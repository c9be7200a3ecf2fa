"""InternVL2-26B [arXiv:2404.16821]: InternViT stubbed (precomputed patch
embeddings, the reference's carve-out) ahead of an InternLM2 20B-class
decoder (port of ``repro.configs.internvl2_26b``)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision",
    num_patches=256,
    rope_theta=1e6,
)
