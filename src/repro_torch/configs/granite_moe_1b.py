"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]:
32-expert top-8 MoE.  The reference's config field for field: untied
embeddings, and none of the checkpoint's muP multipliers, which the
reference does not model."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,               # per-expert hidden
    vocab_size=49155,
    num_experts=32,
    experts_per_token=8,
    rope_theta=1e4,
)
