"""SeamlessM4T-medium [arXiv:2308.11596]: an encoder-decoder whose audio
frontend is stubbed (precomputed conv/mel frame embeddings, the
reference's carve-out; port of ``repro.configs.seamless_m4t_medium``)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    rope_theta=1e4,
    encoder_seq_divisor=4,
)
