"""H2O-Danube3-4B [arXiv:2401.16818]: llama/mistral-style dense decoder
with native sliding-window attention."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e4,
)
