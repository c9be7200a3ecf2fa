"""Minitron-4B [arXiv:2407.14679]: width/depth-pruned Nemotron-4."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    source="arXiv:2407.14679",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=1e4,
)
