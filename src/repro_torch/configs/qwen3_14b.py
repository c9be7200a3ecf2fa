"""Qwen3-14B [hf:Qwen/Qwen3-8B family]: dense GQA decoder with qk_norm."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)
