"""Zamba2-2.7B [arXiv:2411.15242]: a Mamba2 backbone with one shared
attention block applied every 6 Mamba2 blocks (hybrid; port of
``repro.configs.zamba2_2p7b``)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=54,          # mamba2 blocks
    d_model=2560,
    num_heads=32,           # shared attention block
    num_kv_heads=32,
    d_ff=10240,             # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    shared_attn_every=6,
    rope_theta=1e4,
)
