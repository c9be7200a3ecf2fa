"""RWKV6 "Finch" 7B [arXiv:2404.05892]: attention-free SSM with
data-dependent decay (port of ``repro.configs.rwkv6_7b``)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    ssm_head_dim=64,
)
