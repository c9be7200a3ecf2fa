"""Kimi K2 1T-A32B [arXiv:2501.kimi2]: trillion-parameter MoE, 384
experts top-8 (the reference's paper-table scale).  No single card holds
it: one layer's experts are 16.9 G parameters, and the expert-parallel
path (``models.moe._apply_expert_parallel``) shares one card's memory
among its ranks; it waits for several cards (ROADMAP Queue 1 item
16.13)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,              # per-expert hidden
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    rope_theta=1e6,
    moe_capacity_factor=1.25,
)
