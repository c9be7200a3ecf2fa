"""Model and run configuration (port of ``repro.configs.base``).

The fields of all six families (dense, MoE, SSM (RWKV6), hybrid
(Zamba2), audio (SeamlessM4T's encoder-decoder) and vlm (InternVL2's
patch prefix)), and the training knobs ``remat`` (activation
rematerialization of each block, ``models.blocks.maybe_remat``) and
``loss_chunk`` (the sequence chunk of ``models.layers.cross_entropy_loss``).
``dtype`` and ``param_dtype`` are torch dtypes.  ``reduced()`` is the
CPU-smoke variant (<= 2 layers and <= 2 encoder layers, d_model <= 256,
<= 4 experts of top-2, a shared block every 2 layers, <= 16 patches, SSM
chunks of 16, state <= 16, head width <= 32, float32, no remat, the
loss's default chunk), the same cut as the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

# the families whose config fields, param counts and blocks the port has:
# every family of the reference
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    source: str                    # citation of the published config
    num_layers: int
    d_model: int
    vocab_size: int
    d_ff: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0              # 0 => d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (rwkv / mamba) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # --- hybrid (zamba2): one shared attn+mlp block every N mamba blocks ---
    shared_attn_every: int = 0
    # --- enc-dec (seamless) ---
    encoder_layers: int = 0
    encoder_seq_divisor: int = 4   # encoder frames = seq_len // divisor
    # --- modality frontend stubs ---
    frontend: str | None = None    # None | "audio" | "vision"
    num_patches: int = 256         # vision prefix length
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    loss_chunk: int = 512

    def __post_init__(self):
        if self.num_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant: same family and wiring, tiny dims."""
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = min(self.num_kv_heads, max(heads // 2, 1)) if heads else 0
        d_model = min(self.d_model, 256)
        hd = d_model // heads if heads else 0
        return self.with_(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=d_model,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
            encoder_layers=min(self.encoder_layers, 2),
            shared_attn_every=(2 if self.shared_attn_every else 0),
            num_patches=min(self.num_patches, 16),
            ssm_chunk=16,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            dtype=torch.float32,
            param_dtype=torch.float32,
            remat=False,
            loss_chunk=0,
        )

    def _attn_params(self) -> int:
        return self.d_model * self.head_dim * 2 \
            * (self.num_heads + self.num_kv_heads)

    def _embed_params(self) -> int:
        return self.vocab_size * self.d_model \
            * (1 if self.tie_embeddings else 2)

    def _require_counted(self):
        if self.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")

    def param_count(self) -> int:
        """Parameters (the reference's approximate count: no norms, token
        shift mixes, SSM scalars or biases; the router counted; RWKV6's
        decay LoRA at rank 64; Zamba2's one shared block counted once; an
        audio decoder layer's self- and cross-attention both counted, and
        an encoder layer's GELU MLP counted as 3 D F, as the reference
        counts it, where its leaves hold 2 D F + F + D)."""
        self._require_counted()
        D, F, L = self.d_model, self.d_ff, self.num_layers
        if self.family == "ssm":
            time_mix = 5 * D * D + D * 64 + 64 * D
            channel_mix = D * F * 2 + D * D
            return self._embed_params() + L * (time_mix + channel_mix)
        if self.family == "hybrid":
            din = 2 * D
            mamba = D * (2 * din + 2 * self.ssm_state
                         + din // self.ssm_head_dim) + din * D
            shared = self._attn_params() + 3 * D * F
            return self._embed_params() + L * mamba + shared
        if self.family == "audio":
            attn, mlp = self._attn_params(), 3 * D * F
            encoder = self.encoder_layers * (attn + mlp)
            decoder = L * (2 * attn + mlp)
            return self._embed_params() + encoder + decoder
        if self.family in ("dense", "vlm"):
            ffn = 3 * D * F
        else:
            ffn = self.num_experts * 3 * D * F + D * self.num_experts
        return self._embed_params() + L * (self._attn_params() + ffn)

    def active_param_count(self) -> int:
        """Parameters a token passes through (MoE: its top-k experts and
        the router)."""
        self._require_counted()
        if self.family != "moe":
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.num_layers
        act_moe = self.experts_per_token * 3 * D * F + D * self.num_experts
        return self._embed_params() + L * (self._attn_params() + act_moe)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"
