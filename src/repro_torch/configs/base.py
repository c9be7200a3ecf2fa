"""Model and run configuration (port of ``repro.configs.base``).

The fields of the dense family, the one ported so far; the other
families' fields (experts, SSM state, encoder, frontend) come with their
model code, and the training knobs (``remat``, ``loss_chunk``) with
training (ROADMAP Queue 1 item 16).  ``dtype`` and ``param_dtype`` are
torch dtypes.  ``reduced()`` is the CPU-smoke variant (<= 2 layers,
d_model <= 256, float32), the same cut as the reference's.
"""

from __future__ import annotations

import dataclasses

import torch


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
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16

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
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
            dtype=torch.float32,
            param_dtype=torch.float32,
        )

    def param_count(self) -> int:
        """Parameters of the dense family (the reference's approximate
        count; the other families come with their models)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * self.num_heads * self.head_dim * 2 \
            + D * self.num_kv_heads * self.head_dim * 2
        if self.family == "dense":
            return emb + L * (attn + 3 * D * F)
        raise NotImplementedError(
            f"param_count of the {self.family!r} family comes with its "
            "model code (ROADMAP Queue 1 item 16)")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"
