"""Synthetic deterministic LM token stream and the audio and VLM
frontend stubs (port of ``repro.data.tokens``).

Reproducible synthetic tokens whose shapes and types match a real
corpus's: a Zipf-like unigram draw mixed with a deterministic affine
bigram map, so next-token prediction has learnable structure.  A batch is
a pure function of (seed, step), drawn through the port's threefry
(``repro_torch.random``), so its tokens are the reference's bit for bit:
the one float step, f32 ``u ** -0.7``, may differ from XLA's by ulps,
which the integer cast and the clip to the vocabulary absorb unless a
value sits on an integer boundary.

``frame_embeddings`` and ``patch_embeddings`` stand in for the audio
frontend's frames and the vision encoder's patches (the reference's
carve-out): standard normals from the port's ``random.normal`` on an
explicit key, which match ``jax.random.normal`` up to ulps (torch's
``erfinv`` is not XLA's).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import _device
from repro_torch import random as prng


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_workers: int
    seed: int = 0
    device: str | torch.device | None = None   # None: the CUDA card

    def __post_init__(self):
        if self.global_batch % self.num_workers != 0:
            raise ValueError("global_batch must divide evenly among workers")

    @property
    def per_worker(self) -> int:
        return self.global_batch // self.num_workers

    def batch(self, step: int):
        """dict(tokens=(m, B/m, T) int32, labels likewise) on ``device``.

        Tokens follow a two-state mixture: a Zipf-ish unigram draw mixed
        with the bigram map t = (31 start + 7919 pos) % V; labels are the
        tokens rolled left by one (the next token; the last wraps)."""
        dev = _device.resolve_device(self.device)
        key = prng.fold_in(prng.PRNGKey(self.seed, device=dev), step)
        k_uni, k_mix, k_start = prng.split(key, 3)
        shape = (self.num_workers, self.per_worker, self.seq_len)
        # Zipf via inverse CDF on a uniform: rank ~ u^(-1/s), truncated
        u = prng.uniform(k_uni, shape, minval=1e-6, maxval=1.0)
        zipf = torch.clamp((u ** -0.7 - 1.0).to(torch.int32),
                           0, self.vocab_size - 1)
        start = prng.randint(k_start, shape[:2] + (1,), 0, self.vocab_size)
        pos = torch.arange(self.seq_len, dtype=torch.int32,
                           device=dev)[None, None, :]
        bigram = torch.remainder(start * 31 + pos * 7919, self.vocab_size)
        mix = prng.bernoulli(k_mix, 0.5, shape)
        tokens = torch.where(mix, zipf, bigram).to(torch.int32)
        labels = torch.roll(tokens, -1, dims=-1)
        return {"tokens": tokens, "labels": labels}


def frame_embeddings(key, *, num_workers: int, per_worker: int,
                     num_frames: int, d_model: int,
                     dtype=torch.bfloat16):
    """[audio] stub: precomputed mel + conv frontend output, shaped like
    SeamlessM4T's speech encoder input after feature extraction: (m, B/m,
    num_frames, d_model) on ``key``'s device."""
    x = prng.normal(key, (num_workers, per_worker, num_frames, d_model))
    return x.to(dtype)


def patch_embeddings(key, *, num_workers: int, per_worker: int,
                     num_patches: int, d_model: int,
                     dtype=torch.bfloat16):
    """[vlm] stub: precomputed InternViT patch embeddings after the MLP
    projector: (m, B/m, num_patches, d_model) on ``key``'s device."""
    x = prng.normal(key, (num_workers, per_worker, num_patches, d_model))
    return x.to(dtype)
