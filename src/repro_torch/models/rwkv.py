"""RWKV6 "Finch" blocks (port of ``repro.models.rwkv``): an attention-free
linear recurrence with data-dependent decay (arXiv:2404.05892).

* token-shift mixing of the current and previous token (static learned
  mixes, as the reference keeps them);
* the data-dependent per-channel decay ``w_t = exp(-exp(w0 + LoRA(x_t)))``,
  ``w0 + LoRA`` summed in the params' type and only then taken to float32;
* the ``u`` bonus for the current token;
* a float32 per-head WKV state ``S`` (head_dim x head_dim):
      y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
      S_t = diag(w_t) S_{t-1} + k_t v_t^T;
* ``ln_x``, a LayerNorm over all H * head_dim channels (the reference's
  code, whatever its comment calls it), and the squared-ReLU channel mix.

``wkv_scan`` is the recurrence token by token; ``wkv_chunked`` takes
``chunk`` tokens a step with dense intra-chunk products (every kept decay
exponent a difference A_i - A_j with i >= j, so no exp overflows; the
masked pairs are masked in the exponent, where the reference masks exp's
output and its gradient turns NaN once the decay sum passes float32's
exp range).  Where
the reference scans, the port loops in Python.  Every contraction of
more than two operands is written as pairwise products and matmuls in
one fixed order, so the order does not depend on the installation's
einsum planner.  No Pallas kernel computes the recurrence in the
reference, so it stays plain PyTorch.  ``time_mix`` runs it through
``_wkv_dispatch``: under a model mesh, the reference's shard_map WKV
(batch over the data axes, heads over ``model``, no collective inside).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers, meshctx


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    d_model: int
    d_ff: int
    head_dim: int = 64
    decay_lora_rank: int = 64

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim


def init(gen, spec: RWKVSpec, *, dtype, stack: tuple = ()):
    """Params drawn on ``gen``'s device, each (*stack, ...) as one leaf."""
    D, F_, H, hd = spec.d_model, spec.d_ff, spec.num_heads, spec.head_dim
    R = spec.decay_lora_rank
    dev = gen.device

    def full(shape, value):
        return torch.full((*stack, *shape), value, dtype=dtype, device=dev)

    def dense(d_in, d_out):
        return layers.dense_init(gen, d_in, d_out, dtype=dtype, stack=stack)

    return {
        "time_mix": {
            "mix_r": full((D,), 0.5),
            "mix_k": full((D,), 0.5),
            "mix_v": full((D,), 0.5),
            "mix_g": full((D,), 0.5),
            "mix_w": full((D,), 0.5),
            "wr": dense(D, (H, hd)),
            "wk": dense(D, (H, hd)),
            "wv": dense(D, (H, hd)),
            "wg": dense(D, (H, hd)),
            "wo": dense(H * hd, D),
            "w0": full((H, hd), -0.6),
            "w_lora_a": dense(D, R),
            "w_lora_b": layers.truncated_normal_init(
                gen, (*stack, R, H, hd), 0.01, dtype),
            "u": layers.truncated_normal_init(gen, (*stack, H, hd), 0.1,
                                              dtype),
            "ln_x": layers.layernorm_init(H * hd, dtype=dtype, device=dev,
                                          stack=stack),
        },
        "channel_mix": {
            "mix_k": full((D,), 0.5),
            "mix_r": full((D,), 0.5),
            "wk": dense(D, F_),
            "wv": dense(F_, D),
            "wr": dense(D, D),
        },
    }


def _token_shift(x, prev):
    """Shift right by one: position t sees token t-1, position 0 sees
    ``prev`` (zeros at a sequence's start, the carried token in decode)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, shifted, coeff):
    return x + (shifted - x) * coeff


def _heads(x, w):
    """einsum("btd,dhk->bthk") as one matmul."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).reshape(*x.shape[:-1], H, hd)


def wkv_scan(r, k, v, w, u, state):
    """The WKV recurrence token by token.  r, k, v, w: (B, T, H, hd); u:
    (H, hd); state: (B, H, hd, hd).  Returns (y (B, T, H, hd), final
    state), in float32."""
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    uf = u.to(torch.float32)[None, :, :, None]
    S = state.to(torch.float32)
    ys = []
    for t in range(rf.shape[1]):
        k_t, v_t = kf[:, t], vf[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]            # (B, H, hd, hd)
        ys.append((rf[:, t, :, None, :] @ (S + uf * kv))[..., 0, :])
        S = wf[:, t, ..., None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv_chunked(r, k, v, w, u, state, *, chunk: int = 64):
    """The WKV recurrence ``chunk`` tokens a step: within a chunk the pair
    decays D[i, j] = exp(A_{i-1} - A_j), j < i (A the inclusive cumsum of
    log w, w clamped at 1e-30), the state entering the chunk decayed to
    each position, and the state leaving it.  Shapes as ``wkv_scan``;
    falls back to it where T exceeds ``chunk`` and is not a multiple of
    it."""
    B, T, H, hd = r.shape
    L = min(chunk, T)
    if T % L != 0:
        return wkv_scan(r, k, v, w, u, state)
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    uf = u.to(torch.float32)
    strict = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    strict = strict[None, :, :, None, None]
    neg_inf = torch.full((), float("-inf"), device=r.device)
    S = state.to(torch.float32)
    ys = []
    for c in range(T // L):
        sl = slice(c * L, (c + 1) * L)
        r_c, k_c, v_c, w_c = rf[:, sl], kf[:, sl], vf[:, sl], wf[:, sl]
        log_w = torch.log(torch.clamp(w_c, min=1e-30))
        A = torch.cumsum(log_w, dim=1)                        # inclusive
        A_prev = A - log_w                                    # exclusive
        # masked in the exponent (exp(-inf) = 0): the reference's exp of
        # the unmasked difference overflows above the diagonal and its
        # gradient turns NaN there
        D = torch.exp(torch.where(strict, A_prev[:, :, None] - A[:, None],
                                  neg_inf))                   # (B,L,L,H,hd)
        # scores[b,l,m,h] = sum_d (r[l] D[l,m]) k[m]
        scores = torch.sum(r_c[:, :, None] * D * k_c[:, None], dim=-1)
        diag = torch.sum(r_c * uf * k_c, dim=-1)              # (B, L, H)
        y_c = (scores.permute(0, 3, 1, 2) @ v_c.transpose(1, 2)) \
            .transpose(1, 2) + diag[..., None] * v_c
        # the state entering the chunk, decayed to each position
        y_c = y_c + ((r_c * torch.exp(A_prev)).transpose(1, 2) @ S) \
            .transpose(1, 2)
        decay_end = torch.exp(A[:, -1:] - A)
        kv_inj = (k_c * decay_end).permute(0, 2, 3, 1) @ v_c.transpose(1, 2)
        S = torch.exp(A[:, -1])[..., None] * S + kv_inj
        ys.append(y_c)
    return torch.cat(ys, dim=1), S


def _wkv_dispatch(r, k, v, w, u, state):
    """``wkv_chunked`` (``wkv_scan`` for one token), or under a model mesh
    the reference's shard_map region: r, k, v, w (B/data, T, H, hd) are
    the rank's batch shard with every head (the stream is the same on
    every model rank); the rank runs the recurrence on its H/|model|
    heads, and the heads are all-gathered over ``model`` where the
    region's output leaves it.  ``state`` (B/data, H, hd, hd) has every
    head, and the new state comes back gathered too, or (decode) it is
    the rank's block of H/|model| heads
    (``launch.sharding.local_decode_state``), and so is the new state."""
    mesh = meshctx.current_mesh()
    T, H = r.shape[1], r.shape[2]
    wkv = wkv_chunked if T > 1 else wkv_scan
    if mesh is not None and "model" in mesh.axis_names \
            and meshctx.data_axes(mesh) and H % meshctx.model_size(mesh) == 0:
        hs = H // meshctx.model_size(mesh)
        lo = mesh.coords["model"] * hs
        block = state.shape[1] != H
        y, s = wkv(*(t[:, :, lo:lo + hs] for t in (r, k, v, w)),
                   u[lo:lo + hs], state if block else state[:, lo:lo + hs])
        y = meshctx.all_gather(y, "model", 2, mesh=mesh)
        return y, s if block else meshctx.all_gather(s, "model", 1,
                                                     mesh=mesh)
    return wkv(r, k, v, w, u, state)


def time_mix(params, spec: RWKVSpec, x, *, prev_token=None, wkv_state=None):
    """RWKV6's attention replacement.  x: (B, T, D).  Returns (out,
    (x[:, -1], the new WKV state)): the carried token is the block's
    input, the normed x."""
    p = params
    B, T, D = x.shape
    H, hd = spec.num_heads, spec.head_dim
    if prev_token is None:
        prev_token = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    if wkv_state is None:
        wkv_state = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                device=x.device)
    shifted = _token_shift(x, prev_token)
    xr = _mix(x, shifted, p["mix_r"])
    xk = _mix(x, shifted, p["mix_k"])
    xv = _mix(x, shifted, p["mix_v"])
    xg = _mix(x, shifted, p["mix_g"])
    xw = _mix(x, shifted, p["mix_w"])

    r = _heads(xr, p["wr"])
    k = _heads(xk, p["wk"])
    v = _heads(xv, p["wv"])
    g = F.silu(_heads(xg, p["wg"]).to(torch.float32)).to(x.dtype)

    # the data-dependent decay: w0 + LoRA in the params' type, then float32
    lora_in = torch.tanh((xw @ p["w_lora_a"]).to(torch.float32)).to(x.dtype)
    Rk = p["w_lora_b"].shape[0]
    lora = (lora_in @ p["w_lora_b"].reshape(Rk, H * hd)).reshape(B, T, H, hd)
    w = torch.exp(-torch.exp((p["w0"] + lora).to(torch.float32)))

    y, new_state = _wkv_dispatch(r, k, v, w, p["u"], wkv_state)
    y = y.reshape(B, T, H * hd).to(x.dtype)
    y = layers.layernorm(p["ln_x"], y)
    y = y * g.reshape(B, T, H * hd)
    return y @ p["wo"], (x[:, -1, :], new_state)


def channel_mix(params, spec: RWKVSpec, x, *, prev_token=None):
    """Squared-ReLU channel mixing.  Returns (out, x[:, -1]).  The receptance
    is the reference's ``einsum("btd,dd->btd", xr, wr)``: a repeated index
    takes the diagonal, so only diag(wr) enters (D numbers of the (D, D)
    leaf)."""
    p = params
    B, T, D = x.shape
    if prev_token is None:
        prev_token = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    shifted = _token_shift(x, prev_token)
    xk = _mix(x, shifted, p["mix_k"])
    xr = _mix(x, shifted, p["mix_r"])
    k = torch.square(F.relu((xk @ p["wk"]).to(torch.float32))).to(x.dtype)
    r = torch.sigmoid((xr * torch.diagonal(p["wr"], dim1=-2, dim2=-1))
                      .to(torch.float32)).to(x.dtype)
    return r * (k @ p["wv"]), x[:, -1, :]
