"""Mamba2 (SSD) block for the Zamba2 hybrid (port of
``repro.models.mamba``; arXiv:2411.15242).

A state-space recurrence with a scalar decay per head:

    h_t = a_t h_{t-1} + dt_t x_t B_t^T        a_t = exp(-dt_t A_h)
    y_t = C_t . h_t + D_h x_t

computed by the chunked SSD algorithm: within a chunk of ``chunk``
tokens a masked (L x L) decay-weighted product, across chunks a short
loop that carries the (H, P, N) state.  The in-projection is stored as
separate matrices (w_z, w_x, w_B, w_C, w_dt), as in the reference.
``A_log``, ``dt_bias`` and ``D`` are float32 in every config; the SSD
runs in float32.  The intra-chunk decay is masked in its exponent (to
-inf, so exp gives 0) where the reference masks exp's output: the same
values, and a gradient that stays finite once a chunk's decay sum passes
float32's exp range (the reference's is NaN there).  Every contraction
of more than two operands is written as pairwise products and matmuls in
one fixed order (the installation's einsum planner would pick its own),
and ``softplus`` is the reference's ``logaddexp(x, 0)``.  No Pallas kernel computes the SSD in the
reference, so it stays plain PyTorch.  Decode carries (conv states, ssm
state (B, H, P, N)).

Under a model mesh whose |model| divides the heads, ``apply`` runs the
block channel-parallel (the reference's sharding rules): the stream
(B/data, T, D) is the same on every model rank, the rank holds Din/|model|
channels of ``w_z``, ``w_x``, ``conv_x``, ``conv_x_b``, ``norm`` and the
rows of ``w_out``, H/|model| heads of ``w_dt``, ``A_log``, ``dt_bias``
and ``D`` (``TP_DIMS``), ``w_B``, ``w_C`` and their convs whole, and runs
the SSD on its heads.  The gated RMSNorm's sum of squares is psum'd over
``model`` before the rsqrt, and the out-projection's partial sums are
psum'd over ``model`` in rank order.  Each model rank then holds its own
copy of the sum (the convention of the replicated stream: a value's
gradient is the sum of its copies' cotangents), so both sums take the
copies' cotangents summed in their backward.  Where |model| does not
divide the heads the block runs whole on every rank, with no collective.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers, meshctx

# the leaves channel TP cuts over ``model``, and the dim it cuts (from the
# end): Din columns, H heads, Din rows of the out-projection
TP_DIMS = {"w_z": -1, "w_x": -1, "conv_x": -1, "conv_x_b": -1, "w_dt": -1,
           "A_log": -1, "dt_bias": -1, "D": -1, "w_out": -2}


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


def init(gen, spec: MambaSpec, *, dtype, stack: tuple = ()):
    """Params drawn on ``gen``'s device, each (*stack, ...) as one leaf;
    ``A_log``, ``dt_bias`` and ``D`` in float32 whatever ``dtype``."""
    D, Din, N, H = spec.d_model, spec.d_inner, spec.d_state, spec.num_heads
    K = spec.conv_kernel
    dev = gen.device

    def dense(d_in, d_out):
        return layers.dense_init(gen, d_in, d_out, dtype=dtype, stack=stack)

    def conv(width):
        return layers.truncated_normal_init(gen, (*stack, K, width), 0.1,
                                            dtype)

    def const(shape, value, dt):
        return torch.full((*stack, *shape), value, dtype=dt, device=dev)

    return {
        "w_z": dense(D, Din),
        "w_x": dense(D, Din),
        "w_B": dense(D, N),
        "w_C": dense(D, N),
        "w_dt": dense(D, H),
        "conv_x": conv(Din),
        "conv_x_b": const((Din,), 0.0, dtype),
        "conv_B": conv(N),
        "conv_B_b": const((N,), 0.0, dtype),
        "conv_C": conv(N),
        "conv_C_b": const((N,), 0.0, dtype),
        "A_log": const((H,), 0.0, torch.float32),     # A = exp(A_log) >= 1
        "dt_bias": const((H,), -2.0, torch.float32),
        "D": const((H,), 1.0, torch.float32),
        "norm": layers.rmsnorm_init(Din, dtype=dtype, device=dev,
                                    stack=stack),
        "w_out": dense(Din, D),
    }


def _causal_conv(x, w, b, *, state=None):
    """Depthwise causal conv over time.  x: (B, T, C); w: (K, C).
    ``state`` (B, K-1, C) is the history before x (zeros when None).
    Returns (silu(conv + b) in x's type, the new state)."""
    K, T = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                  # (B, T+K-1, C)
    y = xp[:, 0:T] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + T] * w[i]
    y = y + b
    return (F.silu(y.to(torch.float32)).to(x.dtype), xp[:, -(K - 1):])


def _ssd_chunked(x, dt, A, B_mat, C_mat, spec: MambaSpec, *,
                 init_state=None):
    """Chunked SSD.  x (B, T, H, P), dt (B, T, H), A (H,), B_mat and C_mat
    (B, T, N).  Returns (y (B, T, H, P), final state (B, H, P, N)) in
    float32.  T must be a multiple of min(chunk, T)."""
    Bsz, T, H, P = x.shape
    N = B_mat.shape[-1]
    L = min(spec.chunk, T)
    if T % L != 0:
        raise ValueError(f"T={T} must be divisible by chunk={L}")
    nC = T // L
    xf = x.to(torch.float32).reshape(Bsz, nC, L, H, P)
    dtf = dt.to(torch.float32).reshape(Bsz, nC, L, H)
    Bf = B_mat.to(torch.float32).reshape(Bsz, nC, L, N)
    Cf = C_mat.to(torch.float32).reshape(Bsz, nC, L, N)

    log_a = -dtf * A                                   # (B, nC, L, H) <= 0
    acum = torch.cumsum(log_a, dim=2)                  # inclusive
    dtx = dtf[..., None] * xf                          # (B, nC, L, H, P)
    scores = Cf @ Bf.transpose(-1, -2)                 # (B, nC, L, L)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))

    if init_state is None:
        init_state = torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                                 device=x.device)

    # intra-chunk: the masked decay "attention".  The reference takes exp
    # of every (l, m) difference and masks after; above the diagonal the
    # difference is the positive decay sum, which past 88 overflows to inf,
    # so exp's backward meets 0 * inf = NaN.  Masking the exponent to -inf
    # first gives the same values and a gradient that stays finite.
    causal = causal[None, None, :, :, None]
    decay = torch.exp(torch.where(
        causal, acum[:, :, :, None, :] - acum[:, :, None, :, :],
        torch.full((), float("-inf"), device=x.device)))
    weights = (scores[..., None] * decay).permute(0, 1, 4, 2, 3)  # (B,nC,H,L,L)
    y_intra = (weights @ dtx.permute(0, 1, 3, 2, 4)) \
        .permute(0, 1, 3, 2, 4)                        # (B, nC, L, H, P)
    # the state each chunk injects, decayed to the chunk's end
    decay_end = torch.exp(acum[:, :, -1:, :] - acum)   # (B, nC, L, H)
    S_chunk = (decay_end[..., None] * dtx).permute(0, 1, 3, 4, 2) \
        @ Bf[:, :, None]                               # (B, nC, H, P, N)

    # inter-chunk recurrence: the state entering each chunk
    a_total = torch.exp(acum[:, :, -1, :])             # (B, nC, H)
    S = init_state.to(torch.float32)
    entering = []
    for c in range(nC):
        entering.append(S)
        S = a_total[:, c, :, None, None] * S + S_chunk[:, c]
    S_prev = torch.stack(entering, dim=1)              # (B, nC, H, P, N)

    y_inter = (Cf[:, :, None] @ S_prev.transpose(-1, -2)) \
        .permute(0, 1, 3, 2, 4) * torch.exp(acum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, T, H, P)
    return y, S


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) (``F.softplus`` turns linear
    past 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _project(params, spec: MambaSpec, x, conv_state):
    """The projections, the causal convs and dt, shared by ``apply`` and
    ``decode_step``.  conv_state: None or {"x", "B", "C"}."""
    p = params
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    B_mat = x @ p["w_B"]
    C_mat = x @ p["w_C"]
    dt = x @ p["w_dt"]
    cs = conv_state or {}
    xs, cx = _causal_conv(xs, p["conv_x"], p["conv_x_b"], state=cs.get("x"))
    B_mat, cb = _causal_conv(B_mat, p["conv_B"], p["conv_B_b"],
                             state=cs.get("B"))
    C_mat, cc = _causal_conv(C_mat, p["conv_C"], p["conv_C_b"],
                             state=cs.get("C"))
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])
    return z, xs, B_mat, C_mat, dt, {"x": cx, "B": cb, "C": cc}


def tp_dim(names) -> int | None:
    """The dim channel TP cuts of the block's leaf at ``names`` (its path,
    the leaf's name last), or None for a leaf every rank holds whole (the
    block's own ``ln`` among them)."""
    if names[-1] == "scale":
        return -1 if "norm" in names else None
    return TP_DIMS.get(names[-1])


def tp_applies(mesh, spec: MambaSpec) -> bool:
    """Whether the block runs channel-parallel on ``mesh``: a model axis
    whose size divides the heads (and so Din)."""
    return mesh is not None and "model" in mesh.axis_names \
        and spec.num_heads % meshctx.model_size(mesh) == 0


def _gate_norm(params, y, mesh, width: int):
    """The gated RMSNorm over all ``width`` channels of y (B, T, channels):
    under channel TP (``mesh``) the rank's sum of squares psum'd over
    ``model`` before the rsqrt, the sum each rank's own copy."""
    yf = y.to(torch.float32)
    ss = torch.sum(yf * yf, dim=-1, keepdim=True)
    if mesh is not None:
        ss = meshctx.pvary(meshctx.psum(ss, "model", mesh=mesh), "model",
                           mesh=mesh)
    normed = yf * torch.rsqrt(ss / width + 1e-5)
    return (normed * params["scale"].to(torch.float32)).to(y.dtype)


def _gate_out(p, y, z, dtype, width: int, *, mesh=None):
    y = _gate_norm(p["norm"], y.to(dtype), mesh, width)
    y = y * F.silu(z.to(torch.float32)).to(dtype)
    return y @ p["w_out"]


def apply(params, spec: MambaSpec, x, *, conv_state=None, ssm_state=None):
    """The Mamba2 block over a sequence (train / prefill).  x: (B, T, D).
    Returns (out (B, T, D), (new conv state, new ssm state)); under
    channel TP (module docstring) the states are the rank's heads'."""
    p = params
    Bsz, T, _ = x.shape
    mesh = meshctx.current_mesh()
    mesh = mesh if tp_applies(mesh, spec) else None
    H = spec.num_heads // (meshctx.model_size(mesh) if mesh else 1)
    P = spec.head_dim
    if p["A_log"].shape[-1] != H:
        raise ValueError(
            f"Mamba2 block: A_log {tuple(p['A_log'].shape)} holds not the "
            f"{H} heads of this rank's layout")
    z, xs, B_mat, C_mat, dt, new_conv = _project(p, spec, x, conv_state)
    A = torch.exp(p["A_log"])
    xh = xs.reshape(Bsz, T, H, P)
    y, new_ssm = _ssd_chunked(xh, dt, A, B_mat, C_mat, spec,
                              init_state=ssm_state)
    y = y + p["D"][:, None] * xh.to(torch.float32)
    out = _gate_out(p, y.reshape(Bsz, T, H * P), z, x.dtype, spec.d_inner,
                    mesh=mesh)
    if mesh is not None:
        out = _psum_copies(out, mesh)
    return out, (new_conv, new_ssm)


def _psum_copies(out, mesh):
    """The partial sums over the rank's heads, psum'd over model in rank
    order, each rank's own copy of the sum: a psum_scatter and an
    all_gather over T where |model| divides it (the same sums, without
    every rank receiving every whole partial), else ``pvary(psum(.))``;
    either backward sums the copies' cotangents."""
    if out.shape[1] % meshctx.model_size(mesh) == 0:
        return meshctx.all_gather(
            meshctx.psum_scatter(out, "model", 1, mesh=mesh), "model", 1,
            mesh=mesh)
    return meshctx.pvary(meshctx.psum(out, "model", mesh=mesh), "model",
                         mesh=mesh)


def _gather_channels(b_blk, c_blk, mesh):
    """The B and C conv outputs (B, 1, N/|model|) of the rank's N block,
    all-gathered over ``model`` into every channel (one collective)."""
    return meshctx.all_gather_many([b_blk, c_blk], "model", -1, mesh=mesh)


def _project_tp_decode(p, spec: MambaSpec, x, conv_state, mesh):
    """``_project`` for one token on the rank's channels: z, x, dt and the
    x conv on its Din and heads; B and C projected whole, their convs on
    the rank's N block of their states, then gathered
    (``_gather_channels``)."""
    n_blk = conv_state["B"].shape[-1]
    lo = meshctx.axis_index("model") * n_blk
    z = x @ p["w_z"]
    xs, cx = _causal_conv(x @ p["w_x"], p["conv_x"], p["conv_x_b"],
                          state=conv_state["x"])
    bc, new = [], {"x": cx}
    for name in ("B", "C"):
        w = p[f"conv_{name}"][..., lo:lo + n_blk]
        b = p[f"conv_{name}_b"][..., lo:lo + n_blk]
        proj = (x @ p[f"w_{name}"])[..., lo:lo + n_blk]
        y, new[name] = _causal_conv(proj, w, b, state=conv_state[name])
        bc.append(y)
    B_mat, C_mat = _gather_channels(*bc, mesh)
    dt = _softplus((x @ p["w_dt"]).to(torch.float32) + p["dt_bias"])
    return z, xs, B_mat, C_mat, dt, new


def decode_step(params, spec: MambaSpec, x, conv_state, ssm_state):
    """One token.  x: (B, 1, D).  The exact recurrence at T = 1.

    Under channel TP (module docstring) the states are the rank's blocks
    (``launch.sharding.local_decode_state``): the x conv state on its
    Din/|model| channels, the B and C conv states on N/|model|, the SSM
    state on its heads.  B and C are gathered over ``model`` before the
    rank's heads take them in; the gated norm's sum of squares and the
    out-projection are psum'd as in ``apply``."""
    p = params
    Bsz = x.shape[0]
    mesh = meshctx.current_mesh()
    mesh = mesh if tp_applies(mesh, spec) else None
    n = meshctx.model_size(mesh) if mesh is not None else 1
    Din, H, P = spec.d_inner // n, spec.num_heads // n, spec.head_dim
    if mesh is None:
        z, xs, B_mat, C_mat, dt, new_conv = _project(p, spec, x, conv_state)
    else:
        z, xs, B_mat, C_mat, dt, new_conv = _project_tp_decode(
            p, spec, x, conv_state, mesh)
    A = torch.exp(p["A_log"])
    dt0 = dt[:, 0]                                            # (B, H)
    a = torch.exp(-dt0 * A)
    xh = xs[:, 0].reshape(Bsz, H, P).to(torch.float32)
    Bf = B_mat[:, 0].to(torch.float32)
    Cf = C_mat[:, 0].to(torch.float32)
    inject = (dt0[..., None] * xh)[..., None] * Bf[:, None, None, :]
    new_ssm = a[..., None, None] * ssm_state + inject         # (B, H, P, N)
    y = (new_ssm @ Cf[:, None, :, None])[..., 0]              # (B, H, P)
    y = y + p["D"][:, None] * xh
    out = _gate_out(p, y.reshape(Bsz, 1, Din), z, x.dtype, spec.d_inner,
                    mesh=mesh)
    if mesh is not None:
        out = _psum_copies(out, mesh)
    return out, (new_conv, new_ssm)


def init_states(spec: MambaSpec, batch: int, *, dtype, device=None,
                stack: tuple = ()):
    """Zero decode states: conv {"x", "B", "C"} (*stack, B, K-1, C) in
    ``dtype``, ssm (*stack, B, H, P, N) in float32."""
    K1 = spec.conv_kernel - 1

    def zeros(*shape, dt=dtype):
        return torch.zeros((*stack, batch, *shape), dtype=dt, device=device)

    conv = {"x": zeros(K1, spec.d_inner), "B": zeros(K1, spec.d_state),
            "C": zeros(K1, spec.d_state)}
    ssm = zeros(spec.num_heads, spec.head_dim, spec.d_state,
                dt=torch.float32)
    return conv, ssm
