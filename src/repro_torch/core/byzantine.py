"""Byzantine attacks and multi-round attack schedules (PyTorch port of
``repro.core.byzantine``).

The paper's fault model (§1.2): in round t an arbitrary set B_t of up to q
workers reports arbitrary vectors; the adversary is omniscient and
colluding, and B_t may change every round.  An ``Attack`` maps
``(stacked_honest_grads, byz_mask, key) -> stacked_reported_grads`` and may
only change rows where ``byz_mask`` is True (enforced with ``torch.where``).

All twelve of the reference's attacks and its five schedules are
registered under its names.  The attacks that draw random bits
(``random_noise``, ``colluding_mimic``) split the key over the leaves in
JAX's order (``repro_torch.tree``), so each leaf draws the reference's
bits.

The reference rolls rounds into ``lax.scan`` and branches with
``lax.cond``; here rounds are a Python loop, ``round_index`` is a Python
int, and a branch on a device flag (``stealth_then_strike``) reads one
scalar back per round.

On the 2D layout (``shard_aggregation.use_layout``, the mesh train step)
the stacked leaves are a rank's blocks: the coordinate-wise attacks run
as they are; the global norms (``norm_stealth``, ``colluding_mimic``,
``stealth_then_strike``) are the layout's blocked sums;
``anti_aggregation`` passes the layout to GMoM; and the random draws
take each leaf whole from the unsharded key and keep the rank's block.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

from repro_torch import _device
from repro_torch import random as prng
from repro_torch import tree as jtree
from repro_torch.core import shard_aggregation as sa
from repro_torch.core.geometric_median import batch_mean_norms, median

AttackFn = Callable[..., object]

_REGISTRY: dict[str, "Attack"] = {}


@dataclasses.dataclass(frozen=True)
class Attack:
    name: str
    fn: AttackFn
    description: str = ""

    def __call__(self, stacked_grads, byz_mask, key, **kw):
        return self.fn(stacked_grads, byz_mask, key, **kw)


def register(name: str, description: str = ""):
    def deco(fn):
        _REGISTRY[name] = Attack(name=name, fn=fn, description=description)
        return fn
    return deco


def get_attack(name: str) -> Attack:
    if name not in _REGISTRY:
        raise KeyError(f"unknown attack {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available() -> list[str]:
    return sorted(_REGISTRY)


def _mask_like(mask, g):
    """Broadcast the (m,) mask against a stacked leaf (m, ...)."""
    return mask.reshape((-1,) + (1,) * (g.ndim - 1))


def _where_byz(mask, malicious, honest):
    return tree_map(
        lambda bad, good: torch.where(_mask_like(mask, good), bad, good),
        malicious, honest)


def sample_byzantine_mask(key, num_workers: int, num_byzantine, *,
                          rotate: bool = True, round_index=0):
    """(m,) bool mask with exactly q True entries, on the key's device.

    ``rotate=True`` draws a fresh uniformly-random q-subset per round (the
    round index folded into the key); ``rotate=False`` fixes the first q
    workers.  ``num_byzantine`` may be an int or an integer 0-d tensor."""
    from repro_torch.core.aggregators import bottom_k_mask
    dev = key.device
    if isinstance(num_byzantine, int) and num_byzantine == 0:
        return torch.zeros((num_workers,), dtype=torch.bool, device=dev)
    if not rotate:
        return torch.arange(num_workers, device=dev) < num_byzantine
    key = prng.fold_in(key, round_index)
    scores = prng.uniform(key, (num_workers,))
    return bottom_k_mask(scores, num_byzantine).to(torch.bool)


# ---------------------------------------------------------------------------
# attacks

@register("none", "no attack — every worker honest")
def none_attack(stacked_grads, byz_mask, key, **_kw):
    del byz_mask, key
    return stacked_grads


@register("sign_flip", "report -c × true gradient (classic reverse attack)")
def sign_flip_attack(stacked_grads, byz_mask, key, *, scale: float = 10.0,
                     **_kw):
    del key
    malicious = tree_map(lambda g: -scale * g, stacked_grads)
    return _where_byz(byz_mask, malicious, stacked_grads)


@register("inner_product",
          "omniscient: report -eps × honest mean (Xie et al. inner-product "
          "manipulation — small norm, survives norm filters)")
def inner_product_attack(stacked_grads, byz_mask, key, *,
                         epsilon_scale: float = 1.0, **_kw):
    del key

    def mal(g):
        mu = torch.mean(g, dim=0, keepdim=True)
        return (-epsilon_scale * mu).expand(g.shape).to(g.dtype)
    return _where_byz(byz_mask, tree_map(mal, stacked_grads), stacked_grads)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@register("alie",
          "A Little Is Enough [Baruch et al. '19]: all byzantine report "
          "mean - z·std of the honest gradients, with z calibrated from "
          "(m, q) so the point still looks like a plausible honest draw — "
          "small perturbation, accumulates bias across rounds")
def alie_attack(stacked_grads, byz_mask, key, *, z_max: float | None = None,
                min_z: float = 0.5, **_kw):
    del key
    m = tree_leaves(stacked_grads)[0].shape[0]
    dev = byz_mask.device
    honest_w = torch.logical_not(byz_mask).to(torch.float32)      # (m,)
    n_h = torch.clamp(torch.sum(honest_w), min=1.0)
    if z_max is None:
        # z s.t. Phi(z) = (m - q - s)/(m - q) with s = floor(m/2 + 1) - q,
        # floored at min_z (float32 throughout, as in the reference)
        q = torch.sum(byz_mask.to(torch.float32))
        s = torch.floor(_f32(m / 2.0 + 1.0, dev)) - q
        phi = (m - q - s) / torch.clamp(m - q, min=1.0)
        z = torch.special.ndtri(torch.clamp(phi, 0.5, 1.0 - 1e-6))
        z = torch.clamp(z, min=min_z)
    else:
        z = _f32(z_max, dev)

    def mal(g):
        gf = g.to(torch.float32)
        w = _mask_like(honest_w, gf)
        mu = torch.sum(gf * w, dim=0, keepdim=True) / n_h
        var = torch.sum(torch.square(gf - mu) * w, dim=0, keepdim=True) / n_h
        point = mu - z * torch.sqrt(var)
        return point.expand(g.shape).to(g.dtype)

    return _where_byz(byz_mask, tree_map(mal, stacked_grads), stacked_grads)


@register("norm_stealth",
          "adaptive omniscient: report the *negated* honest-mean direction "
          "rescaled to sit just under the server's norm-trim threshold "
          "(multiplier × median worker norm) so trimming never fires")
def norm_stealth_attack(stacked_grads, byz_mask, key, *,
                        trim_multiplier: float = 3.0, safety: float = 0.9,
                        **_kw):
    del key
    layout = sa.current_layout()
    norms = batch_mean_norms(stacked_grads,           # (m,) honest
                             shard_spec=layout)       # pre-attack
    tau = safety * trim_multiplier * median(norms)
    leaves, spec = tree_flatten(stacked_grads)
    mu = [torch.mean(leaf.to(torch.float32), dim=0, keepdim=True)
          for leaf in leaves]
    mu_norm = torch.sqrt(sa.sq_norm(layout, mu, lead_axes=1))
    scale = tau / torch.clamp(mu_norm, min=1e-12)
    malicious = tree_unflatten(
        [(-scale * x).expand(leaf.shape).to(leaf.dtype)
         for x, leaf in zip(mu, leaves)], spec)
    return _where_byz(byz_mask, malicious, stacked_grads)


@register("zero", "report zero gradients (stalling attack)")
def zero_attack(stacked_grads, byz_mask, key, **_kw):
    del key
    return _where_byz(byz_mask, tree_map(torch.zeros_like, stacked_grads),
                      stacked_grads)


def _per_leaf_keys(stacked_grads, key):
    """(leaves in JAX's order, one split key per leaf)."""
    leaves = jtree.leaves(stacked_grads)
    return leaves, prng.split(key, len(leaves))


@register("random_noise", "report large gaussian noise")
def random_noise_attack(stacked_grads, byz_mask, key, *,
                        scale: float = 100.0, **_kw):
    leaves, keys = _per_leaf_keys(stacked_grads, key)
    specs = sa.leaf_specs(sa.current_layout(), stacked_grads)
    noisy = [(scale * sa.draw_block(s, leaf, k, "normal")).to(leaf.dtype)
             for k, leaf, s in zip(keys, leaves, specs)]
    return _where_byz(byz_mask, jtree.unflatten(stacked_grads, noisy),
                      stacked_grads)


@register("mean_shift",
          "omniscient: shift the honest mean by a huge constant direction")
def mean_shift_attack(stacked_grads, byz_mask, key, *, scale: float = 1e3,
                      **_kw):
    del key
    m = tree_leaves(stacked_grads)[0].shape[0]
    q = torch.clamp(torch.sum(byz_mask.to(torch.float32)), min=1.0)
    # each byzantine reports mean + (m/q) scale, so the average moves by
    # about scale in every coordinate
    shift = (m / q) * scale

    def mal(g):
        mu = torch.mean(g, dim=0, keepdim=True)
        return (mu + shift).expand(g.shape).to(g.dtype)
    return _where_byz(byz_mask, tree_map(mal, stacked_grads), stacked_grads)


@register("colluding_mimic",
          "omniscient collusion: all byzantine report the *same* crafted "
          "point far away, forming a fake cluster to drag the median")
def colluding_mimic_attack(stacked_grads, byz_mask, key, *,
                           scale: float = 50.0, **_kw):
    def norm(x, s):
        if s is None:
            return torch.linalg.norm(x)
        return torch.sqrt(sa.sq_norm(s, [x], lead_axes=1))

    def mal(g, k, s):
        mu = torch.mean(g, dim=0, keepdim=True)
        direction = sa.draw_block(s, mu, k, "normal")
        direction = direction / torch.clamp(norm(direction, s), min=1e-12)
        point = mu + scale * norm(mu, s) * direction.to(g.dtype)
        return point.expand(g.shape).to(g.dtype)
    leaves, keys = _per_leaf_keys(stacked_grads, key)
    specs = sa.leaf_specs(sa.current_layout(), stacked_grads)
    malicious = jtree.unflatten(
        stacked_grads, [mal(g, k, s) for g, k, s in zip(leaves, keys, specs)])
    return _where_byz(byz_mask, malicious, stacked_grads)


@register("anti_aggregation",
          "omniscient: estimate what GMoM would output on honest grads and "
          "report its negation scaled up (targets the aggregator itself)")
def anti_aggregation_attack(stacked_grads, byz_mask, key, *,
                            scale: float = 10.0, num_batches: int = 4, **_kw):
    del key
    from repro_torch.core import aggregators as agg
    m = tree_leaves(stacked_grads)[0].shape[0]
    nb = max(1, min(num_batches, m))
    while m % nb != 0:
        nb -= 1
    honest_est = agg.gmom_aggregator(stacked_grads, num_batches=nb,
                                     trim_multiplier=None, max_iters=8,
                                     shard_spec=sa.current_layout())
    malicious = tree_map(
        lambda e, g: (-scale * e[None]).expand(g.shape).to(g.dtype),
        honest_est, stacked_grads)
    return _where_byz(byz_mask, malicious, stacked_grads)


@register("label_flip",
          "non-omniscient data-poisoning proxy: gradient computed as if "
          "labels were permuted — here approximated by negating the gradient "
          "without rescaling (unit-norm sign attack)")
def label_flip_attack(stacked_grads, byz_mask, key, **_kw):
    del key
    return _where_byz(byz_mask, tree_map(lambda g: -g, stacked_grads),
                      stacked_grads)


@register("sign_flip_targeted",
          "omniscient, native to majority-vote aggregation: casts all q "
          "byzantine votes against the honest sign exactly on the "
          "coordinates where the margin is thin enough to flip the vote, "
          "and reports the honest mean elsewhere — honest-sized magnitude, "
          "maximal vote damage")
def sign_flip_targeted_attack(stacked_grads, byz_mask, key, **_kw):
    """The adversary native to ``sign_sgd_majority``: on the coordinates
    where all q Byzantine votes against the honest majority flip the
    outcome, report honest-mean magnitude with the opposing sign; report
    the honest mean elsewhere."""
    del key
    m = tree_leaves(stacked_grads)[0].shape[0]
    honest_w = torch.logical_not(byz_mask).to(torch.float32)     # (m,)
    n_h = torch.clamp(torch.sum(honest_w), min=1.0)
    q = torch.sum(byz_mask.to(torch.float32))

    def mal(g):
        gf = g.to(torch.float32)
        w = _mask_like(honest_w, gf)
        neg = torch.signbit(gf).to(torch.float32)
        n_neg_all = torch.sum(neg, dim=0, keepdim=True)
        n_neg_h = torch.sum(neg * w, dim=0, keepdim=True)
        maj_neg = 2.0 * n_neg_all > m                # honest-vote outcome
        # flippable: all q votes against the majority change the outcome
        # (ties go to +1, as in the server's vote)
        flip_pos_maj = torch.logical_and(torch.logical_not(maj_neg),
                                         2.0 * (n_neg_h + q) > m)
        flip_neg_maj = torch.logical_and(maj_neg, 2.0 * n_neg_h <= m)
        flippable = torch.logical_or(flip_pos_maj, flip_neg_maj)
        mu = torch.sum(gf * w, dim=0, keepdim=True) / n_h
        mag = torch.sum(torch.abs(gf) * w, dim=0, keepdim=True) / n_h
        against = torch.where(maj_neg, mag, -mag)
        point = torch.where(flippable, against, mu)
        return point.expand(g.shape).to(g.dtype)

    return _where_byz(byz_mask, tree_map(mal, stacked_grads), stacked_grads)


# ---------------------------------------------------------------------------
# attack schedules: multi-round adversaries as functions of the round

@dataclasses.dataclass(frozen=True)
class AttackSchedule:
    """A multi-round adversary campaign.

    ``apply(stacked_honest_grads, key, round_index, state) ->
    (reported_grads, byz_mask, new_state)``; ``state`` starts from
    ``init_state(device)``.

    Checkpoint contract (as in the reference): ``init_state`` returns a
    pytree whose structure is fixed for the schedule's lifetime with tensor
    leaves only (scalars as 0-d tensors, ``()`` when stateless), and
    ``apply`` preserves that structure and every leaf dtype.
    """
    name: str
    num_workers: int
    num_byzantine: int
    init_state: Callable[[torch.device], Any]
    apply: Callable[..., tuple]


_SCHEDULE_REGISTRY: dict[str, Callable[..., AttackSchedule]] = {}
_SCHEDULE_DESCRIPTIONS: dict[str, str] = {}


def register_schedule(name: str, description: str = ""):
    def deco(make):
        _SCHEDULE_REGISTRY[name] = make
        _SCHEDULE_DESCRIPTIONS[name] = description
        return make
    return deco


def make_schedule(name: str, *, num_workers: int, num_byzantine: int,
                  attack: str = "sign_flip", attack_kwargs=(),
                  **kwargs) -> AttackSchedule:
    if name not in _SCHEDULE_REGISTRY:
        raise KeyError(
            f"unknown schedule {name!r}; have {sorted(_SCHEDULE_REGISTRY)}")
    return _SCHEDULE_REGISTRY[name](
        num_workers=num_workers, num_byzantine=num_byzantine, attack=attack,
        attack_kwargs=tuple(attack_kwargs), **kwargs)


def available_schedules() -> list[str]:
    return sorted(_SCHEDULE_REGISTRY)


def describe() -> list[tuple[str, str]]:
    """(name, description) rows for every registered attack, sorted."""
    return [(n, _REGISTRY[n].description) for n in available()]


def describe_schedules() -> list[tuple[str, str]]:
    """(name, description) rows for every registered schedule, sorted."""
    return [(n, _SCHEDULE_DESCRIPTIONS[n]) for n in available_schedules()]


def _stateless(device):
    del device
    return ()


@register_schedule("static", "fixed Byzantine set (first q workers), same attack every round")
def static_schedule(*, num_workers, num_byzantine, attack="sign_flip",
                    attack_kwargs=(), **_kw) -> AttackSchedule:
    """Fixed Byzantine set (first q workers), same attack every round."""
    atk, kw = get_attack(attack), dict(attack_kwargs)

    def apply(stacked, key, round_index, state):
        del round_index
        mask = sample_byzantine_mask(key, num_workers, num_byzantine,
                                     rotate=False)
        return atk(stacked, mask, key, **kw), mask, state

    return AttackSchedule("static", num_workers, num_byzantine,
                          _stateless, apply)


@register_schedule("rotating", "fresh random q-subset each round — the paper's time-varying hard case")
def rotating_schedule(*, num_workers, num_byzantine, attack="sign_flip",
                      attack_kwargs=(), **_kw) -> AttackSchedule:
    """Fresh uniformly-random q-subset every round."""
    atk, kw = get_attack(attack), dict(attack_kwargs)

    def apply(stacked, key, round_index, state):
        mask = sample_byzantine_mask(key, num_workers, num_byzantine,
                                     rotate=True, round_index=round_index)
        return atk(stacked, mask, key, **kw), mask, state

    return AttackSchedule("rotating", num_workers, num_byzantine,
                          _stateless, apply)


@register_schedule("ramp_up", "corruption grows 0 -> q over ramp_rounds (slow-burn infiltration)")
def ramp_up_schedule(*, num_workers, num_byzantine, attack="sign_flip",
                     attack_kwargs=(), ramp_rounds: int = 20,
                     **_kw) -> AttackSchedule:
    """Corruption grows from 0 to q over ``ramp_rounds`` rounds, rotating
    which workers are faulty.  q_t is computed in float32 on the host, as
    the reference computes it from the traced round index."""
    atk, kw = get_attack(attack), dict(attack_kwargs)

    def apply(stacked, key, round_index, state):
        t = torch.tensor(round_index, dtype=torch.float32)
        frac = torch.clamp((t + 1.0) / ramp_rounds, max=1.0)
        q_t = int(torch.ceil(frac * num_byzantine))
        mask = sample_byzantine_mask(key, num_workers, q_t,
                                     rotate=True, round_index=round_index)
        return atk(stacked, mask, key, **kw), mask, state

    return AttackSchedule("ramp_up", num_workers, num_byzantine,
                          _stateless, apply)


@register_schedule("coordinated_switch", "all colluders switch from attack to attack2 at switch_round")
def coordinated_switch_schedule(*, num_workers, num_byzantine,
                                attack="sign_flip",
                                attack_b="inner_product",
                                attack_kwargs=(), attack_b_kwargs=(),
                                switch_round: int = 10, rotate: bool = True,
                                **_kw) -> AttackSchedule:
    """All colluders run ``attack`` until ``switch_round`` then switch to
    ``attack_b`` in lockstep."""
    atk_a, kw_a = get_attack(attack), dict(attack_kwargs)
    atk_b, kw_b = get_attack(attack_b), dict(attack_b_kwargs)

    def apply(stacked, key, round_index, state):
        mask = sample_byzantine_mask(key, num_workers, num_byzantine,
                                     rotate=rotate, round_index=round_index)
        if round_index < switch_round:
            reported = atk_a(stacked, mask, key, **kw_a)
        else:
            reported = atk_b(stacked, mask, key, **kw_b)
        return reported, mask, state

    return AttackSchedule("coordinated_switch", num_workers, num_byzantine,
                          _stateless, apply)


@register_schedule("stealth_then_strike", "stateful: honest until the aggregate gradient norm decays below trigger, then latches into attacking")
def stealth_then_strike_schedule(*, num_workers, num_byzantine,
                                 attack="sign_flip", attack_kwargs=(),
                                 strike_fraction: float = 0.25,
                                 ema_decay: float = 0.8,
                                 **_kw) -> AttackSchedule:
    """The colluders report honestly while tracking an EMA of the
    honest-mean gradient norm; once it decays below ``strike_fraction`` x
    its initial value they latch into attacking every round."""
    atk, kw = get_attack(attack), dict(attack_kwargs)

    def init_state(device):
        return {"init_norm": torch.tensor(-1.0, dtype=torch.float32,
                                          device=device),
                "ema_norm": torch.tensor(0.0, dtype=torch.float32,
                                         device=device),
                "struck": torch.tensor(False, device=device)}

    def apply(stacked, key, round_index, state):
        del round_index
        norm = torch.sqrt(sa.sq_norm(sa.current_layout(), [
            torch.mean(leaf, dim=0).to(torch.float32)
            for leaf in tree_leaves(stacked)]))
        first = state["init_norm"] < 0.0
        init_norm = torch.where(first, norm, state["init_norm"])
        ema = torch.where(first, norm,
                          ema_decay * state["ema_norm"]
                          + (1.0 - ema_decay) * norm)
        strike = torch.logical_or(state["struck"],
                                  ema < strike_fraction * init_norm)
        base = sample_byzantine_mask(key, num_workers, num_byzantine,
                                     rotate=False)
        mask = torch.logical_and(base, strike)
        reported = (atk(stacked, mask, key, **kw)
                    if _device.host_value(strike, traced=True) else stacked)
        new_state = {"init_norm": init_norm, "ema_norm": ema,
                     "struck": strike}
        return reported, mask, new_state

    return AttackSchedule("stealth_then_strike", num_workers, num_byzantine,
                          init_state, apply)
