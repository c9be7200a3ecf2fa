"""Scenario execution: one registry entry -> one multi-round run -> trace
(PyTorch port of ``repro.sim.engine``).

``run_scenario`` realizes a Scenario on the paper's linear-regression data
model, runs all rounds through ``make_run_rounds`` and returns a compact
metrics trace (estimation error vs the true theta*, aggregate-gradient
norm and loss per round) for golden comparison (``repro_torch.sim.goldens``).

``replay_scenario`` is the checkpointed twin: it runs in chunks, saving the
full ``TrainState`` at every chunk boundary, and resumes from the latest
checkpoint in ``ckpt_dir`` — including one the JAX package wrote, since
the on-disk layout is shared.

``run_failure_free`` runs a scenario's failure-free rounds from the raw
worker batches, each round one call of the whole-round linreg kernel
(``failure_free_step``); it has no JAX twin in the engine.

All are entry points: ``device=None`` means the CUDA card (raising when
there is none), ``device="cpu"`` runs on the CPU.  With
``round_backend="auto"``, gmom rounds on the card go through the CUDA
round kernel.
"""

from __future__ import annotations

import torch

from repro_torch import _device, optim
from repro_torch import random as prng
from repro_torch.core import (RobustConfig, byzantine, init_train_state,
                              make_run_rounds, restore_train_state,
                              save_train_state)
from repro_torch.core.grouping import make_grouping
from repro_torch.core.train_state import advance
from repro_torch.data import regression
from repro_torch.sim.scenarios import Scenario, get_scenario


def build_schedule(sc: Scenario) -> byzantine.AttackSchedule:
    return byzantine.make_schedule(
        sc.schedule, num_workers=sc.num_workers,
        num_byzantine=sc.num_byzantine, attack=sc.attack,
        attack_kwargs=sc.attack_kwargs, **dict(sc.schedule_kwargs))


def _robust_config(sc: Scenario, round_backend: str) -> RobustConfig:
    return RobustConfig(num_workers=sc.num_workers,
                        num_byzantine=sc.num_byzantine,
                        num_batches=sc.num_batches,
                        aggregator=sc.aggregator, attack=sc.attack,
                        attack_kwargs=sc.attack_kwargs,
                        round_backend=round_backend,
                        compression=sc.compression,
                        arrival=sc.arrival,
                        staleness_bound=sc.staleness_bound,
                        arrival_kwargs=sc.arrival_kwargs)


def _generate(sc: Scenario, key, device) -> regression.RegressionDataset:
    return regression.generate(
        key, dim=sc.dim, total_samples=sc.total_samples,
        num_workers=sc.num_workers, noise_std=sc.noise_std, device=device)


def _build_run(sc: Scenario, *, round_backend: str = "auto", device=None,
               dataset: regression.RegressionDataset | None = None):
    """Shared setup: (runner, round-zero TrainState, worker_batches, rc,
    schedule).  ``dataset`` replaces the generated data (tests hand the
    reference's arrays across)."""
    if sc.arch != "linreg":
        raise NotImplementedError(
            f"scenario {sc.name!r} targets arch {sc.arch!r}: the engine only "
            "runs the linreg substrate")
    device = _device.enter(device)
    key = prng.PRNGKey(sc.seed, device=device)
    ds = dataset if dataset is not None else _generate(sc, key, device)
    rc = _robust_config(sc, round_backend)
    opt = optim.sgd(sc.step_size)
    theta_star = ds.theta_star.to(device)

    def extra_metrics(params, agg_grad):
        del agg_grad
        return {"est_error": torch.linalg.norm(params - theta_star)}

    schedule = build_schedule(sc)
    run = make_run_rounds(regression.squared_loss, opt, rc,
                          schedule=schedule, extra_metrics=extra_metrics,
                          device=device)
    theta0 = torch.zeros((sc.dim,), dtype=torch.float32, device=device)
    state = init_train_state(theta0, opt.init(theta0), prng.fold_in(key, 999),
                             schedule=schedule)
    batches = tuple(x.to(device) for x in regression.worker_batches(ds))
    return run, state, batches, rc, schedule


def _trace(sc: Scenario, rc: RobustConfig, rounds: int, history) -> dict:
    return {
        "scenario": sc.name,
        "aggregator": sc.aggregator,
        "attack": sc.attack,
        "schedule": sc.schedule,
        "num_workers": sc.num_workers,
        "num_byzantine": sc.num_byzantine,
        "num_batches": rc.resolved_num_batches(),
        "dim": sc.dim,
        "total_samples": sc.total_samples,
        "rounds": rounds,
        "seed": sc.seed,
        "paper_floor": sc.paper_floor,
        "final_est_error": float(history["est_error"][-1]),
        "final_loss_median": float(history["loss_median"][-1]),
        "est_error": [float(v) for v in history["est_error"]],
        "agg_grad_norm": [float(v) for v in history["agg_grad_norm"]],
        "loss_median": [float(v) for v in history["loss_median"]],
        "byz_count": [int(v) for v in history["byz_count"]],
    }


def run_scenario(sc: Scenario | str, *, rounds: int | None = None,
                 round_backend: str = "auto", device=None,
                 dataset: regression.RegressionDataset | None = None) -> dict:
    """Run one scenario end to end; returns a JSON-ready trace dict."""
    if isinstance(sc, str):
        sc = get_scenario(sc)
    rounds = sc.rounds if rounds is None else rounds
    run, state, batches, rc, _ = _build_run(
        sc, round_backend=round_backend, device=device, dataset=dataset)
    state, _ = advance(run, state, batches, num_rounds=rounds)
    return _trace(sc, rc, rounds, state.history)


def failure_free_step(sc: Scenario, *, device=None,
                      dataset: regression.RegressionDataset | None = None,
                      plain: bool = False):
    """The failure-free round of Algorithm 2 on raw worker batches, the
    whole round in one kernel: theta -> theta - step_size *
    ``linreg_round_kernel``(X, y, theta), with the scenario's grouping and
    its RobustConfig's trim multiplier, ``max_iters`` and ``tol``
    (``plain=True``: the plain ``linreg_round_fused``).  No attack runs.

    -> (step, dataset): ``step`` maps theta (d,) to the next theta."""
    from repro_torch.kernels.geomed import round as round_kernels
    device = _device.enter(device)
    ds = dataset if dataset is not None else _generate(
        sc, prng.PRNGKey(sc.seed, device=device), device)
    rc = _robust_config(sc, "auto")
    grouping = make_grouping(sc.num_workers, rc.resolved_num_batches(),
                             scheme=rc.grouping_scheme)
    kw = dict(trim_multiplier=rc.trim_multiplier,
              max_iters=rc.gmom_max_iters, tol=rc.gmom_tol)
    fn = (round_kernels.linreg_round_fused if plain
          else round_kernels.linreg_round_kernel)
    x, t = ds.features.to(device), ds.targets.to(device)

    def step(theta):
        agg, _ = fn(x, t, theta, grouping, **kw)
        return theta - sc.step_size * agg

    return step, ds


def run_failure_free(sc: Scenario | str, *, rounds: int | None = None,
                     device=None,
                     dataset: regression.RegressionDataset | None = None,
                     plain: bool = False) -> dict:
    """``rounds`` failure-free rounds through ``failure_free_step`` from
    theta = 0 -> {"est_error": per round, "final_est_error"}, the keys the
    engine's trace has for them.  The errors are read back once, after the
    last round."""
    if isinstance(sc, str):
        sc = get_scenario(sc)
    rounds = sc.rounds if rounds is None else rounds
    device = _device.enter(device)
    step, ds = failure_free_step(sc, device=device, dataset=dataset,
                                 plain=plain)
    theta_star = ds.theta_star.to(device)
    theta = torch.zeros((sc.dim,), dtype=torch.float32, device=device)
    errs = []
    for _ in range(rounds):
        theta = step(theta)
        errs.append(torch.linalg.norm(theta - theta_star))
    errs = torch.stack(errs).tolist()
    return {"est_error": errs, "final_est_error": errs[-1]}


def replay_scenario(sc: Scenario | str, ckpt_dir: str, *,
                    rounds: int | None = None, ckpt_every: int = 10,
                    resume: bool = True, keep: int | None = 3,
                    device=None) -> dict:
    """Checkpointed scenario run, resumable from any chunk boundary.

    Saves the full TrainState under ``ckpt_dir`` every ``ckpt_every``
    rounds; with ``resume=True`` the latest checkpoint is restored
    (dtype-strict) and the run continues from its round.  Stopping early
    and calling again with the full count is an interrupted-then-resumed
    run."""
    from repro_torch import checkpoint
    if isinstance(sc, str):
        sc = get_scenario(sc)
    rounds = sc.rounds if rounds is None else rounds
    run, state, batches, rc, schedule = _build_run(sc, device=device)
    if resume:
        step = checkpoint.latest_step(ckpt_dir)
        if step is not None:
            state = restore_train_state(ckpt_dir, step, state.params,
                                        state.opt_state, schedule=schedule)
    while int(state.round_index) < rounds:
        n = min(ckpt_every, rounds - int(state.round_index))
        state, _ = advance(run, state, batches, num_rounds=n)
        save_train_state(ckpt_dir, state, keep=keep)
    if int(state.round_index) != rounds or not state.history:
        raise ValueError(
            f"checkpoint in {ckpt_dir!r} is at round "
            f"{int(state.round_index)}, beyond the requested {rounds} — "
            "refusing to truncate; use a fresh ckpt_dir or resume=False")
    return _trace(sc, rc, rounds, state.history)

