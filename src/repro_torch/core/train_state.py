"""The full, checkpointable state of a multi-round Byzantine GD run
(PyTorch port of ``repro.core.train_state``).

    params        model/estimator parameters (tensor pytree)
    opt_state     optimizer state (``optim.SGDState``)
    attack_state  the schedule's carried adversary memory (``()`` when
                  stateless)
    round_index   number of completed rounds (int32 0-d tensor)
    base_key      the PRNG key handed to the runner (round t folds in t)
    history       per-round metrics, dict[str, (round_index,)] float32
                  numpy arrays
    stale_buffer  always ``()`` in this slice (asynchronous arrival is
                  ROADMAP Queue 1 item 12)

Checkpoints use the reference's layout, leaf paths and dtypes
(``repro_torch.checkpoint``), so the port restores a state the JAX package
saved; the key is stored as the reference stores it, two uint32 words.
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.core import byzantine

TRAIN_STATE_PAYLOAD = "train_state"


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    attack_state: Any
    round_index: torch.Tensor
    base_key: torch.Tensor
    history: Any
    stale_buffer: Any = ()


def init_train_state(params, opt_state, base_key, *,
                     schedule: byzantine.AttackSchedule | None = None,
                     arrival=None) -> TrainState:
    """Round-zero state on the params' device: fresh adversary memory and
    an empty history."""
    if arrival is not None:
        raise NotImplementedError("asynchronous arrival is ROADMAP Queue 1 "
                                  "item 12")
    device = tree_leaves(params)[0].device
    attack_state = schedule.init_state(device) if schedule is not None else ()
    return TrainState(params=params, opt_state=opt_state,
                      attack_state=attack_state,
                      round_index=torch.zeros((), dtype=torch.int32,
                                              device=device),
                      base_key=base_key.to(device), history={})


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def append_history(history, metrics) -> dict:
    """Concatenate a chunk's stacked per-round metrics onto ``history``
    (stored float32, exactly as the reference stores them)."""
    new = {k: _to_numpy(v) for k, v in metrics.items()}
    if not history:
        return new
    if set(history) != set(new):
        raise ValueError(
            f"metrics keys changed across chunks: {sorted(history)} vs "
            f"{sorted(new)}")
    return {k: np.concatenate([_to_numpy(history[k]), new[k]]) for k in new}


def advance(run, state: TrainState, worker_batches, *, num_rounds=None,
            per_round_batches: bool = False) -> tuple[TrainState, dict]:
    """Run one chunk of rounds through a ``make_run_rounds`` runner;
    returns ``(new_state, chunk_metrics)``."""
    params, opt_state, attack_state, stale_buffer, metrics = run(
        state.params, state.opt_state, worker_batches, state.base_key,
        num_rounds=num_rounds, start_round=state.round_index,
        attack_state=state.attack_state, stale_buffer=state.stale_buffer,
        per_round_batches=per_round_batches)
    n = int(next(iter(metrics.values())).shape[0])
    return TrainState(
        params=params, opt_state=opt_state, attack_state=attack_state,
        round_index=state.round_index + n, base_key=state.base_key,
        history=append_history(state.history, metrics),
        stale_buffer=stale_buffer), metrics


def _stored(state: TrainState) -> TrainState:
    """The state as the checkpoint holds it: the key as two uint32s."""
    return state._replace(
        base_key=state.base_key.cpu().numpy().astype(np.uint32))


def save_train_state(directory: str, state: TrainState, *,
                     keep: int | None = 3) -> str:
    """Checkpoint the full state under ``directory/step_<round_index>``."""
    from repro_torch import checkpoint
    return checkpoint.save(directory, int(state.round_index), _stored(state),
                           keep=keep, payload=TRAIN_STATE_PAYLOAD)


_HISTORY_PATH = re.compile(r"^\.history/\['(.+)'\]$")


def _history_example(manifest: dict) -> dict:
    """The history example pytree (keys/shapes/dtypes) from the manifest."""
    out = {}
    for entry in manifest["leaves"]:
        match = _HISTORY_PATH.match(entry["path"])
        if match:
            out[match.group(1)] = np.zeros(
                tuple(entry["shape"]), dtype=entry["dtype"])
    return out


def restore_train_state(directory: str, step: int, example_params,
                        example_opt_state, *,
                        schedule: byzantine.AttackSchedule | None = None,
                        arrival=None, allow_cast: bool = False
                        ) -> TrainState:
    """Dtype-strict restore of a TrainState checkpoint (the port's or the
    reference's) onto the example params' device."""
    from repro_torch import checkpoint
    if arrival is not None:
        raise NotImplementedError("asynchronous arrival is ROADMAP Queue 1 "
                                  "item 12")
    manifest = checkpoint.read_manifest(directory, step)
    if manifest["format_version"] < 2:
        raise ValueError(
            f"checkpoint at {directory!r} step {step} is a legacy "
            "params-only checkpoint (format_version "
            f"{manifest['format_version']}); restore params with "
            "repro_torch.checkpoint.restore instead")
    if manifest.get("payload") != TRAIN_STATE_PAYLOAD:
        raise ValueError(
            f"checkpoint at {directory!r} step {step} is not a TrainState "
            f"(payload={manifest.get('payload')!r}); restore it with "
            "repro_torch.checkpoint.restore")
    device = tree_leaves(example_params)[0].device
    example = TrainState(
        params=example_params, opt_state=example_opt_state,
        attack_state=(schedule.init_state(device) if schedule is not None
                      else ()),
        round_index=torch.zeros((), dtype=torch.int32, device=device),
        base_key=np.zeros((2,), np.uint32),
        history=_history_example(manifest))
    state = checkpoint.restore(directory, step, example,
                               allow_cast=allow_cast)
    return state._replace(base_key=torch.as_tensor(
        state.base_key.astype(np.int64), device=device))
