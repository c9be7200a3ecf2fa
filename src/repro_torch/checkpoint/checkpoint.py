"""Msgpack + npz pytree checkpoints in the reference's on-disk layout.

Layout: ``<dir>/step_<n:08d>/{manifest.msgpack, arrays.npz}``.  The
manifest records leaf paths, dtypes, shapes, ``format_version`` (2) and an
optional ``payload`` tag; arrays go in one ``.npz`` (stored, not
compressed: random and trained weights do not compress, and an LM's
optimizer state is gigabytes; ``np.load`` reads both kinds).  bfloat16
leaves are stored as the reference stores them, their raw two-byte words
(``|V2`` in the archive) under the manifest dtype ``bfloat16``.  Leaf paths
are the strings ``jax.tree_util.tree_flatten_with_path`` gives
(``.field`` for named tuples, ``['key']`` for dicts in sorted key order,
``[i]`` for sequences, joined by ``/``), so the port restores what the
JAX package saved and the other way round.  Writes are atomic
(temp dir + rename); restore is dtype-strict unless ``allow_cast=True``.

Leaves may be torch tensors (restored onto the example leaf's device) or
numpy arrays (restored as numpy).
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import tree as jtree

FORMAT_VERSION = 2


def _flatten_with_paths(tree, prefix=()):
    """[(path string, leaf)] in the reference's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for name, sub in items:
        out += _flatten_with_paths(sub, prefix + (name,))
    return out


BF16 = "bfloat16"


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return BF16
        return str(torch.empty((0,), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _bf16_tensor(arr: np.ndarray, stored: str, device) -> torch.Tensor:
    """A stored leaf as a bfloat16 tensor: raw words when it was saved as
    bfloat16, a rounding cast of its values otherwise."""
    if stored == BF16:
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.as_tensor(words, device=device).view(torch.bfloat16)
    return torch.as_tensor(arr, device=device).to(torch.bfloat16)


def save(directory: str, step: int, tree, *, keep: int | None = 3,
         payload: str | None = None) -> str:
    """Serialize ``tree`` under ``directory/step_<step>``; returns the path."""
    import msgpack
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "format_version": FORMAT_VERSION, "leaves": []}
    if payload is not None:
        manifest["payload"] = payload
    for i, (p, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = _as_numpy(leaf)
        key = f"leaf_{i}"
        arrays[key] = arr
        manifest["leaves"].append(
            {"path": p, "key": key, "dtype": _dtype_name(leaf),
             "shape": list(arr.shape)})

    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(msgpack.packb(manifest))
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    if keep is not None:
        for old in all_steps(directory)[:-keep]:
            shutil.rmtree(os.path.join(directory, f"step_{old:08d}"),
                          ignore_errors=True)
    return final


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name[len("step_"):]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> dict:
    """The raw manifest; legacy (unversioned) checkpoints report 1."""
    import msgpack
    path = os.path.join(directory, f"step_{step:08d}", "manifest.msgpack")
    with open(path, "rb") as f:
        manifest = msgpack.unpackb(f.read())
    manifest.setdefault("format_version", 1)
    return manifest


def restore(directory: str, step: int, example_tree, *,
            allow_cast: bool = False):
    """Restore into the structure of ``example_tree``; shapes and dtypes
    are checked against the manifest (a dtype mismatch raises unless
    ``allow_cast``)."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = read_manifest(directory, step)
    dtypes = {e["path"]: e["dtype"] for e in manifest["leaves"]}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        stored = {e["path"]: data[e["key"]] for e in manifest["leaves"]}

    new_leaves = []
    for p, example in _flatten_with_paths(example_tree):
        if p not in stored:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        arr = stored[p]
        shape = tuple(example.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"shape mismatch for {p!r}: ckpt {arr.shape} vs {shape}")
        want = _dtype_name(example)
        if dtypes[p] != want and not allow_cast:
            raise ValueError(
                f"dtype mismatch for {p!r}: ckpt {dtypes[p]} vs {want} "
                "(pass allow_cast=True to cast)")
        if want == BF16:
            new_leaves.append(_bf16_tensor(arr, dtypes[p], example.device))
            continue
        if dtypes[p] == BF16:    # raw words -> values, then the cast
            arr = _bf16_tensor(arr, BF16, "cpu").float().numpy()
        arr = arr.astype(want)
        if isinstance(example, torch.Tensor):
            new_leaves.append(torch.as_tensor(arr, device=example.device))
        else:
            new_leaves.append(arr)
    return jtree.unflatten(example_tree, new_leaves)
