"""The port stands alone: nothing under src/repro_torch/ and neither chip
script imports jax or the JAX package (repro), at any nesting level."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _files():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "chip_profile.py")]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith(".py")]
    return sorted(out)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_has_modules():
    names = {os.path.relpath(f, REPO) for f in _files()}
    for module in ("round.py", "geomed.py", "ops.py", "ref.py"):
        assert os.path.join("src", "repro_torch", "kernels", "geomed",
                            module) in names
    for module in ("flash.py", "ops.py", "ref.py"):
        assert os.path.join("src", "repro_torch", "kernels", "attention",
                            module) in names
    for module in ("configs/base.py", "configs/shapes.py",
                   "configs/h2o_danube3_4b.py", "configs/minitron_4b.py",
                   "configs/qwen3_14b.py", "configs/qwen2_72b.py",
                   "models/layers.py", "models/attention.py",
                   "models/blocks.py", "models/model.py",
                   "launch/steps.py", "launch/serve.py"):
        assert os.path.join("src", "repro_torch", *module.split("/")) \
            in names
    csrc = os.path.join(PORT, "kernels", "geomed", "csrc")
    for source in ("round_aggregate.cu", "linreg_round.cu", "geomed.cu"):
        assert os.path.exists(os.path.join(csrc, source))
    assert os.path.exists(os.path.join(PORT, "kernels", "attention", "csrc",
                                       "flash_attention.cu"))
    assert len(names) > 40


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_repro_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_checker_catches_a_forbidden_import():
    tree = ast.parse("def f():\n    from repro.core import grouping\n"
                     "import jax.numpy as jnp\n")
    assert set(_imported_roots(tree)) == {"repro", "jax"}
