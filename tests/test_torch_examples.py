"""The port's example scripts (examples/torch_*.py) run on the CPU at a
reduced size when asked for it, and tell what the reference examples
tell: gmom converges under the sign flip where the mean breaks.  On the
card they are the same code with ``device=None``."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_lm_parity import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    path = os.path.join(REPO, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_gmom_converges_where_the_mean_breaks(capsys):
    errors = _example("quickstart").main("cpu", rounds=12)
    assert errors["gmom"] < 1.0 < errors["mean"]
    assert "theory floor" in capsys.readouterr().out


def test_linear_regression_sweep_covers_every_attack():
    """Three rounds of every attack: under the sign flip gmom's error
    falls far below the mean's."""
    from repro_torch.core import byzantine
    traces = _example("linear_regression_byzantine").main(
        ["--device", "cpu", "--rounds", "3"])
    assert {atk for _, atk in traces} == set(byzantine.available())
    assert all(len(t) == 4 and np.all(np.isfinite(t))
               for t in traces.values())
    gmom, mean = traces[("gmom", "sign_flip")], traces[("mean", "sign_flip")]
    assert gmom[-1] < 0.5 * min(gmom[0], mean[-1])


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-26b"])
def test_train_lm_under_attack_runs_the_stub_families(arch):
    """The families whose batches carry frames or patches (the dense one
    is the reference example's own default)."""
    results = _example("train_lm_under_attack").main(
        ["--arch", arch, "--steps", "1", "--seq-len", "24", "--device",
         "cpu"])
    assert set(results) == {("mean", "none"), ("mean", "sign_flip"),
                            ("gmom", "sign_flip")}
    assert all(len(t) == 1 and np.all(np.isfinite(t))
               for t in results.values())


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "granite-moe-1b-a400m",
                                  "rwkv6-7b", "zamba2-2.7b",
                                  "seamless-m4t-medium", "internvl2-26b"])
def test_serve_decode_serves_every_family(arch):
    from repro_torch.configs import get_config
    out = _example("serve_decode").main(
        ["--arch", arch, "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "4", "--device", "cpu"])
    assert out.shape == (2, 4) and out.dtype == torch.int64
    assert 0 <= int(out.min()) and int(out.max()) < \
        get_config(arch).reduced().vocab_size


def test_examples_want_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example("serve_decode").main(["--new-tokens", "2"])
