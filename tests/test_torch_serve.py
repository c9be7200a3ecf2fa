"""The port's serve CLI (repro_torch.launch.serve and steps) against
the JAX package's ``serve_cpu``.

``serve_cpu`` draws its params and prompts with jax.random from --seed;
the port draws its own from a torch.Generator, so the parity check hands
the reference's params and prompts across (``convert``) and runs the
port's greedy loop on them: in float32 the tokens must be equal."""

import argparse

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch import configs, convert
from repro_torch.launch import serve, steps
from repro_torch.models import model


@pytest.fixture(autouse=True)
def _threefry_original():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _args(**kw):
    base = dict(arch="h2o-danube-3-4b", scale="cpu", batch=4, prompt_len=16,
                new_tokens=32, shape="decode_32k", multi_pod=False, seed=0)
    return argparse.Namespace(**dict(base, **kw))


@pytest.mark.parametrize("seed,prompt_len", [(0, 16), (1, 80)])
def test_greedy_tokens_equal_jax_serve_cpu(seed, prompt_len):
    """The reference's defaults (4 requests, 16-token prompts, 32 new
    tokens), and prompts of 80 > the reduced window of 64 (the ring
    wraps)."""
    args = _args(seed=seed, prompt_len=prompt_len)
    want = np.asarray(jserve.serve_cpu(args))
    # serve_cpu's own params and prompts, drawn again
    jcfg = jconfigs.get_config(args.arch).reduced()
    jparams = jmodel.init(jax.random.PRNGKey(args.seed), jcfg)
    prompt_key = jax.random.fold_in(jax.random.PRNGKey(args.seed), 1)
    prompts = np.array(jax.random.randint(
        prompt_key, (args.batch, args.prompt_len), 0, jcfg.vocab_size))
    cfg = configs.get_config(args.arch).reduced()
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), "cpu")
    tokens, logits, times = serve.generate(params, cfg,
                                           torch.as_tensor(prompts),
                                           args.new_tokens)
    assert tokens.shape == (args.batch, args.new_tokens)
    np.testing.assert_array_equal(tokens.numpy(), want)
    assert times["prefill_s"] > 0 and times["decode_s"] > 0


def test_serve_cpu_from_the_command_line(capsys):
    tokens, stats = serve.main(["--scale", "cpu", "--seed", "3"])
    assert tokens.shape == (4, 32)
    assert tokens.dtype == torch.int64
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 512
    assert stats["tokens_per_s"] > 0
    assert "[serve] h2o-danube-3-4b" in capsys.readouterr().out
    again, _ = serve.main(["--scale", "cpu", "--seed", "3"])
    other, _ = serve.main(["--scale", "cpu", "--seed", "4"])
    assert torch.equal(tokens, again) and not torch.equal(tokens, other)


@pytest.mark.parametrize("flags", [["--shape", "decode_32k"],
                                   ["--multi-pod"]])
def test_pod_flags_are_refused(flags):
    with pytest.raises(SystemExit):
        serve.main(["--scale", "cpu", *flags])


@pytest.mark.parametrize("flags", [["--scale", "gpu"], []],
                         ids=["explicit", "default"])
def test_gpu_scale_wants_the_card(flags):
    """``--scale gpu`` is the default: the CLI serves on the card unless
    asked for the CPU, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py serves at full width")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(flags)


def test_prompts_do_not_reuse_the_params_stream():
    """The prompts' generator is seeded apart from the params' (the
    reference folds its key for them)."""
    cfg = configs.get_config("h2o-danube-3-4b").reduced()
    drawn = serve.draw_prompts(0, cfg, 4, 16, "cpu")
    assert torch.equal(drawn, serve.draw_prompts(0, cfg, 4, 16, "cpu"))
    reused = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(0))
    assert not torch.equal(drawn, reused)
    assert not torch.equal(drawn, serve.draw_prompts(1, cfg, 4, 16, "cpu"))


def test_steps_are_the_model_functions():
    cfg = configs.get_config("h2o-danube-3-4b").reduced()
    params = model.init(1, cfg, device="cpu")
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)))
    torch.testing.assert_close(
        steps.make_prefill_step(cfg)(params, {"tokens": tokens}),
        model.prefill(params, cfg, {"tokens": tokens}), atol=0, rtol=0)
    # on the CPU, plain=True is the same path
    torch.testing.assert_close(
        steps.make_prefill_step(cfg, plain=True)(params, {"tokens": tokens}),
        model.prefill(params, cfg, {"tokens": tokens}), atol=0, rtol=0)
    s1 = model.init_decode_state(cfg, 2, 12, device="cpu")
    s2 = model.init_decode_state(cfg, 2, 12, device="cpu")
    pos = torch.zeros(2, dtype=torch.int64)
    a, _ = steps.make_serve_step(cfg)(params, s1, tokens[:, :1], pos)
    b, _ = model.decode_step(params, cfg, s2, tokens[:, :1], pos)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert a.shape == (2, 1, cfg.vocab_size)
