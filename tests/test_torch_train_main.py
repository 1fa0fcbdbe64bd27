"""The port's training entry point and step builders (``repro_torch.launch.
train``, ``repro_torch.launch.steps``) on the CPU at smoke width.

``launch.train.main`` handed the reference main's own weights (through its
``make_state`` hook) prints the reference main's lines and returns its
losses within rtol 1e-5; the ports of the reference's system tests (the
loss drops by 0.3 in 30 steps; a run stopped at step 6 and resumed
reproduces the uninterrupted run, here exactly on one CPU thread); the
prefill and decode builders equal the functions they wrap; the abstract
state lives on the ``meta`` device.
"""

import re

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.launch.train as RT
import repro.models.model as RM
import repro_torch.configs as PC
import repro_torch.launch.train as PT
from _torch_lm import inputs, port_batch
from repro_torch.launch.steps import (abstract_opt, abstract_params, make_decode_step,
                                      make_prefill)
from repro_torch.models import decode_step, from_reference_params, init_params, prefill

torch.set_num_threads(1)

_SECONDS = re.compile(r" \(\d+\.\ds\)$")


def _lines(out: str):
    """main's lines without their elapsed seconds."""
    return [_SECONDS.sub("", line) for line in out.splitlines()]


@pytest.mark.parametrize("arch,extra", [("qwen2.5-3b", []),
                                        ("phi-3-vision-4.2b", ["--compress-grads"])],
                         ids=["qwen", "phi3v-int8"])
def test_train_main_matches_reference(arch, extra, monkeypatch, capsys):
    argv = ["--arch", arch, "--smoke", "--steps", "8", "--batch", "4", "--seq", "32",
            "--log-every", "3", "--seed", "2"] + extra
    want = RT.main(argv)
    want_out = capsys.readouterr().out
    params = jax.tree.map(np.asarray, RM.init_params(RC.ARCHS[arch].smoke(),
                                                     jax.random.PRNGKey(2)))

    def carried(cfg, seed, device):
        assert (cfg.name, seed, device.type) == (PC.ARCHS[arch].smoke().name, 2, "cpu")
        return from_reference_params(cfg, params, device)

    monkeypatch.setattr(PT, "make_state", carried)
    got = PT.main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    np.testing.assert_allclose(got, want, rtol=1e-5)
    g, w = _lines(got_out), _lines(want_out)
    assert len(g) == len(w) == 5
    assert [l.split()[:2] for l in g] == [l.split()[:2] for l in w]
    assert g[-1].startswith("[done] first loss ") and g[-1] == w[-1]


def test_train_main_smoke():
    """Few steps of real training on a reduced arch: loss must drop."""
    losses = PT.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--steps", "30",
                      "--batch", "8", "--seq", "64", "--lr", "3e-3", "--log-every", "10",
                      "--device", "cpu"])
    assert losses[-1] < losses[0] - 0.3


@pytest.mark.parametrize("extra", [[], ["--compress-grads"]], ids=["plain", "int8"])
def test_train_resume_exact(tmp_path, capsys, extra):
    """Kill/restart fault-tolerance: resumed run reproduces the
    uninterrupted run (deterministic pipeline + exact state restore,
    the error-feedback residuals included)."""
    common = ["--arch", "qwen2.5-3b", "--smoke", "--batch", "4", "--seq", "32",
              "--ckpt-every", "6", "--device", "cpu"] + extra
    full = PT.main(common + ["--steps", "12", "--ckpt-dir", str(tmp_path / "a")])
    PT.main(common + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b")])
    capsys.readouterr()
    resumed = PT.main(common + ["--steps", "12", "--ckpt-dir", str(tmp_path / "b"),
                                "--resume"])
    assert "[resume] restored step 5, continuing at 6" in capsys.readouterr().out
    assert len(resumed) == 6
    np.testing.assert_allclose(full[6:], resumed, rtol=1e-5)
    assert full[6:] == resumed          # one CPU thread: bit for bit


def test_step_builders_and_abstract_state():
    """make_prefill and make_decode_step compute prefill and decode_step;
    abstract_params and abstract_opt have the real state's names, shapes
    and dtypes and hold no storage."""
    cfg = PC.ARCHS["gemma3-27b"].smoke()
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = port_batch(inputs(cfg, B=2, S=10))
    last, caches = make_prefill(cfg)(model, batch)
    want_last, want_caches = prefill(cfg, model, batch["tokens"])
    assert torch.equal(last, want_last)
    tok = last.argmax(-1)
    caches2 = [{k: v.clone() for k, v in c.items()} for c in want_caches]
    got, _ = make_decode_step(cfg)(model, tok, caches, 9)
    want, _ = decode_step(cfg, model, tok, caches2, 9)
    assert torch.equal(got, want)

    ap = abstract_params(cfg)
    real = dict(model.named_parameters())
    assert [(k, p.shape, p.dtype) for k, p in ap.named_parameters()] == \
        [(k, p.shape, p.dtype) for k, p in real.items()]
    assert all(p.device.type == "meta" for p in ap.parameters())
    ao = abstract_opt(ap)
    assert ao.step.device.type == "meta" and ao.step.dtype == torch.int32
    for f in ("mu", "nu", "master"):
        d = getattr(ao, f)
        assert list(d) == list(real)
        assert all(t.device.type == "meta" and t.dtype == torch.float32 and
                   t.shape == real[k].shape for k, t in d.items())
