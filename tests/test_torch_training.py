"""The port's training path against the JAX package's, on the CPU.

- ``train_loss`` and every gradient leaf against
  ``jax.value_and_grad(train_loss)`` for the eight families' SMOKE configs
  (fp32), from the JAX package's parameters carried across with
  ``params_from_numpy``; the port runs with ``remat`` on (its
  ``torch.utils.checkpoint`` route).  Loss to 1e-5; gradients at rtol 2e-4
  with atol 1e-4 × the leaf's largest |grad|.
- One AdamW step against the reference's at 1e-6, with clipping active and
  bf16 moments.
- Checkpoints written by either package's ``CheckpointManager`` restore
  bit for bit in the other's, with the same manifest.
- The JAX loop trains 4 steps (saves at 0 and 3); each package's loop then
  resumes to step 8 from its own copy of the directory, and the losses
  agree at rtol 1e-4.
- Mirrors of ``tests/test_training.py``'s ``TestCheckpointRestart`` (a
  restore onto an explicit device in place of the sharded restore, which
  is ROADMAP A.13's), ``TestStraggler`` and ``TestDataPipeline``, with
  ``repro`` → ``repro_torch`` and ``device="cpu"``.
- The launcher, and kernel E's refusal of inputs that require a gradient.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.models import transformer as jax_T
from repro.training import optimizer as jax_opt
from repro.training.loop import LoopConfig as JaxLoopConfig
from repro.training.loop import run as jax_run
from repro_torch.configs.registry import get_config
from repro_torch.core import checkpoint as ckpt_mod
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.tree import leaves, leaves_with_path, path_str
from repro_torch.data.pipeline import ContentAddressedStore, synthetic_batch
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import optimizer
from repro_torch.training.loop import LoopConfig, run
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.straggler import StragglerAbort, StragglerMonitor

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["llama3-8b", "qwen3-0.6b", "qwen2-vl-72b", "qwen2-moe-a2.7b",
            "deepseek-v3-671b", "mamba2-1.3b", "recurrentgemma-9b",
            "whisper-large-v3"]


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="train-test-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _jax_path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jax_leaves(tree) -> dict:
    return {_jax_path(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        return ckpt_mod._to_bytes(leaf)
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def _batch(cfg, B=2, S=16, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1].copy(), "labels": tok[:, 1:].copy()}
    if cfg.family == "vlm":
        batch["vision_embed"] = rng.standard_normal(
            (B, 4, cfg.d_model)).astype(np.float32)
        batch["mrope_positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.encoder_dim)).astype(np.float32)
    return batch


# ------------------------------------------------------ loss and gradients
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    jcfg = jax_get_config(arch, smoke=True)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), remat=True)
    jparams = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_T.train_loss),
                                    static_argnums=1)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    flat = [p.requires_grad_() for p in leaves(params)]
    loss = T.train_loss(params, tcfg,
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5,
                               atol=1e-5)
    want = _jax_leaves(want_grads)
    paths = [path_str(p) for p, _ in leaves_with_path(params)]
    assert sorted(paths) == sorted(want)
    for path, g in zip(paths, grads):
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=path)
    if arch == "mamba2-1.3b":        # the SSD route carries the gradient
        for path in ("layers/ssm/in_x", "layers/ssm/conv_x_w"):
            assert np.abs(want[path]).max() > 0, path


# ------------------------------------------------------------------ AdamW
def test_adamw_update_matches_jax():
    rng = np.random.default_rng(3)
    tree = lambda: {"w": rng.standard_normal((6, 5)).astype(np.float32),
                    "b": rng.standard_normal(5).astype(np.float32),
                    "blocks": [{"k": rng.standard_normal((3, 4, 2))
                                .astype(np.float32)}]}
    params, grads = tree(), jax.tree.map(lambda g: 40.0 * g, tree())
    cfg = jax_opt.AdamWConfig(lr=1e-2, warmup_steps=4,
                              moment_dtype="bfloat16")
    jstate = jax_opt.adamw_init(jax.tree.map(jnp.asarray, params), cfg)
    jstate = {"m": jax.tree.map(lambda m, g: (0.1 * g).astype(m.dtype),
                                jstate["m"], grads),
              "v": jax.tree.map(lambda v, g: (0.01 * g * g).astype(v.dtype),
                                jstate["v"], grads),
              "step": jnp.int32(2)}
    want_p, want_s, want_n = jax_opt.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jstate, cfg)
    assert float(want_n) > cfg.grad_clip          # clipping is active

    tstate = params_from_numpy(jax.tree.map(np.asarray, jstate),
                               device="cpu")
    assert tstate["step"].shape == () and tstate["step"].dtype == torch.int32
    assert tstate["m"]["w"].dtype == torch.bfloat16
    got_p, got_s, got_n = optimizer.adamw_update(
        params_from_numpy(params, device="cpu"),
        params_from_numpy(grads, device="cpu"), tstate,
        AdamWConfig(**dataclasses.asdict(cfg)))
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    assert int(got_s["step"]) == 3 and got_s["step"].dtype == torch.int32
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        w = _jax_leaves(want)
        for path, leaf in leaves_with_path(got):
            np.testing.assert_allclose(
                leaf.float().numpy(), w[path_str(path)].astype(np.float32),
                rtol=1e-6, atol=1e-6, err_msg=path_str(path))
    assert got_s["m"]["w"].dtype == torch.bfloat16


def test_adamw_init_layout():
    params = {"a": torch.ones(3, 2), "tail": [torch.zeros(4)]}
    state = optimizer.adamw_init(params, AdamWConfig(moment_dtype="bfloat16"))
    assert set(state) == {"m", "v", "step"}
    assert state["step"].shape == () and state["step"].dtype == torch.int32
    assert state["m"]["tail"][0].dtype == torch.bfloat16
    assert state["v"]["a"].shape == (3, 2)


# ------------------------------------------------- checkpoints across packages
def _jax_state():
    """A train state with a list (griffin's ``tail``), leaves of several
    chunks, bf16 moments and the int32 scalar step."""
    rng = np.random.default_rng(4)
    normal = lambda *shape: jnp.asarray(rng.standard_normal(shape),
                                        jnp.float32)
    params = {"embed": normal(64, 48), "final_norm": normal(48),
              "groups": {"blk0": {"w": normal(2, 48, 40)}},
              "tail": [{"ln1": normal(48), "w": normal(48, 24)},
                       {"ln1": normal(64)}]}
    opt = jax_opt.adamw_init(params, jax_opt.AdamWConfig(
        moment_dtype="bfloat16"))
    opt["m"] = jax.tree.map(lambda p: (p * 3).astype(jnp.bfloat16), params)
    opt["step"] = jnp.int32(7)
    return {"params": params, "opt": opt}


def _manifest(db_get, step):
    m = json.loads(db_get(ckpt_mod._key("manifest", step, "", 0),
                          keyspace="meta"))
    m.pop("time")
    return m


def test_jax_checkpoint_restores_bit_exactly_in_the_port(tmpdir):
    state = _jax_state()
    jm = JaxCheckpointManager(tmpdir, chunk_bytes=4096)
    jm.save(5, state)
    jm.close()
    host = jax.tree.map(np.asarray, state)
    like = params_from_numpy(host, device="cpu")
    mgr = CheckpointManager(tmpdir, chunk_bytes=4096, device="cpu")
    assert mgr.latest_step() == 5
    got, step = mgr.restore(like)
    mgr.close()
    assert step == 5
    want = _jax_leaves(host)
    for path, leaf in leaves_with_path(got):
        w = want[path_str(path)]
        assert tuple(leaf.shape) == w.shape, path
        assert ckpt_mod._dtype_name(leaf.dtype) == str(w.dtype), path
        assert _bytes(leaf) == _bytes(w), path
    assert got["opt"]["m"]["embed"].dtype == torch.bfloat16
    assert got["params"]["tail"][1]["ln1"].shape == (64,)
    assert got["opt"]["step"].shape == () and int(got["opt"]["step"]) == 7


def test_port_checkpoint_restores_bit_exactly_in_jax(tmpdir):
    state = _jax_state()
    host = jax.tree.map(np.asarray, state)
    port_dir, jax_dir = os.path.join(tmpdir, "port"), os.path.join(tmpdir,
                                                                   "jax")
    mgr = CheckpointManager(port_dir, chunk_bytes=4096, device="cpu")
    mgr.save(5, params_from_numpy(host, device="cpu"))
    port_manifest = _manifest(mgr.db.get, 5)
    mgr.close()
    jm = JaxCheckpointManager(jax_dir, chunk_bytes=4096)
    jm.save(5, state)
    assert _manifest(jm.db.get, 5) == port_manifest
    jm.close()
    jm = JaxCheckpointManager(port_dir, chunk_bytes=4096)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        state)
    got, step = jm.restore(like)
    jm.close()
    assert step == 5
    want, have = _jax_leaves(host), _jax_leaves(got)
    assert sorted(want) == sorted(have)
    for path, w in want.items():
        assert have[path].dtype == w.dtype, path
        assert _bytes(have[path]) == _bytes(w), path


# ------------------------------------------------------ the loop across packages
def test_resumed_loop_matches_jax(tmpdir):
    arch = "llama3-8b"
    jcfg, tcfg = jax_get_config(arch, smoke=True), get_config(arch,
                                                              smoke=True)
    jopt = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=3)
    data = lambda step: synthetic_batch(step, batch=2, seq=16,
                                        vocab=jcfg.vocab)
    quiet = lambda s: None
    first = jax_run(jcfg, jopt, JaxLoopConfig(total_steps=4,
                                              checkpoint_every=3),
                    lambda s: {k: jnp.asarray(v) for k, v in data(s).items()},
                    os.path.join(tmpdir, "run"), log_fn=quiet)
    assert len(first["losses"]) == 4
    jax_dir, port_dir = (os.path.join(tmpdir, d) for d in ("jax", "port"))
    shutil.copytree(os.path.join(tmpdir, "run"), jax_dir)
    shutil.copytree(os.path.join(tmpdir, "run"), port_dir)
    want = jax_run(jcfg, jopt, JaxLoopConfig(total_steps=8,
                                             checkpoint_every=3),
                   lambda s: {k: jnp.asarray(v) for k, v in data(s).items()},
                   jax_dir, log_fn=quiet)
    got = run(tcfg, AdamWConfig(**dataclasses.asdict(jopt)),
              LoopConfig(total_steps=8, checkpoint_every=3),
              lambda s: {k: torch.from_numpy(v) for k, v in data(s).items()},
              port_dir, log_fn=quiet, device="cpu")
    assert want["resumed_from"] == got["resumed_from"] == 3
    assert len(got["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


# ------------------------------------------- mirrors of tests/test_training.py
CFG = get_config("llama3-8b", smoke=True)
OPT = AdamWConfig(lr=1e-3, warmup_steps=5)


def batch_fn(step):
    b = synthetic_batch(step, batch=2, seq=16, vocab=CFG.vocab)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def pinned_batch_fn(step):
    """Two repeating batches from a pinned seed: a learnable (memorizable)
    stream, unlike fresh random tokens whose loss floor is ln(vocab)."""
    b = synthetic_batch(step % 2, batch=2, seq=16, vocab=CFG.vocab)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _init(seed):
    return T.init_params(CFG, torch.Generator().manual_seed(seed))


class TestCheckpointRestart:
    def test_loss_decreases_and_checkpoints(self, tmpdir):
        out = run(CFG, OPT, LoopConfig(total_steps=12, checkpoint_every=5,
                                       seed=0),
                  pinned_batch_fn, tmpdir, log_fn=lambda s: None,
                  device="cpu")
        # Smoothed tail-vs-head comparison: single-step losses are noisy.
        losses = out["losses"]
        assert np.mean(losses[-4:]) < np.mean(losses[:4])
        ckpt = CheckpointManager(tmpdir, device="cpu")
        assert ckpt.latest_step() == 11
        ckpt.close()

    def test_crash_resume_continues_exactly(self, tmpdir):
        with pytest.raises(RuntimeError, match="injected"):
            run(CFG, OPT, LoopConfig(total_steps=20, checkpoint_every=4,
                                     fail_at_step=10),
                batch_fn, tmpdir, log_fn=lambda s: None, device="cpu")
        out = run(CFG, OPT, LoopConfig(total_steps=20, checkpoint_every=4),
                  batch_fn, tmpdir, log_fn=lambda s: None, device="cpu")
        assert out["resumed_from"] == 8          # last checkpoint before 10
        # uninterrupted reference run matches the resumed run's tail
        d2 = tempfile.mkdtemp()
        try:
            ref = run(CFG, OPT, LoopConfig(total_steps=20,
                                           checkpoint_every=4),
                      batch_fn, d2, log_fn=lambda s: None, device="cpu")
            np.testing.assert_allclose(out["final_loss"], ref["final_loss"],
                                       rtol=1e-4)
        finally:
            shutil.rmtree(d2, ignore_errors=True)

    def test_checkpoint_values_roundtrip(self, tmpdir):
        params = _init(1)
        ckpt = CheckpointManager(tmpdir, chunk_bytes=4096,  # force chunking
                                 device="cpu")
        ckpt.save(7, {"params": params})
        restored, step = ckpt.restore({"params": params})
        assert step == 7
        for a, b in zip(leaves(params), leaves(restored["params"])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        ckpt.close()

    def test_step_retention_epoch_pruning(self, tmpdir):
        params = {"w": torch.arange(4096, dtype=torch.float32)}
        ckpt = CheckpointManager(tmpdir, keep_last=2, device="cpu")
        for s in range(6):
            ckpt.save(s, params)
        steps = ckpt.list_steps()
        assert 5 in steps and 4 in steps
        ckpt.close()

    def test_restore_onto_an_explicit_device(self, tmpdir):
        """A restart restores onto the device its manager names, whatever
        device wrote the checkpoint (values are raw leaf bytes)."""
        params = _init(2)
        ckpt = CheckpointManager(tmpdir, device="cpu")
        ckpt.save(3, params)
        ckpt.close()
        ckpt = CheckpointManager(tmpdir, device=torch.device("cpu"))
        restored, step = ckpt.restore(params)
        assert step == 3
        for a, b in zip(leaves(params), leaves(restored)):
            assert b.device == torch.device("cpu")
            assert torch.equal(a, b)
        ckpt.close()


class TestStraggler:
    def test_monitor_flags_and_aborts(self):
        mon = StragglerMonitor(threshold=2.0, patience=2, action="abort",
                               ema_alpha=0.5)
        import time as _t
        for _ in range(3):                       # healthy baseline
            mon.step_start(); _t.sleep(0.01); mon.step_end(0)
        mon.step_start(); _t.sleep(0.08); mon.step_end(1)
        assert mon.slow_streak == 1
        with pytest.raises(StragglerAbort):
            mon.step_start(); _t.sleep(0.08); mon.step_end(2)
        assert len(mon.events) == 2

    def test_healthy_steps_recover_streak(self):
        mon = StragglerMonitor(threshold=2.0, patience=3)
        import time as _t
        for _ in range(3):
            mon.step_start(); _t.sleep(0.01); mon.step_end(0)
        mon.step_start(); _t.sleep(0.05); mon.step_end(1)
        mon.step_start(); _t.sleep(0.01); mon.step_end(2)
        assert mon.slow_streak == 0


class TestDataPipeline:
    def test_synthetic_deterministic(self):
        a = synthetic_batch(5, 2, 16, 1000)
        b = synthetic_batch(5, 2, 16, 1000)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_content_addressed_dedup(self, tmpdir):
        store = ContentAddressedStore(tmpdir, background=False, device="cpu")
        toks = synthetic_batch(0, 8, 32, 1000)["tokens"]
        keys1 = store.ingest_tokens(toks, epoch=0)
        keys2 = store.ingest_tokens(toks, epoch=1)   # identical content
        assert keys1 == keys2
        assert store.inserted == 8 and store.dedup_hits == 8
        sample = store.get(keys1[0])
        np.testing.assert_array_equal(
            np.frombuffer(sample, np.int32), toks[0])
        store.close()


def test_synthetic_batch_is_the_reference_bits():
    from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
    for step in (0, 5):
        want, got = jax_synthetic_batch(step, 3, 8, 151936), \
            synthetic_batch(step, 3, 8, 151936)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------- launcher, route
def test_launcher_trains_on_the_host(tmpdir):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3-8b", "--smoke", "--device", "cpu", "--steps", "3",
         "--ckpt-dir", os.path.join(tmpdir, "ckpt")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[train] llama3-8b: loss" in res.stdout
    assert "resumed_from=None" in res.stdout


def test_ssd_refuses_inputs_that_require_grad():
    """Kernel E's outputs carry no gradient, so ``ops.ssd`` refuses inputs
    that need one (on every device); training takes the plain SSD."""
    g = torch.Generator().manual_seed(0)
    b, l, h, p, n = 1, 8, 2, 4, 4
    x = torch.randn((b, l, h, p), generator=g)
    dt = torch.rand((b, l, h), generator=g)
    A = -torch.rand((h,), generator=g)
    Bm, Cm = torch.randn((b, l, n), generator=g), torch.randn((b, l, n),
                                                              generator=g)
    ssd(x, dt, A, Bm, Cm, chunk=4)
    for i in range(5):
        args = [x, dt, A, Bm, Cm]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(ValueError, match="differentiate"):
            ssd(*args, chunk=4)
    cfg = get_config("mamba2-1.3b", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    flat = [t.requires_grad_() for t in leaves(params)]
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="differentiate"):
        T.forward(params, cfg, tokens)
    logits, _ = T.forward(params, cfg, tokens, train=True)
    logits.float().square().mean().backward()
    assert params["layers"]["ssm"]["in_x"].grad.abs().max() > 0
    assert all(t.grad is not None for t in flat)


def test_prefill_and_decode_step_factories():
    """``make_prefill_step`` / ``make_decode_step`` run ``serve.prefill`` /
    ``serve.decode_step`` without building a graph."""
    from repro_torch.models import serve
    from repro_torch.training.step import (init_train_state,
                                           make_decode_step,
                                           make_prefill_step)
    cfg = get_config("qwen3-0.6b", smoke=True)
    params, opt_state = init_train_state(
        cfg, AdamWConfig(), torch.Generator().manual_seed(5))
    assert set(opt_state) == {"m", "v", "step"}
    for t in leaves(params):
        t.requires_grad_()
    tokens = torch.tensor([[3, 1, 4, 1], [5, 9, 2, 6]], dtype=torch.int32)
    logits, cache = make_prefill_step(cfg, 8)(params, {"tokens": tokens})
    nxt = logits.argmax(-1).to(torch.int32)
    step_logits, _ = make_decode_step(cfg)(params, cache, nxt)
    assert not logits.requires_grad and not step_logits.requires_grad
    with torch.no_grad():
        want, want_cache = serve.prefill(params, cfg, {"tokens": tokens}, 8)
        want_step, _ = serve.decode_step(params, cfg, want_cache, nxt)
    assert torch.equal(logits, want) and torch.equal(step_logits, want_step)
