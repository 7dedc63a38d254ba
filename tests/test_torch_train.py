"""repro_torch's training loop vs repro's, on the CPU.

The port's counterparts of ``tests/test_train_infra.py`` (loss decrease,
microbatch equivalence, bitwise restart, async checkpoints and their GC,
preemption, stragglers, pipeline determinism), then the port held to the
JAX package on the same seeded numpy inputs, each part apart (AdamW is
held in ``tests/test_torch_optimizer.py``):

- gradients of each loss on identical params against ``jax.grad``: each
  leaf within 1e-5 of that leaf's max |g| (f32 sums in another order), the
  loss within 1e-5 relative;
- the whole loop: the losses of 5 steps within 1e-5 relative (parameters
  are not compared elementwise after several steps: early Adam steps are
  about sign(g), so noise in a near-zero gradient can move an element by a
  whole lr either way);
- checkpoints cross both ways with no hand step: the port's
  ``load_latest`` opens a JAX checkpoint and JAX's opens a port one, and
  either continues with the other's losses, within 1e-5 relative;
  ``params_to_jax`` inverts ``params_from_jax`` leaf for leaf, for the
  transformer and the recsys families.

Gradient ties: ``splade_head_ref`` takes ``amax`` over tokens, which splits
the gradient evenly among tied maxima, as ``jnp.max`` does; its
``clamp_min(x, 0)`` passes the full gradient at exactly 0 where
``jnp.maximum(x, 0)`` passes half.  Only an exactly-zero logit tells the
two apart, and seeded random inputs do not make one.
"""
import copy
import dataclasses
import functools
import json
import os
import shutil
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.checkpoint import load_latest as j_load_latest
from repro.configs import autoint as j_autoint
from repro.configs import dien as j_dien
from repro.configs import din as j_din
from repro.configs import gpusparse as j_gpusparse
from repro.configs import qwen2_0_5b as j_qwen
from repro.configs import xdeepfm as j_xdeepfm
from repro.data import pipeline as jpipe
from repro.models.recsys import build_model as j_build_model
from repro.models.splade import SpladeEncoder as JEncoder
from repro.models.transformer import TransformerLM as JLM
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.checkpoint import Checkpointer, load_latest
from repro_torch.configs import autoint, dien, din, gpusparse, qwen2_0_5b
from repro_torch.configs import xdeepfm
from repro_torch.configs.base import TransformerConfig
from repro_torch.data.pipeline import (
    DeterministicPipeline, lm_batch_fn, paired_batch_fn,
)
from repro_torch.data.synthetic import make_recsys_batch
from repro_torch.models.recsys import build_model
from repro_torch.models.recsys import params_from_jax as recsys_from_jax
from repro_torch.models.recsys import params_to_jax as recsys_to_jax
from repro_torch.models.splade import SpladeEncoder
from repro_torch.models.transformer import (
    TransformerLM, params_from_jax, params_to_jax,
)
from repro_torch.runtime import (
    FaultToleranceSupervisor, StragglerMonitor, run_with_restarts,
)
from repro_torch.train import (
    AdamWConfig, Trainer, adamw_init, copy_state, init_state, make_train_step,
)
from repro_torch.train.train_loop import to_device

GRAD_TOL = 1e-5  # of each leaf's max |g|
LOSS_RTOL = 1e-5
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

TINY = TransformerConfig(
    name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
    vocab_size=128, dtype="float32", param_dtype="float32", remat=False,
)


def _tiny_lm(seed: int = 0) -> TransformerLM:
    return TransformerLM(TINY, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


def _state(model, adamw) -> dict:
    return init_state(dict(model.named_parameters()), adamw).as_dict()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the port's counterparts of tests/test_train_infra.py ------------------

def test_loss_decreases():
    model = _tiny_lm()
    adamw = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=100)
    step = make_train_step(model.loss_fn, adamw)
    state = _state(model, adamw)
    batch = lm_batch_fn(8, 16, 128)(0, 0)
    losses = []
    for _ in range(20):
        state, m = step(state, batch)  # same batch: must overfit
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5
    assert set(m) == {"loss", "lr", "grad_norm"}  # aux metrics dropped


def test_microbatch_equivalence():
    model = _tiny_lm()
    adamw = AdamWConfig()
    batch = lm_batch_fn(8, 16, 128)(0, 5)
    outs, losses = [], []
    for mb in (1, 2, 4):
        m = copy.deepcopy(model)
        state, metrics = make_train_step(m.loss_fn, adamw, microbatches=mb)(
            _state(m, adamw), batch)
        outs.append({k: v.detach().clone() for k, v in
                     state["params"].items()})
        losses.append(float(metrics["loss"]))
    for other in outs[1:]:
        for k in outs[0]:
            np.testing.assert_allclose(outs[0][k].numpy(), other[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(losses[1:], losses[0], rtol=1e-6)


def test_checkpoint_restart_bitexact():
    model = _tiny_lm()
    adamw = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)
    step = make_train_step(model.loss_fn, adamw)
    make = lm_batch_fn(4, 16, 128)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, async_write=False)
        tr = Trainer(step, _state(model, adamw),
                     iter(DeterministicPipeline(make, seed=0, prefetch=0)),
                     checkpointer=ck, checkpoint_every=3)
        tr.run(6)  # checkpoints at 3 and 6
        ref_state = tr.state
        loaded, s = load_latest(d, ref_state)
        assert s == 6 and ck.list_steps() == [3, 6]
        flat_ref = jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.detach(), ref_state))
        for a, b in zip(jax.tree_util.tree_leaves(loaded), flat_ref):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert int(loaded["opt_state"]["step"]) == 6
        # crash + restart: another model takes the checkpoint's values
        model2 = _tiny_lm(seed=99)
        state2 = _state(model2, adamw)
        copy_state(state2, loaded)
        tr2 = Trainer(make_train_step(model2.loss_fn, adamw), state2,
                      iter(DeterministicPipeline(make, seed=0, start_step=6,
                                                 prefetch=0)), start_step=6)
        log2 = tr2.run(2)
        tr3 = Trainer(step, ref_state, iter(DeterministicPipeline(
            make, seed=0, start_step=6, prefetch=0)), start_step=6)
        log3 = tr3.run(2)
        assert [l["loss"] for l in log2] == [l["loss"] for l in log3]
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  model2.named_parameters()):
            assert torch.equal(p, q), n


def test_async_checkpoint_and_gc():
    model = _tiny_lm()
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2, async_write=True)
        state = _state(model, AdamWConfig())
        for s in (1, 2, 3, 4):
            ck.save(s, state)
        ck.wait()
        assert ck.list_steps() == [3, 4]  # GC keeps last 2
        with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["format"] == 1 and manifest["process_count"] == 1
        # the JAX key space: blocks stacked, no state_dict names
        assert "params/blocks/attn/wq" in manifest["keys"]
        assert not any("blocks." in key for key in manifest["keys"])
        assert {"opt_state/step", "opt_state/mu/embed",
                "opt_state/nu/ln_f"} <= set(manifest["keys"])


def test_async_save_copies_before_the_state_changes():
    """``save`` returns with its own host copy: a step that overwrites the
    live tensors before the writer runs does not reach the checkpoint (on
    the CPU ``t.cpu()``/``t.numpy()`` would share the live memory)."""
    model = _tiny_lm()
    state = _state(model, AdamWConfig())
    before = {k: v.detach().clone() for k, v in state["params"].items()}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, async_write=True)
        mutated = threading.Event()
        write = ck._write

        def write_after_the_step(step, flat):
            assert mutated.wait(timeout=30)
            write(step, flat)

        ck._write = write_after_the_step
        ck.save(1, state)
        with torch.no_grad():
            for p in state["params"].values():
                p.add_(1.0)
            state["opt_state"]["step"].add_(5)
        mutated.set()
        ck.wait()
        loaded = ck.load(1, state)
    for k, v in before.items():
        assert torch.equal(loaded["params"][k], v), k
    assert int(loaded["opt_state"]["step"]) == 0


def test_preemption_checkpoint():
    model = _tiny_lm()
    adamw = AdamWConfig()
    step = make_train_step(model.loss_fn, adamw)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, async_write=False)
        sup = FaultToleranceSupervisor()
        pipe = DeterministicPipeline(lm_batch_fn(4, 16, 128), prefetch=0)
        tr = Trainer(step, _state(model, adamw), iter(pipe), checkpointer=ck,
                     checkpoint_every=1000, supervisor=sup)
        tr.run(2)
        sup.request_stop()  # simulated SIGTERM
        tr.run(5)  # must stop immediately + final checkpoint
        assert tr.step == 2
        assert ck.list_steps() == [2]
        assert sup.dead_hosts(timeout=3600.0) == []
        assert sup.seconds_to_deadline() <= sup.grace_seconds


def test_restart_harness_resumes_from_the_latest_checkpoint():
    """``run_with_restarts``: an injected failure at step 4, a rebuild from
    the checkpoint of step 4, and the same losses as one unbroken run."""
    adamw = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)
    make = lm_batch_fn(4, 16, 128)
    total = 7

    class Bounded:
        def __init__(self, trainer):
            self.trainer = trainer

        def run(self, n):
            return self.trainer.run(min(n, total - self.trainer.step))

    with tempfile.TemporaryDirectory() as d:
        logs = []

        def make_trainer(restarts):
            model = _tiny_lm()
            state = _state(model, adamw)
            loaded, start = load_latest(d, state)
            if loaded is not None:
                copy_state(state, loaded)
            tr = Trainer(make_train_step(model.loss_fn, adamw), state,
                         iter(DeterministicPipeline(make, start_step=start,
                                                    prefetch=0)),
                         checkpointer=Checkpointer(d, async_write=False),
                         checkpoint_every=2, start_step=start)
            logs.append(tr.metrics_log)
            return Bounded(tr)

        run_with_restarts(make_trainer, inject_failure_at=4)
    model = _tiny_lm()
    whole = Trainer(make_train_step(model.loss_fn, adamw),
                    _state(model, adamw),
                    iter(DeterministicPipeline(make, prefetch=0))).run(total)
    assert len(logs) == 2 and [m["step"] for m in logs[1]] == [5, 6, 7]
    assert ([m["loss"] for m in logs[0] + logs[1]]
            == [m["loss"] for m in whole])


def test_straggler_monitor():
    mon = StragglerMonitor(lag_steps=2, slow_factor=2.0)
    t0 = 1000.0
    for step in range(6):
        for host in range(4):
            dt = 1.0 if host != 3 else 5.0  # host 3 is 5x slower
            mon.record(host, step, now=t0 + step * dt)
    reps = mon.stragglers()
    assert any(r.host == 3 for r in reps)
    assert not any(r.host in (0, 1, 2) for r in reps)


def _example_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_splade_example", os.path.join(ROOT, "examples",
                                             "train_splade.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pipeline_determinism_and_the_jax_batches():
    make = lm_batch_fn(2, 8, 64)
    a = [make(0, s)["tokens"] for s in range(3)]
    b = [make(0, s)["tokens"] for s in range(3)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], a[1])
    pairs = (paired_batch_fn(512, 4, 6),
             _example_module().paired_batch_fn(512, 4, 6))
    for mine, theirs in ((make, jpipe.lm_batch_fn(2, 8, 64)), pairs):
        for s in range(3):
            got, want = mine(7, s), theirs(7, s)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    # prefetching and a later start step replay the same stream
    for prefetch in (0, 2):
        pipe = DeterministicPipeline(make, seed=3, start_step=1,
                                     prefetch=prefetch)
        it = iter(pipe)
        for s in (1, 2, 3):
            np.testing.assert_array_equal(next(it)["tokens"],
                                          make(3, s)["tokens"])
        pipe.close()


# -- gradients against jax.grad -------------------------------------------

def _assert_grads_match(grads: dict, jgrads: dict):
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        want = jgrads[k]
        scale = float(np.abs(want).max())
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (k, err, scale)


def _grads(model, loss_fn, batch):
    params = dict(model.named_parameters())
    loss, _ = loss_fn(to_device(batch, "cpu"))
    gs = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, gs))


def _check_loss_and_grads(jloss_fn, jparams, model, loss_fn, batch,
                          from_jax):
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(model, loss_fn, batch)
    np.testing.assert_allclose(loss, float(jl), rtol=LOSS_RTOL)
    _assert_grads_match(grads, {k: v.numpy()
                                for k, v in from_jax(_np(jg)).items()})
    return grads


@functools.lru_cache(maxsize=None)
def _encoder(seed: int = 0):
    jm = JEncoder(j_gpusparse.ENCODER_SMOKE)
    params = jax.jit(jm.init)(jax.random.key(seed))
    port = SpladeEncoder(gpusparse.ENCODER_SMOKE, device="cpu")
    port.load_state_dict(params_from_jax(_np(params)), strict=True)
    return jm, params, port


def test_contrastive_loss_grads_match_jax():
    jm, params, port = _encoder()
    batch = paired_batch_fn(512, 6, 12)(4, 0)
    batch["q_mask"][:, 9:] = 0.0  # padded queries
    _check_loss_and_grads(
        lambda p, b: jm.contrastive_loss(p, b, flops_weight=3e-2), params,
        port, lambda b: port.contrastive_loss(b, flops_weight=3e-2), batch,
        params_from_jax)
    loss, aux = port.contrastive_loss(to_device(batch, "cpu"))
    (jl, jaux) = jm.contrastive_loss(params, batch)
    for k in ("ce", "flops", "q_nnz"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL)


def test_lm_loss_grads_match_jax_and_remat_changes_no_bit():
    assert j_qwen.SMOKE.remat and qwen2_0_5b.SMOKE.remat  # as JAX sets it
    jm = JLM(j_qwen.SMOKE)
    params = jax.jit(jm.init)(jax.random.key(2))
    port = TransformerLM(qwen2_0_5b.SMOKE, device="cpu")
    port.load_state_dict(params_from_jax(_np(params)), strict=True)
    batch = lm_batch_fn(2, 24, 512)(1, 0)
    batch["loss_mask"][1, 17:] = 0.0
    grads = _check_loss_and_grads(jm.loss_fn, params, port, port.loss_fn,
                                  batch, params_from_jax)
    port.cfg = dataclasses.replace(qwen2_0_5b.SMOKE, remat=False)
    loss, plain = _grads(port, port.loss_fn, batch)
    for k, g in grads.items():
        assert torch.equal(g, plain[k]), k
    _, aux = port.loss_fn(to_device(batch, "cpu"))
    assert float(aux["aux"]) == 0.0
    np.testing.assert_allclose(float(aux["ce"]), loss, rtol=0)


def test_lm_remat_recomputes_the_blocks():
    """With remat, the forward keeps no block's activations: fewer saved
    tensors in the graph, the same loss."""
    port = TransformerLM(qwen2_0_5b.SMOKE, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    batch = to_device(lm_batch_fn(2, 32, 512)(0, 0), "cpu")
    counts, losses = {}, {}
    for remat in (True, False):
        port.cfg = dataclasses.replace(qwen2_0_5b.SMOKE, remat=remat)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            loss, _ = port.loss_fn(batch)
        counts[remat], losses[remat] = len(saved), float(loss.detach())
    assert counts[True] < counts[False] / 2
    assert losses[True] == losses[False]


RECSYS = {"xdeepfm": (j_xdeepfm, xdeepfm), "autoint": (j_autoint, autoint),
          "din": (j_din, din), "dien": (j_dien, dien)}


@pytest.mark.parametrize("model", sorted(RECSYS))
def test_recsys_loss_grads_match_jax(model):
    jmod, tmod = RECSYS[model]
    jm = j_build_model(jmod.SMOKE)
    params = jax.jit(jm.init)(jax.random.key(1))
    port = build_model(tmod.SMOKE, device="cpu")
    port.load_state_dict(recsys_from_jax(_np(params)), strict=True)
    cfg = tmod.SMOKE
    batch = make_recsys_batch(8, cfg.n_sparse, list(cfg.vocab_sizes),
                              cfg.seq_len, cfg.item_vocab, multi_hot=3,
                              seed=5)
    batch["sparse_ids"][:, ::2, 1:] = -1  # even fields: one live id
    _check_loss_and_grads(jm.loss_fn, params, port, port.loss_fn, batch,
                          recsys_from_jax)
    loss, aux = port.loss_fn(to_device(batch, "cpu"))
    assert set(aux) == {"bce"} and float(aux["bce"]) == float(loss)


# -- the whole loop and a JAX checkpoint carried into the port -------------

LOOP_ADAMW = dict(lr=2e-3, warmup_steps=2, total_steps=20)
LOOP_FLOPS = 3e-4


def _loop_batches():
    return paired_batch_fn(512, 8, 16)


def _jax_step(jm):
    return jax.jit(jloop.make_train_step(
        lambda p, b: jm.contrastive_loss(p, b, flops_weight=LOOP_FLOPS),
        jopt.AdamWConfig(**LOOP_ADAMW)))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX loop of ``examples/train_splade.py`` at ``ENCODER_SMOKE``: 5
    steps from the JAX init, a checkpoint at step 3 -> (its losses, the
    init params, the checkpoint's directory, the JAX model)."""
    jm, params, _ = _encoder(seed=6)
    adamw = jopt.AdamWConfig(**LOOP_ADAMW)
    step = _jax_step(jm)
    d = tempfile.mkdtemp(prefix="jax_ckpt_")
    tr = jloop.Trainer(step, jloop.init_state(params, adamw).as_dict(),
                       iter(jpipe.DeterministicPipeline(_loop_batches(),
                                                        prefetch=0)),
                       checkpointer=JCheckpointer(d, async_write=False),
                       checkpoint_every=3)
    losses = [m["loss"] for m in tr.run(5)]
    yield losses, params, d, jm
    shutil.rmtree(d, ignore_errors=True)


def _port_trainer(state_values, start_step: int):
    port = SpladeEncoder(gpusparse.ENCODER_SMOKE, device="cpu")
    adamw = AdamWConfig(**LOOP_ADAMW)
    state = _state(port, adamw)
    copy_state(state, state_values)
    step = make_train_step(
        lambda b: port.contrastive_loss(b, flops_weight=LOOP_FLOPS), adamw)
    return Trainer(step, state, iter(DeterministicPipeline(
        _loop_batches(), start_step=start_step, prefetch=2)),
        start_step=start_step)


def test_five_step_loop_matches_jax(jax_run):
    losses, params, _, _ = jax_run
    init = params_from_jax(_np(params))
    init = {"params": init, "opt_state": adamw_init(init)}
    got = [m["loss"] for m in _port_trainer(init, 0).run(5)]
    np.testing.assert_allclose(got, losses, rtol=LOSS_RTOL)


def test_jax_checkpoint_continues_in_the_port(jax_run):
    """The port's ``load_latest`` opens the JAX directory as it is."""
    losses, _, d, _ = jax_run
    port = SpladeEncoder(gpusparse.ENCODER_SMOKE, device="cpu")
    template = _state(port, AdamWConfig(**LOOP_ADAMW))
    state, step = load_latest(d, template)
    assert step == 3 and int(state["opt_state"]["step"]) == 3
    tr = _port_trainer(state, 3)
    got = [m["loss"] for m in tr.run(2)]
    assert [m["step"] for m in tr.metrics_log] == [4, 5]
    np.testing.assert_allclose(got, losses[3:], rtol=LOSS_RTOL)


def test_port_checkpoint_continues_in_jax(jax_run, tmp_path):
    """JAX's ``load_latest`` opens a port checkpoint of the encoder's loop
    (3 port steps from the JAX init), and JAX's steps 4-5 from it give the
    unbroken JAX run's losses."""
    losses, params, _, jm = jax_run
    init = params_from_jax(_np(params))
    tr = _port_trainer({"params": init, "opt_state": adamw_init(init)}, 0)
    tr.checkpointer = Checkpointer(str(tmp_path), async_write=False)
    tr.checkpoint_every = 3
    tr.run(3)
    adamw = jopt.AdamWConfig(**LOOP_ADAMW)
    template = jloop.init_state(params, adamw).as_dict()
    state, step = j_load_latest(str(tmp_path), template)
    assert step == 3 and int(state["opt_state"]["step"]) == 3
    jtr = jloop.Trainer(_jax_step(jm), state, iter(
        jpipe.DeterministicPipeline(_loop_batches(), start_step=3,
                                    prefetch=0)), start_step=3)
    got = [m["loss"] for m in jtr.run(2)]
    np.testing.assert_allclose(got, losses[3:], rtol=LOSS_RTOL)


@pytest.mark.parametrize("model", sorted(RECSYS))
def test_recsys_checkpoint_opens_in_jax(model, tmp_path):
    """A recsys train state saved by a plain ``Checkpointer`` opens in
    JAX's ``load_latest`` (``cin``/``attn_layers`` as lists, leaf for leaf
    the port's), and the port's ``load_latest`` reads it back bit for
    bit."""
    jmod, tmod = RECSYS[model]
    port = build_model(tmod.SMOKE, device="cpu", seed=4)
    state = _state(port, AdamWConfig())
    state["opt_state"]["step"].add_(7)
    for t in state["opt_state"]["mu"].values():
        t.normal_(generator=torch.Generator().manual_seed(t.numel()))
    Checkpointer(str(tmp_path), async_write=False).save(7, state)
    params = jax.jit(j_build_model(jmod.SMOKE).init)(jax.random.key(1))
    template = jloop.init_state(params, jopt.AdamWConfig()).as_dict()
    got, step = j_load_latest(str(tmp_path), template)
    assert step == 7 and int(got["opt_state"]["step"]) == 7
    want = {"params": recsys_to_jax(state["params"]),
            "mu": recsys_to_jax(state["opt_state"]["mu"]),
            "nu": recsys_to_jax(state["opt_state"]["nu"])}
    for key, tree in (("params", got["params"]),
                      ("mu", got["opt_state"]["mu"]),
                      ("nu", got["opt_state"]["nu"])):
        (wl, wt), (gl, gt) = (jax.tree_util.tree_flatten_with_path(t)
                              for t in (want[key], tree))
        assert wt == gt
        for (wp, a), (gp, b) in zip(wl, gl):
            assert wp == gp
            np.testing.assert_array_equal(a, np.asarray(b))
    back, step = load_latest(str(tmp_path), state)
    assert step == 7
    for k, v in _flatten_names(state).items():
        assert torch.equal(_flatten_names(back)[k], v), k


def _flatten_names(state):
    return {f"{a}/{k}": v for a, tree in (("p", state["params"]),
                                          ("mu", state["opt_state"]["mu"]),
                                          ("nu", state["opt_state"]["nu"]))
            for k, v in tree.items()}


@pytest.mark.parametrize("family", ["encoder", "xdeepfm", "autoint"])
def test_params_to_jax_inverts_params_from_jax(family):
    """Leaf for leaf and key path for key path: the JAX tree comes back
    (the encoder's blocks restacked [L, ...], xDeepFM's ``cin`` and
    AutoInt's ``attn_layers`` as lists)."""
    if family == "encoder":
        _, params, _ = _encoder(seed=2)
        to_jax, from_jax = params_to_jax, params_from_jax
    else:
        cfg = {"xdeepfm": j_xdeepfm, "autoint": j_autoint}[family].SMOKE
        params = j_build_model(cfg).init(jax.random.key(0))
        to_jax, from_jax = recsys_to_jax, recsys_from_jax
    want = _np(params)
    got = to_jax(from_jax(want))
    (wl, wt), (gl, gt) = (jax.tree_util.tree_flatten_with_path(t)
                          for t in (want, got))
    assert wt == gt
    for (wp, a), (gp, b) in zip(wl, gl):
        assert wp == gp and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
