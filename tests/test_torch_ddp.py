"""repro_torch's data-parallel training (``make_ddp_train_step``,
``train/grad_compress.py``) and ``checkpoint.reshard`` vs repro's, on the
CPU.

  * ``compressed_psum`` over two gloo ranks, in two processes, equals JAX's
    under ``shard_map`` on two forced host devices (a third process) bit
    for bit on identical gradients: the reduced gradients and each rank's
    error buffer, a first round without feedback and a second with it.
  * 3 steps of ``make_ddp_train_step`` on ``smollm-135m``'s SMOKE LM, each
    rank two rows of a global batch of 4, uncompressed and compressed,
    against JAX's ``make_ddp_train_step`` on the same mesh of two: the
    losses within 1e-5 relative uncompressed; compressed, the first
    step's within 1e-5 and the rest within 1e-4.  The int8 quantiser is a
    step function: the two packages' local gradients agree within 1e-5 of
    max |g|, so the odd element sits across a rounding step and is
    reduced a quantum apart, and AdamW's first step is about lr x sign(g)
    (0 for a gradient quantised to 0), so such an element moves by lr =
    1e-3 in one package and not the other (2.7e-5 relative on the second
    step's loss, seen).
  * At world size 1 the step is ``make_train_step`` bit for bit; the
    quantiser rounds half to even as ``jnp.round`` does; ``reshard``
    places every leaf.

Both packages start from the JAX init, written by this process with
numpy, so the three processes read the same numbers.
"""
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as j_smollm
from repro.models.transformer import TransformerLM as JLM
from repro.train import grad_compress as jgc
from repro_torch.checkpoint import reshard
from repro_torch.configs import smollm_135m
from repro_torch.data.pipeline import lm_batch_fn
from repro_torch.models.transformer import TransformerLM
from repro_torch.train import (AdamWConfig, init_state, make_ddp_train_step,
                               make_train_step)
from repro_torch.train import grad_compress as tgc

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")
STEPS = 3
LOSS_RTOL = 1e-5
QUANTISED_RTOL = 1e-4  # compressed steps after the first (see above)
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _grad_inputs():
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (33,), "c": (2, 3, 4)}
    rounds = [{k: (rng.normal(size=(2, *s)) * rng.uniform(0.01, 3))
               .astype(np.float32) for k, s in shapes.items()}
              for _ in range(2)]
    rounds[0]["c"][1] = 0.0  # rank 1 holds an all-zero leaf
    return rounds


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    params = jax.tree_util.tree_map(np.asarray, JLM(j_smollm.SMOKE).init(
        jax.random.key(0)))
    inputs = {"grads": _grad_inputs(), "params": params}
    path = tmp / "inputs.pkl"
    path.write_bytes(pickle.dumps(inputs))
    return path


def _batches():
    return [lm_batch_fn(4, 16, j_smollm.SMOKE.vocab_size)(0, i)
            for i in range(STEPS)]


JAX_TWO = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import smollm_135m
from repro.data.pipeline import lm_batch_fn
from repro.models.transformer import TransformerLM
from repro.train.grad_compress import compressed_psum
from repro.train.optimizer import AdamWConfig
from repro.train.train_loop import init_state, make_ddp_train_step
from repro.utils.compat import shard_map_compat

inputs = pickle.loads(open(sys.argv[1], "rb").read())
mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
spec = {k: P("data") for k in inputs["grads"][0]}

def two_rounds(g1, g2):
    sq = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
    un = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)
    r1, e1 = compressed_psum(sq(g1), ("data",))
    r2, e2 = compressed_psum(sq(g2), ("data",), e1)
    return un(r1), un(e1), un(r2), un(e2)

fn = jax.jit(shard_map_compat(two_rounds, mesh=mesh, in_specs=(spec, spec),
                              out_specs=(spec,) * 4))
out = {"psum": [jax.tree_util.tree_map(np.asarray, t) for t in fn(
    *[{k: jnp.asarray(v) for k, v in g.items()} for g in inputs["grads"]])]}

cfg = smollm_135m.SMOKE
model = TransformerLM(cfg)
params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
adamw = AdamWConfig(**%(ADAMW)r)
pspec = jax.tree_util.tree_map(lambda _: P(), params)
for compress in (False, True):
    bspec = {k: P("data") for k in ("tokens", "targets", "loss_mask")}
    step = jax.jit(make_ddp_train_step(model.loss_fn, adamw, mesh, ("data",),
                                       pspec, bspec, compress=compress))
    state = init_state(params, adamw).as_dict()
    if compress:
        state["err_buf"] = jax.tree_util.tree_map(jnp.zeros_like, params)
    losses = []
    for i in range(%(STEPS)r):
        batch = {k: jnp.asarray(v) for k, v in
                 lm_batch_fn(4, 16, cfg.vocab_size)(0, i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    out[compress] = losses
open(sys.argv[2], "wb").write(pickle.dumps(out))
"""

GLOO_RANK = r"""
import pickle, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import smollm_135m
from repro_torch.data.pipeline import lm_batch_fn
from repro_torch.models.transformer import TransformerLM, params_from_jax
from repro_torch.train import AdamWConfig, init_state, make_ddp_train_step
from repro_torch.train.grad_compress import compressed_psum

inputs = pickle.loads(open(sys.argv[1], "rb").read())
port, rank = sys.argv[3], int(sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
try:
    mine = [{k: torch.from_numpy(v[rank].copy()) for k, v in g.items()}
            for g in inputs["grads"]]
    r1, e1 = compressed_psum(mine[0])
    r2, e2 = compressed_psum(mine[1], error_buf=e1)
    out = {"psum": [{k: v.numpy() for k, v in t.items()}
                    for t in (r1, e1, r2, e2)]}
    cfg = smollm_135m.SMOKE
    params = params_from_jax(inputs["params"])
    for compress in (False, True):
        model = TransformerLM(cfg, device="cpu")
        model.load_state_dict(params)
        adamw = AdamWConfig(**%(ADAMW)r)
        step = make_ddp_train_step(model.loss_fn, adamw, compress=compress)
        state = init_state(dict(model.named_parameters()), adamw).as_dict()
        losses = []
        for i in range(%(STEPS)r):
            batch = lm_batch_fn(4, 16, cfg.vocab_size)(0, i)
            rows = {k: v[2 * rank:2 * rank + 2] for k, v in batch.items()}
            state, m = step(state, rows)
            losses.append(float(m["loss"]))
        out[compress] = losses
        out[f"err_buf_{compress}"] = state.get("err_buf") is not None
finally:
    dist.destroy_process_group()
open(sys.argv[2], "wb").write(pickle.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(saved, tmp_path_factory):
    """JAX on two forced host devices and two gloo ranks of the port, all
    three started in the background -> a function that waits for them."""
    tmp = tmp_path_factory.mktemp("ddp_runs")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=2")
    port = str(_free_port())
    outs = {"jax": tmp / "jax.pkl", 0: tmp / "rank0.pkl",
            1: tmp / "rank1.pkl"}
    args = dict(ADAMW=ADAMW, STEPS=STEPS)
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", JAX_TWO % args, str(saved), str(outs["jax"])],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)}
    for r in (0, 1):
        procs[r] = subprocess.Popen(
            [sys.executable, "-c", GLOO_RANK % args, str(saved),
             str(outs[r]), port, str(r)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    def result():
        for name, p in procs.items():
            log, _ = p.communicate(timeout=600)
            assert p.returncode == 0, (name, log)
        return {name: pickle.loads(o.read_bytes()) for name, o in outs.items()}

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def test_compressed_psum_over_two_gloo_ranks_is_jax_bit_for_bit(runs):
    got = runs()
    want = got["jax"]["psum"]  # (r1, e1, r2, e2), leaves [2, ...]
    for rank in (0, 1):
        for i, name in enumerate(("reduced 1", "error 1", "reduced 2",
                                  "error 2")):
            for k, w in want[i].items():
                g = got[rank]["psum"][i][k]
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, w[rank],
                                              err_msg=f"{name} {k} {rank}")
    # the feedback moved the second round: its reduced sum differs from a
    # round without it
    assert any(not np.array_equal(got[0]["psum"][2][k],
                                  got[0]["psum"][0][k]) for k in want[0])


@pytest.mark.parametrize("compress", [False, True])
def test_ddp_steps_over_two_gloo_ranks_match_jax(runs, compress):
    got = runs()
    want = got["jax"][compress]
    assert len(want) == STEPS
    for rank in (0, 1):
        np.testing.assert_allclose(got[rank][compress][0], want[0],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[rank][compress], want,
                                   rtol=QUANTISED_RTOL if compress
                                   else LOSS_RTOL)
        assert got[rank][f"err_buf_{compress}"] == compress
    assert got[0][compress] == got[1][compress]  # every rank the same loss


def _lm(seed=0):
    return TransformerLM(smollm_135m.SMOKE, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


def test_world_size_one_step_is_make_train_step_bit_for_bit():
    adamw = AdamWConfig(**ADAMW)
    out = {}
    for name in ("single", "ddp"):
        lm = _lm()
        step = (make_train_step(lm.loss_fn, adamw) if name == "single"
                else make_ddp_train_step(lm.loss_fn, adamw))
        state = init_state(dict(lm.named_parameters()), adamw).as_dict()
        losses = [float(step(state, b)[1]["loss"]) for b in _batches()]
        out[name] = losses, {k: v.detach().clone()
                             for k, v in lm.named_parameters()}
    assert out["single"][0] == out["ddp"][0]
    for k, v in out["single"][1].items():
        assert torch.equal(v, out["ddp"][1][k]), k


def test_compressed_step_keeps_the_residual_at_world_size_one():
    """One rank: the reduced gradient plus the error is the gradient (the
    quantisation residual is all kept), as JAX's own test holds it."""
    g = {k: torch.from_numpy(v[0]) for k, v in _grad_inputs()[0].items()}
    red, err = tgc.compressed_psum(g)
    for k in g:
        np.testing.assert_allclose((red[k] + err[k]).numpy(), g[k].numpy(),
                                   rtol=1e-6, atol=1e-7)
    lm = _lm()
    adamw = AdamWConfig(**ADAMW)
    step = make_ddp_train_step(lm.loss_fn, adamw, compress=True)
    state = init_state(dict(lm.named_parameters()), adamw).as_dict()
    state, _ = step(state, _batches()[0])
    assert set(state["err_buf"]) == set(state["params"])


def test_quantiser_rounds_half_to_even_as_jax():
    scale = np.float32(0.25)
    g = ((np.arange(-20, 20) + 0.5) * scale).astype(np.float32)
    g = np.concatenate([g, np.float32([1e3, -1e3, 0.0, 31.75])])
    want = np.asarray(jgc.quantize_leaf(jnp.asarray(g), jnp.float32(scale)))
    got = tgc.quantize_leaf(torch.from_numpy(g), torch.tensor(scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tgc.dequantize_leaf(got, torch.tensor(scale)).numpy(),
        np.asarray(jgc.dequantize_leaf(jnp.asarray(want),
                                       jnp.float32(scale))))
    tree = {k: torch.from_numpy(v[0]) for k, v in _grad_inputs()[0].items()}
    assert tgc.compression_ratio(tree) == jgc.compression_ratio(
        {k: jnp.asarray(v.numpy()) for k, v in tree.items()})


def test_reshard_places_every_leaf():
    tree = {"params": {"w": np.ones((2, 3), np.float32),
                       "b": torch.zeros(3)},
            "opt_state": {"step": np.int32(4),
                          "mu": [np.arange(3.0), (torch.ones(1),)]}}
    out = reshard(tree, "cpu")
    leaves = [out["params"]["w"], out["params"]["b"],
              out["opt_state"]["step"], out["opt_state"]["mu"][0],
              out["opt_state"]["mu"][1][0]]
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in leaves)
    assert isinstance(out["opt_state"]["mu"], list)
    assert isinstance(out["opt_state"]["mu"][1], tuple)
    np.testing.assert_array_equal(out["params"]["w"].numpy(),
                                  tree["params"]["w"])
    assert int(out["opt_state"]["step"]) == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            reshard(tree, "cuda")
