"""repro_torch's SchNet vs repro's, on the CPU.

The same seeded numpy graphs go through both packages, the JAX weights
carried into the port by ``params_from_jax``.  Bars: outputs and losses
within 1e-5 (relative to the largest |output|), gradients within 1e-5 of
each leaf's max |g| (f32 sums in another order: ``index_add_`` against
``segment_sum``), at ``SMOKE`` and at ``FULL`` width (d 64, 300 RBFs,
full_graph_sm's 1,433 input features) on small graphs.  Ids outside the
graph keep JAX's meaning (a sender of -1 wraps, one past the end reads
NaN, a receiver outside [0, N) is dropped), in a molecule batch too.
Also: three train steps give JAX's losses, the params and a checkpoint
cross both ways, ``make_graph`` and ``sample_neighbors`` give JAX's
arrays, and the model runs on ``meta`` (no host sync anywhere).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_latest as j_load_latest
from repro.configs import schnet as j_schnet
from repro.data import synthetic as jsyn
from repro.models.schnet import SchNet as JSchNet
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.checkpoint import Checkpointer, load_latest
from repro_torch.configs import schnet
from repro_torch.data import synthetic as tsyn
from repro_torch.models.schnet import SchNet, params_from_jax, params_to_jax
from repro_torch.train import (
    AdamWConfig, adamw_init, init_state, make_train_step,
)
from repro_torch.train.train_loop import to_device

TOL = 1e-5
N, E = 40, 160  # a small graph
B, NM, EM = 3, 7, 12  # a molecule batch
CONFIGS = {"smoke": (schnet.SMOKE, j_schnet.SMOKE),
           "full": (dataclasses.replace(schnet.FULL, d_in=1433),
                    dataclasses.replace(j_schnet.FULL, d_in=1433))}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models(which: str):
    tcfg, jcfg = CONFIGS[which]
    jm = JSchNet(jcfg)
    params = jax.jit(jm.init)(jax.random.key(3))
    port = SchNet(tcfg, device="cpu")
    port.load_state_dict(params_from_jax(_np(params)), strict=True)
    return jm, params, port


def _graph(d_in: int, seed: int = 0) -> dict:
    g = tsyn.make_graph(N, E, d_in, seed=seed)
    rng = np.random.default_rng(seed + 1)
    g["targets"] = rng.normal(size=N).astype(np.float32)
    g["node_mask"] = (rng.random(N) < 0.6).astype(np.float32)
    return g


def _molecules(d_in: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "node_feat": rng.normal(size=(B, NM, d_in)).astype(np.float32),
        "senders": rng.integers(0, NM, size=(B, EM)).astype(np.int32),
        "receivers": rng.integers(0, NM, size=(B, EM)).astype(np.int32),
        "distances": rng.uniform(0.5, 10.0, size=(B, EM)).astype(np.float32),
        "energy": rng.normal(size=B).astype(np.float32),
    }


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = max(float(np.abs(want[ok]).max(initial=0.0)), 1e-30)
    err = float(np.abs(got[ok] - want[ok]).max(initial=0.0))
    assert err <= tol * scale, (err, scale)


def _jforward(jm, params, g):
    return jax.jit(jm.forward)(params, jnp.asarray(g["node_feat"]),
                               jnp.asarray(g["senders"]),
                               jnp.asarray(g["receivers"]),
                               jnp.asarray(g["distances"]))


def _tforward(port, g):
    t = to_device(g, "cpu")
    with torch.no_grad():
        return port(t["node_feat"], t["senders"], t["receivers"],
                    t["distances"]).numpy()


def _grads_close(port, loss_name, jm, params, batch):
    jloss = getattr(jm, loss_name)
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    named = dict(port.named_parameters())
    loss, aux = getattr(port, loss_name)(to_device(batch, "cpu"))
    grads = torch.autograd.grad(loss, list(named.values()))
    loss = float(loss.detach())
    _close(np.float32(loss), np.asarray(jl))
    np.testing.assert_equal(float(aux["mse"]), loss)  # NaN equals NaN
    want = params_from_jax(_np(jg))
    assert set(want) == set(named)
    for k, g in zip(named, grads):
        _close(g.numpy(), want[k].numpy())


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_forward_losses_and_grads_match_jax(which):
    jm, params, port = _models(which)
    d_in = CONFIGS[which][0].d_in
    g = _graph(d_in)
    _close(_tforward(port, g), _jforward(jm, params, g))
    _grads_close(port, "loss_fn", jm, params, g)
    _grads_close(port, "batched_energy_loss", jm, params, _molecules(d_in))
    # without a node mask every node counts
    del g["node_mask"]
    _grads_close(port, "loss_fn", jm, params, g)


def test_softplus_is_jax_above_twenty():
    from repro.models.schnet import shifted_softplus as jssp
    from repro_torch.models.schnet import shifted_softplus as tssp
    x = np.array([-40.0, -3.0, 0.0, 1e-3, 19.0, 20.0, 20.5, 30.0, 90.0],
                 dtype=np.float32)
    np.testing.assert_allclose(tssp(torch.from_numpy(x)).numpy(),
                               np.asarray(jssp(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


# Each case puts one id outside [0, N) on a few edges.
OUT_OF_RANGE = {
    "sender_minus_one": ("senders", -1),  # jnp.take wraps to N - 1
    "sender_past_end": ("senders", None),  # >= N: jnp.take fills NaN
    "receiver_past_end": ("receivers", None),  # segment_sum drops it
    "receiver_minus_one": ("receivers", -1),  # dropped too
}


def _poke(arr: np.ndarray, n: int, value, edges) -> np.ndarray:
    arr = arr.copy()
    arr[..., edges] = n + 3 if value is None else value
    return arr


@pytest.mark.parametrize("case", sorted(OUT_OF_RANGE))
def test_out_of_range_ids_match_jax(case):
    field, value = OUT_OF_RANGE[case]
    jm, params, port = _models("smoke")
    g = _graph(16, seed=4)
    g[field] = _poke(g[field], N, value, [3, 50, 151])
    got, want = _tforward(port, g), np.asarray(_jforward(jm, params, g))
    # a NaN sender reaches its receiver's output; the others stay finite
    assert np.isnan(want).any() == (case == "sender_past_end")
    _close(got, want)
    _grads_close(port, "loss_fn", jm, params, g)
    # per molecule: an id outside [0, n) never lands in a neighbour
    m = _molecules(16, seed=5)
    m[field] = _poke(m[field], NM, value, [0, 7])
    _grads_close(port, "batched_energy_loss", jm, params, m)


def test_padded_edges_change_nothing():
    """The cells' padding (sender 0, receiver N) drops the edges."""
    _, _, port = _models("smoke")
    g = _graph(16, seed=6)
    pad = {k: v.copy() for k, v in g.items()}
    pad["senders"] = np.concatenate([g["senders"], np.zeros(9, np.int32)])
    pad["receivers"] = np.concatenate([g["receivers"],
                                       np.full(9, N, np.int32)])
    pad["distances"] = np.concatenate([g["distances"],
                                       np.ones(9, np.float32)])
    np.testing.assert_array_equal(_tforward(port, pad), _tforward(port, g))


STEP_ADAMW = dict(lr=2e-3, warmup_steps=2, total_steps=20)


def test_three_train_steps_match_jax():
    jm, params, port = _models("smoke")
    g = _graph(16, seed=7)
    jstep = jax.jit(jloop.make_train_step(
        jm.loss_fn, jopt.AdamWConfig(**STEP_ADAMW)))
    jstate = jloop.init_state(params, jopt.AdamWConfig()).as_dict()
    adamw = AdamWConfig(**STEP_ADAMW)
    fresh = SchNet(schnet.SMOKE, device="cpu")
    fresh.load_state_dict(port.state_dict())
    step = make_train_step(fresh.loss_fn, adamw)
    state = init_state(dict(fresh.named_parameters()), adamw).as_dict()
    jb = {k: jnp.asarray(v) for k, v in g.items()}
    for _ in range(3):
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, g)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=TOL)


def test_params_to_jax_inverts_params_from_jax():
    _, params, port = _models("full")
    want = _np(params)
    got = params_to_jax(params_from_jax(want))
    (wl, wt), (gl, gt) = (jax.tree_util.tree_flatten_with_path(t)
                          for t in (want, got))
    assert wt == gt
    for (wp, a), (gp, b) in zip(wl, gl):
        assert wp == gp and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got["interactions"]["filter_w1"].shape == (3, 300, 64)
    back = params_to_jax(dict(port.named_parameters()))
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_crosses_to_jax_and_back(tmp_path):
    """A SchNet train state opens in ``repro.checkpoint.load_latest``
    (interactions restacked, leaf for leaf) and back in the port."""
    jm, params, port = _models("smoke")
    state = init_state(dict(port.named_parameters()), AdamWConfig()).as_dict()
    state = {"params": {k: v.detach().clone()
                        for k, v in state["params"].items()},
             "opt_state": adamw_init(state["params"])}
    state["opt_state"]["step"].add_(5)
    for t in state["opt_state"]["nu"].values():
        t.uniform_(generator=torch.Generator().manual_seed(t.numel()))
    Checkpointer(str(tmp_path), async_write=False).save(5, state)
    template = jloop.init_state(params, jopt.AdamWConfig()).as_dict()
    got, step = j_load_latest(str(tmp_path), template)
    assert step == 5 and int(got["opt_state"]["step"]) == 5
    for tree, want in ((got["params"], state["params"]),
                       (got["opt_state"]["nu"], state["opt_state"]["nu"])):
        want = params_to_jax(want)
        for (wp, a), (gp, b) in zip(
                jax.tree_util.tree_flatten_with_path(want)[0],
                jax.tree_util.tree_flatten_with_path(tree)[0]):
            assert wp == gp
            np.testing.assert_array_equal(a, np.asarray(b))
    back, step = load_latest(str(tmp_path), state)
    assert step == 5
    for k, v in state["opt_state"]["nu"].items():
        assert torch.equal(back["opt_state"]["nu"][k], v), k


def test_graph_data_is_jax():
    for spatial in (True, False):
        want = jsyn.make_graph(300, 1000, 9, seed=11, spatial=spatial)
        got = tsyn.make_graph(300, 1000, 9, seed=11, spatial=spatial)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    # a CSR with empty rows (self-loop fill) and a repeated seed
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 6, size=500)
    deg[::7] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, 500, size=indptr[-1]).astype(np.int32)
    seeds = np.array([3, 14, 14, 0, 499, 7], dtype=np.int64)
    want = jsyn.sample_neighbors(indptr, indices, seeds, [4, 3],
                                 np.random.default_rng(9))
    got = tsyn.sample_neighbors(indptr, indices, seeds, [4, 3],
                                np.random.default_rng(9))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_runs_on_meta_without_a_host_sync():
    """Every op of both losses and their backward runs on ``meta``, where
    any read of a value raises."""
    cfg = dataclasses.replace(schnet.FULL, d_in=602)
    model = SchNet(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    n, e = 1000, 5000
    meta = functools.partial(torch.empty, device="meta")
    batch = {"node_feat": meta((n, 602)),
             "senders": meta(e, dtype=torch.int32),
             "receivers": meta(e, dtype=torch.int32),
             "distances": meta(e), "targets": meta(n), "node_mask": meta(n)}
    loss, _ = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert loss.is_meta and all(g.is_meta for g in grads)
    mol = {"node_feat": meta((4, 30, 602)),
           "senders": meta((4, 64), dtype=torch.int32),
           "receivers": meta((4, 64), dtype=torch.int32),
           "distances": meta((4, 64)), "energy": meta(4)}
    loss, _ = model.batched_energy_loss(mol)
    assert loss.is_meta and loss.shape == ()


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        SchNet(schnet.SMOKE)
