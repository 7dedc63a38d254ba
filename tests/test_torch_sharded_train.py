"""Training under the sharding policy (repro_torch) against JAX's
``make_train_step`` under the same policy, on the CPU.

- The reference is JAX on four forced host devices in a background
  subprocess: ``jit`` of ``make_train_step(loss_fn, AdamWConfig(), mb)``
  on parameters, optimizer state and batches placed by
  ``repro.sharding.policies``' specs, under ``with_axes`` (and its
  ``_accumulate_grads`` for step 1's gradients; two processes, half the
  cases each).  Both start from the same seeded weights as a JAX params
  pytree of numpy arrays and JAX's ``adamw_init``.  The port runs as gloo
  worlds of 2 and 4 processes, each rank starting from its shards of that
  whole JAX state (``state_from_jax`` then ``policies.shard_state``) and
  its share of the batch (``policies.shard_batch``, JAX's microbatch
  order), stepping ``make_sharded_train_step`` with the model's
  ``train_plan``.
- Cases at SMOKE in f32: ``qwen3-4b`` at (2, 1), (1, 2) with and without
  ``seq_parallel``, (2, 2) with two microbatches and ``seq_parallel``;
  ``smollm-135m`` at (1, 2) (split heads); ``olmoe-1b-7b`` under EP and
  under TP at (1, 2) and (2, 2) (at (2, 2) the dispatch groups span the
  data ranks; TP with ``seq_parallel``); xDeepFM and AutoInt with their
  tables' rows x 4 at (1, 2) and (2, 2) (row-sharded for training);
  SchNet's full graph (edges split) and molecule batches (graphs split)
  at (1, 4) and (2, 2).
- Bars: each rank's loss and ``grad_norm`` of 3 steps within 1e-5
  relative of JAX's; its step-1 gradient blocks within 1e-5 of each
  leaf's max |g|; after step 3 every leaf, both moments and the step
  bit for bit equal on the ranks that hold the same block; the whole
  state gathered back (``policies.gather_state``) cuts to each rank's
  own bits.
- Each autograd collective of ``sharding.ctx`` over gloo ranks: the
  gradient of a function through it against the unsharded function's;
  the sharded global norm counts a block split over data and model and a
  replicated leaf once each.
- At world size 1 (a gloo group of one, mesh (1, 1)) the sharded step is
  ``make_train_step`` bit for bit, for an LM, SchNet and xDeepFM; without
  a process group, with one of another size than the mesh's, or over an
  ``AbstractMesh`` off ``meta``, the sharded step raises.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_recsys_batch
from repro_torch.configs import get_arch
from repro_torch.models import recsys, schnet, transformer
from repro_torch.sharding import policies as pol

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL = 1e-5
STEPS = 3
B, S = 4, 16  # an LM batch
RECSYS_B = 16
GRAPH = (30, 96)  # a full graph's nodes and edges (the edges divide 4)
MOLECULES = (8, 6, 12)  # molecules, nodes and edges a molecule

# name -> (family, arch, mesh, seq_parallel, microbatches, expert_parallel)
CASES = {
    "qwen3-fsdp": ("lm", "qwen3-4b", (2, 1), False, 1, None),
    "qwen3-tp": ("lm", "qwen3-4b", (1, 2), False, 1, None),
    "qwen3-tp-sp": ("lm", "qwen3-4b", (1, 2), True, 1, None),
    "qwen3-2x2-mb2-sp": ("lm", "qwen3-4b", (2, 2), True, 2, None),
    "smollm-tp": ("lm", "smollm-135m", (1, 2), False, 1, None),
    "olmoe-ep": ("lm", "olmoe-1b-7b", (1, 2), False, 1, True),
    "olmoe-tp": ("lm", "olmoe-1b-7b", (1, 2), False, 1, False),
    "olmoe-2x2-ep": ("lm", "olmoe-1b-7b", (2, 2), False, 1, True),
    "olmoe-2x2-tp-sp": ("lm", "olmoe-1b-7b", (2, 2), True, 1, False),
    "xdeepfm": ("recsys", "xdeepfm", (1, 2), False, 1, None),
    "xdeepfm-2x2": ("recsys", "xdeepfm", (2, 2), False, 1, None),
    "autoint": ("recsys", "autoint", (1, 2), False, 1, None),
    "autoint-2x2": ("recsys", "autoint", (2, 2), False, 1, None),
    "schnet-graph-1x4": ("gnn", "schnet", (1, 4), False, 1, None),
    "schnet-graph-2x2": ("gnn", "schnet", (2, 2), False, 1, None),
    "schnet-molecules-1x4": ("gnn", "schnet", (1, 4), True, 1, None),
    "schnet-molecules-2x2": ("gnn", "schnet", (2, 2), True, 1, None),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(arch: str, sp: bool):
    """The port's config of a case (JAX's subprocess makes the same):
    SMOKE, the recsys tables' rows x 4 (so they divide the model axis),
    SchNet's ``d_in`` set."""
    t = get_arch(arch).smoke_config
    if get_arch(arch).family == "lm":
        return dataclasses.replace(t, seq_parallel=sp)
    if arch == "schnet":
        return dataclasses.replace(t, d_in=5 if sp else 7)
    return dataclasses.replace(t, vocab_sizes=tuple(
        4 * v for v in t.vocab_sizes))


def _batch(family: str, arch: str, cfg, molecules: bool, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    if family == "lm":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                    np.int32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                    np.int32),
                "loss_mask": (rng.random((B, S)) < 0.7).astype(np.float32)}
    if family == "recsys":
        return make_recsys_batch(RECSYS_B, cfg.n_sparse, cfg.vocab_sizes,
                                 multi_hot=3 if arch == "xdeepfm" else 1,
                                 seed=seed)
    if molecules:
        b, n, e = MOLECULES
        return {"node_feat": rng.standard_normal((b, n, cfg.d_in)).astype(
                    np.float32),
                "senders": rng.integers(-n, n, (b, e)).astype(np.int32),
                "receivers": rng.integers(0, n + 1, (b, e)).astype(np.int32),
                "distances": rng.uniform(0.5, 5.0, (b, e)).astype(np.float32),
                "energy": rng.standard_normal(b).astype(np.float32)}
    n, e = GRAPH
    return {"node_feat": rng.standard_normal((n, cfg.d_in)).astype(
                np.float32),
            "senders": rng.integers(-n, n, e).astype(np.int32),
            "receivers": rng.integers(0, n + 1, e).astype(np.int32),
            "distances": rng.uniform(0.5, 5.0, e).astype(np.float32),
            "targets": rng.standard_normal(n).astype(np.float32),
            "node_mask": (rng.random(n) < 0.5).astype(np.float32)}


FROM_JAX = {"lm": transformer.params_from_jax,
            "recsys": recsys.params_from_jax,
            "gnn": schnet.params_from_jax}


def _init(family: str, tcfg, seed: int) -> dict:
    """Seeded weights (the port's init laws) as a JAX params pytree of
    numpy arrays: both packages start from these numbers."""
    gen = torch.Generator().manual_seed(seed)
    if family == "lm":
        model = transformer.TransformerLM(tcfg, device="cpu", generator=gen)
        to_jax = transformer.params_to_jax
    elif family == "recsys":
        model = recsys.build_model(tcfg, device="cpu", seed=seed)
        to_jax = recsys.params_to_jax
    else:
        model = schnet.SchNet(tcfg, device="cpu", generator=gen)
        to_jax = schnet.params_to_jax
    params = to_jax(model.state_dict())
    # SchNet's and the LM's biases and norms init to constants: draw them
    return jax.tree_util.tree_map(
        lambda x: x + np.float32(0.01) * np.random.default_rng(
            seed).standard_normal(x.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every case's JAX init and whole batch, as numpy, saved for the
    subprocesses."""
    out = {}
    for seed, (name, (family, arch, _, sp, _, _)) in enumerate(
            CASES.items()):
        tcfg = _config(arch, sp)
        out[name] = {"params": _init(family, tcfg, seed),
                     "batch": _batch(family, arch, tcfg, sp, seed + 100)}
    path = tmp_path_factory.mktemp("sharded_train") / "inputs.pkl"
    path.write_bytes(pickle.dumps(out))
    return out, path


JAX_RUN = r"""
import dataclasses, pickle, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.models.recsys import build_model
from repro.models.schnet import SchNet
from repro.models.transformer import TransformerLM
from repro.sharding import ctx, policies as pol
from repro.train.optimizer import AdamWConfig, adamw_init
from repro.train.train_loop import _accumulate_grads, make_train_step

CASES = {k: v for k, v in %(CASES)r.items() if k in sys.argv[3:]}
inputs = pickle.loads(open(sys.argv[1], "rb").read())
out = {}
def put(tree, specs, mesh):
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)
for name, (family, arch, shape, sp, mb, ep) in CASES.items():
    inp = inputs[name]
    params, batch = inp["params"], inp["batch"]
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(
        shape), ("data", "model"))
    cfg = get_arch(arch).smoke_config
    if family == "lm":
        cfg = dataclasses.replace(cfg, seq_parallel=sp)
        if ep is None:
            ep = pol.default_expert_parallel(cfg, shape[1])
    policy = pol.make_policy(mesh, expert_parallel=bool(ep))
    flat = policy.dp + (policy.tp,)
    batch_axes = None
    if family == "lm":
        model = TransformerLM(cfg)
        loss_fn = model.loss_fn
        pspecs = pol.lm_param_specs(cfg, policy, params)
        bspecs = pol.lm_batch_specs(policy)
    elif family == "recsys":
        cfg = dataclasses.replace(cfg, vocab_sizes=tuple(
            4 * v for v in cfg.vocab_sizes))
        model = build_model(cfg)
        loss_fn = model.loss_fn
        pspecs = pol.recsys_param_specs(policy, params, serving=False)
        bspecs = pol.recsys_batch_specs(
            policy, {k: v.ndim for k, v in batch.items()})
        batch_axes = flat
    else:
        cfg = dataclasses.replace(cfg, d_in=5 if sp else 7)
        model = SchNet(cfg)
        loss_fn = model.batched_energy_loss if sp else model.loss_fn
        pspecs = pol.gnn_param_specs(params)
        bspecs = pol.gnn_batch_specs(policy, batched=sp)
        batch_axes = flat if sp else None
    state = {"params": params, "opt_state": adamw_init(params)}
    sspecs = {"params": pspecs,
              "opt_state": {"step": P(), "mu": pspecs, "nu": pspecs}}
    state = put(state, sspecs, mesh)
    placed = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
              for k, v in batch.items()}
    train_step = make_train_step(loss_fn, AdamWConfig(), mb)

    def step_and_grads(state, batch):  # one compile: the step, its grads
        grads = _accumulate_grads(loss_fn, state["params"], batch, mb)[2]
        return (*train_step(state, batch), grads)

    step = jax.jit(ctx.with_axes(policy, step_and_grads, batch_axes))
    losses, norms = [], []
    for i in range(%(STEPS)r):
        state, m, grads = step(state, placed)
        if i == 0:
            first = jax.tree_util.tree_map(np.asarray, grads)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[name] = {"grads": first, "loss": losses, "grad_norm": norms}
open(sys.argv[2], "wb").write(pickle.dumps(out))
"""

GLOO_RANK = r"""
import dataclasses, pickle, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import recsys, schnet, transformer
from repro_torch.sharding import ctx, policies as pol
from repro_torch.train import AdamWConfig, adamw_init
from repro_torch.train.train_loop import (
    copy_state, make_sharded_train_step, sharded_grads, state_from_jax)

CASES = %(CASES)r
inputs = pickle.loads(open(sys.argv[1], "rb").read())
port, rank, world = sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        rank=rank, world_size=world)
out = {}
try:
    # the collectives, each against the unsharded function (a 4-rank world)
    if world == 4:
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        d, m = mesh.get_coordinate()
        g = torch.Generator().manual_seed(0)
        w = torch.randn(6, 4, generator=g)  # whole, the same on every rank
        x = torch.randn(2, 6, generator=g)
        a = torch.randn(4, 2, generator=g)
        res = {}
        c = torch.arange(1.0, 5.0)[:, None]  # a weight a row of a
        with ctx.axes(mesh, ("data",), "model"):
            def run(name, fn, *leaves):
                leaves = [t.clone().requires_grad_(True) for t in leaves]
                y = fn(*leaves)
                grads = torch.autograd.grad(y, leaves)
                res[name] = (float(y), [t.numpy() for t in grads])
            # each is sum((x @ w)^2) of the whole x, w (the last one the
            # weighted squared deviation of a's rows from their mean),
            # computed in parts on the model axis's ranks
            cols = slice(2 * m, 2 * m + 2)  # rank m's output columns
            ks = slice(3 * m, 3 * m + 3)  # rank m's inner dims
            # the ranks' partial sums all-reduced (backward: identity)
            run("all_reduce_sum", lambda x, w: ctx.all_reduce_sum(
                torch.sum((x @ w[:, cols]) ** 2)), x, w)
            # x, replicated, entering the ranks' columns
            run("enter_split", lambda x, w: ctx.all_reduce_sum(torch.sum(
                (ctx.enter_split(x) @ w[:, cols]) ** 2)), x, w)
            # x's inner blocks gathered, each rank using its own row
            run("gather", lambda x, w: ctx.all_reduce_sum(torch.sum(
                (ctx.gather(x[:, ks], 1) @ w)[m] ** 2)), x, w)
            # the output's column blocks gathered, used replicated
            run("gather_out", lambda x, w: torch.sum(ctx.gather_out(
                x @ w[:, cols], 1) ** 2), x, w)
            # partial products over the inner dims, each rank keeping its
            # block of the output's columns
            run("reduce_scatter", lambda x, w: ctx.all_reduce_sum(torch.sum(
                ctx.reduce_scatter(x[:, ks] @ w[ks], 1) ** 2)), x, w)
            # a mean over the rows split on the model axis, used on each
            # rank's own rows
            rows = slice(2 * m, 2 * m + 2)
            run("all_reduce_stat", lambda a: ctx.all_reduce_sum(torch.sum(
                c[rows] * (a[rows] - ctx.all_reduce_stat(torch.sum(
                    a[rows], 0), "model") / 4) ** 2)), a)
            # the sharded global norm: a [4, 6] leaf split over data and
            # model, a [3] leaf replicated
            big = torch.arange(24.0).reshape(4, 6)
            rep = torch.tensor([1.0, -2.0, 3.0])
            specs = {"big": pol.to_placements(("data", "model"), mesh),
                     "rep": pol.to_placements((None,), mesh)}
            from repro_torch.train.optimizer import sharded_global_norm
            res["norm"] = float(sharded_global_norm(
                {"big": big[2 * d:2 * d + 2, 3 * m:3 * m + 3], "rep": rep},
                specs, mesh))
        out["collectives"] = res
    for name, (family, arch, shape, sp, mb, ep) in CASES.items():
        if shape[0] * shape[1] != world:
            continue
        inp = inputs[name]
        mesh = make_debug_mesh(*shape, device_type="cpu")
        coords = mesh.get_coordinate()
        cfg = get_arch(arch).smoke_config
        if family == "lm":
            cfg = dataclasses.replace(cfg, seq_parallel=sp)
            if ep is None:
                ep = pol.default_expert_parallel(cfg, shape[1])
        policy = pol.make_policy(mesh, expert_parallel=bool(ep))
        if family == "lm":
            model = transformer.TransformerLM(cfg, device="cpu",
                                              policy=policy)
            loss_fn, plan = model.loss_fn, model.train_plan()
            dims = pol.lm_batch_dims(policy)
            from_jax = transformer.params_from_jax
        elif family == "recsys":
            cfg = dataclasses.replace(cfg, vocab_sizes=tuple(
                4 * v for v in cfg.vocab_sizes))
            model = recsys.build_model(cfg, device="cpu", policy=policy,
                                       serving=False)
            loss_fn, plan = model.loss_fn, model.train_plan()
            dims = pol.recsys_batch_dims(
                policy, {k: v.ndim for k, v in inp["batch"].items()})
            from_jax = recsys.params_from_jax
        else:
            cfg = dataclasses.replace(cfg, d_in=5 if sp else 7)
            model = schnet.SchNet(cfg, device="cpu", policy=policy)
            loss_fn = model.batched_energy_loss if sp else model.loss_fn
            plan = model.train_plan(batched=sp)
            dims = pol.gnn_batch_dims(policy, batched=sp)
            from_jax = schnet.params_from_jax
        # this rank's shards of JAX's whole init state (adamw_init's zeros)
        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [zeros(v) for v in tree]
            return np.zeros_like(tree)
        whole = state_from_jax({"params": inp["params"], "opt_state": {
            "step": np.int32(0), "mu": zeros(inp["params"]),
            "nu": zeros(inp["params"])}}, from_jax)
        params = dict(model.named_parameters())
        state = {"params": params, "opt_state": adamw_init(params)}
        copy_state(state, pol.shard_state(whole, plan.specs, mesh, coords))
        batch = pol.shard_batch(inp["batch"], dims, mesh, coords, mb)
        _, grads = sharded_grads(loss_fn, plan, params, batch, mb)
        step = make_sharded_train_step(loss_fn, AdamWConfig(), plan, mb)
        losses, norms = [], []
        for _ in range(%(STEPS)r):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        o = state["opt_state"]
        local = {"params": {k: v.detach().numpy().copy()
                            for k, v in params.items()},
                 "mu": {k: v.numpy().copy() for k, v in o["mu"].items()},
                 "nu": {k: v.numpy().copy() for k, v in o["nu"].items()}}
        gathered = pol.gather_state(
            {"params": {k: v.detach() for k, v in params.items()},
             "opt_state": o}, plan.specs, policy)
        again = pol.shard_state(gathered, plan.specs, mesh, coords)
        round_trip = all(
            torch.equal(again["params"][k], params[k].detach())
            and torch.equal(again["opt_state"]["mu"][k], o["mu"][k])
            and torch.equal(again["opt_state"]["nu"][k], o["nu"][k])
            for k in params)
        out[name] = {
            "loss": losses, "grad_norm": norms, "coords": list(coords),
            "grads": {k: v.numpy().copy() for k, v in grads.items()},
            "final": local, "step": int(o["step"]),
            "blocks": {k: [list(mesh.mesh_dim_names).index(a)
                           for a in pol.sharded_axes(pl, mesh)]
                       for k, pl in plan.specs.items()},
            "specs": plan.specs, "round_trip": round_trip}
finally:
    dist.destroy_process_group()
open(sys.argv[2], "wb").write(pickle.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """JAX on four forced host devices and the port's gloo worlds of 2
    and 4 ranks, all started in the background -> a function that waits
    for them once."""
    _, path = inputs
    tmp = tmp_path_factory.mktemp("sharded_train_runs")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    args = {"CASES": CASES, "STEPS": STEPS}
    outs, procs = {}, {}
    names = list(CASES)
    for j in range(2):  # two JAX processes, half the cases each
        outs[("jax", j)] = tmp / f"jax{j}.pkl"
        procs[("jax", j)] = subprocess.Popen(
            [sys.executable, "-c", JAX_RUN % args, str(path),
             str(outs[("jax", j)]), *names[j::2]],
            env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for world in (2, 4):
        port = str(_free_port())
        for r in range(world):
            key = (world, r)
            outs[key] = tmp / f"w{world}r{r}.pkl"
            procs[key] = subprocess.Popen(
                [sys.executable, "-c", GLOO_RANK % args, str(path),
                 str(outs[key]), port, str(r), str(world)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    cache = {}

    def result():
        if not cache:
            for name, p in procs.items():
                log, _ = p.communicate(timeout=600)
                assert p.returncode == 0, (name, log)
            cache.update({k: pickle.loads(o.read_bytes())
                          for k, o in outs.items() if k[0] != "jax"})
            cache["jax"] = {}
            for j in range(2):
                cache["jax"].update(pickle.loads(
                    outs[("jax", j)].read_bytes()))
        return cache

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_training_matches_jax(case, inputs, runs):
    family, arch, shape, *_ = CASES[case]
    got = runs()
    want = got["jax"][case]
    world = shape[0] * shape[1]
    ranks = [got[(world, r)][case] for r in range(world)]
    mesh = pol.AbstractMesh(shape)
    whole_grads = FROM_JAX[family](want["grads"])
    for r, res in enumerate(ranks):
        for i in range(STEPS):
            for k in ("loss", "grad_norm"):
                assert _rel(res[k][i], want[k][i]) <= RTOL, (
                    case, r, k, i, res[k][i], want[k][i])
        assert set(res["grads"]) == set(whole_grads)
        for name, g in whole_grads.items():
            block = pol.shard_leaf(g.numpy(), res["specs"][name], mesh,
                                   res["coords"])
            scale = float(np.max(np.abs(g.numpy())))
            np.testing.assert_allclose(
                res["grads"][name], block, rtol=0, atol=RTOL * scale,
                err_msg=f"{case} rank {r} step-1 gradient of {name}")
        assert res["step"] == STEPS and res["round_trip"], (case, r)
    # the ranks that hold the same block of a leaf hold the same bits
    for name, dims in ranks[0]["blocks"].items():
        held = {}
        for res in ranks:
            held.setdefault(tuple(res["coords"][i] for i in dims),
                            []).append(res)
        for same in held.values():
            for part in ("params", "mu", "nu"):
                for res in same[1:]:
                    np.testing.assert_array_equal(
                        res["final"][part][name],
                        same[0]["final"][part][name],
                        err_msg=f"{case}: {part} {name} differs between "
                                f"ranks holding one block")


def test_sharded_lm_cases_cover_the_layouts():
    """The LM cases reach FSDP alone, TP alone and both, sequence
    parallelism with and without data, split heads, MoE under EP and TP,
    and dispatch groups that span the data ranks."""
    from repro_torch.models.layers import moe_group_tokens

    cfg = get_arch("smollm-135m").smoke_config
    assert cfg.n_kv_heads % 2  # split heads at model 2
    moe = get_arch("olmoe-1b-7b").smoke_config.moe
    rows = B // 2 * S  # a data rank's tokens at (2, 2)
    assert rows % moe_group_tokens(rows * 2, moe)  # the groups span them
    seen = {(CASES[c][2], CASES[c][3], CASES[c][5]) for c in CASES
            if CASES[c][0] == "lm"}
    assert {((2, 1), False, None), ((1, 2), True, None),
            ((2, 2), True, None), ((1, 2), False, True),
            ((2, 2), True, False)} <= seen


@pytest.mark.parametrize("name", ["all_reduce_sum", "enter_split",
                                  "gather", "gather_out", "reduce_scatter",
                                  "all_reduce_stat"])
def test_autograd_collective_gives_the_unsharded_gradient(name, runs):
    """Over a (2, 2) gloo mesh, each collective on the model axis inside a
    function the model ranks compute in parts: every rank's value is the
    whole function's, and the ranks' gradients summed over the model axis
    are the whole function's (a backward that summed where it should not,
    or did not where it should, gives a multiple or a part); a replicated
    input entering a split computation gets the whole gradient on each
    rank."""
    got = runs()
    g = torch.Generator().manual_seed(0)
    w = torch.randn(6, 4, generator=g)
    x = torch.randn(2, 6, generator=g)
    a = torch.randn(4, 2, generator=g)
    c = torch.arange(1.0, 5.0)[:, None]
    if name == "all_reduce_stat":
        leaves = [a.clone().requires_grad_(True)]
        want_y = torch.sum(c * (leaves[0] - leaves[0].mean(0)) ** 2)
    else:
        leaves = [x.clone().requires_grad_(True),
                  w.clone().requires_grad_(True)]
        want_y = torch.sum((leaves[0] @ leaves[1]) ** 2)
    want = [t.numpy() for t in torch.autograd.grad(want_y, leaves)]
    ranks = [got[(4, r)]["collectives"][name] for r in range(4)]
    for d in range(2):  # ranks 2 d and 2 d + 1: (d, 0) and (d, 1)
        pair = ranks[2 * d:2 * d + 2]
        for y, _ in pair:
            assert abs(y - want_y.item()) <= RTOL * abs(want_y.item())
        for i, wi in enumerate(want):
            if name == "enter_split" and i == 0:
                for _, grads in pair:  # the whole gradient on each rank
                    np.testing.assert_allclose(grads[i], wi, rtol=1e-5,
                                               atol=1e-6)
                continue
            np.testing.assert_allclose(pair[0][1][i] + pair[1][1][i], wi,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}, leaf {i}")


def test_sharded_global_norm_counts_each_block_once(runs):
    """A leaf split over data and model and a replicated leaf each count
    once: the norm of the whole tree on every rank."""
    got = runs()
    want = float(np.sqrt(np.sum(np.arange(24.0) ** 2) + 1 + 4 + 9))
    for r in range(4):
        assert abs(got[(4, r)]["collectives"]["norm"] - want) <= 1e-6 * want


def test_shard_batch_keeps_jaxs_microbatch_order():
    """A rank's rows are its block of each contiguous microbatch, as JAX's
    reshape [mb, B / mb, ...] sharded on dim 1 gives them; a dim the ranks
    do not divide (an edge count) raises."""
    x = np.arange(16 * 3).reshape(16, 3)
    mesh = pol.AbstractMesh((2, 2))
    for mb in (1, 2, 4):
        micro = x.reshape(mb, 16 // mb, 3)
        for d in range(2):
            want = micro[:, d * (8 // mb):(d + 1) * (8 // mb)].reshape(-1, 3)
            got = pol.shard_batch({"t": x}, {"t": (("data",), None)}, mesh,
                                  (d, 1), mb)["t"]
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="split"):  # edges not dividing
        pol.shard_batch({"senders": np.arange(10)},
                        {"senders": (("data", "model"),)}, mesh, (0, 0))
    with pytest.raises(ValueError, match="microbatches"):
        pol.shard_batch({"t": x[:6]}, {"t": (("data",), None)}, mesh,
                        (0, 0), 4)


def _one_rank_runs():
    """(name, a model under a policy or None, loss name, batch, plan
    kwargs) of the world-size-1 cases."""
    lm = get_arch("qwen3-4b").smoke_config
    x_cfg = get_arch("xdeepfm").smoke_config
    g_cfg = dataclasses.replace(get_arch("schnet").smoke_config, d_in=7)
    return [
        ("qwen3-4b", lambda policy: transformer.TransformerLM(
            lm, device="cpu", generator=torch.Generator().manual_seed(0),
            policy=policy), "loss_fn", _batch("lm", "qwen3-4b", lm, False, 1),
         {}),
        ("xdeepfm", lambda policy: recsys.build_model(
            x_cfg, device="cpu", seed=0, policy=policy, serving=False),
         "loss_fn", _batch("recsys", "xdeepfm", x_cfg, False, 2), {}),
        ("schnet", lambda policy: schnet.SchNet(
            g_cfg, device="cpu", generator=torch.Generator().manual_seed(0),
            policy=policy), "loss_fn",
         _batch("gnn", "schnet", g_cfg, False, 3),
         {"batched": False}),
    ]


@pytest.mark.parametrize("case", ["qwen3-4b", "xdeepfm", "schnet"])
def test_world_size_one_is_make_train_step_bit_for_bit(case, tmp_path):
    """Under a gloo group of one (mesh (1, 1)) the sharded step is the
    unsharded ``make_train_step``, bit for bit, over 3 steps; with the
    group gone it raises."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import (
        make_sharded_train_step, make_train_step,
    )

    name, make, loss, batch, kw = next(c for c in _one_rank_runs()
                                       if c[0] == case)
    base = make(None)
    state = {"params": dict(base.named_parameters()),
             "opt_state": adamw_init(dict(base.named_parameters()))}
    step = make_train_step(getattr(base, loss), AdamWConfig())
    want = [step(state, batch)[1] for _ in range(STEPS)]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        model = make(pol.make_policy(make_debug_mesh(1, 1, "cpu")))
        params = dict(model.named_parameters())
        sstate = {"params": params, "opt_state": adamw_init(params)}
        sstep = make_sharded_train_step(getattr(model, loss), AdamWConfig(),
                                        model.train_plan(**kw))
        for i in range(STEPS):
            sstate, m = sstep(sstate, batch)
            for k in ("loss", "grad_norm", "lr"):
                assert torch.equal(m[k], want[i][k]), (case, i, k)
        for k, p in base.named_parameters():
            assert torch.equal(p, params[k]), (case, k)
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="process group"):
        sstep(sstate, batch)


def test_sharded_step_refuses_an_abstract_mesh_off_meta():
    """A plan over an ``AbstractMesh`` steps ``meta`` tensors alone: on
    the CPU the step raises (no fallback to an unsharded step)."""
    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_sharded_train_step

    cfg = get_arch("qwen3-4b").smoke_config
    model = transformer.TransformerLM(cfg, device="cpu")
    params = dict(model.named_parameters())
    plan = pol.TrainPlan(pol.make_policy(pol.AbstractMesh((1, 2))),
                         {k: pol.to_placements((None,) * p.dim(),
                                               pol.AbstractMesh((1, 2)))
                          for k, p in params.items()},
                         {k: () for k in params})
    step = make_sharded_train_step(model.loss_fn, AdamWConfig(), plan)
    with pytest.raises(ValueError, match="meta"):
        step({"params": params, "opt_state": adamw_init(params)},
             _batch("lm", "qwen3-4b", cfg, False, 0))


def test_sharded_step_refuses_a_group_of_another_size(tmp_path):
    """A plan whose mesh holds two ranks, under a gloo group of one: the
    step raises before any collective (no fallback to an unsharded
    step)."""
    import torch.distributed as dist

    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import make_sharded_train_step

    class TwoRanks:  # a mesh's shape and size, with no ranks behind it
        shape = (1, 2)
        mesh_dim_names = ("data", "model")

        def size(self) -> int:
            return 2

    cfg = get_arch("qwen3-4b").smoke_config
    model = transformer.TransformerLM(cfg, device="cpu")
    params = dict(model.named_parameters())
    mesh = TwoRanks()
    plan = pol.TrainPlan(pol.make_policy(mesh), {
        k: pol.to_placements((None,) * p.dim(), mesh)
        for k, p in params.items()}, {k: () for k in params})
    step = make_sharded_train_step(model.loss_fn, AdamWConfig(), plan)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="has 2 ranks"):
            step({"params": params, "opt_state": adamw_init(params)},
                 _batch("lm", "qwen3-4b", cfg, False, 0))
    finally:
        dist.destroy_process_group()
