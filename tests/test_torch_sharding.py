"""repro_torch.sharding against repro.sharding, on the CPU.

- Placements: every registry architecture's parameters, on meshes (1, 1),
  (1, 2), (2, 2) and (1, 4), expert parallelism on and off (recsys:
  serving and training), as the port's sharded models hold them on
  ``meta``: each leaf's placements are ``to_placements`` of JAX's
  ``PartitionSpec`` (its stacked ``L`` dim dropped) and its local shape
  JAX's shard shape (``jax.sharding.AbstractMesh``: the rules read only
  the mesh's shape).  The cache, batch and GNN specs and
  ``default_expert_parallel`` over grids.
- Numerics over gloo: ``smollm-135m`` (3 q / 1 kv heads: split heads, a
  cache split by sequence), ``qwen3-4b`` (heads divide at model 2; at 4
  the cache splits by sequence) and ``olmoe-1b-7b`` (EP by default at
  model 2; TP inside the experts forced) at SMOKE, in f32: a prefill and
  3 decode steps from a seeded cache, the port's ranks at (1, 2), (2, 2)
  and (1, 4) (two gloo worlds, of 2 and 4 processes) against JAX on four
  forced host devices under the same policy (``with_axes``, ``jit`` of
  sharded inputs; a background subprocess) and the port at world size 1,
  within 1e-5 relative; MoE expert ids and drops equal.  xDeepFM and
  AutoInt at SMOKE with their table rows x 4 (divisible by 4) and
  ``REPLICATE_TABLE_BYTES`` lowered in both packages for the run (so the
  serving rule row-shards the tables): each rank's logits within 1e-5 of
  JAX's.
- A sharded entry raises without a process group or with one of another
  size; ``shard_params`` cuts JAX's parameters by the placements.
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
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import get_arch as j_get_arch
from repro.models.recsys import build_model as j_build_recsys
from repro.models.schnet import SchNet as JSchNet
from repro.models.transformer import TransformerLM as JLM
from repro.sharding import policies as jpol
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs import olmoe_1b_7b, qwen3_4b, smollm_135m
from repro_torch.configs import autoint, xdeepfm
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.recsys import build_model
from repro_torch.models.transformer import TransformerLM, shard_params
from repro_torch.sharding import ctx
from repro_torch.sharding import policies as pol

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = [(1, 1), (1, 2), (2, 2), (1, 4)]
NUM_MESHES = [(1, 2), (2, 2), (1, 4)]
RTOL = 1e-5
B, S, CTX, STEPS = 4, 16, 20, 3  # decode at positions 9, 10, 11
FILLED = 9  # cache slots 0..8 hold seeded K/V
TABLE_BYTES = 1024  # REPLICATE_TABLE_BYTES while the recsys cases run


def _jmesh(shape):
    return AbstractMesh(tuple(shape), ("data", "model"))


def _pmesh(shape):
    return pol.AbstractMesh(tuple(shape), ("data", "model"))


def _jflat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(getattr(p, "key", getattr(p, "idx", "")))
                     for p in path)] = leaf
    return out


def _check_leaf(name, got_pl, got_shape, jspec, jshape, jmesh, pmesh,
                drop_first: bool):
    entries = tuple(jspec) + (None,) * (len(jshape) - len(jspec))
    shard = NamedSharding(jmesh, P(*entries)).shard_shape(tuple(jshape))
    if drop_first:
        entries, shard = entries[1:], shard[1:]
    assert tuple(got_pl) == pol.to_placements(entries, pmesh), name
    assert tuple(got_shape) == tuple(shard), name


# ---------------------------------------------------------------------------
# (a) placements


LM_ARCHS = [a for a in list_archs() if get_arch(a).family == "lm"]


@pytest.mark.parametrize("ep", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_placements_are_jax(arch, mesh, ep):
    cfg = get_arch(arch).config
    jcfg = j_get_arch(arch).config
    jmesh, pmesh = _jmesh(mesh), _pmesh(mesh)
    jspecs = _jflat(jpol.lm_param_specs(
        jcfg, jpol.make_policy(jmesh, expert_parallel=ep),
        JLM(jcfg).abstract_params()))
    jshapes = _jflat(JLM(jcfg).abstract_params())
    model = TransformerLM(cfg, device="meta", policy=pol.make_policy(
        pmesh, expert_parallel=ep))
    seen = set()
    for name, p in model.named_parameters():
        parts = name.split(".")
        stacked = parts[0] == "blocks"
        key = ".".join(["blocks"] + parts[2:]) if stacked else name
        _check_leaf(name, model.specs[name], p.shape, jspecs[key],
                    jshapes[key].shape, jmesh, pmesh, stacked)
        seen.add(key)
    assert seen == set(jspecs)


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ["din", "dien", "autoint", "xdeepfm"])
def test_recsys_param_placements_are_jax(arch, mesh, serving):
    cfg = get_arch(arch).config
    jcfg = j_get_arch(arch).config
    jmesh, pmesh = _jmesh(mesh), _pmesh(mesh)
    jshape = jax.eval_shape(lambda: j_build_recsys(jcfg).init(
        jax.random.key(0)))
    jspecs = _jflat(jpol.recsys_param_specs(jpol.make_policy(jmesh), jshape,
                                            serving=serving))
    jshapes = _jflat(jshape)
    policy = pol.make_policy(pmesh)
    if serving:  # the sharded model's own shards
        model = build_model(cfg, device="meta", policy=policy)
        specs = model.specs
        shapes = {n: p.shape for n, p in model.named_parameters()}
    else:
        model = build_model(cfg, device="meta")
        shapes = dict(model.named_parameters())
        specs = pol.recsys_param_specs(policy, shapes, serving=False)
        shapes = {n: pol.local_shape(p.shape, specs[n], pmesh)
                  for n, p in shapes.items()}
    assert set(specs) == set(jspecs)
    for name in specs:
        _check_leaf(name, specs[name], shapes[name], jspecs[name],
                    jshapes[name].shape, jmesh, pmesh, False)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_gnn_and_batch_specs_are_jax(mesh):
    jmesh, pmesh = _jmesh(mesh), _pmesh(mesh)
    jp, pp = jpol.make_policy(jmesh), pol.make_policy(pmesh)
    cfg = j_get_arch("schnet").config
    jshape = jax.eval_shape(lambda: JSchNet(cfg).init(jax.random.key(0)))
    jflat = _jflat(jpol.gnn_param_specs(jshape))
    got = pol.gnn_param_specs(pp, {k: v.shape for k, v in
                                   _jflat(jshape).items()})
    assert got == {k: pol.to_placements(tuple(v) or (None,), pmesh)
                   for k, v in jflat.items()}
    for batched in (False, True):
        want = jpol.gnn_batch_specs(jp, batched)
        got = pol.gnn_batch_specs(pp, batched)
        assert got == {k: pol.to_placements(tuple(v), pmesh)
                       for k, v in want.items()}
    assert pol.lm_batch_specs(pp) == {
        k: pol.to_placements(tuple(v), pmesh)
        for k, v in jpol.lm_batch_specs(jp).items()}
    keys = {"sparse_ids": 3, "label": 1, "hist_ids": 2}
    assert pol.recsys_batch_specs(pp, keys) == {
        k: pol.to_placements(tuple(v), pmesh)
        for k, v in jpol.recsys_batch_specs(jp, keys).items()}


@pytest.mark.parametrize("mesh", MESHES + [(4, 1), (2, 4), (1, 8)],
                         ids=str)
def test_cache_specs_and_expert_parallel_are_jax(mesh):
    jmesh, pmesh = _jmesh(mesh), _pmesh(mesh)
    jp, pp = jpol.make_policy(jmesh), pol.make_policy(pmesh)
    for batch in (1, 2, 3, 4, 8):
        for cache_len in (1, 2, 3, 4, 6, 8, 16, 4096):
            for n_kv in (1, 2, 3, 4, 8, 16):
                want = jpol.lm_cache_specs(jp, batch, cache_len, n_kv)
                got = pol.lm_cache_specs(pp, batch, cache_len, n_kv)
                assert got == {k: pol.to_placements(tuple(v), pmesh)
                               for k, v in want.items()}, (batch, cache_len,
                                                           n_kv)
    tp = mesh[1]
    for arch in list_archs():
        assert pol.default_expert_parallel(get_arch(arch).config, tp) == \
            jpol.default_expert_parallel(j_get_arch(arch).config, tp), arch


def test_to_placements_and_shard_leaf():
    mesh = _pmesh((2, 2))
    assert pol.to_placements((("data", "model"), None), mesh) == (
        pol.Shard(0), pol.Shard(0))
    assert pol.to_placements((None, "data"), mesh) == (pol.Shard(1),
                                                       pol.Replicate())
    with pytest.raises(ValueError):
        pol.to_placements(("model", "model"), mesh)
    x = np.arange(8 * 6).reshape(8, 6)
    pl = pol.to_placements((("data", "model"), None), mesh)
    blocks = [pol.shard_leaf(x, pl, mesh, (d, m))
              for d in range(2) for m in range(2)]
    np.testing.assert_array_equal(np.concatenate(blocks), x)
    pl = pol.to_placements(("model", "data"), mesh)
    t = torch.from_numpy(x)
    got = pol.shard_leaf(t, pl, mesh, (1, 0))
    np.testing.assert_array_equal(got.numpy(), x[:4, 3:])


def test_sharded_entries_raise_without_a_matching_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_debug_mesh(1, 2, device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_debug_mesh(1, 1, device_type="cpu")
    # an abstract mesh counts on meta only
    with pytest.raises(ValueError, match="meta"):
        TransformerLM(smollm_135m.SMOKE, device="cpu",
                      policy=pol.make_policy(_pmesh((1, 2))))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2"):
            make_debug_mesh(1, 2, device_type="cpu")
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        lm = TransformerLM(smollm_135m.SMOKE, device="cpu",
                           generator=torch.Generator().manual_seed(0),
                           policy=pol.make_policy(mesh))
        base = TransformerLM(smollm_135m.SMOKE, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        tokens = torch.randint(0, 512, (2, 8),
                               generator=torch.Generator().manual_seed(1))
        with torch.inference_mode():
            assert torch.equal(lm.prefill(tokens), base.prefill(tokens))
    finally:
        dist.destroy_process_group()


def test_collectives_are_no_ops_without_a_policy():
    x = torch.arange(6.0).reshape(2, 3)
    assert ctx.get_axes() is None
    assert ctx.all_reduce_sum(x) is x and ctx.all_reduce_max(x) is x
    assert ctx.gather(x, 0) is x and ctx.gather(x, 1, "data") is x
    assert ctx.constrain(x, "batch", "tp") is x
    with ctx.axes(_pmesh((2, 2)), ("data",), "model"):
        # a local shard keeps its layout under a policy too
        assert ctx.constrain(x, "batch", "tp") is x
        assert ctx.constrain_leading(x) is x
        assert ctx.group_size("all") == 4 and ctx.group_index("all") == 0
        with ctx.recording() as rec:
            m = torch.empty(4, 3, device="meta")
            ctx.all_reduce_sum(m)
            assert ctx.gather(m, 1).shape == (4, 6)
            assert ctx.gather(m, 0, "data").shape == (8, 3)
        assert rec["all-reduce"] == [4 * 3 * 4, 1]
        assert rec["all-gather"] == [4 * 6 * 4 + 8 * 3 * 4, 2]
    assert ctx.get_axes() is None


# ---------------------------------------------------------------------------
# (b), (c) numerics over gloo against JAX under the same policy

LM_CASES = {
    "smollm": (smollm_135m.SMOKE, None),
    "qwen3": (qwen3_4b.SMOKE, None),
    "olmoe-ep": (olmoe_1b_7b.SMOKE, None),  # the default: EP at model 2
    "olmoe-tp": (olmoe_1b_7b.SMOKE, False),  # TP inside the experts
}


def _recsys_cfg(mod):
    cfg = mod.SMOKE
    return dataclasses.replace(cfg, vocab_sizes=tuple(
        4 * v for v in cfg.vocab_sizes))


RECSYS_CASES = {"xdeepfm": xdeepfm, "autoint": autoint}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """JAX's parameters, the tokens, the seeded cache and the recsys
    batches, as numpy, saved for the subprocesses."""
    from repro.data.synthetic import make_recsys_batch

    rng = np.random.default_rng(0)
    out = {"lm": {}, "recsys": {}}
    for seed, (name, (cfg, _)) in enumerate(LM_CASES.items()):
        jcfg = j_get_arch({"smollm": "smollm-135m", "qwen3": "qwen3-4b"}.get(
            name, "olmoe-1b-7b")).smoke_config
        params = jax.tree_util.tree_map(np.asarray, JLM(jcfg).init(
            jax.random.key(seed)))
        kv = (cfg.n_layers, B, CTX, cfg.n_kv_heads, cfg.head_dim)
        pos = np.full((cfg.n_layers, CTX), 2**31 - 1, np.int32)
        pos[:, :FILLED] = np.arange(FILLED)
        k = np.zeros(kv, np.float32)
        v = np.zeros(kv, np.float32)
        k[:, :, :FILLED] = rng.standard_normal(k[:, :, :FILLED].shape)
        v[:, :, :FILLED] = rng.standard_normal(v[:, :, :FILLED].shape)
        out["lm"][name] = {
            "params": params,
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "cache": {"k": k, "v": v, "pos": pos},
            "steps": rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(
                np.int32)}
    for name, mod in RECSYS_CASES.items():
        cfg = _recsys_cfg(mod)
        jcfg = dataclasses.replace(j_get_arch(name).smoke_config,
                                   vocab_sizes=cfg.vocab_sizes)
        params = jax.tree_util.tree_map(np.asarray, j_build_recsys(
            jcfg).init(jax.random.key(7)))
        out["recsys"][name] = {"params": params, "batches": {
            hot: make_recsys_batch(8, jcfg.n_sparse, jcfg.vocab_sizes,
                                   multi_hot=hot, seed=hot)
            for hot in (1, 3)}}
    path = tmp_path_factory.mktemp("sharding") / "inputs.pkl"
    path.write_bytes(pickle.dumps(out))
    return out, path


JAX_RUN = r"""
import dataclasses, pickle, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.models.recsys import build_model
from repro.models.transformer import TransformerLM
from repro.sharding import ctx, policies as pol

pol.REPLICATE_TABLE_BYTES = %(TABLE_BYTES)r
inputs = pickle.loads(open(sys.argv[1], "rb").read())
ARCH = {"smollm": "smollm-135m", "qwen3": "qwen3-4b"}
EP = %(EP)r
out = {}
def put(tree, specs, mesh):
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)
for shape in %(MESHES)r:
    # make_debug_mesh's axes are Explicit under this jax, which the
    # package's constraints refuse: the same (data, model) mesh, Auto
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(
        shape), ("data", "model"))
    for name, inp in inputs["lm"].items():
        cfg = get_arch(ARCH.get(name, "olmoe-1b-7b")).smoke_config
        ep = EP[name]
        if ep is None:
            ep = pol.default_expert_parallel(cfg, shape[1])
        policy = pol.make_policy(mesh, expert_parallel=ep)
        model = TransformerLM(cfg)
        params = put(inp["params"], pol.lm_param_specs(
            cfg, policy, inp["params"]), mesh)
        tokens = jax.device_put(inp["tokens"], NamedSharding(
            mesh, P(policy.dp, None)))
        prefill = jax.jit(ctx.with_axes(policy, model.prefill))
        res = {"prefill": np.asarray(prefill(params, tokens))}
        b = inp["tokens"].shape[0]
        cspecs = pol.lm_cache_specs(policy, b, inp["cache"]["k"].shape[2],
                                    cfg.n_kv_heads)
        cache = put(inp["cache"], cspecs, mesh)
        step = jax.jit(ctx.with_axes(policy, model.decode_step))
        tok_spec = P(policy.dp) if b %% policy.dp_size == 0 else P()
        logits = []
        for i, toks in enumerate(inp["steps"]):
            lg, cache = step(params, cache, jax.device_put(
                toks, NamedSharding(mesh, tok_spec)), %(FILLED)r + i)
            logits.append(np.asarray(lg))
        res["decode"] = np.stack(logits)
        out[(shape, name)] = res
    for name, inp in inputs["recsys"].items():
        cfg = dataclasses.replace(get_arch(name).smoke_config,
                                  vocab_sizes=tuple(
                                      4 * v for v in get_arch(
                                          name).smoke_config.vocab_sizes))
        policy = pol.make_policy(mesh)
        model = build_model(cfg)
        params = put(inp["params"], pol.recsys_param_specs(
            policy, inp["params"], serving=True), mesh)
        flat = policy.dp + (policy.tp,)
        fwd = jax.jit(ctx.with_axes(policy, model.forward, batch_axes=flat))
        for hot, batch in inp["batches"].items():
            placed = {k: jax.device_put(v, NamedSharding(
                mesh, P(flat, *([None] * (v.ndim - 1)))))
                for k, v in batch.items()}
            out[(shape, name, hot)] = np.asarray(fwd(params, placed))
open(sys.argv[2], "wb").write(pickle.dumps(out))
"""

GLOO_RANK = r"""
import dataclasses, pickle, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import recsys
from repro_torch.models.transformer import TransformerLM, shard_params
from repro_torch.sharding import policies as pol

pol.REPLICATE_TABLE_BYTES = %(TABLE_BYTES)r
inputs = pickle.loads(open(sys.argv[1], "rb").read())
port, rank, world = sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
ARCH = {"smollm": "smollm-135m", "qwen3": "qwen3-4b"}
EP = %(EP)r
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        rank=rank, world_size=world)
out = {}
try:
    for shape in [s for s in %(MESHES)r if s[0] * s[1] == world]:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        coords = mesh.get_coordinate()
        for name, inp in inputs["lm"].items():
            cfg = get_arch(ARCH.get(name, "olmoe-1b-7b")).smoke_config
            ep = EP[name]
            if ep is None:
                ep = pol.default_expert_parallel(cfg, shape[1])
            policy = pol.make_policy(mesh, expert_parallel=ep)
            lm = TransformerLM(cfg, device="cpu", policy=policy)
            lm.load_state_dict(shard_params(inp["params"], policy, coords,
                                            cfg))
            lm.routes = []
            b = inp["tokens"].shape[0]
            rows = b // shape[0]
            lo = coords[0] * rows
            tokens = torch.from_numpy(inp["tokens"][lo:lo + rows])
            with torch.inference_mode():
                res = {"prefill": lm.prefill(tokens).numpy(),
                       "rows": (lo, lo + rows)}
                cache = lm.init_cache(b, inp["cache"]["k"].shape[2])
                pl = policy.placements(pol.lm_cache_dims(
                    policy, b, inp["cache"]["k"].shape[2],
                    cfg.n_kv_heads)["k"])
                for n in ("k", "v"):
                    cache[n].copy_(torch.from_numpy(pol.shard_leaf(
                        inp["cache"][n], pl, mesh, coords)))
                cache["pos"].copy_(torch.from_numpy(inp["cache"]["pos"]))
                drows = b // lm.cache_data
                dlo = (coords[0] * drows) if lm.cache_data > 1 else 0
                logits = []
                for i, toks in enumerate(inp["steps"]):
                    lg, cache = lm.decode_step(
                        cache, torch.from_numpy(toks[dlo:dlo + drows]),
                        %(FILLED)r + i)
                    logits.append(lg.numpy())
                res["decode"] = np.stack(logits)
                res["decode_rows"] = (dlo, dlo + drows)
                res["cache_seq"] = lm.cache_seq
                res["routes"] = [(i.numpy(), k.numpy()) for i, k in lm.routes]
            out[(shape, name)] = res
        for name, inp in inputs["recsys"].items():
            base = get_arch(name).smoke_config
            cfg = dataclasses.replace(base, vocab_sizes=tuple(
                4 * v for v in base.vocab_sizes))
            policy = pol.make_policy(mesh)
            model = recsys.build_model(cfg, device="cpu", policy=policy)
            model.load_state_dict(recsys.shard_params(inp["params"], policy,
                                                      coords))
            n = rank  # batches split over every axis, in rank order
            for hot, batch in inp["batches"].items():
                rows = batch["label"].shape[0] // world
                mine = {k: torch.from_numpy(v[n * rows:(n + 1) * rows])
                        for k, v in batch.items()}
                with torch.inference_mode():
                    out[(shape, name, hot)] = (
                        model(mine).numpy(), (n * rows, (n + 1) * rows),
                        sorted(model.first))
finally:
    dist.destroy_process_group()
open(sys.argv[2], "wb").write(pickle.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """JAX on four forced host devices, and the port's gloo worlds of 2
    and 4 ranks, all started in the background -> a function that waits
    for them once."""
    _, path = inputs
    tmp = tmp_path_factory.mktemp("sharding_runs")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    args = dict(TABLE_BYTES=TABLE_BYTES, MESHES=NUM_MESHES, FILLED=FILLED,
                EP={k: v[1] for k, v in LM_CASES.items()})
    outs = {"jax": tmp / "jax.pkl"}
    procs = {"jax": subprocess.Popen(
        [sys.executable, "-c", JAX_RUN % args, str(path), str(outs["jax"])],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)}
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
                          for k, o in outs.items()})
        return cache

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def single(inputs):
    """The port at world size 1 (no policy) on the same inputs."""
    data, _ = inputs
    out = {}
    for name, (cfg, _) in LM_CASES.items():
        inp = data["lm"][name]
        lm = TransformerLM(cfg, device="cpu")
        from repro_torch.models.transformer import params_from_jax

        lm.load_state_dict(params_from_jax(inp["params"]))
        lm.routes = []
        with torch.inference_mode():
            res = {"prefill": lm.prefill(torch.from_numpy(
                inp["tokens"])).numpy()}
            cache = {k: torch.from_numpy(v.copy())
                     for k, v in inp["cache"].items()}
            logits = []
            for i, toks in enumerate(inp["steps"]):
                lg, cache = lm.decode_step(cache, torch.from_numpy(toks),
                                           FILLED + i)
                logits.append(lg.numpy())
            res["decode"] = np.stack(logits)
            res["routes"] = [(i.numpy(), k.numpy()) for i, k in lm.routes]
        out[name] = res
    return out


def _close(got, want, what):
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", list(LM_CASES))
@pytest.mark.parametrize("mesh", NUM_MESHES, ids=str)
def test_sharded_lm_matches_jax_and_world_size_one(mesh, case, runs,
                                                   single):
    got = runs()
    world = mesh[0] * mesh[1]
    want = got["jax"][(mesh, case)]
    one = single[case]
    cfg = LM_CASES[case][0]
    for r in range(world):
        res = got[(world, r)][(mesh, case)]
        lo, hi = res["rows"]
        for ref, label in ((want, "jax"), (one, "world size 1")):
            _close(res["prefill"], ref["prefill"][lo:hi],
                   f"prefill rank {r} vs {label}")
            dlo, dhi = res["decode_rows"]
            _close(res["decode"], ref["decode"][:, dlo:dhi],
                   f"decode rank {r} vs {label}")
        if cfg.n_kv_heads % mesh[1]:  # kv heads do not divide: by sequence
            assert res["cache_seq"] == ("model",), res["cache_seq"]
        if cfg.moe is not None:  # world size 1's routing, on each rank
            assert len(res["routes"]) == len(one["routes"])
            for j, ((wi, wk), (gi, gk)) in enumerate(zip(one["routes"],
                                                         res["routes"])):
                if len(gi) != len(wi):  # this rank's rows of the batch
                    per, lo = ((S, res["rows"][0]) if j < cfg.n_layers
                               else (1, res["decode_rows"][0]))
                    wi = wi[lo * per:lo * per + len(gi)]
                    wk = wk[lo * per:lo * per + len(gi)]
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gk, wk)


@pytest.mark.parametrize("case", list(RECSYS_CASES))
@pytest.mark.parametrize("mesh", NUM_MESHES, ids=str)
def test_row_sharded_recsys_matches_jax(mesh, case, runs):
    got = runs()
    world = mesh[0] * mesh[1]
    for hot in (1, 3):
        want = got["jax"][(mesh, case, hot)]
        for r in range(world):
            logits, (lo, hi), sharded = got[(world, r)][(mesh, case, hot)]
            assert "fields.table" in sharded
            _close(logits, want[lo:hi], f"{case} H={hot} rank {r}")


def test_shard_params_cut_jax_parameters_by_the_placements(inputs):
    data, _ = inputs
    cfg = smollm_135m.SMOKE
    params = data["lm"]["smollm"]["params"]
    mesh = _pmesh((2, 2))
    policy = pol.make_policy(mesh)
    from repro_torch.models.transformer import params_from_jax

    whole = params_from_jax(params)
    specs = pol.lm_param_specs(cfg, policy, whole)
    parts = {c: shard_params(params, policy, c, cfg)
             for c in [(0, 0), (0, 1), (1, 0), (1, 1)]}
    for name, w in whole.items():
        d_model = [i for i, p in enumerate(specs[name])
                   if isinstance(p, pol.Shard)]
        got = parts[(1, 1)][name]
        assert tuple(got.shape) == pol.local_shape(w.shape, specs[name],
                                                   mesh)
        assert got.is_contiguous()
        if not d_model:
            assert torch.equal(got, w)
    wq = whole["blocks.0.attn.wq"]  # (data on D, model on H Dh)
    np.testing.assert_array_equal(
        parts[(1, 0)]["blocks.0.attn.wq"].numpy(),
        wq[24:, :24].numpy())


def test_reshard_places_each_leaf_by_its_placements():
    from repro_torch.checkpoint.checkpoint import reshard

    mesh = _pmesh((2, 2))
    policy = pol.make_policy(mesh)
    tree = {"embed": np.arange(16 * 4, dtype=np.float32).reshape(16, 4),
            "ln_f": np.ones(4, np.float32)}
    specs = pol.lm_param_specs(smollm_135m.SMOKE, policy, tree)
    got = reshard(tree, "cpu", specs, mesh, (1, 0))  # data 1, model 0
    assert torch.equal(got["embed"], torch.from_numpy(tree["embed"][:8, 2:]))
    assert got["embed"].is_contiguous()
    assert torch.equal(got["ln_f"], torch.ones(4))
    whole = reshard(tree, "cpu")
    assert whole["embed"].shape == (16, 4)
