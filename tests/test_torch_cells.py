"""repro_torch's cell layer vs repro's, on the CPU.

- ``all_cells()`` is JAX's list, and every cell's ``model_flops`` and
  microbatch count equal those of JAX's ``build_cell``: on one device
  (``make_debug_mesh(1, 1)``, the port's ``"single"``) and on four forced
  host devices in a background subprocess (``make_debug_mesh(4, 1)``,
  the port's data-parallel ``"quad"``; and ``make_debug_mesh(2, 2)``,
  the port's ``"quad_tp"``, where ``seq_parallel`` is JAX's
  ``adjusted_lm_cfg`` decision too).  The port's cells are built on
  ``meta``; at ``"quad_tp"`` the serving cells hold one rank's shards
  and count the tensor-parallel collectives.
- ``retrieval_input_specs`` / ``retrieval_tiled_specs`` give JAX's shapes
  and dtypes at S = 1, 2, 4.
- The probes: one matmul counts 2 m n k FLOPs; on smoke configs every
  extrapolated count (layers x microbatches, layers x prefill tiles,
  interactions, GRU steps, ELL slabs) equals the count of the whole step
  exactly; a cell's count is one rank's.
- ``RooflineTerms`` on a hand example; ``elastic_restart_plan`` equals
  JAX's over a grid; the mesh of a plan over a gloo group of one.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.launch.cells import all_cells as j_all_cells
from repro.launch.cells import build_cell as j_build_cell
from repro.launch.mesh import make_debug_mesh
from repro.runtime.elastic import elastic_restart_plan as j_plan
from repro_torch.analysis import ops as ops_mod
from repro_torch.analysis import probes, report
from repro_torch.analysis.roofline import (
    HBM_BW, NVLINK_BW, PEAK_FLOPS, RooflineTerms,
)
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import distributed as tdist
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import make_device_mesh as make_device_mesh_port
from repro_torch.runtime import elastic
from repro_torch.sharding import policies as pol

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = j_all_cells()

JAX_QUAD = r"""
import json, sys
from repro.configs import get_arch
from repro.launch.cells import adjusted_lm_cfg, all_cells, build_cell
from repro.launch.mesh import make_debug_mesh
from repro.sharding import policies as pol
out = {}
for name, shape in (("quad", (4, 1)), ("quad_tp", (2, 2))):
    mesh = make_debug_mesh(*shape)
    policy = pol.make_policy(mesh)
    for a, s in all_cells():
        c = build_cell(a, s, mesh)
        spec = get_arch(a)
        sh = next(x for x in spec.shapes if x.name == s)
        sp = (adjusted_lm_cfg(spec.config, sh, policy).seq_parallel
              if spec.family == "lm" and sh.kind == "train" else None)
        out[name + ":" + a + "/" + s] = [c.model_flops,
                                         c.meta.get("microbatches"), sp]
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_quad(tmp_path_factory):
    """JAX's cells on four forced host devices, built in the background
    when first asked for and read when a test needs them."""
    out = tmp_path_factory.mktemp("cells4") / "cells.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", JAX_QUAD, str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    cache = {}

    def result():
        if not cache:
            log, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, log
            cache.update(json.loads(out.read_text()))
        return cache

    yield result
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def jax_single():
    mesh = make_debug_mesh(1, 1)
    out = {}
    for a, s in CELLS:
        c = j_build_cell(a, s, mesh)
        out[f"{a}/{s}"] = [c.model_flops, c.meta.get("microbatches")]
    return out


def test_all_cells_are_jax(jax_quad):  # starts JAX's four-device build
    assert cells.all_cells() == CELLS and len(CELLS) == 39
    with pytest.raises(ValueError, match="documented skip"):
        cells.build_cell("qwen3-4b", "long_500k")


def _port_numbers(arch, shape, layout):
    c = cells.build_cell(arch, shape, layout)
    assert c.layout == layout and c.arch_id == arch
    for t in torch.utils._pytree.tree_flatten(c.args)[0]:
        if isinstance(t, torch.Tensor):
            assert t.is_meta, (arch, shape)
    return [c.model_flops, c.meta.get("microbatches")]


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_model_flops_and_microbatches_match_jax_on_one_card(cell, jax_single):
    assert _port_numbers(*cell, "single") == jax_single["/".join(cell)]


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_model_flops_and_microbatches_match_jax_on_four_cards(cell, jax_quad):
    assert _port_numbers(*cell, "quad") == jax_quad()[
        "quad:" + "/".join(cell)][:2]


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_cells_at_quad_tp_match_jax_on_a_two_by_two_mesh(cell, jax_quad):
    c = cells.build_cell(*cell, "quad_tp")
    assert c.layout == "quad_tp"
    for t in torch.utils._pytree.tree_flatten(c.args)[0]:
        if isinstance(t, torch.Tensor):
            assert t.is_meta, cell
    flops, mb, sp = jax_quad()["quad_tp:" + "/".join(cell)]
    assert [c.model_flops, c.meta.get("microbatches"),
            c.meta.get("seq_parallel")] == [flops, mb, sp]
    spec = get_arch(cell[0])
    if spec.family in ("lm", "recsys"):
        policy = c.meta["policy"]
        assert policy["mesh"] == (2, 2)
        assert policy["expert_parallel"] == pol.default_expert_parallel(
            spec.config, 2)
        if c.meta["kind"] != "train":  # one rank's shards, on meta
            held = sum(p.numel() * 4 for p in c.model.parameters())
            assert held == policy["param_bytes_per_rank"]


def test_seq_parallel_takes_jaxs_divisibility_clause():
    """A training shape whose residuals exceed the budget: sequence
    parallel unless the model axis does not divide the sequence."""
    from repro.configs import get_arch as j_get_arch
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.launch.cells import adjusted_lm_cfg
    from repro.sharding import policies as jpol
    from jax.sharding import AbstractMesh

    from repro_torch.launch.mesh import Layout

    for seq in (4096, 4098, 4099):
        for tp in (1, 2, 3, 4):
            shape = ShapeSpec(name="t", kind="train", seq_len=seq,
                              global_batch=8)
            jshape = JShapeSpec(name="t", kind="train", seq_len=seq,
                                global_batch=8)
            policy = jpol.make_policy(AbstractMesh((1, tp),
                                                   ("data", "model")))
            cfg = get_arch("mixtral-8x22b").config
            want = adjusted_lm_cfg(j_get_arch("mixtral-8x22b").config,
                                   jshape, policy).seq_parallel
            got = cells.seq_parallel(cfg, shape, Layout("t", tp, 1, tp))
            assert got == want, (seq, tp)
            if tp > 1 and seq % tp:
                assert not got  # the clause decides
    assert cells.seq_parallel(cfg, ShapeSpec(name="t", kind="train",
                                             seq_len=4098, global_batch=8),
                              Layout("t", 1, 1, 1))


def test_dryrun_counts_tensor_parallel_collectives(tmp_path):
    """At quad_tp a serving cell's count records the collectives of its
    sharded step; ``--expert-parallel`` tags the artifact ``_ep`` and
    ``--skip-existing`` leaves it alone."""
    args = ["--arch", "olmoe-1b-7b", "--shape", "decode_32k", "--layout",
            "quad_tp", "--out", str(tmp_path)]
    dryrun.main(args + ["--expert-parallel"])
    path = tmp_path / "olmoe-1b-7b__decode_32k__quad_tp_ep.json"
    art = json.loads(path.read_text())
    assert art["expert_parallel"] and art["meta"]["policy"][
        "expert_parallel"]
    coll = art["collectives"]
    # all-reduces: 16 layers' attention and experts, plus the embedding;
    # all-gathers: FSDP's of every layer over the data axis, plus the
    # head's logits over the model axis
    assert coll["counts"]["all-reduce"] == 2 * 16 + 1
    assert coll["counts"]["all-gather"] >= 16 + 1
    assert coll["total_bytes"] > 0
    stamp = path.stat().st_mtime_ns
    dryrun.main(args + ["--expert-parallel", "--skip-existing"])
    assert path.stat().st_mtime_ns == stamp
    single = dryrun.run_cell("olmoe-1b-7b", "decode_32k", save=False,
                             verbose=False)
    assert single["collectives"]["total_bytes"] == 0


def test_lm_cells_record_the_sequence_parallel_decision():
    """JAX's ``adjusted_lm_cfg`` decides sequence parallelism for a
    training cell; the port records the same decision in ``meta``."""
    from repro.configs import get_arch as j_get_arch
    from repro.launch.cells import adjusted_lm_cfg
    from repro.sharding import policies as pol

    policy = pol.make_policy(make_debug_mesh(1, 1))
    seen = set()
    for a, s in CELLS:
        if s != "train_4k":
            continue
        jspec = j_get_arch(a)
        shape = next(x for x in jspec.shapes if x.name == s)
        want = adjusted_lm_cfg(jspec.config, shape, policy).seq_parallel
        got = cells.build_cell(a, s).meta["seq_parallel"]
        assert got == want, a
        seen.add(want)
    assert seen == {True, False}


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_retrieval_specs_match_jax(shards):
    args = dict(num_docs=1_000_003, vocab_size=30522, batch=500,
                avg_doc_terms=128, num_shards=shards)
    for name in ("retrieval_input_specs", "retrieval_tiled_specs"):
        got = getattr(tdist, name)(**args)
        want = getattr(jdist, name)(**args)
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            if isinstance(w, (tuple, list)) or hasattr(w, "dtype"):
                ws = w if isinstance(w, (tuple, list)) else (w,)
                gs = g if isinstance(g, (tuple, list)) else (g,)
                assert len(gs) == len(ws)
                for gi, wi in zip(gs, ws):
                    assert gi.is_meta and tuple(gi.shape) == wi.shape
                    assert str(gi.dtype).split(".")[-1] == str(wi.dtype)
            else:
                assert g == w, (name, k)


# -- the probes ---------------------------------------------------------------

def test_one_matmul_counts_two_m_n_k():
    m, k, n = 7, 33, 20
    lin = torch.nn.Linear(k, n, bias=False, device="meta")
    x = torch.empty(m, k, device="meta")
    cost, ops = probes.count(lambda x: lin(x), (x,))
    assert cost.flops == 2 * m * n * k
    # mm reads x and W and writes y; the weight's transpose is a view
    assert cost.bytes == 4 * (m * k + k * n + m * n)
    # x, y and W (seen through its transpose, though not an input)
    assert cost.peak == 4 * (m * k + k * n + m * n)
    assert ops["aten.mm"] == 1


def _smoke(arch, **cut):
    spec = get_arch(arch)
    return dataclasses.replace(
        spec, config=dataclasses.replace(spec.smoke_config, **cut))


# (spec, shape): every extrapolation against the whole count
PROBE_CASES = {
    "lm_train_microbatches": (
        lambda: _smoke("qwen2-0.5b", attn_q_chunk=16, attn_kv_chunk=32),
        ShapeSpec(name="t", kind="train", seq_len=32, global_batch=6)),
    "moe_train_one_microbatch": (
        lambda: _smoke("olmoe-1b-7b", attn_q_chunk=16, attn_kv_chunk=32),
        ShapeSpec(name="t", kind="train", seq_len=64, global_batch=1)),
    "lm_prefill_tiles": (
        lambda: _smoke("qwen3-4b", attn_q_chunk=16, attn_kv_chunk=32),
        ShapeSpec(name="p", kind="prefill", seq_len=224, global_batch=2)),
    "lm_decode": (
        lambda: _smoke("smollm-135m"),
        ShapeSpec(name="d", kind="decode", seq_len=96, global_batch=4)),
    "schnet_graph": (
        lambda: get_arch("schnet"),
        ShapeSpec(name="g", kind="gnn_full", n_nodes=300, n_edges=1200,
                  d_feat=24)),
    "schnet_molecules": (
        lambda: get_arch("schnet"),
        ShapeSpec(name="m", kind="gnn_batched", n_nodes=9, n_edges=20,
                  global_batch=8)),
    "dien_gru_steps": (
        lambda: _smoke("dien"),
        ShapeSpec(name="s", kind="recsys_train", global_batch=32)),
    "ell_slabs": (
        lambda: dataclasses.replace(
            get_arch("gpusparse"),
            config=get_arch("gpusparse").smoke_config),
        ShapeSpec(name="r", kind="retrieval_serve", num_docs=0,
                  global_batch=4096)),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_extrapolated_count_equals_the_whole_count(case, monkeypatch):
    make_spec, shape = PROBE_CASES[case]
    spec = make_spec()
    if case == "lm_train_microbatches":
        # a budget that asks for 3 microbatches of 2 sequences
        monkeypatch.setattr(cells, "ACT_BUDGET", 15_000)
        assert cells._lm_microbatches(spec.config, shape, 1) == 3
    if case == "ell_slabs":
        # a shard of 20 whole slabs of the plain gather (73 docs at B =
        # 4,096 queries x 56 slots; k = 1,000 docs fill 14 of them)
        from repro_torch.kernels.ell_gather import ref as ell_ref
        slab = ell_ref._SLAB_ELEMS // (4096 * 56)
        shape = dataclasses.replace(shape, num_docs=20 * slab)
    got = probes.spec_cost(spec, shape)
    whole, _ = probes.count_cell(cells.make_cell(spec, shape))
    assert got["total"]["flops"] == whole.flops
    assert got["total"]["bytes"] == whole.bytes
    # the peak is an estimate, linear through the two largest probes
    assert got["total"]["peak_bytes"] == pytest.approx(whole.peak, rel=0.05)
    assert got["trips"] or case in ("lm_decode",)


def test_the_count_is_one_ranks_step():
    """On four data-parallel cards a molecule batch's rank steps a quarter
    of it; its gradients all-reduce through one f32 buffer."""
    spec = get_arch("schnet")
    one = probes.cell_cost("schnet", "molecule", "single")["total"]
    four = probes.cell_cost("schnet", "molecule", "quad")["total"]
    assert four["flops"] * 4 == one["flops"]
    quad = cells.build_cell("schnet", "molecule", "quad")
    coll = ops_mod.collective_bytes(quad)
    n_params = sum(p.numel() for p in quad.args[0]["params"].values())
    assert coll.by_kind == {"all-reduce": 4 * n_params + 4}
    assert ops_mod.collective_bytes(
        cells.build_cell("schnet", "molecule")).total_bytes == 0
    assert spec.family == "gnn"


def test_dryrun_writes_an_artifact_a_cell(tmp_path, capsys):
    art = dryrun.run_cell("schnet", "full_graph_sm", out_dir=str(tmp_path),
                          verbose=False)
    saved = json.loads((tmp_path / "schnet__full_graph_sm__single.json")
                       .read_text())
    assert saved["model_flops"] == art["model_flops"] == pytest.approx(6.74e9,
                                                                        rel=1e-3)
    assert saved["fits"] and saved["roofline"]["dominant"] in (
        "compute", "memory")
    assert saved["cost"]["flops"] > 0 and saved["op_histogram"]
    # the report reads the artifacts back
    dryrun.run_cell("schnet", "molecule", out_dir=str(tmp_path),
                    verbose=False)
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "schnet" in out and "molecule" in out and "hillclimb" in out
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--arch", "schnet", "--device", "cuda",
                     "--out", str(tmp_path)])


# -- roofline and elastic restart ---------------------------------------------

def test_roofline_terms_on_a_hand_example():
    t = RooflineTerms(arch="a", shape="s", layout="quad", chips=4,
                      flops=2 * 66.9e12, bytes=3.35e12, coll_bytes=45e9,
                      model_flops=4 * 66.9e12, meta={}, compute="f32")
    assert t.t_compute == pytest.approx(2.0)
    assert t.t_memory == pytest.approx(1.0)
    assert t.t_collective == pytest.approx(0.1)
    assert t.dominant == "compute" and t.bound_time == pytest.approx(2.0)
    assert t.useful_ratio == pytest.approx(0.5)
    assert t.roofline_fraction == pytest.approx(0.5)
    bf = dataclasses.replace(t, compute="bf16")
    assert bf.t_compute == pytest.approx(2 * 66.9 / 989.4)
    assert bf.dominant == "memory"
    assert PEAK_FLOPS["tf32"] == 494.7e12 and HBM_BW == 3.35e12
    assert NVLINK_BW == 450e9


@pytest.mark.parametrize("tp", [1, 2, 16])
def test_elastic_restart_plan_matches_jax(tp):
    for avail in (1, 2, 3, 4, 5, 7, 8, 12, 16, 31, 64, 100, 384):
        for old in (1, 2, 4, 16):
            for pod in (1, 2):
                if avail < tp:
                    with pytest.raises(ValueError):
                        elastic.elastic_restart_plan(avail, tp, old, pod)
                    with pytest.raises(ValueError):
                        j_plan(avail, tp, old, pod)
                    continue
                got = elastic.elastic_restart_plan(avail, tp, old, pod)
                want = j_plan(avail, tp, old, pod)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_mesh_of_a_plan_over_a_gloo_group_of_one(tmp_path):
    import torch.distributed as dist

    plan = elastic.elastic_restart_plan(1, 1, 4)
    with pytest.raises(RuntimeError, match="process group"):
        elastic.make_mesh_from_plan(plan, "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = elastic.make_mesh_from_plan(plan, "cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
        single = make_device_mesh_port("single", "cpu")
        assert tuple(single.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="4 rank"):
            make_device_mesh_port("quad", "cpu")
        state = elastic.remesh_state({"w": np.arange(3.0)}, mesh)
        assert torch.equal(state["w"], torch.arange(3.0, dtype=torch.float64))
        with pytest.raises(ValueError, match="4 rank"):
            elastic.make_mesh_from_plan(elastic.elastic_restart_plan(4, 1, 4),
                                        "cpu")
    finally:
        dist.destroy_process_group()


GNN_DEVICE_CASES = {
    "full": (ShapeSpec(name="g", kind="gnn_full", n_nodes=300,
                       n_edges=1201, d_feat=24), "single"),
    "full_quad": (ShapeSpec(name="g", kind="gnn_full", n_nodes=300,
                            n_edges=1201, d_feat=24), "quad"),
    "minibatch": (ShapeSpec(name="mb", kind="gnn_minibatch", n_nodes=2000,
                            n_edges=20000, batch_nodes=8, fanout=(3, 2)),
                  "single"),
    "molecules": (ShapeSpec(name="m", kind="gnn_batched", n_nodes=9,
                            n_edges=20, global_batch=8), "single"),
}


@pytest.mark.parametrize("case", sorted(GNN_DEVICE_CASES))
def test_gnn_cell_on_a_device_is_the_meta_cell_with_values(case):
    """A GNN cell on a device (here the CPU) holds ``gnn_batch``'s graph in
    the meta cell's shapes and dtypes, pads edges with sender 0 and
    receiver N, and steps to a finite loss."""
    shape, layout = GNN_DEVICE_CASES[case]
    spec = get_arch("schnet")
    meta = cells.make_cell(spec, shape, layout)
    cell = cells.make_cell(spec, shape, layout, device="cpu", seed=3)
    assert cell.model_flops == meta.model_flops
    mb, b = meta.args[1], cell.args[1]
    assert sorted(mb) == sorted(b)
    for k in mb:
        assert (b[k].shape, b[k].dtype, b[k].device.type) == (
            mb[k].shape, mb[k].dtype, "cpu"), k
    arrays, info = cells.gnn_batch(shape, 4, 4 if layout == "quad" else 1)
    for k, v in arrays.items():
        np.testing.assert_array_equal(b[k].numpy(), v)
    if shape.kind != "gnn_batched":
        n_pad = b["node_feat"].shape[0]
        m = info.get("sampled_edges", shape.n_edges)
        assert (b["receivers"][m:] == n_pad).all()
        assert (b["senders"][m:] == 0).all()
        assert int(b["receivers"][:m].max()) < n_pad
    if shape.kind == "gnn_minibatch":
        assert info["seeds"] == 8 and b["node_mask"].sum() == 8
        assert info["sampled_nodes"] <= b["node_feat"].shape[0]
    state, metrics = cell.step_fn(*cell.args)
    assert np.isfinite(float(metrics["loss"]))
