"""Helpers shared by the port's CPU parity tests (``test_torch_*.py``).

``assert_same_topk`` compares two (values, ids) top-k results tie-aware:
values allclose at rtol 1e-5 / atol 1e-6 (f32 sums in another order), ids
equal except inside a run of reference values closer than that tolerance
(an f32 near-tie, which the two packages may order either way): there
only the set of ids must match, and in the run that reaches the k-th slot
— which may go on past the cut — each id must carry its float64 score.

``assert_bf16_topk`` compares two bf16 top-ks the same way at one bf16 ulp.

``dyadic`` rounds a JAX batch's weights to multiples of 2^-8: every f32
sum of their products is then exact in any order, so the two packages'
scores, top-k and certified thresholds agree bit for bit (the serving
state's tests hold them so; ties break lower id first in both).
"""
import numpy as np
import torch

from repro_torch.core import index as tidx
from repro_torch.core.sparse import SparseBatch

RTOL, ATOL = 1e-5, 1e-6

# One intra-op thread a process.  The suite runs in several worker
# processes at once (pytest-xdist; every worker imports this module when it
# collects the port's tests), and torch's per-process pools of as many
# threads as cores, spinning on shared cores, slow the plain versions'
# loops of small ops by tens of times (a 1 s sweep test took 34 s beside
# seven busy processes, 1.2 s with one thread).  Sums are exact or held to
# tolerances, never to a thread count.
torch.set_num_threads(1)


def port_batch(batch) -> SparseBatch:
    """A JAX ``SparseBatch`` as the port's, on the CPU."""
    return SparseBatch(torch.from_numpy(np.array(batch.term_ids)),
                       torch.from_numpy(np.array(batch.values)),
                       batch.vocab_size)


def dyadic(batch, scale: float = 2.0 ** 8):
    """A JAX ``SparseBatch`` with its nonzero weights rounded to nonzero
    multiples of ``1 / scale``."""
    import jax.numpy as jnp
    from repro.core.sparse import SparseBatch as JBatch

    v = np.asarray(batch.values)
    v = np.sign(v) * np.maximum(np.round(np.abs(v) * scale), 1) / scale
    return JBatch(jnp.asarray(np.asarray(batch.term_ids)),
                  jnp.asarray(v.astype(np.float32)), batch.vocab_size)


def carry_tiled(j):
    """A JAX ``TiledIndex`` as the port's, on the CPU, field for field."""
    fields = tidx.TILED_ARRAY_FIELDS + tidx.TILED_OPTIONAL_ARRAY_FIELDS
    return tidx.tiled_index_from_numpy(
        {f: getattr(j, f) for f in fields if getattr(j, f) is not None},
        {f: getattr(j, f) for f in tidx.TILED_SCALAR_FIELDS}, device="cpu",
    )


def assert_same_topk(port, ref, oracle, deleted=None):
    (pv, pi), (rv, ri) = port, ref
    np.testing.assert_allclose(pv, rv, rtol=RTOL, atol=ATOL)
    k = rv.shape[1]
    for row in range(rv.shape[0]):
        v = rv[row]
        with np.errstate(invalid="ignore"):  # -inf - -inf
            same = (v[1:] == v[:-1]) | (
                np.abs(v[1:] - v[:-1]) <= ATOL + RTOL * np.abs(v[1:]))
        starts = np.concatenate([[0], np.nonzero(~same)[0] + 1])
        ends = np.concatenate([starts[1:], [k]])
        for s, e in zip(starts, ends):
            if e < k:
                assert set(pi[row, s:e]) == set(ri[row, s:e]), (row, s, e)
        live = np.isfinite(pv[row])
        assert np.all(pi[row][~live] == -1)
        got = oracle[row, pi[row][live]]
        np.testing.assert_allclose(pv[row][live], got, rtol=RTOL, atol=ATOL)
        if deleted is not None:
            assert not np.any(deleted[pi[row][live]])


def bf16_ulp(x) -> np.ndarray:
    """One bf16 ulp at each value of ``x`` (2^(e - 7) for |x| in [2^e,
    2^(e + 1)))."""
    x = np.abs(np.asarray(x, np.float64))
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


def assert_bf16_topk(port, ref):
    """Two bf16 top-ks under one contract whose f32 sums ran in other
    orders: each value within one bf16 ulp of ``ref``'s at its rank (a
    score may round either way at a tie of the f32 sums), and an id in one
    list but not the other only at a value within one ulp of the other's
    k-th value (a rounding tie at the cut)."""
    (pv, pi), (rv, ri) = ((np.asarray(v), np.asarray(i)) for v, i, *_ in
                          (port, ref))
    assert pv.shape == rv.shape and pi.shape == ri.shape
    assert np.all(np.abs(pv - rv) <= bf16_ulp(rv))
    for row in range(rv.shape[0]):
        for v, ids, other, kth in ((pv[row], pi[row], ri[row], rv[row, -1]),
                                   (rv[row], ri[row], pi[row], pv[row, -1])):
            out = ~np.isin(ids, other)
            assert np.all(v[out] <= kth + bf16_ulp(kth)), (row, ids[out])


def shard_run(tdocs, tq, shards, *, k, geo, min_share):
    """What one rank of a sharded serve does, as ``run(group)``: build the
    whole index, keep its own shard, serve ``ell`` and ``tiled-bmp-fused``
    -> ({name: (values, ids, tau)}, the fused step's plan groups).  Shared
    by the thread emulation and the gloo ranks of
    ``test_torch_distributed.py``."""
    from repro_torch.core import distributed as tdist
    from repro_torch.core.engine import RetrievalConfig
    from repro_torch.sched.planner import PlanCache

    def run(group):
        rank = tdist.group_rank_size(group)[0]
        ell = tdist.build_sharded_ell(tdocs, shards).keep_shard(rank, "cpu")
        tiled = tdist.build_sharded_tiled(tdocs, shards, **geo).keep_shard(
            rank, "cpu")
        out = {"ell": tdist.make_serve_step(
            group, engine="ell", k=k,
            docs_per_shard=ell.docs_per_shard)(ell, queries=tq)}
        cfg = RetrievalConfig(engine="tiled-bmp-fused", k=k,
                              sched_min_share=min_share)
        cfg.plan_cache = PlanCache()
        out["fused"] = tdist.make_serve_step(
            group, cfg=cfg, docs_per_shard=tiled.docs_per_shard,
            geometry=tiled.geometry())(tiled, queries=tq)
        groups = [[g.tolist() for g in plan.groups]
                  for plan in cfg.plan_cache._plans.values()]
        return out, groups

    return run
