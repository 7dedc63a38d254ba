"""The counted cost of a cell, on ``meta`` (``repro.analysis.probes``).

JAX lowers loop-free probe programs and reads XLA's ``cost_analysis()``.
The port runs a cell's step eagerly on ``meta`` tensors under a
``TorchDispatchMode`` (:class:`CostMode`) that sees every aten op after
autograd and counts:

- **FLOPs** with ``torch.utils.flop_counter``'s formulas, which cover the
  matmul-class ops (``mm``, ``addmm``, ``bmm``, convolutions, fused
  attention) and nothing else: ``index_add_``, gathers and elementwise ops
  count 0, where XLA counts them;
- **bytes**: the inputs plus the outputs of each aten op (views and
  allocations move nothing and count 0): XLA's "bytes accessed" without
  fusion.  A gather (``index``, ``index_select``, ``gather``,
  ``embedding``) reads the rows it selects, not its whole source: its
  indices plus twice its output; an in-place scatter (``index_add_``,
  ``index_put_``, ``scatter_add_``, ...) its indices plus three times
  its source (the source read, the touched rows read and written);
- **peak live bytes**: every storage the step's inputs hold, plus each
  storage an op creates until it is freed (for a train step: parameters,
  optimizer state, gradients and what autograd saves).

Eager ``meta`` execution grows with layers x microbatches (mixtral
``train_4k``: 56 layers x 256 microbatches) and with attention tiles, so
the cost is extrapolated from probes as JAX's is: L in {1, 2} layers for
the LMs (on one microbatch, or on m in {2, 3} with the accumulation path
when the cell has several: cost = A + B L + C m + D L m; a prefill also
at S in {1, 2, 3} x the attention tile, quadratic in S: its tiles grow as
S^2), ``n_interactions`` in {1, 2} for SchNet, the GRU's sequence length
in {2, 3, 4} for DIEN (quadratic: see :func:`recsys_cell_cost`), and for the sharded ``ell`` step the docs a shard
holds at two whole numbers of the plain gather's slabs, at least k docs
(linear).  Every other cell is counted whole.  FLOPs and bytes
extrapolate exactly (each layer, microbatch, interaction, time step, tile
or slab repeats the same ops; a ragged last slab within one slab's
fixed bytes).  The peak is an estimate, linear in the same variables
through the two largest probes (at one microbatch count).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ArchSpec, ShapeSpec, get_arch
from repro_torch.launch import cells as cells_mod
from repro_torch.launch.mesh import production_layout
from repro_torch.sharding import ctx

NOTES = (
    "flops: torch.utils.flop_counter formulas, matmul-class ops only "
    "(index_add_, gathers and elementwise ops count 0, unlike XLA); bytes: "
    "inputs + outputs of each aten op, views and allocations excluded "
    "(XLA's bytes accessed without fusion); peak: live storages, the "
    "inputs' included, on meta")

aten = torch.ops.aten
# Ops that move no data though their schema says they return a new tensor.
_NO_BYTES = {aten._unsafe_view, aten.empty, aten.empty_strided,
             aten.empty_like, aten.new_empty, aten.new_empty_strided}
# Gathers: (index args) -> read the selected rows, write the output.
_GATHERS = {aten.index: (1,), aten.index_select: (2,), aten.gather: (2,),
            aten.embedding: (1,)}
# In-place scatters: (index args, source arg).
_SCATTERS = {aten.index_add_: ((2,), 3), aten.index_put_: ((1,), 2),
             aten._index_put_impl_: ((1,), 2), aten.scatter_add_: ((2,), 3),
             aten.scatter_: ((2,), 3), aten.index_copy_: ((2,), 3)}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes, aten ops and live storage bytes of what runs
    under it; ``roots`` are the tensors alive before (the step's
    inputs)."""

    def __init__(self, roots=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops: collections.Counter = collections.Counter()
        self._held: set = set()  # storages of the roots, held by the caller
        self._new: dict = {}  # storage -> (weak ref, bytes), made here
        self.live = 0
        for t in _tensors(roots):
            st = t.untyped_storage()
            if st._cdata not in self._held:
                self._held.add(st._cdata)
                self.live += st.nbytes()
        self.peak = self.live

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held or key in self._new:
                continue
            self._new[key] = (StorageWeakRef(st), st.nbytes())
            self.live += st.nbytes()
        # ``live`` counts freed storages until a sweep, so it bounds the
        # true live bytes from above: sweep only when it tops the peak.
        if self.live > self.peak:
            for key, (ref, n) in list(self._new.items()):
                if ref.expired():
                    del self._new[key]
                    self.live -= n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        self.ops[str(packet)] += 1
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        outs = _tensors(out)
        self.bytes += _op_bytes(func, packet, args, kwargs, outs)
        self._track(outs)
        return out


def _op_bytes(func, packet, args, kwargs, outs) -> int:
    if func.is_view or packet in _NO_BYTES:
        return 0
    if packet in _GATHERS:
        idx = _tensors([args[i] for i in _GATHERS[packet] if i < len(args)])
        return (sum(_nbytes(t) for t in idx)
                + 2 * sum(_nbytes(t) for t in outs))
    if packet in _SCATTERS and len(args) > _SCATTERS[packet][1]:
        where, src = _SCATTERS[packet]
        idx = _tensors([args[i] for i in where])
        src_t = args[src]
        n = _nbytes(src_t) if isinstance(src_t, torch.Tensor) else 0
        return sum(_nbytes(t) for t in idx) + 3 * n
    return (sum(_nbytes(t) for t in _tensors((args, kwargs)))
            + sum(_nbytes(t) for t in outs))


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    peak: float = 0.0
    # the sharded paths' collectives (``sharding.ctx``), by kind: output
    # bytes and calls
    all_reduce: float = 0.0
    all_reduce_n: float = 0.0
    all_gather: float = 0.0
    all_gather_n: float = 0.0
    reduce_scatter: float = 0.0
    reduce_scatter_n: float = 0.0

    def _map(self, fn, o=None):
        return Cost(*(fn(getattr(self, f.name),
                         None if o is None else getattr(o, f.name))
                      for f in dataclasses.fields(self)))

    def __add__(self, o):
        return self._map(lambda a, b: a + b, o)

    def __sub__(self, o):
        return self._map(lambda a, b: a - b, o)

    def __mul__(self, k: float):
        return self._map(lambda a, _: a * k)

    __rmul__ = __mul__

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak,
                "collectives": {"all-reduce": [self.all_reduce,
                                               self.all_reduce_n],
                                "all-gather": [self.all_gather,
                                               self.all_gather_n],
                                "reduce-scatter": [self.reduce_scatter,
                                                   self.reduce_scatter_n]}}


def count(fn: Callable, args: tuple) -> tuple[Cost, collections.Counter]:
    """Run ``fn(*args)`` under :class:`CostMode` -> (its cost, its aten op
    histogram), with the collectives the sharded paths issue
    (``sharding.ctx.recording``: nothing moves on ``meta``)."""
    with CostMode(roots=args) as mode, ctx.recording() as rec:
        fn(*args)
    return Cost(mode.flops, mode.bytes, mode.peak, *rec["all-reduce"],
                *rec["all-gather"], *rec["reduce-scatter"]), mode.ops


def count_cell(cell) -> tuple[Cost, collections.Counter]:
    try:
        return count(cell.step_fn, cell.args)
    except Exception as e:
        e.add_note(f"counting cell {cell.arch_id}/{cell.shape_name}/"
                   f"{cell.layout} on meta")
        raise


def _linear(c1: Cost, c2: Cost) -> tuple[Cost, Cost]:
    """(per unit, base) of a cost linear in n, from n = 1 and n = 2."""
    per = c2 - c1
    return per, c1 - per


# ---------------------------------------------------------------------------
# per family


def lm_cell_cost(spec: ArchSpec, shape: ShapeSpec, layout) -> dict:
    cfg = spec.config
    lay = production_layout(layout) if isinstance(layout, str) else layout
    train = shape.kind == "train"
    mb = cells_mod._lm_microbatches(cfg, shape, lay.dp) if train else 1
    per_mb = shape.global_batch // (mb * lay.dp) if train else 0

    def probe(n_layers: int, m: int = 1):
        pspec = dataclasses.replace(
            spec, config=dataclasses.replace(cfg, n_layers=n_layers))
        pshape = (dataclasses.replace(shape, global_batch=m * lay.dp * per_mb)
                  if train else shape)
        kw = {"microbatches": m} if train else {}
        return count_cell(cells_mod.make_cell(pspec, pshape, lay, **kw))

    L = cfg.n_layers
    tile = max(cfg.attn_q_chunk, cfg.attn_kv_chunk)
    if shape.kind == "prefill" and shape.seq_len > 3 * tile:
        return _prefill_cost(spec, shape, lay, tile)
    if mb == 1:
        (c1, _), (c2, ops) = probe(1), probe(2)
        per, base = _linear(c1, c2)
        total = base + L * per
        parts = {"per_layer": per.as_dict(), "base": base.as_dict()}
    else:
        (c12, _), (c22, ops) = probe(1, 2), probe(2, 2)
        (c13, _), (c23, _) = probe(1, 3), probe(2, 3)
        d = (c23 - c13) - (c22 - c12)
        b = (c22 - c12) - 2 * d
        c = (c13 - c12) - d
        a = c12 - b - 2 * c - 2 * d
        total = a + L * b + mb * c + (L * mb) * d
        # the peak does not grow with the microbatches (they run in turn)
        per_peak = c22.peak - c12.peak
        total.peak = c12.peak + (L - 1) * per_peak
        parts = {"fixed": a.as_dict(), "per_layer": b.as_dict(),
                 "per_microbatch": c.as_dict(),
                 "per_layer_microbatch": d.as_dict()}
    return {"total": total.as_dict(), "parts": parts,
            "trips": {"layers": L, "microbatches": mb}, "ops": ops}


def _quadratic_at(cs: list, x: int) -> Cost:
    """The FLOPs and bytes of the quadratic through costs at 1, 2, 3,
    evaluated at ``x`` (Lagrange weights: integers, so integer counts stay
    exact); the peak the line through the costs at 2 and 3 (a peak is
    not a sum, and curvature fitted to it runs away)."""
    w1 = (x - 2) * (x - 3) // 2
    w2 = -(x - 1) * (x - 3)
    w3 = (x - 1) * (x - 2) // 2
    out = cs[0] * w1 + cs[1] * w2 + cs[2] * w3
    out.peak = cs[1].peak + (x - 2) * (cs[2].peak - cs[1].peak)
    return out


def _prefill_cost(spec: ArchSpec, shape: ShapeSpec, lay, tile: int) -> dict:
    """A prefill at S = j x tile: the cost of L layers is A(S) + L B(S),
    each quadratic in j (the attention's tiles grow as j^2, the rest as
    j), probed at L in {1, 2} and j in {1, 2, 3}."""
    cfg = spec.config
    if shape.seq_len % tile:
        raise ValueError(f"prefill of {shape.seq_len} tokens: not a whole "
                         f"number of {tile}-token tiles")
    j = shape.seq_len // tile
    costs, ops = {}, None
    for n_layers in (1, 2):
        pspec = dataclasses.replace(
            spec, config=dataclasses.replace(cfg, n_layers=n_layers))
        for m in (1, 2, 3):
            pshape = dataclasses.replace(shape, seq_len=m * tile)
            costs[n_layers, m], ops = count_cell(
                cells_mod.make_cell(pspec, pshape, lay))
    c1 = _quadratic_at([costs[1, m] for m in (1, 2, 3)], j)
    c2 = _quadratic_at([costs[2, m] for m in (1, 2, 3)], j)
    per, base = _linear(c1, c2)
    total = base + cfg.n_layers * per
    return {"total": total.as_dict(),
            "parts": {"per_layer": per.as_dict(), "base": base.as_dict()},
            "trips": {"layers": cfg.n_layers, "tiles": j * j,
                      "tile_tokens": tile}, "ops": ops}


def retrieval_cell_cost(spec: ArchSpec, shape: ShapeSpec, layout) -> dict:
    """The sharded ``ell`` step: linear in the docs of a shard once they
    fill whole slabs of ``ell_gather_ref`` and at least k docs; probed at
    two such counts and extrapolated to the cell's."""
    from repro_torch.kernels.ell_gather import ref as ell_ref

    lay = production_layout(layout) if isinstance(layout, str) else layout
    cell = cells_mod.make_cell(spec, shape, lay)
    per = cell.meta["docs_per_shard"]
    b, k_slots = cell.args[2].shape[0], cell.args[0].shape[-1]
    slab = max(1, ell_ref._SLAB_ELEMS // max(b * k_slots, 1))
    j1 = -(-cell.meta["topk"] // slab)
    if per <= (j1 + 1) * slab:
        return whole_cell_cost(spec, shape, lay)

    def probe(j: int):
        pshape = dataclasses.replace(shape, num_docs=j * slab * lay.cards)
        return count_cell(cells_mod.make_cell(spec, pshape, lay))

    (c1, _), (c2, ops) = probe(j1), probe(j1 + 1)
    per_slab = c2 - c1
    total = c1 + per_slab * ((per - j1 * slab) / slab)
    return {"total": total.as_dict(),
            "parts": {"per_slab": per_slab.as_dict(),
                      "slab_docs": slab}, "trips": {"slabs": per / slab},
            "ops": ops}


def gnn_cell_cost(spec: ArchSpec, shape: ShapeSpec, layout) -> dict:
    """SchNet: the interactions repeat -> probe n_int in {1, 2}."""
    def probe(n_int: int):
        pspec = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, n_interactions=n_int))
        return count_cell(cells_mod.make_cell(pspec, shape, layout))

    (c1, _), (c2, ops) = probe(1), probe(2)
    n = spec.config.n_interactions
    per, base = _linear(c1, c2)
    total = base + n * per
    return {"total": total.as_dict(),
            "parts": {"per_interaction": per.as_dict(),
                      "base": base.as_dict()},
            "trips": {"interactions": n}, "ops": ops}


def recsys_cell_cost(spec: ArchSpec, shape: ShapeSpec, layout) -> dict:
    """DIEN: the GRU runs over the sequence -> probe seq in {2, 3, 4}.
    Quadratic, not linear as in JAX: the backward of each step's slice of
    the [B, S, ...] history writes a whole [B, S, ...] gradient.  The
    others (and DIEN's retrieval, which runs no step of the sequence) are
    counted whole."""
    cfg = spec.config
    if cfg.model != "dien" or shape.kind == "recsys_retrieval":
        return whole_cell_cost(spec, shape, layout)

    def probe(seq: int):
        pspec = dataclasses.replace(spec, config=dataclasses.replace(
            cfg, seq_len=seq))
        return count_cell(cells_mod.make_cell(pspec, shape, layout))

    (c2, _), (c3, _), (c4, ops) = probe(2), probe(3), probe(4)
    total = _quadratic_at([c2, c3, c4], cfg.seq_len - 1)
    return {"total": total.as_dict(),
            "parts": {"seq_2": c2.as_dict(), "seq_3": c3.as_dict(),
                      "seq_4": c4.as_dict()},
            "trips": {"seq": cfg.seq_len}, "ops": ops}


def whole_cell_cost(spec: ArchSpec, shape: ShapeSpec, layout) -> dict:
    total, ops = count_cell(cells_mod.make_cell(spec, shape, layout))
    return {"total": total.as_dict(), "parts": {}, "trips": {}, "ops": ops}


_BY_FAMILY = {"lm": lm_cell_cost, "gnn": gnn_cell_cost,
              "recsys": recsys_cell_cost, "retrieval": retrieval_cell_cost}


def spec_cost(spec: ArchSpec, shape: ShapeSpec, layout="single") -> dict:
    """The counted cost of one rank's step of a cell -> ``{"total":
    {flops, bytes, peak_bytes}, "parts", "trips", "ops": aten op
    histogram, "notes"}``."""
    out = _BY_FAMILY[spec.family](spec, shape, layout)
    out["notes"] = NOTES
    return out


def cell_cost(arch_id: str, shape_name: str, layout="single") -> dict:
    spec = get_arch(arch_id)
    return spec_cost(spec, cells_mod.shape_of(spec, shape_name), layout)
