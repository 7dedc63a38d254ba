"""Op histograms and collective bytes of a cell (the counterpart of
``repro.analysis.hlo``, which reads XLA's HLO text; the port has none).

:func:`op_histogram` ranks the aten ops the ``meta`` count saw
(``probes.CostMode``) or, on the card, the kernels ``torch.profiler``
timed.  :func:`collective_bytes` reckons the payload of the collectives
the port's step issues on one rank, as JAX sums the output bytes of each
collective in the HLO.  A serving step on ``"quad"`` gathers the [S, B,
k] values and ids (``topk.gather_shards``).  The collectives of
``sharding.ctx`` the ``meta`` count records as it runs the step
(``probes.count``; extrapolated over layers and microbatches as the
FLOPs are), forward and backward, a remat's re-issued forward included.
At ``"quad_tp"`` a serving step's: per layer the f32 SUM all-reduce of
the attention's and of the MLP's or experts' [tokens, D] output, the
embedding's all-reduce and the logits' all-gather over the model axis
(of [tokens, V]), the decode combine of a sequence-split cache (a MAX
and a SUM all-reduce a layer), the gathers of split heads' weights,
FSDP's all-gather of each layer's weights over the data axis, and a
row-sharded table's id gather and bag all-reduce.  A training step's on
``"quad"`` and ``"quad_tp"`` (``make_sharded_train_step``): those of the
forward, the backward's transposes (FSDP's gathers reduce-scatter the
weights' gradients, a split input's gradient is all-reduced, a
sequence-parallel exit's all-gathered), the loss's all-reduces, one SUM
all-reduce of the partial gradients a set of axes, and the clipping
norm's all-reduces; :func:`collective_bytes` adds them (and counts a
training cell's step itself when no count is given).  On ``"single"`` no
collective runs: 0.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int
    by_kind: dict
    counts: dict

    def __str__(self) -> str:
        parts = [f"{k}: {v / 1e6:.1f}MB x{self.counts[k]}"
                 for k, v in sorted(self.by_kind.items())]
        return (f"collectives total {self.total_bytes / 1e6:.1f}MB "
                f"({'; '.join(parts)})")


def op_histogram(counts, top: int = 12) -> list[tuple[str, int]]:
    """The ``top`` most frequent names of a ``Counter`` (aten ops) or of
    ``torch.profiler`` key averages (kernel names by call count)."""
    if hasattr(counts, "most_common"):
        return [(k, int(v)) for k, v in counts.most_common(top)]
    rows = sorted(((e.key, int(e.count)) for e in counts),
                  key=lambda kv: -kv[1])
    return rows[:top]


def collective_bytes(cell, counted: dict = None) -> CollectiveStats:
    """The bytes one rank's step moves through collectives, by kind; with
    ``counted`` (a count's ``{kind: [bytes, calls]}``) the sharded paths'
    collectives added.  A training cell with no ``counted`` runs its step
    once under ``ctx.recording`` (on ``meta``, where it moves nothing)."""
    if counted is None and cell.meta.get("kind") == "train":
        from repro_torch.sharding import ctx

        with ctx.recording() as counted:
            cell.step_fn(*cell.args)
    by_kind, counts = {}, {}
    for name, (nbytes, calls) in (counted or {}).items():
        if calls:
            by_kind[name] = int(round(nbytes))
            counts[name] = int(round(calls))
    kind = cell.meta.get("kind")
    if cell.layout != "single" and kind in ("retrieval", "retrieval_serve"):
        s = _cards(cell.layout)
        b = _rows(cell)
        k = int(cell.meta["topk"])
        id_bytes = 8 if kind == "retrieval" else 4
        _add(by_kind, counts, "all-gather",
             s * b * k * (4 + id_bytes), 2)  # values, ids
    return CollectiveStats(sum(by_kind.values()), by_kind, counts)


def _add(by_kind: dict, counts: dict, kind: str, nbytes: int,
         calls: int) -> None:
    by_kind[kind] = by_kind.get(kind, 0) + nbytes
    counts[kind] = counts.get(kind, 0) + calls


def _cards(layout: str) -> int:
    from repro_torch.launch.mesh import production_layout

    return production_layout(layout).cards


def _rows(cell) -> int:
    """The query rows of a serving cell (B of its [B, k] top-k)."""
    if cell.meta["kind"] == "retrieval_serve":
        return int(cell.args[2].shape[0])  # qw [B, V]
    user = cell.args[1]
    return int(next(t for t in user.values()
                    if isinstance(t, torch.Tensor)).shape[0])
