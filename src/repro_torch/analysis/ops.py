"""Op histograms and collective bytes of a cell (the counterpart of
``repro.analysis.hlo``, which reads XLA's HLO text; the port has none).

:func:`op_histogram` ranks the aten ops the ``meta`` count saw
(``probes.CostMode``) or, on the card, the kernels ``torch.profiler``
timed.  :func:`collective_bytes` reckons the payload of the collectives
the port's step issues on one rank, as JAX sums the output bytes of each
collective in the HLO: on ``"quad"``, a training step's one SUM
all-reduce of the f32 gradient buffer (``make_ddp_train_step``'s
``_pmean``, then the loss's), and a serving step's gather of the [S, B,
k] values and ids (``topk.gather_shards``).  On ``"single"`` no
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


def _param_bytes(params: dict) -> int:
    return sum(p.numel() * 4 for p in params.values())  # f32 gradients


def collective_bytes(cell) -> CollectiveStats:
    """The bytes one rank's step moves through collectives, by kind."""
    by_kind, counts = {}, {}
    if cell.layout != "single":
        s = _cards(cell.layout)
        kind = cell.meta.get("kind")
        if kind == "train":
            state = cell.args[0]
            by_kind["all-reduce"] = _param_bytes(state["params"]) + 4
            counts["all-reduce"] = 2  # gradients, then the loss
        elif kind in ("retrieval", "retrieval_serve"):
            b = _rows(cell)
            k = int(cell.meta["topk"])
            id_bytes = 8 if kind == "retrieval" else 4
            by_kind["all-gather"] = s * b * k * (4 + id_bytes)
            counts["all-gather"] = 2  # values, ids
    return CollectiveStats(sum(by_kind.values()), by_kind, counts)


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
