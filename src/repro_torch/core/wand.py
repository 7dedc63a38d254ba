"""CPU exact top-k baselines: WAND [Broder+03] and Block-Max WAND [Ding&Suel11].

The paper's CPU ground truth is Lucene's impact-ordered exact traversal;
these are the canonical WAND and BMW algorithms (numpy/heapq,
single-threaded), copied from :mod:`repro.core.wand`: the same Python
float arithmetic on the same f32 inputs, so the ids and values equal the
JAX package's.  They are host algorithms by nature, not a fallback of a
device path, and take no ``device``: a batch on any device is read once
to the host.  The pivot loop is a data-dependent while loop over sorted
iterator state, the "inherently sequential" selection of the paper's
§2.2.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.sparse import SparseBatch, to_numpy_rows


def _host_postings(docs: SparseBatch):
    """(term int64, doc int64, value float64) of every posting, doc-major
    in slot order: the order JAX appends them in (one D2H copy)."""
    ids_rows, val_rows = to_numpy_rows(docs)
    lens = np.fromiter((len(r) for r in ids_rows), np.int64,
                       count=len(ids_rows))
    doc = np.repeat(np.arange(len(ids_rows), dtype=np.int64), lens)
    if not len(ids_rows):
        return doc, doc, doc.astype(np.float64)
    terms = np.concatenate(ids_rows).astype(np.int64)
    vals = np.concatenate(val_rows).astype(np.float64)
    return terms, doc, vals


def _term_runs(terms_sorted: np.ndarray):
    """(term, start, end) of each run of equal terms in a sorted array."""
    if not len(terms_sorted):
        return
    cut = np.nonzero(np.diff(terms_sorted))[0] + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(terms_sorted)]])
    for s, e in zip(starts.tolist(), ends.tolist()):
        yield int(terms_sorted[s]), s, e


@dataclasses.dataclass
class CpuPostings:
    """Term -> (sorted doc ids, values) CPU inverted index."""

    postings: dict[int, tuple[np.ndarray, np.ndarray]]
    max_score: dict[int, float]
    num_docs: int
    # Block-max metadata (BMW): per-term block boundaries + per-block maxima.
    block_size: int = 64
    block_max: dict[int, np.ndarray] | None = None

    @classmethod
    def build(cls, docs: SparseBatch, block_size: int = 64) -> "CpuPostings":
        """JAX's build, vectorised: each term's postings sorted by (doc,
        value), as JAX's ``plist.sort()`` of (doc, value) tuples orders
        them."""
        terms, doc, vals = _host_postings(docs)
        order = np.lexsort((vals, doc, terms))
        terms, doc, vals = terms[order], doc[order], vals[order]
        postings = {}
        max_score = {}
        block_max = {}
        for t, s, e in _term_runs(terms):
            dids, v = doc[s:e], vals[s:e]
            postings[t] = (dids, v)
            max_score[t] = float(v.max())
            block_max[t] = np.maximum.reduceat(
                v, np.arange(0, e - s, block_size))
        return cls(postings, max_score, docs.batch, block_size, block_max)


def _host_queries(queries: SparseBatch) -> tuple[np.ndarray, np.ndarray]:
    return queries.term_ids.cpu().numpy(), queries.values.cpu().numpy()


def _query_terms(ids: np.ndarray, vals: np.ndarray) -> list[tuple[int, float]]:
    return [(int(t), float(w)) for t, w in zip(ids, vals) if t >= 0 and w > 0]


def exhaustive_topk_cpu(
    queries: SparseBatch, index: CpuPostings, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Term-at-a-time exhaustive exact scoring (the safe oracle)."""
    b = queries.batch
    q_ids, q_vals = _host_queries(queries)
    out_v = np.zeros((b, k))
    out_i = np.full((b, k), -1, dtype=np.int64)
    for qi in range(b):
        acc = np.zeros(index.num_docs)
        for t, w in _query_terms(q_ids[qi], q_vals[qi]):
            if t in index.postings:
                dids, vals = index.postings[t]
                acc[dids] += w * vals
        kk = min(k, index.num_docs)
        part = np.argpartition(-acc, kk - 1)[:kk]
        order = part[np.argsort(-acc[part], kind="stable")]
        out_v[qi, :kk] = acc[order]
        out_i[qi, :kk] = order
    return out_v, out_i


class _TermIterator:
    __slots__ = ("dids", "vals", "pos", "weight", "ub", "block_max", "block_size")

    def __init__(self, dids, vals, weight, ub, block_max, block_size):
        self.dids, self.vals = dids, vals
        self.pos = 0
        self.weight = weight
        self.ub = ub  # weight * term max score
        self.block_max = block_max
        self.block_size = block_size

    def cur_doc(self) -> int:
        return int(self.dids[self.pos]) if self.pos < len(self.dids) else 1 << 60

    def cur_score(self) -> float:
        return self.weight * float(self.vals[self.pos])

    def advance_to(self, target: int) -> None:
        # galloping seek to first doc >= target
        self.pos += int(np.searchsorted(self.dids[self.pos :], target))

    def next(self) -> None:
        self.pos += 1

    def cur_block_ub(self) -> float:
        if self.pos >= len(self.dids):
            return 0.0
        return self.weight * float(self.block_max[self.pos // self.block_size])

    def block_ub_at(self, target: int) -> float:
        """Shallow block pointer: UB of the block holding the first posting
        >= ``target`` (BMW's block-max refinement — safe because if
        ``target`` appears in this list it lives in exactly that block)."""
        p = self.pos + int(np.searchsorted(self.dids[self.pos :], target))
        if p >= len(self.dids):
            return 0.0
        if int(self.dids[p]) != target:
            return 0.0  # target absent from this list -> contributes 0
        return self.weight * float(self.block_max[p // self.block_size])


def wand_topk_cpu(
    queries: SparseBatch,
    index: CpuPostings,
    k: int,
    block_max: bool = False,
    theta: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """WAND (``block_max=False``) / Block-Max WAND (``True``) exact top-k.

    ``theta`` is the threshold over-scaling factor; 1.0 keeps the safe
    (exact) guarantee.  The pivot-selection loop below is the sequential
    bottleneck the paper's scatter-add sidesteps.
    """
    b = queries.batch
    q_ids, q_vals = _host_queries(queries)
    out_v = np.zeros((b, k))
    out_i = np.full((b, k), -1, dtype=np.int64)

    for qi in range(b):
        iters: list[_TermIterator] = []
        for t, w in _query_terms(q_ids[qi], q_vals[qi]):
            if t in index.postings:
                dids, vals = index.postings[t]
                iters.append(
                    _TermIterator(
                        dids, vals, w, w * index.max_score[t],
                        index.block_max[t], index.block_size,
                    )
                )
        heap: list[tuple[float, int]] = []  # (score, doc) min-heap
        threshold = 0.0

        while True:
            iters = [it for it in iters if it.cur_doc() < (1 << 60)]
            if not iters:
                break
            iters.sort(key=lambda it: it.cur_doc())
            # --- pivot selection (sequential, data-dependent) ---
            acc_ub = 0.0
            pivot = -1
            for i, it in enumerate(iters):
                acc_ub += it.ub
                if acc_ub > threshold * theta:
                    pivot = i
                    break
            if pivot < 0:
                break  # no document can beat the threshold
            pivot_doc = iters[pivot].cur_doc()

            if block_max and len(heap) == k:
                # Refine with block maxima at the pivot document: skip the
                # pivot entirely if even the block-level UB cannot beat the
                # current threshold.  The sum must run over EVERY list that
                # may still contain pivot_doc (lists beyond the pivot index
                # can tie on cur_doc); block_ub_at returns 0 for lists that
                # cannot contribute.
                block_ub = sum(it.block_ub_at(pivot_doc) for it in iters)
                if block_ub <= threshold * theta:
                    iters[0].advance_to(pivot_doc + 1)
                    continue

            if iters[0].cur_doc() == pivot_doc:
                # fully aligned: score pivot_doc exactly
                score = 0.0
                for it in iters:
                    if it.cur_doc() == pivot_doc:
                        score += it.cur_score()
                for it in iters:
                    if it.cur_doc() == pivot_doc:
                        it.next()
                if len(heap) < k:
                    heapq.heappush(heap, (score, -pivot_doc))
                    if len(heap) == k:
                        threshold = heap[0][0]
                elif score > heap[0][0]:
                    heapq.heapreplace(heap, (score, -pivot_doc))
                    threshold = heap[0][0]
            else:
                # advance a leading iterator up to the pivot document
                iters[0].advance_to(pivot_doc)

        ranked = sorted(heap, key=lambda sv: (-sv[0], -sv[1]))
        for j, (s, negd) in enumerate(ranked[:k]):
            out_v[qi, j] = s
            out_i[qi, j] = -negd
    return out_v, out_i
