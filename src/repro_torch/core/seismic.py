"""Seismic-like approximate CPU retrieval baseline [Bruch+ SIGIR'24].

The paper measures Seismic (geometric blocking + ``query_cut`` query-term
pruning) losing ~25% Recall@1000 against exact scoring on SPLADE data.
This is the mechanism of :mod:`repro.core.seismic`, copied (a host
algorithm, no ``device``), so the exact-vs-approximate trade-off is
reproducible beside the port's exact engines:

  * each term's posting list is partitioned into fixed-size blocks of
    value-sorted (impact-ordered) postings — the static analogue of
    Seismic's k-means geometric blocks;
  * per-block *summaries* keep the block's max contribution, enabling
    block-level pruning against a heap threshold (``heap_factor``);
  * only the top-``query_cut`` query terms by weight are traversed at all —
    the approximation knob the paper sweeps (cut in {5,10,20,50}).

Exactness is intentionally NOT guaranteed — that is the point of the
baseline.  The stable orders (impact sort, ``query_cut``) and the
``(-score, doc)`` ranking are JAX's, so the ids and values equal the JAX
package's.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.sparse import SparseBatch
from repro_torch.core.wand import _host_postings, _host_queries, _term_runs


@dataclasses.dataclass
class SeismicIndex:
    # term -> list of blocks; each block = (doc_ids, values, summary_max)
    blocks: dict[int, list[tuple[np.ndarray, np.ndarray, float]]]
    num_docs: int
    block_size: int

    @classmethod
    def build(cls, docs: SparseBatch, block_size: int = 128) -> "SeismicIndex":
        """JAX's build, vectorised: each term's postings impact-ordered by
        a stable sort on -value, ties kept in doc order (JAX's
        ``plist.sort(key=-v)`` over postings appended doc-major)."""
        terms, doc, vals = _host_postings(docs)
        order = np.lexsort((-vals, terms))
        terms, doc, vals = terms[order], doc[order], vals[order]
        blocks: dict[int, list[tuple[np.ndarray, np.ndarray, float]]] = {}
        for t, s, e in _term_runs(terms):
            blist = []
            for b in range(s, e, block_size):
                dids = doc[b:min(b + block_size, e)]
                bvals = vals[b:min(b + block_size, e)]
                blist.append((dids, bvals, float(bvals.max())))
            blocks[t] = blist
        return cls(blocks, docs.batch, block_size)


def seismic_topk_cpu(
    queries: SparseBatch,
    index: SeismicIndex,
    k: int,
    query_cut: int = 5,
    heap_factor: float = 0.8,
) -> tuple[np.ndarray, np.ndarray]:
    """Approximate top-k: query-term cut + summary-pruned block traversal."""
    b = queries.batch
    q_ids, q_vals = _host_queries(queries)
    out_v = np.zeros((b, k))
    out_i = np.full((b, k), -1, dtype=np.int64)
    for qi in range(b):
        ids = q_ids[qi]
        vals = q_vals[qi]
        valid = ids >= 0
        ids, vals = ids[valid], vals[valid]
        # --- query_cut: keep only the heaviest query terms ---
        if len(ids) > query_cut:
            keep = np.argsort(-vals, kind="stable")[:query_cut]
            ids, vals = ids[keep], vals[keep]

        acc: dict[int, float] = {}
        heap: list[float] = []
        threshold = 0.0
        for t, w in sorted(zip(ids.tolist(), vals.tolist()), key=lambda x: -x[1]):
            for dids, dvals, smax in index.blocks.get(int(t), []):
                # summary pruning: skip blocks that cannot move the heap
                if len(heap) >= k and w * smax < heap_factor * threshold:
                    break  # impact-ordered => all later blocks are smaller
                for d, v in zip(dids.tolist(), dvals.tolist()):
                    s = acc.get(d, 0.0) + w * v
                    acc[d] = s
            # maintain a loose threshold from current partial scores
            if acc:
                top = heapq.nlargest(min(k, len(acc)), acc.values())
                heap = top
                threshold = top[-1] if len(top) == k else 0.0

        ranked = sorted(acc.items(), key=lambda dv: (-dv[1], dv[0]))[:k]
        for j, (d, s) in enumerate(ranked):
            out_v[qi, j] = s
            out_i[qi, j] = d
    return out_v, out_i
