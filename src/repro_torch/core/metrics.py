"""IR quality metrics: MRR@k, nDCG@k, Recall@k, top-k ranking overlap.

A copy of :mod:`repro.core.metrics` (numpy, host-side): ranked ids come
back from :meth:`repro_torch.core.engine.RetrievalEngine.search` as numpy.
"""
from __future__ import annotations

import numpy as np


def mrr_at_k(ranked_ids: np.ndarray, qrels: list[set[int]], k: int = 10) -> float:
    """Mean reciprocal rank of the first relevant doc within top-k."""
    rr = []
    for qi, rel in enumerate(qrels):
        r = 0.0
        for rank, d in enumerate(ranked_ids[qi][:k]):
            if int(d) in rel:
                r = 1.0 / (rank + 1)
                break
        rr.append(r)
    return float(np.mean(rr)) if rr else 0.0


def recall_at_k(ranked_ids: np.ndarray, qrels: list[set[int]], k: int = 1000) -> float:
    rec = []
    for qi, rel in enumerate(qrels):
        if not rel:
            continue
        hits = sum(1 for d in ranked_ids[qi][:k] if int(d) in rel)
        rec.append(hits / len(rel))
    return float(np.mean(rec)) if rec else 0.0


def ndcg_at_k(
    ranked_ids: np.ndarray,
    qrels: list[dict[int, float] | set[int]],
    k: int = 10,
) -> float:
    """nDCG@k; ``qrels`` may be graded (dict doc->gain) or binary (set)."""
    scores = []
    for qi, rel in enumerate(qrels):
        gains = rel if isinstance(rel, dict) else {d: 1.0 for d in rel}
        if not gains:
            continue
        dcg = 0.0
        for rank, d in enumerate(ranked_ids[qi][:k]):
            g = gains.get(int(d), 0.0)
            if g:
                dcg += (2**g - 1) / np.log2(rank + 2)
        ideal = sorted(gains.values(), reverse=True)[:k]
        idcg = sum((2**g - 1) / np.log2(r + 2) for r, g in enumerate(ideal))
        scores.append(dcg / idcg if idcg > 0 else 0.0)
    return float(np.mean(scores)) if scores else 0.0


def ranking_overlap(ids_a: np.ndarray, ids_b: np.ndarray, k: int) -> float:
    """Mean |top-k(A) ∩ top-k(B)| / k — the paper's "ranking agreement"
    (Recall@k of one system against another as ground truth)."""
    ov = []
    for qi in range(ids_a.shape[0]):
        sa = {int(d) for d in ids_a[qi][:k] if int(d) >= 0}
        sb = {int(d) for d in ids_b[qi][:k] if int(d) >= 0}
        denom = min(k, len(sb)) or 1
        ov.append(len(sa & sb) / denom)
    return float(np.mean(ov)) if ov else 0.0


def recall_vs_ids(
    candidate_ids: np.ndarray, reference_ids: np.ndarray, k: int
) -> float:
    """Mean fraction of the reference top-k retrieved by the candidate.

    The theta-mode quality metric: ``reference_ids`` is the exact top-k,
    ``candidate_ids`` the approximate one; negative ids (pruned / padded
    slots) count as not retrieved on the candidate side and are ignored on
    the reference side.  Equals 1.0 iff every exact top-k doc survived."""
    rec = []
    for qi in range(reference_ids.shape[0]):
        ref = {int(d) for d in reference_ids[qi][:k] if int(d) >= 0}
        if not ref:
            continue
        cand = {int(d) for d in candidate_ids[qi][:k] if int(d) >= 0}
        rec.append(len(cand & ref) / len(ref))
    return float(np.mean(rec)) if rec else 0.0


def recall_vs_oracle(
    candidate_scores: np.ndarray, oracle_scores: np.ndarray, k: int
) -> float:
    """Recall@k of candidate ranking against an oracle score matrix.

    Implements the paper's Table 10 check (GPU kernel vs CPU dense matmul).
    """
    ca = np.argsort(-candidate_scores, axis=-1, kind="stable")[:, :k]
    oa = np.argsort(-oracle_scores, axis=-1, kind="stable")[:, :k]
    return ranking_overlap(ca, oa, k)
