"""Synthetic corpora with the paper's published SPLADE statistics, on device.

The same laws as :mod:`repro.data.synthetic` (vocab 30,522; ~127.2 nnz/doc,
sigma 34.3; ~49.9 nnz/query, sigma 18.2; log1p-ReLU-shaped weights in
[0.01, 3.5]; Zipf(1.07) term popularity; queries seeded from a "relevant"
document plus Zipf expansion terms; and the topical corpus of
:func:`make_topical_corpus`), drawn from an explicit ``torch.Generator`` on
the target device and vectorised over documents.  :func:`make_lm_batch`,
:func:`make_recsys_batch`, :func:`make_graph` and :func:`sample_neighbors`
are the JAX LM and recsys batches, graphs and sampled subgraphs, drawn with
numpy as there (numpy arrays: callers move them to a device).

Sampling ``k`` distinct terms with probabilities ``p`` — numpy's
successive sampling without replacement — is drawn here as Gumbel-top-k:
the ``k`` largest of ``log p_i + G_i`` with ``G_i`` i.i.d. Gumbel(0, 1).
The two have the same law; they do not give the same numbers, so tests
that compare the two packages hand both the numpy corpus.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sparse import PAD_ID, SparseBatch
from repro_torch.utils import resolve_device

MSMARCO_VOCAB = 30522
DOC_TERMS_MEAN, DOC_TERMS_STD = 127.2, 34.3
QUERY_TERMS_MEAN, QUERY_TERMS_STD = 49.9, 18.2

# Rows of [rows, vocab] Gumbel keys drawn at once: bounds the sampler's
# scratch to 2^27 floats (512 MB) whatever the corpus size.
_KEY_ELEMS = 1 << 27
# Rows of a corpus masked, sorted and packed at once: bounds that scratch
# (the sort's int64 indices among it) to 2^26 slots.
_PACK_ELEMS = 1 << 26


@dataclasses.dataclass
class SyntheticCorpus:
    docs: SparseBatch
    queries: SparseBatch
    qrels: list[set[int]]
    vocab_size: int


def _zipf_log_probs(vocab: int, alpha: float, device) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks ** -alpha
    return torch.log(p / p.sum()).to(torch.float32)


def _gumbel_top(logp: torch.Tensor, rows: int, k: int,
                g: torch.Generator, dtype=torch.int64) -> torch.Tensor:
    """[rows, k] distinct term ids per row, in descending key order: the
    first ``j`` of a row are a sample of ``j`` terms without replacement."""
    vocab = logp.shape[0]
    out = torch.empty((rows, k), dtype=dtype, device=logp.device)
    step = max(1, _KEY_ELEMS // max(vocab, 1))
    for s in range(0, rows, step):
        n = min(step, rows - s)
        e = torch.empty((n, vocab), device=logp.device).exponential_(
            generator=g
        )
        keys = logp - torch.log(e)  # -log(Exp(1)) is Gumbel(0, 1)
        out[s:s + n] = torch.topk(keys, k, dim=1).indices
    return out


def _log1p_abs_normal(shape, mean: float, std: float,
                      g: torch.Generator, device) -> torch.Tensor:
    z = torch.randn(shape, generator=g, device=device) * std + mean
    return torch.log1p(z.abs()).clamp(0.01, 3.5)


def _pack_rows(ids: torch.Tensor, vals: torch.Tensor, vocab: int,
               cut: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row by term id with the sentinel ``vocab`` last, cut to
    the widest row (unless ``cut`` is False), and mark the sentinels as
    padding."""
    ids, order = torch.sort(ids, dim=1)
    vals = vals.gather(1, order)
    if cut:
        width = max(int((ids < vocab).sum(dim=1).max())
                    if ids.numel() else 1, 1)
        ids, vals = ids[:, :width], vals[:, :width]
    pad = ids >= vocab
    return (torch.where(pad, PAD_ID, ids).to(torch.int32),
            torch.where(pad, 0.0, vals).to(torch.float32))


def make_corpus(
    num_docs: int,
    vocab_size: int = MSMARCO_VOCAB,
    seed: int = 0,
    doc_terms: tuple[float, float] = (DOC_TERMS_MEAN, DOC_TERMS_STD),
    zipf_alpha: float = 1.07,
    device="cuda",
    min_terms: int = 4,
) -> SparseBatch:
    """``num_docs`` documents of the MS MARCO/SPLADE laws, on ``device``.

    The draws are whole-corpus (lengths, then every row's terms, then
    every weight), so a seed gives the same documents at any size; the
    ids are held as int32 and the rows are masked, sorted and packed in
    place, ``_PACK_ELEMS`` slots at a time, so the corpus plus a bounded
    scratch is all the memory it takes (serve_8m: 2 x 11 GB)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    lengths = (torch.randn(num_docs, generator=g, device=dev) * doc_terms[1]
               + doc_terms[0]).round().clamp(min_terms, vocab_size).long()
    kmax = int(lengths.max()) if num_docs else 1
    logp = _zipf_log_probs(vocab_size, zipf_alpha, dev)
    ids = _gumbel_top(logp, num_docs, kmax, g, dtype=torch.int32)
    # _log1p_abs_normal's arithmetic, in place.
    vals = torch.randn((num_docs, kmax), generator=g, device=dev)
    vals.mul_(1.2).add_(1.0).abs_().log1p_().clamp_(0.01, 3.5)
    # The longest row is kmax live slots long: no column is cut.
    slots = torch.arange(kmax, device=dev)[None, :]
    step = max(1, _PACK_ELEMS // kmax)
    for s in range(0, num_docs, step):
        rows = slice(s, s + step)
        ids[rows].masked_fill_(slots >= lengths[rows, None], vocab_size)
        ids[rows], vals[rows] = _pack_rows(ids[rows], vals[rows], vocab_size,
                                           cut=False)
    return SparseBatch(ids, vals, vocab_size)


def make_queries_with_qrels(
    docs: SparseBatch,
    num_queries: int,
    seed: int = 1,
    query_terms: tuple[float, float] = (QUERY_TERMS_MEAN, QUERY_TERMS_STD),
    overlap_frac: float = 0.6,
    device="cuda",
) -> tuple[SparseBatch, list[set[int]]]:
    """Queries seeded from relevant docs: ``overlap_frac`` of terms copied
    from the relevant document (weights jittered by U(0.7, 1.3)), the rest
    Zipf expansion terms; an expansion term the query already holds is
    dropped, as in :func:`repro.data.synthetic.make_queries_with_qrels`."""
    dev = resolve_device(device)
    docs = docs.to(dev)
    v = docs.vocab_size
    g = torch.Generator(device=dev).manual_seed(seed)
    rel = torch.randint(docs.batch, (num_queries,), generator=g, device=dev)
    d_ids = docs.term_ids[rel].long()
    d_vals = docs.values[rel]
    d_live = d_ids >= 0
    k = (torch.randn(num_queries, generator=g, device=dev) * query_terms[1]
         + query_terms[0]).clamp(3, v).floor().long()
    k_overlap = torch.minimum((k * overlap_frac).floor().long(),
                              d_live.sum(dim=1))
    n_extra = (k - k_overlap).clamp(min=0)

    # Copied terms: a uniform draw of k_overlap of the doc's live slots.
    width = d_ids.shape[1]
    keys = torch.rand((num_queries, width), generator=g, device=dev)
    pick = torch.topk(torch.where(d_live, keys, -1.0), width, dim=1).indices
    ranks = torch.arange(width, device=dev)[None, :]
    keep = ranks < k_overlap[:, None]
    p_ids = torch.where(keep, d_ids.gather(1, pick), v)
    jitter = torch.rand((num_queries, width), generator=g, device=dev)
    p_vals = d_vals.gather(1, pick) * (0.7 + 0.6 * jitter)

    # Expansion terms: Zipf draws without replacement.
    e_max = max(int(n_extra.max()) if num_queries else 0, 1)
    e_ids = _gumbel_top(_zipf_log_probs(v, 1.07, dev), num_queries, e_max, g)
    e_ids = torch.where(
        torch.arange(e_max, device=dev)[None, :] < n_extra[:, None], e_ids, v
    )
    e_vals = _log1p_abs_normal((num_queries, e_max), 0.6, 0.8, g, dev)

    # Drop expansion terms the copied terms already hold: sort by
    # (id, source) so a duplicate id's copied entry comes first.
    ids = torch.cat([p_ids, e_ids], dim=1)
    vals = torch.cat([p_vals, e_vals], dim=1)
    src = torch.cat([torch.zeros_like(p_ids), torch.ones_like(e_ids)], dim=1)
    order = torch.argsort(ids * 2 + src, dim=1)
    ids, vals = ids.gather(1, order), vals.gather(1, order)
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    ids = torch.where(dup, v, ids)
    q_ids, q_vals = _pack_rows(ids, vals, v)
    qrels = [{int(r)} for r in rel.cpu().tolist()]
    return SparseBatch(q_ids, q_vals, v), qrels


def make_msmarco_like(
    num_docs: int,
    num_queries: int,
    vocab_size: int = MSMARCO_VOCAB,
    seed: int = 0,
    device="cuda",
) -> SyntheticCorpus:
    docs = make_corpus(num_docs, vocab_size, seed=seed, device=device)
    queries, qrels = make_queries_with_qrels(docs, num_queries,
                                             seed=seed + 1, device=device)
    return SyntheticCorpus(docs, queries, qrels, vocab_size)


def make_topical_corpus(
    num_docs: int,
    num_queries: int,
    vocab_size: int = MSMARCO_VOCAB,
    num_topics: int = 40,
    seed: int = 0,
    doc_terms: tuple[float, float] = (DOC_TERMS_MEAN, DOC_TERMS_STD),
    query_terms: int = 40,
    shared_frac: float = 0.3,
    shared_vocab_frac: float = 0.03,
    topic_vocab: int = 1200,
    device="cuda",
) -> SyntheticCorpus:
    """Topically clustered corpus with IDF-correlated weights, the laws of
    :func:`repro.data.synthetic.make_topical_corpus`.

    Each document picks a topic uniformly and ``clip(N(mean, std), 8, V)``
    terms: ``shared_frac`` of them from a Zipf-weighted shared head (the
    first ``max(int(V * shared_vocab_frac), 16)`` ids) at stopword-grade
    weights U(0.05, 0.4), the rest uniformly from its topic's pool of
    ``topic_vocab`` ids at ``clip(log1p|N(1, 1.2)|, 0.05, 3.5)``.  A query
    copies up to ``query_terms`` terms of a uniformly drawn relevant
    document, weights jittered by U(0.7, 1.3).  Documents come in shuffled
    topic order: index-side reordering (``reorder_docs``) has to recover
    the clusters.
    """
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    v = vocab_size
    shared = max(int(v * shared_vocab_frac), 16)
    n_pool = min(topic_vocab, v - shared)
    pools = shared + _gumbel_top(torch.zeros(v - shared, device=dev),
                                 num_topics, n_pool, g)  # [T, n_pool]
    topics = torch.randint(num_topics, (num_docs,), generator=g, device=dev)
    k = (torch.randn(num_docs, generator=g, device=dev, dtype=torch.float64)
         * doc_terms[1] + doc_terms[0]).clamp(8, v).long()
    k_shared = (k.double() * shared_frac).long()
    n_sh = k_shared.clamp(max=shared)
    n_tp = (k - k_shared).clamp(max=n_pool)

    sh_max = max(int(n_sh.max()) if num_docs else 0, 1)
    sh = _gumbel_top(_zipf_log_probs(shared, 1.07, dev), num_docs, sh_max, g)
    sh = torch.where(torch.arange(sh_max, device=dev)[None, :]
                     < n_sh[:, None], sh, v)
    tp_max = max(int(n_tp.max()) if num_docs else 0, 1)
    slots = _gumbel_top(torch.zeros(n_pool, device=dev), num_docs, tp_max, g)
    tp = pools[topics[:, None], slots]
    tp = torch.where(torch.arange(tp_max, device=dev)[None, :]
                     < n_tp[:, None], tp, v)
    ids = torch.cat([sh, tp], dim=1)
    stop_w = 0.05 + 0.35 * torch.rand(ids.shape, generator=g, device=dev)
    z = torch.randn(ids.shape, generator=g, device=dev) * 1.2 + 1.0
    topic_w = torch.log1p(z.abs()).clamp(0.05, 3.5)
    vals = torch.where(ids < shared, stop_w, topic_w)
    d_ids, d_vals = _pack_rows(ids, vals, v)
    docs = SparseBatch(d_ids, d_vals, v)

    rel = torch.randint(num_docs, (num_queries,), generator=g, device=dev)
    q_ids = d_ids[rel].long()
    q_live = q_ids >= 0
    width = q_ids.shape[1]
    keys = torch.rand((num_queries, width), generator=g, device=dev)
    pick = torch.topk(torch.where(q_live, keys, -1.0), width, dim=1).indices
    n_pick = q_live.sum(dim=1).clamp(max=query_terms)
    keep = torch.arange(width, device=dev)[None, :] < n_pick[:, None]
    jitter = 0.7 + 0.6 * torch.rand((num_queries, width), generator=g,
                                    device=dev)
    p_ids = torch.where(keep, q_ids.gather(1, pick), v)
    p_vals = d_vals[rel].gather(1, pick) * jitter
    q_ids, q_vals = _pack_rows(p_ids, p_vals, v)
    qrels = [{int(r)} for r in rel.cpu().tolist()]
    return SyntheticCorpus(docs, SparseBatch(q_ids, q_vals, v), qrels, v)


def make_lm_batch(batch: int, seq_len: int, vocab_size: int,
                  seed: int = 0) -> dict:
    """An LM batch as numpy arrays, the very numbers of ``repro.data.
    synthetic.make_lm_batch`` for one seed: int32 ``tokens`` [B, S] uniform
    over the vocabulary, ``targets`` (tokens shifted left by one, wrapping)
    and an all-ones f32 ``loss_mask``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab_size, size=(batch, seq_len),
                          dtype=np.int32)
    return {
        "tokens": tokens,
        "targets": np.roll(tokens, -1, axis=1),
        "loss_mask": np.ones((batch, seq_len), dtype=np.float32),
    }


def make_recsys_batch(batch: int, n_sparse: int, vocab_sizes,
                      seq_len: int = 0, item_vocab: int = 0,
                      multi_hot: int = 1, seed: int = 0) -> dict:
    """A Criteo/Amazon-style click batch as numpy arrays, the very numbers
    of ``repro.data.synthetic.make_recsys_batch`` for one seed: int32
    ``sparse_ids`` [B, F, H] (H = ``multi_hot``, each field uniform over its
    vocabulary, never padded), with ``seq_len`` and ``item_vocab`` also
    int32 ``hist_ids`` [B, S], an f32 ``hist_mask`` [B, S] (a prefix of
    1 to S valid steps) and int32 ``target_id`` [B]; and an f32 0/1
    ``label`` [B].  ``n_sparse`` is not read, as in JAX: the fields are
    ``vocab_sizes``."""
    rng = np.random.default_rng(seed)
    out = {}
    ids = np.stack(
        [rng.integers(0, vs, size=(batch, multi_hot)) for vs in vocab_sizes],
        axis=1,
    ).astype(np.int32)
    out["sparse_ids"] = ids
    if seq_len and item_vocab:
        out["hist_ids"] = rng.integers(
            0, item_vocab, size=(batch, seq_len)).astype(np.int32)
        out["hist_mask"] = (
            np.arange(seq_len)[None, :]
            < rng.integers(1, seq_len + 1, size=(batch, 1))
        ).astype(np.float32)
        out["target_id"] = rng.integers(0, item_vocab,
                                        size=(batch,)).astype(np.int32)
    out["label"] = rng.integers(0, 2, size=(batch,)).astype(np.float32)
    return out


def make_graph(
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    seed: int = 0,
    spatial: bool = True,
    cutoff: float = 10.0,
) -> dict:
    """A random graph as numpy arrays, the very numbers of ``repro.data.
    synthetic.make_graph`` for one seed: int32 ``senders`` and
    ``receivers`` [E] uniform over the nodes, f32 ``node_feat`` [N, F]
    standard normal and, with ``spatial``, f32 ``distances`` [E] uniform
    on [0.5, cutoff) (SchNet needs distances)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    out = {
        "senders": src,
        "receivers": dst,
        "node_feat": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
    }
    if spatial:
        out["distances"] = rng.uniform(0.5, cutoff,
                                       size=n_edges).astype(np.float32)
    return out


def sample_neighbors(
    csr_indptr: np.ndarray,
    csr_indices: np.ndarray,
    seeds: np.ndarray,
    fanouts,
    rng: np.random.Generator,
) -> dict:
    """Uniform neighbour sampling (GraphSAGE-style) into a block subgraph,
    the very arrays of ``repro.data.synthetic.sample_neighbors`` for one
    generator state: for each hop, ``fanout`` draws with replacement from
    each frontier node's CSR row (a node of no neighbour gets ``fanout``
    self-loops and draws nothing), the next frontier the distinct sampled
    senders.  Returns int64 ``node_ids`` (the sorted distinct global ids of
    every hop) and int32 local ``senders``, ``receivers`` and
    ``seed_local``.  The global-to-local map is a binary search over
    ``node_ids`` where JAX builds a dict; the draws keep JAX's order."""
    layers = [seeds.astype(np.int64)]
    all_src, all_dst = [], []
    frontier = seeds.astype(np.int64)
    for fanout in fanouts:
        srcs = np.empty(len(frontier) * fanout, dtype=np.int64)
        dsts = np.repeat(frontier, fanout)
        for i, node in enumerate(frontier):
            lo, hi = csr_indptr[node], csr_indptr[node + 1]
            deg = hi - lo
            w = i * fanout
            if deg == 0:
                srcs[w:w + fanout] = node  # self-loop fill
            else:
                sel = rng.integers(0, deg, size=fanout)
                srcs[w:w + fanout] = csr_indices[lo + sel]
        all_src.append(srcs)
        all_dst.append(dsts)
        frontier = np.unique(srcs)
        layers.append(frontier)
    nodes = np.unique(np.concatenate(layers))
    src = np.concatenate(all_src)
    dst = np.concatenate(all_dst)
    return {
        "node_ids": nodes.astype(np.int64),
        "senders": np.searchsorted(nodes, src).astype(np.int32),
        "receivers": np.searchsorted(nodes, dst).astype(np.int32),
        "seed_local": np.searchsorted(
            nodes, seeds.astype(np.int64)).astype(np.int32),
    }
