"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc`` and skip without them.  The
file imports no JAX, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: max |kernel - plain| <= 1e-5 * max |plain| — the same f32
products summed in another order.  The ``bmp_scan`` sweep must also fetch
exactly the plain version's blocks and chunks in the same number of steps.
``splade_head`` sums d-long dot products in another order; its max over
tokens is exact.  ``flash_attention`` in f32: atol = rtol = 2e-5 (the JAX
package's bar for this kernel); in bf16 both versions compute in f32 and
round once, so within one bf16 ulp of the output plus that f32 bar.
``embedding_bag``: atol = rtol = 1e-5 of the plain version (an f32 sum of
at most a few products, in another order), bitwise equal between launches.
"""
import pytest
import torch

from repro_torch.core import index as tidx
from repro_torch.core import scoring
from repro_torch.core.engine import RetrievalConfig, RetrievalEngine
from repro_torch.data.synthetic import make_msmarco_like, make_topical_corpus
from repro_torch.kernels.bmp_scan import ops as bmp_ops
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.bmp_scan.ref import bmp_sweep_ref
from repro_torch.kernels.ell_gather import ops as ell_ops
from repro_torch.kernels.ell_gather.ref import ell_gather_ref
from repro_torch.kernels.scatter_score import ops as scatter_ops
from repro_torch.kernels.scatter_score.ref import scatter_score_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.splade_head import ops as head_ops
from repro_torch.kernels.splade_head.ref import splade_head_ref

TOL = 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    """Within TOL of max |want| where finite; the same infinities."""
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    if fin.any():
        err = (got[fin] - want[fin]).abs().max().item()
        assert err <= TOL * want[fin].abs().max().item(), err


def _tiled_args(t):
    return (t.local_term, t.local_doc, t.value, t.chunk_term_block,
            t.chunk_doc_block)


@pytest.mark.parametrize("tb,db,cs,b", [(512, 256, 512, 70),
                                        (512, 256, 512, 300),
                                        (512, 128, 64, 64),
                                        (128, 32, 256, 3)])
def test_scatter_score_kernel_matches_plain(cuda, tb, db, cs, b):
    c = make_msmarco_like(3001, b, vocab_size=5000, seed=tb + db,
                          device=cuda)
    t = tidx.build_tiled_index(c.docs, tb, db, cs)
    qw = torch.nn.functional.pad(c.queries.to_dense(),
                                 (0, t.num_term_blocks * tb - c.vocab_size))
    # the index, and a tile-skipped one whose zeroing chunks are blanked
    for ix in (t, tidx.filter_tiled_index(t, c.queries.slice_rows(0, 1))):
        before = scatter_ops.launches
        got = scatter_ops.scatter_score(
            qw, *_tiled_args(ix), ix.block_chunk_start, ix.block_chunk_count,
            term_block=tb, doc_block=db, num_doc_blocks=ix.num_doc_blocks)
        assert scatter_ops.launches == before + 1
        want = scatter_score_ref(qw, *_tiled_args(ix), ix.block_chunk_start,
                                 ix.block_chunk_count, term_block=tb,
                                 doc_block=db,
                                 num_doc_blocks=ix.num_doc_blocks)
        _close(got, want)


@pytest.mark.parametrize("b", [1, 64, 130])
def test_ell_gather_kernel_matches_plain(cuda, b):
    c = make_msmarco_like(2999, b, vocab_size=5000, seed=b, device=cuda)
    e = tidx.build_ell_index(c.docs)
    qw = c.queries.to_dense()
    before = ell_ops.launches
    got = ell_ops.ell_gather(qw, e.terms, e.values)
    assert ell_ops.launches == before + 1
    _close(got, ell_gather_ref(qw, e.terms, e.values))


def test_cuda_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor goes to the kernel or raises; a bad operand raises
    before any launch."""
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(scatter_ops, "scatter_score_ref", boom)
    monkeypatch.setattr(ell_ops, "ell_gather_ref", boom)
    monkeypatch.setattr(bmp_ops, "bmp_sweep_ref", boom)
    c = make_msmarco_like(500, 8, vocab_size=2000, seed=1, device=cuda)
    for name in ("tiled", "ell", "tiled-pruned", "tiled-bmp-fused"):
        v, i = RetrievalEngine(c.docs, RetrievalConfig(engine=name, k=10),
                               device=cuda).search(c.queries)
        assert v.shape == (8, 10)
    e = tidx.build_ell_index(c.docs)
    with pytest.raises(TypeError):
        ell_ops.ell_gather(c.queries.to_dense(), e.terms.long(), e.values)


def test_scatter_score_kernel_honours_partial_runs(cuda):
    """Runs over a subset of blocks: the kernel scores those blocks as the
    full runs do and leaves 0 elsewhere, as its plain version."""
    c = make_msmarco_like(2001, 16, vocab_size=3000, seed=3, device=cuda)
    t = tidx.build_tiled_index(c.docs, 256, 32, 64)
    qw = torch.nn.functional.pad(c.queries.to_dense(),
                                 (0, t.num_term_blocks * 256 - 3000))
    keep = torch.arange(t.num_doc_blocks, device=cuda) % 3 == 1
    count = t.block_chunk_count * keep.int()
    args = (qw, *_tiled_args(t), t.block_chunk_start)
    kw = dict(term_block=256, doc_block=32, num_doc_blocks=t.num_doc_blocks)
    got = scatter_ops.scatter_score(*args, count, **kw)
    full = scatter_ops.scatter_score(*args, t.block_chunk_count, **kw)
    cols = keep.repeat_interleave(32)
    assert torch.equal(got[:, cols], full[:, cols])
    assert not got[:, ~cols].any()
    _close(got, scatter_score_ref(*args, count, **kw))


def _sweep_inputs(cuda, n_docs, b, db, k, cs=64, seed=0):
    c = make_topical_corpus(n_docs, b, vocab_size=4000, num_topics=8,
                            topic_vocab=300, seed=seed, device=cuda)
    docs, _ = tidx.reorder_docs(c.docs, "df-signature")
    t = tidx.build_tiled_index(docs, 256, db, cs, store_term_block_max=True)
    qw = scoring._pad_queries_to_term_blocks(c.queries, t)
    ub = scoring.block_upper_bounds(c.queries, t, qw=qw)
    order = torch.argsort(-ub, dim=-1, stable=True)
    return t, qw, order.int(), ub.gather(-1, order)


def _runs(t):
    return (t.block_chunk_start, t.block_chunk_count, t.chunk_term_block,
            t.chunk_doc_block, t.local_term, t.local_doc, t.value)


@pytest.mark.parametrize("db,k,groups,theta,warm,dead", [
    (16, 5, [[0, 1, 2], [3], [4, 5, 6, 7]], 1.0, False, False),
    (64, 40, [[0, 1, 2, 3, 4, 5, 6, 7]], 0.8, True, True),
    (32, 10, [list(range(40))], 1.0, False, True),  # one 64-row group
])
def test_bmp_sweep_kernel_matches_plain(cuda, db, k, groups, theta, warm,
                                        dead):
    b = max(max(g) for g in groups) + 1
    t, qw, order, ub_sorted = _sweep_inputs(cuda, 1500, b, db, k)
    size = max(1 << (len(g) - 1).bit_length() for g in groups)
    sel = torch.tensor([g + [0] * (size - len(g)) for g in groups],
                       device=cuda)
    tau0 = torch.full(sel.shape, float("-inf"), device=cuda)
    if warm:
        tau0[:, 0] = 2.0
    for i, g in enumerate(groups):
        tau0[i, len(g):] = 3.4e38 / 4  # PAD_TAU
    alive = None
    if dead:
        alive = torch.ones(t.num_docs, dtype=torch.bool, device=cuda)
        alive[::7] = False
    kw = dict(term_block=256, doc_block=db, k_eff=k, theta=theta,
              num_docs=t.num_docs)
    before = bmp_ops.launches
    got = bmp_ops.bmp_sweep(qw[sel], order[sel], ub_sorted[sel], tau0,
                            *_runs(t), alive, **kw)
    assert bmp_ops.launches == before + 1
    torch.cuda.synchronize()
    for gi in range(len(groups)):
        want = bmp_sweep_ref(qw[sel[gi]], order[sel[gi]],
                             ub_sorted[sel[gi]], tau0[gi], *_runs(t), alive,
                             **kw)
        _close(got[0][gi], want[0])
        _close(got[1][gi], want[1])
        assert torch.equal(got[2][gi].bool(), want[2])
        assert torch.equal(got[3][gi].bool(), want[3])
        assert int(got[4][gi, 0]) == want[4]


@pytest.mark.parametrize("engine", ["tiled-pruned", "tiled-bmp-grouped",
                                    "tiled-bmp-fused"])
@pytest.mark.parametrize("reorder", [False, True])
def test_pruned_engines_on_the_card_match_tiled(cuda, engine, reorder):
    c = make_topical_corpus(3000, 24, vocab_size=4000, num_topics=8,
                            topic_vocab=300, seed=2, device=cuda)
    geo = dict(k=20, term_block=256, doc_block=32, chunk_size=64)
    exact = RetrievalEngine(c.docs, RetrievalConfig(engine="tiled", **geo),
                            device=cuda).search(c.queries)
    eng = RetrievalEngine(c.docs, RetrievalConfig(
        engine=engine, reorder_docs=reorder, reorder_method="df-signature",
        **geo), device=cuda)
    before = bmp_ops.launches
    v, i = eng.search(c.queries)
    assert bmp_ops.launches > before
    if reorder:  # other blocks, so sums in another order
        torch.testing.assert_close(torch.from_numpy(v),
                                   torch.from_numpy(exact[0]))
    else:  # scored blocks carry scatter_score's very bits (the same fold)
        assert (v == exact[0]).all() and (i == exact[1]).all()


@pytest.mark.parametrize("b,t,d,v,layout", [
    (3, 37, 64, 1000, "contiguous"),  # ragged T and V
    (2, 130, 96, 513, "embed.T"),  # T over three token tiles
    (1, 64, 768, 30522, "embed.T"),  # B = 1 at the encoder's width
    (4, 200, 768, 2000, "contiguous"),
    (2, 7, 64, 257, "embed.T"),
])
def test_splade_head_kernel_matches_plain(cuda, b, t, d, v, layout):
    g = torch.Generator(device=cuda).manual_seed(b * t + v)
    h = torch.randn(b, t, d, generator=g, device=cuda)
    mask = (torch.rand(b, t, generator=g, device=cuda) > 0.3).float()
    mask[:, 1::3] *= 0.5  # a fractional mask
    if b > 1:
        mask[-1] = 0.0  # an all-zero row
    embed = torch.randn(v, d, generator=g, device=cuda) * 0.05
    w = embed.T if layout == "embed.T" else embed.T.contiguous()
    bias = torch.randn(v, generator=g, device=cuda) * 0.1
    before = head_ops.launches
    got = head_ops.splade_head(h, mask, w, bias)
    assert head_ops.launches == before + 1
    _close(got, splade_head_ref(h, mask, w, bias))
    assert torch.equal(got, head_ops.splade_head(h, mask, w, bias))
    if b > 1:
        assert not got[-1].any()


def test_encoder_on_the_card_goes_through_the_kernel(cuda, monkeypatch):
    from repro_torch.configs.gpusparse import ENCODER_SMOKE
    from repro_torch.models.splade import SpladeEncoder

    enc = SpladeEncoder(ENCODER_SMOKE, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, ENCODER_SMOKE.vocab_size, (5, 40),
                           generator=g, device=cuda)
    mask = (torch.rand(5, 40, generator=g, device=cuda) > 0.2).float()
    with pytest.raises(RuntimeError, match="backward"):
        enc.encode(tokens, mask, use_kernel=True)
    with torch.inference_mode():
        want = enc.encode(tokens, mask)

        def boom(*a, **k):
            raise AssertionError("plain version called on a CUDA tensor")

        monkeypatch.setattr(head_ops, "splade_head_ref", boom)
        before = head_ops.launches
        got = enc.encode(tokens, mask, use_kernel=True)
    assert head_ops.launches == before + 1
    _close(got, want)


def _flash_within(got, want):
    """f32: atol = rtol = 2e-5; bf16: one bf16 ulp of the output on top
    (|x| in [2^(e-1), 2^e) has a bf16 ulp of 2^(e-8))."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    bar = 2e-5 * (1 + w.abs())
    if got.dtype == torch.bfloat16:
        big = torch.maximum(g.abs(), w.abs())
        bar = bar + torch.ldexp(torch.ones_like(big),
                                torch.frexp(big).exponent - 8)
    err = (g - w).abs()
    assert torch.isfinite(g).all() and (err <= bar).all(), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window", [
    (2, 64, 4, 2, 64, True, None),
    (1, 200, 14, 2, 64, True, None),  # qwen2-0.5b's heads, ragged S
    (2, 130, 6, 3, 64, True, 24),  # window across tile edges
    (1, 96, 8, 1, 64, True, None),  # MQA
    (2, 77, 4, 4, 64, False, None),
    (1, 300, 32, 8, 128, True, None),  # Dh 128, ragged S
    (1, 150, 32, 8, 128, False, 40),
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, hq, hkv,
                                              dh, causal, window):
    g = torch.Generator(device=cuda).manual_seed(s * hq + dh)
    q, k, v = (torch.randn(b, s, h, dh, generator=g, device=cuda).to(dtype)
               for h in (hq, hkv, hkv))
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert flash_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, s, hq, dh)
    _flash_within(got, flash_attention_ref(q, k, v, causal, window))
    assert torch.equal(got, flash_ops.flash_attention(q, k, v, causal=causal,
                                                      window=window))


def test_flash_attention_reads_strided_heads(cuda):
    """q, k, v as views of one fused [B, S, Hq + 2 Hkv, Dh] projection."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 100, 14 + 4, 64, generator=g, device=cuda)
    q, k, v = qkv[:, :, :14], qkv[:, :, 14:16], qkv[:, :, 16:]
    got = flash_ops.flash_attention(q, k, v)
    _flash_within(got, flash_attention_ref(q.contiguous(), k.contiguous(),
                                           v.contiguous()))


def test_flash_attention_refuses_what_it_cannot_run(cuda):
    q = torch.randn(1, 64, 4, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=cuda)
    before = flash_ops.launches
    with pytest.raises(RuntimeError, match="backward"):
        flash_ops.flash_attention(q, k, k)
    q = q.detach()
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="Dh"):
        flash_ops.flash_attention(q[..., :32].contiguous(),
                                  k[..., :32].contiguous(),
                                  k[..., :32].contiguous())
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, torch.randn(1, 64, 3, 64, device=cuda),
                                  torch.randn(1, 64, 3, 64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q.transpose(1, 3).contiguous().transpose(
            1, 3), k, k)
    assert flash_ops.launches == before


def test_lm_prefill_on_the_card_goes_through_the_kernel(cuda, monkeypatch):
    import dataclasses

    from repro_torch.configs.qwen2_0_5b import FULL
    from repro_torch.models.transformer import TransformerLM

    # qwen2-0.5b's head geometry (Dh 64, a group of 7), narrow and shallow
    cfg = dataclasses.replace(FULL, n_layers=2, d_model=448, n_heads=7,
                              n_kv_heads=1, d_ff=256, vocab_size=512,
                              dtype="float32")
    lm = TransformerLM(cfg, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, 512, (2, 90), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    with pytest.raises(RuntimeError, match="backward"):
        lm.prefill(tokens)
    with torch.inference_mode():
        want = lm.prefill(tokens, use_kernel=False)

        def boom(*a, **k):
            raise AssertionError("plain version called on a CUDA tensor")

        monkeypatch.setattr(flash_ops, "flash_attention_ref", boom)
        before = flash_ops.launches
        got = lm.prefill(tokens)
    assert flash_ops.launches == before + cfg.n_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,l,v,d,weighted", [
    (7, 1, 50, 10, False), (7, 1, 50, 10, True),
    (130, 5, 1000, 18, False), (130, 5, 1000, 18, True),
])
def test_embedding_bag_kernel_matches_plain(cuda, n, l, v, d, weighted):
    g = torch.Generator(device=cuda).manual_seed(n + v)
    ids = torch.randint(-1, v + 20, (n, l), generator=g, device=cuda,
                        dtype=torch.int32)  # pads and ids at or past V
    ids[0] = -1  # an all-pad bag
    ids[1, 1:] = ids[1, 0].clone()  # duplicate ids
    table = torch.randn(v, d, generator=g, device=cuda)
    w = torch.randn(n, l, generator=g, device=cuda) if weighted else None
    before = bag_ops.launches
    got = bag_ops.embedding_bag(ids, table, w)
    assert bag_ops.launches == before + 1
    assert got.shape == (n, d) and not got[0].any()
    torch.testing.assert_close(got, embedding_bag_ref(ids, w, table),
                               rtol=TOL, atol=TOL)
    assert torch.equal(got, bag_ops.embedding_bag(ids, table, w))


def test_embedding_bag_refuses_what_it_cannot_run(cuda):
    ids = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    table = torch.randn(10, 10, device=cuda, requires_grad=True)
    before = bag_ops.launches
    with pytest.raises(RuntimeError, match="backward"):
        bag_ops.embedding_bag(ids, table)
    table = table.detach()
    with pytest.raises(TypeError):
        bag_ops.embedding_bag(ids.long(), table)
    with pytest.raises(TypeError):
        bag_ops.embedding_bag(ids, table.double())
    with pytest.raises(ValueError, match="contiguous"):
        bag_ops.embedding_bag(ids, table.T)
    with pytest.raises(ValueError):
        bag_ops.embedding_bag(ids, table, torch.ones(4, 2, device=cuda))
    assert bag_ops.launches == before


def test_xdeepfm_forward_on_the_card_goes_through_the_kernel(cuda,
                                                            monkeypatch):
    """xDeepFM at full width (the 16.6M-row Criteo-39 table) on a multi-hot
    batch: one launch a forward, the plain path's logits."""
    from repro_torch.configs.xdeepfm import FULL
    from repro_torch.data.synthetic import make_recsys_batch
    from repro_torch.models.recsys import build_model

    model = build_model(FULL, device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in make_recsys_batch(
        64, FULL.n_sparse, FULL.vocab_sizes, multi_hot=8, seed=0).items()}
    with pytest.raises(RuntimeError, match="backward"):
        model(batch)
    with torch.inference_mode():
        want = model(batch, use_kernel=False)

        def boom(*a, **k):
            raise AssertionError("plain version called on a CUDA tensor")

        monkeypatch.setattr(bag_ops, "embedding_bag_ref", boom)
        before = bag_ops.launches
        got = model(batch)
    assert bag_ops.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
