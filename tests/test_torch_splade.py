"""repro_torch's SPLADE encoding path vs repro's, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in the port.  Tolerance atol = rtol = 1e-5, the JAX
package's own bar for the fused head (``tests/test_splade_encoder.py``):
the same f32 products summed in another order.  The JAX ``splade_head``
runs its Pallas kernel in interpret mode here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_topk
from repro.configs import gpusparse as jcfg
from repro.core import engine as jeng
from repro.core import scoring as jscoring
from repro.core import sparse as jsparse
from repro.data.synthetic import make_msmarco_like
from repro.kernels.splade_head import splade_head as j_splade_head
from repro.kernels.splade_head import splade_head_ref as j_splade_head_ref
from repro.models import layers as JL
from repro.models.splade import SpladeEncoder as JEncoder
from repro_torch.configs import gpusparse as tcfg
from repro_torch.configs.base import MoEConfig
from repro_torch.core import engine as teng
from repro_torch.core import sparse as tsparse
from repro_torch.kernels.splade_head import ops as head_ops
from repro_torch.kernels.splade_head import splade_head_ref
from repro_torch.models import layers as TL
from repro_torch.models.splade import SpladeEncoder, params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
THRESHOLD = 0.05  # the serve example's query threshold


def _t(x):
    return torch.from_numpy(np.array(x))


def _head_inputs(b, t, d, v, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, t, d)).astype(np.float32)
    mask = (rng.uniform(size=(b, t)) > 0.3).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    return h, mask, w, bias


@pytest.mark.parametrize("b,t,d,v,vb,tc", [
    (2, 64, 32, 300, 128, 32),
    (3, 96, 48, 513, 256, 96),
])
def test_head_ref_matches_the_pallas_kernel_and_its_ref(b, t, d, v, vb, tc):
    args = _head_inputs(b, t, d, v, b * t)
    got = splade_head_ref(*map(_t, args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    kernel = j_splade_head(*jargs, vocab_block=vb, token_chunk=tc)
    np.testing.assert_allclose(got, np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got, np.asarray(j_splade_head_ref(*jargs)),
                               **TOL)


def test_head_ref_at_full_width():
    cfg = tcfg.ENCODER
    args = _head_inputs(2, 8, cfg.d_model, cfg.vocab_size, 7)
    got = splade_head_ref(*map(_t, args)).numpy()
    want = j_splade_head_ref(*[jnp.asarray(a) for a in args])
    assert got.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_head_mask_is_a_multiplier():
    h, _, w, bias = _head_inputs(3, 5, 16, 40, 3)
    mask = np.ones((3, 5), np.float32)
    mask[1] = 0.0  # a fully masked row encodes to exactly 0
    mask[2] = 0.5  # a fractional mask scales every activation
    got = splade_head_ref(*map(_t, (h, mask, w, bias))).numpy()
    assert np.all(got[1] == 0.0)
    full = splade_head_ref(*map(_t, (h, np.ones_like(mask), w, bias))).numpy()
    np.testing.assert_allclose(got[2], 0.5 * full[2], **TOL)
    np.testing.assert_array_equal(got[0], full[0])


def test_head_entry_on_cpu_is_the_plain_version():
    args = list(map(_t, _head_inputs(2, 9, 16, 70, 5)))
    before = head_ops.launches
    got = head_ops.splade_head(*args)
    assert head_ops.launches == before
    assert torch.equal(got, splade_head_ref(*args))


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 3, 8)).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, size=(8,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(_t(x), _t(wt), 1e-6).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(wt), 1e-6)), **TOL)
    pos = np.arange(6) + 3
    np.testing.assert_allclose(
        TL.apply_rope(_t(x), _t(pos), 10000.0).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        **TOL)


@pytest.mark.parametrize("causal,window,hq,hkv,chunks", [
    (False, None, 4, 4, (1024, 1024)),  # the encoder's call: one chunk
    (False, None, 4, 4, (8, 4)),
    (True, None, 4, 2, (8, 4)),  # GQA, Hq = 2 Hkv
    (True, 5, 4, 4, (4, 8)),
    (False, 3, 2, 1, (16, 16)),
])
def test_chunked_attention_matches_jax(causal, window, hq, hkv, chunks):
    rng = np.random.default_rng(hq * 10 + hkv)
    b, s, dh = 2, 16, 8
    q = rng.normal(size=(b, s, hq, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    pos = np.arange(s)
    qc, kc = chunks
    got = TL.chunked_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                               window=window, q_chunk=qc, kv_chunk=kc,
                               causal=causal).numpy()
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                window=window, q_chunk=qc, kv_chunk=kc,
                                causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("qk_norm,qkv_bias", [(False, False), (True, True)])
def test_qkv_matches_jax(qk_norm, qkv_bias):
    jc = dataclasses.replace(jcfg.ENCODER_SMOKE, n_kv_heads=2,
                             qk_norm=qk_norm, qkv_bias=qkv_bias)
    tc = dataclasses.replace(tcfg.ENCODER_SMOKE, n_kv_heads=2,
                             qk_norm=qk_norm, qkv_bias=qkv_bias)
    rng = np.random.default_rng(4)
    p = {k: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32) * 0.1
         for k, v in JL.init_attention(jax.random.key(3), jc,
                                       jnp.float32).items()}
    tp = TL.init_attention(torch.Generator().manual_seed(0), tc,
                           torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in p.items()}
    x = rng.normal(size=(2, 6, jc.d_model)).astype(np.float32)
    pos = np.arange(6)
    got = TL.qkv({k: _t(v) for k, v in p.items()}, _t(x), tc, _t(pos))
    want = JL._qkv(p, jnp.asarray(x), jc, jnp.asarray(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp_block_matches_jax(act):
    jc = dataclasses.replace(jcfg.ENCODER_SMOKE, act=act)
    tc = dataclasses.replace(tcfg.ENCODER_SMOKE, act=act)
    p = jax.tree_util.tree_map(np.asarray, JL.init_mlp(jax.random.key(1), jc,
                                                       jnp.float32))
    x = np.random.default_rng(2).normal(size=(2, 5, jc.d_model)).astype(
        np.float32)
    got = TL.mlp_block({k: _t(v) for k, v in p.items()}, _t(x), tc).numpy()
    want = JL.mlp_block(p, jnp.asarray(x), jc)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _carry(jconf, tconf, seed):
    jenc = JEncoder(jconf)
    params = jenc.init(jax.random.key(seed))
    port = SpladeEncoder(tconf, device="cpu")
    port.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jenc, params, port


def _tokens(b, t, vocab, seed, zero_row=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, t)).astype(np.int32)
    lens = rng.integers(1, t + 1, b)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    if zero_row:
        mask[-1] = 0.0
    return toks, mask


@pytest.mark.parametrize("jconf,tconf,b,t", [
    (jcfg.ENCODER_SMOKE, tcfg.ENCODER_SMOKE, 3, 24),
    (jcfg.ENCODER_SMOKE, tcfg.ENCODER_SMOKE, 3, 32),
    (dataclasses.replace(jcfg.ENCODER, n_layers=1),
     dataclasses.replace(tcfg.ENCODER, n_layers=1), 2, 16),
], ids=["smoke-T24", "smoke-T32", "full-width-1-layer"])
def test_encode_matches_jax(jconf, tconf, b, t):
    jenc, params, port = _carry(jconf, tconf, seed=t)
    toks, mask = _tokens(b, t, jconf.vocab_size, seed=t, zero_row=b > 2)
    want = np.asarray(jenc.encode(params, jnp.asarray(toks),
                                  jnp.asarray(mask)))
    if jconf.d_model < 768:  # the Pallas head in interpret mode, too
        fused = jenc.encode(params, jnp.asarray(toks), jnp.asarray(mask),
                            use_kernel=True)
        np.testing.assert_allclose(np.asarray(fused), want, **TOL)
    with torch.no_grad():
        for use_kernel in (False, True):
            got = port.encode(_t(toks), _t(mask), use_kernel=use_kernel)
            assert got.shape == (b, jconf.vocab_size)
            np.testing.assert_allclose(got.numpy(), want, **TOL)
    if b > 2:
        assert np.all(got.numpy()[-1] == 0.0)  # the all-zero mask row


def test_port_init_has_the_jax_shapes_and_scales():
    cfg = tcfg.ENCODER_SMOKE
    port = SpladeEncoder(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    jstate = params_from_jax(jax.tree_util.tree_map(
        np.asarray, JEncoder(jcfg.ENCODER_SMOKE).init(jax.random.key(0))))
    state = port.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in jstate.items()}
    assert all(v.dtype == torch.float32 for v in state.values())
    assert float(state["embed"].std()) == pytest.approx(0.02, rel=0.05)
    wq = state["blocks.0.attn.wq"]
    assert float(wq.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)
    assert torch.equal(state["ln_f"], torch.ones(cfg.d_model))
    assert not state["mlm_bias"].any()
    # the seed fixes the weights; the tied head is embed.T, not a copy
    again = SpladeEncoder(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.embed, port.embed)
    assert port.head_weight().data_ptr() == port.embed.data_ptr()
    # the backbone's analytic count, plus the head's bias
    assert port.cfg.num_params() + cfg.vocab_size == sum(
        v.numel() for v in state.values())


def test_encoder_defaults_to_cuda_and_checks_token_ids():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        SpladeEncoder(tcfg.ENCODER_SMOKE)
    port = SpladeEncoder(tcfg.ENCODER_SMOKE, device="cpu")
    mask = torch.ones(1, 3)
    for bad in (-1, tcfg.ENCODER_SMOKE.vocab_size):
        with pytest.raises(ValueError, match="token ids"):
            port.encode(torch.tensor([[1, bad, 2]]), mask)
    with pytest.raises(NotImplementedError, match="expert"):
        SpladeEncoder(dataclasses.replace(
            tcfg.ENCODER_SMOKE, moe=MoEConfig(num_experts=4, top_k=2)),
            device="cpu")


@pytest.mark.parametrize("knob,value", [
    ("scan_layers", False), ("attn_unroll", True), ("seq_parallel", True),
])
def test_config_has_no_unported_knob(knob, value):
    """A JAX knob the port does not read is no field of the port's config:
    setting it fails instead of being ignored.  ``seq_parallel`` is ported
    (the LM reads it under a sharding policy): a field with JAX's name and
    default that takes the value."""
    assert hasattr(jcfg.ENCODER, knob)
    if knob == "seq_parallel":
        assert tcfg.ENCODER_SMOKE.seq_parallel == jcfg.ENCODER.seq_parallel
        assert dataclasses.replace(tcfg.ENCODER_SMOKE, **{knob: value}
                                   ).seq_parallel == value
        return
    with pytest.raises(TypeError):
        dataclasses.replace(tcfg.ENCODER_SMOKE, **{knob: value})


@pytest.mark.parametrize("knob,value", [
    ("sliding_window", 8), ("dtype", "bfloat16"), ("attn_q_chunk", 16),
    ("attn_kv_chunk", 16), ("remat", True),
])
def test_lm_fields_have_the_jax_defaults_and_leave_encode_alone(knob, value):
    """The LM path's fields exist with JAX's defaults and values; the
    encoder reads none of them (the JAX ``encode`` never casts to ``dtype``
    either, nor remats)."""
    for t, j in ((tcfg.ENCODER, jcfg.ENCODER),
                 (tcfg.ENCODER_SMOKE, jcfg.ENCODER_SMOKE)):
        assert getattr(t, knob) == getattr(j, knob)
    _, _, port = _carry(jcfg.ENCODER_SMOKE, tcfg.ENCODER_SMOKE, seed=1)
    toks, mask = _tokens(2, 20, tcfg.ENCODER_SMOKE.vocab_size, seed=2)
    with torch.no_grad():
        want = port.encode(_t(toks), _t(mask))
        port.cfg = dataclasses.replace(tcfg.ENCODER_SMOKE, **{knob: value})
        got = port.encode(_t(toks), _t(mask))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_config_refuses_an_unported_compute_dtype():
    with pytest.raises(ValueError, match="float16"):
        dataclasses.replace(tcfg.ENCODER_SMOKE, dtype="float16")


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float16"])
def test_config_keeps_parameters_in_f32(param_dtype):
    with pytest.raises(NotImplementedError, match="float32"):
        dataclasses.replace(tcfg.ENCODER_SMOKE, param_dtype=param_dtype)


def test_encode_then_search_matches_jax():
    """tokens -> encode -> threshold -> dense_to_sparse -> tiled search,
    through both packages, over one corpus in the encoder's vocabulary."""
    jconf, tconf = jcfg.ENCODER_SMOKE, tcfg.ENCODER_SMOKE
    jenc, params, port = _carry(jconf, tconf, seed=3)
    toks, mask = _tokens(6, 20, jconf.vocab_size, seed=4)
    x = np.asarray(jenc.encode(params, jnp.asarray(toks), jnp.asarray(mask)))
    with torch.no_grad():
        y = port.encode(_t(toks), _t(mask), use_kernel=True)
    np.testing.assert_allclose(y.numpy(), x, **TOL)
    # No encoded value lies closer to the threshold than the two packages'
    # encodings differ there, so no term can fall on the other side of it in
    # one package only: a differing sparsity pattern below is a fault.
    assert np.all(np.abs(x - THRESHOLD) > np.abs(y.numpy() - x))
    jq = jsparse.dense_to_sparse(np.where(x > THRESHOLD, x, 0.0))
    tq = tsparse.dense_to_sparse(torch.where(y > THRESHOLD, y, 0.0),
                                 device="cpu")
    np.testing.assert_array_equal(tq.term_ids.numpy(), np.asarray(jq.term_ids))
    np.testing.assert_allclose(tq.values.numpy(), np.asarray(jq.values), **TOL)

    c = make_msmarco_like(300, 1, vocab_size=jconf.vocab_size, seed=9)
    geo = dict(engine="tiled", term_block=128, doc_block=32, chunk_size=64,
               k=25)
    ref = jeng.RetrievalEngine(c.docs, jeng.RetrievalConfig(**geo))
    docs = tsparse.SparseBatch(_t(c.docs.term_ids), _t(c.docs.values),
                               c.docs.vocab_size)
    got = teng.RetrievalEngine(docs, teng.RetrievalConfig(**geo),
                               device="cpu").search(tq)
    oracle = np.asarray(jscoring.score_dense_f64(jq, c.docs))
    assert_same_topk(got, ref.search(jq), oracle)
