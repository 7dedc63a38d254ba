"""repro_torch's LM serving path (prefill and decode) vs repro's, on the CPU.

Weights are the JAX init's, carried into the port by ``params_from_jax``;
tokens come from ``make_lm_batch`` (numpy, the same numbers in both
packages).  Tolerance atol = rtol = 1e-5 in f32: the same f32 arithmetic
summed in another order.  In bf16 the two frameworks round at other places,
so the port's bf16 logits are held within twice the JAX package's own
bf16-vs-f32 drift on the same inputs.  The port's attention runs either the
plain chunked attention or ``flash_attention``, whose CPU entry is its
plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_0_5b as jq
from repro.data.synthetic import make_lm_batch as j_make_lm_batch
from repro.models import layers as JL
from repro.models.transformer import TransformerLM as JLM
from repro_torch.configs import qwen2_0_5b as tq
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.models import layers as TL
from repro_torch.models.transformer import (
    EMPTY_SLOT, TransformerLM, params_from_jax,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _carry(jconf, tconf, seed):
    jlm = JLM(jconf)
    params = jlm.init(jax.random.key(seed))
    port = TransformerLM(tconf, device="cpu")
    port.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jlm, params, port


def _attn_params(cfg_j, seed):
    rng = np.random.default_rng(seed)
    p = JL.init_attention(jax.random.key(seed), cfg_j, jnp.float32)
    # non-zero biases, so that the bias path is held too
    return {k: np.asarray(v) + (rng.normal(size=v.shape) * 0.1).astype(
        np.float32) for k, v in p.items()}


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_block_matches_jax(window, use_kernel):
    jc = dataclasses.replace(jq.SMOKE, sliding_window=window)
    tc = dataclasses.replace(tq.SMOKE, sliding_window=window)
    p = _attn_params(jc, 3)
    x = np.random.default_rng(1).normal(size=(2, 24, jc.d_model)).astype(
        np.float32)
    pos = np.arange(24)
    want, (wk, wv) = JL.attention_block(p, jnp.asarray(x), jc,
                                        jnp.asarray(pos), 8, 16)
    got, (gk, gv) = TL.attention_block({k: _t(v) for k, v in p.items()},
                                       _t(x), tc, _t(pos), 8, 16,
                                       use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)


@pytest.mark.parametrize("window,position", [(None, 9), (6, 13)])
def test_decode_attention_matches_jax(window, position):
    """One token into a cache of 10 slots holding positions 0..8 and an
    empty slot; with a window of 6 the cache is a ring that has wrapped."""
    jc = dataclasses.replace(jq.SMOKE, sliding_window=window)
    tc = dataclasses.replace(tq.SMOKE, sliding_window=window)
    p = _attn_params(jc, 4)
    rng = np.random.default_rng(position)
    b, s = 3, 10
    shape = (b, s, jc.n_kv_heads, jc.head_dim)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    cpos = np.full(s, EMPTY_SLOT, np.int32)
    cpos[:9] = np.arange(9) + (position - 9)
    x = rng.normal(size=(b, 1, jc.d_model)).astype(np.float32)
    want, (wk, wv, wpos) = JL.decode_attention(
        p, jnp.asarray(x), jc, jnp.asarray(ck), jnp.asarray(cv),
        jnp.int32(position), jnp.asarray(cpos))
    tk, tv, tpos = _t(ck), _t(cv), _t(cpos)
    got, (gk, gv, gpos) = TL.decode_attention(
        {k: _t(v) for k, v in p.items()}, _t(x), tc, tk, tv, position, tpos)
    assert gk is tk and gv is tv and gpos is tpos  # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))


@pytest.mark.parametrize("window", [None, 16])
def test_prefill_and_decode_match_jax(window):
    """prefill of 24 tokens, then decode from a cache of 40 positions: with
    a window of 16 the cache is a 16-slot ring and the steps wrap it."""
    jc = dataclasses.replace(jq.SMOKE, sliding_window=window)
    tc = dataclasses.replace(tq.SMOKE, sliding_window=window)
    jlm, params, port = _carry(jc, tc, seed=2)
    toks = make_lm_batch(2, 40, jc.vocab_size, seed=5)["tokens"]
    want = np.asarray(jax.jit(jlm.prefill)(params, jnp.asarray(toks[:, :24])))
    with torch.inference_mode():
        for use_kernel in (True, False):
            got = port.prefill(_t(toks[:, :24]), use_kernel=use_kernel)
            assert got.shape == (2, 1, jc.vocab_size)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, **TOL)

        assert port.cache_len(40) == jlm.cache_len(40)
        jcache = jlm.init_cache(2, 40)
        cache = port.init_cache(2, 40)
        for name in ("k", "v", "pos"):
            assert tuple(cache[name].shape) == jcache[name].shape
            np.testing.assert_array_equal(cache[name].numpy(),
                                          np.asarray(jcache[name]))
        step = jax.jit(jlm.decode_step)
        for pos in range(40):
            wl, jcache = step(params, jcache, jnp.asarray(toks[:, pos]),
                              jnp.int32(pos))
            gl, cache = port.decode_step(cache, _t(toks[:, pos]), pos)
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
        for name in ("k", "v", "pos"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL)


def test_decoding_one_by_one_reproduces_prefill():
    """Both packages: decoding S tokens from an empty cache ends with the
    logits that prefill gives for the last position."""
    jlm, params, port = _carry(jq.SMOKE, tq.SMOKE, seed=7)
    toks = make_lm_batch(3, 20, jq.SMOKE.vocab_size, seed=1)["tokens"]
    jcache = jlm.init_cache(3, 20)
    step = jax.jit(jlm.decode_step)
    for pos in range(20):
        wl, jcache = step(params, jcache, jnp.asarray(toks[:, pos]),
                          jnp.int32(pos))
    jpre = np.asarray(jax.jit(jlm.prefill)(params, jnp.asarray(toks)))[:, 0]
    np.testing.assert_allclose(np.asarray(wl), jpre, **TOL)
    with torch.inference_mode():
        cache = port.init_cache(3, 20)
        for pos in range(20):
            gl, cache = port.decode_step(cache, _t(toks[:, pos]), pos)
        pre = port.prefill(_t(toks))[:, 0]
    np.testing.assert_allclose(gl.numpy(), pre.numpy(), **TOL)
    np.testing.assert_allclose(pre.numpy(), jpre, **TOL)


def test_full_width_one_layer_f32_and_bf16():
    """qwen2-0.5b at full width (d 896, 14 heads over 2, d_ff 4864, V
    151,936, tied head) with one layer, B = 2, S = 64."""
    jfull = dataclasses.replace(jq.FULL, n_layers=1)
    tfull = dataclasses.replace(tq.FULL, n_layers=1)
    toks = make_lm_batch(2, 64, jfull.vocab_size, seed=3)["tokens"]
    jlm = JLM(jfull)
    params = jlm.init(jax.random.key(0))
    out = {}
    for dt in ("float32", "bfloat16"):
        jlm_dt = JLM(dataclasses.replace(jfull, dtype=dt))
        out[dt] = np.asarray(jax.jit(jlm_dt.prefill)(params,
                                                     jnp.asarray(toks)))
    port = TransformerLM(dataclasses.replace(tfull, dtype="float32"),
                         device="cpu")
    port.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    del params
    with torch.inference_mode():
        got32 = port.prefill(_t(toks)).numpy()
        np.testing.assert_allclose(got32, out["float32"], **TOL)
        port.cfg = tfull  # the same weights under the bf16 compute dtype
        assert tfull.dtype == "bfloat16"
        got16 = port.prefill(_t(toks)).numpy()
    drift = np.abs(out["bfloat16"] - out["float32"]).max()
    assert 0 < drift < 0.5 * np.abs(out["float32"]).max()
    assert np.abs(got16 - out["bfloat16"]).max() <= 2 * drift


def test_lm_defaults_to_cuda_and_checks_tokens():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        TransformerLM(tq.SMOKE)
    port = TransformerLM(tq.SMOKE, device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        port.prefill(torch.tensor([[1, tq.SMOKE.vocab_size]]))
    cache = port.init_cache(1, 4)
    with pytest.raises(ValueError, match="token ids"):
        port.decode_step(cache, torch.tensor([-1]), 0)


def test_port_init_has_the_jax_shapes_and_dtypes():
    cfg = tq.SMOKE
    jstate = params_from_jax(jax.tree_util.tree_map(
        np.asarray, JLM(jq.SMOKE).init(jax.random.key(0))))
    port = TransformerLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    state = port.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in jstate.items()}
    assert all(v.dtype == torch.float32 for v in state.values())
    # num_params() counts no qkv bias, in JAX or here
    bias = sum(v.numel() for k, v in state.items()
               if k.rsplit(".", 1)[-1] in ("bq", "bk", "bv"))
    assert bias and cfg.num_params() + bias == sum(
        v.numel() for v in state.values())
    assert tq.FULL.num_params() == jq.FULL.num_params() == 494_005_120


def test_make_lm_batch_is_the_jax_batch():
    got, want = make_lm_batch(3, 17, 1000, seed=4), j_make_lm_batch(
        3, 17, 1000, seed=4)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
