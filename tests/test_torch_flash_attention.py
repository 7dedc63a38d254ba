"""repro_torch's flash-attention entry and plain version vs repro's, on the
CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in the port.  The JAX ``flash_attention`` runs its Pallas
kernel in interpret mode here, as the JAX package's own tests run it.
Tolerance atol = rtol = 2e-5 in f32, the JAX package's bar for this kernel
(``tests/test_kernels.py::test_flash_attention_sweep``): the same f32 sums
in another order.  In bf16 both sides compute in f32 and round once to
bf16, so they may differ by one bf16 ulp of the output on top of that f32
bar (which is what shows at outputs near 0, where an ulp is tiny).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref as j_flash_ref
from repro_torch.kernels.flash_attention import flash_attention_ref, ops

TOL = dict(rtol=2e-5, atol=2e-5)

# test_flash_attention_sweep's shapes, and qwen2-0.5b's heads (14 over 2,
# a group of 7) at Dh 64.
SWEEP = [
    (2, 64, 4, 2, 16, True, None, 16, 16),
    (1, 128, 6, 3, 32, True, 24, 32, 32),
    (2, 32, 2, 2, 8, False, None, 16, 8),
    (1, 96, 8, 1, 16, True, None, 32, 48),  # MQA
    (2, 64, 14, 2, 64, True, None, 32, 32),
]


def _qkv(b, sq, hq, hkv, dh, seed, skv=None):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return (rng.normal(size=(b, sq, hq, dh)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, dh)).astype(np.float32))


def _jax_ref(q, k, v, causal, window):
    """The JAX naive oracle on [B*H, S, Dh], back to [B, S, H, Dh]."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    flat = [jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(-1, x.shape[1], dh)
            for x in (q, k, v)]
    out = j_flash_ref(*flat, hq, hkv, causal=causal, window=window)
    return np.asarray(jnp.moveaxis(out.reshape(b, hq, sq, dh), 1, 2))


def _bf16_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Within one bf16 ulp of max(|got|, |want|) plus the f32 atol (|x| in
    [2^(e-1), 2^e) has a bf16 ulp of 2^(e-8))."""
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return bool(torch.all((got - want).abs() <= ulp + TOL["atol"]))


@pytest.mark.parametrize("b,sq,hq,hkv,dh,causal,window,qc,kc", SWEEP)
def test_matches_the_pallas_kernel_and_its_ref(b, sq, hq, hkv, dh, causal,
                                               window, qc, kc):
    q, k, v = _qkv(b, sq, hq, hkv, dh, sq + hq)
    kernel = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window, q_chunk=qc, kv_chunk=kc))
    naive = _jax_ref(q, k, v, causal, window)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = ops.launches
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert ops.launches == before  # a CPU tensor takes the plain version
    assert got.shape == (b, sq, hq, dh) and got.dtype == torch.float32
    plain = flash_attention_ref(tq, tk, tv, causal, window, q_chunk=qc,
                                kv_chunk=kc)
    for out in (got.numpy(), plain.numpy()):
        np.testing.assert_allclose(out, kernel, **TOL)
        np.testing.assert_allclose(out, naive, **TOL)


@pytest.mark.parametrize("sq,skv,causal,window,qc,kc", [
    (50, 50, True, None, 16, 8),  # ragged last chunks
    (77, 77, True, 20, 16, 16),  # the window skips whole kv chunks
    (45, 45, False, 7, 8, 16),  # non-causal window: keys on both sides
    (40, 40, True, 1, 16, 16),  # the diagonal alone
    (24, 40, True, None, 16, 16),  # Sq != Skv, positions from 0 in both
    (40, 24, True, 8, 16, 8),  # rows past Skv + window see nothing
])
def test_ref_chunking_and_skips(sq, skv, causal, window, qc, kc):
    q, k, v = _qkv(2, sq, 6, 2, 16, sq * 7 + skv, skv)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal,
                              window, q_chunk=qc, kv_chunk=kc).numpy()
    want = _jax_ref(q, k, v, causal, window)
    # A row with no visible key is 0 here, as in the Pallas kernel and the
    # model's chunked attention; the naive JAX softmax gives NaN there.
    blind = np.isnan(want)
    assert blind.any() == (sq > skv and window is not None)
    assert not got[blind].any()
    np.testing.assert_allclose(got[~blind], want[~blind], **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_bf16_within_one_ulp_of_the_jax_ref(causal, window):
    q, k, v = _qkv(2, 100, 14, 2, 64, 5)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    b, sq, hq, dh = q.shape
    flat = [jnp.moveaxis(x, 2, 1).reshape(-1, x.shape[1], dh)
            for x in (jq, jk, jv)]
    want = j_flash_ref(*flat, hq, 2, causal=causal, window=window)
    want = torch.from_numpy(np.array(jnp.moveaxis(
        want.reshape(b, hq, sq, dh), 1, 2).astype(jnp.float32)))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    assert _bf16_close(got, want)


def test_ref_rejects_a_head_count_that_is_no_group():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 6, 4, 16, 0))
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention_ref(q, k, v)
