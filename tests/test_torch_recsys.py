"""repro_torch's recsys serving path vs repro's, on the CPU.

The JAX models are initialised by their own ``init`` and their weights
carried into the port by ``params_from_jax``; batches come from
``make_recsys_batch`` (numpy, one seed) and go through both.  Tolerance
atol = rtol = 1e-5 on logits and retrieval scores: the same f32
arithmetic in another order.  Each model runs at ``SMOKE`` and at its full
width with the tables cut (``FULL`` with the smoke vocabularies and 200
items: D, the towers, the CIN, ``seq_len`` and ``gru_dim`` stay), with
``sparse_ids`` single-hot [B, F], one-hot bags [B, F, 1] and bags of 3
with -1 pads after position 0 (xDeepFM's linear term reads position 0;
the reference gives a pad there no meaning).  On the CPU the multi-hot
lookups take the kernel entry's plain version.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same_topk
from repro.configs import autoint as j_autoint
from repro.configs import dien as j_dien
from repro.configs import din as j_din
from repro.configs import xdeepfm as j_xdeepfm
from repro.data.synthetic import make_recsys_batch as j_make_recsys_batch
from repro.models.recsys import build_model as j_build_model
from repro.models.recsys.dien import gru_cell as j_gru_cell
from repro.models.recsys.dien import run_gru as j_run_gru
from repro.models.recsys.din import dice as j_dice
from repro_torch.configs import autoint, dien, din, xdeepfm
from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.recsys_common import SMOKE_39, SMOKE_CTX
from repro_torch.core.topk import topk
from repro_torch.data.synthetic import make_recsys_batch
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models.recsys import build_model, params_from_jax
from repro_torch.models.recsys.dien import gru_cell, run_gru
from repro_torch.models.recsys.din import dice

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {"xdeepfm": (j_xdeepfm, xdeepfm), "autoint": (j_autoint, autoint),
           "din": (j_din, din), "dien": (j_dien, dien)}
BATCH, CANDIDATES, K = 8, 96, 10


def _configs(model: str, width: str):
    """(JAX config, port config): SMOKE, or FULL with its tables cut."""
    jmod, tmod = CONFIGS[model]
    if width == "smoke":
        return jmod.SMOKE, tmod.SMOKE
    cut = dict(vocab_sizes=SMOKE_39 if model in ("xdeepfm", "autoint")
               else SMOKE_CTX, item_vocab=jmod.FULL.item_vocab and 200)
    return (dataclasses.replace(jmod.FULL, **cut),
            dataclasses.replace(tmod.FULL, **cut))


@functools.lru_cache(maxsize=None)
def _carried(model: str, width: str):
    """The JAX model's config and params, one jitted function of its
    ``forward`` and ``score_candidates`` (one compile a batch shape), and
    the port's model carrying those params, on the CPU."""
    jc, tc = _configs(model, width)
    jm = j_build_model(jc)
    params = jax.jit(jm.init)(jax.random.key(1))
    port = build_model(tc, device="cpu")
    port.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)

    def serve(params, batch, user, cand):
        return (jm.forward(params, batch),
                jm.score_candidates(params, user, cand))

    return jc, params, jax.jit(serve), port


def _batch(cfg, hot: int, seed: int = 2) -> dict:
    b = make_recsys_batch(BATCH, cfg.n_sparse, list(cfg.vocab_sizes),
                          cfg.seq_len, cfg.item_vocab, multi_hot=max(hot, 1),
                          seed=seed)
    if hot == 0:
        b["sparse_ids"] = b["sparse_ids"][:, :, 0]
    elif hot == 3:
        b["sparse_ids"][:, ::2, 1:] = -1  # even fields: one live id
        b["sparse_ids"][0, :, 2] = -1
    return b


@pytest.mark.parametrize("seq,items,hot", [(0, 0, 1), (12, 200, 1),
                                           (100, 1000, 8)])
def test_make_recsys_batch_gives_the_jax_numbers(seq, items, hot):
    vocab = [97, 53, 31, 17]
    want = j_make_recsys_batch(6, 4, vocab, seq, items, hot, seed=9)
    got = make_recsys_batch(6, 4, vocab, seq, items, hot, seed=9)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["sparse_ids"].shape == (6, 4, hot)


@pytest.mark.parametrize("shape", [(8, 5), (1, 7), (4, 3, 6)])
def test_dice_matches_jax(shape):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32) * 3
    want = np.asarray(j_dice(jnp.asarray(x)))
    got = dice(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if shape[0] == 1:  # batch statistics of one row: p = 0.5
        np.testing.assert_allclose(got, 0.625 * x, **TOL)


@pytest.mark.parametrize("with_attn", [False, True])
def test_gru_cell_and_run_gru_match_jax(with_attn):
    rng = np.random.default_rng(4)
    b, s, d_in, d_h = 5, 7, 6, 9
    p = {"w": rng.normal(size=(d_in, 3 * d_h)), "u": rng.normal(
        size=(d_h, 3 * d_h)), "b": rng.normal(size=(3 * d_h,))}
    p = {k: (v * 0.3).astype(np.float32) for k, v in p.items()}
    h = rng.normal(size=(b, d_h)).astype(np.float32)
    xs = rng.normal(size=(b, s, d_in)).astype(np.float32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    attn = rng.random((b, s)).astype(np.float32) if with_attn else None
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    a0 = None if attn is None else attn[:, 0]
    want = np.asarray(j_gru_cell(jp, jnp.asarray(h), jnp.asarray(xs[:, 0]),
                                 None if a0 is None else jnp.asarray(a0)))
    got = gru_cell(tp, torch.from_numpy(h), torch.from_numpy(xs[:, 0]),
                   None if a0 is None else torch.from_numpy(a0))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    w_last, w_all = j_run_gru(jp, jnp.asarray(xs), jnp.asarray(mask),
                              None if attn is None else jnp.asarray(attn))
    g_last, g_all = run_gru(tp, torch.from_numpy(xs), torch.from_numpy(mask),
                            None if attn is None else torch.from_numpy(attn))
    np.testing.assert_allclose(g_last.numpy(), np.asarray(w_last), **TOL)
    np.testing.assert_allclose(g_all.numpy(), np.asarray(w_all), **TOL)


@pytest.mark.parametrize("hot", [0, 1, 3])
@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("model", list(CONFIGS))
def test_forward_and_retrieval_match_jax(model, width, hot):
    jc, params, j_serve, port = _carried(model, width)
    batch = _batch(jc, hot)
    cand = np.arange(CANDIDATES, dtype=np.int32)
    user = {k: v[:1] for k, v in batch.items()}
    want, want_s = (np.asarray(x) for x in j_serve(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in user.items()}, jnp.asarray(cand)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = bag_ops.launches
    with torch.inference_mode():
        got = port(tbatch)
        assert torch.equal(got, port(tbatch, use_kernel=False))
    assert bag_ops.launches == before
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    # retrieval_cand: one user, every candidate scored, then top-K
    with torch.inference_mode():
        got_s = port.score_candidates(
            {k: torch.from_numpy(v) for k, v in user.items()},
            torch.from_numpy(cand))
    np.testing.assert_allclose(got_s.numpy(), want_s, **TOL)
    rv, ri = jax.lax.top_k(jnp.asarray(want_s), K)
    pv, pi = topk(got_s, K)
    assert_same_topk((pv.numpy(), cand[pi.numpy()]),
                     (np.asarray(rv), cand[np.asarray(ri)]),
                     want_s.astype(np.float64))


@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("model", list(CONFIGS))
def test_seeded_init_has_the_jax_names_and_shapes(model, width):
    jc, tc = _configs(model, width)
    shapes = jax.eval_shape(j_build_model(jc).init, jax.random.key(0))
    want = {k: tuple(v.shape) for k, v in params_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               shapes)).items()}
    port = build_model(tc, device="cpu", seed=3)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    assert all(v.dtype == torch.float32 for v in port.state_dict().values())
    again = build_model(tc, device="cpu", seed=3)
    assert all(torch.equal(v, again.state_dict()[k])
               for k, v in port.state_dict().items())


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for _, tmod in CONFIGS.values():
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(tmod.SMOKE)
        with pytest.raises(RuntimeError, match="cuda"):
            type(build_model(tmod.SMOKE, device="cpu"))(tmod.SMOKE)


def test_config_keeps_the_jax_fields_and_refuses_another_dtype():
    for jmod, tmod in CONFIGS.values():
        for name in ("FULL", "SMOKE"):
            assert dataclasses.asdict(getattr(tmod, name)) == \
                dataclasses.asdict(getattr(jmod, name))
        assert tmod.FULL.total_rows() == jmod.FULL.total_rows()
    assert sum(xdeepfm.FULL.vocab_sizes) == 16_596_850
    with pytest.raises(NotImplementedError, match="float32"):
        dataclasses.replace(din.SMOKE, dtype="bfloat16")
    assert RecsysConfig(name="x", model="din", n_sparse=1,
                        embed_dim=4).dtype == "float32"
