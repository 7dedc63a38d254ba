"""repro_torch's mixture-of-experts layer and the five LM architectures vs
repro's, on the CPU.

Inputs are made from a seed with numpy; weights are the JAX init's, carried
into the port by ``params_from_jax``.  Tolerances:

- the router's gates within 1e-6 and its expert ids equal (ties, as a zero
  router makes them, go to the lower expert in both);
- a MoE layer's output within 1e-5 of max |JAX| on either dispatch, its aux
  loss within 1e-6 relative, and the (token, slot) entries dropped at
  capacity equal (the kept mask recomputed with ``_moe_einsum``'s own
  one-hot cumsum);
- each LM's prefill and decode logits and loss (aux included) within
  1e-5 (atol and rtol), its gradients within 1e-5 of each leaf's max |g|
  (``jax.grad``): the same f32 arithmetic summed in another order;
- under bf16 the router weights are rounded to bf16 before the f32
  logits, in both packages: the port's routing of the bf16-cast layer
  equals JAX's exactly (ids) and its gates within 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import layers as JL
from repro.models.transformer import TransformerLM as JLM
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import lm_batch_fn
from repro_torch.models import layers as TL
from repro_torch.models.transformer import TransformerLM, params_from_jax
from repro_torch.train.train_loop import to_device

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5  # of each leaf's max |g|
LM_ARCHS = ["qwen3-4b", "smollm-135m", "qwen2-0.5b", "mixtral-8x22b",
            "olmoe-1b-7b"]
MOE_ARCHS = ["olmoe-1b-7b", "mixtral-8x22b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(arch, **kw):
    j, t = j_get_arch(arch).smoke_config, get_arch(arch).smoke_config
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _moe_params(jcfg, seed, router_scale=1.0):
    p = _np(JL.init_moe(jax.random.key(seed), jcfg, jnp.float32))
    p["router"] = (p["router"] * router_scale).astype(np.float32)
    return p


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_kept(expert_idx, moe, g_tok):
    """``_moe_einsum``'s ``within`` mask, [T, k], from JAX's own ops."""
    e, k = moe.num_experts, moe.top_k
    ei = jnp.asarray(expert_idx).reshape(-1, g_tok, k)
    c = max(int(g_tok * k / e * moe.capacity_factor), 1)
    onehot = jax.nn.one_hot(ei, e, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(ei.shape[0], g_tok * k, e), axis=1) - 1.0
    pos = pos.reshape(onehot.shape)
    within = ((pos < c) & (onehot > 0)).any(-1)
    return np.asarray(within).reshape(-1, k)


def _port_kept(expert_idx, moe, g_tok):
    ei = _t(expert_idx).long().reshape(-1, g_tok, moe.top_k)
    pos = TL.capacity_positions(ei, moe.num_experts)
    return (pos < TL.moe_capacity(g_tok, moe)).reshape(-1, moe.top_k).numpy()


# -- the router ---------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("router_scale", [1.0, 0.0])
def test_route_matches_jax(arch, router_scale):
    """With a zero router every expert ties (softmax 1/E): both packages
    pick experts 0..k-1 with equal gates."""
    jc, tc = _cfgs(arch)
    p = _moe_params(jc, 1, router_scale)
    x = _x((37, jc.d_model), 2)
    jg, ji, jaux = JL._route(p, jnp.asarray(x), jc.moe)
    tg, ti, taux = TL.route({k: _t(v) for k, v in p.items()}, _t(x), tc.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if router_scale == 0.0:
        k = tc.moe.top_k
        assert (ti.numpy() == np.arange(k)).all()
        np.testing.assert_allclose(tg.numpy(), 1.0 / k, rtol=1e-6)


def test_route_rounds_the_router_to_bf16_as_jax_does():
    """Under bf16 ``_cast_floats`` rounds every float leaf, the router too,
    then ``xf.astype(f32) @ router`` promotes it back: the port's
    ``_Block.cast`` and ``route`` do the same."""
    jc, tc = _cfgs("olmoe-1b-7b", dtype="bfloat16")
    jlm = JLM(jc)
    params = jlm.init(jax.random.key(4))
    port = TransformerLM(tc, device="cpu")
    port.load_state_dict(params_from_jax(_np(params)))
    layer = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    jcast = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), layer)
    with torch.no_grad():
        tcast = port.blocks[0].cast(torch.bfloat16)
    assert tcast["moe"]["router"].dtype == torch.bfloat16
    x = _x((64, jc.d_model), 5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jg, ji, _ = JL._route(jcast["moe"], xb, jc.moe)
    tg, ti, _ = TL.route(tcast["moe"], _t(np.asarray(xb.astype(jnp.float32)))
                         .to(torch.bfloat16), tc.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    # the rounding matters: the f32 router gives other logits
    f32 = TL.route({k: v.detach() for k, v in port.blocks[0].moe.items()},
                   _t(np.asarray(xb.astype(jnp.float32))), tc.moe)[0]
    assert not torch.equal(f32, tg)


# -- the layer on both dispatches --------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dispatch", ["einsum", "ragged"])
def test_moe_block_matches_jax(arch, dispatch):
    moe_j, moe_t = _cfgs(arch)
    jc = dataclasses.replace(moe_j, moe=dataclasses.replace(
        moe_j.moe, dispatch=dispatch, group_tokens=16))
    tc = dataclasses.replace(moe_t, moe=dataclasses.replace(
        moe_t.moe, dispatch=dispatch, group_tokens=16))
    p = _moe_params(jc, 3)
    x = _x((3, 32, jc.d_model), 4)
    want, jaux = JL.moe_block(p, jnp.asarray(x), jc)
    got, taux = TL.moe_block({k: _t(v) for k, v in p.items()}, _t(x), tc)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_capacity_drops_the_same_entries_as_jax():
    """A router that sends every token to expert 0 first: expert 0 takes C
    entries a group and drops the rest; the same (token, slot) pairs are
    dropped in both packages and the outputs agree."""
    jc, tc = _cfgs("olmoe-1b-7b")
    moe = jc.moe
    p = _moe_params(jc, 6)
    p["router"][:, 0] = 0.0
    x = _x((2, 24, jc.d_model), 7)
    x[..., 0] = np.abs(x[..., 0]) + 1.0  # every token's logit 0 is largest
    p["router"][0, 0] = 50.0
    _, ji, _ = JL._route(p, jnp.asarray(x.reshape(-1, jc.d_model)), moe)
    assert (np.asarray(ji)[:, 0] == 0).all()
    g_tok = TL.moe_group_tokens(48, tc.moe)
    assert g_tok == 16  # 2048 halved until it divides 48
    kept = _port_kept(np.asarray(ji), tc.moe, g_tok)
    np.testing.assert_array_equal(kept, _jax_kept(np.asarray(ji), moe,
                                                  g_tok))
    c = TL.moe_capacity(g_tok, tc.moe)
    assert (~kept[:, 0]).sum() == 48 - 3 * c  # expert 0: C kept a group
    want, _ = JL.moe_block(p, jnp.asarray(x), jc)
    got, _ = TL.moe_block({k: _t(v) for k, v in p.items()}, _t(x), tc)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_odd_token_count_halves_to_groups_of_one():
    """T = 7 tokens: the halving loop reaches groups of one token, where
    the capacity is max(int(k / E * 1.25), 1) = 1 slot an expert."""
    jc, tc = _cfgs("mixtral-8x22b")
    assert TL.moe_group_tokens(7, tc.moe) == 1
    assert TL.moe_capacity(1, tc.moe) == 1
    p = _moe_params(jc, 8)
    x = _x((1, 7, jc.d_model), 9)
    want, _ = JL.moe_block(p, jnp.asarray(x), jc)
    got, _ = TL.moe_block({k: _t(v) for k, v in p.items()}, _t(x), tc)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_super_chunk_branch_matches_jax(monkeypatch):
    """``MOE_SUPER_CHUNK_ELEMS`` lowered in both packages: the sequence
    runs in super-chunks of the group size, one ``moe_einsum`` call each,
    with JAX's result and the one-pass result."""
    moe_j, moe_t = _cfgs("olmoe-1b-7b")
    jc = dataclasses.replace(moe_j, moe=dataclasses.replace(
        moe_j.moe, group_tokens=8))
    tc = dataclasses.replace(moe_t, moe=dataclasses.replace(
        moe_t.moe, group_tokens=8))
    p = _moe_params(jc, 10)
    tp = {k: _t(v) for k, v in p.items()}
    x = _x((2, 32, jc.d_model), 11)
    one_pass, _ = TL.moe_block(tp, _t(x), tc)
    monkeypatch.setattr(JL, "MOE_SUPER_CHUNK_ELEMS", 1.0)
    monkeypatch.setattr(TL, "MOE_SUPER_CHUNK_ELEMS", 1.0)
    calls = []
    einsum = TL.moe_einsum
    monkeypatch.setattr(TL, "moe_einsum",
                        lambda *a: calls.append(a[1].shape) or einsum(*a))
    want, _ = JL.moe_block(p, jnp.asarray(x), jc)
    got, _ = TL.moe_block(tp, _t(x), tc)
    assert calls == [torch.Size([2, 8, jc.d_model])] * 4
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), one_pass.numpy(), rtol=1e-6,
                               atol=1e-6)


# -- the whole LM, every architecture ----------------------------------------

@functools.lru_cache(maxsize=None)
def _carry(arch, seed=0):
    jc, tc = _cfgs(arch)
    jlm = JLM(jc)
    params = jax.jit(jlm.init)(jax.random.key(seed))
    port = TransformerLM(tc, device="cpu")
    port.load_state_dict(params_from_jax(_np(params)), strict=True)
    return jlm, params, port


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_jax(arch, monkeypatch):
    """Prefill of 2 x 24 tokens, then 8 decode steps of 4 sequences from
    an empty cache of 12 positions (a sliding window wraps its ring); at
    B = 4 a MoE step's single group drops entries at capacity."""
    jlm, params, port = _carry(arch)
    cfg = port.cfg
    toks = lm_batch_fn(4, 24, cfg.vocab_size)(3, 0)["tokens"]
    want = np.asarray(jax.jit(jlm.prefill)(params, jnp.asarray(toks[:2])))
    dropped = []
    with torch.inference_mode():
        for use_kernel in (True, False):
            got = port.prefill(_t(toks[:2]), use_kernel=use_kernel)
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        jcache, cache = jlm.init_cache(4, 12), port.init_cache(4, 12)
        step = jax.jit(jlm.decode_step)
        positions = TL.capacity_positions

        def counting(expert_idx, n):
            pos = positions(expert_idx, n)
            c = TL.moe_capacity(expert_idx.shape[1], cfg.moe)
            dropped.append(int((pos >= c).sum()))
            return pos

        monkeypatch.setattr(TL, "capacity_positions", counting)
        for pos in range(8):
            wl, jcache = step(params, jcache, jnp.asarray(toks[:, pos]),
                              jnp.int32(pos))
            gl, cache = port.decode_step(cache, _t(toks[:, pos]), pos)
            np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    if arch == "olmoe-1b-7b":
        assert sum(dropped) > 0  # decode drops tokens too


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` (ce + the layers' aux) and its gradients against
    ``jax.grad`` of JAX's, remat on as the configs set it."""
    jlm, params, port = _carry(arch)
    cfg = port.cfg
    assert cfg.remat
    batch = lm_batch_fn(2, 20, cfg.vocab_size)(1, 0)
    batch["loss_mask"][1, 13:] = 0.0
    (jl, jm), jg = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    named = dict(port.named_parameters())
    loss, metrics = port.loss_fn(to_device(batch, "cpu"))
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), **TOL)
    assert (float(jm["aux"]) > 0) == (cfg.moe is not None)
    want = params_from_jax(_np(jg))
    assert set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * max(float(np.abs(w).max()), 1e-30), (k, err)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dispatch", ["einsum", "ragged"])
def test_bf16_moe_block_within_two_ulps_of_jax(arch, dispatch):
    """The layer under bf16 compute, on the same bf16 weights and inputs:
    the same expert ids, and the output within two bf16 ulps of max |JAX|
    (the two round the products' f32 sums to bf16 at other points, and a
    token sums k rounded expert outputs; the einsum dispatch rounds the
    gates to bf16 first, the ragged one multiplies in the outputs'
    bf16)."""
    jc, tc = _cfgs(arch, dtype="bfloat16")
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                         dispatch=dispatch))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                         dispatch=dispatch))
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                               _moe_params(jc, 12))
    x = jnp.asarray(_x((2, 32, jc.d_model), 13), jnp.bfloat16)
    want, _ = JL.moe_block(p, x, jc)
    _, ji, _ = JL._route(p, x.reshape(-1, jc.d_model), jc.moe)

    def bf16(a):
        return _t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    tp = {k: bf16(v) for k, v in p.items()}
    got, _ = TL.moe_block(tp, bf16(x), tc)
    _, ti, _ = TL.route(tp, bf16(x).reshape(-1, tc.d_model), tc.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.frexp(np.abs(w).max())[1] - 8)
    assert np.abs(got.float().numpy() - w).max() <= 2 * ulp
