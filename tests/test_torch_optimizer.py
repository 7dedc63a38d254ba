"""repro_torch's AdamW, schedule and clipping vs repro's, on the CPU.

The optimizer is held apart from the gradients: the same numpy params,
grads and state go through the JAX functions and the port's.  Tolerance
rtol = 1e-6 plus atol = 1e-6 x the leaf's max |value|: the f32 rounding of
the same operations, which the two compilers may contract or order a
little differently (the global norm sums in another order, so the clip
scale may differ by an ulp, and ``b1 m + (1 - b1) g`` cancels where the
two terms nearly meet, which turns that ulp into a larger relative error of
a small moment, never a larger one than the terms' own ulps).  The
decay mask is read from parameter names; it must agree with the JAX
mask, which reads the last key of each pytree path, on every name of the
port's models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import autoint as j_autoint
from repro.configs import dien as j_dien
from repro.configs import din as j_din
from repro.configs import gpusparse as j_gpusparse
from repro.configs import qwen2_0_5b as j_qwen
from repro.configs import xdeepfm as j_xdeepfm
from repro.models.recsys import build_model as j_build_model
from repro.models.splade import SpladeEncoder as JEncoder
from repro.models.transformer import TransformerLM as JLM
from repro.train import optimizer as jopt
from repro_torch.configs import autoint, dien, din, gpusparse, qwen2_0_5b
from repro_torch.configs import xdeepfm
from repro_torch.models.recsys import build_model
from repro_torch.models.recsys import params_from_jax as recsys_from_jax
from repro_torch.models.splade import SpladeEncoder
from repro_torch.models.transformer import TransformerLM, params_from_jax
from repro_torch.train import optimizer as opt

RTOL = 1e-6

# Names of every decay-mask case, with the JAX answer: norms, biases and
# the head bias stay; matrices, a list item (xDeepFM's cin.<i>: no key in
# JAX, so ""), the embedding and the field tables decay.
MASK_CASES = {
    "blocks.0.ln_attn": False, "blocks.1.ln_mlp": False, "ln_f": False,
    "mlm_bias": False, "blocks.0.attn.bq": False, "blocks.0.attn.bk": False,
    "blocks.0.attn.bv": False, "blocks.0.attn.q_norm": False,
    "blocks.0.attn.k_norm": False, "b_out": False, "mlp.layers.0.b": False,
    "mlp.head.b": False, "gru1.b": False, "blocks.0.attn.wq": True,
    "blocks.0.mlp.w_up": True, "cin.0": True, "cin.1": True, "embed": True,
    "fields.table": True, "linear.table": True, "item_table": True,
    "gru1.w": True, "gru2.u": True, "attn_proj": True, "w_cin": True,
    "mlp.layers.1.w": True,
}


def _nest(flat: dict):
    """Dotted names -> the JAX pytree of dicts, with a list where a key is
    an index (so that the JAX path of ``cin.0`` ends in a list item)."""
    tree: dict = {}
    for name, v in flat.items():
        node, parts = tree, name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def _dotted(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                    for p in path)


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {name: (rng.normal(size=(3, 5)) * scale).astype(np.float32)
            for name in MASK_CASES}


@pytest.mark.parametrize("warmup,total,min_frac", [
    (10, 100, 0.1), (0, 37, 0.0), (1, 5, 0.1), (100, 10_000, 0.1),
    (20, 20, 0.5),
])
def test_schedule_at_every_step(warmup, total, min_frac):
    cfg = dict(lr=2e-3, warmup_steps=warmup, total_steps=total,
               min_lr_frac=min_frac)
    jlr = jax.jit(jopt.cosine_schedule(jopt.AdamWConfig(**cfg)))
    lr = opt.cosine_schedule(opt.AdamWConfig(**cfg))
    steps = np.arange(0, total + 3, dtype=np.int32)
    want = np.asarray(jax.vmap(jlr)(jnp.asarray(steps)))
    got = np.array([lr(torch.tensor(s)).item() for s in steps], np.float32)
    assert lr(torch.tensor(0)).dtype == torch.float32
    # Near the end of a cosine to 0, 1 + cos(pi t) cancels: one f32 ulp of
    # cos there is ~6e-8 of lr, absolute.
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7 * cfg["lr"])
    assert float(lr(5)) == pytest.approx(float(jlr(jnp.int32(5))), rel=RTOL)


def test_adamw_config_fields_and_defaults():
    assert ([(f.name, f.default) for f in dataclasses.fields(opt.AdamWConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jopt.AdamWConfig)])


def test_decay_mask_cases():
    tree = _nest(_tree(0))
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(paths) == len(MASK_CASES)
    for path, _ in paths:
        name = _dotted(path)
        assert jopt._decay_mask(path) == MASK_CASES[name], name
        assert opt.decay_mask(name) == MASK_CASES[name], name


def _masks_of(jax_params, from_jax) -> dict:
    """The JAX mask of each leaf as a full array, carried to the port's
    names by the model family's ``params_from_jax``."""
    masks = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(x.shape, jopt._decay_mask(p)), jax_params)
    return {k: bool(v.all()) for k, v in from_jax(masks).items()}


@pytest.mark.parametrize("model", ["encoder", "lm", "xdeepfm", "autoint",
                                   "din", "dien"])
def test_decay_mask_agrees_on_every_parameter_of_the_models(model):
    if model == "encoder":
        jm, port = JEncoder(j_gpusparse.ENCODER_SMOKE), SpladeEncoder(
            gpusparse.ENCODER_SMOKE, device="cpu")
        from_jax = params_from_jax
    elif model == "lm":
        jm, port = JLM(j_qwen.SMOKE), TransformerLM(qwen2_0_5b.SMOKE,
                                                     device="cpu")
        from_jax = params_from_jax
    else:
        jmod = {"xdeepfm": j_xdeepfm, "autoint": j_autoint, "din": j_din,
                "dien": j_dien}[model]
        tmod = {"xdeepfm": xdeepfm, "autoint": autoint, "din": din,
                "dien": dien}[model]
        jm, port = j_build_model(jmod.SMOKE), build_model(tmod.SMOKE,
                                                          device="cpu")
        from_jax = recsys_from_jax
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    want = _masks_of(shapes, from_jax)
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(want)
    assert {n: opt.decay_mask(n) for n in names} == want


def _jax_state(mu, nu, step):
    return {"step": jnp.int32(step), "mu": _nest(mu), "nu": _nest(nu)}


@pytest.mark.parametrize("clip,decay", [(1.0, 0.1), (0.0, 0.1), (1.0, 0.0),
                                        (1e3, 0.3)])
def test_adamw_update_three_steps_on_identical_inputs(clip, decay):
    """Each step gets identical params, grads and state on both sides (the
    port's outputs of the step before), so an error cannot compound."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip,
               weight_decay=decay)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    jupdate = jax.jit(lambda g, p, s: jopt.adamw_update(
        _nest(g), _nest(p), s, jcfg))
    params = _tree(1)
    mu = {k: np.zeros_like(v) for k, v in params.items()}
    nu = {k: np.zeros_like(v) for k, v in params.items()}
    flat = lambda t: {_dotted(p): np.asarray(x)  # noqa: E731
                      for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
    for step in range(3):
        grads = _tree(10 + step, scale=0.5 + step)
        jp, js, jm = jupdate(grads, params, _jax_state(mu, nu, step))
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        ts = {"step": torch.tensor(step, dtype=torch.int32),
              "mu": {k: torch.from_numpy(v.copy()) for k, v in mu.items()},
              "nu": {k: torch.from_numpy(v.copy()) for k, v in nu.items()}}
        tg = {k: torch.from_numpy(v) for k, v in grads.items()}
        before = {k: v.clone() for k, v in tg.items()}
        out_p, out_s, tm = opt.adamw_update(tg, tp, ts, tcfg)
        assert out_p is tp and out_s is ts  # updated in place
        assert all(torch.equal(tg[k], before[k]) for k in tg)  # read only
        assert int(ts["step"]) == step + 1 and ts["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        for mine, theirs in ((tp, flat(jp)), (ts["mu"], flat(js["mu"])),
                             (ts["nu"], flat(js["nu"]))):
            assert set(mine) == set(theirs)
            for k in mine:
                np.testing.assert_allclose(
                    mine[k].numpy(), theirs[k], rtol=RTOL,
                    atol=RTOL * np.abs(theirs[k]).max(), err_msg=k)
        params = {k: v.numpy() for k, v in tp.items()}
        mu = {k: v.numpy() for k, v in ts["mu"].items()}
        nu = {k: v.numpy() for k, v in ts["nu"].items()}


def test_adamw_init_is_zero_moments_at_step_zero():
    params = {k: torch.from_numpy(v) for k, v in _tree(2).items()}
    state = opt.adamw_init(params)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for k, p in params.items():
        for m in (state["mu"][k], state["nu"][k]):
            assert m.dtype == torch.float32 and m.shape == p.shape
            assert not m.any() and m.data_ptr() != p.data_ptr()


def test_global_norm_and_clip_match_jax():
    tree = _tree(3, scale=4.0)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    np.testing.assert_allclose(float(opt.global_norm(tt)),
                               float(jopt.global_norm(jt)), rtol=RTOL)
    for max_norm in (1.0, 1e4):
        jc, jn = jopt.clip_by_global_norm(jt, max_norm)
        tc, tn = opt.clip_by_global_norm(tt, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        for k in tree:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=RTOL)
        assert torch.equal(tt[k], torch.from_numpy(tree[k]))  # not in place


def test_grad_clip():
    """``tests/test_train_infra.py::test_grad_clip`` on the port."""
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    zero, norm = opt.clip_by_global_norm({"a": torch.zeros(3)}, 1.0)
    assert float(norm) == 0.0 and not zero["a"].any()


def test_adamw_schedule_shape():
    """``tests/test_train_infra.py::test_adamw_schedule_shape`` on the
    port."""
    sched = opt.cosine_schedule(opt.AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1))
    assert float(sched(0)) == 0.0
    assert abs(float(sched(10)) - 1e-3) < 1e-9
    assert float(sched(100)) == pytest.approx(1e-4, rel=1e-3)
