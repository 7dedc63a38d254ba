"""repro_torch's architecture registry vs repro's, on the CPU.

``list_archs()`` is JAX's, ``schnet`` included, and every registered
``ArchSpec`` equals JAX's field for field: config and smoke config (nested
``MoEConfig``, ``SchNetConfig`` and encoder configs too), shapes,
skip_shapes, source and notes.  The port's transformer config lacks three
JAX knobs that nothing in it reads (``scan_layers``, ``attn_unroll``,
``seq_parallel``); every registered config leaves them at JAX's defaults.
Parameter counts are JAX's analytic ones, dense and active.
"""
import dataclasses

import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as j_get_arch
from repro.configs import list_archs as j_list_archs
from repro.models.transformer import TransformerLM as JLM
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch, list_archs
from repro_torch.models.transformer import TransformerLM

UNREAD = {"scan_layers", "attn_unroll"}  # XLA lowering knobs
ARCHS = sorted(j_list_archs())


def _same(port, ref, path="") -> None:
    """``port`` equals ``ref`` field for field (dataclasses recursively);
    a JAX field the port lacks must be an unread knob at its default."""
    if dataclasses.is_dataclass(ref):
        assert type(port).__name__ == type(ref).__name__, path
        tnames = {f.name for f in dataclasses.fields(port)}
        for f in dataclasses.fields(ref):
            if f.name in tnames:
                _same(getattr(port, f.name), getattr(ref, f.name),
                      f"{path}.{f.name}")
            else:
                assert f.name in UNREAD, f"{path}.{f.name}"
                assert getattr(ref, f.name) == f.default, f"{path}.{f.name}"
        assert tnames <= {f.name for f in dataclasses.fields(ref)}, path
    elif isinstance(ref, tuple) and ref and dataclasses.is_dataclass(ref[0]):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _same(p, r, f"{path}[{i}]")
    else:
        assert port == ref, path


def test_list_archs_is_jax_less_schnet():
    # The name is older than the port's SchNet: the registry is now JAX's
    # whole, schnet included.
    assert list_archs() == ARCHS
    assert "schnet" in list_archs()
    assert get_arch("schnet").family == "gnn"
    with pytest.raises(KeyError, match="no-such-arch"):
        get_arch("no-such-arch")


# qwen2-0.5b is the case that test_torch_lm.py held alone before the
# registry existed.
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_jax_ones_field_for_field(arch):
    _same(get_arch(arch), j_get_arch(arch), arch)


def test_shape_grids_and_moe_config_copy_jax():
    _same(tbase.LM_SHAPES, jbase.LM_SHAPES, "LM_SHAPES")
    _same(tbase.RECSYS_SHAPES, jbase.RECSYS_SHAPES, "RECSYS_SHAPES")
    _same(tbase.GNN_SHAPES, jbase.GNN_SHAPES, "GNN_SHAPES")
    _same(tbase.SchNetConfig(name="s"), jbase.SchNetConfig(name="s"),
          "SchNetConfig")
    _same(tbase.MoEConfig(num_experts=4, top_k=2),
          jbase.MoEConfig(num_experts=4, top_k=2), "MoEConfig")


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if j_get_arch(a).family == "lm"])
def test_param_counts_are_jax_and_the_smoke_init_holds_them(arch):
    t, j = get_arch(arch), j_get_arch(arch)
    for tc, jc in ((t.config, j.config), (t.smoke_config, j.smoke_config)):
        assert tc.num_params() == jc.num_params()
        assert tc.num_active_params() == jc.num_active_params()
    # the port's init holds num_params() leaves, plus the qkv biases and
    # the qk norms (which neither counts), in JAX's shapes
    import jax
    import numpy as np

    from repro_torch.models.transformer import params_from_jax

    jstate = params_from_jax(jax.tree_util.tree_map(
        np.asarray, JLM(j.smoke_config).init(jax.random.key(0))))
    port = TransformerLM(t.smoke_config, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    state = port.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in jstate.items()}
    uncounted = sum(v.numel() for k, v in state.items()
                    if k.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "q_norm",
                                                "k_norm"))
    assert t.smoke_config.num_params() + uncounted == sum(
        v.numel() for v in state.values())


def test_unread_knobs_and_unknown_dispatch_are_refused():
    cfg = get_arch("olmoe-1b-7b").smoke_config
    for knob in sorted(UNREAD):
        with pytest.raises(TypeError):
            dataclasses.replace(cfg, **{knob: True})
    # sequence parallelism is read (under a policy with a model axis)
    assert dataclasses.replace(cfg, seq_parallel=True).seq_parallel
    with pytest.raises(ValueError, match="dispatch"):
        tbase.MoEConfig(num_experts=4, top_k=2, dispatch="sorted")
    with pytest.raises(NotImplementedError):
        dataclasses.replace(cfg, param_dtype="bfloat16")


def test_register_refuses_a_duplicate():
    spec = get_arch("smollm-135m")
    with pytest.raises(ValueError, match="duplicate"):
        tbase.register(spec)
