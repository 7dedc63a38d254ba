"""Fixture: capability flags drifting from the wired functions, a serve
factory without the port's make_serve_step keywords (compute_dtype among
them), and an engine-name string branch.  registry-conformance must flag
every marked definition."""
from repro_torch.core.registry import register_engine, register_serve_factory


def _build(docs, cfg):
    return docs


@register_engine("fixture-tau", build_index=_build, supports_tau=True)
def score_no_tau(queries, index, cfg, k=None):  # BAD: no tau_init
    return None


@register_engine("fixture-pruned", build_index=_build, pruned=True,
                 supports_deletes=True)
def score_pruned(queries, index, cfg, k=None,  # BAD: no bounds=
                 tau_init=None, deleted_mask=None):
    return None


@register_serve_factory("fixture-factory")
def make_fixture_step(ctx, *, k, docs_per_shard,  # BAD: no compute_dtype
                      geometry, cfg, hierarchical_merge):
    return None


def pick_block(cfg):
    if cfg.engine == "tiled-pruned":  # BAD: a string branch
        return 128
    return 256
