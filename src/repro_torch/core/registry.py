"""Engine registry — the single seam every dispatcher goes through.

As in :mod:`repro.core.registry`, an engine is one :class:`EngineSpec`
registered once with ``@register_engine``: ``build_index(docs, cfg)`` and
``score(queries, index, cfg, k=None, tau_init=None)`` returning a
[B, num_docs] score matrix.  ``get_engine`` raises with the registered
list on an unknown name.

Registered here: ``dense``, ``tiled`` (the ``scatter_score`` kernel),
``ell`` (the ``ell_gather`` kernel), and the pruned engines
``tiled-pruned`` (BMP sweep or two-pass), ``tiled-pruned-approx``
(``theta``), ``tiled-bmp-grouped`` (one sweep a demand group) and
``tiled-bmp-fused`` (one sweep a power-of-two bucket), which run the
``bmp_scan`` kernel (the two-pass traversal runs ``scatter_score``).  The
JAX names ``pallas`` and ``pallas_ell`` would be the very same kernels as
``tiled`` and ``ell`` in the port, so they are not registered.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core import index as index_mod
from repro_torch.core import scoring
from repro_torch.core.index import EllIndex, TiledIndex
from repro_torch.core.sparse import SparseBatch
from repro_torch.kernels.bmp_scan import ops as bmp_ops


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One scoring engine: how to build its index and how to score with it.

    ``cfg`` is duck-typed (any object with the :class:`RetrievalConfig`
    attributes), so the registry never imports the engine layer.
    """

    name: str
    build_index: Callable[[SparseBatch, Any], Any]
    score: Callable[..., Any]
    # Pruned engines only: (queries, index) -> [B, num_doc_blocks] upper
    # bounds dominating every true doc score in the block.
    bounds: Optional[Callable[..., Any]] = None
    # Pruned engines only: (queries, index, cfg, k) -> PruneStats, the
    # ``RetrievalEngine.prune_stats`` seam.
    stats: Optional[Callable[..., Any]] = None
    index_type: Optional[type] = None  # None: the "index" is the docs batch
    pruned: bool = False  # masks docs outside the top-k to -inf
    supports_tau: bool = False  # consumes tau_init warm-start thresholds
    supports_theta: bool = False  # honours cfg.theta (approximate mode)
    # Pruned engines that also honour cfg.traversal="two-pass".
    supports_two_pass: bool = False
    # Refines supports_tau for engines whose tau use depends on the config.
    consumes_tau: Optional[Callable[[Any], bool]] = None
    # The score fn takes ``deleted_mask=`` ([num_docs] bool, index doc
    # numbering) and masks tombstones inside the traversal, so they never
    # certify a pruning threshold; mandatory for pruned engines, where
    # post-hoc masking is unsafe.  Exact engines get post-hoc masking.
    supports_deletes: bool = False
    doc: str = ""


_REGISTRY: dict[str, EngineSpec] = {}


def register_engine(
    name: str,
    *,
    build_index: Callable[[SparseBatch, Any], Any],
    bounds: Optional[Callable[..., Any]] = None,
    stats: Optional[Callable[..., Any]] = None,
    index_type: Optional[type] = None,
    pruned: bool = False,
    supports_tau: bool = False,
    supports_theta: bool = False,
    supports_two_pass: bool = False,
    consumes_tau: Optional[Callable[[Any], bool]] = None,
    supports_deletes: bool = False,
    doc: str = "",
):
    """Decorator: register ``score_fn`` as engine ``name`` (returned
    unchanged)."""

    def deco(score_fn):
        if name in _REGISTRY:
            raise ValueError(f"engine {name!r} is already registered")
        _REGISTRY[name] = EngineSpec(
            name=name,
            build_index=build_index,
            score=score_fn,
            bounds=bounds,
            stats=stats,
            index_type=index_type,
            pruned=pruned,
            supports_tau=supports_tau,
            supports_theta=supports_theta,
            supports_two_pass=supports_two_pass,
            consumes_tau=consumes_tau,
            supports_deletes=supports_deletes,
            doc=doc,
        )
        return score_fn

    return deco


def available_engines() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_engine(name: str) -> EngineSpec:
    """Look up an engine; unknown names fail with the registered list."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered engines: "
            f"{', '.join(available_engines())}"
        ) from None


def config_supports_tau(cfg) -> bool:
    """Whether this config's scorer consumes a tau warm-start."""
    spec = get_engine(cfg.engine)
    if not spec.supports_tau:
        return False
    if spec.consumes_tau is not None:
        return bool(spec.consumes_tau(cfg))
    return True


# ---------------------------------------------------------------------------
# Engine registrations.  Build wrappers thread the config's index geometry.


def _build_docs(docs: SparseBatch, cfg) -> SparseBatch:
    return docs


def _build_tiled(docs: SparseBatch, cfg) -> TiledIndex:
    return index_mod.build_tiled_index(
        docs,
        term_block=cfg.term_block,
        doc_block=cfg.doc_block,
        chunk_size=cfg.chunk_size,
    )


def _build_tiled_pruned(docs: SparseBatch, cfg) -> TiledIndex:
    return index_mod.build_tiled_index(
        docs,
        term_block=cfg.term_block,
        doc_block=cfg.doc_block,
        chunk_size=cfg.chunk_size,
        store_term_block_max=True,
        bounds_format=getattr(cfg, "bounds_format", "dense"),
    )


def _build_ell(docs: SparseBatch, cfg) -> EllIndex:
    return index_mod.build_ell_index(docs)


@register_engine("dense", build_index=_build_docs,
                 doc="dense matmul oracle (paper's GPU Dense MatMul)")
def _score_dense(queries, index, cfg, k=None, tau_init=None):
    return scoring.score_dense(queries, index)


@register_engine("tiled", build_index=_build_tiled, index_type=TiledIndex,
                 doc="term-parallel tiled scatter-add (CUDA scatter_score)")
def _score_tiled(queries, index, cfg, k=None, tau_init=None):
    if getattr(cfg, "tile_skip", False):
        index = index_mod.filter_tiled_index(index, queries)
    return scoring.score_tiled(queries, index)


def _sched_knobs(cfg) -> dict:
    return dict(top_m=cfg.sched_top_m, max_group=cfg.sched_max_group,
                min_share=cfg.sched_min_share,
                plan_cache=getattr(cfg, "plan_cache", None),
                obs=getattr(cfg, "obs", None))


def _stats_block_max(queries, index, cfg, k, deleted_mask=None):
    """Skip observability of the block-max engines: the configured
    traversal rerun with ``return_stats``."""
    if cfg.traversal == "two-pass":
        _, st = scoring.score_tiled_pruned(
            queries, index, k=k, seed_blocks=cfg.prune_seed_blocks,
            return_stats=True, deleted_mask=deleted_mask,
        )
    else:
        _, st = scoring.score_tiled_bmp(
            queries, index, k=k, theta=cfg.theta, return_stats=True,
            deleted_mask=deleted_mask,
        )
    return st


def _stats_grouped(queries, index, cfg, k, deleted_mask=None):
    """The grouped engine's stats reduced to the flat-comparable union."""
    _, st = scoring.score_tiled_bmp_grouped(
        queries, index, k=k, return_stats=True, deleted_mask=deleted_mask,
        **_sched_knobs(cfg),
    )
    return st.union


def _stats_fused(queries, index, cfg, k, deleted_mask=None):
    """The fused engine's stats reduced to the flat-comparable union."""
    _, st = bmp_ops.bmp_scan(
        queries, index, k=k, return_stats=True, deleted_mask=deleted_mask,
        **_sched_knobs(cfg),
    )
    return st.union


@register_engine("tiled-pruned", build_index=_build_tiled_pruned,
                 index_type=TiledIndex, bounds=scoring.block_upper_bounds,
                 stats=_stats_block_max,
                 pruned=True, supports_tau=True, supports_two_pass=True,
                 consumes_tau=lambda cfg: cfg.traversal != "two-pass",
                 supports_deletes=True,
                 doc="safe block-max pruning (BMP sweep or two-pass seed)")
def _score_tiled_pruned(queries, index, cfg, k=None, tau_init=None,
                        deleted_mask=None):
    k = k or cfg.k
    if cfg.traversal == "two-pass":
        if tau_init is not None:
            raise ValueError(
                "tau warm-start needs traversal='bmp' "
                "(the two-pass sweep re-seeds per call)"
            )
        return scoring.score_tiled_pruned(
            queries, index, k=k, seed_blocks=cfg.prune_seed_blocks,
            deleted_mask=deleted_mask,
        )
    return scoring.score_tiled_bmp(queries, index, k=k, tau_init=tau_init,
                                   deleted_mask=deleted_mask)


@register_engine("tiled-pruned-approx", build_index=_build_tiled_pruned,
                 index_type=TiledIndex, bounds=scoring.block_upper_bounds,
                 stats=_stats_block_max,
                 pruned=True, supports_tau=True, supports_theta=True,
                 supports_deletes=True,
                 doc="BMP sweep with theta-scaled bounds (bounded recall)")
def _score_tiled_pruned_approx(queries, index, cfg, k=None, tau_init=None,
                               deleted_mask=None):
    return scoring.score_tiled_bmp(
        queries, index, k=k or cfg.k, theta=cfg.theta, tau_init=tau_init,
        deleted_mask=deleted_mask,
    )


@register_engine("tiled-bmp-grouped", build_index=_build_tiled_pruned,
                 index_type=TiledIndex, bounds=scoring.block_upper_bounds,
                 stats=_stats_grouped,
                 pruned=True, supports_tau=True, supports_deletes=True,
                 doc="demand-grouped BMP: one bmp_scan launch per "
                     "micro-batch group (repro_torch.sched)")
def _score_tiled_bmp_grouped(queries, index, cfg, k=None, tau_init=None,
                             deleted_mask=None):
    return scoring.score_tiled_bmp_grouped(
        queries, index, k=k or cfg.k, tau_init=tau_init,
        deleted_mask=deleted_mask, **_sched_knobs(cfg),
    )


@register_engine("tiled-bmp-fused", build_index=_build_tiled_pruned,
                 index_type=TiledIndex, bounds=scoring.block_upper_bounds,
                 stats=_stats_fused,
                 pruned=True, supports_tau=True, supports_deletes=True,
                 doc="fused BMP scan: demand-grouped sweeps stacked per "
                     "power-of-two bucket, one bmp_scan launch per bucket")
def _score_tiled_bmp_fused(queries, index, cfg, k=None, tau_init=None,
                           deleted_mask=None):
    return bmp_ops.bmp_scan(
        queries, index, k=k or cfg.k, tau_init=tau_init,
        deleted_mask=deleted_mask, **_sched_knobs(cfg),
    )


@register_engine("ell", build_index=_build_ell, index_type=EllIndex,
                 doc="doc-parallel gather over ELL (CUDA ell_gather)")
def _score_ell(queries, index, cfg, k=None, tau_init=None):
    return scoring.score_ell(queries, index)
