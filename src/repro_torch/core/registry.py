"""Engine registry — the single seam every dispatcher goes through.

As in :mod:`repro.core.registry`, an engine is one :class:`EngineSpec`
registered once with ``@register_engine``: ``build_index(docs, cfg)`` and
``score(queries, index, cfg, k=None, tau_init=None)`` returning a
[B, num_docs] score matrix.  ``get_engine`` raises with the registered
list on an unknown name.

Registered here: ``dense``, ``tiled`` (the ``scatter_score`` kernel) and
``ell`` (the ``ell_gather`` kernel).  The JAX names ``pallas`` and
``pallas_ell`` would be the very same kernels as ``tiled`` and ``ell`` in
the port, so they are not registered.  The pruned engines come with the
pruned slice, and with them the ``bounds``/``stats``/deletion seams.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core import index as index_mod
from repro_torch.core import scoring
from repro_torch.core.index import EllIndex, TiledIndex
from repro_torch.core.sparse import SparseBatch


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One scoring engine: how to build its index and how to score with it.

    ``cfg`` is duck-typed (any object with the :class:`RetrievalConfig`
    attributes), so the registry never imports the engine layer.
    """

    name: str
    build_index: Callable[[SparseBatch, Any], Any]
    score: Callable[..., Any]
    index_type: Optional[type] = None  # None: the "index" is the docs batch
    supports_tau: bool = False  # consumes tau_init warm-start thresholds
    # Refines supports_tau for engines whose tau use depends on the config.
    consumes_tau: Optional[Callable[[Any], bool]] = None
    doc: str = ""


_REGISTRY: dict[str, EngineSpec] = {}


def register_engine(
    name: str,
    *,
    build_index: Callable[[SparseBatch, Any], Any],
    index_type: Optional[type] = None,
    supports_tau: bool = False,
    consumes_tau: Optional[Callable[[Any], bool]] = None,
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
            index_type=index_type,
            supports_tau=supports_tau,
            consumes_tau=consumes_tau,
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


@register_engine("ell", build_index=_build_ell, index_type=EllIndex,
                 doc="doc-parallel gather over ELL (CUDA ell_gather)")
def _score_ell(queries, index, cfg, k=None, tau_init=None):
    return scoring.score_ell(queries, index)
