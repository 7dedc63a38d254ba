"""The exact-retrieval loop: sparse batches, indices, scoring, top-k
(``topk``, the module, as JAX's ``repro.core`` exports it), engine; the stateful serving layer (``Retriever``, ``SearchSession``); and
document-sharded serving over ``torch.distributed`` (``make_serve_step``).
The paper's CPU baselines are in ``core.wand`` and ``core.seismic``."""
from repro_torch.core.sparse import SparseBatch, from_lists, dense_to_sparse
from repro_torch.core.index import (
    FlatIndex,
    TiledIndex,
    EllIndex,
    build_flat_index,
    build_tiled_index,
    build_ell_index,
    filter_tiled_index,
    reorder_docs,
    shard_docs,
)
from repro_torch.core import topk
from repro_torch.core.scoring import (
    score_dense,
    score_bcoo,
    score_segment,
    score_tiled,
    score_tiled_pruned,
    score_tiled_bmp,
    score_tiled_bmp_grouped,
    score_ell,
    score_with_engine,
    block_upper_bounds,
    PruneStats,
    SchedStats,
)
from repro_torch.core.topk import (
    certify_tau,
    local_then_global_topk,
    merge_gathered,
    merge_topk,
    partial_topk_threshold,
    topk_two_stage,
    update_topk_heap,
)
from repro_torch.core.registry import (
    EngineSpec,
    register_engine,
    get_engine,
    available_engines,
    get_serve_factory,
    register_serve_factory,
)
from repro_torch.core.engine import (
    RetrievalEngine,
    RetrievalConfig,
    stream_search,
)
from repro_torch.core.session import Retriever, SearchSession
from repro_torch.core.distributed import (
    ShardedEllIndex,
    ShardedTiledIndex,
    build_sharded_ell,
    build_sharded_tiled,
    make_serve_step,
    snapshot_paged,
)

__all__ = [
    "SparseBatch",
    "from_lists",
    "dense_to_sparse",
    "FlatIndex",
    "TiledIndex",
    "EllIndex",
    "build_flat_index",
    "build_tiled_index",
    "build_ell_index",
    "filter_tiled_index",
    "reorder_docs",
    "shard_docs",
    "score_dense",
    "score_bcoo",
    "score_segment",
    "score_tiled",
    "score_tiled_pruned",
    "score_tiled_bmp",
    "score_tiled_bmp_grouped",
    "score_ell",
    "score_with_engine",
    "block_upper_bounds",
    "PruneStats",
    "SchedStats",
    "topk",
    "topk_two_stage",
    "merge_topk",
    "partial_topk_threshold",
    "update_topk_heap",
    "certify_tau",
    "local_then_global_topk",
    "merge_gathered",
    "EngineSpec",
    "register_engine",
    "get_engine",
    "available_engines",
    "get_serve_factory",
    "register_serve_factory",
    "RetrievalEngine",
    "RetrievalConfig",
    "stream_search",
    "Retriever",
    "SearchSession",
    "ShardedEllIndex",
    "ShardedTiledIndex",
    "build_sharded_ell",
    "build_sharded_tiled",
    "make_serve_step",
    "snapshot_paged",
]
