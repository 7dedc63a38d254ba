"""The exact-retrieval loop: sparse batches, indices, scoring, top-k,
engine; and the stateful serving layer (``Retriever``, ``SearchSession``)."""
from repro_torch.core.sparse import SparseBatch, from_lists, dense_to_sparse
from repro_torch.core.index import (
    TiledIndex,
    EllIndex,
    build_tiled_index,
    build_ell_index,
    filter_tiled_index,
)
from repro_torch.core.registry import get_engine, available_engines
from repro_torch.core.engine import (
    RetrievalEngine,
    RetrievalConfig,
    stream_search,
)
from repro_torch.core.session import Retriever, SearchSession

__all__ = [
    "SparseBatch",
    "from_lists",
    "dense_to_sparse",
    "TiledIndex",
    "EllIndex",
    "build_tiled_index",
    "build_ell_index",
    "filter_tiled_index",
    "get_engine",
    "available_engines",
    "RetrievalEngine",
    "RetrievalConfig",
    "stream_search",
    "Retriever",
    "SearchSession",
]
