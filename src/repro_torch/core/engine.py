"""RetrievalEngine — one index + one scorer, dispatched via the registry.

index build -> batched scoring -> top-k, with query-batch chunking (the
[B, N] score buffer bounds the concurrent queries) and metric evaluation,
as :mod:`repro.core.engine`.  The config's ``engine`` string resolves to a
:class:`~repro_torch.core.registry.EngineSpec` whose ``build_index`` and
``score`` this class drives.

The engine lives on one device (``device``, default ``"cuda"``): the docs
are moved there, the index is built there, queries are moved there, and
results come back to the host as numpy, as the JAX engine returns them.

The pruned engines (``tiled-pruned``, ``tiled-pruned-approx``,
``tiled-bmp-grouped``, ``tiled-bmp-fused``) mask docs provably outside the
top-k to ``-inf``; ``config.traversal`` picks the BMP sweep or the
two-pass seed/sweep, ``config.theta < 1`` over-prunes (``evaluate``
reports recall against exact), ``config.bounds_format`` stores the fine
bounds dense or CSR, and ``config.reorder_docs`` clusters the collection
at build (ids stay in the caller's numbering).  Deletions are tombstones:
the pruned engines mask them inside the traversal (a deleted doc must
never certify tau), the exact engines after scoring.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import index as index_mod
from repro_torch.core import metrics as metrics_mod
from repro_torch.core import registry, scoring, topk
from repro_torch.core.index import EllIndex, FlatIndex, TiledIndex
from repro_torch.core.sparse import SparseBatch
from repro_torch.utils import resolve_device

EngineName = Literal[
    "dense", "bcoo", "segment", "tiled", "ell", "tiled-pruned",
    "tiled-pruned-approx", "tiled-bmp-grouped", "tiled-bmp-fused",
]


@dataclasses.dataclass
class RetrievalConfig:
    """The JAX config's fields that the port's engines read.
    ``use_f32_scores`` (read by nothing) is not a field, so setting it
    fails (``TypeError``) instead of doing nothing; a store's config
    snapshot carries it at JAX's default (``repro_torch.store.format``)."""

    engine: EngineName = "tiled"
    k: int = 1000
    query_chunk: int = 512  # max concurrent queries (score-buffer bound)
    term_block: int = 512
    doc_block: int = 256
    chunk_size: int = 512
    # FlatIndex posting-list pad (the ``segment`` engine's index).
    pad_to: int = index_mod.LANE
    topk_block: int = 4096
    # Query-aware tile skipping (exact): drop chunks whose term block
    # carries zero query mass before scoring.
    tile_skip: bool = False
    # --- pruned engines ---
    # Total seed blocks of the two-pass traversal (None = 8x the k-covering
    # count, see scoring.prune_seed_count), clamped up to that minimum.
    prune_seed_blocks: Optional[int] = None
    # "bmp" = the descending-bound sweep with a running threshold (theta,
    # tau warm-start); "two-pass" = seed pass then sweep of the survivors.
    traversal: Literal["bmp", "two-pass"] = "bmp"
    # "tiled-pruned-approx" scales the bounds by theta before the skip
    # test: 1.0 = exact, < 1.0 over-prunes (bounded recall).
    theta: float = 1.0
    # Fine bound layout: "dense" (u8 [V, n_db]) or "csr" (nonzeros only).
    bounds_format: Literal["dense", "csr"] = "dense"
    # Cluster-friendly doc reordering at build (core.index.reorder_docs);
    # ids are mapped back, so only speed differs.
    reorder_docs: bool = False
    reorder_method: str = "signature"
    # --- demand planner of the grouped/fused engines (sched.planner) ---
    sched_top_m: int = 8
    sched_max_group: Optional[int] = None
    sched_min_share: float = 0.5
    # Optional sched.planner.PlanCache memoizing the demand plan per query
    # stream: serving state, not a config value (no equality, no repr).
    plan_cache: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # Observability (repro_torch.obs.Obs): metrics and spans threaded down
    # the serve path.  Default on; None disables it.  Serving state like
    # plan_cache: no equality, no repr, not in a store's config snapshot.
    obs: Optional[object] = dataclasses.field(
        default_factory=obs_mod.Obs, repr=False, compare=False
    )

    def __post_init__(self):
        # Fail invalid configs at construction, not first use.
        spec = registry.get_engine(self.engine)  # unknown -> ValueError
        if spec.pruned and not spec.supports_two_pass \
                and self.traversal != "bmp":
            raise ValueError(
                f"engine={self.engine!r} has no two-pass "
                "implementation; use traversal='bmp'"
            )
        if self.theta != 1.0 and not spec.supports_theta:
            raise ValueError(
                "theta != 1.0 requires an engine with supports_theta "
                "(every other engine is exact by contract)"
            )
        if not 0.0 < self.theta <= 1.0:
            raise ValueError(f"theta must be in (0, 1], got {self.theta}")
        if self.bounds_format not in ("dense", "csr"):
            raise ValueError(
                f"unknown bounds_format {self.bounds_format!r}; "
                "use 'dense' or 'csr'"
            )
        if self.sched_top_m < 1:
            raise ValueError(
                f"sched_top_m must be >= 1, got {self.sched_top_m}"
            )
        if self.sched_max_group is not None and self.sched_max_group < 1:
            raise ValueError(
                f"sched_max_group must be >= 1, got {self.sched_max_group}"
            )
        if not 0.0 <= self.sched_min_share <= 1.0:
            raise ValueError(
                f"sched_min_share must be in [0, 1], got "
                f"{self.sched_min_share}"
            )
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.query_chunk < 1:
            raise ValueError(
                f"query_chunk must be >= 1, got {self.query_chunk}"
            )

    @property
    def spec(self) -> registry.EngineSpec:
        """The registry entry this config resolves to."""
        return registry.get_engine(self.engine)


class RetrievalEngine:
    """Exact learned-sparse retrieval over a device-resident index."""

    def __init__(self, docs: SparseBatch,
                 config: Optional[RetrievalConfig] = None, device="cuda"):
        self.config = config or RetrievalConfig()
        self.spec = registry.get_engine(self.config.engine)
        self.device = resolve_device(device)
        self.docs = docs.to(self.device)
        self.num_docs = docs.batch
        self.vocab_size = docs.vocab_size
        self._doc_unperm = None  # original-order column gather
        index_docs = self.docs
        if self.spec.pruned and self.config.reorder_docs:
            index_docs, perm = index_mod.reorder_docs(
                self.docs, method=self.config.reorder_method
            )
            unperm = torch.empty_like(perm)
            unperm[perm] = torch.arange(perm.numel(), device=perm.device)
            self._doc_unperm = unperm
        self._index = self.spec.build_index(index_docs, self.config)
        self._set_views()
        # Tombstones, original doc numbering (None = nothing deleted).
        self._deleted: Optional[np.ndarray] = None
        self._deleted_dev: Optional[torch.Tensor] = None
        self._deleted_index_dev: Optional[torch.Tensor] = None

    @classmethod
    def from_prebuilt(
        cls,
        docs: SparseBatch,
        config: RetrievalConfig,
        index,
        doc_unperm=None,
        deleted: Optional[np.ndarray] = None,
        device="cuda",
    ) -> "RetrievalEngine":
        """Wrap an already-built index (what ``config.spec.build_index``
        would produce for ``docs``) without rebuilding it; ``doc_unperm``
        and ``deleted`` restore a reorder permutation and tombstones.
        ``docs`` stay where they are: a store segment's stay on the host,
        and only its index is on ``device``."""
        self = cls.__new__(cls)
        self.config = config
        self.spec = registry.get_engine(config.engine)
        self.device = resolve_device(device)
        self.docs = docs
        self.num_docs = docs.batch
        self.vocab_size = docs.vocab_size
        self._doc_unperm = (
            None if doc_unperm is None
            else torch.as_tensor(np.asarray(doc_unperm), dtype=torch.int64,
                                 device=self.device)
        )
        self._index = index
        self._set_views()
        self._deleted = (
            None if deleted is None or not np.any(deleted)
            else np.array(deleted, dtype=bool)
        )
        self._deleted_dev = None
        self._deleted_index_dev = None
        return self

    def _set_views(self) -> None:
        """Typed views of the index, kept for callers that inspect the
        concrete layout (None where the index is another type)."""
        idx = self._index
        self._flat = idx if isinstance(idx, FlatIndex) else None
        self._tiled = idx if isinstance(idx, TiledIndex) else None
        self._ell = idx if isinstance(idx, EllIndex) else None

    # -- deletions ---------------------------------------------------------
    @property
    def num_alive(self) -> int:
        if self._deleted is None:
            return self.num_docs
        return self.num_docs - int(self._deleted.sum())

    @property
    def deleted_mask(self) -> Optional[np.ndarray]:
        """[num_docs] bool tombstone mask, or ``None`` when clean."""
        return self._deleted

    def delete_docs(self, doc_ids) -> int:
        """Tombstone documents by original id (no index rewrite): the
        pruned engines mask them inside the traversal, the exact engines
        after scoring.  Idempotent; returns the count of newly deleted
        docs.  Raises on out-of-range ids."""
        ids = np.asarray(doc_ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_docs):
            raise ValueError(
                f"doc ids must be in [0, {self.num_docs}); got range "
                f"[{ids.min()}, {ids.max()}]"
            )
        if self._deleted is None:
            self._deleted = np.zeros(self.num_docs, bool)
        before = int(self._deleted.sum())
        self._deleted[ids] = True
        self._deleted_dev = None  # rebuilt on next score
        self._deleted_index_dev = None
        return int(self._deleted.sum()) - before

    def _deleted_original_order(self) -> Optional[torch.Tensor]:
        """The tombstone mask on the device, original doc numbering."""
        if self._deleted is None:
            return None
        if self._deleted_dev is None:
            self._deleted_dev = torch.from_numpy(self._deleted).to(
                self.device)
        return self._deleted_dev

    def _deleted_index_order(self) -> Optional[torch.Tensor]:
        """The tombstone mask on the device in *index* doc numbering, for
        the registry's ``deleted_mask`` seam; ``None`` when clean."""
        deleted = self._deleted_original_order()
        if deleted is None or self._doc_unperm is None:
            return deleted
        if self._deleted_index_dev is None:
            # unperm[orig_id] = index position
            d_idx = torch.empty_like(deleted)
            d_idx[self._doc_unperm] = deleted
            self._deleted_index_dev = d_idx
        return self._deleted_index_dev

    # -- index stats ------------------------------------------------------
    def index_bytes(self) -> int:
        for idx in (self._flat, self._tiled, self._ell):
            if idx is not None:
                return idx.memory_bytes()
        return 0

    def padding_overhead(self) -> float:
        for idx in (self._flat, self._tiled):
            if idx is not None:
                return idx.padding_overhead
        return 0.0

    # -- scoring ----------------------------------------------------------
    def score(
        self,
        queries: SparseBatch,
        k: Optional[int] = None,
        tau_init=None,
    ) -> torch.Tensor:
        """[B, num_docs] score matrix (original doc numbering), on the
        engine's device; tombstoned docs score ``-inf``."""
        cfg = self.config
        if tau_init is not None and not self.spec.supports_tau:
            raise ValueError(
                f"tau_init needs an engine that supports it, not "
                f"engine={cfg.engine!r}"
            )
        queries = queries.to(self.device)
        deleted = self._deleted_index_order()
        if deleted is not None and self.spec.supports_deletes:
            # In-traversal masking: a tombstoned doc never certifies the
            # pruning threshold (post-hoc masking would be unsafe here).
            out = self.spec.score(queries, self._index, cfg, k=k or cfg.k,
                                  tau_init=tau_init, deleted_mask=deleted)
        else:
            out = self.spec.score(queries, self._index, cfg, k=k or cfg.k,
                                  tau_init=tau_init)
        if self._doc_unperm is not None:
            out = out[:, self._doc_unperm]
        if deleted is not None and not self.spec.supports_deletes:
            # Exact engines score the full matrix: masking afterwards is
            # the same as never having indexed the doc.
            out = out.masked_fill(self._deleted_original_order()[None, :],
                                  float("-inf"))
        return out

    def search(
        self,
        queries: SparseBatch,
        k: Optional[int] = None,
        tau_init: Optional[np.ndarray] = None,
        return_tau: bool = False,
    ):
        """Chunked top-k search -> (values [B,k], doc ids [B,k]) as numpy.

        Slots with a non-finite value come back with id ``-1``.
        ``return_tau`` appends the per-query certified threshold (the k-th
        returned value where finite, else the carried ``tau_init``).
        """
        k_req = k or self.config.k
        k = min(k_req, self.num_docs)
        obs = getattr(self.config, "obs", None)
        out_v, out_i = [], []
        for s in range(0, queries.batch, self.config.query_chunk):
            q = queries.slice_rows(s, min(self.config.query_chunk,
                                          queries.batch - s))
            t0 = None if tau_init is None else torch.as_tensor(
                np.asarray(tau_init)[s:s + q.batch], dtype=torch.float32,
                device=self.device,
            )
            # The copies to numpy end the chunk on the host, so the span
            # measures its device work, not its dispatch.
            with obs_mod.span(obs, "engine.score", rows=q.batch, k=k):
                scores = self.score(q, k=k, tau_init=t0)
                v, i = topk.topk_two_stage(scores, k,
                                           block=self.config.topk_block)
                # Freed before the next chunk is scored: one chunk's
                # [q, N] scores live at a time.
                del scores
                out_v.append(v.cpu().numpy())
                out_i.append(i.cpu().numpy())
        vals = np.concatenate(out_v, axis=0)
        ids = np.where(np.isfinite(vals), np.concatenate(out_i, axis=0), -1)
        if not return_tau:
            return vals, ids
        # Certification needs k docs at the *requested* k.
        tau = topk.certify_tau(vals, k_req, tau_init)
        return vals, ids, tau

    # -- observability ----------------------------------------------------
    def prune_stats(self, queries: SparseBatch,
                    k: Optional[int] = None) -> Optional[scoring.PruneStats]:
        """Block/chunk skip statistics of one scoring pass, through
        ``EngineSpec.stats``; ``None`` for the exact engines."""
        if not self.spec.pruned or self.spec.stats is None:
            return None
        queries = queries.to(self.device)
        deleted = self._deleted_index_order()
        if deleted is not None:
            return self.spec.stats(queries, self._index, self.config,
                                   k or self.config.k, deleted_mask=deleted)
        return self.spec.stats(queries, self._index, self.config,
                               k or self.config.k)

    # -- evaluation -------------------------------------------------------
    def _exact_topk_ids(self, queries: SparseBatch, k: int) -> np.ndarray:
        """Exact top-k ids (original numbering) from the exhaustive tiled
        scan over the same index — the theta-mode ground truth."""
        out = []
        for s in range(0, queries.batch, self.config.query_chunk):
            q = queries.slice_rows(s, min(self.config.query_chunk,
                                          queries.batch - s))
            scores = scoring.score_tiled(q.to(self.device), self._index)
            if self._doc_unperm is not None:
                scores = scores[:, self._doc_unperm]
            if self._deleted is not None:
                scores = scores.masked_fill(
                    self._deleted_original_order()[None, :], float("-inf"))
            v, i = topk.topk_two_stage(scores, min(k, self.num_docs),
                                       block=self.config.topk_block)
            del scores
            out.append(torch.where(torch.isfinite(v), i, -1).cpu().numpy())
        return np.concatenate(out, axis=0)

    def evaluate(
        self,
        queries: SparseBatch,
        qrels: list[set[int]],
        k: int = 1000,
    ) -> dict[str, float]:
        """Qrels metrics of the top-k; with ``theta < 1`` on an engine that
        honours it, also ``recall_vs_exact@k`` against the exact top-k over
        the same index."""
        _, ids = self.search(queries, k=k)
        out = {
            "mrr@10": metrics_mod.mrr_at_k(ids, qrels, 10),
            "ndcg@10": metrics_mod.ndcg_at_k(ids, qrels, 10),
            f"recall@{k}": metrics_mod.recall_at_k(ids, qrels, k),
        }
        if self.spec.supports_theta and self.config.theta < 1.0:
            out[f"recall_vs_exact@{k}"] = metrics_mod.recall_vs_ids(
                ids, self._exact_topk_ids(queries, k), k
            )
        return out


def stream_search(
    doc_batches,
    queries: SparseBatch,
    config: Optional[RetrievalConfig] = None,
    k: Optional[int] = None,
    device="cuda",
):
    """Retrieval over a streamed corpus: each batch is indexed, searched
    and merged into the running top-k, with the stream's certified
    threshold passed as ``tau_init`` to engines that consume it.

    Returns ``(values [B, k], global doc ids [B, k], tau [B])`` as numpy.
    """
    config = config or RetrievalConfig()
    dev = resolve_device(device)
    k = k or config.k
    warm = registry.config_supports_tau(config)
    tau = np.full((queries.batch,), -np.inf, np.float32)
    run_v = run_i = None
    offset = 0
    for docs in doc_batches:
        eng = RetrievalEngine(docs, config, device=dev)
        v, i = eng.search(queries, k=k, tau_init=tau if warm else None)
        i = np.where(np.isfinite(v), i + offset, -1)  # globalize finite ids
        offset += docs.batch
        if run_v is None:
            run_v, run_i = v, i
        else:
            mv, mi = topk.merge_topk(
                torch.from_numpy(run_v), torch.from_numpy(run_i),
                torch.from_numpy(v), torch.from_numpy(i), k,
            )
            run_v, run_i = mv.numpy(), mi.numpy()
        tau = topk.certify_tau(run_v, k, tau)
    return run_v, run_i, tau
