"""Serve loop: bounded admission queue + deadline-aware micro-batching
(:mod:`repro.sched.queue`, on the port's ``SearchSession``).

The high-QPS serving story the ROADMAP's north star asks for: requests
arrive one at a time, the scheduler admits them through a **bounded**
queue (backpressure instead of unbounded memory growth), assembles
micro-batches in **earliest-deadline-first** order, and serves each batch
through a :class:`repro_torch.core.session.SearchSession` — so a repeat request
from the same query stream warm-starts at its cached certified tau, and
the grouped BMP engine (``"tiled-bmp-grouped"``) splits each micro-batch
by demand overlap on the way down.

Deadline semantics: a deadline orders service, it never drops work.  When
a micro-batch fills before a request's turn, the request *falls to the
next micro-batch* and is eventually served with ``SearchResult.late ==
True`` — silent dropping is the one failure mode a retrieval tier must
not have.  Only admission is bounded: ``submit`` on a full queue raises
:class:`QueueFull`, which is the caller-visible backpressure signal.

The loop is deterministic and clock-injected (tests drive it with a fake
``now``); ``QueryScheduler.run_async`` wraps the same ``step`` in an
asyncio coroutine for callers that want a real event loop.

Observability: every request carries its full timeline (``arrival`` →
``dispatched_at`` → ``completed_at``), so queue wait and end-to-end
latency are first-class — the scheduler records them into the
retriever's ``config.obs`` (histograms ``sched.queue_wait_s`` /
``sched.e2e_latency_s``, counter ``sched.deadline_miss_total``) and
traces each micro-batch as one ``serve.step`` span tree.
``QueryScheduler.obs_snapshot()`` folds in the session/queue/plan-cache
islands and returns the whole story.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Hashable, Optional

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core.sparse import SparseBatch
from repro_torch.utils import resolve_device


class QueueFull(RuntimeError):
    """Admission rejected: the bounded request queue is at capacity."""


@dataclasses.dataclass
class Request:
    """One enqueued query of a (possibly repeating) query stream."""

    query_id: Hashable
    term_ids: np.ndarray  # int32 [K], -1 padding
    values: np.ndarray  # f32 [K]
    deadline: float = math.inf  # absolute time; orders service (EDF)
    arrival: float = 0.0
    # Stamped by the scheduler (same clock as arrival): when the request
    # left the queue for a micro-batch, and when its batch finished.
    # Queue wait and end-to-end latency used to be computed and thrown
    # away — only the boolean `late` survived.
    dispatched_at: Optional[float] = None
    completed_at: Optional[float] = None

    def __post_init__(self) -> None:
        # A length mismatch used to be absorbed by the batcher's
        # zero-fill — silently scoring the query with dropped (or
        # zero-weight) terms.  Malformed requests must fail at admission,
        # not serve wrong results.
        if len(self.term_ids) != len(self.values):
            raise ValueError(
                f"request {self.query_id!r}: {len(self.term_ids)} term_ids "
                f"vs {len(self.values)} values; one weight per term"
            )


@dataclasses.dataclass
class SearchResult:
    """What the scheduler hands back per served request."""

    query_id: Hashable
    values: np.ndarray  # [k'] top-k scores (sorted desc)
    ids: np.ndarray  # [k'] global doc ids (-1 in masked slots)
    deadline: float
    served_at: float
    arrival: float = 0.0
    dispatched_at: Optional[float] = None

    @property
    def late(self) -> bool:
        return self.served_at > self.deadline

    @property
    def queue_wait(self) -> Optional[float]:
        """Seconds spent queued before dispatch (None pre-scheduler)."""
        if self.dispatched_at is None:
            return None
        return self.dispatched_at - self.arrival

    @property
    def latency(self) -> float:
        """End-to-end seconds: arrival to served."""
        return self.served_at - self.arrival


class RequestQueue:
    """Bounded priority queue over requests, earliest deadline first.

    ``submit`` raises :class:`QueueFull` at capacity (bounded admission);
    ``pop_batch`` removes up to ``max_batch`` requests in (deadline,
    arrival order) — whatever does not fit stays queued for the next
    assembly, so no request is ever discarded by the queue itself.
    """

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._heap: list[tuple[float, int, Request]] = []
        # Arrival-order mirror with lazy deletion, so oldest_arrival (the
        # serve loop polls it every ready() check) stays O(log n) instead
        # of a linear scan of the deadline heap.
        self._arrivals: list[tuple[float, int]] = []
        self._alive: set[int] = set()
        self._seq = 0  # FIFO tie-break among equal deadlines

    def __len__(self) -> int:
        return len(self._heap)

    def _prune_arrivals(self) -> None:
        while self._arrivals and self._arrivals[0][1] not in self._alive:
            heapq.heappop(self._arrivals)
        # Lazy deletion can strand dead entries behind a long-lived head;
        # compact when they outnumber the live ones so the mirror stays
        # O(queue depth) no matter the pop pattern (amortized O(1)/op).
        if len(self._arrivals) > 2 * max(len(self._alive), 8):
            self._arrivals = [e for e in self._arrivals if e[1] in self._alive]
            heapq.heapify(self._arrivals)

    @property
    def oldest_arrival(self) -> Optional[float]:
        self._prune_arrivals()
        return self._arrivals[0][0] if self._arrivals else None

    @property
    def next_deadline(self) -> Optional[float]:
        if not self._heap:
            return None
        return self._heap[0][0]

    def submit(self, request: Request) -> int:
        """Admit one request; raises :class:`QueueFull` at capacity.

        Returns the queue depth after admission (the caller's load
        signal)."""
        if len(self._heap) >= self.capacity:
            raise QueueFull(
                f"request queue at capacity ({self.capacity}); "
                "shed load upstream or grow the queue"
            )
        heapq.heappush(self._heap, (request.deadline, self._seq, request))
        heapq.heappush(self._arrivals, (request.arrival, self._seq))
        self._alive.add(self._seq)
        self._seq += 1
        return len(self._heap)

    def pop_batch(self, max_batch: int) -> list[Request]:
        """Up to ``max_batch`` requests, earliest deadline (then FIFO)
        first; the remainder stays queued for the next micro-batch."""
        out = []
        while self._heap and len(out) < max_batch:
            _, seq, req = heapq.heappop(self._heap)
            self._alive.discard(seq)
            out.append(req)
        self._prune_arrivals()  # drain-driven callers never read
        return out              # oldest_arrival, so purge here too


def _batch_from_requests(reqs: list[Request], vocab_size: int,
                         device) -> SparseBatch:
    """The micro-batch padded on the host, then one copy of each array to
    ``device`` (not one a request)."""
    # Request.__post_init__ guarantees len(term_ids) == len(values), so
    # the tail fill here is pure padding (-1 ids / 0 weights), never a
    # silent truncation of a malformed row.
    kmax = max(max(len(r.term_ids) for r in reqs), 1)
    ids = np.full((len(reqs), kmax), -1, np.int32)
    vals = np.zeros((len(reqs), kmax), np.float32)
    for i, r in enumerate(reqs):
        ids[i, : len(r.term_ids)] = np.asarray(r.term_ids, np.int32)
        vals[i, : len(r.term_ids)] = np.asarray(r.values, np.float32)
    return SparseBatch(torch.from_numpy(ids).to(device),
                       torch.from_numpy(vals).to(device), vocab_size)


class QueryScheduler:
    """The demand-aware serve loop over a :class:`~repro_torch.core.session.Retriever`.

    Assembly policy (checked by :meth:`ready`): a micro-batch launches
    when (a) a full ``max_batch`` is waiting, (b) the oldest queued
    request has waited ``max_delay``, or (c) the nearest deadline is due.
    Each launch pops the EDF prefix of the queue and searches it through
    one :class:`~repro_torch.core.session.SearchSession` call — which groups
    rows by cache state, warm-starts each stream at its cached certified
    tau, and (with ``engine="tiled-bmp-grouped"``) splits the batch by
    demand overlap inside the scorer.  Results are returned per request
    with their lateness visible, never silently dropped.

    ``device`` (default ``"cuda"``) is where the micro-batches go: the
    retriever's device, which it must equal.
    """

    def __init__(
        self,
        retriever,
        k: Optional[int] = None,
        capacity: int = 1024,
        max_batch: int = 32,
        max_delay: float = 0.01,
        max_entries: Optional[int] = None,
        # The blessed monotonic clock (repro_torch.obs.clock), so request
        # timestamps share the tracer's domain; tests inject fakes.
        clock: Callable[[], float] = obs_mod.clock,
        device="cuda",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        if self.device != retriever.device:
            raise ValueError(
                f"scheduler device {self.device} is not the retriever's "
                f"({retriever.device})"
            )
        self.retriever = retriever
        self.session = retriever.open_session(k=k, max_entries=max_entries)
        self.queue = RequestQueue(capacity)
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.clock = clock
        self.served = 0
        # Demand-plan memo for the grouped/fused BMP engines: a serving
        # tier replays the same query streams, so the micro-batch plan is
        # computed once per (stream, index segment) and invalidated when
        # the retriever's epoch bumps (destructive rebuild) — exactly the
        # session tau cache's invalidation contract.  Installed on the
        # shared config so every segment engine reaches it; an
        # already-installed cache (another scheduler over the same
        # retriever) is adopted rather than clobbered, so all schedulers
        # share one bounded memo and one set of counters.
        from repro_torch.sched.planner import PlanCache

        if getattr(retriever.config, "plan_cache", None) is None:
            retriever.config.plan_cache = PlanCache()
        self.plan_cache = retriever.config.plan_cache
        self.plan_cache.set_epoch(self._lifecycle_token(),
                                  owner=id(retriever))

    def _lifecycle_token(self) -> tuple:
        """Plan-cache invalidation token: rebuilds (epoch) *and*
        deletions (mutation) flush memoized demand plans.  Deletion
        staleness is perf-only — any partition is exact and the
        tombstone mask is applied inside every group's sweep — but a
        plan keyed on pre-deletion demand would keep scheduling blocks
        that are now mostly dead, so it is conservatively dropped."""
        return (self.retriever.epoch, getattr(self.retriever, "mutation", 0))

    def submit(
        self,
        query_id: Hashable,
        term_ids: np.ndarray,
        values: np.ndarray,
        deadline: Optional[float] = None,
        now: Optional[float] = None,
    ) -> int:
        """Admit one request (raises :class:`QueueFull` at capacity).

        ``deadline`` defaults to ``now + max_delay`` — an SLA-less
        request still gets a service order."""
        now = self.clock() if now is None else now
        return self.queue.submit(Request(
            query_id=query_id,
            term_ids=np.asarray(term_ids),
            values=np.asarray(values),
            deadline=now + self.max_delay if deadline is None else deadline,
            arrival=now,
        ))

    def ready(self, now: Optional[float] = None) -> bool:
        """Whether :meth:`step` would launch a micro-batch right now."""
        if not len(self.queue):
            return False
        if len(self.queue) >= self.max_batch:
            return True
        now = self.clock() if now is None else now
        oldest = self.queue.oldest_arrival
        if oldest is not None and now - oldest >= self.max_delay:
            return True
        nxt = self.queue.next_deadline
        return nxt is not None and nxt <= now

    def step(
        self, now: Optional[float] = None, force: bool = False
    ) -> list[SearchResult]:
        """Serve one micro-batch if assembly is due (or ``force``).

        Pops the EDF prefix, searches it through the session (tau
        warm-start per stream), and returns one :class:`SearchResult` per
        request.  Anything beyond ``max_batch`` stays queued — a late
        request is served in a later micro-batch, never dropped."""
        caller_now = now
        now = self.clock() if now is None else now
        if not (force or self.ready(now)):
            return []
        reqs = self.queue.pop_batch(self.max_batch)
        if not reqs:
            return []
        obs = getattr(self.retriever.config, "obs", None)
        with obs_mod.span(obs, "serve.step", batch=len(reqs)) as root:
            # Dispatch stamp: when the batch left the queue.  An injected
            # ``now`` pins the whole step to that instant for
            # deterministic tests.
            dispatched_at = self.clock() if caller_now is None else now
            for r in reqs:
                r.dispatched_at = dispatched_at
            if obs is not None:
                m = obs.metrics
                m.counter("sched.requests_total").inc(len(reqs))
                m.counter("sched.batches_total").inc()
                m.histogram("sched.batch_size").observe(len(reqs))
                m.gauge("sched.queue_depth").set(len(self.queue))
                for r in reqs:
                    m.histogram("sched.queue_wait_s").observe(
                        dispatched_at - r.arrival
                    )
                # Queue wait as a trace child with explicit timestamps
                # (earliest arrival -> dispatch); request stamps come
                # from self.clock, so durations are meaningful even with
                # an injected test clock.
                obs.record_span(
                    "queue.wait", min(r.arrival for r in reqs),
                    dispatched_at, batch=len(reqs),
                )
            self.plan_cache.set_epoch(
                self._lifecycle_token(), owner=id(self.retriever)
            )  # rebuild/delete
            queries = _batch_from_requests(reqs, self.retriever.vocab_size,
                                           self.device)
            with obs_mod.span(obs, "session.search", rows=len(reqs)):
                vals, ids = self.session.search(
                    queries, query_ids=[r.query_id for r in reqs]
                )
            # Real-clock callers get completion stamped AFTER the search
            # (so ``late`` includes search latency).
            served_at = self.clock() if caller_now is None else now
            self.served += len(reqs)
            results = []
            misses = 0
            for i, r in enumerate(reqs):
                r.completed_at = served_at
                res = SearchResult(
                    query_id=r.query_id, values=vals[i], ids=ids[i],
                    deadline=r.deadline, served_at=served_at,
                    arrival=r.arrival, dispatched_at=r.dispatched_at,
                )
                results.append(res)
                if res.late:
                    misses += 1
                if obs is not None:
                    obs.metrics.histogram("sched.e2e_latency_s").observe(
                        res.latency
                    )
            if obs is not None:
                if misses:
                    obs.metrics.counter("sched.deadline_miss_total").inc(
                        misses
                    )
                root.attrs["deadline_misses"] = misses
        return results

    def obs_snapshot(self) -> Optional[obs_mod.ObsSnapshot]:
        """One snapshot of the whole serve stack's observability.

        Folds the serving-layer islands (queue depth/served, session
        cache occupancy/evictions/demotions) into the retriever's
        ``config.obs`` registry, then defers to
        ``Retriever.obs_snapshot`` for the index-layer islands (plan
        cache, pager, index shape).  ``None`` when obs is disabled.
        """
        obs = getattr(self.retriever.config, "obs", None)
        if obs is None:
            return None
        from repro_torch.obs import collect

        collect.collect_queue(obs.metrics, self)
        collect.collect_session(obs.metrics, self.session)
        return self.retriever.obs_snapshot()

    def drain(self, now: Optional[float] = None) -> list[SearchResult]:
        """Serve micro-batch after micro-batch until the queue is empty."""
        out = []
        while len(self.queue):
            out.extend(self.step(now=now, force=True))
        return out

    async def run_async(self, poll_interval: float = 0.001, stop=None,
                        on_batch=None):
        """Asyncio wrapper around :meth:`step` for event-loop callers.

        Yields control between batches.  ``on_batch`` (called with each
        served ``list[SearchResult]`` as it completes) is the delivery
        path for a long-running server; without it, results accumulate
        and are returned when ``stop`` (a callable returning truthy)
        fires after the queue drains — so a callback-less call *requires*
        ``stop``, otherwise served results would pile up unbounded with
        no way to ever receive them."""
        import asyncio

        if on_batch is None and stop is None:
            raise ValueError(
                "run_async without on_batch requires stop: an endless "
                "loop with no delivery path hoards results unboundedly"
            )
        results: list[SearchResult] = []
        while True:
            batch = self.step()
            if batch:
                if on_batch is not None:
                    on_batch(batch)
                else:
                    results.extend(batch)
            else:
                if stop is not None and stop():
                    tail = self.drain()
                    if on_batch is not None:
                        if tail:
                            on_batch(tail)
                        return results  # empty: everything was delivered
                    results.extend(tail)
                    return results
                await asyncio.sleep(poll_interval)
