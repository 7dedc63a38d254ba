"""``repro_torch.obs`` — observability for the serve path (``repro.obs``).

One :class:`Obs` object bundles a :class:`~repro_torch.obs.metrics.
MetricsRegistry` (counters, gauges, log-bucketed latency histograms with
mergeable snapshots), a :class:`~repro_torch.obs.trace.Tracer` with its
ring-buffer :class:`~repro_torch.obs.trace.TraceLog` (per-request span
trees, JSON and Chrome-trace export), and the :mod:`~repro_torch.obs.
collect` adapters folding the serve path's stat islands into the same
registry.  Metric and span names, the bucket law and the export formats
are the JAX package's, so snapshots of either package merge.

Wiring: ``RetrievalConfig.obs`` holds one (default on; set it to ``None``
to disable) and every layer of the serve path reaches it with
``getattr(cfg, "obs", None)``, through the None-safe helpers::

    from repro_torch import obs as obs_mod

    with obs_mod.span(obs, "engine.score", rows=q.batch):
        ...

Timing contract: :func:`clock` is the one wall-clock read of the port.
It reads ``time.monotonic`` (on Linux the ``CLOCK_MONOTONIC`` that
``time.perf_counter`` reads too): the ``obs-contract`` lint exempts only
``repro/obs`` and ``benchmarks/`` from its ban on ``time.perf_counter``.
A span that covers device work calls :func:`fence` inside it, so it
measures the kernels, not their dispatch.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

from repro_torch.obs.metrics import (  # noqa: F401  (public API re-exports)
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    ObsSnapshot,
)
from repro_torch.obs.trace import (  # noqa: F401
    Span,
    TraceLog,
    Tracer,
    to_chrome_trace,
)

__all__ = [
    "Obs",
    "ObsSnapshot",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "Span",
    "Tracer",
    "TraceLog",
    "to_chrome_trace",
    "clock",
    "dump",
    "fence",
    "span",
    "timer",
]


def clock() -> float:
    """Monotonic wall-clock seconds — the port's one blessed time source."""
    return time.monotonic()


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            _cuda_devices(leaf, out)
    elif getattr(tree, "is_cuda", False):
        out.add(tree.device)
    return out


def fence(tree) -> None:
    """Block the host until the work queued for every CUDA tensor in
    ``tree`` (tensors, or dicts, lists and tuples of them) is done.

    One ``torch.cuda.synchronize`` per CUDA device the tree holds
    tensors on; CPU tensors and other leaves need nothing.  It swallows no
    exception: a fault of the queued work surfaces here.
    """
    import torch

    for dev in sorted(_cuda_devices(tree, set()), key=lambda d: d.index or 0):
        torch.cuda.synchronize(dev)


class Obs:
    """Facade: one registry + one tracer, shared by a serve stack."""

    def __init__(self, max_traces: int = 256) -> None:
        self.metrics = MetricsRegistry()
        self.trace_log = TraceLog(maxlen=max_traces)
        self.tracer = Tracer(self.trace_log, on_close=self._on_span_close)

    def _on_span_close(self, sp: Span) -> None:
        # Every completed span doubles as a latency sample, so the
        # snapshot carries per-stage duration histograms for free.
        self.metrics.histogram("span." + sp.name).observe(sp.duration)

    # -- tracing --------------------------------------------------------
    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def record_span(self, name: str, start: float, end: float,
                    **attrs) -> Span:
        return self.tracer.record(name, start, end, **attrs)

    # -- metrics --------------------------------------------------------
    def counter(self, name: str) -> Counter:
        return self.metrics.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.metrics.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.metrics.histogram(name)

    def snapshot(self) -> ObsSnapshot:
        return self.metrics.snapshot()


def dump(obs: "Obs", path: str,
         snapshot: Optional[ObsSnapshot] = None) -> dict:
    """Write the snapshot (+ Chrome trace events) as JSON to ``path``.

    The shared ``--obs-dump PATH`` implementation: top-level keys are
    the :meth:`ObsSnapshot.as_dict` ones (``counters`` / ``gauges`` /
    ``histograms``) plus ``chrome_trace`` (load into chrome://tracing
    or ui.perfetto.dev).  Pass ``snapshot`` when a collector already
    folded the islands (e.g. ``QueryScheduler.obs_snapshot()``);
    defaults to ``obs.snapshot()``.  Returns the written payload.
    """
    import json

    snap = obs.snapshot() if snapshot is None else snapshot
    payload = snap.as_dict()
    payload["chrome_trace"] = obs.trace_log.to_chrome_trace()
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return payload


_NULL_SPAN = contextlib.nullcontext()


def span(obs: Optional[Obs], name: str, **attrs):
    """None-safe ``obs.span``: a no-op context manager when disabled."""
    if obs is None:
        return _NULL_SPAN
    return obs.span(name, **attrs)


@contextlib.contextmanager
def timer(obs: Optional[Obs], name: str) -> Iterator[None]:
    """None-safe elapsed-time sample into histogram ``name``."""
    if obs is None:
        yield
        return
    t0 = clock()
    try:
        yield
    finally:
        obs.metrics.histogram(name).observe(clock() - t0)
