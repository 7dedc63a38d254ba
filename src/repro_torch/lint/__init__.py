"""``repro_torch.lint`` — static analysis of the port's own contracts.

The port's counterpart of :mod:`repro.lint`, which walks the port too but
checks nothing there in five of its nine passes (they read ``jax.jit``,
``interpret`` and Pallas bodies).  The CPU tests sample runtime behaviour;
these passes check the contracts that, when broken, keep every test green
while the card quietly does something else: a CUDA branch that gives way
to the plain version, a host round trip on the serve path, a
half-precision running sum, a pointer no one checked.  It imports neither
``jax`` nor ``repro``, parses source with ``ast``, and runs torch code only
in ``kernel-shape`` (fake tensors, no device) and in the device half.

Run it the way CI does::

    python -m repro_torch.lint src/repro_torch       # exit 0 iff clean
    python -m repro_torch.lint src/repro_torch --format json
    python -m repro_torch.lint --list-passes
    python -m repro_torch.lint --device cuda --select kernel-memory,kernel-race

Passes (nine; each module's docstring has its full contract; "kind" says
which half runs where — static on any machine, device only with
``--device cuda`` on a card):

==================== ====== ==============================================
device-contract      static kernel entries: CPU branch returns the
                            ``*_ref``, other devices raise, no ``try``
                            around a build or launch, each launch checked
                            and counted, no ``interpret``; no public
                            ``device`` parameter defaults to the CPU
host-sync            static no ``.item()``/``.tolist()``/``.cpu()``/
                            ``.numpy()``/``synchronize()``/casts of tensors
                            /file handles on the serve path
registry-conformance static EngineSpec flags match wired signatures; no
                            engine-name string branches outside
                            ``core/registry.py``
kernel-shape         static each entry's CUDA branch on fake CUDA tensors
                            against its ``*_ref``
deprecation-shim     static the four ``make_retrieval_serve_step*`` warn
                            and forward to ``make_serve_step``
obs-contract         static no raw ``time.time()``/``perf_counter()``
                            outside ``repro_torch.obs``
kernel-memory        both   static: pointers reach C only from checked or
                            allocated tensors; device: memcheck and guard
                            bands over every route
kernel-race          device racecheck (shared memory) and repeated
                            launches (global memory) over every route
accum-dtype          static running sums accumulate in f32; bf16 is
                            rounded once
==================== ====== ==============================================

Suppress a finding with a justified comment on its line (or on the first
line of the multi-line statement containing it)::

    x = int(n)  # lint: disable=host-sync -- why the round trip stays

Programmatic entry point: :func:`run_paths` returns a
:class:`~repro_torch.lint.core.Report`.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

from repro_torch.lint.core import (  # noqa: F401  (public API re-exports)
    FileContext,
    Finding,
    LintPass,
    Report,
    run_passes,
)
from repro_torch.lint.accum_dtype import AccumDtypePass
from repro_torch.lint.deprecation_shim import DeprecationShimPass
from repro_torch.lint.device_contract import DeviceContractPass
from repro_torch.lint.host_sync import HostSyncPass
from repro_torch.lint.kernel_memory import KernelMemoryPass
from repro_torch.lint.kernel_race import KernelRacePass
from repro_torch.lint.kernel_shape import KernelShapePass
from repro_torch.lint.obs_contract import ObsContractPass
from repro_torch.lint.registry_conformance import RegistryConformancePass

ALL_PASSES: tuple[type, ...] = (
    DeviceContractPass,
    HostSyncPass,
    RegistryConformancePass,
    KernelShapePass,
    DeprecationShimPass,
    ObsContractPass,
    KernelMemoryPass,
    KernelRacePass,
    AccumDtypePass,
)


def make_passes() -> list[LintPass]:
    """Fresh instances of every registered pass, in report order."""
    return [cls() for cls in ALL_PASSES]


def run_paths(
    paths: Sequence[str],
    select: Optional[Iterable[str]] = None,
    cache=None,
    device: Optional[str] = None,
) -> Report:
    """Lint ``paths`` (files or directories) with every registered pass.

    ``select`` restricts to the given pass ids (unknown ids raise
    ``ValueError``).  ``cache`` (a :class:`repro_torch.lint.cache.LintCache`)
    replays the static findings of an unchanged tree.  ``device="cuda"``
    also runs the device halves of the selected passes on the card
    (:func:`repro_torch.lint.sanitize.run`), and raises without one.
    Returns the :class:`Report`; callers gate on ``report.clean``.
    """
    passes = make_passes()
    report = run_passes(paths, passes, select=select, cache=cache)
    if device is None:
        return report
    wanted = [p for p in passes if p.pass_id in report.passes_run
              and p.kind in ("device", "both")]
    from repro_torch.lint import sanitize

    results = sanitize.run(device)
    for p in wanted:
        report.findings.extend(p.device_findings(results))
    report.findings.sort(key=lambda f: (f.path, f.line, f.pass_id))
    report.device = results
    return report
