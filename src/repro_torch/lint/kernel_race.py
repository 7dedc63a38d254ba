"""Pass ``kernel-race``: the kernels' writes do not race.

The port's counterpart of :mod:`repro.lint.kernel_race`.  A CUDA kernel's
blocks run in no order on 132 SMs, so JAX's static grid-step footprint
analysis has no counterpart here; the pass is its device half only
(``--device cuda``, :mod:`repro_torch.lint.sanitize`), in two parts:

* **shared memory**: every route under ``compute-sanitizer --tool
  racecheck``, which models shared memory only.  A route whose
  instructions the tool does not model (TMA, ``mbarrier``, clusters,
  ``wgmma``: ``bmp_scan``'s small route, bf16 ``flash_attention``) is
  listed by name as not race-checked, with the tool's words — neither
  failed nor passed silently;
* **global memory**: each route launched three times on the same inputs
  must give the same bits (a lost update or an order-dependent write
  shows as a difference), the check ``chip_smoke.py``'s phases 2, 2b and
  2c make at the main path's sizes.

A static run (no ``--device``) checks nothing for this pass.
"""
from __future__ import annotations

from repro_torch.lint.core import LintPass

PASS_ID = "kernel-race"


class KernelRacePass(LintPass):
    pass_id = PASS_ID
    kind = "device"
    description = (
        "device: every route under compute-sanitizer racecheck (shared "
        "memory) and launched three times for the same bits (global "
        "memory); routes the tool does not model are listed by name"
    )

    def device_findings(self, results: dict):
        """The findings of a :func:`repro_torch.lint.sanitize.run`."""
        from repro_torch.lint import sanitize

        return sanitize.race_findings(results)
