"""Roofline terms from dry-run artifacts, for the NVIDIA H100
(``repro.analysis.roofline``, whose constants are TPU v5e's).

Per (arch x shape x layout), one rank's step:

    compute    = counted FLOPs / the peak of the cell's compute dtype
    memory     = counted bytes / HBM_BW
    collective = collective bytes / NVLINK_BW

(seconds).  ``model_flops`` is the analytic useful work of the whole step
(6·N·D for dense LM training, per-family analogues in ``launch.cells``);
``model_flops / (counted FLOPs x cards)`` is the useful ratio (it shows
recompute and dispatch overheads, and exceeds 1 where the counter sees no
FLOP: it counts matmul-class ops only).  ``roofline_fraction`` is the
share of the card's peak the useful work reaches at the bound.  The
counted bytes are unfused (every aten op's inputs and outputs), an upper
count: the memory term bounds no step that fuses ops, until fusion is
modelled.

H100 SXM5 80 GB HBM3 at 700 W, NVIDIA's data sheet (dense rates): bf16
989.4 TFLOP/s and TF32 494.7 on the tensor cores, f32 66.9 on the SIMT
units; HBM3 3.35 TB/s; NVLink 4 at 450 GB/s a direction.  SchNet, the
recsys models and the retrieval path run f32 with TF32 off (the SIMT
peak); the LMs compute in bf16.  ``HBM_BYTES`` is the card's own memory
as ``torch.cuda.get_device_properties(0).total_memory`` reports it.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = {"bf16": 989.4e12, "tf32": 494.7e12, "f32": 66.9e12}
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s, one direction
HBM_BYTES = 85_017_493_504  # NVIDIA H100 80GB HBM3, total_memory


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    layout: str
    chips: int
    flops: float  # counted, one rank
    bytes: float  # counted, one rank
    coll_bytes: float  # one rank
    model_flops: float  # global analytic useful FLOPs
    meta: dict
    compute: str = "f32"  # a key of PEAK_FLOPS

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.compute]

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the card's peak the USEFUL work achieves at the
        bound: (model_flops / chips / bound_time) / peak."""
        if self.bound_time == 0:
            return 0.0
        per_chip = self.model_flops / self.chips
        return (per_chip / self.bound_time) / self.peak_flops

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "layout": self.layout,
            "chips": self.chips,
            "compute": self.compute,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "flops_per_dev": self.flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_from_artifacts(artifact: dict) -> RooflineTerms:
    """Terms from a ``launch.dryrun`` JSON artifact."""
    cost = artifact["cost"]
    return RooflineTerms(
        arch=artifact["arch"],
        shape=artifact["shape"],
        layout=artifact["layout"],
        chips=artifact["chips"],
        flops=cost["flops"],
        bytes=cost["bytes"],
        coll_bytes=artifact["collectives"]["total_bytes"],
        model_flops=artifact["model_flops"],
        meta={**artifact.get("meta", {}),
              "peak_bytes": cost.get("peak_bytes", 0.0)},
        compute=artifact.get("meta", {}).get("compute", "f32"),
    )


def format_table(terms: list[RooflineTerms]) -> str:
    hdr = (
        f"{'arch':<14} {'shape':<14} {'layout':<6} "
        f"{'t_comp(ms)':>10} {'t_mem(ms)':>10} {'t_coll(ms)':>10} "
        f"{'dominant':>10} {'useful':>7} {'roofline':>9}"
    )
    lines = [hdr, "-" * len(hdr)]
    for t in terms:
        lines.append(
            f"{t.arch:<14} {t.shape:<14} {t.layout:<6} "
            f"{t.t_compute*1e3:>10.2f} {t.t_memory*1e3:>10.2f} "
            f"{t.t_collective*1e3:>10.2f} {t.dominant:>10} "
            f"{t.useful_ratio:>7.3f} {t.roofline_fraction:>9.4f}"
        )
    return "\n".join(lines)
