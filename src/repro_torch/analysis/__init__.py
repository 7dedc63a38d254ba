"""Cost analysis of the cells (``repro.analysis``): the counted cost of a
cell on ``meta`` (``probes``), op histograms and collective bytes
(``ops``), roofline terms at the H100's peaks (``roofline``) and the
report over the dry run's artifacts (``report``)."""
from repro_torch.analysis.ops import CollectiveStats, collective_bytes
from repro_torch.analysis.roofline import (
    RooflineTerms, roofline_from_artifacts,
)

__all__ = [
    "collective_bytes",
    "CollectiveStats",
    "RooflineTerms",
    "roofline_from_artifacts",
]
