"""PyTorch/CUDA port of the traversability estimation engine.

The main path runs on one NVIDIA H100: map update (filter chain + dense veto
fields, one hand-written CUDA kernel) -> query state -> dense circle field
(a second hand-written CUDA kernel) -> batched circular path checks (torch
ops). Every kernel has a plain PyTorch version beside it in the same module;
the plain version serves CPU tensors and referees the kernel on the card.
Polygonal footprint paths (convex hulls of consecutive footprints, rasterised
by the crossing-number rule) and the dense footprint services are torch ops
behind the same estimator. The online loop (a persistent map refreshed from
robot-centric submaps, ``TraversabilityEstimator.online_tick``) runs both
kernels on crops of the map, once per tick.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from traversability_estimation_tpu_torch.device import resolve_device
from traversability_estimation_tpu_torch.grid.gridmap import GridMap
from traversability_estimation_tpu_torch.models.estimator import (
    FootprintPath,
    TraversabilityEstimator,
    TraversabilityResult,
)
from traversability_estimation_tpu_torch.utils.config import (
    EstimatorConfig,
    FootprintConfig,
)
from traversability_estimation_tpu_torch.utils.sources import (
    ArraySource,
    SyntheticTerrainSource,
)

__all__ = [
    "ArraySource",
    "EstimatorConfig",
    "FootprintConfig",
    "FootprintPath",
    "GridMap",
    "SyntheticTerrainSource",
    "TraversabilityEstimator",
    "TraversabilityResult",
    "resolve_device",
]
