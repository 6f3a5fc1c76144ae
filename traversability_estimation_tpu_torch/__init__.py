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

The serving path is the normal way in: ``python -m
traversability_estimation_tpu_torch serve`` starts a ``TraversabilityNode``
(timer thread, subscribers, the seven services) behind a
``TraversabilityServer`` (JSON lines over TCP), configured from the
reference's YAML files (``load_config``) or from the same parameters already
loaded (``config_from_documents``); a reference-format configuration's fusion
expression is evaluated inside the map-update kernel.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from traversability_estimation_tpu_torch.device import resolve_device
from traversability_estimation_tpu_torch.grid.gridmap import GridMap
from traversability_estimation_tpu_torch.models.estimator import (
    FootprintPath,
    TraversabilityEstimator,
    TraversabilityResult,
)
from traversability_estimation_tpu_torch.node import StampedPolygon, TraversabilityNode
from traversability_estimation_tpu_torch.ops.chain import FilterSpec
from traversability_estimation_tpu_torch.ops.filters import ChainConfig
from traversability_estimation_tpu_torch.service import TraversabilityClient, TraversabilityServer
from traversability_estimation_tpu_torch.utils.config import (
    EstimatorConfig,
    FootprintConfig,
    config_from_documents,
    load_config,
    reference_documents,
)
from traversability_estimation_tpu_torch.utils.sources import (
    ArraySource,
    SyntheticTerrainSource,
)

__all__ = [
    "ArraySource",
    "ChainConfig",
    "EstimatorConfig",
    "FilterSpec",
    "FootprintConfig",
    "FootprintPath",
    "GridMap",
    "StampedPolygon",
    "SyntheticTerrainSource",
    "TraversabilityClient",
    "TraversabilityEstimator",
    "TraversabilityNode",
    "TraversabilityResult",
    "TraversabilityServer",
    "config_from_documents",
    "load_config",
    "reference_documents",
    "resolve_device",
]
