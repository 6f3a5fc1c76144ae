"""Typed estimator configuration (reference parameter names).

The reference configures itself from robot.yaml,
robot_filter_parameter.yaml and robot_footprint_parameter.yaml. This slice
of the port takes the configuration as dataclasses only: no YAML loader and
no declarative filter list yet (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from traversability_estimation_tpu_torch.ops.filters import ChainConfig
from traversability_estimation_tpu_torch.ops.veto import VetoConfig


@dataclasses.dataclass(frozen=True)
class FootprintConfig:
    """footprint/* parameters (robot_footprint_parameter.yaml)."""

    footprint_polygon: Tuple[Tuple[float, float], ...] = (
        (0.45, 0.30),
        (0.45, -0.30),
        (-0.45, -0.30),
        (-0.45, 0.30),
    )
    circular_footprint_radius: float = 0.541
    circular_footprint_radius_inscribed: float = 0.30
    circular_footprint_offset: float = 0.15
    footprint_frame_id: str = "base"
    traversability_default: float = 0.5
    verify_roughness_footprint: bool = False
    check_robot_inclination: bool = False


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Top-level config: node params + filter chain + footprint."""

    resolution: float = 0.03
    map_frame_id: str = "map"
    robot_frame_id: str = "base"
    min_update_rate: float = 1.0
    map_length: Tuple[float, float] = (4.0, 4.0)
    map_center: Tuple[float, float] = (0.0, 0.0)
    footprint_yaw: float = 1.5708
    max_gap_width: float = 0.3
    use_raw_map: bool = False
    chain: ChainConfig = None  # type: ignore[assignment]
    footprint: FootprintConfig = dataclasses.field(default_factory=FootprintConfig)
    use_generic_chain: bool = False

    def __post_init__(self):
        if self.chain is None:
            object.__setattr__(self, "chain", ChainConfig(resolution=self.resolution))
        if self.use_generic_chain:
            raise NotImplementedError(
                "use_generic_chain is not ported yet (ROADMAP A11: generic chain "
                "and fusion_expression)"
            )

    @property
    def veto(self) -> VetoConfig:
        return VetoConfig(
            resolution=self.chain.resolution,
            critical_step_height=self.chain.step_critical_value,
            max_gap_width=self.max_gap_width,
            check_roughness=self.footprint.verify_roughness_footprint,
        )
