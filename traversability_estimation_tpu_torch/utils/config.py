"""Typed estimator configuration with reference-YAML compatibility.

The reference configures itself from three YAML files loaded by rosparam:
``robot.yaml``, ``robot_filter_parameter.yaml`` and
``robot_footprint_parameter.yaml``. :func:`load_config` reads those files
(the same parameter names, the same filter-chain list) into typed
dataclasses; :func:`config_from_documents` does the same from documents that
are already loaded, so a caller without PyYAML (or with the parameters in
hand) needs no file. A reload merges onto a base config, as ``rosparam load``
does: what the documents do not mention keeps its value.

A filter list that the fused map update represents exactly (the canonical
chain: normals, slope, step, roughness, a MathExpressionFilter into
``traversability``, a DeletionFilter of the normals) configures
``ChainConfig``, its expression included; any other list sets
``use_generic_chain`` and runs through ``ops/chain.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

from traversability_estimation_tpu_torch.ops.chain import FilterSpec
from traversability_estimation_tpu_torch.ops.filters import ChainConfig
from traversability_estimation_tpu_torch.ops.veto import VetoConfig

# chain shapes the fused map update (ops/filters.run_chain, kernel 1) reproduces exactly:
# at most one of each canonical filter, normals first, default output names
_CANONICAL_TYPES = {
    "gridMapFilters/NormalVectorsFilter",
    "traversabilityFilters/SlopeFilter",
    "traversabilityFilters/StepFilter",
    "traversabilityFilters/RoughnessFilter",
    "gridMapFilters/MathExpressionFilter",
    "gridMapFilters/DeletionFilter",
}
_DEFAULT_OUTPUTS = {
    "traversabilityFilters/SlopeFilter": "traversability_slope",
    "traversabilityFilters/StepFilter": "traversability_step",
    "traversabilityFilters/RoughnessFilter": "traversability_roughness",
}


_CANONICAL_ORDER = (
    "gridMapFilters/NormalVectorsFilter",
    "traversabilityFilters/SlopeFilter",
    "traversabilityFilters/StepFilter",
    "traversabilityFilters/RoughnessFilter",
    "gridMapFilters/MathExpressionFilter",
    "gridMapFilters/DeletionFilter",
)
_NORMAL_LAYERS = {"surface_normal_x", "surface_normal_y", "surface_normal_z"}


def _is_canonical(specs: Sequence[FilterSpec]) -> bool:
    """True ONLY when the fused fast path (ChainConfig) represents this chain
    exactly: each canonical filter at most once, in the reference order
    (the fused path computes normals -> slope -> step -> roughness ->
    fusion regardless of the list), default layer names, and a Deletion
    stage that drops nothing but the normals (the fused path never persists
    them anyway). Anything else routes through the generic compiled chain."""
    order_pos = -1
    for s in specs:
        if s.type not in _CANONICAL_TYPES:
            return False
        pos = _CANONICAL_ORDER.index(s.type)
        if pos <= order_pos:  # out of order or duplicate
            return False
        order_pos = pos
        if s.type == "gridMapFilters/NormalVectorsFilter":
            if s.param("input_layer", "elevation") != "elevation" or s.param(
                "output_layers_prefix", "surface_normal_"
            ) != "surface_normal_":
                return False
        elif s.type in _DEFAULT_OUTPUTS:
            if s.param("map_type", _DEFAULT_OUTPUTS[s.type]) != _DEFAULT_OUTPUTS[s.type]:
                return False
        elif s.type == "gridMapFilters/MathExpressionFilter":
            if s.param("output_layer", "traversability") != "traversability":
                return False
        elif s.type == "gridMapFilters/DeletionFilter":
            victims = set(str(v) for v in (s.param("layers", ()) or ()))
            if not victims <= _NORMAL_LAYERS:
                return False
    return True


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
    # the full declarative chain (ops/chain.py). With `use_generic_chain` (a
    # configured chain the fused update cannot represent) map updates run the
    # generic chain instead of ops/filters.run_chain; `chain` still carries
    # the parameters extracted for the veto cascade (critical step height).
    filter_specs: Tuple[FilterSpec, ...] = ()
    use_generic_chain: bool = False

    def __post_init__(self):
        if self.chain is None:
            object.__setattr__(self, "chain", ChainConfig(resolution=self.resolution))

    @property
    def veto(self) -> VetoConfig:
        return VetoConfig(
            resolution=self.chain.resolution,
            critical_step_height=self.chain.step_critical_value,
            max_gap_width=self.max_gap_width,
            check_roughness=self.footprint.verify_roughness_footprint,
        )

    @property
    def elevation_layers(self) -> Tuple[str, ...]:
        """The layers an elevation map message must carry
        (TraversabilityMap::createLayers)."""
        if self.use_raw_map:
            return (
                "elevation",
                "variance",
                "horizontal_variance_x",
                "horizontal_variance_y",
                "horizontal_variance_xy",
                "time",
            )
        return ("elevation", "upper_bound", "lower_bound")


def _chain_from_filter_list(filters: Sequence[dict], resolution: float) -> ChainConfig:
    """Build a ChainConfig from the reference's traversability_map_filters
    list (name/type/params entries, robot_filter_parameter.yaml)."""
    kw: Dict[str, object] = {"resolution": resolution}
    fusion_expression: Optional[str] = None
    for entry in filters:
        ftype = entry.get("type", "")
        params = entry.get("params", {}) or {}
        if ftype.endswith("NormalVectorsFilter"):
            kw["normals_radius"] = float(params.get("radius", 0.05))
        elif ftype.endswith("SlopeFilter"):
            kw["slope_critical_value"] = float(params.get("critical_value", 1.0))
        elif ftype.endswith("StepFilter"):
            kw["step_critical_value"] = float(params.get("critical_value", 0.12))
            kw["step_first_window_radius"] = float(
                params.get("first_window_radius", 0.04)
            )
            kw["step_second_window_radius"] = float(
                params.get("second_window_radius", 0.04)
            )
            kw["step_critical_cell_number"] = int(
                params.get("critical_cell_number", 4)
            )
        elif ftype.endswith("RoughnessFilter"):
            kw["roughness_critical_value"] = float(params.get("critical_value", 0.3))
            kw["roughness_estimation_radius"] = float(
                params.get("estimation_radius", 0.3)
            )
        elif ftype.endswith("MathExpressionFilter"):
            fusion_expression = str(params.get("expression", ""))
        # DeletionFilter: no-op — normals never persist unless asked for
    if fusion_expression:
        kw["fusion_expression"] = fusion_expression
    return ChainConfig(**kw)


def config_from_documents(
    robot: Optional[Mapping] = None,
    filters: Optional[Sequence[Mapping]] = None,
    footprint: Optional[Mapping] = None,
    resolution: float = 0.03,
    base: Optional["EstimatorConfig"] = None,
) -> EstimatorConfig:
    """An EstimatorConfig from already-loaded reference-format documents:
    `robot` the mapping of ``robot.yaml``, `filters` the
    ``traversability_map_filters`` list of ``robot_filter_parameter.yaml``,
    `footprint` the ``footprint`` mapping of
    ``robot_footprint_parameter.yaml``. Any may be omitted. With `base` (the
    reload path) parameters the documents do not mention keep the base
    config's values, its resolution included; without it the defaults are
    the reference code's."""
    robot = robot or {}
    filters = list(filters or [])
    fp_doc = footprint or {}
    if base is not None:
        resolution = base.resolution
    bf = base.footprint if base is not None else FootprintConfig()

    if filters:
        chain = _chain_from_filter_list(filters, resolution)
        specs = tuple(FilterSpec.from_dict(e) for e in filters)
        generic = bool(specs) and not _is_canonical(specs)
    elif base is not None:
        chain = base.chain
        specs = base.filter_specs
        generic = base.use_generic_chain
    else:
        chain = _chain_from_filter_list([], resolution)
        specs = ()
        generic = False

    def fp(key, cast):
        return cast(fp_doc.get(key, getattr(bf, key)))

    footprint_cfg = FootprintConfig(
        footprint_polygon=tuple(
            tuple(p) for p in fp_doc.get("footprint_polygon", bf.footprint_polygon)
        ),
        circular_footprint_radius=fp("circular_footprint_radius", float),
        circular_footprint_radius_inscribed=fp("circular_footprint_radius_inscribed", float),
        circular_footprint_offset=fp("circular_footprint_offset", float),
        footprint_frame_id=fp("footprint_frame_id", str),
        traversability_default=fp("traversability_default", float),
        verify_roughness_footprint=fp("verify_roughness_footprint", bool),
        check_robot_inclination=fp("check_robot_inclination", bool),
    )
    b = base if base is not None else EstimatorConfig(resolution=resolution)
    return EstimatorConfig(
        resolution=resolution,
        map_frame_id=str(robot.get("map_frame_id", b.map_frame_id)),
        robot_frame_id=str(robot.get("robot_frame_id", b.robot_frame_id)),
        min_update_rate=float(robot.get("min_update_rate", b.min_update_rate)),
        map_length=(
            float(robot.get("map_length_x", b.map_length[0])),
            float(robot.get("map_length_y", b.map_length[1])),
        ),
        map_center=(
            float(robot.get("map_center_x", b.map_center[0])),
            float(robot.get("map_center_y", b.map_center[1])),
        ),
        footprint_yaw=float(robot.get("footprint_yaw", b.footprint_yaw)),
        max_gap_width=float(robot.get("max_gap_width", b.max_gap_width)),
        use_raw_map=bool(robot.get("use_raw_map", b.use_raw_map)),
        chain=chain,
        footprint=footprint_cfg,
        filter_specs=specs,
        use_generic_chain=generic,
    )


def load_config(
    robot_yaml: Optional[str] = None,
    filter_yaml: Optional[str] = None,
    footprint_yaml: Optional[str] = None,
    resolution: float = 0.03,
    base: Optional["EstimatorConfig"] = None,
) -> EstimatorConfig:
    """Load an EstimatorConfig from reference-format YAML files (needs
    PyYAML, imported here and nowhere else). Any file may be omitted; `base`
    as in :func:`config_from_documents`."""
    import yaml

    def document(path) -> dict:
        if not path:
            return {}
        with open(path) as f:
            return yaml.safe_load(f) or {}

    return config_from_documents(
        robot=document(robot_yaml),
        filters=document(filter_yaml).get("traversability_map_filters", []),
        footprint=document(footprint_yaml).get("footprint", {}),
        resolution=resolution,
        base=base,
    )


def reference_documents() -> Dict[str, object]:
    """The upstream ``anymal`` parameter set (leggedrobotics'
    traversability_estimation, ``config/robot.yaml``,
    ``config/robot_filter_parameter.yaml`` and
    ``config/robot_footprint_parameter.yaml``) as loaded documents, ready for
    ``config_from_documents(**reference_documents())``: the canonical filter
    list with its fusion expression, the filter values this package takes as
    defaults, and the footprint of ``FootprintConfig``."""
    return {
        "robot": {
            "map_frame_id": "map",
            "robot_frame_id": "base",
            "min_update_rate": 1.0,
            "map_length_x": 4.0,
            "map_length_y": 4.0,
            "footprint_yaw": 1.5708,
            "max_gap_width": 0.3,
        },
        "filters": [
            {"name": "surface_normals", "type": "gridMapFilters/NormalVectorsFilter",
             "params": {"input_layer": "elevation", "output_layers_prefix": "surface_normal_",
                        "radius": 0.05, "normal_vector_positive_axis": "z"}},
            {"name": "slope", "type": "traversabilityFilters/SlopeFilter",
             "params": {"map_type": "traversability_slope", "critical_value": 1.0}},
            {"name": "step", "type": "traversabilityFilters/StepFilter",
             "params": {"map_type": "traversability_step", "critical_value": 0.12,
                        "first_window_radius": 0.04, "second_window_radius": 0.04,
                        "critical_cell_number": 4}},
            {"name": "roughness", "type": "traversabilityFilters/RoughnessFilter",
             "params": {"map_type": "traversability_roughness", "critical_value": 0.05,
                        "estimation_radius": 0.05}},
            {"name": "weighted_sum", "type": "gridMapFilters/MathExpressionFilter",
             "params": {"output_layer": "traversability",
                        "expression": "(1.0 / 3.0) * (traversability_slope + "
                                      "traversability_step + traversability_roughness)"}},
            {"name": "delete_normals", "type": "gridMapFilters/DeletionFilter",
             "params": {"layers": ["surface_normal_x", "surface_normal_y", "surface_normal_z"]}},
        ],
        "footprint": {
            "footprint_polygon": [[0.45, 0.30], [0.45, -0.30], [-0.45, -0.30], [-0.45, 0.30]],
            "circular_footprint_radius": 0.541,
            "circular_footprint_radius_inscribed": 0.30,
            "circular_footprint_offset": 0.15,
            "footprint_frame_id": "base",
            "traversability_default": 0.5,
            "verify_roughness_footprint": False,
            "check_robot_inclination": False,
        },
    }
