"""State carried into the port from plain values.

The engine has no weights; what moves between the JAX package and the port
is configuration and map state: a query state, or a whole estimator's state
in the middle of an online loop. All of it arrives as plain fields (dicts,
numpy arrays), so this module needs nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from traversability_estimation_tpu_torch.device import DeviceLike, resolve_device
from traversability_estimation_tpu_torch.grid.gridmap import GridMap
from traversability_estimation_tpu_torch.models.estimator import TraversabilityEstimator
from traversability_estimation_tpu_torch.ops.chain import FilterSpec
from traversability_estimation_tpu_torch.ops.filters import ChainConfig
from traversability_estimation_tpu_torch.ops.footprint import QueryState
from traversability_estimation_tpu_torch.utils.config import EstimatorConfig, FootprintConfig


def _as_fields(obj_or_dict: Any) -> Mapping[str, Any]:
    if dataclasses.is_dataclass(obj_or_dict) and not isinstance(obj_or_dict, type):
        return dataclasses.asdict(obj_or_dict)
    return obj_or_dict


def _tuples(x):
    """Lists (as ``dataclasses.asdict`` or a serialiser leaves them) back to
    the hashable tuples the frozen configs hold."""
    if isinstance(x, (list, tuple)):
        return tuple(_tuples(v) for v in x)
    return x


def _build(cls, fields: Mapping[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: _tuples(v) for k, v in fields.items() if k in names})


def config_from_fields(obj_or_dict: Any) -> EstimatorConfig:
    """The port's EstimatorConfig from an estimator config's fields: a
    dataclass instance with the same field names (the JAX package's
    ``EstimatorConfig``) or its ``dataclasses.asdict``.

    Filter specs (dataclass instances or their fields) become the port's
    ``FilterSpec``s, and ``use_generic_chain`` is carried across, so both
    packages run the same chain."""
    fields = dict(_as_fields(obj_or_dict))
    fields["filter_specs"] = tuple(
        _build(FilterSpec, _as_fields(spec)) for spec in fields.get("filter_specs") or ()
    )
    chain = fields.get("chain")
    if chain is not None and not isinstance(chain, ChainConfig):
        fields["chain"] = _build(ChainConfig, _as_fields(chain))
    footprint = fields.get("footprint")
    if footprint is not None and not isinstance(footprint, FootprintConfig):
        fields["footprint"] = _build(FootprintConfig, _as_fields(footprint))
    return _build(EstimatorConfig, fields)


def query_state_from_numpy(
    traversability: np.ndarray,
    traversable_mask: np.ndarray,
    position,
    resolution: float,
    default: float = 0.5,
    device: DeviceLike = None,
) -> QueryState:
    """The port's QueryState from host arrays (float32 traversability with NaN
    unknown, bool mask, (2,) map position)."""
    dev = resolve_device(device)
    return QueryState(
        traversability=torch.as_tensor(
            np.array(traversability, dtype=np.float32), dtype=torch.float32, device=dev
        ),
        traversable_mask=torch.as_tensor(
            np.array(traversable_mask, dtype=bool), dtype=torch.bool, device=dev
        ),
        position=torch.as_tensor(
            np.array(position, dtype=np.float32).reshape(2), dtype=torch.float32, device=dev
        ),
        resolution=float(resolution),
        default_traversability=float(default),
    )


def estimator_from_state(
    config: EstimatorConfig,
    elevation: np.ndarray,
    position,
    map_layers: Mapping[str, np.ndarray],
    extra_layers: Optional[Mapping[str, np.ndarray]] = None,
    traversability_default: Optional[float] = None,
    initialized: bool = True,
    device: DeviceLike = None,
) -> TraversabilityEstimator:
    """The port's estimator set up in the middle of a loop from another
    estimator's state as host arrays, without running ``update()``:
    `elevation` (the persistent plane), `position` (the map centre),
    `map_layers` (every layer of the traversability map, bool veto planes as
    bool), `extra_layers`, the current default traversability and the
    initialised flag. The next ``online_tick`` continues from there."""
    est = TraversabilityEstimator(config, device=device)
    est.set_elevation_map(elevation, position, extra_layers)
    if traversability_default is not None:
        est.set_default_traversability(traversability_default)
    if map_layers:
        layers = {}
        for name, plane in map_layers.items():
            # a copy the estimator owns, bool planes kept bool
            plane = np.array(plane, dtype=bool if np.asarray(plane).dtype == np.bool_ else np.float32)
            layers[name] = torch.as_tensor(plane, device=est.device)
        layers["elevation"] = est._elevation
        est._map = GridMap(
            layers=layers,
            resolution=config.chain.resolution,
            position=est._position_tensor(),
            frame_id=config.map_frame_id,
        )
        est._set_query_state(layers)
    est.initialized = bool(initialized)
    return est
