"""Declarative filter chain: the pluginlib / FilterChain counterpart.

The reference composes its per-cell map pipeline from dynamically loaded
``filters::FilterBase<grid_map::GridMap>`` plugins configured as an ordered
name/type/params list (``config/robot_filter_parameter.yaml``). This module
keeps that contract (the same list, the same type names, the same parameter
names) and composes the chain as one layers -> layers function of torch ops;
"reconfigure" is compiling a new spec list.

The canonical chain (normals, slope, step, roughness, fusion) does not come
through here: ``utils/config.py`` recognises it and routes it to the fused
map update (kernel 1 on CUDA). This module serves every other chain: extra
filters, custom layer names, reordered stages. No function of the JAX
package's generic chain reaches a TPU kernel, so it has none here either.

Supported filter types:

  gridMapFilters/NormalVectorsFilter      radius, input_layer, output_layers_prefix
  traversabilityFilters/SlopeFilter       critical_value, map_type
  traversabilityFilters/StepFilter        critical_value, first/second_window_radius,
                                          critical_cell_number, map_type
  traversabilityFilters/RoughnessFilter   critical_value, estimation_radius, map_type
  gridMapFilters/MathExpressionFilter     expression, output_layer (ops/expr.py)
  gridMapFilters/DeletionFilter           layers
  gridMapFilters/DuplicationFilter        input_layer, output_layer
  gridMapFilters/ThresholdFilter          layer/condition_layer(+output_layer),
                                          lower/upper_threshold, set_to
  gridMapFilters/MeanInRadiusFilter       input_layer, output_layer, radius
  gridMapFilters/MinInRadiusFilter        input_layer, output_layer, radius
  gridMapFilters/MaxInRadiusFilter        input_layer, output_layer, radius
  gridMapFilters/SetBasicLayersFilter     layers (metadata only)

Unknown types raise when the chain is compiled, like a failed plugin load.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Sequence, Tuple

import torch

from traversability_estimation_tpu_torch.grid.geometry import circle_offsets
from traversability_estimation_tpu_torch.ops import expr as expr_mod
from traversability_estimation_tpu_torch.ops import filters as f_ops

Layers = Dict[str, torch.Tensor]


def _freeze(value):
    """Recursively convert YAML params into hashable static values."""
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """One chain entry: the reference's {name, type, params} YAML item,
    frozen and hashable so a chain of specs can sit in a frozen config."""

    name: str
    type: str
    params: Tuple[Tuple[str, object], ...] = ()

    @staticmethod
    def from_dict(entry: Mapping) -> "FilterSpec":
        return FilterSpec(
            name=str(entry.get("name", "")),
            type=str(entry.get("type", "")),
            params=_freeze(entry.get("params", {}) or {}),
        )

    def param(self, key: str, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default


class ChainCompileError(ValueError):
    """Unknown filter type or missing required parameter (a failed plugin
    load or configure)."""


# --- individual filter factories -------------------------------------------
# Each factory: (spec, resolution) -> Callable[[Layers], Layers]


def _normal_vectors(spec: FilterSpec, res: float):
    radius = float(spec.param("radius", 0.05))
    in_layer = str(spec.param("input_layer", "elevation"))
    prefix = str(spec.param("output_layers_prefix", "surface_normal_"))

    def apply(layers: Layers) -> Layers:
        normals = f_ops.surface_normals(layers[in_layer], res, radius)
        out = dict(layers)
        out[prefix + "x"] = normals["surface_normal_x"]
        out[prefix + "y"] = normals["surface_normal_y"]
        out[prefix + "z"] = normals["surface_normal_z"]
        return out

    return apply


def _slope(spec: FilterSpec, res: float):
    critical = float(spec.param("critical_value", 0.3))
    out_layer = str(spec.param("map_type", "traversability_slope"))

    def apply(layers: Layers) -> Layers:
        nz = layers.get("surface_normal_z")
        if nz is None:
            raise ChainCompileError(
                "SlopeFilter requires surface normals earlier in the chain "
                "(it reads surface_normal_z)"
            )
        out = dict(layers)
        out[out_layer] = f_ops.slope_from_normals(nz, critical)
        return out

    return apply


def _step(spec: FilterSpec, res: float):
    out_layer = str(spec.param("map_type", "traversability_step"))
    critical = float(spec.param("critical_value", 0.3))
    w1 = float(spec.param("first_window_radius", 0.08))
    w2 = float(spec.param("second_window_radius", 0.08))
    ncrit = int(spec.param("critical_cell_number", 5))

    def apply(layers: Layers) -> Layers:
        out = dict(layers)
        out[out_layer] = f_ops.step_layer(layers["elevation"], res, critical, w1, w2, ncrit)
        return out

    return apply


def _roughness(spec: FilterSpec, res: float):
    out_layer = str(spec.param("map_type", "traversability_roughness"))
    critical = float(spec.param("critical_value", 0.3))
    radius = float(spec.param("estimation_radius", 0.3))

    def apply(layers: Layers) -> Layers:
        normals = {
            "surface_normal_x": layers["surface_normal_x"],
            "surface_normal_y": layers["surface_normal_y"],
            "surface_normal_z": layers["surface_normal_z"],
        }
        out = dict(layers)
        out[out_layer] = f_ops.roughness_layer(layers["elevation"], normals, res, critical, radius)
        return out

    return apply


def _math_expression(spec: FilterSpec, res: float):
    out_layer = str(spec.param("output_layer", "traversability"))
    src = str(spec.param("expression", ""))
    if not src:
        raise ChainCompileError(f"MathExpressionFilter {spec.name!r}: empty expression")
    ast = expr_mod.parse(src)

    def apply(layers: Layers) -> Layers:
        out = dict(layers)
        out[out_layer] = expr_mod.evaluate(ast, layers).to(torch.float32)
        return out

    return apply


def _deletion(spec: FilterSpec, res: float):
    victims = tuple(str(v) for v in (spec.param("layers", ()) or ()))

    def apply(layers: Layers) -> Layers:
        return {k: v for k, v in layers.items() if k not in victims}

    return apply


def _duplication(spec: FilterSpec, res: float):
    in_layer = str(spec.param("input_layer", ""))
    out_layer = str(spec.param("output_layer", ""))
    if not in_layer or not out_layer:
        raise ChainCompileError(f"DuplicationFilter {spec.name!r}: need input/output")

    def apply(layers: Layers) -> Layers:
        out = dict(layers)
        out[out_layer] = layers[in_layer]
        return out

    return apply


def _threshold(spec: FilterSpec, res: float):
    # grid_map ThresholdFilter: where the condition layer crosses the
    # threshold, write set_to into the output layer (the condition layer by
    # default)
    layer = str(spec.param("condition_layer", spec.param("layer", "")))
    out_layer = str(spec.param("output_layer", layer))
    lower = spec.param("lower_threshold")
    upper = spec.param("upper_threshold")
    set_to = f_ops.f32(float(spec.param("set_to", 0.0)))
    if not layer or (lower is None and upper is None):
        raise ChainCompileError(
            f"ThresholdFilter {spec.name!r}: need layer and lower/upper_threshold"
        )

    def apply(layers: Layers) -> Layers:
        cond = layers[layer]
        target = layers.get(out_layer, cond)
        hit = torch.zeros_like(cond, dtype=torch.bool)
        if lower is not None:
            hit = hit | (cond < f_ops.f32(float(lower)))
        if upper is not None:
            hit = hit | (cond > f_ops.f32(float(upper)))
        out = dict(layers)
        out[out_layer] = torch.where(hit, set_to, target)
        return out

    return apply


def _in_radius(reduction: str):
    def build(spec: FilterSpec, res: float):
        in_layer = str(spec.param("input_layer", "elevation"))
        out_layer = str(spec.param("output_layer", in_layer))
        radius = float(spec.param("radius", res))
        offs = circle_offsets(radius, res).tolist()

        def apply(layers: Layers) -> Layers:
            src = layers[in_layer].to(torch.float32)
            valid = torch.isfinite(src)
            if reduction == "mean":
                acc = torch.zeros_like(src)
                cnt = torch.zeros_like(src)
                zf = torch.where(valid, src, 0.0)
                vf = valid.to(torch.float32)
                for di, dj in offs:
                    acc = acc + f_ops._shifted(zf, di, dj, 0.0)
                    cnt = cnt + f_ops._shifted(vf, di, dj, 0.0)
                res_plane = acc / torch.where(cnt > 0, cnt, float("nan"))
            else:
                neutral = f_ops.POS if reduction == "min" else f_ops.NEG
                op = torch.minimum if reduction == "min" else torch.maximum
                acc = torch.full_like(src, neutral)
                any_v = torch.zeros_like(valid)
                filled = torch.where(valid, src, neutral)
                for di, dj in offs:
                    acc = op(acc, f_ops._shifted(filled, di, dj, neutral))
                    any_v = any_v | f_ops._shifted(valid, di, dj, False)
                res_plane = torch.where(any_v, acc, float("nan"))
            out = dict(layers)
            out[out_layer] = res_plane
            return out

        return apply

    return build


def _set_basic_layers(spec: FilterSpec, res: float):
    def apply(layers: Layers) -> Layers:  # metadata only in grid_map
        return layers

    return apply


_REGISTRY: Dict[str, Callable[[FilterSpec, float], Callable[[Layers], Layers]]] = {
    "gridMapFilters/NormalVectorsFilter": _normal_vectors,
    "traversabilityFilters/SlopeFilter": _slope,
    "traversabilityFilters/StepFilter": _step,
    "traversabilityFilters/RoughnessFilter": _roughness,
    "gridMapFilters/MathExpressionFilter": _math_expression,
    "gridMapFilters/DeletionFilter": _deletion,
    "gridMapFilters/DuplicationFilter": _duplication,
    "gridMapFilters/ThresholdFilter": _threshold,
    "gridMapFilters/MeanInRadiusFilter": _in_radius("mean"),
    "gridMapFilters/MinInRadiusFilter": _in_radius("min"),
    "gridMapFilters/MaxInRadiusFilter": _in_radius("max"),
    "gridMapFilters/SetBasicLayersFilter": _set_basic_layers,
}


def register_filter(type_name: str, factory) -> None:
    """Extension point: the counterpart of exporting a new pluginlib plugin."""
    _REGISTRY[type_name] = factory


def available_filters() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def compile_chain(
    specs: Sequence[FilterSpec | Mapping], resolution: float
) -> Callable[[Layers], Layers]:
    """Compile an ordered spec list into one composite layers -> layers
    function."""
    built = []
    for entry in specs:
        spec = entry if isinstance(entry, FilterSpec) else FilterSpec.from_dict(entry)
        factory = _REGISTRY.get(spec.type)
        if factory is None:
            raise ChainCompileError(
                f"unknown filter type {spec.type!r} (filter {spec.name!r}); "
                f"known: {available_filters()}"
            )
        built.append(factory(spec, resolution))

    def chain(layers: Layers) -> Layers:
        out = dict(layers)
        for fn in built:
            out = fn(out)
        return out

    return chain


def run_spec_chain(layers: Layers, specs: Tuple[FilterSpec, ...], resolution: float) -> Layers:
    """The generic chain over a dict of (H, W) layer planes."""
    return compile_chain(specs, resolution)(layers)
