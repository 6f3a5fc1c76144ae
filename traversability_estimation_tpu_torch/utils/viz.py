"""Visualization on the host (numpy only): layer dumps for the command
line's ``--dump-png`` (any layer as PNG and NPY, with the reference's value
conventions: 0..1 traversability, NaN rendered grey), and the products of the
reference's grid_map_visualization node (occupancy grids of the
traversability layers, a point cloud of the elevation) driven by the same
visualization YAML."""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np


def layer_to_rgb(
    layer: np.ndarray,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
) -> np.ndarray:
    """(H, W) layer -> (H, W, 3) uint8. Green=traversable, red=blocked,
    grey=NaN (unknown). No matplotlib dependency."""
    a = np.asarray(layer, np.float64)
    finite = np.isfinite(a)
    lo = np.nanmin(a) if vmin is None else vmin
    hi = np.nanmax(a) if vmax is None else vmax
    if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
        lo, hi = 0.0, 1.0
    # mask NaN before the arithmetic/cast: casting NaN to uint8 raises
    # RuntimeWarnings and is UB-adjacent; unknown cells render grey anyway
    t = np.clip((np.where(finite, a, lo) - lo) / (hi - lo), 0.0, 1.0)
    rgb = np.zeros(a.shape + (3,), np.uint8)
    rgb[..., 0] = np.where(finite, ((1.0 - t) * 255).astype(np.uint8), 128)
    rgb[..., 1] = np.where(finite, (t * 255).astype(np.uint8), 128)
    rgb[..., 2] = np.where(finite, 0, 128)
    return rgb


def write_png(path: str, rgb: np.ndarray):
    """Minimal PNG writer (no deps): 8-bit RGB."""
    import struct
    import zlib

    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def dump_layers(layers: Dict[str, np.ndarray], out_dir: str, prefix: str = "map"):
    """Write every layer as PNG (+ raw .npy) into out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, layer in layers.items():
        arr = np.asarray(layer)
        if arr.dtype == bool:
            arr = arr.astype(np.float32)
        base = os.path.join(out_dir, f"{prefix}_{name}")
        np.save(base + ".npy", arr)
        write_png(base + ".png", layer_to_rgb(arr))
        written.append(base + ".png")
    return written


# ---------------------------------------------------------------------------
# grid_map_visualization
# ---------------------------------------------------------------------------
# The reference ships a visualization node config mapping four traversability
# layers to ROS occupancy grids and the elevation layer to a point cloud
# (traversability_estimation/config/visualization/traversability.yaml,
# launch/visualization.launch). These helpers produce the same products as
# plain arrays / structured data, driven by the same YAML.


def occupancy_grid(
    layer: np.ndarray, data_min: float, data_max: float
) -> np.ndarray:
    """grid_map_visualization OccupancyGridVisualization parity: linearly map
    [data_min, data_max] -> occupancy [0, 100]; unknown (NaN) -> -1. The
    shipped config uses data_min=1.0 > data_max=0.0, i.e. traversable=free(0),
    blocked=occupied(100). Returns int8 (rows, cols)."""
    arr = np.asarray(layer, np.float64)
    span = data_max - data_min
    if span == 0.0:
        scaled = np.zeros_like(arr)
    else:
        scaled = (arr - data_min) / span * 100.0
    out = np.clip(np.round(scaled), 0.0, 100.0)
    grid = np.where(np.isfinite(arr), out, -1.0).astype(np.int8)
    return grid


def point_cloud(
    layers: Dict[str, np.ndarray],
    z_layer: str,
    resolution: float,
    position=(0.0, 0.0),
    extra_layers: tuple = (),
) -> np.ndarray:
    """PointCloudVisualization parity: one point per valid z-layer cell at the
    cell-center map position, with optional extra per-point channels.
    Returns a structured array with fields x, y, z (+ extra layer names)."""
    z = np.asarray(layers[z_layer], np.float32)
    rows, cols = z.shape
    x = position[0] + rows * resolution / 2 - (np.arange(rows) + 0.5) * resolution
    y = position[1] + cols * resolution / 2 - (np.arange(cols) + 0.5) * resolution
    X = np.broadcast_to(x[:, None], z.shape)
    Y = np.broadcast_to(y[None, :], z.shape)
    valid = np.isfinite(z)
    fields = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    fields += [(name, np.float32) for name in extra_layers]
    out = np.empty(int(valid.sum()), dtype=fields)
    out["x"] = X[valid]
    out["y"] = Y[valid]
    out["z"] = z[valid]
    for name in extra_layers:
        out[name] = np.asarray(layers[name], np.float32)[valid]
    return out


def visualizations_from_yaml(
    yaml_path: Union[str, os.PathLike, dict],
    layers: Dict[str, np.ndarray],
    resolution: float,
    position=(0.0, 0.0),
) -> Dict[str, np.ndarray]:
    """Run a reference-format grid_map_visualizations document over a layer
    dict: occupancy_grid entries -> int8 grids, point_cloud entries ->
    structured point arrays. Entries whose layer is absent are skipped (the
    reference node logs and skips them the same way).

    `yaml_path` is the YAML file, or the document already loaded (a dict
    with a ``grid_map_visualizations`` list): only a path needs PyYAML,
    which is imported here and nowhere at import time."""
    if isinstance(yaml_path, dict):
        doc = yaml_path
    else:
        import yaml as _yaml

        with open(yaml_path) as f:
            doc = _yaml.safe_load(f) or {}
    out: Dict[str, np.ndarray] = {}
    for entry in doc.get("grid_map_visualizations", []):
        name = entry.get("name", "")
        vtype = entry.get("type", "")
        params = entry.get("params", {}) or {}
        layer = params.get("layer", "")
        if layer not in layers:
            continue
        if vtype == "occupancy_grid":
            out[name] = occupancy_grid(
                layers[layer],
                float(params.get("data_min", 0.0)),
                float(params.get("data_max", 1.0)),
            )
        elif vtype == "point_cloud":
            out[name] = point_cloud(layers, layer, resolution, position)
    return out
