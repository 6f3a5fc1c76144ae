"""Layer dumps for the command line's ``--dump-png``: any layer as PNG and
NPY on the host (numpy only), with the reference's value conventions (0..1
traversability, NaN rendered grey)."""

from __future__ import annotations

import os
from typing import Dict, Optional

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
