"""Elevation input sources: the upstream side of the online loop.

A source is a host object whose ``sample(center_xy, length_xy)`` returns
``(elevation_patch, center_position)``, a robot-centric submap as an
elevation-mapping node would serve it; the estimator's online tick merges the
patch into the persistent map and refreshes traversability around it. Numpy
only.

- SyntheticTerrainSource: procedural rolling terrain with steps and holes,
  a fixed function of the world position, sampled in any window.
- ArraySource: windows of a fixed global elevation array.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticTerrainSource:
    resolution: float = 0.03
    seed: int = 0
    noise: float = 0.012
    hole_frac: float = 0.01

    def sample(self, center_xy, length_xy) -> Tuple[np.ndarray, np.ndarray]:
        """Sample a (rows, cols) window centred at `center_xy` covering
        `length_xy` metres. The terrain is a fixed function of the world
        position, so overlapping windows agree."""
        res = self.resolution
        rows = int(round(length_xy[0] / res))
        cols = int(round(length_xy[1] / res))
        # cell centres in the world frame, grid_map convention
        cx, cy = float(center_xy[0]), float(center_xy[1])
        x = cx + rows * res / 2 - 0.5 * res - np.arange(rows) * res
        y = cy + cols * res / 2 - 0.5 * res - np.arange(cols) * res
        X = np.broadcast_to(x[:, None], (rows, cols))
        Y = np.broadcast_to(y[None, :], (rows, cols))
        z = (
            0.15 * np.sin(0.7 * X) * np.cos(0.5 * Y)
            + 0.3 * ((np.sin(0.21 * X + 1.0) > 0.85) & (np.cos(0.17 * Y) > 0.4))
        )
        # per-cell noise and holes from integer world cell ids. floor, not
        # round: cell centres sit at half-integer multiples of res, so
        # round() would break ties differently between windows
        gi = np.floor(X / res).astype(np.int64)
        gj = np.floor(Y / res).astype(np.int64)
        h = (gi * 2654435761 + gj * 40503) & 0xFFFFFFFF
        u = h.astype(np.float64) / 2**32
        z = z + self.noise * (2.0 * u - 1.0)
        z = np.where(((h >> 8) & 0xFFFF) / 65536.0 < self.hole_frac, np.nan, z)
        return z.astype(np.float32), np.asarray([cx, cy], np.float32)


@dataclasses.dataclass
class ArraySource:
    """Windows over a fixed global array whose centre lies at the world
    position `position`; cells beyond the array are NaN."""

    elevation: np.ndarray
    resolution: float
    position: Tuple[float, float] = (0.0, 0.0)

    def sample(self, center_xy, length_xy) -> Tuple[np.ndarray, np.ndarray]:
        res = self.resolution
        rows = int(round(length_xy[0] / res))
        cols = int(round(length_xy[1] / res))
        H, W = self.elevation.shape
        half = np.array([H, W]) * res / 2.0
        # index of the requested window's top-left cell in the global array
        i0 = int(np.floor((self.position[0] + half[0] - (center_xy[0] + rows * res / 2)) / res))
        j0 = int(np.floor((self.position[1] + half[1] - (center_xy[1] + cols * res / 2)) / res))
        out = np.full((rows, cols), np.nan, np.float32)
        si0, sj0 = max(i0, 0), max(j0, 0)
        si1, sj1 = min(i0 + rows, H), min(j0 + cols, W)
        if si1 > si0 and sj1 > sj0:
            out[si0 - i0 : si1 - i0, sj0 - j0 : sj1 - j0] = self.elevation[si0:si1, sj0:sj1]
        return out, np.asarray(center_xy, np.float32)
