"""A minimal layered grid map: named (H, W) tensors on one device plus the
map geometry. grid_map conventions: index (0, 0) is the +x/+y corner, x
decreases with the row index and y with the column index."""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class GridMap:
    layers: Dict[str, torch.Tensor]
    resolution: float
    position: torch.Tensor  # (2,) f32 map center in the map frame
    frame_id: str = "map"

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.layers[name]

    @property
    def size(self) -> Tuple[int, int]:
        return tuple(next(iter(self.layers.values())).shape)

    def add_all(self, updates: Mapping[str, torch.Tensor]) -> "GridMap":
        """A map with the float32 (H, W) layers of `updates` added or
        replaced; this one stays as it is."""
        rows, cols = self.size
        layers = dict(self.layers)
        for name, arr in updates.items():
            layers[name] = arr.to(torch.float32).reshape(rows, cols)
        return dataclasses.replace(self, layers=layers)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self.layers.items()}
