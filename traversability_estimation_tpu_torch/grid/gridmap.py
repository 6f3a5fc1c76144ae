"""GridMap: the multi-layer grid data model, named (rows, cols) tensors on
one device plus the map geometry.

Geometry conventions follow grid_map:

- ``size = (rows, cols)``; the row index runs along the map-frame x axis,
  the column index along y. Index (0, 0) is the corner with the LARGEST x
  and y.
- cell centre: ``pos(i) = position + 0.5*length - 0.5*res - i*res`` per axis.
- position -> index: ``i = floor((position + 0.5*length - pos) / res)``.
- a position is inside the map iff ``pos in (position - L/2, position + L/2]``
  per axis (upper edge inclusive, lower exclusive).

Every update returns a new map and leaves this one as it is: layers are
replaced, never written in place, so a map handed out earlier keeps its
values. Recentring is a roll plus a fill on the device, with a zero start
index throughout. Cells without data are NaN ("unknown").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from traversability_estimation_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class GridMap:
    """Immutable multi-layer grid map.

    layers: layer name -> (rows, cols) tensor, float32 with NaN = no data
      (the veto planes are bool).
    resolution: cell edge length [m].
    position: (2,) float32 tensor, map-frame position of the grid centre.
    basic_layers: layers that define cell validity (grid_map's ``isValid``).
    """

    layers: Dict[str, torch.Tensor]
    resolution: float
    position: torch.Tensor
    frame_id: str = "map"
    basic_layers: Tuple[str, ...] = ()

    # -- constructors ------------------------------------------------------
    @classmethod
    def create(
        cls,
        size: Tuple[int, int],
        resolution: float,
        position=(0.0, 0.0),
        layers: Iterable[str] = (),
        frame_id: str = "map",
        data: Optional[Mapping[str, np.ndarray]] = None,
        device: DeviceLike = None,
    ) -> "GridMap":
        """A (rows, cols) map with NaN-filled `layers` and the float32 planes
        of `data`, on `device` (cuda unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        rows, cols = int(size[0]), int(size[1])
        layer_dict: Dict[str, torch.Tensor] = {}
        for name in layers:
            layer_dict[name] = torch.full((rows, cols), math.nan, dtype=torch.float32, device=dev)
        for name, arr in (data or {}).items():
            plane = torch.as_tensor(np.asarray(arr, np.float32), device=dev)
            if tuple(plane.shape) != (rows, cols):
                raise ValueError(
                    f"layer {name!r} has shape {tuple(plane.shape)}, expected {(rows, cols)}"
                )
            layer_dict[name] = plane
        return cls(
            layers=layer_dict,
            resolution=float(resolution),
            position=torch.as_tensor(np.asarray(position, np.float32).reshape(2), device=dev),
            frame_id=frame_id,
        )

    @classmethod
    def from_length(
        cls,
        length: Tuple[float, float],
        resolution: float,
        position=(0.0, 0.0),
        layers: Iterable[str] = (),
        frame_id: str = "map",
        device: DeviceLike = None,
    ) -> "GridMap":
        """grid_map's setGeometry: size = round(length / res) per axis."""
        rows = int(round(length[0] / resolution))
        cols = int(round(length[1] / resolution))
        return cls.create((rows, cols), resolution, position, layers, frame_id, device=device)

    # -- basic properties --------------------------------------------------
    @property
    def size(self) -> Tuple[int, int]:
        for arr in self.layers.values():
            return tuple(arr.shape)
        raise ValueError("GridMap has no layers")

    @property
    def rows(self) -> int:
        return self.size[0]

    @property
    def cols(self) -> int:
        return self.size[1]

    @property
    def length(self) -> Tuple[float, float]:
        r, c = self.size
        return (r * self.resolution, c * self.resolution)

    @property
    def device(self) -> torch.device:
        return self.position.device

    def exists(self, layer: str) -> bool:
        return layer in self.layers

    def get(self, layer: str) -> torch.Tensor:
        return self.layers[layer]

    def __getitem__(self, layer: str) -> torch.Tensor:
        return self.layers[layer]

    # -- functional updates ------------------------------------------------
    def _f32(self, data) -> torch.Tensor:
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data, np.float32))
        return data.to(device=self.device, dtype=torch.float32).reshape(self.size)

    def add(self, layer: str, data=None) -> "GridMap":
        """A map with `layer` set (NaN-filled if data is None); an existing
        layer of that name is replaced, as grid_map's ``add`` does."""
        if data is None:
            arr = torch.full(self.size, math.nan, dtype=torch.float32, device=self.device)
        else:
            arr = self._f32(data)
        return dataclasses.replace(self, layers={**self.layers, layer: arr})

    def add_all(self, updates: Mapping[str, torch.Tensor]) -> "GridMap":
        """A map with the float32 (rows, cols) layers of `updates` added or
        replaced."""
        layers = dict(self.layers)
        for name, arr in updates.items():
            layers[name] = self._f32(arr)
        return dataclasses.replace(self, layers=layers)

    def erase(self, layer: str) -> "GridMap":
        return dataclasses.replace(
            self, layers={k: v for k, v in self.layers.items() if k != layer}
        )

    def keep_only(self, names: Iterable[str]) -> "GridMap":
        keep = set(names)
        return dataclasses.replace(
            self, layers={k: v for k, v in self.layers.items() if k in keep}
        )

    def clear(self, layer: str) -> "GridMap":
        """NaN-fill one layer (grid_map ``clear``)."""
        return self.add(layer)

    @staticmethod
    def roll_valid_mask(rows: int, cols: int, si: int, sj: int, device=None) -> torch.Tensor:
        """(rows, cols) bool: cells that survive a window roll by (si, sj);
        False marks cells exposed from outside the old window."""
        ri = torch.arange(rows, dtype=torch.int32, device=device)[:, None]
        rj = torch.arange(cols, dtype=torch.int32, device=device)[None, :]
        return (ri - si >= 0) & (ri - si < rows) & (rj - sj >= 0) & (rj - sj < cols)

    @staticmethod
    def roll_layer(a: torch.Tensor, si: int, sj: int, valid: torch.Tensor) -> torch.Tensor:
        """The grid_map ``move()`` primitive for one layer: roll by (si, sj);
        exposed cells take the per-dtype "unknown" fill: NaN for floats,
        True for bool veto planes (unknown terrain passes the vetoes), 0
        otherwise. The only implementation of this fill policy:
        ``GridMap.recenter`` and the estimator's online tick both call it, so
        fused and unfused roaming agree by construction."""
        rolled = torch.roll(a, (int(si), int(sj)), dims=(0, 1))
        if a.is_floating_point():
            fill = math.nan
        elif a.dtype == torch.bool:
            fill = True
        else:
            fill = 0
        return torch.where(valid, rolled, torch.as_tensor(fill, dtype=a.dtype, device=a.device))

    def with_position(self, position) -> "GridMap":
        return dataclasses.replace(self, position=self._position_tensor(position))

    def _position_tensor(self, xy) -> torch.Tensor:
        if isinstance(xy, torch.Tensor):
            return xy.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(xy, np.float32), device=self.device)

    def recenter(self, new_position) -> "GridMap":
        """grid_map ``move()`` analog: translate the map window to the
        grid-aligned centre nearest `new_position`. Overlapping cells keep
        their values at unchanged world positions; newly exposed cells are
        unknown. The shift is computed in float32 and rounded half to even."""
        rows, cols = self.size
        res = self.resolution
        pos = self.position.detach().cpu().numpy().astype(np.float32)
        target = np.asarray(
            new_position.detach().cpu().numpy() if isinstance(new_position, torch.Tensor)
            else new_position, np.float32,
        )
        shift = np.round((target - pos) / np.float32(res)).astype(np.int32)
        snapped = pos + shift.astype(np.float32) * np.float32(res)
        # world point p: index_new = index_old + shift, so new[i] = old[i - shift]
        si, sj = int(shift[0]), int(shift[1])
        valid = self.roll_valid_mask(rows, cols, si, sj, self.device)
        new_layers = {k: self.roll_layer(v, si, sj, valid) for k, v in self.layers.items()}
        return dataclasses.replace(
            self, layers=new_layers, position=self._position_tensor(snapped)
        )

    def get_submap(self, position, length) -> Tuple["GridMap", bool]:
        """grid_map ``getSubmap(position, length, isSuccess)`` analog.

        Clips the requested centre + length rectangle to the map, snaps it
        to whole cells, and returns ``(submap, success)``. The requested
        CENTRE must land inside the generated submap: a request entirely off
        the map clips to an edge sliver that no longer contains its centre
        and fails; a partly off-map request whose centre is on the map
        succeeds with the clipped extent. Host float64 math; the submap's
        layers are views of this map's."""
        rows, cols = self.size
        res = float(self.resolution)
        mpos = self.position.detach().cpu().numpy().astype(np.float64)
        L = np.array([rows * res, cols * res], np.float64)
        req_pos = np.asarray(position, np.float64).reshape(2)
        req_len = np.asarray(length, np.float64).reshape(2)

        def bound(p):
            # grid_map boundPositionToRange: clamp each coordinate into the
            # open interval (centre - L/2, centre + L/2) with a tiny inset so
            # the floor() below lands on a real cell
            out = p.copy()
            for i in range(2):
                eps = 10.0 * np.finfo(np.float64).eps * max(abs(p[i]), 1.0)
                lo, hi = mpos[i] - 0.5 * L[i], mpos[i] + 0.5 * L[i]
                if out[i] <= lo:
                    out[i] = lo + eps
                elif out[i] >= hi:
                    out[i] = hi - eps
            return out

        def idx(p):
            return np.floor((mpos + 0.5 * L - p) / res).astype(int)

        tl = idx(bound(req_pos + 0.5 * req_len))  # largest coordinates: the (0, 0) side
        br = idx(bound(req_pos - 0.5 * req_len))
        size = br - tl + 1
        sub_len = size * res
        # submap centre from the top-left cell's outer corner
        tl_center = mpos + 0.5 * L - (tl + 0.5) * res
        sub_pos = (tl_center + 0.5 * res) - 0.5 * sub_len
        # success: requested centre within the generated submap (lower edge
        # exclusive, upper inclusive)
        t = sub_pos + 0.5 * sub_len - req_pos
        ok = bool(np.all((t >= 0.0) & (t < sub_len)))
        sub_layers = {
            k: v[tl[0] : tl[0] + size[0], tl[1] : tl[1] + size[1]]
            for k, v in self.layers.items()
        }
        sub = dataclasses.replace(
            self, layers=sub_layers, position=self._position_tensor(sub_pos.astype(np.float32))
        )
        return sub, ok

    # -- geometry ----------------------------------------------------------
    def _half(self) -> torch.Tensor:
        """Half the map's length per axis, the lengths rounded to float32
        once (``rows * res`` in double precision first)."""
        rows, cols = self.size
        res = self.resolution
        return torch.tensor([rows * res, cols * res], dtype=torch.float32, device=self.device) * 0.5

    def cell_positions(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, cols) tensors of cell-centre x and y map-frame coordinates."""
        rows, cols = self.size
        res = self.resolution
        # here the lengths are float32 products, as the reference computes them
        size = torch.tensor([rows, cols], dtype=torch.float32, device=self.device)
        half = (size * res) * 0.5
        i = torch.arange(rows, dtype=torch.float32, device=self.device)[:, None]
        j = torch.arange(cols, dtype=torch.float32, device=self.device)[None, :]
        x = self.position[0] + half[0] - 0.5 * res - i * res
        y = self.position[1] + half[1] - 0.5 * res - j * res
        return x.expand(rows, cols), y.expand(rows, cols)

    def index_of(self, xy) -> torch.Tensor:
        """Map-frame position(s) (..., 2) -> integer index(es) (..., 2), with
        grid_map's truncation (valid only for in-map positions)."""
        # a tensor divisor: a true float32 division on every device (CUDA turns
        # a division by a Python scalar into a multiply by its reciprocal)
        res = torch.tensor(self.resolution, dtype=torch.float32, device=self.device)
        v = (self.position + self._half() - self._position_tensor(xy)) / res
        return torch.floor(v).to(torch.int32)

    def position_of(self, index) -> torch.Tensor:
        """Integer index(es) (..., 2) -> cell-centre position(s) (..., 2)."""
        res = self.resolution
        return self.position + self._half() - 0.5 * res - self._position_tensor(index) * res

    def is_inside(self, xy) -> torch.Tensor:
        """grid_map checkIfPositionWithinMap: pos in (centre-L/2, centre+L/2]."""
        half = self._half()
        t = self.position + half - self._position_tensor(xy)
        return ((t >= 0.0) & (t < 2.0 * half)).all(dim=-1)

    def valid_mask(self, layer: str = "elevation") -> torch.Tensor:
        """True where `layer` holds finite data (grid_map ``isValid``)."""
        return torch.isfinite(self.layers[layer])

    # -- host conversion ---------------------------------------------------
    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self.layers.items()}

    def __repr__(self) -> str:  # short: layers can be many
        try:
            rows, cols = self.size
        except ValueError:
            rows = cols = 0
        return (
            f"GridMap({rows}x{cols} @ {self.resolution} m, "
            f"layers={sorted(self.layers.keys())}, frame={self.frame_id!r})"
        )
