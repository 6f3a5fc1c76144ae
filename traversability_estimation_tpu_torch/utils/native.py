"""ctypes bindings of the native (C++) components at the repository root's
``csrc/``: the single-thread CPU reference baseline
(``reference_baseline.cpp``: the filter chain and the memoised circle and
polygon-path queries, the reference's semantics; the comparison floor for
the card's throughput) and the native GridMap bag reader
(``rosbag_reader.cpp``).

Both libraries are compiled here, at first use, by the host's ``g++`` with
the flags of the JAX package's ``csrc/build.sh`` into this package's
``_build/native/`` (git-ignored), named by a hash of the source, the flags
and the compiler, so that an edited source rebuilds. ``csrc/build.sh`` and
its output directory belong to the JAX package and are never run or read
here. Every entry point raises ``NativeUnavailable`` when ``g++`` is absent
or a build fails; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR.parent / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build" / "native"

SOURCES = {
    "te_baseline": "reference_baseline.cpp",
    "te_rosbag": "rosbag_reader.cpp",
}
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("g++ not found: the native baseline builds with the host's g++")
    return cxx


def library_path(name: str, cxx: str) -> Path:
    """Where the library of `name` is built: ``_build/native/lib<name>-<hash>.so``."""
    src = CSRC_DIR / SOURCES[name]
    if not src.exists():
        raise NativeUnavailable(f"{src} is missing")
    h = hashlib.sha256(src.read_bytes() + "\0".join(CXX_FLAGS).encode() + cxx.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _load_named(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, compiled first if needed."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        cxx = _compiler()
        out = library_path(name, cxx)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, str(CSRC_DIR / SOURCES[name]), "-o", str(tmp)],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeUnavailable(f"g++ failed on {SOURCES[name]}:\n{proc.stderr}")
            os.replace(tmp, out)
        _loaded[name] = ctypes.CDLL(str(out))
        return _loaded[name]


def _load() -> ctypes.CDLL:
    lib = _load_named("te_baseline")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.te_run_chain.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        f32p, f32p, f32p, f32p,
    ]
    lib.te_check_polygon_paths.argtypes = [
        f32p, f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        f32p, f32p, f64p, ctypes.c_int, ctypes.c_int, f64p, ctypes.c_int,
        u8p, f64p,
    ]
    lib.te_check_circles.argtypes = [
        f32p, f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        f32p, f32p, f32p, f64p, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, u8p, f64p,
    ]
    for fn in (lib.te_run_chain, lib.te_check_polygon_paths, lib.te_check_circles):
        fn.restype = None
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def baseline_run_chain(
    elevation: np.ndarray, resolution: float, chain_cfg
) -> Dict[str, np.ndarray]:
    """Native single-thread filter chain (reference semantics)."""
    lib = _load()
    elev = np.ascontiguousarray(elevation, np.float32)
    rows, cols = elev.shape
    outs = [np.empty((rows, cols), np.float32) for _ in range(4)]
    lib.te_run_chain(
        elev, rows, cols, resolution,
        chain_cfg.normals_radius, chain_cfg.slope_critical_value,
        chain_cfg.step_critical_value, chain_cfg.step_first_window_radius,
        chain_cfg.step_second_window_radius, chain_cfg.step_critical_cell_number,
        chain_cfg.roughness_critical_value, chain_cfg.roughness_estimation_radius,
        *outs,
    )
    return {
        "traversability_slope": outs[0],
        "traversability_step": outs[1],
        "traversability_roughness": outs[2],
        "traversability": outs[3],
    }


def _load_bag_lib() -> ctypes.CDLL:
    lib = _load_named("te_rosbag")
    lib.te_bag_open.restype = ctypes.c_void_p
    lib.te_bag_open.argtypes = [ctypes.c_char_p]
    ip = ctypes.POINTER(ctypes.c_int)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.te_bag_info.argtypes = [ctypes.c_void_p, ip, ip, dp, dp, ip]
    lib.te_bag_layer_name.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.te_bag_layer.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    lib.te_bag_close.argtypes = [ctypes.c_void_p]
    return lib


def load_grid_map_bag_native(path: str):
    """Native reader of a GridMap bag. Returns the same ``GridMapMessage``
    as ``utils.rosbag.load_grid_map_bag``; raises ``NativeUnavailable`` if
    the library cannot be built or the bag needs a feature only the Python
    reader has (e.g. bz2 chunks)."""
    from traversability_estimation_tpu_torch.utils.rosbag import GridMapMessage

    lib = _load_bag_lib()
    h = lib.te_bag_open(os.fsencode(path))
    if not h:
        raise NativeUnavailable(f"native reader could not decode {path}")
    try:
        rows = ctypes.c_int()
        cols = ctypes.c_int()
        res = ctypes.c_double()
        nl = ctypes.c_int()
        pos = (ctypes.c_double * 2)()
        lib.te_bag_info(h, ctypes.byref(rows), ctypes.byref(cols),
                        ctypes.byref(res), pos, ctypes.byref(nl))
        data = {}
        names = []
        for i in range(nl.value):
            nb = ctypes.create_string_buffer(128)
            lib.te_bag_layer_name(h, i, nb, 128)
            name = nb.value.decode()
            names.append(name)
            buf = np.empty((rows.value, cols.value), np.float32)
            lib.te_bag_layer(h, i, buf)
            data[name] = buf
        return GridMapMessage(
            frame_id="map",
            resolution=res.value,
            length=(rows.value * res.value, cols.value * res.value),
            position=(pos[0], pos[1], 0.0),
            orientation=(0.0, 0.0, 0.0, 1.0),
            layers=names,
            basic_layers=[],
            data=data,
        )
    finally:
        lib.te_bag_close(ctypes.c_void_p(h))


class BaselineQueryEngine:
    """Stateful native query engine: memo caches persist across calls within
    one map epoch (reference behavior)."""

    def __init__(
        self,
        layers: Dict[str, np.ndarray],
        resolution: float,
        critical_step_height: float = 0.12,
        max_gap_width: float = 0.3,
        default_traversability: float = 0.5,
    ):
        self._lib = _load()
        self.elev = np.ascontiguousarray(layers["elevation"], np.float32)
        self.trav = np.ascontiguousarray(layers["traversability"], np.float32)
        self.slope = np.ascontiguousarray(layers["traversability_slope"], np.float32)
        self.step = np.ascontiguousarray(layers["traversability_step"], np.float32)
        rows, cols = self.elev.shape
        self.rows, self.cols = rows, cols
        self.resolution = resolution
        self.critical_step_height = critical_step_height
        self.max_gap_width = max_gap_width
        self.default = default_traversability
        self._slope_memo = np.full((rows, cols), np.nan, np.float32)
        self._step_memo = np.full((rows, cols), np.nan, np.float32)
        self._trav_memo = np.full((rows, cols), np.nan, np.float32)

    def check_circles(
        self, centers: np.ndarray, radius_max: float, radius_min: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        centers = np.ascontiguousarray(centers, np.float64).reshape(-1, 2)
        n = len(centers)
        ok = np.empty(n, np.uint8)
        trav = np.empty(n, np.float64)
        self._lib.te_check_circles(
            self.elev, self.trav, self.slope, self.step, self.rows, self.cols,
            self.resolution, self.critical_step_height, self.max_gap_width,
            self.default, self._slope_memo, self._step_memo, self._trav_memo,
            centers, n, radius_max, radius_min, ok, trav,
        )
        return ok.astype(bool), trav

    def check_polygon_paths(
        self,
        poses: np.ndarray,
        footprint: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Polygonal footprint paths at identity orientation: per segment the
        convex hull of the footprint at both endpoint poses, PolygonIterator
        raster with the memoized veto cascade, area-weighted aggregation
        (TraversabilityMap.cpp:464-584 semantics)."""
        lib = self._lib
        poses = np.ascontiguousarray(poses, np.float64)
        P, N, _ = poses.shape
        fp = np.ascontiguousarray(footprint, np.float64)
        ok = np.empty(P, np.uint8)
        trav = np.empty(P, np.float64)
        lib.te_check_polygon_paths(
            self.elev, self.trav, self.slope, self.step, self.rows, self.cols,
            self.resolution, self.critical_step_height, self.max_gap_width,
            self.default, self._slope_memo, self._step_memo,
            poses, P, N, fp, len(fp), ok, trav,
        )
        return ok.astype(bool), trav
