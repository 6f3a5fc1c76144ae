"""TraversabilityNode: the process-level orchestrator.

The reference boots a ROS node that wires a periodic update timer, an
elevation-submap service client, two subscribers, three publishers and seven
services around the core engine. This is its single-controller counterpart,
with the estimator's tensors on one device (``cuda`` unless the caller
passes ``device="cpu"``):

- the unbounded callback thread pool and its two recursive mutexes become
  ONE background timer thread and an estimator whose map state is swapped as
  a whole on update: readers never block updates;
- the elevation_mapping service client (requestElevationMap) becomes an
  elevation source (``utils/sources.py``) sampled robot-centric each tick,
  with the robot -> map transform supplied by a pose callable (the tf
  lookup);
- the latched ``traversability_map`` topic becomes subscriber callbacks that
  replay the last published map on subscribe. Subscribers receive the port's
  ``GridMap``, its layers tensors on the node's device: nothing copies a map
  to the host unless a subscriber or a service asks for it;
- the image topic (imageCallback) and the ``~initial_elevation_map`` topic
  become ``push_image`` / ``push_initial_grid_map``.

The 7 services are served in-process by these methods, and over the wire by
``traversability_estimation_tpu_torch.service`` (a JSON-lines TCP front end
for planner-in-the-loop runs).

Threads and the device: the timer thread and every service thread queue
their work on the device's one current stream, so device work stays ordered.
On CUDA the constructor builds and loads both kernels, so that no two
threads meet at a kernel's first use.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np

from traversability_estimation_tpu_torch.device import DeviceLike
from traversability_estimation_tpu_torch.grid.gridmap import GridMap
from traversability_estimation_tpu_torch.models.estimator import (
    FootprintPath,
    TraversabilityEstimator,
    TraversabilityResult,
)
from traversability_estimation_tpu_torch.ops import field_kernel, update_kernel
from traversability_estimation_tpu_torch.utils.config import (
    EstimatorConfig,
    config_from_documents,
    load_config,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class StampedPolygon:
    """geometry_msgs/PolygonStamped: 2-D vertices lifted to a constant z (the
    reference sets every point's z to zPosition)."""

    vertices: np.ndarray  # (K, 2) float64, map frame
    z: float
    frame_id: str = "map"


class TraversabilityNode:
    def __init__(
        self,
        config: Optional[EstimatorConfig] = None,
        source=None,
        robot_pose: Optional[Callable[[], Tuple[float, float]]] = None,
        persistent_map_length: Optional[Tuple[float, float]] = None,
        recenter_on_robot: bool = False,
        device: DeviceLike = None,
    ):
        """`source` provides robot-centric elevation submaps
        (``utils/sources.py``: sample(center_xy, length_xy)); `robot_pose`
        returns the robot position in the map frame. With no source, updates
        only happen via pushed inputs (image, initial grid map, explicit
        update), like the reference when its submap service is absent.

        `persistent_map_length`: the reference's map is a robot-centric map
        REPLACED each tick; pass (len_x, len_y) to keep a large persistent
        world map instead, which submaps merge into incrementally (the
        online loop).

        `recenter_on_robot`: with a persistent map, keep the bounded window
        centred on the robot each tick (``GridMap.recenter``): memory stays
        constant for an unbounded roam, computed layers ride along, and only
        newly exposed terrain is refreshed.

        `device`: ``cuda`` by default (raises without a card); ``"cpu"`` runs
        the plain versions."""
        self.config = config or EstimatorConfig()
        self.estimator = TraversabilityEstimator(self.config, device=device)
        if self.estimator.device.type == "cuda":
            update_kernel.library()
            field_kernel.library()
        self.source = source
        self.persistent_map_length = persistent_map_length
        self.recenter_on_robot = recenter_on_robot
        if persistent_map_length is not None:
            res = self.config.resolution
            rows = int(round(persistent_map_length[0] / res))
            cols = int(round(persistent_map_length[1] / res))
            self.estimator.set_elevation_map(
                np.full((rows, cols), np.nan, np.float32), self.config.map_center
            )
        self.robot_pose = robot_pose or (lambda: (0.0, 0.0))
        self._subscribers: List[Callable[[GridMap], None]] = []
        self._last_published: Optional[GridMap] = None
        # the footprint_polygon / untraversable_polygon topics, latched like
        # the map
        self._footprint_subscribers: List[Callable[[StampedPolygon], None]] = []
        self._untraversable_subscribers: List[Callable[[StampedPolygon], None]] = []
        self._last_footprint: Optional[StampedPolygon] = None
        self._last_untraversable: Optional[StampedPolygon] = None
        self._lock = threading.Lock()
        # one map update at a time: the timer thread and an update request
        # both replace the estimator's state
        self._update_lock = threading.RLock()
        self._timer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.update_count = 0
        # failure detection: every failed tick is counted and retried on the
        # next tick; a persistent map keeps serving the last good state
        # meanwhile
        self.consecutive_failures = 0
        self.total_failures = 0
        self._started = False
        # min_update_rate == 0 disables the timer, as in the reference
        self.timer_enabled = self.config.min_update_rate > 0.0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Begin periodic updates. Remembered as intent: a later
        update_parameters that enables the timer spawns the thread for a
        started node."""
        self._started = True
        if not self.timer_enabled or self._timer is not None:
            return
        self._spawn_timer()

    def _spawn_timer(self) -> None:
        self._stop.clear()
        self._timer = threading.Thread(target=self._timer_loop, daemon=True)
        self._timer.start()

    def _join_timer(self) -> None:
        self._stop.set()
        if self._timer is not None:
            self._timer.join(timeout=30.0)
            self._timer = None

    def stop(self) -> None:
        self._started = False
        self._join_timer()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def _timer_loop(self) -> None:
        while not self._stop.is_set():
            # re-read each tick so update_parameters rate changes take effect
            rate = self.config.min_update_rate
            if rate <= 0.0:
                return  # timer disabled by a parameter reload
            period = 1.0 / rate
            t0 = time.time()
            try:
                ok = self.update_traversability()
            except Exception:  # noqa: BLE001 - a failed tick must not kill the loop
                logger.exception("update tick failed")
                ok = False
            if ok:
                self.consecutive_failures = 0
            else:
                self.consecutive_failures += 1
                self.total_failures += 1
                if self.consecutive_failures in (1, 10, 100):
                    logger.warning(
                        "update tick failed (%d consecutive); retrying at the configured rate",
                        self.consecutive_failures,
                    )
            self._stop.wait(max(0.0, period - (time.time() - t0)))

    # -- topics (publish / subscribe) ----------------------------------------
    def subscribe(self, callback: Callable[[GridMap], None]) -> None:
        """Register a map listener. Latched: a new subscriber immediately
        receives the last published map."""
        with self._lock:
            self._subscribers.append(callback)
            last = self._last_published
        if last is not None:
            callback(last)

    def _publish(self) -> None:
        gm = self.estimator.traversability_map
        with self._lock:
            self._last_published = gm
            subs = list(self._subscribers)
        for cb in subs:
            cb(gm)

    def subscribe_footprint_polygon(self, callback: Callable[[StampedPolygon], None]) -> None:
        """The ``footprint_polygon`` topic (latched): every checked pose's or
        segment's footprint outline, the 20-gon circle or the
        consecutive-footprint hull."""
        with self._lock:
            self._footprint_subscribers.append(callback)
            last = self._last_footprint
        if last is not None:
            callback(last)

    def subscribe_untraversable_polygon(self, callback: Callable[[StampedPolygon], None]) -> None:
        """The ``untraversable_polygon`` topic (latched): hulls of the
        failing cells a failed check visited, for paths that set
        compute_untraversable_polygon."""
        with self._lock:
            self._untraversable_subscribers.append(callback)
            last = self._last_untraversable
        if last is not None:
            callback(last)

    def _publish_path_polygons(self, paths: List[FootprintPath]) -> None:
        """The check service's publishPolygons side channel. Computed only
        when subscribers exist; the untraversable stream also needs the
        path's compute_untraversable_polygon flag."""
        with self._lock:
            fp_subs = list(self._footprint_subscribers)
            up_subs = list(self._untraversable_subscribers)
        if not fp_subs and not up_subs:
            return
        frame = self.config.map_frame_id
        for path in paths:
            footprints, untraversables, robot_z = self.estimator.path_polygons(path)
            # circular footprints publish at z = 0; polygonal multi-pose
            # hulls at the robot's height; a polygonal single pose at 0
            is_polygonal = path.footprint is not None and len(path.footprint) > 0
            n_poses = np.atleast_2d(np.asarray(path.poses)).shape[0]
            fp_z = robot_z if (is_polygonal and n_poses > 1) else 0.0
            for verts in footprints:
                msg = StampedPolygon(np.asarray(verts, np.float64), fp_z, frame)
                with self._lock:
                    self._last_footprint = msg
                for cb in fp_subs:
                    cb(msg)
            if path.compute_untraversable_polygon:
                for verts in untraversables:
                    msg = StampedPolygon(np.asarray(verts, np.float64), robot_z, frame)
                    with self._lock:
                        self._last_untraversable = msg
                    for cb in up_subs:
                        cb(msg)

    # -- the periodic update (updateTimerCallback -> updateTraversability) ---
    def update_traversability(self) -> bool:
        """One tick: request a robot-centric submap from the source, merge,
        recompute, publish."""
        with self._update_lock:
            if self.source is not None:
                center = tuple(map(float, self.robot_pose()))
                patch, pos = self.source.sample(center, self.config.map_length)
                if self.persistent_map_length is not None:
                    # merge into the persistent world map, refresh only the
                    # affected region
                    if self.recenter_on_robot:
                        self.estimator.recenter(center)
                    ok = self.estimator.update_with_submap(patch, tuple(np.asarray(pos)))
                else:
                    # as the reference: the map IS the fresh robot-centric submap
                    ok = self.estimator.update(patch, position=np.asarray(pos))
            else:
                ok = self.estimator.update()
            if ok:
                self.update_count += 1
                self._publish()
        return ok

    # -- services -------------------------------------------------------------
    def request_update(self, timeout: float = 10.0) -> bool:
        """``update_traversability`` service: with the timer disabled, run
        the update inline; then wait until the map is initialized (the
        reference busy-waits in steps of 1 s; this polls at 10 ms)."""
        if not self.timer_enabled:
            if not self.update_traversability():
                return False
        deadline = time.time() + timeout
        while not self.estimator.initialized:
            if time.time() > deadline:
                return False
            time.sleep(0.01)
        return True

    def check_footprint_path(self, paths) -> List[TraversabilityResult]:
        if isinstance(paths, FootprintPath):
            paths = [paths]
        results = self.estimator.check_footprint_path(paths)
        self._publish_path_polygons(paths)
        return results

    def get_traversability_map(self) -> GridMap:
        return self.estimator.traversability_map

    def traversability_footprint(self) -> GridMap:
        return self.estimator.traversability_footprint(self.config.footprint_yaw)

    def load_elevation_map(self, path: str) -> bool:
        with self._update_lock:
            ok = self.estimator.load_elevation_map(path)
            if ok:
                self._publish()
        return ok

    def save_traversability_map_to_bag(self, path: str) -> bool:
        self.estimator.save(path)
        return True

    def update_parameters(
        self,
        config: Optional[EstimatorConfig] = None,
        robot_yaml: Optional[str] = None,
        filter_yaml: Optional[str] = None,
        footprint_yaml: Optional[str] = None,
        documents: Optional[Mapping] = None,
    ) -> bool:
        """``update_parameters`` service: accept a typed config, re-read YAML
        files (``rosparam load``), or take already-loaded `documents`
        (``{"robot": ..., "filters": ..., "footprint": ...}``, for a caller
        without files or PyYAML); the next update runs with the new
        configuration.

        A reload MERGES onto the current config: parameters the files or
        documents do not mention keep their current values. A rate change
        takes effect on the running timer; enabling the timer on a started
        node spawns it, disabling stops it."""
        if config is None and documents is not None:
            config = config_from_documents(
                robot=documents.get("robot"),
                filters=documents.get("filters"),
                footprint=documents.get("footprint"),
                base=self.config,
            )
        elif config is None:
            config = load_config(
                robot_yaml=robot_yaml,
                filter_yaml=filter_yaml,
                footprint_yaml=footprint_yaml,
                resolution=self.config.resolution,
                base=self.config,
            )
        with self._update_lock:
            self.config = config
            self.timer_enabled = config.min_update_rate > 0.0
            ok = self.estimator.update_parameters(config)
        if self._started:
            if self.timer_enabled and self._timer is None:
                self._spawn_timer()
            elif not self.timer_enabled and self._timer is not None:
                self._join_timer()
        return ok

    # -- pushed inputs (the subscribers' counterparts) -------------------------
    def push_image(
        self, image: np.ndarray, min_height: float, max_height: float, position=(0.0, 0.0)
    ) -> None:
        """imageCallback: grayscale image -> elevation in [min_height,
        max_height]; traversability is recomputed on the next tick."""
        self.estimator.set_elevation_from_image(image, min_height, max_height, position)

    def push_initial_grid_map(self, elevation: np.ndarray, position=(0.0, 0.0)) -> bool:
        """The ``~initial_elevation_map`` topic: only accepted while the
        traversability map is uninitialized."""
        with self._update_lock:
            if self.estimator.initialized:
                return False
            self.estimator.set_elevation_map(np.asarray(elevation), position)
            ok = self.estimator.update()
            if ok:
                self._publish()
        return ok
