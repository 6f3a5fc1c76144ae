"""JSON-lines TCP service front end: the counterpart of the ROS services and
their transport.

The reference's external API is seven ROS services over TCPROS. This module
serves the same seven operations over a newline-delimited-JSON
TCP socket so an out-of-process planner can run in the loop without ROS:

    request : {"service": <name>, ...args}\n
    response: {"ok": true, ...}\n  |  {"ok": false, "error": "..."}\n

Services (names match the reference):
  check_footprint_path            paths=[{poses,[orientations],[radius],
                                  [footprint],[conservative],
                                  [compute_untraversable_polygon]}]
  update_traversability           -> map info
  get_traversability              [layers=[names]] [position=[x,y]
                                  length=[lx,ly]] -> info + base64 f32 planes
                                  (position+length = clipped submap request,
                                  grid_map_msgs/GetGridMap parity)
  traversability_footprint        -> dense footprint layers computed
  load_elevation_map              path=...
  save_traversability_map_to_bag  path=...
  update_parameters               robot_yaml/filter_yaml/footprint_yaml=... or
                                  documents={robot, filters, footprint}: the
                                  same parameters already loaded, as JSON

Array planes travel as {"shape": [r, c], "b64": base64(little-endian f32)}.
The wire format is the JAX package's: either package's client talks to
either's server (``documents`` is the one key only this server reads).
The server is a thread-per-connection loop around a TraversabilityNode; the
node's map swaps make concurrent queries safe without locks. The map lives
on the node's device: ``get_traversability`` copies only the requested
layers, and of a submap request only the clipped window, to the host.
"""

from __future__ import annotations

import base64
import json
import socket
import socketserver
import threading
from typing import Dict, List, Optional

import numpy as np

import torch

from traversability_estimation_tpu_torch.models.estimator import FootprintPath
from traversability_estimation_tpu_torch.node import TraversabilityNode


def encode_plane(arr: np.ndarray) -> Dict:
    a = np.asarray(arr, dtype="<f4")
    return {"shape": list(a.shape), "b64": base64.b64encode(a.tobytes()).decode()}


def decode_plane(obj: Dict) -> np.ndarray:
    raw = base64.b64decode(obj["b64"])
    return np.frombuffer(raw, dtype="<f4").reshape(obj["shape"]).copy()


def _map_info(gm) -> Dict:
    rows, cols = gm.size
    return {
        "frame_id": gm.frame_id,
        "resolution": float(gm.resolution),
        "size": [int(rows), int(cols)],
        "position": [float(v) for v in gm.position.tolist()],
        "layers": sorted(gm.layers),
    }


def _parse_path(obj: Dict) -> FootprintPath:
    return FootprintPath(
        poses=np.asarray(obj["poses"], np.float32),
        orientations=(
            np.asarray(obj["orientations"], np.float32)
            if obj.get("orientations")
            else None
        ),
        radius=float(obj.get("radius", 0.0)),
        footprint=(
            np.asarray(obj["footprint"], np.float32) if obj.get("footprint") else None
        ),
        conservative=bool(obj.get("conservative", False)),
        compute_untraversable_polygon=bool(
            obj.get("compute_untraversable_polygon", False)
        ),
    )


class TraversabilityServer:
    """Serve a TraversabilityNode's API over TCP (threaded, JSON-lines)."""

    class _Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True  # fast restarts (no TIME_WAIT bind errors)
        daemon_threads = True

    def __init__(self, node: TraversabilityNode, host: str = "127.0.0.1", port: int = 0):
        self.node = node
        handler = self._make_handler()
        self._srv = self._Server((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self._srv.server_address

    def start(self):
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- dispatch -------------------------------------------------------------
    def _dispatch(self, req: Dict) -> Dict:
        node = self.node
        name = req.get("service", "")
        if name == "check_footprint_path":
            paths = [_parse_path(p) for p in req.get("paths", [])]
            results = node.check_footprint_path(paths)
            return {
                "ok": True,
                "results": [
                    {
                        "is_safe": bool(r.is_safe),
                        "traversability": float(r.traversability),
                        "area": float(r.area),
                        **(
                            {"untraversable_polygon": np.asarray(
                                r.untraversable_polygon).tolist()}
                            if r.untraversable_polygon is not None
                            else {}
                        ),
                    }
                    for r in results
                ],
            }
        if name == "update_traversability":
            if not node.request_update():
                return {"ok": False, "error": "update failed"}
            return {"ok": True, "map_info": _map_info(node.estimator.traversability_map)}
        if name == "get_traversability":
            if not node.estimator.initialized:
                return {"ok": False, "error": "map not initialized"}
            gm = node.estimator.traversability_map
            wanted = req.get("layers")
            # submap extraction, the reference's getTraversabilityMap: the request carries a
            # position + length, the map's getSubmap clips it, and isSuccess
            # is the service result. Full map when no length is requested.
            length = req.get("length")
            is_submap = bool(length) and float(length[0]) > 0 and float(length[1]) > 0
            if is_submap:
                position = req.get("position", (0.0, 0.0))
                gm, success = gm.get_submap(
                    (float(position[0]), float(position[1])),
                    (float(length[0]), float(length[1])),
                )
                if not success:
                    return {
                        "ok": False,
                        "error": "requested submap does not contain its center "
                        "position (off-map request)",
                    }
                if not wanted:  # reference returns ALL layers when unspecified
                    wanted = sorted(gm.layers)
            out = {"ok": True, "map_info": _map_info(gm)}
            if wanted:
                planes = {}
                for lname in wanted:
                    if lname not in gm.layers:
                        return {"ok": False, "error": f"no layer {lname!r}"}
                    planes[lname] = encode_plane(gm.layers[lname].to(torch.float32).cpu().numpy())
                out["data"] = planes
            return out
        if name == "traversability_footprint":
            node.traversability_footprint()
            return {"ok": True, "map_info": _map_info(node.estimator.traversability_map)}
        if name == "load_elevation_map":
            if not node.load_elevation_map(str(req["path"])):
                return {"ok": False, "error": "load failed"}
            return {"ok": True, "map_info": _map_info(node.estimator.traversability_map)}
        if name == "save_traversability_map_to_bag":
            node.save_traversability_map_to_bag(str(req["path"]))
            return {"ok": True}
        if name == "update_parameters":
            ok = node.update_parameters(
                robot_yaml=req.get("robot_yaml"),
                filter_yaml=req.get("filter_yaml"),
                footprint_yaml=req.get("footprint_yaml"),
                documents=req.get("documents"),
            )
            return {"ok": bool(ok)}
        if name == "set_elevation_map":  # pushed input (a subscriber's counterpart)
            accepted = node.push_initial_grid_map(
                decode_plane(req["elevation"]),
                tuple(req.get("position", (0.0, 0.0))),
            )
            if not accepted:
                # accepted only while the map is uninitialized
                return {"ok": False, "error": "map already initialized"}
            return {"ok": True}
        return {"ok": False, "error": f"unknown service {name!r}"}

    def _make_handler(self):
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    line = self.rfile.readline()
                    if not line:
                        return
                    try:
                        req = json.loads(line)
                        resp = outer._dispatch(req)
                    except Exception as e:  # noqa: BLE001 - report, keep serving
                        resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()

        return Handler


class TraversabilityClient:
    """Planner-side client for TraversabilityServer (one persistent
    connection; call methods named after the reference services)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, timeout: float = 120.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")

    def close(self):
        self._rfile.close()
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def call(self, service: str, **kwargs) -> Dict:
        req = {"service": service, **kwargs}
        self._sock.sendall(json.dumps(req).encode() + b"\n")
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed connection")
        return json.loads(line)

    # convenience wrappers, one per reference service ------------------------
    def check_footprint_path(self, paths: List[Dict]) -> Dict:
        return self.call("check_footprint_path", paths=paths)

    def update_traversability(self) -> Dict:
        return self.call("update_traversability")

    def get_traversability(
        self,
        layers: Optional[List[str]] = None,
        position=None,
        length=None,
    ) -> Dict:
        """Full map info (+ layer planes), or a clipped submap when
        ``position``/``length`` are given (grid_map_msgs/GetGridMap)."""
        kwargs: Dict = {}
        if layers:
            kwargs["layers"] = layers
        if length is not None:
            kwargs["length"] = list(map(float, length))
            kwargs["position"] = list(map(float, position or (0.0, 0.0)))
        resp = self.call("get_traversability", **kwargs)
        if resp.get("ok") and "data" in resp:
            resp["data"] = {k: decode_plane(v) for k, v in resp["data"].items()}
        return resp

    def traversability_footprint(self) -> Dict:
        return self.call("traversability_footprint")

    def load_elevation_map(self, path: str) -> Dict:
        return self.call("load_elevation_map", path=path)

    def save_traversability_map_to_bag(self, path: str) -> Dict:
        return self.call("save_traversability_map_to_bag", path=path)

    def update_parameters(self, **sources) -> Dict:
        """`robot_yaml` / `filter_yaml` / `footprint_yaml` paths the server
        can read, or `documents`: the same parameters as loaded mappings."""
        return self.call("update_parameters", **sources)

    def set_elevation_map(self, elevation: np.ndarray, position=(0.0, 0.0)) -> Dict:
        return self.call(
            "set_elevation_map",
            elevation=encode_plane(elevation),
            position=list(map(float, position)),
        )
