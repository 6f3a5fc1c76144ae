"""The port's node (node.py) and JSON-lines TCP service (service.py) on the
CPU, against the JAX package's where a counterpart exists (mirrors
tests/test_node_service.py and tests/test_services.py).

Bars: the wire format is the JAX package's, so either client talks to either
server; a node and a JAX node fed the same source give equal verdicts and
step layers (exact) and traversability within 2e-4 (the fused layer's bar of
test_torch_filters.py); four client threads hammering one node while its
timer runs get, on a static source, exactly the answers of a quiescent node.
Every thread is joined and every socket closed with a timeout.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from traversability_estimation_tpu.node import TraversabilityNode as JaxNode
from traversability_estimation_tpu.service import TraversabilityClient as JaxClient
from traversability_estimation_tpu.service import TraversabilityServer as JaxServer
from traversability_estimation_tpu.utils.config import EstimatorConfig as JaxConfig
from traversability_estimation_tpu.utils.sources import ArraySource as JaxArraySource
from traversability_estimation_tpu_torch import (
    ArraySource,
    FootprintPath,
    GridMap,
    TraversabilityClient,
    TraversabilityNode,
    TraversabilityServer,
    config_from_documents,
    reference_documents,
)
from traversability_estimation_tpu_torch.__main__ import main as cli_main
from traversability_estimation_tpu_torch.service import decode_plane, encode_plane

RES = 0.03
RECT = [[0.1, 0.08], [0.1, -0.08], [-0.1, -0.08], [-0.1, 0.08]]
PATHS = [
    {"poses": [[0.0, 0.0], [0.1, 0.05]], "radius": 0.1},
    {"poses": [[0.0, 0.0]], "footprint": RECT},
    {"poses": [[0.2, 0.1], [0.0, -0.1], [-0.2, 0.1]], "radius": 0.12,
     "compute_untraversable_polygon": True},
    {"poses": [[0.2, -0.2, 0.0], [0.1, 0.0, 0.0]], "footprint": RECT, "conservative": True,
     "orientations": [[0, 0, 0.38, 0.92], [0, 0, 0, 1]], "compute_untraversable_polygon": True},
]


def _terrain(n, seed):
    from conftest import synthetic_terrain

    return synthetic_terrain(n, n, RES, seed=seed)


def _source(seed=0, n=48, cls=ArraySource):
    return cls(elevation=_terrain(n, seed), resolution=RES)


def _config(**kw):
    kw = {"min_update_rate": 0.0, "map_length": (1.0, 1.0), **kw}
    return dataclasses.replace(
        config_from_documents(**reference_documents(), resolution=RES), **kw)


def _wait(condition, seconds=30.0):
    deadline = time.time() + seconds
    while not condition() and time.time() < deadline:
        time.sleep(0.01)
    return condition()


@pytest.fixture()
def server():
    node = TraversabilityNode(_config(), source=_source(seed=7), device="cpu")
    with TraversabilityServer(node) as srv:
        yield srv
    node.stop()


def test_node_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TraversabilityNode(_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["run"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["serve", "--port", "0"])
    assert TraversabilityNode(_config(), device="cpu").estimator.device.type == "cpu"


def test_timer_loop_updates_and_publishes():
    node = TraversabilityNode(_config(min_update_rate=50.0), source=_source(), device="cpu")
    seen = []
    node.subscribe(seen.append)
    with node:
        assert _wait(lambda: node.update_count >= 4)
    assert node._timer is None and len(seen) >= 4
    assert isinstance(seen[-1], GridMap) and isinstance(seen[-1]["traversability"], torch.Tensor)
    assert seen[-1].size == (33, 33)


def test_persistent_map_mode_merges_submaps():
    pose = {"xy": (-0.3, -0.3)}
    node = TraversabilityNode(
        _config(map_length=(0.6, 0.6)), source=_source(seed=5, n=64),
        robot_pose=lambda: pose["xy"], persistent_map_length=(64 * RES, 64 * RES), device="cpu")
    assert node.update_traversability()
    assert node.estimator.traversability_map.size == (64, 64)  # the world map, not the submap
    valid_1 = int(torch.isfinite(node.estimator.traversability_map["elevation"]).sum())
    pose["xy"] = (0.3, 0.3)  # the robot moved: the second submap adds coverage
    assert node.update_traversability()
    valid_2 = int(torch.isfinite(node.estimator.traversability_map["elevation"]).sum())
    assert valid_2 > valid_1 and node.update_count == 2


def test_recenter_on_robot_moves_the_window():
    pose = {"xy": (0.0, 0.0)}
    node = TraversabilityNode(
        _config(map_length=(0.6, 0.6)), source=_source(seed=5, n=96),
        robot_pose=lambda: pose["xy"], persistent_map_length=(48 * RES, 48 * RES),
        recenter_on_robot=True, device="cpu")
    assert node.update_traversability()
    pose["xy"] = (0.3, -0.24)
    assert node.update_traversability()
    np.testing.assert_allclose(node.estimator.traversability_map.position.numpy(),
                               [0.3, -0.24], atol=1e-6)


def test_latched_publication_replays_last_map():
    node = TraversabilityNode(_config(), source=_source(), device="cpu")
    assert not node.timer_enabled  # rate 0 disables the timer
    assert node.request_update()  # runs inline when the timer is off
    late = []
    node.subscribe(late.append)  # subscribes AFTER the publish
    assert len(late) == 1 and late[0] is node.get_traversability_map()


def test_timer_retries_after_source_failure():
    class FlakySource:
        def __init__(self, inner, fail_first):
            self.inner = inner
            self.fails_left = fail_first

        def sample(self, center, length):
            if self.fails_left > 0:
                self.fails_left -= 1
                raise ConnectionError("sensor offline")
            return self.inner.sample(center, length)

    node = TraversabilityNode(
        _config(min_update_rate=50.0), source=FlakySource(_source(), 3), device="cpu")
    with node:
        assert _wait(lambda: node.update_count >= 1)
    assert node.total_failures == 3 and node.consecutive_failures == 0


def test_initial_grid_map_gate_and_pushed_image():
    node = TraversabilityNode(_config(), device="cpu")
    elev = _terrain(32, 2)
    assert node.push_initial_grid_map(elev)
    assert not node.push_initial_grid_map(elev * 2.0)  # already initialized
    node.push_image(np.full((20, 24), 127.5, np.float32), 0.0, 2.0, position=(0.5, 0.0))
    assert node.request_update()  # the image is the elevation of the next update
    gm = node.get_traversability_map()
    assert gm.size == (20, 24)
    np.testing.assert_allclose(gm["elevation"].numpy(), 1.0, atol=1e-6)


def test_update_parameters_sources(tmp_path):
    """A typed config, YAML files and loaded documents; the last two merge
    onto the current config."""
    node = TraversabilityNode(_config(max_gap_width=0.21), device="cpu")
    node.push_initial_grid_map(_terrain(32, 3))
    assert node.update_parameters(config=dataclasses.replace(node.config, min_update_rate=5.0))
    assert node.timer_enabled and node.config.min_update_rate == 5.0
    assert node._timer is None  # not started: no thread

    path = tmp_path / "robot_footprint_parameter.yaml"
    path.write_text(yaml.safe_dump(
        {"footprint": {"traversability_default": 0.3, "circular_footprint_radius": 0.5}}))
    assert node.update_parameters(footprint_yaml=str(path))
    assert node.config.min_update_rate == 5.0 and node.config.max_gap_width == 0.21
    assert node.config.map_length == (1.0, 1.0)
    assert node.config.footprint.traversability_default == 0.3
    assert node.config.footprint.circular_footprint_radius == 0.5
    assert node.estimator.config is node.config
    assert node.estimator._traversability_default == 0.3

    two = "0.5*(traversability_slope + traversability_step)"
    filters = [dict(f) for f in reference_documents()["filters"]]
    filters[4] = {**filters[4], "params": {**filters[4]["params"], "expression": two}}
    before = node.get_traversability_map()["traversability"]
    assert node.update_parameters(documents={"filters": filters, "robot": {"min_update_rate": 0}})
    assert node.config.chain.fusion_expression == two and not node.timer_enabled
    assert node.config.footprint.traversability_default == 0.3  # kept
    assert node.request_update()
    layers = node.get_traversability_map()
    want = 0.5 * (layers["traversability_slope"] + layers["traversability_step"])
    assert torch.equal(layers["traversability"].nan_to_num(-1), want.nan_to_num(-1))
    assert not torch.equal(before.nan_to_num(-1), want.nan_to_num(-1))


def test_update_parameters_spawns_and_stops_timer():
    cfg = _config()
    node = TraversabilityNode(cfg, source=_source(), device="cpu")
    with node:
        assert node._timer is None  # rate 0: no thread
        node.update_parameters(config=dataclasses.replace(cfg, min_update_rate=50.0))
        timer = node._timer
        assert timer is not None and timer.is_alive()
        base = node.update_count
        assert _wait(lambda: node.update_count >= base + 2)  # ticking at the new rate
        node.update_parameters(config=dataclasses.replace(cfg, min_update_rate=0.0))
        assert node._timer is None and not timer.is_alive()


def test_plane_encoding_matches_jax():
    from traversability_estimation_tpu.service import decode_plane as jdecode
    from traversability_estimation_tpu.service import encode_plane as jencode

    plane = _terrain(9, 1)
    assert encode_plane(plane) == jencode(plane)
    np.testing.assert_array_equal(decode_plane(jencode(plane)), jdecode(encode_plane(plane)))


def test_service_roundtrip_all_seven(server, tmp_path):
    host, port = server.address
    with TraversabilityClient(host, port, timeout=60.0) as cli:
        # 1. update_traversability
        resp = cli.update_traversability()
        assert resp["ok"] and resp["map_info"]["size"] == [33, 33]
        # 2. get_traversability with layer payloads; bool planes travel as float
        resp = cli.get_traversability(layers=["traversability", "traversable_mask"])
        assert resp["ok"] and set(resp["data"]) == {"traversability", "traversable_mask"}
        gm = server.node.get_traversability_map()
        np.testing.assert_array_equal(
            np.nan_to_num(resp["data"]["traversability"], nan=-1),
            np.nan_to_num(gm["traversability"].numpy(), nan=-1))
        np.testing.assert_array_equal(
            resp["data"]["traversable_mask"], gm["traversable_mask"].numpy().astype(np.float32))
        # 3. check_footprint_path: circular and polygonal in one request
        resp = cli.check_footprint_path(PATHS)
        assert resp["ok"] and len(resp["results"]) == len(PATHS)
        direct = server.node.check_footprint_path([
            FootprintPath(poses=np.float32(p["poses"]), radius=p.get("radius", 0.0),
                          footprint=np.float32(p["footprint"]) if "footprint" in p else None,
                          orientations=(np.float32(p["orientations"])
                                        if "orientations" in p else None),
                          conservative=p.get("conservative", False),
                          compute_untraversable_polygon=p.get(
                              "compute_untraversable_polygon", False))
            for p in PATHS])
        for r, d in zip(resp["results"], direct):
            assert r["is_safe"] == d.is_safe and r["traversability"] == d.traversability
            assert r["area"] == d.area and 0.0 <= r["traversability"] <= 1.0
            assert ("untraversable_polygon" in r) == (d.untraversable_polygon is not None)
            if d.untraversable_polygon is not None:
                np.testing.assert_array_equal(r["untraversable_polygon"], d.untraversable_polygon)
        # 4. traversability_footprint (the dense layers appear)
        resp = cli.traversability_footprint()
        assert resp["ok"] and "traversability_x" in resp["map_info"]["layers"]
        # 5. save, 6. load: a round trip through the bag checkpoint
        ckpt = str(tmp_path / "srv.bag")
        assert cli.save_traversability_map_to_bag(ckpt)["ok"]
        resp = cli.load_elevation_map(ckpt)
        assert resp["ok"] and resp["map_info"]["size"] == [33, 33]
        assert not cli.load_elevation_map(str(tmp_path / "none.bag"))["ok"]
        # 7. update_parameters from a YAML file and from documents
        path = tmp_path / "robot.yaml"
        path.write_text(yaml.safe_dump({"max_gap_width": 0.25}))
        assert cli.update_parameters(robot_yaml=str(path))["ok"]
        assert server.node.config.max_gap_width == 0.25
        assert cli.update_parameters(documents={"footprint": {"traversability_default": 0.4}})["ok"]
        assert server.node.config.footprint.traversability_default == 0.4
        assert server.node.config.max_gap_width == 0.25
        # error paths stay JSON
        resp = cli.call("no_such_service")
        assert not resp["ok"] and "unknown service" in resp["error"]
        assert not cli.get_traversability(layers=["nope"])["ok"]
        resp = cli.call("load_elevation_map")  # a missing argument is reported, not fatal
        assert not resp["ok"] and "KeyError" in resp["error"]
        assert cli.update_traversability()["ok"]


def test_service_push_elevation(server):
    host, port = server.address
    with TraversabilityClient(host, port, timeout=60.0) as cli:
        assert not cli.get_traversability()["ok"]  # not initialized yet
        elev = _terrain(24, 11)
        assert cli.set_elevation_map(elev, (0.1, -0.2))["ok"]
        resp = cli.get_traversability(layers=["elevation"])
        assert resp["ok"]
        np.testing.assert_array_equal(
            np.nan_to_num(resp["data"]["elevation"], nan=-1.0), np.nan_to_num(elev, nan=-1.0))
        assert resp["map_info"]["position"][:2] == pytest.approx([0.1, -0.2])
        resp = cli.set_elevation_map(elev)
        assert not resp["ok"] and "already initialized" in resp["error"]


def test_service_get_traversability_submap(server):
    host, port = server.address
    with TraversabilityClient(host, port, timeout=60.0) as cli:
        assert cli.update_traversability()["ok"]
        full = cli.get_traversability(layers=["traversability"])
        rows, cols = full["map_info"]["size"]
        res = full["map_info"]["resolution"]
        cx, cy = full["map_info"]["position"]
        # an interior submap: ~0.3 m square around the centre
        resp = cli.get_traversability(
            layers=["traversability"], position=(cx, cy), length=(0.31, 0.31))
        assert resp["ok"]
        sr, sc = resp["map_info"]["size"]
        assert 0 < sr < rows and 0 < sc < cols
        sub = resp["data"]["traversability"]
        i0, j0 = round((rows - sr) / 2), round((cols - sc) / 2)
        np.testing.assert_array_equal(
            np.nan_to_num(sub, nan=-7.0),
            np.nan_to_num(full["data"]["traversability"][i0 : i0 + sr, j0 : j0 + sc], nan=-7.0))
        # no layer filter: all layers of the submap come back
        resp = cli.get_traversability(position=(cx, cy), length=(0.31, 0.31))
        assert resp["ok"] and set(resp["data"]) == set(resp["map_info"]["layers"])
        assert all(v.shape == (sr, sc) for v in resp["data"].values())
        # partly off the map: clipped but ok (the centre is on the map)
        resp = cli.get_traversability(
            layers=["traversability"], position=(cx + rows * res / 2 - 2 * res, cy),
            length=(8 * res, 4 * res))
        assert resp["ok"] and resp["map_info"]["size"][0] < 8
        # wholly off the map
        assert not cli.get_traversability(
            layers=["traversability"], position=(cx + rows * res, cy),
            length=(4 * res, 4 * res))["ok"]


def _drive(cli, tmp_path, tag):
    """One client's exchange: every service but update_parameters' files."""
    out = {"update": cli.update_traversability()}
    out["map"] = cli.get_traversability(layers=["traversability_step", "traversability",
                                                "traversable_mask"])
    out["sub"] = cli.get_traversability(layers=["elevation"], position=(0.05, 0.0),
                                        length=(0.4, 0.3))
    out["paths"] = cli.check_footprint_path(PATHS)
    out["footprint"] = cli.traversability_footprint()
    ckpt = str(tmp_path / f"{tag}.bag")
    out["save"] = cli.save_traversability_map_to_bag(ckpt)
    out["load"] = cli.load_elevation_map(ckpt)
    out["unknown"] = cli.call("nope")
    return out


def test_clients_and_servers_cross_the_packages(tmp_path):
    """The wire format is one: the JAX client against the port's server, the
    port's client against the JAX server, and each against its own, fed the
    same source, give the same answers."""
    cfg = _config()
    jcfg = JaxConfig(resolution=RES, min_update_rate=0.0, map_length=(1.0, 1.0), chain=None)
    jcfg = dataclasses.replace(jcfg, chain=dataclasses.replace(
        jcfg.chain, fusion_expression=cfg.chain.fusion_expression))
    exchanges = {}
    for server_name in ("port", "jax"):
        for client_name, client_cls in (("port", TraversabilityClient), ("jax", JaxClient)):
            if server_name == "port":
                node = TraversabilityNode(cfg, source=_source(seed=7), device="cpu")
                srv = TraversabilityServer(node)
            else:
                node = JaxNode(jcfg, source=_source(seed=7, cls=JaxArraySource))
                srv = JaxServer(node)
            with srv:
                # the JAX server compiles each service at its first request
                # (its first traversability_footprint: 22 s alone, 60-120 s on
                # a loaded host): no request may time out before the whole
                # test suite's own limit does
                with client_cls(*srv.address, timeout=1500.0) as cli:
                    exchanges[server_name, client_name] = _drive(
                        cli, tmp_path, f"{server_name}_{client_name}")
    want = exchanges["jax", "jax"]
    for key, got in exchanges.items():
        for name in ("update", "save", "load", "footprint", "map", "sub"):
            assert got[name]["ok"], (key, name)
        assert got["unknown"] == want["unknown"]
        assert got["update"]["map_info"] == want["update"]["map_info"], key
        assert got["load"]["map_info"]["layers"] == want["load"]["map_info"]["layers"], key
        assert got["sub"]["map_info"] == want["sub"]["map_info"], key
        np.testing.assert_array_equal(got["sub"]["data"]["elevation"],
                                      want["sub"]["data"]["elevation"])
        for layer, atol in (("traversability_step", 0.0), ("traversable_mask", 0.0),
                            ("traversability", 2e-4)):
            g, w = got["map"]["data"][layer], want["map"]["data"][layer]
            assert (np.isnan(g) == np.isnan(w)).all(), (key, layer)
            np.testing.assert_allclose(np.nan_to_num(g), np.nan_to_num(w), rtol=0, atol=atol)
        for g, w in zip(got["paths"]["results"], want["paths"]["results"]):
            assert g["is_safe"] == w["is_safe"], key
            assert abs(g["traversability"] - w["traversability"]) <= 2e-4
            assert abs(g["area"] - w["area"]) <= 1e-5 * abs(w["area"]) + 1e-6
            assert ("untraversable_polygon" in g) == ("untraversable_polygon" in w)
            if "untraversable_polygon" in w:
                np.testing.assert_allclose(g["untraversable_polygon"], w["untraversable_polygon"],
                                           atol=1e-9)
    # one server, two clients: the same bytes on the wire
    for name in ("update", "paths", "load"):
        assert exchanges["port", "port"][name] == exchanges["port", "jax"][name]


def test_four_clients_hammer_a_ticking_node():
    """Four client threads query one node while its timer ticks at 100 Hz on
    a static source: every answer equals a quiescent node's, nothing raises,
    and the timer kept updating."""
    rng = np.random.default_rng(3)
    requests = []
    for _ in range(6):
        starts = rng.uniform(-0.3, 0.3, (6, 2))
        poses = starts[:, None] + np.cumsum(rng.uniform(-0.05, 0.05, (6, 4, 2)), 1)
        requests.append(
            [{"poses": p.tolist(), "radius": 0.1, "compute_untraversable_polygon": True}
             for p in poses[:4]]
            + [{"poses": p.tolist(), "footprint": RECT, "compute_untraversable_polygon": True}
               for p in poses[4:]])
    quiet = TraversabilityNode(_config(), source=_source(seed=7), device="cpu")
    with TraversabilityServer(quiet) as srv, TraversabilityClient(*srv.address, timeout=60.0) as cli:
        assert cli.update_traversability()["ok"]
        want = [cli.check_footprint_path(r) for r in requests]
        want_map = cli.get_traversability(layers=["traversability"])["data"]["traversability"]
    assert any(not r["is_safe"] for w in want for r in w["results"])

    node = TraversabilityNode(_config(min_update_rate=100.0), source=_source(seed=7), device="cpu")
    errors, done = [], []

    def client(address, rounds):
        try:
            with TraversabilityClient(*address, timeout=60.0) as cli:
                for k in range(rounds):
                    i = k % len(requests)
                    if cli.check_footprint_path(requests[i]) != want[i]:
                        errors.append(f"request {i} differs")
                    if k % 5 == 0:
                        got = cli.get_traversability(layers=["traversability"])
                        if not np.array_equal(got["data"]["traversability"], want_map,
                                              equal_nan=True):
                            errors.append("map differs")
            done.append(rounds)
        except Exception as e:  # noqa: BLE001 - reported to the main thread
            errors.append(repr(e))

    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        with node, TraversabilityServer(node) as srv:
            assert _wait(lambda: node.estimator.initialized)
            base = node.update_count
            threads = [threading.Thread(target=client, args=(srv.address, 30), daemon=True)
                       for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            assert not any(t.is_alive() for t in threads)
            ticks = node.update_count - base
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[:3]
    assert done == [30] * 4 and ticks >= 3 and node.total_failures == 0


def test_cli_run_and_serve(tmp_path, capsys):
    ckpt = str(tmp_path / "cli.npz")
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    docs = reference_documents()
    (cfg_dir / "robot.yaml").write_text(yaml.safe_dump(docs["robot"]))
    (cfg_dir / "robot_filter_parameter.yaml").write_text(
        yaml.safe_dump({"traversability_map_filters": docs["filters"]}))
    rc = cli_main(["run", "--device", "cpu", "--config-dir", str(cfg_dir), "--check", "0,0",
                   "0.3,0.2", "--save", ckpt, "--dump-png", str(tmp_path / "png")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "map 128x128" in out and "path check (2 poses" in out and "on cpu" in out
    assert (tmp_path / "png" / "map_traversability.png").exists()
    rc = cli_main(["run", "--device", "cpu", "--map", ckpt])
    assert rc == 0 and "map 128x128" in capsys.readouterr().out
    assert cli_main(["run", "--device", "cpu", "--map", str(tmp_path / "none.bag")]) == 1
    assert cli_main(["serve", "--device", "cpu", "--map", str(tmp_path / "none.bag")]) == 1
