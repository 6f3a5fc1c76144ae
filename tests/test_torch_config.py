"""The port's configuration loading (utils/config.py) against the JAX
package's ``load_config``: the same YAML files, written to a temporary
directory, give the same configuration field by field (the JAX config
carried across by ``config_from_fields``), with and without a base to merge
onto. Exact: configurations hold no computed floats.
"""

import dataclasses
import os

import pytest
import yaml

from traversability_estimation_tpu.utils import config as jconfig
from traversability_estimation_tpu_torch.utils import config as tconfig
from traversability_estimation_tpu_torch.utils.convert import config_from_fields

DOCS = tconfig.reference_documents()

ROBOT = {"map_frame_id": "odom", "robot_frame_id": "base_link", "min_update_rate": 4.0,
         "map_length_x": 6.0, "map_length_y": 5.0, "map_center_x": 0.5, "map_center_y": -0.25,
         "footprint_yaw": 0.7, "max_gap_width": 0.2, "use_raw_map": True}
FOOTPRINT = {"footprint_polygon": [[0.3, 0.2], [0.3, -0.2], [-0.3, -0.2], [-0.3, 0.2]],
             "circular_footprint_radius": 0.4, "circular_footprint_radius_inscribed": 0.2,
             "circular_footprint_offset": 0.1, "footprint_frame_id": "body",
             "traversability_default": 0.3, "verify_roughness_footprint": True,
             "check_robot_inclination": True}
GENERIC = [
    {"name": "smooth", "type": "gridMapFilters/MeanInRadiusFilter",
     "params": {"input_layer": "elevation", "output_layer": "elevation_smooth", "radius": 0.06}},
    *DOCS["filters"][:4],
    {"name": "fuse", "type": "gridMapFilters/MathExpressionFilter",
     "params": {"expression": "min(traversability_slope, traversability_step)",
                "output_layer": "traversability"}},
]

# name -> (robot, filters, footprint) documents; None: the file is not given
CASES = {
    "reference": (DOCS["robot"], DOCS["filters"], DOCS["footprint"]),
    "every_field": (ROBOT, DOCS["filters"], FOOTPRINT),
    "generic_chain": (None, GENERIC, None),
    "no_files": (None, None, None),
    "footprint_only": (None, None, {"traversability_default": 0.3}),
    "partial_filters": (None, [DOCS["filters"][2], DOCS["filters"][4]], None),
    "empty_files": ({}, [], {}),
}


def _write(tmp_path, robot, filters, footprint):
    paths = {}
    for key, name, doc in (
        ("robot_yaml", "robot.yaml", robot),
        ("filter_yaml", "robot_filter_parameter.yaml",
         None if filters is None else {"traversability_map_filters": filters}),
        ("footprint_yaml", "robot_footprint_parameter.yaml",
         None if footprint is None else {"footprint": footprint}),
    ):
        if doc is not None:
            path = tmp_path / name
            path.write_text(yaml.safe_dump(doc))
            paths[key] = str(path)
    return paths


def _assert_equal(tcfg, jcfg):
    carried = config_from_fields(jcfg)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(carried, f.name), f.name
    assert dataclasses.asdict(tcfg.veto) == dataclasses.asdict(jcfg.veto)
    assert tcfg.elevation_layers == jcfg.elevation_layers


@pytest.mark.parametrize("resolution", [0.03, 0.05])
@pytest.mark.parametrize("name", sorted(CASES))
def test_load_config_matches_jax(tmp_path, name, resolution):
    paths = _write(tmp_path, *CASES[name])
    tcfg = tconfig.load_config(resolution=resolution, **paths)
    _assert_equal(tcfg, jconfig.load_config(resolution=resolution, **paths))
    robot, filters, footprint = CASES[name]
    assert tcfg == tconfig.config_from_documents(robot, filters, footprint, resolution=resolution)
    assert tcfg.use_generic_chain == (name == "generic_chain")


@pytest.mark.parametrize("name", sorted(CASES))
def test_base_merge_matches_jax(tmp_path, name):
    """A reload keeps what the files do not mention, the resolution too."""
    base_paths = _write(tmp_path, ROBOT, GENERIC, FOOTPRINT)
    tbase = tconfig.load_config(resolution=0.04, **base_paths)
    jbase = jconfig.load_config(resolution=0.04, **base_paths)
    sub = tmp_path / "reload"
    sub.mkdir()
    paths = _write(sub, *CASES[name])
    tcfg = tconfig.load_config(base=tbase, **paths)
    _assert_equal(tcfg, jconfig.load_config(base=jbase, **paths))
    assert tcfg.resolution == 0.04 and tcfg.chain.resolution == 0.04
    robot, filters, footprint = CASES[name]
    if not filters:
        assert tcfg.chain == tbase.chain and tcfg.filter_specs == tbase.filter_specs
        assert tcfg.use_generic_chain
    if not robot:
        assert tcfg.map_length == (6.0, 5.0) and tcfg.max_gap_width == 0.2
    if footprint == {"traversability_default": 0.3}:
        assert tcfg.footprint == dataclasses.replace(tbase.footprint, traversability_default=0.3)


def test_reference_documents_are_the_defaults():
    """The inline upstream parameter set: the canonical chain with its fusion
    expression; every other value is the typed default."""
    cfg = tconfig.config_from_documents(**DOCS)
    default = tconfig.EstimatorConfig(resolution=0.03)
    assert not cfg.use_generic_chain and len(cfg.filter_specs) == 6
    assert cfg.chain.fusion_expression.replace(" ", "") == (
        "(1.0/3.0)*(traversability_slope+traversability_step+traversability_roughness)")
    assert dataclasses.replace(cfg.chain, fusion_expression="") == default.chain
    assert cfg.footprint == default.footprint
    assert dataclasses.replace(cfg, chain=default.chain, filter_specs=()) == default


def test_import_needs_no_yaml():
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"  # any import of it now raises
        "from traversability_estimation_tpu_torch.utils.config import (\n"
        "    config_from_documents, load_config, reference_documents)\n"
        "import traversability_estimation_tpu_torch.node, traversability_estimation_tpu_torch.service\n"
        "import traversability_estimation_tpu_torch.__main__\n"
        "cfg = config_from_documents(**reference_documents())\n"
        "assert cfg.chain.fusion_expression\n"
        "try:\n"
        "    load_config()\n"
        "except ImportError:\n"
        "    print('load_config alone needs yaml')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, env={**os.environ, "PYTHONPATH": repo},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "load_config alone needs yaml" in out.stdout
