"""The port's multi-process entry point (parallel/multihost.py) in two real
processes on the CPU over gloo: ``initialize_multihost`` from explicit
arguments (coordinator address, number of processes, process id) and from a
torchrun-style environment, the (1, 2) grid it returns, a tiled update with
a halo exchange across the processes (bit-identical to the port's whole-map
update and, in its step layer and veto planes, to the JAX package's), and a
group whose size differs from the one asked for, which raises. The
multi-process form of tests/test_multihost.py.
"""

import socket

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_cases as cases
from traversability_estimation_tpu.models.estimator import _update_step
from traversability_estimation_tpu.ops.filters import ChainConfig as JChain
from traversability_estimation_tpu.ops.veto import VetoConfig as JVeto
from traversability_estimation_tpu_torch.ops import update_kernel, veto
from traversability_estimation_tpu_torch.ops.filters import ChainConfig
from traversability_estimation_tpu_torch.parallel import multihost
from traversability_estimation_tpu_torch.parallel.sharding import backend_for

RES = 0.03
TIMEOUT = 300.0


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Two 2-process worlds, started together: explicit arguments and the
    environment."""
    d = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(0)
    elev = (0.05 * rng.standard_normal((64, 64))).astype(np.float32)
    elev[rng.random((64, 64)) < 0.05] = np.nan
    inp = {"mh_elev": elev}
    np.savez(d / "inputs.npz", **inp)
    runs = {
        "args": cases.spawn_world(2, ["grid", "multihost_update", "multihost_mismatch"],
                                  d / "inputs.npz", d / "args", f"tcp://localhost:{_free_port()}"),
        "env": cases.spawn_world(2, ["grid", "multihost_update"], d / "inputs.npz", d / "env",
                                 f"env://localhost:{_free_port()}"),
    }
    waited = set()

    def result(kind, case):
        if kind not in waited:
            cases.wait_world(runs[kind], TIMEOUT)
            waited.add(kind)
        return cases.load_result(d / kind, case)

    yield inp, result
    for ps in runs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("kind", ["args", "env"])
def test_two_process_sharded_update(worlds, kind):
    inp, result = worlds
    assert tuple(result(kind, "grid")["shape"]) == (1, 2)
    got = result(kind, "multihost_update")
    want = update_kernel.fused_update_plain(
        torch.from_numpy(inp["mh_elev"]), ChainConfig(resolution=RES), veto.VetoConfig(resolution=RES))
    for k, v in want.items():
        assert np.array_equal(got[k], v.numpy(), equal_nan=v.is_floating_point()), k
    ref = _update_step(jnp.asarray(inp["mh_elev"]), JChain(resolution=RES), JVeto(resolution=RES))
    for k in ("traversability_step", "traversable_mask", "step_ok", "slope_ok"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    trav, trav_j = got["traversability"], np.asarray(ref["traversability"])
    assert (np.isfinite(trav) == np.isfinite(trav_j)).all()
    fin = np.isfinite(trav_j)
    np.testing.assert_allclose(trav[fin], trav_j[fin], rtol=0, atol=2e-4)


def test_group_of_another_size_raises(worlds):
    _, result = worlds
    msg = str(result("args", "multihost_mismatch")["raised"])
    assert "expected 3 processes, the group has 2" in msg


def test_backend_follows_the_device():
    assert backend_for(torch.device("cpu")) == "gloo"
    assert backend_for(torch.device("cuda")) == "nccl"
    assert backend_for(torch.device("cuda", 1)) == "nccl"


def test_default_device_is_cuda():
    """Without a device the entry point asks for CUDA, and raises where
    there is none before it touches the process group."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the CPU-only machine")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize_multihost("localhost:1", 1, 0)
    assert not torch.distributed.is_initialized()
