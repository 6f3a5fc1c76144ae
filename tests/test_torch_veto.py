"""The port's dense veto fields (traversability_estimation_tpu_torch.ops.veto)
against the JAX veto fields, on the CPU. Every mask cell-exact; the float
``*_footprint`` layers equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traversability_estimation_tpu.ops import filters as jf
from traversability_estimation_tpu.ops import veto as jv
from traversability_estimation_tpu.parallel.sharding import required_halo as jax_required_halo
from traversability_estimation_tpu_torch.ops import update_kernel
from traversability_estimation_tpu_torch.ops import veto as tv
from traversability_estimation_tpu_torch.ops.filters import ChainConfig, run_chain

RES = 0.03


@pytest.fixture(scope="module")
def layers():
    """Chain layers of a rough map (made by the port's chain: the veto
    inputs only need to be the same for both engines)."""
    from conftest import synthetic_terrain

    elev = synthetic_terrain(72, 90, RES, seed=21, nan_frac=0.06)
    out = run_chain(torch.from_numpy(elev), ChainConfig(resolution=RES))
    return {
        "elevation": elev,
        **{k: out[k].numpy() for k in (
            "traversability_slope", "traversability_step", "traversability_roughness")},
    }


@pytest.fixture(scope="module")
def jax_veto(layers):
    """The JAX veto fields with the roughness veto on: a superset of the
    planes of the run without it."""
    return jv.compute_veto_fields_jit(
        {k: jnp.asarray(v) for k, v in layers.items()},
        jv.VetoConfig(resolution=RES, check_roughness=True),
    )


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("check_roughness", [False, True])
def test_compute_veto_fields_matches_jax(layers, jax_veto, check_roughness):
    ref = {k: np.asarray(v) for k, v in jax_veto.items()}
    if not check_roughness:
        ref = {k: v for k, v in ref.items() if not k.startswith("roughness")}
        ref["traversable_mask"] = ref["slope_ok"] & ref["step_ok"]
    out = tv.compute_veto_fields(
        _torch(layers), tv.VetoConfig(resolution=RES, check_roughness=check_roughness)
    )
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)
    # the veto must bite on this map, or the comparison proves little
    assert not out["traversable_mask"].all() and out["traversable_mask"].any()


def test_step_veto_ok_with_in_map_matches_v1(layers):
    """The sentinel-folded step veto with a global in-map plane against the
    JAX package's retained referee formulation (step_veto_ok_v1)."""
    in_map = np.random.default_rng(4).random(layers["elevation"].shape) > 0.15
    cfg = dict(resolution=RES, critical_step_height=0.08)
    ref = jax.jit(jv.step_veto_ok_v1, static_argnums=(2,))(
        jnp.asarray(layers["elevation"]), jnp.asarray(layers["traversability_step"]),
        jv.VetoConfig(**cfg), jnp.asarray(in_map),
    )
    out = tv.step_veto_ok(
        torch.from_numpy(layers["elevation"].copy()),
        torch.from_numpy(layers["traversability_step"].copy()),
        tv.VetoConfig(**cfg), torch.from_numpy(in_map),
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert not out.all()


@pytest.mark.parametrize("max_gap_width", [0.3, 0.2])
def test_required_halo_and_kernel_reaches(max_gap_width):
    """The copied required_halo equals the JAX package's, and kernel 1's
    windows cover every stage's stencil within it: the layers kernel's
    elevation window the step windows, the moments and the ray walk; the
    veto kernel's window the count disc and the candidates + one step."""
    chain = ChainConfig(resolution=RES)
    vcfg = tv.VetoConfig(resolution=RES, max_gap_width=max_gap_width)
    jax_halo = jax_required_halo(
        jf.ChainConfig(resolution=RES), jv.VetoConfig(resolution=RES, max_gap_width=max_gap_width)
    )
    assert tv.required_halo(chain, vcfg) == jax_halo
    p = update_kernel.kernel_params(chain, vcfg)
    walk = max(k for _, _, k in tv._ray_directions(vcfg))
    assert (p.r_ray, p.r_mid, p.r_sh) == (2, 3, 1)
    assert p.halo == max(2, walk) <= jax_halo
    assert (p.n_mom_n, p.n_s1, p.n_s2, p.n_cnt, p.n_dirs, p.n_cand) == (9, 5, 5, 29, 8, 20)
    cand = [(p.cand[3 * k], p.cand[3 * k + 1]) for k in range(p.n_cand)]
    cnt = [(p.cnt[2 * k], p.cnt[2 * k + 1]) for k in range(p.n_cnt)]
    assert max(max(abs(a), abs(b)) for a, b in cand) == p.r_ray
    assert max(max(abs(a), abs(b)) for a, b in cnt) <= p.r_mid


@pytest.mark.parametrize("with_in_map", [False, True])
def test_step_veto_ok_v1_matches_jax_and_the_folded_form(layers, with_in_map):
    """The port's bool-plane step veto: cell for cell the JAX package's
    step_veto_ok_v1 and the port's sentinel-folded step_veto_ok."""
    in_map = np.random.default_rng(5).random(layers["elevation"].shape) > 0.15
    cfg = dict(resolution=RES, critical_step_height=0.08)
    im = in_map if with_in_map else None
    ref = jax.jit(jv.step_veto_ok_v1, static_argnums=(2,))(
        jnp.asarray(layers["elevation"]), jnp.asarray(layers["traversability_step"]),
        jv.VetoConfig(**cfg), None if im is None else jnp.asarray(im))
    args = (torch.from_numpy(layers["elevation"].copy()),
            torch.from_numpy(layers["traversability_step"].copy()), tv.VetoConfig(**cfg),
            None if im is None else torch.from_numpy(im))
    out = tv.step_veto_ok_v1(*args)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), tv.step_veto_ok(*args).numpy())
    assert not out.all()
