"""Multi-chip sharding on the 8-virtual-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""

import numpy as np
import jax
import pytest

pytestmark = pytest.mark.slow  # compile-heavy (see pyproject addopts)

from tpurt.config import RenderConfig
from tpurt.parallel import make_mesh, render_frame_sharded
from tpurt.render.renderer import render_frame
from tpurt.scene.presets import cornell_sphere_scene


requires_8 = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def small_scene():
    cfg = RenderConfig(width=16, height=20, rays_per_pixel=4, max_bounces=3,
                       tile_size=16, object_path="sphere0.obj")
    scene, cam, _ = cornell_sphere_scene(0, cfg)
    return scene, cam, cfg


@requires_8
def test_tile_sharding_bitwise_identical(small_scene):
    """The headline property: sharding over chips changes NOTHING —
    fixing the reference's multi-GPU seed drift (image.hpp:228,304)."""
    scene, cam, cfg = small_scene
    single = render_frame(scene, cam, cfg)
    for n in (2, 4, 8):
        mesh = make_mesh(tile_devices=n, devices=jax.devices()[:n])
        sharded = render_frame_sharded(scene, cam, cfg, mesh=mesh)
        np.testing.assert_array_equal(single, sharded)


@requires_8
def test_overdecompose_bitwise_identical(small_scene):
    """k round-robin blocks per chip (the SPMD answer to the reference's
    dynamic tile queue, image.hpp:289-333) changes NOTHING: seeds are
    pure functions of absolute pixel index."""
    scene, cam, cfg = small_scene
    single = render_frame(scene, cam, cfg)
    mesh = make_mesh(tile_devices=4, devices=jax.devices()[:4])
    for k in (2, 3):
        sharded = render_frame_sharded(scene, cam, cfg, mesh=mesh,
                                       overdecompose=k)
        np.testing.assert_array_equal(single, sharded)


@requires_8
def test_sharded_quota_lanes_bitwise_identical(small_scene):
    """pixels_per_lane > 1 (the quota scheduling bench.py times) under
    sharding, bitwise vs the single-chip render at the same quota."""
    scene, cam, cfg = small_scene
    cfg = cfg.replace(pixels_per_lane=2)
    single = render_frame(scene, cam, cfg)
    mesh = make_mesh(tile_devices=4, devices=jax.devices()[:4])
    stats: dict = {}
    sharded = render_frame_sharded(scene, cam, cfg, mesh=mesh, stats=stats)
    np.testing.assert_array_equal(single, sharded)
    assert stats["segments"] > 0


@requires_8
def test_sample_sharding_matches_single(small_scene):
    scene, cam, cfg = small_scene
    cfg = cfg.replace(seed_mode="decorrelated")
    single = render_frame(scene, cam, cfg)
    mesh = make_mesh(tile_devices=4, sample_devices=2)
    sharded = render_frame_sharded(scene, cam, cfg, mesh=mesh)
    np.testing.assert_allclose(single, sharded, atol=1e-5)


@requires_8
def test_sample_sharding_requires_decorrelated(small_scene):
    scene, cam, cfg = small_scene
    mesh = make_mesh(tile_devices=4, sample_devices=2)
    with pytest.raises(ValueError, match="decorrelated"):
        render_frame_sharded(scene, cam, cfg, mesh=mesh)


@requires_8
def test_spp_divisibility_checked(small_scene):
    scene, cam, cfg = small_scene
    mesh = make_mesh(tile_devices=4, sample_devices=2)
    with pytest.raises(ValueError, match="divisible"):
        render_frame_sharded(
            scene, cam, cfg.replace(seed_mode="decorrelated", rays_per_pixel=5),
            mesh=mesh,
        )


def test_graft_entry_contract():
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (64, 64, 3)
    assert np.isfinite(np.asarray(out)).all()


@requires_8
def test_graft_dryrun_multichip():
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import __graft_entry__ as g

    g.dryrun_multichip(8)


@requires_8
def test_sharding_efficiency_branch_runs():
    """bench.run_sharding_efficiency's MEASURING branch (the >=2-device
    code, BASELINE.md) end to end on the virtual mesh: the number is
    meaningless on the CPU, but a
    finite efficiency proves the plumbing — warmup, timed sharded
    renders, the efficiency arithmetic."""
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import bench

    cfg = RenderConfig(width=64, height=32, rays_per_pixel=2,
                       max_bounces=2, rays_per_batch=1024,
                       pixels_per_lane=2, tile_size=16)
    row = bench.run_sharding_efficiency(cfg, repeats=1, force=True,
                                        scene_kind="sphere")
    assert row["devices"] == 8
    assert np.isfinite(row["efficiency"]) and row["efficiency"] > 0
