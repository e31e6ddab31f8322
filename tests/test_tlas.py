"""Instance-level acceleration (TLAS).

Above config.MEGA_TLAS_THRESHOLD instanced meshes, freeze routes them
through instance ROWS in the mega bank under a world-space top-level
BVH (builder._emit_tlas) — chain-enter becomes a traversal step instead
of K unrolled select/enter stages (the reference's O(K)-per-ray mesh
loop, src/Trace.cl:444-482, replaced by an O(log K) structure). The
TLAS render must be bitwise-identical to the unrolled-chain engine on
the same geometry (trajectory order differs, hit RESULTS do not) and
to the modular cross-check engine.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # compile-heavy (see pyproject addopts)

import tpurt.config as config_mod
from tpurt.render.renderer import render_frame


def _grid(k):
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "tmm", os.path.join(os.path.dirname(__file__), "test_many_meshes.py")
    )
    tmm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tmm)
    return tmm._grid_scene(k)


def test_tlas_engages_above_threshold_and_matches_unrolled(monkeypatch):
    scene, cam, cfg = _grid(12)
    assert scene.mega_tlas
    assert scene.mega_chain[-1][0] == -2
    assert len(scene.mega_tlas_bounds) == 6
    img_tlas = render_frame(scene, cam, cfg)
    assert np.isfinite(img_tlas).all() and img_tlas.max() > 0.0

    # Same builder scene through the unrolled chain: bitwise-equal.
    monkeypatch.setattr(config_mod, "MEGA_TLAS_THRESHOLD", 10_000)
    scene2, cam2, _ = _grid(12)
    assert not scene2.mega_tlas
    img_chain = render_frame(scene2, cam2, cfg.replace(rays_per_batch=768))
    np.testing.assert_array_equal(img_tlas, img_chain)


def test_tlas_matches_modular_engine():
    """The readable nested-loop engine is TLAS-independent (it walks
    scene.node_* directly) — cross-engine agreement on a TLAS scene."""
    scene, cam, cfg = _grid(10)
    assert scene.mega_tlas
    mega = render_frame(scene, cam, cfg)
    modular = render_frame(scene, cam, cfg.replace(engine="modular"))
    np.testing.assert_array_equal(mega, modular)


def test_tlas_small_k_keeps_unrolled_chain():
    scene, _, _ = _grid(4)
    assert not scene.mega_tlas  # 4 <= threshold 8: measured-fast selects


def test_tlas_refuses_post_freeze_animation():
    from tpurt.anim import set_mesh_yaw

    scene, _, _ = _grid(12)
    with pytest.raises(ValueError, match="TLAS"):
        set_mesh_yaw(scene, scene.num_meshes - 1, 1.0)


def test_tlas_quota_and_staged_paths():
    """TLAS lane state must survive the quota machinery and the
    host-staged compaction driver (state slicing is pytree-generic)."""
    scene, cam, cfg = _grid(12)
    plain = render_frame(scene, cam, cfg)
    quota = render_frame(
        scene, cam, cfg.replace(rays_per_batch=256, pixels_per_lane=2)
    )
    np.testing.assert_array_equal(plain, quota)
    staged = render_frame(
        scene, cam, cfg.replace(rays_per_batch=512, compaction_threshold=256)
    )
    # Staged re-runs tail lanes under a different executable: identical
    # up to the usual 1-ulp class (test_flat_batching contract).
    exact = (plain == staged).all(axis=-1)
    assert exact.mean() > 0.98, exact.mean()
    np.testing.assert_allclose(plain, staged, rtol=1e-5, atol=1e-7)


def test_material_slot_dedup_and_recolor():
    """Freeze-time material dedup (mesh_mat_slot): the two-level fetch
    must agree with the per-mesh chain, and viewer recolor_mesh must
    re-slot a tinted mesh without leaking the tint to meshes that
    shared its material."""
    import jax.numpy as jnp

    from tpurt.render.shading import pack_materials, select_material_soa
    from tpurt.viewer import recolor_mesh

    scene, cam, cfg = _grid(12)
    assert scene.mesh_mat_slot and scene.mat_slot_rep
    assert len(set(scene.mesh_mat_slot)) == len(scene.mat_slot_rep)
    assert len(scene.mat_slot_rep) < scene.num_meshes  # dedup happened

    mats = pack_materials(scene)
    idx = jnp.arange(scene.num_meshes, dtype=jnp.int32)
    via_slots = select_material_soa(
        mats, scene.num_meshes, idx,
        mat_slots=(scene.mesh_mat_slot, scene.mat_slot_rep))
    per_mesh = select_material_soa(mats, scene.num_meshes, idx)
    for a, b in zip(via_slots, per_mesh):
        if hasattr(a, "x"):
            for c in ("x", "y", "z"):
                np.testing.assert_array_equal(getattr(a, c), getattr(b, c))
        else:
            np.testing.assert_array_equal(a, b)

    i = scene.num_meshes - 1
    shared = [j for j in range(scene.num_meshes)
              if scene.mesh_mat_slot[j] == scene.mesh_mat_slot[i] and j != i]
    assert shared  # the grid scene cycles materials: i shares its slot
    sc = recolor_mesh(scene, i, (1.0, 0.0, 0.0))
    mats2 = pack_materials(sc)
    _, _, col, *_ = select_material_soa(
        mats2, sc.num_meshes, idx,
        mat_slots=(sc.mesh_mat_slot, sc.mat_slot_rep))
    col = np.stack([np.asarray(col.x), np.asarray(col.y),
                    np.asarray(col.z)], -1)
    np.testing.assert_allclose(col[i], (1.0, 0.0, 0.0))
    orig = np.asarray(scene.mat_color)
    for j in shared:
        np.testing.assert_allclose(col[j], orig[j])
