"""Select-chain cliff guard.

Parameter fetches (chain transforms, materials, static roots) are
unrolled broadcast-select chains below SELECT_GATHER_THRESHOLD
instances — the measured-fast form at the reference's K=8 scale — and
real gathers above it, because the select form grows the loop body
O(K) per call site and becomes uncompilable around K~100. The gather
path must agree bitwise with the select transcription, and a
64-instance scene must build, compile, and render in test time.

The reference's own mesh loop is O(K) per ray at runtime
(src/Trace.cl:444-482); the chain walk here is O(E) iterations per
segment too, but with O(1) code size in the gather regime.
"""

import dataclasses

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # compile-heavy (see pyproject addopts)

import tpurt.config as config_mod
from tpurt.config import RenderConfig
from tpurt.core.camera import Camera
from tpurt.render.renderer import render_frame
from tpurt.scene import procedural
from tpurt.scene.builder import Material, SceneBuilder
from tpurt.scene.types import MaterialType


def _grid_scene(k: int):
    """k icosphere instances (shared geometry) on a grid in a Cornell
    box, cycling through material types."""
    b = SceneBuilder()
    pos, nrm = procedural.icosphere(0, radius=10.0)
    proto = b.add_triangles(pos, nrm)
    proto.material = Material(type=MaterialType.SOLID, color=(1.0, 1.0, 1.0))
    proto.scale = 0.5
    b.add_cornell_box(proto)  # 7 meshes
    side = int(np.ceil(np.sqrt(k)))
    mats = [
        Material(type=MaterialType.SOLID, color=(0.9, 0.4, 0.3)),
        Material(type=MaterialType.SOLID, color=(0.3, 0.9, 0.4),
                 reflectiveness=0.8, specular_probability=0.5),
        Material(type=MaterialType.CHECKER, color=(0.9, 0.9, 0.9),
                 emission_color=(0.1, 0.1, 0.6), emission_strength=25.0),
        Material(type=MaterialType.GLASSY, ior=1.5, color=(1.0, 1.0, 1.0)),
        Material(type=MaterialType.SOLID, color=(0.9, 0.9, 0.2),
                 emission_color=(1.0, 0.9, 0.7), emission_strength=2.0),
    ]
    for i in range(k):
        h = dataclasses.replace(
            proto,
            pos=(
                -120.0 + 240.0 * (i % side) / max(side - 1, 1),
                30.0 + 200.0 * (i // side) / max(side - 1, 1),
                -40.0 + 10.0 * (i % 3),
            ),
            yaw=0.3 * i,
            scale=0.4 + 0.02 * (i % 5),
            material=mats[i % len(mats)],
        )
        b.add_mesh(h)
    scene = b.freeze()
    cfg = RenderConfig(
        width=32, height=24, rays_per_pixel=2, max_bounces=3, tile_size=32,
        seed_mode="reference", rays_per_batch=512, compaction_threshold=0,
    )
    cam = Camera.create(
        position=cfg.camera_position, pitch=cfg.camera_pitch,
        yaw=cfg.camera_yaw, roll=cfg.camera_roll,
        fov_degrees=cfg.fov_degrees, aspect_ratio=cfg.aspect_ratio,
    )
    return scene, cam, cfg


def test_gather_path_bitwise_matches_selects(monkeypatch):
    """Just above the threshold, the gathered parameter fetches must be
    bit-identical to the unrolled select chains (same math, different
    fetch mechanism)."""
    scene, cam, cfg = _grid_scene(24)  # 31 meshes total > threshold 24
    gathered = render_frame(scene, cam, cfg)
    monkeypatch.setattr(config_mod, "SELECT_GATHER_THRESHOLD", 256)
    # Different batch size -> different jit cache entry (the threshold
    # is not a static argument), same pixels: the flat decomposition is
    # bitwise-invariant by design.
    selected = render_frame(scene, cam, cfg.replace(rays_per_batch=768))
    np.testing.assert_array_equal(gathered, selected)


def test_64_instances_render():
    """The cliff itself: 64 instances (+ 7 Cornell meshes) must freeze,
    compile, and produce a finite, lit image — this hangs or blows the
    trace in the unrolled-select regime."""
    scene, cam, cfg = _grid_scene(64)
    assert scene.num_meshes == 71
    out = render_frame(scene, cam, cfg)
    assert out.shape == (cfg.height, cfg.width, 3)
    assert np.isfinite(out).all()
    assert out.max() > 0.0
