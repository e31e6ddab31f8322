"""Root-expansion (config.MEGA_ROOT_EXPAND) invariants.

The enter-time inline root-node test must be a pure scheduling
transform: bitwise-identical radiance and identical segment counts to
the un-expanded walk (the expansion consumes the SAME decoded bounds
the in-loop quantised decode produces — megakernel._root_tables), while
strictly reducing loop iterations on scenes whose chain entries get
entered at all.
"""

import functools

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # compile-heavy (see pyproject addopts)

import jax
import jax.numpy as jnp

import tpurt.config as tc
from tpurt.config import RenderConfig
from tpurt.core.camera import Camera, make_ray, pixel_uv
from tpurt.render.renderer import _flat_coords
from tpurt.scene import procedural
from tpurt.scene.builder import Material, SceneBuilder
from tpurt.scene.types import MaterialType

W, H, P = 128, 64, 2


def _scene(subdiv=2):
    b = SceneBuilder()
    pos, nrm = procedural.icosphere(subdiv, radius=100.0)
    mesh = b.add_triangles(pos, nrm)
    mesh.material = Material(
        type=MaterialType.SOLID, ior=1.0, color=(1.0, 1.0, 1.0),
        specular_probability=1.0,
    )
    mesh.scale = 0.5
    b.add_cornell_box(mesh)
    b.add_mesh(mesh)
    scene = b.freeze()
    cfg = RenderConfig(width=W, height=H, rays_per_pixel=2, max_bounces=3)
    cam = Camera.create(
        position=cfg.camera_position, pitch=cfg.camera_pitch,
        yaw=cfg.camera_yaw, roll=cfg.camera_roll,
        fov_degrees=cfg.fov_degrees, aspect_ratio=cfg.aspect_ratio,
    )
    return scene, cam, cfg


def _render(scene, cam, cfg):
    batch = (W * H) // P

    @functools.partial(jax.jit, static_argnames=("b",))
    def run(scene, camera, coords, *, b):
        from tpurt.render.megakernel import run_megakernel

        xs, ys, pix = _flat_coords(coords, b, W, H)
        uv = pixel_uv(xs, ys, W, H)
        ro0, rd0 = make_ray(camera, uv)
        return run_megakernel(
            scene, ro0, rd0, pix, coords[1], sample_offset=coords[2],
            camera=camera, width=W, height=H,
            rays_per_pixel=cfg.rays_per_pixel, max_bounces=cfg.max_bounces,
            seed_mode=cfg.seed_mode, invisible_budget=cfg.invisible_budget,
            subpixel_jitter=False, pixels_per_lane=P,
        )

    coords = jnp.asarray([0, 0, 0], jnp.int32)
    mean, segs, iters = run(scene, cam, coords, b=batch)
    return np.asarray(mean), float(segs), int(iters)


def test_root_expand_bitwise_and_fewer_iters(monkeypatch):
    scene, cam, cfg = _scene()
    monkeypatch.setattr(tc, "MEGA_ROOT_EXPAND", False)
    jax.clear_caches()
    m_off, s_off, it_off = _render(scene, cam, cfg)
    monkeypatch.setattr(tc, "MEGA_ROOT_EXPAND", True)
    jax.clear_caches()
    m_on, s_on, it_on = _render(scene, cam, cfg)
    assert s_off == s_on
    assert np.array_equal(m_off, m_on)
    assert it_on < it_off
