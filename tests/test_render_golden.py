"""Golden renders: the framework must match the independent scalar
oracle BITWISE on CPU in seed_mode='reference' (the oracle transcribes
src/Trace.cl literally; see tests/oracle.py).

Cross-IMPLEMENTATION comparisons (engine vs oracle, engine vs engine)
allow a tiny fraction of knife-edge pixels: rays meeting triangle edges
or box faces exactly sit on accept/reject boundaries where numpy's and
XLA's float summation orders legitimately disagree by 1 ulp, and a
single flipped bounce diverges that pixel's whole path (~3e-4 flip rate
per intersection, verified first-hit-identical). Same-implementation
properties (tile decomposition, sharding) remain strictly bitwise."""

import numpy as np
import pytest


def assert_mostly_bitwise(a, b, max_flip_fraction=0.005):
    """All-but-knife-edge bitwise equality (see module docstring)."""
    a, b = np.asarray(a), np.asarray(b)
    flipped = (a != b).any(axis=-1)
    frac = flipped.mean()
    assert frac <= max_flip_fraction, (
        f"{flipped.sum()} pixels differ ({frac:.2%}); "
        "beyond knife-edge tolerance"
    )
    assert np.isfinite(a).all() and np.isfinite(b).all()

import oracle
from tpurt.config import RenderConfig
from tpurt.core.camera import Camera
from tpurt.render.renderer import render_frame, render_image
from tpurt.scene import procedural
from tpurt.scene.builder import Material, SceneBuilder
from tpurt.scene.presets import cornell_sphere_scene
from tpurt.scene.types import MaterialType


@pytest.mark.parametrize(
    "engine",
    # Both engines run in the DEFAULT suite: with the all-materials and
    # engines-agree goldens below, these are the fast gate's checks of
    # the flagship mega engine against the oracle.
    ["modular", "mega"],
)
def test_cornell_sphere_bitwise(engine):
    cfg = RenderConfig(
        width=16, height=16, rays_per_pixel=2, max_bounces=3, tile_size=16,
        object_path="sphere0.obj", engine=engine,
    )
    scene, cam, _ = cornell_sphere_scene(0, cfg)
    mine = render_frame(scene, cam, cfg)
    ref, ref_px = oracle.render(scene, cam, 16, 16, 2, 3)
    assert_mostly_bitwise(mine, ref, max_flip_fraction=0.0)
    # And the quantised pixels too (tonemap parity).
    from tpurt.render.tonemap import tonemap
    import jax.numpy as jnp

    np.testing.assert_array_equal(np.asarray(tonemap(jnp.asarray(mine))), ref_px)


def _all_materials_scene():
    b = SceneBuilder()
    pos, nrm = procedural.icosphere(1, radius=40.0)
    glass = b.add_triangles(pos, nrm)
    glass.material = Material(type=MaterialType.GLASSY, ior=1.5, color=(0.9, 0.9, 1.0))
    glass.pos = (0.0, 40.0, 0.0)
    b.add_mesh(glass)
    fl = b.add_quad((-200, 0, -200), (200, 0, -200), (200, 0, 200), (-200, 0, 200),
                    (0, 1, 0), (0.8, 0.8, 0.8))
    fl.material = Material(
        type=MaterialType.CHECKER, color=(0.9, 0.9, 0.9),
        emission_color=(0.2, 0.2, 0.2), emission_strength=50.0,
        specular_probability=0.3, reflectiveness=0.5,
    )
    inv = b.add_quad((-50, 0, 80), (50, 0, 80), (50, 100, 80), (-50, 100, 80),
                     (0, 0, -1), (1, 0, 0))
    inv.material = Material(type=MaterialType.INVISIBLE, color=(1, 0, 0))
    osw = b.add_quad((-200, 0, -100), (200, 0, -100), (200, 200, -100),
                     (-200, 200, -100), (0, 0, 1), (0.5, 0.9, 0.5))
    osw.material = Material(type=MaterialType.ONE_SIDED, color=(0.5, 0.9, 0.5))
    bp, bn = procedural.box((30, 30, 30))
    bx = b.add_triangles(bp, bn)
    bx.material = Material(type=MaterialType.SOLID, color=(0.9, 0.6, 0.3),
                           specular_probability=0.5, reflectiveness=0.8)
    bx.pos = (60.0, 15.0, 20.0)
    bx.yaw = 0.7
    bx.pitch = 0.2
    bx.scale = 1.3
    b.add_mesh(bx)
    lt = b.add_quad((-60, 180, -60), (60, 180, -60), (60, 180, 60), (-60, 180, 60),
                    (0, -1, 0), (0, 0, 0))
    lt.material = Material(type=MaterialType.SOLID, color=(1, 1, 1),
                           emission_color=(1, 1, 0.9), emission_strength=10.0,
                           specular_probability=1.0)
    scene = b.freeze()
    cam = Camera.create((0, 80, 220), pitch=-0.15, yaw=3.14159,
                        fov_degrees=70, aspect_ratio=1.0)
    return scene, cam


@pytest.mark.parametrize(
    "engine,bruteforce_threshold",
    [("modular", 4096), ("modular", 10), ("mega", 4096)],
)
def test_all_materials_bitwise(engine, bruteforce_threshold):
    """Every material branch + Russian roulette + transformed instances,
    on all intersection paths (dense sweep, threaded BVH, megakernel)."""
    scene, cam = _all_materials_scene()
    cfg = RenderConfig(
        width=12, height=12, rays_per_pixel=3, max_bounces=8, tile_size=12,
        bruteforce_threshold=bruteforce_threshold, engine=engine,
    )
    mine = render_frame(scene, cam, cfg)
    ref, _ = oracle.render(scene, cam, 12, 12, 3, 8)
    assert_mostly_bitwise(mine, ref)


@pytest.mark.slow
def test_staged_compaction_bitwise():
    """The host-staged megakernel (capped stages + quarter-batch lane
    compaction) must produce the identical image to the single-shot
    megakernel — compaction only reorders which lanes share a batch."""
    cfg = RenderConfig(width=16, height=16, rays_per_pixel=2, max_bounces=3,
                       tile_size=16, object_path="sphere0.obj", engine="mega",
                       compaction_threshold=64)
    scene, cam, _ = cornell_sphere_scene(0, cfg)
    staged = render_frame(scene, cam, cfg)
    single = render_frame(scene, cam, cfg.replace(compaction_threshold=0))
    np.testing.assert_array_equal(staged, single)
    ref, _ = oracle.render(scene, cam, 16, 16, 2, 3)
    assert_mostly_bitwise(staged, ref, max_flip_fraction=0.0)


def test_engines_agree_on_default_scene():
    """Modular vs megakernel on the default Cornell scene at a size
    where knife-edge pixels statistically appear."""
    cfg = RenderConfig(width=48, height=48, rays_per_pixel=2, max_bounces=5,
                       tile_size=48, object_path="sphere1.obj")
    scene, cam, _ = cornell_sphere_scene(1, cfg)
    a = render_frame(scene, cam, cfg.replace(engine="mega"))
    b = render_frame(scene, cam, cfg.replace(engine="modular"))
    assert_mostly_bitwise(a, b)


@pytest.mark.slow
def test_tile_decomposition_bitwise_invariant():
    """Any tile split must give the identical frame — the deliberate fix
    of the reference's per-device seed drift (image.hpp:228,304)."""
    cfg = RenderConfig(width=20, height=12, rays_per_pixel=1, max_bounces=2,
                       tile_size=20, object_path="sphere0.obj")
    scene, cam, _ = cornell_sphere_scene(0, cfg)
    whole = render_frame(scene, cam, cfg)
    for ts in (4, 8, 12):
        split = render_frame(scene, cam, cfg.replace(tile_size=ts))
        np.testing.assert_array_equal(whole, split)


@pytest.mark.slow
def test_decorrelated_mode_close_to_reference_mode():
    """Different estimator, same integral: means should agree loosely."""
    cfg = RenderConfig(width=12, height=12, rays_per_pixel=16, max_bounces=3,
                       tile_size=12, object_path="sphere0.obj")
    scene, cam, _ = cornell_sphere_scene(0, cfg)
    a = render_frame(scene, cam, cfg)
    b = render_frame(scene, cam, cfg.replace(seed_mode="decorrelated"))
    assert abs(float(a.mean()) - float(b.mean())) < 0.05
    assert np.isfinite(b).all()


@pytest.mark.slow
def test_frame_index_changes_image():
    cfg = RenderConfig(width=8, height=8, rays_per_pixel=2, max_bounces=3,
                       tile_size=8, object_path="sphere0.obj")
    scene, cam, _ = cornell_sphere_scene(0, cfg)
    f0 = render_frame(scene, cam, cfg, frame_index=0)
    f1 = render_frame(scene, cam, cfg, frame_index=1)
    assert not np.array_equal(f0, f1)


@pytest.mark.gpu
def test_cornell_sphere_mega_on_gpu(gpu):
    """The megakernel compiled for the card against the oracle, within
    chip_smoke.py's tolerance: XLA compiles the GPU on its own and the
    GPU's transcendentals may round differently, so knife-edge samples
    may diverge."""
    import jax

    cfg = RenderConfig(
        width=16, height=16, rays_per_pixel=2, max_bounces=3, tile_size=16,
        object_path="sphere0.obj", engine="mega",
    )
    with jax.default_device(gpu):
        scene, cam, _ = cornell_sphere_scene(0, cfg)
        mine = render_frame(scene, cam, cfg)
    ref, _ = oracle.render(scene, cam, 16, 16, 2, 3)
    close = np.isclose(mine, ref, rtol=1e-3, atol=1e-4).all(-1)
    assert np.isfinite(mine).all()
    assert close.mean() >= 0.99, close.mean()


def test_render_image_uint8():
    # modular engine: the fast gate avoids the megakernel compile
    cfg = RenderConfig(width=8, height=8, rays_per_pixel=1, max_bounces=2,
                       engine="modular",
                       tile_size=8, object_path="sphere0.obj")
    scene, cam, _ = cornell_sphere_scene(0, cfg)
    img = render_image(scene, cam, cfg)
    assert img.dtype == np.uint8 and img.shape == (8, 8, 3)
