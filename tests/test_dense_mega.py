"""Dense megakernel (mega_dense=True): the fused Plücker sweep engine.

The data-parallel counterpart of the reference's UseBVH=false
brute-force mode (the per-mesh dense triangle loop, Trace.cl:276-317 +
444-482): each megakernel iteration resolves every live lane's whole
current chain entry with one sweep (render/plucker_fused.py).

The sweep has two forms of one function: the Triton-route Pallas kernel
(tested here in interpret mode) and the plain jnp reference. They must
pick the same winning column; t agrees within f32 summation order.

Contract (same as dense_engine="plucker"): winner ACCEPTANCE is
Plücker-precision — u/v/t within ~1 ulp of the sequential math, so
knife-edge candidates may differ from the exact BVH engine — while the
winner's shading data is recomputed exactly. On real scenes the two
engines produce identical uint8 frames except (rarely) isolated
knife-edge pixels; the sweep itself is tested exactly against
per-triangle Möller-Trumbore below.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpurt.config import RenderConfig
from tpurt.core import v3 as v3lib
from tpurt.render import plucker_fused as pf
from tpurt.scene.presets import default_scene


def _cfg(**kw):
    base = dict(width=32, height=32, rays_per_pixel=2, max_bounces=3,
                tile_size=32, rays_per_batch=256,
                object_path="sphere1.obj")
    base.update(kw)
    return RenderConfig(**base)


def _rays(r, seed=0, dist=200.0, spread=30.0):
    """r rays from around (0, 0, -dist) aimed at random points near the
    origin, as V3 pairs plus their (r, 3) rows."""
    rng = np.random.default_rng(seed)
    lo_r = (np.array([[0, 0, -dist]], np.float32)
            + rng.standard_normal((r, 3)).astype(np.float32) * 5)
    tgt = rng.standard_normal((r, 3)).astype(np.float32) * spread
    ld_r = tgt - lo_r
    ld_r /= np.linalg.norm(ld_r, axis=1, keepdims=True)
    lo = v3lib.from_rows(jnp.asarray(lo_r))
    ld = v3lib.from_rows(jnp.asarray(ld_r))
    return lo, ld, lo_r, ld_r


def _both(lo, ld, entry, table):
    """(kernel, reference) results of one sweep as numpy pairs."""
    feats = pf.ray_features(lo, ld)
    k = pf.sweep_entry_kernel(feats, entry, table, interpret=True)
    r = pf.sweep_entry_reference(feats, entry, table)
    return tuple(map(np.asarray, k)), tuple(map(np.asarray, r))


def _assert_same_winner(k, r, rtol=1e-6):
    (kt, kc), (rt, rc) = k, r
    np.testing.assert_array_equal(kc, rc)
    hit = kc >= 0
    np.testing.assert_array_equal(np.isinf(kt), ~hit)
    np.testing.assert_allclose(kt[hit], rt[hit], rtol=rtol)


def _single_tri_table(tris, normals=None, cull=None, entry=None):
    """Sweep table over hand-made triangles ((T, 3, 3) vertices)."""
    tris = np.asarray(tris, np.float32)
    t = tris.shape[0]
    if normals is None:
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        normals = np.repeat(n[:, None], 3, axis=1)
    normals = np.asarray(normals, np.float32)
    return pf.table_from_soup(
        tris[:, 0], tris[:, 1], tris[:, 2],
        normals[:, 0], normals[:, 1], normals[:, 2],
        ids=list(range(t)), owner=[0] * t,
        entry=entry if entry is not None else [0] * t,
        cull=cull if cull is not None else [1] * t,
    )


def test_dense_table_routing():
    """Every chain entry's triangles land in the table exactly once,
    tagged with the right owner/entry/cull."""
    cfg = _cfg()
    scene, _, _ = default_scene(cfg)
    table = pf.build_dense_table(scene)
    ids = np.asarray(table.ids)
    ent = np.asarray(table.entry)
    own = np.asarray(table.owner)
    live = ids >= 0
    assert table.count == live.sum()
    assert ids.shape[0] % pf.TRI_CHUNK == 0
    for e, members in enumerate(scene.mega_chain_members):
        want = []
        for i in members:
            first, count = scene.mesh_tri_ranges[i]
            want.extend(range(first, first + count))
        got = ids[live & (ent == e)]
        assert sorted(got.tolist()) == sorted(want)
        assert set(own[live & (ent == e)].tolist()) == set(members)
    # padding columns are inert
    assert (ent[~live] == -1).all()


@pytest.mark.parametrize("lanes", [pf.RAY_BLOCK, 200, 3 * pf.RAY_BLOCK])
def test_sweep_kernel_matches_reference(lanes):
    """Kernel (interpret mode) and jnp reference pick the same winner
    column per lane, including lane counts that are not a multiple of
    the kernel's ray block (the wrapper pads them)."""
    scene, _, _ = default_scene(_cfg())
    table = pf.build_dense_table(scene)
    lo, ld, _, _ = _rays(lanes)
    k, r = _both(lo, ld, jnp.zeros((lanes,), jnp.int32), table)
    assert (k[1] >= 0).sum() > lanes // 4, "test rays barely hit the mesh"
    _assert_same_winner(k, r)


def test_sweep_ragged_triangle_count_pads_inert():
    """A triangle count that is not a multiple of the table alignment:
    the pad columns never win, and rays that miss the real triangles
    report (inf, -1)."""
    tris = [[[-10, -10, 0], [10, -10, 0], [0, 10, 0]]] * 3
    table = _single_tri_table(tris)
    assert table.count == 3 and table.entry.shape[0] % pf.TRI_CHUNK == 0
    # Front-facing hit, a ray pointing away, a ray beside the mesh.
    lo = v3lib.from_rows(jnp.asarray(
        [[0, 0, 50], [0, 0, 50], [500, 500, 50]], jnp.float32))
    ld = v3lib.from_rows(jnp.asarray(
        [[0, 0, -1], [0, 0, 1], [0, 0, -1]], jnp.float32))
    k, r = _both(lo, ld, jnp.zeros((3,), jnp.int32), table)
    _assert_same_winner(k, r)
    assert k[1].tolist() == [0, -1, -1]
    np.testing.assert_allclose(k[0][0], 50.0, rtol=1e-6)


def test_sweep_tie_break_lowest_column():
    """Coincident triangles give equal t: the LOWEST column wins (the
    reference's strict-< update in index order, Trace.cl:352-357),
    also when the duplicates straddle in-kernel triangle chunks and
    other chain entries sit in front of them."""
    tri = [[-10, -10, 0], [10, -10, 0], [0, 10, 0]]
    near = [[-10, -10, 5], [10, -10, 5], [0, 10, 5]]
    c = pf.TRI_CHUNK
    tris = [near] * 2 + [tri] * (c + 3)
    entry = [1, 1] + [0] * (c + 3)
    table = _single_tri_table(tris, entry=entry)
    lo = v3lib.from_rows(jnp.asarray([[0, 0, 50]] * 2, jnp.float32))
    ld = v3lib.from_rows(jnp.asarray([[0, 0, -1]] * 2, jnp.float32))
    k, r = _both(lo, ld, jnp.asarray([0, 1], jnp.int32), table)
    _assert_same_winner(k, r)
    assert k[1].tolist() == [2, 0]


def test_sweep_backface_cull_and_orient():
    """cull=1 rejects hits on the back of the face, where 'back' follows
    the authored normals (orient), not the winding; cull=0 accepts both
    sides."""
    tri = [[-10, -10, 0], [10, -10, 0], [0, 10, 0]]  # winding normal +z
    up = [[0, 0, 1]] * 3
    down = [[0, 0, -1]] * 3
    from_below = (jnp.asarray([[0, 0, -50]], jnp.float32),
                  jnp.asarray([[0, 0, 1]], jnp.float32))
    from_above = (jnp.asarray([[0, 0, 50]], jnp.float32),
                  jnp.asarray([[0, 0, -1]], jnp.float32))
    cases = [
        # (normals, cull, ray, expect hit)
        (up, 1, from_above, True),
        (up, 1, from_below, False),
        (down, 1, from_above, False),
        (down, 1, from_below, True),
        (up, 0, from_below, True),
        (down, 0, from_above, True),
    ]
    for normals, cull, (o, d), expect in cases:
        table = _single_tri_table([tri], normals=[normals], cull=[cull])
        k, r = _both(v3lib.from_rows(o), v3lib.from_rows(d),
                     jnp.zeros((1,), jnp.int32), table)
        _assert_same_winner(k, r)
        assert (k[1][0] == 0) == expect, (normals, cull, o)


def test_fused_sweep_matches_exact_mt():
    """The sweep's winner (t, column) against a per-triangle exact MT
    fold in index order — the reference's strict-< dense loop
    semantics (Trace.cl:352-357). t within Plücker precision; the
    winning COLUMN must match exactly."""
    import tpurt.render.intersect as I

    cfg = _cfg()
    scene, _, _ = default_scene(cfg)
    table = pf.build_dense_table(scene)

    r = 128
    lo, ld, lo_r, ld_r = _rays(r)
    t, col = pf.sweep_entry_local(lo, ld, jnp.zeros((r,), jnp.int32), table)
    t, col = np.asarray(t), np.asarray(col)

    ids = np.asarray(table.ids)
    ent = np.asarray(table.entry)
    cull = np.asarray(table.cull)
    best_t = np.full(r, np.inf)
    best_col = np.full(r, -1)
    for c in range(ids.shape[0]):
        if ids[c] < 0 or ent[c] != 0:
            continue
        tri = ids[c]
        tile = lambda a: jnp.broadcast_to(jnp.asarray(a)[tri], (r, 3))
        ok, tt, _n, _back = I._mt_single(
            jnp.asarray(lo_r), jnp.asarray(ld_r),
            tile(scene.tri_pos_a), tile(scene.tri_pos_b),
            tile(scene.tri_pos_c),
            tile(scene.tri_nrm_a), tile(scene.tri_nrm_b),
            tile(scene.tri_nrm_c),
            jnp.full((r,), bool(cull[c])),
        )
        ok, tt = np.asarray(ok), np.asarray(tt)
        win = ok & (tt < best_t)
        best_t[win] = tt[win]
        best_col[win] = c

    assert (col >= 0).sum() > r // 4, "test rays barely hit the scene"
    assert ((col >= 0) == (best_col >= 0)).all()
    both = col >= 0
    assert (col[both] == best_col[both]).all()
    np.testing.assert_allclose(t[both], best_t[both], rtol=3e-5, atol=1e-5)


@pytest.mark.gpu
def test_sweep_kernel_compiled_matches_reference(gpu):
    """The compiled Triton kernel on the card against the reference at
    the teapot's widths (6,144 triangles, 230,400 lanes would take the
    chip smoke's budget; 16,384 lanes here)."""
    import jax

    from tpurt.scene import procedural
    from tpurt.scene.builder import Material, SceneBuilder
    from tpurt.scene.types import MaterialType

    b = SceneBuilder()
    pos, nrm = procedural.torus_knot(segments=96, sides=32, radius=80.0,
                                     tube=22.0)
    mesh = b.add_triangles(pos, nrm)
    mesh.material = Material(type=MaterialType.SOLID)
    b.add_mesh(mesh)
    table = pf.build_dense_table(b.freeze())
    lanes = 16384
    lo, ld, _, _ = _rays(lanes, dist=300.0, spread=60.0)
    feats = pf.ray_features(lo, ld)
    entry = jnp.zeros((lanes,), jnp.int32)
    with jax.default_device(gpu):
        k = jax.jit(pf.sweep_entry_kernel)(feats, entry, table)
        r = jax.jit(pf.sweep_entry_reference)(feats, entry, table)
    kt, kc = map(np.asarray, k)
    rt, rc = map(np.asarray, r)
    assert (kc >= 0).mean() > 0.25
    # Knife-edge winners may differ between the two summation orders.
    assert (kc == rc).mean() > 0.999
    same = (kc == rc) & (kc >= 0)
    np.testing.assert_allclose(kt[same], rt[same], rtol=1e-5)


@pytest.mark.slow
def test_dense_mega_matches_bvh_mega():
    """Full frames: dense engine vs the BVH megakernel on the default
    preset (lit Cornell + transformed sphere). Identical uint8 frames
    up to isolated knife-edge pixels (sweep-precision winner choice).
    Compared TONEMAPPED (the display artifact; render_frame returns
    linear radiance whose mean is ~0.06 on this scene)."""
    from tpurt.render.renderer import render_frame
    from tpurt.render.tonemap import tonemap

    cfg = _cfg(width=48, height=48, rays_per_pixel=4, max_bounces=6,
               rays_per_batch=512)
    scene, cam, _ = default_scene(cfg)
    ref = np.asarray(tonemap(render_frame(scene, cam, cfg)))
    assert ref.mean() > 1.0, "reference frame unexpectedly dark"
    out = np.asarray(tonemap(
        render_frame(scene, cam, cfg.replace(mega_dense=True))
    ))
    diff = np.abs(ref.astype(np.int32) - out.astype(np.int32))
    frac = (diff.sum(-1) > 0).mean()
    assert frac < 0.005, f"{frac:.4f} of pixels differ"
    # A knife-edge flip re-routes that sample's whole PATH (different
    # material chain), so a divergent pixel can differ by up to 255 —
    # bound the count (above) and the image-level drift, not the
    # per-pixel max (same contract as test_plucker's frame test).
    assert abs(ref.mean() - out.mean()) < 0.02 * max(ref.mean(), 1.0)


@pytest.mark.slow
def test_dense_mega_quota_and_staged():
    """The dense engine composes with the quota (pixels_per_lane) and
    staged-compaction machinery: same frame as the plain dense run."""
    from tpurt.render.renderer import render_frame
    from tpurt.render.tonemap import tonemap

    cfg = _cfg(rays_per_batch=128)
    scene, cam, _ = default_scene(cfg)
    ref = np.asarray(tonemap(
        render_frame(scene, cam, cfg.replace(mega_dense=True))
    ))
    quota = np.asarray(tonemap(render_frame(scene, cam, cfg.replace(
        mega_dense=True, pixels_per_lane=2))))
    staged = np.asarray(tonemap(render_frame(scene, cam, cfg.replace(
        mega_dense=True, pixels_per_lane=2, compaction_threshold=64))))
    for out in (quota, staged):
        diff = np.abs(ref.astype(np.int32) - out.astype(np.int32))
        assert (diff.sum(-1) > 0).mean() < 0.01
        assert diff.max() <= 8
