"""Closest-hit scene intersection, vectorised over ray lanes.

Reproduces the semantics of CalculateRayCollisionWithTriangle
(src/Trace.cl:434-485): per mesh instance, transform the ray to local
space (WorldToLocalRay, Trace.cl:118-137), find the closest triangle,
reject OneSided backfaces, transform back (LocalToWorldHit,
Trace.cl:139-156) and keep the strictly-closest world hit with earlier
meshes winning ties.

The HOW is data-parallel rather than a port of the reference's
divergent per-thread traversal:

  * **Triangle tests as tensor contractions.** Möller-Trumbore
    (Trace.cl:276-317) is algebraically rewritten so every per-candidate
    quantity is a dot product between a per-ray feature vector
    (direction d, moment w = d x o, origin o) and a per-triangle
    precomputed vector (e2 x e1, pa x e2, pa x e1, geometric normal):

        det   =  d . (e2 x e1)
        u_num =  d . (pa x e2) - w . e2
        v_num =  w . e1        - d . (pa x e1)
        t_num =  o . Ng        - pa . Ng

    This is the Plücker/moment form of MT: a (rays x tris) sweep becomes
    a handful of (R,3)x(3,C) contractions plus elementwise work — no
    (R,C,3) cross-product temporaries, minimal memory traffic. Smooth-
    normal backfacing is likewise resolved from barycentric weights and
    a per-triangle normal Gram table, so per-candidate normals are never
    materialised; the winner's exact normal is recomputed once at the
    end.

  * **Stackless BVH walk.** Instead of a 64-entry per-thread stack
    (Trace.cl:319-397) each ray carries one int32 cursor through a
    depth-first threading (hit -> first child, miss/leaf-done -> skip
    link), with the reference's distance pruning (skip a node whose
    AABB entry distance is not closer than the current best,
    Trace.cl:348-349).

  * **Static-mesh fusion.** Instances with identity transforms (the 7
    Cornell quads) are merged into one world-space brute-force sweep
    with per-triangle cull/one-sided flags, collapsing 7 kernel passes
    into 1.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from tpurt.config import EPSILON
from tpurt.core.vecmath import (
    cross3,
    dot3,
    euler_rotation,
    length3,
    normalize3,
    rotate,
    rotate_t,
)
from tpurt.scene.types import MaterialType, Scene

_F32 = jnp.float32
# Host constant on purpose: a module-level jnp scalar would be a
# device-resident array that gets embedded into every jit as a runtime
# device constant. A numpy scalar folds into the executable at compile
# time.
_INF = np.float32(np.inf)


class Hit(NamedTuple):
    """World-space closest hit per ray (HitInfo, Trace.cl:67-74, with
    the material replaced by the winning mesh index)."""

    valid: jnp.ndarray  # (R,) bool
    dst: jnp.ndarray  # (R,) f32
    point: jnp.ndarray  # (R, 3) f32
    normal: jnp.ndarray  # (R, 3) f32
    backface: jnp.ndarray  # (R,) bool
    mesh_idx: jnp.ndarray  # (R,) i32 (-1 if none)


class _LocalBest(NamedTuple):
    t: jnp.ndarray  # (R,) f32 local-space distance, inf if none
    tri: jnp.ndarray  # (R,) i32 winning triangle, -1 if none


# ---------------------------------------------------------------------------
# Möller–Trumbore
# ---------------------------------------------------------------------------


def _mt_single(ro, rd, pa, pb, pc, na, nb, nc, cull):
    """Exact MT on paired rays/triangles, all (R, 3).

    Returns (ok, t, normal, backface) following Trace.cl:276-317,
    including the smooth-normal backface flip.
    """
    e1 = pb - pa
    e2 = pc - pa
    h = cross3(rd, e2)
    det = dot3(e1, h)
    ok = jnp.abs(det) >= EPSILON
    f = 1.0 / det
    s = ro - pa
    u = f * dot3(s, h)
    ok &= (u >= 0.0) & (u <= 1.0)
    q = cross3(s, e1)
    v = f * dot3(rd, q)
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = f * dot3(e2, q)
    ok &= t > EPSILON
    n = normalize3(
        na * (1.0 - u - v)[..., None] + nb * u[..., None] + nc * v[..., None]
    )
    backface = dot3(rd, n) > EPSILON
    ok &= ~(cull & backface)
    n = jnp.where(backface[..., None], -n, n)
    return ok, t, n, backface


class _TriTable(NamedTuple):
    """Gathered candidate-triangle fields for a sweep chunk.
    All shapes (C, 3) / (C,)."""

    pa: jnp.ndarray
    pb: jnp.ndarray
    pc: jnp.ndarray
    na: jnp.ndarray
    nb: jnp.ndarray
    nc: jnp.ndarray
    cull: jnp.ndarray  # (C,) bool — per-tri backface culling


def _make_tri_table(scene: Scene, idx: jnp.ndarray, cull: jnp.ndarray) -> _TriTable:
    return _TriTable(
        pa=scene.tri_pos_a[idx],
        pb=scene.tri_pos_b[idx],
        pc=scene.tri_pos_c[idx],
        na=scene.tri_nrm_a[idx],
        nb=scene.tri_nrm_b[idx],
        nc=scene.tri_nrm_c[idx],
        cull=jnp.broadcast_to(cull, scene.tri_pos_a[idx].shape[:1]),
    )


def _mt_sweep(
    ro: jnp.ndarray, rd: jnp.ndarray, table: _TriTable, best: _LocalBest,
    tri_base: jnp.ndarray,
) -> _LocalBest:
    """Dense MT sweep of R rays against C candidate triangles; folds the
    per-ray closest candidate into ``best``.

    Uses the exact broadcast form of ``_mt_single`` (ops in the same
    order, shapes (R, C, 3)) so a candidate's acceptance and distance
    are BIT-IDENTICAL to the per-pair test and the scalar oracle — XLA
    fuses the elementwise chain, so the broadcast intermediates stay in
    registers rather than device memory. ``tri_base`` maps candidate
    column j to its global triangle id (scalar offset or (C,) index
    array).
    """
    ok, t, _, _ = _mt_single(
        ro[:, None, :], rd[:, None, :],
        table.pa[None], table.pb[None], table.pc[None],
        table.na[None], table.nb[None], table.nc[None],
        table.cull[None, :],
    )

    t = jnp.where(ok, t, _INF)
    # argmin returns the FIRST minimum, matching the reference's
    # strict-< update over triangles in index order (Trace.cl:352-357).
    j = jnp.argmin(t, axis=-1)
    t_best = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
    tri_id = (tri_base + j).astype(jnp.int32) if jnp.ndim(tri_base) == 0 else (
        jnp.asarray(tri_base, jnp.int32)[j]
    )
    closer = t_best < best.t
    return _LocalBest(
        t=jnp.where(closer, t_best, best.t),
        tri=jnp.where(closer, tri_id, best.tri),
    )


# ---------------------------------------------------------------------------
# Brute force over a static triangle range
# ---------------------------------------------------------------------------


def _bruteforce_range(
    scene: Scene, ro, rd, first: int, count: int, cull, chunk: int = 2048,
    dense_engine: str = "exact",
) -> _LocalBest:
    best = _LocalBest(
        t=jnp.full(ro.shape[:-1], _INF, _F32),
        tri=jnp.full(ro.shape[:-1], -1, jnp.int32),
    )
    if dense_engine == "plucker":
        from tpurt.render.plucker import build_plucker_table, plucker_sweep

        idx = jnp.arange(first, first + count)
        table = build_plucker_table(
            scene.tri_pos_a[idx], scene.tri_pos_b[idx], scene.tri_pos_c[idx],
            cull=jnp.broadcast_to(cull, (count,)), tri_id=idx,
            na=scene.tri_nrm_a[idx], nb=scene.tri_nrm_b[idx],
            nc=scene.tri_nrm_c[idx],
        )
        t, tri = plucker_sweep(ro, rd, table, best.t, best.tri)
        return _LocalBest(t=t, tri=tri)
    for start in range(first, first + count, chunk):
        n = min(chunk, first + count - start)
        idx = jnp.arange(start, start + n)
        table = _make_tri_table(scene, idx, cull)
        best = _mt_sweep(ro, rd, table, best, jnp.int32(start))
    return best


def _bruteforce_indices(
    scene: Scene, ro, rd, tri_idx: np.ndarray, cull_flags: jnp.ndarray,
    chunk: int = 2048, dense_engine: str = "exact",
) -> _LocalBest:
    """Brute force over an arbitrary static triangle index list with
    per-triangle (traced) cull flags — the fused static-mesh pass."""
    best = _LocalBest(
        t=jnp.full(ro.shape[:-1], _INF, _F32),
        tri=jnp.full(ro.shape[:-1], -1, jnp.int32),
    )
    if dense_engine == "plucker":
        from tpurt.render.plucker import build_plucker_table, plucker_sweep

        ids = jnp.asarray(tri_idx)
        table = build_plucker_table(
            scene.tri_pos_a[ids], scene.tri_pos_b[ids], scene.tri_pos_c[ids],
            cull=cull_flags, tri_id=ids,
            na=scene.tri_nrm_a[ids], nb=scene.tri_nrm_b[ids],
            nc=scene.tri_nrm_c[ids],
        )
        t, tri = plucker_sweep(ro, rd, table, best.t, best.tri)
        return _LocalBest(t=t, tri=tri)
    for start in range(0, len(tri_idx), chunk):
        ids = jnp.asarray(tri_idx[start : start + chunk])
        cull = cull_flags[start : start + chunk]
        table = _make_tri_table(scene, ids, cull)
        best = _mt_sweep(ro, rd, table, best, ids)
    return best


# ---------------------------------------------------------------------------
# Threaded BVH traversal
# ---------------------------------------------------------------------------


def _aabb(ro, invd, bmin, bmax):
    """Slab test (RayBoundingBox, Trace.cl:259-274): hit iff
    tmax >= max(tmin, 0); also returns tmin as the entry distance.

    NaN-robust-conservative: a ray lying exactly in the plane of a box
    face yields 0 * inf = NaN slab distances; the reference inherits
    whatever its GPU's fast-math does (a silent miss on most). Here NaNs
    widen to (-inf, +inf) so such rays TOUCH the box — an AABB is a
    pruning structure and must never reject a hit the exact triangle
    test would accept (keeps every engine and the brute-force oracle in
    exact agreement)."""
    t0 = (bmin - ro) * invd
    t1 = (bmax - ro) * invd
    tsm = jnp.minimum(t0, t1)
    tbg = jnp.maximum(t0, t1)
    tsm = jnp.where(jnp.isnan(tsm), -jnp.inf, tsm)
    tbg = jnp.where(jnp.isnan(tbg), jnp.inf, tbg)
    tmin = jnp.max(tsm, axis=-1)
    tmax = jnp.min(tbg, axis=-1)
    return tmax >= jnp.maximum(tmin, 0.0), tmin


def _bvh_traverse(
    scene: Scene, root: jnp.ndarray, ro, rd, cull, max_leaf: int,
    qmin, qscale, t_limit=None,
) -> _LocalBest:
    """Stackless threaded walk; one int32 cursor per ray lane.

    The walk's cost is gathered ELEMENTS per lane per step, so it is
    phase-split:

      * descent steps fetch one 5-float quantised node row (uint16
        bounds on the per-mesh grid; decoded boxes are conservative,
        never clipping a true hit);
      * leaf processing (the 18-float exact triangle rows + MT) happens
        only once per landed leaf, outside the descent loop — lanes park
        on their leaf until every lane has either parked or finished,
        then all leaves are drained together.

    ``t_limit`` (local-space distance, optional) pre-seeds the pruning
    bound with the closest hit found on earlier meshes: a candidate
    beyond it can never win globally, so subtrees behind already-found
    geometry are skipped (the reference starts each mesh at INFINITY,
    Trace.cl:322-323; pruning harder is result-invariant because the
    final winner comparison is exact).
    """
    invd = 1.0 / rd
    r = ro.shape[0]
    cur = jnp.broadcast_to(jnp.asarray(root, jnp.int32), (r,))
    t0 = jnp.full((r,), _INF, _F32) if t_limit is None else t_limit
    best = _LocalBest(t=t0, tri=jnp.full((r,), -1, jnp.int32))

    zeros_i = jnp.zeros((r,), jnp.int32)
    state0 = (
        cur,
        jnp.zeros((r,), bool),  # parked on a leaf
        zeros_i,  # leaf first tri
        zeros_i,  # leaf tri count
        zeros_i - 1,  # leaf miss link
        best,
    )

    def outer_cond(s):
        return jnp.any(s[0] >= 0)

    def descend_cond(s):
        cur, parked = s[0], s[1]
        return jnp.any((cur >= 0) & ~parked)

    def descend_body(s):
        cur, parked, lf, ln, lm, best = s
        walking = (cur >= 0) & ~parked
        idx = jnp.where(walking, cur, 0)
        row = scene.node_q[idx]  # (R, 5) — the one descent gather
        u0 = lax.bitcast_convert_type(row[:, 0], jnp.uint32)
        u1 = lax.bitcast_convert_type(row[:, 1], jnp.uint32)
        u2 = lax.bitcast_convert_type(row[:, 2], jnp.uint32)
        lo16 = jnp.uint32(0xFFFF)
        q_lo = jnp.stack(
            [u0 & lo16, u0 >> 16, u1 & lo16], axis=-1
        ).astype(_F32)
        q_hi = jnp.stack(
            [u1 >> 16, u2 & lo16, u2 >> 16], axis=-1
        ).astype(_F32)
        bmin = qmin + q_lo * qscale
        bmax = qmin + q_hi * qscale
        w6 = lax.bitcast_convert_type(row[:, 3], jnp.int32)
        w7 = lax.bitcast_convert_type(row[:, 4], jnp.uint32)
        miss = (w7 & jnp.uint32(0xFFFFFF)).astype(jnp.int32) - 1
        ntris = (w7 >> jnp.uint32(24)).astype(jnp.int32)

        box_hit, tmin = _aabb(ro, invd, bmin, bmax)
        # Distance pruning mirrors Trace.cl:348-349.
        enter = walking & box_hit & (tmin < best.t)
        is_leaf = ntris > 0
        land = enter & is_leaf

        parked = parked | land
        lf = jnp.where(land, w6, lf)
        ln = jnp.where(land, ntris, ln)
        lm = jnp.where(land, miss, lm)
        nxt = jnp.where(enter & ~is_leaf, w6, miss)
        cur = jnp.where(walking & ~land, nxt, cur)
        return cur, parked, lf, ln, lm, best

    def outer_body(s):
        s = lax.while_loop(descend_cond, descend_body, s)
        cur, parked, lf, ln, lm, best = s
        on = (cur >= 0) & parked
        t_acc, tri_acc = best.t, best.tri
        for i in range(max_leaf):
            live = on & (i < ln)
            tri = jnp.where(live, lf + i, 0)
            trow = scene.tri_packed[tri]  # (R, 18) exact
            ok, t, _, _ = _mt_single(
                ro, rd,
                trow[:, 0:3], trow[:, 3:6], trow[:, 6:9],
                trow[:, 9:12], trow[:, 12:15], trow[:, 15:18],
                cull,
            )
            win = live & ok & (t < t_acc)
            t_acc = jnp.where(win, t, t_acc)
            tri_acc = jnp.where(win, tri, tri_acc)
        cur = jnp.where(on, lm, cur)
        parked = parked & ~on
        return cur, parked, lf, ln, lm, _LocalBest(t=t_acc, tri=tri_acc)

    final = lax.while_loop(outer_cond, outer_body, state0)
    return final[5]


# ---------------------------------------------------------------------------
# Full scene
# ---------------------------------------------------------------------------


def _mesh_cull(scene: Scene, i) -> jnp.ndarray:
    """Backface-cull policy: cull unless Glassy/Invisible/OneSided
    (Trace.cl:460-462)."""
    mt = scene.mat_type[i]
    return (
        (mt != int(MaterialType.GLASSY))
        & (mt != int(MaterialType.INVISIBLE))
        & (mt != int(MaterialType.ONE_SIDED))
    )


def intersect_scene(
    scene: Scene,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    bruteforce_threshold: int = 4096,
    dense_engine: str = "exact",
) -> Hit:
    """Closest hit of world rays (R, 3) against every mesh instance."""
    r = ro.shape[0]
    best = Hit(
        valid=jnp.zeros((r,), bool),
        dst=jnp.full((r,), _INF, _F32),
        point=jnp.zeros((r, 3), _F32),
        normal=jnp.zeros((r, 3), _F32),
        backface=jnp.zeros((r,), bool),
        mesh_idx=jnp.full((r,), -1, jnp.int32),
    )

    # Partition instances: fused identity-transform brute-force group vs
    # individually transformed meshes. Static decision per mesh.
    # OneSided meshes must keep per-mesh closest-hit semantics (their
    # backface rejection happens after the mesh's own query,
    # Trace.cl:466-471, and must not shadow other meshes' hits), so they
    # always take the separate path.
    fused, separate = [], []
    for i, (first, count) in enumerate(scene.mesh_tri_ranges):
        if (
            scene.mesh_identity[i]
            and count <= bruteforce_threshold
            and scene.mesh_mat_types[i] != int(MaterialType.ONE_SIDED)
        ):
            fused.append(i)
        else:
            separate.append(i)

    if fused:
        tri_idx = np.concatenate(
            [
                np.arange(
                    scene.mesh_tri_ranges[i][0],
                    scene.mesh_tri_ranges[i][0] + scene.mesh_tri_ranges[i][1],
                )
                for i in fused
            ]
        )
        owner = np.concatenate(
            [np.full(scene.mesh_tri_ranges[i][1], i, np.int32) for i in fused]
        )
        if len(tri_idx):
            best = _fused_identity_pass(
                scene, ro, rd, tri_idx, owner, best, dense_engine
            )

    for i in separate:
        best = _transformed_mesh_pass(
            scene, ro, rd, i, bruteforce_threshold, best, dense_engine
        )

    return best


def _finalize_local(scene, lo, ld, lb: _LocalBest, cull):
    """Recompute the winner's exact normal/backface via one paired MT."""
    tri = jnp.maximum(lb.tri, 0)
    ok, t, n, backface = _mt_single(
        lo, ld,
        scene.tri_pos_a[tri], scene.tri_pos_b[tri], scene.tri_pos_c[tri],
        scene.tri_nrm_a[tri], scene.tri_nrm_b[tri], scene.tri_nrm_c[tri],
        cull,
    )
    valid = (lb.tri >= 0) & ok
    point = lo + ld * lb.t[..., None]
    return valid, point, n, backface


def _fused_identity_pass(
    scene, ro, rd, tri_idx, owner, best: Hit, dense_engine: str = "exact"
) -> Hit:
    # Per-triangle cull flag from the owning mesh's material.
    owner_j = jnp.asarray(owner)
    cull_flags_all = jax.vmap(lambda i: _mesh_cull(scene, i))(owner_j)
    # WorldToLocalRay with identity transform still renormalises the
    # direction (Trace.cl:130); replicate so distances match exactly.
    ld = normalize3(rd)
    lb = _bruteforce_indices(
        scene, ro, ld, tri_idx, cull_flags_all, dense_engine=dense_engine
    )

    # The fused sweep applied per-tri culling already; recompute the
    # winner's data with its own cull flag.
    win_owner = jnp.where(lb.tri >= 0, owner_j[_searchsorted_map(tri_idx, lb.tri)], 0)
    win_cull = jax.vmap(lambda i: _mesh_cull(scene, i))(win_owner)
    valid, point, n, backface = _finalize_local(scene, ro, ld, lb, win_cull)

    # OneSided backface rejection (Trace.cl:468-471).
    one_sided = scene.mat_type[win_owner] == int(MaterialType.ONE_SIDED)
    valid &= ~(one_sided & backface)

    # LocalToWorldHit with identity transform: world dst recomputed from
    # the hit point (Trace.cl:153).
    n_world = normalize3(n)
    dst = length3(point - ro)
    closer = valid & (dst < best.dst)
    return Hit(
        valid=best.valid | closer,
        dst=jnp.where(closer, dst, best.dst),
        point=jnp.where(closer[..., None], point, best.point),
        normal=jnp.where(closer[..., None], n_world, best.normal),
        backface=jnp.where(closer, backface, best.backface),
        mesh_idx=jnp.where(closer, win_owner.astype(jnp.int32), best.mesh_idx),
    )


def _searchsorted_map(tri_idx: np.ndarray, tri: jnp.ndarray) -> jnp.ndarray:
    """Map a winning global triangle id back to its row in the fused
    index list (tri_idx is static & sorted per construction)."""
    order = np.argsort(tri_idx, kind="stable")
    sorted_idx = tri_idx[order]
    pos = jnp.searchsorted(jnp.asarray(sorted_idx), jnp.maximum(tri, 0))
    pos = jnp.clip(pos, 0, len(tri_idx) - 1)
    return jnp.asarray(order)[pos]


def _transformed_mesh_pass(
    scene, ro, rd, i: int, bruteforce_threshold: int, best: Hit,
    dense_engine: str = "exact",
) -> Hit:
    first, count = scene.mesh_tri_ranges[i]
    pos = scene.mesh_pos[i]
    scale = scene.mesh_scale[i]
    rot = euler_rotation(scene.mesh_pitch[i], scene.mesh_yaw[i], scene.mesh_roll[i])
    cull = _mesh_cull(scene, i)

    # WorldToLocalRay (Trace.cl:118-137): rotate by R^T, translate,
    # divide by uniform scale (guarded), renormalise.
    safe = jnp.where(jnp.abs(scale) > EPSILON, scale, _F32(1.0))
    lo = rotate_t(rot, ro - pos) / safe
    ld = normalize3(rotate_t(rot, rd) / safe)

    if count <= bruteforce_threshold:
        lb = _bruteforce_range(
            scene, lo, ld, first, count, cull, dense_engine=dense_engine
        )
    else:
        # Seed pruning with the best hit from earlier meshes, converted
        # to local distance (world ~= scale * local) with a relative
        # safety margin so float rounding can never prune a candidate
        # that would win the exact world-space comparison below.
        t_limit = best.dst / safe * _F32(1.001)
        lb = _bvh_traverse(
            scene, scene.mesh_root[i], lo, ld, cull, scene.max_leaf_tris,
            qmin=scene.mesh_qmin[i], qscale=scene.mesh_qscale[i],
            t_limit=t_limit,
        )

    valid, point_l, n_l, backface = _finalize_local(scene, lo, ld, lb, cull)

    # Degenerate-mesh skip (Trace.cl:448-449).
    valid &= scale > EPSILON
    # OneSided backface rejection (Trace.cl:468-471).
    one_sided = scene.mat_type[i] == int(MaterialType.ONE_SIDED)
    valid &= ~(one_sided & backface)

    # LocalToWorldHit (Trace.cl:139-156).
    point_w = rotate(rot, point_l * scale) + pos
    n_w = normalize3(rotate(rot, n_l))
    dst = length3(point_w - ro)

    closer = valid & (dst < best.dst)
    return Hit(
        valid=best.valid | closer,
        dst=jnp.where(closer, dst, best.dst),
        point=jnp.where(closer[..., None], point_w, best.point),
        normal=jnp.where(closer[..., None], n_w, best.normal),
        backface=jnp.where(closer, backface, best.backface),
        mesh_idx=jnp.where(closer, jnp.int32(i), best.mesh_idx),
    )
