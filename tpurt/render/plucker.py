"""Plücker-form dense Möller-Trumbore as a matrix product.

The fast dense-sweep engine (counterpart of the reference's
all-triangles case inside RayTriangleBVH leaves and of small-scene
rendering, src/Trace.cl:276-317 + 351-358): Möller-Trumbore is
algebraically refactored so that all four per-candidate decision
quantities are LINEAR in a 10-component per-ray feature vector

    F = [ d, w, o, 1 ]          with  w = d x o  (the Plücker moment)

against per-triangle constant columns:

    det   = d . (e2 x e1)
    u_num = d . (pa x e2) - w . e2
    v_num = w . e1        - d . (pa x e1)
    t_num = o . Ng - pa . Ng          (Ng = e1 x e2)

so an (R rays x T tris) sweep becomes ONE (R,16)x(16,4T) matrix
product; the (R,4T) epilogue (accept tests + running min) is
elementwise.

Precision: the product runs at precision='highest' (f32, never a
reduced-precision matrix unit); u/v/t come out within ~1 ulp of the
sequential form but are
NOT bit-identical (different summation order), so this is the FAST
dense engine (RenderConfig.dense_engine='plucker'), not the parity
anchor. Acceptance knife-edges (1-ulp u/v/t boundaries) and the
backface-cull test differ from the exact path: culling here uses the
GEOMETRIC orientation (sign of det) rather than the interpolated
smooth normal the reference tests (Trace.cl:304-311) — they disagree
only where a silhouette's smooth normal flips against the face normal.
The WINNER's shading data (normal/backface) is recomputed exactly by
the caller (intersect._finalize_local), as in the exact path.

The feature vector is padded 10 -> 16 columns; the pad columns are
zero.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp
from jax import lax

from tpurt.config import EPSILON

_F32 = jnp.float32
_INF = np.float32(np.inf)

#: Ray feature / triangle coefficient count (10 used + 6 zero pad).
K_FEATURES = 16
#: Ray rows per GEMM block (bounds the (RB, 4*TC) epilogue temporary).
_RAY_BLOCK = 8192
#: Triangle columns per GEMM block.
_TRI_CHUNK = 4096


class PluckerTable(NamedTuple):
    """Per-triangle GEMM coefficients, laid out component-major:
    w[:, 0:T] -> det, w[:, T:2T] -> u_num, w[:, 2T:3T] -> v_num,
    w[:, 3T:4T] -> t_num, so each component slices out as (R, T)."""

    coeffs: jnp.ndarray  # (K_FEATURES, 4*Tpad) f32
    cull: jnp.ndarray  # (Tpad,) bool — backface-cull policy per tri
    orient: jnp.ndarray  # (Tpad,) f32 ±1 — authored-normal vs winding sign
    tri_id: jnp.ndarray  # (Tpad,) i32 — global triangle id (-1 = pad)
    count: int  # real triangle count


def component_rows(pa, e1, e2, ng):
    """The four per-triangle coefficient blocks, each (10, T) f32, in
    the feature basis [d, w=d x o, o, 1] (rows 0:3 d, 3:6 w, 6:9 o,
    9 const). Shared by the chunked XLA sweep (PluckerTable) and the
    fused dense sweep (render/plucker_fused.py)."""
    t = pa.shape[0]

    def col3(x):  # (T,3) -> (3, T)
        return jnp.transpose(x)

    det_c = jnp.concatenate(
        [col3(jnp.cross(e2, e1)), jnp.zeros((7, t), _F32)], axis=0
    )  # d-coeff rows 0:3
    u_c = jnp.concatenate(
        [col3(jnp.cross(pa, e2)), col3(-e2), jnp.zeros((4, t), _F32)], axis=0
    )  # d rows 0:3, w rows 3:6
    v_c = jnp.concatenate(
        [col3(-jnp.cross(pa, e1)), col3(e1), jnp.zeros((4, t), _F32)], axis=0
    )
    t_c = jnp.concatenate(
        [jnp.zeros((6, t), _F32), col3(ng),
         -jnp.sum(pa * ng, axis=-1)[None, :]],
        axis=0,
    )  # o rows 6:9, const row 9
    return det_c, u_c, v_c, t_c


def build_plucker_table(pa, pb, pc, cull, tri_id, na=None, nb=None, nc=None) -> PluckerTable:
    """Precompute the coefficient matrix for a triangle set (traced or
    numpy inputs, all (T, 3) / (T,)).

    ``na/nb/nc`` (optional authored vertex normals) fix the orientation
    of the backface test: the reference classifies backfaces against the
    INTERPOLATED vertex normal (Trace.cl:304-311), which may oppose the
    winding's geometric normal (e.g. addQuad authors normals
    independently of vertex order, readobj.hpp:378-408). The per-tri
    sign of dot(na+nb+nc, Ng) reconciles the two; without normals the
    winding orientation is used."""
    t = pa.shape[0]
    tpad = max(-(-t // 128) * 128, 128)

    e1 = pb - pa
    e2 = pc - pa
    ng = jnp.cross(e1, e2)
    if na is not None:
        osign = jnp.sum((na + nb + nc) * ng, axis=-1)
        orient = jnp.where(osign < 0.0, -1.0, 1.0).astype(_F32)
    else:
        orient = jnp.ones((t,), _F32)

    det_c, u_c, v_c, t_c = component_rows(pa, e1, e2, ng)

    def pad_cols(m):
        return jnp.pad(m, ((0, K_FEATURES - 10), (0, tpad - t)))

    coeffs = jnp.concatenate(
        [pad_cols(det_c), pad_cols(u_c), pad_cols(v_c), pad_cols(t_c)], axis=1
    )
    cull_p = jnp.pad(jnp.asarray(cull, bool), (0, tpad - t))
    orient_p = jnp.pad(orient, (0, tpad - t), constant_values=1.0)
    ids = jnp.pad(
        jnp.asarray(tri_id, jnp.int32), (0, tpad - t), constant_values=-1
    )
    return PluckerTable(
        coeffs=coeffs, cull=cull_p, orient=orient_p, tri_id=ids, count=int(t)
    )


def ray_features(ro: jnp.ndarray, rd: jnp.ndarray) -> jnp.ndarray:
    """(R, K_FEATURES) f32: [d, d x o, o, 1, 0-pad]."""
    w = jnp.cross(rd, ro)
    ones = jnp.ones(ro.shape[:-1] + (1,), _F32)
    pad = jnp.zeros(ro.shape[:-1] + (K_FEATURES - 10,), _F32)
    return jnp.concatenate([rd, w, ro, ones, pad], axis=-1)


def plucker_sweep(ro, rd, table: PluckerTable, t_best, tri_best):
    """Closest accepted hit of R rays against the table's triangles,
    folded into the running (t_best (R,), tri_best (R,) i32).

    Tie/order semantics: within the sweep the LOWEST padded column index
    wins among equal-t candidates, matching the reference's strict-<
    update in index order (Trace.cl:352-357) as long as tri_id is
    sorted ascending (true for contiguous ranges)."""
    r = ro.shape[0]
    tpad = table.cull.shape[0]
    feats = ray_features(ro, rd)

    for r0 in range(0, r, _RAY_BLOCK):
        rb = min(_RAY_BLOCK, r - r0)
        f_blk = lax.dynamic_slice(feats, (r0, 0), (rb, K_FEATURES))
        tb_blk = lax.dynamic_slice(t_best, (r0,), (rb,))
        ib_blk = lax.dynamic_slice(tri_best, (r0,), (rb,))

        for c0 in range(0, tpad, _TRI_CHUNK):
            tc = min(_TRI_CHUNK, tpad - c0)
            # component-major: gather this chunk's 4 column groups
            cols = jnp.concatenate(
                [
                    lax.dynamic_slice(
                        table.coeffs, (0, comp * tpad + c0), (K_FEATURES, tc)
                    )
                    for comp in range(4)
                ],
                axis=1,
            )
            out = jnp.dot(f_blk, cols, precision="highest")  # (rb, 4*tc)
            det = out[:, 0 * tc : 1 * tc]
            u_num = out[:, 1 * tc : 2 * tc]
            v_num = out[:, 2 * tc : 3 * tc]
            t_num = out[:, 3 * tc : 4 * tc]

            f = 1.0 / det
            u = f * u_num
            v = f * v_num
            t = f * t_num
            ok = jnp.abs(det) >= EPSILON
            ok &= (u >= 0.0) & (u <= 1.0)
            ok &= (v >= 0.0) & (u + v <= 1.0)
            ok &= t > EPSILON
            # Geometric backface: det = d.(e2 x e1) = -d.Ng, and a ray
            # hits the back of the face when d.(orient*Ng) > 0, i.e.
            # orient*det < 0 (orient reconciles authored normals with
            # the winding, see build_plucker_table).
            orient = lax.dynamic_slice(table.orient, (c0,), (tc,))
            backface_geo = det * orient[None, :] < 0.0
            cull = lax.dynamic_slice(table.cull, (c0,), (tc,))
            ok &= ~(cull[None, :] & backface_geo)
            ids = lax.dynamic_slice(table.tri_id, (c0,), (tc,))
            ok &= ids[None, :] >= 0

            t = jnp.where(ok, t, _INF)
            j = jnp.argmin(t, axis=-1)  # first minimum
            t_min = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
            id_min = ids[j]
            closer = t_min < tb_blk
            tb_blk = jnp.where(closer, t_min, tb_blk)
            ib_blk = jnp.where(closer, id_min, ib_blk)

        t_best = lax.dynamic_update_slice(t_best, tb_blk, (r0,))
        tri_best = lax.dynamic_update_slice(tri_best, ib_blk, (r0,))

    return t_best, tri_best
