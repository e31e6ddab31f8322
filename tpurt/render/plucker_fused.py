"""Fused Plücker dense sweep: the brute-force megakernel's traversal.

The brute-force counterpart of the reference's UseBVH=false mode (the
per-mesh dense triangle loop, src/Trace.cl:276-317 + 444-482): every
chain entry's triangles are swept densely, with the (R rays x T tris)
Möller-Trumbore refactored into per-ray features x per-triangle
coefficients (see render/plucker.py for the algebra).

Two implementations of one function, ``sweep_entry_local``:

* ``sweep_entry_kernel`` — a Pallas kernel on the Triton route. Each
  program owns a power-of-two block of rays and loops over triangle
  chunks in-kernel, carrying the running (t, column) winner in
  registers, so the (R, 4T) decision planes never reach device memory.
  The ten real features are contracted as explicit f32 multiply-adds
  (only the 19 non-zero coefficient rows are read), so there is no
  reduced-precision matrix unit in the accept tests.
* ``sweep_entry_reference`` — plain jnp/lax: triangle chunks swept by a
  (R, 10) x (10, 4C) product at precision="highest" with the same
  accept tests and fold. XLA materialises each chunk's planes.

Precision: this is the FAST dense form, not the parity anchor — u/v/t
come out within ~1 ulp of the sequential math (different summation
order), so acceptance knife-edges may differ between the two forms and
from the exact engine; the winner's shading data is recomputed exactly
by the caller (megakernel._dense_hit), mirroring
intersect._finalize_local.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpurt.config import EPSILON
from tpurt.scene.types import MaterialType, Scene

_F32 = jnp.float32
_INF = np.float32(np.inf)
_BIG = np.int32(2**30)

#: Triangle columns are padded to a multiple of this (pad: entry -1).
#: Both sweep forms step through the table in chunks that divide it.
_TRI_ALIGN = 512
#: Ray lanes per kernel program (a power of two).
RAY_BLOCK = 64
#: Triangle columns per in-kernel chunk (a power of two).
TRI_CHUNK = 32
#: Triangle columns per chunk of the reference sweep.
_REF_CHUNK = 512

#: Non-zero feature rows of each coefficient block (features are
#: [d, w = d x o, o, 1], plucker.component_rows): det reads d, u and v
#: read d and w, t reads o and the constant.
_ROWS = ((0, 1, 2), (0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5), (6, 7, 8, 9))


class FusedDenseTable(NamedTuple):
    """Per-triangle sweep data over the UNION of all chain entries'
    triangles, column-padded to a _TRI_ALIGN multiple (pad: id -1,
    entry -1, which no lane's entry equals)."""

    coeffs: jnp.ndarray  # (4, 10, Tpad) f32 — det/u/v/t coefficient rows
    ids: jnp.ndarray  # (Tpad,) i32 soup triangle id (-1 = pad)
    owner: jnp.ndarray  # (Tpad,) i32 owner mesh id
    entry: jnp.ndarray  # (Tpad,) i32 owning chain-entry index
    cull: jnp.ndarray  # (Tpad,) f32 0/1 backface-cull policy
    orient: jnp.ndarray  # (Tpad,) f32 ±1 authored-normal orientation
    count: int


def build_dense_table(scene: Scene) -> FusedDenseTable:
    """Assemble the fused sweep table from the scene's triangle soup.

    Pure jnp on traced scene arrays with static slicing — safe to call
    inside a jit; the result is loop-invariant and XLA hoists it out of
    the megakernel while_loop. Per-triangle policy scalars come from the
    freeze-time static mirrors (mesh_mat_types), matching
    megakernel._chain_params row construction."""
    idx_np: list = []
    owner_np: list = []
    entry_np: list = []
    cull_np: list = []
    for e, members in enumerate(scene.mega_chain_members):
        for i in members:
            first, count = scene.mesh_tri_ranges[i]
            idx_np.extend(range(first, first + count))
            owner_np.extend([i] * count)
            entry_np.extend([e] * count)
            mt = scene.mesh_mat_types[i]
            cull_np.extend([
                mt not in (
                    int(MaterialType.GLASSY),
                    int(MaterialType.INVISIBLE),
                    int(MaterialType.ONE_SIDED),
                )
            ] * count)
    assert idx_np, "dense megakernel needs at least one chain triangle"
    idx = jnp.asarray(np.asarray(idx_np, np.int32))
    return table_from_soup(
        scene.tri_pos_a[idx], scene.tri_pos_b[idx], scene.tri_pos_c[idx],
        scene.tri_nrm_a[idx], scene.tri_nrm_b[idx], scene.tri_nrm_c[idx],
        ids=idx_np, owner=owner_np, entry=entry_np, cull=cull_np,
    )


def table_from_soup(pa, pb, pc, na, nb, nc, *, ids, owner, entry, cull):
    """The sweep table of T triangles given as (T, 3) vertex positions
    and authored vertex normals, with per-triangle host lists of soup
    ids, owner meshes, chain entries and 0/1 cull flags. Columns are
    padded to a _TRI_ALIGN multiple with inert triangles (entry -1)."""
    t = len(ids)
    tpad = -(-t // _TRI_ALIGN) * _TRI_ALIGN

    def soup(g):
        return jnp.pad(jnp.asarray(g, _F32), ((0, tpad - t), (0, 0)))

    pa, pb, pc, na, nb, nc = map(soup, (pa, pb, pc, na, nb, nc))
    e1 = pb - pa
    e2 = pc - pa
    ng = jnp.cross(e1, e2)
    osign = jnp.sum((na + nb + nc) * ng, axis=-1)
    orient = jnp.where(osign < 0.0, -1.0, 1.0).astype(_F32)

    from tpurt.render.plucker import component_rows

    coeffs = jnp.stack(component_rows(pa, e1, e2, ng))  # (4, 10, Tpad)

    def pad_i(vals, fill):
        a = np.full(tpad, fill, np.int32)
        a[:t] = np.asarray(vals, np.int32)
        return jnp.asarray(a)

    cull_f = np.zeros(tpad, np.float32)
    cull_f[:t] = np.asarray(cull, np.float32)
    return FusedDenseTable(
        coeffs=coeffs,
        ids=pad_i(ids, -1),
        owner=pad_i(owner, 0),
        entry=pad_i(entry, -1),
        cull=jnp.asarray(cull_f),
        orient=orient,
        count=t,
    )


def ray_features(lo, ld):
    """The ten per-lane features [d, w = d x o, o, 1] as (R,) arrays,
    shared by both sweep forms (lo/ld are V3, SoA)."""
    wx = ld.y * lo.z - ld.z * lo.y
    wy = ld.z * lo.x - ld.x * lo.z
    wz = ld.x * lo.y - ld.y * lo.x
    one = jnp.ones_like(lo.x)
    return (ld.x, ld.y, ld.z, wx, wy, wz, lo.x, lo.y, lo.z, one)


def _accept(det, u_num, v_num, t_num, same_entry, cull, orient):
    """Möller-Trumbore acceptance on the four decision planes (any
    broadcastable shapes) -> t with +inf where rejected."""
    ok = jnp.abs(det) >= EPSILON
    f = 1.0 / det
    u = f * u_num
    v = f * v_num
    t = f * t_num
    ok &= (u >= 0.0) & (u <= 1.0)
    ok &= (v >= 0.0) & (u + v <= 1.0)
    ok &= t > EPSILON
    # Only the lane's CURRENT chain entry participates (the chain fold
    # processes entries sequentially, Trace.cl:444-482); pad columns
    # carry entry -1.
    ok &= same_entry
    # Geometric backface cull (see plucker.plucker_sweep): the ray hits
    # the back when orient*det < 0.
    ok &= ~((cull != 0.0) & (det * orient < 0.0))
    return jnp.where(ok, t, _INF)


def _fold(t, cols, t_best, c_best):
    """Fold one chunk's (RB, C) distances into the running winner. The
    winner is the lowest column among equal minima (the reference's
    strict-< update in index order, Trace.cl:352-357); chunks arrive in
    column order, so a later chunk replaces only on a strictly closer
    hit."""
    t_min = jnp.min(t, axis=1)
    hit = (t == t_min[:, None]) & (t < _INF)
    col_min = jnp.min(jnp.where(hit, cols, _BIG), axis=1)
    closer = (t_min < t_best) & (col_min < _BIG)
    return jnp.where(closer, t_min, t_best), jnp.where(closer, col_min, c_best)


def _sweep_kernel(*refs, n_chunks: int):
    feat_refs = refs[:10]
    lane_entry_ref, coeffs_ref, entry_ref, cull_ref, orient_ref = refs[10:15]
    t_ref, col_ref = refs[15:]
    feats = [r[...] for r in feat_refs]  # ten (RB,) lane vectors
    lane_entry = lane_entry_ref[...]
    rb = lane_entry.shape[0]
    lane_iota = jnp.arange(TRI_CHUNK, dtype=jnp.int32)

    def chunk(c, carry):
        t_best, c_best = carry
        c0 = pl.multiple_of(c * TRI_CHUNK, TRI_CHUNK)
        sl = pl.ds(c0, TRI_CHUNK)
        planes = []
        for k, rows in enumerate(_ROWS):
            acc = None
            for j in rows:
                term = feats[j][:, None] * coeffs_ref[k, j, sl][None, :]
                acc = term if acc is None else acc + term
            planes.append(acc)
        t = _accept(
            *planes,
            entry_ref[sl][None, :] == lane_entry[:, None],
            cull_ref[sl][None, :], orient_ref[sl][None, :],
        )
        return _fold(t, (lane_iota + c0)[None, :], t_best, c_best)

    init = (jnp.full((rb,), _INF, _F32), jnp.full((rb,), -1, jnp.int32))
    t_best, c_best = lax.fori_loop(0, n_chunks, chunk, init)
    t_ref[...] = t_best
    col_ref[...] = c_best


def sweep_entry_kernel(feats, lane_entry, table: FusedDenseTable,
                       interpret: bool = False):
    """Triton-route sweep. ``feats`` are ray_features' ten (R,) arrays;
    lane_entry (R,) i32. Returns (t (R,) f32 — +inf miss, col (R,) i32
    table column — -1). ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU tests)."""
    r = lane_entry.shape[0]
    r_pad = -(-r // RAY_BLOCK) * RAY_BLOCK
    if r_pad != r:
        # Pad lanes carry entry -1, which no table column has: they
        # sweep and miss.
        feats = [jnp.pad(f, (0, r_pad - r)) for f in feats]
        lane_entry = jnp.pad(lane_entry, (0, r_pad - r), constant_values=-1)
    tpad = table.entry.shape[0]
    lane_spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    t_out, col_out = pl.pallas_call(
        functools.partial(_sweep_kernel, n_chunks=tpad // TRI_CHUNK),
        grid=(r_pad // RAY_BLOCK,),
        in_specs=[lane_spec] * 11 + [whole] * 4,
        out_specs=[lane_spec, lane_spec],
        out_shape=[
            jax.ShapeDtypeStruct((r_pad,), _F32),
            jax.ShapeDtypeStruct((r_pad,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="plucker_dense_sweep",
    )(
        *feats, lane_entry.astype(jnp.int32), table.coeffs, table.entry,
        table.cull, table.orient,
    )
    return t_out[:r], col_out[:r]


def sweep_entry_reference(feats, lane_entry, table: FusedDenseTable):
    """Plain jnp/lax form of sweep_entry_kernel (same signature, same
    fold): one (R, 10) x (10, 4C) product at full f32 precision per
    triangle chunk."""
    f = jnp.stack(feats, axis=1)  # (R, 10)
    r = f.shape[0]
    lane_entry = lane_entry.astype(jnp.int32)
    tpad = table.entry.shape[0]
    cols = jnp.arange(_REF_CHUNK, dtype=jnp.int32)

    def chunk(c, carry):
        c0 = c * _REF_CHUNK
        co = lax.dynamic_slice_in_dim(table.coeffs, c0, _REF_CHUNK, axis=2)
        planes = jnp.einsum("rj,kjc->krc", f, co, precision="highest")
        sl = lambda a: lax.dynamic_slice_in_dim(a, c0, _REF_CHUNK)[None, :]
        t = _accept(
            *planes, sl(table.entry) == lane_entry[:, None],
            sl(table.cull), sl(table.orient),
        )
        return _fold(t, (cols + c0)[None, :], *carry)

    init = (jnp.full((r,), _INF, _F32), jnp.full((r,), -1, jnp.int32))
    return lax.fori_loop(0, tpad // _REF_CHUNK, chunk, init)


def sweep_entry_local(lo, ld, lane_entry, table: FusedDenseTable):
    """Closest accepted hit of each lane's local-frame ray against ITS
    chain entry's triangles. lo/ld are V3 (SoA); lane_entry (R,) i32.
    Returns (t (R,) f32 — +inf miss, col (R,) i32 table column — -1).

    On a CUDA device this is the Triton kernel; any other backend
    lowers the plain reference (the kernel has no CPU lowering)."""
    return lax.platform_dependent(
        ray_features(lo, ld), lane_entry.astype(jnp.int32), table,
        cuda=sweep_entry_kernel, default=sweep_entry_reference,
    )
