"""Persistent-lane megakernel integrator over a wide (MEGA_ARITY) BVH.

The fast path. Its cost model: each while_loop iteration pays one row
gather per lane and a fixed per-iteration cost, so the binding
constraint is (LOOP ITERATIONS) x (LANES), which drives the design:

  * ONE while_loop for the whole renderer. Each lane owns its entire
    task — pixel, sample loop, bounce loop, mesh chain, BVH cursor — as
    a state machine, so iterations approach the per-lane mean work
    instead of the product of per-phase maxima that a nested-loop
    renderer pays.
  * WIDE BVH nodes (MEGA_ARITY=32) + 8-triangle leaf rows in one
    W=160 bank. Row width is free, so a node row carries 32 uint8-
    quantised boxes (per-node grid, conservative) and their targets;
    leaf rows carry up to eight exact-f32 triangles inline (subtrees
    with <= 8 tris collapse into one row). Rows visited per path
    segment drop ~3-4x versus the 8-wide/2-tri layout.
  * INLINE STATIC STAGE. Small identity-transform meshes (the Cornell
    quads — where most secondary segments terminate) are MT-tested
    densely inside the shade iteration: zero gathered rows, no chain
    entry. A wall-bound segment costs ONE loop iteration.
  * ROOT PRETEST. Entering a traversal entry slab-tests the mesh's
    root bounds against the static-stage distance bound first; lanes
    whose segment resolves in front of the mesh skip its subtree
    entirely (most diffuse bounces in a Cornell scene).
  * SoA STATE. Every vector lives as per-component (R,) arrays
    (tpurt.core.v3.V3) and the traversal stack as per-slot (R,)
    registers, so every elementwise op streams contiguous lane vectors.
    The one (R, W) array per iteration (the gathered row) comes from
    the pre-transposed (W, N) bank so every column slice is a
    contiguous (R,) vector.
  * ACCESSOR-INDIRECTED BODY. Everything after the gather lives in
    ``_body_math``, which reads row columns through ``col(j)``, static
    triangles through ``srows[s, j]``, and chain/material constants
    through packed little tables supporting scalar ``[i, c]`` reads, so
    a kernel that holds these as refs can run the same transcription
    without a second copy of the algorithm.

Chain/shade structure and parity are as before: OneSided meshes keep
per-mesh rejection (Trace.cl:466-471; single-quad OneSided meshes may
move into the static stage, where candidate-level rejection is
equivalent because all of a quad's candidates share one facing),
shading is the shared render/shading.py step (identical RNG stream to
the modular engine and the scalar oracle), and the bounce-0
intersection of sample 0 replays for later samples (the reference
reuses one camera ray per pixel, Trace.cl:636-641). Retired lanes idle
until the batch drains (the host-staged compaction driver in
render/renderer.py shrinks long tails); closest-hit ties between
coincident triangles resolve by traversal order (measure-zero; goldens
gate it).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from tpurt.config import EPSILON


def _config_mod():
    """Late module handle so tests can monkeypatch tunables (e.g. the
    interleave floor) on ``tpurt.config`` and have the kernel see it."""
    import tpurt.config as _c

    return _c
from tpurt.core import rng as rnglib
from tpurt.core import v3 as v3lib
from tpurt.core.v3 import V3
from tpurt.core.vecmath import euler_rotation
from tpurt.render import shading as _shading
from tpurt.render.shading import pack_materials, shade_hit_soa
from tpurt.scene.builder import MEGA_ARITY, MEGA_LEAF_TRIS, MEGA_SLOT_BITS
from tpurt.scene.types import MaterialType, Scene

_F32 = jnp.float32
_INF = np.float32(np.inf)
_NINF = np.float32(-np.inf)
# Host constant on purpose: a module-level jnp array referenced inside
# traced code caches a stale tracer across traces on this JAX version,
# corrupting later executables' hidden-constant lists ("Execution
# supplied N buffers but compiled program expected N+k").
_EMPTY = np.uint32(0xFFFFFFFF)
_SLOT_MASK = np.uint32((1 << MEGA_SLOT_BITS) - 1)
#: Stack-entry tag: set = a RESOLVED child meta (target<<1 | is_leaf),
#: clear = a (row << SLOT_BITS | slot) parent resume. Row indices stay
#: < 2^26 so resume entries never set it; _EMPTY is tested first.
_TAG = np.uint32(0x80000000)
#: TLAS regime only (builder.MEGA_ITAG): meta bit 28 marks "target is
#: an INSTANCE row" in node-row child slots and resolved stack entries;
#: the same bit on a _TAG entry whose lane is in_inst is the instance
#: EXIT MARKER. Targets stay < 2^27 (freeze assert) so plain metas
#: never set it.
_ITAG = np.uint32(1 << 28)
_ITAG_I = np.int32(1 << 28)
#: Meta target mask (bits 0..27: target << 1 | is_leaf).
_META_T = np.int32((1 << 28) - 1)
_EPS = np.float32(EPSILON)

# Packed chain-parameter table columns (one (E, 21) f32 matrix serving
# scalar [e, c] reads).
_CP_POS = 0  # 3 columns
_CP_ROT = 3  # 9 columns, row-major: rot[i][j] at 3 + 3*i + j
_CP_SCALE = 12
_CP_OS = 13  # one_sided as 0.0/1.0
_CP_CULL = 14  # backface-cull policy as 0.0/1.0
_CP_RMIN = 15  # 3 columns
_CP_RMAX = 18  # 3 columns
CP_WIDTH = 21


class _Lane(NamedTuple):
    # diagnostics
    iters: jnp.ndarray  # () i32 — loop iterations executed (sync cost);
    #   with run_megakernel(debug_counters=True) a (6,) i32 vector:
    #   [iters, live, node, leaf, shade, enter] lane-iteration tallies
    # per-lane task constants (ride in the state so lanes can be
    # COMPACTED: a shrunken batch must carry its own primary rays/seeds)
    ro0: V3  # primary origin
    rd0: V3  # primary direction
    pix: jnp.ndarray  # (R,) u32 pixel index (CURRENT pixel in quota mode)
    pixno: jnp.ndarray  # (R,) i32 — index of the current pixel in the
    #   lane's quota (0..pixels_per_lane-1); always 0 when quota == 1
    lane0: jnp.ndarray  # (R,) i32 — the lane's ORIGINAL batch index
    #   (list-quota mode only, else None): its quota pixels are
    #   pixel_list[lane0 + k*stride], and a compacted resume rebuilds
    #   the slot tables from it. Never read inside the loop body.
    # sample machinery
    sample: jnp.ndarray  # (R,) i32
    acc: V3  # current pixel's radiance accumulator
    accs: Tuple[V3, ...]  # per-quota-slot banked accumulators (empty
    #   when quota == 1: the single pixel's result stays in ``acc``)
    rng: jnp.ndarray  # (R,) u32
    done: jnp.ndarray  # (R,) bool
    segments: jnp.ndarray  # (R,) i32
    # path state
    origin: V3
    direction: V3
    throughput: V3
    light: V3
    bounces: jnp.ndarray  # (R,) i32
    invis: jnp.ndarray  # (R,) i32
    # chain + traversal
    entry: jnp.ndarray  # (R,) i32 in [0, E]; E == shading stage
    cur: jnp.ndarray  # (R,) i32 row; -1 = entry exhausted
    cur_leaf: jnp.ndarray  # (R,) bool — cur is a leaf row
    cur_slot: jnp.ndarray  # (R,) i32 — first child slot to consider
    stack: Tuple[jnp.ndarray, ...]  # S x (R,) u32 — (row << SLOT_BITS | slot)
    lo: V3  # local ray
    ld: V3
    lid: V3  # 1/ld
    lt: jnp.ndarray  # (R,) local best distance
    lnrm: V3  # local best normal (ray-flipped)
    lback: jnp.ndarray  # (R,) bool
    lmesh: jnp.ndarray  # (R,) i32 winner's mesh (-1 = none)
    # world-space best across the chain
    w_valid: jnp.ndarray
    w_dst: jnp.ndarray
    w_point: V3
    w_normal: V3
    w_back: jnp.ndarray
    w_mesh: jnp.ndarray
    # primary-hit cache (bounce-0 intersection, shared by all samples)
    c_set: jnp.ndarray
    c_valid: jnp.ndarray
    c_point: V3
    c_normal: V3
    c_back: jnp.ndarray
    c_mesh: jnp.ndarray
    c_dst: jnp.ndarray
    # TLAS (instance-as-data) regime only — None otherwise, so the
    # leaves drop out of the streamed state for unrolled-chain scenes
    # (the cache-field pattern above).
    in_inst: jnp.ndarray = None  # (R,) bool — inside an instance subtree
    cur_inst: jnp.ndarray = None  # (R,) bool — cur is an INSTANCE row
    inst_mesh: jnp.ndarray = None  # (R,) i32 — owner mesh, stashed at enter
    inst_scale: jnp.ndarray = None  # (R,) f32 — instance scale (1.0 outside)
    inst_cull: jnp.ndarray = None  # (R,) bool — backface-cull policy
    inst_os: jnp.ndarray = None  # (R,) bool — OneSided rejection at exit


class _Slots(NamedTuple):
    """Per-quota-slot loop-invariant tables for slots 1..P-1 (slot 0 is
    the lane's entry ray/pixel). ``rd``: primary directions, always
    present in quota mode. ``pix``: absolute pixel ids — only in LIST
    mode, where a lane's quota walks an arbitrary packed pixel list
    (pixel_list[lane0 + k*stride]) instead of the affine pix + k*stride
    of a frame batch; the advance step then selects the next pixel from
    these tables exactly like it selects the next direction."""

    rd: Tuple[V3, ...]
    pix: Tuple[jnp.ndarray, ...]


class _ChainParams(NamedTuple):
    """Per-entry transform/material constants: one packed (E, 21) f32
    table (scalar [e, c] reads) plus build-time-static row targets."""

    table: jnp.ndarray  # (E, CP_WIDTH) f32
    root: Tuple[int, ...]  # static row indices
    root_leaf: Tuple[bool, ...]
    mesh: Tuple[int, ...]  # static mesh ids (-1 = fused static entry)
    # Root-expansion tables (config.MEGA_ROOT_EXPAND; None when no
    # entry expands). roots_f: (E, 1 + 6*MEGA_ARITY) f32 — [sort axis
    # as f32, then per slot bmin.xyz/bmax.xyz DECODED exactly as the
    # in-loop quantised decode computes them]. roots_i: (E, MEGA_ARITY)
    # i32 child metas. expand: static per-entry gate.
    roots_f: jnp.ndarray = None
    roots_i: jnp.ndarray = None
    expand: Tuple[bool, ...] = ()


def _chain_params(scene: Scene) -> _ChainParams:
    rows = []
    for mesh_idx, _root, _leaf in scene.mega_chain:
        if mesh_idx == -2:  # TLAS entry: identity transform, world-
            # space union bounds of all instances as the pretest box
            b = scene.mega_tlas_bounds
            rows.append(jnp.asarray(
                [0.0, 0.0, 0.0,
                 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0,
                 1.0, 0.0, 1.0,
                 b[0], b[1], b[2], b[3], b[4], b[5]],
                dtype=jnp.float32,
            ))
        elif mesh_idx < 0:  # fused static entry: identity transform
            rows.append(jnp.asarray(
                [0.0, 0.0, 0.0,  # pos
                 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0,  # rot
                 1.0,  # scale
                 0.0,  # one_sided
                 1.0,  # cull (unused; per-tri cull applies)
                 -_INF, -_INF, -_INF, _INF, _INF, _INF],  # rmin/rmax
                dtype=jnp.float32,
            ))
        else:
            i = mesh_idx
            rot = euler_rotation(
                scene.mesh_pitch[i], scene.mesh_yaw[i], scene.mesh_roll[i]
            ).reshape(9)
            mt = scene.mat_type[i]
            one_sided = (mt == int(MaterialType.ONE_SIDED)).astype(_F32)
            cull = (
                (mt != int(MaterialType.GLASSY))
                & (mt != int(MaterialType.INVISIBLE))
                & (mt != int(MaterialType.ONE_SIDED))
            ).astype(_F32)
            # Local-space root bounds from the mesh's uint16 quant grid
            # (it spans exactly the binary-BVH root box).
            rmin = scene.mesh_qmin[i]
            rmax = scene.mesh_qmin[i] + np.float32(65535.0) * scene.mesh_qscale[i]
            rows.append(jnp.concatenate([
                scene.mesh_pos[i], rot,
                scene.mesh_scale[i][None], one_sided[None], cull[None],
                rmin, rmax,
            ]))
    cfg = _config_mod()
    chain_roots = tuple(r for _, r, _ in scene.mega_chain)
    chain_leaf = tuple(l for _, _, l in scene.mega_chain)
    expand = tuple(
        bool(cfg.MEGA_ROOT_EXPAND)
        and len(scene.mega_chain) <= cfg.MEGA_ROOT_EXPAND_MAX_E
        and not leaf
        # TLAS roots hold ITAG-tagged instance metas the expansion's
        # meta decode does not handle — one root-gather iteration per
        # entered TLAS traversal instead.
        and m != -2
        for m, _, leaf in scene.mega_chain
    )
    roots_f = roots_i = None
    if any(expand):
        roots_f, roots_i = _root_tables(scene, chain_roots, expand)
    return _ChainParams(
        table=jnp.stack(rows),
        root=chain_roots,
        root_leaf=chain_leaf,
        mesh=tuple(m for m, _, _ in scene.mega_chain),
        roots_f=roots_f,
        roots_i=roots_i,
        expand=expand,
    )


def _root_tables(scene: Scene, chain_roots, expand):
    """Precompute each expanded entry's root-node test inputs: the
    sort axis, DECODED per-slot child bounds, and child metas, read as
    scalars by the enter-time expansion (_expand_root). The bounds
    are computed with exactly the in-loop expression
    ``grid_o + q * grid_s`` on exactly the same f32 inputs, so the
    expansion's slab tests reproduce the node branch's hit decisions.
    Runs at trace time, so the loop body needs no scalar bitcasts (the
    bytes are pre-extracted here)."""
    f_rows = []
    i_rows = []
    m8 = jnp.uint32(0xFF)
    m_hi = jnp.uint32(0xFFFF0000)
    b2f = lambda v: v.astype(jnp.int32).astype(_F32)
    bcf = lambda u: lax.bitcast_convert_type(u, _F32)
    bf16 = scene.mega_bounds_fmt == "bf16"
    arity = int(getattr(scene, "mega_arity", MEGA_ARITY))
    for e, root in enumerate(chain_roots):
        if not expand[e]:
            f_rows.append(jnp.zeros((1 + 6 * arity,), _F32))
            i_rows.append(jnp.zeros((arity,), jnp.int32))
            continue
        row = scene.mega_rows[root]  # (W,) f32
        axis_f = lax.bitcast_convert_type(row[6], jnp.int32).astype(_F32)
        cols = [axis_f[None]]
        metas = []
        if bf16:
            for slot in range(arity):
                base = 7 + 4 * slot
                w0 = lax.bitcast_convert_type(row[base], jnp.uint32)
                w1 = lax.bitcast_convert_type(row[base + 1], jnp.uint32)
                w2 = lax.bitcast_convert_type(row[base + 2], jnp.uint32)
                metas.append(
                    lax.bitcast_convert_type(row[base + 3], jnp.int32)
                )
                sh = jnp.uint32(16)
                cols.append(jnp.stack(
                    [bcf(w0 << sh), bcf(w0 & m_hi), bcf(w1 << sh)]
                ))
                cols.append(jnp.stack(
                    [bcf(w1 & m_hi), bcf(w2 << sh), bcf(w2 & m_hi)]
                ))
        else:
            grid_o = row[0:3]
            grid_s = row[3:6]
            for slot in range(arity):
                base = 7 + 3 * slot
                w0 = lax.bitcast_convert_type(row[base], jnp.uint32)
                w1 = lax.bitcast_convert_type(row[base + 1], jnp.uint32)
                metas.append(
                    lax.bitcast_convert_type(row[base + 2], jnp.int32)
                )
                q_lo = jnp.stack([
                    b2f(w0 & m8),
                    b2f((w0 >> jnp.uint32(8)) & m8),
                    b2f((w0 >> jnp.uint32(16)) & m8),
                ])
                q_hi = jnp.stack([
                    b2f((w0 >> jnp.uint32(24)) & m8),
                    b2f(w1 & m8),
                    b2f((w1 >> jnp.uint32(8)) & m8),
                ])
                cols.append(grid_o + q_lo * grid_s)
                cols.append(grid_o + q_hi * grid_s)
        f_rows.append(jnp.concatenate(cols))
        i_rows.append(jnp.stack(metas))
    return jnp.stack(f_rows), jnp.stack(i_rows)



def _bool_full(shape, value: bool) -> jnp.ndarray:
    """Lane-shaped bool constant built from an i32 compare."""
    z = jnp.zeros(shape, jnp.int32)
    return (z == 0) if value else (z != 0)


def _bsel(c, a, b):
    """where(c, a, b) for BOOL payloads as pure boolean logic."""
    return (c & a) | (~c & b)

def _sel(table, entry: jnp.ndarray, e_count: int, col: int) -> jnp.ndarray:
    """Per-lane fetch of table[entry, col] -> lane-shaped f32.

    Below SELECT_GATHER_THRESHOLD entries this is a chain of broadcast
    selects (one fused elementwise op each). Above it, a real gather:
    the select chain's O(K) body growth per call site makes K~100
    scenes uncompilable."""
    from tpurt.config import SELECT_GATHER_THRESHOLD

    if e_count > SELECT_GATHER_THRESHOLD:
        return table[entry, col]
    out = jnp.zeros(entry.shape, _F32)
    for i in range(e_count):
        out = jnp.where(entry == i, table[i, col], out)
    return out


def _sel_v3(table, entry: jnp.ndarray, e_count: int, col: int) -> V3:
    return V3(
        _sel(table, entry, e_count, col),
        _sel(table, entry, e_count, col + 1),
        _sel(table, entry, e_count, col + 2),
    )


def _sel_static(values, entry: jnp.ndarray, e_count: int, dtype) -> jnp.ndarray:
    from tpurt.config import SELECT_GATHER_THRESHOLD

    if e_count > SELECT_GATHER_THRESHOLD:
        # Gather regime (see _sel): build-time-static tuples become
        # device constants indexed per lane.
        tab = jnp.asarray(np.asarray(values, dtype))
        return tab[entry]
    if dtype is bool:
        # Pure boolean logic (no bool-scalar where).
        out = _bool_full(entry.shape, False)
        for i in range(e_count):
            if bool(values[i]):
                out = out | (entry == i)
        return out
    out = jnp.zeros(entry.shape, dtype)
    for i in range(e_count):
        out = jnp.where(entry == i, jnp.asarray(values[i], dtype), out)
    return out


def _rot_fwd(table, entry, e_count: int, v: V3) -> V3:
    """out_i = sum_j rot[i][j] * v_j (mul_mat_vec, Trace.cl:105-107),
    accumulated j = 0, 1, 2 like the einsum it replaced."""
    out = []
    for i in range(3):
        r0 = _sel(table, entry, e_count, _CP_ROT + 3 * i)
        r1 = _sel(table, entry, e_count, _CP_ROT + 3 * i + 1)
        r2 = _sel(table, entry, e_count, _CP_ROT + 3 * i + 2)
        out.append(r0 * v.x + r1 * v.y + r2 * v.z)
    return V3(*out)


def _rot_t(table, entry, e_count: int, v: V3) -> V3:
    """out_i = sum_j rot[j][i] * v_j (transposed apply)."""
    out = []
    for i in range(3):
        r0 = _sel(table, entry, e_count, _CP_ROT + i)
        r1 = _sel(table, entry, e_count, _CP_ROT + 3 + i)
        r2 = _sel(table, entry, e_count, _CP_ROT + 6 + i)
        out.append(r0 * v.x + r1 * v.y + r2 * v.z)
    return V3(*out)


def _enter(params: _ChainParams, e_count: int, entry, origin: V3, direction: V3):
    """WorldToLocalRay (Trace.cl:118-137) for each lane's chain entry."""
    entry_c = jnp.minimum(entry, e_count - 1)
    tab = params.table
    pos = _sel_v3(tab, entry_c, e_count, _CP_POS)
    scale = _sel(tab, entry_c, e_count, _CP_SCALE)
    safe = jnp.where(jnp.abs(scale) > _EPS, scale, _F32(1.0))
    lo = _rot_t(tab, entry_c, e_count, origin - pos) / safe
    ld = v3lib.normalize(_rot_t(tab, entry_c, e_count, direction) / safe)
    root = _sel_static(params.root, entry_c, e_count, jnp.int32)
    root_leaf = _sel_static(params.root_leaf, entry_c, e_count, bool)
    return lo, ld, V3(1.0 / ld.x, 1.0 / ld.y, 1.0 / ld.z), root, root_leaf


def _mt_core(lo: V3, ld: V3, pa: V3, pb: V3, pc: V3, na: V3, nb: V3, nc: V3,
             cull):
    """Exact Moller-Trumbore; identical op order to intersect._mt_single.
    ``cull`` is a bool array broadcastable to the lane shape."""
    e1 = pb - pa
    e2 = pc - pa
    h = v3lib.cross(ld, e2)
    det = v3lib.dot(e1, h)
    ok = jnp.abs(det) >= _EPS
    f = 1.0 / det
    s = lo - pa
    u = f * v3lib.dot(s, h)
    ok &= (u >= 0.0) & (u <= 1.0)
    q = v3lib.cross(s, e1)
    v = f * v3lib.dot(ld, q)
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = f * v3lib.dot(e2, q)
    ok &= t > _EPS
    w = 1.0 - u - v
    n = v3lib.normalize(V3(
        na.x * w + nb.x * u + nc.x * v,
        na.y * w + nb.y * u + nc.y * v,
        na.z * w + nb.z * u + nc.z * v,
    ))
    backface = v3lib.dot(ld, n) > _EPS
    if isinstance(cull, bool):  # trace-time-static policy (static stage)
        if cull:
            ok &= ~backface
    else:
        ok &= ~(cull & backface)
    n = v3lib.where(backface, -n, n)
    return ok, t, n, backface


def _mt_inline(lo: V3, ld: V3, col, base, cull):
    """MT against an inline triangle slot of a leaf row read through the
    ``col`` accessor; returns the owner-mesh aux word too."""
    cv = lambda b: V3(col(b), col(b + 1), col(b + 2))
    aux = lax.bitcast_convert_type(col(base + 18), jnp.int32)
    ok, t, n, backface = _mt_core(
        lo, ld, cv(base), cv(base + 3), cv(base + 6),
        cv(base + 9), cv(base + 12), cv(base + 15), cull,
    )
    return ok, t, n, backface, aux


def _static_cull(mats, num_meshes: int, owner: jnp.ndarray,
                 candidates=None) -> jnp.ndarray:
    """Backface-cull policy by owner mesh id (cull unless
    Glassy/Invisible/OneSided, Trace.cl:460-462). ``candidates``
    (static tuple) restricts the select chain to the mesh ids that can
    actually appear as owners at the call site — ids outside it default
    to cull=True, which callers guarantee is never read."""
    from tpurt.config import SELECT_GATHER_THRESHOLD
    from tpurt.render.shading import MAT_TYPE

    if candidates is not None:
        cull_f = jnp.ones(owner.shape, _F32)
        for i in candidates:
            mt = mats[int(i), MAT_TYPE]
            c = (
                (mt != float(int(MaterialType.GLASSY)))
                & (mt != float(int(MaterialType.INVISIBLE)))
                & (mt != float(int(MaterialType.ONE_SIDED)))
            ).astype(_F32)
            cull_f = jnp.where(owner == int(i), c, cull_f)
        return cull_f != 0.0
    if num_meshes > SELECT_GATHER_THRESHOLD:
        # Gather regime (XLA body only — see _sel).
        mt = mats[jnp.clip(owner, 0, num_meshes - 1), MAT_TYPE]
        c = (
            (mt != float(int(MaterialType.GLASSY)))
            & (mt != float(int(MaterialType.INVISIBLE)))
            & (mt != float(int(MaterialType.ONE_SIDED)))
        )
        return c | (owner < 0) | (owner >= num_meshes)

    # The policy rides as f32 0/1 through the select chain (no scalar
    # bool broadcast into a lane vector).
    cull_f = jnp.ones(owner.shape, _F32)
    for i in range(num_meshes):
        mt = mats[i, MAT_TYPE]
        c = (
            (mt != float(int(MaterialType.GLASSY)))
            & (mt != float(int(MaterialType.INVISIBLE)))
            & (mt != float(int(MaterialType.ONE_SIDED)))
        ).astype(_F32)
        cull_f = jnp.where(owner == i, c, cull_f)
    return cull_f != 0.0


def _static_stage(srows, s_cull, s_onesided, s_owner, mats,
                  num_meshes: int, enabled, origin: V3, direction: V3):
    """Dense MT of the inline static triangles (Scene.mega_static_rows,
    read through scalar ``srows[s, j]`` accesses) for lanes with a fresh
    ray; returns the seeded world-space best (valid, dst, point, normal,
    back, mesh) exactly as the old fused static chain entry would have
    produced it.

    Identity WorldToLocalRay still renormalises the direction
    (Trace.cl:130); replicated so distances stay bit-identical to the
    oracle. Candidates fold in mesh/index order with strict <, matching
    the reference's per-mesh loop order."""
    s_count = len(s_cull)
    zeros = jnp.zeros(enabled.shape, _F32)
    zero3 = V3(zeros, zeros, zeros)
    falses = _bool_full(enabled.shape, False)
    if s_count == 0:
        return (
            falses, jnp.full(enabled.shape, _INF, _F32), zero3, zero3, falses,
            jnp.zeros(enabled.shape, jnp.int32) - 1,
        )

    ld = v3lib.normalize(direction)
    lt = jnp.full(enabled.shape, _INF, _F32)
    lnrm = zero3
    lback = falses
    lmesh = jnp.zeros(enabled.shape, jnp.int32) - 1
    for s_idx in range(s_count):
        cv = lambda b: V3(srows[s_idx, b], srows[s_idx, b + 1],
                          srows[s_idx, b + 2])
        ok, t, n, backface = _mt_core(
            origin, ld, cv(0), cv(3), cv(6), cv(9), cv(12), cv(15),
            bool(s_cull[s_idx]),
        )
        # OneSided candidate rejection (equivalent to the reference's
        # per-mesh rejection for planar quads; builder guarantees only
        # those are inlined).
        if s_onesided[s_idx]:
            ok &= ~backface
        # Owner rides as static metadata (mega_static_owner) so no
        # scalar bitcast is needed.
        owner = np.int32(s_owner[s_idx])
        win = enabled & ok & (t < lt)
        lt = jnp.where(win, t, lt)
        lnrm = v3lib.where(win, n, lnrm)
        lback = _bsel(win, backface, lback)
        lmesh = jnp.where(win, owner, lmesh)

    valid = enabled & (lmesh >= 0)
    point = origin + ld * lt
    n_w = v3lib.normalize(lnrm)
    dst = v3lib.length(point - origin)
    return (
        valid,
        jnp.where(valid, dst, _INF),
        v3lib.where(valid, point, zero3),
        v3lib.where(valid, n_w, zero3),
        valid & lback,
        jnp.where(valid, lmesh, -1),
    )


def _aabb_soa(lo: V3, lid: V3, bmin: V3, bmax: V3, limit):
    """Slab test of per-lane boxes with a distance bound; same
    association as the (R, 3)-reduction form it replaced."""
    t0 = (bmin - lo) * lid
    t1 = (bmax - lo) * lid
    tsm = V3(jnp.minimum(t0.x, t1.x), jnp.minimum(t0.y, t1.y),
             jnp.minimum(t0.z, t1.z))
    tbg = V3(jnp.maximum(t0.x, t1.x), jnp.maximum(t0.y, t1.y),
             jnp.maximum(t0.z, t1.z))
    sx = jnp.where(jnp.isnan(tsm.x), _NINF, tsm.x)
    sy = jnp.where(jnp.isnan(tsm.y), _NINF, tsm.y)
    sz = jnp.where(jnp.isnan(tsm.z), _NINF, tsm.z)
    bx = jnp.where(jnp.isnan(tbg.x), _INF, tbg.x)
    by = jnp.where(jnp.isnan(tbg.y), _INF, tbg.y)
    bz = jnp.where(jnp.isnan(tbg.z), _INF, tbg.z)
    tmin = jnp.maximum(jnp.maximum(sx, sy), sz)
    tmax = jnp.minimum(jnp.minimum(bx, by), bz)
    return (tmax >= jnp.maximum(tmin, 0.0)) & (tmin < limit), tmin


def _pretest(params, e_count: int, entry, lo: V3, lid: V3, w_dst):
    """Root pretest: slab the entry's local root box against the bound."""
    entry_c = jnp.minimum(entry, e_count - 1)
    tab = params.table
    scale = _sel(tab, entry_c, e_count, _CP_SCALE)
    safe = jnp.where(jnp.abs(scale) > _EPS, scale, _F32(1.0))
    rmin = _sel_v3(tab, entry_c, e_count, _CP_RMIN)
    rmax = _sel_v3(tab, entry_c, e_count, _CP_RMAX)
    ok, _ = _aabb_soa(lo, lid, rmin, rmax, w_dst / safe * _F32(1.001))
    return ok


def _expand_root(
    params: _ChainParams,
    e: int,  # static entry index (params.expand[e] is True)
    mask,  # (R,) bool — lanes entering entry e with a passing pretest
    lo: V3, ld: V3, lid: V3,  # the entry's local ray
    lt, w_dst,  # distance state as the next node step would see it
    cur, cur_leaf, stack, s_depth: int,
    arity: int = None,
):
    """Run entry ``e``'s root-node test inline at enter time (the
    node branch of _body_math one iteration early, from precomputed
    scalars instead of a gathered row): descend straight to the
    first hit child, push the resolved second child / parent resume
    exactly as the node step would, or finish the entry (cur = -1)
    when no child hits. Saves the root-row gather AND its loop
    iteration for every entered traversal; hit decisions and stack
    contents are identical to the un-expanded trajectory."""
    lanes = cur.shape
    arity = arity or MEGA_ARITY
    rf, ri = params.roots_f, params.roots_i
    tab = params.table

    scale = tab[e, _CP_SCALE]
    safe = jnp.where(jnp.abs(scale) > _EPS, scale, _F32(1.0))
    limit = jnp.minimum(lt, w_dst / safe * _F32(1.001))
    # Scalar table reads are broadcast to lane vectors BEFORE any
    # compare (the node branch's operands are all lane vectors too).
    zeros = jnp.zeros(lanes, _F32)
    zeros_i = jnp.zeros(lanes, jnp.int32)
    axis_v = zeros + rf[e, 0]
    dcomp = jnp.where(
        axis_v == _F32(0.0), ld.x,
        jnp.where(axis_v == _F32(1.0), ld.y, ld.z),
    )
    fwd = dcomp >= 0.0

    best_prio = jnp.full(lanes, arity, jnp.int32)
    first_meta = jnp.zeros(lanes, jnp.int32)
    second_prio = jnp.full(lanes, arity, jnp.int32)
    second_meta = jnp.zeros(lanes, jnp.int32)
    hit_count = jnp.zeros(lanes, jnp.int32)
    for slot in range(arity):
        meta = zeros_i + ri[e, slot]  # scalar i32 -> lane vector
        base = 1 + 6 * slot
        bmin = V3(rf[e, base], rf[e, base + 1], rf[e, base + 2])
        bmax = V3(rf[e, base + 3], rf[e, base + 4], rf[e, base + 5])
        hit, _tmin = _aabb_soa(lo, lid, bmin, bmax, limit)
        prio = jnp.where(fwd, slot, arity - 1 - slot)
        hit = hit & (meta != 0)  # enter implies cur_slot == 0: no floor
        better = hit & (prio < best_prio)
        second = hit & ~better & (prio < second_prio)
        second_prio = jnp.where(
            better, best_prio, jnp.where(second, prio, second_prio)
        )
        second_meta = jnp.where(
            better, first_meta, jnp.where(second, meta, second_meta)
        )
        best_prio = jnp.where(better, prio, best_prio)
        first_meta = jnp.where(better, meta, first_meta)
        hit_count = hit_count + hit.astype(jnp.int32)

    first_found = best_prio < arity
    desc = mask & first_found
    push_child = desc & (hit_count >= 2)
    push_resume = desc & (hit_count >= 3)

    root_row = int(params.root[e])  # build-time static
    resume_entry = (
        jnp.uint32(root_row << MEGA_SLOT_BITS)
        | (second_prio + 1).astype(jnp.uint32)
    )
    child_entry = _TAG | second_meta.astype(jnp.uint32)

    cur = jnp.where(desc, first_meta >> 1, jnp.where(mask, -1, cur))
    cur_leaf = _bsel(desc, (first_meta & 1) == 1, cur_leaf & ~mask)
    # Entering lanes hold an empty stack by invariant (restart resets
    # it; a chain advance only happens once the previous entry's stack
    # drained), so the node step's two push cascades reduce to direct
    # slot writes: resolved 2nd child on top, parent resume below it.
    assert s_depth >= 2, "node-root scenes always carry stack depth >= 2"
    stack = (
        jnp.where(push_child, child_entry, stack[0]),
        jnp.where(push_resume, resume_entry, stack[1]),
    ) + tuple(stack[2:])
    return cur, cur_leaf, stack


def _body_math(
    s: _Lane,
    col,  # col(j) -> lane-shaped f32 column of the gathered row (or None)
    srows,  # static triangle rows, scalar [s, j] reads
    mats,  # (K, 11) packed materials, scalar [i, c] reads
    params: _ChainParams,
    slot_rays,  # _Slots: per-slot primary DIRECTIONS (and, in list
    #   mode, per-slot PIXEL ids) for quota slots 1..P-1 (empty tuples
    #   at quota 1). Slot 0's direction is the entry rd0 and is never
    #   re-selected; origins are not slotted at all — the camera is a
    #   pinhole, every slot's origin is the camera position in s.ro0.
    frame_index,
    sample_offset,
    primary_ray_fn,  # (ro0, rd0, pix, sample_u) -> (V3, V3)
    *,
    e_count: int,
    s_depth: int,
    num_meshes: int,
    s_cull,
    s_onesided,
    s_owner,
    max_bounces: int,
    rays_per_pixel: int,
    seed_mode: str,
    invisible_budget: int,
    use_cache: bool,
    p_count: int = 1,
    pixel_stride: int = 0,
    width: int = 0,
    height: int = 0,
    tail_passes: int = 1,
    frames_per_batch: int = 1,  # quota slots span this many FRAMES:
    #   slot k belongs to frame k // (p_count // frames_per_batch); the
    #   per-slot frame offset enters the seed so packed frames are
    #   bitwise-identical to rendering them separately (cross-frame
    #   lane packing — the idle decay tail and launch ramp amortise
    #   over the whole pack)
    slot_rd_map: tuple = None,  # static maps: slot index k (1..P-1) ->
    slot_pix_map: tuple = None,  # table index in slot_rays.rd / .pix.
    #   Cross-frame packs share PERIODIC tables (slot k's pixel — and,
    #   static-camera, its direction — equals slot k mod P/frames'), so
    #   the operand count stays ~one frame's worth regardless of how
    #   many frames pack. None = identity (k -> k-1).
    mat_present: tuple = None,  # static material-type set (branch pruning)
    bounds_fmt: str = "u8",  # node-row child-bounds encoding (static)
    leaf_tris: int = 8,  # inline triangles per leaf row (static; must
    #   match the scene's bank layout, Scene.mega_leaf_tris)
    arity: int = 32,  # children per node row (Scene.mega_arity)
    tlas: bool = False,  # instance-as-data regime (Scene.mega_tlas):
    #   compile the instance enter/exit branches — node-row metas may
    #   carry the MEGA_ITAG instance bit, and the lane state's
    #   in_inst/cur_inst/inst_* fields are live
    static_leaf_owners: tuple = None,  # TLAS: static owner-id set for
    #   the fused static entry's leaf-row aux words
    mat_slots: tuple = None,  # static (mesh->slot, slot->rep) material
    #   dedup for the shade fetch (TLAS regime)
    dense_hit=None,  # (t, normal V3, backface, mesh) from the fused
    #   dense sweep — replaces the BVH walk when set (dense mode)
) -> _Lane:
    """One megakernel iteration AFTER the row gather: traversal step,
    chain fold, shade, sample bookkeeping, next-entry setup. Pure
    elementwise lane math over (R,) arrays (the XLA while_loop body).
    Does NOT advance ``iters`` (the caller owns the loop counter)."""
    lanes = s.cur.shape
    zeros = jnp.zeros(lanes, _F32)
    zero3 = V3(zeros, zeros, zeros)
    zeros_i = jnp.zeros(lanes, jnp.int32)
    falses = _bool_full(lanes, False)
    empty_slot = jnp.full(lanes, _EMPTY, jnp.uint32)

    def seed_for(p_pix, sample_id, f_off=None):
        fi = frame_index if f_off is None else frame_index + f_off
        if seed_mode == "reference":
            return rnglib.make_seed(p_pix, fi, 0)
        return rnglib.make_seed(
            p_pix, fi, sample_id + jnp.uint32(sample_offset)
        )

    # ---------------- TRAVERSE: consume the gathered row --------------
    if e_count and dense_hit is not None:
        # DENSE MODE (render/plucker_fused.py): the fused Plücker sweep
        # already resolved the lane's ENTIRE current entry this
        # iteration (the reference's UseBVH=false per-mesh loop,
        # Trace.cl:444-482); adopt its winner and fall through to the
        # shared fold/enter below with the walk finished (cur = -1).
        trav = ~s.done & (s.entry < e_count) & (s.cur >= 0)
        entry_c = jnp.minimum(s.entry, e_count - 1)
        scale_e = _sel(params.table, entry_c, e_count, _CP_SCALE)
        d_t, d_nrm, d_back, d_mesh = dense_hit
        lt = jnp.where(trav, d_t, s.lt)
        lnrm = v3lib.where(trav, d_nrm, s.lnrm)
        lback = _bsel(trav, d_back, s.lback)
        lmesh = jnp.where(trav, d_mesh, s.lmesh)
        stack = s.stack
        cur = jnp.where(trav, -1, s.cur)
        cur_leaf, cur_slot = s.cur_leaf, s.cur_slot

        # ---------------- NEXT-MESH: fold + enter --------------------
        fin = ~s.done & (s.entry < e_count) & (cur < 0)
        lvalid = fin & (lmesh >= 0)
        one_sided_e = _sel(params.table, entry_c, e_count, _CP_OS) != 0.0
        lvalid &= ~(one_sided_e & lback)
        lvalid &= scale_e > _EPS
        point_l = s.lo + s.ld * lt
        point_w = (
            _rot_fwd(params.table, entry_c, e_count, point_l * scale_e)
            + _sel_v3(params.table, entry_c, e_count, _CP_POS)
        )
        n_w = v3lib.normalize(_rot_fwd(params.table, entry_c, e_count, lnrm))
        dst = v3lib.length(point_w - s.origin)
        closer = lvalid & (dst < s.w_dst)
        w_valid = _bsel(fin, s.w_valid | closer, s.w_valid)
        w_dst = jnp.where(closer, dst, s.w_dst)
        w_point = v3lib.where(closer, point_w, s.w_point)
        w_normal = v3lib.where(closer, n_w, s.w_normal)
        w_back = _bsel(closer, lback, s.w_back)
        w_mesh = jnp.where(closer, lmesh, s.w_mesh)

        entry = jnp.where(fin, s.entry + 1, s.entry)
        in_chain = fin & (entry < e_count)
        lt = jnp.where(fin, _INF, lt)
        lnrm = v3lib.where(fin, V3(zeros, zeros, zeros), lnrm)
        lback = lback & ~fin
        lmesh = jnp.where(fin, -1, lmesh)
    elif e_count:
        trav = ~s.done & (s.entry < e_count) & (s.cur >= 0)

        entry_c = jnp.minimum(s.entry, e_count - 1)
        scale_e = _sel(params.table, entry_c, e_count, _CP_SCALE)
        if tlas:
            # The lane's CURRENT frame scale: the stashed instance scale
            # inside an instance subtree, the entry's (identity) scale
            # at TLAS/static level — limits and folds follow the frame.
            scale_e = jnp.where(s.in_inst, s.inst_scale, scale_e)
        safe_e = jnp.where(jnp.abs(scale_e) > _EPS, scale_e, _F32(1.0))
        limit = jnp.minimum(s.lt, s.w_dst / safe_e * _F32(1.001))

        # --- instance branch (TLAS): the gathered row is an INSTANCE
        # row — enter (WorldToLocalRay + root pretest, the data form of
        # _enter/_pretest) or exit (LocalToWorldHit fold, the data form
        # of the per-entry fold below). See builder MEGA_INST_ROW_WORDS
        # for the row layout.
        if tlas:
            inst_on = trav & s.cur_inst
            inst_enter = inst_on & ~s.in_inst
            inst_exit = inst_on & s.in_inst

            def _irot_t(v: V3) -> V3:  # out_i = sum_j rot[j][i] * v_j
                return V3(
                    col(3) * v.x + col(6) * v.y + col(9) * v.z,
                    col(4) * v.x + col(7) * v.y + col(10) * v.z,
                    col(5) * v.x + col(8) * v.y + col(11) * v.z,
                )

            def _irot_f(v: V3) -> V3:  # out_i = sum_j rot[i][j] * v_j
                return V3(
                    col(3) * v.x + col(4) * v.y + col(5) * v.z,
                    col(6) * v.x + col(7) * v.y + col(8) * v.z,
                    col(9) * v.x + col(10) * v.y + col(11) * v.z,
                )

            i_pos = V3(col(0), col(1), col(2))
            i_scale = col(12)
            i_flags = lax.bitcast_convert_type(col(13), jnp.int32)
            i_mesh = lax.bitcast_convert_type(col(14), jnp.int32)
            i_rootmeta = lax.bitcast_convert_type(col(15), jnp.int32)
            i_safe = jnp.where(jnp.abs(i_scale) > _EPS, i_scale, _F32(1.0))
            # Enter: exactly _enter's op order (WorldToLocalRay,
            # Trace.cl:118-137), then _pretest's slab against the local
            # root bounds; degenerate scale skips the mesh up front
            # (Trace.cl:448-449 — equivalent to the unrolled fold's
            # scale>eps rejection, just earlier).
            lo_i = _irot_t(s.origin - i_pos) / i_safe
            ld_i = v3lib.normalize(_irot_t(s.direction) / i_safe)
            lid_i = V3(1.0 / ld_i.x, 1.0 / ld_i.y, 1.0 / ld_i.z)
            i_rmin = V3(col(16), col(17), col(18))
            i_rmax = V3(col(19), col(20), col(21))
            pre_i, _ = _aabb_soa(
                lo_i, lid_i, i_rmin, i_rmax,
                s.w_dst / i_safe * _F32(1.001),
            )
            enter_ok = inst_enter & pre_i & (i_scale > _EPS)
            inst_skip = inst_enter & ~(pre_i & (i_scale > _EPS))
            # Exit: LocalToWorldHit (Trace.cl:139-156) on the stashed
            # local best — exactly the per-entry fold's op order.
            fold_i = inst_exit & (s.lmesh >= 0) & ~(s.inst_os & s.lback)
            point_li = s.lo + s.ld * s.lt
            point_wi = _irot_f(point_li * i_scale) + i_pos
            n_wi = v3lib.normalize(_irot_f(s.lnrm))
            dst_i = v3lib.length(point_wi - s.origin)

        # --- leaf branch: inline exact MT tests -------------------
        leaf_on = trav & s.cur_leaf
        entry_mesh = _sel_static(params.mesh, entry_c, e_count, jnp.int32)
        is_static = entry_mesh < 0
        cull_mesh_e = _sel(params.table, entry_c, e_count, _CP_CULL) != 0.0
        lt, lnrm, lback, lmesh = s.lt, s.lnrm, s.lback, s.lmesh
        for k in range(leaf_tris):
            aux_raw = lax.bitcast_convert_type(col(19 * k + 18), jnp.int32)
            cull = _bsel(
                is_static,
                _static_cull(mats, num_meshes, aux_raw,
                             candidates=static_leaf_owners),
                cull_mesh_e,
            )
            if tlas:
                cull = _bsel(s.in_inst, s.inst_cull, cull)
            ok, t, n, backface, aux = _mt_inline(s.lo, s.ld, col, 19 * k, cull)
            cand_mesh = jnp.where(is_static, aux, entry_mesh)
            if tlas:
                cand_mesh = jnp.where(s.in_inst, s.inst_mesh, cand_mesh)
            win = leaf_on & ok & (t < lt)
            lt = jnp.where(win, t, lt)
            lnrm = v3lib.where(win, n, lnrm)
            lback = _bsel(win, backface, lback)
            lmesh = jnp.where(win, cand_mesh, lmesh)

        # --- node branch: test MEGA_ARITY quantised children -------
        # Children are build-sorted along the node's widest axis
        # (row[6]); visiting them in direction-signed PRIORITY order
        # (forward when the local ray points up the axis, reversed
        # otherwise) makes near children test first, so the distance
        # bound prunes far siblings. cur_slot is a priority threshold
        # for resuming a popped node.
        node_on = trav & ~s.cur_leaf
        if tlas:
            node_on &= ~s.cur_inst
        if bounds_fmt != "bf16":
            grid_o = V3(col(0), col(1), col(2))
            grid_s = V3(col(3), col(4), col(5))
        sort_axis = lax.bitcast_convert_type(col(6), jnp.int32)
        dcomp = jnp.where(
            sort_axis == 0, s.ld.x,
            jnp.where(sort_axis == 1, s.ld.y, s.ld.z),
        )
        fwd = dcomp >= 0.0
        best_prio = jnp.full(lanes, arity, jnp.int32)
        first_meta = zeros_i
        second_prio = jnp.full(lanes, arity, jnp.int32)
        second_meta = zeros_i
        hit_count = zeros_i
        m8 = np.uint32(0xFF)
        m_hi = np.uint32(0xFFFF0000)
        for slot in range(arity):
            if bounds_fmt == "bf16":
                # Absolute bf16 bounds, two per word in the f32 TOP
                # halves: decode = shift/mask + vector bitcast (no FMA,
                # no byte extraction) — see builder._emit_mega_subtree.
                base = 7 + 4 * slot
                w0 = lax.bitcast_convert_type(col(base), jnp.uint32)
                w1 = lax.bitcast_convert_type(col(base + 1), jnp.uint32)
                w2 = lax.bitcast_convert_type(col(base + 2), jnp.uint32)
                meta = lax.bitcast_convert_type(col(base + 3), jnp.int32)
                bcf = lambda u: lax.bitcast_convert_type(u, _F32)
                sh16 = np.uint32(16)
                bmin = V3(bcf(w0 << sh16), bcf(w0 & m_hi), bcf(w1 << sh16))
                bmax = V3(bcf(w1 & m_hi), bcf(w2 << sh16), bcf(w2 & m_hi))
            else:
                base = 7 + 3 * slot
                w0 = lax.bitcast_convert_type(col(base), jnp.uint32)
                w1 = lax.bitcast_convert_type(col(base + 1), jnp.uint32)
                meta = lax.bitcast_convert_type(col(base + 2), jnp.int32)
                # u32 -> i32 -> f32 (values are bytes, exact either way
                # — see rng.u32_to_f32_exact).
                b2f = lambda v: v.astype(jnp.int32).astype(_F32)
                q_lo = V3(
                    b2f(w0 & m8),
                    b2f((w0 >> np.uint32(8)) & m8),
                    b2f((w0 >> np.uint32(16)) & m8),
                )
                q_hi = V3(
                    b2f((w0 >> np.uint32(24)) & m8),
                    b2f(w1 & m8),
                    b2f((w1 >> np.uint32(8)) & m8),
                )
                bmin = grid_o + q_lo * grid_s
                bmax = grid_o + q_hi * grid_s
            hit, _tmin = _aabb_soa(s.lo, s.lid, bmin, bmax, limit)
            prio = jnp.where(fwd, slot, arity - 1 - slot)
            hit &= (meta != 0) & (prio >= s.cur_slot)
            better = hit & (prio < best_prio)
            second = hit & ~better & (prio < second_prio)
            # two-best tracking: a new best demotes the old best
            second_prio = jnp.where(
                better, best_prio, jnp.where(second, prio, second_prio)
            )
            second_meta = jnp.where(
                better, first_meta, jnp.where(second, meta, second_meta)
            )
            best_prio = jnp.where(better, prio, best_prio)
            first_meta = jnp.where(better, meta, first_meta)
            hit_count = hit_count + hit.astype(jnp.int32)

        first_found = best_prio < arity
        descend = node_on & first_found
        # DIRECT SECOND-CHILD PUSH: the 2nd-nearest hit child's meta is
        # pushed as a RESOLVED entry (tag bit set) so popping it costs
        # no re-gather of this node row; a (row | slot) resume entry is
        # only pushed when a THIRD hit child exists. Without this every
        # extra hit child re-gathered and re-scanned the parent row.
        push_child = descend & (hit_count >= 2)
        push_resume = descend & (hit_count >= 3)
        pop = (node_on & ~first_found) | leaf_on

        resume_entry = (
            (jnp.where(trav, s.cur, 0).astype(jnp.uint32)
             << jnp.uint32(MEGA_SLOT_BITS))
            | (second_prio + 1).astype(jnp.uint32)
        )
        child_entry = _TAG | second_meta.astype(jnp.uint32)
        if tlas:
            # Instance transitions ride the same push/pop cascades: a
            # passing enter pushes the EXIT MARKER (a resolved entry
            # targeting this instance row — popped when the subtree
            # drains, routing the lane back through the row in exit
            # mode); a failed pretest or a finished exit pops the TLAS
            # continuation. Enter/exit lanes are disjoint from the
            # node/leaf sets (cur kinds are exclusive).
            marker = (
                _TAG | _ITAG
                | (jnp.where(inst_on, s.cur, 0).astype(jnp.uint32)
                   << jnp.uint32(1))
            )
            child_entry = jnp.where(enter_ok, marker, child_entry)
            push_child = push_child | enter_ok
            pop = pop | inst_skip | inst_exit
        top = s.stack[0]
        top_empty = top == _EMPTY
        pop_shift = pop & ~top_empty
        # cascade 1: resume push XOR pop (descend and pop are disjoint)
        stack1 = []
        for i in range(s_depth):
            below = s.stack[i - 1] if i > 0 else resume_entry
            above = s.stack[i + 1] if i + 1 < s_depth else empty_slot
            stack1.append(jnp.where(
                push_resume, below, jnp.where(pop_shift, above, s.stack[i])
            ))
        # cascade 2: the resolved 2nd child lands on top (popped first:
        # it is the nearer of the two saved continuations)
        stack = []
        for i in range(s_depth):
            below = stack1[i - 1] if i > 0 else child_entry
            stack.append(jnp.where(push_child, below, stack1[i]))
        stack = tuple(stack)

        cur = s.cur
        cur_leaf = s.cur_leaf
        cur_slot = s.cur_slot
        # descend into the first hit child
        if tlas:
            cur = jnp.where(descend, (first_meta & _META_T) >> 1, cur)
        else:
            cur = jnp.where(descend, first_meta >> 1, cur)
        cur_leaf = _bsel(descend, (first_meta & 1) == 1, cur_leaf)
        cur_slot = jnp.where(descend, 0, cur_slot)
        # pop: a resolved child meta (tag bit), a saved (row, slot)
        # resume, or finish the entry
        resume = pop & ~top_empty
        top_resolved = (top & _TAG) != 0
        top_meta = top & np.uint32(0x7FFFFFFF)
        if tlas:
            pop_target = (
                (top_meta.astype(jnp.int32) & _META_T) >> jnp.int32(1)
            )
        else:
            pop_target = (top_meta >> jnp.uint32(1)).astype(jnp.int32)
        cur_popped = jnp.where(
            top_resolved,
            pop_target,
            (top >> jnp.uint32(MEGA_SLOT_BITS)).astype(jnp.int32),
        )
        slot_popped = jnp.where(
            top_resolved, 0, (top & _SLOT_MASK).astype(jnp.int32)
        )
        cur = jnp.where(resume, cur_popped, cur)
        cur_slot = jnp.where(resume, slot_popped, cur_slot)
        cur_leaf = _bsel(
            resume, top_resolved & ((top_meta & jnp.uint32(1)) == 1), cur_leaf
        )
        cur = jnp.where(pop & top_empty, -1, cur)
        if tlas:
            # Instance descend (enter) + cur-kind bookkeeping: metas
            # with the ITAG bit target instance rows; popping the exit
            # marker (ITAG while in_inst) routes the lane back through
            # the instance row in exit mode.
            cur = jnp.where(enter_ok, (i_rootmeta & _META_T) >> 1, cur)
            cur_leaf = _bsel(enter_ok, (i_rootmeta & 1) == 1, cur_leaf)
            cur_slot = jnp.where(enter_ok, 0, cur_slot)
            cur_inst = s.cur_inst
            cur_inst = _bsel(descend, (first_meta & _ITAG_I) != 0, cur_inst)
            cur_inst = _bsel(
                resume, top_resolved & ((top_meta & _ITAG) != 0), cur_inst
            )
            cur_inst = cur_inst & ~enter_ok & ~(pop & top_empty)
            in_inst = (s.in_inst | enter_ok) & ~inst_exit
            inst_mesh = jnp.where(enter_ok, i_mesh, s.inst_mesh)
            inst_scale = jnp.where(enter_ok, i_scale, s.inst_scale)
            inst_cull = _bsel(
                enter_ok, (i_flags & jnp.int32(2)) != 0, s.inst_cull
            )
            inst_os = _bsel(
                enter_ok, (i_flags & jnp.int32(1)) != 0, s.inst_os
            )
            # Ray-frame switches: the transformed local ray at enter,
            # the (identity) world ray — recomputed with _enter's exact
            # op sequence — at exit.
            lo_w, ld_w, lid_w, _r_w, _l_w = _enter(
                params, e_count, s.entry, s.origin, s.direction
            )
            lo_n = v3lib.where(enter_ok, lo_i, v3lib.where(
                inst_exit, lo_w, s.lo))
            ld_n = v3lib.where(enter_ok, ld_i, v3lib.where(
                inst_exit, ld_w, s.ld))
            lid_n = v3lib.where(enter_ok, lid_i, v3lib.where(
                inst_exit, lid_w, s.lid))
            # Exit fold into the world best (before the entry-level
            # fold below, which rebases on these), then local reset.
            closer_i = fold_i & (dst_i < s.w_dst)
            w_valid_b = s.w_valid | closer_i
            w_dst_b = jnp.where(closer_i, dst_i, s.w_dst)
            w_point_b = v3lib.where(closer_i, point_wi, s.w_point)
            w_normal_b = v3lib.where(closer_i, n_wi, s.w_normal)
            w_back_b = _bsel(closer_i, s.lback, s.w_back)
            w_mesh_b = jnp.where(closer_i, s.lmesh, s.w_mesh)
            lt = jnp.where(inst_exit, _INF, lt)
            lnrm = v3lib.where(inst_exit, zero3, lnrm)
            lback = lback & ~inst_exit
            lmesh = jnp.where(inst_exit, -1, lmesh)
        else:
            cur_inst = in_inst = None
            inst_mesh = inst_scale = inst_cull = inst_os = None
            lo_n, ld_n, lid_n = s.lo, s.ld, s.lid
            w_valid_b, w_dst_b = s.w_valid, s.w_dst
            w_point_b, w_normal_b = s.w_point, s.w_normal
            w_back_b, w_mesh_b = s.w_back, s.w_mesh

        # ---------------- NEXT-MESH: fold + enter --------------------
        fin = ~s.done & (s.entry < e_count) & (cur < 0)
        lvalid = fin & (lmesh >= 0)
        one_sided_e = _sel(params.table, entry_c, e_count, _CP_OS) != 0.0
        lvalid &= ~(one_sided_e & lback)
        lvalid &= scale_e > _EPS
        point_l = s.lo + s.ld * lt
        point_w = (
            _rot_fwd(params.table, entry_c, e_count, point_l * scale_e)
            + _sel_v3(params.table, entry_c, e_count, _CP_POS)
        )
        n_w = v3lib.normalize(_rot_fwd(params.table, entry_c, e_count, lnrm))
        dst = v3lib.length(point_w - s.origin)
        # Rebased on the instance-exit fold (w_*_b aliases s.w_* in the
        # unrolled-chain regime): an exit and an entry completion can
        # land in the same iteration, and the exit's winner must
        # survive into the entry fold's base.
        closer = lvalid & (dst < w_dst_b)
        w_valid = _bsel(fin, w_valid_b | closer, w_valid_b)
        w_dst = jnp.where(closer, dst, w_dst_b)
        w_point = v3lib.where(closer, point_w, w_point_b)
        w_normal = v3lib.where(closer, n_w, w_normal_b)
        w_back = _bsel(closer, lback, w_back_b)
        w_mesh = jnp.where(closer, lmesh, w_mesh_b)

        entry = jnp.where(fin, s.entry + 1, s.entry)
        in_chain = fin & (entry < e_count)
        lt = jnp.where(fin, _INF, lt)
        lnrm = v3lib.where(fin, zero3, lnrm)
        lback = lback & ~fin
        lmesh = jnp.where(fin, -1, lmesh)
    else:
        # no traversal entries: every active lane shades each iter
        stack = s.stack
        cur, cur_leaf, cur_slot = s.cur, s.cur_leaf, s.cur_slot
        lt, lnrm, lback, lmesh = s.lt, s.lnrm, s.lback, s.lmesh
        w_valid, w_dst = s.w_valid, s.w_dst
        w_point, w_normal = s.w_point, s.w_normal
        w_back, w_mesh = s.w_back, s.w_mesh
        entry = s.entry
        in_chain = falses

    # Post-traversal state: the tail below reads everything through
    # ``t`` so it can run MULTIPLE times per iteration (tail_passes).
    rep = dict(
        entry=entry, cur=cur, cur_leaf=cur_leaf, cur_slot=cur_slot,
        stack=stack, lt=lt, lnrm=lnrm, lback=lback, lmesh=lmesh,
        w_valid=w_valid, w_dst=w_dst, w_point=w_point, w_normal=w_normal,
        w_back=w_back, w_mesh=w_mesh,
    )
    if tlas:
        rep.update(
            lo=lo_n, ld=ld_n, lid=lid_n,
            cur_inst=cur_inst, in_inst=in_inst, inst_mesh=inst_mesh,
            inst_scale=inst_scale, inst_cull=inst_cull, inst_os=inst_os,
        )
    t = s._replace(**rep)

    from tpurt.config import MEGA_SKIP_CAP, SELECT_GATHER_THRESHOLD

    def _tail(t: _Lane, entering_in, do_expand: bool = True) -> _Lane:
        """Segment completion: shade -> accumulate/advance -> restart ->
        static stage -> chain enter (with pretest-fail skip). Lanes not
        at the shading stage pass through unchanged, so running the
        tail again immediately completes segments that need no
        traversal (cache replays; rays whose every chain pretest fails
        because the inline static stage already resolved them)."""
        # ---------------- SHADE ---------------------------------------
        shade = ~t.done & (t.entry >= e_count)
        segments = t.segments + shade.astype(jnp.int32)

        res = shade_hit_soa(
            mats, num_meshes, shade,
            t.w_valid, t.w_point, t.w_normal, t.w_back, t.w_mesh,
            t.origin, t.direction, t.throughput, t.light, t.rng, t.bounces,
            max_bounces, present=mat_present, mat_slots=mat_slots,
        )
        invis = t.invis + (shade & res.invisible).astype(jnp.int32)
        continuing = res.continuing & ~(
            res.invisible & (invis > invisible_budget)
        )

        # primary cache store (sample 0, bounce 0)
        if use_cache:
            store = shade & ~t.c_set & (t.bounces == 0) & (t.sample == 0)
            c_set = t.c_set | store
            c_valid = _bsel(store, t.w_valid, t.c_valid)
            c_point = v3lib.where(store, t.w_point, t.c_point)
            c_normal = v3lib.where(store, t.w_normal, t.c_normal)
            c_back = _bsel(store, t.w_back, t.c_back)
            c_mesh = jnp.where(store, t.w_mesh, t.c_mesh)
            c_dst = jnp.where(store, t.w_dst, t.c_dst)
        else:
            # Cache disabled (jitter, or one sample per pixel where a
            # replay can never fire): the fields are None so the 11 cache
            # leaves drop out of the streamed lane state entirely.
            c_set = c_valid = c_point = c_normal = None
            c_back = c_mesh = c_dst = None

        cont = shade & continuing
        path_end = shade & ~continuing
        zero = np.float32(0.0)
        acc = t.acc + V3(
            jnp.where(path_end, res.light.x, zero),
            jnp.where(path_end, res.light.y, zero),
            jnp.where(path_end, res.light.z, zero),
        )
        sample = t.sample + path_end.astype(jnp.int32)
        pix_done = path_end & (sample >= rays_per_pixel)
        if p_count > 1:
            # Quota mode: a lane whose pixel is complete banks its
            # accumulator into the pixel's slot and ADVANCES to its next
            # quota pixel (stride = batch size) instead of idling; only the
            # last quota pixel retires the lane.
            last_pix = t.pixno >= (p_count - 1)
            retire = pix_done & last_pix
            advance = pix_done & ~last_pix
            accs = []
            for k in range(p_count):
                wk = pix_done & (t.pixno == k)
                accs.append(V3(
                    jnp.where(wk, acc.x, t.accs[k].x),
                    jnp.where(wk, acc.y, t.accs[k].y),
                    jnp.where(wk, acc.z, t.accs[k].z),
                ))
            accs = tuple(accs)
            acc = V3(
                jnp.where(pix_done, zero, acc.x),
                jnp.where(pix_done, zero, acc.y),
                jnp.where(pix_done, zero, acc.z),
            )
            pixno = t.pixno + advance.astype(jnp.int32)
            if slot_rays.pix:
                # Table mode (list batches and cross-frame packs): the
                # next pixel comes from per-slot tables, precomputed
                # loop-invariant like the slot directions. Static
                # select chain over slots (advance implies pixno >= 1),
                # indirected through the static slot->table map so
                # periodic packs reuse one frame's tables.
                pm = slot_pix_map or (0,) + tuple(range(p_count - 1))
                adv_pix = slot_rays.pix[pm[1]]
                for k in range(2, p_count):
                    adv_pix = jnp.where(
                        pixno == k, slot_rays.pix[pm[k]], adv_pix
                    )
            else:
                # Signed arithmetic: pixel indices are < 2^24 so i32 is
                # exact.
                adv_pix = jnp.minimum(
                    t.pix.astype(jnp.int32) + np.int32(pixel_stride),
                    np.int32(width * height - 1),  # pad lanes clamp like _flat_coords
                ).astype(jnp.uint32)
            pix = jnp.where(advance, adv_pix, t.pix)
            sample = jnp.where(pix_done, 0, sample)
        else:
            retire = pix_done
            advance = falses
            accs = t.accs
            pixno = t.pixno
            pix = t.pix
        done = t.done | retire
        new_sample = path_end & ~retire

        sample_u = sample.astype(jnp.uint32)
        if p_count > 1:
            # New pixel's primary ray: select the slot's PRECOMPUTED
            # direction (slot_rays come from the same make_ray entry
            # computation as plain batches — recomputing the camera chain
            # in-body is NOT bit-stable, XLA fuses the uv arithmetic
            # differently inside the loop). Static chain over slots;
            # advance implies pixno >= 1. Origins never change (pinhole).
            rm = slot_rd_map or (0,) + tuple(range(p_count - 1))
            rd_n = slot_rays.rd[rm[1]]  # slot 1
            for k in range(2, p_count):
                rd_n = v3lib.where(pixno == k, slot_rays.rd[rm[k]], rd_n)
            ro0 = t.ro0
            rd0 = v3lib.where(advance, rd_n, t.rd0)
        else:
            ro0, rd0 = t.ro0, t.rd0
        ro_s, rd_s = primary_ray_fn(ro0, rd0, pix, sample_u)
        rng = res.rng
        if frames_per_batch > 1:
            # Cross-frame pack: the slot's FRAME OFFSET (a static
            # function of the post-advance slot index) enters the seed.
            # Static select chain, like the slot direction selects
            # (i32 compares + wheres, no division).
            ppf = p_count // frames_per_batch
            f_off = zeros_i
            for k in range(ppf, p_count):
                f_off = jnp.where(pixno == k, np.int32(k // ppf), f_off)
        else:
            f_off = None
        if seed_mode != "reference":
            rng = jnp.where(new_sample, seed_for(pix, sample_u, f_off), rng)
        elif p_count > 1:
            # Reference seed mode draws one seed per PIXEL (the stream then
            # runs across its samples, Trace.cl:632-641) — re-seed on
            # advance only.
            rng = jnp.where(advance, seed_for(pix, sample_u, f_off), rng)

        origin = v3lib.where(new_sample, ro_s, res.origin)
        direction = v3lib.where(new_sample, rd_s, res.direction)
        one = np.float32(1.0)
        throughput = V3(
            jnp.where(new_sample, one, res.throughput.x),
            jnp.where(new_sample, one, res.throughput.y),
            jnp.where(new_sample, one, res.throughput.z),
        )
        light = V3(
            jnp.where(new_sample, zero, res.light.x),
            jnp.where(new_sample, zero, res.light.y),
            jnp.where(new_sample, zero, res.light.z),
        )
        bounces = jnp.where(new_sample, 0, res.bounces)
        invis = jnp.where(new_sample, 0, invis)

        # cached primary replay: new samples with a cache skip the chain
        # (a quota advance invalidates the cache — it belongs to the
        # finished pixel)
        if use_cache:
            c_set = c_set & ~advance
            replay = new_sample & c_set
        else:
            replay = falses
        restart = cont | (new_sample & ~replay)
        entry = jnp.where(restart, 0, t.entry)
        stack = tuple(
            jnp.where(restart, _EMPTY, slot_arr) for slot_arr in t.stack
        )

        # ---- world-best reset + static stage + cached replay ----------
        # (before `entering` so the root pretest sees the seeded w_dst)
        w_valid = t.w_valid & ~shade
        w_dst = jnp.where(shade, _INF, t.w_dst)
        w_mesh = jnp.where(shade, -1, t.w_mesh)
        w_point, w_normal, w_back = t.w_point, t.w_normal, t.w_back

        sv, sd, sp, sn, sb, sm = _static_stage(
            srows, s_cull, s_onesided, s_owner, mats, num_meshes, restart,
            origin, direction
        )
        w_valid = _bsel(restart, sv, w_valid)
        w_dst = jnp.where(restart, sd, w_dst)
        w_point = v3lib.where(restart, sp, w_point)
        w_normal = v3lib.where(restart, sn, w_normal)
        w_back = _bsel(restart, sb, w_back)
        w_mesh = jnp.where(restart, sm, w_mesh)

        if use_cache:
            entry = jnp.where(replay, e_count, entry)
            w_valid = _bsel(replay, c_valid, w_valid)
            w_dst = jnp.where(replay, c_dst, w_dst)
            w_point = v3lib.where(replay, c_point, w_point)
            w_normal = v3lib.where(replay, c_normal, w_normal)
            w_back = _bsel(replay, c_back, w_back)
            w_mesh = jnp.where(replay, c_mesh, w_mesh)

        # ONE local-frame entry computation serves both transitions
        # (advancing to the next chain entry and restarting at entry 0
        # with the bounced/new ray): by this point `entry` and
        # origin/direction hold their final values for the pass.
        cur, cur_leaf, cur_slot = t.cur, t.cur_leaf, t.cur_slot
        if e_count:
            entering = entering_in | restart
            lo2, ld2, lid2, root2, root_leaf2 = _enter(
                params, e_count, entry, origin, direction
            )
            # Root pretest: skip the whole subtree when the entry's
            # local root box lies beyond the already-found best hit
            # (seeded by the static stage) or misses the ray.
            pre_ok = _pretest(params, e_count, entry, lo2, lid2, w_dst)

            # CHAIN SKIP: a failed pretest advances the lane's entry
            # IN-PLACE (the fold it skips is trivial by invariant —
            # traversal never ran, so lt/lmesh are reset) instead of
            # burning a whole gather iteration per failed entry. Each
            # unrolled round evaluates the next entry for still-failing
            # lanes; the evaluation order per lane is exactly the
            # iterated fold's, so trajectories are bitwise-identical.
            cur_e = entry
            pend = entering & ~pre_ok
            ok_e = pre_ok
            lo_e, ld_e, lid_e = lo2, ld2, lid2
            root_e, leaf_e = root2, root_leaf2
            n_skip = (
                min(e_count - 1, MEGA_SKIP_CAP)
                if e_count <= SELECT_GATHER_THRESHOLD else 0
            )
            for _ in range(n_skip):
                cur_e = jnp.where(pend, cur_e + 1, cur_e)
                valid2 = pend & (cur_e < e_count)
                lo3, ld3, lid3, root3, leaf3 = _enter(
                    params, e_count, cur_e, origin, direction
                )
                ok3 = _pretest(params, e_count, cur_e, lo3, lid3, w_dst)
                lo_e = v3lib.where(valid2, lo3, lo_e)
                ld_e = v3lib.where(valid2, ld3, ld_e)
                lid_e = v3lib.where(valid2, lid3, lid_e)
                root_e = jnp.where(valid2, root3, root_e)
                leaf_e = _bsel(valid2, leaf3, leaf_e)
                ok_e = _bsel(valid2, ok3, ok_e)
                pend = valid2 & ~ok3
            # A failure at the LAST chain entry needs no further
            # evaluation: the lane is shade-ready right now. Lanes that
            # exhausted the skip cap mid-chain stay at their (evaluated,
            # failed) entry with cur = -1; the per-iteration fold
            # resumes them exactly as before the skip existed.
            adv_last = pend & (cur_e == e_count - 1)
            cur_e = jnp.where(adv_last, cur_e + 1, cur_e)
            entry = jnp.where(entering, cur_e, entry)

            root_or_skip = jnp.where(ok_e, root_e, -1)
            lo = v3lib.where(entering, lo_e, t.lo)
            ld = v3lib.where(entering, ld_e, t.ld)
            lid = v3lib.where(entering, lid_e, t.lid)
            cur = jnp.where(entering, root_or_skip, cur)
            cur_leaf = _bsel(entering, leaf_e & ok_e, cur_leaf)
            cur_slot = jnp.where(entering, 0, cur_slot)
            # ROOT EXPANSION (config.MEGA_ROOT_EXPAND): entries whose
            # root is a node row run its 32-child test right here from
            # precomputed scalars and descend straight to the first hit
            # child — the gather the next iteration would have spent on
            # the (static) root row never happens.
            for e_x in range(e_count):
                # dense mode never walks rows: cur >= 0 only flags an
                # unresolved entry for the sweep — do not expand.
                if dense_hit is not None or not do_expand:
                    break
                if e_x >= len(params.expand) or not params.expand[e_x]:
                    continue
                m_x = entering & ok_e & (entry == e_x)
                cur, cur_leaf, stack = _expand_root(
                    params, e_x, m_x, lo, ld, lid, t.lt, w_dst,
                    cur, cur_leaf, stack, s_depth, arity=arity,
                )
        else:
            lo, ld, lid = t.lo, t.ld, t.lid

        if tlas:
            # A lane that enters a chain entry starts at that entry's
            # root (always a node row) in the world/identity frame.
            cur_inst_t = t.cur_inst & ~entering
            in_inst_t = t.in_inst & ~entering
        else:
            cur_inst_t, in_inst_t = t.cur_inst, t.in_inst  # None

        return _Lane(
            iters=t.iters,
            ro0=ro0, rd0=rd0, pix=pix, pixno=pixno, lane0=t.lane0,
            sample=sample, acc=acc, accs=accs, rng=rng, done=done,
            segments=segments,
            origin=origin, direction=direction, throughput=throughput,
            light=light, bounces=bounces, invis=invis,
            entry=entry,
            cur=cur, cur_leaf=cur_leaf, cur_slot=cur_slot, stack=stack,
            lo=lo, ld=ld, lid=lid,
            lt=t.lt, lnrm=t.lnrm, lback=t.lback, lmesh=t.lmesh,
            w_valid=w_valid, w_dst=w_dst, w_point=w_point, w_normal=w_normal,
            w_back=w_back, w_mesh=w_mesh,
            c_set=c_set, c_valid=c_valid, c_point=c_point, c_normal=c_normal,
            c_back=c_back, c_mesh=c_mesh, c_dst=c_dst,
            in_inst=in_inst_t, cur_inst=cur_inst_t, inst_mesh=t.inst_mesh,
            inst_scale=t.inst_scale, inst_cull=t.inst_cull,
            inst_os=t.inst_os,
        )

    # Pass 1 finishes segments whose traversal completed this iteration;
    # passes 2..N immediately finish segments the restart resolved
    # WITHOUT traversal (replays; all-pretests-failed rays), which would
    # otherwise idle a full gather iteration each (measured 0.9 of 2.14
    # live lane-iterations/segment on the bunny ladder).
    expand_passes = _config_mod().MEGA_EXPAND_PASSES
    t = _tail(t, in_chain, do_expand=expand_passes >= 1)
    for p in range(1, max(1, tail_passes)):
        t = _tail(t, falses, do_expand=p < expand_passes)
    return t


def _slots_ok(scene: Scene, tlas: bool, e_count: int,
              num_meshes: int) -> bool:
    """TLAS + material-slot scenes keep the select-chain fetches at any
    mesh count the dedup makes viable: the only O(K) chain left is the
    single-i32 mesh->slot map in the shade fetch — everything else is
    O(entries) or O(unique materials). The 4x bound caps compile
    growth; past it the transposed-gather fetch takes over and the
    slots are NOT threaded (run_megakernel body_kw)."""
    from tpurt.config import SELECT_GATHER_THRESHOLD

    return (
        tlas and bool(scene.mesh_mat_slot)
        and num_meshes <= 4 * SELECT_GATHER_THRESHOLD
    )


def run_megakernel(
    scene: Scene,
    ro0,  # (R, 3) primary origins (or V3)
    rd0,  # (R, 3) primary directions (or V3)
    pixel_index: jnp.ndarray,  # (R,) u32
    frame_index,  # scalar i32
    rays_per_pixel: int,
    max_bounces: int,
    seed_mode: str,
    invisible_budget: int,
    sample_offset=0,
    subpixel_jitter: bool = False,
    camera=None,
    width: int = 0,
    height: int = 0,
    initial_state: "_Lane" = None,
    max_iterations: int = None,
    return_state: bool = False,
    pixels_per_lane: int = 1,
    pixel_stride: int = None,
    debug_counters: bool = False,
    interleave: int = 1,
    tail_passes: int = 1,
    schedule: str = "inline",
    dense: bool = False,
    pixel_list=None,
    frames_per_batch: int = 1,
    cameras=None,
):
    """Returns (mean radiance (R*pixels_per_lane, 3), total path
    segments (scalar f32), iterations) — or the raw lane state when
    ``return_state`` (used by the host-staged compaction driver in
    render/renderer.py, which caps iterations, shrinks the batch to the
    surviving lanes, and resumes — including quota batches).

    ``tail_passes`` > 1 runs the loop body's segment-completion tail
    (shade -> restart -> static stage -> chain enter) that many times
    per iteration, so segments that complete WITHOUT traversal (cache
    replays; rays whose every chain pretest fails) finish in the same
    iteration instead of idling a gather each. Bitwise-identical to 1.

    ``pixels_per_lane`` > 1 gives each lane a quota of pixels at stride
    ``pixel_stride`` (default R; lane i: pix[i], pix[i]+stride, ...);
    radiance row k*R+i is quota slot k of lane i — exactly pixel
    start+k*stride+i for the flat path's row-major slices. A COMPACTED
    resume (initial_state narrower than the original batch) must pass
    the ORIGINAL stride and, as ``pixel_index``, each lane's slot-0
    pixel (pix - pixno*stride) so the slot ray table rebuilds for the
    right pixels.

    ``interleave`` > 1 splits the batch into that many independent
    sub-batches stepped back-to-back per while_loop iteration so each
    sub-batch's row gather can overlap the previous one's body.
    Bitwise-identical to interleave=1; falls back to 1 when the batch
    does not split into 128-lane-aligned parts.

    ``pixel_list`` ((N,) u32 device array) switches quota mode to LIST
    form: lane i's quota pixels are pixel_list[i + k*stride] (clamped
    to the last entry) instead of the affine pix + k*stride — the
    cascade-respread driver re-traces an arbitrary packed set of
    incomplete pixels with full quota/staging machinery this way.
    ``pixel_index`` must then be each lane's slot-0 pixel
    (pixel_list[:R] for a fresh batch); the lane's original index rides
    in the state (lane0) so compacted resumes rebuild slot tables, and
    radiance row k*R+i corresponds to pixel_list[i + k*stride] — the
    same positional layout as the affine flat path. Requires
    pixels_per_lane > 1 handling only when quota > 1; with quota 1 the
    list is ignored (callers trace pixel_index directly).

    ``frames_per_batch`` > 1 packs that many FRAMES into one launch
    (cross-frame lane packing): quota slot k covers frame
    k // (P/frames) at pixel pix + (k mod P/frames)*stride, with the
    slot's frame offset entering the seed and its primary direction
    coming from ``cameras[frame]`` (``cameras`` is a per-frame Camera
    tuple; None = one static camera for every packed frame, the
    progressive-accumulation shape). Radiance rows for frame f are
    [f*(P/frames)*R, (f+1)*(P/frames)*R) — each frame bitwise-identical
    to rendering it alone (trajectories are pure functions of
    (pixel, frame, sample); packing only changes which lane runs them).
    One frame's straggler tail overlaps the next frame's ramp, so the
    per-frame iteration count drops toward the per-lane mean work.
    Incompatible with subpixel_jitter and pixel_list. Per-frame cameras
    must share one POSITION (slot advance re-selects the primary
    direction only; origins are not slotted) — rotation/fov animation
    packs, dolly moves do not (drivers check and fall back).
    """
    if not isinstance(ro0, V3):
        ro0 = v3lib.from_rows(ro0)
    if not isinstance(rd0, V3):
        rd0 = v3lib.from_rows(rd0)
    r = ro0.x.shape[0]
    p_count = int(pixels_per_lane)
    frames_per_batch = max(1, int(frames_per_batch))
    if frames_per_batch > 1:
        assert p_count % frames_per_batch == 0, (
            "pixels_per_lane must split evenly over frames_per_batch")
        assert not subpixel_jitter and pixel_list is None, (
            "cross-frame packing: jitter/list mode unsupported")
        assert cameras is None or len(cameras) == frames_per_batch
        # share_rd's frame-start direction table reuses the ENTRY rd0
        # array verbatim (bit-stability); a compacted resume's rd0 is
        # mid-quota, so packing runs fresh plain batches only.
        assert initial_state is None, (
            "cross-frame packing: compacted resume unsupported")
    if max_bounces <= 0 and not return_state:
        return (
            jnp.zeros((r * p_count, 3), _F32), jnp.float32(0.0),
            jnp.int32(0),
        )

    e_count = len(scene.mega_chain)
    params = _chain_params(scene) if e_count else None
    tlas = bool(getattr(scene, "mega_tlas", False))
    assert not (tlas and dense), (
        "dense (brute-force) mode walks chain entries per mesh; freeze "
        "TLAS scenes with MEGA_TLAS_THRESHOLD above the instance count "
        "to use it"
    )
    # Up to TWO entries per tree level (a resolved 2nd child + a parent
    # resume), so the register stack doubles the per-level budget.
    s_depth = 2 * scene.mega_stack_depth
    # The bounce-0 cache replays sample 0's primary intersection for
    # later samples of the same pixel — pointless at one sample per
    # pixel, and wrong under per-sample jitter.
    use_cache = not subpixel_jitter and rays_per_pixel > 1
    mats = pack_materials(scene)
    srows = scene.mega_static_rows
    s_cull = scene.mega_static_cull
    s_onesided = scene.mega_static_onesided
    s_owner = scene.mega_static_owner
    num_meshes = scene.num_meshes

    def primary_ray(p_ro0: V3, p_rd0: V3, p_pix, sample_id):
        if not subpixel_jitter:
            return p_ro0, p_rd0
        from tpurt.core.camera import make_ray, pixel_uv

        xs = p_pix.astype(jnp.int32) % jnp.int32(width)
        ys = p_pix.astype(jnp.int32) // jnp.int32(width)
        uv = pixel_uv(xs, ys, width, height)
        jseed = rnglib.make_seed(
            p_pix ^ jnp.uint32(0xA511E9B3), frame_index, sample_id
        )
        jseed, jx = rnglib.random_value(jseed)
        jseed, jy = rnglib.random_value(jseed)
        uv = uv + jnp.stack([(jx - 0.5) / width, (jy - 0.5) / height], axis=-1)
        ro, rd = make_ray(camera, uv)
        return v3lib.from_rows(ro), v3lib.from_rows(rd)

    def seed_for(p_pix, sample_id):
        if seed_mode == "reference":
            return rnglib.make_seed(p_pix, frame_index, 0)
        return rnglib.make_seed(
            p_pix, frame_index, sample_id + jnp.uint32(sample_offset)
        )

    zeros = jnp.zeros((r,), _F32)
    ones = jnp.ones((r,), _F32)
    zero3 = V3(zeros, zeros, zeros)
    zeros_i = jnp.zeros((r,), jnp.int32)
    falses = jnp.zeros((r,), bool)
    trues = jnp.ones((r,), bool)
    empty_slot = jnp.full((r,), _EMPTY, jnp.uint32)
    empty_stack = tuple(empty_slot for _ in range(s_depth))

    # Seed the world best with the inline static stage for the primary
    # segment, then enter the chain (with root pretest).
    sv, sd, sp, sn, sb, sm = _static_stage(
        srows, s_cull, s_onesided, s_owner, mats, num_meshes, trues, ro0, rd0
    )
    if e_count:
        lo0, ld0, lid0, root0, root_leaf0 = _enter(
            params, e_count, zeros_i, ro0, rd0
        )
        pre_ok0 = _pretest(params, e_count, zeros_i, lo0, lid0, sd)
        cur0 = jnp.where(pre_ok0, root0, -1)
        cur_leaf0 = root_leaf0 & (cur0 >= 0)
        stack0 = tuple(empty_slot for _ in range(s_depth))
        if params.expand and params.expand[0] and not dense:
            # Primary segments start at entry 0: expand its root here
            # (same math as the tail's enter-time expansion).
            cur0, cur_leaf0, stack0 = _expand_root(
                params, 0, pre_ok0, lo0, ld0, lid0,
                jnp.full((r,), _INF, _F32), sd,
                cur0, cur_leaf0, stack0, s_depth,
                arity=int(getattr(scene, "mega_arity", 32)),
            )
    else:
        lo0, ld0, lid0 = ro0, rd0, V3(1.0 / rd0.x, 1.0 / rd0.y, 1.0 / rd0.z)
        cur0 = zeros_i - 1
        cur_leaf0 = falses
        stack0 = tuple(empty_slot for _ in range(s_depth))

    if debug_counters:
        assert max_iterations is None
    list_mode = pixel_list is not None and p_count > 1
    lane = _Lane(
        iters=jnp.zeros((6,), jnp.int32) if debug_counters else jnp.int32(0),
        ro0=ro0, rd0=rd0, pix=pixel_index, pixno=zeros_i,
        lane0=jnp.arange(r, dtype=jnp.int32) if list_mode else None,
        sample=zeros_i, acc=zero3,
        accs=tuple(zero3 for _ in range(p_count)) if p_count > 1 else (),
        rng=seed_for(pixel_index, jnp.uint32(0)), done=falses,
        segments=zeros_i,
        origin=ro0, direction=rd0,
        throughput=V3(ones, ones, ones), light=zero3,
        bounces=zeros_i, invis=zeros_i,
        entry=zeros_i,
        cur=cur0, cur_leaf=cur_leaf0, cur_slot=zeros_i,
        stack=stack0,
        lo=lo0, ld=ld0, lid=lid0,
        lt=jnp.full((r,), _INF, _F32), lnrm=zero3, lback=falses,
        lmesh=zeros_i - 1,
        w_valid=sv, w_dst=sd,
        w_point=sp, w_normal=sn, w_back=sb, w_mesh=sm,
        c_set=falses if use_cache else None,
        c_valid=falses if use_cache else None,
        c_point=zero3 if use_cache else None,
        c_normal=zero3 if use_cache else None,
        c_back=falses if use_cache else None,
        c_mesh=zeros_i - 1 if use_cache else None,
        c_dst=jnp.full((r,), _INF, _F32) if use_cache else None,
        # TLAS regime lane state (chain-entry roots are node rows, so
        # cur_inst starts False; lanes start outside any instance).
        in_inst=falses if tlas else None,
        cur_inst=falses if tlas else None,
        inst_mesh=zeros_i - 1 if tlas else None,
        inst_scale=ones if tlas else None,
        inst_cull=falses if tlas else None,
        inst_os=falses if tlas else None,
    )

    if initial_state is not None:
        lane = initial_state
    iter_cap = None if max_iterations is None else lane.iters + max_iterations

    if p_count > 1:
        # Per-slot primary rays, precomputed with the SAME
        # pixel_uv+make_ray entry chain as plain batches (bit-stable;
        # an in-body recomputation is not — XLA fuses the uv arithmetic
        # differently inside the while_loop). Loop-invariant captures,
        # selected by pixno at advance time. In list mode the per-slot
        # PIXELS are precomputed the same way (pixel_list[lane0 +
        # k*stride], pad lanes clamp to the last entry).
        from tpurt.core.camera import make_ray as _mk, pixel_uv as _puv

        stride = r if pixel_stride is None else int(pixel_stride)
        ppf = p_count // frames_per_batch  # pixels per lane per frame
        share_rd = frames_per_batch > 1 and cameras is None
        rd_tabs = []  # UNIQUE direction tables (V3)
        pix_tabs = []  # UNIQUE pixel-id tables ((R,) u32)
        rd_map = [0] * p_count  # slot k -> rd_tabs index (k >= 1)
        pix_map = [0] * p_count
        if list_mode:
            l0 = lane.lane0  # initial_state already replaced lane
            n_list = pixel_list.shape[0]
        pi0 = pixel_index.astype(jnp.int32)

        def _slot_pixel(kk):  # within-frame slot kk's pixel, i32
            return jnp.minimum(
                pi0 + np.int32(kk * stride), np.int32(width * height - 1)
            )

        def _slot_rd(pk, cam_k):
            xs_k = pk % jnp.int32(width)
            ys_k = pk // jnp.int32(width)
            _ro_k, rd_k = _mk(cam_k, _puv(xs_k, ys_k, width, height))
            return v3lib.from_rows(rd_k)

        if frames_per_batch > 1:
            # Cross-frame pack: pixel tables are PERIODIC (slot k's
            # pixel == slot k mod ppf's), so only one frame's worth of
            # tables ride as operands; with a static camera the
            # direction tables share the same way (frame-start slots
            # reuse the lane's entry direction). Keeps the body's
            # operand footprint ~independent of the pack depth.
            for kk in range(ppf):
                pix_tabs.append(_slot_pixel(kk).astype(jnp.uint32))
            if share_rd:
                rd_tabs.append(rd0)  # entry direction (frame-start)
                for kk in range(1, ppf):
                    rd_tabs.append(_slot_rd(_slot_pixel(kk), camera))
            for k in range(1, p_count):
                pix_map[k] = k % ppf
                if share_rd:
                    rd_map[k] = k % ppf
                else:
                    rd_tabs.append(_slot_rd(
                        _slot_pixel(k % ppf), cameras[k // ppf]
                    ))
                    rd_map[k] = len(rd_tabs) - 1
        else:
            for k in range(1, p_count):
                if list_mode:
                    pk = pixel_list[jnp.minimum(
                        l0 + np.int32(k * stride), np.int32(n_list - 1)
                    )].astype(jnp.int32)
                    pix_tabs.append(pk.astype(jnp.uint32))
                    pix_map[k] = len(pix_tabs) - 1
                else:
                    pk = _slot_pixel(k)  # affine advance; no pix table
                rd_tabs.append(_slot_rd(pk, camera))
                rd_map[k] = len(rd_tabs) - 1
        slot_rays = _Slots(tuple(rd_tabs), tuple(pix_tabs))
        slot_rd_map, slot_pix_map = tuple(rd_map), tuple(pix_map)
    else:
        slot_rays = _Slots((), ())
        slot_rd_map = slot_pix_map = None
    # lane0 is loop-invariant and never read in the body — keep it out
    # of the while_loop carry (it would stream through device memory
    # every iteration) and reattach on exit for the staged driver's
    # compaction slicing.
    lane0_keep = lane.lane0
    if lane0_keep is not None:
        lane = lane._replace(lane0=None)
    body_kw = dict(
        e_count=e_count, s_depth=s_depth, num_meshes=num_meshes,
        s_cull=s_cull, s_onesided=s_onesided, s_owner=s_owner,
        max_bounces=max_bounces, rays_per_pixel=rays_per_pixel,
        seed_mode=seed_mode, invisible_budget=invisible_budget,
        use_cache=use_cache,
        p_count=p_count,
        pixel_stride=r if pixel_stride is None else int(pixel_stride),
        width=width, height=height,
        tail_passes=max(1, int(tail_passes)),
        frames_per_batch=frames_per_batch,
        slot_rd_map=slot_rd_map, slot_pix_map=slot_pix_map,
        mat_present=(
            _shading.mat_types_present(scene)
            if _config_mod().MEGA_MAT_PRUNE else None
        ),
        bounds_fmt=scene.mega_bounds_fmt,
        leaf_tris=int(getattr(scene, "mega_leaf_tris", 8)),
        arity=int(getattr(scene, "mega_arity", 32)),
        tlas=tlas,
        # In the TLAS regime, only the fused static entry's leaf rows
        # carry real owner ids in their aux words (instance leaves are
        # resolved through the lane's stashed inst_mesh/inst_cull), so
        # the per-slot owner-cull select chain shrinks to the static
        # members instead of looping all K meshes (an empty tuple when
        # there is no static entry).
        static_leaf_owners=(
            (scene.mega_chain_members[0]
             if e_count and scene.mega_chain[0][0] == -1 else ())
            if tlas else None
        ),
        # Freeze-time material dedup: O(K + 11U) shade fetch. Threaded
        # only where the slot regime is the winner (see _slots_ok
        # below): small-K scenes keep their exact measured program, and
        # the huge-K XLA fallback keeps its single transposed gather
        # (an O(K) mesh->slot select chain would replace it otherwise).
        mat_slots=(
            (scene.mesh_mat_slot, scene.mat_slot_rep)
            if _slots_ok(scene, tlas, e_count, num_meshes) else None
        ),
    )

    dense = bool(dense) and e_count > 0
    rows_t = scene.mega_rows.T if e_count and not dense else None  # (W, N)

    dense_table = None
    if dense:
        from tpurt.render.plucker_fused import (
            build_dense_table, sweep_entry_local,
        )

        # Brute-force mode (the reference's UseBVH=false dense loop,
        # Trace.cl:276-317 + 444-482): every iteration resolves each
        # live lane's whole current chain entry with ONE fused Plücker
        # sweep (render/plucker_fused.py); the surrounding per-lane math
        # is the ordinary body. The table build is loop-invariant; XLA
        # hoists it out of the while_loop.
        dense_table = build_dense_table(scene)
        interleave = 1
        assert not debug_counters, "debug_counters unsupported in dense mode"

        def _dense_hit(s: _Lane):
            """Sweep + exact winner recompute -> (t, normal, backface,
            mesh/-1). Mirrors intersect._finalize_local: acceptance and
            t come from the fast sweep, shading data from the exact MT
            on the single winner triangle (Trace.cl:276-317)."""
            from tpurt.render.intersect import _mt_single

            ec = jnp.minimum(s.entry, e_count - 1)
            t_sw, colw = sweep_entry_local(s.lo, s.ld, ec, dense_table)
            valid = colw >= 0
            cc = jnp.maximum(colw, 0)
            tri = dense_table.ids[cc]
            owner = dense_table.owner[cc]
            cull_w = dense_table.cull[cc] != 0.0
            lo_rows = v3lib.to_rows(s.lo)
            ld_rows = v3lib.to_rows(s.ld)
            ok, _t_e, n, back = _mt_single(
                lo_rows, ld_rows,
                scene.tri_pos_a[tri], scene.tri_pos_b[tri],
                scene.tri_pos_c[tri],
                scene.tri_nrm_a[tri], scene.tri_nrm_b[tri],
                scene.tri_nrm_c[tri],
                cull_w,
            )
            d_mesh = jnp.where(valid & ok, owner.astype(jnp.int32), -1)
            return t_sw, v3lib.from_rows(n), back, d_mesh

    # Interleaved sub-batches: split the R lanes into k INDEPENDENT
    # sub-states stepped back-to-back inside one while_loop iteration
    # (gather_0, body_0, gather_1, body_1, ...). Sub-state j's gather
    # depends only on j's previous body, so the scheduler may overlap
    # it with sub-state j-1's body. Per-lane trajectories are
    # untouched, so results are bitwise-identical to interleave=1; the
    # loop still runs until ALL sub-batches drain (same idle
    # accounting). Sub-batches narrower than MEGA_INTERLEAVE_FLOOR
    # (config.py) are not split further — notably the staged
    # schedule's narrow tail stages, which inherit the frame config's
    # interleave. Fall to the LARGEST admissible split rather than
    # straight to 1 so a frame config tuned for full batches still
    # splits its half-width stages.
    k_il = max(1, int(interleave))
    while k_il > 1 and (
        r % k_il != 0
        or (r // k_il) % 128 != 0  # 128-lane-aligned sub-batches
        or r // k_il < _config_mod().MEGA_INTERLEAVE_FLOOR
    ):
        k_il -= 1
    if debug_counters:
        assert k_il == 1, "debug_counters requires interleave=1"
    m_il = r // k_il

    def _sub(tree, j):
        return jax.tree_util.tree_map(
            lambda a: (
                a[j * m_il : (j + 1) * m_il]
                if getattr(a, "ndim", 0) >= 1 and a.shape[0] == r
                else a
            ),
            tree,
        )

    def _gather(s: _Lane):
        """Issue sub-batch s's row gather. Hoisted out of the bodies so
        the drivers below control its PROGRAM POSITION: emitted for all
        sub-batches before any body runs ("gfirst"), or carried one
        body-step ahead of its consumer ("carry") — either way the
        gather gets an independent body to overlap with instead of its
        consumer being the very next op."""
        if not e_count or dense:
            return None  # dense mode sweeps; there is no row bank walk
        trav = ~s.done & (s.entry < e_count) & (s.cur >= 0)
        idx = jnp.where(trav, s.cur, 0)
        # Gather along the minor axis of the PRE-transposed bank: the
        # (W, R) layout keeps each column a contiguous (R,) lane
        # vector, and the one transpose is loop-invariant (hoisted)
        # instead of per-iteration.
        return rows_t[:, idx]  # (W, R)

    if debug_counters:
        def body(s: _Lane, rowt) -> _Lane:
            # Instrumented body: same math, plus lane-iteration
            # tallies (bit-identical trajectories, so counts measured
            # here describe the uninstrumented body too).
            live = ~s.done
            trav = live & (s.entry < e_count) & (s.cur >= 0)
            node = trav & ~s.cur_leaf
            leaf = trav & s.cur_leaf
            shade = live & (s.entry >= e_count)
            enter = live & (s.entry < e_count) & (s.cur < 0)
            # i32 on purpose: totals stay < 2^31.
            cnt = lambda m: jnp.sum(m.astype(jnp.int32))
            tallies = s.iters + jnp.stack([
                jnp.int32(1), cnt(live), cnt(node), cnt(leaf), cnt(shade),
                cnt(enter),
            ])
            col = (lambda j: rowt[j]) if rowt is not None else None
            s2 = _body_math(
                s, col, srows, mats, params, slot_rays, frame_index,
                sample_offset, primary_ray, **body_kw,
            )
            return s2._replace(iters=tallies)

        bodies = [body]
    else:
        bodies = []
        for j in range(k_il):
            def body(s: _Lane, rowt, slot_rays=_sub(slot_rays, j)) -> _Lane:
                col = (lambda i: rowt[i]) if rowt is not None else None
                dh = _dense_hit(s) if dense_table is not None else None
                s2 = _body_math(
                    s, col, srows, mats, params, slot_rays, frame_index,
                    sample_offset, primary_ray, dense_hit=dh, **body_kw,
                )
                return s2._replace(iters=s.iters + 1)

            bodies.append(body)

    if k_il == 1:
        def cond(s: _Lane):
            live = jnp.any(~s.done)
            if iter_cap is not None:
                live &= s.iters < iter_cap
            return live

        final = lax.while_loop(
            cond, lambda s: bodies[0](s, _gather(s)), lane
        )
    else:
        subs = tuple(_sub(lane, j) for j in range(k_il))
        carry_rows = schedule == "carry" and e_count > 0

        def cond(ss):
            if carry_rows:
                ss = ss[0]
            live = jnp.any(~ss[0].done)
            for s in ss[1:]:
                live |= jnp.any(~s.done)
            if iter_cap is not None:
                live &= ss[0].iters < iter_cap
            return live

        if carry_rows:
            # Software-pipelined schedule: the loop carries each sub-
            # batch's GATHERED ROWS, issued one body-step ahead of the
            # body that consumes them — body_j(step i) runs while
            # gather_{j+1}(step i) is in flight, so every row gather has
            # a full body to hide behind (the in-line schedule gives it
            # nothing to overlap: its consumer is the very next op).
            # Bitwise-identical: same per-lane sequence, rows just
            # fetched one program point earlier.
            def body_step(carry):
                ss, rowts = list(carry[0]), list(carry[1])
                for j in range(k_il):
                    ss[j] = bodies[j](ss[j], rowts[j])
                    rowts[j] = _gather(ss[j])
                return (tuple(ss), tuple(rowts))

            carry0 = (subs, tuple(_gather(s) for s in subs))
            finals = lax.while_loop(cond, body_step, carry0)[0]
        else:
            def body_step(ss):
                ss = list(ss)
                if schedule == "gfirst":
                    # All gathers first (independent gathers), then
                    # bodies. Kept for A/B measurement.
                    rowts = [_gather(ss[j]) for j in range(k_il)]
                    for j in range(k_il):
                        ss[j] = bodies[j](ss[j], rowts[j])
                elif schedule == "pair2":
                    # Pairs of sub-batches: both gathers, then both
                    # bodies — two row gathers in flight at once while
                    # the pair's bodies cover the NEXT pair's gathers.
                    for g in range(0, k_il, 2):
                        pair = range(g, min(g + 2, k_il))
                        rowts = [_gather(ss[j]) for j in pair]
                        for t, j in enumerate(pair):
                            ss[j] = bodies[j](ss[j], rowts[t])
                else:
                    # "inline": each sub-batch's gather is emitted
                    # immediately before its own body, so sub-batch
                    # j's gather may overlap j-1's body.
                    for j in range(k_il):
                        ss[j] = bodies[j](ss[j], _gather(ss[j]))
                return tuple(ss)

            finals = lax.while_loop(cond, body_step, subs)
        # Re-assemble the full-width state (sub j held lanes
        # [j*m, (j+1)*m)) so callers — the staged-compaction driver and
        # the finalisers below — see exactly the interleave=1 layout.
        final = jax.tree_util.tree_map(
            lambda *xs: (
                jnp.concatenate(xs)
                if getattr(xs[0], "ndim", 0) >= 1 and xs[0].shape[0] == m_il
                else xs[0]
            ),
            *finals,
        )
    if lane0_keep is not None:
        final = final._replace(lane0=lane0_keep)
    if return_state:
        return final
    if p_count > 1:
        # (P, R, 3) -> (P*R, 3): row k*R+i is lane i's quota slot k,
        # i.e. pixel start + k*R + i in the flat path's row-major order.
        mean = jnp.concatenate(
            [v3lib.to_rows(a) for a in final.accs]
        ) / jnp.float32(rays_per_pixel)
    else:
        mean = v3lib.to_rows(final.acc) / jnp.float32(rays_per_pixel)
    return mean, jnp.sum(final.segments.astype(jnp.float32)), final.iters
