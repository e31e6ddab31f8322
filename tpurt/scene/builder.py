"""SceneBuilder: host-side scene assembly -> frozen device Scene.

Replaces the reference's mutable globals (meshList / triangleList /
nodeList, src/readobj.hpp:91-94) and its scene-assembly helpers:

  * ``load_obj``         — loadMeshFromOBJFile (readobj.hpp:270-376),
                           including the per-file mesh cache (fixed: the
                           reference caches the wrong index space,
                           readobj.hpp:272-274);
  * ``add_quad``         — addQuad (readobj.hpp:378-408);
  * ``add_cornell_box``  — addCornellBoxToScene (image.hpp:401-449),
                           geometry and materials reproduced exactly;
  * ``freeze``           — the generateBuffers upload (image.hpp:97-175),
                           but to SoA jnp arrays plus threaded BVH links.

Mesh ordering matters for closest-hit tie-breaking and is preserved: the
driver appends the 7 Cornell quads first and the model mesh last
(main.cpp:272,298).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpurt.accel.bvh import BVHNodes, build_bvh, bvh_stats, thread_links


def _subtree_indices(child, ntris, root):
    stack = [int(root)]
    while stack:
        idx = stack.pop()
        yield idx
        if ntris[idx] == 0:
            stack.append(int(child[idx]))
            stack.append(int(child[idx]) + 1)


def _quantize_boxes(lo, hi, gmin, gmax):
    """Conservative uint16 quantisation of boxes onto the grid spanned
    by [gmin, gmax]: decoded boxes always contain the originals."""
    lo64 = np.asarray(lo, np.float64).reshape(-1, 3)
    hi64 = np.asarray(hi, np.float64).reshape(-1, 3)
    gmin64 = np.asarray(gmin, np.float64)
    scale = (np.asarray(gmax, np.float64) - gmin64) / 65535.0
    safe = np.where(scale > 0, scale, 1.0)
    ql = np.clip(np.floor((lo64 - gmin64) / safe), 0, 65535)
    qh = np.clip(np.ceil((hi64 - gmin64) / safe), 0, 65535)
    scale32 = np.where(scale > 0, scale, 0.0).astype(np.float32)
    gmin32 = gmin64.astype(np.float32)
    dec = lambda q: gmin32.astype(np.float64) + q * scale32.astype(np.float64)
    for _ in range(3):  # fix against float32 decode rounding
        ql = np.where(dec(ql) > lo64, np.maximum(ql - 1, 0), ql)
        qh = np.where((dec(qh) < hi64) & (scale32 > 0), np.minimum(qh + 1, 65535), qh)
    return ql.astype(np.uint16), qh.astype(np.uint16), gmin32, scale32


def _pack_q_words(qlo, qhi):
    """6 uint16 -> 3 float32 words (bitcast)."""
    q32 = lambda a, b: (a.astype(np.uint32) | (b.astype(np.uint32) << 16)).view(
        np.float32
    )
    return (
        q32(qlo[:, 0], qlo[:, 1]),
        q32(qlo[:, 2], qhi[:, 0]),
        q32(qhi[:, 1], qhi[:, 2]),
    )


def _bf16_dir(vals, up: bool) -> np.ndarray:
    """Conservative bf16 rounding of f32 values: the returned uint16
    (the f32's top half), reinterpreted as f32 with a zero low half, is
    <= vals (up=False) or >= vals (up=True). Truncating the mantissa
    moves toward zero; where that lands on the wrong side, step one
    bf16 ulp away from zero (carry into the exponent is the correct
    next-representable step for IEEE bit patterns)."""
    f = np.atleast_1d(np.asarray(vals, np.float32))
    u = f.view(np.uint32)
    t = u & np.uint32(0xFFFF0000)
    dec = t.view(np.float32)
    need = (dec < f) if up else (dec > f)
    t = np.where(need, t + np.uint32(0x10000), t)
    return (t >> 16).astype(np.uint16)


#: Unified megakernel row width (node rows use [0:7+3*MEGA_ARITY], leaf
#: rows [0:19*MEGA_LEAF_TRIS]). Wider fanout + fatter leaves = fewer
#: rows visited per path segment, at more gathered bytes per row; the
#: default layout (config.MEGA_LEAF_TRIS / MEGA_NODE_ARITY) is narrower.
MEGA_ROW_WIDTH = 160
#: Children per node row.
MEGA_ARITY = 32


def mega_row_width(leaf_tris: int, bounds_fmt: str = "u8",
                   arity: int = None) -> int:
    """Bank row width for a leaf capacity: 19 f32 per inline triangle;
    node rows need 7 + 3*MEGA_ARITY words (u8 bounds) or 7 + 4*
    MEGA_ARITY (bf16). Rounded to a multiple of 8; past 160, to a
    multiple of 64 that is never 256. leaf_tris < 8 narrows the bank
    below 160: smaller leaves trade extra leaf rows for fewer gathered
    bytes per iteration."""
    arity = arity or MEGA_ARITY
    node_w = 7 + (4 if bounds_fmt == "bf16" else 3) * arity
    w = max(19 * leaf_tris, node_w)
    w = -(-w // 8) * 8
    if leaf_tris >= 8:
        w = max(w, MEGA_ROW_WIDTH)  # the W=160 anchor layout
    if w > 160:
        w = -(-w // 64) * 64
        if w == 256:
            w = 320
    return w


#: Inline exact triangles per leaf row.
MEGA_LEAF_TRIS = 8
#: Bits reserved for the resume-slot in packed stack entries
#: (must hold MEGA_ARITY + 1 values).
MEGA_SLOT_BITS = 6
#: Triangle budget for the inline static stage: identity-transform
#: meshes whose combined size fits are MT-tested densely in the shade
#: iteration (elementwise work paid once per iteration) instead of traversed.
MEGA_STATIC_MAX_TRIS = 64



def _pack_child_slots(row, kids, bounds_fmt: str, arity: int, lo, hi):
    """Write one node row's child-slot words — THE shared packer for
    both bank emitters (_emit_mega_subtree.emit_node and _emit_tlas),
    so the conservativeness invariant the kernel's slab test depends on
    (decoded lo <= true lo, decoded hi >= true hi; empty slots are
    self-missing boxes with meta 0) lives in exactly one place.

    ``kids``: [(meta_i32, lo64 (3,), hi64 (3,))] already slot-sorted
    along the node's recorded axis; ``lo``/``hi``: the node's f64
    bounds (the u8 quantisation grid). u8 format also writes the grid
    to row[0:3]/row[3:6]; bf16 writes absolute conservative bounds per
    slot (_bf16_dir)."""
    i32f = lambda v: np.array(v, np.int32).view(np.float32)
    if bounds_fmt == "bf16":
        u16f = lambda a, b: np.array(
            np.uint32(a) | (np.uint32(b) << np.uint32(16)), np.uint32
        ).view(np.float32)
        for s_idx, (meta, clo, chi) in enumerate(kids):
            lo16 = _bf16_dir(clo.astype(np.float32), up=False)
            hi16 = _bf16_dir(chi.astype(np.float32), up=True)
            base = 7 + 4 * s_idx
            row[base] = u16f(lo16[0], lo16[1])
            row[base + 1] = u16f(lo16[2], hi16[0])
            row[base + 2] = u16f(hi16[1], hi16[2])
            row[base + 3] = i32f(meta)
        big, neg = np.uint16(0x7F7F), np.uint16(0xFF7F)
        for s_idx in range(len(kids), arity):
            base = 7 + 4 * s_idx
            # empty slot: lo = +MAX > hi = -MAX never hits; meta 0
            row[base] = u16f(big, big)
            row[base + 1] = u16f(big, neg)
            row[base + 2] = u16f(neg, neg)
            row[base + 3] = 0.0
        return

    scale = (hi - lo) / 255.0
    origin32 = lo.astype(np.float32)
    scale32 = np.where(scale > 0, scale, 0.0).astype(np.float32)
    row[0:3] = origin32
    row[3:6] = scale32
    safe = np.where(scale32 > 0, scale32.astype(np.float64), 1.0)
    dec = lambda q: origin32.astype(np.float64) + q * scale32.astype(
        np.float64
    )
    for s_idx, (meta, clo, chi) in enumerate(kids):
        # conservative u8 quantisation on this node's grid, refined
        # against float32 decode rounding
        ql = np.clip(np.floor((clo - origin32) / safe), 0, 255)
        qh = np.clip(np.ceil((chi - origin32) / safe), 0, 255)
        for _ in range(3):
            ql = np.where(dec(ql) > clo, np.maximum(ql - 1, 0), ql)
            qh = np.where(
                (dec(qh) < chi) & (scale32 > 0), np.minimum(qh + 1, 255), qh
            )
        ql = ql.astype(np.uint32)
        qh = qh.astype(np.uint32)
        w0 = ql[0] | (ql[1] << 8) | (ql[2] << 16) | (qh[0] << 24)
        w1 = qh[1] | (qh[2] << 8)
        base = 7 + 3 * s_idx
        row[base] = np.array(w0, np.uint32).view(np.float32)
        row[base + 1] = np.array(w1, np.uint32).view(np.float32)
        row[base + 2] = i32f(meta)
    for s_idx in range(len(kids), arity):
        base = 7 + 3 * s_idx
        # empty slot: qlo=255 > qhi=0 never hits; meta 0
        row[base] = np.array(
            np.uint32(255 | (255 << 8) | (255 << 16)), np.uint32
        ).view(np.float32)
        row[base + 1] = 0.0
        row[base + 2] = 0.0


def _emit_mega_subtree(rows, nodes, root, tri_pos, tri_nrm, tri_mesh,
                       bounds_fmt: str = "u8", leaf_tris: int = None,
                       row_width: int = None, arity: int = None):
    """Emit a BVH2 subtree as MEGA_ARITY-wide megakernel rows.

    The traversal currency is ROWS VISITED (one row gather per lane per
    iteration). A node row packs 16 children's bounds; a leaf row carries
    up to 8 inline exact triangles (subtrees with <= 8 triangles
    collapse into one leaf row regardless of the binary leaf cap).

    Node row:
      [0:3] grid origin (f32), [3:6] grid cell size (f32; child boxes
      are uint8-quantised on this per-node grid, conservatively),
      [6] bitcast i32 sort axis, then MEGA_ARITY child slots x 3 words
      at base 7+3*s:
        w0 = qlo.x | qlo.y<<8 | qlo.z<<16 | qhi.x<<24
        w1 = qhi.y | qhi.z<<8
        w2 = bitcast i32 meta: target_row<<1 | is_leaf; meta 0 AND
             qlo>qhi marks an empty slot (self-missing box).
    Node row, ``bounds_fmt == "bf16"`` (config.MEGA_BF16_BOUNDS):
      [0:6] unused, [6] bitcast i32 sort axis, then MEGA_ARITY child
      slots x 4 words at base 7+4*s — absolute bf16 child bounds,
      conservatively rounded (_bf16_dir), packed two-per-word as the
      f32 TOP halves (decode = shift/mask + bitcast, no FMA):
        w0 = bf16(lo.x) | bf16(lo.y)<<16
        w1 = bf16(lo.z) | bf16(hi.x)<<16
        w2 = bf16(hi.y) | bf16(hi.z)<<16
        w3 = bitcast i32 meta (as u8); empty slot: lo=+MAX > hi=-MAX.
      Tighter than u8-on-node-grid (relative 2^-8 error instead of
      1/255 of the PARENT extent), so fewer false descends.
    Leaf row: MEGA_LEAF_TRIS x 19 floats (pa pb pc na nb nc + owner
    mesh aux), exact f32; unused slots are zero triangles (MT det==0
    rejects them).

    Returns (root_row, root_is_leaf, depth) — depth is the maximum
    push depth a traversal of this subtree can need.
    """
    leaf_tris = leaf_tris or MEGA_LEAF_TRIS
    arity = arity or MEGA_ARITY
    row_width = row_width or mega_row_width(leaf_tris, bounds_fmt, arity)
    bmin, bmax, child, first, ntris = nodes
    i32f = lambda v: np.array(v, np.int32).view(np.float32)

    counts: Dict[int, int] = {}

    def subtree_count(i) -> int:
        i = int(i)
        if i not in counts:
            if ntris[i] > 0:
                counts[i] = int(ntris[i])
            else:
                counts[i] = subtree_count(child[i]) + subtree_count(
                    int(child[i]) + 1
                )
        return counts[i]

    def subtree_tris(i):
        """Global triangle ids of a subtree, in BVH traversal order
        (keeps the reference's index-order tie semantics within a row,
        Trace.cl:352-357)."""
        out = []
        stack = [int(i)]
        while stack:
            j = stack.pop()
            if ntris[j] > 0:
                out.extend(range(int(first[j]), int(first[j]) + int(ntris[j])))
            else:
                stack.append(int(child[j]) + 1)
                stack.append(int(child[j]))
        return out

    def emit_leaf(i):
        tris = subtree_tris(i)
        assert 1 <= len(tris) <= leaf_tris, len(tris)
        row = np.zeros(row_width, np.float32)
        for k in range(leaf_tris):
            base = 19 * k
            if k < len(tris):
                t = tris[k]
                row[base : base + 9] = np.asarray(
                    tri_pos[t], np.float32
                ).reshape(9)
                row[base + 9 : base + 18] = np.asarray(
                    tri_nrm[t], np.float32
                ).reshape(9)
                row[base + 18] = i32f(
                    -1 if tri_mesh is None else int(tri_mesh[t])
                )
            else:
                # degenerate slot: zero triangle, MT det==0 rejects it
                row[base + 18] = i32f(-1)
        my = len(rows)
        rows.append(row)
        return my

    def collect_slots(i):
        """Collapse: expand internal BVH2 nodes (largest surface first)
        until up to MEGA_ARITY slots remain. Subtrees at or below the
        leaf-row capacity are not expanded — they become leaf rows."""
        slots = [i]

        def area(j):
            s = bmax[j] - bmin[j]
            return float(s[0] * (s[1] + s[2]) + s[1] * s[2])

        while len(slots) < arity - 1:
            internals = [
                j for j in slots
                if ntris[j] == 0 and subtree_count(j) > leaf_tris
            ]
            if not internals:
                break
            j = max(internals, key=area)
            slots.remove(j)
            slots.append(int(child[j]))
            slots.append(int(child[j]) + 1)
        return slots

    def emit_node(i):
        if ntris[i] > 0 or subtree_count(i) <= leaf_tris:
            return emit_leaf(i), True, 0
        slots = collect_slots(i)
        my = len(rows)
        rows.append(None)  # reserve position (pre-order)
        row = np.zeros(row_width, np.float32)

        lo = np.min([bmin[j] for j in slots], axis=0).astype(np.float64)
        hi = np.max([bmax[j] for j in slots], axis=0).astype(np.float64)

        # Sort slots along the node's widest axis and record it: the
        # traversal visits slots in this order (or reversed, by ray
        # direction sign) so near children are tested first and the
        # distance bound prunes far siblings earlier.
        axis = int(np.argmax(hi - lo))
        slots.sort(key=lambda j: float(bmin[j][axis] + bmax[j][axis]))
        row[6] = np.array(axis, np.int32).view(np.float32)

        kids = []
        depth = 0
        for j in slots:
            target, is_leaf, d = emit_node(j)
            depth = max(depth, d)
            kids.append((
                (target << 1) | (1 if is_leaf else 0),
                np.asarray(bmin[j], np.float64),
                np.asarray(bmax[j], np.float64),
            ))
        _pack_child_slots(row, kids, bounds_fmt, arity, lo, hi)
        rows[my] = row
        return my, False, depth + 1

    return emit_node(root)


#: Instance-row layout (TLAS regime): transform + routing data for one
#: mesh instance, gathered by the megakernel's instance enter/exit
#: branches exactly like node/leaf rows. 22 f32 words:
#:   [0:3]  position, [3:12] row-major rotation (euler, bit-matching
#:          vecmath.euler_rotation), [12] uniform scale,
#:   [13]   bitcast i32 flags: bit0 one_sided, bit1 backface-cull
#:          (cull unless Glassy/Invisible/OneSided, Trace.cl:460-462),
#:   [14]   bitcast i32 owner mesh id,
#:   [15]   bitcast i32 root meta (mesh BVH root_row << 1 | is_leaf),
#:   [16:19]/[19:22] local root bounds (the uint16 quant grid's span —
#:          the same f32 values the unrolled chain's pretest uses).
MEGA_INST_ROW_WORDS = 22
#: Meta bit marking "target is an INSTANCE row" in node-row child slots
#: and stack entries (bit 28; targets stay < 2^27 by the freeze assert,
#: so metas never set it accidentally).
MEGA_ITAG = 1 << 28


def _euler_np(pitch: float, yaw: float, roll: float) -> np.ndarray:
    """float32 XYZ-Euler rotation bit-matching vecmath.euler_rotation
    (same expressions and association order, numpy f32 instead of
    traced jnp — freeze-time twin for baked instance rows).

    Backend caveat: "bit-matching" holds where the backend's f32
    cos/sin agree with numpy's (true on the CPU backend, where the
    TLAS-vs-unrolled bitwise tests run). An accelerator whose
    transcendentals round differently can put the BAKED rotation a ulp
    off the TRACED one — each regime stays self-consistent (a scene is
    either TLAS or unrolled, never both), so this only means the two
    regimes' outputs may differ in the last ulp on such backends, not
    that either is wrong."""
    p = np.float32(pitch)
    y = np.float32(yaw)
    r = np.float32(roll)
    cx, sx = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(r), np.sin(r)
    return np.array([
        [cy * cz, cy * sz, -sy],
        [cz * sy * sx - cx * sz, cx * cz + sx * sy * sz, cy * sx],
        [sx * sz + cx * cz * sy, cx * sy * sz - cz * sx, cx * cy],
    ], np.float32)


def _emit_tlas(rows, entries, bounds_fmt: str, row_width: int, arity: int):
    """Emit the top-level BVH over instances as node rows in the same
    bank format as _emit_mega_subtree's (u8-on-node-grid or bf16 child
    bounds), with leaf-slot metas tagged MEGA_ITAG and pointing at
    INSTANCE rows.

    ``entries``: [(inst_row_idx, world_lo(3,f64), world_hi(3,f64))].
    Returns (root_row, depth). Topology: recursive arity-wide split of
    the instance list sorted along the widest axis (near-equal chunks),
    child slots sorted along the node's widest axis like emit_node so
    the kernel's direction-signed priority order prunes far siblings.
    """
    i32f = lambda v: np.array(v, np.int32).view(np.float32)

    def bounds_of(items):
        lo = np.min([e[1] for e in items], axis=0)
        hi = np.max([e[2] for e in items], axis=0)
        return lo, hi

    def emit(items, force_node=False):
        """-> (meta_sans_shift target, is_instance, lo, hi, depth)"""
        if len(items) == 1 and not force_node:
            row_idx, lo, hi = items[0]
            return row_idx, True, lo, hi, 0
        # Partition into up to ``arity`` chunks along the widest axis.
        lo, hi = bounds_of(items)
        axis = int(np.argmax(hi - lo))
        items = sorted(items, key=lambda e: float(e[1][axis] + e[2][axis]))
        n_chunks = min(arity, len(items))
        cuts = [round(k * len(items) / n_chunks) for k in range(n_chunks + 1)]
        chunks = [items[cuts[k]:cuts[k + 1]] for k in range(n_chunks)
                  if cuts[k] < cuts[k + 1]]
        my = len(rows)
        rows.append(None)  # reserve (pre-order)
        row = np.zeros(row_width, np.float32)
        row[6] = i32f(axis)
        kids = []
        depth = 0
        for ch in chunks:
            t, is_inst, clo, chi, d = emit(ch)
            depth = max(depth, d)
            meta = (MEGA_ITAG | (t << 1)) if is_inst else (t << 1)
            kids.append((meta, clo, chi))
        # slot order: by centroid along the recorded axis (emit_node's
        # contract with the kernel's priority machinery)
        kids.sort(key=lambda k: float(k[1][axis] + k[2][axis]))
        _pack_child_slots(row, kids, bounds_fmt, arity, lo, hi)
        rows[my] = row
        return my, False, lo, hi, depth + 1

    # force_node: the chain-entry root must be a NODE row (the enter
    # step descends into it like any subtree root).
    target, _is_inst, _lo, _hi, depth = emit(entries, force_node=True)
    return target, depth


from tpurt.config import CORNELL_BREATHING_ROOM
from tpurt.scene.obj import load_obj as _load_obj_file
from tpurt.scene.obj import parse_obj
from tpurt.scene.types import MaterialType, Scene


@dataclasses.dataclass
class Material:
    """Host-side RayTracingMaterial (src/readobj.hpp:48-56). Defaults
    mirror the C++ member initialisers (ior = 1, rest zero)."""

    type: MaterialType = MaterialType.SOLID
    ior: float = 1.0
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_strength: float = 0.0
    reflectiveness: float = 0.0
    specular_probability: float = 0.0


@dataclasses.dataclass
class MeshHandle:
    """Host-side MeshInfo (src/readobj.hpp:75-81); mutable until the
    builder freezes."""

    node_idx: int
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    pitch: float = 0.0
    yaw: float = 0.0
    roll: float = 0.0
    scale: float = 1.0
    material: Material = dataclasses.field(default_factory=Material)
    # Triangle range of the geometry this handle points at (for the
    # brute-force intersector; instances sharing geometry share it).
    first_tri: int = 0
    num_tris: int = 0


class SceneBuilder:
    def __init__(self) -> None:
        self._tri_pos: List[np.ndarray] = []  # (n, 3, 3) chunks
        self._tri_nrm: List[np.ndarray] = []
        self._num_tris = 0
        self.nodes = BVHNodes.empty()
        self.meshes: List[MeshHandle] = []
        self._mesh_cache: Dict[str, Tuple[int, int, int]] = {}

    # -- geometry ---------------------------------------------------------

    def _append_tris(self, pos: np.ndarray, nrm: np.ndarray) -> int:
        first = self._num_tris
        self._tri_pos.append(np.asarray(pos, np.float32).reshape(-1, 3, 3))
        self._tri_nrm.append(np.asarray(nrm, np.float32).reshape(-1, 3, 3))
        self._num_tris += self._tri_pos[-1].shape[0]
        return first

    def _consolidate(self) -> Tuple[np.ndarray, np.ndarray]:
        if len(self._tri_pos) != 1:
            self._tri_pos = [
                np.concatenate(self._tri_pos, 0)
                if self._tri_pos
                else np.zeros((0, 3, 3), np.float32)
            ]
            self._tri_nrm = [
                np.concatenate(self._tri_nrm, 0)
                if self._tri_nrm
                else np.zeros((0, 3, 3), np.float32)
            ]
        return self._tri_pos[0], self._tri_nrm[0]

    def add_triangles(
        self, pos: np.ndarray, nrm: np.ndarray, max_depth: int = 64
    ) -> MeshHandle:
        """Append a triangle soup, build its BVH, return an (un-added)
        handle with the reference's default OBJ material (white Solid,
        readobj.hpp:369-375). Large meshes build through the native C++
        SAH builder when available (identical topology; tpurt/_native)."""
        pos = np.asarray(pos, np.float32).reshape(-1, 3, 3)
        nrm = np.asarray(nrm, np.float32).reshape(-1, 3, 3)
        first = self._append_tris(pos, nrm)
        tri_pos, tri_nrm = self._consolidate()
        root = self._build_bvh_fast(tri_pos, tri_nrm, first, pos.shape[0], max_depth)
        return MeshHandle(
            node_idx=root,
            material=Material(type=MaterialType.SOLID, color=(1.0, 1.0, 1.0)),
            first_tri=first,
            num_tris=pos.shape[0],
        )

    def _build_bvh_fast(
        self, tri_pos, tri_nrm, first: int, count: int, max_depth: int
    ) -> int:
        """SAH build, native C++ for large meshes, numpy otherwise."""
        if count >= 512:
            from tpurt import _native
            from tpurt.accel.bvh import DEFAULT_LEAF_CAP

            out = _native.build_bvh(
                tri_pos, tri_nrm, first, count, max_depth, DEFAULT_LEAF_CAP
            )
            if out is not None:
                bmin, bmax, child, nfirst, ntris = out
                base = len(self.nodes)
                for i in range(len(ntris)):
                    self.nodes.append(
                        bmin[i], bmax[i],
                        int(child[i]) + base if ntris[i] == 0 else 0,
                        int(nfirst[i]), int(ntris[i]),
                    )
                return base
        return build_bvh(self.nodes, tri_pos, tri_nrm, first, count, max_depth)

    def load_obj(self, path: str) -> MeshHandle:
        """loadMeshFromOBJFile semantics incl. the per-file cache: a
        repeat load returns a fresh handle sharing the existing geometry
        and BVH (the reference intended this but cached a triangle index
        as a node index, readobj.hpp:272-274)."""
        if path in self._mesh_cache:
            root, first, num = self._mesh_cache[path]
            return MeshHandle(
                node_idx=root,
                material=Material(type=MaterialType.SOLID, color=(1.0, 1.0, 1.0)),
                first_tri=first,
                num_tris=num,
            )
        pos, nrm = _load_obj_file(path)
        handle = self.add_triangles(pos, nrm, max_depth=64)
        self._mesh_cache[path] = (handle.node_idx, handle.first_tri, handle.num_tris)
        return handle

    def load_obj_text(self, text: str) -> MeshHandle:
        pos, nrm = parse_obj(text)
        return self.add_triangles(pos, nrm, max_depth=64)

    # -- instances --------------------------------------------------------

    def add_mesh(self, handle: MeshHandle) -> int:
        """Append an instance to the scene (meshList.emplace_back)."""
        self.meshes.append(handle)
        return len(self.meshes) - 1

    def add_quad(self, a, b, c, d, normal, color) -> MeshHandle:
        """addQuad (readobj.hpp:378-408): two triangles (a,b,c), (a,c,d)
        with a constant normal, identity transform, Solid material of the
        given color; appended to the scene immediately."""
        a, b, c, d = (np.asarray(v, np.float32) for v in (a, b, c, d))
        normal = np.asarray(normal, np.float32)
        pos = np.stack([np.stack([a, b, c]), np.stack([a, c, d])])
        nrm = np.broadcast_to(normal, (2, 3, 3)).copy()
        first = self._append_tris(pos, nrm)
        tri_pos, tri_nrm = self._consolidate()
        # SplitBVH default depth 10; a no-op at 2 triangles (readobj.hpp:392).
        root = build_bvh(self.nodes, tri_pos, tri_nrm, first, 2, max_depth=10)
        handle = MeshHandle(
            node_idx=root,
            material=Material(type=MaterialType.SOLID, color=tuple(map(float, color))),
            first_tri=first,
            num_tris=2,
        )
        self.add_mesh(handle)
        return handle

    def add_cornell_box(self, mesh: MeshHandle) -> None:
        """addCornellBoxToScene (image.hpp:401-449): box sized from the
        mesh's scaled root bounds with CORNELL_BREATHING_ROOM slack on
        every side except the floor (so the model touches it), plus an
        emissive light quad just below the ceiling."""
        room = CORNELL_BREATHING_ROOM
        bmin = self.nodes.bmin[mesh.node_idx] * np.float32(mesh.scale)
        bmax = self.nodes.bmax[mesh.node_idx] * np.float32(mesh.scale)
        min_x, max_x = bmin[0] - room, bmax[0] + room
        min_y, max_y = bmin[1], bmax[1] + room  # floor not lowered (image.hpp:406)
        min_z, max_z = bmin[2] - room, bmax[2] + room

        # Floor (image.hpp:411-421): dark, specularProbability 1.
        floor = self.add_quad(
            (min_x, min_y, min_z), (max_x, min_y, min_z),
            (max_x, min_y, max_z), (min_x, min_y, max_z),
            (0, 1, 0), (0.1, 0.1, 0.1),
        )
        floor.material = Material(
            type=MaterialType.SOLID, ior=1.0, color=(0.1, 0.1, 0.1),
            specular_probability=1.0,
        )
        # Ceiling, white (image.hpp:424).
        self.add_quad(
            (min_x, max_y, min_z), (max_x, max_y, min_z),
            (max_x, max_y, max_z), (min_x, max_y, max_z),
            (0, -1, 0), (1.0, 1.0, 1.0),
        )
        # Front wall, white, one-sided so the camera sees in (image.hpp:427-428).
        front = self.add_quad(
            (min_x, min_y, max_z), (max_x, min_y, max_z),
            (max_x, max_y, max_z), (min_x, max_y, max_z),
            (0, 0, -1), (1.0, 1.0, 1.0),
        )
        front.material.type = MaterialType.ONE_SIDED
        # Back wall, green (image.hpp:432).
        self.add_quad(
            (min_x, min_y, min_z), (max_x, min_y, min_z),
            (max_x, max_y, min_z), (min_x, max_y, min_z),
            (0, 0, 1), (0.1, 0.8, 0.1),
        )
        # Left wall, blue (image.hpp:435).
        self.add_quad(
            (min_x, min_y, min_z), (min_x, min_y, max_z),
            (min_x, max_y, max_z), (min_x, max_y, min_z),
            (1, 0, 0), (0.1, 0.1, 1.0),
        )
        # Right wall, red (image.hpp:438).
        self.add_quad(
            (max_x, min_y, min_z), (max_x, min_y, max_z),
            (max_x, max_y, max_z), (max_x, max_y, min_z),
            (-1, 0, 0), (1.0, 0.2, 0.2),
        )
        # Ceiling light (image.hpp:441-448).
        lx, lz, ly = 50.0, 50.0, max_y - 1.0
        light = self.add_quad(
            (-lx, ly, -lz), (lx, ly, -lz), (lx, ly, lz), (-lx, ly, lz),
            (0, -1, 0), (0.0, 0.0, 0.0),
        )
        light.material = Material(
            type=MaterialType.SOLID, ior=1.0, color=(1.0, 1.0, 1.0),
            emission_color=(1.0, 1.0, 1.0), emission_strength=8.0,
            specular_probability=1.0,
        )

    # -- freeze -----------------------------------------------------------

    def freeze(self) -> Scene:
        """Flatten to the device Scene (the analog of generateBuffers,
        image.hpp:97-175, including the Node -> GPUNode compression:
        index = childIndex if internal else firstTriangleIdx,
        image.hpp:116-128)."""
        import jax.numpy as jnp

        tri_pos, tri_nrm = self._consolidate()
        bmin, bmax, child, first, ntris = self.nodes.as_arrays()
        index = np.where(ntris == 0, child, first).astype(np.int32)

        roots = [m.node_idx for m in self.meshes]
        hit, miss = thread_links(child, ntris, sorted(set(roots)))

        # Gather-packed quantised node rows (see Scene.node_q).
        m_nodes = len(ntris)
        assert m_nodes < (1 << 24), "node count exceeds packed miss-link field"
        assert ntris.max(initial=0) < (1 << 8), (
            "leaf size exceeds packed field; lower the builder leaf cap"
        )
        w6 = np.where(ntris == 0, hit.astype(np.int64), first).astype(np.int32)
        w7 = ((miss.astype(np.int64) + 1) | (ntris.astype(np.int64) << 24)).astype(
            np.int32
        )
        bmin_arr = np.asarray(bmin, np.float32).reshape(m_nodes, 3)
        bmax_arr = np.asarray(bmax, np.float32).reshape(m_nodes, 3)

        # Per-root uint16 quantisation grids. Conservative by
        # construction: decoded lo <= true lo and decoded hi >= true hi
        # (verified and fixed up element-wise below), so traversal can
        # only over-visit, never miss.
        unique_roots = sorted({m.node_idx for m in self.meshes})
        qlo = np.zeros((m_nodes, 3), np.uint16)
        qhi = np.zeros((m_nodes, 3), np.uint16)
        root_params = {}
        for root in unique_roots:
            members = list(_subtree_indices(child, ntris, root))
            gmin = bmin_arr[root].astype(np.float64)
            gmax = bmax_arr[root].astype(np.float64)
            scale = (gmax - gmin) / 65535.0
            safe = np.where(scale > 0, scale, 1.0)
            sub_lo = bmin_arr[members].astype(np.float64)
            sub_hi = bmax_arr[members].astype(np.float64)
            ql = np.clip(np.floor((sub_lo - gmin) / safe), 0, 65535)
            qh = np.clip(np.ceil((sub_hi - gmin) / safe), 0, 65535)
            # Fix-up against float32 decode rounding.
            f32 = lambda x: x.astype(np.float32).astype(np.float64)
            gmin32, scale32 = f32(gmin), f32(np.where(scale > 0, scale, 0.0))
            for _ in range(3):
                dec_lo = gmin32 + ql * scale32
                ql = np.where(dec_lo > sub_lo, np.maximum(ql - 1, 0), ql)
                dec_hi = gmin32 + qh * scale32
                qh = np.where(
                    (dec_hi < sub_hi) & (scale32 > 0), np.minimum(qh + 1, 65535), qh
                )
            qlo[members] = ql.astype(np.uint16)
            qhi[members] = qh.astype(np.uint16)
            root_params[root] = (
                gmin.astype(np.float32),
                np.where(scale > 0, scale, 0.0).astype(np.float32),
            )

        node_q = np.zeros((m_nodes, 5), np.float32)
        q32 = lambda lo16, hi16: (
            lo16.astype(np.uint32) | (hi16.astype(np.uint32) << 16)
        ).view(np.float32)
        node_q[:, 0] = q32(qlo[:, 0], qlo[:, 1])
        node_q[:, 1] = q32(qlo[:, 2], qhi[:, 0])
        node_q[:, 2] = q32(qhi[:, 1], qhi[:, 2])
        node_q[:, 3] = w6.view(np.float32)
        node_q[:, 4] = w7.view(np.float32)

        if self.meshes:
            mesh_qmin = np.stack([root_params[m.node_idx][0] for m in self.meshes])
            mesh_qscale = np.stack([root_params[m.node_idx][1] for m in self.meshes])
        else:
            mesh_qmin = np.zeros((0, 3), np.float32)
            mesh_qscale = np.zeros((0, 3), np.float32)

        tri_packed = np.concatenate(
            [tri_pos.reshape(-1, 9), tri_nrm.reshape(-1, 9)], axis=1
        ).astype(np.float32)

        # --- megakernel arrays (see Scene.mega_rows) -------------------
        import tpurt.config as _cfgmod
        from tpurt.config import MEGA_BF16_BOUNDS

        bounds_fmt = "bf16" if MEGA_BF16_BOUNDS else "u8"
        leaf_tris = int(getattr(_cfgmod, "MEGA_LEAF_TRIS", MEGA_LEAF_TRIS))
        arity = int(getattr(_cfgmod, "MEGA_NODE_ARITY", MEGA_ARITY))
        assert 2 <= arity <= (1 << MEGA_SLOT_BITS) - 1
        row_width = mega_row_width(leaf_tris, bounds_fmt, arity)
        mega_rows_list: List[np.ndarray] = []
        chain: List[Tuple[int, int, bool]] = []
        mega_depth = 0
        nodes_tuple = (bmin_arr, bmax_arr, child, first, ntris)

        def _is_identity(m):
            return (
                tuple(np.asarray(m.pos, np.float64).tolist()) == (0.0, 0.0, 0.0)
                and float(m.pitch) == 0.0 and float(m.yaw) == 0.0
                and float(m.roll) == 0.0 and float(m.scale) == 1.0
            )

        # Inline static stage: small identity-transform meshes are tested
        # densely inside the megakernel's shade iteration (zero gathered
        # rows, zero chain entries) instead of being traversed. OneSided
        # meshes are eligible only as single quads (<= 2 coplanar tris):
        # the reference rejects a OneSided mesh's contribution when ITS
        # closest hit is a backface (Trace.cl:466-471) — for a planar
        # quad every candidate has the same facing, so rejecting
        # backface candidates directly is equivalent; for thicker
        # OneSided meshes a closer backface must shadow farther
        # frontfaces, which needs the per-mesh query the chain provides.
        inline_eligible = [
            i
            for i, m in enumerate(self.meshes)
            if m.num_tris > 0 and _is_identity(m)
            and (
                int(m.material.type) != int(MaterialType.ONE_SIDED)
                or m.num_tris <= 2
            )
        ]
        total_inline = sum(self.meshes[i].num_tris for i in inline_eligible)
        if total_inline > MEGA_STATIC_MAX_TRIS:
            inline_eligible = []  # dense per-iteration cost would exceed
            #                       a traversal; fall back to the BVH path

        static_rows_list: List[np.ndarray] = []
        static_cull: List[bool] = []
        static_onesided: List[bool] = []
        static_owner: List[int] = []
        i32f = lambda v: np.array(v, np.int32).view(np.float32)
        for i in inline_eligible:
            m = self.meshes[i]
            mt = int(m.material.type)
            for t in range(m.first_tri, m.first_tri + m.num_tris):
                row = np.zeros(19, np.float32)
                row[0:9] = tri_pos[t].reshape(9)
                row[9:18] = tri_nrm[t].reshape(9)
                row[18] = i32f(i)
                static_rows_list.append(row)
                static_owner.append(i)
                static_cull.append(
                    mt not in (
                        int(MaterialType.GLASSY),
                        int(MaterialType.INVISIBLE),
                        int(MaterialType.ONE_SIDED),
                    )
                )
                static_onesided.append(mt == int(MaterialType.ONE_SIDED))
        mega_static_rows = (
            np.stack(static_rows_list)
            if static_rows_list
            else np.zeros((0, 19), np.float32)
        )

        static_members = [
            i
            for i, m in enumerate(self.meshes)
            if m.num_tris > 0 and _is_identity(m)
            and int(m.material.type) != int(MaterialType.ONE_SIDED)
            and i not in inline_eligible
        ]
        if static_members:
            s_pos = np.concatenate(
                [tri_pos[m.first_tri : m.first_tri + m.num_tris]
                 for m in (self.meshes[i] for i in static_members)]
            ).copy()
            s_nrm = np.concatenate(
                [tri_nrm[m.first_tri : m.first_tri + m.num_tris]
                 for m in (self.meshes[i] for i in static_members)]
            ).copy()
            s_mesh = np.concatenate(
                [np.full(self.meshes[i].num_tris, i, np.int64)
                 for i in static_members]
            )
            s_nodes = BVHNodes.empty()
            s_root = build_bvh(
                s_nodes, s_pos, s_nrm, 0, len(s_pos), 64, leaf_cap=2, aux=s_mesh
            )
            root_row, root_leaf, d = _emit_mega_subtree(
                mega_rows_list, s_nodes.as_arrays(), s_root, s_pos, s_nrm,
                s_mesh, bounds_fmt=bounds_fmt, leaf_tris=leaf_tris,
                row_width=row_width, arity=arity,
            )
            chain.append((-1, root_row, root_leaf))
            mega_depth = max(mega_depth, d)

        chain_members: List[Tuple[int, ...]] = (
            [tuple(static_members)] if static_members else []
        )
        emitted_roots: Dict[int, Tuple[int, bool]] = {}
        inst_list = [
            i for i, m in enumerate(self.meshes)
            if i not in static_members and i not in inline_eligible
            and m.num_tris > 0
        ]
        use_tlas = len(inst_list) > int(
            getattr(_cfgmod, "MEGA_TLAS_THRESHOLD", 8)
        )
        tlas_bounds: Tuple[float, ...] = ()
        inst_roots: Dict[int, Tuple[int, bool]] = {}
        inst_depth = 0
        for i in inst_list:
            m = self.meshes[i]
            if m.node_idx in emitted_roots:
                root_row, root_leaf = emitted_roots[m.node_idx]
            else:
                root_row, root_leaf, d = _emit_mega_subtree(
                    mega_rows_list, nodes_tuple, m.node_idx,
                    tri_pos, tri_nrm, None, bounds_fmt=bounds_fmt,
                    leaf_tris=leaf_tris, row_width=row_width, arity=arity,
                )
                inst_depth = max(inst_depth, d)
                if not use_tlas:
                    mega_depth = max(mega_depth, d)
                emitted_roots[m.node_idx] = (root_row, root_leaf)
            inst_roots[i] = emitted_roots[m.node_idx]
            if not use_tlas:
                chain.append((i, root_row, root_leaf))
                chain_members.append((i,))
        if use_tlas:
            # Many-instance regime: entries become DATA — one instance
            # row per mesh (transform baked at freeze) under a world-
            # space top-level BVH; the chain gets ONE (-2) entry. The
            # unrolled per-entry enter/pretest stages (and the K>64
            # many-gather regime) are never emitted.
            assert row_width >= MEGA_INST_ROW_WORDS, (
                f"bank width {row_width} cannot hold an instance row"
            )
            assert len(mega_rows_list) + 2 * len(inst_list) < (1 << 27)
            i32f_ = lambda v: np.array(v, np.int32).view(np.float32)
            tlas_entries = []
            for i in inst_list:
                m = self.meshes[i]
                root_row, root_leaf = inst_roots[i]
                gmin32, scale32 = root_params[m.node_idx]
                rmin = gmin32
                rmax = (gmin32 + np.float32(65535.0) * scale32).astype(
                    np.float32
                )
                rot = _euler_np(m.pitch, m.yaw, m.roll)
                row = np.zeros(row_width, np.float32)
                row[0:3] = np.asarray(m.pos, np.float32)
                row[3:12] = rot.reshape(9)
                row[12] = np.float32(m.scale)
                mt = int(m.material.type)
                os_f = 1 if mt == int(MaterialType.ONE_SIDED) else 0
                cull_f = 0 if mt in (
                    int(MaterialType.GLASSY), int(MaterialType.INVISIBLE),
                    int(MaterialType.ONE_SIDED),
                ) else 1
                row[13] = i32f_(os_f | (cull_f << 1))
                row[14] = i32f_(i)
                row[15] = i32f_((root_row << 1) | (1 if root_leaf else 0))
                row[16:19] = rmin
                row[19:22] = rmax
                inst_row = len(mega_rows_list)
                mega_rows_list.append(row)
                # Conservative world AABB: rotate the local root box's
                # 8 corners in float64, pad one f32 ulp outward.
                sc = np.float64(m.scale)
                r64 = rot.astype(np.float64)
                pos64 = np.asarray(m.pos, np.float64)
                cs = np.array([
                    [rmin[0] if (k & 1) == 0 else rmax[0],
                     rmin[1] if (k & 2) == 0 else rmax[1],
                     rmin[2] if (k & 4) == 0 else rmax[2]]
                    for k in range(8)
                ], np.float64)
                world = (cs * sc) @ r64.T + pos64
                wlo = np.nextafter(
                    world.min(axis=0).astype(np.float32), -np.inf
                ).astype(np.float64)
                whi = np.nextafter(
                    world.max(axis=0).astype(np.float32), np.inf
                ).astype(np.float64)
                tlas_entries.append((inst_row, wlo, whi))
            tlas_root, tlas_depth = _emit_tlas(
                mega_rows_list, tlas_entries, bounds_fmt, row_width, arity
            )
            chain.append((-2, tlas_root, False))
            chain_members.append(tuple(inst_list))
            # Stack budget: TLAS pushes + the exit marker + the deepest
            # instance subtree.
            mega_depth = max(mega_depth, tlas_depth + 1 + inst_depth)
            ulo = np.min([e[1] for e in tlas_entries], axis=0)
            uhi = np.max([e[2] for e in tlas_entries], axis=0)
            tlas_bounds = tuple(float(v) for v in ulo) + tuple(
                float(v) for v in uhi
            )
            import sys

            print(
                f"tpurt: {len(inst_list)} instanced meshes > TLAS "
                f"threshold {getattr(_cfgmod, 'MEGA_TLAS_THRESHOLD', 8)} "
                f"— routing through the instance-row TLAS (depth "
                f"{tlas_depth}); transforms are baked (re-freeze to "
                f"animate)", file=sys.stderr,
            )

        mega_rows = (
            np.stack(mega_rows_list)
            if mega_rows_list
            else np.zeros((1, row_width), np.float32)
        )
        assert len(mega_rows) < (1 << 27), "row index exceeds packed meta field"

        # Material dedup (Scene.mesh_mat_slot / mat_slot_rep): slots by
        # VALUE over the builder materials — instanced scenes share a
        # handful of materials across many meshes, and the shade-time
        # select chain then scales with the unique count (see
        # shading.select_material_soa).
        mat_key = lambda m: (
            int(m.type), float(m.ior), tuple(m.color),
            tuple(m.emission_color), float(m.emission_strength),
            float(m.reflectiveness), float(m.specular_probability),
        )
        slot_of: Dict[tuple, int] = {}
        mesh_mat_slot: List[int] = []
        mat_slot_rep: List[int] = []
        for i, m in enumerate(self.meshes):
            key = mat_key(m.material)
            if key not in slot_of:
                slot_of[key] = len(mat_slot_rep)
                mat_slot_rep.append(i)
            mesh_mat_slot.append(slot_of[key])

        k = len(self.meshes)
        mesh_root = np.asarray(roots, np.int32)
        mesh_pos = np.asarray([m.pos for m in self.meshes], np.float32).reshape(k, 3)
        f32 = lambda get: np.asarray([get(m) for m in self.meshes], np.float32)
        mats = [m.material for m in self.meshes]

        max_leaf = int(ntris.max()) if len(ntris) else 0
        scene = Scene(
            tri_pos_a=jnp.asarray(tri_pos[:, 0]),
            tri_pos_b=jnp.asarray(tri_pos[:, 1]),
            tri_pos_c=jnp.asarray(tri_pos[:, 2]),
            tri_nrm_a=jnp.asarray(tri_nrm[:, 0]),
            tri_nrm_b=jnp.asarray(tri_nrm[:, 1]),
            tri_nrm_c=jnp.asarray(tri_nrm[:, 2]),
            node_min=jnp.asarray(bmin),
            node_max=jnp.asarray(bmax),
            node_index=jnp.asarray(index),
            node_ntris=jnp.asarray(ntris.astype(np.int32)),
            node_hit=jnp.asarray(hit),
            node_miss=jnp.asarray(miss),
            node_q=jnp.asarray(node_q),
            tri_packed=jnp.asarray(tri_packed),
            mesh_qmin=jnp.asarray(mesh_qmin),
            mesh_qscale=jnp.asarray(mesh_qscale),
            mega_rows=jnp.asarray(mega_rows),
            mesh_root=jnp.asarray(mesh_root),
            mesh_pos=jnp.asarray(mesh_pos),
            mesh_pitch=jnp.asarray(f32(lambda m: m.pitch)),
            mesh_yaw=jnp.asarray(f32(lambda m: m.yaw)),
            mesh_roll=jnp.asarray(f32(lambda m: m.roll)),
            mesh_scale=jnp.asarray(f32(lambda m: m.scale)),
            mat_type=jnp.asarray([int(m.type) for m in mats], jnp.int32),
            mat_ior=jnp.asarray([m.ior for m in mats], jnp.float32),
            mat_color=jnp.asarray([m.color for m in mats], jnp.float32).reshape(k, 3),
            mat_emission_color=jnp.asarray(
                [m.emission_color for m in mats], jnp.float32
            ).reshape(k, 3),
            mat_emission_strength=jnp.asarray(
                [m.emission_strength for m in mats], jnp.float32
            ),
            mat_reflectiveness=jnp.asarray(
                [m.reflectiveness for m in mats], jnp.float32
            ),
            mat_specular_prob=jnp.asarray(
                [m.specular_probability for m in mats], jnp.float32
            ),
            mega_static_rows=jnp.asarray(mega_static_rows),
            max_leaf_tris=max(max_leaf, 1),
            mega_chain=tuple(chain),
            mega_chain_members=tuple(chain_members),
            mega_stack_depth=int(mega_depth) + 2,
            mega_static_cull=tuple(static_cull),
            mega_static_onesided=tuple(static_onesided),
            mega_static_owner=tuple(static_owner),
            mesh_tri_ranges=tuple((m.first_tri, m.num_tris) for m in self.meshes),
            mega_bounds_fmt=bounds_fmt,
            mega_leaf_tris=leaf_tris,
            mega_arity=arity,
            mega_tlas=use_tlas,
            mega_tlas_bounds=tlas_bounds,
            mesh_mat_slot=tuple(mesh_mat_slot),
            mat_slot_rep=tuple(mat_slot_rep),
            mesh_mat_types=tuple(int(m.material.type) for m in self.meshes),
            mesh_identity=tuple(
                tuple(np.asarray(m.pos, np.float64).tolist()) == (0.0, 0.0, 0.0)
                and float(m.pitch) == 0.0 and float(m.yaw) == 0.0
                and float(m.roll) == 0.0 and float(m.scale) == 1.0
                for m in self.meshes
            ),
        )
        return scene

    def stats(self, handle: MeshHandle) -> dict:
        return bvh_stats(self.nodes, handle.node_idx)
