"""Scene representation: immutable struct-of-arrays pytrees.

The reference keeps the scene in mutable host globals — ``meshList``,
``triangleList``, ``nodeList`` (src/readobj.hpp:91-94) — uploaded to
per-device OpenCL buffers (src/image.hpp:97-175) as arrays of padded
structs (float3 == float4, 16 B). This design dissolves those structs
into struct-of-arrays jnp fields: each float3 member becomes an (N, 3)
float32 array, and no padding semantics leak into goldens.

``Scene`` is a frozen dataclass registered as a pytree: array fields
are leaves (donatable, shardable), while static metadata (max leaf
size, per-mesh triangle ranges) rides in the treedef so jit
specialises on it.

Material enum values mirror MaterialType (src/Trace.cl:28-34).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import jax
import jax.numpy as jnp


def _static(default):
    """A metadata field: part of the treedef, not a leaf."""
    return dataclasses.field(default=default, metadata={"static": True})


class MaterialType(enum.IntEnum):
    """MaterialType (Trace.cl:28-34)."""

    SOLID = 0
    CHECKER = 1
    INVISIBLE = 2
    GLASSY = 3
    ONE_SIDED = 4


@dataclasses.dataclass(frozen=True)
class Scene:
    """Frozen device-side scene.

    Triangles (T of them) and BVH nodes (M) are shared by all mesh
    instances; each of the K meshes references a BVH root plus a TRS
    transform and a material, mirroring MeshInfo (Trace.cl:59-65).
    """

    # Triangle soup: vertex positions and smooth vertex normals.
    tri_pos_a: jnp.ndarray  # (T, 3) f32
    tri_pos_b: jnp.ndarray
    tri_pos_c: jnp.ndarray
    tri_nrm_a: jnp.ndarray
    tri_nrm_b: jnp.ndarray
    tri_nrm_c: jnp.ndarray

    # Flat BVH (GPUNode semantics, src/readobj.hpp:27-31): ``index`` is
    # the first-triangle index for leaves and the first-child index for
    # internal nodes; siblings are adjacent (childIndex, childIndex+1).
    node_min: jnp.ndarray  # (M, 3) f32
    node_max: jnp.ndarray  # (M, 3) f32
    node_index: jnp.ndarray  # (M,) i32
    node_ntris: jnp.ndarray  # (M,) i32  (0 => internal node)

    # Threaded (stackless) traversal links, precomputed per mesh subtree:
    # on AABB hit of an internal node continue at node_hit (= first
    # child); on miss or after a leaf continue at node_miss; -1 ends the
    # walk. A lane-parallel replacement for the reference's per-thread
    # 64-entry traversal stack (Trace.cl:319-397).
    node_hit: jnp.ndarray  # (M,) i32
    node_miss: jnp.ndarray  # (M,) i32

    # Gather-packed mirrors for the traversal hot loop: the walk's cost
    # is the number of gathered ELEMENTS per step. Node rows
    # are 5 floats: AABB bounds quantised to uint16 on a per-mesh grid
    # (conservative — decoded boxes always contain the true box, so
    # traversal may visit slightly more nodes but images are identical;
    # hits come only from exact triangle tests):
    #   [0] qx_lo | qy_lo<<16   [1] qz_lo | qx_hi<<16   [2] qy_hi | qz_hi<<16
    #   [3] bitcast i32: first child (internal) / first triangle (leaf)
    #   [4] bitcast i32: (miss_link + 1) | (num_tris << 24)
    # Decode: bound = mesh_qmin + q * mesh_qscale (per-mesh grid params).
    # tri_packed rows stay exact f32: pa pb pc na nb nc (18 floats).
    node_q: jnp.ndarray  # (M, 5) f32
    tri_packed: jnp.ndarray  # (T, 18) f32
    mesh_qmin: jnp.ndarray  # (K, 3) f32 quantisation grid origin
    mesh_qscale: jnp.ndarray  # (K, 3) f32 quantisation cell size

    # Megakernel row bank: an 8-wide BVH encoding sized for the
    # persistent-lane integrator. The traversal currency is ROWS
    # VISITED (one row gather per step): an 8-wide node packs eight
    # children's uint8-quantised boxes (per-node grid, conservative)
    # plus their targets
    # into ONE row, and leaf rows carry both triangles inline, exact
    # f32. Node and leaf rows share one bank so each traversal step is
    # exactly one gather. Layouts in scene/builder._emit_mega_subtree.
    # The traversal CHAIN (static meta) lists the BVHs every ray visits
    # in order: one combined world-space BVH over all identity-transform
    # non-OneSided meshes, then each remaining instance.
    mega_rows: jnp.ndarray  # (Mm, builder.MEGA_ROW_WIDTH) f32

    #: Inline static stage: small identity-transform meshes (the
    #: Cornell quads) packed as (S, 19) exact triangle rows
    #: (pa pb pc na nb nc + bitcast-i32 owner mesh). The megakernel MT-
    #: tests these densely during its shade iteration — zero gathered
    #: rows, no chain entry — so wall-bound path segments never touch
    #: the traversal machinery. Per-tri cull/one-sided policy is static
    #: metadata (mega_static_cull / mega_static_onesided).
    mega_static_rows: jnp.ndarray  # (S, 19) f32

    # Mesh instances (K).
    mesh_root: jnp.ndarray  # (K,) i32 BVH root node per mesh
    mesh_pos: jnp.ndarray  # (K, 3) f32
    mesh_pitch: jnp.ndarray  # (K,) f32
    mesh_yaw: jnp.ndarray
    mesh_roll: jnp.ndarray
    mesh_scale: jnp.ndarray

    # Materials, one per mesh (RayTracingMaterial, Trace.cl:36-45).
    mat_type: jnp.ndarray  # (K,) i32
    mat_ior: jnp.ndarray  # (K,) f32
    mat_color: jnp.ndarray  # (K, 3) f32
    mat_emission_color: jnp.ndarray  # (K, 3) f32
    mat_emission_strength: jnp.ndarray  # (K,) f32
    mat_reflectiveness: jnp.ndarray  # (K,) f32
    mat_specular_prob: jnp.ndarray  # (K,) f32

    # --- static metadata (part of the treedef, jit-specialised) ---
    #: Largest leaf size across all BVHs; bounds the masked leaf loop.
    max_leaf_tris: int = _static(2)
    #: (first_tri, num_tris) per mesh — lets the integrator brute-force
    #: small meshes over a static triangle range.
    mesh_tri_ranges: Tuple[Tuple[int, int], ...] = _static(())
    #: Megakernel traversal chain: ((mesh_idx, root_row, root_is_leaf),
    #: ...) with mesh_idx == -1 for the combined static-geometry entry.
    mega_chain: Tuple[Tuple[int, int, bool], ...] = _static(())
    #: Member mesh ids per mega_chain entry: (i,) for a regular entry,
    #: the fused static-geometry members for a -1 entry. Lets the dense
    #: megakernel (render/plucker_fused.py) rebuild each entry's
    #: triangle set from mesh_tri_ranges without re-deriving the
    #: freeze-time routing.
    mega_chain_members: Tuple[Tuple[int, ...], ...] = _static(())
    #: Register-file traversal stack entries needed for the deepest
    #: 8-wide subtree (static; sets the megakernel's shift-chain length).
    mega_stack_depth: int = _static(8)
    #: Material type per mesh as known at freeze time (static mirror of
    #: mat_type, used only to ROUTE meshes between the fused sweep and
    #: the per-mesh path — OneSided meshes need per-mesh closest-hit
    #: semantics: the reference rejects a OneSided mesh's contribution
    #: only after that mesh's own query, Trace.cl:466-471).
    mesh_mat_types: Tuple[int, ...] = _static(())
    #: Backface-cull / one-sided policy per inline static triangle
    #: (static: known from the owner material at freeze).
    mega_static_cull: Tuple[bool, ...] = _static(())
    mega_static_onesided: Tuple[bool, ...] = _static(())
    #: Owner mesh id per inline static triangle (static twin of the
    #: bitcast-i32 word in column 18 of mega_static_rows — kept static
    #: so the hot loop needs no scalar bitcast).
    mega_static_owner: Tuple[int, ...] = _static(())
    #: True where the instance transform was identity at freeze time
    #: (pos=0, angles=0, scale=1 — e.g. the Cornell quads, which addQuad
    #: leaves untransformed, readobj.hpp:393). The intersector fuses all
    #: identity small meshes into one world-space brute-force sweep.
    mesh_identity: Tuple[bool, ...] = _static(())
    #: Node-row child-bounds encoding of mega_rows: "u8" (uint8 on a
    #: per-node grid, 3 words/slot at stride 3) or "bf16" (absolute
    #: conservative bf16, 4 words/slot at stride 4) — see
    #: builder._emit_mega_subtree. Static: selects the decode the
    #: megakernel's node branch compiles.
    mega_bounds_fmt: str = _static("u8")
    #: Inline exact triangles per leaf row in mega_rows (builder
    #: MEGA_LEAF_TRIS / config override; the kernel's leaf loop is
    #: unrolled to this static count).
    mega_leaf_tris: int = _static(8)
    #: Children per node row in mega_rows (builder MEGA_ARITY /
    #: config.MEGA_NODE_ARITY override; static in the kernel).
    mega_arity: int = _static(32)
    #: Instance-level acceleration (TLAS): True when freeze routed the
    #: non-identity meshes through a top-level BVH of INSTANCE ROWS in
    #: mega_rows (the many-instance regime, builder MEGA_TLAS_THRESHOLD)
    #: instead of one unrolled chain entry per mesh. The megakernel then
    #: compiles the instance enter/exit branches and the chain holds one
    #: (-2, tlas_root, False) entry covering every instanced mesh.
    #: Instance transforms are BAKED into the rows at freeze — post-
    #: freeze transform edits (anim.set_mesh_yaw) require a re-freeze.
    mega_tlas: bool = _static(False)
    #: World-space union bounds of all TLAS instances
    #: (lo.xyz + hi.xyz, 6 floats) — the -2 chain entry's root pretest
    #: box. Empty when mega_tlas is False.
    mega_tlas_bounds: Tuple[float, ...] = _static(())
    #: Freeze-time material DEDUP: per-mesh slot index into the unique
    #: materials (mesh_mat_slot, length K) and each slot's
    #: REPRESENTATIVE mesh (mat_slot_rep, length U) whose pack_materials
    #: row carries the slot's values. Lets the shade-time fetch run
    #: O(K + 11U) selects instead of O(11K) — the piece that keeps the
    #: loop body compact for many-instance (TLAS) scenes where
    #: hundreds of meshes share a handful of materials. viewer
    #: recolor_mesh re-slots a tinted mesh (see its docstring). Empty
    #: tuples on scenes frozen before this field existed (per-mesh
    #: fetch, the conservative default).
    mesh_mat_slot: Tuple[int, ...] = _static(())
    mat_slot_rep: Tuple[int, ...] = _static(())

    @property
    def num_triangles(self) -> int:
        return self.tri_pos_a.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_index.shape[0]

    @property
    def num_meshes(self) -> int:
        return self.mesh_root.shape[0]

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


jax.tree_util.register_dataclass(
    Scene,
    data_fields=[f.name for f in dataclasses.fields(Scene)
                 if not f.metadata.get("static")],
    meta_fields=[f.name for f in dataclasses.fields(Scene)
                 if f.metadata.get("static")],
)
