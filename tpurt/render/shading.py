"""Shared material shading step.

The single transcription of the Trace() material branches + common tail
(src/Trace.cl:502-591) used by BOTH integrators (the modular bounce
loop and the persistent-lane megakernel), so their RNG consumption and
arithmetic agree bit-for-bit by construction.

Materials are fetched with a select chain over the (small, static) mesh
count instead of gathers: K broadcast selects are ordinary fused
elementwise ops.

The core (``shade_hit_soa``) carries vectors as tpurt.core.v3.V3
component triples (see v3.py's module docstring) — and ``shade_hit``
is the (R, 3)-layout wrapper used
by the modular engine. Both produce bit-identical results (the wrapper
only repacks components).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from tpurt.config import EPSILON, IOR_AIR
from tpurt.core import rng as rnglib
from tpurt.core import v3 as v3lib
from tpurt.core.v3 import V3
from tpurt.scene.types import MaterialType, Scene


class ShadeResultSoA(NamedTuple):
    origin: V3
    direction: V3
    throughput: V3
    light: V3
    rng: jnp.ndarray  # (R,) u32
    bounces: jnp.ndarray  # (R,) i32
    continuing: jnp.ndarray  # (R,) bool — path goes on (per Trace.cl exit rules)
    invisible: jnp.ndarray  # (R,) bool — pass-through hit (no bounce spent)


class ShadeResult(NamedTuple):
    origin: jnp.ndarray  # (R, 3)
    direction: jnp.ndarray
    throughput: jnp.ndarray
    light: jnp.ndarray
    rng: jnp.ndarray  # (R,) u32
    bounces: jnp.ndarray  # (R,) i32
    continuing: jnp.ndarray  # (R,) bool
    invisible: jnp.ndarray  # (R,) bool


# Packed material table columns (pack_materials): mat_type rides as f32
# (values 0-4 are exact), everything else is f32 anyway. The select
# chain reads it by scalar [i, c] indexing.
MAT_TYPE, MAT_IOR = 0, 1
MAT_COLOR, MAT_EMC = 2, 5  # 3 columns each
MAT_EMS, MAT_REFL, MAT_SPEC = 8, 9, 10
MAT_WIDTH = 11


def pack_materials(scene: Scene) -> jnp.ndarray:
    """(K, 11) f32 material table from the Scene's per-mesh columns."""
    return jnp.stack(
        [
            scene.mat_type.astype(jnp.float32),
            scene.mat_ior,
            scene.mat_color[:, 0], scene.mat_color[:, 1], scene.mat_color[:, 2],
            scene.mat_emission_color[:, 0], scene.mat_emission_color[:, 1],
            scene.mat_emission_color[:, 2],
            scene.mat_emission_strength,
            scene.mat_reflectiveness,
            scene.mat_specular_prob,
        ],
        axis=1,
    )


def select_material_soa(mats, num_meshes: int, mesh_idx: jnp.ndarray,
                        mat_slots=None):
    """Gather-free material fetch: chain of broadcast selects over the
    static mesh count. ``mats`` is the (K, 11) pack_materials table (any
    scalar-[i, c]-indexable reader). Returns per-lane material
    fields (colors as V3); mtype stays f32 (exact small ints).

    ``mat_slots`` — a static (mesh->slot tuple, slot->rep-mesh tuple)
    pair from freeze-time material DEDUP (Scene.mesh_mat_slot /
    mat_slot_rep) — switches to a two-level fetch: one O(K) single-i32
    select chain maps the mesh to its slot, then the 11 field chains
    run over the U unique materials only (O(K + 11U) ops instead of
    O(11K)). This is what keeps the loop body compact at large
    instance counts (the TLAS regime): instanced scenes share a
    handful of materials across hundreds of meshes.

    Otherwise, above SELECT_GATHER_THRESHOLD meshes the chain becomes
    one real gather of the transposed table — (11, R) so every fetched
    column is a contiguous lane vector."""
    from tpurt.config import SELECT_GATHER_THRESHOLD

    if mat_slots is not None:
        slot_map, reps = mat_slots
        # mesh -> slot (slot 0 is the default: meshes mapping there
        # need no select).
        slot = jnp.zeros(mesh_idx.shape, jnp.int32)
        for i in range(num_meshes):
            si = int(slot_map[i])
            if si:
                slot = jnp.where(mesh_idx == i, si, slot)
        zeros = jnp.zeros(mesh_idx.shape, jnp.float32)
        mtype = zeros
        ior = zeros
        color = V3(zeros, zeros, zeros)
        em_color = V3(zeros, zeros, zeros)
        em_strength = zeros
        refl = zeros
        spec = zeros
        for s, rep in enumerate(reps):
            m = slot == s
            i = int(rep)
            mtype = jnp.where(m, mats[i, MAT_TYPE], mtype)
            ior = jnp.where(m, mats[i, MAT_IOR], ior)
            color = V3(
                jnp.where(m, mats[i, MAT_COLOR], color.x),
                jnp.where(m, mats[i, MAT_COLOR + 1], color.y),
                jnp.where(m, mats[i, MAT_COLOR + 2], color.z),
            )
            em_color = V3(
                jnp.where(m, mats[i, MAT_EMC], em_color.x),
                jnp.where(m, mats[i, MAT_EMC + 1], em_color.y),
                jnp.where(m, mats[i, MAT_EMC + 2], em_color.z),
            )
            em_strength = jnp.where(m, mats[i, MAT_EMS], em_strength)
            refl = jnp.where(m, mats[i, MAT_REFL], refl)
            spec = jnp.where(m, mats[i, MAT_SPEC], spec)
        return mtype, ior, color, em_color, em_strength, refl, spec

    if num_meshes > SELECT_GATHER_THRESHOLD:
        rows = mats.T[:, jnp.clip(mesh_idx, 0, num_meshes - 1)]  # (11, R)
        return (
            rows[MAT_TYPE], rows[MAT_IOR],
            V3(rows[MAT_COLOR], rows[MAT_COLOR + 1], rows[MAT_COLOR + 2]),
            V3(rows[MAT_EMC], rows[MAT_EMC + 1], rows[MAT_EMC + 2]),
            rows[MAT_EMS], rows[MAT_REFL], rows[MAT_SPEC],
        )
    zeros = jnp.zeros(mesh_idx.shape, jnp.float32)
    mtype = zeros
    ior = zeros
    color = V3(zeros, zeros, zeros)
    em_color = V3(zeros, zeros, zeros)
    em_strength = zeros
    refl = zeros
    spec = zeros
    for i in range(num_meshes):
        m = mesh_idx == i
        mtype = jnp.where(m, mats[i, MAT_TYPE], mtype)
        ior = jnp.where(m, mats[i, MAT_IOR], ior)
        color = V3(
            jnp.where(m, mats[i, MAT_COLOR], color.x),
            jnp.where(m, mats[i, MAT_COLOR + 1], color.y),
            jnp.where(m, mats[i, MAT_COLOR + 2], color.z),
        )
        em_color = V3(
            jnp.where(m, mats[i, MAT_EMC], em_color.x),
            jnp.where(m, mats[i, MAT_EMC + 1], em_color.y),
            jnp.where(m, mats[i, MAT_EMC + 2], em_color.z),
        )
        em_strength = jnp.where(m, mats[i, MAT_EMS], em_strength)
        refl = jnp.where(m, mats[i, MAT_REFL], refl)
        spec = jnp.where(m, mats[i, MAT_SPEC], spec)
    return mtype, ior, color, em_color, em_strength, refl, spec


def mat_types_present(scene: Scene):
    """Static material-type set for branch pruning (None when the scene
    predates the static mirror — prune nothing)."""
    if scene.mesh_mat_types:
        return tuple(sorted(set(int(t) for t in scene.mesh_mat_types)))
    return None


def select_material(scene: Scene, mesh_idx: jnp.ndarray):
    """Row-layout compatibility fetch: colors as (R, 3)."""
    mtype, ior, color, em_color, em_strength, refl, spec = select_material_soa(
        pack_materials(scene), scene.num_meshes, mesh_idx
    )
    return (
        mtype.astype(jnp.int32), ior, v3lib.to_rows(color),
        v3lib.to_rows(em_color), em_strength, refl, spec,
    )


def shade_hit_soa(
    mats,  # (K, 11) pack_materials table
    num_meshes: int,
    enabled: jnp.ndarray,  # (R,) bool — lanes taking a shade step now
    hit_valid: jnp.ndarray,
    hit_point: V3,
    hit_normal: V3,
    hit_backface: jnp.ndarray,
    hit_mesh: jnp.ndarray,
    origin: V3,
    direction: V3,
    throughput: V3,
    light: V3,
    rng: jnp.ndarray,
    bounces: jnp.ndarray,
    max_bounces: int,
    present: tuple = None,
    mat_slots=None,
) -> ShadeResultSoA:
    """One material interaction for lanes where ``enabled``; all other
    lanes pass through untouched (including their RNG stream).

    ``present`` (static) is the set of material-type ints that can occur
    in the scene (Scene.mesh_mat_types); branches for absent types are
    pruned from the program. Bitwise-identical to the unpruned body: an
    absent type's mask is all-False, so its selects are identity and its
    masked RNG draws pass the stream through unchanged
    (rnglib.*_masked freeze non-participating lanes). None = keep all
    branches (the conservative default)."""
    def _has(mt: MaterialType) -> bool:
        return present is None or int(mt) in present

    def _falses(like):
        # Lane-shaped all-False via an i32 compare (see
        # megakernel._bool_full).
        return jnp.zeros(like.shape, jnp.int32) != 0

    mtype, ior, color, em_color, em_strength, refl, spec_prob = (
        select_material_soa(mats, num_meshes, jnp.maximum(hit_mesh, 0),
                            mat_slots=mat_slots)
    )

    a_hit = enabled & hit_valid
    if _has(MaterialType.INVISIBLE):
        invisible = a_hit & (mtype == int(MaterialType.INVISIBLE))
        scatter = a_hit & ~invisible
    else:
        invisible = _falses(a_hit)
        scatter = a_hit

    # --- Checker cell selection (Trace.cl:509-524) ---
    # Deliberate deviation: cell size 1 when emissionStrength == 0; the
    # reference divides unguarded (Trace.cl:511-515) — see README.
    if _has(MaterialType.CHECKER):
        is_checker = scatter & (mtype == int(MaterialType.CHECKER))
        checker_size = jnp.where(em_strength != 0.0, em_strength, 1.0)
        xi = jnp.floor(hit_point.x / checker_size).astype(jnp.int32)
        zi = jnp.floor(hit_point.z / checker_size).astype(jnp.int32)
        is_even = ((xi + zi) & 1) == 0
        checker_color = v3lib.where(is_even, color, em_color)
        color = v3lib.where(is_checker, checker_color, color)
        em_strength = jnp.where(is_checker, 0.0, em_strength)
    else:
        is_checker = _falses(scatter)

    # --- Diffuse/specular scatter: Checker + Solid (Trace.cl:525-533,559-567) ---
    new_rng = rng
    if _has(MaterialType.SOLID) or _has(MaterialType.CHECKER):
        mask_cs = is_checker | (scatter & (mtype == int(MaterialType.SOLID)))
        new_rng, rv = rnglib.random_value_masked(new_rng, mask_cs)
        new_rng, (rdx, rdy, rdz) = rnglib.random_direction_masked_soa(
            new_rng, mask_cs
        )
        is_specular = spec_prob >= rv
        diffuse_dir = v3lib.normalize(hit_normal + V3(rdx, rdy, rdz))
        specular_dir = v3lib.reflect(direction, hit_normal)
        dir_cs = v3lib.normalize(
            v3lib.lerp(diffuse_dir, specular_dir,
                       refl * is_specular.astype(jnp.float32))
        )
    else:
        mask_cs = is_checker
        dir_cs = direction

    # --- Glassy (Trace.cl:534-558) ---
    if _has(MaterialType.GLASSY):
        is_glassy = scatter & (mtype == int(MaterialType.GLASSY))
        ior_cur = jnp.where(hit_backface, ior, IOR_AIR)
        ior_next = jnp.where(hit_backface, IOR_AIR, ior)
        reflect_dir = v3lib.reflect(direction, hit_normal)
        refract_dir = v3lib.refract(direction, hit_normal, ior_cur, ior_next)
        reflect_w = v3lib.fresnel_reflectance(
            direction, hit_normal, ior_cur, ior_next
        )
        new_rng, r01 = rnglib.rand01_masked(new_rng, is_glassy)
        will_reflect = r01 < reflect_w
        dir_glassy = v3lib.where(will_reflect, reflect_dir, refract_dir)
        glassy_w = jnp.where(will_reflect, reflect_w, 1.0 - reflect_w)

        new_dir = v3lib.where(
            is_glassy, dir_glassy, v3lib.where(mask_cs, dir_cs, direction)
        )
        throughput_new = throughput * jnp.where(is_glassy, glassy_w, 1.0)
    else:
        new_dir = v3lib.where(mask_cs, dir_cs, direction)
        throughput_new = throughput

    # --- Common tail (Trace.cl:574-591) ---
    # Masked contributions keep the original add-zero / mul-one forms
    # (not selects) so -0.0 edges stay bit-identical to the row-layout
    # implementation this replaced.
    emission = em_color * em_strength
    zero = np.float32(0.0)
    one = np.float32(1.0)
    contrib = throughput_new * emission
    light_new = light + V3(
        jnp.where(scatter, contrib.x, zero),
        jnp.where(scatter, contrib.y, zero),
        jnp.where(scatter, contrib.z, zero),
    )
    eps = np.float32(EPSILON)
    origin_new = v3lib.where(scatter, hit_point + new_dir * eps, origin)
    if _has(MaterialType.INVISIBLE):
        origin_new = v3lib.where(
            invisible, hit_point + direction * eps, origin_new
        )
    throughput_new = throughput_new * V3(
        jnp.where(scatter, color.x, one),
        jnp.where(scatter, color.y, one),
        jnp.where(scatter, color.z, one),
    )

    # Russian roulette after bounce 3 (Trace.cl:583-590).
    # Same association as jnp.max over a 3-axis: (x max y) max z.
    p = jnp.maximum(jnp.maximum(throughput_new.x, throughput_new.y),
                    throughput_new.z)
    rr = scatter & (bounces > 3)
    q = jnp.maximum(0.05, 1.0 - p)
    new_rng, r01_rr = rnglib.rand01_masked(new_rng, rr)
    killed = rr & (r01_rr < q)
    surv = rr & ~killed
    throughput_new = v3lib.where(
        surv, throughput_new / (1.0 - q), throughput_new
    )

    bounces_new = bounces + scatter.astype(jnp.int32)
    continuing = a_hit & ~killed & (bounces_new < max_bounces)
    # Invisible lanes stay continuing without spending a bounce; miss
    # lanes (enabled & ~hit_valid) break (Trace.cl:497-501).

    return ShadeResultSoA(
        origin=v3lib.where(enabled, origin_new, origin),
        direction=v3lib.where(scatter, new_dir, direction),
        throughput=v3lib.where(enabled, throughput_new, throughput),
        light=v3lib.where(enabled, light_new, light),
        rng=new_rng,  # masked draws already froze non-participating lanes
        bounces=jnp.where(enabled, bounces_new, bounces),
        continuing=continuing,
        invisible=invisible,
    )


def shade_hit(
    scene: Scene,
    enabled: jnp.ndarray,
    hit_valid: jnp.ndarray,
    hit_point: jnp.ndarray,  # (R, 3)
    hit_normal: jnp.ndarray,
    hit_backface: jnp.ndarray,
    hit_mesh: jnp.ndarray,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    throughput: jnp.ndarray,
    light: jnp.ndarray,
    rng: jnp.ndarray,
    bounces: jnp.ndarray,
    max_bounces: int,
) -> ShadeResult:
    """(R, 3)-layout wrapper over shade_hit_soa (the modular engine's
    calling convention); numerically identical — only repacks. Prunes
    absent-material branches from the static Scene.mesh_mat_types."""
    res = shade_hit_soa(
        pack_materials(scene), scene.num_meshes, enabled, hit_valid,
        v3lib.from_rows(hit_point), v3lib.from_rows(hit_normal),
        hit_backface, hit_mesh,
        v3lib.from_rows(origin), v3lib.from_rows(direction),
        v3lib.from_rows(throughput), v3lib.from_rows(light),
        rng, bounces, max_bounces,
        present=mat_types_present(scene),
    )
    return ShadeResult(
        origin=v3lib.to_rows(res.origin),
        direction=v3lib.to_rows(res.direction),
        throughput=v3lib.to_rows(res.throughput),
        light=v3lib.to_rows(res.light),
        rng=res.rng,
        bounces=res.bounces,
        continuing=res.continuing,
        invisible=res.invisible,
    )
