"""Vector math on (..., 3) float32 arrays.

Array counterpart of the reference's scalar helpers: host float3
operators (src/math.hpp:97-179) and the device helpers in
src/Trace.cl:80-156 (lerp3, makeRotation, mul_mat_vec, transpose_mat,
WorldToLocalRay, LocalToWorldHit) plus the optics helpers at
src/Trace.cl:219-236,401-432 (refract, reflect, CalculateReflectance).

Everything is shape-polymorphic over leading batch dims: a "vector" is
any float32 array whose last axis has size 3, so the same functions
serve one ray or a million rays. Rotation matrices are (..., 3, 3).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from tpurt.config import EPSILON


def dot3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3-vector dot product -> (...,)."""
    return jnp.sum(a * b, axis=-1)


def cross3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length3(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(dot3(a, a))


def normalize3(a: jnp.ndarray) -> jnp.ndarray:
    """a / |a| with rsqrt (the reference uses fast_normalize everywhere)."""
    return a * lax.rsqrt(dot3(a, a))[..., None]


def lerp3(a: jnp.ndarray, b: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """a*(1-t) + b*t with t broadcast over the vector axis (Trace.cl:84)."""
    t = jnp.asarray(t)[..., None]
    return a * (1.0 - t) + b * t


def reflect(in_dir: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection (Trace.cl:234-236)."""
    return in_dir - 2.0 * dot3(in_dir, normal)[..., None] * normal


def refract(
    in_dir: jnp.ndarray, normal: jnp.ndarray, ior_a: jnp.ndarray, ior_b: jnp.ndarray
) -> jnp.ndarray:
    """Snell refraction; zero vector on total internal reflection
    (Trace.cl:219-232)."""
    ratio = ior_a / ior_b
    cos_in = -dot3(in_dir, normal)
    sin_sqr_refr = ratio * ratio * (1.0 - cos_in * cos_in)
    tir = sin_sqr_refr > 1.0
    # Clamp the sqrt argument so masked-out lanes don't produce NaN.
    root = jnp.sqrt(jnp.maximum(1.0 - sin_sqr_refr, 0.0))
    out = ratio[..., None] * in_dir + (ratio * cos_in - root)[..., None] * normal
    return jnp.where(tir[..., None], 0.0, out)


def fresnel_reflectance(
    in_dir: jnp.ndarray, normal: jnp.ndarray, ior_a: jnp.ndarray, ior_b: jnp.ndarray
) -> jnp.ndarray:
    """Unpolarised Fresnel reflectance, the full (non-Schlick) average of
    s/p polarisations (Trace.cl:401-432). Returns 1 on grazing/TIR."""
    ratio = ior_a / ior_b
    cos_in = -dot3(in_dir, normal)
    sin_sqr_refr = ratio * ratio * (1.0 - cos_in * cos_in)
    cos_refr = jnp.sqrt(jnp.maximum(1.0 - sin_sqr_refr, 0.0))
    denom = ior_a * cos_in + ior_b * cos_refr
    r_perp = (ior_a * cos_in - ior_b * cos_refr) / denom
    r_par = (ior_b * cos_in - ior_a * cos_refr) / denom
    refl = 0.5 * (r_perp * r_perp + r_par * r_par)
    degenerate = (cos_in <= 0.0) | (sin_sqr_refr >= 1.0) | (denom < EPSILON)
    return jnp.where(degenerate, 1.0, refl)


def euler_rotation(
    pitch: jnp.ndarray, yaw: jnp.ndarray, roll: jnp.ndarray
) -> jnp.ndarray:
    """XYZ-Euler rotation matrix, rows exactly as makeRotation
    (Trace.cl:90-100). Returns (..., 3, 3); apply with ``rotate``.
    """
    cx, sx = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    cz, sz = jnp.cos(roll), jnp.sin(roll)
    row0 = jnp.stack([cy * cz, cy * sz, -sy], axis=-1)
    row1 = jnp.stack([cz * sy * sx - cx * sz, cx * cz + sx * sy * sz, cy * sx], axis=-1)
    row2 = jnp.stack([sx * sz + cx * cz * sy, cx * sy * sz - cz * sx, cx * cy], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def rotate(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """mul_mat_vec(m, v): each output component is dot(row_i, v)
    (Trace.cl:105-107). m: (..., 3, 3), v: (..., 3).

    Written as explicit f32 multiply-adds in the reference's order, not
    as a matrix product: a dot may run at reduced (TF32) precision on a
    GPU's tensor cores."""
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [m[..., i, 0] * v0 + m[..., i, 1] * v1 + m[..., i, 2] * v2
         for i in range(3)],
        axis=-1,
    )


def rotate_t(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """mul_mat_vec(transpose(m), v) without materialising the transpose
    (explicit multiply-adds, as in ``rotate``)."""
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [m[..., 0, i] * v0 + m[..., 1, i] * v1 + m[..., 2, i] * v2
         for i in range(3)],
        axis=-1,
    )


def hsv2rgb(h: jnp.ndarray, s: jnp.ndarray, v: jnp.ndarray):
    """HSV -> RGB with the reference's sector semantics
    (src/math.hpp:19-75: h in degrees with h >= 360 wrapping to 0, s/v
    in [0,1]; s <= 0 returns the grey (v, v, v)). Dead code in the
    reference's live path (used only in commented-out tile-debug tints,
    src/image.hpp:392-398); transcribed for symbol-level completeness.
    Vectorised: h/s/v broadcast, returns (..., 3)."""
    h = jnp.asarray(h, jnp.float32)
    s = jnp.asarray(s, jnp.float32)
    v = jnp.asarray(v, jnp.float32)
    hh = jnp.where(h >= 360.0, 0.0, h) / 60.0
    # C's ``(long)hh`` truncates toward zero (math.hpp:33); sectors
    # outside 0..4 — including negative h — take the switch's default
    # arm (case 5), which jnp.select's default reproduces below.
    i = jnp.trunc(hh)
    ff = hh - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * ff)
    t = v * (1.0 - s * (1.0 - ff))
    sector = i.astype(jnp.int32)
    r = jnp.select(
        [sector == 0, sector == 1, sector == 2, sector == 3, sector == 4],
        [v, q, p, p, t], default=v)
    g = jnp.select(
        [sector == 0, sector == 1, sector == 2, sector == 3, sector == 4],
        [t, v, v, q, p], default=p)
    b = jnp.select(
        [sector == 0, sector == 1, sector == 2, sector == 3, sector == 4],
        [p, p, t, v, v], default=q)
    rgb = jnp.stack([r, g, b], axis=-1)
    grey = jnp.stack([v, v, v], axis=-1)
    return jnp.where((s <= 0.0)[..., None], grey, rgb)
