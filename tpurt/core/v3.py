"""Structure-of-arrays 3-vectors: a V3 is three same-shaped arrays.

Why this exists: a float32 array of shape (R, 3) puts the 3-component
axis innermost, so every elementwise op works on strided triples and
every component slice is a gather-like access. All hot device code
therefore carries vectors as V3 (x, y, z) pytrees of contiguous (R,)
arrays; (..., 3) arrays appear only at API boundaries (camera rays in,
radiance images out).

Every op here is an exact component transcription of the corresponding
tpurt.core.vecmath function — same operations, same order, same
rounding — so integrators built on either layout are bit-identical
(gated by the golden tests). Reference counterparts are the float3
helpers at src/math.hpp:97-179 and src/Trace.cl:80-156,219-236,401-432.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from tpurt.config import EPSILON


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # Arithmetic as infix operators so formulas read like vecmath.
    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __mul__(self, s):
        """Component-wise with another V3, or broadcast by a scalar array."""
        if isinstance(s, V3):
            return V3(self.x * s.x, self.y * s.y, self.z * s.z)
        return V3(self.x * s, self.y * s, self.z * s)

    def __rmul__(self, s):
        return V3(s * self.x, s * self.y, s * self.z)

    def __truediv__(self, s):
        if isinstance(s, V3):
            return V3(self.x / s.x, self.y / s.y, self.z / s.z)
        return V3(self.x / s, self.y / s, self.z / s)


def from_rows(a: jnp.ndarray) -> V3:
    """(..., 3) -> V3 of (...,) components (layout boundary)."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def to_rows(v: V3) -> jnp.ndarray:
    """V3 -> (..., 3) (layout boundary)."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def full_like(ref: jnp.ndarray, value) -> V3:
    c = jnp.full(ref.shape, value, jnp.float32)
    return V3(c, c, c)


def dot(a: V3, b: V3) -> jnp.ndarray:
    """Same association as vecmath.dot3's 3-element sum: (x + y) + z."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: V3) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    """a * rsqrt(a.a), exactly vecmath.normalize3."""
    inv = lax.rsqrt(dot(a, a))
    return V3(a.x * inv, a.y * inv, a.z * inv)


def lerp(a: V3, b: V3, t) -> V3:
    """a*(1-t) + b*t (Trace.cl:84)."""
    w = 1.0 - t
    return V3(a.x * w + b.x * t, a.y * w + b.y * t, a.z * w + b.z * t)


def where(mask: jnp.ndarray, a: V3, b: V3) -> V3:
    return V3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def reflect(in_dir: V3, normal: V3) -> V3:
    """Trace.cl:234-236 — in - 2*dot(in,n)*n."""
    k = 2.0 * dot(in_dir, normal)
    return V3(in_dir.x - k * normal.x, in_dir.y - k * normal.y,
              in_dir.z - k * normal.z)


def refract(in_dir: V3, normal: V3, ior_a, ior_b) -> V3:
    """Snell refraction, zero vector on TIR (Trace.cl:219-232); mirrors
    vecmath.refract op for op."""
    ratio = ior_a / ior_b
    cos_in = -dot(in_dir, normal)
    sin_sqr_refr = ratio * ratio * (1.0 - cos_in * cos_in)
    tir = sin_sqr_refr > 1.0
    root = jnp.sqrt(jnp.maximum(1.0 - sin_sqr_refr, 0.0))
    k = ratio * cos_in - root
    out = V3(
        ratio * in_dir.x + k * normal.x,
        ratio * in_dir.y + k * normal.y,
        ratio * in_dir.z + k * normal.z,
    )
    return where(tir, full_like(out.x, 0.0), out)


def fresnel_reflectance(in_dir: V3, normal: V3, ior_a, ior_b) -> jnp.ndarray:
    """Full s/p-average Fresnel (Trace.cl:401-432); mirrors
    vecmath.fresnel_reflectance."""
    ratio = ior_a / ior_b
    cos_in = -dot(in_dir, normal)
    sin_sqr_refr = ratio * ratio * (1.0 - cos_in * cos_in)
    cos_refr = jnp.sqrt(jnp.maximum(1.0 - sin_sqr_refr, 0.0))
    denom = ior_a * cos_in + ior_b * cos_refr
    r_perp = (ior_a * cos_in - ior_b * cos_refr) / denom
    r_par = (ior_b * cos_in - ior_a * cos_refr) / denom
    refl = 0.5 * (r_perp * r_perp + r_par * r_par)
    degenerate = (cos_in <= 0.0) | (sin_sqr_refr >= 1.0) | (denom < EPSILON)
    return jnp.where(degenerate, 1.0, refl)
