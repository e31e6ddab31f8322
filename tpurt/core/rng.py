"""Bit-exact counterpart of the reference's 32-bit stateful PRNG.

The reference threads a single ``uint`` state through the whole path
trace (src/Trace.cl:158-217). Pixel parity of the whole framework keys
off reproducing that stream exactly, so every function here is a pure
uint32-arithmetic transcription:

  * ``make_seed``       — MakeSeed(pixelIndex, frameIndex, rayIdx), Trace.cl:170-177
  * ``random_value``    — RandomValue (LCG + variable-shift xor hash),  Trace.cl:163-168
  * ``rand01``          — rand01 (same LCG, murmur-style finalizer),    Trace.cl:209-217
  * ``random_normal``   — Box-Muller,                                   Trace.cl:179-187
  * ``random_direction``— normalized 3-Gaussian w/ NaN fallback (0,1,0),Trace.cl:189-200
  * ``random_hemisphere_direction`` — sign-flipped direction,           Trace.cl:202-207

State is any-shaped jnp.uint32; all functions are (state) -> (new_state,
sample) so lanes vectorise freely. The ``*_masked`` variants advance the
state only where ``mask`` is True — that is how a SIMD integrator keeps
per-lane streams identical to the reference's divergent scalar control
flow (different material branches draw different numbers of samples).

Design note: the two generators share the same LCG state update
(state*747796405 + 2891336453) and differ only in the output hash, so a
masked draw is a cheap select on the state.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax.numpy as jnp

TAU = 6.28318530717958647692  # Trace.cl:5
_EPS = 1e-6

_U32 = jnp.uint32


def _u32(x) -> jnp.ndarray:
    """uint32 cast. Host (numpy) values become numpy scalars/arrays on
    purpose: tiny jnp constants created during tracing land in JAX's
    value cache as concrete device arrays, and later traces CAPTURE the
    cached array as an extra executable parameter — which breaks
    dispatch for executables compiled before the constant existed
    ('Execution supplied N buffers but compiled program expected N+2').
    numpy constants embed as literals instead."""
    if isinstance(x, (int, np.integer)):
        return np.uint32(x)
    if isinstance(x, np.ndarray):
        return x.astype(np.uint32)
    return jnp.asarray(x, dtype=_U32)


def u32_to_f32_exact(s: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 with the same round-to-nearest as a direct
    convert, but WITHOUT a u32->f32 cast op: the value goes through two
    exact i32 halves (hi*2^16 is exact in f32 and the final add rounds
    once — bit-identical to the direct conversion)."""
    lo = (s & _u32(0xFFFF)).astype(jnp.int32).astype(jnp.float32)
    hi = (s >> _u32(16)).astype(jnp.int32).astype(jnp.float32)
    return hi * jnp.float32(65536.0) + lo


def u32_to_unit_float(s: jnp.ndarray) -> jnp.ndarray:
    """SafelyMapU32ToFloat: (s+1)/2^32 in float32 (Trace.cl:158-161).

    Keeps the reference's wrap quirk: s == 0xFFFFFFFF maps to exactly 0.
    """
    return u32_to_f32_exact(s + _u32(1)) * jnp.float32(1.0 / 4294967296.0)


def lcg_step(state: jnp.ndarray) -> jnp.ndarray:
    """The shared LCG state update used by both generators."""
    return state * _u32(747796405) + _u32(2891336453)


def make_seed(pixel_index, frame_index, ray_idx) -> jnp.ndarray:
    """MakeSeed (Trace.cl:170-177): LCG-mixed 32-bit seed."""
    pixel_index = _u32(pixel_index)
    frame_index = jnp.asarray(frame_index, jnp.int32).astype(_U32)
    ray_idx = _u32(ray_idx)
    s = pixel_index * _u32(1664525) + frame_index * _u32(1013904223)
    s = s ^ (ray_idx + _u32(0x9E3779B9))
    return s * _u32(22695477) + _u32(1)


def random_value(state: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """RandomValue (Trace.cl:163-168) -> (new_state, float in (0,1))."""
    state = lcg_step(state)
    shift = (state >> _u32(28)) + _u32(4)
    result = ((state >> shift) ^ state) * _u32(277803737)
    result = (result >> _u32(22)) ^ result
    return state, u32_to_unit_float(result)


def rand01(state: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """rand01 (Trace.cl:209-217) -> (new_state, float in (0,1))."""
    state = lcg_step(state)
    z = state
    z = (z ^ (z >> _u32(16))) * _u32(0x7FEB352D)
    z = (z ^ (z >> _u32(15))) * _u32(0x846CA68B)
    z = z ^ (z >> _u32(16))
    return state, u32_to_unit_float(z)


def random_normal(state: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Box-Muller standard normal (Trace.cl:179-187); draws twice."""
    state, u1 = random_value(state)
    state, u2 = random_value(state)
    u1 = jnp.maximum(u1, jnp.float32(_EPS))
    r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(u1))
    theta = jnp.float32(TAU) * u2
    return state, r * jnp.cos(theta)


def random_direction(state: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform sphere direction via 3 Gaussians (Trace.cl:189-200).

    Returns (new_state, (..., 3) unit vector). Non-finite results fall
    back to (0, 1, 0) exactly like the kernel's isfinite guard.
    """
    state, x = random_normal(state)
    state, y = random_normal(state)
    state, z = random_normal(state)
    from tpurt.core.vecmath import normalize3

    v = normalize3(jnp.stack([x, y, z], axis=-1))
    bad = ~jnp.all(jnp.isfinite(v), axis=-1, keepdims=True)
    fallback = np.array([0.0, 1.0, 0.0], dtype=np.float32)  # host constant
    return state, jnp.where(bad, fallback, v)


def random_direction_soa(state: jnp.ndarray):
    """random_direction in SoA form -> (new_state, (x, y, z) components).

    Identical draws and arithmetic to random_direction (the stacked
    form), just without materialising the (..., 3) layout — see
    tpurt.core.v3 for why the hot path carries components."""
    from jax import lax

    state, x = random_normal(state)
    state, y = random_normal(state)
    state, z = random_normal(state)
    inv = lax.rsqrt(x * x + y * y + z * z)
    vx, vy, vz = x * inv, y * inv, z * inv
    bad = ~(jnp.isfinite(vx) & jnp.isfinite(vy) & jnp.isfinite(vz))
    # NaN fallback (0, 1, 0), Trace.cl:195-199.
    vx = jnp.where(bad, np.float32(0.0), vx)
    vy = jnp.where(bad, np.float32(1.0), vy)
    vz = jnp.where(bad, np.float32(0.0), vz)
    return state, (vx, vy, vz)


def random_hemisphere_direction(
    normal: jnp.ndarray, state: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sign-flipped sphere sample (Trace.cl:202-207; unused by the live
    reference path but part of its kernel API surface)."""
    state, d = random_direction(state)
    flip = jnp.sum(d * normal, axis=-1, keepdims=True) < 0.0
    return state, jnp.where(flip, -d, d)


def sample_hemisphere_cosine(
    normal: jnp.ndarray, state: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cosine-weighted hemisphere sample (Trace.cl:238-257; defined but
    never called in the reference — kept for API parity)."""
    state, r1 = rand01(state)
    state, r2 = rand01(state)
    r = jnp.sqrt(r1)
    phi = jnp.float32(TAU) * r2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - r1))
    up = jnp.where(
        (jnp.abs(normal[..., 2:3]) < 0.999),
        np.array([0.0, 0.0, 1.0], np.float32),
        np.array([1.0, 0.0, 0.0], np.float32),
    )
    from tpurt.core.vecmath import cross3, normalize3

    t = normalize3(cross3(up, normal))
    b = cross3(normal, t)
    d = t * x[..., None] + b * y[..., None] + normal * z[..., None]
    return state, normalize3(d)


# ---------------------------------------------------------------------------
# Masked draws: advance state only on lanes where the reference's scalar
# control flow would have drawn. The returned sample is garbage on masked
# lanes and must be gated by the caller.
# ---------------------------------------------------------------------------


def random_value_masked(state, mask):
    new_state, x = random_value(state)
    return jnp.where(mask, new_state, state), x


def rand01_masked(state, mask):
    new_state, x = rand01(state)
    return jnp.where(mask, new_state, state), x


def random_direction_masked(state, mask):
    new_state, d = random_direction(state)
    return jnp.where(mask, new_state, state), d


def random_direction_masked_soa(state, mask):
    new_state, d = random_direction_soa(state)
    return jnp.where(mask, new_state, state), d
