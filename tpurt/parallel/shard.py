"""Multi-chip frame rendering via shard_map.

The SPMD replacement for the reference's host-threaded dynamic
tile work queue (src/image.hpp:280-350): instead of one std::thread per
device popping (tileX, tileY) under a mutex and reading frames back
over PCIe, the frame is decomposed statically over the device mesh and
every chip runs the same jitted program on its shard — no host in the
loop, no mutexes, results assembled by XLA's collectives.

Decomposition:
  * ``tile`` axis: contiguous row blocks of the image. Each device owns
    rows [k*rows_per_dev, (k+1)*rows_per_dev). Because seeds are pure
    functions of absolute pixel coordinates (core/camera.py), a sharded
    render is BITWISE identical to the single-chip render — the
    property the reference's per-device seeding broke
    (image.hpp:228,304).
  * ``sample`` axis (optional, needs seed_mode="decorrelated"): device
    column j renders samples [j*local_spp, (j+1)*local_spp) and the
    radiance means are combined with a psum. Equal to the single-chip
    estimator up to f32 summation reassociation.

The scene/camera pytrees are replicated (the triangle buffers are MBs,
mirroring the reference's per-device scene replication,
main.cpp:709-717); only the output image is sharded.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from tpurt.config import RenderConfig
from tpurt.core.camera import Camera
from tpurt.parallel.mesh import SAMPLE_AXIS, TILE_AXIS, make_mesh
from tpurt.render.renderer import (
    _mega_flat_full,
    _mega_statics,
    _render_tile_impl,
)
from tpurt.scene.types import Scene


def _padded_rows(height: int, n_tile: int) -> int:
    return -(-height // n_tile) * n_tile


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "mesh", "n_tile", "n_sample", "rows_per_dev"),
)
def _render_sharded_impl(
    scene: Scene,
    camera: Camera,
    frame_index,
    *,
    cfg: RenderConfig,
    mesh: Mesh,
    n_tile: int,
    n_sample: int,
    rows_per_dev: int,
):
    local_spp = cfg.rays_per_pixel // n_sample

    def worker(scene, camera, frame_index):
        ti = lax.axis_index(TILE_AXIS)
        si = lax.axis_index(SAMPLE_AXIS)
        y0 = (ti * rows_per_dev).astype(jnp.int32)
        sample0 = si * jnp.int32(local_spp)
        coords = jnp.stack(
            [jnp.int32(0), y0, jnp.asarray(frame_index, jnp.int32), sample0]
        )
        block, _ = _render_tile_impl(
            scene, camera, coords,
            tile_h=rows_per_dev, tile_w=cfg.width,
            width=cfg.width, height=cfg.height,
            rays_per_pixel=local_spp, max_bounces=cfg.max_bounces,
            seed_mode=cfg.seed_mode, invisible_budget=cfg.invisible_budget,
            bruteforce_threshold=cfg.bruteforce_threshold,
            subpixel_jitter=cfg.subpixel_jitter,
            engine=cfg.engine,
            dense_engine=cfg.dense_engine,
        )
        if n_sample > 1:
            # Mean of per-shard means over equal shares == global mean.
            block = lax.psum(block, SAMPLE_AXIS) / jnp.float32(n_sample)
        return block

    return jax.shard_map(
        worker,
        mesh=mesh,
        in_specs=(P(), P(), P()),  # scene, camera, frame replicated
        out_specs=P(TILE_AXIS, None, None),
        # Replication checking off: the megakernel's while_loop carry
        # starts from replicated constants that become device-varying
        # inside the loop, which the checker would demand pcasts for.
        check_vma=False,
    )(scene, camera, jnp.int32(frame_index))


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "mesh", "n_tile", "n_sample", "block_px", "blocks_per_dev",
        "batch", "replicate_out",
    ),
)
def _render_sharded_flat_impl(
    scene: Scene,
    camera: Camera,
    frame_index,
    *,
    cfg: RenderConfig,
    mesh: Mesh,
    n_tile: int,
    n_sample: int,
    block_px: int,
    blocks_per_dev: int,
    batch: int,
    replicate_out: bool = False,
):
    """Sharded render through the megakernel FLAT fast path — the same
    quota machinery bench.py times, per shard. The frame is decomposed
    into n_tile * blocks_per_dev flat row-major pixel blocks assigned
    ROUND-ROBIN: device ti owns blocks
    {ti, ti + n_tile, ti + 2*n_tile, ...}. blocks_per_dev > 1
    over-decomposes the tile axis so non-uniform block cost (a
    glass-heavy region) spreads across chips instead of straggling one —
    the SPMD answer to the reference's dynamic tile queue
    (src/image.hpp:289-333). Host-staged compaction is the one perf
    feature unavailable here (it needs host round-trips mid-render;
    shard_map bodies are single traced programs).

    Returns (blocks (n_tile * blocks_per_dev, block_px, 3) with shard ti
    holding rows [ti*k, (ti+1)*k), segments scalar, replicated)."""
    local_spp = cfg.rays_per_pixel // n_sample
    statics = _mega_statics(
        cfg.replace(rays_per_pixel=local_spp), cfg.width, cfg.height
    )
    p = cfg.pixels_per_lane
    launch_px = batch * p
    n_launch = -(-block_px // launch_px)

    def worker(scene, camera, frame_index):
        ti = lax.axis_index(TILE_AXIS)
        si = lax.axis_index(SAMPLE_AXIS)
        sample0 = si * jnp.int32(local_spp)
        means = []
        segs = jnp.float32(0.0)
        for j in range(blocks_per_dev):
            base = (jnp.int32(j * n_tile) + ti) * jnp.int32(block_px)
            parts = []
            for q in range(n_launch):
                coords = jnp.stack([
                    base + jnp.int32(q * launch_px),
                    jnp.asarray(frame_index, jnp.int32),
                    sample0,
                ])
                mean, s, _ = _mega_flat_full(
                    scene, camera, coords, batch=batch,
                    pixels_per_lane=p, **statics,
                )
                parts.append(mean)
                segs = segs + s
            block = parts[0] if n_launch == 1 else jnp.concatenate(parts)
            means.append(block[:block_px])
        out = jnp.stack(means)  # (blocks_per_dev, block_px, 3)
        if n_sample > 1:
            # Mean of per-shard means over equal shares == global mean.
            out = lax.psum(out, SAMPLE_AXIS) / jnp.float32(n_sample)
        segs = lax.psum(segs, (TILE_AXIS, SAMPLE_AXIS))
        if replicate_out:
            # Multi-process meshes: every host must end up holding the
            # whole frame (np.asarray of a partially-addressable global
            # array is an error), so the disjoint shards ride one
            # all_gather over the tile axis — the collective analog of the
            # reference's host-merged tile buffer (image.hpp:255-277).
            out = lax.all_gather(out, TILE_AXIS, axis=0, tiled=True)
        return out, segs

    return jax.shard_map(
        worker,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(
            (P() if replicate_out else P(TILE_AXIS, None, None)), P()),
        check_vma=False,  # as in _render_sharded_impl
    )(scene, camera, jnp.int32(frame_index))


def render_frame_sharded(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame_index: int = 0,
    mesh: Optional[Mesh] = None,
    overdecompose: int = 1,
    stats: Optional[dict] = None,
    replicate_out: Optional[bool] = None,
) -> np.ndarray:
    """Full-frame mean radiance (H, W, 3) float32 over the device mesh.

    With the mega engine the frame runs through the flat fast path per
    shard (quota machinery — the same code path bench.py times);
    seeds are pure functions of absolute pixel index, so the result is
    bitwise-identical to the single-chip render for ANY decomposition.

    ``overdecompose=k`` gives each tile-axis device k round-robin pixel
    blocks instead of one contiguous block (load balance for non-uniform
    scenes). ``stats`` (dict) receives {"segments": N} on the flat path.
    """
    mesh = mesh or make_mesh()
    n_tile = mesh.shape[TILE_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    if n_sample > 1 and cfg.seed_mode != "decorrelated":
        raise ValueError(
            "sample-axis sharding needs seed_mode='decorrelated': the "
            "reference seed mode is a single sequential RNG stream per "
            "pixel (Trace.cl:639-642) and cannot be split across chips"
        )
    if cfg.rays_per_pixel % n_sample != 0:
        raise ValueError(
            f"rays_per_pixel={cfg.rays_per_pixel} not divisible by "
            f"sample axis size {n_sample}"
        )
    if overdecompose < 1:
        raise ValueError("overdecompose must be >= 1")

    if cfg.engine == "mega" and cfg.rays_per_batch > 0 and cfg.max_bounces > 0:
        k = int(overdecompose)
        total = cfg.width * cfg.height
        nblocks = n_tile * k
        block_px = -(-total // nblocks)
        p = cfg.pixels_per_lane
        batch = min(cfg.rays_per_batch, -(-block_px // (256 * p)) * 256)
        blocks, segs = _render_sharded_flat_impl(
            scene, camera, frame_index,
            cfg=cfg, mesh=mesh, n_tile=n_tile, n_sample=n_sample,
            block_px=block_px, blocks_per_dev=k, batch=batch,
            # Default: replicate (all_gather) only when shards live in
            # different processes. Overridable so single-process dryruns
            # can force the all_gather lowering through the compiler
            # (the multi-host merge semantics, image.hpp:255-277).
            replicate_out=(
                jax.process_count() > 1
                if replicate_out is None else bool(replicate_out)
            ),
        )
        if stats is not None:
            stats["segments"] = float(np.asarray(segs))
        # Shard ti holds rows [ti*k, (ti+1)*k); row ti*k + j is frame
        # block j*n_tile + ti — reorder to frame-block order (j, ti).
        arr = np.asarray(blocks).reshape(n_tile, k, block_px, 3)
        flat = arr.transpose(1, 0, 2, 3).reshape(nblocks * block_px, 3)
        return flat[:total].reshape(cfg.height, cfg.width, 3)

    if overdecompose != 1:
        raise ValueError(
            "overdecompose > 1 requires the mega engine's flat path"
        )
    rows_pad = _padded_rows(cfg.height, n_tile)
    out = _render_sharded_impl(
        scene, camera, frame_index,
        cfg=cfg, mesh=mesh, n_tile=n_tile, n_sample=n_sample,
        rows_per_dev=rows_pad // n_tile,
    )
    return np.asarray(out)[: cfg.height]
