"""Frame renderer: camera rays, the sample loop, tile orchestration.

The reference's raytrace kernel (src/Trace.cl:623-653) is per pixel:
one camera ray, seed = MakeSeed(pixelIndex, frameIndex, 0), then
``incomingRaysPerPixel`` sequential Trace() calls sharing the RNG
stream. ``render_tile`` is its jit-compiled counterpart over a whole
pixel tile; ``render_frame`` is the host loop that replaces the
work-queue scheduler (src/image.hpp:280-381) — on one device tiles run
sequentially under the same jit; multi-chip decomposition lives in
tpurt.parallel.

Seeds are pure functions of absolute pixel coordinates and frame index,
so ANY tile decomposition renders bitwise identically — unlike the
reference, whose per-tile/per-device seed arithmetic makes multi-GPU
output differ from single-GPU (image.hpp:228,304).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from tpurt.config import RenderConfig
from tpurt.core import rng as rnglib
from tpurt.core.camera import Camera, make_ray, pixel_uv
from tpurt.render.integrator import trace_paths
from tpurt.render.intersect import intersect_scene
from tpurt.render.tonemap import tonemap
from tpurt.scene.types import Scene

#: Errors worth retrying a tile/batch for: device- or transport-level
#: failures (a lost device, a dropped connection). Deterministic
#: bugs (shape/type/tracing errors) propagate immediately instead of
#: being re-executed ``retries`` times (the reference exits fatally on
#: ANY device error, image.hpp:33-36; we retry only what idempotent
#: re-execution can actually fix).
_TRANSIENT_ERRORS = (jax.errors.JaxRuntimeError, OSError)


def _tile_pixel_coords(tile_h: int, tile_w: int, x0, y0):
    """Absolute pixel coords of a tile, flattened row-major."""
    ys = jnp.arange(tile_h, dtype=jnp.int32)[:, None] + jnp.int32(y0)
    xs = jnp.arange(tile_w, dtype=jnp.int32)[None, :] + jnp.int32(x0)
    ys = jnp.broadcast_to(ys, (tile_h, tile_w)).reshape(-1)
    xs = jnp.broadcast_to(xs, (tile_h, tile_w)).reshape(-1)
    return xs, ys


@functools.partial(
    jax.jit,
    static_argnames=(
        "tile_h", "tile_w", "width", "height", "rays_per_pixel", "max_bounces",
        "seed_mode", "invisible_budget", "bruteforce_threshold", "subpixel_jitter",
        "engine", "dense_engine",
    ),
    # The mega engine leaves many Scene fields unused; without this the
    # executable's parameter pruning has been observed to disagree with
    # the dispatch fast path when a cache entry is shared across scenes
    # ("Execution supplied 22 buffers but compiled program expected 24").
    keep_unused=True,
)
def _render_tile_impl(
    scene: Scene,
    camera: Camera,
    coords,  # (4,) i32: x0, y0, frame_index, sample_offset — packed into
    #          one buffer (multiple 0-d scalar args of equal value can
    #          alias the same cached constant object, and the XLA client
    #          dedupes same-object parameters, making the compiled
    #          program's buffer count depend on runtime VALUES)
    *,
    tile_h: int,
    tile_w: int,
    width: int,
    height: int,
    rays_per_pixel: int,
    max_bounces: int,
    seed_mode: str,
    invisible_budget: int,
    bruteforce_threshold: int,
    subpixel_jitter: bool,
    engine: str = "mega",
    dense_engine: str = "exact",
) -> jnp.ndarray:
    x0, y0 = coords[0], coords[1]
    frame_index, sample_offset = coords[2], coords[3]
    xs, ys = _tile_pixel_coords(tile_h, tile_w, x0, y0)
    pixel_index = ys.astype(jnp.uint32) * jnp.uint32(width) + xs.astype(jnp.uint32)

    if engine == "mega":
        from tpurt.render.megakernel import run_megakernel

        uv = pixel_uv(xs, ys, width, height)
        ro0, rd0 = make_ray(camera, uv)
        mean, segs, _iters = run_megakernel(
            scene, ro0, rd0, pixel_index, frame_index,
            rays_per_pixel=rays_per_pixel, max_bounces=max_bounces,
            seed_mode=seed_mode, invisible_budget=invisible_budget,
            sample_offset=sample_offset, subpixel_jitter=subpixel_jitter,
            camera=camera, width=width, height=height,
        )
        return mean.reshape(tile_h, tile_w, 3), segs

    def camera_rays(sample_idx):
        uv = pixel_uv(xs, ys, width, height)
        if subpixel_jitter:
            # Anti-aliasing jitter from an auxiliary stream (a capability
            # the reference lacks — it reuses one ray for all samples,
            # Trace.cl:636-641). Uses its own seed so the main stream is
            # untouched.
            jseed = rnglib.make_seed(
                pixel_index ^ jnp.uint32(0xA511E9B3), frame_index, sample_idx
            )
            jseed, jx = rnglib.random_value(jseed)
            jseed, jy = rnglib.random_value(jseed)
            uv = uv + jnp.stack(
                [(jx - 0.5) / width, (jy - 0.5) / height], axis=-1
            )
        return make_ray(camera, uv)

    acc0 = jnp.zeros((tile_h * tile_w, 3), jnp.float32)
    seg0 = jnp.float32(0.0)

    if seed_mode == "reference":
        # One ray + one continuous stream shared by all samples
        # (Trace.cl:632-642). The shared camera ray means the bounce-0
        # intersection is identical across samples: compute it once and
        # share it through the whole spp loop (bit-identical; the first
        # intersection consumes no RNG).
        ro, rd = camera_rays(jnp.uint32(0))
        state0 = rnglib.make_seed(pixel_index, frame_index, 0)
        hit0 = intersect_scene(scene, ro, rd, bruteforce_threshold, dense_engine)

        def body(_, carry):
            acc, state, seg = carry
            light, state, segments = trace_paths(
                scene, ro, rd, state, max_bounces,
                invisible_budget, bruteforce_threshold, first_hit=hit0,
                dense_engine=dense_engine,
            )
            return acc + light, state, seg + jnp.sum(segments.astype(jnp.float32))

        acc, _, seg = lax.fori_loop(0, rays_per_pixel, body, (acc0, state0, seg0))
    else:
        # Decorrelated per-sample streams: MakeSeed(pixel, frame, sample).
        # sample_offset lets a device mesh shard the sample axis: shard k
        # renders samples [k*local_spp, (k+1)*local_spp) of the SAME
        # estimator, so the psum of shard sums equals the single-chip sum
        # up to f32 reassociation. Without sub-pixel jitter the camera
        # ray is still shared, so the primary hit is cached here too.
        hit0 = (
            None
            if subpixel_jitter
            else intersect_scene(
                scene, *camera_rays(jnp.uint32(0)), bruteforce_threshold,
                dense_engine,
            )
        )

        def body(s, carry):
            acc, seg = carry
            sample_id = (s + sample_offset).astype(jnp.uint32)
            ro, rd = camera_rays(sample_id)
            state = rnglib.make_seed(pixel_index, frame_index, sample_id)
            light, _, segments = trace_paths(
                scene, ro, rd, state, max_bounces,
                invisible_budget, bruteforce_threshold, first_hit=hit0,
                dense_engine=dense_engine,
            )
            return acc + light, seg + jnp.sum(segments.astype(jnp.float32))

        acc, seg = lax.fori_loop(0, rays_per_pixel, body, (acc0, seg0))

    mean = acc / jnp.float32(rays_per_pixel)
    # Total path segments traced in this tile — the "rays" of the
    # Mrays/s metric (rays = W*H*spp*avg_path_length, SURVEY.md §5).
    return mean.reshape(tile_h, tile_w, 3), seg


_MEGA_STAGE_ITERS = 384  # iterations per capped stage before a host check


def _mega_statics(cfg: RenderConfig, width: int, height: int) -> dict:
    return dict(
        width=width, height=height,
        rays_per_pixel=cfg.rays_per_pixel, max_bounces=cfg.max_bounces,
        seed_mode=cfg.seed_mode, invisible_budget=cfg.invisible_budget,
        subpixel_jitter=cfg.subpixel_jitter,
        interleave=cfg.mega_interleave, tail_passes=cfg.mega_tail_passes,
        schedule=cfg.mega_schedule, dense=cfg.mega_dense,
    )


@functools.partial(jax.jit, static_argnames=(
    "tile_h", "tile_w", "width", "height", "rays_per_pixel", "max_bounces",
    "seed_mode", "invisible_budget", "subpixel_jitter",
    "interleave", "tail_passes", "schedule", "dense",
), keep_unused=True)
def _mega_stage_start(scene, camera, coords, *, tile_h, tile_w, **statics):
    from tpurt.render.megakernel import run_megakernel

    x0, y0 = coords[0], coords[1]
    frame_index, sample_offset = coords[2], coords[3]
    xs, ys = _tile_pixel_coords(tile_h, tile_w, x0, y0)
    width = statics["width"]
    pixel_index = ys.astype(jnp.uint32) * jnp.uint32(width) + xs.astype(jnp.uint32)
    uv = pixel_uv(xs, ys, width, statics["height"])
    ro0, rd0 = make_ray(camera, uv)
    state = run_megakernel(
        scene, ro0, rd0, pixel_index, frame_index,
        sample_offset=sample_offset, camera=camera,
        max_iterations=coords[4], return_state=True, **statics,
    )
    return state, jnp.sum(~state.done)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "rays_per_pixel", "max_bounces",
    "seed_mode", "invisible_budget", "subpixel_jitter", "uncapped",
    "pixels_per_lane", "pixel_stride", "interleave", "tail_passes", "schedule", "dense",
), keep_unused=True)
def _mega_stage_more(scene, camera, state, frame_and_offset, *, uncapped=False,
                     pixels_per_lane=1, pixel_stride=None, pixel_list=None,
                     **statics):
    from tpurt.render.megakernel import run_megakernel

    pix0 = state.pix
    if pixels_per_lane > 1:
        # Slot-0 pixel of each (possibly compacted/permuted) lane, so
        # the slot ray table rebuilds for the right quota pixels.
        if pixel_list is not None:
            pix0 = pixel_list[jnp.clip(
                state.lane0, 0, pixel_list.shape[0] - 1
            )]
        else:
            pix0 = (
                state.pix.astype(jnp.int32)
                - state.pixno * jnp.int32(pixel_stride)
            ).astype(jnp.uint32)
    out = run_megakernel(
        scene, state.ro0, state.rd0, pix0, frame_and_offset[0],
        sample_offset=frame_and_offset[1],
        camera=camera, initial_state=state,
        max_iterations=None if uncapped else frame_and_offset[2],
        return_state=True, pixels_per_lane=pixels_per_lane,
        pixel_stride=pixel_stride, pixel_list=pixel_list, **statics,
    )
    return out, jnp.sum(~out.done)


@functools.partial(jax.jit, static_argnames=("quarter",))
def _mega_compact(state, *, quarter: int):
    # Stable-sort active lanes to the front, take a quarter-size batch.
    order = jnp.argsort(state.done, stable=True)
    idx = order[:quarter]
    r = state.done.shape[0]
    small = jax.tree_util.tree_map(
        lambda a: a[idx] if getattr(a, "ndim", 0) >= 1 and a.shape[0] == r else a,
        state,
    )
    return small, idx


@jax.jit
def _mega_fold(big, small, idx):
    """Scatter a compacted batch's result-bearing leaves (radiance
    accumulators + segment counts) back into the wider state it was
    carved from at rows ``idx``; the other leaves of ``big`` are stale
    but never read again."""
    upd = lambda full, part: full.at[idx].set(part)
    return big._replace(
        acc=jax.tree_util.tree_map(upd, big.acc, small.acc),
        accs=jax.tree_util.tree_map(upd, big.accs, small.accs),
        segments=upd(big.segments, small.segments),
    )


@jax.jit
def _mega_finalize(state, spp):
    from tpurt.core import v3 as v3lib

    if len(state.accs):  # quota mode: banked per-slot accumulators
        mean = jnp.concatenate(
            [v3lib.to_rows(a) for a in state.accs]
        ) / spp.astype(jnp.float32)
    else:
        mean = v3lib.to_rows(state.acc) / spp.astype(jnp.float32)
    return mean, jnp.sum(state.segments.astype(jnp.float32))


#: Widest tail batch the respread scheduler will launch (and the
#: alive-lane bound under which it activates: active*P must fit).
_TAIL_RESPREAD_MAX = 65536


@functools.partial(jax.jit, static_argnames=(
    "p_count", "stride", "wh", "max_lanes",
))
def _collect_tail_pixels(state, start, *, p_count, stride, wh, max_lanes,
                         pixel_list=None):
    """Every incomplete pixel of a quota batch, packed valid-first.

    A lane owns quota pixels ``pix + (j - pixno)*stride`` for slots
    ``j = 0..p_count-1`` (megakernel quota advance) — or, in LIST mode,
    ``pixel_list[lane0 + j*stride]``; slots ``>= pixno`` of an alive
    lane are incomplete — the current in-flight pixel plus any
    unstarted ones. Caller guarantees ``active <= max_lanes`` so the
    lane sort cannot drop an alive lane. Returns (pixel ids u32 — pad
    entries hold wh-1 —, POSITIONS i32 of each entry in the batch's
    radiance rows — pad entries hold -1 —, and the valid count)."""
    order = jnp.argsort(state.done, stable=True)[:max_lanes]
    alive = ~state.done[order]
    pixno = state.pixno[order][:, None]
    js = jnp.arange(p_count, dtype=jnp.int32)[None, :]
    if pixel_list is not None:
        l0 = state.lane0[order][:, None]
        posc = l0 + js * np.int32(stride)
        n_list = pixel_list.shape[0]
        cand = pixel_list[
            jnp.minimum(posc, np.int32(n_list - 1))
        ].astype(jnp.int32)
    else:
        base = state.pix.astype(jnp.int32)[order][:, None]
        # Same frame-end clamp as the in-kernel quota advance (adv_pix).
        cand = jnp.minimum(base + (js - pixno) * np.int32(stride),
                           np.int32(wh - 1))
        posc = cand - start
    valid = alive[:, None] & (js >= pixno)
    flat_c = cand.reshape(-1)
    flat_p = posc.reshape(-1)
    flat_v = valid.reshape(-1)
    pack = jnp.argsort(~flat_v, stable=True)
    pix = jnp.where(flat_v[pack], flat_c[pack], np.int32(wh - 1))
    pos = jnp.where(flat_v[pack], flat_p[pack], np.int32(-1))
    return (pix.astype(jnp.uint32), pos.astype(jnp.int32),
            jnp.sum(flat_v.astype(jnp.int32)))


@functools.partial(jax.jit, static_argnames=(
    "tail_w", "width", "height", "rays_per_pixel", "max_bounces",
    "seed_mode", "invisible_budget", "subpixel_jitter",
    "interleave", "tail_passes", "schedule", "dense",
), keep_unused=True)
def _mega_tail_full(scene, camera, pixpack, coords, *, tail_w, **statics):
    """Respread tail: trace ``pixpack[:tail_w]`` as a fresh dense P=1
    batch to completion. A pixel's trace is a pure function of its
    absolute index (seeds, camera ray), so re-tracing an in-flight
    pixel from sample 0 reproduces the quota batch's radiance for it
    exactly (same per-lane op sequence; only XLA fusion context
    differs — the 1-ulp class shared by every staged executable)."""
    from tpurt.render.megakernel import run_megakernel

    width, height = statics["width"], statics["height"]
    pix = pixpack[:tail_w]
    xs = (pix % jnp.uint32(width)).astype(jnp.int32)
    ys = (pix // jnp.uint32(width)).astype(jnp.int32)
    uv = pixel_uv(xs, ys, width, height)
    ro0, rd0 = make_ray(camera, uv)
    mean, segs, _iters = run_megakernel(
        scene, ro0, rd0, pix, coords[0], sample_offset=coords[1],
        camera=camera, **statics,
    )
    return mean, segs


@jax.jit
def _tail_overwrite(mean, tail_mean, pospack, n_valid):
    """Scatter the respread tail's radiance over the batch mean at the
    collected slots' POSITIONS (_collect_tail_pixels pospack). Pad
    entries (-1) and out-of-batch clamps drop; duplicate frame-end
    clamp pixels write identical values (pixel-pure traces)."""
    limit = mean.shape[0]
    tw = tail_mean.shape[0]
    idx = pospack[:tw]
    j = jnp.arange(tw)
    ok = (j < n_valid) & (idx >= 0) & (idx < limit)
    idx = jnp.where(ok, idx, limit)
    return mean.at[idx].set(tail_mean, mode="drop")


#: Cascade respread (quota batches): fire the respread while up to this
#: many incomplete PIXELS remain (collect capacity = this / P lanes) and
#: re-trace them as a fresh full-occupancy QUOTA batch over the packed
#: pixel list — recursively, each level's stragglers respreading again —
#: instead of waiting for the deep tail to fit one P=1 batch. Cuts the
#: top batch's decaying-occupancy phase short (the last stretch of a
#: 384-iteration stage0 runs at low occupancy).
_CASCADE_MAX = 524288
#: First-stage cap when the cascade is enabled: the stage0 boundary
#: must land while the retirement curve is still mid-decay for the
#: cascade to have anything to redistribute.
_CASCADE_STAGE0 = 288
#: Lane width of a cascade level.
_CASCADE_W = 65536
#: Recursion bound: below this many incomplete pixels — or past depth
#: 2 — the tail runs as the plain P=1 respread batch.
_CASCADE_MIN = 49152
#: Follow-up stage cap while waiting for the cascade to activate: if
#: stage0's boundary lands BEFORE the retirement curve crosses the
#: activation bound (a slower-decaying scene), full 384-iteration
#: stages overshoot the crossing (the next check is 384 iterations
#: away). Short probe stages find the crossing within ~this many
#: iterations instead; scenes that activate at the first boundary
#: never run one.
_CASCADE_PROBE = 96


@functools.partial(jax.jit, static_argnames=(
    "w", "p", "width", "height", "rays_per_pixel", "max_bounces",
    "seed_mode", "invisible_budget", "subpixel_jitter",
    "interleave", "tail_passes", "schedule", "dense",
), keep_unused=True)
def _mega_pix_start(scene, camera, pixpack, coords, *, w, p, **statics):
    """Start a staged LIST-quota batch over ``pixpack`` (w lanes x p
    slots; lane i owns pixpack[i + k*w]): the cascade level's analog of
    _mega_flat_start."""
    from tpurt.render.megakernel import run_megakernel

    width, height = statics["width"], statics["height"]
    pix = pixpack[:w]
    xs = (pix % jnp.uint32(width)).astype(jnp.int32)
    ys = (pix // jnp.uint32(width)).astype(jnp.int32)
    uv = pixel_uv(xs, ys, width, height)
    ro0, rd0 = make_ray(camera, uv)
    state = run_megakernel(
        scene, ro0, rd0, pix, coords[0], sample_offset=coords[1],
        camera=camera, max_iterations=coords[2], return_state=True,
        pixels_per_lane=p, pixel_stride=w, pixel_list=pixpack, **statics,
    )
    return state, jnp.sum(~state.done)


def _render_pixlist_staged(scene, camera, cfg, pixpack, w, p, frame_index,
                           sample_offset, depth, stage_stats=None):
    """One cascade level: trace pixpack[:w*p] as a staged quota batch
    (its own compaction ladder + respread recursion). Returns
    (mean (w*p, 3) radiance rows positionally matching pixpack, segs)."""
    statics = _mega_statics(cfg, cfg.width, cfg.height)
    need = w * p
    npix = pixpack.shape[0]
    if npix < need:
        pixpack = jnp.concatenate([
            pixpack,
            jnp.full((need - npix,), np.uint32(cfg.width * cfg.height - 1),
                     jnp.uint32),
        ])
    elif npix > need:
        pixpack = pixpack[:need]  # drops only pad entries (need >= n_valid)
    cap0 = _MEGA_STAGE_ITERS
    coords = jnp.asarray([frame_index, sample_offset, cap0], jnp.int32)
    state, active = _mega_pix_start(
        scene, camera, pixpack, coords, w=w, p=p, **statics
    )
    return _mega_finish_staged(
        scene, camera, cfg, state, active, frame_index, sample_offset, w,
        pixels_per_lane=p, stage_stats=stage_stats, pixel_list=pixpack,
        depth=depth,
    )


#: Last observed retirement curve per (scene, shape) — a list of
#: (cumulative iterations, active lanes) host checkpoints. The next
#: batch with the same key predicts its stage caps from it, so host
#: checks land right where compaction becomes possible instead of on a
#: fixed 384-iteration grid (caps are traced operands — no recompiles).
_RETIRE_CURVES: dict = {}

#: Executed-schedule cache per (scene, shape) key: the decision trace
#: (stages run, compaction widths, respread tail width) of the last
#: blocking run of _mega_finish_staged. A later frame with the same key
#: REPLAYS the trace speculatively: every stage/compact/collect/tail is
#: dispatched WITHOUT blocking host reads, guard scalars are gathered,
#: and the one guard readback overlaps the queued device work. A
#: blocking int(active) leaves the device idle for a host round trip
#: (3-4 of them per staged batch), and removing them also lets
#: multi-batch frames pipeline back-to-back on the device. Guard
#: failure (the retirement curve shifted across frames) falls back to
#: the blocking path from the ORIGINAL entry state — bitwise-correct,
#: one speculative pass wasted.
_SCHED_TRACES: dict = {}

#: Observability for the speculative scheduler (tests + profiling):
#: how many staged batches replayed a cached trace vs fell back.
_SPEC_STATS = {"replayed": 0, "fallback": 0}


def _curve_key(scene, cfg: RenderConfig, r: int, p: int):
    return (
        id(scene.mega_rows), r, p, cfg.rays_per_pixel, cfg.max_bounces,
        cfg.width, cfg.height, cfg.seed_mode,
    )


#: Override for the compaction-width ladder (a list of absolute widths,
#: widest first). Read at schedule time by the un-jitted staged
#: driver, so sweeps need no cache clearing; None = the default ladder
#: below.
_STAGE_WIDTHS_OVERRIDE = None


def _stage_widths(r: int):
    if _STAGE_WIDTHS_OVERRIDE is not None:
        return [w for w in _STAGE_WIDTHS_OVERRIDE if w < r] or [r // 4]
    # Quarter-step width ladder (r/4, r/16, ... >= 1024): each level
    # is one fixed executable width, so it compiles once per level and
    # the deep tail runs at ~its own width instead of a single
    # quarter-width plateau (the straggler tail is the dominant cost).
    # Floor of 65536: the FIXED per-iteration cost makes narrower
    # widths slower per unit of work than the idle lanes they shed,
    # and every extra level adds host round-trips + compile shapes.
    widths = []
    w = r // 4
    while w >= 65536:
        widths.append(w)
        w //= 4
    if not widths:
        widths = [max(r // 4, 1024)]
    return widths


def _stage_cap(prev_curve, iters_now: int, target_active: int) -> int:
    """Iterations to run before the next host check.

    Caps are TRACED operands (no recompile per value), so any schedule
    is cheap to express. Predictive scheduling — capping each stage at
    the previous batch's active-count crossing so compaction fires as
    early as possible — is the alternative; the fixed grid retires
    straggler work at full-batch efficiency before compacting. The
    curve cache remains for schedules that can use it (e.g. choosing
    the uncapped-tail entry width offline)."""
    return _MEGA_STAGE_ITERS


def _assemble_staged(scene, camera, cfg: RenderConfig, state, folds, tail,
                     frame_index, sample_offset, statics,
                     stage_stats=None):
    """Shared epilogue of the staged drivers: unfold compactions, build
    the mean, trace + scatter the respread tail (if any). ``tail`` is
    ("plain", pixpack, pospack, n_valid, tail_w) — one P=1 dense batch —
    or ("cascade", pixpack, pospack, n_valid, w, p, depth) — a
    recursive staged quota level over the packed pixel list."""
    import time as _time

    for big, idx in reversed(folds):
        state = _mega_fold(big, state, idx)
    mean, segs = _mega_finalize(state, jnp.int32(cfg.rays_per_pixel))
    if tail is not None:
        t0 = _time.perf_counter()
        if tail[0] == "cascade":
            _, pixpack, pospack, n_valid_dev, w, p, depth = tail
            tmean, tsegs = _render_pixlist_staged(
                scene, camera, cfg, pixpack, w, p, frame_index,
                sample_offset, depth + 1, stage_stats=stage_stats,
            )
            label = dict(cascade_done=w * p)
        else:
            _, pixpack, pospack, n_valid_dev, tail_w = tail
            fo = jnp.asarray([frame_index, sample_offset], jnp.int32)
            # interleave=1: sub-batch overlap doesn't pay at tail widths
            # and halves the shape count this path compiles.
            tmean, tsegs = _mega_tail_full(
                scene, camera, pixpack, fo, tail_w=tail_w,
                **{**statics, "interleave": 1},
            )
            label = dict(respread_done=tail_w)
        mean = _tail_overwrite(mean, tmean, pospack, n_valid_dev)
        segs = segs + tsegs
        if stage_stats is not None:
            mean.block_until_ready()
            stage_stats.append(dict(wall_s=_time.perf_counter() - t0,
                                    **label))
    return mean, segs


def _respread_lanes_for(cfg: RenderConfig, p: int, r: int) -> int:
    """Alive-lane bound under which the respread/cascade activates (and
    the collect capacity). Without the cascade: survivors' remaining
    pixels must fit one _TAIL_RESPREAD_MAX batch. With it: fire while
    up to _CASCADE_MAX pixels remain, but never before the batch has
    drained to a quarter of its lanes (a cascade level would otherwise
    respread at its very first boundary and recurse on itself)."""
    if p <= 1 or not cfg.mega_tail_respread:
        return 0
    cap = _CASCADE_MAX if cfg.mega_cascade else _TAIL_RESPREAD_MAX
    return min(cap // p, max(r // 4, 1024))


def _first_cap(cfg: RenderConfig, p: int) -> int:
    """Iteration cap of a batch's FIRST stage. With the cascade the
    boundary must land mid-decay of the retirement curve (something to
    redistribute); without it, as late as possible (full-batch
    efficiency).

    The mid-decay crossing scales with per-lane work (p x spp): the
    retirement curve is a function of samples retired, so halving spp
    halves the iteration count at which occupancy collapses: work 32
    gets 96, work 64 gets 288, work 128 gets 384. Caps are traced
    operands — each value costs a schedule, not a recompile."""
    if cfg.mega_cascade and p > 1 and cfg.mega_tail_respread:
        work = p * cfg.rays_per_pixel
        # Scaling factors are expressed relative to _CASCADE_STAGE0 so
        # shrunken-test grids (conftest/monkeypatch overrides) scale
        # with their stage constants: 96/288 at work<=32, 384/288 at
        # work>=128 on the production grid.
        if work <= 32:
            cap = max(1, _CASCADE_STAGE0 // 3)
        elif work < 128:
            cap = _CASCADE_STAGE0
        else:
            cap = (_CASCADE_STAGE0 * 4) // 3
        # min() keeps shrunken-test schedules (and any user override of
        # the global grid) meaningful: the cascade cap only ever lands
        # the boundary EARLIER.
        return min(cap, _MEGA_STAGE_ITERS)
    return _MEGA_STAGE_ITERS


def _mega_replay_staged(scene, camera, cfg: RenderConfig, state, active_dev,
                        frame_index, sample_offset, r, pixels_per_lane,
                        start, plan, pixel_list=None, depth=0):
    """Speculative replay of a cached staged schedule (_SCHED_TRACES):
    dispatches every step asynchronously, then validates the gathered
    guard scalars with ONE readback that overlaps the queued device
    work. Returns (mean, segs) or None if a guard failed (the caller
    re-runs the blocking path from its saved entry state).

    Guards protect exactly the steps that can DROP work when the
    retirement curve shifted since the trace was recorded:
      * compact to width w   — requires active <= w (the stable argsort
        keeps alive lanes first; overflow would discard alive lanes);
      * respread collect     — requires active <= max_lanes for the
        same reason, and n_valid <= tail_w so no incomplete pixel is
        left untraced.
    Extra stages on an already-drained batch are harmless (the
    while_loop cond exits immediately), so stage steps need no guard.
    """
    statics = _mega_statics(cfg, cfg.width, cfg.height)
    quota = {}
    if pixels_per_lane > 1:
        quota = dict(pixels_per_lane=pixels_per_lane, pixel_stride=r)
        if pixel_list is not None:
            quota["pixel_list"] = pixel_list
    respread_lanes = _respread_lanes_for(cfg, pixels_per_lane, r)
    start_dev = jnp.int32(start)
    guards = []
    folds = []
    tail = None

    def collect():
        return _collect_tail_pixels(
            state, start_dev, p_count=pixels_per_lane, stride=r,
            wh=cfg.width * cfg.height, max_lanes=respread_lanes,
            pixel_list=pixel_list,
        )

    for step in plan:
        kind = step[0]
        if kind == "stage":
            fo = jnp.asarray([frame_index, sample_offset, step[1]], jnp.int32)
            state, active_dev = _mega_stage_more(
                scene, camera, state, fo, **quota, **statics
            )
        elif kind == "compact":
            wq = step[1]
            guards.append(active_dev <= wq)
            small, idx = _mega_compact(state, quarter=wq)
            folds.append((state, idx))
            state = small
        elif kind == "respread":
            tail_w = step[1]
            if not respread_lanes:
                return None  # config changed since the trace
            guards.append(active_dev <= respread_lanes)
            pixpack, pospack, n_valid_dev = collect()
            tail_w = min(tail_w, pixpack.shape[0])
            guards.append(n_valid_dev <= tail_w)
            tail = ("plain", pixpack, pospack, n_valid_dev, tail_w)
        elif kind == "cascade":
            w2, p2 = step[1], step[2]
            if not respread_lanes:
                return None
            guards.append(active_dev <= respread_lanes)
            pixpack, pospack, n_valid_dev = collect()
            guards.append(n_valid_dev <= w2 * p2)
            tail = ("cascade", pixpack, pospack, n_valid_dev, w2, p2, depth)
        else:  # "uncapped" — always valid
            fo = jnp.asarray([frame_index, sample_offset, 0], jnp.int32)
            state, active_dev = _mega_stage_more(
                scene, camera, state, fo, uncapped=True, **quota, **statics
            )
    if not plan or plan[-1][0] not in ("respread", "cascade", "uncapped"):
        # The recorded run finished inside its capped stages (active hit
        # 0); this frame must too, or lanes would be left untraced.
        guards.append(active_dev == 0)
    mean, segs = _assemble_staged(
        scene, camera, cfg, state, folds, tail, frame_index, sample_offset,
        statics,
    )
    # One readback validates the whole schedule; everything above is
    # already in the device queue, so the wait overlaps real work.
    if guards and not bool(np.all(np.asarray(jnp.stack(guards)))):
        return None
    return mean, segs


def _mega_finish_staged(scene, camera, cfg: RenderConfig, state, active,
                        frame_index, sample_offset, r,
                        pixels_per_lane: int = 1, stage_stats=None,
                        start: int = 0, pixel_list=None, depth: int = 0):
    """Shared tail of the host-staged compaction driver: run capped
    stages at full width while most lanes retire, then shrink to the
    surviving quarter and let the deep tail finish without taxing every
    lane. Stage caps are predicted from the previous batch's retirement
    curve (_stage_cap). Returns (mean (R*P, 3), segs).

    Respread tail (quota batches): once the alive lanes' remaining
    quota pixels fit one _TAIL_RESPREAD_MAX batch, the deep tail is not
    ground out in place — a straggler lane can hold up to P unstarted
    pixels, so the uncapped stage runs hundreds of iterations at ~3%
    occupancy (measured 554 iters for 2147/65536 lanes on the 4K
    frame). Instead every incomplete pixel is collected and re-traced
    as a fresh dense P=1 batch (pixel traces are pure functions of the
    pixel index; in-flight pixels restart from sample 0, re-tracing at
    most ~active partial pixels), and its radiance overwrites those
    slots. The work-redistribution answer to the reference's dynamic
    queue tail (image.hpp:289-333) in SPMD form.

    ``stage_stats`` (a list, optional) collects per-stage telemetry —
    dicts of {width, iters, active, wall_s, and at folds the active
    lanes' quota-progress histogram} — for the profiling harness and
    scheduling experiments; the extra device syncs it forces make it a
    measurement tool, not a production default."""
    import time as _time

    statics = _mega_statics(cfg, cfg.width, cfg.height)
    quota = {}
    if pixels_per_lane > 1:
        quota = dict(pixels_per_lane=pixels_per_lane, pixel_stride=r)
        if pixel_list is not None:
            quota["pixel_list"] = pixel_list
    widths = _stage_widths(r)
    key = _curve_key(scene, cfg, r, pixels_per_lane)
    prev = _RETIRE_CURVES.get(key)

    respread_lanes = _respread_lanes_for(cfg, pixels_per_lane, r)
    if respread_lanes and respread_lanes < widths[-1]:
        # Virtual final ladder level: keep running capped stages at the
        # last compacted width until the survivors fit a respread batch
        # (the break below fires before this level would compact).
        widths = widths + [respread_lanes]

    plan_key = (key, _MEGA_STAGE_ITERS, _TAIL_RESPREAD_MAX,
                cfg.mega_cascade, depth)
    if stage_stats is None and cfg.mega_speculative:
        plan = _SCHED_TRACES.get(plan_key)
        if plan is not None:
            out = _mega_replay_staged(
                scene, camera, cfg, state, active, frame_index,
                sample_offset, r, pixels_per_lane, start, plan,
                pixel_list=pixel_list, depth=depth,
            )
            if out is not None:
                _SPEC_STATS["replayed"] += 1
                return out
            # Guard failed: the curve shifted — fall through to the
            # blocking path from the untouched entry state (and
            # re-record the trace below).
            _SPEC_STATS["fallback"] += 1

    active = int(active)
    iters_now = 0  # stage grid index; iters itself is not fetched
    curve = [(iters_now, active)]
    plan = []  # executed schedule, recorded for speculative replay
    folds = []  # (wider_state, idx) per compaction, innermost last
    for wq in widths:
        while active > wq:
            if respread_lanes and active <= respread_lanes:
                break
            cap = (
                min(_CASCADE_PROBE, _MEGA_STAGE_ITERS)
                if cfg.mega_cascade and respread_lanes
                and pixels_per_lane > 1 and depth == 0
                else _stage_cap(prev, iters_now, wq)
            )
            fo = jnp.asarray([frame_index, sample_offset, cap], jnp.int32)
            t0 = _time.perf_counter()
            state, active = _mega_stage_more(
                scene, camera, state, fo, **quota, **statics
            )
            active = int(active)  # blocks until the stage is done
            iters_now += cap
            curve.append((iters_now, active))
            plan.append(("stage", cap))
            if stage_stats is not None:
                stage_stats.append(dict(
                    width=state.done.shape[0], iters=cap, active=active,
                    wall_s=_time.perf_counter() - t0,
                ))
        if active == 0 or (respread_lanes and active <= respread_lanes):
            break
        small, idx = _mega_compact(state, quarter=wq)
        folds.append((state, idx))
        state = small
        plan.append(("compact", wq))
        if stage_stats is not None and pixels_per_lane > 1:
            # Quota progress of the lanes that survived into the fold:
            # how many of their P pixel slots are not yet started — the
            # pool a work-stealing schedule could re-balance.
            alive = ~np.asarray(small.done)
            pixno = np.asarray(small.pixno)[alive]
            stage_stats.append(dict(
                fold_to=int(wq), active=int(alive.sum()),
                pixno_hist=np.bincount(
                    pixno, minlength=pixels_per_lane
                ).tolist(),
            ))
    tail = None  # see _assemble_staged for the two forms
    if active > 0 and respread_lanes and active <= respread_lanes:
        t0 = _time.perf_counter()
        pixpack, pospack, n_valid_dev = _collect_tail_pixels(
            state, jnp.int32(start), p_count=pixels_per_lane, stride=r,
            wh=cfg.width * cfg.height, max_lanes=respread_lanes,
            pixel_list=pixel_list,
        )
        n_valid = int(n_valid_dev)
        if cfg.mega_cascade and depth < 2 and n_valid > _CASCADE_MIN:
            # Too much work for one dense P=1 batch: re-trace as a
            # full-occupancy staged QUOTA level over the packed list.
            w2 = _CASCADE_W
            p2 = -(-n_valid // w2)
            if p2 > 8:
                # Quotas stay <= 8 — widen the level instead so w2*p2
                # always covers
                # n_valid (dropping a collected pixel would leave its
                # slot holding the parent's partial value).
                p2 = 8
                w2 = -(-(-(-n_valid // 8)) // 128) * 128
            tail = ("cascade", pixpack, pospack, n_valid_dev, w2, p2,
                    depth)
            plan.append(("cascade", w2, p2))
            if stage_stats is not None:
                stage_stats.append(dict(
                    cascade=w2 * p2, incomplete=n_valid, active=active,
                    wall_s=_time.perf_counter() - t0,
                ))
        else:
            tail_w = 2048
            while tail_w < n_valid:
                tail_w *= 2
            tail_w = min(tail_w, pixpack.shape[0])
            tail = ("plain", pixpack, pospack, n_valid_dev, tail_w)
            plan.append(("respread", tail_w))
            if stage_stats is not None:
                stage_stats.append(dict(
                    respread=tail_w, incomplete=n_valid, active=active,
                    wall_s=_time.perf_counter() - t0,
                ))
    elif active > 0:
        fo = jnp.asarray([frame_index, sample_offset, 0], jnp.int32)
        t0 = _time.perf_counter()
        state, _ = _mega_stage_more(
            scene, camera, state, fo, uncapped=True, **quota, **statics
        )
        plan.append(("uncapped",))
        if stage_stats is not None:
            state.done.block_until_ready()
            stage_stats.append(dict(
                width=state.done.shape[0], iters=int(state.iters),
                active=0, wall_s=_time.perf_counter() - t0, uncapped=True,
            ))
    _RETIRE_CURVES[key] = curve
    _SCHED_TRACES[plan_key] = plan
    return _assemble_staged(
        scene, camera, cfg, state, folds, tail, frame_index, sample_offset,
        statics, stage_stats=stage_stats,
    )


def _render_tile_mega_staged(
    scene, camera, cfg: RenderConfig, x0, y0, tile_h, tile_w, frame_index
):
    statics = _mega_statics(cfg, cfg.width, cfg.height)
    r = tile_h * tile_w
    cap0 = _stage_cap(
        _RETIRE_CURVES.get(_curve_key(scene, cfg, r, 1)), 0,
        _stage_widths(r)[0],
    )
    coords = jnp.asarray([x0, y0, frame_index, 0, cap0], jnp.int32)
    state, active = _mega_stage_start(
        scene, camera, coords, tile_h=tile_h, tile_w=tile_w, **statics
    )
    mean, segs = _mega_finish_staged(
        scene, camera, cfg, state, active, frame_index, 0, r
    )
    return mean.reshape(tile_h, tile_w, 3), segs


# --------------------------------------------------------------------------
# Flat batching: full frames as ceil(W*H / rays_per_batch) lane batches.
# Square tiles exist for the reference's scheduler semantics and for
# checkpoint/preview granularity; the megakernel itself only sees flat
# pixel lists, and bigger batches amortise the gather engine's fixed
# per-iteration cost (~110M rows/s at 65k lanes -> ~207M at 262k), so
# the fast path slices the frame row-major into rays_per_batch lanes.
# Seeds are pure functions of absolute pixel index, so the flat
# decomposition is bitwise-identical to any tile decomposition.
# --------------------------------------------------------------------------


def _flat_batch_size(cfg: RenderConfig) -> int:
    """Lanes per flat batch: the configured size, clamped so small
    frames don't pad to a huge batch (rounded up to 256 lanes). With a
    pixel quota the clamp divides by pixels_per_lane — covering the
    frame in one launch with fewer lanes beats padding every lane's
    quota with duplicate clamped pixels."""
    total = cfg.width * cfg.height
    b = min(cfg.rays_per_batch, -(-total // 256) * 256)
    if b * cfg.pixels_per_lane > 2 * total:
        # Quota would more than double-cover the frame with padding —
        # shrink to the minimal covering lane count instead.
        b = -(-total // (256 * cfg.pixels_per_lane)) * 256
    return b


def _flat_coords(coords, batch: int, width: int, height: int):
    start = coords[0]
    pix = jnp.arange(batch, dtype=jnp.int32) + start
    # Pad lanes past the frame end repeat the last pixel (their output
    # is discarded on the host; they retire with the real lanes).
    pix = jnp.minimum(pix, jnp.int32(width * height - 1))
    xs = pix % jnp.int32(width)
    ys = pix // jnp.int32(width)
    return xs, ys, pix.astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=(
    "batch", "width", "height", "rays_per_pixel", "max_bounces",
    "seed_mode", "invisible_budget", "subpixel_jitter",
    "pixels_per_lane", "interleave", "tail_passes", "schedule", "dense",
), keep_unused=True)
def _mega_flat_full(scene, camera, coords, *, batch, pixels_per_lane=1,
                    **statics):
    from tpurt.render.megakernel import run_megakernel

    width, height = statics["width"], statics["height"]
    xs, ys, pix = _flat_coords(coords, batch, width, height)
    uv = pixel_uv(xs, ys, width, height)
    ro0, rd0 = make_ray(camera, uv)
    mean, segs, iters = run_megakernel(
        scene, ro0, rd0, pix, coords[1],
        sample_offset=coords[2], camera=camera,
        pixels_per_lane=pixels_per_lane, **statics,
    )
    return mean, segs, iters


@functools.partial(jax.jit, static_argnames=(
    "batch", "width", "height", "rays_per_pixel", "max_bounces",
    "seed_mode", "invisible_budget", "subpixel_jitter",
    "pixels_per_lane", "interleave", "tail_passes", "schedule", "dense",
), keep_unused=True)
def _mega_flat_start(scene, camera, coords, *, batch, pixels_per_lane=1,
                     **statics):
    from tpurt.render.megakernel import run_megakernel

    width, height = statics["width"], statics["height"]
    xs, ys, pix = _flat_coords(coords, batch, width, height)
    uv = pixel_uv(xs, ys, width, height)
    ro0, rd0 = make_ray(camera, uv)
    state = run_megakernel(
        scene, ro0, rd0, pix, coords[1],
        sample_offset=coords[2], camera=camera,
        max_iterations=coords[3], return_state=True,
        pixels_per_lane=pixels_per_lane, **statics,
    )
    return state, jnp.sum(~state.done)


@functools.partial(jax.jit, static_argnames=(
    "batch", "width", "height", "rays_per_pixel", "max_bounces",
    "seed_mode", "invisible_budget", "subpixel_jitter",
    "pixels_per_lane", "interleave", "tail_passes", "schedule", "dense",
    "frames_per_batch",
), keep_unused=True)
def _mega_flat_multi(scene, cameras, coords, *, batch, pixels_per_lane=1,
                     frames_per_batch=1, **statics):
    from tpurt.render.megakernel import run_megakernel

    width, height = statics["width"], statics["height"]
    xs, ys, pix = _flat_coords(coords, batch, width, height)
    uv = pixel_uv(xs, ys, width, height)
    ro0, rd0 = make_ray(cameras[0], uv)
    # A 1-tuple marks an all-identical camera pack (the progressive /
    # noise-varying video shape): pass cameras=None so the megakernel's
    # shared frame-start direction table engages and the operand
    # footprint stays one frame's worth regardless of pack depth.
    mean, segs, iters = run_megakernel(
        scene, ro0, rd0, pix, coords[1],
        sample_offset=coords[2], camera=cameras[0],
        cameras=None if len(cameras) == 1 else cameras,
        pixels_per_lane=pixels_per_lane * frames_per_batch,
        frames_per_batch=frames_per_batch, **statics,
    )
    return mean, segs, iters


def cross_frame_pack_ok(cfg: RenderConfig) -> bool:
    """Single source of truth for cross-frame packing eligibility
    (bench steady blocks, anim video packs, and the assertion in
    render_batch_flat_frames all consult this): packing runs the PLAIN
    flat megakernel schedule with in-lane samples only — no per-sample
    jitter, no staged/compaction driver engaging at this batch size,
    and a live bounce loop."""
    return (
        cfg.max_bounces > 0
        and not cfg.subpixel_jitter
        and not (cfg.sample_flatten and cfg.rays_per_pixel > 1)
        and not (
            cfg.compaction_threshold
            and _flat_batch_size(cfg) >= cfg.compaction_threshold
        )
    )


def render_batch_flat_frames(
    scene: Scene,
    cameras,
    cfg: RenderConfig,
    start: int,
    frame_index: int = 0,
    sample_offset: int = 0,
):
    """Cross-frame packed flat batch: len(cameras) FRAMES of pixels
    [start, start + B*pixels_per_lane) rendered in ONE launch, frame f
    under cameras[f] with frame index frame_index+f. Returns
    ((F*P*B, 3) radiance, segs, iters) where frame f's rows are
    [f*P*B, (f+1)*P*B) — each bitwise what render_batch_flat would
    produce for that frame alone (tests/test_flat_batching.py).

    One frame's straggler tail shares iterations with the next frame's
    ramp, so per-frame cost drops toward the per-lane mean (the
    animation/progressive steady-state workload). Cameras must share a
    position (megakernel docstring); plain schedule only (the staged
    drivers don't pack)."""
    f = len(cameras)
    assert f >= 1
    if f == 1:
        m, s, it = render_batch_flat(scene, cameras[0], cfg, start,
                                     frame_index, sample_offset)
        return m, s, it
    assert cfg.max_bounces <= 0 or cross_frame_pack_ok(cfg), (
        "cross-frame packing runs the plain flat schedule only "
        "(see cross_frame_pack_ok)"
    )
    # Caller contract (NOT checked here — a device read per call would
    # bill a host round trip to every timed pack): cameras share one
    # position. bench/anim construct packed cameras rotation-only.
    b = _flat_batch_size(cfg)
    statics = _mega_statics(cfg, cfg.width, cfg.height)
    coords = jnp.asarray([start, frame_index, sample_offset], jnp.int32)
    # Static-camera packs (bench steady blocks, anim's unchanged-scene
    # packs) collapse to a 1-tuple so the megakernel's periodic
    # rd-table sharing engages (identity check only — free, and the
    # callers that pack construct `(cam,) * n`).
    cams = tuple(cameras)
    if all(c is cams[0] for c in cams[1:]):
        cams = (cams[0],)
    return _mega_flat_multi(
        scene, cams, coords, batch=b,
        pixels_per_lane=cfg.pixels_per_lane, frames_per_batch=f, **statics
    )


def render_batch_flat(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    start: int,
    frame_index: int = 0,
    sample_offset: int = 0,
    stage_stats=None,
):
    """Mean radiance of one flat lane batch: pixels
    [start, start + B*pixels_per_lane) in row-major order, padded past
    the frame end. Returns ((B*P, 3) radiance device array, segs,
    iters-or-None)."""
    b = _flat_batch_size(cfg)
    p = cfg.pixels_per_lane
    statics = _mega_statics(cfg, cfg.width, cfg.height)
    if (
        cfg.compaction_threshold
        and b >= cfg.compaction_threshold
        and cfg.max_bounces > 0
    ):
        cap0 = _first_cap(cfg, p)
        coords = jnp.asarray(
            [start, frame_index, sample_offset, cap0], jnp.int32
        )
        state, active = _mega_flat_start(
            scene, camera, coords, batch=b, pixels_per_lane=p, **statics
        )
        mean, segs = _mega_finish_staged(
            scene, camera, cfg, state, active, frame_index, sample_offset,
            b, pixels_per_lane=p, stage_stats=stage_stats, start=start,
        )
        return mean, segs, None
    coords = jnp.asarray([start, frame_index, sample_offset], jnp.int32)
    mean, segs, iters = _mega_flat_full(
        scene, camera, coords, batch=b, pixels_per_lane=p, **statics
    )
    return mean, segs, iters


def render_tile(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    x0: int = 0,
    y0: int = 0,
    tile_h: Optional[int] = None,
    tile_w: Optional[int] = None,
    frame_index: int = 0,
) -> jnp.ndarray:
    """Mean radiance of one tile, (tile_h, tile_w, 3) float32."""
    return render_tile_with_stats(
        scene, camera, cfg, x0, y0, tile_h, tile_w, frame_index
    )[0]


def render_tile_with_stats(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    x0: int = 0,
    y0: int = 0,
    tile_h: Optional[int] = None,
    tile_w: Optional[int] = None,
    frame_index: int = 0,
):
    """(radiance tile, total path segments traced) — the second value is
    the exact ray count of the Mrays/s metric."""
    tile_h = tile_h or min(cfg.tile_size, cfg.height)
    tile_w = tile_w or min(cfg.tile_size, cfg.width)
    if (
        cfg.engine == "mega"
        and cfg.compaction_threshold
        and tile_h * tile_w >= cfg.compaction_threshold
        and cfg.max_bounces > 0
    ):
        return _render_tile_mega_staged(
            scene, camera, cfg, x0, y0, tile_h, tile_w, frame_index
        )
    return _render_tile_impl(
        scene, camera,
        jnp.asarray([x0, y0, frame_index, 0], jnp.int32),
        tile_h=tile_h, tile_w=tile_w,
        width=cfg.width, height=cfg.height,
        rays_per_pixel=cfg.rays_per_pixel, max_bounces=cfg.max_bounces,
        seed_mode=cfg.seed_mode, invisible_budget=cfg.invisible_budget,
        bruteforce_threshold=cfg.bruteforce_threshold,
        subpixel_jitter=cfg.subpixel_jitter,
        engine=cfg.engine,
        dense_engine=cfg.dense_engine,
    )


def render_frame(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame_index: int = 0,
    progress=None,
    accumulator=None,
    retries: int = 1,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Full-frame mean radiance (H, W, 3) float32, single chip.

    Tiles are swept row-major like singleThreadedCompute
    (image.hpp:352-381); edge tiles are rendered at full tile shape and
    cropped (static shapes keep one compiled executable per frame).
    ``progress(done, total)`` is invoked per tile; ``accumulator`` (an
    io.checkpoint.TileAccumulator) receives finished tiles for
    resume/preview support.

    Failure recovery: tile renders are pure and idempotent, so a
    transient device error retries the tile up to ``retries`` times
    before propagating (the reference exits fatally on any device
    error, image.hpp:33-36; with an ``accumulator`` a crashed run
    additionally resumes from its finished tiles).

    Fast path: with the mega engine and no accumulator the frame is
    rendered as flat rays_per_batch lane batches (bitwise-identical to
    the tile sweep; see render_batch_flat) — tiles only exist for
    checkpoint/preview granularity.

    ``stats``: pass a dict to receive {"segments": float} — the exact
    path-segment count of the frame (the "rays" of Mrays/s; resumed
    tiles from an accumulator contribute no segments since no rays were
    traced for them this run) — plus {"iterations": int}, the summed
    megakernel loop iterations, where the flat plain schedule runs (the
    staged schedule does not report them).
    """
    if (
        accumulator is None
        and cfg.engine == "mega"
        and cfg.rays_per_batch > 0
        and cfg.max_bounces > 0
    ):
        if cfg.sample_flatten and cfg.rays_per_pixel > 1:
            return _render_frame_flat_sflat(
                scene, camera, cfg, frame_index, progress, retries,
                stats=stats,
            )
        return _render_frame_flat(
            scene, camera, cfg, frame_index, progress, retries, stats=stats
        )
    ts = cfg.tile_size
    tiles_x, tiles_y = cfg.tiles()
    out = np.zeros((cfg.height, cfg.width, 3), np.float32)
    done = 0
    total_segs = 0.0
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            if accumulator is not None and accumulator.has_tile(tx, ty):
                out_tile = accumulator.get_tile(tx, ty)
                h = min(ts, cfg.height - ty * ts)
                w = min(ts, cfg.width - tx * ts)
                out[ty * ts : ty * ts + h, tx * ts : tx * ts + w] = out_tile[:h, :w]
                done += 1
                if progress is not None:
                    progress(done, tiles_x * tiles_y)
                continue
            attempt = 0
            while True:
                try:
                    tile, segs = render_tile_with_stats(
                        scene, camera, cfg,
                        x0=tx * ts, y0=ty * ts, tile_h=ts, tile_w=ts,
                        frame_index=frame_index,
                    )
                    tile_np = np.asarray(tile)
                    total_segs += float(segs)
                    break
                except _TRANSIENT_ERRORS:
                    attempt += 1
                    if attempt > retries:
                        raise
            h = min(ts, cfg.height - ty * ts)
            w = min(ts, cfg.width - tx * ts)
            out[ty * ts : ty * ts + h, tx * ts : tx * ts + w] = tile_np[:h, :w]
            if accumulator is not None:
                accumulator.put_tile(tx, ty, tile_np)
            done += 1
            if progress is not None:
                progress(done, tiles_x * tiles_y)
    if stats is not None:
        stats["segments"] = total_segs
    return out


_tonemap_dev = jax.jit(tonemap)
_add_dev = jax.jit(lambda a, b: a + b)
_div_dev = jax.jit(lambda a, g: a / g, static_argnames=("g",))
#: Static on-device row slice (packed multi-frame outputs -> per-frame
#: buffers without a host round-trip).
_slice_dev = jax.jit(lambda a, start, size: a[start:start + size],
                     static_argnames=("start", "size"))


def _render_frame_flat_sflat(
    scene: Scene, camera: Camera, cfg: RenderConfig, frame_index, progress,
    retries: int = 1, as_u8: bool = False, stats: Optional[dict] = None,
) -> np.ndarray:
    """sample_flatten driver: rays_per_pixel one-sample passes of the
    whole frame, accumulated ON DEVICE in sample order (bitwise-equal
    to the in-lane sample loop: per-sample trajectories are pure
    functions of (pixel, frame, sample) in decorrelated mode, and f32
    adds happen in the same order). One pass's lanes carry near-uniform
    work — one path chain each — so the straggler tail is the worst
    single path, not the worst pixel's whole sample budget."""
    total = cfg.width * cfg.height
    spp = cfg.rays_per_pixel
    cfg1 = cfg.replace(rays_per_pixel=1)
    b = _flat_batch_size(cfg1) * cfg1.pixels_per_lane  # pixels per launch
    n_batches = -(-total // b)
    accs = [None] * n_batches
    total_segs = 0.0
    for g in range(spp):
        for i in range(n_batches):
            attempt = 0
            while True:
                try:
                    mean, segs, _ = render_batch_flat(
                        scene, camera, cfg1, i * b, frame_index,
                        sample_offset=g,
                    )
                    total_segs += float(segs)
                    accs[i] = mean if accs[i] is None else _add_dev(
                        accs[i], mean
                    )
                    break
                except _TRANSIENT_ERRORS:
                    attempt += 1
                    if attempt > retries:
                        raise
            if progress is not None:
                progress(g * n_batches + i + 1, spp * n_batches)
    if stats is not None:
        stats["segments"] = total_segs
    out = np.zeros((total, 3), np.uint8 if as_u8 else np.float32)
    for i in range(n_batches):
        mean = _div_dev(accs[i], float(spp))
        if as_u8:
            mean = _tonemap_dev(mean)
        mean_np = np.asarray(mean)
        start = i * b
        n = min(b, total - start)
        out[start : start + n] = mean_np[:n]
    return out.reshape(cfg.height, cfg.width, 3)


def _render_frame_flat(
    scene: Scene, camera: Camera, cfg: RenderConfig, frame_index, progress,
    retries: int = 1, as_u8: bool = False, stats: Optional[dict] = None,
) -> np.ndarray:
    total = cfg.width * cfg.height
    b = _flat_batch_size(cfg) * cfg.pixels_per_lane  # pixels per launch
    n_batches = -(-total // b)
    out = np.zeros((total, 3), np.uint8 if as_u8 else np.float32)
    total_segs = 0.0
    total_iters = 0
    for i in range(n_batches):
        start = i * b
        attempt = 0
        while True:
            try:
                mean, segs, iters = render_batch_flat(
                    scene, camera, cfg, start, frame_index
                )
                total_segs += float(segs)
                if iters is not None:
                    total_iters += int(iters)
                if as_u8:
                    # Tonemap ON DEVICE and ship uint8: the display
                    # artifact is 3 B/px against 12 B/px of f32
                    # radiance.
                    mean = _tonemap_dev(mean)
                mean_np = np.asarray(mean)
                break
            except _TRANSIENT_ERRORS:
                attempt += 1
                if attempt > retries:
                    raise
        n = min(b, total - start)
        out[start : start + n] = mean_np[:n]
        if progress is not None:
            progress(i + 1, n_batches)
    if stats is not None:
        stats["segments"] = total_segs
        if total_iters:
            stats["iterations"] = total_iters
    return out.reshape(cfg.height, cfg.width, 3)


def render_image(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    frame_index: int = 0,
    progress=None,
    accumulator=None,
) -> np.ndarray:
    """Full pipeline to display pixels (H, W, 3) uint8.

    On the flat fast path the tonemap runs on device and only uint8
    crosses the host boundary (4x less D2H than f32 radiance). Tonemap
    is elementwise
    per pixel, so device and host application are bitwise-identical.
    """
    if (
        accumulator is None
        and cfg.engine == "mega"
        and cfg.rays_per_batch > 0
        and cfg.max_bounces > 0
    ):
        if cfg.sample_flatten and cfg.rays_per_pixel > 1:
            return _render_frame_flat_sflat(
                scene, camera, cfg, frame_index, progress, as_u8=True
            )
        return _render_frame_flat(
            scene, camera, cfg, frame_index, progress, as_u8=True
        )
    radiance = render_frame(
        scene, camera, cfg, frame_index, progress=progress, accumulator=accumulator
    )
    return np.asarray(tonemap(jnp.asarray(radiance)))
