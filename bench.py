"""Benchmark harness.

Runs the BASELINE.md config ladder on the GPU and prints ONE JSON line
for the headline metric — Mrays/sec/device on the bunny-class 1080p BVH
scene — where rays = W*H*spp*avg_path_length (path segments actually
traced, counted exactly by the integrator). Every row names the device
it ran on (platform, device_kind, device count, and the card's name and
power limit from nvidia-smi). Without a GPU it exits non-zero unless
``--cpu`` asks for a CPU debug run.

The mega engine renders through the flat-batch fast path (the same path
render_frame uses); stderr carries the breakdown — loop iterations,
us/iteration, and iterations per path segment (rows gathered per
segment).

Secondary ladder results go to stderr. Usage:
    python bench.py                 # headline only (fast-ish)
    python bench.py --ladder        # all configs
    python bench.py --cpu           # debug on CPU
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_info() -> dict:
    """The card's name and power limit as nvidia-smi reports them (a
    child process that stays off JAX); None without nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return {"name": None, "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power = (f.strip() for f in out.split(",", 1))
    return {"name": name, "power_limit": power}


def device_info() -> dict:
    """What every printed row carries: the JAX device and the card."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "count": len(jax.devices()), **card_info()}


def build_scene(kind: str, cfg):
    from tpurt.scene import procedural
    from tpurt.scene.builder import Material, SceneBuilder
    from tpurt.scene.types import MaterialType
    from tpurt.core.camera import Camera

    b = SceneBuilder()
    if kind == "teapot":  # low-poly class, ~6k tris (BASELINE config 2)
        pos, nrm = procedural.torus_knot(segments=96, sides=32, radius=80.0, tube=22.0)
    elif kind == "knot":  # smooth/regular 69,120-tri A/B counterpart
        pos, nrm = procedural.torus_knot(segments=540, sides=64, radius=80.0, tube=22.0)
    elif kind == "bunny":  # irregular 69,120-tri committed scan-like
        # asset (BASELINE config 3's "Stanford bunny" class): same
        # triangle count as the knot row, but lumps/crevices give the
        # BVH the bounds irregularity a scan has
        # (scripts/make_irregular_mesh.py).
        from tpurt.scene.obj import load_obj

        pos, nrm = load_obj(os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "assets", "blob69k.obj"))
    elif kind == "sphere":
        pos, nrm = procedural.icosphere(3, radius=100.0)
    else:
        raise ValueError(kind)
    mesh = b.add_triangles(pos, nrm)
    mesh.material = Material(
        type=MaterialType.SOLID, ior=1.0, color=(1.0, 1.0, 1.0),
        specular_probability=1.0,
    )
    mesh.scale = 0.5
    b.add_cornell_box(mesh)
    b.add_mesh(mesh)
    scene = b.freeze()
    cam = Camera.create(
        position=cfg.camera_position, pitch=cfg.camera_pitch,
        yaw=cfg.camera_yaw, roll=cfg.camera_roll,
        fov_degrees=cfg.fov_degrees, aspect_ratio=cfg.aspect_ratio,
    )
    return scene, cam


def time_render_flat(scene, cam, cfg, repeats=2, max_frames=32, strict=False):
    """Steady-state multi-frame throughput of the flat megakernel path
    (the render_frame default). Dispatches a block of frames with
    DISTINCT frame_index values (distinct RNG streams — the animation /
    progressive-accumulation workload shape) back-to-back with no host
    round-trip inside the timed region; per-frame segment/iteration
    counts accumulate ON DEVICE and one 4-byte scalar D2H at the block
    end both drains the stream and prices the sync (amortised over the
    block). Compile excluded, best of `repeats` blocks. Returns a dict:
    seconds/segments/iters (per frame, steady-state), frames,
    latency_s (single frame INCLUDING its display D2H), d2h_s.

    Steady-state dispatch is how every frame after the first behaves in
    the animation/accumulation paths; the one-frame latency with its
    D2H is still measured and reported. Warmup materialises EVERY batch
    twice (batch contents differ structurally), so the timed block
    replays fully-compiled executables only."""
    from tpurt.render.renderer import (
        _add_dev, _div_dev, _flat_batch_size, _slice_dev, _tonemap_dev,
        render_batch_flat,
    )

    total = cfg.width * cfg.height
    sflat = cfg.sample_flatten and cfg.rays_per_pixel > 1
    spp = cfg.rays_per_pixel
    if sflat:
        cfg = cfg.replace(rays_per_pixel=1)
    groups = spp if sflat else 1
    b = _flat_batch_size(cfg) * cfg.pixels_per_lane  # pixels per launch
    n_batches = -(-total // b)
    # Cross-frame packing (steady blocks only; latency stays a true
    # single frame). Eligibility is the shared predicate
    # (renderer.cross_frame_pack_ok: plain schedule, in-lane samples).
    from tpurt.render.renderer import cross_frame_pack_ok

    pack = max(1, int(getattr(cfg, "mega_frames_per_batch", 1)))
    if sflat or not cross_frame_pack_ok(cfg):
        pack = 1

    def frame(f, collect=None):
        """Dispatch one frame; returns lazy (segs_dev, iters_dev)."""
        seg_d = it_d = None
        accs = [None] * n_batches
        for g in range(groups):
            for i in range(n_batches):
                m, s, it = render_batch_flat(
                    scene, cam, cfg, i * b, frame_index=f, sample_offset=g
                )
                seg_d = s if seg_d is None else _add_dev(seg_d, s)
                if it is not None:
                    it_d = it if it_d is None else _add_dev(it_d, it)
                accs[i] = m if accs[i] is None else _add_dev(accs[i], m)
        if collect is not None:
            for i in range(n_batches):
                m = _div_dev(accs[i], float(spp)) if sflat else accs[i]
                collect.append(_tonemap_dev(m))
        return seg_d, it_d

    def frame_pack(f0, n_frames, collect=None):
        """Dispatch ``n_frames`` frames (indices f0..f0+n_frames-1) as
        cross-frame packed launches (megakernel frames_per_batch): one
        frame's straggler tail shares loop iterations with the next
        frame's ramp. Pixels are bitwise-identical to frame-by-frame
        dispatch (tests/test_flat_batching.py)."""
        from tpurt.render.renderer import render_batch_flat_frames

        seg_d = it_d = None
        cams = (cam,) * n_frames
        outs = [[None] * n_batches for _ in range(n_frames)]
        for i in range(n_batches):
            m, s, it = render_batch_flat_frames(
                scene, cams, cfg, i * b, frame_index=f0
            )
            seg_d = s if seg_d is None else _add_dev(seg_d, s)
            if it is not None:
                it_d = it if it_d is None else _add_dev(it_d, it)
            for k in range(n_frames):
                outs[k][i] = _slice_dev(m, k * b, b)
        if collect is not None:
            for k in range(n_frames):
                for i in range(n_batches):
                    collect.append(_tonemap_dev(outs[k][i]))
        return seg_d, it_d

    # Warmup / compile: every batch, twice, display shipped. Also warms
    # the cross-frame accumulate ops the steady block chains with.
    for _ in range(2):
        shipped = []
        seg_d, it_d = frame(0, collect=shipped)
        seg_d = _add_dev(seg_d, seg_d)
        if it_d is not None:
            _ = int(np.asarray(_add_dev(it_d, it_d)))
        _ = float(np.asarray(seg_d))  # drain compute before timing D2H
        warm_t0 = time.perf_counter()
        for t in shipped:  # first materialisation of each buffer
            np.asarray(t)
        d2h_s = time.perf_counter() - warm_t0
        _ = int(np.asarray(shipped[0]).sum())
    if pack > 1:  # warm the packed executable set too (both passes)
        for _ in range(2):
            shipped = []
            seg_d, it_d = frame_pack(0, pack, collect=shipped)
            _ = float(np.asarray(seg_d))
            if it_d is not None:
                _ = int(np.asarray(it_d))
            for t in shipped:
                np.asarray(t)

    # Single-frame latency (dispatch -> tonemapped frame on host).
    t0 = time.perf_counter()
    shipped = []
    frame(0, collect=shipped)
    for t in shipped:
        np.asarray(t)
    latency_s = time.perf_counter() - t0

    # Steady-state block: enough frames (~3 s) to amortise the one end
    # sync into the noise, bounded so the slow ladder rows stay fast;
    # slow rows derive small counts from their latency. Every steady
    # frame DISPATCHES its on-device tonemap (the displayable uint8
    # frame is produced inside the timed region; only its D2H stays
    # out).
    frames = max(2, min(max_frames, int(3.0 / max(latency_s, 1e-3)) + 1))
    frames = -(-frames // pack) * pack  # whole packs
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        seg_d = it_d = None
        for f in range(0, frames, pack):
            display = []
            if pack > 1:
                s, it = frame_pack(f, pack, collect=display)
            else:
                s, it = frame(f, collect=display)
            seg_d = s if seg_d is None else _add_dev(seg_d, s)
            if it is not None:
                it_d = it if it_d is None else _add_dev(it_d, it)
        segs = float(np.asarray(seg_d))  # the one blocking D2H
        # Execution on the device stream is in-order: the scalar read
        # above drains every dispatched tonemap too, so their cost is
        # inside dt.
        dt = time.perf_counter() - t0
        iters = int(np.asarray(it_d)) if it_d is not None else 0
        if best is None or dt < best[0]:
            best = (dt, segs, iters)
    dt, segs, iters = best
    out = {
        "seconds": dt / frames, "segments": segs / frames,
        "iters": iters / frames, "frames": frames,
        "latency_s": latency_s, "d2h_s": d2h_s,
    }
    if strict:
        # Transparency row: time the block WITH every frame's tonemapped
        # uint8 frame materialised on the host (a production host
        # overlaps this — see anim.py's double-buffered video loop).
        best_s = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            seg_d = None
            for f in range(0, frames, pack):
                display = []
                if pack > 1:
                    s, _ = frame_pack(f, pack, collect=display)
                else:
                    s, _ = frame(f, collect=display)
                seg_d = s if seg_d is None else _add_dev(seg_d, s)
                for t in display:
                    np.asarray(t)
            float(np.asarray(seg_d))
            dt_s = time.perf_counter() - t0
            if best_s is None or dt_s < best_s:
                best_s = dt_s
        out["strict_seconds"] = best_s / frames
    return out


def time_render_tiles(scene, cam, cfg, repeats=2):
    """Tile-loop render (modular engine / accumulator-style path)."""
    from tpurt.render.renderer import render_tile_with_stats

    ts = cfg.tile_size
    tiles_x, tiles_y = cfg.tiles()

    r, s = render_tile_with_stats(scene, cam, cfg, 0, 0, ts, ts)
    _ = float(s) + float(np.asarray(r).sum())

    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        total_seg = 0.0
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                r, s = render_tile_with_stats(
                    scene, cam, cfg, tx * ts, ty * ts, ts, ts
                )
                total_seg += float(s)
                np.asarray(r)
        dt = time.perf_counter() - t0
        if best is None or dt < best[0]:
            best = (dt, total_seg, 0)
    return best


def run_config_anim(name, scene_kind, cfg, frames=4):
    """BASELINE config 5's single-chip component: an animated camera
    sweep (yaw advancing per frame, the viewer/anim.py schedule) at 4K,
    every frame through the flat fast path. One executable serves all
    frames (camera and frame_index are traced data)."""
    import math

    from tpurt.core.camera import Camera
    from tpurt.render.renderer import (
        _flat_batch_size, _tonemap_dev, render_batch_flat,
    )

    scene, _ = build_scene(scene_kind, cfg)
    cams = [
        Camera.create(
            position=cfg.camera_position, pitch=cfg.camera_pitch,
            yaw=cfg.camera_yaw + 2.0 * math.pi * f / 720.0,
            roll=cfg.camera_roll, fov_degrees=cfg.fov_degrees,
            aspect_ratio=cfg.aspect_ratio,
        )
        for f in range(frames)
    ]
    total = cfg.width * cfg.height
    b = _flat_batch_size(cfg) * cfg.pixels_per_lane
    n_batches = -(-total // b)
    log(f"[{name}] scene={scene_kind} {cfg.width}x{cfg.height} "
        f"spp={cfg.rays_per_pixel} frames={frames} batches={n_batches}")

    # Warmup/compile: all batches, twice (see time_render_flat — batch
    # contents differ structurally, so a batch0-only warmup leaks
    # compile waits into the timed frames).
    for _ in range(2):
        for i in range(n_batches):
            m, s, _ = render_batch_flat(scene, cams[0], cfg, i * b)
            _ = float(s) + int(np.asarray(_tonemap_dev(m)).sum())

    # Steady-state sweep: frames dispatch back-to-back (camera is traced
    # data — one executable serves every frame), segment counts
    # accumulate on device, one scalar D2H drains the block.
    from tpurt.render.renderer import _add_dev

    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        seg_d = None
        outs = []
        for f, cam in enumerate(cams):
            outs = []
            for i in range(n_batches):
                m, s, _ = render_batch_flat(scene, cam, cfg, i * b,
                                            frame_index=f)
                seg_d = s if seg_d is None else _add_dev(seg_d, s)
                outs.append(m)
        segs = float(np.asarray(seg_d))
        trial = time.perf_counter() - t0
        if best is None or trial < best:
            best = trial
    dt = best
    t0 = time.perf_counter()
    for m in outs:  # ship the last frame, outside the block
        np.asarray(_tonemap_dev(m))
    d2h_s = time.perf_counter() - t0
    mrays = segs / dt / 1e6
    log(f"[{name}] {frames} frames in {dt:.3f}s "
        f"({dt/frames:.3f}s/frame, frame d2h {d2h_s:.3f}s)  "
        f"=> {mrays:.1f} Mrays/s")
    return {"name": name, "seconds": dt, "mrays": mrays,
            "seconds_per_frame": dt / frames, "d2h_s": d2h_s,
            "avg_path": segs / (total * cfg.rays_per_pixel * frames)}


def run_sharding_efficiency(cfg, repeats=2, force=False, scene_kind="bunny"):
    """BASELINE config 5's multi-device component: per-device
    efficiency of the tile-sharded render vs the single-device flat
    path (target >=90%, BASELINE.md). Measured only when more than one
    GPU is visible; otherwise it reports the measurement as unavailable
    (the CPU-mesh decomposition tests in tests/test_parallel.py cover
    correctness of the sharded path).

    ``force=True`` runs the measuring branch on whatever >=2-device
    backend is up (the 8-virtual-CPU mesh in tests / --force-cpu-mesh):
    the efficiency NUMBER is meaningless there (virtual devices share
    cores), but the branch gets exercised end-to-end."""
    import jax

    devs = jax.devices()
    if len(devs) < 2 or (devs[0].platform != "gpu" and not force):
        log("[sharding-eff] fewer than two GPUs visible — efficiency not "
            "measurable here")
        return {"name": "sharding-efficiency", "devices": 1,
                "efficiency": None}
    from tpurt.parallel import make_mesh, render_frame_sharded

    scene, cam = build_scene(scene_kind, cfg)
    n = len(devs)
    r1 = time_render_flat(scene, cam, cfg, repeats)
    dt1 = r1["latency_s"]
    mesh = make_mesh(tile_devices=n, devices=devs)
    stats: dict = {}
    render_frame_sharded(scene, cam, cfg, mesh=mesh, stats=stats)  # warmup
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = render_frame_sharded(scene, cam, cfg, mesh=mesh, stats=stats)
        np.asarray(out)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    eff = (dt1 / best) / n
    log(f"[sharding-eff] single {dt1:.3f}s, {n}-chip {best:.3f}s "
        f"=> speedup {dt1/best:.2f}x, efficiency {eff*100:.1f}%")
    return {"name": "sharding-efficiency", "devices": n,
            "single_s": dt1, "sharded_s": best, "efficiency": eff}


def run_config(name, scene_kind, cfg, repeats=2, strict=False):
    scene, cam = build_scene(scene_kind, cfg)
    log(f"[{name}] scene={scene_kind} tris={scene.num_triangles} "
        f"{cfg.width}x{cfg.height} spp={cfg.rays_per_pixel} "
        f"bounces={cfg.max_bounces} engine={cfg.engine} "
        f"dense={cfg.dense_engine} bf_threshold={cfg.bruteforce_threshold}")
    extra = {}
    if cfg.engine == "mega" and cfg.rays_per_batch > 0 and cfg.max_bounces > 0:
        r = time_render_flat(scene, cam, cfg, repeats, strict=strict)
        dt, segments, iters = r["seconds"], r["segments"], r["iters"]
        extra = {k: r[k] for k in ("frames", "latency_s", "d2h_s")}
        if "strict_seconds" in r:
            extra["strict_seconds"] = r["strict_seconds"]
    else:
        dt, segments, iters = time_render_tiles(scene, cam, cfg, repeats)
    mrays = segments / dt / 1e6
    prim = cfg.width * cfg.height * cfg.rays_per_pixel
    breakdown = ""
    result = {"name": name, "seconds": dt, "mrays": mrays,
              "avg_path": segments / prim, **extra}
    if iters:
        # Uncompacted main-stage iterations only (the compacted tail
        # reports None); still the right currency for rows/segment.
        us_per_iter = dt / iters * 1e6
        result["iters"] = iters
        result["us_per_iter"] = us_per_iter
        result["iters_per_seg"] = iters * min(
            cfg.rays_per_batch, cfg.width * cfg.height) / segments
        breakdown = (f" | {iters:.0f} iters, {us_per_iter:.0f} us/iter, "
                     f"{result['iters_per_seg']:.2f} iters(rows)/seg")
    if extra:
        breakdown += (f" | steady over {extra['frames']} frames, "
                      f"1-frame latency {extra['latency_s']:.3f}s "
                      f"(d2h {extra['d2h_s']:.3f}s)")
        if "strict_seconds" in extra:
            breakdown += (f" | strict (per-frame host frame) "
                          f"{extra['strict_seconds']:.3f}s/frame")
    log(f"[{name}] {dt:.3f}s/frame  {segments/1e6:.1f}M segments "
        f"(avg path {segments/prim:.2f})  => {mrays:.1f} Mrays/s{breakdown}")
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ladder", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="debug run on the CPU (its times are not device "
                         "measurements)")
    ap.add_argument("--strict", action="store_true",
                    help="additionally time the headline with every "
                         "frame materialised on the host (D2H inside the "
                         "timed region)")
    ap.add_argument("--tile-size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--tuned", action="store_true",
                    help="apply the cached autotuner knob set for this "
                         "platform (python -m tpurt.autotune)")
    ap.add_argument("--force-cpu-mesh", action="store_true",
                    help="run the sharding-efficiency measuring branch "
                         "on an 8-virtual-CPU mesh (plumbing check; the "
                         "efficiency number is meaningless on the CPU)")
    args = ap.parse_args()

    if args.force_cpu_mesh:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
        args.cpu = True
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        log(f"no GPU (devices: {jax.devices()}); pass --cpu for a CPU "
            "debug run")
        return 1
    from tpurt.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from tpurt.config import RenderConfig

    device = device_info()
    log(f"devices: {jax.devices()} | {device}")

    # The bench knob set: lanes work through 8-pixel quotas so one
    # straggler set amortises over the whole launch; four interleaved
    # sub-batches per loop iteration; five segment-completion passes
    # per iteration; PLAIN batches (no staged compaction). The
    # bunny-1080p-bvh row keeps the staged schedule as the A/B. These
    # values were tuned for another device; ROADMAP speed item 4
    # re-derives them (python -m tpurt.autotune).
    common = dict(tile_size=args.tile_size, seed_mode="reference",
                  pixels_per_lane=8, mega_interleave=4,
                  mega_tail_passes=5, compaction_threshold=0)
    if args.tuned:
        # Platform-specific knob set from the autotuner cache.
        from tpurt import autotune

        knobs = autotune.load_tuned()
        if knobs:
            log(f"tuned knobs: {knobs}")
            # Route ALL knob application through autotune.apply so the
            # module-level tunables (bounds_fmt, leaf_tris, node_arity,
            # mat_prune — the freeze-time bank layout the tuner
            # measured) land exactly as swept; the RenderConfig fields
            # feed the shared `common` dict.
            tuned_cfg = autotune.apply(knobs, RenderConfig())
            for k in ("mega_tail_passes", "mega_interleave",
                      "pixels_per_lane"):
                if k in knobs:
                    common[k] = int(getattr(tuned_cfg, k))
        else:
            log("no autotune cache for this platform — run "
                "`python -m tpurt.autotune` first; using defaults")
    staged = dict(common, compaction_threshold=32768)

    results = []
    if args.ladder:
        # Config 1: CPU-oracle parity scene (BASELINE.json config 1:
        # 640x480, 1 spp, direct lighting — parity itself is asserted
        # in tests vs tests/oracle.py; here we time the config).
        # mega_frames_per_batch=4: 4-iteration frames are all launch
        # ramp, cross-frame packing's natural habitat.
        results.append(run_config(
            "parity-640x480-1spp", "sphere",
            RenderConfig(width=640, height=480, rays_per_pixel=1,
                         max_bounces=1, mega_frames_per_batch=4,
                         **common)))
        # Config 2: low-poly brute force, 720p (BASELINE config 2).
        # mega_dense: persistent lanes whose per-iteration "traversal"
        # is one fused Plücker sweep (render/plucker_fused.py); the
        # bit-exact "exact" sweep remains the tested parity anchor.
        results.append(run_config(
            "teapot-720p-bruteforce", "teapot",
            RenderConfig(width=1280, height=720, rays_per_pixel=args.spp,
                         max_bounces=4, mega_dense=True,
                         rays_per_batch=230400,
                         # P=4 covers the 921600-pixel frame in ONE
                         # launch (230400*4) with no padded lanes — a
                         # padded lane still pays its sweeps here.
                         **{**common, "pixels_per_lane": 4})))
        # Same scene through the megakernel (BVH) for comparison.
        results.append(run_config(
            "teapot-720p-mega", "teapot",
            RenderConfig(width=1280, height=720, rays_per_pixel=args.spp,
                         max_bounces=4, **common)))
        # Config 4: Cornell box + mesh, 4 bounces, 256 spp at 1080p
        # (BASELINE.json config 4 verbatim — stochastic accumulation
        # throughput; ~530M camera samples, ~1.2G path segments/frame).
        results.append(run_config(
            "cornell-256spp-1080p", "sphere",
            RenderConfig(width=1920, height=1080, rays_per_pixel=256,
                         max_bounces=4, **common)))
        # Config 5: 4K animated camera sweep + sharding efficiency
        # (efficiency measured when >1 GPU is visible).
        # pixels_per_lane=16 at 4K/spp4 halves the launches per
        # 8.3M-pixel frame.
        results.append(run_config_anim(
            "4k-anim-sweep", "bunny",
            RenderConfig(width=3840, height=2160, rays_per_pixel=4,
                         max_bounces=4,
                         **{**common, "pixels_per_lane": 16})))
        results.append(run_sharding_efficiency(
            RenderConfig(width=1920, height=1080, rays_per_pixel=args.spp,
                         max_bounces=4, **common),
            force=args.force_cpu_mesh))
        # A/B for the headline mesh: the SAME triangle count as a
        # smooth regular torus knot so the irregular-asset delta is
        # documented.
        results.append(run_config(
            "knot-1080p-plain", "knot",
            RenderConfig(width=1920, height=1080, rays_per_pixel=args.spp,
                         max_bounces=4, **common)))
    elif args.force_cpu_mesh:
        # Plumbing-only invocation: tiny frame, the measuring branch
        # end-to-end on the virtual mesh (same scale as the slow test
        # in tests/test_parallel.py — CPU mega compiles dominate).
        results.append(run_sharding_efficiency(
            RenderConfig(width=64, height=32, rays_per_pixel=2,
                         max_bounces=2, rays_per_batch=1024,
                         **{**common, "pixels_per_lane": 2}),
            force=True, scene_kind="sphere"))

    # Config 3 — the headline: bunny-class BVH at 1080p, reference-seed
    # in-lane sample loop. The PLAIN schedule runs first and prints a
    # provisional metric line; the staged run then prints the final
    # line, which supersedes it. mega_frames_per_batch=2: cross-frame
    # lane packing in the steady blocks (single-frame latency stays a
    # true single frame).
    metric = "Mrays/sec/device bunny-class 1080p BVH path trace"
    headline = run_config(
        "bunny-1080p-plain", "bunny",
        RenderConfig(width=1920, height=1080, rays_per_pixel=args.spp,
                     max_bounces=4, mega_frames_per_batch=2, **common),
        strict=args.strict)
    print(json.dumps({
        "metric": metric, "value": round(headline["mrays"], 2),
        "unit": "Mrays/s", "provisional": True, "device": device,
    }), flush=True)
    results.append(headline)
    staged_row = run_config(
        "bunny-1080p-bvh", "bunny",
        RenderConfig(width=1920, height=1080, rays_per_pixel=args.spp,
                     max_bounces=4, **staged))
    if staged_row["mrays"] > headline["mrays"]:
        headline = staged_row
    results.append(staged_row)

    for r in results:
        log(json.dumps({**r, "device": device}))

    print(json.dumps({
        "metric": metric, "value": round(headline["mrays"], 2),
        "unit": "Mrays/s", "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
