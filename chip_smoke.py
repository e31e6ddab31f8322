#!/usr/bin/env python3
"""On-card smoke test: tpurt's main path on one GPU, end to end.

    python chip_smoke.py               # one GPU: phases (a)-(f)
    python chip_smoke.py --four-gpus   # four GPUs: the sharded phase only

Phases, each printing one line of its own (the oracle's host renders
run on a thread during (e), so (b) is checked after (e)):

  (a) device   — the JAX device list, the card's name and power limit.
  (b) oracle   — the megakernel on the card against the scalar oracle
                 (tests/oracle.py) on the host, on two small scenes.
  (c) frame    — the 1080p blob69k headline frame through render_frame,
                 with RenderConfig's defaults and with the bench's knob
                 set; the two must agree, and a 32x32 crop rendered on
                 the CPU with the modular engine must match the card.
  (d) cli      — the same frame through tpurt.cli.main, BMP read back.
  (e) dense    — the Triton dense sweep against its jnp reference at
                 the teapot's widths, then one brute-force 720p frame.
  (f) tests    — the gpu-marked tests, run in this process.

Tolerance of every cross-implementation comparison (TOL below): the
card need not be bitwise-equal to the CPU. XLA compiles each backend
on its own, free to fuse and contract multiply-adds differently, and
the GPU's log / cos / sin / rsqrt may differ from the CPU's in the last
ulp. A ray that meets a triangle edge or a Russian-roulette threshold
exactly (a knife edge) can then take another branch, and that sample's
whole path diverges. So nearly all pixels are bitwise-equal and a small
fraction differ outright, by as much as a light source's radiance: TOL
asks for 99% of pixels within 1e-3 relative and frame means within 5%
(one divergent bright pixel moves a 48x48 frame's mean by ~1.5%). All
arithmetic is f32: no matrix product runs in TF32 on a device path.

Everything runs in this one process (one JAX client holds the card);
only nvidia-smi runs as a child (bench.card_info). The last line of standard output is a
JSON object {"ok": true, "device": {...}}; any failed phase exits
non-zero without printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

#: Cross-implementation tolerance (see the module docstring): at least
#: MIN_CLOSE of the pixels within rtol/atol on every channel, and the
#: frame means within MEAN_RTOL of each other.
TOL = dict(rtol=1e-3, atol=1e-4, min_close=0.99, mean_rtol=0.05)

HEADLINE = dict(width=1920, height=1080, rays_per_pixel=8, max_bounces=4,
                object_path=os.path.join(REPO, "assets", "blob69k.obj"))
#: bench.py's knob set for the headline rows.
BENCH_KNOBS = dict(pixels_per_lane=8, mega_interleave=4, mega_tail_passes=5,
                   compaction_threshold=0)
#: Four-GPU phase: a lane batch that a 4K frame quarter fills in one
#: launch, so one card and each of four cards run the same program.
FOUR_GPU_KNOBS = dict(pixels_per_lane=8, rays_per_batch=259328,
                      compaction_threshold=0)
#: Four-GPU frames: the tile-sharded 4K blob69k frame and the
#: sample-sharded 1080p Cornell frame.
FOUR_GPU_TILE = dict(width=3840, height=2160, rays_per_pixel=4)
FOUR_GPU_SAMPLE = dict(width=1920, height=1080, rays_per_pixel=64)
#: Lanes of the dense sweep comparison (the brute-force row's batch).
DENSE_LANES = 230400


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def compare(a, b, tol=TOL):
    """Agreement of two radiance images (numpy, same shape)."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    check(a.shape == b.shape, f"shape {a.shape} != {b.shape}")
    check(np.isfinite(a).all() and np.isfinite(b).all(), "non-finite pixels")
    close = np.isclose(a, b, rtol=tol["rtol"], atol=tol["atol"]).all(-1)
    ma, mb = a.mean(), b.mean()
    res = dict(
        bitwise=float((a == b).all(-1).mean()),
        close=float(close.mean()),
        max_abs=float(np.abs(a - b).max()),
        mean_rel=float(abs(ma - mb) / max(abs(mb), 1e-12)),
    )
    res["ok"] = bool(res["close"] >= tol["min_close"]
                     and res["mean_rel"] <= tol["mean_rtol"])
    return res


def peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def emit(phase, card, **fields):
    print(f"[{phase}] {card} " + json.dumps(fields, default=str), flush=True)


def timed_frame(render, *args, **kw):
    """(image, first-call seconds, second-call seconds, stats): the
    first call compiles; the second is the frame time. render_frame
    returns a host array, so each call ends when the frame is done."""
    st = {}
    t0 = time.perf_counter()
    render(*args, **kw, stats={})
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = render(*args, **kw, stats=st)
    second = time.perf_counter() - t0
    return img, first, second, st


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def oracle_cases():
    """(name, scene, camera, cfg) of the two oracle scenes."""
    from test_render_golden import _all_materials_scene

    from tpurt.config import RenderConfig
    from tpurt.scene.presets import cornell_sphere_scene

    scene, cam = _all_materials_scene()
    cases = [("all-materials", scene, cam, RenderConfig(
        width=12, height=12, rays_per_pixel=3, max_bounces=8, tile_size=12,
        engine="mega"))]
    cfg = RenderConfig(width=48, height=48, rays_per_pixel=2, max_bounces=5,
                       tile_size=48, object_path="sphere1.obj",
                       engine="mega")
    scene, cam, _ = cornell_sphere_scene(1, cfg)
    cases.append(("cornell-sphere1", scene, cam, cfg))
    return cases


def start_oracle(cases):
    """Render the oracle images on a host thread while the card works
    (the oracle is scalar Python; XLA compiles release the GIL)."""
    import threading

    import oracle

    out = {}

    def work():
        for name, scene, cam, cfg in cases:
            out[name] = oracle.render(scene, cam, cfg.width, cfg.height,
                                      cfg.rays_per_pixel, cfg.max_bounces)[0]

    th = threading.Thread(target=work, daemon=True)
    th.start()
    return th, out


def phase_oracle(card, dev, cases, pending):
    from tpurt.render.renderer import render_frame

    th, refs = pending
    mine = {name: render_frame(scene, cam, cfg)
            for name, scene, cam, cfg in cases}
    th.join()
    ok = True
    for name, _, _, _ in cases:
        res = compare(mine[name], refs[name])
        ok &= res["ok"]
        emit("b:oracle", card, scene=name, tol=TOL, **res)
    check(ok, "megakernel on the card disagrees with the oracle")


def phase_frame(card, dev):
    import jax
    import numpy as np

    from tpurt.config import RenderConfig
    from tpurt.render.renderer import render_frame, render_tile_with_stats
    from tpurt.scene.presets import default_scene

    cfg = RenderConfig(**HEADLINE)
    scene, cam, _ = default_scene(cfg)
    frames = {}
    for label, c in (("defaults", cfg),
                     ("bench-knobs", cfg.replace(**BENCH_KNOBS))):
        img, first, second, st = timed_frame(render_frame, scene, cam, c)
        check(np.isfinite(img).all(), f"{label}: non-finite pixels")
        frames[label] = img
        emit("c:frame", card, config=label,
             shape=f"{c.width}x{c.height} spp={c.rays_per_pixel} "
                   f"bounces={c.max_bounces}",
             compile_s=round(first - second, 3), frame_s=second,
             segments=st.get("segments"),
             iterations=st.get("iterations", "not reported (staged)"),
             mrays_per_s=st["segments"] / second / 1e6,
             peak_bytes_in_use=peak_bytes(dev))
    res = compare(frames["defaults"], frames["bench-knobs"])
    emit("c:frame", card, compare="defaults vs bench-knobs", tol=TOL, **res)
    check(res["ok"], "defaults and bench-knob frames disagree")

    # The same pixels on the CPU, modular engine: seeds are pure
    # functions of the pixel, so the crop must match the card's frame.
    cpu = jax.devices("cpu")[0]
    n = 32
    x0, y0 = (cfg.width - n) // 2, (cfg.height - n) // 2
    scene_c, cam_c = jax.device_put((scene, cam), cpu)
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        tile, _ = render_tile_with_stats(
            scene_c, cam_c, cfg.replace(engine="modular"), x0, y0, n, n)
        tile = np.asarray(tile)
    res = compare(frames["defaults"][y0:y0 + n, x0:x0 + n], tile)
    emit("c:frame", card, compare=f"card vs cpu crop {n}x{n}@({x0},{y0})",
         cpu_s=time.perf_counter() - t0, tol=TOL, **res)
    check(res["ok"], "card frame disagrees with the CPU crop")


def phase_cli(card, dev):
    import numpy as np

    from tpurt import cli
    from tpurt.io.bmp import read_bmp

    out_dir = os.path.join(REPO, "chiprun_out", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "cli_blob69k_1080p.bmp")
    if os.path.exists(out):
        os.remove(out)
    argv = ["--object-path", HEADLINE["object_path"],
            "--width", "1920", "--height", "1080",
            "--rays-per-pixel", "8", "--max-bounces", "4", "--output", out]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli.main returned {rc}")
    img = read_bmp(out)
    lit = float((img.max(-1) > 8).mean())
    emit("d:cli", card, argv=" ".join(argv[2:]), wall_s=wall,
         shape=list(img.shape), lit_fraction=lit,
         mean_u8=float(img.mean()), peak_bytes_in_use=peak_bytes(dev))
    check(img.shape == (1080, 1920, 3), f"BMP shape {img.shape}")
    check(lit > 0.05 and np.isfinite(img).all(), "CLI frame is trivial")


def phase_dense(card, dev):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from tpurt.config import RenderConfig
    from tpurt.core import v3 as v3lib
    from tpurt.render import plucker_fused as pf
    from tpurt.render.renderer import render_frame

    cfg = RenderConfig(width=1280, height=720, rays_per_pixel=8,
                       max_bounces=4, mega_dense=True, rays_per_batch=230400,
                       **{**BENCH_KNOBS, "pixels_per_lane": 4})
    scene, cam = bench.build_scene("teapot", cfg)
    table = pf.build_dense_table(scene)

    # Kernel vs reference at the row's widths: 230,400 lanes against
    # the teapot's triangles, rays aimed through the mesh's box.
    lanes = DENSE_LANES
    rng = np.random.default_rng(0)
    d = rng.standard_normal((lanes, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo = d * np.float32(300.0)
    tgt = (rng.standard_normal((lanes, 3)) * 60).astype(np.float32)
    ld = tgt - lo
    ld /= np.linalg.norm(ld, axis=1, keepdims=True)
    feats = pf.ray_features(v3lib.from_rows(jnp.asarray(lo)),
                            v3lib.from_rows(jnp.asarray(ld)))
    entry = jnp.full((lanes,), int(table.entry[0]), jnp.int32)
    kern = jax.jit(pf.sweep_entry_kernel)
    ref = jax.jit(pf.sweep_entry_reference)
    times = {}
    outs = {}
    for name, fn in (("kernel", kern), ("reference", ref)):
        jax.block_until_ready(fn(feats, entry, table))
        t0 = time.perf_counter()
        for _ in range(5):
            out = jax.block_until_ready(fn(feats, entry, table))
        times[name] = (time.perf_counter() - t0) / 5
        outs[name] = tuple(map(np.asarray, out))
    (kt, kc), (rt, rc) = outs["kernel"], outs["reference"]
    same = (kc == rc)
    both = same & (kc >= 0)
    t_rel = float((np.abs(kt[both] - rt[both]) / rt[both]).max())
    emit("e:dense", card, lanes=lanes, triangles=table.count,
         kernel_ms=times["kernel"] * 1e3, reference_ms=times["reference"] * 1e3,
         hit_fraction=float((rc >= 0).mean()),
         same_column=float(same.mean()), t_max_rel=t_rel)
    check(same.mean() >= 0.999 and t_rel <= 1e-5,
          "dense sweep kernel disagrees with its reference")

    img, first, second, st = timed_frame(render_frame, scene, cam, cfg)
    lit = float((img.max(-1) > 0.01).mean())
    emit("e:dense", card, frame="teapot 1280x720 spp=8 bounces=4 brute force",
         compile_s=round(first - second, 3), frame_s=second,
         segments=st.get("segments"), iterations=st.get("iterations"),
         lit_fraction=lit, peak_bytes_in_use=peak_bytes(dev))
    check(np.isfinite(img).all() and lit > 0.05, "brute-force frame is trivial")


def phase_tests(card, dev):
    import pytest

    os.environ["TESTS_ON_GPU"] = "1"
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(REPO, "tests")])
    emit("f:tests", card, pytest_rc=int(rc), wall_s=time.perf_counter() - t0)
    check(rc == 0, f"pytest -m gpu exited {rc}")


def phase_four_gpus(card, devs):
    """Tile and sample sharding on four cards against one card. Both
    sides run one launch of the same flat megakernel program per
    frame block (pixels_per_lane=8, FOUR_GPU_BATCH lanes)."""
    import numpy as np

    from tpurt.config import RenderConfig
    from tpurt.parallel import make_mesh, render_frame_sharded
    from tpurt.render.renderer import render_frame
    from tpurt.scene.presets import cornell_sphere_scene, default_scene

    check(len(devs) >= 4, f"--four-gpus needs 4 GPUs, found {len(devs)}")
    devs = devs[:4]

    def run(fn, *args, **kw):
        st = {}
        t0 = time.perf_counter()
        img = fn(*args, **kw, stats=st)
        return img, time.perf_counter() - t0, st.get("segments")

    # Tile mesh, reference seeds: bitwise against one card.
    cfg = RenderConfig(**FOUR_GPU_TILE, max_bounces=4,
                       object_path=HEADLINE["object_path"], **FOUR_GPU_KNOBS)
    scene, cam, _ = default_scene(cfg)
    one, t1, s1 = run(render_frame, scene, cam, cfg)
    four, t4, s4 = run(render_frame_sharded, scene, cam, cfg,
                       mesh=make_mesh(4, 1, devices=devs))
    bitwise = float((one == four).all(-1).mean())
    emit("4gpu:tile", card, frame=f"blob69k {cfg.width}x{cfg.height} "
         f"spp={cfg.rays_per_pixel} bounces=4",
         mesh="4x1 tile", one_card_s=t1, four_card_s=t4,
         note="seconds include compilation", segments=[s1, s4],
         bitwise=bitwise, max_abs=float(np.abs(one - four).max()),
         peak_bytes_in_use=[peak_bytes(d) for d in devs])
    check(bitwise == 1.0, "tile-sharded frame is not bitwise-equal")

    # Sample mesh, decorrelated seeds: psum of four 16-spp means
    # against one card's 64-spp mean (f32 reassociation only).
    cfg = RenderConfig(**FOUR_GPU_SAMPLE, max_bounces=4,
                       seed_mode="decorrelated", object_path="sphere1.obj",
                       **FOUR_GPU_KNOBS)
    scene, cam, _ = cornell_sphere_scene(1, cfg)
    one, t1, _ = run(render_frame, scene, cam, cfg)
    four, t4, _ = run(render_frame_sharded, scene, cam, cfg,
                      mesh=make_mesh(1, 4, devices=devs))
    psum_tol = dict(rtol=1e-5, atol=1e-6, min_close=0.999, mean_rtol=1e-5)
    res = compare(four, one, psum_tol)
    peaks = [peak_bytes(d) for d in devs]
    emit("4gpu:sample", card, frame=f"cornell-sphere1 {cfg.width}x"
         f"{cfg.height} spp={cfg.rays_per_pixel} decorrelated",
         mesh="1x4 sample", one_card_s=t1, four_card_s=t4,
         note="seconds include compilation", tol=psum_tol, **res,
         peak_bytes_in_use=peaks)
    check(res["ok"], "sample-sharded frame outside the psum tolerance")
    check(all(p and p > 0 for p in peaks), f"idle device: {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU sharding phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        import tpurt
    except ImportError:
        print("chip_smoke.py: no tpurt package next to this script",
              file=sys.stderr)
        return 2
    if not os.path.dirname(os.path.abspath(tpurt.__file__)).startswith(REPO):
        print("chip_smoke.py: tpurt is not this checkout's", file=sys.stderr)
        return 2

    import jax

    from tpurt.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke.py: no GPU (devices: {devs})", file=sys.stderr)
        return 1
    import bench

    info = bench.card_info()  # nvidia-smi's name and power.limit
    card = f"{info['name']}, {info['power_limit']}"
    print(f"[a:device] {devs} | {card}", flush=True)
    dev = devs[0]

    if args.four_gpus:
        phases = [("four-gpus", lambda: phase_four_gpus(card, devs))]
        count = 4
    else:
        cases = oracle_cases()
        pending = []

        def dense_beside_oracle():
            # The oracle's host renders run on a thread during (e), whose
            # timings are device-bound; (c) and (d) time host-driven
            # schedules and run alone. (b) then compares.
            pending.append(start_oracle(cases))
            phase_dense(card, dev)

        phases = [
            ("c:frame", lambda: phase_frame(card, dev)),
            ("d:cli", lambda: phase_cli(card, dev)),
            ("e:dense", dense_beside_oracle),
            ("b:oracle", lambda: phase_oracle(card, dev, cases, pending[0])),
            ("f:tests", lambda: phase_tests(card, dev)),
        ]
        count = 1
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # report the phase, keep checking the rest
            traceback.print_exc()
            print(f"[{name}] FAILED: {e}", flush=True)
            failed.append(name)
        print(f"[{name}] done in {time.perf_counter() - t0:.1f}s", flush=True)
    print(f"{card} | total {time.perf_counter() - t_all:.1f}s", flush=True)
    if failed:
        print(f"chip_smoke.py: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
