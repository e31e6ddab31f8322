"""Command-line driver.

Reproduces the reference's interactive flow (src/main.cpp:14-244): dump
the device inventory, prompt for device list / width / height /
rays-per-pixel / max bounces / OBJ path with empty-input-keeps-default
semantics (parseDefaultInput, math.hpp:182-218), render with a live
progress/ETA line, write output.bmp — and adds what the reference
lacks: real CLI flags, non-interactive mode, JSON scene files,
checkpoint/resume, video and progressive-preview modes, and multi-chip
meshes. The reference accepts no CLI args at all (README.md:69).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from tpurt.config import RenderConfig


def _prompt(label: str, default, cast):
    """parseDefaultInput semantics: empty line keeps the default;
    unparseable input falls back to the default with a warning."""
    try:
        line = input(f"{label} [{default}]: ").strip()
    except EOFError:
        return default
    if not line:
        return default
    try:
        return cast(line)
    except ValueError:
        print(f"could not parse {line!r}; keeping {default}", file=sys.stderr)
        return default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpurt",
        description="Monte-Carlo path tracer in JAX "
        "(re-implementation of ripoff-raytracer's capabilities)",
    )
    d = RenderConfig()
    p.add_argument("--width", type=int, default=d.width)
    p.add_argument("--height", type=int, default=d.height)
    p.add_argument("--rays-per-pixel", type=int, default=d.rays_per_pixel)
    p.add_argument("--max-bounces", type=int, default=d.max_bounces)
    p.add_argument("--tile-size", type=int, default=d.tile_size)
    p.add_argument("--object-path", default=d.object_path,
                   help="OBJ file; missing files fall back to procedural "
                        "stand-ins (sphereN / knot)")
    p.add_argument("--scene-json", default=None,
                   help="JSON scene description (see scene.presets docs)")
    p.add_argument("--seed-mode", choices=["reference", "decorrelated"],
                   default=d.seed_mode)
    p.add_argument("--subpixel-jitter", action="store_true")
    p.add_argument("--engine", choices=["mega", "modular"], default=d.engine,
                   help="integrator: persistent-lane megakernel (fast "
                        "path) or the modular bounce loop")
    p.add_argument("--pixels-per-lane", type=int, default=d.pixels_per_lane,
                   help="pixel quota per megakernel lane (work "
                        "equalisation)")
    p.add_argument("--rays-per-batch", type=int, default=d.rays_per_batch,
                   help="lanes per flat megakernel launch (0 = tile loop)")
    p.add_argument("--interleave", type=int, default=d.mega_interleave,
                   help="megakernel sub-batches per loop iteration (row "
                        "gathers overlap the previous sub-batch's compute; "
                        "bitwise-identical)")
    p.add_argument("--tail-passes", type=int, default=d.mega_tail_passes,
                   help="segment-completion passes per megakernel loop "
                        "iteration (bitwise-identical scheduling knob)")
    p.add_argument("--frames-per-batch", type=int, default=1,
                   help="cross-frame lane packing for --frames videos "
                        "with a static-position camera: pack this many "
                        "frames per megakernel launch (bitwise-identical "
                        "to frame-by-frame)")
    p.add_argument("--tuned", action="store_true",
                   help="apply this platform's cached autotuner knob set "
                        "(python -m tpurt.autotune)")
    p.add_argument("--mega-dense", action="store_true",
                   help="brute-force the megakernel: one fused Pluecker "
                        "sweep per bounce segment instead of the BVH "
                        "walk (the reference's UseBVH=false mode; fastest "
                        "below a few thousand triangles)")
    p.add_argument("--output", default="output.bmp")
    p.add_argument("--checkpoint", default=None,
                   help="npz tile accumulator path for resume/preview")
    p.add_argument("--frames", type=int, default=1,
                   help="video frame count; >1 writes <video-dir>/output_<i>.bmp")
    p.add_argument("--video-dir", default=d.video_output_dir)
    p.add_argument("--progressive", type=int, default=0, metavar="PASSES",
                   help="progressive refinement: average PASSES whole-frame "
                        "passes, writing preview.bmp periodically")
    p.add_argument("--preview-every", type=int, default=10)
    p.add_argument("--devices", default=None, metavar="IDS",
                   help="comma-separated device ids to render on (the "
                        "reference's interactive device pick, "
                        "main.cpp:159-193); default: all")
    p.add_argument("--tile-devices", type=int, default=None,
                   help="devices on the image-tile mesh axis (default: all)")
    p.add_argument("--sample-devices", type=int, default=1,
                   help="devices on the samples-per-pixel mesh axis "
                        "(needs --seed-mode decorrelated)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host: jax.distributed coordinator address; "
                        "requires --num-processes and --process-id")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--overdecompose", type=int, default=1, metavar="K",
                   help="round-robin pixel blocks per tile-axis device "
                        "(load balance for non-uniform scenes; mega "
                        "engine only)")
    p.add_argument("--single-chip", action="store_true",
                   help="host tile loop on one device (no shard_map)")
    p.add_argument("--interactive", action="store_true",
                   help="prompt for settings like the reference driver")
    p.add_argument("--view", action="store_true",
                   help="interactive progressive viewer: steer the "
                        "camera (wasd/qe + ijkl), adjust spp/bounces, "
                        "pick-to-tint; writes preview.bmp per pass")
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from tpurt.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    # Multi-host initialisation must precede any backend use: the mesh
    # then spans every process (SURVEY.md §2.3). Single-process remains
    # the default; this is the jax.distributed analog of the reference's
    # single-host multi-GPU setup (image.hpp:280-350).
    if args.coordinator is not None:
        if args.num_processes is None or args.process_id is None:
            print("--coordinator requires --num-processes and --process-id",
                  file=sys.stderr)
            return 2
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from tpurt.parallel.mesh import device_inventory, select_devices

    inventory = device_inventory()
    print(f"Found {len(inventory)} device(s):")
    for rec in inventory:
        extra = f", {rec['memory_gb']} GiB" if "memory_gb" in rec else ""
        print(f"  [{rec['id']}] {rec['kind']} ({rec['platform']}{extra})")
    if args.list_devices:
        return 0

    if args.interactive:
        # The reference prompts for a comma-separated device list first
        # (main.cpp:159-193).
        args.devices = _prompt("Devices (comma-separated ids)",
                               args.devices or "all", str)
        if args.devices == "all":
            args.devices = None
        args.width = _prompt("Width", args.width, int)
        args.height = _prompt("Height", args.height, int)
        args.rays_per_pixel = _prompt("Rays per pixel", args.rays_per_pixel, int)
        args.max_bounces = _prompt("Max bounces", args.max_bounces, int)
        args.object_path = _prompt("OBJ path", args.object_path, str)

    cfg = RenderConfig(
        width=args.width, height=args.height,
        rays_per_pixel=args.rays_per_pixel, max_bounces=args.max_bounces,
        tile_size=args.tile_size, object_path=args.object_path,
        seed_mode=args.seed_mode, subpixel_jitter=args.subpixel_jitter,
        video_frame_count=args.frames, video_output_dir=args.video_dir,
        engine=args.engine,
        pixels_per_lane=args.pixels_per_lane,
        rays_per_batch=args.rays_per_batch,
        mega_interleave=args.interleave,
        mega_dense=args.mega_dense,
        mega_tail_passes=args.tail_passes,
        mega_frames_per_batch=max(1, args.frames_per_batch),
    )
    if args.tuned:
        from tpurt import autotune

        knobs = autotune.load_tuned()
        if knobs:
            cfg = autotune.apply(knobs, cfg)
        else:
            print("no autotune cache for this platform; run "
                  "`python -m tpurt.autotune` (using defaults)")

    from tpurt.scene.presets import default_scene
    from tpurt.scene.jsonscene import scene_from_json
    from tpurt.render.renderer import render_frame
    from tpurt.render.tonemap import tonemap
    from tpurt.io.bmp import write_bmp
    from tpurt.io.checkpoint import TileAccumulator
    from tpurt.utils.progress import ProgressReporter, mrays_per_second
    from tpurt import anim

    if args.scene_json:
        with open(args.scene_json) as f:
            scene, camera = scene_from_json(json.load(f), cfg)
    else:
        scene, camera, _ = default_scene(cfg)
    print(
        f"Scene: {scene.num_triangles} triangles, {scene.num_nodes} BVH nodes, "
        f"{scene.num_meshes} meshes"
    )

    live = sys.stderr.isatty()
    t0 = time.perf_counter()
    stats: dict = {}  # filled with {"segments": N} where the path supports it

    if args.view:
        from tpurt.viewer import run_terminal

        # Interactive sessions default to the PLAIN flat mega schedule:
        # the staged/compaction driver's internal host reads serialise
        # against the double-buffered pass delivery (viewer
        # render_passes), and at viewer frame sizes the plain path's
        # latency wins (bench parity row).
        run_terminal(scene, cfg.replace(compaction_threshold=0),
                     preview_path="preview.bmp")
        return 0

    if args.frames > 1:
        prog = ProgressReporter(args.frames, label="frames", live=live)
        paths = anim.render_video(scene, camera, cfg, progress=prog)
        prog.finish()
        print(f"Wrote {len(paths)} frames to {args.video_dir}/ "
              f"(assemble with scripts/render.sh)")
        return 0

    if args.progressive > 0:
        prog = ProgressReporter(args.progressive, label="passes", live=live)
        radiance = anim.progressive_render(
            scene, camera, cfg, args.progressive,
            preview_path="preview.bmp", preview_every=args.preview_every,
            progress=prog,
        )
        prog.finish()
    elif args.single_chip or (len(inventory) == 1 and not args.devices):
        tiles_x, tiles_y = cfg.tiles()
        prog = ProgressReporter(tiles_x * tiles_y, live=live)
        acc = (
            TileAccumulator(cfg, path=args.checkpoint) if args.checkpoint else None
        )
        radiance = render_frame(
            scene, camera, cfg, progress=prog, accumulator=acc, stats=stats
        )
        prog.finish()
    else:
        from tpurt.parallel import make_mesh, mesh_info, render_frame_sharded

        try:
            devices = select_devices(args.devices)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        mesh = make_mesh(args.tile_devices, args.sample_devices,
                         devices=devices)
        print(mesh_info(mesh))
        radiance = render_frame_sharded(
            scene, camera, cfg, mesh=mesh,
            overdecompose=args.overdecompose, stats=stats,
        )

    elapsed = time.perf_counter() - t0
    import jax.numpy as jnp

    write_bmp(args.output, np.asarray(tonemap(jnp.asarray(radiance))))
    if stats.get("segments"):
        # Exact path-segment count from the integrator (the true "rays"
        # of Mrays/s — rays = W*H*spp*avg_path_length, SURVEY.md §6).
        rate = f"{stats['segments'] / elapsed / 1e6:.1f} Mrays/s"
    else:
        # Paths without segment accounting report the primary-ray lower
        # bound (avg path length >= 1.0).
        mrays = mrays_per_second(
            cfg.width, cfg.height, cfg.rays_per_pixel, 1.0, elapsed
        )
        rate = f">= {mrays:.1f} Mrays/s"
    print(
        f"Rendered {cfg.width}x{cfg.height} @ {cfg.rays_per_pixel} spp in "
        f"{elapsed:.2f}s ({rate}) -> {args.output}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
