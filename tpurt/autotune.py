"""Autotuner: derive the engine knob set on a new device.

The engine's knobs (bank layout, interleave, tail passes, pixel quota,
bounds format, material pruning) trade loop iterations against body
size, and where the optimum sits depends on the device. This module
measures it: coordinate descent over the knob axes on a
headline-shaped workload, one steady-state timed block per leg
(bench.time_render_flat's methodology), results cached per platform so
the sweep runs once per device generation.

    python -m tpurt.autotune            # full sweep (each leg compiles)
    python -m tpurt.autotune --quick    # interleave + tail passes only
    python bench.py --tuned             # apply the cached knob set

The tuned values feed RenderConfig fields verbatim; the bank layout and
bounds format are config-module tunables applied via apply(). On the
CPU the numbers are meaningless — the CPU path exists to smoke the
plumbing (tests/test_autotune.py).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

#: Axes swept, in descent order: bank layout first (arity x leaf, which
#: together derive the row width W at freeze: u8 node rows need
#: 7+3*arity words, leaf rows 1+21*leaf), then tail passes, then the
#: scheduler knobs. Values are candidates; the current best of every
#: other axis is held while one axis sweeps. The descent SEEDS from the
#: shipped config (the config-module defaults) and explores outward.
AXES = (
    ("node_arity", (4, 8, 16, 32)),
    ("leaf_tris", (2, 3, 4, 5, 8)),
    ("mega_tail_passes", (3, 4, 5, 6)),
    ("mega_interleave", (1, 2, 4, 8)),
    ("pixels_per_lane", (4, 8, 16)),
    ("bounds_fmt", ("u8", "bf16")),
    ("mat_prune", (True, False)),
)
QUICK_AXES = ("mega_tail_passes", "mega_interleave")

_CFG_FIELDS = {"mega_tail_passes", "mega_interleave", "pixels_per_lane"}
#: Axes baked into the Scene at freeze time (bank layout / encoding):
#: each leg rebuilds + refreezes the scene.
_FREEZE_AXES = {"bounds_fmt", "leaf_tris", "node_arity"}
#: Axes read from config-module globals at TRACE time without entering
#: any jit cache key: mutating them silently reuses the stale
#: executable, so these legs clear the jit caches around the trial.
_TRACE_GLOBAL_AXES = {"mat_prune"}


def cache_path(platform: str) -> str:
    root = os.environ.get("TPURT_TUNE_DIR") or os.path.expanduser("~/.cache")
    return os.path.join(root, f"tpurt_tune_{platform}.json")


def load_tuned(platform: Optional[str] = None) -> Optional[dict]:
    """The cached knob set for this platform, or None."""
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    try:
        with open(cache_path(platform)) as f:
            return json.load(f)["knobs"]
    except (OSError, KeyError, ValueError):
        return None


def apply(knobs: dict, cfg):
    """Returns (cfg with tuned RenderConfig fields, after applying the
    config-module tunables). Unknown keys are ignored so old caches
    survive knob renames."""
    import tpurt.config as _c

    updates = {k: knobs[k] for k in _CFG_FIELDS if k in knobs}
    if "bounds_fmt" in knobs:
        # Scene freeze reads the format; the sweep re-freezes per value.
        _c.MEGA_BF16_BOUNDS = knobs["bounds_fmt"] == "bf16"
    if "leaf_tris" in knobs:
        # Freeze-time bank layout (leaf capacity; with node_arity this
        # derives the row width W at freeze).
        _c.MEGA_LEAF_TRIS = int(knobs["leaf_tris"])
    if "node_arity" in knobs:
        _c.MEGA_NODE_ARITY = int(knobs["node_arity"])
    if "mat_prune" in knobs:
        _c.MEGA_MAT_PRUNE = bool(knobs["mat_prune"])
    return cfg.replace(**updates) if updates else cfg


def _bench_mod():
    try:
        import bench
    except ImportError:  # installed package: bench.py lives at repo root
        import sys

        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import bench
    return bench


def _time_leg(scene, cam, cfg, frames: int = 3) -> float:
    """Steady-state seconds/frame of the flat path (compile excluded,
    the bench methodology)."""
    bench = _bench_mod()

    r = bench.time_render_flat(scene, cam, cfg, repeats=1,
                               max_frames=frames)
    return r["seconds"]


def _build(cfg, scene_kind: str):
    return _bench_mod().build_scene(scene_kind, cfg)


def sweep(cfg=None, scene_kind: str = "bunny", quick: bool = False,
          log=print) -> dict:
    """Coordinate descent over AXES; returns the winning knob dict
    (including its measured seconds/frame). Each leg is a fresh steady
    block; a leg that fails to compile (e.g. for want of device memory)
    is logged and skipped."""
    import jax

    from tpurt.config import RenderConfig
    import tpurt.config as _c

    if cfg is None:
        # Seed the descent from the bench's knob set (bench common)
        # instead of re-climbing from the RenderConfig defaults.
        # mega_frames_per_batch=2 because that is the workload bench
        # runs for the headline: the tuner must price knobs under the
        # quota-slot pressure they will actually run with.
        cfg = RenderConfig(width=1920, height=1080, rays_per_pixel=8,
                           max_bounces=4, seed_mode="reference",
                           pixels_per_lane=8, mega_interleave=4,
                           mega_tail_passes=5, compaction_threshold=0,
                           mega_frames_per_batch=2)
    best = {
        "mega_tail_passes": cfg.mega_tail_passes,
        "mega_interleave": cfg.mega_interleave,
        "pixels_per_lane": cfg.pixels_per_lane,
        "bounds_fmt": "bf16" if getattr(_c, "MEGA_BF16_BOUNDS", False) else "u8",
        "leaf_tris": int(getattr(_c, "MEGA_LEAF_TRIS", 3)),
        "node_arity": int(getattr(_c, "MEGA_NODE_ARITY", 8)),
        "mat_prune": bool(getattr(_c, "MEGA_MAT_PRUNE", True)),
    }
    scene, cam = _build(apply(best, cfg), scene_kind)
    t_best = _time_leg(scene, cam, apply(best, cfg))
    log(f"[autotune] baseline {best} -> {t_best*1e3:.1f} ms/frame")
    for axis, values in AXES:
        if quick and axis not in QUICK_AXES:
            continue
        for v in values:
            if v == best[axis]:
                continue
            trial = dict(best, **{axis: v})
            try:
                tcfg = apply(trial, cfg)
                tscene = scene
                if axis in _FREEZE_AXES:  # baked into the Scene
                    tscene, cam = _build(tcfg, scene_kind)
                if axis in _TRACE_GLOBAL_AXES:
                    # These globals are read at trace time but are NOT
                    # part of any jit cache key — without a cache clear
                    # the leg replays the previous executable verbatim.
                    jax.clear_caches()
                t = _time_leg(tscene, cam, tcfg)
            except Exception as e:  # compile OOM etc: skip the point
                log(f"[autotune] {axis}={v} failed: {str(e)[:120]}")
                continue
            log(f"[autotune] {axis}={v} -> {t*1e3:.1f} ms/frame")
            if t < t_best:
                t_best, best = t, trial
                if axis in _FREEZE_AXES:
                    scene = tscene
        if axis in _TRACE_GLOBAL_AXES:
            # Leave the axis's global at the WINNER, with fresh caches,
            # before the next axis compiles against it.
            apply(best, cfg)
            jax.clear_caches()
    # Restore every config-module tunable to the winning set (a losing
    # trial otherwise leaves its value behind for any in-process freeze
    # after sweep()).
    apply(best, cfg)
    best["seconds_per_frame"] = t_best
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--scene", default="bunny")
    ap.add_argument("--cpu", action="store_true",
                    help="plumbing smoke on the CPU (tiny shapes, "
                         "numbers meaningless)")
    args = ap.parse_args()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    cfg = None
    if args.cpu:
        from tpurt.config import RenderConfig

        cfg = RenderConfig(width=64, height=32, rays_per_pixel=2,
                           max_bounces=2, rays_per_batch=1024,
                           compaction_threshold=0)
    platform = jax.devices()[0].platform
    knobs = sweep(cfg, scene_kind=args.scene if not args.cpu else "sphere",
                  quick=args.quick)
    path = cache_path(platform)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"platform": platform, "ts": time.time(),
                   "knobs": knobs}, f, indent=1)
    print(json.dumps({"platform": platform, "knobs": knobs}))
    print(f"cached -> {path}")


if __name__ == "__main__":
    main()
