"""Render configuration.

Replaces the reference's three-tier config (compile-time #defines +
mutable globals + interactive stdin overrides, src/settings.hpp:13-62,
src/main.cpp:195-234) with a single frozen dataclass. Defaults match
src/settings.hpp exactly so the default workload is the reference's
implicit benchmark (512x512, 50 spp, 50 bounces, tile 512).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: Space between the loaded model and the Cornell-box walls
#: (ref: src/settings.hpp:52  CORNELL_BREATHING_ROOM).
CORNELL_BREATHING_ROOM = 100.0

#: Numeric epsilon used throughout the kernel (ref: src/Trace.cl:6).
EPSILON = 1e-6

#: Index of refraction of the surrounding medium (ref: src/Trace.cl:7).
IOR_AIR = 1.0

#: Mesh/chain-entry count above which per-lane parameter fetches switch
#: from unrolled broadcast-select chains to real gathers. Selects are
#: cheap at small K (each is one fused elementwise op), but the select
#: chains grow the loop body O(K) per call site, so compile time and
#: body size become unusable around K~100 (the reference's mesh loop,
#: src/Trace.cl:444-482, is O(K) per ray at RUNTIME — the select form is
#: O(K) in CODE size too). Above this threshold fetches are gathers,
#: which keep the body O(1) in the instance count.
SELECT_GATHER_THRESHOLD = 64

#: Instanced-mesh count above which scene freeze emits a TLAS (top-
#: level BVH over instances): instance transforms/bounds become DATA
#: ROWS in the megakernel's narrow bank and chain-enter becomes a
#: traversal step, so loop-body size stops growing O(K) with the
#: instance count. At or below the threshold the unrolled select-chain
#: entries stay (each enter is a handful of fused elementwise ops; the
#: TLAS costs ~1 extra gathered row per entered instance). Replaces the
#: reference's O(K)-per-ray mesh loop (src/Trace.cl:444-482) with an
#: O(log K) structure it never had.
MEGA_TLAS_THRESHOLD = 8

#: Maximum chain entries the megakernel's enter step will advance past
#: IN-PLACE when their root pretests fail (the chain skip). Each step
#: unrolls one more _enter/_pretest round into the loop body, so the
#: cap bounds body growth for long chains; lanes that exhaust it fall
#: back to the one-entry-per-iteration fold (bitwise-identical, just
#: slower). Chains of <= MEGA_SKIP_CAP + 1 entries always drain in the
#: iteration that finishes a segment.
MEGA_SKIP_CAP = 3

#: Minimum lanes per interleaved sub-batch (RenderConfig.mega_interleave).
#: Batches whose sub-batches would fall below this floor DROP to the
#: largest interleave that stays at/above it (bitwise-identical either
#: way), so the staged schedule's narrow tail stages run unsplit.
MEGA_INTERLEAVE_FLOOR = 65536

#: Inline root-node expansion at chain-enter time. A traversal entry
#: whose root row is a NODE row normally spends its first loop
#: iteration gathering that row (whose index is BUILD-TIME STATIC per
#: entry) just to run the child test on it. When enabled, the enter
#: step runs that first node test inline from a small precomputed
#: per-entry table (decoded child bounds as scalars — no row gather,
#: no scalar bitcasts) and descends directly to the first hit child,
#: merging the enter-bubble iteration into productive work and removing
#: ~1 gathered row per entered traversal. Trajectory-identical hit
#: decisions: the table holds the exact f32 values the in-loop decode
#: computes. Disabled above the entry cap (each expanded entry adds
#: MEGA_ARITY slab tests to the tail body).
MEGA_ROOT_EXPAND = True
MEGA_ROOT_EXPAND_MAX_E = 4

#: Tail passes that run the enter-time root expansion. Each expanded
#: entry costs MEGA_ARITY slab tests PER TAIL PASS (the expansion block
#: is emitted once per pass), so later passes' expansions triple that
#: body cost at tail_passes=3. Passes beyond this count enter with
#: cur = root instead; the NEXT iteration's node branch performs the
#: same child test from the gathered root row — radiance is bitwise
#: identical (same per-lane op sequence), only iteration scheduling
#: moves. 99 = expand in every pass.
MEGA_EXPAND_PASSES = 99

#: Inline exact triangles per megakernel leaf row. Read at scene
#: FREEZE; the kernel's leaf block follows the scene layout
#: (Scene.mega_leaf_tris). Narrow rows mean fewer gathered bytes per
#: iteration and a smaller in-kernel traversal block; wide layouts
#: remain autotuner axes (tpurt/autotune.py).
MEGA_LEAF_TRIS = 3

#: Children per megakernel node row (read at scene FREEZE; the kernel
#: follows Scene.mega_arity). Small arity shrinks the node-row words
#: (u8 bank floor: 7+3*arity) and the per-iteration node branch (arity
#: slab tests); the tree deepens (blob: depth 7 -> 11 at 8). Must fit
#: MEGA_SLOT_BITS (<= 63).
MEGA_NODE_ARITY = 8

#: Scene-specialised material-branch pruning in the shade step
#: (shading.shade_hit_soa ``present``): bitwise-identical on CPU (the
#: pruned branches' masks are all-False and masked RNG draws freeze).
#: Default ON; the default-suite mega-vs-oracle golden exercises the
#: pruned body bitwise (the Cornell-sphere scene lacks several material
#: types).
MEGA_MAT_PRUNE = True

#: Freeze-time node-row bounds encoding (scene/builder): bf16 absolute
#: child bounds (4 words/slot, decode = shift+bitcast) instead of u8 on
#: a per-node grid (3 words/slot, byte extraction + FMA decode). bf16
#: is both cheaper to decode (~20 fewer ops per slot) and TIGHTER
#: (relative 2^-8 rounding vs 1/255 of the parent extent), so lanes
#: descend into fewer false-positive children. Conservative either way:
#: hit results are identical, only traversal work changes. Baked into
#: the Scene at freeze (Scene.mega_bounds_fmt).
MEGA_BF16_BOUNDS = False


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Knobs of a single render.

    Field defaults mirror src/settings.hpp:23-50 and the camera/fov
    set-up at src/main.cpp:299-304.
    """

    width: int = 512
    height: int = 512
    rays_per_pixel: int = 50
    max_bounces: int = 50
    tile_size: int = 512
    object_path: str = "knight.obj"

    #: Camera start pose (ref: src/settings.hpp:23-28).
    camera_position: Tuple[float, float, float] = (0.0, 150.0, 250.0)
    camera_pitch: float = 0.0
    camera_yaw: float = 3.14
    camera_roll: float = 0.0
    fov_degrees: float = 90.0

    #: ``"reference"`` reuses one RNG stream across all samples of a
    #: pixel, bit-matching the reference spp loop (src/Trace.cl:639-642,
    #: where the state threads through every sample sequentially).
    #: ``"decorrelated"`` re-seeds each sample via MakeSeed(pixel, frame,
    #: sample) so the sample axis becomes embarrassingly parallel and can
    #: be sharded over chips (psum of radiance) — an intentional
    #: improvement; MakeSeed already takes a rayIdx slot the reference
    #: always passes 0 to (src/Trace.cl:632).
    seed_mode: str = "reference"

    #: Budget of extra loop iterations granted to Invisible-material
    #: pass-throughs, which in the reference do NOT count as bounces and
    #: make the bounce loop unbounded (src/Trace.cl:502-506). A masked
    #: while_loop needs a hard trip cap; rays that exhaust the budget
    #: terminate (they would have escaped the scene long before).
    invisible_budget: int = 32

    #: Number of video frames; 1 renders a single output.bmp
    #: (ref: src/settings.hpp:55  VIDEO_FRAME_COUNT).
    video_frame_count: int = 1
    video_output_dir: str = "img"

    #: Optional sub-pixel jitter. The reference casts ONE camera ray per
    #: pixel and reuses it for every sample (src/Trace.cl:636-641) — no
    #: anti-aliasing. Off by default for parity.
    subpixel_jitter: bool = False

    #: Triangle-count threshold below which a mesh is intersected by
    #: brute force instead of BVH traversal (modular engine). Dense
    #: all-pairs intersection is branch-free, so it beats divergent
    #: traversal for small meshes.
    bruteforce_threshold: int = 4096

    #: Lanes per megakernel launch on the flat (non-tiled) fast path.
    #: Each loop iteration has a fixed cost that a wider batch
    #: amortises, until streaming the lane state dominates. Full frames
    #: render as ceil(W*H / rays_per_batch) flat launches.
    rays_per_batch: int = 262144

    #: Pixels each megakernel lane renders sequentially (flat path
    #: only). One flat launch covers rays_per_batch * pixels_per_lane
    #: pixels: lane i owns pixels start+i, start+i+B, ... (stride B).
    #: A lane that finishes a pixel's samples advances to its next
    #: pixel in-loop (primary ray + seed recomputed in the kernel), so
    #: fast lanes keep working while slow ones traverse (the tail of a
    #: quota batch is one straggler set instead of pixels_per_lane of
    #: them, and per-lane work variance averages down). Bitwise-
    #: identical to pixels_per_lane=1 (tests/test_megakernel.py).
    pixels_per_lane: int = 1

    #: Sample-flattened scheduling (decorrelated seed mode only): the
    #: frame renders as rays_per_pixel one-sample passes accumulated on
    #: device instead of each lane looping its pixel's samples. Lane
    #: work becomes near-uniform (one path segment chain per task), so
    #: the straggler tail shrinks from the worst PIXEL (spp x path
    #: variance) to the worst single path. Bitwise-identical to the
    #: ordinary decorrelated render: per-sample trajectories are pure
    #: functions of (pixel, frame, sample) and the device accumulation
    #: adds in the same sample order the in-lane loop uses.
    sample_flatten: bool = False

    #: Lane-compaction threshold for the megakernel (single-chip path):
    #: tiles with at least this many pixels run in host-driven stages —
    #: a capped main stage, then the surviving (slowest) lanes compact
    #: into a quarter-size batch that finishes alone, so the tail of
    #: deep paths stops taxing every lane. 0 disables.
    compaction_threshold: int = 32768

    #: Integrator engine. ``"mega"`` is the persistent-lane megakernel
    #: (one flattened while_loop; the fast path). ``"modular"`` is
    #: the readable nested-loop engine used as its cross-check. Both are
    #: bit-exact against the scalar oracle and each other.
    engine: str = "mega"

    #: Interleaved megakernel sub-batches: the flat batch splits into
    #: this many independent sub-batches stepped back-to-back inside
    #: one while_loop iteration, so each sub-batch's BVH row gather can
    #: overlap the previous sub-batch's body. Bitwise-identical to 1
    #: (lane trajectories are independent). Ignored when the batch does
    #: not split 128-lane-aligned.
    mega_interleave: int = 1

    #: Segment-completion passes per megakernel loop iteration. The
    #: loop body's tail (shade -> restart -> static stage -> chain
    #: enter) runs this many times back-to-back, so a lane whose fresh
    #: segment completes WITHOUT traversal — a cache-replayed primary,
    #: or a ray whose every chain pretest fails (wall hits: the static
    #: stage already resolved it) — shades in the SAME iteration
    #: instead of burning a whole row-gather iteration idling.
    #: Bitwise-identical to 1 (same per-lane op sequence, fewer trips).
    #: The trade: a batch's iteration count is set by its STRAGGLER
    #: lanes, whose trajectories are traversal-dominated, while every
    #: extra pass grows the loop body.
    mega_tail_passes: int = 1

    #: Cross-frame lane packing: multi-frame drivers (bench steady
    #: blocks, animation sweeps) may pack this many FRAMES into one
    #: megakernel launch — quota slots span frames, so one frame's
    #: straggler tail shares loop iterations with the next frame's
    #: ramp and straggler variance averages over frames*pixels_per_lane
    #: pixels per lane. Bitwise-identical to frame-by-frame dispatch
    #: (trajectories are pure functions of (pixel, frame, sample);
    #: tests/test_flat_batching.py). Single-frame APIs (render_frame,
    #: one-frame latency) ignore it. Plain schedule, in-lane samples,
    #: shared camera position only (megakernel.run_megakernel).
    mega_frames_per_batch: int = 1

    #: Gather/body ordering inside one interleaved loop iteration
    #: (only meaningful when mega_interleave > 1 takes effect):
    #: "inline"  — each sub-batch's gather is emitted immediately
    #:             before its own body, so gather_j may overlap
    #:             body_{j-1} (the default).
    #: "gfirst"  — all sub-batch gathers emitted before any body.
    #: "carry"   — software pipelining: the loop CARRIES each sub-
    #:             batch's gathered rows, issued one body-step ahead of
    #:             consumption, so every row gather has a full body to
    #:             hide behind.
    #: "pair2"   — sub-batches advance in PAIRS: both gathers of a
    #:             pair emitted adjacently, then both bodies, so two
    #:             row gathers are in flight at once while the pair's
    #:             bodies overlap the NEXT pair's gathers. Needs
    #:             interleave >= 4 to differ from "inline".
    #: All schedules are bitwise-identical (same per-lane op sequence).
    mega_schedule: str = "inline"

    #: Respread the staged quota tail: when the surviving lanes'
    #: remaining quota pixels fit one 65536-wide batch, re-trace them
    #: as a fresh dense P=1 batch instead of grinding the uncapped
    #: stage at ~3% occupancy (a straggler lane can still hold up to P
    #: unstarted pixels). Pixel traces are pure functions of the pixel
    #: index, so the respread frame is identical up to the usual
    #: staged-executable 1-ulp class. The SPMD answer to the
    #: reference's dynamic work queue draining its tail
    #: (src/image.hpp:289-333).
    mega_tail_respread: bool = True

    #: Cascade respread: fire the quota respread while up to
    #: renderer._CASCADE_MAX incomplete pixels remain (not just when
    #: the tail fits one 65536-pixel P=1 batch) and re-trace them as a
    #: fresh FULL-OCCUPANCY staged quota batch over the packed pixel
    #: list (megakernel list-quota mode), recursing on that batch's own
    #: stragglers. The first stage's cap drops to _CASCADE_STAGE0 so
    #: the boundary lands mid-decay of the retirement curve. Work is
    #: never ground at a few-percent occupancy; the price is re-tracing
    #: the in-flight pixels' partial samples (percent-level). The same
    #: pixel-purity argument as the plain respread: identical up to the
    #: different-executable 1-ulp class.
    mega_cascade: bool = True

    #: Speculative replay of the staged schedule: after one blocking
    #: run of a (scene, shape) key, later frames dispatch the SAME
    #: stage/compact/respread sequence without blocking host reads and
    #: validate guard scalars after dispatch (one readback, overlapped
    #: with queued device work). Each blocking int(active) leaves the
    #: device idle for a host round trip, and removing them lets
    #: multi-batch frames pipeline on the device. A
    #: failed guard (the retirement curve shifted) falls back to the
    #: blocking path from the untouched entry state — always correct,
    #: one speculative pass wasted.
    mega_speculative: bool = True

    #: Brute-force the megakernel: every loop iteration resolves each
    #: live lane's whole current chain entry with ONE fused Plücker
    #: sweep (render/plucker_fused.py) instead of walking the BVH row
    #: bank — the data-parallel form of the reference's UseBVH=false
    #: dense mode (Trace.cl:276-317 + 444-482). One path segment per
    #: lane per iteration, no row gathers; cost scales with the scene's
    #: total chain-triangle count, so this is the small-scene /
    #: cross-check engine (the BVH megakernel wins beyond a few
    #: thousand triangles). Winner acceptance is Plücker-precision
    #: (~1 ulp off the sequential math), shading data exact — the same
    #: contract as dense_engine="plucker".
    mega_dense: bool = False

    #: Dense-sweep backend for brute-force intersection (modular engine
    #: + fused static pass). ``"exact"`` is the broadcast elementwise
    #: form, bit-identical to the scalar oracle. ``"plucker"`` rewrites
    #: MT as a (R,16)x(16,4T) matrix product at full f32 precision
    #: (render/plucker.py) — within ~1 ulp of exact but NOT bitwise
    #: (different summation order; geometric rather than smooth-normal
    #: backface culling during the sweep).
    dense_engine: str = "exact"

    def __post_init__(self) -> None:
        if self.seed_mode not in ("reference", "decorrelated"):
            raise ValueError(f"unknown seed_mode: {self.seed_mode!r}")
        if self.engine not in ("mega", "modular"):
            raise ValueError(f"unknown engine: {self.engine!r}")
        if self.dense_engine not in ("exact", "plucker"):
            raise ValueError(f"unknown dense_engine: {self.dense_engine!r}")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("image dimensions must be positive")
        if self.rays_per_pixel <= 0:
            raise ValueError("rays_per_pixel must be positive")
        if self.pixels_per_lane < 1:
            raise ValueError("pixels_per_lane must be >= 1")
        if self.mega_interleave < 1:
            raise ValueError("mega_interleave must be >= 1")
        if self.mega_tail_passes < 1:
            raise ValueError("mega_tail_passes must be >= 1")
        if self.mega_schedule not in ("inline", "gfirst", "carry", "pair2"):
            raise ValueError(
                "mega_schedule must be 'inline', 'gfirst', 'carry' or"
                " 'pair2'"
            )
        if self.sample_flatten and self.seed_mode != "decorrelated":
            raise ValueError(
                "sample_flatten requires seed_mode='decorrelated' "
                "(reference mode's RNG stream is sequential across a "
                "pixel's samples)"
            )
        # Reference clamps tile size into [1, min(W, H)] (src/main.cpp:230-234).
        object.__setattr__(
            self, "tile_size", max(1, min(self.tile_size, self.width, self.height))
        )

    @property
    def aspect_ratio(self) -> float:
        return float(self.width) / float(self.height)

    def tiles(self) -> Tuple[int, int]:
        """Number of tiles (x, y), ceil-divided like src/main.cpp:678-684."""
        tx = -(-self.width // self.tile_size)
        ty = -(-self.height // self.tile_size)
        return tx, ty

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
