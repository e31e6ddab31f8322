"""Megakernel scheduling knobs (XLA body, CPU): pixel quotas, staged
compaction, sample flattening, tail passes and interleaved sub-batches
only change which lane runs which work when, so each must reproduce the
plain render bitwise (or within the staged schedule's 1-ulp class).
"""

import pytest

pytestmark = pytest.mark.slow  # compile-heavy (see pyproject addopts)
import numpy as np

from tpurt.config import RenderConfig
from tpurt.render.renderer import render_frame
from tpurt.scene.presets import default_scene


def _cfg(**kw):
    # Tiny workloads: a few dozen loop iterations each.
    base = dict(width=16, height=8, rays_per_pixel=1, max_bounces=3,
                tile_size=16, object_path="sphere0.obj", engine="mega",
                rays_per_batch=128, compaction_threshold=0)
    base.update(kw)
    return RenderConfig(**base)


def test_pixel_quota_matches_plain_bitwise():
    """pixels_per_lane > 1 (in-body pixel advance: camera ray, seed,
    cache reset computed inside the loop) must be bitwise-identical to
    the plain one-pixel-per-lane flat path and the tile sweep."""
    cfg_plain = _cfg(width=40, height=24, rays_per_pixel=2, max_bounces=4,
                     rays_per_batch=960)
    scene, cam, _ = default_scene(cfg_plain)
    ref = render_frame(scene, cam, cfg_plain)
    for p in (2, 4):
        cfg_q = _cfg(width=40, height=24, rays_per_pixel=2, max_bounces=4,
                     rays_per_batch=960 // p, pixels_per_lane=p)
        out = render_frame(scene, cam, cfg_q)
        assert np.array_equal(ref, out), p
    # quota batches that don't divide the frame (padding + clamp path)
    cfg_q = _cfg(width=40, height=24, rays_per_pixel=2, max_bounces=4,
                 rays_per_batch=256, pixels_per_lane=3)
    assert np.array_equal(ref, render_frame(scene, cam, cfg_q))


def test_pixel_quota_staged_compaction_near_bitwise():
    """Quota + host-staged compaction: the compacted tail re-runs under
    a different executable width, where XLA may contract FMAs
    differently — identical up to 1-ulp on a handful of pixels, same
    tolerance class as the plain staged path
    (test_flat_batching.test_flat_staged_compaction_near_bitwise)."""
    cfg_plain = _cfg(width=40, height=24, rays_per_pixel=3, max_bounces=5,
                     rays_per_batch=240, pixels_per_lane=4)
    scene, cam, _ = default_scene(cfg_plain)
    plain = render_frame(scene, cam, cfg_plain)
    staged = render_frame(scene, cam, cfg_plain.replace(
        compaction_threshold=128))
    exact = (plain == staged).all(axis=-1)
    assert exact.mean() > 0.99, exact.mean()
    np.testing.assert_allclose(plain, staged, rtol=1e-5, atol=1e-7)


def test_sample_flatten_matches_decorrelated_bitwise():
    """sample_flatten (rays_per_pixel one-sample device-accumulated
    passes) must equal the ordinary decorrelated render bitwise:
    per-sample trajectories are pure functions of (pixel, frame,
    sample) and the accumulation adds in the same sample order."""
    cfg = _cfg(width=32, height=16, rays_per_pixel=3, max_bounces=4,
               rays_per_batch=256, pixels_per_lane=2,
               seed_mode="decorrelated")
    scene, cam, _ = default_scene(cfg)
    ref = render_frame(scene, cam, cfg)
    out = render_frame(scene, cam, cfg.replace(sample_flatten=True))
    assert np.array_equal(ref, out)


def test_tail_passes_match_single_pass_bitwise():
    """mega_tail_passes > 1 (multi-pass segment completion: replays and
    all-pretests-failed segments shade in the same iteration instead of
    idling a gather each) must be bitwise-identical to the one-pass
    body — the per-lane op sequence is unchanged, only the loop-trip
    packing differs. Covers the chain-skip (pretest-fail entry advance)
    against the iterated fold it replaces. Quota lanes included: the
    pass-2 shade may complete a pixel and advance the quota in the same
    iteration its previous segment folded."""
    cfg1 = _cfg(rays_per_pixel=2, max_bounces=4, pixels_per_lane=2,
                rays_per_batch=64, mega_tail_passes=1)
    scene, cam, _ = default_scene(cfg1)
    ref = render_frame(scene, cam, cfg1)
    out = render_frame(scene, cam, cfg1.replace(mega_tail_passes=2))
    assert np.array_equal(ref, out)


def test_interleave_matches_single_batch_bitwise(monkeypatch):
    """mega_interleave=2 (independent sub-batches stepped back-to-back
    inside one while iteration so each gather overlaps the other half's
    body) must be bitwise-identical to interleave=1 — lanes never mix
    across sub-batches. The production floor (MEGA_INTERLEAVE_FLOOR)
    would silently disable the split at test sizes, so patch it down to
    actually exercise the interleaved path."""
    import tpurt.config as config_mod

    monkeypatch.setattr(config_mod, "MEGA_INTERLEAVE_FLOOR", 128)
    cfg1 = _cfg(rays_per_pixel=2, max_bounces=4, rays_per_batch=256,
                mega_interleave=1)
    scene, cam, _ = default_scene(cfg1)
    ref = render_frame(scene, cam, cfg1)
    out = render_frame(scene, cam, cfg1.replace(mega_interleave=2))
    assert np.array_equal(ref, out)


def test_interleave_floor_falls_back_to_single_batch():
    """Below the floor the engine must run interleave=1 (identical
    output, no 128-lane sub-batches)."""
    cfg1 = _cfg(rays_per_pixel=2, rays_per_batch=256, mega_interleave=1)
    scene, cam, _ = default_scene(cfg1)
    ref = render_frame(scene, cam, cfg1)
    out = render_frame(scene, cam, cfg1.replace(mega_interleave=2))
    assert np.array_equal(ref, out)
