"""Speculative replay of the staged schedule (renderer._SCHED_TRACES).

After one blocking staged run of a (scene, shape) key, later batches
dispatch the recorded stage/compact/respread sequence without blocking
host reads and validate guard scalars after dispatch — each removed
int(active) readback leaves the device idle for a host round trip.
Replayed frames must be bitwise-identical to
the blocking run (same executables, same widths, same order), and a
corrupted trace must fail its guards and fall back to the blocking
path, still bitwise-correct. The reference has no analog — its host
threads block on every tile (src/image.hpp:241-253); this is the
async-dispatch discipline an accelerator behind a host queue needs.
"""

import pytest

pytestmark = pytest.mark.slow  # compile-heavy (see pyproject addopts)
import numpy as np

from tpurt.config import RenderConfig
from tpurt.render.renderer import render_batch_flat
from tpurt.scene.presets import default_scene


def _cfg(**kw):
    base = dict(width=64, height=32, rays_per_pixel=8, max_bounces=5,
                tile_size=32, object_path="sphere1.obj", engine="mega")
    base.update(kw)
    return RenderConfig(**base)


def _fresh(monkeypatch):
    from tpurt.render import renderer as R

    monkeypatch.setattr(R, "_MEGA_STAGE_ITERS", 48)
    monkeypatch.setattr(R, "_SCHED_TRACES", {})
    monkeypatch.setattr(R, "_RETIRE_CURVES", {})
    monkeypatch.setattr(R, "_SPEC_STATS", {"replayed": 0, "fallback": 0})
    return R


def test_replay_is_bitwise_and_taken(monkeypatch):
    R = _fresh(monkeypatch)
    cfg = _cfg(rays_per_batch=256, pixels_per_lane=8,
               compaction_threshold=128)
    scene, cam, _ = default_scene(cfg)

    first = np.asarray(render_batch_flat(scene, cam, cfg, 0)[0])
    assert R._SPEC_STATS == {"replayed": 0, "fallback": 0}
    assert len(R._SCHED_TRACES) == 1
    second = np.asarray(render_batch_flat(scene, cam, cfg, 0)[0])
    assert R._SPEC_STATS["replayed"] == 1, R._SPEC_STATS
    assert np.array_equal(first, second)


def test_replay_quota1_uncapped_plan(monkeypatch):
    """P=1 batches have no respread; their plan ends in the uncapped
    stage and must replay bitwise too."""
    R = _fresh(monkeypatch)
    cfg = _cfg(rays_per_batch=2048, pixels_per_lane=1,
               compaction_threshold=128)
    scene, cam, _ = default_scene(cfg)

    first = np.asarray(render_batch_flat(scene, cam, cfg, 0)[0])
    (plan,) = R._SCHED_TRACES.values()
    assert plan and plan[-1][0] == "uncapped", plan
    second = np.asarray(render_batch_flat(scene, cam, cfg, 0)[0])
    assert R._SPEC_STATS["replayed"] == 1, R._SPEC_STATS
    assert np.array_equal(first, second)


def test_guard_failure_falls_back(monkeypatch):
    """A trace whose compact width cannot hold the live lanes must fail
    its guard and re-run the blocking path, bitwise-correct."""
    R = _fresh(monkeypatch)
    cfg = _cfg(rays_per_batch=256, pixels_per_lane=8,
               compaction_threshold=128)
    scene, cam, _ = default_scene(cfg)

    first = np.asarray(render_batch_flat(scene, cam, cfg, 0)[0])
    (key,) = list(R._SCHED_TRACES)
    # Far too narrow a compact for the entry active count: the stable
    # argsort would drop alive lanes, so the guard must reject it.
    R._SCHED_TRACES[key] = [("compact", 128)]
    second = np.asarray(render_batch_flat(scene, cam, cfg, 0)[0])
    assert R._SPEC_STATS["fallback"] == 1, R._SPEC_STATS
    assert np.array_equal(first, second)
    # The blocking fallback re-recorded an honest trace; next run replays.
    third = np.asarray(render_batch_flat(scene, cam, cfg, 0)[0])
    assert R._SPEC_STATS["replayed"] == 1, R._SPEC_STATS
    assert np.array_equal(first, third)


def test_speculative_off_never_replays(monkeypatch):
    R = _fresh(monkeypatch)
    cfg = _cfg(rays_per_batch=256, pixels_per_lane=8,
               compaction_threshold=128, mega_speculative=False)
    scene, cam, _ = default_scene(cfg)
    a = np.asarray(render_batch_flat(scene, cam, cfg, 0)[0])
    b = np.asarray(render_batch_flat(scene, cam, cfg, 0)[0])
    assert R._SPEC_STATS == {"replayed": 0, "fallback": 0}
    assert np.array_equal(a, b)
