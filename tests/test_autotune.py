"""Autotuner plumbing (tpurt/autotune.py): the sweep runs end-to-end on
the CPU (tiny shapes; the chosen values are meaningless on CPU — only
the machinery is under test)."""

import json
import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # compile-heavy (mega engine legs)

from tpurt.config import RenderConfig


def test_autotune_quick_sweep_and_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TPURT_TUNE_DIR", str(tmp_path))
    from tpurt import autotune

    cfg = RenderConfig(width=32, height=16, rays_per_pixel=1,
                       max_bounces=2, rays_per_batch=256,
                       pixels_per_lane=2, compaction_threshold=0)
    # Two-value axes keep the CPU sweep to a few compiles. node_arity
    # exercises the freeze-time rebuild path (the bank layout axis).
    monkeypatch.setattr(autotune, "AXES", (
        ("node_arity", (8, 4)),
        ("mega_tail_passes", (1, 2)),
        ("mega_interleave", (1, 2)),
    ))
    import tpurt.config as _c

    # Register restore-to-default for every global apply() touches so
    # later tests in the session see the shipped layout again.
    for name in ("MEGA_BF16_BOUNDS", "MEGA_LEAF_TRIS",
                 "MEGA_NODE_ARITY", "MEGA_MAT_PRUNE"):
        monkeypatch.setattr(_c, name, getattr(_c, name))

    knobs = autotune.sweep(cfg, scene_kind="sphere", quick=False,
                           log=lambda *a: None)
    assert np.isfinite(knobs["seconds_per_frame"])
    assert knobs["mega_tail_passes"] in (1, 2)
    assert knobs["node_arity"] in (4, 8)
    # Globals restored to the WINNING set (not a losing trial's value).
    assert _c.MEGA_NODE_ARITY == knobs["node_arity"]
    assert _c.MEGA_LEAF_TRIS == knobs["leaf_tris"]

    # Cache round-trip + apply().
    path = autotune.cache_path("cpu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"platform": "cpu", "knobs": knobs}, f)
    loaded = autotune.load_tuned("cpu")
    assert loaded == knobs
    cfg2 = autotune.apply(loaded, cfg)
    assert cfg2.mega_tail_passes == knobs["mega_tail_passes"]
