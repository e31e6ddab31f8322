"""Multi-host smoke test: two real processes initialise
jax.distributed against a local coordinator, form a global 2-device CPU
mesh, and run a psum across process boundaries — proving the CLI's
--coordinator/--num-processes/--process-id wiring drives actual
cross-process collectives (the multi-host story in parallel/mesh.py)."""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # compile-heavy (see pyproject addopts)

_CHILD = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
coordinator, num, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
jax.distributed.initialize(coordinator_address=coordinator,
                           num_processes=num, process_id=pid)
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

devs = jax.devices()
assert len(devs) == num, f"global devices {len(devs)} != {num}"
mesh = Mesh(devs, ("tile",))

def f(x):
    return jax.lax.psum(x, "tile")

out = jax.jit(shard_map(f, mesh=mesh, in_specs=P(), out_specs=P()))(
    jnp.ones((4,)) * (pid + 1)
)
import numpy as np
total = np.asarray(out)
# psum over shards: process 0 holds 1s, process 1 holds... in_specs=P()
# replicates the local value; psum sums across the 2 devices.
# Device k holds (pid_k + 1); psum over num devices = 1 + 2 + ... + num.
expected = float(sum(range(1, num + 1)))
assert (total == expected).all(), f"psum {total} != {expected}"
print("PSUM_OK", total[0], flush=True)
"""


_CHILD_RENDER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
coordinator, num, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
jax.distributed.initialize(coordinator_address=coordinator,
                           num_processes=num, process_id=pid)
import numpy as np
from tpurt.config import RenderConfig
from tpurt.scene.presets import default_scene
from tpurt.render.renderer import render_frame
from tpurt.parallel import make_mesh, render_frame_sharded

devs = jax.devices()
assert len(devs) == 2 * num, f"global devices {len(devs)} != {2 * num}"
cfg = RenderConfig(width=16, height=16, rays_per_pixel=2, max_bounces=2,
                   tile_size=16, object_path="sphere0.obj",
                   rays_per_batch=256, compaction_threshold=0)
scene, cam, _ = default_scene(cfg)
single = render_frame(scene, cam, cfg)  # local, no collectives
mesh = make_mesh(tile_devices=len(devs), devices=devs)
stats = {}
sharded = render_frame_sharded(scene, cam, cfg, mesh=mesh, stats=stats)
assert sharded.shape == single.shape, (sharded.shape, single.shape)
assert np.array_equal(single, sharded), (
    "cross-process sharded render differs: max abs diff "
    f"{np.abs(single - sharded).max()}"
)
assert stats["segments"] > 0
print("RENDER_OK", float(sharded.sum()), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(300)
def test_two_process_dcn_psum(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one CPU device per process
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD, coord, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost smoke timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"child failed:\n{out}\n{err[-2000:]}"
        assert "PSUM_OK" in out, out


@pytest.mark.timeout(1200)
def test_two_process_dcn_sharded_render():
    """The full multi-host story: two real processes (2 CPU devices each) form
    a 4-device global mesh and run render_frame_sharded through the
    megakernel flat path — output all_gathered over the tile axis so
    every host holds the frame — bitwise vs the single-chip render
    (seeds are pure functions of absolute pixel index, so process
    decomposition must change nothing)."""
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CHILD_RENDER, coord, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=1100)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost sharded render timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"child failed:\n{out}\n{err[-2000:]}"
        assert "RENDER_OK" in out, out
