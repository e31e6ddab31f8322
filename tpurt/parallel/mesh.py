"""Device-mesh construction and device inventory.

Replaces the reference's OpenCL platform/device discovery and the
user's comma-separated device pick (src/main.cpp:54-193) with a
jax.sharding.Mesh over the visible chips. Two logical axes:

  * ``tile``   — data parallelism over image row blocks (the analog of
                 the reference's multi-GPU tile work queue,
                 image.hpp:280-350, but static/SPMD: tiles are
                 near-uniform cost, so an even split already achieves
                 the queue's load-balancing goal with zero host
                 coordination);
  * ``sample`` — parallelism over the samples-per-pixel axis with a
                 psum of radiance (the direct analog of
                 sequence-sharding + reduce; requires the decorrelated
                 seed mode).

On several hosts, initialise jax.distributed first; the mesh then
spans all hosts.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def device_inventory() -> List[dict]:
    """The analog of the reference's startup device dump
    (main.cpp:79-140): one record per visible accelerator."""
    out = []
    for d in jax.devices():
        rec = {
            "id": d.id,
            "platform": d.platform,
            "kind": getattr(d, "device_kind", "?"),
            "process": d.process_index,
        }
        stats = d.memory_stats() or {}
        if "bytes_limit" in stats:
            rec["memory_gb"] = round(stats["bytes_limit"] / 2**30, 2)
        out.append(rec)
    return out


def select_devices(spec: Optional[str]):
    """Resolve a comma-separated device-id list (the reference's
    interactive pick, main.cpp:159-193) to device objects. ``None`` /
    "all" selects every visible device; bad ids raise ValueError with
    the valid set listed."""
    devices = jax.devices()
    if spec is None or str(spec).strip().lower() in ("", "all"):
        return devices
    by_id = {d.id: d for d in devices}
    picked = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            did = int(part)
        except ValueError:
            raise ValueError(
                f"device id {part!r} is not an integer; valid ids: "
                f"{sorted(by_id)}"
            )
        if did not in by_id:
            raise ValueError(
                f"no device with id {did}; valid ids: {sorted(by_id)}"
            )
        if by_id[did] in picked:
            raise ValueError(f"device id {did} given twice")
        picked.append(by_id[did])
    if not picked:
        raise ValueError("empty device list")
    return picked


def make_mesh(
    tile_devices: Optional[int] = None,
    sample_devices: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (tile, sample) mesh. Defaults to all visible devices on
    the tile axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if tile_devices is None:
        tile_devices = n // sample_devices
    if tile_devices * sample_devices != n:
        raise ValueError(
            f"{tile_devices} x {sample_devices} != {n} devices"
        )
    grid = np.asarray(devices).reshape(tile_devices, sample_devices)
    return Mesh(grid, (TILE_AXIS, SAMPLE_AXIS))


def mesh_info(mesh: Mesh) -> str:
    t, s = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    return f"mesh {t}x{s} (tile x sample) over {t * s} devices"
