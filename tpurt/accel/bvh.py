"""SAH BVH construction (host, numpy) + threaded flat layout.

Semantics follow the reference's top-down in-place builder
(src/readobj.hpp:96-267):

  * cost model       NodeCost = halfArea(size) * numTris          (readobj.hpp:119-122)
  * candidate splits 5 positions/axis x 3 axes at fractions
                     (i+1)/6 of the node bounds                   (readobj.hpp:142-163)
  * full-sweep SAH   each candidate grows vertex-tight child
                     boxes over every triangle                    (readobj.hpp:124-140)
  * partition        by centroid < splitPos                       (readobj.hpp:222-235)
  * stop             depth 0, <=2 tris, split cost >= parent
                     leaf cost, or a one-sided partition          (readobj.hpp:206-240)
  * layout           flat node array, children adjacent
                     (childIndex, childIndex+1)                   (readobj.hpp:243-259)

Differences (deliberate fixes, see SURVEY.md quirk ledger — none change
rendered images, which never depend on BVH shape):

  * empty-box bounds initialise to +/-inf, not CL_FLT_MAX/CL_FLT_MIN
    (the reference's positive-tiny max, readobj.hpp:16-17, inflates
    bounds of all-negative geometry);
  * empty split sides cost +inf explicitly (the reference relies on
    float overflow -> inf * 0 -> NaN comparing false, readobj.hpp:139);
  * the partition is stable (order within a side is preserved) instead
    of the two-pointer swap; membership is identical;
  * an unsplit root keeps childIndex = 0 (the reference stores a bogus
    nodeList.size()+1, readobj.hpp:349, which the GPUNode flattening
    would misread as a child pointer).

Instead of translating the reference's per-thread traversal stack
(Trace.cl:319-397), ``thread_links`` post-computes a stackless
depth-first threading: on AABB hit continue at the first child, on miss
(or after a leaf) continue at a skip link. Traversal then needs one
int32 cursor per ray — no scatter, no per-lane stack — which is what a
wide data-parallel lane loop wants.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

_NUM_TESTS_PER_AXIS = 5  # readobj.hpp:143


@dataclasses.dataclass
class BVHNodes:
    """Growable flat node arrays (host Node, readobj.hpp:20-25)."""

    bmin: list  # of (3,) float32
    bmax: list
    child: list  # first-child index; 0 = leaf
    first: list  # first triangle index
    ntris: list  # triangle count; 0 = internal

    @classmethod
    def empty(cls) -> "BVHNodes":
        return cls([], [], [], [], [])

    def __len__(self) -> int:
        return len(self.child)

    def append(self, bmin, bmax, child, first, ntris) -> int:
        self.bmin.append(np.asarray(bmin, np.float32))
        self.bmax.append(np.asarray(bmax, np.float32))
        self.child.append(int(child))
        self.first.append(int(first))
        self.ntris.append(int(ntris))
        return len(self.child) - 1

    def as_arrays(self):
        return (
            np.asarray(self.bmin, np.float32).reshape(len(self), 3),
            np.asarray(self.bmax, np.float32).reshape(len(self), 3),
            np.asarray(self.child, np.int64),
            np.asarray(self.first, np.int64),
            np.asarray(self.ntris, np.int64),
        )


def _node_cost(size: np.ndarray, num_tris: int) -> np.float32:
    """halfArea * numTris (readobj.hpp:119-122)."""
    sx, sy, sz = np.float32(size[0]), np.float32(size[1]), np.float32(size[2])
    half_area = sx * (sy + sz) + sy * sz
    return np.float32(half_area * np.float32(num_tris))


def _tri_bounds(verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """verts (n, 3, 3) -> vertex-tight (min(3,), max(3,))."""
    if verts.shape[0] == 0:
        return (
            np.full(3, np.inf, np.float32),
            np.full(3, -np.inf, np.float32),
        )
    return verts.min(axis=(0, 1)), verts.max(axis=(0, 1))


def _choose_split(
    pos: np.ndarray, bmin: np.ndarray, bmax: np.ndarray
) -> Tuple[int, float, float]:
    """ChooseSplitAxisAndPosition (readobj.hpp:142-163), vectorised.

    pos: (n, 3, 3) triangle vertices of the node. Evaluates all 15
    candidates; ties keep the earliest candidate in (axis-major,
    position-minor) order exactly like the reference's strict-< update.
    """
    n = pos.shape[0]
    centroids = (pos[:, 0] + pos[:, 1] + pos[:, 2]) / np.float32(3.0)

    best_cost = np.float32(np.finfo(np.float32).max)  # CL_FLT_MAX, readobj.hpp:144
    best_axis, best_pos = 0, np.float32(0.0)
    fractions = (np.arange(_NUM_TESTS_PER_AXIS, dtype=np.float32) + 1.0) / np.float32(
        _NUM_TESTS_PER_AXIS + 1.0
    )
    for axis in range(3):
        lo, hi = np.float32(bmin[axis]), np.float32(bmax[axis])
        for t in fractions:
            split = lo + (hi - lo) * t
            in_a = centroids[:, axis] < split
            na = int(in_a.sum())
            nb = n - na
            if na == 0 or nb == 0:
                continue  # empty side => +inf cost => never selected
            amin, amax = _tri_bounds(pos[in_a])
            bmin_b, bmax_b = _tri_bounds(pos[~in_a])
            cost = _node_cost(amax - amin, na) + _node_cost(bmax_b - bmin_b, nb)
            if cost < best_cost:
                best_cost, best_axis, best_pos = np.float32(cost), axis, split
    return best_axis, float(best_pos), float(best_cost)


def _split(
    nodes: BVHNodes,
    tri_pos: np.ndarray,
    tri_nrm: np.ndarray,
    parent: int,
    depth: int,
    leaf_cap: int = 0,
    aux: np.ndarray = None,
) -> None:
    """SplitBVH (readobj.hpp:206-267), stable-partition variant.

    ``leaf_cap`` > 0 additionally forces oversized leaves to split even
    when the SAH cost test declines (midpoint of the longest axis, then
    a median split if the midpoint degenerates). The reference has no
    cap — its cost cutoff can leave arbitrarily fat leaves — but the
    lane-parallel traversal wants a bound: leaf size feeds a masked per-lane loop
    and an 8-bit packed-node field. Image output never depends on BVH
    shape, only speed does.
    """
    n = nodes.ntris[parent]
    if depth == 0 or n <= 2:
        return
    f = nodes.first[parent]
    seg = tri_pos[f : f + n]

    axis, split_pos, cost = _choose_split(seg, nodes.bmin[parent], nodes.bmax[parent])
    parent_size = nodes.bmax[parent] - nodes.bmin[parent]
    forced = leaf_cap > 0 and n > leaf_cap
    if cost >= float(_node_cost(parent_size, n)) and not forced:
        return

    centroids = (seg[:, 0] + seg[:, 1] + seg[:, 2]) / np.float32(3.0)
    in_a = centroids[:, axis] < np.float32(split_pos)
    na = int(in_a.sum())
    if (na == 0 or na == n) and forced:
        # SAH declined or degenerated but the leaf is too fat: midpoint
        # of the longest axis, falling back to a median split.
        size = nodes.bmax[parent] - nodes.bmin[parent]
        axis = int(np.argmax(size))
        mid = np.float32(nodes.bmin[parent][axis] + size[axis] * 0.5)
        in_a = centroids[:, axis] < mid
        na = int(in_a.sum())
        if na == 0 or na == n:
            order_med = np.argsort(centroids[:, axis], kind="stable")
            in_a = np.zeros(n, bool)
            in_a[order_med[: n // 2]] = True
            na = n // 2
    if na == 0 or na == n:
        return

    order = np.concatenate([np.nonzero(in_a)[0], np.nonzero(~in_a)[0]])
    tri_pos[f : f + n] = seg[order]
    tri_nrm[f : f + n] = tri_nrm[f : f + n][order]
    if aux is not None:
        aux[f : f + n] = aux[f : f + n][order]

    amin, amax = _tri_bounds(tri_pos[f : f + na])
    bmin_b, bmax_b = _tri_bounds(tri_pos[f + na : f + n])

    child = len(nodes)
    nodes.child[parent] = child
    nodes.ntris[parent] = 0  # becomes internal (readobj.hpp:249)
    nodes.append(amin, amax, 0, f, na)
    nodes.append(bmin_b, bmax_b, 0, f + na, n - na)
    _split(nodes, tri_pos, tri_nrm, child, depth - 1, leaf_cap, aux)
    _split(nodes, tri_pos, tri_nrm, child + 1, depth - 1, leaf_cap, aux)


#: Default leaf-size cap: bounds the traversal's masked leaf loop (every
#: leaf-drain step pays max_leaf triangle-row gathers across ALL lanes,
#: so one fat leaf anywhere taxes the whole scene) and matches the two
#: inline triangle slots of the megakernel's fat node rows.
DEFAULT_LEAF_CAP = 2


def build_bvh(
    nodes: BVHNodes,
    tri_pos: np.ndarray,
    tri_nrm: np.ndarray,
    first_tri: int,
    num_tris: int,
    max_depth: int = 64,
    leaf_cap: int = DEFAULT_LEAF_CAP,
    aux: np.ndarray = None,
) -> int:
    """Build a BVH over tri_pos[first : first+num] in place; returns the
    root node index. max_depth=64 matches loadMeshFromOBJFile
    (readobj.hpp:367); quads use the SplitBVH default of 10
    (readobj.hpp:392, a no-op at 2 triangles). ``aux`` (optional, same
    length) is permuted alongside the triangles (e.g. owner-mesh ids)."""
    bmin, bmax = _tri_bounds(tri_pos[first_tri : first_tri + num_tris])
    root = nodes.append(bmin, bmax, 0, first_tri, num_tris)
    _split(nodes, tri_pos, tri_nrm, root, max_depth, leaf_cap, aux)
    return root


def thread_links(
    child: np.ndarray, ntris: np.ndarray, roots
) -> Tuple[np.ndarray, np.ndarray]:
    """Depth-first threading of every mesh subtree.

    Returns (hit, miss) int32 arrays: hit[n] = first child for internal
    nodes (unused for leaves); miss[n] = where to go on AABB miss or
    after leaf processing; -1 terminates.
    """
    m = len(child)
    hit = np.full(m, -1, np.int32)
    miss = np.full(m, -1, np.int32)
    for root in roots:
        stack = [(int(root), -1)]
        while stack:
            node, exit_to = stack.pop()
            miss[node] = exit_to
            if ntris[node] == 0:  # internal
                a = int(child[node])
                hit[node] = a
                stack.append((a + 1, exit_to))
                stack.append((a, a + 1))
    return hit, miss


def bvh_stats(nodes: BVHNodes, root: int) -> dict:
    """PrintDebugBVH equivalent (readobj.hpp:175-204): leaf count,
    internal count, average tris/leaf, max depth."""
    leaves = internals = 0
    tri_total = 0
    max_depth = 0
    stack = [(root, 1)]
    while stack:
        idx, depth = stack.pop()
        if nodes.ntris[idx] > 0:
            leaves += 1
            tri_total += nodes.ntris[idx]
            max_depth = max(max_depth, depth)
        else:
            internals += 1
            stack.append((nodes.child[idx], depth + 1))
            stack.append((nodes.child[idx] + 1, depth + 1))
    return {
        "leaf_count": leaves,
        "internal_count": internals,
        "avg_tris_per_leaf": tri_total / leaves if leaves else 0.0,
        "max_depth": max_depth,
        "max_leaf_tris": max(
            (nodes.ntris[i] for i in _subtree(nodes, root)), default=0
        ),
    }


def _subtree(nodes: BVHNodes, root: int):
    stack = [root]
    while stack:
        idx = stack.pop()
        yield idx
        if nodes.ntris[idx] == 0:
            stack.append(nodes.child[idx])
            stack.append(nodes.child[idx] + 1)


def validate_bvh(
    nodes: BVHNodes, root: int, first_tri: int, num_tris: int, tri_pos: np.ndarray
) -> None:
    """Structural invariants used by the test suite: every triangle of
    the range lands in exactly one leaf; child bounds nest in parents;
    siblings are adjacent; leaf bounds contain their triangles."""
    covered = np.zeros(num_tris, bool)
    stack = [root]
    while stack:
        idx = stack.pop()
        if nodes.ntris[idx] > 0:
            f, n = nodes.first[idx], nodes.ntris[idx]
            rel = np.arange(f - first_tri, f - first_tri + n)
            assert (rel >= 0).all() and (rel < num_tris).all(), "leaf outside range"
            assert not covered[rel].any(), "triangle in two leaves"
            covered[rel] = True
            verts = tri_pos[f : f + n]
            assert (verts.min(axis=(0, 1)) >= nodes.bmin[idx] - 1e-4).all()
            assert (verts.max(axis=(0, 1)) <= nodes.bmax[idx] + 1e-4).all()
        else:
            a = nodes.child[idx]
            for c in (a, a + 1):
                assert (nodes.bmin[c] >= nodes.bmin[idx] - 1e-4).all(), "child escapes"
                assert (nodes.bmax[c] <= nodes.bmax[idx] + 1e-4).all(), "child escapes"
            stack.append(a)
            stack.append(a + 1)
    assert covered.all(), "triangle in no leaf"
