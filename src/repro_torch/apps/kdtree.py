"""kD-tree — count points in a rectangle (Table III, 'fork').

Each query is a dataflow thread traversing a 2-D k-d tree; when the query
rectangle spans a split it *forks*, and the children re-enter the circulating
traversal loop (the dynamic-thread-spawning capability CUDA lacks, §VI-B(b)).
Leaf counts accumulate through atomics (hierarchy-less reduction, Fig. 9
discipline). The paper's 16-ary vectorized node layout (Fig. 11) is a machine
-width specialization; this is the binary-tree formulation of the same
traversal.
"""
from __future__ import annotations

import numpy as np

from .. import api as revet
from ..core.lang import select
from .common import App, make_app


class _Node:
    __slots__ = ("dim", "split", "left", "right", "start", "count")


def _build_tree(pts: np.ndarray, leaf_size: int = 8):
    """Median k-d tree; returns flat arrays + reordered points."""
    nodes = []
    order = []

    def rec(idx: np.ndarray, depth: int) -> int:
        nid = len(nodes)
        n = _Node()
        nodes.append(n)
        if len(idx) <= leaf_size:
            n.dim, n.split = 0, 0
            n.left = n.right = -1
            n.start = len(order)
            n.count = len(idx)
            order.extend(idx.tolist())
            return nid
        d = depth % 2
        srt = idx[np.argsort(pts[idx, d], kind="stable")]
        mid = len(srt) // 2
        n.dim = d
        n.split = int(pts[srt[mid], d])
        n.start = n.count = 0
        n.left = rec(srt[:mid], depth + 1)
        n.right = rec(srt[mid:], depth + 1)
        return nid

    rec(np.arange(len(pts)), 0)
    arr = lambda f: np.array([getattr(n, f) for n in nodes], np.int64)
    return (arr("dim"), arr("split"), arr("left"), arr("right"),
            arr("start"), arr("count"), pts[np.array(order)])


@revet.program(name="kdtree",
               outputs={"results": lambda env: env["rects"] // 4})
def kdtree_program(m, node_dim, node_split, node_left, node_right,
                   node_start, node_count, px, py, rects, results, *, count):
    with m.foreach(count) as (b, q):
        x0 = b.let(b.dram_load(rects, q * 4 + 0))
        x1 = b.let(b.dram_load(rects, q * 4 + 1))
        y0 = b.let(b.dram_load(rects, q * 4 + 2))
        y1 = b.let(b.dram_load(rects, q * 4 + 3))
        node = b.let(0, "node")
        with b.while_(b.let(1) == 1) as w:
            nl = w.let(w.dram_load(node_left, node))
            with w.if_(nl < 0) as leaf:
                st = leaf.let(leaf.dram_load(node_start, node))
                nc = leaf.let(leaf.dram_load(node_count, node))
                j = leaf.let(0)
                local = leaf.let(0)
                with leaf.while_(j < nc) as scan:
                    pxv = scan.let(scan.dram_load(px, st + j))
                    pyv = scan.let(scan.dram_load(py, st + j))
                    inx = scan.let((pxv >= x0) & (pxv <= x1))
                    iny = scan.let((pyv >= y0) & (pyv <= y1))
                    scan.set(local, local + (inx & iny))
                    scan.set(j, j + 1)
                leaf.atomic_add(results, q, local)
                leaf.exit_()
            d = w.let(w.dram_load(node_dim, node))
            sp = w.let(w.dram_load(node_split, node))
            nr = w.let(w.dram_load(node_right, node))
            lo = w.let(select(d == 0, x0, y0))
            hi = w.let(select(d == 0, x1, y1))
            need_l = w.let(lo <= sp)
            need_r = w.let((hi >= sp))
            first = w.let(select(need_l, nl, nr))
            nkids = w.let(need_l + need_r)
            with w.fork(nkids) as (fb, k):
                fb.set(node, select(k == 0, first, nr))


def build(n_points: int = 512, n_queries: int = 16, coord_max: int = 1 << 14,
          seed: int = 0) -> App:
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, coord_max, size=(n_points, 2)).astype(np.int64)
    dim, split, left, right, start, count, opts = _build_tree(pts)

    # queries sized to catch ~16 points each (paper's workload shape)
    half = int(coord_max * (16 / n_points) ** 0.5 / 2) + 1
    centers = rng.integers(half, coord_max - half, size=(n_queries, 2))
    rects = np.stack([centers[:, 0] - half, centers[:, 0] + half,
                      centers[:, 1] - half, centers[:, 1] + half], axis=1)

    expected = np.array([
        int(((pts[:, 0] >= r[0]) & (pts[:, 0] <= r[1]) &
             (pts[:, 1] >= r[2]) & (pts[:, 1] <= r[3])).sum())
        for r in rects])
    fetched = expected.sum() * 8  # Table III: size of fetched counted points

    return make_app(
        kdtree_program, name="kdtree",
        inputs={"node_dim": dim, "node_split": split, "node_left": left,
                "node_right": right, "node_start": start,
                "node_count": count, "px": opts[:, 0], "py": opts[:, 1],
                "rects": rects.reshape(-1)},
        params={"count": n_queries},
        expected={"results": expected},
        bytes_processed=int(fetched),
        meta={"threads": n_queries, "features": "fork, while, atomics"})
