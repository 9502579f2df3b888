"""PageRank + Transitive Closure (paper §6.2, Figs. 17–18) on IDataFrame.

PageRank follows the classic links.join(ranks) → contribs → reduceByKey
dataflow; TC is the fixed-point join/union/distinct loop of paper Fig. 6.
"""
from __future__ import annotations

import numpy as np
import torch


def make_graph(n_vertices: int = 64, n_edges: int = 256, seed: int = 0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges).astype(np.int32)
    dst = rng.integers(0, n_vertices, n_edges).astype(np.int32)
    keep = src != dst
    return np.stack([src[keep], dst[keep]], 1)


def pagerank(worker, edges: np.ndarray, iters: int = 5, damping: float = 0.85,
             fanout: int = 16):
    """edges: (E, 2). Returns {vertex: rank}. Uses join/reduceByKey/mapValues."""
    links = (
        worker.parallelize(edges)
        .map(lambda e: {"key": e[0], "value": e[1]})
        .cache()
    )
    verts = np.unique(edges)  # the sorted vertex list
    ranks = worker.parallelize(verts.astype(np.int32)).map(
        lambda v: {"key": v, "value": 1.0}
    )
    # out-degrees (static per graph)
    deg = links.map_values(lambda d: 1.0).reduce_by_key(
        lambda a, b: a + b, 0.0
    ).cache()

    base = worker.parallelize(verts.astype(np.int32)).map(
        lambda v: {"key": v, "value": 0.0}
    ).cache()

    for _ in range(iters):
        # (v, ((dst, deg), rank)) → contribs (dst, rank/deg)
        j = links.join(deg, max_matches=1)  # one degree entry per key
        jr = j.map(lambda r: {"key": r["key"],
                              "value": (r["value"][0], r["value"][1])}).join(
            ranks, max_matches=1  # one rank entry per key
        )
        contribs = jr.map(
            lambda r: {
                "key": r["value"][0][0],
                "value": r["value"][1] / torch.clamp_min(r["value"][0][1], 1.0),
            }
        )
        # union with zero base keeps vertices that received no contributions
        sums = contribs.union(base).reduce_by_key(lambda a, b: a + b, 0.0)
        ranks = sums.map_values(lambda s: (1 - damping) + damping * s)
    out = {}
    for r in ranks.collect():
        out[int(np.asarray(r["key"]))] = float(np.asarray(r["value"]))
    return out


def pagerank_reference(edges: np.ndarray, iters: int = 5, damping: float = 0.85):
    verts = sorted({int(v) for e in edges for v in e})
    ranks = {v: 1.0 for v in verts}
    out_deg = {}
    for s, d in edges:
        out_deg[int(s)] = out_deg.get(int(s), 0) + 1
    for _ in range(iters):
        sums = {v: 0.0 for v in verts}
        for s, d in edges:
            sums[int(d)] += ranks[int(s)] / out_deg[int(s)]
        ranks = {v: (1 - damping) + damping * sums[v] for v in verts}
    return ranks


def transitive_closure(worker, edges: np.ndarray, max_rounds: int = 10,
                       max_matches: int = 16):
    """Paper Fig. 6: grow paths until fixed point. Returns edge set."""
    tc = worker.parallelize(edges).map(lambda e: (e[0], e[1])).distinct().cache()
    # edges reversed for the join: (dst → src)
    rev = worker.parallelize(edges).map(
        lambda e: {"key": e[0], "value": e[1]}
    ).cache()
    old = 0
    new = tc.count()
    rounds = 0
    while new != old and rounds < max_rounds:
        old = new
        # paths (x, y) joined with edges (y, z) → (x, z)
        lhs = tc.map(lambda e: {"key": e[1], "value": e[0]})
        joined = lhs.join(rev, max_matches=max_matches)
        new_edges = joined.map(
            lambda r: (r["value"][0], r["value"][1])
        )
        # compact() bounds padded-capacity growth across fixed-point rounds
        tc = tc.union(new_edges).distinct().compact().cache()
        new = tc.count()
        rounds += 1
    return tc


def tc_reference(edges: np.ndarray, max_rounds: int = 10) -> set:
    es = {(int(a), int(b)) for a, b in edges}
    for _ in range(max_rounds):
        new = {(x, w) for (x, y) in es for (z, w) in es if y == z}
        if new <= es:
            break
        es |= new
    return es
