"""Dataset layer: loaders and the synthetic generator (numpy only).

Counterpart of the JAX package's ``data/datasets.py``: the same published
dataset profiles, the same power-law / community generator (same numpy
random stream, so the same seed gives the same graph), and the same
``.npz`` format.  The checked-in real-graph fixtures (Zachary's karate
club and the handwritten-digits 8-NN graph) live in this package's own
``data/fixtures/``, byte for byte the JAX package's copies.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..graph import HostGraph, build_host_graph

# name: (n_node, n_edge, n_feat, n_class)
DATASET_STATS = {
    "cora": (2708, 10556, 1433, 7),
    "citeseer": (3327, 9104, 3703, 6),
    "pubmed": (19717, 88648, 500, 3),
    "flickr": (89250, 899756, 500, 7),
    "reddit": (232965, 114615892, 602, 41),
    # small synthetic profile for fast tests
    "tiny": (200, 900, 32, 4),
}

FIXTURES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")


@dataclasses.dataclass
class Dataset:
    name: str
    host_graph: HostGraph
    x: np.ndarray            # [N, F] float32 node features
    y: np.ndarray            # [N] int32 labels
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    n_class: int
    synthetic: bool = True


def synthetic_coo(n_node: int, n_edge: int, seed: int = 0, alpha: float = 0.8,
                  communities: int = 0, p_in: float = 0.7,
                  sender_alpha: float = 0.0):
    """Power-law COO edge list without self loops (multi-edges possible).

    ``communities`` > 0 plants that many communities and draws ``p_in`` of
    the edges within the receiver's community; the return is then
    (senders, receivers, community_of_node).  ``sender_alpha`` > 0 draws
    cross-community senders from a zipf-like popularity."""
    rng = np.random.default_rng(seed)
    p = (np.arange(1, n_node + 1, dtype=np.float64)) ** (-alpha)
    p /= p.sum()
    perm = rng.permutation(n_node)
    receivers = perm[rng.choice(n_node, size=n_edge, p=p)]
    if communities > 0:
        com_of = rng.integers(0, communities, size=n_node)
        order = np.argsort(com_of, kind="stable")
        starts = np.searchsorted(com_of[order], np.arange(communities + 1))
        sizes = np.diff(starts)
        intra = rng.random(n_edge) < p_in
        rc = com_of[receivers]
        off = (rng.random(n_edge) * np.maximum(sizes[rc], 1)).astype(np.int64)
        if sender_alpha > 0:
            ps = (np.arange(1, n_node + 1, dtype=np.float64)
                  ) ** (-sender_alpha)
            ps /= ps.sum()
            perm_s = rng.permutation(n_node)
            cross = perm_s[rng.choice(n_node, size=n_edge, p=ps)]
        else:
            cross = rng.integers(0, n_node, size=n_edge)
        senders = np.where(intra, order[starts[rc] + off], cross)
    else:
        senders = rng.integers(0, n_node, size=n_edge)
    keep = senders != receivers
    senders, receivers = senders[keep], receivers[keep]
    if communities > 0:
        return senders.astype(np.int32), receivers.astype(np.int32), com_of
    return senders.astype(np.int32), receivers.astype(np.int32)


def _planted_labels(rng, n_node, n_class, n_feat):
    """Features correlated with planted labels, so training on synthetic
    data is a meaningful convergence test."""
    y = rng.integers(0, n_class, size=n_node).astype(np.int32)
    centers = rng.normal(0, 1.0, size=(n_class, n_feat)).astype(np.float32)
    x = centers[y] + rng.normal(0, 2.0, size=(n_node, n_feat)).astype(
        np.float32)
    return x.astype(np.float32), y


def load_dataset(
    name: str,
    root: Optional[str] = None,
    *,
    seed: int = 0,
    add_self_loops: bool = True,
    symmetric_norm: bool = True,
    edge_pad_multiple: int = 512,
) -> Dataset:
    """``<root>/<name>.npz`` or a checked-in fixture when present (keys:
    senders, receivers, x, y, train_mask, val_mask, test_mask), else a
    synthetic graph with the published counts (``synthetic=True``)."""
    name = name.lower()
    path = os.path.join(root, f"{name}.npz") if root else None
    if not (path and os.path.exists(path)):
        fpath = os.path.join(FIXTURES_DIR, f"{name}.npz")
        if os.path.exists(fpath):
            path = fpath
    if path and os.path.exists(path):
        z = np.load(path)
        senders, receivers = z["senders"], z["receivers"]
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int32)
        n_node = x.shape[0]
        n_class = int(y.max()) + 1
        train_mask, val_mask, test_mask = (
            z["train_mask"], z["val_mask"], z["test_mask"])
        synthetic = False
    else:
        if name not in DATASET_STATS:
            raise ValueError(f"unknown dataset {name}")
        n_node, n_edge, n_feat, n_class = DATASET_STATS[name]
        senders, receivers = synthetic_coo(n_node, n_edge, seed)
        rng = np.random.default_rng(seed + 1)
        x, y = _planted_labels(rng, n_node, n_class, n_feat)
        idx = rng.permutation(n_node)
        n_tr = max(n_class * 20, n_node // 10)
        n_va = max(n_node // 10, 1)
        train_mask = np.zeros(n_node, bool)
        train_mask[idx[:n_tr]] = True
        val_mask = np.zeros(n_node, bool)
        val_mask[idx[n_tr:n_tr + n_va]] = True
        test_mask = np.zeros(n_node, bool)
        test_mask[idx[n_tr + n_va:]] = True
        synthetic = True

    g = build_host_graph(senders, receivers, n_node,
                         add_self_loops=add_self_loops,
                         symmetric_norm=symmetric_norm,
                         edge_pad_multiple=edge_pad_multiple)
    return Dataset(name=name, host_graph=g, x=x, y=y, train_mask=train_mask,
                   val_mask=val_mask, test_mask=test_mask, n_class=n_class,
                   synthetic=synthetic)
