"""Predicted multi-card scaling efficiency.

Counterpart of the JAX package's ``parallel/scaling.py``.  A machine with
one card cannot measure scaling, but the prediction's inputs can be had:
the per-card edge rate of the sharded path, each plan's exchange bytes
(``comm_report``), the interconnect rates of ``hwconfig``
(``nvlink_gbps`` inside a node, ``nic_gbps`` across nodes: NVIDIA's
published H100 SXM figures, not measurements) and the share of the
collectives' windows that compute fills, read from a profiler trace by
``parallel/overlap.overlap_report``.

Model (per GNN layer, D cards):

  t_comp = (n_edge * balance / D) / edges_per_s_card
  t_ici  = per-card intra-node egress bytes / nvlink rate
  t_dcn  = per-node inter-node egress bytes / NIC rate
  t_comm = max(t_ici, t_dcn)                  (separate networks)
  t_step(ov) = ov * max(t_comp, t_comm) + (1 - ov) * (t_comp + t_comm)

  efficiency(ov) = (n_edge / edges_per_s_card) / (D * t_step(ov))

The key names (``ici``, ``dcn``) are the JAX package's: intra-node and
inter-node.  Both bounds (ov = 0 and 1) are reported beside the value at
the given overlap.
"""
from __future__ import annotations

from typing import Optional

from ..hwconfig import HwConfig, load_hw_config


def overlap_fraction(report: dict) -> float:
    """The share of the collectives' windows that compute fills, from an
    ``overlap_report``: the compute inside the windows over the windows'
    own span (both as unions of intervals), 0.0 when there is no window.
    (The JAX package divides the hidden compute by itself, so its
    fraction is always 0 or 1.)"""
    span = float(report.get("window_us", 0.0))
    if span <= 0:
        return 0.0
    return float(report.get("hidden_us", 0.0)) / span


def predicted_scaling(
    plan: dict,
    *,
    edges_per_s_chip: float,
    n_edge: int,
    overlap: float = 0.7,
    hw: Optional[HwConfig] = None,
) -> dict:
    """Predicted per-layer step time and scaling efficiency of one
    partition plan.

    ``plan``: a ``comm_report`` dict plus its shape: 1-D (one node, D
    cards over NVLink): ``n_shards``, ``halo_bytes``, ``hub_bytes``
    (optional), ``edge_balance`` (optional); 2-D (nodes x cards):
    ``mesh`` [Dh, Dc], ``ici_bytes``, ``dcn_bytes``, ``edge_balance``
    (optional).  ``edges_per_s_chip``: the measured per-card edge rate.
    ``overlap``: the share of communication hidden under compute
    (:func:`overlap_fraction` of a traced step).  Returns t_comp / t_ici /
    t_dcn (s) and the efficiency at ``overlap`` and at both bounds."""
    hw = hw or load_hw_config()
    balance = float(plan.get("edge_balance", 1.0))
    if "mesh" in plan:
        dh, dc = (int(v) for v in plan["mesh"])
        d = dh * dc
        t_ici = (float(plan.get("ici_bytes", 0.0)) / d) / (
            hw.nvlink_gbps * 1e9)
        # the NIC is per node in this model: each node's inter-node bytes
        t_dcn = (float(plan.get("dcn_bytes", 0.0)) / dh) / (
            hw.nic_gbps * 1e9)
    else:
        d = int(plan["n_shards"])
        ici_bytes = float(plan.get("halo_bytes", 0.0)) + float(
            plan.get("hub_bytes", 0.0))
        t_ici = (ici_bytes / d) / (hw.nvlink_gbps * 1e9)
        t_dcn = 0.0
    t_comp = (n_edge * balance / d) / edges_per_s_chip
    t_comm = max(t_ici, t_dcn)

    def step(ov: float) -> float:
        return ov * max(t_comp, t_comm) + (1.0 - ov) * (t_comp + t_comm)

    t1 = n_edge / edges_per_s_chip

    def eff(ov: float) -> float:
        return t1 / (d * step(ov))

    return dict(
        n_chips=d,
        t_comp_s=t_comp,
        t_ici_s=t_ici,
        t_dcn_s=t_dcn,
        overlap=overlap,
        t_step_s=step(overlap),
        efficiency=eff(overlap),
        efficiency_no_overlap=eff(0.0),
        efficiency_full_overlap=eff(1.0),
        comm_bound=t_comm > t_comp,
    )
