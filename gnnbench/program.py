"""The system under test: the PyTorch and CUDA port, driven through its
normal path.  The only module of the benchmark that imports the port.

Set-up is what a user of the port runs: ``graph.build_host_graph`` (self
loops, symmetric normalisation), ``graph.reorder_nodes`` and
``Model.make_apply`` on the hybrid schedules of
``compiler.fusion.hybrid_schedules`` (with the transposed graph for
training), then ``models.train.make_train_step`` with the port's AdamW.
"""
from __future__ import annotations

import time
from typing import Dict, Mapping

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


class Program:
    """One configuration lowered on one device; ``timers`` holds the
    seconds of each set-up stage."""

    def __init__(self, cfg: Dict, device, train: bool):
        self.cfg, self.device, self.train = cfg, torch.device(device), train
        self.timers: Dict[str, float] = {}

    def build_library(self) -> None:
        """Build (first run in a checkout) or load the port's kernels."""
        if self.device.type != "cuda":
            return
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import _ext
        t0 = time.perf_counter()
        _ext.library()
        self.timers["library_s"] = time.perf_counter() - t0

    def build_graph(self, senders: torch.Tensor, receivers: torch.Tensor,
                    community: torch.Tensor) -> torch.Tensor:
        """The host graph and its device copy from the raw COO; returns
        the node permutation (perm[new id] = original id) on the device."""
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
        t0 = time.perf_counter()
        n = self.cfg["nodes"]
        hg = G.build_host_graph(senders.cpu().numpy(),
                                receivers.cpu().numpy(), n,
                                add_self_loops=True, symmetric_norm=True)
        hg, perm = G.reorder_nodes(hg, self.cfg["reorder_nodes"],
                                   labels=community.cpu().numpy())
        self.hg, self.g = hg, hg.to_device(self.device)
        self.timers["graph_s"] = time.perf_counter() - t0
        return torch.as_tensor(perm, device=self.device)

    def lower(self) -> None:
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import hybrid_schedules
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
        cfg = self.cfg
        t0 = time.perf_counter()
        self.model = build_model(
            cfg["network"], cfg["features"], cfg["classes"],
            hidden=cfg["hidden"], n_layers=cfg["layers"],
            heads=cfg.get("heads", 1), reorder=cfg["transform_first"],
            generator=torch.Generator().manual_seed(0), device=self.device)
        sched = hybrid_schedules(self.model.layers)
        self.apply = self.model.make_apply(
            DTYPES[cfg["dtype"]], schedules=sched, host_graph=self.hg,
            device=self.device, build_transpose=self.train)
        if self.train:
            self.step_fn = TT.make_train_step(self.apply)
        self.timers["lower_s"] = time.perf_counter() - t0

    def load(self, weights: Mapping[str, torch.Tensor]) -> None:
        """Hand the benchmark's weights to the model."""
        have = {k: tuple(p.shape) for k, p in self.model.params.items()}
        want = {k: tuple(w.shape) for k, w in weights.items()}
        if have != want:
            raise ValueError(f"the port's parameters {have} are not the "
                             f"reference's {want}")
        self.model.load_params(weights)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.params)

    def new_state(self):
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
        opt = self.cfg["optimizer"]
        return TT.TrainState(self.model.params,
                             TT.adamw(self.model.params, opt["lr"],
                                      opt["weight_decay"]))

    def serve(self, params, x: torch.Tensor) -> torch.Tensor:
        """One request: the logits of every node."""
        return self.apply(params, self.g, x)

    def step(self, state, x, y, mask):
        """One full-batch training step; returns (state, loss)."""
        return self.step_fn(state, self.g, x, y, mask)

    @staticmethod
    def first_gradient(state) -> Dict[str, torch.Tensor]:
        """The gradient of each parameter as AdamW received it in its first
        step, from its first moment: (1 - beta1) g."""
        opt = state.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        out = {}
        for k, p in state.params.items():
            st = opt.state.get(p, {})
            m = st.get("exp_avg")
            out[k] = (m / (1.0 - b1) if m is not None
                      else torch.zeros_like(p)).detach().clone()
        return out

    def free(self) -> None:
        for k in ("apply", "step_fn", "model", "g", "hg"):
            self.__dict__.pop(k, None)
