"""PyTorch port, the scaling prediction, overlap read from traces, and data
parallelism, on the CPU; one world of two gloo ranks serves the cases
that need processes.

``predicted_scaling`` equals the JAX package's given the same
interconnect rates (the port's ``nvlink_gbps`` / ``nic_gbps`` in place of
``ici_gbps`` / ``dcn_gbps``) and keeps its bounds and ordering;
``overlap_fraction`` divides the compute inside the communication
windows by the windows' own span, so a hand-built trace gives a
fraction strictly between 0 and 1 (JAX's divides the hidden compute by
itself); ``overlap_report`` reads gloo's ranges from a real trace.  In
the world: ``make_train_step(pmean_axis=group)`` against one process
averaging the two ranks' gradients; ``train_sampled_scan(mesh=group)``
against JAX's on a 2-device mesh, both on the numpy sampler;
``train_multihost``'s return value.  Without the world: ``cli train
--multihost`` as a world of one, and ``train_sampled_scan`` refusing a
gloo group on a card.

Tolerances: the prediction within 1e-12 relative; the data-parallel
step's loss and parameters within 1e-5 * max(1, max |ref|);
``train_sampled_scan``'s final loss within 1e-4 of JAX's (two epochs of
AdamW through different float32 sum orders) and its parameters within
1e-4 * max(1, max |jax|)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import native as JN  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.hwconfig import HwConfig as JHw  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models import train as JT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.parallel import scaling as JS  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.hwconfig import HwConfig, load_hw_config  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.parallel import multihost as TM  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.parallel.launch import launch  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.parallel.overlap import (  # noqa: E402
    overlap_compiler_options, overlap_report)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.parallel.scaling import (  # noqa: E402
    overlap_fraction, predicted_scaling)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils.shard_cases import run_cases  # noqa: E402

from conftest import small_graph  # noqa: E402

CPU = "cpu"
RATE = 1.2e9
E = 114_505_698
TOL = 1e-5
SCAN = dict(fanouts=(3, 3), batch_size=16, epochs=2, hidden=16)

PLANS = [dict(n_shards=8, halo_bytes=477e6, hub_bytes=13e6,
              edge_balance=1.02),
         dict(n_shards=4, halo_bytes=60e6),
         dict(mesh=[2, 4], ici_bytes=600e6, dcn_bytes=67e6),
         dict(mesh=[4, 8], ici_bytes=2e9, dcn_bytes=9e8, edge_balance=1.1)]


def _close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(port - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("plan", PLANS, ids=range(len(PLANS)))
@pytest.mark.parametrize("overlap", [0.0, 0.35, 1.0])
def test_predicted_scaling_equals_jax_at_equal_rates(plan, overlap):
    port = predicted_scaling(plan, edges_per_s_chip=RATE, n_edge=E,
                             overlap=overlap,
                             hw=HwConfig(nvlink_gbps=180.0, nic_gbps=25.0))
    ref = JS.predicted_scaling(plan, edges_per_s_chip=RATE, n_edge=E,
                               overlap=overlap, hw=JHw(ici_gbps=180.0,
                                                       dcn_gbps=25.0))
    assert port.keys() == ref.keys()
    for k, v in ref.items():
        assert port[k] == pytest.approx(v, rel=1e-12), k


def test_interconnect_defaults_are_the_h100_spec():
    hw = load_hw_config()
    assert (hw.nvlink_gbps, hw.nic_gbps) == (450.0, 50.0)
    r = predicted_scaling(PLANS[0], edges_per_s_chip=RATE, n_edge=E,
                          overlap=0.5)
    assert 0 < r["efficiency_no_overlap"] <= r["efficiency"] \
        <= r["efficiency_full_overlap"] <= 1.0 + 1e-9
    assert r["efficiency_full_overlap"] <= 1 / 1.02 + 1e-9
    assert r["t_ici_s"] == pytest.approx(490e6 / 8 / 450e9)


def test_slow_links_make_the_plan_comm_bound():
    r = predicted_scaling(dict(n_shards=8, halo_bytes=477e6),
                          edges_per_s_chip=RATE, n_edge=E, overlap=1.0,
                          hw=HwConfig(nvlink_gbps=0.5))
    assert r["comm_bound"] and r["efficiency"] < 0.8
    r = predicted_scaling(PLANS[2], edges_per_s_chip=RATE, n_edge=E,
                          overlap=0.0, hw=HwConfig(nic_gbps=0.05))
    assert r["t_dcn_s"] > r["t_ici_s"] and r["comm_bound"]


def _x(name, ts, dur, cat, tid=1):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": 0, "tid": tid}


def test_overlap_fraction_of_a_hand_built_trace():
    """Two gloo windows [0, 100] and [150, 250] (union 200 us), one NCCL
    kernel [500, 600]; compute kernels [20, 60], [90, 170], [300, 400]
    and [550, 580]: inside the windows 40 + 10 + 20 + 30 = 100 of 300."""
    trace = {"traceEvents": [
        _x("gloo:all_to_all", 0, 100, "user_annotation", 7),
        _x("gloo:all_gather", 150, 100, "user_annotation", 7),
        _x("ncclDevKernel_AllReduce_Sum_f32", 500, 100, "kernel", 9),
        _x("spmm_tiles_kernel", 20, 40, "kernel", 8),
        _x("gat_tiles_kernel", 90, 80, "kernel", 8),
        _x("index_add_kernel", 300, 100, "kernel", 8),
        _x("elementwise_kernel", 550, 30, "kernel", 8),
        _x("aten::mm", 0, 600, "cpu_op"),
        {"ph": "i", "name": "marker", "ts": 10},
    ]}
    rep = overlap_report(trace)
    assert rep["n_windows"] == 3
    assert [p["hidden_us"] for p in rep["pairs"]] == [50.0, 20.0, 30.0]
    assert rep["window_us"] == 300.0 and rep["hidden_us"] == 100.0
    f = overlap_fraction(rep)
    assert 0.0 < f < 1.0 and f == pytest.approx(1 / 3)
    assert overlap_fraction({"pairs": []}) == 0.0
    # the JAX package's fraction of its own report is hidden / hidden
    assert JS.overlap_fraction({"pairs": [{"overlapped_est_cycles": 100}],
                                "overlapped_cycles": 100}) == 1.0


def test_overlap_report_reads_a_trace_file(tmp_path):
    trace = {"traceEvents": [_x("gloo:all_reduce", 0, 10, "user_annotation"),
                             _x("k", 5, 20, "kernel")]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    assert overlap_fraction(overlap_report(str(path))) == pytest.approx(0.5)
    assert overlap_compiler_options() is None


def _dp_inputs():
    rng = np.random.default_rng(3)
    n, c = 60, 3
    s, r = small_graph(rng, n=n, e=300)
    hg = T.build_host_graph(s, r, n, symmetric_norm=True, add_self_loops=True)
    model = T.build_model("GCN", 8, c, hidden=8, n_layers=2, device=CPU,
                          generator=torch.Generator().manual_seed(2))
    params = {k: v.detach().numpy() for k, v in model.params.items()}
    xs = rng.normal(size=(2, n, 8)).astype(np.float32)
    ys = rng.integers(0, c, size=(2, n)).astype(np.int64)
    masks = rng.random((2, n)) < np.array([[0.3], [0.8]])
    return dict(layers=model.layers, graph=hg, params=params, xs=xs, ys=ys,
                masks=masks, steps=2)


def _jax_scan_params():
    ds = J.load_dataset("tiny")
    m = J.build_model("GraphSAGE", ds.x.shape[1], ds.n_class,
                      hidden=SCAN["hidden"], n_layers=len(SCAN["fanouts"]))
    return {k: np.asarray(v) for k, v in m.init(jax.random.key(0)).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    ds = T.load_dataset("tiny")
    model = T.build_model("GCN", ds.x.shape[1], ds.n_class, hidden=16,
                          n_layers=2, device=CPU)
    dp = _dp_inputs()
    cases = [
        dict(dp, name="dp_step", kind="dp_step"),
        dict(name="scan", kind="sampled_scan", dataset="tiny",
             kw=SCAN, params=_jax_scan_params(), numpy_sampler=True),
        dict(name="multihost", kind="multihost", dataset="tiny",
             mesh2d=(1, 2), kw=dict(hidden=32, epochs=4)),
        dict(name="trace", kind="trace", layers=model.layers,
             graph=ds.host_graph,
             params={k: v.detach().numpy() for k, v in model.params.items()},
             x=ds.x, trace_dir=str(tmp)),
    ]
    res = launch(run_cases, 2, backend="gloo", args=(cases,), device=CPU,
                 threads=1, tmp_dir=str(tmp))
    return res, dp


def test_pmean_axis_step_averages_the_ranks_gradients(world):
    """Each rank steps on its own batch; one process computing both
    ranks' gradients, averaging them and stepping AdamW gives the same
    loss and parameters."""
    res, dp = world
    p = T.params_from_numpy(dp["params"], CPU)
    for v in p.values():
        v.requires_grad_(True)
    opt = TT.adamw(p, 1e-2)
    fns = [T.lower(layer) for layer in dp["layers"]]

    def apply(params, g, x):
        for fn in fns:
            x = fn(params, g, x)
        return x

    g = dp["graph"].to_device(CPU)
    losses = []
    for _ in range(2):
        grads, ls = [], []
        for d in range(2):
            loss = TT.masked_cross_entropy(
                apply(p, g, torch.from_numpy(dp["xs"][d])),
                torch.from_numpy(dp["ys"][d]), torch.from_numpy(dp["masks"][d]))
            grads.append(torch.autograd.grad(loss, list(p.values())))
            ls.append(float(loss.detach()))
        for v, a, b in zip(p.values(), *grads):
            v.grad = (a + b) / 2
        opt.step()
        losses.append(sum(ls) / 2)
    for r in res:
        _close(r["dp_step"]["losses"], losses)
        for k, v in p.items():
            _close(r["dp_step"]["params"][k], v.detach().numpy())


def test_train_sampled_scan_mesh_matches_jax(world, monkeypatch):
    """Two epochs of data-parallel sampled training over two ranks
    against JAX's over a 2-device mesh from the same parameters; global
    step i feeds rank d its batch 2i + d in both."""
    res, _ = world
    monkeypatch.setattr(JN, "HAVE_NATIVE", False)
    ds = J.load_dataset("tiny")
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    st, fr, bd = JT.train_sampled_scan(ds, mesh=mesh, **SCAN)
    a, b = res
    assert a["scan"]["train_loss"] == b["scan"]["train_loss"]
    assert abs(a["scan"]["train_loss"] - fr.train_loss) <= 1e-4
    assert a["scan"]["steps_per_epoch"] == bd["steps_per_epoch"]
    assert a["scan"]["step"] == SCAN["epochs"] * bd["steps_per_epoch"] // 2
    for k, v in st.params.items():
        _close(a["scan"]["params"][k], np.asarray(v), 1e-4)
        np.testing.assert_array_equal(a["scan"]["params"][k],
                                      b["scan"]["params"][k])


def test_train_multihost_returns_final_loss_and_every_epoch(world):
    res, _ = world
    for d, r in enumerate(res):
        assert r["multihost"]["init"] == (d, 2)      # idempotent
        final, losses = r["multihost"]["result"]
        assert len(losses) == 4 and final == losses[-1]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert res[0]["multihost"]["result"] == res[1]["multihost"]["result"]


def test_train_multihost_refuses_zero_epochs():
    with pytest.raises(ValueError, match="epochs=0"):
        TM.train_multihost(T.load_dataset("tiny"), epochs=0, device=CPU)


def test_overlap_report_of_a_gloo_trace(world):
    """A traced sharded forward over gloo: the report finds gloo's
    collective ranges (the CPU run has no device kernel, so nothing is
    hidden)."""
    res, _ = world
    for r in res:
        rep = r["trace"]
        assert rep["n_windows"] >= 2
        assert {p["collective"] for p in rep["pairs"]} >= {
            "gloo:all_to_all", "gloo:all_gather"}
        assert rep["window_us"] > 0 and rep["hidden_us"] == 0.0
        assert overlap_fraction(rep) == 0.0


def test_pmean_axis_and_mesh_refuse_what_is_not_a_group():
    with pytest.raises(TypeError, match="process group"):
        TT.make_train_step(lambda p, g, x: x, pmean_axis="data")
    with pytest.raises(TypeError, match="process group"):
        TT.train_sampled_scan(T.load_dataset("tiny"), mesh=object(),
                              device=CPU)


def test_cli_train_multihost_world_of_one():
    """``cli train --multihost`` with neither a coordinator nor the env://
    variables trains as a world of one (its own process, so no process
    group is left in the test's); ``--coordinator`` needs ``--nprocs``
    and ``--procid``."""
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    out = subprocess.run(
        [sys.executable, "-m",
         "gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.cli",
         "train", "--dataset", "tiny", "--network", "GCN", "--multihost",
         "--device", "cpu", "--epochs", "3", "--f32", "--json"],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["multihost"] and res["processes"] == 1
    assert len(res["epoch_losses"]) == 3
    assert res["train_loss"] == res["epoch_losses"][-1]
    with pytest.raises(ValueError, match="num_processes"):
        TM.init_multihost("localhost:29500")


def test_train_sampled_scan_refuses_gloo_on_a_card(tmp_path, monkeypatch):
    """On a CUDA device the step is captured with its all-reduce, which
    gloo cannot do: a gloo group there raises, naming the reason, before
    any device work (the device is only named here: no card needed)."""
    import torch.distributed as dist
    monkeypatch.setattr(TT, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="cannot be captured"):
            TT.train_sampled_scan(T.load_dataset("tiny"),
                                  mesh=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
