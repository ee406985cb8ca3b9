"""PyTorch port: the span and counter recorder (``utils/spans.py``) and
the spans at the port's layer boundaries, on the CPU.

Off, nothing is recorded and no ``user_annotation`` reaches a profiler
trace; on, spans nest by parent and unit (a request or a step), also
across autograd's thread; inside ``utils/profile.trace`` each span is a
``user_annotation`` event on the recorder's clock; ``lower.split``'s
counters equal the splits' own counts; a training step records its
forward, backward and optimizer phases once each, and a GAT step's
kernel backward counts ``gat_bwd.shared``."""
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.datasets import synthetic_coo  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import profile as TP  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import spans as SP  # noqa: E402

CPU = "cpu"
N, E, F_IN, HIDDEN, N_CLASS = 600, 5000, 24, 32, 5
SPMM_TILE = TS.TileConfig(block_rows=128, block_cols=128, tile_edges=128,
                          path=TS.PATH_HYBRID, dense_block=128)
GAT_TILE = TS.TileConfig(block_rows=128, block_cols=256, tile_edges=128,
                         path=TS.PATH_HYBRID, dense_block=128)


@pytest.fixture(autouse=True)
def _clean():
    SP.take()
    yield
    SP.take()


@pytest.fixture(scope="module")
def host_graph():
    s, r, labels = synthetic_coo(N, E, seed=1, communities=6, p_in=0.8)
    hg = TG.build_host_graph(s, r, N, add_self_loops=True,
                             symmetric_norm=True)
    return TG.reorder_nodes(hg, "hubs+labels", labels=labels)[0]


def _lowered(net, hg, build_transpose):
    m = build_model(net, F_IN, N_CLASS, hidden=HIDDEN, n_layers=2,
                    heads=2, reorder=(net == "GCN"),
                    generator=torch.Generator().manual_seed(0), device=CPU)
    sched = TF.hybrid_schedules(m.layers, spmm_tile=SPMM_TILE,
                                gat_tile=GAT_TILE)
    fwd = m.make_apply(None, schedules=sched, host_graph=hg, device=CPU,
                       build_transpose=build_transpose)
    return m, fwd


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_emits_no_annotation(tmp_path):
    assert SP.span("a") is SP.span("b")      # one shared object, no clock
    with SP.span("model.forward"):
        SP.count("n", 3)
    assert SP.take() == {"spans": [], "counters": {}}
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with SP.span("lower.split"):
        torch.ones(4).add_(1)
    prof.stop()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert not [e for e in events if e.get("cat") == "user_annotation"]
    assert SP.take()["spans"] == []


def test_on_nests_parents_units_and_counters():
    with SP.recording():
        for _ in range(2):
            with SP.span("model.forward"):
                with SP.span("model.layer0"):
                    with SP.span("block.spmm_hybrid"):
                        SP.count("edges", 5)
                        SP.count("edges", 2)
        with SP.span("lower.layer"):
            pass
        SP.count("loose", 1.5)
    got = SP.take()
    sp = _by_name(got["spans"])
    assert [len(sp[k]) for k in ("model.forward", "model.layer0",
                                 "block.spmm_hybrid", "lower.layer")] == [
        2, 1 * 2, 2, 1]
    for fwd, layer, blk in zip(sp["model.forward"], sp["model.layer0"],
                               sp["block.spmm_hybrid"]):
        assert fwd["parent"] is None and fwd["unit"] == fwd["id"]
        assert layer["parent"] == fwd["id"] and layer["unit"] == fwd["id"]
        assert blk["parent"] == layer["id"] and blk["unit"] == fwd["id"]
        assert blk["counters"] == {"edges": 7}
        assert fwd["start_ns"] <= layer["start_ns"] <= blk["start_ns"]
        assert blk["end_ns"] <= layer["end_ns"] <= fwd["end_ns"]
        assert fwd["tid"] == threading.get_native_id()
    assert sp["model.forward"][0]["id"] != sp["model.forward"][1]["id"]
    assert sp["lower.layer"][0]["unit"] is None
    assert got["counters"] == {"loose": 1.5}
    assert SP.take() == {"spans": [], "counters": {}}


def test_a_second_thread_takes_the_open_backward_as_parent():
    seen = {}

    def autograd_like(key):
        with SP.span("bwd.spmm_hybrid"):
            seen[key] = threading.get_native_id()

    with SP.recording():
        with SP.span("train.step"):
            with SP.span("train.backward"):
                t = threading.Thread(target=autograd_like, args=("in",))
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        t = threading.Thread(target=autograd_like, args=("out",))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    sp = _by_name(SP.take()["spans"])
    step, bwd = sp["train.step"][0], sp["train.backward"][0]
    inside, outside = sp["bwd.spmm_hybrid"]
    assert bwd["parent"] == step["id"] and bwd["unit"] == step["id"]
    assert inside["parent"] == bwd["id"] and inside["unit"] == step["id"]
    assert inside["tid"] == seen["in"] != step["tid"]
    assert outside["parent"] is None and outside["unit"] is None


def test_recording_nests_and_restores():
    with SP.recording():
        with SP.recording():
            pass
        with SP.span("a"):
            pass
    with SP.span("b"):
        pass
    assert [s["name"] for s in SP.take()["spans"]] == ["a"]


def test_spanned_keeps_the_function():
    assert TG.build_host_graph.__name__ == "build_host_graph"
    assert "sorted, padded" in TG.build_host_graph.__doc__
    assert TF.lower_schedule.__wrapped__.__name__ == "lower_schedule"


def test_spans_land_in_a_profile_trace_on_the_same_clock(tmp_path):
    with TP.trace(str(tmp_path)):
        with SP.span("model.forward"):
            with SP.span("model.layer0"):
                torch.ones(64).mul_(2)
            time.sleep(0.002)
    rec = SP.take()["spans"]
    (path,) = Path(tmp_path).glob("trace_*.json")
    data = json.loads(path.read_text())
    base = data["baseTimeNanoseconds"]
    ann = {e["name"]: e for e in data["traceEvents"]
           if e.get("cat") == "user_annotation"}
    assert {s["name"] for s in rec} <= set(ann)
    for s in rec:
        e = ann[s["name"]]
        assert abs(e["ts"] * 1e3 + base - s["start_ns"]) < 2e6
        assert abs(e["dur"] * 1e3 - (s["end_ns"] - s["start_ns"])) < 2e6


def test_graph_spans_nest_the_rebuild_in_the_reorder():
    s, r, labels = synthetic_coo(200, 1500, seed=2, communities=4)
    with SP.recording():
        hg = TG.build_host_graph(s, r, 200, add_self_loops=True,
                                 symmetric_norm=True)
        hg, _ = TG.reorder_nodes(hg, "hubs+labels", labels=labels)
        hg.to_device(CPU)
    sp = _by_name(SP.take()["spans"])
    assert len(sp["graph.reorder_nodes"]) == 1
    assert len(sp["graph.to_device"]) == 1
    outer, inner = sorted(sp["graph.build_host_graph"],
                          key=lambda x: x["start_ns"])
    assert outer["parent"] is None
    assert inner["parent"] == sp["graph.reorder_nodes"][0]["id"]


@pytest.mark.parametrize("net", ["GCN", "GAT"])
def test_split_counters_are_the_splits_own(host_graph, net):
    with SP.recording():
        _, fwd = _lowered(net, host_graph, build_transpose=True)
    sp = _by_name(SP.take()["spans"])
    # one split per graph and geometry, shared by the layers that use it:
    # GCN's two layers share theirs, GAT's differ in heads
    splits = list({id(h): h for fn in fwd.layer_fns
                   for k, _, d, tw in fn.plans if k.endswith("_hybrid")
                   for h in (d, tw)}.values())
    assert len(sp["lower.layer"]) == 2
    assert len(sp["lower.transpose"]) == 1
    assert len(sp["lower.split"]) == len(sp["lower.threshold"]) == len(
        splits) == (2 if net == "GCN" else 4)
    assert len(sp.get("lower.scales", [])) == (2 if net == "GCN" else 0)
    layer_ids = {s["id"] for s in sp["lower.layer"]}
    got = sorted(tuple(s["counters"][k] for k in (
        "dense_blocks", "dense_edges", "tail_edges", "tail_tiles",
        "tail_slots")) for s in sp["lower.split"])
    want = sorted((0 if h.dense is None else h.dense.n_blocks,
                   h.n_dense_edges, h.n_sparse_edges, h.tiles.n_tiles,
                   h.tiles.n_tiles * h.tiles.tile_edges) for h in splits)
    assert got == want
    assert any(w[0] > 0 for w in want) and any(w[2] > 0 for w in want)
    for s in sp["lower.split"]:
        assert s["parent"] in layer_ids and s["unit"] is None


@pytest.mark.parametrize("net", ["GCN", "GAT"])
def test_a_request_records_its_layers_and_blocks(host_graph, net):
    m, fwd = _lowered(net, host_graph, build_transpose=False)
    g = host_graph.to_device(CPU)
    x = torch.randn(N, F_IN, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode(), SP.recording():
        fwd(dict(m.params), g, x)
    sp = _by_name(SP.take()["spans"])
    (unit,) = sp["model.forward"]
    layers = sp["model.layer0"] + sp["model.layer1"]
    assert [s["parent"] for s in layers] == [unit["id"]] * 2
    want = sorted("block.op" if k == "xla" else f"block.{k}"
                  for fn in fwd.layer_fns for k, _, _, _ in fn.plans)
    blocks = [s for s in sum(sp.values(), []) if s["name"].startswith(
        "block.")]
    assert sorted(s["name"] for s in blocks) == want
    kind = "block.spmm_hybrid" if net == "GCN" else "block.gat_hybrid"
    assert kind in want and "block.op" in want
    layer_ids = {s["id"] for s in layers}
    assert all(s["parent"] in layer_ids and s["unit"] == unit["id"]
               for s in blocks)


@pytest.mark.parametrize("net", ["GCN", "GAT"])
def test_a_step_records_forward_backward_optimizer_once(host_graph, net):
    with SP.recording():
        m, fwd = _lowered(net, host_graph, build_transpose=True)
        state = TT.TrainState(m.params, TT.adamw(m.params, 0.01))
        step = TT.make_train_step(fwd)
        rng = np.random.default_rng(4)
        x = torch.tensor(rng.standard_normal((N, F_IN)).astype(np.float32))
        y = torch.tensor(rng.integers(0, N_CLASS, N))
        mask = torch.tensor(rng.random(N) < 0.8)
        SP.take()
        state, loss = step(state, host_graph.to_device(CPU), x, y, mask)
    assert np.isfinite(float(loss))
    sp = _by_name(SP.take()["spans"])
    (unit,) = sp["train.step"]
    assert unit["unit"] == unit["id"]
    for name in ("train.forward", "train.backward", "train.optimizer"):
        (ph,) = sp[name]
        assert ph["parent"] == unit["id"] and ph["unit"] == unit["id"]
    (fwd_span,) = sp["model.forward"]
    assert fwd_span["parent"] == sp["train.forward"][0]["id"]
    assert fwd_span["unit"] == unit["id"]
    bwd = sp["bwd.spmm_hybrid" if net == "GCN" else "bwd.gat_hybrid"]
    assert len(bwd) == 2
    assert all(s["parent"] == sp["train.backward"][0]["id"]
               and s["unit"] == unit["id"] for s in bwd)
    order = [sp[k][0]["start_ns"] for k in ("train.forward",
                                            "train.backward",
                                            "train.optimizer")]
    assert order == sorted(order)


@pytest.mark.parametrize("twin", [True, False])
def test_gat_backward_counts_the_shared_path(host_graph, twin):
    """``gat_bwd.shared`` counts 1 under each ``bwd.gat_hybrid`` of a GAT
    training step whose backward runs on the kernels over both shares (the
    lowering built the transposed twin), and is absent from the
    full-graph fallback (no twin)."""
    with SP.recording():
        m, fwd = _lowered("GAT", host_graph, build_transpose=twin)
        state = TT.TrainState(m.params, TT.adamw(m.params, 0.01))
        step = TT.make_train_step(fwd)
        rng = np.random.default_rng(5)
        x = torch.tensor(rng.standard_normal((N, F_IN)).astype(np.float32))
        y = torch.tensor(rng.integers(0, N_CLASS, N))
        mask = torch.tensor(rng.random(N) < 0.8)
        SP.take()
        step(state, host_graph.to_device(CPU), x, y, mask)
    bwd = _by_name(SP.take()["spans"])["bwd.gat_hybrid"]
    assert len(bwd) == 2
    for s in bwd:
        assert s["counters"] == ({"gat_bwd.shared": 1} if twin else {})


def test_adamw_records_its_construction():
    p = {"w": torch.nn.Parameter(torch.ones(3))}
    with SP.recording():
        opt = TT.adamw(p, 0.01)
    (s,) = SP.take()["spans"]
    assert s["name"] == "train.adamw_init" and s["end_ns"] >= s["start_ns"]
    assert isinstance(opt, torch.optim.AdamW)
