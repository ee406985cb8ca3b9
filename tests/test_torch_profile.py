"""PyTorch port: ``utils/profile``'s cost reports and trace reader against
the JAX package's.

``op_report`` field by field and ``schedule_report`` character by
character equal to JAX's for the same op graph, partition and graph
statistics; ``trace`` over ``torch.profiler`` on the CPU, and
``trace_events`` / ``measured_report`` on hand-written Chrome traces
(plain and gzipped) with known counts, totals and order."""
import dataclasses
import gzip
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as JS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.builders import build_op_graph as j_build  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.utils import profile as JP  # noqa: E402

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.builders import build_op_graph as t_build  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import profile as TP  # noqa: E402

# (network, in width, out width, heads)
GRAPHS = [("GCN", 64, 32, 1), ("GAT", 16, 8, 2), ("GraphSAGE", 48, 24, 1),
          ("GIN", 40, 40, 1)]
PARTITIONS = ["singleton_partition", "max_fusion_partition",
              "aggregation_partition"]
# n_node, n_edge, e_pad: a Cora-sized graph and a small one
STATS = [(2708, 13264, 13312), (100, 500, 512)]


def _graphs(net, fin, fout, heads):
    kw = dict(heads=heads) if net == "GAT" else {}
    return j_build(net, fin, fout, **kw), t_build(net, fin, fout, **kw)


# every (graph, partition) where the JAX partition applies (the
# aggregation partition needs an SpMM chain: GAT has none)
CASES = [(g, part) for g in GRAPHS for part in PARTITIONS
         if getattr(JS, part)(_graphs(*g)[0]) is not None]


def test_partitions_apply_alike():
    for g in GRAPHS:
        jg, tg = _graphs(*g)
        for part in PARTITIONS:
            jb, tb = getattr(JS, part)(jg), getattr(TS, part)(tg)
            assert (jb is None) == (tb is None)
            if jb is not None:
                assert tuple(map(tuple, jb)) == tuple(map(tuple, tb))
    assert len(CASES) == len(GRAPHS) * len(PARTITIONS) - 1


@pytest.mark.parametrize("stats", STATS)
@pytest.mark.parametrize("g,part", CASES)
@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_op_report_equals_jax(g, part, stats, dtype_bytes):
    jg, tg = _graphs(*g)
    blocks = getattr(TS, part)(tg)
    js, ts = JS.GraphStats(*stats), TS.GraphStats(*stats)
    jc = JP.op_report(jg, blocks, js, dtype_bytes)
    tc = TP.op_report(tg, blocks, ts, dtype_bytes)
    assert [dataclasses.astuple(c) for c in tc] == [
        dataclasses.astuple(c) for c in jc]
    assert [f.name for f in dataclasses.fields(TP.OpCost)] == [
        f.name for f in dataclasses.fields(JP.OpCost)]
    # the accounting itself: an MM's FLOPs, and no bytes for a fused value
    for c in tc:
        op = tg.by_id[c.op_id]
        if op.compute == "MM":
            _, iw, ow = op.extra["weight"]
            rows = stats[0] if op.in_domain == "node" else stats[2]
            assert c.flops == 2 * rows * iw * ow
        assert (c.hbm_bytes == 0) == c.fused


@pytest.mark.parametrize("measured_s", [None, 1e-4, 2.5e-3])
@pytest.mark.parametrize("net,fin,fout,heads", GRAPHS)
def test_schedule_report_equals_jax(net, fin, fout, heads, measured_s):
    jg, tg = _graphs(net, fin, fout, heads)
    for stats in STATS:
        for dtype_bytes in (4, 2):
            for part in ("singleton_partition", "max_fusion_partition"):
                blocks = getattr(TS, part)(tg)
                js = JS.Schedule(blocks=blocks,
                                 tiles=(JS.TileConfig(),) * len(blocks))
                ts = TS.Schedule(blocks=blocks,
                                 tiles=(TS.TileConfig(),) * len(blocks))
                want = JP.schedule_report(jg, js, JS.GraphStats(*stats),
                                          measured_s, dtype_bytes)
                got = TP.schedule_report(tg, ts, TS.GraphStats(*stats),
                                         measured_s, dtype_bytes)
                assert got == want
                assert ("TFLOP/s" in got) == (measured_s is not None)


def test_trace_on_cpu_writes_and_reads(tmp_path):
    out = tmp_path / "tr"
    a = torch.randn(128, 128, generator=torch.Generator().manual_seed(0))
    with TP.trace(str(out)) as d:
        for _ in range(3):
            a = torch.mm(a, a) / 128.0
    assert d == str(out)
    files = list(out.rglob("*.json"))
    assert len(files) == 1
    evs = TP.trace_events(str(out))
    mm = [m for m in evs if m.name == "aten::mm"]
    assert len(mm) == 1 and mm[0].count == 3 and mm[0].total_us > 0
    assert [m.total_us for m in evs] == sorted(
        (m.total_us for m in evs), reverse=True)
    rep = TP.measured_report(str(out))
    assert "total_us" in rep and "aten::mm" in rep
    assert rep.splitlines()[0] == f"measured trace report ({out}):"


def _events(spec):
    """Complete events from (name, dur) pairs, plus events the reader
    must skip: other phases and a counter."""
    evs = [{"ph": "X", "name": n, "ts": i, "dur": d, "cat": "kernel"}
           for i, (n, d) in enumerate(spec)]
    evs += [{"ph": "B", "name": "skipped", "ts": 0},
            {"ph": "i", "name": "instant", "ts": 1, "dur": 999.0},
            {"ph": "C", "name": "counter", "ts": 2, "args": {"v": 1}}]
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def test_trace_events_on_written_traces(tmp_path):
    """A plain .json and a .json.gz in a subdirectory: counts, totals and
    the heaviest-first order exact, other files and phases ignored;
    equal to JAX's reader on the same gzipped file."""
    (tmp_path / "a.json").write_text(json.dumps(_events(
        [("k1", 10.0), ("k2", 1.5), ("k1", 2.0), ("k3", 100.0)])))
    sub = tmp_path / "plugins" / "profile" / "ts"
    sub.mkdir(parents=True)
    with gzip.open(sub / "b.trace.json.gz", "wt") as f:
        json.dump(_events([("k2", 4.0), ("k4", 0.25), ("k2", 30.0)]), f)
    (tmp_path / "notes.txt").write_text("not a trace")
    got = [(m.name, m.count, m.total_us)
           for m in TP.trace_events(str(tmp_path))]
    assert got == [("k3", 1, 100.0), ("k2", 3, 35.5), ("k1", 2, 12.0),
                   ("k4", 1, 0.25)]
    only_gz = [(m.name, m.count, m.total_us)
               for m in TP.trace_events(str(sub))]
    assert only_gz == [(m.name, m.count, m.total_us)
                       for m in JP.trace_events(str(sub))]
    rep = TP.measured_report(str(tmp_path), top=2).splitlines()
    assert rep[1].split() == ["total_us", "count", "name"]
    assert [r.split() for r in rep[2:]] == [["100.0", "1", "k3"],
                                            ["35.5", "3", "k2"]]
    assert TP.trace_events(str(tmp_path / "missing")) == []
