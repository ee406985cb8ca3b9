"""PyTorch port: the schedule space and the autotuner (``compiler/
schedule.py``'s enumerator, traffic model, whole-layer partition, legality
with patterns and shared-memory rule; ``hwconfig.py``; ``tune/search.py``;
``cli tune``) against the JAX package where both define the function.  On
the CPU measured times mean nothing, so the tests hold the machinery: the
candidates, the pruning, the memo, the choice of the minimum."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as JS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune import search as JT  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import cli as TCLI  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import hwconfig as TH  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.tune import search as TT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import benchmark as TB  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
FAMILIES = ["GCN", "GAT", "SGC", "GraphSAGE", "GIN", "DGN", "PNA"]


def _graphs(network, reorder=False):
    kw = dict(heads=2, reorder=reorder)
    return (J.build_op_graph(network, 16, 8, **kw),
            T.build_op_graph(network, 16, 8, **kw))


def _palette_keys(pal):
    return [t.key() for t in pal]


@pytest.mark.parametrize("network", FAMILIES)
@pytest.mark.parametrize("reorder", [False, True])
def test_partitions_traffic_and_candidates_match_jax(network, reorder):
    gj, gt = _graphs(network, reorder)
    assert TS.enumerate_partitions(gt, limit=64) == JS.enumerate_partitions(
        gj, limit=64)
    assert TS.layer_partition(gt) == JS.layer_partition(gj)
    stats = dict(n_node=1000, n_edge=5000, e_pad=5120)
    parts = TS.enumerate_partitions(gt, limit=16) + [
        TS.singleton_partition(gt), TS.max_fusion_partition(gt)]
    for p in parts:
        assert TS.traffic_bytes(gt, p, TS.GraphStats(**stats)) == \
            JS.traffic_bytes(gj, p, JS.GraphStats(**stats))
        assert TS.partition_is_legal_with_patterns(gt, p) == \
            JS.partition_is_legal_with_patterns(gj, p)
    for fn in ("pattern_partition", "layer_partition", "pair_agg_partition"):
        p = getattr(TS, fn)(gt)
        if p is not None:
            assert TS.partition_is_legal_with_patterns(gt, p)
            assert JS.partition_is_legal_with_patterns(gj, p)
    # the port's palette is JAX's, the stream and densefull entries included
    assert _palette_keys(TT.TILE_PALETTE) == _palette_keys(JT.TILE_PALETTE)
    cj = JT._candidate_schedules(gj, 64, JT.TILE_PALETTE)
    ct = TT._candidate_schedules(gt, 64, TT.TILE_PALETTE)
    assert [c.key() for c in ct] == [c.key() for c in cj]


def test_illegal_partition_with_a_broken_pattern_block():
    """A block with a breakpoint edge is legal only when it matches a
    fused-kernel pattern exactly."""
    gj, gt = _graphs("GAT")
    chain = max(TS.pattern_partition(gt), key=len)
    bad = [list(chain[:-1]), [chain[-1]]] + [
        [o] for o in gt.topo_order() if o not in chain]
    assert TS.partition_is_legal_with_patterns(gt, bad) == \
        JS.partition_is_legal_with_patterns(gj, bad) is False


def test_memo_round_trip(tmp_path):
    p = str(tmp_path / "sub" / "m.csv")
    m = TT.Memo(p)
    m.put("k1", 1.5e-4)
    m.put("k2", 2.0)
    m2 = TT.Memo(p)
    assert m2.get("k1") == 1.5e-4 and m2.get("k2") == 2.0
    assert m2.get("nope") is None
    assert TT.Memo(None).get("k1") is None


def _tiny_gat():
    ds = T.load_dataset("tiny")
    gt = T.build_op_graph("GAT", ds.x.shape[1], 8, heads=2)
    params = T.init_params(gt, torch.Generator().manual_seed(0), device=CPU)
    x = torch.tensor(ds.x)
    return ds, gt, params, x


def test_autotune_picks_the_minimum_and_reads_its_memo(monkeypatch,
                                                       tmp_path):
    """Under a stubbed timer autotune returns the candidate with the least
    time (a whole-layer schedule here), memoises every measurement under
    the port's KERNEL_VERSION, and a second tune over the same memo
    measures nothing."""
    ds, gt, params, x = _tiny_gat()
    calls = []

    def fake(fn, params, g, x, **kw):
        kinds = {k for k, *_ in fn.plans}
        calls.append(kinds)
        return 1e-3 if "gat_layer" in kinds else 5e-3 + 1e-4 * len(calls)

    monkeypatch.setattr(TT, "time_layer_device", fake)
    memo = str(tmp_path / "memo.csv")
    res = TT.autotune(gt, ds.host_graph, params,
                      ds.host_graph.to_device(CPU), x, memo_path=memo,
                      device=CPU)
    assert len(calls) == len(res.trials) >= 3
    assert res.latency_s == 1e-3 == min(m.latency_s for m in res.trials)
    best_kinds = {TF.classify_block(gt, b, tc)[0]
                  for b, tc in zip(res.best.blocks, res.best.tiles)}
    assert "gat_layer" in best_kinds
    keys = list(TT.Memo(memo).data)
    assert len(keys) == len(calls)
    assert all(k.startswith(f"v{TF.KERNEL_VERSION}|{gt.name}|") for k in keys)
    n = len(calls)
    res2 = TT.autotune(gt, ds.host_graph, params,
                       ds.host_graph.to_device(CPU), x, memo_path=memo,
                       device=CPU)
    assert len(calls) == n
    assert res2.best == res.best and res2.latency_s == res.latency_s
    assert "best" in res.report() and res.pareto[0].latency_s == 1e-3


def test_autotune_raises_where_a_candidate_fails(monkeypatch, tmp_path):
    """A candidate that fails to lower or run fails the tune: it is not
    recorded as infinitely slow, as the JAX tuner records a rejection."""
    ds, gt, params, x = _tiny_gat()

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(TT, "time_layer_device", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        TT.autotune(gt, ds.host_graph, params, ds.host_graph.to_device(CPU),
                    x, memo_path=str(tmp_path / "m.csv"), device=CPU)
    assert not (tmp_path / "m.csv").exists()


def test_time_layer_device_on_cpu_is_a_host_time():
    calls = []

    def apply(p, g, x):
        calls.append(1)
        return x

    s = TB.time_layer_device(apply, {}, None, torch.zeros(2), iters=5,
                             warmup=1)
    assert s > 0 and len(calls) == 6
    s = TB.time_layer_device(apply, {}, None, torch.zeros(2), target_s=1e-4,
                             warmup=0)
    assert s > 0


def test_hw_config_file_and_smem_rule(tmp_path, monkeypatch):
    """The H100 template equals the defaults; a file overrides the budget
    and the palette (with a dense-block entry); the rule follows the
    kernels' own shared-memory requests: the dense attention backward
    needs more than a block may hold at width 602, and a tight budget
    refuses what the default admits."""
    monkeypatch.delenv("GTA_HW_CONFIG", raising=False)
    assert TH.load_hw_config(TH.DEFAULT_CONFIG) == TH.HwConfig()
    assert TH.HwConfig().smem_budget_bytes == 232_448
    assert TH.HwConfig().hbm_gbps == 3350.0
    p = tmp_path / "hw.json"
    p.write_text(json.dumps(dict(
        smem_budget_bytes=16 * 1024, hbm_gbps=100.0,
        tile_palette=[[128, 128, 256], [256, 256, 512, "hybrid", "d128"]])))
    cfg = TH.load_hw_config(str(p))
    assert cfg.smem_budget_bytes == 16 * 1024 and cfg.hbm_gbps == 100.0
    pal = cfg.palette()
    assert pal[0] == TS.TileConfig(128, 128, 256)
    assert pal[1] == TS.TileConfig(256, 256, 512, TS.PATH_HYBRID,
                                   dense_block=128)
    assert TH.HwConfig().palette() == TT.TILE_PALETTE
    hyb = TS.TileConfig(256, 256, 512, TS.PATH_HYBRID)
    onehot = TS.TileConfig(512, 1024, 512)
    assert TS.tile_is_feasible(hyb, 128, heads=4)
    assert not TS.tile_is_feasible(hyb, 602)
    assert TS.tile_is_feasible(hyb, 602, kind="spmm_hybrid")
    assert TS.tile_is_feasible(onehot, 128, heads=4, kind="gat_layer")
    assert not TS.tile_is_feasible(onehot, 128, 16 * 1024, heads=4,
                                   kind="gat_layer")
    # K1 requests none; K2's bf16 ring holds 3 stages of a 256 x 144 B
    # count tile and a 128-row x tile of 128 bf16 features, plus 1 KB of
    # alignment; its float32 path none
    assert TS.smem_bytes(onehot, 128, 4, kind="spmm") == 0
    assert TS.smem_bytes(hyb, 128, dtype_bytes=2, kind="spmm_hybrid") == (
        3 * (256 * 144 + 128 * 128 * 2) + 1024)
    assert TS.smem_bytes(hyb, 41, dtype_bytes=4, kind="spmm_hybrid") == 0
    assert not TS.tile_is_feasible(TS.TileConfig(32768, 128, 512), 16)
    # the stream and densefull paths run no kernel of their own
    assert TS.tile_is_feasible(TS.TileConfig(path=TS.PATH_DENSEFULL), 16)
    assert TS.smem_bytes(TS.TileConfig(path=TS.PATH_STREAM), 602, 4) == 0
    monkeypatch.setenv("GTA_HW_CONFIG", str(p))
    assert not TS.tile_is_feasible(onehot, 128, heads=4, kind="gat_layer")


def test_derived_palette_is_feasible():
    cfg = TH.HwConfig()
    pal = cfg.derived_palette(feat_width=128, dtype_bytes=2)
    onehot = [t for t in pal if t.path == TS.PATH_ONEHOT]
    mx = cfg.max_tile(128, dtype_bytes=2)
    assert onehot and any(t.block_rows == mx.block_rows for t in onehot)
    assert mx.block_rows < TS.LOCAL_INDEX_MAX
    for t in onehot:
        assert TS.tile_is_feasible(t, 128, dtype_bytes=2)
    assert [t for t in pal if t.path != TS.PATH_ONEHOT] == [
        t for t in cfg.palette() if t.path != TS.PATH_ONEHOT]
    # nothing fits a budget below one block's request: the static palette
    assert TH.HwConfig(smem_budget_bytes=1).derived_palette(
        128) == cfg.palette()


def test_cli_tune_stack_writes_a_schedule_run_and_train_read(tmp_path,
                                                             capsys):
    sched = tmp_path / "s.json"
    memo = tmp_path / "m.csv"
    rc = TCLI.main(["tune", "--dataset", "tiny", "--network", "GAT",
                    "--hidden", "16", "--heads", "2", "--stack", "--f32",
                    "--device", "cpu", "--memo", str(memo), "--schedule",
                    str(sched), "--target-s", "0.002", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["schedule_path"] == str(sched)
    assert memo.exists() and out["memo"] == str(memo)
    spec = json.loads(sched.read_text())
    assert len(spec["layers"]) == 2
    for layer in spec["layers"]:
        assert set(layer) == {"blocks", "tiles", "latency_us"}
        assert len(layer["blocks"]) == len(layer["tiles"])
    rc = TCLI.main(["run", "--dataset", "tiny", "--network", "GAT",
                    "--hidden", "16", "--heads", "2", "--f32", "--device",
                    "cpu", "--schedule", str(sched), "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["finite"] and out["out_shape"] == [200, 4]
    rc = TCLI.main(["train", "--dataset", "tiny", "--network", "GAT",
                    "--hidden", "16", "--heads", "2", "--f32", "--device",
                    "cpu", "--schedule", str(sched), "--epochs", "2",
                    "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and np.isfinite(out["train_loss"])


def test_cli_tune_single_layer_and_the_unported_options(tmp_path, capsys):
    rc = TCLI.main(["tune", "--dataset", "tiny", "--network", "GCN",
                    "--hidden", "8", "--f32", "--device", "cpu", "--memo",
                    str(tmp_path / "m.csv"), "--target-s", "0", "--iters",
                    "1", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["n_trials"] >= 2 and out["pareto"]
    TS.Schedule.from_key(out["best_schedule"])
    # the options that exited 2 until they were ported: the genetic tuner
    # on the same layer, and the compile-only pick
    rc = TCLI.main(["tune", "--dataset", "tiny", "--network", "GCN", "--ga",
                    "--hidden", "8", "--f32", "--device", "cpu", "--memo",
                    str(tmp_path / "m.csv"), "--target-s", "0", "--iters",
                    "1", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["search"] == "genetic" and out["n_trials"] >= 2
    TS.Schedule.from_key(out["best_schedule"])
    rc = TCLI.main(["run", "--compiled", "--dataset", "tiny", "--hidden", "8",
                    "--device", "cpu", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["finite"] and out["modelled_us"] > 0


def test_default_memo_path_stays_out_of_the_sources():
    path = TT.default_memo_path("GAT", "cora")
    assert "/build/tune/" in path.replace("\\", "/")
    assert "results" not in path
