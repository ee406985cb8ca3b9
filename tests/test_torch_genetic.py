"""PyTorch port: the genetic tuner (``tune/genetic.py``) and ``cli tune
--ga`` against the JAX package.

Both tuners draw from ``random.Random(seed)`` in the same order, so with
the same palette and the same fitness they must walk the same genomes:
``decode`` and ``encode`` give equal schedules and genomes, and one
``search`` on each side, with ``_measure`` replaced by one deterministic
function of the schedule key, visits the same keys and returns the same
best.  On the CPU a measured time means nothing, so the port's own
``_measure`` is held to its contract (memo, shared-memory rule, a failure
raises) and the CLI to its output."""
import json
import random
import zlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune import genetic as JGen  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune import search as JT  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import cli as TCLI  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data import datasets as TDs  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.tune import genetic as TGen  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.tune import search as TT  # noqa: E402

CPU = "cpu"
CASES = [("GCN", 1, False), ("GAT", 4, False), ("GAT", 2, True),
         ("SGC", 1, False), ("GraphSAGE", 1, False), ("GIN", 1, False),
         ("DGN", 1, False), ("PNA", 1, True)]
IDS = [f"{n}-{h}{'-trans' if r else ''}" for n, h, r in CASES]


def _tuners(network, heads, reorder, seed=0, **kw):
    s, r = TDs.synthetic_coo(300, 1500, seed=2)
    hj = J.build_host_graph(s, r, 300, add_self_loops=True)
    ht = T.build_host_graph(s, r, 300, add_self_loops=True)
    gj = J.build_op_graph(network, 16, 8, heads=heads, reorder=reorder)
    gt = T.build_op_graph(network, 16, 8, heads=heads, reorder=reorder)
    tj = JGen.GeneticTuner(gj, hj, tile_palette=JT.TILE_PALETTE, seed=seed,
                           **kw)
    tt = TGen.GeneticTuner(gt, ht, tile_palette=TT.TILE_PALETTE, seed=seed,
                           device=CPU, **kw)
    return tj, tt


def _genome_pair(tj, rng):
    n, nt = len(tj.free), tj._n_tile_genes
    bits = tuple(rng.randint(0, 1) for _ in range(n))
    tiles = tuple(rng.randrange(len(tj.palette)) for _ in range(nt))
    kern, patt = rng.random() < 0.7, rng.random() < 0.5
    return (JGen.Genome(bits, tiles, kern, patt),
            TGen.Genome(bits, tiles, kern, patt))


@pytest.mark.parametrize("network,heads,reorder", CASES, ids=IDS)
def test_decode_encode_equal_jax(network, heads, reorder):
    tj, tt = _tuners(network, heads, reorder)
    assert tt.free == tj.free and tt._n_tile_genes == tj._n_tile_genes
    rng = random.Random(7)
    decoded = 0
    for _ in range(60):
        gj, gt = _genome_pair(tj, rng)
        sj, st = tj.decode(gj), tt.decode(gt)
        assert (sj is None) == (st is None)
        if sj is None:
            continue
        decoded += 1
        assert st.key() == sj.key()
        ej, et = tj.encode(sj), tt.encode(st)
        assert (et.bits, et.tile_idx, et.kernels, et.use_pattern) == (
            ej.bits, ej.tile_idx, ej.kernels, ej.use_pattern)
    assert decoded >= 10
    # the seeds (random ones included) are drawn in the same order
    assert [tuple(vars(g).values()) for g in tt._seeds()] == \
        [tuple(vars(g).values()) for g in tj._seeds()]


def _fake_latency(sched) -> float:
    return (zlib.crc32(sched.key().encode()) % 997 + 1) * 1e-6


@pytest.mark.parametrize("network,heads,reorder", CASES[:3] + CASES[-1:],
                         ids=IDS[:3] + IDS[-1:])
def test_search_walks_the_same_keys(network, heads, reorder):
    kw = dict(max_generations=6, stable_stop=3)
    tj, tt = _tuners(network, heads, reorder, seed=3, **kw)
    seen = {"jax": [], "port": []}

    def fake(side):
        def measure(sched, params, g_dev, x):
            seen[side].append(sched.key())
            return _fake_latency(sched)
        return measure

    tj._measure = fake("jax")
    tt._measure = fake("port")
    rj = tj.search(None, None, None)
    rt = tt.search(None, None, None)
    assert seen["port"] == seen["jax"] and len(seen["port"]) >= 5
    assert rt.best.key() == rj.best.key()
    assert rt.latency_s == rj.latency_s
    assert [m.schedule.key() for m in rt.trials] == \
        [m.schedule.key() for m in rj.trials]
    assert [m.traffic for m in rt.trials] == [m.traffic for m in rj.trials]


def test_warm_start_transfers_like_jax():
    """A tuned schedule of another layer seeds the search (encode of a
    foreign graph's schedule), as in JAX."""
    tj, tt = _tuners("GAT", 4, False)
    layer = T.build_model("GAT", 16, 8, hidden=16, heads=4,
                          device=CPU).layers[1]
    cand = TT._candidate_schedules(layer, 64, TT.TILE_PALETTE)[3]
    jc = JT._candidate_schedules(
        J.build_model("GAT", 16, 8, hidden=16, heads=4).layers[1], 64,
        JT.TILE_PALETTE)[3]
    assert cand.key() == jc.key()
    tj2 = JGen.GeneticTuner(tj.graph, tj.hg, tile_palette=JT.TILE_PALETTE,
                            warm_start=[jc])
    tt2 = TGen.GeneticTuner(tt.graph, tt.hg, tile_palette=TT.TILE_PALETTE,
                            warm_start=[cand], device=CPU)
    sj, st = tj2._seeds(), tt2._seeds()
    assert [tuple(vars(g).values()) for g in st] == \
        [tuple(vars(g).values()) for g in sj]
    assert len(st) == len(tt._seeds()) + 1


def test_measure_memo_feasibility_and_failure(tmp_path, monkeypatch):
    ds = T.load_dataset("tiny")
    hg = ds.host_graph
    g = T.build_op_graph("GCN", 32, 8)
    memo = str(tmp_path / "memo.csv")
    tuner = TGen.GeneticTuner(g, hg, tile_palette=TT.TILE_PALETTE,
                              memo_path=memo, iters=1, target_s=None,
                              device=CPU)
    params = T.init_params(g, torch.Generator().manual_seed(0), device=CPU)
    gd = hg.to_device(CPU)
    x = torch.randn(hg.n_node, 32, generator=torch.Generator().manual_seed(1))
    sched = TT._candidate_schedules(g, 64, TT.TILE_PALETTE)[1]
    lat = tuner._measure(sched, params, gd, x)
    assert lat > 0
    key = f"v{TF.KERNEL_VERSION}|{g.name}|{sched.key()}"
    assert TT.Memo(memo).get(key) == lat        # memoised under the key
    assert tuner._measure(sched, params, gd, x) == lat
    # the shared-memory rule: refused without lowering
    monkeypatch.setattr(TGen, "schedule_is_feasible", lambda *a: False)
    other = TT._candidate_schedules(g, 64, TT.TILE_PALETTE)[2]
    assert tuner._measure(other, params, gd, x) == float("inf")
    monkeypatch.undo()

    # a failing lowering raises (JAX records it as infinitely slow)
    def broken(*a, **k):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(TGen, "lower_schedule", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        tuner._measure(other, params, gd, x)


def test_search_on_the_cpu_two_generations():
    ds = T.load_dataset("tiny")
    hg = ds.host_graph
    g = T.build_op_graph("GAT", 32, 8, heads=2)
    tuner = TGen.GeneticTuner(g, hg, tile_palette=TT.TILE_PALETTE,
                              iters=1, target_s=None, max_generations=2,
                              device=CPU)
    params = T.init_params(g, torch.Generator().manual_seed(0), device=CPU)
    x = torch.randn(hg.n_node, 32, generator=torch.Generator().manual_seed(1))
    res = tuner.search(params, hg.to_device(CPU), x)
    assert res.latency_s == min(m.latency_s for m in res.trials)
    assert any(tc.kernel for m in res.trials for tc in m.schedule.tiles)
    assert all(TT.schedule_is_feasible(g, m.schedule, 4) for m in res.trials)


def test_cli_tune_ga_stack(tmp_path, capsys):
    path = tmp_path / "sched.json"
    rc = TCLI.main(["tune", "--dataset", "tiny", "--network", "GCN", "--ga",
                    "--stack", "--hidden", "16", "--device", "cpu",
                    "--target-s", "0", "--iters", "1", "--memo",
                    str(tmp_path / "m.csv"), "--schedule", str(path),
                    "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["search"] == "genetic"
    assert out["schedule_path"] == str(path)
    spec = json.loads(path.read_text())
    assert len(spec["layers"]) == 2
    sched = TCLI.load_schedules(str(path), 2)
    assert all(isinstance(s, TS.Schedule) for s in sched)
