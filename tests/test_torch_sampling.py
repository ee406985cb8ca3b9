"""PyTorch port, neighbour-sampled training: ``data/sampling.py`` against
the JAX package's (every batch of a seeded epoch equal bit for bit, and
``gather_features``), the batches' invariants, one sampled train step
against JAX's (``jax.value_and_grad`` and ``optax.adamw``), and the two
trainers ``train_sampled`` and ``train_sampled_scan`` on the tiny
dataset, on the CPU.

Tolerances: the sampler's arrays exactly; the train step in float32,
the loss within 1e-5 relative and each gradient within 1e-5 *
max(1, max |g_jax|), then the losses of steps 2-3 within 1e-5 relative
(the two AdamW updates agree to rounding); the trainers converge (train
accuracy above 0.5, loss below 1.3 < ln 4)."""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data import sampling as JSa  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models import train as JT  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import native as TN  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data import sampling as TSa  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT  # noqa: E402

from conftest import small_graph  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
STEP_TOL = 1e-5


def _graphs(rng, n=300, e=2500):
    """The same COO graph built by both packages (nodes 100-109 without
    in-edges, so some frontier nodes have degree 0)."""
    s, r = small_graph(rng, n=n, e=e, multi_edges=True)
    keep = (r < 100) | (r >= 110)
    s, r = s[keep], r[keep]
    return J.build_host_graph(s, r, n), T.build_host_graph(s, r, n), s, r


@pytest.mark.parametrize("fanouts,batch", [((5, 3), 16), ((4,), 32),
                                           ((3, 3, 2), 8)])
def test_sampler_epoch_matches_jax_bit_for_bit(rng, fanouts, batch):
    """For one seed the port's NeighborSampler draws the JAX sampler's
    batches: every array of every batch of an epoch, and the gathered
    features."""
    jhg, thg, _, _ = _graphs(rng)
    x = rng.normal(size=(300, 7)).astype(np.float32)
    train = np.arange(0, 300, 2)
    js = JSa.NeighborSampler(jhg, fanouts, batch, seed=3)
    ts = TSa.NeighborSampler(thg, fanouts, batch, seed=3)
    assert (ts.cap_nodes, ts.cap_edges) == (js.cap_nodes, js.cap_edges)
    n = 0
    for _ in range(2):
        for jb, tb in zip(js.epoch(train), ts.epoch(train), strict=True):
            for f in ("senders", "receivers", "edge_mask", "edge_weight"):
                np.testing.assert_array_equal(getattr(tb.graph, f),
                                              getattr(jb.graph, f), f)
            assert tb.graph.n_edge == jb.graph.n_edge
            np.testing.assert_array_equal(tb.node_ids, jb.node_ids)
            np.testing.assert_array_equal(tb.seed_mask, jb.seed_mask)
            assert tb.n_seed == jb.n_seed
            np.testing.assert_array_equal(TSa.gather_features(x, tb),
                                          JSa.gather_features(x, jb))
            n += 1
    assert n == 2 * (len(train) // batch)


def test_sampled_batches_static_shapes_and_real_edges(rng):
    """Every batch has the same capacities; every edge maps back to a
    real edge of the graph or is a self loop (JAX test_sampling.py:13)."""
    s, r = small_graph(rng, n=200, e=1500, multi_edges=True)
    hg = T.build_host_graph(s, r, 200)
    sampler = TSa.NeighborSampler(hg, fanouts=[5, 3], batch_size=16, seed=0)
    real_pairs = set(zip(s.tolist(), r.tolist()))
    shapes = set()
    for batch in sampler.epoch(np.arange(100)):
        shapes.add((batch.cap_nodes, batch.graph.e_pad))
        g = batch.graph
        gs = batch.node_ids[g.senders[: g.n_edge]]
        gd = batch.node_ids[g.receivers[: g.n_edge]]
        for a, b in zip(gs.tolist(), gd.tolist()):
            assert a == b or (a, b) in real_pairs
    assert shapes == {(sampler.cap_nodes, sampler.e_pad)}


def test_sampler_nodes_without_in_edges_at_the_end(rng):
    """Seeds among the last nodes, which have no in-edges: they sample
    nothing and keep their slots (the JAX sampler indexes past its edge
    array there and raises IndexError)."""
    s, r = small_graph(rng, n=60, e=400, multi_edges=True)
    keep = r < 50
    hg = T.build_host_graph(s[keep], r[keep], 60)
    sampler = TSa.NeighborSampler(hg, fanouts=[3, 2], batch_size=4, seed=0)
    batch = sampler.sample(np.array([57, 58, 59, 3]))
    np.testing.assert_array_equal(batch.node_ids[:4], [57, 58, 59, 3])
    g = batch.graph
    dst = batch.node_ids[g.receivers[: g.n_edge]]
    src = batch.node_ids[g.senders[: g.n_edge]]
    loops = src == dst
    assert not np.isin(dst[~loops], [57, 58, 59]).any()
    assert (~loops).sum() >= 3      # node 3 sampled its in-neighbours


def test_sampled_seeds_lead(rng):
    s, r = small_graph(rng, n=100, e=600)
    hg = T.build_host_graph(s, r, 100)
    sampler = TSa.NeighborSampler(hg, fanouts=[4], batch_size=8, seed=0)
    seeds = np.array([5, 9, 13, 17, 21, 25, 29, 33])
    batch = sampler.sample(seeds)
    np.testing.assert_array_equal(batch.node_ids[:8], seeds)
    assert batch.seed_mask[:8].all() and not batch.seed_mask[8:].any()


def test_device_graph_pins_n_edge_to_capacity():
    """Two batches with different real edge counts give the step device
    graphs of one shape, n_edge pinned to e_pad."""
    ds = T.load_dataset("tiny")
    sampler = TSa.NeighborSampler(ds.host_graph, (3, 3), 8, seed=0)
    batches = [sampler.sample(np.arange(8)), sampler.sample(np.arange(8, 16))]
    assert batches[0].graph.n_edge != batches[1].graph.n_edge
    for b in batches:
        g = b.device_graph(CPU)
        assert g.n_edge == g.e_pad == sampler.e_pad
        assert g.senders.device.type == "cpu"
        np.testing.assert_array_equal(g.senders.numpy(), b.graph.senders)
        np.testing.assert_array_equal(g.edge_mask.numpy(), b.graph.edge_mask)


def _close(port, ref, tol=STEP_TOL):
    port = port.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _rel(a, b):
    a = float(a.detach()) if torch.is_tensor(a) else float(a)
    return abs(a - float(b)) / max(abs(float(b)), 1e-30)


def test_sampled_train_step_matches_jax():
    """One GraphSAGE train step on a sampled batch, from the same
    parameters: the port (rows gathered on the device from the full x and
    y, ``make_sampled_update``) against JAX (host-gathered rows): loss
    and every gradient, then the losses of steps 2 and 3 with AdamW
    updates carried on both sides."""
    ds = J.load_dataset("tiny")
    tds = T.load_dataset("tiny")
    js_ = JSa.NeighborSampler(ds.host_graph, (5, 5), 16, seed=0)
    ts_ = TSa.NeighborSampler(tds.host_graph, (5, 5), 16, seed=0)
    train = np.flatnonzero(ds.train_mask)
    jbs = [b for b, _ in zip(js_.epoch(train), range(3))]
    tbs = [b for b, _ in zip(ts_.epoch(train), range(3))]

    kw = dict(hidden=32, n_layers=2)
    jm = J.build_model("GraphSAGE", ds.x.shape[1], ds.n_class, **kw)
    tm = T.build_model("GraphSAGE", ds.x.shape[1], ds.n_class, **kw,
                       device=CPU)
    pj = jm.init(jax.random.key(0))
    tm.load_params(T.params_from_numpy({k: np.asarray(v)
                                        for k, v in pj.items()}, CPU))
    japply, tapply = jm.make_apply(), tm.make_apply()

    def jbatch(b):
        valid = b.node_ids >= 0
        yb = np.zeros(b.cap_nodes, np.int32)
        yb[valid] = ds.y[b.node_ids[valid]]
        return (b.device_graph(), jnp.asarray(JSa.gather_features(ds.x, b)),
                jnp.asarray(yb), jnp.asarray(b.seed_mask))

    def tbatch(b):
        g = b.graph
        return TT.batch_to_device(dict(
            senders=g.senders, receivers=g.receivers, mask=g.edge_mask,
            weight=g.edge_weight, ids=b.node_ids.astype(np.int32),
            seed=b.seed_mask), CPU)

    xfull = torch.as_tensor(tds.x)
    yfull = torch.as_tensor(tds.y.astype(np.int64))

    # step 1's loss and gradients at the initial parameters
    jg, jx, jy, jmask = jbatch(jbs[0])
    jl, jgr = jax.value_and_grad(lambda p: JT.masked_cross_entropy(
        japply(p, jg, jx), jy, jmask))(pj)
    b = tbatch(tbs[0])
    g = T.GraphTensor(senders=b["senders"], receivers=b["receivers"],
                      edge_mask=b["mask"], edge_weight=b["weight"],
                      n_node=ts_.cap_nodes, n_edge=ts_.e_pad)
    xb, yb = TT.gather_rows(xfull, yfull, b["ids"])
    np.testing.assert_array_equal(xb.numpy(), np.asarray(jx))
    params = dict(tm.params)
    tl = TT.masked_cross_entropy(tapply(params, g, xb), yb, b["seed"])
    tgr = torch.autograd.grad(tl, list(params.values()))
    assert _rel(tl, jl) <= STEP_TOL, (float(tl), float(jl))
    for k, gk in zip(params, tgr):
        _close(gk, jgr[k])

    # steps 1-3 with the optimizers
    tx = optax.adamw(1e-2, weight_decay=5e-4)
    jstep = jax.jit(JT.make_train_step(japply, tx))
    jst = JT.TrainState(pj, tx.init(pj), jnp.zeros((), jnp.int32))
    tst = TT.TrainState(tm.params, TT.adamw(tm.params, 1e-2, 5e-4))
    update = TT.make_sampled_update(tapply, tst, ts_.cap_nodes, ts_.e_pad,
                                    xfull, yfull)
    for jb, tb in zip(jbs, tbs):
        jst, jl = jstep(jst, *jbatch(jb))
        tl = update(tbatch(tb))
        assert _rel(tl, jl) <= STEP_TOL, (float(tl), float(jl))
    for k, p in tst.params.items():
        _close(p, jst.params[k])


@pytest.mark.parametrize("device_features", [False, True])
def test_train_sampled_converges(device_features):
    ds = T.load_dataset("tiny")
    state, res = TT.train_sampled(
        ds, fanouts=(5, 5), batch_size=16, epochs=8, hidden=32,
        device_features=device_features, prefetch=2, device=CPU)
    assert np.isfinite(res.train_loss)
    assert res.train_acc > 0.5, res
    assert res.epoch_time_s is None    # no CUDA device: not measured
    steps = len(np.flatnonzero(ds.train_mask)) // 16
    assert state.step == 8 * steps


def test_train_sampled_device_features_take_the_host_rows():
    """The device-side row gather trains exactly as the host gather does
    (same seed, same batches, same rows)."""
    ds = T.load_dataset("tiny")
    kw = dict(fanouts=(3, 3), batch_size=16, epochs=2, hidden=16,
              device=CPU, prefetch=0)
    s0, r0 = TT.train_sampled(ds, device_features=False, **kw)
    s1, r1 = TT.train_sampled(ds, device_features=True, **kw)
    assert r0.train_loss == r1.train_loss
    for k in s0.params:
        assert torch.equal(s0.params[k], s1.params[k]), k


@pytest.mark.parametrize("sampler", ["native", "numpy"])
def test_train_sampled_scan_converges(sampler, monkeypatch):
    if sampler == "native":
        if shutil.which(TN.CXX) is None:
            pytest.skip(f"{TN.CXX} not found")
        assert TN.HAVE_NATIVE, TN.BUILD_ERROR
    else:
        monkeypatch.setattr(TN, "HAVE_NATIVE", False)
    ds = T.load_dataset("tiny")
    state, res, bd = TT.train_sampled_scan(
        ds, fanouts=(5, 5), batch_size=16, epochs=6, hidden=32, device=CPU)
    assert np.isfinite(res.train_loss)
    assert res.train_loss < 1.3, res
    assert bd["sampler"] == sampler
    assert len(bd["epoch_losses"]) == 6
    assert bd["epoch_losses"][-1] < bd["epoch_losses"][0]
    assert bd["steps_per_epoch"] >= 1
    assert state.step == 6 * bd["steps_per_epoch"]


def test_train_sampled_scan_numpy_epochs_match_jax_stack(monkeypatch):
    """Without the native library the scanned trainer samples its epochs
    with the numpy sampler in the JAX trainer's RNG order: its first
    epoch's batches are JAX's NeighborSampler's."""
    monkeypatch.setattr(TN, "HAVE_NATIVE", False)
    ds = T.load_dataset("tiny")
    seen = []
    real = TT.batch_to_device

    def record(arrays, device):
        seen.append({k: np.array(v) for k, v in arrays.items()})
        return real(arrays, device)

    monkeypatch.setattr(TT, "batch_to_device", record)
    TT.train_sampled_scan(ds, fanouts=(3, 3), batch_size=16, epochs=1,
                          hidden=8, device=CPU)
    jds = J.load_dataset("tiny")
    js_ = JSa.NeighborSampler(jds.host_graph, (3, 3), 16, seed=0)
    jbs = list(js_.epoch(np.flatnonzero(jds.train_mask)))
    np.testing.assert_array_equal(
        seen[0]["senders"], np.stack([b.graph.senders for b in jbs]))
    np.testing.assert_array_equal(
        seen[0]["ids"], np.stack([b.node_ids for b in jbs]))


def test_train_sampled_scan_refuses_mesh_and_cpu_timing():
    ds = T.load_dataset("tiny")
    with pytest.raises(TypeError, match="process group"):
        TT.train_sampled_scan(ds, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        TT.train_sampled_scan(ds, measure_device_epoch=True, device=CPU)
    with pytest.raises(ValueError, match="batch_size"):
        TT.train_sampled_scan(ds, batch_size=10_000, device=CPU)


def test_snapshot_restore_returns_the_state_bit_for_bit():
    """After steps of an eager EpochRunner, ``restore`` puts the
    parameters and AdamW's moments and step counts back exactly."""
    ds = T.load_dataset("tiny")
    sampler = TSa.NeighborSampler(ds.host_graph, (3, 3), 16, seed=0)
    model = T.build_model("GraphSAGE", ds.x.shape[1], ds.n_class,
                          hidden=16, device=CPU)
    state = TT.TrainState(model.params, TT.adamw(model.params, 1e-2))
    update = TT.make_sampled_update(
        model.make_apply(), state, sampler.cap_nodes, sampler.e_pad,
        torch.as_tensor(ds.x), torch.as_tensor(ds.y.astype(np.int64)))
    batches = list(sampler.epoch(np.flatnonzero(ds.train_mask)))
    stacked = TT.batch_to_device(dict(
        senders=np.stack([b.graph.senders for b in batches]),
        receivers=np.stack([b.graph.receivers for b in batches]),
        mask=np.stack([b.graph.edge_mask for b in batches]),
        weight=np.stack([b.graph.edge_weight for b in batches]),
        ids=np.stack([b.node_ids.astype(np.int32) for b in batches]),
        seed=np.stack([b.seed_mask for b in batches])), CPU)
    runner = TT.EpochRunner(update, capture=False)
    runner.run(stacked, 2)                 # the optimizer has state now
    snap = TT.snapshot(state)
    # each parameter, and its AdamW step count and two moments
    assert len(snap) == 4 * len(state.params)
    losses = torch.zeros(len(batches))
    runner.run(stacked, len(batches), losses)
    assert bool((losses > 0).all())
    moved = TT.snapshot(state)
    assert not all(torch.equal(a, b) for a, b in zip(snap, moved))
    TT.restore(state, snap)
    for a, b in zip(TT.snapshot(state), snap, strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        TT.device_epoch_seconds(runner, state, stacked, 1)


def test_prefetch_surfaces_producer_errors_and_stops():
    def items():
        yield 1
        yield 2
        raise KeyError("sampler failed")

    got = []
    with pytest.raises(KeyError, match="sampler failed"):
        for v in TT._prefetched(items(), 2):
            got.append(v)
    assert got == [1, 2]

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    gen = TT._prefetched(endless(), 3)
    assert [next(gen) for _ in range(5)] == [0, 1, 2, 3, 4]
    gen.close()      # joins the producer thread; a hang would time out
