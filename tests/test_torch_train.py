"""PyTorch port, full-batch training: ``lower_schedule(build_transpose=True)``
for GCN-2l and GAT-2l (loss and gradients against ``jax.value_and_grad``,
JAX kernels in interpret mode), ``models/train.py`` against the JAX
package's trainer, training through the hybrid path with the transposed
twins, the checkpoint round trip and ``cli.py train``.

Tolerance in float32: max |port - jax| <= 1e-5 * max(1, max |jax|), for
the loss, the gradients and the parameters after AdamW updates (the two
optimizers apply the same decoupled decay and bias correction, so they
agree to rounding)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import fusion as JF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as JS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets import synthetic_coo  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models import train as JT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import dense as JD  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import cli as TCLI  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import checkpoint as TC  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
# the JAX trainer test's hybrid geometry for the 200-node tiny graph
TINY_TILE = TS.TileConfig(32, 32, 64, TS.PATH_HYBRID)
# the slice's geometry shrunk to a 600-node graph (test_torch_slice.py)
N, E, F_IN, HIDDEN, N_CLASS = 600, 5000, 24, 32, 5
SPMM_TILE = dict(block_rows=128, block_cols=128, tile_edges=128,
                 dense_block=128)
GAT_TILE = dict(block_rows=128, block_cols=256, tile_edges=128,
                dense_block=128)


def _close(port, ref, tol=1e-5):
    port = port.detach().float().cpu().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _schedules(model, network):
    return TF.hybrid_schedules(model.layers, spmm_tile=TINY_TILE,
                               gat_tile=TINY_TILE)


@pytest.mark.parametrize("network", ["GCN", "GAT"])
def test_adamw_steps_match_optax(network):
    """Two train steps on the per-op path: the losses and the parameters
    after each AdamW update match JAX's make_train_step with
    optax.adamw(lr, weight_decay=5e-4)."""
    ds = J.load_dataset("tiny")
    kw = dict(hidden=16, n_layers=2, heads=2)
    jm = J.build_model(network, ds.x.shape[1], ds.n_class, **kw)
    tm = T.build_model(network, ds.x.shape[1], ds.n_class, **kw, device=CPU)
    pj = jm.init(jax.random.key(0))
    tm.load_params(T.params_from_numpy({k: np.asarray(v)
                                        for k, v in pj.items()}, CPU))
    tx = optax.adamw(1e-2, weight_decay=5e-4)
    jstep = jax.jit(JT.make_train_step(jm.make_apply(), tx))
    js = JT.TrainState(pj, tx.init(pj), jnp.zeros((), jnp.int32))
    ts = TT.TrainState(tm.params, TT.adamw(tm.params, 1e-2, 5e-4))
    tstep = TT.make_train_step(tm.make_apply())
    gj, gt = ds.host_graph.to_device(), \
        T.load_dataset("tiny").host_graph.to_device(CPU)
    args_j = (jnp.asarray(ds.x), jnp.asarray(ds.y), jnp.asarray(ds.train_mask))
    args_t = (torch.tensor(ds.x), torch.tensor(ds.y).long(),
              torch.tensor(ds.train_mask))
    for _ in range(2):
        js, lj = jstep(js, gj, *args_j)
        ts, lt = tstep(ts, gt, *args_t)
        _close(lt, lj)
        for k, v in ts.params.items():
            _close(v, js.params[k])
    assert ts.step == int(js.step) == 2


@pytest.mark.parametrize("network", ["GCN", "GAT"])
def test_train_tiny_through_hybrid_kernel_backward(network):
    """train_node_classifier on the tiny dataset through hybrid schedules
    with the transposed twins reaches train_acc > 0.6, as the JAX
    trainer's own test does (test_train.py, 30 epochs)."""
    ds = T.load_dataset("tiny")
    model = T.build_model(network, ds.x.shape[1], ds.n_class, hidden=16,
                          n_layers=2, heads=2, device=CPU,
                          generator=torch.Generator().manual_seed(0))
    sched = _schedules(model, network)
    want = "spmm_hybrid" if network == "GCN" else "gat_hybrid"
    assert all(any(TF.classify_block(g, b, t)[0] == want
                   for b, t in zip(s.blocks, s.tiles))
               for g, s in zip(model.layers, sched))
    state, res = TT.train_node_classifier(
        ds, network, hidden=16, heads=2, epochs=30, model=model,
        schedules=sched, build_transpose=True, device=CPU)
    assert res.train_acc > 0.6, res
    assert state.step == 30
    assert res.epoch_time_s is None       # no device clock on the CPU


def test_checkpoint_round_trip(tmp_path):
    """Save after three steps, restore into a fresh state, and the next
    step of both is the same."""
    ds = T.load_dataset("tiny")
    g = ds.host_graph.to_device(CPU)
    args = (torch.tensor(ds.x), torch.tensor(ds.y).long(),
            torch.tensor(ds.train_mask))

    def fresh(seed):
        m = T.build_model("GCN", ds.x.shape[1], ds.n_class, hidden=16,
                          generator=torch.Generator().manual_seed(seed),
                          device=CPU)
        return m, TT.TrainState(m.params, TT.adamw(m.params, 1e-2))

    m, st = fresh(0)
    step = TT.make_train_step(m.make_apply())
    for _ in range(3):
        st, _ = step(st, g, *args)
    assert TC.save_state(str(tmp_path), st) == 3
    assert TC.latest_step(str(tmp_path)) == 3
    m2, st2 = fresh(1)
    st2 = TC.restore_state(str(tmp_path), st2)
    assert st2.step == 3
    for k, v in st.params.items():
        assert torch.equal(v, st2.params[k])
    st, la = step(st, g, *args)
    st2, lb = TT.make_train_step(m2.make_apply())(st2, g, *args)
    assert torch.equal(la, lb)
    for k, v in st.params.items():
        assert torch.equal(v, st2.params[k])
    with pytest.raises(FileNotFoundError):
        TC.restore_state(str(tmp_path / "none"), st2)


def test_cli_train_schedule_prints_jax_keys(tmp_path, capsys):
    spec = {"layers": [
        {"blocks": [list(b) for b in s.blocks],
         "tiles": [list(t.key()) for t in s.tiles]}
        for s in _schedules(T.build_model("GCN", 32, 4, hidden=16,
                                          reorder=True, device=CPU), "GCN")]}
    path = tmp_path / "sched.json"
    path.write_text(json.dumps(spec))
    rc = TCLI.main(["train", "--dataset", "tiny", "--network", "GCN",
                    "--reorder", "--hidden", "16", "--f32", "--device",
                    "cpu", "--epochs", "3", "--schedule", str(path),
                    "--ckpt", str(tmp_path / "ck"), "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    for k in ("train_loss", "train_acc", "val_acc", "test_acc",
              "epoch_time_s", "edges_per_s", "ckpt_step", "schedule"):
        assert k in out, k
    assert out["ckpt_step"] == 3 and np.isfinite(out["train_loss"])
    assert out["epoch_time_s"] is None    # a CPU run has no device time
    assert TCLI.main(["train", "--compiled", "--device", "cpu"]) == 2


def test_non_hybrid_kernel_blocks_refuse_a_gradient():
    """The non-hybrid gat kind used to refuse a gradient, having no
    backward; it now has ``_gat_vjp``'s (without a twin, autograd of the
    edge formulation), and its gradient equals autograd of the per-op
    path.  (The spmm kinds: ``test_torch_grouped.py``; the gat kind against
    ``jax.grad``: ``test_torch_gat_layer.py``.)"""
    ds = T.load_dataset("tiny")
    m = T.build_model("GAT", ds.x.shape[1], ds.n_class, hidden=16,
                      n_layers=1, heads=1, device=CPU)
    part = TS.pattern_partition(m.layers[0])
    tc = TS.TileConfig(32, 32, 64, TS.PATH_ONEHOT)
    sched = TS.Schedule(blocks=part, tiles=tuple(
        tc if TF.classify_block(m.layers[0], b, tc)[0] == "gat"
        else TS.TileConfig(path=TS.PATH_XLA) for b in part))
    assert any(t.kernel for t in sched.tiles)
    g = ds.host_graph.to_device(CPU)
    x = torch.tensor(ds.x)
    grads = []
    for fwd in (m.make_apply(schedules=sched, host_graph=ds.host_graph,
                             device=CPU), m.make_apply()):
        m.zero_grad(set_to_none=True)
        (fwd(dict(m.params), g, x) ** 2).sum().backward()
        grads.append({k: p.grad.clone() for k, p in m.params.items()})
    for k, ref in grads[1].items():
        err = float((grads[0][k] - ref).abs().max())
        assert err <= 1e-5 * max(1.0, float(ref.abs().max())), (k, err)


@pytest.fixture(scope="module")
def slice_graphs():
    s, r, labels = synthetic_coo(N, E, seed=1, communities=6, p_in=0.8)
    hj = J.build_host_graph(s, r, N, add_self_loops=True, symmetric_norm=True)
    hj, _ = J.reorder_nodes(hj, "hubs+labels", labels=labels)
    ht = TG.build_host_graph(s, r, N, add_self_loops=True,
                             symmetric_norm=True)
    ht, _ = TG.reorder_nodes(ht, "hubs+labels", labels=labels)
    return hj, ht


@pytest.mark.parametrize("net", ["GCN", "GAT"])
def test_lower_schedule_build_transpose_matches_jax(slice_graphs, net):
    """GCN-2l (transform-first) and GAT-2l (4 heads) lowered on the hybrid
    path with the transposed twins: the loss and every parameter's
    gradient against jax.value_and_grad over the JAX package's own
    lower_schedule(build_transpose=True), same weights, float32."""
    hj, ht = slice_graphs
    kw = dict(hidden=HIDDEN, n_layers=2, reorder=(net == "GCN"), heads=4)
    jm = J.build_model(net, F_IN, N_CLASS, **kw)
    tm = T.build_model(net, F_IN, N_CLASS, **kw, device=CPU)
    pj = jm.init(jax.random.key(0))
    tm.load_params(T.params_from_numpy({k: np.asarray(v)
                                        for k, v in pj.items()}, CPU))
    st = TF.hybrid_schedules(
        tm.layers, spmm_tile=TS.TileConfig(path=TS.PATH_HYBRID, **SPMM_TILE),
        gat_tile=TS.TileConfig(path=TS.PATH_HYBRID, **GAT_TILE))
    sj = [JS.Schedule.from_key(s.key()) for s in st]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    y = rng.integers(0, N_CLASS, N).astype(np.int32)
    mask = rng.random(N) < 0.8

    cache = {}
    fj = [JF.lower_schedule(g, s, hj, build_transpose=True, interpret=True,
                            tile_cache=cache) for g, s in zip(jm.layers, sj)]

    def j_loss(p):
        v = jnp.asarray(x)
        for fn in fj:
            v = fn(p, hj.to_device(), v)
        return JT.masked_cross_entropy(v, jnp.asarray(y), jnp.asarray(mask))

    lj, gj = jax.value_and_grad(j_loss)(pj)
    fwd = tm.make_apply(schedules=st, host_graph=ht, build_transpose=True,
                        device=CPU)
    want = "spmm_hybrid" if net == "GCN" else "gat_hybrid"
    for fn in fwd.layer_fns:
        twins = [(d, tw) for k, _, d, tw in fn.plans if k == want]
        assert len(twins) == 1 and twins[0][1] is not None
        assert twins[0][1].dense is not None
    lt = TT.masked_cross_entropy(fwd(dict(tm.params), ht.to_device(CPU), torch.tensor(x)),
              torch.tensor(y), torch.tensor(mask))
    lt.backward()
    _close(lt, lj)
    assert set(gj) == set(tm.params)
    for k, p in tm.params.items():
        _close(p.grad, gj[k])


def test_twin_threshold_is_the_transposed_graphs(slice_graphs):
    """The twin's dense threshold is computed over the transposed graph, as
    the JAX package computes it, so both build the same twin split."""
    hj, ht = slice_graphs
    tm = T.build_model("GAT", F_IN, N_CLASS, hidden=HIDDEN, heads=4,
                       device=CPU)
    st = TF.hybrid_schedules(
        tm.layers, gat_tile=TS.TileConfig(path=TS.PATH_HYBRID, **GAT_TILE))
    cache = {}
    fn = TF.lower_schedule(tm.layers[0], st[0], ht, build_transpose=True,
                           tile_cache=cache, device=CPU)
    (_, _, hyb, twin), = [p for p in fn.plans if p[0] == "gat_hybrid"]
    hj_t, _ = JG.transpose_host_graph(hj)
    thr = JD.hybrid_threshold(hj_t, "gat", heads=4, head_dim=HIDDEN // 4,
                              dense_rows=128, dense_cols=128)
    jtwin = JG.hybrid_graph(hj_t, block_rows=128, block_cols=128,
                            sparse_block_rows=128, sparse_block_cols=256,
                            tile_edges=128, min_nnz=thr, unit_weight=True,
                            block_layout="cr", values_dtype=np.int8)
    assert twin.n_dense_edges == jtwin.n_dense_edges
    assert twin.tiles.n_tiles == jtwin.tiles.n_tiles
    assert cache["transpose"][0].n_edge == ht.n_edge
