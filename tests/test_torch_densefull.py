"""PyTorch port, the densefull path and the tuner's palette against the JAX
package: ``graph.dense_adjacency`` (weighted and unweighted, multi-edges,
several row blocks, ``pad_multiple``), ``lower_schedule`` on the
``spmm_densefull`` kind for GCN, GAT (whose attention block has no
densefull kind and runs op by op) and SAGE-mean, forward and gradient in
x (as tests/test_dense.py:645-700), the node cap's fallback to the per-op
path, and ``TILE_PALETTE`` entry by entry.  Inputs are made with numpy
from a seed and handed to both.

Tolerances: the adjacency in float32 equal to JAX's to 1e-6 of its largest
entry (the same float32 adds in the same edge order), in bf16 within one
bf16 rounding of that (2^-8 of an entry); lowered outputs in float32 max
|port - jax| <= 1e-5 * max(1, max |jax|) (both multiply the same bf16
adjacency by the float32 features), bfloat16 2e-2 of the same scale;
gradients 1e-4 * max(1, max |jax|)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import fusion as JF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as JS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune import search as JT  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.tune import search as TT  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(port, ref, tol=TOL["float32"]):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _graphs(**kw):
    """(jax host graph, port host graph) of the edge-case graph."""
    s, r, n, _ = fixtures.edge_case_graph()
    kw = dict(edge_pad_multiple=128, **kw)
    return (J.build_host_graph(s, r, n, **kw),
            TG.build_host_graph(s, r, n, **kw))


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("pad_multiple,rows", [(256, 128), (128, 96),
                                               (256, 8192)])
def test_dense_adjacency_matches_jax(weighted, pad_multiple, rows,
                                     monkeypatch):
    """Built ``rows`` rows at a time: several row blocks, a block size
    that does not divide N_pad, and one block; the hub pair's 200 copies
    sum into one cell."""
    monkeypatch.setattr(TG, "DENSE_ROWS", rows)
    hj, ht = _graphs(add_self_loops=True, symmetric_norm=True)
    assert ht.n_node % pad_multiple
    for dt, jdt in ((torch.float32, np.float32), (torch.bfloat16, None)):
        got = TG.dense_adjacency(ht, weighted=weighted,
                                 pad_multiple=pad_multiple, dtype=dt,
                                 device=CPU)
        want = np.asarray(JG.dense_adjacency(
            hj, weighted=weighted, pad_multiple=pad_multiple,
            dtype=jdt)).astype(np.float32)
        assert got.dtype == dt and tuple(got.shape) == want.shape
        assert want.shape[0] % pad_multiple == 0
        if not weighted:
            s, r = fixtures.HOT_PAIR
            assert float(got[r, s]) == want[r, s] >= fixtures.HOT_COPIES
        tol = 1e-6 if dt == torch.float32 else 2.0 ** -8
        err = np.abs(got.float().numpy() - want)
        assert bool((err <= tol * np.abs(want)
                     + 1e-6 * np.abs(want).max()).all())


def test_dense_adjacency_refuses_past_the_cap(monkeypatch):
    _, ht = _graphs()
    monkeypatch.setattr(TG, "DENSEFULL_MAX_N", ht.n_node - 1)
    with pytest.raises(ValueError, match="DENSEFULL_MAX_N"):
        TG.dense_adjacency(ht, device=CPU)


NETS = {"GCN": "aggregation_partition", "GraphSAGE": "aggregation_partition",
        "GAT": "pattern_partition"}


def _schedule(graph, partition):
    """``partition``'s blocks on PATH_DENSEFULL where they lower to a
    kernel kind, the rest op by op."""
    tc = TS.TileConfig(path=TS.PATH_DENSEFULL)
    part = getattr(TS, partition)(graph)
    tiles = tuple(tc if TF.classify_block(graph, b, tc)[0] != "xla"
                  else TS.TileConfig(path=TS.PATH_XLA) for b in part)
    return TS.Schedule(blocks=part, tiles=tiles)


def _lowered(network, capped=False, monkeypatch=None):
    """(port apply, JAX apply per dtype name, params of both, graphs, x) of
    ``network`` on the densefull schedule; with ``capped`` both packages'
    node caps sit just below the graph's node count."""
    hj, ht = _graphs(add_self_loops=True, symmetric_norm=True)
    if capped:
        monkeypatch.setattr(TF, "DENSEFULL_MAX_N", ht.n_node - 1)
        monkeypatch.setattr(JG, "DENSEFULL_MAX_N", ht.n_node - 1)
    gj = J.build_op_graph(network, 12, 8, heads=2)
    gt = T.build_op_graph(network, 12, 8, heads=2)
    sched = _schedule(gt, NETS[network])
    sj = JS.Schedule.from_key(sched.key())
    fns = {dtn: (TF.lower_schedule(gt, sched, ht, None if dtn == "float32"
                                   else tdt, device=CPU),
                 JF.lower_schedule(gj, sj, hj, None if dtn == "float32"
                                   else jdt, interpret=True))
           for dtn, (tdt, jdt) in DTYPES.items()}
    pj = J.init_params(gj, jax.random.key(0))
    pt = T.params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, CPU)
    x = np.random.default_rng(4).standard_normal(
        (ht.n_node, 12)).astype(np.float32)
    return fns, pj, pt, hj, ht, x


@pytest.mark.parametrize("network", sorted(NETS))
def test_lower_schedule_densefull_matches_jax(network):
    fns, pj, pt, hj, ht, x = _lowered(network)
    kinds = [p[0] for p in fns["float32"][0].plans]
    assert kinds.count("spmm_densefull") == (network != "GAT")
    for dtn, (fn, fj) in fns.items():
        _close(fn(pt, ht.to_device(CPU), torch.tensor(x)),
               fj(pj, hj.to_device(), jnp.asarray(x)), TOL[dtn])
    fn, fj = fns["float32"]
    xt = torch.tensor(x, requires_grad=True)
    (fn(pt, ht.to_device(CPU), xt) ** 2).sum().backward()
    want = jax.grad(lambda v: jnp.sum(fj(pj, hj.to_device(), v) ** 2))(
        jnp.asarray(x))
    _close(xt.grad, want, GRAD_TOL)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_densefull_product_and_its_backward(dtn, monkeypatch):
    """``fusion._Densefull`` against autograd of the plain product of the
    widened adjacency, over row blocks that do not divide n: y float32,
    dv in v's dtype (the backward widens A as the float32 forward does,
    since the card's bf16 forward, ``torch.mm(out_dtype=float32)``, has no
    derivative)."""
    monkeypatch.setattr(TF, "DENSE_ROWS", 96)
    _, ht = _graphs(add_self_loops=True, symmetric_norm=True)
    a = TG.dense_adjacency(ht, device=CPU)
    n = ht.n_node
    rng = np.random.default_rng(5)
    v0 = torch.tensor(rng.standard_normal((n, 7)), dtype=DTYPES[dtn][0])
    gy = torch.tensor(rng.standard_normal((n, 7)), dtype=torch.float32)
    v = v0.clone().requires_grad_(True)
    y = TF._Densefull.apply(a, v)
    y.backward(gy)
    vr = v0.clone().requires_grad_(True)
    yr = a[:n, :n].float() @ vr.float()
    yr.backward(gy)
    assert y.dtype == torch.float32 and v.grad.dtype == v0.dtype
    _close(y, yr.detach())
    _close(v.grad, vr.grad, TOL[dtn] if dtn == "bfloat16" else GRAD_TOL)


def test_densefull_above_the_cap_runs_op_by_op(monkeypatch):
    """Past ``DENSEFULL_MAX_N`` the densefull block lowers to ``xla`` in
    both packages (JAX fusion.py:330-331), with the same answers."""
    fns, pj, pt, hj, ht, x = _lowered("GCN", capped=True,
                                      monkeypatch=monkeypatch)
    fn, fj = fns["float32"]
    assert [p[0] for p in fn.plans] == ["xla", "xla"]
    assert all(p[2] is None for p in fn.plans)
    _close(fn(pt, ht.to_device(CPU), torch.tensor(x)),
           fj(pj, hj.to_device(), jnp.asarray(x)))


def test_tile_palette_is_jaxs_and_feasible():
    """The tuner sweeps the JAX package's palette, entry by entry and in
    order, and the port runs every entry (the shared-memory rule admits
    each path at the smoke's widths)."""
    assert len(TT.TILE_PALETTE) == len(JT.TILE_PALETTE)
    for t, j in zip(TT.TILE_PALETTE, JT.TILE_PALETTE):
        assert (t.block_rows, t.block_cols, t.tile_edges, t.path,
                t.dense_block) == (j.block_rows, j.block_cols, j.tile_edges,
                                   j.path, j.dense_block)
    paths = {t.path for t in TT.TILE_PALETTE}
    assert {TS.PATH_STREAM, TS.PATH_DENSEFULL} <= paths
    for t in TT.TILE_PALETTE:
        for width, heads in ((128, 4), (41, 1)):
            for db in (2, 4):
                assert TS.tile_is_feasible(t, width, heads=heads,
                                           dtype_bytes=db), t
