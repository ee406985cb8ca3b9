"""PyTorch port, the stream path against the JAX package: ``ops/chunked``'s
``_pad_to_chunks``, ``spmm_chunked`` and ``gat_chunked`` (forward, and
``gat_chunked``'s gradients as tests/test_chunked.py:68-90 takes them), and
``lower_schedule`` on the ``spmm_stream`` and ``gat_stream`` kinds for GCN,
GAT and SAGE-mean, forward and gradient in x.  Both packages scan the same
edge chunks outside any kernel (JAX ``lax.scan``, the port a loop of
``index_select`` / ``index_add_``), on the edge-case graph of
``utils/fixtures`` (multi-edges, a hub pair of 200 copies, empty rows);
chunk sizes divide e_pad, do not, and exceed it.  Inputs are made with
numpy from a seed and handed to both.

Tolerances: float32 max |port - jax| <= 1e-5 * max(1, max |jax|) (the same
float32 messages summed in another order); bfloat16 inputs 2e-2 of the
same scale (both widen them to float32 before any product); gradients
1e-4 * max(1, max |jax|)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import fusion as JF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as JS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import chunked as JC  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import chunked as TC  # noqa: E402
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


def _chunks(e_pad):
    """Chunk sizes that divide e_pad, do not, and exceed it."""
    assert e_pad % 128 == 0 and e_pad % 100
    return (128, 100, 10 ** 6)


def test_pad_to_chunks_matches_jax():
    hj, ht = _graphs(symmetric_norm=True)
    gj, gt = hj.to_device(), ht.to_device(CPU)
    for chunk in _chunks(ht.e_pad):
        want = JC._pad_to_chunks(chunk, hj.n_node, gj.senders, gj.receivers,
                                 gj.edge_weight, gj.edge_mask)
        got = TC._pad_to_chunks(chunk, ht.n_node, gt.senders, gt.receivers,
                                gt.edge_weight, gt.edge_mask)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_spmm_chunked_matches_jax(dtn):
    hj, ht = _graphs(symmetric_norm=True)
    gj, gt = hj.to_device(), ht.to_device(CPU)
    tdt, jdt = DTYPES[dtn]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((ht.n_node, 24)).astype(np.float32)
    ev = rng.standard_normal(ht.e_pad).astype(np.float32)
    for chunk in _chunks(ht.e_pad):
        for vals in (None, ev):
            got = TC.spmm_chunked(
                gt, torch.tensor(x).to(tdt), chunk=chunk,
                edge_vals=None if vals is None else torch.tensor(vals))
            want = JC.spmm_chunked(
                gj, jnp.asarray(x).astype(jdt), chunk=chunk,
                edge_vals=None if vals is None else jnp.asarray(vals))
            assert got.dtype == torch.float32
            _close(got, want, TOL[dtn])


def _gat_inputs(n, H, D, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, H * D)).astype(np.float32),
            rng.standard_normal((n, H)).astype(np.float32),
            rng.standard_normal((n, H)).astype(np.float32))


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,D", [(2, 4), (1, 8)])
def test_gat_chunked_matches_jax(dtn, H, D):
    hj, ht = _graphs(add_self_loops=True)
    gj, gt = hj.to_device(), ht.to_device(CPU)
    tdt, jdt = DTYPES[dtn]
    h, a1, a2 = _gat_inputs(ht.n_node, H, D)
    for chunk in _chunks(ht.e_pad):
        got = TC.gat_chunked(gt, *(torch.tensor(v).to(tdt)
                                   for v in (h, a1, a2)), chunk=chunk)
        want = JC.gat_chunked(gj, *(jnp.asarray(v).astype(jdt)
                                    for v in (h, a1, a2)), chunk=chunk)
        assert got.dtype == torch.float32
        _close(got, want, TOL[dtn])


def test_gat_chunked_gradients_match_jax():
    """d sum(out^2) / d (h, a_src, a_dst) by autograd of the loop against
    ``jax.grad`` of JAX's scan, at a chunk that does not divide e_pad."""
    hj, ht = _graphs(add_self_loops=True)
    gj, gt = hj.to_device(), ht.to_device(CPU)
    H, D = 2, 4
    ins = _gat_inputs(ht.n_node, H, D, seed=2)
    want = jax.grad(lambda *a: jnp.sum(JC.gat_chunked(gj, *a, chunk=100)
                                       ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(v) for v in ins))
    tv = [torch.tensor(v, requires_grad=True) for v in ins]
    (TC.gat_chunked(gt, *tv, chunk=100) ** 2).sum().backward()
    for t, w in zip(tv, want):
        _close(t.grad, w, GRAD_TOL)


def _schedule(mod, graph, partition, tc):
    """``partition``'s blocks with the kernel kind on ``tc``, the rest op
    by op (as ``fusion._one_kind``, for either package)."""
    part = getattr(mod[0], partition)(graph)
    tiles = tuple(tc if mod[1].classify_block(graph, b, tc)[0] != "xla"
                  else mod[0].TileConfig(path=mod[0].PATH_XLA) for b in part)
    return mod[0].Schedule(blocks=part, tiles=tiles)


NETS = {"GCN": "aggregation_partition", "GraphSAGE": "aggregation_partition",
        "GAT": "pattern_partition"}


@pytest.mark.parametrize("network", sorted(NETS))
@pytest.mark.parametrize("tile_edges", [1, 8])
def test_lower_schedule_stream_matches_jax(network, tile_edges):
    """The stream kinds (``tile_edges * 2048``-edge chunks: several, and
    one past e_pad) in float32 and bfloat16, and the float32 gradient in
    x, against the JAX package's lowering of the same schedule."""
    hj, ht = _graphs(add_self_loops=True, symmetric_norm=True)
    gj = J.build_op_graph(network, 12, 8, heads=2)
    gt = T.build_op_graph(network, 12, 8, heads=2)
    tc = TS.TileConfig(tile_edges=tile_edges, path=TS.PATH_STREAM)
    sched = _schedule((TS, TF), gt, NETS[network], tc)
    want_kind = "gat_stream" if network == "GAT" else "spmm_stream"
    pj = J.init_params(gj, jax.random.key(0))
    pt = T.params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, CPU)
    x = np.random.default_rng(3).standard_normal(
        (ht.n_node, 12)).astype(np.float32)
    sj = JS.Schedule.from_key(sched.key())
    for dtn, (tdt, jdt) in DTYPES.items():
        cd_t = None if dtn == "float32" else tdt
        cd_j = None if dtn == "float32" else jdt
        fn = TF.lower_schedule(gt, sched, ht, cd_t, device=CPU)
        assert [p[0] for p in fn.plans].count(want_kind) == 1
        fj = JF.lower_schedule(gj, sj, hj, cd_j, interpret=True)
        _close(fn(pt, ht.to_device(CPU), torch.tensor(x)),
               fj(pj, hj.to_device(), jnp.asarray(x)), TOL[dtn])
    xt = torch.tensor(x, requires_grad=True)
    fn_f = TF.lower_schedule(gt, sched, ht, device=CPU)
    (fn_f(pt, ht.to_device(CPU), xt) ** 2).sum().backward()
    fj = JF.lower_schedule(gj, sj, hj, interpret=True)
    want = jax.grad(lambda v: jnp.sum(fj(pj, hj.to_device(), v) ** 2))(
        jnp.asarray(x))
    _close(xt.grad, want, GRAD_TOL)
