"""PyTorch port: GAT attention (K3 edge tiles, K4 dense blocks, the hybrid)
against the JAX package's kernels in Pallas interpret mode on the CPU.

Tolerance in float32: max |port - jax| <= 1e-5 * max(1, max |jax|); both
compute the same shift-bound terms and sum them in another order."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import dense as JDn  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import gat as JA  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TDn  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as TA  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

F32_TOL = 1e-5
CPU = "cpu"     # the port's entry points default to the CUDA card
# (HD, H): the narrow GAT-Cora layer-3 shape and the wide Reddit shape
SHAPES = [(16, 16), (128, 4)]


def _close(port, ref, tol=F32_TOL):
    port = port.float().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _hosts():
    s, r, n, meta = fixtures.edge_case_graph(seed=0)
    kw = dict(edge_pad_multiple=128)
    return (J.build_host_graph(s, r, n, **kw),
            T.build_host_graph(s, r, n, **kw), meta)


def _inputs(n, HD, H, seed=3, gap=False):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, HD)).astype(np.float32)
    a_s = (fixtures.gap_a_src(rng, n, H) if gap
           else rng.standard_normal((n, H)).astype(np.float32))
    a_d = rng.standard_normal((n, H)).astype(np.float32)
    w = (rng.standard_normal((HD, H)) / np.sqrt(HD)).astype(np.float32)
    return h, a_s, a_d, w


def _tiles(hj, ht):
    geo = dict(block_rows=128, block_cols=128, tile_edges=128,
               unit_weight=True)
    return J.tile_graph(hj, **geo), T.tile_graph(ht, **geo, device=CPU)


@pytest.mark.parametrize("HD,H", SHAPES)
@pytest.mark.parametrize("mode", ["derive", "values"])
@pytest.mark.parametrize("normalize", [True, False])
def test_gat_forward_matches_jax(HD, H, mode, normalize):
    hj, ht, _ = _hosts()
    tj, tt = _tiles(hj, ht)
    h, a_s, a_d, w = _inputs(hj.n_node, HD, H)
    if mode == "derive":
        yj = JA._gat_forward(tj, jnp.asarray(h), None, jnp.asarray(a_d),
                             w_asrc=jnp.asarray(w), normalize=normalize,
                             interpret=True)
        yt = TA._gat_forward(tt, torch.from_numpy(h), None,
                             torch.from_numpy(a_d), w_asrc=torch.from_numpy(w),
                             normalize=normalize)
    else:
        yj = JA._gat_forward(tj, jnp.asarray(h), jnp.asarray(a_s),
                             jnp.asarray(a_d), normalize=normalize,
                             interpret=True)
        yt = TA._gat_forward(tt, torch.from_numpy(h), torch.from_numpy(a_s),
                             torch.from_numpy(a_d), normalize=normalize)
    assert yt.shape == (hj.n_node, HD if normalize else HD + H)
    _close(yt, yj)


def test_gat_shift_gap_row_collapses_like_jax():
    """A row whose sources sit far below the global a_src max underflows to
    zero attention in the kernels of both packages (not in the exact
    per-row-max reference); gat_shift_gap reports the same gap."""
    hj, ht, meta = _hosts()
    tj, tt = _tiles(hj, ht)
    h, a_s, a_d, _ = _inputs(hj.n_node, 16, 4, gap=True)
    yj = JA.gat_attention(tj, jnp.asarray(h), jnp.asarray(a_s),
                          jnp.asarray(a_d), interpret=True)
    yt = TA.gat_attention(tt, torch.from_numpy(h), torch.from_numpy(a_s),
                          torch.from_numpy(a_d))
    _close(yt, yj)
    row = meta["gap_row"]
    assert float(yt[row].abs().max()) == 0.0
    exact = TA._gat_reference(tt, torch.from_numpy(h), torch.from_numpy(a_s),
                              torch.from_numpy(a_d), 0.2)
    assert float(exact[row].abs().max()) > 0.0
    _close(exact, JA._gat_reference(tj, jnp.asarray(h), jnp.asarray(a_s),
                                    jnp.asarray(a_d), 0.2))
    gj = float(JA.gat_shift_gap(hj.to_device(), jnp.asarray(a_s)))
    gt = float(TA.gat_shift_gap(ht.to_device(CPU), torch.from_numpy(a_s)))
    assert gt > TA.SHIFT_GAP_SAFE
    np.testing.assert_allclose(gt, gj, rtol=1e-6)


@pytest.mark.parametrize("layout", ["cr", "rc"])
@pytest.mark.parametrize("HD,H", SHAPES)
def test_gat_dense_partial_matches_jax(layout, HD, H):
    hj, ht, _ = _hosts()
    kw = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=64,
              unit_weight=True, values_dtype=np.int8, block_layout=layout)
    yj_, yt_ = JG.hybrid_graph(hj, **kw), TG.hybrid_graph(ht, **kw, device=CPU)
    h, a_s, a_d, _ = _inputs(hj.n_node, HD, H)
    ms = a_s.max(0, keepdims=True)
    pj = JDn.gat_dense_partial(yj_.dense, jnp.asarray(h), jnp.asarray(a_s),
                               jnp.asarray(a_d), jnp.asarray(ms),
                               interpret=True)
    pt = TDn.gat_dense_partial(yt_.dense, torch.from_numpy(h),
                               torch.from_numpy(a_s), torch.from_numpy(a_d),
                               torch.from_numpy(ms))
    _close(pt, pj)
    assert float(pt[512:].abs().max()) == 0.0      # unvisited stripe
    if layout == "cr":
        pjt = JDn.gat_dense_partial_t(yj_.dense, jnp.asarray(h),
                                      jnp.asarray(a_s), jnp.asarray(a_d),
                                      jnp.asarray(ms), interpret=True)
        _close(TDn.gat_dense_partial_t(
            yt_.dense, torch.from_numpy(h), torch.from_numpy(a_s),
            torch.from_numpy(a_d), torch.from_numpy(ms)), pjt)


@pytest.mark.parametrize("mode", ["derive", "values"])
def test_gat_hybrid_matches_jax(mode):
    """The 200-copy pair puts 127 in a dense count and merges the rest into
    one tail slot of multiplicity 73: both partials scale by it."""
    hj, ht, _ = _hosts()
    kw = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=64,
              sparse_block_rows=256, sparse_block_cols=128, unit_weight=True,
              values_dtype=np.int8, block_layout="cr")
    yj_, yt_ = JG.hybrid_graph(hj, **kw), TG.hybrid_graph(ht, **kw, device=CPU)
    assert float(yt_.tiles.weight.float().max()) == 73.0
    h, a_s, a_d, w = _inputs(hj.n_node, 128, 4)
    if mode == "derive":
        oj = JDn.gat_hybrid(yj_, hj.to_device(), jnp.asarray(h), None,
                            jnp.asarray(a_d), w_asrc=jnp.asarray(w),
                            interpret=True)
        ot = TDn.gat_hybrid(yt_, ht.to_device(CPU), torch.from_numpy(h), None,
                            torch.from_numpy(a_d), w_asrc=torch.from_numpy(w))
    else:
        oj = JDn.gat_hybrid(yj_, hj.to_device(), jnp.asarray(h),
                            jnp.asarray(a_s), jnp.asarray(a_d),
                            interpret=True)
        ot = TDn.gat_hybrid(yt_, ht.to_device(CPU), torch.from_numpy(h),
                            torch.from_numpy(a_s), torch.from_numpy(a_d))
    _close(ot, oj)
    # inside the shift-bound domain the exact full-graph softmax agrees
    ref = TDn._gat_reference_g(ht.to_device(CPU), torch.from_numpy(h),
                               torch.from_numpy(a_s) if mode == "values"
                               else torch.from_numpy(h) @ torch.from_numpy(w),
                               torch.from_numpy(a_d), 0.2, weighted=False)
    _close(ot, ref.numpy(), tol=1e-4)
    _close(ref, JDn._gat_reference_g(
        hj.to_device(), jnp.asarray(h),
        jnp.asarray(a_s) if mode == "values" else jnp.asarray(h @ w),
        jnp.asarray(a_d), 0.2, weighted=False), tol=1e-4)


def test_gat_bf16_rounding_points_match_jax():
    """bf16 h: p*hs and p round to bf16 before the f32 sums (tail), p before
    the num product (dense), as in the TPU kernels.  Bound 1e-3 relative:
    exp and the derived a_s may differ in their last f32 bit between the
    two libraries, so a term near a bf16 rounding boundary may round the
    other way; one flip moves one term of a row sum by 2^-8 of itself
    (measured here: 4e-7)."""
    hj, ht, _ = _hosts()
    kw = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=64,
              unit_weight=True, values_dtype=np.int8, block_layout="cr")
    yj_, yt_ = JG.hybrid_graph(hj, **kw), TG.hybrid_graph(ht, **kw, device=CPU)
    h, _, a_d, w = _inputs(hj.n_node, 128, 4)
    bf = jnp.bfloat16
    oj = JDn.gat_hybrid(yj_, hj.to_device(), jnp.asarray(h, bf), None,
                        jnp.asarray(a_d, bf), w_asrc=jnp.asarray(w, bf),
                        interpret=True)
    ot = TDn.gat_hybrid(yt_, ht.to_device(CPU), torch.from_numpy(h).bfloat16(),
                        None, torch.from_numpy(a_d).bfloat16(),
                        w_asrc=torch.from_numpy(w).bfloat16())
    _close(ot, oj, tol=1e-3)


def test_gat_matchers_match_jax():
    for HD, heads, reorder in ((16, 4, False), (16, 4, True), (41, 1, False)):
        gj = J.build_op_graph("GAT", 12, HD, heads=heads, reorder=reorder)
        gt = T.build_op_graph("GAT", 12, HD, heads=heads, reorder=reorder)
        pj, pt = JA.find_gat_chain(gj), TA.find_gat_chain(gt)
        assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
        blk = sorted(pt.ops)
        assert TA.match_gat_block(gt, blk) is not None
        assert (TA.match_gat_layer(gt, [o.op_id for o in gt.ops]) is None) \
            == (JA.match_gat_layer(gj, [o.op_id for o in gj.ops]) is None)
