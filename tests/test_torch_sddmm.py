"""PyTorch port, SDDMM against the JAX package: ``sddmm`` on per-tile and
grouped tilings (K11's and K12's plain versions against the TPU kernels in
interpret mode), ``tiles_to_edges`` / ``edges_to_tiles``, the
differentiable ``sddmm_edges`` (MUL and ADD), ``sddmm_dense_blocks``, and
the ``sddmm`` kind of ``lower_schedule`` on GAT's logit block.  Inputs are
made with numpy from a seed and handed to both packages.

Tolerances: float32 max |port - jax| <= 1e-5 * max(1, max |jax|); the
dots of bfloat16 inputs are held to the same bound, since both packages
form the same exact float32 products (and, on grouped tilings, the same
bf16 roundings of them) and differ only in the order of the float32 sums;
``sddmm_dense_blocks`` in bfloat16 (one rounding of each float32 dot)
within 1e-2 of each row's largest |jax|; gradients 1e-4 * max(1, max
|jax|)."""
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
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import dense as JD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import sddmm as JSd  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sddmm as TSd  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = 1e-4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TILE = dict(block_rows=128, block_cols=128, tile_edges=64)
GROUPED = dict(block_rows=32, block_cols=64, tile_edges=32, group=2)


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
    s, r, n, _ = fixtures.edge_case_graph()
    kw = dict(edge_pad_multiple=128, **kw)
    return J.build_host_graph(s, r, n, **kw), TG.build_host_graph(s, r, n,
                                                                  **kw)


def _tilings(kind):
    """(jax tiling, port tiling, jax host graph, port host graph); the
    per-tile pair has its tile 1 marked dead in both."""
    hj, ht = _graphs()
    if kind == "grouped":
        return (JG.tile_graph_grouped(hj, **GROUPED),
                TG.tile_graph_grouped(ht, **GROUPED, device=CPU), hj, ht)
    tj = JG.tile_graph(hj, unit_weight=True, **TILE)
    tt = fixtures._dead_tile(TG.tile_graph(ht, unit_weight=True, **TILE,
                                           device=CPU))
    import dataclasses
    tj = dataclasses.replace(tj, tile_cb=jnp.asarray(tt.tile_cb.numpy()))
    return tj, tt, hj, ht


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [1, 2, 32])
@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("kind", ["tiles", "grouped"])
def test_sddmm_matches_jax(kind, heads, P, dtn):
    """K11 / K12 plain versions (through ``sddmm``'s dispatch) against the
    TPU kernels.  Pad slots read exact zeros.  The per-tile tiling has a
    dead tile (cb = -1) whose slots look live: the port reads zeros there,
    the TPU kernel's clamped block index reads column block 0, so that
    tile is compared with zeros and the rest with JAX."""
    tj, tt, hj, _ = _tilings(kind)
    tdt, jdt = DTYPES[dtn]
    rng = np.random.default_rng(heads * 100 + P)
    xs, xd = (rng.standard_normal((hj.n_node, heads * P)).astype(np.float32)
              for _ in range(2))
    want = np.asarray(JSd.sddmm(tj, jnp.asarray(xs, jdt), jnp.asarray(xd, jdt),
                                heads=heads, interpret=True))
    got = TSd.sddmm(tt, torch.tensor(xs, dtype=tdt),
                    torch.tensor(xd, dtype=tdt), heads=heads)
    assert got.dtype == torch.float32 and got.shape == want.shape
    pad = (tt.dst_local >= tt.block_rows).reshape(got.shape[1:]).expand(
        got.shape)
    assert float(got[pad].abs().max()) == 0.0
    if kind == "tiles":
        assert float(got[:, 1].abs().max()) == 0.0
        keep = np.arange(want.shape[1]) != 1
        got, want = got[:, keep], want[:, keep]
    _close(got, want)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_grouped_rounds_products_in_bf16(dtn):
    """The grouped kernel rounds each product to the input dtype before its
    float32 head sum, the per-tile one does not: over the same edges the
    two agree to float32 rounding in float32 and differ by that rounding in
    bfloat16, where each grouped dot equals the float32 sum of the
    bf16-rounded products."""
    hj, ht = _graphs()
    tt = TG.tile_graph(ht, unit_weight=True, **TILE, device=CPU)
    tg = TG.tile_graph_grouped(ht, **GROUPED, device=CPU)
    tdt, _ = DTYPES[dtn]
    rng = np.random.default_rng(9)
    xs, xd = (torch.tensor(rng.standard_normal((ht.n_node, 64)), dtype=tdt)
              for _ in range(2))
    e_tiles, e_grp = (TSd.tiles_to_edges(t, TSd.sddmm(t, xs, xd, heads=2),
                                         ht.e_pad) for t in (tt, tg))
    s, r = (torch.as_tensor(a[: ht.n_edge].astype(np.int64))
            for a in (ht.senders, ht.receivers))
    p = (xs[s].float() * xd[r].float()).view(-1, 2, 32)
    _close(e_tiles[: ht.n_edge], p.sum(2))
    _close(e_grp[: ht.n_edge], p.to(tdt).float().sum(2))
    diff = float((e_grp - e_tiles).abs().max())
    if dtn == "float32":
        _close(e_grp, e_tiles)
    else:
        assert diff > 0.0
        assert diff <= 2.0 ** -8 * float(p.abs().sum(2).max())


@pytest.mark.parametrize("kind", ["tiles", "grouped"])
def test_tiles_to_edges_and_back_match_jax(kind):
    """Tile-layout values to edge order (pad slots alias the last edge id
    and add zeros) and per-edge values to tile layout, against JAX."""
    tj, tt, hj, _ = _tilings(kind)
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((3,) + tuple(tt.src_local.reshape(
        tt.src_local.shape[0], -1).shape)).astype(np.float32)
    pad = (tt.dst_local >= tt.block_rows).reshape(vals.shape[1:]).numpy()
    vals[:, pad] = 0.0
    got = TSd.tiles_to_edges(tt, torch.tensor(vals), hj.e_pad)
    want = JSd.tiles_to_edges(tj, jnp.asarray(vals), hj.e_pad)
    assert got.shape == (hj.e_pad, 3)
    _close(got, want, 0.0)
    ev = rng.standard_normal((hj.e_pad, 2)).astype(np.float32)
    got = TSd.edges_to_tiles(tt, torch.tensor(ev))
    _close(got, JSd.edges_to_tiles(tj, jnp.asarray(ev)), 0.0)
    assert got.shape == tuple(tt.edge_id.shape) + (2,)


@pytest.mark.parametrize("compute", ["MUL", "ADD"])
@pytest.mark.parametrize("kind", ["tiles", "grouped"])
def test_sddmm_edges_and_grads_match_jax(kind, compute):
    """``sddmm_edges``: forward in edge order (0 on padding edges) and the
    gradients of both operands against ``jax.grad`` of the JAX function,
    float32; the forward also in bfloat16."""
    tj, tt, hj, ht = _tilings(kind)
    if kind == "tiles":
        # a real edge in a dead tile has no slot that computes it: use
        # tile_graph's own tiling here
        tj = JG.tile_graph(hj, unit_weight=True, **TILE)
        tt = TG.tile_graph(ht, unit_weight=True, **TILE, device=CPU)
    gj, gt = hj.to_device(), ht.to_device(CPU)
    rng = np.random.default_rng(11)
    xs, xd = (rng.standard_normal((hj.n_node, 6)).astype(np.float32)
              for _ in range(2))
    gy = rng.standard_normal((hj.e_pad, 6)).astype(np.float32)

    def j_loss(a, b):
        y = JSd.sddmm_edges(tj, gj, a, b, compute, interpret=True)
        return jnp.vdot(y, jnp.asarray(gy))

    want = JSd.sddmm_edges(tj, gj, jnp.asarray(xs), jnp.asarray(xd), compute,
                           interpret=True)
    dj = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(xs), jnp.asarray(xd))
    tv = [torch.tensor(a, requires_grad=True) for a in (xs, xd)]
    y = TSd.sddmm_edges(tt, gt, *tv, compute)
    assert y.shape == (hj.e_pad, 6)
    assert float(y[~gt.edge_mask].abs().max()) == 0.0
    _close(y, want)
    (y * torch.tensor(gy)).sum().backward()
    for a, b in zip(tv, dj):
        _close(a.grad, b, GRAD_TOL)
    yb = TSd.sddmm_edges(tt, gt, torch.tensor(xs, dtype=torch.bfloat16),
                         torch.tensor(xd, dtype=torch.bfloat16), compute)
    wb = JSd.sddmm_edges(tj, gj, jnp.asarray(xs, jnp.bfloat16),
                         jnp.asarray(xd, jnp.bfloat16), compute,
                         interpret=True)
    _close(yb, wb)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_sddmm_dense_blocks_matches_jax(dtn):
    """All R*C pair dots of every 'rc' dense block, in x's dtype."""
    hj, ht = _graphs()
    split = dict(block_rows=128, block_cols=128, tile_edges=64, min_nnz=64,
                 values_dtype=np.int8)
    bj = JG.hybrid_graph(hj, **split).dense
    bt = TG.hybrid_graph(ht, **split, device=CPU).dense
    assert bt.n_blocks > 0
    tdt, jdt = DTYPES[dtn]
    rng = np.random.default_rng(6)
    xs, xd = (rng.standard_normal((hj.n_node, 24)).astype(np.float32)
              for _ in range(2))
    want = JD.sddmm_dense_blocks(bj, jnp.asarray(xs, jdt),
                                 jnp.asarray(xd, jdt))
    got = TD.sddmm_dense_blocks(bt, torch.tensor(xs, dtype=tdt),
                                torch.tensor(xd, dtype=tdt))
    assert got.dtype == tdt and got.shape == (bt.n_blocks, 128, 128)
    if dtn == "float32":
        _close(got, want)
    else:
        g, w = (_np(a).reshape(-1, 128) for a in (got, want))
        scale = np.maximum(np.abs(w).max(1), 1e-6)
        assert float((np.abs(g - w).max(1) / scale).max()) <= TOL[dtn]
    with pytest.raises(ValueError, match="'rc'"):
        TD.sddmm_dense_blocks(TG.hybrid_graph(
            ht, **split, block_layout="cr", device=CPU).dense,
            torch.tensor(xs), torch.tensor(xd))


def _logit_schedule(mod, graph, tc):
    """GAT's logit block (scatter(C) + scatter(R) + apply_edge ADD) on
    ``tc``, every other op alone on the per-op path."""
    add = next(op for op in graph.ops
               if op.kind == ir.APPLY_EDGE and op.compute == ir.ADD
               and all(graph.by_id[i].kind == ir.SCATTER
                       for i in op.inputs if i >= 0) and len(op.inputs) == 2)
    block = sorted(add.inputs + [add.op_id])
    rest = [[op.op_id] for op in graph.ops if op.op_id not in block]
    part = tuple(tuple(b) for b in mod._order_blocks(graph, [block] + rest))
    return mod.Schedule(blocks=part, tiles=tuple(
        tc if list(b) == block else mod.TileConfig(path=mod.PATH_XLA)
        for b in part))


def test_lower_schedule_sddmm_kind_matches_jax():
    """GAT with its logit block on the ``sddmm`` kind (as
    tests/test_dense.py:212-245 builds it for the JAX package): the
    forward and every parameter's gradient against JAX's lowering."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, 300, 2000).astype(np.int32)
    r = rng.integers(0, 300, 2000).astype(np.int32)
    kw = dict(add_self_loops=True)
    hj, ht = J.build_host_graph(s, r, 300, **kw), TG.build_host_graph(
        s, r, 300, **kw)
    gj, gt = J.build_op_graph("GAT", 8, 8, heads=2), T.build_op_graph(
        "GAT", 8, 8, heads=2)
    sched = _logit_schedule(TS, gt, TS.TileConfig(32, 32, 64))
    assert TF.sddmm_schedules([gt], tile=TS.TileConfig(32, 32, 64)) == [sched]
    with pytest.raises(ValueError, match="logit"):
        TF.sddmm_schedules([T.build_op_graph("GCN", 8, 8)])
    assert [TF.classify_block(gt, b, t)[0] for b, t in
            zip(sched.blocks, sched.tiles)].count("sddmm") == 1
    fj = JF.lower_schedule(gj, JS.Schedule.from_key(sched.key()), hj,
                           interpret=True)
    fn = TF.lower_schedule(gt, sched, ht, device=CPU)
    assert [k for k, _, _, _ in fn.plans].count("sddmm") == 1
    pj = J.init_params(gj, jax.random.key(0))
    pt = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in pj.items()}
    x = rng.standard_normal((300, 8)).astype(np.float32)
    out = fn(pt, ht.to_device(CPU), torch.tensor(x))
    _close(out, fj(pj, hj.to_device(), jnp.asarray(x)))
    want = jax.grad(lambda p: jnp.sum(fj(p, hj.to_device(),
                                         jnp.asarray(x)) ** 2))(pj)
    (out ** 2).sum().backward()
    for k, p in pt.items():
        _close(p.grad, want[k], GRAD_TOL)
    ob = TF.lower_schedule(gt, sched, ht, torch.bfloat16, device=CPU)(
        pt, ht.to_device(CPU), torch.tensor(x))
    wb = JF.lower_schedule(gj, JS.Schedule.from_key(sched.key()), hj,
                           jnp.bfloat16, interpret=True)(
        pj, hj.to_device(), jnp.asarray(x))
    _close(ob, wb, TOL["bfloat16"])


def test_sddmm_rejects_what_it_cannot_run():
    _, tt, hj, _ = _tilings("tiles")
    x = torch.zeros((hj.n_node, 6))
    with pytest.raises(ValueError, match="heads"):
        TSd.sddmm(tt, x, x, heads=4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        TSd.sddmm((tt,), x, x)
    with pytest.raises(ValueError, match="MUL or ADD"):
        TSd.sddmm_edges(tt, None, x, x, "SUB")
