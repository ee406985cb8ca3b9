"""PyTorch port: the whole-layer GAT kind (K14 through its plain version)
and the backward of the ``gat`` kind (``_gat_vjp``: K5 and K6 through
their plain versions, or the edge formulation) against the JAX package,
whose Pallas kernels run in interpret mode on the CPU.  Inputs are made
with numpy from a seed and handed to both.

Tolerance: max |port - jax| <= 1e-5 * max(1, max |jax|) in float32; in
bfloat16 1e-3 relative, the bound of ``test_torch_gat.py``'s bf16 test
(exp and the sums may differ in their last f32 bit between the libraries,
so a value near a bf16 rounding boundary may round the other way; one flip
moves one term by 2^-8 of itself)."""
import dataclasses

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
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.lower import init_params as j_init  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.lower import lower as j_lower  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import gat as JA  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.lower import lower as t_lower  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.lower import params_from_numpy  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as TP  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as TA  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 1e-3}
CPU = "cpu"     # the port's entry points default to the CUDA card
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GEO = dict(block_rows=128, block_cols=128, tile_edges=128, unit_weight=True)


def _close(port, ref, tol):
    port = port.detach().float().cpu().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


@pytest.fixture(scope="module")
def edge_tiles():
    """The fixture's edge-case graph tiled in both packages, tile 1 dead
    (cb = -1).  The port's dead tile keeps slots that look live, which it
    must skip; JAX's K14 reads a dead tile's column block at index 0 and
    masks only pad destinations, so its copy has pad slots there."""
    s, r, n, meta = fixtures.edge_case_graph()
    hj = J.build_host_graph(s, r, n, edge_pad_multiple=128)
    ht = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    tj, tt = J.tile_graph(hj, **GEO), TG.tile_graph(ht, **GEO, device=CPU)
    tt = fixtures._dead_tile(tt)
    cb, sl, dl = (np.asarray(a).copy() for a in (tj.tile_cb, tj.src_local,
                                                  tj.dst_local))
    cb[1], sl[1], dl[1] = -1, tj.block_cols, tj.block_rows
    tj = dataclasses.replace(tj, tile_cb=jnp.asarray(cb),
                             src_local=jnp.asarray(sl),
                             dst_local=jnp.asarray(dl))
    assert int((tt.dst_local[1] < tt.block_rows).sum()) > 0
    return tj, tt, n


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,HD,F", [(1, 41, 64), (2, 16, 24), (4, 128, 43)])
@pytest.mark.parametrize("sf", fixtures.SFS)
def test_gat_layer_plain_matches_jax_kernel(edge_tiles, dtn, H, HD, F, sf):
    """K14's plain version against ``_gat_layer_forward(interpret=True)``
    on the edge cases: pad slots, a dead tile, empty rows, the hot pair's
    200 slots, a row above the clamp and one whose p underflows."""
    tj, tt, n = edge_tiles
    tdt, jdt = DTYPES[dtn]
    arrays = fixtures.layer_inputs(
        np.random.default_rng(H * 100 + HD), n, F, HD, H,
        knobs={fixtures.CLAMP_ROW: 2.0, fixtures.GAP_ROW: -6.0})
    yj = JA._gat_layer_forward(tj, *(jnp.asarray(a, jdt) for a in arrays),
                               final_sf=sf, interpret=True)
    ins = [torch.from_numpy(a).to(tdt) for a in arrays]
    yt = TA._gat_layer_plain(tt, *ins, final_sf=sf)
    assert yt.shape == (n, HD)
    _close(yt, yj, TOL[dtn])
    assert float(yt[512:599].abs().max()) == pytest.approx(
        float(TA._sf_apply(torch.zeros(()), sf, 0.2).abs()))   # empty rows
    # the knobs reach both ends of the static-shift domain in head 0
    hq, a_s, a_d = TA._gat_layer_project_plain(*ins)
    e = TA._leaky(a_s.float()[:, 0][None] + a_d[:, 0][:, None], 0.2)
    src = torch.from_numpy(fixtures.edge_case_graph()[0].astype(np.int64))
    dst = torch.from_numpy(fixtures.edge_case_graph()[1].astype(np.int64))
    e_edge = e[dst, src]
    assert float(e_edge[dst == fixtures.CLAMP_ROW].max()) > TA.SHIFT + 60
    assert float(e_edge[dst == fixtures.GAP_ROW].max()) < TA.SHIFT - 104


def test_gat_layer_tiles_takes_its_plain_version_on_cpu(edge_tiles):
    _, tt, n = edge_tiles
    ins = [torch.from_numpy(a) for a in fixtures.layer_inputs(
        np.random.default_rng(0), n, 20, 16, 2)]
    TA.gat_layer_tiles.launches = 0
    y = TA.gat_layer_tiles(tt, *ins, final_sf="elu")
    assert torch.equal(y, TA._gat_layer_plain(tt, *ins, final_sf="elu"))
    assert TA.gat_layer_tiles.launches == 0
    with pytest.raises(ValueError, match="unsupported sf"):
        TA.gat_layer_tiles(tt, *ins, final_sf="tanh")


def test_fixture_layer_cases_run_on_cpu():
    """The K14 / K15 case list (stage checks, every sf, both dtypes) runs
    on the CPU, where the wrappers take their plain versions; a fault in
    one output cell fails the row-scaled check."""
    seen = set()
    for c in fixtures.layer_kernel_cases(CPU):
        fixtures.check_kernel(c)
        seen.add((c.kernel, c.dtype_name))
    assert seen == {(k, d) for k in fixtures.LAYER_KERNELS
                    for d in fixtures.KERNEL_TOL}
    c = next(c for c in fixtures.layer_kernel_cases(CPU)
             if c.case.startswith("walk"))
    bad = c.out.clone()
    row = int(c.ref.abs().amax(dim=1).argmax())
    bad[row, 0] += 0.05 * float(c.ref[row].abs().max())
    with pytest.raises(AssertionError):
        fixtures.check_kernel(c._replace(out=bad))


def _graphs(rng, n, e):
    from conftest import small_graph
    s, r = small_graph(rng, n=n, e=e)
    hj = J.build_host_graph(s, r, n, add_self_loops=True, symmetric_norm=True)
    ht = TG.build_host_graph(s, r, n, add_self_loops=True,
                             symmetric_norm=True)
    return hj, ht


def _models(in_w, out_w, **kw):
    gj = J.build_op_graph("GAT", in_w, out_w, **kw)
    gt = T.build_op_graph("GAT", in_w, out_w, **kw)
    pj = j_init(gj, jax.random.key(0))
    pt = params_from_numpy({k: np.asarray(v) for k, v in pj.items()},
                           device=CPU)
    return gj, gt, pj, pt


def test_layer_partition_lowering_matches_jax(rng):
    """Port of ``test_schedule.py::test_gat_layer_megakernel_matches_xla``:
    the whole layer on ``layer_partition`` lowers to ``gat_layer`` and
    equals JAX's lowering of it (and the per-op path inside the shift
    domain)."""
    hj, ht = _graphs(rng, 50, 250)
    gj, gt, pj, pt = _models(12, 8, heads=2, final_sf="elu")
    x = rng.normal(size=(hj.n_node, 12)).astype(np.float32)
    part = TS.layer_partition(gt)
    assert part == JS.layer_partition(gj) and len(part) == 1
    tc = TS.TileConfig(block_rows=32, block_cols=32, tile_edges=128)
    assert TF.classify_block(gt, part[0], tc)[0] == "gat_layer"
    fj = JF.lower_schedule(gj, JS.Schedule(blocks=part, tiles=(
        JS.TileConfig(32, 32, 128),)), hj, interpret=True)
    ft = TF.lower_schedule(gt, TS.Schedule(blocks=part, tiles=(tc,)), ht,
                           device=CPU)
    yj = fj(pj, hj.to_device(), jnp.asarray(x))
    yt = ft(pt, ht.to_device(CPU), torch.from_numpy(x))
    _close(yt, yj, TOL["float32"])
    _close(yt, j_lower(gj)(pj, hj.to_device(), jnp.asarray(x)), 2e-4)


def test_layer_partition_gradients_match_jax(rng):
    """Port of ``test_schedule.py::test_gat_layer_megakernel_gradients``:
    the layer's backward is autograd of the exact edge formulation in both
    packages."""
    hj, ht = _graphs(rng, 40, 200)
    gj, gt, pj, pt = _models(8, 8, heads=2)
    x = rng.normal(size=(hj.n_node, 8)).astype(np.float32)
    part = TS.layer_partition(gt)
    fj = JF.lower_schedule(gj, JS.Schedule(blocks=part, tiles=(
        JS.TileConfig(32, 32, 128),)), hj, interpret=True)
    ft = TF.lower_schedule(gt, TS.Schedule(blocks=part, tiles=(
        TS.TileConfig(32, 32, 128),)), ht, device=CPU)
    gdj = jax.grad(lambda p: jnp.sum(fj(p, hj.to_device(),
                                        jnp.asarray(x)) ** 2))(pj)
    pv = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    (ft(pv, ht.to_device(CPU), torch.from_numpy(x)) ** 2).sum().backward()
    for k in gdj:
        _close(pv[k].grad, gdj[k], TOL["float32"])


@pytest.mark.parametrize("mode", ["derive", "values"])
@pytest.mark.parametrize("twin", [True, False])
def test_gat_attention_grads_match_jax(monkeypatch, mode, twin):
    """``gat_attention`` gradients against ``jax.grad`` of JAX's: with g,
    tg_t and ev_perm_t both take the tile-domain backward (K5, K6), without
    them autograd of the edge formulation; derive mode adds dh += das wᵀ
    and dw = hᵀ das in float32."""
    s, r, n, _ = fixtures.edge_case_graph()
    hj = J.build_host_graph(s, r, n, edge_pad_multiple=128)
    ht = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    tj, tt = J.tile_graph(hj, **GEO), TG.tile_graph(ht, **GEO, device=CPU)
    extra_j, extra_t = {}, {}
    if twin:
        hj_t, pj_ = JG.transpose_host_graph(hj)
        ht_t, pt_ = TG.transpose_host_graph(ht)
        extra_j = dict(g=hj.to_device(), tg_t=J.tile_graph(hj_t, **GEO),
                       ev_perm_t=jnp.asarray(pj_))
        extra_t = dict(g=ht.to_device(CPU),
                       tg_t=TG.tile_graph(ht_t, **GEO, device=CPU),
                       ev_perm_t=torch.from_numpy(pt_))
    rng = np.random.default_rng(5)
    H, HD = 4, 32
    h = rng.standard_normal((n, HD)).astype(np.float32)
    a_s = rng.standard_normal((n, H)).astype(np.float32)
    a_d = rng.standard_normal((n, H)).astype(np.float32)
    w = (rng.standard_normal((HD, H)) / np.sqrt(HD)).astype(np.float32)
    gy = rng.standard_normal((n, HD)).astype(np.float32)
    side = w if mode == "derive" else a_s

    def fj(h_, s_, d_):
        kw = dict(w_asrc=s_) if mode == "derive" else dict(a_src=s_)
        y = JA.gat_attention(tj, h_, a_dst=d_, heads=H, interpret=True,
                             **kw, **extra_j)
        return jnp.sum(y * jnp.asarray(gy))

    gj = jax.grad(fj, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                           for a in (h, side, a_d)))
    tv = [torch.from_numpy(a).requires_grad_(True) for a in (h, side, a_d)]
    kw = dict(w_asrc=tv[1]) if mode == "derive" else dict(a_src=tv[1])
    if twin:
        def boom(*a, **k):
            raise AssertionError("the edge formulation was differentiated")
        monkeypatch.setattr(TA, "_gat_reference", boom)
    y = TA.gat_attention(tt, tv[0], a_dst=tv[2], heads=H, **kw, **extra_t)
    (y * torch.from_numpy(gy)).sum().backward()
    for t, ref in zip(tv, gj):
        _close(t.grad, ref, TOL["float32"])


def _values_mode(g, ir_mod):
    """``g`` with its a_src op reading x instead of h: a_src is then no
    map of h, so the ``gat`` kind runs in values mode (a_src as values,
    its gradient das) instead of deriving a_s in the kernel."""
    ops = [dataclasses.replace(op) for op in g.ops]
    op = ops[1]
    assert op.compute == ir_mod.MM and op.inputs == [0]
    name, _, H = op.extra["weight"]
    ops[1] = dataclasses.replace(op, inputs=[ir_mod.X_INPUT],
                                 extra={"weight": (name, g.in_width, H)})
    return ir_mod.OpGraph(name=g.name + "-values", ops=ops,
                          in_width=g.in_width)


@pytest.mark.parametrize("mode", ["derive", "values"])
@pytest.mark.parametrize("twin", [True, False])
def test_gat_kind_gradients_match_jax(rng, mode, twin):
    """The ``gat`` kind lowered with and without ``build_transpose``: the
    model's loss gradients against ``jax.grad`` through JAX's
    ``lower_schedule(build_transpose=..., interpret=True)`` (the JAX one-hot
    training recipe, ``scripts/reddit_train.py``), in derive mode (the
    standard GAT graph, a_src = h w) and values mode (a_src = x w'); a
    gradient no longer raises."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu import ir as JI
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir as TI
    hj, ht = _graphs(rng, 60, 300)
    gj, gt = (J.build_op_graph("GAT", 12, 8, heads=2),
              T.build_op_graph("GAT", 12, 8, heads=2))
    if mode == "values":
        gj, gt = _values_mode(gj, JI), _values_mode(gt, TI)
    pj = j_init(gj, jax.random.key(0))
    pt = params_from_numpy({k: np.asarray(v) for k, v in pj.items()},
                           device=CPU)
    x = rng.normal(size=(hj.n_node, 12)).astype(np.float32)
    part = TS.pattern_partition(gt)
    tcs = [TS.TileConfig(32, 32, 128) if TF.classify_block(
        gt, b, TS.TileConfig(32, 32, 128))[0] == "gat"
        else TS.TileConfig(path=TS.PATH_XLA) for b in part]
    assert sum(t.kernel for t in tcs) == 1
    plan = next(TF.classify_block(gt, b, t)[1] for b, t in zip(part, tcs)
                if t.kernel)
    assert (gt.by_id[plan.asrc_op].inputs == [plan.h_op]) == (
        mode == "derive")
    sj = JS.Schedule(blocks=part, tiles=tuple(
        JS.TileConfig(32, 32, 128) if t.kernel
        else JS.TileConfig(path=JS.PATH_XLA) for t in tcs))
    fj = JF.lower_schedule(gj, sj, hj, interpret=True,
                           build_transpose=twin)
    ft = TF.lower_schedule(gt, TS.Schedule(blocks=part, tiles=tuple(tcs)),
                           ht, device=CPU, build_transpose=twin)
    twins = [tw for k, _, _, tw in ft.plans if k == "gat"]
    assert len(twins) == 1 and (twins[0] is not None) == twin
    gdj = jax.grad(lambda p: jnp.sum(fj(p, hj.to_device(),
                                        jnp.asarray(x)) ** 2))(pj)
    pv = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    (ft(pv, ht.to_device(CPU), torch.from_numpy(x)) ** 2).sum().backward()
    assert set(gdj) == set(pv)
    for k in gdj:
        _close(pv[k].grad, gdj[k], TOL["float32"])


def test_gat_layer_kind_is_lowered_not_refused():
    assert "gat_layer" not in TF.NOT_PORTED
    assert TF.KERNEL_VERSION >= 1


def test_leaky_relu_gradient_at_zero_is_jaxs():
    """``jax.nn.leaky_relu`` is where(v >= 0, v, slope v): its gradient at
    0 and at -0 is 1.  The port's per-op SF takes the same branch there, as
    its backward kernels do (``lraw >= 0``)."""
    v = np.array([-1.5, -0.0, 0.0, 2.0], np.float32)
    gj = jax.grad(lambda a: jnp.sum(jax.nn.leaky_relu(a, 0.2)))(
        jnp.asarray(v))
    vt = torch.from_numpy(v).requires_grad_(True)
    TP.special_function(vt, "leaky_relu", 0.2).sum().backward()
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(vt.grad.numpy(),
                                  np.float32([0.2, 1.0, 1.0, 1.0]))


@pytest.mark.parametrize("path", ["per-op", "gat_layer kind"])
def test_gat_gradients_match_jax_at_zero_logits(rng, path):
    """With att_dst = -att_src every self loop's logit a_s[v] + a_d[v] is
    exactly 0, where leaky relu has its kink: the per-op path and the
    ``gat_layer`` kind's backward (autograd of the edge formulation) take
    JAX's gradient there, leaky'(0) = 1, not the slope."""
    hj, ht = _graphs(rng, 40, 200)
    gj, gt, pj, pt = _models(8, 8, heads=2)
    (src,) = [k for k in pj if k.endswith("_asrc")]
    dst = src[:-4] + "adst"
    pj = dict(pj, **{dst: -pj[src]})
    pt = dict(pt, **{dst: -pt[src]})
    x = rng.normal(size=(hj.n_node, 8)).astype(np.float32)
    (wname,) = [k for k in pt if k.endswith("_w")]
    h = torch.from_numpy(x) @ pt[wname]
    assert bool(((h @ pt[src]) + (h @ pt[dst]) == 0).all())
    if path == "per-op":
        fj, ft = j_lower(gj), t_lower(gt)
    else:
        part = TS.layer_partition(gt)
        fj = JF.lower_schedule(gj, JS.Schedule(blocks=part, tiles=(
            JS.TileConfig(32, 32, 128),)), hj, interpret=True)
        ft = TF.lower_schedule(gt, TS.Schedule(blocks=part, tiles=(
            TS.TileConfig(32, 32, 128),)), ht, device=CPU)
    gdj = jax.grad(lambda p: jnp.sum(fj(p, hj.to_device(),
                                        jnp.asarray(x)) ** 2))(pj)
    pv = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    (ft(pv, ht.to_device(CPU), torch.from_numpy(x)) ** 2).sum().backward()
    for k in gdj:
        _close(pv[k].grad, gdj[k], TOL["float32"])
