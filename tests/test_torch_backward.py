"""PyTorch port, the backward of the hybrid path against the JAX package:
``transpose_host_graph``, the tail backward ``_gat_bwd_fused`` (kernels K5
and K6 through their plain versions), the dense backward ``gat_dense_bwd``
(K7 and K8), and the gradients of ``spmm_hybrid`` and ``gat_hybrid`` with
the transposed twin (``test_torch_train.py`` holds the whole models'
gradients).  JAX runs its Pallas kernels in interpret mode; inputs are made
with numpy from a seed and handed to both.

Tolerance: max |port - jax| <= 1e-5 * max(1, max |jax|) in float32 and
2e-2 * max(1, max |jax|) in bfloat16 (both round at the same points; a
value that lands on the other side of a bf16 rounding boundary moves one
term by up to 2^-8 of itself)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets import synthetic_coo  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import dense as JD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import gat as JA  # noqa: E402

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as TA  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as TSp  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CPU = "cpu"     # the port's entry points default to the CUDA card
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# edge-case graph split: community blocks dense, cross blocks in the tails
SPLIT = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=100,
             unit_weight=True, values_dtype=np.int8, block_layout="cr")
# the slice test's community graph (test_torch_slice.py) and its attention
# split ('cr', unit weight)
N, E = 600, 5000
ATT_SPLIT = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=60,
                 unit_weight=True, values_dtype=np.int8, block_layout="cr")


def _float_state() -> str:
    """The process state that can change float32 arithmetic, for a
    failure's message (never asserted on)."""
    mk = torch.backends.mkldnn
    return (f"torch.get_float32_matmul_precision() = "
            f"{torch.get_float32_matmul_precision()!r}, "
            f"torch.backends.fp32_precision = "
            f"{torch.backends.fp32_precision!r}, "
            f"torch.backends.mkldnn.matmul.fp32_precision = "
            f"{mk.matmul.fp32_precision!r}, "
            f"torch.backends.mkldnn.fp32_precision = {mk.fp32_precision!r}, "
            f"torch.get_num_threads() = {torch.get_num_threads()}, "
            f"jax.config.jax_default_matmul_precision = "
            f"{jax.config.jax_default_matmul_precision!r}, a float32 "
            f"denormal times 1 in torch = "
            f"{float(torch.tensor([1e-40]) * 1.0):.3g} (0: flushed)")


def _close(port, ref, tol, f64=None):
    """max |port - ref| <= tol * max(1, max |ref|).  With ``f64``, the same
    quantity in float64, a failure's message says which side is further
    from it, by how much, and the process's float state."""
    port = port.detach().float().cpu().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    msg = (err, bound)
    if f64 is not None and not err <= bound:
        e_port, e_ref = (float(np.abs(np.asarray(a, np.float64) - f64).max())
                         for a in (port, ref))
        msg = (f"|port - jax| {err:.3e} > {bound:.3e}; against float64: "
               f"port {e_port:.3e}, jax {e_ref:.3e}, so "
               f"{'the port' if e_port > e_ref else 'JAX'} is off; "
               f"{_float_state()}")
    assert err <= bound, msg


def _tail_bwd_f64(tg, tg_t, h, gbar, a_s, a_d, den, out):
    """``_gat_bwd_fused``'s (dh, das, dad) in float64 numpy from float64
    copies of its (rounded) inputs: per live slot s -> d of weight m and
    per head, alpha = m p / den[d] under the shift bound of max a_s, te =
    <gbar_d, h_s>, dz = alpha (te - <gbar_d, out_d>) leaky'(a_s[s] +
    a_d[d]); dad[d] sums dz over ``tg``, das[s] dz and dh[s] alpha gbar_d
    over the transposed ``tg_t`` (its rows are the senders)."""
    n, HD = h.shape
    H = a_d.shape[1]
    D = HD // H
    h, gbar, a_s, a_d, den, out = (np.asarray(x, np.float64) for x in (
        h, gbar, a_s, a_d, den, out))
    s2 = (gbar.reshape(n, H, D) * out.reshape(n, H, D)).sum(-1)
    rden = 1.0 / np.maximum(den, 1e-20)
    msrc = a_s.max(0, keepdims=True)
    dh, das, dad = np.zeros((n, HD)), np.zeros((n, H)), np.zeros((n, H))
    for tiling, src_mode in ((tg, False), (tg_t, True)):
        valid, col, row = TSp._live_slots(tiling, 0, tiling.n_tiles)
        m = tiling.weight.double()[valid].numpy()[:, None]
        col, row = col.numpy(), row.numpy()
        s, d = (row, col) if src_mode else (col, row)
        lraw = a_s[s] + a_d[d]
        lk = lambda v: np.where(v >= 0, v, 0.2 * v)  # noqa: E731
        p = np.exp(np.minimum(lk(lraw) - lk(msrc + a_d[d]), 60.0))
        alpha = p * m * rden[d]
        te = (h[s].reshape(-1, H, D) * gbar[d].reshape(-1, H, D)).sum(-1)
        dz = alpha * (te - s2[d]) * np.where(lraw >= 0, 1.0, 0.2)
        if src_mode:
            np.add.at(das, s, dz)
            np.add.at(dh, s, (alpha[:, :, None]
                              * gbar[d].reshape(-1, H, D)).reshape(-1, HD))
        else:
            np.add.at(dad, d, dz)
    return dh, das, dad


def _dead_first_tile(tg):
    """The same tiling with tile 0 dead (cb = -1), in either package."""
    cb = tg.tile_cb
    cb = (cb.clone() if isinstance(cb, torch.Tensor) else np.asarray(cb).copy())
    cb[0] = -1
    return dataclasses.replace(tg, tile_cb=cb if isinstance(
        cb, torch.Tensor) else jnp.asarray(cb))


@pytest.fixture(scope="module")
def edge_pair():
    """The fixture's edge-case graph split forward and transposed, in both
    packages: (jax forward, jax twin, port forward, port twin)."""
    s, r, n, _ = fixtures.edge_case_graph()
    hj = J.build_host_graph(s, r, n, edge_pad_multiple=128)
    ht = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    hj_t, _ = JG.transpose_host_graph(hj)
    ht_t, _ = TG.transpose_host_graph(ht)
    out = (JG.hybrid_graph(hj, **SPLIT), JG.hybrid_graph(hj_t, **SPLIT),
           TG.hybrid_graph(ht, **SPLIT, device=CPU),
           TG.hybrid_graph(ht_t, **SPLIT, device=CPU))
    for hy in out:
        assert hy.dense is not None and hy.n_sparse_edges > 0
        # 200 copies of the hot pair: 127 in a dense cell, 73 in one slot
        assert float(np.asarray(hy.tiles.weight, np.float32).max()) == 73
    return out


def _bwd_inputs(seed, n, H, HD):
    """h, gbar, a_s (the gap row's sources far below), a_d, den (0 on the
    gap row, whose attention underflows) and out, as numpy float32."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, HD)).astype(np.float32)
    gbar = rng.standard_normal((n, HD)).astype(np.float32)
    a_s = fixtures.gap_a_src(rng, n, H)
    a_d = rng.standard_normal((n, H)).astype(np.float32)
    den = rng.uniform(0.5, 40.0, (n, H)).astype(np.float32)
    den[fixtures.GAP_ROW] = 0.0
    out = rng.standard_normal((n, HD)).astype(np.float32)
    return h, gbar, a_s, a_d, den, out


def test_transpose_host_graph_matches_jax():
    s, r, labels = synthetic_coo(N, E, seed=1, communities=6, p_in=0.8)
    for kw in (dict(symmetric_norm=True, add_self_loops=True), {}):
        hj = J.build_host_graph(s, r, N, **kw)
        ht = TG.build_host_graph(s, r, N, **kw)
        (gj, pj), (gt, pt) = JG.transpose_host_graph(hj), \
            TG.transpose_host_graph(ht)
        np.testing.assert_array_equal(pt, pj)
        for f in ("senders", "receivers", "edge_mask", "edge_weight"):
            np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f))
        assert (gt.n_node, gt.n_edge) == (gj.n_node, gj.n_edge)
        assert (np.diff(gt.receivers[: gt.n_edge]) >= 0).all()


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,HD", [(8, 8), (4, 128)])
@pytest.mark.parametrize("route", ["tt", "wide"])
def test_gat_bwd_fused_matches_jax(edge_pair, monkeypatch, dtn, H, HD,
                                   route):
    """The tail backward (dh, das, dad) on the edge-case tails: a dead tile
    in each tiling, pad slots, a merged slot of 73 copies and the gap row.
    ``route`` picks JAX's transposed-dataflow or wide kernels."""
    monkeypatch.setattr(JA, "GAT_BWD_T", route == "tt")
    jf, jt, tf, tt = edge_pair
    tdt, jdt = DTYPES[dtn]
    h, gbar, a_s, a_d, den, out = _bwd_inputs(1, tf.tiles.n_node, H, HD)
    want = JA._gat_bwd_fused(
        _dead_first_tile(jf.tiles), _dead_first_tile(jt.tiles),
        jnp.asarray(h, jdt), jnp.asarray(a_s), jnp.asarray(a_d, jdt),
        jnp.asarray(den), jnp.asarray(out), jnp.asarray(gbar), 0.2,
        interpret=True)
    got = TA._gat_bwd_fused(
        _dead_first_tile(tf.tiles), _dead_first_tile(tt.tiles),
        torch.tensor(h, dtype=tdt), torch.tensor(a_s),
        torch.tensor(a_d, dtype=tdt), torch.tensor(den), torch.tensor(out),
        torch.tensor(gbar), 0.2)
    # the same in float64 from the inputs as rounded to the dtype: which
    # side a failure is off on
    hr, adr = (torch.tensor(x, dtype=tdt).double().numpy() for x in (h, a_d))
    f64 = _tail_bwd_f64(_dead_first_tile(tf.tiles), _dead_first_tile(tt.tiles),
                        hr, gbar, a_s, adr, den, out)
    for name, a, b, c in zip(("dh", "das", "dad"), got, want, f64):
        assert a.dtype == {"dh": tdt, "das": torch.float32, "dad": tdt}[name]
        _close(a, b, TOL[dtn], f64=c)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,HD", [(8, 8), (4, 128)])
def test_gat_dense_bwd_matches_jax(edge_pair, dtn, H, HD):
    """The dense backward on the edge-case 'cr' split (counts of 127 on the
    saturated pair, a row block no dense block visits)."""
    jf, jt, tf, tt = edge_pair
    tdt, jdt = DTYPES[dtn]
    h, gbar, a_s, a_d, den, out = _bwd_inputs(2, tf.tiles.n_node, H, HD)
    want = JD.gat_dense_bwd(jf.dense, jt.dense, jnp.asarray(h, jdt),
                            jnp.asarray(a_s), jnp.asarray(a_d),
                            jnp.asarray(den), jnp.asarray(out),
                            jnp.asarray(gbar), interpret=True)
    got = TD.gat_dense_bwd(tf.dense, tt.dense, torch.tensor(h, dtype=tdt),
                           torch.tensor(a_s), torch.tensor(a_d),
                           torch.tensor(den), torch.tensor(out),
                           torch.tensor(gbar))
    for a, b in zip(got, want):
        _close(a, b, TOL[dtn])
    assert float(got[2][512:].abs().max()) == 0.0   # unvisited row block


@pytest.fixture(scope="module")
def sym_pair():
    """A symmetric-norm graph (what GCN and GAT train on) with both
    packages' GCN-style splits (int8 counts + separable scales) and
    attention splits ('cr', unit weight), forward and transposed."""
    s, r, labels = synthetic_coo(N, E, seed=1, communities=6, p_in=0.8)
    hj = J.build_host_graph(s, r, N, add_self_loops=True, symmetric_norm=True)
    hj, _ = J.reorder_nodes(hj, "hubs+labels", labels=labels)
    ht = TG.build_host_graph(s, r, N, add_self_loops=True,
                             symmetric_norm=True)
    ht, _ = TG.reorder_nodes(ht, "hubs+labels", labels=labels)
    agg = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=60,
               values_dtype=np.int8, supergroup=16)

    def scaled(mod, hg, to, dev):
        hy = mod.hybrid_graph(hg, **agg, **dev)
        rs, cs = mod.separable_weight_scales(hg)
        return dataclasses.replace(hy, row_scale=to(rs), col_scale=to(cs))

    out = {}
    for name, mod, hg, to, dev in (
            ("jax", JG, hj, jnp.asarray, {}),
            ("port", TG, ht, torch.as_tensor, dict(device=CPU))):
        hg_t, _ = mod.transpose_host_graph(hg)
        out[name] = dict(g=hg.to_device(**dev), host=(hg, hg_t),
                         att=(mod.hybrid_graph(hg, **ATT_SPLIT, **dev),
                              mod.hybrid_graph(hg_t, **ATT_SPLIT, **dev)),
                         agg=(scaled(mod, hg, to, dev),
                              scaled(mod, hg_t, to, dev)))
    return out


def test_spmm_hybrid_grad_matches_jax(sym_pair):
    """dx = Aᵀ ȳ on the hybrid split of the transposed graph (K1 + K2 plain
    versions) against jax.grad through the JAX package's twin."""
    j, t = sym_pair["jax"], sym_pair["port"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, 24)).astype(np.float32)
    gy = rng.standard_normal((N, 24)).astype(np.float32)
    dj = jax.grad(lambda v: jnp.vdot(JD.spmm_hybrid(
        j["agg"][0], j["g"], v, interpret=True, hyb_t=j["agg"][1]),
        jnp.asarray(gy)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (dt,) = torch.autograd.grad(
        (TD.spmm_hybrid(t["agg"][0], t["g"], xt, hyb_t=t["agg"][1])
         * torch.tensor(gy)).sum(), xt)
    _close(dt, dj, 1e-5)


@pytest.mark.parametrize("mode", ["values", "derive"])
def test_gat_hybrid_grads_match_jax(sym_pair, mode):
    """gat_hybrid's kernel backward (values mode: dh, das, dad; derive
    mode: dh, dw, dad) against jax.grad through the JAX twin, on a
    symmetric-norm graph: in values mode also against the gradient of the
    UNWEIGHTED full-graph formulation (JAX's no-twin backward), the
    function the unit-weight attention kernels compute."""
    j, t = sym_pair["jax"], sym_pair["port"]
    H, HD = 4, 32
    rng = np.random.default_rng(4)
    h = rng.standard_normal((N, HD)).astype(np.float32)
    s = (rng.standard_normal((HD, H)) * 0.3 if mode == "derive"
         else rng.standard_normal((N, H))).astype(np.float32)
    d = rng.standard_normal((N, H)).astype(np.float32)
    wt = rng.standard_normal((HD, 3)).astype(np.float32)

    def j_loss(twin):
        def f(hh, ss, dd):
            kw = dict(w_asrc=ss) if mode == "derive" else {}
            y = JD.gat_hybrid(j["att"][0], j["g"], hh,
                              None if mode == "derive" else ss, dd,
                              interpret=True, hyb_t=twin, **kw)
            return jnp.sum(jnp.tanh(y @ wt) ** 2)
        return f

    args = (jnp.asarray(h), jnp.asarray(s), jnp.asarray(d))
    want = jax.grad(j_loss(j["att"][1]), argnums=(0, 1, 2))(*args)
    unweighted = (jax.grad(j_loss(None), argnums=(0, 1, 2))(*args)
                  if mode == "values" else want)
    tv = [torch.tensor(v, requires_grad=True) for v in (h, s, d)]
    kw = dict(w_asrc=tv[1]) if mode == "derive" else {}
    y = TD.gat_hybrid(t["att"][0], t["g"], tv[0],
                      None if mode == "derive" else tv[1], tv[2],
                      hyb_t=t["att"][1], **kw)
    got = torch.autograd.grad((torch.tanh(y @ torch.tensor(wt)) ** 2).sum(),
                              tv)
    for a, b, c in zip(got, want, unweighted):
        _close(a, b, 1e-5)
        _close(a, c, 1e-4)    # a different formulation: exact row max


@pytest.mark.parametrize("tail_only", ["forward", "twin"])
def test_gat_hybrid_grads_when_one_split_has_no_dense_blocks(
        sym_pair, monkeypatch, tail_only):
    """The forward split and its twin need not agree on having dense
    blocks (each has its own threshold): the backward still runs the
    kernels' functions, dad from the forward split and (dh, das) from the
    twin, and matches jax.grad through the JAX twin whose splits both
    have dense blocks."""
    j, t = sym_pair["jax"], sym_pair["port"]
    hyb, twin = t["att"]
    assert hyb.dense is not None and twin.dense is not None
    # min_nnz 0: no block goes dense, every edge stays in the tail
    tail = TG.hybrid_graph(t["host"][tail_only == "twin"],
                           **{**ATT_SPLIT, "min_nnz": 0}, device=CPU)
    assert tail.dense is None
    if tail_only == "forward":
        hyb = tail
    else:
        twin = tail
    H, HD = 4, 32
    rng = np.random.default_rng(6)
    h, s, d = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((N, HD), (N, H), (N, H)))
    gy = rng.standard_normal((N, HD)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.vdot(JD.gat_hybrid(
        j["att"][0], j["g"], *a, interpret=True, hyb_t=j["att"][1]),
        jnp.asarray(gy)), argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(s), jnp.asarray(d))

    def boom(*a, **k):
        raise AssertionError("full-graph backward taken")

    monkeypatch.setattr(TD, "_gat_reference_g", boom)
    tv = [torch.tensor(v, requires_grad=True) for v in (h, s, d)]
    y = TD.gat_hybrid(hyb, t["g"], *tv, hyb_t=twin)
    got = torch.autograd.grad((y * torch.tensor(gy)).sum(), tv)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("lacks", ["neither", "forward", "twin"])
@pytest.mark.parametrize("mode", ["values", "derive"])
def test_gat_hybrid_shared_backward_is_the_two_share_sum(sym_pair, mode,
                                                         lacks):
    """gat_hybrid's backward, one float32 buffer per output that the tail
    (K5, K6) and dense (K7, K8) kernels' plain versions both add into,
    against the two backwards it replaces: ``_gat_bwd_fused``'s tail share
    plus ``gat_dense_bwd``'s dense share, added in float32 (then, in derive
    mode, the chain rule through a_s = h w), within 1e-6 of each gradient's
    max; also where the forward split or the twin has no dense blocks."""
    t = sym_pair["port"]
    hyb, twin = t["att"]
    if lacks != "neither":
        # min_nnz 0: no block goes dense, every edge stays in the tail
        tail = TG.hybrid_graph(t["host"][lacks == "twin"],
                               **{**ATT_SPLIT, "min_nnz": 0}, device=CPU)
        hyb, twin = (tail, twin) if lacks == "forward" else (hyb, tail)
    assert (hyb.dense is None, twin.dense is None) == (
        lacks == "forward", lacks == "twin")
    H, HD = 4, 32
    wmode = mode == "derive"
    rng = np.random.default_rng(9)
    h, sw, d, gy = (torch.tensor(rng.standard_normal(shape),
                                 dtype=torch.float32) for shape in (
        (N, HD), (HD, H) if wmode else (N, H), (N, H), (N, HD)))
    if wmode:
        sw = sw * 0.3
    tv = [v.clone().requires_grad_(True) for v in (h, sw, d)]
    y = TD.gat_hybrid(hyb, None, tv[0], None if wmode else tv[1], tv[2],
                      w_asrc=tv[1] if wmode else None, hyb_t=twin)
    got = torch.autograd.grad((y * gy).sum(), tv)

    acc, a_s = TD._gat_hybrid_raw(hyb, h, sw, d, wmode, 0.2)
    den, out = acc[:, HD:], y.detach()
    dh, das, dad = TA._gat_bwd_fused(hyb.tiles, twin.tiles, h, a_s, d, den,
                                     out, gy, 0.2)
    dhd, dasd, dadd = TD.gat_dense_bwd(hyb.dense, twin.dense, h, a_s, d,
                                       den, out, gy)
    dh, das, dad = dh + dhd, das + dasd, dad + dadd
    if wmode:
        dh, das = dh + das @ sw.T, h.T @ das
    for name, a, b in zip(("dh", "dsw", "dad"), got, (dh, das, dad)):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        err = float((a - b).abs().max())
        assert err <= 1e-6 * float(b.abs().max()), (name, err)


@pytest.mark.parametrize("wrapper", ["gat_bwd_tiles_dad", "gat_bwd_tiles_src",
                                     "gat_dense_bwd_dad", "gat_dense_bwd_src"])
def test_bwd_wrapper_given_out_adds_into_it(sym_pair, wrapper):
    """Each backward wrapper given ``out`` returns ``out`` itself, holding
    what it held plus what the wrapper returns without it (plain
    versions)."""
    hyb, twin = sym_pair["port"]["att"]
    H, HD = 4, 32
    rng = np.random.default_rng(10)
    h, gy = (torch.tensor(rng.standard_normal((N, HD)), dtype=torch.float32)
             for _ in range(2))
    a_s, a_d = (torch.tensor(rng.standard_normal((N, H)),
                             dtype=torch.float32) for _ in range(2))
    acc, _ = TD._gat_hybrid_raw(hyb, h, a_s, a_d, False, 0.2)
    den = acc[:, HD:]
    y = acc[:, :HD] / den.repeat_interleave(HD // H, dim=1)
    hc, gc, side, msrc = TA.bwd_inputs(h, a_s, a_d, den, y, gy)
    split = {"gat_bwd_tiles_dad": hyb.tiles, "gat_bwd_tiles_src": twin.tiles,
             "gat_dense_bwd_dad": hyb.dense,
             "gat_dense_bwd_src": twin.dense}[wrapper]
    args = (split, hc, gc, side, msrc)
    if wrapper.startswith("gat_dense"):
        args = (split, hc, gc, TD._block_values(split, hc.dtype), side, msrc)
    fn = getattr(TA if "tiles" in wrapper else TD, wrapper)
    plain = fn(*args)
    assert plain.shape == (N, H + (HD if wrapper.endswith("src") else 0))
    assert float(plain.abs().max()) > 0
    base = torch.tensor(rng.standard_normal(tuple(plain.shape)),
                        dtype=torch.float32)
    out = base.clone()
    got = fn(*args, out=out)
    assert got is out
    assert torch.equal(got, base + plain)


def test_backward_with_twin_never_takes_the_full_graph_path(sym_pair,
                                                            monkeypatch):
    """With the twin, the backward runs the kernels' functions only: the
    full-graph formulations are patched to raise, and the twin-less
    backward shows that the patch bites."""
    t = sym_pair["port"]

    def boom(*a, **k):
        raise AssertionError("full-graph backward taken")

    monkeypatch.setattr(TD, "_spmm_ref_g", boom)
    monkeypatch.setattr(TD, "_gat_reference_g", boom)
    x = torch.randn((N, 8), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    a = torch.randn((N, 4), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    TD.spmm_hybrid(t["agg"][0], t["g"], x, hyb_t=t["agg"][1]).sum().backward()
    TD.gat_hybrid(t["att"][0], t["g"], x, a, a,
                  hyb_t=t["att"][1]).sum().backward()
    assert x.grad is not None and a.grad is not None
    with pytest.raises(AssertionError, match="full-graph"):
        TD.spmm_hybrid(t["agg"][0], t["g"], x).sum().backward()
    with pytest.raises(AssertionError, match="full-graph"):
        TD.gat_hybrid(t["att"][0], t["g"], x, a, a).sum().backward()
