"""PyTorch port: how K7's and K8's wgmma paths (``csrc/gat_dense_bwd_dad.cu``
``gat_dense_bwd_dad_wgmma_kernel``, ``csrc/gat_dense_bwd_src.cu``
``gat_dense_bwd_wgmma_kernel``, both on the tensor-core stage of
``csrc/gat_bwd.cuh``) are sized and what they read, and their plain
versions on the shapes made to reach them.

The bf16 paths take K4's head shapes (1, 2, 4 or 8 heads whose width D pads
to N, the next of 8, 32, 48, 64, 128, with H N <= 128); the wrapper hands
each the shared-memory size of its ring (``compiler/schedule._dense_bwd_smem``),
which the launch checks against its own layout, and walks
``DenseBlockGraph.wide_segments``.  float32 h and the other shapes keep the
dense walk of ``csrc/gat_bwd.cuh`` over ``segments``.  The tuner prunes by
``_kind_smem``, which must cover both.  The plain versions, which the CPU
wrapper takes, are held to the JAX package's TPU kernels (interpret mode)
at 1, 2, 4 and 8 heads and at D = 41 (padded to 48 on the card) in both
dtypes, and to a float64 sum of the same terms on row blocks of 8, 9, 16
and 17 dense blocks (both sides of the run cuts).  Tolerances: float32
max |port - ref| <= 1e-5 * max(1, max |ref|) (the same terms summed in
another order); bfloat16 2e-2 * max(1, max |ref|), as
``test_torch_backward.py`` holds the dense backward (a value that lands on
the other side of a bf16 rounding boundary moves one term by up to 2^-8 of
itself).  The kernel itself is held to the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import dense as JD  # noqa: E402

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TSc  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import roofline  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CPU = "cpu"     # the port's entry points default to the CUDA card
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SPLIT = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=100,
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
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    msg = (err, bound)
    if f64 is not None and not err <= bound:
        e_port, e_ref = (float(np.abs(a - f64).max()) for a in (port, ref))
        msg = (f"|port - jax| {err:.3e} > {bound:.3e}; against float64: "
               f"port {e_port:.3e}, jax {e_ref:.3e}, so "
               f"{'the port' if e_port > e_ref else 'JAX'} is off; "
               f"{_float_state()}")
    assert err <= bound, msg


def _lk(v):
    return np.where(v >= 0, v, 0.2 * v)


def _dense_bwd_f64(bg, bg_t, h, gbar, a_s, a_d, den, out):
    """``gat_dense_bwd``'s (dh, das, dad) in float64 numpy, from float64
    copies of its inputs: the chain of every dense cell, summed per row
    (dad over ``bg``, rows the receivers; [das | dh] over ``bg_t``, rows
    the senders)."""
    n, HD = h.shape
    H = a_d.shape[1]
    D = HD // H
    R = C = bg.block_rows
    npad = max(n, bg.n_row_blocks * R, bg.n_col_blocks * C)
    pad = lambda x: np.concatenate(  # noqa: E731
        [x.astype(np.float64), np.zeros((npad - n, x.shape[1]))])
    h, gbar, a_s, a_d, out = map(pad, (h, gbar, a_s, a_d, out))
    den = pad(den)
    s2 = (gbar.reshape(npad, H, D) * out.reshape(npad, H, D)).sum(-1)
    rden = 1.0 / np.maximum(den, 1e-20)
    msrc = a_s[:n].max(0, keepdims=True)
    dad, sd = np.zeros((npad, H)), np.zeros((npad, H + HD))
    for split, src_mode in ((bg, False), (bg_t, True)):
        vals = split.values.double().numpy()
        for b, (rb, cb) in enumerate(zip(split.blk_rb.tolist(),
                                         split.blk_cb.tolist())):
            cnt = vals[b].T                               # [R rows, C cols]
            rows = slice(rb * R, (rb + 1) * R)
            cols = slice(cb * C, (cb + 1) * C)
            s, d = (rows, cols) if src_mode else (cols, rows)
            a_ss = a_s[s][:, None, :] if src_mode else a_s[s][None]
            a_dd, rd, s2d = ((x[d][None] if src_mode else x[d][:, None, :])
                             for x in (a_d, rden, s2))
            lraw = a_ss + a_dd
            p = cnt[:, :, None] * np.exp(np.minimum(
                _lk(lraw) - _lk(msrc + a_dd), 60.0))
            alpha = p * rd
            hs = h[s].reshape(-1, H, D)
            gd = gbar[d].reshape(-1, H, D)
            te = (np.einsum("rhd,chd->rch", hs, gd) if src_mode
                  else np.einsum("rhd,chd->rch", gd, hs))
            dz = alpha * (te - s2d) * np.where(lraw >= 0, 1.0, 0.2)
            if src_mode:
                sd[rows, :H] += dz.sum(1)
                sd[rows, H:] += np.einsum("rch,chd->rhd", alpha,
                                          gd).reshape(R, HD)
            else:
                dad[rows] += dz.sum(1)
    return sd[:n, H:], sd[:n, :H], dad[:n]


def _ring(H, N, vb, src_mode=True):
    """The wgmma ring: 3 stages of [column panel H KT x 128 B | count tile
    64 x (128 vb + 16) B | column terms 4H (K8) or H (K7) x 64 f32], each
    rounded up to 1 KB, then for K8 256 threads' te A fragments (16 B a
    head and k-step), plus 1 KB of alignment."""
    kt = -(-N // 16) * 16
    terms = 4 * H if src_mode else H
    stage = H * kt * 128 + 64 * (128 * vb + 16) + terms * 64 * 4
    frags = 256 * H * kt if src_mode else 0
    return 3 * (-(-stage // 1024) * 1024) + frags + 1024


def _walk(HD, H, src_mode):
    """The dense walk's 64-row sub-tile (csrc/gat_bwd.cuh dense_smem_bytes)."""
    width = H + (HD if src_mode else 0)
    return 4 * (64 * HD + 64 * 4 * H + 64 * 65 + 64 * width)


@pytest.mark.parametrize("src_mode", [True, False])
@pytest.mark.parametrize("HD,H,N", [(128, 4, 32), (41, 1, 48), (64, 2, 32),
                                    (64, 8, 8), (128, 1, 128), (8, 1, 8)])
@pytest.mark.parametrize("vb", [1, 2, None])
def test_dense_bwd_smem_follows_the_wgmma_launch(HD, H, N, vb, src_mode):
    """``_dense_bwd_smem`` is the size K8's (``src_mode``) or K7's launch
    accepts on the wgmma path (int8 counts, bf16 values, or the larger when
    the value type is not given); the head panel's KT rows a head are N
    padded to 16 (8 -> 16); every size fits one H100 block, and K7's ring
    at most half of the SM's shared memory (two blocks an SM fit)."""
    assert TSc._gat_wgmma_width(H, HD // H) == N
    want = (_ring(H, N, vb, src_mode) if vb else
            max(_ring(H, N, 1, src_mode), _ring(H, N, 2, src_mode)))
    assert TSc._dense_bwd_smem(HD, H, 2, src_mode, vb) == want
    assert want <= TSc.SMEM_BLOCK_BYTES
    if not src_mode:
        assert want <= TSc.SMEM_BLOCK_BYTES // 2
    assert TSc._kind_smem("gat_hybrid", HD, H, 2) >= want


def test_dense_bwd_smem_of_the_walk():
    """float32 h and the shapes the wgmma paths do not take request the
    walk's sub-tile, for K7 and K8 alike; the main instantiations' numbers
    by hand (K8: a 29 KB stage and 32 KB of A fragments; K7: a 26 KB
    stage, no fragments)."""
    assert _ring(4, 32, 1) == 3 * 29696 + 32768 + 1024
    assert _ring(4, 32, 1, False) == 3 * 26624 + 1024
    for src_mode in (True, False):
        assert TSc._dense_bwd_smem(128, 4, 4, src_mode, 1) == _walk(
            128, 4, src_mode)
        for HD, H in ((16, 16), (256, 4), (256, 1)):
            assert TSc._gat_wgmma_width(H, HD // H) == 0
            assert TSc._dense_bwd_smem(HD, H, 2, src_mode) == _walk(
                HD, H, src_mode)
    for HD, H in ((128, 4), (41, 1), (64, 8), (16, 16), (256, 4)):
        for db in (2, 4):
            assert TSc._kind_smem("gat_hybrid", HD, H, db) >= max(
                _walk(HD, H, True), _walk(HD, H, False))
            assert TSc._kind_smem("gat_hybrid", HD, H, db) <= (
                TSc.SMEM_BLOCK_BYTES)


@pytest.mark.parametrize("HD,H", [(128, 4), (41, 1), (16, 16)])
def test_gat_kind_smem_is_k3s_a_s_pass(HD, H):
    """The one-hot ``gat`` kind requests K3's per-node a_s pass (w staged
    as [HD, H] float32; the walk itself and K5/K6 request none); the hybrid
    kind also covers K10's [HD, H] weights and its msrc."""
    assert TSc._kind_smem("gat", HD, H, 2) == HD * H * 4
    assert TSc._kind_smem("gat_hybrid", HD, H, 2) >= (HD * H + H) * 4


def test_dense_bwd_cell_floor_counts_every_cell_head():
    """K8's floor: one exp per cell-head at the special-function units'
    rate plus BWD_CELL_OPS float32 operations at the non-FMA half of the
    float32 rate; linear in the cell-heads and above K4's forward floor."""
    cells = 2529 * 65536 * 4
    exp_ms = cells / (roofline.SMS * roofline.SM_CLOCK_HZ
                      * roofline.EXP_PER_CLOCK_SM) * 1e3
    ops_ms = roofline.BWD_CELL_OPS * cells / (
        roofline.PEAK_OPS_PER_S[torch.float32] / 2) * 1e3
    got = roofline.dense_bwd_cell_floor_ms(cells)
    assert got == pytest.approx(exp_ms + ops_ms)
    assert got > roofline.dense_cell_floor_ms(cells)
    assert roofline.dense_bwd_cell_floor_ms(2 * cells) == pytest.approx(
        2 * got)


def test_dense_panel_cell_floor_has_no_exp():
    """K15's floor: PANEL_CELL_OPS float32 operations per cell-head at the
    non-FMA half of the float32 rate and no exponential, so it sits below
    K4's floor by the exps and the ops that the panels replace."""
    cells = 2529 * 65536 * 4
    ops_ms = roofline.PANEL_CELL_OPS * cells / (
        roofline.PEAK_OPS_PER_S[torch.float32] / 2) * 1e3
    got = roofline.dense_panel_cell_floor_ms(cells)
    assert got == pytest.approx(ops_ms)
    assert got == pytest.approx(roofline.dense_cell_floor_ms(
        cells, roofline.PANEL_CELL_OPS, exps=0))
    assert roofline.PANEL_CELL_OPS < roofline.CELL_OPS
    assert got < roofline.dense_cell_floor_ms(cells)
    assert roofline.dense_panel_cell_floor_ms(2 * cells) == pytest.approx(
        2 * got)


@pytest.fixture(scope="module")
def edge_pair():
    """The edge-case graph split forward and transposed, in both packages:
    (jax forward, jax twin, port forward, port twin)."""
    s, r, n, _ = fixtures.edge_case_graph()
    hj = J.build_host_graph(s, r, n, edge_pad_multiple=128)
    ht = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    hj_t, _ = JG.transpose_host_graph(hj)
    ht_t, _ = TG.transpose_host_graph(ht)
    return (JG.hybrid_graph(hj, **SPLIT), JG.hybrid_graph(hj_t, **SPLIT),
            TG.hybrid_graph(ht, **SPLIT, device=CPU),
            TG.hybrid_graph(ht_t, **SPLIT, device=CPU))


def _bwd_inputs(seed, n, H, HD):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, HD)).astype(np.float32)
    gbar = rng.standard_normal((n, HD)).astype(np.float32)
    a_s = fixtures.gap_a_src(rng, n, H)
    a_d = rng.standard_normal((n, H)).astype(np.float32)
    den = rng.uniform(0.5, 40.0, (n, H)).astype(np.float32)
    den[fixtures.GAP_ROW] = 0.0
    out = rng.standard_normal((n, HD)).astype(np.float32)
    return h, gbar, a_s, a_d, den, out


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,HD", [(1, 41), (2, 64), (8, 64), (1, 128),
                                  (4, 128), (2, 128)])
def test_dense_bwd_plain_matches_jax_at_the_wgmma_shapes(edge_pair, dtn, H,
                                                        HD):
    """K8's [das | dh] and K7's dad plain versions at the head shapes of
    their wgmma paths: 1 head of 41 (N = 48), 2 of 32, 8 of 8 (N = 8, KT =
    16), 1 of 128, 4 of 32 and 2 of 64, on the 'cr' split whose dense block
    holds the saturated pair at count 127 and whose last row block no dense
    block visits."""
    jf, jt, tf, tt = edge_pair
    tdt, jdt = DTYPES[dtn]
    h, gbar, a_s, a_d, den, out = _bwd_inputs(5, tf.tiles.n_node, H, HD)
    want = JD.gat_dense_bwd(jf.dense, jt.dense, jnp.asarray(h, jdt),
                            jnp.asarray(a_s), jnp.asarray(a_d),
                            jnp.asarray(den), jnp.asarray(out),
                            jnp.asarray(gbar), interpret=True)
    got = TD.gat_dense_bwd(tf.dense, tt.dense, torch.tensor(h, dtype=tdt),
                           torch.tensor(a_s), torch.tensor(a_d),
                           torch.tensor(den), torch.tensor(out),
                           torch.tensor(gbar))
    # the same in float64 from h and gbar as rounded to the dtype: which
    # side a failure is off on
    hr, gr = (torch.tensor(x, dtype=tdt).double().numpy() for x in (h, gbar))
    f64 = _dense_bwd_f64(tf.dense, tt.dense, hr, gr, a_s, a_d, den, out)
    for a, b, c in zip(got, want, f64):
        _close(a, b, TOL[dtn], f64=c)
    assert float(got[0][512:].float().abs().max()) == 0.0   # unvisited stripe
    assert float(got[1][512:].abs().max()) == 0.0
    assert float(got[2][512:].abs().max()) == 0.0


@pytest.mark.parametrize("H,HD", [(4, 128), (1, 41)])
def test_dense_bwd_src_plain_matches_float64_across_run_cuts(H, HD):
    """K8's plain version on row blocks of 8, 9, 16 and 17 dense blocks
    (its wgmma path's runs of at most 16 cut the last in two, the walk's
    runs of 8 the last three) against a float64 sum of the same terms; the
    row block without dense blocks reads 0."""
    bg = dataclasses.replace(fixtures.seg_block_graph(CPU),
                             values_layout="cr")
    runs = torch.bincount(bg.wide_segments[:, 0].long(),
                          minlength=bg.n_row_blocks)
    assert runs[:4].tolist() == [1, 1, 1, 2]
    R = C = bg.block_rows
    n = bg.n_col_blocks * C
    rng = np.random.default_rng(11)
    h, gbar = (rng.standard_normal((n, HD)).astype(np.float32)
               for _ in range(2))
    a_s = fixtures.gap_a_src(rng, n, H)
    msrc = a_s.max(0, keepdims=True)
    side = fixtures.bwd_side(rng, n, H, torch.float32, CPU, a_s=a_s)
    got = TD.gat_dense_bwd_src(bg, torch.from_numpy(h),
                               torch.from_numpy(gbar), bg.values, side,
                               torch.from_numpy(msrc))
    D = HD // H
    sd = side.double().numpy()
    lk = lambda v: np.where(v >= 0, v, 0.2 * v)  # noqa: E731
    want = np.zeros((n, H + HD))
    vals = bg.values.double().numpy()
    for b, (rb, cb) in enumerate(zip(bg.blk_rb.tolist(),
                                     bg.blk_cb.tolist())):
        cnt = vals[b].T                                   # [R rows, C cols]
        rows, cols = slice(rb * R, (rb + 1) * R), slice(cb * C, (cb + 1) * C)
        a_sr = sd[rows, :H][:, None, :]                   # senders: rows
        a_dc, rden, s2 = (sd[cols, k * H:(k + 1) * H][None] for k in (1, 2, 3))
        lraw = a_sr + a_dc
        p = cnt[:, :, None] * np.exp(np.minimum(
            lk(lraw) - lk(msrc.astype(np.float64) + a_dc), 60.0))
        alpha = p * rden
        hr = h[rows].reshape(R, H, D).astype(np.float64)
        gc = gbar[cols].reshape(C, H, D).astype(np.float64)
        te = np.einsum("rhd,chd->rch", hr, gc)
        dz = alpha * (te - s2) * np.where(lraw >= 0, 1.0, 0.2)
        want[rows, :H] += dz.sum(1)
        want[rows, H:] += np.einsum("rch,chd->rhd", alpha, gc).reshape(R, HD)
    _close(got, want, TOL["float32"])
    assert float(got[len(fixtures.SEG_COUNTS) * R:].abs().max()) == 0.0


@pytest.mark.parametrize("H,HD", [(4, 128), (1, 41)])
def test_dense_bwd_dad_plain_matches_float64_across_run_cuts(H, HD):
    """K7's plain version on row blocks of 8, 9, 16 and 17 dense blocks
    (its wgmma path's runs of at most 16 cut the last in two, the walk's
    runs of 8 the last three) against a float64 sum of the same terms,
    the rows the receivers; the row block without dense blocks reads 0."""
    bg = dataclasses.replace(fixtures.seg_block_graph(CPU),
                             values_layout="cr")
    R = C = bg.block_rows
    n = bg.n_col_blocks * C
    rng = np.random.default_rng(12)
    h, gbar = (rng.standard_normal((n, HD)).astype(np.float32)
               for _ in range(2))
    a_s = fixtures.gap_a_src(rng, n, H)
    msrc = a_s.max(0, keepdims=True)
    side = fixtures.bwd_side(rng, n, H, torch.float32, CPU, a_s=a_s)
    got = TD.gat_dense_bwd_dad(bg, torch.from_numpy(h),
                               torch.from_numpy(gbar), bg.values, side,
                               torch.from_numpy(msrc))
    D = HD // H
    sd = side.double().numpy()
    lk = lambda v: np.where(v >= 0, v, 0.2 * v)  # noqa: E731
    want = np.zeros((n, H))
    vals = bg.values.double().numpy()
    for b, (rb, cb) in enumerate(zip(bg.blk_rb.tolist(),
                                     bg.blk_cb.tolist())):
        cnt = vals[b].T                                   # [R rows, C cols]
        rows, cols = slice(rb * R, (rb + 1) * R), slice(cb * C, (cb + 1) * C)
        a_sc = sd[cols, :H][None]                         # senders: columns
        a_dr, rden, s2 = (sd[rows, k * H:(k + 1) * H][:, None, :]
                          for k in (1, 2, 3))
        lraw = a_sc + a_dr
        p = cnt[:, :, None] * np.exp(np.minimum(
            lk(lraw) - lk(msrc.astype(np.float64) + a_dr), 60.0))
        alpha = p * rden
        gr = gbar[rows].reshape(R, H, D).astype(np.float64)
        hc = h[cols].reshape(C, H, D).astype(np.float64)
        te = np.einsum("rhd,chd->rch", gr, hc)
        dz = alpha * (te - s2) * np.where(lraw >= 0, 1.0, 0.2)
        want[rows] += dz.sum(1)
    _close(got, want, TOL["float32"])
    assert float(got[len(fixtures.SEG_COUNTS) * R:].abs().max()) == 0.0
