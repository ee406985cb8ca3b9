"""PyTorch port: how K8's wgmma path (``csrc/gat_dense_bwd_src.cu``,
``gat_dense_bwd_wgmma_kernel``) is sized and what it reads, and K8's plain
version on the shapes made to reach it.

The bf16 path takes K4's head shapes (1, 2, 4 or 8 heads whose width D pads
to N, the next of 8, 32, 48, 64, 128, with H N <= 128); the wrapper hands
it the shared-memory size of its ring (``compiler/schedule._dense_bwd_smem``),
which the launch checks against its own layout, and walks
``DenseBlockGraph.wide_segments``.  float32 h and the other shapes keep the
dense walk of ``csrc/gat_bwd.cuh`` over ``segments``.  The tuner prunes by
``_kind_smem``, which must cover both.  K8's plain version, which the CPU
wrapper takes, is held to the JAX package's TPU kernel (interpret mode) at
1, 2 and 8 heads and at D = 41 (padded to 48 on the card) in both dtypes,
and to a float64 sum of the same terms on row blocks of 8, 9, 16 and 17
dense blocks (both sides of the run cuts).  Tolerances: float32 max |port -
ref| <= 1e-5 * max(1, max |ref|) (the same terms summed in another order);
bfloat16 2e-2 * max(1, max |ref|), as ``test_torch_backward.py`` holds the
dense backward (a value that lands on the other side of a bf16 rounding
boundary moves one term by up to 2^-8 of itself).  The kernel itself is
held to the plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

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


def _close(port, ref, tol):
    port = port.detach().float().cpu().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _ring(H, N, vb):
    """K8's wgmma ring: 3 stages of [gbar panel H KT x 128 B | count tile
    64 x (128 vb + 16) B | column terms 4H x 64 f32], each rounded up to
    1 KB, then 256 threads' te A fragments (16 B a head and k-step), plus
    1 KB of alignment."""
    kt = -(-N // 16) * 16
    stage = H * kt * 128 + 64 * (128 * vb + 16) + 4 * H * 64 * 4
    return 3 * (-(-stage // 1024) * 1024) + 256 * H * kt + 1024


def _walk(HD, H, src_mode):
    """The dense walk's 64-row sub-tile (csrc/gat_bwd.cuh dense_smem_bytes)."""
    width = H + (HD if src_mode else 0)
    return 4 * (64 * HD + 64 * 4 * H + 64 * 65 + 64 * width)


@pytest.mark.parametrize("HD,H,N", [(128, 4, 32), (41, 1, 48), (64, 2, 32),
                                    (64, 8, 8), (128, 1, 128), (8, 1, 8)])
@pytest.mark.parametrize("vb", [1, 2, None])
def test_dense_bwd_smem_follows_the_wgmma_launch(HD, H, N, vb):
    """``_dense_bwd_smem`` is the size K8's launch accepts on the wgmma path
    (int8 counts, bf16 values, or the larger when the value type is not
    given); the head panel's KT rows a head are N padded to 16 (8 -> 16);
    every size fits one H100 block."""
    assert TSc._gat_wgmma_width(H, HD // H) == N
    want = _ring(H, N, vb) if vb else max(_ring(H, N, 1), _ring(H, N, 2))
    assert TSc._dense_bwd_smem(HD, H, 2, True, vb) == want
    assert want <= TSc.SMEM_BLOCK_BYTES
    assert TSc._kind_smem("gat_hybrid", HD, H, 2) >= want


def test_dense_bwd_smem_of_the_walk():
    """float32 h, K7 (which stays on the walk) and the shapes the wgmma path
    does not take request the walk's sub-tile; the main instantiation's
    numbers by hand."""
    assert _ring(4, 32, 1) == 3 * 29696 + 32768 + 1024
    assert TSc._dense_bwd_smem(128, 4, 4, True, 1) == _walk(128, 4, True)
    assert TSc._dense_bwd_smem(128, 4, 2, False, 1) == _walk(128, 4, False)
    for HD, H in ((16, 16), (256, 4), (256, 1)):
        assert TSc._gat_wgmma_width(H, HD // H) == 0
        assert TSc._dense_bwd_smem(HD, H, 2, True) == _walk(HD, H, True)
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
@pytest.mark.parametrize("H,HD", [(1, 41), (2, 64), (8, 64), (1, 128)])
def test_dense_bwd_plain_matches_jax_at_the_wgmma_shapes(edge_pair, dtn, H,
                                                        HD):
    """K8's [das | dh] (and K7's dad) plain versions at the head shapes of
    K8's wgmma path beyond the Reddit layer's 4 heads of 32: 1 head of 41
    (N = 48), 2 of 32, 8 of 8 (N = 8, KT = 16) and 1 of 128, on the 'cr'
    split whose dense block holds the saturated pair at count 127 and whose
    last row block no dense block visits."""
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
    for a, b in zip(got, want):
        _close(a, b, TOL[dtn])
    assert float(got[0][512:].float().abs().max()) == 0.0   # unvisited stripe
    assert float(got[1][512:].abs().max()) == 0.0


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
