"""PyTorch port: what K4's wgmma path (``csrc/gat_dense_blocks.cu``,
``gat_dense_wgmma_kernel``) reads and how it is sized, and K4's plain
version on the shapes made to reach its work split.

The bf16 path takes 1, 2, 4 or 8 heads whose width D pads to N (the next
of 8, 32, 48, 64, 128) with H N <= 128; the wrapper hands it the shared-
memory size of its ring (``compiler/schedule._dense_attention_smem``),
which the launch checks against its own layout. The B operand is a panel
of h transposed, each head's D features on N rows, that the kernel's entry
point writes into the wrapper's scratch before the main kernel. K4's plain
version, which the CPU wrapper takes, is held to the JAX package's TPU
kernel (interpret mode) at 2 heads of 32 and 8 heads of 8 in both layouts
and on float-valued 'cr' blocks, and to a float64 sum on row blocks of 8,
9, 16 and 17 dense blocks (both sides of the 8- and 16-block run cuts).
Tolerances: float32 max |port - ref| <= 1e-5 * max(1, max |ref|) (the same
terms summed in another order); bfloat16 1e-2 of each row's largest |ref|
in the num and den columns apart (both round p to bf16; a p whose f32
value differs in its last bit between the libraries may round the other
way, 2^-8 of itself).  The kernel itself is held to the plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
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

CPU = "cpu"     # the port's entry points default to the CUDA card
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SPLIT = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=64)


def _close(port, ref, tol, split):
    """Each row's num and den columns within ``tol`` of that row's largest
    |ref| there (at least 1 in float32 terms of the whole result)."""
    port = port.float().numpy()
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    for lo, hi in ((0, split), (split, ref.shape[1])):
        d = np.abs(port[:, lo:hi] - ref[:, lo:hi]).max(1)
        scale = np.maximum(np.abs(ref[:, lo:hi]).max(1),
                           1.0 if tol == TOL["float32"] else 1e-30)
        assert (d <= tol * scale).all(), float((d / scale).max())


def _inputs(n, HD, H, seed=3):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, HD)).astype(np.float32)
    a_s = fixtures.gap_a_src(rng, n, H)
    a_d = rng.standard_normal((n, H)).astype(np.float32)
    return h, a_s, a_d, a_s.max(0, keepdims=True)


def test_wgmma_width_follows_the_launcher():
    """``_gat_wgmma_width`` is the launcher's ``wgmma_width``: the next of
    8, 32, 48, 64, 128 at or above D, for 1, 2, 4 or 8 heads with H N <=
    128, else 0 (the mma.sync kernel takes the shape)."""
    want = {(1, 41): 48, (4, 32): 32, (2, 32): 32, (8, 8): 8, (1, 128): 128,
            (2, 64): 64, (1, 1): 8, (4, 9): 32, (2, 49): 64, (4, 64): 0,
            (8, 16): 0, (3, 32): 0, (16, 1): 0, (1, 129): 0}
    for (H, D), n in want.items():
        assert TSc._gat_wgmma_width(H, D) == n, (H, D)


def test_dense_attention_smem_follows_the_launch():
    """``_dense_attention_smem`` is the size K4's and K15's launches
    accept: on the wgmma path 3 stages of [h panel H N x 128 B | count tile
    | K4: a_s 64 H f32; K15: a_s, E1s and E2s 3 x 64 H f32], each rounded
    up to 1 KB, plus 1 KB of alignment and the rows' terms (K4: a_d and
    bound; K15: a_d, E1d and E2d) (the count tile the larger of its layouts: 64 x (256 + 16) or 256
    x (64 + 16) bytes for int8, twice the values for bf16); float32 h and
    the shapes the wgmma path does not take keep the mma.sync / FMA
    kernel's size.  Every size fits one H100 block."""
    def ring(H, N, vb, panel=False):
        tile = max(64 * (256 * vb + 16), 256 * (64 * vb + 16))
        cols = 256 * 3 * H if panel else 256 * H
        stage = -(-(H * N * 128 + tile + cols) // 1024) * 1024
        return 3 * stage + 1024 + (3 if panel else 2) * 1024 * H
    assert ring(4, 32, 1) == 3 * 37888 + 1024 + 8192
    assert TSc._dense_attention_smem(128, 4, 2, False, 1) == ring(4, 32, 1)
    assert TSc._dense_attention_smem(41, 1, 2, False, 1) == ring(1, 48, 1)
    assert TSc._dense_attention_smem(128, 4, 2, False, 2) == ring(4, 32, 2)
    assert TSc._dense_attention_smem(128, 4, 2, False) == ring(4, 32, 2)
    assert TSc._dense_attention_smem(64, 8, 2, False, 1) == ring(8, 8, 1)

    def mma(HD, H, panel, tensor_cores):
        cc = 32
        while cc > 4 and H * 64 * cc * 4 > 32 * 1024:
            cc //= 2
        f = 64 * (HD + H) + cc * H + 128 * H + 64 * cc + (
            cc * 2 * H + 64 * H if panel else 0)
        if tensor_cores and cc % 16 == 0:
            return f * 4 + (HD + H * 64) * (cc + 8) * 2
        return (f + cc * HD + H * 64 * cc) * 4
    assert TSc._dense_attention_smem(128, 4, 4, False, 1) == mma(
        128, 4, False, False)
    assert TSc._dense_attention_smem(128, 4, 2, True) == ring(4, 32, 2,
                                                              True)
    assert TSc._dense_attention_smem(41, 1, 2, True, 1) == ring(1, 48, 1,
                                                                True)
    assert TSc._dense_attention_smem(64, 8, 2, True, 2) == ring(8, 8, 2, True)
    assert TSc._dense_attention_smem(128, 4, 4, True) == mma(128, 4, True,
                                                             False)
    assert TSc._dense_attention_smem(256, 4, 2, True) == mma(256, 4, True,
                                                             True)
    assert TSc._dense_attention_smem(256, 4, 2, False, 1) == mma(
        256, 4, False, True)
    for HD, H in ((128, 4), (41, 1), (64, 2), (64, 8), (128, 1), (16, 16)):
        for db in (2, 4):
            assert TSc._kind_smem("gat_hybrid", HD, H, db) <= (
                TSc.SMEM_BLOCK_BYTES)
            for vb in (1, 2):
                assert TSc._dense_attention_smem(HD, H, db, True, vb) <= (
                    TSc.SMEM_BLOCK_BYTES)
    assert TSc._kind_smem("gat_hybrid", 128, 4, 2) >= ring(4, 32, 2, True)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,HD", [(2, 64), (8, 64)])
@pytest.mark.parametrize("layout", ["cr", "rc"])
def test_gat_dense_plain_matches_jax_at_more_heads(layout, H, HD, dtn):
    """K4's plain version at 2 heads of 32 and 8 heads of 8 (N = 32 and
    8 on the wgmma path) on int8 count blocks of either layout, with an
    unvisited row stripe and a row past the shift-bound gap, against the
    TPU kernel."""
    s, r, n, _ = fixtures.edge_case_graph(seed=0)
    kw = dict(SPLIT, unit_weight=True, values_dtype=np.int8,
              block_layout=layout)
    yj = JG.hybrid_graph(J.build_host_graph(s, r, n, edge_pad_multiple=128),
                         **kw)
    yt = TG.hybrid_graph(TG.build_host_graph(s, r, n, edge_pad_multiple=128),
                         device=CPU, **kw)
    tdt, jdt = DTYPES[dtn]
    h, a_s, a_d, ms = _inputs(n, HD, H)
    pj = JD.gat_dense_partial(yj.dense, jnp.asarray(h, jdt),
                              jnp.asarray(a_s), jnp.asarray(a_d),
                              jnp.asarray(ms), interpret=True)
    pt = TD.gat_dense_partial(yt.dense, torch.from_numpy(h).to(tdt),
                              torch.from_numpy(a_s), torch.from_numpy(a_d),
                              torch.from_numpy(ms))
    _close(pt, pj, TOL[dtn], HD)
    assert float(pt[512:].abs().max()) == 0.0      # unvisited stripe


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_gat_dense_plain_matches_jax_on_float_values(dtn):
    """K4's plain version on 'cr' blocks of float values (the normalised
    edge weights, rounded to h's dtype in both packages) against the TPU
    kernel, at 4 heads of 32."""
    s, r, n, _ = fixtures.edge_case_graph(seed=0)
    kw = dict(SPLIT, block_layout="cr")
    hkw = dict(symmetric_norm=True, edge_pad_multiple=128)
    yj = JG.hybrid_graph(J.build_host_graph(s, r, n, **hkw), **kw)
    yt = TG.hybrid_graph(TG.build_host_graph(s, r, n, **hkw), device=CPU,
                         **kw)
    assert yt.dense.values.dtype == torch.float32
    tdt, jdt = DTYPES[dtn]
    h, a_s, a_d, ms = _inputs(n, 128, 4)
    pj = JD.gat_dense_partial(yj.dense, jnp.asarray(h, jdt),
                              jnp.asarray(a_s), jnp.asarray(a_d),
                              jnp.asarray(ms), interpret=True)
    pt = TD.gat_dense_partial(yt.dense, torch.from_numpy(h).to(tdt),
                              torch.from_numpy(a_s), torch.from_numpy(a_d),
                              torch.from_numpy(ms))
    _close(pt, pj, TOL[dtn], 128)


@pytest.mark.parametrize("H,HD", [(4, 128), (1, 41)])
@pytest.mark.parametrize("layout", ["cr", "rc"])
def test_gat_dense_plain_matches_float64_across_run_cuts(layout, H, HD):
    """K4's plain version on row blocks of 8, 9, 16 and 17 dense blocks
    (the wgmma path's runs of at most 16 cut the last in two, the mma.sync
    path's runs of 8 the last three) against a float64 sum of the same
    terms; the row block without dense blocks reads 0."""
    import dataclasses
    bg = dataclasses.replace(fixtures.seg_block_graph(CPU),
                             values_layout=layout)
    runs = torch.bincount(bg.wide_segments[:, 0].long(),
                          minlength=bg.n_row_blocks)
    assert runs[:4].tolist() == [1, 1, 1, 2]
    R = C = bg.block_rows
    n = bg.n_col_blocks * C
    h, a_s, a_d, ms = _inputs(n, HD, H)
    got = TD.gat_dense_blocks(bg, torch.from_numpy(h), bg.values,
                              torch.from_numpy(a_s), torch.from_numpy(a_d),
                              torch.from_numpy(ms))
    D = HD // H
    want = np.zeros((bg.n_row_blocks * R, HD + H))
    lk = lambda v: np.where(v >= 0, v, 0.2 * v)  # noqa: E731
    vals = bg.values.double().numpy()
    for b, (rb, cb) in enumerate(zip(bg.blk_rb.tolist(),
                                     bg.blk_cb.tolist())):
        cnt = vals[b].T if layout == "cr" else vals[b]          # [R, C]
        rows, cols = slice(rb * R, (rb + 1) * R), slice(cb * C, (cb + 1) * C)
        ad = a_d[rows].astype(np.float64)                       # [R, H]
        e = lk(a_s[cols][None, :, :] + ad[:, None, :]) - lk(ms + ad)[:, None]
        p = cnt[:, :, None] * np.exp(np.minimum(e, 60.0))       # [R, C, H]
        hb = h[cols].reshape(C, H, D).astype(np.float64)
        want[rows, :HD] += np.einsum("rch,chd->rhd", p, hb).reshape(R, HD)
        want[rows, HD:] += p.sum(1)
    _close(got, want, TOL["float32"], HD)
    assert float(got[len(fixtures.SEG_COUNTS) * R:].abs().max()) == 0.0
