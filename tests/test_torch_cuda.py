"""PyTorch port: the hand-written CUDA kernels K1-K15 against their plain
PyTorch versions on the edge cases of ``utils/fixtures.kernel_cases`` (the
forward kernels K1-K4), ``utils/fixtures.bwd_kernel_cases`` (the GAT
backward kernels K5-K8), ``utils/fixtures.grouped_kernel_cases`` (the
grouped-tail kernels K9 and K10), ``utils/fixtures.sddmm_kernel_cases``
(the SDDMM kernels K11 and K12), ``utils/fixtures.pair_agg_kernel_cases``
(the pair aggregation K13) and ``utils/fixtures.layer_kernel_cases`` (the
whole GAT layer K14, stage by stage, and the exp-panel dense partial
K15), and the walk K11 picks at the cuts between its paths.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed.  On a machine with a CUDA device:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)  The
``gpu`` test skips without a CUDA device: a CUDA kernel has no CPU mode.
Tolerance: |kernel - plain| <= KERNEL_TOL[dtype] times each row's scale,
num and den columns apart, widened only for f32 rows that sum more than
1,759 terms (``utils/fixtures.kernel_error`` says why); the backward
kernels' scale is each cell's sum of |term|, since their sums cancel, and
so is that of K11-K13's sums (a dot or a pair sum may cancel)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import _ext  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

KERNELS = {"spmm_tiles", "spmm_dense_blocks", "gat_tiles", "gat_dense_blocks"}
CPU = torch.device("cpu")   # the port's entry points default to the card


def _check_cases(device):
    seen = set()
    for c in fixtures.kernel_cases(device):
        assert c.out.device == c.ref.device == device, (c.kernel, c.case)
        fixtures.check_kernel(c)
        seen.add((c.kernel, c.dtype_name))
    assert seen == {(k, d) for k in KERNELS for d in fixtures.KERNEL_TOL}


def test_kernel_error_scales_by_row_and_column_group():
    """A fault confined to the num columns of one row fails the check even
    when den columns elsewhere run far larger; an all-zero row must stay
    zero; sum-order noise passes, and a row that sums many terms may carry
    more of it."""
    K = fixtures.KernelCase
    gen = torch.Generator().manual_seed(0)
    ref = torch.randn((64, 12), generator=gen)
    ref[:, 8:] = ref[:, 8:].abs() * 1000.0          # den columns
    noisy = ref * (1 + 1e-7 * torch.randn(ref.shape, generator=gen))
    assert fixtures.kernel_error(K("k", "noise", "float32", noisy, ref,
                                   split=8))[1] <= 1.0
    bad = ref.clone()
    bad[3, :8] *= 1.05
    with pytest.raises(AssertionError):
        fixtures.check_kernel(K("k", "num fault", "bfloat16", bad, ref, 8))
    assert fixtures.kernel_error(K("k", "num fault", "bfloat16", bad,
                                   ref))[1] <= 1.0, \
        "without the split the den scale hides the fault"
    zero = torch.zeros((4, 12))
    off = zero.clone()
    off[2, 5] = 1e-7
    with pytest.raises(AssertionError):
        fixtures.check_kernel(K("k", "zero row", "float32", off, zero))
    hub = ref * (1 + 3e-5)                          # 500 u: a hub's sum order
    with pytest.raises(AssertionError):
        fixtures.check_kernel(K("k", "few terms", "float32", hub, ref))
    terms = torch.full((64,), 1e5)
    fixtures.check_kernel(K("k", "1e5 terms", "float32", hub, ref,
                            terms=terms))


def test_row_terms_count_live_slots_and_dense_cells():
    """row_terms counts a row's live tile slots (its in-degree on a plain
    tiling) and nonzero dense cells: on the hybrid split, one per distinct
    pair, plus the merged tail slot of the pair past the int8 maximum."""
    import numpy as np

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    s, r, n, _ = fixtures.edge_case_graph()
    hg = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    geo = dict(block_rows=128, block_cols=128, tile_edges=128, device=CPU)
    deg = torch.bincount(torch.from_numpy(r.astype(np.int64)),
                         minlength=n).float()
    assert torch.equal(fixtures.row_terms(G.tile_graph(hg, **geo)), deg)
    pairs = np.unique(np.stack([s, r]), axis=1)
    expect = torch.bincount(torch.from_numpy(pairs[1].astype(np.int64)),
                            minlength=n).float()
    expect[fixtures.HOT_PAIR[1]] += 1
    for layout in ("cr", "rc"):
        hy = G.hybrid_graph(hg, min_nnz=64, unit_weight=True,
                            values_dtype=np.int8, block_layout=layout, **geo)
        got = fixtures.row_terms(hy.tiles) + fixtures.row_terms(hy.dense)[:n]
        assert torch.equal(got, expect), layout


def test_profile_counts_overlapping_device_time_once():
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import profile
    trace = {"traceEvents": [
        {"cat": "kernel", "name": "a", "ts": 0.0, "dur": 1000.0},
        {"cat": "kernel", "name": "b", "ts": 500.0, "dur": 1000.0},
        {"cat": "gpu_memcpy", "name": "c", "ts": 3000.0, "dur": 500.0},
        {"cat": "cpu_op", "name": "a", "ts": 0.0, "dur": 9000.0},
        {"cat": "kernel", "name": "a", "ts": 4000.0, "dur": 1000.0},
    ]}
    st = profile.summarize(profile.device_events(trace), wall_ms=10.0)
    assert st["busy_ms"] == pytest.approx(3.0)
    assert st["idle_share"] == pytest.approx(0.7)
    assert st["by_name"][0] == ("a", pytest.approx(2.0), 2)


def _check_bwd_cases(device):
    seen = set()
    for c in fixtures.bwd_kernel_cases(device):
        assert c.out.device == c.ref.device == device, (c.kernel, c.case)
        fixtures.check_kernel(c)
        seen.add((c.kernel, c.dtype_name))
    assert seen == {(k, d) for k in fixtures.BWD_KERNELS
                    for d in fixtures.KERNEL_TOL}


def test_bwd_kernel_cases_run_on_cpu():
    """The backward case list runs on the CPU, where every wrapper takes
    its plain version; a fault planted in one cell of an output fails the
    sum-of-|term| check."""
    _check_bwd_cases(CPU)
    c = next(c for c in fixtures.bwd_kernel_cases(CPU)
             if c.kernel == "gat_dense_bwd_src")
    bad = c.out.clone()
    bad[7, 0] += 0.05 * float(c.scale[7].abs().max())
    with pytest.raises(AssertionError):
        fixtures.check_kernel(c._replace(out=bad))


def test_kernel_cases_run_on_cpu():
    """The case list itself (graphs, inputs, wrappers) runs on the CPU,
    where every wrapper takes its plain version."""
    _check_cases(CPU)


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1-K4 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _ext.library()
    _check_cases(dev)
    torch.cuda.synchronize(dev)


@pytest.mark.gpu
def test_bwd_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5-K8 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _ext.library()
    _check_bwd_cases(dev)
    torch.cuda.synchronize(dev)


def _check_grouped_cases(device):
    seen = set()
    for c in fixtures.grouped_kernel_cases(device):
        assert c.out.device == c.ref.device == device, (c.kernel, c.case)
        fixtures.check_kernel(c)
        seen.add((c.kernel, c.dtype_name))
    assert seen == {(k, d) for k in fixtures.GROUPED_KERNELS
                    for d in fixtures.KERNEL_TOL}


def test_grouped_kernel_cases_run_on_cpu():
    """The grouped case list (tilings with a padding chunk, unit and
    weighted streams, a merged multi-edge slot) runs on the CPU, where the
    K9 and K10 wrappers take their plain versions; a fault in one num
    cell fails the row-scaled check."""
    _check_grouped_cases(CPU)
    c = next(c for c in fixtures.grouped_kernel_cases(CPU)
             if c.kernel == "gat_grouped")
    bad = c.out.clone()
    row = int(c.ref[:, 0].abs().argmax())
    bad[row, 0] *= 1.05
    with pytest.raises(AssertionError):
        fixtures.check_kernel(c._replace(out=bad))


@pytest.mark.gpu
def test_grouped_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K9 and K10 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _ext.library()
    _check_grouped_cases(dev)
    torch.cuda.synchronize(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("tail_only", ["forward", "twin"])
def test_gat_hybrid_backward_on_cuda_when_one_split_has_no_dense_blocks(
        monkeypatch, tail_only):
    """With a twin, gat_hybrid's backward stays on the kernels even when
    only one of the two splits has dense blocks: the dense backward kernel
    of the split that has them launches (K7 for the forward split, K8 for
    the twin), the full-graph formulation is never called, and the float32
    gradients match the same call on CPU tensors (the plain versions)
    within 1e-4 of each gradient's max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3-K8 have no CPU mode")
    import numpy as np

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    s, r, n, _ = fixtures.edge_case_graph()
    hg = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    hg_t, _ = G.transpose_host_graph(hg)
    split = dict(block_rows=128, block_cols=128, tile_edges=128,
                 unit_weight=True, values_dtype=np.int8, block_layout="cr")

    def boom(*a, **k):
        raise AssertionError("full-graph backward taken")

    monkeypatch.setattr(D, "_gat_reference_g", boom)
    grads = {}
    for device in (CPU, dev):
        # min_nnz 0 sends every edge of that split to the tail
        hyb, twin = (G.hybrid_graph(g, min_nnz=0 if tail else 100,
                                    device=device, **split)
                     for g, tail in ((hg, tail_only == "forward"),
                                     (hg_t, tail_only == "twin")))
        assert (hyb.dense is None) == (tail_only == "forward")
        assert (twin.dense is None) == (tail_only == "twin")
        gen = torch.Generator().manual_seed(0)
        h, a_s, a_d, gy = (torch.randn(shape, generator=gen) for shape in
                           ((n, 16), (n, 4), (n, 4), (n, 16)))
        tv = [t.to(device).requires_grad_(True) for t in (h, a_s, a_d)]
        D.gat_dense_bwd_dad.launches = D.gat_dense_bwd_src.launches = 0
        y = D.gat_hybrid(hyb, None, *tv, hyb_t=twin)
        grads[device.type] = torch.autograd.grad(
            (y * gy.to(device)).sum(), tv)
    assert D.gat_dense_bwd_dad.launches == int(tail_only == "twin")
    assert D.gat_dense_bwd_src.launches == int(tail_only == "forward")
    for a, b in zip(grads["cuda"], grads["cpu"]):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), err


def _check_new_cases(device):
    seen = set()
    for cases in (fixtures.sddmm_kernel_cases, fixtures.pair_agg_kernel_cases):
        for c in cases(device):
            assert c.out.device == c.ref.device == device, (c.kernel, c.case)
            fixtures.check_kernel(c)
            seen.add((c.kernel, c.dtype_name))
    assert seen == {(k, d) for k in fixtures.SDDMM_KERNELS
                    + fixtures.PAIR_KERNELS for d in fixtures.KERNEL_TOL}


def test_sddmm_and_pair_agg_cases_run_on_cpu():
    """The SDDMM and pair-aggregate case lists (a dead tile, grouped
    tilings with padding, heads narrower and wider than a warp, an
    all-negative row, a hub of duplicate edges, two feature passes) run on
    the CPU, where the K11-K13 wrappers take their plain versions; a fault
    in one slot's dot, or one cell of a max, fails the check."""
    _check_new_cases(CPU)
    for kernel, what in (("sddmm_grouped", "H=4 P=32"), ("pair_agg", "max")):
        c = next(c for c in (*fixtures.sddmm_kernel_cases(CPU),
                             *fixtures.pair_agg_kernel_cases(CPU))
                 if c.kernel == kernel and what in c.case)
        bad = c.out.clone()
        row = int(c.ref.abs().amax(dim=1).argmax())
        bad[row, 0] += 0.05 * float(c.ref[row].abs().max())
        with pytest.raises(AssertionError):
            fixtures.check_kernel(c._replace(out=bad))


@pytest.mark.gpu
def test_sddmm_and_pair_agg_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K11-K13 have no CPU mode")
    dev = torch.device("cuda", 0)
    _ext.library()
    _check_new_cases(dev)
    torch.cuda.synchronize(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
def test_k11_walk_follows_the_cuts(dtn):
    """The walk K11 takes (``ops/sddmm.k11_walk``, named by its launch) at
    the fixture shapes either side of its cuts: rows of at most 32 bytes a lane
    per slot (whole-row loads for a power-of-two F on aligned rows), wider
    ones by lane groups, segmented head trees where a head is a power of
    two of loads' lanes, past 8 heads only where each head lies within one
    load; rows one element off alignment give up the wide loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk is the library's choice")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sddmm as TS
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtn]
    bf = dt == torch.bfloat16
    s, r, n, _ = fixtures.edge_case_graph()
    tg = TG.tile_graph(TG.build_host_graph(s, r, n, edge_pad_multiple=128),
                       block_rows=128, block_cols=128, tile_edges=64,
                       device="cuda")

    def walk(H, P, unaligned=False):
        x = torch.zeros((n, H * P), dtype=dt, device="cuda")
        if unaligned:
            x = fixtures._unaligned(x)
        TS.sddmm_tiles(tg, x, x, H)
        return TS.k11_walk()

    lane16 = "a lane per slot, 16-byte loads"
    scalar = "a lane per slot, a feature at a time"
    groups = "half-warps" if bf else "whole warps"
    seg = f"lane groups ({groups}, 4 a load), head sums by segmented trees"
    assert walk(1, 2) == ("a lane per slot, 4-byte loads" if bf else
                          "a lane per slot, 8-byte loads")
    assert walk(4, 2) == lane16
    assert walk(8, 2) == (lane16 if bf else
                          "lane groups (whole warps, 4 a load), head sums "
                          "by a tree a head")
    assert walk(3, 4) == (scalar if bf else seg)
    assert walk(5, 1) == scalar
    assert walk(9, 2) == scalar
    assert walk(1, 128) == walk(4, 32) == seg
    assert walk(128, 1) == f"lane groups ({groups}, 4 a load), heads within a load"
    assert walk(16, 4) == walk(128, 1)
    assert walk(2, 41) == ("lane groups (whole warps, 1 a load), head sums "
                           "by a tree a head")
    assert walk(4, 2, unaligned=True) == scalar
    assert walk(1, 128, unaligned=True) == (
        "lane groups (whole warps, 1 a load), head sums by segmented trees")
    assert walk(128, 1, unaligned=True) == (
        "lane groups (whole warps, 1 a load), heads within a load")


def _check_layer_cases(device):
    seen = set()
    for c in fixtures.layer_kernel_cases(device):
        assert c.out.device == c.ref.device == device, (c.kernel, c.case)
        fixtures.check_kernel(c)
        seen.add((c.kernel, c.dtype_name))
    assert seen == {(k, d) for k in fixtures.LAYER_KERNELS
                    for d in fixtures.KERNEL_TOL}


def test_layer_cases_run_on_cpu():
    """The K14 / K15 case list runs on the CPU, where the wrappers take
    their plain versions; a fault in one cell of K15's num fails it."""
    _check_layer_cases(CPU)
    c = next(c for c in fixtures.layer_kernel_cases(CPU)
             if c.kernel == "gat_dense_panel")
    bad = c.out.clone()
    row = int(c.ref[:, 0].abs().argmax())
    bad[row, 0] *= 1.05
    with pytest.raises(AssertionError):
        fixtures.check_kernel(c._replace(out=bad))


@pytest.mark.gpu
def test_layer_kernels_match_plain_versions_on_cuda():
    """K14 and K15 on the card: the launch counts rise (the projection
    stage alone does not count), and every case holds its bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K14 and K15 have no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _ext.library()
    A.gat_layer_tiles.launches = D.gat_dense_panel_blocks.launches = 0
    _check_layer_cases(dev)
    torch.cuda.synchronize(dev)
    assert A.gat_layer_tiles.launches > 0
    assert D.gat_dense_panel_blocks.launches > 0
