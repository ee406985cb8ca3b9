"""PyTorch port: the hand-written CUDA kernels K1-K17 against their plain
PyTorch versions on the edge cases of ``utils/fixtures.kernel_cases`` (the
forward kernels K1-K4), ``utils/fixtures.bwd_kernel_cases`` (the GAT
backward kernels K5-K8), ``utils/fixtures.grouped_kernel_cases`` (the
grouped-tail kernels K9 and K10), ``utils/fixtures.sddmm_kernel_cases``
(the SDDMM kernels K11 and K12), ``utils/fixtures.pair_agg_kernel_cases``
(the pair aggregation K13) and ``utils/fixtures.layer_kernel_cases`` (the
whole GAT layer K14, stage by stage, and the exp-panel dense partial
K15), K17 (GATv2's attention on K13's work list) on that fixture and
the ``gatv2_e11m_serve`` cell's graph, K16 (x W, ``ops/primitives.dense_mm``) at the main path's shapes and
ragged ones, with its gradients and its launches per forward, and the
walk K11 picks at the cuts between its paths.  Also the
sampled trainer's captured CUDA graph against its eager loop on one
seeded stacked epoch (``models/train.EpochRunner``; the losses within
CAPTURE_TOL relative: index_add_'s float atomics reorder sums) and the
device-epoch measurement's restore of the state, bit for bit.

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


@pytest.mark.gpu
def test_gat_hybrid_shared_backward_rounds_once_on_cuda():
    """gat_hybrid's bf16 derive-mode backward on the card (the models'
    path, at the fixture's graph, H = 4 and HD = 128): K5, K6, K7 and K8
    launch once each, ``gat_bwd.shared`` counts 1 under
    ``spans.recording()``, and dh, dw and dad each lie within one bf16
    rounding (2^-8 of the value, plus 1e-5 of the largest for the float32
    atomics' order) of the float32 sums of the same inputs' shares: the
    four kernels' outputs added in float32, then das w^T into dh and
    h^T das for dw, from the a_s the forward saved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3-K8 have no CPU mode")
    import numpy as np

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as D
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as A
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import spans
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    s, r, n, _ = fixtures.edge_case_graph()
    hg = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    hg_t, _ = G.transpose_host_graph(hg)
    hyb, twin = (G.hybrid_graph(g, block_rows=128, block_cols=128,
                                tile_edges=128, min_nnz=100, unit_weight=True,
                                values_dtype=np.int8, block_layout="cr",
                                device=dev) for g in (hg, hg_t))
    assert hyb.dense is not None and twin.dense is not None
    H, HD = 4, 128
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    h, w, a_d, gy = (torch.randn(shape, generator=gen) for shape in
                     ((n, HD), (HD, H), (n, H), (n, HD)))
    tv = [t.to(dev, bf).requires_grad_(True) for t in (h, w * 0.1, a_d)]
    gy = gy.to(dev)
    kernels = (A.gat_bwd_tiles_dad, A.gat_bwd_tiles_src,
               D.gat_dense_bwd_dad, D.gat_dense_bwd_src)
    for k in kernels:
        k.launches = 0
    spans.take()
    with spans.recording():
        y = D.gat_hybrid(hyb, None, tv[0], None, tv[2], w_asrc=tv[1],
                         hyb_t=twin)
        got = torch.autograd.grad((y * gy).sum(), tv, retain_graph=True)
    rec = spans.take()["spans"]
    assert [k.launches for k in kernels] == [1, 1, 1, 1]
    (bwd,) = [sp for sp in rec if sp["name"] == "bwd.gat_hybrid"]
    assert bwd["counters"] == {"gat_bwd.shared": 1}
    assert [g.dtype for g in got] == [bf] * 3

    # the backward's own saved den and a_s: a recomputed den may differ
    # in float32 by the atomics' order, and its bf16 rounding with it
    hb, wb, db, yb, den, a_s = y.grad_fn.saved_tensors
    with torch.no_grad():
        hc, gc, side, msrc = A.bwd_inputs(hb, a_s, db, den, yb, gy)
        side_t = side.to(bf).float()
        dad = (A.gat_bwd_tiles_dad(hyb.tiles, hc, gc, side_t, msrc)
               + D.gat_dense_bwd_dad(hyb.dense, hc, gc,
                                     D._block_values(hyb.dense, bf), side,
                                     msrc))
        sd = (A.gat_bwd_tiles_src(twin.tiles, hc, gc, side_t, msrc)
              + D.gat_dense_bwd_src(twin.dense, hc, gc,
                                    D._block_values(twin.dense, bf), side,
                                    msrc))
        das = sd[:, :H]
        want = (sd[:, H:] + das @ wb.float().T, hb.float().T @ das, dad)
    for name, a, b in zip(("dh", "dw", "dad"), got, want):
        err = (a.float() - b).abs()
        bound = 2.0 ** -8 * b.abs() + 1e-5 * float(b.abs().max())
        assert bool((err <= bound).all()), (name, float((err / bound).max()))
    torch.cuda.synchronize(dev)


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
def test_k13_four_aggregators_keep_the_sum_and_max_on_cuda():
    """K13's instantiation of PNA's four aggregators (min and sum of
    squares too) returns the sum, max and count of the sum-and-max
    instantiation: bit for bit on the rows of one chunk of the work list
    (plain stores, the same slot order), and on the rows cut into chunks
    the same max and count and the sum within float32 sum order (their
    chunks meet by atomics, in an order that varies by run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K13 has no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import pairagg as PA
    dev = torch.device("cuda", 0)
    s, r, n, _ = fixtures.edge_case_graph()
    hg = G.build_host_graph(s, r, n, edge_pad_multiple=128)
    tg = fixtures._dead_tile(G.tile_graph(hg, block_rows=128, block_cols=128,
                                          tile_edges=64, unit_weight=True,
                                          device=dev))
    split = torch.zeros(n, dtype=torch.bool, device=dev)
    split[PA.pair_work(tg, n).split_rows] = True
    assert bool(split.any()) and not bool(split.all())
    gen = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        for D in (41, 48, 128, 300):
            for sf in (None, "leaky_relu"):
                u, v = (torch.randn((n, D), generator=gen, device=dev
                                    ).to(dt) for _ in range(2))
                two = PA.pair_agg(tg, u, v, sf=sf)
                four = PA.pair_agg(tg, u, v, sf=sf, want_min_sq=True)
                assert len(four) == 5
                for i, (a, b) in enumerate(zip(two, four[:3])):
                    assert torch.equal(a[~split], b[~split]), (dt, D, sf, i)
                    if i:
                        assert torch.equal(a[split], b[split])
                    else:
                        err = float((a[split] - b[split]).abs().max())
                        assert err <= 1e-5 * float(a.abs().max()), err
    torch.cuda.synchronize(dev)


_CELL = {}


def _pair_tiling(where):
    """(K13's tiling, rows, feature widths) on the card: the edge-case
    fixture's 128-wide tiling at ET 64 (a dead tile, empty rows, a hub row
    cut into chunks), or the ``pna2_e11m_serve`` cell's graph (232,965
    nodes, its community COO, self loops, hubs+labels order) on the
    ``pair_agg`` kind's 1024² tiles of 512 slots, built once."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    dev = torch.device("cuda", 0)
    if where == "fixture":
        s, r, n, _ = fixtures.edge_case_graph()
        hg = G.build_host_graph(s, r, n, edge_pad_multiple=128)
        return fixtures._dead_tile(G.tile_graph(
            hg, block_rows=128, block_cols=128, tile_edges=64,
            unit_weight=True, device=dev)), n, (41, 48, 128, 300)
    if not _CELL:
        from gnnbench import inputs, spec
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import PAIR_TILE
        cfg = spec.cell("pna2_e11m_serve").config
        s, r, com = inputs.make_graph(cfg, dev)
        hg = G.build_host_graph(s.cpu().numpy(), r.cpu().numpy(),
                                cfg["nodes"], add_self_loops=True,
                                symmetric_norm=True)
        hg, _ = G.reorder_nodes(hg, cfg["reorder_nodes"],
                                labels=com.cpu().numpy())
        _CELL["tg"] = G.tile_graph(
            hg, block_rows=PAIR_TILE.block_rows,
            block_cols=PAIR_TILE.block_cols, tile_edges=PAIR_TILE.tile_edges,
            unit_weight=True, device=dev)
        _CELL["n"], _CELL["D"] = hg.n_node, cfg["hidden"]
    return _CELL["tg"], _CELL["n"], (_CELL["D"],)


def _k13_sequential(work, u, v, sf=None, slope=0.2):
    """K13's arithmetic per chunk of its work list in plain torch: z =
    sf(u[sender] + v[row]) in float32 (0 for a pad sender's u), rounded to
    u's dtype, summed in float32 in slot order (the order each lane group
    sums in), and its max; (sum, max) [chunks, D]."""
    ptr = work.chunk_ptr.long()
    lens = ptr[1:] - ptr[:-1]
    row = work.chunk_row.long()
    row = torch.where(row < 0, -row - 1, row)
    src = work.slot_src.long()
    D = u.shape[1]
    s = torch.zeros((work.n_chunks, D), device=u.device)
    m = torch.full((work.n_chunks, D), float("-inf"), device=u.device)
    uf, vf = u.float(), v.float()
    for j in range(int(lens.max())):
        live = torch.nonzero(lens > j).squeeze(1)
        sj = src[ptr[live] + j]
        z = torch.where((sj >= 0)[:, None], uf[sj.clamp(min=0)], 0.0) \
            + vf[row[live]]
        if sf == "leaky_relu":
            z = torch.where(z >= 0, z, slope * z)
        zr = z.to(u.dtype).float()
        s[live] += zr
        m[live] = torch.maximum(m[live], zr)
    return s, torch.where((lens > 0)[:, None], m, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["fixture", "cell"])
def test_k13_sum_and_max_is_the_sequential_sum_on_cuda(where):
    """K13's sum-and-max instantiation (DGN's, the reference zoo's PNA's)
    on a row of one chunk is its slots' float32 sum in slot order and their
    max, bit for bit, and on a cut row the max and count exactly and the
    sum within float32 sum order; the same holds for the sum, max and count
    of the four-aggregator instantiation's moments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K13 has no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import pairagg as PA
    tg, n, widths = _pair_tiling(where)
    dev = torch.device("cuda", 0)
    work = PA.pair_work(tg, n)
    one = work.chunk_row >= 0
    rows = work.chunk_row[one].long()
    cut = torch.zeros(n, dtype=torch.bool, device=dev)
    cut[work.split_rows] = True
    assert bool(one.any()) and bool(cut.any())
    gen = torch.Generator(device=dev).manual_seed(3)
    for dt in (torch.float32, torch.bfloat16):
        for D in widths:
            for sf in (None, "leaky_relu"):
                u, v = (torch.randn((n, D), generator=gen, device=dev
                                    ).to(dt) for _ in range(2))
                s, m = _k13_sequential(work, u, v, sf)
                ref = PA._pair_agg_reference(tg, u, v, sf=sf)
                for four in (False, True):
                    got = PA.pair_agg(tg, u, v, sf=sf, want_min_sq=four)
                    what = (where, dt, D, sf, four)
                    assert torch.equal(got[0][rows], s[one]), what
                    assert torch.equal(got[1][rows], m[one]), what
                    assert torch.equal(got[1][cut], ref[1][cut]), what
                    assert torch.equal(got[2], ref[2]), what
                    err = float((got[0][cut] - ref[0][cut]).abs().max())
                    assert err <= 1e-5 * float(ref[0][cut].abs().max()), what
    torch.cuda.synchronize(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["fixture", "cell"])
def test_k13_final_layout_equals_moments_and_glue_on_cuda(where):
    """K13's final layout (``pair_agg(..., layout=)``: the epilogue's mean
    and std, the finishing kernel's on the cut rows) against the path
    before it (K13's moments, then mean = sum / c and std = sqrt(relu(sq /
    c - mean^2) + 1e-5) in PyTorch, concatenated): bit for bit on every
    row of one chunk; on the cut rows the min, max and count exactly and
    the mean and std within float32 rounding of the atomics' order
    (``fixtures.pair_layout_gaps``' bound from the sum-order rule); in
    PNA-4x3's order, another order, and two aggregates with the rest left
    in the tensor's last columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K13 has no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir
    tg, n, widths = _pair_tiling(where)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    layouts = (fixtures.PNA_LAYOUT, (ir.STD, ir.MAX, ir.MEAN, ir.MIN),
               (ir.MIN, ir.STD))
    for dt in (torch.float32, torch.bfloat16):
        for D in widths:
            for sf in (None, "leaky_relu"):
                u, v = (torch.randn((n, D), generator=gen, device=dev
                                    ).to(dt) for _ in range(2))
                for layout in layouts:
                    gap = fixtures.pair_layout_gaps(tg, u, v, layout, sf=sf)
                    what = (where, dt, D, sf, layout, gap)
                    assert gap["one_chunk"] and gap["exact"], what
                    assert gap["cut_err"] <= 1.0 and gap["cut_rows"], what
    torch.cuda.synchronize(dev)


@pytest.mark.gpu
def test_published_pna_on_the_hybrid_path_on_cuda():
    """``"PNA-4x3"`` through ``hybrid_schedules`` on the card (K13's
    four-aggregator instantiation, K16) against its per-op path in float32
    and bf16; lowering records ``lower.pair_work`` once with the work
    list's counters and ``lower.degree_scalers`` once a model, and a
    request counts one ``pair_agg.k13`` launch under each layer's
    ``block.pair_agg``, which wrote the final layout (``pair_agg.layout``)
    and finished the work list's cut rows (``pair_agg.cut_rows``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K13 and K16 have no CPU mode")
    import numpy as np
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import spans
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, e = 3000, 40000
    s = rng.integers(0, n, e)
    r = np.concatenate([rng.integers(0, n, e - 3000), np.full(3000, 17)])
    hg = G.build_host_graph(s[s != r], r[s != r], n, add_self_loops=True,
                            symmetric_norm=True)
    g = hg.to_device(dev)
    m = build_model("PNA-4x3", 40, 7, hidden=128, n_layers=2, reorder=True,
                    generator=torch.Generator().manual_seed(0), device=dev)
    x = torch.randn((n, 40), generator=torch.Generator().manual_seed(1)
                    ).to(dev)
    params = dict(m.params)
    sched = TF.hybrid_schedules(m.layers)
    with torch.inference_mode():
        want = m.make_apply()(params, g, x)
        got32 = m.make_apply(schedules=sched, host_graph=hg, device=dev)(
            params, g, x)
        spans.take()
        with spans.recording():
            fn = m.make_apply(torch.bfloat16, schedules=sched,
                              host_graph=hg, device=dev)
            got16 = fn(params, g, x)
        rec = spans.take()["spans"]
    scale = float(want.abs().max())
    assert float((got32 - want).abs().max()) <= 1e-4 * scale
    assert float((got16 - want).abs().max()) <= 3e-2 * scale
    work = [sp for sp in rec if sp["name"] == "lower.pair_work"]
    assert len(work) == 1 and work[0]["counters"]["pair_split_rows"] >= 1
    assert work[0]["counters"]["pair_slots"] == hg.n_edge
    assert work[0]["counters"]["pair_chunks"] >= n
    names = [sp["name"] for sp in rec]
    assert names.count("lower.degree_scalers") == 1
    blocks = [sp for sp in rec if sp["name"] == "block.pair_agg"]
    assert [b["counters"].get("pair_agg.k13") for b in blocks] == [1, 1]
    # each launch wrote the final layout and finished the work list's cut
    # rows
    cut = work[0]["counters"]["pair_split_rows"]
    assert [b["counters"].get("pair_agg.layout") for b in blocks] == [1, 1]
    assert [b["counters"].get("pair_agg.cut_rows") for b in blocks] == [
        cut, cut]
    torch.cuda.synchronize(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["fixture", "cell"])
def test_k17_matches_plain_version_on_cuda(where):
    """K17 (``ops/gatv2.gatv2_attn``) against its plain version on K13's
    work list, float32 and bf16, 4 heads of 32 and 1 head of 41 features:
    on the edge-case fixture (empty rows, a dead tile, a hub row cut into
    chunks) and on the ``gatv2_e11m_serve`` cell's graph and tiling
    (``pna2_e11m_serve``'s: the two configurations share the graph).  A
    row of one slot takes its sender's u exactly (alpha = 1); a row whose
    scores are all equal (attention vectors 0) takes the mean of its
    senders' u; the cut rows come from the finishing kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K17 has no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gatv2 as GV
    from gnnbench import spec
    same = ("nodes", "edges", "graph", "reorder_nodes")
    assert ({k: spec.cell("gatv2_e11m_serve").config[k] for k in same}
            == {k: spec.cell("pna2_e11m_serve").config[k] for k in same})
    tg, n, _ = _pair_tiling(where)
    dev = torch.device("cuda", 0)
    work = GV.gatv2_work(tg, n)
    pw = work.pair
    lens = (pw.chunk_ptr[1:] - pw.chunk_ptr[:-1]).long()
    one = pw.chunk_row >= 0
    rows = pw.chunk_row[one].long()
    single = rows[lens[one] == 1]
    single_src = pw.slot_src[pw.chunk_ptr[:-1][one][lens[one] == 1]].long()
    cut = pw.split_rows
    assert single.numel() and cut.numel() and work.n_parts > cut.numel()
    slot_src = pw.slot_src.long()
    crow = pw.chunk_row.long()
    slot_row = torch.repeat_interleave(torch.where(crow < 0, -crow - 1, crow),
                                       lens)
    gen = torch.Generator(device=dev).manual_seed(5)
    for dt in (torch.float32, torch.bfloat16):
        for H, C in ((4, 32), (1, 41)):
            u, v = (torch.randn((n, H * C), generator=gen, device=dev
                                ).to(dt) for _ in range(2))
            att = torch.randn((H, C), generator=gen, device=dev)
            for a in (att, torch.zeros_like(att)):
                got = GV.gatv2_attn(tg, u, v, a)
                want = GV._gatv2_attn_reference(tg, u, v, a)
                mag = GV._gatv2_attn_reference(tg, u, v, a, magnitude=True)
                what = (where, dt, H, C, bool(a.any()))
                tol = fixtures.K17_TOL
                assert fixtures.k17_error(got, want, mag) <= tol, what
                assert fixtures.k17_error(got, want, mag, cut) <= tol, what
                ok = single_src >= 0
                assert torch.equal(got[single[ok]],
                                   u[single_src[ok]].float()), what
            # attention vectors 0 (the last ``got``): every score equal,
            # the mean of the senders' rows
            keep = slot_src >= 0
            num = torch.zeros((n, H * C), dtype=torch.float64, device=dev)
            num.index_add_(0, slot_row[keep], u[slot_src[keep]].double())
            cnt = torch.bincount(slot_row[keep], minlength=n)[:, None]
            mean = (num / cnt.clamp(min=1)).float()
            assert fixtures.k17_error(got, mean, mag) <= fixtures.K17_TOL
    torch.cuda.synchronize(dev)


@pytest.mark.gpu
def test_gatv2_on_the_hybrid_path_on_cuda():
    """``"GATv2"`` through ``hybrid_schedules`` on the card (K17, K16)
    against its per-op path in float32 and bf16, and its float32 gradients
    through the twin against per-op autograd; lowering records
    ``lower.pair_work`` once with the work list's counters, and a request
    counts one ``gatv2.k17`` launch under each layer's ``block.gatv2``,
    whose finishing kernel merged the work list's cut rows
    (``gatv2.cut_rows``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K17 and K16 have no CPU mode")
    import numpy as np
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import spans
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, e = 3000, 40000
    s = rng.integers(0, n, e)
    r = np.concatenate([rng.integers(0, n, e - 3000), np.full(3000, 17)])
    hg = G.build_host_graph(s[s != r], r[s != r], n, add_self_loops=True,
                            symmetric_norm=True)
    g = hg.to_device(dev)
    m = build_model("GATv2", 40, 7, hidden=128, n_layers=2, heads=4,
                    reorder=True, generator=torch.Generator().manual_seed(0),
                    device=dev)
    x = torch.randn((n, 40), generator=torch.Generator().manual_seed(1)
                    ).to(dev)
    params = dict(m.params)
    sched = TF.hybrid_schedules(m.layers)
    with torch.inference_mode():
        want = m.make_apply()(params, g, x)
        got32 = m.make_apply(schedules=sched, host_graph=hg, device=dev)(
            params, g, x)
        spans.take()
        with spans.recording():
            fn = m.make_apply(torch.bfloat16, schedules=sched,
                              host_graph=hg, device=dev)
            got16 = fn(params, g, x)
        rec = spans.take()["spans"]
    scale = float(want.abs().max())
    assert float((got32 - want).abs().max()) <= 1e-4 * scale
    assert float((got16 - want).abs().max()) <= 3e-2 * scale
    work = [sp for sp in rec if sp["name"] == "lower.pair_work"]
    assert len(work) == 1 and work[0]["counters"]["pair_split_rows"] >= 1
    assert work[0]["counters"]["pair_slots"] == hg.n_edge
    blocks = [sp for sp in rec if sp["name"] == "block.gatv2"]
    cut = work[0]["counters"]["pair_split_rows"]
    assert [b["counters"].get("gatv2.k17") for b in blocks] == [1, 1]
    assert [b["counters"].get("gatv2.cut_rows") for b in blocks] == [cut,
                                                                    cut]
    gy = torch.randn(want.shape, generator=torch.Generator().manual_seed(2)
                     ).to(dev)
    fwd = m.make_apply(schedules=sched, host_graph=hg, device=dev)
    got = torch.autograd.grad((fwd(params, g, x) * gy).sum(),
                              list(params.values()))
    ref = torch.autograd.grad((m.make_apply()(params, g, x) * gy).sum(),
                              list(params.values()))
    for k, a, b in zip(params, got, ref):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), k
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


CAPTURE_TOL = 1e-4


def _sampled_epoch_losses(dev, capture: bool, n_steps: int = 8):
    """Losses of ``n_steps`` GraphSAGE steps on one seeded stacked epoch
    of the tiny dataset (the native sampler), from seeded parameters and
    a fresh capturable AdamW; returns (losses, runner, state, stacked)."""
    import numpy as np

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import native
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.datasets import load_dataset
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.sampling import NeighborSampler
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model

    assert native.HAVE_NATIVE, native.BUILD_ERROR
    ds = load_dataset("tiny")           # 80 train nodes: 10 batches of 8
    sampler = NeighborSampler(ds.host_graph, (5, 5), 8, seed=0)
    perm = sampler.rng.permutation(np.flatnonzero(ds.train_mask))
    stacked = TT.batch_to_device(native.sample_epoch_native(
        sampler.row_ptr, sampler.senders, perm[: n_steps * 8], (5, 5), 8,
        sampler.cap_nodes, sampler.e_pad, 1), dev)
    model = build_model("GraphSAGE", ds.x.shape[1], ds.n_class, hidden=32,
                        generator=torch.Generator().manual_seed(0),
                        device=dev)
    state = TT.TrainState(model.params, TT.adamw(model.params, 1e-2,
                                                 capturable=True))
    update = TT.make_sampled_update(
        model.make_apply(), state, sampler.cap_nodes, sampler.e_pad,
        torch.as_tensor(ds.x, device=dev),
        torch.as_tensor(ds.y.astype(np.int64), device=dev))
    runner = TT.EpochRunner(update, capture=capture)
    losses = torch.zeros(n_steps, device=dev)
    runner.run(stacked, n_steps, losses)
    return losses.cpu(), runner, state, stacked


@pytest.mark.gpu
def test_captured_sampled_epoch_matches_eager_loop():
    """3 eager warm-up steps then 5 replays of the captured step, against
    8 eager steps from the same state on the same batches; then the
    device-epoch measurement restores parameters and AdamW state exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models import train as TT
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cap, runner, state, stacked = _sampled_epoch_losses(dev, True)
    eager, _, _, _ = _sampled_epoch_losses(dev, False)
    assert runner.graph is not None and runner.replays == 5
    rel = ((cap - eager).abs() / eager.abs()).max().item()
    assert rel <= CAPTURE_TOL, (cap.tolist(), eager.tolist())
    snap = TT.snapshot(state)
    sec = TT.device_epoch_seconds(runner, state, stacked, 8)
    assert sec > 0
    for a, b in zip(TT.snapshot(state), snap, strict=True):
        assert torch.equal(a, b)


# K16 (ops/primitives.dense_mm): (M, K, N, x dtype, w dtype, how x is laid
# out).  The main path's shapes first (layer 0, layer 1 and the one- and
# four-column a_src / a_dst products), then ragged ones: M off the 64-row
# tile, x's rows strided (aligned and not), K odd, K past one k-segment, N
# past one column tile, bf16 weights, one row.
K16_CASES = [
    (232965, 602, 128, "float32", "float32", "contiguous"),
    (232965, 128, 41, "float32", "float32", "contiguous"),
    (232965, 128, 4, "float32", "float32", "contiguous"),
    (232965, 128, 1, "float32", "float32", "contiguous"),
    (232965, 602, 128, "bfloat16", "float32", "contiguous"),
    (1000, 602, 128, "float32", "float32", "contiguous"),
    (1000, 602, 41, "float32", "float32", "strided 640"),
    (1000, 602, 128, "float32", "float32", "strided offset 3"),
    (999, 602, 41, "bfloat16", "float32", "strided offset 3"),
    (1000, 43, 41, "float32", "float32", "contiguous"),
    (777, 1500, 128, "float32", "float32", "contiguous"),
    (300, 602, 200, "float32", "float32", "contiguous"),
    (513, 128, 64, "float32", "bfloat16", "contiguous"),
    (1, 602, 128, "float32", "float32", "contiguous"),
]


def _k16_inputs(M, K, N, x_dtype, w_dtype, layout, dev):
    gen = torch.Generator(device=dev).manual_seed(M * 7 + K * 3 + N)
    if layout == "contiguous":
        x = torch.randn((M, K), generator=gen, device=dev)
    else:
        width, off = (640, 0) if layout == "strided 640" else (K + 8, 3)
        x = torch.randn((M, width), generator=gen, device=dev)[:, off:off + K]
    w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
    return x.to(getattr(torch, x_dtype)), w.to(getattr(torch, w_dtype))


def _k16_bound(xh, w):
    """4 K 2^-24 (|x̂| |Ŵ|): the float32 bound on a sum of the same K exact
    products taken in another order."""
    wh = w.to(torch.bfloat16).float()
    return 4 * xh.shape[1] * 2.0 ** -24 * (xh.abs() @ wh.abs())


@pytest.mark.gpu
@pytest.mark.parametrize("case", K16_CASES,
                         ids=["-".join(map(str, c)) for c in K16_CASES])
def test_k16_matches_plain_version_on_cuda(case):
    """K16 against its plain version: y within the bound on reordered float32
    sums, elementwise; x̂ bit for bit; one launch per column tile and
    k-segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K16 has no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    M, K, N = case[:3]
    x, w = _k16_inputs(*case, dev)
    ref, ref_h = P.dense_xw_plain(x, w, True)
    before = P.dense_mm.launches
    y, xh = P._xw_kernel(x, w, True)
    y2, none = P._xw_kernel(x, w, False)
    torch.cuda.synchronize(dev)
    tiles = -(-N // 128)
    segs = -(-K // P._xw_k_step(next(v for v in P.XW_WIDTHS
                                      if v >= min(N, 128))))
    assert P.dense_mm.launches - before == 2 * tiles * segs
    assert none is None
    assert torch.equal(xh, ref_h), "x̂ differs from x.to(bf16).float()"
    assert torch.equal(y, y2)
    bad = (y - ref).abs() > _k16_bound(ref_h, w)
    assert not bool(bad.any()), (int(bad.sum()), float((y - ref).abs().max()))
    assert bool(torch.isfinite(y).all())


@pytest.mark.gpu
@pytest.mark.parametrize("x_grad", [False, True])
def test_k16_gradients_equal_the_plain_chain_on_cuda(x_grad):
    """dense_mm's gradients on the card equal autograd's of the rounded
    float32 chain, bit for bit: the same x̂ (K16 writes it), the same float32
    products and roundings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K16 has no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    x, w = _k16_inputs(5000, 602, 128, "float32", "float32", "contiguous", dev)
    gy = torch.randn((5000, 128), device=dev)
    grads = []
    for fn in (lambda a, b: P.dense_mm(a, b, torch.bfloat16),
               lambda a, b: a.to(torch.bfloat16).float()
               @ b.to(torch.bfloat16).float()):
        a = x.clone().requires_grad_(x_grad)
        b = w.clone().requires_grad_(True)
        fn(a, b).backward(gy)
        grads.append((a.grad, b.grad))
    assert torch.equal(grads[0][1], grads[1][1])
    if x_grad:
        assert torch.equal(grads[0][0], grads[1][0])


@pytest.mark.gpu
@pytest.mark.parametrize("network", ["GCN", "GAT"])
def test_k16_launches_once_per_per_op_mm(network):
    """A bf16 forward of the cells' hybrid lowering launches K16 once for
    every MM op its per-op blocks evaluate, and its answer holds the per-op
    path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K16 has no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler.fusion import hybrid_schedules
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.data.datasets import synthetic_coo
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.models.zoo import build_model
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    n = 4000
    s, r, _ = synthetic_coo(n, 60_000, seed=3, communities=20, p_in=0.7)
    hg = G.build_host_graph(s, r, n, add_self_loops=True,
                            symmetric_norm=True)
    model = build_model(network, 602, 41, hidden=128, n_layers=2, heads=4,
                        reorder=network == "GCN",
                        generator=torch.Generator().manual_seed(0),
                        device=dev)
    fwd = model.make_apply(torch.bfloat16,
                           schedules=hybrid_schedules(model.layers),
                           host_graph=hg, device=dev)
    mms = sum(1 for layer, fn in zip(model.layers, fwd.layer_fns)
              for kind, block, _, _ in fn.plans if kind == "xla"
              for oid in block if layer.by_id[oid].compute == ir.MM)
    g = hg.to_device(dev)
    x = torch.randn((n, 602), generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev)
    with torch.inference_mode():
        params = dict(model.params)
        before = P.dense_mm.launches
        y = fwd(params, g, x)
        launched = P.dense_mm.launches - before
        ref = model.make_apply(torch.bfloat16)(params, g, x)
    assert mms > 0 and launched == mms, (launched, mms)
    rel = float((y - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    assert rel <= 2e-2, rel


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["float64 x", "float16 x", "3-d x", "1-d x"])
def test_k16_serves_other_dtypes_and_leading_dims_on_cuda(how):
    """dense_mm's bf16 product launches K16 for x of another dtype (rounded
    to bf16 once first, as the plain formula does) and for x whose leading
    dimensions are rows; the answer holds the plain formula's within the
    bound on reordered float32 sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K16 has no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    x, w = _k16_inputs(600, 602, 41, "float32", "float32", "contiguous", dev)
    if how == "float64 x":
        x = x.double()
    elif how == "float16 x":
        x = x.half()
    elif how == "3-d x":
        x = x.reshape(4, 150, 602)
    else:
        x = x[7]
    before = P.dense_mm.launches
    with torch.inference_mode():
        y = P.dense_mm(x, w, torch.bfloat16)
    torch.cuda.synchronize(dev)
    assert P.dense_mm.launches - before == 1
    ref = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    assert y.dtype == torch.float32 and y.shape == ref.shape
    xh = x.to(torch.bfloat16).float().reshape(-1, 602)
    bound = _k16_bound(xh, w).reshape(ref.shape)
    assert not bool(((y - ref).abs() > bound).any())
