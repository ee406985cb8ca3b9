"""PyTorch port: the hand-written CUDA kernels K1-K4 against their plain
PyTorch versions on the edge cases of ``utils/fixtures.kernel_cases``.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed.  On a machine with a CUDA device:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)  The
``gpu`` test skips without a CUDA device: a CUDA kernel has no CPU mode.
Tolerance: |kernel - plain| <= KERNEL_TOL[dtype] times each row's scale,
num and den columns apart, widened only for f32 rows that sum more than
1,759 terms (``utils/fixtures.kernel_error`` says why)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import _ext  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

KERNELS = {"spmm_tiles", "spmm_dense_blocks", "gat_tiles", "gat_dense_blocks"}


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
    geo = dict(block_rows=128, block_cols=128, tile_edges=128)
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


def test_kernel_cases_run_on_cpu():
    """The case list itself (graphs, inputs, wrappers) runs on the CPU,
    where every wrapper takes its plain version."""
    _check_cases(torch.device("cpu"))


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
