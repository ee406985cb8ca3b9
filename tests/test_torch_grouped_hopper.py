"""PyTorch port: K10's two forms of a_s, on the CPU; K12's fixture cases.

K10 (``csrc/gat_grouped.cu``) reads a per-node float32 a_s, as K3 does: the
wrapper ``ops/gat.gat_grouped`` takes exactly one of ``w_asrc`` (derive
mode: the entry point forms a_s = h @ w_asrc first) and ``a_src`` (the
array the grouped hybrid path computes once, which its msrc and the dense
partial K4 read too).  On the CPU each form takes its plain version; the
two forms are held to each other on every grouped tiling of
``utils/fixtures.grouped_tilings`` at K10's fixture head shapes, within the
bounds ``tests/test_torch_grouped.py::test_grouped_gat_partials_match_jax``
holds the plain version to JAX by (float32: max |a - b| <= 1e-5 max(1, max
|b|), num and den columns apart; bfloat16: each row within 1e-2 of its
largest |b|, num and den apart: the two forms differ only in the sum order
of a_s, and a flip of one rounded p or p h moves a term by at most 2^-8 of
itself).  ``_gat_hybrid_raw`` on a grouped tail must hand K10 the very
a_s tensor whose max is its msrc and which K4 reads.

K12 (``csrc/sddmm_grouped.cu``) walks ``GroupedTiledGraph.live_sub`` by
K11's walks and writes every slot itself.  ``utils/fixtures.
sddmm_kernel_cases`` must hold its edge cases (a dead chunk whose slots
look live, ET 50, sub-tiles whose prefix ends mid-window, rows off the
vector loads' alignment) at every ``SDDMM_SHAPES`` entry and dtype; on the
CPU each case is the plain version against itself, so the test holds the
case list, the dead chunk's zeros, and that a fault in one slot fails the
check.  On the card (``gpu``) K12's output lies over NaN and each case
must lie within ``fixtures.kernel_error``'s bound (each slot's scale its
heads' sums of |product|), and K12 names the walk K11 names for the same
rows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as TA  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import sddmm as TSd  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TILINGS = fixtures.grouped_tilings(CPU)


def _inputs(n: int, HD: int, H: int, dt, seed: int = 0):
    rng = np.random.default_rng(seed)
    h = torch.tensor(rng.standard_normal((n, HD)), dtype=dt)
    w = torch.tensor(rng.standard_normal((HD, H)) / np.sqrt(HD), dtype=dt)
    a_d = torch.tensor(rng.standard_normal((n, H)), dtype=torch.float32)
    a_s = TD._a_s_kernel(h, w)
    return h, w, a_d, a_s, a_s.amax(0, keepdim=True)


def _close(got, want, tol):
    bound = tol * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= bound, (err, bound)


def _close_rows(got, want, tol):
    scale = want.abs().amax(dim=1)
    scale = torch.clamp(scale, min=1e-6 * max(1.0, float(scale.max())))
    share = float(((got - want).abs().amax(dim=1) / (tol * scale)).max())
    assert share <= 1.0, share


def test_k10_wrapper_takes_one_a_s_form():
    """Exactly one of ``w_asrc`` and ``a_src``; on CPU tensors derive mode
    is the plain version ``_gat_grouped_reference``, and the float32 a_src
    is read as it is (rounding it to bf16 changes the partials)."""
    tg = TILINGS["cr int8 unit tail"]
    h, w, a_d, a_s, ms = _inputs(tg.n_node, 128, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="exactly one"):
        TA.gat_grouped(tg, h, a_d, ms)
    with pytest.raises(ValueError, match="exactly one"):
        TA.gat_grouped(tg, h, a_d, ms, w, a_src=a_s)
    assert torch.equal(TA.gat_grouped(tg, h, a_d, ms, w),
                       TA._gat_grouped_reference(tg, h, a_d, ms, w))
    f32 = TA.gat_grouped(tg, h, a_d, ms, a_src=a_s)
    rounded = TA.gat_grouped(tg, h, a_d, ms,
                             a_src=a_s.to(torch.bfloat16).float())
    assert not torch.equal(f32, rounded)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,HD", [(4, 128), (1, 41), (16, 16)])
@pytest.mark.parametrize("tiling", list(TILINGS))
def test_k10_derive_and_a_src_forms_agree(tiling, H, HD, dtn):
    """K10's wrapper in derive mode and with the float32 a_s of the same h
    and w_asrc: the same raw [num | den] within the bounds of the module
    docstring, num and den apart; merged multi-edge slots ('cr int8 unit
    tail') and the weight stream ('weighted R32 G2') included."""
    tg = TILINGS[tiling]
    h, w, a_d, a_s, ms = _inputs(tg.n_node, HD, H, DTYPES[dtn], seed=H)
    derive = TA.gat_grouped(tg, h, a_d, ms, w)
    given = TA.gat_grouped(tg, h, a_d, ms, a_src=a_s)
    assert derive.shape == given.shape == (tg.n_node, HD + H)
    assert float(derive[:, HD:].max()) > 0.0
    for cols in (slice(0, HD), slice(HD, None)):
        if dtn == "float32":
            _close(given[:, cols], derive[:, cols], TOL[dtn])
        else:
            _close_rows(given[:, cols], derive[:, cols], TOL[dtn])


def test_gat_hybrid_raw_hands_k10_the_a_s_of_msrc_and_k4(monkeypatch):
    """On a split with dense blocks and a grouped tail, ``_gat_hybrid_raw``
    forms a_s once and hands that tensor to K10 (as ``a_src``, no
    ``w_asrc``) and to the dense partial (K4), with msrc its column max,
    and returns it beside the raw partials (the backward reads it): one
    a_src precision for every partial."""
    s, r, n, _ = fixtures.edge_case_graph()
    hg = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    hyb = TG.hybrid_graph(hg, block_rows=128, block_cols=128, tile_edges=64,
                          min_nnz=64, unit_weight=True, block_layout="cr",
                          values_dtype=np.int8, tail_format="grouped",
                          tail_group=4, device=CPU)
    assert isinstance(hyb.tiles, TG.GroupedTiledGraph)
    assert hyb.dense is not None
    h, w, a_d, _, _ = _inputs(n, 128, 4, torch.bfloat16)
    seen = {}
    a_s_kernel, k10, k4 = TD._a_s_kernel, TA.gat_grouped, TD.gat_dense_partial

    def a_s_rec(*args):
        seen["a_s"] = a_s_kernel(*args)
        return seen["a_s"]

    def k10_rec(tg, h, a_dst, msrc, w_asrc=None, **kw):
        seen["k10"] = (w_asrc, kw.get("a_src"), msrc)
        return k10(tg, h, a_dst, msrc, w_asrc, **kw)

    def k4_rec(bg, h, a_s, a_dst, msrc, **kw):
        seen["k4"] = (a_s, msrc)
        return k4(bg, h, a_s, a_dst, msrc, **kw)

    monkeypatch.setattr(TD, "_a_s_kernel", a_s_rec)
    monkeypatch.setattr(TA, "gat_grouped", k10_rec)
    monkeypatch.setattr(TD, "gat_dense_partial", k4_rec)
    acc, a_ret = TD._gat_hybrid_raw(hyb, h, w, a_d, True, 0.2)
    assert acc.shape == (n, 128 + 4)
    a_s = seen["a_s"]
    w_k10, a_k10, ms_k10 = seen["k10"]
    a_k4, ms_k4 = seen["k4"]
    assert w_k10 is None and a_k10 is a_s and a_k4 is a_s and a_ret is a_s
    want = a_s.amax(0, keepdim=True)
    assert torch.equal(ms_k10, want) and torch.equal(ms_k4, want)


K12_TAGS = ("R32 G2", "R128 G4 dead chunk", "ET 50 G2")


def _k12_cases(device, H=None, P=None):
    """K12's fixture cases (at one shape where H and P are given)."""
    return [c for c in fixtures.sddmm_kernel_cases(device)
            if c.kernel == "sddmm_grouped"
            and (H is None or f" H={H} P={P}" in c.case)]


def test_k12_fixture_cases_hold_the_edge_cases():
    cases = _k12_cases(CPU)
    names = {(c.case, c.dtype_name) for c in cases}
    for dtn in DTYPES:
        for H, P in fixtures.SDDMM_SHAPES:
            for tag in K12_TAGS:
                assert (f"{tag} H={H} P={P}", dtn) in names
            assert (f"R128 G4 dead chunk H={H} P={P}: dead chunk is 0",
                    dtn) in names
            if (H, P) in fixtures.SDDMM_UNALIGNED:
                assert (f"R128 G4 dead chunk H={H} P={P} unaligned",
                        dtn) in names
    for c in cases:
        fixtures.check_kernel(c)
        if c.case.endswith("dead chunk is 0"):
            assert c.out.numel() and not bool(c.out.any())
    # the dead chunk's slots look live: its sub-tiles are on the work list
    s, r, n, _ = fixtures.edge_case_graph()
    hg = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    tg, c = fixtures._dead_chunk(TG.tile_graph_grouped(
        hg, block_rows=128, block_cols=128, tile_edges=64, group=4,
        device=CPU))
    assert int(tg.chunk_cb[c]) == -1
    assert bool(((tg.live_sub // tg.group) == c).any())
    # a fault in one slot's dot fails the check
    c = next(c for c in cases if "ET 50 G2 H=4 P=32" in c.case)
    bad = c.out.clone()
    row = int(c.ref.abs().amax(dim=1).argmax())
    bad[row, 0] += 0.05 * float(c.ref[row].abs().max())
    with pytest.raises(AssertionError):
        fixtures.check_kernel(c._replace(out=bad))


@pytest.mark.gpu
@pytest.mark.parametrize("H,P", fixtures.SDDMM_SHAPES)
def test_k12_matches_its_plain_version_on_cuda(H, P):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K12 has no CPU mode")
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import _ext
    dev = torch.device("cuda", 0)
    _ext.library()
    cases = _k12_cases(dev, H, P)
    assert len(cases) == 2 * (len(K12_TAGS) + 1 + 2 * (
        (H, P) in fixtures.SDDMM_UNALIGNED))
    for c in cases:
        assert c.out.device == c.ref.device == dev
        fixtures.check_kernel(c)
    torch.cuda.synchronize(dev)
    # K12 picks its walk by K11's rule
    s, r, n, _ = fixtures.edge_case_graph()
    hg = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    tg = TG.tile_graph(hg, block_rows=128, block_cols=128, tile_edges=64,
                       device=dev)
    gg = TG.tile_graph_grouped(hg, block_rows=128, block_cols=128,
                               tile_edges=64, group=4, device=dev)
    for dt in DTYPES.values():
        x = torch.zeros((n, H * P), dtype=dt, device=dev)
        for rows in (x, fixtures._unaligned(x)):
            TSd.sddmm_tiles(tg, rows, rows, H)
            TSd.sddmm_grouped(gg, rows, rows, H)
            assert TSd.k12_walk() == TSd.k11_walk()
