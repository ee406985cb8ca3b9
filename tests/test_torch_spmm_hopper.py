"""PyTorch port: the schedule arrays that the Hopper SpMM kernels K1, K2
and K9 read, and their plain versions on the graphs made to reach the
kernels' work splits.

K9 (``csrc/spmm_grouped.cu``) launches a warp per entry of
``GroupedTiledGraph.live_sub``, which reads only each sub-tile's slot 0:
it must list exactly the sub-tiles that hold an edge, on every grouped
tiling of the fixture cases (a stripe group without edges, the hub's deep
spill levels) and on a graph without edges.  K9's plain version is held
to the TPU kernel on the hub's grouped tiling at F = 8, 128 and 300, with
and without edge weights.

K1 (``csrc/spmm_tiles.cu``) walks each tile's slots up to the first 32
without an edge, which relies on the builders putting a tile's edges in a
prefix of its slots; K2's bf16 path (``csrc/spmm_dense_blocks.cu``)
walks ``DenseBlockGraph.wide_segments`` (runs of at most
``DENSE_WIDE_SEGMENT`` dense blocks of one row block), its float32 path
``segments``.  These tests hold every one of those arrays to cover each
live slot and dense block exactly once, on the fixture graph (a dead
tile, a row block without dense blocks, more than 127 copies of one pair),
on a hub graph (full tiles, runs longer than a tile) and on a dense-block
graph with row blocks of 8, 9, 16 and 17 blocks (both
sides of each cut).  The plain versions, which the CPU wrappers take, are
held on those graphs to the JAX package's TPU kernel (K1, Pallas interpret
mode) and to a float64 product (K2): float32 max |port - ref| <= 1e-5 *
max(1, max |ref|), the same terms summed in another order.  The kernels
themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import spmm as JS  # noqa: E402

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import schedule as TSc  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
F32_TOL = 1e-5
SPLIT = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=64,
             values_dtype=np.int8)


def _close(port, ref, tol=F32_TOL):
    port = port.float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _fixture_host(symmetric_norm=True):
    s, r, n, _ = fixtures.edge_case_graph(seed=0)
    return TG.build_host_graph(s, r, n, symmetric_norm=symmetric_norm,
                               edge_pad_multiple=128)


def _tilings():
    """name -> TiledGraph: the builders' per-tile tilings K1 walks."""
    hg, hu = _fixture_host(), _fixture_host(symmetric_norm=False)
    return {
        "fixture, dead tile": fixtures._dead_tile(TG.tile_graph(
            hg, block_rows=128, block_cols=128, tile_edges=128, device=CPU)),
        "fixture hybrid tail (merged copies)": TG.hybrid_graph(
            hu, unit_weight=True, block_layout="cr", device=CPU,
            **SPLIT).tiles,
        "hub": fixtures.hub_tiling(CPU),
        "hub hybrid tail": TG.hybrid_graph(TG.build_host_graph(
            *fixtures.hub_graph()[:2], fixtures.hub_graph()[2],
            symmetric_norm=True), device=CPU, **SPLIT).tiles,
        **_gat_tilings(),
        **_sddmm_tilings(),
    }


def _gat_tilings():
    """name -> TiledGraph: the attention tilings K3 walks, and their
    transposed twins, which K6 walks (built as
    ``compiler/fusion.lower_schedule(..., build_transpose=True)`` builds
    them: the same builder over ``transpose_host_graph``), on the hub graph
    with 12,000 random edges (a 512 x 1024 tail block then holds ~1,500 of
    them): the hybrid GAT tails at the smoke's geometry (256-wide dense
    grid, 512 x 1024 tail tiles of 512 slots, unit weight, 'cr' int8
    blocks) at its two layers' thresholds, and the one-hot ``gat`` kind's
    tiling (512 x 1024, ET 512)."""
    s, r, n = fixtures.hub_graph(n_edge=12_000)
    hu = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    tail = dict(block_rows=256, block_cols=256, sparse_block_rows=512,
                sparse_block_cols=1024, tile_edges=512, unit_weight=True,
                values_dtype=np.int8, block_layout="cr", device=CPU)
    out = {}
    for graph, twin in ((hu, ""), (TG.transpose_host_graph(hu)[0],
                                   " twin")):
        for thr in (768, 256):
            out[f"GAT hybrid tail{twin} thr {thr} (512x1024, ET 512)"] = (
                TG.hybrid_graph(graph, min_nnz=thr, **tail).tiles)
        out[f"GAT one-hot tiling{twin} (512x1024, ET 512)"] = TG.tile_graph(
            graph, block_rows=512, block_cols=1024, tile_edges=512,
            unit_weight=True, device=CPU)
    out["GAT gat_layer kind, lowered (512x1024, ET 512)"] = _gat_layer_tiling(
        hu)
    return out


def _gat_layer_tiling(hg):
    """The tiling that the ``gat_layer`` kind walks (K14), as the lowering
    builds it: a GAT layer's ``layer_partition`` through
    ``compiler/fusion.lower_schedule`` at the smoke's 512 x 1024, ET 512."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import build_op_graph
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF
    g = build_op_graph("GAT", 16, 8, heads=2)
    part = TSc.layer_partition(g)
    fn = TF.lower_schedule(g, TSc.Schedule(blocks=part, tiles=(
        TSc.TileConfig(512, 1024, 512),)), hg, device=CPU)
    tg, = [d for k, _, d, _ in fn.plans if k == "gat_layer"]
    return tg


def _sddmm_tilings():
    """name -> TiledGraph: the tilings K11 walks by their edge prefixes, on
    the hub graph with 12,000 random edges: the ``sddmm`` kind's, as
    ``compiler/fusion.sddmm_schedules`` lowers GAT's logit block at the
    smoke's 1024², ET 512, and the per-tile tail of the hybrid SDDMM at the
    bench SpMM recipe's geometry (256-wide 'rc' int8 blocks in supergroups
    of 16, 512² tail tiles of 128 slots; ``bench.spmm_recipe`` with
    ``tail_format="tiles"``), its threshold raised so that the tail holds
    full tiles."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import build_op_graph
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.compiler import fusion as TF
    s, r, n = fixtures.hub_graph(n_edge=12_000)
    hg = TG.build_host_graph(s, r, n, symmetric_norm=True,
                             edge_pad_multiple=128)
    g = build_op_graph("GAT", 16, 8, heads=2)
    sched, = TF.sddmm_schedules([g])
    fn = TF.lower_schedule(g, sched, hg, device=CPU)
    tg, = [d for k, _, d, _ in fn.plans if k == "sddmm"]
    tail = TG.hybrid_graph(
        hg, block_rows=256, block_cols=256, tile_edges=128, min_nnz=512,
        supergroup=16, values_dtype=np.int8, sparse_block_rows=512,
        sparse_block_cols=512, device=CPU).tiles
    return {"sddmm kind, lowered (1024², ET 512)": tg,
            "hybrid SDDMM per-tile tail (512², ET 128)": tail}


def _block_graphs():
    """name -> DenseBlockGraph: dense splits K2 walks."""
    hg = _fixture_host()
    return {
        "fixture int8 sg16 (unvisited row block)": TG.hybrid_graph(
            hg, supergroup=16, device=CPU, **SPLIT).dense,
        "fixture float values": TG.hybrid_graph(
            hg, device=CPU, **dict(SPLIT, values_dtype=np.float32)).dense,
        "8, 9, 16, 17 blocks a row block": fixtures.seg_block_graph(CPU),
        "hub": TG.hybrid_graph(TG.build_host_graph(
            *fixtures.hub_graph()[:2], fixtures.hub_graph()[2]),
            block_rows=128, block_cols=128, tile_edges=32, min_nnz=16,
            values_dtype=np.int8, device=CPU).dense,
    }


TILINGS = list(_tilings())
BLOCK_GRAPHS = list(_block_graphs())


@pytest.mark.parametrize("name", TILINGS)
def test_live_slots_form_each_tiles_prefix(name):
    """K1's walk (and K9's, K3's, K6's and K11's) stops at the first 32
    slots of a tile without an edge, so the builders must put a tile's
    edges in a prefix of its slots, sorted by receiver (the walk sums each
    receiver's run of slots): no pad slot lies before an edge, and the
    receivers of the prefix never fall; the SpMM tilings, the attention
    ones K3 reads and their transposed twins K6 reads, the tiling the
    ``gat_layer`` kind's lowering builds for K14's walk, and the ``sddmm``
    kind's and the hybrid SDDMM's per-tile tail that K11 reads, full tiles
    among them."""
    tg = _tilings()[name]
    real = ((tg.src_local < tg.block_cols) & (tg.dst_local < tg.block_rows)
            & (tg.src_local >= 0) & (tg.dst_local >= 0))
    n = real.sum(1, keepdim=True)
    pos = torch.arange(tg.tile_edges)[None, :]
    assert torch.equal(real, pos < n), "a pad slot before an edge"
    d = tg.dst_local.long()
    assert not bool(((d[:, 1:] < d[:, :-1]) & real[:, 1:]).any()), \
        "receivers out of order within a tile"
    if name == "hub" or "512x1024" in name or "SDDMM" in name:
        assert int((n == tg.tile_edges).sum()) > 1      # full tiles
@pytest.mark.parametrize("which", ["segments", "wide_segments"])
@pytest.mark.parametrize("name", BLOCK_GRAPHS)
def test_segments_cover_every_block_once(name, which):
    """K2's work lists (``wide_segments`` for bf16, ``segments`` for
    float32) visit every dense block exactly once, each run within the row
    block it names and no longer than its cut."""
    bg = _block_graphs()[name]
    cap = {"segments": TG.DENSE_SEGMENT,
           "wide_segments": TG.DENSE_WIDE_SEGMENT}[which]
    seg = getattr(bg, which).long()
    assert getattr(bg, which).dtype == torch.int32 and seg.shape[1] == 3
    lengths = seg[:, 2] - seg[:, 1]
    assert int(lengths.min()) >= 1 and int(lengths.max()) <= cap
    ks = torch.cat([torch.arange(int(a), int(b)) for a, b in seg[:, 1:]])
    blocks = bg.row_blocks.long()[ks]
    assert torch.equal(torch.sort(blocks).values, torch.arange(bg.n_blocks))
    assert torch.equal(bg.blk_rb.long()[blocks],
                       torch.repeat_interleave(seg[:, 0], lengths))
    if name.startswith("8, 9"):
        runs = torch.bincount(seg[:, 0], minlength=bg.n_row_blocks)
        want = [-(-c // cap) for c in fixtures.SEG_COUNTS]
        assert runs.tolist() == want + [0] * (bg.n_row_blocks - len(want))


@pytest.mark.parametrize("name", ["hub", "fixture, dead tile"])
def test_spmm_tiles_plain_matches_jax(name):
    """K1's plain version on the hub tiling (full tiles, runs longer than a
    tile) and the fixture's dead tile, at the ragged
    widths 41 and 300, against the TPU kernel over the same tiling."""
    if name == "hub":
        s, r, n = fixtures.hub_graph()
        geo = dict(block_rows=128, block_cols=128, tile_edges=32)
    else:
        s, r, n, _ = fixtures.edge_case_graph(seed=0)
        geo = dict(block_rows=128, block_cols=128, tile_edges=128)
    kw = dict(symmetric_norm=True, edge_pad_multiple=128)
    tj = J.tile_graph(J.build_host_graph(s, r, n, **kw), **geo)
    tt = _tilings()[name]
    if name != "hub":
        tj = dataclasses.replace(tj, tile_cb=tj.tile_cb.at[1].set(-1))
    for F in (41, 300):
        x = np.random.default_rng(F).standard_normal((n, F)).astype(
            np.float32)
        yj = JS.spmm(tj, jnp.asarray(x), interpret=True)
        _close(TS.spmm_tiles(tt, torch.from_numpy(x), tt.weight), yj)


@pytest.mark.parametrize("name", BLOCK_GRAPHS)
def test_spmm_dense_plain_matches_float64(name):
    """K2's plain version on each dense split against a float64 sum of the
    blocks' products, at a ragged width; row stripes that no dense block
    visits read 0."""
    bg = _block_graphs()[name]
    R, C, F = bg.block_rows, bg.block_cols, 41
    n = bg.n_col_blocks * C
    x = np.random.default_rng(3).standard_normal((n, F)).astype(np.float32)
    want = np.zeros((bg.n_row_blocks * R, F))
    vals = bg.values.double().numpy()
    for b, (rb, cb) in enumerate(zip(bg.blk_rb.tolist(),
                                     bg.blk_cb.tolist())):
        want[rb * R:(rb + 1) * R] += vals[b] @ x[cb * C:(cb + 1) * C]
    got = TD.spmm_dense_blocks(bg, torch.from_numpy(x),
                               bg.values.float() if bg.values.is_floating_point()
                               else bg.values)
    _close(got, want)
    visited = torch.zeros(bg.n_row_blocks, dtype=torch.bool)
    visited[bg.blk_rb.long()] = True
    assert float(got.view(bg.n_row_blocks, R, F)[~visited].abs().max()
                 if (~visited).any() else 0.0) == 0.0


def test_kind_smem_follows_the_launchers():
    """schedule._kind_smem reports what the K2 wrapper passes to its launch
    (the same function; the launch checks the size against its ring's
    layout on the card): three ring stages of a count tile and an x tile
    plus 1 KB of alignment (int8 counts or bf16 values; the kind the
    larger), the float32 path none; K1 requests none (its walk keeps the
    slots in registers); the smoke's GCN tiles (1024-row tail, 256-row
    blocks) stay feasible."""
    assert TSc._spmm_dense_smem(41, 2, 1) == 3 * (256 * 144 + 128 * 64 * 2) + 1024
    assert TSc._spmm_dense_smem(128, 2, 1) == (
        3 * (256 * 144 + 128 * 128 * 2) + 1024)
    assert TSc._spmm_dense_smem(128, 2, 2) == (
        3 * (256 * 160 + 64 * 128 * 2) + 1024)
    assert TSc._spmm_dense_smem(128, 2) == TSc._spmm_dense_smem(128, 2, 1)
    assert TSc._spmm_dense_smem(128, 4, 4) == 0
    gcn = TSc.TileConfig(1024, 1024, 512, TSc.PATH_HYBRID, dense_block=256)
    for F in (128, 41):
        assert TSc.smem_bytes(gcn, F, dtype_bytes=2, kind="spmm") == 0
        assert TSc.smem_bytes(gcn, F, dtype_bytes=2, kind="spmm_hybrid") == (
            TSc._spmm_dense_smem(F, 2))
        assert TSc.tile_is_feasible(gcn, F, dtype_bytes=2,
                                    kind="spmm_hybrid")


def _grouped_tilings():
    """name -> GroupedTiledGraph: every tiling of the K9 fixture cases (a
    stripe group without edges, unit and weighted streams, the hub's deep
    spill levels), and a tiling of a graph without edges."""
    tilings = fixtures.grouped_tilings(CPU)
    empty = TG.build_host_graph(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                300)
    tilings["no edges"] = TG.tile_graph_grouped(
        empty, block_rows=32, block_cols=64, tile_edges=32, group=2,
        device=CPU)
    return tilings


GROUPED_TILINGS = list(_grouped_tilings())


@pytest.mark.parametrize("name", GROUPED_TILINGS)
def test_k9_work_list_is_every_sub_tile_with_an_edge(name):
    """K9 launches one warp per entry of ``live_sub``: it must list, in
    ascending order, exactly the sub-tiles (flat index chunk * G + j) that
    hold a live slot anywhere, though it reads only each slot 0."""
    tg = _grouped_tilings()[name]
    real = ((tg.src_local >= 0) & (tg.src_local < tg.block_cols)
            & (tg.dst_local >= 0) & (tg.dst_local < tg.block_rows))
    want = torch.nonzero(real.any(2).reshape(-1)).reshape(-1)
    assert tg.live_sub.dtype == torch.int32
    assert torch.equal(tg.live_sub.long(), want)
    if name == "no edges":
        assert tg.n_chunks > 0 and tg.live_sub.numel() == 0
    if name == "weighted R32 G2":      # a stripe group of padding only
        listed = set(tg.chunk_grp[tg.live_sub.long() // tg.group].tolist())
        assert listed != set(range(tg.n_groups))
    if name.startswith("hub"):         # deep spill levels, mostly empty
        levels = torch.bincount(tg.chunk_grp.long() * tg.n_col_blocks
                                + tg.chunk_cb.long()).max()
        assert int(levels) > 16 and tg.live_sub.numel() < tg.n_tiles / 2


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("F", [8, 128, 300])
def test_spmm_grouped_plain_matches_jax_on_deep_spills(F, unit):
    """K9's plain version on the hub graph's grouped tiling (a block that
    spills into dozens of levels, a run of 300 copies of one pair), with
    and without edge weights, at the new fixture widths, against the TPU
    kernel over the same tiling."""
    s, r, n = fixtures.hub_graph()
    kw = dict(symmetric_norm=not unit, edge_pad_multiple=128)
    geo = dict(block_rows=128, block_cols=128, tile_edges=32, group=4,
               unit_weight=unit)
    tj = JG.tile_graph_grouped(J.build_host_graph(s, r, n, **kw), **geo)
    tt = TG.tile_graph_grouped(TG.build_host_graph(s, r, n, **kw),
                               device=CPU, **geo)
    assert tt.weight_all_unit == unit
    x = np.random.default_rng(F).standard_normal((n, F)).astype(np.float32)
    yj = JS._spmm_grouped_raw(tj, jnp.asarray(x), None, interpret=True)
    _close(TS.spmm_grouped(tt, torch.from_numpy(x),
                           None if unit else tt.weight), yj)
