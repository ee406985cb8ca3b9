"""PyTorch port: K13's receiver work list (``ops/pairagg.pair_work``), the
input of ``csrc/pair_agg.cu``.

The kernel walks the slots that ``_kernel_slots`` counts, sorted by
receiver and cut into chunks of at most ``PAIR_CHUNK`` slots, a lane group
per chunk; a row of one chunk is written with plain stores, a row cut into
several adds its chunks with atomics.  Here, on the CPU: the list covers
each counted slot exactly once with its sender (-1 for a pad sender),
keeps tile order within a row, keeps every chunk within the cap and every
row in order, marks exactly the rows it cuts, and is built once per tiling
(never for a tiling no K13 call reads).  A plain torch reduction over the
list in the kernel's shape (per chunk, then per row) equals
``_pair_agg_reference`` and, through it, the JAX package's
``pair_aggregate_raw`` with its TPU kernel in interpret mode.  K13's final
layout (``pair_agg(..., layout=)``: PNA's mean, min, max and std as
column slices of one tensor) equals the PyTorch formulas over the moments
that the path before it applied, bit for bit.

Graphs: the edge-case graph of ``utils/fixtures`` (empty rows 512-598,
receiver 7 takes 200 copies of one pair, which the cap of 128 cuts into
two chunks, row ``NEG_ROW`` gets only negative z, tile 1 dead), the same
tiling with pad senders and senders past the last node written into live
slots by hand, and a skewed random graph whose hubs span several chunks.

Tolerances: float32 max |port - ref| <= 1e-5 * max(1, max |ref|); bfloat16
within 1e-2 of each row's largest |ref|, as ``test_torch_pairagg.py``;
counts exact; the kernel itself is held to the plain version on the card
by ``chip_smoke.py`` (phase 7a's split-row fixture, 7b at the models'
shapes)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import pairagg as JP  # noqa: E402

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import ir  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import pairagg as TP  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TILE = dict(block_rows=128, block_cols=128, tile_edges=64)
HUB = fixtures.HOT_PAIR[1]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(port, ref, tol=TOL["float32"]):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _close_rows(port, ref, tol=TOL["bfloat16"]):
    """Each row within ``tol`` of its largest |ref|."""
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    scale = np.maximum(np.abs(ref).max(axis=1), 1e-6)
    worst = float((np.abs(port - ref).max(axis=1) / scale).max())
    assert worst <= tol, worst


def _edge_case():
    """(jax tiling, port tiling, n) of the edge-case graph, tile 1 dead."""
    s, r, n, _ = fixtures.edge_case_graph()
    hj = J.build_host_graph(s, r, n, edge_pad_multiple=128)
    ht = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    tt = fixtures._dead_tile(TG.tile_graph(ht, unit_weight=True, **TILE,
                                           device=CPU))
    tj = dataclasses.replace(JG.tile_graph(hj, unit_weight=True, **TILE),
                             tile_cb=jnp.asarray(tt.tile_cb.numpy()))
    return tj, tt, n


def _pad_senders(tt, n):
    """The edge-case tiling with some live slots' senders made pad slots
    (src_local = C: the slot still counts, u reads 0) and others pointed
    past the last node (a sender >= n reads 0 too)."""
    sl = tt.src_local.clone()
    live = (tt.dst_local < tt.block_rows) & (sl < tt.block_cols)
    t_idx, e_idx = torch.nonzero(live, as_tuple=True)
    sl[t_idx[::7], e_idx[::7]] = tt.block_cols
    last = int(tt.tile_cb.max())
    past = torch.nonzero(live & (tt.tile_cb == last)[:, None],
                         as_tuple=True)
    sl[past[0][:3], past[1][:3]] = n - last * tt.block_cols + 1
    return dataclasses.replace(tt, src_local=sl)


def _skewed():
    """A random graph whose hubs hold several chunks' worth of edges."""
    rng = np.random.default_rng(3)
    n = 700
    s = rng.integers(0, n, 4000)
    r = np.concatenate([rng.integers(0, n, 3000),
                        rng.choice([3, 200, 650], 1000)])
    ht = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    return TG.tile_graph(ht, unit_weight=True, block_rows=64, block_cols=128,
                         tile_edges=32, device=CPU), n


def _graphs():
    _, tt, n = _edge_case()
    return {"edge cases": (tt, n), "pad senders": (_pad_senders(tt, n), n),
            "skewed": _skewed()}


def _slots_by_row(tg, n):
    """{row: [sender or -1 in tile order]} of the slots K13 counts, by a
    loop over the tiles in order (independent of `_build_pair_work`)."""
    R, C = tg.block_rows, tg.block_cols
    rows = {}
    for t in range(tg.n_tiles):
        rb, cb = int(tg.tile_rb[t]), max(int(tg.tile_cb[t]), 0)
        for sl, dl in zip(tg.src_local[t].tolist(), tg.dst_local[t].tolist()):
            row = rb * R + dl
            if dl >= R or row >= n:
                continue
            col = cb * C + sl
            rows.setdefault(row, []).append(col if sl < C and col < n else -1)
    return rows


def _work_rows(work):
    """(row of each chunk, its slots' senders) of a work list."""
    ptr = work.chunk_ptr.tolist()
    src = work.slot_src.tolist()
    rows = [r if r >= 0 else -r - 1 for r in work.chunk_row.tolist()]
    return rows, [src[ptr[c]:ptr[c + 1]] for c in range(len(rows))]


def _work_reduce(work, u, v, *, sf=None, slope=0.2):
    """The kernel's reduction over the work list in plain torch: z per
    slot, each chunk's sum (float64), max and count, then each row its one
    chunk's values or the sum / max of its chunks."""
    n, D = u.shape
    dt = u.dtype
    v = v.to(dt)
    ptr = work.chunk_ptr.long()
    lens = ptr[1:] - ptr[:-1]
    chunk = torch.repeat_interleave(torch.arange(work.n_chunks), lens)
    crow = work.chunk_row.long()
    crow = torch.where(crow < 0, -crow - 1, crow)
    src = work.slot_src.long()
    us = torch.where((src >= 0)[:, None],
                     u.index_select(0, src.clamp(min=0)).float(),
                     torch.zeros(()))
    z = us + v.index_select(0, crow[chunk]).float()
    if sf == "leaky_relu":
        z = torch.where(z >= 0, z, slope * z)
    zr = z.to(dt).float()
    c_sum = torch.zeros((work.n_chunks, D), dtype=torch.float64).index_add_(
        0, chunk, zr.double())
    c_max = torch.full((work.n_chunks, D), float("-inf")).scatter_reduce_(
        0, chunk[:, None].expand_as(zr), zr, "amax")
    y_sum = torch.zeros((n, D), dtype=torch.float64).index_add_(0, crow,
                                                                 c_sum)
    y_max = torch.full((n, D), float("-inf")).scatter_reduce_(
        0, crow[:, None].expand_as(c_max), c_max, "amax")
    cnt = torch.zeros(n).index_add_(0, crow, lens.float())[:, None]
    return y_sum.float(), torch.where(cnt > 0, y_max, 0.0), cnt


@pytest.mark.parametrize("name", ["edge cases", "pad senders", "skewed"])
def test_work_list_covers_each_counted_slot_once_in_tile_order(name):
    """Every slot ``_kernel_slots`` counts is in the list exactly once,
    under its receiver, with its sender (-1 where u reads 0), in tile and
    slot order within the row."""
    tg, n = _graphs()[name]
    want = _slots_by_row(tg, n)
    rows, slots = _work_rows(TP.pair_work(tg, n))
    got = {}
    for r, s in zip(rows, slots):
        got.setdefault(r, []).extend(s)
    assert {r: s for r, s in got.items() if s} == want
    assert TP.pair_work(tg, n).slot_src.numel() == sum(map(len, want.values()))
    src, has, dst = TP._kernel_slots(tg, 0, tg.n_tiles, n)
    assert int(dst.numel()) == TP.pair_work(tg, n).slot_src.numel()
    if name == "pad senders":
        assert int((~has).sum()) > 0


@pytest.mark.parametrize("name", ["edge cases", "pad senders", "skewed"])
def test_chunks_stay_within_the_cap_and_cover_every_row(name):
    """Chunks hold at most ``PAIR_CHUNK`` slots; every row 0..n-1 has its
    chunks in row order (an empty row one empty chunk); a row is marked cut
    (chunk_row ~r, listed in split_rows) exactly where it has more slots
    than the cap, and its chunks are then all full but the last."""
    tg, n = _graphs()[name]
    work = TP.pair_work(tg, n)
    lens = torch.diff(work.chunk_ptr.long())
    assert int(work.chunk_ptr[0]) == 0
    assert int(work.chunk_ptr[-1]) == work.slot_src.numel()
    assert bool((lens >= 0).all()) and int(lens.max()) <= TP.PAIR_CHUNK
    rows, _ = _work_rows(work)
    assert sorted(set(rows)) == list(range(n)) and rows == sorted(rows)
    cnt = torch.zeros(n, dtype=torch.long).index_add_(
        0, torch.tensor(rows), lens)
    cut = cnt > TP.PAIR_CHUNK
    assert torch.equal(work.split_rows, torch.nonzero(cut).reshape(-1))
    split = (work.chunk_row < 0).tolist()
    for c, r in enumerate(rows):
        assert split[c] == bool(cut[r])
        last = c + 1 == len(rows) or rows[c + 1] != r
        if split[c] and not last:
            assert int(lens[c]) == TP.PAIR_CHUNK
    assert int(torch.bincount(torch.tensor(rows), minlength=n).max()) == (
        -(-int(cnt.max()) // TP.PAIR_CHUNK))
    if name == "edge cases":
        assert HUB in work.split_rows.tolist()   # 200 slots: two chunks
    if name == "skewed":
        assert int(cnt.max()) > 2 * TP.PAIR_CHUNK


def test_work_list_is_built_once_per_tiling_and_only_on_demand():
    """A tiling holds no work list until a K13 call asks for one; then
    the one list per row count is kept with it, and a tiling derived with
    other tiles starts without one."""
    _, tt, n = _edge_case()
    assert tt.work_lists == {}
    work = TP.pair_work(tt, n)
    assert TP.pair_work(tt, n) is work
    assert list(tt.work_lists) == [("pair_agg", n)]
    tt2 = dataclasses.replace(tt, tile_cb=tt.tile_cb.clone())
    assert tt2.work_lists == {}


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("want_max", [True, False])
@pytest.mark.parametrize("sf", [None, "leaky_relu"])
def test_work_list_reduction_matches_reference_and_jax(sf, want_max, dtn):
    """The reduction over the work list equals K13's plain version and the
    JAX package's ``pair_aggregate_raw`` (TPU kernel in interpret mode):
    sum, max (0 on empty rows, the all-negative row's true maximum, the
    cut hub's ties) and count."""
    tj, tt, n = _edge_case()
    tdt, jdt = DTYPES[dtn]
    rng = np.random.default_rng(7 if sf else 8)
    u, v = (rng.standard_normal((n, 41)).astype(np.float32) for _ in range(2))
    v[fixtures.NEG_ROW] = -50.0 - np.abs(v[fixtures.NEG_ROW])
    ut, vt = (torch.tensor(a, dtype=tdt) for a in (u, v))
    got = _work_reduce(TP.pair_work(tt, n), ut, vt, sf=sf)
    ref = TP._pair_agg_reference(tt, ut, vt, sf=sf)
    jax_out = JP.pair_aggregate_raw(tj, jnp.asarray(u, jdt),
                                    jnp.asarray(v, jdt), sf=sf,
                                    want_max=want_max, interpret=True)
    close = _close if dtn == "float32" else _close_rows
    for i, (a, b, c) in enumerate(zip(got, ref, jax_out)):
        _close(a, b)
        if want_max or i != 1:      # JAX's max is not asked for
            close(a, c)
    assert torch.equal(got[2], ref[2])
    assert float(got[1][fixtures.NEG_ROW].max()) < 0.0
    assert float(got[1][512:599].abs().max()) == 0.0


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["pad senders", "skewed"])
def test_work_list_reduction_matches_reference(name, dtn):
    """The same on a tiling with pad senders and senders past the last
    node (those slots count, u reads 0) and on the skewed graph, whose
    hubs sum over three or more chunks."""
    tg, n = _graphs()[name]
    tdt, _ = DTYPES[dtn]
    rng = np.random.default_rng(9)
    ut, vt = (torch.tensor(rng.standard_normal((n, 48)), dtype=tdt)
              for _ in range(2))
    got = _work_reduce(TP.pair_work(tg, n), ut, vt, sf="leaky_relu")
    ref = TP._pair_agg_reference(tg, ut, vt, sf="leaky_relu")
    for a, b in zip(got, ref):
        _close(a, b)
    assert torch.equal(got[2], ref[2])


def _work_min_sq(work, u, v):
    """K13's min and sum of squares over the work list in plain torch, in
    the kernel's shape: per chunk, then per row (a cut row's chunks meet
    as the kernel's atomics do: sums add, the min is the chunks' min)."""
    n, D = u.shape
    ptr = work.chunk_ptr.long()
    lens = ptr[1:] - ptr[:-1]
    chunk = torch.repeat_interleave(torch.arange(work.n_chunks), lens)
    crow = work.chunk_row.long()
    crow = torch.where(crow < 0, -crow - 1, crow)
    src = work.slot_src.long()
    us = torch.where((src >= 0)[:, None],
                     u.index_select(0, src.clamp(min=0)).float(),
                     torch.zeros(()))
    zr = (us + v.to(u.dtype).index_select(0, crow[chunk]).float()
          ).to(u.dtype).float()
    c_min = torch.full((work.n_chunks, D), float("inf")).scatter_reduce_(
        0, chunk[:, None].expand_as(zr), zr, "amin")
    c_sq = torch.zeros((work.n_chunks, D), dtype=torch.float64).index_add_(
        0, chunk, zr.double() ** 2)
    y_min = torch.full((n, D), float("inf")).scatter_reduce_(
        0, crow[:, None].expand_as(c_min), c_min, "amin")
    y_sq = torch.zeros((n, D), dtype=torch.float64).index_add_(0, crow, c_sq)
    cnt = torch.zeros(n).index_add_(0, crow, lens.float())[:, None]
    return torch.where(cnt > 0, y_min, 0.0), y_sq.float()


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["edge cases", "pad senders", "skewed"])
def test_work_list_min_and_sum_of_squares_match_reference(name, dtn):
    """K13's instantiation of PNA's four aggregators, in its reduction
    over the work list, equals the plain version's min and sum of squares
    (of z rounded to u's dtype): the cut hub, the all-negative row, the
    empty rows (0), pad senders (u reads 0) and -0.0 inputs; and its sum,
    max and count are those of the sum-and-max plain version."""
    tg, n = _graphs()[name]
    tdt, _ = DTYPES[dtn]
    rng = np.random.default_rng(11)
    u, v = (rng.standard_normal((n, 48)).astype(np.float32) for _ in range(2))
    u[:, :8] = v[:, :8] = -0.0
    if name != "skewed":
        v[fixtures.NEG_ROW] = -50.0 - np.abs(v[fixtures.NEG_ROW])
    ut, vt = (torch.tensor(a, dtype=tdt) for a in (u, v))
    ref = TP._pair_agg_reference(tg, ut, vt, want_min_sq=True)
    two = TP._pair_agg_reference(tg, ut, vt)
    for a, b in zip(two, ref[:3]):
        assert torch.equal(a, b)
    got = _work_min_sq(TP.pair_work(tg, n), ut, vt)
    assert torch.equal(got[0], ref[3])
    _close(got[1], ref[4])
    zero = torch.ones(n, dtype=torch.bool)      # rows whose z there is -0.0
    if name != "skewed":
        zero[fixtures.NEG_ROW] = False
    assert float(ref[4].min()) >= 0.0
    assert float(ref[4][zero, :8].abs().max()) == 0.0
    assert float(ref[3][zero, :8].abs().max()) == 0.0
    if name == "edge cases":
        assert HUB in TP.pair_work(tg, n).split_rows.tolist()
        assert float(ref[3][fixtures.NEG_ROW].max()) < 0.0
        assert float(ref[3][512:599].abs().max()) == 0.0


LAYOUTS = {"PNA-4x3": fixtures.PNA_LAYOUT,
           "permuted": (ir.STD, ir.MAX, ir.MEAN, ir.MIN),
           "min and std": (ir.MIN, ir.STD),
           "with the sum": (ir.ADD, ir.MIN, ir.STD, ir.MEAN)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["edge cases", "pad senders", "skewed"])
def test_final_layout_equals_moments_and_glue(name, dtn, layout):
    """K13's final layout equals, bit for bit, what the path before it
    computed from the moments: mean = sum / c and std = sqrt(relu(sq / c -
    mean^2) + 1e-5), c = max(count, 1), concatenated in the layout's order
    (a layout with the sum keeps it); empty rows read mean 0 and std
    sqrt(1e-5), rows of one slot std sqrt(1e-5), and the hub's row, cut
    into chunks, is among them.  The differentiable form returns the
    same."""
    tg, n = _graphs()[name]
    tdt, _ = DTYPES[dtn]
    order = LAYOUTS[layout]
    rng = np.random.default_rng(12)
    u, v = (torch.tensor(rng.standard_normal((n, 48)).astype(np.float32),
                         dtype=tdt) for _ in range(2))
    got, cnt, glue, c0, _ = fixtures.pair_layout_glue(tg, u, v, order,
                                                      sf="leaky_relu")
    assert got.shape == (n, 48 * len(order))
    assert torch.equal(got, glue) and torch.equal(cnt, c0)
    same, same_cnt = TP.pair_aggregate(tg, u, v, sf="leaky_relu",
                                       want_min_sq=True, layout=order)
    assert torch.equal(same, got) and torch.equal(same_cnt, cnt)
    eps = torch.sqrt(torch.tensor(ir.STD_EPS))
    cols = dict(zip(order, got.split(48, 1)))
    empty, single = cnt[:, 0] == 0, cnt[:, 0] == 1
    assert bool(single.any())
    if ir.STD in cols:
        assert bool((cols[ir.STD][empty | single] == eps).all())
    if ir.MEAN in cols:
        assert not bool(cols[ir.MEAN][empty].any())
    if name == "edge cases":
        assert bool(empty.any())
        assert HUB in TP.pair_work(tg, n).split_rows.tolist()


def test_final_layout_takes_the_four_aggregator_instantiation():
    """A layout needs ``want_min_sq`` and distinct reduces of
    ``PAIR_REDUCES``."""
    tg, n = _graphs()["skewed"]
    u = torch.zeros((n, 8))
    for kw, what in ((dict(layout=fixtures.PNA_LAYOUT), "want_min_sq"),
                     (dict(want_min_sq=True, layout=(ir.MIN, ir.MIN)),
                      "distinct"),
                     (dict(want_min_sq=True, layout=(ir.MIN, "MUL")),
                      "distinct")):
        with pytest.raises(ValueError, match=what):
            TP.pair_agg(tg, u, u, **kw)
