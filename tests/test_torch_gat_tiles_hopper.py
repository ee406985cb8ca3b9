"""PyTorch port: what K3 (``csrc/gat_tiles.cu``, on ``gta::gat_prefix_walk``
of ``csrc/tile_walk.cuh``) reads, and its plain version in the a_s forms
its wrapper takes.

K3 reads a float32 a_s per node: the hybrid path hands it the array that
its msrc, K4 and the backward read (``ops/dense._a_s_kernel``); derive mode
(``w_asrc``) forms it first in the kernel's own per-node pass; the values
mode reads a_src in h's dtype.  The plain version, which the CPU wrapper
takes, is held here with float32 a_s to the JAX package's TPU kernel in
derive mode (``_gat_kernel_t``, Pallas interpret mode) at 1, 2 and 4 heads
and at HD 128 and 41, in float32 and bfloat16, and the wrapper's derive and
float32 forms to each other.  Tolerances: float32 max |port - jax| <= 1e-5
* max(1, max |jax|) (the same terms summed in another order, a_s from
another order of the same products); bfloat16 1e-2 of each row's largest
|jax| in the num and den columns apart (p and p h round to bf16 in both; a
value whose f32 bits differ in the last place may round the other way,
2^-8 of itself).  K3's walk stops at each tile's first 32 slots without an
edge: ``tests/test_torch_spmm_hopper.py`` holds every tiling it reads to
that order.  The kernel itself is held to the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import gat as JA  # noqa: E402

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as TA  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

CPU = "cpu"     # the port's entry points default to the CUDA card
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GEO = dict(block_rows=128, block_cols=128, tile_edges=128, unit_weight=True)
SHAPES = [(128, 1), (128, 2), (128, 4), (41, 1)]


def _close(port, ref, tol, split):
    """float32: within tol * max(1, max |ref|); bfloat16: each row's num and
    den columns (or its normalized output) within tol of that row's largest
    |ref| there."""
    port = port.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    assert port.shape == ref.shape
    if tol == TOL["float32"]:
        bound = tol * max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(port - ref).max()) <= bound
        return
    groups = ((0, split), (split, ref.shape[1])) if split < ref.shape[1] \
        else ((0, ref.shape[1]),)
    for lo, hi in groups:
        d = np.abs(port[:, lo:hi] - ref[:, lo:hi]).max(1)
        scale = np.maximum(np.abs(ref[:, lo:hi]).max(1), 1e-30)
        assert (d <= tol * scale).all(), float((d / scale).max())


def _inputs(n, HD, H, seed=3):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, HD)).astype(np.float32)
    a_d = rng.standard_normal((n, H)).astype(np.float32)
    w = (rng.standard_normal((HD, H)) / np.sqrt(HD)).astype(np.float32)
    return h, a_d, w


def _tilings():
    s, r, n, _ = fixtures.edge_case_graph(seed=0)
    kw = dict(edge_pad_multiple=128)
    return (J.tile_graph(J.build_host_graph(s, r, n, **kw), **GEO),
            TG.tile_graph(TG.build_host_graph(s, r, n, **kw), **GEO,
                          device=CPU))


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("HD,H", SHAPES)
def test_plain_with_f32_a_s_matches_jax_derive_mode(HD, H, normalize, dtn):
    """The plain version fed the hybrid path's float32 a_s (h @ w_asrc of
    h's dtype, float32 sums) against the TPU kernel deriving a_s itself,
    on the edge-case tiling (the hot pair's merged slot, empty rows)."""
    tj, tt = _tilings()
    tdt, jdt = DTYPES[dtn]
    h, a_d, w = _inputs(tt.n_node, HD, H)
    want = JA._gat_forward(tj, jnp.asarray(h, jdt), None, jnp.asarray(a_d),
                           w_asrc=jnp.asarray(w, jdt), normalize=normalize,
                           interpret=True)
    ht, wt = torch.from_numpy(h).to(tdt), torch.from_numpy(w).to(tdt)
    a_s = TD._a_s_kernel(ht, wt)
    assert a_s.dtype == torch.float32
    got = TA._gat_forward(tt, ht, None, torch.from_numpy(a_d), a_s=a_s,
                          normalize=normalize)
    assert got.shape == (tt.n_node, HD if normalize else HD + H)
    _close(got, want, TOL[dtn], HD)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("HD,H", SHAPES)
def test_wrapper_derive_and_f32_forms_agree(HD, H, dtn):
    """The K3 wrapper's two forms of a_s, derive mode (``w_asrc``) and the
    float32 per-node array (``a_src`` float32), give the same raw [num |
    den] under one shift bound, on the tiling with a dead tile and on the
    unit-weight hub tiling (full tiles)."""
    tdt = DTYPES[dtn][0]
    s, r, n, _ = fixtures.edge_case_graph(seed=0)
    dead = fixtures._dead_tile(TG.tile_graph(
        TG.build_host_graph(s, r, n, edge_pad_multiple=128), **GEO,
        device=CPU))
    for tg in (dead, fixtures.hub_tiling(CPU, unit_weight=True)):
        h, a_d, w = _inputs(tg.n_node, HD, H, seed=7)
        ht, wt = torch.from_numpy(h).to(tdt), torch.from_numpy(w).to(tdt)
        a_s = ht.float() @ wt.float()
        ms = a_s.amax(0, keepdim=True)
        ad = torch.from_numpy(a_d)
        derive = TA.gat_tiles(tg, ht, tg.weight, ad, ms, w_asrc=wt,
                              normalize=False)
        f32 = TA.gat_tiles(tg, ht, tg.weight, ad, ms, a_src=a_s,
                           normalize=False)
        _close(f32, derive.numpy(), TOL[dtn], HD)


def test_wrapper_takes_one_a_s_form():
    """Exactly one of ``w_asrc`` and ``a_src``; on a CUDA-less CPU tensor
    the wrapper takes the plain version, which reads float32 a_src as it
    is (no rounding to h's dtype)."""
    tj, tt = _tilings()
    h, a_d, w = _inputs(tt.n_node, 128, 4)
    ht = torch.from_numpy(h).to(torch.bfloat16)
    ad = torch.from_numpy(a_d)
    a_s = torch.from_numpy(h @ w)
    ms = a_s.amax(0, keepdim=True)
    with pytest.raises(ValueError):
        TA.gat_tiles(tt, ht, tt.weight, ad, ms, normalize=False)
    with pytest.raises(ValueError):
        TA.gat_tiles(tt, ht, tt.weight, ad, ms, a_src=a_s,
                     w_asrc=torch.from_numpy(w).to(torch.bfloat16))
    f32 = TA.gat_tiles(tt, ht, tt.weight, ad, ms, a_src=a_s, normalize=False)
    rounded = TA.gat_tiles(tt, ht, tt.weight, ad, ms,
                           a_src=a_s.to(torch.bfloat16), normalize=False)
    assert not torch.equal(f32, rounded)
