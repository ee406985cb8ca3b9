"""PyTorch port: SpMM (K1 edge tiles, K2 dense blocks, the hybrid) against
the JAX package's kernels, which run in Pallas interpret mode on the CPU.

On the CPU the port's wrappers take their plain versions, so these tests
hold the plain versions to the TPU kernels.  Tolerance in float32:
max |port - jax| <= 1e-5 * max(1, max |jax|) -- the two sum the same terms
in another order.  The CUDA kernels themselves are held to the plain
versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import dense as JDn  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import spmm as JS  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TDn  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import spmm as TS  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

F32_TOL = 1e-5
CPU = "cpu"     # the port's entry points default to the CUDA card


def _close(port, ref, tol=F32_TOL):
    port = port.float().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _hosts(symmetric_norm=True):
    s, r, n, meta = fixtures.edge_case_graph(seed=0)
    kw = dict(symmetric_norm=symmetric_norm, edge_pad_multiple=128)
    return (J.build_host_graph(s, r, n, **kw),
            T.build_host_graph(s, r, n, **kw), meta)


def _x(n, f, seed=1):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(
        np.float32)


@pytest.mark.parametrize("unit_weight", [False, True])
def test_spmm_matches_jax(unit_weight):
    hj, ht, _ = _hosts()
    geo = dict(block_rows=128, block_cols=128, tile_edges=128,
               unit_weight=unit_weight)
    x = _x(hj.n_node, 16)
    yj = JS.spmm(J.tile_graph(hj, **geo), jnp.asarray(x), interpret=True)
    yt = TS.spmm(T.tile_graph(ht, **geo, device=CPU), torch.from_numpy(x))
    _close(yt, yj)


def test_spmm_dead_tile_and_edge_vals_match_jax():
    """A dead tile (cb = -1) keeps its slots but adds nothing; runtime
    per-edge values multiply the tile weights."""
    hj, ht, _ = _hosts()
    geo = dict(block_rows=128, block_cols=128, tile_edges=128)
    tj, tt = J.tile_graph(hj, **geo), T.tile_graph(ht, **geo, device=CPU)
    tj = dataclasses.replace(tj, tile_cb=tj.tile_cb.at[1].set(-1))
    cb = tt.tile_cb.clone()
    cb[1] = -1
    tt = dataclasses.replace(tt, tile_cb=cb)
    x = _x(hj.n_node, 24)
    ev = np.random.default_rng(2).random(hj.e_pad).astype(np.float32)
    _close(TS.spmm(tt, torch.from_numpy(x)),
           JS.spmm(tj, jnp.asarray(x), interpret=True))
    _close(TS.spmm(tt, torch.from_numpy(x), torch.from_numpy(ev)),
           JS.spmm(tj, jnp.asarray(x), jnp.asarray(ev), interpret=True))


def test_spmm_bf16_rounding_point_matches_jax():
    """bf16 x: each w*x[s] rounds to bf16 before the f32 sum, as in the
    TPU kernel.  With the rounding points equal, only the f32 sum order
    differs, so the float32 bound holds."""
    hj, ht, _ = _hosts()
    geo = dict(block_rows=128, block_cols=128, tile_edges=128)
    x = _x(hj.n_node, 16)
    yj = JS.spmm(J.tile_graph(hj, **geo), jnp.asarray(x, jnp.bfloat16),
                 interpret=True)
    yt = TS.spmm(T.tile_graph(ht, **geo, device=CPU), torch.from_numpy(x).bfloat16())
    _close(yt, yj)


@pytest.mark.parametrize("supergroup", [0, 16])
def test_spmm_dense_matches_jax(supergroup):
    hj, ht, meta = _hosts()
    kw = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=64,
              values_dtype=np.int8, supergroup=supergroup)
    yj_, yt_ = JG.hybrid_graph(hj, **kw), TG.hybrid_graph(ht, **kw, device=CPU)
    rs, cs = TG.separable_weight_scales(ht)
    x = _x(hj.n_node, 40)
    dj = JDn.spmm_dense(yj_.dense, jnp.asarray(x), interpret=True,
                        row_scale=jnp.asarray(rs), col_scale=jnp.asarray(cs))
    dt = TDn.spmm_dense(yt_.dense, torch.from_numpy(x),
                        row_scale=torch.from_numpy(rs),
                        col_scale=torch.from_numpy(cs))
    _close(dt, dj)
    # the last row block holds no dense block: its stripe is zero
    assert not bool(yt_.dense.row_mask[-1])
    assert float(dt[meta["empty_row_block_start"]:].abs().max()) == 0.0


@pytest.mark.parametrize("weighted", [True, False])
def test_spmm_hybrid_matches_jax(weighted):
    hj, ht, _ = _hosts(symmetric_norm=weighted)
    kw = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=64,
              sparse_block_rows=256, sparse_block_cols=128,
              values_dtype=np.int8, supergroup=16, unit_weight=not weighted)
    yj_, yt_ = JG.hybrid_graph(hj, **kw), TG.hybrid_graph(ht, **kw, device=CPU)
    if weighted:
        rs, cs = TG.separable_weight_scales(ht)
        yj_ = dataclasses.replace(yj_, row_scale=jnp.asarray(rs),
                                  col_scale=jnp.asarray(cs))
        yt_ = dataclasses.replace(yt_, row_scale=torch.from_numpy(rs),
                                  col_scale=torch.from_numpy(cs))
    x = _x(hj.n_node, 32)
    yj = JDn.spmm_hybrid(yj_, hj.to_device(), jnp.asarray(x), interpret=True)
    yt = TDn.spmm_hybrid(yt_, ht.to_device(CPU), torch.from_numpy(x))
    _close(yt, yj)
    # and the full-graph segment formulation agrees with both
    _close(TDn._spmm_ref_g(ht.to_device(CPU), torch.from_numpy(x), weighted),
           JDn._spmm_ref_g(hj.to_device(), jnp.asarray(x), weighted))
    _close(yt, TDn._spmm_ref_g(ht.to_device(CPU), torch.from_numpy(x),
                               weighted).numpy())


@pytest.mark.parametrize("kind,heads,head_dim", [("spmm", 1, 128),
                                                 ("gat", 4, 32),
                                                 ("gat", 1, 41)])
def test_hybrid_threshold_matches_jax(kind, heads, head_dim):
    hj, ht, _ = _hosts()
    for budget in (1 << 30, 3 * 128 * 128):
        assert JDn.hybrid_threshold(
            hj, kind, heads=heads, head_dim=head_dim, dense_rows=128,
            dense_cols=128, budget=budget) == TDn.hybrid_threshold(
            ht, kind, heads=heads, head_dim=head_dim, dense_rows=128,
            dense_cols=128, budget=budget)


def test_wrappers_have_no_fallback_switch():
    """A tensor on the CPU takes the plain version; nothing else does: the
    wrappers have no environment switch and no try/except fallback."""
    import inspect
    for fn in (TS.spmm_tiles, TDn.spmm_dense_blocks):
        src = inspect.getsource(fn)
        assert "except" not in src and "environ" not in src
