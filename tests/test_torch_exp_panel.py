"""PyTorch port: the exp-panel dense partial (K15 through its plain
version, ``DENSE_EXP_PANEL``) against the JAX package's
``gat_dense_partial_t`` with its own ``DENSE_EXP_PANEL`` set by
``monkeypatch`` (the JAX Pallas kernel in interpret mode), and against the
port's K4 path with the flag off.  Inputs are made with numpy from a seed.

Tolerance: 1e-5 * max(1, max |jax|) in float32 (the factorisation is exact:
both packages form the same products and sum them in another order); in
bfloat16 1e-3 relative (``test_torch_gat.py``: one flipped rounding of p
moves one term by 2^-8 of itself)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as JG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import dense as JD  # noqa: E402

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch import graph as TG  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import dense as TD  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import fixtures  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 1e-3}
CPU = "cpu"     # the port's entry points default to the CUDA card
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SPLIT = dict(block_rows=128, block_cols=128, tile_edges=128, min_nnz=64,
             unit_weight=True, values_dtype=np.int8, block_layout="cr")


def _close(port, ref, tol):
    port = port.detach().float().cpu().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


@pytest.fixture(scope="module")
def splits():
    s, r, n, _ = fixtures.edge_case_graph()
    hj = J.build_host_graph(s, r, n, edge_pad_multiple=128)
    ht = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    return JG.hybrid_graph(hj, **SPLIT), TG.hybrid_graph(ht, **SPLIT,
                                                         device=CPU), n


def _inputs(n, HD, H, gap, seed=3):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, HD)).astype(np.float32)
    a_s = (fixtures.gap_a_src(rng, n, H) if gap
           else rng.standard_normal((n, H)).astype(np.float32))
    a_d = rng.standard_normal((n, H)).astype(np.float32)
    return h, a_s, a_d, a_s.max(0, keepdims=True)


@pytest.mark.parametrize("dtn", ["float32", "bfloat16"])
@pytest.mark.parametrize("HD,H", [(16, 16), (128, 4), (41, 1)])
@pytest.mark.parametrize("gap", [False, True])
def test_exp_panel_partial_matches_jax(monkeypatch, splits, dtn, HD, H, gap):
    """``gat_dense_partial_t`` with the flag set in both packages: K15's
    plain version against ``_gat_dense_kernel_t2`` in interpret mode, with
    an unvisited row stripe and (``gap``) a row whose sources sit past the
    shift-bound gap."""
    yj, yt, n = splits
    tdt, jdt = DTYPES[dtn]
    h, a_s, a_d, ms = _inputs(n, HD, H, gap)
    monkeypatch.setattr(JD, "DENSE_EXP_PANEL", True)
    monkeypatch.setattr(TD, "DENSE_EXP_PANEL", True)
    pj = JD.gat_dense_partial_t(yj.dense, jnp.asarray(h, jdt),
                                jnp.asarray(a_s), jnp.asarray(a_d),
                                jnp.asarray(ms), interpret=True)
    TD.gat_dense_panel_blocks.launches = 0
    pt = TD.gat_dense_partial_t(yt.dense, torch.from_numpy(h).to(tdt),
                                torch.from_numpy(a_s), torch.from_numpy(a_d),
                                torch.from_numpy(ms))
    _close(pt, pj, TOL[dtn])
    assert float(pt[:, 512:].abs().max()) == 0.0      # unvisited stripe
    # and the port's K4 path with the flag off computes the same partials
    monkeypatch.setattr(TD, "DENSE_EXP_PANEL", False)
    p4 = TD.gat_dense_partial_t(yt.dense, torch.from_numpy(h).to(tdt),
                                torch.from_numpy(a_s), torch.from_numpy(a_d),
                                torch.from_numpy(ms))
    _close(pt, p4, TOL[dtn])


def test_exp_panels_are_bounded_and_zero_padded():
    """Every panel entry of a real node is exp of a non-positive exponent
    (at most 1); pad entries are 0, so a masked pad cell reads 0, not
    inf * 0; the raw a_d rides in the row panel's last H columns."""
    rng = np.random.default_rng(0)
    a_s = torch.tensor(rng.standard_normal((10, 3)) - 50.0)
    a_d = torch.tensor(rng.standard_normal((10, 3)) * 30.0)
    ms = a_s.amax(0, keepdim=True)
    ps, pd = TD.exp_panels(a_s, a_d, ms, 16, 12)
    assert ps.shape == (16, 6) and pd.shape == (12, 9)
    assert float(ps[:10].max()) <= 1.0 and float(pd[:10, :6].max()) <= 1.0
    assert float(ps[10:].abs().max()) == 0.0
    assert float(pd[10:].abs().max()) == 0.0
    assert torch.equal(pd[:10, 6:], a_d.float())


@pytest.mark.parametrize("mode", ["derive", "values"])
def test_exp_panel_hybrid_matches_jax(monkeypatch, splits, mode):
    """The whole hybrid attention (tail on K3's plain version, dense blocks
    on K15's) with the flag set in both packages."""
    yj, yt, n = splits
    s, r, _, _ = fixtures.edge_case_graph()
    h, a_s, a_d, _ = _inputs(n, 128, 4, False)
    w = (np.random.default_rng(4).standard_normal((128, 4))
         / np.sqrt(128)).astype(np.float32)
    monkeypatch.setattr(JD, "DENSE_EXP_PANEL", True)
    monkeypatch.setattr(TD, "DENSE_EXP_PANEL", True)
    hj = J.build_host_graph(s, r, n, edge_pad_multiple=128)
    ht = TG.build_host_graph(s, r, n, edge_pad_multiple=128)
    if mode == "derive":
        oj = JD.gat_hybrid(yj, hj.to_device(), jnp.asarray(h), None,
                           jnp.asarray(a_d), w_asrc=jnp.asarray(w),
                           interpret=True)
        ot = TD.gat_hybrid(yt, ht.to_device(CPU), torch.from_numpy(h), None,
                           torch.from_numpy(a_d), w_asrc=torch.from_numpy(w))
    else:
        oj = JD.gat_hybrid(yj, hj.to_device(), jnp.asarray(h),
                           jnp.asarray(a_s), jnp.asarray(a_d),
                           interpret=True)
        ot = TD.gat_hybrid(yt, ht.to_device(CPU), torch.from_numpy(h),
                           torch.from_numpy(a_s), torch.from_numpy(a_d))
    _close(ot, oj, TOL["float32"])


def test_exp_panel_flag_is_off_by_default():
    assert TD.DENSE_EXP_PANEL is False and JD.DENSE_EXP_PANEL is False
