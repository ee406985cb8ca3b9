"""PyTorch port: ``gat_attention(guard_shift=True)``, the run-time check of
the shift bound's domain, against the JAX package's (its kernels in Pallas
interpret mode on the CPU).

JAX's three value-domain cases (tests/test_value_domain.py:41-92), on the
same graph, tiling and inputs drawn from the same seed: ``gat_shift_gap``
equal within 1e-6 relative; on adversarial logits (a_src spread 200) the
unguarded kernel collapses (off the exact result by more than 0.1) and the
guarded call lands within 1e-4 of the exact per-row-max reference; on
benign logits the guard takes the kernel's route and matches the unguarded
call within 1e-6.  Both packages' answers agree within 1e-5 * max(1,
max |jax|).  Gradients through a guarded call, on either route and in both
a_src forms, equal autograd of ``_gat_reference``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as J  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import tile_graph as j_tile  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import gat as JA  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch as T  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.graph import tile_graph as t_tile  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import gat as TA  # noqa: E402

CPU = "cpu"
TILE = dict(block_rows=128, block_cols=128, tile_edges=64, unit_weight=True)
F32_TOL = 1e-5


def _close(port, ref, tol):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= bound, (err, bound)


def _graphs(rng, n=300, e=2000):
    """JAX's ``_rand_graph(rng, add_self_loops=True)`` in both packages,
    with the tiling and the device graph of each."""
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    hj = J.build_host_graph(s, r, n, add_self_loops=True)
    ht = T.build_host_graph(s, r, n, add_self_loops=True)
    return (hj.to_device(), j_tile(hj, **TILE),
            ht.to_device(CPU), t_tile(ht, **TILE, device=CPU))


def _adversarial(rng, n, H=2, D=4, spread=200.0):
    """JAX's ``_adversarial_inputs``: one +spread/2 a_src row, the rest
    spread/2 below it."""
    h = rng.standard_normal((n, H * D)).astype(np.float32)
    a_s = (rng.standard_normal((n, H)) - spread / 2).astype(np.float32)
    a_s[0, :] = spread / 2
    a_d = rng.standard_normal((n, H)).astype(np.float32)
    return h, a_s, a_d


def _benign(rng, n):
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((n, 8), (n, 2), (n, 2)))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_gap_detects_adversarial_like_jax():
    rng = np.random.default_rng(0)
    gj, _, gt, _ = _graphs(rng)
    _, a_s, _ = _adversarial(rng, gt.n_node)
    benign = (rng.standard_normal((gt.n_node, 2)) * 3.0).astype(np.float32)
    for a, above in ((a_s, True), (benign, False)):
        vj = float(JA.gat_shift_gap(gj, jnp.asarray(a)))
        vt = float(TA.gat_shift_gap(gt, torch.from_numpy(a)))
        np.testing.assert_allclose(vt, vj, rtol=1e-6)
        assert (vt > TA.SHIFT_GAP_SAFE) == above
    assert TA.SHIFT_GAP_SAFE == JA.SHIFT_GAP_SAFE


def test_adversarial_unguarded_collapse_guarded_exact():
    rng = np.random.default_rng(0)
    gj, tj, gt, tt = _graphs(rng)
    h, a_s, a_d = _adversarial(rng, gt.n_node)
    exact = TA._gat_reference(tt, *_t(h, a_s, a_d), 0.2)
    _close(exact, JA._gat_reference(tj, *_j(h, a_s, a_d), 0.2), F32_TOL)
    raw = TA.gat_attention(tt, *_t(h, a_s, a_d), heads=2)
    _close(raw, JA.gat_attention(tj, *_j(h, a_s, a_d), heads=2,
                                 interpret=True), F32_TOL)
    assert float((raw - exact).abs().max()) > 0.1
    guarded = TA.gat_attention(tt, *_t(h, a_s, a_d), heads=2, g=gt,
                               guard_shift=True)
    np.testing.assert_allclose(guarded.numpy(), exact.numpy(), rtol=1e-4,
                               atol=1e-4)
    jg = JA.gat_attention(tj, *_j(h, a_s, a_d), heads=2, interpret=True,
                          g=gj, guard_shift=True)
    _close(guarded, jg, F32_TOL)


def test_benign_passthrough():
    rng = np.random.default_rng(0)
    gj, tj, gt, tt = _graphs(rng)
    h, a_s, a_d = _benign(rng, gt.n_node)
    raw = TA.gat_attention(tt, *_t(h, a_s, a_d), heads=2)
    guarded = TA.gat_attention(tt, *_t(h, a_s, a_d), heads=2, g=gt,
                               guard_shift=True)
    np.testing.assert_allclose(guarded.numpy(), raw.numpy(), rtol=1e-6,
                               atol=1e-6)
    jg = JA.gat_attention(tj, *_j(h, a_s, a_d), heads=2, interpret=True,
                          g=gj, guard_shift=True)
    _close(guarded, jg, F32_TOL)


def test_guard_needs_g():
    rng = np.random.default_rng(0)
    _, _, gt, tt = _graphs(rng)
    with pytest.raises(AssertionError, match="guard_shift needs g"):
        TA.gat_attention(tt, *_t(*_benign(rng, gt.n_node)), heads=2,
                         guard_shift=True)


@pytest.mark.parametrize("case", ["adversarial", "benign"])
@pytest.mark.parametrize("wmode", [False, True])
def test_guarded_gradient_is_reference_autograd(case, wmode):
    """The guard turns the fused backward off: whichever route the forward
    takes, the gradient in h, a_src (or w_asrc) and a_dst is autograd of
    the exact edge formulation."""
    rng = np.random.default_rng(1)
    _, _, gt, tt = _graphs(rng)
    n = gt.n_node
    h, a_s, a_d = (_adversarial(rng, n) if case == "adversarial"
                   else _benign(rng, n))
    w = (rng.standard_normal((8, 2)) / np.sqrt(8)).astype(np.float32)
    if wmode and case == "adversarial":
        # h w with the outlier row of h alone reaching the top
        h[0] = 0.0
        h[0, :2] = 1e3
        w[:2] = np.eye(2, dtype=np.float32) / 10.0
        w[2:] = 0.0
    gy = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))

    def grads(fn):
        hv, sv, dv = (torch.from_numpy(v.copy()).requires_grad_(True)
                      for v in (h, w if wmode else a_s, a_d))
        y = fn(hv, sv, dv)
        return (y,) + torch.autograd.grad(y, (hv, sv, dv), gy)

    def guarded(hv, sv, dv):
        kw = dict(w_asrc=sv) if wmode else dict(a_src=sv)
        return TA.gat_attention(tt, hv, a_dst=dv, heads=2, g=gt,
                                guard_shift=True, **kw)

    def reference(hv, sv, dv):
        a = hv.float() @ sv.float() if wmode else sv
        return TA._gat_reference(tt, hv, a, dv, 0.2)

    got, want = grads(guarded), grads(reference)
    a = (torch.from_numpy(h) @ torch.from_numpy(w)) if wmode else a_s
    gap = float(TA.gat_shift_gap(gt, torch.as_tensor(a)))
    assert (gap > TA.SHIFT_GAP_SAFE) == (case == "adversarial")
    for g_, w_ in zip(got, want):
        _close(g_, w_.detach().numpy(), F32_TOL)
