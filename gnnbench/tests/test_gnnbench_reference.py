"""The plain references against values worked out by hand on a 5-node
graph, the node order, the control's rounding and the plain AdamW."""
import math

import numpy as np
import pytest
import torch

from gnnbench.reference import common, gat, gcn

# 0->1, 1->2, 2->0, 3->1, 4->3; communities {0, 1} and {2, 3, 4}
S = [0, 1, 2, 3, 4]
R = [1, 2, 0, 1, 3]
COM = [0, 0, 1, 1, 1]
N = 5


def _graph():
    return common.prepare_graph(torch.tensor(S, dtype=torch.int32),
                                torch.tensor(R, dtype=torch.int32),
                                torch.tensor(COM), N)


def _edges_with_loops():
    return list(zip(S, R)) + [(v, v) for v in range(N)]


def test_self_loops_and_normalisation_by_hand():
    g = _graph()
    indeg = {0: 2, 1: 3, 2: 2, 3: 2, 4: 1}       # loops included
    outdeg = {v: 2 for v in range(N)}
    got = {(int(s), int(r)): float(w) for s, r, w in
           zip(g.senders, g.receivers, g.weight)}
    assert len(got) == len(_edges_with_loops())
    for s, r in _edges_with_loops():
        assert got[(s, r)] == pytest.approx(1 / math.sqrt(indeg[r]
                                                          * outdeg[s]))


def test_node_order_hub_first_then_communities():
    # degrees in + out: 4 5 4 4 3; the one hub (2% of 5 rounds to 1) is
    # node 1; then community 0 (node 0), then 1 by degree (2, 3, then 4)
    assert _graph().perm.tolist() == [1, 0, 2, 3, 4]


def test_gcn_forward_by_hand():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, 3))
    w0, w1 = rng.standard_normal((3, 4)), rng.standard_normal((4, 2))
    g = _graph()
    wt = {(int(s), int(r)): float(w) for s, r, w in
          zip(g.senders, g.receivers, g.weight)}

    def layer(h, w):
        t = h @ w
        out = np.zeros((N, w.shape[1]))
        for s, r in _edges_with_loops():
            out[r] += wt[(s, r)] * t[s]
        return out

    want = layer(layer(x, w0), w1)
    params = {"gcn_l0_w": torch.tensor(w0, dtype=torch.float32),
              "gcn_l1_w": torch.tensor(w1, dtype=torch.float32)}
    got = gcn.forward(params, g, torch.tensor(x, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_gat_forward_by_hand():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, 3))
    p = {"gat_l0_w": rng.standard_normal((3, 4)),
         "gat_l0_asrc": rng.standard_normal((4, 2)),
         "gat_l0_adst": rng.standard_normal((4, 2)),
         "gat_l1_w": rng.standard_normal((4, 2)),
         "gat_l1_asrc": rng.standard_normal((2, 1)),
         "gat_l1_adst": rng.standard_normal((2, 1))}

    def layer(h, w, a_s, a_d):
        t = h @ w
        heads = a_s.shape[1]
        d = t.shape[1] // heads
        es, ed = t @ a_s, t @ a_d
        out = np.zeros_like(t)
        for r in range(N):
            srcs = [s for s, rr in _edges_with_loops() if rr == r]
            for k in range(heads):
                e = np.array([es[s, k] + ed[r, k] for s in srcs])
                e = np.where(e >= 0, e, 0.2 * e)
                a = np.exp(e - e.max())
                a /= a.sum()
                for s, al in zip(srcs, a):
                    out[r, k * d:(k + 1) * d] += al * t[s, k * d:(k + 1) * d]
        return out

    h = layer(x, p["gat_l0_w"], p["gat_l0_asrc"], p["gat_l0_adst"])
    h = np.where(h > 0, h, np.expm1(h))          # ELU between the layers
    want = layer(h, p["gat_l1_w"], p["gat_l1_asrc"], p["gat_l1_adst"])
    got = gat.forward({k: torch.tensor(v, dtype=torch.float32)
                       for k, v in p.items()}, _graph(),
                      torch.tensor(x, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_param_specs_match_the_widths():
    cfg = dict(features=602, hidden=128, classes=41, layers=2, heads=4)
    assert gcn.param_specs(cfg) == [("gcn_l0_w", 602, 128),
                                    ("gcn_l1_w", 128, 41)]
    assert gat.param_specs(cfg) == [
        ("gat_l0_w", 602, 128), ("gat_l0_asrc", 128, 4),
        ("gat_l0_adst", 128, 4), ("gat_l1_w", 128, 41),
        ("gat_l1_asrc", 41, 1), ("gat_l1_adst", 41, 1)]


def test_fp8_rounding_is_coarser_than_bf16_and_keeps_gradients():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = float((common.fp8(x) - x).abs().max() / x.abs().max())
    e16 = float((x.bfloat16().float() - x).abs().max() / x.abs().max())
    assert 4 * e16 < e8 < 2 ** -3
    v = x.clone().requires_grad_(True)
    common.fp8_round(v).sum().backward()
    assert torch.equal(v.grad, torch.ones_like(x))


def test_adamw_matches_torch():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(64, 5, generator=gen)
    y = torch.randint(0, 3, (64,), generator=gen)
    mask = torch.rand(64, generator=gen) < 0.7
    w0 = {"w": torch.randn(5, 3, generator=gen)}
    opt = {"lr": 0.01, "weight_decay": 5e-4, "betas": [0.9, 0.999],
           "eps": 1e-8}

    def fwd(p, g, x_, rnd):
        return x_ @ p["w"]

    got = common.train_steps(fwd, w0, None, x, y, mask, opt, 3)
    w = w0["w"].clone().requires_grad_(True)
    ta = torch.optim.AdamW([w], lr=0.01, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=5e-4)
    losses = []
    for _ in range(3):
        ta.zero_grad()
        loss = common.masked_loss(x @ w, y, mask)
        loss.backward()
        losses.append(float(loss.detach()))
        ta.step()
    assert got["losses"] == pytest.approx(losses, rel=1e-6)
    torch.testing.assert_close(got["delta"]["w"], w.detach() - w0["w"],
                               rtol=1e-5, atol=1e-7)
