"""PyTorch port: ``ops/primitives.dense_mm`` on the CPU, its plain path and
the autograd Function that carries K16 on the card.

Every case holds ``dense_mm`` bit for bit to the rounded float32 formula
(round both operands to the compute dtype, widen, multiply; autograd
through it): the forward, dW and dx.  On the card K16 sums in
another order (``tests/test_torch_cuda.py`` holds it to the float32 bound on
reordered sums); here the plain version and the Function's backward are the
same float32 products as that formula's."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.ops import primitives as P  # noqa: E402

BF16 = torch.bfloat16


def _formula(x, w, compute_dtype):
    """The rounded float32 product, differentiated by autograd."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc) @ w.to(acc)


def _inputs(m, k, n, x_dtype, seed=0, w_dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((m, k), generator=gen) * 3).to(x_dtype)
    w = (torch.randn((k, n), generator=gen) * 0.1).to(w_dtype)
    return x, w


def _grads(fn, x, w, gy):
    x = x.detach().clone().requires_grad_(x.is_floating_point())
    w = w.detach().clone().requires_grad_(True)
    y = fn(x, w)
    y.backward(gy)
    return y.detach(), x.grad, w.grad


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a.double() - b.double()).abs().max())


def _check_bitwise(x, w, seed=1):
    y0 = _formula(x, w, BF16)
    gen = torch.Generator().manual_seed(seed)
    gy = torch.randn(y0.shape, generator=gen)
    with torch.no_grad():
        _same(P.dense_mm(x, w, BF16), y0)
    ref = _grads(lambda a, b: _formula(a, b, BF16), x, w, gy)
    got = _grads(lambda a, b: P.dense_mm(a, b, BF16), x, w, gy)
    for r, g in zip(ref, got):
        _same(g, r)
    # w alone needs a gradient (layer 0: x is the input features)
    wr = w.detach().clone().requires_grad_(True)
    wg = w.detach().clone().requires_grad_(True)
    _formula(x, wr, BF16).backward(gy)
    y = P.dense_mm(x, wg, BF16)
    assert y.grad_fn is not None
    y.backward(gy)
    _same(wg.grad, wr.grad)


SHAPES = [(k, n) for k in (602, 128) for n in (128, 41, 4, 1)]


def _shape_case(x_dtype, k, n):
    x, w = _inputs(97, k, n, x_dtype, seed=k + n)
    _check_bitwise(x, w)


def _special_case(name):
    if name == "compute_none":
        # the float32 yardstick: a plain product, no rounding
        x, w = _inputs(50, 602, 41, torch.float32)
        _same(P.dense_mm(x, w), x @ w)
        xr = x.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        y = P.dense_mm(xr, wr)
        assert "DenseXW" not in type(y.grad_fn).__name__
    elif name == "float64_none":
        # the float64 yardstick keeps float64
        x, w = _inputs(50, 128, 41, torch.float64, w_dtype=torch.float64)
        y = P.dense_mm(x, w)
        assert y.dtype == torch.float64
        _same(y, x @ w)
    elif name == "float64_bf16":
        x, w = _inputs(50, 128, 41, torch.float64)
        _check_bitwise(x, w)
    elif name == "float16_bf16":
        # another dtype than K16 reads: rounded to bf16 once, as the formula
        x, w = _inputs(50, 128, 41, torch.float16)
        _check_bitwise(x, w)
    elif name == "batched_x":
        # x's leading dimensions are rows (jnp.dot's contraction)
        x, w = _inputs(3 * 17, 128, 41, torch.float32)
        _check_bitwise(x.reshape(3, 17, 128), w)
        _check_bitwise(x[0], w)
    elif name == "w_not_2d":
        x, w = _inputs(8, 16, 4, torch.float32)
        with pytest.raises(ValueError, match="2-d w"):
            P.dense_mm(x, w[None], BF16)
    elif name == "bf16_weights":
        x, w = _inputs(61, 128, 41, torch.float32, w_dtype=BF16)
        _check_bitwise(x, w)
    elif name == "col_major":
        # transposed operands take mm's other backward layout
        x, w = _inputs(128, 70, 33, torch.float32)
        _check_bitwise(x.t().contiguous().t(), w.t().contiguous().t())
    elif name == "strided_x":
        x, _ = _inputs(65, 610, 1, torch.float32)
        _, w = _inputs(1, 602, 128, torch.float32)
        _check_bitwise(x[:, 3:605], w)
    elif name == "no_grad_needed":
        # inference: no graph, and x̂ is not kept
        x, w = _inputs(40, 128, 41, torch.float32)
        w.requires_grad_(True)
        with torch.inference_mode():
            y = P.dense_mm(x, w, BF16)
        assert y.grad_fn is None
        _same(y, _formula(x, w.detach(), BF16))
        y, xh = P.dense_xw_plain(x, w.detach(), False)
        assert xh is None
        _, xh = P.dense_xw_plain(x, w.detach(), True)
        _same(xh, x.to(BF16).float())
    elif name == "launches":
        before = P.dense_mm.launches
        x, w = _inputs(70, 602, 128, torch.float32)
        P.dense_mm(x, w, BF16)
        _grads(lambda a, b: P.dense_mm(a, b, BF16), x, w,
               torch.ones((70, 128)))
        assert P.dense_mm.launches == before == 0
    else:
        raise AssertionError(name)


CASES = ([("shape", dt, k, n) for dt in ("float32", "bfloat16")
          for k, n in SHAPES]
         + [("special", name) for name in (
             "compute_none", "float64_none", "float64_bf16", "float16_bf16",
             "batched_x", "w_not_2d", "bf16_weights",
             "col_major", "strided_x", "no_grad_needed", "launches")])


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_dense_mm_cpu_equals_the_rounded_formula(case):
    """The forward and both gradients equal the formula's bit for bit,
    for float32 and bf16 x at layer 0's and layer 1's widths; the float32
    and float64 yardsticks keep their paths; K16 never launches on the
    CPU."""
    if case[0] == "shape":
        _shape_case(getattr(torch, case[1]), case[2], case[3])
    else:
        _special_case(case[1])


def test_xw_smem_and_tiles_fit_a_block():
    """K16's shared memory for each column tile: W's chunks for the
    k-segments the wrapper cuts (602 -> 128 in one), never over the
    block's limit."""
    for np_ in P.XW_WIDTHS:
        step = P._xw_k_step(np_)
        assert step % 64 == 0
        assert P._xw_smem(step, np_) <= P.XW_SMEM_MAX
        assert P._xw_smem(step + 64, np_) > P.XW_SMEM_MAX
    assert P._xw_k_step(128) >= 602
    assert P._xw_smem(602, 128) == 10 * 128 * 128 + P.XW_HAT + 1024
    assert P._xw_smem(128, 48) == 2 * 48 * 128 + P.XW_HAT + 1024
