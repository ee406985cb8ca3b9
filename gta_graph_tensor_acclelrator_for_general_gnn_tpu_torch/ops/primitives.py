"""Per-op implementations of the four IR primitives on torch tensors.

The port's per-op path and its end-to-end oracle (the JAX package's XLA
path): scatter is ``index_select``, gather is ``index_add_`` or
``scatter_reduce``, and node/edge appliers are elementwise ops or a matrix
product.  Semantics follow the JAX ``ops/primitives.py``:

  scatter  ORDER=C: node rows broadcast to edges by sender;
           ORDER=R: by receiver.  Padding edges read a zero dump row.
  gather   segment-reduce edge rows to their receiver (ADD / MAX / MEAN,
           and PNA's MIN / STD); padding edges land in the dump segment
           ``n_node``, sliced away.
  SCALER   PNA's degree scalers (:func:`degree_scalers`) from the graph's
           in-degrees.

Kernel: K16 ``csrc/dense_xw.cu`` behind :func:`dense_mm` with bf16
operands on a CUDA tensor (x W: x read once and rounded in registers,
wgmma with float32 sums).  It replaces no TPU kernel: the JAX package
leaves that product to XLA.  CPU tensors take its plain version,
:func:`dense_xw_plain`.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as tF

from .. import ir
from ..graph import GraphTensor
from ..utils import spans
from . import _ext


def scatter_to_edges(x: torch.Tensor, g: GraphTensor,
                     order: str = "C") -> torch.Tensor:
    """Node [N, F] -> edge [E_pad, F]."""
    idx = g.senders if order == "C" else g.receivers
    x1 = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)
    return x1.index_select(0, idx)


def gather_to_nodes(e: torch.Tensor, g: GraphTensor, reduce: str = ir.ADD,
                    order: str = "R") -> torch.Tensor:
    """Edge [E_pad, F] -> node [N, F] segment reduction."""
    idx = g.receivers if order == "R" else g.senders
    num = g.n_node + 1
    shape = (num,) + tuple(e.shape[1:])
    if reduce == ir.ADD:
        out = e.new_zeros(shape).index_add_(0, idx, e)
    elif reduce == ir.MAX:
        out = e.new_full(shape, float("-inf")).scatter_reduce_(
            0, idx.view(-1, *([1] * (e.dim() - 1))).expand_as(e), e, "amax")
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    elif reduce == ir.MIN:
        out = e.new_full(shape, float("inf")).scatter_reduce_(
            0, idx.view(-1, *([1] * (e.dim() - 1))).expand_as(e), e, "amin")
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    elif reduce in (ir.MEAN, ir.STD):
        d = e.new_zeros(num).index_add_(0, idx, g.edge_mask.to(e.dtype))
        d = torch.clamp(d, min=1.0)[:, None]
        out = e.new_zeros(shape).index_add_(0, idx, e) / d
        if reduce == ir.STD:
            out = std_from_moments(
                out, e.new_zeros(shape).index_add_(0, idx, e * e) / d)
    else:
        raise ValueError(f"bad gather reduce {reduce}")
    return out[: g.n_node]


def std_from_moments(mean: torch.Tensor, mean_sq: torch.Tensor
                     ) -> torch.Tensor:
    """PNA's std from a row's mean and mean of squares, as the PNA authors'
    code takes it: sqrt(relu(mean_sq - mean^2) + 1e-5)."""
    return torch.sqrt(torch.relu(mean_sq - mean * mean) + ir.STD_EPS)


def head_dot(e: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """GATv2's per-head score of edge values ``e`` [E, H*C] (heads
    head-major) under the attention vectors ``att`` [H, C]: [E, H], the
    sum over c of e[:, h*C + c] * att[h, c], in e's dtype."""
    H, C = att.shape
    return (e.view(-1, H, C) * att.to(e.dtype)).sum(-1)


def in_degree(g: GraphTensor) -> torch.Tensor:
    """Each node's count of real incoming edges, float32 [N]."""
    d = torch.zeros(g.n_node + 1, dtype=torch.float32,
                    device=g.receivers.device)
    return d.index_add_(0, g.receivers, g.edge_mask.float())[: g.n_node]


def degree_scalers(deg: torch.Tensor) -> Dict[str, torch.Tensor]:
    """PNA's degree scalers of in-degrees ``deg`` [N]: {'amplification':
    log(d+1)/delta, 'attenuation': delta/log(d+1)} as float32 [N, 1], d
    clamped to at least 1 and delta the mean of log(d+1) over the nodes,
    computed in float64 and rounded once."""
    logd = torch.log(deg.double().clamp(min=1.0) + 1.0)
    delta = logd.mean()
    return {"amplification": (logd / delta).float()[:, None],
            "attenuation": (delta / logd).float()[:, None]}


def exp_f64(v: torch.Tensor) -> torch.Tensor:
    """exp of ``v``; on the CPU taken in float64 and rounded once to v's
    dtype.  There PyTorch takes a contiguous float32 exp from MKL's vector
    math library (``vmsExp``), whose first call in a process now and then
    returns the main thread's share of the elements far less accurate
    than float32 (oneMKL 2024.0 on an AVX-512 / AMX host;
    ``MKL_CBWR=COMPATIBLE`` avoids it); every float32 exp of the port's
    plain versions and per-op path goes through here.  Other devices take
    ``torch.exp`` as it is."""
    if v.device.type != "cpu":
        return torch.exp(v)
    return torch.exp(v.double()).to(v.dtype)


_SF_FNS: Dict[str, Callable] = {
    "relu": torch.relu,
    "exp": exp_f64,
    "elu": tF.elu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": lambda x: x,
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
}


def special_function(x: torch.Tensor, name: str,
                     negative_slope: float = 0.2) -> torch.Tensor:
    if name == "leaky_relu":
        # where(x >= 0): jax.nn.leaky_relu, whose gradient at 0 is 1 (as
        # the backward kernels take it); tF.leaky_relu's is the slope
        return torch.where(x >= 0, x, negative_slope * x)
    fn = _SF_FNS.get(name)
    if fn is None:
        raise ValueError(f"unknown SF {name}")
    return fn(x)


def _broadcast_pair(a: torch.Tensor, b: torch.Tensor):
    """Equal widths as-is; width 1 broadcasts; when one width divides the
    other the narrow operand repeats head-major (alpha [E, H] against
    h [E, H*D]: each head's value repeated D times)."""
    fa, fb = a.shape[-1], b.shape[-1]
    if fa == fb or fa == 1 or fb == 1:
        return a, b
    if fb > fa and fb % fa == 0:
        return a.repeat_interleave(fb // fa, dim=-1), b
    if fa > fb and fa % fb == 0:
        return a, b.repeat_interleave(fa // fb, dim=-1)
    raise ValueError(f"incompatible widths {fa} vs {fb}")


def binary_op(compute: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _broadcast_pair(a, b)
    if compute == ir.ADD:
        return a + b
    if compute == ir.MUL:
        return a * b
    if compute == ir.SUB:
        return a - b
    if compute == ir.DIV:
        return a / b
    raise ValueError(f"bad binary compute {compute}")


def dense_mm(x: torch.Tensor, w: torch.Tensor,
             compute_dtype=None) -> torch.Tensor:
    """X @ W with float32 accumulation and a float32 result (float64 when X
    is float64, so the per-op path can serve as a float64 yardstick).

    ``compute_dtype=torch.bfloat16`` rounds both operands to bf16 first (the
    production policy); their products are exact in float32, so the f32
    product of the rounded operands is what the JAX package computes with
    ``preferred_element_type=float32``.  That bf16 product runs as K16 on a
    CUDA tensor (or raises) and as :func:`dense_xw_plain` on the CPU, both
    under :class:`_DenseXW` where a gradient is wanted; its gradients are
    autograd's of the plain version's formula.  x's leading dimensions are
    rows; an x or w of another dtype than K16 reads is rounded to bf16
    first, which is the same single rounding."""
    if compute_dtype == torch.bfloat16:
        if w.dim() != 2:
            raise ValueError(f"dense_mm takes a 2-d w, got shape "
                             f"{tuple(w.shape)}")
        x = x if x.dtype in XW_DTYPES else x.to(torch.bfloat16)
        w = w if w.dtype in XW_DTYPES else w.to(torch.bfloat16)
        x2 = (x if x.dim() == 2
              else x.reshape(x.shape[:-1].numel(), x.shape[-1]))
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _DenseXW.apply(x2, w)
        else:
            y = _dense_xw(x2, w, False)[0]
        return y if x.dim() == 2 else y.reshape(*x.shape[:-1], w.shape[1])
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    acc = torch.promote_types(x.dtype, torch.float32)
    return x.to(acc) @ w.to(acc)


dense_mm.launches = 0   # K16 launches


def dense_xw_plain(x: torch.Tensor, w: torch.Tensor, want_xhat: bool):
    """K16's plain version: ``(y, xhat)`` with y = round_bf16(x) @
    round_bf16(w) in float32 and xhat = float32(round_bf16(x)) (None unless
    ``want_xhat``)."""
    xa = x.to(torch.bfloat16).to(torch.float32)
    y = xa @ w.to(torch.bfloat16).to(torch.float32)
    return y, (xa if want_xhat else None)


XW_DTYPES = (torch.float32, torch.bfloat16)   # what K16 reads
XW_WIDTHS = (8, 32, 48, 64, 128)   # K16's column tiles, padded (wgmma n)
XW_SMEM_MAX = 232_448              # shared memory a block may use
XW_HAT = 8 * 16 * 64 * 4           # x̂'s tiles: 8 warps x 16 rows x 64 f32


def _xw_smem(k: int, np_: int) -> int:
    """K16's shared memory for k columns of x into an np_-wide tile: W's
    64-k chunks of np_ 128-byte rows, the warps' x̂ tiles and 1 KB for
    aligning them (``csrc/dense_xw.cu`` xw_smem, which the launch checks)."""
    return -(-k // 64) * np_ * 128 + XW_HAT + 1024


def _xw_k_step(np_: int) -> int:
    """The most k of one K16 launch into an np_-wide tile: as many 64-k
    chunks of W as fit shared memory beside the x̂ tiles."""
    return (XW_SMEM_MAX - XW_HAT - 1024) // (np_ * 128) * 64


def _xw_kernel(x: torch.Tensor, w: torch.Tensor, want_xhat: bool):
    """K16 wrapper: ``(y, xhat)`` as :func:`dense_xw_plain` gives them, x
    float32 or bf16 [M, K] (rows of any stride), w [K, N].  One launch per
    column tile of at most 128 and k-segment whose bf16 W fits shared
    memory; a later segment adds into y."""
    dev = x.device
    for t, name in ((x, "x"), (w, "w")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype not in XW_DTYPES:
            raise TypeError(f"K16 takes float32 or bf16 {name}, got "
                            f"{t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"K16 takes a 2-d {name}, got shape "
                             f"{tuple(t.shape)}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}")
    # rows are read with unit stride along k
    x = x if x.stride(1) == 1 else x.contiguous()
    w = w if w.stride(1) == 1 else w.contiguous()
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    xh = (torch.empty((M, K), dtype=torch.float32, device=dev)
          if want_xhat else None)
    if M == 0 or N == 0 or K == 0:
        return y.zero_(), xh
    lib = _ext.library()
    xs, ws = x.element_size(), w.element_size()
    with torch.cuda.device(dev):
        st = _ext.stream(x)
        for n0 in range(0, N, XW_WIDTHS[-1]):
            nt = min(XW_WIDTHS[-1], N - n0)
            np_ = next(v for v in XW_WIDTHS if v >= nt)
            step = _xw_k_step(np_)
            for k0 in range(0, K, step):
                kt = min(step, K - k0)
                rc = lib.gta_dense_xw(
                    x.data_ptr() + k0 * xs, x.stride(0),
                    _ext.DTYPE_CODE[x.dtype],
                    w.data_ptr() + (k0 * w.stride(0) + n0) * ws,
                    w.stride(0), _ext.DTYPE_CODE[w.dtype],
                    y.data_ptr() + n0 * 4, N,
                    xh.data_ptr() + k0 * 4 if xh is not None and n0 == 0
                    else None, K, M, kt, nt, int(k0 > 0),
                    _xw_smem(kt, np_), st)
                _ext.check(rc, "dense_xw")
                dense_mm.launches += 1
                spans.count("dense_mm.k16", 1)
    return y, xh


def _dense_xw(x: torch.Tensor, w: torch.Tensor, want_xhat: bool):
    if x.device.type == "cpu":
        return dense_xw_plain(x, w, want_xhat)
    return _xw_kernel(x, w, want_xhat)


def _col_major(t: torch.Tensor) -> bool:
    return t.stride(0) == 1 and t.stride(1) == t.shape[0]


class _DenseXW(torch.autograd.Function):
    """y = round_bf16(x) @ round_bf16(w), float32.  Forward: K16 (CPU: the
    plain version), which also writes xhat = float32(round_bf16(x)) when w
    needs a gradient.  Backward: what autograd of the plain version's
    formula computes, the same float32 products (``mm``'s two layouts
    included) and roundings: dx = bf16(ȳ Ŵᵀ) and dW = bf16(x̂ᵀ ȳ), each
    widened to its input's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        want_dx, want_dw = ctx.needs_input_grad[:2]
        y, xh = _dense_xw(x, w, want_dw)
        wh = w.to(torch.bfloat16).to(torch.float32) if want_dx else None
        ctx.save_for_backward(xh, wh)
        ctx.layout = (x.dtype, w.dtype, _col_major(x), _col_major(w))
        return y

    @staticmethod
    def backward(ctx, gy):
        xh, wh = ctx.saved_tensors
        x_dtype, w_dtype, x_cm, w_cm = ctx.layout
        dx = dw = None
        if ctx.needs_input_grad[0]:
            d = wh.mm(gy.t()).t() if x_cm else gy.mm(wh.t())
            dx = d.to(torch.bfloat16).to(x_dtype)
        if ctx.needs_input_grad[1]:
            d = gy.t().mm(xh).t() if w_cm else xh.t().mm(gy)
            dw = d.to(torch.bfloat16).to(w_dtype)
        return dx, dw
