"""int8 weight-only matrix products: x @ (q * scale) and its input gradient
with the weight q kept int8 in device memory.

Counterpart of rlaifv_tpu/ops/quant_matmul.py, with its names and layouts:
x (..., K), q (K, N) int8, scale (N,) fp32 per output channel.

- `int8_matmul` (TPU kernel #7): each row of x quantised inside the kernel
  (sx = max(max|x|, 1e-20) / 127, xq = clamp(round(x / sx), -127, 127)),
  int8 x int8 -> int32, out = (acc * sx) * scale;
- `int8_matmul_dx` (#8): dx = (dy * scale) @ q^T with dy * scale quantised
  per row the same way, q^T never made: on the card a row pass quantises
  once, then the product splits the N contraction into `dx_split` slices
  whose exact int32 partials are summed in order (`int8_dx_split_plain`);
- `int8_matmul_prequant` (#9), `int8_matmul_dx_prequant` (#10): the same
  functions with the rows quantised beforehand, in torch (as XLA does it
  outside Pallas in the JAX package), and a pure int8 product kernel.

The kernels live in csrc/quant_matmul.cu. Each entry point launches its
kernel for a CUDA tensor (bf16 activations; anything else raises) and runs
its plain PyTorch twin for a CPU tensor. The twins sum the int8 products
exactly (int64 on the CPU, float64 on the card, both exact far beyond
127^2 x 11008) and quantise with IEEE divisions, so a kernel equals its
twin bit for bit, and #7 equals #9 and #8 equals #10.

`int8_matmul_grad` is the differentiable, shape-dispatched product that
models/llama.py's QuantDense runs on the card (the JAX package's
`jax.custom_vjp`): rows >= INT8_DEQUANT_MIN_M take INT8_LARGE_M_IMPL
("prequant": #9/#10, the default; "kernel": #7/#8; "dequant": a bf16
product of the dequantised weight), fewer rows take #7/#8. Its backward
returns dx only: q and scale are frozen.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Tuple

import torch

# Row count from which the prequantised kernels (#9, #10) replace the
# in-kernel-quantisation ones (#7, #8). 128 is the JAX package's crossover,
# measured on a TPU; it has not been measured on the H100 yet.
INT8_DEQUANT_MIN_M = int(os.environ.get("RLAIFV_INT8_DEQUANT_MIN_M", "128"))
# large-M route: "prequant" (default) | "kernel" | "dequant"
INT8_LARGE_M_IMPL = os.environ.get("RLAIFV_INT8_LARGE_M_IMPL", "prequant")
LARGE_M_IMPLS = ("prequant", "kernel", "dequant")


def quantize_rows(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (M, C) -> (int8 (M, C), fp32 (M, 1) scales): sx = max(max|v|,
    1e-20) / 127 and clamp(round_half_even(v / sx), -127, 127). Both
    divisions are tensor by tensor: PyTorch multiplies by the reciprocal of
    a Python-scalar divisor, which is not the IEEE quotient."""
    amax = v.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp_min(amax, 1e-20) / torch.full_like(amax, 127.0)
    return torch.round(v / sx).clamp_(-127, 127).to(torch.int8), sx


def _exact_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, C) @ int8 (C, P) -> the exact integer sums: int64 on the
    CPU, float64 on the card (exact below 2^53)."""
    if a.is_cuda:
        return a.double() @ b.double()
    return a.long() @ b.long()


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact sums as fp32 (one rounding, as the kernels' int32 -> fp32
    conversion)."""
    return _exact_product(a, b).float()


def int8_matmul_prequant_plain(xq, sx, q, scale) -> torch.Tensor:
    """Twin of kernel #9: xq (M, K) int8, sx (M, 1) fp32 -> fp32 (M, N)
    (acc * sx) * scale, before the cast to the activation type."""
    return _int_product(xq, q) * sx * scale.float()


def int8_matmul_dx_prequant_plain(dyq, sy, q) -> torch.Tensor:
    """Twin of kernel #10: dyq (M, N) int8, sy (M, 1) -> fp32 (M, K)."""
    return _int_product(dyq, q.T) * sy


def int8_matmul_plain(x, q, scale) -> torch.Tensor:
    """Twin of kernel #7 (and of `int8_matmul_prequant`): (..., N) in x.dtype."""
    x2 = x.reshape(-1, x.shape[-1])
    out = int8_matmul_prequant_plain(*quantize_rows(x2.float()), q, scale)
    return out.to(x.dtype).reshape(*x.shape[:-1], q.shape[1])


def int8_matmul_dx_plain(dy, q, scale) -> torch.Tensor:
    """Twin of kernel #8 (and of `int8_matmul_dx_prequant`): (..., K)."""
    d2 = dy.reshape(-1, dy.shape[-1]).float() * scale.float()
    out = int8_matmul_dx_prequant_plain(*quantize_rows(d2), q)
    return out.to(dy.dtype).reshape(*dy.shape[:-1], q.shape[0])


# kernel #8's tiles (csrc/quant_matmul.cu, qdx): the output columns (rows
# of q) a CTA owns and the contraction chunk a stage holds
DX_TILE = 128


def dx_split(M: int, K: int, N: int, sms: int, tma: bool = True) -> int:
    """Slices of kernel #8's N contraction. Rows take one 64-row warpgroup
    a CTA at M <= 64 (two CTAs an SM) and two above (one an SM); the
    slices multiply the (output tile, row tile) CTAs up to that count,
    with at least one 128-wide chunk a slice. 1 where TMA cannot map the
    rows (N % 16 != 0 or an unaligned q), which #10's kernel takes."""
    if not tma or N % 16:
        return 1
    rows, per_sm = (64, 2) if M <= 64 else (128, 1)
    tiles = -(-M // rows) * -(-K // DX_TILE)
    return max(1, min(-(-N // DX_TILE), -(-per_sm * sms // tiles)))


def dx_launches(split: int) -> int:
    """Kernel launches of one #8 call: the row pass, the product and, with
    more than one slice, the pass that sums them."""
    return 2 + (split > 1)


def int8_dx_split_plain(dyq, sy, q, split: int) -> torch.Tensor:
    """Kernel #8's product as the card splits it: dyq (M, N) int8, sy (M, 1)
    fp32 -> fp32 (M, K). Slice s holds the 128-wide chunks [s nc / split,
    (s + 1) nc / split) of nc; each slice's exact integer partial, summed
    in slice order (exact: int32 on the card), rounds once to fp32, times
    sy."""
    N = dyq.shape[1]
    nc = -(-N // DX_TILE)
    acc = 0
    for s in range(split):
        c0, c1 = (min(N, s * nc // split * DX_TILE),
                  min(N, (s + 1) * nc // split * DX_TILE))
        acc = acc + _exact_product(dyq[:, c0:c1], q[:, c0:c1].T)
    return acc.float() * sy


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, a: torch.Tensor, a_dtype: torch.dtype, q: torch.Tensor,
           **fp32) -> None:
    if a.dtype != a_dtype:
        raise TypeError(f"{name}: the kernel takes {a_dtype} activations; got {a.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"{name}: q must be a 2-D int8 (K, N) weight; got "
                        f"{q.dtype} {tuple(q.shape)}")
    for key, (t, n) in fp32.items():
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{name}: {key} must be ({n},) fp32; got {t.dtype} "
                             f"{tuple(t.shape)}")
    for key, t in dict(a=a, q=q, **{k: t for k, (t, _) in fp32.items()}).items():
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on {a.device}")


def _launch(fn: str, *args) -> None:
    from rlaifv_tpu_torch.ops import _build

    err = getattr(_build.load_kernels(), fn)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        torch.cuda.current_stream(args[0].device).cuda_stream)
    _build.check(err, fn)


def _kernel_fwd(x2, q, scale) -> torch.Tensor:
    """Kernel #7 on x (M, K) bf16 -> (M, N) bf16."""
    M, K = x2.shape
    N = q.shape[1]
    _check("int8_matmul", x2, torch.bfloat16, q, scale=(scale, N))
    if q.shape[0] != K:
        raise ValueError(f"int8_matmul: x (M, {K}) against q {tuple(q.shape)}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x2.device)
    _launch("int8_matmul_bf16", x2, q, scale, out, M, K, N)
    int8_matmul.launches += 1
    return out


def _kernel_dx(dy2, q, scale) -> torch.Tensor:
    """Kernel #8 on dy (M, N) bf16 -> (M, K) bf16: the row pass into dyq
    and sy, the split product, and the sum of the slices' int32 partials."""
    M, N = dy2.shape
    K = q.shape[0]
    _check("int8_matmul_dx", dy2, torch.bfloat16, q, scale=(scale, N))
    if q.shape[1] != N:
        raise ValueError(f"int8_matmul_dx: dy (M, {N}) against q {tuple(q.shape)}")
    dev = dy2.device
    split = dx_split(M, K, N, _sms(dev.index or 0), q.data_ptr() % 16 == 0)
    dyq = torch.empty((M, N), dtype=torch.int8, device=dev)
    sy = torch.empty((M,), dtype=torch.float32, device=dev)
    part = torch.empty((split, M, K), dtype=torch.int32, device=dev) if split > 1 else None
    dx = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    _launch("int8_matmul_dx_bf16", dy2, q, scale, dyq, sy, part, dx, M, K, N, split)
    int8_matmul_dx.launches += 1
    return dx


def _kernel_prequant(xq, sx, q, scale) -> torch.Tensor:
    """Kernel #9 on xq (M, K) int8, sx (M,) fp32 -> (M, N) bf16."""
    M, K = xq.shape
    N = q.shape[1]
    _check("int8_matmul_prequant", xq, torch.int8, q, sx=(sx, M), scale=(scale, N))
    if q.shape[0] != K:
        raise ValueError(f"int8_matmul_prequant: xq (M, {K}) against q {tuple(q.shape)}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    _launch("int8_matmul_prequant_bf16", xq, sx, q, scale, out, M, K, N)
    int8_matmul_prequant.launches += 1
    return out


def _kernel_dx_prequant(dyq, sy, q) -> torch.Tensor:
    """Kernel #10 on dyq (M, N) int8, sy (M,) fp32 -> (M, K) bf16."""
    M, N = dyq.shape
    K = q.shape[0]
    _check("int8_matmul_dx_prequant", dyq, torch.int8, q, sy=(sy, M))
    if q.shape[1] != N:
        raise ValueError(f"int8_matmul_dx_prequant: dyq (M, {N}) against q {tuple(q.shape)}")
    dx = torch.empty((M, K), dtype=torch.bfloat16, device=dyq.device)
    _launch("int8_matmul_dx_prequant_bf16", dyq, sy, q, dx, M, K, N)
    int8_matmul_dx_prequant.launches += 1
    return dx


def _rows(t: torch.Tensor) -> int:
    return math.prod(t.shape[:-1])


def int8_matmul(x, q, scale) -> torch.Tensor:
    """(..., K) -> (..., N) in x.dtype: x @ (q * scale), x quantised per row
    inside the kernel (#7) on the card, the plain twin on the CPU."""
    if not x.is_cuda:
        return int8_matmul_plain(x, q, scale)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _kernel_fwd(x2, q, scale) if x2.shape[0] else x2.new_empty((0, q.shape[1]))
    return out.reshape(*x.shape[:-1], q.shape[1])


def int8_matmul_dx(dy, q, scale) -> torch.Tensor:
    """(..., N) -> (..., K): (dy * scale) @ q^T, dy * scale quantised per
    row inside the kernel (#8) on the card, the plain twin on the CPU."""
    if not dy.is_cuda:
        return int8_matmul_dx_plain(dy, q, scale)
    d2 = dy.reshape(-1, dy.shape[-1]).contiguous()
    dx = _kernel_dx(d2, q, scale) if d2.shape[0] else d2.new_empty((0, q.shape[0]))
    return dx.reshape(*dy.shape[:-1], q.shape[0])


def int8_matmul_prequant(x, q, scale) -> torch.Tensor:
    """int8_matmul with the rows quantised once, in torch, then the pure
    int8 product kernel (#9) on the card; the plain twin on the CPU."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()  # the quantised rows keep its layout
    xq, sx = quantize_rows(x2.float())
    if not x.is_cuda:
        out = int8_matmul_prequant_plain(xq, sx, q, scale).to(x.dtype)
    elif x2.shape[0]:
        out = _kernel_prequant(xq, sx.reshape(-1), q, scale)
    else:
        out = x2.new_empty((0, q.shape[1]))
    return out.reshape(*x.shape[:-1], q.shape[1])


def int8_matmul_dx_prequant(dy, q, scale) -> torch.Tensor:
    """int8_matmul_dx with dy * scale quantised once, in torch, then the
    pure int8 product kernel (#10) on the card; the plain twin on the CPU."""
    d2 = dy.reshape(-1, dy.shape[-1]).contiguous()
    dyq, sy = quantize_rows(d2.float() * scale.float())
    if not dy.is_cuda:
        dx = int8_matmul_dx_prequant_plain(dyq, sy, q).to(dy.dtype)
    elif d2.shape[0]:
        dx = _kernel_dx_prequant(dyq, sy.reshape(-1), q)
    else:
        dx = d2.new_empty((0, q.shape[0]))
    return dx.reshape(*dy.shape[:-1], q.shape[0])


def dequant_matmul(x, q, scale) -> torch.Tensor:
    """The "dequant" route: x @ (q * scale) as one product in x's dtype
    (the weight dequantised first, the formula QuantDense runs on the CPU)."""
    return x @ (q.to(x.dtype) * scale.to(x.dtype))


def dequant_matmul_dx(dy, q, scale) -> torch.Tensor:
    """(dy @ (q * scale)^T), the "dequant" route's input gradient."""
    return dy @ (q.to(dy.dtype) * scale.to(dy.dtype)).T


def _large_m_impl() -> str:
    if INT8_LARGE_M_IMPL not in LARGE_M_IMPLS:
        raise ValueError(f"INT8_LARGE_M_IMPL={INT8_LARGE_M_IMPL!r}: one of {LARGE_M_IMPLS}")
    return INT8_LARGE_M_IMPL


def _fwd_dispatch(x, q, scale) -> torch.Tensor:
    if _rows(x) >= INT8_DEQUANT_MIN_M:
        impl = _large_m_impl()
        if impl == "prequant":
            return int8_matmul_prequant(x, q, scale)
        if impl == "dequant":
            return dequant_matmul(x, q, scale)
    return int8_matmul(x, q, scale)


def _bwd_dispatch(dy, q, scale) -> torch.Tensor:
    if _rows(dy) >= INT8_DEQUANT_MIN_M:
        impl = _large_m_impl()
        if impl == "prequant":
            return int8_matmul_dx_prequant(dy, q, scale)
        if impl == "dequant":
            return dequant_matmul_dx(dy, q, scale)
    return int8_matmul_dx(dy, q, scale)


class _Int8MatmulGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)  # never the activations
        return _fwd_dispatch(x, q, scale)

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        return _bwd_dispatch(dy, q, scale), None, None


def int8_matmul_grad(x, q, scale) -> torch.Tensor:
    """x @ (q * scale), shape-dispatched (module docstring), differentiable
    in x only: the int8 weight and its scales are frozen (QLoRA trains
    adapters beside them). The route is chosen per call from the row count,
    so a remat recompute takes the route its forward took."""
    return _Int8MatmulGrad.apply(x, q, scale)


int8_matmul.launches = 0  # kernel #7 launches (CUDA tensors only)
int8_matmul_dx.launches = 0  # kernel #8
int8_matmul_prequant.launches = 0  # kernel #9
int8_matmul_dx_prequant.launches = 0  # kernel #10
