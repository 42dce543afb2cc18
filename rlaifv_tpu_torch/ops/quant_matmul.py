"""int8 weight-only matrix products: x @ (q * scale) and its input gradient
with the weight q kept int8 in device memory.

Counterpart of rlaifv_tpu/ops/quant_matmul.py, with its names and layouts:
x (..., K), q (K, N) int8, scale (N,) fp32 per output channel.

- `int8_matmul` (TPU kernel #7): each row of x quantised inside the kernel
  (sx = max(max|x|, 1e-20) / 127, xq = clamp(round(x / sx), -127, 127)),
  int8 x int8 -> int32, out = (acc * sx) * scale; on the card by the route
  `fwd_plan` picks: at decode rows a row pass quantises once, then the
  product splits the K contraction into slices whose exact int32 partials
  are summed (`int8_fwd_split_plain`);
- `int8_matmul_dx` (#8): dx = (dy * scale) @ q^T with dy * scale quantised
  per row the same way, q^T never made: on the card a row pass quantises
  once, then the product splits the N contraction into `dx_split` slices
  whose exact int32 partials are summed in order (`int8_dx_split_plain`);
- `int8_matmul_prequant` (#9), `int8_matmul_dx_prequant` (#10): the same
  functions with the rows quantised beforehand (as XLA does it outside
  Pallas in the JAX package: here by #7's and #8's row passes on the card,
  `quantize_rows_cuda`, and `quantize_rows` on the CPU), and a pure int8
  product kernel; #9 takes the route `fwd_prequant_plan` picks (a wide TMA
  + wgmma tile with q^T built in registers where TMA can map the rows),
  #10 the route `dx_prequant_plan` picks (a wide TMA + wgmma tile where
  its tiles fill the card, #8's split product where they do not).

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
from typing import NamedTuple, Tuple

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


# kernel #7's split product (csrc/quant_matmul.cu, qfwd): the output
# columns (columns of q) a CTA owns, which is also the contraction chunk a
# stage holds, and the row counts it is built for (x's rows rounded up to
# one of them)
FWD_TILE = 128
FWD_ROWS = (8, 16, 24, 32, 48, 64, 96, 128)
# the most rows the split product takes; more take the cp.async kernel
FWD_SPLIT_MAX_M = 127
# the C entry's route codes: the cp.async kernel for "rows" and "tile"
FWD_ROUTES = {"rows": 0, "tile": 0, "split": 1}


class FwdPlan(NamedTuple):
    """How one kernel #7 (or #9) call runs: `route` ("split", "tile" or
    "rows"; #9: "wide" or "rows"), the output `tile` (rows, columns) a CTA
    owns, the K contraction's `split` and the kernels the call
    `launches`."""
    route: str
    tile: Tuple[int, int]
    split: int
    launches: int


def fwd_plan(M: int, K: int, N: int, sms: int, tma: bool = True) -> FwdPlan:
    """Kernel #7's route on x (M, K), q (K, N):
    - "rows": rows a TMA tensor map cannot read (N or K not a multiple of
      16, x or q off 16 bytes) take the cp.async kernel, 128 x 128 tiles,
      one launch;
    - "tile": more than FWD_SPLIT_MAX_M rows take the same kernel;
    - "split": the row pass, then the product on tiles of x's rows rounded
      up to FWD_ROWS x 128 columns, its K contraction in as many slices of
      128-row chunks as keep the CTAs within one an SM (never more slices
      than chunks): two launches. A slice's partial sums cost more than
      further CTAs win (tools/split_sweep.py), so only the narrow widths
      split: N 4096 in 4 slices, N 6144 in 2, N 11008 and wider in one."""
    if not tma or N % 16 or K % 16:
        return FwdPlan("rows", (128, 128), 1, 1)
    if M > FWD_SPLIT_MAX_M:
        return FwdPlan("tile", (128, 128), 1, 1)
    rows = next(r for r in FWD_ROWS if r >= M)
    split = max(1, min(-(-K // FWD_TILE), sms // -(-N // FWD_TILE)))
    return FwdPlan("split", (rows, FWD_TILE), split, 2)


def fwd_slices(K: int, split: int) -> list:
    """The K rows [k0, k1) of each of kernel #7's `split` slices: slice s
    holds the 128-row chunks [s nc / split, (s + 1) nc / split) of nc."""
    nc = -(-K // FWD_TILE)
    return [(min(K, s * nc // split * FWD_TILE), min(K, (s + 1) * nc // split * FWD_TILE))
            for s in range(split)]


def int8_fwd_split_plain(xq, sx, q, scale, split: int) -> torch.Tensor:
    """Kernel #7's product as the card splits it: xq (M, K) int8, sx (M, 1)
    fp32 -> fp32 (M, N). Each slice's exact integer partial, summed
    (exact: int32 on the card), rounds once to fp32, times sx, times
    scale."""
    acc = 0
    for k0, k1 in fwd_slices(xq.shape[1], split):
        acc = acc + _exact_product(xq[:, k0:k1], q[k0:k1])
    return acc.float() * sx * scale.float()


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


# kernel #10's wide tile (csrc/quant_matmul.cu, qdx::dx_wide): rows of dyq
# and output columns (rows of q) a CTA owns
WIDE_TILE = (128, 256)
# the C entry's route codes
DX_ROUTES = {"rows": 0, "wide": 1, "split": 2}


class DxPlan(NamedTuple):
    """How one kernel #10 call runs: `route` ("wide", "split" or "rows"),
    the output `tile` (rows, columns) a CTA owns, the N contraction's
    `split` and the kernels the call `launches`."""
    route: str
    tile: Tuple[int, int]
    split: int
    launches: int


def dx_prequant_plan(M: int, K: int, N: int, sms: int, tma: bool = True) -> DxPlan:
    """Kernel #10's route on dyq (M, N), q (K, N):
    - "rows": rows a TMA tensor map cannot read (N % 16 != 0, or dyq or q
      off 16 bytes) take the cp.async kernel, 128 x 128 tiles, one launch;
    - "wide": the 128 x 256 tile at split 1 where its tiles fill the card
      (at least one a streaming multiprocessor): QLoRA's prefix and suffix
      rows;
    - "split": fewer rows take #8's product on the prequantised rows, its
      N contraction in `dx_split` slices, and the pass that sums them."""
    if not tma or N % 16:
        return DxPlan("rows", (128, 128), 1, 1)
    rows, cols = WIDE_TILE
    if -(-M // rows) * -(-K // cols) >= sms:
        return DxPlan("wide", WIDE_TILE, 1, 1)
    split = dx_split(M, K, N, sms)
    return DxPlan("split", (64 if M <= 64 else 128, DX_TILE), split, 1 + (split > 1))


# kernel #9's wide tile (csrc/quant_matmul.cu, qpre::fwd_wide): rows of xq
# and columns of q a CTA owns
PREQ_TILE = (128, 256)
# the C entry's route codes: the cp.async kernel, the wide tile
PREQ_ROUTES = {"rows": 0, "wide": 1}


def fwd_prequant_plan(M: int, K: int, N: int, sms: int, tma: bool = True) -> FwdPlan:
    """Kernel #9's route on xq (M, K), q (K, N):
    - "rows": rows a TMA tensor map cannot read (N or K not a multiple of
      16, xq or q off 16 bytes) take the cp.async kernel, 128 x 128 tiles,
      one launch;
    - "wide": every other row count takes the 128 x 256 tile (q^T built in
      registers, wgmma), one launch: QLoRA's prefix and suffix rows and a
      batch's prefill fill the card with it; one prompt's prefill (128 to a
      few hundred rows) does not, but the tile alone still reads faster there
      than the cp.async kernel and than a K split of the tile (whose last
      CTA sums int32 partials) on the H100, so `sms` changes nothing."""
    if not tma or N % 16 or K % 16:
        return FwdPlan("rows", (128, 128), 1, 1)
    return FwdPlan("wide", PREQ_TILE, 1, 1)


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


def _align16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=512)
def _fwd_call(M: int, K: int, N: int, sms: int, tma: bool, plan: FwdPlan = None) -> tuple:
    """One #7 call's plan (fwd_plan's, or `plan`), the C entry's route
    codes, the byte offsets of its scratch (sx, the tile counters, the
    partials) and the scratch's size, cached: a decode step calls #7 with a
    few shapes over and over, and the host's time a call is part of an
    eager step's."""
    plan = plan or fwd_plan(M, K, N, sms, tma)
    o_sx = _align16(M * K)
    o_cnt = _align16(o_sx + 4 * M)
    o_part = _align16(o_cnt + 4 * -(-N // FWD_TILE))
    size = o_part + 4 * plan.split * M * N if plan.split > 1 else o_cnt
    return plan, (FWD_ROUTES[plan.route], plan.tile[0], plan.split), o_sx, o_cnt, o_part, size


def _kernel_fwd(x2, q, scale, plan: FwdPlan = None) -> torch.Tensor:
    """Kernel #7 on x (M, K) bf16 -> (M, N) bf16, by the route `fwd_plan`
    picks (or `plan`). The split route's scratch is one byte buffer: xq (M,
    K) int8, sx (M,) fp32 and, with slices, the tile counters and the int32
    partials (split, M, N)."""
    M, K = x2.shape
    N = q.shape[1]
    _check("int8_matmul", x2, torch.bfloat16, q, scale=(scale, N))
    if q.shape[0] != K:
        raise ValueError(f"int8_matmul: x (M, {K}) against q {tuple(q.shape)}")
    dev = x2.device
    plan, codes, o_sx, o_cnt, o_part, size = _fwd_call(
        M, K, N, _sms(dev.index or 0), q.data_ptr() % 16 == 0 and x2.data_ptr() % 16 == 0,
        plan)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    buf = xq = sx = part = cnt = None
    if plan.route == "split":  # held until the launch is queued
        buf = torch.empty(size, dtype=torch.uint8, device=dev)
        xq = buf.data_ptr()
        sx = xq + o_sx
        if plan.split > 1:
            cnt, part = xq + o_cnt, xq + o_part
    _launch("int8_matmul_bf16", x2, q, scale, xq, sx, part, cnt, out, M, K, N, *codes)
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


def _kernel_prequant(xq, sx, q, scale, plan: FwdPlan = None) -> torch.Tensor:
    """Kernel #9 on xq (M, K) int8, sx (M,) fp32 -> (M, N) bf16, by the
    route `fwd_prequant_plan` picks (or `plan`)."""
    M, K = xq.shape
    N = q.shape[1]
    _check("int8_matmul_prequant", xq, torch.int8, q, sx=(sx, M), scale=(scale, N))
    if q.shape[0] != K:
        raise ValueError(f"int8_matmul_prequant: xq (M, {K}) against q {tuple(q.shape)}")
    dev = xq.device
    plan = plan or fwd_prequant_plan(M, K, N, _sms(dev.index or 0),
                                     q.data_ptr() % 16 == 0 and xq.data_ptr() % 16 == 0)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    _launch("int8_matmul_prequant_bf16", xq, sx, q, scale, out, M, K, N,
            PREQ_ROUTES[plan.route])
    int8_matmul_prequant.launches += 1
    return out


def quantize_rows_cuda(x2: torch.Tensor, scale: torch.Tensor = None) -> tuple:
    """The prequant wrappers' row quantisation on the card: x (M, C) bf16
    (times scale (C,) fp32 where given: #10's dy * s) -> int8 (M, C) and
    fp32 (M,) row scales, bit for bit `quantize_rows` of the same fp32
    values, by the row passes of kernels #7 and #8 (one CTA a row)."""
    M, C = x2.shape
    if x2.dtype != torch.bfloat16 or not x2.is_contiguous():
        raise TypeError(f"quantize_rows_cuda takes contiguous bf16 rows; got {x2.dtype} "
                        f"strides {x2.stride()}")
    if scale is not None and (scale.dtype != torch.float32 or tuple(scale.shape) != (C,)
                              or not scale.is_contiguous() or scale.device != x2.device):
        raise ValueError(f"quantize_rows_cuda: scale must be ({C},) fp32 contiguous on "
                         f"{x2.device}")
    xq = torch.empty((M, C), dtype=torch.int8, device=x2.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x2.device)
    _launch("int8_quant_rows_bf16", x2, scale, xq, sx, M, C)
    return xq, sx


def _kernel_dx_prequant(dyq, sy, q) -> torch.Tensor:
    """Kernel #10 on dyq (M, N) int8, sy (M,) fp32 -> (M, K) bf16, by the
    route `dx_prequant_plan` picks."""
    M, N = dyq.shape
    K = q.shape[0]
    _check("int8_matmul_dx_prequant", dyq, torch.int8, q, sy=(sy, M))
    if q.shape[1] != N:
        raise ValueError(f"int8_matmul_dx_prequant: dyq (M, {N}) against q {tuple(q.shape)}")
    dev = dyq.device
    plan = dx_prequant_plan(M, K, N, _sms(dev.index or 0),
                            q.data_ptr() % 16 == 0 and dyq.data_ptr() % 16 == 0)
    part = torch.empty((plan.split, M, K), dtype=torch.int32, device=dev) \
        if plan.split > 1 else None
    dx = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    _launch("int8_matmul_dx_prequant_bf16", dyq, sy, q, part, dx, M, K, N,
            DX_ROUTES[plan.route], plan.split)
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


def _rows_on_card(x2, scale=None) -> tuple:
    """The prequant kernels' rows on the card: bf16 rows by the row passes
    (`quantize_rows_cuda`), others (no int8 path of the port runs them) by
    `quantize_rows` as before."""
    if x2.dtype == torch.bfloat16:
        return quantize_rows_cuda(x2, scale)
    v = x2.float() if scale is None else x2.float() * scale.float()
    xq, sx = quantize_rows(v)
    return xq, sx.reshape(-1)


def int8_matmul_prequant(x, q, scale) -> torch.Tensor:
    """int8_matmul with the rows quantised once beforehand, then the pure
    int8 product kernel (#9): on the card the rows by #7's row pass
    (`quantize_rows_cuda`), on the CPU by `quantize_rows` and the plain
    twin."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()  # the quantised rows keep its layout
    if not x.is_cuda:
        xq, sx = quantize_rows(x2.float())
        out = int8_matmul_prequant_plain(xq, sx, q, scale).to(x.dtype)
    elif x2.shape[0]:
        out = _kernel_prequant(*_rows_on_card(x2), q, scale)
    else:
        out = x2.new_empty((0, q.shape[1]))
    return out.reshape(*x.shape[:-1], q.shape[1])


def int8_matmul_dx_prequant(dy, q, scale) -> torch.Tensor:
    """int8_matmul_dx with dy * scale quantised once beforehand, then the
    pure int8 product kernel (#10): on the card the rows by #8's row pass
    (`quantize_rows_cuda`), on the CPU by `quantize_rows` and the plain
    twin."""
    d2 = dy.reshape(-1, dy.shape[-1]).contiguous()
    if not dy.is_cuda:
        dyq, sy = quantize_rows(d2.float() * scale.float())
        dx = int8_matmul_dx_prequant_plain(dyq, sy, q).to(dy.dtype)
    elif d2.shape[0]:
        dx = _kernel_dx_prequant(*_rows_on_card(d2, scale), q)
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
