"""int4 weight-only matrix products: x @ dequant(qp, gs) and its input
gradient, with the weight kept nibble-packed in device memory.

Counterpart of rlaifv_tpu/ops/int4_matmul.py, with its names and layouts:
x (..., K); qp (K/2, N) int8 holding two int4 weights a byte; gs (K/G, N)
fp32, one scale per group of G contraction rows and output column (G =
INT4_GROUP = 128 wherever it divides K, `pick_int4_group`). Within group i,
byte row r holds row i G + r in its low nibble and row i G + G/2 + r in its
high nibble (`pack_int4`), so any whole group unpacks on its own.

- `int4_matmul` (TPU kernel #11): the rows of x quantised once, in torch
  (`quant_matmul.quantize_rows`, as XLA does it outside Pallas in the JAX
  package), then for each group an exact int8 x int4 sub-dot, converted to
  fp32 and times gs[g], the groups summed in order in fp32, times the row
  scale;
- `int4_matmul_dx` (#12): for each output group j, dy * gs[j] quantised per
  row with its own scale sy, an exact int8 sub-dot over all N against the
  group's unpacked rows, times sy. On the card one pass over dy writes the
  (M, K/G) table of every sy (`int4_dx_row_scales`), and the product
  rounds each quotient without a division (`bracketed_round`).

The kernels live in csrc/int4_matmul.cu. Each entry point launches its
kernel for a CUDA tensor (bf16 activations; anything else raises) and runs
its plain PyTorch twin for a CPU tensor. The twins sum each group's products
exactly (int64 on the CPU, float64 on the card; |sum| < 2^24 either way)
and quantise with IEEE divisions, so a kernel equals its twin bit for bit.

`int4_matmul_grad` is the differentiable product that models/llama.py's
QuantDense(bits=4) runs on the card (the JAX package's `jax.custom_vjp`):
#11 forward where `_kernel_legal` (G % 128 == 0 and N % 128 == 0), #12
backward where also N <= INT4_DX_MAX_N, and the dequant formula elsewhere.
INT4_IMPL = "dequant" sends every shape to the dequant formula (the
comparison route). Its backward returns dx only: qp and gs are frozen.
"""
from __future__ import annotations

import numpy as np
import torch

from rlaifv_tpu_torch.ops.quant_matmul import _int_product, _launch, quantize_rows

INT4_GROUP = 128  # quantization group size along the contraction axis
# #11 sums 16 times each weight (csrc/int4_matmul.cu); a group's int32 sum
# stays exact in fp32 up to this group size
FWD_MAX_GROUP = 1024
# Widest output whose dx takes kernel #12; wider ones (gate/up at N = 11008)
# take the dequant formula. The JAX package's choice (a TPU VMEM budget), not
# measured on the H100.
INT4_DX_MAX_N = 8192
# "kernel" (default): the dispatch above; "dequant": the dequant formula
# for every shape, forward and dx
INT4_IMPL = "kernel"
IMPLS = ("kernel", "dequant")


def pick_int4_group(K: int) -> int:
    """Group size for a K-row kernel: 128 (the AWQ/GPTQ convention) when it
    tiles K — required by the kernels. Smaller K (tiny test models) falls
    back to one group; those run the exact dequant path."""
    if K % INT4_GROUP == 0:
        return INT4_GROUP
    if K % 2:
        raise ValueError(f"int4 packing needs an even K (K={K})")
    return K


def pack_int4(q, group: int = INT4_GROUP):
    """(K, N) int8 values in [-7, 7] -> (K/2, N) packed bytes (numpy).
    Group-local layout: byte r of group i packs (lo=row i*G+r,
    hi=row i*G+G/2+r)."""
    q = np.asarray(q, np.int8)
    K, N = q.shape
    if group % 2 or K % group:
        raise ValueError(f"group({group}) must be even and divide K({K})")
    hg = group // 2
    g = q.reshape(K // group, 2, hg, N)  # [:, 0] = lo rows, [:, 1] = hi rows
    lo = g[:, 0].astype(np.uint8) & 0xF
    hi = g[:, 1].astype(np.uint8) << 4
    return (lo | hi).astype(np.int8).reshape(K // 2, N)


def quantize_int4(w, group: int = INT4_GROUP):
    """(K, N) float -> (packed int8 (K/2, N), scales f32 (K//group, N)).
    numpy in, numpy out; see `pack_int4` for the byte layout."""
    w = np.asarray(w, np.float32)
    K, N = w.shape
    if K % group or group % 2:
        raise ValueError(f"K={K} not a multiple of even group={group}")
    g = w.reshape(K // group, group, N)
    scale = np.abs(g).max(axis=1) / 7.0  # (K//group, N)
    scale = np.maximum(scale, 1e-8)
    q = np.clip(np.round(g / scale[:, None, :]), -7, 7).astype(np.int8)
    return pack_int4(q.reshape(K, N), group), scale.astype(np.float32)


def pack_int4_torch(q: torch.Tensor, group: int = INT4_GROUP) -> torch.Tensor:
    """`pack_int4` on q's device: (K, N) int8 in [-8, 7] -> (K/2, N) int8."""
    K, N = q.shape
    if group % 2 or K % group:
        raise ValueError(f"group({group}) must be even and divide K({K})")
    g = q.to(torch.int32).reshape(K // group, 2, group // 2, N)
    b = (g[:, 0] & 0xF) | ((g[:, 1] & 0xF) << 4)  # the byte, 0..255
    return torch.where(b > 127, b - 256, b).to(torch.int8).reshape(K // 2, N).contiguous()


def unpack_int4(packed: torch.Tensor, group: int = INT4_GROUP) -> torch.Tensor:
    """(K/2, N) packed bytes -> (K, N) int8 in [-8, 7] on their device (the
    inverse of `pack_int4`)."""
    K2, N = packed.shape
    if group % 2 or (2 * K2) % group:
        raise ValueError(f"group({group}) must be even and divide K({2 * K2})")
    hg = group // 2
    b = packed.to(torch.int32).reshape(K2 // hg, hg, N)
    lo = ((b & 0xF) ^ 8) - 8  # sign-extend the low nibble
    hi = b >> 4  # the arithmetic shift sign-extends the high one
    return torch.stack([lo, hi], dim=1).reshape(2 * K2, N).to(torch.int8)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """(K/2, N) packed + (K//G, N) scales -> (K, N) dequantized weights:
    fp32 products rounded once to `dtype` (the dequant formula)."""
    K = 2 * packed.shape[0]
    G = K // scale.shape[0]
    s = scale.float().repeat_interleave(G, dim=0)
    return (unpack_int4(packed, G).float() * s).to(dtype)


def _group(qp: torch.Tensor, gs: torch.Tensor) -> int:
    return 2 * qp.shape[0] // gs.shape[0]


def _kernel_legal(qp: torch.Tensor, gs: torch.Tensor) -> bool:
    return _group(qp, gs) % 128 == 0 and qp.shape[1] % 128 == 0


def int4_product_plain(xq, sx, qp, gs) -> torch.Tensor:
    """Twin of kernel #11 on prequantised rows: xq (M, K) int8, sx (M, 1)
    fp32 -> fp32 (M, N), the sum over groups g in order of fp32(exact
    int sub-dot) * gs[g], times sx. One group at a time (a float64 product
    over every group at once would not fit at M = 6144, K = 11008)."""
    G = _group(qp, gs)
    q = unpack_int4(qp, G)
    acc = None
    for g in range(gs.shape[0]):
        part = _int_product(xq[:, g * G:(g + 1) * G], q[g * G:(g + 1) * G]) * gs[g]
        acc = part if acc is None else acc + part
    return acc * sx


def int4_matmul_plain(x, qp, gs) -> torch.Tensor:
    """Twin of `int4_matmul`: (..., K) -> (..., N) in x.dtype."""
    x2 = x.reshape(-1, x.shape[-1])
    out = int4_product_plain(*quantize_rows(x2.float()), qp, gs)
    return out.to(x.dtype).reshape(*x.shape[:-1], qp.shape[1])


def int4_matmul_dx_plain(dy, qp, gs) -> torch.Tensor:
    """Twin of kernel #12: (..., N) -> (..., K) in dy.dtype; for each output
    group j, dy * gs[j] quantised per row, an exact sub-dot over N, times
    that group's row scale."""
    G = _group(qp, gs)
    q = unpack_int4(qp, G)
    d2 = dy.reshape(-1, dy.shape[-1]).float()
    out = d2.new_empty((d2.shape[0], 2 * qp.shape[0]))
    for j in range(gs.shape[0]):
        dyq, sy = quantize_rows(d2 * gs[j])
        out[:, j * G:(j + 1) * G] = _int_product(dyq, q[j * G:(j + 1) * G].T) * sy
    return out.to(dy.dtype).reshape(*dy.shape[:-1], out.shape[1])


# the relative half-width of the brackets around 1 / sy (csrc/int4_matmul.cu)
BRACKET = 2.0 ** -20


def int4_dx_row_scales(dy2: torch.Tensor, gs: torch.Tensor) -> torch.Tensor:
    """Plain version of #12's row-scale pass: fp32 dy (M, N), gs (J, N) ->
    the (M, J) table sy[m, j] = max(max_n |dy[m, n] gs[j, n]|, 1e-20) / 127
    (the product rounded to fp32, the quotient IEEE: `quantize_rows`' scale
    of dy * gs[j], group for group)."""
    amax = torch.stack([(dy2 * gs[j]).abs().amax(dim=-1) for j in range(gs.shape[0])], 1)
    amax = torch.clamp_min(amax, 1e-20)
    return amax / torch.full_like(amax, 127.0)


def bracketed_round(v: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """#12's rounding, in torch: fp32 v (M, C), sy (M, 1) -> int8 equal to
    `quantize_rows`' clamp(round(v / sy)) bit for bit, by its rule: with r =
    1 / sy (fp32, IEEE), r1 = r (1 - BRACKET) and r2 = r (1 + BRACKET)
    rounded to fp32, v r1 and v r2 (exact in float64: two 24-bit
    significands) bracket the IEEE quotient; where both round to one
    integer (half to even) that is the result, elsewhere the quotient
    v / sy itself (fp32, IEEE) is rounded."""
    r = torch.ones_like(sy) / sy
    lo = torch.round(v.double() * (r * (1 - BRACKET)).double())
    hi = torch.round(v.double() * (r * (1 + BRACKET)).double())
    out = torch.where(lo == hi, lo.float(), torch.round(v / sy))
    return out.clamp_(-127, 127).to(torch.int8)


def _check_weight(name: str, qp: torch.Tensor, gs: torch.Tensor) -> None:
    """The layouts both kernels take: qp (K/2, N) int8, gs (K/G, N) fp32,
    G a multiple of 128 dividing K, N a multiple of 128 (the JAX package's
    legality rule for its kernels)."""
    if qp.dtype != torch.int8 or qp.dim() != 2:
        raise TypeError(f"{name}: qp must be a 2-D int8 (K/2, N) weight; got "
                        f"{qp.dtype} {tuple(qp.shape)}")
    K, N = 2 * qp.shape[0], qp.shape[1]
    if gs.dtype != torch.float32 or gs.dim() != 2 or gs.shape[1] != N or \
            not gs.shape[0] or K % gs.shape[0]:
        raise ValueError(f"{name}: gs must be (K/G, {N}) fp32 with K = {K}; got "
                         f"{gs.dtype} {tuple(gs.shape)}")
    if K // gs.shape[0] % 128 or N % 128:
        raise ValueError(f"{name}: the kernels take groups of a multiple of 128 rows "
                         f"and N a multiple of 128; got G={K // gs.shape[0]}, N={N}")


def _check_card(name: str, a: torch.Tensor, qp: torch.Tensor, gs: torch.Tensor) -> None:
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16 activations; got {a.dtype}")
    for key, t in (("qp", qp), ("gs", gs)):
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous on {a.device}")


def _kernel_fwd(xq, sx, qp, gs) -> torch.Tensor:
    """Kernel #11 on xq (M, K) int8, sx (M,) fp32 -> (M, N) bf16."""
    M, K = xq.shape
    N = qp.shape[1]
    _check_weight("int4_matmul", qp, gs)
    if xq.dtype != torch.int8 or K != 2 * qp.shape[0] or sx.dtype != torch.float32 \
            or sx.shape != (M,):
        raise TypeError(f"int4_matmul: xq (M, {2 * qp.shape[0]}) int8 and sx (M,) fp32; "
                        f"got {xq.dtype} {tuple(xq.shape)}, {sx.dtype} {tuple(sx.shape)}")
    for key, t in (("xq", xq), ("sx", sx), ("qp", qp), ("gs", gs)):
        if t.device != xq.device or not t.is_contiguous():
            raise ValueError(f"int4_matmul: {key} must be contiguous on {xq.device}")
    if qp.data_ptr() % 16 or gs.data_ptr() % 16:
        raise ValueError("int4_matmul: the kernel reads qp and gs through TMA, "
                         "which needs 16-byte aligned bases")
    if _group(qp, gs) > FWD_MAX_GROUP:
        raise ValueError(f"int4_matmul: the kernel takes groups of at most {FWD_MAX_GROUP} "
                         f"rows; got {_group(qp, gs)}")
    if xq.data_ptr() % 16:
        xq = xq.clone()  # a view at an odd offset; TMA reads aligned rows
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    _launch("int4_matmul_bf16", xq, sx, qp, gs, out, M, K, N, _group(qp, gs))
    int4_matmul.launches += 1
    return out


def _kernel_dx(dy2, qp, gs) -> torch.Tensor:
    """Kernel #12 on dy (M, N) bf16 -> (M, K) bf16: the pass of row maxima
    into an (M, K/G) table, then the product (two launches)."""
    M, N = dy2.shape
    K = 2 * qp.shape[0]
    _check_weight("int4_matmul_dx", qp, gs)
    _check_card("int4_matmul_dx", dy2, qp, gs)
    if qp.shape[1] != N or not dy2.is_contiguous():
        raise ValueError(f"int4_matmul_dx: dy must be contiguous (M, {qp.shape[1]}); "
                         f"got {tuple(dy2.shape)}")
    if qp.data_ptr() % 16 or gs.data_ptr() % 16:
        raise ValueError("int4_matmul_dx: the kernel reads qp and gs through TMA, "
                         "which needs 16-byte aligned bases")
    if dy2.data_ptr() % 16:
        dy2 = dy2.clone()  # a view at an odd offset; TMA reads aligned rows
    amax = torch.empty((M, gs.shape[0]), dtype=torch.float32, device=dy2.device)
    dx = torch.empty((M, K), dtype=torch.bfloat16, device=dy2.device)
    _launch("int4_matmul_dx_bf16", dy2, qp, gs, amax, dx, M, K, N, _group(qp, gs))
    int4_matmul_dx.launches += 1
    return dx


def int4_matmul(x, qp, gs) -> torch.Tensor:
    """(..., K) -> (..., N) in x.dtype: x @ dequant(qp, gs) with x quantised
    per row in torch, then kernel #11 on the card; the plain twin on the
    CPU."""
    _check_weight("int4_matmul", qp, gs)
    K, N = 2 * qp.shape[0], qp.shape[1]
    if x.shape[-1] != K:
        raise ValueError(f"int4_matmul: x (..., {x.shape[-1]}) against packed K={K}")
    if x.is_cuda:
        _check_card("int4_matmul", x, qp, gs)
    x2 = x.reshape(-1, K).contiguous()  # the quantised rows keep its layout
    xq, sx = quantize_rows(x2.float())
    if not x.is_cuda:
        out = int4_product_plain(xq, sx, qp, gs).to(x.dtype)
    elif x2.shape[0]:
        out = _kernel_fwd(xq, sx.reshape(-1), qp, gs)
    else:
        out = x2.new_empty((0, N))
    return out.reshape(*x.shape[:-1], N)


def int4_matmul_dx(dy, qp, gs) -> torch.Tensor:
    """(..., N) -> (..., K): dy @ dequant(qp, gs)^T, dy * gs[j] quantised
    per row for each output group j inside kernel #12 on the card; the
    plain twin on the CPU."""
    _check_weight("int4_matmul_dx", qp, gs)
    K, N = 2 * qp.shape[0], qp.shape[1]
    if dy.shape[-1] != N:
        raise ValueError(f"int4_matmul_dx: dy (..., {dy.shape[-1]}) against N={N}")
    if not dy.is_cuda:
        return int4_matmul_dx_plain(dy, qp, gs)
    d2 = dy.reshape(-1, N).contiguous()
    dx = _kernel_dx(d2, qp, gs) if d2.shape[0] else d2.new_empty((0, K))
    return dx.reshape(*dy.shape[:-1], K)


def dequant_int4_matmul(x, qp, gs) -> torch.Tensor:
    """The dequant formula (the JAX package's `_jnp_fallback`): x @ the
    weight dequantised to x's dtype, one product, no activation
    quantisation."""
    return x @ dequantize_int4(qp, gs, x.dtype)


def dequant_int4_matmul_dx(dy, qp, gs) -> torch.Tensor:
    """dy @ dequant(qp, gs)^T in dy's dtype (`_jnp_fallback_dx`)."""
    return dy @ dequantize_int4(qp, gs, dy.dtype).T


def _impl() -> str:
    if INT4_IMPL not in IMPLS:
        raise ValueError(f"INT4_IMPL={INT4_IMPL!r}: one of {IMPLS}")
    return INT4_IMPL


def _fwd_dispatch(x, qp, gs) -> torch.Tensor:
    if _impl() == "kernel" and _kernel_legal(qp, gs):
        return int4_matmul(x, qp, gs)
    return dequant_int4_matmul(x, qp, gs)


def _bwd_dispatch(dy, qp, gs) -> torch.Tensor:
    if _impl() == "kernel" and _kernel_legal(qp, gs) and dy.shape[-1] <= INT4_DX_MAX_N:
        return int4_matmul_dx(dy, qp, gs)
    return dequant_int4_matmul_dx(dy, qp, gs)


class _Int4MatmulGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, qp, gs):
        ctx.save_for_backward(qp, gs)  # never the activations
        return _fwd_dispatch(x, qp, gs)

    @staticmethod
    def backward(ctx, dy):
        qp, gs = ctx.saved_tensors
        return _bwd_dispatch(dy, qp, gs), None, None


def int4_matmul_grad(x, qp, gs) -> torch.Tensor:
    """x @ dequant(qp, gs), shape-dispatched (module docstring),
    differentiable in x only: the packed base is frozen (QLoRA: a 4-bit base
    with adapters beside it)."""
    return _Int4MatmulGrad.apply(x, qp, gs)


int4_matmul.launches = 0  # kernel #11 launches (CUDA tensors only)
int4_matmul_dx.launches = 0  # kernel #12
