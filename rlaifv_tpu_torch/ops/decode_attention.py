"""Decode attention: hand-written Hopper kernels + plain PyTorch versions.

Counterpart of rlaifv_tpu/ops/decode_attention.py: one query token per head
over a static (B, L, KVH, D) cache.

- `decode_attention` (TPU kernel #6): the whole cache, every column read,
  fp32 or bf16 operands, the arithmetic in fp32 whatever their type,
  causality folded into the mask by the caller; a row whose keys are all
  masked returns 0. Kernel in csrc/decode_attention_full.cu, plain version
  `decode_attention_ref`. No module of the JAX package calls it, and no
  path of the port does;
- `decode_attention_prefix` (TPU kernel #4): a bf16 cache, columns
  [0, valid_len); kernel in csrc/decode_attention.cu, plain version
  `decode_attention_prefix_ref`;
- `decode_attention_prefix_int8` (#5): an int8 cache with fp32 (B, L, KVH)
  per-(token, head) scales (`quantize_kv`), key blocks [0, ceil(valid_len /
  block_l)); q and the v-scaled probabilities are quantised to int8 per
  row (p per key block), so both products are int8 x int8 -> int32. Kernel
  in csrc/decode_attention_int8.cu, plain twin
  `decode_attention_prefix_int8_ref`. `decode_attention_prefix_int8_dense`
  is the JAX package's off-TPU formula (dense attention over the cache
  dequantised to q's type), which the model runs on the CPU and with
  attn_impl "dense".

Each wrapper launches its kernel for a CUDA tensor (anything it does not
take raises) and runs the plain version for a CPU tensor. `valid_len` is a
host int (the engine's cache_index + 1): the kernel's read range is fixed
at launch, with no device scalar to fetch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from rlaifv_tpu_torch.ops.attention import _build_bias, dense_attention, repeat_kv
from rlaifv_tpu_torch.ops.quant_matmul import _int_product, quantize_rows

NEG_INF = -1e30
DEFAULT_BLOCK_L = 256


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, L, KVH, D)
    v: torch.Tensor,  # (B, L, KVH, D)
    mask: torch.Tensor,  # (B, L) key validity
) -> torch.Tensor:
    """Plain version of kernel #6 (the TPU `_kernel`) in fp32 over every
    cache column -> (B, H, D) in q's type: s = (q . k) / sqrt(D) plus -1e30
    where mask == 0, m = max(max s, -5e29), p = exp(s - m) / max(sum p,
    1e-30), out = p . v. A row that sees no key outputs 0."""
    B, H, D = q.shape
    KVH = k.shape[2]
    n_rep = H // KVH
    qf = q.float().reshape(B, KVH, n_rep, D)
    s = torch.einsum("bgrd,btgd->bgrt", qf, k.float()) * (1.0 / D ** 0.5)
    s = s + torch.where(mask[:, None, None, :] != 0, 0.0, NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
    p = torch.exp(s - m)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bgrt,btgd->bgrd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def _kernel_full(q, k, v, mask):
    from rlaifv_tpu_torch.ops import _build

    B, H, D = q.shape
    L, KVH = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes q, k and v all fp32 or all bf16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[0] != B or tuple(mask.shape) != (B, L):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} mask {tuple(mask.shape)}")
    if D not in (64, 128) or H % KVH or H // KVH not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention kernel takes D in (64, 128) and n_rep in "
                         f"(1, 2, 4, 8); got D={D} H={H} KVH={KVH}")
    vec = 16 // q.element_size()  # elements of one 16-byte load
    if not (k.is_contiguous() and v.is_contiguous()) or k.data_ptr() % 16 \
            or v.data_ptr() % 16:
        raise ValueError("decode_attention kernel needs a contiguous, 16-byte aligned "
                         f"cache; got strides {k.stride()} / {v.stride()}")
    if q.stride(-1) != 1 or q.stride(0) % vec or q.stride(1) % vec or q.data_ptr() % 16:
        raise ValueError(f"q needs unit stride along D; got {q.stride()}")
    mask = mask.to(dtype=torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load_kernels().decode_attention_full_cuda(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, H, KVH, L, D, q.stride(0), q.stride(1), int(q.dtype == torch.bfloat16),
        1.0 / D ** 0.5, stream,
    )
    _build.check(err, "decode_attention_full_cuda")
    decode_attention.launches += 1
    return out


def decode_attention(
    q: torch.Tensor,  # (B, H, D) single-position queries
    k: torch.Tensor,  # (B, L, KVH, D) cache
    v: torch.Tensor,  # (B, L, KVH, D)
    mask: torch.Tensor,  # (B, L) key validity (causality folded in by the caller)
) -> torch.Tensor:
    """-> (B, H, D) in q's type. A CUDA tensor runs kernel #6 (q, k, v all
    fp32 or all bf16, a contiguous cache, D in {64, 128}, n_rep in {1, 2,
    4, 8}, any L; anything else raises); a CPU tensor runs
    `decode_attention_ref`."""
    if q.is_cuda:
        return _kernel_full(q, k, v, mask)
    return decode_attention_ref(q, k, v, mask)


decode_attention.launches = 0  # kernel #6 launches (CUDA tensors only)


def decode_attention_prefix_ref(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, L, KVH, D)
    v: torch.Tensor,  # (B, L, KVH, D)
    mask: torch.Tensor,  # (B, L) key validity
    valid_len: int,
) -> torch.Tensor:
    """Plain version of kernel #4: `decode_attention_ref` over columns
    [0, valid_len) -> (B, H, D)."""
    return decode_attention_ref(q, k[:, :valid_len], v[:, :valid_len], mask[:, :valid_len])


def _kernel(q, k, v, mask, valid_len):
    from rlaifv_tpu_torch.ops import _build

    B, H, D = q.shape
    L, KVH = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"decode_attention_prefix kernel takes bf16; {name} is {t.dtype}"
            )
    if not (k.is_contiguous() and v.is_contiguous()):
        # an expand()-ed cache (stride 0 over the batch) must be
        # materialised by the caller; the kernel indexes rows densely
        raise ValueError("decode_attention_prefix kernel needs a contiguous "
                         f"cache; got strides {k.stride()} / {v.stride()}")
    if q.stride(-1) != 1 or q.stride(0) % 8 or q.stride(1) % 8 \
            or q.data_ptr() % 16:
        raise ValueError(f"q needs unit stride along D; got {q.stride()}")
    if D not in (64, 128) or H % KVH or H // KVH not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention_prefix kernel takes D in (64, 128) "
                         f"and n_rep in (1, 2, 4, 8); got D={D} H={H} KVH={KVH}")
    if k.shape != v.shape or k.shape[0] != B or tuple(mask.shape) != (B, L):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"mask {tuple(mask.shape)}")
    if not isinstance(valid_len, int) or not 1 <= valid_len <= L:
        raise ValueError(f"valid_len must be an int in [1, {L}]; got {valid_len!r}")
    mask = mask.to(dtype=torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_prefix_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B, H, KVH, L, D, valid_len, q.stride(0), q.stride(1),
        1.0 / D ** 0.5, stream,
    )
    _build.check(err, "decode_attention_prefix_bf16")
    decode_attention_prefix.launches += 1
    return out


def decode_attention_prefix(
    q: torch.Tensor,  # (B, H, D) single-position queries
    k: torch.Tensor,  # (B, L, KVH, D) cache (static max length)
    v: torch.Tensor,  # (B, L, KVH, D)
    mask: torch.Tensor,  # (B, L) key validity within the prefix
    valid_len: int,  # cache columns [0, valid_len) are live
) -> torch.Tensor:
    """-> (B, H, D). A CUDA tensor runs the Hopper kernel (bf16, contiguous
    cache, D in {64, 128}; anything else raises); a CPU tensor runs
    `decode_attention_prefix_ref`."""
    if q.is_cuda:
        return _kernel(q, k, v, mask, valid_len)
    return decode_attention_prefix_ref(q, k, v, mask, valid_len)


decode_attention_prefix.launches = 0  # kernel launches (CUDA tensors only)


# ------------------------------------------------------------ int8 cache (#5)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, KVH, D) float -> (int8 values, (B, L, KVH) fp32 scales):
    symmetric per (token, head) over D, s = max(max|x|, 1e-20) / 127 and
    round half to even (`quantize_rows`: IEEE divisions)."""
    q, s = quantize_rows(x.float())
    return q, s[..., 0]


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * s[..., None].float()).to(dtype)


def prefix_block_l(L: int, block_l: Optional[int] = None) -> int:
    """The key block of kernel #5, the JAX rule: 256 when it divides L,
    else 128. The per-block quantisation of p makes it part of the
    function, so the kernel and its twin both take it from here."""
    if block_l is None:
        block_l = next((b for b in (DEFAULT_BLOCK_L, 128) if L % b == 0), None)
        if block_l is None:
            raise ValueError(f"decode_attention_prefix_int8: L={L} is not a multiple of 128")
    if L % block_l:
        raise ValueError(f"block_l={block_l} does not divide L={L}")
    return block_l


def decode_attention_prefix_int8_ref(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, L, KVH, D) int8
    k_scale: torch.Tensor,  # (B, L, KVH) fp32
    v: torch.Tensor,  # (B, L, KVH, D) int8
    v_scale: torch.Tensor,  # (B, L, KVH) fp32
    mask: torch.Tensor,  # (B, L) key validity
    valid_len: int,
    *,
    block_l: Optional[int] = None,
) -> torch.Tensor:
    """Plain twin of kernel #5 (the TPU `_prefix_kernel_int8`), block by
    block in fp32 -> (B, H, D) in q's type. Blocks [0, max(ceil(valid_len /
    block_l), 1)) are read whole, their columns past valid_len under the
    mask. Per block: s = int(q8 . k8) * sq * ks * (1/sqrt(D)) plus the mask
    bias; the online softmax (m floored at -5e29); pv = p * vs quantised per
    row of the block; acc = acc * corr + int(p8 . v8) * sp. Out = acc /
    max(l, 1e-30): a row that sees no key outputs 0. The integer sums are
    exact (`_int_product`: |sum| <= 127^2 x 256)."""
    B, H, D = q.shape
    L, KVH = k.shape[1], k.shape[2]
    n_rep = H // KVH
    bl = prefix_block_l(L, block_l)
    n_blocks = max(-(-valid_len // bl), 1)
    q8, sq = quantize_rows(q.float().reshape(B, KVH, n_rep, D))
    scale = 1.0 / D ** 0.5
    m = torch.full((B, KVH, n_rep, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, n_rep, D), device=q.device)
    for j in range(n_blocks):
        cols = slice(j * bl, (j + 1) * bl)
        kb = k[:, cols].permute(0, 2, 3, 1)  # (B, KVH, D, bl)
        vb = v[:, cols].permute(0, 2, 1, 3)  # (B, KVH, bl, D)
        ks = k_scale[:, cols].permute(0, 2, 1)[:, :, None, :].float()  # (B, KVH, 1, bl)
        vs = v_scale[:, cols].permute(0, 2, 1)[:, :, None, :].float()
        s = _int_product(q8, kb) * sq * ks * scale
        s = s + torch.where(mask[:, None, None, cols] != 0, 0.0, NEG_INF)
        m_new = torch.maximum(m, torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF / 2))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        p8, sp = quantize_rows(p * vs)  # the v scale folded into p
        acc = acc * corr + _int_product(p8, vb) * sp
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_prefix_int8_dense(q, k, k_scale, v, v_scale, mask) -> torch.Tensor:
    """The JAX package's formula off the TPU: dense attention over the whole
    cache dequantised to q's type, keys masked by `mask` -> (B, H, D)."""
    B, H, _ = q.shape
    L, KVH = k.shape[1], k.shape[2]
    n_rep = H // KVH
    kd = dequantize_kv(k, k_scale, q.dtype)
    vd = dequantize_kv(v, v_scale, q.dtype)
    bias = _build_bias(1, L, mask, False, None, q.device)
    return dense_attention(q[:, None], repeat_kv(kd, n_rep), repeat_kv(vd, n_rep), bias)[:, 0]


def _kernel_int8(q, k, k_scale, v, v_scale, mask, valid_len):
    from rlaifv_tpu_torch.ops import _build

    B, H, D = q.shape
    L, KVH = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"decode_attention_prefix_int8 kernel takes bf16 q; got {q.dtype}")
    for name, t, dtype, shape in (("k", k, torch.int8, (B, L, KVH, D)),
                                  ("v", v, torch.int8, (B, L, KVH, D)),
                                  ("k_scale", k_scale, torch.float32, (B, L, KVH)),
                                  ("v_scale", v_scale, torch.float32, (B, L, KVH))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"decode_attention_prefix_int8 kernel: {name} must be "
                             f"{shape} {dtype}, contiguous; got {tuple(t.shape)} "
                             f"{t.dtype} strides {t.stride()}")
    if q.stride(-1) != 1 or q.stride(0) % 8 or q.stride(1) % 8 or q.data_ptr() % 16:
        raise ValueError(f"q needs unit stride along D; got {q.stride()}")
    if D not in (64, 128) or H % KVH or H // KVH not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention_prefix_int8 kernel takes D in (64, 128) "
                         f"and n_rep in (1, 2, 4, 8); got D={D} H={H} KVH={KVH}")
    if tuple(mask.shape) != (B, L):
        raise ValueError(f"mask {tuple(mask.shape)} != ({B}, {L})")
    if not isinstance(valid_len, int) or not 1 <= valid_len <= L:
        raise ValueError(f"valid_len must be an int in [1, {L}]; got {valid_len!r}")
    bl = prefix_block_l(L)
    mask = mask.to(dtype=torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load_kernels().decode_attention_prefix_int8_bf16(
        q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(), v_scale.data_ptr(),
        mask.data_ptr(), out.data_ptr(), B, H, KVH, L, D, valid_len, bl,
        q.stride(0), q.stride(1), 1.0 / D ** 0.5, stream,
    )
    _build.check(err, "decode_attention_prefix_int8_bf16")
    decode_attention_prefix_int8.launches += 1
    return out


def decode_attention_prefix_int8(
    q: torch.Tensor,  # (B, H, D) single-position queries
    k: torch.Tensor,  # (B, L, KVH, D) int8 cache
    k_scale: torch.Tensor,  # (B, L, KVH) fp32
    v: torch.Tensor,  # (B, L, KVH, D) int8
    v_scale: torch.Tensor,  # (B, L, KVH) fp32
    mask: torch.Tensor,  # (B, L) key validity
    valid_len: int,  # cache columns [0, valid_len) are live
) -> torch.Tensor:
    """-> (B, H, D). A CUDA tensor runs kernel #5 (bf16 q, contiguous int8
    cache and fp32 scales, D in {64, 128}, L a multiple of 128; anything
    else raises: the JAX package's dense fallback for other L is not
    taken); a CPU tensor runs `decode_attention_prefix_int8_ref`."""
    if q.is_cuda:
        return _kernel_int8(q, k, k_scale, v, v_scale, mask, valid_len)
    return decode_attention_prefix_int8_ref(q, k, k_scale, v, v_scale, mask, valid_len)


decode_attention_prefix_int8.launches = 0  # kernel launches (CUDA tensors only)
