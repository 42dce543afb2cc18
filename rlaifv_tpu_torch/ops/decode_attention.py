"""Decode attention: hand-written Hopper kernels + plain PyTorch versions.

Counterpart of rlaifv_tpu/ops/decode_attention.py: one query token per head
over a static (B, L, KVH, D) cache.

- `decode_attention` (TPU kernel #6): the whole cache, every column read,
  fp32 or bf16 operands, the arithmetic in fp32 whatever their type,
  causality folded into the mask by the caller; a row whose keys are all
  masked returns 0. Kernel in csrc/decode_attention_full.cu, its key axis
  split into `full_plan` ranges whose partial softmax states a merge pass
  combines (`decode_attention_split_ref`), plain version
  `decode_attention_ref`. No module of the JAX package calls it, and no
  path of the port does;
- `decode_attention_prefix` (TPU kernel #4): a bf16 cache, columns
  [0, valid_len); kernel in csrc/decode_attention.cu, the live keys split
  into `prefix_plan` ranges whose states a merge pass combines
  (`decode_attention_prefix_split_ref`), plain version
  `decode_attention_prefix_ref`;
- `decode_attention_prefix_int8` (#5): an int8 cache with fp32 (B, L, KVH)
  per-(token, head) scales (`quantize_kv`), key blocks [0, ceil(valid_len /
  block_l)); q and the v-scaled probabilities are quantised to int8 per
  row (p per key block), so both products are int8 x int8 -> int32. Kernel
  in csrc/decode_attention_int8.cu, its key blocks split into
  `prefix_int8_plan` ranges whose states a merge pass combines
  (`decode_attention_prefix_int8_split_ref`), plain twin
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
from rlaifv_tpu_torch.ops.quant_matmul import _int_product, _sms, quantize_rows

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


# kernel #6's split of the key axis: (batch row, kv head, split) CTAs for
# one wave of the CTAs an SM holds (by n_rep: 8-warp CTAs at n_rep 1-2, two
# an SM; 4-warp CTAs at 4, three, and at 8, two: their registers), at least
# FULL_MIN_KEYS keys a split
FULL_CTAS_PER_SM = {1: 2, 2: 2, 4: 3, 8: 2}
FULL_MIN_KEYS = 128


def full_plan(B: int, KVH: int, L: int, sms: int, n_rep: int = 4) -> int:
    """The splits of kernel #6's key axis: as many as B x KVH x splits CTAs
    fit in one wave (FULL_CTAS_PER_SM[n_rep] on each of `sms`
    multiprocessors), no more than leave each split FULL_MIN_KEYS keys (the
    merge stays a small part of the work), at least one. Llama3's GQA step
    (B 8, KVH 8, n_rep 4, L 2304) takes 6 (384 CTAs), batch 24 (KVH 32: 768
    CTAs already) one."""
    return max(1, min(FULL_CTAS_PER_SM[n_rep] * sms // (B * KVH), L // FULL_MIN_KEYS))


def full_split_ranges(L: int, splits: int) -> list:
    """The keys [l0, l1) of each split, as the kernel cuts them."""
    return [(s * L // splits, (s + 1) * L // splits) for s in range(splits)]


def decode_attention_split_ref(q, k, v, mask, splits: int) -> torch.Tensor:
    """Kernel #6 as the card splits it, in fp32 -> (B, H, D) in q's type:
    each split's state over its keys (`full_split_ranges`), m_s = max(max s,
    -5e29), l_s = sum exp(s - m_s), acc_s = sum exp(s - m_s) v (a masked key
    adds exp(-1e30 - m_s) = 0), then the merge: M = max m_s and out = (sum
    acc_s e^(m_s - M)) / max(sum l_s e^(m_s - M), 1e-30), splits in order.
    A split with no live key has m_s = -5e29, l_s = 0, acc_s = 0 and adds
    nothing; a row masked in every split gives 0. (The card keeps m in log2
    units and exponentiates with exp2: the same function, rounded
    elsewhere.)"""
    B, H, D = q.shape
    KVH = k.shape[2]
    n_rep = H // KVH
    qf = q.float().reshape(B, KVH, n_rep, D)
    states = []
    for l0, l1 in full_split_ranges(k.shape[1], splits):
        s = torch.einsum("bgrd,btgd->bgrt", qf, k[:, l0:l1].float()) * (1.0 / D ** 0.5)
        s = s + torch.where(mask[:, None, None, l0:l1] != 0, 0.0, NEG_INF)
        m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
        p = torch.exp(s - m)
        states.append((m, p.sum(dim=-1, keepdim=True),
                       torch.einsum("bgrt,btgd->bgrd", p, v[:, l0:l1].float())))
    mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
    num, den = 0.0, 0.0
    for m, l, acc in states:
        w = torch.exp(m - mx)
        num, den = num + acc * w, den + l * w
    out = num / torch.clamp(den, min=1e-30)
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
    splits = full_plan(B, KVH, L, _sms(q.device.index or 0), H // KVH)
    part = torch.empty((B, H, splits, D + 2), dtype=torch.float32, device=q.device) \
        if splits > 1 else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load_kernels().decode_attention_full_cuda(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), B, H, KVH, L, D, q.stride(0),
        q.stride(1), int(q.dtype == torch.bfloat16), splits, 1.0 / D ** 0.5, stream,
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


# the CTAs a streaming multiprocessor that kernel #4's splits aim for (three
# fit, with a 64 KB ring of shared-memory stages each: csrc/decode_attention.cu;
# a split beyond one CTA an SM reads no faster, tools/split_sweep.py) and the
# fewest keys a split takes
PREFIX_CTAS_PER_SM = 1
PREFIX_MIN_KEYS = 256


def prefix_plan(B: int, KVH: int, valid_len: int, sms: int, n_rep: int = 4) -> int:
    """The splits of kernel #4's live keys [0, valid_len): as many as bring
    the B x KVH (batch row, kv head) CTAs up to PREFIX_CTAS_PER_SM on each
    of `sms` multiprocessors, no more than leave each split PREFIX_MIN_KEYS
    keys, at least one; no split once B x KVH reaches that. The splits cut
    [0, valid_len) only (`full_split_ranges(valid_len, splits)`), so no
    column past valid_len is read. The CTA serves all n_rep (1, 2, 4 or 8)
    query heads of its group, so n_rep does not change the plan. Llama3-8B's
    bf16 GQA step (B 8, KVH 8: 64 CTAs, valid_len 2200) takes 2 splits on
    132 SMs, at phase 13's short prompts (valid_len 384) one; phase 4's
    decode (B 10, KVH 32: 320 CTAs) and batch 24 (768) one."""
    if n_rep not in (1, 2, 4, 8):
        raise ValueError(f"prefix_plan: n_rep must be 1, 2, 4 or 8; got {n_rep}")
    return max(1, min(PREFIX_CTAS_PER_SM * sms // (B * KVH), valid_len // PREFIX_MIN_KEYS))


def decode_attention_prefix_split_ref(q, k, v, mask, valid_len: int, splits: int) -> torch.Tensor:
    """Kernel #4 as the card splits it: `decode_attention_split_ref`'s
    function over the live prefix, its keys [0, valid_len) cut at
    `full_split_ranges(valid_len, splits)`, in fp32 -> (B, H, D) in q's
    type. Each split's scores s (plus -1e30 where the mask is 0), m_s =
    max(max s, -5e29), p_s = exp(s - m_s), l_s = sum p_s; then M = max m_s,
    w_s = exp(m_s - M), den = max(sum l_s w_s, 1e-30) and out = sum (p_s w_s
    / den) . v_s, splits in order. A split with no live key has l_s = 0 and
    p_s = 0 and adds nothing; a row masked in every split gives 0. At one
    split (w = 1) this is `decode_attention_prefix_ref`'s arithmetic bit
    for bit. (The card sums acc_s = p_s . v_s and divides after the merge,
    merges with a running max, keeps m in log2 units and rounds p to bf16
    for its P.V product, as the TPU kernel does: the same function, rounded
    elsewhere.)"""
    B, H, D = q.shape
    KVH = k.shape[2]
    if not 1 <= splits <= valid_len:
        raise ValueError(f"splits must be in [1, {valid_len}]; got {splits}")
    qf = q.float().reshape(B, KVH, H // KVH, D)
    states = []
    for l0, l1 in full_split_ranges(valid_len, splits):
        s = torch.einsum("bgrd,btgd->bgrt", qf, k[:, l0:l1].float()) * (1.0 / D ** 0.5)
        s = s + torch.where(mask[:, None, None, l0:l1] != 0, 0.0, NEG_INF)
        m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
        p = torch.exp(s - m)
        states.append((l0, l1, m, p))
    mx = torch.stack([m for _, _, m, _ in states]).amax(dim=0)
    w = [torch.exp(m - mx) for _, _, m, _ in states]
    den = 0.0
    for (_, _, _, p), ws in zip(states, w):
        den = den + p.sum(dim=-1, keepdim=True) * ws
    den = torch.clamp(den, min=1e-30)
    out = 0.0
    for (l0, l1, _, p), ws in zip(states, w):
        out = out + torch.einsum("bgrt,btgd->bgrd", p * ws / den, v[:, l0:l1].float())
    return out.reshape(B, H, D).to(q.dtype)


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
    splits = prefix_plan(B, KVH, valid_len, _sms(q.device.index or 0), H // KVH)
    part = torch.empty((B, H, splits, D + 2), dtype=torch.float32, device=q.device) \
        if splits > 1 else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load_kernels().decode_attention_prefix_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), B, H, KVH, L, D, valid_len, splits,
        q.stride(0), q.stride(1), 1.0 / D ** 0.5, stream,
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
    cache, D in {64, 128}; anything else raises) over `prefix_plan`'s key
    splits; a CPU tensor runs `decode_attention_prefix_ref`."""
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


def _prefix_int8_state(q8, sq, k, k_scale, v, v_scale, mask, bl: int, j0: int, j1: int):
    """Kernel #5's block recurrence over key blocks [j0, j1) from a fresh
    state -> (m, l, acc): q8 (B, KVH, n_rep, D) int8 with its row scales sq.
    Per block: s = int(q8 . k8) * sq * ks * (1/sqrt(D)) plus the mask bias;
    the online softmax (m floored at -5e29); pv = p * vs quantised per row
    of the block; acc = acc * corr + int(p8 . v8) * sp. The integer sums are
    exact (`_int_product`: |sum| <= 127^2 x 256)."""
    B, KVH, n_rep, D = q8.shape
    scale = 1.0 / D ** 0.5
    m = torch.full((B, KVH, n_rep, 1), NEG_INF, device=q8.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, n_rep, D), device=q8.device)
    for j in range(j0, j1):
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
    return m, l, acc


def _prefix_int8_setup(q, k, valid_len: int, block_l: Optional[int]) -> tuple:
    """q quantised per head row, (B, KVH, n_rep, D), its scales, the key
    block and the live block count max(ceil(valid_len / block_l), 1)."""
    B, H, D = q.shape
    L, KVH = k.shape[1], k.shape[2]
    bl = prefix_block_l(L, block_l)
    q8, sq = quantize_rows(q.float().reshape(B, KVH, H // KVH, D))
    return q8, sq, bl, max(-(-valid_len // bl), 1)


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
    mask, through `_prefix_int8_state`'s recurrence. Out = acc / max(l,
    1e-30): a row that sees no key outputs 0."""
    q8, sq, bl, n_blocks = _prefix_int8_setup(q, k, valid_len, block_l)
    _, l, acc = _prefix_int8_state(q8, sq, k, k_scale, v, v_scale, mask, bl, 0, n_blocks)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(q.shape).to(q.dtype)


# kernel #5's CTAs a streaming multiprocessor: ~111 KB of shared memory a
# CTA (csrc/decode_attention_int8.cu), two on the H100's 228 KB
PREFIX_INT8_CTAS_PER_SM = 2


def prefix_int8_plan(B: int, KVH: int, n_blocks: int, sms: int, n_rep: int = 1) -> int:
    """The splits of kernel #5's key blocks: as many as bring the B x KVH
    (batch row, kv head) CTAs up to one wave (PREFIX_INT8_CTAS_PER_SM on
    each of `sms` multiprocessors), at most one a block, at least one; no
    split once B x KVH fills a wave. The CTA serves all n_rep (1, 2, 4 or
    8) query heads of its group whatever their count, so n_rep does not
    change the plan. Llama3-8B's int8 decode step (B 8, KVH 8, L 2304,
    9 blocks) takes 4 splits on 132 SMs; phase 11's diverse_gen (B 10,
    KVH 32: 320 CTAs) and batch 24 (768) one."""
    if n_rep not in (1, 2, 4, 8):
        raise ValueError(f"prefix_int8_plan: n_rep must be 1, 2, 4 or 8; got {n_rep}")
    return max(1, min(n_blocks, PREFIX_INT8_CTAS_PER_SM * sms // (B * KVH)))


def prefix_int8_split_blocks(n_blocks: int, splits: int) -> list:
    """The key blocks [j0, j1) of each split, as the kernel cuts them."""
    return [(s * n_blocks // splits, (s + 1) * n_blocks // splits) for s in range(splits)]


def decode_attention_prefix_int8_split_ref(q, k, k_scale, v, v_scale, mask, valid_len: int,
                                           splits: int, *,
                                           block_l: Optional[int] = None) -> torch.Tensor:
    """Kernel #5 as the card splits it, in fp32 -> (B, H, D) in q's type:
    each split's state (m_s, l_s, acc_s) over its key blocks
    (`prefix_int8_split_blocks`) by `_prefix_int8_state` from a fresh
    running max, then the merge: M = max m_s and out = (sum acc_s e^(m_s -
    M)) / max(sum l_s e^(m_s - M), 1e-30), splits in order. A split starts
    its own running max, so its first blocks quantise p under another max
    than the sequential twin does: p8 can move by one step where a quotient
    lies near a half-integer. A split with no live key has m_s = -5e29, l_s
    = 0, acc_s = 0 and adds nothing; a row masked in every split gives 0. At
    one split this is `decode_attention_prefix_int8_ref` bit for bit."""
    q8, sq, bl, n_blocks = _prefix_int8_setup(q, k, valid_len, block_l)
    if not 1 <= splits <= n_blocks:
        raise ValueError(f"splits must be in [1, {n_blocks}]; got {splits}")
    states = [_prefix_int8_state(q8, sq, k, k_scale, v, v_scale, mask, bl, j0, j1)
              for j0, j1 in prefix_int8_split_blocks(n_blocks, splits)]
    mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
    num, den = 0.0, 0.0
    for m, l, acc in states:
        w = torch.exp(m - mx)
        num, den = num + acc * w, den + l * w
    out = num / torch.clamp_min(den, 1e-30)
    return out.reshape(q.shape).to(q.dtype)


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
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention_prefix_int8 kernel needs a 16-byte aligned cache")
    bl = prefix_block_l(L)
    mask = mask.to(dtype=torch.int32).contiguous()
    splits = prefix_int8_plan(B, KVH, max(-(-valid_len // bl), 1), _sms(q.device.index or 0),
                              H // KVH)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    part = torch.empty((B, H, splits, D + 2), dtype=torch.float32, device=q.device) \
        if splits > 1 else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load_kernels().decode_attention_prefix_int8_bf16(
        q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(), v_scale.data_ptr(),
        mask.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(), B, H,
        KVH, L, D, valid_len, bl, splits, q.stride(0), q.stride(1), 1.0 / D ** 0.5, stream,
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
