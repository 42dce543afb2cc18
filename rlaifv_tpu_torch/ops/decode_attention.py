"""Prefix decode attention: hand-written Hopper kernel + plain PyTorch version.

Counterpart of rlaifv_tpu/ops/decode_attention.py::decode_attention_prefix:
one query token per head over a static (B, L, KVH, D) cache, reading only
the live columns [0, valid_len). The kernel lives in
csrc/decode_attention.cu; `decode_attention_prefix_ref` is the plain
version, used for CPU tensors and as the kernel's reference on the card.

`valid_len` is a host int (the engine's cache_index + 1): the kernel's
read range is fixed at launch, with no device scalar to fetch.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_prefix_ref(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, L, KVH, D)
    v: torch.Tensor,  # (B, L, KVH, D)
    mask: torch.Tensor,  # (B, L) key validity
    valid_len: int,
) -> torch.Tensor:
    """Plain version in fp32 over columns [0, valid_len) -> (B, H, D)."""
    B, H, D = q.shape
    KVH = k.shape[2]
    n_rep = H // KVH
    kf = k[:, :valid_len].float()  # (B, T, KVH, D)
    vf = v[:, :valid_len].float()
    qf = q.float().reshape(B, KVH, n_rep, D)
    s = torch.einsum("bgrd,btgd->bgrt", qf, kf) * (1.0 / D ** 0.5)
    s = s + torch.where(mask[:, None, None, :valid_len] != 0, 0.0, NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
    p = torch.exp(s - m)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bgrt,btgd->bgrd", p, vf)
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
