"""Flash attention forward: hand-written Hopper kernel + plain PyTorch version.

Counterpart of rlaifv_tpu/ops/flash_attention.py (forward only; the
backward comes with the training slice). The kernel lives in
csrc/flash_attention.cu; `flash_attention_ref` is the same function in plain
PyTorch, used for CPU tensors and as the reference the kernel is checked
against on the card.

Semantics (identical to the TPU kernel): fp32 scores and softmax, scale
1/sqrt(D); additive -1e30 masks for key padding and, when causal, for keys
past the query's absolute position q_offset + i; GQA by h // (H // KVH);
a fully masked row outputs 0, and lse = max(m, -5e29) + log(max(l, 1e-30)).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: q (B, Lq, H, D), k/v (B, Lk, KVH, D) ->
    (out (B, Lq, H, D) in q.dtype, lse (B, H, Lq) fp32)."""
    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    n_rep = H // KVH
    qf = q.float().transpose(1, 2)  # (B, H, Lq, D)
    kf = k.float().repeat_interleave(n_rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(n_rep, dim=2).transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / D ** 0.5)
    bias = torch.zeros((B, 1, 1, Lk), dtype=torch.float32, device=q.device)
    if attention_mask is not None:
        bias = torch.where(attention_mask[:, None, None, :] != 0, 0.0, NEG_INF)
    if causal:
        qpos = q_offset + torch.arange(Lq, device=q.device)[:, None]
        kpos = torch.arange(Lk, device=q.device)[None, :]
        bias = bias + torch.where(kpos <= qpos, 0.0, NEG_INF)
    s = s + bias
    m_safe = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
    p = torch.exp(s - m_safe)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p / l, vf).transpose(1, 2).to(q.dtype)
    lse = (m_safe + torch.log(l))[..., 0]
    return out, lse


def _kernel_fwd(q, k, v, attention_mask, causal, q_offset):
    from rlaifv_tpu_torch.ops import _build

    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bf16; {name} is {t.dtype}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention kernel needs {name} with unit stride along D, "
                f"16-byte aligned rows; got strides {t.stride()}"
            )
    if D not in (64, 128):
        raise ValueError(f"flash_attention kernel takes D in (64, 128); got {D}")
    if H % KVH or k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be a non-negative int; got {q_offset!r}")
    if attention_mask is None:
        mask = torch.ones((B, Lk), dtype=torch.int32, device=q.device)
    else:
        mask = attention_mask.to(device=q.device, dtype=torch.int32).contiguous()
        if mask.shape != (B, Lk):
            raise ValueError(f"mask {tuple(mask.shape)} != {(B, Lk)}")
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, KVH, Lq, Lk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), q_offset, 1.0 / D ** 0.5, stream,
    )
    _build.check(err, "flash_attention_fwd_bf16")
    flash_attention.launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    attention_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """q (B, Lq, H, D); k/v (B, Lk, KVH, D) with KVH dividing H ->
    out (B, Lq, H, D), plus lse (B, H, Lq) fp32 when return_lse.

    attention_mask: (B, Lk) key validity (1 = attend). q_offset (int):
    absolute position of q row 0. A CUDA tensor runs the Hopper kernel
    (bf16, D in {64, 128}; anything else raises); a CPU tensor runs
    `flash_attention_ref`. Any Lq/Lk works: the kernel masks ragged tiles
    itself, so the TPU wrapper's 128-padding has no counterpart here.
    """
    if q.is_cuda:
        out, lse = _kernel_fwd(q, k, v, attention_mask, causal, q_offset)
    else:
        out, lse = flash_attention_ref(q, k, v, attention_mask, causal, q_offset)
    return (out, lse) if return_lse else out


flash_attention.launches = 0  # kernel launches (CUDA tensors only)
