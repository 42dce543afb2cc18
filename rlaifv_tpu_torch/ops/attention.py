"""Attention dispatch: hand-written Hopper kernels for CUDA tensors, the
plain PyTorch path otherwise.

Counterpart of rlaifv_tpu/ops/attention.py with the same layouts (q
(B, Lq, H, D); k/v (B, Lk, KVH, D), KVH dividing H) and the same dispatch
rule, with "on TPU" read as "q is a CUDA tensor":

- flash (ops/flash_attention.py) when Lq >= 128, D <= 256, q_offset is None
  or an int, and Lq == Lk or q_offset + Lq == Lk;
- prefix decode (ops/decode_attention.py) when Lq == 1, a mask is given,
  q_offset is not None and Lk % 128 == 0;
- dense otherwise.

In eager PyTorch every cache_index is a Python int, so the geometry
conditions alone keep the generate prefill (Lk = max_len != Lq) and the
short autocheck suffix window (Lq < 128) on the dense path, as on the TPU.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30  # finite -inf stand-in keeps fully-masked rows NaN-free


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, L, KVH, D) -> (B, L, KVH*n_rep, D) duplicating each kv head."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def _build_bias(
    Lq: int,
    Lk: int,
    attention_mask: Optional[torch.Tensor],
    causal: bool,
    q_offset: Optional[int],
    device,
) -> Optional[torch.Tensor]:
    """Additive fp32 bias (B, 1, Lq, Lk) or None when nothing is masked."""
    bias = None
    if causal:
        q_pos = torch.arange(Lq, device=device)[:, None]
        if q_offset is not None:
            q_pos = q_pos + q_offset
        k_pos = torch.arange(Lk, device=device)[None, :]
        bias = torch.where(k_pos <= q_pos, 0.0, _NEG_INF)[None, None]
    if attention_mask is not None:
        pad = torch.where(attention_mask.bool(), 0.0, _NEG_INF)
        pad = pad[:, None, None, :].to(torch.float32)
        bias = pad if bias is None else bias + pad
    return bias


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """Plain attention over already-repeated heads: fp32 scores and softmax,
    probabilities cast to v.dtype for the value product (fp32 sum)."""
    D = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / D ** 0.5)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float()
    )
    return out.to(q.dtype)


def attention_route(*, Lq: int, Lk: int, D: int, q_offset: Optional[int],
                    has_mask: bool, on_cuda: bool, impl: str = "auto") -> str:
    """The path `multi_head_attention` takes: "flash", "decode" or "dense"."""
    if impl != "auto":
        return impl
    if not on_cuda:
        return "dense"
    if Lq >= 128 and D <= 256 and (
            Lq == Lk or (q_offset is not None and q_offset + Lq == Lk)):
        return "flash"
    if (Lq == 1 and q_offset is not None and has_mask and D <= 256
            and Lk % 128 == 0):
        return "decode"
    return "dense"


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    attention_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    q_offset: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Grouped-query attention. Returns (B, Lq, H, D).

    impl: "auto" picks a Hopper kernel for CUDA tensors of a fitting
    geometry and the dense path otherwise; "flash"/"decode"/"dense" force a
    path (a forced kernel on a CPU tensor runs its plain version).
    """
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if q_offset is not None and not isinstance(q_offset, int):
        raise TypeError(f"q_offset must be a Python int; got {type(q_offset)}")
    route = attention_route(Lq=Lq, Lk=Lk, D=D, q_offset=q_offset,
                            has_mask=attention_mask is not None,
                            on_cuda=q.is_cuda, impl=impl)

    if route == "flash":
        from rlaifv_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(
            q, k, v, attention_mask=attention_mask, causal=causal,
            q_offset=q_offset or 0,
        )

    if route == "decode":
        # single-token decode over a static cache: the prefix kernel reads
        # only live columns [0, cache_index] - bytes track the generated
        # length, not max_len
        from rlaifv_tpu_torch.ops.decode_attention import decode_attention_prefix

        out = decode_attention_prefix(
            q[:, 0], k, v, attention_mask, q_offset + 1
        )
        return out[:, None]

    if route != "dense":
        raise ValueError(f"unknown attention impl {impl!r}")
    n_rep = H // k.shape[2]
    bias = _build_bias(Lq, Lk, attention_mask, causal, q_offset, q.device)
    return dense_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep), bias)
