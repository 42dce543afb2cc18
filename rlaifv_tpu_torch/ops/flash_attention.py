"""Flash attention, forward and backward: hand-written Hopper kernels + plain
PyTorch versions.

Counterpart of rlaifv_tpu/ops/flash_attention.py. The kernels live in
csrc/flash_attention.cu (forward) and csrc/flash_attention_bwd.cu (dq and
dk/dv); `flash_attention_ref` and `flash_attention_bwd_ref` are the same
functions in plain PyTorch, used for CPU tensors and as the references the
kernels are checked against on the card. `flash_attention` is
differentiable on both devices through one `torch.autograd.Function`.

Semantics (identical to the TPU kernels): fp32 scores and softmax, scale
1/sqrt(D); additive -1e30 masks for key padding and, when causal, for keys
past the query's absolute position q_offset + i; GQA by h // (H // KVH);
a fully masked row outputs 0, and lse = max(m, -5e29) + log(max(l, 1e-30)).
The backward recomputes p = exp(s + bias - lse) from the saved lse, with
delta = rowsum(dO * O) and ds = p * (dp - delta) * scale, and sums dk/dv
over the query heads of each kv head.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _scores_and_bias(q, k, attention_mask, causal, q_offset):
    """fp32 scaled scores (B, H, Lq, Lk) over repeated kv heads, the
    additive bias, and the repeated fp32 k (B, H, Lk, D)."""
    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(H // KVH, dim=2).transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / D ** 0.5)
    bias = torch.zeros((B, 1, 1, Lk), dtype=torch.float32, device=q.device)
    if attention_mask is not None:
        bias = torch.where(attention_mask[:, None, None, :] != 0, 0.0, NEG_INF)
    if causal:
        qpos = q_offset + torch.arange(Lq, device=q.device)[:, None]
        kpos = torch.arange(Lk, device=q.device)[None, :]
        bias = bias + torch.where(kpos <= qpos, 0.0, NEG_INF)
    return s, bias, kf


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
    n_rep = q.shape[2] // k.shape[2]
    s, bias, _ = _scores_and_bias(q, k, attention_mask, causal, q_offset)
    vf = v.float().repeat_interleave(n_rep, dim=2).transpose(1, 2)
    s = s + bias
    m_safe = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
    p = torch.exp(s - m_safe)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p / l, vf).transpose(1, 2).to(q.dtype)
    lse = (m_safe + torch.log(l))[..., 0]
    return out, lse


def flash_attention_bwd_ref(q, k, v, attention_mask, out, lse, do,
                            causal: bool = True, q_offset: int = 0):
    """Plain backward with the TPU kernels' formulas: (dq, dk, dv) in the
    dtypes of q, k, v. lse (B, H, Lq) is the forward's; out/do (B, Lq, H, D)."""
    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    n_rep = H // KVH
    scale = 1.0 / D ** 0.5
    s, bias, kf = _scores_and_bias(q, k, attention_mask, causal, q_offset)
    p = torch.exp(s + bias - lse[..., None])
    qf = q.float().transpose(1, 2)
    vf = v.float().repeat_interleave(n_rep, dim=2).transpose(1, 2)
    dof = do.float().transpose(1, 2)
    delta = (dof * out.float().transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = dk.view(B, KVH, n_rep, Lk, D).sum(2)
    dv = dv.view(B, KVH, n_rep, Lk, D).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _check_operands(B, Lk, D, H, KVH, q_offset, **tensors):
    for name, t in tensors.items():
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
    k, v = tensors["k"], tensors["v"]
    if H % KVH or k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"bad shapes q {tuple(tensors['q'].shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be a non-negative int; got {q_offset!r}")


def _int_mask(attention_mask, B, Lk, device):
    if attention_mask is None:
        return torch.ones((B, Lk), dtype=torch.int32, device=device)
    mask = attention_mask.to(device=device, dtype=torch.int32).contiguous()
    if mask.shape != (B, Lk):
        raise ValueError(f"mask {tuple(mask.shape)} != {(B, Lk)}")
    return mask


def _kernel_fwd(q, k, v, attention_mask, causal, q_offset):
    from rlaifv_tpu_torch.ops import _build

    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    _check_operands(B, Lk, D, H, KVH, q_offset, q=q, k=k, v=v)
    mask = _int_mask(attention_mask, B, Lk, q.device)
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


def bwd_delta(out, do):
    """delta = rowsum(dO * O), (B, H, Lq) fp32 contiguous: an XLA fusion
    outside the Pallas kernels on the TPU, a torch reduction here."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_args(q, k, v, mask, do, lse, delta, causal, q_offset):
    """The C arguments of both backward entry points before and after their
    outputs, checked: mask (B, Lk) int32, lse and delta (B, H, Lq) fp32,
    all contiguous; dO like q."""
    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    _check_operands(B, Lk, D, H, KVH, q_offset, q=q, k=k, v=v, do=do)
    for name, t, shape, dtype in (("do", do, q.shape, torch.bfloat16),
                                  ("mask", mask, (B, Lk), torch.int32),
                                  ("lse", lse, (B, H, Lq), torch.float32),
                                  ("delta", delta, (B, H, Lq), torch.float32)):
        if t.shape != shape or t.dtype != dtype or \
                (name != "do" and not t.is_contiguous()):
            raise ValueError(f"flash backward: {name} must be {tuple(shape)} "
                             f"{dtype}, contiguous; got {tuple(t.shape)} {t.dtype}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    rest = (B, H, KVH, Lq, Lk, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], int(causal), q_offset,
            1.0 / D ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    return ptrs, rest


def _kernel_bwd_dq(q, k, v, mask, do, lse, delta, causal, q_offset):
    """dq (B, Lq, H, D) bf16 from the dq kernel (operands as `_bwd_args`)."""
    from rlaifv_tpu_torch.ops import _build

    ptrs, rest = _bwd_args(q, k, v, mask, do, lse, delta, causal, q_offset)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _build.load_kernels().flash_attention_bwd_dq_bf16(
        *ptrs, dq.data_ptr(), *rest)
    _build.check(err, "flash_attention_bwd_dq_bf16")
    flash_attention_bwd.dq_launches += 1
    return dq


def _kernel_bwd_dkv(q, k, v, mask, do, lse, delta, causal, q_offset):
    """(dk, dv) (B, Lk, KVH, D) bf16 from the dk/dv kernel."""
    from rlaifv_tpu_torch.ops import _build

    ptrs, rest = _bwd_args(q, k, v, mask, do, lse, delta, causal, q_offset)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _build.load_kernels().flash_attention_bwd_dkv_bf16(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *rest)
    _build.check(err, "flash_attention_bwd_dkv_bf16")
    flash_attention_bwd.dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, attention_mask, out, lse, do,
                        causal: bool = True, q_offset: int = 0):
    """(dq, dk, dv) of `flash_attention` from its saved output and lse: the
    two Hopper kernels for CUDA tensors (bf16, D in {64, 128}; anything else
    raises), `flash_attention_bwd_ref` for CPU tensors."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, attention_mask, out, lse, do,
                                       causal, q_offset)
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} != q {tuple(q.shape)}")
    do = do.contiguous()  # autograd hands over any strides
    args = (q, k, v, _int_mask(attention_mask, k.shape[0], k.shape[1], q.device),
            do, lse.float().contiguous(), bwd_delta(out, do), causal, q_offset)
    # dq, then dk/dv: no atomics, so reruns give the same bits
    return (_kernel_bwd_dq(*args), *_kernel_bwd_dkv(*args))


flash_attention_bwd.dq_launches = 0  # dq kernel launches (CUDA tensors only)
flash_attention_bwd.dkv_launches = 0  # dk/dv kernel launches


def _forward(q, k, v, attention_mask, causal, q_offset):
    if q.is_cuda:
        return _kernel_fwd(q, k, v, attention_mask, causal, q_offset)
    return flash_attention_ref(q, k, v, attention_mask, causal, q_offset)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, attention_mask, causal, q_offset):
        out, lse = _forward(q, k, v, attention_mask, causal, q_offset)
        ctx.save_for_backward(q, k, v, attention_mask, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, attention_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, attention_mask, out, lse,
                                         dout, ctx.causal, ctx.q_offset)
        return dq, dk, dv, None, None, None


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
    absolute position of q row 0. A CUDA tensor runs the Hopper kernels
    (bf16, D in {64, 128}; anything else raises); a CPU tensor runs the
    plain versions. Any Lq/Lk works: the kernels mask ragged tiles
    themselves, so the TPU wrapper's 128-padding has no counterpart here.
    Differentiable in q, k and v when autograd records.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, attention_mask, causal, q_offset)
    else:
        out, lse = _forward(q, k, v, attention_mask, causal, q_offset)
    return (out, lse) if return_lse else out


flash_attention.launches = 0  # forward kernel launches (CUDA tensors only)
