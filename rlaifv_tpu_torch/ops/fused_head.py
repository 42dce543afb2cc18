"""Fused LM head: target-token log-probabilities without the (M, V) logits.

Counterpart of rlaifv_tpu/ops/fused_head.py. The kernels live in
csrc/fused_head.cu: one forward (the TPU's `_fwd_kernel` and
`_fwd_kernel_hblocked`; the H contraction is the kernel's inner loop at any
H), `dx` and `dW` (`_bwd_dx_kernel`, `_bwd_dw_kernel`), which recompute the
scores from the saved row logsumexp. `target_logp_plain`,
`fused_head_fwd_plain` and `fused_head_bwd_plain` are the same functions in
plain PyTorch, used for CPU tensors and as the kernels' references on the
card. `fused_target_logp` is differentiable on both devices through one
`torch.autograd.Function`.

The weight is the torch (V, H) `lm_head` weight, the JAX kernel's (H, V)
transposed: its rows are the K-major operand of the score product, so the
kernels read it as it lies. Scores are fp32 sums of the input-type
products, never rounded to the input type (the TPU kernels' fp32 MXU
accumulators); the backward rounds dl = g (onehot(y) - p) to the input type
before its products, as `_bwd_dx_kernel` does. Labels must lie in [0, V):
callers pass a safe target (0) at ignored positions and zero those rows.
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 64  # rows, vocabulary columns and H columns of the kernels' tiles


def fused_head_fwd_plain(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, H), w (V, H), y (M,) -> (logp (M,), lse (M,)), both fp32."""
    logits = torch.matmul(x.float(), w.float().T)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, y[:, None].long())[:, 0]
    return tgt - lse, lse


def target_logp_plain(hidden: torch.Tensor, w: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """(..., H) hidden, (V, H) weight, (...,) labels -> (...,) fp32
    log p(labels) = logit[label] - logsumexp(logits), the logits in fp32.
    (The JAX `target_logp_xla` rounds the logits to the activation dtype
    first; in fp32 the two are the same function.)"""
    logp, _ = fused_head_fwd_plain(hidden.reshape(-1, hidden.shape[-1]), w,
                                   labels.reshape(-1))
    return logp.reshape(labels.shape)


def fused_head_bwd_plain(x, w, y, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx (M, H) in x's dtype, dW (V, H) in w's dtype) of sum(g * logp):
    dl = g (onehot(y) - exp(s - lse)), rounded to x's dtype, then dl W and
    dl^T x with fp32 sums."""
    s = torch.matmul(x.float(), w.float().T)
    onehot = torch.zeros_like(s).scatter_(1, y[:, None].long(), 1.0)
    dl = g.float()[:, None] * (onehot - torch.exp(s - lse.float()[:, None]))
    dl = dl.to(x.dtype).float()
    dx = torch.matmul(dl, w.float()).to(x.dtype)
    dw = torch.matmul(dl.T, x.float()).to(w.dtype)
    return dx, dw


def _splits(M: int, V: int, device) -> int:
    """Vocabulary splits so that about two CTAs per SM run (each CTA owns 64
    rows of one split); at most one split per 64-wide vocabulary tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_m = -(-M // BLOCK)
    return max(1, min(-(-V // BLOCK), -(-2 * sms // n_m)))


def _check(x, w, y, **fp32):
    M, H = x.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"fused head kernels take bf16; got x {x.dtype}, w {w.dtype}")
    if w.dim() != 2 or w.shape[1] != H or H % BLOCK:
        raise ValueError(f"fused head kernels need w (V, {H}) and H a multiple of "
                         f"{BLOCK}; got x {tuple(x.shape)}, w {tuple(w.shape)}")
    if y.shape != (M,) or y.dtype != torch.int32:
        raise ValueError(f"labels must be ({M},) int32; got {tuple(y.shape)} {y.dtype}")
    for name, t in fp32.items():
        if t.shape != (M,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({M},) fp32; got {tuple(t.shape)} {t.dtype}")
    for name, t in dict(x=x, w=w, y=y, **fp32).items():
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"fused head kernels need {name} contiguous on {x.device}")


def _kernel_fwd(x, w, y):
    """(logp, lse) from the forward kernel; the vocabulary splits' partial
    (max, sumexp, target) combine here."""
    from rlaifv_tpu_torch.ops import _build

    _check(x, w, y)
    M, H = x.shape
    V = w.shape[0]
    nsplit = _splits(M, V, x.device)
    part = torch.empty((3, nsplit, M), dtype=torch.float32, device=x.device)
    err = _build.load_kernels().fused_head_fwd_bf16(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), part[2].data_ptr(), M, H, V, nsplit,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_head_fwd_bf16")
    fused_target_logp.fwd_launches += 1
    m, s, t = part
    mx = m.amax(dim=0)
    lse = mx + torch.log(torch.clamp((s * torch.exp(m - mx)).sum(dim=0), min=1e-30))
    return t.sum(dim=0) - lse, lse


def _kernel_dx(x, w, y, lse, g):
    """dx (M, H) in x's dtype from the dx kernel: the vocabulary splits'
    fp32 slabs are summed here."""
    from rlaifv_tpu_torch.ops import _build

    _check(x, w, y, lse=lse, g=g)
    M, H = x.shape
    V = w.shape[0]
    nsplit = _splits(M, V, x.device)
    Mpad = -(-M // BLOCK) * BLOCK
    part = torch.empty((nsplit, Mpad, H), dtype=torch.float32, device=x.device)
    err = _build.load_kernels().fused_head_dx_bf16(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), lse.data_ptr(), g.data_ptr(),
        part.data_ptr(), M, H, V, nsplit, Mpad,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_head_dx_bf16")
    fused_target_logp.dx_launches += 1
    return part.sum(dim=0)[:M].to(x.dtype)


def _kernel_dw(x, w, y, lse, g):
    """dW (V, H) in w's dtype from the dW kernel's fp32 slab."""
    from rlaifv_tpu_torch.ops import _build

    _check(x, w, y, lse=lse, g=g)
    M, H = x.shape
    V = w.shape[0]
    Vpad = -(-V // BLOCK) * BLOCK
    dw32 = torch.empty((Vpad, H), dtype=torch.float32, device=x.device)
    err = _build.load_kernels().fused_head_dw_bf16(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dw32.data_ptr(), M, H, V, Vpad,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_head_dw_bf16")
    fused_target_logp.dw_launches += 1
    return dw32[:V].to(w.dtype)


def fused_head_fwd(x, w, y):
    """(logp, lse) (M,) fp32: the forward kernel for CUDA tensors (bf16,
    H a multiple of 64; anything else raises), the plain version on the CPU."""
    if not x.is_cuda:
        return fused_head_fwd_plain(x, w, y)
    return _kernel_fwd(x.contiguous(), w.contiguous(), y.to(torch.int32).contiguous())


def fused_head_bwd(x, w, y, lse, g):
    """(dx, dW) of sum(g * logp) from the saved lse: the dx and dW kernels
    for CUDA tensors, the plain version on the CPU."""
    if not x.is_cuda:
        return fused_head_bwd_plain(x, w, y, lse, g)
    args = (x.contiguous(), w.contiguous(), y.to(torch.int32).contiguous(),
            lse.float().contiguous(), g.float().contiguous())
    # dx, then dW: no atomics, so reruns give the same bits
    return _kernel_dx(*args), _kernel_dw(*args)


class _FusedHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, y):
        logp, lse = fused_head_fwd(x, w, y)
        ctx.save_for_backward(x, w, y, lse)
        return logp

    @staticmethod
    def backward(ctx, g):
        x, w, y, lse = ctx.saved_tensors
        dx, dw = fused_head_bwd(x, w, y, lse, g)
        return dx, dw, None


def fused_target_logp(hidden: torch.Tensor, w: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """hidden (..., H), w (V, H) lm_head weight, labels (...,) ids in
    [0, V) -> (...,) fp32 log p(labels) = logit[label] - logsumexp(logits).

    Differentiable in hidden and w; the (..., V) logits never reach device
    memory on the kernel path. Rows whose label position is masked upstream
    still compute, and the caller zeroes them (the contract of
    get_batch_logps)."""
    batch_shape = hidden.shape[:-1]
    x = hidden.reshape(-1, hidden.shape[-1])
    y = labels.reshape(-1)
    if torch.is_grad_enabled() and (hidden.requires_grad or w.requires_grad):
        logp = _FusedHead.apply(x, w, y)
    else:
        logp = fused_head_fwd(x, w, y)[0]
    return logp.reshape(batch_shape)


fused_target_logp.fwd_launches = 0  # forward kernel launches (CUDA tensors only)
fused_target_logp.dx_launches = 0  # dx kernel launches
fused_target_logp.dw_launches = 0  # dW kernel launches
