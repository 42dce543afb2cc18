"""Fused LM head: target-token log-probabilities without the (M, V) logits.

Counterpart of rlaifv_tpu/ops/fused_head.py. The kernels live in
csrc/fused_head.cu, four epilogues of one TMA + wgmma mainloop (the
source's header says how). The forward (the TPU's `_fwd_kernel` and
`_fwd_kernel_hblocked`; the H contraction is the mainloop at any H) runs
one CTA per (128 rows, vocabulary split): it walks the split's 256-wide
vocabulary tiles with an online (max, sumexp, target) per row, writes the
split's partials, and a small second kernel combines the splits
(`fwd_splits` plans them; `fwd_partials_plain` and `combine_partials` are
the two stages in plain PyTorch). The backward (the TPU's
`_bwd_dx_kernel` and `_bwd_dw_kernel`, both built on `_dl_tile`) walks the
vocabulary in chunks of `vc` columns, in order, and runs three kernels a
chunk:

- dl: the chunk's scores x W_c^T, recomputed once from the saved row
  logsumexp, and from them dl_c = g (onehot(y) - exp(s - lse)), written once
  as an (M, vc) bf16 buffer that every chunk reuses;
- dx: dl_c W_c, summed over the chunks in order (one chunk: bf16 dx straight
  from the kernel's registers; several: an fp32 (M, H) buffer, cast once by
  the last chunk's kernel);
- dW: dl_c^T x, the chunk's rows of dW, each written once (skipped for a
  frozen head).

What bounds them on the card: the forward's product 2 M H V and the
backward's three, at the tensor cores' rate, plus the M vc 2 bytes of dl a
chunk writes once and reads twice. `chunk_width` picks vc so that dl stays
within DL_CHUNK_BYTES: one chunk at the 7B train step's head (M = 2046,
V = 32000: 131 MB), 8192 columns at the QLoRA step's M = 16368. Scratch:
the forward's 3 nsplit M 4 bytes of partials; M vc 2 bytes of dl, plus
M H 4 bytes of fp32 dx when there is more than one chunk.

`target_logp_plain`, `fused_head_fwd_plain` and `fused_head_bwd_plain` are
the functions in plain PyTorch, the kernels' references on the card; on the
CPU the forward takes its plain version and the backward walks the same
chunks with the per-chunk plain versions (`_dl_plain`, `_dx_plain` and an
fp32 product for dW). `fused_target_logp` is differentiable on both devices
through one `torch.autograd.Function`.

The weight is the torch (V, H) `lm_head` weight, the JAX kernel's (H, V)
transposed; the kernels read it, x and dl as they lie. Scores are fp32 sums
of the input-type products, never rounded to the input type (the TPU
kernels' fp32 MXU accumulators); the backward rounds dl to the input type
before its products, as `_bwd_dx_kernel` does. Labels must lie in [0, V):
callers pass a safe target (0) at ignored positions and zero those rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

BLOCK = 64  # H is a multiple of this: one 128-byte row of bf16, a stage's depth
ROW_TILE = 128  # rows of a forward CTA
VOCAB_TILE = 256  # vocabulary columns of a forward score tile
# the backward's dl chunk (M x vc bf16) stays within this many bytes
DL_CHUNK_BYTES = 256 * 2 ** 20
# vc is a multiple of this: the dW kernel's tile over the vocabulary
VC_ALIGN = 128
FIRST, LAST = 1, 2  # a chunk's place in the walk, for the dx product


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


def fwd_splits(M: int, V: int, sms: int) -> int:
    """The forward's vocabulary splits for M rows on `sms` SMs. A CTA owns
    128 rows (n_m row tiles in all) and one split, and walks the split's
    256-wide vocabulary tiles; one CTA fits an SM (~197 KB of ring). The
    rule: sms // n_m splits, so that one wave of CTAs fills the card (M
    2046: 16 row tiles x 8 splits, 128 CTAs of 15-16 tiles; 9 splits would
    start a second, nearly empty wave), but at least two (M 16363: 128 row
    tiles x 2 splits, two waves of 62-63 tiles a CTA), and never more
    splits than vocabulary tiles. Measured on an H100 (PERF.md,
    tools/head_splits.py): at M 2046 8 splits beat 4, 9 and 16; at M 16363
    2 beat 1, 3, 4 and 8."""
    n_m, n_v = -(-M // ROW_TILE), -(-V // VOCAB_TILE)
    return max(1, min(n_v, max(2, sms // n_m)))


def _split_tiles(split: int, nsplit: int, V: int) -> range:
    """The vocabulary tiles of one split (the kernel's rule)."""
    n_v = -(-V // VOCAB_TILE)
    return range(split * n_v // nsplit, (split + 1) * n_v // nsplit)


def fwd_partials_plain(x, w, y, nsplit: int) -> torch.Tensor:
    """The forward kernel's first stage in plain PyTorch: (3, nsplit, M) fp32
    of each split's row max, sum of exp(s - max) and target logit (0 where
    the label lies in another split), over the split's vocabulary tiles."""
    M, V = x.shape[0], w.shape[0]
    part = torch.empty((3, nsplit, M), dtype=torch.float32, device=x.device)
    for i in range(nsplit):
        tiles = _split_tiles(i, nsplit, V)
        c0, c1 = tiles.start * VOCAB_TILE, min(V, tiles.stop * VOCAB_TILE)
        s = torch.matmul(x.float(), w[c0:c1].float().T)
        m = s.amax(dim=-1)
        part[0, i] = m
        part[1, i] = torch.exp(s - m[:, None]).sum(dim=-1)
        inside = (y.long() >= c0) & (y.long() < c1)
        at = torch.clamp(y.long() - c0, 0, c1 - c0 - 1)
        part[2, i] = torch.where(inside, torch.gather(s, 1, at[:, None])[:, 0], 0.0)
    return part


def combine_partials(part: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's second stage in plain PyTorch: (logp, lse) (M,)
    from (3, nsplit, M) partials, lse = max + log(max(sum, 1e-30)) as the
    TPU kernels."""
    m, s, t = part
    mx = m.amax(dim=0)
    lse = mx + torch.log(torch.clamp((s * torch.exp(m - mx)).sum(dim=0), min=1e-30))
    return t.sum(dim=0) - lse, lse


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
    """(logp, lse) from the forward kernels: the split tiles' partials, then
    their combine (two launches)."""
    from rlaifv_tpu_torch.ops import _build

    _check(x, w, y)
    M, H = x.shape
    V = w.shape[0]
    nsplit = fwd_splits(M, V, torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty((3, nsplit, M), dtype=torch.float32, device=x.device)
    logp, lse = torch.empty((2, M), dtype=torch.float32, device=x.device)
    err = _build.load_kernels().fused_head_fwd_bf16(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(), logp.data_ptr(),
        lse.data_ptr(), M, H, V, nsplit, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_head_fwd_bf16")
    fused_target_logp.fwd_launches += 1
    return logp, lse


def chunk_width(M: int, V: int) -> int:
    """The backward's vocabulary chunk: the largest multiple of VC_ALIGN
    whose dl (M x vc bf16) fits in DL_CHUNK_BYTES, at most V rounded up to
    VC_ALIGN, at least VC_ALIGN."""
    vc = DL_CHUNK_BYTES // (2 * M) // VC_ALIGN * VC_ALIGN
    return max(VC_ALIGN, min(vc, -(-V // VC_ALIGN) * VC_ALIGN))


def _dl_plain(x, w_c, y, lse, g, c0: int) -> torch.Tensor:
    """dl (M, vw) of the chunk whose rows of the head are w_c (vw, H) and
    whose first vocabulary column is c0, in x's dtype."""
    s = torch.matmul(x.float(), w_c.float().T)
    cols = torch.arange(c0, c0 + w_c.shape[0], device=x.device)
    onehot = (y.long()[:, None] == cols).float()
    return (g.float()[:, None] * (onehot - torch.exp(s - lse.float()[:, None]))).to(x.dtype)


def _dx_plain(dl_c, w_c, dx32, dx, mode: int) -> None:
    """The chunk's dl_c w_c in fp32, after the earlier chunks' sum in dx32
    (not FIRST), into dx32 or, for the LAST chunk, into dx (its dtype)."""
    part = torch.matmul(dl_c.float(), w_c.float())
    if not mode & FIRST:
        part = dx32 + part
    (dx if mode & LAST else dx32).copy_(part)


def _kernel_dl(x, w, y, lse, g, dl, c0: int, vw: int) -> None:
    """The dl kernel: columns [0, vw) of dl (M, vc) for the chunk at c0."""
    from rlaifv_tpu_torch.ops import _build

    M, H = x.shape
    err = _build.load_kernels().fused_head_dl_bf16(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dl.data_ptr(), M, H, w.shape[0], c0, vw, dl.shape[1],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_head_dl_bf16")
    fused_target_logp.dl_launches += 1


def _kernel_dx(dl, w, dx32, dx, c0: int, vw: int, mode: int) -> None:
    """The dx product of the chunk at c0 (see _dx_plain); dx32 may be None
    for a single chunk (mode FIRST | LAST)."""
    from rlaifv_tpu_torch.ops import _build

    M, H = dx.shape
    err = _build.load_kernels().fused_head_dx_bf16(
        dl.data_ptr(), w.data_ptr(), None if dx32 is None else dx32.data_ptr(),
        dx.data_ptr(), M, H, w.shape[0], c0, vw, dl.shape[1], mode,
        torch.cuda.current_stream(dx.device).cuda_stream)
    _build.check(err, "fused_head_dx_bf16")
    fused_target_logp.dx_launches += 1


def _kernel_dw(dl, x, dw_c, vw: int) -> None:
    """The dW product of one chunk: dw_c (vw, H) = dl[:, :vw]^T x."""
    from rlaifv_tpu_torch.ops import _build

    M, H = x.shape
    err = _build.load_kernels().fused_head_dw_bf16(
        dl.data_ptr(), x.data_ptr(), dw_c.data_ptr(), M, H, vw, dl.shape[1],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_head_dw_bf16")
    fused_target_logp.dw_launches += 1


def fused_head_fwd(x, w, y):
    """(logp, lse) (M,) fp32: the forward kernel for CUDA tensors (bf16,
    H a multiple of 64; anything else raises), the plain version on the CPU."""
    if not x.is_cuda:
        return fused_head_fwd_plain(x, w, y)
    return _kernel_fwd(x.contiguous(), w.contiguous(), y.to(torch.int32).contiguous())


def fused_head_bwd(x, w, y, lse, g, need_dw: bool = True, *, vc: Optional[int] = None):
    """(dx, dW) of sum(g * logp) from the saved lse, walking the vocabulary
    in chunks of vc columns (`chunk_width` unless given; a multiple of
    VC_ALIGN): per chunk, dl, then its share of dx and its rows of dW. The
    kernels for CUDA tensors, the per-chunk plain versions on the CPU.
    need_dw=False (a frozen head, as under LoRA) returns dW None and runs
    no dW product."""
    M = x.shape[0]
    V = w.shape[0]
    vc = chunk_width(M, V) if vc is None else vc
    if vc <= 0 or vc % VC_ALIGN:
        raise ValueError(f"the vocabulary chunk must be a positive multiple of {VC_ALIGN}; "
                         f"got {vc}")
    cuda = x.is_cuda
    if cuda:
        x, w, y = x.contiguous(), w.contiguous(), y.to(torch.int32).contiguous()
        lse, g = lse.float().contiguous(), g.float().contiguous()
        _check(x, w, y, lse=lse, g=g)
    dl = x.new_empty((M, vc))  # one chunk's dl, reused by every chunk
    dx = torch.empty_like(x)
    dx32 = x.new_empty(x.shape, dtype=torch.float32) if V > vc else None
    dw = torch.empty_like(w) if need_dw else None
    starts = range(0, V, vc)
    for i, c0 in enumerate(starts):
        vw = min(vc, V - c0)
        mode = (FIRST if i == 0 else 0) | (LAST if i == len(starts) - 1 else 0)
        # one stream, in chunk order: no atomics, so reruns give the same bits
        if cuda:
            _kernel_dl(x, w, y, lse, g, dl, c0, vw)
            _kernel_dx(dl, w, dx32, dx, c0, vw, mode)
            if need_dw:
                _kernel_dw(dl, x, dw[c0:c0 + vw], vw)
            continue
        w_c, dl_c = w[c0:c0 + vw], dl[:, :vw]
        dl_c.copy_(_dl_plain(x, w_c, y, lse, g, c0))
        _dx_plain(dl_c, w_c, dx32, dx, mode)
        if need_dw:
            dw[c0:c0 + vw] = torch.matmul(dl_c.float().T, x.float())
    return dx, dw


class _FusedHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, y):
        logp, lse = fused_head_fwd(x, w, y)
        ctx.save_for_backward(x, w, y, lse)
        return logp

    @staticmethod
    def backward(ctx, g):
        x, w, y, lse = ctx.saved_tensors
        dx, dw = fused_head_bwd(x, w, y, lse, g, need_dw=ctx.needs_input_grad[1])
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


fused_target_logp.fwd_launches = 0  # forward calls on the card (two kernels each)
fused_target_logp.dl_launches = 0  # dl kernel launches (one a chunk)
fused_target_logp.dx_launches = 0  # dx product launches (one a chunk)
fused_target_logp.dw_launches = 0  # dW product launches (one a chunk)
