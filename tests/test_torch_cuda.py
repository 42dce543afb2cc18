"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test skips. On the card
(`--noconftest`: tests/conftest.py imports jax, which the port never needs):

    python -m pytest -m cuda tests/test_torch_cuda.py --noconftest -q

bf16 inputs; outputs are checked as |kernel - plain| <= 1e-2 + 1e-2 |plain|
(each side rounds once to bf16, and the flash kernel and the prefix decode
kernel #4 round their probabilities to bf16 for the P.V product; #4 also
against its split twin at the card's plan), lse at 1e-3 abs (fp32). The
backward kernels' dq, dk, dv: max|kernel - plain| <= 2e-2 max|plain| per
gradient (P and dS are rounded to bf16 for the products and the outputs
are bf16: about one bf16 ulp of the largest entry). The fused LM head:
logp and lse within 2e-4 nats (fp32 sums of the same bf16 products in
other orders); dx and dW elementwise within 2^-6 |plain| + 1e-5 max|plain|
(both round dl to bf16 and the fp32 sums to bf16 once: an ulp or two).
The int8 matmul kernels equal their plain twins bit for bit (exact integer
sums, IEEE quantisation, the same fp32 epilogue), and #7 equals #9, #8
equals #10; so do the int4 kernels #11 and #12 (the groups' fp32 sums in
order, each product and sum rounded separately), #8 and #12 also on
quotients at and next to half-integers (synth.quotient_ties). The int8-cache decode
kernel #5: max|kernel - twin| <= 2^-7 max|twin| (exact integer sums, IEEE
quantisation and unfused fp32 epilogues on both sides; expf against torch's
exp can flip a rounding of p8 by one step, and the output is bf16), held to
the split twin at the key splits the card's plan gives; a rerun is bit-equal.
The prequant kernel #9 equals its twin on both routes, and the prequant
wrappers' row passes equal quantize_rows bit for bit. The
fused decode kernel #16 through 2 layers, held to its twin at the kernel's
plan (the cache blocks cut into the same key splits; forced plans with one
split and with several, and sliced contractions): every row of x_out
within 1e-5 of max|x_out| of its twin and the fresh k/v equal, but for at most
FUSED_FLIP_ROWS(B) rows where a value landed on the other side of a
quantisation step; there every row's x_out stays within FUSED_FLIP_STEPS
int8 steps of that row's scale (max|x_out row| / 127) and the fresh k/v
within FUSED_KV_STEPS steps. The full-cache decode kernel #6: fp32 inputs
within 1e-5 x max(1, max|twin|) of its twin (both in fp32, sums in other
orders, exp2f of log2-scaled scores against torch's exp), bf16 inputs
within the bf16 bound above;
a fully masked row is exactly 0, also when the key axis is split (a split
whose keys are all masked adds nothing to the merge).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from rlaifv_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_prefix,
    decode_attention_prefix_int8,
    decode_attention_prefix_int8_ref,
    decode_attention_prefix_ref,
    decode_attention_ref,
    quantize_kv,
)
from rlaifv_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from rlaifv_tpu_torch.ops.fused_head import (
    fused_head_bwd,
    fused_head_bwd_plain,
    fused_head_fwd,
    fused_head_fwd_plain,
    fused_target_logp,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(g, *shape):
    return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)


def _close(out, ref):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    err = (out - ref).abs() - 1e-2 * ref.abs()
    assert err.max().item() <= 1e-2, err.max().item()


@pytest.mark.parametrize("B,Lq,Lk,H,KVH,D,causal,q_offset", [
    (1, 740, 740, 32, 32, 128, True, 0),     # autocheck prefix
    (2, 1024, 1024, 32, 8, 128, True, 0),    # GQA
    (1, 577, 577, 16, 16, 64, False, 0),     # bidirectional, D=64
    (2, 70, 70, 4, 1, 64, True, 0),          # one ragged tile
    (1, 100, 300, 4, 2, 128, True, 200),     # rectangular suffix window
    # the 128-row query tiles' and 128-key tiles' edges
    (1, 127, 127, 4, 1, 128, True, 0),       # n_rep 4
    (1, 128, 128, 8, 1, 64, True, 0),        # n_rep 8, D 64
    (2, 129, 129, 4, 4, 128, True, 0),
    (1, 255, 255, 8, 2, 64, True, 0),
    (1, 200, 300, 4, 4, 128, True, 100),     # query tiles straddle q_offset
    (2, 129, 255, 8, 1, 128, True, 126),
    (1, 255, 127, 4, 4, 128, False, 0),
    (2, 384, 640, 8, 8, 128, False, 0),      # more key tiles than ring stages
])
def test_flash_kernel_matches_plain(gen, B, Lq, Lk, H, KVH, D, causal, q_offset):
    q, k, v = _randn(gen, B, Lq, H, D), _randn(gen, B, Lk, KVH, D), _randn(gen, B, Lk, KVH, D)
    mask = torch.ones((B, Lk), dtype=torch.int32, device="cuda")
    mask[-1, :7] = 0  # left padding: the first 7 queries of row -1 see nothing
    kw = dict(attention_mask=mask, causal=causal, q_offset=q_offset)
    n0 = flash_attention.launches
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    ref, ref_lse = flash_attention_ref(q, k, v, mask, causal, q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    _close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    if causal and q_offset == 0:
        assert (out[-1, :7] == 0).all()


def test_flash_kernel_takes_strided_views(gen):
    """q/k/v as head-major views (the JAX layout with explicit strides)."""
    B, L, H, D = 1, 200, 4, 64
    qt = _randn(gen, B, H, L, D)
    kt, vt = _randn(gen, B, H, L, D), _randn(gen, B, H, L, D)
    q, k, v = (x.transpose(1, 2) for x in (qt, kt, vt))
    out = flash_attention(q, k, v)
    ref, _ = flash_attention_ref(q, k, v)
    _close(out, ref)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_take_fused_qkv_views(gen, D):
    """q, k, v as views of one fused (B, L, 3, H, D) projection (position
    stride 3 H D, head stride D), through the forward and both backward
    kernels (rank-4 TMA tensor maps take any such strides)."""
    B, L, H = 2, 300, 4
    qkv = _randn(gen, B, L, 3, H, D)
    q, k, v = qkv.unbind(2)
    mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
    mask[1, -30:] = 0
    out, lse = flash_attention(q, k, v, attention_mask=mask, return_lse=True)
    ref, ref_lse = flash_attention_ref(q, k, v, mask)
    _close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    do = _randn(gen, B, L, H, D)
    got = flash_attention_bwd(q, k, v, mask, out, lse, do)
    want = flash_attention_bwd_ref(q, k, v, mask, out, lse, do)
    for a, r in zip(got, want):
        _close_grad(a, r)


def test_flash_kernel_refuses_broadcast_operands(gen):
    """A stride-0 (expanded) dimension has no TMA tensor map: the wrapper
    raises before any launch."""
    q = _randn(gen, 2, 128, 4, 64)
    kv = _randn(gen, 1, 128, 4, 64).expand(2, -1, -1, -1)
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv)


def _close_grad(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


@pytest.mark.parametrize("B,Lq,Lk,H,KVH,D,causal,q_offset", [
    (2, 200, 200, 4, 4, 128, True, 0),     # MHA, ragged last tile
    (2, 256, 256, 8, 2, 128, True, 0),     # GQA, n_rep 4
    (1, 100, 300, 4, 1, 128, True, 200),   # rectangular suffix window
    (1, 150, 150, 4, 4, 64, False, 0),     # bidirectional, D=64
    (2, 70, 70, 4, 2, 64, True, 0),        # one ragged tile
    # the dk/dv kernel's 128-key CTAs and 64-query steps at their edges
    (1, 127, 127, 4, 1, 128, True, 0),     # n_rep 4
    (1, 128, 128, 8, 1, 64, True, 0),      # n_rep 8, D 64
    (2, 129, 129, 4, 4, 128, True, 0),
    (1, 255, 255, 8, 2, 64, True, 0),
    (1, 200, 300, 4, 4, 128, True, 100),   # query tiles straddle q_offset
    (2, 129, 255, 8, 1, 128, True, 126),
    (1, 255, 127, 4, 4, 128, False, 0),
    (2, 577, 577, 16, 16, 64, False, 0),   # more steps than ring stages, ragged rows
    # the dq kernel's 128-row CTAs (two warpgroups of 64) and 64-key steps
    (1, 383, 384, 4, 4, 128, True, 1),     # the last CTA's second warpgroup ragged
    (1, 65, 193, 4, 2, 128, True, 128),    # one row past a warpgroup, a 1-key step
    (2, 300, 640, 8, 2, 128, False, 0),    # 10 key steps through its 4 ring stages
])
def test_flash_bwd_kernels_match_plain(gen, B, Lq, Lk, H, KVH, D, causal, q_offset):
    """dq and dk/dv kernels against flash_attention_bwd_ref on the same
    inputs, with a strided dO; the left-padded row's first queries see no
    key and get dq = 0."""
    q, k, v = _randn(gen, B, Lq, H, D), _randn(gen, B, Lk, KVH, D), _randn(gen, B, Lk, KVH, D)
    mask = torch.ones((B, Lk), dtype=torch.int32, device="cuda")
    mask[-1, :7] = 0
    mask[0, -5:] = 0
    out, lse = flash_attention(q, k, v, attention_mask=mask, causal=causal,
                               q_offset=q_offset, return_lse=True)
    do = _randn(gen, B, H, Lq, D).transpose(1, 2)  # not contiguous
    args = (q, k, v, mask, out, lse, do, causal, q_offset)
    n = (flash_attention_bwd.dq_launches, flash_attention_bwd.dkv_launches)
    got = flash_attention_bwd(*args)
    ref = flash_attention_bwd_ref(*args)
    torch.cuda.synchronize()
    assert (flash_attention_bwd.dq_launches, flash_attention_bwd.dkv_launches) == \
        (n[0] + 1, n[1] + 1)
    for a, r, t in zip(got, ref, (q, k, v)):
        assert a.dtype == torch.bfloat16 and a.shape == t.shape
        _close_grad(a, r)
    if causal and q_offset == 0:
        assert (got[0][-1, :7] == 0).all()
    # no atomics: the same inputs give the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, flash_attention_bwd(*args)))


def test_flash_autograd_on_cuda(gen):
    """flash_attention under autograd on the card: the gradients come from
    the two kernels and match the plain backward."""
    B, L, H, KVH, D = 2, 192, 4, 2, 128
    q, k, v = (_randn(gen, B, L, n, D).requires_grad_() for n in (H, KVH, KVH))
    g = _randn(gen, B, L, H, D)
    mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
    mask[1, -20:] = 0
    n = (flash_attention.launches, flash_attention_bwd.dq_launches)
    out = flash_attention(q, k, v, attention_mask=mask)
    (out.float() * g.float()).sum().backward()
    assert (flash_attention.launches, flash_attention_bwd.dq_launches) == (n[0] + 1, n[1] + 1)
    ref_out, lse = flash_attention_ref(q.detach(), k.detach(), v.detach(), mask)
    ref = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), mask, out.detach(),
                                  lse, g, True, 0)
    for t, r in zip((q, k, v), ref):
        _close_grad(t.grad, r)


@pytest.mark.parametrize("B,L,H,KVH,D,valid_len,splits", [
    *[(10, 896, H, KVH, D, valid_len, None)  # phase 4's shape, the plan's splits
      for H, KVH, D in ((32, 32, 128), (32, 8, 128), (8, 1, 64))
      for valid_len in (1, 129, 640, 896)],
    (8, 2304, 32, 8, 128, 2200, None),  # the bf16 Llama3-8B backend's GQA step
    (8, 512, 32, 8, 128, 384, None),    # the same at phase 13's short prompts
    # forced plans (prefix_plan patched)
    (10, 896, 32, 32, 128, 896, 3),
    (8, 2304, 32, 8, 128, 2200, 1),
    (3, 781, 32, 4, 128, 700, 5),  # n_rep 8, splits off the 16-key tiles
    (3, 333, 8, 8, 64, 300, 7),    # n_rep 1, D 64
    (4, 640, 16, 8, 128, 37, 3),   # splits shorter than a tile
])
def test_decode_kernel_matches_plain_and_skips_dead_columns(gen, monkeypatch, B, L, H, KVH, D,
                                                            valid_len, splits):
    """Kernel #4 against the plain version and the split twin at the
    kernel's plan (or a forced one), 7 b columns of left padding in row b
    (rows padded past valid_len see nothing: exactly 0), NaN in every column
    past valid_len (never read); a rerun gives the same bits; one launch
    counted, the split kernel and (with splits) the merge launched."""
    from rlaifv_tpu_torch.ops import decode_attention as da
    from rlaifv_tpu_torch.ops.quant_matmul import _sms

    if splits is None:
        splits = da.prefix_plan(B, KVH, valid_len, _sms(0), H // KVH)
    else:
        monkeypatch.setattr(da, "prefix_plan", lambda *a: splits)
    q, k, v = _randn(gen, B, H, D), _randn(gen, B, L, KVH, D), _randn(gen, B, L, KVH, D)
    mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    for b in range(B):
        mask[b, 7 * b:valid_len] = 1
    k[:, valid_len:] = float("nan")  # columns past valid_len are never read
    v[:, valid_len:] = float("nan")
    n0 = decode_attention_prefix.launches
    out = decode_attention_prefix(q, k, v, mask, valid_len)
    torch.cuda.synchronize()
    assert decode_attention_prefix.launches == n0 + 1
    _close(out, decode_attention_prefix_ref(q, k, v, mask, valid_len))
    _close(out, da.decode_attention_prefix_split_ref(q, k, v, mask, valid_len, splits))
    assert all((out[b] == 0).all() for b in range(B) if 7 * b >= valid_len)
    assert torch.equal(decode_attention_prefix(q, k, v, mask, valid_len), out)
    assert _kernel_nodes(lambda: decode_attention_prefix(q, k, v, mask, valid_len)) == \
        1 + (splits > 1)


def test_kernels_raise_on_what_they_do_not_take(gen):
    q, k = _randn(gen, 2, 128, 4, 64), _randn(gen, 2, 128, 4, 64)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError):
        flash_attention(q[..., :48], k[..., :48], k[..., :48])
    cache = _randn(gen, 1, 128, 4, 64).expand(3, -1, -1, -1)  # stride-0 batch
    mask = torch.ones((3, 128), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        decode_attention_prefix(_randn(gen, 3, 4, 64), cache, cache, mask, 5)
    with pytest.raises(ValueError):
        decode_attention_prefix(_randn(gen, 3, 4, 64), cache.contiguous(),
                                cache.contiguous(), mask, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,KVH,D", [
    (4, 896, 8, 4, 128),    # run_tpu_checks' shape, n_rep 2
    (8, 2304, 32, 8, 128),  # Llama3 GQA, n_rep 4
    (3, 781, 32, 4, 128),   # n_rep 8, a partial last key tile
    (3, 333, 8, 8, 64),     # D 64
])
def test_full_decode_kernel_matches_twin(gen, dtype, B, L, H, KVH, D):
    """Kernel #6 over every cache column: rows masked from 700 and from 13
    (run_tpu_checks), interior holes, and a fully masked row (exactly 0)."""
    q, k, v = (torch.randn(*s, generator=gen, device="cuda").to(dtype)
               for s in ((B, H, D), (B, L, KVH, D), (B, L, KVH, D)))
    mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
    mask[0, 700:] = 0
    mask[0, 13:40] = 0
    mask[1] = 0
    mask[-1, ::3] = 0
    n0 = decode_attention.launches
    out = decode_attention(q, k, v, mask)
    ref = decode_attention_ref(q, k, v, mask)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1 and out.dtype == dtype
    assert (out[1] == 0).all()
    if dtype == torch.float32:
        assert torch.isfinite(out).all()
        err = (out - ref).abs().max().item()
        assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err
    else:
        _close(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,KVH,D,splits", [
    (3, 1000, 8, 8, 128, 7),   # n_rep 1, L % 7 != 0
    (3, 640, 16, 8, 64, 5),    # n_rep 2, D 64
    (3, 781, 32, 8, 128, 6),   # n_rep 4: 3h's fault case
    (3, 333, 32, 4, 128, 2),   # n_rep 8
    (2, 129, 8, 2, 64, 1),
])
def test_full_decode_kernel_merges_its_key_splits(gen, monkeypatch, dtype, B, L, H, KVH, D,
                                                   splits):
    """Kernel #6 with its key axis split as given (full_plan patched): a
    split whose keys are all masked (row 0's second split) adds nothing, a
    row masked in every split (row 1) is exactly 0; within 3h's bound of
    the plain version and of the split twin; one launch counted, one
    kernel and the merge launched."""
    from rlaifv_tpu_torch.ops import decode_attention as da

    monkeypatch.setattr(da, "full_plan", lambda *a: splits)
    q, k, v = (torch.randn(*s, generator=gen, device="cuda").to(dtype)
               for s in ((B, H, D), (B, L, KVH, D), (B, L, KVH, D)))
    mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
    l0, l1 = da.full_split_ranges(L, splits)[min(1, splits - 1)]
    mask[0, l0:l1] = 0
    mask[1] = 0
    mask[-1, :7] = 0
    n0 = decode_attention.launches
    out = decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1 and (out[1] == 0).all()
    for ref in (decode_attention_ref(q, k, v, mask),
                da.decode_attention_split_ref(q, k, v, mask, splits)):
        if dtype == torch.float32:
            assert torch.isfinite(out).all()
            err = (out - ref).abs().max().item()
            assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err
        else:
            _close(out, ref)


def test_full_decode_kernel_raises_on_what_it_does_not_take(gen):
    q, k = _randn(gen, 2, 8, 64), _randn(gen, 2, 100, 4, 64)
    mask = torch.ones((2, 100), dtype=torch.int32, device="cuda")
    n0 = decode_attention.launches
    with pytest.raises(TypeError):  # mixed types
        decode_attention(q.float(), k, k, mask)
    with pytest.raises(TypeError):
        decode_attention(q.half(), k.half(), k.half(), mask)
    with pytest.raises(ValueError):  # D 48
        decode_attention(q[..., :48], k[..., :48], k[..., :48], mask)
    with pytest.raises(ValueError):  # n_rep 3
        decode_attention(_randn(gen, 2, 12, 64), k, k, mask)
    with pytest.raises(ValueError):  # a strided cache
        decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), k, mask)
    with pytest.raises(ValueError):
        decode_attention(q, k, k, mask[:, :50])
    assert decode_attention.launches == n0


def _int8_cache(gen, B, L, H, KVH, D, valid_len):
    """q, a quantised cache whose scales past the last live block are NaN
    (never read), and a mask with left padding of 7b columns (a row padded
    past valid_len sees nothing)."""
    from rlaifv_tpu_torch.ops.decode_attention import prefix_block_l

    q = _randn(gen, B, H, D)
    kq, ks = quantize_kv(_randn(gen, B, L, KVH, D))
    vq, vs = quantize_kv(_randn(gen, B, L, KVH, D))
    end = -(-valid_len // prefix_block_l(L)) * prefix_block_l(L)
    ks[:, end:], vs[:, end:] = float("nan"), float("nan")
    mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    for b in range(B):
        mask[b, 7 * b:valid_len] = 1
    return q, kq, ks, vq, vs, mask


@pytest.mark.parametrize("B,L,H,KVH,D,valid_len", [
    (10, 896, 32, 32, 128, 860),   # diverse_gen: block 128
    (24, 1024, 32, 32, 128, 960),  # the batch-24 headline: block 256
    (4, 1024, 32, 32, 128, 1),     # one live column
    (4, 1024, 32, 32, 128, 200),   # mid-block
    (4, 1024, 32, 32, 128, 256),   # exactly one block
    (3, 384, 32, 8, 128, 300),     # n_rep 4, L % 256 != 0
    (2, 512, 8, 8, 64, 137),       # D 64
    (8, 2304, 32, 8, 128, 2200),   # the int8 Llama3 backend's GQA step: 4 key splits
    (4, 896, 32, 32, 128, 833),    # greedy_gen: 2 splits of block 128
])
def test_int8_decode_kernel_matches_twin(gen, B, L, H, KVH, D, valid_len):
    """Kernel #5 at its plan's key splits (prefix_int8_plan on this card)
    against the split twin within 2^-7 max|twin| (and the sequential twin
    where it does not split); a rerun gives the same bits, fully masked rows
    give 0; one launch counted, the split kernel and (with splits) the
    merge launched."""
    from rlaifv_tpu_torch.ops import decode_attention as da
    from rlaifv_tpu_torch.ops.quant_matmul import _sms

    args = _int8_cache(gen, B, L, H, KVH, D, valid_len)
    splits = da.prefix_int8_plan(B, KVH, -(-valid_len // da.prefix_block_l(L)), _sms(0),
                                 H // KVH)
    n0 = decode_attention_prefix_int8.launches
    out = decode_attention_prefix_int8(*args, valid_len)
    ref = da.decode_attention_prefix_int8_split_ref(*args, valid_len, splits)
    torch.cuda.synchronize()
    assert decode_attention_prefix_int8.launches == n0 + 1
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -7 * ref.float().abs().max().item(), err
    if splits == 1:
        assert torch.equal(ref, decode_attention_prefix_int8_ref(*args, valid_len))
    dead = [b for b in range(B) if 7 * b >= valid_len]
    assert all((out[b] == 0).all() for b in dead)  # fully masked rows output 0
    assert torch.equal(decode_attention_prefix_int8(*args, valid_len), out)
    assert _kernel_nodes(lambda: decode_attention_prefix_int8(*args, valid_len)) == \
        1 + (splits > 1)


@pytest.mark.parametrize("B,L,H,KVH,D,valid_len,splits", [
    (3, 1280, 8, 8, 128, 1250, 5),   # block 256, n_rep 1
    (3, 640, 16, 4, 64, 640, 3),     # block 128, n_rep 4, D 64
    (3, 640, 8, 1, 64, 577, 5),      # n_rep 8, a partial last block
    (3, 2304, 32, 8, 128, 2200, 9),  # one block a split
])
def test_int8_decode_kernel_merges_its_key_splits(gen, monkeypatch, B, L, H, KVH, D,
                                                  valid_len, splits):
    """Kernel #5 with its key blocks split as given (prefix_int8_plan
    patched): a split whose blocks are all masked (row 0's second) adds
    nothing, a row masked everywhere (row 1) is exactly 0; within 2^-7
    max|twin| of the split twin; a rerun gives the same bits."""
    from rlaifv_tpu_torch.ops import decode_attention as da

    monkeypatch.setattr(da, "prefix_int8_plan", lambda *a: splits)
    q, kq, ks, vq, vs, mask = _int8_cache(gen, B, L, H, KVH, D, valid_len)
    bl = da.prefix_block_l(L)
    mask[:] = 1
    j0, j1 = da.prefix_int8_split_blocks(-(-valid_len // bl), splits)[1]
    mask[0, j0 * bl:j1 * bl] = 0
    mask[1] = 0
    args = (q, kq, ks, vq, vs, mask)
    out = decode_attention_prefix_int8(*args, valid_len)
    ref = da.decode_attention_prefix_int8_split_ref(*args, valid_len, splits)
    torch.cuda.synchronize()
    assert (out[1] == 0).all() and torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -7 * ref.float().abs().max().item(), err
    assert torch.equal(decode_attention_prefix_int8(*args, valid_len), out)


def _kernel_nodes(fn) -> int:
    """The kernels one call of fn() puts on the card: the call captured in
    a CUDA graph (never replayed), its kernel nodes counted through
    libcuda."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    fn()  # builds the kernels and warms the caches outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    kernels = 0
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    graph.reset()
    return kernels


def test_int8_decode_kernel_raises_on_what_it_does_not_take(gen):
    q, kq, ks, vq, vs, mask = _int8_cache(gen, 2, 256, 8, 4, 64, 100)
    with pytest.raises(TypeError):
        decode_attention_prefix_int8(q.float(), kq, ks, vq, vs, mask, 100)
    with pytest.raises(ValueError):
        decode_attention_prefix_int8(q, kq.transpose(1, 2).contiguous().transpose(1, 2),
                                     ks, vq, vs, mask, 100)
    with pytest.raises(ValueError):
        decode_attention_prefix_int8(q, kq, ks, vq, vs, mask, 0)
    with pytest.raises(ValueError):  # L not a multiple of 128
        decode_attention_prefix_int8(q, kq[:, :200].contiguous(), ks[:, :200].contiguous(),
                                     vq[:, :200].contiguous(), vs[:, :200].contiguous(),
                                     mask[:, :200], 100)


def test_tiny_int8_kv_model_decodes_through_kernel_5(gen):
    """A bf16 tiny LLaMA (head dim 64) with int8 weights, fused projections
    and an int8 cache: every decode step launches #5 once a layer and no
    #4; its logits stay within 5% of the same model on attn_impl "dense"
    (the dequantised formula)."""
    from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2, quantize=True,
                           quantize_lm_head=False, fuse_proj=True, kv_cache_dtype="int8",
                           dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    ids = torch.randint(3, 200, (3, 140), generator=gen, device="cuda")
    mask = torch.zeros((3, 256), dtype=torch.int32, device="cuda")
    mask[:, :130] = 1
    outs = []
    for impl in ("auto", "dense"):
        torch.manual_seed(0)  # the same weights for both routes
        model = LlamaForCausalLM(dataclasses.replace(cfg, attn_impl=impl), device="cuda")
        wgen = torch.Generator(device="cuda").manual_seed(1)
        for m in model.modules():
            if hasattr(m, "q"):
                m.q.copy_(torch.randint(-127, 128, m.q.shape, generator=wgen, device="cuda"))
                m.scale.fill_(2e-4)
        cache = model.init_cache(3, 256)
        n4, n5 = decode_attention_prefix.launches, decode_attention_prefix_int8.launches
        with torch.no_grad():
            logits = [model(ids[:, :130], attention_mask=mask, cache=cache, cache_index=0)[0]]
            for t in range(130, 134):
                mask[:, t] = 1
                logits.append(model(ids[:, t:t + 1], attention_mask=mask, cache=cache,
                                    cache_index=t)[0])
        mask[:, 130:] = 0
        if impl == "auto":
            assert decode_attention_prefix.launches == n4
            assert decode_attention_prefix_int8.launches - n5 == 4 * cfg.num_layers
        outs.append(torch.cat([x[:, -1] for x in logits]).float())
    assert torch.isfinite(outs[0]).all()
    rel = ((outs[0] - outs[1]).abs().max() / outs[1].abs().max()).item()
    assert rel <= 0.05, rel


def test_tiny_slice_kernels_match_dense_path(gen):
    """A bf16 tiny LLaVA (head dim 64) on the card: autocheck and greedy
    decoding through the kernels agree with the same model forced dense."""
    import numpy as np

    from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.llama import LlamaAttention, LlamaConfig
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_
    from fake_tokenizer import FakeTokenizer  # tests/ is on sys.path under pytest

    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    cfg = LlavaConfig(
        llm=LlamaConfig.tiny(hidden_size=128, num_heads=2, num_kv_heads=1, **bf16),
        vision=CLIPVisionConfig.tiny(hidden_size=48, **bf16))
    model = init_weights_(LlavaForCausalLM(cfg, device="cuda"), gen).eval()
    g = Llava15Generator(model, FakeTokenizer(), cfg.num_image_tokens,
                         image_size=cfg.vision.image_size)
    S = cfg.vision.image_size
    img = np.random.default_rng(0).integers(0, 255, (S, S, 3), dtype=np.uint8)
    items = [{"question": f"Is object {i} present?", "question_id": i, "image": img}
             for i in range(4)]
    prompts, starts, images = g._prepare(items)
    P = int(starts[0]) + g.num_patches

    def run(impl):
        for m in model.modules():
            if isinstance(m, LlamaAttention):
                m.attn_impl = impl
        logits = g.engine.score_shared_prefix(
            prompts[0][:P], [p[P:] for p in prompts], image=images[0],
            image_start=int(starts[0]), batch_size=4)
        res = g.engine.generate(prompts, images=images, image_starts=starts,
                                max_new_tokens=8)
        return torch.from_numpy(logits), res

    f0, d0 = flash_attention.launches, decode_attention_prefix.launches
    fast_logits, fast = run("auto")
    assert flash_attention.launches > f0 and decode_attention_prefix.launches > d0
    plain_logits, plain = run("dense")
    scale = plain_logits.abs().max().item()
    assert (fast_logits - plain_logits).abs().max().item() <= 5e-2 * scale
    assert np.abs(fast.first_logits - plain.first_logits).max() <= 5e-2 * scale


def test_tiny_beam_search_kernels_match_dense_route(gen):
    """A bf16 tiny LLaVA (head dim 128, n_rep 2) through the beam path on
    the card: the prefill takes #1 and every beam step #4; the recorded
    parents and tokens of 4 steps replayed with attention forced dense give
    log-probs within 5e-2 of max|logp|, and one beam is greedy decoding."""
    import numpy as np

    from rlaifv_tpu_torch.genai import beam
    from rlaifv_tpu_torch.genai.engine import left_pad_batch
    from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.llama import LlamaAttention, LlamaConfig
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_
    from fake_tokenizer import FakeTokenizer  # tests/ is on sys.path under pytest

    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    cfg = LlavaConfig(
        llm=LlamaConfig.tiny(hidden_size=256, num_heads=2, num_kv_heads=1, vocab_size=512,
                             max_position_embeddings=512, **bf16),
        vision=CLIPVisionConfig.tiny(hidden_size=48, **bf16))
    model = init_weights_(LlavaForCausalLM(cfg, device="cuda"), gen).eval()
    g = Llava15Generator(model, FakeTokenizer(), cfg.num_image_tokens,
                         image_size=cfg.vision.image_size)
    eng, K = g.engine, 3
    S = cfg.vision.image_size
    img = np.random.default_rng(0).integers(0, 255, (S, S, 3), dtype=np.uint8)
    items = [{"question": "Describe it." if i % 2 else f"What is object {i} doing here?",
              "question_id": i, "image": img} for i in range(4)]
    prompts, starts, images = g._prepare(items)
    Lp = -(-max(map(len, prompts)) // 64) * 64
    assert Lp >= 128  # the prefill is square and long enough for the flash route
    ids_np, mask_np = left_pad_batch(prompts, eng.pad_id, Lp)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    padded = np.asarray(starts) + Lp - np.asarray([len(p) for p in prompts])
    attn = [m for m in model.modules() if isinstance(m, LlamaAttention)]

    def run(impl, forced=None):
        for m in attn:
            m.attn_impl = impl
        with torch.inference_mode():
            first, cache, cmask = eng._prefill(ids, mask, eng._device_images(images), padded,
                                               -(-(Lp + 8) // 128) * 128, beams=K)
            state, tok0, logp0 = beam.beam_start(first, cache, cmask,
                                                 mask.sum(dim=1).repeat_interleave(K),
                                                 num_beams=K, eos_id=-1)
            if forced:
                state.last_tok = torch.from_numpy(forced[0]).cuda()
            out = [(tok0, logp0)]
            for t in range(1, 5):
                parent, tok, logp = beam.beam_step(eng._step, state, t, Lp=Lp, eos_id=-1,
                                                   pad_id=eng.pad_id,
                                                   forced=forced[t] if forced else None)
                out.append(((parent, tok), logp))
        for m in attn:
            m.attn_impl = "auto"
        return out

    f0, d0 = flash_attention.launches, decode_attention_prefix.launches
    fast = run("auto")
    assert flash_attention.launches - f0 == cfg.llm.num_layers
    assert decode_attention_prefix.launches - d0 == 4 * cfg.llm.num_layers
    plain = run("dense", [fast[0][0]] + [f[0] for f in fast[1:]])
    for (_, a), (_, b) in zip(fast, plain):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 5e-2 * b.abs().max().item()
    one = eng.generate_beam(prompts, images=images, image_starts=starts, num_beams=1,
                            max_new_tokens=8)
    greedy = eng.generate(prompts, images=images, image_starts=starts, max_new_tokens=8)
    np.testing.assert_array_equal(one.tokens, greedy.tokens)


def _head_case(gen, M, H, V):
    x = torch.randn(M, H, generator=gen, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(V, H, generator=gen, device="cuda")).to(torch.bfloat16)
    y = torch.randint(0, V, (M,), generator=gen, device="cuda", dtype=torch.int32)
    return x, w, y, torch.randn(M, generator=gen, device="cuda")


def _grad_close(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    bad = (got - ref).abs() - (2 ** -6 * ref.abs() + 1e-5 * ref.abs().max())
    assert bad.max().item() <= 0, bad.max().item()


@pytest.mark.parametrize("vc", [None, 128, 256])  # the planner's; many chunks, ragged last
@pytest.mark.parametrize("M,H,V", [
    (2046, 4096, 32000),  # the 7B train step's head
    (2046, 1024, 32000),  # H <= 2048: the TPU's single-pass row 13
    (130, 4096, 32001),   # ragged rows and one valid column in the last tile
    (77, 128, 300),       # tiny, every edge ragged
    (1, 64, 64),          # one row, one tile
    (300, 256, 1000),     # the forward's edges: V % 256 != 0, M % 128 != 0
    (200, 64, 700),       # H 64: one stage a tile
    (77, 128, 256),       # one vocabulary tile: a single split
])
def test_fused_head_kernels_match_plain(gen, M, H, V, vc):
    x, w, y, g = _head_case(gen, M, H, V)
    logp, lse = fused_head_fwd(x, w, y)
    ref_logp, ref_lse = fused_head_fwd_plain(x, w, y)
    assert (logp - ref_logp).abs().max().item() <= 2e-4
    assert (lse - ref_lse).abs().max().item() <= 2e-4
    dx, dw = fused_head_bwd(x, w, y, ref_lse, g, vc=vc)
    ref_dx, ref_dw = fused_head_bwd_plain(x, w, y, ref_lse, g)
    assert dx.shape == x.shape and dw.shape == w.shape
    _grad_close(dx, ref_dx)
    _grad_close(dw, ref_dw)
    # no atomics, chunks in order: a rerun gives the same bits
    dx2, dw2 = fused_head_bwd(x, w, y, ref_lse, g, vc=vc)
    assert torch.equal(dx2, dx) and torch.equal(dw2, dw)
    assert torch.equal(fused_head_fwd(x, w, y)[0], logp)


def test_fused_head_frozen_head_runs_no_dw_product(gen):
    """need_dw=False (the QLoRA head): dl and dx once a chunk, no dW."""
    x, w, y, g = _head_case(gen, 300, 256, 1000)
    _, lse = fused_head_fwd_plain(x, w, y)
    n0 = (fused_target_logp.dl_launches, fused_target_logp.dx_launches,
          fused_target_logp.dw_launches)
    dx, dw = fused_head_bwd(x, w, y, lse, g, need_dw=False, vc=256)
    assert dw is None
    assert (fused_target_logp.dl_launches - n0[0], fused_target_logp.dx_launches - n0[1],
            fused_target_logp.dw_launches - n0[2]) == (4, 4, 0)
    _grad_close(dx, fused_head_bwd_plain(x, w, y, lse, g)[0])


def test_fused_head_autograd_counts_its_launches(gen):
    x, w, y, g = _head_case(gen, 300, 256, 1000)
    x.requires_grad_(True)
    w.requires_grad_(True)
    n0 = (fused_target_logp.fwd_launches, fused_target_logp.dl_launches,
          fused_target_logp.dx_launches, fused_target_logp.dw_launches)
    (fused_target_logp(x.view(3, 100, 256), w, y.view(3, 100)).reshape(-1) * g).sum().backward()
    # one vocabulary chunk at this shape: one launch of each kernel
    assert (fused_target_logp.fwd_launches - n0[0], fused_target_logp.dl_launches - n0[1],
            fused_target_logp.dx_launches - n0[2], fused_target_logp.dw_launches - n0[3]
            ) == (1, 1, 1, 1)
    _, lse = fused_head_fwd_plain(x.detach(), w.detach(), y)
    ref_dx, ref_dw = fused_head_bwd_plain(x.detach(), w.detach(), y, lse, g)
    _grad_close(x.grad, ref_dx)
    _grad_close(w.grad, ref_dw)
    with pytest.raises(TypeError):
        fused_head_fwd(x.detach().float(), w.detach(), y)
    with pytest.raises(ValueError):
        fused_head_fwd(x.detach()[:, :100], w.detach()[:, :100], y)


def _int8_case(gen, M, K, N):
    from rlaifv_tpu_torch.models.convert import quantize_kernel_int8_torch

    q, s = quantize_kernel_int8_torch(0.02 * torch.randn(K, N, generator=gen, device="cuda"))
    return _randn(gen, M, K), _randn(gen, M, N), q, s


@pytest.mark.parametrize("M,K,N", [
    (16, 4096, 4096),     # below the crossover: the in-kernel pair's route
    (127, 4096, 11008),   # the 7B MLP widths, one ragged row tile
    (128, 11008, 4096),   # down_proj, at the crossover
    (300, 96, 300),       # ragged rows, contraction and columns
    (5, 40, 24),          # rows not a multiple of 16 bytes: the byte path
    (10, 4096, 12288),    # fused qkv_proj, a decode step of 10 rows
    (24, 4096, 22016),    # fused gate_up_proj, the batch-24 decode step
    (832, 4096, 12288),   # fused qkv_proj, a prefill window
])
def test_int8_kernels_match_plain_bit_for_bit(gen, M, K, N):
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    x, dy, q, s = _int8_case(gen, M, K, N)
    n0 = [f.launches for f in (qm.int8_matmul, qm.int8_matmul_dx,
                               qm.int8_matmul_prequant, qm.int8_matmul_dx_prequant)]
    out, dx = qm.int8_matmul(x, q, s), qm.int8_matmul_dx(dy, q, s)
    outp, dxp = qm.int8_matmul_prequant(x, q, s), qm.int8_matmul_dx_prequant(dy, q, s)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(
        (qm.int8_matmul, qm.int8_matmul_dx, qm.int8_matmul_prequant,
         qm.int8_matmul_dx_prequant), n0)] == [1, 1, 1, 1]
    assert torch.equal(out, qm.int8_matmul_plain(x, q, s))
    assert torch.equal(dx, qm.int8_matmul_dx_plain(dy, q, s))
    assert torch.equal(out, outp) and torch.equal(dx, dxp)
    assert out.shape == (M, N) and dx.shape == (M, K)


def test_int8_autograd_routes_and_quant_dense_on_cuda(gen, monkeypatch):
    """int8_matmul_grad launches #9/#10 from 128 rows, #7/#8 below, no
    kernel on the "dequant" route; QuantDense on the card agrees with its
    CPU formula to bf16 rounding; the weight quantiser gives the CPU's bits."""
    from rlaifv_tpu_torch.models.convert import quantize_kernel_int8_torch
    from rlaifv_tpu_torch.models.llama import QuantDense
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    w = 0.02 * torch.randn(256, 384, generator=gen, device="cuda")
    q, s = quantize_kernel_int8_torch(w)
    q_cpu, s_cpu = quantize_kernel_int8_torch(w.cpu())
    assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)
    for rows, kernels in ((200, (qm.int8_matmul_prequant, qm.int8_matmul_dx_prequant)),
                          (100, (qm.int8_matmul, qm.int8_matmul_dx))):
        x = _randn(gen, rows, 256).requires_grad_(True)
        n0 = [f.launches for f in kernels]
        qm.int8_matmul_grad(x, q, s).float().sum().backward()
        assert [f.launches - n for f, n in zip(kernels, n0)] == [1, 1]
        assert x.grad.dtype == torch.bfloat16
    monkeypatch.setattr(qm, "INT8_LARGE_M_IMPL", "dequant")
    n0 = qm.int8_matmul_prequant.launches
    qm.int8_matmul_grad(_randn(gen, 200, 256), q, s)
    assert qm.int8_matmul_prequant.launches == n0
    monkeypatch.setattr(qm, "INT8_LARGE_M_IMPL", "prequant")

    layer = QuantDense(256, 384, dtype=torch.bfloat16, device="cuda")
    layer.q.copy_(q)
    layer.scale.copy_(s)
    x = _randn(gen, 3, 70, 256)
    got = layer(x).float()
    want = (x.float() @ (q.float() * s)).float()
    assert ((got - want).abs() <= 0.02 * want.abs() + 0.02 * want.abs().max()).all()


@pytest.mark.parametrize("split", [1, 2, 3, 5])
@pytest.mark.parametrize("M,K,N", [
    (1, 4096, 4096), (8, 4096, 6144), (10, 272, 1008), (24, 1040, 4096),
    (63, 4096, 1040), (64, 4096, 11008), (100, 1424, 528), (127, 4096, 11008),
])
def test_int8_fwd_split_kernel_matches_twin(gen, M, K, N, split):
    """Kernel #7's row pass and split product, its K contraction in the
    given slices (ragged K: a short last chunk; N not a multiple of the
    128-column tile; rows at the edges of the 8-row tiles): equal to its
    twin, to #9 and to a rerun bit for bit; one launch counted."""
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    x, _, q, s = _int8_case(gen, M, K, N)
    plan = qm.fwd_plan(M, K, N, 132)._replace(split=min(split, -(-K // 128)))
    assert plan.route == "split"
    n0 = qm.int8_matmul.launches
    got = qm._kernel_fwd(x, q, s, plan)
    torch.cuda.synchronize()
    assert qm.int8_matmul.launches - n0 == 1
    assert torch.equal(got, qm.int8_matmul_plain(x, q, s))
    assert torch.equal(got, qm.int8_matmul_prequant(x, q, s))
    assert torch.equal(qm._kernel_fwd(x, q, s, plan), got)


@pytest.mark.parametrize("M,K,N", [
    (6144, 4096, 11008),  # the 8-pair QLoRA step's prefix, gate/up
    (128, 11008, 4096),   # down_proj at the crossover: 16 tiles
    (129, 272, 1008),     # a ragged row tile, a short last K chunk, a half column tile
    (300, 96, 304),
    (257, 264, 1000),     # rows TMA cannot map: the cp.async route
])
def test_int8_prequant_kernel_routes_match_twin(gen, M, K, N):
    """Kernel #9 on the route fwd_prequant_plan picks and on every route
    the shape allows (the wide tile where TMA can map the rows, the
    cp.async kernel anywhere): equal to its twin, to #7 and to a rerun bit
    for bit; one launch counted and one kernel launched a call."""
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    x, _, q, s = _int8_case(gen, M, K, N)
    xq, sx = qm.quantize_rows(x.float())
    sx = sx.reshape(-1)
    want = qm.int8_matmul_plain(x, q, s)
    plan = qm.fwd_prequant_plan(M, K, N, qm._sms(0))
    assert plan.route == ("wide" if N % 16 == 0 and K % 16 == 0 else "rows")
    routes = [plan] + ([qm.FwdPlan("rows", (128, 128), 1, 1)] if plan.route == "wide" else [])
    for p in routes:
        n0 = qm.int8_matmul_prequant.launches
        got = qm._kernel_prequant(xq, sx, q, s, p)
        torch.cuda.synchronize()
        assert qm.int8_matmul_prequant.launches - n0 == 1
        assert torch.equal(got, want), p.route
        assert torch.equal(qm._kernel_prequant(xq, sx, q, s, p), got)
        assert _kernel_nodes(lambda: qm._kernel_prequant(xq, sx, q, s, p)) == p.launches
    assert torch.equal(qm.int8_matmul(x, q, s), want)


@pytest.mark.parametrize("M,C", [(1, 4096), (127, 4096), (6144, 4096), (200, 1008), (33, 100)])
def test_prequant_wrappers_quantise_rows_on_the_card(gen, M, C):
    """The prequant wrappers' rows on the card (#7's row pass for x, #8's
    for dy * s; C 100 and unaligned rows take #8's pass without a scale)
    equal quantize_rows bit for bit, also on quotients at and next to
    half-integers (synth.quotient_ties); the whole wrapper call launches
    the row pass and its product: two kernels."""
    from rlaifv_tpu_torch.ops import quant_matmul as qm
    from rlaifv_tpu_torch.utils.synth import quotient_ties

    x = _randn(gen, M, C)
    dy, gs = quotient_ties(M, C, 1, seed=M + C)
    dy = torch.from_numpy(dy).cuda().to(torch.bfloat16)
    s = torch.from_numpy(gs[0]).cuda()
    for rows, scale in ((x, None), (dy, None), (dy, s), (x, s)):
        got = qm.quantize_rows_cuda(rows, scale)
        want = qm.quantize_rows(rows.float() if scale is None else rows.float() * scale)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1].reshape(-1))
    xs = _randn(gen, M * C + 1)[1:].view(M, C)  # contiguous, off 16 bytes: #8's pass
    got = qm.quantize_rows_cuda(xs)
    want = qm.quantize_rows(xs.float())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1].reshape(-1))
    if C % 16 == 0:
        q, s2 = _int8_case(gen, 1, C, 256)[2:]
        assert _kernel_nodes(lambda: qm.int8_matmul_prequant(x, q, s2)) == 2
        q, s2 = _int8_case(gen, 1, 256, C)[2:]
        plan = qm.dx_prequant_plan(M, 256, C, qm._sms(0))
        dyx = _randn(gen, M, C)
        assert _kernel_nodes(lambda: qm.int8_matmul_dx_prequant(dyx, q, s2)) == 1 + plan.launches
        assert torch.equal(qm.int8_matmul_dx_prequant(dyx, q, s2), qm.int8_matmul_dx_plain(dyx, q, s2))


def test_int8_kernels_raise_on_what_they_do_not_take(gen):
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    x, dy, q, s = _int8_case(gen, 8, 64, 32)
    # strided activations are taken (copied), a strided weight is not
    xt, dyt = _randn(gen, 64, 200).T, _randn(gen, 32, 200).T
    assert torch.equal(qm.int8_matmul_prequant(xt, q, s), qm.int8_matmul_plain(xt, q, s))
    assert torch.equal(qm.int8_matmul_dx_prequant(dyt, q, s),
                       qm.int8_matmul_dx_plain(dyt, q, s))
    assert torch.equal(qm.int8_matmul(xt, q, s), qm.int8_matmul_plain(xt, q, s))
    with pytest.raises(TypeError):
        qm.int8_matmul(x.float(), q, s)
    with pytest.raises(TypeError):
        qm.int8_matmul(x, q.float(), s)
    with pytest.raises(ValueError):
        qm.int8_matmul(x, q, s.double())
    with pytest.raises(ValueError):
        qm.int8_matmul_dx(dy, q[:, :16], s)


def _int4_case(gen, M, K, N):
    from rlaifv_tpu_torch.models.convert import quantize_int4_torch

    qp, gs = quantize_int4_torch(0.02 * torch.randn(K, N, generator=gen, device="cuda"))
    return _randn(gen, M, K), _randn(gen, M, N), qp, gs


@pytest.mark.parametrize("M,K,N", [
    (16, 4096, 4096),     # q/k/v/o widths, few rows
    (127, 4096, 11008),   # gate/up widths, one ragged row tile
    (300, 11008, 4096),   # down_proj: 86 groups, ragged rows
    (5, 384, 128),        # three groups, one column tile
])
def test_int4_kernels_match_plain_bit_for_bit(gen, M, K, N):
    from rlaifv_tpu_torch.ops import int4_matmul as i4

    x, dy, qp, gs = _int4_case(gen, M, K, N)
    n0 = (i4.int4_matmul.launches, i4.int4_matmul_dx.launches)
    out, dx = i4.int4_matmul(x, qp, gs), i4.int4_matmul_dx(dy, qp, gs)
    torch.cuda.synchronize()
    assert (i4.int4_matmul.launches - n0[0], i4.int4_matmul_dx.launches - n0[1]) == (1, 1)
    assert out.shape == (M, N) and dx.shape == (M, K)
    assert torch.equal(out, i4.int4_matmul_plain(x, qp, gs))
    assert torch.equal(dx, i4.int4_matmul_dx_plain(dy, qp, gs))


@pytest.mark.parametrize("G", [128, 256])
@pytest.mark.parametrize("M", [1, 127, 6144])
def test_int4_forward_kernel_matches_twin_at_groups_of_128_and_256(gen, M, G):
    """Kernel #11 on prequantised rows equals int4_product_plain bit for bit
    at one row, a ragged row tile and the 8-pair step's prefix rows, groups
    of 128 and 256; an xq view off 16 bytes is copied first, a qp off 16
    bytes raises."""
    from rlaifv_tpu_torch.models.convert import quantize_int4_torch
    from rlaifv_tpu_torch.ops import int4_matmul as i4
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    K, N = 4096, 4096
    qp, gs = quantize_int4_torch(0.02 * torch.randn(K, N, generator=gen, device="cuda"), G)
    xq, sx = qm.quantize_rows(_randn(gen, M, K).float())
    want = i4.int4_product_plain(xq, sx, qp, gs).to(torch.bfloat16)
    got = i4._kernel_fwd(xq, sx.reshape(-1), qp, gs)
    odd = torch.empty(xq.numel() + 1, dtype=torch.int8, device="cuda")[1:].view(xq.shape)
    odd.copy_(xq)
    got_odd = i4._kernel_fwd(odd, sx.reshape(-1), qp, gs)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_odd, want)
    odd_qp = torch.empty(qp.numel() + 1, dtype=torch.int8, device="cuda")[1:].view(qp.shape)
    odd_qp.copy_(qp)
    with pytest.raises(ValueError):
        i4._kernel_fwd(xq, sx.reshape(-1), odd_qp, gs)


def test_int4_autograd_routes_and_quant_dense_on_cuda(gen, monkeypatch):
    """int4_matmul_grad launches #11 and, up to INT4_DX_MAX_N output
    columns, #12 (wider ones take the dequant dx); INT4_IMPL "dequant"
    launches neither; QuantDense(bits=4) on the card agrees with its CPU
    formula to the activation quantisation's ~1%; the weight quantiser gives
    the CPU's bits."""
    from rlaifv_tpu_torch.models.convert import quantize_int4_torch
    from rlaifv_tpu_torch.models.llama import QuantDense
    from rlaifv_tpu_torch.ops import int4_matmul as i4

    w = 0.02 * torch.randn(256, 384, generator=gen, device="cuda")
    qp, gs = quantize_int4_torch(w)
    qp_cpu, gs_cpu = quantize_int4_torch(w.cpu())
    assert torch.equal(qp.cpu(), qp_cpu) and torch.equal(gs.cpu(), gs_cpu)
    counters = (i4.int4_matmul, i4.int4_matmul_dx)
    for max_n, want in ((8192, [1, 1]), (256, [1, 0])):
        monkeypatch.setattr(i4, "INT4_DX_MAX_N", max_n)
        x = _randn(gen, 200, 256).requires_grad_(True)
        n0 = [f.launches for f in counters]
        i4.int4_matmul_grad(x, qp, gs).float().sum().backward()
        assert [f.launches - n for f, n in zip(counters, n0)] == want
        assert x.grad.dtype == torch.bfloat16
    monkeypatch.setattr(i4, "INT4_DX_MAX_N", 8192)
    monkeypatch.setattr(i4, "INT4_IMPL", "dequant")
    n0 = [f.launches for f in counters]
    x = _randn(gen, 200, 256).requires_grad_(True)
    i4.int4_matmul_grad(x, qp, gs).float().sum().backward()
    assert [f.launches for f in counters] == n0
    monkeypatch.setattr(i4, "INT4_IMPL", "kernel")

    layer = QuantDense(256, 384, dtype=torch.bfloat16, bits=4, device="cuda")
    layer.q.copy_(qp)
    layer.scale.copy_(gs)
    x = _randn(gen, 3, 70, 256)
    got = layer(x).float()
    want = x.float() @ i4.dequantize_int4(qp, gs)
    assert ((got - want).abs() <= 0.02 * want.abs() + 0.02 * want.abs().max()).all()


def test_int4_kernels_raise_on_what_they_do_not_take(gen):
    from rlaifv_tpu_torch.ops import int4_matmul as i4

    x, dy, qp, gs = _int4_case(gen, 8, 256, 128)
    # strided activations are taken (copied), a strided weight is not
    xt, dyt = _randn(gen, 256, 200).T, _randn(gen, 128, 200).T
    assert torch.equal(i4.int4_matmul(xt, qp, gs), i4.int4_matmul_plain(xt, qp, gs))
    assert torch.equal(i4.int4_matmul_dx(dyt, qp, gs), i4.int4_matmul_dx_plain(dyt, qp, gs))
    with pytest.raises(TypeError):
        i4.int4_matmul(x.float(), qp, gs)
    with pytest.raises(TypeError):
        i4.int4_matmul_dx(dy.half(), qp, gs)
    with pytest.raises(TypeError):
        i4.int4_matmul(x, qp.float(), gs)
    with pytest.raises(ValueError):
        i4.int4_matmul(x, qp, gs.double())
    with pytest.raises(ValueError):  # N not a multiple of 128
        i4.int4_matmul(x, qp[:, :64].contiguous(), gs[:, :64].contiguous())
    _, _, qp2, gs2 = _int4_case(gen, 1, 256, 256)
    with pytest.raises(ValueError):  # a strided weight
        i4.int4_matmul_dx(dy, qp2[:, :128], gs2[:, :128])
    with pytest.raises(ValueError):  # groups of 64 rows
        i4.int4_matmul(x, qp, torch.ones(4, 128, device="cuda"))


# ---------------------------------- #8 and #12: row passes, split and warp-specialised products


def _ties(M, N, J, seed):
    """synth.quotient_ties on the card: bf16 dy (M, N), fp32 scales (J, N)."""
    from rlaifv_tpu_torch.utils.synth import quotient_ties

    dy, gs = quotient_ties(M, N, J, seed=seed)
    return torch.from_numpy(dy).cuda().to(torch.bfloat16), torch.from_numpy(gs).cuda()


@pytest.mark.parametrize("M,K,N", [
    (1, 4096, 11008), (16, 4096, 11008), (63, 4096, 11008), (64, 4096, 11008),
    (127, 4096, 11008),   # one and two 64-row warpgroups, 9 / 5 contraction slices
    (64, 300, 1008),      # ragged output columns and contraction chunks
    (20, 130, 200),       # N % 16 != 0: #10's kernel on the quantised rows
])
def test_int8_dx_kernel_matches_twin_on_ties_and_reruns(gen, M, K, N):
    """Kernel #8 (row pass, split product, sum of the slices) equals its
    twin and #10 bit for bit on Gaussian rows and on quotients at and next
    to half-integers; a rerun gives the same bits; one wrapper call counts
    one launch."""
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    _, dy, q, s = _int8_case(gen, M, K, N)
    tdy, ts = _ties(M, N, 1, seed=M)
    n0 = qm.int8_matmul_dx.launches
    got = qm.int8_matmul_dx(dy, q, s)
    got_ties = qm.int8_matmul_dx(tdy, q, ts[0])
    torch.cuda.synchronize()
    assert qm.int8_matmul_dx.launches - n0 == 2
    assert torch.equal(got, qm.int8_matmul_dx_plain(dy, q, s))
    assert torch.equal(got, qm.int8_matmul_dx_prequant(dy, q, s))
    assert torch.equal(got_ties, qm.int8_matmul_dx_plain(tdy, q, ts[0]))
    assert torch.equal(qm.int8_matmul_dx(dy, q, s), got)


@pytest.mark.parametrize("sms", [1, 132])  # at 1 every case TMA can map takes the wide tile
@pytest.mark.parametrize("N", [1008, 1000])
@pytest.mark.parametrize("K", [255, 256, 257])
@pytest.mark.parametrize("M", [127, 128, 129, 257])
def test_int8_dx_prequant_kernel_matches_twin_at_its_tiles_edges(gen, monkeypatch, M, K, N,
                                                                 sms):
    """Kernel #10 at the edges of its wide tile (128 rows x 256 output
    columns) and 128-byte contraction chunks, on the route its plan picks
    for `sms` streaming multiprocessors (the wide tile, #8's split product,
    or the cp.async kernel where N % 16 != 0): equal to its twin and to #8
    bit for bit, a rerun equal, one launch counted."""
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    monkeypatch.setattr(qm, "_sms", lambda index: sms)
    _, dy, q, s = _int8_case(gen, M, K, N)
    dyq, sy = qm.quantize_rows(dy.float() * s)
    plan = qm.dx_prequant_plan(M, K, N, sms)
    assert plan.route == ("rows" if N % 16 else "wide" if sms == 1 else "split")
    n0 = qm.int8_matmul_dx_prequant.launches
    got = qm._kernel_dx_prequant(dyq, sy.reshape(-1), q)
    torch.cuda.synchronize()
    assert qm.int8_matmul_dx_prequant.launches - n0 == 1
    assert torch.equal(got, qm.int8_matmul_dx_plain(dy, q, s))
    assert torch.equal(got, qm.int8_matmul_dx(dy, q, s))
    assert torch.equal(qm._kernel_dx_prequant(dyq, sy.reshape(-1), q), got)


@pytest.mark.parametrize("M,K,N,route,split", [
    (128, 4096, 4096, "split", 5),     # the crossover: slices and their sum
    (768, 4096, 11008, "split", 1),    # one pair's prefix rows: 6 x 16 wide tiles
    (768, 11008, 4096, "wide", 1),
    (4544, 4096, 11008, "wide", 1),    # the 8-pair step's suffix rows
])
def test_int8_dx_prequant_kernel_routes_at_train_rows(gen, M, K, N, route, split):
    """#10 at QLoRA's row counts on the card's 132 SMs: the planned route,
    equal to its twin bit for bit."""
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    plan = qm.dx_prequant_plan(M, K, N, qm._sms(0))
    assert (plan.route, plan.split) == (route, split)
    _, dy, q, s = _int8_case(gen, M, K, N)
    assert torch.equal(qm.int8_matmul_dx_prequant(dy, q, s), qm.int8_matmul_dx_plain(dy, q, s))


@pytest.mark.parametrize("M,K,N,G", [
    (16, 11008, 4096, 128), (127, 4096, 4096, 128), (128, 11008, 4096, 128),
    (6144, 11008, 4096, 128),   # the 8-pair QLoRA step's down_proj dx
    (200, 1024, 256, 256), (130, 2560, 384, 256),   # groups of 256, a ragged row tile
    (5, 384, 128, 128),         # an odd number of 64-row units
])
def test_int4_dx_kernel_matches_twin_on_ties_and_reruns(gen, M, K, N, G):
    """Kernel #12 (the row-maximum pass, the warp-specialised product with
    the bracketed rounding) equals its twin bit for bit on Gaussian rows
    and on quotients at and next to half-integers, at groups of 128 and
    256; a rerun gives the same bits."""
    from rlaifv_tpu_torch.models.convert import quantize_int4_torch
    from rlaifv_tpu_torch.ops import int4_matmul as i4

    qp, gs = quantize_int4_torch(0.02 * torch.randn(K, N, generator=gen, device="cuda"), G)
    dy = _randn(gen, M, N)
    tdy, tgs = _ties(M, N, K // G, seed=M + G)
    got = i4.int4_matmul_dx(dy, qp, gs)
    got_ties = i4.int4_matmul_dx(tdy, qp, tgs)
    torch.cuda.synchronize()
    assert torch.equal(got, i4.int4_matmul_dx_plain(dy, qp, gs))
    assert torch.equal(got_ties, i4.int4_matmul_dx_plain(tdy, qp, tgs))
    assert torch.equal(i4.int4_matmul_dx(dy, qp, gs), got)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 96), (torch.float32, 128),
                                     (torch.float32, 64)])
def test_attention_outside_the_kernels_domain_runs_dense(gen, dtype, D):
    """On the card a bf16 head dim the kernels do not take (96) and any
    fp32 operands take the dense path, the JAX package's off-TPU formula,
    for a flash geometry and a decode step: no kernel launches, no raise."""
    from rlaifv_tpu_torch.ops.attention import multi_head_attention

    B, L, H, KVH = 2, 256, 4, 2
    q = torch.randn(B, L, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, L, KVH, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, L, KVH, D, generator=gen, device="cuda").to(dtype)
    mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
    n0 = (flash_attention.launches, decode_attention_prefix.launches)
    for kw in (dict(q_offset=0), dict(q_offset=None)):
        out = multi_head_attention(q, k, v, attention_mask=mask, causal=True, **kw)
        want = multi_head_attention(q, k, v, attention_mask=mask, causal=True,
                                    impl="dense", **kw)
        assert out.dtype == dtype and torch.equal(out, want)
    step = multi_head_attention(q[:, :1], k, v, attention_mask=mask, q_offset=200)
    assert torch.equal(step, multi_head_attention(q[:, :1], k, v, attention_mask=mask,
                                                  q_offset=200, impl="dense"))
    assert (flash_attention.launches, decode_attention_prefix.launches) == n0


def test_tiny_fp32_train_step_runs_on_the_card(gen, tmp_path):
    """A tiny fp32 LLaVA with the 7B's head dim (128) and a hidden size at
    which "auto" would pick the fused head in bf16 (2048), on sequences
    long enough for the flash route (>= 128 tokens): two DPO steps on the
    card take the dense attention and the "xla" head (neither launches a
    bf16 kernel, which raised before) and give finite losses."""
    import json as _json

    from rlaifv_tpu_torch.core.config import Config
    from rlaifv_tpu_torch.data.collator import DPOCollator
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_
    from rlaifv_tpu_torch.train.trainer import DPOTrainer, resolve_head
    from rlaifv_tpu_torch.utils.synth import synth_preference_pairs

    cfg = LlavaConfig(
        llm=LlamaConfig.tiny(hidden_size=2048, num_heads=16, num_kv_heads=16,
                             intermediate_size=256, max_position_embeddings=512),
        vision=CLIPVisionConfig.tiny(hidden_size=48))
    assert cfg.llm.dtype == torch.float32
    model = init_weights_(LlavaForCausalLM(cfg, device="cuda"), gen)
    pairs = synth_preference_pairs(cfg, 4, answer_len=150, question_len=16)
    collator = DPOCollator(pad_token_id=0, max_len=256, num_patches=cfg.num_image_tokens)
    config = Config()
    config.training.output_dir = str(tmp_path)
    config.training.max_steps = 2
    config.training.learning_rate = 1e-4
    assert resolve_head(config.training, 2048, torch.float32) == "xla"
    n0 = (flash_attention.launches, fused_target_logp.fwd_launches)
    assert DPOTrainer(config, model, pairs, collator).train() == 2
    assert (flash_attention.launches, fused_target_logp.fwd_launches) == n0
    logged = [_json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    losses = [m["loss"] for m in logged if "loss" in m]
    assert len(losses) == 2 and all(np.isfinite(losses))


# ---------------------------------------------------------------- kernel #16


def _fused_case(gen, bits, D, H, KVH, I, L, B, ci, n_layers=2):
    """A bf16 tiny Llama (head dim 128) quantised to int8 or int4 on the
    card, fused and stacked (ops/fused_decode.py), a random stacked int8
    cache whose scales past the last live block are NaN, a left-padded mask
    live up to ci, x ~ N(0, 0.02)."""
    from rlaifv_tpu_torch.models.convert import (fuse_llm_projections_, quantize_llm_int4,
                                                 quantize_llm_int8)
    from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from rlaifv_tpu_torch.models.llava import init_weights_
    from rlaifv_tpu_torch.ops import fused_decode as fd

    cfg = LlamaConfig(vocab_size=64, hidden_size=D, intermediate_size=I, num_layers=n_layers,
                      num_heads=H, num_kv_heads=KVH, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    model = init_weights_(LlamaForCausalLM(cfg, device="cuda"), gen)
    if bits == 4:
        quantize_llm_int4(model)
    else:
        quantize_llm_int8(model, include_lm_head=False)
    fuse_llm_projections_(model)
    d = fd.default_dims(model.cfg, L)
    stacked = fd.stack_llama_params(model)
    shape = (n_layers, KVH, B, L)
    cache = {}
    for key in ("k", "v"):
        cache[key] = torch.randint(-127, 128, shape + (128,), generator=gen, device="cuda",
                                   dtype=torch.int8)
        sc = 0.01 + 0.02 * torch.rand(shape, generator=gen, device="cuda")
        sc[..., -(-ci // 128) * 128:] = float("nan")
        cache[f"{key}_scale"] = sc
    mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    for b in range(B):
        mask[b, 3 * b:ci + 1] = 1
    x = 0.02 * torch.randn(B, D, generator=gen, device="cuda")
    return stacked, cache, x, mask, ci - torch.arange(B, device="cuda"), ci, d


FUSED_FLIP_STEPS = 8.0
FUSED_KV_STEPS = 1


def FUSED_FLIP_ROWS(B):  # noqa: N802 (a bound, named like the others)
    return max(1, B // 4)


def _fused_broken(out, ref):
    """The bounds kernel #16's output `out` breaks against the twin's `ref`
    (module docstring)."""
    (x_out, kv), (x_ref, kv_ref) = out, ref
    err = (x_out - x_ref).abs().amax(dim=1)
    rows = err > 1e-5 * x_ref.abs().max()
    steps = 0
    for key in ("k", "v"):
        diff = (kv[key].int() - kv_ref[key].int()).abs()
        steps = max(steps, int(diff.max()))
        rows |= (diff != 0).any(dim=3).any(dim=1).any(dim=0)
        rel = (kv[f"{key}_scale"] - kv_ref[f"{key}_scale"]).abs() / kv_ref[f"{key}_scale"]
        rows |= (rel > 1e-5).any(dim=1).any(dim=0)
    row_steps = float((err / (x_ref.abs().amax(dim=1) / 127)).max())
    B = x_out.shape[0]
    return [msg for msg, bad in (
        (f"{int(rows.sum())} rows differ", int(rows.sum()) > FUSED_FLIP_ROWS(B)),
        (f"a row {row_steps:.3g} steps off", not row_steps <= FUSED_FLIP_STEPS),
        (f"k/v {steps} steps apart", steps > FUSED_KV_STEPS)) if bad]


@pytest.mark.parametrize("bits,D,H,KVH,I,L,B,ci,plan", [
    (8, 256, 2, 2, 512, 256, 5, 200, None),  # MHA, one I-block (the card's plan: 2 splits)
    (8, 512, 4, 1, 4096, 384, 3, 300, None),  # n_rep 4, two I-blocks (3 splits)
    (8, 256, 2, 2, 512, 128, 32, 100, None),  # the widest batch (one live block: 1 split)
    (4, 256, 2, 2, 512, 256, 4, 129, None),  # int4, one live column past a block edge
    (4, 256, 2, 2, 4096, 384, 6, 256, None),  # int4, two I-blocks, cache_index on a block edge
    (8, 512, 4, 1, 4096, 384, 3, 300, (1, 1, 1)),  # forced: one split, whole contractions
    (8, 512, 4, 1, 4096, 384, 3, 300, (2, 4, 3)),  # forced: 2 splits, sliced contractions
    (4, 256, 2, 2, 512, 512, 4, 400, (4, 1, 1)),  # int4, forced 4 splits
])
def test_fused_decode_kernel_matches_twin(gen, bits, D, H, KVH, I, L, B, ci, plan):
    """Kernel #16 against fused_decode_step_ref at the kernel's plan (the
    cache blocks cut into the same splits) through 2 layers within the flip
    bounds of the module docstring; one launch a call. `plan` forces
    (attn_splits, qkv_slices, gu_slices) in place of the
    card's own."""
    from unittest import mock

    from rlaifv_tpu_torch.ops import fused_decode as fd

    args = _fused_case(gen, bits, D, H, KVH, I, L, B, ci)
    forced = fd.FusedPlan(*plan) if plan else None
    used = forced or fd.fused_plan(args[-1], B, ci, device="cuda")
    n = fd.fused_decode_step.launches
    with mock.patch.object(fd, "fused_plan", lambda *a, **k: forced) if forced \
            else contextlib.nullcontext():
        out = fd.fused_decode_step(*args)
    ref = fd.fused_decode_step_ref(*args, attn_splits=used.attn_splits)
    torch.cuda.synchronize()
    assert fd.fused_decode_step.launches == n + 1
    assert torch.isfinite(out[0]).all()
    assert not _fused_broken(out, ref), (used, _fused_broken(out, ref))


@pytest.mark.parametrize("fault", ["mask ignored", "fresh column dropped"])
def test_fused_decode_check_catches_a_second_row_tile_fault(gen, fault):
    """The bounds above catch a kernel wrong only in its second 16-row mma
    tile: at B = 32, the twin with `fault` planted on rows 16-31 (rows 0-15
    sound) against the sound kernel."""
    from unittest import mock

    from rlaifv_tpu_torch.ops import fused_decode as fd

    stacked, cache, x, mask, pos, ci, d = _fused_case(gen, 8, 256, 2, 2, 512, 128, 32, 100)
    out = fd.fused_decode_step(stacked, cache, x, mask, pos, ci, d)
    fresh = fd._fresh_column

    def late_rows_lose_fresh(qg, k, v, scale):
        m, l, acc = fresh(qg, k, v, scale)
        m[16:], l[16:], acc[16:] = fd.NEG_INF, 0.0, 0.0
        return m, l, acc

    bad_mask = mask.clone()
    if fault == "mask ignored":
        bad_mask[16:] = 1
    with mock.patch.object(fd, "_fresh_column",
                           late_rows_lose_fresh if fault == "fresh column dropped" else fresh):
        ref = fd.fused_decode_step_ref(stacked, cache, x, bad_mask, pos, ci, d)
    torch.cuda.synchronize()
    assert (ref[0][:16] == fd.fused_decode_step_ref(stacked, cache, x, mask, pos, ci, d)[0][:16]).all()
    assert _fused_broken(out, ref)


def test_fused_decode_kernel_raises_on_what_it_does_not_take(gen):
    from rlaifv_tpu_torch.ops import fused_decode as fd

    stacked, cache, x, mask, pos, ci, d = _fused_case(gen, 8, 256, 2, 2, 512, 256, 3, 100)
    n = fd.fused_decode_step.launches
    with pytest.raises(ValueError, match="cache_index"):  # a device scalar, not a host int
        fd.fused_decode_step(stacked, cache, x, mask, pos, torch.tensor(ci), d)
    with pytest.raises(ValueError, match="cache_index"):
        fd.fused_decode_step(stacked, cache, x, mask, pos, 256, d)
    with pytest.raises(ValueError, match="k must be"):  # a strided cache
        fd.fused_decode_step(stacked, dict(cache, k=cache["k"].transpose(2, 3)), x, mask, pos,
                             ci, d)
    with pytest.raises(ValueError, match="Dh 128"):
        fd.fused_decode_step(stacked, cache, x, mask, pos, ci, dataclasses.replace(d, Dh=64))
    with pytest.raises(ValueError, match="1 <= B"):
        big = x.repeat(11, 1)
        fd.fused_decode_step(stacked, cache, big, mask.repeat(11, 1), pos.repeat(11), ci, d)
    assert fd.fused_decode_step.launches == n


def test_tiny_fused_engine_decodes_through_kernel_16(gen):
    """A bf16 tiny LLaVA (head dim 128) with int8 weights, fused projections
    and an int8 cache through the fused engine: one #16 launch a decode
    step, no #4, #5 or #7; the write-through prefill's logits equal the
    per-layer engine's (the same products and attention) to 1e-3 of
    max|logit|."""
    import numpy as np

    from rlaifv_tpu_torch.genai.engine import DecodeEngine
    from rlaifv_tpu_torch.models.convert import fuse_llm_projections_, quantize_llm_int8, \
        set_llm_config
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_
    from rlaifv_tpu_torch.ops import fused_decode as fd
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    cfg = LlavaConfig.tiny(hidden_size=256, num_heads=2, num_kv_heads=2,
                           dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    engines = []
    for fused in (False, True):
        model = init_weights_(LlavaForCausalLM(cfg, device="cuda"),
                              torch.Generator(device="cuda").manual_seed(0)).eval()
        quantize_llm_int8(model, include_lm_head=False)
        set_llm_config(fuse_llm_projections_(model), kv_cache_dtype="int8")
        engines.append(DecodeEngine(model, eos_id=-1, fused_decode=fused))
    S = cfg.vision.image_size
    images = np.random.default_rng(0).integers(0, 255, (2, S, S, 3), dtype=np.uint8)
    prompts = [list(range(3, 3 + 150)), list(range(5, 5 + 140))]
    kw = dict(images=images, image_starts=[0, 0], max_new_tokens=5)
    counts = lambda: (fd.fused_decode_step.launches, decode_attention_prefix.launches,  # noqa: E731
                      decode_attention_prefix_int8.launches, qm.int8_matmul.launches)
    want = engines[0].generate(prompts, **kw)
    before = counts()
    got = engines[1].generate(prompts, **kw)
    after = counts()
    assert after[0] - before[0] == 4 and after[1:] == before[1:]
    top = np.abs(want.first_logits).max()
    np.testing.assert_allclose(got.first_logits, want.first_logits, rtol=0, atol=1e-3 * top)
    assert got.tokens.shape == want.tokens.shape == (2, 5)


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_bare_llama_backend_runs_its_kernels(gen, fused):
    """A bf16 tiny bare Llama (head dim 128, GQA n_rep 2) through the
    divide-and-conquer backend: bf16 decodes through #4 and no #6; with
    fused_decode (int8 implied) one #16 launch a decode step and no #4,
    #5 or #7. generate_fn returns one string a prompt."""
    import sys
    from pathlib import Path

    from rlaifv_tpu_torch.genai import divide_conquer as dc
    from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from rlaifv_tpu_torch.models.llava import init_weights_
    from rlaifv_tpu_torch.ops import fused_decode as fd
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fake_tokenizer import FakeTokenizer

    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=512, num_heads=4, num_kv_heads=2,
                           intermediate_size=1024, rope_theta=5e5, rms_norm_eps=1e-5,
                           dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = init_weights_(LlamaForCausalLM(cfg, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(0)).eval()
    gen_fn, tmpl = dc.llama3_backend(model, FakeTokenizer(), max_new_tokens=4,
                                     fused_decode=fused)
    gen_fn.engine.eos_id = -1  # decode all 4 tokens
    counts = lambda: (fd.fused_decode_step.launches, decode_attention_prefix.launches,  # noqa: E731
                      decode_attention_prefix_int8.launches, qm.int8_matmul.launches,
                      decode_attention.launches)
    before = counts()
    out = gen_fn([tmpl(dc.divide_messages({"question": "Q?", "answer": a}))
                  for a in ("A cat.", "Two dogs on a mat.")])
    torch.cuda.synchronize()
    d = [a - b for a, b in zip(counts(), before)]
    assert len(out) == 2 and all(isinstance(o, str) for o in out)
    if fused:
        assert d == [3, 0, 0, 0, 0], d
    else:
        assert d[0] == 0 and d[1] == 3 * cfg.num_layers and d[2:] == [0, 0, 0], d


def _continuous_masks(B, L, gt, seed):
    """continuous batching's masks (utils/synth.py): windows ending at gt
    with different starts, finished rows, an empty slot (row 1), and the
    same rolled by a compaction."""
    from rlaifv_tpu_torch.utils.synth import continuous_mask

    return [torch.from_numpy(continuous_mask(B, L, gt, seed=seed, shift=s)).cuda()
            for s in (0, L - 1 - gt)]


@pytest.mark.parametrize("B,L,H,KVH,gt", [(8, 896, 32, 32, 700), (8, 2304, 32, 8, 2000),
                                          (4, 640, 8, 8, 37)])
def test_prefix_kernels_at_continuous_batching_masks(gen, B, L, H, KVH, gt):
    """Kernels #4 and #5 at the masks continuous batching gives them: #4
    within the bf16 bound of its plain version and its split twin at the
    card's plan, #5 within 2^-7 max|twin| of its split twin; the empty slot
    exactly 0."""
    from rlaifv_tpu_torch.ops import decode_attention as da
    from rlaifv_tpu_torch.ops.quant_matmul import _sms

    valid = gt + 1
    for mask in _continuous_masks(B, L, gt, seed=B):
        q, k, v = _randn(gen, B, H, 128), _randn(gen, B, L, KVH, 128), _randn(gen, B, L, KVH, 128)
        k[:, valid:] = float("nan")
        v[:, valid:] = float("nan")
        out = decode_attention_prefix(q, k, v, mask, valid)
        _close(out, decode_attention_prefix_ref(q, k, v, mask, valid))
        splits = da.prefix_plan(B, KVH, valid, _sms(0), H // KVH)
        _close(out, da.decode_attention_prefix_split_ref(q, k, v, mask, valid, splits))
        assert (out[1] == 0).all()
        args = list(_int8_cache(gen, B, L, H, KVH, 128, valid))
        args[5] = mask
        splits = da.prefix_int8_plan(B, KVH, -(-valid // da.prefix_block_l(L)), _sms(0),
                                     H // KVH)
        out = decode_attention_prefix_int8(*args, valid)
        ref = da.decode_attention_prefix_int8_split_ref(*args, valid, splits)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 2 ** -7 * ref.float().abs().max().item(), err
        assert (out[1] == 0).all()


@pytest.mark.parametrize("B,ci", [(4, 200), (8, 300)])
def test_fused_decode_kernel_at_continuous_batching_masks(gen, B, ci):
    """Kernel #16 at continuous batching's masks (an empty slot sees only
    its fresh column) within the flip bounds of its twin at its plan."""
    from rlaifv_tpu_torch.ops import fused_decode as fd

    stacked, cache, x, _, _, _, d = _fused_case(gen, 8, 512, 4, 1, 4096, 384, B, ci)
    for mask in _continuous_masks(B, 384, ci, seed=ci):
        pos = mask.sum(dim=1) - 1
        out = fd.fused_decode_step(stacked, cache, x, mask, pos, ci, d)
        plan = fd.fused_plan(d, B, ci, device="cuda")
        ref = fd.fused_decode_step_ref(stacked, cache, x, mask, pos, ci, d,
                                       attn_splits=plan.attn_splits)
        torch.cuda.synchronize()
        assert torch.isfinite(out[0]).all()
        assert not _fused_broken(out, ref), (plan, _fused_broken(out, ref))


def test_sampler_draws_as_multinomial_on_the_card(gen):
    """genai/sampling.py's exponential race is torch.multinomial's one-sample
    draw on the same generator state, and reads nothing back to the host."""
    import warnings

    from rlaifv_tpu_torch.genai.sampling import SamplingParams, sample_token

    logits = torch.randn(8, 32000, generator=gen, device="cuda") * 3
    sp = SamplingParams.diverse_gen()
    probs = torch.softmax(logits / sp.temperature, dim=-1)
    for seed in range(3):
        want = torch.multinomial(probs, 1, generator=torch.Generator(
            device="cuda").manual_seed(seed))[:, 0]
        g = torch.Generator(device="cuda").manual_seed(seed)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = sample_token(g, logits, sp)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert not [w for w in caught if "called a synchronizing" in str(w.message)]
        assert torch.equal(got, want)


def test_tiny_continuous_engine_runs_its_kernels(gen):
    """A bf16 tiny LLaVA (head dim 128) on the card through a
    ContinuousGenerator with a compaction: #1 once a layer a refill prefill,
    #4 once a layer a decode step; one host sync a chunk, and over the
    whole run (refills included) no other but the first-logit read that
    collect_first_logits asks of each refill prefill; the first logits
    within 5e-2 of max|logit| of generate's (phase 5's bound)."""
    import warnings

    import numpy as np

    from rlaifv_tpu_torch.genai.continuous import ContinuousGenerator
    from rlaifv_tpu_torch.genai.engine import DecodeEngine
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_

    cfg = LlavaConfig.tiny(hidden_size=256, num_heads=2, num_kv_heads=2,
                           dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = init_weights_(LlavaForCausalLM(cfg, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(0)).eval()
    eng = DecodeEngine(model, eos_id=-1)
    S = cfg.vision.image_size
    images = np.random.default_rng(0).integers(0, 255, (5, S, S, 3), dtype=np.uint8)
    prompts = [list(range(3, 3 + n)) for n in (150, 140, 130, 145, 135)]
    kw = dict(images=images, image_starts=[0] * 5, max_new_tokens=40)
    cont = ContinuousGenerator(eng, slots=2, chunk=8, max_new_tokens=40, headroom=8)
    chunk, caught, syncs = ContinuousGenerator._chunk, [], []

    def n_syncs(ws):
        return sum("called a synchronizing" in str(w.message) for w in ws)

    def counted(self, *a):
        n0 = len(caught)
        out = chunk(self, *a)
        syncs.append(n_syncs(caught[n0:]))
        return out

    n = (flash_attention.launches, decode_attention_prefix.launches)
    ContinuousGenerator._chunk = counted
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = cont.run(prompts, images=images, image_starts=[0] * 5,
                               collect_first_logits=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        ContinuousGenerator._chunk = chunk
    st = cont.stats
    assert st["compactions"] >= 1 and syncs == [1] * st["chunks"], (st, syncs)
    assert n_syncs(caught) == st["chunks"] + st["prefills"], (st, n_syncs(caught))
    assert flash_attention.launches - n[0] == cfg.llm.num_layers * st["prefills"]
    assert decode_attention_prefix.launches - n[1] == cfg.llm.num_layers * st["steps"]
    want = eng.generate(prompts, **kw)
    top = np.abs(want.first_logits).max()
    np.testing.assert_allclose(got.first_logits, want.first_logits, rtol=0, atol=5e-2 * top)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("K,N", [(1792, 5376), (1792, 15360), (15360, 1792)])
def test_quant_dense_with_bias_at_eva_rows_matches_twin(gen, bits, K, N):
    """QuantDense with a bias at the EVA02-enormous tower's projections
    (qkv, fc1, fc2) on one 448 px image's rows (M 1025): #9 (int8, one
    launch) or #11 (int4, one launch) plus the bias equal the plain twin
    plus the bias bit for bit."""
    from rlaifv_tpu_torch.models.convert import quantize_int4_torch, quantize_kernel_int8_torch
    from rlaifv_tpu_torch.models.llama import QuantDense
    from rlaifv_tpu_torch.ops import int4_matmul as i4
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    w = 0.02 * torch.randn(K, N, generator=gen, device="cuda")
    layer = QuantDense(K, N, dtype=torch.bfloat16, bits=bits, bias=True,
                       param_dtype=torch.bfloat16, device="cuda")
    layer.q, layer.scale = quantize_int4_torch(w) if bits == 4 else quantize_kernel_int8_torch(w)
    layer.bias.copy_(torch.randn(N, generator=gen, device="cuda"))
    x = _randn(gen, 1, 1025, K)
    counter = i4.int4_matmul if bits == 4 else qm.int8_matmul_prequant
    n0 = counter.launches
    with torch.no_grad():
        got = layer(x)
    torch.cuda.synchronize()
    assert counter.launches - n0 == 1
    plain = i4.int4_matmul_plain if bits == 4 else qm.int8_matmul_plain
    want = plain(x[0], layer.q, layer.scale) + layer.bias.to(torch.bfloat16)
    assert torch.equal(got[0], want)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_tiny_omnilmm_engine_matches_dense_route(gen, mode):
    """A tiny OmniLMM (LM head dim 64, n_rep 2; an EVA tower of head dim 64
    at 28 px, its table re-gridded from a 2 x 2 grid) on the card, in bf16
    and with both towers int8 and an int8 cache: the shared-prefix scores
    and generate's first logits through the kernels (#1 prefill, #4 or #5
    decode steps, #7 / #9 projections) within 5e-2 of max|logit| of the
    same model on attn_impl "dense"; the decode kernel of the mode ran and
    the other did not."""
    import numpy as np

    from rlaifv_tpu_torch.genai.omni_gen import OmniLMMGenerator
    from rlaifv_tpu_torch.models.convert import (quantize_llm_int8, quantize_vision_int8,
                                                 set_llm_config)
    from rlaifv_tpu_torch.models.eva02 import EvaConfig
    from rlaifv_tpu_torch.models.llama import LlamaAttention, LlamaConfig
    from rlaifv_tpu_torch.models.omnilmm import (OmniLMMConfig, OmniLMMForCausalLM,
                                                 init_omnilmm_weights_)
    from rlaifv_tpu_torch.ops import quant_matmul as qm
    from fake_tokenizer import FakeTokenizer  # tests/ is on sys.path under pytest

    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    cfg = OmniLMMConfig(
        llm=LlamaConfig.tiny(hidden_size=256, intermediate_size=256, num_heads=4,
                             num_kv_heads=2, vocab_size=512, **bf16),
        vision=EvaConfig.tiny(image_size=14, embed_dim=128, num_heads=2, mlp_hidden=256,
                              **bf16),
        num_query=4)
    model = init_omnilmm_weights_(OmniLMMForCausalLM(cfg, device="cuda"), gen).eval()
    if mode == "int8":
        quantize_llm_int8(model, include_lm_head=False)
        set_llm_config(quantize_vision_int8(model), kv_cache_dtype="int8")
    g = OmniLMMGenerator(model, FakeTokenizer(), image_size=28)
    img = np.random.default_rng(0).integers(0, 255, (40, 30, 3), dtype=np.uint8)
    items = [{"question": f"Is object {i} present?", "question_id": i, "image": img}
             for i in range(4)]
    prompts, starts, images = g._prepare(items)
    P = int(starts[0]) + g.num_query + 1

    def run(impl):
        for m in model.modules():
            if isinstance(m, LlamaAttention):
                m.attn_impl = impl
        logits = g.engine.score_shared_prefix(
            prompts[0][:P], [p[P:] for p in prompts], image=images[0],
            image_start=int(starts[0]), batch_size=4)
        res = g.engine.generate(prompts, images=images, image_starts=starts, max_new_tokens=6)
        return torch.from_numpy(logits), res

    decode, other = decode_attention_prefix_int8, decode_attention_prefix
    if mode == "bf16":
        decode, other = other, decode
    n = (flash_attention.launches, decode.launches, other.launches,
         qm.int8_matmul.launches + qm.int8_matmul_prequant.launches)
    fast_logits, fast = run("auto")
    assert flash_attention.launches > n[0] and decode.launches > n[1]
    assert other.launches == n[2]
    assert (qm.int8_matmul.launches + qm.int8_matmul_prequant.launches > n[3]) == (mode == "int8")
    set_llm_config(model, kv_cache_dtype="fp")  # the dense route on a bf16 cache
    plain_logits, plain = run("dense")
    scale = plain_logits.abs().max().item()
    assert torch.isfinite(fast_logits).all()
    assert (fast_logits - plain_logits).abs().max().item() <= 5e-2 * scale
    assert np.abs(fast.first_logits - plain.first_logits).max() <= 5e-2 * scale


def test_tiny_minicpmv_int8_engine_matches_dense_route(gen):
    """A tiny MiniCPM-V (LM head dim 64, n_rep 2, 32 queries; a SigLIP tower
    of head dim 8 at 28 px, re-gridded per slice) with int8 LLM
    projections and an int8 cache on the card: a sliced image's span
    groups through the shared-prefix scores and generate's first logits
    (#1 prefill, #5 decode steps, #7 / #9 projections) within 5e-2 of
    max|logit| of the same model on attn_impl "dense" over a bf16 cache;
    #5 ran and #4 did not."""
    import numpy as np

    from rlaifv_tpu_torch.genai.minicpmv_gen import MiniCPMVGenerator
    from rlaifv_tpu_torch.models.convert import quantize_llm_int8, set_llm_config
    from rlaifv_tpu_torch.models.llama import LlamaAttention, LlamaConfig
    from rlaifv_tpu_torch.models.minicpmv import (MiniCPMVConfig, MiniCPMVForCausalLM,
                                                  init_minicpmv_weights_)
    from rlaifv_tpu_torch.models.siglip import SiglipVisionConfig
    from rlaifv_tpu_torch.ops import quant_matmul as qm
    from fake_tokenizer import FakeTokenizer  # tests/ is on sys.path under pytest

    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    cfg = MiniCPMVConfig(
        llm=LlamaConfig.tiny(hidden_size=256, intermediate_size=256, num_heads=4,
                             num_kv_heads=2, vocab_size=512, **bf16),
        vision=SiglipVisionConfig.tiny(**bf16), query_num=32, scale_resolution=28,
        patch_size=7)
    model = init_minicpmv_weights_(MiniCPMVForCausalLM(cfg, device="cuda"), gen).eval()
    quantize_llm_int8(model, include_lm_head=False)
    set_llm_config(model, kv_cache_dtype="int8")
    g = MiniCPMVGenerator(model, FakeTokenizer())
    img = np.random.default_rng(0).integers(0, 255, (90, 60, 3), dtype=np.uint8)
    items = [{"question": f"Is object {i} present?", "question_id": i, "image": img}
             for i in range(4)]
    prompts, feats, starts = g._prepare(items)
    P = g.engine.longest_common_prefix_len(prompts)
    assert starts.shape[1] > 2 and int(starts.max()) + cfg.query_num <= P >= 128

    def run(impl):
        for m in model.modules():
            if isinstance(m, LlamaAttention):
                m.attn_impl = impl
        logits = g.engine.score_shared_prefix(
            prompts[0][:P], [p[P:] for p in prompts], span_features=feats[0],
            span_starts=starts[0], batch_size=4)
        res = g.engine.generate(prompts, span_features=feats, span_starts=starts,
                                max_new_tokens=6)
        return torch.from_numpy(logits), res

    n = (flash_attention.launches, decode_attention_prefix_int8.launches,
         decode_attention_prefix.launches,
         qm.int8_matmul.launches + qm.int8_matmul_prequant.launches)
    fast_logits, fast = run("auto")
    assert flash_attention.launches > n[0] and decode_attention_prefix_int8.launches > n[1]
    assert decode_attention_prefix.launches == n[2]
    assert qm.int8_matmul.launches + qm.int8_matmul_prequant.launches > n[3]
    set_llm_config(model, kv_cache_dtype="fp")  # the dense route on a bf16 cache
    plain_logits, plain = run("dense")
    scale = plain_logits.abs().max().item()
    assert torch.isfinite(fast_logits).all()
    assert (fast_logits - plain_logits).abs().max().item() <= 5e-2 * scale
    assert np.abs(fast.first_logits - plain.first_logits).max() <= 5e-2 * scale


def _tiny_bf16_llava(gen):
    """A tiny LLaVA in bf16 on the card whose LM widths the int4 kernel
    takes (K and N multiples of 128: hidden 256, 4 heads of 64, 2 KV
    heads), random weights from `gen`."""
    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig

    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    cfg = LlavaConfig(llm=LlamaConfig.tiny(hidden_size=256, intermediate_size=256, num_heads=4,
                                           num_kv_heads=2, vocab_size=512, **bf16),
                      vision=CLIPVisionConfig.tiny(hidden_size=48, **bf16))
    return init_weights_(LlavaForCausalLM(cfg, device="cuda"), gen).eval()


def test_tiny_smoothed_int4_engine_matches_its_twin_route(gen):
    """A tiny LLaVA smoothed (the alpha search, on the card) and quantised
    to int4 in place: the prefill and 4 decode steps with every projection
    on kernel #11 equal, bit for bit, the same steps with each #11 product
    by its plain twin (`int4_product_plain`); attention is the same on both
    routes (#1 prefill, #4 steps)."""
    from rlaifv_tpu_torch.genai.engine import DecodeEngine
    from rlaifv_tpu_torch.models.quant_smooth import quantize_llm_int4_smooth
    from rlaifv_tpu_torch.ops import int4_matmul as i4

    model = _tiny_bf16_llava(gen)
    log = {}
    quantize_llm_int4_smooth(model, torch.randint(3, 500, (1, 40), generator=gen,
                                                  device="cuda"), log=log)
    assert model.cfg.llm.quantize_bits == 4 and set(log) == {"layer_0", "layer_1"}
    eng = DecodeEngine(model, eos_id=-1)
    ids = torch.randint(3, 500, (2, 160), generator=gen, device="cuda")
    mask = torch.ones_like(ids, dtype=torch.int32)
    steps = torch.randint(3, 500, (2, 4), generator=gen, device="cuda")

    def run():
        with torch.inference_mode():
            first, cache, cmask = eng._prefill(ids, mask, None, None, 256)
            out = [first.float()]
            for t in range(4):
                cmask[:, 160 + t] = 1
                logits, cache = eng.llm(input_ids=steps[:, t:t + 1], attention_mask=cmask,
                                        position_ids=torch.full((2, 1), 160 + t, device="cuda"),
                                        cache=cache, cache_index=160 + t)
                out.append(logits[:, 0].float())
        return torch.stack(out)

    n0, f0, d0 = i4.int4_matmul.launches, flash_attention.launches, \
        decode_attention_prefix.launches
    kernel = run()
    assert i4.int4_matmul.launches - n0 == 5 * 2 * 7  # 5 passes x 2 layers x 7 projections
    assert flash_attention.launches - f0 == 2 and decode_attention_prefix.launches - d0 == 8
    real = i4._kernel_fwd
    i4._kernel_fwd = lambda xq, sx, qp, gs: i4.int4_product_plain(
        xq, sx.reshape(-1, 1), qp, gs).to(torch.bfloat16)
    try:
        twin = run()
    finally:
        i4._kernel_fwd = real
    assert torch.isfinite(kernel).all() and torch.equal(kernel, twin)


def test_tiny_lookup_matches_generate_on_the_card(gen):
    """Greedy prompt-lookup decoding on a tiny bf16 LLaVA on the card, on a
    prompt that quotes the model's own greedy continuation (then its last 4
    tokens again), so drafts are accepted: #1 prefills the prompt, no #4
    runs inside the window loop (the 9-row window takes the dense path),
    more than one token a window, and the tokens equal generate's greedy
    tokens up to the first position where generate's top-2 logit gap is
    under 0.05 of max|first logit| (the window's dense logits and #4's
    round differently)."""
    from rlaifv_tpu_torch.genai.engine import DecodeEngine
    from rlaifv_tpu_torch.genai.lookup_decode import lookup_generate

    model = _tiny_bf16_llava(gen)
    eng = DecodeEngine(model, eos_id=-1)
    base = torch.randint(3, 500, (8,), generator=gen, device="cuda").tolist()
    prompt = [1] + (base * 20)[:159]
    quoted = eng.generate([prompt], max_new_tokens=48, prompt_bucket=len(prompt))
    prompt = prompt + [int(t) for t in quoted.tokens[0][:quoted.lengths[0]]] + prompt[-4:]
    steps, step = [], eng._step

    def recorded(*a):
        logits, cache = step(*a)
        steps.append(logits[0].float().clone())
        return logits, cache

    eng._step = recorded
    ref = eng.generate([prompt], max_new_tokens=48, prompt_bucket=len(prompt))
    del eng._step
    f0, d0 = flash_attention.launches, decode_attention_prefix.launches
    got = lookup_generate(eng, prompt, max_new_tokens=48)
    assert flash_attention.launches - f0 == 2 and decode_attention_prefix.launches == d0
    want = [int(t) for t in ref.tokens[0][:ref.lengths[0]]]
    rows = [torch.from_numpy(ref.first_logits[0]).cuda()] + steps
    scale = rows[0].abs().max().item()
    m = next((i for i, (a, b) in enumerate(zip(got.tokens, want)) if a != b), None)
    if m is None:
        assert got.tokens == want
    else:
        top2 = rows[m].topk(2).values
        assert (top2[0] - top2[1]).item() < 0.05 * scale, (m, got.tokens, want)
    assert got.n_steps < len(got.tokens) and got.tokens_per_step > 1
