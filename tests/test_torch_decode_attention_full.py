"""Kernel #6's plain version against the JAX package's, on the CPU.

`decode_attention_ref` (the port's twin of the TPU `_kernel` of
rlaifv_tpu/ops/decode_attention.py:341 `decode_attention`) against the JAX
`decode_attention(..., interpret=True)` on the same seeded inputs. Both
compute in fp32 over every cache column, so fp32 inputs agree to atol 1e-5,
the tolerance of tests/test_decode_attention.py (only the summation order
of the dots and exp's rounding differ). bf16 inputs: both upcast the same
bf16 values and round the fp32 result to bf16 once, so the outputs differ
by at most one bf16 ulp of the output (2^-8 relative, plus the fp32 atol).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from rlaifv_tpu_torch.ops import decode_attention as td

ATOL = 1e-5
BF16_RTOL = 2.0 ** -8


def _inputs(seed, B, L, H, KVH, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, L, KVH, D)).astype(np.float32)
    mask = np.ones((B, L), np.int32)
    mask[0, L // 2:] = 0  # a truncated row
    mask[-1, :3] = 0  # left padding
    mask[-1, L // 3:L // 3 + 5] = 0  # an interior hole
    return q, k, v, mask


def _jax(q, k, v, mask):
    return np.asarray(jax_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, mask)), interpret=True)).astype(np.float32)


@pytest.mark.parametrize("B,L,H,KVH,D", [
    (2, 32, 4, 4, 16),  # n_rep 1
    (2, 40, 4, 2, 16),  # n_rep 2
    (3, 37, 8, 2, 32),  # n_rep 4, L not a multiple of 8
    (2, 128, 8, 8, 64),  # D 64
])
def test_twin_matches_jax_interpret_fp32(B, L, H, KVH, D):
    q, k, v, mask = _inputs(0, B, L, H, KVH, D)
    want = _jax(q, k, v, mask)
    got = td.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert td.decode_attention.launches == 0  # CPU tensors: the twin


def test_fully_masked_row_returns_zero():
    """The denominator clamp: a row that sees no key outputs exactly 0 in
    both packages (the dense softmax path would give the uniform average)."""
    q, k, v, mask = _inputs(1, 3, 29, 8, 4, 16)
    mask[1] = 0
    want = _jax(q, k, v, mask)
    got = td.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    assert (want[1] == 0).all() and (got[1] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_twin_matches_jax_interpret_bf16():
    """bf16 operands: fp32 arithmetic on both sides, one rounding to bf16."""
    q, k, v, mask = _inputs(2, 2, 45, 8, 2, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_decode_attention(jq, jk, jv, jnp.asarray(mask), interpret=True))
    assert want.dtype == jnp.bfloat16
    want = want.astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = td.decode_attention(tq, tk, tv, torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= ATOL + BF16_RTOL * np.abs(want)).all()


def test_prefix_twin_is_the_full_twin_over_the_prefix():
    """Kernel #4's plain version is kernel #6's over columns [0, valid_len):
    columns past it never reach the result."""
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(3, 2, 48, 8, 4, 16))
    k[:, 30:] = float("nan")
    v[:, 30:] = float("nan")
    got = td.decode_attention_prefix_ref(q, k, v, mask, 30)
    want = td.decode_attention_ref(q, k[:, :30], v[:, :30], mask[:, :30])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------- kernel #6's split key axis


def _split_case(case, seed, B, L, H, KVH, D, splits):
    """Inputs whose mask exercises the merge: "dead split" masks every key
    of split 1 in row 0; "dead row" masks all of row 1 (a row masked in
    every split); "holes" leaves left padding and an interior hole."""
    q, k, v, mask = _inputs(seed, B, L, H, KVH, D)
    mask[:] = 1
    ranges = td.full_split_ranges(L, splits)
    if case == "dead split":
        mask[0, ranges[1][0]:ranges[1][1]] = 0
    elif case == "dead row":
        mask[1] = 0
    else:
        mask[-1, :3] = 0
        mask[0, L // 3:L // 3 + 5] = 0
    return q, k, v, mask


@pytest.mark.parametrize("case,B,L,H,KVH,D,splits", [
    ("dead split", 2, 96, 4, 4, 16, 3),    # n_rep 1
    ("dead split", 2, 100, 8, 4, 32, 4),   # n_rep 2, L not a multiple of the splits
    ("dead row", 3, 77, 8, 2, 16, 5),      # n_rep 4
    ("dead row", 2, 130, 8, 1, 64, 2),     # n_rep 8
    ("holes", 3, 129, 16, 2, 32, 7),       # n_rep 8, L % 7 != 0
    ("holes", 2, 64, 4, 4, 16, 1),         # one split: the plain state
])
def test_split_twin_matches_ref_and_jax(case, B, L, H, KVH, D, splits):
    """decode_attention_split_ref (each split's (m, l, acc) merged as the
    card merges them) against decode_attention_ref and the JAX
    decode_attention(..., interpret=True), fp32, within 1e-5 x max(1,
    max|ref|) (3h's bound: sums in other orders, exp rounded once more per
    split). A split whose keys are all masked adds nothing; a row masked in
    every split is exactly 0."""
    q, k, v, mask = _split_case(case, 4, B, L, H, KVH, D, splits)
    args = [torch.from_numpy(a) for a in (q, k, v, mask)]
    got = td.decode_attention_split_ref(*args, splits)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, D)
    assert torch.isfinite(got).all()
    for want in (td.decode_attention_ref(*args).numpy(), _jax(q, k, v, mask)):
        bound = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got.numpy() - want).max()) <= bound
    if case == "dead row":
        assert (got[1] == 0).all()
    if case == "dead split":  # the live splits of row 0 alone give its output
        live = [r for i, r in enumerate(td.full_split_ranges(L, splits)) if i != 1]
        keep = torch.zeros(L, dtype=torch.bool)
        for l0, l1 in live:
            keep[l0:l1] = True
        alone = td.decode_attention_ref(args[0][:1], args[1][:1, keep], args[2][:1, keep],
                                        args[3][:1, keep])
        torch.testing.assert_close(got[:1], alone, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,KVH,L,n_rep,want", [
    (8, 8, 2304, 4, 6),     # Llama3-8B's GQA step: 384 CTAs for 3 x 132
    (8, 4, 2304, 8, 8),     # n_rep 8: two CTAs an SM, 256 CTAs
    (24, 32, 1024, 1, 1),   # batch 24, H = KVH = 32: 768 CTAs already
    (4, 8, 896, 1, 7),      # run_tpu_checks' shape: 8 fit, 7 splits of 128 keys
    (4, 4, 896, 2, 7),
    (3, 8, 781, 4, 6),
    (1, 1, 100, 4, 1),      # fewer keys than one split's floor
    (2, 1, 4096, 8, 32),
    (16, 8, 4096, 4, 3),    # 384 CTAs
])
def test_full_plan(B, KVH, L, n_rep, want):
    """As many splits as B x KVH x splits CTAs fit in one wave of the CTAs
    an SM holds at this n_rep on 132 SMs, each split at least
    FULL_MIN_KEYS keys; the ranges cover the keys once."""
    splits = td.full_plan(B, KVH, L, 132, n_rep)
    assert splits == want
    ranges = td.full_split_ranges(L, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == L
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert splits == 1 or min(l1 - l0 for l0, l1 in ranges) >= td.FULL_MIN_KEYS
    assert splits == 1 or B * KVH * splits <= td.FULL_CTAS_PER_SM[n_rep] * 132
