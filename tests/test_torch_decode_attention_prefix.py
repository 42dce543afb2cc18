"""Kernel #4's plan and split twin against the JAX package's, on the CPU.

`prefix_plan` cuts the live keys [0, valid_len) of the bf16 prefix decode
kernel (csrc/decode_attention.cu) into splits; `decode_attention_prefix_split_ref`
is the kernel's function as the card splits it. The twin, on fp32 inputs
made from one numpy seed, is held to the JAX `decode_attention_prefix(...,
interpret=True)` (rlaifv_tpu/ops/decode_attention.py:104, TPU kernel #4) at
tests/test_torch_attention.py's tolerance, atol 1e-4 (fp32 sums in another
order and across split boundaries); at one split it is
`decode_attention_prefix_ref` bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.ops.decode_attention import decode_attention_prefix as jdecode
from rlaifv_tpu_torch.ops import decode_attention as td

ATOL = 1e-4
SMS = 132  # the H100's streaming multiprocessors


@pytest.mark.parametrize("B,KVH,valid_len,n_rep", [
    (10, 32, 896, 1),  # phase 4's decode step: 320 CTAs
    (24, 32, 960, 1),  # the bf16 batch-24 run: 768 CTAs
    (40, 8, 960, 4),   # 320 CTAs, GQA
])
def test_plan_takes_one_split_where_the_batch_fills_a_wave(B, KVH, valid_len, n_rep):
    assert td.prefix_plan(B, KVH, valid_len, SMS, n_rep) == 1


@pytest.mark.parametrize("B,valid_len,want", [
    (8, 2200, 2), (8, 1024, 2), (8, 384, 1), (8, 64, 1),  # B 8 x KVH 8 = 64 CTAs
    (1, 2200, 8), (2, 4000, 8), (4, 2200, 4),
])
def test_plan_splits_the_llama3_gqa_step(B, valid_len, want):
    """B x KVH 8 CTAs: as many splits as bring them up to one CTA an SM,
    unless the live keys leave fewer than PREFIX_MIN_KEYS a split."""
    splits = td.prefix_plan(B, 8, valid_len, SMS, 4)
    assert splits == want
    assert B * 8 * splits <= td.PREFIX_CTAS_PER_SM * SMS


@pytest.mark.parametrize("B,KVH,valid_len,sms", [
    (1, 1, 1, 132), (1, 1, 5, 132), (1, 1, 63, 132), (1, 1, 64, 132), (1, 1, 129, 132),
    (2, 8, 4000, 132), (1, 8, 2200, 1000), (8, 8, 2200, 16), (64, 32, 4096, 132),
])
def test_plan_cuts_the_live_prefix_only(B, KVH, valid_len, sms):
    """At least one split; every split non-empty, within [0, valid_len),
    and the splits cover it once; more than one only with PREFIX_MIN_KEYS
    keys each."""
    splits = td.prefix_plan(B, KVH, valid_len, sms, 2)
    assert 1 <= splits <= valid_len
    ranges = td.full_split_ranges(valid_len, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == valid_len
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(l1 > l0 for l0, l1 in ranges)
    if splits > 1:
        assert min(l1 - l0 for l0, l1 in ranges) >= td.PREFIX_MIN_KEYS
        assert B * KVH * splits <= td.PREFIX_CTAS_PER_SM * sms


@pytest.mark.parametrize("n_rep", [0, 3, 16])
def test_plan_refuses_other_head_groups(n_rep):
    with pytest.raises(ValueError):
        td.prefix_plan(8, 8, 2200, SMS, n_rep)


def _inputs(seed, B, L, H, KVH, D, valid_len, pad=7):
    """fp32 q, k, v and a mask with `pad` b columns of left padding in row
    b, live up to valid_len (the engine's mask: 0 past it)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, L, KVH, D)).astype(np.float32)
    mask = np.zeros((B, L), np.int32)
    for b in range(B):
        mask[b, pad * b:valid_len] = 1
    return q, k, v, mask


def _jax(q, k, v, mask, valid_len, block_l=8):
    return np.asarray(jdecode(*(jnp.asarray(a) for a in (q, k, v, mask)),
                              jnp.int32(valid_len), block_l=block_l, interpret=True))


def _poisoned(q, k, v, mask, valid_len):
    """The port's tensors with NaN in every cache column past valid_len."""
    tq, tk, tv, tm = (torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, mask))
    tk[:, valid_len:] = float("nan")
    tv[:, valid_len:] = float("nan")
    return tq, tk, tv, tm


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("B,L,H,KVH,D,valid_len", [
    (3, 64, 4, 4, 16, 50),   # n_rep 1
    (3, 64, 8, 2, 32, 61),   # n_rep 4 (GQA)
    (2, 40, 8, 1, 16, 33),   # n_rep 8
    (2, 128, 4, 2, 64, 97),  # D 64
])
def test_split_twin_matches_jax_interpret(splits, B, L, H, KVH, D, valid_len):
    """Each split count on the same inputs; columns past valid_len hold NaN
    on the port's side (never read)."""
    q, k, v, mask = _inputs(splits, B, L, H, KVH, D, valid_len)
    want = _jax(q, k, v, mask, valid_len)
    got = td.decode_attention_prefix_split_ref(*_poisoned(q, k, v, mask, valid_len),
                                               valid_len, splits)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("splits", [2, 3, 4])
def test_a_split_in_the_left_padding_adds_nothing(splits):
    """Row 1's left padding covers its first split whole, row 2 sees no key
    at all (exactly 0), row 0 only its last split's keys."""
    B, L, H, KVH, D, valid_len = 3, 96, 8, 2, 32, 90
    q, k, v, mask = _inputs(7, B, L, H, KVH, D, valid_len, pad=0)
    ranges = td.full_split_ranges(valid_len, splits)
    mask[0, :ranges[-1][0]] = 0
    mask[1, :ranges[0][1] + 3] = 0
    mask[2] = 0
    want = _jax(q, k, v, mask, valid_len)
    got = td.decode_attention_prefix_split_ref(*_poisoned(q, k, v, mask, valid_len),
                                               valid_len, splits)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert (got[2] == 0).all()
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid_len", [1, 13, 64, 100])
def test_one_split_is_the_sequential_twin(dtype, valid_len):
    """At one split the twin is `decode_attention_prefix_ref` bit for bit,
    the fully masked rows (1 and 2 at valid_len 1) included."""
    q, k, v, mask = _inputs(3, 3, 128, 8, 4, 64, valid_len, pad=1)
    args = [t.to(dtype) for t in _poisoned(q, k, v, mask, valid_len)[:3]]
    tm = torch.from_numpy(mask)
    ref = td.decode_attention_prefix_ref(*args, tm, valid_len)
    assert torch.equal(td.decode_attention_prefix_split_ref(*args, tm, valid_len, 1), ref)
    if valid_len == 1:
        assert (ref[1:] == 0).all()


def test_split_twin_refuses_more_splits_than_keys():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(0, 1, 16, 2, 2, 16, 3))
    with pytest.raises(ValueError):
        td.decode_attention_prefix_split_ref(q, k, v, mask, 3, 4)


def test_cpu_wrapper_runs_the_sequential_twin():
    """A CPU tensor takes `decode_attention_prefix_ref`, whatever the plan,
    and launches nothing."""
    q, k, v, mask = _inputs(4, 8, 256, 32, 8, 32, 200)
    tq, tk, tv, tm = _poisoned(q, k, v, mask, 200)
    n0 = td.decode_attention_prefix.launches
    got = td.decode_attention_prefix(tq, tk, tv, tm, 200)
    assert torch.equal(got, td.decode_attention_prefix_ref(tq, tk, tv, tm, 200))
    assert td.decode_attention_prefix.launches == n0
