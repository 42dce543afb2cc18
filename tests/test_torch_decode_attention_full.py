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
