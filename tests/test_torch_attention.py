"""The port's attention ops against the JAX package's, on the CPU.

The JAX Pallas kernels run in interpret mode, as tests/test_flash_attention.py
and tests/test_decode_attention.py run them; the port's wrappers get CPU
tensors and so run their plain PyTorch versions. Inputs are fp32, made from
one numpy seed. Tolerance: atol 1e-4 (fp32 sums taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.ops import attention as jattn
from rlaifv_tpu.ops.decode_attention import decode_attention_prefix as jdecode
from rlaifv_tpu.ops.flash_attention import _fwd as jflash_fwd
from rlaifv_tpu.ops.flash_attention import flash_attention as jflash
from rlaifv_tpu_torch.ops import attention as tattn
from rlaifv_tpu_torch.ops.decode_attention import (
    decode_attention_prefix,
    decode_attention_prefix_ref,
)
from rlaifv_tpu_torch.ops.flash_attention import flash_attention

ATOL = 1e-4


def _qkv(seed, B, Lq, Lk, H, KVH, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Lk, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, Lk, KVH, D)).astype(np.float32)
    return q, k, v


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("kvh", [2, 1])
def test_flash_forward_matches_jax(kvh):
    """B=2, L=256, H=2, D=128, causal, padded key tail; out and lse."""
    B, L, H, D = 2, 256, 2, 128
    q, k, v = _qkv(0, B, L, L, H, kvh, D)
    mask = np.ones((B, L), np.int32)
    mask[1, 200:] = 0

    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  attention_mask=jnp.asarray(mask))
    _, want_lse = jflash_fwd(
        jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(mask), 1.0 / D ** 0.5,
        True, 256,
    )
    got, lse = flash_attention(*_t(q, k, v), attention_mask=torch.from_numpy(mask),
                               return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, 0], atol=ATOL)


def test_flash_unaligned_left_padded_matches_jax():
    """Lq = Lk = 98 causal (the TPU wrapper pads it to 128); row 1 is
    left-padded, so its first queries see no key and must output 0."""
    B, L, H, KVH, D = 2, 98, 2, 1, 128
    q, k, v = _qkv(1, B, L, L, H, KVH, D)
    mask = np.ones((B, L), np.int32)
    mask[1, :5] = 0

    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  attention_mask=jnp.asarray(mask))
    pad = ((0, 0), (0, 128 - L), (0, 0), (0, 0))
    _, want_lse = jflash_fwd(
        *(jnp.asarray(np.pad(x, pad).transpose(0, 2, 1, 3)) for x in (q, k, v)),
        jnp.asarray(np.pad(mask, ((0, 0), (0, 128 - L)))), 1.0 / D ** 0.5,
        True, 128,
    )
    got, lse = flash_attention(*_t(q, k, v), attention_mask=torch.from_numpy(mask),
                               return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, 0, :L],
                               atol=ATOL)
    assert (got[1, :5] == 0).all()


def test_flash_rectangular_q_offset_matches_jax():
    """Suffix queries at [128, 256) over 256 keys (static q_offset)."""
    B, W, P, H, KVH, D = 1, 128, 128, 2, 2, 128
    q, k, v = _qkv(2, B, W, P + W, H, KVH, D)
    mask = np.ones((B, P + W), np.int32)
    mask[0, 240:] = 0
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  attention_mask=jnp.asarray(mask), q_offset=P)
    got = flash_attention(*_t(q, k, v), attention_mask=torch.from_numpy(mask),
                          q_offset=P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("valid_len", [1, 13, 32])
def test_decode_attention_prefix_matches_jax(valid_len):
    """JAX's prefix kernel (block_l=8, interpret) vs the port, with a
    left-padded row (fully masked at valid_len=1, which must give 0)."""
    B, L, H, KVH, D = 2, 32, 4, 2, 16
    q, k, v = _qkv(3, B, 1, L, H, KVH, D)
    q = q[:, 0]
    mask = np.zeros((B, L), np.int32)
    mask[0, :valid_len] = 1
    mask[1, 2:valid_len] = 1

    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(mask), jnp.int32(valid_len), block_l=8,
                   interpret=True)
    tq, tk, tv, tm = _t(q, k, v, mask)
    got = decode_attention_prefix(tq, tk, tv, tm, valid_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if valid_len == 1:
        assert (got[1] == 0).all()
    # columns at or past valid_len are never read
    tk[:, valid_len:] = float("nan")
    tv[:, valid_len:] = float("nan")
    assert torch.equal(decode_attention_prefix_ref(tq, tk, tv, tm, valid_len), got)


@pytest.mark.parametrize(
    "Lq,Lk,q_offset,causal,masked",
    [(16, 16, None, True, True),   # training-style causal, left-padded rows
     (1, 128, 40, True, True),     # decode step over a static cache
     (8, 40, 32, True, True),      # autocheck suffix window after a prefix
     (17, 17, None, False, False)],  # bidirectional, no mask (CLIP tower)
)
def test_multi_head_attention_matches_jax(Lq, Lk, q_offset, causal, masked):
    B, H, KVH, D = 2, 4, 2, 16
    q, k, v = _qkv(4, B, Lq, Lk, H, KVH, D)
    mask = None
    if masked:
        mask = np.ones((B, Lk), np.int32)
        mask[1, :3] = 0
        if q_offset is not None:
            mask[:, q_offset + Lq:] = 0
    want = jattn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attention_mask=None if mask is None else jnp.asarray(mask),
        causal=causal, q_offset=q_offset,
    )
    got = tattn.multi_head_attention(
        *_t(q, k, v), attention_mask=None if mask is None else torch.from_numpy(mask),
        causal=causal, q_offset=q_offset,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize(
    "geometry,want",
    [(dict(Lq=740, Lk=740, q_offset=0), "flash"),     # autocheck prefix
     (dict(Lq=832, Lk=896, q_offset=0), "dense"),     # generate prefill
     (dict(Lq=32, Lk=772, q_offset=740), "dense"),    # autocheck suffix
     (dict(Lq=1, Lk=896, q_offset=800), "decode"),    # decode step
     (dict(Lq=1, Lk=900, q_offset=800), "dense"),     # unaligned cache
     (dict(Lq=128, Lk=256, q_offset=128), "flash")],  # rectangular suffix
)
def test_attention_route_on_cuda(geometry, want):
    """The slice's geometries reach the same paths as on the TPU."""
    assert tattn.attention_route(D=128, has_mask=True, on_cuda=True,
                                 **geometry) == want
    assert tattn.attention_route(D=128, has_mask=True, on_cuda=False,
                                 **geometry) == "dense"
