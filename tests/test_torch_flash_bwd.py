"""The port's flash-attention gradients against the JAX package's, on the CPU.

The JAX side is `jax.grad` of rlaifv_tpu.ops.flash_attention with its
Pallas forward and backward kernels in interpret mode, as
tests/test_flash_attention.py runs them (the same cases: kv-head variants
at L=256, the rectangular (P, W) grid with q_offset, an unaligned one),
plus left-padded rows that see no key at all. The port's
`flash_attention` gets CPU tensors, so its autograd Function runs
`flash_attention_ref` forward and `flash_attention_bwd_ref` backward.
Inputs are fp32 from one numpy seed; the JAX kernels run fp32 at
HIGHEST precision, so both sides are fp32 end to end. Tolerance: atol
2e-4 plus rtol 1e-4 on gradients of magnitude up to ~10 (fp32 sums over
256 keys taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.ops.flash_attention import flash_attention as jflash
from rlaifv_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
)

ATOL, RTOL = 2e-4, 1e-4
H = 2  # as the JAX tests on the CPU (interpret mode runs cell by cell)


def _inputs(seed, B, Lq, Lk, kvh, D=128):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Lk, kvh, D)).astype(np.float32)
    v = rng.normal(size=(B, Lk, kvh, D)).astype(np.float32)
    g = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("case", [
    dict(kvh=H, P=0, L=256, mask="tail"),        # tests/test_flash_attention.py:47
    dict(kvh=1, P=0, L=256, mask="tail"),        # GQA, n_rep 2
    dict(kvh=H, P=128, L=128, mask="tail16"),    # :79, rectangular (P, W)
    dict(kvh=1, P=128, L=128, mask="tail16"),
    dict(kvh=H, P=98, L=73, mask="tail16"),      # unaligned P and W
    dict(kvh=1, P=0, L=256, mask="left7"),       # rows 0-6 of batch 0 see no key
], ids=["mha", "gqa", "rect", "rect-gqa", "rect-unaligned", "fully-masked-rows"])
def test_flash_grads_match_jax(case):
    P, W, kvh = case["P"], case["L"], case["kvh"]
    B, Lk = 1, P + W
    q, k, v, g = _inputs(1, B, W, Lk, kvh)
    mask = np.ones((B, Lk), np.int32)
    if case["mask"] == "tail":
        mask[0, 230:] = 0
    elif case["mask"] == "tail16":
        mask[0, Lk - 16:] = 0
    else:
        mask[0, :7] = 0

    def jloss(q, k, v):
        out = jflash(q, k, v, attention_mask=jnp.asarray(mask), q_offset=P)
        return (out * g).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, attention_mask=torch.from_numpy(mask), q_offset=P)
    (out * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL)
    for name, t, want in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")
        assert torch.isfinite(t.grad).all()
    if case["mask"] == "left7":
        assert (out[0, :7] == 0).all()
        assert (tq.grad[0, :7] == 0).all()  # a row that sees nothing adds nothing



# the redesigned Hopper kernels' tile edges (see tests/test_torch_attention.py
# TILE_EDGES): B, Lq, Lk, H, KVH, D, causal, q_offset. The dq kernel's CTAs
# own 128 query rows (two warpgroups of 64) and step over 64 keys, the dk/dv
# kernel's own 128 keys and step over 64 query rows.
TILE_EDGES = [
    (1, 127, 127, 4, 1, 64, True, 0),      # n_rep 4
    (1, 128, 128, 8, 1, 64, True, 0),      # n_rep 8
    (2, 129, 129, 2, 2, 64, True, 0),
    (1, 255, 255, 2, 1, 128, True, 0),
    (1, 200, 300, 2, 2, 64, True, 100),    # query tiles straddle q_offset
    (1, 129, 255, 4, 1, 64, True, 126),
    (1, 256, 256, 2, 1, 64, False, 0),     # bidirectional
    (1, 383, 384, 2, 1, 64, True, 1),      # the last CTA's second warpgroup ragged
    (1, 65, 193, 2, 2, 128, True, 128),    # one row past a warpgroup, a 1-key step
    (1, 64, 321, 2, 1, 64, False, 0),      # the second warpgroup empty, 6 key steps
]


@pytest.mark.parametrize("B,Lq,Lk,H,KVH,D,causal,q_offset", TILE_EDGES)
def test_flash_grads_at_tile_edges_match_jax(B, Lq, Lk, H, KVH, D, causal, q_offset):
    """`jax.grad` through the JAX kernels (interpret mode) against the
    port's autograd Function on CPU tensors (the plain forward and
    backward), fp32 from one seed, with a strided dO (head-major storage)
    and the last row left-padded by 7 keys (with causal masking at q_offset
    0 its first 7 queries see nothing and get dq = 0)."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Lk, KVH, D)).astype(np.float32)
    v = rng.normal(size=(B, Lk, KVH, D)).astype(np.float32)
    g = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    mask = np.ones((B, Lk), np.int32)
    mask[-1, :7] = 0

    def jloss(q, k, v):
        out = jflash(q, k, v, attention_mask=jnp.asarray(mask), causal=causal,
                     q_offset=q_offset)
        return (out * g).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, attention_mask=torch.from_numpy(mask), causal=causal,
                          q_offset=q_offset)
    tg = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 2, 1, 3))).transpose(1, 2)
    out.backward(tg)

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL)
    for name, t, want in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")
    if causal and q_offset == 0:
        assert (tq.grad[-1, :7] == 0).all()

def test_bwd_ref_is_the_gradient_of_the_plain_forward():
    """flash_attention_bwd_ref, fed the saved out/lse and an arbitrary-strided
    dO, equals autograd through the plain forward and returns the input
    dtypes. Both compute in fp32 (atol 1e-5 on gradients of magnitude ~5)."""
    from rlaifv_tpu_torch.ops.flash_attention import flash_attention_ref

    rng = np.random.default_rng(2)
    B, Lq, Lk, KVH, D, off = 2, 20, 50, 1, 16, 30
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()
               for s in ((B, Lq, H, D), (B, Lk, KVH, D), (B, Lk, KVH, D)))
    mask = torch.ones((B, Lk), dtype=torch.int32)
    mask[1, :35] = 0  # row 1's first queries see nothing
    do = torch.from_numpy(rng.normal(size=(B, H, Lq, D)).astype(np.float32)).transpose(1, 2)
    out, lse = flash_attention_ref(q, k, v, mask, True, off)
    want = torch.autograd.grad((out * do).sum(), (q, k, v))
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), mask,
                                  out.detach(), lse.detach(), do, True, off)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_cpu_routes_to_plain_versions_and_counts_nothing():
    """On the CPU the autograd Function runs the plain versions: the kernel
    counters stay put and no kernel library is built."""
    from rlaifv_tpu_torch.ops import _build

    n = (flash_attention.launches, flash_attention_bwd.dq_launches,
         flash_attention_bwd.dkv_launches)
    q, k, v, g = _inputs(3, 1, 64, 64, 1, D=16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (flash_attention(tq, tk, tv) * torch.from_numpy(g)).sum().backward()
    assert tk.grad is not None and tv.grad.shape == tv.shape
    assert n == (flash_attention.launches, flash_attention_bwd.dq_launches,
                 flash_attention_bwd.dkv_launches)
    assert _build._lib is None
