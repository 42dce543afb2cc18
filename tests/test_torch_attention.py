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



# the redesigned Hopper kernels' tile edges (128-row query tiles, 128-key
# tiles, 64-query steps of the dk/dv kernel): lengths beside 128 and 255, a
# query tile straddling q_offset, n_rep 4 and 8, D 64, rows that see no key,
# strided views; B, Lq, Lk, H, KVH, D, causal, q_offset
TILE_EDGES = [
    (1, 127, 127, 4, 1, 64, True, 0),      # n_rep 4
    (1, 128, 128, 8, 1, 64, True, 0),      # n_rep 8
    (2, 129, 129, 2, 2, 64, True, 0),
    (1, 255, 255, 2, 1, 128, True, 0),
    (1, 200, 300, 2, 2, 64, True, 100),    # query tiles straddle q_offset
    (1, 129, 255, 4, 1, 64, True, 126),
    (1, 256, 256, 2, 1, 64, False, 0),     # bidirectional
    (1, 255, 127, 2, 2, 64, False, 0),
]


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
@pytest.mark.parametrize("B,Lq,Lk,H,KVH,D,causal,q_offset", TILE_EDGES)
def test_flash_forward_tile_edges_match_jax(B, Lq, Lk, H, KVH, D, causal, q_offset, strided):
    """The plain forward (out and lse) against the JAX forward kernel in
    interpret mode on inputs padded to 128 (pad keys masked, pad queries cut
    off). Row B - 1 is left-padded by 7 keys, so with causal masking at
    q_offset 0 its first 7 queries see nothing (out 0). "strided" hands the
    port head-major (B, H, L, D) storage viewed as (B, L, H, D)."""
    q, k, v = _qkv(5, B, Lq, Lk, H, KVH, D)
    mask = np.ones((B, Lk), np.int32)
    mask[-1, :7] = 0
    pq, pk = (-Lq) % 128, (-Lk) % 128

    def heads_first(x, pad):
        return jnp.asarray(np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))).transpose(0, 2, 1, 3))

    want, want_lse = jflash_fwd(heads_first(q, pq), heads_first(k, pk), heads_first(v, pk),
                                jnp.asarray(np.pad(mask, ((0, 0), (0, pk)))), 1.0 / D ** 0.5,
                                causal, 128, q_offset)
    if strided:
        tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
                      .transpose(1, 2) for x in (q, k, v))
        assert not tq.is_contiguous()
    else:
        tq, tk, tv = _t(q, k, v)
    got, lse = flash_attention(tq, tk, tv, attention_mask=torch.from_numpy(mask),
                               causal=causal, q_offset=q_offset, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3)[:, :Lq],
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, 0, :Lq], atol=ATOL)
    if causal and q_offset == 0:
        assert (got[-1, :7] == 0).all()

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
                                 dtype=torch.bfloat16, **geometry) == want
    assert tattn.attention_route(D=128, has_mask=True, on_cuda=False,
                                 dtype=torch.bfloat16, **geometry) == "dense"


@pytest.mark.parametrize(
    "Lq,Lk,q_offset",
    [(24, 24, None),   # plain DPO path: Lq == Lk == L, causal, key padding
     (16, 16, None),   # paired prefix: Lq == Lk == Pa
     (8, 24, 16)],     # paired suffix: Lq = W, Lk = Pa + W, q_offset = Pa
)
def test_dense_attention_grads_match_jax(Lq, Lk, q_offset):
    """The dense path is differentiable: dq, dk, dv of sum(out * g) against
    jax.grad of the JAX dense path, at the train step's three geometries."""
    import jax

    B, H, KVH, D = 2, 4, 2, 16
    q, k, v = _qkv(5, B, Lq, Lk, H, KVH, D)
    g = np.random.default_rng(6).normal(size=(B, Lq, H, D)).astype(np.float32)
    mask = np.ones((B, Lk), np.int32)
    mask[1, -3:] = 0  # padded key tail

    def jloss(q, k, v):
        out = jattn.multi_head_attention(q, k, v, attention_mask=jnp.asarray(mask),
                                         causal=True, q_offset=q_offset)
        return (out * g).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tattn.multi_head_attention(tq, tk, tv, attention_mask=torch.from_numpy(mask),
                                     causal=True, q_offset=q_offset, impl="dense")
    (out * torch.from_numpy(g)).sum().backward()
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize(
    "geometry,want",
    [(dict(Lq=2048, Lk=2048, q_offset=None), "flash"),    # plain DPO path
     (dict(Lq=640, Lk=640, q_offset=None), "flash"),      # paired prefix Pa
     (dict(Lq=1408, Lk=2048, q_offset=640), "flash"),     # paired suffix W
     (dict(Lq=96, Lk=736, q_offset=640), "dense")],       # a suffix under 128
)
def test_attention_route_train_shapes(geometry, want):
    """The train step's attention calls take the flash kernels on the card
    (forward and, through autograd, the two backward kernels)."""
    assert tattn.attention_route(D=128, has_mask=True, on_cuda=True,
                                 dtype=torch.bfloat16, **geometry) == want


@pytest.mark.parametrize("geometry,kernel", [
    (dict(Lq=740, Lk=740, q_offset=0), "flash"),      # autocheck prefix
    (dict(Lq=128, Lk=256, q_offset=128), "flash"),    # rectangular suffix
    (dict(Lq=2048, Lk=2048, q_offset=None), "flash"),  # plain DPO path
    (dict(Lq=1, Lk=896, q_offset=800), "decode"),     # decode step
    (dict(Lq=32, Lk=772, q_offset=740), None),        # short suffix: dense anyway
])
@pytest.mark.parametrize("D", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_attention_route_keeps_kernels_in_their_domain(dtype, D, geometry, kernel):
    """On the card a kernel takes only bf16 with D 64 or 128; every other
    type or head dim, fp32 at any D included, takes the dense path (the
    JAX package's off-TPU formula) instead of reaching a kernel that
    raises. The CPU is always dense."""
    want = kernel if kernel and dtype == torch.bfloat16 and D in (64, 128) else "dense"
    kw = dict(D=D, has_mask=True, dtype=dtype, **geometry)
    assert tattn.attention_route(on_cuda=True, **kw) == want
    assert tattn.attention_route(on_cuda=False, **kw) == "dense"
    assert tattn.kernel_domain(dtype, D) == (dtype == torch.bfloat16 and D in (64, 128))


@pytest.mark.parametrize("n_rep,want", [(1, "decode"), (2, "decode"), (4, "decode"),
                                        (8, "decode"), (3, "dense"), (16, "dense")])
def test_decode_route_needs_a_kernel_head_group(n_rep, want):
    """The decode kernels take n_rep 1, 2, 4 or 8 (flash any); mixed
    operand types (dtype None) take the dense path."""
    geo = dict(Lq=1, Lk=896, q_offset=800, D=128, has_mask=True, on_cuda=True)
    assert tattn.attention_route(dtype=torch.bfloat16, n_rep=n_rep, **geo) == want
    assert tattn.attention_route(dtype=None, n_rep=1, **geo) == "dense"
    assert tattn.attention_route(Lq=740, Lk=740, q_offset=0, D=128, has_mask=True,
                                 on_cuda=True, dtype=torch.bfloat16, n_rep=n_rep) == "flash"


@pytest.mark.parametrize("dtype,hidden,want", [
    (torch.bfloat16, 4096, "fused"), (torch.float32, 4096, "xla"),
    (torch.float16, 4096, "xla"), (torch.bfloat16, 64, "xla"), (torch.float32, 64, "xla"),
])
def test_auto_head_follows_the_model_dtype(dtype, hidden, want):
    """"auto" picks the fused head (bf16 kernels) only for a bf16 model at
    hidden >= 2048, in the precompute and in the train step; an explicit
    head stays as asked."""
    from rlaifv_tpu_torch.core.config import Config
    from rlaifv_tpu_torch.train.trainer import precompute_head, resolve_head

    training = Config().training
    assert precompute_head(training, hidden, dtype) == want
    assert resolve_head(training, hidden, dtype) == want
    training.lm_head_impl = "fused"
    assert resolve_head(training, hidden, dtype) == "fused"
