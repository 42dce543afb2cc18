"""The port's fused LM head (rlaifv_tpu_torch/ops/fused_head.py) against the
JAX package's Pallas kernels (rlaifv_tpu/ops/fused_head.py, interpret mode),
on the CPU.

The same numpy-seeded hidden states, weight and labels go through both; the
port takes the torch (V, H) weight and the JAX side its transpose (H, V).
On the CPU the port runs its plain versions (the CUDA kernels are checked
against them on the card, tests/test_torch_cuda.py and chip_smoke.py).
Cases mirror tests/test_fused_head.py: exact tiling, a vocabulary pad, a
row pad, a batch shape and H-blocked forwards. Tolerances are
tests/test_fused_head.py's: rtol/atol 1e-5 on the fp32 logps (a logsumexp
over <= 300 terms in another order), rtol 1e-4 / atol 1e-5 on gradients.

The backward walks the vocabulary in chunks (`chunk_width`, or a forced
`vc`), on the CPU with the per-chunk plain versions: the walk is held
against the JAX `_bwd` at forced small chunks with a ragged last one, and
against the unchunked `fused_head_bwd_plain` (fp32: the same products
summed over the chunks in order, rtol 1e-5 / atol 1e-6; bf16: dl rounds
alike, the fp32 sums round once to bf16, within one bf16 ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.constants import IGNORE_INDEX
from rlaifv_tpu.ops import fused_head as jfh
from rlaifv_tpu.train import dpo as jdpo
from rlaifv_tpu_torch.ops import fused_head as tfh
from rlaifv_tpu_torch.train import dpo as tdpo

ATOL = RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _case(seed, M, H, V):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(M, H)) * 0.3).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.3).astype(np.float32)  # torch (V, H)
    y = rng.integers(0, V, size=(M,)).astype(np.int32)
    g = rng.normal(size=(M,)).astype(np.float32)
    return x, w, y, g


CASES = {  # M, H, V, JAX blocks (block_m, block_v, block_h)
    "exact tiling": (16, 32, 256, dict(block_m=8, block_v=128)),
    "vocab pad": (16, 32, 300, dict(block_m=8, block_v=128)),
    "row pad": (13, 32, 256, dict(block_m=8, block_v=128)),
    "single tile": (16, 32, 256, dict(block_m=16, block_v=256)),
    "h-blocked": (16, 96, 300, dict(block_m=8, block_v=128, block_h=32)),
    "h-blocked row pad": (13, 64, 300, dict(block_m=8, block_v=128, block_h=32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_jax(case):
    M, H, V, blocks = CASES[case]
    x, w, y, g = _case(len(case), M, H, V)

    def jloss(xj, wj):
        return (jfh.fused_target_logp(xj, wj, jnp.asarray(y), interpret=True,
                                      **blocks) * jnp.asarray(g)).sum()

    want = jfh.fused_target_logp(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(y),
                                 interpret=True, **blocks)
    dx_w, dwt_w = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w.T))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = tfh.fused_target_logp(xt, wt, torch.from_numpy(y))
    (got * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_w), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dwt_w).T, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_batch_shape_and_the_plain_versions():
    """(2, 12, H) hidden keeps its batch shape; the plain forward returns
    the lse the backward uses; no kernel runs for CPU tensors."""
    x, w, y, g = _case(1, 24, 32, 256)
    launches = (tfh.fused_target_logp.fwd_launches, tfh.fused_target_logp.dx_launches,
                tfh.fused_target_logp.dw_launches)
    got = tfh.fused_target_logp(torch.from_numpy(x).reshape(2, 12, 32), torch.from_numpy(w),
                                torch.from_numpy(y).reshape(2, 12))
    assert got.shape == (2, 12) and got.dtype == torch.float32
    want = jfh.target_logp_xla(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(y))
    np.testing.assert_allclose(got.reshape(-1).numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        tfh.target_logp_plain(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(y)).numpy(), np.asarray(want),
        rtol=RTOL, atol=ATOL)
    logp, lse = tfh.fused_head_fwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                         torch.from_numpy(y))
    logits = x.astype(np.float64) @ w.T.astype(np.float64)
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(logits).sum(-1)), rtol=1e-6)
    assert launches == (tfh.fused_target_logp.fwd_launches,
                        tfh.fused_target_logp.dx_launches,
                        tfh.fused_target_logp.dw_launches)


def test_bf16_backward_rounds_dl_before_its_products():
    """bf16 in: dx and dW are the products of dl rounded to bf16 (as the
    TPU's _bwd_dx_kernel casts it), summed in fp32 and cast once."""
    x, w, y, g = _case(5, 8, 32, 128)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    _, lse = tfh.fused_head_fwd_plain(xb, wb, torch.from_numpy(y))
    dx, dw = tfh.fused_head_bwd_plain(xb, wb, torch.from_numpy(y), lse, torch.from_numpy(g))
    assert dx.dtype == dw.dtype == torch.bfloat16
    s = xb.double() @ wb.double().T
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    onehot = torch.nn.functional.one_hot(torch.from_numpy(y).long(), 128).double()
    dl = (torch.from_numpy(g).double()[:, None] * (onehot - p)).bfloat16().double()
    torch.testing.assert_close(dx, (dl @ wb.double()).bfloat16(), rtol=2 ** -7, atol=1e-6)
    torch.testing.assert_close(dw, (dl.T @ xb.double()).bfloat16(), rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("bad", ["fp32", "ragged H", "int64 labels", "strided"])
def test_kernel_operands_are_checked(bad):
    """What the CUDA kernels do not take raises before a launch."""
    x = torch.zeros((8, 64), dtype=torch.bfloat16)
    w = torch.zeros((100, 64), dtype=torch.bfloat16)
    y = torch.zeros((8,), dtype=torch.int32)
    if bad == "fp32":
        x = x.float()
    elif bad == "ragged H":
        x, w = x[:, :48].contiguous(), w[:, :48].contiguous()
    elif bad == "int64 labels":
        y = y.long()
    else:
        x = torch.zeros((8, 128), dtype=torch.bfloat16)[:, :64]
    with pytest.raises((TypeError, ValueError)):
        tfh._check(x, w, y)


@pytest.mark.parametrize("shift", [True, False])
def test_get_batch_logps_from_hidden_matches_jax(shift):
    rng = np.random.default_rng(3)
    B, L, H, V = 3, 17, 32, 53
    hidden = (rng.normal(size=(B, L, H)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, size=(B, L)).astype(np.int64)
    labels[:, :4] = IGNORE_INDEX
    labels[1, 9:12] = IGNORE_INDEX
    want = jdpo.get_batch_logps_from_hidden(jnp.asarray(hidden), jnp.asarray(w.T),
                                            jnp.asarray(labels), shift=shift,
                                            interpret=True)
    got = tdpo.get_batch_logps_from_hidden(torch.from_numpy(hidden), torch.from_numpy(w),
                                           torch.from_numpy(labels), shift=shift)
    np.testing.assert_allclose(got.per_token.numpy(), np.asarray(want.per_token),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum.numpy(), np.asarray(want.sum), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=RTOL, atol=ATOL)
    # and against the "xla" path from the logits
    logits = torch.from_numpy(hidden) @ torch.from_numpy(w).T
    plain = tdpo.get_batch_logps(logits, torch.from_numpy(labels), shift=shift)
    np.testing.assert_allclose(got.sum.numpy(), plain.sum.numpy(), rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("M,V,want", [
    (2046, 32000, 32000),   # the 7B train step's head: one chunk, 131 MB of dl
    (16368, 32000, 8192),   # the QLoRA step's 16 x 1023 rows: four chunks
    (16363, 32001, 8192),
    (77, 300, 384),         # V rounded up to VC_ALIGN
    (1, 64, 128),
    (2 ** 21, 32000, 128),  # never below VC_ALIGN
])
def test_chunk_width(M, V, want):
    vc = tfh.chunk_width(M, V)
    assert vc == want and vc % tfh.VC_ALIGN == 0
    assert vc * -(-V // vc) >= V  # the chunks cover the vocabulary
    assert vc <= -(-V // tfh.VC_ALIGN) * tfh.VC_ALIGN
    if vc > tfh.VC_ALIGN:  # within the budget, and the next width is not
        assert M * vc * 2 <= tfh.DL_CHUNK_BYTES
        assert vc == -(-V // tfh.VC_ALIGN) * tfh.VC_ALIGN or \
            M * (vc + tfh.VC_ALIGN) * 2 > tfh.DL_CHUNK_BYTES


@pytest.mark.parametrize("M,V,sms,want", [
    (2046, 32000, 132, 8),     # the 7B train step: 16 row tiles x 8 splits, one wave
    (16363, 32000, 132, 2),    # the ref-logp fallback: 128 row tiles, at least two splits
    (16368, 32000, 132, 2),    # the QLoRA step's head
    (1000, 32001, 132, 16),
    (130, 32001, 132, 66),     # two row tiles: 132 CTAs of about two tiles
    (77, 300, 132, 2),         # never more splits than vocabulary tiles
    (77, 256, 132, 1),         # one vocabulary tile: a single split
    (1, 64, 132, 1),
    (2 ** 21, 32000, 132, 2),
    (2046, 32000, 114, 7),     # a card with fewer SMs
])
def test_fwd_splits(M, V, sms, want):
    s = tfh.fwd_splits(M, V, sms)
    n_m, n_v = -(-M // tfh.ROW_TILE), -(-V // tfh.VOCAB_TILE)
    assert s == want and 1 <= s <= n_v
    assert n_m * s <= sms or s == min(2, n_v)  # one wave, unless two splits make more


FWD_SPLIT_CASES = {  # M, H, V, splits: ragged rows and a ragged last vocabulary tile
    "three splits": (13, 32, 700, 3),
    "two splits, one column in the last tile": (21, 64, 513, 2),
    "one split a tile": (29, 32, 1000, 4),
    "one split": (5, 32, 300, 1),
}


@pytest.mark.parametrize("case", list(FWD_SPLIT_CASES))
def test_split_partials_combine_to_the_forward(case):
    """The forward kernel's two stages in plain PyTorch: each split's (max,
    sumexp, target) over its 256-wide tiles, then the combine, against
    fused_head_fwd_plain and the JAX `_fwd` kernel in interpret mode."""
    M, H, V, nsplit = FWD_SPLIT_CASES[case]
    x, w, y, _ = _case(len(case) + 3, M, H, V)
    xt, wt, yt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y)
    part = tfh.fwd_partials_plain(xt, wt, yt, nsplit)
    assert part.shape == (3, nsplit, M)
    inside = [(yt >= r.start * tfh.VOCAB_TILE) & (yt < r.stop * tfh.VOCAB_TILE)
              for r in (tfh._split_tiles(i, nsplit, V) for i in range(nsplit))]
    assert torch.equal(torch.stack(inside).sum(0), torch.ones(M, dtype=torch.long))
    assert bool((part[2][~torch.stack(inside)] == 0).all())  # the label's split alone
    logp, lse = tfh.combine_partials(part)
    want_logp, want_lse = tfh.fused_head_fwd_plain(xt, wt, yt)
    torch.testing.assert_close(logp, want_logp, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(lse, want_lse, rtol=RTOL, atol=ATOL)
    jlogp, jlse = jfh._fwd(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(y), 8, 128,
                           jax.lax.Precision.HIGHEST, True)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0], rtol=RTOL, atol=ATOL)


CHUNKED = {  # M, H, V, forced vc, JAX blocks
    "ragged last chunk": (13, 64, 300, 128, dict(block_m=8, block_v=128)),
    "two chunks": (16, 32, 300, 256, dict(block_m=8, block_v=128)),
    "exact chunks": (16, 32, 256, 128, dict(block_m=8, block_v=128)),
    "h-blocked, one column last": (13, 64, 257, 128, dict(block_m=8, block_v=128,
                                                         block_h=32)),
}


@pytest.mark.parametrize("case", list(CHUNKED))
def test_chunked_backward_matches_jax(case):
    """fused_head_bwd's chunk walk on the CPU (per-chunk plain dl, fp32
    products, dx summed over the chunks in order) against jax.grad of the
    JAX fused head in interpret mode (its `_bwd` kernels)."""
    M, H, V, vc, blocks = CHUNKED[case]
    x, w, y, g = _case(len(case) + 7, M, H, V)

    def jloss(xj, wj):
        return (jfh.fused_target_logp(xj, wj, jnp.asarray(y), interpret=True,
                                      **blocks) * jnp.asarray(g)).sum()

    dx_w, dwt_w = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w.T))
    xt, wt, yt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y)
    _, lse = tfh.fused_head_fwd_plain(xt, wt, yt)
    dx, dw = tfh.fused_head_bwd(xt, wt, yt, lse, torch.from_numpy(g), vc=vc)
    assert -(-V // vc) > 1
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_w), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dwt_w).T, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vc", [None, 128, 256, 384])
def test_chunked_backward_matches_unchunked_plain(vc, dtype):
    """The chunk walk against fused_head_bwd_plain on the same inputs, with
    dW and without (need_dw=False returns None and the same dx); no kernel
    runs for CPU tensors."""
    M, H, V = 21, 64, 700  # 700 = 5 x 128 + 60: ragged at every forced vc
    x, w, y, g = _case(11, M, H, V)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    yt, gt = torch.from_numpy(y), torch.from_numpy(g)
    _, lse = tfh.fused_head_fwd_plain(xt, wt, yt)
    launches = (tfh.fused_target_logp.dl_launches, tfh.fused_target_logp.dx_launches,
                tfh.fused_target_logp.dw_launches)
    want_dx, want_dw = tfh.fused_head_bwd_plain(xt, wt, yt, lse, gt)
    dx, dw = tfh.fused_head_bwd(xt, wt, yt, lse, gt, vc=vc)
    dx_only, none = tfh.fused_head_bwd(xt, wt, yt, lse, gt, need_dw=False, vc=vc)
    assert none is None and torch.equal(dx_only, dx)
    assert dx.dtype == dw.dtype == dtype and dx.shape == xt.shape and dw.shape == wt.shape
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-6)
    torch.testing.assert_close(dx, want_dx, **tol)
    torch.testing.assert_close(dw, want_dw, **tol)
    assert launches == (tfh.fused_target_logp.dl_launches, tfh.fused_target_logp.dx_launches,
                        tfh.fused_target_logp.dw_launches)


@pytest.mark.parametrize("vc", [0, 64, 200])
def test_forced_chunk_must_be_a_multiple_of_the_tile(vc):
    x, w, y, g = _case(2, 8, 32, 256)
    xt, wt, yt, gt = (torch.from_numpy(a) for a in (x, w, y, g))
    _, lse = tfh.fused_head_fwd_plain(xt, wt, yt)
    with pytest.raises(ValueError):
        tfh.fused_head_bwd(xt, wt, yt, lse, gt, vc=vc)
