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
