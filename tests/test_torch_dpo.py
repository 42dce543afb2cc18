"""The port's DPO math (rlaifv_tpu_torch/train/dpo.py) against the JAX
package's (rlaifv_tpu/train/dpo.py), on the CPU.

The same numpy-seeded logits, hidden states, labels and logps go through
both. Tolerances: atol 1e-5 on per-token logps and rewards (fp32 logsumexp
over <= 64 entries), 1e-4 on sums over a sequence (atol scales with the
~17 summed terms), 1e-6 on bf16-logit gathers that both sides read from
the same bf16 values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.constants import IGNORE_INDEX
from rlaifv_tpu.train import dpo as jdpo
from rlaifv_tpu_torch.train import dpo as tdpo


def _labels(rng, B, L, V):
    labels = rng.integers(0, V, size=(B, L)).astype(np.int64)
    labels[:, :4] = IGNORE_INDEX  # the prompt
    labels[1, 9:12] = IGNORE_INDEX
    return labels


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol)


@pytest.mark.parametrize("shift", [True, False])
def test_get_batch_logps_matches_jax(shift):
    rng = np.random.default_rng(0)
    B, L, V = 3, 17, 53
    logits = (rng.normal(size=(B, L, V)) * 3.0).astype(np.float32)
    labels = _labels(rng, B, L, V)
    want = jdpo.get_batch_logps(jnp.asarray(logits), jnp.asarray(labels), shift=shift)
    got = tdpo.get_batch_logps(torch.from_numpy(logits), torch.from_numpy(labels),
                               shift=shift)
    _close(got.per_token, want.per_token, 1e-5)
    _close(got.sum, want.sum, 1e-4)
    _close(got.mean, want.mean, 1e-5)


def test_get_batch_logps_bf16_logits_match_jax():
    """bf16 logits: both gather the bf16 target logit and take the
    logsumexp in fp32."""
    rng = np.random.default_rng(1)
    B, L, V = 2, 9, 64
    logits = (rng.normal(size=(B, L, V)) * 2.0).astype(np.float32)
    labels = _labels(rng, B, L, V)
    want = jdpo.get_batch_logps(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    got = tdpo.get_batch_logps(torch.from_numpy(logits).bfloat16(),
                               torch.from_numpy(labels))
    assert got.per_token.dtype == torch.float32
    _close(got.per_token, want.per_token, 1e-6)


@pytest.mark.parametrize("n_pos", [16, 5])  # 5 < valid targets: overflow
def test_get_batch_logps_compact_matches_jax(n_pos):
    rng = np.random.default_rng(2)
    B, L, Hd, V = 3, 17, 8, 40
    hidden = rng.normal(size=(B, L, Hd)).astype(np.float32)
    kernel = (rng.normal(size=(Hd, V)) * 0.5).astype(np.float32)  # flax (H, V)
    labels = _labels(rng, B, L, V)
    want = jdpo.get_batch_logps_compact(jnp.asarray(hidden), jnp.asarray(kernel),
                                        jnp.asarray(labels), n_pos=n_pos)
    got = tdpo.get_batch_logps_compact(torch.from_numpy(hidden),
                                       torch.from_numpy(kernel.T.copy()),
                                       torch.from_numpy(labels), n_pos=n_pos)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    _close(got.per_token, want.per_token, 1e-5)
    _close(got.sum, want.sum, 1e-4)
    _close(got.mean, want.mean, 1e-5)
    if n_pos == 16:  # every target fits: the full path's sums
        full = tdpo.get_batch_logps(torch.from_numpy(hidden @ kernel),
                                    torch.from_numpy(labels))
        torch.testing.assert_close(got.sum, full.sum, atol=1e-4, rtol=0)


@pytest.mark.parametrize("reference_free", [False, True])
def test_dpo_loss_matches_jax(reference_free):
    rng = np.random.default_rng(3)
    pw, pr, rw, rr = (rng.normal(-50, 10, size=8).astype(np.float32) for _ in range(4))
    want = jdpo.dpo_loss(*map(jnp.asarray, (pw, pr, rw, rr)), 0.1,
                         reference_free=reference_free)
    tpw = torch.from_numpy(pw).requires_grad_()
    got = tdpo.dpo_loss(tpw, *map(torch.from_numpy, (pr, rw, rr)), 0.1,
                        reference_free=reference_free)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    # rewards carry no gradient (stop_gradient in JAX)
    assert not got[1].requires_grad and not got[2].requires_grad
    assert got[0].requires_grad


@pytest.mark.parametrize("use_average", [False, True])
def test_compute_weighted_logp_matches_jax(use_average):
    rng = np.random.default_rng(4)
    B, L = 3, 12
    per_token = rng.normal(-2, 1, size=(B, L - 1)).astype(np.float32)
    labels = _labels(rng, B, L, 30)
    weight = rng.uniform(0.5, 2.0, size=(B, L - 1)).astype(np.float32)
    want = jdpo.compute_weighted_logp(jnp.asarray(per_token), jnp.asarray(labels),
                                      jnp.asarray(weight), use_average)
    got = tdpo.compute_weighted_logp(torch.from_numpy(per_token),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(weight), use_average)
    _close(got, want, 1e-5)


def test_dpo_metrics_match_jax():
    rng = np.random.default_rng(5)
    args = [rng.normal(size=6).astype(np.float32) for _ in range(6)]
    want = jdpo.dpo_metrics("train", *map(jnp.asarray, args))
    got = tdpo.dpo_metrics("train", *map(torch.from_numpy, args))
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], 1e-6)


def test_fused_head_raises_naming_its_item():
    """The fused head is ported (tests/test_torch_fused_head.py holds it to
    the JAX kernels); what its CUDA kernels do not take raises naming the
    condition before any launch: bf16 operands, H a multiple of 64."""
    from rlaifv_tpu_torch.ops.fused_head import _check

    y = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="bf16"):
        _check(torch.zeros(2, 64), torch.zeros(5, 64), y)
    with pytest.raises(ValueError, match="multiple of 64"):
        _check(torch.zeros(2, 4, dtype=torch.bfloat16), torch.zeros(5, 4, dtype=torch.bfloat16), y)
