"""The port's int8 weight-only products against the JAX package's, on the CPU.

The same seeded numpy inputs go through rlaifv_tpu/ops/quant_matmul.py
(the Pallas kernels in interpret mode) and rlaifv_tpu_torch/ops/
quant_matmul.py (CPU tensors: the kernels' plain twins).

Tolerances, with their reasons:
- the prequant paths (#9, #10) match bit for bit, in fp32 and in bf16: the
  same IEEE quantisation, exact integer sums, the same two multiplies;
- the JAX in-kernel paths (#7, #8) in interpret mode differ in one place,
  which the tests pin instead of hiding it under a tolerance: XLA computes
  their row scale max(amax, 1e-20) / 127 as a product with the rounded
  reciprocal of 127, one fp32 ulp off the IEEE quotient. The JAX #7/#8
  equal that rule bit for bit (`_reciprocal_rule`), and the port's #7/#8
  equal the JAX #9/#10, i.e. the IEEE rule the TPU's default path and the
  CUDA kernels use. The two rules move fp32 outputs by about an ulp, and
  in bf16, where x / sx lands exactly on a .5 tie, they round a quantised
  value differently (one quantisation step in one term);
- through the autograd Function (fp32, normal inputs, no ties) the port
  agrees with jax.grad within rtol 2^-21 for the same reason;
- the quantiser of the weights matches the numpy one bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.models.llama import quantize_kernel_int8
from rlaifv_tpu.ops import quant_matmul as jq
from rlaifv_tpu_torch.models.convert import quantize_kernel_int8_torch
from rlaifv_tpu_torch.ops import quant_matmul as tq

SHAPES = [(8, 32, 128), (5, 32, 300), (257, 64, 512), (130, 96, 200)]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, M, K, N, dtype):
    """x (M, K), dy (M, N) in `dtype` on both sides (the same values), and
    the int8 weight quantised from a random (K, N) kernel."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    q, s = quantize_kernel_int8((rng.normal(size=(K, N)) * 0.1).astype(np.float32))

    def both(shape):
        j = jnp.asarray((rng.normal(size=shape) * 0.5).astype(np.float32), jdt)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)

    return both((M, K)), both((M, N)), (jnp.asarray(q), jnp.asarray(s)), \
        (torch.from_numpy(q), torch.from_numpy(s))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _reciprocal_rule(v, q, scale, dx):
    """The JAX in-kernel paths as XLA's interpreter evaluates them: the
    port's plain math with sx = max(amax, 1e-20) * fp32(1 / 127)."""
    if dx:
        v = v.float() * scale.float()
    amax = v.float().abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp_min(amax, 1e-20) * torch.tensor(np.float32(1) / np.float32(127))
    vq = torch.round(v.float() / sx).clamp(-127, 127).to(torch.int8)
    if dx:
        return tq.int8_matmul_dx_prequant_plain(vq, sx, q)
    return tq.int8_matmul_prequant_plain(vq, sx, q, scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_prequant_twins_match_jax_bit_for_bit(M, K, N, dtype):
    (jx, tx), (jdy, tdy), (jqw, js), (tqw, ts) = _inputs(0, M, K, N, dtype)
    np.testing.assert_array_equal(_np(tq.int8_matmul_prequant(tx, tqw, ts)),
                                  _np(jq.int8_matmul_prequant(jx, jqw, js)))
    np.testing.assert_array_equal(_np(tq.int8_matmul_dx_prequant(tdy, tqw, ts)),
                                  _np(jq.int8_matmul_dx_prequant(jdy, jqw, js)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_in_kernel_twins_match_jax(M, K, N, dtype):
    (jx, tx), (jdy, tdy), (jqw, js), (tqw, ts) = _inputs(1, M, K, N, dtype)
    out, dx = tq.int8_matmul(tx, tqw, ts), tq.int8_matmul_dx(tdy, tqw, ts)
    assert out.dtype == tx.dtype and out.shape == (M, N) and dx.shape == (M, K)
    # the JAX in-kernel paths are the reciprocal rule, bit for bit ...
    np.testing.assert_array_equal(
        _np(jq.int8_matmul(jx, jqw, js)),
        _np(_reciprocal_rule(tx, tqw, ts, dx=False).to(tx.dtype)))
    np.testing.assert_array_equal(
        _np(jq.int8_matmul_dx(jdy, jqw, js)),
        _np(_reciprocal_rule(tdy, tqw, ts, dx=True).to(tdy.dtype)))
    # ... the port's are the IEEE rule of the JAX prequant paths
    np.testing.assert_array_equal(_np(out), _np(jq.int8_matmul_prequant(jx, jqw, js)))
    np.testing.assert_array_equal(_np(dx), _np(jq.int8_matmul_dx_prequant(jdy, jqw, js)))
    # and #7 == #9, #8 == #10 on the same inputs, bit for bit
    assert torch.equal(out, tq.int8_matmul_prequant(tx, tqw, ts))
    assert torch.equal(dx, tq.int8_matmul_dx_prequant(tdy, tqw, ts))


def test_batched_shapes_and_cpu_tensors_launch_nothing():
    (_, tx), (_, tdy), _, (tqw, ts) = _inputs(2, 14, 32, 128, "bf16")
    counts = [f.launches for f in (tq.int8_matmul, tq.int8_matmul_dx,
                                   tq.int8_matmul_prequant, tq.int8_matmul_dx_prequant)]
    x3, dy3 = tx.reshape(2, 7, 32), tdy.reshape(2, 7, 128)
    assert tq.int8_matmul(x3, tqw, ts).shape == (2, 7, 128)
    assert tq.int8_matmul_dx(dy3, tqw, ts).shape == (2, 7, 32)
    assert torch.equal(tq.int8_matmul_prequant(x3, tqw, ts).reshape(14, 128),
                       tq.int8_matmul(tx, tqw, ts))
    assert torch.equal(tq.int8_matmul_dx_prequant(dy3, tqw, ts).reshape(14, 32),
                       tq.int8_matmul_dx(tdy, tqw, ts))
    assert counts == [f.launches for f in (tq.int8_matmul, tq.int8_matmul_dx,
                                           tq.int8_matmul_prequant,
                                           tq.int8_matmul_dx_prequant)]


@pytest.mark.parametrize("M", [16, 200])
def test_int8_matmul_grad_matches_jax_grad(M):
    """The forward and dx of the autograd Function against jax.grad through
    the JAX custom_vjp (which on the CPU takes the in-kernel pair at any M;
    the port's CPU twins take the prequant pair from 128 rows, the same
    values)."""
    (jx, tx), (jg, tg), (jqw, js), (tqw, ts) = _inputs(3, M, 64, 96, "f32")
    x = tx.clone().requires_grad_(True)
    out = tq.int8_matmul_grad(x, tqw, ts)
    (out * tg).sum().backward()
    want_out = jq.int8_matmul_grad(jx, jqw, js)
    want_dx = jax.grad(lambda v: (jq.int8_matmul_grad(v, jqw, js) * jg).sum())(jx)
    np.testing.assert_allclose(_np(out.detach()), _np(want_out), rtol=2 ** -21, atol=0)
    np.testing.assert_allclose(_np(x.grad), _np(want_dx), rtol=2 ** -21, atol=0)
    assert tqw.grad is None and ts.grad is None


def test_autograd_saves_only_the_weight_and_routes_by_rows(monkeypatch):
    """The forward saves q and scale, never the activations; rows below
    INT8_DEQUANT_MIN_M take the in-kernel pair, from it INT8_LARGE_M_IMPL's
    route ("dequant" is the float product of the dequantised weight); an
    unknown route raises. Under no_grad and remat the Function still runs."""
    (_, tx), (_, tg), _, (tqw, ts) = _inputs(4, 130, 64, 96, "f32")
    saved = []
    x = tx.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                  lambda t: t):
        out = tq.int8_matmul_grad(x, tqw, ts)
    assert {t.data_ptr() for t in saved} == {tqw.data_ptr(), ts.data_ptr()}
    assert torch.equal(out, tq.int8_matmul_prequant(tx, tqw, ts))

    monkeypatch.setattr(tq, "INT8_LARGE_M_IMPL", "dequant")
    x.grad = None
    (tq.int8_matmul_grad(x, tqw, ts) * tg).sum().backward()
    w = tqw.float() * ts
    torch.testing.assert_close(x.grad, tg @ w.T, rtol=0, atol=0)
    monkeypatch.setattr(tq, "INT8_LARGE_M_IMPL", "kernel")
    assert torch.equal(tq.int8_matmul_grad(tx, tqw, ts), tq.int8_matmul(tx, tqw, ts))
    monkeypatch.setattr(tq, "INT8_LARGE_M_IMPL", "fast")
    with pytest.raises(ValueError, match="INT8_LARGE_M_IMPL"):
        tq.int8_matmul_grad(tx, tqw, ts)
    monkeypatch.setattr(tq, "INT8_LARGE_M_IMPL", "prequant")

    with torch.no_grad():
        assert torch.equal(tq.int8_matmul_grad(tx, tqw, ts), out.detach())
    x.grad = None
    from torch.utils.checkpoint import checkpoint

    (checkpoint(tq.int8_matmul_grad, x, tqw, ts, use_reentrant=False) * tg).sum().backward()
    assert torch.equal(x.grad, tq.int8_matmul_dx_prequant(tg, tqw, ts))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_quantiser_matches_numpy_bit_for_bit(dtype):
    """quantize_kernel_int8_torch against the JAX package's numpy
    quantize_kernel_int8, on fp32 weights and on bf16 ones (as a 7B bf16
    checkpoint holds them), with an all-zero column (the 1e-8 floor)."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.normal(size=(96, 200)) * 0.02).astype(np.float32))
    w[:, 7] = 0
    w = w.to(getattr(torch, dtype))
    q, s = quantize_kernel_int8_torch(w)
    want_q, want_s = quantize_kernel_int8(w.float().numpy())
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(s.numpy(), want_s)
    # and a transposed view (the torch (out, in) weight) quantises the same
    q2, s2 = quantize_kernel_int8_torch(w.T.contiguous().T)
    assert torch.equal(q2, q) and torch.equal(s2, s) and q2.is_contiguous()


# -------------------------------------------------- kernel #8's split product


@pytest.mark.parametrize("split", [1, 2, 3, 5])
@pytest.mark.parametrize("M,K,N", [(8, 32, 640), (5, 40, 520), (64, 96, 1000)])
def test_split_contraction_equals_the_twin_and_jax(M, K, N, split):
    """#8's product on the card splits the N contraction into slices of
    128-wide chunks and sums their exact int32 partials in order
    (int8_dx_split_plain): equal to the twin int8_matmul_dx_plain and to
    the JAX #10 bit for bit, and, given the rows the reciprocal rule
    quantises, to the JAX in-kernel #8 in interpret mode."""
    (_, tx), (jdy, tdy), (jqw, js), (tqw, ts) = _inputs(6, M, K, N, "bf16")
    dyq, sy = tq.quantize_rows(tdy.float() * ts)
    got = tq.int8_dx_split_plain(dyq, sy, tqw, split).to(tdy.dtype)
    assert torch.equal(got, tq.int8_matmul_dx_plain(tdy, tqw, ts))
    np.testing.assert_array_equal(_np(got), _np(jq.int8_matmul_dx_prequant(jdy, jqw, js)))
    v = tdy.float() * ts
    amax = v.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp_min(amax, 1e-20) * torch.tensor(np.float32(1) / np.float32(127))
    vq = torch.round(v / sx).clamp(-127, 127).to(torch.int8)
    np.testing.assert_array_equal(
        _np(tq.int8_dx_split_plain(vq, sx, tqw, split).to(tdy.dtype)),
        _np(jq.int8_matmul_dx(jdy, jqw, js, interpret=True)))


def test_dx_split_plan():
    """The slices fill about two CTAs an SM at M <= 64 (one 64-row tile of
    128 output columns a CTA), one CTA an SM above; never more slices than
    128-wide chunks, one where TMA cannot map the rows; a call launches the
    row pass, the product and, with slices, their sum."""
    assert tq.dx_split(64, 4096, 11008, 132) == 9       # 32 tiles x 9 = 288 CTAs
    assert tq.dx_split(127, 4096, 11008, 132) == 5      # 128-row tiles
    assert tq.dx_split(6144, 4096, 11008, 132) == 1
    assert tq.dx_split(1, 40, 208, 132) == 2            # 2 chunks of 128
    assert tq.dx_split(16, 4096, 4104, 132) == 1        # N % 16 != 0
    assert tq.dx_split(16, 4096, 4096, 132, tma=False) == 1
    assert [tq.dx_launches(s) for s in (1, 2, 9)] == [2, 3, 3]
