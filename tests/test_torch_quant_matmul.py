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


# ------------------------------------------- kernel #10's routes and tile edges


@pytest.mark.parametrize("M,K,N,tma,want", [
    # 3d's 7B widths: below the crossover, the crossover, the short step's
    # prefix (one pair, 768 rows), the 8-pair step's suffix and prefix rows
    (16, 4096, 4096, True, ("split", (64, 128), 9, 2)),
    (64, 4096, 11008, True, ("split", (64, 128), 9, 2)),
    (127, 11008, 4096, True, ("split", (128, 128), 2, 2)),
    (128, 4096, 4096, True, ("split", (128, 128), 5, 2)),
    (768, 4096, 11008, True, ("split", (128, 128), 1, 1)),   # 6 x 16 wide tiles < 132
    (768, 11008, 4096, True, ("wide", (128, 256), 1, 1)),    # 6 x 43
    (4544, 4096, 11008, True, ("wide", (128, 256), 1, 1)),
    (6144, 4096, 11008, True, ("wide", (128, 256), 1, 1)),
    (6144, 11008, 4096, True, ("wide", (128, 256), 1, 1)),
    # the fused widths at a decode and a prefill step, Llama3-8B's down_proj
    (24, 4096, 22016, True, ("split", (64, 128), 9, 2)),
    (21504, 4096, 12288, True, ("wide", (128, 256), 1, 1)),
    (128, 14336, 4096, True, ("split", (128, 128), 2, 2)),
    # rows a TMA tensor map cannot read: the cp.async kernel, one launch
    (512, 4096, 1000, True, ("rows", (128, 128), 1, 1)),
    (6144, 4096, 11008, False, ("rows", (128, 128), 1, 1)),
])
def test_dx_prequant_plan(M, K, N, tma, want):
    """#10 takes the 128 x 256 tile at split 1 where its tiles fill the 132
    SMs (at least one each), #8's 128-column product split along N where
    they do not (its `dx_split` slices; the summing pass only with more
    than one), and the cp.async kernel on rows TMA cannot map."""
    plan = tq.dx_prequant_plan(M, K, N, 132, tma)
    assert tuple(plan) == want
    if plan.route == "split":
        assert plan.split == tq.dx_split(M, K, N, 132)
        assert plan.launches == tq.dx_launches(plan.split) - 1  # no row pass


@pytest.mark.parametrize("N", [1008, 1000])
@pytest.mark.parametrize("K", [255, 256, 257])
@pytest.mark.parametrize("M", [127, 128, 129, 257])
def test_dx_prequant_twin_at_the_wide_tiles_edges_matches_jax(M, K, N):
    """int8_matmul_dx_prequant's twin (CPU tensors) against the JAX #10 in
    interpret mode, bit for bit, bf16, at the edges of the wide tile (128
    rows x 256 output columns) and of its 128-byte contraction chunks (N
    1008, and N 1000, which TMA cannot map); and, where the card's plan at
    any SM count splits the contraction, #8's split product the same."""
    _, (jdy, tdy), (jqw, js), (tqw, ts) = _inputs(7, M, K, N, "bf16")
    got = tq.int8_matmul_dx_prequant(tdy, tqw, ts)
    assert got.shape == (M, K) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(got), _np(jq.int8_matmul_dx_prequant(jdy, jqw, js, interpret=True)))
    dyq, sy = tq.quantize_rows(tdy.float() * ts)
    for sms in (1, 132):
        plan = tq.dx_prequant_plan(M, K, N, sms)
        assert plan.route == ("rows" if N % 16 else "wide" if sms == 1 else "split")
        if plan.route == "split":
            assert torch.equal(tq.int8_dx_split_plain(dyq, sy, tqw, plan.split).to(got.dtype),
                               got)


# ------------------------------------------- kernel #7's split product and plan


@pytest.mark.parametrize("M,K,N,tma,want", [
    # phase 11's decode rows at the fused widths (qkv 3 x 4096, gate/up 2 x
    # 11008) and its o and down projections
    (10, 4096, 12288, True, ("split", (16, 128), 1, 2)),
    (24, 4096, 12288, True, ("split", (24, 128), 1, 2)),
    (24, 4096, 22016, True, ("split", (24, 128), 1, 2)),
    (24, 4096, 4096, True, ("split", (24, 128), 4, 2)),
    (24, 11008, 4096, True, ("split", (24, 128), 4, 2)),
    # phase 13's Llama3-8B decode rows: fused qkv, gate/up, down
    (8, 4096, 6144, True, ("split", (8, 128), 2, 2)),
    (8, 4096, 28672, True, ("split", (8, 128), 1, 2)),
    (8, 14336, 4096, True, ("split", (8, 128), 4, 2)),
    # the 7B widths at 3d's rows below the crossover and the short step's suffix
    (16, 4096, 4096, True, ("split", (16, 128), 4, 2)),
    (64, 4096, 11008, True, ("split", (64, 128), 1, 2)),
    (64, 11008, 4096, True, ("split", (64, 128), 4, 2)),
    (127, 4096, 11008, True, ("split", (128, 128), 1, 2)),
    # few columns and a short contraction: no more slices than 128-row chunks
    (1, 32, 16, True, ("split", (8, 128), 1, 2)),
    (40, 272, 1008, True, ("split", (48, 128), 3, 2)),
    # more rows than the split product takes, and rows TMA cannot map
    (128, 4096, 4096, True, ("tile", (128, 128), 1, 1)),
    (64, 4096, 1000, True, ("rows", (128, 128), 1, 1)),
    (64, 4100, 4096, True, ("rows", (128, 128), 1, 1)),
    (24, 4096, 12288, False, ("rows", (128, 128), 1, 1)),
])
def test_fwd_plan(M, K, N, tma, want):
    """#7 takes the row pass and the split product up to FWD_SPLIT_MAX_M
    rows, on tiles of the rows rounded up to FWD_ROWS, its K contraction
    in as many slices as keep the CTAs within one an SM on 132 SMs (never
    more slices than 128-row chunks): two launches; the cp.async kernel
    above it and on rows TMA cannot map: one. The slices cover K exactly
    once."""
    plan = tq.fwd_plan(M, K, N, 132, tma)
    assert tuple(plan) == want
    if plan.route == "split":
        assert plan.tile[0] == min(r for r in tq.FWD_ROWS if r >= M)
        assert -(-N // tq.FWD_TILE) * plan.split <= 132 or plan.split == 1
    slices = tq.fwd_slices(K, plan.split)
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(k0 < k1 for k0, k1 in slices)  # no empty slice where the plan splits
    assert all(k0 % tq.FWD_TILE == 0 for k0, _ in slices)


@pytest.mark.parametrize("split", [1, 2, 3, 5])
@pytest.mark.parametrize("M,K,N", [(8, 640, 128), (24, 520, 96), (5, 300, 200), (64, 1000, 48)])
def test_fwd_split_contraction_equals_the_twins_and_jax(M, K, N, split):
    """#7's product on the card splits the K contraction into slices of
    128-row chunks (ragged K: the last chunk short) and sums their exact
    int32 partials (int8_fwd_split_plain): equal to int8_matmul_plain and to
    the #9 twin bit for bit, on rows quantised once (the row pass); and,
    given the rows the reciprocal rule quantises, to the JAX in-kernel #7 in
    interpret mode bit for bit (the rule test_in_kernel_twins_match_jax
    pins)."""
    (jx, tx), _, (jqw, js), (tqw, ts) = _inputs(8, M, K, N, "bf16")
    xq, sx = tq.quantize_rows(tx.float())
    got = tq.int8_fwd_split_plain(xq, sx, tqw, ts, split).to(tx.dtype)
    assert torch.equal(got, tq.int8_matmul_plain(tx, tqw, ts))
    assert torch.equal(got, tq.int8_matmul_prequant_plain(xq, sx, tqw, ts).to(tx.dtype))
    np.testing.assert_array_equal(_np(got), _np(jq.int8_matmul_prequant(jx, jqw, js)))
    amax = tx.float().abs().amax(dim=-1, keepdim=True)
    sr = torch.clamp_min(amax, 1e-20) * torch.tensor(np.float32(1) / np.float32(127))
    xr = torch.round(tx.float() / sr).clamp(-127, 127).to(torch.int8)
    np.testing.assert_array_equal(
        _np(tq.int8_fwd_split_plain(xr, sr, tqw, ts, split).to(tx.dtype)),
        _np(jq.int8_matmul(jx, jqw, js, interpret=True)))
    slices = tq.fwd_slices(K, split)
    assert sum(k1 - k0 for k0, k1 in slices) == K


# ------------------------------------------------ kernel #9's routes and plan


@pytest.mark.parametrize("M,K,N,tma,want", [
    # the 8-pair QLoRA step's prefix and suffix rows, a batch's prefill at the
    # fused widths, one prompt's prefill and 3d's crossover rows
    (6144, 4096, 11008, True, ("wide", (128, 256), 1, 1)),
    (4544, 11008, 4096, True, ("wide", (128, 256), 1, 1)),
    (21504, 4096, 12288, True, ("wide", (128, 256), 1, 1)),
    (832, 4096, 22016, True, ("wide", (128, 256), 1, 1)),
    (128, 4096, 4096, True, ("wide", (128, 256), 1, 1)),   # 16 tiles: fewer than 132 SMs
    (1, 32, 16, True, ("wide", (128, 256), 1, 1)),
    # rows a TMA tensor map cannot read: the cp.async kernel
    (512, 4096, 1000, True, ("rows", (128, 128), 1, 1)),   # N % 16 != 0
    (512, 4104, 4096, True, ("rows", (128, 128), 1, 1)),   # K % 16 != 0
    (6144, 4096, 11008, False, ("rows", (128, 128), 1, 1)),
])
def test_fwd_prequant_plan(M, K, N, tma, want):
    """#9 takes the 128 x 256 wide tile (q^T built in registers, wgmma)
    wherever TMA can map the rows, one launch whatever the row count and the
    SM count; the cp.async kernel where it cannot."""
    for sms in (1, 132):
        assert tuple(tq.fwd_prequant_plan(M, K, N, sms, tma)) == want
    assert tq.PREQ_ROUTES[want[0]] == (0 if want[0] == "rows" else 1)


@pytest.mark.parametrize("N", [1008, 1000])
@pytest.mark.parametrize("K", [272, 264])
@pytest.mark.parametrize("M", [127, 128, 129, 257])
def test_prequant_twin_at_the_wide_tiles_edges_matches_jax(M, K, N):
    """int8_matmul_prequant's twin (CPU tensors), the function of both #9
    routes, against the JAX #9 in interpret mode, bit for bit, bf16, at the
    edges of the wide tile (128 rows x 256 columns, 128-row K chunks: K 272
    ends on a short chunk) and on rows TMA cannot map (N 1000, K 264: the
    cp.async route); and equal to #7's twin, which #9 equals on the card."""
    (jx, tx), _, (jqw, js), (tqw, ts) = _inputs(9, M, K, N, "bf16")
    route = tq.fwd_prequant_plan(M, K, N, 132).route
    assert route == ("wide" if N % 16 == 0 and K % 16 == 0 else "rows")
    got = tq.int8_matmul_prequant(tx, tqw, ts)
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(got), _np(jq.int8_matmul_prequant(jx, jqw, js, interpret=True)))
    xq, sx = tq.quantize_rows(tx.float())
    assert torch.equal(tq.int8_matmul_prequant_plain(xq, sx, tqw, ts).to(got.dtype), got)
    assert torch.equal(tq.int8_matmul_plain(tx, tqw, ts), got)
    assert tq.int8_matmul_prequant.launches == 0  # CPU tensors: the twin
