"""The port's int4 weight-only products against the JAX package's, on the CPU.

The same seeded numpy inputs go through rlaifv_tpu/ops/int4_matmul.py (the
Pallas kernels in interpret mode, its dequant fallback) and
rlaifv_tpu_torch/ops/int4_matmul.py (CPU tensors: the kernels' plain
twins).

Tolerances, with their reasons:
- packing, unpacking, the weight quantiser and the dequantisation match bit
  for bit (the same integer operations, IEEE divisions, round half to even);
- the JAX kernels run by XLA on the CPU round in two places where the TPU
  kernels' code (and the port's, on the card and in its twins) does not,
  and the tests pin each rule, in fp32 and in bf16, instead of hiding it
  under a tolerance:
  the forward's first group sum acc = p0 + p1 is contracted into one fused
  multiply-add, fma(float(i0), gs[0], p1), and each later acc + p_g into
  fma(float(i_g), gs[g], acc) (`_numpy_forward(contracted=True)`); the dx
  kernel's row scale max(amax, 1e-20) / 127 becomes a product with the
  rounded reciprocal of 127, one fp32 ulp off the IEEE quotient (as for the
  int8 kernels #7/#8). The port's twins follow the separately rounded sums
  and the IEEE quotient (`contracted=False`, `reciprocal=False`), bit for
  bit. The two rules move an fp32 output by about an ulp; in bf16 most
  outputs agree, but one that lies on a rounding boundary can move by an
  ulp (the (130, 512) x (512, 128) case has one);
- through the autograd Function's dequant route (the JAX package's CPU
  path) fp32 products in other summation orders: rtol 1e-5 on outputs of
  ~1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.ops import int4_matmul as J
from rlaifv_tpu_torch.models.convert import quantize_int4_torch
from rlaifv_tpu_torch.ops import int4_matmul as T

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [((8, 256), 384), ((130, 512), 128), ((1, 5, 384), 256)]  # x shape, N


def _inputs(seed, xshape, N, dtype):
    """x (..., K) and dy (..., N) in `dtype` on both sides (the same values)
    and the int4 weight quantised from a random (K, N) kernel."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    K = xshape[-1]
    qp, gs = J.quantize_int4((rng.normal(size=(K, N)) * 0.1).astype(np.float32))

    def both(shape):
        j = jnp.asarray((rng.normal(size=shape) * 0.5).astype(np.float32), jdt)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)

    return both(xshape), both(xshape[:-1] + (N,)), (jnp.asarray(qp), jnp.asarray(gs)), \
        (torch.from_numpy(qp), torch.from_numpy(gs))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rows(v, reciprocal=False):
    """numpy row quantisation: (int64 values, fp32 row scales)."""
    amax = np.abs(v).max(axis=-1, keepdims=True)
    s = np.maximum(amax, np.float32(1e-20))
    s = s * (np.float32(1) / np.float32(127)) if reciprocal else s / np.float32(127)
    s = s.astype(np.float32)
    return np.clip(np.round(v / s), -127, 127).astype(np.int64), s


def _numpy_forward(x, qp, gs, contracted):
    """Kernel #11's arithmetic in numpy on fp32 x (M, K): exact int sums per
    group, then the groups' fp32 sum, separately rounded or contracted into
    fused multiply-adds as XLA does on the CPU (the exact product in fp64,
    rounded once with the addend)."""
    xq, sx = _rows(x)
    q = T.unpack_int4(torch.from_numpy(np.array(qp))).numpy().astype(np.int64)
    gs = np.asarray(gs)
    i = [(xq[:, g * 128:(g + 1) * 128] @ q[g * 128:(g + 1) * 128]).astype(np.float64)
         for g in range(gs.shape[0])]
    p = [(v * gs[g]).astype(np.float32) for g, v in enumerate(i)]
    if contracted and len(p) > 1:
        acc = (i[0] * gs[0] + p[1]).astype(np.float32)
        for g in range(2, len(p)):
            acc = (i[g] * gs[g] + acc).astype(np.float32)
    else:
        acc = p[0]
        for part in p[1:]:
            acc = (acc + part).astype(np.float32)
    return (acc * sx).astype(np.float32)


def _numpy_dx(dy, qp, gs, reciprocal):
    """Kernel #12's arithmetic in numpy on fp32 dy (M, N)."""
    q = T.unpack_int4(torch.from_numpy(np.array(qp))).numpy().astype(np.int64)
    gs = np.asarray(gs)
    out = np.zeros((dy.shape[0], q.shape[0]), np.float32)
    for j in range(gs.shape[0]):
        vq, sy = _rows((dy * gs[j]).astype(np.float32), reciprocal)
        out[:, j * 128:(j + 1) * 128] = ((vq @ q[j * 128:(j + 1) * 128].T)
                                         .astype(np.float32) * sy).astype(np.float32)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [128, 256, "K"])
def test_packing_and_quantiser_match_jax_bit_for_bit(dtype, group):
    """pack/unpack/dequantize in torch and the numpy and torch quantisers
    against the JAX package's, on fp32 weights and on bf16 ones (as a 7B
    bf16 checkpoint holds them), with an all-zero column (the 1e-8 floor)."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.normal(size=(512, 200)) * 0.02).astype(np.float32))
    w[:, 7] = 0
    w = w.to(getattr(torch, dtype))
    G = 512 if group == "K" else group
    want_q, want_s = J.quantize_int4(w.float().numpy(), group=G)
    for q, s in (T.quantize_int4(w.float().numpy(), group=G), quantize_int4_torch(w, G)):
        np.testing.assert_array_equal(np.asarray(q), want_q)
        np.testing.assert_array_equal(np.asarray(s), want_s)
    # a transposed view (the torch (out, in) weight) quantises the same
    q2, s2 = quantize_int4_torch(w.T.contiguous().T, G)
    assert q2.dtype == torch.int8 and s2.dtype == torch.float32 and q2.is_contiguous()
    np.testing.assert_array_equal(q2.numpy(), want_q)
    # every nibble value, -8 included, through pack and unpack
    vals = rng.integers(-8, 8, size=(512, 200)).astype(np.int8)
    packed = T.pack_int4_torch(torch.from_numpy(vals), G)
    np.testing.assert_array_equal(packed.numpy(), J.pack_int4(vals, G))
    np.testing.assert_array_equal(T.unpack_int4(packed, G).numpy(), vals)
    np.testing.assert_array_equal(T.unpack_int4(torch.from_numpy(want_q), G).numpy(),
                                  np.asarray(J.unpack_int4(want_q, G)))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    got = T.dequantize_int4(torch.from_numpy(want_q), torch.from_numpy(want_s),
                            getattr(torch, dtype))
    np.testing.assert_array_equal(_np(got), _np(J.dequantize_int4(
        jnp.asarray(want_q), jnp.asarray(want_s), jdt)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("xshape,N", SHAPES)
def test_forward_twin_matches_the_jax_kernel(xshape, N, dtype):
    (jx, tx), _, (jqp, jgs), (tqp, tgs) = _inputs(0, xshape, N, dtype)
    got = T.int4_matmul(tx, tqp, tgs)
    want = J.int4_matmul(jx, jqp, jgs, interpret=True)
    assert got.dtype == tx.dtype and got.shape == tuple(xshape[:-1]) + (N,)
    assert torch.equal(got, T.int4_matmul_plain(tx, tqp, tgs))
    x2 = _np(tx).reshape(-1, xshape[-1])
    for out, contracted in ((got, False), (want, True)):  # each side is its rule
        rule = torch.from_numpy(_numpy_forward(x2, jqp, jgs, contracted)).to(tx.dtype)
        np.testing.assert_array_equal(_np(out).reshape(x2.shape[0], N), _np(rule))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("xshape,N", SHAPES)
def test_dx_twin_matches_the_jax_kernel(xshape, N, dtype):
    _, (jdy, tdy), (jqp, jgs), (tqp, tgs) = _inputs(1, xshape, N, dtype)
    got = T.int4_matmul_dx(tdy, tqp, tgs)
    want = J.int4_matmul_dx(jdy, jqp, jgs, interpret=True)
    assert got.dtype == tdy.dtype and got.shape == tuple(xshape)
    d2 = _np(tdy).reshape(-1, N)
    for out, reciprocal in ((got, False), (want, True)):
        rule = torch.from_numpy(_numpy_dx(d2, jqp, jgs, reciprocal)).to(tdy.dtype)
        np.testing.assert_array_equal(_np(out).reshape(d2.shape[0], -1), _np(rule))


@pytest.mark.parametrize("M", [16, 200])
def test_int4_matmul_grad_routes_as_on_the_card(M, monkeypatch):
    """On CPU tensors the autograd Function takes the card's routes: #11's
    twin forward and #12's twin dx at a legal shape; with INT4_DX_MAX_N
    below N the dequant dx, which is jax.grad through the JAX custom_vjp
    (its CPU path) to fp32 reordering. Nothing launches; q and scales get
    no gradient."""
    (jx, tx), (jg, tg), (jqp, jgs), (tqp, tgs) = _inputs(3, (M, 256), 384, "f32")
    n0 = (T.int4_matmul.launches, T.int4_matmul_dx.launches)
    x = tx.clone().requires_grad_(True)
    out = T.int4_matmul_grad(x, tqp, tgs)
    (out * tg).sum().backward()
    assert torch.equal(out.detach(), T.int4_matmul(tx, tqp, tgs))
    assert torch.equal(x.grad, T.int4_matmul_dx(tg, tqp, tgs))

    monkeypatch.setattr(T, "INT4_DX_MAX_N", 256)
    x.grad = None
    (T.int4_matmul_grad(x, tqp, tgs) * tg).sum().backward()
    want_dx = jax.grad(lambda v: (J.int4_matmul_grad(v, jqp, jgs) * jg).sum())(jx)
    np.testing.assert_allclose(_np(x.grad), _np(want_dx), rtol=1e-5, atol=1e-6)
    assert torch.equal(x.grad, tg @ T.dequantize_int4(tqp, tgs).T)
    assert tqp.grad is None and tgs.grad is None
    assert (T.int4_matmul.launches, T.int4_matmul_dx.launches) == n0


def test_autograd_saves_only_the_weight_and_takes_the_dequant_route(monkeypatch):
    """The forward saves qp and gs, never the activations; INT4_IMPL
    "dequant" and the shapes the kernels do not take (N not a multiple of
    128, one group of K = 192) run the dequant formula, which is the JAX
    package's CPU result; an unknown route raises. Under no_grad and remat
    the Function still runs."""
    (jx, tx), (_, tg), (jqp, jgs), (tqp, tgs) = _inputs(4, (130, 256), 128, "f32")
    saved = []
    x = tx.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                  lambda t: t):
        out = T.int4_matmul_grad(x, tqp, tgs)
    assert {t.data_ptr() for t in saved} == {tqp.data_ptr(), tgs.data_ptr()}

    monkeypatch.setattr(T, "INT4_IMPL", "dequant")
    deq = T.int4_matmul_grad(tx, tqp, tgs)
    assert torch.equal(deq, tx @ T.dequantize_int4(tqp, tgs))
    np.testing.assert_allclose(_np(deq), _np(J.int4_matmul_grad(jx, jqp, jgs)),
                               rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(T, "INT4_IMPL", "fast")
    with pytest.raises(ValueError, match="INT4_IMPL"):
        T.int4_matmul_grad(tx, tqp, tgs)
    monkeypatch.setattr(T, "INT4_IMPL", "kernel")

    rng = np.random.default_rng(6)
    for K, N, G in ((256, 64, 128), (192, 128, 192)):
        qp, gs = (torch.from_numpy(a) for a in J.quantize_int4(
            rng.normal(size=(K, N)).astype(np.float32), group=G))
        assert not T._kernel_legal(qp, gs)
        v = torch.from_numpy(rng.normal(size=(3, K)).astype(np.float32))
        assert torch.equal(T.int4_matmul_grad(v, qp, gs), v @ T.dequantize_int4(qp, gs))

    with torch.no_grad():
        assert torch.equal(T.int4_matmul_grad(tx, tqp, tgs), out.detach())
    from torch.utils.checkpoint import checkpoint

    x.grad = None
    (checkpoint(T.int4_matmul_grad, x, tqp, tgs, use_reentrant=False) * tg).sum().backward()
    assert torch.equal(x.grad, T.int4_matmul_dx(tg, tqp, tgs))


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    """The JAX package's legality rule (128 | G, 128 | N) and the layouts,
    on the CPU as on the card; zero rows give empty outputs."""
    _, _, _, (tqp, tgs) = _inputs(5, (4, 256), 128, "f32")
    x, dy = torch.zeros(4, 256), torch.zeros(4, 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        T.int4_matmul(x[:, :128], tqp[:64, :64].contiguous(), tgs[:1, :64].contiguous())
    with pytest.raises(ValueError, match="multiple of 128"):
        T.int4_matmul_dx(dy, *(torch.from_numpy(a) for a in
                               J.quantize_int4(np.ones((256, 128), np.float32), group=64)))
    with pytest.raises(TypeError):
        T.int4_matmul(x, tqp.float(), tgs)
    with pytest.raises(ValueError):
        T.int4_matmul(x, tqp, tgs.double())
    with pytest.raises(ValueError):
        T.int4_matmul(x[:, :128], tqp, tgs)
    with pytest.raises(ValueError):
        T.int4_matmul_dx(dy[:, :64], tqp, tgs)
    assert T.int4_matmul(x[:0], tqp, tgs).shape == (0, 128)
    assert T.int4_matmul_dx(dy[:0], tqp, tgs).shape == (0, 256)


def test_forward_kernel_wrapper_raises_on_what_tma_does_not_take():
    """Kernel #11's wrapper reads qp and gs through TMA: a base off 16 bytes
    raises before any launch, as groups of more than FWD_MAX_GROUP rows do
    (the kernel's int32 sums of 16 times the weights stay exact in fp32 up
    to there)."""
    xq = torch.ones(4, 256, dtype=torch.int8)
    sx = torch.ones(4)
    _, _, _, (tqp, tgs) = _inputs(5, (4, 256), 128, "f32")
    odd = torch.empty(tqp.numel() + 1, dtype=torch.int8)[1:].view(tqp.shape)
    odd.copy_(tqp)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        T._kernel_fwd(xq, sx, odd, tgs)
    odd_gs = torch.empty(tgs.numel() + 1)[1:].view(tgs.shape)
    odd_gs.copy_(tgs)
    with pytest.raises(ValueError, match="16-byte"):
        T._kernel_fwd(xq, sx, tqp, odd_gs)
    K = 2 * T.FWD_MAX_GROUP
    with pytest.raises(ValueError, match="at most"):
        T._kernel_fwd(torch.ones(4, K, dtype=torch.int8), sx,
                      torch.zeros(K // 2, 128, dtype=torch.int8), torch.ones(1, 128))


@pytest.mark.parametrize("width", ["one-group", "g128"])
def test_quantize_llm_int4_equals_jax_and_bridges_both_ways(width):
    """quantize_llm_int4 on the port's tiny Llama (weights bridged from a
    JAX tree) equals the JAX quantize_llm_int4 plus the bridge bit for bit;
    flax_tree gives the JAX tree back; the head stays float; logits agree
    with the JAX int4 model's (both dequantise on the CPU; atol 1e-5)."""
    from rlaifv_tpu.models.convert import quantize_llm_int4 as jquantize
    from rlaifv_tpu.models.llama import LlamaConfig as JLlamaConfig
    from rlaifv_tpu.models.llama import LlamaForCausalLM as JLlama
    from rlaifv_tpu_torch.models.convert import flax_tree, load_jax_params, quantize_llm_int4
    from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, QuantDense

    dims = {} if width == "one-group" else dict(hidden_size=128, intermediate_size=256)
    ids = jnp.asarray([[1, 5, 9, 12, 40]], jnp.int32)
    params = JLlama(JLlamaConfig.tiny(**dims)).init(jax.random.PRNGKey(0), ids)["params"]
    params = jax.tree.map(np.asarray, params)
    model = load_jax_params(LlamaForCausalLM(LlamaConfig.tiny(**dims)), params)
    quantize_llm_int4(model)
    jq = jquantize(params)
    down = model.model.layers[0].mlp.down_proj
    assert isinstance(down, QuantDense) and down.bits == 4
    assert down.scale.shape == ((1, 64) if width == "one-group" else (2, 128))
    assert not isinstance(model.lm_head, QuantDense)
    assert model.cfg.quantize and model.cfg.quantize_bits == 4
    assert not model.cfg.quantize_lm_head

    bridged = load_jax_params(LlamaForCausalLM(LlamaConfig.tiny(
        **dims, quantize=True, quantize_bits=4, quantize_lm_head=False)), jq)
    own, other = model.state_dict(), bridged.state_dict()
    assert set(own) == set(other)
    for k in own:
        assert torch.equal(own[k], other[k]), k
    flat = dict(jax.tree_util.tree_flatten_with_path(jq)[0])
    back = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.detach().numpy(), flax_tree(model)))[0])
    assert set(flat) == set(back)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]), err_msg=str(k))

    jcfg = JLlamaConfig.tiny(**dims, quantize=True, quantize_bits=4, quantize_lm_head=False)
    want = JLlama(jcfg).apply({"params": jq}, ids)[0]
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(ids)).long())[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_quant_dense_bits_and_other_bit_widths():
    """QuantDense(bits=4) holds (in/2, out) packed weights and (in/G, out)
    scales and computes x @ dequant on the CPU; a bit width other than 8
    or 4 raises."""
    from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, QuantDense

    layer = QuantDense(256, 128, dtype=torch.float32, bits=4)
    assert layer.q.shape == (128, 128) and layer.scale.shape == (2, 128)
    _, _, _, (tqp, tgs) = _inputs(7, (3, 256), 128, "f32")
    layer.q.copy_(tqp)
    layer.scale.copy_(tgs)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 3, 256)).astype(np.float32))
    assert torch.equal(layer(x), x @ T.dequantize_int4(tqp, tgs))
    assert QuantDense(96, 8, dtype=torch.float32, bits=4).scale.shape == (1, 8)
    with pytest.raises(ValueError, match="8 or 4"):
        QuantDense(64, 8, dtype=torch.float32, bits=2)
    with pytest.raises(ValueError, match="8 or 4"):
        LlamaForCausalLM(LlamaConfig.tiny(quantize=True, quantize_bits=2), device="meta")


# ------------------------------------------------- kernel #12's arithmetic


def _groups(dy, gs):
    """fp32 v = dy * gs[j] for every group j (the twin's products)."""
    return [torch.from_numpy(dy) * torch.from_numpy(gs[j]) for j in range(gs.shape[0])]


@pytest.mark.parametrize("seed,M,N,J", [(0, 8, 256, 3), (1, 33, 384, 2), (2, 5, 1024, 7)])
def test_bracketed_rounding_equals_ieee_on_ties(seed, M, N, J):
    """#12 rounds rn(v / sy) without a division: two bracketing products
    v r (1 -+ 2^-20), exact in float64, rounded half to even; where they
    round apart, the IEEE quotient. On inputs whose quotients are exact
    half-integers or one ulp beside them (synth.quotient_ties) it equals
    quantize_rows bit for bit, while rounding v r alone (the rule without
    the guard) misses about a quarter of the ties."""
    from rlaifv_tpu_torch.ops.quant_matmul import quantize_rows
    from rlaifv_tpu_torch.utils.synth import quotient_ties

    dy, gs = quotient_ties(M, N, J, seed=seed)
    assert torch.equal(torch.from_numpy(dy).to(torch.bfloat16).float(), torch.from_numpy(dy))
    for v in _groups(dy, gs):
        want, sy = quantize_rows(v)
        q = v / sy
        assert (q - q.floor() == 0.5).float().mean() > 0.3  # the ties are there
        assert torch.equal(T.bracketed_round(v, sy), want)
        unguarded = torch.round(v.double() * (torch.ones_like(sy) / sy).double())
        assert (unguarded.clamp(-127, 127).to(torch.int8) != want).float().mean() > 0.1


def test_bracketed_rounding_equals_ieee_on_a_sweep():
    """The same on random rows of any scale: values drawn from fp32 bit
    patterns, rows with zeros, tiny and huge magnitudes (hypothesis)."""
    from hypothesis import given, settings
    from hypothesis import strategies as st
    from hypothesis.extra.numpy import arrays

    from rlaifv_tpu_torch.ops.quant_matmul import quantize_rows

    finite = st.floats(allow_nan=False, allow_infinity=False, width=32)

    @settings(max_examples=200, deadline=None, derandomize=True)
    @given(arrays(np.float32, st.tuples(st.integers(1, 4), st.integers(1, 64)),
                  elements=finite), st.floats(2.0 ** -100, 2.0 ** 100, width=32))
    def check(rows, scale):
        v = torch.from_numpy(rows) * torch.tensor(scale, dtype=torch.float32)
        v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
        want, sy = quantize_rows(v)
        assert torch.equal(T.bracketed_round(v, sy), want)

    check()


@pytest.mark.parametrize("G", [128, 256])
def test_row_scale_table_matches_the_jax_kernel_group_for_group(G):
    """The plain version of #12's first pass, the (M, K/G) table of row
    scales, equals quantize_rows' scale of dy * gs[j] group for group; its
    maxima equal the ones the JAX _dx_kernel takes (the same jnp
    expressions, on the CPU), and its scale is the IEEE quotient of them
    by 127 where XLA's is the reciprocal rule (as tests above pin)."""
    from rlaifv_tpu_torch.ops.quant_matmul import quantize_rows

    rng = np.random.default_rng(9)
    K, N, M = 2 * G, 256, 20
    qp, gs = J.quantize_int4((rng.normal(size=(K, N)) * 0.1).astype(np.float32), group=G)
    dy = (rng.normal(size=(M, N)) * 0.5).astype(np.float32)
    table = T.int4_dx_row_scales(torch.from_numpy(dy), torch.from_numpy(gs))
    assert table.shape == (M, K // G) and table.dtype == torch.float32
    for j, v in enumerate(_groups(dy, gs)):
        assert torch.equal(table[:, j:j + 1], quantize_rows(v)[1])
        dys = jnp.asarray(dy) * jnp.asarray(gs)[j:j + 1, :]
        amax = np.asarray(jnp.max(jnp.abs(dys), axis=1, keepdims=True))
        np.testing.assert_array_equal(amax, v.abs().amax(-1, keepdim=True).numpy())
        np.testing.assert_array_equal(_rows(v.numpy(), reciprocal=False)[1],
                                      table[:, j:j + 1].numpy())
        np.testing.assert_array_equal(
            _rows(v.numpy(), reciprocal=True)[1],
            np.asarray(jnp.maximum(jnp.asarray(amax), 1e-20) / 127.0))


@pytest.mark.parametrize("ties", [False, True])
def test_kernel_rule_dx_equals_the_twin(ties):
    """#12 as the card computes it (the row-scale table, then the
    bracketed rounding, exact integer sums per group) equals the twin
    int4_matmul_dx_plain bit for bit, on Gaussian rows and on ties."""
    from rlaifv_tpu_torch.utils.synth import quotient_ties

    rng = np.random.default_rng(11)
    K, N, M = 384, 256, 12
    qp, gs = (torch.from_numpy(a) for a in J.quantize_int4(
        (rng.normal(size=(K, N)) * 0.1).astype(np.float32)))
    if ties:
        dy_np, gs_np = quotient_ties(M, N, K // 128, seed=4)
        dy, gs = torch.from_numpy(dy_np).to(torch.bfloat16), torch.from_numpy(gs_np)
    else:
        dy = torch.from_numpy((rng.normal(size=(M, N)) * 0.5).astype(np.float32)).bfloat16()
    d2 = dy.float()
    table = T.int4_dx_row_scales(d2, gs)
    w = T.unpack_int4(qp).long()
    out = torch.empty(M, K)
    for j in range(gs.shape[0]):
        sy = table[:, j:j + 1]
        vq = T.bracketed_round(d2 * gs[j], sy)
        out[:, j * 128:(j + 1) * 128] = (vq.long() @ w[j * 128:(j + 1) * 128].T).float() * sy
    assert torch.equal(out.to(torch.bfloat16), T.int4_matmul_dx_plain(dy, qp, gs))
