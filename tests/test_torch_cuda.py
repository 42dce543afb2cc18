"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test skips. On the card
(`--noconftest`: tests/conftest.py imports jax, which the port never needs):

    python -m pytest -m cuda tests/test_torch_cuda.py --noconftest -q

bf16 inputs; outputs are checked as |kernel - plain| <= 1e-2 + 1e-2 |plain|
(each side rounds once to bf16, and the flash kernel rounds its
probabilities to bf16 for the P.V product), lse at 1e-3 abs (fp32). The
backward kernels' dq, dk, dv: max|kernel - plain| <= 2e-2 max|plain| per
gradient (P and dS are rounded to bf16 for the products and the outputs
are bf16: about one bf16 ulp of the largest entry). The fused LM head:
logp and lse within 2e-4 nats (fp32 sums of the same bf16 products in
other orders); dx and dW elementwise within 2^-6 |plain| + 1e-5 max|plain|
(both round dl to bf16 and the fp32 sums to bf16 once: an ulp or two).
"""
import pytest
import torch

from rlaifv_tpu_torch.ops.decode_attention import (
    decode_attention_prefix,
    decode_attention_prefix_ref,
)
from rlaifv_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from rlaifv_tpu_torch.ops.fused_head import (
    fused_head_bwd,
    fused_head_bwd_plain,
    fused_head_fwd,
    fused_head_fwd_plain,
    fused_target_logp,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(g, *shape):
    return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)


def _close(out, ref):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    err = (out - ref).abs() - 1e-2 * ref.abs()
    assert err.max().item() <= 1e-2, err.max().item()


@pytest.mark.parametrize("B,Lq,Lk,H,KVH,D,causal,q_offset", [
    (1, 740, 740, 32, 32, 128, True, 0),     # autocheck prefix
    (2, 1024, 1024, 32, 8, 128, True, 0),    # GQA
    (1, 577, 577, 16, 16, 64, False, 0),     # bidirectional, D=64
    (2, 70, 70, 4, 1, 64, True, 0),          # one ragged tile
    (1, 100, 300, 4, 2, 128, True, 200),     # rectangular suffix window
])
def test_flash_kernel_matches_plain(gen, B, Lq, Lk, H, KVH, D, causal, q_offset):
    q, k, v = _randn(gen, B, Lq, H, D), _randn(gen, B, Lk, KVH, D), _randn(gen, B, Lk, KVH, D)
    mask = torch.ones((B, Lk), dtype=torch.int32, device="cuda")
    mask[-1, :7] = 0  # left padding: the first 7 queries of row -1 see nothing
    kw = dict(attention_mask=mask, causal=causal, q_offset=q_offset)
    n0 = flash_attention.launches
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    ref, ref_lse = flash_attention_ref(q, k, v, mask, causal, q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    _close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    if causal and q_offset == 0:
        assert (out[-1, :7] == 0).all()


def test_flash_kernel_takes_strided_views(gen):
    """q/k/v as head-major views (the JAX layout with explicit strides)."""
    B, L, H, D = 1, 200, 4, 64
    qt = _randn(gen, B, H, L, D)
    kt, vt = _randn(gen, B, H, L, D), _randn(gen, B, H, L, D)
    q, k, v = (x.transpose(1, 2) for x in (qt, kt, vt))
    out = flash_attention(q, k, v)
    ref, _ = flash_attention_ref(q, k, v)
    _close(out, ref)


def _close_grad(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err


@pytest.mark.parametrize("B,Lq,Lk,H,KVH,D,causal,q_offset", [
    (2, 200, 200, 4, 4, 128, True, 0),     # MHA, ragged last tile
    (2, 256, 256, 8, 2, 128, True, 0),     # GQA, n_rep 4
    (1, 100, 300, 4, 1, 128, True, 200),   # rectangular suffix window
    (1, 150, 150, 4, 4, 64, False, 0),     # bidirectional, D=64
    (2, 70, 70, 4, 2, 64, True, 0),        # one ragged tile
])
def test_flash_bwd_kernels_match_plain(gen, B, Lq, Lk, H, KVH, D, causal, q_offset):
    """dq and dk/dv kernels against flash_attention_bwd_ref on the same
    inputs, with a strided dO; the left-padded row's first queries see no
    key and get dq = 0."""
    q, k, v = _randn(gen, B, Lq, H, D), _randn(gen, B, Lk, KVH, D), _randn(gen, B, Lk, KVH, D)
    mask = torch.ones((B, Lk), dtype=torch.int32, device="cuda")
    mask[-1, :7] = 0
    mask[0, -5:] = 0
    out, lse = flash_attention(q, k, v, attention_mask=mask, causal=causal,
                               q_offset=q_offset, return_lse=True)
    do = _randn(gen, B, H, Lq, D).transpose(1, 2)  # not contiguous
    args = (q, k, v, mask, out, lse, do, causal, q_offset)
    n = (flash_attention_bwd.dq_launches, flash_attention_bwd.dkv_launches)
    got = flash_attention_bwd(*args)
    ref = flash_attention_bwd_ref(*args)
    torch.cuda.synchronize()
    assert (flash_attention_bwd.dq_launches, flash_attention_bwd.dkv_launches) == \
        (n[0] + 1, n[1] + 1)
    for a, r, t in zip(got, ref, (q, k, v)):
        assert a.dtype == torch.bfloat16 and a.shape == t.shape
        _close_grad(a, r)
    if causal and q_offset == 0:
        assert (got[0][-1, :7] == 0).all()
    # no atomics: the same inputs give the same bits
    assert all(torch.equal(a, b) for a, b in zip(got, flash_attention_bwd(*args)))


def test_flash_autograd_on_cuda(gen):
    """flash_attention under autograd on the card: the gradients come from
    the two kernels and match the plain backward."""
    B, L, H, KVH, D = 2, 192, 4, 2, 128
    q, k, v = (_randn(gen, B, L, n, D).requires_grad_() for n in (H, KVH, KVH))
    g = _randn(gen, B, L, H, D)
    mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
    mask[1, -20:] = 0
    n = (flash_attention.launches, flash_attention_bwd.dq_launches)
    out = flash_attention(q, k, v, attention_mask=mask)
    (out.float() * g.float()).sum().backward()
    assert (flash_attention.launches, flash_attention_bwd.dq_launches) == (n[0] + 1, n[1] + 1)
    ref_out, lse = flash_attention_ref(q.detach(), k.detach(), v.detach(), mask)
    ref = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), mask, out.detach(),
                                  lse, g, True, 0)
    for t, r in zip((q, k, v), ref):
        _close_grad(t.grad, r)


@pytest.mark.parametrize("H,KVH,D", [(32, 32, 128), (32, 8, 128), (8, 1, 64)])
@pytest.mark.parametrize("valid_len", [1, 129, 640, 896])
def test_decode_kernel_matches_plain_and_skips_dead_columns(gen, H, KVH, D, valid_len):
    B, L = 10, 896
    q, k, v = _randn(gen, B, H, D), _randn(gen, B, L, KVH, D), _randn(gen, B, L, KVH, D)
    mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
    for b in range(B):
        mask[b, 7 * b:valid_len] = 1
    k[:, valid_len:] = float("nan")  # columns past valid_len are never read
    v[:, valid_len:] = float("nan")
    out = decode_attention_prefix(q, k, v, mask, valid_len)
    ref = decode_attention_prefix_ref(q, k, v, mask, valid_len)
    _close(out, ref)
    if valid_len == 1:
        assert (out[1:] == 0).all()


def test_kernels_raise_on_what_they_do_not_take(gen):
    q, k = _randn(gen, 2, 128, 4, 64), _randn(gen, 2, 128, 4, 64)
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError):
        flash_attention(q[..., :48], k[..., :48], k[..., :48])
    cache = _randn(gen, 1, 128, 4, 64).expand(3, -1, -1, -1)  # stride-0 batch
    mask = torch.ones((3, 128), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        decode_attention_prefix(_randn(gen, 3, 4, 64), cache, cache, mask, 5)
    with pytest.raises(ValueError):
        decode_attention_prefix(_randn(gen, 3, 4, 64), cache.contiguous(),
                                cache.contiguous(), mask, 0)


def test_tiny_slice_kernels_match_dense_path(gen):
    """A bf16 tiny LLaVA (head dim 64) on the card: autocheck and greedy
    decoding through the kernels agree with the same model forced dense."""
    import numpy as np

    from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.llama import LlamaAttention, LlamaConfig
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_
    from fake_tokenizer import FakeTokenizer  # tests/ is on sys.path under pytest

    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    cfg = LlavaConfig(
        llm=LlamaConfig.tiny(hidden_size=128, num_heads=2, num_kv_heads=1, **bf16),
        vision=CLIPVisionConfig.tiny(hidden_size=48, **bf16))
    model = init_weights_(LlavaForCausalLM(cfg, device="cuda"), gen).eval()
    g = Llava15Generator(model, FakeTokenizer(), cfg.num_image_tokens,
                         image_size=cfg.vision.image_size)
    S = cfg.vision.image_size
    img = np.random.default_rng(0).integers(0, 255, (S, S, 3), dtype=np.uint8)
    items = [{"question": f"Is object {i} present?", "question_id": i, "image": img}
             for i in range(4)]
    prompts, starts, images = g._prepare(items)
    P = int(starts[0]) + g.num_patches

    def run(impl):
        for m in model.modules():
            if isinstance(m, LlamaAttention):
                m.attn_impl = impl
        logits = g.engine.score_shared_prefix(
            prompts[0][:P], [p[P:] for p in prompts], image=images[0],
            image_start=int(starts[0]), batch_size=4)
        res = g.engine.generate(prompts, images=images, image_starts=starts,
                                max_new_tokens=8)
        return torch.from_numpy(logits), res

    f0, d0 = flash_attention.launches, decode_attention_prefix.launches
    fast_logits, fast = run("auto")
    assert flash_attention.launches > f0 and decode_attention_prefix.launches > d0
    plain_logits, plain = run("dense")
    scale = plain_logits.abs().max().item()
    assert (fast_logits - plain_logits).abs().max().item() <= 5e-2 * scale
    assert np.abs(fast.first_logits - plain.first_logits).max() <= 5e-2 * scale


def _head_case(gen, M, H, V):
    x = torch.randn(M, H, generator=gen, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(V, H, generator=gen, device="cuda")).to(torch.bfloat16)
    y = torch.randint(0, V, (M,), generator=gen, device="cuda", dtype=torch.int32)
    return x, w, y, torch.randn(M, generator=gen, device="cuda")


def _grad_close(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    bad = (got - ref).abs() - (2 ** -6 * ref.abs() + 1e-5 * ref.abs().max())
    assert bad.max().item() <= 0, bad.max().item()


@pytest.mark.parametrize("M,H,V", [
    (2046, 4096, 32000),  # the 7B train step's head
    (2046, 1024, 32000),  # H <= 2048: the TPU's single-pass row 13
    (130, 4096, 32001),   # ragged rows and one valid column in the last tile
    (77, 128, 300),       # tiny, every edge ragged
    (1, 64, 64),          # one row, one tile
])
def test_fused_head_kernels_match_plain(gen, M, H, V):
    x, w, y, g = _head_case(gen, M, H, V)
    logp, lse = fused_head_fwd(x, w, y)
    ref_logp, ref_lse = fused_head_fwd_plain(x, w, y)
    assert (logp - ref_logp).abs().max().item() <= 2e-4
    assert (lse - ref_lse).abs().max().item() <= 2e-4
    dx, dw = fused_head_bwd(x, w, y, ref_lse, g)
    ref_dx, ref_dw = fused_head_bwd_plain(x, w, y, ref_lse, g)
    assert dx.shape == x.shape and dw.shape == w.shape
    _grad_close(dx, ref_dx)
    _grad_close(dw, ref_dw)
    # no atomics: a rerun gives the same bits
    assert torch.equal(fused_head_bwd(x, w, y, ref_lse, g)[1], dw)
    assert torch.equal(fused_head_fwd(x, w, y)[0], logp)


def test_fused_head_autograd_counts_its_launches(gen):
    x, w, y, g = _head_case(gen, 300, 256, 1000)
    x.requires_grad_(True)
    w.requires_grad_(True)
    n0 = (fused_target_logp.fwd_launches, fused_target_logp.dx_launches,
          fused_target_logp.dw_launches)
    (fused_target_logp(x.view(3, 100, 256), w, y.view(3, 100)).reshape(-1) * g).sum().backward()
    assert (fused_target_logp.fwd_launches - n0[0], fused_target_logp.dx_launches - n0[1],
            fused_target_logp.dw_launches - n0[2]) == (1, 1, 1)
    _, lse = fused_head_fwd_plain(x.detach(), w.detach(), y)
    ref_dx, ref_dw = fused_head_bwd_plain(x.detach(), w.detach(), y, lse, g)
    _grad_close(x.grad, ref_dx)
    _grad_close(w.grad, ref_dw)
    with pytest.raises(TypeError):
        fused_head_fwd(x.detach().float(), w.detach(), y)
    with pytest.raises(ValueError):
        fused_head_fwd(x.detach()[:, :100], w.detach()[:, :100], y)
