"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test skips. On the card
(`--noconftest`: tests/conftest.py imports jax, which the port never needs):

    python -m pytest -m cuda tests/test_torch_cuda.py --noconftest -q

bf16 inputs; outputs are checked as |kernel - plain| <= 1e-2 + 1e-2 |plain|
(each side rounds once to bf16, and the flash kernel rounds its
probabilities to bf16 for the P.V product), lse at 1e-3 abs (fp32).
"""
import pytest
import torch

from rlaifv_tpu_torch.ops.decode_attention import (
    decode_attention_prefix,
    decode_attention_prefix_ref,
)
from rlaifv_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

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
