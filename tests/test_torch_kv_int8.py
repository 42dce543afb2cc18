"""The port's int8-KV serving path against the JAX package's, on the CPU.

Kernel #5's plain twin (`decode_attention_prefix_int8_ref`) against the JAX
`decode_attention_prefix_int8(..., interpret=True)` on the same seeded
inputs: rel <= 1e-5 of max|out| (fp32; the integer sums are exact on both
sides and the divisions IEEE, so only exp and the fp32 sum order differ:
read ~3e-7). The cache quantiser copies match bit for bit.

The model: a tiny LLaVA with int8 weights, fused projections and an int8
KV cache, bridged from the JAX tree `fuse_llm_projections(
quantize_llm_int8(...))`. Both packages run the off-TPU formula on the CPU
(QuantDense dequantised, decode attention dense over the dequantised
cache), so prefill and decode logits agree to fp32 rounding (atol 1e-4, as
tests/test_torch_models.py), greedy tokens are equal, and the scoring paths,
which run on a bf16 (here fp32) cache whatever the serving cache type,
equal the float-cache model's results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.genai.llava_gen import Llava15Generator as JGenerator
from rlaifv_tpu.models.convert import fuse_llm_projections, quantize_llm_int8
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu.ops import decode_attention as jd
from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
from rlaifv_tpu_torch.models.convert import load_jax_params
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from rlaifv_tpu_torch.ops import decode_attention as td
from tests.fake_tokenizer import FakeTokenizer

ATOL = 1e-4
TWIN_RTOL = 1e-5
SERVE = dict(quantize=True, quantize_lm_head=False, fuse_proj=True, kv_cache_dtype="int8")


def _cache_inputs(seed, B, L, H, KVH, D, valid_len):
    """q (B, H, D), a quantised (B, L, KVH, D) cache and a mask with a
    left-padded row and a right-truncated one."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kq, ks = jd.quantize_kv(jnp.asarray(rng.normal(size=(B, L, KVH, D)), jnp.float32))
    vq, vs = jd.quantize_kv(jnp.asarray(rng.normal(size=(B, L, KVH, D)), jnp.float32))
    mask = np.ones((B, L), np.int32)
    mask[0, :7] = 0
    mask[-1, max(valid_len // 2, 1):] = 0
    arrays = [q, *(np.asarray(a) for a in (kq, ks, vq, vs)), mask]
    return arrays, [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("B,L,H,KVH,D,valid_len", [
    (2, 256, 8, 4, 128, 256),  # block 256, n_rep 2
    (2, 384, 8, 8, 128, 300),  # L % 256 != 0: block 128, a partial last block
    (3, 512, 4, 4, 64, 137),  # D 64, two of the four blocks read
    (2, 256, 8, 4, 128, 1),  # one live column
])
def test_twin_matches_jax_interpret(B, L, H, KVH, D, valid_len):
    (q, kq, ks, vq, vs, mask), targs = _cache_inputs(0, B, L, H, KVH, D, valid_len)
    want = np.asarray(jd.decode_attention_prefix_int8(
        *(jnp.asarray(a) for a in (q, kq, ks, vq, vs, mask)), jnp.int32(valid_len),
        interpret=True))
    got = td.decode_attention_prefix_int8(*targs, valid_len)
    assert td.prefix_block_l(L) == (256 if L % 256 == 0 else 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TWIN_RTOL * np.abs(want).max())
    assert td.decode_attention_prefix_int8.launches == 0  # CPU tensors: the twin


def test_twin_reads_only_live_blocks_and_zeroes_dead_rows():
    """Columns past the last live block never reach the result (NaN scales
    there change nothing); a row whose live keys are all masked outputs 0;
    the twin stays within the JAX test's 3.5% of the dequantised dense
    formula, the quantisation of q and p being the only difference."""
    _, (q, kq, ks, vq, vs, mask) = _cache_inputs(1, 2, 512, 8, 4, 64, 200)
    mask[1] = 0
    mask[1, 300:] = 1  # live only past the read blocks
    got = td.decode_attention_prefix_int8_ref(q, kq, ks, vq, vs, mask, 200)
    ks2, vs2 = ks.clone(), vs.clone()
    ks2[:, 256:], vs2[:, 256:] = float("nan"), float("nan")
    assert torch.equal(td.decode_attention_prefix_int8_ref(q, kq, ks2, vq, vs2, mask, 200), got)
    assert (got[1] == 0).all()
    mask[1] = 0
    mask[1, :100] = 1
    mask[:, 256:] = 0  # the dense formula reads every column
    got = td.decode_attention_prefix_int8_ref(q, kq, ks, vq, vs, mask, 256)
    dense = td.decode_attention_prefix_int8_dense(q, kq, ks, vq, vs, mask)
    rel = ((got - dense).abs().max() / dense.abs().max()).item()
    assert rel < 0.035, rel


def test_quantize_kv_copies_bit_for_bit_from_bf16():
    """The model's k/v are bf16 on the card (fp32 inputs:
    tests/test_torch_data_copies.py)."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 16, 4, 32)) * 3).astype(np.float32)
    x[0, 3] = 0  # the 1e-20 floor
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    jq, js = jd.quantize_kv(jx)
    tq, ts = td.quantize_kv(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.dequantize_kv(tq, ts, torch.float32).numpy(),
                                  np.asarray(jd.dequantize_kv(jq, js, jnp.float32)))


@pytest.fixture(scope="module")
def serving():
    """A tiny LLaVA in the JAX headline serving configuration (int8
    weights, bf16-kept head, fuse_proj, int8 KV) on both sides, the same
    weights; and the port's model with a float cache."""
    jcfg = JLlavaConfig.tiny()
    P, S = jcfg.num_image_tokens, jcfg.vision.image_size
    params = dict(JLlava(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, P + 8), jnp.int32),
        images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([0]))["params"])
    params["llm"] = fuse_llm_projections(quantize_llm_int8(params["llm"],
                                                           include_lm_head=False))
    jmodel = JLlava(JLlavaConfig.tiny(**SERVE))
    tmodel = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny(**SERVE)), params).eval()
    fp = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny(**dict(SERVE, kv_cache_dtype="fp"))),
                         params).eval()
    tok = FakeTokenizer()
    jgen = JGenerator(jmodel, params, tok, P, image_size=S, checkpoint_name="tiny")
    tgen = Llava15Generator(tmodel, tok, P, image_size=S, checkpoint_name="tiny")
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, fp=fp, jgen=jgen, tgen=tgen,
                cfg=jcfg)


def test_int8_cache_layout_and_config(serving):
    cache = serving["tmodel"].llm.init_cache(3, 128)
    cfg = serving["tmodel"].cfg.llm
    assert len(cache) == cfg.num_layers
    assert {k: (tuple(t.shape), t.dtype) for k, t in cache[0].items()} == {
        "k": ((3, 128, cfg.num_kv_heads, cfg.head_size), torch.int8),
        "v": ((3, 128, cfg.num_kv_heads, cfg.head_size), torch.int8),
        "k_scale": ((3, 128, cfg.num_kv_heads), torch.float32),
        "v_scale": ((3, 128, cfg.num_kv_heads), torch.float32)}
    attn = serving["tmodel"].llm.model.layers[0].attn
    assert hasattr(attn, "qkv_proj") and not hasattr(attn, "q_proj")
    assert attn.qkv_proj.q.shape == (cfg.hidden_size, (cfg.num_heads + 2 * cfg.num_kv_heads)
                                     * cfg.head_size)
    assert serving["tmodel"].llm.lm_head.weight.dtype == torch.float32  # head kept float


def test_prefill_and_decode_logits_match_jax(serving):
    """The JAX test_kv_int8 reading: prefill logits, the cache the prefill
    writes, then one decode step over the int8 cache, against the JAX model
    on the same weights (atol 1e-4); the prefill also equals the float-cache
    model's (the fresh-window prefill), and the decode step stays within the
    JAX test's 5% of it."""
    jmodel, params, tmodel = serving["jmodel"], serving["params"], serving["tmodel"]
    rng = np.random.default_rng(3)
    B, Lp, max_len = 2, 11, 128
    ids = rng.integers(3, 200, size=(B, Lp)).astype(np.int32)
    mask = np.zeros((B, max_len), np.int32)
    mask[:, :Lp] = 1
    mask[1, :3] = 0  # a left-padded row
    pos = np.maximum(np.cumsum(mask[:, :Lp], axis=1) - 1, 0).astype(np.int32)

    def jrun(cache, ids, mask, pos, index):
        return jmodel.apply({"params": params}, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                            position_ids=jnp.asarray(pos), cache=cache, cache_index=jnp.int32(index),
                            method=lambda m, *a, **kw: m.llm(*a, **kw))

    def trun(model, cache, ids, mask, pos, index):
        with torch.no_grad():
            return model.llm(torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask),
                             position_ids=torch.from_numpy(pos).long(), cache=cache,
                             cache_index=index)

    jcache = jmodel.apply({"params": params}, B, max_len,
                          method=lambda m, b, n: m.llm.init_cache(b, n))
    want, jcache = jrun(jcache, ids, mask, pos, 0)
    got, tcache = trun(tmodel, tmodel.llm.init_cache(B, max_len), ids, mask, pos, 0)
    fp, fcache = trun(serving["fp"], serving["fp"].llm.init_cache(B, max_len), ids, mask, pos, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), fp.numpy(), atol=ATOL)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_allclose(tcache[1][name].float().numpy(),
                                   np.asarray(jcache[1][name], np.float32), atol=1e-6)

    tok = np.argmax(got[:, -1].numpy(), axis=-1).astype(np.int32)[:, None]
    mask[:, Lp] = 1
    step_pos = mask.sum(axis=1, keepdims=True).astype(np.int32) - 1
    want, _ = jrun(jcache, tok, mask, step_pos, Lp)
    got, _ = trun(tmodel, tcache, tok, mask, step_pos, Lp)
    fp, _ = trun(serving["fp"], fcache, tok, mask, step_pos, Lp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    rel = np.abs(got.numpy() - fp.numpy()).max() / np.abs(fp.numpy()).max()
    assert 0 < rel < 0.05, rel


def _items(cfg, n, same_image=False):
    rng = np.random.default_rng(4)
    S = cfg.vision.image_size
    image = rng.integers(0, 255, size=(S, S, 3), dtype=np.uint8)
    return [{"question": f"Is object {i} present?", "question_id": i,
             "image": image if same_image else rng.integers(0, 255, size=(S, S, 3),
                                                              dtype=np.uint8)}
            for i in range(n)]


def test_generate_and_generate_repeated_match_jax(serving):
    """Greedy tokens of generate (ragged prompts, left padding) and of
    generate_repeated (the copied cache, 3-D scales included) equal the JAX
    engine's; the first logits agree to fp32 rounding."""
    jgen, tgen = serving["jgen"], serving["tgen"]
    prompts, starts, images = tgen._prepare(_items(serving["cfg"], 2))
    prompts[1] = prompts[1][:-3]
    kw = dict(images=images, image_starts=starts, max_new_tokens=6)
    want, got = jgen.engine.generate(prompts, **kw), tgen.engine.generate(prompts, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.first_logits, want.first_logits, atol=ATOL)
    kw = dict(n=3, image=images[0], image_start=int(starts[0]), max_new_tokens=6)
    want = jgen.engine.generate_repeated(prompts[0], **kw)
    got = tgen.engine.generate_repeated(prompts[0], **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.first_logits, want.first_logits, atol=ATOL)


def test_scoring_paths_use_a_float_cache(serving):
    """score_shared_prefix and score_pair_logps on the int8-KV model equal
    the float-cache model's results: both prefill their prefix into a
    float cache (`_fp_cache`), so the suffix sees the live prefix. The JAX
    engine's shared-prefix logits agree too."""
    tgen, cfg = serving["tgen"], serving["cfg"]
    fgen = Llava15Generator(serving["fp"], tgen.tokenizer, tgen.num_patches,
                            image_size=cfg.vision.image_size)
    prompts, starts, images = tgen._prepare(_items(cfg, 3, same_image=True))
    P = int(starts[0]) + tgen.num_patches
    args = (prompts[0][:P], [p[P:] for p in prompts])
    kw = dict(image=images[0], image_start=int(starts[0]), batch_size=2)
    got = tgen.engine.score_shared_prefix(*args, **kw)
    np.testing.assert_allclose(got, fgen.engine.score_shared_prefix(*args, **kw), atol=ATOL)
    np.testing.assert_allclose(got, serving["jgen"].engine.score_shared_prefix(*args, **kw),
                               atol=ATOL)

    rng = np.random.default_rng(5)
    prefixes = [p[:P + 2] for p in prompts[:2]]
    suffixes = [rng.integers(3, 200, size=n).tolist() for n in (5, 3, 4, 6)]
    labels = [[-100] + s[1:] for s in suffixes]
    kw = dict(images=images[:2], image_starts=starts[:2], pair_batch=2)
    got = tgen.engine.score_pair_logps(prefixes, suffixes, labels, **kw)
    want = fgen.engine.score_pair_logps(prefixes, suffixes, labels, **kw)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, atol=ATOL)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_generator_modes_run_on_the_serving_model(serving):
    """autocheck, diverse_gen (generate_repeated) and greedy_gen run on the
    fused int8-KV model; autocheck's probabilities equal the JAX
    generator's."""
    tgen, cfg = serving["tgen"], serving["cfg"]
    items = _items(cfg, 3, same_image=True)
    got = tgen.autocheck(items, batch_size=2)
    want = serving["jgen"].autocheck(items, batch_size=2)
    for a, b in zip(got, want):
        for w in a["scores"]:
            assert abs(a["scores"][w] - b["scores"][w]) < 1e-5
    rows = tgen.diverse_gen([items[0]] * 3, max_new_tokens=4, seed=1)
    assert len(rows) == 3 and all(isinstance(r["answer"], str) for r in rows)
    assert len(tgen.greedy_gen(items[:2], max_new_tokens=4)) == 2


def test_dense_route_and_unknown_cache_type():
    """attn_impl "dense" takes the dequantised dense formula for a decode
    step (the CPU always does); a cache type the JAX package does not know
    raises."""
    from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    with pytest.raises(ValueError, match="kv_cache_dtype"):
        LlamaForCausalLM(LlamaConfig.tiny(kv_cache_dtype="fp8"), device="meta")
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(kv_cache_dtype="int8")).eval()
    dense = LlamaForCausalLM(LlamaConfig.tiny(kv_cache_dtype="int8", attn_impl="dense")).eval()
    dense.load_state_dict(model.state_dict())
    ids = torch.randint(3, 200, (2, 9))
    mask = torch.ones((2, 128), dtype=torch.int32)
    outs = []
    for m in (model, dense):
        cache = m.init_cache(2, 128)
        with torch.no_grad():
            m(ids, attention_mask=mask, cache=cache, cache_index=0)
            outs.append(m(ids[:, :1], attention_mask=mask, cache=cache, cache_index=9)[0])
    torch.testing.assert_close(outs[0], outs[1], atol=1e-6, rtol=0)


# -------------------------------------- kernel #5's key splits and their merge

SPLIT_CASES = [  # (B, L, H, KVH, D, valid_len): at least 5 key blocks each
    (3, 1280, 8, 8, 128, 1250),  # block 256, n_rep 1
    (3, 640, 16, 4, 64, 640),    # L % 256 != 0: block 128; n_rep 4, D 64
    (3, 640, 8, 1, 64, 577),     # block 128, n_rep 8, a partial last block
]


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
@pytest.mark.parametrize("B,L,H,KVH,D,valid_len", SPLIT_CASES)
def test_split_twin_matches_twin_and_jax(B, L, H, KVH, D, valid_len, splits):
    """`decode_attention_prefix_int8_split_ref`, kernel #5 as the card
    splits its key blocks, against the sequential twin and the JAX
    `decode_attention_prefix_int8(..., interpret=True)`. Row 0 has a split
    whose blocks are all masked (the second, where there are two or more),
    row 1 is masked everywhere (exactly 0), row 2 sees one column. At one
    split the split twin is the sequential twin bit for bit. Otherwise each
    split starts its own running max, so the early blocks of a later split
    quantise p under another max: a p8 on a half-integer can move by one
    step, ~1/127 of its block's largest share, and the merge rounds in
    another order; both sides stay within 2^-7 max|out| (3f's bound on the
    card), and the JAX kernel within TWIN_RTOL where nothing was split."""
    (q, kq, ks, vq, vs, mask), targs = _cache_inputs(3, B, L, H, KVH, D, valid_len)
    bl = td.prefix_block_l(L)
    n_blocks = -(-valid_len // bl)
    assert n_blocks >= 5
    ranges = td.prefix_int8_split_blocks(n_blocks, splits)
    mask[:] = 1
    if splits > 1:
        j0, j1 = ranges[1]
        mask[0, j0 * bl:j1 * bl] = 0
    mask[1] = 0
    mask[2] = 0
    mask[2, 5] = 1
    targs[-1] = torch.from_numpy(mask.copy())
    want = np.asarray(jd.decode_attention_prefix_int8(
        *(jnp.asarray(a) for a in (q, kq, ks, vq, vs, mask)), jnp.int32(valid_len),
        interpret=True))
    seq = td.decode_attention_prefix_int8_ref(*targs, valid_len)
    got = td.decode_attention_prefix_int8_split_ref(*targs, valid_len, splits)
    assert (got[1] == 0).all() and (seq[1] == 0).all()
    bound = 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(seq.numpy(), want, rtol=0, atol=TWIN_RTOL * np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=0, atol=bound)
    if splits == 1:
        assert torch.equal(got, seq)
    # row 2's one column: its value row, wherever the split holds it
    np.testing.assert_allclose(got[2].numpy(), seq[2].numpy(), rtol=0, atol=bound)


def test_split_twin_at_one_live_column_and_a_dead_split():
    """valid_len 1 is one block, hence one split; a split past every live
    key (all its keys masked) adds nothing: equal to the twin over the
    other splits' blocks alone."""
    _, targs = _cache_inputs(4, 2, 1024, 8, 2, 128, 1)
    assert torch.equal(td.decode_attention_prefix_int8_split_ref(*targs, 1, 1),
                       td.decode_attention_prefix_int8_ref(*targs, 1))
    with pytest.raises(ValueError):
        td.decode_attention_prefix_int8_split_ref(*targs, 1, 2)
    _, (q, kq, ks, vq, vs, mask) = _cache_inputs(5, 2, 1024, 8, 2, 128, 1024)
    mask[:] = 1
    mask[:, 512:] = 0  # the second of two splits sees no key
    got = td.decode_attention_prefix_int8_split_ref(q, kq, ks, vq, vs, mask, 1024, 2)
    assert torch.equal(got, td.decode_attention_prefix_int8_ref(q, kq, ks, vq, vs, mask, 512))


@pytest.mark.parametrize("B,KVH,n_blocks,n_rep,want", [
    (8, 8, 9, 4, 4),      # the int8 Llama3-8B backend's decode step (L 2304): 256 CTAs
    (10, 32, 7, 1, 1),    # phase 11's diverse_gen: 320 CTAs fill the wave already
    (24, 32, 4, 1, 1),    # the batch-24 headline
    (4, 32, 7, 1, 2),     # greedy_gen's 4 rows
    (3, 8, 3, 4, 3),      # few blocks: one split a block
    (8, 8, 1, 8, 1),      # one block: no split
    (1, 1, 300, 8, 264),  # one (row, head): a wave of splits
    (200, 32, 9, 2, 1),
])
def test_prefix_int8_plan(B, KVH, n_blocks, n_rep, want):
    """Kernel #5 splits its key blocks only while B x KVH CTAs do not fill
    one wave of two CTAs an SM (132 SMs), at most one split a block; the
    ranges cover the blocks once, in order."""
    splits = td.prefix_int8_plan(B, KVH, n_blocks, 132, n_rep)
    assert splits == want
    ranges = td.prefix_int8_split_blocks(n_blocks, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_blocks
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:] + [(n_blocks,)]))
    assert td.prefix_int8_plan(B, KVH, n_blocks, 1, n_rep) == max(1, min(n_blocks, 2 // (B * KVH)))
    with pytest.raises(ValueError):
        td.prefix_int8_plan(B, KVH, n_blocks, 132, 3)
