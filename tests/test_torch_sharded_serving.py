"""Tensor-parallel serving in the port (parallel/sharding.py + genai/engine.py)
against tests/test_sharded_serving.py's JAX cases, on the CPU over gloo.

tests/torch_serving_worker.py runs each world once, all of its jobs in that
one spawn (as tests/test_torch_mesh_train.py spawns its worker): the port's
DecodeEngine over the tiny models, the JAX init bridged into the port,
sharded by `shard_params` at (1, 1, 2) and (1, 1, 4); the quantised
models are quantised whole in the port first, then split.

World 2, the five JAX cases on their tiny configs: fp32 `generate`
(tokens and lengths equal, first_logits within rtol/atol 2e-5, against
both the JAX single-device engine and the JAX engine sharded on the
8-device virtual CPU mesh), packed-int4 `generate`, `generate_continuous`,
3-beam `generate_beam` (the JAX step moved to the greedy columns, as
tests/test_torch_beam.py does) and the LLaVA multimodal `generate`:
tokens and lengths equal to the JAX single-device engine. Further: int8
weights with an int8 cache, `score_shared_prefix`, one seeded sampled
`generate` (equal on both ranks), and an int4 config whose K holds whole
groups at tp 2 (hidden 256 / intermediate 512, G 128), so that the
row-parallel int4 split runs. World 4 on the tiny Llama (2 KV heads): the
attention stays gathered (the cache at the global KV heads) and the int4
row projections, one group each, stay whole; fp32 and int4 tokens equal to
JAX. In every run both ranks' outputs are equal bit for bit and every tp
shard of a QuantDense gathers back to the whole model's integers and
scales. Pins: `fused_decode=True` over tp raises ValueError, the int4 split
rule (`sharding.int4_splits_on_k`), and a planted fault (one layer's
row-parallel sum left out on rank 0) that the check against JAX must
catch.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.genai import beam as jbeam
from rlaifv_tpu.genai.engine import DecodeEngine as JEngine
from rlaifv_tpu.genai.sampling import SamplingParams as JSampling
from rlaifv_tpu.models import convert as jconvert
from rlaifv_tpu.models.llama import LlamaConfig as JLlamaConfig
from rlaifv_tpu.models.llama import LlamaForCausalLM as JLlama
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu.parallel import sharding as jsh
from rlaifv_tpu_torch.models.convert import load_jax_params, quantize_int4_torch
from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from rlaifv_tpu_torch.ops.int4_matmul import dequantize_int4, pack_int4, unpack_int4
from rlaifv_tpu_torch.parallel import sharding as tsh

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_serving_worker.py"
TIMEOUT = 300
RTOL = ATOL = 2e-5  # tests/test_sharded_serving.py's first_logits tolerance
WIDE = dict(hidden_size=256, intermediate_size=512)


def _prompts(vocab, n=3):
    """tests/test_sharded_serving.py's prompts."""
    rng = np.random.default_rng(11)
    return [list(map(int, rng.integers(5, vocab - 1, size=k))) for k in (5, 8, 3)[:n]]


PROMPTS = _prompts(256)
GEN = dict(max_new_tokens=6, prompt_bucket=8)
CONT = dict(slots=2, max_new_tokens=5, prompt_bucket=8)
BEAM = dict(num_beams=3, max_new_tokens=5, prompt_bucket=8)
SAMPLED = dict(max_new_tokens=8, prompt_bucket=8, seed=3)
PREFIX = [7, 9, 11, 13, 15, 17]
SUFFIXES = [[20, 21], [30], [40, 41, 42], [50, 51]]


def _llava_inputs():
    """tests/test_sharded_serving.py's multimodal prompts and images."""
    cfg = JLlavaConfig.tiny()
    rng = np.random.default_rng(5)
    T = cfg.num_image_tokens
    prompts = []
    for k in (6, 4):
        p = list(map(int, rng.integers(5, cfg.llm.vocab_size - 1, size=k)))
        prompts.append(p[:1] + [0] * T + p[1:])
    S = cfg.vision.image_size
    images = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    return prompts, images, dict(image_starts=[1, 1], max_new_tokens=4, prompt_bucket=8)


def _job(name, family, method, args, kwargs=None, **extra):
    return dict(name=name, family=family, method=method, args=args, kwargs=kwargs or {},
                **extra)


def _jobs():
    lp, images, lkw = _llava_inputs()
    world2 = [
        _job("float", "llama", "generate", [PROMPTS], GEN),
        _job("int4", "llama", "generate", [PROMPTS], GEN, bits=4),
        _job("continuous", "llama", "generate_continuous", [PROMPTS], CONT),
        _job("beam", "llama", "generate_beam", [PROMPTS[:2]], BEAM),
        _job("llava", "llava", "generate", [lp], dict(images=images, **lkw)),
        _job("int8_kv", "llama", "generate", [PROMPTS], GEN, bits=8,
             cfg=dict(kv_cache_dtype="int8")),
        _job("prefix", "llama", "score_shared_prefix", [PREFIX, SUFFIXES]),
        _job("sampled", "llama", "generate", [PROMPTS],
             dict(sampling=dict(temperature=0.8), **SAMPLED)),
        _job("wide_int4", "llama_wide", "generate", [PROMPTS], GEN, bits=4),
        _job("fused", "llama", "fused", [], bits=8, fuse=True, cfg=dict(kv_cache_dtype="int8")),
        _job("fault", "llama", "generate", [PROMPTS], GEN, fault=True),
    ]
    world4 = [
        _job("float", "llama", "generate", [PROMPTS], GEN),
        _job("int4", "llama", "generate", [PROMPTS], GEN, bits=4),
    ]
    return {2: world2, 4: world4}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, inputs, out):
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, str(WORKER), str(inputs), str(out)], cwd=ROOT,
                             env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _init(model, *args, **kw):
    return model.init(jax.random.PRNGKey(0), *args, **kw)["params"]


def _greedy_columns_beam(orig):
    """The JAX beam_search with its model step at the greedy loop's columns
    (tests/test_torch_beam.py's `greedy_columns`: the port's deliberate
    difference)."""

    def shifted(llm_apply, params, prefill_logits, cache, cache_mask, prompt_len, Lp, **kw):
        def step(params, *, input_ids, attention_mask, position_ids, cache, cache_index):
            mask = attention_mask.at[:, Lp].set(1).at[:, cache_index].set(0)
            return llm_apply(params, input_ids=input_ids, attention_mask=mask,
                             position_ids=position_ids - 1, cache=cache,
                             cache_index=cache_index - 1)

        return orig(step, params, prefill_logits, cache, cache_mask, prompt_len, Lp, **kw)

    return shifted


def _jax_refs(params, wide_params, llava_params):
    """The JAX engines' outputs for every case (single device; the float
    case also sharded on a 2-device mesh)."""
    cfg = JLlamaConfig.tiny()
    eng = lambda c, p: JEngine(JLlama(c), p, eos_id=-1, pad_id=0)  # noqa: E731
    greedy = JSampling.greedy()
    refs = {"float": eng(cfg, params).generate(PROMPTS, sampling=greedy, **GEN)}
    mesh = jsh.create_mesh(dp=1, fsdp=1, tp=2, devices=jax.devices()[:2])
    sharded = JEngine(JLlama(cfg), jsh.shard_params(params, mesh), eos_id=-1, pad_id=0)
    with mesh:
        refs["float_jax_tp2"] = sharded.generate(PROMPTS, sampling=greedy, **GEN)
    q4 = dict(quantize=True, quantize_bits=4, quantize_lm_head=False)
    refs["int4"] = eng(JLlamaConfig.tiny(**q4), jax.tree.map(
        jnp.asarray, jconvert.quantize_llm_int4(params))).generate(
            PROMPTS, sampling=greedy, **GEN)
    refs["wide_int4"] = eng(JLlamaConfig.tiny(**WIDE, **q4), jax.tree.map(
        jnp.asarray, jconvert.quantize_llm_int4(wide_params))).generate(
            PROMPTS, sampling=greedy, **GEN)
    refs["int8_kv"] = eng(JLlamaConfig.tiny(quantize=True, kv_cache_dtype="int8"),
                          jax.tree.map(jnp.asarray, jconvert.quantize_llm_int8(params))
                          ).generate(PROMPTS, sampling=greedy, **GEN)
    refs["continuous"] = eng(cfg, params).generate_continuous(PROMPTS, sampling=greedy,
                                                              **CONT)
    orig = jbeam.beam_search
    jbeam.beam_search = _greedy_columns_beam(orig)
    try:
        refs["beam"] = eng(cfg, params).generate_beam(PROMPTS[:2], **BEAM)
    finally:
        jbeam.beam_search = orig
    refs["prefix"] = np.asarray(eng(cfg, params).score_shared_prefix(PREFIX, SUFFIXES),
                                np.float32)
    lp, images, lkw = _llava_inputs()
    refs["llava"] = JEngine(JLlava(JLlavaConfig.tiny()), llava_params, eos_id=-1,
                            pad_id=0).generate(lp, images=images, sampling=greedy, **lkw)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results {world: {job: [rank 0's, rank 1's, ...]}} and
    the JAX references; the workers run while JAX computes."""
    tmp = tmp_path_factory.mktemp("sharded_serving")
    params = _init(JLlama(JLlamaConfig.tiny()), jnp.ones((1, 8), jnp.int32))
    wide_params = _init(JLlama(JLlamaConfig.tiny(**WIDE)), jnp.ones((1, 8), jnp.int32))
    lcfg = JLlavaConfig.tiny()
    S = lcfg.vision.image_size
    llava_params = _init(JLlava(lcfg), jnp.ones((1, lcfg.num_image_tokens + 8), jnp.int32),
                         images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([0]))
    jobs = _jobs()
    inputs = {
        "llama": load_jax_params(LlamaForCausalLM(LlamaConfig.tiny()), params).state_dict(),
        "llama_wide": load_jax_params(LlamaForCausalLM(LlamaConfig.tiny(**WIDE)),
                                      wide_params).state_dict(),
        "llava": load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()),
                                 llava_params).state_dict(),
        "jobs": jobs,
    }
    torch.save(inputs, tmp / "inputs.pt")
    procs = {}
    for world in jobs:
        (tmp / str(world)).mkdir()
        procs[world] = _spawn(world, tmp / "inputs.pt", tmp / str(world))
    refs = _jax_refs(params, wide_params, llava_params)
    out = {}
    for world, ps in procs.items():
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in ps]
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"world {world} rank {r}:\n{logs[r][-4000:]}"
        out[world] = {job["name"]: [torch.load(tmp / str(world) / f"{job['name']}.rank{r}.pt",
                                               weights_only=False) for r in range(world)]
                      for job in jobs[world]}
    return out, refs


def problems(ranks, want, logits: bool = False) -> list:
    """What keeps a tp run from passing: the ranks' outputs not equal bit
    for bit, a QuantDense shard that does not gather back to the whole
    model's, tokens or lengths not JAX's, and with `logits` the first
    logits outside rtol/atol 2e-5 of JAX's."""
    out, got = [], ranks[0]
    for r, other in enumerate(ranks[1:], 1):
        for key in ("tokens", "lengths", "first_logits", "logits"):
            if key in got and not np.array_equal(got[key], other[key]):
                out.append(f"rank {r}'s {key} differ from rank 0's")
    if not all(r["quant_exact"] for r in ranks):
        out.append("a tp shard's q/scale is not the whole model's")
    if "logits" in got:
        if not np.allclose(got["logits"], want, rtol=RTOL, atol=ATOL):
            out.append(f"logits off by {np.abs(got['logits'] - want).max()}")
        return out
    for key in ("tokens", "lengths"):
        if not np.array_equal(got[key], np.asarray(getattr(want, key))):
            out.append(f"{key} {got[key].tolist()} against JAX's "
                       f"{np.asarray(getattr(want, key)).tolist()}")
    if logits:
        w = np.asarray(want.first_logits, np.float32)
        if not np.allclose(got["first_logits"], w, rtol=RTOL, atol=ATOL):
            out.append(f"first_logits off by {np.abs(got['first_logits'] - w).max()}")
    return out


def test_float_generate_matches_jax_single_and_sharded(runs):
    out, refs = runs
    got = out[2]["float"]
    assert problems(got, refs["float"], logits=True) == []
    assert problems(got, refs["float_jax_tp2"], logits=True) == []
    assert got[0]["kv_heads"] == 1  # the cache holds this rank's one KV head of 2


@pytest.mark.parametrize("case", ["int4", "continuous", "beam", "llava", "int8_kv",
                                  "wide_int4", "prefix"])
def test_tp2_case_matches_jax(runs, case):
    out, refs = runs
    assert problems(out[2][case], refs[case]) == []


def test_llava_vision_tower_and_heads_split(runs):
    out, _ = runs
    got = out[2]["llava"][0]
    assert got["kv_heads"] == 1
    assert "vision_tower.layers.0.attn.q_proj" in got["split"]
    assert "vision_tower.layers.0.fc2" in got["split"]


def test_wide_int4_splits_its_rows_and_tiny_int4_keeps_them_whole(runs):
    """The group rule on the runs: at hidden 256 / intermediate 512 (G 128)
    the row-parallel int4 projections split at tp 2 and the cache holds the
    local head; on the tiny Llama (K 64 and 128: one group each) they stay
    whole, so the attention is gathered and the cache holds both heads."""
    out, _ = runs
    wide, tiny = out[2]["wide_int4"][0], out[2]["int4"][0]
    assert {"model.layers.0.attn.o_proj", "model.layers.0.mlp.down_proj"} <= set(wide["split"])
    assert wide["kv_heads"] == 1
    assert "model.layers.0.attn.o_proj" not in tiny["split"]
    assert "model.layers.0.mlp.down_proj" not in tiny["split"]
    assert "model.layers.0.attn.q_proj" in tiny["split"] and tiny["kv_heads"] == 2


def test_sampled_tokens_equal_on_both_ranks(runs):
    out, _ = runs
    a, b = out[2]["sampled"]
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["first_logits"], b["first_logits"])


@pytest.mark.parametrize("case", ["float", "int4"])
def test_tp4_keeps_two_kv_heads_whole(runs, case):
    """(1, 1, 4): 2 KV heads do not split over 4, so the attention takes the
    gathered route and the cache holds both heads; the tiny int4 row
    projections (one group) stay whole."""
    out, refs = runs
    got = out[4][case]
    assert problems(got, refs[case]) == []
    assert all(r["kv_heads"] == 2 for r in got)
    assert "model.layers.0.mlp.gate_proj" in got[0]["split"]
    assert ("model.layers.0.mlp.down_proj" in got[0]["split"]) == (case == "float")


def test_fused_decode_over_tp_raises(runs):
    out, _ = runs
    for r in out[2]["fused"]:
        assert r["error"] and "unsharded" in r["error"]


def test_planted_fault_is_caught(runs):
    """Rank 0 keeps its partial product in layer 0's o projection. The
    check against JAX must fail on it; the ranks' outputs stay equal (the
    next row-parallel sum and the gathered head leave both ranks the same
    logits), so equality across ranks alone would not catch it."""
    out, refs = runs
    found = problems(out[2]["fault"], refs["float"], logits=True)
    assert any(p.startswith("tokens") for p in found), found
    assert any(p.startswith("first_logits off") for p in found), found
    assert problems(out[2]["float"], refs["float"], logits=True) == []


@pytest.mark.parametrize("K,G,tp,splits", [
    (64, 64, 2, False),  # the tiny o_proj: one group
    (256, 128, 2, True), (256, 128, 4, False),
    (4096, 128, 4, True),  # the 7B o/q projections' K
    (11008, 128, 2, True), (11008, 128, 4, False),  # the 7B down_proj: 86 groups
])
def test_int4_split_rule(K, G, tp, splits):
    """`int4_splits_on_k`: K splits over tp only in whole groups. Where it
    does, a rank's slice of the packed rows and group scales dequantises
    to its contiguous K slice of the whole weight."""
    from rlaifv_tpu_torch.models.llama import QuantDense

    mod = QuantDense(K, 256, dtype=torch.float32, bits=4, device="meta")
    assert mod.scale.shape[0] == K // G
    assert tsh.int4_splits_on_k(mod, tp) == splits
    if K > 256 or not splits:
        return
    w = torch.randn(K, 256, generator=torch.Generator().manual_seed(0))
    q, scale = quantize_int4_torch(w, G)
    whole = dequantize_int4(q, scale)
    for rank in range(tp):
        t = tsh.TensorParallel(None, rank, tp, 1, [K], True)
        part = dequantize_int4(t.local(q, 0), t.local(scale, 0))
        assert torch.equal(part, whole[rank * K // tp:(rank + 1) * K // tp])


def test_int4_packed_rows_are_not_a_k_slice_inside_a_group():
    """Why the rule: in the tiny o_proj (K 64, one group of 64) the first
    half of the packed rows holds K rows 0-15 and 32-47, not 0-31."""
    rows = np.repeat(np.arange(64, dtype=np.int8)[:, None] % 15 - 7, 4, axis=1)
    packed = torch.from_numpy(pack_int4(rows, 64))
    half = unpack_int4(packed[:16], 32).numpy()  # what rank 0 would hold
    np.testing.assert_array_equal(half, rows[np.r_[0:16, 32:48]])
    assert not np.array_equal(half, rows[:32])


def test_tp_modules_follow_the_group_rule_on_the_7b_shapes():
    """The plan itself at the 7B widths (one layer on the meta device):
    int4 at tp 2 splits every projection with local heads; at tp 4 the
    down projection (86 groups) stays whole, so the MLP is gathered."""
    model = LlamaForCausalLM(LlamaConfig.vicuna_7b(
        num_layers=1, quantize=True, quantize_bits=4, quantize_lm_head=False), device="meta")
    for tp, down_split in ((2, True), (4, False)):
        specs = tsh.param_specs(model, (1, 1, tp))
        mods = tsh._tp_modules(model, specs, tp)
        assert ("model.layers.0.mlp.down_proj" in mods) == down_split
        assert mods["model.layers.0.mlp.up_proj"][1] == down_split  # local only in pairs
        assert mods["model.layers.0.attn.o_proj"][:2] == (1, True)
        assert mods["model.layers.0.attn.q_proj"][:2] == (0, True)


@pytest.mark.parametrize("bits", [8, 4])
def test_row_parallel_quant_slices_hold_the_whole_kernels_integers(bits):
    """A row-parallel QuantDense's tp slices (`_split_quant`) are the rows
    of the kernel quantised whole: q's K rows (int4: the packed K/2 rows
    and the group scales with them; int8: the per-column scale whole), so
    the ranks' products over their K slices, summed, are one process's
    product of the dequantised weight. Each rank quantises its activation
    rows over its own K slice on the card (a deliberate difference)."""
    from types import SimpleNamespace

    from rlaifv_tpu_torch.models.convert import quantize_kernel_int8_torch
    from rlaifv_tpu_torch.models.llama import QuantDense, quant_product

    K, N, M, tp = 512, 256, 6, 2
    g = torch.Generator().manual_seed(0)
    w = 0.02 * torch.randn(K, N, generator=g)
    x = torch.randn(M, K, generator=g)
    q, s = quantize_int4_torch(w) if bits == 4 else quantize_kernel_int8_torch(w)
    total = 0
    for rank in range(tp):
        mod = QuantDense(K, N, dtype=torch.float32, bits=bits, device="cpu")
        mod.q, mod.scale = q.clone(), s.clone()
        t = tsh.TensorParallel(None, rank, tp, 1, [K], True)
        tsh._split_quant(mod, t, "p", SimpleNamespace(tp_dims={}))
        rows = q.shape[0] // tp
        assert mod.in_features == K // tp and mod.out_features == N
        assert torch.equal(mod.q, q[rank * rows:(rank + 1) * rows])
        assert torch.equal(mod.scale, s if bits == 8 else
                           s[rank * s.shape[0] // tp:(rank + 1) * s.shape[0] // tp])
        total = total + quant_product(t.local(x, 1), mod.q, mod.scale, bits)
    want = quant_product(x, q, s, bits)
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)
