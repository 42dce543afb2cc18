"""Fused projections (`fuse_proj`) in the port, against the JAX package's
tree rewrite, on the CPU.

`fuse_llm_projections_` on a port model gives the state dict that bridging
the JAX `fuse_llm_projections` tree gives, bit for bit, for float, int8 and
int4 weights (the out-axis concatenation is exact, scales included), and
quantising after fusing equals fusing after quantising. A fused model
computes what the separate projections compute (the same per-column sums:
atol 1e-5 in fp32), in the cached forward and in the shared-prefix paired
forward of the train step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.models.convert import (
    fuse_llm_projections,
    quantize_llm_int4,
    quantize_llm_int8,
)
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu_torch.models import convert
from rlaifv_tpu_torch.models.llama import LlamaAttention, LlamaMLP
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from rlaifv_tpu_torch.train.lora import attach_lora, lora_init, lora_scaled
from rlaifv_tpu_torch.train.paired_forward import paired_hidden

ATOL = 1e-5
KINDS = {  # weights -> (the JAX quantiser of the LLM tree, the port's config)
    "float": (None, {}),
    "int8": (quantize_llm_int8, dict(quantize=True)),
    "int4": (quantize_llm_int4, dict(quantize=True, quantize_bits=4, quantize_lm_head=False)),
}


@pytest.fixture(scope="module")
def params():
    jcfg = JLlavaConfig.tiny()
    P, S = jcfg.num_image_tokens, jcfg.vision.image_size
    return JLlava(jcfg).init(
        jax.random.PRNGKey(1), jnp.ones((1, P + 8), jnp.int32),
        images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([0]))["params"]


def _tree(params, kind, fused=False):
    quantizer, _ = KINDS[kind]
    tree = dict(params)
    if quantizer is not None:
        tree["llm"] = quantizer(tree["llm"])
    if fused:
        tree["llm"] = fuse_llm_projections(tree["llm"])
    return tree


def _model(params, kind, fused=False, **kw):
    cfg = LlavaConfig.tiny(fuse_proj=fused, **KINDS[kind][1], **kw)
    return convert.load_jax_params(LlavaForCausalLM(cfg), _tree(params, kind, fused)).eval()


@pytest.mark.parametrize("kind", list(KINDS))
def test_fuse_in_place_equals_the_bridged_jax_fused_tree(params, kind):
    fused = convert.fuse_llm_projections_(_model(params, kind))
    want = _model(params, kind, fused=True).state_dict()
    got = fused.state_dict()
    assert set(got) == set(want)
    assert any(".qkv_proj." in k for k in got) and any(".gate_up_proj." in k for k in got)
    assert not any(".q_proj." in k or ".up_proj." in k for k in got if k.startswith("llm."))
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    assert fused.cfg.llm.fuse_proj
    assert all(m.cfg.fuse_proj for m in fused.modules()
               if isinstance(m, (LlamaAttention, LlamaMLP)))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantise_after_fusing_equals_fusing_after_quantising(params, bits):
    quantize = convert.quantize_llm_int8 if bits == 8 else convert.quantize_llm_int4
    a = quantize(convert.fuse_llm_projections_(_model(params, "float")))
    b = convert.fuse_llm_projections_(quantize(_model(params, "float")))
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb) and "llm.model.layers.0.attn.qkv_proj.q" in sa
    for name, t in sa.items():
        assert torch.equal(t, sb[name]), name
    assert a.cfg.llm == b.cfg.llm and a.cfg.llm.quantize_bits == bits


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_fused_model_computes_the_separate_projections(params, kind):
    """Prefill into a cache and two decode steps: the fused model's logits
    equal the separate projections' (float cache)."""
    models = [_model(params, kind), _model(params, kind, fused=True)]
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, 200, size=(2, 12))).long()
    mask = torch.zeros((2, 16), dtype=torch.int32)
    mask[:, :10] = 1
    mask[1, :2] = 0
    outs = []
    for m in models:
        cache = m.llm.init_cache(2, 16)
        with torch.no_grad():
            run = [m.llm(ids[:, :10], attention_mask=mask, cache=cache, cache_index=0)[0]]
            for t in (10, 11):
                mask[:, t] = 1
                run.append(m.llm(ids[:, t:t + 1], attention_mask=mask, cache=cache,
                                 cache_index=t)[0])
        mask[:, 10:] = 0
        outs.append(run)
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=ATOL, rtol=0)


def test_fused_paired_forward_matches_the_separate_one(params):
    """The train step's shared-prefix paired forward over a fused model
    (one qkv_proj, one gate_up_proj per layer) against the same weights
    unfused, hidden states and the gradients of the embeddings."""
    models = [_model(params, "float"), _model(params, "float", fused=True)]
    rng = np.random.default_rng(1)
    Dm = models[0].cfg.llm.hidden_size
    xp0 = torch.from_numpy(rng.normal(size=(2, 9, Dm)).astype(np.float32))
    xs0 = torch.from_numpy(rng.normal(size=(4, 5, Dm)).astype(np.float32))
    pmask = torch.ones((2, 9), dtype=torch.int32)
    pmask[1, -2:] = 0
    smask = torch.cat([torch.cat([pmask, pmask]), torch.ones((4, 5), dtype=torch.int32)], 1)
    outs = []
    for m in models:
        xp, xs = xp0.clone().requires_grad_(True), xs0.clone().requires_grad_(True)
        hp, hs = paired_hidden(m.llm.model, xp, xs, pmask, smask, suffix_pos_start=7)
        (hp.square().sum() + hs.square().sum()).backward()
        outs.append((hp.detach(), hs.detach(), xp.grad, xs.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-5)


def test_fusing_refuses_attached_adapters(params):
    model = _model(params, "float")
    lora = lora_init(torch.Generator().manual_seed(0), model, r=4)
    attach_lora(model, lora_scaled(lora))
    with pytest.raises(ValueError, match="LoRA"):
        convert.fuse_llm_projections_(model)
