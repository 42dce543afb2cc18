"""The port's LoRA adapters and QLoRA/LoRA DPO step against the JAX
package's, on the CPU.

One flax param tree of the tiny LLaVA (fp32; for QLoRA its LLM projections
int8, filled as tests/test_lora_collection.py fills them) and one adapter
tree (JAX `lora_init` plus seeded noise, so both a and b are non-zero)
cross to the port with `load_jax_params` and `lora_from_jax`. The same
collated batch then goes through both DPO steps. On the CPU both packages'
int8 projections compute x @ (q * scale) in the activation type, so the
comparison is fp32 against fp32: loss and metrics atol 1e-5, every adapter
gradient atol 1e-5 plus rtol 1e-4 (as tests/test_torch_train.py: sums in
another order). The adapters after one AdamW update: atol 1e-6 plus rtol
1e-5 against optax's update of the port's own gradients and against the
JAX step's adapters wherever |g| > 100 eps. The first Adam step moves an
entry by lr g / (|g| + eps) (lr = 1e-2, eps = 1e-8), so where |g| is near
eps the step follows the gradients' fp32 differences: there the two agree
within one step, lr. Forwards with adapters: atol 1e-5 against the JAX
forward and against the merged weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlaifv_tpu.data.collator import DPOCollator
from rlaifv_tpu.models.llama import LlamaConfig as JLlamaConfig
from rlaifv_tpu.models.llama import LlamaForCausalLM as JLlama
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu.train import lora as jlora
from rlaifv_tpu.train import train_step as jts
from rlaifv_tpu_torch.models.convert import (
    flax_tree,
    llava_params_from_jax,
    load_jax_params,
    lora_from_jax,
)
from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, QuantDense
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from rlaifv_tpu_torch.train import lora as tlora
from rlaifv_tpu_torch.train import train_step as tts
from tests.test_torch_train import _pair

ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5


def _fill_int8(params, seed=7):
    """Random int8 kernels in [-30, 30) and scales x 0.01 (an all-zero base
    would route every adapter gradient through a zero product)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda v: jnp.asarray(rng.integers(-30, 30, size=v.shape),
                                                jnp.int8) if v.dtype == jnp.int8 else v,
                          params)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v * 0.01 if path and getattr(path[-1], "key", "") == "scale"
        and path[-2].key.endswith(("proj", "lm_head")) else v, params)


def _noisy_lora(params, r=4, seed=2, **kw):
    lora = jlora.lora_init(jax.random.PRNGKey(1), params, r=r, **kw)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x + 0.02 * rng.normal(size=x.shape).astype(np.float32),
                        lora)


@pytest.fixture(scope="module")
def batch():
    cfg = JLlavaConfig.tiny()
    rng = np.random.default_rng(7)
    coll = DPOCollator(pad_token_id=0, max_len=48, num_patches=cfg.num_image_tokens,
                       beta=0.1)
    return coll([_pair(rng, cfg.llm.vocab_size, cfg.vision.image_size) for _ in range(3)])


def _jax_llava(quantize, remat=False):
    tiny = JLlavaConfig.tiny()
    return JLlava(JLlavaConfig(
        llm=JLlamaConfig.tiny(quantize=quantize, quantize_lm_head=False, remat=remat),
        vision=tiny.vision))


def _params(batch, quantize):
    params = _jax_llava(quantize).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"][:2]),
        images=jnp.asarray(batch["images"][:2]),
        image_starts=jnp.asarray(batch["image_starts"][:2]))["params"]
    return _fill_int8(params) if quantize else params


def _torch_llava(params, quantize, remat=False):
    cfg = LlavaConfig.tiny(quantize=quantize, quantize_lm_head=False, remat=remat)
    return load_jax_params(LlavaForCausalLM(cfg), params)


def test_target_paths_match_jax(batch):
    """The same kernels get adapters, by the same flax paths, on the float
    and on the int8 base, with the default and with custom rules."""
    for quantize in (False, True):
        params = _params(batch, quantize)
        model = _torch_llava(params, quantize)
        for kw in ({}, dict(target=r"model/.*(q_proj|up_proj)/kernel$"),
                   dict(target=r"(proj|fc\d)/kernel$", exclude=r"lm_head")):
            want = jlora.lora_target_paths(params, **kw)
            assert want, kw
            assert sorted(tlora.lora_target_paths(model, **kw)) == sorted(want)
            assert sorted(tlora.lora_target_paths(flax_tree(model), **kw)) == sorted(want)
        if quantize:
            assert isinstance(model.llm.model.layers[0].attn.q_proj, QuantDense)
            assert model.llm.model.layers[0].attn.q_proj.q.dtype == torch.int8


def test_lora_init_is_kaiming_uniform_with_zero_b(batch):
    model = _torch_llava(_params(batch, True), True)
    lora = tlora.lora_init(torch.Generator().manual_seed(3), model, r=8)
    pairs = dict(tlora.adapter_pairs(lora))
    assert sorted(f"{p}/kernel" for p in pairs) == sorted(tlora.lora_target_paths(model))
    for path, node in pairs.items():
        mod = model.get_submodule(path.replace("/layer_", "/layers/").replace("/", "."))
        fan_in, fan_out = mod.q.shape
        assert node["a"].shape == (fan_in, 8) and node["b"].shape == (8, fan_out)
        assert node["a"].abs().max() <= np.sqrt(6.0 / fan_in) and not node["b"].any()
    again = tlora.lora_init(torch.Generator().manual_seed(3), model, r=8)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tts.named_tensors(lora), tts.named_tensors(again)))


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16-base", "int8-base"])
def test_side_term_matches_jax_and_the_merged_weights(batch, quantize):
    """Adapters attached through lora_scaled give the JAX package's forward
    with its "lora" collection; on the float base also the forward of the
    lora_merge weights (the reference's peft merge)."""
    params = _params(batch, quantize)
    lora = _noisy_lora(params)
    model = _torch_llava(params, quantize).eval()
    ids = np.asarray(batch["input_ids"][:2]).clip(min=0)
    mask = np.asarray(batch["attention_mask"][:2])
    jmodel = _jax_llava(quantize)
    variables = {"params": params, "lora": jlora.lora_scaled(lora, alpha=16.0)}
    want = jmodel.apply(variables, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                        method=lambda m, i, attention_mask: m.llm(
                            i, attention_mask=attention_mask)[0])
    base = jmodel.apply({"params": params}, jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask),
                        method=lambda m, i, attention_mask: m.llm(
                            i, attention_mask=attention_mask)[0])
    tl = lora_from_jax(lora)
    tlora.attach_lora(model, tlora.lora_scaled(tl, alpha=16.0))
    with torch.no_grad():
        got = model.llm(torch.from_numpy(ids).long(),
                        attention_mask=torch.from_numpy(mask))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(jnp.abs(want - base).max()) > 1e-3  # the adapters bite
    tlora.attach_lora(model, None)
    with torch.no_grad():
        got_base = model.llm(torch.from_numpy(ids).long(),
                             attention_mask=torch.from_numpy(mask))[0]
    np.testing.assert_allclose(got_base.numpy(), np.asarray(base), atol=ATOL)
    if not quantize:
        with torch.no_grad():
            merged = tlora.lora_merge(flax_tree(model), tl, alpha=16.0)
        mmodel = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), merged).eval()
        with torch.no_grad():
            got_merged = mmodel.llm(torch.from_numpy(ids).long(),
                                    attention_mask=torch.from_numpy(mask))[0]
        np.testing.assert_allclose(got_merged.numpy(), got.numpy(), atol=ATOL)


def test_quant_dense_reads_lora():
    """tests/test_lora_collection.py::test_quant_dense_reads_lora on the
    port: a quantised tiny Llama (int8 head too) with adapters on q_proj and
    up_proj gives the JAX logits, with and without the adapters. The int8
    weights are filled in [-40, 40) and their scales set to 0.01, so the
    activations stay O(1) (at unit scales they grow to ~300 and fp32
    rounding in two summation orders exceeds the bound)."""
    cfg = JLlamaConfig.tiny(quantize=True)
    jmodel = JLlama(cfg)
    ids = jnp.asarray([[1, 5, 9, 12]], jnp.int32)
    params = _fill_int8(jmodel.init(jax.random.PRNGKey(0), ids)["params"], seed=0)
    target = r"model/.*(q_proj|up_proj)/kernel$"
    lora = jax.tree.map(lambda x: x + 0.05, jlora.lora_init(
        jax.random.PRNGKey(1), params, r=2, target=target))
    model = load_jax_params(LlamaForCausalLM(LlamaConfig.tiny(quantize=True)), params)
    assert isinstance(model.lm_head, QuantDense)
    assert sorted(tlora.lora_target_paths(model, target=target)) == \
        sorted(jlora.lora_target_paths(params, target=target))
    for with_lora in (False, True):
        variables = {"params": params}
        if with_lora:
            variables["lora"] = jlora.lora_scaled(lora, alpha=16.0)
            tlora.attach_lora(model, tlora.lora_scaled(lora_from_jax(lora), alpha=16.0))
        want = jmodel.apply(variables, ids)[0]
        with torch.no_grad():
            got = model(torch.from_numpy(np.array(ids)).long())[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_npz_round_trip_both_ways(tmp_path, batch):
    """save_lora's npz (adapters, alpha, r) reads back in both packages."""
    params = _params(batch, False)
    lora = _noisy_lora(params)
    tl = lora_from_jax(lora)
    tlora.save_lora(str(tmp_path / "t.npz"), tl, alpha=16.0, r=4)
    jlora.save_lora(str(tmp_path / "j.npz"), lora, alpha=16.0, r=4)
    for path in ("t.npz", "j.npz"):
        got_j, alpha_j, r_j = jlora.load_lora(str(tmp_path / path))
        got_t, alpha_t, r_t = tlora.load_lora(str(tmp_path / path))
        assert (alpha_j, r_j) == (alpha_t, r_t) == (16.0, 4)
        want = dict(jlora._flatten(lora))
        for flat in (dict(jlora._flatten(got_j)), dict(tlora._flatten(got_t))):
            assert set(flat) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(np.asarray(flat[k]), np.asarray(v), err_msg=k)


STEPS = {
    "qlora": dict(quantize=True, remat=False, paired=False),
    "qlora-paired-remat": dict(quantize=True, remat=True, paired=True),
    "lora": dict(quantize=False, remat=False, paired=False),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_lora_dpo_step_matches_jax(batch, case):
    """One DPO step of make_lora_dpo_train_step against the JAX one on the
    same base and adapters: loss, metrics (logps, rewards), every adapter
    gradient, the global norm and the adapters after the AdamW update;
    the base is untouched and gets no gradient."""
    c = STEPS[case]
    params = _params(batch, c["quantize"])
    lora = _noisy_lora(params)
    kw = dict(beta=0.1)
    if c["paired"]:
        kw["shared_prefix_len"] = tts.derive_shared_prefix_len(
            batch, JLlavaConfig.tiny().num_image_tokens)
        assert kw["shared_prefix_len"] > 0

    jadapter = jts.LlavaDPOAdapter(_jax_llava(c["quantize"], c["remat"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(lo):
        variables = {"params": jax.lax.stop_gradient(params),
                     "lora": jlora.lora_scaled(lo, alpha=16.0)}
        return jts.dpo_loss_from_batch(jadapter, variables, jb, jts.DPOHparams(**kw))

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(lora)
    jopt = jts.make_optimizer(1e-2, total_steps=10, warmup_ratio=0.0)
    updates, _ = jopt.update(jgrads, jopt.init(lora), lora)
    jnew = optax.apply_updates(lora, updates)

    model = _torch_llava(params, c["quantize"], c["remat"])
    base = {k: v.clone() for k, v in model.state_dict().items()}
    tl = lora_from_jax(lora)
    topt = tts.make_optimizer(tl, 1e-2, total_steps=10, warmup_ratio=0.0)
    assert all(topt.decay.values())  # wd_mask decays a and b
    step = tts.make_lora_dpo_train_step(tts.LlavaDPOAdapter(model), topt,
                                        tts.DPOHparams(**kw), tl, lora_alpha=16.0)
    metrics = step(tts.batch_to_device(batch, "cpu"))

    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), atol=ATOL)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(want), atol=ATOL, rtol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optax.global_norm(jgrads)), rtol=1e-5)
    want_grads, want_new = dict(jlora._flatten(jgrads)), dict(jlora._flatten(jnew))
    got = dict(tts.named_tensors(tl))
    assert set(got) == set(want_grads)
    tgrads = jax.tree.map(jnp.asarray, jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(lora),
        [got[n].grad.numpy() for n, _ in jlora._flatten(lora)]))
    updates, _ = jopt.update(tgrads, jopt.init(lora), lora)
    own_new = dict(jlora._flatten(optax.apply_updates(lora, updates)))
    for name, t in got.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grads[name]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(own_new[name]),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=name)
        big = np.abs(np.asarray(want_grads[name])) > 100 * 1e-8
        new, want = t.detach().numpy(), np.asarray(want_new[name])
        np.testing.assert_allclose(new[big], want[big], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)
        assert (np.abs(new - want) <= 1e-2).all(), name
    for name, v in model.state_dict().items():
        assert torch.equal(v, base[name]), name
    assert all(p.grad is None for p in model.parameters())
    assert all(getattr(m, "lora", None) is None for m in model.modules())
    if c["quantize"]:
        assert set(llava_params_from_jax(params)) == set(model.state_dict())
