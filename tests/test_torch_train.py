"""The port's DPO train step against the JAX package's, on the CPU.

One flax param tree (LlavaConfig.tiny(), fp32) is bridged into the torch
model with `llava_params_from_jax`; the same collated batch (numpy-seeded
pairs, DPOCollator) goes through `dpo_loss_from_batch` of both packages.
The loss, every metric and every gradient leaf are compared for each
forward variant, and the optimizer's parameters after 1 and 3 updates
against optax on identical gradients. The JAX attention on the CPU is the
dense path, as the port's is.

Tolerances (fp32 on both sides, sums taken in other orders): loss and
metrics atol 1e-5 (logps ~-100 at rtol 1e-6); gradients atol 1e-5 plus
rtol 1e-4; parameters after optimizer updates atol 1e-6 plus rtol 1e-5
(an Adam step moves an entry by ~lr = 1e-2, so this is ~1e-4 of a step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rlaifv_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from rlaifv_tpu.data.collator import DPOCollator
from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
from rlaifv_tpu.train import train_step as jts
from rlaifv_tpu_torch.models.convert import (
    _torch_name,
    flax_leaf_names,
    llava_params_from_jax,
    load_jax_params,
)
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
from rlaifv_tpu_torch.train import train_step as tts

LOSS_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5


def _pair(rng, vocab, img_size, with_image=True):
    q = rng.integers(5, vocab, size=6).tolist()
    image = rng.normal(size=(img_size, img_size, 3)).astype(np.float32)
    img = [IMAGE_TOKEN_INDEX] if with_image else []

    def side(ans):
        ids = [1] + q[:3] + img + q[3:] + ans + [2]
        labels = [IGNORE_INDEX] * (len(ids) - len(ans) - 1) + ans + [2]
        return {"input_ids": np.asarray(ids, np.int64),
                "labels": np.asarray(labels, np.int64), "image": image,
                "ref_win_logp": -20.0, "ref_win_avg_logp": -2.0,
                "ref_rej_logp": -25.0, "ref_rej_avg_logp": -2.5}

    win = side(rng.integers(5, vocab, size=5).tolist())
    rej = side(rng.integers(5, vocab, size=7).tolist())
    return rej, win


@pytest.fixture(scope="module")
def setup():
    cfg = JLlavaConfig.tiny()
    rng = np.random.default_rng(7)
    coll = DPOCollator(pad_token_id=0, max_len=48, num_patches=cfg.num_image_tokens,
                       beta=0.1)
    batch = coll([_pair(rng, cfg.llm.vocab_size, cfg.vision.image_size)
                  for _ in range(3)])
    # images present, every row text-only (image_start -1): the ghost term
    text = coll([_pair(rng, cfg.llm.vocab_size, cfg.vision.image_size, False)
                 for _ in range(3)])
    assert (text["image_starts"] == -1).all() and "images" in text
    for b in (batch, text):
        B, L = b["win_labels"].shape
        b["ref_win_per_token_logp"] = rng.normal(-2, 0.5, (B, L - 1)).astype(np.float32)
        b["ref_rej_per_token_logp"] = rng.normal(-2, 0.5, (B, L - 1)).astype(np.float32)
    params = JLlava(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"][:2]),
        images=jnp.asarray(batch["images"][:2]),
        image_starts=jnp.asarray(batch["image_starts"][:2]),
    )["params"]
    return dict(batch=batch, text=text, params=params, n_img=cfg.num_image_tokens)


def _torch_model(params, remat=False):
    return load_jax_params(LlavaForCausalLM(LlavaConfig.tiny(remat=remat)), params)


def _jax_loss_grads(params, batch, hp, remat=False):
    adapter = jts.LlavaDPOAdapter(JLlava(JLlavaConfig.tiny(remat=remat)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jts.dpo_loss_from_batch(adapter, p, b, hp), has_aux=True))
    (loss, metrics), grads = fn(params, jb)
    return float(loss), metrics, grads


def _torch_loss_grads(model, batch, hp):
    adapter = tts.LlavaDPOAdapter(model)
    model.zero_grad(set_to_none=True)
    loss, metrics = tts.dpo_loss_from_batch(adapter, tts.batch_to_device(batch, "cpu"), hp)
    loss.backward()
    return float(loss.detach()), metrics


def _hp(setup, batch, **kw):
    """kw with "P": "derive" -> the derived shared prefix; "W": "trim" ->
    a suffix that ends 3 tokens past the last label."""
    kw = dict(kw)
    if kw.get("shared_prefix_len") == "derive":
        P = tts.derive_shared_prefix_len(batch, setup["n_img"])
        assert P == jts.derive_shared_prefix_len(batch, setup["n_img"]) and P > 0
        kw["shared_prefix_len"] = P
    if kw.get("shared_suffix_len") == "trim":
        last = int(np.max(np.where(batch["labels"] != IGNORE_INDEX)[1])) + 1
        kw["shared_suffix_len"] = last - kw["shared_prefix_len"] + 3
        assert kw["shared_prefix_len"] + kw["shared_suffix_len"] < batch["labels"].shape[1]
    return kw


VARIANTS = {
    "plain": ("batch", dict(), False),
    "paired-derived-P": ("batch", dict(shared_prefix_len="derive"), False),
    "suffix-trim": ("batch", dict(shared_prefix_len="derive", shared_suffix_len="trim"), False),
    "average-sft": ("batch", dict(dpo_use_average=True, sft_weight=0.3), False),
    "token-weighted": ("batch", dict(dpo_token_weighted=True, shared_prefix_len="derive"), False),
    "compact": ("batch", dict(lm_head_impl="compact", compact_len=16), False),
    # the fused head: the JAX side runs its Pallas kernels in interpret mode
    "fused": ("batch", dict(lm_head_impl="fused"), False),
    "fused-paired": ("batch", dict(lm_head_impl="fused", shared_prefix_len="derive"), False),
    "fused-remat-paired": ("batch", dict(lm_head_impl="fused", shared_prefix_len="derive"),
                           True),
    "text-only": ("text", dict(), False),
    "text-only-paired": ("text", dict(shared_prefix_len="derive"), False),
    "remat-plain": ("batch", dict(), True),
    "remat-paired": ("batch", dict(shared_prefix_len="derive"), True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_metrics_and_grads_match_jax(setup, variant):
    kind, kw, remat = VARIANTS[variant]
    batch = setup[kind]
    kw = _hp(setup, batch, beta=0.1, **kw)
    jloss, jmetrics, jgrads = _jax_loss_grads(setup["params"], batch,
                                              jts.DPOHparams(**kw), remat)
    model = _torch_model(setup["params"], remat)
    tloss, tmetrics = _torch_loss_grads(model, batch, tts.DPOHparams(**kw))

    np.testing.assert_allclose(tloss, jloss, atol=LOSS_ATOL)
    assert set(tmetrics) == set(jmetrics)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[key]), float(want), atol=LOSS_ATOL,
                                   rtol=1e-6, err_msg=key)
    want = llava_params_from_jax(jgrads)
    for name, p in model.named_parameters():
        assert p.grad is not None, name  # every leaf has a gradient, as in JAX
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_text_only_rows_give_zero_vision_grads_and_decay_like_optax(setup):
    """The ghost term: on text-only rows the tower and projector get zero
    gradients (not None), and one optimizer step still applies AdamW's
    weight decay to them exactly as optax does."""
    params, batch = setup["params"], setup["text"]
    hp = dict(beta=0.1)
    _, _, jgrads = _jax_loss_grads(params, batch, jts.DPOHparams(**hp))
    model = _torch_model(params)
    _torch_loss_grads(model, batch, tts.DPOHparams(**hp))
    vision = [(n, p) for n, p in model.named_parameters()
              if n.startswith(("vision_tower.", "mm_projector."))]
    assert vision
    for name, p in vision:
        assert p.grad is not None and not p.grad.any(), name

    opt = jts.make_optimizer(1e-2, total_steps=10, warmup_ratio=0.0)
    updates, _ = opt.update(jgrads, opt.init(params), params)
    want = llava_params_from_jax(optax.apply_updates(params, updates))
    tts.make_optimizer(model, 1e-2, total_steps=10, warmup_ratio=0.0).step()
    before = llava_params_from_jax(params)
    for name, p in vision:
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=name)
    # decayed although its gradient was zero (biases and norm scales are not)
    assert not torch.equal(model.vision_tower.patch_embed.weight.detach(),
                           before["vision_tower.patch_embed.weight"])


def _step_both(params, model, jopt, topt, grads_np):
    """One update of each optimizer from the same gradient tree."""
    jgrads = jax.tree.map(jnp.asarray, grads_np)
    tgrads = llava_params_from_jax(grads_np)
    for name, p in model.named_parameters():
        p.grad = tgrads[name].clone()
    topt.step()
    return jgrads


@pytest.mark.parametrize("sched", [
    dict(total_steps=20, warmup_ratio=0.1, schedule="cosine", scale=1.0),
    dict(total_steps=10, warmup_ratio=0.05, schedule="cosine", scale=1e-4),
    dict(total_steps=10, warmup_ratio=0.2, schedule="constant", scale=1.0),
], ids=["cosine-warmup2-clipped", "cosine-warmup0-unclipped", "constant-warmup2"])
def test_optimizer_matches_optax(setup, sched):
    """Parameters after 1 and 3 updates from identical random gradients:
    warmup > 0 (first update at lr 0) and warmup = 0 (first at the peak);
    scale 1 makes the global norm ~1e3 (clipped to 1), 1e-4 keeps it
    below 1 (no clipping)."""
    sched = dict(sched)
    scale = sched.pop("scale")
    params = setup["params"]
    model = _torch_model(params)
    jopt = jts.make_optimizer(1e-2, **sched)
    topt = tts.make_optimizer(model, 1e-2, **sched)
    state = jopt.init(params)
    rng = np.random.default_rng(11)
    for step in range(3):
        grads_np = jax.tree.map(
            lambda x: (rng.normal(size=x.shape) * scale).astype(np.float32), params)
        jgrads = _step_both(params, model, jopt, topt, grads_np)
        norm = float(optax.global_norm(jgrads))
        assert (norm > 1.0) == (scale == 1.0)
        updates, state = jopt.update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
        if step in (0, 2):
            want = llava_params_from_jax(params)
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                           atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                           err_msg=f"step {step}: {name}")
    assert topt.count == 3


def test_gradient_accumulation_matches_optax_multisteps(setup):
    """MultiSteps(k=2): the first micro-step changes nothing, the second
    applies the mean gradient; 4 micro-steps = 2 updates, as optax."""
    params = setup["params"]
    model = _torch_model(params)
    jopt = optax.MultiSteps(jts.make_optimizer(1e-2, total_steps=10), every_k_schedule=2)
    topt = tts.MultiSteps(tts.make_optimizer(model, 1e-2, total_steps=10), 2)
    state = jopt.init(params)
    rng = np.random.default_rng(12)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for step in range(4):
        grads_np = jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        jgrads = _step_both(params, model, jopt, topt, grads_np)
        updates, state = jopt.update(jgrads, state, params)
        params = optax.apply_updates(params, updates)
        if step == 0:
            assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
        want = llava_params_from_jax(params)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"micro-step {step}: {name}")
    assert topt.inner.count == 2


@pytest.mark.parametrize("count", [0, 1, 2, 5, 9, 10, 12])
@pytest.mark.parametrize("sched", [dict(total_steps=10, warmup_ratio=0.2),
                                   dict(total_steps=10, warmup_ratio=0.0),
                                   dict(total_steps=10, warmup_ratio=0.2,
                                        schedule="constant")])
def test_lr_schedule_matches_optax(count, sched):
    """The learning rate at each count: the optax schedule inside
    make_optimizer, recovered from a unit gradient on one leaf."""
    lr = tts.lr_schedule(1.0, **sched)
    warmup = int(sched["total_steps"] * sched["warmup_ratio"])
    if sched.get("schedule") == "constant":
        want = optax.join_schedules([optax.linear_schedule(0.0, 1.0, warmup),
                                     optax.constant_schedule(1.0)], [warmup])(count)
    else:
        want = optax.warmup_cosine_decay_schedule(
            0.0, 1.0, warmup, max(sched["total_steps"], warmup + 1), 0.0)(count)
    np.testing.assert_allclose(lr(count), float(want), atol=1e-7)


def test_weight_decay_mask_follows_the_jax_leaf_names(setup):
    """The mask comes from the flax leaf names through the bridge's name
    map: `bias` and `scale` leaves are not decayed (norm scales are
    `.weight` in torch), CLIP's cls_token and pos_embed are."""
    model = _torch_model(setup["params"])
    names = flax_leaf_names(model)
    flat = jax.tree_util.tree_flatten_with_path(setup["params"])[0]
    assert len(flat) == len(names)
    for path, _ in flat:
        keys = [str(k.key) for k in path]
        assert names[_torch_name(".".join(keys))] == keys[-1]
    mask = tts.weight_decay_mask(model)
    assert not mask["llm.model.ln_f.weight"] and not mask["vision_tower.pre_ln.bias"]
    assert mask["vision_tower.cls_token"] and mask["vision_tower.pos_embed"]
    assert mask["llm.lm_head.weight"] and mask["llm.model.tok_embed.weight"]


def test_paired_rejects_bad_lengths_and_the_fused_head(setup):
    """A shared prefix as long as the batch raises; the fused head computes
    the "xla" head's loss and head gradient (fp32, LOSS_ATOL / GRAD_ATOL)."""
    model = _torch_model(setup["params"])
    adapter = tts.LlavaDPOAdapter(model)
    batch = tts.batch_to_device(setup["batch"], "cpu")
    L = batch["input_ids"].shape[1]
    with pytest.raises(ValueError, match="shared_prefix_len"):
        tts.dpo_loss_from_batch(adapter, batch, tts.DPOHparams(shared_prefix_len=L))
    out = {}
    for head in ("xla", "fused"):
        model.zero_grad(set_to_none=True)
        loss, _ = tts.dpo_loss_from_batch(adapter, batch, tts.DPOHparams(lm_head_impl=head))
        loss.backward()
        out[head] = (float(loss.detach()), model.llm.lm_head.weight.grad.clone())
    np.testing.assert_allclose(out["fused"][0], out["xla"][0], atol=LOSS_ATOL)
    np.testing.assert_allclose(out["fused"][1].numpy(), out["xla"][1].numpy(),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("case", ["clean", "diverges", "image-span", "drops-labels"])
def test_validate_shared_prefix_matches_jax(setup, case):
    """The numpy helpers are copies: same verdict and message as JAX's."""
    batch = dict(setup["batch"])
    P = 1 + 3 + setup["n_img"] + 3
    kw = dict(num_patches=setup["n_img"])
    last = int(np.max(np.where(batch["labels"] != IGNORE_INDEX)[1])) + 1
    if case == "diverges":
        P += 4
    elif case == "image-span":
        batch["image_starts"] = batch["image_starts"] + (P - 8)
    elif case == "drops-labels":
        kw["suffix_len"] = last - P - 2
    outcomes = []
    for fn in (jts.validate_shared_prefix, tts.validate_shared_prefix):
        try:
            fn(batch, P, **kw)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) == (case == "clean")
