"""OmniLMM-12B DPO training in the port against the JAX package, on the CPU.

Tiny geometry (`OmniLMMConfig.tiny()`, and the 400-token vocabulary of
tests/test_omni_train.py's `_tiny_omni_400` where rows come from
tests/fake_tokenizer.py), fp32 on both sides; flax trees cross with
`load_jax_params`, the JAX side runs as its own tests run it on the CPU
(dense attention, QuantDense's dequant formula, the fused head's Pallas
kernels in interpret mode).

- the omnilmm `FamilySpec`: its fields, `collator_kwargs` and
  `expand_inst` on the same encoded rows (a span cut by truncation -> -1,
  a row cut before its image); MiniCPM-V raises the JAX ValueError;
- `synth_omni_preference_pairs` / `synth_omni_dpo_batch` equal to the JAX
  helpers' from the same seed;
- `score_preference_rows(..., family="omnilmm")` shared-prefix and plain
  against the JAX function: sums and means atol 1e-4 (logps of ~-100 nats
  summed in other orders), per-token atol 1e-5;
- `dpo_loss_from_batch` through `OmnilmmDPOAdapter` against the JAX one
  (plain, paired, paired with remat and the fused head): loss and metrics
  atol 1e-5, every parameter's gradient atol 1e-5 + rtol 1e-4 (as
  tests/test_torch_train.py);
- the LoRA step's adapter gradients on the int8 base (tower float) and on
  the int4 base (tower int4), quantised by the entry point's `quantize_base`
  (bit-equal to the JAX quantisers' trees), against the JAX LoRA step:
  loss and metrics atol 1e-5, gradients atol 1e-5 + rtol 1e-4;
- the entry point: `--demo --family omnilmm`, `--config` on a tiny
  OmniLMM HF checkpoint (MODEL_BUILDERS["omnilmm"] patched to its geometry) with the
  JAX package's reference logps and with the port's own precompute (equal
  to the JAX one's at the tolerances above; step-1 loss ln 2 within 1e-4),
  QLoRA at 8 bits (tower float) and 4 bits (tower int4), `quantize`
  without `use_lora` failing as train.py does.
"""
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlaifv_tpu.data.image_processing import ClipImageProcessor as JClip
from rlaifv_tpu.models import convert as jconvert
from rlaifv_tpu.models import omnilmm as jomni
from rlaifv_tpu.models.eva02 import EvaConfig as JEva
from rlaifv_tpu.models.llama import LlamaConfig as JLlama
from rlaifv_tpu.train import family as jfamily
from rlaifv_tpu.train import lora as jlora
from rlaifv_tpu.train import ref_logp as jref
from rlaifv_tpu.train import train_step as jts
from rlaifv_tpu.utils import synth as jsynth
from rlaifv_tpu_torch.core.config import Config
from rlaifv_tpu_torch.models import convert as tconvert
from rlaifv_tpu_torch.models import omnilmm as tomni
from rlaifv_tpu_torch.models.llama import QuantDense
from rlaifv_tpu_torch.train import family as tfamily
from rlaifv_tpu_torch.train import ref_logp as tref
from rlaifv_tpu_torch.train import train_step as tts
from rlaifv_tpu_torch.utils import synth as tsynth
from tests.fake_tokenizer import FakeTokenizer
from tests.test_torch_data_copies import _deep_equal

LOSS_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
SUM_ATOL, TOKEN_ATOL = 1e-4, 1e-5
LN2_ATOL = 1e-4


def _png(rng, size):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _rows(n=3, size=28, seed=0):
    """Raw RLAIF-V rows in the fake tokenizer's characters (the rows of
    tests/test_omni_train.py), seeded PNGs."""
    rng = np.random.default_rng(seed)
    return [{"idx": str(i), "question": f"Describe object {i} now",
             "chosen": f"A tidy answer about thing {i}.",
             "rejected": f"Wrong rambling answer {i} with extra words.",
             "image": {"bytes": _png(rng, size), "path": f"mem{i}.png"},
             "image_path": f"mem{i}.png", "origin_dataset": "omni-test",
             "origin_split": "{}"} for i in range(n)]


def _close_rows(got, want):
    """score_preference_rows outputs: sums and means within SUM_ATOL, the
    per-token lists of equal length within TOKEN_ATOL."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose([a[0], a[1], a[3], a[4]], [b[0], b[1], b[3], b[4]],
                                   atol=SUM_ATOL)
        for k in (2, 5):
            assert len(a[k]) == len(b[k])
            np.testing.assert_allclose(a[k], b[k], atol=TOKEN_ATOL)


# ------------------------------------------------------------ the family spec


def test_omni_spec_matches_jax():
    tok = FakeTokenizer()
    got, want = tfamily.get_family("omnilmm"), jfamily.get_family("omnilmm")
    fields = ("name", "keep_image_tag", "use_im_start_end", "expand_images_in_collator",
              "default_image_size", "image_aspect")
    assert {k: getattr(got, k) for k in fields} == {k: getattr(want, k) for k in fields}
    assert got.preprocess_func.__module__ == "rlaifv_tpu_torch.data.preprocess"
    assert got.preprocess_func.__name__ == want.preprocess_func.__name__ == "omni_preprocess"
    assert got.collator_kwargs(tok) == want.collator_kwargs(tok) == \
        {"expand_images": False, "image_patch_id": tok.convert_tokens_to_ids("<im_patch>")}
    assert got.mm_cfg(None, 4) == want.mm_cfg(None, 4)
    _deep_equal(vars(got.image_processor()), vars(want.image_processor()))

    # the same rows through both packages' encoders, then expand_inst at a
    # length that keeps the span, one that cuts it, one that cuts before it
    rows = _rows(n=2)
    mm_t = got.mm_cfg(got.image_processor(28), 4)
    mm_j = want.mm_cfg(want.image_processor(28), 4)
    enc_t = tref._encode_rows(rows, tok, mm_t, got.preprocess_func)
    enc_j = jref._encode_rows(rows, tok, mm_j, want.preprocess_func)
    starts = set()
    for pair_t, pair_j in zip(enc_t, enc_j):
        for side_t, side_j in zip(pair_t, pair_j):
            _deep_equal({k: side_t[k] for k in ("input_ids", "labels")},
                        {k: side_j[k] for k in ("input_ids", "labels")})
            s = int(np.nonzero(np.asarray(side_t["input_ids"]) == 314)[0][0])
            for max_len in (512, s + 2, s - 1):
                ex = got.expand_inst(side_t, 4, max_len, tok)
                _deep_equal(ex, want.expand_inst(side_j, 4, max_len, tok))
                starts.add((max_len == 512, int(ex["image_start"])))
    assert starts == {(True, s), (False, -1)}  # the span found, or cut -> text-only

    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM

    assert type(got.adapter(tomni.OmniLMMForCausalLM(tomni.OmniLMMConfig.tiny()))) is \
        tts.OmnilmmDPOAdapter
    assert type(tfamily.get_family("llava15").adapter(
        LlavaForCausalLM(LlavaConfig.tiny()))) is tts.LlavaDPOAdapter
    with pytest.raises(ValueError) as t_err:
        tfamily.get_family("minicpmv")
    with pytest.raises(ValueError) as j_err:
        jfamily.get_family("minicpmv")
    assert str(t_err.value) == str(j_err.value)


def test_synth_omni_pairs_match_the_jax_helpers():
    tcfg, jcfg = tomni.OmniLMMConfig.tiny(), jomni.OmniLMMConfig.tiny()
    _deep_equal(tsynth.synth_omni_preference_pairs(tcfg, 3, answer_len=5, question_len=4,
                                                   seed=4),
                jsynth.synth_omni_preference_pairs(jcfg, 3, answer_len=5, question_len=4,
                                                   seed=4))
    got = tsynth.synth_omni_dpo_batch(tcfg, 3, 64, answer_len=10, seed=2)
    _deep_equal(got, jsynth.synth_omni_dpo_batch(jcfg, 3, 64, answer_len=10, seed=2))
    assert (got["image_starts"] == 2).all()  # after BOS and <im_start>


# ------------------------------------------------------------ reference logps


def _tiny_400():
    """The JAX `_tiny_omni_400` model and params and the port's twin."""
    jcfg = jomni.OmniLMMConfig(
        llm=JLlama.tiny(num_kv_heads=2, vocab_size=400, max_position_embeddings=512),
        vision=JEva.tiny(), num_query=4)
    jmodel = jomni.OmniLMMForCausalLM(jcfg)
    S = jcfg.vision.image_size
    params = jmodel.init(jax.random.PRNGKey(0), jnp.ones((1, jcfg.num_query + 8), jnp.int32),
                         images=jnp.zeros((1, S, S, 3)),
                         image_starts=jnp.asarray([1]))["params"]
    tcfg = tomni.OmniLMMConfig.tiny(vocab_size=400, max_position_embeddings=512)
    tmodel = tconvert.load_jax_params(tomni.OmniLMMForCausalLM(tcfg),
                                      jax.tree.map(np.asarray, params)).eval()
    return jcfg, jmodel, params, tmodel


@pytest.fixture(scope="module")
def tiny_400():
    return _tiny_400()


@pytest.mark.parametrize("shared", [True, False])
def test_reference_logps_match_jax(tiny_400, shared, monkeypatch):
    """The precompute's per-row logps, omni rows through the shared-prefix
    engine path (every pair shares: a spy counts the pairs it scored) or
    the plain scorer, against the JAX function on the same path."""
    jcfg, jmodel, params, tmodel = tiny_400
    tok = FakeTokenizer()
    rows = _rows()
    kw = dict(max_len=384, num_patches=4, batch_pairs=2, progress=False,
              shared_prefix=shared, family="omnilmm")
    from rlaifv_tpu_torch.genai.engine import DecodeEngine

    scored = []
    monkeypatch.setattr(DecodeEngine, "score_pair_logps",
                        lambda self, prefixes, *a, _f=DecodeEngine.score_pair_logps, **k:
                        scored.append(len(prefixes)) or _f(self, prefixes, *a, **k))
    got = tref.score_preference_rows(
        rows, tmodel, tok, multimodal_cfg=tfamily.get_family("omnilmm").mm_cfg(
            tfamily.get_family("omnilmm").image_processor(28), 4), **kw)
    want = jref.score_preference_rows(
        rows, jmodel, params, tok, multimodal_cfg=jfamily.get_family("omnilmm").mm_cfg(
            jfamily.get_family("omnilmm").image_processor(28), 4), **kw)
    assert sum(scored) == (len(rows) if shared else 0)
    _close_rows(got, want)
    assert all(np.isfinite(r[0]) and r[0] < 0 for r in got)


# ------------------------------------------------------------ the DPO step


@pytest.fixture(scope="module")
def tiny():
    """OmniLMMConfig.tiny() in both packages (fp32), JAX params, a batch of
    3 synthetic omni pairs collated at one shape."""
    jcfg = jomni.OmniLMMConfig.tiny()
    S = jcfg.vision.image_size
    params = jomni.OmniLMMForCausalLM(jcfg).init(
        jax.random.PRNGKey(3), jnp.ones((1, jcfg.num_query + 8), jnp.int32),
        images=jnp.zeros((1, S, S, 3)), image_starts=jnp.asarray([1]))["params"]
    batch = jsynth.synth_omni_dpo_batch(jcfg, 3, 64, answer_len=10, seed=5)
    P = tts.derive_shared_prefix_len(batch, jcfg.num_query)
    assert P == jts.derive_shared_prefix_len(batch, jcfg.num_query) == 2 + jcfg.num_query
    return dict(jcfg=jcfg, params=jax.tree.map(np.asarray, params), batch=batch, P=P)


def _configs(jcfg, remat=False, bits=0):
    """The JAX and port configs of the tiny model, quantised (bits 8: the
    LLM's projections; bits 4: and the tower, as train.py quantises)."""
    q = dict(quantize=True, quantize_bits=bits, quantize_lm_head=False) if bits else {}
    jc = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, remat=remat, **q),
                             vision=dataclasses.replace(jcfg.vision, quantize=bits == 4,
                                                        quantize_bits=bits or 8))
    return jc, tomni.OmniLMMConfig.tiny(remat=remat)


DPO_VARIANTS = {
    "plain": dict(),
    "paired": dict(shared_prefix_len="P"),
    "fused-remat-paired": dict(lm_head_impl="fused", shared_prefix_len="P", remat=True),
}


@pytest.mark.parametrize("variant", list(DPO_VARIANTS))
def test_dpo_loss_and_grads_match_jax(tiny, variant):
    """The full fine-tune's step (configs/omnilmm_dpo.json trains every
    parameter): loss, metrics and every gradient."""
    kw = dict(DPO_VARIANTS[variant])
    remat = kw.pop("remat", False)
    if kw.get("shared_prefix_len") == "P":
        kw["shared_prefix_len"] = tiny["P"]
    jc, tc = _configs(tiny["jcfg"], remat)
    params, batch = tiny["params"], tiny["batch"]
    jadapter = jts.OmnilmmDPOAdapter(jomni.OmniLMMForCausalLM(jc))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jts.dpo_loss_from_batch(jadapter, p, jb, jts.DPOHparams(beta=0.1, **kw))

    (jloss, jmetrics), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model = tconvert.load_jax_params(tomni.OmniLMMForCausalLM(tc), params)
    loss, metrics = tts.dpo_loss_from_batch(tts.OmnilmmDPOAdapter(model),
                                            tts.batch_to_device(batch, "cpu"),
                                            tts.DPOHparams(beta=0.1, **kw))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=LOSS_ATOL)
    assert set(metrics) == set(jmetrics)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(want), atol=LOSS_ATOL,
                                   rtol=1e-6, err_msg=key)
    want = tconvert.llava_params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    assert any(float(want[n].abs().max()) > 0 for n in want if n.startswith("vision_tower."))


def _quantised_jax(params, bits):
    llm = jconvert.quantize_llm_int4(params["llm"]) if bits == 4 else \
        jconvert.quantize_llm_int8(params["llm"], include_lm_head=False)
    tower = jconvert.quantize_vision_int4(params["vision_tower"]) if bits == 4 else \
        params["vision_tower"]
    return {**params, "llm": llm, "vision_tower": tower}


def _noisy_lora(params, r=4, seed=2):
    lora = jlora.lora_init(jax.random.PRNGKey(1), params, r=r)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: x + 0.02 * rng.normal(size=x.shape).astype(np.float32), lora)


@pytest.mark.parametrize("bits", [8, 4])
def test_lora_grads_on_the_quantised_base_match_jax(tiny, bits):
    """configs/omnilmm_dpo_qlora*.json's step at tiny size (paired, remat):
    the port model quantised in place by the entry point's `quantize_base`
    holds the JAX quantisers' tree bit for bit (bits 8: the EVA02 tower
    stays float; bits 4: it is int4 too), and one LoRA step's loss,
    metrics and adapter gradients match the JAX step's; the base gets no
    gradient."""
    from rlaifv_tpu_torch.train.__main__ import quantize_base

    jc, tc = _configs(tiny["jcfg"], remat=True, bits=bits)
    params, batch = tiny["params"], tiny["batch"]
    jparams = jax.tree.map(np.asarray, _quantised_jax(params, bits))
    config = Config()
    config.model.model_family, config.model.quantize = "omnilmm", True
    config.model.quantize_bits = bits
    model = quantize_base(config, tconvert.load_jax_params(tomni.OmniLMMForCausalLM(tc),
                                                           params))
    want_sd = tconvert.llava_params_from_jax(jparams)
    got_sd = model.state_dict()
    assert set(got_sd) == set(want_sd)
    for name, t in got_sd.items():
        assert torch.equal(t, want_sd[name].to(t.dtype)), name
    tower_q = [m for m in model.vision_tower.modules() if isinstance(m, QuantDense)]
    assert (len(tower_q) > 0) == (bits == 4) and all(m.bits == bits for m in tower_q)
    assert model.cfg.vision.quantize == (bits == 4) and model.cfg.llm.quantize_bits == bits
    assert not isinstance(model.llm.lm_head, QuantDense)

    lora = _noisy_lora(jparams)
    hp = dict(beta=0.1, shared_prefix_len=tiny["P"])
    jadapter = jts.OmnilmmDPOAdapter(jomni.OmniLMMForCausalLM(jc))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(lo):
        variables = {"params": jax.lax.stop_gradient(jax.tree.map(jnp.asarray, jparams)),
                     "lora": jlora.lora_scaled(lo, alpha=16.0)}
        return jts.dpo_loss_from_batch(jadapter, variables, jb, jts.DPOHparams(**hp))

    (jloss, jmetrics), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(lora)
    tl = tconvert.lora_from_jax(lora)
    opt = tts.make_optimizer(tl, 1e-2, total_steps=10, warmup_ratio=0.0)
    step = tts.make_lora_dpo_train_step(tts.OmnilmmDPOAdapter(model), opt,
                                        tts.DPOHparams(**hp), tl, lora_alpha=16.0)
    metrics = step(tts.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), atol=LOSS_ATOL)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(want), atol=LOSS_ATOL,
                                   rtol=1e-6, err_msg=key)
    want = dict(jlora._flatten(jgrads))
    got = dict(tts.named_tensors(tl))
    assert set(got) == set(want) and len(got) == 2 * 7 * tc.llm.num_layers
    for name, t in got.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want[name]), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    assert all(p.grad is None for p in model.parameters())


# ------------------------------------------------------------ the entry point


def test_demo_runs_the_omnilmm_family(tmp_path, capsys):
    from rlaifv_tpu_torch.train.__main__ import main

    out = tmp_path / "demo"
    assert main(["--demo", "--family", "omnilmm", "--device", "cpu", "--max-steps", "2",
                 "--output-dir", str(out)]) == 2
    assert "[demo:omnilmm] finished at step 2 on cpu" in capsys.readouterr().out
    logged = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert [m["step"] for m in logged] == [1, 2]
    assert all(np.isfinite(m["loss"]) for m in logged)
    assert os.listdir(out / "checkpoints") == ["2"]


class _Tok(FakeTokenizer):
    pad_token = "<unk>"


def _tiny_checkpoint(d):
    """A tiny real-format OmniLMM checkpoint (safetensors + config.json)
    whose vocabulary covers the fake tokenizer's ids -> (dir, the JAX
    config read from it)."""
    from safetensors.numpy import save_file

    from tests.test_torch_omnilmm import _tiny_omni_sd

    sd = _tiny_omni_sd()
    rng = np.random.default_rng(11)
    for key in ("model.embed_tokens.weight", "lm_head.weight"):
        sd[key] = (rng.standard_normal((400, 16)) * 0.1).astype(np.float32)
    os.makedirs(d)
    save_file(sd, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"vocab_size": 400, "hidden_size": 16, "intermediate_size": 32,
                   "num_hidden_layers": 2, "num_attention_heads": 2,
                   "num_key_value_heads": 2, "max_position_embeddings": 2048,
                   "num_query": 4,
                   "eva_config": {"image_size": 28, "patch_size": 7, "embed_dim": 32,
                                  "depth": 3, "num_heads": 4, "mlp_hidden": 64}}, f)
    return d, jconvert.omnilmm_config_from_hf(d)


def _config_run(tmp_path, monkeypatch, *, logps, bits=0):
    """`python -m rlaifv_tpu_torch.train --config` on the tiny checkpoint:
    the JAX package precomputes the reference logps (on its own quantised
    tree when bits), either into the dataset directory or, for
    logps="precompute", into another one to compare the port's precompute
    with. MODEL_BUILDERS["omnilmm"] is patched to the checkpoint's geometry and the
    tokenizer loader to the fake tokenizer (the kwargs it got are
    recorded). -> (the built model, the tokenizer kwargs, the loss lines)."""
    import pandas as pd
    import transformers

    from rlaifv_tpu_torch.train import __main__ as tmain

    ckpt, jcfg = _tiny_checkpoint(str(tmp_path / "ckpt"))
    data, jdata = str(tmp_path / "data"), str(tmp_path / "jdata")
    rows = _rows(n=4)
    params = jconvert.convert_omnilmm(jconvert.load_state_dict_dir(ckpt))
    if bits:
        params = _quantised_jax(params, bits)
        jcfg, _ = _configs(jcfg, bits=bits)
    jref.inference_logp(rows, jomni.OmniLMMForCausalLM(jcfg), jax.tree.map(jnp.asarray, params),
                        FakeTokenizer(), jdata if logps == "precompute" else data, max_len=512,
                        num_patches=4, batch_pairs=2,
                        image_processor=JClip(image_size=28, aspect_ratio="square"),
                        family="omnilmm")
    if logps == "precompute":
        os.makedirs(data)
        pd.DataFrame(rows).to_parquet(os.path.join(data, "raw-000.parquet"))

    built, tok_kw = [], []

    def build(config, device):
        tcfg = tconvert.omnilmm_config_from_hf(ckpt, llm=dict(remat=config.model.remat))
        built.append(tomni.OmniLMMForCausalLM(tcfg, device="meta").to_empty(device=device))
        return tcfg, built[-1]

    monkeypatch.setitem(tmain.MODEL_BUILDERS, "omnilmm", build)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda path, **kw: tok_kw.append(kw) or _Tok())
    out = tmp_path / "out"
    training = {"output_dir": str(out), "max_steps": 2, "save_steps": 2,
                "learning_rate": 1e-3, "warmup_ratio": 0.0, "lm_head_impl": "xla",
                "shared_prefix_len": -1, "per_device_batch_pairs": 2}
    model = {"model_name_or_path": ckpt, "model_family": "omnilmm"}
    if bits:
        model.update(quantize=True, quantize_bits=bits)
        training.update(use_lora=True, lora_r=4, lora_alpha=16)
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"model": model, "data": {"data_dir": data, "max_len": 512}, "training": training}))
    assert tmain.main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu"]) == 2

    if logps == "precompute":
        name = "RLAIF-V-Dataset-withlogp_000-4.parquet"
        assert sorted(f for f in os.listdir(data) if "logp" in f) == [name]
        got, want = (pd.read_parquet(os.path.join(d, name)) for d in (data, jdata))
        _close_rows([json.loads(x)["logps"] for x in got["logps"]],
                    [json.loads(x)["logps"] for x in want["logps"]])
    logged = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert logged[0]["derived_shared_prefix_len"] > 4  # the paired path ran
    steps = [m for m in logged if "loss" in m]
    assert [m["step"] for m in steps] == [1, 2]
    # policy == reference at step 1
    np.testing.assert_allclose(steps[0]["loss"], np.log(2.0), atol=LN2_ATOL)
    assert os.listdir(out / "checkpoints") == ["2"]
    return built[0], tok_kw


@pytest.mark.parametrize("logps", ["jax-logp-files", "precompute"])
def test_config_run_from_a_tiny_omnilmm_checkpoint(tmp_path, monkeypatch, logps):
    """The full fine-tune from the checkpoint (configs/omnilmm_dpo.json's
    mode): the tokenizer loaded with use_fast=True (train.py's rule for
    every family but llava15)."""
    model, tok_kw = _config_run(tmp_path, monkeypatch, logps=logps)
    assert tok_kw == [{"use_fast": True}]
    assert not any(isinstance(m, QuantDense) for m in model.modules())


@pytest.mark.parametrize("bits", [8, 4])
def test_config_qlora_run_quantises_as_train_py(tmp_path, monkeypatch, bits):
    """QLoRA from the checkpoint: bits 8 quantises the LLM's projections
    and leaves the EVA02 tower float, bits 4 quantises both; the port's
    precompute on that base equals the JAX package's on its own quantised
    tree; the checkpoint holds the adapters only, and a second run resumes
    from it."""
    from rlaifv_tpu_torch.core.checkpoint import CheckpointManager

    from rlaifv_tpu_torch.train.__main__ import main

    model, _ = _config_run(tmp_path, monkeypatch, logps="precompute", bits=bits)
    llm_q = [m for m in model.llm.modules() if isinstance(m, QuantDense)]
    tower_q = [m for m in model.vision_tower.modules() if isinstance(m, QuantDense)]
    assert len(llm_q) == 7 * 2 and all(m.bits == bits for m in llm_q)
    assert len(tower_q) == (4 * 2 if bits == 4 else 0) and all(m.bits == 4 for m in tower_q)
    assert not isinstance(model.llm.lm_head, QuantDense)
    ckpt = CheckpointManager(str(tmp_path / "out" / "checkpoints"))
    state = ckpt.restore()
    assert len(state["params"]) == 2 * 7 * 2
    assert all(k.startswith("llm/model/layer_") for k in state["params"])
    # a second run resumes the adapters and their AdamW state at step 2
    assert main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu",
                 "--max-steps", "3"]) == 3
    assert ckpt.all_steps() == [2, 3] and ckpt.restore()["opt_state"]["count"] == 3


def test_quantize_without_lora_fails_as_train_py_does(tmp_path):
    from rlaifv_tpu_torch.train.__main__ import main

    cfg = {"model": {"model_family": "omnilmm", "quantize": True, "quantize_bits": 4},
           "training": {"output_dir": str(tmp_path / "o")}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    with pytest.raises(AssertionError, match="combine with training.use_lora"):
        main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu"])
    assert not (tmp_path / "o").exists()
