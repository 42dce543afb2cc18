"""The port's DPOTrainer, checkpoints and training entry point, on the CPU.

Ports of tests/test_trainer.py's loop tests (runs and checkpoints, resumes,
accumulates gradients, re-derives the shared prefix on a shorter batch) on
the tiny LLaVA with random weights from a seeded generator, the
`--config` entry point on a tiny HF checkpoint (with reference logps the
JAX package wrote, and with none, which the port then precomputes), the
`--device` rule, and the pieces that raise for what is not ported.
Parameters are compared exactly (a restore copies the saved tensors bit
for bit).
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from rlaifv_tpu_torch.core.checkpoint import CheckpointManager, has_resumable_checkpoint
from rlaifv_tpu_torch.core.config import Config
from rlaifv_tpu_torch.data.collator import DPOCollator
from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM, init_weights_
from rlaifv_tpu_torch.train.trainer import DPOTrainer, precompute_head, resolve_head
from rlaifv_tpu_torch.utils.synth import synth_preference_pairs


def _model(seed=0):
    return init_weights_(LlavaForCausalLM(LlavaConfig.tiny()),
                         torch.Generator().manual_seed(seed))


def _config(out, steps=4, **kw):
    c = Config()
    c.training.output_dir = str(out)
    c.training.max_steps = steps
    c.training.learning_rate = 1e-3
    c.training.save_steps = 2
    for k, v in kw.items():
        setattr(c.training, k, v)
    return c


@pytest.fixture(scope="module")
def data():
    cfg = LlavaConfig.tiny()
    pairs = synth_preference_pairs(cfg, 8, answer_len=12, question_len=8)
    return pairs, DPOCollator(pad_token_id=0, max_len=48,
                              num_patches=cfg.num_image_tokens)


def test_synth_pairs_match_the_jax_helper():
    from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
    from rlaifv_tpu.utils.synth import synth_preference_pairs as jsynth

    got = synth_preference_pairs(LlavaConfig.tiny(), 3, answer_len=5, seed=4)
    want = jsynth(JLlavaConfig.tiny(), 3, answer_len=5, seed=4)
    for (gr, gw), (wr, ww) in zip(got, want):
        for g, w in ((gr, wr), (gw, ww)):
            assert set(g) == set(w)
            for key in g:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))


def test_trainer_runs_checkpoints_and_resumes(data, tmp_path):
    pairs, coll = data
    model = _model()
    trainer = DPOTrainer(_config(tmp_path), model, pairs, coll)
    assert trainer.hp.lm_head_impl == "xla"  # "auto" at hidden 64
    assert trainer.train() == 4
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [m["step"] for m in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) and "grad_norm" in m for m in lines)
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    assert ckpt.all_steps() == [2, 4]
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}

    # a fresh trainer on other weights resumes at step 4 with the saved
    # params and optimizer state, then runs on to 6
    model2 = _model(seed=1)
    trainer2 = DPOTrainer(_config(tmp_path, steps=6), model2, pairs, coll)
    assert trainer2.start_step == 4
    for name, p in model2.named_parameters():
        assert torch.equal(p, saved[name]), name
    assert trainer2.optimizer.count == 4
    for name, mu in trainer.optimizer.mu.items():
        assert torch.equal(trainer2.optimizer.mu[name], mu)
    assert trainer2.train() == 6
    assert ckpt.all_steps() == [2, 4, 6]


def test_checkpoint_rotation_keeps_the_newest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "c"), save_total_limit=2)
    assert ckpt.latest_step() is None and not has_resumable_checkpoint(ckpt.directory)
    for step in (1, 2, 3):
        ckpt.save(step, {"step": step, "x": torch.full((2,), float(step))})
    assert ckpt.all_steps() == [2, 3] and has_resumable_checkpoint(ckpt.directory)
    assert torch.equal(ckpt.restore()["x"], torch.full((2,), 3.0))
    assert ckpt.restore(step=2)["step"] == 2


def test_gradient_accumulation(data, tmp_path):
    """gradient_accumulation=k: k micro-batches per optimizer update; the
    loop runs max_steps * k micro-steps and params move on every k-th."""
    pairs, coll = data
    model = _model()
    c = _config(tmp_path, steps=2, gradient_accumulation=2, save_steps=100)
    trainer = DPOTrainer(c, model, pairs, coll)
    from rlaifv_tpu_torch.train.train_step import batch_to_device

    proj = model.mm_projector
    p0 = [p.detach().clone() for p in proj.parameters()]
    batches = iter(trainer._batches(0))
    trainer._step(batch_to_device(next(batches), "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(p0, proj.parameters()))
    trainer._step(batch_to_device(next(batches), "cpu"))
    assert any(not torch.equal(a, b) for a, b in zip(p0, proj.parameters()))
    assert trainer.train() == 2 * 2
    assert trainer.optimizer.inner.count == 1 + 2


def test_auto_prefix_rederives_on_shorter_batch(tmp_path):
    """shared_prefix_len=-1 on text-only data: the first batch derives P=20;
    a later batch whose pairs share only 10 tokens re-derives with a
    warning; an explicit P=20 hard-fails on that batch."""
    rng = np.random.default_rng(0)
    vocab, L = LlavaConfig.tiny().llm.vocab_size, 32

    def mk_pair(diverge_at):
        base = rng.integers(5, vocab, size=L).astype(np.int64)
        win_ids, rej_ids = base.copy(), base.copy()
        rej_ids[diverge_at:] = rng.integers(5, vocab, size=L - diverge_at)

        def side(ids):
            labels = ids.copy()
            labels[:diverge_at] = -100
            return {"input_ids": ids, "labels": labels}

        win, rej = side(win_ids), side(rej_ids)
        win.update(ref_win_logp=-20.0, ref_win_avg_logp=-2.0)
        rej.update(ref_rej_logp=-22.0, ref_rej_avg_logp=-2.2)
        return rej, win

    order = np.random.default_rng(0).permutation(2)
    pairs = [None, None]
    pairs[int(order[0])] = mk_pair(20)
    pairs[int(order[1])] = mk_pair(10)
    coll = DPOCollator(pad_token_id=0, max_len=L, num_patches=0)

    trainer = DPOTrainer(_config(tmp_path / "auto", steps=2, per_device_batch_pairs=1,
                                 shared_prefix_len=-1), _model(), pairs, coll)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert trainer.train() == 2
    assert any("re-deriving P=10" in str(w.message) for w in caught)
    assert trainer.hp.shared_prefix_len == 10
    logged = [json.loads(x) for x in open(tmp_path / "auto" / "metrics.jsonl")]
    assert [m["derived_shared_prefix_len"] for m in logged
            if "derived_shared_prefix_len" in m] == [20, 10]

    trainer2 = DPOTrainer(_config(tmp_path / "hard", steps=2, per_device_batch_pairs=1,
                                  shared_prefix_len=20), _model(), pairs, coll)
    with pytest.raises(ValueError, match="diverges"):
        trainer2.train()


def test_compact_head_and_its_overflow_check(data, tmp_path):
    """compact_len > 0 makes "auto" pick the compact head; an undersized
    compact_len (the answers have ~13 loss positions) hard-fails."""
    pairs, coll = data
    tr = DPOTrainer(_config(tmp_path / "ok", steps=1, compact_len=32), _model(), pairs,
                    coll)
    assert tr.hp.lm_head_impl == "compact"
    tr.train()
    tr = DPOTrainer(_config(tmp_path / "over", steps=2, compact_len=4), _model(), pairs,
                    coll)
    with pytest.raises(ValueError, match="compact head overflow"):
        tr.train()


@pytest.mark.parametrize("head,compact_len,hidden,want", [
    ("auto", 0, 4096, "fused"), ("auto", 0, 64, "xla"),
    ("auto", 32, 4096, "fused"), ("auto", 32, 64, "xla"),
    ("xla", 32, 4096, "xla"), ("fused", 0, 64, "fused"),
])
def test_precompute_head_follows_train_py(head, compact_len, hidden, want):
    """The reference-logp precompute resolves its head as train.py does:
    "auto" is fused at hidden >= 2048, else "xla", whatever compact_len
    (which the precompute is not given); the train step's own "auto" still
    picks the compact head when compact_len > 0."""
    training = Config().training
    training.lm_head_impl, training.compact_len = head, compact_len
    assert precompute_head(training, hidden, torch.bfloat16) == want
    if head == "auto" and compact_len:
        assert resolve_head(training, hidden, torch.bfloat16) == "compact"


def test_non_finite_loss_stops_the_run(data, tmp_path):
    pairs, coll = data
    model = _model()
    with torch.no_grad():
        model.llm.lm_head.weight.fill_(float("nan"))
    tr = DPOTrainer(_config(tmp_path, steps=2), model, pairs, coll)
    with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
        tr.train()


def test_what_is_not_ported_raises(data, tmp_path):
    """The 7B "auto" head is the fused one (ported); LoRA and QLoRA on an
    int8 or int4 base are ported, the OmniLMM family is #9 and MiniCPM-V
    #10; each raises before anything is loaded."""
    training = Config().training
    assert resolve_head(training, 4096, torch.bfloat16) == "fused"
    assert resolve_head(training, 64, torch.bfloat16) == "xla"
    from rlaifv_tpu_torch.train.__main__ import main

    for model, item in (({"model_family": "omnilmm"}, "#9"),
                        ({"model_family": "minicpmv"}, "#10")):
        cfg = {"model": model, "training": {"output_dir": str(tmp_path / "out"),
                                            "use_lora": True}}
        (tmp_path / "cfg.json").write_text(json.dumps(cfg))
        with pytest.raises(NotImplementedError, match=item):
            main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu"])


@pytest.mark.parametrize("family,item", [("llava15", None), ("omnilmm", "#9"),
                                         ("minicpmv", "#10")])
def test_family_option_overrides_the_config(family, item, tmp_path, capsys):
    """`--family` sets model.model_family as train.py's does: llava15 runs
    the tiny demo on the CPU; OmniLMM (#9) and MiniCPM-V (#10) raise their
    NotImplementedError before anything is built, in the demo and with a
    config file."""
    from rlaifv_tpu_torch.train.__main__ import main

    argv = ["--demo", "--family", family, "--device", "cpu", "--max-steps", "1",
            "--output-dir", str(tmp_path / "out")]
    if item is None:
        assert main(argv) == 1
        assert "[demo:llava15] finished at step 1 on cpu" in capsys.readouterr().out
        return
    with pytest.raises(NotImplementedError, match=item):
        main(argv)
    (tmp_path / "cfg.json").write_text(json.dumps({"model": {"model_family": "llava15"}}))
    with pytest.raises(NotImplementedError, match=item):
        main(["--config", str(tmp_path / "cfg.json"), "--family", family, "--device", "cpu"])


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """Without a visible card and without --device cpu the entry point
    stops with an error before it builds anything."""
    from rlaifv_tpu_torch.train import __main__ as tmain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tmain, "run_demo", lambda *a: pytest.fail("ran without a card"))
    with pytest.raises(SystemExit) as exc:
        tmain.main(["--demo", "--output-dir", str(tmp_path)])
    assert exc.value.code != 0 and "--device cpu" in str(exc.value.code)
    assert tmain.resolve_device("cpu") == torch.device("cpu")


def test_config_files_load_unchanged():
    """configs/*.json load into the jax-free Config as into the JAX one."""
    from rlaifv_tpu.core.config import Config as JConfig

    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        assert Config.from_json(path).to_dict() == JConfig.from_json(path).to_dict(), name


def _tiny_tokenizer(d):
    """A BPE tokenizer saved next to the tiny checkpoint (as
    tests/test_chat_cli.py builds one)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from tokenizers.processors import TemplateProcessing
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁")
    tok.decoder = decoders.Metaspace(replacement="▁")
    tok.train_from_iterator(
        ["a chat between user assistant car stop red light why did"] * 10,
        trainers.BpeTrainer(vocab_size=60, special_tokens=["<unk>", "<s>", "</s>"]))
    tok.post_processor = TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", tok.token_to_id("<s>"))])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>",
                                   eos_token="</s>", unk_token="<unk>",
                                   pad_token="<unk>")
    fast.save_pretrained(d)
    return fast


def _tiny_dims():
    """The geometry of tests/test_loader_variants.py's tiny checkpoint."""
    llm = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=2,
               num_heads=2, num_kv_heads=2)
    vision = dict(image_size=14, patch_size=7, hidden_size=16, intermediate_size=32,
                  num_layers=2, num_heads=2)
    return llm, vision


def _tiny_rows():
    """Four raw RLAIF-V rows in the tiny tokenizer's words, seeded PNGs."""
    import io

    from PIL import Image

    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(
            buf, format="PNG")
        rows.append({"idx": str(i), "question": "why did the car stop",
                     "chosen": "red light", "rejected": f"a user {'stop ' * (i + 1)}",
                     "image": {"bytes": buf.getvalue(), "path": f"{i}.png"},
                     "image_path": f"{i}.png", "origin_dataset": "tiny",
                     "origin_split": "{}"})
    return rows


def test_config_run_from_a_checkpoint_and_jax_reference_logps(tmp_path, monkeypatch):
    """`python -m rlaifv_tpu_torch.train --config` end to end on a tiny HF
    checkpoint: the JAX package precomputes the reference logps into the
    dataset directory (the port's own precompute is the next test),
    the port loads the same checkpoint through the numpy converter and the
    bridge, and trains 2 steps. Policy == reference at step 1, so its loss
    is ln 2 up to the two packages' fp32 differences (atol 1e-4: logps of
    ~-100 agree to ~1e-5 relative)."""
    import jax
    import jax.numpy as jnp

    from rlaifv_tpu.data.image_processing import ClipImageProcessor
    from rlaifv_tpu.models.clip_vit import CLIPVisionConfig as JCLIP
    from rlaifv_tpu.models.convert import load_llava_checkpoint
    from rlaifv_tpu.models.llama import LlamaConfig as JLlama
    from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
    from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
    from rlaifv_tpu.train.ref_logp import inference_logp
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.train import __main__ as tmain
    from tests.test_loader_variants import _make_tiny_llava_sd

    ckpt, data = str(tmp_path / "ckpt"), str(tmp_path / "data")
    _make_tiny_llava_sd(ckpt)
    tok = _tiny_tokenizer(ckpt)
    llm, vision = _tiny_dims()
    jcfg = JLlavaConfig(llm=JLlama(**llm), vision=JCLIP(**vision))
    n_img = jcfg.num_image_tokens
    rows = _tiny_rows()
    proc = ClipImageProcessor(image_size=14)
    params = load_llava_checkpoint(ckpt, vision_layers_to_run=jcfg.vision.layers_to_run)
    inference_logp(rows, JLlava(jcfg), jax.tree.map(jnp.asarray, params), tok, data,
                   max_len=512, num_patches=n_img, batch_pairs=2, image_processor=proc)

    tcfg = LlavaConfig(llm=LlamaConfig(**llm), vision=CLIPVisionConfig(**vision))
    monkeypatch.setattr(tmain, "build_llava", lambda config, device: (
        tcfg, LlavaForCausalLM(tcfg, device="meta").to_empty(device="cpu")))
    out = tmp_path / "out"
    cfg = {"model": {"model_name_or_path": ckpt},
           "data": {"data_dir": data, "max_len": 512},
           "training": {"output_dir": str(out), "max_steps": 2, "save_steps": 2,
                        "learning_rate": 1e-3, "warmup_ratio": 0.0,
                        "lm_head_impl": "xla", "shared_prefix_len": -1}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    assert tmain.main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu"]) == 2
    logged = [json.loads(x) for x in open(out / "metrics.jsonl")]
    steps = [m for m in logged if "loss" in m]
    assert [m["step"] for m in steps] == [1, 2]
    assert logged[0]["derived_shared_prefix_len"] > n_img  # the paired path ran
    np.testing.assert_allclose(steps[0]["loss"], np.log(2.0), atol=1e-4)
    assert os.listdir(out / "checkpoints") == ["2"]


def test_config_run_precomputes_reference_logps(tmp_path, monkeypatch):
    """`python -m rlaifv_tpu_torch.train --config ... --device cpu` on a
    dataset directory of raw parquet rows without logp files: the port
    scores them with the frozen starting policy (shared-prefix path, the
    fused head for rows that cannot share), writes the logp parquet in the
    JAX package's layout and values (atol 1e-4 on sums, 1e-5 per token:
    fp32 in both, other summation orders), and trains on it with the fused
    head; policy == reference at step 1, so the loss is ln 2 (atol 1e-4)."""
    import pandas as pd

    from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
    from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
    from rlaifv_tpu.train.ref_logp import inference_logp
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.convert import load_llava_checkpoint
    from rlaifv_tpu_torch.models.llama import LlamaConfig
    from rlaifv_tpu_torch.train import __main__ as tmain
    from tests.test_loader_variants import _make_tiny_llava_sd

    ckpt, data, jdata = (str(tmp_path / d) for d in ("ckpt", "data", "jdata"))
    _make_tiny_llava_sd(ckpt)
    tok = _tiny_tokenizer(ckpt)
    llm, vision = _tiny_dims()
    rows = _tiny_rows()
    os.makedirs(data)
    pd.DataFrame(rows).to_parquet(os.path.join(data, "raw-000.parquet"))

    tcfg = LlavaConfig(llm=LlamaConfig(**llm), vision=CLIPVisionConfig(**vision))
    monkeypatch.setattr(tmain, "build_llava", lambda config, device: (
        tcfg, LlavaForCausalLM(tcfg, device="meta").to_empty(device="cpu")))
    out = tmp_path / "out"
    cfg = {"model": {"model_name_or_path": ckpt},
           "data": {"data_dir": data, "max_len": 512},
           "training": {"output_dir": str(out), "max_steps": 2, "save_steps": 2,
                        "learning_rate": 1e-3, "warmup_ratio": 0.0,
                        "lm_head_impl": "fused", "shared_prefix_len": -1}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    from rlaifv_tpu_torch.train import ref_logp

    seen = []
    monkeypatch.setattr(ref_logp, "inference_logp", lambda *a, _f=ref_logp.inference_logp,
                        **kw: seen.append(kw) or _f(*a, **kw))
    assert tmain.main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu"]) == 2
    # train.py's call: the head resolved by precompute_head, no compact_len
    assert len(seen) == 1 and seen[0]["lm_head_impl"] == "fused"
    assert "compact_len" not in seen[0]

    # the JAX package's precompute on the same checkpoint and rows
    from rlaifv_tpu.data.image_processing import ClipImageProcessor
    from rlaifv_tpu.models.clip_vit import CLIPVisionConfig as JCLIP
    from rlaifv_tpu.models.llama import LlamaConfig as JLlama

    import jax
    import jax.numpy as jnp

    jcfg = JLlavaConfig(llm=JLlama(**llm), vision=JCLIP(**vision))
    params = load_llava_checkpoint(ckpt, vision_layers_to_run=jcfg.vision.layers_to_run)
    inference_logp(rows, JLlava(jcfg), jax.tree.map(jnp.asarray, params), tok, jdata,
                   max_len=512, num_patches=jcfg.num_image_tokens,
                   image_processor=ClipImageProcessor(image_size=14),
                   lm_head_impl="fused")
    name = "RLAIF-V-Dataset-withlogp_000-4.parquet"
    assert sorted(f for f in os.listdir(data) if "logp" in f) == [name]
    got, want = (pd.read_parquet(os.path.join(d, name)) for d in (data, jdata))
    assert list(got.columns) == list(want.columns)
    for a, b in zip(got["logps"], want["logps"]):
        a, b = json.loads(a)["logps"], json.loads(b)["logps"]
        np.testing.assert_allclose([a[0], a[3]], [b[0], b[3]], atol=1e-4)
        for k in (1, 2, 4, 5):
            np.testing.assert_allclose(a[k], b[k], atol=1e-5)

    logged = [json.loads(x) for x in open(out / "metrics.jsonl")]
    steps = [m for m in logged if "loss" in m]
    assert [m["step"] for m in steps] == [1, 2]
    np.testing.assert_allclose(steps[0]["loss"], np.log(2.0), atol=1e-4)


def test_lora_trainer_checkpoints_adapters_and_resumes(data, tmp_path):
    """QLoRA on the trainer: the int8 base stays as it was, the adapters
    train, a checkpoint holds the adapters (by flax path) and their AdamW
    state and nothing of the base, and a fresh trainer on other adapters
    resumes from it bit for bit."""
    from rlaifv_tpu_torch.models.convert import quantize_llm_int8
    from rlaifv_tpu_torch.train.lora import lora_init
    from rlaifv_tpu_torch.train.train_step import named_tensors

    pairs, coll = data
    model = quantize_llm_int8(_model(), include_lm_head=False)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    lora = lora_init(torch.Generator().manual_seed(0), model, r=4)
    c = _config(tmp_path, use_lora=True)
    trainer = DPOTrainer(c, model, pairs, coll, lora=lora, lora_alpha=16.0)
    assert trainer.use_lora and trainer.device == torch.device("cpu")
    assert trainer.train() == 4
    for k, v in model.state_dict().items():
        assert torch.equal(v, base[k]), k
    names = [n for n, _ in named_tensors(lora)]
    assert len(names) == 2 * 7 * 2  # a and b of 7 projections x 2 layers
    state = CheckpointManager(str(tmp_path / "checkpoints")).restore()
    assert sorted(state["params"]) == sorted(names)
    assert sorted(state["opt_state"]["mu"]) == sorted(names)
    assert not any(n.endswith("b") and not state["params"][n].any() for n in names)
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in lines)

    model2 = quantize_llm_int8(_model(), include_lm_head=False)
    lora2 = lora_init(torch.Generator().manual_seed(1), model2, r=4)
    trainer2 = DPOTrainer(_config(tmp_path, steps=6, use_lora=True), model2, pairs, coll,
                          lora=lora2)
    assert trainer2.start_step == 4 and trainer2.optimizer.count == 4
    for (name, a), (_, b) in zip(named_tensors(lora), named_tensors(lora2)):
        assert torch.equal(a.detach(), b.detach()), name
        assert torch.equal(trainer.optimizer.nu[name], trainer2.optimizer.nu[name])
    assert trainer2.train() == 6


def test_quantize_without_lora_fails_as_train_py_does(tmp_path):
    """train.py asserts that a quantised base trains alongside adapters;
    the port's entry point fails the same way, before loading anything."""
    from rlaifv_tpu_torch.train.__main__ import main

    cfg = {"model": {"quantize": True}, "training": {"output_dir": str(tmp_path / "o")}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    with pytest.raises(AssertionError, match="combine with training.use_lora"):
        main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu"])
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("logps", ["jax-logp-files", "precompute"])
def test_config_qlora_run(tmp_path, monkeypatch, logps):
    _qlora_run(tmp_path, monkeypatch, logps, bits=8)


@pytest.mark.parametrize("logps", ["jax-logp-files", "precompute"])
def test_config_qlora_int4_run(tmp_path, monkeypatch, logps):
    _qlora_run(tmp_path, monkeypatch, logps, bits=4)


def _qlora_run(tmp_path, monkeypatch, logps, bits):
    """`--config` with quantize and use_lora (configs/llava15_dpo_qlora.json's
    model and adapter settings, r 4), `quantize_bits` 8 or 4, on the tiny
    HF checkpoint: the port loads it, quantises the LLM's projections to
    int8 or packed int4 (the head stays float), scores the reference logps
    on that base when the dataset has none (compared with the JAX package's
    precompute on its own quantize_llm_int8 / quantize_llm_int4 base: sums
    atol 1e-4, per token and means 1e-5, fp32 in both), or reads the JAX
    package's, and trains 2 LoRA steps; policy == reference at step 1 (b =
    0), so the loss is ln 2 (atol 1e-4). The checkpoint holds the adapters
    only. (This tokenizer's rows end with their labels masked, so the steps'
    gradients are zero here; the trainer test above trains.)"""
    import jax
    import jax.numpy as jnp
    import pandas as pd

    from rlaifv_tpu.data.image_processing import ClipImageProcessor
    from rlaifv_tpu.models.clip_vit import CLIPVisionConfig as JCLIP
    from rlaifv_tpu.models.convert import load_llava_checkpoint as jload
    from rlaifv_tpu.models.convert import quantize_llm_int4, quantize_llm_int8
    from rlaifv_tpu.models.llama import LlamaConfig as JLlama
    from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
    from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
    from rlaifv_tpu.train.ref_logp import inference_logp
    from rlaifv_tpu_torch.models.clip_vit import CLIPVisionConfig
    from rlaifv_tpu_torch.models.llama import LlamaConfig, QuantDense
    from rlaifv_tpu_torch.train import __main__ as tmain
    from tests.test_loader_variants import _make_tiny_llava_sd

    ckpt, data, jdata = (str(tmp_path / d) for d in ("ckpt", "data", "jdata"))
    _make_tiny_llava_sd(ckpt)
    tok = _tiny_tokenizer(ckpt)
    llm, vision = _tiny_dims()
    rows = _tiny_rows()
    jcfg = JLlavaConfig(llm=JLlama(**llm, quantize=True, quantize_bits=bits,
                                   quantize_lm_head=False), vision=JCLIP(**vision))
    params = jload(ckpt, vision_layers_to_run=jcfg.vision.layers_to_run)
    params["llm"] = quantize_llm_int4(params["llm"]) if bits == 4 else \
        quantize_llm_int8(params["llm"], include_lm_head=False)
    inference_logp(rows, JLlava(jcfg), jax.tree.map(jnp.asarray, params), tok,
                   jdata if logps == "precompute" else data, max_len=512,
                   num_patches=jcfg.num_image_tokens, batch_pairs=2,
                   image_processor=ClipImageProcessor(image_size=14))
    if logps == "precompute":
        os.makedirs(data)
        pd.DataFrame(rows).to_parquet(os.path.join(data, "raw-000.parquet"))

    tcfg = LlavaConfig(llm=LlamaConfig(**llm), vision=CLIPVisionConfig(**vision))
    built = []
    monkeypatch.setattr(tmain, "build_llava", lambda config, device: (
        tcfg, built.append(LlavaForCausalLM(tcfg, device="meta").to_empty(device="cpu"))
        or built[-1]))
    out = tmp_path / "out"
    cfg = {"model": {"model_name_or_path": ckpt, "quantize": True, "quantize_bits": bits},
           "data": {"data_dir": data, "max_len": 512},
           "training": {"output_dir": str(out), "max_steps": 2, "save_steps": 2,
                        "learning_rate": 1e-3, "warmup_ratio": 0.0, "use_lora": True,
                        "lora_r": 4, "lora_alpha": 16, "lm_head_impl": "xla",
                        "shared_prefix_len": -1}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    assert tmain.main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu"]) == 2
    model = built[0]
    down = model.llm.model.layers[0].mlp.down_proj
    assert isinstance(down, QuantDense) and down.bits == bits
    assert down.q.shape == ((16, 16) if bits == 4 else (32, 16))
    assert not isinstance(model.llm.lm_head, QuantDense) and model.cfg.llm.quantize
    assert model.cfg.llm.quantize_bits == bits

    if logps == "precompute":
        name = "RLAIF-V-Dataset-withlogp_000-4.parquet"
        got, want = (pd.read_parquet(os.path.join(d, name)) for d in (data, jdata))
        for a, b in zip(got["logps"], want["logps"]):
            a, b = json.loads(a)["logps"], json.loads(b)["logps"]
            np.testing.assert_allclose([a[0], a[3]], [b[0], b[3]], atol=1e-4)
            for k in (1, 2, 4, 5):
                np.testing.assert_allclose(a[k], b[k], atol=1e-5)
    logged = [json.loads(x) for x in open(out / "metrics.jsonl")]
    steps = [m for m in logged if "loss" in m]
    assert [m["step"] for m in steps] == [1, 2]
    np.testing.assert_allclose(steps[0]["loss"], np.log(2.0), atol=1e-4)
    state = CheckpointManager(str(out / "checkpoints")).restore()
    assert all(k.startswith("llm/model/layer_") and k[-2:] in ("/a", "/b")
               for k in state["params"])
    assert len(state["params"]) == 2 * 7 * llm["num_layers"]
