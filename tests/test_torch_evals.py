"""The port's evals slice against the JAX package's, on the CPU.

- `rlaifv_tpu_torch/evals/{gpt_client,text_utils,object_halbench,mmhal,
  refomb,report,summaries}.py` are copies: each case runs one piece of both
  packages on tests/test_evals.py's and tests/test_report.py's inputs, with
  the same stub transports, and compares the outputs exactly; the data
  files are byte-equal.
- `evals/run_eval.py` against scripts/run_eval.py: Object HalBench without
  GPT on a synthetic COCO directory, MMHal and RefoMB through a stub
  transport; both write the same files with the same contents.
- `evals/vqa.generate_answers` with 3 beams on a tiny bridged LLaVA against
  the JAX one (the same rows).
- `models/convert.py`'s `llava_config_from_hf`, `clip_config_from_hf`,
  `convert_peft_lora` and `load_pretrained_llava` (full, LoRA over a base
  with non_lora_trainables.bin, projector-only, int8 and int4) against the
  JAX ones on checkpoints written here, as tests/test_loader_variants.py
  writes them.
- The entry points stop with an error when the card is asked for and none
  is visible.
"""
import csv
import dataclasses
import filecmp
import importlib
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import run_eval as jrun_eval  # noqa: E402

from rlaifv_tpu_torch.evals import run_eval as trun_eval  # noqa: E402
from tests.test_torch_data_copies import _deep_equal  # noqa: E402

DATA = sorted(p.name for p in (ROOT / "rlaifv_tpu" / "evals" / "data").iterdir())


def _pkg(name):
    def pkg(mod):
        return importlib.import_module(f"{name}.{mod}")

    pkg.root = name
    return pkg


PKGS = (_pkg("rlaifv_tpu"), _pkg("rlaifv_tpu_torch"))


def _stub_chat(pkg, reply_fn):
    def transport(model, messages, **kw):
        return reply_fn(messages), {"total_tokens": 10}

    return pkg("evals.gpt_client").Chat(model="stub", transport=transport)


@pytest.mark.parametrize("name", DATA)
def test_data_files_are_byte_equal(name):
    assert filecmp.cmp(ROOT / "rlaifv_tpu" / "evals" / "data" / name,
                       ROOT / "rlaifv_tpu_torch" / "evals" / "data" / name, shallow=False)


def test_data_dirs_point_at_the_port():
    for mod in ("object_halbench", "mmhal", "refomb"):
        m = importlib.import_module(f"rlaifv_tpu_torch.evals.{mod}")
        assert Path(m.DATA_DIR).resolve() == ROOT / "rlaifv_tpu_torch" / "evals" / "data"


# ------------------------------------------------------------ cases


def case_text_utils(pkg):
    tu = pkg("evals.text_utils")
    words = ["cats", "benches", "people", "glass", "bus", "skis", "ponies", "dresses"]
    return {"lemma": [tu.lemmatize(w) for w in words],
            "tok": tu.tokenize("Two cats, one dog."),
            "np": tu.noun_phrases(tu.tokenize("A black dog with red frisbees on the grass"))}


def case_chair(pkg):
    oh = pkg("evals.object_halbench")
    m = oh.SynonymMapper()
    caps = [{"image_id": 1, "caption": "A dog and a cat."},
            {"image_id": 2, "caption": "A sandwich on a table."}]
    gt = {1: {"dog"}, 2: {"sandwich", "dining table"}}
    return {"map": m.caption_to_coco("A baby dog next to two motor bikes and a wine glass."),
            "parse": [oh.parse_object_list('["cat", "dog"]'),
                      oh.parse_object_list('text\n["car"]')],
            "chair": oh.compute_chair(caps, gt, m)}


def case_gpt_extraction(pkg):
    oh = pkg("evals.object_halbench")
    chat = _stub_chat(pkg, lambda msgs: '["black dog", "red frisbees"]')
    caps = [{"image_id": i, "caption": f"c{i}", "question": "q"} for i in range(3)]
    out, used, _ = oh.extract_objects_gpt(caps, chat, max_workers=2)
    return {"out": out, "used": used,
            "refined": oh.refine_extracted_objects(out, oh.SynonymMapper())}


def case_mmhal(pkg):
    mm = pkg("evals.mmhal")
    rows = [dict(r, model_answer="A test answer.") for r in mm.load_answer_template()]
    responses = mm.judge(rows, chat=_stub_chat(pkg, lambda m: "Analysis...\nRating: 4, fine"),
                         max_workers=4)
    mixed = [{"choices": [{"message": {"content": f"Rating: {i % 7}"}}]}
             for i in range(mm.NUM_QUESTIONS)]
    return {"parse": [mm.parse_rating("... Rating: 5, very informative"),
                      mm.parse_rating("no rating here")],
            "responses": responses, "summary": mm.summarize(responses),
            "mixed": mm.summarize(mixed), "template": mm.load_template()}


def _refomb_items():
    return [{"question": f"q{i}", "description": "desc", "model_answer": "good",
             "baseline_answer": "bad", "type_name": "Description-Simple"}
            for i in range(6)]


def case_refomb(pkg):
    rf = pkg("evals.refomb")
    rows = rf.judge_pairwise(_refomb_items(), chat=_stub_chat(pkg, lambda m: "[[A]]"),
                             max_workers=2, seed=0)
    hall = rf.judge_hallucination(
        rows, chat=_stub_chat(pkg, lambda m: "model A made stuff up. [[B]]"), max_workers=2)
    failed = rf.judge_hallucination(
        [{"judge_output": pkg("evals.gpt_client").FAIL_SENTINEL, "model_is_A": True},
         {"judge_output": "review", "model_is_A": False}],
        chat=_stub_chat(pkg, lambda m: "[[C]]"), max_workers=1)
    return {"verdicts": [rf.parse_verdict(s) for s in ("blah [[A]] blah", "[[B]]", "[[C]]")],
            "rows": rows, "summary": rf.summarize(rows), "hall": hall,
            "hall_summary": rf.summarize_hallucination(hall), "failed": failed,
            "failed_summary": rf.summarize_hallucination(failed),
            "dev": rf.load_dev_set()[:3], "gpt4v": rf.load_gpt4v_answers()[:3],
            "query": rf.build_query("q", "desc", "a", "b"),
            "system": rf.load_system_msg(), "hall_msg": rf.load_hallucination_msg()}


def _report_rows():
    prompt = (
        "[Beginning of the detailed description of the picture]desc here"
        "[End of the detailed description of the picture]\n"
        "[Beginning of the user's question]what color?[End of the user's question]\n"
        "[Beginning of Model A's answer]blue[End of Model A's answer]\n"
        "[Beginning of Model B's answer]red[End of Model B's answer]"
    )
    return [{"modelA": "ours", "modelB": "gpt4v", "type_name": t, "score": s,
             "prompt": p} for t, s, p in (("OCR", 1, prompt), ("OCR", -1, prompt),
                                          ("Coarse Perception", 0, prompt),
                                          ("Coarse Perception", 1, ""),
                                          ("OCR", None, prompt))]


def case_report(pkg, tmp_path):
    rp = pkg("evals.report")
    (tmp_path / pkg.root).mkdir()
    paths = rp.export_refomb_reports(_report_rows(), str(tmp_path / pkg.root / "refomb"))
    csvs = []
    for p in paths:
        with open(p, newline="") as f:
            csvs.append(list(csv.DictReader(f)))
    return {"summary": rp.refomb_summary_table(_report_rows()),
            "all": rp.refomb_all_data_table(_report_rows()), "csv": csvs,
            "names": [os.path.basename(p) for p in paths]}


def case_summaries(pkg, tmp_path):
    sm = pkg("evals.summaries")
    metrics = {"CHAIRs_refine": 0.25, "CHAIRi": 0.125, "correct_rate": 0.75,
               "object_correct_rate": 0.875, "obj_rec": 0.5, "coco_sentence_num": 12,
               "avg_word_len": 12.5, "coco_word_count": 9, "gt_word_count": 7}
    base = tmp_path / pkg.root / "reviews"
    for step in (1, 2):
        d = base / "llava-7b" / "run" / f"checkpoint-{step}"
        d.mkdir(parents=True)
        json.dump({"overall_metrics": dict(metrics, obj_rec=step / 4)},
                  open(d / "hall_obj_halbench_answer.json", "w"))
    return {"chair": sm.chair_summary(metrics),
            "collected": sm.collect_obj_halbench_reviews(str(base))}


def case_gpt_client(pkg):
    gc = pkg("evals.gpt_client")

    def down(model, messages, **kw):
        raise ConnectionError("down")

    chat = gc.Chat(model="x", transport=down, backoff_base=0.0)
    return chat.chat_completion([{"role": "user", "content": "hi"}], fail_limit=2)


CASES = [case_text_utils, case_chair, case_gpt_extraction, case_mmhal, case_refomb,
         case_gpt_client]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_eval_copies_match_jax(case):
    _deep_equal(case(PKGS[1]), case(PKGS[0]))


@pytest.mark.parametrize("case", [case_report, case_summaries], ids=lambda c: c.__name__)
def test_eval_file_copies_match_jax(case, tmp_path):
    _deep_equal(case(PKGS[1], tmp_path), case(PKGS[0], tmp_path))


# ------------------------------------------------------------ run_eval


def _coco_dir(tmp_path):
    d = str(tmp_path / "coco")
    os.makedirs(d, exist_ok=True)
    json.dump({"categories": [{"id": 1, "name": "dog"}, {"id": 2, "name": "cat"}],
               "annotations": [{"image_id": i, "category_id": 1 + (i % 5 == 0)}
                               for i in range(300)]},
              open(os.path.join(d, "instances_val2014.json"), "w"))
    json.dump({"annotations": [{"image_id": i, "caption": "A dog."} for i in range(300)]},
              open(os.path.join(d, "captions_val2014.json"), "w"))
    return d


def _write_answers(path, n):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"question_id": i, "image_id": i, "prompt": "Describe.",
                                "text": "A dog." if i % 2 else "A cat and a bench."}) + "\n")


@pytest.fixture
def stub_transport(monkeypatch):
    """Both gpt_client modules build their transport from this stub."""
    def transport(model, messages, **kw):
        text = messages[-1]["content"]
        if "Rating" in text or "rating" in text:
            return "Analysis.\nRating: 3, fine", {}
        return f"review of {len(text)} chars. [[{'ABC'[len(text) % 3]}]]", {}

    for mod in ("rlaifv_tpu.evals.gpt_client", "rlaifv_tpu_torch.evals.gpt_client"):
        monkeypatch.setattr(importlib.import_module(mod), "openai_http_transport",
                            lambda **kw: transport)


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            text = f.read()
        try:
            out[name] = json.loads(text)
        except json.JSONDecodeError:
            out[name] = [json.loads(line) for line in text.splitlines() if line.strip()]
    return out


def test_run_eval_objhal_matches_scripts(tmp_path, capsys):
    answers = str(tmp_path / "answers.jsonl")
    _write_answers(answers, 300)
    coco = _coco_dir(tmp_path)
    want = jrun_eval.eval_objhal(answers, coco, str(tmp_path / "jax"), use_gpt=False)
    want_out = capsys.readouterr().out
    got = trun_eval.eval_objhal(answers, coco, str(tmp_path / "torch"), use_gpt=False)
    assert capsys.readouterr().out == want_out and "response_hall" in want_out
    assert os.path.basename(got) == os.path.basename(want)
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


def test_run_eval_mmhal_matches_scripts(tmp_path, stub_transport, capsys):
    from rlaifv_tpu_torch.evals.mmhal import NUM_QUESTIONS

    answers = str(tmp_path / "mmhal_answers.json")
    json.dump([{"question_id": i, "text": f"answer {i}"} for i in range(NUM_QUESTIONS)],
              open(answers, "w"))
    want = jrun_eval.eval_mmhal(answers, str(tmp_path / "jax"))
    got = trun_eval.eval_mmhal(answers, str(tmp_path / "torch"))
    _deep_equal(got, want)
    assert want["average_score"] == 3.0
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


def test_run_eval_refomb_matches_scripts(tmp_path, stub_transport, capsys):
    from rlaifv_tpu_torch.evals.refomb import load_dev_set

    answers = str(tmp_path / "refomb_answers.jsonl")
    with open(answers, "w") as f:
        for i in range(len(load_dev_set())):
            f.write(json.dumps({"question_id": i, "text": f"answer {i % 7}"}) + "\n")
    want = jrun_eval.eval_refomb(answers, str(tmp_path / "jax"))
    got = trun_eval.eval_refomb(answers, str(tmp_path / "torch"))
    _deep_equal(got, want)
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    assert set(os.listdir(tmp_path / "torch")) == {"refomb_reviews.jsonl",
                                                    "refomb_reviews.hall.jsonl"}


def test_run_eval_main_objhal(tmp_path, capsys):
    answers = str(tmp_path / "answers.jsonl")
    _write_answers(answers, 300)
    trun_eval.main(["objhal", "--answers", answers, "--out-dir", str(tmp_path / "out"),
                    "--coco-path", _coco_dir(tmp_path), "--no-gpt"])
    assert "response_hall" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "out" / "hall_obj_halbench_answer.json")


# ------------------------------------------------------------ vqa


@pytest.fixture(scope="module")
def gens():
    import jax
    import jax.numpy as jnp

    from rlaifv_tpu.genai.llava_gen import Llava15Generator as JGenerator
    from rlaifv_tpu.models.llava import LlavaConfig as JLlavaConfig
    from rlaifv_tpu.models.llava import LlavaForCausalLM as JLlava
    from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
    from rlaifv_tpu_torch.models.convert import load_jax_params
    from rlaifv_tpu_torch.models.llava import LlavaConfig, LlavaForCausalLM
    from tests.fake_tokenizer import FakeTokenizer

    cfg = JLlavaConfig.tiny()
    P, S = cfg.num_image_tokens, cfg.vision.image_size
    params = JLlava(cfg).init(jax.random.PRNGKey(1), jnp.ones((1, P + 8), jnp.int32),
                              images=jnp.zeros((1, S, S, 3)),
                              image_starts=jnp.asarray([0]))["params"]
    tok = FakeTokenizer()
    jgen = JGenerator(JLlava(cfg), params, tok, P, image_size=S, checkpoint_name="t")
    tmodel = load_jax_params(LlavaForCausalLM(LlavaConfig.tiny()), params).eval()
    return cfg, jgen, Llava15Generator(tmodel, tok, P, image_size=S, checkpoint_name="t")


def _bench_rows(cfg, n):
    import base64
    import io

    from PIL import Image

    rng = np.random.default_rng(3)
    S = cfg.vision.image_size
    rows = []
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (S, S, 3), dtype=np.uint8)).save(buf, "PNG")
        rows.append({"question_id": i, "question": f"Describe image {i} in detail.",
                     "image": base64.b64encode(buf.getvalue()).decode(),
                     "metainfos": {"k": i}})
    return rows


@pytest.mark.parametrize("num_chunks,chunk_idx", [(1, 0), (2, 1)])
def test_generate_answers_beam3_matches_jax(gens, num_chunks, chunk_idx):
    from rlaifv_tpu.evals import vqa as jvqa
    from rlaifv_tpu_torch.evals import vqa as tvqa

    cfg, jgen, tgen = gens
    rows = _bench_rows(cfg, 5)
    kw = dict(max_new_tokens=6, batch_size=2, num_chunks=num_chunks, chunk_idx=chunk_idx,
              model_id="tiny", num_beams=3)
    want = jvqa.generate_answers(jgen, rows, **kw)
    got = tvqa.generate_answers(tgen, rows, **kw)
    assert got == want


@pytest.mark.parametrize("module,args", [
    ("rlaifv_tpu_torch.evals.vqa", ["--model-path", "m", "--question-file", "q",
                                    "--answers-file", "a"]),
    ("rlaifv_tpu_torch.iteration", ["--config", "c", "--ques-file", "q", "--eval-file", "e",
                                    "--coco-path", "c", "--divide-model", "d",
                                    "--work-dir", "w"]),
])
def test_entry_points_need_the_card_unless_told(module, args):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry point would run")
    with pytest.raises(SystemExit, match="no CUDA device is visible"):
        importlib.import_module(module).main(args)


# ------------------------------------------------------------ loaders


def _tiny_ckpt(path, seed=0):
    from tests.test_loader_variants import _make_tiny_llava_sd

    sd = _make_tiny_llava_sd(path, seed)
    json.dump({"vocab_size": 64, "hidden_size": 16, "intermediate_size": 32,
               "num_hidden_layers": 2, "num_attention_heads": 2,
               "num_key_value_heads": 2, "max_position_embeddings": 32,
               "rope_theta": 5e5, "rms_norm_eps": 1e-5, "mm_projector_type": "mlp2x_gelu",
               "mm_vision_select_layer": -1,
               "vision_config": {"image_size": 14, "patch_size": 7, "hidden_size": 16,
                                 "intermediate_size": 32, "num_hidden_layers": 2,
                                 "num_attention_heads": 2}},
              open(os.path.join(path, "config.json"), "w"))
    return sd


def _cfg_fields(cfg):
    """A config as plain values (dtypes by name), for both packages."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = _cfg_fields(v) if dataclasses.is_dataclass(v) else (
            re.sub(r"\W", "", str(v).split(".")[-1]) if "dtype" in f.name else v)
    return out


def test_llava_and_clip_config_from_hf_match_jax(tmp_path):
    from rlaifv_tpu.models import convert as jconv
    from rlaifv_tpu_torch.models import convert as tconv

    d = str(tmp_path / "ckpt")
    _tiny_ckpt(d)
    want, got = _cfg_fields(jconv.llava_config_from_hf(d)), _cfg_fields(
        tconv.llava_config_from_hf(d))
    for part in ("llm", "vision"):
        common = set(want[part]) & set(got[part])
        assert {k: got[part][k] for k in common} == {k: want[part][k] for k in common}
    for k in ("projector_type", "image_aspect_ratio", "image_grid_pinpoints",
              "mm_patch_merge_type"):
        assert got[k] == want[k]
    assert tconv.llava_config_from_hf(d).num_image_tokens == 4
    want_c, got_c = (_cfg_fields(m.clip_config_from_hf(d)) for m in (jconv, tconv))
    assert {k: got_c[k] for k in got_c if k in want_c} == \
        {k: want_c[k] for k in got_c if k in want_c}
    # no config.json: the 7B defaults; overrides reach both sub-configs
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    c = tconv.llava_config_from_hf(empty, llm=bf16, vision=bf16)
    assert (c.llm.hidden_size, c.llm.num_layers, c.vision.image_size) == (4096, 32, 336)
    assert c.llm.dtype == c.vision.param_dtype == torch.bfloat16
    assert c.num_image_tokens == 576


def _load_both(*args, **kw):
    from rlaifv_tpu.models import convert as jconv
    from rlaifv_tpu_torch.models import convert as tconv

    want = jconv.load_pretrained_llava(*args, **kw)
    got = tconv.load_pretrained_llava(*args, **kw)
    return jax_tree_np(want), got


def jax_tree_np(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _lora_dir(tmp_path, with_non_lora: bool):
    d = str(tmp_path / "lora")
    os.makedirs(d)
    g = torch.Generator().manual_seed(1)
    from safetensors.torch import save_file

    save_file({
        "base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight": torch.randn(2, 16, generator=g),
        "base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight": torch.randn(16, 2, generator=g),
        "base_model.model.model.layers.1.mlp.down_proj.lora_A.weight": torch.randn(2, 32, generator=g),
        "base_model.model.model.layers.1.mlp.down_proj.lora_B.weight": torch.randn(16, 2, generator=g),
    }, os.path.join(d, "adapter_model.safetensors"))
    if with_non_lora:
        torch.save({"base_model.model.model.mm_projector.0.weight": torch.randn(16, 16, generator=g),
                    "base_model.model.model.mm_projector.0.bias": torch.randn(16, generator=g),
                    "base_model.model.model.mm_projector.2.weight": torch.randn(16, 16, generator=g),
                    "base_model.model.model.mm_projector.2.bias": torch.randn(16, generator=g)},
                   os.path.join(d, "non_lora_trainables.bin"))
    return d


@pytest.mark.parametrize("layout", ["full", "lora", "lora+non_lora", "projector", "int8", "int4"])
def test_load_pretrained_llava_matches_jax(tmp_path, layout):
    base = str(tmp_path / "base")
    _tiny_ckpt(base)
    if layout in ("full", "int8", "int4"):
        q = {"full": False, "int8": True, "int4": "int4"}[layout]
        want, got = _load_both(base, quantize_llm=q)
    elif layout.startswith("lora"):
        d = _lora_dir(tmp_path, layout == "lora+non_lora")
        want, got = _load_both(d, base, lora_alpha=8.0)
    else:
        d = str(tmp_path / "delta")
        os.makedirs(d)
        torch.save({"model.mm_projector.0.weight": torch.ones(16, 16),
                    "model.mm_projector.0.bias": torch.zeros(16),
                    "model.mm_projector.2.weight": torch.ones(16, 16) * 2,
                    "model.mm_projector.2.bias": torch.zeros(16)},
                   os.path.join(d, "non_lora_trainables.bin"))
        want, got = _load_both(d, base)
    _deep_equal(got, want)


def test_loaded_checkpoint_runs_in_the_port(tmp_path):
    """A tree from load_pretrained_llava loads into a model built from
    llava_config_from_hf (int8 too) and the generator answers."""
    from rlaifv_tpu_torch.evals.vqa import load_generator
    from rlaifv_tpu_torch.models import convert as tconv
    from rlaifv_tpu_torch.models.llava import LlavaForCausalLM
    from tests.fake_tokenizer import FakeTokenizer

    base = str(tmp_path / "base")
    _tiny_ckpt(base)
    cfg = tconv.llava_config_from_hf(base, llm={"quantize": True})
    model = tconv.load_jax_params(LlavaForCausalLM(cfg),
                                  tconv.load_pretrained_llava(base, quantize_llm=True))
    assert model.llm.model.layers[0].attn.q_proj.q.dtype == torch.int8
    gen = load_generator(base, "cpu", tokenizer=FakeTokenizer())
    assert gen.num_patches == 4 and gen.model.cfg.llm.dtype == torch.float32
    ids = torch.arange(3, 9)[None]
    with torch.no_grad():
        want, _ = model.llm(input_ids=ids)
        got, _ = gen.model.llm(input_ids=ids)
    err = (got - want).abs().max().item()
    assert err < 0.05 * want.abs().max().item() + 0.05, err  # int8 against fp32
