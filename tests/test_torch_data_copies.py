"""The port's copies of the JAX package's numpy modules give the originals'
outputs on the same inputs.

rlaifv_tpu_torch keeps its own `constants`, `data/*`, `utils/file_io`,
`utils/prefetch`, `data/augment`, the llava15 `train/family` spec, the HF-checkpoint
loader and `fuse_llm_projections` of `models/convert`,
`quantize_kernel_int8`, the numpy int4 helpers of `ops/int4_matmul`, the
tree helpers of `train/lora` and the KV-cache quantiser of
`ops/decode_attention`, and `pairs/{construction,preference,
length_filter}` (it imports nothing of rlaifv_tpu). Each case
runs one piece of both packages and compares the results exactly: the
copies are the same numpy code.
"""
import io
import os
from functools import partial
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _deep_equal(a, b, path="out"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _deep_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _deep_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    elif hasattr(a, "__dataclass_fields__"):
        _deep_equal(vars(a), vars(b), path)
    else:
        assert a == b, (path, a, b)


def _pairs(c, rng):
    """(rej, win) pairs with an image sentinel, as the collator takes them."""
    out = []
    for _ in range(3):
        q = rng.integers(5, 60, 6).tolist()
        image = rng.normal(size=(14, 14, 3)).astype(np.float32)

        def side(n):
            ans = rng.integers(5, 60, n).tolist()
            ids = [1, *q[:3], c.IMAGE_TOKEN_INDEX, *q[3:], *ans, 2]
            labels = [c.IGNORE_INDEX] * (len(ids) - n - 1) + ans + [2]
            return {"input_ids": np.asarray(ids), "labels": np.asarray(labels),
                    "image": image, "ref_win_logp": -1.0, "ref_win_avg_logp": -0.1,
                    "ref_rej_logp": -2.0, "ref_rej_avg_logp": -0.2}

        win = side(int(rng.integers(3, 9)))
        out.append((side(int(rng.integers(3, 9))), win))
    return out


def case_constants(pkg):
    c = pkg("constants")
    return {k: v for k, v in vars(c).items() if k.isupper()}


def case_collator(pkg):
    c = pkg("constants")
    coll = pkg("data.collator").DPOCollator(pad_token_id=0, max_len=64, num_patches=4,
                                            beta=0.1)
    return coll(_pairs(c, np.random.default_rng(0)))


def case_conversation(pkg):
    conv_lib = pkg("data.conversation")
    out = {}
    for name in sorted(conv_lib.conv_templates):
        conv = conv_lib.conv_templates[name].copy()
        conv.append_message(conv.roles[0], "<image>\nWhat is this?")
        conv.append_message(conv.roles[1], None)
        out[name] = conv.get_prompt()
    return out


def case_preprocess_v1(pkg):
    from tests.fake_tokenizer import FakeTokenizer

    pre = pkg("data.preprocess")
    src = {"question": {"from": "human", "value": "<image>\nWhat is in the image?"},
           "chosen": {"from": "gpt", "value": "A cat on a mat."},
           "rejected": {"from": "gpt", "value": "A dog under a hat."}}
    mm = {"is_multimodal": True, "image_token_len": 4, "use_im_start_end": False,
          "keep_image_tag": True}
    return pre.encode_preference_sample(src, FakeTokenizer(), mm,
                                        preprocess_func=partial(pre.preprocess_v1,
                                                                has_image=True))


def case_multimodal(pkg):
    from tests.fake_tokenizer import FakeTokenizer

    mm = pkg("data.multimodal")
    c = pkg("constants")
    ids = mm.tokenizer_image_token("USER: <image>\nHi there ASSISTANT:", FakeTokenizer())
    labels = np.full(len(ids), c.IGNORE_INDEX)
    return ids, mm.expand_image_sentinels(np.asarray(ids), labels, 5, 64)


def case_diff_lib(pkg):
    d = pkg("data.diff_lib")
    return d.get_diff_ids([1, 2, 3, 4, 5, 6], [1, 2, 9, 9, 5, 6, 7])


def case_clip_preprocessor(pkg):
    ip = pkg("data.image_processing")
    raw = (ROOT / "examples" / "test.jpeg").read_bytes()
    return {aspect: ip.ClipImageProcessor(image_size=336, aspect_ratio=aspect)(raw)
            for aspect in ("pad", "square")}


def case_shard_indices(pkg):
    ds = pkg("data.datasets")
    return ([list(ds.shard_indices(n, w, r)) for n in (0, 7, 10) for w in (1, 3)
             for r in range(w)],
            [ds.chunk_indices(10, 3, i) for i in range(3)])


def case_parquet_round_trip(pkg, tmp_path):
    """write_logp_parquet, then the lazy-cache reader and DPODataset."""
    from PIL import Image

    from tests.fake_tokenizer import FakeTokenizer

    ds = pkg("data.datasets")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(
            buf, format="PNG")
        rows.append({"idx": str(i), "question": f"What is {i}?", "chosen": "A cat.",
                     "rejected": "A dog.", "image": {"bytes": buf.getvalue(),
                                                     "path": f"{i}.png"}})
    logps = [[-1.0 * i, -0.5, [-0.5, -0.5], -2.0, -1.0, [-1.0, -1.0]] for i in range(3)]
    d = tmp_path / pkg.__name__
    written = [os.path.basename(p) for p in ds.write_logp_parquet(rows, str(d), logps,
                                                                   rows_per_file=2)]
    mm = {"is_multimodal": True, "image_token_len": 4, "use_im_start_end": False,
          "image_processor": pkg("data.image_processing").ClipImageProcessor(image_size=14)}
    data = ds.DPODataset(FakeTokenizer(), str(d), mm)
    return written, [data[i] for i in range(len(data))]


def case_family_spec(pkg):
    from tests.fake_tokenizer import FakeTokenizer

    fam = pkg("train.family").get_family("llava15")
    c = pkg("constants")
    inst = {"input_ids": np.asarray([1, 5, c.IMAGE_TOKEN_INDEX, 6, 7, 2]),
            "labels": np.asarray([c.IGNORE_INDEX] * 4 + [7, 2])}
    mm = fam.mm_cfg(None, 4)
    return ({k: getattr(fam, k) for k in ("name", "keep_image_tag", "use_im_start_end",
                                          "expand_images_in_collator",
                                          "default_image_size", "image_aspect")},
            mm, fam.collator_kwargs(FakeTokenizer()),
            fam.expand_inst(inst, 4, 32, FakeTokenizer()),
            vars(fam.image_processor()), fam.preprocess_func.keywords)


def case_augment(pkg):
    """RandomAugment from one seed on a seeded image, several calls (each
    samples and applies n ops), and each op alone from one seeded rng."""
    import random

    aug = pkg("data.augment")
    img = np.random.default_rng(9).integers(0, 256, (32, 40, 3), dtype=np.uint8)
    ra = aug.RandomAugment(n=2, m=7, seed=3)
    calls = [ra(img) for _ in range(6)]
    ops = {name: np.asarray(aug._pil(fn(img, 7, random.Random(1))))
           for name, fn in aug.AUG_OPS.items()}
    return sorted(aug.AUG_OPS), aug.DEFAULT_AUGS, ra.augs, calls, ops


def case_checkpoint_loader(pkg, tmp_path):
    from tests.test_loader_variants import _make_tiny_llava_sd

    d = tmp_path / "ckpt"
    if not d.exists():
        _make_tiny_llava_sd(str(d))
    conv = pkg("models.convert")
    return conv.load_llava_checkpoint(str(d), vision_layers_to_run=1), \
        conv.load_image_newline(str(d))


def case_file_io_and_prefetch(pkg, tmp_path):
    fio = pkg("utils.file_io")
    path = str(tmp_path / f"{pkg.__name__}.jsonl")
    fio.write_jsonlines(path, [{"a": 1}, {"b": [2, 3]}])
    return fio.read_jsonlines(path), fio.read_json_or_jsonlines(path), \
        list(pkg("utils.prefetch").prefetch_iterator(iter(range(7)), depth=2))


def case_quantize_kernel_int8(pkg):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(48, 40)) * 0.02).astype(np.float32)
    w[:, 3] = 0  # the 1e-8 scale floor
    return pkg("models.llama").quantize_kernel_int8(w)


def case_int4_numpy_helpers(pkg):
    """INT4_GROUP, pick_int4_group, and the numpy pack_int4 / quantize_int4
    at group 128 and at one group of K, with an all-zero column (the 1e-8
    scale floor)."""
    i4 = pkg("ops.int4_matmul")
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(256, 40)) * 0.02).astype(np.float32)
    w[:, 5] = 0
    q = rng.integers(-7, 8, size=(96, 24)).astype(np.int8)
    return (i4.INT4_GROUP, [i4.pick_int4_group(k) for k in (128, 256, 11008, 64, 96)],
            i4.pack_int4(q, 32), i4.quantize_int4(w), i4.quantize_int4(w, group=256))


def case_fuse_llm_projections(pkg):
    """Two layers (float and int8, then int4 with 2-D group scales) and a
    float head, rewritten for fuse_proj."""
    rng = np.random.default_rng(3)

    def proj(kind, n_out):
        if kind == "float":
            return {"kernel": rng.normal(size=(8, n_out)).astype(np.float32)}
        if kind == "int8":
            return {"kernel": rng.integers(-9, 9, (8, n_out)).astype(np.int8),
                    "scale": rng.random(n_out).astype(np.float32)}
        return {"kernel": rng.integers(-9, 9, (4, n_out)).astype(np.int8),
                "scale": rng.random((1, n_out)).astype(np.float32)}

    def layer(kind):
        return {"attn": {n: proj(kind, w) for n, w in
                         (("q_proj", 8), ("k_proj", 4), ("v_proj", 4), ("o_proj", 8))},
                "mlp": {n: proj(kind, w) for n, w in
                        (("gate_proj", 12), ("up_proj", 12), ("down_proj", 8))}}

    tree = {"model": {"layer_0": layer("float"), "layer_1": layer("int8"),
                      "layer_2": layer("int4")},
            "lm_head": proj("float", 16)}
    return pkg("models.convert").fuse_llm_projections(tree)


def case_quantize_kv(pkg):
    """The int8 KV-cache quantiser and dequantiser (torch in the port,
    jax.numpy in the JAX package), with an all-zero row (the 1e-20 floor)."""
    mod = pkg("ops.decode_attention")
    x = (np.random.default_rng(4).normal(size=(2, 8, 3, 16)) * 3).astype(np.float32)
    x[1, 2, 0] = 0
    if pkg.__name__ == "rlaifv_tpu_torch":
        import torch

        q, s = mod.quantize_kv(torch.from_numpy(x))
        return q.numpy(), s.numpy(), mod.dequantize_kv(q, s, torch.float32).numpy()
    import jax.numpy as jnp

    q, s = mod.quantize_kv(jnp.asarray(x))
    return np.asarray(q), np.asarray(s), np.asarray(mod.dequantize_kv(q, s, jnp.float32))


def _lora_tree(rng):
    """A numpy param tree shaped like a tiny LLaVA's, int8 and float
    kernels, 1-D norm scales, a vision tower and a projector."""
    layer = {"attn": {"q_proj": {"kernel": rng.integers(-9, 9, (8, 8)).astype(np.int8),
                                 "scale": np.ones(8, np.float32)},
                      "o_proj": {"kernel": rng.normal(size=(8, 8)).astype(np.float32)}},
             "mlp": {"up_proj": {"kernel": rng.normal(size=(8, 12)).astype(np.float32)},
                     "down_proj": {"kernel": rng.normal(size=(12, 8)).astype(np.float32)}},
             "ln_attn": {"scale": np.ones(8, np.float32)}}
    return {"llm": {"model": {"layer_0": layer, "layer_1": layer},
                    "lm_head": {"kernel": rng.normal(size=(8, 16)).astype(np.float32)}},
            "vision_tower": {"layer_0": {"attn": {"q_proj": {
                "kernel": rng.normal(size=(8, 8)).astype(np.float32)}}}},
            "mm_projector": {"fc0": {"kernel": rng.normal(size=(8, 8)).astype(np.float32)}}}


def case_lora_helpers(pkg, tmp_path):
    """lora_target_paths (default and custom rules), lora_scaled,
    lora_merge on a float tree, and a save_lora npz read back by the same
    package's load_lora."""
    lora_mod = pkg("train.lora")
    rng = np.random.default_rng(1)
    params = _lora_tree(rng)
    paths = [lora_mod.lora_target_paths(params),
             lora_mod.lora_target_paths(params, target=r"(proj|fc\d)/kernel$",
                                        exclude=r"lm_head")]
    lora = {}
    for path in paths[0]:
        k = lora_mod._get(params, path)
        lora_mod._set(lora, path.rsplit("/kernel", 1)[0], {
            "a": rng.normal(size=(k.shape[0], 4)).astype(np.float32),
            "b": rng.normal(size=(4, k.shape[1])).astype(np.float32)})
    floats = {"llm": {"model": {"layer_0": {"mlp": params["llm"]["model"]["layer_0"]["mlp"]}}}}
    merged = lora_mod.lora_merge(floats, lora, alpha=16.0)
    path = str(tmp_path / f"{pkg.__name__}.npz")
    lora_mod.save_lora(path, lora, alpha=16.0, r=4)
    loaded, alpha, r = lora_mod.load_lora(path)
    flat = {k: np.asarray(v) for k, v in lora_mod._flatten(loaded)}
    return paths, lora_mod.lora_scaled(lora, alpha=16.0), merged, flat, alpha, r


def _fact_rows(rng):
    """Autocheck rows of 3 instructions x 3 answers, 1-4 facts each, with
    random yes/no scores (ties included): pairs/construction's input."""
    rows = []
    for qid in range(9):
        for f in range(int(rng.integers(1, 5))):
            yes = float(rng.choice([0.1, 0.5, 0.9]))
            rows.append({"question_id": qid, "ds_question_id": f"ds{qid // 3}",
                         "raw_question": f"fact {f} of {qid}?",
                         "scores": {"yes": yes, "Yes": yes / 4, "no": 1 - yes,
                                    "No": (1 - yes) / 4},
                         "metainfos": {"ds_question_id": f"ds{qid // 3}", "metainfos": {
                             "origin_question": f"Question {qid // 3}?"}}})
    return rows


def _answer_rows(rng, fact_rows):
    n_facts = {}
    for r in fact_rows:
        n_facts[r["question_id"]] = n_facts.get(r["question_id"], 0) + 1
    return [{"question_id": qid, "ds_question_id": f"ds{qid // 3}",
             "raw_question": f"Question {qid // 3}?", "question": f"Question {qid // 3}?",
             "answer": " ".join(["w"] * int(rng.integers(2, 30))),
             "facts": [f"f{i}" for i in range(n)], "changed_facts": [f"c{i}" for i in range(n)],
             "metainfos": {"image_path": f"/img/{qid // 3}.jpg"}}
            for qid, n in sorted(n_facts.items())]


def case_pairs_construction(pkg):
    con = pkg("pairs.construction")
    rows = _fact_rows(np.random.default_rng(5))
    return (con.fact_label(rows[0]["scores"]), con.answer_scores(rows),
            con.group_answers_by_instruction(rows), con.build_pairs(rows, diff=1),
            con.build_pairs(rows, diff=0, return_infos=True))


def case_pairs_preference(pkg, tmp_path):
    """assemble_pairs, sample_pairs with a seed, and `run`'s side files
    (.addcls / .addfactjudge; the unseeded sample file is left out)."""
    pref = pkg("pairs.preference")
    fio = pkg("utils.file_io")
    rng = np.random.default_rng(6)
    facts = _fact_rows(rng)
    answers = _answer_rows(rng, facts)
    d = tmp_path / pkg.__name__
    d.mkdir()
    fio.write_jsonlines(str(d / "autocheck.jsonl"), facts)
    fio.write_jsonlines(str(d / "gq.jsonl"), answers)
    pref.run(str(d / "autocheck.jsonl"), str(d / "gq.jsonl"), sample_num=2)
    pairs = pref.assemble_pairs(facts, answers)
    side = [fio.read_jsonlines(str(d / f"autocheck.pair_diff1{ext}.jsonl"))
            for ext in ("", ".addcls", ".addfactjudge")]
    return (pairs, pref.dedup_instructions(answers + answers[:2], facts),
            pref.sample_pairs(pairs[0], 1, seed=3), side)


def case_pairs_length_filter(pkg, tmp_path):
    lf = pkg("pairs.length_filter")
    fio = pkg("utils.file_io")
    rng = np.random.default_rng(7)
    pairs = [{"chosen": " ".join(["a"] * int(rng.integers(1, 40))),
              "rejected": " ".join(["b"] * int(rng.integers(1, 40)))} for _ in range(40)]
    pairs.append({"chosen": "same text", "rejected": "same text "})
    d = tmp_path / pkg.__name__
    d.mkdir()
    fio.write_jsonlines(str(d / "p.jsonl"), pairs)
    lf.run(str(d / "p.jsonl"), str(d / "out.jsonl"))
    return (lf.filter_by_relative_length(pairs, 0.3), lf.statistics(pairs),
            lf.search_balanced_cut(pairs, use_len=False),
            fio.read_jsonlines(str(d / "out.jsonl")),
            fio.read_jsonlines(str(d / "out_search_diff.jsonl")))


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


def _package(root):
    import importlib

    def get(name):
        return importlib.import_module(f"{root}.{name}")

    get.__name__ = root
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_copy_matches_the_original(case, tmp_path):
    fn = CASES[case]
    kw = {"tmp_path": tmp_path} if "tmp_path" in fn.__code__.co_varnames else {}
    got = fn(_package("rlaifv_tpu_torch"), **kw)
    want = fn(_package("rlaifv_tpu"), **kw)
    _deep_equal(got, want)



def test_preference_run_keeps_an_answer_without_questions(tmp_path):
    """A deliberate difference: an answer with no autocheck row (none of its
    facts got a yes/no question) makes the JAX package's `run` raise
    KeyError, as the reference does; the port's writes it to .addfactjudge
    with an empty fact_judge, and every other file as the JAX package writes
    them without that answer."""
    rng = np.random.default_rng(6)
    facts = _fact_rows(rng)
    answers = _answer_rows(rng, facts)
    lone = dict(answers[-1], question_id=99, ds_question_id="ds9", raw_question="Q9?",
                question="Q9?")
    out = {}
    for name, rows in (("rlaifv_tpu_torch", answers + [lone]), ("rlaifv_tpu", answers)):
        pkg = _package(name)
        fio = pkg("utils.file_io")
        d = tmp_path / name
        d.mkdir()
        fio.write_jsonlines(str(d / "autocheck.jsonl"), facts)
        fio.write_jsonlines(str(d / "gq.jsonl"), rows)
        pkg("pairs.preference").run(str(d / "autocheck.jsonl"), str(d / "gq.jsonl"))
        out[name] = [fio.read_jsonlines(str(d / f"autocheck.pair_diff1{ext}.jsonl"))
                     for ext in ("", ".addcls", ".addfactjudge")]
    pairs, addcls, judged = out["rlaifv_tpu_torch"]
    assert judged[-1]["question_id"] == 99 and judged[-1]["fact_judge"] == {}
    _deep_equal((pairs, addcls, judged[:-1]), tuple(out["rlaifv_tpu"]))
    d = tmp_path / "raises"
    d.mkdir()
    jfio = _package("rlaifv_tpu")("utils.file_io")
    jfio.write_jsonlines(str(d / "autocheck.jsonl"), facts)
    jfio.write_jsonlines(str(d / "gq.jsonl"), answers + [lone])
    with pytest.raises(KeyError):
        _package("rlaifv_tpu")("pairs.preference").run(str(d / "autocheck.jsonl"),
                                                      str(d / "gq.jsonl"))

def test_the_data_layer_the_scripts_import_is_the_ports_own():
    from rlaifv_tpu_torch import data

    for cls in (data.DPOCollator, data.ClipImageProcessor):
        assert cls.__module__.startswith("rlaifv_tpu_torch.data."), cls.__module__
