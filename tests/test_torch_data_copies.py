"""The port's copies of the JAX package's numpy modules give the originals'
outputs on the same inputs.

rlaifv_tpu_torch keeps its own `constants`, `data/*`, `utils/file_io`,
`utils/prefetch`, `data/augment`, the llava15 `train/family` spec, the HF-checkpoint
loader and `fuse_llm_projections` of `models/convert`,
`quantize_kernel_int8`, the numpy int4 helpers of `ops/int4_matmul`, the
tree helpers of `train/lora` and the KV-cache quantiser of
`ops/decode_attention`, `pairs/{construction,preference,
length_filter}`, `data/minicpmv_slicing` and the numpy merge of
`models/anyres`, `core/registry`, `data/tsv_data`, the StepTimer of
`utils/profiling`, the numpy resampling weights of `ops/image_kernels`, the
numpy functions of `models/export` and the C++ source of the JPEG loader
(it imports nothing of rlaifv_tpu). Each case
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


def case_minicpmv_slicing(pkg):
    """Every function of data/minicpmv_slicing.py: the geometry on wide,
    tall, square and small images, PIL slicing and the placeholders."""
    from PIL import Image

    sl = pkg("data.minicpmv_slicing")
    sizes = [(1920, 1080), (500, 2000), (448, 448), (300, 200), (90, 60), (1000, 1000)]
    out = {"divide": [sl.ensure_divide(n, 14) for n in (5, 100, 447, 1000)],
           "resize": [sl.find_best_resize(s, 448, 14, allow_upscale=up)
                      for s in sizes for up in (False, True)],
           "refine": [sl.get_refine_size(s, (2, 3), 448, 14, allow_upscale=True) for s in sizes],
           "grid": [sl.best_grid(s, m, 9) for s in sizes for m in (1, 2, 4, 9, 10)],
           "plan": [sl.slice_image_plan(s, never_split=ns) for s in sizes for ns in (False, True)],
           "placeholder": [sl.get_image_placeholder(g, 3) for g in (None, (2, 1), (3, 2))],
           "grid_text": [sl.get_grid_placeholder(g, 2) for g in (None, (1, 3))]}
    rng = np.random.default_rng(8)
    img = Image.fromarray(rng.integers(0, 255, (300, 700, 3), dtype=np.uint8))
    source, patches, grid = sl.slice_image(img, 9, 112, 14)
    out["slices"] = [np.asarray(source), [np.asarray(p) for p in patches], grid]
    out["reshape"] = sl.reshape_by_patch(rng.normal(size=(3, 28, 42)).astype(np.float32), 14)
    return out


def case_anyres(pkg):
    """The numpy merge of models/anyres.py: every merge type, wide, tall
    and square sources, and unpad_grid on its own."""
    ar = pkg("models.anyres")
    rng = np.random.default_rng(9)
    newline = rng.normal(size=4).astype(np.float32)
    out = []
    for n, grid, merge_type, size in ((5, (2, 2), "spatial_unpad", (640, 420)),
                                      (3, (1, 2), "spatial_unpad", (300, 900)),
                                      (5, (2, 2), "spatial_unpad", (500, 500)),
                                      (7, (3, 2), "spatial", None), (3, (2, 1), "flat", None)):
        views = rng.normal(size=(n, 16, 4)).astype(np.float32)
        out.append(ar.merge_anyres_features(views, grid, merge_type=merge_type,
                                            original_size=size, image_newline=newline))
    grid = np.arange(48 * 48).reshape(48, 48, 1)
    out += [ar.unpad_grid(grid, (640, 420)), ar.unpad_grid(grid, (420, 640))]
    return out


def case_registry(pkg):
    """core/registry.py: registration, lookup, membership and both KeyErrors."""
    reg = pkg("core.registry")
    r = reg.Registry("test")
    r.register("a")(len)
    r.register()(sorted)
    out = {"keys": sorted(r.keys()), "a": r["a"] is len, "in": ("sorted" in r, "b" in r),
           "globals": (reg.data_sources.name, reg.models.name)}
    for fn in (lambda: r["missing"], lambda: r.register("a")(len)):
        with pytest.raises(KeyError) as err:
            fn()
        out.setdefault("errors", []).append(str(err.value))
    return out


def case_tsv_data(pkg, tmp_path):
    """data/tsv_data.py: TSVFile (its .lineidx), size-suffixed shards, the
    weighted interleave and the chunked shuffle."""
    tsv = pkg("data.tsv_data")
    d = tmp_path / pkg.__name__
    d.mkdir()
    paths = []
    for name, n in (("a", 7), ("b", 3), ("c", 5)):
        paths.append(str(d / f"{name}.tsv"))
        with open(paths[-1], "w") as f:
            f.writelines(f"{name}{i}\tx{i}\t\n" for i in range(n))
    t = tsv.TSVFile(paths[0])
    one = tsv.SingleDataSourceDataset("ab", paths[0], paths[1])
    multi = tsv.MultiDataSourceDataset([one, tsv.SingleDataSourceDataset("c", paths[2])],
                                       [3, 2])
    return {"len": len(t), "rows": [t[i] for i in (3, 0, 6)],
            "lineidx": open(str(d / "a.lineidx")).read(),
            "single": [len(one), one.borders, [one[i] for i in range(len(one))]],
            "multi": [len(multi), multi.pattern, [multi[i] for i in range(len(multi))]],
            "chunked": [tsv.chunked_random_indices(n, chunk_size=c, seed=s)
                        for n, c, s in ((25, 10, 0), (7, 100, 3), (0, 4, 1))]}


def case_step_timer(pkg):
    """utils/profiling.py's StepTimer on a scripted clock."""
    prof = pkg("utils.profiling")
    ticks = iter([1.0, 1.5, 2.5, 2.75, 4.0])

    class Clock:
        perf_counter = staticmethod(lambda: next(ticks))

    real, prof.time = prof.time, Clock
    try:
        t = prof.StepTimer(ema=0.8)
        out = [(t.tick(), t.avg_seconds, t.throughput(4)) for _ in range(5)]
    finally:
        prof.time = real
    return out


def case_image_resize_weights(pkg):
    """ops/image_kernels.py's numpy: PIL's bicubic kernel and the (dst, src)
    resampling matrices, up- and down-sampling."""
    ik = pkg("ops.image_kernels")
    x = np.linspace(-3, 3, 61)
    return {"bicubic": [ik._bicubic(x), ik._bicubic(x, a=-0.75)],
            "weights": [ik.pil_resize_weights(src, dst) for src, dst in
                        ((448, 336), (336, 336), (100, 336), (1344, 336), (640, 336),
                         (7, 5), (5, 7))]}


def _llava_tree(rng, L=2, D=16, I=24, V=40, VD=12, VI=20, VL=2, P=2, S=4):
    """A JAX-layout LLaVA param tree of random fp32 arrays (flax names,
    kernels (in, out), the patch conv HWIO)."""
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    llm = {"model": {"tok_embed": {"embedding": f(V, D)}, "ln_f": {"scale": f(D)}},
           "lm_head": {"kernel": f(D, V)}}
    for i in range(L):
        llm["model"][f"layer_{i}"] = {
            "attn": {n: {"kernel": f(D, D)} for n in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {"gate_proj": {"kernel": f(D, I)}, "up_proj": {"kernel": f(D, I)},
                    "down_proj": {"kernel": f(I, D)}},
            "ln_attn": {"scale": f(D)}, "ln_mlp": {"scale": f(D)}}
    vis = {"cls_token": f(VD), "patch_embed": {"kernel": f(P, P, 3, VD)},
           "pos_embed": f(S * S + 1, VD), "pre_ln": {"scale": f(VD), "bias": f(VD)}}
    for i in range(VL):
        vis[f"layer_{i}"] = {
            "attn": {n: {"kernel": f(VD, VD), "bias": f(VD)}
                     for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ln1": {"scale": f(VD), "bias": f(VD)}, "ln2": {"scale": f(VD), "bias": f(VD)},
            "fc1": {"kernel": f(VD, VI), "bias": f(VI)}, "fc2": {"kernel": f(VI, VD),
                                                             "bias": f(VD)}}
    proj = {"fc0": {"kernel": f(VD, D), "bias": f(D)}, "fc1": {"kernel": f(D, D), "bias": f(D)}}
    return {"llm": llm, "vision_tower": vis, "mm_projector": proj}


def _read_dir(path):
    import json

    import torch

    out = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.endswith(".json"):
            out[name] = json.load(open(full))
        else:
            out[name] = {k: v.numpy() for k, v in
                         torch.load(full, map_location="cpu", weights_only=True).items()}
    return out


def case_export(pkg, tmp_path):
    """models/export.py's numpy functions: the state dicts at fp32 and fp16,
    int8 dequantisation, unfuse after fuse (float and int8), the
    synthesized config, and the files export_llava_hf and export_peft_lora
    write (with a base dir: its extra tensors, config and tokenizer file)."""
    ex = pkg("models.export")
    conv = pkg("models.convert")
    cfg = pkg("models.llava").LlavaConfig.tiny()
    rng = np.random.default_rng(11)
    params = _llava_tree(rng)
    from types import SimpleNamespace

    from rlaifv_tpu_torch.models.convert import _quantize_llm_tree

    qllm = _quantize_llm_tree(params["llm"], "int8")  # the same input for both
    llm_cfg = SimpleNamespace(num_heads=2, num_kv_heads=2, head_size=8)
    out = {"sd32": ex.export_llava_sd(params, dtype=np.float32),
           "sd16": ex.export_llava_sd(params),
           "int8": ex.export_llama_sd(qllm, dtype=np.float32),
           "kernel8": ex._kernel(qllm["model"]["layer_0"]["mlp"]["up_proj"]),
           "unfuse": ex.unfuse_llm_projections(conv.fuse_llm_projections(params["llm"]),
                                               llm_cfg),
           "unfuse8": ex.unfuse_llm_projections(conv.fuse_llm_projections(qllm), llm_cfg),
           "config": ex._hf_config_from_llava(cfg)}
    d = tmp_path / pkg.__name__
    base = str(d / "base")
    ex.export_llava_hf(params, base, cfg=cfg, dtype=np.float32)
    with open(os.path.join(base, "tokenizer_config.json"), "w") as f:
        f.write("{}")
    sd = _read_dir(base)["pytorch_model.bin"]
    sd["model.image_newline"] = rng.normal(size=16).astype(np.float32)
    import torch

    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               os.path.join(base, "pytorch_model.bin"))
    out["hf"] = _read_dir(ex.export_llava_hf(params, str(d / "hf"), base_dir=base))
    lora = {"llm": {"model": {f"layer_{i}": {blk: {n: {"a": rng.normal(size=(16, 4)).astype(
        np.float32), "b": rng.normal(size=(4, 16)).astype(np.float32)} for n in names}
        for blk, names in (("attn", ("q_proj", "v_proj")), ("mlp", ("up_proj",)))}
        for i in range(2)}}}
    out["peft"] = _read_dir(ex.export_peft_lora(
        lora, str(d / "peft"), alpha=8.0, base_model_name="base",
        non_lora_params={"mm_projector": params["mm_projector"]}))
    return out


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


def test_jpeg_loader_source_is_a_byte_copy():
    """The port builds its JPEG loader from its own copy of the C++ source."""
    port = (ROOT / "rlaifv_tpu_torch" / "native" / "image_loader.cpp").read_bytes()
    assert port == (ROOT / "rlaifv_tpu" / "native" / "image_loader.cpp").read_bytes()
