"""rlaifv_tpu_torch imports no JAX, nothing of the JAX package and no
triton, and builds nothing at import.

A subprocess blocks `jax`, `jaxlib`, `flax`, `optax`, `orbax`, `triton` and
the JAX package `rlaifv_tpu` with a sys.meta_path finder, imports every
module of the port, runs the int4 product's plain twin and the tiny
serving slice on the CPU (random weights from a seeded generator), bf16
cache (greedy, continuous diverse_gen, and 3 beams through evals.vqa),
a tiny OmniLMM through autocheck and diverse_gen (float, then both towers
int8 in place with an int8 cache), a tiny MiniCPM-V through autocheck and
continuous diverse_gen on sliced images, the 7B chat on a tiny LLaVA
smoothed and quantised to int4 (models/quant_smooth.py) and one greedy
prompt-lookup generation (genai/lookup_decode.py), the mesh's parameter
specs (parallel/sharding.py), then in place int8 weights
+ fused projections + int8 cache (beams too), then
through the fused engine (kernel #16's twin), a tiny bare Llama through the
divide-and-conquer backend (bf16 and fused), runs `python -m rlaifv_tpu_torch.train --demo
--device cpu` for 2 steps into a temporary directory and `python -m
rlaifv_tpu_torch.export` on its checkpoint, imports
chip_smoke.py, and checks that no CUDA kernel library was built or loaded.
An AST scan finds no import statement rooted at those names in any file of
the port, of tools/ or in chip_smoke.py.
"""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "triton", "rlaifv_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Block())

    import numpy as np
    import torch
    import rlaifv_tpu_torch

    mods = [m.name for m in pkgutil.walk_packages(rlaifv_tpu_torch.__path__,
                                                  "rlaifv_tpu_torch.")]
    for name in mods:
        importlib.import_module(name)
    assert "rlaifv_tpu_torch.ops.int4_matmul" in mods
    for name in ("genai.beam", "evals.vqa", "evals.run_eval", "evals.object_halbench",
                 "evals.mmhal", "evals.refomb", "evals.report", "evals.summaries",
                 "evals.text_utils", "evals.gpt_client", "iteration", "genai.continuous",
                 "chat", "models.eva02", "models.resampler", "models.omnilmm",
                 "genai.omni_gen", "models.siglip", "models.minicpmv", "genai.minicpmv_gen",
                 "data.minicpmv_slicing", "models.quant_smooth", "genai.lookup_decode",
                 "models.anyres", "core.registry", "core.distributed", "data.tsv_data",
                 "data.native_loader", "ops.image_kernels", "models.export", "export",
                 "utils.profiling", "parallel", "parallel.sharding"):
        assert "rlaifv_tpu_torch." + name in mods, name

    # the int4 product on CPU tensors: the plain twins, nothing built
    from rlaifv_tpu_torch.models.convert import quantize_int4_torch
    from rlaifv_tpu_torch.ops import int4_matmul as i4
    qp, gs = quantize_int4_torch(torch.randn(256, 128, generator=torch.Generator().manual_seed(0)))
    x = torch.randn(3, 256, generator=torch.Generator().manual_seed(1))
    assert torch.equal(i4.int4_matmul_grad(x, qp, gs), i4.int4_matmul(x, qp, gs))

    from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
    from rlaifv_tpu_torch.models.llava import (LlavaConfig, LlavaForCausalLM,
                                               init_weights_)
    from rlaifv_tpu_torch.ops import _build
    sys.path.insert(0, "tests")
    from fake_tokenizer import FakeTokenizer

    cfg = LlavaConfig.tiny()
    model = init_weights_(LlavaForCausalLM(cfg), torch.Generator().manual_seed(0))
    gen = Llava15Generator(model, FakeTokenizer(), cfg.num_image_tokens,
                           image_size=cfg.vision.image_size)
    S = cfg.vision.image_size
    img = np.random.default_rng(0).integers(0, 255, (S, S, 3), dtype=np.uint8)
    items = [{"question": f"Is object {i} present?", "question_id": i,
              "image": img} for i in range(3)]
    rows = gen.autocheck(items, batch_size=2)
    assert all(0.0 <= v <= 1.0 for r in rows for v in r["scores"].values())
    rows = gen.diverse_gen(items[:1] * 2, max_new_tokens=3)
    assert len(rows) == 2 and all(isinstance(r["answer"], str) for r in rows)
    rows = gen.greedy_gen(items[:2], max_new_tokens=3)
    assert len(rows) == 2
    # slot-refill continuous batching (genai/continuous.py)
    from rlaifv_tpu_torch.genai.continuous import ContinuousGenerator
    runs, run = [], ContinuousGenerator.run
    ContinuousGenerator.run = lambda self, *a, **kw: runs.append(self) or run(self, *a, **kw)
    rows = gen.diverse_gen(items[:1] * 3 + items[1:], max_new_tokens=3, batch_size=2,
                           continuous=True)
    ContinuousGenerator.run = run
    assert len(rows) == 5 and runs[0].stats["chunks"] >= 3
    # the eval slice: 3 beams through evals.vqa, judged by run_eval offline
    from rlaifv_tpu_torch.evals.vqa import generate_answers
    answers = generate_answers(gen, items, max_new_tokens=3, num_beams=3)
    assert [a["question_id"] for a in answers] == [0, 1, 2]

    # the same model in the int8-KV serving configuration, in place
    from rlaifv_tpu_torch.models.convert import (fuse_llm_projections_,
                                                 quantize_llm_int8, set_llm_config)
    quantize_llm_int8(model, include_lm_head=False)
    set_llm_config(fuse_llm_projections_(model), kv_cache_dtype="int8")
    assert "k_scale" in model.init_cache(1, 128)[0]
    rows = gen.autocheck(items, batch_size=2)
    assert all(0.0 <= v <= 1.0 for r in rows for v in r["scores"].values())
    assert len(gen.diverse_gen(items[:1] * 2, max_new_tokens=3)) == 2
    assert len(gen.greedy_gen(items[:2], max_new_tokens=3)) == 2
    assert len(gen.greedy_gen(items[:2], max_new_tokens=3, num_beams=3)) == 2
    # and through the fused engine (its weights stacked in place)
    fused = Llava15Generator(model, FakeTokenizer(), cfg.num_image_tokens,
                             image_size=cfg.vision.image_size, fused_decode=True)
    assert len(fused.greedy_gen(items[:2], max_new_tokens=3)) == 2
    assert len(fused.greedy_gen(items, max_new_tokens=3, batch_size=2, continuous=True)) == 3

    # the divide-and-conquer stage: a tiny Llama3-shaped bare LM through
    # llama3_backend, bf16 weights and fused decode (int8 implied)
    from rlaifv_tpu_torch.genai import divide_conquer as dc
    from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    for fused_decode in (False, True):
        lm = init_weights_(LlamaForCausalLM(LlamaConfig.tiny(vocab_size=512, rope_theta=5e5,
                                                             rms_norm_eps=1e-5)),
                           torch.Generator().manual_seed(0))
        dgen, tmpl = dc.llama3_backend(lm, FakeTokenizer(), max_new_tokens=3,
                                       fused_decode=fused_decode)
        out = dgen([tmpl(dc.divide_messages({"question": "Q?", "answer": "A cat."}))])
        assert len(out) == 1 and isinstance(out[0], str)

    # the OmniLMM-12B serving slice at tiny widths: autocheck and generate,
    # then both towers quantised to int8 in place with an int8 cache
    from rlaifv_tpu_torch.genai.omni_gen import OmniLMMGenerator
    from rlaifv_tpu_torch.models import omnilmm
    from rlaifv_tpu_torch.models.convert import quantize_vision_int8
    ocfg = omnilmm.OmniLMMConfig.tiny(vocab_size=512)
    omodel = omnilmm.init_omnilmm_weights_(omnilmm.OmniLMMForCausalLM(ocfg),
                                           torch.Generator().manual_seed(0))
    ogen = OmniLMMGenerator(omodel, FakeTokenizer(), image_size=ocfg.vision.image_size)
    oitems = [dict(it, image=img[:28, :28]) for it in items]
    for quantized in (False, True):
        if quantized:
            quantize_llm_int8(omodel, include_lm_head=False)
            set_llm_config(quantize_vision_int8(omodel), kv_cache_dtype="int8")
        rows = ogen.autocheck(oitems, batch_size=2)
        assert all(0.0 <= v <= 1.0 for r in rows for v in r["scores"].values())
        assert len(ogen.diverse_gen(oitems[:1] * 2, max_new_tokens=3)) == 2

    # the MiniCPM-V serving slice at tiny widths: sliced images, span
    # features through autocheck and continuous diverse_gen
    from rlaifv_tpu_torch.genai.minicpmv_gen import MiniCPMVGenerator
    from rlaifv_tpu_torch.models import minicpmv
    mcfg = minicpmv.MiniCPMVConfig.tiny(vocab_size=512)
    mmodel = minicpmv.init_minicpmv_weights_(minicpmv.MiniCPMVForCausalLM(mcfg),
                                             torch.Generator().manual_seed(0))
    mgen = MiniCPMVGenerator(mmodel, FakeTokenizer())
    mitems = [dict(it, image=np.zeros((60, 40, 3), np.uint8) + i) for i, it in enumerate(items)]
    rows = mgen.autocheck(mitems[:1] * 2 + mitems[1:], batch_size=2)
    assert all(0.0 <= v <= 1.0 for r in rows for v in r["scores"].values())
    assert len(mgen.diverse_gen(mitems, max_new_tokens=3, batch_size=2, continuous=True)) == 3

    # the 7B chat on a tiny LLaVA smoothed (the alpha search) and quantised
    # to int4 in place, its 3 beams, then one greedy lookup_generate
    from rlaifv_tpu_torch.chat import RLAIFV7B
    from rlaifv_tpu_torch.genai.lookup_decode import lookup_generate
    from rlaifv_tpu_torch.models.quant_smooth import quantize_llm_int4_smooth
    smodel = init_weights_(LlavaForCausalLM(cfg), torch.Generator().manual_seed(1)).eval()
    quantize_llm_int4_smooth(smodel, np.arange(1, 33)[None])
    assert smodel.cfg.llm.quantize_bits == 4
    schat = RLAIFV7B.from_model(smodel, FakeTokenizer(), max_new_tokens=3)
    assert isinstance(schat.chat({"image": img, "question": "What is it?"}), str)
    res = lookup_generate(schat.engine, [1, 5, 6, 7, 5, 6, 7], max_new_tokens=5)
    assert len(res.tokens) == 5 and res.n_steps >= 1

    # the mesh's rules need no process group
    from rlaifv_tpu_torch.parallel import sharding
    specs = sharding.param_specs(LlavaForCausalLM(cfg), (1, 2, 2))
    assert specs["llm.model.layers.0.mlp.gate_proj.weight"] == ("tp", "fsdp")

    # the training entry point, as `python -m rlaifv_tpu_torch.train`
    import json, os, runpy
    out = sys.argv[1]
    sys.argv = ["rlaifv_tpu_torch.train", "--demo", "--output-dir", out,
                "--max-steps", "2", "--device", "cpu"]
    runpy.run_module("rlaifv_tpu_torch.train", run_name="__main__")
    steps = [json.loads(line)["step"] for line in open(os.path.join(out, "metrics.jsonl"))]
    assert steps == [1, 2], steps
    assert os.listdir(os.path.join(out, "checkpoints")) == ["2"]
    # and its export, as `python -m rlaifv_tpu_torch.export`
    from rlaifv_tpu_torch.core.config import Config
    with open(os.path.join(out, "cfg.json"), "w") as f:
        json.dump(Config().to_dict(), f)
    sys.argv = ["rlaifv_tpu_torch.export", "--config", os.path.join(out, "cfg.json"),
                "--train-dir", out, "--out", os.path.join(out, "hf")]
    runpy.run_module("rlaifv_tpu_torch.export", run_name="__main__")
    assert sorted(os.listdir(os.path.join(out, "hf"))) == ["config.json", "pytorch_model.bin"]

    import chip_smoke  # noqa: F401  (its main() needs a card; the import does not)

    assert _build._lib is None, "a kernel library was loaded on the CPU path"
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("OK", len(mods))
""")


def test_port_imports_no_jax_and_builds_nothing(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path / "demo")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("OK")
    assert int(last.split()[1]) >= 15  # every module was imported


def _import_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "rlaifv_tpu"}


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port alone: no import statement in it names
    JAX or the JAX package."""
    roots = _import_roots(ROOT / "chip_smoke.py")
    assert not roots & FORBIDDEN, roots
    assert "rlaifv_tpu_torch" in roots


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "rlaifv_tpu_torch").rglob("*.py"),
                                       *(ROOT / "tools").glob("*.py")]))
def test_no_import_is_rooted_at_jax_or_the_jax_package(path):
    """Every import statement of the port and of its measurement scripts
    under tools/, at module level or inside a function."""
    roots = _import_roots(ROOT / path)
    assert not roots & FORBIDDEN, (path, roots & FORBIDDEN)
