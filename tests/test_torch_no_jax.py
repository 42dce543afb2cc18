"""rlaifv_tpu_torch imports no JAX (nor triton) and builds nothing at import.

A subprocess blocks `jax`, `jaxlib`, `flax` and `triton` with a
sys.meta_path finder, imports every module of the package, runs the tiny
serving slice on the CPU (random weights from a seeded generator), and
checks that no CUDA kernel library was built or loaded.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "triton")

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

    assert _build._lib is None, "a kernel library was loaded on the CPU path"
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("OK", len(mods))
""")


def test_port_imports_no_jax_and_builds_nothing():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 15  # every module was imported
