#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rlaifv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one progress line each (or a few):
  1. environment: Python/torch/CUDA/nvcc/triton versions, the card's name
     and power limit (nvidia-smi); TF32 off for matmuls and convolutions;
  2. build: nvcc builds the package's CUDA kernels from csrc/;
  3. each kernel against its plain PyTorch version on the same bf16 inputs
     at the serving slice's shapes: max abs error against a stated
     tolerance, and median times over 20 CUDA-event-timed runs;
  4. the slice: LLaVA-1.5-7B at full width and depth in bf16 with random
     weights (seeded), a synthetic character-level tokenizer and
     examples/test.jpeg: autocheck of 8 facts (shared-prefix prefill ->
     flash kernel), diverse_gen of 10 samples (generate_repeated -> decode
     kernel) and greedy_gen of 4 items (generate -> decode kernel), with the
     kernels' launch counters reset just before and read just after;
  5. the slice against its plain path: shared-prefix logits with every
     attention forced dense, same weights.

Any failure raises (non-zero exit). The last two lines are a JSON object of
per-kernel results and `{"ok": true, "device": {...}}`. Without a CUDA
device it exits non-zero before measuring anything.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator, yesno_token_ids  # noqa: E402
from rlaifv_tpu_torch.models.llama import LlamaAttention  # noqa: E402
from rlaifv_tpu_torch.models.llava import (  # noqa: E402
    LlavaConfig,
    LlavaForCausalLM,
    init_weights_,
)
from rlaifv_tpu_torch.ops import _build  # noqa: E402
from rlaifv_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_attention_prefix,
    decode_attention_prefix_ref,
)
from rlaifv_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
)

# bf16 outputs, checked as |kernel - plain| <= OUT_TOL + OUT_RTOL * |plain|:
# each side rounds once to bf16 (2^-8 relative) and the kernel also rounds
# the probabilities to bf16 for its P.V product, so outputs near 4 (a row
# that sees one key returns that value row) differ by one bf16 ulp, 2^-6;
# lse stays fp32 end to end
OUT_TOL = 1e-2
OUT_RTOL = 1e-2
LSE_TOL = 1e-3
# slice vs plain path: bf16 activations through 32 layers in two summation
# orders drift by a few bf16 ulps of the largest logit
SLICE_REL_TOL = 5e-2
# p(yes) is a softmax entry over 32000 tokens; logits within the bound
# above move it by far less than this
PROB_TOL = 1e-3
HBM_PEAK_GBPS = 3350.0  # H100 SXM data sheet


def _fake_tokenizer():
    """tests/fake_tokenizer.py, loaded by path: an installed package named
    `tests` would shadow the repository's namespace package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "rlaifv_fake_tokenizer", ROOT / "tests" / "fake_tokenizer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FakeTokenizer()


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 20) -> float:
    """Median CUDA-event time of fn() over `runs` launches, after warm-up.

    A spin kernel first holds the stream for ~25 ms so the host queues all
    runs ahead of the device: each event pair then brackets device work
    only, not the Python wrapper's time before the launch (which is longer
    than a small decode kernel)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def phase_environment() -> str:
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    cutlass = "/usr/local/cutlass/include"
    smi = nvidia_smi()
    log(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvcc: {nvcc.splitlines()[-1]} | "
        f"triton {triton_v} | cutlass {cutlass if os.path.isdir(cutlass) else 'absent'}")
    log(f"[1 env] nvidia-smi: {smi} | torch sees {torch.cuda.device_count()} x "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_kernels()
    log(f"[2 build] nvcc -> {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    entry = ""
    for line in _build.build_log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1][:48]
        elif "Used" in line or ("bytes spill" in line and
                                "0 bytes spill stores, 0 bytes spill loads" not in line):
            log(f"[2 build] ptxas {entry}: {line.split(':', 1)[-1].strip()}")


def _within(out: torch.Tensor, ref: torch.Tensor) -> bool:
    out, ref = out.float(), ref.float()
    return bool(((out - ref).abs() <= OUT_TOL + OUT_RTOL * ref.abs()).all())


def _randn(g, *shape):
    return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)


def phase_kernels(g) -> dict:
    results = {}
    # --- flash attention forward
    cases = [
        dict(name="autocheck prefix", B=1, L=740, H=32, KVH=32, D=128, causal=True, masked=20),
        dict(name="gqa", B=2, L=1024, H=32, KVH=8, D=128, causal=True, masked=0),
        dict(name="bidirectional", B=1, L=577, H=16, KVH=16, D=64, causal=False, masked=0),
    ]
    err_max = 0.0
    for c in cases:
        B, L, H, KVH, D = c["B"], c["L"], c["H"], c["KVH"], c["D"]
        q, k, v = _randn(g, B, L, H, D), _randn(g, B, L, KVH, D), _randn(g, B, L, KVH, D)
        mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
        mask[:, :c["masked"]] = 0
        if c["name"] == "gqa":
            mask[1, -100:] = 0  # padded key tail
        kw = dict(attention_mask=mask, causal=c["causal"])
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = flash_attention_ref(q, k, v, mask, c["causal"])
        torch.cuda.synchronize()
        e_out = (out.float() - ref.float()).abs().max().item()
        ok_out = _within(out, ref)
        e_lse = (lse - ref_lse).abs().max().item()
        if c["masked"]:
            assert (out[:, :c["masked"]] == 0).all(), "fully masked rows must be 0"
        ok = ok_out and e_lse <= LSE_TOL and bool(torch.isfinite(out.float()).all())
        t_k = time_ms(lambda: flash_attention(q, k, v, **kw))
        t_p = time_ms(lambda: flash_attention_ref(q, k, v, mask, c["causal"]))
        log(f"[3 flash] {c['name']}: B={B} L={L} H={H} KVH={KVH} D={D} "
            f"causal={c['causal']} | max|out err| {e_out:.3e} (tol {OUT_TOL} + "
            f"{OUT_RTOL} x |plain|) "
            f"max|lse err| {e_lse:.3e} (tol {LSE_TOL}) | kernel {t_k:.4f} ms "
            f"plain {t_p:.4f} ms | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version: {c}")
        err_max = max(err_max, e_out)
        if c["name"] == "autocheck prefix":
            results["flash"] = dict(ms=t_k, plain_ms=t_p)
    results["flash"]["max_abs_err"] = err_max

    # --- prefix decode attention
    B, L, H, KVH, D = 10, 896, 32, 32, 128
    q, k0, v0 = _randn(g, B, H, D), _randn(g, B, L, KVH, D), _randn(g, B, L, KVH, D)
    err_max = 0.0
    for valid_len in (1, 640, 700, 896):
        mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
        for b in range(B):
            mask[b, 7 * b:valid_len] = 1  # left padding of 7b columns
        k, v = k0.clone(), v0.clone()
        k[:, valid_len:] = float("nan")  # never read: poison
        v[:, valid_len:] = float("nan")
        out = decode_attention_prefix(q, k, v, mask, valid_len)
        ref = decode_attention_prefix_ref(q, k, v, mask, valid_len)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        ok = _within(out, ref) and bool(torch.isfinite(out.float()).all())
        if valid_len == 1:
            ok = ok and bool((out[1:] == 0).all())  # rows 1.. are fully masked
        t_k = time_ms(lambda: decode_attention_prefix(q, k, v, mask, valid_len))
        t_p = time_ms(lambda: decode_attention_prefix_ref(q, k, v, mask, valid_len))
        nbytes = 2 * B * valid_len * KVH * D * 2 + 2 * q.numel() * 2 + B * valid_len * 4
        gbps = nbytes / (t_k * 1e-3) / 1e9
        log(f"[3 decode] B={B} L={L} H={H} KVH={KVH} D={D} valid_len={valid_len}: "
            f"max|err| {e:.3e} (tol {OUT_TOL} + {OUT_RTOL} x |plain|) | kernel {t_k:.4f} ms plain "
            f"{t_p:.4f} ms | {gbps:.0f} GB/s = {gbps / HBM_PEAK_GBPS:.1%} of "
            f"{HBM_PEAK_GBPS:.0f} GB/s | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode kernel disagrees at valid_len={valid_len}")
        err_max = max(err_max, e)
        if valid_len == 896:
            results["decode"] = dict(ms=t_k, plain_ms=t_p, gbps=gbps)
    results["decode"]["max_abs_err"] = err_max
    return results


def _items(image_bytes: bytes, questions):
    return [{"question": q, "question_id": i, "image_bytes": image_bytes,
             "metainfos": {"ds_question_id": f"smoke{i}"}}
            for i, q in enumerate(questions)]


FACTS = [f"Is there a {w} in the image? Please answer yes or no." for w in
         ("dog", "cat", "car", "tree", "person", "bicycle", "cup", "clock")]


def phase_slice(gen: Llava15Generator, image_bytes: bytes) -> dict:
    facts = _items(image_bytes, FACTS)
    diverse = _items(image_bytes, ["Describe the image in detail."] * 10)
    greedy = _items(image_bytes, ["What is in the image?", "Describe the scene.",
                                  "What colors do you see?", "Is it daytime?"])
    # warm-up (cuBLAS handles, allocator) outside the counted run
    gen.autocheck(facts[:2], batch_size=8)
    gen.diverse_gen(diverse[:2], max_new_tokens=2)
    torch.cuda.synchronize()

    flash_attention.launches = 0
    decode_attention_prefix.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scored = gen.autocheck(facts, batch_size=8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps0 = decode_attention_prefix.launches
    sampled = gen.diverse_gen(diverse, temperature=0.7, max_new_tokens=64, seed=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    steps1 = decode_attention_prefix.launches
    greedy_rows = gen.greedy_gen(greedy, max_new_tokens=32)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {"flash": flash_attention.launches,
                "decode": decode_attention_prefix.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    assert len(scored) == 8 and all(
        0.0 <= p <= 1.0 for r in scored for p in r["scores"].values())
    assert len(sampled) == 10 and len(greedy_rows) == 4
    assert all(isinstance(r["answer"], str) for r in sampled + greedy_rows)
    n_layers = gen.model.cfg.llm.num_layers
    log(f"[4 slice] launches during the slice: flash {launches['flash']}, "
        f"decode {launches['decode']}")
    if launches["flash"] < n_layers or launches["decode"] < n_layers:
        raise AssertionError(f"a kernel of the path did not run: {launches}")
    # tokens sampled = rows x (decode steps + the first token, which comes
    # from the prefill logits); one decode step launches one kernel a layer
    n_div = 10 * ((steps1 - steps0) // n_layers + 1)
    n_greedy = 4 * ((launches["decode"] - steps1) // n_layers + 1)
    log(f"[4 slice] autocheck 8 facts in {t1 - t0:.3f} s = {8 / (t1 - t0):.2f} facts/s "
        f"(p(yes) row 0 = {scored[0]['scores']['yes']:.3e})")
    log(f"[4 slice] diverse_gen 10 rows, {n_div} tokens in {t2 - t1:.3f} s = "
        f"{n_div / (t2 - t1):.1f} tok/s (prefill and vision encode included)")
    log(f"[4 slice] greedy_gen 4 rows, {n_greedy} tokens in {t3 - t2:.3f} s = "
        f"{n_greedy / (t3 - t2):.1f} tok/s (prefill and vision encode included)")
    log(f"[4 slice] peak device memory {peak_gb:.2f} GiB")
    return launches


def phase_slice_vs_plain(gen: Llava15Generator, image_bytes: bytes) -> None:
    facts = _items(image_bytes, FACTS)
    prompts, starts, images = gen._prepare(facts)
    P = int(starts[0]) + gen.num_patches
    attn = [m for m in gen.model.modules() if isinstance(m, LlamaAttention)]

    def score(impl):
        for m in attn:
            m.attn_impl = impl
        return torch.from_numpy(gen.engine.score_shared_prefix(
            prompts[0][:P], [p[P:] for p in prompts], image=images[0],
            image_start=int(starts[0]), batch_size=8))

    fast, plain = score("auto"), score("dense")
    for m in attn:
        m.attn_impl = "auto"
    assert fast.shape == plain.shape == (8, gen.engine.vocab_size)
    assert torch.isfinite(fast).all() and torch.isfinite(plain).all()
    d_logit = (fast - plain).abs().max().item()
    scale = plain.abs().max().item()
    yes = yesno_token_ids(gen.tokenizer)["yes"]
    d_prob = (fast.double().softmax(-1)[:, yes]
              - plain.double().softmax(-1)[:, yes]).abs().max().item()
    ok = d_logit <= SLICE_REL_TOL * scale and d_prob <= PROB_TOL
    log(f"[5 slice vs plain] shared-prefix logits, flash vs dense attention: "
        f"max|dlogit| {d_logit:.4f} vs max|logit| {scale:.3f} (tol "
        f"{SLICE_REL_TOL} x max) | max|dp(yes)| {d_prob:.3e} (tol {PROB_TOL}) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("slice disagrees with its plain path")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(1)
    smi = phase_environment()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    kern = phase_kernels(g)

    t0 = time.perf_counter()
    cfg = LlavaConfig.llava15_7b()
    model = LlavaForCausalLM(cfg, device="meta").to_empty(device="cuda")
    init_weights_(model, torch.Generator(device="cuda").manual_seed(0)).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[4 slice] LLaVA-1.5-7B bf16 on cuda: {n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    log("[4 slice] weights are random (seed 0) and the tokenizer is the "
        "synthetic character-level tests/fake_tokenizer.py: the text is "
        "meaningless, the shapes and paths are the real ones")
    gen = Llava15Generator(model, _fake_tokenizer(), cfg.num_image_tokens,
                           image_size=cfg.vision.image_size,
                           checkpoint_name="random-llava15-7b")
    image_bytes = (ROOT / "examples" / "test.jpeg").read_bytes()
    launches = phase_slice(gen, image_bytes)
    phase_slice_vs_plain(gen, image_bytes)

    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "rlaifv_tpu_torch/csrc/flash_attention.cu",
         "replaces": "rlaifv_tpu/ops/flash_attention.py:73",
         "launches": launches["flash"],
         "max_abs_err": kern["flash"]["max_abs_err"],
         "ms": kern["flash"]["ms"], "plain_ms": kern["flash"]["plain_ms"]},
        {"name": "decode_attention_prefix", "route": "cuda",
         "source": "rlaifv_tpu_torch/csrc/decode_attention.cu",
         "replaces": "rlaifv_tpu/ops/decode_attention.py:59",
         "launches": launches["decode"],
         "max_abs_err": kern["decode"]["max_abs_err"],
         "ms": kern["decode"]["ms"], "plain_ms": kern["decode"]["plain_ms"]},
    ]
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
