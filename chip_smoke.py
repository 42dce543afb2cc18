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
  3b. the flash forward and backward kernels (dq, dk/dv) against the plain
     versions on the same bf16 inputs and dO at the train step's shapes:
     five fixed ones and the three calls phase 6's collated pair makes
     (plain, paired prefix, paired suffix at q_offset = Pa), with its
     masks; max abs errors against stated tolerances, median times,
     TFLOP/s;
  4. the slice: LLaVA-1.5-7B at full width and depth in bf16 with random
     weights (seeded), a synthetic character-level tokenizer and
     examples/test.jpeg: autocheck of 8 facts (shared-prefix prefill ->
     flash kernel), diverse_gen of 10 samples (generate_repeated -> decode
     kernel) and greedy_gen of 4 items (generate -> decode kernel), with the
     kernels' launch counters reset just before and read just after;
  5. the slice against its plain path: shared-prefix logits with every
     attention forced dense, same weights;
  6. the train slice: LLaVA-1.5-7B bf16 full fine-tune with remat, the
     shared-prefix paired forward and the "xla" head, one synthetic pair at
     the real geometry (examples/test.jpeg) collated as train.py collates
     it; reference logps from the same forward, then (after phase 7) 4
     AdamW steps on that pair: loss ln 2 at step 0, below it by step 3;
     step time, pairs/s, tokens/s with and without padding, peak memory and
     the flash launch counts of every step (counters reset just before);
  7. the train slice against its plain paths on the same weights and pair
     (those of the reference, before any update): paired + flash vs plain
     concatenated + flash vs plain + dense attention, loss, logps and the
     gradients of four named tensors.

Any failure raises (non-zero exit). The last two lines are a JSON object of
per-kernel results and `{"ok": true, "device": {...}}`. Without a CUDA
device it exits non-zero before measuring anything.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from rlaifv_tpu_torch.core.config import Config  # noqa: E402
from rlaifv_tpu_torch.data import (  # noqa: E402
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    ClipImageProcessor,
    DPOCollator,
)
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
from rlaifv_tpu_torch.train.train_step import (  # noqa: E402
    DPOHparams,
    LlavaDPOAdapter,
    batch_to_device,
    derive_shared_prefix_len,
    dpo_forward_logps,
    dpo_loss_from_batch,
    make_dpo_train_step,
    make_optimizer,
    paired_masks,
    validate_shared_prefix,
)
from rlaifv_tpu_torch.train.trainer import resolve_head  # noqa: E402
from rlaifv_tpu_torch.ops.flash_attention import (  # noqa: E402
    _kernel_bwd_dkv,
    _kernel_bwd_dq,
    bwd_delta,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
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
# backward, per gradient: max|kernel - plain| <= BWD_TOL x max|plain|. The
# kernels round P and dS to bf16 for their products (2^-9 relative each)
# and write bf16 outputs (one more rounding), while the plain backward
# stays fp32 to its final cast; over up to 2048 summed terms that leaves
# about one bf16 ulp of the largest entry (0.4-0.8% of max|plain|)
BWD_TOL = 2e-2
# train slice: policy == reference at step 0 makes the DPO margin exactly 0
# (the kernels are deterministic), so the loss is ln 2 to fp32 rounding
LN2_TOL = 1e-4
TRAIN_LR = 1e-4  # constant: a bf16 weight near 0.02 moves by ~1 ulp a step
# train slice vs its plain paths (bf16 activations through 32 layers in
# other summation orders): sequence logps (~-11 nats a token, ~2900 a
# sequence) within LOGP_RTOL of each other, losses within LOSS_TOL (the
# margin within 1 nat), and for each named gradient ||g - g_ref|| <=
# GRAD_REL_TOL ||g_ref|| and cosine >= GRAD_COS_MIN. The margin's gradient
# is the difference of the win and rej sequences' gradients, each a few
# times larger, so a few percent of bf16 noise in each shows as 5-10% in
# the difference (measured against dense attention, where the forward
# rounds other values than the kernels do: rel <= 0.098, cosine >= 0.9957
# on the 7B pair). Backward faults planted around the sound kernels and run
# through this comparison (dS scaled wrong, dk or dv zeroed, delta left
# out, q_offset ignored, the causal diagonal off by one, a dropped 64-row
# tile) each read, on the path they break, rel >= 0.35 and cosine <= 0.945
# on at least one tensor (PERF.md, PR 2); the bounds sit between the two
LOGP_RTOL = 5e-3
LOSS_TOL = 0.1
GRAD_REL_TOL = 0.2
GRAD_COS_MIN = 0.99


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


def _visible_pairs(Lq: int, Lk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs the attention reads: causal rows see keys up to
    their absolute position."""
    if not causal:
        return Lq * Lk
    return int(torch.clamp(q_offset + torch.arange(Lq) + 1, max=Lk).sum())


def _bwd_cases(pair: dict) -> list:
    """3b's cases: five fixed train shapes, then the three attention calls
    the train step makes on its collated pair (phase 6's batch), with that
    batch's own masks: the plain path (2, L, L), the paired prefix
    (1, Pa, Pa) and the paired suffix (2, W, Pa + W) at q_offset = Pa."""
    def ones(B, Lk):
        return torch.ones((B, Lk), dtype=torch.int32, device="cuda")

    tail = ones(2, 2048)
    tail[-1, -300:] = 0  # padded key tail of the last row
    pre = ones(1, 640)
    pre[:, -5:] = 0  # alignment pad rows of Pa = 640
    suf = tail.clone()
    suf[:, 635:640] = 0  # the prefix's pad rows, tiled
    mask = torch.from_numpy(pair["batch_np"]["attention_mask"]).cuda()
    P, L = pair["P"], mask.shape[1]
    pmask, smask = paired_masks(mask, P, L - P)
    Pa = pmask.shape[1]
    return [
        dict(name="plain dpo", Lq=2048, KVH=32, off=0, mask=tail),
        dict(name="gqa", Lq=2048, KVH=8, off=0, mask=tail),
        dict(name="paired prefix", Lq=640, KVH=32, off=0, mask=pre),
        dict(name="paired suffix", Lq=1408, KVH=32, off=640, mask=suf),
        dict(name="ragged", Lq=901, KVH=32, off=0, mask=ones(1, 901)),
        dict(name="train plain", Lq=L, KVH=32, off=0, mask=mask),
        dict(name="train prefix", Lq=Pa, KVH=32, off=0, mask=pmask),
        dict(name="train suffix", Lq=L - P, KVH=32, off=Pa, mask=smask),
    ]


def phase_backward(g, pair: dict) -> dict:
    """3b: the forward kernel and the two backward kernels against their
    plain versions at the train step's shapes (causal, H = 32, D = 128)."""
    H, D = 32, 128
    res = {"fwd_err": 0.0, "dq_err": 0.0, "dkv_err": 0.0}
    for c in _bwd_cases(pair):
        mask, Lq, KVH, off = c["mask"], c["Lq"], c["KVH"], c["off"]
        B, Lk = mask.shape
        q, k, v = _randn(g, B, Lq, H, D), _randn(g, B, Lk, KVH, D), _randn(g, B, Lk, KVH, D)
        out, lse = flash_attention(q, k, v, attention_mask=mask, q_offset=off,
                                   return_lse=True)
        ref_out, ref_lse = flash_attention_ref(q, k, v, mask, True, off)
        do = _randn(g, B, Lq, H, D)
        args = (q, k, v, mask, out, lse, do, True, off)
        got = flash_attention_bwd(*args)
        ref = flash_attention_bwd_ref(*args)
        torch.cuda.synchronize()
        e_out = (out.float() - ref_out.float()).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        ok = _within(out, ref_out) and e_lse <= LSE_TOL and \
            bool(torch.isfinite(out.float()).all())
        errs = []
        for a, r in zip(got, ref):
            errs.append((a.float() - r.float()).abs().max().item())
            ok = ok and errs[-1] <= BWD_TOL * r.float().abs().max().item() and \
                bool(torch.isfinite(a.float()).all())
        kargs = (q, k, v, mask, do, lse, bwd_delta(out, do), True, off)
        t_dq = time_ms(lambda: _kernel_bwd_dq(*kargs))
        t_dkv = time_ms(lambda: _kernel_bwd_dkv(*kargs))
        t_pair = time_ms(lambda: flash_attention_bwd(*args))
        t_plain = time_ms(lambda: flash_attention_bwd_ref(*args), runs=10)
        flop = 2.5 * 4 * B * H * D * _visible_pairs(Lq, Lk, True, off)
        log(f"[3b flash bwd] {c['name']}: B={B} Lq={Lq} Lk={Lk} H={H} KVH={KVH} "
            f"D={D} q_offset={off} | fwd max|out err| {e_out:.3e} (tol {OUT_TOL} + "
            f"{OUT_RTOL} x |plain|) max|lse err| {e_lse:.3e} (tol {LSE_TOL}) | bwd "
            f"max|err| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (tol "
            f"{BWD_TOL} x max|plain|) | dq kernel {t_dq:.4f} ms, dk/dv kernel "
            f"{t_dkv:.4f} ms, pair with delta {t_pair:.4f} ms = "
            f"{flop / (t_pair * 1e-3) / 1e12:.1f} TFLOP/s | plain {t_plain:.4f} ms | "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernels disagree with the plain versions: "
                                 f"{c['name']}")
        res["fwd_err"] = max(res["fwd_err"], e_out)
        res["dq_err"] = max(res["dq_err"], errs[0])
        res["dkv_err"] = max(res["dkv_err"], errs[1], errs[2])
        if c["name"] == "train suffix":  # the train step's largest call
            res.update(dq_ms=t_dq, dkv_ms=t_dkv, plain_ms=t_plain)
    return res


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


def _train_pair(image: np.ndarray, vocab: int):
    """One (rej, win) pair at the real geometry: a 35-token system prompt,
    the image (576 slots once expanded), a 24-token question, answers of
    256 (win) and 192 (rej) tokens; random ids, seeded."""
    rng = np.random.default_rng(0)
    system = rng.integers(5, vocab, 35).tolist()
    question = rng.integers(5, vocab, 24).tolist()

    def side(n):
        ans = rng.integers(5, vocab, n).tolist()
        ids = [1, *system, IMAGE_TOKEN_INDEX, *question, *ans, 2]
        labels = [IGNORE_INDEX] * (len(ids) - n - 1) + ans + [2]
        return {"input_ids": np.asarray(ids), "labels": np.asarray(labels),
                "image": image}

    win = side(256)
    return side(192), win


def collate_train_pair(image: np.ndarray, cfg: LlavaConfig) -> dict:
    """6, data: configs/llava15_dpo.json's training settings (one pair a
    step, max_len 2048, shared_prefix_len -1) with the "xla" head; the pair
    collated as train.py collates it (DPOCollator's default bucket: the
    batch pads to the next multiple of 256 tokens) and its shared prefix
    derived from the batch."""
    t = Config.from_json(str(ROOT / "configs" / "llava15_dpo.json")).training
    t.lm_head_impl = "xla"
    collator = DPOCollator(pad_token_id=0, max_len=2048,
                           num_patches=cfg.num_image_tokens, beta=t.dpo_beta)
    batch_np = collator([_train_pair(image, cfg.llm.vocab_size)])
    assert t.shared_prefix_len == -1 and t.per_device_batch_pairs == 1
    P = derive_shared_prefix_len(batch_np, cfg.num_image_tokens)
    validate_shared_prefix(batch_np, P, cfg.num_image_tokens)
    return dict(batch_np=batch_np, P=P, training=t)


def build_train(pair: dict, cfg: LlavaConfig, device: str = "cuda") -> dict:
    """6, set-up: the model of `cfg` (LLaVA-1.5-7B here) with random weights
    and the pair's reference logps from the same forward."""
    t0 = time.perf_counter()
    model = LlavaForCausalLM(cfg, device="meta").to_empty(device=device)
    init_weights_(model, torch.Generator(device=device).manual_seed(0))
    t, P, batch_np = pair["training"], pair["P"], pair["batch_np"]
    L = batch_np["input_ids"].shape[1]
    hp = DPOHparams(beta=t.dpo_beta, dpo_use_average=t.dpo_use_average,
                    lm_head_impl=resolve_head(t, cfg.llm.hidden_size),
                    shared_prefix_len=P)
    batch = batch_to_device(batch_np, device)
    adapter = LlavaDPOAdapter(model)
    model.train()
    with torch.no_grad():
        ref_w, ref_r, _ = dpo_forward_logps(adapter, batch, hp)
    batch["ref_win_logp"], batch["ref_rej_logp"] = ref_w.float(), ref_r.float()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    # the paired path's rows: the prefix once, each suffix padded to W
    tokens = P + 2 * (L - P)
    real = P + int(batch_np["attention_mask"][:, P:].sum())
    log(f"[6 train] LLaVA-1.5 bf16 full fine-tune, remat on: {n_params / 1e9:.3f} B "
        f"params, built and reference logps in {time.perf_counter() - t0:.1f} s | "
        f"one pair padded to L={L} (bucket 256), derived P={P} (array "
        f"{-(-P // 128) * 128}), W={L - P}: {tokens} tokens a step, {real} of them "
        f"not padding | head {hp.lm_head_impl}, beta {hp.beta}, constant lr "
        f"{TRAIN_LR}, weight decay {t.weight_decay}, clip {t.max_grad_norm}")
    return dict(model=model, adapter=adapter, batch=batch, hp=hp, tokens=tokens,
                real_tokens=real, training=t)


def phase_train(tr: dict) -> dict:
    """6: four AdamW steps of the full fine-tune on the pair."""
    model, t = tr["model"], tr["training"]
    optimizer = make_optimizer(model, TRAIN_LR, total_steps=t.max_steps,
                               warmup_ratio=0.0, weight_decay=t.weight_decay,
                               max_grad_norm=t.max_grad_norm, schedule="constant")
    step = make_dpo_train_step(tr["adapter"], optimizer, tr["hp"])
    n_layers = model.cfg.llm.num_layers
    flash_attention.launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0
    losses, times = [], []
    for i in range(4):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        c0 = (flash_attention.launches, flash_attention_bwd.dq_launches,
              flash_attention_bwd.dkv_launches)
        ts = time.perf_counter()
        metrics = step(tr["batch"])
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        times.append(time.perf_counter() - ts)
        n = (flash_attention.launches - c0[0], flash_attention_bwd.dq_launches - c0[1],
             flash_attention_bwd.dkv_launches - c0[2])
        losses.append(loss)
        log(f"[6 train] step {i}: loss {loss:.6e} grad_norm {gnorm:.4e} | "
            f"{times[-1]:.3f} s | flash launches fwd {n[0]} bwd dq {n[1]} dk/dv {n[2]}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"non-finite loss or grad norm at step {i}")
        if min(n) < n_layers:
            raise AssertionError(f"a kernel of the train path did not run every layer: {n}")
        if i == 0 and (abs(loss - math.log(2)) > LN2_TOL or not gnorm > 0):
            raise AssertionError(f"step 0: loss {loss} != ln 2 (policy == reference) "
                                 f"or grad norm {gnorm} not above 0")
    launches = {"fwd": flash_attention.launches, "dq": flash_attention_bwd.dq_launches,
                "dkv": flash_attention_bwd.dkv_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = statistics.mean(times[1:])
    log(f"[6 train] steps 1-3 (after the warm-up step 0): {step_s:.3f} s a step = "
        f"{1 / step_s:.3f} pairs/s = {tr['tokens'] / step_s:.0f} tokens/s with padding, "
        f"{tr['real_tokens'] / step_s:.0f} without | peak device memory "
        f"{peak_gb:.2f} GiB | loss {losses[0]:.6f} -> {losses[-1]:.3e} "
        f"(ln 2 = {math.log(2):.6f} within {LN2_TOL} at step 0)")
    if not losses[-1] < math.log(2):
        raise AssertionError(f"the loss did not fall below ln 2: {losses}")
    return launches


def train_run(model, adapter, batch, hp, impl: str) -> tuple:
    """One loss and backward with every Llama attention set to `impl` ->
    (loss, (chosen, rejected) logps, the named gradients in fp32, forward
    kernel launches). Holds one full gradient set at a time."""
    params = dict(model.named_parameters())
    last = model.cfg.llm.num_layers - 1
    names = {
        "layer 0 q_proj": "llm.model.layers.0.attn.q_proj.weight",
        f"layer {last} q_proj": f"llm.model.layers.{last}.attn.q_proj.weight",
        # the first readers of the dk/dv kernel's output
        f"layer {last} k_proj": f"llm.model.layers.{last}.attn.k_proj.weight",
        f"layer {last} v_proj": f"llm.model.layers.{last}.attn.v_proj.weight",
        "lm_head": "llm.lm_head.weight",
        "clip patch_embed": "vision_tower.patch_embed.weight",
    }
    attn = [m for m in model.modules() if isinstance(m, LlamaAttention)]
    for m in attn:
        m.attn_impl = impl
    model.zero_grad(set_to_none=True)
    f0 = flash_attention.launches
    loss, metrics = dpo_loss_from_batch(adapter, batch, hp)
    loss.backward()
    grads = {k: params[n].grad.float().clone() for k, n in names.items()}
    model.zero_grad(set_to_none=True)
    for m in attn:
        m.attn_impl = "auto"
    logps = (float(metrics["logps_train/chosen"]), float(metrics["logps_train/rejected"]))
    return float(loss.detach()), logps, grads, flash_attention.launches - f0


def compare_runs(run: tuple, ref: tuple) -> tuple:
    """(|loss - ref loss|, max relative logp difference, {name: (relative
    gradient error ||g - g_ref|| / ||g_ref||, cosine)})."""
    d_logp = max(abs(a - b) / abs(b) for a, b in zip(run[1], ref[1]))
    grads = {}
    for key, g in run[2].items():
        r = ref[2][key]
        grads[key] = (((g - r).norm() / r.norm()).item(),
                      torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(),
                                                            dim=0).item())
    return abs(run[0] - ref[0]), d_logp, grads


def phase_train_vs_plain(model, adapter, batch, hp) -> None:
    """7: paired + flash, plain + flash and plain + dense on one pair, at
    the weights the reference logps came from (loss ln 2 on the paired
    path), each path's loss, logps and named gradients."""
    plain = dataclasses.replace(hp, shared_prefix_len=0)
    runs = {"paired+flash": train_run(model, adapter, batch, hp, "auto"),
            "plain+flash": train_run(model, adapter, batch, plain, "auto"),
            "plain+dense": train_run(model, adapter, batch, plain, "dense")}
    ok = runs["plain+dense"][3] == 0 and runs["paired+flash"][3] > 0
    for name, ref_name in (("paired+flash", "plain+dense"), ("plain+flash", "plain+dense"),
                           ("paired+flash", "plain+flash")):
        (loss, logps, _, n_flash), ref = runs[name], runs[ref_name]
        d_loss, d_logp, grads = compare_runs(runs[name], ref)
        parts = [f"[7 train vs plain] {name} vs {ref_name}: loss {loss:.5f} vs "
                 f"{ref[0]:.5f} (tol {LOSS_TOL}) | logps {logps[0]:.2f}/{logps[1]:.2f} "
                 f"vs {ref[1][0]:.2f}/{ref[1][1]:.2f}, max rel {d_logp:.2e} "
                 f"(tol {LOGP_RTOL}) | flash fwd launches {n_flash}"]
        ok = ok and d_loss <= LOSS_TOL and d_logp <= LOGP_RTOL
        for key, (rel, cos) in grads.items():
            parts.append(f"{key}: rel {rel:.3e} cos {cos:.6f}")
            ok = ok and rel <= GRAD_REL_TOL and cos >= GRAD_COS_MIN
        log(" | ".join(parts) + f" (tol rel {GRAD_REL_TOL}, cos {GRAD_COS_MIN}) | "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the train slice disagrees with its plain paths")


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(1)
    smi = phase_environment()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    kern = phase_kernels(g)
    cfg = LlavaConfig.llava15_7b()
    image_bytes = (ROOT / "examples" / "test.jpeg").read_bytes()
    image = ClipImageProcessor(image_size=cfg.vision.image_size)(image_bytes)
    pair = collate_train_pair(image, cfg)
    bwd = phase_backward(g, pair)

    t0 = time.perf_counter()
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
    launches = phase_slice(gen, image_bytes)
    phase_slice_vs_plain(gen, image_bytes)
    del gen, model
    gc.collect()
    torch.cuda.empty_cache()

    # 7 runs on the weights before any update: the DPO loss of this random
    # model saturates after one step at any lr that moves bf16 weights
    tr = build_train(pair, LlavaConfig.llava15_7b(remat=True))
    phase_train_vs_plain(tr["model"], tr["adapter"], tr["batch"], tr["hp"])
    tl = phase_train(tr)

    log(f"[6 train] main-path launches: flash fwd {launches['flash']} (serving) + "
        f"{tl['fwd']} (train), bwd dq {tl['dq']}, dk/dv {tl['dkv']}")
    src = "rlaifv_tpu_torch/csrc/flash_attention_bwd.cu"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "rlaifv_tpu_torch/csrc/flash_attention.cu",
         "replaces": "rlaifv_tpu/ops/flash_attention.py:73",
         "launches": launches["flash"] + tl["fwd"],
         "max_abs_err": max(kern["flash"]["max_abs_err"], bwd["fwd_err"]),
         "ms": kern["flash"]["ms"], "plain_ms": kern["flash"]["plain_ms"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda", "source": src,
         "replaces": "rlaifv_tpu/ops/flash_attention.py:157",
         "launches": tl["dq"], "max_abs_err": bwd["dq_err"],
         "ms": bwd["dq_ms"], "plain_ms": bwd["plain_ms"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda", "source": src,
         "replaces": "rlaifv_tpu/ops/flash_attention.py:191",
         "launches": tl["dkv"], "max_abs_err": bwd["dkv_err"],
         "ms": bwd["dkv_ms"], "plain_ms": bwd["plain_ms"]},
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
