#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rlaifv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one progress line each (or a few):
  1. environment: Python/torch/CUDA/nvcc/triton versions, the card's name
     and power limit (nvidia-smi); TF32 off for matmuls and convolutions;
  2. build: nvcc builds the package's CUDA kernels from csrc/;
  3. each kernel against its plain PyTorch version on the same bf16 inputs
     at the serving slice's shapes: max abs error against a stated
     tolerance, and median times over 20 CUDA-event-timed runs, beside the
     bound (bytes and operations at the card's peaks) and the time of
     torch's scaled_dot_product_attention on the same inputs;
  3b. the flash forward and backward kernels (dq, dk/dv) against the plain
     versions on the same bf16 inputs and dO at the train step's shapes:
     five fixed ones and the three calls phase 6's collated pair makes
     (plain, paired prefix, paired suffix at q_offset = Pa), with its
     masks; max abs errors against stated tolerances, median times,
     TFLOP/s, bounds, SDPA's autograd backward;
  3c. the fused LM head kernels (forward, dx, dW) against the plain versions
     at the train step's head (M = 2 (L - 1), H = 4096, V = 32000), the
     ref-logp fallback's (M = 16 x 1023 - 5), H = 1024 and ragged
     vocabularies; times beside the bound and the two-call library
     composite (F.linear + F.cross_entropy); then planted faults (g dropped,
     one-hot dropped, lse shifted, ragged tile unmasked), each of which
     must break the bounds;
  4. the slice: LLaVA-1.5-7B at full width and depth in bf16 with random
     weights (seeded), a synthetic character-level tokenizer and
     examples/test.jpeg: autocheck of 8 facts (shared-prefix prefill ->
     flash kernel), diverse_gen of 10 samples (generate_repeated -> decode
     kernel) and greedy_gen of 4 items (generate -> decode kernel), with the
     kernels' launch counters reset just before and read just after;
  5. the slice against its plain path: shared-prefix logits with every
     attention forced dense, same weights;
  8. the reference-logp precompute: 16 synthetic RLAIF-V rows at the train
     geometry through score_preference_rows on the frozen starting policy
     (LLaVA-1.5-7B with remat, seed 0): the shared-prefix path (a spy
     counts the rows it scored), the plain scorer with the fused head and
     with the "xla" head; their agreement, pairs/s and peak memory;
  7. the train slice against its plain paths on the first row's pair and
     phase 8's reference logps, before any update: paired + flash vs plain
     concatenated + flash vs plain + dense attention, and the fused head vs
     the "xla" head; loss, logps and the gradients of named tensors;
  6. the train slice: the 7B full fine-tune with remat, the shared-prefix
     paired forward and lm_head_impl "auto" (the fused head at hidden
     4096), that pair collated as train.py collates it: 4 AdamW steps,
     loss near ln 2 at step 0 (bound stated), lower by step 3; step time,
     pairs/s, tokens/s with and without padding, peak memory and every
     kernel's launches per step; then 3 steps with the "xla" head on the
     same optimizer, for its step time and peak memory beside them;
  3d. (run after 3c) the int8 weight kernels (#7 in-kernel quantisation,
     #8 its dx, #9 and #10 the prequantised pair) against their plain twins
     at the 7B widths
     (K x N = 4096 x 4096, 4096 x 11008, 11008 x 4096) and M = 16, 64, 127
     (in-kernel route), 128 and the M values of phase 9's batches: max abs
     difference 0, #7 == #9 and #8 == #10; times beside the bound (int8 at
     1,979 TOP/s or the bytes), torch._int_mm on the same int8 operands
     (product only) and the "dequant" route (a bf16 cuBLAS product of the
     dequantised weight), and one projection's int8 route against the
     dequant route (the activation-quantisation error, ~1%);
  9. the QLoRA slice (configs/llava15_dpo_qlora.json): phase 8's seed-0
     LLaVA-1.5-7B rebuilt after phase 6 is freed, its LLM projections
     quantised to int8 on the card (head, CLIP and projector bf16), the
     reference logps of phase 8's 16 rows and one short row scored on that
     base (shared-prefix path), step 0 of r=64 / alpha=16 adapters on all 7
     projections x 32 layers against the same step on the "dequant" route
     (and the SFT term's gradient on both routes),
     3 AdamW steps of 8 pairs collated as train.py collates them (loss near
     ln 2 at step 0, lower by step 2), then one step on the short pair whose
     suffix has fewer than INT8_DEQUANT_MIN_M rows (#7 and #8 on the train
     path); step time, pairs/s, tokens/s, peak memory and launches a step.

Each path of the main run (4, 8, 6, and 9's precompute, steps and short
step) starts with every launch counter at 0 and is read just after; the
`kernels` line reports those launches beside each kernel's error, times,
bound and library time.
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

from rlaifv_tpu_torch.constants import IGNORE_INDEX  # noqa: E402
from rlaifv_tpu_torch.core.config import Config  # noqa: E402
from rlaifv_tpu_torch.data import ClipImageProcessor, DPOCollator  # noqa: E402
from rlaifv_tpu_torch.genai.engine import DecodeEngine  # noqa: E402
from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator, yesno_token_ids  # noqa: E402
from rlaifv_tpu_torch.models.llama import LlamaAttention  # noqa: E402
from rlaifv_tpu_torch.models.llava import (  # noqa: E402
    LlavaConfig,
    LlavaForCausalLM,
    init_weights_,
)
from rlaifv_tpu_torch.models.convert import (  # noqa: E402
    quantize_kernel_int8_torch,
    quantize_llm_int8,
)
from rlaifv_tpu_torch.ops import _build  # noqa: E402
from rlaifv_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from rlaifv_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_attention_prefix,
    decode_attention_prefix_ref,
)
from rlaifv_tpu_torch.ops.fused_head import (  # noqa: E402
    _kernel_dw,
    _kernel_dx,
    _kernel_fwd,
    fused_head_bwd_plain,
    fused_head_fwd_plain,
    fused_target_logp,
)
from rlaifv_tpu_torch.train.train_step import (  # noqa: E402
    DPOHparams,
    LlavaDPOAdapter,
    batch_to_device,
    derive_shared_prefix_len,
    dpo_loss_from_batch,
    make_dpo_train_step,
    make_lora_dpo_train_step,
    make_optimizer,
    named_tensors,
    paired_masks,
    validate_shared_prefix,
)
from rlaifv_tpu_torch.train.lora import attach_lora, lora_init, lora_scaled  # noqa: E402
from rlaifv_tpu_torch.train.family import get_family  # noqa: E402
from rlaifv_tpu_torch.train.ref_logp import _encode_rows, score_preference_rows  # noqa: E402
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
PEAK_BF16_TFLOPS = 989.0  # dense bf16 tensor-core rate, H100 SXM data sheet
PEAK_INT8_TOPS = 1979.0  # dense int8 tensor-core rate, H100 SXM data sheet
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
# fused head forward (3c): logp and lse within HEAD_FWD_TOL nats of the
# plain version. Both sum the same exact bf16 x bf16 products in fp32 over
# H (the kernel on the tensor cores, in another order): ~1e-5 at scores of
# ~1 and lse ~11. A ragged vocabulary tile left unmasked adds its zero
# scores to the sum: 63 columns at V = 32001 move lse by ~63 e^-11 = 9e-4
HEAD_FWD_TOL = 2e-4
# fused head backward (3c), elementwise: |kernel - plain| <= HEAD_GRAD_RTOL
# |plain| + HEAD_GRAD_ATOL max|plain|. Both round dl to bf16, sum in fp32
# and round the sum to bf16 once, so an entry differs by an ulp or two
# (one ulp is 2^-8 to 2^-7 of it); the atol covers entries that cancel to
# ~0. Not against max|plain| alone: dW's vocabulary rows that no label hits
# (the softmax part, ~1e-3) are ~1e-3 of the label rows, and a fault there
# (lse off, p wrong) would hide under a bound on the largest entry
HEAD_GRAD_RTOL = 2 ** -6
HEAD_GRAD_ATOL = 1e-5
# 8, ref-logp paths on the same rows: sequence sums and means within
# LOGP_RTOL between the shared-prefix scorer and the plain one (the
# attention paths round bf16 activations in other places, as in 7), within
# HEAD_LOGP_RTOL between the fused and the "xla" head on one forward (the
# "xla" head rounds each logit to bf16 first: 2^-9 of |logit| ~ 1, random
# in sign, ~0.004 nats a token and ~1e-5 of a ~-2700-nat sum); per-token
# logps within TOKEN_MEAN_TOL nats on average (single tokens spread wider)
HEAD_LOGP_RTOL = 1e-3
TOKEN_MEAN_TOL = 0.05
# 6, step 0: the reference logps come from phase 8's shared-prefix scorer
# (bf16 logits, the prefix left-padded to 128 columns) and the policy's
# from the paired forward with the fused head (fp32 logits, the prefix
# right-padded), so the margin is not exactly 0. loss = ln(1 + e^-beta m)
# ~ ln 2 - beta m / 2: REF_LN2_TOL = 0.1 allows a margin of 2 nats, each of
# the four ~-2700-nat sequence logps within ~2.5e-4 of its reference, the
# order phase 7 reads between attention paths
REF_LN2_TOL = 0.1
# 9: the QLoRA step-0 logps, loss and adapter gradients against the same
# step on the "dequant" route (the int8 weights dequantised to bf16, no
# activation quantisation). Rowwise int8 quantisation rounds each entry of
# a row to a step of max|row| / 127: for Gaussian-like rows (max ~4.5 rms
# at K = 4096) that is ~1% rms noise on every projection's input in the
# forward and on every dy * s in the backward, against the ~0.4% of one
# bf16 rounding. The logps stay within QLORA_LOGP_RTOL (read 6.1e-4) and
# the losses within LOSS_TOL. The gradients of b at layers 0 and 31 (a and
# its gradient are 0 at step 0: b starts at 0) collect that noise from
# every layer between them and the loss, twice (forward activations and
# backward dy): the SFT term's gradient (the chosen sequences' mean logp,
# the same step with dpo_weight 0 and sft_weight 1) read rel 0.046-0.25
# and cosine >= 0.967, the DPO margin's gradient, a difference of the win
# and rej gradients each several times larger, rel 0.16-0.43 and cosine
# >= 0.914 (on an H100 80GB HBM3, PERF.md section 6; the same inputs and
# deterministic kernels repeat these readings). The bounds sit about 1.5x outside them:
# a scale left out or a dy quantised without its row scale moves rel far
# past 1, a wrong or dropped dx turns the cosine to ~0
QLORA_LOGP_RTOL = 5e-3
# 3d: one projection's int8 route against the dequant route on Gaussian
# inputs: ~1% (see route_noise), plus bf16 rounding of both outputs
ROUTE_REL_TOL = 0.03
QLORA_GRAD_REL_TOL = 0.6
QLORA_GRAD_COS_MIN = 0.85
QLORA_SFT_GRAD_REL_TOL = 0.4
QLORA_SFT_GRAD_COS_MIN = 0.95
QLORA_LR = 1e-4  # constant: the adapters' b moves off 0 by ~lr a step


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


COUNTERS = {  # every kernel's launch count: (owner, attribute)
    "flash": (flash_attention, "launches"),
    "dq": (flash_attention_bwd, "dq_launches"),
    "dkv": (flash_attention_bwd, "dkv_launches"),
    "decode": (decode_attention_prefix, "launches"),
    "head_fwd": (fused_target_logp, "fwd_launches"),
    "head_dx": (fused_target_logp, "dx_launches"),
    "head_dw": (fused_target_logp, "dw_launches"),
    "int8": (qm.int8_matmul, "launches"),
    "int8_dx": (qm.int8_matmul_dx, "launches"),
    "int8_prequant": (qm.int8_matmul_prequant, "launches"),
    "int8_dx_prequant": (qm.int8_matmul_dx_prequant, "launches"),
}


def reset_counts() -> None:
    for owner, attr in COUNTERS.values():
        setattr(owner, attr, 0)


def read_counts() -> dict:
    return {k: getattr(owner, attr) for k, (owner, attr) in COUNTERS.items()}


def add_counts(total: dict, more: dict) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v
    return total


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


def bound(flop: float, nbytes: float, peak_tera: float = PEAK_BF16_TFLOPS) -> dict:
    """The least time the card could take for the work: the larger of the
    operations at the tensor-core peak for their type (bf16 unless given)
    and the bytes (each input read once, each output written once) at the
    HBM peak."""
    t_ops = flop / (peak_tera * 1e12) * 1e3
    t_bytes = nbytes / (HBM_PEAK_GBPS * 1e9) * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _visible(mask: torch.Tensor, Lq: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs this mask lets the attention read: keys with mask
    1, and (causal) at or before the query's absolute position."""
    if not causal:
        return int(mask.sum()) * Lq
    last = torch.clamp(q_offset + torch.arange(Lq, device=mask.device), max=mask.shape[1] - 1)
    return int(torch.cumsum(mask.long(), dim=1)[:, last].sum())


def _sdpa_mask(mask: torch.Tensor, Lq: int, causal: bool, q_offset: int) -> torch.Tensor:
    """The boolean (B, 1, Lq, Lk) mask of the same attention for SDPA."""
    keep = (mask != 0)[:, None, None, :]
    if causal:
        qpos = q_offset + torch.arange(Lq, device=mask.device)[:, None]
        keep = keep & (torch.arange(mask.shape[1], device=mask.device)[None, :] <= qpos)
    return keep


def sdpa(q, k, v, keep):
    """torch's scaled_dot_product_attention on (B, L, H, D) operands: the
    library yardstick of the attention kernels, timed here only."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=keep)
    return out.transpose(1, 2)


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
            keep = _sdpa_mask(mask, L, True, 0)
            t_lib = time_ms(lambda: sdpa(q, k, v, keep))
            flop = 4 * H * D * _visible(mask, L, True, 0)
            results["flash"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_lib,
                                    **bound(flop, _nbytes(q, k, v, out, lse, mask)))
            log(f"[3 flash] autocheck prefix: SDPA with the same boolean mask "
                f"{t_lib:.4f} ms (library yardstick) | bound "
                f"{results['flash']['bound_ms']:.4f} ms ({results['flash']['bound_by']})")
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
            kv, vv, mv = k[:, :valid_len], v[:, :valid_len], mask[:, :valid_len]
            keep = (mv != 0)[:, None, None, :]
            t_lib = time_ms(lambda: sdpa(q[:, None], kv, vv, keep))
            flop = 4 * H * D * int(mv.sum())
            results["decode"] = dict(ms=t_k, plain_ms=t_p, gbps=gbps, library_ms=t_lib,
                                     **bound(flop, _nbytes(q, kv, vv, mv, out)))
            log(f"[3 decode] valid_len={valid_len}: SDPA over the live prefix "
                f"{t_lib:.4f} ms (library yardstick) | bound "
                f"{results['decode']['bound_ms']:.4f} ms ({results['decode']['bound_by']})")
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
            ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
            lib_out = sdpa(ql, kl, vl, _sdpa_mask(mask, Lq, True, off))
            t_lib = time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                        retain_graph=True))
            pairs = H * D * _visible(mask, Lq, True, off)
            stats = _nbytes(lse, lse, mask)  # lse, delta, mask
            res.update(dq_ms=t_dq, dkv_ms=t_dkv, plain_ms=t_plain, library_ms=t_lib,
                       dq_bound=bound(6 * pairs, _nbytes(q, k, v, do, q) + stats),
                       dkv_bound=bound(8 * pairs, _nbytes(q, k, v, do, k, v) + stats))
            log(f"[3b flash bwd] train suffix: SDPA's autograd backward (dq, dk, dv "
                f"together) {t_lib:.4f} ms (library yardstick) | bound dq "
                f"{res['dq_bound']['bound_ms']:.4f} ms ({res['dq_bound']['bound_by']}), "
                f"dk/dv {res['dkv_bound']['bound_ms']:.4f} ms "
                f"({res['dkv_bound']['bound_by']})")
    return res


def _head_inputs(g, M: int, H: int, V: int) -> tuple:
    """bf16 hidden rows ~N(0, 1) (the final RMSNorm's scale), the (V, H)
    head weight ~N(0, 0.02) (its init), labels and upstream gradients."""
    x = torch.randn(M, H, generator=g, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(V, H, generator=g, device="cuda")).to(torch.bfloat16)
    y = torch.randint(0, V, (M,), generator=g, device="cuda", dtype=torch.int32)
    gr = torch.randn(M, generator=g, device="cuda")
    return x, w, y, gr


def _grad_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|got - ref|, the largest ratio of an entry's error to its 3c
    bound: within the bound at <= 1)."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    allowed = HEAD_GRAD_RTOL * ref.abs() + HEAD_GRAD_ATOL * ref.abs().max()
    ratio = (d / allowed).max().item() if bool(torch.isfinite(got).all()) else math.inf
    return d.max().item(), ratio


def head_check(x, w, y, gr, backward: bool = True, fault: str = "") -> dict:
    """The fused-head kernels against the plain versions on one input set.
    `fault` plants one error around the sound kernels (the probe): "g" drops
    the upstream gradient, "onehot" drops the label's one-hot, "lse" shifts
    the saved lse by 0.5, "ragged" leaves the ragged vocabulary tile
    unmasked (zero weight rows scored as real columns)."""
    M, V = x.shape[0], w.shape[0]
    ref_logp, ref_lse = fused_head_fwd_plain(x, w, y)
    kx, kw, ky = x, w, y
    if fault == "ragged":
        kw = torch.cat([w, w.new_zeros((-V % 64, w.shape[1]))])
    if fault == "onehot":
        ky = torch.full_like(y, V + 7)  # a label no column matches
    logp, lse = _kernel_fwd(kx, kw, ky)
    out = {"logp_err": (logp - ref_logp).abs().max().item(),
           "lse_err": (lse - ref_lse).abs().max().item()}
    ok = out["logp_err"] <= HEAD_FWD_TOL and out["lse_err"] <= HEAD_FWD_TOL and \
        bool(torch.isfinite(logp).all())
    if backward:
        ref_dx, ref_dw = fused_head_bwd_plain(x, w, y, ref_lse, gr)
        klse = lse + 0.5 if fault == "lse" else lse
        kg = torch.ones_like(gr) if fault == "g" else gr
        dx = _kernel_dx(kx, kw, ky, klse, kg)
        dw = _kernel_dw(kx, kw, ky, klse, kg)[:V]
        out["dx_err"], out["dx_ratio"] = _grad_err(dx, ref_dx)
        out["dw_err"], out["dw_ratio"] = _grad_err(dw, ref_dw)
        ok = ok and out["dx_ratio"] <= 1 and out["dw_ratio"] <= 1
    torch.cuda.synchronize()
    out["ok"] = ok
    return out


def _composite(x, w, y):
    """The library yardstick of the fused head: no single PyTorch call
    computes it, so two: F.linear then F.cross_entropy(reduction="none")
    (-logp), timed here only."""
    return -torch.nn.functional.cross_entropy(torch.nn.functional.linear(x, w),
                                              y.long(), reduction="none")


def head_cases(pair: dict) -> list:
    """3c's cases: the train step's head (M = 2 (L - 1) rows of the collated
    pair, H = 4096, V = 32000), the ref-logp plain fallback at batch_pairs 8
    (M = 16 x 1023, less 5 for a ragged row tile), the single-pass regime of
    TPU row 13 (H = 1024) and ragged vocabularies (V = 32001 and 300)."""
    M = 2 * (pair["batch_np"]["input_ids"].shape[1] - 1)
    return [
        dict(name="train step", M=M, H=4096, V=32000, backward=True, time=True),
        dict(name="ref-logp fallback", M=16 * 1023 - 5, H=4096, V=32000, backward=False,
             time=True),
        dict(name="small H (row 13)", M=M, H=1024, V=32000, backward=True, time=True),
        dict(name="ragged vocab", M=1000, H=4096, V=32001, backward=True, time=False),
        dict(name="tiny ragged", M=77, H=1024, V=300, backward=True, time=False),
    ]


def phase_head(g, pair: dict) -> dict:
    """3c: the fused-head kernels (forward, dx, dW) against the plain
    versions, their times beside the bound and the library composite, then
    the planted-fault probe."""
    res = {"fwd_err": 0.0, "dx_err": 0.0, "dw_err": 0.0}
    for c in head_cases(pair):
        M, H, V = c["M"], c["H"], c["V"]
        x, w, y, gr = _head_inputs(g, M, H, V)
        r = head_check(x, w, y, gr, backward=c["backward"])
        msg = (f"[3c fused head] {c['name']}: M={M} H={H} V={V} | max|logp err| "
               f"{r['logp_err']:.3e} max|lse err| {r['lse_err']:.3e} (tol {HEAD_FWD_TOL})")
        if c["backward"]:
            msg += (f" | max|dx err| {r['dx_err']:.3e} max|dW err| {r['dw_err']:.3e} "
                    f"(tol {HEAD_GRAD_RTOL:.4f} x |plain| + {HEAD_GRAD_ATOL} x max|plain|; "
                    f"worst entry at {r['dx_ratio']:.3f} / {r['dw_ratio']:.3f} of it)")
        res["fwd_err"] = max(res["fwd_err"], r["logp_err"], r["lse_err"])
        res["dx_err"] = max(res["dx_err"], r.get("dx_err", 0.0))
        res["dw_err"] = max(res["dw_err"], r.get("dw_err", 0.0))
        if c["time"]:
            runs = 10 if M > 4096 else 20
            flop = 2 * M * H * V
            t_f = time_ms(lambda: _kernel_fwd(x, w, y), runs)
            t_fp = time_ms(lambda: fused_head_fwd_plain(x, w, y), runs)
            t_fl = time_ms(lambda: _composite(x, w, y), runs)
            b_f = bound(flop, _nbytes(x, w, y) + 8 * M)
            msg += (f" | fwd kernel {t_f:.3f} ms = {flop / (t_f * 1e-3) / 1e12:.1f} "
                    f"TFLOP/s, plain {t_fp:.3f} ms, library composite (F.linear + "
                    f"F.cross_entropy) {t_fl:.3f} ms, bound {b_f['bound_ms']:.3f} ms "
                    f"({b_f['bound_by']})")
            res.setdefault("fwd", {})[c["name"]] = dict(ms=t_f, plain_ms=t_fp,
                                                        library_ms=t_fl, **b_f)
            if c["backward"]:
                _, lse = _kernel_fwd(x, w, y)
                t_dx = time_ms(lambda: _kernel_dx(x, w, y, lse, gr))
                t_dw = time_ms(lambda: _kernel_dw(x, w, y, lse, gr))
                t_bp = time_ms(lambda: fused_head_bwd_plain(x, w, y, lse, gr), 10)
                xl, wl = (t.detach().clone().requires_grad_(True) for t in (x, w))
                lib = _composite(xl, wl, y)
                t_bl = time_ms(lambda: torch.autograd.grad(lib, (xl, wl), gr,
                                                           retain_graph=True))
                stats = _nbytes(x, w, y, lse, gr)
                b_dx = res.setdefault("dx", {})[c["name"]] = dict(
                    ms=t_dx, plain_ms=t_bp, library_ms=t_bl,
                    **bound(2 * flop, stats + _nbytes(x)))
                b_dw = res.setdefault("dw", {})[c["name"]] = dict(
                    ms=t_dw, plain_ms=t_bp, library_ms=t_bl,
                    **bound(2 * flop, stats + _nbytes(w)))
                msg += (f" | dx kernel {t_dx:.3f} ms = {2 * flop / (t_dx * 1e-3) / 1e12:.1f} "
                        f"TFLOP/s (bound {b_dx['bound_ms']:.3f} ms), dW kernel "
                        f"{t_dw:.3f} ms = {2 * flop / (t_dw * 1e-3) / 1e12:.1f} TFLOP/s "
                        f"(bound {b_dw['bound_ms']:.3f} ms), plain backward (dx "
                        f"and dW) {t_bp:.3f} ms, composite's autograd backward "
                        f"{t_bl:.3f} ms")
                del xl, wl, lib
        log(msg + f" | {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            raise AssertionError(f"fused head kernels disagree with the plain versions: "
                                 f"{c['name']}")
        del x, w, y, gr
    torch.cuda.empty_cache()

    # the probe: each planted fault must break the bounds above
    x, w, y, gr = _head_inputs(g, 2046, 1024, 32001)
    for fault in ("g", "onehot", "lse", "ragged"):
        r = head_check(x, w, y, gr, fault=fault)
        log(f"[3c fused head] planted fault {fault!r} (M=2046 H=1024 V=32001): max|logp "
            f"err| {r['logp_err']:.3e} max|lse err| {r['lse_err']:.3e} max|dx err| "
            f"{r['dx_err']:.3e} max|dW err| {r['dw_err']:.3e} (worst entry at "
            f"{r['dx_ratio']:.3g} / {r['dw_ratio']:.3g} of its bound) | "
            f"{'caught' if not r['ok'] else 'MISSED'}")
        if r["ok"]:
            raise AssertionError(f"the 3c bounds miss the planted fault {fault!r}")
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

    reset_counts()
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
    launches = read_counts()
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


def _text(rng, k: int) -> str:
    chars = np.asarray(list("abcdefghijklmnopqrstuvwxyz     "))
    return "q" + "".join(rng.choice(chars, k - 2)) + "e"


def _raw_row(idx: str, question: str, chosen: str, rejected: str,
             image_bytes: bytes) -> dict:
    return {"idx": idx, "question": question, "chosen": chosen, "rejected": rejected,
            "image": {"bytes": image_bytes, "path": "test.jpeg"},
            "image_path": "test.jpeg", "origin_dataset": "chip_smoke",
            "origin_split": "{}"}


def synth_rows(image_bytes: bytes, n: int = 16) -> list:
    """n raw RLAIF-V rows (question, chosen, rejected, image) at the train
    pair's geometry: with the character-level tokenizer a 24-token question
    and answers of 224-256 (chosen) and 160-224 (rejected) tokens after the
    llava_v1 system prompt and the image's 576 slots; random letters and
    spaces, seeded; every row on examples/test.jpeg."""
    rng = np.random.default_rng(0)
    return [_raw_row(str(i), _text(rng, 24), _text(rng, int(rng.integers(224, 257))),
                     _text(rng, int(rng.integers(160, 225))), image_bytes)
            for i in range(n)]


def short_row(image_bytes: bytes) -> dict:
    """9's short pair: an 8-token question and answers of 10 and 8 tokens,
    so that its suffix past the image (question, the assistant tag, the
    answer), trimmed to the labels, has fewer rows (two of W tokens) than
    INT8_DEQUANT_MIN_M."""
    rng = np.random.default_rng(1)
    return _raw_row("short", _text(rng, 8), _text(rng, 10), _text(rng, 8), image_bytes)


def preference_items(rows: list, tok, cfg: LlavaConfig, logps=None) -> list:
    """The (rej, win) items DPODataset._get_one builds from parquet rows and
    their reference logps, built in memory (no parquet on this path)."""
    spec = get_family("llava15")
    mm_cfg = spec.mm_cfg(ClipImageProcessor(image_size=cfg.vision.image_size),
                         cfg.num_image_tokens)
    items = _encode_rows(rows, tok, mm_cfg, spec.preprocess_func)
    for (rej, win), lp in zip(items, logps or []):
        win["ref_win_logp"], win["ref_win_avg_logp"], win["ref_win_per_token_logp"] = lp[:3]
        rej["ref_rej_logp"], rej["ref_rej_avg_logp"], rej["ref_rej_per_token_logp"] = lp[3:]
    return items


def collate_train_pair(items: list, tok, cfg: LlavaConfig) -> dict:
    """6, data: configs/llava15_dpo.json's training settings (one pair a
    step, max_len 2048, shared_prefix_len -1, lm_head_impl "auto"); the
    first row's pair collated as train.py collates it (DPOCollator's default
    bucket: the batch pads to the next multiple of 256 tokens) and its shared
    prefix derived from the batch."""
    t = Config.from_json(str(ROOT / "configs" / "llava15_dpo.json")).training
    assert t.shared_prefix_len == -1 and t.per_device_batch_pairs == 1
    assert getattr(t, "lm_head_impl", "auto") == "auto"
    collator = DPOCollator(pad_token_id=tok.pad_token_id, max_len=2048,
                           num_patches=cfg.num_image_tokens, beta=t.dpo_beta,
                           **get_family("llava15").collator_kwargs(tok))
    batch_np = collator(items[:1])
    P = derive_shared_prefix_len(batch_np, cfg.num_image_tokens)
    validate_shared_prefix(batch_np, P, cfg.num_image_tokens)
    return dict(batch_np=batch_np, P=P, training=t)


def build_model(cfg: LlavaConfig, tag: str = "8 ref-logp", device: str = "cuda"):
    """The model of `cfg` (LLaVA-1.5-7B with remat here), random weights
    from seed 0: the frozen starting policy of phase 8, the policy of 6 and,
    built again, the base that 9 quantises."""
    t0 = time.perf_counter()
    model = LlavaForCausalLM(cfg, device="meta").to_empty(device=device)
    init_weights_(model, torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    log(f"[{tag}] LLaVA-1.5-7B bf16, remat on: "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def _seq_close(a: list, b: list, rtol: float) -> tuple:
    """(max relative difference of the sums and means, mean |difference| of
    the per-token logps, max of it) between two row lists of one layout."""
    rel, tok_mean, tok_max = 0.0, 0.0, 0.0
    for ra, rb in zip(a, b):
        for k in (0, 1, 3, 4):
            rel = max(rel, abs(ra[k] - rb[k]) / abs(rb[k]))
        for k in (2, 5):
            assert len(ra[k]) == len(rb[k]), "per-token layouts differ"
            d = np.abs(np.asarray(ra[k]) - np.asarray(rb[k]))
            tok_mean, tok_max = max(tok_mean, float(d.mean())), max(tok_max, float(d.max()))
    return rel, tok_mean, tok_max


def phase_ref_logp(model, tok, rows: list, cfg: LlavaConfig) -> tuple:
    """8: the reference-logp precompute of the rows through the port's
    score_preference_rows three times: the shared-prefix path (the default
    of inference_logp), the plain scorer with the fused head (what rows
    that cannot share take, and what "auto" picks at 7B) and the plain
    scorer with the "xla" head (the comparison, not counted). A spy on
    DecodeEngine.score_pair_logps counts the rows the shared path scored."""
    kw = dict(max_len=2048, num_patches=cfg.num_image_tokens, batch_pairs=8,
              image_processor=ClipImageProcessor(image_size=cfg.vision.image_size),
              progress=False)
    spied = []
    orig = DecodeEngine.score_pair_logps

    def spy(self, prefixes, *a, **k):
        spied.append(len(prefixes))
        return orig(self, prefixes, *a, **k)

    DecodeEngine.score_pair_logps = spy
    runs, launches = {}, {}
    try:
        for name, extra in (("shared", dict(shared_prefix=True)),
                            ("fused", dict(lm_head_impl="fused")),
                            ("xla", dict(lm_head_impl="xla"))):
            score_preference_rows(rows[:2], model, tok, **kw, **extra)  # warm-up
            torch.cuda.synchronize()
            spied.clear()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            out = score_preference_rows(rows, model, tok, **kw, **extra)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if name != "xla":  # the comparison's launches do not count
                add_counts(launches, read_counts())
            runs[name] = out
            ok = all(np.isfinite(r[k]) for r in out for k in (0, 1, 3, 4))
            log(f"[8 ref-logp] {name}: {len(rows)} pairs in {dt:.3f} s = "
                f"{len(rows) / dt:.2f} pairs/s | peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | rows through "
                f"the shared-prefix engine {sum(spied)} | logps row 0 "
                f"{out[0][0]:.2f}/{out[0][3]:.2f}")
            if not ok:
                raise AssertionError(f"8: non-finite logps on the {name} path")
            if sum(spied) != (len(rows) if name == "shared" else 0):
                raise AssertionError(f"8: the shared path scored {sum(spied)} of "
                                     f"{len(rows)} rows on the {name} run")
    finally:
        DecodeEngine.score_pair_logps = orig
    ok = True
    for a, b, rtol in (("shared", "fused", LOGP_RTOL), ("fused", "xla", HEAD_LOGP_RTOL)):
        rel, tmean, tmax = _seq_close(runs[a], runs[b], rtol)
        good = rel <= rtol and tmean <= TOKEN_MEAN_TOL
        ok = ok and good
        log(f"[8 ref-logp] {a} vs {b}: sums and means max rel {rel:.3e} (tol {rtol}) | "
            f"per-token |d| mean {tmean:.3e} (tol {TOKEN_MEAN_TOL}) max {tmax:.3e} | "
            f"{'ok' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("8: the ref-logp paths disagree")
    if launches["head_fwd"] < 1 or launches["flash"] < 2 * cfg.llm.num_layers:
        raise AssertionError(f"8: a kernel of the ref-logp path did not run: {launches}")
    log(f"[8 ref-logp] launches: flash fwd {launches['flash']}, fused head fwd "
        f"{launches['head_fwd']}")
    return runs["shared"], launches


def build_train(pair: dict, model, device: str = "cuda") -> dict:
    """6, set-up: the step's hyperparameters and the collated pair with the
    reference logps phase 8 wrote for it."""
    cfg = model.cfg
    t, P, batch_np = pair["training"], pair["P"], pair["batch_np"]
    L = batch_np["input_ids"].shape[1]
    hp = DPOHparams(beta=t.dpo_beta, dpo_use_average=t.dpo_use_average,
                    lm_head_impl=resolve_head(t, cfg.llm.hidden_size),
                    shared_prefix_len=P)
    assert hp.lm_head_impl == "fused", hp.lm_head_impl
    batch = batch_to_device(batch_np, device)
    adapter = LlavaDPOAdapter(model)
    model.train()
    # the paired path's rows: the prefix once, each suffix padded to W
    tokens = P + 2 * (L - P)
    real = P + int(batch_np["attention_mask"][:, P:].sum())
    log(f"[6 train] LLaVA-1.5 bf16 full fine-tune, remat on | "
        f"one pair padded to L={L} (bucket 256), derived P={P} (array "
        f"{-(-P // 128) * 128}), W={L - P}: {tokens} tokens a step, {real} of them "
        f"not padding | head {hp.lm_head_impl} (\"auto\" at hidden "
        f"{cfg.llm.hidden_size}), beta {hp.beta}, constant lr {TRAIN_LR}, weight decay "
        f"{t.weight_decay}, clip {t.max_grad_norm} | reference logps from phase 8 "
        f"{float(batch_np['ref_win_logp'][0]):.3f}/{float(batch_np['ref_rej_logp'][0]):.3f}")
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
    losses, times, launches = [], [], {}
    for i in range(4):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ts = time.perf_counter()
        metrics = step(tr["batch"])
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        times.append(time.perf_counter() - ts)
        n = read_counts()
        add_counts(launches, n)
        losses.append(loss)
        log(f"[6 train] step {i}: loss {loss:.6e} grad_norm {gnorm:.4e} | "
            f"{times[-1]:.3f} s | flash launches fwd {n['flash']} bwd dq {n['dq']} "
            f"dk/dv {n['dkv']} | fused head fwd {n['head_fwd']} dx {n['head_dx']} "
            f"dW {n['head_dw']}" + (f" | policy logps {float(metrics['logps_train/chosen']):.3f}"
                                     f"/{float(metrics['logps_train/rejected']):.3f}"
                                     if i == 0 else ""))
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"non-finite loss or grad norm at step {i}")
        if min(n["flash"], n["dq"], n["dkv"]) < n_layers or \
                min(n["head_fwd"], n["head_dx"], n["head_dw"]) < 1:
            raise AssertionError(f"a kernel of the train path did not run: {n}")
        if i == 0 and (abs(loss - math.log(2)) > REF_LN2_TOL or not gnorm > 0):
            raise AssertionError(f"step 0: loss {loss} not within {REF_LN2_TOL} of ln 2 "
                                 f"(policy == reference) or grad norm {gnorm} not above 0")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = statistics.mean(times[1:])
    log(f"[6 train] steps 1-3 (after the warm-up step 0): {step_s:.3f} s a step = "
        f"{1 / step_s:.3f} pairs/s = {tr['tokens'] / step_s:.0f} tokens/s with padding, "
        f"{tr['real_tokens'] / step_s:.0f} without | peak device memory "
        f"{peak_gb:.2f} GiB | loss {losses[0]:.6f} -> {losses[-1]:.3e} "
        f"(step 0 within {REF_LN2_TOL} of ln 2 = {math.log(2):.6f}: "
        f"{losses[0] - math.log(2):+.3e})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall after 3 updates: {losses}")

    # the same step with the "xla" head on the same optimizer and batch, for
    # the step time and peak memory beside the fused head's (not counted)
    xla_step = make_dpo_train_step(tr["adapter"], optimizer,
                                   dataclasses.replace(tr["hp"], lm_head_impl="xla"))
    torch.cuda.reset_peak_memory_stats()
    xla_times = []
    for _ in range(3):
        ts = time.perf_counter()
        float(xla_step(tr["batch"])["loss"])
        xla_times.append(time.perf_counter() - ts)
    log(f"[6 train] the same step with the \"xla\" head (comparison, after the fused "
        f"steps): {', '.join(f'{t:.3f}' for t in xla_times)} s, mean "
        f"{statistics.mean(xla_times):.3f} s against {step_s:.3f} s fused | peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB against "
        f"{peak_gb:.2f} GiB fused")
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
        "final norm": "llm.model.ln_f.weight",
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
    """7: paired + flash, plain + flash and plain + dense on one pair with
    the fused head, and paired + flash with the "xla" head, at the weights
    the reference logps came from (loss about ln 2 on the paired path), each
    path's loss, logps and named gradients."""
    plain = dataclasses.replace(hp, shared_prefix_len=0)
    xla = dataclasses.replace(hp, lm_head_impl="xla")
    runs = {"paired+flash": train_run(model, adapter, batch, hp, "auto"),
            "plain+flash": train_run(model, adapter, batch, plain, "auto"),
            "plain+dense": train_run(model, adapter, batch, plain, "dense"),
            "paired+flash xla head": train_run(model, adapter, batch, xla, "auto")}
    ok = runs["plain+dense"][3] == 0 and runs["paired+flash"][3] > 0
    for name, ref_name in (("paired+flash", "plain+dense"), ("plain+flash", "plain+dense"),
                           ("paired+flash", "plain+flash"),
                           ("paired+flash", "paired+flash xla head")):
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


def qlora_batches(rows: list, short: dict, tok, cfg: LlavaConfig, ref=None) -> dict:
    """9, data: configs/llava15_dpo_qlora.json (int8 base, adapters r 64 /
    alpha 16, 8 pairs a step, max_len 2048, shared_prefix_len -1) collated
    as train.py collates it (DPOCollator's bucket 256): the first 8 rows as
    one batch, its shared prefix derived; and the short row's pair with its
    suffix trimmed to the labels (shared_suffix_len W, a multiple of 16).
    `ref`: the reference logps of rows + [short]. The projections' row
    counts (prefix 8 Pa, suffix 2 x 8 (L - P), short suffix 2 W) follow from
    the shapes alone, so phase 3d reads them before any logps exist."""
    c = Config.from_json(str(ROOT / "configs" / "llava15_dpo_qlora.json"))
    t, n = c.training, cfg.num_image_tokens
    assert c.model.quantize and c.model.quantize_bits == 8 and t.use_lora
    assert t.per_device_batch_pairs == 8 and t.shared_prefix_len == -1
    collator = DPOCollator(pad_token_id=tok.pad_token_id, max_len=c.data.max_len,
                           num_patches=n, beta=t.dpo_beta,
                           **get_family("llava15").collator_kwargs(tok))
    items = preference_items(rows + [short], tok, cfg, ref)
    batch = collator(items[:t.per_device_batch_pairs])
    P = derive_shared_prefix_len(batch, n)
    validate_shared_prefix(batch, P, n)
    sbatch = collator(items[-1:])
    Ps = derive_shared_prefix_len(sbatch, n)
    last = int(np.nonzero((sbatch["labels"] != IGNORE_INDEX).any(axis=0))[0].max()) + 1
    W = -(-(last - Ps) // 16) * 16
    validate_shared_prefix(sbatch, Ps, n, suffix_len=W)
    assert 2 * W < qm.INT8_DEQUANT_MIN_M, (W, qm.INT8_DEQUANT_MIN_M)
    B, L = t.per_device_batch_pairs, batch["input_ids"].shape[1]
    return dict(config=c, batch_np=batch, P=P, short_np=sbatch, Ps=Ps, W=W,
                m_prefix=B * (-(-P // 128) * 128), m_suffix=2 * B * (L - P), m_short=2 * W)


def int_mm_ms(a: torch.Tensor, b: torch.Tensor):
    """torch._int_mm (cuBLASLt, int8 x int8 -> int32) on the same int8
    operands: the library yardstick of the int8 kernels, product only (no
    quantisation, no scales), timed here only; None where it refuses the
    operands (it takes more than 16 rows)."""
    try:
        torch._int_mm(a, b)
    except RuntimeError as e:
        log(f"[3d int8] torch._int_mm refuses {tuple(a.shape)} x {tuple(b.shape)}: "
            f"{str(e).splitlines()[0][:120]}")
        return None
    return time_ms(lambda: torch._int_mm(a, b))


def route_noise(x, dy, q, s, out, dx) -> None:
    """One projection's int8 route against the "dequant" route on Gaussian
    x and dy: the activation-quantisation error of a single forward and dx,
    ~1% of a row's rms for Gaussian rows (a step of max|row| / 127, max ~4.5
    rms). Phase 9 reads the same noise summed over 32 layers."""
    rel = [((a.float() - r.float()).norm() / r.float().norm()).item()
           for a, r in ((out, qm.dequant_matmul(x, q, s)),
                        (dx, qm.dequant_matmul_dx(dy, q, s)))]
    ok = max(rel) <= ROUTE_REL_TOL
    log(f"[3d int8] M={x.shape[0]} K={q.shape[0]} N={q.shape[1]}: int8 route against the "
        f"dequant route, ||d|| / ||dequant||: forward {rel[0]:.3e} dx {rel[1]:.3e} (tol "
        f"{ROUTE_REL_TOL}) | {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the int8 route's quantisation error exceeds its bound")


def phase_int8(g, qb: dict) -> dict:
    """3d: the four int8 kernels against their plain twins (max abs
    difference 0; #7 == #9, #8 == #10) at the 7B projection widths, with
    times beside the int8 bound, torch._int_mm and the "dequant" route."""
    res = {"err": 0.0}
    ms = sorted({16, 64, 127, 128, qb["m_short"], qb["m_suffix"], qb["m_prefix"]})
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        for M in ms:
            x, dy = _randn(g, M, K), _randn(g, M, N)
            q, s = quantize_kernel_int8_torch(
                0.02 * torch.randn(K, N, generator=g, device="cuda"))
            xq, sx = qm.quantize_rows(x.float())
            dyq, sy = qm.quantize_rows(dy.float() * s)
            sx, sy = sx.reshape(-1), sy.reshape(-1)
            run = {7: lambda: qm._kernel_fwd(x, q, s),
                   9: lambda: qm._kernel_prequant(xq, sx, q, s),
                   8: lambda: qm._kernel_dx(dy, q, s),
                   10: lambda: qm._kernel_dx_prequant(dyq, sy, q)}
            out = {k: fn() for k, fn in run.items()}
            plain = {7: qm.int8_matmul_plain(x, q, s), 8: qm.int8_matmul_dx_plain(dy, q, s)}
            plain[9], plain[10] = plain[7], plain[8]
            torch.cuda.synchronize()
            err = {k: (out[k].float() - plain[k].float()).abs().max().item() for k in out}
            ok = max(err.values()) == 0 and torch.equal(out[7], out[9]) and \
                torch.equal(out[8], out[10]) and \
                all(bool(torch.isfinite(o.float()).all()) for o in out.values())
            t = {k: time_ms(fn) for k, fn in run.items()}
            t_quant = time_ms(lambda: qm.quantize_rows(x.float()))
            t_plain = {7: time_ms(lambda: qm.int8_matmul_plain(x, q, s), 5),
                       8: time_ms(lambda: qm.int8_matmul_dx_plain(dy, q, s), 5)}
            t_lib = {7: int_mm_ms(xq, q), 8: int_mm_ms(dyq, q.T)}
            t_deq = {7: time_ms(lambda: qm.dequant_matmul(x, q, s)),
                     8: time_ms(lambda: qm.dequant_matmul_dx(dy, q, s))}
            nbytes = {7: _nbytes(x, q, s, out[7]), 9: _nbytes(xq, sx, q, s, out[9]),
                      8: _nbytes(dy, q, s, out[8]), 10: _nbytes(dyq, sy, q, out[10])}
            ops = 2 * M * K * N
            entry = {}
            for k in run:
                ref = 7 if k in (7, 9) else 8
                entry[k] = dict(ms=t[k], plain_ms=t_plain[ref], library_ms=t_lib[ref],
                                dequant_ms=t_deq[ref],
                                **bound(ops, nbytes[k], PEAK_INT8_TOPS))
            res[(M, K, N)] = entry

            def lib(k):
                return "refused" if t_lib[k] is None else f"{t_lib[k]:.4f}"

            log(f"[3d int8] M={M} K={K} N={N}: max|err| #7 {err[7]:.1e} #9 {err[9]:.1e} "
                f"#8 {err[8]:.1e} #10 {err[10]:.1e} (tol 0), #7==#9 "
                f"{torch.equal(out[7], out[9])} #8==#10 {torch.equal(out[8], out[10])} | "
                + " ".join(f"#{k} {t[k]:.4f} ms = {ops / (t[k] * 1e-3) / 1e12:.1f} TOP/s "
                           f"(bound {entry[k]['bound_ms']:.4f}, {entry[k]['bound_by']})"
                           for k in run)
                + f" | torch row quantisation of x (the prequant route's pass) "
                f"{t_quant:.4f} ms | plain fwd {t_plain[7]:.3f} dx {t_plain[8]:.3f} ms | "
                f"torch._int_mm fwd {lib(7)} dx {lib(8)} ms (product only) | dequant "
                f"route fwd {t_deq[7]:.4f} dx {t_deq[8]:.4f} ms | "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int8 kernels disagree with the plain twins at "
                                     f"M={M} K={K} N={N}: {err}")
            res["err"] = max(res["err"], max(err.values()))
            if M == qb["m_prefix"]:
                route_noise(x, dy, q, s, out[9], out[10])
            del x, dy, q, s, xq, dyq, out, plain, run
        torch.cuda.empty_cache()
    return res


def _lora_loss_grads(model, adapter, batch, hp, lora, alpha, names) -> tuple:
    """One loss and backward with the adapters attached and no update ->
    (loss, (chosen, rejected) logps, the named adapter gradients in fp32)."""
    tensors = dict(named_tensors(lora))
    for t in tensors.values():
        t.grad = None
    attach_lora(model, lora_scaled(lora, alpha=alpha))
    loss, metrics = dpo_loss_from_batch(adapter, batch, hp)
    loss.backward()
    attach_lora(model, None)
    logps = (float(metrics["logps_train/chosen"]), float(metrics["logps_train/rejected"]))
    return (float(loss.detach()), logps,
            {k: tensors[n].grad.float().clone() for k, n in names.items()})


def phase_qlora(model, tok, rows: list, short: dict, cfg: LlavaConfig,
                ref_bf16: list) -> dict:
    """9: the QLoRA slice on phase 8's seed-0 model (built anew): int8
    quantisation on the card, the reference logps on the int8 base, step 0
    against the "dequant" route, 3 AdamW steps of 8 pairs, one short step."""
    from rlaifv_tpu_torch.models.llama import QuantDense

    L_layers = cfg.llm.num_layers
    t0 = time.perf_counter()
    quantize_llm_int8(model, include_lm_head=False)
    torch.cuda.synchronize()
    n_q = sum(isinstance(m, QuantDense) for m in model.modules())
    log(f"[9 qlora] LLM projections quantised to int8 on the card: {n_q} QuantDense "
        f"(7 x {L_layers} layers) in {time.perf_counter() - t0:.2f} s; lm_head "
        f"{type(model.llm.lm_head).__name__} {model.llm.lm_head.weight.dtype}, CLIP and "
        f"projector bf16 | device memory {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    if n_q != 7 * L_layers or isinstance(model.llm.lm_head, QuantDense):
        raise AssertionError("9: the int8 base is not the 7 projections x layers")
    launches = {}

    # the reference logps of the 16 rows and the short one on the int8 base
    kw = dict(max_len=2048, num_patches=cfg.num_image_tokens, batch_pairs=8,
              image_processor=ClipImageProcessor(image_size=cfg.vision.image_size),
              progress=False, shared_prefix=True)
    score_preference_rows(rows[:2], model, tok, **kw)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    ref = score_preference_rows(rows + [short], model, tok, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = read_counts()
    add_counts(launches, n)
    rel, tmean, tmax = _seq_close(ref[:len(ref_bf16)], ref_bf16, 1.0)
    log(f"[9 qlora] ref-logp on the int8 base (shared-prefix path): {len(ref)} pairs in "
        f"{dt:.3f} s = {len(ref) / dt:.2f} pairs/s | peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | launches #9 "
        f"{n['int8_prequant']} #7 {n['int8']} flash {n['flash']} | against phase 8's bf16 "
        f"base (weights and activations quantised): sums and means max rel {rel:.3e}, "
        f"per-token |d| mean {tmean:.3e} max {tmax:.3e}")
    if not all(np.isfinite(r[k]) for r in ref for k in (0, 1, 3, 4)) or \
            n["int8_prequant"] < 7 * L_layers:
        raise AssertionError(f"9: the int8 ref-logp path failed: {n}")

    qb = qlora_batches(rows, short, tok, cfg, ref)
    t = qb["config"].training
    hp = DPOHparams(beta=t.dpo_beta, dpo_use_average=t.dpo_use_average,
                    lm_head_impl=resolve_head(t, cfg.llm.hidden_size),
                    shared_prefix_len=qb["P"])
    assert hp.lm_head_impl == "fused", hp.lm_head_impl
    batch = batch_to_device(qb["batch_np"], "cuda")
    adapter = LlavaDPOAdapter(model)
    model.train()
    lora = lora_init(torch.Generator(device="cuda").manual_seed(t.seed), model, r=t.lora_r)
    n_lora = sum(x.numel() for _, x in named_tensors(lora))
    optimizer = make_optimizer(lora, QLORA_LR, total_steps=t.max_steps, warmup_ratio=0.0,
                               weight_decay=t.weight_decay, max_grad_norm=t.max_grad_norm,
                               schedule="constant")
    step = make_lora_dpo_train_step(adapter, optimizer, hp, lora, lora_alpha=t.lora_alpha)
    L, P = qb["batch_np"]["input_ids"].shape[1], qb["P"]
    B = t.per_device_batch_pairs
    tokens = B * P + 2 * B * (L - P)
    real = B * P + int(qb["batch_np"]["attention_mask"][:, P:].sum())
    log(f"[9 qlora] {B} pairs padded to L={L} (bucket 256), derived P={P} (array "
        f"{-(-P // 128) * 128}), W={L - P}: {tokens} tokens a step, {real} not padding | "
        f"adapters r {t.lora_r} alpha {t.lora_alpha} on every projection: {n_lora / 1e6:.1f} M "
        f"fp32 values | head {hp.lm_head_impl}, remat, constant lr {QLORA_LR}, weight decay "
        f"{t.weight_decay} | projection rows: prefix {qb['m_prefix']}, suffix "
        f"{qb['m_suffix']} (from {qm.INT8_DEQUANT_MIN_M}: the prequant kernels)")

    # step 0 on the "dequant" route first (the comparison, not counted),
    # and the SFT term's gradient on both routes
    last = L_layers - 1
    names = {f"layer {i} {p} b": f"llm/model/layer_{i}/{blk}/{p}/b"
             for i in (0, last)
             for blk, p in (("attn", "q_proj"), ("attn", "v_proj"), ("mlp", "down_proj"))}
    hp_sft = dataclasses.replace(hp, dpo_weight=0.0, sft_weight=1.0)
    sft = {}
    for impl in ("dequant", "prequant"):
        qm.INT8_LARGE_M_IMPL = impl
        try:
            if impl == "dequant":
                deq = _lora_loss_grads(model, adapter, batch, hp, lora, t.lora_alpha, names)
            sft[impl] = _lora_loss_grads(model, adapter, batch, hp_sft, lora, t.lora_alpha,
                                         names)
        finally:
            qm.INT8_LARGE_M_IMPL = "prequant"
    _, _, sft_grads = compare_runs(sft["prequant"], sft["dequant"])
    ok = all(rel <= QLORA_SFT_GRAD_REL_TOL and cos >= QLORA_SFT_GRAD_COS_MIN
             for rel, cos in sft_grads.values())
    log("[9 qlora] step 0, SFT term (chosen mean logp), prequant vs dequant route: "
        + " | ".join(f"{k}: rel {r:.3e} cos {c:.6f}" for k, (r, c) in sft_grads.items())
        + f" (tol rel {QLORA_SFT_GRAD_REL_TOL}, cos {QLORA_SFT_GRAD_COS_MIN}) | "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("9: the int8 SFT gradient disagrees with the dequant route")

    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        reset_counts()
        ts = time.perf_counter()
        metrics = step(batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        times.append(time.perf_counter() - ts)
        n = read_counts()
        add_counts(launches, n)
        losses.append(loss)
        log(f"[9 qlora] step {i}: loss {loss:.6e} grad_norm {gnorm:.4e} | "
            f"{times[-1]:.3f} s | int8 launches #9 {n['int8_prequant']} #10 "
            f"{n['int8_dx_prequant']} #7 {n['int8']} #8 {n['int8_dx']} | flash fwd "
            f"{n['flash']} dq {n['dq']} dk/dv {n['dkv']} | fused head fwd {n['head_fwd']} "
            f"dx {n['head_dx']} dW {n['head_dw']} (the head is frozen)")
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"9: non-finite loss or zero grad norm at step {i}")
        if min(n["int8_prequant"], n["int8_dx_prequant"]) < 7 * L_layers or \
                min(n["flash"], n["dq"], n["head_fwd"], n["head_dx"]) < 1:
            raise AssertionError(f"9: a kernel of the QLoRA step did not run: {n}")
        if i == 0:
            tensors = dict(named_tensors(lora))
            run = (loss, (float(metrics["logps_train/chosen"]),
                          float(metrics["logps_train/rejected"])),
                   {k: tensors[nm].grad.float().clone() for k, nm in names.items()})
            d_loss, d_logp, grads = compare_runs(run, deq)
            ok = d_loss <= LOSS_TOL and d_logp <= QLORA_LOGP_RTOL and all(
                rel <= QLORA_GRAD_REL_TOL and cos >= QLORA_GRAD_COS_MIN
                for rel, cos in grads.values())
            log(f"[9 qlora] step 0, prequant (int8 kernels) vs dequant route: loss "
                f"{loss:.5f} vs {deq[0]:.5f} (tol {LOSS_TOL}) | logps "
                f"{run[1][0]:.2f}/{run[1][1]:.2f} vs {deq[1][0]:.2f}/{deq[1][1]:.2f}, max "
                f"rel {d_logp:.2e} (tol {QLORA_LOGP_RTOL}) | "
                + " | ".join(f"{k}: rel {r:.3e} cos {c:.6f}" for k, (r, c) in grads.items())
                + f" (tol rel {QLORA_GRAD_REL_TOL}, cos {QLORA_GRAD_COS_MIN}) | "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("9: the int8 step disagrees with the dequant route")
            if abs(loss - math.log(2)) > REF_LN2_TOL:
                raise AssertionError(f"9: step-0 loss {loss} not within {REF_LN2_TOL} "
                                     f"of ln 2")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = statistics.mean(times[1:])
    log(f"[9 qlora] steps 1-2 (after step 0): {step_s:.3f} s a step = {B / step_s:.3f} "
        f"pairs/s = {tokens / step_s:.0f} tokens/s with padding, {real / step_s:.0f} "
        f"without | peak device memory {peak_gb:.2f} GiB | loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f} (step 0 within {REF_LN2_TOL} of ln 2 = {math.log(2):.6f}: "
        f"{losses[0] - math.log(2):+.3e})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"9: the loss did not fall over 2 updates: {losses}")

    # the short pair: its suffix rows (2 W) take the in-kernel pair #7/#8
    Ps, W = qb["Ps"], qb["W"]
    short_step = make_lora_dpo_train_step(
        adapter, optimizer, dataclasses.replace(hp, shared_prefix_len=Ps,
                                                shared_suffix_len=W),
        lora, lora_alpha=t.lora_alpha)
    reset_counts()
    ts = time.perf_counter()
    metrics = short_step(batch_to_device(qb["short_np"], "cuda"))
    loss = float(metrics["loss"])
    dt = time.perf_counter() - ts
    n = read_counts()
    add_counts(launches, n)
    log(f"[9 qlora] short step: 1 pair, P={Ps}, suffix trimmed to W={W} ({2 * W} rows < "
        f"{qm.INT8_DEQUANT_MIN_M}): loss {loss:.6e} | {dt:.3f} s | int8 launches #7 "
        f"{n['int8']} #8 {n['int8_dx']} #9 {n['int8_prequant']} #10 "
        f"{n['int8_dx_prequant']}")
    # every suffix projection, forward (and its remat recompute) and dx, but
    # layer 0's q, k and v read the embeddings, which need no gradient
    if not math.isfinite(loss) or n["int8"] < 7 * L_layers or \
            n["int8_dx"] < 7 * L_layers - 3:
        raise AssertionError(f"9: the short step missed the in-kernel pair: {n}")
    keys = ("int8", "int8_dx", "int8_prequant", "int8_dx_prequant")
    log(f"[9 qlora] launches on the QLoRA path (ref-logp, 3 steps, short step): "
        f"{ {k: launches[k] for k in keys} }")
    if min(launches[k] for k in keys) < 1:
        raise AssertionError(f"9: an int8 kernel never ran: {launches}")
    return launches


def _row(name, source, replaces, launches, err, timing) -> dict:
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, **{k: timing[k] for k in keys}}


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
    tok = _fake_tokenizer()
    rows = synth_rows(image_bytes)
    pair = collate_train_pair(preference_items(rows, tok, cfg), tok, cfg)
    short = short_row(image_bytes)
    bwd = phase_backward(g, pair)
    head = phase_head(g, pair)
    qb = qlora_batches(rows, short, tok, cfg)
    int8 = phase_int8(g, qb)

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
    gen = Llava15Generator(model, tok, cfg.num_image_tokens,
                           image_size=cfg.vision.image_size,
                           checkpoint_name="random-llava15-7b")
    launches = phase_slice(gen, image_bytes)
    phase_slice_vs_plain(gen, image_bytes)
    del gen, model
    gc.collect()
    torch.cuda.empty_cache()

    # 8 scores the rows with the frozen starting policy; 7 and 6 train that
    # same model on the first row's pair against those reference logps (7
    # runs on the weights before any update: the DPO loss of this random
    # model saturates after one step at any lr that moves bf16 weights)
    model = build_model(LlavaConfig.llava15_7b(remat=True))
    ref_logps, rl = phase_ref_logp(model, tok, rows, cfg)
    add_counts(launches, rl)
    train_pair = collate_train_pair(preference_items(rows, tok, cfg, ref_logps), tok, cfg)
    assert (train_pair["batch_np"]["input_ids"] == pair["batch_np"]["input_ids"]).all()
    tr = build_train(train_pair, model)
    phase_train_vs_plain(tr["model"], tr["adapter"], tr["batch"], tr["hp"])
    add_counts(launches, phase_train(tr))
    del tr, model  # phase 6's model, gradients and optimizer (~55 GiB)
    gc.collect()
    torch.cuda.empty_cache()

    # 9 rebuilds phase 8's seed-0 model, quantises it and trains adapters
    model = build_model(LlavaConfig.llava15_7b(remat=True), "9 qlora")
    add_counts(launches, phase_qlora(model, tok, rows, short, cfg, ref_logps))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[9 qlora] main-path launches (serving 4, ref-logp 8, train 6, QLoRA 9): "
        f"{launches}")
    src = "rlaifv_tpu_torch/csrc/flash_attention_bwd.cu"
    head_src = "rlaifv_tpu_torch/csrc/fused_head.cu"
    kernels = [
        _row("flash_attention_fwd", "rlaifv_tpu_torch/csrc/flash_attention.cu",
             "rlaifv_tpu/ops/flash_attention.py:73", launches["flash"],
             max(kern["flash"]["max_abs_err"], bwd["fwd_err"]), kern["flash"]),
        _row("flash_attention_bwd_dq", src, "rlaifv_tpu/ops/flash_attention.py:157",
             launches["dq"], bwd["dq_err"],
             dict(ms=bwd["dq_ms"], plain_ms=bwd["plain_ms"], library_ms=bwd["library_ms"],
                  **bwd["dq_bound"])),
        _row("flash_attention_bwd_dkv", src, "rlaifv_tpu/ops/flash_attention.py:191",
             launches["dkv"], bwd["dkv_err"],
             dict(ms=bwd["dkv_ms"], plain_ms=bwd["plain_ms"], library_ms=bwd["library_ms"],
                  **bwd["dkv_bound"])),
        _row("decode_attention_prefix", "rlaifv_tpu_torch/csrc/decode_attention.cu",
             "rlaifv_tpu/ops/decode_attention.py:59", launches["decode"],
             kern["decode"]["max_abs_err"], kern["decode"]),
        _row("fused_head_fwd", head_src, "rlaifv_tpu/ops/fused_head.py:128,157",
             launches["head_fwd"], head["fwd_err"], head["fwd"]["train step"]),
        _row("fused_head_dx", head_src, "rlaifv_tpu/ops/fused_head.py:318",
             launches["head_dx"], head["dx_err"], head["dx"]["train step"]),
        _row("fused_head_dw", head_src, "rlaifv_tpu/ops/fused_head.py:334",
             launches["head_dw"], head["dw_err"], head["dw"]["train step"]),
    ]
    # rows 7-10 at the shapes of phase 9 that launch them: the short step's
    # suffix (#7, #8) and the 8-pair step's prefix (#9, #10), gate/up widths
    q_src, q_py = "rlaifv_tpu_torch/csrc/quant_matmul.cu", "rlaifv_tpu/ops/quant_matmul.py"
    small, large = int8[(qb["m_short"], 4096, 11008)], int8[(qb["m_prefix"], 4096, 11008)]
    kernels += [
        _row("int8_matmul", q_src, f"{q_py}:36", launches["int8"], int8["err"], small[7]),
        _row("int8_matmul_dx", q_src, f"{q_py}:132", launches["int8_dx"], int8["err"],
             small[8]),
        _row("int8_matmul_prequant", q_src, f"{q_py}:244", launches["int8_prequant"],
             int8["err"], large[9]),
        _row("int8_matmul_dx_prequant", q_src, f"{q_py}:340",
             launches["int8_dx_prequant"], int8["err"], large[10]),
    ]
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _profile_steps(step, batch, label: str, extra: str) -> None:
    """torch.profiler over two steps after one warm-up step: wall and device
    time a step, the device's idle share, the kernels with the most device
    time and every kernel whose name holds `extra`."""
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 2 * 1e3
    # device-side events only (kernels, copies, sets): an operator's own row
    # repeats the time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    device = sum(dev(e) for e in kernels) / 2 / 1e3
    log(f"[profile] {label}: {wall:.1f} ms a step wall (profiled), {device:.1f} "
        f"ms of device time ({1 - device / wall:.1%} idle), {len(kernels)} kernel names")
    top = sorted(kernels, key=dev, reverse=True)
    for e in top[:20] + [e for e in top[20:] if extra in e.key]:
        log(f"[profile]   {dev(e) / 2 / 1e3:8.2f} ms  x{e.count // 2:<5d} {e.key[:90]}")


def _profile_setup():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(1)
    phase_environment()
    phase_build()
    image_bytes = (ROOT / "examples" / "test.jpeg").read_bytes()
    return LlavaConfig.llava15_7b(), _fake_tokenizer(), image_bytes, synth_rows(image_bytes)


def profile_train() -> None:
    """`python3 chip_smoke.py --profile-train`: a one-off breakdown of the
    7B train step, not part of the smoke run. torch.profiler over two steps
    with the fused head and two with the "xla" head on phase 6's pair (the
    first row of phase 8's rows; zero reference logps, since only time is
    read), each after one warm-up step."""
    cfg, tok, _, rows = _profile_setup()
    pair = collate_train_pair(preference_items(rows, tok, cfg), tok, cfg)
    for key in ("ref_win_logp", "ref_rej_logp"):
        pair["batch_np"][key] = np.zeros(1, np.float32)
    tr = build_train(pair, build_model(LlavaConfig.llava15_7b(remat=True)))
    t = tr["training"]
    optimizer = make_optimizer(tr["model"], TRAIN_LR, total_steps=t.max_steps,
                               warmup_ratio=0.0, weight_decay=t.weight_decay,
                               max_grad_norm=t.max_grad_norm, schedule="constant")
    for head in ("fused", "xla"):
        step = make_dpo_train_step(tr["adapter"], optimizer,
                                   dataclasses.replace(tr["hp"], lm_head_impl=head))
        _profile_steps(step, tr["batch"], f"head {head}", "fused_head")


def profile_qlora() -> None:
    """`python3 chip_smoke.py --profile-qlora`: the same breakdown of phase
    9's QLoRA step (8 pairs, int8 base quantised on the card, r 64 adapters,
    the fused head; zero reference logps)."""
    cfg, tok, image_bytes, rows = _profile_setup()
    qb = qlora_batches(rows, short_row(image_bytes), tok, cfg)
    t = qb["config"].training
    for key in ("ref_win_logp", "ref_rej_logp"):
        qb["batch_np"][key] = np.zeros(t.per_device_batch_pairs, np.float32)
    model = build_model(LlavaConfig.llava15_7b(remat=True), "profile")
    quantize_llm_int8(model, include_lm_head=False)
    model.train()
    lora = lora_init(torch.Generator(device="cuda").manual_seed(t.seed), model, r=t.lora_r)
    optimizer = make_optimizer(lora, QLORA_LR, total_steps=t.max_steps, warmup_ratio=0.0,
                               weight_decay=t.weight_decay, max_grad_norm=t.max_grad_norm,
                               schedule="constant")
    hp = DPOHparams(beta=t.dpo_beta, lm_head_impl="fused", shared_prefix_len=qb["P"])
    step = make_lora_dpo_train_step(LlavaDPOAdapter(model), optimizer, hp, lora,
                                    lora_alpha=t.lora_alpha)
    _profile_steps(step, batch_to_device(qb["batch_np"], "cuda"), "qlora, 8 pairs", "qmm")


if __name__ == "__main__":
    if "--profile-train" in sys.argv[1:]:
        profile_train()
    elif "--profile-qlora" in sys.argv[1:]:
        profile_qlora()
    else:
        main()
