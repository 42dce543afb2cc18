"""Wall time of chip_smoke.py phase 9's QLoRA short step, cold and warm,
and what kernel #8 costs in it, for the tree at ROOT (default: this
checkout).

The short step is one preference pair whose suffix (64 projection rows,
under INT8_DEQUANT_MIN_M) runs kernels #7 and #8 on an int8 base:
LLaVA-1.5-7B at full width and depth, random weights from seed 0, r 64
adapters, the fused head, zero reference logps (only time is read). The
script prints, on one line each:

- the wall seconds of a cold step (as phase 9 times it), then of --pairs
  pairs of warm steps in one process: one with #8 for the suffix's dx,
  one with the dx taken by the prequant route instead (rows quantised in
  torch, then #10), code that is the same in both trees. The difference
  between the two medians is #8's cost in the step beside that common
  route, whatever the host's speed in that process;
- one warm step under torch.profiler: its wall and device time and every
  kernel whose name holds "qmm" or "qdx" (#7-#10), count and device ms;
- one #8 call at the step's widest shape (M 64, K 4096, N 11008): its
  device ms (CUDA events behind a spin kernel, as chip_smoke times) and
  its host microseconds (200 calls issued while a spin kernel holds the
  card).

Each process imports ROOT's chip_smoke.py and rlaifv_tpu_torch, so ROOT
may be an unpacked `git archive` of another commit; run two trees in one
call, in the order A, B, B, A, to compare them on one card:

    python3 tools/short_step.py [ROOT] [--pairs N]
"""
import argparse
import statistics
import sys
import time
from pathlib import Path


def _device_us(e) -> float:
    """A profiler row's own device microseconds (the attribute's name
    differs between torch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    cfg, tok, image_bytes, rows = cs._profile_setup()
    tag = f"[short step] {root.name}"
    qb = cs.qlora_batches(rows, cs.short_row(image_bytes), tok, cfg)
    t = qb["config"].training
    for key in ("ref_win_logp", "ref_rej_logp"):
        qb["short_np"][key] = np.zeros(1, np.float32)
    model = cs.build_model(cs.LlavaConfig.llava15_7b(remat=True), "short step")
    cs.quantize_llm_int8(model, include_lm_head=False)
    model.train()
    lora = cs.lora_init(torch.Generator(device="cuda").manual_seed(t.seed), model, r=t.lora_r)
    optimizer = cs.make_optimizer(lora, cs.QLORA_LR, total_steps=t.max_steps, warmup_ratio=0.0,
                                  weight_decay=t.weight_decay, max_grad_norm=t.max_grad_norm,
                                  schedule="constant")
    hp = cs.DPOHparams(beta=t.dpo_beta, dpo_use_average=t.dpo_use_average,
                       lm_head_impl="fused", shared_prefix_len=qb["Ps"],
                       shared_suffix_len=qb["W"])
    step = cs.make_lora_dpo_train_step(cs.LlavaDPOAdapter(model), optimizer, hp, lora,
                                       lora_alpha=t.lora_alpha)
    batch = cs.batch_to_device(qb["short_np"], "cuda")

    kernel_dx = cs.qm.int8_matmul_dx

    def timed_step(dx_route) -> tuple:
        cs.qm.int8_matmul_dx = dx_route  # the dispatch reads the module's name
        cs.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(batch)["loss"])
        dt = time.perf_counter() - t0
        cs.qm.int8_matmul_dx = kernel_dx
        return dt, cs.read_counts()

    cold, n = timed_step(kernel_dx)
    times = {"#8": [], "#10 route": []}
    counts = {}
    for _ in range(args.pairs):
        for name, route in (("#8", kernel_dx), ("#10 route", cs.qm.int8_matmul_dx_prequant)):
            dt, counts[name] = timed_step(route)
            times[name].append(dt)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"{tag}: {2 * qb['W']} suffix rows | cold step {cold:.4f} s (calls #7 {n['int8']} "
          f"#8 {n['int8_dx']} #9 {n['int8_prequant']} #10 {n['int8_dx_prequant']}) | warm, "
          + " | ".join(f"dx by {k}: " + " ".join(f"{t:.4f}" for t in v)
                       + f" s, median {med[k]:.4f} (calls #8 {counts[k]['int8_dx']} #10 "
                       f"{counts[k]['int8_dx_prequant']})" for k, v in times.items())
          + f" | #8 minus the #10 route: {med['#8'] - med['#10 route']:+.4f} s a step",
          flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(_device_us(e) for e in kernels) / 1e3
    int8 = [e for e in kernels if "qmm" in e.key or "qdx" in e.key]
    print(f"{tag}: one warm step with #8 profiled: {wall * 1e3:.1f} ms wall, {device:.1f} "
          f"ms of device time | " + " | ".join(
              f"{e.key.replace('(anonymous namespace)::', '').split('(')[0][:60]} "
              f"x{e.count} {_device_us(e) / 1e3:.2f} ms" for e in int8), flush=True)

    M, K, N = 2 * qb["W"], 4096, 11008
    g = torch.Generator(device="cuda").manual_seed(0)
    q, s = cs.quantize_kernel_int8_torch(0.02 * torch.randn(K, N, generator=g, device="cuda"))
    dy = cs._randn(g, M, N)
    dev_ms = cs.time_ms(lambda: cs.qm._kernel_dx(dy, q, s))
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(200):
        cs.qm._kernel_dx(dy, q, s)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"{tag}: one #8 call at M={M} K={K} N={N}: {dev_ms:.4f} ms on the card, "
          f"{host_us:.1f} us on the host", flush=True)


if __name__ == "__main__":
    main()
