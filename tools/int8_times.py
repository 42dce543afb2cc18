"""Device times of the prequantised int8 kernels #9 (forward) and #10 (dx)
at chip_smoke.py's phase 3d shapes, beside torch._int_mm on the same int8
operands, then chip_smoke.py's phases 8 (ref-logp) and 9 (the int8 QLoRA
steps), for the tree at ROOT (default: this checkout).

Prints one line a shape, tagged with ROOT's directory name: #9 and #10 in
ms and TOP/s, #10's route where ROOT's quant_matmul plans one, and
torch._int_mm (cuBLASLt, int8 x int8 -> int32, the product only: no
scales, no rounding) for the forward's and the dx's operands. The shapes
are 3d's: the 7B widths (4096 x 4096, 4096 x 11008, 11008 x 4096) at M 16,
64, 127, 128 and phase 9's short, suffix and prefix rows; the fused widths
at phase 11's decode and prefill rows; Llama3-8B's widths at phase 13's
rows. Times are medians of CUDA-event launches behind a spin kernel, as
chip_smoke.py times. Then phases 8 and 9 as chip_smoke.py runs them (their
own log lines: pairs/s, step seconds, peak device memory), unless
--kernels-only.

Each process imports ROOT's chip_smoke.py and rlaifv_tpu_torch, so ROOT
may be an unpacked `git archive` of another commit; run two trees in one
call, in the order A, B, B, A, to compare them on one card:

    python3 tools/int8_times.py [ROOT] [--kernels-only]
"""
import argparse
import gc
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the two kernels and skip phases 8 and 9")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs

    cfg, tok, image_bytes, rows = cs._profile_setup()
    qb = cs.qlora_batches(rows, cs.short_row(image_bytes), tok, cfg)
    tag = f"[int8 times] {root.name}"
    ms = sorted({16, 64, 127, 128, qb["m_short"], qb["m_suffix"], qb["m_prefix"]})
    cases = [(K, N, M) for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)) for M in ms]
    cases += [(K, N, M) for K, N in cs.FUSED_WIDTHS for M in cs.FUSED_MS]
    cases += [(K, N, M) for K, N in cs.LLAMA3_WIDTHS for M in cs.llama3_ms()]
    plan = getattr(cs.qm, "dx_prequant_plan", None)
    g = torch.Generator(device="cuda").manual_seed(0)
    for K, N, M in cases:
        q, s = cs.quantize_kernel_int8_torch(
            0.02 * torch.randn(K, N, generator=g, device="cuda"))
        xq, sx = cs.qm.quantize_rows(cs._randn(g, M, K).float())
        dyq, sy = cs.qm.quantize_rows(cs._randn(g, M, N).float() * s)
        sx, sy = sx.reshape(-1), sy.reshape(-1)
        t9 = cs.time_ms(lambda: cs.qm._kernel_prequant(xq, sx, q, s))
        t10 = cs.time_ms(lambda: cs.qm._kernel_dx_prequant(dyq, sy, q))
        lib = [cs.int_mm_ms(a, b, tag) for a, b in ((xq, q), (dyq, q.T))]
        route = ""
        if plan is not None:
            p = plan(M, K, N, cs.qm._sms(0))
            route = f" ({p.route}, {p.tile[0]} x {p.tile[1]}, {p.split} slices)"
        ops = 2 * M * K * N
        lib_text = " ".join("refused" if t is None else f"{t:.4f}" for t in lib)
        print(f"{tag} M={M} K={K} N={N}: #9 {t9:.4f} ms = {ops / t9 / 1e9:.0f} TOP/s, "
              f"#10 {t10:.4f} ms = {ops / t10 / 1e9:.0f} TOP/s{route} | torch._int_mm "
              f"fwd dx {lib_text} ms", flush=True)
        del q, s, xq, dyq
        torch.cuda.empty_cache()
    if not args.kernels_only:
        model = cs.build_model(cs.LlavaConfig.llava15_7b(remat=True))
        ref_logps, _ = cs.timed("8 ref-logp", cs.phase_ref_logp, model, tok, rows, cfg)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model = cs.build_model(cs.LlavaConfig.llava15_7b(remat=True), "9 qlora")
        cs.timed("9 qlora", cs.phase_qlora, model, tok, rows, cs.short_row(image_bytes), cfg,
                 ref_logps)
    print(f"{tag} {cs.nvidia_smi()} done", flush=True)


if __name__ == "__main__":
    main()
