"""Device times of the int8 kernels #7 (forward, rows quantised in the
kernel) below 128 rows, #9 (forward on prequantised rows) and #10 (its dx)
at chip_smoke.py's phase 3d shapes, beside torch._int_mm on the same int8
operands, and of the whole int8_matmul_prequant call (its row quantisation
and #9); then phase 11's eager int8-KV serving step and headline; then
chip_smoke.py's phases 8 (ref-logp) and 9 (the int8 QLoRA steps), for the
tree at ROOT (default: this checkout).

Prints one line a shape, tagged with ROOT's directory name: #7 (below 128
rows, with its route where ROOT's quant_matmul plans one), #9 and #10 in ms
and TOP/s, #9's and #10's routes where ROOT plans them (and #9's cp.async
route beside its plan's, where ROOT can be given a plan), the whole
int8_matmul_prequant call (the rows quantised as ROOT quantises them, then
#9), and torch._int_mm (cuBLASLt,
int8 x int8 -> int32, the product only: no scales, no rounding) for the
forward's and the dx's operands, on the rows zero-padded to 32 where it
refuses 16 or fewer. The shapes are 3d's: the 7B widths (4096 x 4096, 4096
x 11008, 11008 x 4096) at M 16, 64, 127, 128 and phase 9's short, suffix
and prefix rows; the fused widths at phase 11's decode and prefill rows;
Llama3-8B's widths at phase 13's rows. Times are medians of CUDA-event
launches behind a spin kernel, as chip_smoke.py times. Then phase 11's
model (LLaVA-1.5-7B, random weights from seed 0, quantised in place to
int8 with the head bf16, q/k/v and gate/up fused, an int8 KV cache): the
batch-24 headline generate, its tok/s as phase 11 logs them and the eager
decode step they give (the 64-token run less the 1-token run, over its
decode steps).
Then phases 8 and 9 as chip_smoke.py runs them (their own log lines:
pairs/s, step seconds, peak device memory). --kernels-only stops after the
kernels.

Each process imports ROOT's chip_smoke.py and rlaifv_tpu_torch, so ROOT
may be an unpacked `git archive` of another commit; run two trees in one
call, in the order A, B, B, A, to compare them on one card:

    python3 tools/int8_times.py [ROOT] [--kernels-only]
"""
import argparse
import gc
import sys
from pathlib import Path


def serving(cs, tag: str, tok, image_bytes: bytes) -> None:
    """Phase 11's int8-KV model: the batch-24 headline generate and its
    eager decode step."""
    import torch

    cfg = cs.LlavaConfig.llava15_7b()
    model = cs.LlavaForCausalLM(cfg, device="meta").to_empty(device="cuda")
    cs.init_weights_(model, torch.Generator(device="cuda").manual_seed(0)).eval()
    gen = cs.Llava15Generator(model, tok, cfg.num_image_tokens,
                              image_size=cfg.vision.image_size,
                              checkpoint_name="random-llava15-7b")
    cs.quantize_llm_int8(gen.model, include_lm_head=False)
    cs.set_llm_config(cs.fuse_llm_projections_(gen.model), kv_cache_dtype="int8")
    gc.collect()
    torch.cuda.empty_cache()
    launches, rates = cs.phase_headline(gen, cs._headline_items(gen, image_bytes),
                                        f"{tag} 11 int8-kv headline", "decode_int8")
    step = (rates["total_s"] - rates["prefill_s"]) / rates["steps"] * 1e3
    print(f"{tag} 11 int8-kv headline: {rates['tok_s']:.2f} tok/s, decode alone "
          f"{rates['decode_tok_s']:.2f} tok/s = {step:.2f} ms an eager batch-24 decode step; "
          f"#7 {launches['int8']} and #9 {launches['int8_prequant']} launches", flush=True)
    del gen, model
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels; skip the serving step and phases 8 and 9")
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
    fplan = getattr(cs.qm, "fwd_plan", None)
    pplan = getattr(cs.qm, "fwd_prequant_plan", None)
    g = torch.Generator(device="cuda").manual_seed(0)
    for K, N, M in cases:
        q, s = cs.quantize_kernel_int8_torch(
            0.02 * torch.randn(K, N, generator=g, device="cuda"))
        x = cs._randn(g, M, K)
        xq, sx = cs.qm.quantize_rows(x.float())
        dyq, sy = cs.qm.quantize_rows(cs._randn(g, M, N).float() * s)
        sx, sy = sx.reshape(-1), sy.reshape(-1)
        ops = 2 * M * K * N
        fwd = ""
        if M < 128:
            t7 = cs.time_ms(lambda: cs.qm._kernel_fwd(x, q, s))
            route7 = ""
            if fplan is not None:
                p = fplan(M, K, N, cs.qm._sms(0))
                route7 = f" ({p.route}, {p.tile[0]} x {p.tile[1]}, {p.split} K slices)"
            nbytes = cs._nbytes(x, q, s) + 2 * M * N
            fwd = (f"#7 {t7:.4f} ms = {nbytes / t7 / 1e6:.0f} GB/s of {cs.HBM_PEAK_GBPS:.0f}"
                   f"{route7}, ")
        t9 = cs.time_ms(lambda: cs.qm._kernel_prequant(xq, sx, q, s))
        t_call = cs.time_ms(lambda: cs.qm.int8_matmul_prequant(x, q, s))
        route9 = ""
        if pplan is not None:
            p9 = pplan(M, K, N, cs.qm._sms(0))
            t9_rows = cs.time_ms(lambda: cs.qm._kernel_prequant(
                xq, sx, q, s, cs.qm.FwdPlan("rows", (128, 128), 1, 1)))
            route9 = f" ({p9.route}; the cp.async route {t9_rows:.4f} ms)"
        t10 = cs.time_ms(lambda: cs.qm._kernel_dx_prequant(dyq, sy, q))
        lib = [cs.int_mm_ms(a, b, tag) for a, b in ((xq, q), (dyq, q.T))]
        if lib[0] is None:
            pad = torch.zeros((32, K), dtype=torch.int8, device="cuda")
            pad[:M] = xq
            t_pad = cs.time_ms(lambda: torch._int_mm(pad, q))
            lib[0] = f"refused ({t_pad:.4f} on the rows zero-padded to 32)"
        route = ""
        if plan is not None:
            p = plan(M, K, N, cs.qm._sms(0))
            route = f" ({p.route}, {p.tile[0]} x {p.tile[1]}, {p.split} slices)"
        lib_text = " ".join(t if isinstance(t, str) else "refused" if t is None else f"{t:.4f}"
                            for t in lib)
        print(f"{tag} M={M} K={K} N={N}: {fwd}#9 {t9:.4f} ms = {ops / t9 / 1e9:.0f} TOP/s"
              f"{route9}, the whole int8_matmul_prequant call {t_call:.4f} ms, "
              f"#10 {t10:.4f} ms = {ops / t10 / 1e9:.0f} TOP/s{route} | torch._int_mm "
              f"fwd dx {lib_text} ms", flush=True)
        del q, s, x, xq, dyq
        torch.cuda.empty_cache()
    if not args.kernels_only:
        serving(cs, tag, tok, image_bytes)
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
