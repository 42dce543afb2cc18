"""Device times of the fused head's forward (kernels #13/#14) and of kernel
#11 at chip_smoke.py's shapes, then chip_smoke.py's phases 8 (ref-logp) and
10 (the int4 QLoRA step), for the tree at ROOT (default: this checkout).

Prints one line a measurement, each tagged with ROOT's directory name:

- the head forward (`_kernel_fwd`, both kernels of a call) at 3c's three
  timed cases: the train step (M 2046, H 4096, V 32000), the ref-logp
  fallback (M 16363) and H 1024; medians of CUDA-event launches behind a
  spin kernel, as chip_smoke times;
- #11 (`int4_matmul._kernel_fwd` on rows quantised beforehand) at 3e's
  shapes: the 7B widths (4096 x 4096, 4096 x 11008, 11008 x 4096) at M 16,
  64, 127, 128 and the 8-pair step's suffix and prefix rows, and Llama3-8B's
  widths at its decode and divide-batch rows;
- phases 8 and 10 as chip_smoke.py runs them (their own log lines: pairs/s,
  step seconds, peak device memory).

Each process imports ROOT's chip_smoke.py and rlaifv_tpu_torch, so ROOT
may be an unpacked `git archive` of another commit; run two trees in one
call, in the order A, B, B, A, to compare them on one card:

    python3 tools/forward_times.py [ROOT]
"""
import argparse
import gc
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs

    cfg, tok, image_bytes, rows = cs._profile_setup()
    tag = f"[forward times] {root.name}"
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, M, H in (("train step", 2046, 4096), ("ref-logp fallback", 16 * 1023 - 5, 4096),
                       ("small H (row 13)", 2046, 1024)):
        x, w, y, _ = cs._head_inputs(g, M, H, 32000)
        t = cs.time_ms(lambda: cs._kernel_fwd(x, w, y), 10 if M > 4096 else 20)
        print(f"{tag} head forward, {name}: M={M} H={H} V=32000: {t:.4f} ms", flush=True)
        del x, w, y
    qb = cs.qlora_batches(rows, cs.short_row(image_bytes), tok, cfg)
    ms = sorted({16, 64, 127, 128, qb["m_suffix"], qb["m_prefix"]})
    widths = [(K, N, ms) for K, N in ((4096, 4096), (4096, 11008), (11008, 4096))]
    widths += [(K, N, cs.llama3_ms()) for K, N in cs.LLAMA3_WIDTHS]
    for K, N, mrows in widths:
        qp, gs = cs.quantize_int4_torch(0.02 * torch.randn(K, N, generator=g, device="cuda"))
        for M in mrows:
            xq, sx = cs.qm.quantize_rows(cs._randn(g, M, K).float())
            sx = sx.reshape(-1)
            t = cs.time_ms(lambda: cs.i4._kernel_fwd(xq, sx, qp, gs))
            print(f"{tag} #11 M={M} K={K} N={N}: {t:.4f} ms", flush=True)
        del qp, gs
    torch.cuda.empty_cache()

    model = cs.build_model(cs.LlavaConfig.llava15_7b(remat=True))
    ref_logps, _ = cs.timed("8 ref-logp", cs.phase_ref_logp, model, tok, rows, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = cs.build_model(cs.LlavaConfig.llava15_7b(remat=True), "10 int4")
    cs.timed("10 int4", cs.phase_qlora_int4, model, tok, rows, cfg, ref_logps)
    print(f"{tag} done", flush=True)


if __name__ == "__main__":
    main()
