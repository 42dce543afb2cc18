"""Where kernel #9's time goes: broken copies of csrc/quant_matmul.cu, each
with one part of the wide tile (qpre::fwd_wide) taken out or changed, timed
beside the sound kernel on the same inputs (the 8-pair QLoRA step's prefix
rows at the gate/up and down widths).

Each variant is built with chip_smoke.build_variants (a copy of the source
with exact text edits) and run through the same wrapper; the outputs of
the parts taken out are wrong, and only the times are read (the variants
that change no arithmetic are also checked bit for bit against the twin).
Medians of CUDA-event launches behind a spin kernel, as chip_smoke times;
the sound kernel runs first and last. Needs the card and nvcc:

    python3 tools/prequant_ablate.py
"""
import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = {  # name: (edits, whether the output stays the twin's)
    "no A loads (fragments from a constant)": ([(
        "quant_matmul.cu",
        "v[i] = ld32(qs + k * 128 + (((qchunk ^ (4 * (t & 1) + r)) << 4) | qbyte));",
        "v[i] = k * 0x01010101u;")], False),
    "no 4 x 4 byte transposes": ([(
        "quant_matmul.cu", "transpose4x4(w, o);  // o[j] byte r: q[row 32 kk",
        "o[0] = w[0]; o[1] = w[1]; o[2] = w[2]; o[3] = w[3];  // o[j] byte r: q[row 32 kk")],
        False),
    "one K step a fragment set, four sets": ([
        ("quant_matmul.cu", "constexpr int KS = 2;", "constexpr int KS = 1;"),
        ("quant_matmul.cu", "constexpr int NBUF = 2;", "constexpr int NBUF = 4;")], True),
    "a whole stage a fragment set, one set (the warpgroups alternate)": ([
        ("quant_matmul.cu", "constexpr int KS = 2;", "constexpr int KS = 4;"),
        ("quant_matmul.cu", "constexpr int NBUF = 2;", "constexpr int NBUF = 1;"),
        ("quant_matmul.cu", "wgmma_wait<NBUF - 1>();  // the set NBUF - 1",
         "wgmma_wait<0>();  // the set NBUF - 1"),
        ("quant_matmul.cu", "if (set == NBUF - 2 && c > 0) release(c - 1);",
         "if (set == 0 && c > 0) release(c - 1);")], True),
}


def main() -> None:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("prequant_ablate: no CUDA device")
    print(f"nvidia-smi: {cs.nvidia_smi()}", flush=True)
    cs.phase_build()
    libs = cs.build_variants({name: edits for name, (edits, _) in VARIANTS.items()})
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for K, N in ((4096, 11008), (11008, 4096)):
        q, s = cs.quantize_kernel_int8_torch(0.02 * torch.randn(K, N, generator=g, device="cuda"))
        x = cs._randn(g, 6144, K)
        xq, sx = cs.qm.quantize_rows(x.float())
        cases.append((K, N, xq, sx.reshape(-1), q, s, cs.qm.int8_matmul_plain(x, q, s)))
    for name, lib in [("sound", None), *libs.items(), ("sound, again", None)]:
        exact = VARIANTS[name][1] if name in VARIANTS else True
        with cs.kernels_from(lib) if lib is not None else contextlib.nullcontext():
            for K, N, xq, sx, q, s, want in cases:
                if exact:
                    got = cs.qm._kernel_prequant(xq, sx, q, s)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"#9 ablation {name!r} departs from the twin")
                t = cs.time_ms(lambda: cs.qm._kernel_prequant(xq, sx, q, s))
                print(f"[#9 ablation] {name}: M=6144 K={K} N={N}: {t:.4f} ms "
                      f"({2 * 6144 * K * N / t / 1e9:.0f} TOP/s)"
                      + (", equal to the twin" if exact else ""), flush=True)


if __name__ == "__main__":
    main()
