"""Where kernel #11's time goes: broken copies of csrc/int4_matmul.cu, each
with one part of the forward taken out or changed, timed beside the sound
kernel on the same inputs (the 8-pair QLoRA step's prefix rows at the
gate/up and down widths).

Each variant is built with chip_smoke.build_variants (a copy of the source
with exact text edits) and run through the same wrapper; the outputs of
the parts taken out are wrong, and only the times are read. Medians of
CUDA-event launches behind a spin kernel, as chip_smoke times; the sound
kernel runs first and last. Needs the card and nvcc:

    python3 tools/int4_fwd_ablate.py
"""
import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NO_UNPACK = ("int4_matmul.cu",
             "      unpack(ring + s * STAGE_BYTES + P_OFF, bufs + b * U_BYTES, off, c, kb);", "")
NO_RESCALE = ("int4_matmul.cu",
              "      if ((i + 1) % per_group == 0) rescale(sum, acc, st + G_OFF, t);  "
              "// the group's end", "      fence_acc(acc);")
QUARTER = ("int4_matmul.cu",
           "  for (int run = 0; run < 2; ++run)\n#pragma unroll\n    for (int kk = 0; kk < 2; ++kk)",
           "  for (int run = 0; run < 1; ++run)\n#pragma unroll\n    for (int kk = 0; kk < 1; ++kk)")
VARIANTS = {
    "no rescale": [NO_RESCALE],
    "no unpacking": [NO_UNPACK],
    "a quarter of the products": [QUARTER],
    "all three": [NO_RESCALE, NO_UNPACK, QUARTER],
    "2 unpacked tiles, loads 4 steps ahead": [(
        "int4_matmul.cu", "constexpr int NBUF = 3;       // unpacked tiles",
        "constexpr int NBUF = 2;       // unpacked tiles")],
    "no proxy fence before the unpacked tile's release": [(
        "int4_matmul.cu", "      fence_async_smem();\n      __syncwarp();\n      if (lane == 0) {\n"
        "        bar_arrive(ufull", "      __syncwarp();\n      if (lane == 0) {\n"
        "        bar_arrive(ufull")],
}


def main() -> None:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("int4_fwd_ablate: no CUDA device")
    print(f"nvidia-smi: {cs.nvidia_smi()}", flush=True)
    cs.phase_build()
    libs = cs.build_variants(VARIANTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for K, N in ((4096, 11008), (11008, 4096)):
        qp, gs = cs.quantize_int4_torch(0.02 * torch.randn(K, N, generator=g, device="cuda"))
        xq, sx = cs.qm.quantize_rows(cs._randn(g, 6144, K).float())
        cases.append((K, N, xq, sx.reshape(-1), qp, gs))
    for name, lib in [("sound", None), *libs.items(), ("sound, again", None)]:
        with cs.kernels_from(lib) if lib is not None else contextlib.nullcontext():
            for K, N, xq, sx, qp, gs in cases:
                t = cs.time_ms(lambda: cs.i4._kernel_fwd(xq, sx, qp, gs))
                print(f"[#11 ablation] {name}: M=6144 K={K} N={N}: {t:.4f} ms "
                      f"({2 * 6144 * K * N / t / 1e9:.0f} TOP/s)", flush=True)


if __name__ == "__main__":
    main()
