"""chip_smoke.py phase 3c's "tiny ragged" fused-head case (M 77, H 1024,
V 300, one vocabulary chunk) over several random draws, each through 3c's
own `head_check`: for each draw, the dx error's largest ratio to 3c's
elementwise bound, the dl kernel's entries one bf16 rounding off the plain
dl and their largest ratio to one rounding, the dW kernel's largest ratio
to the bound against dl^T x taken in fp32 from its own dl (3c's gate) and
against the plain dW (not a gate: a flipped dl entry moves it), and where
the worst plain-dW entry lies (its vocabulary row, whether a label hits
it, the plain and kernel values). Within a bound at <= 1.

    python3 tools/head_draws.py [--draws N]

It imports this checkout's chip_smoke.py and builds the kernels; draw i
uses a CUDA generator seeded i.
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=20)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from rlaifv_tpu_torch.ops import fused_head as fh

    cs.phase_environment()
    cs.phase_build()
    M, H, V = 77, 1024, 300
    for seed in range(args.draws):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x, w, y, gr = cs._head_inputs(g, M, H, V)
        r = cs.head_check(x, w, y, gr)
        _, lse = fh.fused_head_fwd_plain(x, w, y)
        _, dw = fh.fused_head_bwd(x, w, y, fh._kernel_fwd(x, w, y)[1], gr)
        _, ref_dw = fh.fused_head_bwd_plain(x, w, y, lse, gr)
        d = (dw[:V].float() - ref_dw.float()).abs()
        allowed = cs.HEAD_GRAD_RTOL * ref_dw.float().abs() + \
            cs.HEAD_GRAD_ATOL * ref_dw.float().abs().max()
        row, col = divmod(int((d / allowed).argmax()), H)
        print(f"[head draws] draw {seed}: dx ratio {r['dx_ratio']:.3f} | dl entries one "
              f"rounding off the plain dl {r['dl_flips']} of {M * V}, worst at "
              f"{r['dl_ratio']:.3f} of one rounding | dW against dl^T x from its own dl: "
              f"ratio {r['dw_ratio']:.3f} (max|d| {r['dw_err']:.3e}); against the plain dW "
              f"{r['dw_plain_ratio']:.3f} | worst plain-dW entry: vocabulary row {row} (a "
              f"label row: {bool((y == row).any())}), plain {ref_dw[row, col].item():.4f}, "
              f"kernel {dw[row, col].item():.4f} | {'ok' if r['ok'] else 'FAIL'}", flush=True)


if __name__ == "__main__":
    main()
