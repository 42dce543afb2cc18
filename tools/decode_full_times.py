"""Device times of kernel #6 (single-query attention over the whole cache,
`rlaifv_tpu_torch.ops.decode_attention.decode_attention`) at chip_smoke.py's
phase 3h timed shapes, beside torch's scaled_dot_product_attention on the
same inputs (KV heads repeated to H beforehand, the repeat not timed), for
the tree at ROOT (default: this checkout).

Prints one line a shape, tagged with ROOT's directory name: #6 in ms and
GB/s against the byte bound at 3.35 TB/s, the key splits ROOT plans (where
it plans any), SDPA's ms. The shapes are 3h's: batch 24 (B 24, L 1024,
H = KVH = 32, D 128) and Llama3-8B's GQA step (B 8, L 2304, H 32, KVH 8),
both bf16 with 7 b columns of left padding in row b, as chip_smoke.py makes
them. Times are medians of CUDA-event launches behind a spin kernel, as
chip_smoke.py times.

Each process imports ROOT's chip_smoke.py and rlaifv_tpu_torch, so ROOT
may be an unpacked `git archive` of another commit; run two trees in one
call, in the order A, B, B, A, to compare them on one card:

    python3 tools/decode_full_times.py [ROOT]
"""
import argparse
import sys
from pathlib import Path

# chip_smoke.py's timed 3h cases, kept here because a parent tree's
# chip_smoke.py names them in its own list
CASES = [
    dict(name="batch 24", B=24, L=1024, H=32, KVH=32, D=128, fp32=False),
    dict(name="Llama3 GQA", B=8, L=2304, H=32, KVH=8, D=128, fp32=False),
]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from rlaifv_tpu_torch.ops import decode_attention as da

    if not torch.cuda.is_available():
        sys.exit("decode_full_times: no CUDA device")
    tag = f"[decode full times] {root.name}"
    plan = getattr(da, "full_plan", None)
    g = torch.Generator(device="cuda").manual_seed(0)
    for c in CASES:
        q, k, v, mask = cs._full_inputs(g, c)
        out = da.decode_attention(q, k, v, mask)
        ref = da.decode_attention_ref(q, k, v, mask)
        torch.cuda.synchronize()
        err, ratio = cs._full_ratio(out, ref)
        t = cs.time_ms(lambda: da.decode_attention(q, k, v, mask))
        n_rep = c["H"] // c["KVH"]
        kr, vr = (x.repeat_interleave(n_rep, dim=2) for x in (k, v))
        keep = (mask != 0)[:, None, None, :]
        t_lib = cs.time_ms(lambda: cs.sdpa(q[:, None], kr, vr, keep))
        nbytes = cs._nbytes(q, k, v, mask, out)
        bound = nbytes / (cs.HBM_PEAK_GBPS * 1e9) * 1e3
        splits = (f", {plan(c['B'], c['KVH'], c['L'], cs.qm._sms(0), c['H'] // c['KVH'])} key "
                  "splits" if plan else "")
        print(f"{tag} #6 {c['name']}: B={c['B']} L={c['L']} H={c['H']} KVH={c['KVH']} "
              f"D={c['D']} bf16{splits}: {t:.4f} ms = {nbytes / t / 1e6:.0f} GB/s, bound "
              f"{bound:.4f} ms ({bound / t:.1%}); SDPA {t_lib:.4f} ms; error {ratio:.3f} of "
              f"3h's bound", flush=True)
        del q, k, v, mask, kr, vr, out, ref
        torch.cuda.empty_cache()
    print(f"{tag} {cs.nvidia_smi()} done", flush=True)


if __name__ == "__main__":
    main()
