"""Device times of the split kernels at every split count, beside the count
their plans pick: kernel #7 (`int8_matmul`, its K contraction in slices,
`ops/quant_matmul.py:fwd_plan`) at the decode rows of chip_smoke.py's phase
3d (M 8, 10, 16, 24, 64, 127 at the 7B, fused and Llama3-8B widths), kernel
#6 (`decode_attention`, its key axis in splits,
`ops/decode_attention.py:full_plan`) at phase 3h's timed shapes and at n_rep
8, and kernel #4 (`decode_attention_prefix`, its live keys in splits,
`ops/decode_attention.py:prefix_plan`) at phase 3's shapes and at the bf16
Llama3-8B GQA step's other prefix lengths and batch rows. Each split count's
output is checked against the plain version (#7 bit for bit, #6 within 3h's
bound) or the split twin (#4, within phase 3's bf16 bound); times are medians
of CUDA-event launches behind a spin kernel, as chip_smoke.py times.

Prints one line a shape: the time at each split count, the plan's count
and the fastest, and the byte bound at 3.35 TB/s.

    python3 tools/split_sweep.py [--kernels 4 6 7]
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# M, K, N: phase 11's fused qkv / gate-up and its o / down at the batch-24
# and diverse_gen decode rows, Llama3-8B's widths at 8 rows, the 7B widths
# at 16, 64 and 127 rows
FWD_CASES = [(10, 4096, 12288), (10, 4096, 22016), (24, 4096, 12288), (24, 4096, 22016),
             (24, 4096, 4096), (24, 11008, 4096), (8, 4096, 6144), (8, 4096, 28672),
             (8, 14336, 4096), (16, 4096, 4096), (16, 4096, 11008), (16, 11008, 4096),
             (64, 4096, 4096), (64, 4096, 11008), (64, 11008, 4096), (127, 4096, 11008),
             (127, 11008, 4096)]
FWD_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)
FULL_CASES = [
    dict(name="batch 24", B=24, L=1024, H=32, KVH=32, D=128, fp32=False),
    dict(name="Llama3 GQA", B=8, L=2304, H=32, KVH=8, D=128, fp32=False),
    dict(name="n_rep 8", B=8, L=2304, H=32, KVH=4, D=128, fp32=False),
]
FULL_SPLITS = (1, 2, 3, 4, 6, 8, 12, 18)
# B, L, H, KVH, valid_len: phase 4, batch 24, the bf16 Llama3-8B GQA step at
# its long prefix, two shorter ones and phase 13's short prompts, then fewer
# batch rows
PREFIX_CASES = [(10, 896, 32, 32, 896), (24, 1024, 32, 32, 960), (8, 2304, 32, 8, 2200),
                (8, 2304, 32, 8, 1024), (8, 2304, 32, 8, 700), (8, 512, 32, 8, 384),
                (1, 2304, 32, 8, 2200), (2, 2304, 32, 8, 2200)]
PREFIX_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def sweep_prefix(cs, da, sms: int, g) -> None:
    import torch

    plan_fn = da.prefix_plan
    for B, L, H, KVH, valid in PREFIX_CASES:
        q, k, v = (cs._randn(g, *s) for s in ((B, H, 128), (B, L, KVH, 128), (B, L, KVH, 128)))
        mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
        for b in range(B):
            mask[b, 7 * b:valid] = 1
        args = (q, k, v, mask, valid)
        bound = cs._nbytes(q, k[:, :valid], v[:, :valid], mask[:, :valid], q) / \
            (cs.HBM_PEAK_GBPS * 1e9) * 1e3
        planned = plan_fn(B, KVH, valid, sms, H // KVH)
        times = {}
        try:
            for splits in PREFIX_SPLITS:
                if splits > 1 and (B * KVH * splits > 3 * sms or splits > valid // 64):
                    break
                da.prefix_plan = lambda *a, n=splits: n
                twin = da.decode_attention_prefix_split_ref(*args, splits)
                if cs._full_ratio(da.decode_attention_prefix(*args), twin)[1] > 1:
                    raise AssertionError(f"#4 B={B} valid_len={valid} at {splits} splits "
                                         "breaks phase 3's bound")
                times[splits] = cs.time_ms(lambda: da.decode_attention_prefix(*args))
        finally:
            da.prefix_plan = plan_fn
        best = min(times, key=times.get)
        plan_ms = times.get(planned)
        print(f"[split sweep] #4 B={B} L={L} H={H} KVH={KVH} valid_len={valid}: " +
              " ".join(f"s{k} {v:.4f}" for k, v in times.items()) +
              f" ms | plan s{planned}" +
              (f" {plan_ms:.4f} ms ({bound / plan_ms:.0%} of the byte bound {bound:.4f})"
               if plan_ms else "") + f", fastest s{best} {times[best]:.4f}", flush=True)
        del q, k, v, mask, args
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", type=int, default=[4, 6, 7], choices=[4, 6, 7])
    kernels = ap.parse_args().kernels
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from rlaifv_tpu_torch.ops import decode_attention as da
    from rlaifv_tpu_torch.ops import quant_matmul as qm

    if not torch.cuda.is_available():
        sys.exit("split_sweep: no CUDA device")
    cs.phase_environment()
    cs.phase_build()
    sms = qm._sms(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    if 4 in kernels:
        sweep_prefix(cs, da, sms, g)
    for M, K, N in FWD_CASES if 7 in kernels else []:
        x = cs._randn(g, M, K)
        q, s = cs.quantize_kernel_int8_torch(
            0.02 * torch.randn(K, N, generator=g, device="cuda"))
        want = qm.int8_matmul_plain(x, q, s)
        plan = qm.fwd_plan(M, K, N, sms)
        bound = (cs._nbytes(x, q, s) + 2 * M * N) / (cs.HBM_PEAK_GBPS * 1e9) * 1e3
        times = {}
        for split in FWD_SPLITS:
            if split > -(-K // qm.FWD_TILE):
                break
            p = plan._replace(split=split)
            if not torch.equal(qm._kernel_fwd(x, q, s, p), want):
                raise AssertionError(f"#7 at M={M} K={K} N={N} split {split} differs from "
                                     "its twin")
            times[split] = cs.time_ms(lambda: qm._kernel_fwd(x, q, s, p))
        best = min(times, key=times.get)
        print(f"[split sweep] #7 M={M} K={K} N={N}: " +
              " ".join(f"s{k} {v:.4f}" for k, v in times.items()) +
              f" ms | plan s{plan.split} {times[plan.split]:.4f} ms "
              f"({bound / times[plan.split]:.0%} of the byte bound {bound:.4f}), fastest "
              f"s{best} {times[best]:.4f}", flush=True)
        del x, q, s, want
    torch.cuda.empty_cache()
    plan_fn = da.full_plan
    for c in FULL_CASES if 6 in kernels else []:
        args = cs._full_inputs(g, c)
        ref = da.decode_attention_ref(*args)
        bound = cs._nbytes(*args, ref) / (cs.HBM_PEAK_GBPS * 1e9) * 1e3
        planned = plan_fn(c["B"], c["KVH"], c["L"], sms, c["H"] // c["KVH"])
        times = {}
        try:
            for splits in FULL_SPLITS:
                if splits > 1 and splits * da.FULL_MIN_KEYS > c["L"]:
                    break
                da.full_plan = lambda *a, n=splits: n
                _, ratio = cs._full_ratio(da.decode_attention(*args), ref)
                if ratio > 1:
                    raise AssertionError(f"#6 {c['name']} at {splits} splits breaks 3h's bound")
                times[splits] = cs.time_ms(lambda: da.decode_attention(*args))
        finally:
            da.full_plan = plan_fn
        best = min(times, key=times.get)
        plan_ms = times.get(planned)
        print(f"[split sweep] #6 {c['name']} B={c['B']} L={c['L']} H={c['H']} KVH={c['KVH']}: " +
              " ".join(f"s{k} {v:.4f}" for k, v in times.items()) +
              f" ms | plan s{planned}" +
              (f" {plan_ms:.4f} ms ({bound / plan_ms:.0%} of the byte bound {bound:.4f})"
               if plan_ms else "") + f", fastest s{best} {times[best]:.4f}", flush=True)
        del args, ref
        torch.cuda.empty_cache()
    print(f"[split sweep] {cs.nvidia_smi()} done", flush=True)


if __name__ == "__main__":
    main()
