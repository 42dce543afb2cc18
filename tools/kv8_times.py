"""Device times of kernel #5 (prefix decode attention over an int8 cache,
`rlaifv_tpu_torch.ops.decode_attention.decode_attention_prefix_int8`) at
chip_smoke.py's phase 3f timed shapes, beside torch's
scaled_dot_product_attention over the live prefix dequantised to bf16 (KV
heads repeated to H beforehand; the dequantisation and the repeat not
timed), for the tree at ROOT (default: this checkout).

Prints one line a shape, tagged with ROOT's directory name: #5 in ms and
GB/s against the byte bound at 3.35 TB/s (the live prefix's q, k, v,
scales and mask read once, the output written once), the key splits ROOT
plans (where it plans any), SDPA's ms. The shapes are 3f's: diverse_gen (B
10, L = valid_len = 896, block 128), the batch-24 headline (B 24, L 1024,
valid_len 960, block 256), both H = KVH = 32, and the int8 Llama3-8B
backend's GQA step (B 8, H 32, KVH 8, L 2304, valid_len 2200), D 128, with
7 b columns of left padding in row b, as chip_smoke.py makes them. Times
are medians of CUDA-event launches behind a spin kernel, as chip_smoke.py
times.

Each process imports ROOT's chip_smoke.py and rlaifv_tpu_torch, so ROOT
may be an unpacked `git archive` of another commit; run two trees in one
call, in the order A, B, B, A, to compare them on one card:

    python3 tools/kv8_times.py [ROOT]
"""
import argparse
import sys
from pathlib import Path

# chip_smoke.py's timed 3f cases, kept here because a parent tree's
# chip_smoke.py names them in its own list
CASES = [
    dict(name="diverse_gen", B=10, L=896, H=32, KVH=32, D=128, valid=896),
    dict(name="batch-24 headline", B=24, L=1024, H=32, KVH=32, D=128, valid=960),
    dict(name="Llama3 GQA", B=8, L=2304, H=32, KVH=8, D=128, valid=2200),
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
        sys.exit("kv8_times: no CUDA device")
    tag = f"[kv8 times] {root.name}"
    plan = getattr(da, "prefix_int8_plan", None)
    g = torch.Generator(device="cuda").manual_seed(5)
    for c in CASES:
        B, L, H, KVH, D, valid = (c[k] for k in ("B", "L", "H", "KVH", "D", "valid"))
        q, kq, ks, vq, vs, mask = kv = cs._kv8_cache(g, B, L, H, KVH, D, valid)
        out = da.decode_attention_prefix_int8(*kv, valid)
        ref = da.decode_attention_prefix_int8_ref(*kv, valid)
        torch.cuda.synchronize()
        _, ratio = cs._kv8_ratio(out, ref)
        t = cs.time_ms(lambda: da.decode_attention_prefix_int8(*kv, valid))
        live = [x[:, :valid] for x in (kq, ks, vq, vs, mask)]
        kd, vd = (da.dequantize_kv(a, s, torch.bfloat16).repeat_interleave(H // KVH, dim=2)
                  for a, s in ((live[0], live[1]), (live[2], live[3])))
        keep = (live[4] != 0)[:, None, None, :]
        t_lib = cs.time_ms(lambda: cs.sdpa(q[:, None], kd, vd, keep))
        nbytes = cs._nbytes(q, *live, out)
        bound = nbytes / (cs.HBM_PEAK_GBPS * 1e9) * 1e3
        splits = ""
        if plan is not None:
            n_blocks = max(-(-valid // da.prefix_block_l(L)), 1)
            splits = f", {plan(B, KVH, n_blocks, cs.qm._sms(0), H // KVH)} key splits"
        print(f"{tag} #5 {c['name']}: B={B} L={L} valid_len={valid} H={H} KVH={KVH} D={D}"
              f"{splits}: {t:.4f} ms = {nbytes / t / 1e6:.0f} GB/s, bound {bound:.4f} ms "
              f"({bound / t:.1%}); SDPA {t_lib:.4f} ms; error {ratio:.3f} of 3f's bound "
              f"against the sequential twin", flush=True)
        del kv, q, kq, ks, vq, vs, mask, kd, vd, out, ref
        torch.cuda.empty_cache()
    print(f"{tag} {cs.nvidia_smi()} done", flush=True)


if __name__ == "__main__":
    main()
