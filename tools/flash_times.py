"""Device times of the flash-attention kernels #1 (forward), #2 (dq) and #3
(dk/dv) at chip_smoke.py's phase 3 and 3b shapes, then chip_smoke.py's
phases 4 (autocheck and generation on LLaVA-1.5-7B) and 6 (the full
fine-tune step, after phase 8's reference logps), for the tree at ROOT
(default: this checkout).

Prints one line a measurement, each tagged with ROOT's directory name:

- #1 at phase 3's three cases (the autocheck prefix, GQA B 2 L 1024, the
  bidirectional D 64 tower) and #1, #2 and #3 at phase 3b's eight (five
  fixed train shapes and the three calls of phase 6's collated pair), each
  on the inputs chip_smoke.py makes for it; medians of CUDA-event launches
  behind a spin kernel, as chip_smoke.py times;
- phases 4, 8 and 6 as chip_smoke.py runs them (their own log lines:
  facts/s and tok/s, pairs/s, step seconds, peak device memory), unless
  --kernels-only.

Each process imports ROOT's chip_smoke.py and rlaifv_tpu_torch, so ROOT
may be an unpacked `git archive` of another commit; run two trees in one
call, in the order A, B, B, A, to compare them on one card:

    python3 tools/flash_times.py [ROOT] [--kernels-only]
"""
import argparse
import gc
import sys
from pathlib import Path

# chip_smoke.py's phase 3 cases (FLASH_FWD_CASES), kept here because a
# parent tree's chip_smoke.py may not define them
FWD_CASES = [
    dict(name="autocheck prefix", B=1, L=740, H=32, KVH=32, D=128, causal=True, masked=20),
    dict(name="gqa", B=2, L=1024, H=32, KVH=8, D=128, causal=True, masked=0),
    dict(name="bidirectional", B=1, L=577, H=16, KVH=16, D=64, causal=False, masked=0),
]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the three kernels and skip phases 4, 8 and 6")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from rlaifv_tpu_torch.ops.flash_attention import flash_attention

    cfg, tok, image_bytes, rows = cs._profile_setup()
    tag = f"[flash times] {root.name}"
    g = torch.Generator(device="cuda").manual_seed(0)
    for c in FWD_CASES:
        B, L, H, KVH, D = c["B"], c["L"], c["H"], c["KVH"], c["D"]
        q, k, v = cs._randn(g, B, L, H, D), cs._randn(g, B, L, KVH, D), cs._randn(g, B, L, KVH, D)
        mask = torch.ones((B, L), dtype=torch.int32, device="cuda")
        mask[:, :c["masked"]] = 0
        if c["name"] == "gqa":
            mask[1, -100:] = 0
        t = cs.time_ms(lambda: flash_attention(q, k, v, attention_mask=mask,
                                               causal=c["causal"]))
        print(f"{tag} #1 {c['name']}: B={B} L={L} H={H} KVH={KVH} D={D} "
              f"causal={c['causal']}: {t:.4f} ms", flush=True)
    pair = cs.collate_train_pair(cs.preference_items(rows, tok, cfg), tok, cfg)
    H, D = 32, 128
    for c in cs._bwd_cases(pair):
        mask, Lq, KVH, off = c["mask"], c["Lq"], c["KVH"], c["off"]
        B, Lk = mask.shape
        q, k, v = cs._randn(g, B, Lq, H, D), cs._randn(g, B, Lk, KVH, D), cs._randn(g, B, Lk, KVH, D)
        do = cs._randn(g, B, Lq, H, D)
        out, lse = flash_attention(q, k, v, attention_mask=mask, q_offset=off, return_lse=True)
        kargs = (q, k, v, mask, do, lse, cs.bwd_delta(out, do), True, off)
        t_f = cs.time_ms(lambda: flash_attention(q, k, v, attention_mask=mask, q_offset=off))
        t_dq = cs.time_ms(lambda: cs._kernel_bwd_dq(*kargs))
        t_dkv = cs.time_ms(lambda: cs._kernel_bwd_dkv(*kargs))
        print(f"{tag} 3b {c['name']}: B={B} Lq={Lq} Lk={Lk} KVH={KVH} q_offset={off}: "
              f"#1 {t_f:.4f} ms, #2 {t_dq:.4f} ms, #3 {t_dkv:.4f} ms", flush=True)
        del q, k, v, do, out, lse, kargs
    torch.cuda.empty_cache()
    if args.kernels_only:
        print(f"{tag} done", flush=True)
        return

    model = cs.LlavaForCausalLM(cfg, device="meta").to_empty(device="cuda")
    cs.init_weights_(model, torch.Generator(device="cuda").manual_seed(0)).eval()
    gen = cs.Llava15Generator(model, tok, cfg.num_image_tokens,
                              image_size=cfg.vision.image_size,
                              checkpoint_name="random-llava15-7b")
    cs.timed("4 slice", cs.phase_slice, gen, image_bytes)
    del gen, model
    gc.collect()
    torch.cuda.empty_cache()
    model = cs.build_model(cs.LlavaConfig.llava15_7b(remat=True))
    ref_logps, _ = cs.timed("8 ref-logp", cs.phase_ref_logp, model, tok, rows, cfg)
    train_pair = cs.collate_train_pair(cs.preference_items(rows, tok, cfg, ref_logps), tok, cfg)
    cs.timed("6 train", cs.phase_train, cs.build_train(train_pair, model))
    print(f"{tag} done", flush=True)


if __name__ == "__main__":
    main()
