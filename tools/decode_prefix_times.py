"""Device times of kernel #4 (bf16 prefix decode attention,
`rlaifv_tpu_torch.ops.decode_attention.decode_attention_prefix`) beside its
plain version and torch's scaled_dot_product_attention over the live prefix
(KV heads repeated to H beforehand, the slice and the repeat not timed), for
the tree at ROOT (default: this checkout).

Prints one line a shape, tagged with ROOT's directory name: #4 in ms and
GB/s against the byte bound at 3.35 TB/s (the live prefix's q, k, v and mask
read once, the output written once), the key splits ROOT plans (where it
plans any), the kernels one call launches (the call captured in a CUDA
graph), the plain version's and SDPA's ms, the error against the plain
version in units of chip_smoke.py's bf16 bound, and the host's time a call
(the wrapper's Python and the launches, enqueued behind a spin kernel so the
device never waits for them); then the floor of this way of timing: one
`x.add_(1)` on one element, and #4 over a single 16-key tile (B 8, KVH 8,
valid_len 16). The shapes, all bf16, D 128, 7 b columns of left padding in
row b:

- phase 4: B 10, L = valid_len = 896, H = KVH = 32 (the bf16 serving slice);
- batch 24: B 24, L 1024, valid_len 960, H = KVH = 32 (the bf16 batch-24 run);
- Llama3 GQA: B 8, L 2304, valid_len 2200, H 32, KVH 8 (the bf16 Llama3-8B
  divide-and-conquer backend at a long prefix);
- phase 13 short: B 8, L 512, valid_len 384, H 32, KVH 8 (the same backend
  at phase 13's short prompts).

Times are medians of CUDA-event launches behind a spin kernel, as
chip_smoke.py times. With --phases, then the two eager paths #4 serves:
chip_smoke.py's phase 4 (the bf16 serving slice: autocheck, diverse_gen and
greedy_gen on LLaVA-1.5-7B, random weights) and the bf16 Llama3-8B
backend of phase 13 on two 8-row batches of divide prompts (answers of 500
and 880 characters, phase 13's two prompt lengths), 256 new tokens each:
tok/s with the prefill, decode steps and #4's launches.

Each process imports ROOT's chip_smoke.py and rlaifv_tpu_torch, so ROOT
may be an unpacked `git archive` of another commit; run two trees in one
call, in the order A, B, B, A, to compare them on one card:

    python3 tools/decode_prefix_times.py [ROOT] [--phases]
"""
import argparse
import gc
import sys
import time
from pathlib import Path

CASES = [
    dict(name="phase 4", B=10, L=896, H=32, KVH=32, valid=896),
    dict(name="batch 24", B=24, L=1024, H=32, KVH=32, valid=960),
    dict(name="Llama3 GQA", B=8, L=2304, H=32, KVH=8, valid=2200),
    dict(name="phase 13 short", B=8, L=512, H=32, KVH=8, valid=384),
]
D = 128


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--phases", action="store_true",
                    help="also run phase 4 and the bf16 Llama3-8B backend")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from rlaifv_tpu_torch.ops import decode_attention as da

    if not torch.cuda.is_available():
        sys.exit("decode_prefix_times: no CUDA device")
    tag = f"[decode prefix times] {root.name}"
    plan = getattr(da, "prefix_plan", None)
    g = torch.Generator(device="cuda").manual_seed(18)
    for c in CASES:
        B, L, H, KVH, valid = (c[k] for k in ("B", "L", "H", "KVH", "valid"))
        q, k, v = (torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
                   for s in ((B, H, D), (B, L, KVH, D), (B, L, KVH, D)))
        mask = torch.zeros((B, L), dtype=torch.int32, device="cuda")
        for b in range(B):
            mask[b, 7 * b:valid] = 1
        kv = (q, k, v, mask, valid)
        out = da.decode_attention_prefix(*kv)
        ref = da.decode_attention_prefix_ref(*kv)
        torch.cuda.synchronize()
        err, ratio = cs._full_ratio(out, ref)
        t = cs.time_ms(lambda: da.decode_attention_prefix(*kv))
        t_p = cs.time_ms(lambda: da.decode_attention_prefix_ref(*kv), 10)
        live = [x[:, :valid] for x in (k, v, mask)]
        kr, vr = (x.repeat_interleave(H // KVH, dim=2) for x in live[:2])
        keep = (live[2] != 0)[:, None, None, :]
        t_lib = cs.time_ms(lambda: cs.sdpa(q[:, None], kr, vr, keep))
        ops = cs.launched_ops(lambda: da.decode_attention_prefix(*kv))
        host = host_us(lambda: da.decode_attention_prefix(*kv))
        nbytes = cs._nbytes(q, *live, out)
        bound = nbytes / (cs.HBM_PEAK_GBPS * 1e9) * 1e3
        splits = f", {plan(B, KVH, valid, cs.qm._sms(0), H // KVH)} key splits" if plan else ""
        print(f"{tag} #4 {c['name']}: B={B} L={L} valid_len={valid} H={H} KVH={KVH} D={D} "
              f"bf16{splits}, one call {cs.ops_text(ops)}: {t:.4f} ms = "
              f"{nbytes / t / 1e6:.0f} GB/s, bound {bound:.4f} ms ({bound / t:.1%}); plain "
              f"{t_p:.4f} ms; SDPA {t_lib:.4f} ms; error {err:.3e} = "
              f"{ratio:.3f} of the bf16 bound; host {host:.1f} us a call", flush=True)
        del q, k, v, mask, kv, kr, vr, live, out, ref
        torch.cuda.empty_cache()
    x = torch.zeros(1, device="cuda")
    q, k, v = (torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
               for s in ((8, 32, D), (8, 512, 8, D), (8, 512, 8, D)))
    mask = torch.ones((8, 512), dtype=torch.int32, device="cuda")
    print(f"{tag} timing floor: one x.add_(1) {cs.time_ms(lambda: x.add_(1)):.4f} ms; #4 over "
          f"one 16-key tile {cs.time_ms(lambda: da.decode_attention_prefix(q, k, v, mask, 16)):.4f}"
          " ms", flush=True)
    del q, k, v, mask
    if args.phases:
        run_phases(cs, tag)
    print(f"{tag} {cs.nvidia_smi()} done", flush=True)


def host_us(fn, calls: int = 200) -> float:
    """The host's microseconds a call of fn(), the calls enqueued behind a
    spin kernel of ~25 ms (200 calls take well under that)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def run_phases(cs, tag: str) -> None:
    import numpy as np
    import torch

    tok = cs._fake_tokenizer()
    cfg = cs.LlavaConfig.llava15_7b()
    model = cs.LlavaForCausalLM(cfg, device="meta").to_empty(device="cuda")
    cs.init_weights_(model, torch.Generator(device="cuda").manual_seed(0)).eval()
    gen = cs.Llava15Generator(model, tok, cfg.num_image_tokens,
                              image_size=cfg.vision.image_size,
                              checkpoint_name="random-llava15-7b")
    cs.timed("4 slice", cs.phase_slice, gen, (cs.ROOT / "examples" / "test.jpeg").read_bytes())
    del gen, model
    gc.collect()
    torch.cuda.empty_cache()
    llama = cs.build_llama3(tok)
    fn, tmpl = cs.dcq.llama3_backend(llama, tok, max_new_tokens=cs.PIPE_NEW_TOKENS)
    meter = cs.BackendMeter(fn.engine)
    rng = np.random.default_rng(0)
    for n_chars in (500, 880):
        fn([tmpl(cs.dcq.divide_messages({"question": cs._text(rng, 40),
                                         "answer": cs._text(rng, n_chars)}))
            for _ in range(8)])
    print(f"{tag} the bf16 Llama3-8B backend, two 8-row divide batches: {meter.rates()} | "
          f"#4 {meter.launches['decode']} launches in {meter.steps} steps", flush=True)
    del fn, llama
    gc.collect()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
