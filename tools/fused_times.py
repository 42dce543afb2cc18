"""Device times of kernel #16 (fused decode through the layer stack,
`rlaifv_tpu_torch.ops.fused_decode.fused_decode_step`) at chip_smoke.py's
phase 3g timed cases, with a per-phase breakdown, for the tree at ROOT
(default: this checkout).

Prints one line a case, tagged with ROOT's directory name: #16 in ms a step
(the wrapper's rope tables and copies included, as 3g times it) and GB/s
against the byte bound at 3.35 TB/s (`chip_smoke._fd_bound`). Then, for
each case, the step's phases: a copy of ROOT's csrc/fused_decode.cu is built
with a %globaltimer stamp where each CTA arrives at a grid barrier and where
it leaves it (the shipped kernel has no such switch), and one launch of
that copy gives, per phase and averaged over the layers (layer 0's first
phase left out: nothing stamps the launch's start), the span from one
barrier's release to the next (us a layer), the slowest CTA's work in it
and the mean CTA's, and the rest of the span: barrier latency plus the
slowest CTA's lag. Last the barrier-bound floor of a launch (3g's tiny
case: D 256, B 1, one live column). With --flips N, 3g's sharp one-layer
check over N seeds instead, at greedy_gen, batch 24 and Llama3-8B (fresh weights of one layer and a fresh cache
each): how many rows hold a quantisation flip, the kernel against the twin
at the kernel's plan and the twin against itself with x one ulp up, and
how often each breaks 3g's flip-row bound (chip_smoke.FUSED_FLIP_ROWS).

The cases are 3g's timed ones (greedy_gen B 8, diverse_gen B 10, the
batch-24 headline, GQA n_rep 4, int4 diverse_gen and batch 24, Llama3-8B
int8 and int4), all 32 layers, random weights and cache as 3g makes them.
Times are medians of CUDA-event launches behind a spin kernel, as
chip_smoke.py times.

Each process imports ROOT's chip_smoke.py and rlaifv_tpu_torch, so ROOT may
be an unpacked `git archive` of another commit; run two trees in one call,
in the order A, B, B, A, to compare them on one card:

    python3 tools/fused_times.py [ROOT] [--flips N]
"""
import argparse
import ctypes
import sys
from pathlib import Path

# chip_smoke.py's timed 3g cases, kept here because a parent tree's
# chip_smoke.py names them in its own list
CASES = [
    dict(name="greedy_gen", B=8, L=896, ci=840, KVH=32, bits=8),
    dict(name="diverse_gen", B=10, L=896, ci=895, KVH=32, bits=8),
    dict(name="batch-24", B=24, L=1024, ci=960, KVH=32, bits=8),
    dict(name="GQA n_rep 4", B=6, L=512, ci=300, KVH=8, bits=8),
    dict(name="int4 diverse_gen", B=10, L=896, ci=895, KVH=32, bits=4),
    dict(name="int4 batch-24", B=24, L=1024, ci=960, KVH=32, bits=4),
    dict(name="Llama3-8B", B=8, L=2304, ci=2200, KVH=8, bits=8, llama3=True),
    dict(name="int4 Llama3-8B", B=8, L=2304, ci=2200, KVH=8, bits=4, llama3=True),
]
PHASES = ("rms", "qkv", "attention", "o", "rms 2", "gate/up", "act", "down")
FLIP_CASES = ("greedy_gen", "batch-24", "Llama3-8B")
MAX_CTAS, MAX_BARRIERS = 1024, 512

# The stamped copy: file-scope stamps, read back by two extra entry points,
# and grid_sync wrapped so that thread 0 stamps after its CTA's arrival
# (every warp done) and after the release.
STAMPS = r'''
__device__ unsigned long long fd_stamp[MAXC * MAXI * 2];
__device__ unsigned fd_stamp_n[MAXC];
extern "C" int fused_decode_stamps(void *stamps, void *counts) {
  cudaError_t e = cudaMemcpyFromSymbol(stamps, fd_stamp, sizeof(fd_stamp));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(counts, fd_stamp_n, sizeof(fd_stamp_n));
  return static_cast<int>(e);
}
extern "C" int fused_decode_stamps_reset() {
  static unsigned zeros[MAXC];
  return static_cast<int>(cudaMemcpyToSymbol(fd_stamp_n, zeros, sizeof(zeros)));
}
__device__ __forceinline__ void fd_stamp_at(int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned i = fd_stamp_n[blockIdx.x];
  if (i < MAXI) fd_stamp[(blockIdx.x * MAXI + i) * 2 + k] = t;
  if (k) fd_stamp_n[blockIdx.x] = i + 1;
}
'''.replace("MAXC", str(MAX_CTAS)).replace("MAXI", str(MAX_BARRIERS))
BARRIER = "__device__ void grid_sync(unsigned *bar) {"
WRAPPED = """__device__ void grid_sync_inner(unsigned *bar);
__device__ void grid_sync(unsigned *bar) {
  __syncthreads();
  if (threadIdx.x == 0) fd_stamp_at(0);
  grid_sync_inner(bar);
  if (threadIdx.x == 0) fd_stamp_at(1);
}
__device__ void grid_sync_inner(unsigned *bar) {"""
INCLUDE = '#include "int8_mma.cuh"\n'
# chip_smoke.build_variants' edits of the stamped copy
STAMP_EDITS = [("fused_decode.cu", INCLUDE, INCLUDE + STAMPS),
               ("fused_decode.cu", BARRIER, WRAPPED)]


def declare(lib):
    """The stamped copy's two extra entry points' C signatures."""
    lib.fused_decode_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.fused_decode_stamps.restype = ctypes.c_int
    lib.fused_decode_stamps_reset.argtypes = []
    lib.fused_decode_stamps_reset.restype = ctypes.c_int
    return lib


def phases_text(rows) -> str:
    total = sum(r[1] for r in rows)
    return (f"us a layer: span / slowest CTA's work / mean work; {total:.1f} us a layer in "
            f"all: " + "; ".join(f"{n} {s:.1f} / {w:.1f} / {m:.1f}" for n, s, w, m in rows))


def breakdown(torch, lib, run, n_layers: int) -> list:
    """One launch of the stamped copy -> per phase (name, span us, slowest
    CTA's work us, mean CTA's work us), averaged over the layers."""
    if lib.fused_decode_stamps_reset():
        raise RuntimeError("fused_decode_stamps_reset failed")
    run()
    torch.cuda.synchronize()
    st = torch.zeros(MAX_CTAS * MAX_BARRIERS * 2, dtype=torch.int64)
    cnt = torch.zeros(MAX_CTAS, dtype=torch.int32)
    if lib.fused_decode_stamps(st.data_ptr(), cnt.data_ptr()):
        raise RuntimeError("fused_decode_stamps failed")
    ctas = int((cnt > 0).sum())
    if ctas == 0:
        raise RuntimeError("stamps: no CTA stamped (the launch did not run the stamped copy)")
    nb = int(cnt[:ctas].min())
    if int(cnt[:ctas].max()) != nb or nb != len(PHASES) * n_layers:
        raise RuntimeError(f"stamps: {ctas} CTAs, {cnt[:ctas].min()}-{cnt[:ctas].max()} "
                           f"barriers, expected {len(PHASES) * n_layers}")
    st = st.view(MAX_CTAS, MAX_BARRIERS, 2)[:ctas, :nb].double() / 1e3  # us
    arrive, release = st[..., 0], st[..., 1]
    span = release[:, 1:].median(dim=0).values - release[:, :-1].median(dim=0).values
    work = arrive[:, 1:] - release[:, :-1]  # (ctas, nb - 1): barrier i's phase
    out = []
    for p, name in enumerate(PHASES):
        idx = [i - 1 for i in range(p, nb, len(PHASES)) if i >= 1]
        out.append((name, float(span[idx].mean()), float(work[:, idx].amax(dim=0).mean()),
                    float(work[:, idx].mean())))
    return out


def flip_rates(torch, cs, fd, tag: str, n: int) -> None:
    """3g's one-layer flip-row statistics over n seeds (module docstring)."""
    plan = getattr(fd, "fused_plan", None)
    for c in CASES:
        if c["name"] not in FLIP_CASES:
            continue
        B, ci = c["B"], c["ci"]
        k_rows, t_rows, k_trips, t_trips = [], [], 0, 0
        for seed in range(n):
            g = torch.Generator(device="cuda").manual_seed(1000 + seed)
            cfg = cs._fd_cfg(c["KVH"], c["bits"], c.get("llama3", False), num_layers=1)
            w = cs._fd_weights(g, cfg)
            d = fd.default_dims(cfg, c["L"])
            cache, mask, x, pos = cs._fd_inputs(g, d, B, ci)
            kw = dict(rope_theta=cfg.rope_theta)
            kwr = dict(kw, attn_splits=plan(d, B, ci).attn_splits) if plan else kw
            out = fd.fused_decode_step(w, cache, x, mask, pos, ci, d, **kw)
            ref = fd.fused_decode_step_ref(w, cache, x, mask, pos, ci, d, **kwr)
            xp = torch.nextafter(x, torch.full_like(x, float("inf")))
            spread = fd.fused_decode_step_ref(w, cache, xp, mask, pos, ci, d, **kwr)
            gk, gt = cs._fd_gap(*out, *ref), cs._fd_gap(*spread, *ref)
            k_rows.append(gk["rows"])
            t_rows.append(gt["rows"])
            k_trips += bool(cs._fd_layer_broken(gk, B))
            t_trips += bool(cs._fd_layer_broken(gt, B))
        print(f"{tag} #16 {c['name']} flips over {n} seeds (one layer, bound "
              f"{cs.FUSED_FLIP_ROWS(B)} rows of {B}): the kernel against the twin {k_rows}, "
              f"{k_trips} break the bound; the twin against itself one ulp up {t_rows}, "
              f"{t_trips} break it", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--flips", type=int, default=0, help="the flip-row sweep over N seeds")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from rlaifv_tpu_torch.ops import fused_decode as fd

    if not torch.cuda.is_available():
        sys.exit("fused_times: no CUDA device")
    tag = f"[fused times] {root.name}"
    if args.flips:
        flip_rates(torch, cs, fd, tag, args.flips)
        print(f"{tag} {cs.nvidia_smi()} done", flush=True)
        return
    lib = declare(cs.build_variants({"fused_stamps": STAMP_EDITS})["fused_stamps"])
    g = torch.Generator(device="cuda").manual_seed(16)
    weights = {}
    for c in CASES:
        key = (c["KVH"], c["bits"], c.get("llama3", False))
        if key not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[key] = cs._fd_weights(g, cs._fd_cfg(*key))
        cfg = cs._fd_cfg(*key)
        d = fd.default_dims(cfg, c["L"])
        B, ci = c["B"], c["ci"]
        cache, mask, x, pos = cs._fd_inputs(g, d, B, ci)
        kw = dict(rope_theta=cfg.rope_theta)

        def run():
            return fd.fused_decode_step(weights[key], cache, x, mask, pos, ci, d, **kw)

        t = cs.time_ms(run, 10)
        b = cs._fd_bound(d, B, ci)
        nbytes = cs._fd_bytes(d, B, ci)
        plan = getattr(fd, "fused_plan", None)
        splits = f", plan {plan(d, B, ci)}" if plan is not None else ""
        print(f"{tag} #16 {c['name']}: int{c['bits']} B={B} L={d.L} cache_index={ci} "
              f"KVH={d.KVH} I={d.I}{splits}: {t:.4f} ms = {nbytes / t / 1e6:.0f} GB/s, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_ms'] / t:.1%})", flush=True)
        with cs.kernels_from(lib):
            rows = breakdown(torch, lib, run, d.n_layers)
        print(f"{tag} #16 {c['name']} phases ({phases_text(rows)})", flush=True)
        del cache, mask, x, pos
    weights.clear()
    torch.cuda.empty_cache()

    # 3g's barrier-bound floor: 32 layers of 8 phases on work too small to
    # matter (D 256, one kv head pair, B 1, one live column)
    cfg = cs._fd_cfg(2, 8, hidden_size=256, intermediate_size=512, num_heads=2)
    d = fd.default_dims(cfg, 128)
    tiny = cs._fd_weights(g, cfg)
    cache, mask, x, pos = cs._fd_inputs(g, d, 1, 1)
    t = cs.time_ms(lambda: fd.fused_decode_step(tiny, cache, x, mask, pos, 1, d), 20)
    n_bar = len(PHASES) * d.n_layers
    print(f"{tag} barrier-bound floor: {t:.4f} ms a launch at D 256, B 1 ({n_bar} grid "
          f"barriers: <= {t / n_bar * 1e3:.2f} us a barrier and phase)", flush=True)
    print(f"{tag} {cs.nvidia_smi()} done", flush=True)


if __name__ == "__main__":
    main()
