"""The fused head forward's time against its vocabulary split count, at
chip_smoke.py 3c's timed cases (the train step M 2046, the ref-logp
fallback M 16363, H 1024), beside the count `ops/fused_head.py:fwd_splits`
picks. Calls the forward's C entry point with each count (both kernels of
a call: the split tiles and the combine), checks logp against the plain
forward (3c's HEAD_FWD_TOL) and prints one line a count: medians of
CUDA-event launches behind a spin kernel, as chip_smoke times. Needs the
card and nvcc:

    python3 tools/head_splits.py
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    import torch

    import chip_smoke as cs
    from rlaifv_tpu_torch.ops import _build, fused_head as fh

    if not torch.cuda.is_available():
        sys.exit("head_splits: no CUDA device")
    print(f"nvidia-smi: {cs.nvidia_smi()}", flush=True)
    lib = _build.load_kernels()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    V = 32000
    for M, H, counts in ((2046, 4096, (4, 8, 9, 16)), (16363, 4096, (1, 2, 3, 4, 8)),
                         (2046, 1024, (4, 8, 16))):
        x, w, y, _ = cs._head_inputs(g, M, H, V)
        ref = fh.fused_head_fwd_plain(x, w, y)[0]
        for ns in counts:
            part = torch.empty((3, ns, M), device="cuda")
            logp, lse = torch.empty((2, M), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                return lib.fused_head_fwd_bf16(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                               part.data_ptr(), logp.data_ptr(), lse.data_ptr(),
                                               M, H, V, ns, stream)

            _build.check(run(), "fused_head_fwd_bf16")
            err = (logp - ref).abs().max().item()
            if not err <= cs.HEAD_FWD_TOL:
                raise AssertionError(f"M={M} H={H} nsplit={ns}: max|logp err| {err}")
            t = cs.time_ms(run, 10)
            pick = " (fwd_splits)" if ns == fh.fwd_splits(M, V, sms) else ""
            print(f"[head splits] M={M} H={H} V={V} nsplit={ns}{pick}: {t:.4f} ms "
                  f"({2 * M * H * V / t / 1e9:.0f} TFLOP/s), max|logp err| {err:.2e}", flush=True)
        del x, w, y, ref


if __name__ == "__main__":
    main()
