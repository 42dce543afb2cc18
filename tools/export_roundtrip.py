"""chip_smoke.py phase 20c's export round trip at full depth: LLaVA-1.5-7B
(32 LLM layers, full width, random bf16 weights from seed 0) through
`params_from_model` + `export_llava_hf` (fp16, ~14 GB) into a temporary
directory, reloaded through `load_pretrained_llava` + `load_jax_params`
into a fresh model on the card.

It prints, on one line each (tagged "[export 32 layers]"): the free space
beside the export, the GB written with the export's and the bridge's
seconds and the reload's seconds, the reloaded state against the original
rounded bf16 -> fp16 -> bf16 (every tensor bit for bit), and 4 prompts x
16 greedy tokens through Llava15Generator on the reloaded model against
those of the rounded original, with kernels #1's and #4's launches. It
exits non-zero if a gate fails. chip_smoke.py runs the same round trip on
4 LLM layers (EXPORT_LAYERS); this is the one-off reading at full depth.

    python3 tools/export_roundtrip.py [ROOT]

ROOT (default: this checkout) is the tree whose chip_smoke.py and
rlaifv_tpu_torch are imported.
"""
import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("export_roundtrip: no CUDA device visible to torch")
    t0 = time.perf_counter()
    smi = cs.phase_environment()
    cs.phase_build()
    cfg = cs.LlavaConfig.llava15_7b()
    tok = cs._fake_tokenizer()
    model = cs.build_model(cfg, "export 32 layers")
    gen = cs.Llava15Generator(model, tok, cfg.num_image_tokens,
                              image_size=cfg.vision.image_size)
    image_bytes = (cs.ROOT / "examples" / "test.jpeg").read_bytes()
    work = tempfile.mkdtemp(prefix="export_roundtrip_")
    try:
        cs.export_roundtrip(gen, tok, image_bytes, smi, str(Path(work) / "full"),
                            tag="export 32 layers")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(f"[export 32 layers] wall {time.perf_counter() - t0:.1f} s | {smi}")


if __name__ == "__main__":
    main()
