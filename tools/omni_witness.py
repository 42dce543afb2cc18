"""chip_smoke.py phase 17's comparisons read again with every attention of
the language model forced dense (attn_impl "dense"): how far this random
OmniLMM-12B moves under a change of rounding alone, the witness beside
17's bounds. For each QLoRA config (17a int8, 17b int4) on 17's base, rows
and batch: the shared-prefix reference logps against the plain scorer
(17's comparison), and the plain scorer against itself with attention
dense; step 0 on the "dequant" route and on the kernel route, each against
itself with attention dense (loss, logps, 17's adapter gradients by
relative error and cosine), each step-0 loss beside ln 2.

    python3 tools/omni_witness.py [--config 17a|17b]

It imports this checkout's chip_smoke.py and builds the kernels; one H100,
about two minutes a config.
"""
import argparse
import contextlib
import dataclasses
import gc
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def dense_attention(model):
    """Every Llama attention of `model` on attn_impl "dense" inside."""
    from rlaifv_tpu_torch.models.llama import LlamaAttention

    attn = [m for m in model.modules() if isinstance(m, LlamaAttention)]
    for m in attn:
        m.attn_impl = "dense"
    try:
        yield
    finally:
        for m in attn:
            m.attn_impl = "auto"


def _grads_text(grads: dict) -> str:
    return " | ".join(f"{k}: rel {r:.3e} cos {cs:.6f}" for k, (r, cs) in grads.items())


def witness(cs, tok, rows: list, short: dict, tag: str, name: str) -> None:
    import torch

    from rlaifv_tpu_torch.core.config import Config
    from rlaifv_tpu_torch.train.family import get_family
    from rlaifv_tpu_torch.train.lora import lora_init
    from rlaifv_tpu_torch.train.ref_logp import score_preference_rows
    from rlaifv_tpu_torch.train.train_step import DPOHparams, batch_to_device, named_tensors
    from rlaifv_tpu_torch.train.trainer import resolve_head

    c = Config.from_json(str(ROOT / "configs" / name))
    t, bits = c.training, c.model.quantize_bits
    model = cs._omni_train_model(tok, c, tag)
    cfg, spec = model.cfg, get_family("omnilmm")
    kw = dict(max_len=c.data.max_len, num_patches=cfg.num_image_tokens, batch_pairs=8,
              image_processor=spec.image_processor(cs.OMNI_IMAGE), progress=False,
              family="omnilmm")
    scored = rows + [short]
    ref = score_preference_rows(scored, model, tok, shared_prefix=True, **kw)
    plain = score_preference_rows(scored, model, tok, shared_prefix=False,
                                  lm_head_impl="fused", **kw)
    with dense_attention(model):
        dense = score_preference_rows(scored, model, tok, shared_prefix=False,
                                      lm_head_impl="fused", **kw)
    rel, tmean, tmax = cs._seq_close(ref, plain, cs.OMNI_REF_RTOL)
    d_rel, d_mean, d_max = cs._seq_close(dense, plain, cs.OMNI_REF_RTOL)
    print(f"[{tag}] ref logps, shared prefix against the plain scorer (17's comparison): "
          f"sums and means max rel {rel:.3e}, per-token |d| mean {tmean:.3e} max {tmax:.3e} | "
          f"the plain scorer against itself with attention dense: max rel {d_rel:.3e}, "
          f"per-token |d| mean {d_mean:.3e} max {d_max:.3e}", flush=True)

    qb = cs.omni_batches(rows, short, tok, c, ref)
    hp = DPOHparams(beta=t.dpo_beta, dpo_use_average=t.dpo_use_average,
                    lm_head_impl=resolve_head(t, cfg.llm.hidden_size, cfg.llm.dtype),
                    shared_prefix_len=qb["P"])
    batch = batch_to_device(qb["batch_np"], "cuda")
    adapter = spec.adapter(model)
    model.train()
    lora = lora_init(torch.Generator(device="cuda").manual_seed(t.seed), model, r=t.lora_r)
    model.requires_grad_(False)  # the frozen base, as make_lora_dpo_train_step leaves it
    for _, x in named_tensors(lora):
        x.requires_grad_(True)
    names = cs.omni_grad_names(cfg.llm.num_layers)
    owner, attr, kernel_impl = (cs.qm, "INT8_LARGE_M_IMPL", "prequant") if bits == 8 \
        else (cs.i4, "INT4_IMPL", "kernel")
    for impl in ("dequant", kernel_impl):
        setattr(owner, attr, impl)
        try:
            run = cs._lora_loss_grads(model, adapter, batch, hp, lora, t.lora_alpha, names)
            with dense_attention(model):
                alt = cs._lora_loss_grads(model, adapter, batch, hp, lora, t.lora_alpha, names)
        finally:
            setattr(owner, attr, kernel_impl)
        d_loss, d_logp, grads = cs.compare_runs(alt, run)
        print(f"[{tag}] step 0 on the {impl} route, attention dense against flash: loss "
              f"{alt[0]:.5f} vs {run[0]:.5f} (|d| {d_loss:.4f}; beside ln 2: "
              f"{alt[0] - math.log(2):+.3e} / {run[0] - math.log(2):+.3e}), logps max rel "
              f"{d_logp:.2e} | {_grads_text(grads)}", flush=True)
    sft = dataclasses.replace(hp, dpo_weight=0.0, sft_weight=1.0)
    run = cs._lora_loss_grads(model, adapter, batch, sft, lora, t.lora_alpha, names)
    with dense_attention(model):
        alt = cs._lora_loss_grads(model, adapter, batch, sft, lora, t.lora_alpha, names)
    print(f"[{tag}] step 0, SFT term on the {kernel_impl} route, attention dense against "
          f"flash: {_grads_text(cs.compare_runs(alt, run)[2])}", flush=True)
    del model, adapter, lora, batch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("17a", "17b"), action="append",
                    help="one config (default both)")
    args = ap.parse_args()
    import chip_smoke as cs

    if not cs.torch.cuda.is_available():
        sys.exit("omni_witness: no CUDA device visible to torch")
    print(f"nvidia-smi: {cs.phase_environment()}", flush=True)
    cs.phase_build()
    tok = cs._fake_tokenizer()
    image_bytes = (ROOT / "examples" / "test.jpeg").read_bytes()
    rows, short = cs.synth_rows(image_bytes), cs.short_row(image_bytes)
    for tag, name in cs.OMNI_QLORA:
        if not args.config or tag.split()[0] in args.config:
            witness(cs, tok, rows, short, tag, name)


if __name__ == "__main__":
    main()
