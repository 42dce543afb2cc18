"""Feedback-data pipeline orchestrator on the port (python -m rlaifv_tpu_torch.pipeline).

A copy of scripts/run_data_pipeline.py over rlaifv_tpu_torch, with the same
stage functions and the same INTERMEDIATE FILENAME CONTRACTS (ref
script/data_gen/run_data_pipline_llava15_omni.sh:1-54), so artifacts
produced by either stack interoperate:

  1. diverse gen      -> diverse_gen_llava15_{start}-{end}_{ques}.jsonl
  2. llama3 divide+gq -> {...}.s{start}-e{end}.chunk{N}-{i}.llama3-8b_divide
                          .gq.qas.jsonl
  3. autocheck        -> autocheck_{labeler}_{start}--1_{...}.qas.jsonl
  4. pairs + sampling -> {...}_pair_diff1_samp{K}.jsonl
  5. length balance   -> {...}_balanceshort.jsonl

Each stage is an importable function; `main` chains them. Stages are
idempotent: existing outputs are reused (resume-by-file like the
reference's per-chunk reruns). `main` runs on the card unless `--device
cpu` asks for the CPU; without a visible card it stops with an error.

One deliberate difference: when no pair survives to the length balance
(none scored apart, or each pair's answers are equal), stage 5 writes an
empty balanced file, where the JAX orchestrator raises ValueError (the min
of an empty sweep in pairs/length_filter.py).
"""
from __future__ import annotations

import argparse
import os

from rlaifv_tpu_torch.data.datasets import GenDataset
from rlaifv_tpu_torch.utils.file_io import read_jsonlines, write_jsonlines


def stage_diverse_gen(generator, ques_path: str, ans_dir: str,
                      start: int = 0, end: int = -1,
                      repeat: int = 10, batch_size: int = 8,
                      temperature: float = 0.7, max_tokens: int = 512) -> str:
    base = os.path.basename(ques_path).replace(".jsonl", "")
    out = os.path.join(ans_dir, f"diverse_gen_llava15_{start}-{end}_{base}.jsonl")
    if os.path.exists(out):
        print(f"[pipeline] reuse {out}")
        return out
    os.makedirs(ans_dir, exist_ok=True)
    ds = GenDataset(ques_path, repeat_time=repeat, start=start,
                    end=None if end == -1 else end)
    rows = generator.diverse_gen(
        [ds[i] for i in range(len(ds))],
        temperature=temperature, max_new_tokens=max_tokens,
        batch_size=batch_size,
    )
    write_jsonlines(out, rows)
    return out


def stage_divide_and_conquer(divide_backend, changeq_backend, ans_file: str,
                             start: int = 0, end: int = -1,
                             batch_size: int = 8) -> str:
    from rlaifv_tpu_torch.genai.divide_conquer import (
        batch_process,
        changeq_messages,
        construct_question_yesno,
        divide_messages,
    )

    gen_d, tmpl_d = divide_backend
    gen_c, tmpl_c = changeq_backend

    divide_path = ans_file.replace(
        ".jsonl", f".s{start}-e{end}.chunk1-0.llama3-8b_divide.jsonl"
    )
    batch_process(ans_file, divide_path, gen_d, tmpl_d, key="facts",
                  wrap_func=divide_messages, batch_size=batch_size,
                  start=start, end=end)
    gq_path = divide_path.replace(".jsonl", ".gq.jsonl")
    batch_process(divide_path, gq_path, gen_c, tmpl_c, key="changed_facts",
                  wrap_func=changeq_messages, batch_size=batch_size)
    qas_path = gq_path.replace(".jsonl", ".qas.jsonl")
    construct_question_yesno(gq_path, qas_path)
    return qas_path, gq_path


def stage_autocheck(labeler, qas_path: str, ans_dir: str,
                    labeler_name: str = "omni", start: int = 0,
                    end: int = -1, batch_size: int = 8) -> str:
    base = os.path.basename(qas_path)
    out = os.path.join(ans_dir, f"autocheck_{labeler_name}_{start}-{end}_{base}")
    if os.path.exists(out):
        print(f"[pipeline] reuse {out}")
        return out
    rows = read_jsonlines(qas_path)
    # GenDataset metainfos contract (ref llava15_gen_data.py:70): all fields
    # except image/question become the row's metainfos — downstream pair
    # construction expects metainfos.metainfos.origin_question
    items = []
    for row in rows:
        item = {
            "question": row["question"],
            "question_id": row["question_id"],
            "ds_question_id": row.get("ds_question_id"),
            "metainfos": {
                k: v for k, v in row.items()
                if k not in ("image_id", "question", "image")
            },
        }
        if "image" in row:
            item["image"] = row["image"]
        elif row.get("image_path") and os.path.exists(row["image_path"]):
            item["image"] = row["image_path"]
        items.append(item)
    scored = labeler.autocheck(items, batch_size=batch_size)
    write_jsonlines(out, scored)
    return out


def stage_pairs(autocheck_path: str, gq_path: str, sample_num: int = 2) -> str:
    from rlaifv_tpu_torch.pairs.preference import run as pref_run

    pref_run(autocheck_path, gq_path, sample_num=sample_num)
    return autocheck_path.replace(
        ".jsonl", f"_pair_diff1_samp{sample_num}.jsonl"
    )


def stage_length_balance(pairs_path: str) -> str:
    from rlaifv_tpu_torch.pairs.length_filter import filter_by_relative_length
    from rlaifv_tpu_torch.pairs.length_filter import run as lf_run

    out = pairs_path.replace(".jsonl", "_balanceshort.jsonl")
    if not filter_by_relative_length(read_jsonlines(pairs_path), 0.98):
        # no pair survives the sweep's loosest cut (no pair came in, or each
        # pair's answers are equal): length_filter.run would take the min of
        # an empty sweep and raise, as the JAX orchestrator does; the port
        # writes the empty balanced file and sweep instead
        print(f"[pipeline] no pair to balance in {pairs_path}")
        write_jsonlines(out, [])
        write_jsonlines(out.replace(".jsonl", "_search_diff.jsonl"), [])
        return out
    lf_run(pairs_path, out)
    return out


def run_pipeline(
    generator,  # Llava15Generator
    labeler,  # any generator with .autocheck
    divide_backend,
    changeq_backend,
    ques_path: str,
    ans_dir: str,
    *,
    start: int = 0,
    end: int = -1,
    sample_num: int = 2,
    labeler_name: str = "omni",
    repeat: int = 10,
    batch_size: int = 8,
    temperature: float = 0.7,
    max_tokens: int = 512,
) -> str:
    """Full loop: gen -> divide -> autocheck -> pairs -> balance.
    Returns the balanced pair jsonl ready for DPO training."""
    ans_file = stage_diverse_gen(
        generator, ques_path, ans_dir, start, end,
        repeat=repeat, batch_size=batch_size, temperature=temperature,
        max_tokens=max_tokens,
    )
    qas_path, gq_path = stage_divide_and_conquer(
        divide_backend, changeq_backend, ans_file, start, end
    )
    autocheck_path = stage_autocheck(
        labeler, qas_path, ans_dir, labeler_name, start, end,
        batch_size=batch_size,
    )
    pairs_path = stage_pairs(autocheck_path, gq_path, sample_num)
    return stage_length_balance(pairs_path)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="RLAIF-V feedback pipeline (LLaVA gen + labeler autocheck)"
    )
    ap.add_argument("--policy-model", required=True)
    ap.add_argument("--labeler-model", required=True)
    ap.add_argument("--divide-model", required=True)
    ap.add_argument("--changeq-model", required=True)
    ap.add_argument("--ques-file", required=True)
    ap.add_argument("--ans-dir", required=True)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=-1)
    ap.add_argument("--sample-num", type=int, default=2)
    ap.add_argument("--llm-int8", action="store_true",
                    help="serve the Llama3-8B divide/changeq models "
                         "weight-only int8 + fused proj + int8 KV cache")
    ap.add_argument("--llm-int4", action="store_true",
                    help="serve the Llama3-8B divide/changeq models "
                         "weight-only packed int4 (half the int8 "
                         "weight traffic on this decode-heavy stage)")
    ap.add_argument("--llm-fused-decode", action="store_true",
                    help="decode Llama3-8B with the whole-layer-stack "
                         "kernel (implies a quantized base)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; no visible card is an error) "
                         "or cpu")
    args = ap.parse_args(argv)

    import torch
    from transformers import AutoTokenizer

    from rlaifv_tpu_torch.genai.divide_conquer import make_llama3_backend
    from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
    from rlaifv_tpu_torch.models.convert import (
        llava_config_from_hf,
        load_jax_params,
        load_llava_checkpoint,
    )
    from rlaifv_tpu_torch.models.llava import LlavaForCausalLM

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rlaifv_tpu_torch.pipeline: no CUDA device is visible; "
                         "pass --device cpu to run on the CPU")

    def llava(path):
        # the checkpoint's own geometry (config.json), in bf16
        bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
        cfg = llava_config_from_hf(path, llm=bf16, vision=bf16)
        model = LlavaForCausalLM(cfg, device="meta").to_empty(device=args.device)
        load_jax_params(model, load_llava_checkpoint(
            path, vision_layers_to_run=cfg.vision.layers_to_run))
        return cfg, model.eval()

    cfg, model = llava(args.policy_model)
    tok = AutoTokenizer.from_pretrained(args.policy_model, use_fast=False)
    generator = Llava15Generator(model, tok, cfg.num_image_tokens,
                                 image_size=cfg.vision.image_size,
                                 checkpoint_name=args.policy_model)

    # labeler: same class pointed at the labeler checkpoint by default
    _, lab_model = llava(args.labeler_model)
    labeler = Llava15Generator(lab_model, tok, cfg.num_image_tokens,
                               image_size=cfg.vision.image_size,
                               checkpoint_name=args.labeler_model)

    llm = dict(int8=args.llm_int8, int4=args.llm_int4,
               fused_decode=args.llm_fused_decode, device=args.device)
    out = run_pipeline(
        generator, labeler,
        make_llama3_backend(args.divide_model, **llm),
        make_llama3_backend(args.changeq_model, **llm),
        args.ques_file, args.ans_dir,
        start=args.start, end=args.end, sample_num=args.sample_num,
    )
    print(f"[pipeline] balanced pairs at {out}")


if __name__ == "__main__":
    main()
