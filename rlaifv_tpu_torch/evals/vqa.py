"""Benchmark answer generation (E1) on the port.

    python -m rlaifv_tpu_torch.evals.vqa --model-path <ckpt> \
        --question-file q.jsonl --answers-file a.jsonl [--device cpu]

Counterpart of rlaifv_tpu/evals/vqa.py (rebuild of ref
muffin/eval/muffin_vqa.py:31-114): read a benchmark jsonl of {question_id,
image(b64)|image_path, question}, batch-generate deterministic answers (3
beams by default, the reference's eval_rlaifv_objhal.sh), write
{question_id, prompt, text, model_id, metadata} rows, with
--num-chunks/--chunk-idx slicing. The model loads from the checkpoint's
config.json (`llava_config_from_hf`) in bf16 on the card (`--device cuda`,
the default; no visible card is an error) or in fp32 on the CPU when
asked.
"""
from __future__ import annotations

import argparse
from typing import List

from rlaifv_tpu_torch.data.datasets import chunk_indices
from rlaifv_tpu_torch.utils.file_io import read_jsonlines, write_jsonlines


def generate_answers(
    generator,
    rows: List[dict],
    *,
    max_new_tokens: int = 1024,
    batch_size: int = 8,
    num_chunks: int = 1,
    chunk_idx: int = 0,
    model_id: str = "",
    num_beams: int = 1,  # eval scripts use 3 (ref eval_rlaifv_objhal.sh)
) -> List[dict]:
    idx = chunk_indices(len(rows), num_chunks, chunk_idx)
    rows = [rows[i] for i in idx]

    out = []
    for i in range(0, len(rows), batch_size):
        chunk = rows[i: i + batch_size]
        items = [
            {
                "question": r["question"] if "question" in r else r["text"],
                "question_id": r.get("question_id", r.get("id")),
                "image": r.get("image"),
                "image_bytes": r.get("image_bytes"),
                "metainfos": r.get("metainfos", {}),
            }
            for r in chunk
        ]
        answers = generator.greedy_gen(
            items, max_new_tokens=max_new_tokens, batch_size=batch_size,
            num_beams=num_beams,
        )
        for r, a in zip(chunk, answers):
            out.append({
                "question_id": a["question_id"],
                "prompt": a["raw_question"],
                "text": a["answer"],
                "model_id": model_id,
                "metadata": r.get("metainfos", {}),
            })
    return out


def load_generator(model_path: str, device, tokenizer=None):
    """A Llava15Generator over the checkpoint at model_path (its config.json
    read by `llava_config_from_hf`, its weights by `load_pretrained_llava`):
    bf16 on the card, fp32 on the CPU."""
    import torch

    from rlaifv_tpu_torch.genai.llava_gen import Llava15Generator
    from rlaifv_tpu_torch.models.convert import (
        llava_config_from_hf,
        load_jax_params,
        load_pretrained_llava,
    )
    from rlaifv_tpu_torch.models.llava import LlavaForCausalLM

    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    dt = dict(dtype=dtype, param_dtype=dtype)
    cfg = llava_config_from_hf(model_path, llm=dt, vision=dt)
    model = LlavaForCausalLM(cfg, device="meta").to_empty(device=device)
    load_jax_params(model, load_pretrained_llava(
        model_path, vision_layers_to_run=cfg.vision.layers_to_run))
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_path, use_fast=False)
    return Llava15Generator(model.eval(), tokenizer, cfg.num_image_tokens,
                            image_size=cfg.vision.image_size,
                            checkpoint_name=model_path)


def main(argv=None):
    ap = argparse.ArgumentParser(description="benchmark answers with the port")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--question-file", required=True)
    ap.add_argument("--answers-file", required=True)
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    ap.add_argument("--max-new-tokens", type=int, default=1024)
    # ref muffin/eval/muffin_vqa.py --num_beams 3 via eval_rlaifv_objhal.sh
    ap.add_argument("--num-beams", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; no visible card is an error) or cpu")
    args = ap.parse_args(argv)

    from rlaifv_tpu_torch.train.__main__ import resolve_device

    device = resolve_device(args.device, "rlaifv_tpu_torch.evals.vqa")
    gen = load_generator(args.model_path, device)
    rows = read_jsonlines(args.question_file)
    out = generate_answers(
        gen, rows, max_new_tokens=args.max_new_tokens,
        num_chunks=args.num_chunks, chunk_idx=args.chunk_idx,
        model_id=args.model_path.split("/")[-1],
        num_beams=args.num_beams,
    )
    write_jsonlines(args.answers_file, out)


if __name__ == "__main__":
    main()
