"""Llama3-8B divide-and-conquer: answer -> atomic facts -> yes/no questions.

A copy of rlaifv_tpu/genai/divide_conquer.py, function for function and
under the same names, over the port's DecodeEngine (ref:
utils/llama3_8b_inference.py:195-321). The two prompts are preserved
verbatim (behavioral contract - the released llama3-split / llama3-changeq
models were tuned on them), as are the resumable append-to-answer-file
protocol (:134-142), the '- ' bullet parser (:68-82) and the output
filename contract (:288-321).

The text-generation backend is injected (`generate_fn: list[str] ->
list[str]`), normally the port's DecodeEngine over a converted Llama3-8B
(a bare LlamaForCausalLM); sampling matches the reference: T 0.2, top-p
0.9, max 256 new tokens. `make_llama3_backend` loads the checkpoint and
hands the built model to `llama3_backend`, the part after the load, which
tests and the card's smoke run call with a model they built themselves.

`continuous=True` generates through the engine's slot-refill
`generate_continuous` (`slots` cache slots). `int4=True, int4_smooth=True`
smooths the model with models/quant_smooth.py's `smooth_quantize_for_serving`
(alpha 0.5, one calibration forward) before the int4 quantisation.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Callable, List

import torch

from rlaifv_tpu_torch.data.datasets import chunk_indices
from rlaifv_tpu_torch.utils.file_io import read_json_or_jsonlines, read_jsonlines

DIVIDE_PROMPT = (
    "You are an expert in extracting facts from the given question-answer pair "
    "for an image. Your task is to extract and rewrite the facts mentioned in "
    "the question-answer pair into self-contained sentences. Exclude opinions "
    "or subjective statements.\n\nYou should present your result in the "
    "following format:\n### Facts:\n- {Extracted fact 1}\n- {Extracted fact 2}"
    "\n- ...\n\n### Question-answer pair:\nQuestion: "
)

CHANGEQ_PROMPT = (
    "You are an expert at modifying a given declarative sentence into a "
    "general question sentence. Your task is to modify the given declarative "
    "sentences one by one into a general question form. Do not change tenses "
    "or add extra content.\n    If the given declarative sentence contains "
    "not, no or negative meaning words, you need to check the modified "
    "general interrogative sentence to make sure that the generated general "
    "question sentence retains words with not , no or negative meaning words."
    "\n\nYou should present your result in the following format:\n"
    "### Modified sentences:\n- {Modified sentence 1}\n- {Modified sentence 2}"
    "\n- ...\n\n### Declarative sentences:"
)


def parse_facts(text: str) -> List[str]:
    """'- ' bullet list -> fact strings (ref get_facts :68-82)."""
    facts = []
    for line in text.strip().split("\n"):
        if line == "" or "###" in line:
            continue
        facts.append(line[1:].strip())
    return facts


def divide_messages(item: dict) -> List[dict]:
    question = item.get("raw_question") or item.get("prompt") or item["question"]
    answer = item.get("answer", item.get("text"))
    content = DIVIDE_PROMPT + question + "\nAnswer: " + answer
    content = " ".join(content.split(" ")[:300])  # ref truncation (:210)
    return [{"role": "user", "content": content}]


def changeq_messages(item: dict) -> List[dict]:
    content = CHANGEQ_PROMPT
    for fact in item["facts"]:
        content += "\n- {}\n".format(fact)
    return [{"role": "user", "content": content}]


def batch_process(
    path: str,
    ans_file: str,
    generate_fn: Callable[[List[str]], List[str]],
    apply_chat_template: Callable[[List[dict]], str],
    key: str,
    wrap_func: Callable[[dict], List[dict]],
    batch_size: int = 8,
    chunk_num: int = 1,
    chunk_idx: int = 0,
    start: int = 0,
    end: int = -1,
) -> List[dict]:
    """Resumable batched generation (ref batch_inference :109-194)."""
    data = read_json_or_jsonlines(path)
    if isinstance(data, dict):
        data = [data]
    end = len(data) if end == -1 else min(end, len(data))
    data = data[start:end]
    data = [data[i] for i in chunk_indices(len(data), chunk_num, chunk_idx)]

    # resume: skip rows already present in the answer file
    if os.path.exists(ans_file):
        prev = read_jsonlines(ans_file)
        data = data[len(prev):]
        out_f = open(ans_file, "a")
    else:
        prev = []
        os.makedirs(os.path.dirname(ans_file) or ".", exist_ok=True)
        out_f = open(ans_file, "w")

    all_outputs = copy.deepcopy(prev)
    with out_f:
        for i in range(0, len(data), batch_size):
            batch = data[i : i + batch_size]
            prompts = [apply_chat_template(wrap_func(item)) for item in batch]
            responses = generate_fn(prompts)
            for item, resp in zip(batch, responses):
                item = dict(item)
                item[f"raw_{key}"] = resp
                item[key] = parse_facts(resp)
                all_outputs.append(item)
                out_f.write(json.dumps(item, ensure_ascii=False) + "\n")
                out_f.flush()
    return all_outputs


def construct_question_yesno(path: str, save_path: str) -> List[dict]:
    """One '{q} Please answer yes or no.' row per (fact, changed_fact)
    (ref :248-286)."""
    from rlaifv_tpu_torch.utils.file_io import write_jsonlines

    data = read_jsonlines(path)
    out = []
    for item in data:
        image_path = item.get("image_path") or item["metainfos"]["image_path"]
        if isinstance(item["facts"], str):
            continue
        for fact, changed in zip(item["facts"], item["changed_facts"]):
            meta = copy.deepcopy(item["metainfos"])
            meta["origin_question"] = item.get("raw_question", item.get("question"))
            meta["origin_answer"] = item["answer"]
            meta["origin_fact"] = fact
            meta["origin_changed_fact"] = changed
            meta["origin_all_facts"] = item["facts"]
            meta["origin_changed_all_facts"] = item["changed_facts"]
            out.append({
                "question_id": item["question_id"],
                "ds_question_id": item.get(
                    "ds_question_id", item["metainfos"].get("ds_question_id")
                ),
                "image_path": image_path,
                "question": f"{changed} Please answer yes or no.",
                "metainfos": meta,
            })
    write_jsonlines(save_path, out)
    return out


def llama3_backend(model, tokenizer, *, temperature: float = 0.2,
                   top_p: float = 0.9, max_new_tokens: int = 256,
                   continuous: bool = False, slots: int = 8,
                   int8: bool = False, int4: bool = False,
                   int4_smooth: bool = False, fused_decode: bool = False):
    """A built bare Llama3 LlamaForCausalLM (float weights, on its device)
    and its tokenizer -> (generate_fn, apply_chat_template): the part of
    `make_llama3_backend` after the checkpoint load.

    int8: weight-only int8 LLM (the head left bf16) + fused projections +
    int8 KV cache (the single-chip 8B serving config), quantised in place.
    int4: nibble-packed int4 weights instead; int4_smooth: AWQ-style
    smoothing first (fixed alpha 0.5). fused_decode additionally runs
    the whole GQA layer stack as one kernel launch per token (kernel #16;
    implies a quantised base: int8 unless int4). The engine consumes the
    model's per-layer weights when it stacks them. continuous: slot-refill
    continuous batching over `slots` slots (genai/continuous.py) on any of
    these engines."""
    from rlaifv_tpu_torch.genai.engine import DecodeEngine
    from rlaifv_tpu_torch.genai.sampling import SamplingParams
    from rlaifv_tpu_torch.models.convert import (
        fuse_llm_projections_,
        quantize_llm_int4,
        quantize_llm_int8,
        set_llm_config,
    )

    from rlaifv_tpu_torch.models.quant_smooth import smooth_quantize_for_serving

    int8 = int8 or (fused_decode and not int4)
    if int4 and int4_smooth:
        # AWQ-style smoothing at the serving loader's fixed alpha 0.5, one
        # calibration forward (models/quant_smooth.py), then fused
        fuse_llm_projections_(smooth_quantize_for_serving(model.cfg, model, tokenizer))
    elif int4:
        fuse_llm_projections_(quantize_llm_int4(model))
    elif int8:
        fuse_llm_projections_(quantize_llm_int8(model, include_lm_head=False))
    if int8 or int4:
        set_llm_config(model, kv_cache_dtype="int8")
    eot = tokenizer.convert_tokens_to_ids("<|eot_id|>")
    engine = DecodeEngine(
        model, eos_id=eot, pad_id=tokenizer.eos_token_id,
        fused_decode=fused_decode,
    )
    sp = SamplingParams(temperature=temperature, top_p=top_p)

    def apply_chat_template(messages):
        return tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )

    def generate_fn(prompts: List[str]) -> List[str]:
        token_prompts = [tokenizer(p).input_ids for p in prompts]
        if continuous:
            # fact lists vary a lot in length: slot refill keeps every cache
            # slot busy instead of waiting on the batch's longest row
            res = engine.generate_continuous(token_prompts, sampling=sp,
                                             max_new_tokens=max_new_tokens, slots=slots)
        else:
            res = engine.generate(token_prompts, sampling=sp, max_new_tokens=max_new_tokens)
        return [
            tokenizer.decode(res.tokens[i][: res.lengths[i]],
                             skip_special_tokens=True)
            for i in range(len(prompts))
        ]

    generate_fn.engine = engine  # the caller may read its counters and memory
    return generate_fn, apply_chat_template


def make_llama3_backend(model_path: str, *, temperature: float = 0.2,
                        top_p: float = 0.9, max_new_tokens: int = 256,
                        continuous: bool = False, slots: int = 8,
                        int8: bool = False, int4: bool = False,
                        int4_smooth: bool = False,
                        fused_decode: bool = False, device: str = "cuda"):
    """Converted Llama3-8B + decode engine as the generate_fn: the HF
    checkpoint at `model_path` loaded into a LlamaForCausalLM on `device`
    ("cuda" unless the caller asks for the CPU; no card raises) in bf16
    (the JAX function keeps the config's default fp32), then
    `llama3_backend`."""
    from transformers import AutoTokenizer

    from rlaifv_tpu_torch.models.convert import (
        convert_llama,
        load_jax_params,
        load_state_dict_dir,
    )
    from rlaifv_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_llama3_backend: no CUDA device is visible; "
                           "pass device='cpu' to run on the CPU")
    tokenizer = AutoTokenizer.from_pretrained(model_path)
    cfg = LlamaConfig.llama3_8b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="meta").to_empty(device=device)
    load_jax_params(model, convert_llama(load_state_dict_dir(model_path)))
    return llama3_backend(
        model.eval(), tokenizer, temperature=temperature, top_p=top_p,
        max_new_tokens=max_new_tokens, continuous=continuous, slots=slots,
        int8=int8, int4=int4, int4_smooth=int4_smooth, fused_decode=fused_decode,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", type=str, required=True)
    ap.add_argument("--divide_model", type=str, required=True)
    ap.add_argument("--changeq_model", type=str, required=True)
    ap.add_argument("--divide_suffix", type=str, default="llama3-8b_divide")
    ap.add_argument("--chunk-num", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=-1)
    ap.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    divide_path = args.path.replace(
        ".jsonl",
        f".s{args.start}-e{args.end}.chunk{args.chunk_num}-{args.chunk_idx}."
        f"{args.divide_suffix}.jsonl",
    )
    gen, tmpl = make_llama3_backend(args.divide_model, device=args.device)
    batch_process(
        args.path, divide_path, gen, tmpl, key="facts",
        wrap_func=divide_messages, batch_size=args.bs,
        chunk_num=args.chunk_num, chunk_idx=args.chunk_idx,
        start=args.start, end=args.end,
    )

    gq_path = divide_path.replace(".jsonl", ".gq.jsonl")
    gen, tmpl = make_llama3_backend(args.changeq_model, device=args.device)
    batch_process(
        divide_path, gq_path, gen, tmpl, key="changed_facts",
        wrap_func=changeq_messages, batch_size=args.bs,
    )
    construct_question_yesno(gq_path, gq_path.replace(".jsonl", ".qas.jsonl"))


if __name__ == "__main__":
    main()
