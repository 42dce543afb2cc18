# A copy of rlaifv_tpu/data/preprocess.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Tokenization + label masking for preference samples (host side, numpy).

Port of the parity-critical encode path
(ref: muffin/train/train_utils.py:198-263 `encode_multimodal_preference_sample`,
:265-349 `preprocess_v1`, :131-158 legacy `preprocess`). The round-length
arithmetic — including the tokenizers>=0.14 off-by-one correction
(train_utils.py:329-331) — must match token-for-token: cached reference
logps are only valid if labels mask identical positions.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np

from rlaifv_tpu_torch.constants import IGNORE_INDEX
from rlaifv_tpu_torch.data import conversation as conversation_lib
from rlaifv_tpu_torch.data.multimodal import expand_image_token, tokenizer_image_token


def _tokenizer_is_legacy(tokenizer) -> bool:
    return bool(getattr(tokenizer, "legacy", True))


def _tokenizers_ge_014() -> bool:
    try:
        import tokenizers
        from packaging import version

        return version.parse(tokenizers.__version__) >= version.parse("0.14")
    except Exception:
        return True  # modern environments


def preprocess_v1(
    sources: Sequence[Sequence[dict]],
    tokenizer,
    has_image: bool = False,
    conv_template=None,
) -> Dict[str, List[np.ndarray]]:
    """Vicuna-v1 ("USER:/ASSISTANT:") conversations -> input_ids + masked labels.

    Masking walks the prompt round by round (split on sep2 "</s>"): the
    instruction part of each round (up to "ASSISTANT: ") is ignored, the
    response tokens are supervised.
    """
    conv = (conv_template or conversation_lib.default_conversation).copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}

    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], "conversation roles must alternate"
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())

    if has_image:
        input_ids = [
            np.asarray(tokenizer_image_token(p, tokenizer), dtype=np.int64)
            for p in conversations
        ]
    else:
        input_ids = [
            np.asarray(tokenizer(p).input_ids[: tokenizer.model_max_length],
                       dtype=np.int64)
            for p in conversations
        ]
    targets = [ids.copy() for ids in input_ids]

    assert conv.sep_style == conversation_lib.SeparatorStyle.TWO

    off_by_one = not _tokenizer_is_legacy(tokenizer) and _tokenizers_ge_014()
    sep = conv.sep + conv.roles[1] + ": "
    for conversation, target in zip(conversations, targets):
        total_len = int((target != tokenizer.pad_token_id).sum())

        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            instruction = parts[0] + sep

            if has_image:
                round_len = len(tokenizer_image_token(rou, tokenizer))
                instruction_len = len(tokenizer_image_token(instruction, tokenizer)) - 2
            else:
                round_len = len(tokenizer(rou).input_ids)
                instruction_len = len(tokenizer(instruction).input_ids) - 2

            if i != 0 and off_by_one:
                round_len -= 1
                instruction_len -= 1

            target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX

        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(
                f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}. (ignored)"
            )

    return dict(input_ids=input_ids, labels=targets)


def _legacy_signal(header: str, source: Sequence[dict], roles) -> str:
    """'### Role: text\\n' formatting (ref train_utils.py:106-127)."""
    BEGIN, END = "### ", "\n"
    out = header
    for sentence in source:
        frm = sentence["from"].lower()
        role = roles[0] if frm == "human" else roles[1] if frm == "gpt" else "unknown"
        sentence["value"] = BEGIN + role + ": " + sentence["value"] + END
        out += sentence["value"]
    return out + BEGIN


def preprocess_legacy(
    sources: Sequence[Sequence[dict]], tokenizer
) -> Dict[str, List[np.ndarray]]:
    """Legacy '### ' conversation encoding (ref train_utils.py:131-158)."""
    conv = conversation_lib.default_conversation
    header = f"{conv.system}\n\n"
    conversations = []
    srcs = [copy.deepcopy(list(s)) for s in sources]
    for source in srcs:
        conversations.append(_legacy_signal(header, source, conv.roles))

    def tok_len(text):
        ids = tokenizer(text).input_ids[: tokenizer.model_max_length]
        return len(ids)

    input_ids = [
        np.asarray(tokenizer(c).input_ids[: tokenizer.model_max_length],
                   dtype=np.int64)
        for c in conversations
    ]
    targets = [ids.copy() for ids in input_ids]
    for target, source in zip(targets, srcs):
        lens = [tok_len(header)] + [tok_len(s["value"]) for s in source]
        speakers = [s["from"] for s in source]
        cur = lens[0]
        target[:cur] = IGNORE_INDEX
        for ln, spk in zip(lens[1:], speakers):
            if spk == "human":
                target[cur + 2 : cur + ln] = IGNORE_INDEX
            cur += ln
    return dict(input_ids=input_ids, labels=targets)


OMNI_SYSTEM = (
    "You are an artificial intelligence assistant, which gives helpful, "
    "detailed, and polite answers to the human's questions."
)


def omni_preprocess(
    sources: Sequence[Sequence[dict]],
    tokenizer,
    generation: bool = False,
) -> Dict[str, List[np.ndarray]]:
    """Zephyr chat-template tokenization with response-only label masking
    (ref: omnilmm/train/train_utils.py:50-150 — masks everything between
    '\\n<|user|>\\n' starts and '\\n<|assistant|>\\n' ends via template-token
    search; a missing template match masks the whole sample).
    """
    response_ids = tokenizer.encode("\n<|assistant|>\n", add_special_tokens=False)
    instruction_ids = tokenizer.encode("\n<|user|>\n", add_special_tokens=False)

    batch_input_ids, batch_labels = [], []
    for source in sources:
        turns = []
        prev_role = None
        for turn in source:
            role = turn.get("from", turn.get("role"))
            content = turn.get("value", turn.get("content"))
            role = {"human": "user", "gpt": "assistant"}.get(role, role)
            assert role in ("user", "assistant")
            assert role != prev_role, "roles must alternate"
            prev_role = role
            turns.append({"role": role, "content": content})
        if turns[0]["role"] != "system":
            turns.insert(0, {"role": "system", "content": OMNI_SYSTEM})

        text = tokenizer.apply_chat_template(
            turns, tokenize=False, add_generation_prompt=generation
        )
        if not generation:
            text = text.strip()

        ids = np.asarray(
            tokenizer(text).input_ids[: tokenizer.model_max_length],
            dtype=np.int64,
        )
        labels = ids.copy()

        def find_spans(needle):
            hits = []
            n = len(needle)
            for start in np.where(labels == needle[0])[0]:
                if labels[start : start + n].tolist() == needle:
                    hits.append(int(start))
            return hits

        response_starts = [h + len(response_ids) for h in find_spans(response_ids)]
        human_starts = find_spans(instruction_ids)

        if not response_starts or not human_starts:
            labels[:] = IGNORE_INDEX
        else:
            for idx, (h, r) in enumerate(zip(human_starts, response_starts)):
                if idx == 0:
                    labels[:r] = IGNORE_INDEX
                else:
                    labels[h:r] = IGNORE_INDEX
            if len(response_starts) < len(human_starts):
                labels[human_starts[-1]:] = IGNORE_INDEX

        batch_input_ids.append(ids)
        batch_labels.append(labels)
    return dict(input_ids=batch_input_ids, labels=batch_labels)


def encode_preference_sample(
    source: dict,
    tokenizer,
    multimodal_cfg: dict,
    preprocess_func=None,
) -> tuple:
    """One preference row -> (rej_dict, win_dict) with tokenized convs and the
    processed image (ref train_utils.py:198-263)."""
    if isinstance(source["chosen"], list):
        win_conv, rej_conv = source["chosen"], source["rejected"]
    else:
        win_conv = copy.deepcopy([source["question"], source["chosen"]])
        rej_conv = copy.deepcopy([source["question"], source["rejected"]])

    image = None
    if "image" in source:
        image = multimodal_cfg["image_processor"](source["image"])
        win_conv = expand_image_token(win_conv, multimodal_cfg)
        rej_conv = expand_image_token(rej_conv, multimodal_cfg)

    fn = preprocess_func or preprocess_v1
    rej = fn([rej_conv], tokenizer)
    win = fn([win_conv], tokenizer)
    rej_dict = dict(input_ids=rej["input_ids"][0], labels=rej["labels"][0])
    win_dict = dict(input_ids=win["input_ids"][0], labels=win["labels"][0])

    if image is not None:
        rej_dict["image"] = win_dict["image"] = image
    elif multimodal_cfg.get("is_multimodal"):
        size = multimodal_cfg.get("crop_size", 336)
        rej_dict["image"] = win_dict["image"] = np.zeros(
            (size, size, 3), dtype=np.float32
        )

    for key in ("ref_win_logp", "ref_win_avg_logp", "ref_win_per_token_logp"):
        if key in source:
            win_dict[key] = source[key]
    for key in ("ref_rej_logp", "ref_rej_avg_logp", "ref_rej_per_token_logp"):
        if key in source:
            rej_dict[key] = source[key]
    return rej_dict, win_dict
