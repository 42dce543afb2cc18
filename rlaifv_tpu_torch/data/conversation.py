# A copy of rlaifv_tpu/data/conversation.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Conversation prompt templates.

Produces byte-identical prompt strings to the reference templates
(ref: llava/conversation.py:32-130 `Conversation.get_prompt`, registry
:373-394; the muffin copy differs only in its default template,
muffin/conversation.py:373). Token-level parity of the whole framework
hinges on these strings, so the rendered output is kept exact; the
implementation here is a small registry of pure render functions instead
of the reference's enum-dispatched method.
"""
from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


def _msg_text(message) -> str:
    # Messages may be (text, image, mode) tuples in the chat UI path.
    if isinstance(message, tuple):
        return message[0]
    return message


def _render_single(conv: "Conversation") -> str:
    out = conv.system + conv.sep
    for role, message in conv.messages:
        if message:
            out += role + ": " + _msg_text(message) + conv.sep
        else:
            out += role + ":"
    return out


def _render_two(conv: "Conversation") -> str:
    seps = (conv.sep, conv.sep2)
    out = conv.system + seps[0]
    for i, (role, message) in enumerate(conv.messages):
        if message:
            out += role + ": " + _msg_text(message) + seps[i % 2]
        else:
            out += role + ":"
    return out


def _render_mpt(conv: "Conversation") -> str:
    out = conv.system + conv.sep
    for role, message in conv.messages:
        if message:
            out += role + _msg_text(message) + conv.sep
        else:
            out += role
    return out


def _render_plain(conv: "Conversation") -> str:
    seps = (conv.sep, conv.sep2)
    out = conv.system
    for i, (_, message) in enumerate(conv.messages):
        if message:
            out += _msg_text(message) + seps[i % 2]
    return out


def _render_llama2(conv: "Conversation") -> str:
    def wrap_sys(msg):
        return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg

    out = ""
    for i, (role, message) in enumerate(conv.messages):
        if i == 0:
            assert message, "first message should not be none"
            assert role == conv.roles[0], "first message should come from user"
        if not message:
            continue
        text = _msg_text(message)
        if i == 0:
            text = wrap_sys(conv.system) + text
        if i % 2 == 0:
            out += conv.sep + f"[INST] {text} [/INST]"
        else:
            out += " " + text + " " + conv.sep2
    return out.lstrip(conv.sep)


_RENDERERS = {
    SeparatorStyle.SINGLE: _render_single,
    SeparatorStyle.TWO: _render_two,
    SeparatorStyle.MPT: _render_mpt,
    SeparatorStyle.PLAIN: _render_plain,
    SeparatorStyle.LLAMA_2: _render_llama2,
}


@dataclasses.dataclass
class Conversation:
    """Prompt state machine: accumulate (role, message) rounds, render."""

    system: str
    roles: Tuple[str, str]
    messages: List[List]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def get_prompt(self) -> str:
        conv = self
        if conv.messages and isinstance(conv.messages[0][1], tuple):
            # First-round multimodal message: normalize to "<image>\n" prefix.
            conv = self.copy()
            role, msg = conv.messages[0]
            text = msg[0].replace(DEFAULT_IMAGE_TOKEN, "").strip()
            if "mmtag" in conv.version:
                conv.messages[0] = [role, text]
                conv.messages.insert(0, [conv.roles[0], "<Image><image></Image>"])
                conv.messages.insert(1, [conv.roles[1], "Received."])
            else:
                conv.messages[0] = [role, DEFAULT_IMAGE_TOKEN + "\n" + text]
        return _RENDERERS[conv.sep_style](conv)

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=tuple(self.roles),
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self) -> dict:
        return {
            "system": self.system,
            "roles": list(self.roles),
            "messages": [[r, _msg_text(m)] for r, m in self.messages],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


DEFAULT_IMAGE_TOKEN = "<image>"

conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[
        [
            "Human",
            "What are the key differences between renewable and non-renewable energy sources?",
        ],
        [
            "Assistant",
            "Renewable energy sources are those that can be replenished naturally in a relatively "
            "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
            "Non-renewable energy sources, on the other hand, are finite and will eventually be "
            "depleted, such as coal, oil, and natural gas. Here are some key differences between "
            "renewable and non-renewable energy sources:\n"
            "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
            "energy sources are finite and will eventually run out.\n"
            "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
            "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
            "and other negative effects.\n"
            "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
            "have lower operational costs than non-renewable sources.\n"
            "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
            "locations than non-renewable sources.\n"
            "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
            "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
            "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
            "non-renewable sources are not, and their depletion can lead to economic and social instability.\n",
        ],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = Conversation(
    system="""<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "llava_v1": conv_llava_v1,
    "mpt": conv_mpt,
}

# The DPO training pipeline renders prompts with llava_v1
# (ref: muffin/conversation.py:373 sets default_conversation = conv_llava_v1).
default_conversation = conv_llava_v1
