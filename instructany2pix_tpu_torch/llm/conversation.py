"""Conversation prompt templating.

Behavioral parity with reference llm/conversation.py:15-104 for the
separator styles the framework uses (vicuna_v1 TWO style is the live
path — reference pipeline.py:176-182; PLAIN backs the plain_gen
training preprocessor, reference train.py:259-346). Implementation is
fresh; only the template *strings* (system prompts, roles, separators)
are preserved since they are the model's prompt format.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def get_prompt(self) -> str:
        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            parts = [self.system + self.sep]
            for role, msg in self.messages:
                parts.append(f"{role}: {msg}{self.sep}" if msg else f"{role}:")
            return "".join(parts)
        if style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            parts = [self.system + seps[0]]
            for i, (role, msg) in enumerate(self.messages):
                parts.append(f"{role}: {msg}{seps[i % 2]}" if msg else f"{role}:")
            return "".join(parts)
        if style == SeparatorStyle.MPT:
            parts = [self.system + self.sep]
            for role, msg in self.messages:
                parts.append(f"{role}{msg}{self.sep}" if msg else role)
            return "".join(parts)
        if style == SeparatorStyle.PLAIN:
            seps = (self.sep, self.sep2)
            parts = [self.system]
            for i, (_, msg) in enumerate(self.messages):
                parts.append(f"{msg}{seps[i % 2]}" if msg else "")
            return "".join(parts)
        if style == SeparatorStyle.LLAMA_2:
            out = ""
            for i, (role, msg) in enumerate(self.messages):
                if not msg:
                    continue
                if i == 0:
                    msg = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" + msg
                if i % 2 == 0:
                    out += f"{self.sep}[INST] {msg} [/INST]"
                else:
                    out += f" {msg} {self.sep2}"
            return out.lstrip(self.sep)
        raise ValueError(style)

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[list(m) for m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )


conv_vicuna_v1 = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    sep2="\n",
    version="plain",
)

# Registry parity with reference conversation.py:361-374 — only
# vicuna_v1 is live in the pipeline (reference pipeline.py:176), but
# checkpoints fine-tuned with other chat formats select these by name
# (reference train.py `version` arg). The template STRINGS are the
# models' prompt formats and must match byte-for-byte; the v0 template
# carries two worked example messages as its preamble (offset=2).

_V0_EXAMPLE_Q = (
    "What are the key differences between renewable and non-renewable energy sources?"
)
_V0_EXAMPLE_A = (
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
    "non-renewable sources are not, and their depletion can lead to economic and social instability.\n"
)

conv_vicuna_v0 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    messages=[["Human", _V0_EXAMPLE_Q], ["Assistant", _V0_EXAMPLE_A]],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llama_2 = Conversation(
    system=(
        "You are a helpful, respectful and honest assistant. Always answer as "
        "helpfully as possible, while being safe.  Your answers should not include any "
        "harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please "
        "ensure that your responses are socially unbiased and positive in nature.\n\n"
        "If a question does not make any sense, or is not factually coherent, explain why "
        "instead of answering something not correct. If you don't know the answer to a "
        "question, please don't share false information."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_llava_llama_2 = Conversation(
    system=(
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_mpt = Conversation(
    system=(
        "<|im_start|>system\n"
        "A conversation between a user and an LLM-based AI assistant. "
        "The assistant gives helpful and honest answers."
    ),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
    version="mpt",
)

conv_llava_v0 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>."
)

conv_llava_v0_mmtag = Conversation(
    system=_MMTAG_SYSTEM,
    roles=("Human", "Assistant"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llava_v1_mmtag = Conversation(
    system=_MMTAG_SYSTEM,
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
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
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}


def default_conversation() -> Conversation:
    return conv_vicuna_v1.copy()
