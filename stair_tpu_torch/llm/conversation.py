"""Conversation state and prompt templates for the Video-ChatGPT demo/eval.

Compact equivalent of the reference's conversation machinery
(yellow-binary-tree/STAIR ``video_chatgpt/video_conversation.py``): a
Conversation dataclass accumulating (role, message) turns, rendered with
either the two-separator Vicuna-v1 style or the single-separator style, plus
the registered templates the inference scripts select with ``--conv-mode``.
"""

from __future__ import annotations

import dataclasses
import enum


class SeparatorStyle(enum.Enum):
    SINGLE = 1
    TWO = 2


@dataclasses.dataclass
class Conversation:
    system: str
    roles: tuple
    messages: list
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = "</s>"

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, message in self.messages:
                if message:
                    out += role + ": " + message + self.sep
                else:
                    out += role + ":"
            return out
        seps = [self.sep, self.sep2]
        out = self.system + seps[0]
        for i, (role, message) in enumerate(self.messages):
            if message:
                out += role + ": " + message + seps[i % 2]
            else:
                out += role + ":"
        return out

    def append_message(self, role, message):
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[list(m) for m in self.messages],
            offset=self.offset, sep_style=self.sep_style,
            sep=self.sep, sep2=self.sep2,
        )

    @property
    def stop_str(self) -> str:
        return self.sep if self.sep_style == SeparatorStyle.SINGLE else self.sep2


conv_video_chatgpt_v1 = Conversation(
    system=(
        "You are Video-ChatGPT, a large vision-language assistant. "
        "You are able to understand the video content that the user "
        "provides, and assist the user with a variety of tasks using "
        "natural language."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_simple_v1 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_templates = {
    "video-chatgpt_v1": conv_video_chatgpt_v1,
    "simple": conv_simple_v1,
}
