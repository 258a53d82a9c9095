"""Character vocabulary for CTC decoding.

Behavioral parity with the reference tokenizer (reference:
``src/data/vocab.py:12-57``): 48 tokens with ``<pad>=0``, ``<blank>=1``,
``<unk>=2``; ``encode`` lowercases and maps unknown characters to ``<unk>``;
``decode`` drops blank (optionally) and pad.

The JSON on-disk format is identical to the reference's ``configs/vocab.json``
so indexes/checkpoints are interchangeable at the data level. This is the
port's own copy of ``ssd_tpu/data/vocab.py``: the two packages share no code.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np


@dataclass
class Vocab:
    tokens: List[str]
    pad_id: int = 0
    blank_id: int = 1
    unk_id: int = 2
    token_to_id: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.token_to_id:
            self.token_to_id = {t: i for i, t in enumerate(self.tokens)}

    # ------------------------------------------------------------------ io
    @classmethod
    def from_json(cls, path: Path | str) -> "Vocab":
        data = json.loads(Path(path).read_text())
        return cls(
            tokens=list(data["tokens"]),
            pad_id=int(data.get("pad_id", 0)),
            blank_id=int(data.get("blank_id", 1)),
            unk_id=int(data.get("unk_id", 2)),
        )

    def to_json(self, path: Path | str) -> None:
        payload = {
            "tokens": self.tokens,
            "pad_id": self.pad_id,
            "blank_id": self.blank_id,
            "unk_id": self.unk_id,
        }
        Path(path).write_text(json.dumps(payload, indent=2))

    # ------------------------------------------------------------- encode
    def encode(self, text: str) -> List[int]:
        unk = self.unk_id
        t2i = self.token_to_id
        return [t2i.get(ch, unk) for ch in text.lower()]

    def encode_np(self, text: str, max_len: int | None = None) -> np.ndarray:
        """Encode into a fixed-width int32 array padded with ``pad_id``."""
        ids = self.encode(text)
        if max_len is None:
            return np.asarray(ids, dtype=np.int32)
        out = np.full((max_len,), self.pad_id, dtype=np.int32)
        n = min(len(ids), max_len)
        out[:n] = ids[:n]
        return out

    # ------------------------------------------------------------- decode
    def decode(self, ids: Iterable[int], skip_blank: bool = True) -> str:
        out: List[str] = []
        n = len(self.tokens)
        for i in ids:
            i = int(i)
            if i == self.pad_id:
                continue
            if skip_blank and i == self.blank_id:
                continue
            if 0 <= i < n:
                out.append(self.tokens[i])
        return "".join(out)

    @property
    def size(self) -> int:
        return len(self.tokens)


DEFAULT_TOKENS: List[str] = (
    ["<pad>", "<blank>", "<unk>", " ", "'", ",", ".", "?", "!", "-", ";", ":"]
    + [str(d) for d in range(10)]
    + [chr(c) for c in range(ord("a"), ord("z") + 1)]
)


def default_vocab() -> Vocab:
    """The 48-token char vocab used by every config in the reference."""
    return Vocab(tokens=list(DEFAULT_TOKENS))
