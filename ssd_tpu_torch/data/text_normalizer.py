"""Transcript normalization (the port's own copy of
``ssd_tpu/data/text_normalizer.py``; the two packages share no code).

Behavioral parity with the reference normalizer
(``src/data/text_normalizer.py:27-38``): smart-quote/dash replacement, NFKC,
non-ASCII removal, leading Roman-numeral / numbered heading removal,
whitespace collapse, lowercase. Bit-exact output parity is required because
both CER scoring and the MD5 split hashing consume normalized transcripts.
"""

from __future__ import annotations

import re
import unicodedata

_UNICODE_MAP = str.maketrans(
    {
        "“": '"',  # left double quote
        "”": '"',  # right double quote
        "‘": "'",  # left single quote
        "’": "'",  # right single quote
        "–": "-",  # en dash
        "—": "-",  # em dash
        "⁇": "?",  # double question mark
        "\xa0": " ",  # non-breaking space
    }
)

_LEADING_HEADING = re.compile(r"^(?:[ivxlcdm]+\.|\d+\.)\s+", re.IGNORECASE)
_NON_ASCII = re.compile(r"[^\x00-\x7F]+")
_WS = re.compile(r"\s+")


def normalize_transcript(text: str | None) -> str:
    """Normalize a raw transcript to lowercase ASCII suitable for the vocab."""
    if text is None:
        return ""
    s = str(text).translate(_UNICODE_MAP)
    s = unicodedata.normalize("NFKC", s)
    s = _NON_ASCII.sub(" ", s)
    s = _LEADING_HEADING.sub("", s)
    s = _WS.sub(" ", s)
    return s.strip().lower()
