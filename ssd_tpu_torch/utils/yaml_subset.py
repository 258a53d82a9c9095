"""A reader and a writer for the YAML subset the repository's configs are
written in.

The card machine has no ``pyyaml``, so the port reads and writes its own
YAML. The subset is what ``configs/*.yaml`` and ``configs/experiments/*.yaml``
use:

* block mappings by indentation, and ``- `` block sequences (of scalars,
  mappings or sequences; a sequence may sit at its key's own indentation);
* flow sequences ``[a, b]`` and flow mappings ``{k: v}`` on one line;
* full-line and trailing ``#`` comments;
* plain, single-quoted and double-quoted (without escapes) scalars on one
  line.

Plain scalars resolve as YAML 1.1 does under ``yaml.safe_load``: ``~`` /
``null`` / empty → ``None``; ``yes/no/true/false/on/off`` in lower, title or
upper case → bool; decimal, ``0x``, ``0b`` and leading-zero octal → int; a
float needs a dot (``7.5e-3`` and ``1.0e-2`` are floats, ``3e-4`` stays a
string) and a signed exponent, or is ``.inf`` / ``.nan``; anything else is a
string. Quoted scalars are always strings.

Everything outside the subset raises :class:`ValueError` naming the source
and line, never a guess: anchors, aliases, tags, block scalars (``|``,
``>``), directives, several documents, complex keys, escape sequences,
multi-line scalars and flow collections, sexagesimal numbers, timestamps
and merge keys.

:func:`write_yaml` writes block style, as ``yaml.safe_dump(data,
sort_keys=False)`` lays it out (mappings in insertion order, sequences at
their key's indentation, ``[]`` / ``{}`` when empty), and quotes every
string that would not read back as itself; both :func:`read_yaml` and
``yaml.safe_load`` read its output back as the data written.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, List, NamedTuple, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {
    form: value
    for word, value in (("yes", True), ("no", False), ("true", True), ("false", False),
                        ("on", True), ("off", False))
    for form in (word, word.title(), word.upper())
}
# pyyaml's YAML 1.1 resolvers (yaml/resolver.py), with its int and float forms
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+"
                  r"|[1-9][0-9_]*(?::[0-5]?[0-9])+)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?")
# characters that open a construct outside the subset where a node begins
_UNSUPPORTED = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
                ">": "a block scalar", "%": "a directive", "?": "a complex key",
                "@": "a reserved indicator", "`": "a reserved indicator"}


class _Line(NamedTuple):
    indent: int
    text: str
    no: int


def _resolve(text: str, where: str) -> Any:
    """A plain scalar's value under YAML 1.1's implicit resolvers."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text) or _FLOAT.fullmatch(text):
        if ":" in text:
            raise ValueError(f"{where}: sexagesimal number {text!r} is outside the YAML subset")
        value = text.replace("_", "")
        if _FLOAT.fullmatch(text):
            low = value.lower()
            if low.endswith(".inf"):
                return float("-inf") if low.startswith("-") else float("inf")
            return float("nan") if low.endswith(".nan") else float(value)
        sign = -1 if value.startswith("-") else 1
        digits = value.lstrip("+-")
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits != "0" and digits.startswith("0"):
            return sign * int(digits, 8)
        return sign * int(digits)
    if _TIMESTAMP.fullmatch(text) or text in ("<<", "="):
        raise ValueError(f"{where}: {text!r} resolves to a type outside the YAML subset")
    return text


class _Reader:
    def __init__(self, text: str, source: str) -> None:
        self.source = source
        self.lines: List[_Line] = []
        for no, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            if not body.strip() or body.startswith("#"):
                continue
            if body[0] == "\t":
                raise ValueError(f"{source}:{no}: a tab in the indentation")
            if body.rstrip() in ("---", "...") or body.startswith(("--- ", "... ")):
                if self.lines or body.rstrip() != "---" or len(body) != len(raw):
                    raise ValueError(f"{source}:{no}: several documents are outside the YAML subset")
                continue  # one leading document marker
            self.lines.append(_Line(len(raw) - len(body), body.rstrip(), no))
        self.i = 0

    def where(self, line: _Line) -> str:
        return f"{self.source}:{line.no}"

    def fail(self, line: _Line, msg: str):
        raise ValueError(f"{self.where(line)}: {msg}")

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.node()
        if self.i < len(self.lines):
            self.fail(self.lines[self.i], "unexpected indentation")
        return value

    # ------------------------------------------------------------ block
    def node(self) -> Any:
        line = self.lines[self.i]
        if _is_item(line.text):
            return self.sequence(line.indent)
        if self.split_key(line) is not None:
            return self.mapping(line.indent)
        self.i += 1
        return self.inline(line.text, line)

    def child(self, indent: int, same_indent_sequence: bool) -> Any:
        """The node below a ``key:`` or ``-`` with nothing after it."""
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > indent:
                return self.node()
            if same_indent_sequence and nxt.indent == indent and _is_item(nxt.text):
                return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines) and self.lines[self.i].indent == indent:
            line = self.lines[self.i]
            kv = self.split_key(line)
            if kv is None:
                self.fail(line, "expected a 'key: value' line of the mapping")
            key, rest = kv
            self.i += 1
            out[key] = self.inline(rest, line) if rest else self.child(indent, True)
        self.dedent(indent)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while (self.i < len(self.lines) and self.lines[self.i].indent == indent
               and _is_item(self.lines[self.i].text)):
            line = self.lines[self.i]
            rest = line.text[1:]
            body = rest.lstrip(" ")
            if not body or body.startswith("#"):
                self.i += 1
                out.append(self.child(indent, False))
            else:
                # the rest of the line is a node of its own at its column
                self.lines[self.i] = _Line(indent + 1 + len(rest) - len(body), body, line.no)
                out.append(self.node())
        self.dedent(indent)
        return out

    def dedent(self, indent: int) -> None:
        if self.i < len(self.lines) and self.lines[self.i].indent > indent:
            self.fail(self.lines[self.i], "unexpected indentation (a multi-line scalar?)")

    def split_key(self, line: _Line) -> Tuple[Any, str] | None:
        """``(key, rest)`` when the line is a ``key: …`` entry, else None."""
        text = line.text
        if text[0] in "'\"":
            key, end = self.quoted(text, 0, line)
            after = text[end:].lstrip(" ")
            if not after.startswith(":") or after[1:2] not in ("", " "):
                return None
            return key, _value_part(after[1:])
        if text[0] in "[{":
            return None
        end = text.find(": ")
        if end < 0:
            if not text.endswith(":"):
                return None
            end = len(text) - 1
        key = text[:end].rstrip(" ")
        if key[0] in _UNSUPPORTED:
            self.fail(line, f"{_UNSUPPORTED[key[0]]} is outside the YAML subset")
        if " #" in key:
            return None
        return _resolve(key, self.where(line)), _value_part(text[end + 1:])

    # ----------------------------------------------------------- inline
    def inline(self, text: str, line: _Line) -> Any:
        """A value written on one line: flow, quoted or plain."""
        c = text[0]
        if c in _UNSUPPORTED:
            self.fail(line, f"{_UNSUPPORTED[c]} is outside the YAML subset")
        if c in "[{'\"":
            value, end = self.flow(text, 0, line) if c in "[{" else self.quoted(text, 0, line)
            rest = text[end:].lstrip(" ")
            if rest and not rest.startswith("#"):
                self.fail(line, f"unexpected text after the value: {rest!r}")
            return value
        if _is_item(text):
            self.fail(line, "a sequence item cannot start here")
        plain = _cut_comment(text)
        if ": " in plain or plain.endswith(":"):
            self.fail(line, "a mapping cannot start inside a value")
        return _resolve(plain, self.where(line))

    def quoted(self, s: str, pos: int, line: _Line) -> Tuple[str, int]:
        q = s[pos]
        out, i = [], pos + 1
        while i < len(s):
            c = s[i]
            if q == "'" and c == "'":
                if s[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if q == '"' and c == '"':
                return "".join(out), i + 1
            if q == '"' and c == "\\":
                self.fail(line, "an escape sequence is outside the YAML subset")
            out.append(c)
            i += 1
        self.fail(line, "a quoted scalar that does not close on its line is outside the YAML subset")

    def flow(self, s: str, pos: int, line: _Line) -> Tuple[Any, int]:
        """A flow collection or scalar at ``s[pos]``: (value, end)."""
        pos = _skip(s, pos)
        if pos >= len(s) or s[pos] == "#":
            self.fail(line, "a flow collection that does not close on its line is outside the "
                      "YAML subset")
        c = s[pos]
        if c in "[{":
            close = "]" if c == "[" else "}"
            out: Any = [] if c == "[" else {}
            pos += 1
            while True:
                pos = _skip(s, pos)
                if pos < len(s) and s[pos] == close:
                    return out, pos + 1
                if c == "[":
                    value, pos = self.flow(s, pos, line)
                    if _skip(s, pos) < len(s) and s[_skip(s, pos)] == ":":
                        self.fail(line, "a mapping inside a flow sequence is outside the YAML subset")
                    out.append(value)
                else:
                    key, pos = self.flow(s, pos, line)
                    pos = _skip(s, pos)
                    value = None
                    if pos < len(s) and s[pos] == ":":
                        pos = _skip(s, pos + 1)
                        if pos < len(s) and s[pos] not in ",}":
                            value, pos = self.flow(s, pos, line)
                    out[key] = value
                pos = _skip(s, pos)
                if pos < len(s) and s[pos] == ",":
                    pos += 1
                elif pos >= len(s) or s[pos] != close:
                    self.fail(line, f"expected ',' or {close!r} in a flow collection")
        if c in "'\"":
            return self.quoted(s, pos, line)
        if c in _UNSUPPORTED:
            self.fail(line, f"{_UNSUPPORTED[c]} is outside the YAML subset")
        end = pos
        while end < len(s) and s[end] not in ",[]{}" and not (
                s[end] == ":" and (end + 1 == len(s) or s[end + 1] in " ,[]{}")) and not (
                s[end] == "#" and s[end - 1] == " "):
            end += 1
        text = s[pos:end].rstrip(" ")
        if not text and end < len(s) and s[end] != ":":
            self.fail(line, "an empty entry in a flow collection")
        return _resolve(text, self.where(line)), end


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _skip(s: str, pos: int) -> int:
    while pos < len(s) and s[pos] == " ":
        pos += 1
    return pos


def _cut_comment(text: str) -> str:
    cut = text.find(" #")
    return (text if cut < 0 else text[:cut]).rstrip(" ")


def _value_part(rest: str) -> str:
    rest = rest.strip(" ")
    return "" if rest.startswith("#") else rest


def read_yaml(text: str, source: str = "<string>") -> Any:
    """Parse ``text`` (the repository's YAML subset) as ``yaml.safe_load``
    would; ``source`` names it in errors."""
    return _Reader(text, source).document()


# plain (unquoted) strings the writer emits: printable ASCII that opens no
# construct and holds no comment, key or flow indicator
_PLAIN = re.compile(r"[A-Za-z0-9_./(=+~$^<\\][A-Za-z0-9_./()=+~$^<>;,\\ -]*")


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "." not in text and "e" in text:  # 1e-05 → 1.0e-05: YAML 1.1 floats need a dot
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, os.PathLike):
        value = os.fspath(value)
    if not isinstance(value, str):
        raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")
    if any(not c.isprintable() for c in value):
        raise ValueError(f"{value!r}: a string with control characters is outside the YAML subset")
    if _PLAIN.fullmatch(value) and not value.endswith(" "):
        try:
            if _resolve(value, "") == value:
                return value
        except ValueError:  # timestamps, '<<', '=': quoted below
            pass
    return "'" + value.replace("'", "''") + "'"


def _block(value: Any, indent: int, lines: List[str]) -> None:
    """Append the lines of a non-empty mapping or sequence at ``indent``."""
    pad = " " * indent
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_scalar(key)}:"
            if isinstance(item, dict) and item:
                lines.append(head)
                _block(item, indent + 2, lines)
            elif isinstance(item, (list, tuple)) and item:
                lines.append(head)
                _block(item, indent, lines)  # a sequence sits at its key's indentation
            else:
                lines.append(f"{head} {_inline(item)}")
        return
    for item in value:
        if isinstance(item, (dict, list, tuple)) and item:
            start = len(lines)
            _block(item, indent + 2, lines)
            lines[start] = f"{pad}- {lines[start][indent + 2:]}"
        else:
            lines.append(f"{pad}- {_inline(item)}")


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"  # only empty collections are written inline
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar(value)


def write_yaml(data: Any) -> str:
    """``data`` (dicts, lists, tuples, strings, paths, numbers, booleans and
    None) as block-style YAML text that :func:`read_yaml` and
    ``yaml.safe_load`` read back equal to it (tuples as lists, paths as
    strings). A string with a line break or another control character, and
    any other type, raises."""
    if isinstance(data, (dict, list, tuple)) and data:
        lines: List[str] = []
        _block(data, 0, lines)
        return "\n".join(lines) + "\n"
    return _inline(data) + "\n"
