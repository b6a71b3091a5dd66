"""A small YAML reader for the dialect the repo's configs are written in.

The card's machine has no PyYAML, so the port reads its configs, run
snapshots and prompt banks with this.  It covers what those files use:
block mappings and block sequences (also the indentless ``key:\\n- item``
form that PyYAML's dumper writes), ``- key: value`` items, flow lists and
flow maps (``[768, 512]``, ``{}``), single- and double-quoted scalars and
keys, comments, plain scalars folded over several lines, and PyYAML's
implicit types: null, YAML 1.1 booleans, ints, and floats under the YAML 1.2
rule of ``mmgclip_tpu/config/compose.py`` (``5e-5`` is a float).  Anchors,
tags, block scalars (``|``, ``>``) and multi-document streams raise.
``dump`` writes a config back (the run snapshot) in that dialect.
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Tuple

_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_KEY = re.compile(r"""^('(?:[^']|'')*'|"(?:[^"\\]|\\.)*"|[^'"\[\]{}\s#][^#]*?)\s*:(?:\s|$)""")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


class YamlError(ValueError):
    pass


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    t = t.lstrip("+-")
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if len(t) > 1 and t.startswith("0"):
        return sign * int(t, 8)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith(".inf"):
        return float("-inf") if t.startswith("-") else float("inf")
    if t.endswith(".nan"):
        return float("nan")
    return float(t)


def plain_scalar(text: str) -> Any:
    """Resolve a plain (unquoted) scalar to its implicit type."""
    if text in _NULLS:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


def _strip_comment(line: str) -> str:
    """Drop a trailing ``# comment`` that is outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if quote == '"' and ch == "\\":
                i += 2
                continue
            if ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _unquote(text: str) -> str:
    if text[0] == "'":
        return text[1:-1].replace("''", "'")
    out = []
    i = 1
    while i < len(text) - 1:
        ch = text[i]
        if ch == "\\":
            nxt = text[i + 1]
            if nxt == "x":
                out.append(chr(int(text[i + 2:i + 4], 16)))
                i += 4
                continue
            if nxt == "u":
                out.append(chr(int(text[i + 2:i + 6], 16)))
                i += 6
                continue
            if nxt == "U":
                out.append(chr(int(text[i + 2:i + 10], 16)))
                i += 10
                continue
            if nxt not in _ESCAPES:
                raise YamlError(f"unknown escape \\{nxt} in {text!r}")
            out.append(_ESCAPES[nxt])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _quoted_end(text: str, start: int) -> int:
    """Index just past the quoted scalar starting at ``text[start]``."""
    quote = text[start]
    i = start + 1
    while i < len(text):
        if quote == '"' and text[i] == "\\":
            i += 2
            continue
        if text[i] == quote:
            if quote == "'" and text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        i += 1
    raise YamlError(f"unterminated quoted scalar: {text!r}")


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """Parse one flow node at ``text[i]``; returns (value, index after it)."""
    while i < len(text) and text[i] == " ":
        i += 1
    if i >= len(text):
        return None, i
    ch = text[i]
    if ch in "[{":
        close = "]" if ch == "[" else "}"
        items: List[Any] = []
        mapping = {}
        i += 1
        while True:
            while i < len(text) and text[i] in " ,":
                i += 1
            if i >= len(text):
                raise YamlError(f"unterminated flow collection: {text!r}")
            if text[i] == close:
                return (items if ch == "[" else mapping), i + 1
            if ch == "[":
                value, i = _flow(text, i)
                items.append(value)
            else:
                key, i = _flow(text, i)
                while i < len(text) and text[i] == " ":
                    i += 1
                if i < len(text) and text[i] == ":":
                    value, i = _flow(text, i + 1)
                else:
                    value = None
                mapping[key] = value
    if ch in "'\"":
        end = _quoted_end(text, i)
        return _unquote(text[i:end]), end
    j = i
    while j < len(text) and text[j] not in ",]}":
        if text[j] == ":" and (j + 1 == len(text) or text[j + 1] in " ,]}"):
            break
        j += 1
    return plain_scalar(text[i:j].strip()), j


def _scalar(text: str) -> Any:
    """A block-context value written on one (joined) line."""
    if text[0] in "[{":
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise YamlError(f"trailing text after flow collection: {text!r}")
        return value
    if text[0] in "'\"":
        end = _quoted_end(text, 0)
        if text[end:].strip():
            raise YamlError(f"trailing text after quoted scalar: {text!r}")
        return _unquote(text)
    if text[0] in "&*!|>%@`":
        raise YamlError(f"unsupported YAML construct: {text!r}")
    return plain_scalar(text)


class _Parser:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if raw.strip() in ("---", "..."):
                if self.lines:
                    raise YamlError("multi-document streams are not supported")
                continue
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YamlError("tab indentation is not YAML")
            line = _strip_comment(raw)
            if line.strip():
                self.lines.append((len(line) - len(line.lstrip(" ")), line.strip()))

    def parse(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0][0])
        if i != len(self.lines):
            raise YamlError(f"unexpected content: {self.lines[i][1]!r}")
        return value

    @staticmethod
    def _is_item(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        content = self.lines[i][1]
        if self._is_item(content):
            return self.sequence(i, indent)
        if _KEY.match(content):
            return self.mapping(i, indent)
        return self.multiline_scalar(i, indent - 1)

    def multiline_scalar(self, i: int, parent: int) -> Tuple[Any, int]:
        """A scalar starting at line ``i`` plus its more-indented continuation
        lines (plain and quoted scalars fold line breaks into spaces)."""
        parts = [self.lines[i][1]]
        i += 1
        while i < len(self.lines) and self.lines[i][0] > parent:
            parts.append(self.lines[i][1])
            i += 1
        return _scalar(" ".join(parts)), i

    def value_after(self, rest: str, i: int, indent: int, allow_same_indent_seq: bool):
        """The value of a ``key:`` or ``-`` whose inline text is ``rest``;
        line ``i`` is the line after it."""
        if rest:
            parts = [rest]
            while i < len(self.lines) and self.lines[i][0] > indent:
                parts.append(self.lines[i][1])
                i += 1
            return _scalar(" ".join(parts)), i
        if i < len(self.lines):
            nxt_indent, nxt = self.lines[i]
            if nxt_indent > indent:
                return self.block(i, nxt_indent)
            if allow_same_indent_seq and nxt_indent == indent and self._is_item(nxt):
                return self.sequence(i, indent)
        return None, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines) and self.lines[i][0] == indent:
            content = self.lines[i][1]
            if self._is_item(content):
                break
            match = _KEY.match(content)
            if not match:
                raise YamlError(f"expected 'key: value', got {content!r}")
            key_text = match.group(1)
            key = _unquote(key_text) if key_text[0] in "'\"" else plain_scalar(key_text)
            rest = content[match.end():].strip()
            out[key], i = self.value_after(rest, i + 1, indent, True)
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise YamlError(f"bad indentation at {self.lines[i][1]!r}")
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out: list = []
        while i < len(self.lines) and self.lines[i][0] == indent:
            content = self.lines[i][1]
            if not self._is_item(content):
                break
            rest = content[1:].lstrip(" ")
            if rest and (self._is_item(rest) or (_KEY.match(rest) and rest[0] not in "[{")):
                # "- key: value" / "- - item" open a mapping / sequence whose
                # entries sit at the column of `key` / of the inner dash
                column = indent + (len(content) - len(rest))
                self.lines[i] = (column, rest)
                value, i = self.block(i, column)
            else:
                value, i = self.value_after(rest, i + 1, indent, False)
            out.append(value)
        return out, i


def load(text: str) -> Any:
    """Parse YAML text of the supported dialect."""
    return _Parser(text).parse()


def load_file(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as fh:
        return load(fh.read())


# ----------------------------------------------------------------------
# writer: block mappings, flow lists of scalars, strings double-quoted, in
# a form both this reader and PyYAML's safe loader read back to equal data

_PLAIN_KEY = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-/]*$")


def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if value is True or value is False:
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "e" in text and "." not in text:  # YAML 1.1 floats need the dot: 1.0e-20
            text = text.replace("e", ".0e", 1)
        return text if "." in text else text + ".0"
    if isinstance(value, str):
        return json.dumps(value)  # JSON escapes are YAML double-quoted escapes
    raise YamlError(f"cannot dump {type(value).__name__}")


def _dump_key(key: Any) -> str:
    text = str(key)
    return text if _PLAIN_KEY.match(text) and plain_scalar(text) == text else json.dumps(text)


def _dump_block(node: Any, indent: int, lines: List[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for key, value in node.items():
            head = f"{pad}{_dump_key(key)}:"
            if isinstance(value, (dict, list)) and value and not _flat_list(value):
                lines.append(head)
                _dump_block(value, indent + 2, lines)
            else:
                lines.append(f"{head} {_dump_inline(value)}")
    else:
        for item in node:
            if isinstance(item, (dict, list)) and item and not _flat_list(item):
                lines.append(f"{pad}-")
                _dump_block(item, indent + 2, lines)
            else:
                lines.append(f"{pad}- {_dump_inline(item)}")


def _flat_list(value: Any) -> bool:
    return isinstance(value, list) and not any(isinstance(v, (dict, list)) for v in value)


def _dump_inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[" + ", ".join(_dump_scalar(v) for v in value) + "]"
    return _dump_scalar(value)


def dump(data: Any) -> str:
    """A mapping of mappings, lists and scalars -> YAML text."""
    if not isinstance(data, dict):
        raise YamlError("dump takes a mapping")
    lines: List[str] = []
    _dump_block(data, 0, lines)
    return "\n".join(lines) + "\n"
