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
``dump`` writes a config back (the run snapshot) as PyYAML's ``safe_dump``
writes it (two deviations, listed at the writer).
"""

from __future__ import annotations

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
# writer: the text PyYAML's ``safe_dump(data, sort_keys=False)`` writes
# (the JAX package's run snapshot), for mappings, lists and scalars: block
# mappings and sequences (indentless under a key), ``{}`` / ``[]`` when
# empty, PyYAML's choice among plain, single- and double-quoted scalars, and
# plain scalars folded at column 80.  Two deviations keep every string
# reading back as written under this reader and the JAX loader: a string
# whose plain form they resolve to another type (``5e-5``, a YAML 1.2
# float) is single-quoted, and a quoted string is never folded (a string
# with a line break is double-quoted on one line).

_PYYAML_IMPLICIT = re.compile(r"""^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE
    |on|On|ON|off|Off|OFF
    |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)
    |[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
    |<<|~|null|Null|NULL|=
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]\ -[0-9][0-9]?\ -[0-9][0-9]?(?:[Tt]|[\ \t]+)[0-9][0-9]?
     :[0-9][0-9]\ :[0-9][0-9]\ (?:\.[0-9]*)?(?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                              re.X)
_BREAKS = "\n\x85\u2028\u2029"
_WHITESPACE = "\0 \t\r" + _BREAKS
_ESCAPED = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n", "\x0B": "v",
            "\x0C": "f", "\x0D": "r", "\x1B": "e", '"': '"', "\\": "\\", "\x85": "N",
            "\xA0": "_", "\u2028": "L", "\u2029": "P"}


def _scalar_text(value: Any) -> Tuple[str, bool]:
    """PyYAML's representation of a scalar -> (text, plain form allowed)."""
    if value is None:
        return "null", True
    if value is True or value is False:
        return ("true" if value else "false"), True
    if isinstance(value, int):
        return str(value), True
    if isinstance(value, float):
        if value != value:
            return ".nan", True
        if value in (float("inf"), float("-inf")):
            return (".inf" if value > 0 else "-.inf"), True
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, True
    if isinstance(value, str):
        return value, (value != "" and not _PYYAML_IMPLICIT.match(value)
                       and plain_scalar(value) == value)
    raise YamlError(f"cannot dump {type(value).__name__}")


def _analyse(text: str) -> dict:
    """PyYAML's ``Emitter.analyze_scalar`` (``allow_unicode`` off)."""
    if not text:
        return {"empty": True, "multiline": False, "block_plain": True, "single": True}
    block_ind = flow_ind = text.startswith("---") or text.startswith("...")
    line_breaks = special = False
    leading = trailing = break_space = space_break = False
    prev_space = prev_break = False
    preceded = True
    followed = len(text) == 1 or text[1] in _WHITESPACE
    for index, ch in enumerate(text):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                flow_ind = block_ind = True
            if ch in "?:":
                flow_ind = True
                block_ind = block_ind or followed
            if ch == "-" and followed:
                flow_ind = block_ind = True
        else:
            if ch in ",?[]{}":
                flow_ind = True
            if ch == ":":
                flow_ind = True
                block_ind = block_ind or followed
            if ch == "#" and preceded:
                flow_ind = block_ind = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
            special = True
        if ch == " ":
            leading = leading or index == 0
            trailing = trailing or index == len(text) - 1
            break_space = break_space or prev_break
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            leading = leading or index == 0
            trailing = trailing or index == len(text) - 1
            space_break = space_break or prev_space
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded = ch in _WHITESPACE
        followed = index + 2 >= len(text) or text[index + 2] in _WHITESPACE
    block_plain = not (leading or trailing or break_space or space_break or special
                       or line_breaks or block_ind)
    single = not (break_space or space_break or special)
    return {"empty": False, "multiline": line_breaks, "block_plain": block_plain,
            "single": single}


class _Emitter:
    """PyYAML's block emitter over Python data (no anchors, tags or flow
    collections with items)."""

    WIDTH = 80

    def __init__(self):
        self.out: List[str] = []
        self.column = 0
        self.whitespace = self.indention = True
        self.indent = None
        self.indents: List[Any] = []

    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def indicator(self, text: str, need_whitespace: bool, whitespace: bool = False,
                  indention: bool = False) -> None:
        self.write(text if self.whitespace or not need_whitespace else " " + text)
        self.whitespace = whitespace
        self.indention = self.indention and indention

    def line_break(self) -> None:
        self.out.append("\n")
        self.whitespace = self.indention = True
        self.column = 0

    def write_indent(self) -> None:
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def increase_indent(self, flow: bool = False, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = 2 if flow else 0
        elif not indentless:
            self.indent += 2

    def node(self, value: Any, mapping: bool = False, simple_key: bool = False) -> None:
        if isinstance(value, (dict, list)) and not value:
            opening, closing = ("{", "}") if isinstance(value, dict) else ("[", "]")
            self.indicator(opening, True, whitespace=True)
            self.indicator(closing, False)
        elif isinstance(value, dict):
            self.increase_indent()
            for key, item in value.items():
                self.write_indent()
                text, plain = _scalar_text(key)
                analysis = _analyse(text)
                if len(text) >= 128 or analysis["empty"] or analysis["multiline"]:
                    raise YamlError(f"cannot dump the complex key {key!r}")
                self.scalar(text, plain, analysis, simple_key=True)
                self.indicator(":", False)
                self.node(item, mapping=True)
            self.indent = self.indents.pop()
        elif isinstance(value, list):
            self.increase_indent(indentless=mapping and not self.indention)
            for item in value:
                self.write_indent()
                self.indicator("-", True, indention=True)
                self.node(item)
            self.indent = self.indents.pop()
        else:
            text, plain = _scalar_text(value)
            self.scalar(text, plain, _analyse(text), simple_key)

    def scalar(self, text: str, plain: bool, analysis: dict, simple_key: bool) -> None:
        self.increase_indent(flow=True)
        if plain and analysis["block_plain"] and not (simple_key and analysis["empty"]):
            self.plain(text, split=not simple_key)
        elif analysis["single"] and not analysis["multiline"]:
            self.indicator("'", True)
            self.write(text.replace("'", "''"))
            self.indicator("'", False)
        else:
            self.indicator('"', True)
            for ch in text:
                if ch in _ESCAPED:
                    self.write("\\" + _ESCAPED[ch])
                elif "\x20" <= ch <= "\x7E":
                    self.write(ch)
                elif ch <= "\xFF":
                    self.write("\\x%02X" % ord(ch))
                elif ch <= "\uFFFF":
                    self.write("\\u%04X" % ord(ch))
                else:
                    self.write("\\U%08X" % ord(ch))
            self.indicator('"', False)
        self.indent = self.indents.pop()

    def plain(self, text: str, split: bool) -> None:
        """PyYAML's ``write_plain`` for a scalar without line breaks: a
        single space past column 80 becomes a line break and the indent."""
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        start = 0
        spaces = False
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > self.WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            spaces = ch == " "


def dump(data: Any) -> str:
    """A mapping of mappings, lists and scalars -> the YAML text PyYAML's
    ``safe_dump(data, sort_keys=False)`` writes (see the deviations above)."""
    if not isinstance(data, dict):
        raise YamlError("dump takes a mapping")
    emitter = _Emitter()
    emitter.node(data)
    emitter.write_indent()
    return "".join(emitter.out)
