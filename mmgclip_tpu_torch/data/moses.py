"""The English Moses word split, without ``sacremoses``.

Equal to ``sacremoses.MosesTokenizer(lang="en").tokenize(text,
aggressive_dash_splits=True, return_str=False, escape=True)``, the word split
under the JAX package's Moses+BPE tokenizer (BioGPT's fairseq scheme): the
same chain of substitutions in the same order, over the same character
classes, which ``moses_tables.py`` carries as code-point ranges (Perl's
Unicode properties, not Python's ``unicodedata`` categories).
"""

from __future__ import annotations

import bisect
import re
from functools import lru_cache
from typing import List, Sequence

from . import moses_tables


def char_class(ranges: Sequence[int]) -> str:
    """Flat (first, last, ...) code-point ranges -> the body of a regex class."""
    parts = []
    for first, last in zip(ranges[::2], ranges[1::2]):
        a = re.escape(chr(first))
        parts.append(a if first == last else f"{a}-{re.escape(chr(last))}")
    return "".join(parts)


def in_ranges(ranges: Sequence[int], char: str) -> bool:
    """Whether ``char`` lies in one of the flat inclusive ranges."""
    code = ord(char)
    i = bisect.bisect_right(ranges, code)
    return i % 2 == 1 or (i > 0 and ranges[i - 1] == code)


IS_N = char_class(moses_tables.ISN)
IS_ALNUM = char_class(moses_tables.ISALNUM)
IS_ALPHA = char_class(moses_tables.ISALPHA)

DEDUPLICATE_SPACE = re.compile(r"\s+"), r" "
ASCII_JUNK = re.compile(r"[\000-\037]"), r""
PAD_NOT_ISALNUM = re.compile(r"([^{}\s\.'\`\,\-])".format(IS_ALNUM)), r" \1 "
AGGRESSIVE_HYPHEN_SPLIT = re.compile(r"([{a}])\-(?=[{a}])".format(a=IS_ALNUM)), r"\1 @-@ "
COMMA_SEPARATE = (
    (re.compile(r"([^{}])[,]".format(IS_N)), r"\1 , "),
    (re.compile(r"[,]([^{}])".format(IS_N)), r" , \1"),
    (re.compile(r"([{}])[,]$".format(IS_N)), r"\1 , "),
)
ENGLISH_APOSTROPHE = (
    (re.compile(r"([^{a}])[']([^{a}])".format(a=IS_ALPHA)), r"\1 ' \2"),
    (re.compile(r"([^{a}{n}])[']([{a}])".format(a=IS_ALPHA, n=IS_N)), r"\1 ' \2"),
    (re.compile(r"([{a}])[']([^{a}])".format(a=IS_ALPHA)), r"\1 ' \2"),
    (re.compile(r"([{a}])[']([{a}])".format(a=IS_ALPHA)), r"\1 '\2"),
    (re.compile(r"([{n}])[']([s])".format(n=IS_N)), r"\1 '\2"),
)
TRAILING_DOT_APOSTROPHE = re.compile(r"\.' ?$"), " . ' "
ESCAPE_XML = (
    (re.compile(r"&"), r"&amp;"),
    (re.compile(r"\|"), r"&#124;"),
    (re.compile(r"<"), r"&lt;"),
    (re.compile(r">"), r"&gt;"),
    (re.compile(r"\'"), r"&apos;"),
    (re.compile(r"\""), r"&quot;"),
    (re.compile(r"\["), r"&#91;"),
    (re.compile(r"]"), r"&#93;"),
)
NONBREAKING_PREFIXES = frozenset(moses_tables.NONBREAKING_PREFIXES_EN)
NUMERIC_ONLY_PREFIXES = frozenset(
    w.rpartition(" ")[0] for w in moses_tables.NONBREAKING_PREFIXES_EN
    if re.search(r"[\s]+(\#NUMERIC_ONLY\#)", w))
_TOKEN_ENDS_WITH_PERIOD = re.compile(r"^(\S+)\.$")
_LEADING_DIGITS = re.compile(r"^[0-9]+")


def _replace_multidots(text: str) -> str:
    text = re.sub(r"\.([\.]+)", r" DOTMULTI\1", text)
    dotmulti = re.compile(r"DOTMULTI\.")
    while dotmulti.search(text):
        text = re.sub(r"DOTMULTI\.([^\.])", r"DOTDOTMULTI \1", text)
        text = dotmulti.sub("DOTDOTMULTI", text)
    return text


def _restore_multidots(text: str) -> str:
    dotmulti = re.compile(r"DOTDOTMULTI")
    while dotmulti.search(text):
        text = dotmulti.sub(r"DOTMULTI.", text)
    return re.sub(r"DOTMULTI", r".", text)


def _is_lower(char: str) -> bool:
    return in_ranges(moses_tables.ISLOWER, char)


def _any_alpha(text: str) -> bool:
    return any(in_ranges(moses_tables.ISALPHA, c) for c in text)


def _handle_nonbreaking_prefixes(text: str) -> str:
    tokens = text.split()
    last = len(tokens) - 1
    for i, token in enumerate(tokens):
        ends_with_period = _TOKEN_ENDS_WITH_PERIOD.search(token)
        if not ends_with_period:
            continue
        prefix = ends_with_period.group(1)
        if (("." in prefix and _any_alpha(prefix))
                or (prefix in NONBREAKING_PREFIXES and prefix not in NUMERIC_ONLY_PREFIXES)
                or (i != last and tokens[i + 1] and _is_lower(tokens[i + 1][0]))):
            continue
        if prefix in NUMERIC_ONLY_PREFIXES and i < last and _LEADING_DIGITS.search(tokens[i + 1]):
            continue
        tokens[i] = prefix + " ."
    return " ".join(tokens)


@lru_cache(maxsize=65536)
def _tokenize(text: str) -> tuple:
    for regexp, substitution in (DEDUPLICATE_SPACE, ASCII_JUNK):
        text = regexp.sub(substitution, text)
    text = text.strip()
    for regexp, substitution in (PAD_NOT_ISALNUM, AGGRESSIVE_HYPHEN_SPLIT):
        text = regexp.sub(substitution, text)
    text = _replace_multidots(text)
    for regexp, substitution in COMMA_SEPARATE + ENGLISH_APOSTROPHE:
        text = regexp.sub(substitution, text)
    text = _handle_nonbreaking_prefixes(text)
    text = DEDUPLICATE_SPACE[0].sub(DEDUPLICATE_SPACE[1], text).strip()
    text = TRAILING_DOT_APOSTROPHE[0].sub(TRAILING_DOT_APOSTROPHE[1], text)
    text = _restore_multidots(text)
    for regexp, substitution in ESCAPE_XML:
        text = regexp.sub(substitution, text)
    return tuple(text.split())


def moses_tokenize(text: str) -> List[str]:
    """English Moses word split with aggressive dash splits and XML escapes."""
    return list(_tokenize(str(text)))
