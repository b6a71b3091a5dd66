"""The WordPiece vocabulary file both sides tokenize with.

Bio_ClinicalBERT's own ``vocab.txt`` is not in the repository, so the
benchmark writes a vocabulary of the published size (28,996 entries): the
five specials at BERT's ids, every printable ASCII character alone and as a
``##`` continuation, the words of the given sentences, then ``[unusedN]``
filler.  The port reads it through ``Tokenizer.from_pretrained(<path>)``
(its local ``vocab.txt`` path) and the reference through its own WordPiece
(``reference/text.py``), so the ids come from a raw file that both read.
"""

from __future__ import annotations

import re
from typing import Iterable, List

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def vocabulary(sentences: Iterable[str], size: int) -> List[str]:
    tokens = list(SPECIALS)
    seen = set(tokens)

    def add(token: str) -> None:
        if token not in seen:
            seen.add(token)
            tokens.append(token)

    for code in range(33, 127):
        add(chr(code).lower())
    for code in range(33, 127):
        if chr(code).isalnum():
            add("##" + chr(code).lower())
    for sentence in sentences:
        for word in re.findall(r"[a-z0-9]+", sentence.lower()):
            add(word)
    if len(tokens) > size:
        raise ValueError(f"{len(tokens)} tokens do not fit a vocabulary of {size}")
    tokens += [f"[unused{i}]" for i in range(size - len(tokens))]
    return tokens


def write_vocab(path: str, sentences: Iterable[str], size: int) -> str:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(vocabulary(sentences, size)) + "\n")
    return path
