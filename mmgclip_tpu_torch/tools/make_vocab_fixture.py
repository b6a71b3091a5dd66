"""Write a small, real-structure WordPiece ``vocab.txt`` covering the prompt
banks (port of tools/make_vocab_fixture.py, which writes
``tests/data/vocab_fixture.txt``).

    python -m mmgclip_tpu_torch.tools.make_vocab_fixture --out vocab.txt

One token per line, id = line number (the BERT-family artifact format).
Every word of >= 10 characters is left out of the whole-word section and
4-character pieces are added instead, so greedy multi-piece WordPiece
splitting is exercised; words absent entirely fall to whole-word [UNK].
The same bytes as the JAX tool's file.  No tensors, no device.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..data.tokenizer import _basic_tokenize, _default_corpus


def vocab_tokens() -> List[str]:
    """The fixture's tokens in file order, without repeats."""
    words = set()
    chars = set()
    for text in _default_corpus():
        for tok in _basic_tokenize(text, lowercase=True):
            words.add(tok)
            chars.update(tok)

    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(5)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += sorted(ch for ch in chars if not ch.isalnum())
    vocab += [str(d) for d in range(10)] + [f"##{d}" for d in range(10)]

    whole, pieces = [], set()
    for word in sorted(words):
        if word.isdigit() or (len(word) == 1 and not word.isalnum()):
            continue
        if len(word) >= 10:
            pieces.add(word[:4])
            for start in range(4, len(word), 4):
                pieces.add("##" + word[start : start + 4])
        else:
            whole.append(word)
    vocab += whole + sorted(pieces)
    return list(dict.fromkeys(vocab))


def main(argv: Optional[List[str]] = None) -> str:
    """The entry point; returns the path written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True, help="vocab.txt path to write")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    tokens = vocab_tokens()
    with open(args.out, "w", encoding="utf-8") as fh:
        for token in tokens:
            fh.write(token + "\n")
    print(f"wrote {len(tokens)} tokens to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
