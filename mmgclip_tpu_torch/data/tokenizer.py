"""Tokenization for the text tower (port of mmgclip_tpu/data/tokenizer.py).

The pure-Python WordPiece path only: the in-repo tokenizer with the
deterministic corpus vocabulary (or a local ``vocab.txt``), HF call signature
(`padding="max_length"`, truncation, max_length), numpy outputs, and the
[SEP]-preserving truncation.  The HF ``transformers``, native C++ and
Moses+BPE backends of the JAX package are not ported yet.
"""

from __future__ import annotations

import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..utils.logging import logger

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
PAD_ID, UNK_ID, CLS_ID, SEP_ID, MASK_ID = range(5)


def _is_punctuation(char: str) -> bool:
    """HF BertTokenizer punctuation test: the four ASCII symbol blocks plus
    every Unicode P* category (reference tokenization contract —
    mmgclip/dataset/dataset.py:72 uses AutoTokenizer/BertTokenizer)."""
    cp = ord(char)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(char).startswith("P")


def _basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """HF BasicTokenizer semantics: clean control chars, whitespace-split,
    optional lowercase + accent strip, then split punctuation chars out."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            if ch not in ("\t", "\n", "\r"):
                continue
        cleaned.append(" " if ch in ("\t", "\n", "\r") else ch)
    tokens: List[str] = []
    for word in "".join(cleaned).split():
        if lowercase:
            word = word.lower()
            word = "".join(
                ch for ch in unicodedata.normalize("NFD", word)
                if unicodedata.category(ch) != "Mn"
            )
        current = ""
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    tokens.append(current)
                    current = ""
                tokens.append(ch)
            else:
                current += ch
        if current:
            tokens.append(current)
    return tokens


def build_vocab_from_corpus(corpus: Sequence[str], max_size: int = 8192) -> Dict[str, int]:
    """Deterministic vocabulary: specials, single chars, then corpus words by
    frequency (ties broken lexicographically)."""
    from collections import Counter

    counts: Counter = Counter()
    chars = set()
    for text in corpus:
        for tok in _basic_tokenize(text):
            counts[tok] += 1
            chars.update(tok)
    vocab: Dict[str, int] = {}
    for sp in SPECIALS:
        vocab[sp] = len(vocab)
    for ch in sorted(chars):
        for form in (ch, f"##{ch}"):
            if form not in vocab:
                vocab[form] = len(vocab)
    for word, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if word not in vocab and len(vocab) < max_size:
            vocab[word] = len(vocab)
    return vocab


def _default_corpus() -> List[str]:
    """Seed corpus: every sentence bank plus label vocabulary words."""
    from ..prompts.enums import ENUM_CLASSES, gtr_Histology
    from ..prompts.generator import _banks  # noqa: SLF001 - internal by design

    corpus: List[str] = []

    def collect(node):
        if isinstance(node, str):
            corpus.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif isinstance(node, list):
            for v in node:
                collect(v)

    collect(_banks())
    for enum_class in ENUM_CLASSES.values():
        corpus.extend(member.name for member in enum_class)
    corpus.extend(gtr_Histology.values())
    corpus.append("finding suggesting mass margin shape is no was observed revealed "
                  "normal architecture visible displayed architectural distortion "
                  "calcifications are present birads score of benign malignant "
                  "mammogram a the this ill defined non-calcified unknown")
    return corpus


_DEFAULT_VOCAB: Optional[Dict[str, int]] = None


def _default_vocab() -> Dict[str, int]:
    """The deterministic fallback vocabulary, built once per process."""
    global _DEFAULT_VOCAB
    if _DEFAULT_VOCAB is None:
        _DEFAULT_VOCAB = build_vocab_from_corpus(_default_corpus())
    return _DEFAULT_VOCAB


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece with [CLS] ... [SEP] framing.

    Algorithm-equal to HF ``BertTokenizer`` given the same vocab and
    ``lowercase`` flag (tested against transformers in
    tests/test_tokenizer_parity.py): whole-word [UNK] when any piece fails
    or the word exceeds ``max_input_chars_per_word``; special-token ids read
    from the vocab, not assumed positions."""

    def __init__(
        self,
        vocab: Optional[Dict[str, int]] = None,
        lowercase: bool = True,
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = vocab if vocab is not None else _default_vocab()
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.lowercase = lowercase
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_id = self.vocab.get("[PAD]", PAD_ID)
        self.unk_id = self.vocab.get("[UNK]", UNK_ID)
        self.cls_id = self.vocab.get("[CLS]", CLS_ID)
        self.sep_id = self.vocab.get("[SEP]", SEP_ID)

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True) -> "WordPieceTokenizer":
        """Load a real ``vocab.txt`` (one token per line, id = line number) —
        the artifact format of every BERT-family checkpoint."""
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                token = line.rstrip("\n")
                if token:
                    vocab[token] = len(vocab)
        return cls(vocab, lowercase=lowercase)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    piece_id = self.vocab[piece]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            ids.append(piece_id)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        ids = [self.cls_id]
        for tok in _basic_tokenize(text, lowercase=self.lowercase):
            ids.extend(self._wordpiece(tok))
        ids.append(self.sep_id)
        return ids

    def truncate(self, ids: List[int], max_length: int) -> List[int]:
        # HF semantics: truncation keeps the specials — inner tokens are
        # cut to max_length-2 so [SEP] stays last (EOS pooling reads
        # sum(mask)-1; reference: mmgclip_model.py:110-111)
        if len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_id]
        return ids


# checkpoint families by tokenization scheme that the port has no backend
# for yet (the JAX package's Moses+BPE and HF backends): fail loudly instead
# of silently WordPiece-ing them
_BPE_FAMILY_MARKERS = ("biogpt",)
_SENTENCEPIECE_MARKERS = ("mistral", "llama", "t5", "sentencepiece")


class Tokenizer:
    """HF-call-compatible front over :class:`WordPieceTokenizer`; numpy outputs.

    ``Tokenizer.from_pretrained(name)`` loads a local ``vocab.txt`` (a file,
    or a directory holding one) and otherwise uses the deterministic corpus
    vocabulary — what the JAX package does for BERT-family names when no HF
    tokenizer is cached locally."""

    def __init__(self, backend, sequence_length: int = 256, name: str = "wordpiece"):
        self._backend = backend
        self.sequence_length = sequence_length
        self.name = name

    @property
    def vocab_size(self) -> int:
        return int(self._backend.vocab_size)

    @classmethod
    def from_pretrained(cls, name: str, sequence_length: int = 256) -> "Tokenizer":
        vocab_file = None
        if os.path.isfile(name) and name.endswith(".txt"):
            vocab_file = name
        elif os.path.isdir(name) and os.path.isfile(os.path.join(name, "vocab.txt")):
            vocab_file = os.path.join(name, "vocab.txt")
        if vocab_file:
            logger.info(f"Using in-repo WordPiece tokenizer on vocab file {vocab_file!r}.")
            return cls(WordPieceTokenizer.from_vocab_file(vocab_file), sequence_length, name)
        lowered = name.lower()

        def _word_bounded(marker):
            return re.search(rf"(^|[^a-z0-9]){re.escape(marker)}([^a-z0-9]|$)", lowered)

        if any(marker in lowered for marker in _BPE_FAMILY_MARKERS) or any(
                _word_bounded(marker) for marker in _SENTENCEPIECE_MARKERS):
            raise NotImplementedError(
                f"Tokenizer {name!r} needs a BPE or SentencePiece backend, which "
                "the PyTorch port does not have yet (ROADMAP.md, queue 1 item 2).")
        logger.info(f"Using in-repo WordPiece tokenizer for {name!r}.")
        return cls(WordPieceTokenizer(), sequence_length, name)

    def __call__(
        self,
        texts: Union[str, Sequence[str]],
        padding: str = "max_length",
        truncation: bool = True,
        max_length: Optional[int] = None,
        return_tensors: str = "np",
    ) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.sequence_length

        encoded = [self._backend.encode(t) for t in texts]
        if truncation:
            # WordPiece keeps [SEP] last (see WordPieceTokenizer.truncate)
            encoded = [self._backend.truncate(ids, max_length) for ids in encoded]
        if padding == "longest":
            width = max(len(e) for e in encoded)
        else:
            width = max_length
        n = len(encoded)
        input_ids = np.full((n, width), self._backend.pad_id, np.int32)
        attention_mask = np.zeros((n, width), np.int32)
        for i, ids in enumerate(encoded):
            if len(ids) > width:
                # reachable only with truncation=False + padding=
                # "max_length": the fixed canvas still has to cut, so use
                # the family truncate rule (WordPiece keeps [SEP] last)
                # rather than a bare slice — a chopped-off [SEP] would make
                # eos_pool (sum(mask)-1) pool an arbitrary mid-sentence
                # token
                ids = self._backend.truncate(ids, width)
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": np.zeros((n, width), np.int32),
        }
