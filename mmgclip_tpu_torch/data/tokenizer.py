"""Tokenization for the text tower (port of mmgclip_tpu/data/tokenizer.py).

The JAX package's in-repo backends, with the HF call signature
(`padding="max_length"`, truncation, max_length) and numpy outputs:

* WordPiece with the deterministic corpus vocabulary (or a local
  ``vocab.txt``) and the [SEP]-preserving truncation; ASCII batches go
  through the C++ encoder (``native_wordpiece.py``, built from
  ``csrc/wordpiece.cc``) unless ``MMGCLIP_NATIVE_TOKENIZER=0``;
* Moses+BPE, BioGPT's fairseq scheme: the English Moses word split
  (``moses.py``, no ``sacremoses``), greedy lowest-rank BPE with ``</w>``
  and the ``</s> X`` framing, over a local ``vocab.json`` + ``merges.txt``
  or the vocabulary learned from the in-repo corpus.

The JAX package first tries a locally cached HuggingFace tokenizer; the port
has no ``transformers``, so it takes the in-repo backend the JAX package
falls back to (algorithm-equal, tests/test_tokenizer_parity.py and
tests/test_biogpt_tokenizer.py).  SentencePiece names raise ``RuntimeError``
as in the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..utils.logging import logger
from .moses import moses_tokenize

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


class MosesBpeTokenizer:
    """Moses + BPE tokenizer, the fairseq scheme BioGPT uses (port of the JAX
    package's ``MosesBpeTokenizer``): the English Moses word split
    (aggressive dash splits, HTML-escaped), greedy lowest-rank BPE with the
    ``</w>`` end-of-word marker, and the fairseq framing ``</s> X``: sep
    first, no trailing EOS, so truncation cuts the tail."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Sequence[str]]):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        # later duplicates overwrite earlier ones, like dict(zip(...))
        self._ranks: Dict[tuple, int] = {tuple(m[:2]): i for i, m in enumerate(merges)}
        self._bpe_cache: Dict[str, List[str]] = {}
        self.unk_token = "<unk>"
        self.pad_id = self.vocab.get("<pad>", 1)
        self.unk_id = self.vocab.get("<unk>", 3)
        self.sep_id = self.vocab.get("</s>", 2)

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "MosesBpeTokenizer":
        with open(vocab_json, encoding="utf-8") as fh:
            vocab = json.load(fh)
        with open(merges_txt, encoding="utf-8") as fh:
            lines = fh.read().split("\n")[:-1]
        merges = [line.split()[:2] for line in lines if line.strip()]
        return cls(vocab, merges)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _bpe(self, token: str) -> List[str]:
        """Greedy merge loop: repeatedly fuse the adjacent pair with the
        lowest merge rank until none of the remaining pairs has one."""
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        symbols = list(token[:-1]) + [token[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = {(a, b) for a, b in zip(symbols, symbols[1:])}
            ranked = [p for p in pairs if p in self._ranks]
            if not ranked:
                break
            first, second = min(ranked, key=self._ranks.__getitem__)
            symbols = _merge(symbols, first, second)
        if symbols == ["\n", " </w>"]:
            # fairseq normalization quirk kept for id-level compatibility
            symbols = ["\n</w>"]
        self._bpe_cache[token] = symbols
        return symbols

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for word in moses_tokenize(text):
            if word:
                pieces.extend(self._bpe(word))
        return pieces

    def encode(self, text: str) -> List[int]:
        return [self.sep_id] + [self.vocab.get(piece, self.unk_id) for piece in self.tokenize(text)]

    def truncate(self, ids: List[int], max_length: int) -> List[int]:
        # the only special token is the LEADING </s>: cutting the tail is HF's rule
        return ids[:max_length]


def _merge(symbols: Sequence[str], first: str, second: str) -> List[str]:
    """Fuse every left-to-right occurrence of the pair (first, second)."""
    fused: List[str] = []
    i = 0
    while i < len(symbols):
        if symbols[i] == first and i + 1 < len(symbols) and symbols[i + 1] == second:
            fused.append(first + second)
            i += 2
        else:
            fused.append(symbols[i])
            i += 1
    return fused


def learn_bpe_from_corpus(corpus: Sequence[str], num_merges: int = 512
                          ) -> "tuple[Dict[str, int], List[tuple]]":
    """Deterministic BPE learning for the offline fallback vocabulary:
    Moses-tokenize the corpus, then repeatedly merge the most frequent
    adjacent symbol pair (ties broken lexicographically).  Returns
    (vocab, merges) in the ``vocab.json``/``merges.txt`` shape."""
    from collections import Counter

    word_counts: Counter = Counter()
    for text in corpus:
        for word in moses_tokenize(text):
            if word:
                word_counts[word] += 1
    words = {w: [tuple(w[:-1]) + (w[-1] + "</w>",), c] for w, c in word_counts.items()}
    chars = sorted({s for sym, _ in words.values() for s in sym})
    merges: List[tuple] = []
    for _ in range(num_merges):
        pair_counts: Counter = Counter()
        for sym, count in words.values():
            for pair in zip(sym, sym[1:]):
                pair_counts[pair] += count
        if not pair_counts:
            break
        best, best_count = min(pair_counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if best_count < 2:
            break
        merges.append(best)
        for entry in words.values():
            entry[0] = tuple(_merge(entry[0], *best))
    vocab: Dict[str, int] = {}
    for special in ("<s>", "<pad>", "</s>", "<unk>"):  # fairseq id order
        vocab[special] = len(vocab)
    for ch in chars:
        if ch not in vocab:
            vocab[ch] = len(vocab)
    for first, second in merges:
        if first + second not in vocab:
            vocab[first + second] = len(vocab)
    return vocab, merges


_DEFAULT_BPE: Optional[MosesBpeTokenizer] = None


def _default_bpe() -> MosesBpeTokenizer:
    """Deterministic Moses+BPE fallback, learned once per process from the
    same in-repo corpus that seeds the WordPiece fallback."""
    global _DEFAULT_BPE
    if _DEFAULT_BPE is None:
        _DEFAULT_BPE = MosesBpeTokenizer(*learn_bpe_from_corpus(_default_corpus()))
    return _DEFAULT_BPE


# checkpoint families by tokenization scheme: fairseq Moses+BPE degrades to
# the in-repo BPE fallback; SentencePiece families have no faithful offline
# backend and fail loudly instead of silently WordPiece-ing
_BPE_FAMILY_MARKERS = ("biogpt",)
_SENTENCEPIECE_MARKERS = ("mistral", "llama", "t5", "sentencepiece")


class Tokenizer:
    """HF-call-compatible front over the in-repo backends; numpy outputs.

    ``Tokenizer.from_pretrained(name)`` dispatches as the JAX package's does
    when no HF tokenizer is cached locally: a local ``vocab.txt`` file, a
    directory with ``vocab.json`` + ``merges.txt`` (Moses+BPE) or with
    ``vocab.txt`` (WordPiece), then by name: BioGPT names to the learned
    Moses+BPE vocabulary, SentencePiece names raise ``RuntimeError``, the rest
    to the corpus WordPiece vocabulary."""

    def __init__(self, backend, sequence_length: int = 256, name: str = "wordpiece"):
        self._backend = backend
        self.sequence_length = sequence_length
        self.name = name
        self._native = None
        self._native_tried = False

    def _native_backend(self):
        """The C++ encoder for ASCII WordPiece batches; None for another
        backend, with ``MMGCLIP_NATIVE_TOKENIZER=0`` or for a vocabulary it
        cannot hold.  A failed build raises."""
        if self._native_tried:
            return self._native
        self._native_tried = True
        if (isinstance(self._backend, WordPieceTokenizer)
                and os.environ.get("MMGCLIP_NATIVE_TOKENIZER", "1") != "0"):
            from .native_wordpiece import NativeWordPiece

            try:
                self._native = NativeWordPiece(
                    self._backend.vocab, lowercase=self._backend.lowercase,
                    max_input_chars_per_word=self._backend.max_input_chars_per_word)
            except ValueError:  # ids not dense, or a newline token: the Python path
                self._native = None
        return self._native

    @property
    def vocab_size(self) -> int:
        return int(self._backend.vocab_size)

    @classmethod
    def from_pretrained(cls, name: str, sequence_length: int = 256) -> "Tokenizer":
        vocab_file = bpe_files = None
        if os.path.isfile(name) and name.endswith(".txt"):
            vocab_file = name
        elif os.path.isdir(name):
            if os.path.isfile(os.path.join(name, "vocab.txt")):
                vocab_file = os.path.join(name, "vocab.txt")
            vj, mt = os.path.join(name, "vocab.json"), os.path.join(name, "merges.txt")
            if os.path.isfile(vj) and os.path.isfile(mt):
                bpe_files = (vj, mt)
        if vocab_file and not os.path.isdir(name):
            logger.info(f"Using in-repo WordPiece tokenizer on vocab file {vocab_file!r}.")
            return cls(WordPieceTokenizer.from_vocab_file(vocab_file), sequence_length, name)
        if bpe_files:
            logger.info(f"Using in-repo Moses+BPE tokenizer on local files {bpe_files}.")
            return cls(MosesBpeTokenizer.from_files(*bpe_files), sequence_length, name)
        if vocab_file:
            logger.info(f"Using in-repo WordPiece tokenizer on vocab file {vocab_file!r}.")
            return cls(WordPieceTokenizer.from_vocab_file(vocab_file), sequence_length, name)
        lowered = name.lower()

        def _word_bounded(marker):
            # 't5' must not match inside e.g. 'gpt5-med'
            return re.search(rf"(^|[^a-z0-9]){re.escape(marker)}([^a-z0-9]|$)", lowered)

        if any(marker in lowered for marker in _BPE_FAMILY_MARKERS):
            logger.warning(
                f"Tokenizer {name!r}: using the in-repo Moses+BPE fallback (the scheme, with a "
                "deterministic learned vocabulary, not the checkpoint's own; point the name at "
                "a directory with vocab.json + merges.txt for its ids).")
            return cls(_default_bpe(), sequence_length, name)
        if any(_word_bounded(marker) for marker in _SENTENCEPIECE_MARKERS):
            raise RuntimeError(
                f"Tokenizer {name!r} is a SentencePiece-family checkpoint with no faithful "
                "offline backend here. Provide the tokenizer files locally instead of relying "
                "on a fallback.")
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

        if truncation:
            native = self._native_backend()
            out = native.encode_batch(list(texts), max_length) if native is not None else None
            if out is not None:  # None: a non-ASCII text, the Python path
                input_ids, attention_mask = out
                if padding == "longest" and len(texts):
                    width = int(attention_mask.sum(axis=1).max())
                    input_ids, attention_mask = input_ids[:, :width], attention_mask[:, :width]
                return {"input_ids": input_ids, "attention_mask": attention_mask,
                        "token_type_ids": np.zeros_like(input_ids)}

        encoded = [self._backend.encode(t) for t in texts]
        if truncation:
            # per-family rule: WordPiece keeps [SEP] last, Moses+BPE cuts the tail
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
