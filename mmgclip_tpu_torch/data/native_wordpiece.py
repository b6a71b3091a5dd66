"""ctypes binding of the batch WordPiece encoder for ASCII text (port of
mmgclip_tpu/data/native_wordpiece.py).

``csrc/wordpiece.cc`` implements the ASCII subset of HF BertTokenizer
semantics exactly; the Python :class:`~.tokenizer.WordPieceTokenizer` stays
the source of truth and takes every batch with a non-ASCII text.  The
library is built from the port's own source by the host C++ compiler at
first use (``ops/_build.py``, into ``mmgclip_tpu_torch/_build/``); a failed
build raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..ops import _build

_SOURCE = "wordpiece.cc"
_P, _I = ctypes.c_void_p, ctypes.c_int
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "wp_create": ([ctypes.c_char_p], _P),
    "wp_free": ([_P], None),
    "wp_encode_batch": ([_P, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), _I, _I, _I, _I,
                         _I32P, _I32P], _I),
}


def load_library() -> ctypes.CDLL:
    """The encoder's library, built first if needed, its entry points typed."""
    lib = _build.load(_SOURCE)
    if not getattr(lib, "_mmg_typed", False):
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        lib._mmg_typed = True
    return lib


class NativeWordPiece:
    """Native encoder over a WordPiece vocabulary (ids must be dense 0..n-1)."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_input_chars_per_word: int = 100):
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        if [i for _t, i in ordered] != list(range(len(ordered))):
            raise ValueError("native WordPiece needs dense token ids 0..n-1")
        if any("\n" in tok for tok, _i in ordered):
            # a newline inside a token would corrupt the line-indexed blob
            raise ValueError("native WordPiece cannot encode newline tokens")
        self._lib = load_library()
        self.lowercase = lowercase
        self.max_chars = max_input_chars_per_word
        self._handle = self._lib.wp_create("\n".join(tok for tok, _i in ordered).encode("utf-8"))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.wp_free(handle)

    def encode_batch(self, texts: Sequence[str], max_len: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """[n] ASCII texts -> (ids, mask) int32 [n, max_len]; None when any
        text is non-ASCII or ``max_len < 2`` (the caller then uses the Python
        path)."""
        if not all(t.isascii() for t in texts):
            return None
        blob = "".join(texts).encode("ascii")
        offsets = np.zeros(len(texts) + 1, np.int64)
        np.cumsum([len(t) for t in texts], out=offsets[1:])
        ids = np.empty((len(texts), max_len), np.int32)
        mask = np.empty((len(texts), max_len), np.int32)
        rc = self._lib.wp_encode_batch(
            self._handle, blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(texts), max_len, int(self.lowercase), self.max_chars,
            ids.ctypes.data_as(_I32P), mask.ctypes.data_as(_I32P))
        if rc != 0:
            return None
        return ids, mask


def native_available() -> bool:
    """Whether the native encoder's library builds and loads here (a host
    C++ compiler on ``$PATH``)."""
    try:
        load_library()
    except (OSError, RuntimeError):
        return False
    return True
