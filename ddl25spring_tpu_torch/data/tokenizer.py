"""Tokenizers: the counterpart of the JAX package's ``data/tokenizer.py``.

The reference tokenizes through simplellm's ``SPTokenizer`` (SentencePiece,
C++; ``lab/s01_b1_microbatches.py:6,31``).  Tokenization runs on the host in
both packages, so this module keeps the JAX module's surface and order:

- :class:`ByteTokenizer`, the dependency-free default (ids = byte + 3);
- :class:`SentencePieceTokenizer`: the sentencepiece package when it can be
  imported, else the pure-Python
  :class:`~ddl25spring_tpu_torch.data.sp_model.PySentencePieceProcessor`,
  with the JAX module's one-time warning.  The processor is the port's own
  copy of the JAX one, so both packages give the same ids on the same text;
- :class:`BpeTokenizer`: a byte-level BPE trained on a corpus and kept as a
  JSON artifact (``ddl25-bpe-v1``).  Its encode loop is native C++
  (``native/bpe.cc``, built at first use into ``native/libddl25_bpe.so``
  through :func:`~ddl25spring_tpu_torch.data.native_loader.load_native_lib`);
  where the library cannot be built, the Python loop below encodes the same
  ids.  :attr:`BpeTokenizer.native` says which one runs.

:func:`get_tokenizer` resolves an explicit path, then ``DDL25_SP_MODEL``,
then ``DDL25_BPE_MODEL`` (default ``data/bpe.json``), then bytes, as the JAX
function does.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import threading
from pathlib import Path

import numpy as np

_BPE_LIB_NAME = "libddl25_bpe.so"
_bpe_lib_lock = threading.Lock()
_bpe_lib: ctypes.CDLL | bool | None = None  # None: untried; False: unavailable


def _load_bpe_lib():
    global _bpe_lib
    with _bpe_lib_lock:
        if _bpe_lib is not None:
            return _bpe_lib or None
        from ddl25spring_tpu_torch.data.native_loader import (
            NativeLoaderUnavailable,
            load_native_lib,
        )

        try:
            lib = load_native_lib(_BPE_LIB_NAME)
        except NativeLoaderUnavailable:
            _bpe_lib = False
            return None
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = ctypes.c_long
        lib.bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _bpe_lib = lib
        return lib


class ByteTokenizer:
    """Byte-level tokenizer: ids = byte value + 3; 0/1/2 = pad/bos/eos."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    vocab_size = 256 + 3

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids) -> str:
        return bytes(i - 3 for i in np.asarray(ids).tolist() if i >= 3).decode(
            "utf-8", errors="replace"
        )


class SentencePieceTokenizer:
    """simplellm's ``SPTokenizer`` surface over a SentencePiece ``.model``:
    the sentencepiece package when it imports, else the port's
    :class:`~ddl25spring_tpu_torch.data.sp_model.PySentencePieceProcessor`
    (unigram Viterbi over the same protobuf), after a one-time warning that
    its encodings approximate real SentencePiece."""

    def __init__(self, model_path: str):
        try:
            import sentencepiece as spm

            self._sp = spm.SentencePieceProcessor(model_file=model_path)
        except ImportError:
            import warnings

            from ddl25spring_tpu_torch.data.sp_model import PySentencePieceProcessor

            warnings.warn(
                "sentencepiece is not importable; falling back to the "
                "in-tree PySentencePieceProcessor for "
                f"{model_path!r}. Encodings approximate real "
                "SentencePiece (unigram Viterbi without NFKC "
                "normalization or byte-fallback; see "
                "ddl25spring_tpu_torch/data/sp_model.py).",
                stacklevel=2,
            )
            self._sp = PySentencePieceProcessor(model_path)
        self.vocab_size = self._sp.vocab_size()
        # SentencePiece's -1 when the model has no pad piece: 0 would alias
        # <unk> and mask it out of the losses
        self.pad_id = self._sp.pad_id()
        self.bos_id = self._sp.bos_id()
        self.eos_id = self._sp.eos_id()

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self._sp.encode(text)
        return ([self.bos_id] if add_bos and self.bos_id >= 0 else []) + ids

    def decode(self, ids) -> str:
        return self._sp.decode(np.asarray(ids).tolist())


class BpeTokenizer:
    """Byte-level BPE, trainable and serializable, with no dependency.

    Merges are learned from a corpus (the most frequent adjacent pair, again
    and again), kept as a JSON artifact and reloaded by id.  Ids: 0/1/2 =
    pad/bos/eos, 3..258 = bytes, 259 + i = merge i.  Text is cut into
    ``\\s*\\S+`` chunks (whitespace travels with the word after it), merges
    never cross a chunk, and decode expands bytes, so ``decode(encode(t)) ==
    t`` for any text.

    ``native`` (default True) asks for the C++ encode loop; :attr:`native`
    afterwards says whether it runs (False where the library could not be
    built or loaded, and the Python loop encodes).  A pickled tokenizer
    carries its merges and that request, and rebuilds its handle."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    _BYTE0 = 3  # id of byte 0

    def __init__(self, merges: list[tuple[int, int]], native: bool = True):
        self.merges = [tuple(m) for m in merges]
        self._rank = {m: i for i, m in enumerate(self.merges)}
        self.vocab_size = 256 + self._BYTE0 + len(self.merges)
        self._bytes: dict[int, bytes] = {self._BYTE0 + b: bytes([b]) for b in range(256)}
        for i, (a, b) in enumerate(self.merges):
            self._bytes[259 + i] = self._bytes[a] + self._bytes[b]
        self._want_native = native
        self._native = None
        lib = _load_bpe_lib() if native else None
        if lib is not None:
            flat = np.asarray(self.merges, np.int32).reshape(-1)
            handle = lib.bpe_create(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                    len(self.merges))
            if handle:
                self._native = (lib, ctypes.c_void_p(handle))

    @property
    def native(self) -> bool:
        """True when :meth:`encode` runs the C++ loop of ``native/bpe.cc``."""
        return self._native is not None

    def __getstate__(self):
        return {"merges": self.merges, "native": self._want_native}

    def __setstate__(self, state):
        self.__init__(state["merges"], native=state["native"])

    def __del__(self):
        native = getattr(self, "_native", None)
        if native is not None:
            lib, handle = native
            # not contextlib.suppress: at interpreter teardown module globals
            # may be gone, and a finalizer must not look any up first
            try:  # noqa: SIM105
                lib.bpe_destroy(handle)
            except Exception:
                pass

    # ------------------------------------------------------------ training
    @classmethod
    def train(cls, corpus: str, n_merges: int = 512) -> "BpeTokenizer":
        """Greedy BPE: merge the most frequent adjacent id pair over the
        chunked corpus (counts weighted by chunk frequency), ``n_merges``
        times or until no pair occurs twice."""
        words: dict[tuple[int, ...], int] = {}
        for chunk in re.findall(r"\s*\S+", corpus):
            ids = tuple(cls._BYTE0 + b for b in chunk.encode("utf-8"))
            words[ids] = words.get(ids, 0) + 1
        merges: list[tuple[int, int]] = []
        for _ in range(n_merges):
            pairs: dict[tuple[int, int], int] = {}
            for ids, cnt in words.items():
                for pair in zip(ids, ids[1:]):
                    pairs[pair] = pairs.get(pair, 0) + cnt
            if not pairs:
                break
            best = max(pairs, key=pairs.get)
            if pairs[best] < 2:
                break
            new_id = 259 + len(merges)
            merges.append(best)
            words = {cls._apply_one(ids, best, new_id): cnt for ids, cnt in words.items()}
        return cls(merges)

    @staticmethod
    def _apply_one(ids, pair, new_id):
        out, i = [], 0
        while i < len(ids):
            if i + 1 < len(ids) and (ids[i], ids[i + 1]) == pair:
                out.append(new_id)
                i += 2
            else:
                out.append(ids[i])
                i += 1
        return tuple(out)

    # ---------------------------------------------------------- save/load
    def save(self, path: str) -> None:
        Path(path).write_text(json.dumps({"format": "ddl25-bpe-v1", "merges": self.merges}))

    @classmethod
    def load(cls, path: str) -> "BpeTokenizer":
        obj = json.loads(Path(path).read_text())
        if obj.get("format") != "ddl25-bpe-v1":
            raise ValueError(f"{path}: not a ddl25-bpe-v1 artifact")
        return cls([tuple(m) for m in obj["merges"]])

    # ------------------------------------------------------- encode/decode
    def _encode_chunk(self, chunk: bytes) -> list[int]:
        ids = [self._BYTE0 + b for b in chunk]
        while len(ids) > 1:
            r, j = min((self._rank.get(p, len(self.merges)), j)
                       for j, p in enumerate(zip(ids, ids[1:])))
            if r == len(self.merges):
                break
            ids[j: j + 2] = [259 + r]
        return ids

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        if self._native is not None:
            lib, handle = self._native
            data = text.encode("utf-8")
            out = np.empty(len(data) + 1, np.int32)  # ids never outnumber bytes
            n = lib.bpe_encode(handle, data, len(data), int(add_bos),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            return out[:n].tolist()
        ids = [self.bos_id] if add_bos else []
        for chunk in re.findall(r"\s*\S+|\s+$", text):
            ids.extend(self._encode_chunk(chunk.encode("utf-8")))
        return ids

    def decode(self, ids) -> str:
        out = b"".join(self._bytes[i] for i in np.asarray(ids).tolist() if i >= self._BYTE0)
        return out.decode("utf-8", errors="replace")


def get_tokenizer(model_path: str | None = None):
    """The reference's artifact discovery, in the JAX function's order: an
    explicit path wins (``.json``: BPE, else SentencePiece); then a
    SentencePiece model named by ``DDL25_SP_MODEL``; then the BPE artifact
    ``DDL25_BPE_MODEL`` (default ``data/bpe.json``); else bytes."""
    if model_path is not None:
        if model_path.endswith(".json"):
            return BpeTokenizer.load(model_path)
        return SentencePieceTokenizer(model_path)
    sp = os.environ.get("DDL25_SP_MODEL")
    if sp and Path(sp).exists():
        return SentencePieceTokenizer(sp)
    bpe = os.environ.get("DDL25_BPE_MODEL", "data/bpe.json")
    if bpe and Path(bpe).exists():
        return BpeTokenizer.load(bpe)
    return ByteTokenizer()
