"""SentencePiece ``.model`` files without the sentencepiece package: the
port's copy of the JAX package's ``data/sp_model.py``, line for line, so
both packages segment the same text into the same ids.

The reference tokenizes TinyStories through simplellm's ``SPTokenizer`` —
a SentencePiece model loaded from a gitignored ``*.model`` artifact
(``lab/s01_b1_microbatches.py:6,31``, ``lab/tutorial_1b/.gitignore:8,28``).
The sentencepiece package is host-side C++ and an optional dependency;
without it the wrapper in :mod:`ddl25spring_tpu_torch.data.tokenizer`
would have nothing to load a model with.  This module makes the format
first-class with zero dependencies:

- :func:`read_sp_model` / :func:`write_sp_model` — the ``ModelProto``
  protobuf wire format, hand-decoded/encoded (the format is stable and
  tiny: ``repeated SentencePiece {piece: string = 1, score: float = 2,
  type: enum = 3} pieces = 1``; every other field is skipped on read and
  omitted on write, which the protobuf wire format makes legal).  A REAL
  SentencePiece ``.model`` therefore loads here, and a model written here
  loads in real SentencePiece.
- :class:`PySentencePieceProcessor` — the inference surface the wrapper
  needs (``vocab_size``/``pad_id``/``bos_id``/``eos_id``/``encode``/
  ``decode``), encoding by unigram Viterbi: SentencePiece's default
  algorithm — maximize the sum of piece log-probs over a segmentation,
  after the standard normalization (spaces to ``▁`` with a dummy
  prefix).  Characters no piece covers fall back to ``<unk>`` with a
  large penalty, exactly the unigram model's unknown handling.
- :func:`train_sp_model` — a frequency-based unigram trainer: candidate
  pieces are frequent substrings of the normalized words (plus all
  single characters for closure), scored by ``log`` relative frequency.
  This is the seed-vocabulary stage of the real unigram trainer without
  the EM prune loop — an honest simplification that yields a valid,
  functional model file; swap in a real SentencePiece-trained artifact
  any time and everything downstream is unchanged.

Known divergences from real SentencePiece (the wrapper in
:mod:`ddl25spring_tpu_torch.data.tokenizer` warns once when it swaps this in):

- **Normalizer**: real SentencePiece applies the model's precompiled
  normalizer before segmentation — by default ``nmt_nfkc`` (NFKC
  Unicode normalization plus space folding).  This module only performs
  the space -> ``▁`` replacement with a dummy prefix and skips NFKC
  entirely (the precompiled charsmap in the proto is not decoded), so
  text containing compatibility characters (full-width forms, ligatures
  like ``ﬁ``, superscripts) segments differently than under the real
  library.
- **Byte fallback**: models trained with ``--byte_fallback`` carry 256
  ``<0xNN>`` BYTE-type pieces so any character not covered by the vocab
  still encodes losslessly.  Here uncovered characters map to ``<unk>``
  with a large Viterbi penalty instead — decode cannot round-trip them,
  exactly the lossy behavior byte fallback exists to avoid (the in-tree
  :class:`~ddl25spring_tpu_torch.data.tokenizer.BpeTokenizer` is the
  dependency-free choice when round-trip exactness matters).

TPU note: tokenization is host-side and off the hot path (the reference's
is too); this module exists for capability parity + artifact
compatibility, not speed.
"""

from __future__ import annotations

import math
import struct
from collections import Counter
from pathlib import Path

_WS = "▁"  # SentencePiece's meta symbol for space

# SentencePiece piece types (sentencepiece_model.proto enum)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
BYTE = 6


# ------------------------------------------------------------ wire format


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _skip_field(buf: bytes, i: int, wire: int) -> int:
    if wire == 0:  # varint
        _, i = _read_varint(buf, i)
    elif wire == 1:  # 64-bit
        i += 8
    elif wire == 2:  # length-delimited
        ln, i = _read_varint(buf, i)
        i += ln
    elif wire == 5:  # 32-bit
        i += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire}")
    return i


def write_sp_model(
    pieces: list[tuple[str, float, int]], path: str | Path
) -> None:
    """Serialize ``(piece, score, type)`` triples as a ``ModelProto``."""
    out = bytearray()
    for piece, score, ptype in pieces:
        sub = bytearray()
        pb = piece.encode("utf-8")
        sub += b"\x0a" + _varint(len(pb)) + pb          # piece = 1, wire 2
        sub += b"\x15" + struct.pack("<f", score)        # score = 2, wire 5
        sub += b"\x18" + _varint(ptype)                  # type  = 3, wire 0
        out += b"\x0a" + _varint(len(sub)) + sub         # pieces = 1, wire 2
    Path(path).write_bytes(bytes(out))


def read_sp_model(path: str | Path) -> list[tuple[str, float, int]]:
    """Parse a ``ModelProto`` into ``(piece, score, type)`` triples —
    real SentencePiece artifacts included (unknown fields skipped)."""
    buf = Path(path).read_bytes()
    pieces: list[tuple[str, float, int]] = []
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            ln, i = _read_varint(buf, i)
            sub, j = buf[i : i + ln], 0
            i += ln
            piece, score, ptype = "", 0.0, NORMAL
            while j < len(sub):
                t, j = _read_varint(sub, j)
                f, w = t >> 3, t & 7
                if f == 1 and w == 2:
                    sln, j = _read_varint(sub, j)
                    piece = sub[j : j + sln].decode("utf-8")
                    j += sln
                elif f == 2 and w == 5:
                    (score,) = struct.unpack("<f", sub[j : j + 4])
                    j += 4
                elif f == 3 and w == 0:
                    ptype, j = _read_varint(sub, j)
                else:
                    j = _skip_field(sub, j, w)
            pieces.append((piece, score, ptype))
        else:
            i = _skip_field(buf, i, wire)
    return pieces


# ------------------------------------------------------------ inference


def _normalize(text: str) -> str:
    # the standard SentencePiece front end: collapse spaces to the meta
    # symbol with a dummy prefix so word starts are marked
    return _WS + text.replace(" ", _WS)


class PySentencePieceProcessor:
    """Pure-Python stand-in for ``sentencepiece.SentencePieceProcessor``
    (the load/encode/decode slice the tokenizer wrapper uses)."""

    def __init__(self, model_file: str | Path):
        self.pieces = read_sp_model(model_file)
        if not self.pieces:
            raise ValueError(f"{model_file}: no pieces parsed")
        self._id = {p: i for i, (p, _, _) in enumerate(self.pieces)}
        self._unk = next(
            (i for i, (_, _, t) in enumerate(self.pieces) if t == UNKNOWN), 0
        )
        self._max_len = max(len(p) for p, _, _ in self.pieces)

        def ctl(name: str) -> int:
            return self._id.get(name, -1)

        self._bos = ctl("<s>")
        self._eos = ctl("</s>")
        self._pad = ctl("<pad>")

    # -- the SPTokenizer-visible surface ---------------------------------
    def vocab_size(self) -> int:
        return len(self.pieces)

    def pad_id(self) -> int:
        return self._pad

    def bos_id(self) -> int:
        return self._bos

    def eos_id(self) -> int:
        return self._eos

    def encode(self, text: str) -> list[int]:
        """Unigram Viterbi: the segmentation maximizing the summed piece
        scores; uncovered characters emit ``<unk>`` at a large penalty."""
        s = _normalize(text)
        n = len(s)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)  # (prev, id)
        best[0] = 0.0
        unk_penalty = -100.0
        for i in range(1, n + 1):
            lo = max(0, i - self._max_len)
            for j in range(lo, i):
                if best[j] == NEG:
                    continue
                pid = self._id.get(s[j:i])
                if pid is None:
                    continue
                sc = best[j] + self.pieces[pid][1]
                if sc > best[i]:
                    best[i] = sc
                    back[i] = (j, pid)
            if best[i] == NEG and best[i - 1] != NEG:
                # unknown character: single-char <unk> step
                best[i] = best[i - 1] + unk_penalty
                back[i] = (i - 1, self._unk)
        ids: list[int] = []
        i = n
        while i > 0:
            j, pid = back[i]
            ids.append(pid)
            i = j
        return ids[::-1]

    def decode(self, ids) -> str:
        # real SentencePiece skips CONTROL pieces but renders UNKNOWN as
        # " ⁇ " — silent dropping would lose characters on out-of-vocab
        # input, breaking parity exactly where it matters
        parts = []
        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.pieces):
                continue
            piece, _, ptype = self.pieces[i]
            if ptype == CONTROL:
                continue
            parts.append(" ⁇ " if ptype == UNKNOWN else piece)
        return "".join(parts).replace(_WS, " ").lstrip(" ")


# ------------------------------------------------------------ training


def train_sp_model(
    texts,
    vocab_size: int,
    path: str | Path,
    max_piece_len: int = 8,
) -> None:
    """Train a unigram-style model and write it as a ``.model`` file.

    Seed-vocabulary recipe (the first stage of SentencePiece's unigram
    trainer): count all substrings of the normalized words up to
    ``max_piece_len``, keep the most frequent until ``vocab_size`` is
    filled (all single characters always kept so every input is
    coverable), score = log relative frequency.  Control pieces
    ``<pad>/<s>/</s>/<unk>`` take ids 0-3 like standard artifacts."""
    words = Counter()
    for t in texts:
        for w in t.split(" "):
            if w:
                words[_WS + w] += 1

    subs: Counter = Counter()
    chars: Counter = Counter()
    for w, c in words.items():
        for i in range(len(w)):
            chars[w[i]] += c
            for ln in range(2, max_piece_len + 1):
                if i + ln <= len(w):
                    subs[w[i : i + ln]] += c * ln  # favor longer pieces

    control = [("<pad>", 0.0, CONTROL), ("<s>", 0.0, CONTROL),
               ("</s>", 0.0, CONTROL), ("<unk>", 0.0, UNKNOWN)]
    budget = vocab_size - len(control) - len(chars)
    if budget < 0:
        raise ValueError(
            f"vocab_size={vocab_size} cannot even hold the "
            f"{len(chars)} single characters"
        )
    chosen = [p for p, _ in subs.most_common(budget)]
    total = sum(chars.values()) + sum(subs[p] for p in chosen) or 1

    def score(freq: int) -> float:
        return math.log(max(freq, 1) / total)

    pieces = control + sorted(
        [(p, score(chars[p]), NORMAL) for p in chars]
        + [(p, score(subs[p]), NORMAL) for p in chosen],
        key=lambda x: -x[1],
    )
    write_sp_model(pieces, path)
