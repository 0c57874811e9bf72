"""Tokenizers.

The byte-level tokenizer of the JAX package's ``data/tokenizer.py`` and its
resolution order.  The SentencePiece and trained-BPE tokenizers are not ported
yet: where the reference would load one of those artifacts, this module raises
instead of tokenizing the text differently.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


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


def _not_ported(kind: str, path: str):
    return NotImplementedError(
        f"{kind} tokenizer artifact {path!r}: the {kind} tokenizer arrives in a "
        "later slice of the PyTorch port"
    )


def get_tokenizer(model_path: str | None = None):
    """Tokenizer resolution in the reference's order: an explicit path wins;
    then a SentencePiece model named by ``DDL25_SP_MODEL``; then the BPE
    artifact (``DDL25_BPE_MODEL``, default ``data/bpe.json``); else bytes.
    The first two kinds raise ``NotImplementedError`` for now."""
    if model_path is not None:
        kind = "BPE" if model_path.endswith(".json") else "SentencePiece"
        raise _not_ported(kind, model_path)
    sp = os.environ.get("DDL25_SP_MODEL")
    if sp and Path(sp).exists():
        raise _not_ported("SentencePiece", sp)
    bpe = os.environ.get("DDL25_BPE_MODEL", "data/bpe.json")
    if bpe and Path(bpe).exists():
        raise _not_ported("BPE", bpe)
    return ByteTokenizer()
