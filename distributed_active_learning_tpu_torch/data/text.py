"""Text tokenization and the AG-News CSV format (the port of
``data/text.py``, pure Python, copied: the ids equal the JAX package's).

The reference has no text pipeline at all (its pools are tabular floats);
BASELINE.json config 5 ("AG-News, BERT encoder, BatchBALD") introduces one.
Token-id pools are dense, fixed-length ``int32 [n, max_len]`` arrays (one
shape for the learner), so tokenization is a *hashing* tokenizer — no
vocabulary file, no OOV path, every token maps to ``1 + (hash(token) % (vocab_size - 1))`` with 0 reserved
for padding. Hash collisions trade a little accuracy for a pipeline with zero
host-side state, the standard feature-hashing trick.
"""

from __future__ import annotations

import csv
import hashlib
import re
from typing import List, Sequence, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(text: str) -> List[str]:
    """Lowercase word tokens (alnum + apostrophe runs)."""
    return _TOKEN_RE.findall(text.lower())


def _hash_token(token: str, vocab_size: int) -> int:
    # blake2b for a stable cross-process hash (Python's hash() is salted).
    h = int.from_bytes(hashlib.blake2b(token.encode(), digest_size=8).digest(), "little")
    return 1 + h % (vocab_size - 1)


def hash_encode(
    texts: Sequence[str], vocab_size: int = 4096, max_len: int = 64
) -> np.ndarray:
    """Encode texts to ``int32 [n, max_len]`` token ids (0 = padding)."""
    out = np.zeros((len(texts), max_len), dtype=np.int32)
    for i, t in enumerate(texts):
        toks = tokenize(t)[:max_len]
        for j, tok in enumerate(toks):
            out[i, j] = _hash_token(tok, vocab_size)
    return out


def load_agnews_csv(
    path: str, vocab_size: int = 4096, max_len: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """Load the AG-News CSV format: ``"class","title","description"`` rows,
    class in 1..4. Returns ``(ids [n, max_len] int32, labels [n] int32)``
    with labels remapped to 0..3 (like the striatum −1→0 remap,
    ``classes/dataset.py:259``)."""
    ids_texts: List[str] = []
    labels: List[int] = []
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.reader(f):
            if not row:
                continue
            cls = int(row[0])
            if not 1 <= cls <= 4:
                raise ValueError(f"AG-News class out of range: {cls}")
            labels.append(cls - 1)
            ids_texts.append(" ".join(row[1:]))
    return hash_encode(ids_texts, vocab_size, max_len), np.asarray(labels, np.int32)
