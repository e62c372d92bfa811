"""Rolling-hash chunk keys (paper §2.1).

Each G-token chunk gets a deterministic object key

    H_i = Hash(H_{i-1} || tokens_i)

so that two requests sharing a prefix address the *same* immutable objects —
the property that makes KV chunks content-addressed and dedupable in an
S3-compatible namespace.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Sequence

import numpy as np

GENESIS = b"\x00" * 16
KEY_BYTES = 16  # 128-bit keys; short enough for compact descriptors.


def _hash_one(parent: bytes, tokens: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=KEY_BYTES)
    h.update(parent)
    h.update(np.ascontiguousarray(tokens, dtype=np.int32).tobytes())
    return h.digest()


def chunk_keys(tokens: Sequence[int] | np.ndarray, chunk_tokens: int,
               parent: bytes = GENESIS) -> list[bytes]:
    """Keys for every *complete* chunk of ``tokens``.

    Incomplete trailing chunks are not addressable (the paper stores only full
    G-token chunks; the tail is always recomputed).
    """
    toks = np.asarray(tokens, dtype=np.int32)
    n_full = toks.shape[0] // chunk_tokens
    keys: list[bytes] = []
    h = parent
    for i in range(n_full):
        h = _hash_one(h, toks[i * chunk_tokens:(i + 1) * chunk_tokens])
        keys.append(h)
    return keys


def extend_keys(parent: bytes, tokens: Sequence[int] | np.ndarray,
                chunk_tokens: int) -> list[bytes]:
    """Continue a hash chain from ``parent`` over additional tokens."""
    return chunk_keys(tokens, chunk_tokens, parent=parent)


def key_hex(key: bytes) -> str:
    return key.hex()
