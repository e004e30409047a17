"""MurmurHash3 (x86 32-bit), the hashing primitive of hashed tokenization.

A copy of `murmur3_32` and `hash_token` from `mmlspark_tpu/ops/hashing.py`
(pure Python over bytes, host side: tokens are hashed before they reach
the card). The batch `hash_strings` and its native kernel wait for the
featurizers (ROADMAP Queue 1 item 21).
"""
from __future__ import annotations

import functools


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF


def murmur3_32(data: bytes, seed: int = 0) -> int:
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[4 * i:4 * i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = _rotl32(k, 15)
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[4 * nblocks:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = _rotl32(k, 15)
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


@functools.lru_cache(maxsize=1_000_000)
def hash_token(token: str, seed: int = 0) -> int:
    return murmur3_32(token.encode("utf-8"), seed)
