"""Text helpers with the reference's semantics: cleaning (TextUtils),
tokenization, and the deterministic MurmurHash3 of feature hashing. Pure
Python: the reference takes these routes whenever its native library
cannot take a string (``transmogrifai_tpu/utils/text.py``)."""
from __future__ import annotations

import re
import struct

_PUNCT_RE = re.compile(r"[\W_]+", flags=re.UNICODE)
_TOKEN_RE = re.compile(r"[^\s\W_]+", flags=re.UNICODE)


def clean_string(raw: str) -> str:
    """TextUtils.cleanString: lowercase, strip punctuation, capitalize each
    word, join with no separator ("hello-world!" -> "HelloWorld")."""
    words = _PUNCT_RE.sub(" ", raw.lower()).split()
    return "".join(w.capitalize() for w in words)


def tokenize(
    text: str,
    to_lowercase: bool = True,
    min_token_length: int = 1,
) -> list[str]:
    """Runs of word characters other than ``_`` (TextTokenizer defaults:
    ToLowercase=true, MinTokenLength=1)."""
    if to_lowercase:
        text = text.lower()
    return [t for t in _TOKEN_RE.findall(text) if len(t) >= min_token_length]


def murmur3_32(data: str | bytes, seed: int = 42) -> int:
    """MurmurHash3 x86 32-bit of the UTF-8 bytes (HashAlgorithm.MurMur3)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    length = len(data)
    rounded = length & ~0x3
    for i in range(0, rounded, 4):
        k = struct.unpack_from("<I", data, i)[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = length & 0x3
    if tail >= 3:
        k ^= data[rounded + 2] << 16
    if tail >= 2:
        k ^= data[rounded + 1] << 8
    if tail >= 1:
        k ^= data[rounded]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def hash_to_index(value: str, num_features: int, seed: int = 42) -> int:
    """Non-negative bucket index for feature hashing."""
    return murmur3_32(value, seed) % num_features
