"""ctypes bindings for the repo's C++ host kernels
(``native/tptpu_native.cpp``), the port's own loader.

The source is compiled with ``g++ -O3 -fPIC -shared -std=c++17`` (the flags
of ``native/Makefile``) into ``transmogrifai_tpu_torch/_build/``, under a
name keyed by a hash of the source and the flags, at the first call that
needs it, never at import. The compiler writes to a temporary file that is
renamed into place, so several processes may build at once and each loads
a whole library. The loader never runs ``native/Makefile`` and never reads
or writes anything under ``native/`` but the source: the JAX package's
``native/libtptpu.so`` is that package's build, not the port's.

A library keyed by its source's hash cannot predate a kernel, so
``featurizeStats``' ``staleLibraryKernels`` stays 0 by construction; the
loaded library's ``tp_abi_version()`` must still equal :data:`ABI_VERSION`,
or the load raises :class:`KernelBuildError`. So does a compiler that is
missing or fails: the port never drops to a Python route because the
library is absent.

The Python routes stay, as the kernels' plain versions (the tests hold one
against the other) and as the reference's data-dependent routes: the C++
tokenizers are exact for ASCII only, so a column with non-ASCII rows takes
the exact-Unicode Python tokenizer for those rows, as in the reference.
``TPTPU_DISABLE_NATIVE`` (read per call, as the reference reads it at its
load) sends every entry point to its Python route. The entry points
release the interpreter lock for the native pass (ctypes does), so the
featurize pool's threads overlap them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

from .utils.cuda_build import KernelBuildError

_REPO_DIR = os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))
)
SOURCE = os.path.join(_REPO_DIR, "native", "tptpu_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
#: the C++ compiler, looked up on ``PATH`` at build time
COMPILER = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
#: the export set these bindings were written against (``tp_abi_version``)
ABI_VERSION = 3

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
#: this process's build: library path, seconds (0.0 when it was on disk)
build_info: dict = {}


def disabled() -> bool:
    """Whether ``TPTPU_DISABLE_NATIVE`` asks for the Python routes."""
    return bool(os.environ.get("TPTPU_DISABLE_NATIVE"))


def library_path() -> str:
    """``_build/libtptpu_native-<hash>.so``; the hash covers the source
    and the flags."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtptpu_native-{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Compile the library unless it is on disk: (path, build seconds)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    cxx = shutil.which(COMPILER)
    if cxx is None:
        raise KernelBuildError(
            f"C++ compiler {COMPILER!r} not found: the native host kernels "
            f"({SOURCE}) cannot be built"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
            capture_output=True, text=True, timeout=300,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise KernelBuildError(f"cannot run {cxx}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(
            f"{cxx} exited {proc.returncode} building {SOURCE}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    return path, time.perf_counter() - t0


_I64 = np.ctypeslib.ndpointer(np.int64, flags="C")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C")
_U32 = np.ctypeslib.ndpointer(np.uint32, flags="C")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C")
_c = ctypes
#: symbol -> (argtypes, restype), the whole export set of ABI 3
_SIGNATURES = {
    "tp_abi_version": ([], _c.c_int64),
    "tp_murmur3_batch": (
        [_c.c_char_p, _I64, _c.c_int64, _c.c_uint32, _U32], None),
    "tp_murmur3_scatter": (
        [_c.c_char_p, _I64, _I64, _c.c_int64, _c.c_uint32, _c.c_int64,
         _c.c_int, _F32, _c.c_int64, _c.c_int64], None),
    "tp_tokenize_hash_scatter": (
        [_c.c_char_p, _I64, _I64, _c.c_int64, _c.c_uint32, _c.c_int64,
         _c.c_int, _c.c_int, _c.c_int64, _c.c_char_p, _c.c_int64, _F32,
         _c.c_int64, _c.c_int64], None),
    "tp_count_tokens": (
        [_c.c_char_p, _I64, _c.c_int64, _c.c_int64], _c.c_int64),
    "tp_tokenize_hash_coo": (
        [_c.c_char_p, _I64, _I64, _c.c_int64, _c.c_uint32, _c.c_int64,
         _c.c_int, _c.c_int, _c.c_int64, _c.c_char_p, _c.c_int64, _I32,
         _I32, _c.c_int64], _c.c_int64),
    "tp_clean_tokenstats": (
        [_c.c_char_p, _I64, _c.c_int64, _U8, _I64, _I64, _c.c_int64], None),
    "tp_text_valuestats": (
        [_c.c_char_p, _I64, _c.c_int64, _I64, _c.c_int64, _c.c_int,
         _c.c_int64, _U8, _I64, _I64], _c.c_int64),
    "tp_intern_tokens": (
        [_c.c_char_p, _I64, _c.c_int64, _c.c_int, _c.c_int64, _I32, _I64,
         _U8, _I64, _c.c_int64], _c.c_int64),
    "tp_intern_values": (
        [_c.c_char_p, _I64, _c.c_int64, _I32, _I64, _I64], _c.c_int64),
    "tp_code_bincount": (
        [_I32, _I64, _c.c_int64, _I32, _c.c_int, _F32, _c.c_int64,
         _c.c_int64], None),
    "tp_parse_doubles": (
        [_c.c_char_p, _I64, _c.c_int64, _F64, _U8], None),
    "tp_tree_predict_sum": (
        [_I32, _c.c_int64, _c.c_int64, _I32, _I32, _F32, _c.c_int64,
         _c.c_int64, _c.c_int64, _c.c_int64, _F32], None),
}


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises
    :class:`KernelBuildError` when it cannot be built, loaded or bound."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path, seconds = build()
        try:
            lib = ctypes.CDLL(path)
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
        except (OSError, AttributeError) as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        abi = int(lib.tp_abi_version())
        if abi != ABI_VERSION:
            raise KernelBuildError(
                f"{path} reports ABI {abi}; these bindings need {ABI_VERSION}"
            )
        build_info.update(path=path, seconds=seconds, abi=abi)
        _LIB = lib
        return lib


def _load() -> ctypes.CDLL | None:
    """The library, or None when ``TPTPU_DISABLE_NATIVE`` asks for the
    Python routes."""
    return None if disabled() else library()


def _count_fallback(kernel: str) -> None:
    from .featurize import stats as _fstats

    _fstats.stats().count_fallback(kernel)


def _concat(values: list) -> tuple[bytes, np.ndarray]:
    """Concatenate strings into one UTF-8 buffer and offsets[n+1] (None and
    non-str values as empty strings). ASCII fast path: one join, one bulk
    ``isascii``, one encode."""
    n = len(values)
    try:
        joined = "".join(values)
    except TypeError:
        joined = None  # None / non-str present: per-item loop below
    if joined is not None and joined.isascii():
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, values), np.int64, n), out=offsets[1:])
        return joined.encode("ascii"), offsets
    encoded = [v.encode("utf-8") if isinstance(v, str) else b"" for v in values]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def _concat_tokens(values: list) -> tuple[bytes, np.ndarray] | None:
    """The tokenizing kernels' ASCII concat: items joined with one ``\\0``
    (a delimiter to the tokenizers), offsets from lengths. Not valid for
    whole-string hashing. None when any item is non-ASCII: the C
    tokenizers are exact for ASCII only, so the caller partitions."""
    n = len(values)
    if n == 0:
        return b"", np.zeros(1, dtype=np.int64)
    joined = "\x00".join(values)
    if not joined.isascii():
        return None
    lens = np.fromiter(map(len, values), np.int64, n)
    offsets = np.empty(n + 1, dtype=np.int64)
    offsets[0] = 0
    np.cumsum(lens + 1, out=offsets[1:])
    offsets[n] -= 1  # no separator after the last item
    return joined.encode("ascii"), offsets


def murmur3_batch(values: list, seed: int = 42) -> np.ndarray:
    """uint32 murmur3 of each string (None hashes as the empty string)."""
    lib = _load()
    n = len(values)
    if lib is not None:
        buf, offsets = _concat(values)
        out = np.empty(n, dtype=np.uint32)
        lib.tp_murmur3_batch(buf, offsets, n, seed & 0xFFFFFFFF, out)
        return out
    from .utils.text import murmur3_32

    return np.array(
        [murmur3_32(v if isinstance(v, str) else "", seed) for v in values],
        dtype=np.uint32,
    )


def murmur3_scatter(
    tokens: list,
    rows: np.ndarray,
    num_rows: int,
    num_buckets: int,
    seed: int = 42,
    binary: bool = False,
    out: np.ndarray | None = None,
    col_offset: int = 0,
) -> np.ndarray:
    """out[rows[i], col_offset + h(tokens[i]) % num_buckets] += 1 (set to 1
    when ``binary``); ``out`` may be a wider float32 matrix."""
    if out is None:
        out = np.zeros((num_rows, num_buckets), dtype=np.float32)
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if lib is not None and out.flags["C_CONTIGUOUS"] and out.dtype == np.float32:
        buf, offsets = _concat(tokens)
        lib.tp_murmur3_scatter(
            buf, offsets, rows, len(tokens), seed & 0xFFFFFFFF, num_buckets,
            1 if binary else 0, out, out.shape[1], col_offset,
        )
        return out
    h = murmur3_batch(tokens, seed)
    j = (h % np.uint32(num_buckets)).astype(np.int64) + col_offset
    if binary:
        out[rows, j] = 1.0
    else:
        np.add.at(out, (rows, j), 1.0)
    return out


def tokenize_hash_scatter(
    texts: list,
    rows: np.ndarray,
    num_buckets: int,
    out: np.ndarray,
    seed: int = 42,
    binary: bool = False,
    to_lowercase: bool = True,
    min_token_length: int = 1,
    prefix: str = "",
    col_offset: int = 0,
) -> bool:
    """Tokenize, hash and scatter ASCII row strings in one native pass.
    False when the pass cannot take them (native routes disabled, an
    output that is not C-contiguous float32, non-ASCII rows): the caller
    then runs the Python tokenizer."""
    lib = _load()
    if lib is None or not out.flags["C_CONTIGUOUS"] or out.dtype != np.float32:
        return False
    ct = _concat_tokens(texts)
    if ct is None:
        return False
    buf, offsets = ct
    pref = prefix.encode("ascii")
    lib.tp_tokenize_hash_scatter(
        buf, offsets, np.ascontiguousarray(rows, dtype=np.int64),
        len(texts), seed & 0xFFFFFFFF, num_buckets,
        1 if binary else 0, 1 if to_lowercase else 0, min_token_length,
        pref, len(pref), out, out.shape[1], col_offset,
    )
    return True


def tokenize_hash_coo(
    texts: list,
    rows: np.ndarray,
    num_buckets: int,
    seed: int = 42,
    binary: bool = False,
    to_lowercase: bool = True,
    min_token_length: int = 1,
    prefix: str = "",
) -> tuple[np.ndarray, np.ndarray] | None:
    """Tokenize and hash ASCII row strings into COO (row, bucket) pairs,
    int32 each, an implicit 1.0 per pair (duplicates accumulate; binary
    mode dedupes within a row). None when the pass cannot take them
    (native routes disabled, non-ASCII rows)."""
    lib = _load()
    if lib is None:
        return None
    ct = _concat_tokens(texts)
    if ct is None:
        return None
    buf, offsets = ct
    # every token needs a word character and a delimiter, so the fill
    # pass emits at most (bytes + strings) / 2 + 1 pairs
    cap = (len(buf) + len(texts)) // 2 + 1
    out_rows = np.empty(max(cap, 1), dtype=np.int32)
    out_cols = np.empty(max(cap, 1), dtype=np.int32)
    pref = prefix.encode("ascii")
    n = int(lib.tp_tokenize_hash_coo(
        buf, offsets, np.ascontiguousarray(rows, dtype=np.int64),
        len(texts), seed & 0xFFFFFFFF, num_buckets,
        1 if binary else 0, 1 if to_lowercase else 0, min_token_length,
        pref, len(pref), out_rows, out_cols, cap,
    ))
    # copies, so the sparse block does not pin the worst-case scratch
    return out_rows[:n].copy(), out_cols[:n].copy()


def clean_tokenstats(texts: list) -> tuple[list, np.ndarray] | None:
    """``clean_string`` of each ASCII string and the token-length
    histogram (256 bins, longer tokens in the last) in one native pass;
    None when the pass cannot take them."""
    lib = _load()
    if lib is None:
        return None
    ct = _concat_tokens(texts)
    if ct is None:
        return None
    buf, offsets = ct
    out_buf = np.zeros(max(len(buf), 1), dtype=np.uint8)
    out_offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    hist = np.zeros(256, dtype=np.int64)
    lib.tp_clean_tokenstats(
        buf, offsets, len(texts), out_buf, out_offsets, hist, hist.shape[0]
    )
    raw = out_buf[: out_offsets[-1]].tobytes().decode("ascii")
    cleaned = [raw[out_offsets[i]:out_offsets[i + 1]] for i in range(len(texts))]
    return cleaned, hist


def text_stats_pass(
    texts: list, cap: int, clean_text: bool
) -> tuple[np.ndarray, list[str], np.ndarray] | None:
    """The SmartText fit statistics in one native pass: ``(length_hist,
    uniques, counts)``, the first ``cap + 1`` distinct (cleaned) values in
    row order with their full counts. None when the pass cannot take the
    column."""
    lib = _load()
    if lib is None:
        return None
    ct = _concat_tokens(texts)
    if ct is None:
        return None
    buf, offsets = ct
    n = len(texts)
    hist = np.zeros(256, dtype=np.int64)
    uniq_buf = np.empty(max(len(buf), 1), dtype=np.uint8)
    uniq_offsets = np.zeros(n + 1, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    n_uniq = int(lib.tp_text_valuestats(
        buf, offsets, n, hist, hist.shape[0], 0 if clean_text else 1, 1,
        uniq_buf, uniq_offsets, counts,
    ))
    k = min(n_uniq, cap + 1)
    raw = uniq_buf[: uniq_offsets[k]].tobytes().decode("ascii")
    uniques = [raw[uniq_offsets[u]:uniq_offsets[u + 1]] for u in range(k)]
    return hist, uniques, counts[:k]


def validate_tree_stack(sf: np.ndarray, lv: np.ndarray, num_f: int) -> None:
    """Bounds-check a tree stack against the binned plane's width before a
    pointer reaches C (the kernel gathers unchecked). Raises IndexError."""
    depth = sf.shape[1]
    if sf.size and int(sf.max()) >= num_f:
        raise IndexError(
            f"tree_predict_sum: split feature index {int(sf.max())} out of "
            f"bounds for {num_f} binned feature(s)"
        )
    if lv.ndim != 2 or lv.shape[1] != (1 << depth):
        raise IndexError(
            f"tree_predict_sum: leaf table width {lv.shape[1:]} does not "
            f"match depth {depth} (expected {1 << depth})"
        )


def tree_predict_sum(
    binned: np.ndarray, sf: np.ndarray, sb: np.ndarray, lv: np.ndarray,
) -> np.ndarray | None:
    """Per-row float32 sum of the leaf values of R stacked trees
    (``split_feat`` / ``split_bin`` [R, depth, width], ``leaf_value``
    [R, 2^depth]) over binned codes [N, F], added in tree order; None when
    the native routes are disabled. The port serves trees through K1 and
    the tree sum on the card; this is bound for the tests."""
    lib = _load()
    if lib is None:
        return None
    binned = np.ascontiguousarray(binned, dtype=np.int32)
    sf = np.ascontiguousarray(sf, dtype=np.int32)
    sb = np.ascontiguousarray(sb, dtype=np.int32)
    lv = np.ascontiguousarray(lv, dtype=np.float32)
    n, num_f = binned.shape
    r, depth, width = sf.shape
    validate_tree_stack(sf, lv, num_f)
    out = np.empty(n, dtype=np.float32)
    lib.tp_tree_predict_sum(
        binned, n, num_f, sf, sb, lv, r, depth, width, lv.shape[1], out,
    )
    return out


def intern_tokens(
    texts: list, to_lowercase: bool = True, min_token_length: int = 1,
) -> tuple[np.ndarray, np.ndarray, list[str]] | None:
    """Tokenize and intern ASCII row strings in one native pass:
    ``(codes int32[T], row_offsets int64[len(texts)+1], vocab)``, the
    vocabulary in first-occurrence order. None when the pass cannot take
    them (the caller partitions)."""
    lib = _load()
    if lib is None:
        return None
    ct = _concat_tokens(texts)
    if ct is None:
        return None
    buf, offsets = ct
    cap = int(lib.tp_count_tokens(buf, offsets, len(texts), min_token_length))
    codes = np.empty(max(cap, 1), dtype=np.int32)
    row_offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    uniq_buf = np.empty(max(len(buf), 1), dtype=np.uint8)
    uniq_offsets = np.zeros(max(cap, 1) + 1, dtype=np.int64)
    n_uniq = int(lib.tp_intern_tokens(
        buf, offsets, len(texts), 1 if to_lowercase else 0, min_token_length,
        codes, row_offsets, uniq_buf, uniq_offsets, cap,
    ))
    raw = uniq_buf[: uniq_offsets[n_uniq]].tobytes().decode("ascii")
    vocab = [raw[uniq_offsets[u]:uniq_offsets[u + 1]] for u in range(n_uniq)]
    return codes[: row_offsets[-1]], row_offsets, vocab


def intern_values(values: list) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Intern whole strings, byte-exact, any Unicode: ``(codes int32[n],
    first_rows int64[U], counts int64[U])``, unique u being
    ``values[first_rows[u]]``. None when the native routes are disabled or
    a value is not a str (interning is byte-keyed; the caller's dict
    interner keys raw values)."""
    lib = _load()
    if lib is None:
        return None
    n = len(values)
    if n == 0:
        z64 = np.zeros(0, dtype=np.int64)
        return np.zeros(0, dtype=np.int32), z64, z64
    try:
        joined = "".join(values)
    except TypeError:
        return None
    offsets = np.zeros(n + 1, dtype=np.int64)
    if joined.isascii():
        np.cumsum(np.fromiter(map(len, values), np.int64, n), out=offsets[1:])
        buf = joined.encode("ascii")
    else:
        encoded = [v.encode("utf-8") for v in values]
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        buf = b"".join(encoded)
    codes = np.empty(n, dtype=np.int32)
    first_rows = np.empty(n, dtype=np.int64)
    counts = np.empty(n, dtype=np.int64)
    n_uniq = int(lib.tp_intern_values(buf, offsets, n, codes, first_rows, counts))
    return codes, first_rows[:n_uniq], counts[:n_uniq]


def code_bincount(
    codes: np.ndarray,
    row_offsets: np.ndarray,
    code_to_col: np.ndarray,
    out: np.ndarray,
    binary: bool = False,
    col_offset: int = 0,
) -> np.ndarray:
    """``out[r, col_offset + code_to_col[codes[t]]] (+)= 1`` for row r's
    tokens, skipping negative columns; ``out`` may be a wider float32
    matrix. The numpy route is exact and counted in ``fallbackKernels``."""
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    row_offsets = np.ascontiguousarray(row_offsets, dtype=np.int64)
    code_to_col = np.ascontiguousarray(code_to_col, dtype=np.int32)
    n_rows = len(row_offsets) - 1
    lib = _load()
    if lib is not None and out.flags["C_CONTIGUOUS"] and out.dtype == np.float32:
        lib.tp_code_bincount(
            codes, row_offsets, n_rows, code_to_col, 1 if binary else 0,
            out, out.shape[1], col_offset,
        )
        return out
    _count_fallback("code_bincount")
    cols = code_to_col[codes].astype(np.int64)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(row_offsets))
    keep = cols >= 0
    rows, cols = rows[keep], cols[keep] + col_offset
    if binary:
        out[rows, cols] = 1.0
    else:
        np.add.at(out, (rows, cols), 1.0)
    return out


def parse_doubles(values: list) -> tuple[np.ndarray, np.ndarray]:
    """Batch str -> double: (values float64[n], mask bool[n]); blank,
    missing and unparseable fields are masked out."""
    lib = _load()
    n = len(values)
    if lib is not None:
        buf, offsets = _concat(values)
        out = np.empty(n, dtype=np.float64)
        mask = np.empty(n, dtype=np.uint8)
        lib.tp_parse_doubles(buf, offsets, n, out, mask)
        return out, mask.astype(bool)
    out = np.zeros(n, dtype=np.float64)
    mask = np.zeros(n, dtype=bool)
    for i, v in enumerate(values):
        if v is None:
            continue
        s = v.strip() if isinstance(v, str) else v
        if s == "":
            continue
        try:
            out[i] = float(s)
            mask[i] = True
        except (TypeError, ValueError):
            pass
    return out, mask
