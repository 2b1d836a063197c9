"""The port's native host kernels (``transmogrifai_tpu_torch/native.py``):
each entry point against the JAX package's ``transmogrifai_tpu.native`` and
against the port's Python route (``TPTPU_DISABLE_NATIVE``), on seeded
inputs with ASCII, non-ASCII, empty and missing rows, tokens longer than
255 characters and ``binary`` on and off. The tolerance is EQUALITY: every
kernel is integer or byte work, or float32 sums in one fixed order.

Then the build's hygiene: the library lands under ``_build/``, nothing
under ``native/`` changes, two processes building at once both load one
whole library, and a missing or failing compiler, or a library of another
ABI, raises ``KernelBuildError`` instead of falling back.
"""
import hashlib
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from transmogrifai_tpu import native as JN

from transmogrifai_tpu_torch import native as PN
from transmogrifai_tpu_torch.models.serve_trees import serve_trees_reference
from transmogrifai_tpu_torch.models.tree_sum import tree_sum
from transmogrifai_tpu_torch.utils.cuda_build import KernelBuildError
from transmogrifai_tpu_torch.utils.text import clean_string, murmur3_32, tokenize

torch.set_num_threads(1)

pytestmark = [pytest.mark.torch_port]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(ROOT, "native")

_WORDS = ["alpha", "Beta", "GAMMA", "delta42", "x", "café", "naïve", "Σigma",
          "日本語", "a-b_c", "hello—world", "", "  ", "!!", "9_000", "z" * 300,
          "Q" * 256]


def _texts(seed: int, n: int, ascii_only: bool = False) -> list:
    """Seeded rows of 0-6 words joined by mixed delimiters, some missing;
    ``ascii_only`` drops the non-ASCII words."""
    rng = np.random.default_rng(seed)
    words = [w for w in _WORDS if w.isascii()] if ascii_only else _WORDS
    seps = [" ", ", ", "\t", "--", "_", "."]
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.08:
            out.append(None)
        elif r < 0.12:
            out.append("")
        else:
            k = int(rng.integers(1, 7))
            parts = [words[i] for i in rng.integers(0, len(words), k)]
            out.append(seps[int(rng.integers(0, len(seps)))].join(parts))
    return out


@pytest.fixture
def plain(monkeypatch):
    """Enter the Python routes."""
    def enter():
        monkeypatch.setenv("TPTPU_DISABLE_NATIVE", "1")
    return enter


def _sha(path: str) -> str | None:
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


# ------------------------------------------------------------------ hashing
@pytest.mark.parametrize("seed", [0, 1])
def test_murmur3_batch_equals_the_reference_and_the_python_route(seed, plain):
    values = _texts(seed, 300)
    got = PN.murmur3_batch(values, seed=42)
    np.testing.assert_array_equal(got, JN.murmur3_batch(values, seed=42))
    want = np.array([murmur3_32(v or "", 42) for v in values], np.uint32)
    np.testing.assert_array_equal(got, want)
    plain()
    np.testing.assert_array_equal(PN.murmur3_batch(values, seed=42), want)


@pytest.mark.parametrize("binary", [False, True])
def test_murmur3_scatter_equals_the_reference_and_the_python_route(binary, plain):
    tokens = [t for v in _texts(3, 200) if v for t in tokenize(v)]
    rows = (np.arange(len(tokens)) * 7) % 50
    out = np.zeros((50, 80), np.float32)
    got = PN.murmur3_scatter(tokens, rows, 50, 64, seed=42, binary=binary,
                             out=out, col_offset=9)
    want = np.zeros((50, 80), np.float32)
    JN.murmur3_scatter(tokens, rows, 50, 64, seed=42, binary=binary,
                       out=want, col_offset=9)
    np.testing.assert_array_equal(got, want)
    plain()
    py = PN.murmur3_scatter(tokens, rows, 50, 64, seed=42, binary=binary,
                            out=np.zeros((50, 80), np.float32), col_offset=9)
    np.testing.assert_array_equal(py, want)


def _python_hash_rows(texts, rows, nb, binary, lower, min_len, prefix):
    out = np.zeros((int(max(rows, default=0)) + 1, nb), np.float32)
    for r, v in zip(rows, texts):
        for t in tokenize(v, lower, min_len):
            j = murmur3_32(prefix + t, 42) % nb
            out[r, j] = 1.0 if binary else out[r, j] + 1.0
    return out


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("lower,min_len,prefix", [(True, 1, ""), (False, 3, "2_")])
def test_tokenize_hash_scatter_and_coo_equal_the_reference(
    binary, lower, min_len, prefix,
):
    """ASCII rows (tokens past 255 characters among them): the dense pass
    and the COO pairs, densified, equal the reference's and the Python
    tokenizer's; the COO pass deduplicates within a row under binary,
    across consecutive strings of one row too."""
    texts = [v for v in _texts(5, 400, ascii_only=True) if v is not None]
    rows = np.arange(len(texts), dtype=np.int64) // 2  # two strings a row
    n = int(rows[-1]) + 1
    kw = dict(seed=42, binary=binary, to_lowercase=lower,
              min_token_length=min_len, prefix=prefix)
    got = np.zeros((n, 70), np.float32)
    assert PN.tokenize_hash_scatter(texts, rows, 64, got, col_offset=3, **kw)
    want = np.zeros((n, 70), np.float32)
    assert JN.tokenize_hash_scatter(texts, rows, 64, want, col_offset=3, **kw)
    np.testing.assert_array_equal(got, want)
    py = _python_hash_rows(texts, rows, 64, binary, lower, min_len, prefix)
    np.testing.assert_array_equal(got[:, 3:67], py)
    r, c = PN.tokenize_hash_coo(texts, rows, 64, **kw)
    jr, jc = JN.tokenize_hash_coo(texts, rows, 64, **kw)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(c, jc)
    dense = np.bincount(r.astype(np.int64) * 64 + c, minlength=n * 64)
    np.testing.assert_array_equal(dense.reshape(n, 64).astype(np.float32), py)
    if binary:
        assert len(np.unique(r.astype(np.int64) * 64 + c)) == len(r)


def test_tokenizing_passes_refuse_non_ascii_rows():
    texts = ["plain row", "café au lait"]
    out = np.zeros((2, 16), np.float32)
    assert not PN.tokenize_hash_scatter(texts, np.arange(2), 16, out)
    assert PN.tokenize_hash_coo(texts, np.arange(2), 16) is None
    assert PN.clean_tokenstats(texts) is None
    assert PN.text_stats_pass(texts, 30, True) is None
    assert PN.intern_tokens(texts) is None
    assert not out.any()


# ---------------------------------------------------------- text statistics
def _python_hist(texts) -> np.ndarray:
    hist = np.zeros(256, np.int64)
    for v in texts:
        for t in tokenize(v):
            hist[min(len(t), 255)] += 1
    return hist


@pytest.mark.parametrize("seed", [7, 8])
def test_clean_tokenstats_equals_the_reference_and_the_python_route(seed):
    texts = [v for v in _texts(seed, 300, ascii_only=True) if v is not None]
    cleaned, hist = PN.clean_tokenstats(texts)
    jc, jh = JN.clean_tokenstats(texts)
    assert cleaned == jc
    np.testing.assert_array_equal(hist, jh)
    assert cleaned == [clean_string(v) for v in texts]
    np.testing.assert_array_equal(hist, _python_hist(texts))
    assert hist[255] > 0  # the tokens past 255 characters


@pytest.mark.parametrize("cap,clean", [(30, True), (3, True), (30, False), (0, False)])
def test_text_stats_pass_equals_the_reference_and_the_python_route(cap, clean):
    rng = np.random.default_rng(11)
    pool = [v for v in _texts(9, 40, ascii_only=True) if v]
    texts = [pool[i] for i in rng.integers(0, len(pool), 600)]
    hist, uniques, counts = PN.text_stats_pass(texts, cap, clean)
    jh, ju, jcounts = JN.text_stats_pass(texts, cap, clean)
    np.testing.assert_array_equal(hist, jh)
    assert uniques == ju
    np.testing.assert_array_equal(counts, jcounts)
    full = Counter(clean_string(v) if clean else v for v in texts)
    assert uniques == list(full)[: cap + 1]
    assert counts.tolist() == [full[u] for u in uniques]
    np.testing.assert_array_equal(hist, _python_hist(texts))


# ---------------------------------------------------------------- interning
@pytest.mark.parametrize("lower,min_len", [(True, 1), (False, 1), (True, 3)])
def test_intern_tokens_equals_the_reference_and_a_dict_interner(lower, min_len):
    texts = [v for v in _texts(12, 300, ascii_only=True) if v is not None]
    codes, offsets, vocab = PN.intern_tokens(texts, lower, min_len)
    jcodes, joffsets, jvocab = JN.intern_tokens(texts, lower, min_len)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(offsets, joffsets)
    assert vocab == jvocab
    index: dict = {}
    want_codes, want_offsets = [], [0]
    for v in texts:
        for t in tokenize(v, lower, min_len):
            want_codes.append(index.setdefault(t, len(index)))
        want_offsets.append(len(want_codes))
    assert codes.tolist() == want_codes
    assert offsets.tolist() == want_offsets
    assert vocab == list(index)


@pytest.mark.parametrize("seed", [13, 14])
def test_intern_values_equals_the_reference_in_first_occurrence_order(seed, plain):
    """Byte-exact whole values, Unicode included, in first-occurrence
    order with their counts; non-str values refuse the native pass."""
    rng = np.random.default_rng(seed)
    pool = [v for v in _texts(seed, 30) if v is not None] + ["A", "a", "é"]
    values = [pool[i] for i in rng.integers(0, len(pool), 500)]
    codes, first, counts = PN.intern_values(values)
    jcodes, jfirst, jcounts = JN.intern_values(values)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(first, jfirst)
    np.testing.assert_array_equal(counts, jcounts)
    order = list(dict.fromkeys(values))
    assert [values[i] for i in first] == order
    assert counts.tolist() == [values.count(u) for u in order]
    assert PN.intern_values(["a", 7]) is None
    plain()
    assert PN.intern_values(values) is None  # the caller's dict interner


@pytest.mark.parametrize("binary", [False, True])
def test_code_bincount_equals_the_reference_and_the_numpy_route(binary, plain):
    rng = np.random.default_rng(15)
    offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 9, 120))])
    codes = rng.integers(0, 40, int(offsets[-1])).astype(np.int32)
    code_to_col = rng.integers(-1, 25, 40).astype(np.int32)
    got = PN.code_bincount(codes, offsets, code_to_col,
                           np.zeros((120, 30), np.float32), binary, 5)
    want = JN.code_bincount(codes, offsets, code_to_col,
                            np.zeros((120, 30), np.float32), binary, 5)
    np.testing.assert_array_equal(got, want)
    plain()
    py = PN.code_bincount(codes, offsets, code_to_col,
                          np.zeros((120, 30), np.float32), binary, 5)
    np.testing.assert_array_equal(py, want)


# ------------------------------------------------------------------ parsing
PARSE_FIELDS = [
    "1", "-2.5", "+3", " 4.25 ", "1e3", "-1E-2", "6.02e+23", ".5", "5.", "",
    "   ", None, "abc", "1.2.3", "--1", "1e", "e5", "nan", "-inf", "Infinity",
    "1_000", "1__0", "_1", "0x", "12abc", "\t7\n", "1 2", "-0", "3.0e-400",
]


def test_parse_doubles_equals_the_reference_and_the_python_route(plain):
    vals, mask = PN.parse_doubles(PARSE_FIELDS)
    jv, jm = JN.parse_doubles(PARSE_FIELDS)
    np.testing.assert_array_equal(mask, jm)
    np.testing.assert_array_equal(vals, jv)
    assert mask.tolist() == [
        True, True, True, True, True, True, True, True, True, False,
        False, False, False, False, False, False, False, True, True, True,
        True, False, False, False, False, True, False, True, True,
    ]
    plain()
    pv, pm = PN.parse_doubles(PARSE_FIELDS)
    np.testing.assert_array_equal(pm, mask)
    np.testing.assert_array_equal(pv, vals)


# -------------------------------------------------------------------- trees
@pytest.mark.parametrize("depth,trees", [(3, 5), (6, 40)])
def test_tree_predict_sum_equals_the_reference_and_the_tree_sum(depth, trees):
    """A stack with leaf-only levels at its bottom (the native walk folds
    them): the per-row sums equal the reference's native walk and the
    port's plain walk summed by ``tree_sum`` in tree order."""
    rng = np.random.default_rng(depth)
    n, f, width = 500, 12, 1 << depth
    binned = rng.integers(0, 32, (n, f)).astype(np.int32)
    sf = rng.integers(-1, f, (trees, depth, width)).astype(np.int32)
    sf[:, depth - 1, :] = -1
    sb = rng.integers(0, 32, (trees, depth, width)).astype(np.int32)
    lv = rng.normal(size=(trees, width)).astype(np.float32)
    got = PN.tree_predict_sum(binned, sf, sb, lv)
    np.testing.assert_array_equal(got, JN.tree_predict_sum(binned, sf, sb, lv))
    per_tree = serve_trees_reference(*map(torch.from_numpy, (binned, sf, sb, lv)))
    want = tree_sum(per_tree, boosted=True, eta=1.0, base_score=0.0)
    np.testing.assert_array_equal(got, want.numpy())
    with pytest.raises(IndexError):
        PN.tree_predict_sum(binned[:, :3], sf, sb, lv)


# ------------------------------------------------------------ build hygiene
def test_library_is_built_under_build_and_native_is_untouched(monkeypatch, tmp_path):
    """A fresh build lands in the build directory, keyed by the source's
    hash, and leaves the source's directory byte-identical: run on a copy
    of ``native/`` holding a stand-in for the JAX package's
    ``libtptpu.so`` (other test processes may build the real one)."""
    lib = PN.library()
    assert os.path.dirname(PN.build_info["path"]) == PN.BUILD_DIR
    assert os.path.basename(PN.BUILD_DIR) == "_build"
    assert PN.build_info["abi"] == PN.ABI_VERSION == int(lib.tp_abi_version())
    native = tmp_path / "native"
    native.mkdir()
    for name in ("tptpu_native.cpp", "Makefile"):
        (native / name).write_bytes(open(os.path.join(NATIVE_DIR, name), "rb").read())
    (native / "libtptpu.so").write_bytes(b"the JAX package's build")
    before = {p.name: _sha(str(p)) for p in native.iterdir()}
    monkeypatch.setattr(PN, "SOURCE", str(native / "tptpu_native.cpp"))
    monkeypatch.setattr(PN, "BUILD_DIR", str(tmp_path / "_build"))
    path, seconds = PN.build()
    assert seconds > 0 and os.path.dirname(path) == str(tmp_path / "_build")
    assert path == PN.library_path() and os.path.basename(path).startswith(
        "libtptpu_native-")
    assert os.listdir(tmp_path / "_build") == [os.path.basename(path)]
    assert {p.name: _sha(str(p)) for p in native.iterdir()} == before
    assert PN.build() == (path, 0.0)  # keyed by the source: built once


_CONCURRENT_BUILD = """
import sys
from transmogrifai_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
lib = native.library()
print(native.build_info["path"], int(lib.tp_abi_version()),
      int(native.murmur3_batch(["abc"])[0]))
"""


def test_two_processes_building_at_once_load_one_library(tmp_path):
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CONCURRENT_BUILD, str(tmp_path)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.split())
    assert outs[0] == outs[1]
    assert outs[0][1:] == ["3", str(murmur3_32("abc", 42))]
    assert os.listdir(tmp_path) == [os.path.basename(outs[0][0])]


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "false"])
def test_a_broken_compiler_raises_instead_of_falling_back(
    compiler, monkeypatch, tmp_path,
):
    monkeypatch.setattr(PN, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(PN, "COMPILER", compiler)
    monkeypatch.setattr(PN, "_LIB", None)
    with pytest.raises(KernelBuildError):
        PN.library()
    with pytest.raises(KernelBuildError):
        PN.murmur3_batch(["a"])
    with pytest.raises(KernelBuildError):
        PN.parse_doubles(["1"])
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".so")]


def test_a_library_of_another_abi_is_refused(monkeypatch):
    PN.library()
    monkeypatch.setattr(PN, "_LIB", None)
    monkeypatch.setattr(PN, "ABI_VERSION", PN.ABI_VERSION + 1)
    with pytest.raises(KernelBuildError, match="ABI 3"):
        PN.library()
