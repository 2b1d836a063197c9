"""Column-sharded ring collectives and per-key segment reductions
(``parallel/ring.py``, ``parallel/segments.py``) over worlds of 2 and 4
``gloo`` ranks on the CPU, held to ``tests/test_ring.py``'s and
``tests/test_parallel.py::TestSegmentReductions``' contracts: the ring
gram equals the dense XᵀX (rtol 2e-4 / atol 1e-3, at a width that does
not divide the world and at the wide axis), the ring correlation numpy's
(atol 1e-5, a constant column correlating 0), every segment monoid the
host's (within 1e-3), the padding neutral. Ranks agree bit for bit and
their tapes are identical."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import parallel_cases as C  # noqa: E402
import world  # noqa: E402

from transmogrifai_tpu_torch.parallel.ring import pad_cols  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: world.run_world(n, "parallel_cases:ring_segments", (),
                               tmp_path_factory.mktemp(f"ring{n}"))
            for n in (2, 4)}


def test_pad_cols():
    x = np.ones((3, 5), dtype=np.float32)
    xp, f = pad_cols(x, 4)
    assert xp.shape == (3, 8) and f == 5
    assert (xp[:, 5:] == 0).all()


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("name", ("ring_gram", "ring_gram_wide"))
def test_ring_gram_matches_dense(worlds, n, name):
    x = C.ring_inputs()[name].astype(np.float64)
    g = worlds[n][0][0][name]
    assert g.shape == (x.shape[1], x.shape[1])
    np.testing.assert_allclose(g, x.T @ x, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("n", (2, 4))
def test_ring_corr_matches_numpy(worlds, n):
    x = C.ring_inputs()["ring_corr"]
    c = worlds[n][0][0]["ring_corr"]
    keep = [i for i in range(9) if i != 3]
    ref = np.corrcoef(np.delete(x, 3, axis=1), rowvar=False)
    np.testing.assert_allclose(c[np.ix_(keep, keep)], ref, atol=1e-5)
    assert (c[3, :] == 0).all() and (c[:, 3] == 0).all()


@pytest.mark.parametrize("n", (2, 4))
def test_segment_ops_match_host(worlds, n):
    d = C.ring_inputs()
    seg, vals = d["seg"], d["vals"]
    got = worlds[n][0][0]
    for op, ref in [
        ("sum", lambda m: vals[m].sum()),
        ("max", lambda m: vals[m].max()),
        ("min", lambda m: vals[m].min()),
        ("mean", lambda m: vals[m].mean()),
        ("count", lambda m: float(m.sum())),
        ("or", lambda m: float((vals[m] != 0).any())),
    ]:
        for s in range(7):
            assert abs(got[f"seg_{op}"][s] - ref(seg == s)) < 1e-3, (op, s)


@pytest.mark.parametrize("n", (2, 4))
def test_aggregate_events_and_padding_invariance(worlds, n):
    got = worlds[n][0][0]
    assert got["events"] == {"u1": 7.0, "u2": 30.0, "u3": 100.0}
    # 3 rows over 2 or 4 ranks: the padding carries max's neutral
    assert got["seg_pad_max"][0] == 7.0 and got["seg_pad_max"][1] == -3.0


@pytest.mark.parametrize("n", (2, 4))
def test_ranks_agree_with_identical_tapes(worlds, n):
    (first, tapes0), *_ = worlds[n]
    for rank, (got, tapes) in enumerate(worlds[n]):
        for key, want in first.items():
            if isinstance(want, dict):
                assert got[key] == want
            else:
                np.testing.assert_array_equal(got[key], want)
        assert tapes["hosts"][str(rank)] == tapes0["hosts"]["0"]
    names = [name for _, name in tapes0["hosts"]["0"]]
    # three grams, each n - 1 ring passes and the gather of its blocks
    ring = 3 * n
    assert names[:ring] == (["ring_pass"] * (n - 1) + ["ring_gram"]) * 3
    assert set(names[ring:]) == {"psegment_reduce"}
