"""The port's sharded reductions (``parallel/reductions.py``) at worlds of
1, 2 and 4 ranks (``gloo`` on the CPU), held against numpy at
``tests/test_parallel.py``'s tolerances and against the JAX package's
same reductions at ``make_mesh(n_data=2 / 4)`` on the test run's simulated
CPU devices. Counts, min and max are exact; every rank's result is
bit-equal, two runs are bit-equal, and the ranks' collective tapes are
identical. The statistics plane's mesh route (``utils/stats.py``) agrees
with its one-rank route, and without an execution mesh (``set_parallelism
(None)``) each rank's statistics are those of its own rows."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import parallel_cases as C  # noqa: E402
import world  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world size -> [(runs, tapes)] per rank; world 1 runs in this
    process (no process group)."""
    out = {1: [(C.reductions(), None)]}
    for n in (2, 4):
        out[n] = world.run_world(n, "parallel_cases:reductions", (),
                                 tmp_path_factory.mktemp(f"red{n}"))
    return out


def _first(runs, n):
    return runs[n][0][0][0]


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


@pytest.mark.parametrize("n", WORLDS)
def test_reductions_match_numpy(runs, n):
    d = C.reduction_inputs()
    r = _first(runs, n)
    x = d["x"]
    cs = r["pcolumn_stats"]
    assert cs["count"] == 1001
    np.testing.assert_allclose(cs["mean"], x.mean(axis=0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        cs["m2"], ((x - x.mean(axis=0)) ** 2).sum(axis=0), rtol=1e-3)
    # min and max are exact: the float32 of the column's extremes
    np.testing.assert_array_equal(cs["min"], x.astype(np.float32).min(axis=0))
    np.testing.assert_array_equal(cs["max"], x.astype(np.float32).max(axis=0))
    off = r["pcolumn_stats_offset"]
    var = off["m2"] / (off["count"] - 1)
    np.testing.assert_allclose(var, d["x_offset"].var(axis=0, ddof=1),
                               rtol=5e-2)
    g, _, cnt = r["pcentered_gram"]
    cov = g / (cnt - 1)
    corr = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    expect = np.corrcoef(d["x_corr"][:, 0], d["x_corr"][:, 1])[0, 1]
    assert abs(corr - expect) < 0.05 and expect > 0.3
    np.testing.assert_allclose(r["pxtx"], d["x_xtx"].T @ d["x_xtx"],
                               rtol=2e-4, atol=1e-5)
    for f in range(4):  # counts: exact
        np.testing.assert_array_equal(
            r["phistogram"][f], np.bincount(d["codes"][:, f], minlength=16))
    expect_w = np.zeros((2, 8))
    for f in range(2):
        np.add.at(expect_w[f], d["codes_w"][:, f], d["w"])
    np.testing.assert_allclose(r["phistogram_w"], expect_w, rtol=1e-5)
    np.testing.assert_array_equal(r["pcontingency"], d["g"].T @ d["y"])


@pytest.mark.parametrize("n", (2, 4))
def test_reductions_match_the_jax_package(runs, n):
    from transmogrifai_tpu.parallel import make_mesh
    from transmogrifai_tpu.parallel import reductions as JR

    d = C.reduction_inputs()
    r = _first(runs, n)
    mesh = make_mesh(n_data=n)
    js = JR.pcolumn_stats(d["x"], mesh)
    assert float(js["count"]) == float(r["pcolumn_stats"]["count"])
    np.testing.assert_array_equal(r["pcolumn_stats"]["min"], js["min"])
    np.testing.assert_array_equal(r["pcolumn_stats"]["max"], js["max"])
    np.testing.assert_allclose(r["pcolumn_stats"]["mean"], js["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["pcolumn_stats"]["m2"], js["m2"], rtol=1e-4)
    jg, jmean, jn = JR.pcentered_gram(d["x_corr"], mesh)
    g, mean, cnt = r["pcentered_gram"]
    assert cnt == jn
    np.testing.assert_allclose(mean, jmean, rtol=1e-6)
    np.testing.assert_allclose(g, jg, rtol=1e-4)
    np.testing.assert_allclose(r["pxtx"], JR.pxtx(d["x_xtx"], mesh),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(r["phistogram"],
                                  JR.phistogram(d["codes"], 16, mesh))
    np.testing.assert_allclose(
        r["phistogram_w"],
        JR.phistogram(d["codes_w"], 8, mesh, weights=d["w"]), rtol=1e-6)
    np.testing.assert_array_equal(r["pcontingency"],
                                  JR.pcontingency(d["g"], d["y"], mesh))


@pytest.mark.parametrize("n", (2, 4))
def test_ranks_and_runs_are_bit_equal_and_tapes_identical(runs, n):
    per_rank = runs[n]
    first_runs, tapes0 = per_rank[0]
    assert _same(first_runs[0], first_runs[1])  # two runs
    for rank, (rank_runs, tapes) in enumerate(per_rank):
        # the routes' "own" statistics are of each rank's own data
        assert _same(rank_runs[:-1], first_runs[:-1])
        for route in ("base", "mesh"):
            assert _same(rank_runs[-1][route], first_runs[-1][route])
        assert tapes["hosts"][str(rank)] == tapes0["hosts"]["0"]
    names = [name for _, name in tapes0["hosts"]["0"]]
    # each all-reduce tapes once, under its reduction's name, in call order
    stats = ["pcolumn_stats.sums", "pcolumn_stats.range", "pcolumn_stats.m2"]
    assert names[:12] == stats + stats + [
        "pcentered_gram.sums", "pcentered_gram.gram", "pxtx", "phistogram",
        "phistogram", "pcontingency"]


@pytest.mark.parametrize("n", WORLDS)
def test_stats_plane_mesh_route_matches_one_rank_route(runs, n):
    """``tests/test_parallel.py::test_stats_plane_uses_mesh_path``: with
    the threshold dropped to 0, column stats, correlation and the
    contingency tables take the mesh route (at world 1 there is none) and
    agree with the float64 one-rank route."""
    routes = runs[n][0][0][-1]
    base, meshed = routes["base"], routes["mesh"]
    np.testing.assert_allclose(meshed["mean"], base["mean"], rtol=1e-5)
    np.testing.assert_allclose(meshed["variance"], base["variance"], rtol=1e-4)
    np.testing.assert_allclose(meshed["min"], base["min"], rtol=1e-6)
    np.testing.assert_allclose(meshed["max"], base["max"], rtol=1e-6)
    np.testing.assert_allclose(meshed["corr"], base["corr"], atol=1e-4)
    for a, b in zip(meshed["tables"], base["tables"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", (2, 4))
def test_stats_without_a_mesh_are_each_ranks_own(runs, n):
    """With no execution mesh installed (``use_execution_mesh(None)``,
    what ``set_parallelism(None)`` installs) the statistics make no
    collective even at or above the size threshold: each rank, holding
    data of its own, gets the statistics of its own rows, equal to the
    same call in a process without a world. In a world of two, a
    ``train()`` under ``set_parallelism(None)`` on each rank's own table
    gives the sanity checker's statistics of that table."""
    from transmogrifai_tpu_torch.utils import stats as S

    saved = S._DEVICE_THRESHOLD
    S._DEVICE_THRESHOLD = 0
    try:
        want = [C._stats_run(torch.float32, seed=6 + r) for r in range(n)]
        flows = [C.own_sanity(r) for r in range(2)] if n == 2 else None
    finally:
        S._DEVICE_THRESHOLD = saved
    for rank, (rank_runs, tapes) in enumerate(runs[n]):
        routes = rank_runs[-1]
        assert _same(routes["own"], want[rank])
        if flows is not None:
            np.testing.assert_allclose(routes["own_sanity"], flows[rank],
                                       rtol=1e-12, atol=0)
    assert not _same(want[0]["mean"], want[1]["mean"])
    if flows is not None:
        assert not np.allclose(flows[0], flows[1])
