"""Per-rank ingest (``parallel/multihost.py``) over worlds of 2 and 4
``gloo`` ranks on the CPU: the padded row layout (rank r owns the block
[r·chunk, (r+1)·chunk) of the rows padded to a multiple of the ranks,
clipped to the real rows), ``read_host_block`` retrying a transient
failure, ``ingest_global_array`` (the block zero-padded, the global array
gathered back whole) and ``global_column_stats`` against numpy; and
``initialize_distributed`` with nothing configured staying a world of
one, and a failed init raising. ``resolve_device(None)`` under a world
names the rank's card. The ranks' tapes are identical."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import world  # noqa: E402

from transmogrifai_tpu_torch.parallel import multihost as M  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

NUM_ROWS = 1003


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: world.run_world(n, "parallel_cases:multihost", (),
                               tmp_path_factory.mktemp(f"mh{n}"))
            for n in (2, 4)}


def _full() -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.normal(loc=5.0, size=(NUM_ROWS, 4)).astype(np.float32)


@pytest.mark.parametrize("n", (2, 4))
def test_host_row_slices_tile_the_real_rows(worlds, n):
    padded = -(-NUM_ROWS // n) * n
    chunk = padded // n
    slices = [r[0]["slice"] for r in worlds[n]]
    assert [r[0]["padded"] for r in worlds[n]] == [padded] * n
    assert slices == [(min(k * chunk, NUM_ROWS), min((k + 1) * chunk, NUM_ROWS))
                      for k in range(n)]


@pytest.mark.parametrize("n", (2, 4))
def test_read_host_block_retries_a_transient_failure(worlds, n):
    full = _full()
    for got, _ in worlds[n]:
        lo, hi = got["slice"]
        assert got["attempts"] == 2
        np.testing.assert_array_equal(got["block"], full[lo:hi])


@pytest.mark.parametrize("n", (2, 4))
def test_ingest_global_array_round_trips(worlds, n):
    full = _full()
    padded = -(-NUM_ROWS // n) * n
    for got, _ in worlds[n]:
        assert got["global_shape"] == (padded, 4)
        np.testing.assert_array_equal(got["gathered"][:NUM_ROWS], full)
        assert (got["gathered"][NUM_ROWS:] == 0).all()


@pytest.mark.parametrize("n", (2, 4))
def test_global_column_stats_match_numpy(worlds, n):
    full = _full().astype(np.float64)
    stats = [r[0]["stats"] for r in worlds[n]]
    assert stats[0]["count"] == NUM_ROWS
    np.testing.assert_allclose(stats[0]["mean"], full.mean(axis=0), rtol=1e-5)
    np.testing.assert_allclose(stats[0]["var"], full.var(axis=0), rtol=1e-4)
    for s in stats[1:]:  # every rank the same bits
        for key in ("mean", "var"):
            np.testing.assert_array_equal(s[key], stats[0][key])


@pytest.mark.parametrize("n", (2, 4))
def test_tapes_identical(worlds, n):
    tapes = [r[1]["hosts"][str(k)] for k, r in enumerate(worlds[n])]
    assert all(t == tapes[0] for t in tapes)
    assert [name for _, name in tapes[0]] == [
        "gather_global_array", "global_column_stats.sums",
        "global_column_stats.m2"]


@pytest.mark.parametrize("n", (2, 4))
def test_resolve_device_names_the_ranks_card(worlds, n):
    """``resolve_device(None)`` under a world is ``cuda:{local rank}``
    taken modulo the host's cards: with one card every rank shares it,
    with four each rank has its own."""
    for rank, (got, _) in enumerate(worlds[n]):
        assert got["card1"] == "cuda:0"
        assert got["card4"] == f"cuda:{rank % 4}"


def test_a_failed_init_fails_with_no_retry(tmp_path):
    """No fallback: a world whose other rank never comes raises out of
    ``initialize_distributed`` (no retry on another backend), and leaves
    no process group behind."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError):
        M.initialize_distributed(init_method=f"file://{tmp_path}/store",
                                 world_size=2, rank=0, backend="gloo",
                                 timeout=2)
    assert not dist.is_initialized()


def test_initialize_distributed_unconfigured_is_a_world_of_one(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert M.initialize_distributed() is False
    assert M.host_row_slice(10) == slice(0, 10)
    assert M.layout_backend(local_ranks=1) == (
        "nccl" if torch.cuda.is_available() else "gloo")
