"""End-to-end tests of the example CLIs (reference ``examples/`` parity:
bfs/sssp/pr/tc run + naive-oracle verification, pi, convert)."""

import os

import numpy as np
import pytest

import examples.bfs
import examples.convert
import examples.pi
import examples.pr
import examples.sssp
import examples.tc


@pytest.fixture(scope="module")
def mtx_path(tmp_path_factory):
    """Small random undirected graph in 1-based MatrixMarket format."""
    rng = np.random.default_rng(7)
    n, m = 60, 180
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    r, c = r[keep], c[keep]
    path = tmp_path_factory.mktemp("mtx") / "g.mtx"
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n")
        f.write(f"{n} {n} {r.size}\n")
        for i, j in zip(r, c):
            f.write(f"{i + 1} {j + 1}\n")
    return str(path)


COMMON = ["--niters", "1", "--run-acc", "false", "--verbose", "false"]


def test_bfs_example(mtx_path):
    assert examples.bfs.run(["--mtxpath", mtx_path, "--undirected", "true", *COMMON]) == 0


def test_sssp_example(mtx_path):
    assert examples.sssp.run(["--mtxpath", mtx_path, "--undirected", "true", *COMMON]) == 0


def test_pr_example(mtx_path):
    assert examples.pr.run(
        ["--mtxpath", mtx_path, "--undirected", "true", "--eps", "1e-5", *COMMON]
    ) == 0


def test_tc_example(mtx_path):
    assert examples.tc.run(["--mtxpath", mtx_path, "--undirected", "true", *COMMON]) == 0


def test_pi_example(capsys):
    assert examples.pi.run(["--n", "20000"]) == 0
    out = capsys.readouterr().out
    pi = float(out.strip().rsplit(" ", 1)[-1])
    # tolerance: a Monte-Carlo estimate from 20000 samples (sd ~0.012)
    assert abs(pi - 3.14159) < 0.1


def test_convert_example(mtx_path, tmp_path):
    out = str(tmp_path / "out.mtx")
    assert examples.convert.run(["--in", mtx_path, "--out", out]) == 0
    assert os.path.exists(out)
    # round-trip: reload what we saved
    from spla_tpu.io import load_mtx

    a = load_mtx(out, make_undirected=False, remove_loops=False)
    assert a.n_values > 0
