"""Data ingestion, CLI, profiling trace."""

import json
import os

import numpy as np
import pytest

from rsparse_tpu.data.io import load_interactions
from rsparse_tpu.utils.profiling import FitTrace


def test_load_interactions(tmp_path):
    p = tmp_path / "ratings.csv"
    p.write_text("userId,movieId,rating\n"
                 "7,100,3.5\n7,200,4.0\n9,100,1.0\n42,300,5.0\n")
    m = load_interactions(str(p))
    assert m.shape == (3, 3)
    assert m.nnz == 4
    assert m.row_names == ["7", "9", "42"]
    assert m.col_names == ["100", "200", "300"]
    assert m[0, 1] == 4.0  # user 7, movie 200


def test_load_interactions_no_rating(tmp_path):
    p = tmp_path / "pairs.tsv"
    p.write_text("1\t5\n2\t6\n")
    m = load_interactions(str(p), sep="\t", skip_header=False)
    assert m.nnz == 2
    assert m.data.tolist() == [1.0, 1.0]


def test_cli_fit_and_recommend(tmp_path, capsys):
    from rsparse_tpu.cli import main
    out = str(tmp_path / "ckpt")
    rc = main(["fit", "--data", "movielens100k", "--rank", "8",
               "--n-iter", "2", "--eval-holdout", "0.2", "--out", out])
    assert rc == 0
    captured = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(captured)
    assert res["ndcg@k"] > 0.1
    assert os.path.exists(os.path.join(out, "arrays.npz"))

    rc = main(["recommend", "--checkpoint", out, "--data", "movielens100k",
               "-k", "3", "--limit", "2"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    rec = json.loads(lines[0])
    assert len(rec["items"]) == 3


def test_fit_trace(ml100k_split):
    from rsparse_tpu import WRMF
    train, _ = ml100k_split
    m = WRMF(rank=4, lambda_=0.1, solver="cholesky", precision="double",
             seed=0)
    m.fit_transform(train, n_iter=2, convergence_tol=-1)
    assert len(m.fit_trace) == 4  # 2 iters x 2 phases
    phases = {r["phase"] for r in m.fit_trace}
    assert phases == {"items", "users"}
    assert all(r["wall_s"] > 0 and np.isfinite(r["loss"])
               for r in m.fit_trace)
    assert set(m.fit_trace.summary()) == phases


@pytest.mark.parametrize("env_set", [True, False])
def test_use_compile_cache(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, wins and nothing is changed;
    otherwise the cache goes to the checkout's fixed .jax_cache."""
    import jax
    from rsparse_tpu.config import use_compile_cache
    before = jax.config.jax_compilation_cache_dir
    sentinel = str(tmp_path / "sentinel")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / "env"))
            assert use_compile_cache() == str(tmp_path / "env")
            assert jax.config.jax_compilation_cache_dir == sentinel
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            want = os.path.join(repo, ".jax_cache")
            assert use_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_load_interactions_string_ids(tmp_path):
    """Non-numeric user/item identifiers fall back to the host tokenizer
    and are densified with originals kept as row/col names."""
    p = tmp_path / "log.csv"
    p.write_text("user,item,value\nalice,apple,2\nbob,banana,1\n"
                 "alice,banana,3\n")
    from rsparse_tpu.data.io import load_interactions
    m = load_interactions(str(p))
    assert m.shape == (2, 2)
    assert m.row_names == ["alice", "bob"]
    assert m.col_names == ["apple", "banana"]
    assert m[0, 1] == 3.0 and m[1, 1] == 1.0
