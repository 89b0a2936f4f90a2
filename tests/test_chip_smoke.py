"""chip_smoke.py off the card: it refuses to run, and its float64 numpy
references agree with the library's CPU path at a small size."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def problem(cs):
    return cs.synth_implicit(300, 120, 3_000, seed=1)


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run(SCRIPT, REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repo."""
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_synth_implicit_exact_shape(cs, problem):
    x = problem
    assert x.shape == (300, 120) and x.nnz == 3_000
    assert (x.data >= 1.0).all()
    coo = x.tocoo()
    assert len(set(zip(coo.row.tolist(), coo.col.tolist()))) == x.nnz
    rows = cs.spread_rows(x, 16)
    lengths = np.diff(x.indptr)
    assert (lengths[rows] > 0).all()
    assert lengths[rows].max() == lengths.max()


def test_ref_exact_transform_matches_wrmf(cs, problem):
    """float64 normal equations vs WRMF's exact (Cholesky) transform."""
    import rsparse_tpu as rt
    m = rt.WRMF(rank=8, lambda_=0.5, feedback="implicit", solver="cholesky",
                precision="double", seed=0)
    m.fit_transform(problem, n_iter=2, convergence_tol=-1)
    got = np.asarray(m.transform(problem))
    want = cs.ref_exact_transform(m.components.T, problem, 0.5)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_ref_cg_matches_cg_sweep(cs, problem):
    from rsparse_tpu.ops.als import (ALSConfig, CONJUGATE_GRADIENT,
                                     wrmf_sweep_streamed)
    from rsparse_tpu.sparse.device import bucket_rows
    rng = np.random.default_rng(2)
    V = rng.standard_normal((120, 8)) * 0.3
    x0 = rng.standard_normal((300, 8)) * 0.01
    cfg = ALSConfig(feedback="implicit", solver=CONJUGATE_GRADIENT)
    got, _ = wrmf_sweep_streamed(
        jnp.asarray(V), jnp.asarray(x0),
        bucket_rows(problem, jnp.float64).buckets, None, 0.5, 0.0, cfg)
    want = cs.ref_cg(V, problem, 0.5, x0, n_steps=3)
    live = np.diff(problem.indptr) > 0          # empty rows are not solved
    np.testing.assert_allclose(np.asarray(got)[live], want[live],
                               rtol=1e-8, atol=1e-10)


def test_ref_masked_topk_and_score_check(cs, problem):
    import rsparse_tpu as rt
    rng = np.random.default_rng(3)
    U = rng.standard_normal((300, 8)).astype(np.float32)
    comps = rng.standard_normal((8, 120)).astype(np.float32)
    idx, _ = rt.top_product(U, comps, 5, not_recommend=problem)
    order, s_ref = cs.ref_masked_topk(U, comps, problem, 5)
    np.testing.assert_array_equal(idx, order)
    assert cs.check_topk_by_score(idx, s_ref, U, comps, problem, 5,
                                  rel_eps=2.0 ** -20) == 1.0
    bad = idx.copy()
    bad[0, -1] = problem.indices[problem.indptr[0]]      # a masked item
    with pytest.raises(AssertionError, match="masked"):
        cs.check_topk_by_score(bad, s_ref, U, comps, problem, 5,
                               rel_eps=2.0 ** -20)
