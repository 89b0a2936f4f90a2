"""End-to-end ML-20M run: ingest ratings.csv -> WRMF rank-128 -> metrics.

The image has zero egress, so the dataset cannot be fetched here; this
script is the missing consumer for when it IS present (driver config #2:
WRMF-implicit rank-128 on ML-20M).  It exercises the exact path the bench
synthesizes: `data/io.py` ingestion -> `fit_transform` (staging, hot/cold
split, training sweeps, closing exact transform) -> held-out NDCG@10/MAP@10
-> top-k predict.

Usage:
  python scripts/ingest_ml20m.py /path/to/ml-20m/ratings.csv [rank] [n_iter]

ratings.csv format (MovieLens): userId,movieId,rating,timestamp with header.
"""

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(2)
    path = sys.argv[1]
    rank = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    n_iter = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    if not os.path.exists(path):
        print(f"dataset not found: {path} (zero-egress image: place the "
              "MovieLens ratings.csv there first)")
        sys.exit(1)

    from rsparse_tpu.config import use_compile_cache
    use_compile_cache()

    import rsparse_tpu as rt
    from rsparse_tpu.data.io import load_interactions

    t0 = time.time()
    x = load_interactions(path, sep=",", skip_header=True)
    print(f"ingested {path}: {x.shape} nnz={x.nnz} "
          f"({time.time()-t0:.1f}s)")

    rng = np.random.default_rng(0)
    train, test = rt.train_test_split(x, 0.1, rng)

    model = rt.WRMF(rank=rank, lambda_=0.1, feedback="implicit",
                    solver="conjugate_gradient", seed=0,
                    compute_dtype="bfloat16")
    t0 = time.time()
    model.fit_transform(train, n_iter=n_iter)
    fit_s = time.time() - t0
    sweeps = 2 * len(model.loss_history) + 1
    ups = train.shape[0] * sweeps / fit_s
    print(f"fit: {fit_s:.1f}s for {len(model.loss_history)} iterations "
          f"-> ~{ups:,.0f} entity-updates/s incl. staging; "
          f"final loss {model.loss_history[-1]:.4f}")

    t0 = time.time()
    preds = model.predict(train, k=10, not_recommend=train)
    ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
    mapk = float(np.nanmean(rt.ap_k(preds.indices, test)))
    print(f"predict top-10 for {train.shape[0]} users: "
          f"{time.time()-t0:.1f}s; NDCG@10={ndcg:.4f} MAP@10={mapk:.4f}")


if __name__ == "__main__":
    main()
