"""End-to-end text8 run: corpus -> co-occurrence -> GloVe rank-128.

Zero-egress image: the corpus cannot be fetched here; this script is the
consumer for when it IS present.  Builds the standard GloVe term
co-occurrence matrix (symmetric window, 1/distance weighting, triangular
storage — the layout text2vec feeds the reference model,
R/model_GloVe.R:73-80) and fits the GloVe model.

Usage:
  python scripts/ingest_text8.py /path/to/text8 [rank] [n_iter] [vocab_min]
"""

import sys
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import scipy.sparse as sp


def build_tcm(tokens: np.ndarray, n_vocab: int, window: int = 10):
    """Triangular term-co-occurrence matrix with 1/distance weights."""
    rows, cols, vals = [], [], []
    n = len(tokens)
    for d in range(1, window + 1):
        a, b = tokens[:-d], tokens[d:]
        keep = (a >= 0) & (b >= 0)
        i, j = a[keep], b[keep]
        lo, hi = np.minimum(i, j), np.maximum(i, j)
        rows.append(lo)
        cols.append(hi)
        vals.append(np.full(len(lo), 1.0 / d, np.float64))
    m = sp.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_vocab, n_vocab)).tocsr()
    m.sum_duplicates()
    return m


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(2)
    path = sys.argv[1]
    rank = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    n_iter = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    vocab_min = int(sys.argv[4]) if len(sys.argv) > 4 else 5

    t0 = time.time()
    with open(path) as f:
        words = f.read().split()
    counts = Counter(words)
    vocab = {w: i for i, (w, c) in enumerate(
        sorted(counts.items(), key=lambda kv: -kv[1])) if c >= vocab_min}
    tokens = np.asarray([vocab.get(w, -1) for w in words], np.int64)
    print(f"corpus: {len(words)} tokens, vocab {len(vocab)} "
          f"({time.time()-t0:.1f}s)")

    t0 = time.time()
    tcm = build_tcm(tokens, len(vocab))
    print(f"tcm: nnz={tcm.nnz} ({time.time()-t0:.1f}s)")

    from rsparse_tpu.config import use_compile_cache
    use_compile_cache()
    from rsparse_tpu.models.glove import GloVe

    model = GloVe(rank=rank, x_max=100.0, learning_rate=0.15, seed=0,
                  shuffle=True)
    t0 = time.time()
    emb = model.fit_transform(tcm, n_iter=n_iter, convergence_tol=0.005)
    dt = time.time() - t0
    print(f"glove fit: {dt:.1f}s ({len(model.cost_history)} epochs, "
          f"{tcm.nnz * len(model.cost_history) / dt / 1e6:.1f} M "
          f"triplets/s); final loss {model.cost_history[-1]:.4f}")
    w = np.asarray(emb) + np.asarray(model.components).T
    out = sys.argv[5] if len(sys.argv) > 5 else "/tmp/text8_vectors.npy"
    np.save(out, w)
    print(f"wrote {out}", w.shape)


if __name__ == "__main__":
    main()
