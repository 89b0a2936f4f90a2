"""Command-line interface: fit / evaluate / benchmark from the shell.

    python -m rsparse_tpu fit --data ratings.csv --model wrmf --rank 32 \
        --out ckpt/ --eval-holdout 0.2
    python -m rsparse_tpu recommend --checkpoint ckpt/ --data ratings.csv -k 10
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _fit(args) -> int:
    import rsparse_tpu as rt
    from rsparse_tpu.data.io import load_interactions
    from rsparse_tpu.utils import checkpoint
    from rsparse_tpu.utils.profiling import trace

    if args.data == "movielens100k":
        x = rt.load_movielens100k()
    else:
        x = load_interactions(args.data, sep=args.sep)
    print(f"data: {x.shape} nnz={x.nnz}", file=sys.stderr)

    test = None
    if args.eval_holdout > 0:
        rng = np.random.default_rng(args.seed)
        x, test = rt.train_test_split(x, args.eval_holdout, rng)

    if args.model == "wrmf":
        model = rt.WRMF(rank=args.rank, lambda_=args.lambda_,
                        feedback=args.feedback, solver=args.solver,
                        precision=args.precision, seed=args.seed)
    elif args.model == "puresvd":
        model = rt.PureSVD(rank=args.rank, lambda_=args.lambda_,
                           precision=args.precision, seed=args.seed)
    elif args.model == "linearflow":
        model = rt.LinearFlow(rank=args.rank, lambda_=args.lambda_,
                              precision=args.precision, seed=args.seed)
    else:
        print(f"unknown model {args.model}", file=sys.stderr)
        return 2

    t0 = time.time()
    with trace(args.profile_dir):
        model.fit_transform(x, n_iter=args.n_iter)
    fit_s = time.time() - t0
    print(f"fit: {fit_s:.1f}s", file=sys.stderr)

    result = {"model": args.model, "rank": args.rank, "fit_seconds": fit_s}
    if test is not None:
        preds = model.predict(x, k=args.k, not_recommend=x)
        result["ndcg@k"] = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
        result["map@k"] = float(np.nanmean(rt.ap_k(preds.indices, test)))
    if args.out:
        checkpoint.save(model, args.out)
        result["checkpoint"] = args.out
    print(json.dumps(result))
    return 0


def _recommend(args) -> int:
    import rsparse_tpu as rt
    from rsparse_tpu.data.io import load_interactions
    from rsparse_tpu.utils import checkpoint

    model = checkpoint.load(args.checkpoint)
    if args.data == "movielens100k":
        x = rt.load_movielens100k()
    else:
        x = load_interactions(args.data, sep=args.sep)
    preds = model.predict(x, k=args.k, not_recommend=x)
    ids = preds.ids if preds.ids is not None else preds.indices
    for u in range(min(len(ids), args.limit)):
        uid = preds.user_ids[u] if preds.user_ids else u
        print(json.dumps({"user": str(uid),
                          "items": [str(i) for i in ids[u]],
                          "scores": [round(float(s), 4)
                                     for s in preds.scores[u]]}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsparse_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fit", help="fit a model")
    f.add_argument("--data", required=True,
                   help="CSV path or 'movielens100k'")
    f.add_argument("--sep", default=",")
    f.add_argument("--model", default="wrmf",
                   choices=["wrmf", "puresvd", "linearflow"])
    f.add_argument("--rank", type=int, default=32)
    f.add_argument("--lambda", dest="lambda_", type=float, default=0.1)
    f.add_argument("--feedback", default="implicit",
                   choices=["implicit", "explicit"])
    f.add_argument("--solver", default="conjugate_gradient",
                   choices=["conjugate_gradient", "cholesky", "nnls"])
    f.add_argument("--precision", default="float32")
    f.add_argument("--n-iter", type=int, default=10)
    f.add_argument("--eval-holdout", type=float, default=0.0)
    f.add_argument("-k", type=int, default=10)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--out", default=None, help="checkpoint directory")
    f.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace here")
    f.set_defaults(fn=_fit)

    r = sub.add_parser("recommend", help="top-k from a checkpoint")
    r.add_argument("--checkpoint", required=True)
    r.add_argument("--data", required=True)
    r.add_argument("--sep", default=",")
    r.add_argument("-k", type=int, default=10)
    r.add_argument("--limit", type=int, default=10)
    r.set_defaults(fn=_recommend)

    args = p.parse_args(argv)
    from .config import use_compile_cache
    use_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
