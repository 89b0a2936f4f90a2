"""rsparse_tpu: sparse matrix factorization & candidate retrieval in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
``rsparse`` R package (statistical learning on sparse matrices): WRMF/iALS,
Linear-Flow, soft-SVD / soft-impute, PureSVD, GloVe, RankMF, factorization
machines, FTRL, top-k retrieval, and ranking metrics — batched onto the matrix units
and sharded over device meshes instead of OpenMP threads.
"""

__version__ = "0.1.0"

from .config import default_device_count, logger, resolve_dtype  # noqa: F401
from .data.movielens import load_movielens100k  # noqa: F401
from .models.base import MatrixFactorizationRecommender, TopK  # noqa: F401
from .models.fm import FactorizationMachine  # noqa: F401
from .models.ftrl import FTRL  # noqa: F401
from .models.glove import GloVe  # noqa: F401
from .models.linear_flow import LinearFlow  # noqa: F401
from .models.rankmf import RankMF  # noqa: F401
from .models.pure_svd import PureSVD  # noqa: F401
from .models.scale_normalize import ScaleNormalize  # noqa: F401
from .models.soft_als import (SVDResult, soft_als, soft_impute,  # noqa: F401
                              soft_svd)
from .models.wrmf import WRMF  # noqa: F401
from .models.kmeans import kmeans  # noqa: F401
from .ops.topk import top_product  # noqa: F401
from .sparse.splr import SparsePlusLowRank  # noqa: F401
from .utils import checkpoint  # noqa: F401
from .utils.metrics import ap_k, ndcg_k  # noqa: F401
from .utils.split import train_test_split  # noqa: F401
