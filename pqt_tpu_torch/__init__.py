"""pqt_tpu_torch: the PyTorch and CUDA port of the Product-Quantization-Tree
ANN engine `pqt_tpu`.

It trains a two-level PQ tree, builds the in-memory database and serves
`query_knn` (exact or line re-rank) and `query_knn_refine` on the pair
pipeline.  The per-row top-k, the prefix sums and the line re-rank of that
path are hand-written CUDA kernels for Hopper (`ops/cuda`, sources in
`csrc/`), built with nvcc at first use; on CPU tensors their plain PyTorch
versions run instead.  Entry points take `device=` ("cuda" by default) and
raise when no card is present unless the caller passes device="cpu".

Importing the package turns TF32 off for CUDA matmuls and cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`): the distance tables need full
float32 products.  It imports neither JAX nor the JAX package.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from pqt_tpu_torch.config import (GIST1M_CONFIG, PQTConfig,  # noqa: E402
                                  SIFT1B_CONFIG, SIFT1M_CONFIG)
from pqt_tpu_torch.io.artifacts import load_database, load_tree  # noqa: E402
from pqt_tpu_torch.models.db import PQTDatabase, build_database  # noqa: E402
from pqt_tpu_torch.models.query import (QueryResult,  # noqa: E402
                                        query_candidates, query_knn,
                                        query_knn_refine)
from pqt_tpu_torch.models.tree import PQTree, train_tree  # noqa: E402

__all__ = [
    "PQTConfig", "SIFT1M_CONFIG", "SIFT1B_CONFIG", "GIST1M_CONFIG",
    "PQTree", "train_tree", "PQTDatabase", "build_database",
    "QueryResult", "query_knn", "query_knn_refine", "query_candidates",
    "load_tree", "load_database",
]
