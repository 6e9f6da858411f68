"""pqt_tpu_torch: the PyTorch and CUDA port of the Product-Quantization-Tree
ANN engine `pqt_tpu`.

It trains a two-level PQ tree, builds the database in memory or out of core
(chunks encoded on the card, merged on the host into a CSR database that
may spill to disk and be saved as raw sidecars), and serves `query_knn`
(exact or line re-rank), `query_knn_refine` and `query_candidates` on the
pair and the parts pipelines, with the pair-occupancy filter and in rows
or slab gather mode, over raw vectors by id or in CSR order
(`vectors_csr`), and the BIG two-stage query (`query_big_knn`,
`query_big_knn_perfect`); the sparse/dense split tree (`train_tree_split`,
`build_split_database`, `query_knn_split`) and the multi-database engine
over part groups (`build_multi_database`, `query_multi_knn`) run on the
same paths.  `io/texmex.py` reads and writes the TexMex datasets,
`tools/` holds the convert, create_db and query command lines, and
`utils/diagnostics.py` the ground-truth bin probes and quantization
statistics.  The per-row top-k,
the prefix sums, the line re-rank, the segment sums, the table lookups and
the row gathers of those paths are hand-written CUDA kernels for Hopper
(`ops/cuda`, sources in `csrc/`), built with nvcc at first use; on CPU
tensors their plain PyTorch versions run instead.  Entry points take `device=` ("cuda" by default) and
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
from pqt_tpu_torch.io.artifacts import (load_database,  # noqa: E402
                                        load_tree, save_database, save_tree)
from pqt_tpu_torch.models.db import (ChunkedDBBuilder,  # noqa: E402
                                     ChunkFormatError, PQTDatabase,
                                     build_database, encode_chunk_to_file,
                                     merge_chunk_files,
                                     merge_chunk_files_range)
from pqt_tpu_torch.models.query import (QueryResult,  # noqa: E402
                                        query_candidates, query_knn,
                                        query_knn_refine)
from pqt_tpu_torch.models.query_big import (query_big_knn,  # noqa: E402
                                            query_big_knn_perfect)
from pqt_tpu_torch.models.multidb import (MultiDatabase,  # noqa: E402
                                          build_multi_database,
                                          place_multi_database,
                                          query_multi_knn)
from pqt_tpu_torch.models.split import (SplitDatabase,  # noqa: E402
                                        build_split_database,
                                        load_split_database, query_knn_split,
                                        save_split_database)
from pqt_tpu_torch.models.tree import (PQTree, train_tree,  # noqa: E402
                                       train_tree_split)

__all__ = [
    "PQTConfig", "SIFT1M_CONFIG", "SIFT1B_CONFIG", "GIST1M_CONFIG",
    "PQTree", "train_tree", "train_tree_split", "PQTDatabase",
    "build_database",
    "ChunkedDBBuilder", "ChunkFormatError", "encode_chunk_to_file",
    "merge_chunk_files", "merge_chunk_files_range",
    "QueryResult", "query_knn", "query_knn_refine", "query_candidates",
    "query_big_knn", "query_big_knn_perfect",
    "SplitDatabase", "build_split_database", "query_knn_split",
    "save_split_database", "load_split_database",
    "MultiDatabase", "build_multi_database", "place_multi_database",
    "query_multi_knn",
    "load_tree", "load_database", "save_tree", "save_database",
]
