"""MMRec-style multimodal graph recommenders (SkipPredBaseline/MMRec),
ported to PyTorch (port of ``segmminterest_tpu/mmrec``; the module names
are the JAX package's).

Frame-as-item universe, triplet BPR training over full-graph embeddings on
the device, leave-rank evaluation through the same interest_TopK path as
the reference fork.
"""

from .graph import bipartite_norm_edges, knn_item_graph, propagate
from .models import MMREC_REGISTRY
from .runner import MMRecConfig, MMRecRunner

__all__ = ["bipartite_norm_edges", "knn_item_graph", "propagate",
           "MMREC_REGISTRY", "MMRecRunner", "MMRecConfig"]
