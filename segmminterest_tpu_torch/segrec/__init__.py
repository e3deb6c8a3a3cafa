"""SegRec — segment-integrated recommendation (Task 2), ported to PyTorch
(port of ``segmminterest_tpu/segrec``; the module names are the JAX
package's).

Readers -> fixed-shape numpy feeds -> torch models -> runners on the
device, plus the Clip* segment-integration models that weight per-segment
scores by Task-1 interest logits (``tasks/export_logits.py`` writes them).
It holds the corpus, the ranking and CTR feeds and runners (full-sort
evaluation and the general and sequential models' loss routes among
them), ``main`` and every general, sequential and context model of the
JAX registry, the leave-frame ranking runner, Impression mode
(``impression``, ``rerank``) and the KG family (``kg``): every route of
the JAX CLI but a batch sharded over several cards.
"""

from .corpus import Corpus
from .runner import CTRRunner, LeaveRankingRunner, RankingRunner

__all__ = ["Corpus", "RankingRunner", "CTRRunner", "LeaveRankingRunner"]
