"""SegRec — segment-integrated recommendation (Task 2), ported to PyTorch
(port of ``segmminterest_tpu/segrec``; the module names are the JAX
package's).

Readers -> fixed-shape numpy feeds -> torch models -> runners on the
device, plus the Clip* segment-integration models that weight per-segment
scores by Task-1 interest logits (``tasks/export_logits.py`` writes them).
This slice holds the corpus, the ranking and CTR feeds and runners,
``main`` and the models ClipWDRec (ClipRec), ClipDINRec, WideDeep and DIN;
the rest of the JAX package's SegRec is ROADMAP Queue A item 4.
"""

from .corpus import Corpus
from .runner import CTRRunner, RankingRunner

__all__ = ["Corpus", "RankingRunner", "CTRRunner"]
