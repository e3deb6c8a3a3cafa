"""SegRec models (port of ``segmminterest_tpu/segrec/models``): torch
modules producing ``(scores (B, I), losses)``. Each model is one module;
the reference's *CTR / *Ranking class pairs map to the same module run
under different runners (CTR applies sigmoid + BCE, Ranking softmax-weighted
BPR).

``MODEL_REGISTRY`` holds the models this slice ports; every other name of
the JAX package's registry raises ``NotImplementedError`` (ROADMAP Queue A
item 4). No model stands in for another.
"""

from .cliprec import ClipWDModel
from .din import ClipDINModel, DINModel
from .widedeep import WideDeepModel

MODEL_REGISTRY = {
    "WideDeep": WideDeepModel,
    "DIN": DINModel,
    "ClipRec": ClipWDModel,     # reference ClipRec.py is the WideDeep variant
    "ClipWDRec": ClipWDModel,
    "ClipDINRec": ClipDINModel,
}

# the JAX package's other models (segmminterest_tpu/segrec/models/
# __init__.py:30-74, and the KG and Impression families of segrec/kg.py
# and segrec/rerank.py)
NOT_PORTED = (
    "BPRMF", "BUIR", "NeuMF", "LightGCN", "DirectAU", "POP", "SASRec",
    "GRU4Rec", "Caser", "NARM", "FPMC", "TiSASRec", "ComiRec", "ContraRec",
    "TiMiRec", "SRGNN", "CLRec", "FourierTA", "S3Rec", "FM", "DeepFM", "AFM",
    "xDeepFM", "SAM", "DCN", "DCNv2", "AutoInt", "FinalMLP", "AdaGIN",
    "DIEN", "CAN", "SDIM", "ETA", "ClipDCNv2Rec", "ClipAutoIntRec",
    "ClipFinalMLPRec", "ClipAdaGINRec", "ClipDIENRec", "ClipCANRec",
    "CFKG", "SLRCPlus", "Chorus", "KDA")


def model_class(name: str):
    """The registry's class for ``name``; a JAX model not ported yet
    raises ``NotImplementedError``."""
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"SegRec model {name} is not ported yet: ROADMAP Queue A item 4 "
            f"(the rest of SegRec); ported: {sorted(MODEL_REGISTRY)}")
    raise ValueError(f"unknown model {name}")


__all__ = ["MODEL_REGISTRY", "NOT_PORTED", "model_class", "ClipDINModel",
           "ClipWDModel", "DINModel", "WideDeepModel"]
