"""SegRec models (port of ``segmminterest_tpu/segrec/models``): torch
modules producing ``(scores (B, I), losses)``. Each model is one module;
the reference's *CTR / *Ranking class pairs map to the same module run
under different runners (CTR applies sigmoid + BCE, Ranking softmax-weighted
BPR).

``MODEL_REGISTRY`` holds every model of the JAX package's registry: the
general, sequential and context models. :func:`model_class` finds those
and the KG family (``segrec/kg.py``: CFKG, SLRCPlus, Chorus, KDA, built
by ``segrec.main`` from the KG metadata); the impression rankers and the
rerankers are ``segrec/rerank.py``'s. No model stands in for another.
"""

from .adagin import AdaGINModel
from .autoint import AutoIntModel
from .can import CANModel
from .clip_variants import (ClipAdaGINModel, ClipAutoIntModel, ClipCANModel,
                            ClipDCNv2Model, ClipDIENModel, ClipFinalMLPModel)
from .cliprec import ClipWDModel
from .dcn import DCNModel, DCNv2Model
from .deepfm import AFMModel, DeepFMModel, XDeepFMModel
from .dien import DIENModel
from .din import ClipDINModel, DINModel
from .finalmlp import FinalMLPModel
from .fm import FMModel
from .general import (BPRMFModel, BUIRModel, DirectAUModel, LightGCNModel,
                      NeuMFModel, POPModel)
from .sam import SAMModel
from .sdim import ETAModel, SDIMModel
from .sequential import (CaserModel, CLRecModel, ComiRecModel,
                         ContraRecModel, FourierTAModel, FPMCModel,
                         GRU4RecModel, NARMModel, S3RecModel, SASRecModel,
                         SRGNNModel, TiMiRecModel, TiSASRecModel)
from .widedeep import WideDeepModel

MODEL_REGISTRY = {
    "BPRMF": BPRMFModel,
    "BUIR": BUIRModel,
    "NeuMF": NeuMFModel,
    "LightGCN": LightGCNModel,
    "DirectAU": DirectAUModel,
    "POP": POPModel,
    "SASRec": SASRecModel,
    "GRU4Rec": GRU4RecModel,
    "Caser": CaserModel,
    "NARM": NARMModel,
    "FPMC": FPMCModel,
    "TiSASRec": TiSASRecModel,
    "ComiRec": ComiRecModel,
    "ContraRec": ContraRecModel,
    "TiMiRec": TiMiRecModel,
    "SRGNN": SRGNNModel,
    "CLRec": CLRecModel,
    "FourierTA": FourierTAModel,
    "S3Rec": S3RecModel,
    "FM": FMModel,
    "WideDeep": WideDeepModel,
    "DeepFM": DeepFMModel,
    "AFM": AFMModel,
    "xDeepFM": XDeepFMModel,
    "SAM": SAMModel,
    "DCN": DCNModel,
    "DCNv2": DCNv2Model,
    "AutoInt": AutoIntModel,
    "FinalMLP": FinalMLPModel,
    "AdaGIN": AdaGINModel,
    "DIN": DINModel,
    "DIEN": DIENModel,
    "CAN": CANModel,
    "SDIM": SDIMModel,
    "ETA": ETAModel,
    "ClipRec": ClipWDModel,     # reference ClipRec.py is the WideDeep variant
    "ClipWDRec": ClipWDModel,
    "ClipDCNv2Rec": ClipDCNv2Model,
    "ClipAutoIntRec": ClipAutoIntModel,
    "ClipFinalMLPRec": ClipFinalMLPModel,
    "ClipAdaGINRec": ClipAdaGINModel,
    "ClipDINRec": ClipDINModel,
    "ClipDIENRec": ClipDIENModel,
    "ClipCANRec": ClipCANModel,
}



def model_class(name: str):
    """The class of the model ``name``: the registry's, or the KG
    family's; an unknown name raises ``ValueError``."""
    from ..kg import KG_MODELS
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name in KG_MODELS:
        return KG_MODELS[name]
    raise ValueError(f"unknown model {name}")


__all__ = ["MODEL_REGISTRY", "model_class"] + sorted(
    {cls.__name__ for cls in MODEL_REGISTRY.values()})
