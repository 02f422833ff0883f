"""Model zoo and factory (counterpart of the JAX ``models/__init__.py``):
the same ``model_conf.model`` / ``model_conf.model_args`` keys select and
parametrise a backbone. ``MFAConformer`` is the port's own: the JAX package
has no counterpart."""

from .campplus import CAMPPlus
from .conformer import MFAConformer
from .ecapa_tdnn import EcapaTdnn
from .eres2net import ERes2Net, ERes2NetV2
from .fc import SpeakerIdentification
from .res2net import Res2Net
from .resnet_se import ResNetSE
from .tdnn import TDNN

__all__ = ["build_model", "MODELS", "SpeakerIdentification", "CAMPPlus",
           "EcapaTdnn", "ERes2Net", "ERes2NetV2", "MFAConformer", "Res2Net",
           "ResNetSE", "TDNN"]

MODELS = {
    "CAMPPlus": CAMPPlus,
    "EcapaTdnn": EcapaTdnn,
    "ERes2Net": ERes2Net,
    "ERes2NetV2": ERes2NetV2,
    "MFAConformer": MFAConformer,
    "Res2Net": Res2Net,
    "ResNetSE": ResNetSE,
    "TDNN": TDNN,
}


def build_model(input_size, configs):
    """Instantiate the backbone named by ``configs.model_conf.model``."""
    use_model = configs.model_conf.get("model", "CAMPPlus")
    if use_model not in MODELS:
        raise ValueError(f"unknown model: {use_model}")
    # YAML lists arrive as lists; the JAX dataclass fields take tuples
    model_args = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in dict(configs.model_conf.get("model_args")
                                   or {}).items()}
    return MODELS[use_model](input_size=input_size, **model_args)
