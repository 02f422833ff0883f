"""Training objectives and their factory (counterpart of the JAX
``loss/__init__.py``; reference ``ppvector/loss/__init__.py:16-22``)."""

from ..utils.logger import logger
from .losses import (AAMLoss, AMLoss, ARMLoss, CELoss, SphereFace2,
                     SubCenterLoss, TripletAngularMarginLoss)

__all__ = ["build_loss", "LOSSES", "AAMLoss", "AMLoss", "ARMLoss", "CELoss",
           "SphereFace2", "SubCenterLoss", "TripletAngularMarginLoss"]

LOSSES = {
    "AAMLoss": AAMLoss,
    "AMLoss": AMLoss,
    "ARMLoss": ARMLoss,
    "CELoss": CELoss,
    "SphereFace2": SphereFace2,
    "SubCenterLoss": SubCenterLoss,
    "TripletAngularMarginLoss": TripletAngularMarginLoss,
}


def build_loss(configs):
    use_loss = configs.loss_conf.get("loss", "AAMLoss")
    loss_args = dict(configs.loss_conf.get("loss_args", {}))
    if use_loss not in LOSSES:
        raise ValueError(f"unknown loss: {use_loss}")
    loss = LOSSES[use_loss](**loss_args)
    logger.info(f"created loss: {use_loss}, args: {loss_args}")
    return loss
