"""Module-path shim: the reference exposes the featurizer as
``ppvector.data_utils.featurizer.AudioFeaturizer``; the port's lives in
``ops.features`` (JAX ``data_utils/featurizer.py``)."""

from ..ops.features import AudioFeaturizer

__all__ = ["AudioFeaturizer"]
