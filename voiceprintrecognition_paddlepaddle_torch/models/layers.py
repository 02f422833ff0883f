"""Shared model building blocks (counterpart of the JAX ``models/layers.py``
for the modules CAM++ needs).

Attribute names follow the flax parameter tree (``Dense_0``,
``BatchNorm_0``, ...) so that ``convert.jax_to_torch_state`` is a plain
tree walk. BatchNorm uses the reference's eps 1e-5 (momentum only matters
for training, which this slice does not port).
"""

import torch
from torch import nn

__all__ = ["batch_norm", "bn_affine", "DenseBN", "NonLinear"]

BN_EPS = 1e-5


def batch_norm(channels):
    """BatchNorm over the channel axis of an NC* tensor, reference eps."""
    return nn.BatchNorm1d(channels, eps=BN_EPS)


def bn_affine(bn):
    """Inference BN as a per-channel affine ``(a, b)`` in fp32:
    ``bn(x) = x * a + b``."""
    a = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return a, bn.bias.float() - bn.running_mean.float() * a


class NonLinear(nn.Module):
    """The ``batchnorm-relu`` stack (reference ``campplus.py:8-21``) on
    ``(B, C, T)``."""

    def __init__(self, channels, config_str="batchnorm-relu"):
        super().__init__()
        if config_str != "batchnorm-relu":
            raise NotImplementedError(
                f"config_str {config_str!r} is not ported yet; see "
                "ROADMAP.md queue 1")
        self.BatchNorm_0 = batch_norm(channels)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(x))


class DenseBN(nn.Module):
    """Linear then BatchNorm (``config_str="batchnorm_"``, the CAM++ embedding
    head) on ``(B, C)``."""

    def __init__(self, in_features, features):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.BatchNorm_0 = batch_norm(features)

    def forward(self, x):
        return self.BatchNorm_0(self.Dense_0(x))
