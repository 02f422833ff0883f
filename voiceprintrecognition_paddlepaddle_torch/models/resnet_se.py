"""SE-ResNet backbone, 2-D (counterpart of the JAX ``models/resnet_se.py``).

A 3x3 stem, four SEBottleneck stages (expansion 2) with
squeeze-excitation, then pooling over ``(F * C) x T`` and Linear -> BN to
the embedding. Takes ``(B, T, F)``, runs NCHW ``(B, C, F, T)`` inside.
"""

import torch
from torch import nn

from .layers import BN2d, BatchNorm1d
from .pooling import POOLING_DIM_FACTOR, POOLINGS

__all__ = ["ResNetSE"]


def halved(n):
    """Size after a stride-2 3x3 conv with pad 1 (or a stride-2 1x1)."""
    return (n + 1) // 2


class SELayer(nn.Module):
    """Squeeze-excitation over the mean of all of F and T. As in JAX it
    takes no mask: padded frames enter the mean."""

    def __init__(self, channels, reduction=8):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels // reduction)
        self.Dense_1 = nn.Linear(channels // reduction, channels)

    def forward(self, x):
        y = torch.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return x * torch.sigmoid(self.Dense_1(y))[:, :, None, None]


class SEBottleneck(nn.Module):
    def __init__(self, in_planes, planes, stride=1, downsample=False,
                 reduction=8, expansion=2):
        super().__init__()
        out = planes * expansion
        self.Conv_0 = nn.Conv2d(in_planes, planes, 1)
        self._BN2d_0 = BN2d(planes)
        self.Conv_1 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1)
        self._BN2d_1 = BN2d(planes)
        self.Conv_2 = nn.Conv2d(planes, out, 1)
        self._BN2d_2 = BN2d(out)
        self.SELayer_0 = SELayer(out, reduction)
        self.downsample = downsample
        if downsample:
            # flax's SAME padding of a 1x1 stride-2 conv pads nothing
            self.Conv_3 = nn.Conv2d(in_planes, out, 1, stride=stride)
            self._BN2d_3 = BN2d(out)

    def forward(self, x):
        out = torch.relu(self._BN2d_0(self.Conv_0(x)))
        out = torch.relu(self._BN2d_1(self.Conv_1(out)))
        out = self.SELayer_0(self._BN2d_2(self.Conv_2(out)))
        residual = self._BN2d_3(self.Conv_3(x)) if self.downsample else x
        return torch.relu(out + residual)


class ResNetSE(nn.Module):
    def __init__(self, input_size, layers=(3, 4, 6, 3),
                 num_filters=(32, 64, 128, 256), embd_dim=192,
                 pooling_type="ASP"):
        super().__init__()
        if pooling_type not in POOLINGS:
            raise ValueError(f"no pooling layer {pooling_type}")
        expansion = 2
        self.Conv_0 = nn.Conv2d(1, num_filters[0], 3, padding=1)
        self._BN2d_0 = BN2d(num_filters[0])
        in_planes, f, n = num_filters[0], input_size, 0
        for stage, stride in enumerate((1, 2, 2, 2)):
            planes = num_filters[stage]
            need_ds = stride != 1 or in_planes != planes * expansion
            for i in range(layers[stage]):
                setattr(self, f"SEBottleneck_{n}", SEBottleneck(
                    in_planes, planes, stride if i == 0 else 1,
                    downsample=need_ds and i == 0))
                in_planes, n = planes * expansion, n + 1
            f = halved(f) if stride == 2 else f
        self.n_blocks = n
        pool = POOLINGS[pooling_type]
        self._pool = f"{pool.__name__}_0"
        setattr(self, self._pool, pool(f * in_planes))
        out = f * in_planes * POOLING_DIM_FACTOR[pooling_type]
        self.BatchNorm1d_0 = BatchNorm1d(out)
        self.Dense_0 = nn.Linear(out, embd_dim)
        self.BatchNorm1d_1 = BatchNorm1d(embd_dim)

    def forward(self, x, lengths=None):
        x = x.transpose(1, 2)[:, None]                       # (B, 1, F, T)
        x = torch.relu(self._BN2d_0(self.Conv_0(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"SEBottleneck_{i}")(x)
        b, c, f, t = x.shape
        x = x.permute(0, 3, 2, 1).reshape(b, t, f * c)
        x = self.BatchNorm1d_0(getattr(self, self._pool)(x, lengths))
        return self.BatchNorm1d_1(self.Dense_0(x))
