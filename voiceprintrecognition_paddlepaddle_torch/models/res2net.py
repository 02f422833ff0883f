"""Res2Net backbone, 2-D (counterpart of the JAX ``models/res2net.py``).

A 7x7 stride-3 stem (pad 1) and a 3x3 stride-2 max pool (pad 1, padded
with -inf), four Bottle2neck stages (split-scale hierarchical 3x3 convs,
expansion 4; a stage's first block average-pools its last split,
excluding the padding from the divisor), then pooling over
``(F * C) x T`` and Linear -> BN to the embedding. Takes ``(B, T, F)``,
runs NCHW ``(B, C, F, T)`` inside.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BN2d, BatchNorm1d, avg_pool_exclusive
from .pooling import POOLING_DIM_FACTOR, POOLINGS
from .resnet_se import halved

__all__ = ["Res2Net"]


class Bottle2neck(nn.Module):
    def __init__(self, in_planes, planes, stride=1, base_width=26, scale=4,
                 stype="normal", downsample=False, expansion=4):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        self.scale, self.stride, self.stype = scale, stride, stype
        self.nums = 1 if scale == 1 else scale - 1
        self.Conv_0 = nn.Conv2d(in_planes, width * scale, 1)
        self._BN2d_0 = BN2d(width * scale)
        for i in range(self.nums):
            setattr(self, f"Conv_{i + 1}", nn.Conv2d(
                width, width, 3, stride=stride, padding=1))
            setattr(self, f"_BN2d_{i + 1}", BN2d(width))
        n = self.nums + 1
        self._last = (f"Conv_{n}", f"_BN2d_{n}")
        setattr(self, self._last[0],
                nn.Conv2d(width * scale, planes * expansion, 1))
        setattr(self, self._last[1], BN2d(planes * expansion))
        self.downsample = downsample
        if downsample:
            self._ds = (f"Conv_{n + 1}", f"_BN2d_{n + 1}")
            setattr(self, self._ds[0], nn.Conv2d(
                in_planes, planes * expansion, 1, stride=stride))
            setattr(self, self._ds[1], BN2d(planes * expansion))

    def forward(self, x):
        out = torch.relu(self._BN2d_0(self.Conv_0(x)))
        spx = torch.chunk(out, self.scale, dim=1)
        ys, sp = [], None
        for i in range(self.nums):
            sp = spx[i] if (i == 0 or self.stype == "stage") else sp + spx[i]
            sp = getattr(self, f"Conv_{i + 1}")(sp)
            sp = torch.relu(getattr(self, f"_BN2d_{i + 1}")(sp))
            ys.append(sp)
        if self.scale != 1 and self.stype == "normal":
            ys.append(spx[self.nums])
        elif self.scale != 1 and self.stype == "stage":
            ys.append(avg_pool_exclusive(spx[self.nums], 3, self.stride, 1))
        conv, bn = (getattr(self, n) for n in self._last)
        out = bn(conv(torch.cat(ys, dim=1)))
        residual = x
        if self.downsample:
            conv, bn = (getattr(self, n) for n in self._ds)
            residual = bn(conv(x))
        return torch.relu(out + residual)


class Res2Net(nn.Module):
    def __init__(self, input_size, m_channels=32, layers=(3, 4, 6, 3),
                 base_width=32, scale=2, embd_dim=192, pooling_type="ASP"):
        super().__init__()
        if pooling_type not in POOLINGS:
            raise ValueError(f"no pooling layer {pooling_type}")
        expansion = 4
        self.Conv_0 = nn.Conv2d(1, m_channels, 7, stride=3, padding=1)
        self._BN2d_0 = BN2d(m_channels)
        f = halved((input_size + 2 - 7) // 3 + 1)            # stem, max pool
        in_planes, n = m_channels, 0
        for stage, (mul, stride) in enumerate(zip((1, 2, 4, 8),
                                                  (1, 2, 2, 2))):
            planes = m_channels * mul
            need_ds = stride != 1 or in_planes != planes * expansion
            for i in range(layers[stage]):
                first = i == 0
                setattr(self, f"Bottle2neck_{n}", Bottle2neck(
                    in_planes, planes, stride if first else 1, base_width,
                    scale, stype="stage" if first else "normal",
                    downsample=need_ds and first))
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
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self.n_blocks):
            x = getattr(self, f"Bottle2neck_{i}")(x)
        b, c, f, t = x.shape
        x = x.permute(0, 3, 2, 1).reshape(b, t, f * c)
        x = self.BatchNorm1d_0(getattr(self, self._pool)(x, lengths))
        return self.BatchNorm1d_1(self.Dense_0(x))
