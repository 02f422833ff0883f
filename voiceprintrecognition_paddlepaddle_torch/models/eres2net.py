"""ERes2Net and ERes2NetV2 backbones, 2-D (counterpart of the JAX
``models/eres2net.py``).

Four block stages; the 'fuse' stages (3 and 4) replace the blocks' split
additions with attentional feature fusion (AFF). V1 also fuses every stage
bottom-up through stride-2 3x3 convs and AFF; V2 fuses only layer3 into
layer4. The blocks' activation is Hardtanh(0, 20). TSTP pooling on the
4-D output, a Linear embedding, and optionally a second
ReLU -> BN -> Linear layer. Takes ``(B, T, F)``, runs NCHW
``(B, C, F, T)`` inside.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BN2d, BatchNorm, hardtanh_relu20
from .pooling import TemporalStatsPool
from .resnet_se import halved

__all__ = ["AFF", "ERes2Net", "ERes2NetV2"]


class AFF(nn.Module):
    """Attentional feature fusion: ``x * a + ds_y * (2 - a)`` with
    ``a = 1 + tanh(.)`` of a 1x1 conv bottleneck over ``x || ds_y``."""

    def __init__(self, channels, r=4):
        super().__init__()
        inter = channels // r
        self.Conv_0 = nn.Conv2d(2 * channels, inter, 1)
        self._BN2d_0 = BN2d(inter)
        self.Conv_1 = nn.Conv2d(inter, channels, 1)
        self._BN2d_1 = BN2d(channels)

    def forward(self, x, ds_y):
        a = F.silu(self._BN2d_0(self.Conv_0(torch.cat([x, ds_y], dim=1))))
        a = 1.0 + torch.tanh(self._BN2d_1(self.Conv_1(a)))
        return x * a + ds_y * (2.0 - a)


class _BasicBlock(nn.Module):
    """All four reference block variants: ``use_aff`` switches the split
    summation to AFF; the 1x1 ``Conv_0`` carries the stride."""

    def __init__(self, in_planes, planes, stride=1, base_width=32, scale=2,
                 expansion=2, use_aff=False):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        out = planes * expansion
        self.scale, self.use_aff = scale, use_aff
        self.Conv_0 = nn.Conv2d(in_planes, width * scale, 1, stride=stride)
        self._BN2d_0 = BN2d(width * scale)
        for i in range(scale):
            if i > 0 and use_aff:
                setattr(self, f"AFF_{i - 1}", AFF(width))
            setattr(self, f"Conv_{i + 1}", nn.Conv2d(width, width, 3,
                                                     padding=1))
            setattr(self, f"_BN2d_{i + 1}", BN2d(width))
        n = scale + 1
        self._last = (f"Conv_{n}", f"_BN2d_{n}")
        setattr(self, self._last[0], nn.Conv2d(width * scale, out, 1))
        setattr(self, self._last[1], BN2d(out))
        self.shortcut = stride != 1 or in_planes != out
        if self.shortcut:
            self._ds = (f"Conv_{n + 1}", f"_BN2d_{n + 1}")
            setattr(self, self._ds[0], nn.Conv2d(in_planes, out, 1,
                                                 stride=stride))
            setattr(self, self._ds[1], BN2d(out))

    def forward(self, x):
        out = hardtanh_relu20(self._BN2d_0(self.Conv_0(x)))
        spx = torch.chunk(out, self.scale, dim=1)
        ys, sp = [], None
        for i in range(self.scale):
            if i == 0:
                sp = spx[i]
            elif self.use_aff:
                sp = getattr(self, f"AFF_{i - 1}")(sp, spx[i])
            else:
                sp = sp + spx[i]
            sp = getattr(self, f"Conv_{i + 1}")(sp)
            sp = hardtanh_relu20(getattr(self, f"_BN2d_{i + 1}")(sp))
            ys.append(sp)
        conv, bn = (getattr(self, n) for n in self._last)
        out = bn(conv(torch.cat(ys, dim=1)))
        residual = x
        if self.shortcut:
            conv, bn = (getattr(self, n) for n in self._ds)
            residual = bn(conv(x))
        return hardtanh_relu20(out + residual)


class _ERes2NetBase(nn.Module):
    """The stem, the four stages and the embedding head that both
    versions share; each version's ``forward`` adds its fusion."""

    def _build(self, input_size, num_blocks, m_channels, expansion,
               base_width, scale, embd_dim, pooling_type, two_emb_layer,
               fused_channels):
        if pooling_type != "TSTP":
            raise ValueError(f"no pooling layer {pooling_type}")
        m = m_channels
        self.Conv_0 = nn.Conv2d(1, m, 3, padding=1)
        self._BN2d_0 = BN2d(m)
        self.stages, in_planes, n = [], m, 0
        for stage, (mul, stride) in enumerate(zip((1, 2, 4, 8),
                                                  (1, 2, 2, 2))):
            names = []
            for i in range(num_blocks[stage]):
                names.append(f"_BasicBlock_{n}")
                setattr(self, names[-1], _BasicBlock(
                    in_planes, m * mul, stride if i == 0 else 1, base_width,
                    scale, expansion, use_aff=stage >= 2))
                in_planes, n = m * mul * expansion, n + 1
            self.stages.append(names)
        f = halved(halved(halved(input_size)))
        self.TemporalStatsPool_0 = TemporalStatsPool()
        self.Dense_0 = nn.Linear(2 * f * fused_channels, embd_dim)
        self.two_emb_layer = two_emb_layer
        if two_emb_layer:
            self.BatchNorm_0 = BatchNorm(embd_dim)
            self.Dense_1 = nn.Linear(embd_dim, embd_dim)

    def _stage(self, i, x):
        for name in self.stages[i]:
            x = getattr(self, name)(x)
        return x

    def _head(self, fused, lengths):
        embed = self.Dense_0(self.TemporalStatsPool_0(fused, lengths))
        if self.two_emb_layer:
            return self.Dense_1(self.BatchNorm_0(torch.relu(embed)))
        return embed

    def _stem(self, x):
        x = x.transpose(1, 2)[:, None]                       # (B, 1, F, T)
        return torch.relu(self._BN2d_0(self.Conv_0(x)))


class ERes2Net(_ERes2NetBase):
    """V1: every stage fused bottom-up through stride-2 3x3 convs
    (``m * 4 * mul_channel`` channels and up) and AFF."""

    def __init__(self, input_size, num_blocks=(3, 4, 6, 3), m_channels=32,
                 mul_channel=1, expansion=2, base_width=32, scale=2,
                 embd_dim=192, pooling_type="TSTP", two_emb_layer=False):
        super().__init__()
        m, mc = m_channels, mul_channel
        self._build(input_size, num_blocks, m, expansion, base_width, scale,
                    embd_dim, pooling_type, two_emb_layer, m * 16 * mc)
        self.Conv_1 = nn.Conv2d(m * expansion, m * 4 * mc, 3, stride=2,
                                padding=1)
        self.AFF_0 = AFF(m * 4 * mc)
        self.Conv_2 = nn.Conv2d(m * 4 * mc, m * 8 * mc, 3, stride=2,
                                padding=1)
        self.AFF_1 = AFF(m * 8 * mc)
        self.Conv_3 = nn.Conv2d(m * 8 * mc, m * 16 * mc, 3, stride=2,
                                padding=1)
        self.AFF_2 = AFF(m * 16 * mc)

    def forward(self, x, lengths=None):
        out1 = self._stage(0, self._stem(x))
        out2 = self._stage(1, out1)
        fuse12 = self.AFF_0(out2, self.Conv_1(out1))
        out3 = self._stage(2, out2)
        fuse123 = self.AFF_1(out3, self.Conv_2(fuse12))
        out4 = self._stage(3, out3)
        fuse1234 = self.AFF_2(out4, self.Conv_3(fuse123))
        return self._head(fuse1234, lengths)


class ERes2NetV2(_ERes2NetBase):
    """V2: only layer3 is fused into layer4."""

    def __init__(self, input_size, num_blocks=(3, 4, 6, 3), m_channels=32,
                 expansion=2, base_width=26, scale=2, embd_dim=192,
                 pooling_type="TSTP", two_emb_layer=False):
        super().__init__()
        m = m_channels
        self._build(input_size, num_blocks, m, expansion, base_width, scale,
                    embd_dim, pooling_type, two_emb_layer, m * 16)
        self.Conv_1 = nn.Conv2d(m * 4 * expansion, m * 16, 3, stride=2,
                                padding=1)
        self.AFF_0 = AFF(m * 16)

    def forward(self, x, lengths=None):
        out3 = self._stage(2, self._stage(1, self._stage(0, self._stem(x))))
        out4 = self._stage(3, out3)
        return self._head(self.AFF_0(out4, self.Conv_1(out3)), lengths)
