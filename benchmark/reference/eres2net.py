"""ERes2Net (3D-Speaker, arXiv:2305.12838; ppvector ``models/eres2net.py``)
as plain PyTorch modules whose state-dict keys are the port's: four
stages of split residual blocks (Hardtanh(0, 20)), attentional feature
fusion (AFF) in the blocks of stages 3 and 4 and between the stages
bottom-up, TSTP pooling over the valid frames, one linear embedding."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .precision import BatchNorm, Conv2d, Linear


def relu20(x):
    return torch.clamp(x, 0.0, 20.0)


class BN2d(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x):
        return self.BatchNorm_0(x)


class AFF(nn.Module):
    def __init__(self, channels, r=4):
        super().__init__()
        self.Conv_0 = Conv2d(2 * channels, channels // r, 1)
        self._BN2d_0 = BN2d(channels // r)
        self.Conv_1 = Conv2d(channels // r, channels, 1)
        self._BN2d_1 = BN2d(channels)

    def forward(self, x, ds_y):
        a = F.silu(self._BN2d_0(self.Conv_0(torch.cat([x, ds_y], dim=1))))
        a = 1.0 + torch.tanh(self._BN2d_1(self.Conv_1(a)))
        return x * a + ds_y * (2.0 - a)


class BasicBlock(nn.Module):
    def __init__(self, in_planes, planes, stride, base_width=32, scale=2,
                 expansion=2, use_aff=False):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        out = planes * expansion
        self.scale, self.use_aff = scale, use_aff
        self.Conv_0 = Conv2d(in_planes, width * scale, 1, stride=stride)
        self._BN2d_0 = BN2d(width * scale)
        for i in range(scale):
            if i > 0 and use_aff:
                setattr(self, f"AFF_{i - 1}", AFF(width))
            setattr(self, f"Conv_{i + 1}", Conv2d(width, width, 3, padding=1))
            setattr(self, f"_BN2d_{i + 1}", BN2d(width))
        n = scale + 1
        self.last = (f"Conv_{n}", f"_BN2d_{n}")
        setattr(self, self.last[0], Conv2d(width * scale, out, 1))
        setattr(self, self.last[1], BN2d(out))
        self.ds = None
        if stride != 1 or in_planes != out:
            self.ds = (f"Conv_{n + 1}", f"_BN2d_{n + 1}")
            setattr(self, self.ds[0], Conv2d(in_planes, out, 1, stride=stride))
            setattr(self, self.ds[1], BN2d(out))

    def forward(self, x):
        spx = torch.chunk(relu20(self._BN2d_0(self.Conv_0(x))), self.scale, 1)
        ys, sp = [], None
        for i in range(self.scale):
            if i == 0:
                sp = spx[0]
            elif self.use_aff:
                sp = getattr(self, f"AFF_{i - 1}")(sp, spx[i])
            else:
                sp = sp + spx[i]
            sp = relu20(getattr(self, f"_BN2d_{i + 1}")(
                getattr(self, f"Conv_{i + 1}")(sp)))
            ys.append(sp)
        conv, bn = (getattr(self, n) for n in self.last)
        out = bn(conv(torch.cat(ys, dim=1)))
        res = x
        if self.ds:
            conv, bn = (getattr(self, n) for n in self.ds)
            res = bn(conv(x))
        return relu20(out + res)


class ERes2Net(nn.Module):
    def __init__(self, input_size=80, num_blocks=(3, 4, 6, 3), m_channels=32,
                 expansion=2, base_width=32, scale=2, embd_dim=192):
        super().__init__()
        m = m_channels
        self.Conv_0 = Conv2d(1, m, 3, padding=1)
        self._BN2d_0 = BN2d(m)
        self.stages, in_planes, n = [], m, 0
        for stage, (mul, stride) in enumerate(zip((1, 2, 4, 8), (1, 2, 2, 2))):
            names = []
            for i in range(num_blocks[stage]):
                names.append(f"_BasicBlock_{n}")
                setattr(self, names[-1], BasicBlock(
                    in_planes, m * mul, stride if i == 0 else 1, base_width,
                    scale, expansion, use_aff=stage >= 2))
                in_planes, n = m * mul * expansion, n + 1
            self.stages.append(names)
        f = input_size
        for _ in range(3):
            f = (f + 1) // 2
        self.Dense_0 = Linear(2 * f * m * 16, embd_dim)
        self.Conv_1 = Conv2d(m * expansion, m * 4, 3, stride=2, padding=1)
        self.AFF_0 = AFF(m * 4)
        self.Conv_2 = Conv2d(m * 4, m * 8, 3, stride=2, padding=1)
        self.AFF_1 = AFF(m * 8)
        self.Conv_3 = Conv2d(m * 8, m * 16, 3, stride=2, padding=1)
        self.AFF_2 = AFF(m * 16)

    def _stage(self, i, x):
        for name in self.stages[i]:
            x = getattr(self, name)(x)
        return x

    def forward(self, feats, lengths=None):
        """``(B, T, 80)`` features and valid fractions -> ``(B, embd_dim)``."""
        x = torch.relu(self._BN2d_0(self.Conv_0(feats.transpose(1, 2)[:, None])))
        out1 = self._stage(0, x)
        out2 = self._stage(1, out1)
        fuse12 = self.AFF_0(out2, self.Conv_1(out1))
        out3 = self._stage(2, out2)
        fuse123 = self.AFF_1(out3, self.Conv_2(fuse12))
        out4 = self._stage(3, out3)
        fused = self.AFF_2(out4, self.Conv_3(fuse123))
        b, c, f, t = fused.shape
        x = fused.permute(0, 3, 2, 1).reshape(b, t, f * c)
        if lengths is None:
            mean, var = x.mean(1), x.var(1, correction=1)
        else:
            m = (torch.arange(t, device=x.device)[None, :]
                 < lengths.float()[:, None] * t).to(x.dtype)[..., None]
            n = m.sum(1).clamp(min=1)
            mean = (x * m).sum(1) / n
            var = (((x - mean[:, None]) ** 2) * m).sum(1) / (n - 1).clamp(min=1)
        return self.Dense_0(torch.cat([mean, torch.sqrt(var + 1e-8)], -1))


Model = ERes2Net


def forward_flops(frames, rows):
    """The whole forward of one clip of ``frames`` valid frames
    (``work.eres2net_flops``; the plain backbone has no trunk rows)."""
    from ..work import eres2net_flops
    return eres2net_flops(frames)
