"""CAM++ backbone as eager PyTorch modules (counterpart of the JAX
``models/campplus.py``; reference ``ppvector/models/campplus.py:284-335``).

This is the plain model: the test oracle for the whole network, in fp32
or bf16. The serving path (``trunk_kernel.campplus_embed_fast``) reuses
its head and replaces the FCM and the trunk with CUDA kernels.

Layouts at the public functions follow the JAX package:

- ``FCM`` takes ``(B, T, F)`` and returns ``(B, T, F' * C)`` flattened
  frequency-major (index ``f * C + c``), as ``campplus.py:238-240``. That
  is not paddle's channel-major ``c * F' + f``.
- ``CAMPPlus`` takes ``(B, T, F)`` features and optional ``lengths``
  (valid fractions) and returns ``(B, embd_dim)``.

Inside, the trunk runs torch's ``(B, C, T)``. Attribute names follow the
flax tree (``FCM_0``, ``TDNNLayer_0``, ``CAMDenseTDNNBlock_0``, ...).
As in the JAX module, only the final statistics pooling is length-aware;
the CAM context of this plain model spans the whole padded input.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, DenseBN, NonLinear
from .pooling import masked_mean_var

__all__ = ["SDConv", "TDNNLayer", "CAMLayer", "CAMDenseTDNNLayer",
           "CAMDenseTDNNBlock", "BasicResBlock", "FCM", "CAMPPlus"]

SEG_LEN = 100  # reference campplus.py:96 segment pooling window


class SDConv(nn.Conv2d):
    """3x3 conv with frequency-only stride, padding 1, on ``(B, C, F, T)``."""

    def __init__(self, in_channels, features, stride=1):
        super().__init__(in_channels, features, 3, stride=(stride, 1),
                         padding=1)


class TDNNLayer(nn.Module):
    """conv1d then BN-ReLU (reference ``campplus.py:38-64``) on ``(B, C, T)``."""

    def __init__(self, in_channels, features, kernel_size, stride=1,
                 dilation=1, config_str="batchnorm-relu"):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.Conv_0 = nn.Conv1d(in_channels, features, kernel_size,
                                stride=stride, padding=pad,
                                dilation=dilation)
        self._NonLinear_0 = NonLinear(features, config_str)

    def forward(self, x):
        return self._NonLinear_0(self.Conv_0(x))


def seg_pooling(x, seg_len=SEG_LEN):
    """ceil-mode average pool over time, repeated back to T
    (reference ``campplus.py:96-106``), on ``(B, C, T)``."""
    t = x.shape[-1]
    n = -(-t // seg_len)
    sums = F.pad(x, (0, n * seg_len - t)).reshape(
        *x.shape[:-1], n, seg_len).sum(-1)
    counts = torch.full((n,), float(seg_len), dtype=x.dtype, device=x.device)
    counts[-1] = t - (n - 1) * seg_len
    return (sums / counts).repeat_interleave(seg_len, dim=-1)[..., :t]


class CAMLayer(nn.Module):
    """Local conv gated by a sigmoid MLP of global mean + segment means
    (reference ``campplus.py:67-106``)."""

    def __init__(self, bn_channels, out_channels, kernel_size, dilation,
                 reduction=2):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.Conv_0 = nn.Conv1d(bn_channels, out_channels, kernel_size,
                                padding=pad, dilation=dilation)
        self.Conv_1 = nn.Conv1d(bn_channels, bn_channels // reduction, 1)
        self.Conv_2 = nn.Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x):
        y = self.Conv_0(x)
        context = x.mean(-1, keepdim=True) + seg_pooling(x)
        context = torch.relu(self.Conv_1(context))
        return y * torch.sigmoid(self.Conv_2(context))


class CAMDenseTDNNLayer(nn.Module):
    """BN-ReLU, 1x1 bottleneck, BN-ReLU, CAM conv
    (reference ``campplus.py:109-142``)."""

    def __init__(self, in_channels, out_channels, bn_channels, kernel_size,
                 dilation=1, config_str="batchnorm-relu"):
        super().__init__()
        self._NonLinear_0 = NonLinear(in_channels, config_str)
        self.Conv_0 = nn.Conv1d(in_channels, bn_channels, 1)
        self._NonLinear_1 = NonLinear(bn_channels, config_str)
        self.CAMLayer_0 = CAMLayer(bn_channels, out_channels, kernel_size,
                                   dilation)

    def forward(self, x):
        h = self._NonLinear_1(self.Conv_0(self._NonLinear_0(x)))
        return self.CAMLayer_0(h)


class CAMDenseTDNNBlock(nn.Module):
    """Densely connected CAM layers (reference ``campplus.py:145-173``)."""

    def __init__(self, num_layers, in_channels, out_channels, bn_channels,
                 kernel_size, dilation=1, config_str="batchnorm-relu"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"CAMDenseTDNNLayer_{i}", CAMDenseTDNNLayer(
                in_channels + i * out_channels, out_channels, bn_channels,
                kernel_size, dilation, config_str))

    def forward(self, x):
        for i in range(self.num_layers):
            y = getattr(self, f"CAMDenseTDNNLayer_{i}")(x)
            x = torch.cat([x, y], dim=1)
        return x


class BasicResBlock(nn.Module):
    """2-D residual block with frequency-only stride
    (reference ``campplus.py:211-243``) on ``(B, C, F, T)``."""

    def __init__(self, in_planes, planes, stride=1):
        super().__init__()
        self.Conv_0 = SDConv(in_planes, planes, stride)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = SDConv(planes, planes)
        self.BatchNorm_1 = BatchNorm(planes)
        self.has_shortcut = stride != 1 or in_planes != planes
        if self.has_shortcut:
            self.Conv_2 = nn.Conv2d(in_planes, planes, 1, stride=(stride, 1))
            self.BatchNorm_2 = BatchNorm(planes)

    def forward(self, x):
        out = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = self.BatchNorm_1(self.Conv_1(out))
        shortcut = (self.BatchNorm_2(self.Conv_2(x)) if self.has_shortcut
                    else x)
        return torch.relu(out + shortcut)


class FCM(nn.Module):
    """2-D conv front end: frequency / 8, ``m_channels`` channels
    (reference ``campplus.py:246-281``). ``(B, T, F) -> (B, T, F' * C)``
    flattened frequency-major."""

    def __init__(self, m_channels=32):
        super().__init__()
        m = m_channels
        self.Conv_0 = nn.Conv2d(1, m, 3, padding=1)
        self.BatchNorm_0 = BatchNorm(m)
        for i, stride in enumerate((2, 1, 2, 1)):
            setattr(self, f"BasicResBlock_{i}", BasicResBlock(m, m, stride))
        self.Conv_1 = SDConv(m, m, stride=2)
        self.BatchNorm_1 = BatchNorm(m)

    def forward(self, x):
        x = x.transpose(1, 2)[:, None]                       # (B, 1, F, T)
        out = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        for i in range(4):
            out = getattr(self, f"BasicResBlock_{i}")(out)
        out = torch.relu(self.BatchNorm_1(self.Conv_1(out)))
        b, c, f, t = out.shape
        return out.permute(0, 3, 2, 1).reshape(b, t, f * c)


class CAMPPlus(nn.Module):
    """CAM++: FCM, a stride-2 TDNN stem, three CAM dense blocks (12/24/16
    layers) with transits, mean || unbiased std pooling, DenseBN head."""

    def __init__(self, input_size, embd_dim=512, growth_rate=32, bn_size=4,
                 init_channels=128, config_str="batchnorm-relu",
                 memory_efficient=True):
        super().__init__()
        self.input_size = input_size
        self.config_str = config_str
        self.embd_dim = embd_dim
        self.growth_rate = growth_rate
        self.bn_size = bn_size
        self.init_channels = init_channels
        self.FCM_0 = FCM()
        fcm_dim = 32 * (-(-input_size // 8))
        self.TDNNLayer_0 = TDNNLayer(fcm_dim, init_channels, 5, stride=2,
                                     config_str=config_str)
        channels = init_channels
        for b, (n, dil) in enumerate(zip((12, 24, 16), (1, 2, 2))):
            setattr(self, f"CAMDenseTDNNBlock_{b}", CAMDenseTDNNBlock(
                n, channels, growth_rate, bn_size * growth_rate, 3, dil,
                config_str))
            channels += n * growth_rate
            setattr(self, f"_NonLinear_{b}", NonLinear(channels, config_str))
            setattr(self, f"Conv_{b}", nn.Conv1d(channels, channels // 2, 1))
            channels //= 2
        self._NonLinear_3 = NonLinear(channels, config_str)
        self.DenseBN_0 = DenseBN(2 * channels, embd_dim, "batchnorm_")

    def trunk(self, fcm_out):
        """FCM output ``(B, T_raw, F'*C)`` -> final trunk activations
        ``(B, T, C_final)``."""
        x = self.TDNNLayer_0(fcm_out.transpose(1, 2))
        for b in range(3):
            x = getattr(self, f"CAMDenseTDNNBlock_{b}")(x)
            x = getattr(self, f"Conv_{b}")(getattr(self, f"_NonLinear_{b}")(x))
        return self._NonLinear_3(x).transpose(1, 2)

    def forward(self, x, lengths=None):
        x = self.trunk(self.FCM_0(x))
        mean, var = masked_mean_var(x, lengths, ddof=1)
        stats = torch.cat([mean, torch.sqrt(torch.clamp(var, min=0.0))], -1)
        return self.DenseBN_0(stats)
