"""ECAPA-TDNN backbone (counterpart of the JAX ``models/ecapa_tdnn.py``).

An initial TDNN block, three SE-Res2Net blocks (dilations 2/3/4),
multi-layer feature aggregation over the SE blocks' outputs, an MFA TDNN
block, pooling (ASP / SAP / TAP / TSP) with BN and a 1x1 projection to the
embedding. Takes ``(B, T, F)``, runs ``(B, C, T)`` inside; the SE blocks
and the pooling are length-aware.

Spans (``utils.tracing``): ``vpr.ecapa`` around the forward, inside it
``vpr.ecapa.front`` (the first TDNN block), ``vpr.ecapa.block`` (the
block's index as ``id``) holding ``vpr.ecapa.res2net`` and
``vpr.ecapa.se``, then ``vpr.ecapa.mfa``, ``vpr.ecapa.pool`` and
``vpr.ecapa.head``. They time the host's dispatch: none waits for the
device.
"""

import torch
from torch import nn

from ..utils import tracing
from .layers import BatchNorm1d, SamePadConv1d, TDNNBlock, length_to_mask
from .pooling import POOLING_DIM_FACTOR, POOLINGS

__all__ = ["EcapaTdnn"]


class Res2NetBlock(nn.Module):
    """Hierarchical multi-scale temporal convs over ``scale`` contiguous
    channel chunks; the first chunk passes straight through."""

    def __init__(self, out_channels, scale=8, dilation=1):
        super().__init__()
        assert out_channels % scale == 0
        self.scale = scale
        hidden = out_channels // scale
        for i in range(scale - 1):
            setattr(self, f"TDNNBlock_{i}",
                    TDNNBlock(hidden, hidden, 3, dilation=dilation))

    def forward(self, x):
        y = []
        for i, x_i in enumerate(torch.chunk(x, self.scale, dim=1)):
            if i == 0:
                y_i = x_i
            elif i == 1:
                y_i = self.TDNNBlock_0(x_i)
            else:
                y_i = getattr(self, f"TDNNBlock_{i - 1}")(x_i + y_i)
            y.append(y_i)
        return torch.cat(y, dim=1)


class SEBlock(nn.Module):
    """Squeeze-excitation whose mean over time is masked with ``lengths``."""

    def __init__(self, in_channels, se_channels, out_channels):
        super().__init__()
        self.SamePadConv1d_0 = SamePadConv1d(in_channels, se_channels, 1)
        self.SamePadConv1d_1 = SamePadConv1d(se_channels, out_channels, 1)

    def forward(self, x, lengths=None):
        t = x.shape[-1]
        if lengths is not None:
            ratio = torch.as_tensor(lengths, dtype=torch.float32,
                                    device=x.device)
            mask = length_to_mask(ratio * t, t).to(x.dtype)[:, None, :]
            s = (x * mask).sum(dim=-1, keepdim=True) / \
                mask.sum(dim=-1, keepdim=True)
        else:
            s = x.mean(dim=-1, keepdim=True)
        s = torch.relu(self.SamePadConv1d_0(s))
        return torch.sigmoid(self.SamePadConv1d_1(s)) * x


class SERes2NetBlock(nn.Module):
    """TDNN -> Res2Net -> TDNN -> SE, with a residual (a 1x1 conv when the
    channel count changes)."""

    def __init__(self, in_channels, out_channels, res2net_scale=8,
                 se_channels=128, dilation=1):
        super().__init__()
        self.has_shortcut = in_channels != out_channels
        if self.has_shortcut:
            self.SamePadConv1d_0 = SamePadConv1d(in_channels, out_channels, 1)
        self.TDNNBlock_0 = TDNNBlock(in_channels, out_channels, 1)
        self.Res2NetBlock_0 = Res2NetBlock(out_channels, res2net_scale,
                                           dilation)
        self.TDNNBlock_1 = TDNNBlock(out_channels, out_channels, 1)
        self.SEBlock_0 = SEBlock(out_channels, se_channels, out_channels)

    def forward(self, x, lengths=None):
        residual = self.SamePadConv1d_0(x) if self.has_shortcut else x
        x = self.TDNNBlock_0(x)
        with tracing.span("vpr.ecapa.res2net"):
            x = self.Res2NetBlock_0(x)
        x = self.TDNNBlock_1(x)
        with tracing.span("vpr.ecapa.se"):
            x = self.SEBlock_0(x, lengths)
        return x + residual


class EcapaTdnn(nn.Module):
    def __init__(self, input_size, embd_dim=192, pooling_type="ASP",
                 channels=(512, 512, 512, 512, 1536),
                 kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
                 attention_channels=128, res2net_scale=8, se_channels=128,
                 global_context=True):
        super().__init__()
        ch, ks, dil = channels, kernel_sizes, dilations
        assert len(ch) == len(ks) == len(dil)
        self.n_blocks = len(ch) - 2
        self.TDNNBlock_0 = TDNNBlock(input_size, ch[0], ks[0], dil[0])
        for i in range(1, len(ch) - 1):
            setattr(self, f"SERes2NetBlock_{i - 1}", SERes2NetBlock(
                ch[i - 1], ch[i], res2net_scale, se_channels, dil[i]))
        self.TDNNBlock_1 = TDNNBlock(sum(ch[1:-1]), ch[-1], ks[-1], dil[-1])
        if pooling_type == "ASP":
            pool = POOLINGS["ASP"](ch[-1], attention_channels, global_context)
        elif pooling_type in ("SAP", "TAP", "TSP"):
            pool = POOLINGS[pooling_type](ch[-1])
        else:
            raise ValueError(f"no pooling layer {pooling_type}")
        self._pool = f"{type(pool).__name__}_0"
        setattr(self, self._pool, pool)
        out = ch[-1] * POOLING_DIM_FACTOR[pooling_type]
        self.BatchNorm1d_0 = BatchNorm1d(out)
        self.SamePadConv1d_0 = SamePadConv1d(out, embd_dim, 1)

    def forward(self, x, lengths=None):
        with tracing.span("vpr.ecapa"):
            with tracing.span("vpr.ecapa.front"):
                x = self.TDNNBlock_0(x.transpose(1, 2))
            xl = []
            for i in range(self.n_blocks):
                with tracing.span("vpr.ecapa.block", id=i):
                    x = getattr(self, f"SERes2NetBlock_{i}")(x, lengths)
                xl.append(x)
            with tracing.span("vpr.ecapa.mfa"):
                x = self.TDNNBlock_1(torch.cat(xl, dim=1))
            with tracing.span("vpr.ecapa.pool"):
                x = getattr(self, self._pool)(x.transpose(1, 2), lengths)
            with tracing.span("vpr.ecapa.head"):
                x = self.BatchNorm1d_0(x)
                return self.SamePadConv1d_0(x[:, :, None])[:, :, 0]
