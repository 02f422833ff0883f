"""ECAPA-TDNN (Desplanques et al., arXiv:2005.07143; SpeechBrain's
``ECAPA_TDNN``, ppvector ``models/ecapa_tdnn.py``) as plain PyTorch in
float32, with state-dict keys that are the port's.

On ``(B, C, T)`` features, with ``m`` the mask of valid frames (frame
``t`` of an utterance of length ratio ``r`` is valid when ``t < r * T``)
and ``TDNN(x) = BN(ReLU(conv(x)))``:

- ``h0 = TDNN_k5(x)``;
- three SE-Res2Net blocks, dilations 2, 3, 4: ``u = TDNN_1x1(h)``, split
  into ``scale`` chunks ``u_1..u_s``; ``y_1 = u_1``, ``y_2 = K_2(u_2)``,
  ``y_i = K_i(u_i + y_{i-1})`` (``K_i`` a dilated k3 TDNN); ``v =
  TDNN_1x1(cat y)``; the squeeze ``z`` is the mean of ``v`` over the
  valid frames, the excitation ``sigmoid(W2 ReLU(W1 z))`` scales ``v``
  per channel; the block returns that plus ``h`` (a 1x1 conv of ``h``
  where the widths differ);
- multi-layer feature aggregation: ``TDNN_1x1`` of the three blocks'
  outputs concatenated over channels;
- attentive statistics pooling with global context: the mean and standard
  deviation of ``H`` over the valid frames, tiled over time and
  concatenated with ``H``; ``e = W tanh(TDNN_1x1([H; mean; std]))`` per
  channel and frame; ``a = softmax(e)`` over the valid frames (padded
  frames weigh nothing); the ``a``-weighted mean and standard deviation
  of ``H``;
- BN of the pooled ``2C`` vector and a 1x1 projection to the embedding.

Departures from the paper, both as ppvector (and SpeechBrain) compute:
every temporal conv pads to 'same' length in reflect mode, where the
paper does not say; and each standard deviation of the pooling is
``sqrt(max(var, 1e-12))``. The reference computes both directly; it
shares no code with the port.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .precision import BatchNorm, Conv1d

STD_EPS = 1e-12
# the published channel widths (C = 1024), which ``forward_flops`` counts
CHANNELS = (1024, 1024, 1024, 1024, 3072)


class SamePadConv(nn.Module):
    def __init__(self, cin, cout, k, dilation=1):
        super().__init__()
        self.pad = dilation * (k - 1) // 2
        self.Conv_0 = Conv1d(cin, cout, k, dilation=dilation)

    def forward(self, x):
        if self.pad:
            x = F.pad(x, (self.pad, self.pad), mode="reflect")
        return self.Conv_0(x)


class BN(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x):
        return self.BatchNorm_0(x)


class TDNN(nn.Module):
    def __init__(self, cin, cout, k, dilation=1):
        super().__init__()
        self.SamePadConv1d_0 = SamePadConv(cin, cout, k, dilation)
        self.BatchNorm1d_0 = BN(cout)

    def forward(self, x):
        return self.BatchNorm1d_0(torch.relu(self.SamePadConv1d_0(x)))


class Res2Net(nn.Module):
    def __init__(self, channels, scale, dilation):
        super().__init__()
        self.width = channels // scale
        self.convs = [f"TDNNBlock_{i}" for i in range(scale - 1)]
        for name in self.convs:
            setattr(self, name, TDNN(self.width, self.width, 3, dilation))

    def forward(self, x):
        chunks = x.split(self.width, dim=1)
        out, y = [chunks[0]], None
        for name, u in zip(self.convs, chunks[1:]):
            y = getattr(self, name)(u if y is None else u + y)
            out.append(y)
        return torch.cat(out, dim=1)


class SE(nn.Module):
    def __init__(self, channels, bottleneck):
        super().__init__()
        self.SamePadConv1d_0 = SamePadConv(channels, bottleneck, 1)
        self.SamePadConv1d_1 = SamePadConv(bottleneck, channels, 1)

    def forward(self, v, m):
        z = (v * m).sum(-1, keepdim=True) / m.sum(-1, keepdim=True)
        s = torch.relu(self.SamePadConv1d_0(z))
        return v * torch.sigmoid(self.SamePadConv1d_1(s))


class SERes2Net(nn.Module):
    def __init__(self, cin, cout, scale, se_channels, dilation):
        super().__init__()
        if cin != cout:
            self.SamePadConv1d_0 = SamePadConv(cin, cout, 1)
        self.shortcut = cin != cout
        self.TDNNBlock_0 = TDNN(cin, cout, 1)
        self.Res2NetBlock_0 = Res2Net(cout, scale, dilation)
        self.TDNNBlock_1 = TDNN(cout, cout, 1)
        self.SEBlock_0 = SE(cout, se_channels)

    def forward(self, h, m):
        v = self.TDNNBlock_1(self.Res2NetBlock_0(self.TDNNBlock_0(h)))
        res = self.SamePadConv1d_0(h) if self.shortcut else h
        return self.SEBlock_0(v, m) + res


def weighted_stats(h, w):
    """Mean and ``sqrt(max(var, eps))`` of ``h`` (B, C, T) over time under
    weights ``w`` (B, 1 or C, T) that sum to one."""
    mean = (h * w).sum(-1, keepdim=True)
    var = (w * (h - mean) ** 2).sum(-1, keepdim=True)
    return mean, var.clamp(min=STD_EPS).sqrt()


class ASP(nn.Module):
    def __init__(self, channels, attention, global_context):
        super().__init__()
        self.global_context = global_context
        self.TDNNBlock_0 = TDNN(3 * channels if global_context else channels,
                                attention, 1)
        self.SamePadConv1d_0 = SamePadConv(attention, channels, 1)

    def forward(self, h, m):
        t = h.shape[-1]
        a_in = h
        if self.global_context:
            mean, std = weighted_stats(h, m / m.sum(-1, keepdim=True))
            a_in = torch.cat([h, mean.expand(-1, -1, t), std.expand(-1, -1, t)], 1)
        e = self.SamePadConv1d_0(torch.tanh(self.TDNNBlock_0(a_in)))
        a = torch.softmax(e.masked_fill(m == 0, float("-inf")), dim=-1)
        mean, std = weighted_stats(h, a)
        return torch.cat([mean, std], dim=1)[..., 0]


class EcapaTdnn(nn.Module):
    def __init__(self, input_size=80, embd_dim=192, pooling_type="ASP",
                 channels=(512, 512, 512, 512, 1536),
                 kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
                 attention_channels=128, res2net_scale=8, se_channels=128,
                 global_context=True):
        super().__init__()
        if pooling_type != "ASP":
            raise ValueError("the reference holds ECAPA-TDNN's attentive "
                             f"statistics pooling only, not {pooling_type}")
        c, k, d = list(channels), list(kernel_sizes), list(dilations)
        self.TDNNBlock_0 = TDNN(input_size, c[0], k[0], d[0])
        self.blocks = []
        for i in range(1, len(c) - 1):
            self.blocks.append(f"SERes2NetBlock_{i - 1}")
            setattr(self, self.blocks[-1], SERes2Net(
                c[i - 1], c[i], res2net_scale, se_channels, d[i]))
        self.TDNNBlock_1 = TDNN(sum(c[1:-1]), c[-1], k[-1], d[-1])
        self.AttentiveStatisticsPooling_0 = ASP(c[-1], attention_channels,
                                                global_context)
        self.BatchNorm1d_0 = BN(2 * c[-1])
        self.SamePadConv1d_0 = SamePadConv(2 * c[-1], embd_dim, 1)

    def forward(self, feats, lengths=None):
        """``(B, T, n_mels)`` features and the valid fractions ``(B,)``
        (every frame when None) -> ``(B, embd_dim)``."""
        x = feats.transpose(1, 2)
        b, _, t = x.shape
        if lengths is None:
            m = x.new_ones((b, 1, t))
        else:
            r = lengths.to(torch.float32).to(x.device)
            m = (torch.arange(t, device=x.device)[None, :] < r[:, None] * t)
            m = m.to(x.dtype)[:, None, :]
        h = self.TDNNBlock_0(x)
        outs = []
        for name in self.blocks:
            h = getattr(self, name)(h, m)
            outs.append(h)
        h = self.TDNNBlock_1(torch.cat(outs, dim=1))
        pooled = self.BatchNorm1d_0(self.AttentiveStatisticsPooling_0(h, m))
        return self.SamePadConv1d_0(pooled[..., None])[..., 0]


Model = EcapaTdnn


def forward_flops(frames, rows):
    """The whole forward of one clip of ``frames`` valid frames at the
    published widths (``C = 1024``, ``Model(80, channels=CHANNELS)``): two
    FLOPs a multiply-add of every conv, per frame, and the SE excitations
    and the head once a clip. The plain backbone has no trunk rows, so
    ``rows`` is ignored."""
    c, scale, se, att, embd = CHANNELS, 8, 128, 128, 192
    w = c[1] // scale
    per_frame = (80 * c[0] * 5                                   # front, k5
                 + 3 * (2 * c[1] * c[1] + (scale - 1) * w * w * 3)  # blocks
                 + sum(c[1:4]) * c[4]                            # aggregation
                 + 3 * c[4] * att + att * c[4])                  # attention
    per_clip = 3 * 2 * c[1] * se + 2 * c[4] * embd               # SE, head
    return 2 * (per_frame * int(frames) + per_clip)
