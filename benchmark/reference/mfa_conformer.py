"""MFA-Conformer (Zhang et al., Interspeech 2022, arXiv:2203.15249; the
authors' code on WeNet's ``ConformerEncoder``) as plain PyTorch in
float32, with state-dict keys that are the port's.

On ``(B, T, F)`` features, with ``LN`` a LayerNorm (eps 1e-5),
``swish(z) = z sigmoid(z)`` and ``m`` the mask of valid positions after
subsampling (position ``t`` of an utterance of length ratio ``r`` is
valid when ``t < r * T'``):

- subsampling: ``s = ReLU(Conv2d_k3s2(x))`` (1 to ``d`` channels over
  time and mel), flattened channel-major per position, ``h = sqrt(d) W s
  + b``; ``T' = (T - 1) // 2``;
- positions: ``P[j] = pe[j]``, WeNet's sinusoid (``sin`` at even, ``cos``
  at odd channels of ``j / 10000^(2i/d)``);
- each of the blocks: ``h += 0.5 FFN(LN(h))``; ``h += MHSA(LN(h))``;
  ``h += Conv(LN(h))``; ``h += 0.5 FFN(LN(h))``; ``h = LN(h)``, with
  ``FFN(z) = W2 swish(W1 z)``;
- ``MHSA``: per head, ``q, k, v`` the projections, ``p = W_pos P`` (no
  bias), ``S = ((q + u) k^T + (q + v) p^T) / sqrt(d_k)`` (WeNet, no
  ``rel_shift``), keys at padded positions at ``-inf``, ``A =
  softmax(S) v``, heads concatenated and projected;
- ``Conv``: ``z`` zeroed at padded positions, ``GLU(PW1 z)`` (the first
  half times the sigmoid of the second), depthwise conv (k, 'same' zero
  padding), BN, swish, ``PW2``, zeroed again at padded positions;
- aggregation: ``LN`` of the blocks' outputs concatenated over channels;
- attentive statistics pooling with global context over the valid
  positions (``ecapa_tdnn.ASP`` of this folder: mean and standard
  deviation tiled, ``TDNN_1x1`` with ReLU and BN, tanh, ``1x1`` to the
  channels, softmax over time), BN of the pooled vector and a Linear.

Departures from WeNet and the authors' code: the validity mask after
subsampling is the ratio mask above where WeNet takes every second frame
of the input mask (the two differ by at most one position); each standard
deviation of the pooling is ``sqrt(max(var, 1e-12))``, as SpeechBrain's.
The scores are materialised; the reference shares no code with the
port.
"""

import math

import torch
from torch import nn

from .ecapa_tdnn import ASP, BN
from .precision import Conv1d, Conv2d, Linear, operand, output

LN_EPS = 1e-5
# the published widths, which ``forward_flops`` counts: d, blocks, heads,
# feed-forward, depthwise kernel, embedding, ASP attention, mel bins
D, BLOCKS, HEADS, UNITS, KERNEL, EMBD, ATT, MELS = 256, 6, 4, 2048, 15, 192, 128, 80


def swish(z):
    return z * torch.sigmoid(z)


def sinusoid(n, d, device):
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    freq = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                     * -(math.log(10000.0) / d))
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(pos * freq)
    pe[:, 1::2] = torch.cos(pos * freq)
    return pe


class LayerNorm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + LN_EPS) * self.weight + self.bias


def matmul(a, b):
    return output(torch.matmul(operand(a), operand(b)))


class Subsampling(nn.Module):
    def __init__(self, mels, d):
        super().__init__()
        self.Conv_0 = Conv2d(1, d, 3, 2)
        self.Dense_0 = Linear(d * ((mels - 1) // 2), d)

    def forward(self, x):
        s = torch.relu(self.Conv_0(x[:, None]))          # (B, d, T', F')
        b, c, t, f = s.shape
        return self.Dense_0(s.permute(0, 2, 1, 3).reshape(b, t, c * f))


class FFN(nn.Module):
    def __init__(self, d, units):
        super().__init__()
        self.Dense_0 = Linear(d, units)
        self.Dense_1 = Linear(units, d)

    def forward(self, x):
        return self.Dense_1(swish(self.Dense_0(x)))


class MHSA(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.h, self.dk = heads, d // heads
        self.Dense_0, self.Dense_1, self.Dense_2, self.Dense_3 = (
            Linear(d, d), Linear(d, d), Linear(d, d), Linear(d, d))
        self.Dense_4 = Linear(d, d, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, self.dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, self.dk))

    def forward(self, x, pe, m):
        b, t, d = x.shape

        def heads(y):                                    # (B, h, T', d_k)
            return y.reshape(y.shape[0], t, self.h, self.dk).transpose(1, 2)

        q = self.Dense_0(x).reshape(b, t, self.h, self.dk)
        k, v = heads(self.Dense_1(x)), heads(self.Dense_2(x))
        p = heads(self.Dense_4(pe[None]))
        qu = (q + self.pos_bias_u).transpose(1, 2)
        qv = (q + self.pos_bias_v).transpose(1, 2)
        s = (matmul(qu, k.transpose(-2, -1)) + matmul(qv, p.transpose(-2, -1))) / math.sqrt(self.dk)
        s = s.masked_fill(m[:, None, None, :] == 0, float("-inf"))
        a = matmul(torch.softmax(s, dim=-1), v)          # (B, h, T', d_k)
        return self.Dense_3(a.transpose(1, 2).reshape(b, t, d))


class ConvModule(nn.Module):
    def __init__(self, d, kernel):
        super().__init__()
        self.Conv_0 = Conv1d(d, 2 * d, 1)
        self.Conv_1 = Conv1d(d, d, kernel, padding=(kernel - 1) // 2, groups=d)
        self.BatchNorm1d_0 = BN(d)
        self.Conv_2 = Conv1d(d, d, 1)

    def forward(self, x, m):
        z = x.transpose(1, 2) * m[:, None, :]            # (B, d, T')
        y = self.Conv_0(z)
        a, g = y.chunk(2, dim=1)
        y = swish(self.BatchNorm1d_0(self.Conv_1(a * torch.sigmoid(g))))
        return (self.Conv_2(y) * m[:, None, :]).transpose(1, 2)


class Block(nn.Module):
    def __init__(self, d, heads, units, kernel):
        super().__init__()
        (self.LayerNorm_0, self.LayerNorm_1, self.LayerNorm_2, self.LayerNorm_3,
         self.LayerNorm_4) = (LayerNorm(d) for _ in range(5))
        self.FeedForward_0 = FFN(d, units)
        self.RelPositionAttention_0 = MHSA(d, heads)
        self.ConvModule_0 = ConvModule(d, kernel)
        self.FeedForward_1 = FFN(d, units)

    def forward(self, h, pe, m):
        h = h + 0.5 * self.FeedForward_0(self.LayerNorm_0(h))
        h = h + self.RelPositionAttention_0(self.LayerNorm_1(h), pe, m)
        h = h + self.ConvModule_0(self.LayerNorm_2(h), m)
        h = h + 0.5 * self.FeedForward_1(self.LayerNorm_3(h))
        return self.LayerNorm_4(h)


class MFAConformer(nn.Module):
    def __init__(self, input_size=MELS, output_size=D, num_blocks=BLOCKS,
                 attention_heads=HEADS, linear_units=UNITS,
                 cnn_module_kernel=KERNEL, embd_dim=EMBD):
        super().__init__()
        self.d, self.blocks = output_size, [f"ConformerBlock_{i}" for i in range(num_blocks)]
        self.Subsampling_0 = Subsampling(input_size, output_size)
        for name in self.blocks:
            setattr(self, name, Block(output_size, attention_heads, linear_units,
                                      cnn_module_kernel))
        c = output_size * num_blocks
        self.LayerNorm_0 = LayerNorm(c)
        self.AttentiveStatisticsPooling_0 = ASP(c, ATT, True)
        self.BatchNorm1d_0 = BN(2 * c)
        self.Dense_0 = Linear(2 * c, embd_dim)

    def forward(self, feats, lengths=None):
        """``(B, T, n_mels)`` features and the valid fractions ``(B,)``
        (every frame when None) -> ``(B, embd_dim)``."""
        h = self.Subsampling_0(feats) * math.sqrt(self.d)
        b, t, _ = h.shape
        if lengths is None:
            m = h.new_ones((b, t))
        else:
            r = lengths.to(torch.float32).to(h.device)
            m = (torch.arange(t, device=h.device)[None, :] < r[:, None] * t).to(h.dtype)
        pe = sinusoid(t, self.d, h.device)
        outs = []
        for name in self.blocks:
            h = getattr(self, name)(h, pe, m)
            outs.append(h)
        h = self.LayerNorm_0(torch.cat(outs, dim=-1)).transpose(1, 2)
        pooled = self.BatchNorm1d_0(self.AttentiveStatisticsPooling_0(h, m[:, None, :]))
        return self.Dense_0(pooled)


Model = MFAConformer


def positions(frames):
    """Positions after the subsampling of ``frames`` frames."""
    return max((int(frames) - 1) // 2, 0)


def attention_flops(n, blocks=BLOCKS, heads=HEADS, d_k=D // HEADS):
    """The scores ``[q+u | q+v] [k | p]^T`` (head dimension ``2 d_k``) and
    the weighted sum ``A v`` over ``n`` positions, two FLOPs a
    multiply-add."""
    return blocks * heads * (2 * n * n * 2 * d_k + 2 * n * n * d_k)


def forward_flops(frames, rows):
    """The whole forward of one clip of ``frames`` valid frames at the
    published widths, two FLOPs a multiply-add over the ``positions``
    they give: the subsampling's conv and Linear, each block's projections
    (``linear_pos`` over every position), feed-forwards, pointwise and
    depthwise convs and attention, the pooling's two 1x1 convs, and the
    head once a clip. The plain backbone has no trunk rows, so ``rows`` is
    ignored."""
    n = positions(frames)
    f = (MELS - 1) // 2
    per_pos = (D * f * 9                                         # Conv2d k3
               + D * f * D                                       # Linear
               + BLOCKS * (2 * 2 * D * UNITS                     # two FFNs
                           + 5 * D * D                           # q k v out pos
                           + D * 2 * D + D * KERNEL + D * D)     # conv module
               + 3 * D * BLOCKS * ATT + ATT * D * BLOCKS)        # ASP
    return 2 * (per_pos * n + 2 * D * BLOCKS * EMBD) + attention_flops(n)
