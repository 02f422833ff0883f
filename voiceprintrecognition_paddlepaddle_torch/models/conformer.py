"""MFA-Conformer backbone (Zhang et al., "MFA-Conformer: Multi-scale
Feature Aggregation Conformer for Automatic Speaker Verification",
Interspeech 2022, arXiv:2203.15249), a port-only backbone: the JAX
package has no counterpart.

The encoder is WeNet's ``ConformerEncoder`` with ``conv2d2`` subsampling
and relative-position self-attention, as the authors build it:

- subsampling by 2: a k3 stride-2 Conv2d from 1 to ``output_size``
  channels over (time, mel), ReLU, a Linear from ``output_size`` x
  ``(F - 1) // 2`` to ``output_size``, then the scale ``sqrt(d)``;
- ``num_blocks`` Conformer blocks, pre-norm, macaron style: half a
  feed-forward (swish), relative-position self-attention, the
  convolution module (pointwise to ``2d``, GLU, depthwise
  ``cnn_module_kernel``, BatchNorm, swish, pointwise), the other half
  feed-forward, then a LayerNorm;
- the blocks' outputs concatenated over channels (the multi-scale feature
  aggregation) and a LayerNorm;
- attentive statistics pooling with global context, BatchNorm of the
  pooled vector and a Linear to ``embd_dim``.

The attention is WeNet's ``RelPositionMultiHeadedAttention`` without
``rel_shift``: ``((q + u) k^T + (q + v) p^T) / sqrt(d_k)`` with learned
biases ``u``, ``v`` and ``p`` the bias-free ``linear_pos`` of the
sinusoidal table. It runs as one fused
``F.scaled_dot_product_attention`` by folding the position term into the
key dimension: ``Q' = [q + u | q + v]``, ``K' = [k | p]`` (head
dimension ``2 d_k``), ``V = v`` and the scale ``1 / sqrt(d_k)``, so no
``(B, h, T', T')`` score tensor is held.

``lengths`` are the per-utterance valid fractions, as for every backbone:
a position ``t'`` after subsampling is valid when ``t' < ratio * T'``
(``models.pooling``'s convention; WeNet takes every second frame of the
input mask, which differs by at most one position). Padded positions are
masked out of the attention's keys, zeroed at the convolution module's
input and output (as WeNet does) and left out of the pooling.

Spans (``utils.tracing``): ``vpr.conformer`` around the forward, inside
it ``vpr.conformer.subsample``, ``vpr.conformer.block`` (the block's
index as ``id``) holding ``vpr.conformer.ffn``, ``.attn``, ``.conv`` and
``.ffn``, then ``vpr.conformer.mfa``, ``vpr.conformer.pool`` and
``vpr.conformer.head``. None waits for the device. Counters: ``calls``,
the forwards dispatched, and ``rows``, the ``B x T'`` positions they
dispatched, both from shapes.
"""

import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import tracing
from .layers import BatchNorm1d, length_to_mask
from .pooling import AttentiveStatisticsPooling

__all__ = ["MFAConformer"]

LN_EPS = 1e-5
_count_lock = threading.Lock()


def sinusoid_table(positions, dim, device=None):
    """WeNet's ``PositionalEncoding.pe``: ``(positions, dim)`` float32,
    ``sin`` at even and ``cos`` at odd channels of ``pos / 10000^(2i/d)``.
    Built per forward on the device, so it is never in the state dict."""
    pos = torch.arange(positions, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    table = torch.zeros(positions, dim, device=device)
    table[:, 0::2] = torch.sin(pos * div)
    table[:, 1::2] = torch.cos(pos * div)
    return table


class Subsampling(nn.Module):
    """WeNet's ``Conv2dSubsampling2`` on ``(B, T, F)``: ``(B, T', d)``
    with ``T' = (T - 1) // 2``."""

    def __init__(self, input_size, dim):
        super().__init__()
        self.Conv_0 = nn.Conv2d(1, dim, 3, 2)
        self.Dense_0 = nn.Linear(dim * ((input_size - 1) // 2), dim)

    def forward(self, x):
        x = torch.relu(self.Conv_0(x[:, None]))
        b, c, t, f = x.shape
        return self.Dense_0(x.transpose(1, 2).reshape(b, t, c * f))


class FeedForward(nn.Module):
    def __init__(self, dim, units):
        super().__init__()
        self.Dense_0 = nn.Linear(dim, units)
        self.Dense_1 = nn.Linear(units, dim)

    def forward(self, x):
        return self.Dense_1(F.silu(self.Dense_0(x)))


class RelPositionAttention(nn.Module):
    """Multi-head self-attention with WeNet's position term; ``Dense_0``
    to ``Dense_3`` are the query, key, value and output projections,
    ``Dense_4`` the bias-free ``linear_pos``."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads, self.d_k = heads, dim // heads
        for i in range(4):
            setattr(self, f"Dense_{i}", nn.Linear(dim, dim))
        self.Dense_4 = nn.Linear(dim, dim, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.empty(heads, self.d_k))
        nn.init.xavier_uniform_(self.pos_bias_u)
        nn.init.xavier_uniform_(self.pos_bias_v)

    def forward(self, x, pos, key_mask):
        """``x`` (B, T', d), ``pos`` (T', d), ``key_mask`` (B, 1, 1, T')
        bool (True: attend) or None."""
        b, t, _ = x.shape
        h, dk = self.heads, self.d_k
        q = self.Dense_0(x).view(b, t, h, dk)
        k = self.Dense_1(x).view(b, t, h, dk)
        v = self.Dense_2(x).view(b, t, h, dk)
        p = self.Dense_4(pos).view(1, t, h, dk).expand(b, t, h, dk)
        q2 = torch.cat([q + self.pos_bias_u, q + self.pos_bias_v], dim=-1)
        k2 = torch.cat([k, p], dim=-1)
        out = F.scaled_dot_product_attention(
            q2.transpose(1, 2), k2.transpose(1, 2), v.transpose(1, 2),
            attn_mask=key_mask, scale=dk ** -0.5)
        return self.Dense_3(out.transpose(1, 2).reshape(b, t, h * dk))


class ConvModule(nn.Module):
    """Pointwise conv to ``2d``, GLU, depthwise conv, BatchNorm, swish,
    pointwise conv, on ``(B, T', d)``; padded positions are zeroed at the
    input and at the output."""

    def __init__(self, dim, kernel):
        super().__init__()
        self.Conv_0 = nn.Conv1d(dim, 2 * dim, 1)
        self.Conv_1 = nn.Conv1d(dim, dim, kernel, padding=(kernel - 1) // 2,
                                groups=dim)
        self.BatchNorm1d_0 = BatchNorm1d(dim)
        self.Conv_2 = nn.Conv1d(dim, dim, 1)

    def forward(self, x, pad_mask):
        """``pad_mask`` (B, 1, T') bool, True at padded positions, or None."""
        x = x.transpose(1, 2)
        if pad_mask is not None:
            x = x.masked_fill(pad_mask, 0.0)
        x = F.glu(self.Conv_0(x), dim=1)
        x = self.Conv_2(F.silu(self.BatchNorm1d_0(self.Conv_1(x))))
        if pad_mask is not None:
            x = x.masked_fill(pad_mask, 0.0)
        return x.transpose(1, 2)


class ConformerBlock(nn.Module):
    def __init__(self, dim, heads, units, kernel):
        super().__init__()
        for i in range(5):
            setattr(self, f"LayerNorm_{i}", nn.LayerNorm(dim, eps=LN_EPS))
        self.FeedForward_0 = FeedForward(dim, units)
        self.RelPositionAttention_0 = RelPositionAttention(dim, heads)
        self.ConvModule_0 = ConvModule(dim, kernel)
        self.FeedForward_1 = FeedForward(dim, units)

    def forward(self, x, pos, key_mask, pad_mask):
        with tracing.span("vpr.conformer.ffn"):
            x = x + 0.5 * self.FeedForward_0(self.LayerNorm_0(x))
        with tracing.span("vpr.conformer.attn"):
            x = x + self.RelPositionAttention_0(self.LayerNorm_1(x), pos,
                                                key_mask)
        with tracing.span("vpr.conformer.conv"):
            x = x + self.ConvModule_0(self.LayerNorm_2(x), pad_mask)
        with tracing.span("vpr.conformer.ffn"):
            x = x + 0.5 * self.FeedForward_1(self.LayerNorm_3(x))
        return self.LayerNorm_4(x)


class MFAConformer(nn.Module):
    def __init__(self, input_size, output_size=256, num_blocks=6,
                 attention_heads=4, linear_units=2048, cnn_module_kernel=15,
                 embd_dim=192):
        super().__init__()
        self.dim, self.num_blocks = output_size, num_blocks
        self.Subsampling_0 = Subsampling(input_size, output_size)
        for i in range(num_blocks):
            setattr(self, f"ConformerBlock_{i}", ConformerBlock(
                output_size, attention_heads, linear_units, cnn_module_kernel))
        mfa = output_size * num_blocks
        self.LayerNorm_0 = nn.LayerNorm(mfa, eps=LN_EPS)
        self.AttentiveStatisticsPooling_0 = AttentiveStatisticsPooling(mfa)
        self.BatchNorm1d_0 = BatchNorm1d(2 * mfa)
        self.Dense_0 = nn.Linear(2 * mfa, embd_dim)
        self.calls = 0
        self.rows = 0

    def _masks(self, t, lengths, device):
        """The attention's key mask (B, 1, 1, T') and the convolution
        module's padding mask (B, 1, T'), or two Nones."""
        if lengths is None:
            return None, None
        ratio = torch.as_tensor(lengths, dtype=torch.float32, device=device)
        valid = length_to_mask(ratio * t, t)
        return valid[:, None, None, :], ~valid[:, None, :]

    def forward(self, x, lengths=None):
        with tracing.span("vpr.conformer"):
            with tracing.span("vpr.conformer.subsample"):
                x = self.Subsampling_0(x) * math.sqrt(self.dim)
                b, t, _ = x.shape
                with _count_lock:
                    self.calls += 1
                    self.rows += b * t
                key_mask, pad_mask = self._masks(t, lengths, x.device)
                pos = sinusoid_table(t, self.dim, x.device)
            outs = []
            for i in range(self.num_blocks):
                with tracing.span("vpr.conformer.block", id=i):
                    x = getattr(self, f"ConformerBlock_{i}")(
                        x, pos, key_mask, pad_mask)
                outs.append(x)
            with tracing.span("vpr.conformer.mfa"):
                x = self.LayerNorm_0(torch.cat(outs, dim=-1))
            with tracing.span("vpr.conformer.pool"):
                x = self.AttentiveStatisticsPooling_0(x, lengths)
            with tracing.span("vpr.conformer.head"):
                return self.Dense_0(self.BatchNorm1d_0(x))
