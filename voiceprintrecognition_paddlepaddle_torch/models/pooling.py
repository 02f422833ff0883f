"""Length-aware temporal poolings (counterpart of the JAX
``models/pooling.py``): TAP, TSP, SAP, ASP and TSTP.

Each pooling takes ``(B, T, C)``, as in the JAX package, and optional
``lengths``, the per-utterance valid fractions: frame ``t`` is valid when
``t < ratio * T``. ``lengths=None`` pools over every frame. TSTP also
takes the 2-D backbones' NCHW ``(B, C, F, T)`` and flattens ``(F, C)``
frequency-major (index ``f * C + c``), as the JAX NHWC reshape does.
Variance uses ddof=1 where the reference relies on paddle's unbiased
default.
"""

import torch
from torch import nn

from .layers import SamePadConv1d, TDNNBlock, length_to_mask

__all__ = ["masked_mean_var", "TemporalAveragePooling",
           "TemporalStatisticsPooling", "SelfAttentivePooling",
           "AttentiveStatisticsPooling", "TemporalStatsPool", "POOLINGS",
           "POOLING_DIM_FACTOR"]

# output dim = factor * input channel dim
POOLING_DIM_FACTOR = {"TAP": 1, "SAP": 1, "TSP": 2, "ASP": 2, "TSTP": 2}


def _time_mask(x, lengths):
    """``(B, T, 1)`` validity mask of ``(B, T, C)`` in ``x``'s dtype."""
    t = x.shape[1]
    ratio = torch.as_tensor(lengths, dtype=torch.float32, device=x.device)
    return length_to_mask(ratio * t, t).to(x.dtype)[:, :, None]


def masked_mean_var(x, lengths, ddof=0):
    """Mean / variance over the valid frames of ``(B, T, C)``.

    Frame ``t`` is valid when ``t < ratio * T``, i.e. ``ceil(ratio * T)``
    frames. ``None`` means every frame is valid."""
    if lengths is None:
        return x.mean(dim=1), x.var(dim=1, correction=ddof)
    mask = _time_mask(x, lengths)
    n = torch.clamp(mask.sum(dim=1), min=1.0)
    mean = (x * mask).sum(dim=1) / n
    var = (((x - mean[:, None, :]) ** 2) * mask).sum(dim=1) / \
        torch.clamp(n - ddof, min=1.0)
    return mean, var


class TemporalAveragePooling(nn.Module):
    """TAP: mean over time."""

    def __init__(self, channels=None):
        super().__init__()

    def forward(self, x, lengths=None):
        return masked_mean_var(x, lengths)[0]


class TemporalStatisticsPooling(nn.Module):
    """TSP: mean || variance (ddof 1) over time."""

    def __init__(self, channels=None):
        super().__init__()

    def forward(self, x, lengths=None):
        mean, var = masked_mean_var(x, lengths, ddof=1)
        return torch.cat([mean, var], dim=-1)


class SelfAttentivePooling(nn.Module):
    """SAP: tanh-bottleneck attention weights over time, weighted mean."""

    def __init__(self, channels, bottleneck_dim=128):
        super().__init__()
        self.Conv_0 = nn.Conv1d(channels, bottleneck_dim, 1)
        self.Conv_1 = nn.Conv1d(bottleneck_dim, channels, 1)

    def forward(self, x, lengths=None):
        alpha = self.Conv_1(torch.tanh(self.Conv_0(x.transpose(1, 2))))
        alpha = alpha.transpose(1, 2)
        if lengths is not None:
            alpha = alpha.masked_fill(_time_mask(x, lengths) == 0,
                                      float("-inf"))
        return (torch.softmax(alpha, dim=1) * x).sum(dim=1)


class AttentiveStatisticsPooling(nn.Module):
    """ASP (JAX ``pooling.py:96-121``): with ``global_context``, the masked
    global mean / std (weights ``mask / total``, ``sqrt(max(var, eps))``)
    are tiled over time and concatenated with the input; a tanh TDNN
    bottleneck gives per-frame attention, padded frames go to -inf before
    the softmax over time, and the attention-weighted mean || std is
    returned."""

    def __init__(self, channels, attention_channels=128, global_context=True,
                 eps=1e-12):
        super().__init__()
        self.global_context = global_context
        self.eps = eps
        self.TDNNBlock_0 = TDNNBlock(
            channels * 3 if global_context else channels, attention_channels,
            1)
        self.SamePadConv1d_0 = SamePadConv1d(attention_channels, channels, 1)

    def _stats(self, x, m):
        mean = (m * x).sum(dim=1)
        var = (m * (x - mean[:, None, :]) ** 2).sum(dim=1)
        return mean, torch.sqrt(torch.clamp(var, min=self.eps))

    def forward(self, x, lengths=None):
        b, t, c = x.shape
        if lengths is None:
            lengths = torch.ones((b,), dtype=torch.float32, device=x.device)
        mask = _time_mask(x, lengths)
        if self.global_context:
            mean, std = self._stats(x, mask / mask.sum(dim=1, keepdim=True))
            attn = torch.cat([x, mean[:, None, :].expand(b, t, c),
                              std[:, None, :].expand(b, t, c)], dim=-1)
        else:
            attn = x
        attn = self.TDNNBlock_0(attn.transpose(1, 2))
        attn = self.SamePadConv1d_0(torch.tanh(attn)).transpose(1, 2)
        attn = torch.softmax(attn.masked_fill(mask == 0, float("-inf")),
                             dim=1)
        return torch.cat(self._stats(x, attn), dim=-1)


class TemporalStatsPool(nn.Module):
    """TSTP: mean || std over time (ddof 1, ``sqrt(var + 1e-8)``), on
    ``(B, T, C)`` or NCHW ``(B, C, F, T)``."""

    def __init__(self, channels=None):
        super().__init__()

    def forward(self, x, lengths=None):
        if x.ndim == 4:
            b, c, f, t = x.shape
            x = x.permute(0, 3, 2, 1).reshape(b, t, f * c)
        mean, var = masked_mean_var(x, lengths, ddof=1)
        return torch.cat([mean, torch.sqrt(var + 1e-8)], dim=-1)


POOLINGS = {
    "TAP": TemporalAveragePooling,
    "TSP": TemporalStatisticsPooling,
    "SAP": SelfAttentivePooling,
    "ASP": AttentiveStatisticsPooling,
    "TSTP": TemporalStatsPool,
}
