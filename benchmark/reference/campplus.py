"""CAM++ (3D-Speaker, arXiv:2303.00332; ppvector ``models/campplus.py``)
as plain PyTorch modules whose state-dict keys are the port's.

``CAMPPlus.forward(feats, lengths)`` is the model as trained: the CAM
context over the whole input, the statistics over the valid frames.
``CAMPPlus.embed_masked(feats, tvalids)`` is the function the port's
kernel path serves on a padded batch: every trunk row at or past an
utterance's valid count is zero after each layer's write, and the CAM
context, the pooling and the unbiased deviation count the valid rows
only. Both run in the products' precision of ``precision.precision``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .precision import BatchNorm, Conv1d, Conv2d, Linear

SEG_LEN = 100


class NonLinear(nn.Module):
    """``batchnorm-relu``: BatchNorm_0 then ReLU; ``batchnorm_``: the
    BatchNorm alone."""

    def __init__(self, channels, relu=True):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels)
        self.relu = relu

    def forward(self, x):
        x = self.BatchNorm_0(x)
        return torch.relu(x) if self.relu else x


class BasicResBlock(nn.Module):
    def __init__(self, planes, stride):
        super().__init__()
        self.Conv_0 = Conv2d(planes, planes, 3, stride=(stride, 1), padding=1)
        self.BatchNorm_0 = BatchNorm(planes)
        self.Conv_1 = Conv2d(planes, planes, 3, padding=1)
        self.BatchNorm_1 = BatchNorm(planes)
        self.has_shortcut = stride != 1
        if self.has_shortcut:
            self.Conv_2 = Conv2d(planes, planes, 1, stride=(stride, 1))
            self.BatchNorm_2 = BatchNorm(planes)

    def forward(self, x):
        out = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = self.BatchNorm_1(self.Conv_1(out))
        sc = self.BatchNorm_2(self.Conv_2(x)) if self.has_shortcut else x
        return torch.relu(out + sc)


class FCM(nn.Module):
    """``(B, T, 80) -> (B, T, 320)``, frequency-major (``f * 32 + c``)."""

    def __init__(self, m=32):
        super().__init__()
        self.Conv_0 = Conv2d(1, m, 3, padding=1)
        self.BatchNorm_0 = BatchNorm(m)
        for i, stride in enumerate((2, 1, 2, 1)):
            setattr(self, f"BasicResBlock_{i}", BasicResBlock(m, stride))
        self.Conv_1 = Conv2d(m, m, 3, stride=(2, 1), padding=1)
        self.BatchNorm_1 = BatchNorm(m)

    def forward(self, x):
        out = torch.relu(self.BatchNorm_0(self.Conv_0(x.transpose(1, 2)[:, None])))
        for i in range(4):
            out = getattr(self, f"BasicResBlock_{i}")(out)
        out = torch.relu(self.BatchNorm_1(self.Conv_1(out)))
        b, c, f, t = out.shape
        return out.permute(0, 3, 2, 1).reshape(b, t, f * c)


class TDNNLayer(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.Conv_0 = Conv1d(cin, cout, 5, stride=2, padding=2)
        self._NonLinear_0 = NonLinear(cout)

    def forward(self, x):
        return self._NonLinear_0(self.Conv_0(x))


class CAMLayer(nn.Module):
    def __init__(self, bn_ch, out_ch, dilation):
        super().__init__()
        self.Conv_0 = Conv1d(bn_ch, out_ch, 3, padding=dilation,
                             dilation=dilation)
        self.Conv_1 = Conv1d(bn_ch, bn_ch // 2, 1)
        self.Conv_2 = Conv1d(bn_ch // 2, out_ch, 1)

    def gate(self, context):
        return torch.sigmoid(self.Conv_2(torch.relu(self.Conv_1(context))))


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, cin, out_ch, bn_ch, dilation):
        super().__init__()
        self._NonLinear_0 = NonLinear(cin)
        self.Conv_0 = Conv1d(cin, bn_ch, 1)
        self._NonLinear_1 = NonLinear(bn_ch)
        self.CAMLayer_0 = CAMLayer(bn_ch, out_ch, dilation)

    def bottleneck(self, x):
        return self._NonLinear_1(self.Conv_0(self._NonLinear_0(x)))


class CAMDenseTDNNBlock(nn.Module):
    def __init__(self, n, cin, growth, bn_ch, dilation):
        super().__init__()
        self.n = n
        for i in range(n):
            setattr(self, f"CAMDenseTDNNLayer_{i}", CAMDenseTDNNLayer(
                cin + i * growth, growth, bn_ch, dilation))


def seg_means(x, valid=None):
    """Each frame's 100-frame segment mean of ``(B, C, T)``; with the
    ``(B, 1, T)`` mask ``valid``, over the segment's valid frames."""
    b, c, t = x.shape
    n = -(-t // SEG_LEN)
    pad = n * SEG_LEN - t
    v = torch.ones((b, 1, t), dtype=x.dtype, device=x.device) if valid is None else valid
    sums = F.pad(x * v, (0, pad)).reshape(b, c, n, SEG_LEN).sum(-1)
    cnt = F.pad(v, (0, pad)).reshape(b, 1, n, SEG_LEN).sum(-1).clamp(min=1)
    return (sums / cnt).repeat_interleave(SEG_LEN, dim=-1)[..., :t]


class CAMPPlus(nn.Module):
    def __init__(self, input_size=80, embd_dim=192, growth_rate=32,
                 bn_size=4, init_channels=128):
        super().__init__()
        self.FCM_0 = FCM()
        self.TDNNLayer_0 = TDNNLayer(32 * (-(-input_size // 8)), init_channels)
        c = init_channels
        for b, (n, dil) in enumerate(zip((12, 24, 16), (1, 2, 2))):
            setattr(self, f"CAMDenseTDNNBlock_{b}", CAMDenseTDNNBlock(
                n, c, growth_rate, bn_size * growth_rate, dil))
            c += n * growth_rate
            setattr(self, f"_NonLinear_{b}", NonLinear(c))
            setattr(self, f"Conv_{b}", Conv1d(c, c // 2, 1))
            c //= 2
        self._NonLinear_3 = NonLinear(c)
        self.DenseBN_0 = nn.Module()
        self.DenseBN_0.Dense_0 = Linear(2 * c, embd_dim)
        self.DenseBN_0.BatchNorm_0 = BatchNorm(embd_dim)

    def _trunk(self, x, mask):
        """FCM output ``(B, T_raw, 320)`` -> final ``(B, C, T)``; ``mask``
        None (every row valid, the model as trained) or a function that
        zeroes the rows past the valid counts."""
        keep = mask or (lambda v: v)
        x = keep(self.TDNNLayer_0(x.transpose(1, 2)))
        for b in range(3):
            blk = getattr(self, f"CAMDenseTDNNBlock_{b}")
            for i in range(blk.n):
                layer = getattr(blk, f"CAMDenseTDNNLayer_{i}")
                h = keep(layer.bottleneck(x))
                cam = layer.CAMLayer_0
                y = cam.Conv_0(h)
                if mask is None:
                    ctx = h.mean(-1, keepdim=True) + seg_means(h)
                else:
                    ctx = (h.sum(-1, keepdim=True) / self._tv
                           + seg_means(h, self._valid))
                x = torch.cat([x, keep(y * cam.gate(ctx))], dim=1)
            x = keep(getattr(self, f"Conv_{b}")(getattr(self, f"_NonLinear_{b}")(x)))
        return keep(self._NonLinear_3(x))

    def _head(self, stats):
        return self.DenseBN_0.BatchNorm_0(self.DenseBN_0.Dense_0(stats))

    def forward(self, feats, lengths=None):
        """The model as trained: ``(B, T, 80)`` and valid fractions."""
        x = self._trunk(self.FCM_0(feats), None).transpose(1, 2)
        t = x.shape[1]
        if lengths is None:
            mean, var = x.mean(1), x.var(1, correction=1)
        else:
            m = (torch.arange(t, device=x.device)[None, :]
                 < lengths.float()[:, None] * t).to(x.dtype)[..., None]
            n = m.sum(1).clamp(min=1)
            mean = (x * m).sum(1) / n
            var = (((x - mean[:, None]) ** 2) * m).sum(1) / (n - 1).clamp(min=1)
        return self._head(torch.cat([mean, torch.sqrt(var.clamp(min=0))], -1))

    def embed_masked(self, feats, tvalids):
        """The kernel path's function: ``(B, T_raw, 80)`` CMN'd features
        and per-utterance valid trunk rows -> ``(B, embd_dim)``."""
        t_valid = (feats.shape[1] - 1) // 2 + 1
        tv = torch.as_tensor(np.asarray(tvalids), device=feats.device).long()
        valid = (torch.arange(t_valid, device=feats.device)[None, :]
                 < tv[:, None]).to(feats.dtype)[:, None, :]
        self._valid, self._tv = valid, tv.to(feats.dtype)[:, None, None]
        try:
            x = self._trunk(self.FCM_0(feats), lambda v: v * valid)
        finally:
            del self._valid, self._tv
        n = tv.to(x.dtype)[:, None]
        mean = x.sum(-1) / n
        var = (((x - mean[..., None]) ** 2) * valid).sum(-1) / n
        std = torch.sqrt(var) * torch.sqrt(n / (n - 1).clamp(min=1))
        return self._head(torch.cat([mean, std], -1))


def tvalids(ratios, t_raw):
    """Valid trunk rows ``ceil(r * t_valid)`` in float32, in ``[1, t_valid]``."""
    t_valid = (t_raw - 1) // 2 + 1
    r = np.asarray(ratios, np.float32)
    return np.clip(np.ceil(r * np.float32(t_valid)).astype(np.int64), 1, t_valid)


Model = CAMPPlus


def forward_flops(frames, rows):
    """The whole forward of one clip of ``frames`` valid frames and
    ``rows`` valid trunk rows (``work.campplus_flops``)."""
    from ..work import campplus_flops
    return campplus_flops(frames, rows)
