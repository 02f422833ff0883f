"""Shared model building blocks (counterpart of the JAX ``models/layers.py``).

Layouts: 1-D (temporal) modules run torch's ``(B, C, T)``; 2-D modules
run NCHW ``(B, C, F, T)``. Attribute names follow the flax parameter tree
(``Conv_0``, ``BatchNorm_0``, ``SamePadConv1d_0``, ...) so that
``convert.jax_to_torch_state`` is a plain tree walk. Every BatchNorm is
``BatchNorm``: the reference's eps 1e-5, and in training flax's
``nn.BatchNorm(momentum=0.9)`` update of the running statistics.
"""

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BN_EPS", "BatchNorm", "bn_affine", "length_to_mask",
           "hardtanh_relu20", "SamePadConv1d", "BatchNorm1d", "BN2d",
           "TDNNBlock", "NonLinear", "DenseBN", "avg_pool_exclusive"]

BN_EPS = 1e-5


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the channel axis 1 of an NC* tensor of any rank, with
    scale and bias (JAX ``layers.py:65-72``, ``campplus.py:62-63``).

    Evaluation normalizes by the running statistics, as ``nn.BatchNorm1d``
    does. Training normalizes by the batch statistics and then moves the
    running ones by ``momentum`` 0.1 (flax's 0.9) towards the batch mean
    and the *biased* batch variance, as flax does; torch's own update takes
    the unbiased variance, ``n / (n - 1)`` times larger. Torch's fused
    update runs first and the variance is then corrected on the ``(C,)``
    vector: no second pass over the activations. ``momentum=None`` (a
    cumulative average, as ``nn.BatchNorm1d``) keeps the same correction.
    """

    def __init__(self, channels, eps=BN_EPS, momentum=0.1):
        super().__init__(channels, eps=eps, momentum=momentum)

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected an NC* input, got {x.dim()}-D")

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        factor = (self.momentum if self.momentum is not None
                  else 1.0 / float(self.num_batches_tracked))
        # torch's update lands in a copy (autograd keeps the tensors the
        # op was given, so the buffer itself must not change after it)
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, factor, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            # torch folded in factor * v * n / (n - 1); take
            # factor * v / (n - 1) back out: what remains is factor * v
            self.running_var.copy_(
                var - (var - (1.0 - factor) * self.running_var) / n)
        return y


def bn_affine(bn):
    """Inference BN as a per-channel affine ``(a, b)`` in fp32:
    ``bn(x) = x * a + b``."""
    a = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return a, bn.bias.float() - bn.running_mean.float() * a


def length_to_mask(lengths, max_len):
    """``(B,)`` lengths (frames, may be fractional) -> ``(B, max_len)``
    boolean mask, frame ``t`` valid when ``t < lengths``."""
    idx = torch.arange(max_len, device=lengths.device)[None, :]
    return idx < lengths[:, None]


def hardtanh_relu20(x):
    """ERes2Net's ReLU: Hardtanh(0, 20)."""
    return torch.clamp(x, 0.0, 20.0)


class SamePadConv1d(nn.Module):
    """Stride-1 conv over time on ``(B, C, T)`` with the reference's 'same'
    padding in reflect mode, then a VALID conv (JAX ``layers.py:36-62``).

    ``jnp.pad(mode="reflect")`` repeats the reflection when the pad is not
    shorter than the input; ``F.pad`` refuses such a pad, and so does this
    module (``ValueError``) rather than compute something else."""

    def __init__(self, in_channels, features, kernel_size, dilation=1):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_channels, features, kernel_size,
                                dilation=dilation)

    def forward(self, x):
        (k,), (d,) = self.Conv_0.kernel_size, self.Conv_0.dilation
        pad = d * (k - 1) // 2
        if pad:
            if pad >= x.shape[-1]:
                raise ValueError(
                    f"reflect padding of {pad} frames needs more than {pad} "
                    f"frames of input, got {x.shape[-1]}")
            x = F.pad(x, (pad, pad), mode="reflect")
        return self.Conv_0(x)


class BatchNorm1d(nn.Module):
    """BatchNorm over the channel axis of ``(B, C)`` or ``(B, C, T)``
    (JAX ``layers.py:65-72``, a wrapper in the flax tree)."""

    def __init__(self, channels):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x):
        return self.BatchNorm_0(x)


class BN2d(nn.Module):
    """BatchNorm over the channel axis of NCHW (the JAX 2-D backbones'
    ``_BN2d`` wrapper)."""

    def __init__(self, channels):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x):
        return self.BatchNorm_0(x)


class TDNNBlock(nn.Module):
    """conv -> ReLU -> BN (JAX ``layers.py:75-88``), on ``(B, C, T)``."""

    def __init__(self, in_channels, features, kernel_size, dilation=1):
        super().__init__()
        self.SamePadConv1d_0 = SamePadConv1d(in_channels, features,
                                             kernel_size, dilation=dilation)
        self.BatchNorm1d_0 = BatchNorm1d(features)

    def forward(self, x):
        return self.BatchNorm1d_0(torch.relu(self.SamePadConv1d_0(x)))


class _Stack(nn.Module):
    """The ``get_nonlinear`` stack of a ``config_str`` such as
    ``"batchnorm-relu"`` or ``"prelu-batchnorm"``: its BatchNorms are
    ``BatchNorm_0``, ``BatchNorm_1``, ... and a PReLU's slope is the
    parameter ``prelu_alpha``, as in the flax tree. Applied over the
    channel axis 1."""

    def _build_stack(self, channels, config_str):
        self.config_str = config_str
        self._ops = []
        for name in config_str.split("-"):
            if name == "relu":
                self._ops.append("relu")
            elif name in ("batchnorm", "batchnorm_"):
                n = sum(o.startswith("BatchNorm") for o in self._ops)
                bn = f"BatchNorm_{n}"
                setattr(self, bn, BatchNorm(channels))
                self._ops.append(bn)
            elif name == "prelu":
                self.prelu_alpha = nn.Parameter(torch.full((channels,), 0.25))
                self._ops.append("prelu")
            else:
                raise ValueError(f"Unexpected module ({name}).")

    def _run_stack(self, x):
        for op in self._ops:
            if op == "relu":
                x = torch.relu(x)
            elif op == "prelu":
                a = self.prelu_alpha.view(-1, *([1] * (x.ndim - 2)))
                x = torch.where(x >= 0, x, a * x)
            else:
                x = getattr(self, op)(x)
        return x


class NonLinear(_Stack):
    """The BN / ReLU / PReLU stack of CAM++ (JAX ``campplus.py:52-71``) on
    ``(B, C, T)``."""

    def __init__(self, channels, config_str="batchnorm-relu"):
        super().__init__()
        self._build_stack(channels, config_str)

    def forward(self, x):
        return self._run_stack(x)


class DenseBN(_Stack):
    """Linear, then the ``config_str`` stack (JAX ``layers.py:91-115``), on
    ``(B, C)``: the classifier's dense blocks and the CAM++ embedding head
    (``config_str="batchnorm_"``)."""

    def __init__(self, in_features, features, config_str="batchnorm-relu"):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self._build_stack(features, config_str)

    def forward(self, x):
        return self._run_stack(self.Dense_0(x))


def avg_pool_exclusive(x, window, stride, padding):
    """2-D average pool of NCHW input whose divisor excludes the padding,
    paddle's ``AvgPool2D(exclusive=True)`` (JAX ``layers.py:118-134``)."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=False)
