"""Operand rounding of the reference's products.

``fp32`` leaves the products alone (the reference runs with TF32 off).
``bf16`` and ``fp8`` are the controls: every conv and linear product
takes its operands rounded to that format (fp8: e4m3 with one scale per
tensor, its largest value at 448) and stores its output in bf16, as a
lower-precision port would."""

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

FORMATS = ("fp32", "bf16", "fp8")
FP8_MAX = 448.0
_mode = ["fp32"]


@contextlib.contextmanager
def precision(fmt):
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}")
    old = _mode[0]
    _mode[0] = fmt
    try:
        yield
    finally:
        _mode[0] = old


@contextlib.contextmanager
def no_tf32():
    """cuBLAS and cuDNN in full fp32 for the block: the reference's
    products are never TF32, whatever the process had set."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def operand(x):
    fmt = _mode[0]
    if fmt == "fp32":
        return x
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def output(y):
    return y if _mode[0] == "fp32" else y.to(torch.bfloat16).to(y.dtype)


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return output(self._conv_forward(operand(x), operand(self.weight),
                                         self.bias))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return output(self._conv_forward(operand(x), operand(self.weight),
                                         self.bias))


class Linear(nn.Linear):
    def forward(self, x):
        return output(F.linear(operand(x), operand(self.weight), self.bias))


class BatchNorm(nn.Module):
    """BatchNorm over axis 1 of an NC* tensor, keys as ``nn.BatchNorm1d``:
    batch statistics in train mode (the running ones are not kept; the
    reference never reads them after training), running ones in eval."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        return F.batch_norm(x, None if self.training else self.running_mean,
                            None if self.training else self.running_var,
                            self.weight, self.bias, self.training, 0.0,
                            self.eps)
