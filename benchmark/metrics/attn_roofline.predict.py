"""The MFA-Conformer's fused attention's share of its roofline: the TF32
bound of every traced batch's valid attention work
(``work.conformer.attention_work``) over the device time of the fused
attention kernel (PyTorch's memory-efficient SDPA kernel,
``fmha_cutlassF``) in the traced window."""

from benchmark.metrics._roofline import share
from benchmark.work.conformer import attention_work


def read(reading):
    return share(reading, "fmha_cutlassF", attention_work, "tf32")
