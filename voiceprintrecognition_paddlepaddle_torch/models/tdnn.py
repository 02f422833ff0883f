"""x-vector TDNN backbone (counterpart of the JAX ``models/tdnn.py``).

Five dilated VALID temporal convs (ReLU then BN after layers 1-4, ReLU
only after layer 5), a pooling with BN, then Linear -> BN to the
embedding. Takes ``(B, T, F)``, runs ``(B, C, T)`` inside. The length
ratios apply to the shortened T, as in JAX.
"""

import torch
from torch import nn

from .layers import BatchNorm1d
from .pooling import POOLING_DIM_FACTOR, POOLINGS

__all__ = ["TDNN"]

_CONVS = ((5, 1), (3, 2), (3, 3), (1, 1), (1, 1))   # (kernel, dilation)


class TDNN(nn.Module):
    def __init__(self, input_size, channels=512, embd_dim=192,
                 pooling_type="ASP"):
        super().__init__()
        if pooling_type not in POOLING_DIM_FACTOR:
            raise ValueError(f"no pooling layer {pooling_type}")
        for i, (k, d) in enumerate(_CONVS):
            setattr(self, f"Conv_{i}", nn.Conv1d(
                input_size if i == 0 else channels, channels, k, dilation=d))
        for i in range(4):
            setattr(self, f"BatchNorm1d_{i}", BatchNorm1d(channels))
        pool = POOLINGS[pooling_type]
        self._pool = f"{pool.__name__}_0"
        setattr(self, self._pool, pool(channels))
        out = channels * POOLING_DIM_FACTOR[pooling_type]
        self.BatchNorm1d_4 = BatchNorm1d(out)
        self.Dense_0 = nn.Linear(out, embd_dim)
        self.BatchNorm1d_5 = BatchNorm1d(embd_dim)

    def forward(self, x, lengths=None):
        x = x.transpose(1, 2)
        for i in range(4):
            x = getattr(self, f"BatchNorm1d_{i}")(
                torch.relu(getattr(self, f"Conv_{i}")(x)))
        x = torch.relu(self.Conv_4(x))
        out = getattr(self, self._pool)(x.transpose(1, 2), lengths)
        out = self.Dense_0(self.BatchNorm1d_4(out))
        return self.BatchNorm1d_5(out)
