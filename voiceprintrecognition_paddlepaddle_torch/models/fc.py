"""Speaker classifier head (counterpart of the JAX ``models/fc.py``).

Optional DenseBN blocks, then a Cosine head, ``normalize(x) @
normalize(W, axis=0)`` in fp32 with ``weight`` of shape
``(in_dim, num_speakers * K)`` (K sub-centers), or a Linear head. Returns
``{"features", "logits"}``. Serving does not call it; a whole converted
checkpoint loads into it, and the trainer trains it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import DenseBN

__all__ = ["SpeakerIdentification"]


class SpeakerIdentification(nn.Module):
    def __init__(self, input_dim, num_speakers, classifier_type="Cosine", K=1,
                 num_blocks=0, inter_dim=512):
        super().__init__()
        self.num_blocks = num_blocks
        self.classifier_type = classifier_type
        dim = input_dim
        for i in range(num_blocks):
            setattr(self, f"DenseBN_{i}", DenseBN(dim, inter_dim, "batchnorm"))
            dim = inter_dim
        if classifier_type == "Cosine":
            w = torch.empty(dim, num_speakers * K)
            nn.init.xavier_uniform_(w)
            self.weight = nn.Parameter(w)
        elif classifier_type == "Linear":
            self.Dense_0 = nn.Linear(dim, num_speakers)
        else:
            raise ValueError(f"unsupported classifier: {classifier_type}")

    def forward(self, features):
        x = features
        for i in range(self.num_blocks):
            x = getattr(self, f"DenseBN_{i}")(x)
        if self.classifier_type == "Cosine":
            # fp32 logits (or wider): the margin losses derive sin(theta)
            # from sqrt(1 - cos^2)
            dtype = torch.promote_types(x.dtype, torch.float32)
            x_n = F.normalize(x.to(dtype), dim=-1, eps=1e-12)
            w_n = F.normalize(self.weight.to(dtype), dim=0, eps=1e-12)
            logits = x_n @ w_n
        else:
            logits = self.Dense_0(x)
        return {"features": features, "logits": logits}
