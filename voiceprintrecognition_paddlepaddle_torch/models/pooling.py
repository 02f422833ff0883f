"""Length-aware temporal statistics (counterpart of ``masked_mean_var`` in
the JAX ``models/pooling.py``)."""

import torch

__all__ = ["masked_mean_var"]


def masked_mean_var(x, lengths, ddof=0):
    """Mean / variance over the valid frames of ``(B, T, C)``.

    ``lengths`` holds per-utterance valid fractions; frame ``t`` is valid
    when ``t < ratio * T``, i.e. ``ceil(ratio * T)`` frames. ``None`` means
    every frame is valid."""
    if lengths is None:
        return x.mean(dim=1), x.var(dim=1, correction=ddof)
    t = x.shape[1]
    ratio = torch.as_tensor(lengths, dtype=torch.float32, device=x.device)
    mask = (torch.arange(t, device=x.device)[None, :]
            < ratio[:, None] * t).to(x.dtype)[:, :, None]
    n = torch.clamp(mask.sum(dim=1), min=1.0)
    mean = (x * mask).sum(dim=1) / n
    var = (((x - mean[:, None, :]) ** 2) * mask).sum(dim=1) / \
        torch.clamp(n - ddof, min=1.0)
    return mean, var
