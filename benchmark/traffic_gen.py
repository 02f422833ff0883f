"""The one generator of inputs: clips whose lengths and content follow a
traffic file's parameters and the seed.

Lengths are the same stratified set for every seed (``n`` points evenly
inside ``clip_seconds``), in an order the seed draws, so that every seed
gives the same work in another order. Content is made on the device by a
``torch.Generator`` seeded from the seed: noise under a slow amplitude
envelope plus three tones, each clip at ``level_db`` dBFS RMS over its
length and zero past it."""

import math

import numpy as np
import torch


def lengths(traffic, n, seed):
    lo, hi = traffic["clip_seconds"]
    sr = traffic.get("sample_rate", 16000)
    grid = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    out = np.round(grid * sr).astype(np.int64)
    return out[np.random.default_rng([seed, 1]).permutation(n)]


def waves(lens, padded, seed, device, level_db=-20.0, sr=16000, chunk=512):
    """``(len(lens), padded)`` float32 clips on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63) ^ 0x5EED)
    out = torch.zeros((len(lens), padded), dtype=torch.float32, device=device)
    t = torch.arange(padded, device=device, dtype=torch.float32) / sr
    target = 10.0 ** (level_db / 20.0)
    for i in range(0, len(lens), chunk):
        n = min(chunk, len(lens) - i)
        u = torch.rand((n, 8), generator=gen, device=device)
        env = 0.6 + 0.4 * torch.sin(2 * math.pi * (2 + 4 * u[:, :1]) * t
                                    + 2 * math.pi * u[:, 1:2])
        x = torch.randn((n, padded), generator=gen, device=device) * env
        for k in range(3):
            f = 100 + 2900 * u[:, 2 + k:3 + k]
            x = x + (1.0 + 2.0 * u[:, 5 + k:6 + k]) * torch.sin(2 * math.pi * f * t)
        ln = torch.as_tensor(np.asarray(lens[i:i + n]), device=device)
        valid = (torch.arange(padded, device=device)[None] < ln[:, None]).float()
        x = x * valid
        rms = torch.sqrt((x * x).sum(1) / ln.float())
        out[i:i + n] = x * (target / rms)[:, None]
    return out
