"""Frozen counts of the MFA-Conformer's fused attention at the published
widths: the reference's ``attention_flops`` (the scores ``Q' K'^T`` with
``Q' = [q + u | q + v]`` and ``K' = [k | p]``, head dimension 128, and the
weighted sum with ``V``, 64) over the valid positions of each clip alone,
as ``work`` counts every function."""

import numpy as np

from . import num_frames
from ..reference.mfa_conformer import BLOCKS, D, HEADS, attention_flops, positions


def valid_positions(lengths, padded):
    """The positions the port's key mask keeps per clip of ``lengths``
    samples: ``ceil(float32(len / padded) * T')``."""
    t = positions(num_frames(padded))
    r = (np.asarray(lengths, np.float64) / padded).astype(np.float32)
    return np.clip(np.ceil(r * np.float32(t)).astype(np.int64), 1, t)


def attention_work(lengths, padded):
    """(flops, bytes) of the attention of one batch: ``attention_flops``
    over each clip's valid positions, and ``Q'``, ``K'`` (``2 d_k`` each),
    ``V`` and the output (``d_k`` each) read or written once, in
    float32."""
    n = valid_positions(lengths, padded)
    nbytes = BLOCKS * HEADS * 4 * 6 * (D // HEADS) * int(n.sum())
    return sum(attention_flops(int(x)) for x in n), nbytes
