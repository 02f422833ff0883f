"""Speaker-verification metrics: FNR/FPR curves, EER, MinDCF (a copy of
the JAX package's ``metric/metrics.py``).

Numerically matches reference ``ppvector/metric/metrics.py:4-37`` — the
published EER/MinDCF numbers depend on this exact interpolation — while the
curve construction itself is pure cumulative-sum numpy.
"""

import numpy as np

__all__ = ["compute_fnr_fpr", "compute_eer", "compute_dcf"]


def compute_fnr_fpr(scores, labels, weights=None):
    """Sorted cumulative-weight FNR/FPR curves over score thresholds.

    Semantics of reference ``metric/metrics.py:4-19``: sort by score
    ascending; FNR(t) = weighted fraction of targets with score <= t;
    FPR(t) = weighted fraction of impostors with score > t.
    """
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    order = np.argsort(scores)
    thresholds = scores[order]
    labels = labels[order]
    if weights is None:
        weights = np.ones(labels.shape, dtype="f8")
    else:
        weights = np.asarray(weights)[order]

    tgt = weights * (labels == 1).astype("f8")
    imp = weights * (labels == 0).astype("f8")

    tgt_total, imp_total = np.sum(tgt), np.sum(imp)
    if tgt_total == 0 or imp_total == 0:
        # one-sided trial set: the curves would be 0/0 = NaN everywhere
        # and compute_eer would raise a bare IndexError downstream
        raise ValueError(
            "FNR/FPR are undefined: the trials must contain both target "
            "(same-speaker) and non-target pairs "
            f"(got {int(np.sum(labels == 1))} target / "
            f"{int(np.sum(labels == 0))} non-target).")
    fnr = np.cumsum(tgt) / tgt_total
    fpr = 1 - np.cumsum(imp) / imp_total
    return fnr, fpr, thresholds


def compute_eer(fnr, fpr, scores=None):
    """Equal error rate by linear interpolation at the FNR=FPR crossing.

    Reference ``metric/metrics.py:22-31``; when ``scores`` is given, also
    returns the operating threshold at the crossing index.
    """
    diff = fnr - fpr
    pos, neg = np.flatnonzero(diff >= 0), np.flatnonzero(diff < 0)
    if pos.size == 0 or neg.size == 0:
        # degenerate trial set: the FNR/FPR curves never cross, which
        # happens when the trials contain no target (or no non-target)
        # pairs, or all scores tie — EER is undefined there
        raise ValueError(
            "EER is undefined: FNR and FPR never cross. The trials list "
            "must contain both target (same-speaker) and non-target "
            "pairs with distinct scores.")
    x1 = pos[0]
    x2 = neg[-1]
    a = (fnr[x1] - fpr[x1]) / (fpr[x2] - fpr[x1] - (fnr[x2] - fnr[x1]))
    eer = fnr[x1] + a * (fnr[x2] - fnr[x1])
    if scores is not None:
        return eer, np.sort(scores)[x1]
    return eer


def compute_dcf(fnr, fpr, p_target=0.01, c_miss=1, c_fa=1):
    """Normalized minimum detection cost (reference ``metric/metrics.py:34-37``)."""
    c_det = np.min(c_miss * fnr * p_target + c_fa * fpr * (1 - p_target))
    c_def = min(c_miss * p_target, c_fa * (1 - p_target))
    return c_det / c_def
