"""Diarization scoring: RTTM I/O + Diarization Error Rate (copy of the JAX
package's ``infer_utils/der.py``).

Self-contained replacement for the ``pyannote.metrics`` dependency used by
the reference's eval tools (reference
``tools/eval_speaker_diarization/compute_metrics.py:1-21``): loads RTTM
annotations, finds the optimal one-to-one reference↔hypothesis speaker
mapping (Hungarian assignment on pairwise overlap durations), and reports
the standard components — missed detection, false alarm, speaker confusion
— and their sum as DER, all as times normalised by total reference speech
time (pyannote's detailed-result convention, no collar).
"""

from collections import defaultdict

import numpy as np
from scipy.optimize import linear_sum_assignment

__all__ = ["load_rttm", "write_rttm", "diarization_error_rate"]


def load_rttm(path):
    """Parse an RTTM file → {uri: [(start, end, speaker), ...]}."""
    annotations = defaultdict(list)
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            uri, start, dur, label = (parts[1], float(parts[3]),
                                      float(parts[4]), parts[7])
            annotations[uri].append((start, start + dur, label))
    return dict(annotations)


def write_rttm(f, uri, segments):
    """``segments``: iterable of {speaker, start, end} dicts."""
    for seg in segments:
        dur = seg["end"] - seg["start"]
        f.write(f"SPEAKER {uri} 1 {seg['start']:.3f} {dur:.3f} "
                f"<NA> <NA> {seg['speaker']} <NA> <NA>\n")


def _intervals(ref, hyp):
    """Cut the time axis at every boundary; yield (duration,
    ref_speaker_set, hyp_speaker_set) per elementary interval."""
    points = sorted({t for s, e, _ in ref + hyp for t in (s, e)})
    for a, b in zip(points, points[1:]):
        if b - a <= 0:
            continue
        mid = (a + b) / 2
        r = {spk for s, e, spk in ref if s <= mid < e}
        h = {spk for s, e, spk in hyp if s <= mid < e}
        yield b - a, r, h


def diarization_error_rate(reference, hypothesis, detailed=False):
    """``reference`` / ``hypothesis``: [(start, end, speaker), ...].

    Returns DER (or a detailed dict with pyannote-compatible keys)."""
    ref_spks = sorted({s for _, _, s in reference})
    hyp_spks = sorted({s for _, _, s in hypothesis})

    # overlap matrix for the optimal speaker mapping
    overlap = np.zeros((len(ref_spks), len(hyp_spks)))
    r_idx = {s: i for i, s in enumerate(ref_spks)}
    h_idx = {s: i for i, s in enumerate(hyp_spks)}
    for dur, r, h in _intervals(reference, hypothesis):
        for rs in r:
            for hs in h:
                overlap[r_idx[rs], h_idx[hs]] += dur
    if overlap.size:
        rows, cols = linear_sum_assignment(-overlap)
        mapping = {ref_spks[i]: hyp_spks[j] for i, j in zip(rows, cols)}
    else:
        mapping = {}

    total = miss = fa = conf = 0.0
    for dur, r, h in _intervals(reference, hypothesis):
        total += dur * len(r)
        miss += dur * max(0, len(r) - len(h))
        fa += dur * max(0, len(h) - len(r))
        matched = sum(1 for rs in r if mapping.get(rs) in h)
        conf += dur * (min(len(r), len(h)) - matched)

    total = max(total, 1e-12)
    der = (miss + fa + conf) / total
    if detailed:
        return {"diarization error rate": der,
                "false alarm": fa / total,
                "missed detection": miss / total,
                "confusion": conf / total,
                "total": total}
    return der
