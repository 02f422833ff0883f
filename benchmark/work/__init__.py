"""Frozen counts of the work the port's functions do, and the card's
published peaks (NVIDIA H100 SXM data sheet, dense rates).

Every count is the function's work over the valid part of each
utterance, not a design's: a padded frame needs none, an input byte is
read once and an output byte written once. A roofline bound is the larger
of operations over the peak of the precision the function computes in and
bytes over the HBM3 bandwidth."""

import math

import numpy as np

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12

SAMPLE_RATE, FRAME_LEN, SHIFT, N_FFT, N_MELS = 16000, 400, 160, 512, 80
FCM_DIM = 320


def bound_s(flops, peak, nbytes):
    """The least seconds for ``flops`` at ``peak`` FLOP/s moving ``nbytes``."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def num_frames(num_samples):
    return 0 if num_samples < FRAME_LEN else 1 + (num_samples - FRAME_LEN) // SHIFT


def valid_frames(lengths, padded):
    """Per clip of ``lengths`` samples padded to ``padded``: the frames the
    CMN keeps, ``int(float32(len / padded) * T)``."""
    t = num_frames(padded)
    r = np.asarray(lengths, np.float64) / padded
    return (r.astype(np.float32) * np.float32(t)).astype(np.int64)


def trunk_rows(lengths, padded):
    """Valid trunk rows ``ceil(float32(len / padded) * t_valid)``."""
    t_valid = (num_frames(padded) - 1) // 2 + 1
    r = (np.asarray(lengths, np.float64) / padded).astype(np.float32)
    return np.clip(np.ceil(r * np.float32(t_valid)).astype(np.int64), 1, t_valid)


def _mel_nonzero():
    from ..reference.fbank import mel_banks
    return int((mel_banks(N_MELS) != 0).sum())


MEL_NONZERO = _mel_nonzero()


def fbank_flops_per_frame(mel_nonzero=MEL_NONZERO):
    """DC removal, pre-emphasis and window (4 a sample), a 512-point FFT
    (2.5 N log2 N), the power of 256 bins and the mel weights."""
    return (4 * FRAME_LEN + 2.5 * N_FFT * math.log2(N_FFT) + 3 * (N_FFT // 2)
            + 2 * mel_nonzero)


def fbank_work(lengths):
    """(flops, bytes) of the fp32 fbank over clips of ``lengths`` samples."""
    frames = sum(num_frames(int(n)) for n in lengths)
    return (frames * fbank_flops_per_frame(),
            4 * int(np.sum(lengths)) + 4 * N_MELS * frames)


# FCM convs: (output frequencies, K per output: 9 * cin, plus 32 for a
# 1x1 shortcut summed into it), 32 output channels each
FCM_CONVS = ((80, 9), (40, 288), (40, 288 + 32), (40, 288), (40, 288),
             (20, 288), (20, 288 + 32), (20, 288), (20, 288), (10, 288))
FCM_FLOPS_PER_FRAME = 2 * 32 * sum(f * k for f, k in FCM_CONVS)


def fcm_work(frames):
    """(flops, bytes) of the FCM over ``frames`` valid frames per clip:
    fp32 features in, bf16 (B, T, 320) out."""
    n = int(np.sum(frames))
    return n * FCM_FLOPS_PER_FRAME, n * (4 * N_MELS + 2 * FCM_DIM)


def trunk_plan():
    """Input widths of the 52 CAM layers and each dense block's (in, out,
    transit) widths of the stock CAM++ trunk."""
    c, cins, blocks = 128, [], []
    for n in (12, 24, 16):
        cins += [c + i * 32 for i in range(n)]
        blocks.append((c, c + 32 * n, (c + 32 * n) // 2))
        c = (c + 32 * n) // 2
    return cins, blocks


def trunk_macs_per_row():
    """The stem (k5 over 320), the 52 bottlenecks (cin x 128) and k3
    local convs (3 x 128 x 32), and the 3 transits, per trunk row."""
    cins, blocks = trunk_plan()
    return (5 * FCM_DIM * 128 + 128 * sum(cins) + len(cins) * 3 * 128 * 32
            + sum(out * tr for _, out, tr in blocks))


TRUNK_WEIGHT_BYTES = 2 * (5 * FCM_DIM * 128 + 128 * sum(trunk_plan()[0])
                          + 52 * (3 * 128 * 32 + 128 * 64 + 64 * 32)
                          + sum(o * t for _, o, t in trunk_plan()[1]))


def cam_gate_flops(rows):
    """The 52 CAM gate MLPs (128 -> 64 -> 32), once per 100-row segment."""
    return 52 * 2 * (128 * 64 + 64 * 32) * -(-int(rows) // 100)


def trunk_work(rows):
    """(flops, bytes) of the trunk over ``rows`` valid rows per clip: its
    input rows (2 FCM frames a row, bf16), the weights once, the fp32
    statistics out."""
    rows = np.asarray(rows, np.int64)
    flops = 2 * trunk_macs_per_row() * int(rows.sum())
    nbytes = (int(rows.sum()) * 2 * FCM_DIM * 2 + TRUNK_WEIGHT_BYTES
              + len(rows) * 1024 * 4)
    return flops, nbytes


def campplus_flops(frames, rows):
    """The whole CAM++ forward of one clip: FCM, trunk, CAM gates, head."""
    return (FCM_FLOPS_PER_FRAME * int(frames) + 2 * trunk_macs_per_row() * int(rows)
            + cam_gate_flops(rows) + 2 * 1024 * 192)


def eres2net_flops(frames):
    """The whole ERes2Net (m_channels 32, embedding 192) forward of one
    clip of ``frames`` frames: convs at full, 1/2, 1/4 and 1/8 time
    resolution, and the constant head (counted from the reference's
    layers' output shapes)."""
    t = int(frames)
    return (4387840 * t + 18350080 * -(-t // 2) + 48578560 * -(-t // 4)
            + 62996480 * -(-t // 8) + 3932160)

