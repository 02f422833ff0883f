#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device   the card's name and power limit (nvidia-smi); no CUDA -> fail
2. build    nvcc builds csrc/*.cu for sm_90a (one process per source, all
            at once); prints time and ptxas output
3. fbank    the fbank kernel against its plain version, b256 x 3 s; then
            on hard inputs (1e-4 noise, a tone then digital silence, a
            1e-3 tone on a 0.5 DC offset, rows of 48123 and 401 samples)
            against a float64 run of kaldi's steps (``fbank_steps``)
4. fcm      the FCM kernel against its plain version (both bf16) at full
            CAM++ width: b8 x 298 and b8 x 297 frames (where the JAX
            package's single-pass kernel runs), b4 x 1598 (the 16 s
            bucket) and b2 x 3198 (the 32 s bucket, where it runs the
            chunked kernel)
5. trunk    the trunk kernel against its plain version (both bf16), full
            CAM++ width with random weights and BN statistics from a seed,
            converted from the flax layout by models/convert.py:
            b256 x 298 frames, 3 x 798 frames, 1598 and 3198 frames exact
            and ragged, and ragged padded 8 s and 32 s batches held row by
            row against their exact-length embeddings; then every cluster
            size the kernel allows (R <= 400 rows per block) at b1 x 398
            frames with ratio 0.75 (one /embedding), b2 x 3198 (ragged)
            and b32 x 1598
6. main     Predictor(device="cuda"): register / recognition / contrast
            over the demo wavs, predict_batch over 64 seeded 1-8 s clips
            and 8 seeded 9-30 s clips (the 32 s bucket), a 15 s clip (the
            16 s bucket), and a 33 s clip that runs the plain
            model; every kernel's launch counter must rise, and 1-8 s,
            16 s and 32 s embeddings are held against the eager fp32 model
7. times    CUDA-event times of each kernel against its plain version and
            whole-embed utt/s at b256 x 3 s (bench.py's embed workload)
            and b32 x 16 s; the fbank kernel also at b32 x 16 s and b1 x
            64000 (one /embedding), each beside ``cufft_ms`` (kaldi's steps
            as library calls with cuFFT, fp32) and its device time from a
            CUDA-graph replay (at b1 the events time the host's launches);
            the FCM kernel also against the model's plain
            FCM (cuDNN), there and at b1 x 398 and b64 x 398 (below
            FCM_MIN_T), with the ms of each of its launches beside the
            bytes the design moves (GB/s, TFLOP/s, the byte floor); the
            stages of the b32 x 16 s embed; the trunk
            at b256 x 298, b64 x 398, b1 x 398 and b32 x 1598 frames with
            its default cluster split against the smallest cluster that
            shape allows, in turns; every cluster size at the serving and
            bucket shapes, and the resident clusters of every split the
            rule may take; each kernel's bound (bytes or operations over
            the H100's published peaks)
8. serve    the serving surface on the card: speaker_diarization of
            dataset/test_long.wav (28.8 s; 1.5 s chunks padded to the 2 s
            bucket, the masked path) without an oracle count, with
            speaker_num=2 and against the audio db, each chunk embedding
            held against the eager fp32 model at exact length; a CAM++ at
            init_channels 32, which takes the plain model and launches no
            FCM or trunk kernel; two in-process HTTP servers (serve.py's
            make_handler, one plain and one with a MicroBatcher), every
            endpoint, 64 concurrent /embedding requests held against a
            main-thread embed; then /embedding P50/P99 latency over 100
            serial requests, micro-batched requests/s with 64 clients
            over 512 requests, the diarization wall time, and where one
            request's time goes (HTTP, decode, the b1 and b64 embed stages)
9. backbones the six other configs (tdnn, ecapa_tdnn, res2net, resnet_se,
            eres2net, eres2netv2) at full width with random weights from a
            seed: Predictor(device="cuda") over 32 seeded 1-8 s clips in
            chunks of 8 (ragged, padded to their buckets), the fbank
            kernel's launches rising by the chunks and the FCM and trunk
            kernels' not moving, every embedding held against
            Predictor(device="cpu") on the same clips; padded against
            exact-length cos printed without a bar; the whole embed at b64 x
            3 s timed (featurize, model); then the four other feature
            methods and two non-stock Fbank settings on the card against
            the CPU

The last line is ``{"ok": true, "device": {...}}``; the line before it
is a JSON object with one entry per kernel.
"""

import json
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# configs/cam++.yml, whole (kept as a dict: the GPU host has no PyYAML)
CONFIG = {
    "dataset_conf": {
        "dataset": {"min_duration": 0.3, "max_duration": 3,
                    "sample_rate": 16000, "use_dB_normalization": True,
                    "target_dB": -20},
        "sampler": {"batch_size": 64, "shuffle": True, "drop_last": True},
        "dataLoader": {"num_workers": 8},
        "eval_conf": {"batch_size": 8, "max_duration": 20},
        "train_list": "dataset/train_list.txt",
        "enroll_list": "dataset/cn-celeb-test/enroll_list.txt",
        "trials_list": "dataset/cn-celeb-test/trials_list.txt",
        "is_use_pksampler": False,
        "sample_per_id": 4,
    },
    "preprocess_conf": {"feature_method": "Fbank",
                        "method_args": {"sr": 16000, "n_mels": 80}},
    "model_conf": {"model": "CAMPPlus", "model_args": {"embd_dim": 192},
                   "classifier": {"classifier_type": "Cosine",
                                  "num_speakers": 2796, "num_blocks": 0}},
    "loss_conf": {"loss": "AAMLoss",
                  "loss_args": {"margin": 0.2, "scale": 32,
                                "easy_margin": False, "label_smoothing": 0.0},
                  "use_margin_scheduler": True,
                  "margin_scheduler_args": {"initial_margin": 0.0,
                                            "final_margin": 0.3}},
    "optimizer_conf": {"optimizer": "Adam",
                       "optimizer_args": {"weight_decay": 1.0e-06},
                       "scheduler": "WarmupCosineSchedulerLR",
                       "scheduler_args": {"learning_rate": 0.001,
                                          "min_lr": 1.0e-05,
                                          "warmup_epoch": 5}},
    "train_conf": {"enable_amp": False, "max_epoch": 60, "log_interval": 10},
}

# model_conf of the six other configs/*.yml (kept as dicts, as CONFIG)
_HEAD = {"classifier_type": "Cosine", "num_speakers": 2796, "num_blocks": 0}
BACKBONE_CONFS = {
    "tdnn": {"model": "TDNN", "model_args": {
        "embd_dim": 192, "channels": 512, "pooling_type": "ASP"},
        "classifier": _HEAD},
    "ecapa_tdnn": {"model": "EcapaTdnn", "model_args": {
        "embd_dim": 192, "pooling_type": "ASP",
        "channels": [512, 512, 512, 512, 1536]}, "classifier": _HEAD},
    "res2net": {"model": "Res2Net", "model_args": {
        "embd_dim": 192, "pooling_type": "ASP", "m_channels": 32},
        "classifier": _HEAD},
    "resnet_se": {"model": "ResNetSE", "model_args": {
        "embd_dim": 192, "pooling_type": "ASP"}, "classifier": _HEAD},
    "eres2net": {"model": "ERes2Net", "model_args": {
        "embd_dim": 192, "m_channels": 32}, "classifier": _HEAD},
    "eres2netv2": {"model": "ERes2NetV2", "model_args": {
        "embd_dim": 192, "m_channels": 32}, "classifier": _HEAD},
}

FBANK_SRC = "voiceprintrecognition_paddlepaddle_torch/csrc/fbank.cu"
TRUNK_SRC = "voiceprintrecognition_paddlepaddle_torch/csrc/campplus_trunk.cu"
FCM_SRC = "voiceprintrecognition_paddlepaddle_torch/csrc/fcm.cu"
FBANK_TPU = "voiceprintrecognition_paddlepaddle_tpu/ops/pallas_fbank.py:79"
TRUNK_TPU = ("voiceprintrecognition_paddlepaddle_tpu/models/"
             "pallas_campplus.py:317")
TRUNK_TPU_LOOPED = ("voiceprintrecognition_paddlepaddle_tpu/models/"
                    "pallas_campplus.py:458")
FCM_TPU = "voiceprintrecognition_paddlepaddle_tpu/models/pallas_fcm.py:251"
FCM_TPU_CHUNKED = "voiceprintrecognition_paddlepaddle_tpu/models/pallas_fcm.py:442"

# published H100 SXM peaks (dense): bf16 and TF32 tensor cores, fp32
# outside the tensor cores, HBM3 bytes/s
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound(flops, peak, nbytes):
    """The least time for work of ``flops`` at ``peak`` FLOP/s that must
    move ``nbytes``: {"bound_ms", "bound_by": "operations" or "bytes",
    "work_gflop"}."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "work_gflop": flops / 1e9}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def fbank_flops_per_frame(mel_nonzero, frame_len=400, n_fft=512):
    """The least fp32 work of one Fbank frame: DC removal, pre-emphasis
    and window (4 per sample), a 512-point FFT (2.5 N log2 N, the usual
    count for a radix-2 FFT; a real FFT needs about half), the power of
    256 bins and the mel filters' nonzero weights (a multiply-add each).
    The kernel does a folded DFT as a product, about 30 times this."""
    return (4 * frame_len + 2.5 * n_fft * math.log2(n_fft) + 3 * (n_fft // 2)
            + 2 * mel_nonzero)


def fbank_bound(fk, waves, n_mels=80):
    """Bound of one fbank call on ``waves`` (B, L): fp32 FFTs per frame,
    the waveform read once and the log-mel written once."""
    mel = fk.fbank_tables(16000, n_mels, waves.device).mel
    n_frames = waves.shape[0] * (1 + (waves.shape[1] - 400) // 160)
    return bound(n_frames * fbank_flops_per_frame(int((mel != 0).sum())),
                 PEAK_FP32, nbytes(waves) + n_frames * n_mels * 4)


def fbank_steps(fk, waves, n_mels=80, dtype=torch.float64):
    """Kaldi's fbank as a composition of library calls in ``dtype``:
    unfold, DC removal, pre-emphasis, povey window, ``torch.fft.rfft``
    (cuFFT on the card), power, mel matmul, log. In float64 it is the
    reference the fbank kernel is held to on hard inputs; in float32 its
    time is ``cufft_ms``, a yardstick. The port never calls it."""
    tables = fk.fbank_tables(16000, n_mels, waves.device)
    x = waves.to(dtype)
    t = 1 + (x.shape[1] - 400) // 160
    frames = x[:, :(t - 1) * 160 + 400].unfold(-1, 400, 160)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - 0.97 * prev) * tables.window.to(dtype)
    spec = torch.fft.rfft(frames, n=512)[..., :256]   # Nyquist: weight 0
    power = spec.real ** 2 + spec.imag ** 2
    return torch.log(torch.clamp(power @ tables.mel.to(dtype),
                                 min=float(np.finfo(np.float32).eps)))


def tone(n):
    """A 1 kHz sine of amplitude 1, ``n`` samples at 16 kHz (float64)."""
    return np.sin(2 * np.pi * 1000.0 * (np.arange(n) / 16000.0))


def tone_then_silence(n):
    """(1, n) float32: the 1 kHz tone at 0.5 for the first half, then
    digital silence."""
    return np.where(np.arange(n) < n // 2, 0.5 * tone(n),
                    0.0)[None].astype(np.float32)


def hard_waves(rng):
    """{name: (B, L) float32}: inputs hard for an fp32 fbank (low energy,
    digital silence, a weak tone on a DC offset) and rows that do not
    start on 16 bytes (L % 4 != 0)."""
    waves = {"1e-4 noise": rng.randn(4, 48000) * 1e-4,
             "1 kHz tone, then 1.5 s of silence": tone_then_silence(48000),
             "1e-3 tone on a 0.5 DC offset": (0.5 + 1e-3 * tone(48000))[None],
             "noise, 48123 samples": rng.randn(3, 48123) * 0.1,
             "noise, 401 samples": rng.randn(5, 401) * 0.1}
    return {k: v.astype(np.float32) for k, v in waves.items()}


def check_fbank_hard(fk, dev, rng):
    """Phase 3, hard inputs: the kernel against a float64 run of kaldi's
    steps, bars max |d| < 2e-2 and p99 <= max(1e-3, 2 x the plain
    version's p99 against the same run). Returns the largest max |d|."""
    worst = 0.0
    for name, w in hard_waves(rng).items():
        x = torch.from_numpy(w).to(dev)
        exact = fbank_steps(fk, x)
        got = fk.fbank_fused(x)
        plain = fk.fbank_fused_reference(x)
        torch.cuda.synchronize()
        d = (got.double() - exact).abs().flatten()
        dp = (plain.double() - exact).abs().flatten()
        p99, p99_plain = (float(torch.quantile(v, 0.99)) for v in (d, dp))
        bar = max(1e-3, 2 * p99_plain)
        log(f"[fbank] {name} {tuple(w.shape)}: kernel vs float64 max|d|="
            f"{float(d.max()):.3e} p99={p99:.3e}; plain version vs float64 "
            f"max|d|={float(dp.max()):.3e} p99={p99_plain:.3e} (bars 2e-2, "
            f"p99 <= {bar:.3e})")
        if not (got.shape == exact.shape and float(d.max()) < 2e-2
                and p99 <= bar):
            raise AssertionError(f"fbank kernel misses its bars ({name})")
        worst = max(worst, float(d.max()))
    return worst


def fbank_times(fk, shapes, card):
    """Phase 7, the fbank: for each of ``shapes`` ({name: (B, L) waves})
    the kernel against its plain version in turns, ``cufft_ms``
    (``fbank_steps`` in fp32, twice) and the kernel's device time from a
    graph replay (``graph_ms``, twice)."""
    out = {}
    for name, w in shapes.items():
        iters = 200 if w.shape[0] == 1 else 20
        k, p = turns(lambda: fk.fbank_fused_reference(w),
                     lambda: fk.fbank_fused(w), iters)
        c = [cuda_ms(lambda: fbank_steps(fk, w, dtype=torch.float32), iters)
             for _ in range(2)]
        g = [graph_ms(lambda: fk.fbank_fused(w)) for _ in range(2)]
        out[name] = {"ms": k, "plain_ms": p, "cufft_ms": c, "graph_ms": g,
                     **fbank_bound(fk, w)}
        log(f"[times] {card}: fbank {name} kernel {k} ms (graph replay {g} "
            f"ms), plain version {p} ms, cuFFT composition {c} ms; bound "
            f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']})")
    return out


def resident_table(tk, index):
    """``{cs: {R: clusters}}``: how many clusters of ``cs`` blocks of R
    rows the card holds at once (cudaOccupancyMaxActiveClusters), for
    every split ``trunk_split`` may take (t16 from 64 to 1600 rows, t_valid
    at both ends of each t16, which changes the segment arrays). Raises
    if the two ends of a t16 disagree, since ``trunk_split`` keys the count
    by (cs, R) alone."""
    table = {}
    for t16 in range(64, tk.MAX_T16 + 1, 16):
        for cs in tk.CLUSTER_SIZES:
            rows = tk.rows_per_block(t16, cs)
            if rows > tk.SMEM_MAX_T16 or (cs > smallest_cluster(tk, t16)
                                          and rows < 32):
                continue
            got = {tk._max_clusters(cs, rows, t_valid, index)
                   for t_valid in (t16 - 15, t16)}
            table.setdefault(cs, {}).setdefault(rows, set()).update(got)
    out = {cs: {r: sorted(n) for r, n in sorted(row.items())}
           for cs, row in sorted(table.items())}
    if any(len(n) > 1 for row in out.values() for n in row.values()):
        raise AssertionError(f"resident clusters depend on t_valid: {out}")
    return {cs: {r: n[0] for r, n in row.items()} for cs, row in out.items()}


def trunk_macs_per_row(tk):
    """Multiply-adds of one trunk row: stem, 52 bottlenecks and local
    convs, 3 transits (the CAM gate MLP is per segment, not per row)."""
    plan = tk.trunk_plan()
    return (5 * 320 * plan["init_channels"] + plan["lin1_rows"] * plan["bn_ch"]
            + plan["n_layers"] * 3 * plan["bn_ch"] * plan["growth"]
            + sum(bl["c_out"] * bl["c_transit"] for bl in plan["blocks"]))


def trunk_bound(tk, packed, fcm_out, tv):
    """Bound of one trunk call: the valid rows' products (rows past an
    utterance's valid count need none) in bf16; bytes: the FCM output,
    the weights and the stats."""
    b, t_raw, _ = fcm_out.shape
    t_valid, _ = tk.trunk_geometry(t_raw)
    rows = b * t_valid if tv is None else int(np.sum(tv))
    return bound(2.0 * trunk_macs_per_row(tk) * rows, PEAK_BF16,
                 b * t_raw * 320 * 2 + nbytes(*packed.values()) + b * 1024 * 4)


def cluster_sweep(tk, packed, model, rng, dev, card):
    """Every cluster size the trunk allows at the serving and bucket
    shapes: CUDA-event ms and how many such clusters the card holds
    resident at once (cudaOccupancyMaxActiveClusters)."""
    index = dev.index or 0
    out = {}
    for name, b, t, ratio in (("b1 x 398", 1, 398, 0.75),
                              ("b30 x 198", 30, 198, 0.75),
                              ("b30 x 398", 30, 398, 0.75),
                              ("b64 x 398", 64, 398, 0.75),
                              ("b256 x 298", 256, 298, None),
                              ("b32 x 1598", 32, 1598, None),
                              ("b1 x 3198", 1, 3198, None)):
        t_valid, t16 = tk.trunk_geometry(t)
        tv = (None if ratio is None else
              tk.tvalids_from_ratios(np.full(b, ratio, np.float32), t_valid))
        fx = model.FCM_0(torch.from_numpy(
            rng.randn(b, t, 80).astype(np.float32)).to(dev))
        row = {}
        for cs in tk.CLUSTER_SIZES:
            if cs < smallest_cluster(tk, t16):
                continue
            rows = tk.rows_per_block(t16, cs)
            resident = tk._max_clusters(cs, rows, t_valid, index)
            ms_ = cuda_ms(lambda: tk.trunk_stats(packed, fx, tv, cluster=cs),
                          5 if b >= 32 else 10)
            row[cs] = {"rows_per_block": rows, "resident_clusters": resident,
                       "ms": ms_}
        out[name] = row
        log(f"[times] {card}: trunk cluster sweep {name} frames: " + "; ".join(
            f"cluster={cs} R={r['rows_per_block']} resident="
            f"{r['resident_clusters']} {r['ms']:.3f} ms" for cs, r in row.items()))
    return out


def smallest_cluster(tk, t16):
    return next(c for c in tk.CLUSTER_SIZES
                if tk.rows_per_block(t16, c) <= tk.SMEM_MAX_T16)


def check_fcm(fkm, packed_fcm, rng, dev):
    """Phase 4: the FCM kernel against its plain version (both bf16);
    returns the largest max |d|."""
    fcm_max = 0.0
    for b, t in ((8, 298), (8, 297), (4, 1598), (2, 3198)):
        x = torch.from_numpy(rng.randn(b, t, 80).astype(np.float32)).to(dev)
        got = fkm.fcm_fused(packed_fcm, x)
        ref = fkm.fcm_reference(packed_fcm, x)
        torch.cuda.synchronize()
        g, r = got.double(), ref.double()
        d = float((g - r).abs().max())
        scale = max(1.0, float(r.abs().max()))
        c = float((g * r).sum() / (g.norm() * r.norm()))
        log(f"[fcm] b{b} x {t} frames: shape {tuple(got.shape)} cos={c:.8f} "
            f"max|d|={d:.3e} max|d|/scale={d / scale:.3e} (bars cos > 0.9999, "
            f"max|d|/scale < 5e-2)")
        if not (got.shape == (b, t, 320) and torch.isfinite(g).all()
                and c > 0.9999 and d / scale < 5e-2):
            raise AssertionError(f"FCM kernel disagrees (b{b} x {t})")
        fcm_max = max(fcm_max, d)
    return fcm_max


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def random_flax_variables(model, seed):
    """Seeded random weights in the flax layout (the inverse of
    ``convert.jax_to_torch_state``), BN statistics included, so that the
    BN folding is not an identity."""
    rng = np.random.RandomState(seed)
    params, stats = {}, {}

    def put(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value.astype(np.float32)

    bn_mods = {n for n, m in model.named_modules()
               if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))}
    for key, t in model.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        path, shape = mod.split("."), tuple(t.shape)
        if mod in bn_mods:
            if leaf == "weight":
                put(params, path + ["scale"], rng.uniform(0.5, 1.5, shape))
            elif leaf == "bias":
                put(params, path + ["bias"], rng.normal(0.0, 0.2, shape))
            elif leaf == "running_mean":
                put(stats, path + ["mean"], rng.normal(0.0, 0.2, shape))
            elif leaf == "running_var":
                put(stats, path + ["var"], rng.uniform(0.5, 1.5, shape))
        elif leaf == "weight":
            fan_in = int(np.prod(shape[1:]))
            w = rng.randn(*shape) / np.sqrt(fan_in)
            order = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}[len(shape)]
            put(params, path + ["kernel"], np.transpose(w, order))
        elif leaf == "bias":
            put(params, path + ["bias"], rng.normal(0.0, 0.1, shape))
    return {"params": params, "batch_stats": stats}


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n=20):
    """Device ms of one ``fn()`` without the host's launch cost: ``n``
    calls captured in one CUDA graph, the graph replayed (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, 10) / n


def ms(xs):
    return sum(xs) / len(xs)


def turns(plain, kernel, iters, plain_iters=None):
    """plain, kernel, kernel, plain: two CUDA-event means each."""
    pi = plain_iters or iters
    p = [cuda_ms(plain, pi, 1)]
    k = [cuda_ms(kernel, iters) for _ in range(2)]
    p.append(cuda_ms(plain, pi, 1))
    return k, p


def fcm_split(fkm, packed_fcm, fx, occ):
    """The ms of each launch of the FCM kernel (CUDA events around each,
    a mean of 10 runs) beside the bytes its design moves and the
    operations it does: rows of {name, ms, bytes, gb_per_s, tflop_per_s,
    floor_ms, items, grid}, floor_ms being the bytes over the HBM3 peak,
    items and grid those of the persistent conv launches (the grids the
    wrapper passes to the kernel, from ``occ``: fcm_occupancy)."""
    b, t, _ = fx.shape
    times = fkm.fcm_stage_times(packed_fcm, fx, 10)
    items = [None] + [fkm.fcm_conv_items(b, t, f_out)
                      for _, _, f_out, *_ in fkm.FCM_LAUNCHES[1:]]
    grids = [None] + fkm.fcm_grids(b, t, occ)
    rows = []
    for c, n_items, grid in zip(fkm.fcm_launch_costs(b, t), items, grids):
        ms_ = times[c["name"]]
        rows.append({"name": c["name"], "ms": ms_, "bytes": c["bytes"],
                     "gb_per_s": c["bytes"] / ms_ / 1e6,
                     "tflop_per_s": c["flop"] / ms_ / 1e9,
                     "floor_ms": c["bytes"] / PEAK_BYTES * 1e3,
                     "items": n_items, "grid": grid})
    return rows


def fcm_times(fkm, packed_fcm, model, feats, rng, dev, card):
    """Phase 7, the FCM. For each of ``feats`` ({name: (B, T, 80)}): the
    kernel against its plain version (fcm_reference) in turns, the model's
    plain FCM (cuDNN), and the split by launch. At b1 x 398 and b64 x 398
    (one /embedding and a micro-batch, below FCM_MIN_T): the kernel
    against model.FCM_0 in turns."""
    occ = fkm.fcm_occupancy(dev)
    log(f"[fcm] {card}: conv kernel resident blocks per SM and SM count "
        f"{occ}")
    out = {"occupancy": occ}
    for name, fx in feats.items():
        k, p = turns(lambda: fkm.fcm_reference(packed_fcm, fx),
                     lambda: fkm.fcm_fused(packed_fcm, fx), 10, 3)
        cud = [cuda_ms(lambda: model.FCM_0(fx), 3, 1) for _ in range(2)]
        split = fcm_split(fkm, packed_fcm, fx, occ)
        floor = sum(r["floor_ms"] for r in split)
        out[name] = {"ms": k, "plain_ms": p, "cudnn_ms": cud,
                     "design_floor_ms": floor, "split": split}
        log(f"[times] {card}: FCM {name} kernel {k} ms, plain version "
            f"(fcm_reference) {p} ms, model.FCM_0 (cuDNN, fp32) {cud} ms; "
            f"design byte floor {floor:.4f} ms (the kernel at "
            f"{floor / ms(k):.1%} of it)")
        for r in split:
            log(f"[fcm split] {card}: {name} {r['name']:7s} {r['ms']:.4f} ms, "
                f"{r['bytes'] / 1e6:.1f} MB, {r['gb_per_s']:.0f} GB/s, "
                f"{r['tflop_per_s']:.1f} TFLOP/s, byte floor "
                f"{r['floor_ms']:.4f} ms ({r['floor_ms'] / r['ms']:.1%}); "
                f"items {r['items']}, grid {r['grid']}")
        log(f"[fcm split] {card}: {name} sum of launches "
            f"{sum(r['ms'] for r in split):.4f} ms")
    for name, b, t in (("b1 x 398", 1, 398), ("b64 x 398", 64, 398)):
        fx = torch.from_numpy(rng.randn(b, t, 80).astype(np.float32)).to(dev)
        k, c = turns(lambda: model.FCM_0(fx),
                     lambda: fkm.fcm_fused(packed_fcm, fx), 20)
        out[name] = {"ms": k, "cudnn_ms": c}
        log(f"[times] {card}: FCM {name} frames kernel {k} ms, model.FCM_0 "
            f"(cuDNN, fp32) {c} ms")
    return out


def cos_min(a, b):
    a, b = a.double(), b.double()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())


def check_trunk(name, model, packed, fcm_out, tv, tk, cluster=None):
    """Trunk kernel against its plain version; returns the stats max |d|."""
    s_k = tk.trunk_stats(packed, fcm_out, tv, cluster=cluster)
    s_p = tk.trunk_stats_reference(packed, fcm_out, tv)
    e_k = model.DenseBN_0(s_k)
    e_p = model.DenseBN_0(s_p)
    torch.cuda.synchronize()
    sd = float((s_k - s_p).abs().max())
    ed = float((e_k - e_p).abs().max())
    c_s, c_e = cos_min(s_k, s_p), cos_min(e_k, e_p)
    rel = sd / float(s_p.abs().max())
    log(f"[trunk] {name}: stats cos={c_s:.6f} max|d|={sd:.3e} "
        f"(rel {rel:.3e}); embed cos={c_e:.6f} max|d|={ed:.3e} "
        f"(bars cos > 0.9999, max|d| < 5e-3)")
    if not (torch.isfinite(s_k).all() and c_s > 0.9999
            and c_e > 0.9999 and ed < 5e-3 and rel < 5e-3):
        raise AssertionError(f"trunk kernel disagrees ({name})")
    return sd


def check_ragged(embed, rng, bucket, valids, dev):
    """A ragged padded batch, each row against its exact-length run."""
    padded = np.zeros((len(valids), bucket), np.float32)
    for i, n in enumerate(valids):
        padded[i, :n] = rng.randn(n) * 0.1
    ratios = np.asarray([n / bucket for n in valids], np.float32)
    got = embed(torch.from_numpy(padded).to(dev), ratios)
    for i, n in enumerate(valids):
        exact = embed(torch.from_numpy(padded[i:i + 1, :n]).to(dev))
        c = cos_min(exact, got[i:i + 1])
        log(f"[trunk] ragged {bucket}-sample bucket, row {i} ({n} samples): "
            f"cos vs exact-length = {c:.6f} (bar 0.999)")
        if c <= 0.999:
            raise AssertionError("padded row disagrees with exact length")


def wav_bytes(samples, sr=16000):
    import io
    import wave
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def http_post(url, body=b""):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def http_get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def check_segments(name, segs, n_max=None, named=False):
    """A diarization output: ordered, non-empty {speaker, start, end} rows."""
    ok = bool(segs) and all(set(s) == {"speaker", "start", "end"}
                            and s["end"] > s["start"] for s in segs)
    ok = ok and all(a["end"] <= b["start"] + 1e-9
                    for a, b in zip(segs, segs[1:]))
    speakers = {s["speaker"] for s in segs}
    if n_max is not None:
        ok = ok and len(speakers) <= n_max
    if named:
        ok = ok and all(isinstance(s, str) for s in speakers)
    log(f"[serve] diarization {name}: {len(segs)} segments, speakers "
        f"{sorted(map(str, speakers))}, {segs[0]['start']}-{segs[-1]['end']} s")
    if not ok:
        raise AssertionError(f"diarization output malformed ({name}): {segs}")


def reset_launches(fk, fkm, tk):
    fk.fbank_fused.launches = 0
    fkm.fcm_fused.launches = 0
    tk.trunk_stats.launches = 0
    tk.trunk_stats.cluster_launches = {}


def read_launches(fk, fkm, tk):
    torch.cuda.synchronize()
    return {"fbank": fk.fbank_fused.launches, "fcm": fkm.fcm_fused.launches,
            "campplus_trunk": tk.trunk_stats.launches}


def serving_breakdown(pred, model, url, bodies, card, dev):
    """Where a 3 s /embedding request spends its time: host wall medians
    of an HTTP round trip without and with the 3 s body (GET /users, a
    POST that answers 404), WAV decode + dB normalisation, and
    predict_batch at b1 (also from a new thread each time, as a server
    that starts a thread per request would call it) and b64; CUDA-event
    device times of the b1 and b64 embed stages (fbank + CMN, plain FCM,
    trunk kernel, head)."""
    from voiceprintrecognition_paddlepaddle_torch.models import \
        trunk_kernel as tk

    def wall_ms(fn, n):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    def post_404():
        try:
            http_post(f"{url}/nope", bodies[0])
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def in_new_thread(fn):
        t = threading.Thread(target=fn)
        t.start()
        t.join()

    samples = [pred._load_audio(b).samples for b in bodies]
    res = {
        "http_get_users": wall_ms(lambda: http_get(f"{url}/users"), 50),
        "http_post_3s_body_404": wall_ms(post_404, 50),
        "predict_batch_b1_new_thread": wall_ms(lambda: in_new_thread(
            lambda: pred.predict_batch(samples[:1])), 50),
        "load_audio": wall_ms(lambda: pred._load_audio(bodies[0]), 50),
        "predict_batch_b1": wall_ms(lambda: pred.predict_batch(samples[:1]),
                                    50),
        "predict_batch_b64": wall_ms(
            lambda: pred.predict_batch(samples, batch_size=64), 10),
    }
    feat, packed = pred._audio_featurizer, tk.pack_trunk(model)
    for b in (1, 64):
        n = len(samples[0])
        bucket = 64000
        waves = torch.zeros((b, bucket), device=dev)
        for i in range(b):
            waves[i, :n] = torch.from_numpy(samples[i])
        ratios = np.full((b,), n / bucket, np.float32)
        with torch.no_grad():
            feats = feat(waves, input_lens_ratio=ratios)
            t_valid, _ = tk.trunk_geometry(feats.shape[1])
            tv = tk.tvalids_from_ratios(ratios, t_valid)
            fcm = model.FCM_0(feats)
            stats = tk.trunk_stats(packed, fcm, tv)
            res[f"b{b}_featurize"] = cuda_ms(
                lambda: feat(waves, input_lens_ratio=ratios), 20)
            res[f"b{b}_fcm_plain"] = cuda_ms(lambda: model.FCM_0(feats), 20)
            res[f"b{b}_trunk_kernel"] = cuda_ms(
                lambda: tk.trunk_stats(packed, fcm, tv), 20)
            res[f"b{b}_head"] = cuda_ms(lambda: model.DenseBN_0(stats), 20)
    log(f"[times] {card}: serving breakdown (ms; host wall medians, CUDA-"
        f"event device times per stage): " + ", ".join(
            f"{k} {v:.3f}" for k, v in res.items()))
    return res


def serve_phase(model, dev, card, rng):
    """Phase 8: diarization, the narrow plain path and HTTP serving on
    the card. Returns the numbers for the kernels line."""
    from voiceprintrecognition_paddlepaddle_torch import serve
    from voiceprintrecognition_paddlepaddle_torch.infer_utils.micro_batcher \
        import MicroBatcher
    from voiceprintrecognition_paddlepaddle_torch.models import \
        fcm_kernel as fkm
    from voiceprintrecognition_paddlepaddle_torch.models import \
        trunk_kernel as tk
    from voiceprintrecognition_paddlepaddle_torch.models.campplus import \
        CAMPPlus
    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state
    from voiceprintrecognition_paddlepaddle_torch.ops import fbank_kernel as fk
    from voiceprintrecognition_paddlepaddle_torch.ops import features, kaldi
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor

    out = {}
    work = tempfile.mkdtemp(prefix="vpr_serve_")
    servers = []
    try:
        model_path = os.path.join(work, "model.pt")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   model_path)
        db = os.path.join(work, "audio_db")
        shutil.copytree(os.path.join(ROOT, "audio_db"), db,
                        ignore=shutil.ignore_patterns("audio_indexes.bin"))
        long_wav = os.path.join(ROOT, "dataset", "test_long.wav")
        pred = Predictor(CONFIG, threshold=0.6, audio_db_path=db,
                         model_path=model_path, device="cuda")

        # ---- diarization on the main thread ----------------------------
        seen = []
        cluster = pred.speaker_diarize.clustering
        pred.speaker_diarize.clustering = (
            lambda f, speaker_num=None: seen.append(f)
            or cluster(f, speaker_num=speaker_num))
        reset_launches(fk, fkm, tk)
        auto = pred.speaker_diarization(long_wav)
        two = pred.speaker_diarization(long_wav, speaker_num=2)
        named = pred.speaker_diarization(long_wav, search_audio_db=True)
        launches = read_launches(fk, fkm, tk)
        log(f"[serve] diarization of test_long.wav x3: launches {launches}")
        if launches["fbank"] < 3 or launches["campplus_trunk"] < 3:
            raise AssertionError(f"diarization missed a kernel: {launches}")
        out["launches_diarization"] = launches
        check_segments("without an oracle count", auto)
        check_segments("speaker_num=2", two, n_max=2)
        check_segments("search_audio_db", named, named=True)
        segments = pred.speaker_diarize.segments_audio(
            pred._load_audio(long_wav))
        chunks = torch.from_numpy(np.stack([s[2] for s in segments])).to(dev)
        with torch.no_grad():
            ref = model(features.apply_cmn_and_mask(
                kaldi.fbank(chunks, n_mels=80)))
        got = torch.from_numpy(seen[0]).to(dev)
        c = cos_min(ref, got)
        log(f"[serve] {len(segments)} chunk embeddings ({chunks.shape[1]} "
            f"samples in the 32000-sample bucket): min cos vs eager fp32 "
            f"model at exact length = {c:.6f} (bar 0.999)")
        if not (got.shape == ref.shape and c > 0.999):
            raise AssertionError("diarization chunk embeddings disagree")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.speaker_diarization(long_wav)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out["diarization_s"] = walls
        log(f"[times] {card}: diarization of test_long.wav (28.8 s, "
            f"{len(segments)} chunks) wall {walls} s")

        # ---- a CAM++ off the stock widths: the plain model -------------
        narrow = CAMPPlus(80, embd_dim=32, init_channels=32)
        narrow.load_state_dict(jax_to_torch_state(
            random_flax_variables(narrow, SEED)))
        narrow_path = os.path.join(work, "narrow.pt")
        torch.save(narrow.state_dict(), narrow_path)
        cfg = dict(CONFIG, model_conf=dict(
            CONFIG["model_conf"],
            model_args={"embd_dim": 32, "init_channels": 32}))
        reset_launches(fk, fkm, tk)
        npred = Predictor(cfg, model_path=narrow_path, device="cuda")
        clip = (rng.randn(32000) * 0.1).astype(np.float32)
        embs = npred.predict_batch([clip, clip[:20000]])
        launches = read_launches(fk, fkm, tk)
        narrow = narrow.to(dev).eval()
        with torch.no_grad():
            ref = narrow(features.apply_cmn_and_mask(kaldi.fbank(
                torch.from_numpy(clip).to(dev)[None], n_mels=80)))
        c = cos_min(ref, torch.from_numpy(embs[:1]).to(dev))
        log(f"[serve] init_channels 32 CAM++: embeddings {embs.shape}, "
            f"launches {launches}; 2 s clip cos vs eager model {c:.6f} "
            f"(bar 0.9999)")
        if not (embs.shape == (2, 32) and np.isfinite(embs).all()
                and launches["fcm"] == 0 and launches["campplus_trunk"] == 0
                and launches["fbank"] >= 1 and c > 0.9999):
            raise AssertionError("the narrow CAM++ did not take the plain "
                                 "model")

        # ---- HTTP: a plain and a micro-batched server ------------------
        batcher = MicroBatcher(pred, window_ms=5.0, max_batch=64)
        urls = []
        for handler in (serve.make_handler(pred),
                        serve.make_handler(pred, batcher)):
            httpd = serve.ServingHTTPServer(("127.0.0.1", 0), handler)
            servers.append(httpd)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            urls.append(f"http://127.0.0.1:{httpd.server_address[1]}")
        plain_url, batched_url = urls

        def main_thread_embed(body):
            return pred.predict_batch([pred._load_audio(body).samples])[0]

        bodies = [wav_bytes((rng.randn(48000) * 0.1).astype(np.float32))
                  for _ in range(64)]
        with open(long_wav, "rb") as f:
            long_body = f.read()
        ref = torch.from_numpy(np.stack([main_thread_embed(b)
                                         for b in bodies]))
        reset_launches(fk, fkm, tk)
        for i, url in enumerate(urls):
            emb = np.asarray(http_post(f"{url}/embedding", bodies[0])
                             ["embedding"], np.float32)
            c = cos_min(torch.from_numpy(emb[None]), ref[:1])
            score = http_post(f"{url}/contrast?other=user_a/0.wav",
                              bodies[1])["score"]
            reg = http_post(f"{url}/register?name=smoke_{i}", bodies[2])
            rec = http_post(f"{url}/recognition?threshold=0", bodies[2])
            users = http_get(f"{url}/users")["users"]
            stats = http_get(f"{url}/stats")
            log(f"[serve] {url}: /embedding cos vs main thread {c:.6f} (bar "
                f"0.9999); /contrast {score:.4f}; /register {reg}; "
                f"/recognition {rec}; /users {sorted(set(users))}; /stats "
                f"{stats}")
            if not (c > 0.9999 and reg["success"] and rec["name"]
                    and np.isfinite(score)):
                raise AssertionError(f"an endpoint failed on {url}")
        segs = http_post(f"{plain_url}/diarization?speakers=2&search_db=1",
                         long_body)["segments"]
        check_segments("over HTTP", segs, n_max=2, named=True)
        items0, batches0 = batcher.items, batcher.batches
        with ThreadPoolExecutor(64) as pool:
            embs = list(pool.map(lambda b: np.asarray(http_post(
                f"{batched_url}/embedding", b)["embedding"], np.float32),
                bodies))
        items, batches = batcher.items - items0, batcher.batches - batches0
        launches = read_launches(fk, fkm, tk)
        c = cos_min(torch.from_numpy(np.stack(embs)), ref)
        log(f"[serve] 64 concurrent /embedding (3 s clips) through the "
            f"micro-batcher: {items} items in {batches} batches; min cos vs "
            f"main-thread embeds {c:.6f} (bar 0.9999); launches over the "
            f"HTTP run {launches}")
        if not (c > 0.9999 and batches < items == 64):
            raise AssertionError("micro-batched embeddings disagree")
        if launches["fbank"] < 1 or launches["campplus_trunk"] < 1:
            raise AssertionError(f"HTTP serving missed a kernel: {launches}")
        out["launches_http"] = launches

        # ---- serving numbers -------------------------------------------
        for _ in range(5):
            http_post(f"{plain_url}/embedding", bodies[0])
        lat = []
        for i in range(100):
            t0 = time.perf_counter()
            http_post(f"{plain_url}/embedding", bodies[i % 64])
            lat.append(time.perf_counter() - t0)
        p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
        log(f"[times] {card}: /embedding, 3 s clip, 100 serial requests: "
            f"P50 {p50:.3f} ms, P99 {p99:.3f} ms, mean "
            f"{1e3 * sum(lat) / len(lat):.3f} ms")

        def client(k):
            for j in range(8):
                http_post(f"{batched_url}/embedding", bodies[(k + j) % 64])

        items0, batches0 = batcher.items, batcher.batches
        t0 = time.perf_counter()
        with ThreadPoolExecutor(64) as pool:
            list(pool.map(client, range(64)))
        wall = time.perf_counter() - t0
        rps = 512 / wall
        n_b = batcher.batches - batches0
        log(f"[times] {card}: micro-batched /embedding, 64 clients x 8 "
            f"requests of 3 s clips: {rps:.1f} requests/s ({wall:.3f} s; "
            f"{batcher.items - items0} items in {n_b} batches, mean batch "
            f"{(batcher.items - items0) / max(n_b, 1):.1f})")
        out.update(embedding_p50_ms=p50, embedding_p99_ms=p99,
                   batched_requests_per_s=rps)
        out["breakdown_ms"] = serving_breakdown(
            pred, model, plain_url, bodies, card, dev)
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(work, ignore_errors=True)
    return out


def median_ms(fn, iters):
    """The median of ``iters`` CUDA-event times of one ``fn()``, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def product_flops(model, x):
    """Twice the multiply-adds of every conv and linear layer in one
    forward of ``model`` on ``x`` (counted from the layers' output shapes
    by forward hooks)."""
    total = [0]

    def count(m, _, out):
        if isinstance(m, torch.nn.Linear):
            total[0] += 2 * out.numel() * m.in_features
        else:
            total[0] += 2 * out.numel() * (m.in_channels // m.groups) \
                * math.prod(m.kernel_size)

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d,
                               torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def kernel_split(fn, n_top=4):
    """Device time of one ``fn()`` by kernel, from ``torch.profiler``
    (CUDA activity): the traced total, the share in conv / matmul kernels
    (names with gemm, conv, xmma or cutlass) and the ``n_top`` kernels by
    time. ``traced_ms`` is 0 where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    total = sum(ms_ for _, ms_ in rows)
    products = sum(ms_ for k, ms_ in rows if any(
        w in k.lower() for w in ("gemm", "conv", "xmma", "cutlass")))
    return {"traced_ms": total,
            "products_share": products / total if total else None,
            "top": [(k[:70], ms_) for k, ms_ in rows[:n_top]]}


def row_cos(a, b):
    a, b = a.double(), b.double()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def check_feature_methods(features, fk, rng, dev):
    """Phase 9, the front end: the four other feature methods and two
    non-stock Fbank settings on the card against the CPU, on b4 x 3 s.
    Bars: log features max |d| < 2e-2 and p99 < 1e-3, linear ones max |d|
    < 1e-4 of their largest value; the non-stock Fbank launches no fbank
    kernel."""
    w = (rng.randn(4, 48000) * 0.1).astype(np.float32)
    out = {}
    for method, args, is_log in (
            ("MFCC", {}, True), ("MelSpectrogram", {}, False),
            ("LogMelSpectrogram", {}, True), ("Spectrogram", {}, False),
            ("Fbank", {"n_mels": 80, "window_type": "hamming"}, True),
            ("Fbank", {"n_mels": 80, "snip_edges": False,
                       "use_energy": True}, True)):
        name = " ".join([method] + [f"{k}={v}" for k, v in args.items()])
        launches = fk.fbank_fused.launches
        got = features.compute_feature(torch.from_numpy(w).to(dev), method,
                                       sr=16000, **args)
        torch.cuda.synchronize()
        ref = features.compute_feature(torch.from_numpy(w), method, sr=16000,
                                       **args)
        d = (got.cpu().double() - ref.double()).abs()
        mx, p99 = float(d.max()), float(torch.quantile(d.flatten(), 0.99))
        scale = float(ref.abs().max())
        ok = (got.shape == ref.shape and bool(torch.isfinite(got).all())
              and fk.fbank_fused.launches == launches
              and (mx < 2e-2 and p99 < 1e-3 if is_log
                   else mx < 1e-4 * scale))
        log(f"[backbones] {name}: card vs CPU {tuple(got.shape)} max|d|="
            f"{mx:.3e} p99={p99:.3e} scale {scale:.3e} (bars "
            f"{'2e-2, p99 1e-3' if is_log else '1e-4 of the scale'})")
        if not ok:
            raise AssertionError(f"{name} on the card disagrees with the CPU")
        out[name] = {"max_abs_err": mx, "p99_abs_err": p99, "scale": scale}
    return out


def backbones_phase(dev, card):
    """Phase 9: the six other configs served through Predictor on the card
    at full width, held against Predictor(device="cpu"), and timed."""
    from voiceprintrecognition_paddlepaddle_torch.models import build_model
    from voiceprintrecognition_paddlepaddle_torch.models import \
        fcm_kernel as fkm
    from voiceprintrecognition_paddlepaddle_torch.models import \
        trunk_kernel as tk
    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state
    from voiceprintrecognition_paddlepaddle_torch.ops import fbank_kernel as fk
    from voiceprintrecognition_paddlepaddle_torch.ops import features
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
    from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
        dict_to_object

    t0 = time.perf_counter()
    precision = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                 "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    log(f"[backbones] precision: the Predictor keeps PyTorch's defaults, "
        f"{precision}: cuDNN convs in TF32, matmuls in fp32")
    rng = np.random.RandomState(SEED + 9)
    clips = [(rng.randn(int(rng.uniform(1.0, 8.0) * 16000)) * 0.1)
             .astype(np.float32) for _ in range(32)]
    chunk, n_chunks = 8, 4
    w64 = torch.from_numpy(
        (rng.randn(64, 48000) * 0.1).astype(np.float32)).to(dev)
    out = {"precision": precision}
    work = tempfile.mkdtemp(prefix="vpr_backbones_")
    try:
        for key, conf in BACKBONE_CONFS.items():
            cfg = dict(CONFIG, model_conf=conf)
            model = build_model(80, dict_to_object(cfg))
            model.load_state_dict(jax_to_torch_state(
                random_flax_variables(model, SEED)))
            path = os.path.join(work, f"{key}.pt")
            torch.save(model.state_dict(), path)
            pred = Predictor(cfg, model_path=path, device="cuda")
            reset_launches(fk, fkm, tk)
            embs = pred.predict_batch(clips, batch_size=chunk)
            launches = read_launches(fk, fkm, tk)
            ref = Predictor(cfg, model_path=path, device="cpu").predict_batch(
                clips, batch_size=chunk)
            got, want = torch.from_numpy(embs), torch.from_numpy(ref)
            cos = row_cos(got, want)
            rel = float(((got - want).abs().amax(-1)
                         / want.abs().amax(-1)).max())
            with torch.no_grad():
                exact = torch.cat([pred.model(pred._audio_featurizer(
                    torch.from_numpy(c).to(dev))) for c in clips[:8]]).cpu()
            pad_cos = row_cos(exact, got[:8])
            with torch.no_grad():
                feats = pred._audio_featurizer(w64)
                t = {"featurize_ms": median_ms(
                         lambda: pred._audio_featurizer(w64), 5),
                     "model_ms": median_ms(lambda: pred.model(feats), 5),
                     "embed_ms": median_ms(
                         lambda: pred.model(pred._audio_featurizer(w64)), 5)}
            t["utt_per_s"] = 64e3 / t["embed_ms"]
            split = kernel_split(lambda: pred.model(feats))
            flops = product_flops(pred.model, feats)
            t["model_gflop"] = flops / 1e9
            t["model_tflop_per_s"] = flops / t["model_ms"] / 1e9
            params = sum(p.numel() for p in pred.model.parameters())
            log(f"[backbones] {key} ({conf['model']}, {params / 1e6:.2f} M "
                f"parameters): predict_batch {embs.shape} in {n_chunks} chunks"
                f", launches {launches}; card vs CPU min cos "
                f"{float(cos.min()):.6f} (bar 0.999), largest max|d|/scale "
                f"{rel:.3e}; padded vs exact length on the card, 8 clips: "
                f"min cos {float(pad_cos.min()):.6f} (no bar)")
            log(f"[times] {card}: {key} whole embed b64 x 3 s "
                f"{t['embed_ms']:.3f} ms = {t['utt_per_s']:.1f} utt/s "
                f"(featurize {t['featurize_ms']:.3f} ms, model "
                f"{t['model_ms']:.3f} ms; CUDA-event medians of 5); the "
                f"model's convs and linears {t['model_gflop']:.1f} GFLOP, "
                f"{t['model_tflop_per_s']:.1f} TFLOP/s, "
                f"{t['model_tflop_per_s'] * 1e12 / PEAK_TF32:.1%} of the TF32 "
                f"peak")
            log(f"[times] {card}: {key} model b64 x 3 s by kernel "
                f"(torch.profiler): traced {split['traced_ms']:.3f} ms, "
                f"conv / matmul kernels {split['products_share']}; top "
                + "; ".join(f"{k} {v:.3f} ms" for k, v in split["top"]))
            if not (embs.shape == (32, 192) and np.isfinite(embs).all()
                    and launches["fbank"] == n_chunks
                    and launches["fcm"] == 0
                    and launches["campplus_trunk"] == 0
                    and float(cos.min()) >= 0.999):
                raise AssertionError(f"{key} on the card fails its checks")
            out[key] = {"model": conf["model"], "parameters": params,
                        "launches": launches, "min_cos_vs_cpu":
                        float(cos.min()), "max_rel_err_vs_cpu": rel,
                        "padded_vs_exact_min_cos": float(pad_cos.min()),
                        "kernel_split": split, **t}
            del pred, model
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["features"] = check_feature_methods(features, fk, rng, dev)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[backbones] phase 9 wall {out['wall_s']:.1f} s")
    return out


# ---- 10. training ----------------------------------------------------------
def write_wav(path, samples, sr=16000):
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


def synth_corpus(root, n_train=64, clips=8, train_s=(3.0, 5.0), n_eval=8,
                 enroll=2, trials=3, eval_s=(3.0, 20.0), seed=SEED):
    """Seeded WAVs under ``root``: speaker k a harmonic stack on its own
    f0 with noise (``tests/test_trainer_e2e.py``), ``n_train`` train
    speakers of ``clips`` clips and ``n_eval`` other speakers with
    ``enroll`` enroll and ``trials`` trial clips. Returns the train, enroll
    and trials list paths."""
    rng = np.random.RandomState(seed)
    wavs = os.path.join(root, "wavs")
    os.makedirs(wavs, exist_ok=True)

    def clip(f0, seconds, name):
        t = np.arange(int(seconds * 16000)) / 16000
        sig = sum(np.sin(2 * np.pi * f0 * h * t + rng.rand()) / h
                  for h in range(1, 5))
        path = os.path.join(wavs, name)
        write_wav(path, rng.uniform(0.1, 0.4) * (sig + 0.1 * rng.randn(len(t))))
        return path

    lists = {"train": [], "enroll": [], "trials": []}
    for k in range(n_train):
        f0 = 90.0 + 5.0 * k
        lists["train"] += [f"{clip(f0, rng.uniform(*train_s), f't{k}_{i}.wav')}"
                           f"\t{k}" for i in range(clips)]
    for k in range(n_eval):
        f0 = 92.5 + 37.0 * k
        for part, n in (("enroll", enroll), ("trials", trials)):
            lists[part] += [f"{clip(f0, rng.uniform(*eval_s), f'{part}{k}_{i}.wav')}"
                            f"\t{k}" for i in range(n)]
    out = []
    for part in ("train", "enroll", "trials"):
        path = os.path.join(root, f"{part}_list.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lists[part]) + "\n")
        out.append(path)
    return out


def train_config(lists, **changes):
    """``CONFIG`` with the list paths set (and ``changes``, dotted keys);
    returns the config and every change made."""
    import copy

    cfg = copy.deepcopy(CONFIG)
    done = dict(zip(("dataset_conf.train_list", "dataset_conf.enroll_list",
                     "dataset_conf.trials_list"), lists), **changes)
    for key, value in done.items():
        node = cfg
        *path, leaf = key.split(".")
        for k in path:
            node = node[k]
        node[leaf] = value
    return cfg, done


def _one_step(tr, variables, classifier, batch, step):
    """``tr``'s train step from the given weights on ``batch`` at the
    trainer's step ``step``: the loss, the gradients (caught before the
    update), the parameters after it and the BN statistics, on the CPU
    in float64."""
    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state

    tr.model.load_state_dict(jax_to_torch_state(variables))
    tr.classifier.load_state_dict(classifier)
    tr.step = step
    grads = {}

    def catch(opt, args, kwargs):
        for n, p in zip(tr.param_names, opt.param_groups[0]["params"]):
            grads[n] = p.grad.detach().double().cpu()

    hook = tr.optimizer.register_step_pre_hook(catch)
    kind, data, labels, lens = batch
    tr.model.train()
    tr.classifier.train()
    loss, _ = tr.train_step(kind, *(torch.from_numpy(x).to(tr.device)
                                    for x in (data, labels, lens)))
    hook.remove()
    return {"loss": float(loss), "grads": grads,
            "params": {n: p.detach().double().cpu() for n, p in
                       zip(tr.param_names,
                           tr.optimizer.param_groups[0]["params"])},
            "stats": {k: v.double().cpu() for k, v in
                      tr.model.state_dict().items() if "running" in k}}


def _step_diff(c, g):
    """The card's step ``g`` against the CPU's ``c``."""
    top = max(float(v.norm()) for v in c["grads"].values())
    cos, small = {}, {}
    for n, v in c["grads"].items():
        w = g["grads"][n]
        if float(v.norm()) >= 1e-5 * top:
            cos[n] = float((v * w).sum() / (v.norm() * w.norm()))
        else:   # zero up to rounding: a bias ahead of a BatchNorm
            small[n] = float((v - w).norm()) / top
    flat_c = torch.cat([v.flatten() for v in c["grads"].values()])
    flat_g = torch.cat([g["grads"][n].flatten() for n in c["grads"]])
    stats = max(float((g["stats"][k] - v).abs().max() / v.abs().max())
                for k, v in c["stats"].items())
    # Adam's first step moves an entry by lr * g / (|g| + 1e-8), about
    # lr * sign(g): compare the entries whose gradient sets that sign on
    # both sides (above 1e-3 of the leaf's largest and 1e-6 on both), in
    # the leaves whose gradient is not rounding alone
    held, flips, total, par, worst = 0, 0, 0, 0.0, None
    for n, v in c["params"].items():
        total += v.numel()
        if n not in cos:
            continue
        gc, gg = c["grads"][n], g["grads"][n]
        det = (gc.abs() > 1e-3 * gc.abs().max()) & (gc.abs() > 1e-6)
        same = det & (torch.sign(gc) == torch.sign(gg)) & (gg.abs() > 1e-6)
        d = torch.where(same, (g["params"][n] - v).abs(), 0.0)
        rel = float(d.max()) / float(v.abs().max())
        if rel > par:
            i = int(d.flatten().argmax())
            par, worst = rel, (n, float(gc.flatten()[i]),
                               float(gg.flatten()[i]), float(v.flatten()[i]),
                               float(g["params"][n].flatten()[i]))
        held += int(same.sum())
        flips += int((det & ~same).sum())
    return {"loss_card": g["loss"],
            "loss_rel": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
            "grad_cos_all": float((flat_c * flat_g).sum()
                                  / (flat_c.norm() * flat_g.norm())),
            "grad_cos_min": min(cos.values()),
            "grad_cos_worst": sorted(
                (round(v, 6), n, float(c["grads"][n].norm()) / top)
                for n, v in cos.items())[:4],
            "grad_leaves": len(cos), "rounding_leaves": len(small),
            "rounding_leaf_max_d": max(small.values(), default=0.0),
            "bn_stats_rel": stats, "param_rel": par,
            "param_worst": worst,
            "param_entries_held": held, "param_sign_flips": flips,
            "param_entries": total}


def held_step(cfg, dev, seed=SEED, step=None):
    """One train step of ``cfg`` on ``dev`` against the same step on the
    CPU: the same weights (seeded through models/convert.py), the same
    first batch of the train list, no augmentation (the dB normalization
    runs). The card runs it twice: with cuDNN's TF32 convs (PyTorch's
    default, what training uses) and in fp32. ``step``: the trainer's
    step count before it (the schedule's update), by default the end of
    the warmup, where the LR is at its peak. Returns the measured
    differences of each."""
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer

    cpu = Trainer(cfg, device="cpu")
    cpu._setup_dataloader(is_train=True)
    cpu._setup_model(cpu.audio_featurizer.feature_dim, is_train=True)
    variables = random_flax_variables(cpu.model, seed)
    classifier = {k: v.clone() for k, v in cpu.classifier.state_dict().items()}
    if step is None:
        warm = cfg["optimizer_conf"]["scheduler_args"].get("warmup_epoch", 5)
        step = int(warm * len(cpu.train_loader))
    cpu.train_dataset._rng.seed(seed)        # the crops of the batch
    batch = next(iter(cpu.train_loader))
    ref = _one_step(cpu, variables, classifier, batch, step)
    out = {"loss_cpu": ref["loss"], "step": step, "lr": cpu.lr_schedule(step)}
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        for name, allow in (("tf32", True), ("fp32", False)):
            torch.backends.cudnn.allow_tf32 = allow
            card = Trainer(cfg, device=dev)
            card._setup_dataloader(is_train=True)
            card._setup_model(card.audio_featurizer.feature_dim, is_train=True)
            out[name] = _step_diff(
                ref, _one_step(card, variables, classifier, batch, step))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def held_step_ok(held, per_leaf=True):
    """The gates, from what the card measured (two batches each). fp32
    convs: the loss and the BN statistics within 1e-3 relative, the whole
    gradient cos >= 0.999 (measured 0.99970, 0.99972), every leaf
    cos >= 0.995 (measured down to 0.99869, 0.99930: small CAM-gate
    leaves, 1e-4 of the largest leaf's norm, from summation order alone),
    the leaves that are zero up to rounding within 1e-3 of the largest
    leaf's norm, the updated parameters within 1e-3 of each leaf's scale
    where both gradients set the same Adam sign (measured 6.0e-5, on 89.8 %
    of the entries; the gate asks 75 % or more). TF32 convs (PyTorch's default, what training uses; measured
    loss 5.9e-4 and 1.6e-3 relative off the CPU's fp32, whole-gradient cos
    0.966 and 0.969, leaves down to 0.785): the loss within 1e-2, the
    whole gradient cos >= 0.9, the BN statistics within 1e-3.
    ``per_leaf=False`` drops the leaf bar (the tiny model of
    ``tests/test_torch_gpu.py``, whose 1e-5 cutoff does not separate its
    zero-up-to-rounding leaves)."""
    f, t = held["fp32"], held["tf32"]
    return (f["loss_rel"] <= 1e-3 and f["grad_cos_all"] >= 0.999
            and (f["grad_cos_min"] >= 0.995 or not per_leaf)
            and f["rounding_leaf_max_d"] <= 1e-3 and f["bn_stats_rel"] <= 1e-3
            and f["param_rel"] <= 1e-3
            and f["param_entries_held"] >= 0.75 * f["param_entries"]
            and t["loss_rel"] <= 1e-2 and t["grad_cos_all"] >= 0.9
            and t["bn_stats_rel"] <= 1e-3)


def instrument(tr, fk):
    """Wrap ``tr.train_step`` and ``tr.featurize`` with CUDA events, and
    count the fbank kernel's launches and keep the loss of each step."""
    rec = {"step": [], "featurize": [], "fbank": [], "loss": []}
    step, featurize = tr.train_step, tr.featurize

    def events():
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        return s, e

    def timed_featurize(*a, **kw):
        s, e = events()
        out = featurize(*a, **kw)
        e.record()
        rec["featurize"].append((s, e))
        return out

    def timed_step(*a, **kw):
        n = fk.fbank_fused.launches
        s, e = events()
        loss, acc = step(*a, **kw)
        e.record()
        rec["step"].append((s, e))
        rec["fbank"].append(fk.fbank_fused.launches - n)
        rec["loss"].append(loss)
        return loss, acc

    tr.train_step, tr.featurize = timed_step, timed_featurize
    return rec


def step_split(tr, batch, steps=4):
    """Where a train step's time goes: CUDA events around the whole step,
    the featurize, the backbone's forward (module hooks) and the optimizer
    update (optimizer hooks), means over ``steps`` steps after two; the
    rest is the head, the loss and the backward. Then one step traced by
    ``torch.profiler`` (``kernel_split``): its device time, the share in
    conv and matmul kernels, the top kernels."""
    rec = {k: [] for k in ("step", "featurize", "forward", "optimizer")}
    open_ = {}

    def start(key):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        open_[key] = e

    def stop(key):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        rec[key].append((open_.pop(key), e))

    featurize = tr.featurize

    def timed_featurize(*a, **kw):
        start("featurize")
        out = featurize(*a, **kw)
        stop("featurize")
        return out

    hooks = [tr.model.register_forward_pre_hook(lambda *_: start("forward")),
             tr.model.register_forward_hook(lambda *_: stop("forward")),
             tr.optimizer.register_step_pre_hook(lambda *_: start("optimizer")),
             tr.optimizer.register_step_post_hook(lambda *_: stop("optimizer"))]
    tr.featurize = timed_featurize
    args = [torch.from_numpy(x).to(tr.device) for x in batch[1:]]
    try:
        for i in range(steps + 2):
            start("step")
            tr.train_step(batch[0], *args)
            stop("step")
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
        tr.featurize = featurize
    out = {k: sum(s_.elapsed_time(e) for s_, e in v[2:]) / steps
           for k, v in rec.items()}
    out["rest_ms"] = out["step"] - out["featurize"] - out["forward"] \
        - out["optimizer"]
    out = {f"{k}_ms" if not k.endswith("_ms") else k: v
           for k, v in out.items()}
    out.update(kernel_split(lambda: tr.train_step(batch[0], *args), n_top=6))
    out["busy"] = out["traced_ms"] / out["step_ms"]
    return out


def train_phase(dev, card):
    """Phase 10: training on the card. A seeded corpus; one train step
    held against the CPU; Trainer.train() for one epoch at b64 x 3 s in
    fp32 and with enable_amp; evaluate() through the three kernels;
    best_model served by Predictor; resume."""
    from voiceprintrecognition_paddlepaddle_torch.models import \
        fcm_kernel as fkm
    from voiceprintrecognition_paddlepaddle_torch.models import \
        trunk_kernel as tk
    from voiceprintrecognition_paddlepaddle_torch.ops import fbank_kernel as fk
    from voiceprintrecognition_paddlepaddle_torch.ops import features, kaldi
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer

    t0 = time.perf_counter()
    out = {"card": card}
    work = tempfile.mkdtemp(prefix="vpr_train_")
    try:
        lists = synth_corpus(work)
        cfg, changes = train_config(lists)
        log(f"[train] corpus: 64 train speakers x 8 clips of 3-5 s, 8 eval "
            f"speakers x (2 enroll + 3 trials) clips of 3-20 s, in "
            f"{time.perf_counter() - t0:.1f} s; config configs/cam++.yml "
            f"with {changes}; precision: cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}")

        # -- one step on the card against the CPU, b8 x 3 s ---------------
        cfg8, ch8 = train_config(lists, **{"dataset_conf.sampler.batch_size": 8})
        t = time.perf_counter()
        held = held_step(cfg8, dev)
        held["wall_s"] = time.perf_counter() - t
        out["held_vs_cpu"] = held
        for name in ("tf32", "fp32"):
            h = held[name]
            log(f"[train] {card}: one step b8 x 3 s at update {held['step']} "
                f"(lr {held['lr']:.2e}), the card ({name} convs) against the "
                f"CPU: loss {h['loss_card']:.6f} vs {held['loss_cpu']:.6f} "
                f"(rel {h['loss_rel']:.2e}); gradient cos over all leaves "
                f"{h['grad_cos_all']:.6f}, leaf min {h['grad_cos_min']:.6f} "
                f"over {h['grad_leaves']} leaves, worst "
                f"{h['grad_cos_worst']} (cos, leaf, norm / largest); "
                f"{h['rounding_leaves']} leaves below 1e-5 of the largest "
                f"leaf's norm (zero up to rounding) within "
                f"{h['rounding_leaf_max_d']:.2e} of it; BN running statistics "
                f"rel {h['bn_stats_rel']:.2e}; updated parameters rel "
                f"{h['param_rel']:.2e} on {h['param_entries_held']} of "
                f"{h['param_entries']} entries (gradient above 1e-3 of the "
                f"leaf's largest and 1e-6, the same sign on both, leaves "
                f"above rounding; {h['param_sign_flips']} such entries flip "
                f"sign); worst (leaf, CPU gradient, card gradient, CPU "
                f"parameter, card parameter) {h['param_worst']}")
        log(f"[train] gates (held_step_ok): fp32: loss, BN 1e-3, all-leaf "
            f"cos >= 0.999, each leaf >= 0.995, rounding leaves 1e-3, "
            f"parameters 1e-3; tf32: loss 1e-2, all-leaf cos >= 0.9, BN 1e-3; "
            f"{held['wall_s']:.1f} s")
        if not held_step_ok(held):
            raise AssertionError("the train step on the card disagrees with "
                                 "the CPU")

        # -- full width: one epoch at b64 x 3 s, fp32 then AMP --------------
        save = os.path.join(work, "models")
        trainers = {}
        for amp in (False, True):
            cfg_r, _ = train_config(lists, **{"train_conf.enable_amp": amp})
            tr = Trainer(cfg_r, device=dev)
            rec = instrument(tr, fk)
            reset_launches(fk, fkm, tk)
            t = time.perf_counter()
            tr.train(save_model_path="" if amp else save, log_dir="",
                     do_eval=not amp, max_epochs=1)
            wall = time.perf_counter() - t
            launches = read_launches(fk, fkm, tk)
            steps = [s.elapsed_time(e) for s, e in rec["step"]]
            feat = [s.elapsed_time(e) for s, e in rec["featurize"]]
            losses = [float(x) for x in rec["loss"]]
            steady = steps[2:]
            step_ms = sum(steady) / len(steady)
            run = {"steps": len(steps), "step_ms": steps,
                   "steady_step_ms": step_ms,
                   "train_utt_per_s": 64e3 / step_ms,
                   "featurize_ms": sum(feat[2:]) / len(feat[2:]),
                   "fbank_launches_per_step": rec["fbank"], "loss": losses,
                   "wall_s": wall, "launches_train_path": launches}
            run["featurize_share"] = run["featurize_ms"] / step_ms
            out["amp" if amp else "fp32"] = run
            log(f"[train] {card}: Trainer.train() 1 epoch, b64 x 3 s, "
                f"{'AMP bf16' if amp else 'fp32'}: {len(steps)} steps, "
                f"steady step {step_ms:.2f} ms (CUDA events, steps 3-"
                f"{len(steps)}) = {run['train_utt_per_s']:.1f} train utt/s; "
                f"featurize {run['featurize_ms']:.3f} ms "
                f"({100 * run['featurize_share']:.1f} % of the step); fbank "
                f"launches per step {rec['fbank']}; loss "
                f"{[round(x, 4) for x in losses]}; train() wall {wall:.1f} s "
                f"(with {'no' if amp else 'the per-epoch'} evaluation); "
                f"launches {launches}")
            if not (all(n == 1 for n in rec["fbank"]) and len(steps) >= 4
                    and all(np.isfinite(losses))):
                raise AssertionError("a train step did not launch the fbank "
                                     "kernel once, or its loss is not finite")
            trainers[amp] = tr

        # -- evaluate(): the three kernels, no fallback ---------------------
        tr = trainers[False]
        reset_launches(fk, fkm, tk)
        t = time.perf_counter()
        eer, min_dcf, threshold = tr.evaluate()
        launches = read_launches(fk, fkm, tk)
        ev = {"eer": eer, "min_dcf": min_dcf, "threshold": threshold,
              "wall_s": time.perf_counter() - t, "launches": launches,
              "clips": len(tr.enroll_dataset) + len(tr.trials_dataset)}
        enroll, _ = tr.eval_embeddings["enroll"]
        cos = []
        tr.model.eval()
        with torch.no_grad():
            for i in range(len(tr.enroll_dataset)):
                x = torch.from_numpy(tr.enroll_dataset[i][0]).to(dev)[None]
                f = features.apply_cmn_and_mask(kaldi.fbank(x, n_mels=80))
                cos.append(cos_min(tr.model(f), enroll[i:i + 1]))
        tr.model.train()
        ev["cos_vs_plain_min"] = min(cos)
        out["eval"] = ev
        log(f"[train] {card}: evaluate() over {ev['clips']} clips of 3-20 s: "
            f"EER {eer:.5f}, MinDCF {min_dcf:.5f}, threshold "
            f"{threshold:.4f}, wall {ev['wall_s']:.2f} s, launches "
            f"{launches}; enroll embeddings against the plain fp32 model at "
            f"exact length: cos min {ev['cos_vs_plain_min']:.6f} (bar 0.999)")
        if not (launches["campplus_trunk"] > 0 and launches["fcm"] > 0
                and ev["cos_vs_plain_min"] > 0.999):
            raise AssertionError("the evaluation did not run the kernels or "
                                 "disagrees with the plain model")

        # -- checkpoints: Predictor serves best_model; resume ---------------
        best = os.path.join(save, "CAMPPlus_Fbank", "best_model")
        pred = Predictor(cfg, model_path=best, device=dev)
        paths = [ln.split("\t")[0] for ln in tr.enroll_dataset.lines]
        got = torch.from_numpy(pred.predict_batch(
            paths, batch_size=cfg["dataset_conf"]["eval_conf"]["batch_size"]))
        c_pred = cos_min(got.to(dev), enroll)
        tr2 = Trainer(cfg, device=dev)
        tr2.train(save_model_path=save, log_dir="", do_eval=False,
                  max_epochs=2)
        with open(os.path.join(save, "CAMPPlus_Fbank", "last_model",
                               "model.state"), encoding="utf-8") as f:
            last = json.load(f)
        lr = tr2.optimizer.param_groups[0]["lr"]
        want_lr = tr2.lr_schedule(tr2.updates - 1)
        out["checkpoints"] = {
            "predictor_cos_min": c_pred, "resumed_step": tr2.step,
            "steps_per_epoch": len(tr2.train_loader),
            "last_epoch": last["last_epoch"], "lr": lr, "schedule_lr": want_lr,
            "files": sorted(os.listdir(best))}
        log(f"[train] Predictor(best_model, device='cuda') against the "
            f"trainer's eval embeddings: cos min {c_pred:.6f} (bar 0.9999); "
            f"resumed from last_model for epoch 2: step {tr2.step} "
            f"({len(tr2.train_loader)} a epoch), last_epoch "
            f"{last['last_epoch']}, lr {lr:.4e} = schedule({tr2.updates - 1}) "
            f"{want_lr:.4e}; best_model holds {sorted(os.listdir(best))}")
        if not (c_pred > 0.9999 and tr2.step == 2 * len(tr2.train_loader)
                and last["last_epoch"] == 2 and lr == want_lr):
            raise AssertionError("checkpoint serving or resume is wrong")

        # -- where a step's time goes (after the checks above: these steps
        # move the weights that best_model holds) --------------------------
        for amp, tr in trainers.items():
            run = out["amp" if amp else "fp32"]
            run["split"] = step_split(tr, next(iter(tr.train_loader)))
            sp = run["split"]
            log(f"[train] {card}: one {'AMP' if amp else 'fp32'} step at b64 "
                f"x 3 s (means of 4 after 2): {sp['step_ms']:.2f} ms = "
                f"featurize {sp['featurize_ms']:.3f} + backbone forward "
                f"{sp['forward_ms']:.2f} + optimizer {sp['optimizer_ms']:.2f} "
                f"+ head, loss and backward {sp['rest_ms']:.2f}; traced device "
                f"time {sp['traced_ms']:.2f} ms (busy {100 * sp['busy']:.0f} "
                f"%), conv / matmul kernels {sp['products_share']} of it; top "
                f"kernels {sp['top']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[train] phase 10 wall {out['wall_s']:.1f} s")
    return out


def main():
    t_start = time.perf_counter()
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs an NVIDIA GPU")
    import voiceprintrecognition_paddlepaddle_torch as port
    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != ROOT:
        raise RuntimeError(f"the port was imported from {port.__file__}, "
                           f"not from this checkout ({ROOT})")
    from voiceprintrecognition_paddlepaddle_torch import _build
    from voiceprintrecognition_paddlepaddle_torch.models.campplus import \
        CAMPPlus
    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state
    from voiceprintrecognition_paddlepaddle_torch.models import \
        fcm_kernel as fkm
    from voiceprintrecognition_paddlepaddle_torch.models import \
        trunk_kernel as tk
    from voiceprintrecognition_paddlepaddle_torch.ops import fbank_kernel as fk
    from voiceprintrecognition_paddlepaddle_torch.ops import features, kaldi
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor

    card = card_line()
    log(card)
    dev = torch.device("cuda:0")
    # plain versions compute their products in true fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} count="
        f"{torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda} matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    # ---- 2. build --------------------------------------------------------
    lib = _build.kernel_library()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} -> {lib.path} in "
        f"{lib.build_seconds:.1f} s (cached={lib.cached})")
    for line in lib.ptxas_log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            log(f"[build] {line.strip()}")

    # ---- 3. fbank kernel vs plain ----------------------------------------
    rng = np.random.RandomState(SEED)
    waves = torch.from_numpy(
        (rng.randn(256, 48000) * 0.1).astype(np.float32)).to(dev)
    got = fk.fbank_fused(waves, n_mels=80)
    ref = fk.fbank_fused_reference(waves, n_mels=80)
    torch.cuda.synchronize()
    d = (got - ref).abs().flatten()
    fb_max = float(d.max())
    fb_p99 = float(torch.quantile(d[::7].double(), 0.99))
    log(f"[fbank] b256 x 3 s: shape {tuple(got.shape)} max|d|={fb_max:.3e} "
        f"p99|d|={fb_p99:.3e} (bars 2e-2, 1e-3)")
    if not (got.shape == (256, 298, 80) and fb_max < 2e-2 and fb_p99 < 1e-3):
        raise AssertionError("fbank kernel disagrees with its plain version")
    fb_hard_max = check_fbank_hard(fk, dev,
                                   np.random.RandomState(SEED + 1))

    # ---- 4. FCM kernel vs plain -----------------------------------------
    model = CAMPPlus(80, embd_dim=192)
    model.load_state_dict(jax_to_torch_state(random_flax_variables(model,
                                                                   SEED)))
    model.to(dev).eval().requires_grad_(False)
    packed_fcm = fkm.pack_fcm(model)
    fcm_max = check_fcm(fkm, packed_fcm, rng, dev)

    # ---- 5. trunk kernel vs plain ----------------------------------------
    packed = tk.pack_trunk(model)
    feat = features.AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80})
    embed = tk.make_campplus_masked_embed_fn(model, feat)
    with torch.no_grad():
        fcm_b256 = model.FCM_0(feat(waves))
        trunk_max = check_trunk("b256 x 298 frames", model, packed, fcm_b256,
                                None, tk)
        w8 = torch.from_numpy(
            (rng.randn(3, 128000) * 0.1).astype(np.float32)).to(dev)
        check_trunk("3 x 798 frames", model, packed, model.FCM_0(feat(w8)),
                    None, tk)
        for b, t, tv in ((4, 1598, [800, 612, 101, 1]),
                         (2, 3198, [1600, 1199])):
            f = model.FCM_0(torch.from_numpy(
                rng.randn(b, t, 80).astype(np.float32)).to(dev))
            check_trunk(f"{b} x {t} frames", model, packed, f, None, tk)
            check_trunk(f"{b} x {t} frames, tvalids {tv}", model, packed, f,
                        tv, tk)
        check_ragged(embed, rng, 128000, [128000, 96000, 48000, 24000, 16000],
                     dev)
        check_ragged(embed, rng, 512000, [512000, 400000, 256000, 170000],
                     dev)
        # every cluster size the kernel allows at b1 x 398 (one
        # /embedding: ratio 0.75), b2 x 3198 and b32 x 1598
        checked = set()
        for b, t, tv in ((1, 398, tk.tvalids_from_ratios([0.75], 199)),
                         (2, 3198, [1600, 1101]), (32, 1598, None)):
            _, t16 = tk.trunk_geometry(t)
            f = model.FCM_0(torch.from_numpy(
                rng.randn(b, t, 80).astype(np.float32)).to(dev))
            for cs in tk.CLUSTER_SIZES:
                if cs < smallest_cluster(tk, t16):
                    continue
                d = check_trunk(f"b{b} x {t} frames, tvalids "
                                f"{None if tv is None else [int(v) for v in tv][:4]}, "
                                f"cluster={cs}", model, packed, f, tv, tk,
                                cluster=cs)
                trunk_max = max(trunk_max, d)
                checked.add(cs)

    # ---- 6. the main path: Predictor on the card --------------------------
    work = tempfile.mkdtemp(prefix="vpr_smoke_")
    try:
        model_path = os.path.join(work, "model.pt")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   model_path)
        db = os.path.join(work, "audio_db")
        shutil.copytree(os.path.join(ROOT, "audio_db"), db,
                        ignore=shutil.ignore_patterns("audio_indexes.bin"))
        wav = lambda n: os.path.join(ROOT, "dataset", f"{n}.wav")  # noqa: E731
        clips = [(rng.randn(int(rng.uniform(1.0, 8.0) * 16000)) * 0.1)
                 .astype(np.float32) for _ in range(64)]
        long_clips = [(rng.randn(int(rng.uniform(9.0, 30.0) * 16000)) * 0.1)
                      .astype(np.float32) for _ in range(8)]
        long_clips[0] = (rng.randn(30 * 16000) * 0.1).astype(np.float32)
        clip_16 = (rng.randn(15 * 16000) * 0.1).astype(np.float32)
        clip_33 = (rng.randn(33 * 16000) * 0.1).astype(np.float32)

        reset_launches(fk, fkm, tk)
        t0 = time.perf_counter()
        pred = Predictor(CONFIG, threshold=-1.0, audio_db_path=db,
                         model_path=model_path, device="cuda")
        ok_a, _ = pred.register(wav("a_1"), "speaker_a")
        ok_b, _ = pred.register(wav("b_1"), "speaker_b")
        rec = [pred.recognition(wav(n)) for n in ("a_2", "b_2")]
        score = pred.contrast(wav("a_1"), wav("a_2"))
        embs = pred.predict_batch(clips)
        long_embs = pred.predict_batch(long_clips)
        emb_16 = pred.predict_batch([clip_16])[0]
        kernel_counts = (fkm.fcm_fused.launches, tk.trunk_stats.launches)
        emb_33 = pred.predict_batch([clip_33])
        launches = read_launches(fk, fkm, tk)
        main_clusters = dict(sorted(tk.trunk_stats.cluster_launches.items()))
        main_s = time.perf_counter() - t0
        log(f"[main] Predictor(device='cuda') in {main_s:.2f} s: register "
            f"{ok_a} {ok_b}; users {sorted(set(pred.get_users()))}; "
            f"recognition {rec}; contrast(a_1, a_2) = {score:.4f}; "
            f"predict_batch {embs.shape} + {long_embs.shape}; predict 15 s "
            f"{emb_16.shape}; 33 s {emb_33.shape}; launches {launches}; "
            f"trunk launches by cluster size {main_clusters}")
        if not (ok_a and ok_b and embs.shape == (64, 192)
                and long_embs.shape == (8, 192) and emb_16.shape == (192,)
                and emb_33.shape == (1, 192)
                and all(np.isfinite(e).all()
                        for e in (embs, long_embs, emb_16, emb_33))
                and np.isfinite(score)
                and all(r[0] is not None for r in rec)):
            raise AssertionError("Predictor outputs are wrong")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the path never ran: {launches}")
        if kernel_counts != (launches["fcm"], launches["campplus_trunk"]):
            raise AssertionError("the 33 s clip did not take the plain branch")
        # outputs against the eager fp32 model on exact-length features
        # from the plain fbank
        held = [(f"clip {i}", clips[i], embs[i]) for i in range(4)]
        held += [("15 s clip (16 s bucket)", clip_16, emb_16),
                 ("30 s clip (32 s bucket)", long_clips[0], long_embs[0])]
        with torch.no_grad():
            for name, clip, emb in held:
                x = torch.from_numpy(clip).to(dev)[None]
                f = features.apply_cmn_and_mask(kaldi.fbank(x, n_mels=80))
                ref_e = model(f)
                c = cos_min(ref_e, torch.from_numpy(emb[None]).to(dev))
                log(f"[main] {name} ({clip.shape[0]} samples): cos vs eager "
                    f"fp32 model = {c:.6f} (bar 0.999)")
                if c <= 0.999:
                    raise AssertionError("embedding disagrees with eager model")
            x = torch.from_numpy(clip_33).to(dev)[None]
            f = features.apply_cmn_and_mask(kaldi.fbank(x, n_mels=80))
            c = cos_min(model(f), torch.from_numpy(emb_33).to(dev))
            log(f"[main] 33 s clip, plain branch at the 64 s bucket: cos vs "
                f"the eager model at exact length = {c:.6f} (no bar: the "
                f"plain model's CAM context spans the padding, as in JAX)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 7. times on the card -------------------------------------------
    w16 = torch.from_numpy(
        (rng.randn(32, 256000) * 0.1).astype(np.float32)).to(dev)
    w1 = torch.from_numpy((np.random.RandomState(SEED + 2).randn(1, 64000)
                           * 0.1).astype(np.float32)).to(dev)
    with torch.no_grad():
        fb_t = fbank_times(fk, {"b256 x 3 s": waves, "b32 x 16 s": w16,
                                "b1 x 64000": w1}, card)
        tr_kern, tr_plain = turns(
            lambda: tk.trunk_stats_reference(packed, fcm_b256),
            lambda: tk.trunk_stats(packed, fcm_b256), 10, 3)
        embed_ms = cuda_ms(lambda: embed(waves), 10)
        feats_3 = feat(waves)
        feats_16 = feat(w16)
        fcm_t = fcm_times(fkm, packed_fcm, model, {"b256 x 3 s": feats_3,
                                                   "b32 x 16 s": feats_16},
                          rng, dev, card)
        fcm16 = fkm.fcm_fused(packed_fcm, feats_16)
        tr16_kern, tr16_plain = turns(
            lambda: tk.trunk_stats_reference(packed, fcm16),
            lambda: tk.trunk_stats(packed, fcm16), 5, 2)
        embed16_ms = cuda_ms(lambda: embed(w16), 5)
        stats16 = tk.trunk_stats(packed, fcm16)
        # the trunk with its default split against the smallest cluster
        # the shape allows, in turns (smallest, default, default, smallest)
        split_times = {}
        for name, b, t, ratio, iters in (
                ("b256 x 298", 256, 298, None, 10),
                ("b64 x 398", 64, 398, 0.75, 10),
                ("b1 x 398", 1, 398, 0.75, 20),
                ("b32 x 1598", 32, 1598, None, 5)):
            t_valid, t16 = tk.trunk_geometry(t)
            tv = (None if ratio is None else
                  tk.tvalids_from_ratios(np.full(b, ratio, np.float32), t_valid))
            fx = {"b256 x 298": fcm_b256, "b32 x 1598": fcm16}.get(name)
            if fx is None:
                fx = model.FCM_0(torch.from_numpy(
                    rng.randn(b, t, 80).astype(np.float32)).to(dev))
            cs_def, rows = tk.default_split(b, t, dev)
            cs_min = smallest_cluster(tk, t16)
            k, p = turns(
                lambda: tk.trunk_stats(packed, fx, tv, cluster=cs_min),
                lambda: tk.trunk_stats(packed, fx, tv), iters)
            split_times[name] = {
                "cluster": cs_def, "rows_per_block": rows, "ms": k,
                "smallest_cluster": cs_min, "smallest_cluster_ms": p,
                **trunk_bound(tk, packed, fx, tv)}
        stages16 = {
            "featurize": cuda_ms(lambda: feat(w16), 10),
            "fcm kernel": cuda_ms(lambda: fkm.fcm_fused(packed_fcm, feats_16), 10),
            "trunk kernel": cuda_ms(lambda: tk.trunk_stats(packed, fcm16), 5),
            "head": cuda_ms(lambda: model.DenseBN_0(stats16), 10),
        }
    log(f"[times] {card}: trunk b256 x 298 frames kernel {tr_kern} ms, plain "
        f"{tr_plain} ms")
    log(f"[times] {card}: whole embed b256 x 3 s {embed_ms:.3f} ms/batch = "
        f"{256e3 / embed_ms:.1f} utt/s")
    log(f"[times] {card}: trunk b32 x 1598 frames kernel {tr16_kern} ms, "
        f"plain {tr16_plain} ms")
    log(f"[times] {card}: whole embed b32 x 16 s {embed16_ms:.3f} ms/batch = "
        f"{32e3 / embed16_ms:.1f} utt/s; stages {stages16} ms")
    with torch.no_grad():
        sweep = cluster_sweep(tk, packed, model, rng, dev, card)
    resident = resident_table(tk, dev.index or 0)
    log(f"[split] {card}: resident clusters by cluster size and rows per "
        f"block (cs: {{R: clusters}}): {json.dumps(resident)}")
    for name, st in split_times.items():
        log(f"[times] {card}: trunk {name} frames, default split cluster="
            f"{st['cluster']} (R={st['rows_per_block']}) {st['ms']} ms; "
            f"smallest cluster={st['smallest_cluster']} "
            f"{st['smallest_cluster_ms']} ms; bound {st['bound_ms']:.4f} ms "
            f"({st['bound_by']}, {st['work_gflop']:.2f} GFLOP)")

    # ---- 8. serve: diarization, the narrow path, HTTP -------------------
    served = serve_phase(model, dev, card, rng)

    # ---- 9. backbones: the six other configs, the other front ends ------
    backbones = backbones_phase(dev, card)
    print(json.dumps({"backbones": backbones, "card": card}), flush=True)

    # ---- 10. training: the train step, evaluate, checkpoints -------------
    training = train_phase(dev, card)
    print(json.dumps({"training": training}), flush=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    train_launches = {"fbank_per_step": 1,
                      "eval": training["eval"]["launches"],
                      "train_path": training["fp32"]["launches_train_path"]}

    f16, f3 = fcm_t["b32 x 16 s"], fcm_t["b256 x 3 s"]
    # bounds at the shapes of "ms": fbank b256 x 3 s (fp32: a 512-point
    # FFT per frame), FCM b32 x 16 s (bf16 convs), trunk b256 x 3 s (bf16
    # products over the valid rows)
    fb3 = fb_t["b256 x 3 s"]
    fb_bound = {k: fb3[k] for k in ("bound_ms", "bound_by", "work_gflop")}
    fb_entry = {
        "name": "fbank", "route": "cuda", "source": FBANK_SRC,
        "replaces": FBANK_TPU, "launches": launches["fbank"],
        "max_abs_err": fb_max, "max_abs_err_hard_vs_float64": fb_hard_max,
        "launches_train_step": train_launches["fbank_per_step"],
        "launches_train_path": train_launches["train_path"]["fbank"],
        "launches_eval": train_launches["eval"]["fbank"],
        "ms": ms(fb3["ms"]), "plain_ms": ms(fb3["plain_ms"]), **fb_bound,
        "library_ms": None, "cufft_ms": ms(fb3["cufft_ms"]),
        "graph_ms": ms(fb3["graph_ms"]), "shape": "b256 x 3 s"}
    for name, key in (("b32 x 16 s", "b32x16s"), ("b1 x 64000", "b1x64000")):
        fb_entry.update({f"{k}_{key}": ms(fb_t[name][k])
                         for k in ("ms", "plain_ms", "cufft_ms", "graph_ms")})
        fb_entry[f"bound_ms_{key}"] = fb_t[name]["bound_ms"]
    fcm_macs, f = 0, 80
    for i, (_, _, stride) in enumerate(fkm._SPECS):
        f = f // stride if stride else f
        fcm_macs += packed_fcm[f"w{i}"].shape[0] * 32 * f
    fcm_bounds = {name: bound(2.0 * fcm_macs * fx.shape[0] * fx.shape[1],
                              PEAK_BF16, nbytes(fx) + nbytes(*packed_fcm.values())
                              + fx.shape[0] * fx.shape[1] * 320 * 2)
                  for name, fx in (("b32 x 16 s", feats_16),
                                   ("b256 x 3 s", feats_3))}
    tr_bound = trunk_bound(tk, packed, fcm_b256, None)
    for name, bd in (("fbank b256 x 3 s", fb_bound),
                     ("FCM b32 x 16 s", fcm_bounds["b32 x 16 s"]),
                     ("FCM b256 x 3 s", fcm_bounds["b256 x 3 s"]),
                     ("trunk b256 x 3 s", tr_bound)):
        log(f"[times] {name}: bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
            f"{bd['work_gflop']:.2f} GFLOP) on the published H100 SXM peaks")
    print(json.dumps({"kernels": [
        fb_entry,
        {"name": "fcm", "route": "cuda", "source": FCM_SRC,
         "replaces": FCM_TPU, "also_replaces": FCM_TPU_CHUNKED,
         "launches": launches["fcm"], "max_abs_err": fcm_max,
         "launches_eval": train_launches["eval"]["fcm"],
         "ms": ms(f16["ms"]), "plain_ms": ms(f16["plain_ms"]),
         **fcm_bounds["b32 x 16 s"], "library_ms": None,
         "cudnn_ms": ms(f16["cudnn_ms"]),
         "design_floor_ms": f16["design_floor_ms"], "shape": "b32 x 16 s",
         "ms_b256x3s": ms(f3["ms"]), "plain_ms_b256x3s": ms(f3["plain_ms"]),
         "cudnn_ms_b256x3s": ms(f3["cudnn_ms"]),
         "bound_ms_b256x3s": fcm_bounds["b256 x 3 s"]["bound_ms"],
         "work_gflop_b256x3s": fcm_bounds["b256 x 3 s"]["work_gflop"],
         "design_floor_ms_b256x3s": f3["design_floor_ms"],
         "occupancy": fcm_t["occupancy"],
         "split_ms": {n: {r["name"]: r["ms"] for r in f["split"]}
                      for n, f in (("b32 x 16 s", f16), ("b256 x 3 s", f3))},
         "vs_cudnn_398": {n: {"ms": ms(fcm_t[n]["ms"]),
                              "cudnn_ms": ms(fcm_t[n]["cudnn_ms"])}
                          for n in ("b1 x 398", "b64 x 398")}},
        {"name": "campplus_trunk", "route": "cuda", "source": TRUNK_SRC,
         "replaces": TRUNK_TPU, "also_replaces": TRUNK_TPU_LOOPED,
         "launches": launches["campplus_trunk"], "max_abs_err": trunk_max,
         "launches_eval": train_launches["eval"]["campplus_trunk"],
         "ms": ms(tr_kern), "plain_ms": ms(tr_plain), **tr_bound,
         "library_ms": None, "shape": "b256 x 3 s",
         "ms_b32x16s": ms(tr16_kern), "plain_ms_b32x16s": ms(tr16_plain),
         "cluster_launches_main_path": main_clusters,
         "clusters_checked": sorted(checked), "split_times": split_times,
         "cluster_sweep": sweep, "resident_clusters": resident},
    ], "embed_utt_per_s": 256e3 / embed_ms,
        "embed_16s_utt_per_s": 32e3 / embed16_ms, "serve": served,
        "train_utt_per_s": training["fp32"]["train_utt_per_s"],
        "train_utt_per_s_amp": training["amp"]["train_utt_per_s"],
        "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
