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
            bucket), b2 x 3198 (the 32 s bucket, where it runs the
            chunked kernel), the bucket shapes the main path gives it: b64
            x 98 (1 s), b256 x 198 (2 s), b1 x 398 (one /embedding, 4 s)
            and b16 x 798 (8 s), and the edges of the kernel's items: b1 x
            5 (shorter than every halo), b3 x 33 (one frame past a time
            tile) and b1 x 1598 (one long clip)
5. trunk    the trunk kernel against its plain version (both bf16), full
            CAM++ width with random weights and BN statistics from a seed,
            converted from the flax layout by models/convert.py:
            b256 x 298 frames, 3 x 798 frames, 1598 and 3198 frames exact
            and ragged, and ragged padded 8 s and 32 s batches held row by
            row against their exact-length embeddings; then every cluster
            size the kernel allows (R <= 256 rows per block) at b1 x 398
            frames with ratio 0.75 (one /embedding), b2 x 3198 (ragged)
            and b32 x 1598
6. main     Predictor(device="cuda"): register / recognition / contrast
            over the demo wavs, predict_batch over 64 seeded 1-8 s clips
            and 8 seeded 9-30 s clips (the 32 s bucket), a 15 s clip (the
            16 s bucket), and a 33 s clip that runs the plain
            model; every kernel's launch counter must rise, and 1-8 s,
            16 s and 32 s embeddings are held against the eager fp32 model;
            the FCM and trunk kernels launch at every stage (the demo wavs,
            the 1-8 s clips, the 32 s and 16 s buckets) and not for the
            33 s clip
7. times    CUDA-event times of each kernel against its plain version and
            whole-embed utt/s at b256 x 3 s (bench.py's embed workload)
            and b32 x 16 s; the fbank kernel also at b32 x 16 s and b1 x
            64000 (one /embedding), each beside ``cufft_ms`` (kaldi's steps
            as library calls with cuFFT, fp32) and its device time from a
            CUDA-graph replay (at b1 the events time the host's launches);
            the FCM kernel's crossover against the model's plain FCM
            (cuDNN convs, the input in the model's dtype, on a thread
            that has its cuDNN handle), in turns, at b1, b64 and b256 of each bucket from 1 s
            to 8 s (98, 198, 398 and 798 frames), b256 x 298 and b32 x
            1598, one line a shape, failing if cuDNN wins at any (the embed
            path takes the kernel at every bucket); the ms of each of its
            four launches beside the bytes the design moves and the
            operations it issues (GB/s, TFLOP/s of the function's and of
            the design's work, the byte floor); the stages of the b256 x 3
            s and b32 x 16 s embeds; the trunk
            at b256 x 298, b64 x 398, b1 x 398 and b32 x 1598 frames with
            its default cluster split against the smallest cluster that
            shape allows, in turns, with each split's block threads and
            shared memory; where block 0's time goes at b256 x 298 and
            b32 x 1598 (the kernel's phase stamps: stem, bottleneck
            products, CAM sums and exchange, local conv, gate MLP, append,
            transits, pooling); every cluster size at the serving and
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
            request's time goes (HTTP, decode, the b1 and b64 embed stages;
            predict_batch and cuDNN's FCM in a new thread against the
            same thread); the FCM kernel's launches on one /embedding and
            on predict_batch of 3 s clips (one each)
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
10. train   training on the card: a seeded corpus, one b8 x 3 s step held
            against the CPU, Trainer.train() of the stock CAM++ for an
            epoch at b64 x 3 s in fp32 and with AMP, evaluate() through the
            three kernels, best_model served, resume
11. workflow the single-card workflow at the stock CAM++'s width, every
            command line reading configs/cam++.yml (its lists replaced)
            through the port's YAML reader: convert_paddle turns a seeded
            paddle state into model.pt (equal to the in-process route, its
            kernel-path embeddings held against the eager model);
            extract_features writes .npy features (the fbank kernel, held
            against the plain fbank); Trainer.train() from them at b64 x
            3 s with enable_remat and mu_dtype bfloat16, then with neither
            (step ms, peak memory; the loss, the BN statistics after step 1
            and the bf16 exp_avg held); train(profiler_dir=...) for 21
            steps from waveforms (a trace naming the fbank kernel);
            export(export_batch=None, export_seconds=None), model.pt2
            reloaded and held against the Predictor's kernel path at two
            batches and two lengths; infer_recognition registers two users
            and recognises a 12 s clip (the three kernels)
12. parallel data parallelism at the stock CAM++'s width, on phase 10's
            seeded corpus: two ranks on cuda:0 (gloo with CUDA tensors)
            started by the port's launcher run 4 DDP steps at b32 x 3 s
            each, held against one process at b64 on the same batches
            (the mean rank loss within 1e-3 relative, the parameters at
            cos >= 0.9999); rank 0 saves a checkpoint_format: orbax (DCP)
            checkpoint; both ranks evaluate() their shards of the 16
            enroll and 24 trial clips of 3-20 s through the three kernels
            and report the EER and MinDCF of a world-1 evaluate() within
            1e-6; one rank over NCCL takes a DDP step; Predictor serves
            the DCP checkpoint (cos >= 0.9999 against model.pt) and
            Predictor(data_parallel=True, devices=[cuda:0, cuda:0]) holds
            11 clips of 1-8 s and one of 16 s against one device (cos >=
            0.9999); the step ms of both, the collectives timed alone
13. last    the last modules, on the stock CAM++ (192-d) trained on the
            card by the port's Trainer on 4 tone speakers x 4 clips of
            1.2 s (tests/test_predictor.py's diarization recipe: 40
            epochs, lr 0.05, seed 7): a 6-turn 3-speaker conversation
            diarized with speaker_num=3 through the kernel path (fbank
            and trunk kernels) and through the fp32 plain model
            (kaldi.fbank and the eager CAM++, no kernel launched), each
            held to 3 speakers, DER < 0.20 and confusion < 0.05 after an
            RTTM round trip; the chunk embeddings as served against the
            plain version of the same padded batch (cos >= 0.9999) and,
            at exact length, the kernel path against the fp32 model (cos
            >= 0.999), the cosines to the fp32 model at exact length and
            to the fp32 Predictor printed; the RTTM flow
            (eval_speaker_diarization.infer_data and compute_metrics as
            child processes) over two conversations with their own
            audio_db, DER < 0.20 with each turn named; eval_from_paddle
            (a child process) on the trained weights written as a
            .pdparams (converted back bit-equal) over 8 tone speakers'
            clips of 3-20 s (the three kernels) equal to an in-process
            Trainer.evaluate within 1e-6, --predict to
            Predictor.contrast within 1e-5; the GUI actions (contrast
            verdicts, register and recognise, the streaming window, the
            diarization action); the wall time of each step

The last line is ``{"ok": true, "device": {...}}``; the line before it
is a JSON object with one entry per kernel. ``chip_smoke.py --phase12-rank
<dir>`` and ``--phase12-nccl <dir>`` are phase 12's rank programs, which
the phase starts itself.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from voiceprintrecognition_paddlepaddle_torch.utils.config import load_yaml

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# the configs, read by the port's YAML reader (the GPU host has no PyYAML)
CONFIG = load_yaml(os.path.join(ROOT, "configs", "cam++.yml"))
# model_conf of the six other configs/*.yml
BACKBONE_CONFS = {
    name: load_yaml(os.path.join(ROOT, "configs", f"{name}.yml"))["model_conf"]
    for name in ("tdnn", "ecapa_tdnn", "res2net", "resnet_se", "eres2net",
                 "eres2netv2")}

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
            ms_ = cuda_ms(lambda: tk._trunk_stats_at(packed, fx, tv, cs),
                          5 if b >= 32 else 10)
            row[cs] = {"rows_per_block": rows, "resident_clusters": resident,
                       "ms": ms_}
        out[name] = row
        log(f"[times] {card}: trunk cluster sweep {name} frames: " + "; ".join(
            f"cluster={cs} R={r['rows_per_block']} resident="
            f"{r['resident_clusters']} {r['ms']:.3f} ms" for cs, r in row.items()))
    return out


def trunk_phase_split(tk, packed, cases, card):
    """Where block 0 of the trunk kernel spends its time, at each of
    ``cases`` ({name: (fcm_out, tvalids)}, the default split): the
    kernel's phase stamps (``trunk_phase_times``, a mean of 5 launches),
    ms per phase by ``%globaltimer`` and the share of SM cycles, beside
    the kernel's CUDA-event ms."""
    out = {}
    for name, (fx, tv) in cases.items():
        st = tk.trunk_phase_times(packed, fx, tv, iters=5)
        kernel = cuda_ms(lambda: tk.trunk_stats(packed, fx, tv), 5)
        cyc = sum(st["cycles"].values())
        ghz = cyc / sum(st["ms"].values()) / 1e6
        out[name] = {"kernel_ms": kernel, "ms": st["ms"], "sm_ghz": ghz,
                     "cycle_share": {k: v / cyc for k, v in st["cycles"].items()}}
        log(f"[trunk split] {card}: {name}: kernel {kernel:.3f} ms; block 0 "
            f"{sum(st['ms'].values()):.3f} ms at {ghz:.2f} GHz: " + ", ".join(
                f"{k} {v:.3f} ms ({st['cycles'][k] / cyc:.1%})"
                for k, v in st["ms"].items()))
    return out


def smallest_cluster(tk, t16):
    return next(c for c in tk.CLUSTER_SIZES
                if tk.rows_per_block(t16, c) <= tk.SMEM_MAX_T16)


def check_fcm(fkm, packed_fcm, rng, dev):
    """Phase 4: the FCM kernel against its plain version (both bf16);
    returns the largest max |d|."""
    fcm_max = 0.0
    for b, t in ((8, 298), (8, 297), (4, 1598), (2, 3198), (64, 98),
                 (256, 198), (1, 398), (16, 798), (1, 5), (3, 33), (1, 1598)):
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
    operations it does: rows of {name, convs, ms, bytes, gb_per_s,
    tflop_per_s (the function's work), design_tflop_per_s (what the kernel
    issues, halos included), floor_ms, items, grid}, floor_ms being the
    bytes over the HBM3 peak, items and grid those of the persistent
    launches (the grids the wrapper passes to the kernel, from ``occ``:
    fcm_occupancy)."""
    b, t, _ = fx.shape
    times = fkm.fcm_stage_times(packed_fcm, fx, 10)
    grids = fkm.fcm_grids(b, t, occ)
    rows = []
    for ln, c, grid in zip(fkm.FCM_LAUNCHES, fkm.fcm_launch_costs(b, t),
                           grids):
        ms_ = times[c["name"]]
        rows.append({"name": c["name"], "convs": ln.convs, "ms": ms_,
                     "bytes": c["bytes"], "gb_per_s": c["bytes"] / ms_ / 1e6,
                     "tflop_per_s": c["flop"] / ms_ / 1e9,
                     "design_tflop_per_s": c["design_flop"] / ms_ / 1e9,
                     "floor_ms": c["bytes"] / PEAK_BYTES * 1e3,
                     "items": fkm.fcm_items(b, t, ln), "grid": grid})
    return rows


# the buckets' frames from 1 s to 8 s (data_utils/collate.py) and the
# batches of the FCM crossover: one /embedding, a micro-batch, bench.py's
FCM_BUCKET_FRAMES = (98, 198, 398, 798)
FCM_CROSSOVER_BATCHES = (1, 64, 256)


def fcm_times(fkm, packed_fcm, model, feats, rng, dev, card):
    """Phase 7, the FCM. For each of ``feats`` ({name: (B, T, 80)}): the
    kernel against its plain version (fcm_reference) in turns and the
    split by launch. Then the crossover: the kernel against the model's
    plain FCM (cuDNN, called as the embed path called it: the input in
    the model's dtype, on this thread, which has its cuDNN handle) in
    turns at each of FCM_CROSSOVER_BATCHES x FCM_BUCKET_FRAMES and at
    ``feats``' shapes; raises if cuDNN wins at any."""
    occ = fkm.fcm_occupancy(dev)
    log(f"[fcm] {card}: each launch's resident blocks per SM and SM count "
        f"{occ}")
    out = {"occupancy": occ}
    for name, fx in feats.items():
        k, p = turns(lambda: fkm.fcm_reference(packed_fcm, fx),
                     lambda: fkm.fcm_fused(packed_fcm, fx), 10, 3)
        split = fcm_split(fkm, packed_fcm, fx, occ)
        floor = sum(r["floor_ms"] for r in split)
        out[name] = {"ms": k, "plain_ms": p, "design_floor_ms": floor,
                     "split": split}
        log(f"[times] {card}: FCM {name} kernel {k} ms, plain version "
            f"(fcm_reference) {p} ms; design byte floor {floor:.4f} ms (the "
            f"kernel at {floor / ms(k):.1%} of it)")
        for r in split:
            log(f"[fcm split] {card}: {name} {r['name']} ({r['convs']}) "
                f"{r['ms']:.4f} ms, {r['bytes'] / 1e6:.1f} MB, "
                f"{r['gb_per_s']:.0f} GB/s, {r['tflop_per_s']:.1f} TFLOP/s "
                f"({r['design_tflop_per_s']:.1f} issued), byte floor "
                f"{r['floor_ms']:.4f} ms ({r['floor_ms'] / r['ms']:.1%}); "
                f"items {r['items']}, grid {r['grid']}")
        log(f"[fcm split] {card}: {name} sum of launches "
            f"{sum(r['ms'] for r in split):.4f} ms")
    dtype = model.DenseBN_0.Dense_0.weight.dtype
    shapes = [(b, t, None) for t in FCM_BUCKET_FRAMES
              for b in FCM_CROSSOVER_BATCHES]
    shapes += [(*fx.shape[:2], fx) for fx in feats.values()]
    crossover, cudnn_wins = {}, []
    for b, t, fx in shapes:
        if fx is None:
            fx = torch.from_numpy(rng.randn(b, t, 80).astype(np.float32)).to(dev)
        # cuDNN's FCM takes about 0.0002-0.0003 ms a frame at a batch:
        # about 30 ms of it a timed run
        iters = max(3, min(20, int(30 / (0.0002 * b * t) + 1)))
        k, c = turns(lambda: model.FCM_0(fx.to(dtype)),
                     lambda: fkm.fcm_fused(packed_fcm, fx), 20,
                     plain_iters=iters)
        name = f"b{b} x {t}"
        crossover[name] = {"batch": b, "frames": t, "ms": k, "cudnn_ms": c}
        if max(k) >= min(c):
            cudnn_wins.append(name)
        log(f"[crossover] {card}: FCM {name} frames: kernel {k} ms, "
            f"model.FCM_0 (cuDNN, {dtype}) {c} ms; cuDNN / kernel "
            f"{ms(c) / ms(k):.2f}")
    out["crossover"] = crossover
    if cudnn_wins:
        raise AssertionError(f"cuDNN's FCM beats the FCM kernel at "
                             f"{cudnn_wins}: the embed path must not take "
                             f"the kernel there")
    return out


def cos_min(a, b):
    a, b = a.double(), b.double()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())


def check_trunk(name, model, packed, fcm_out, tv, tk, cluster=None):
    """Trunk kernel against its plain version; returns the stats max |d|."""
    s_k = (tk.trunk_stats(packed, fcm_out, tv) if cluster is None
           else tk._trunk_stats_at(packed, fcm_out, tv, cluster))
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
    that starts a thread per request would call it) and b64; the model's
    cuDNN FCM at b1, from a new thread each time and from this thread (a
    stand-in for the other backbones' cuDNN convs); CUDA-event device
    times of the b1 and b64 embed stages as served (fbank + CMN, FCM
    kernel, trunk kernel, head)."""
    from voiceprintrecognition_paddlepaddle_torch.models import \
        fcm_kernel as fkm
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
    packed_fcm = fkm.pack_fcm(model)
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
            fcm = fkm.fcm_fused(packed_fcm, feats)
            stats = tk.trunk_stats(packed, fcm, tv)
            if b == 1:
                res["cudnn_fcm_b1_new_thread"] = wall_ms(
                    lambda: in_new_thread(lambda: model.FCM_0(feats)), 20)
                res["cudnn_fcm_b1"] = wall_ms(lambda: model.FCM_0(feats), 20)
            res[f"b{b}_featurize"] = cuda_ms(
                lambda: feat(waves, input_lens_ratio=ratios), 20)
            res[f"b{b}_fcm_kernel"] = cuda_ms(
                lambda: fkm.fcm_fused(packed_fcm, feats), 20)
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
        if min(launches.values()) < 3:
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
        if min(launches.values()) < 1:
            raise AssertionError(f"HTTP serving missed a kernel: {launches}")
        out["launches_http"] = launches
        # one /embedding of a 3 s clip, and predict_batch of one and of 64
        # 3 s clips (the 4 s bucket): one launch of each kernel a batch
        reset_launches(fk, fkm, tk)
        http_post(f"{plain_url}/embedding", bodies[0])
        one = read_launches(fk, fkm, tk)
        reset_launches(fk, fkm, tk)
        samples = [pred._load_audio(b).samples for b in bodies]
        pred.predict_batch(samples[:1])
        pred.predict_batch(samples, batch_size=64)
        two = read_launches(fk, fkm, tk)
        log(f"[serve] launches of one /embedding (3 s) {one}; of predict_batch "
            f"at b1 and b64 (3 s clips) {two}")
        if not (set(one.values()) == {1} and set(two.values()) == {2}):
            raise AssertionError("a 3 s /embedding or predict_batch did not "
                                 "launch each kernel once a batch")
        out["launches_embedding_request"] = one
        out["launches_predict_batch_3s_b1_b64"] = two

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
    (names with gemm, conv, xmma or cutlass), the device operations
    (kernels and copies) counted, the ms in NCCL kernels and in memory
    copies, and the ``n_top`` kernels by time. ``traced_ms`` is 0 where
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in rows)

    def named(*words):
        return sum(r[1] for r in rows if any(w in r[0].lower()
                                             for w in words))

    products = named("gemm", "conv", "xmma", "cutlass")
    return {"traced_ms": total,
            "products_share": products / total if total else None,
            "device_ops": sum(r[2] for r in rows),
            "nccl_ms": named("nccl"), "memcpy_ms": named("memcpy"),
            "top": [(k[:70], ms_) for k, ms_, _ in rows[:n_top]]}


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


# ---- 11. the single-card workflow ------------------------------------------
PORT = "voiceprintrecognition_paddlepaddle_torch"


def paddle_shape(kind, f):
    """The paddle shape of a converter spec entry of ``kind`` whose flax
    leaf has the shape ``f``."""
    return {"conv1d_w": lambda: (f[2], f[1], f[0]),
            "conv2d_w": lambda: (f[3], f[2], f[0], f[1]),
            "conv1d_as_dense_w": lambda: (f[1], f[0], 1)}.get(
        kind, lambda: tuple(f))()


def synth_pdparams(model, model_args, seed):
    """A reference paddle ``state_dict`` (numpy, ``0.``-prefixed keys) for
    the CAM++ ``model`` (``CAMPPlus(80, **model_args)``): every key of the
    converter's spec, in paddle's layouts, drawn as
    ``random_flax_variables`` draws its leaves."""
    from voiceprintrecognition_paddlepaddle_torch.models.convert_paddle \
        import SPECS

    flax_tree = random_flax_variables(model, seed)     # for the shapes
    rng = np.random.RandomState(seed + 11)
    out = {}
    for pkey, coll, fpath, _, kind in SPECS["CAMPPlus"](80, **model_args):
        node = flax_tree[coll]
        for k in fpath.split("/"):
            node = node[k]
        shape = paddle_shape(kind, node.shape)
        if kind.endswith("_w"):
            fan_in = shape[0] if kind == "dense_w" else np.prod(shape[1:])
            x = rng.randn(*shape) / np.sqrt(fan_in)
        elif pkey.endswith("._variance") or fpath.endswith("/scale"):
            x = rng.uniform(0.5, 1.5, shape)
        elif pkey.endswith("._mean"):
            x = rng.normal(0.0, 0.2, shape)
        else:
            x = rng.normal(0.0, 0.1, shape)
        out[f"0.{pkey}"] = x.astype(np.float32)
    return out


def pdparams_of(model, model_args):
    """A paddle ``state_dict`` (numpy, ``0.``-prefixed keys) holding the
    CAM++ ``model``'s own weights: the model's state in the flax layout
    (the inverse of ``convert.jax_to_torch_state``), then the inverse of
    each transform of the converter's spec (each a permutation)."""
    from voiceprintrecognition_paddlepaddle_torch.models.convert_paddle \
        import SPECS

    bn_mods = {n for n, m in model.named_modules()
               if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))}
    tree = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        v = t.detach().cpu().numpy()
        if leaf == "num_batches_tracked":
            continue
        coll = "params"
        if mod in bn_mods:
            coll, leaf = {"weight": ("params", "scale"),
                          "bias": ("params", "bias"),
                          "running_mean": ("batch_stats", "mean"),
                          "running_var": ("batch_stats", "var")}[leaf]
        elif leaf == "weight":
            leaf = "kernel"
            v = np.transpose(v, {2: (1, 0), 3: (2, 1, 0),
                                 4: (2, 3, 1, 0)}[v.ndim])
        elif leaf != "bias":
            raise KeyError(f"no flax leaf for {key}")
        node = tree[coll]
        for k in mod.split("."):
            node = node.setdefault(k, {})
        node[leaf] = v
    out = {}
    for pkey, coll, fpath, tf, kind in SPECS["CAMPPlus"](80, **model_args):
        v = tree[coll]
        for k in fpath.split("/"):
            v = v[k]
        # every transform moves elements only: carry the paddle indices
        # through it and scatter the flax values back
        shape = paddle_shape(kind, v.shape)
        idx = np.asarray(tf(np.arange(int(np.prod(shape))).reshape(shape)))
        w = np.empty(idx.size, np.float32)
        w[idx.ravel()] = v.ravel()
        out[f"0.{pkey}"] = w.reshape(shape)
    return out


def run_cli(module, args, timeout=600):
    """``python -m <PORT>.<module> args`` in a child process: the child
    calls the module's ``main`` on ``args`` (what ``-m`` runs), prints its
    return value as JSON, then its kernel launch counts as the last line;
    returns (stdout, launches, value)."""
    code = (
        "import json, sys\n"
        f"from {PORT}.{module} import main\n"
        f"value = main({list(args)!r})\n"
        f"from {PORT}.models import fcm_kernel, trunk_kernel\n"
        f"from {PORT}.ops import fbank_kernel\n"
        "print(json.dumps(value, default=str))\n"
        "print(json.dumps({'fbank': fbank_kernel.fbank_fused.launches, "
        "'fcm': fcm_kernel.fcm_fused.launches, "
        "'campplus_trunk': trunk_kernel.trunk_stats.launches}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    return ("\n".join(lines[:-2]), json.loads(lines[-1]),
            json.loads(lines[-2]))


def yaml_with_lists(path, lists):
    """configs/cam++.yml's text with its three list paths replaced (read
    back by the port's YAML reader); returns the path written."""
    with open(os.path.join(ROOT, "configs", "cam++.yml"),
              encoding="utf-8") as f:
        text = f.read()
    for key, value in zip(("train_list", "enroll_list", "trials_list"),
                          lists):
        old = f"  {key}: {CONFIG['dataset_conf'][key]}\n"
        if old not in text:
            raise AssertionError(f"configs/cam++.yml has no line {old!r}")
        text = text.replace(old, f"  {key}: {value}\n")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return path


def held_features(lists, device):
    """Each ``*_features.txt`` array against the plain fbank on the card
    (``fbank_fused_reference``) of the same clip, padded to its bucket
    and trimmed as ``extract_features`` does; returns (max |d|, p99 |d|,
    arrays)."""
    from voiceprintrecognition_paddlepaddle_torch.data_utils import \
        SpeakerDataset
    from voiceprintrecognition_paddlepaddle_torch.data_utils.collate import \
        bucket_length
    from voiceprintrecognition_paddlepaddle_torch.ops import features
    from voiceprintrecognition_paddlepaddle_torch.ops.fbank_kernel import \
        fbank_fused_reference

    diffs, n = [], 0
    args = dict(CONFIG["dataset_conf"]["dataset"], max_duration=100)
    for src in lists:
        ds = SpeakerDataset(src, mode="extract_feature", **args)
        with open(src.replace(".txt", "_features.txt"),
                  encoding="utf-8") as f:
            saved = [ln.split("\t") for ln in f.read().splitlines()]
        if len(saved) != len(ds):
            raise AssertionError(f"{src}: {len(saved)} features for "
                                 f"{len(ds)} clips")
        for i, (path, label) in enumerate(saved):
            samples, want_label, valid = ds[i]
            pad = bucket_length(len(samples))
            x = torch.zeros((1, pad), device=device)
            x[0, :len(samples)] = torch.from_numpy(samples).to(device)
            ratio = torch.tensor([len(samples) / pad], device=device)
            with torch.no_grad():
                ref = features.apply_cmn_and_mask(
                    fbank_fused_reference(x, n_mels=80), ratio)[0]
            got = torch.from_numpy(np.load(path)).to(device)
            if int(label) != int(want_label) or got.shape[0] > ref.shape[0]:
                raise AssertionError(f"{path}: label or length is wrong")
            diffs.append((got - ref[:got.shape[0]]).abs().flatten())
            n += 1
    d = torch.cat(diffs)
    return float(d.max()), float(torch.quantile(d[::7].double(), 0.99)), n


def workflow_phase(dev, card):
    """Phase 11: the single-card workflow at the stock CAM++'s width:
    convert a paddle checkpoint -> extract features (the fbank kernel) ->
    train from them with and without remat and the bf16 moment -> the
    profiler hook -> export and reload -> recognise (the three kernels).
    Every command line reads configs/cam++.yml's text (its lists
    replaced) through the port's YAML reader."""
    import glob
    import pickle

    from voiceprintrecognition_paddlepaddle_torch.models import \
        fcm_kernel as fkm
    from voiceprintrecognition_paddlepaddle_torch.models import \
        trunk_kernel as tk
    from voiceprintrecognition_paddlepaddle_torch.models.campplus import \
        CAMPPlus
    from voiceprintrecognition_paddlepaddle_torch.models.convert_paddle \
        import pdparams_to_torch_state
    from voiceprintrecognition_paddlepaddle_torch.ops import fbank_kernel as fk
    from voiceprintrecognition_paddlepaddle_torch.ops import features, kaldi
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer

    t0 = time.perf_counter()
    out = {"card": card, "wall_s": {}, "launches": {}}
    work = tempfile.mkdtemp(prefix="vpr_workflow_")

    def lap(name, t):
        out["wall_s"][name] = time.perf_counter() - t

    try:
        # 64 train speakers x 4 clips of 3 s (b64: 4 steps, no crop), 4
        # eval speakers x (2 enroll + 2 trials) clips of 3-8 s
        lists = synth_corpus(work, n_train=64, clips=4, train_s=(3.0, 3.0),
                             n_eval=4, enroll=2, trials=2, eval_s=(3.0, 8.0),
                             seed=SEED + 11)
        yml = yaml_with_lists(os.path.join(work, "cam++.yml"), lists)
        feat_lists = [p.replace(".txt", "_features.txt") for p in lists]
        feat_yml = yaml_with_lists(os.path.join(work, "features.yml"),
                                   feat_lists)

        # -- convert a paddle checkpoint (the command line) ----------------
        t = time.perf_counter()
        model_args = dict(CONFIG["model_conf"]["model_args"])
        model = CAMPPlus(80, **model_args)
        state = synth_pdparams(model, model_args, SEED)
        pdparams = os.path.join(work, "model.pdparams")
        with open(pdparams, "wb") as f:
            pickle.dump(state, f)
        converted = os.path.join(work, "converted")
        proc = subprocess.run(
            [sys.executable, "-m", f"{PORT}.convert_paddle",
             f"--configs={yml}", f"--pdparams={pdparams}",
             f"--output={converted}"], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"convert_paddle failed:\n{proc.stderr[-4000:]}")
        cli_sd = torch.load(os.path.join(converted, "model.pt"),
                            weights_only=True)
        ref_sd = pdparams_to_torch_state(
            {k[2:]: v for k, v in state.items()}, "CAMPPlus", 80,
            model_args=model_args)["model"]
        same = (list(cli_sd) == list(ref_sd)
                and all(torch.equal(cli_sd[k], ref_sd[k]) for k in ref_sd))
        model.load_state_dict(ref_sd)
        model.to(dev).eval().requires_grad_(False)
        rng = np.random.RandomState(SEED + 11)
        # seven clips of 1-8 s and one of 12 s (the 16 s bucket: the FCM
        # kernel)
        clips = [(rng.randn(int(s_ * 16000)) * 0.1).astype(np.float32)
                 for s_ in list(rng.uniform(1.0, 8.0, 7)) + [12.0]]
        reset_launches(fk, fkm, tk)
        pred = Predictor(yml, model_path=converted, device=dev)
        embs = torch.from_numpy(pred.predict_batch(clips)).to(dev)
        out["launches"]["convert_predict"] = read_launches(fk, fkm, tk)
        with torch.no_grad():
            cos = min(cos_min(model(features.apply_cmn_and_mask(kaldi.fbank(
                torch.from_numpy(c).to(dev)[None], n_mels=80))),
                embs[i:i + 1]) for i, c in enumerate(clips))
        lap("convert", t)
        out["convert"] = {"tensors": len(cli_sd), "equal_to_in_process": same,
                          "kernel_path_cos_vs_eager_min": cos,
                          "stdout": proc.stdout.strip()}
        log(f"[workflow] {card}: convert_paddle (a subprocess) wrote "
            f"{len(cli_sd)} tensors, equal to pdparams_to_torch_state "
            f"(convert_state + jax_to_torch_state): {same}; Predictor on its "
            f"model.pt through the kernel path, 7 clips of 1-8 s and one of "
            f"12 s, against the "
            f"eager fp32 model of the in-process route at exact length: cos "
            f"min {cos:.6f} (bar 0.999); launches "
            f"{out['launches']['convert_predict']}; "
            f"{out['wall_s']['convert']:.1f} s")
        if not (same and cos > 0.999
                and min(out["launches"]["convert_predict"].values()) > 0):
            raise AssertionError("the converted checkpoint is wrong")

        # -- extract_features (the command line, the fbank kernel) ---------
        t = time.perf_counter()
        _, launches, _ = run_cli("extract_features", [
            f"--configs={yml}", f"--device={dev.type}",
            f"--save_dir={os.path.join(work, 'features')}"])
        out["launches"]["extract_features"] = launches
        d_max, d_p99, n = held_features(lists, dev)
        lap("extract_features", t)
        out["extract_features"] = {"arrays": n, "max_abs_err": d_max,
                                   "p99_abs_err": d_p99}
        log(f"[workflow] {card}: extract_features (a subprocess, "
            f"--configs through the port's YAML reader): {n} arrays against "
            f"the plain fbank on the card: max|d| {d_max:.3e}, p99|d| "
            f"{d_p99:.3e} (bars 2e-2, 1e-3); launches {launches}; "
            f"{out['wall_s']['extract_features']:.1f} s")
        if not (launches["fbank"] == n and d_max < 2e-2 and d_p99 < 1e-3):
            raise AssertionError("extract_features is wrong")

        # -- train from the features at b64, two ways ----------------------
        runs = {}
        for name, extra in (("remat_bf16_moment",
                             {"train_conf.enable_remat": True,
                              "optimizer_conf.optimizer_args.mu_dtype":
                                  "bfloat16"}),
                            ("plain", {})):
            t = time.perf_counter()
            cfg = load_yaml(feat_yml)
            for key, value in extra.items():
                node = cfg
                *path, leaf = key.split(".")
                for k in path:
                    node = node[k]
                node[leaf] = value
            tr = Trainer(cfg, device=dev)
            rec = instrument(tr, fk)
            first = {}
            step = tr.train_step

            def step_and_snapshot(*a, _step=step, _tr=tr, _first=first,
                                  **kw):
                res = _step(*a, **kw)
                if not _first:
                    _first.update({k: v.detach().clone() for k, v in
                                   _tr.model.state_dict().items()
                                   if "running" in k})
                return res

            tr.train_step = step_and_snapshot
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tr.train(save_model_path="", log_dir="", do_eval=False,
                     max_epochs=1)
            torch.cuda.synchronize()
            steps = [s_.elapsed_time(e) for s_, e in rec["step"]]
            moments = {str(tr.optimizer.state[p]["exp_avg"].dtype)
                       for p in tr.optimizer.param_groups[0]["params"]}
            runs[name] = {
                "steps": len(steps), "step_ms": steps,
                "steady_step_ms": sum(steps[1:]) / max(len(steps) - 1, 1),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "loss": [float(x) for x in rec["loss"]],
                "fbank_launches": sum(rec["fbank"]),
                "exp_avg_dtypes": sorted(moments),
                "optimizer": type(tr.optimizer).__name__,
                "first_step_stats": first, "wall_s": time.perf_counter() - t}
        r, p = runs["remat_bf16_moment"], runs["plain"]
        bn_rel = max(float((r["first_step_stats"][k] - v).abs().max()
                           / v.abs().max().clamp_min(1e-30))
                     for k, v in p["first_step_stats"].items())
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(r["loss"], p["loss"])]
        for run in runs.values():
            del run["first_step_stats"]
        out["train"] = {**runs, "bn_stats_rel_after_step_1": bn_rel,
                        "loss_rel": loss_rel}
        for name, run in runs.items():
            log(f"[workflow] {card}: {name}: Trainer.train() from the "
                f"features at b64 x 3 s, {run['steps']} steps "
                f"({run['optimizer']}, exp_avg {run['exp_avg_dtypes']}): step "
                f"ms {[round(x, 2) for x in run['step_ms']]}, steady "
                f"{run['steady_step_ms']:.2f} ms (CUDA events, steps 2-); "
                f"peak max_memory_allocated {run['peak_gb']:.3f} GB; loss "
                f"{[round(x, 5) for x in run['loss']]}; fbank launches "
                f"{run['fbank_launches']}; {run['wall_s']:.1f} s")
        log(f"[workflow] remat + bf16 moment against neither: loss rel "
            f"{[f'{x:.2e}' for x in loss_rel]} (bars: steps 1-2 1e-5, as "
            f"update 0 runs at lr 0; steps 3-4 1e-2, the bf16 moment's "
            f"rounding), BN running statistics "
            f"after step 1 rel {bn_rel:.2e} (bar 1e-6)")
        if not (r["steps"] == p["steps"] >= 4 and max(loss_rel[:2]) <= 1e-5
                and max(loss_rel[2:4]) <= 1e-2 and bn_rel <= 1e-6
                and r["exp_avg_dtypes"] == ["torch.bfloat16"]
                and r["fbank_launches"] == p["fbank_launches"] == 0):
            raise AssertionError("remat or the bf16 moment changed training")

        # -- the profiler hook, from waveforms, 21 steps -------------------
        t = time.perf_counter()
        cfg = load_yaml(yml)
        cfg["dataset_conf"]["sampler"]["batch_size"] = 12    # 21 steps
        prof_dir = os.path.join(work, "profile")
        tr = Trainer(cfg, device=dev)
        reset_launches(fk, fkm, tk)
        tr.train(save_model_path="", log_dir="", do_eval=False, max_epochs=1,
                 profiler_dir=prof_dir)
        out["launches"]["profiled_train"] = read_launches(fk, fkm, tk)
        traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
        names_fbank = False
        size = 0
        for path in traces:
            size += os.path.getsize(path)
            with open(path, encoding="utf-8") as f:
                names_fbank |= "fbank_kernel" in f.read()
        lap("profiler", t)
        out["profiler"] = {"steps": tr.step, "traces": len(traces),
                           "trace_mb": size / 1e6,
                           "names_fbank_kernel": names_fbank}
        log(f"[workflow] {card}: train(profiler_dir=...) from waveforms, "
            f"b12 x 3 s, {tr.step} steps: {len(traces)} trace(s) of steps "
            f"10-19, {size / 1e6:.1f} MB, names fbank_kernel: {names_fbank}; "
            f"launches {out['launches']['profiled_train']}; "
            f"{out['wall_s']['profiler']:.1f} s")
        if not (tr.step >= 21 and len(traces) == 1 and names_fbank
                and out["launches"]["profiled_train"]["fbank"] == tr.step):
            raise AssertionError("the profiler hook wrote no trace of the "
                                 "fbank kernel")

        # -- export with a symbolic batch and length, reload, run ----------
        t = time.perf_counter()
        tr = Trainer(load_yaml(yml), device=dev)
        infer = tr.export(save_model_path=os.path.join(work, "export"),
                          resume_model=converted, export_batch=None,
                          export_seconds=None)
        lap("export", t)
        t = time.perf_counter()
        program = torch.export.load(os.path.join(infer, "model.pt2")).module()
        lap("export_load", t)
        reset_launches(fk, fkm, tk)
        pred = Predictor(yml, model_path=infer, device=dev)
        held = {}
        for f_ in (298, 498):
            w = (rng.randn(3, 160 * f_ + 240) * 0.1).astype(np.float32)
            want = torch.from_numpy(pred.predict_batch(list(w))).to(dev)
            for b in (1, 3):
                with torch.no_grad():
                    got = program(torch.from_numpy(w[:b]).to(dev))
                held[f"b{b} x {f_} frames"] = cos_min(got, want[:b])
        out["launches"]["export_predict"] = read_launches(fk, fkm, tk)
        out["export"] = {"files": sorted(os.listdir(infer)), "cos": held}
        log(f"[workflow] {card}: export(export_batch=None, export_seconds="
            f"None) {out['wall_s']['export']:.1f} s (torch.export on the "
            f"card, the plain fbank), torch.export.load "
            f"{out['wall_s']['export_load']:.1f} s; model.pt2 against the "
            f"Predictor's kernel path on the exported model.pt: cos {held} "
            f"(bar 0.999); launches {out['launches']['export_predict']}")
        if not min(held.values()) > 0.999:
            raise AssertionError("the exported program disagrees with the "
                                 "kernel path")

        # -- infer_recognition: two users, then a third clip (16 s bucket) -
        t = time.perf_counter()
        third = os.path.join(work, "third.wav")
        write_wav(third, (np.sin(2 * np.pi * 140 * np.arange(192000) / 16000)
                          * 0.3 + 0.02 * rng.randn(192000)))
        db = os.path.join(work, "db")
        wav = lambda n: os.path.join(ROOT, "dataset", f"{n}.wav")  # noqa: E731
        text, launches, _ = run_cli("infer_recognition", [
            f"--configs={yml}", f"--device={dev.type}",
            f"--model_path={converted}",
            f"--audio_db_path={db}", "--threshold=-1.0",
            f"--register=alice={wav('a_1')}", f"--register=bob={wav('b_1')}",
            f"--recognize={third}"])
        out["launches"]["infer_recognition"] = launches
        lap("infer_recognition", t)
        rec_line = [ln for ln in text.splitlines()
                    if ln.startswith(("register ", "recognised", "no match",
                                      "registered users"))]
        out["infer_recognition"] = rec_line
        log(f"[workflow] {card}: infer_recognition (a subprocess): "
            f"{rec_line}; launches {launches}; "
            f"{out['wall_s']['infer_recognition']:.1f} s")
        if not (any(ln.startswith("recognised speaker: ") for ln in rec_line)
                and "registered users: ['alice', 'bob']" in rec_line
                and min(launches.values()) > 0):
            raise AssertionError("infer_recognition is wrong")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"]["phase"] = time.perf_counter() - t0
    log(f"[workflow] {card}: phase 11 wall {out['wall_s']['phase']:.1f} s: "
        f"{ {k: round(v, 1) for k, v in out['wall_s'].items()} }")
    return out


# ---- 12. data parallelism ----------------------------------------------------
P12_STEPS = 4            # DDP steps held against one process
P12_BATCH = 64           # the global batch: b32 on each of two ranks
# the bar on the cosine of the DDP run's parameter change against one
# process's. Adam's first steps move each weight by about the LR whatever
# its gradient's size, so weights of near-zero gradient move by rounding
# noise: on an NVIDIA H100 80GB HBM3 at 700 W two gloo ranks read
# 0.9984889 and the same steps with no gradient exchange 0.4309177 (and
# a loss 4.66e-2 apart); the fault must fail this bar and the loss's
P12_DELTA_COS = 0.99


def _kernel_modules():
    from voiceprintrecognition_paddlepaddle_torch.models import \
        fcm_kernel as fkm
    from voiceprintrecognition_paddlepaddle_torch.models import \
        trunk_kernel as tk
    from voiceprintrecognition_paddlepaddle_torch.ops import fbank_kernel as fk
    return fk, fkm, tk


def p12_steps(tr, batches, dev, rank=0, world=1):
    """``tr.train_step`` on this rank's rows of each global batch (rows
    ``[r n / w, (r + 1) n / w)``): the losses, the CUDA-event ms of each
    step and the kernel launches of the steps (counts set to 0 first)."""
    kernels = _kernel_modules()
    tr.model.train()
    tr.classifier.train()
    reset_launches(*kernels)
    losses, events = [], []
    for data, labels, lens in batches:
        n = data.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        x = [torch.from_numpy(a[rows]).to(dev) for a in (data, labels, lens)]
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        loss, _ = tr.train_step("waveforms", *x)
        e.record()
        losses.append(loss)
        events.append((s, e))
    launches = read_launches(*kernels)
    return ([float(x) for x in losses], [s.elapsed_time(e) for s, e in events],
            launches)


def p12_evaluate(tr):
    """``tr.evaluate()`` with the kernel counts set to 0 first: the EER,
    MinDCF, threshold, wall seconds and launches."""
    kernels = _kernel_modules()
    reset_launches(*kernels)
    t = time.perf_counter()
    eer, min_dcf, threshold = tr.evaluate()
    return {"eer": eer, "min_dcf": min_dcf, "threshold": threshold,
            "wall_s": time.perf_counter() - t,
            "launches": read_launches(*kernels)}


def collective_ms(numel, dev, iters):
    """Host ms of one all-reduce of ``numel`` fp32 on ``dev`` over the
    process group, synchronized on both ends (a mean of ``iters``)."""
    buf = torch.ones(numel, device=dev)
    torch.distributed.all_reduce(buf)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    for _ in range(iters):
        torch.distributed.all_reduce(buf)
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t) * 1e3 / iters


def calibrated_bn(model, feats):
    """A copy of ``model`` whose BatchNorm running statistics are the
    cumulative averages of the batch statistics over ``feats`` (a list of
    ``(features, ratios)``), the rest of its weights unchanged."""
    import copy

    from voiceprintrecognition_paddlepaddle_torch.models.layers import \
        BatchNorm

    cal = copy.deepcopy(model).train()
    bns = [m for m in cal.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    with torch.no_grad():
        for x, lens in feats:
            cal(x, lengths=lens)
    for m in bns:
        m.momentum = 0.1
    return cal.eval()


def parallel_rank(work):
    """Phase 12, one rank (``chip_smoke.py --phase12-rank <work>`` under
    the port's launcher): ``P12_STEPS`` DDP steps on this rank's share of
    each global batch, rank 0 saves an orbax (DCP) checkpoint; the same
    steps from the same weights with no gradient exchange (every step
    under DDP's ``no_sync``: each rank trains on its share alone), the
    fault the held steps must tell apart; one DDP step traced; every rank
    evaluates its shard of the lists with ``<work>/eval_model.pt``, and
    the collectives are timed alone. Rank 0 saves its weights after each
    run. Writes ``<work>/rank<r>.json``."""
    from voiceprintrecognition_paddlepaddle_torch.models import layers
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
    from voiceprintrecognition_paddlepaddle_torch.utils.checkpoint import \
        save_checkpoint

    with open(os.path.join(work, "phase12.json"), encoding="utf-8") as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    # true fp32 convs on both sides of the holds, the steps and the
    # evaluation (see parallel_phase)
    torch.backends.cudnn.allow_tf32 = False

    def trainer():
        tr = Trainer(spec["cfg"], device="cuda")
        tr._setup_dataloader(is_train=True)
        tr._setup_model(80, is_train=True)
        return tr

    def save_weights(tr, tag):
        for part in ("model", "classifier"):
            torch.save({k: v.cpu()
                        for k, v in getattr(tr, part).state_dict().items()},
                       os.path.join(work, f"{tag}_{part}.pt"))

    tr = trainer()
    rank, world, dev = tr.rank, tr.world, tr.device
    data = np.load(os.path.join(work, "batches.npz"))
    batches = [tuple(data[f"{k}{i}"] for k in ("data", "labels", "lens"))
               for i in range(P12_STEPS)]
    # the BatchNorm collectives of the steps, counted
    calls = {"all_gather_stacked": 0, "all_reduce_sum": 0}
    real = {name: getattr(layers, name) for name in calls}

    def counted(name):
        def call(*a):
            calls[name] += 1
            return real[name](*a)
        return call

    for name in calls:
        setattr(layers, name, counted(name))
    try:
        losses, step_ms, train_launches = p12_steps(tr, batches, dev, rank,
                                                    world)
    finally:
        for name, fn in real.items():
            setattr(layers, name, fn)
    out = {"rank": rank, "world": world, "device": str(dev),
           "backend": torch.distributed.get_backend(),
           "ddp": type(tr._net).__name__, "losses": losses,
           "step_ms": step_ms, "train_launches": train_launches,
           "bn_collectives_per_step": {k: v / P12_STEPS
                                       for k, v in calls.items()},
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    if rank == 0:
        save_weights(tr, "rank0")
        save_checkpoint(tr.configs, tr.train_state(),
                        os.path.join(work, "ckpt"), 1)
    torch.distributed.barrier()
    # the fault: the same steps, no gradient exchange on any of them
    fault = trainer()
    with fault._train_net().no_sync():
        out["nosync_losses"] = p12_steps(fault, batches, dev, rank, world)[0]
    if rank == 0:
        save_weights(fault, "nosync")
    del fault
    # one DDP step traced on each rank (every rank steps together)
    rows = slice(rank * P12_BATCH // world, (rank + 1) * P12_BATCH // world)
    first = [torch.from_numpy(a[rows]).to(dev) for a in batches[0]]
    out["trace"] = kernel_split(lambda: tr.train_step("waveforms", *first),
                                n_top=3)
    tr.model.load_state_dict(torch.load(os.path.join(work, "eval_model.pt")))
    out["eval"] = p12_evaluate(tr)
    if rank == 0:
        np.savez(os.path.join(work, "rank0_eval.npz"), **{
            f"{part}_{i}": (a.cpu().numpy() if torch.is_tensor(a) else a)
            for part, pair in tr.eval_embeddings.items()
            for i, a in enumerate(pair)})
    n_grad = sum(p.numel() for m in (tr.model, tr.classifier)
                 for p in m.parameters())
    out["grad_numel"] = n_grad
    out["grad_all_reduce_ms"] = collective_ms(n_grad, dev, 5)
    out["bn_all_reduce_ms"] = collective_ms(2 * 512 + 1, dev, 20)
    out["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(work, f"rank{rank}.json"), "w",
              encoding="utf-8") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def parallel_nccl(work):
    """Phase 12, NCCL at world 1 (``chip_smoke.py --phase12-nccl <work>``
    under the launcher with one rank): one DDP step on the first half of
    the first batch. Writes ``<work>/nccl.json``."""
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer

    with open(os.path.join(work, "phase12.json"), encoding="utf-8") as f:
        spec = json.load(f)
    tr = Trainer(spec["cfg"], device="cuda")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(80, is_train=True)
    data = np.load(os.path.join(work, "batches.npz"))
    half = P12_BATCH // 2
    batch = tuple(data[f"{k}0"][:half] for k in ("data", "labels", "lens"))
    losses, step_ms, launches = p12_steps(tr, [batch], tr.device)
    with open(os.path.join(work, "nccl.json"), "w", encoding="utf-8") as f:
        json.dump({"backend": torch.distributed.get_backend(),
                   "world": tr.world, "ddp": type(tr._net).__name__,
                   "loss": losses[0], "step_ms": step_ms[0],
                   "launches": launches}, f)
    torch.distributed.destroy_process_group()


def launch_ranks(nproc, flag, work, timeout):
    """``chip_smoke.py <flag> <work>`` on ``nproc`` ranks through the
    port's launcher; raises with the ranks' last output if any fails.
    Returns the wall seconds."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.launch_multihost", "--nproc",
         str(nproc), "--timeout", str(timeout), "--", sys.executable,
         os.path.abspath(__file__), flag, work], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout + 60)
    if proc.returncode != 0:
        raise RuntimeError(f"{flag} on {nproc} rank(s) failed "
                           f"({proc.returncode}):\n{proc.stderr[-6000:]}")
    return time.perf_counter() - t


def parallel_phase(dev, card, nproc=2):
    """Phase 12: data parallelism at the stock CAM++'s width on the card.
    ``nproc`` ranks through the port's launcher (two on cuda:0 by default:
    gloo with CUDA tensors; one a card over NCCL where there are as many
    cards): DDP steps at b64 / ``nproc`` each held against one process at
    b64 on the same batches, evaluate() at world ``nproc`` against world
    1, an orbax (DCP) checkpoint saved by rank 0; NCCL at world 1;
    Predictor over the DCP checkpoint and Predictor(data_parallel=True)
    over two replicas on cuda:0 (over every card where there are more).

    The held steps run cuDNN's convs in true fp32 on both sides: in TF32
    (PyTorch's default) b32 and b64 take other conv algorithms, whose
    rounding moved the loss by 8e-4 relative within 4 steps (this phase
    on an NVIDIA H100 80GB HBM3 at 700 W), next to the 1e-3 bar that
    holds DDP's semantics. The evaluations, at world 2 and world 1, run
    them in fp32 too: with TF32 allowed, cuDNN took a TF32 algorithm for
    some plain FCM conv in one process and a full fp32 one in another, in
    some runs only, so rank 0's gathered embeddings sat at cos 0.9976661
    of world 1's, which was the cosine of world 1's own embeddings in
    fp32 against TF32 (this phase on an NVIDIA H100 80GB HBM3 at 700 W).

    Both evaluations embed with the seeded initial weights whose BatchNorm
    statistics are calibrated on the held batches (``calibrated_bn``), one
    clip a batch (eval_conf.batch_size 1). With the initial statistics
    every clip embeds nearly alike: a world-1 evaluate() at eval batch 8
    and at batch 1 put its EER threshold at a score of 0.99999988 and gave
    EERs 0.3125 and 0.2738 from embeddings at cos 0.99999999 of each
    other, and world 2 against world 1 gave EERs 3.6e-2 apart from the
    same embeddings in another order (this phase on an NVIDIA H100 80GB
    HBM3 at 700 W): the EER followed the order of near-equal scores. One
    clip a batch gives each clip the same bucket at any world size."""
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer

    kernels = _kernel_modules()
    t0 = time.perf_counter()
    out = {"card": card}
    work = tempfile.mkdtemp(prefix="vpr_parallel_")
    try:
        lists = synth_corpus(work)
        cfg64, _ = train_config(lists, **{"dataset_conf.eval_conf.batch_size": 1})
        cfg_rank, _ = train_config(lists, **{
            "dataset_conf.sampler.batch_size": P12_BATCH // nproc,
            "dataset_conf.eval_conf.batch_size": 1,
            "train_conf.checkpoint_format": "orbax"})
        ref = Trainer(cfg64, device=dev)
        ref._setup_dataloader(is_train=True)
        ref._setup_model(80, is_train=True)
        theta0 = {f"{part}.{k}": v.detach().clone()
                  for part in ("model", "classifier")
                  for k, v in getattr(ref, part).state_dict().items()}
        it = iter(ref.train_loader)
        batches = [next(it)[1:] for _ in range(P12_STEPS)]
        cal = calibrated_bn(ref.model, [
            (ref.featurize("waveforms", *(torch.from_numpy(a).to(dev)
                                          for a in (data, lens))),
             torch.from_numpy(lens).to(dev)) for data, _, lens in batches])
        torch.save({k: v.cpu() for k, v in cal.state_dict().items()},
                   os.path.join(work, "eval_model.pt"))
        del cal
        np.savez(os.path.join(work, "batches.npz"), **{
            f"{k}{i}": a for i, b in enumerate(batches)
            for k, a in zip(("data", "labels", "lens"), b)})
        with open(os.path.join(work, "phase12.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"cfg": cfg_rank}, f)
        torch.cuda.empty_cache()

        # -- the ranks: DDP steps, DCP save, evaluate ------------------------
        out["ranks_wall_s"] = launch_ranks(nproc, "--phase12-rank", work, 420)
        ranks = []
        for r in range(nproc):
            with open(os.path.join(work, f"rank{r}.json"),
                      encoding="utf-8") as f:
                ranks.append(json.load(f))
        out["ranks"] = ranks
        for r in ranks:
            log(f"[parallel] {card}: rank {r['rank']} of {r['world']} on "
                f"{r['device']}, backend {r['backend']}, {r['ddp']}: losses "
                f"{[round(x, 5) for x in r['losses']]}, step ms "
                f"{[round(x, 1) for x in r['step_ms']]}, train launches "
                f"{r['train_launches']}; BN collectives a step "
                f"{r['bn_collectives_per_step']}; one all-reduce of the "
                f"{r['grad_numel']} gradient floats {r['grad_all_reduce_ms']:.2f}"
                f" ms, of 1025 floats {r['bn_all_reduce_ms']:.3f} ms (host "
                f"clock, alone); evaluate() EER {r['eval']['eer']:.6f} MinDCF "
                f"{r['eval']['min_dcf']:.6f} in {r['eval']['wall_s']:.2f} s, "
                f"launches {r['eval']['launches']}; peak "
                f"{r['peak_gb']:.2f} GB; rank wall {r['wall_s']:.1f} s")

        # -- one process at b64 on the same batches --------------------------
        torch.cuda.reset_peak_memory_stats(dev)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            ref_losses, ref_ms, ref_launches = p12_steps(ref, batches, dev)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        ddp_losses = [sum(x) / nproc
                      for x in zip(*(r["losses"] for r in ranks))]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ddp_losses,
                                                           ref_losses))

        def saved(tag):
            return {f"{part}.{k}": v for part in ("model", "classifier")
                    for k, v in torch.load(os.path.join(
                        work, f"{tag}_{part}.pt")).items()}

        want = {f"{part}.{k}": v for part in ("model", "classifier")
                for k, v in getattr(ref, part).state_dict().items()}
        got, fault = saved("rank0"), saved("nosync")
        names = [n for n in ref.param_names if n in want]

        def flat(d, base=None):
            return torch.cat([(d[n].double().to(dev) - (
                0 if base is None else base[n].double())).flatten()
                for n in names])

        def cos(a, b):
            return float((a @ b) / (a.norm() * b.norm()))

        param_cos = cos(flat(got), flat(want))
        # the parameters' change over the steps: what the gradients did
        step_want = flat(want, theta0)
        delta_cos = cos(flat(got, theta0), step_want)
        fault_cos = cos(flat(fault, theta0), step_want)
        leaf_cos = min((float(torch.nn.functional.cosine_similarity(
            got[n].double().flatten().to(dev), want[n].double().flatten(),
            dim=0)), n) for n in names if want[n].abs().max() > 0)
        stats_rel = max(float((got[n].to(dev) - want[n]).abs().max()
                              / max(float(want[n].abs().max()), 1e-6))
                        for n in want if "running_" in n)
        ddp_step = ms(ranks[0]["step_ms"][1:])
        ref_step = ms(ref_ms[1:])
        fault_rel = max(abs(a - b) / abs(b) for a, b in zip(
            [sum(x) / nproc for x in zip(*(r["nosync_losses"]
                                          for r in ranks))], ref_losses))
        share = ((ranks[0]["grad_all_reduce_ms"]
                  + sum(ranks[0]["bn_collectives_per_step"].values())
                  * ranks[0]["bn_all_reduce_ms"]) / ddp_step)
        out["train"] = {
            "ddp_losses": ddp_losses, "ref_losses": ref_losses,
            "loss_rel": loss_rel, "param_cos": param_cos,
            "delta_cos": delta_cos, "nosync_delta_cos": fault_cos,
            "nosync_loss_rel": fault_rel,
            "leaf_cos_min": leaf_cos, "bn_stats_rel": stats_rel,
            "ddp_step_ms": ddp_step, "ref_step_ms": ref_step,
            "ref_step_ms_all": ref_ms, "collective_share_est": share,
            "ref_launches": ref_launches,
            "ref_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        log(f"[parallel] {card}: {P12_STEPS} DDP steps, {nproc} ranks x "
            f"b{P12_BATCH // nproc} x 3 s, against one process at b64 x 3 s "
            f"on the same "
            f"batches: mean rank loss {[round(x, 5) for x in ddp_losses]} vs "
            f"{[round(x, 5) for x in ref_losses]} (fp32 convs; rel "
            f"{loss_rel:.2e}, bar "
            f"1e-3); parameters after {P12_STEPS} steps cos {param_cos:.7f} "
            f"(bar 0.9999), leaf min {leaf_cos[0]:.6f} ({leaf_cos[1]}); their "
            f"change over the steps cos {delta_cos:.7f} (bar {P12_DELTA_COS}"
            f"); the same steps with no gradient exchange (no_sync on each): "
            f"change cos {fault_cos:.7f}, loss rel {fault_rel:.2e} (must "
            f"fail both bars); BN statistics rel {stats_rel:.2e} (bar 1e-3); "
            f"step {ddp_step:.2f} ms (rank 0, "
            f"steps 2-{P12_STEPS}, CUDA events) vs one process "
            f"{ref_step:.2f} ms; collectives timed alone, an estimate of "
            f"{100 * share:.1f} % of the DDP step")
        n_cards = torch.cuda.device_count()
        backend = "nccl" if nproc <= n_cards else "gloo"
        if fault_cos >= P12_DELTA_COS or fault_rel < 1e-3:
            raise AssertionError("the held steps cannot tell a DDP run "
                                 "without the gradient exchange apart")
        if not (loss_rel < 1e-3 and param_cos >= 0.9999
                and delta_cos >= P12_DELTA_COS and stats_rel <= 1e-3
                and all(r["ddp"] == "DistributedDataParallel"
                        and r["backend"] == backend and r["world"] == nproc
                        and r["device"] == f"cuda:{r['rank'] % n_cards}"
                        for r in ranks)
                and all(n == P12_STEPS for n in
                        (r["train_launches"]["fbank"] for r in ranks))
                and ref_launches["fbank"] == P12_STEPS):
            raise AssertionError("the DDP steps disagree with one process, or "
                                 "a rank did not run on its card under DDP")

        # -- one step traced: a rank under DDP against one process ----------
        torch.backends.cudnn.allow_tf32 = False
        try:
            b0 = [torch.from_numpy(a).to(dev) for a in batches[0]]
            ref_trace = kernel_split(lambda: ref.train_step("waveforms", *b0),
                                     n_top=3)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        out["trace"] = {"rank0": ranks[0]["trace"], "one_process": ref_trace}
        for name, tr_, step in (
                (f"rank 0 of {nproc} at b{P12_BATCH // nproc}",
                 ranks[0]["trace"], ddp_step),
                (f"one process at b{P12_BATCH}", ref_trace, ref_step)):
            log(f"[parallel] {card}: one step traced (torch.profiler), "
                f"{name}: device {tr_['traced_ms']:.2f} ms of a {step:.2f} ms "
                f"step (busy {100 * tr_['traced_ms'] / step:.1f} %), "
                f"{tr_['device_ops']} device operations, NCCL kernels "
                f"{tr_['nccl_ms']:.3f} ms, copies {tr_['memcpy_ms']:.3f} ms; "
                f"top " + "; ".join(f"{k} {v:.3f} ms" for k, v in tr_["top"]))

        # -- evaluate() at world 1 with the same weights ---------------------
        ev1 = Trainer(cfg64, device=dev)
        ev1._setup_dataloader()
        ev1._setup_model(80)
        ev1.model.load_state_dict(torch.load(
            os.path.join(work, "eval_model.pt")))
        # in fp32 convs, as the ranks; then once in TF32 (PyTorch's
        # default): how far the precision of cuDNN's convs moves these
        # embeddings (none since the FCM kernel serves every bucket)
        torch.backends.cudnn.allow_tf32 = False
        try:
            world1 = p12_evaluate(ev1)
            emb_fp32 = {k: v[0].clone()
                        for k, v in ev1.eval_embeddings.items()}
            torch.backends.cudnn.allow_tf32 = True
            ev1.evaluate()
            world1["tf32_vs_fp32_cos_min"] = min(
                cos_min(ev1.eval_embeddings[k][0].cpu(), v.cpu())
                for k, v in emb_fp32.items())
            ev1.eval_embeddings = {k: (emb_fp32[k], v[1])
                                   for k, v in ev1.eval_embeddings.items()}
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        out["eval_world1"] = world1
        diffs = [abs(r["eval"][k] - world1[k]) for r in ranks
                 for k in ("eer", "min_dcf")]
        # rank 0's gather against world 1's rows in rank order (rank r
        # embeds clips r, r + 2, ...)
        gathered = np.load(os.path.join(work, "rank0_eval.npz"))
        emb_cos, labels_equal = [], True
        for part, (emb, labels) in ev1.eval_embeddings.items():
            n = len(labels)
            order = np.concatenate([np.arange(n)[r::nproc]
                                    for r in range(nproc)])
            emb_cos.append(cos_min(torch.from_numpy(gathered[f"{part}_0"]),
                                   emb[order].cpu()))
            labels_equal &= bool(np.array_equal(gathered[f"{part}_1"],
                                                labels[order]))
        world1["gather_cos_min"] = min(emb_cos)
        log(f"[parallel] {card}: evaluate() at world 1 (the initial weights, "
            f"BN statistics calibrated): EER {world1['eer']:.6f} MinDCF "
            f"{world1['min_dcf']:.6f}, threshold {world1['threshold']:.6f} in "
            f"{world1['wall_s']:.2f} s, launches {world1['launches']}; world "
            f"{nproc} ranks against it: max |d| {max(diffs):.2e} (bar 1e-6); "
            f"rank 0's gathered embeddings against world 1's in rank order: cos "
            f"min {min(emb_cos):.7f} (bar 0.9999), labels equal "
            f"{labels_equal} (fp32 convs on both sides); world 1 in TF32 "
            f"against fp32: cos min {world1['tf32_vs_fp32_cos_min']:.7f}")
        if not (max(diffs) <= 1e-6 and labels_equal and min(emb_cos) >= 0.9999
                and all(min(r["eval"]["launches"].values()) > 0
                        for r in ranks)
                and min(world1["launches"].values()) > 0):
            raise AssertionError("evaluate() at world 2 disagrees with world "
                                 "1, or a rank's evaluation skipped a kernel")

        # -- NCCL at world 1 -------------------------------------------------
        torch.cuda.empty_cache()
        out["nccl_wall_s"] = launch_ranks(1, "--phase12-nccl", work, 300)
        with open(os.path.join(work, "nccl.json"), encoding="utf-8") as f:
            nccl = json.load(f)
        out["nccl"] = nccl
        log(f"[parallel] {card}: one rank, backend {nccl['backend']}, "
            f"{nccl['ddp']}: one step b32 x 3 s, loss {nccl['loss']:.5f}, "
            f"{nccl['step_ms']:.1f} ms (first step: DDP and NCCL set up), "
            f"launches {nccl['launches']}; {out['nccl_wall_s']:.1f} s")
        if not (nccl["backend"] == "nccl" and nccl["world"] == 1
                and nccl["ddp"] == "DistributedDataParallel"
                and np.isfinite(nccl["loss"])
                and nccl["launches"]["fbank"] == 1):
            raise AssertionError("the NCCL step did not run")

        # -- Predictor: the DCP checkpoint; data parallel --------------------
        rng = np.random.RandomState(SEED + 12)
        clips = [(rng.randn(int(rng.uniform(1.0, 8.0) * 16000)) * 0.1)
                 .astype(np.float32) for _ in range(11)]
        clips.append((rng.randn(16 * 16000) * 0.1).astype(np.float32))
        ckpt = os.path.join(work, "ckpt", "CAMPPlus_Fbank", "epoch_1")
        pt = os.path.join(work, "rank0_model.pt")
        one_pt = Predictor(cfg64, model_path=pt, device=dev)
        one_dcp = Predictor(cfg64, model_path=ckpt, device=dev)
        dp = Predictor(cfg64, model_path=ckpt, device=dev, data_parallel=True,
                       devices=[dev, dev] if n_cards == 1 else None)
        e_pt = torch.from_numpy(one_pt.predict_batch(clips))
        e_dcp = torch.from_numpy(one_dcp.predict_batch(clips))
        reset_launches(*kernels)
        t = time.perf_counter()
        e_dp = torch.from_numpy(dp.predict_batch(clips))
        dp_wall = time.perf_counter() - t
        dp_launches = read_launches(*kernels)
        pred = {"files": sorted(os.listdir(ckpt)),
                "dcp_vs_pt_cos": cos_min(e_dcp, e_pt),
                "dp_vs_one_cos": cos_min(e_dp, e_pt),
                "replicas": [str(d) for d, _, _ in dp._replicas],
                "dp_wall_s": dp_wall, "dp_launches": dp_launches}
        out["predictor"] = pred
        log(f"[parallel] {card}: the orbax checkpoint saved at world {nproc} "
            f"holds {pred['files']}; Predictor(model.dcp) against "
            f"Predictor(model.pt) of the same weights cos "
            f"{pred['dcp_vs_pt_cos']:.7f}; Predictor(data_parallel=True, "
            f"devices={pred['replicas']}) over 11 clips of 1-8 s and one of "
            f"16 s against one device cos {pred['dp_vs_one_cos']:.7f} (bars "
            f"0.9999), {dp_wall:.2f} s, launches {dp_launches}")
        if not (pred["dcp_vs_pt_cos"] >= 0.9999
                and pred["dp_vs_one_cos"] >= 0.9999
                and "model.dcp" in pred["files"]
                and min(dp_launches.values()) >= len(dp._replicas)):
            raise AssertionError("the DCP checkpoint or the data-parallel "
                                 "Predictor is wrong")
        out["launches"] = {
            **{f"rank{r['rank']}_train": r["train_launches"] for r in ranks},
            **{f"rank{r['rank']}_eval": r["eval"]["launches"] for r in ranks},
            "world1_eval": world1["launches"], "nccl_step": nccl["launches"],
            "predictor_dp": dp_launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[parallel] {card}: phase 12 wall {out['wall_s']:.1f} s (ranks "
        f"{out['ranks_wall_s']:.1f} s, NCCL {out['nccl_wall_s']:.1f} s)")
    return out


# ---- 13. the last modules ----------------------------------------------------
P13_F0S = (130, 210, 290, 370)   # tests/test_predictor.py: 130 + 80 * spk
P13_TURN_S, P13_GAP_S = 4.0, 0.8


def p13_tone(f0, seconds, seed, amp=0.3):
    """A tone speaker (``tests/test_predictor.py`` ``_tone``)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    sig = sum(np.sin(2 * np.pi * f0 * h * t + rng.rand()) / h
              for h in range(1, 5))
    return (amp * (sig + 0.05 * rng.randn(len(t)))).astype(np.float32)


def p13_config(train_list):
    """``tests/test_predictor.py`` ``_configs`` with the stock CAM++ of
    ``configs/cam++.yml`` (192-d, its 80-mel Fbank) over 4 speakers, and
    the recipe of its diarization bar: 40 epochs, learning rate 0.05,
    ``dataset.seed`` 7."""
    import copy

    return {
        "dataset_conf": {
            "dataset": {"min_duration": 0.3, "max_duration": 1.0,
                        "sample_rate": 16000, "use_dB_normalization": True,
                        "target_dB": -20, "seed": 7},
            "sampler": {"batch_size": 8, "shuffle": True, "drop_last": True},
            # one loader thread: two draw the clips' crops from one
            # generator in whichever order the host schedules them
            "dataLoader": {"num_workers": 1},
            "eval_conf": {"batch_size": 4, "max_duration": 2},
            "train_list": train_list, "enroll_list": None,
            "trials_list": None},
        "preprocess_conf": copy.deepcopy(CONFIG["preprocess_conf"]),
        "model_conf": {"model": "CAMPPlus",
                       "model_args": dict(CONFIG["model_conf"]["model_args"]),
                       "classifier": {"classifier_type": "Cosine",
                                      "num_speakers": 4, "num_blocks": 0}},
        "loss_conf": {"loss": "AAMLoss",
                      "loss_args": {"margin": 0.2, "scale": 32}},
        "optimizer_conf": {"optimizer": "Adam", "optimizer_args": {},
                           "scheduler": "WarmupCosineSchedulerLR",
                           "scheduler_args": {"learning_rate": 0.05,
                                              "min_lr": 1.0e-5,
                                              "warmup_epoch": 1}},
        "train_conf": {"enable_amp": False, "max_epoch": 40,
                       "log_interval": 10},
    }


def p13_conversation(path, order, seed0):
    """Turns of ``P13_TURN_S`` s by the speakers ``order`` (f0s of
    ``P13_F0S``) with ``P13_GAP_S`` s of silence between, fresh seeds;
    written to ``path``. Returns the reference [(start, end, "spk<k>")]."""
    pieces, reference, t0 = [], [], 0.0
    for i, spk in enumerate(order):
        pieces.append(p13_tone(P13_F0S[spk], P13_TURN_S,
                               seed=seed0 + 17 * i + spk))
        reference.append((t0, t0 + P13_TURN_S, f"spk{spk}"))
        t0 += P13_TURN_S
        if i != len(order) - 1:
            pieces.append(np.zeros(int(P13_GAP_S * 16000), np.float32))
            t0 += P13_GAP_S
    write_wav(path, np.concatenate(pieces))
    return reference


def p13_score(reference, segments, path):
    """DER of ``segments`` after a round trip through an RTTM file at
    ``path`` (the port's ``write_rttm`` / ``load_rttm``), detailed."""
    from voiceprintrecognition_paddlepaddle_torch.infer_utils.der import (
        diarization_error_rate, load_rttm, write_rttm)

    with open(path, "w", encoding="utf-8") as f:
        write_rttm(f, "synth", segments)
    return diarization_error_rate(reference, load_rttm(path)["synth"],
                                  detailed=True)


def p13_names_ok(reference, hypothesis):
    """Each reference turn's most-overlapping hypothesis label is the
    turn's own speaker name."""
    for s, e, name in reference:
        overlap = {}
        for hs, he, label in hypothesis:
            overlap[label] = overlap.get(label, 0.0) + max(
                0.0, min(e, he) - max(s, hs))
        if not overlap or max(overlap, key=overlap.get) != name:
            return False
    return True


def p13_margins(model_pt, dev, refs, paths, db_root):
    """What phase 13's RTTM flow names each cluster from, as
    ``infer_data`` computes it (its config, threshold, audio_db and
    clustering, in this process): per conversation, per cluster, the
    speaker whose turns it holds most of, the cosine of the cluster's
    center to that speaker's mean voiceprint (``score``; the name needs
    >= 0.6) and that cosine less the nearest other speaker's
    (``margin``; the name needs > 0)."""
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor

    out = {}
    for name, ref in refs.items():
        db = os.path.join(db_root, name)
        pred = Predictor(configs="configs/cam++.yml", model_path=model_pt,
                         threshold=0.6, audio_db_path=db, device=dev)
        try:
            segments = pred.speaker_diarize.segments_audio(
                pred._load_audio(paths[name]))
            feats = pred.predict_batch([s[2] for s in segments])
            labels, centers = pred.speaker_diarize.clustering(feats)
            turns = pred.speaker_diarize.postprocess(segments, labels)
        finally:
            index = os.path.join(db, "audio_indexes.bin")
            if os.path.exists(index):
                os.remove(index)
        sims = (pred.normalize_features(np.asarray(centers, np.float32))
                @ pred.normalize_features(
                    pred.audio_feature_mean.astype(np.float32)).T)
        rows = []
        for k in range(len(centers)):
            held = {}
            for o in turns:
                if o["speaker"] == k:
                    for s, e, spk in ref:
                        held[spk] = held.get(spk, 0.0) + max(
                            0.0, min(e, o["end"]) - max(s, o["start"]))
            true = max(held, key=held.get) if held else None
            if true not in pred.users_name_mean:
                rows.append({"speaker": true, "score": None, "margin": None})
                continue
            i = pred.users_name_mean.index(true)
            rows.append({"speaker": true, "score": float(sims[k, i]),
                         "margin": float(sims[k, i] - np.delete(
                             sims[k], i).max())})
        out[name] = rows
    return out


class fp32_convs:
    """cuDNN convs in true fp32 (TF32 off) inside the block."""

    def __enter__(self):
        self.tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.tf32
        return False


class p13_deterministic:
    """cuDNN's deterministic algorithms without autotuning and PyTorch's
    deterministic kernels inside the block, so that phase 13's training
    gives the same weights, and so the same diarization, on every run.
    An op with no deterministic version warns; the set of such warnings
    is ``self.ops``."""

    def __enter__(self):
        import warnings

        self.saved = (torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled(),
                      torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark,
                      os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        self._catch.__exit__(*exc)
        self.ops = sorted({str(w.message).splitlines()[0] for w in self._seen
                           if "determinis" in str(w.message)})
        on, warn_only, det, bench, cublas = self.saved
        torch.use_deterministic_algorithms(on, warn_only=warn_only)
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
        return False


def state_digest(model):
    """SHA-256 of a module's state (names and bytes), its first 16 hex
    digits: equal digests, equal weights."""
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


class kaldi_featurizer:
    """The Predictor's Fbank and masked CMN through ``kaldi.fbank`` (plain
    PyTorch in fp32): a featurizer that launches no kernel."""
    dither = 0.0

    def __init__(self, method_args):
        self.method_args = dict(method_args)

    def __call__(self, waveforms, input_lens_ratio=None, rng=None):
        from voiceprintrecognition_paddlepaddle_torch.ops import (features,
                                                                   kaldi)

        return features.apply_cmn_and_mask(
            kaldi.fbank(waveforms, **self.method_args), input_lens_ratio)


def p13_chunk_cos(pred, plain, chunks):
    """Cosines (min, mean) of the diarization chunk embeddings: as served
    (``predict_batch``: the kernel path, each chunk padded to its bucket)
    against the plain version of the same path (``fbank_fused_reference``,
    ``fcm_reference`` and ``trunk_stats_reference`` on the same padded
    batch); the kernel path at exact length against the fp32 model at
    exact length (``kaldi.fbank``, CMN, the eager CAM++: the kernels' bf16
    design alone); as served against the fp32 model at exact length (that
    and the bucket padding); as served against the fp32 plain Predictor
    (``plain``: its eager model at the same padding)."""
    from voiceprintrecognition_paddlepaddle_torch.data_utils.collate import \
        bucket_length
    from voiceprintrecognition_paddlepaddle_torch.models import \
        fcm_kernel as fkm
    from voiceprintrecognition_paddlepaddle_torch.models import \
        trunk_kernel as tk
    from voiceprintrecognition_paddlepaddle_torch.ops import features
    from voiceprintrecognition_paddlepaddle_torch.ops.fbank_kernel import \
        fbank_fused_reference

    model, dev = pred.model, pred.device
    n = len(chunks[0])
    if any(len(c) != n for c in chunks):
        raise AssertionError("diarization chunks of unequal length")
    exact = torch.from_numpy(np.stack(chunks)).to(dev)
    length = bucket_length(n)
    padded = torch.nn.functional.pad(exact, (0, length - n))
    ratios = np.full(len(chunks), n / length, np.float32)
    with torch.no_grad():
        served = torch.from_numpy(pred.predict_batch(chunks)).to(dev)
        feats = features.apply_cmn_and_mask(
            fbank_fused_reference(padded, sr=16000, n_mels=80), ratios)
        t_valid, _ = tk.trunk_geometry(feats.shape[1])
        stats = tk.trunk_stats_reference(
            tk.pack_trunk(model),
            fkm.fcm_reference(fkm.pack_fcm(model), feats),
            tk.tvalids_from_ratios(ratios, t_valid))
        plain_version = model.DenseBN_0(stats).float()
        kernel_exact = pred._embed(exact, None)
        with fp32_convs():
            fp32_exact = model(plain._audio_featurizer(exact)).float()
            fp32_served = torch.from_numpy(
                plain.predict_batch(chunks)).to(dev)

    def cos(a, b):
        c = torch.nn.functional.cosine_similarity(a.double(), b.double(),
                                                  dim=1)
        return [float(c.min()), float(c.mean())]

    return {"served vs its plain version": cos(served, plain_version),
            "exact length: kernel path vs fp32": cos(kernel_exact,
                                                     fp32_exact),
            "served vs fp32 at exact length": cos(served, fp32_exact),
            "served vs the fp32 Predictor": cos(served, fp32_served)}


def last_modules_phase(dev, card):
    """Phase 13: the stock CAM++ trained on the card by the port's
    Trainer (the recipe of ``tests/test_predictor.py``'s diarization bar)
    and served by ``Predictor.speaker_diarization``: (a) the quality bar on
    the kernel path and on the fp32 plain model; (b) the RTTM evaluation
    flow (``eval_speaker_diarization.infer_data`` and ``compute_metrics``
    as child processes); (c) ``eval_from_paddle`` (a child process)
    against in-process ``Trainer.evaluate`` and ``Predictor.contrast``; (d)
    the GUI actions; (e) the wall time of each step."""
    import pickle

    from voiceprintrecognition_paddlepaddle_torch import (
        infer_contrast_gui, infer_recognition_gui,
        infer_speaker_diarization_gui)
    from voiceprintrecognition_paddlepaddle_torch.infer_utils.der import (
        load_rttm, write_rttm)
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer

    fk, fkm, tk = _kernel_modules()
    t0 = time.perf_counter()
    out = {"card": card, "wall_s": {}, "launches": {}}
    work = tempfile.mkdtemp(prefix="vpr_phase13_")

    def lap(name, t):
        out["wall_s"][name] = time.perf_counter() - t
        log(f"[phase13] {card}: {name} {out['wall_s'][name]:.2f} s")

    try:
        # -- (a) train the stock CAM++ on 4 tone speakers -------------------
        t = time.perf_counter()
        lines = []
        for spk, f0 in enumerate(P13_F0S):
            for u in range(4):
                p = os.path.join(work, f"s{spk}_u{u}.wav")
                write_wav(p, p13_tone(f0, 1.2, seed=spk * 10 + u))
                lines.append(f"{p}\t{spk}")
        train_list = os.path.join(work, "train_list.txt")
        with open(train_list, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        cfg = p13_config(train_list)
        with p13_deterministic() as det:
            tr = Trainer(cfg, device=dev)
            tr.train(save_model_path="", log_dir="", do_eval=False)
        model_pt = os.path.join(work, "model", "model.pt")
        os.makedirs(os.path.dirname(model_pt))
        torch.save({k: v.detach().cpu() for k, v in
                    tr.model.state_dict().items()}, model_pt)
        bn_var = [m.running_var.min().item() for m in tr.model.modules()
                  if isinstance(m, (torch.nn.BatchNorm1d,
                                    torch.nn.BatchNorm2d))]
        out["train"] = {"steps": tr.step, "loss": float(tr.train_loss),
                        "acc": float(tr.train_acc),
                        "bn_running_var_min": min(bn_var),
                        "digest": state_digest(tr.model),
                        "nondeterministic_ops": det.ops}
        lap("train", t)
        log(f"[phase13] {card}: Trainer.train() of the stock CAM++ (192-d) "
            f"on 4 tone speakers x 4 clips of 1.2 s, 40 epochs at lr 0.05, "
            f"seed 7, deterministic algorithms, one loader thread: "
            f"{out['train']}")
        trained = tr.model
        del tr

        # -- (a) the quality bar: the kernel path, then the fp32 model ------
        conv = os.path.join(work, "conversation.wav")
        reference = p13_conversation(conv, [0, 1, 2, 0, 1, 2], 0)
        pred = Predictor(cfg, model_path=model_pt, device=dev)
        if pred._embed is None:
            raise AssertionError("the stock CAM++ did not take the kernel path")
        t = time.perf_counter()
        reset_launches(fk, fkm, tk)
        segs = pred.speaker_diarization(conv, speaker_num=3)
        out["launches"]["diarize"] = read_launches(fk, fkm, tk)
        lap("diarize_kernel_path", t)
        # the fp32 side: kaldi.fbank and the eager model, no kernel
        plain = Predictor(cfg, model_path=model_pt, device=dev)
        plain._embed = None
        plain._replicas = [(d, m, None) for d, m, _ in plain._replicas]
        plain._audio_featurizer = kaldi_featurizer(
            cfg["preprocess_conf"]["method_args"])
        t = time.perf_counter()
        reset_launches(fk, fkm, tk)
        with fp32_convs():
            segs32 = plain.speaker_diarization(conv, speaker_num=3)
        out["launches"]["diarize_fp32"] = read_launches(fk, fkm, tk)
        lap("diarize_fp32", t)
        chunks = [np.asarray(c[2], np.float32) for c in
                  pred.speaker_diarize.segments_audio(pred._load_audio(conv))]
        cos = p13_chunk_cos(pred, plain, chunks)
        out["quality"] = {
            "kernel_path": p13_score(reference, segs,
                                     os.path.join(work, "hyp_k.rttm")),
            "fp32": p13_score(reference, segs32,
                              os.path.join(work, "hyp_32.rttm")),
            "speakers": {"kernel_path": len({s["speaker"] for s in segs}),
                         "fp32": len({s["speaker"] for s in segs32})},
            "chunks": len(chunks), "chunk_cos": cos}
        q = out["quality"]
        for name in ("kernel_path", "fp32"):
            r = q[name]
            log(f"[phase13] {card}: diarization of a 6-turn 3-speaker "
                f"conversation ({P13_TURN_S} s turns, {P13_GAP_S} s gaps), "
                f"{name}: {q['speakers'][name]} speakers, DER "
                f"{r['diarization error rate']:.5f}, false alarm "
                f"{r['false alarm']:.5f}, missed detection "
                f"{r['missed detection']:.5f}, confusion "
                f"{r['confusion']:.5f} (bars: 3 speakers, DER < 0.20, "
                f"confusion < 0.05)")
        log(f"[phase13] {card}: {q['chunks']} chunk embeddings, cos min / "
            f"mean: " + "; ".join(f"{k} {c[0]:.6f} / {c[1]:.6f}" for k, c in
                                  cos.items())
            + f" (bars: served vs plain version min 0.9999, exact length "
            f"min 0.999); the trained model's smallest BN running variance "
            f"{out['train']['bn_running_var_min']:.3e}; launches: kernel "
            f"path {out['launches']['diarize']}, fp32 path "
            f"{out['launches']['diarize_fp32']}")
        for name in ("kernel_path", "fp32"):
            r = q[name]
            if not (q["speakers"][name] == 3
                    and r["diarization error rate"] < 0.20
                    and r["confusion"] < 0.05):
                raise AssertionError(f"diarization misses the bar on the "
                                     f"{name} path: {r}")
        if not (out["launches"]["diarize"]["fbank"] > 0
                and out["launches"]["diarize"]["campplus_trunk"] > 0):
            raise AssertionError("diarization did not run the kernels")
        if any(out["launches"]["diarize_fp32"].values()):
            raise AssertionError("the fp32 path launched a kernel")
        if not (cos["served vs its plain version"][0] >= 0.9999
                and cos["exact length: kernel path vs fp32"][0] >= 0.999):
            raise AssertionError(f"kernel-path chunk embeddings disagree: "
                                 f"{cos}")

        # -- (b) the RTTM flow: infer_data and compute_metrics --------------
        t = time.perf_counter()
        db_root = os.path.join(work, "audio_db")
        data_list = os.path.join(work, "data_list.txt")
        refs = {}
        with open(data_list, "w", encoding="utf-8") as f:
            for c, (name, order) in enumerate(
                    (("conv_a", [0, 2, 1, 2, 0, 1]),
                     ("conv_b", [1, 0, 2, 0, 2, 1]))):
                path = os.path.join(work, f"{name}.wav")
                refs[name] = p13_conversation(path, order, 1000 * (c + 1))
                f.write(f"{path}\t{name}\n")
                for spk in range(3):
                    d = os.path.join(db_root, name, f"spk{spk}")
                    os.makedirs(d)
                    for n in range(2):
                        write_wav(os.path.join(d, f"{n}.wav"), p13_tone(
                            P13_F0S[spk], 2.0, seed=5000 + 100 * c
                            + 10 * spk + n))
        references = os.path.join(work, "references.rttm")
        with open(references, "w", encoding="utf-8") as f:
            for name, ref in refs.items():
                write_rttm(f, name, [{"speaker": s, "start": a, "end": b}
                                     for a, b, s in ref])
        hypotheses = os.path.join(work, "hypotheses.rttm")
        _, launches, _ = run_cli("eval_speaker_diarization.infer_data", [
            "--configs=configs/cam++.yml", f"--device={dev.type}",
            f"--model_path={model_pt}", f"--data_list_path={data_list}",
            f"--result_path={hypotheses}", f"--audio_db_path={db_root}"])
        out["launches"]["infer_data"] = launches
        lap("infer_data", t)
        t = time.perf_counter()
        text, _, metrics = run_cli("eval_speaker_diarization.compute_metrics",
                                   [f"--references={references}",
                                    f"--hypotheses={hypotheses}"])
        lap("compute_metrics", t)
        hyp = load_rttm(hypotheses)
        named = {name: p13_names_ok(refs[name], hyp.get(name, []))
                 for name in refs}
        margins = p13_margins(model_pt, dev, refs, {
            name: os.path.join(work, f"{name}.wav") for name in refs},
            db_root)
        out["rttm_flow"] = {"metrics": metrics, "named": named,
                            "labels": sorted({s for h in hyp.values()
                                              for _, _, s in h}),
                            "margins": margins}
        log(f"[phase13] {card}: infer_data (a child process) over 2 "
            f"conversations, each with its own audio_db: launches "
            f"{launches}; compute_metrics: {metrics}; labels "
            f"{out['rttm_flow']['labels']}, each turn named by its speaker: "
            f"{named} (bars: DER < 0.20, names)")
        log(f"[phase13] {card}: naming margins per cluster (speaker, cosine "
            f"to its voiceprint, less the nearest other's): " + "; ".join(
                f"{name} " + ", ".join(
                    f"{r['speaker']} {r['score']:.4f} {r['margin']:+.4f}"
                    if r["margin"] is not None else f"{r['speaker']} -"
                    for r in rows) for name, rows in margins.items()))
        if not (metrics["diarization error rate"] < 0.20
                and all(named.values()) and launches["fbank"] > 0
                and launches["campplus_trunk"] > 0):
            raise AssertionError(f"the RTTM flow is wrong: {out['rttm_flow']}"
                                 f"\n{text}")

        # -- (c) eval_from_paddle on (a)'s weights as a .pdparams ----------
        t = time.perf_counter()
        pd_dir = os.path.join(work, "paddle")
        os.makedirs(pd_dir)
        rng = np.random.RandomState(SEED + 13)
        lists = [os.path.join(pd_dir, f"{p}_list.txt")
                 for p in ("train", "enroll", "trials")]
        with open(lists[0], "w", encoding="utf-8") as f:
            f.write(f"{os.path.join(work, 's0_u0.wav')}\t0\n")
        for part, n, path in (("enroll", 1, lists[1]), ("trials", 2, lists[2])):
            with open(path, "w", encoding="utf-8") as f:
                # the 4 trained speakers and 4 between them
                for k, f0 in enumerate(sorted(P13_F0S + (170, 250, 330, 410))):
                    for u in range(n):
                        p = os.path.join(pd_dir, f"{part}{k}_{u}.wav")
                        write_wav(p, p13_tone(f0, rng.uniform(3.0, 20.0),
                                              seed=9000 + 10 * k + u + n))
                        f.write(f"{p}\t{k}\n")
        yml = yaml_with_lists(os.path.join(pd_dir, "cam.yml"), lists)
        args = dict(CONFIG["model_conf"]["model_args"])
        pdparams = os.path.join(pd_dir, "model.pdparams")
        with open(pdparams, "wb") as f:
            pickle.dump(pdparams_of(trained, args), f)
        converted = os.path.join(pd_dir, "converted")
        common = ["--configs", yml, "--pdparams", pdparams, "--workdir",
                  converted, "--device", dev.type]
        _, launches, got = run_cli("eval_from_paddle", common)
        out["launches"]["eval_from_paddle"] = launches
        lap("eval_from_paddle", t)
        back = torch.load(os.path.join(converted, "model.pt"),
                          weights_only=True)
        same_weights = all(torch.equal(back[k].cpu(), v.cpu()) for k, v in
                           trained.state_dict().items()
                           if not k.endswith("num_batches_tracked"))
        t = time.perf_counter()
        want = Trainer(load_yaml(yml), device=dev).evaluate(
            resume_model=converted)
        lap("evaluate_in_process", t)
        diffs = [abs(got[k] - w) for k, w in
                 zip(("eer", "min_dcf", "threshold"), want)]
        with open(lists[1], encoding="utf-8") as f:
            a = [ln.split("\t")[0] for ln in f.read().splitlines()]
        t = time.perf_counter()
        _, launches, pr = run_cli("eval_from_paddle",
                                  common + ["--predict", a[0], a[1]])
        out["launches"]["eval_from_paddle_predict"] = launches
        lap("eval_from_paddle_predict", t)
        score = Predictor(load_yaml(yml), model_path=converted,
                          device=dev).contrast(a[0], a[1])
        out["eval_from_paddle"] = {
            "child": got, "in_process": dict(zip(("eer", "min_dcf",
                                                  "threshold"), want)),
            "abs_diff": diffs, "predict": pr["score"],
            "contrast_in_process": score, "same_weights": same_weights}
        log(f"[phase13] {card}: eval_from_paddle (a child process) on (a)'s "
            f"trained CAM++ written as a .pdparams (converted back "
            f"bit-equal: {same_weights}) over 8 tone speakers x (1 enroll "
            f"+ 2 trials) clips of 3-20 s: EER {got['eer']:.6f}, MinDCF "
            f"{got['min_dcf']:.6f}, threshold {got['threshold']:.6f}; "
            f"in-process Trainer.evaluate {want}; |d| {diffs} (bar 1e-6); "
            f"launches {out['launches']['eval_from_paddle']}; --predict "
            f"{pr['score']:.6f} against Predictor.contrast {score:.6f} (bar "
            f"1e-5), launches {launches}")
        if not (same_weights and max(diffs) <= 1e-6
                and abs(pr["score"] - score) <= 1e-5
                and min(out["launches"]["eval_from_paddle"].values()) > 0):
            raise AssertionError("eval_from_paddle disagrees with the "
                                 "in-process evaluation or missed a kernel")

        # -- (d) the GUI actions on the trained checkpoint ------------------
        t = time.perf_counter()
        clip = {}
        for key, (spk, seed) in {"s0_a": (0, 7000), "s0_b": (0, 7001),
                                 "s0_c": (0, 7002), "s1": (1, 7003)}.items():
            clip[key] = os.path.join(work, f"{key}.wav")
            write_wav(clip[key], p13_tone(P13_F0S[spk], 2.0, seed=seed))
        stream = p13_tone(P13_F0S[0], 3.0, seed=7004)
        reset_launches(fk, fkm, tk)
        contrast = infer_contrast_gui.ContrastActions(pred, 0.6)
        same = contrast.compare(clip["s0_a"], clip["s0_b"])
        diff = contrast.compare(clip["s0_a"], clip["s1"])
        db_pred = Predictor(cfg, model_path=model_pt, device=dev,
                            audio_db_path=os.path.join(work, "gui_db"))
        rec = infer_recognition_gui.RecognitionActions(db_pred)
        registered = rec.register(clip["s0_a"], "alice")
        recognised = rec.recognise(clip["s0_c"])
        window = infer_recognition_gui.StreamWindow(16000)
        texts = [rec.stream_block(window, stream[i:i + 1024])
                 for i in range(0, len(stream), 1024)]
        diar, diar_text = infer_speaker_diarization_gui.DiarizationActions(
            pred).diarize(conv, "3")
        out["launches"]["gui"] = read_launches(fk, fkm, tk)
        lap("gui_actions", t)
        heard = [x for x in texts if x is not None]
        out["gui"] = {"same": same, "different": diff,
                      "register": list(registered), "recognise": recognised,
                      "stream_blocks": len(texts),
                      "stream_recognitions": len(heard),
                      "stream_last": heard[-1] if heard else None,
                      "diarize_equals_a": diar == segs}
        log(f"[phase13] {card}: GUI actions: contrast {same!r} / {diff!r}; "
            f"register {registered}, recognise {recognised!r}; the stream "
            f"window over {len(texts)} blocks of 1024: {len(heard)} "
            f"recognitions, last {out['gui']['stream_last']!r}; diarize "
            f"returns (a)'s {len(diar)} segments: "
            f"{out['gui']['diarize_equals_a']}; launches "
            f"{out['launches']['gui']}")
        if not (same.startswith("SAME") and diff.startswith("DIFFERENT")
                and registered[0] and recognised.startswith("speaker: alice")
                and len(heard) == len(texts) - 15
                and heard[-1].startswith("speaker: alice")
                and diar == segs and diar_text.count("\n") == len(segs)):
            raise AssertionError(f"a GUI action is wrong: {out['gui']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"]["phase"] = time.perf_counter() - t0
    log(f"[phase13] {card}: phase 13 wall {out['wall_s']['phase']:.1f} s: "
        f"{ {k: round(v, 2) for k, v in out['wall_s'].items()} }")
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
        # the launches each stage adds: the FCM and trunk kernels serve
        # every bucket up to 32 s, so every stage but the 33 s clip
        # launches both
        stage_launches, last = {}, read_launches(fk, fkm, tk)

        def stage(name):
            nonlocal last
            now = read_launches(fk, fkm, tk)
            stage_launches[name] = {k: now[k] - last[k] for k in now}
            last = now

        ok_a, _ = pred.register(wav("a_1"), "speaker_a")
        ok_b, _ = pred.register(wav("b_1"), "speaker_b")
        rec = [pred.recognition(wav(n)) for n in ("a_2", "b_2")]
        score = pred.contrast(wav("a_1"), wav("a_2"))
        stage("register, recognition, contrast (demo wavs)")
        embs = pred.predict_batch(clips)
        stage("predict_batch, 64 clips of 1-8 s")
        long_embs = pred.predict_batch(long_clips)
        stage("predict_batch, 8 clips of 9-30 s")
        emb_16 = pred.predict_batch([clip_16])[0]
        stage("predict_batch, a 15 s clip")
        emb_33 = pred.predict_batch([clip_33])
        stage("predict_batch, a 33 s clip")
        launches = read_launches(fk, fkm, tk)
        main_clusters = dict(sorted(tk.trunk_stats.cluster_launches.items()))
        main_s = time.perf_counter() - t0
        log(f"[main] Predictor(device='cuda') in {main_s:.2f} s: register "
            f"{ok_a} {ok_b}; users {sorted(set(pred.get_users()))}; "
            f"recognition {rec}; contrast(a_1, a_2) = {score:.4f}; "
            f"predict_batch {embs.shape} + {long_embs.shape}; predict 15 s "
            f"{emb_16.shape}; 33 s {emb_33.shape}; launches {launches}; "
            f"trunk launches by cluster size {main_clusters}; by stage "
            f"{json.dumps(stage_launches)}")
        if not (ok_a and ok_b and embs.shape == (64, 192)
                and long_embs.shape == (8, 192) and emb_16.shape == (192,)
                and emb_33.shape == (1, 192)
                and all(np.isfinite(e).all()
                        for e in (embs, long_embs, emb_16, emb_33))
                and np.isfinite(score)
                and all(r[0] is not None for r in rec)):
            raise AssertionError("Predictor outputs are wrong")
        *kernel_stages, plain_stage = stage_launches.values()
        if any(min(n.values()) < 1 for n in kernel_stages):
            raise AssertionError(f"a kernel of the path did not run at every "
                                 f"stage: {stage_launches}")
        if plain_stage["fcm"] or plain_stage["campplus_trunk"]:
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
        fcm3 = fkm.fcm_fused(packed_fcm, feats_3)
        stats3 = tk.trunk_stats(packed, fcm3)
        stages3 = {
            "featurize": cuda_ms(lambda: feat(waves), 10),
            "fcm kernel": cuda_ms(
                lambda: fkm.fcm_fused(packed_fcm, feats_3), 10),
            "trunk kernel": cuda_ms(lambda: tk.trunk_stats(packed, fcm3), 10),
            "head": cuda_ms(lambda: model.DenseBN_0(stats3), 10),
        }
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
                lambda: tk._trunk_stats_at(packed, fx, tv, cs_min),
                lambda: tk.trunk_stats(packed, fx, tv), iters)
            threads, smem = tk.block_launch(rows, t_valid)
            split_times[name] = {
                "cluster": cs_def, "rows_per_block": rows, "ms": k,
                "smallest_cluster": cs_min, "smallest_cluster_ms": p,
                "block_threads": threads, "block_smem_bytes": smem,
                **trunk_bound(tk, packed, fx, tv)}
        trunk_split_ms = trunk_phase_split(
            tk, packed, {"b256 x 298": (fcm_b256, None),
                         "b32 x 1598": (fcm16, None)}, card)
        stages16 = {
            "featurize": cuda_ms(lambda: feat(w16), 10),
            "fcm kernel": cuda_ms(lambda: fkm.fcm_fused(packed_fcm, feats_16), 10),
            "trunk kernel": cuda_ms(lambda: tk.trunk_stats(packed, fcm16), 5),
            "head": cuda_ms(lambda: model.DenseBN_0(stats16), 10),
        }
    log(f"[times] {card}: trunk b256 x 298 frames kernel {tr_kern} ms, plain "
        f"{tr_plain} ms")
    log(f"[times] {card}: whole embed b256 x 3 s {embed_ms:.3f} ms/batch = "
        f"{256e3 / embed_ms:.1f} utt/s; stages {stages3} ms")
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
            f"{st['cluster']} (R={st['rows_per_block']}, {st['block_threads']} threads, "
            f"{st['block_smem_bytes']} bytes of shared memory) {st['ms']} ms; "
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

    # ---- 11. the single-card workflow: convert, extract, train, export ---
    workflow = workflow_phase(dev, card)
    print(json.dumps({"workflow": workflow}), flush=True)

    # ---- 12. data parallelism: DDP, rank-sharded eval, DCP, DP serving ---
    parallel = parallel_phase(dev, card)
    print(json.dumps({"parallel": parallel}), flush=True)

    # ---- 13. the last modules: diarization quality, tools, GUI actions ---
    phase13 = last_modules_phase(dev, card)
    print(json.dumps({"phase13": phase13}), flush=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    def phase11_launches(kernel):
        return {path: n[kernel] for path, n in workflow["launches"].items()}

    def phase12_launches(kernel):
        return {path: n[kernel] for path, n in parallel["launches"].items()}

    def phase13_launches(kernel):
        return {path: n[kernel] for path, n in phase13["launches"].items()}

    train_launches = {"fbank_per_step": 1,
                      "eval": training["eval"]["launches"],
                      "train_path": training["fp32"]["launches_train_path"]}

    f16, f3 = fcm_t["b32 x 16 s"], fcm_t["b256 x 3 s"]
    cross = fcm_t["crossover"]
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
        "launches_phase11": phase11_launches("fbank"),
        "launches_phase12": phase12_launches("fbank"),
        "launches_phase13": phase13_launches("fbank"),
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
         "launches_main_by_stage": {k: n["fcm"]
                                    for k, n in stage_launches.items()},
         "launches_embedding_request":
             served["launches_embedding_request"]["fcm"],
         "launches_predict_batch_3s_b1_b64":
             served["launches_predict_batch_3s_b1_b64"]["fcm"],
         "launches_eval": train_launches["eval"]["fcm"],
         "launches_phase11": phase11_launches("fcm"),
         "launches_phase12": phase12_launches("fcm"),
         "launches_phase13": phase13_launches("fcm"),
         "ms": ms(f16["ms"]), "plain_ms": ms(f16["plain_ms"]),
         **fcm_bounds["b32 x 16 s"], "library_ms": None,
         "cudnn_ms": ms(cross["b32 x 1598"]["cudnn_ms"]),
         "design_floor_ms": f16["design_floor_ms"], "shape": "b32 x 16 s",
         "ms_b256x3s": ms(f3["ms"]), "plain_ms_b256x3s": ms(f3["plain_ms"]),
         "cudnn_ms_b256x3s": ms(cross["b256 x 298"]["cudnn_ms"]),
         "bound_ms_b256x3s": fcm_bounds["b256 x 3 s"]["bound_ms"],
         "work_gflop_b256x3s": fcm_bounds["b256 x 3 s"]["work_gflop"],
         "design_floor_ms_b256x3s": f3["design_floor_ms"],
         "occupancy": fcm_t["occupancy"],
         "split_ms": {n: {r["name"]: r["ms"] for r in f["split"]}
                      for n, f in (("b32 x 16 s", f16), ("b256 x 3 s", f3))},
         "crossover": {n: {"ms": ms(c["ms"]), "cudnn_ms": ms(c["cudnn_ms"])}
                       for n, c in cross.items()}},
        {"name": "campplus_trunk", "route": "cuda", "source": TRUNK_SRC,
         "replaces": TRUNK_TPU, "also_replaces": TRUNK_TPU_LOOPED,
         "launches": launches["campplus_trunk"], "max_abs_err": trunk_max,
         "launches_eval": train_launches["eval"]["campplus_trunk"],
         "launches_phase11": phase11_launches("campplus_trunk"),
         "launches_phase12": phase12_launches("campplus_trunk"),
         "launches_phase13": phase13_launches("campplus_trunk"),
         "ms": ms(tr_kern), "plain_ms": ms(tr_plain), **tr_bound,
         "library_ms": None, "shape": "b256 x 3 s",
         "ms_b32x16s": ms(tr16_kern), "plain_ms_b32x16s": ms(tr16_plain),
         "cluster_launches_main_path": main_clusters,
         "clusters_checked": sorted(checked), "split_times": split_times,
         "cluster_sweep": sweep, "resident_clusters": resident,
         "phase_split": trunk_split_ms},
    ], "embed_utt_per_s": 256e3 / embed_ms, "embed_stages_ms": stages3,
        "embed_16s_utt_per_s": 32e3 / embed16_ms, "serve": served,
        "train_utt_per_s": training["fp32"]["train_utt_per_s"],
        "train_utt_per_s_amp": training["amp"]["train_utt_per_s"],
        "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase12-rank"]:
        parallel_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--phase12-nccl"]:
        parallel_nccl(sys.argv[2])
    else:
        main()
