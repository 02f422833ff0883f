#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device   the card's name and power limit (nvidia-smi); no CUDA -> fail
2. build    nvcc builds csrc/*.cu for sm_90a; prints time and ptxas output
3. fbank    the fbank kernel against its plain version, b256 x 3 s
4. trunk    the trunk kernel against its plain version (both bf16), full
            CAM++ width with random weights and BN statistics from a seed,
            converted from the flax layout by models/convert.py:
            b256 x 298 frames, 3 x 798 frames, and a ragged padded batch
            held row by row against its exact-length embeddings
5. main     Predictor(device="cuda"): register / recognition / contrast
            over the demo wavs and predict_batch over 64 seeded 1-8 s
            clips; both kernels' launch counters must rise, and four
            embeddings are held against the eager fp32 model
6. times    CUDA-event times of each kernel against its plain version and
            whole-embed utt/s at b256 x 3 s (bench.py's embed workload)

The last line is ``{"ok": true, "device": {...}}``; the line before it
is a JSON object with one entry per kernel.
"""

import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# configs/cam++.yml: dataset_conf, preprocess_conf and model_conf (kept as
# a dict: the GPU host has no PyYAML)
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
}

FBANK_SRC = "voiceprintrecognition_paddlepaddle_torch/csrc/fbank.cu"
TRUNK_SRC = "voiceprintrecognition_paddlepaddle_torch/csrc/campplus_trunk.cu"
FBANK_TPU = "voiceprintrecognition_paddlepaddle_tpu/ops/pallas_fbank.py:79"
TRUNK_TPU = ("voiceprintrecognition_paddlepaddle_tpu/models/"
             "pallas_campplus.py:317")
TRUNK_TPU_LOOPED = ("voiceprintrecognition_paddlepaddle_tpu/models/"
                    "pallas_campplus.py:458")


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


def cos_min(a, b):
    a, b = a.double(), b.double()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())


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

    # ---- 4. trunk kernel vs plain ----------------------------------------
    model = CAMPPlus(80, embd_dim=192)
    model.load_state_dict(jax_to_torch_state(random_flax_variables(model,
                                                                   SEED)))
    model.to(dev).eval().requires_grad_(False)
    packed = tk.pack_trunk(model)
    feat = features.AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80})
    with torch.no_grad():
        fcm_b256 = model.FCM_0(feat(waves))
        cases = [("b256 x 298 frames", fcm_b256, None)]
        w8 = torch.from_numpy(
            (rng.randn(3, 128000) * 0.1).astype(np.float32)).to(dev)
        cases.append(("3 x 798 frames", model.FCM_0(feat(w8)), None))
        trunk_max = None
        for name, fcm_out, tv in cases:
            s_k = tk.trunk_stats(packed, fcm_out, tv)
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
            if trunk_max is None:
                trunk_max = sd
        # ragged padded 8 s bucket: each row against its exact-length run
        valids = [128000, 96000, 48000, 24000, 16000]
        padded = np.zeros((len(valids), 128000), np.float32)
        for i, n in enumerate(valids):
            padded[i, :n] = rng.randn(n) * 0.1
        ratios = np.asarray([n / 128000 for n in valids], np.float32)
        embed = tk.make_campplus_masked_embed_fn(model, feat)
        got = embed(torch.from_numpy(padded).to(dev), ratios)
        for i, n in enumerate(valids):
            exact = embed(torch.from_numpy(padded[i:i + 1, :n]).to(dev))
            c = cos_min(exact, got[i:i + 1])
            log(f"[trunk] ragged row {i} ({n} samples): cos vs exact-length "
                f"= {c:.6f} (bar 0.999)")
            if c <= 0.999:
                raise AssertionError("padded row disagrees with exact length")

    # ---- 5. the main path: Predictor on the card --------------------------
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

        fk.fbank_fused.launches = 0
        tk.trunk_stats.launches = 0
        t0 = time.perf_counter()
        pred = Predictor(CONFIG, threshold=-1.0, audio_db_path=db,
                         model_path=model_path, device="cuda")
        ok_a, _ = pred.register(wav("a_1"), "speaker_a")
        ok_b, _ = pred.register(wav("b_1"), "speaker_b")
        rec = [pred.recognition(wav(n)) for n in ("a_2", "b_2")]
        score = pred.contrast(wav("a_1"), wav("a_2"))
        embs = pred.predict_batch(clips)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = {"fbank": fk.fbank_fused.launches,
                    "campplus_trunk": tk.trunk_stats.launches}
        log(f"[main] Predictor(device='cuda') in {main_s:.2f} s: register "
            f"{ok_a} {ok_b}; users {sorted(set(pred.get_users()))}; "
            f"recognition {rec}; contrast(a_1, a_2) = {score:.4f}; "
            f"predict_batch {embs.shape}; launches {launches}")
        if not (ok_a and ok_b and embs.shape == (64, 192)
                and np.isfinite(embs).all() and np.isfinite(score)
                and all(r[0] is not None for r in rec)):
            raise AssertionError("Predictor outputs are wrong")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the path never ran: {launches}")
        # four outputs against the eager fp32 model on exact-length
        # features from the plain fbank
        with torch.no_grad():
            for i in range(4):
                x = torch.from_numpy(clips[i]).to(dev)[None]
                f = features.apply_cmn_and_mask(kaldi.fbank(x, n_mels=80))
                ref_e = model(f)
                c = cos_min(ref_e, torch.from_numpy(embs[i:i + 1]).to(dev))
                log(f"[main] clip {i} ({clips[i].shape[0]} samples): cos vs "
                    f"eager fp32 model = {c:.6f} (bar 0.999)")
                if c <= 0.999:
                    raise AssertionError("embedding disagrees with eager model")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 6. times on the card -------------------------------------------
    fb_plain = [cuda_ms(lambda: fk.fbank_fused_reference(waves, n_mels=80), 20)]
    fb_kern = [cuda_ms(lambda: fk.fbank_fused(waves, n_mels=80), 20)
               for _ in range(2)]
    fb_plain.append(cuda_ms(lambda: fk.fbank_fused_reference(waves, n_mels=80), 20))
    with torch.no_grad():
        tr_plain = [cuda_ms(lambda: tk.trunk_stats_reference(packed, fcm_b256), 3, 1)]
        tr_kern = [cuda_ms(lambda: tk.trunk_stats(packed, fcm_b256), 10)
                   for _ in range(2)]
        tr_plain.append(cuda_ms(
            lambda: tk.trunk_stats_reference(packed, fcm_b256), 3, 1))
        embed_ms = cuda_ms(lambda: embed(waves), 10)
    ms = lambda xs: sum(xs) / len(xs)  # noqa: E731
    log(f"[times] {card}: fbank b256 x 3 s kernel {fb_kern} ms, plain "
        f"{fb_plain} ms")
    log(f"[times] {card}: trunk b256 x 298 frames kernel {tr_kern} ms, plain "
        f"{tr_plain} ms")
    log(f"[times] {card}: whole embed b256 x 3 s {embed_ms:.3f} ms/batch = "
        f"{256e3 / embed_ms:.1f} utt/s")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        {"name": "fbank", "route": "cuda", "source": FBANK_SRC,
         "replaces": FBANK_TPU, "launches": launches["fbank"],
         "max_abs_err": fb_max, "ms": ms(fb_kern), "plain_ms": ms(fb_plain)},
        {"name": "campplus_trunk", "route": "cuda", "source": TRUNK_SRC,
         "replaces": TRUNK_TPU, "also_replaces": TRUNK_TPU_LOOPED,
         "launches": launches["campplus_trunk"], "max_abs_err": trunk_max,
         "ms": ms(tr_kern), "plain_ms": ms(tr_plain)},
    ], "embed_utt_per_s": 256e3 / embed_ms, "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
