"""Helpers the entries share: seeded weights written as a state dict and
loaded through ``Predictor``, the dispatch of batches ahead of the
device, the reference's embeddings of padded clips, and clips as WAV
bodies and as the port reads them back."""

import io
import os
import time
import wave

import numpy as np
import torch

from .. import traffic_gen
from ..reference import fbank as ref_fbank
from ..reference.campplus import tvalids
from ..reference.precision import no_tf32, precision
from ..weights import model_state, reference_model


def predictor(ctx, state):
    """``Predictor`` on the seeded weights, written as a state dict and
    loaded through its constructor; the configuration file's ``run`` key
    is the YAML configuration the port reads."""
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
    path = os.path.join(ctx.tmpdir, "model.pt")
    torch.save(state, path)
    return Predictor(ctx.config["run"], model_path=path, device=str(ctx.device))


def clip_pool(ctx, n_clips):
    """``(lengths, waves (n, padded) on the device, ratios float32)``."""
    t = ctx.traffic
    lens = traffic_gen.lengths(t, n_clips, ctx.seed)
    padded = t["padded_samples"]
    w = traffic_gen.waves(lens, padded, ctx.seed, ctx.device,
                          t.get("level_db", -20.0))
    return lens, w, (lens / padded).astype(np.float32)


@torch.no_grad()
def reference_embeddings(config, state, waves, ratios, fmt="fp32", block=64):
    """The plain reference's embeddings of padded clips ``waves`` (B, L)
    with length ratios: Kaldi's fbank and CMN, then the kernel path's
    masked CAM++ or the plain backbone, in blocks of ``block`` rows."""
    model = reference_model(config).to(waves.device)
    model.load_state_dict(state)
    model.eval()
    out = []
    with no_tf32(), precision(fmt):
        for i in range(0, waves.shape[0], block):
            w, r = waves[i:i + block], np.asarray(ratios[i:i + block], np.float32)
            feats = ref_fbank.features(w, r).to(torch.float32)
            if config["path"] == "kernels":
                out.append(model.embed_masked(feats, tvalids(r, feats.shape[1])))
            else:
                out.append(model(feats, torch.from_numpy(r).to(w.device)))
    del model
    return torch.cat(out).float()


def rel_err(got, ref):
    """Per row ``|got - ref| / |ref|``, as float64 on the host."""
    got, ref = got.double(), ref.double().to(got.device)
    return ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).cpu().numpy()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Ahead:
    """Keep at most ``depth`` dispatched batches unfinished on the device:
    before the next dispatch past that, wait for the oldest one's event."""

    def __init__(self, depth, device):
        self.depth, self.events = depth, []
        self.cuda = device.type == "cuda"

    def dispatched(self):
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        if len(self.events) > self.depth:
            self.events.pop(0).synchronize()


def window_loop(seconds, step, device):
    """Call ``step(i)`` from ``i = 0`` until ``seconds`` have passed on
    the host's clock; then wait for the device. Returns (calls, seconds
    from the first call to the device's end)."""
    t0 = time.perf_counter()
    end = t0 + seconds
    i = 0
    while time.perf_counter() < end:
        step(i)
        i += 1
    sync(device)
    return i, time.perf_counter() - t0


def seeded_state(ctx):
    return model_state(ctx.config, ctx.seed, ctx.device)


def wav_body(samples_int16, sr=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(samples_int16.astype("<i2").tobytes())
    return buf.getvalue()


def served_input(pcm, target_db=-20.0):
    """What the server embeds for a clip: the PCM over 32768, gained to
    ``target_db`` dBFS RMS in float32 (``AudioSegment.normalize``)."""
    x = pcm.astype(np.float32) / np.float32(32768.0)
    ms = float(np.mean(x ** 2))
    rms_db = -100.0 if ms <= 1e-30 else 10.0 * np.log10(ms)
    return x * (10.0 ** (min(target_db - rms_db, 300.0) / 20.0))
