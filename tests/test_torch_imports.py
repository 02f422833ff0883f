"""PyTorch port, packaging and host helpers: importing the port never
loads jax, nor matplotlib or tkinter (the viewer and the GUIs import them
where they draw; the GPU host has neither); no port source imports jax, flax, the JAX package or
scikit-learn (the GPU host has none of them); the copied host helpers
(``bucket_length``, ``AudioSegment``) agree with the JAX package's; the
kernel build reports a missing toolchain instead of running anything
else, and threads that ask for the library at once share one build."""

import glob
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from torch_jax_native import require_jax_native
from voiceprintrecognition_paddlepaddle_torch import _build
from voiceprintrecognition_paddlepaddle_torch.data_utils.collate import \
    bucket_length
from voiceprintrecognition_paddlepaddle_torch.ops.audio import AudioSegment
from voiceprintrecognition_paddlepaddle_tpu.data_utils import collate as jcollate
from voiceprintrecognition_paddlepaddle_tpu.ops.audio import \
    AudioSegment as JaxAudioSegment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "voiceprintrecognition_paddlepaddle_torch")
MODULES = ["predict", "models.trunk_kernel", "models.fcm_kernel",
           "models.convert", "ops.fbank_kernel", "ops.features", "_build",
           "ops.audio", "native", "native.audio_native", "infer_utils",
           "infer_utils.speaker_diarization", "infer_utils.der",
           "infer_utils.micro_batcher", "utils.utils", "serve",
           "infer_contrast", "infer_speaker_diarization", "models",
           "models.layers", "models.pooling", "models.tdnn",
           "models.ecapa_tdnn", "models.resnet_se", "models.res2net",
           "models.eres2net", "models.fc", "ops.kaldi", "trainer", "train",
           "eval", "metric", "metric.metrics", "data_utils",
           "data_utils.collate", "data_utils.reader", "data_utils.loader",
           "data_utils.pk_sampler", "ops.augment", "loss", "loss.losses",
           "optimizer", "optimizer.scheduler", "utils.checkpoint",
           "utils.config", "optimizer.adam", "models.convert_paddle",
           "convert_paddle", "create_data", "extract_features",
           "infer_recognition", "utils.record", "data_utils.featurizer",
           "parallel", "parallel.mesh", "launch_multihost",
           "infer_utils.viewer", "infer_utils.player", "infer_contrast_gui",
           "infer_recognition_gui", "infer_speaker_diarization_gui",
           "eval_from_paddle", "eval_speaker_diarization",
           "eval_speaker_diarization.infer_data",
           "eval_speaker_diarization.compute_metrics",
           "eval_speaker_diarization.create_aishell4_test_rttm",
           "models.conformer"]


def test_importing_the_port_leaves_jax_out():
    code = ("import sys\n"
            + "".join(f"import voiceprintrecognition_paddlepaddle_torch.{m}\n"
                      for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m in ('jax', 'sklearn', "
              "'matplotlib', 'tkinter') or m.startswith(('jax.', 'flax', "
              "'sklearn.', 'matplotlib.', 'tkinter.', "
              "'voiceprintrecognition_paddlepaddle_tpu')))\n"
              "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    """The port, and what runs beside it on the card's host: the card's
    tests, their helpers and ``fcm_variants.py``."""
    sources = [os.path.join(d, n) for d, _, files in os.walk(PKG)
               for n in files if n.endswith(".py")]
    assert len(sources) > 20
    card = [os.path.join(ROOT, "tests", "torch_card.py"),
            os.path.join(ROOT, "fcm_variants.py")]
    card += glob.glob(os.path.join(ROOT, "tests", "test_torch_gpu*.py"))
    assert all(os.path.exists(p) for p in card) and len(card) >= 3
    sources += card
    for path in sources:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert not re.search(
            r"^\s*(import|from)\s+(jax|flax|sklearn|"
            r"voiceprintrecognition_paddlepaddle_tpu)\b", text,
            re.MULTILINE), path


@pytest.mark.parametrize("n", [1, 16000, 16001, 56000, 64000, 128000,
                               128001, 460800])
def test_bucket_length_matches_jax(n):
    assert bucket_length(n) == jcollate.bucket_length(n)


def test_audio_segment_matches_jax():
    require_jax_native()
    path = os.path.join(ROOT, "dataset", "a_1.wav")
    ours, theirs = AudioSegment.from_file(path), JaxAudioSegment.from_file(path)
    np.testing.assert_array_equal(ours.samples, theirs.samples)
    assert ours.sample_rate == theirs.sample_rate
    ours.normalize(target_db=-20)
    theirs.normalize(target_db=-20)
    np.testing.assert_allclose(ours.samples, theirs.samples, rtol=1e-6)
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(AudioSegment.from_bytes(data).samples,
                                  AudioSegment.from_file(path).samples)
    # both resample with the native Kaiser-windowed filter: equal samples
    # (tests/test_torch_native.py holds noise at 44.1, 8 and 48 kHz)
    x = (0.3 * np.sin(2 * np.pi * 440 * np.arange(4410) / 44100)).astype(
        np.float32)
    a = AudioSegment.from_ndarray(x, 44100).resample(16000)
    b = JaxAudioSegment.from_ndarray(x, 44100).resample(16000)
    assert a.num_samples == b.num_samples == 1600
    np.testing.assert_array_equal(a.samples, b.samples)


def test_default_feature_method_matches_jax_and_is_not_ported():
    """Both packages default to MelSpectrogram. The port raised for it
    while it had Fbank only; a featurizer that names no method now
    computes the JAX package's default features."""
    import inspect

    import torch

    from voiceprintrecognition_paddlepaddle_torch.ops import features as tfeat
    from voiceprintrecognition_paddlepaddle_tpu.ops import features as jfeat

    for mod in (tfeat, jfeat):
        for fn in (mod.compute_feature, mod.AudioFeaturizer.__init__):
            param = inspect.signature(fn).parameters["feature_method"]
            assert param.default == "MelSpectrogram", (mod.__name__, fn)
    w = (np.random.RandomState(4).randn(2, 16000) * 0.1).astype(np.float32)
    ref = np.asarray(jfeat.AudioFeaturizer()(w))
    got = tfeat.AudioFeaturizer()(torch.from_numpy(w)).numpy()
    assert got.shape == ref.shape and tfeat.AudioFeaturizer().feature_dim == 64
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())
    got = tfeat.compute_feature(torch.from_numpy(w), sr=16000).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_wav_roundtrip(tmp_path):
    x = (np.random.RandomState(1).randn(1600) * 0.1).astype(np.float32)
    path = tmp_path / "x.wav"
    AudioSegment(x, 16000).to_wav_file(path)
    back = AudioSegment.from_file(str(path))
    assert back.sample_rate == 16000
    np.testing.assert_allclose(back.samples, x, atol=1.0 / 16000)


def test_check_raises_on_cuda_error():
    _build.check(0, "k")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "k")


def test_build_names_missing_toolchain(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_kernel_library_builds_once_for_concurrent_callers(monkeypatch,
                                                          tmp_path):
    """Eight threads ask for the library at once (the first requests of a
    threaded server): one build (an nvcc compile per source, then one
    link), one library for all."""
    builds = []

    def fake_nvcc_run(cmd, **kw):
        builds.append(cmd)
        time.sleep(0.2)               # a slow compile widens any race
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"so")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(_build, "_BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc_run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    _build._kernel_library.cache_clear()
    try:
        got = [None] * 8
        start = threading.Barrier(8)

        def ask(i):
            start.wait()
            got[i] = _build.kernel_library()

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        _build._kernel_library.cache_clear()
    links = [cmd for cmd in builds if "-shared" in cmd]
    sources = glob.glob(os.path.join(_build._CSRC, "*.cu"))
    assert len(links) == 1 and len(builds) == len(sources) + 1
    assert all(g is got[0] for g in got) and got[0].lib[0] == "lib"
    assert os.path.exists(got[0].path) and not got[0].cached


def test_torch_card_config_is_cam_yml_and_its_weights_load():
    """``tests/torch_card.py`` keeps configs/cam++.yml as a dict (the GPU
    host has no PyYAML) and builds its weights in the flax layout."""
    import torch
    import yaml

    import torch_card
    from voiceprintrecognition_paddlepaddle_torch.models.campplus import \
        CAMPPlus
    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state

    with open(os.path.join(ROOT, "configs", "cam++.yml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    for key in ("dataset_conf", "preprocess_conf", "model_conf"):
        assert torch_card.CONFIG[key] == cfg[key], key
    model = CAMPPlus(80, embd_dim=192)
    state = jax_to_torch_state(torch_card.random_flax_variables(model, 0))
    model.load_state_dict(state)
    bn = model.TDNNLayer_0._NonLinear_0.BatchNorm_0
    assert not torch.allclose(bn.running_var, torch.ones_like(bn.running_var))


def test_torch_card_backbones_are_the_configs():
    """``tests/torch_card.py`` keeps the other six configs' ``model_conf`` as
    dicts; they are the YAML files', and each builds its backbone."""
    import yaml

    import torch_card
    from voiceprintrecognition_paddlepaddle_torch.models import build_model
    from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
        dict_to_object

    for key, conf in torch_card.BACKBONE_CONFS.items():
        with open(os.path.join(ROOT, "configs", f"{key}.yml"),
                  encoding="utf-8") as f:
            cfg = yaml.safe_load(f)
        assert conf == cfg["model_conf"], key
        for k in ("dataset_conf", "preprocess_conf"):
            assert torch_card.CONFIG[k] == cfg[k], (key, k)
        model = build_model(80, dict_to_object(dict(torch_card.CONFIG,
                                                    model_conf=conf)))
        assert type(model).__name__ == conf["model"]
