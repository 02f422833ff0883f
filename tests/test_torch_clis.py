"""PyTorch port, the command lines of this slice: ``create_data``,
``extract_features``, ``infer_recognition`` and ``convert_paddle``
(``python -m voiceprintrecognition_paddlepaddle_torch.<name>``).

Each answers ``--help``, as do the later command lines (``eval_from_paddle``,
the three GUIs, ``infer_speaker_diarization`` and the
``eval_speaker_diarization`` tools). ``create_data`` on a CN-Celeb-shaped tree (802
speakers in CN-Celeb, the ones from id 800 on the test split, and two in
CN-Celeb2 offset by 800) writes the list the root ``create_data.py`` of
the JAX package writes, line for line. ``extract_features --device=cpu``
writes a ``*_features.txt`` list per list of its YAML config.
``infer_recognition --device=cpu`` registers a user into a copy of
``audio_db/`` and recognises a clip: the name and score the port's
``Predictor`` gives in the process on the same weights and database
(``tests/test_torch_predictor.py`` holds that against JAX; here the tiny
CAM++ with BN statistics calibrated on tones moves ``a_1.wav``'s embedding
to cos 0.988 of JAX's from the 1.4e-3 log-mel difference of the two
front ends, ROADMAP.md queue 3); without ``--register`` / ``--recognize``
its loop records from the microphone, which raises a clear error on a
host without ``soundcard``."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import (SMALL, calibrate_bn_stats, calibration_clips,
                                speaker_corpus, synth_campplus, train_configs)
from voiceprintrecognition_paddlepaddle_torch import infer_recognition
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "voiceprintrecognition_paddlepaddle_torch"


def _env():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["OMP_NUM_THREADS"] = "2"
    return env


def _run(args, timeout=300, **kw):
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=timeout,
                          **kw)


@pytest.mark.parametrize("name", [
    "create_data", "extract_features", "infer_recognition", "convert_paddle",
    "eval_from_paddle", "infer_contrast_gui", "infer_recognition_gui",
    "infer_speaker_diarization_gui", "infer_speaker_diarization",
    "eval_speaker_diarization.infer_data",
    "eval_speaker_diarization.compute_metrics",
    "eval_speaker_diarization.create_aishell4_test_rttm"])
def test_help(name):
    run = _run(["-m", f"{PKG}.{name}", "--help"])
    assert run.returncode == 0, run.stderr[-2000:]
    assert "usage:" in run.stdout and "Run: python -m" in run.stdout


def test_create_data_writes_the_root_scripts_list(tmp_path):
    celeb = tmp_path / "CN-Celeb_flac" / "data"
    celeb2 = tmp_path / "CN-Celeb2_flac" / "data"
    for i in range(802):
        (celeb / f"id{i:05d}").mkdir(parents=True)
    for i in (0, 1, 799, 800, 801):
        for u in range(2):
            (celeb / f"id{i:05d}" / f"u{u}.flac").write_bytes(b"")
    for i in range(2):
        (celeb2 / f"id{i:05d}").mkdir(parents=True)
        (celeb2 / f"id{i:05d}" / "x.flac").write_bytes(b"")
    lists = {}
    for side, args in (("port", ["-m", f"{PKG}.create_data"]),
                       ("jax", [os.path.join(ROOT, "create_data.py")])):
        out = tmp_path / side / "train_list.txt"
        run = _run(args + [f"--cn_celeb_dir={celeb}",
                           f"--cn_celeb2_dir={celeb2}",
                           f"--list_path={out}"])
        assert run.returncode == 0, run.stderr[-2000:]
        lists[side] = out.read_text(encoding="utf-8")
    assert lists["port"] == lists["jax"]
    labels = [ln.split("\t")[1] for ln in lists["port"].splitlines()]
    assert labels == ["0", "0", "1", "1", "799", "799", "800", "801"]


def test_extract_features_command_line(tmp_path):
    lists = speaker_corpus(tmp_path / "corpus", n_speakers=2, n_utts=2)
    cfg = train_configs(lists, model_args={"embd_dim": 16, "channels": 16})
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg), encoding="utf-8")
    run = _run(["-m", f"{PKG}.extract_features", f"--configs={path}",
                "--device=cpu", f"--save_dir={tmp_path / 'features'}"])
    assert run.returncode == 0, run.stderr[-3000:]
    for src in lists:
        feats = src.replace(".txt", "_features.txt")
        lines = open(feats, encoding="utf-8").read().splitlines()
        assert len(lines) == len(open(src).read().splitlines())
        assert np.load(lines[0].split("\t")[0]).shape[1] == 40


@pytest.fixture(scope="module")
def recognition_world(tmp_path_factory):
    """A tiny CAM++ (BN statistics calibrated, so that clips score
    apart) and its YAML config."""
    root = tmp_path_factory.mktemp("recognition")
    _, v, tm = synth_campplus(SMALL, seed=9)
    v, tm = calibrate_bn_stats(v, tm, calibration_clips())
    torch.save(tm.state_dict(), str(root / "model.pt"))
    with open(os.path.join(ROOT, "configs", "cam++.yml"),
              encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    cfg["model_conf"]["model_args"] = dict(SMALL)
    (root / "tiny.yml").write_text(yaml.safe_dump(cfg), encoding="utf-8")
    return root, cfg


def test_infer_recognition_registers_and_recognises(recognition_world,
                                                    tmp_path):
    root, cfg = recognition_world
    wav = lambda n: os.path.join(ROOT, "dataset", f"{n}.wav")  # noqa: E731
    db = tmp_path / "db"
    shutil.copytree(os.path.join(ROOT, "audio_db"), db,
                    ignore=shutil.ignore_patterns("audio_indexes.bin"))
    run = _run(["-m", f"{PKG}.infer_recognition", "--device=cpu",
                f"--configs={root / 'tiny.yml'}",
                f"--model_path={root / 'model.pt'}", f"--audio_db_path={db}",
                "--threshold=0.0", f"--register=alice={wav('a_1')}",
                f"--recognize={wav('b_2')}"])
    assert run.returncode == 0, run.stderr[-3000:]
    assert f"register alice from {wav('a_1')}: True" in run.stdout
    m = re.search(r"recognised speaker: (\S+), similarity: (\S+)", run.stdout)
    assert m, run.stdout
    assert "registered users: ['user_a', 'user_b', 'alice']" in run.stdout

    ref_db = tmp_path / "ref_db"
    shutil.copytree(os.path.join(ROOT, "audio_db"), ref_db,
                    ignore=shutil.ignore_patterns("audio_indexes.bin"))
    pred = Predictor(cfg, threshold=0.0, audio_db_path=str(ref_db),
                     model_path=str(root / "model.pt"), device="cpu")
    assert pred.register(wav("a_1"), user_name="alice")[0]
    name, score = pred.recognition(wav("b_2"))
    assert (m.group(1), float(m.group(2))) == (name, score)
    assert score < 0.99
    assert sorted(os.listdir(db)) == sorted(os.listdir(ref_db))


def test_infer_recognition_loop_needs_a_microphone(recognition_world,
                                                   tmp_path, monkeypatch):
    root, _ = recognition_world
    monkeypatch.setitem(sys.modules, "soundcard", None)
    monkeypatch.setattr("builtins.input", lambda prompt="": "1")
    with pytest.raises(RuntimeError, match="audio recording unavailable"):
        infer_recognition.main([
            "--device=cpu", f"--configs={root / 'tiny.yml'}",
            f"--model_path={root / 'model.pt'}",
            f"--audio_db_path={tmp_path / 'db'}"])
