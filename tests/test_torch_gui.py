"""PyTorch port, the three tk GUIs (``infer_contrast_gui``,
``infer_recognition_gui``, ``infer_speaker_diarization_gui``) against the
root GUIs of the JAX package.

Each port module imports without tkinter (hidden) and without a display.
Each action method, on a ``Predictor(device="cpu")`` of a tiny CAM++ whose
weights come from JAX through ``jax_to_torch_state``, gives the text that
the JAX GUI builds from the same score, name or segments: the JAX GUI runs
with a stand-in tkinter module, its worker threads run inline, and its
predictor returns what the port's gave; the port's own tk shell runs on
the same stand-in and shows the same text. The streaming window: its
length after each 1024-frame block (two channels averaged), and a
recognition from the block that brings it to 1 s on, of the last 3 s, as
the JAX GUI's loop over a stand-in microphone does. Texts are compared
exactly."""

import importlib.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import SMALL, synth_campplus
from voiceprintrecognition_paddlepaddle_torch import (
    infer_contrast_gui, infer_recognition_gui, infer_speaker_diarization_gui)
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "voiceprintrecognition_paddlepaddle_torch"
SR = 16000
WAV = {n: os.path.join(ROOT, "dataset", f"{n}.wav")
       for n in ("a_1", "a_2", "b_1", "b_2", "test_long")}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as ``tests/test_torch_trainer.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- a stand-in tkinter: widgets that keep their text ------------------------
class _Widget:
    def __init__(self, *args, text="", command=None, **kw):
        self.text, self.command = text, command

    def grid(self, **kw):
        pass

    def title(self, text):
        self.text = text

    def config(self, text=None, **kw):
        if text is not None:
            self.text = text

    def delete(self, *args):
        self.text = ""

    def insert(self, _index, text):
        self.text += text


class _Var:
    def __init__(self, value=""):
        self.value = value

    def get(self):
        return self.value

    def set(self, value):
        self.value = value


def _fake_tk(file_path="", name=""):
    def showerror(title, message):
        raise AssertionError(f"the GUI showed an error: {message}")

    tk = types.ModuleType("tkinter")
    tk.Tk = tk.Label = tk.Entry = tk.Button = tk.Text = _Widget
    tk.StringVar, tk.END = _Var, "end"
    tk.filedialog = types.SimpleNamespace(askopenfilename=lambda: file_path)
    tk.simpledialog = types.SimpleNamespace(askstring=lambda *a: name)
    tk.messagebox = types.SimpleNamespace(showerror=showerror)
    return tk


class _InlineThread:
    """``threading.Thread`` that runs its target on ``start``."""

    def __init__(self, target, daemon=None):
        self.target = target

    def start(self):
        self.target()


INLINE = types.SimpleNamespace(Thread=_InlineThread)


def _jax_gui(monkeypatch, name, tk, **predictor_returns):
    """The root ``<name>.py`` of the JAX package imported with ``tk`` as
    tkinter, inline threads and a predictor that returns
    ``predictor_returns`` (and records its calls)."""
    calls = []

    class StubPredictor:
        def __init__(self, **kw):
            pass

        def __getattr__(self, method):
            def call(*args, **kw):
                calls.append((method, args, kw))
                return predictor_returns.get(method)
            return call

    monkeypatch.setitem(sys.modules, "tkinter", tk)
    for sub in ("filedialog", "messagebox", "simpledialog"):
        monkeypatch.setitem(sys.modules, f"tkinter.{sub}", getattr(tk, sub))
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.Predictor = StubPredictor
    mod.threading = INLINE
    return mod, calls


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A tiny CAM++ (``configs/cam++.yml`` at init_channels 32) with
    weights from JAX through ``jax_to_torch_state``; its config and
    ``model.pt``."""
    root = tmp_path_factory.mktemp("gui")
    _, _, tmodel = synth_campplus(SMALL, seed=5)
    torch.save(tmodel.state_dict(), str(root / "model.pt"))
    with open(os.path.join(ROOT, "configs", "cam++.yml"),
              encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    cfg["model_conf"]["model_args"] = dict(SMALL)
    return cfg, str(root / "model.pt")


@pytest.mark.parametrize("name", ["infer_contrast_gui",
                                  "infer_recognition_gui",
                                  "infer_speaker_diarization_gui"])
def test_gui_imports_without_tkinter_or_display(name):
    code = ("import sys\n"
            "sys.modules['tkinter'] = None\n"
            f"import {PKG}.{name} as m\n"
            "assert callable(m.main)\n"
            "assert not any(k.startswith('tkinter') and sys.modules[k] "
            "for k in sys.modules)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "DISPLAY")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_contrast_text_is_jax_s(model, monkeypatch):
    cfg, pt = model
    pred = Predictor(cfg, model_path=pt, device="cpu")
    score = pred.contrast(WAV["a_1"], WAV["b_1"])
    tk = _fake_tk()
    # a threshold just under and just over the score: both verdicts
    for threshold in (score - 1e-3, score + 1e-3):
        actions = infer_contrast_gui.ContrastActions(pred, threshold)
        text = actions.compare(WAV["a_1"], WAV["b_1"])
        jmod, _ = _jax_gui(monkeypatch, "infer_contrast_gui", tk,
                           contrast=score)
        jmod.args.threshold = threshold
        jgui = jmod.ContrastGUI(_Widget())
        jgui.path1.set(WAV["a_1"])
        jgui.path2.set(WAV["b_1"])
        jgui.compare()
        assert text == jgui.result.text
        assert text.startswith("SAME" if score > threshold else "DIFFERENT")
        monkeypatch.setattr(infer_contrast_gui, "threading", INLINE)
        gui = infer_contrast_gui.ContrastGUI(_Widget(), actions, tk)
        gui.path1.set(WAV["a_1"])
        gui.path2.set(WAV["b_1"])
        gui.compare()
        assert gui.result.text == text


def test_recognition_texts_are_jax_s(model, monkeypatch, tmp_path):
    cfg, pt = model
    pred = Predictor(cfg, model_path=pt, device="cpu",
                     audio_db_path=str(tmp_path / "db"))
    actions = infer_recognition_gui.RecognitionActions(pred)
    assert actions.register(WAV["a_1"], "alice") == (True, "register success")
    assert pred.get_users() == ["alice"]
    for threshold in (0.0, 1.1):        # a match, and no user above 1.1
        pred.threshold = threshold
        result = pred.recognition(WAV["a_2"])
        text = actions.recognise(WAV["a_2"])
        tk = _fake_tk(file_path=WAV["a_2"])
        jmod, calls = _jax_gui(monkeypatch, "infer_recognition_gui", tk,
                               recognition=result)
        jgui = jmod.RecognitionGUI(_Widget())
        jgui.recognise_file()
        assert calls[-1][:2] == ("recognition", (WAV["a_2"],))
        assert text == jgui.result.text
        assert text == ("speaker: alice (%s)" % result[1] if threshold == 0.0
                        else "no matching user")
        gui = infer_recognition_gui.RecognitionGUI(_Widget(), actions, tk)
        gui.recognise_file()
        assert gui.result.text == text
    gui.tk = _fake_tk(name="alice")
    gui.remove_user()
    assert pred.get_users() == []


def test_stream_window_is_jax_s_loop(monkeypatch):
    """60 two-channel blocks of 1024 frames through the port's live-mode
    step and through the JAX GUI's loop over a stand-in microphone: the
    same recognitions, of the same windows, with the same texts."""
    rng = np.random.RandomState(0)
    blocks = [(rng.randn(1024, 2) * 0.1).astype(np.float32)
              for _ in range(60)]
    seen = []

    class Recorder:
        def __init__(self, predictor):
            self.predictor = predictor

        def recognition(self, audio, sample_rate=16000):
            seen.append((self.predictor, np.array(audio), sample_rate))
            return ["alice", 0.9]

    # the port: the window's length after each block, and when it
    # recognises
    window = infer_recognition_gui.StreamWindow(SR)
    actions = infer_recognition_gui.RecognitionActions(Recorder("port"))
    lengths, texts = [], []
    for i, block in enumerate(blocks):
        text = actions.stream_block(window, block)
        lengths.append(len(window.samples))
        assert lengths[-1] == min(1024 * (i + 1), 3 * SR)
        assert (text is None) == (lengths[-1] < SR)
        if text is not None:
            texts.append(text)
    assert lengths.index(16384) == 15 and len(texts) == 60 - 15

    # JAX's loop over a microphone that stops the stream after its blocks
    tk = _fake_tk()
    jmod, _ = _jax_gui(monkeypatch, "infer_recognition_gui", tk)
    jgui = jmod.RecognitionGUI(_Widget())
    jgui.predictor = Recorder("jax")
    feed = list(blocks)

    class Rec:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def record(self, numframes):
            assert numframes == 1024
            block = feed.pop(0)
            if not feed:
                jgui.streaming = False
            return block

    mic = types.SimpleNamespace(recorder=lambda samplerate, blocksize: Rec())
    monkeypatch.setitem(sys.modules, "soundcard", types.SimpleNamespace(
        default_microphone=lambda: mic))
    jtexts = []
    jgui._show = lambda name, score: jtexts.append(
        infer_recognition_gui.recognition_text(name, score))
    jgui.toggle_stream()
    port = [s for s in seen if s[0] == "port"]
    jax = [s for s in seen if s[0] == "jax"]
    assert len(port) == len(jax) == 45
    for (_, a, sra), (_, b, srb) in zip(port, jax):
        assert sra == srb == SR
        np.testing.assert_array_equal(a, b)
    assert texts == jtexts


def test_diarization_action_is_jax_s(model, monkeypatch):
    cfg, pt = model
    pred = Predictor(cfg, model_path=pt, device="cpu")
    actions = infer_speaker_diarization_gui.DiarizationActions(pred)
    results, text = actions.diarize(WAV["test_long"], "2")
    assert results == pred.speaker_diarization(WAV["test_long"],
                                               speaker_num=2)
    assert results and all(r["end"] > r["start"] for r in results)
    plots = []

    class Plot:
        def __init__(self, results, audio_path=None):
            plots.append((results, audio_path))

        def show(self):
            pass

    tk = _fake_tk()
    jmod, calls = _jax_gui(monkeypatch, "infer_speaker_diarization_gui", tk,
                           speaker_diarization=results)
    jmod.PlotSpeaker = Plot
    jgui = jmod.DiarizationGUI(_Widget())
    jgui.path.set(WAV["test_long"])
    jgui.spk_num.set("2")
    jgui.run()
    assert calls[-1] == ("speaker_diarization", (WAV["test_long"],),
                         {"speaker_num": 2, "search_audio_db": False})
    assert text == jgui.text.text
    monkeypatch.setattr(infer_speaker_diarization_gui, "threading", INLINE)
    monkeypatch.setattr(infer_speaker_diarization_gui, "PlotSpeaker", Plot)
    gui = infer_speaker_diarization_gui.DiarizationGUI(
        _Widget(), actions, tk, audio_path=WAV["test_long"], speaker_num=2)
    gui.run()
    assert gui.text.text == text
    assert plots == [(results, WAV["test_long"])] * 2
