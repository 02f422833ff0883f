"""tkinter GUI for 1:N voiceprint recognition with registration and a
streaming real-time mode, with the port's Predictor (counterpart of the
root ``infer_recognition_gui.py``, its block-wise live recognition loop
included).

``RecognitionActions`` holds the buttons' work with plain values in and
out: register, recognise (the result text), remove a user, and one step of
the live mode over a ``StreamWindow`` (append a 1024-frame block, keep the
last 3 s, recognise once at least 1 s is held). ``RecognitionGUI`` is the
tk window around them, with the root GUI's layout, worker threads and
microphone (``utils/record.py`` and the ``soundcard`` package). tkinter is
imported by ``main`` alone, and the window needs a display.

Run: python -m voiceprintrecognition_paddlepaddle_torch.infer_recognition_gui
--configs=configs/cam++.yml --model_path=<model.pt> [--device=cuda]
[--audio_db_path=audio_db/]
"""

import argparse
import functools
import threading

import numpy as np

from .predict import Predictor
from .utils.record import RecordAudio
from .utils.utils import add_arguments, print_arguments

# the live mode's microphone block, in frames
STREAM_BLOCK = 1024


def recognition_text(name, score):
    """The result line of a recognition ``[name, score]``."""
    return f"speaker: {name} ({score})" if name else "no matching user"


class StreamWindow:
    """The live mode's sliding window: each block is appended (a
    multi-channel block averaged to mono) and the last ``seconds`` are
    kept; it is ready to recognise once it holds one second."""

    def __init__(self, sample_rate, seconds=3):
        self.sample_rate = sample_rate
        self.max_samples = sample_rate * seconds
        self.samples = np.zeros(0, dtype=np.float32)

    def push(self, block):
        """Append ``block``; returns whether the window holds 1 s."""
        block = np.asarray(block, np.float32)
        if block.ndim == 2:
            block = block.mean(axis=1)
        self.samples = np.concatenate([self.samples, block])[
            -self.max_samples:]
        return len(self.samples) >= self.sample_rate


class RecognitionActions:
    def __init__(self, predictor):
        self.predictor = predictor

    def register(self, audio, user_name, sample_rate=16000):
        """Register ``user_name`` from a path or samples: (ok, message)."""
        return self.predictor.register(audio, user_name=user_name,
                                       sample_rate=sample_rate)

    def recognise(self, audio, sample_rate=16000):
        """The result text for a path or samples."""
        return recognition_text(*self.predictor.recognition(
            audio, sample_rate=sample_rate))

    def stream_block(self, window, block):
        """One step of the live mode: ``block`` into ``window``; the
        result text once the window holds 1 s, else None."""
        if not window.push(block):
            return None
        return self.recognise(window.samples.copy(),
                              sample_rate=window.sample_rate)

    def remove_user(self, user_name):
        return self.predictor.remove_user(user_name)


class RecognitionGUI:
    def __init__(self, window, actions, tk, record_seconds=3):
        """``tk``: the ``tkinter`` module, with ``filedialog``,
        ``messagebox`` and ``simpledialog`` imported."""
        self.window = window
        self.actions = actions
        self.tk = tk
        self.record_seconds = record_seconds
        window.title("voiceprint recognition")
        self.recorder = RecordAudio()
        self.streaming = False

        tk.Button(window, text="register (record)",
                  command=self.register_record).grid(row=0, column=0)
        tk.Button(window, text="register (file)",
                  command=self.register_file).grid(row=0, column=1)
        tk.Button(window, text="recognise (record)",
                  command=self.recognise_record).grid(row=1, column=0)
        tk.Button(window, text="recognise (file)",
                  command=self.recognise_file).grid(row=1, column=1)
        self.stream_btn = tk.Button(window, text="start live recognition",
                                    command=self.toggle_stream)
        self.stream_btn.grid(row=2, column=0)
        tk.Button(window, text="remove user",
                  command=self.remove_user).grid(row=2, column=1)
        self.result = tk.Label(window, text="")
        self.result.grid(row=3, column=0, columnspan=2)

    def register_record(self):
        name = self.tk.simpledialog.askstring("register", "user name:")
        if not name:
            return

        def run():
            audio = self.recorder.record(self.record_seconds)
            self.actions.register(audio, name, self.recorder.sample_rate)
        threading.Thread(target=run, daemon=True).start()

    def register_file(self):
        path = self.tk.filedialog.askopenfilename()
        name = self.tk.simpledialog.askstring("register", "user name:")
        if path and name:
            self.actions.register(path, name)

    def recognise_record(self):
        def run():
            audio = self.recorder.record(self.record_seconds)
            self.result.config(text=self.actions.recognise(
                audio, self.recorder.sample_rate))
        threading.Thread(target=run, daemon=True).start()

    def recognise_file(self):
        path = self.tk.filedialog.askopenfilename()
        if path:
            self.result.config(text=self.actions.recognise(path))

    def toggle_stream(self):
        """Streaming mode: microphone blocks of ``STREAM_BLOCK`` frames
        into a sliding window, recognised again after every block."""
        if self.streaming:
            self.streaming = False
            self.stream_btn.config(text="start live recognition")
            return
        self.streaming = True
        self.stream_btn.config(text="stop live recognition")

        def run():
            window = StreamWindow(self.recorder.sample_rate)
            try:
                import soundcard
                mic = soundcard.default_microphone()
                with mic.recorder(samplerate=window.sample_rate,
                                  blocksize=STREAM_BLOCK) as rec:
                    while self.streaming:
                        text = self.actions.stream_block(
                            window, rec.record(numframes=STREAM_BLOCK))
                        if text is not None:
                            self.result.config(text=text)
            except Exception as e:  # noqa: BLE001 - shown to the user
                self.streaming = False
                self.tk.messagebox.showerror("error", str(e))
        threading.Thread(target=run, daemon=True).start()

    def remove_user(self):
        name = self.tk.simpledialog.askstring("remove", "user name:")
        if name:
            self.actions.remove_user(name)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",        str,   "configs/cam++.yml", "config file path")
    add_arg("device",         str,   "cuda", "torch device: cuda or cpu")
    add_arg("audio_db_path",  str,   "audio_db/", "voiceprint database directory")
    add_arg("threshold",      float, 0.6,  "recognition threshold")
    add_arg("record_seconds", int,   3,    "seconds per recorded utterance")
    add_arg("model_path",     str,   "models/CAMPPlus_Fbank/best_model/",
            "model.pt or its directory")
    args = parser.parse_args(argv)
    print_arguments(args=args)

    import tkinter as tk
    from tkinter import filedialog, messagebox, simpledialog  # noqa: F401

    predictor = Predictor(configs=args.configs, model_path=args.model_path,
                          threshold=args.threshold,
                          audio_db_path=args.audio_db_path,
                          device=args.device)
    root = tk.Tk()
    RecognitionGUI(root, RecognitionActions(predictor), tk,
                   record_seconds=args.record_seconds)
    root.mainloop()


if __name__ == "__main__":
    main()
