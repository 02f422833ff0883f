"""tkinter GUI for speaker diarization with timeline rendering, with the
port's Predictor (counterpart of the root
``infer_speaker_diarization_gui.py``).

``DiarizationActions.diarize`` is the button's work: an audio path and the
speaker-count field's text in, the segments and the text box's lines out,
no tk objects. ``DiarizationGUI`` is the tk window around it, with the
root GUI's layout and worker thread; after a run it opens the timeline
(``infer_utils/viewer.PlotSpeaker.show``, which needs matplotlib).
tkinter is imported by ``main`` alone, and the window needs a display.

Run: python -m voiceprintrecognition_paddlepaddle_torch.infer_speaker_diarization_gui
--configs=configs/cam++.yml --model_path=<model.pt> [--device=cuda]
[--audio_path=dataset/test_long.wav] [--search_audio_db=True]
"""

import argparse
import functools
import threading

from .infer_utils.viewer import PlotSpeaker
from .predict import Predictor
from .utils.utils import add_arguments, print_arguments


def diarization_text(results):
    """The text box's lines: one segment dict a line."""
    return "".join(f"{r}\n" for r in results)


class DiarizationActions:
    def __init__(self, predictor, search_audio_db=False):
        self.predictor = predictor
        self.search_audio_db = search_audio_db

    def diarize(self, audio_path, speaker_num=""):
        """The run button: ``speaker_num`` is the field's text (blank for
        the eigen-gap count). Returns (segments, text)."""
        spk = int(speaker_num) if speaker_num else None
        results = self.predictor.speaker_diarization(
            audio_path, speaker_num=spk,
            search_audio_db=self.search_audio_db)
        return results, diarization_text(results)


class DiarizationGUI:
    def __init__(self, window, actions, tk, audio_path="", speaker_num=None):
        """``tk``: the ``tkinter`` module, with ``filedialog`` and
        ``messagebox`` imported."""
        self.window = window
        self.actions = actions
        self.tk = tk
        window.title("speaker diarization")
        self.path = tk.StringVar(value=audio_path)
        tk.Label(window, text="audio:").grid(row=0, column=0)
        tk.Entry(window, textvariable=self.path, width=50).grid(row=0, column=1)
        tk.Button(window, text="browse",
                  command=lambda: self.path.set(
                      tk.filedialog.askopenfilename())).grid(row=0, column=2)
        tk.Label(window, text="speakers (blank=auto):").grid(row=1, column=0)
        self.spk_num = tk.StringVar(
            value="" if speaker_num is None else str(speaker_num))
        tk.Entry(window, textvariable=self.spk_num, width=6).grid(row=1,
                                                                  column=1)
        tk.Button(window, text="run diarization",
                  command=self.run).grid(row=2, column=1)
        self.text = tk.Text(window, width=70, height=15)
        self.text.grid(row=3, column=0, columnspan=3)

    def run(self):
        def task():
            try:
                results, text = self.actions.diarize(self.path.get(),
                                                     self.spk_num.get())
                self.text.delete("1.0", self.tk.END)
                self.text.insert(self.tk.END, text)
                PlotSpeaker(results, audio_path=self.path.get()).show()
            except Exception as e:  # noqa: BLE001 - shown to the user
                self.tk.messagebox.showerror("error", str(e))
        threading.Thread(target=task, daemon=True).start()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",       str,  "configs/cam++.yml", "config file path")
    add_arg("audio_path",    str,  "dataset/test_long.wav",
            "audio preselected in the file box")
    add_arg("device",        str,  "cuda", "torch device: cuda or cpu")
    add_arg("audio_db_path", str,  "audio_db/", "voiceprint database directory")
    add_arg("search_audio_db", bool, False, "name speakers from the database")
    add_arg("speaker_num",   int,  None, "oracle speaker count (optional)")
    add_arg("threshold",     float, 0.6,
            "same-speaker decision threshold for audio-db matching")
    add_arg("model_path",    str,  "models/CAMPPlus_Fbank/best_model/",
            "model.pt or its directory")
    args = parser.parse_args(argv)
    print_arguments(args=args)

    import tkinter as tk
    from tkinter import filedialog, messagebox  # noqa: F401 (tk.<name>)

    predictor = Predictor(
        configs=args.configs, model_path=args.model_path, device=args.device,
        threshold=args.threshold,
        audio_db_path=args.audio_db_path if args.search_audio_db else None)
    root = tk.Tk()
    DiarizationGUI(root, DiarizationActions(predictor, args.search_audio_db),
                   tk, audio_path=args.audio_path, speaker_num=args.speaker_num)
    root.mainloop()


if __name__ == "__main__":
    main()
