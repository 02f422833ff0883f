"""tkinter GUI for 1:1 voiceprint contrast with the port's Predictor
(counterpart of the root ``infer_contrast_gui.py``).

``ContrastActions.compare`` is the button's work: two audio paths in, the
verdict text out, no tk objects. ``ContrastGUI`` is the tk window around
it, with the root GUI's layout and its worker thread. tkinter is imported
by ``main`` alone, and the window needs a display.

Run: python -m voiceprintrecognition_paddlepaddle_torch.infer_contrast_gui
--configs=configs/cam++.yml --model_path=<model.pt> [--device=cuda]
"""

import argparse
import functools
import threading

from .predict import Predictor
from .utils.utils import add_arguments, print_arguments


def contrast_text(score, threshold):
    """The verdict line of a similarity ``score``."""
    verdict = "SAME speaker" if score > threshold else "DIFFERENT speakers"
    return f"{verdict} (similarity {score:.5f})"


class ContrastActions:
    def __init__(self, predictor, threshold=0.6):
        self.predictor = predictor
        self.threshold = threshold

    def compare(self, path1, path2):
        """The contrast button: the verdict text for two audio files."""
        return contrast_text(self.predictor.contrast(path1, path2),
                             self.threshold)


class ContrastGUI:
    def __init__(self, window, actions, tk):
        """``tk``: the ``tkinter`` module, with ``filedialog`` and
        ``messagebox`` imported."""
        self.window = window
        self.actions = actions
        self.tk = tk
        window.title("voiceprint contrast")
        self.path1 = tk.StringVar()
        self.path2 = tk.StringVar()
        for row, (label, var) in enumerate(
                [("audio 1:", self.path1), ("audio 2:", self.path2)]):
            tk.Label(window, text=label).grid(row=row, column=0)
            tk.Entry(window, textvariable=var, width=50).grid(row=row, column=1)
            tk.Button(window, text="browse",
                      command=lambda v=var: v.set(
                          tk.filedialog.askopenfilename())).grid(row=row,
                                                                 column=2)
        tk.Button(window, text="compare", command=self.compare).grid(
            row=2, column=1)
        self.result = tk.Label(window, text="")
        self.result.grid(row=3, column=1)

    def compare(self):
        def run():
            try:
                self.result.config(text=self.actions.compare(
                    self.path1.get(), self.path2.get()))
            except Exception as e:  # noqa: BLE001 - shown to the user
                self.tk.messagebox.showerror("error", str(e))
        threading.Thread(target=run, daemon=True).start()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",    str,   "configs/cam++.yml", "config file path")
    add_arg("device",     str,   "cuda", "torch device: cuda or cpu")
    add_arg("threshold",  float, 0.6,  "same-speaker decision threshold")
    add_arg("model_path", str,   "models/CAMPPlus_Fbank/best_model/",
            "model.pt or its directory")
    args = parser.parse_args(argv)
    print_arguments(args=args)

    import tkinter as tk
    from tkinter import filedialog, messagebox  # noqa: F401 (tk.<name>)

    predictor = Predictor(configs=args.configs, model_path=args.model_path,
                          threshold=args.threshold, device=args.device)
    root = tk.Tk()
    ContrastGUI(root, ContrastActions(predictor, args.threshold), tk)
    root.mainloop()


if __name__ == "__main__":
    main()
