"""Run diarization over the test list, writing a hypothesis RTTM with the
port's Predictor (counterpart of the JAX package's
``tools/eval_speaker_diarization/infer_data.py``; ``--device`` in place of
``--use_gpu``).

The defaults of ``--configs`` and ``--model_path`` are relative to the
repository root, where ``python -m`` runs it (JAX's script runs inside
``tools/eval_speaker_diarization/`` and defaults to ``../../configs`` and
``../../models``); the data paths keep JAX's defaults.

Each listed file is diarized with the speakers named from its own
audio_db (``<audio_db_path>/<name>/<speaker>/*.wav``); the index file the
Predictor writes there is removed afterwards.

Run: python -m voiceprintrecognition_paddlepaddle_torch.eval_speaker_diarization.infer_data
[--model_path=models/CAMPPlus_Fbank/best_model/] [--configs=configs/cam++.yml] [--device=cuda]
[--data_list_path=dataset/data_list.txt] [--result_path=dataset/hypotheses.rttm]
[--audio_db_path=dataset/audio_db/]
"""

import argparse
import functools
import os

from ..infer_utils.der import write_rttm
from ..predict import Predictor
from ..utils.utils import add_arguments, print_arguments


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",        str,   "configs/cam++.yml", "config file path")
    add_arg("device",         str,   "cuda", "torch device: cuda or cpu")
    add_arg("data_list_path", str,   "dataset/data_list.txt", "test audio list")
    add_arg("result_path",    str,   "dataset/hypotheses.rttm", "output RTTM")
    add_arg("audio_db_path",  str,   "dataset/audio_db/",
            "per-file audio_db root")
    add_arg("threshold",      float, 0.6, "same-speaker threshold")
    add_arg("model_path",     str,   "models/CAMPPlus_Fbank/best_model/",
            "model.pt or its directory")
    args = parser.parse_args(argv)
    print_arguments(args=args)

    with open(args.data_list_path, "r", encoding="utf-8") as f_r, \
            open(args.result_path, "w", encoding="utf-8") as f_w:
        for line in f_r:
            audio_path, name = line.strip().split("\t")
            audio_db_path = os.path.join(args.audio_db_path, name)
            predictor = Predictor(configs=args.configs,
                                  model_path=args.model_path,
                                  threshold=args.threshold,
                                  audio_db_path=audio_db_path,
                                  device=args.device)
            results = predictor.speaker_diarization(audio_path,
                                                    search_audio_db=True)
            write_rttm(f_w, name, results)
            index = os.path.join(audio_db_path, "audio_indexes.bin")
            if os.path.exists(index):
                os.remove(index)


if __name__ == "__main__":
    main()
