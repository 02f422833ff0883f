"""1:1 voiceprint contrast with the port's Predictor (counterpart of the
root ``infer_contrast.py``).

Run: python -m voiceprintrecognition_paddlepaddle_torch.infer_contrast
--configs=configs/cam++.yml --model_path=<model.pt> [--device=cuda]
"""

import argparse
import functools

from .predict import Predictor
from .utils.utils import add_arguments, print_arguments


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",     str,   "configs/cam++.yml", "config file path")
    add_arg("device",      str,   "cuda", "torch device: cuda or cpu")
    add_arg("audio_path1", str,   "dataset/a_1.wav", "first audio")
    add_arg("audio_path2", str,   "dataset/b_2.wav", "second audio")
    add_arg("threshold",   float, 0.6,  "same-speaker decision threshold")
    add_arg("model_path",  str,   "models/CAMPPlus_Fbank/best_model/",
            "model.pt or its directory")
    args = parser.parse_args(argv)
    print_arguments(args=args)

    predictor = Predictor(configs=args.configs, model_path=args.model_path,
                          threshold=args.threshold, device=args.device)
    dist = predictor.contrast(args.audio_path1, args.audio_path2)
    verdict = "the SAME speaker" if dist > args.threshold else \
        "DIFFERENT speakers"
    print(f"{args.audio_path1} and {args.audio_path2} are {verdict}, "
          f"similarity: {dist:.5f}")
    return dist


if __name__ == "__main__":
    main()
