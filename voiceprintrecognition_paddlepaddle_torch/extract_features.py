"""Pre-extract features to ``.npy`` for faster training with the port's
Trainer (counterpart of the root ``extract_features.py``; ``--device`` in
place of the accelerator default). On the card the stock Fbank runs the
fbank kernel. Writes a ``*_features.txt`` list beside each list in the
config that exists; point ``dataset_conf.train_list`` (and the eval lists)
at them to train from the features.

Run: python -m voiceprintrecognition_paddlepaddle_torch.extract_features
--configs=configs/cam++.yml [--device=cuda] [--save_dir=dataset/features]
"""

import argparse
import functools

from .trainer import Trainer
from .utils.utils import add_arguments, print_arguments


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",      str, "configs/cam++.yml", "config file path")
    add_arg("device",       str, "cuda", "torch device: cuda or cpu")
    add_arg("save_dir",     str, "dataset/features", "feature output directory")
    add_arg("max_duration", int, 100, "max seconds of audio to featurize")
    args = parser.parse_args(argv)
    print_arguments(args=args)

    trainer = Trainer(configs=args.configs, device=args.device)
    trainer.extract_features(save_dir=args.save_dir,
                             max_duration=args.max_duration)
    return trainer


if __name__ == "__main__":
    main()
