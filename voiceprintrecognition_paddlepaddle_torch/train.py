"""Train a speaker-verification model with the port's Trainer (counterpart
of the root ``train.py``; ``--device`` in place of ``--use_gpu``).

Run: python -m voiceprintrecognition_paddlepaddle_torch.train
--configs=configs/cam++.yml [--device=cuda] [--data_augment_configs=...]
"""

import argparse
import functools

from .trainer import Trainer
from .utils.utils import add_arguments, print_arguments


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",          str,  "configs/cam++.yml", "config file path")
    add_arg("data_augment_configs", str, "configs/augmentation.yml",
            "augmentation config file path ('' for none)")
    add_arg("device",           str,  "cuda", "torch device: cuda or cpu")
    add_arg("save_model_path",  str,  "models/", "where to save checkpoints")
    add_arg("log_dir",          str,  "log/", "TensorBoard log directory")
    add_arg("resume_model",     str,  None, "checkpoint to resume; None = auto")
    add_arg("pretrained_model", str,  None, "pretrained weights to start from")
    add_arg("do_eval",          bool, True, "evaluate at every epoch end")
    args = parser.parse_args(argv)
    print_arguments(args=args)

    trainer = Trainer(configs=args.configs, device=args.device,
                      data_augment_configs=args.data_augment_configs)
    trainer.train(save_model_path=args.save_model_path,
                  log_dir=args.log_dir,
                  resume_model=args.resume_model,
                  pretrained_model=args.pretrained_model,
                  do_eval=args.do_eval)
    return trainer


if __name__ == "__main__":
    main()
