"""Evaluate EER / MinDCF on the enroll and trials lists with the port's
Trainer (counterpart of the root ``eval.py``; ``--device`` in place of
``--use_gpu``).

Run: python -m voiceprintrecognition_paddlepaddle_torch.eval
--configs=configs/cam++.yml --resume_model=models/CAMPPlus_Fbank/best_model/
[--device=cuda]

Under ``launch_multihost --nproc N`` the evaluation is collective: each
rank embeds its shard of the lists on its own device and every rank
reports the EER of the whole lists; rank 0 logs it and saves the plot.
"""

import argparse
import functools
import time

from .trainer import Trainer
from .utils.logger import logger
from .utils.utils import add_arguments, print_arguments


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",         str, "configs/cam++.yml", "config file path")
    add_arg("device",          str, "cuda", "torch device: cuda or cpu")
    add_arg("save_image_path", str, "output/images/",
            "where to save the DET plot ('' for none)")
    add_arg("resume_model",    str, "models/CAMPPlus_Fbank/best_model/",
            "model checkpoint to evaluate")
    args = parser.parse_args(argv)
    print_arguments(args=args)

    trainer = Trainer(configs=args.configs, device=args.device)
    start = time.time()
    eer, min_dcf, threshold = trainer.evaluate(
        resume_model=args.resume_model,
        save_image_path=args.save_image_path or None)
    if trainer.rank == 0:
        logger.info(f"eval time: {int(time.time() - start)}s, "
                    f"threshold: {threshold:.2f}, EER: {eer:.5f}, "
                    f"MinDCF: {min_dcf:.5f}")
    return eer, min_dcf, threshold


if __name__ == "__main__":
    main()
