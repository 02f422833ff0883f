"""A reference paddle ``model.pdparams`` -> EER / MinDCF (or a 1:1
contrast score) in one command, with the port (counterpart of the JAX
package's ``tools/eval_from_paddle.py``).

It chains the port's converter (``convert_paddle``) with the port's
``Trainer.evaluate`` over the config's enroll and trials lists, or, with
``--predict``, with ``Predictor.contrast`` of two wavs.

Run: python -m voiceprintrecognition_paddlepaddle_torch.eval_from_paddle
--configs=configs/cam++.yml --pdparams=CAMPPlus_Fbank/best_model/model.pdparams
[--device=cuda] [--predict a.wav b.wav]

The converted ``model.pt`` stays in ``--workdir`` (default: a temporary
directory) for ``eval`` and the ``infer_*`` command lines.
"""

import argparse
import tempfile

from .convert_paddle import main as convert_main


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", required=True, help="model YAML (this repo)")
    ap.add_argument("--pdparams", required=True,
                    help="paddle model.pdparams from the reference")
    ap.add_argument("--workdir", default=None,
                    help="where the converted checkpoint is written "
                         "(default: a temp dir)")
    ap.add_argument("--predict", nargs=2, metavar=("A_WAV", "B_WAV"),
                    default=None,
                    help="score two wavs against each other instead of "
                         "running the enroll/trials EER evaluation")
    ap.add_argument("--threshold", type=float, default=0.6,
                    help="same-speaker decision threshold for --predict")
    ap.add_argument("--save_image_path", default=None,
                    help="optional DET-curve output dir (eval mode; needs "
                         "matplotlib)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda or cpu")
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="paddle_ckpt_")
    convert_main(["--configs", args.configs, "--pdparams", args.pdparams,
                  "--output", workdir])

    if args.predict is not None:
        from .predict import Predictor
        predictor = Predictor(configs=args.configs,
                              threshold=args.threshold,
                              model_path=workdir, device=args.device)
        score = predictor.contrast(args.predict[0], args.predict[1])
        same = bool(score > args.threshold)
        print(f"contrast score: {score:.5f} "
              f"({'same' if same else 'different'} speaker "
              f"@ threshold {args.threshold})")
        return {"score": float(score), "same_speaker": same,
                "checkpoint": workdir}

    from .trainer import Trainer
    trainer = Trainer(configs=args.configs, device=args.device)
    eer, min_dcf, threshold = trainer.evaluate(
        resume_model=workdir, save_image_path=args.save_image_path)
    print(f"EER: {eer:.5f}, MinDCF: {min_dcf:.5f}, "
          f"threshold: {threshold:.2f}")
    print(f"converted checkpoint kept at: {workdir}")
    return {"eer": eer, "min_dcf": min_dcf, "threshold": threshold,
            "checkpoint": workdir}


if __name__ == "__main__":
    main()
