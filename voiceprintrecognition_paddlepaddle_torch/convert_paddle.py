"""Convert a reference ``ppvector`` paddle checkpoint to the port's
``model.pt`` (the counterpart of the JAX package's
``tools/convert_paddle_checkpoint.py``; no paddle, no JAX, no PyYAML).

Run: python -m voiceprintrecognition_paddlepaddle_torch.convert_paddle
--configs=configs/cam++.yml --pdparams=/path/to/model.pdparams
--output=models/CAMPPlus_Fbank/converted/

The output directory then works as ``Predictor(model_path=...)`` and as
``Trainer.train(pretrained_model=...)``; ``--with_classifier`` also writes
the classifier head into ``classifier.pt`` beside ``model.pt``.
"""

import argparse
import os

import torch

from .models.convert_paddle import load_pdparams, pdparams_to_torch_state
from .utils.config import load_yaml


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", required=True, help="model YAML")
    ap.add_argument("--pdparams", required=True, help="paddle model.pdparams")
    ap.add_argument("--output", required=True, help="output directory")
    ap.add_argument("--with_classifier", action="store_true",
                    help="also convert the '1.*' classifier keys")
    args = ap.parse_args(argv)

    cfg = load_yaml(args.configs)
    model_args = cfg["model_conf"].get("model_args") or {}
    input_size = (cfg["preprocess_conf"].get("method_args") or {}).get(
        "n_mels", 80)
    state = load_pdparams(args.pdparams)
    cls_conf = None
    if args.with_classifier:
        c = cfg["model_conf"]["classifier"]
        cls_conf = dict(input_dim=model_args.get("embd_dim", 192),
                        num_speakers=c["num_speakers"],
                        classifier_type=c.get("classifier_type", "Cosine"),
                        K=c.get("K", 1), num_blocks=c.get("num_blocks", 0))
    else:
        state = {k: v for k, v in state.items() if not k.startswith("1.")}
    out = pdparams_to_torch_state(state, cfg["model_conf"]["model"],
                                  input_size, model_args=model_args,
                                  classifier_conf=cls_conf)
    os.makedirs(args.output, exist_ok=True)
    path = os.path.join(args.output, "model.pt")
    torch.save(out["model"], path)
    if "classifier" in out:
        torch.save({"classifier": out["classifier"]},
                   os.path.join(args.output, "classifier.pt"))
    print(f"converted {len(out['model'])} tensors -> {path}")
    return path


if __name__ == "__main__":
    main()
