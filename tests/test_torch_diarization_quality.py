"""PyTorch port, the diarization quality bar: the port's counterpart of
``tests/test_predictor.py::test_diarization_der_regression``.

The same construction: 4 tone speakers x 4 clips of 1.2 s at
``130 + 80 * spk`` Hz, the tiny TDNN config of ``_configs`` with JAX's
recipe (40 epochs, learning rate 0.05, ``dataset.seed`` 7), trained by the
port's ``Trainer(device="cpu")``; a 6-turn, 3-speaker conversation of 4 s
turns and 0.8 s gaps with fresh seeds, diarized by
``Predictor(device="cpu")`` with ``speaker_num=3`` and scored by the port's
``der.py`` after a round trip through ``write_rttm`` and ``load_rttm``. The
same bar: 3 speakers, DER < 0.20, confusion < 0.05."""

import numpy as np
import pytest
import torch

from test_predictor import SR, _configs, _tone, _write_wav
from voiceprintrecognition_paddlepaddle_torch.infer_utils.der import (
    diarization_error_rate, load_rttm, write_rttm)
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as ``tests/test_torch_trainer.py``: the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_diarization_der_regression(tmp_path):
    root = tmp_path
    lines = []
    for spk in range(4):
        for u in range(4):
            p = root / f"s{spk}_u{u}.wav"
            _write_wav(p, _tone(130 + 80 * spk, 1.2, seed=spk * 10 + u))
            lines.append(f"{p}\t{spk}")
    (root / "train_list.txt").write_text("\n".join(lines) + "\n",
                                         encoding="utf-8")
    cfg = _configs(root)
    cfg["train_conf"]["max_epoch"] = 40
    cfg["optimizer_conf"]["scheduler_args"]["learning_rate"] = 0.05
    cfg["dataset_conf"]["dataset"]["seed"] = 7
    trainer = Trainer(configs=cfg, device="cpu")
    trainer.train(save_model_path=str(root / "models"), log_dir="",
                  do_eval=False)
    model_path = str(root / "models" / "TDNN_Fbank" / "last_model")
    pred = Predictor(configs=cfg, model_path=model_path, device="cpu")

    turn_s, gap_s = 4.0, 0.8
    order = [0, 1, 2, 0, 1, 2]
    f0s = [130, 210, 290]
    pieces, reference, t0 = [], [], 0.0
    for i, spk in enumerate(order):
        pieces.append(_tone(f0s[spk], turn_s, seed=17 * i + spk))
        reference.append((t0, t0 + turn_s, f"spk{spk}"))
        t0 += turn_s
        if i != len(order) - 1:
            pieces.append(np.zeros(int(gap_s * SR), np.float32))
            t0 += gap_s
    audio = np.concatenate(pieces)

    out = pred.speaker_diarization(audio, sample_rate=SR, speaker_num=3)
    assert len({s["speaker"] for s in out}) == 3

    hyp_path = tmp_path / "hyp.rttm"
    with open(hyp_path, "w", encoding="utf-8") as f:
        write_rttm(f, "synth", out)
    hyp = load_rttm(str(hyp_path))["synth"]

    res = diarization_error_rate(reference, hyp, detailed=True)
    assert res["diarization error rate"] < 0.20, res
    assert res["confusion"] < 0.05, res
