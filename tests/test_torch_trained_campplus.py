"""PyTorch port, the kernel path's plain versions against JAX's Pallas path
(interpret mode) on a *trained* stock CAM++ (192-d): the model that
``tests/test_torch_gpu_workflows.py`` trains on the card, trained here on
the CPU by the port's ``Trainer`` with the JAX diarization bar's recipe (4
tone speakers x 4 clips of 1.2 s, 40 epochs, learning rate 0.05,
``dataset.seed`` 7).

Four of the diarizer's 1.5 s chunks of the card test's conversation (two end
where a turn ends, two lie inside a turn) are embedded at exact length and
padded to their 2 s bucket (ratio 0.75), as ``predict_batch`` pads them:

- the port (``make_campplus_masked_embed_fn`` on CPU tensors: the plain
  fbank, the model's FCM, ``trunk_stats_reference``) against JAX's
  ``make_campplus_masked_embed_fn(interpret=True)`` on the same weights,
  padded and at exact length: cos > 0.9999 (``tests/test_torch_trunk.py``);
- the kernel path's bf16 design at exact length against the fp32 model:
  cos > 0.999 (the bar of ``tests/test_torch_gpu.py``'s diarization
  chunks);
- the bucket padding: each side's cosine of a padded chunk to its
  exact-length embedding, within 1e-3 of the other side's. The padding
  moves the trained model's embedding of a chunk that ends at a turn's end
  on both sides alike (the FCM's edge rows and the rounded-up valid count;
  ROADMAP.md queue 3); the test prints each side's cosines.

Marked slow: the training alone takes about 45 s on two threads."""

import numpy as np
import pytest
import torch

from test_predictor import SR, _configs, _tone, _write_wav
from test_torch_eval_tools import _flax_from_torch
from voiceprintrecognition_paddlepaddle_torch.models import trunk_kernel as tk
from voiceprintrecognition_paddlepaddle_torch.ops.features import \
    AudioFeaturizer
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
from voiceprintrecognition_paddlepaddle_tpu.data_utils.featurizer import \
    AudioFeaturizer as JaxFeaturizer
from voiceprintrecognition_paddlepaddle_tpu.models import CAMPPlus
from voiceprintrecognition_paddlepaddle_tpu.models import pallas_campplus as pc

FBANK = {"sr": SR, "n_mels": 80}
CHUNKS = [3, 4, 8, 9]     # 4 and 9 end where a turn ends


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as ``tests/test_torch_trainer.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


@pytest.mark.slow
def test_trained_campplus_matches_jax_padded_and_exact(tmp_path):
    lines = []
    for spk in range(4):
        for u in range(4):
            p = tmp_path / f"s{spk}_u{u}.wav"
            _write_wav(p, _tone(130 + 80 * spk, 1.2, seed=spk * 10 + u))
            lines.append(f"{p}\t{spk}")
    (tmp_path / "train_list.txt").write_text("\n".join(lines) + "\n",
                                             encoding="utf-8")
    cfg = _configs(tmp_path)
    cfg["preprocess_conf"] = {"feature_method": "Fbank",
                              "method_args": dict(FBANK)}
    cfg["model_conf"]["model"] = "CAMPPlus"
    cfg["model_conf"]["model_args"] = {"embd_dim": 192}
    cfg["train_conf"]["max_epoch"] = 40
    cfg["optimizer_conf"]["scheduler_args"]["learning_rate"] = 0.05
    cfg["dataset_conf"]["dataset"]["seed"] = 7
    trainer = Trainer(configs=cfg, device="cpu")
    trainer.train(save_model_path=str(tmp_path / "models"), log_dir="",
                  do_eval=False)
    pred = Predictor(configs=cfg, device="cpu", model_path=str(
        tmp_path / "models" / "CAMPPlus_Fbank" / "last_model"))
    model = pred.model

    pieces = []
    for i, spk in enumerate([0, 1, 2, 0, 1, 2]):
        pieces.append(_tone(130 + 80 * spk, 4.0, seed=17 * i + spk))
        pieces.append(np.zeros(int(0.8 * SR), np.float32))
    segments = pred.speaker_diarize.segments_audio(
        pred._load_audio(np.concatenate(pieces[:-1]), SR))
    exact = np.stack([np.asarray(segments[i][2], np.float32)
                      for i in CHUNKS])
    n = exact.shape[1]
    assert n == int(1.5 * SR)
    padded = np.zeros((len(exact), 2 * SR), np.float32)
    padded[:, :n] = exact
    ratios = np.full(len(exact), n / (2 * SR), np.float32)

    featurizer = AudioFeaturizer("Fbank", FBANK)
    port = tk.make_campplus_masked_embed_fn(model, featurizer)
    with torch.no_grad():
        got = {"padded": port(torch.from_numpy(padded), ratios).numpy(),
               "exact": port(torch.from_numpy(exact), None).numpy()}
        fp32 = model(featurizer(torch.from_numpy(exact))).numpy()
    variables = _flax_from_torch({k: v.detach().float() for k, v in
                                  model.state_dict().items()})
    jax_embed = pc.make_campplus_masked_embed_fn(
        CAMPPlus(input_size=80, embd_dim=192), variables,
        JaxFeaturizer("Fbank", dict(FBANK)), interpret=True)
    want = {"padded": np.asarray(jax_embed(padded, ratios)),
            "exact": np.asarray(jax_embed(exact, np.ones_like(ratios)))}

    port_padding = _cos(got["padded"], got["exact"])
    jax_padding = _cos(want["padded"], want["exact"])
    print(f"chunks {CHUNKS}: port vs JAX padded {_cos(got['padded'], want['padded'])}, "
          f"exact {_cos(got['exact'], want['exact'])}; bf16 design vs fp32 "
          f"at exact length {_cos(got['exact'], fp32)}; padded vs exact: "
          f"port {port_padding}, JAX {jax_padding}")
    for key in ("padded", "exact"):
        assert _cos(got[key], want[key]).min() > 0.9999, key
    assert _cos(got["exact"], fp32).min() > 0.999
    np.testing.assert_allclose(port_padding, jax_padding, atol=1e-3)
