"""PyTorch port, ``Trainer.evaluate`` pinned against the JAX
``Trainer.evaluate`` (ROADMAP.md queue 3, "Unpinned").

The JAX trainer's initialized tiny CAM++ (all 52 layers, 32 channels) is
carried into the port by ``jax_to_torch_state`` and both trainers
evaluate the same lists on the CPU: 8 tone speakers, 3 enroll and 3 trial
clips of 0.5-1 s each (one 1 s bucket), where the EER is 0.105 and the
MinDCF 0.806, neither 0 nor near 0.5 (the TDNN of the probe gave 0.58,
this CAM++ over 4 speakers gave 0). Bars: the EER and the MinDCF equal,
the thresholds within 1e-6 (measured 6e-8), the enroll and trial
embeddings at cos >= 0.99999 row by row."""

import jax
import numpy as np
import pytest
import torch

import torch_jax_native  # noqa: F401 (JAX's native library, locked)
from test_torch_helpers import speaker_corpus, train_configs
from torch_card import cos_min
from voiceprintrecognition_paddlepaddle_torch.models.convert import \
    jax_to_torch_state
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
from voiceprintrecognition_paddlepaddle_tpu.trainer import \
    Trainer as JaxTrainer


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as the other training test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_evaluate_matches_jax(tmp_path):
    lists = speaker_corpus(tmp_path, n_speakers=8, n_utts=6,
                           seconds=(0.5, 1.0))
    cfg = train_configs(lists, model="CAMPPlus",
                        model_args={"embd_dim": 32, "init_channels": 32},
                        n_mels=80, num_speakers=8)
    jt = JaxTrainer(cfg, use_gpu=False)
    eer_j, dcf_j, thr_j = jt.evaluate()
    state = jax.device_get(jt.state)
    tr = Trainer(cfg, device="cpu")
    tr._setup_dataloader()
    tr._setup_model(tr.audio_featurizer.feature_dim)
    tr.model.load_state_dict(jax_to_torch_state(
        {"params": state.params["backbone"],
         "batch_stats": state.batch_stats["backbone"]}))
    eer, dcf, thr = tr.evaluate()
    assert 0.05 < eer_j < 0.3
    assert eer == eer_j and dcf == dcf_j
    assert abs(thr - thr_j) <= 1e-6
    for part in ("enroll", "trials"):
        loader = getattr(jt, f"{part}_loader")
        want, labels = jt._embed_loader(loader, part)
        got, got_labels = tr.eval_embeddings[part]
        np.testing.assert_array_equal(got_labels, labels)
        assert got.shape == (24, 32)
        assert cos_min(np.asarray(want), got.numpy()) >= 0.99999, part
