"""PyTorch port, data-parallel training, evaluation, checkpoints and
serving on the CPU. Two gloo ranks are started by the port's launcher
(``tests/test_torch_parallel_ranks.py``); the references are the JAX
package's single-process results.

- ``evaluate()`` at world 2 of the JAX trainer's tiny CAM++ (the lists and
  weights of ``tests/test_torch_evaluate.py``): both ranks report the EER
  and MinDCF of JAX's ``evaluate``, the threshold within 1e-6, and the
  gathered embeddings, in rank order, at cos >= 0.99999 of JAX's;
- ``Trainer.train`` at world 2 with ``checkpoint_format: orbax`` and
  ``num_devices: 2``: only rank 0 writes checkpoints, TensorBoard and the
  train and test log lines; the checkpoint holds DCP directories; both
  ranks report the same EER and end with the same weights; a resume of it
  at world 2 and at world 1; ``Predictor`` serves it;
- the DCP checkpoint round trip in one process;
- ``Predictor(data_parallel=True, devices=["cpu", "cpu"])`` against JAX's
  ``Predictor(data_parallel=True)`` on the 8-device mesh (11 ragged clips
  and the single-clip route, as ``tests/test_predictor.py:148-170``), and
  the stock CAM++'s kernel path split over two replicas;
- the launcher's exit codes.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import torch_jax_native  # noqa: F401 (JAX's native library, locked)
from test_torch_helpers import (FULL, NARROW, synth_backbone, synth_campplus,
                                speaker_corpus, train_configs)
from test_torch_parallel_ranks import launch_ranks
from torch_card import cos_min, tone
from voiceprintrecognition_paddlepaddle_torch import launch_multihost
from voiceprintrecognition_paddlepaddle_torch import predict as tpredict
from voiceprintrecognition_paddlepaddle_torch.models.convert import \
    jax_to_torch_state
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
from voiceprintrecognition_paddlepaddle_torch.utils.checkpoint import (
    load_checkpoint, load_pretrained, save_checkpoint)
from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
    dict_to_object
from voiceprintrecognition_paddlepaddle_tpu.predict import \
    Predictor as JaxPredictor
from voiceprintrecognition_paddlepaddle_tpu.trainer import \
    Trainer as JaxTrainer

DCP_FILES = ["classifier.dcp", "model.dcp", "model.state", "optimizer.dcp"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as the other training test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    return speaker_corpus(tmp_path_factory.mktemp("corpus"), n_speakers=8,
                          n_utts=6, seconds=(0.5, 1.0))


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def evaluated(tmp_path_factory, lists):
    """JAX's single-process ``evaluate`` and the port's at world 2 on the
    same weights (``tests/test_torch_evaluate.py``'s)."""
    cfg = train_configs(lists, model="CAMPPlus",
                        model_args={"embd_dim": 32, "init_channels": 32},
                        n_mels=80, num_speakers=8)
    jt = JaxTrainer(cfg, use_gpu=False)
    want = jt.evaluate()
    state = jax.device_get(jt.state)
    model = jax_to_torch_state({"params": state.params["backbone"],
                                "batch_stats": state.batch_stats["backbone"]})
    embs = {part: jt._embed_loader(getattr(jt, f"{part}_loader"), part)
            for part in ("enroll", "trials")}
    ranks = launch_ranks(tmp_path_factory.mktemp("eval"), ["evaluate"],
                         {"evaluate": {"cfg": cfg, "model": model}})
    return want, embs, ranks


def test_evaluate_at_world_2_matches_jax(evaluated):
    (eer_j, dcf_j, thr_j), _, ranks = evaluated
    assert 0.05 < eer_j < 0.3
    for out in ranks:
        e = out["evaluate"]
        assert e["eer"] == eer_j and e["min_dcf"] == dcf_j
        assert abs(e["threshold"] - thr_j) <= 1e-6
        assert e["shard"] == 3          # 12 of the 24 enroll clips at b4


def test_evaluate_gathers_the_shards_in_rank_order(evaluated):
    """Rank r embeds clips r, r + 2, ...; the gather puts rank 0's shard
    first, as JAX ``allgather_ragged`` does."""
    _, embs, ranks = evaluated
    for part in ("enroll", "trials"):
        want, labels = (np.asarray(a) for a in embs[part])
        order = np.concatenate([np.arange(24)[0::2], np.arange(24)[1::2]])
        for out in ranks:
            got, got_labels = out["evaluate"]["embeddings"][part]
            np.testing.assert_array_equal(got_labels, labels[order])
            assert got.shape == (24, 32)
            assert cos_min(want[order], got) >= 0.99999, part
        np.testing.assert_array_equal(
            ranks[0]["evaluate"]["embeddings"][part][0],
            ranks[1]["evaluate"]["embeddings"][part][0])


# ---------------------------------------------------------------------------
def _train_cfg(lists, **train_conf):
    return train_configs(lists, batch_size=4, max_epoch=3, num_speakers=8,
                         checkpoint_format="orbax", **train_conf)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, lists):
    root = tmp_path_factory.mktemp("train")
    cfg = _train_cfg(lists, num_devices=2)
    ranks = launch_ranks(root, ["train"],
                         {"train": {"cfg": cfg, "root": str(root)}})
    return cfg, root, ranks


def _logs(root, rank):
    return (root / f"rank{rank}.log").read_text(encoding="utf-8")


def test_only_rank_0_writes_checkpoints_and_logs(trained):
    _, root, _ = trained
    assert not (root / "models_r1").exists()
    assert not (root / "log_r1").exists()
    assert os.listdir(root / "log_r0")
    log0, log1 = _logs(root, 0), _logs(root, 1)
    for line in ("Train epoch: [1/1]", "Test epoch: 1", "checkpoint saved"):
        assert line in log0 and line not in log1, line
    assert "rank 1 of 2" in log1 and "rank 0 of 2" in log0


def test_orbax_format_writes_dcp_directories(trained):
    _, root, _ = trained
    base = root / "models_r0" / "TDNN_Fbank"
    assert sorted(os.listdir(base)) == ["best_model", "epoch_1", "epoch_2",
                                        "last_model"]
    for tag in ("epoch_1", "best_model", "last_model"):
        assert sorted(os.listdir(base / tag)) == DCP_FILES, tag
        assert os.path.exists(base / tag / "model.dcp" / ".metadata")


def test_ranks_agree_after_ddp_training(trained):
    _, _, ranks = trained
    a, b = (r["train"] for r in ranks)
    assert a["first"]["eer"] == b["first"]["eer"]
    assert a["first"]["min_dcf"] == b["first"]["min_dcf"]
    # 48 clips at b4 over 2 ranks: 6 steps an epoch
    assert a["first"]["steps_per_epoch"] == 6 and a["first"]["step"] == 6
    for k, v in a["first"]["state"].items():
        torch.testing.assert_close(v, b["first"]["state"][k], rtol=1e-6,
                                   atol=1e-7)


def test_orbax_checkpoint_resumes_at_world_2_and_world_1(trained):
    """The second run of both ranks resumed rank 0's epoch 1 (step 6) and
    trained epoch 2; then one process resumes epoch 2's checkpoint
    (step 12) for a third epoch of 12 steps at b4."""
    cfg, root, ranks = trained
    for rank, out in enumerate(ranks):
        assert out["train"]["resumed_step"] == 12
        log = _logs(root, rank)
        assert "resumed model + optimizer state" in log
        assert "auto-resume from latest model failed" not in log
    assert "Train epoch: [2/2]" in _logs(root, 0)
    assert "Train epoch: [1/2]" not in _logs(root, 0)
    save = str(root / "models_r0")
    tr = Trainer(cfg, device="cpu")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
    _, last_epoch, _ = load_checkpoint(tr.configs, tr.load_train_state, save)
    assert last_epoch == 2 and tr.step == 12
    for k, v in ranks[0]["train"]["state"].items():
        torch.testing.assert_close(tr.model.state_dict()[k], v)
    assert len(tr.optimizer.state) == len(tr.param_names)
    tr = Trainer(cfg, device="cpu")
    tr.train(save_model_path=save, log_dir="", max_epochs=3, do_eval=False)
    assert tr.world == 1 and tr.step == 12 + 12
    last = root / "models_r0" / "TDNN_Fbank" / "last_model"
    assert sorted(os.listdir(last)) == DCP_FILES


def test_predictor_serves_the_dcp_checkpoint(trained, tmp_path):
    cfg, root, ranks = trained
    epoch_1 = root / "models_r0" / "TDNN_Fbank" / "epoch_1"
    torch.save(ranks[0]["train"]["first"]["state"], tmp_path / "model.pt")
    clips = [tone(150 + 40 * i, 0.6 + 0.2 * i, seed=i) for i in range(3)]
    got = Predictor(cfg, model_path=str(epoch_1),
                    device="cpu").predict_batch(clips)
    want = Predictor(cfg, model_path=str(tmp_path / "model.pt"),
                     device="cpu").predict_batch(clips)
    np.testing.assert_array_equal(got, want)
    direct = Predictor(cfg, model_path=str(epoch_1 / "model.dcp"),
                       device="cpu").predict_batch(clips)
    np.testing.assert_array_equal(direct, want)


# ---------------------------------------------------------------------------
def test_dcp_checkpoint_round_trip(lists, tmp_path):
    """``save_checkpoint`` under ``checkpoint_format: orbax``, then
    ``load_checkpoint`` and ``load_pretrained`` in one process: every
    tensor of the five entries back, the optimizer's state under its
    integer keys."""
    cfg = _train_cfg(lists)
    tr = Trainer(cfg, device="cpu")
    tr.train(save_model_path="", log_dir="", max_epochs=1, do_eval=False)
    state = tr.train_state()
    conf = dict_to_object(cfg)
    save_checkpoint(conf, state, str(tmp_path), 1)
    path = tmp_path / "TDNN_Fbank" / "epoch_1"
    assert sorted(os.listdir(path)) == DCP_FILES
    got = {}
    _, last_epoch, _ = load_checkpoint(conf, got.update, str(tmp_path),
                                       resume_model=str(path))
    assert last_epoch == 1 and got["step"] == tr.step == 12
    for key in ("model", "classifier", "loss"):
        assert got[key].keys() == state[key].keys()
        for k, v in state[key].items():
            torch.testing.assert_close(got[key][k], v, rtol=0, atol=0)
    assert sorted(got["optimizer"]["state"]) == list(range(
        len(tr.param_names)))
    for i, st in state["optimizer"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(got["optimizer"]["state"][i][k], v)
    fresh = Trainer(cfg, device="cpu")
    fresh._setup_dataloader(is_train=True)
    fresh._setup_model(fresh.audio_featurizer.feature_dim, is_train=True)
    n = load_pretrained({"model": fresh.model, "classifier": fresh.classifier},
                        str(path))
    assert n == len(state["model"]) + len(state["classifier"])


def test_num_devices_in_one_process_trains_on_one_device(lists):
    tr = Trainer(_train_cfg(lists, num_devices=2), device="cpu")
    tr.train(save_model_path="", log_dir="", max_epochs=1, do_eval=False)
    assert (tr.rank, tr.world) == (0, 1) and tr.step == 12
    assert type(tr._net).__name__ == "_TrainNet"


# ---------------------------------------------------------------------------
def _tdnn_files(root):
    _, v, tm = synth_backbone("TDNN", NARROW["TDNN"], input_size=40, seed=11)
    torch.save(tm.state_dict(), str(root / "model.pt"))
    (root / "model.msgpack").write_bytes(serialization.msgpack_serialize(v))
    cfg = train_configs([None, None, None], model="TDNN",
                        model_args=dict(NARROW["TDNN"]), n_mels=40)
    return cfg, str(root / "model.pt"), str(root / "model.msgpack")


def test_data_parallel_predictor_matches_jax(tmp_path):
    """11 ragged clips split over two CPU replicas against JAX's
    ``Predictor(data_parallel=True)`` on its 8-device mesh and the port's
    one-device ``Predictor``; a single clip takes the first device."""
    cfg, pt, msgpack = _tdnn_files(tmp_path)
    pred = Predictor(cfg, model_path=pt, device="cpu", data_parallel=True,
                     devices=["cpu", "cpu"])
    assert len(pred._replicas) == 2
    assert pred._replicas[1][1] is not pred.model
    one = Predictor(cfg, model_path=pt, device="cpu")
    jpred = JaxPredictor(cfg, model_path=msgpack, use_gpu=False,
                         data_parallel=True)
    assert jpred._mesh is not None and jpred._mesh.devices.size == 8
    clips = [tone(140 + 17 * i, 0.6 + 0.13 * i, seed=i) for i in range(11)]
    calls = []
    real = pred._embed_on
    pred._embed_on = (lambda r, w, q: calls.append((r, w.shape))
                      or real(r, w, q))
    got = pred.predict_batch(clips)
    assert calls == [(0, (8, 32000)), (1, (8, 32000))]
    want = jpred.predict_batch(clips)
    assert got.shape == want.shape == (11, 16)
    assert cos_min(want, got) > 0.9999
    np.testing.assert_allclose(got, one.predict_batch(clips), rtol=0,
                               atol=1e-5)
    calls.clear()
    single = pred.predict(clips[0])
    assert [c[0] for c in calls] == [0]
    np.testing.assert_allclose(single, jpred.predict(clips[0]), atol=1e-4)


def test_data_parallel_predictor_splits_the_kernel_path(tmp_path,
                                                        monkeypatch):
    """The stock CAM++ (the kernel path, plain versions on the CPU) over
    two replicas: each packs its own weights and embeds its share; the
    rows equal the one-device ``Predictor``'s."""
    _, _, tm = synth_campplus(FULL, seed=3)
    pt = str(tmp_path / "model.pt")
    torch.save(tm.state_dict(), pt)
    cfg = train_configs([None, None, None], model="CAMPPlus",
                        model_args=dict(FULL), n_mels=80)
    packs = []
    real = tpredict.make_campplus_masked_embed_fn
    monkeypatch.setattr(tpredict, "make_campplus_masked_embed_fn",
                        lambda m, f: packs.append(m) or real(m, f))
    pred = Predictor(cfg, model_path=pt, device="cpu", data_parallel=True,
                     devices=["cpu", "cpu"])
    assert len(packs) == 2 and packs[0] is not packs[1]
    one = Predictor(cfg, model_path=pt, device="cpu")
    rng = np.random.RandomState(4)
    clips = [(rng.randn(n) * 0.05).astype(np.float32)
             for n in (16000, 20000, 31000)]
    got = pred.predict_batch(clips)
    np.testing.assert_allclose(got, one.predict_batch(clips), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("failing,want", [("1", 3), ("none", 124)])
def test_launcher_stops_every_rank(failing, want):
    """A rank that fails stops the others and gives its code; ranks that
    outlive ``timeout`` give 124."""
    code = ("import os, sys, time\n"
            f"if os.environ['VPR_PROCESS_ID'] == {failing!r}: sys.exit(3)\n"
            "time.sleep(60)\n")
    rc = launch_multihost.launch([sys.executable, "-c", code], 2,
                                 timeout=3)
    assert rc == want
