"""PyTorch port, ``Trainer(device="cpu")`` end to end on a synthetic corpus
(4 tone speakers): ``train`` for 2 epochs on a tiny TDNN and a tiny CAM++
with augmentation, the checkpoint layout and ``model.state`` keys of the
JAX ``save_checkpoint``, resume (the step and the epoch go on),
``Predictor(device="cpu")`` serving ``best_model`` with the trainer's
eval embeddings, the ``train`` / ``eval`` command lines, the options
that were once deferred (each now runs), and one train step of each of the 7 backbones (a finite loss, BN
statistics that move)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import NARROW, speaker_corpus, train_configs
from torch_card import cos_min
from voiceprintrecognition_paddlepaddle_torch.optimizer import \
    AdamLowPrecisionMoment
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG = {"speed": {"prob": 0.5, "speed_perturb_3_class": False},
       "volume": {"prob": 0.2, "min_gain_dBFS": -15, "max_gain_dBFS": 15},
       "noise": None, "reverb": None,
       "spec_aug": {"prob": 0.5, "freq_mask_ratio": 0.1, "n_freq_masks": 1,
                    "time_mask_ratio": 0.05, "n_time_masks": 1}}
MODELS = {"TDNN": ({"embd_dim": 32, "channels": 32, "pooling_type": "TSP"},
                   40),
          "CAMPPlus": ({"embd_dim": 32, "init_channels": 32}, 80)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this file: the suite runs six workers on the
    host's cores, and torch's default pool of one thread per core in each
    worker oversubscribes them (this file took 930 s in a six-worker run,
    30 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    return speaker_corpus(tmp_path_factory.mktemp("corpus"))


def _cfg(lists, name, **kw):
    args, n_mels = MODELS.get(name, (None, 40))
    return train_configs(lists, model=name, model_args=dict(args),
                         n_mels=n_mels, **kw)


def _jax_layout(tmp_path, cfg):
    """What the JAX ``save_checkpoint`` writes in the JAX trainer's calls
    of a 2-epoch run with evaluation (``trainer.py:615-629``): the
    directories and their ``model.state``."""
    from voiceprintrecognition_paddlepaddle_tpu.utils import checkpoint
    from voiceprintrecognition_paddlepaddle_tpu.utils.utils import \
        dict_to_object

    class State:
        params = {"w": np.zeros(2, np.float32)}
        batch_stats, loss_params, opt_state = {}, {}, ()
        step = np.int32(6)

    cfg = dict_to_object(cfg)
    save = str(tmp_path / "jax")
    for epoch in (1, 2):
        for best in (True, False):
            checkpoint.save_checkpoint(cfg, State, save, epoch, eer=0.25,
                                       min_dcf=0.5, threshold=0.4,
                                       margin=0.1, best_model=best)
    base = os.path.join(save, "TDNN_Fbank")
    return {d: json.load(open(os.path.join(base, d, "model.state")))
            for d in sorted(os.listdir(base))}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_saves_resumes_and_serves(lists, tmp_path, name):
    cfg = _cfg(lists, name)
    save = str(tmp_path / "models")
    tr = Trainer(cfg, device="cpu", data_augment_configs=AUG)
    tr.train(save_model_path=save, log_dir="", do_eval=True)
    base = os.path.join(save, f"{name}_Fbank")
    assert sorted(os.listdir(base)) == ["best_model", "epoch_1", "epoch_2",
                                        "last_model"]
    assert tr.step == 2 * len(tr.train_loader) == 6
    assert np.isfinite(tr.train_loss) and 0.0 <= tr.eval_eer <= 1.0
    jax_states = _jax_layout(tmp_path, _cfg(lists, "TDNN"))
    assert sorted(jax_states) == ["best_model", "epoch_1", "epoch_2",
                                  "last_model"]
    for d in os.listdir(base):
        assert sorted(os.listdir(os.path.join(base, d))) == [
            "classifier.pt", "model.pt", "model.state", "optimizer.pt"]
        state = json.load(open(os.path.join(base, d, "model.state")))
        assert sorted(state) == sorted(jax_states[d]), d
        if d == "best_model":   # the epoch of the lowest EER (ties: later)
            assert state["last_epoch"] in (1, 2)
        else:
            assert state["last_epoch"] == jax_states[d]["last_epoch"], d
    # model.pt is the backbone alone; the rest sits beside it
    sd = torch.load(os.path.join(base, "best_model", "model.pt"),
                    weights_only=True)
    assert set(sd) == set(tr.model.state_dict())
    opt = torch.load(os.path.join(base, "last_model", "optimizer.pt"),
                     weights_only=True)
    assert opt["step"] == 6 and set(opt) == {"optimizer", "step"}

    # Predictor serves best_model with the trainer's eval embeddings of
    # the same weights (evaluate(resume_model=...) loads them)
    best = os.path.join(base, "best_model")
    tr.evaluate(resume_model=best)
    enroll, _ = tr.eval_embeddings["enroll"]
    paths = [ln.split("\t")[0] for ln in tr.enroll_dataset.lines]
    got = Predictor(cfg, model_path=best, device="cpu").predict_batch(
        paths, batch_size=cfg["dataset_conf"]["eval_conf"]["batch_size"])
    assert got.shape == tuple(enroll.shape)
    assert cos_min(enroll.numpy(), got) > 0.9999

    # resume: one more epoch from last_model; the step and the epoch go on
    cfg3 = _cfg(lists, name, max_epoch=3)
    tr2 = Trainer(cfg3, device="cpu", data_augment_configs=AUG)
    tr2.train(save_model_path=save, log_dir="", do_eval=False)
    assert tr2.step == 9
    assert sorted(os.listdir(base)) == ["best_model", "epoch_1", "epoch_2",
                                        "epoch_3", "last_model"]
    last = json.load(open(os.path.join(base, "last_model", "model.state")))
    assert last["last_epoch"] == 3
    st = tr2.optimizer.state[tr2.optimizer.param_groups[0]["params"][0]]
    assert float(st["step"]) == 9
    assert tr2.optimizer.param_groups[0]["lr"] == tr2.lr_schedule(8)


def test_train_and_eval_command_lines(lists, tmp_path):
    cfg = _cfg(lists, "TDNN", max_epoch=1)
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg), encoding="utf-8")
    aug = tmp_path / "aug.yml"
    aug.write_text(yaml.safe_dump({"speed": {"prob": 0.0}}), encoding="utf-8")
    save = tmp_path / "models"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["OMP_NUM_THREADS"] = "2"
    run = subprocess.run(
        [sys.executable, "-m", "voiceprintrecognition_paddlepaddle_torch.train",
         f"--configs={path}", f"--data_augment_configs={aug}",
         "--device=cpu", f"--save_model_path={save}", "--log_dir="],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "Test epoch: 1" in run.stderr
    best = save / "TDNN_Fbank" / "best_model"
    assert (best / "model.pt").exists()
    run = subprocess.run(
        [sys.executable, "-m", "voiceprintrecognition_paddlepaddle_torch.eval",
         f"--configs={path}", "--device=cpu", f"--resume_model={best}",
         f"--save_image_path={tmp_path / 'img'}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "EER:" in run.stderr and (tmp_path / "img" / "result.png").exists()


@pytest.mark.parametrize("where,value", [
    ("train_conf.enable_remat", True), ("train_conf.num_devices", 4),
    ("train_conf.checkpoint_format", "orbax"),
    ("optimizer_conf.optimizer_args.mu_dtype", "bfloat16")])
def test_deferred_options_raise(lists, where, value):
    """No option is deferred any more: the Trainer builds with each.
    ``num_devices`` 4 in one process trains on one device and
    ``checkpoint_format: orbax`` writes DCP directories (both held at world
    2 in ``tests/test_torch_parallel_train.py``); ``enable_remat`` and
    ``mu_dtype`` are held against JAX in ``tests/test_torch_remat.py`` and
    ``tests/test_torch_adam_moment.py``. An unknown format raises."""
    cfg = _cfg(lists, "TDNN")
    node = cfg
    *path, leaf = where.split(".")
    for k in path:
        node = node[k]
    node[leaf] = value
    tr = Trainer(cfg, device="cpu")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
    if leaf == "enable_remat":
        assert tr.remat
    elif leaf == "mu_dtype":
        assert isinstance(tr.optimizer, AdamLowPrecisionMoment)
    elif leaf == "num_devices":
        assert (tr.rank, tr.world) == (0, 1)
    else:
        node[leaf] = "safetensors"
        with pytest.raises(ValueError, match="checkpoint_format"):
            Trainer(cfg, device="cpu")


@pytest.mark.parametrize("call", ["extract_features", "export", "profiler"])
def test_deferred_calls_raise(lists, tmp_path, call):
    """Each call runs: ``extract_features`` writes the feature lists,
    ``export`` the inference bundle, ``train(profiler_dir=...)`` a trace
    (each held against JAX in ``tests/test_torch_{export,remat}.py``)."""
    tr = Trainer(_cfg(lists, "TDNN", max_epoch=1), device="cpu")
    if call == "profiler":
        tr.train(save_model_path="", log_dir="", profiler_dir=str(tmp_path))
        assert tr.step == 3     # fewer steps than the trace's start: none
        assert os.listdir(tmp_path) == []
    elif call == "export":
        infer = tr.export(save_model_path=str(tmp_path), resume_model=None,
                          export_seconds=1)
        assert sorted(os.listdir(infer)) == ["inference.json", "model.pt",
                                             "model.pt2"]
    else:
        cfg = _cfg(lists, "TDNN")
        for key in ("train_list", "enroll_list", "trials_list"):
            src = cfg["dataset_conf"][key]
            dst = tmp_path / os.path.basename(src)
            dst.write_text(open(src, encoding="utf-8").read(),
                           encoding="utf-8")
            cfg["dataset_conf"][key] = str(dst)
        Trainer(cfg, device="cpu").extract_features(
            save_dir=str(tmp_path / "features"), max_duration=2)
        for key in ("train_list", "enroll_list", "trials_list"):
            feats = cfg["dataset_conf"][key].replace(".txt", "_features.txt")
            lines = open(feats, encoding="utf-8").read().splitlines()
            assert len(lines) == len(open(cfg["dataset_conf"][key])
                                     .read().splitlines())
            assert all(np.load(ln.split("\t")[0]).shape[1] == 40
                       for ln in lines)


def test_cuda_trainer_needs_a_card(lists):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_cfg(lists, "TDNN"))


BACKBONES = {**{k: dict(v) for k, v in NARROW.items()},
             "CAMPPlus": {"embd_dim": 16, "init_channels": 16},
             # the port's own backbone: not in NARROW, which the JAX
             # cross-checks iterate
             "MFAConformer": {"embd_dim": 16, "output_size": 16,
                              "num_blocks": 2, "attention_heads": 2,
                              "linear_units": 32, "cnn_module_kernel": 5}}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_every_backbone_takes_a_train_step(lists, name):
    cfg = train_configs(lists, model=name, model_args=BACKBONES[name],
                        n_mels=40)
    tr = Trainer(cfg, device="cpu")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
    tr.model.train()
    tr.classifier.train()
    bns = [m for m in tr.model.modules()
           if isinstance(m, torch.nn.BatchNorm1d)]
    before = [m.running_var.clone() for m in bns]
    params = [p.detach().clone() for p in tr.model.parameters()]
    kind, data, labels, lens = next(iter(tr.train_loader))
    assert kind == "waveforms" and data.dtype == np.int16
    tr.step = 1           # update 1: the warmup's lr is above 0
    loss, acc = tr.train_step(kind, *(torch.from_numpy(x)
                                      for x in (data, labels, lens)))
    assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0
    assert bns and all(not torch.equal(b, m.running_var)
                       for b, m in zip(before, bns))
    assert any(not torch.equal(p, q) for p, q in
               zip(params, tr.model.parameters()))


def test_torch_card_config_is_the_whole_cam_yml(tmp_path):
    """The card's training tests train ``CONFIG``: every key of
    configs/cam++.yml, and ``train_config`` changes the list paths (and
    what it is asked to) and nothing else."""
    import torch_card

    with open(os.path.join(ROOT, "configs", "cam++.yml"),
              encoding="utf-8") as f:
        assert torch_card.CONFIG == yaml.safe_load(f)
    cfg, changes = torch_card.train_config(
        ["a.txt", "b.txt", "c.txt"], **{"train_conf.enable_amp": True})
    assert changes == {"dataset_conf.train_list": "a.txt",
                       "dataset_conf.enroll_list": "b.txt",
                       "dataset_conf.trials_list": "c.txt",
                       "train_conf.enable_amp": True}
    cfg["dataset_conf"].update(train_list="dataset/train_list.txt",
                               enroll_list=torch_card.CONFIG["dataset_conf"]
                               ["enroll_list"],
                               trials_list=torch_card.CONFIG["dataset_conf"]
                               ["trials_list"])
    cfg["train_conf"]["enable_amp"] = False
    assert cfg == torch_card.CONFIG


LOSS_ARGS = {"AAMLoss": {"margin": 0.2, "scale": 32},
             "AMLoss": {"margin": 0.2, "scale": 30},
             "ARMLoss": {"margin": 0.2, "scale": 30},
             "CELoss": {"label_smoothing": 0.1},
             "SphereFace2": {"margin": 0.2, "scale": 32.0},
             "SubCenterLoss": {"margin": 0.2, "scale": 32, "K": 3},
             "TripletAngularMarginLoss": {"margin": 0.5}}


@pytest.mark.parametrize("loss", sorted(LOSS_ARGS))
def test_every_loss_trains(lists, loss):
    """One train step of a tiny TDNN with each loss: SubCenter with a
    3-center head, the triplet loss on P x K batches, SphereFace2's bias
    among the optimizer's parameters and moved by the update."""
    cfg = _cfg(lists, "TDNN", loss=loss, loss_args=LOSS_ARGS[loss])
    if loss == "SubCenterLoss":
        cfg["model_conf"]["classifier"]["K"] = 3
    tr = Trainer(cfg, device="cpu")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
    if loss == "TripletAngularMarginLoss":
        assert type(tr.train_loader.batch_sampler).__name__ == "PKSampler"
    tr.model.train()
    tr.classifier.train()
    before = {n: p.detach().clone() for n, p in
              tr.criterion.named_parameters()}
    kind, data, labels, lens = next(iter(tr.train_loader))
    tr.step = 1
    loss_v, acc = tr.train_step(kind, *(torch.from_numpy(x)
                                        for x in (data, labels, lens)))
    assert np.isfinite(float(loss_v)) and 0.0 <= float(acc) <= 1.0
    if loss == "SphereFace2":
        assert "loss.sphereface2_bias" in tr.param_names
        assert not torch.equal(before["sphereface2_bias"],
                               tr.criterion.sphereface2_bias)


def test_accumulation_updates_every_kth_step(lists):
    """``train_conf.accum_steps: 2``: the optimizer updates on every
    second microbatch, at lr = schedule(update), and the schedule paces
    on updates."""
    tr = Trainer(_cfg(lists, "TDNN", accum_steps=2), device="cpu")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
    tr.model.train()
    tr.classifier.train()
    batches = list(tr.train_loader)
    first = tr.optimizer.param_groups[0]["params"][0]
    for i, (kind, data, labels, lens) in enumerate(batches[:2]):
        tr.train_step(kind, *(torch.from_numpy(x)
                              for x in (data, labels, lens)))
        updated = first in tr.optimizer.state
        assert updated == (i == 1)
        assert (first.grad is None) == (i == 1)
    assert tr.updates == 1
    assert float(tr.optimizer.state[first]["step"]) == 1
    assert tr.optimizer.param_groups[0]["lr"] == tr.lr_schedule(0)


def test_pretrained_load_skips_mismatched_shapes(lists, tmp_path):
    """``load_pretrained`` (what ``train(pretrained_model=...)`` calls)
    loads what matches by name and shape, the backbone, and skips with a
    warning what does not: a classifier for another speaker count."""
    save = str(tmp_path / "models")
    tr = Trainer(_cfg(lists, "TDNN", max_epoch=1), device="cpu")
    tr.train(save_model_path=save, log_dir="", do_eval=False)
    best = os.path.join(save, "TDNN_Fbank", "last_model")
    cfg = _cfg(lists, "TDNN", max_epoch=1, num_speakers=6)
    tr2 = Trainer(cfg, device="cpu")
    tr2._setup_dataloader(is_train=True)
    tr2._setup_model(tr2.audio_featurizer.feature_dim, is_train=True)
    from voiceprintrecognition_paddlepaddle_torch.utils.checkpoint import \
        load_pretrained
    n = load_pretrained({"model": tr2.model, "classifier": tr2.classifier,
                         "loss": tr2.criterion}, best)
    assert n == len(tr.model.state_dict())
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, tr2.model.state_dict()[k]), k
    assert tr2.classifier.weight.shape[1] == 6
