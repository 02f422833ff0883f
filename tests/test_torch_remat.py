"""PyTorch port, ``train_conf.enable_remat`` and ``train(profiler_dir=...)``.

Remat: the backbone's forward under ``torch.utils.checkpoint``, whose
recomputation in the backward must not move the BatchNorm running
statistics a second time (``layers.frozen_running_stats``; ``jax.checkpoint``
of the functional flax step has no such effect). One float64 step of a tiny
TDNN with remat against the JAX step with ``jax.checkpoint`` around the
backbone (``trainer.py:366-379``), at the bars of
``tests/test_torch_train_step.py``: the loss within 1e-5 relative, each
gradient leaf within 1e-4 of its norm, the BN statistics within 1e-5 of
each leaf's scale and counted once, the updated parameters within 1e-5
(a TDNN: the JAX remat step of a tiny CAM++ takes 100 s to compile here).
Then one step of a tiny CAM++ (all 52 layers, 122 BatchNorms) with and
without remat in the port, from the same weights and batch: the loss,
the gradients, the parameters after the update and every BN running
statistic and batch count equal bit for bit.

Profiler: a tiny TDNN ``train()`` of 24 steps with ``profiler_dir`` writes
one ``*.pt.trace.json`` there holding steps 10-19 (JAX
``trainer.py:700-708``)."""

import json
import os

import jax
from jax import enable_x64
import numpy as np
import optax
import pytest
import torch

from test_torch_helpers import NARROW, speaker_corpus, train_configs
from test_torch_train_step import (CASES, SPK, _batch, _check_params,
                                   _jax_front, _load_port, _named,
                                   _port_step)
from voiceprintrecognition_paddlepaddle_torch.models.convert import \
    jax_to_torch_state
from voiceprintrecognition_paddlepaddle_torch.trainer import (PROFILE_STEPS,
                                                              Trainer)
from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
    dict_to_object
from voiceprintrecognition_paddlepaddle_tpu.loss import build_loss
from voiceprintrecognition_paddlepaddle_tpu.models import MODELS
from voiceprintrecognition_paddlepaddle_tpu.models.fc import \
    SpeakerIdentification
from voiceprintrecognition_paddlepaddle_tpu.optimizer import (
    build_lr_scheduler, build_optimizer)

CASES = {**CASES, "TDNN": (NARROW["TDNN"], 40)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as the other training test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_remat_step(cfg, jmodel, jcls, steps_per_epoch):
    """The JAX Trainer's step body from features on with
    ``jax.checkpoint`` around the backbone's forward, as
    ``train_conf.enable_remat`` builds it; returns the gradients too."""
    criterion = build_loss(cfg)
    tx = build_optimizer(build_lr_scheduler(steps_per_epoch, cfg), cfg)

    @jax.jit
    def step(params, stats, opt_state, feats, ratio, labels):
        @jax.checkpoint
        def backbone_fwd(backbone_params, feats):
            return jmodel.apply(
                {"params": backbone_params, "batch_stats": stats["backbone"]},
                feats, train=True, lengths=ratio, mutable=["batch_stats"])

        def loss_fn(p):
            emb, mb = backbone_fwd(p["backbone"], feats)
            out, mc = jcls.apply(
                {"params": p["classifier"],
                 "batch_stats": stats["classifier"]},
                emb, train=True, mutable=["batch_stats"])
            new_stats = {"backbone": mb["batch_stats"],
                         "classifier": mc.get("batch_stats", {})}
            return criterion(out, labels, margin=0.2), new_stats

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, _ = tx.update((grads, {}), opt_state, (params, {}))
        new_params, _ = optax.apply_updates((params, {}), updates)
        return loss, grads, new_stats, new_params

    return step, tx


def _trainers(lists, name, remats=(True, False)):
    """Port trainers of ``name`` (float64), with and without remat."""
    import test_torch_train_step

    out = {}
    for remat in remats:
        args, n_mels = CASES[name]
        cfg = train_configs(lists, model=name, model_args=dict(args),
                            n_mels=n_mels, num_speakers=SPK, batch_size=4,
                            max_epoch=4, enable_remat=remat)
        ref = test_torch_train_step._configs(
            lists, "CAMPPlus")         # the step test's dataset and schedule
        for key in ("dataset_conf", "loss_conf", "optimizer_conf"):
            cfg[key] = ref[key]
        tr = Trainer(cfg, device="cpu")
        tr._setup_dataloader(is_train=True)
        tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
        tr.model.double()
        tr.classifier.double()
        out[remat] = tr
    return out


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    return speaker_corpus(tmp_path_factory.mktemp("corpus"),
                          n_speakers=SPK, n_utts=2)


@pytest.fixture(scope="module")
def setup(lists):
    import flax

    from test_torch_helpers import seeded_variables

    args, n_mels = CASES["TDNN"]
    jmodel = MODELS["TDNN"](input_size=n_mels, **args)
    rng = np.random.RandomState(7)
    shapes = flax.core.unfreeze(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        np.zeros((1, 51, n_mels), np.float32)))
    v = jax.tree.map(lambda a: a.astype(np.float64),
                     seeded_variables(shapes, rng))
    emb_dim = args["embd_dim"]
    params = {"backbone": v["params"],
              "classifier": {"weight": rng.randn(emb_dim, SPK)
                             / np.sqrt(emb_dim)}}
    stats = {"backbone": v["batch_stats"], "classifier": {}}
    tr = _trainers(lists, "TDNN", remats=(True,))[True]
    cfg = dict_to_object(tr.configs)
    step, tx = _jax_remat_step(cfg, jmodel, SpeakerIdentification(
        num_speakers=SPK), len(tr.train_loader))
    waves, ratio, labels = _batch()
    feats = np.asarray(_jax_front(cfg)(waves, ratio), np.float64)
    return dict(trainer=tr, step=step, tx=tx, params=params, stats=stats,
                feats=feats, ratio=ratio, labels=labels)


def test_remat_step_matches_jax_remat_step(setup):
    tr = setup["trainer"]
    assert tr.remat
    params, stats = setup["params"], setup["stats"]
    feats, ratio, labels = setup["feats"], setup["ratio"], setup["labels"]
    _load_port(tr, params, stats)
    tr.step = 0
    with enable_x64():
        loss_j, grads_j, stats_j, new_params = jax.device_get(setup["step"](
            params, stats, setup["tx"].init((params, {})), feats, ratio,
            labels))
    loss, _, grads = _port_step(tr, feats, ratio, labels)
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
    ref = {**_named(grads_j["backbone"], "model"),
           **_named(grads_j["classifier"], "classifier")}
    assert set(ref) == set(grads)
    floor = 1e-3 * max(np.linalg.norm(r) for r in ref.values())
    for k, r in ref.items():
        d = np.linalg.norm(grads[k].numpy() - r) / max(np.linalg.norm(r),
                                                       floor)
        assert d <= 1e-4, (k, d)
    got = tr.model.state_dict()
    for k, v in jax_to_torch_state({"params": {}, "batch_stats":
                                    stats_j["backbone"]},
                                   dtype=np.float64).items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k      # one update, not two
            continue
        scale = max(np.abs(v.numpy()).max(), 1e-6)
        assert np.abs(got[k].numpy() - v.numpy()).max() <= 1e-5 * scale, k
    _check_params(tr, new_params, grads_j, "remat step 0")


def test_remat_leaves_the_running_statistics_as_without_it(lists):
    trainers = _trainers(lists, "CAMPPlus")
    waves, ratio, labels = _batch()
    weights = {k: v.clone() for k, v in
               trainers[False].model.state_dict().items()}
    head = {k: v.clone() for k, v in
            trainers[False].classifier.state_dict().items()}
    out = {}
    for remat, tr in trainers.items():
        assert tr.remat == remat
        tr.model.load_state_dict(weights)
        tr.classifier.load_state_dict(head)
        tr.step = 0
        feats = tr.featurize("waveforms", torch.from_numpy(waves),
                             torch.from_numpy(ratio)).double()
        loss, _, grads = _port_step(tr, feats.numpy(), ratio, labels)
        out[remat] = (loss, grads, {k: v.clone() for k, v in
                                    tr.model.state_dict().items()})
    (l1, g1, s1), (l0, g0, s0) = out[True], out[False]
    assert l1 == l0
    assert g1.keys() == g0.keys()
    assert all(torch.equal(g1[k], g0[k]) for k in g0)
    assert s1.keys() == s0.keys()
    bn = [k for k in s0 if k.endswith("num_batches_tracked")]
    assert len(bn) == 122               # every BatchNorm of the CAM++
    assert all(int(s1[k]) == 1 for k in bn)
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k


def test_profiler_traces_steps_10_to_19(tmp_path):
    lists = speaker_corpus(tmp_path / "corpus")
    cfg = train_configs(lists, model="TDNN",
                        model_args={"embd_dim": 16, "channels": 16,
                                    "pooling_type": "TSP"},
                        batch_size=2, max_epoch=2, log_interval=100)
    tr = Trainer(cfg, device="cpu")
    prof = tmp_path / "profile"
    tr.train(save_model_path="", log_dir="", do_eval=False,
             profiler_dir=str(prof))
    assert tr.step == 24 > PROFILE_STEPS[1]
    traces = [n for n in os.listdir(prof) if n.endswith(".pt.trace.json")]
    assert len(traces) == 1, os.listdir(prof)
    with open(prof / traces[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the backbone's ops ran inside the trace
    assert any("conv1d" in n or "convolution" in n for n in names)
    assert tr._profiler is None
