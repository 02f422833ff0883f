"""PyTorch port, one DDP train step on the CPU: two gloo ranks started by
the port's launcher (``tests/test_torch_parallel_ranks.py``), b2 each, of
the tiny CAM++ of ``tests/test_torch_train_step.py`` (all 52 layers, 32
channels, float64) against that file's ``_jax_step`` on the b4 global
batch, which is what the JAX mesh computes: the ranks' mean loss (rel
1e-5), every gradient leaf DDP hands the optimizer within 1e-4 of its
norm (the same on both ranks), the BN statistics within 1e-5 of each
leaf's scale (the global batch's, ``layers.BatchNorm``), and the updated
parameters as that file holds them."""

import flax
import jax
import numpy as np
import pytest
import torch
from jax import enable_x64

from test_torch_helpers import seeded_variables, speaker_corpus
from test_torch_parallel_ranks import launch_ranks
from test_torch_train_step import (CASES, SPK, _batch, _configs, _jax_front,
                                   _jax_step, _named)
from voiceprintrecognition_paddlepaddle_torch.models.convert import \
    jax_to_torch_state
from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
    dict_to_object
from voiceprintrecognition_paddlepaddle_tpu.models import MODELS
from voiceprintrecognition_paddlepaddle_tpu.models.fc import \
    SpeakerIdentification


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as the other training test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def step_world(tmp_path_factory):
    """The tiny CAM++ and its JAX step (``test_torch_train_step``'s), the
    features of a b4 batch, and the weights the ranks start from."""
    name = "CAMPPlus"
    args, n_mels = CASES[name]
    root = tmp_path_factory.mktemp("ddp_step")
    cfg = _configs(speaker_corpus(root, n_speakers=SPK, n_utts=2), name)
    jmodel = MODELS[name](input_size=n_mels, **args)
    jcls = SpeakerIdentification(num_speakers=SPK)
    rng = np.random.RandomState(7)
    shapes = flax.core.unfreeze(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        np.zeros((1, 51, n_mels), np.float32)))
    v = jax.tree.map(lambda a: a.astype(np.float64),
                     seeded_variables(shapes, rng))
    cls_w = rng.randn(args["embd_dim"], SPK) / np.sqrt(args["embd_dim"])
    params = {"backbone": v["params"], "classifier": {"weight": cls_w}}
    stats = {"backbone": v["batch_stats"], "classifier": {}}
    waves, ratio, labels = _batch()
    feats = np.asarray(_jax_front(dict_to_object(cfg))(waves, ratio),
                       np.float64)
    # the LR of update 0 is the same for any epoch length; 3 (12 clips at
    # b4, one rank) makes this the program test_torch_train_step compiles,
    # which the suite's persistent compilation cache may then hold
    step, tx = _jax_step(dict_to_object(cfg), jmodel, jcls, 3)
    with enable_x64():
        opt_state = tx.init((params, {}))
        jax_out = jax.device_get(step(params, stats, opt_state, feats, ratio,
                                      labels))
    inputs = {"cfg": cfg, "feats": torch.from_numpy(feats),
              "ratio": torch.from_numpy(ratio),
              "labels": torch.from_numpy(labels),
              "model": jax_to_torch_state({"params": params["backbone"],
                                           "batch_stats": stats["backbone"]},
                                          dtype=np.float64),
              "classifier": jax_to_torch_state(
                  {"params": params["classifier"]}, dtype=np.float64)}
    return inputs, jax_out

@pytest.fixture(scope="module")
def ranks(tmp_path_factory, step_world):
    return launch_ranks(tmp_path_factory.mktemp("ranks"), ["step"],
                        {"step": step_world[0]})


def test_ddp_step_loss_matches_jax_global_batch(ranks, step_world):
    loss_j = float(step_world[1][0])
    assert all(r["step"]["ddp"] == "DistributedDataParallel" for r in ranks)
    # each rank's AAM loss is its half's mean: the global mean is theirs
    got = np.mean([r["step"]["loss"] for r in ranks])
    np.testing.assert_allclose(got, loss_j, rtol=1e-5)


def test_ddp_step_gradients_match_jax_global_batch(ranks, step_world):
    grads_j = step_world[1][1]
    ref = {**_named(grads_j["backbone"], "model"),
           **_named(grads_j["classifier"], "classifier")}
    floor = 1e-3 * max(np.linalg.norm(r) for r in ref.values())
    for out in ranks:
        grads = out["step"]["grads"]
        assert set(grads) == set(ref)
        for k, r in ref.items():
            d = np.linalg.norm(grads[k].numpy() - r) / max(
                np.linalg.norm(r), floor)
            assert d <= 1e-4, (k, d)
    # DDP left the same gradient on both ranks
    for k in ref:
        torch.testing.assert_close(ranks[0]["step"]["grads"][k],
                                   ranks[1]["step"]["grads"][k])


def test_ddp_step_bn_statistics_are_the_global_batch(ranks, step_world):
    stats_j = step_world[1][2]
    want = jax_to_torch_state({"params": {}, "batch_stats":
                               stats_j["backbone"]}, dtype=np.float64)
    for out in ranks:
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            scale = max(np.abs(v.numpy()).max(), 1e-6)
            d = np.abs(out["step"]["state"][k].numpy() - v.numpy()).max()
            assert d <= 1e-5 * scale, (k, d, scale)


def test_ddp_step_updated_parameters_match_jax(ranks, step_world):
    """As ``test_torch_train_step._check_params``: within 1e-5 of each
    leaf's scale where the JAX gradient is above 1e-5 of the leaf's
    largest, those entries over 90 % of all."""
    _, grads_j, _, new_params, _ = step_world[1]
    ref = {**_named(new_params["backbone"], "model"),
           **_named(new_params["classifier"], "classifier")}
    gj = {**_named(grads_j["backbone"], "model"),
          **_named(grads_j["classifier"], "classifier")}
    for out in ranks:
        got = {k: v.numpy() for k, v in out["step"]["params"].items()}
        assert set(got) == set(ref)
        small = total = 0
        for k in ref:
            g = np.abs(gj[k])
            held = g > 1e-5 * g.max()
            small += int((~held).sum())
            total += g.size
            d = np.abs(got[k] - ref[k])[held].max(initial=0.0) / np.abs(
                ref[k]).max()
            assert d <= 1e-5, (k, d)
        assert small < 0.1 * total
