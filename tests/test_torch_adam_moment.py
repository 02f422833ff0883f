"""PyTorch port, ``optimizer_args.mu_dtype: bfloat16`` (``optimizer/adam.py``)
against the JAX package's ``build_optimizer``, whose Adam and AdamW pass
it to ``optax.scale_by_adam``: the first moment kept in bf16, the second
and the update in the parameters' dtype.

Bars, over 8 updates from the same seeded parameters and gradients:
``exp_avg`` equal to optax's ``mu`` bit for bit (both round the same
fp32 moment to bf16, after the product ``b1 * mu`` in bf16 with ``b1``
rounded to bf16, as JAX multiplies a bf16 array by a Python float; the
first port of the update missed that rounding and was 1e-2 off); the
parameters within 1e-6 of their largest entry in float64 (measured 3e-9)
and 1e-5 in float32 (measured 1.3e-6: optax forms the bias corrections
``1 - b^t`` in float32, the port in double). Then the bf16 moment
survives a checkpoint's save and resume, and a JAX ``TrainState`` with a
bf16 ``mu`` goes on in the port (``convert.jax_to_torch_train_state``):
the same ``exp_avg`` and the same next update."""

from contextlib import nullcontext

import flax
import jax
from jax import enable_x64
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_helpers import (NARROW, seeded_variables, speaker_corpus,
                                train_configs)
from voiceprintrecognition_paddlepaddle_torch import optimizer as topt
from voiceprintrecognition_paddlepaddle_torch.models.convert import (
    jax_to_torch_state, jax_to_torch_train_state)
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
from voiceprintrecognition_paddlepaddle_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint)
from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
    dict_to_object
from voiceprintrecognition_paddlepaddle_tpu import optimizer as jopt
from voiceprintrecognition_paddlepaddle_tpu.models import MODELS

SHAPES = {"w": (6, 5), "b": (5,), "s": ()}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as the other training test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(optimizer):
    return dict_to_object({
        "optimizer_conf": {"optimizer": optimizer,
                           "optimizer_args": {"weight_decay": 1e-2,
                                              "mu_dtype": "bfloat16"},
                           "scheduler": "WarmupCosineSchedulerLR",
                           "scheduler_args": {"learning_rate": 0.1,
                                              "min_lr": 1e-3,
                                              "warmup_epoch": 1}},
        "train_conf": {"max_epoch": 4}})


def _mu(opt_state):
    """The ``mu`` of the one Adam state in an optax chain's state."""
    return [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0].mu


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_bf16_moment_matches_optax(name, dtype):
    rng = np.random.RandomState(3)

    def draw():
        return {k: np.asarray(rng.randn(*s), dtype) for k, s in SHAPES.items()}

    params, grads = draw(), [draw() for _ in range(8)]
    cfg = _configs(name)
    tx = jopt.build_optimizer(jopt.build_lr_scheduler(2, cfg), cfg)
    ref = []
    with enable_x64() if dtype == np.float64 else nullcontext():
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        state = tx.init(jp)
        for g in grads:
            upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
            jp = optax.apply_updates(jp, upd)
            mu = _mu(state)
            assert mu["w"].dtype == jnp.bfloat16
            ref.append(({k: np.asarray(v) for k, v in jp.items()},
                        {k: np.asarray(v.astype(jnp.float32))
                         for k, v in mu.items()}))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = topt.build_optimizer(list(tp.values()), cfg)
    assert isinstance(opt, topt.AdamLowPrecisionMoment)
    sched = topt.build_lr_scheduler(2, cfg)
    bar = 1e-6 if dtype == np.float64 else 1e-5
    for i, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        assert topt.scheduled_step(opt, sched, i + 1)
        want_p, want_mu = ref[i]
        for k, p in tp.items():
            st = opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16
            assert st["exp_avg_sq"].dtype == p.dtype == torch.from_numpy(
                params[k]).dtype
            np.testing.assert_array_equal(st["exp_avg"].float().numpy(),
                                          want_mu[k], err_msg=f"{k} {i}")
            np.testing.assert_allclose(
                p.detach().numpy(), want_p[k], rtol=0,
                atol=bar * np.abs(want_p[k]).max(), err_msg=f"{k} {i}")


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    return speaker_corpus(tmp_path_factory.mktemp("corpus"))


def _trainer(lists, optimizer="Adam"):
    cfg = train_configs(lists, model="TDNN", model_args=dict(NARROW["TDNN"]),
                        optimizer=optimizer)
    cfg["optimizer_conf"]["optimizer_args"]["mu_dtype"] = "bfloat16"
    tr = Trainer(cfg, device="cpu")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
    return tr


def test_bf16_moment_survives_save_and_resume(lists, tmp_path):
    tr = _trainer(lists)
    tr.model.train()
    tr.classifier.train()
    for i, (kind, data, labels, lens) in enumerate(tr.train_loader):
        tr.train_step(kind, *(torch.from_numpy(x)
                              for x in (data, labels, lens)))
    save = str(tmp_path / "models")
    save_checkpoint(tr.configs, tr.train_state(), save, 1)
    tr2 = _trainer(lists)
    step, _, _ = load_checkpoint(tr2.configs, tr2.load_train_state, save)
    assert step == tr.step == len(tr.train_loader)
    for p, q in zip(tr.optimizer.param_groups[0]["params"],
                    tr2.optimizer.param_groups[0]["params"]):
        a, b = tr.optimizer.state[p], tr2.optimizer.state[q]
        assert b["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
        assert float(a["step"]) == float(b["step"])


def _named(tree):
    """A JAX ``{"backbone", "classifier"}`` tree -> the port's qualified
    parameter names."""
    return {f"{side}.{k}": t
            for side, prefix in (("model", "backbone"),
                                 ("classifier", "classifier"))
            for k, t in jax_to_torch_state({"params": tree[prefix]}).items()}


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
def test_jax_bf16_state_continues_in_the_port(lists, optimizer):
    tr = _trainer(lists, optimizer)
    cfg = tr.configs
    jm = MODELS["TDNN"](input_size=40, **NARROW["TDNN"])
    rng = np.random.RandomState(5)
    v = seeded_variables(flax.core.unfreeze(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), np.zeros((1, 64, 40), np.float32))),
        rng)
    cls_w = tr.classifier.weight.detach().numpy().copy()
    params = {"backbone": v["params"], "classifier": {"weight": cls_w}}
    tx = jopt.build_optimizer(
        jopt.build_lr_scheduler(len(tr.train_loader), cfg), cfg)

    def grad_tree():
        return jax.tree.map(
            lambda a: rng.randn(*a.shape).astype(np.float32), params)

    grads = [grad_tree() for _ in range(4)]
    jp = (params, {})
    state = tx.init(jp)
    for g in grads[:3]:
        upd, state = tx.update((g, {}), state, jp)
        jp = optax.apply_updates(jp, upd)
    jax_state = jax.device_get({
        "params": jp[0], "batch_stats": {"backbone": v["batch_stats"],
                                         "classifier": {}},
        "loss_params": {}, "opt_state": state, "step": 3})
    upd, state4 = tx.update((grads[3], {}), state, jp)
    want = jax.device_get(optax.apply_updates(jp, upd)[0])

    tr.load_train_state(jax_to_torch_train_state(
        jax_state, tr.optimizer, tr.param_names))
    params_t = tr.optimizer.param_groups[0]["params"]
    mu = _named(jax.device_get(_mu(state)[0]))
    for name, p in zip(tr.param_names, params_t):
        st = tr.optimizer.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16 and float(st["step"]) == 3
        assert torch.equal(st["exp_avg"].float(), mu[name]), name
    g_t = _named(grads[3])
    for name, p in zip(tr.param_names, params_t):
        p.grad = g_t[name]
    tr.step = 4
    assert topt.scheduled_step(tr.optimizer, tr.lr_schedule, tr.step)
    got = dict(zip(tr.param_names, (p.detach() for p in params_t)))
    ref = _named(want)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=0,
                                   atol=1e-5 * float(r.abs().max()),
                                   err_msg=name)
    mu4 = _named(jax.device_get(_mu(state4)[0]))
    for name, p in zip(tr.param_names, params_t):
        assert torch.equal(tr.optimizer.state[p]["exp_avg"].float(),
                           mu4[name]), name
