"""PyTorch port, schedules and optimizers (``optimizer/``) against the JAX
package's: the two LR schedules and the margin scheduler step by step; the
five optimizers with weight decay over 5 updates against the optax chain
of the JAX ``build_optimizer`` on the same seeded parameters and
gradients; gradient accumulation (2 microbatches) against
``optax.MultiSteps``.

The optimizers run in float64 on both sides (``jax.enable_x64``
and float64 tensors): in float32 optax rounds Adam's bias corrections
``1 - 0.999^t`` to 3e-5 relative, which moves its parameters 1e-6 off a
float64 run after 5 updates while the port's stay within 2e-7 (the port
computes them in double on the host); float64 isolates the update rules.

Bars: schedules within 1e-6 of the base LR (JAX evaluates them in
float32, whose cosine near the end of the decay rounds at 1e-10 absolute);
margins equal;
parameters within 1e-6 of their largest entry after every update.
"""

import jax.numpy as jnp
from jax import enable_x64
import numpy as np
import optax
import pytest
import torch

from voiceprintrecognition_paddlepaddle_torch import optimizer as topt
from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
    dict_to_object
from voiceprintrecognition_paddlepaddle_tpu import optimizer as jopt

SHAPES = {"w": (6, 5), "b": (5,), "s": ()}


def _configs(optimizer="Adam", scheduler="WarmupCosineSchedulerLR",
             weight_decay=1e-2, **sched):
    sched = sched or {"learning_rate": 0.1, "min_lr": 1e-3,
                      "warmup_epoch": 1}
    return dict_to_object({
        "optimizer_conf": {"optimizer": optimizer,
                           "optimizer_args": {"weight_decay": weight_decay},
                           "scheduler": scheduler, "scheduler_args": sched},
        "train_conf": {"max_epoch": 4}})


@pytest.mark.parametrize("scheduler,args", [
    ("WarmupCosineSchedulerLR", {"learning_rate": 0.001, "min_lr": 1e-5,
                                 "warmup_epoch": 2}),
    ("WarmupCosineSchedulerLR", {"learning_rate": 0.01, "warmup_epoch": 0}),
    ("CosineAnnealingDecay", {"learning_rate": 0.01}),
    ("CosineAnnealingDecay", {"learning_rate": 0.01, "T_max": 7,
                              "eta_min": 1e-4})])
def test_lr_schedules_match_jax(scheduler, args):
    cfg = _configs(scheduler=scheduler, **args)
    ref = jopt.build_lr_scheduler(step_per_epoch=5, configs=cfg)
    got = topt.build_lr_scheduler(step_per_epoch=5, configs=cfg)
    for k in range(30):
        np.testing.assert_allclose(got(k), float(ref(k)), rtol=0,
                                   atol=1e-6 * args["learning_rate"])
    if scheduler == "WarmupCosineSchedulerLR" and args["warmup_epoch"]:
        assert got(0) == 0.0


@pytest.mark.parametrize("increase_type", ["exp", "linear"])
def test_margin_scheduler_matches_jax(increase_type):
    class Crit:
        margin = None

        def update(self, margin):
            self.margin = margin

    kw = dict(increase_start_epoch=2, fix_epoch=6, step_per_epoch=5,
              initial_margin=0.0, final_margin=0.3,
              increase_type=increase_type)
    ref, got = Crit(), Crit()
    rs = jopt.MarginScheduler(criterion=ref, **kw)
    gs = topt.MarginScheduler(criterion=got, **kw)
    for k in range(40):
        rs.step(current_step=k)
        gs.step(current_step=k)
        assert got.margin == ref.margin == gs.get_margin()


def _run(name, accum=1, updates=5, weight_decay=1e-2):
    """Both sides from the same seeded params over ``updates`` updates of
    ``accum`` microbatch gradients each; returns per-update params."""
    rng = np.random.RandomState(3)
    def draw():
        return {k: np.asarray(rng.randn(*s), np.float64)
                for k, s in SHAPES.items()}
    params = draw()
    grads = [draw() for _ in range(updates * accum)]
    cfg = _configs(optimizer=name, weight_decay=weight_decay)
    sched_j = jopt.build_lr_scheduler(step_per_epoch=2, configs=cfg)
    tx = jopt.build_optimizer(sched_j, cfg)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    ref = []
    with enable_x64():
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        state = tx.init(jp)
        for i, g in enumerate(grads):
            upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
            jp = optax.apply_updates(jp, upd)
            if (i + 1) % accum == 0:
                ref.append({k: np.asarray(v) for k, v in jp.items()})
        assert jp["w"].dtype == jnp.float64

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = topt.build_optimizer(list(tp.values()), cfg)
    sched_t = topt.build_lr_scheduler(step_per_epoch=2, configs=cfg)
    got = []
    for i, g in enumerate(grads):
        for k, p in tp.items():       # what backward of loss / accum adds
            gi = torch.from_numpy(g[k]) / accum if accum > 1 else \
                torch.from_numpy(g[k])
            p.grad = gi if p.grad is None else p.grad + gi
        if topt.scheduled_step(opt, sched_t, i + 1, accum):
            got.append({k: p.detach().numpy().copy() for k, p in tp.items()})
    return params, ref, got


def _assert_params(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        for k in r:
            scale = max(np.abs(r[k]).max(), 1e-6)
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=1e-6 * scale,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["Adam", "AdamMax", "AdamW", "Momentum",
                                  "SGD"])
def test_optimizer_with_weight_decay_matches_optax(name):
    params, ref, got = _run(name)
    _assert_params(ref, got)
    # update 0 runs at lr = schedule(0) = 0: nothing moves
    for k in params:
        np.testing.assert_array_equal(got[0][k], params[k])


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_accumulation_matches_optax_multisteps(name):
    _, ref, got = _run(name, accum=2)
    _assert_params(ref, got)


def test_mu_dtype_raises_and_unknown_optimizer_is_refused():
    cfg = _configs()
    cfg.optimizer_conf.optimizer_args["mu_dtype"] = "bfloat16"
    with pytest.raises(NotImplementedError, match="mu_dtype"):
        topt.build_optimizer([torch.zeros(2, requires_grad=True)], cfg)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer([torch.zeros(2, requires_grad=True)],
                             _configs(optimizer="Lion"))
