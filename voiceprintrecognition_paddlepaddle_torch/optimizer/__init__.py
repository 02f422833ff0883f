"""Optimizer and LR-schedule factories on ``torch.optim`` (counterpart of
the JAX ``optimizer/__init__.py``; reference
``ppvector/optimizer/__init__.py:13-33``).

The same config keys select the optimizer and the schedule, with the JAX
package's (optax's) semantics:

- ``weight_decay`` is paddle's *coupled* L2 (optax ``add_decayed_weights``
  before the moments) for Adam, AdamMax, Momentum and SGD: torch's
  ``weight_decay`` argument of those classes. AdamW decays after the Adam
  scaling (decoupled): ``torch.optim.AdamW``.
- AdamMax is ``torch.optim.Adamax``: ``u = max(b2 * u, |g| + eps)`` and
  the update ``m_hat / u``, as ``optax.scale_by_adamax``.
- Momentum is ``torch.optim.SGD(momentum=...)`` without dampening or
  Nesterov: ``optax.trace``.
- The LR is not the optimizer's: ``set_lr`` writes ``schedule(k)`` into
  every param group before update ``k``.

``optimizer_args.mu_dtype`` (the JAX package's bf16 Adam first moment)
has no ``torch.optim`` counterpart and raises ``NotImplementedError``.
"""

import torch

from ..utils.logger import logger
from .scheduler import (CosineAnnealingDecay, MarginScheduler,
                        WarmupCosineSchedulerLR, cosine_decay_with_warmup)

__all__ = ["build_optimizer", "build_lr_scheduler", "set_lr", "scheduled_step",
           "MarginScheduler", "WarmupCosineSchedulerLR",
           "CosineAnnealingDecay", "cosine_decay_with_warmup"]

SCHEDULERS = {
    "WarmupCosineSchedulerLR": WarmupCosineSchedulerLR,
    "CosineAnnealingDecay": CosineAnnealingDecay,
}


def build_lr_scheduler(step_per_epoch, configs):
    """Returns ``schedule(update) -> lr``."""
    use_scheduler = configs.optimizer_conf.get("scheduler",
                                               "WarmupCosineSchedulerLR")
    scheduler_args = dict(configs.optimizer_conf.get("scheduler_args", {}))
    if use_scheduler == "CosineAnnealingDecay" and "T_max" not in scheduler_args:
        scheduler_args["T_max"] = int(
            configs.train_conf.max_epoch * 1.2) * step_per_epoch
    if use_scheduler == "WarmupCosineSchedulerLR":
        scheduler_args.setdefault("fix_epoch", configs.train_conf.max_epoch)
        scheduler_args.setdefault("step_per_epoch", step_per_epoch)
    if use_scheduler not in SCHEDULERS:
        raise ValueError(f"unknown scheduler: {use_scheduler}")
    schedule = SCHEDULERS[use_scheduler](**scheduler_args)
    logger.info(f"created LR schedule: {use_scheduler}, args: {scheduler_args}")
    return schedule


def set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def scheduled_step(optimizer, schedule, step, accum_steps=1):
    """Call after the backward of microbatch ``step`` (counted from 1),
    whose loss was divided by ``accum_steps``: every ``accum_steps``-th
    microbatch updates with the mean gradient (optax ``MultiSteps``) at
    ``lr = schedule(update)``, the update counted from 0, and clears the
    gradients. Returns True when it updated."""
    if step % accum_steps:
        return False
    set_lr(optimizer, schedule(step // accum_steps - 1))
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return True


def build_optimizer(params, configs, fused=None):
    """A ``torch.optim`` optimizer over ``params`` (a list of tensors) with
    the LR at 0 until ``set_lr``. ``fused`` passes through to Adam and
    AdamW (one kernel for every parameter on CUDA)."""
    use_optimizer = configs.optimizer_conf.get("optimizer", "Adam")
    args = dict(configs.optimizer_conf.get("optimizer_args", {}))
    weight_decay = float(args.pop("weight_decay", 0.0))
    b1 = float(args.pop("beta1", 0.9))
    b2 = float(args.pop("beta2", 0.999))
    eps = float(args.pop("epsilon", 1e-8))
    momentum = float(args.pop("momentum", 0.9))
    if args.pop("mu_dtype", None) is not None:
        raise NotImplementedError(
            "optimizer_args.mu_dtype (a bf16 Adam first moment) has no "
            "torch.optim counterpart in the port yet (ROADMAP.md, queue 1: "
            "training, deferred: mu_dtype)")
    kw = {} if fused is None else {"fused": fused}  # Adam and AdamW
    if use_optimizer == "Adam":
        opt = torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=eps,
                               weight_decay=weight_decay, **kw)
    elif use_optimizer == "AdamMax":
        # infinity-norm second moment (paddle.optimizer.Adamax), not Adam
        opt = torch.optim.Adamax(params, lr=0.0, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)
    elif use_optimizer == "AdamW":
        opt = torch.optim.AdamW(params, lr=0.0, betas=(b1, b2), eps=eps,
                                weight_decay=weight_decay, **kw)
    elif use_optimizer == "Momentum":
        opt = torch.optim.SGD(params, lr=0.0, momentum=momentum,
                              weight_decay=weight_decay)
    elif use_optimizer == "SGD":
        opt = torch.optim.SGD(params, lr=0.0, weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer: {use_optimizer}")
    if args:
        # a typo'd key (e.g. beta_1, weight_dacay) would otherwise train
        # silently with defaults
        logger.warning(f"unrecognised optimizer_args ignored: "
                       f"{sorted(args)}")
    logger.info(f"created optimizer: {use_optimizer}, "
                f"weight_decay: {weight_decay}")
    return opt
