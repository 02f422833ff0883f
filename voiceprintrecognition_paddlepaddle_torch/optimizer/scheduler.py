"""LR and margin schedules as closed-form functions of the step
(counterpart of the JAX ``optimizer/scheduler.py``).

The reference materialises a per-step PiecewiseDecay table (reference
``ppvector/optimizer/scheduler.py:6-40``): linear warmup to the base LR,
then cosine decay to ``min_lr`` over ``fix_epoch`` epochs. Here, as in the
JAX package, a schedule is ``schedule(k) -> lr`` for the optimizer update
``k`` counted from 0, so a resumed run reads the LR off its update count
and replays nothing. The trainer sets each param group's ``lr`` to
``schedule(k)`` before update ``k`` (optax's ``scale_by_learning_rate``
convention: WarmupCosine gives lr 0 at update 0).

``MarginScheduler`` (copied) ramps the loss margin from ``initial_margin``
to ``final_margin`` between ``increase_start_epoch`` and ``fix_epoch``
(reference ``optimizer/scheduler.py:44-102``).
"""

import math

__all__ = ["cosine_decay_with_warmup", "WarmupCosineSchedulerLR",
           "CosineAnnealingDecay", "MarginScheduler"]


def cosine_decay_with_warmup(learning_rate, step_per_epoch, fix_epoch=1000,
                             warmup_epoch=5, min_lr=0.0):
    """``schedule(step) -> lr``: the reference's per-step table."""
    warmup_steps = int(warmup_epoch * step_per_epoch)
    max_iters = int(fix_epoch) * int(step_per_epoch)

    def schedule(step):
        step = float(step)
        if step < warmup_steps:
            return learning_rate * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps)
                           / max(max_iters - warmup_steps, 1), 0.0), 1.0)
        return min_lr + (learning_rate - min_lr) * 0.5 * (
            math.cos(progress * math.pi) + 1.0)

    return schedule


# registry alias matching the reference config name
WarmupCosineSchedulerLR = cosine_decay_with_warmup


def CosineAnnealingDecay(learning_rate, T_max, eta_min=0.0, **_):
    """paddle ``CosineAnnealingDecay`` stepped per update (the reference
    steps its scheduler every batch, ``trainer.py:272``)."""

    def schedule(step):
        return eta_min + (learning_rate - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * float(step) / T_max))

    return schedule


class MarginScheduler:
    """Drives ``criterion.update(margin)`` per step and exposes the margin
    for the loss (reference ``optimizer/scheduler.py:44-102``, including
    the ``1 - exp(r * log(1e-3))`` exponential ramp)."""

    def __init__(self, criterion, increase_start_epoch, fix_epoch,
                 step_per_epoch, initial_margin=0.0, final_margin=0.3,
                 increase_type="exp"):
        assert hasattr(criterion, "update"), \
            "Loss function has no 'update()' attribute."
        self.criterion = criterion
        self.increase_start_step = increase_start_epoch * step_per_epoch
        self.fix_step = fix_epoch * step_per_epoch
        self.initial_margin = initial_margin
        self.final_margin = final_margin
        self.increase_type = increase_type
        self.margin = initial_margin
        self.current_step = 0
        self.increase_step = self.fix_step - self.increase_start_step
        self.criterion.update(margin=self.initial_margin)

    def margin_at(self, step):
        """Closed-form margin(step)."""
        if step < self.increase_start_step:
            return self.initial_margin
        if step >= self.fix_step:
            return self.final_margin
        a, b = 1.0, 1e-3
        cur = step - self.increase_start_step
        if self.increase_type == "exp":
            ratio = 1.0 - math.exp(
                (cur / self.increase_step) * math.log(b / (a + 1e-6))) * a
        else:
            ratio = cur / self.increase_step
        return self.initial_margin + (self.final_margin
                                      - self.initial_margin) * ratio

    def step(self, current_step=None):
        if current_step is not None:
            self.current_step = current_step
        self.margin = self.margin_at(self.current_step)
        self.criterion.update(margin=self.margin)
        self.current_step += 1

    def get_margin(self):
        return self.margin
