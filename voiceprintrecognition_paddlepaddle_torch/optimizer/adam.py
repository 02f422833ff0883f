"""Adam and AdamW with the first moment kept in a lower precision (the JAX
package's ``optimizer_args.mu_dtype``: ``optax.scale_by_adam(...,
mu_dtype=...)``).

Per update ``t`` (counted from 1), in optax's order:

1. Adam's coupled L2: ``g += weight_decay * p``;
2. ``m = b1 * exp_avg + (1 - b1) * g``: ``b1 * exp_avg`` in the moment's
   dtype with ``b1`` rounded to it (as JAX multiplies a bf16 array by a
   Python float), the sum in the gradient's;
3. ``v = (1 - b2) * g**2 + b2 * exp_avg_sq`` in the gradient's dtype;
4. ``u = (m / (1 - b1**t)) / (sqrt(v / (1 - b2**t)) + eps)``, from the
   unrounded ``m``;
5. AdamW's decoupled decay: ``u += weight_decay * p``;
6. ``p -= lr * u``; ``exp_avg = m`` rounded to the moment's dtype.

The state keeps torch's names (``exp_avg``, ``exp_avg_sq``, ``step``), so
checkpoints and ``models/convert.jax_to_torch_train_state`` carry it as
they carry ``torch.optim.Adam``'s; ``load_state_dict`` keeps ``exp_avg``
in the moment's dtype (``torch.optim`` would cast it to the parameter's).
"""

import torch

__all__ = ["AdamLowPrecisionMoment"]


class AdamLowPrecisionMoment(torch.optim.Optimizer):
    def __init__(self, params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, decoupled=False, mu_dtype=torch.bfloat16):
        defaults = dict(lr=lr, betas=betas, eps=eps,
                        weight_decay=weight_decay, decoupled=decoupled)
        super().__init__(params, defaults)
        self.mu_dtype = mu_dtype

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            wd = group["weight_decay"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(
                        p, dtype=self.mu_dtype,
                        memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                st["step"] += 1
            states = [self.state[p] for p in params]
            grads = [p.grad for p in params]
            if wd and not group["decoupled"]:
                grads = torch._foreach_add(grads, params, alpha=wd)
            mu = [s["exp_avg"] for s in states]
            nu = [s["exp_avg_sq"] for s in states]
            m = torch._foreach_mul(grads, 1 - b1)
            # b1 * exp_avg in the moment's dtype, b1 rounded to it first
            b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
            torch._foreach_add_(m, torch._foreach_mul(mu, b1_mu))
            v = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
            torch._foreach_add_(v, torch._foreach_mul(nu, b2))
            t = [float(s["step"]) for s in states]
            u = torch._foreach_div(m, [1 - b1 ** n for n in t])
            den = torch._foreach_div(v, [1 - b2 ** n for n in t])
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(u, den)
            if wd and group["decoupled"]:
                torch._foreach_add_(u, params, alpha=wd)
            torch._foreach_add_(params, u, alpha=-group["lr"])
            torch._foreach_copy_(mu, m)
            torch._foreach_copy_(nu, v)
        return loss
