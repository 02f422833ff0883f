"""The CAM++ train step as plain PyTorch: the batch's int16 waveforms over
32768, the RMS normalization to the target dB over the valid samples,
Kaldi's fbank and CMN, the backbone in train mode (batch statistics), the
cosine classifier, the additive angular margin loss at the scheduled
margin, and Adam with coupled weight decay at the scheduled learning
rate, all in fp32 with TF32 off."""

import math

import torch
import torch.nn.functional as F

from . import fbank as ref_fbank
from .precision import no_tf32


def normalize_db(waves, target_db, ratios):
    ms = (waves ** 2).mean(-1) / ratios.clamp(min=1e-6)
    gain = torch.clamp(target_db - 10.0 * torch.log10(ms.clamp(min=1e-30)), max=300.0)
    return waves * 10.0 ** (gain[:, None] / 20.0)


def aam_loss(cosine, labels, margin, scale):
    sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, min=0.0))
    phi = cosine * math.cos(margin) - sine * math.sin(margin)
    th = math.cos(math.pi - margin)
    phi = torch.where(cosine > th, phi, cosine - (1.0 + th))
    one_hot = F.one_hot(labels, cosine.shape[-1]).to(cosine.dtype)
    return F.cross_entropy((one_hot * phi + (1.0 - one_hot) * cosine) * scale, labels)


def lr_at(update, base_lr, warmup_steps, max_iters, min_lr):
    """Linear warm-up, then cosine decay to ``min_lr`` (the reference's
    per-step table), for the update counted from 0."""
    if update < warmup_steps:
        return base_lr * update / max(warmup_steps, 1)
    p = min(max((update - warmup_steps) / max(max_iters - warmup_steps, 1), 0.0), 1.0)
    return min_lr + (base_lr - min_lr) * 0.5 * (math.cos(p * math.pi) + 1.0)


def margin_at(step, start_step, fix_step, initial, final):
    if step < start_step:
        return initial
    if step >= fix_step:
        return final
    r = 1.0 - math.exp((step - start_step) / (fix_step - start_step)
                       * math.log(1e-3 / (1.0 + 1e-6)))
    return initial + (final - initial) * r


def schedules(run_conf, steps_per_epoch, n_steps):
    """(margin, lr) of the first ``n_steps`` steps of a run of ``run_conf``."""
    tc, oc, lc = run_conf["train_conf"], run_conf["optimizer_conf"], run_conf["loss_conf"]
    sa = oc["scheduler_args"]
    warm = int(sa["warmup_epoch"] * steps_per_epoch)
    max_iters = int(tc["max_epoch"]) * steps_per_epoch
    ms = lc.get("margin_scheduler_args", {})
    start = int(tc["max_epoch"] * 0.3) * steps_per_epoch
    fix = int(tc["max_epoch"] * 0.7) * steps_per_epoch
    out = []
    for k in range(n_steps):
        m = (margin_at(k, start, fix, ms.get("initial_margin", 0.0), ms.get("final_margin", 0.3))
             if lc.get("use_margin_scheduler") else lc["loss_args"]["margin"])
        out.append((m, lr_at(k, sa["learning_rate"], warm, max_iters, sa["min_lr"])))
    return out


def train_steps(run_conf, model, cls_weight, batches, steps_per_epoch):
    """Run the steps on ``batches`` [(int16 waves, labels, ratios)] from
    ``model``, the reference model holding the seeded state, on the
    classifier's device. Returns ``(losses, first_grads, params_after)``:
    each step's loss, each leaf's gradient as the optimizer takes it at
    step 1 (weight decay included), each leaf after the last step; leaves
    named as the port's trainer names them."""
    dev = cls_weight.device
    model = model.to(dev)
    model.train()
    names = [f"model.{n}" for n, _ in model.named_parameters()] + ["classifier.weight"]
    weight = torch.nn.Parameter(cls_weight.clone())
    params = [p for _, p in model.named_parameters()] + [weight]
    oc = run_conf["optimizer_conf"]["optimizer_args"]
    wd, b1, b2, eps = float(oc.get("weight_decay", 0.0)), 0.9, 0.999, 1e-8
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    la = run_conf["loss_conf"]["loss_args"]
    target = run_conf["dataset_conf"]["dataset"]["target_dB"]
    losses, first = [], None
    sched = schedules(run_conf, steps_per_epoch, len(batches))
    with no_tf32():
        for k, ((waves, labels, ratios), (margin, lr)) in enumerate(zip(batches, sched)):
            r = ratios.to(dev).float()
            w = normalize_db(waves.to(dev).float() / 32768.0, target, r)
            feats = ref_fbank.features(w, r.cpu().numpy()).float()
            emb = model(feats, r)
            cos = F.normalize(emb, dim=-1, eps=1e-12) @ F.normalize(weight, dim=0, eps=1e-12)
            loss = aam_loss(cos, labels.to(dev), margin, la["scale"])
            grads = torch.autograd.grad(loss, params)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                gs = [g + wd * p for g, p in zip(grads, params)]
                if k == 0:
                    first = dict(zip(names, [g.clone() for g in gs]))
                t = k + 1
                for p, g, mi, vi in zip(params, gs, m, v):
                    mi.mul_(b1).add_(g, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (vi / (1 - b2 ** t)).sqrt() + eps
                    p.sub_(lr * (mi / (1 - b1 ** t)) / denom)
    return losses, first, dict(zip(names, [p.detach().clone() for p in params]))
