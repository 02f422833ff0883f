"""Rank programs of the port's data-parallel tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_train.py``,
and on the card ``tests/test_torch_gpu.py`` and
``tests/test_torch_gpu_workflows.py``).

Each test starts its ranks (two, unless it asks for another count)
through the port's launcher::

    python -m voiceprintrecognition_paddlepaddle_torch.launch_multihost \\
        --nproc 2 -- python tests/test_torch_parallel_ranks.py <dir> <prog>...

Every rank reads ``<dir>/inputs.pt``, joins the group from the
launcher's variables on the device the inputs name (``"device"``, by
default the CPU: gloo), runs each named program on its half of the inputs
and writes ``<dir>/rank<r>.pt`` (``{program: outputs}``) and its log lines
to ``<dir>/rank<r>.log``. Torch and the port only, no jax: the tests hold
the outputs against the JAX package in their own process. No test here.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _half(x, rank, world):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _device(inp):
    """This rank's device for the inputs' ``"device"``."""
    from voiceprintrecognition_paddlepaddle_torch.parallel import rank_device
    return rank_device(inp.get("device", "cpu"))


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def ragged(inp, rank, world):
    """``allgather_ragged`` with shards of 3 and 1 rows, numpy and
    tensors."""
    from voiceprintrecognition_paddlepaddle_torch.parallel import \
        allgather_ragged
    n = 3 if rank == 0 else 1
    feats = (np.arange(n * 2, dtype=np.float32).reshape(n, 2)
             + 100 * rank)
    labels = np.arange(n, dtype=np.int32) + 10 * rank
    g_np = allgather_ragged(feats, labels)
    g_t = allgather_ragged(torch.from_numpy(feats).to(_device(inp)), labels)
    empty = allgather_ragged(np.zeros((0 if rank else 2, 3), np.float64))
    return {"numpy": g_np, "tensor": (g_t[0].cpu().numpy(), g_t[1]),
            "empty_shard": empty[0]}


def batchnorm(inp, rank, world):
    """``layers.BatchNorm`` in train mode on this rank's half of each
    case's batch: the output, the input and weight gradients of
    ``sum(y * dy)``, the running statistics."""
    from voiceprintrecognition_paddlepaddle_torch.models.layers import \
        BatchNorm
    dev = _device(inp)
    out = {}
    for name, case in inp["bn"].items():
        bn = BatchNorm(case["x"].shape[1]).double().train()
        bn.load_state_dict({"weight": case["scale"], "bias": case["bias"],
                            "running_mean": case["mean"],
                            "running_var": case["var"],
                            "num_batches_tracked": torch.tensor(0)})
        bn.to(dev)
        x = _half(case["x"], rank, world).to(dev, copy=True)
        x.requires_grad_(True)
        y = bn(x)
        (y * _half(case["dy"], rank, world).to(dev)).sum().backward()
        out[name] = _cpu({"y": y, "dx": x.grad,
                          "dscale": bn.weight.grad, "dbias": bn.bias.grad,
                          "mean": bn.running_mean, "var": bn.running_var})
    return out


def triplet(inp, rank, world):
    """``TripletAngularMarginLoss`` on this rank's half: the loss and the
    gradients of the features and logits."""
    from voiceprintrecognition_paddlepaddle_torch.loss import \
        TripletAngularMarginLoss
    dev = _device(inp)
    t = inp["triplet"]
    crit = TripletAngularMarginLoss(**t["args"])
    feats = _half(t["features"], rank, world).to(dev, copy=True)
    feats.requires_grad_(True)
    logits = _half(t["logits"], rank, world).to(dev, copy=True)
    logits.requires_grad_(True)
    loss = crit({"features": feats, "logits": logits},
                _half(t["labels"], rank, world).to(dev), margin=t["margin"])
    loss.backward()
    return _cpu({"loss": loss, "dfeatures": feats.grad,
                 "dlogits": logits.grad})


def step(inp, rank, world):
    """One ``Trainer.train_step`` of the float64 model from the given
    weights on this rank's half of the features batch: the loss, the
    gradients DDP hands the optimizer, the BN statistics and the
    parameters after the update."""
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
    s = inp["step"]
    tr = Trainer(s["cfg"], device="cpu")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
    tr.model.double()
    tr.classifier.double()
    tr.model.load_state_dict(s["model"])
    tr.classifier.load_state_dict(s["classifier"])
    grads = {}

    def catch(opt, args, kwargs):
        for n, p in zip(tr.param_names, opt.param_groups[0]["params"]):
            grads[n] = p.grad.detach().clone()

    tr.optimizer.register_step_pre_hook(catch)
    tr.model.train()
    tr.classifier.train()
    loss, acc = tr.train_step("features", _half(s["feats"], rank, world),
                              _half(s["labels"], rank, world),
                              _half(s["ratio"], rank, world))
    return {"loss": float(loss), "grads": grads,
            "state": tr.model.state_dict(),
            "params": dict(zip(tr.param_names,
                               (p.detach() for p in
                                tr.optimizer.param_groups[0]["params"]))),
            "ddp": type(tr._net).__name__}


def evaluate(inp, rank, world):
    """``Trainer.evaluate`` of the given backbone weights over the lists,
    each rank embedding its shard."""
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
    e = inp["evaluate"]
    tr = Trainer(e["cfg"], device="cpu")
    tr._setup_dataloader()
    tr._setup_model(tr.audio_featurizer.feature_dim)
    tr.model.load_state_dict(e["model"])
    eer, min_dcf, threshold = tr.evaluate()
    return {"eer": eer, "min_dcf": min_dcf, "threshold": threshold,
            "embeddings": {k: (v[0].numpy(), v[1])
                           for k, v in tr.eval_embeddings.items()},
            "shard": len(tr.enroll_loader.batch_sampler)}


def train(inp, rank, world):
    """``Trainer.train`` for one epoch with ``checkpoint_format: orbax``
    and the per-epoch evaluation, each rank given its own checkpoint and
    TensorBoard directories; then a resume of rank 0's checkpoint for a
    second epoch, both ranks reading it."""
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
    t = inp["train"]
    root = t["root"]
    tr = Trainer(t["cfg"], device="cpu")
    tr.train(save_model_path=os.path.join(root, f"models_r{rank}"),
             log_dir=os.path.join(root, f"log_r{rank}"), max_epochs=1)
    first = {"step": tr.step, "eer": tr.eval_eer, "min_dcf": tr.eval_min_dcf,
             "steps_per_epoch": len(tr.train_loader),
             "state": {k: v.clone() for k, v in tr.model.state_dict().items()}}
    tr2 = Trainer(t["cfg"], device="cpu")
    tr2.train(save_model_path=os.path.join(root, "models_r0"), log_dir="",
              max_epochs=2, do_eval=False)
    return {"first": first, "resumed_step": tr2.step,
            "state": tr2.model.state_dict()}


def _card_steps(tr, batches, rank, world):
    """``tr.train_step`` on this rank's rows of each global batch of
    waveforms: the losses and the kernels' launches over the steps."""
    from torch_card import launches, launches_since
    tr.model.train()
    tr.classifier.train()
    before, losses = launches(), []
    for batch in batches:
        x = [torch.from_numpy(_half(a, rank, world)).to(tr.device)
             for a in batch]
        losses.append(tr.train_step("waveforms", *x)[0])
    return [float(x) for x in losses], launches_since(before)


def _card_trainer(cfg):
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
    tr = Trainer(cfg, device="cuda")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(80, is_train=True)
    return tr


def _state(tr):
    return {f"{part}.{k}": v.detach().cpu() for part in ("model", "classifier")
            for k, v in getattr(tr, part).state_dict().items()}


def ddp_steps(inp, rank, world):
    """On the card, cuDNN's convs in true fp32: DDP steps from the seeded
    weights on this rank's share of each global batch, rank 0's weights
    after them and an orbax (DCP) checkpoint; the same steps with no
    gradient exchange (each under DDP's ``no_sync``), the fault the held
    steps must tell apart; ``evaluate()`` of the given weights over this
    rank's shard. The launches of the steps and of the evaluation."""
    from torch_card import launches, launches_since
    from voiceprintrecognition_paddlepaddle_torch.utils.checkpoint import \
        save_checkpoint
    d = inp["ddp"]
    torch.backends.cudnn.allow_tf32 = False
    tr = _card_trainer(d["cfg"])
    losses, steps = _card_steps(tr, d["batches"], rank, world)
    out = {"device": str(tr.device), "backend": dist.get_backend(),
           "ddp": type(tr._net).__name__, "losses": losses,
           "train_launches": steps}
    if rank == 0:
        out["state"] = _state(tr)
        save_checkpoint(tr.configs, tr.train_state(), d["ckpt"], 1)
    dist.barrier()
    fault = _card_trainer(d["cfg"])
    with fault._train_net().no_sync():
        out["nosync_losses"] = _card_steps(fault, d["batches"], rank,
                                           world)[0]
    if rank == 0:
        out["nosync_state"] = _state(fault)
    del fault
    tr.model.load_state_dict(d["eval_model"])
    before = launches()
    out["eval"] = dict(zip(("eer", "min_dcf", "threshold"), tr.evaluate()))
    out["eval_launches"] = launches_since(before)
    out["eval_embeddings"] = {k: (v[0].cpu().numpy(), v[1])
                              for k, v in tr.eval_embeddings.items()}
    return out


def nccl_step(inp, rank, world):
    """One DDP step on the card on the first half of the first batch."""
    d = inp["ddp"]
    tr = _card_trainer(d["cfg"])
    half = [a[:a.shape[0] // 2] for a in d["batches"][0]]
    losses, steps = _card_steps(tr, [half], rank, world)
    return {"backend": dist.get_backend(), "world": tr.world,
            "ddp": type(tr._net).__name__, "loss": losses[0],
            "launches": steps}


def launch_ranks(directory, programs, inputs, timeout=240, nproc=2):
    """Run ``programs`` on ``nproc`` ranks through the port's launcher
    with ``inputs``; returns each rank's outputs, rank 0 first."""
    torch.save(inputs, os.path.join(directory, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-m",
         "voiceprintrecognition_paddlepaddle_torch.launch_multihost",
         "--nproc", str(nproc), "--timeout", str(timeout), "--",
         sys.executable, os.path.abspath(__file__), str(directory),
         *programs],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout + 30)
    assert run.returncode == 0, run.stderr[-6000:]
    return [torch.load(os.path.join(directory, f"rank{r}.pt"),
                       weights_only=False) for r in range(nproc)]


PROGRAMS = {f.__name__: f for f in (ragged, batchnorm, triplet, step,
                                    evaluate, train, ddp_steps, nccl_step)}


def main(directory, *programs):
    torch.set_num_threads(2)
    from voiceprintrecognition_paddlepaddle_torch.parallel import (
        local_process_info, maybe_initialize_distributed)
    from voiceprintrecognition_paddlepaddle_torch.utils.logger import logger
    inp = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    assert maybe_initialize_distributed(inp.get("device", "cpu"))
    rank, world = local_process_info()
    handler = logging.FileHandler(os.path.join(directory, f"rank{rank}.log"))
    logger.addHandler(handler)
    out = {name: PROGRAMS[name](inp, rank, world) for name in programs}
    out["rank_world"] = (rank, world)
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    handler.close()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
