"""Training and evaluation (counterpart of the JAX ``trainer.py``;
reference ``ppvector/trainer.py:33-474``).

``Trainer(configs, device="cuda", data_augment_configs=None)`` takes a
dict or a YAML path. ``device="cuda"`` raises when no CUDA device is
present; ``device="cpu"`` runs every wrapper's plain version.

The train step, in the JAX step's order (``trainer.py:351-411``):

1. int16 -> float / 32768;
2. ``DeviceAugmenter`` (volume, noise, reverb, then the dB normalization,
   on every step), draws from the trainer's ``torch.Generator``;
3. ``AudioFeaturizer``: the fbank kernel on the card for the stock Fbank,
   under ``torch.no_grad()`` and outside ``autocast`` (fp32 features, as
   JAX featurizes in fp32);
4. SpecAugment;
5. the backbone in train mode with ``lengths=ratios``, the classifier, the
   loss with the scheduled margin, under ``torch.autocast`` bf16 when
   ``train_conf.enable_amp``;
6. backward, and every ``train_conf.accum_steps``-th step the optimizer
   update on the mean of the microbatch gradients (optax ``MultiSteps``)
   with ``lr = schedule(update)``, the update counted from 0;
7. accuracy over the sub-center max.

No kernel has a backward: the backbone trains as the plain modules under
autograd, as in JAX.

``evaluate()`` embeds the enroll and trials lists with the model in eval
mode and scores every pair with one matmul on the device. On CUDA the
stock CAM++ (``predict.campplus_kernel_path_applies``) embeds buckets up to
32 s through the fbank, FCM and trunk kernels
(``trunk_kernel.make_campplus_masked_embed_fn``), with the weights packed
anew on every call; other buckets and configs run the plain model. Unlike
the JAX trainer (``trainer.py:804-815``), a kernel that fails raises: the
evaluation never falls back.

``train_conf.enable_remat`` runs the backbone's forward under
``torch.utils.checkpoint`` (JAX ``jax.checkpoint``, ``trainer.py:366-379``);
the recomputation in the backward leaves the BatchNorm running statistics
alone (``layers.frozen_running_stats``), so a step moves them once, as the
functional flax step does. ``optimizer_args.mu_dtype`` keeps Adam's first
moment in that dtype (``optimizer/adam.py``). ``train(profiler_dir=...)``
traces steps 10-19 with ``torch.profiler``. ``extract_features`` writes
per-utterance ``.npy`` features; ``export`` writes the inference bundle,
with ``model.pt2`` from ``torch.export`` of the plain wav -> embedding
forward.

Data parallelism (JAX ``trainer.py`` over ``parallel/mesh.py``) is one
process per device, started by ``launch_multihost`` (or a cluster runner)
and joined by ``parallel.maybe_initialize_distributed`` in ``__init__``:

- each rank computes on its own device (``parallel.rank_device``) and
  draws its augmentation from a generator seeded ``1000 + rank`` (JAX
  ``PRNGKey(1000 + rank)``); the initial weights come from seed 1000 on
  every rank;
- the samplers are rank-sharded (``num_replicas=world, rank=rank``); the
  sampler's ``batch_size`` is per rank, and a train sampler must drop the
  last partial batch, so that every rank holds the same batch size;
- the backbone, head and loss run as one module under
  ``DistributedDataParallel`` whenever a process group is up, one rank
  included (``broadcast_buffers=False``: the BatchNorm
  statistics are those of the global batch on every rank,
  ``layers.BatchNorm``), with ``no_sync`` on the microbatches before an
  accumulated update;
- logs, TensorBoard, the profiler and checkpoints are rank 0's; the
  logged loss and accuracy are means over the ranks;
- ``evaluate()`` is collective: each rank embeds its shard of the enroll
  and trials lists, and ``parallel.allgather_ragged`` joins them in rank
  order on every rank (also a rank that stopped early), so that every
  rank reports the same EER.

``train_conf.num_devices`` caps the devices as in JAX: a run of one
process uses one device, and a run of several uses every rank (a cap that
differs is logged and ignored). ``train_conf.checkpoint_format: orbax``
writes ``torch.distributed.checkpoint`` directories
(``utils/checkpoint.py``).
"""

import json
import os
import time
from contextlib import nullcontext
from datetime import timedelta

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from .data_utils import (BatchSampler, DataLoader, PKSampler, SpeakerDataset,
                         collate_features, collate_waveforms)
from .data_utils.collate import bucket_length
from .loss import build_loss
from .metric.metrics import compute_dcf, compute_eer, compute_fnr_fpr
from .models import build_model
from .models.campplus import SEG_LEN, CAMPPlus
from .models.fc import SpeakerIdentification
from .models.layers import frozen_running_stats
from .models.trunk_kernel import make_campplus_masked_embed_fn
from .ops import kaldi
from .ops.augment import DeviceAugmenter
from .ops.features import AudioFeaturizer, apply_cmn_and_mask
from .optimizer import (MarginScheduler, build_lr_scheduler, build_optimizer,
                        scheduled_step)
from .parallel import (all_reduce_sum, allgather_ragged, local_process_info,
                       maybe_initialize_distributed, rank_device)
from .predict import (MAX_KERNEL_BUCKET_SAMPLES, _load_configs,
                      campplus_kernel_path_applies)
from .utils.checkpoint import (CHECKPOINT_FORMATS, AsyncSaver,
                               load_checkpoint, load_pretrained,
                               save_checkpoint)
from .utils import tracing
from .utils.logger import logger
from .utils.utils import dict_to_object, print_arguments

__all__ = ["Trainer", "PPVectorTrainer"]

# the steps train(profiler_dir=...) traces: [start, stop)
PROFILE_STEPS = (10, 20)


class _TrainNet(nn.Module):
    """The backbone, the head and the loss of a train step as one module:
    one DDP wrapper averages the gradients of all three (SphereFace2's
    bias included). ``remat`` runs the backbone under
    ``torch.utils.checkpoint``; the recomputation leaves the BN running
    statistics as the forward left them."""

    def __init__(self, model, classifier, criterion, remat):
        super().__init__()
        self.model = model
        self.classifier = classifier
        self.criterion = criterion
        self.remat = remat

    def forward(self, feats, lens, labels, margin):
        if self.remat:
            emb = checkpoint(
                lambda f, r: self.model(f, lengths=r), feats, lens,
                use_reentrant=False,
                context_fn=lambda: (nullcontext(), frozen_running_stats()))
        else:
            emb = self.model(feats, lengths=lens)
        outputs = self.classifier(emb)
        loss = self.criterion(outputs, labels, margin=margin)
        return loss, outputs["logits"]


class Trainer:
    def __init__(self, configs, device="cuda", data_augment_configs=None):
        if (torch.device(device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError("Trainer(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        # the process group of a data-parallel run (no-op without the
        # launcher's variables), then this rank's device
        maybe_initialize_distributed(device)
        self.rank, self.world = local_process_info()
        self.device = rank_device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if isinstance(configs, str):
            configs = _load_configs(configs)
            print_arguments(configs=configs)
        self.configs = dict_to_object(configs)
        if isinstance(data_augment_configs, str):
            if not data_augment_configs.strip():
                data_augment_configs = None  # '' on the CLI = no augmentation
            else:
                data_augment_configs = _load_configs(data_augment_configs)
                print_arguments(configs=data_augment_configs,
                                title="augmentation configs")
        self.data_augment_configs = dict_to_object(data_augment_configs or {})
        train_conf = self.configs.get("train_conf", {})
        num_devices = int(train_conf.get("num_devices", 0) or 0)
        if num_devices > 1 and self.world == 1:
            logger.warning(
                f"train_conf.num_devices {num_devices}: this run has one "
                f"process, so it trains on one device ({self.device}); "
                f"start {num_devices} ranks with launch_multihost --nproc "
                f"{num_devices} for data parallelism")
        elif num_devices and num_devices != self.world:
            logger.warning(f"ignoring train_conf.num_devices {num_devices} "
                           f"in a run of {self.world} ranks; using all ranks")
        fmt = train_conf.get("checkpoint_format", "torch")
        if fmt not in CHECKPOINT_FORMATS:
            raise ValueError(f"unknown train_conf.checkpoint_format {fmt!r}; "
                             f"one of {sorted(CHECKPOINT_FORMATS)}")
        self.amp = bool(train_conf.get("enable_amp", False))
        self.remat = bool(train_conf.get("enable_remat", False))
        self._profiler = self._profiler_dir = None

        self.audio_featurizer = None
        self.train_dataset = self.train_loader = None
        self.enroll_dataset = self.enroll_loader = None
        self.trials_dataset = self.trials_loader = None
        self.model = self.classifier = self.criterion = None
        self._net = None        # _TrainNet; under DDP when a group is up
        self._emb_dim = None
        self.optimizer = None
        self.param_names = []
        self.margin_scheduler = None
        self.lr_schedule = None
        self.accum_steps = 1
        self.augmenter = None
        self.step = 0
        self.max_step = 0
        self.train_loss = self.train_acc = None
        self.train_eta_sec = None
        self.train_window_speeds = []
        self.eval_eer = self.eval_min_dcf = self.eval_threshold = None
        self.eval_embeddings = None
        self._banks = None
        self.test_log_step = self.train_log_step = 0
        self.stop_train = self.stop_eval = False
        # augmentation and dither draws: one generator on the train device,
        # seeded per rank
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(1000 + self.rank)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _loss_name(self):
        return self.configs.loss_conf.get(
            "loss", self.configs.loss_conf.get("use_loss", "AAMLoss"))

    def _setup_dataloader(self, is_train=False):
        self.audio_featurizer = AudioFeaturizer(
            feature_method=self.configs.preprocess_conf.feature_method,
            method_args=self.configs.preprocess_conf.get("method_args", {}))
        dataset_args = dict(self.configs.dataset_conf.get("dataset", {}))
        sampler_args = dict(self.configs.dataset_conf.get("sampler", {}))
        loader_args = dict(self.configs.dataset_conf.get("dataLoader", {}))
        max_feature_len = self.audio_featurizer.num_frames(
            int(dataset_args.get("max_duration", 3)
                * dataset_args.get("sample_rate", 16000)))
        workers = loader_args.get("num_workers", 4)
        shard = dict(num_replicas=self.world, rank=self.rank)
        if is_train:
            self.train_dataset = SpeakerDataset(
                data_list_path=self.configs.dataset_conf.train_list,
                aug_conf=self.data_augment_configs,
                num_speakers=self.configs.model_conf.classifier.num_speakers,
                mode="train", max_feature_len=max_feature_len,
                **dataset_args)
            if self.world > 1 and not sampler_args.get("drop_last", True):
                raise ValueError(
                    "dataset_conf.sampler.drop_last must be true in a "
                    "data-parallel run: every rank must hold the same batch "
                    "size for DDP's mean of the gradients to be the global "
                    "batch's")
            if (self.configs.dataset_conf.get("is_use_pksampler", False)
                    or self._loss_name() == "TripletAngularMarginLoss"):
                sampler = PKSampler(
                    self.train_dataset,
                    sample_per_id=self.configs.dataset_conf.get(
                        "sample_per_id", 4), **shard, **sampler_args)
            else:
                sampler = BatchSampler(self.train_dataset, **shard,
                                       **sampler_args)
            self.train_loader = DataLoader(self.train_dataset, sampler,
                                           self._train_collate,
                                           num_workers=workers)
        # eval loaders (reference ``trainer.py:113-131``)
        eval_args = dict(dataset_args)
        eval_args["max_duration"] = \
            self.configs.dataset_conf.eval_conf.max_duration
        eval_bs = self.configs.dataset_conf.eval_conf.batch_size
        for attr, list_key in (("enroll", "enroll_list"),
                               ("trials", "trials_list")):
            list_path = self.configs.dataset_conf.get(list_key)
            if not list_path or not os.path.exists(list_path):
                continue
            ds = SpeakerDataset(data_list_path=list_path, mode="eval",
                                **eval_args)
            # each rank embeds its shard; _embed_loader gathers them
            sampler = BatchSampler(ds, batch_size=eval_bs, shuffle=False,
                                   drop_last=False, **shard)
            setattr(self, f"{attr}_dataset", ds)
            setattr(self, f"{attr}_loader",
                    DataLoader(ds, sampler, self._eval_collate,
                               num_workers=workers))

    @staticmethod
    def _train_collate(items):
        if items[0][0].ndim == 2:  # precomputed features
            return ("features",) + collate_features(items, bucket=True)
        # int16 transfer: half the host-to-device bytes
        return ("waveforms",) + collate_waveforms(items, bucket=False,
                                                  quantize_int16=True)

    @staticmethod
    def _eval_collate(items):
        if items[0][0].ndim == 2:
            return ("features",) + collate_features(items, bucket=True)
        return ("waveforms",) + collate_waveforms(items, bucket=True)

    def _setup_model(self, input_size, is_train=False):
        dataset_args = self.configs.dataset_conf.get("dataset", {})
        t_probe = max(self.audio_featurizer.num_frames(
            int(dataset_args.get("max_duration", 3) * 16000)), 98)
        # initial weights from a seed (the reference seeds 1000) without
        # touching the caller's global RNG state
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1000)
            self.model = build_model(input_size, self.configs)
            with torch.no_grad():
                emb_dim = self.model.eval()(
                    torch.zeros(2, t_probe, input_size)).shape[-1]
            self._emb_dim = emb_dim
            if is_train:
                num_class = self.configs.model_conf.classifier.num_speakers
                speed_conf = self.data_augment_configs.get("speed") or {}
                if (speed_conf.get("prob", 0) > 0
                        and speed_conf.get("speed_perturb_3_class", False)):
                    num_class *= 3
                cls_conf = dict(self.configs.model_conf.classifier)
                cls_conf["num_speakers"] = num_class
                self.classifier = SpeakerIdentification(emb_dim, **cls_conf)
                self.criterion = build_loss(self.configs)
        self.model.to(self.device)
        n = sum(p.numel() for p in self.model.parameters())
        logger.info(f"backbone parameters: {n / 1e6:.2f}M "
                    f"({self.configs.model_conf.model})")
        if not is_train:
            return
        self.classifier.to(self.device)
        self.criterion.to(self.device)
        self._net = None        # wrapped at the first train step
        if self.configs.loss_conf.get("use_margin_scheduler", False):
            ms_args = dict(
                increase_start_epoch=int(
                    self.configs.train_conf.max_epoch * 0.3),
                fix_epoch=int(self.configs.train_conf.max_epoch * 0.7),
                initial_margin=0.0, final_margin=0.3)
            ms_args.update(self.configs.loss_conf.get(
                "margin_scheduler_args", {}))
            self.margin_scheduler = MarginScheduler(
                criterion=self.criterion,
                step_per_epoch=len(self.train_loader), **ms_args)
        # gradient accumulation: the LR schedule paces on optimizer updates
        self.accum_steps = max(int(self.configs.train_conf.get(
            "accum_steps", 1)), 1)
        self.lr_schedule = build_lr_scheduler(
            step_per_epoch=max(len(self.train_loader) // self.accum_steps, 1),
            configs=self.configs)
        named = [(f"{prefix}.{n}", p) for prefix, mod in (
            ("model", self.model), ("classifier", self.classifier),
            ("loss", self.criterion)) for n, p in mod.named_parameters()]
        self.param_names = [n for n, _ in named]
        self.optimizer = build_optimizer(
            [p for _, p in named], self.configs,
            fused=True if self.device.type == "cuda" else None)
        if self.accum_steps > 1:
            logger.info(f"gradient accumulation: {self.accum_steps} "
                        f"microbatches per optimizer update")
        self.augmenter = DeviceAugmenter(
            self.data_augment_configs,
            sample_rate=dataset_args.get("sample_rate", 16000),
            clip_seconds=dataset_args.get("max_duration", 3),
            target_db=(dataset_args.get("target_dB", -20)
                       if dataset_args.get("use_dB_normalization", True)
                       else None))

    # ------------------------------------------------------------------
    # train state
    # ------------------------------------------------------------------
    def train_state(self):
        """The live train state (``utils/checkpoint.py``'s five entries)."""
        return {"model": self.model.state_dict(),
                "classifier": self.classifier.state_dict(),
                "loss": self.criterion.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_train_state(self, state):
        """Load a train state (a checkpoint's, or
        ``convert.jax_to_torch_train_state``'s) into the modules and the
        optimizer. The optimizer keeps its own hyperparameters."""
        self.model.load_state_dict(state["model"])
        self.classifier.load_state_dict(state["classifier"])
        self.criterion.load_state_dict(state["loss"])
        opt = dict(state["optimizer"])
        opt["param_groups"] = [
            {**saved, **{k: v for k, v in cur.items() if k != "params"}}
            for saved, cur in zip(opt["param_groups"],
                                  self.optimizer.param_groups)]
        self.optimizer.load_state_dict(opt)
        self.step = int(state["step"])

    @property
    def updates(self):
        """Optimizer updates so far (the LR schedule's step)."""
        return self.step // self.accum_steps

    def _margin(self):
        return (self.margin_scheduler.get_margin()
                if self.margin_scheduler else
                self.configs.loss_conf.get("loss_args", {}).get("margin", 0.2))

    # ------------------------------------------------------------------
    # the hot path
    # ------------------------------------------------------------------
    def featurize(self, kind, data, lens):
        """One batch on the device -> augmented fp32 features ``(B, T, F)``
        (steps 1-4 of the train step); no autograd graph."""
        with torch.no_grad():
            if kind == "waveforms":
                waves = data
                if waves.dtype == torch.int16:
                    waves = waves.to(torch.float32) / 32768.0
                waves = self.augmenter(waves, self._gen, valid_ratio=lens,
                                       banks=self._banks)
                rng = self._gen if self.audio_featurizer.dither > 0 else None
                feats = self.audio_featurizer(waves, input_lens_ratio=lens,
                                              rng=rng)
            else:
                feats = data
            return self.augmenter.augment_features(feats, self._gen)

    def train_step(self, kind, data, labels, lens):
        """One microbatch already on the device; returns ``(loss, acc)``
        as device scalars (no host sync). Its spans: ``vpr.train.step``
        around ``vpr.train.{featurize,forward,backward,optimizer}``."""
        with tracing.span("vpr.train.step", id=self.step):
            with tracing.span("vpr.train.featurize"):
                feats = self.featurize(kind, data, lens)
            net = self._train_net()
            # DDP all-reduces the gradients on an update's microbatch only
            final = (self.step + 1) % self.accum_steps == 0
            sync = (net.no_sync() if isinstance(net, DistributedDataParallel)
                    and not final else nullcontext())
            with sync:
                with tracing.span("vpr.train.forward"), torch.autocast(
                        self.device.type, dtype=torch.bfloat16,
                        enabled=self.amp):
                    loss, logits = net(feats, lens, labels, self._margin())
                with tracing.span("vpr.train.backward"):
                    (loss / self.accum_steps if self.accum_steps > 1
                     else loss).backward()
            self.step += 1
            with tracing.span("vpr.train.optimizer"):
                scheduled_step(self.optimizer, self.lr_schedule, self.step,
                               self.accum_steps)
                acc = self._accuracy(logits, labels)
            return loss.detach(), acc

    @torch.no_grad()
    def _accuracy(self, logits, labels):
        logits = logits.detach()
        if self._loss_name() == "SubCenterLoss":
            k = self.configs.loss_conf.get("loss_args", {}).get("K", 3)
            logits = torch.amax(logits.reshape(logits.shape[0], -1, k), 2)
        return (torch.argmax(logits, dim=-1) == labels).float().mean()

    def _train_net(self):
        """The step's module: ``_TrainNet``, wrapped in DDP when a process
        group is up (a run the launcher started, one rank too). Built at
        the first step, so that the modules' dtype and weights are final
        by then (DDP's buckets keep the dtype they were built with); DDP's
        construction broadcasts rank 0's weights, and every rank takes its
        first step together."""
        if self._net is None:
            net = _TrainNet(self.model, self.classifier, self.criterion,
                            self.remat)
            if torch.distributed.is_initialized():
                ids = ([self.device.index] if self.device.type == "cuda"
                       else None)
                net = DistributedDataParallel(net, device_ids=ids,
                                              broadcast_buffers=False)
            self._net = net
        return self._net

    def _to_device(self, arr):
        with tracing.span("vpr.train.to_device"):
            t = torch.from_numpy(arr)
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t

    # ------------------------------------------------------------------
    # public API (reference surface)
    # ------------------------------------------------------------------
    def train(self, save_model_path="models/", log_dir="log/",
              resume_model=None, pretrained_model=None, do_eval=True,
              max_epochs=None, profiler_dir=None):
        """``profiler_dir``: when set, rank 0 traces train steps 10-19
        (``PROFILE_STEPS``) with ``torch.profiler``, CUDA activity included
        on the card, and writes the trace there (a ``*.pt.trace.json`` that
        TensorBoard and Perfetto open), as JAX ``trainer.py:700-708``."""
        self._profiler_dir = profiler_dir if self.rank == 0 else None
        self.train_window_speeds = []
        writer = None
        if log_dir and self.rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
                writer = SummaryWriter(log_dir=log_dir)
            except Exception as e:  # noqa: BLE001 - tensorboard is optional
                logger.warning(f"tensorboard writer unavailable: {e}")

        self._setup_dataloader(is_train=True)
        self._setup_model(self.audio_featurizer.feature_dim, is_train=True)
        if pretrained_model is not None:
            load_pretrained({"model": self.model,
                             "classifier": self.classifier,
                             "loss": self.criterion}, pretrained_model)
        last_epoch, best_eer = 0, 1.0
        if save_model_path or resume_model:
            _, last_epoch, best_eer = load_checkpoint(
                self.configs, self.load_train_state, save_model_path or "",
                resume_model)
        if self.margin_scheduler:
            self.margin_scheduler.step(current_step=self.step)
        if last_epoch:
            # resume continues the (seed, epoch) sample stream
            self.train_loader.batch_sampler.set_epoch(last_epoch)
        logger.info(f"train data: {len(self.train_dataset)}, device: "
                    f"{self.device} (rank {self.rank} of {self.world})")
        self.model.train()
        self.classifier.train()
        max_epoch = max_epochs or self.configs.train_conf.max_epoch
        self.max_step = len(self.train_loader) * max_epoch
        self.test_log_step = self.train_log_step = 0
        if self.rank != 0:
            save_model_path = ""            # checkpoints are rank 0's
        self._async_saver = (
            AsyncSaver() if (save_model_path and self.configs.train_conf.get(
                "async_checkpoint", True)) else None)
        try:
            self._train_epochs(last_epoch, max_epoch, writer,
                               save_model_path, do_eval, best_eer)
        finally:
            self._stop_profiler()
            if self._async_saver is not None:
                self._async_saver.close()
                self._async_saver = None
            if writer is not None:
                writer.close()
        if self.world > 1:
            # rank 0's checkpoints are on disk when train() returns on
            # any rank (a resume that follows reads them)
            torch.distributed.barrier()

    def _save(self, save_model_path, epoch_id, **kw):
        save_checkpoint(self.configs, self.train_state(), save_model_path,
                        epoch_id, margin=self._margin(),
                        async_saver=self._async_saver, **kw)

    def _train_epochs(self, last_epoch, max_epoch, writer, save_model_path,
                      do_eval, best_eer):
        for epoch_id in range(last_epoch + 1, max_epoch + 1):
            if self.stop_train:
                break
            start_epoch = time.time()
            self._train_epoch(epoch_id, max_epoch, writer, save_model_path)
            eval_ok = False
            if do_eval and not self.stop_eval:
                # collective in a group of > 1: every rank evaluates
                if self.rank == 0:
                    logger.info("=" * 70)
                try:
                    (self.eval_eer, self.eval_min_dcf,
                     self.eval_threshold) = self.evaluate()
                    eval_ok = True
                except Exception:
                    # a broken eval config (e.g. a missing trials list) must
                    # not discard the epoch: log it and save the epoch
                    logger.exception("per-epoch evaluation failed; the epoch "
                                     "checkpoint is still saved below")
            if eval_ok and self.rank == 0:
                logger.info(
                    f"Test epoch: {epoch_id}, time/epoch: "
                    f"{timedelta(seconds=int(time.time() - start_epoch))}, "
                    f"threshold: {self.eval_threshold:.2f}, "
                    f"EER: {self.eval_eer:.5f}, "
                    f"MinDCF: {self.eval_min_dcf:.5f}")
                logger.info("=" * 70)
                if writer is not None:
                    writer.add_scalar("Test/threshold", self.eval_threshold,
                                      self.test_log_step)
                    writer.add_scalar("Test/min_dcf", self.eval_min_dcf,
                                      self.test_log_step)
                    writer.add_scalar("Test/eer", self.eval_eer,
                                      self.test_log_step)
                self.test_log_step += 1
                if self.eval_eer <= best_eer and save_model_path:
                    best_eer = self.eval_eer
                    self._save(save_model_path, epoch_id, eer=self.eval_eer,
                               min_dcf=self.eval_min_dcf,
                               threshold=self.eval_threshold, best_model=True)
            if save_model_path:
                self._save(save_model_path, epoch_id, eer=self.eval_eer,
                           min_dcf=self.eval_min_dcf,
                           threshold=self.eval_threshold)

    def _train_epoch(self, epoch_id, max_epoch, writer, save_model_path):
        batch_size = self.configs.dataset_conf.sampler.batch_size
        log_interval = self.configs.train_conf.log_interval
        last_log_time, last_log_batch = time.time(), 0
        # per-epoch refresh of the noise / RIR banks
        self._banks = self.augmenter.device_banks(epoch_id, self.device)
        for batch_id, (kind, data, labels, lens) in enumerate(
                self.train_loader):
            if self.stop_train:
                break
            if self.margin_scheduler:
                self.margin_scheduler.step(current_step=self.step)
            data, labels, lens = (self._to_device(x)
                                  for x in (data, labels, lens))
            self._profile_hook()
            loss, acc = self.train_step(kind, data, labels, lens)
            if batch_id % log_interval == 0 and self.world > 1:
                # the global batch's means, as JAX's step reports them
                loss, acc = all_reduce_sum(torch.stack([loss.float(),
                                                        acc])) / self.world
            if batch_id % log_interval == 0 and self.rank == 0:
                self.train_loss, self.train_acc = float(loss), float(acc)
                now = time.time()
                step_sec = (now - last_log_time) / max(batch_id
                                                       - last_log_batch, 1)
                last_log_time, last_log_batch = now, batch_id
                train_speed = batch_size / step_sec
                self.train_window_speeds.append(train_speed)
                self.train_eta_sec = step_sec * (self.max_step - self.step)
                lr = self.lr_schedule(self.updates)
                margin_str = (f"margin: {self._margin():.5f}"
                              if self.margin_scheduler else "")
                logger.info(
                    f"Train epoch: [{epoch_id}/{max_epoch}], "
                    f"batch: [{batch_id}/{len(self.train_loader)}], "
                    f"loss: {self.train_loss:.5f}, "
                    f"accuracy: {self.train_acc:.5f}, "
                    f"learning rate: {lr:.8f}, {margin_str} "
                    f"speed: {train_speed:.2f} data/sec, "
                    f"eta: {timedelta(seconds=int(self.train_eta_sec))}")
                if writer is not None:
                    for tag, v in (("Train/Loss", self.train_loss),
                                   ("Train/Accuracy", self.train_acc),
                                   ("Train/lr", lr)):
                        writer.add_scalar(tag, v, self.train_log_step)
                    if self.margin_scheduler:
                        writer.add_scalar("Train/margin", self._margin(),
                                          self.train_log_step)
                self.train_log_step += 1
            if batch_id % 10000 == 0 and batch_id != 0 and save_model_path:
                # the epoch is not complete: record epoch_id - 1 so that a
                # resume replays this epoch from these weights
                self._save(save_model_path, epoch_id,
                           completed_epoch=epoch_id - 1)

    def _profile_hook(self):
        """Before a step: start the trace at step 10, stop it at 20."""
        if not self._profiler_dir:
            return
        if self.step == PROFILE_STEPS[0] and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self._profiler_dir))
            self._profiler.start()
        elif self.step == PROFILE_STEPS[1]:
            self._stop_profiler()

    def _stop_profiler(self):
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        self._profiler = None
        logger.info(f"profiler trace saved: {self._profiler_dir}")

    # ------------------------------------------------------------------
    def _eval_embed_fn(self):
        """``(waves tensor, ratios numpy) -> embeddings`` for the kernel
        path with the current weights packed now, or None where the plain
        model serves every batch."""
        if (self.device.type == "cuda"
                and campplus_kernel_path_applies(self.model,
                                                 self.audio_featurizer)):
            return make_campplus_masked_embed_fn(self.model,
                                                 self.audio_featurizer)
        return None

    @torch.no_grad()
    def _embed_plain(self, kind, data, lens):
        if kind == "waveforms":
            rng = None
            if self.audio_featurizer.dither > 0:
                # a fixed seed: a reproducible eval dither (JAX: PRNGKey(0))
                rng = torch.Generator(device=self.device)
                rng.manual_seed(0)
            feats = self.audio_featurizer(data, input_lens_ratio=lens,
                                          rng=rng)
        else:
            feats = data
        return self.model(feats, lengths=lens).float()

    def _embed_loader(self, loader, fast):
        """This rank's shard of ``loader`` embedded on its device, then every
        rank's shard in rank order (``allgather_ragged``, called by every
        rank, also one that stopped early; JAX ``trainer.py:763-840``)."""
        feats, labels = [], []
        for kind, data, y, lens in loader:
            if self.stop_eval:
                break
            x = self._to_device(data)
            if (fast is not None and kind == "waveforms"
                    and data.shape[1] <= MAX_KERNEL_BUCKET_SAMPLES):
                emb = fast(x, lens)
            else:
                emb = self._embed_plain(kind, x, self._to_device(lens))
            feats.append(emb.float())
            labels.append(y)
        emb_dim = feats[0].shape[1] if feats else self._emb_dim
        feats = (torch.cat(feats) if feats else
                 torch.zeros((0, emb_dim), device=self.device))
        labels = (np.concatenate(labels).astype(np.int32) if labels
                  else np.zeros((0,), np.int32))
        return allgather_ragged(feats, labels)

    def evaluate(self, resume_model=None, save_image_path=None):
        """Returns ``(eer, min_dcf, threshold)``; the embeddings stay in
        ``self.eval_embeddings`` (``{"enroll": (tensor, labels),
        "trials": ...}``)."""
        if self.enroll_loader is None or self.trials_loader is None:
            self._setup_dataloader()
        if self.enroll_loader is None or self.trials_loader is None:
            raise FileNotFoundError(
                "evaluate() needs dataset_conf.enroll_list and "
                "dataset_conf.trials_list to exist "
                f"(enroll_list={self.configs.dataset_conf.get('enroll_list')}, "
                f"trials_list={self.configs.dataset_conf.get('trials_list')})")
        if self.model is None:
            self._setup_model(self.audio_featurizer.feature_dim)
        if resume_model is not None:
            load_pretrained({"model": self.model}, resume_model)
        was_training = self.model.training
        self.model.eval()
        try:
            fast = self._eval_embed_fn()
            enroll = self._embed_loader(self.enroll_loader, fast)
            trials = self._embed_loader(self.trials_loader, fast)
        finally:
            self.model.train(was_training)
        self.eval_embeddings = {"enroll": enroll, "trials": trials}
        if self.stop_eval:
            return -1, -1, -1
        scores, match = self._score_all(trials[0], enroll[0], trials[1],
                                        enroll[1])
        fnr, fpr, thresholds = compute_fnr_fpr(scores, match)
        eer, threshold = compute_eer(fnr, fpr, scores)
        min_dcf = compute_dcf(fnr, fpr)
        eer, min_dcf, threshold = float(eer), float(min_dcf), float(threshold)
        if save_image_path and self.rank == 0:
            self._plot(fnr, fpr, thresholds, threshold, save_image_path)
        return eer, min_dcf, threshold

    @staticmethod
    def _plot(fnr, fpr, thresholds, threshold, save_image_path):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        index = int(np.argmin(np.abs(thresholds - threshold)))
        plt.figure()
        plt.plot(thresholds, fnr, color="blue", linestyle="-", label="fnr")
        plt.plot(thresholds, fpr, color="red", linestyle="-", label="fpr")
        plt.plot(threshold, fpr[index], "ro-")
        plt.text(threshold, fpr[index],
                 (round(threshold, 3), round(float(fpr[index]), 5)),
                 color="red")
        plt.xlabel("threshold")
        plt.title("fnr and fpr")
        plt.grid(True)
        os.makedirs(save_image_path, exist_ok=True)
        out = os.path.join(save_image_path, "result.png")
        plt.savefig(out)
        plt.close()
        logger.info(f"result plot saved to: {out}")

    @staticmethod
    def _score_all(trials, enrolls, trials_labels, enroll_labels):
        """All-pairs cosine scores (one matmul on the device) and
        same-speaker labels, flattened trial-major."""
        t = trials / torch.clamp(torch.linalg.norm(trials, dim=1,
                                                   keepdim=True), min=1e-12)
        e = enrolls / torch.clamp(torch.linalg.norm(enrolls, dim=1,
                                                    keepdim=True), min=1e-12)
        scores = (t @ e.T).reshape(-1).cpu().numpy().astype(np.float32)
        match = (trials_labels[:, None]
                 == enroll_labels[None, :]).reshape(-1).astype(np.int32)
        return scores, match

    # ------------------------------------------------------------------
    def extract_features(self, save_dir="dataset/features", max_duration=100):
        """Write per-utterance ``.npy`` features and a ``*_features.txt``
        list beside each list that exists (JAX ``trainer.py:913-949``):
        each clip padded to its bucket, featurized with its length ratio on
        the trainer's device (the fbank kernel on the card for the stock
        Fbank) and trimmed to its valid frames."""
        self.audio_featurizer = AudioFeaturizer(
            feature_method=self.configs.preprocess_conf.feature_method,
            method_args=self.configs.preprocess_conf.get("method_args", {}))
        for data_list in [self.configs.dataset_conf.train_list,
                          self.configs.dataset_conf.enroll_list,
                          self.configs.dataset_conf.trials_list]:
            if not data_list or not os.path.exists(data_list):
                continue
            dataset_args = dict(self.configs.dataset_conf.get("dataset", {}))
            dataset_args["max_duration"] = max_duration
            ds = SpeakerDataset(data_list_path=data_list,
                                mode="extract_feature", **dataset_args)
            save_list = data_list.replace(".txt", "_features.txt")
            with open(save_list, "w", encoding="utf-8") as f:
                for counter in range(len(ds)):
                    samples, label, valid = ds[counter]
                    n_frames = self.audio_featurizer.num_frames(valid)
                    pad_len = bucket_length(len(samples))
                    padded = torch.zeros((1, pad_len), dtype=torch.float32)
                    padded[0, :len(samples)] = torch.from_numpy(samples)
                    ratio = torch.tensor([len(samples) / pad_len],
                                         dtype=torch.float32)
                    with torch.no_grad():
                        feat = self.audio_featurizer(
                            padded.to(self.device),
                            ratio.to(self.device))[0, :n_frames]
                    save_path = os.path.join(
                        save_dir, str(label),
                        f"{int(time.time() * 1000)}_{counter}.npy")
                    os.makedirs(os.path.dirname(save_path), exist_ok=True)
                    np.save(save_path, feat.cpu().numpy())
                    f.write(f"{save_path}\t{label}\n")
            logger.info(f"features extracted for {data_list} -> {save_list}")

    def _export_featurize(self):
        """The plain front end for the exported program: the Fbank as
        ``kaldi.fbank`` (a CUDA extension cannot go into a portable
        program, as JAX keeps Pallas out of its StableHLO export)."""
        pre = self.configs.preprocess_conf
        if pre.feature_method != "Fbank":
            return self.audio_featurizer
        args = dict(pre.get("method_args", {}))
        args.setdefault("sr", 16000)

        def featurize(waves):
            return apply_cmn_and_mask(kaldi.fbank(waves, **args))
        return featurize

    def _export_min_frames(self):
        """The shortest symbolic length, in frames, ``export`` takes: 10,
        as JAX; 201 for CAM++, whose context pooling over segments of
        ``SEG_LEN`` frames (after its stride-2 stem) makes ``torch.export``
        assume more than one segment, a guard it cannot prove for one."""
        if isinstance(self.model, CAMPPlus):
            return 2 * SEG_LEN + 1
        return 10

    def export(self, save_model_path="models/",
               resume_model="models/CAMPPlus_Fbank/best_model/",
               export_batch=None, export_seconds=3):
        """Save the backbone-only inference bundle (JAX
        ``trainer.py:951-1049``) in
        ``<save_model_path>/<model>_<feature_method>/infer/``:

        - ``model.pt``: the backbone ``state_dict``
          (``Predictor(model_path=...)`` loads it);
        - ``inference.json``: the JAX bundle's keys;
        - ``model.pt2``: ``torch.export`` of the wav -> features ->
          embedding forward in eval mode on the trainer's device, over the
          plain front end (``torch.export.load(path).module()`` runs it).

        ``export_batch=None`` makes the batch symbolic. ``export_seconds=
        None`` makes the length symbolic too: ``shift*f + (len - shift)``
        samples for Fbank (``160*f + 240`` at 16 kHz: exactly ``f`` kaldi
        frames), ``hop*f`` for the centred-STFT methods (the featurizer's
        hop), with ``f >= 10``
        as in JAX but ``f >= 201`` (2.0 s) for CAM++
        (``_export_min_frames``).
        ``resume_model=None`` exports the weights the trainer holds.
        Unlike JAX, which logs "StableHLO export skipped", a failing
        export raises."""
        self.audio_featurizer = AudioFeaturizer(
            feature_method=self.configs.preprocess_conf.feature_method,
            method_args=self.configs.preprocess_conf.get("method_args", {}))
        if self.model is None:
            self._setup_model(self.audio_featurizer.feature_dim)
        if resume_model is not None:
            load_pretrained({"model": self.model}, resume_model)
        infer_dir = os.path.join(
            save_model_path,
            f"{self.configs.model_conf.model}_"
            f"{self.configs.preprocess_conf.feature_method}", "infer")
        os.makedirs(infer_dir, exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in
                    self.model.state_dict().items()},
                   os.path.join(infer_dir, "model.pt"))
        with open(os.path.join(infer_dir, "inference.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"model": self.configs.model_conf.model,
                       "feature_method":
                           self.configs.preprocess_conf.feature_method,
                       "export_batch": export_batch,
                       "export_seconds": export_seconds}, f, indent=2)

        featurize, model = self._export_featurize(), self.model

        class Forward(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.model = model

            def forward(self, waves):
                return self.model(featurize(waves))

        sr = self.configs.dataset_conf.get("dataset", {}).get(
            "sample_rate", 16000)
        ma = dict(self.configs.preprocess_conf.get("method_args", {}))
        if self.configs.preprocess_conf.feature_method == "Fbank":
            step = int(sr * float(ma.get("frame_shift", 10.0)) / 1000)
            rest = int(sr * float(ma.get("frame_length", 25.0)) / 1000) - step
        else:
            # centred-STFT methods: f + 1 frames at a hop-aligned length
            # (the featurizer's hop, win_length // 4 when unset; JAX takes
            # 160 when unset, which the default hop of 128 does not divide)
            step = int(ma.get("hop_length")
                       or (ma.get("win_length") or ma.get("n_fft", 512)) // 4)
            rest = 0
        dim, shape = torch.export.Dim, {}
        if export_batch is None:
            shape[0] = dim("b", min=1, max=4096)
        if export_seconds is None:
            shape[1] = step * dim("f", min=self._export_min_frames(),
                                  max=2 ** 20) + rest
            example_len = step * 300 + rest
        else:
            example_len = int(export_seconds * sr)
        batch = 2 if export_batch is None else int(export_batch)
        was_training = self.model.training
        self.model.eval()
        try:
            example = torch.zeros((batch, example_len), dtype=torch.float32,
                                  device=self.device)
            with torch.no_grad():
                program = torch.export.export(
                    Forward(), (example,),
                    dynamic_shapes={"waves": shape} if shape else None)
            torch.export.save(program, os.path.join(infer_dir, "model.pt2"))
        finally:
            self.model.train(was_training)
        logger.info(f"inference model saved: {infer_dir}")
        return infer_dir


# reference-compatible alias (``ppvector.trainer.PPVectorTrainer``)
PPVectorTrainer = Trainer
