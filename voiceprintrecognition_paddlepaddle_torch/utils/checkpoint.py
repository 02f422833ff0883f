"""Checkpoint save, resume and pretrained load (counterpart of the JAX
``utils/checkpoint.py``), with torch files.

Directory and JSON semantics of reference ``ppvector/utils/checkpoint.py``
and of the JAX package: ``<save>/<Model>_<Feature>/{epoch_N, last_model,
best_model}``, a ``model.state`` JSON (last_epoch, version, model,
feature_method, loss; eer / min_dcf / threshold after an evaluation;
margin), ``epoch_{N-3}`` pruning, the best-model copy when the EER
improves, the mid-epoch ``completed_epoch``, auto-resume from
``last_model`` with the best EER taken from the sibling ``best_model``, and
shape-filtered partial loading of pretrained weights with warnings.

A checkpoint directory holds:

- ``model.pt``: the backbone ``state_dict`` alone, so
  ``Predictor(model_path=<dir>)`` serves it as it is;
- ``classifier.pt``: ``{"classifier": state_dict, "loss": state_dict}``
  (the head and the loss's parameters, SphereFace2's bias);
- ``optimizer.pt``: ``{"optimizer": state_dict, "step": int}``, the
  optimizer's moments and update count and the trainer's step count.

The train state handed to ``save_checkpoint`` and returned by
``load_checkpoint`` is the dict of those five entries. The LR and margin
schedules are functions of the counts and need no replay.

``train_conf.checkpoint_format: orbax`` writes each of
the three files as a ``torch.distributed.checkpoint`` directory
(``model.dcp/``, ``classifier.dcp/``, ``optimizer.dcp/``) in place of the
JAX package's ``<name>.orbax/``: DCP is PyTorch's sharded checkpoint
format, as orbax is JAX's. Each directory is written under a temporary
name and then renamed. Under data parallelism the state is replicated, so
rank 0 writes it alone (``no_dist``), as JAX's orbax save runs on rank 0
(``utils/checkpoint.py:109-141``). Every reader (``load_checkpoint``,
``load_pretrained``, ``Predictor``) takes ``<name>.dcp/`` before
``<name>.pt``, as JAX takes ``.orbax/`` before ``.msgpack``.
"""

import json
import os
import queue
import shutil
import threading

import torch

from .. import __version__
from .logger import logger

__all__ = ["save_checkpoint", "load_checkpoint", "load_pretrained",
           "AsyncSaver", "checkpoint_dir", "TRAIN_FILES", "CHECKPOINT_FORMATS",
           "find_weights", "read_weights"]

# file -> the train-state entries it holds (model.pt: the bare backbone)
TRAIN_FILES = {"model.pt": None, "classifier.pt": ("classifier", "loss"),
               "optimizer.pt": ("optimizer", "step")}
# train_conf.checkpoint_format -> the suffix of each file's stem; "msgpack"
# (the JAX default) is the torch file, "orbax" the DCP directory
CHECKPOINT_FORMATS = {"torch": ".pt", "msgpack": ".pt", "orbax": ".dcp"}


def _save_dcp(obj, path):
    """Write ``obj`` (a state dict, nested dicts of tensors and values) as
    a DCP directory at ``path``: into a temporary sibling, then renamed
    over ``path``. One process writes it (``no_dist``)."""
    import torch.distributed.checkpoint as dcp

    tmp = f"{path}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    dcp.save(obj, storage_writer=dcp.FileSystemWriter(tmp), no_dist=True)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _load_dcp(path):
    """The whole state a DCP directory holds, on the CPU, with no template
    (DCP's own reader for a format conversion, as ``dcp_to_torch_save``
    reads). Integer keys come back as strings; ``_optimizer_keys`` turns an
    optimizer's state keys back."""
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.format_utils import \
        _EmptyStateDictLoadPlanner
    from torch.distributed.checkpoint.state_dict_loader import \
        _load_state_dict

    out = {}
    _load_state_dict(out, storage_reader=FileSystemReader(path),
                     planner=_EmptyStateDictLoadPlanner(), no_dist=True)
    return out


def _optimizer_keys(opt):
    """An optimizer state dict read from DCP with its per-parameter state
    under the integer keys ``torch.optim`` indexes it by."""
    opt = dict(opt)
    opt["state"] = {int(k): v for k, v in opt.get("state", {}).items()}
    return opt


def find_weights(directory, name="model"):
    """``<directory>/<name>.dcp`` when that directory exists, else
    ``<directory>/<name>.pt`` (which may not exist)."""
    dcp_dir = os.path.join(directory, name + ".dcp")
    return dcp_dir if os.path.isdir(dcp_dir) else os.path.join(
        directory, name + ".pt")


def read_weights(path):
    """A state saved by this module: a ``.pt`` file or a DCP directory."""
    if os.path.isdir(path):
        return _load_dcp(path)
    return torch.load(path, map_location="cpu", weights_only=True)


class AsyncSaver:
    """Ordered background writer for checkpoints (copied from the JAX
    package). The device-to-host snapshot happens on the caller's thread;
    serialization, disk writes, the ``last_model`` copy and the epoch
    pruning run on one worker thread in submission order. Errors surface
    on the next submit or wait."""

    def __init__(self):
        # bounded: each queued closure holds a host copy of the state
        self._q = queue.Queue(maxsize=2)
        self._err = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            fn = self._q.get()
            if fn is None:
                self._q.task_done()
                return
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - also raised on next call
                logger.error(f"async checkpoint write failed: {e!r}")
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(f"async checkpoint write failed: {err}") \
                from err

    def submit(self, fn):
        self._check()
        self._q.put(fn)

    def wait(self):
        """Block until all submitted writes are on disk."""
        self._q.join()
        self._check()

    def close(self):
        self._q.put(None)
        self._q.join()
        self._check()


def checkpoint_dir(configs, save_model_path, tag):
    name = (f"{configs.model_conf.model}_"
            f"{configs.preprocess_conf.feature_method}")
    return os.path.join(save_model_path, name, tag)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(configs, state, save_model_path, epoch_id, eer=None,
                    min_dcf=None, threshold=None, margin=None,
                    best_model=False, async_saver=None, completed_epoch=None):
    """``state``: the train-state dict (see the module docstring).

    The host snapshot is taken here; with ``async_saver`` the writes run
    in its thread. ``completed_epoch`` overrides the ``last_epoch``
    recorded in ``model.state``: a mid-epoch save passes ``epoch_id - 1``
    so that a resume replays the interrupted epoch. The format is
    ``train_conf.checkpoint_format`` (a key of ``CHECKPOINT_FORMATS``,
    by default ``"torch"``)."""
    tag = "best_model" if best_model else f"epoch_{epoch_id}"
    model_path = checkpoint_dir(configs, save_model_path, tag)
    fmt = configs.get("train_conf", {}).get("checkpoint_format", "torch")
    if fmt not in CHECKPOINT_FORMATS:
        raise ValueError(f"unknown checkpoint_format {fmt!r}; one of "
                         f"{sorted(CHECKPOINT_FORMATS)}")
    suffix = CHECKPOINT_FORMATS[fmt]
    snap = _to_cpu(state)
    data = {"last_epoch": int(epoch_id if completed_epoch is None
                              else completed_epoch),
            "version": __version__,
            "model": configs.model_conf.model,
            "feature_method": configs.preprocess_conf.feature_method,
            "loss": configs.loss_conf.get(
                "loss", configs.loss_conf.get("use_loss", "AAMLoss"))}
    if eer is not None:
        data.update(threshold=threshold, eer=eer, min_dcf=min_dcf)
    if margin is not None:
        data["margin"] = float(margin)

    def _write():
        if os.path.exists(model_path):
            shutil.rmtree(model_path)
        os.makedirs(model_path, exist_ok=True)
        for name, keys in TRAIN_FILES.items():
            obj = snap["model"] if keys is None else {k: snap[k] for k in keys}
            path = os.path.join(model_path, name[:-len(".pt")] + suffix)
            if suffix == ".dcp":
                _save_dcp(obj, path)
            else:
                torch.save(obj, path)
        with open(os.path.join(model_path, "model.state"), "w",
                  encoding="utf-8") as f:
            json.dump(data, f, indent=4, ensure_ascii=False)
        if not best_model:
            last_path = checkpoint_dir(configs, save_model_path, "last_model")
            shutil.rmtree(last_path, ignore_errors=True)
            shutil.copytree(model_path, last_path)
            old = checkpoint_dir(configs, save_model_path,
                                 f"epoch_{epoch_id - 3}")
            if os.path.exists(old):
                shutil.rmtree(old)
        logger.info(f"checkpoint saved: {model_path}")

    if async_saver is not None:
        async_saver.submit(_write)
    else:
        _write()
    return model_path


def _read_state(model_path):
    state = {}
    for name, keys in TRAIN_FILES.items():
        obj = read_weights(find_weights(model_path, name[:-len(".pt")]))
        if keys is None:
            state["model"] = obj
        else:
            # DCP keeps no empty dict: a loss without parameters has none
            state.update({k: obj.get(k, {}) for k in keys})
    state["optimizer"] = _optimizer_keys(state["optimizer"])
    state["step"] = int(state["step"])
    return state


def load_checkpoint(configs, apply_state, save_model_path, resume_model=None):
    """Auto-resume from ``last_model`` (or the directory ``resume_model``):
    reads the train state and hands it to ``apply_state(state)``. Returns
    ``(step or None, last_epoch, best_eer)``; None when nothing was
    loaded. A failed auto-resume logs a warning and starts afresh; a
    failed explicit ``resume_model`` raises."""
    last_epoch, best_eer = 0, 1.0
    model_path = resume_model or checkpoint_dir(configs, save_model_path,
                                                "last_model")
    if not all(os.path.exists(find_weights(model_path, n[:-len(".pt")]))
               for n in TRAIN_FILES):
        if resume_model is not None:
            raise FileNotFoundError(f"checkpoint not found: {model_path}")
        return None, last_epoch, best_eer
    try:
        state = _read_state(model_path)
        apply_state(state)
        state_file = os.path.join(model_path, "model.state")
        if os.path.exists(state_file):
            with open(state_file, "r", encoding="utf-8") as f:
                j = json.load(f)
            last_epoch = j.get("last_epoch", 0)
            if j.get("eer") is not None:  # 0.0 is a valid (perfect) EER
                best_eer = j["eer"]
        # best-model tracking restores the *best* EER seen, not the last
        # epoch's: the sibling best_model's recorded state
        best_state = os.path.join(os.path.dirname(os.path.normpath(model_path)),
                                  "best_model", "model.state")
        if os.path.exists(best_state):
            with open(best_state, "r", encoding="utf-8") as f:
                bj = json.load(f)
            if bj.get("eer") is not None:
                best_eer = min(best_eer, bj["eer"])
        logger.info(f"resumed model + optimizer state: {model_path}")
        return int(state["step"]), last_epoch, best_eer
    except Exception as e:
        if resume_model is not None:
            raise
        logger.warning(f"auto-resume from latest model failed: {e}")
        return None, 0, 1.0


def _merge(module, loaded, what):
    """Copy the entries of ``loaded`` whose name and shape match into
    ``module``'s state; warn for the others. Returns the count."""
    own = module.state_dict()
    merged = 0
    for key, value in own.items():
        if key not in loaded:
            logger.warning(f"Lack weight: {what}.{key}")
            continue
        lv = loaded[key]
        if tuple(lv.shape) != tuple(value.shape):
            logger.warning(f"{what}.{key} not used, shape {list(lv.shape)} "
                           f"unmatched with {list(value.shape)} in model.")
            continue
        with torch.no_grad():
            value.copy_(lv.to(value.dtype))
        merged += 1
    return merged


def load_pretrained(modules, pretrained_model):
    """Shape-filtered partial load (reference ``checkpoint.py``
    load_pretrained): ``modules`` maps "model" / "classifier" / "loss" to
    modules; ``pretrained_model`` is a checkpoint directory (its
    ``model.dcp/`` or ``model.pt``, and ``classifier.dcp/`` or
    ``classifier.pt`` when there is one), a ``model.pt`` file or a DCP
    directory. Missing or shape-mismatched tensors are skipped with a
    warning. Returns the number of tensors loaded."""
    if pretrained_model is None:
        return 0
    directory = None
    if (os.path.isdir(pretrained_model) and not os.path.exists(
            os.path.join(pretrained_model, ".metadata"))):
        directory = pretrained_model
        pretrained_model = find_weights(directory)
    assert os.path.exists(pretrained_model), \
        f"{pretrained_model} does not exist!"
    loaded = {"model": read_weights(pretrained_model)}
    head = directory and find_weights(directory, "classifier")
    if head and os.path.exists(head):
        loaded.update(read_weights(head))
    merged = 0
    for name, module in modules.items():
        if module is not None and name in loaded:
            merged += _merge(module, loaded[name], name)
    logger.info(f"loaded pretrained model ({merged} tensors): "
                f"{pretrained_model}")
    return merged
