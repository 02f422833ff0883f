"""Flax variables -> the port's ``state_dict``, and a JAX train state ->
the port's train state.

The port's module attribute names follow the flax tree, so the mapping is
a plain tree walk with these layout rules:

- conv1d kernel ``(K, Cin, Cout)``  -> weight ``(Cout, Cin, K)``
- conv2d kernel HWIO                -> weight OIHW
- Dense kernel ``(in, out)``        -> weight ``(out, in)``
- BN scale / bias / mean / var      -> weight / bias / running_mean /
  running_var (plus ``num_batches_tracked = 0``)
- the Cosine head's ``weight`` ``(in_dim, num_speakers * K)`` and a
  PReLU's ``prelu_alpha`` keep their name and layout

Any other leaf raises ``KeyError``.

``jax_to_torch_train_state`` carries a JAX ``TrainState`` (numpy leaves,
``jax.device_get``) into the port's train state (``utils/checkpoint.py``):
the backbone, ``params["classifier"]`` and ``loss_params`` with their
``batch_stats``, the Adam ``mu`` / ``nu`` / ``count`` of the optax chain as
the torch optimizer's ``exp_avg`` / ``exp_avg_sq`` / ``step``, and the
step. Each moment takes its parameter's transform: every transform is a
permutation, so the moments map exactly. A JAX run can then go on in the
port.

A paddle ``.pdparams`` file loads through ``convert_paddle``
(``load_pdparams``, then ``pdparams_to_torch_state``: the port's copy of
the JAX package's numpy converter followed by this function); ``python -m
voiceprintrecognition_paddlepaddle_torch.convert_paddle`` writes the
``model.pt`` that ``Predictor`` loads.
"""

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["jax_to_torch_state", "jax_to_torch_train_state"]


def _leaves(tree, prefix=(), dtype=np.float32):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),), dtype)
        else:
            yield prefix + (str(k),), np.asarray(v, dtype)


def _param_arrays(params, dtype=np.float32):
    """A flax ``params`` tree -> ``{torch name: array}``."""
    state = {}
    for path, v in _leaves(params, dtype=dtype):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            if v.ndim == 3:
                v = v.transpose(2, 1, 0)
            elif v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            elif v.ndim == 2:
                v = v.T
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf not in ("bias", "weight", "prelu_alpha", "sphereface2_bias"):
            raise KeyError(f"unmapped flax parameter {'/'.join(path)}")
        state[f"{mod}.{leaf}" if mod else leaf] = v
    return state


def _tensors(state):
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in state.items()}


def jax_to_torch_state(variables, dtype=np.float32):
    """``{"params": ..., "batch_stats": ...}`` (numpy leaves) -> an
    ordered ``state_dict`` of ``dtype`` (float32) tensors."""
    state = _param_arrays(variables["params"], dtype)
    for path, v in _leaves(variables.get("batch_stats", {}), dtype=dtype):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in ("mean", "var"):
            raise KeyError(f"unmapped flax statistic {'/'.join(path)}")
        state[f"{mod}.running_{leaf}"] = v
        state[f"{mod}.num_batches_tracked"] = np.zeros((), np.int64)
    return _tensors(state)


def _get(obj, key):
    return obj[key] if isinstance(obj, Mapping) else getattr(obj, key)


def _adam_states(tree):
    """Every node of an optax state with ``mu``, ``nu`` and ``count``."""
    if all(hasattr(tree, k) for k in ("mu", "nu", "count")):
        yield tree
    elif hasattr(tree, "inner_opt_state"):          # optax.MultiSteps
        if int(np.asarray(tree.mini_step)) != 0:
            raise ValueError("the JAX state is between the microbatches of "
                             "an accumulated update; convert it after one")
        yield from _adam_states(tree.inner_opt_state)
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _adam_states(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _adam_states(v)


def jax_to_torch_train_state(jax_state, optimizer, param_names,
                             dtype=np.float32):
    """A JAX ``TrainState`` (or a dict of its fields), numpy leaves ->
    the port's train state ``{"model", "classifier", "loss", "optimizer",
    "step"}``.

    ``optimizer`` is the port's optimizer and ``param_names`` the qualified
    name of each of its parameters in order (``model.*``, ``classifier.*``,
    ``loss.*``; ``Trainer.param_names``): the moments are written into a
    copy of its ``state_dict``. The optax chain must hold one Adam-family
    state (Adam, AdamW, AdamMax's ``mu`` / ``nu``)."""
    params = _get(jax_state, "params")
    stats = _get(jax_state, "batch_stats")
    out = {
        "model": jax_to_torch_state({"params": params["backbone"],
                                     "batch_stats": stats["backbone"]},
                                    dtype),
        "classifier": jax_to_torch_state({
            "params": params.get("classifier", {}),
            "batch_stats": stats.get("classifier", {})}, dtype),
        "loss": _tensors(_param_arrays(_get(jax_state, "loss_params") or {},
                                       dtype)),
        "step": int(np.asarray(_get(jax_state, "step"))),
    }
    adam = list(_adam_states(_get(jax_state, "opt_state")))
    if len(adam) != 1:
        raise ValueError(f"expected one Adam-family state in the optax "
                         f"chain, found {len(adam)}")
    adam = adam[0]
    moments = {}
    second = ("exp_inf" if isinstance(optimizer, torch.optim.Adamax)
              else "exp_avg_sq")
    for key, tree in (("exp_avg", adam.mu), (second, adam.nu)):
        p_tree, l_tree = tree
        named = {f"model.{k}": v for k, v in
                 _param_arrays(p_tree["backbone"], dtype).items()}
        named.update({f"classifier.{k}": v for k, v in
                      _param_arrays(p_tree.get("classifier", {}),
                                    dtype).items()})
        named.update({f"loss.{k}": v for k, v in
                      _param_arrays(l_tree or {}, dtype).items()})
        for name, v in _tensors(named).items():
            moments.setdefault(name, {})[key] = v
    if set(moments) != set(param_names):
        raise KeyError(f"optimizer parameters and JAX moments differ: "
                       f"{sorted(set(moments) ^ set(param_names))}")
    sd = optimizer.state_dict()
    count = float(np.asarray(adam.count))
    sd["state"] = {i: {"step": torch.tensor(count), **moments[name]}
                   for i, name in enumerate(param_names)}
    out["optimizer"] = sd
    return out
