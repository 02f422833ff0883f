"""Flax variables -> the port's ``state_dict``.

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

A paddle ``.pdparams`` file loads through the JAX package's pure-numpy
``tools/convert_paddle_checkpoint.convert_state`` followed by this
function (take ``["params"]["backbone"]`` / ``["batch_stats"]["backbone"]``
of its result). Write the result with ``torch.save`` for ``Predictor``.
"""

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["jax_to_torch_state"]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v, np.float32)


def jax_to_torch_state(variables):
    """``{"params": ..., "batch_stats": ...}`` (numpy leaves) -> an
    ordered ``state_dict`` of float32 tensors."""
    state = {}

    def put(mod, name, v):
        state[f"{mod}.{name}" if mod else name] = v

    for path, v in _leaves(variables["params"]):
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
            put(mod, "weight", v)
        elif leaf == "scale":
            put(mod, "weight", v)
        elif leaf in ("bias", "weight", "prelu_alpha"):
            put(mod, leaf, v)
        else:
            raise KeyError(f"unmapped flax parameter {'/'.join(path)}")
    for path, v in _leaves(variables.get("batch_stats", {})):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in ("mean", "var"):
            raise KeyError(f"unmapped flax statistic {'/'.join(path)}")
        put(mod, f"running_{leaf}", v)
        put(mod, "num_batches_tracked", np.zeros((), np.int64))
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in state.items()}
