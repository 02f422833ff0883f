"""Seeded random weights, made on the device in a few large calls.

Every float tensor of a state dict is cut from one normal and one uniform
draw of a ``torch.Generator`` on the device: conv and linear weights
N(0, 1 / fan_in), biases N(0, 0.1^2), BatchNorm scales U(0.5, 1.5), shifts
and running means N(0, 0.2^2), running variances U(0.5, 1.5), so that no
BatchNorm folds to an identity. The names and shapes come from the plain
reference, whose keys are the port's."""

import torch

from . import core


def reference_model(config):
    """The plain reference model of ``config`` (a configuration file's
    dict), from the module its ``reference`` key names."""
    conf = config["run"]["model_conf"]
    return core.reference(config).Model(80, **conf.get("model_args", {}))


def _is_bn(name):
    return ".BatchNorm_" in name or name.startswith("BatchNorm_")


def seeded_state(shapes, seed, device):
    """``{name: shape}`` -> ``{name: fp32 tensor on device}``."""
    names = sorted(shapes)
    sizes = [int(torch.Size(shapes[n]).numel()) for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, size in zip(names, sizes):
        shape = shapes[name]
        n, u = normal[off:off + size], uniform[off:off + size]
        off += size
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        if _is_bn(name) and leaf in ("weight", "running_var"):
            t = 0.5 + u
        elif _is_bn(name):
            t = 0.2 * n
        elif leaf == "weight" and len(shape) > 1:
            fan_in = size // shape[0]
            t = n / fan_in ** 0.5
        else:
            t = 0.1 * n
        out[name] = t.reshape(shape).clone()
    return out


def model_state(config, seed, device):
    ref = reference_model(config)
    shapes = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    return seeded_state(shapes, seed, device)
