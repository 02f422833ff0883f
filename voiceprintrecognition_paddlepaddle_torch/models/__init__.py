"""Model factory (counterpart of the JAX ``models/__init__.py``).

This slice ports CAM++ only; the other backbones are queued in
ROADMAP.md."""

from .campplus import CAMPPlus

__all__ = ["build_model", "CAMPPlus"]


def build_model(input_size, configs):
    """Instantiate the backbone named by ``configs.model_conf.model``."""
    use_model = configs.model_conf.get("model", "CAMPPlus")
    if use_model != "CAMPPlus":
        raise NotImplementedError(
            f"backbone {use_model!r} is not ported yet (CAMPPlus only); see "
            "ROADMAP.md queue 1")
    return CAMPPlus(input_size=input_size,
                    **dict(configs.model_conf.get("model_args") or {}))
