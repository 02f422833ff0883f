"""PyTorch port, the seven losses (``loss/losses.py``) against the JAX
package's: the value and the gradient with respect to the logits (and the
features for the triplet loss, and SphereFace2's learnable bias) against
``jax.grad``, at margins 0, 0.2 and 0.3, on seeded logits that include
values near +-1 and near the AAM branch point ``cos(pi - m)``.

Bar: rtol 1e-5 on the value; each gradient within rtol 1e-5 with an
absolute floor of 1e-5 x its largest entry (softmax gradients of the
non-target classes sit at 1e-10 at scale 32, where float32 rounding is
relative to the larger entries of the same sum).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voiceprintrecognition_paddlepaddle_torch import loss as tloss
from voiceprintrecognition_paddlepaddle_tpu import loss as jloss

B, C, K = 8, 12, 3

CASES = {
    "AAMLoss": dict(scale=32),
    "AAMLoss-easy": dict(scale=32, easy_margin=True, label_smoothing=0.1),
    "AMLoss": dict(scale=30),
    "ARMLoss": dict(scale=30),
    "CELoss": dict(label_smoothing=0.1),
    "SphereFace2": dict(scale=32.0, lanbuda=0.7, t=3),
    "SphereFace2-A": dict(scale=32.0, margin_type="A"),
    "SubCenterLoss": dict(scale=32, K=K),
    "TripletAngularMarginLoss": dict(),
}


def _inputs(name, margin, seed=0):
    rng = np.random.RandomState(seed)
    width = C * K if name.startswith("SubCenter") else C
    logits = rng.uniform(-0.9, 0.9, (B, width))
    # the clip and the branch: near +-1, and either side of cos(pi - m)
    # at m = 0 the branch point is -1 itself: stay inside the clip
    th = math.cos(math.pi - margin) if margin else -0.99
    logits[0, :4] = [0.9999, -0.9999, 0.99999, -0.99999]
    logits[1, :4] = [th + 1e-3, th - 1e-3, th + 1e-4, th - 1e-4]
    labels = np.asarray([0, 1, 2, 3, 0, 1, 2, 3])
    logits[2, 2] = 0.99995                      # a target near the clip
    logits[3, 3] = th + 2e-3                    # a target near the branch
    features = rng.randn(B, 16)
    return (logits.astype(np.float32), labels.astype(np.int64),
            features.astype(np.float32), np.float32(rng.uniform(-1, 1)))


def _jax(name, margin, logits, labels, features, bias):
    base = name.split("-")[0]
    loss = jloss.LOSSES[base](**CASES[name])

    def f(lg, ft, b):
        params = ({"sphereface2_bias": b} if base == "SphereFace2" else None)
        return loss({"logits": lg, "features": ft}, jnp.asarray(labels),
                    margin=margin, params=params)

    val, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(logits), jnp.asarray(features), jnp.asarray(bias))
    return float(val), [np.asarray(g) for g in grads]


def _torch(name, margin, logits, labels, features, bias):
    base = name.split("-")[0]
    loss = tloss.LOSSES[base](**CASES[name])
    lg = torch.tensor(logits, requires_grad=True)
    ft = torch.tensor(features, requires_grad=True)
    if base == "SphereFace2":
        with torch.no_grad():
            loss.sphereface2_bias.fill_(float(bias))
    val = loss({"logits": lg, "features": ft}, torch.from_numpy(labels),
               margin=margin)
    val.backward()
    bias_grad = (loss.sphereface2_bias.grad.numpy() if base == "SphereFace2"
                 else np.zeros((), np.float32))
    ft_grad = (ft.grad.numpy() if ft.grad is not None
               else np.zeros_like(features))
    return float(val.detach()), [lg.grad.numpy(), ft_grad, bias_grad]


def _close(ref, got, what):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    atol = 1e-5 * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol, err_msg=what)


@pytest.mark.parametrize("margin", [0.0, 0.2, 0.3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_gradients_match_jax(name, margin):
    args = _inputs(name, margin)
    ref_val, ref_grads = _jax(name, margin, *args)
    val, grads = _torch(name, margin, *args)
    assert np.isfinite(val)
    np.testing.assert_allclose(val, ref_val, rtol=1e-5)
    for what, r, g in zip(("logits", "features", "bias"), ref_grads, grads):
        assert np.isfinite(g).all(), what
        _close(r, g, what)


def test_update_sets_the_margin_used_when_none_is_given():
    args = _inputs("AAMLoss", 0.3)
    loss = tloss.AAMLoss(margin=0.2)
    loss.update(0.3)
    lg = torch.tensor(args[0])
    got = loss({"logits": lg}, torch.from_numpy(args[1]))
    ref = tloss.AAMLoss(margin=0.0)({"logits": lg},
                                    torch.from_numpy(args[1]), margin=0.3)
    assert float(got) == float(ref)


def test_sphereface2_bias_is_a_parameter_and_ce_ignores_update():
    assert [n for n, _ in tloss.SphereFace2().named_parameters()] == [
        "sphereface2_bias"]
    ce = tloss.CELoss()
    ce.update(0.3)
    assert ce.margin == 0.0
    with pytest.raises(ValueError, match="unknown loss"):
        from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
            dict_to_object
        tloss.build_loss(dict_to_object({"loss_conf": {"loss": "Nope"}}))
