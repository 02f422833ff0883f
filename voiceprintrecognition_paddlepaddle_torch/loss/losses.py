"""The seven margin-softmax and metric-learning objectives (counterpart of
the JAX ``loss/losses.py``; reference ``ppvector/loss/*.py``).

Each loss is an ``nn.Module`` called as ``loss(outputs, labels,
margin=None)`` on the classifier's ``{"features", "logits"}``:

- ``margin`` is the scheduled margin of this step (a float); None takes
  the loss's own, which ``update(margin)`` sets (the ``MarginScheduler``
  protocol);
- SphereFace2's learnable bias is the parameter ``sphereface2_bias``, so
  the optimizer updates it with the model (JAX ``loss_params``);
- the triplet loss mines hard pairs with masked min / max (``amin`` /
  ``amax`` split the gradient between ties, as ``jnp.min`` / ``jnp.max``
  do).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["AAMLoss", "AMLoss", "ARMLoss", "CELoss", "SphereFace2",
           "SubCenterLoss", "TripletAngularMarginLoss"]


def _wide(x):
    """At least float32: bf16 outputs under autocast widen, float64 stays."""
    return x if x.dtype == torch.float64 else x.float()


def _ce(logits, labels, label_smoothing=0.0):
    """Mean cross-entropy with label smoothing (optax
    ``softmax_cross_entropy`` of ``smooth_labels``)."""
    return F.cross_entropy(_wide(logits), labels,
                           label_smoothing=label_smoothing)


def _one_hot(labels, n, dtype):
    return F.one_hot(labels, n).to(dtype)


class _Loss(nn.Module):
    """Margin bookkeeping."""

    def __init__(self, margin=0.2):
        super().__init__()
        self.margin = margin

    def update(self, margin=0.2):
        """The reference's per-step margin update (``loss/aamloss.py``)."""
        self.margin = margin

    def _m(self, margin):
        return float(self.margin if margin is None else margin)


def _additive_angular(cosine, m, easy_margin):
    """``cos(theta + m)``, with the reference's fallback past theta =
    pi - m (or theta = pi/2 with ``easy_margin``)."""
    sine = torch.sqrt(torch.clamp(1.0 - cosine ** 2, min=0.0))
    phi = cosine * math.cos(m) - sine * math.sin(m)
    if easy_margin:
        return torch.where(cosine > 0, phi, cosine)
    th = math.cos(math.pi - m)
    return torch.where(cosine > th, phi, cosine - (1.0 + th))


class AAMLoss(_Loss):
    """Additive angular margin (ArcFace) on cosine logits
    (reference ``loss/aamloss.py``)."""

    def __init__(self, margin=0.2, scale=32, easy_margin=False,
                 label_smoothing=0.0):
        super().__init__(margin)
        self.scale = scale
        self.easy_margin = easy_margin
        self.label_smoothing = label_smoothing

    def forward(self, outputs, labels, margin=None):
        logits = _wide(outputs["logits"])
        phi = _additive_angular(logits, self._m(margin), self.easy_margin)
        one_hot = _one_hot(labels, logits.shape[-1], logits.dtype)
        output = (one_hot * phi + (1.0 - one_hot) * logits) * self.scale
        return _ce(output, labels, self.label_smoothing)


class AMLoss(_Loss):
    """Additive (cosine) margin, CosFace (reference ``loss/amloss.py``)."""

    def __init__(self, margin=0.2, scale=30, label_smoothing=0.0):
        super().__init__(margin)
        self.scale = scale
        self.label_smoothing = label_smoothing

    def forward(self, outputs, labels, margin=None):
        logits = _wide(outputs["logits"])
        one_hot = _one_hot(labels, logits.shape[-1], logits.dtype)
        output = self.scale * (logits - self._m(margin) * one_hot)
        return _ce(output, labels, self.label_smoothing)


class ARMLoss(_Loss):
    """Additive-reduction margin: subtract the target logit, clamp
    negatives to zero (reference ``loss/armloss.py``)."""

    def __init__(self, margin=0.2, scale=30, label_smoothing=0.0):
        super().__init__(margin)
        self.scale = scale
        self.label_smoothing = label_smoothing

    def forward(self, outputs, labels, margin=None):
        logits = _wide(outputs["logits"])
        one_hot = _one_hot(labels, logits.shape[-1], logits.dtype)
        costh_m_s = self.scale * (logits - self._m(margin) * one_hot)
        target = torch.sum(costh_m_s * one_hot, dim=-1, keepdim=True)
        output = torch.where(costh_m_s - target < 0.0, 0.0, costh_m_s)
        return _ce(output, labels, self.label_smoothing)


class CELoss(_Loss):
    """Plain cross entropy (reference ``loss/celoss.py``)."""

    def __init__(self, label_smoothing=0.0):
        super().__init__(0.0)
        self.label_smoothing = label_smoothing

    def forward(self, outputs, labels, margin=None):
        return _ce(outputs["logits"], labels, self.label_smoothing)

    def update(self, margin=0.2):
        pass


class SphereFace2(_Loss):
    """Binary-classification margin loss (reference ``loss/sphereface2.py``):
    the warped cosine g(z) = 2((z+1)/2)^t - 1, lambda-weighted positive and
    negative softplus terms and a learnable bias."""

    def __init__(self, margin=0.2, scale=32.0, lanbuda=0.7, t=3,
                 margin_type="C"):
        super().__init__(margin)
        self.scale = scale
        self.lanbuda = lanbuda
        self.t = t
        self.margin_type = margin_type
        self.sphereface2_bias = nn.Parameter(torch.zeros(()))

    def _fun_g(self, z):
        return 2.0 * ((z + 1.0) / 2.0) ** self.t - 1.0

    def forward(self, outputs, labels, margin=None):
        logits = _wide(outputs["logits"])
        bias = self.sphereface2_bias
        m = self._m(margin)
        if self.margin_type == "A":
            sin = torch.sqrt(torch.clamp(1.0 - logits ** 2, min=0.0))
            phi_p = _additive_angular(logits, m, easy_margin=False)
            phi_n = logits * math.cos(m) + sin * math.sin(m)
            z_p = self.scale * self._fun_g(phi_p) + bias
            z_n = self.scale * self._fun_g(phi_n) + bias
        else:  # cosface type 'C'
            z_p = self.scale * (self._fun_g(logits) - m) + bias
            z_n = self.scale * (self._fun_g(logits) + m) + bias
        # log(1 + exp(+-z)), exactly (jax.nn.softplus)
        zero = torch.zeros_like(z_p)
        cos_p = self.lanbuda * torch.logaddexp(-z_p, zero)
        cos_n = (1.0 - self.lanbuda) * torch.logaddexp(z_n, zero)
        target = _one_hot(labels, logits.shape[-1], logits.dtype)
        return (target * cos_p + (1.0 - target) * cos_n).sum(dim=1).mean()


class SubCenterLoss(_Loss):
    """Sub-center ArcFace: the max over K sub-centers, then the AAM margin
    (reference ``loss/subcenterloss.py``; the classifier's K matches)."""

    def __init__(self, margin=0.2, scale=32, easy_margin=False, K=3,
                 label_smoothing=0.0):
        super().__init__(margin)
        self.scale = scale
        self.K = K
        self.easy_margin = easy_margin
        self.label_smoothing = label_smoothing

    def forward(self, outputs, labels, margin=None):
        logits = _wide(outputs["logits"])
        cosine = torch.amax(logits.reshape(logits.shape[0], -1, self.K), dim=2)
        phi = _additive_angular(cosine, self._m(margin), self.easy_margin)
        one_hot = _one_hot(labels, cosine.shape[-1], cosine.dtype)
        output = (one_hot * phi + (1.0 - one_hot) * cosine) * self.scale
        return _ce(output, labels, self.label_smoothing)


class TripletAngularMarginLoss(_Loss):
    """Cross entropy plus a margin ranking on cosine similarity with
    in-batch hard positive / negative mining and absolute thresholds
    (reference ``loss/tripletangularmarginloss.py``; needs P x K batches).
    Sub-threshold negative hinges count as ones, as in the reference."""

    def __init__(self, margin=0.5, normalize_feature=True, add_absolute=True,
                 absolute_loss_weight=1.0, ap_value=0.8, an_value=0.4,
                 label_smoothing=0.0):
        super().__init__(margin)
        self.normalize_feature = normalize_feature
        self.add_absolute = add_absolute
        self.absolute_loss_weight = absolute_loss_weight
        self.ap_value = ap_value
        self.an_value = an_value
        self.label_smoothing = label_smoothing

    def forward(self, outputs, labels, margin=None):
        features = _wide(outputs["features"])
        loss_ce = _ce(outputs["logits"], labels, self.label_smoothing)
        if self.normalize_feature:
            features = features / torch.clamp(
                torch.linalg.norm(features, dim=-1, keepdim=True), min=1e-12)
        dist = features @ features.T
        same = labels[:, None] == labels[None, :]
        inf = torch.tensor(float("inf"), device=dist.device)
        dist_ap = torch.amin(torch.where(same, dist, inf), dim=1)
        dist_an = torch.amax(torch.where(same, -inf, dist), dim=1)
        # MarginRankingLoss(dist_ap, dist_an, y=1): max(0, m - (ap - an))
        loss = torch.clamp(self._m(margin) + dist_an - dist_ap, min=0.0).mean()
        if self.add_absolute:
            abs_ap = torch.clamp(self.ap_value - dist_ap, min=0.0)
            abs_an = torch.where(dist_an - self.an_value > 0,
                                 dist_an - self.an_value, 1.0)
            loss = ((abs_an.mean() + abs_ap.mean())
                    * self.absolute_loss_weight + loss)
        return loss + loss_ce
