"""PyTorch port, the train step (``Trainer.train_step``) against the JAX
package's train step on a tiny CAM++ (all 52 layers, 32 channels) and a
tiny ECAPA-TDNN with the Cosine head and the AAM loss: the same seeded
weights (the values of ``jax.eval_shape`` trees, no flax ``init``) and the
same int16 batch with one clip shorter than the crop.

The JAX side is the body of the JAX ``Trainer``'s jitted step
(``trainer.py:351-411``: int16 -> float, ``DeviceAugmenter`` with no
augment configured, the featurizer, the backbone in train mode with
``lengths``, the head, the loss, the optax chain of ``build_optimizer``),
with the gradients returned; it compiles once per backbone per file.

The step runs from the JAX front end's features, the train path of
``.npy`` feature lists (``kind="features"``), so both networks see the
same input; ``test_waveform_step_matches_jax`` holds the waveform path
(int16, dB normalization, the port's fbank) on its own.

Both sides run in float64 (``jax.enable_x64``; the port's modules
``.double()``, the trainer unchanged): in float32 the two frameworks'
rounding, amplified by the AAM scale of 32 through 52 layers, moves CAM++
gradient leaves by about 1e-2 of their norm (as the slow
``tests/test_train_dynamics_parity.py`` measures), which would hide a
real fault behind a 1e-2 bar; float64 holds the step's semantics to the
bars below. ``test_waveform_step_matches_jax`` runs the float32 path.

Checks, at step 0: the loss (rel 1e-5); every gradient leaf, mapped
through ``models/convert.py``, within 1e-4 of its norm (or of 1e-3 of
the largest leaf's norm, for the leaves whose gradient is zero up to
rounding: a bias ahead of a BatchNorm or of the attentive pooling's
softmax over time); the BN running
statistics (within 1e-5 of each leaf's scale: the step that shows the
flax momentum and biased variance of ``layers.BatchNorm``); the
parameters after the update. Then a JAX ``TrainState`` after two steps,
carried into the port by ``convert.jax_to_torch_train_state``, gives the
same third step. ``test_dense_bn_running_variance_is_flax_s`` pins the
BatchNorm alone: ``DenseBN_0`` of CAM++ at batch 4, running variance
within 1e-6 relative of flax ``nn.BatchNorm``.

The JAX Cosine head rounds the embedding to float32 even under x64
(``models/fc.py:39``), so the gradients agree to about 1e-7 of each
leaf's norm, not to float64 rounding. Adam's first step,
``g / (|g| + 1e-8)``, turns that into a large change of the update for
the entries whose gradient is near 1e-8; the parameters after an update
are therefore held within 1e-5 of each leaf's scale on every entry whose
JAX gradient is above 1e-5 of the leaf's largest, and the other entries
must be under 10 % of all (3.5 % in the tiny CAM++, 0 in ECAPA-TDNN).

The crops are 1 s: at 0.5 s (a 0.3 s clip among them) the tiny CAM++
reaches a trunk channel with zero variance over the short clip's valid
frames after one update, where ``sqrt(max(var, 0))`` of the statistics
pooling has an infinite derivative, and JAX and the port both give NaN
gradients from the second step (ROADMAP.md, queue 3).
"""

import flax
import jax
from jax import enable_x64
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_helpers import (NARROW, seeded_variables, speaker_corpus,
                                train_configs)
from voiceprintrecognition_paddlepaddle_torch.models.convert import (
    jax_to_torch_state, jax_to_torch_train_state)
from voiceprintrecognition_paddlepaddle_torch.models.layers import DenseBN
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
    dict_to_object
from voiceprintrecognition_paddlepaddle_tpu.loss import build_loss
from voiceprintrecognition_paddlepaddle_tpu.models import MODELS
from voiceprintrecognition_paddlepaddle_tpu.models.fc import \
    SpeakerIdentification
from voiceprintrecognition_paddlepaddle_tpu.models.layers import \
    DenseBN as JaxDenseBN
from voiceprintrecognition_paddlepaddle_tpu.ops.augment import \
    DeviceAugmenter
from voiceprintrecognition_paddlepaddle_tpu.ops.features import \
    AudioFeaturizer
from voiceprintrecognition_paddlepaddle_tpu.optimizer import (
    build_lr_scheduler, build_optimizer)

SPK, B, L = 6, 4, 16000           # 6 speakers, b4 x 1 s crops
CASES = {"CAMPPlus": (dict(embd_dim=32, init_channels=32), 80),
         "EcapaTdnn": (NARROW["EcapaTdnn"], 40)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this file: the suite runs six workers on the
    host's cores, and torch's default pool of one thread per core in each
    worker oversubscribes them (this file took 470 s in a six-worker run,
    about 60 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(lists, name):
    args, n_mels = CASES[name]
    cfg = train_configs(lists, model=name, model_args=dict(args),
                        n_mels=n_mels, num_speakers=SPK, batch_size=B,
                        max_epoch=4)
    cfg["dataset_conf"]["dataset"]["max_duration"] = L / 16000
    cfg["loss_conf"]["use_margin_scheduler"] = False
    cfg["optimizer_conf"]["scheduler_args"] = {
        "learning_rate": 1e-3, "min_lr": 1e-5, "warmup_epoch": 0}
    return cfg


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(L) / 16000
    waves = np.stack([0.3 * np.sin(2 * np.pi * (110 + 70 * i) * t
                                   + rng.rand()) + 0.05 * rng.randn(L)
                      for i in range(B)])
    ratio = np.asarray([1.0, 1.0, 0.6, 1.0], np.float32)   # one short clip
    waves[2, int(0.6 * L):] = 0.0
    waves = (np.clip(waves, -1, 1) * 32767).astype(np.int16)
    labels = np.asarray([0, 3, 1, 5], np.int64)
    return waves, ratio, labels


def _jax_front(cfg):
    """The JAX step's front end: int16 -> float, ``DeviceAugmenter`` with
    no augment configured (the dB normalization), the featurizer."""
    feat = AudioFeaturizer(cfg.preprocess_conf.feature_method,
                           cfg.preprocess_conf.method_args)
    augmenter = DeviceAugmenter({}, 16000, L / 16000, target_db=-20)

    @jax.jit
    def front(waves, ratio):
        key = jax.random.PRNGKey(0)
        w = augmenter(waves.astype(jnp.float32) / 32768.0, key,
                      valid_ratio=ratio)
        return augmenter.augment_features(
            feat.featurize(w, input_lens_ratio=ratio), key)

    return front


def _jax_step(cfg, jmodel, jcls, steps_per_epoch):
    """The JAX Trainer's step body from features on, returning the
    gradients too."""
    criterion = build_loss(cfg)
    tx = build_optimizer(build_lr_scheduler(steps_per_epoch, cfg), cfg)

    @jax.jit
    def step(params, stats, opt_state, feats, ratio, labels):
        def loss_fn(p):
            emb, mb = jmodel.apply(
                {"params": p["backbone"], "batch_stats": stats["backbone"]},
                feats, train=True, lengths=ratio, mutable=["batch_stats"])
            out, mc = jcls.apply(
                {"params": p["classifier"],
                 "batch_stats": stats["classifier"]},
                emb, train=True, mutable=["batch_stats"])
            new_stats = {"backbone": mb["batch_stats"],
                         "classifier": mc.get("batch_stats", {})}
            return criterion(out, labels, margin=0.2), new_stats

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, new_opt = tx.update((grads, {}), opt_state, (params, {}))
        new_params, _ = optax.apply_updates((params, {}), updates)
        return loss, grads, new_stats, new_params, new_opt

    return step, tx


@pytest.fixture(scope="module", params=sorted(CASES))
def setup(request, tmp_path_factory):
    name = request.param
    args, n_mels = CASES[name]
    root = tmp_path_factory.mktemp(name)
    lists = speaker_corpus(root, n_speakers=SPK, n_utts=2)
    cfg = _configs(lists, name)
    jmodel = MODELS[name](input_size=n_mels, **args)
    jcls = SpeakerIdentification(num_speakers=SPK)
    rng = np.random.RandomState(7)
    shapes = flax.core.unfreeze(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        np.zeros((1, 51, n_mels), np.float32)))
    v = jax.tree.map(lambda a: a.astype(np.float64),
                     seeded_variables(shapes, rng))
    emb_dim = args["embd_dim"]
    cls_w = rng.randn(emb_dim, SPK) / np.sqrt(emb_dim)
    params = {"backbone": v["params"], "classifier": {"weight": cls_w}}
    stats = {"backbone": v["batch_stats"], "classifier": {}}

    tr = Trainer(cfg, device="cpu")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
    tr.model.double()
    tr.classifier.double()
    step, tx = _jax_step(dict_to_object(cfg), jmodel, jcls,
                         len(tr.train_loader))
    return dict(name=name, cfg=cfg, trainer=tr, step=step, tx=tx,
                front=_jax_front(dict_to_object(cfg)), params=params,
                stats=stats)


def _load_port(tr, params, stats):
    tr.model.load_state_dict(jax_to_torch_state(
        {"params": params["backbone"], "batch_stats": stats["backbone"]},
        dtype=np.float64))
    tr.classifier.load_state_dict(jax_to_torch_state(
        {"params": params["classifier"]}, dtype=np.float64))


def _port_step(tr, feats, ratio, labels, kind="features"):
    """``Trainer.train_step`` with the gradients caught just before the
    optimizer's update."""
    grads = {}

    def catch(opt, args, kwargs):
        for n, p in zip(tr.param_names, opt.param_groups[0]["params"]):
            grads[n] = p.grad.detach().clone()

    hook = tr.optimizer.register_step_pre_hook(catch)
    try:
        tr.model.train()
        tr.classifier.train()
        loss, acc = tr.train_step(kind, torch.from_numpy(np.asarray(feats)),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(ratio))
    finally:
        hook.remove()
    return float(loss), float(acc), grads


def _named(tree, prefix):
    return {f"{prefix}.{k}": v.numpy() for k, v in jax_to_torch_state(
        {"params": tree}, dtype=np.float64).items()}


def _check_params(tr, new_params, grads_j, what):
    """Updated parameters within 1e-5 of each leaf's scale where the JAX
    gradient is above 1e-5 of the leaf's largest; those entries are over
    90 % of all. Returns the worst relative difference."""
    got = dict(zip(tr.param_names, (p.detach().numpy() for p in
                                    tr.optimizer.param_groups[0]["params"])))
    ref = {**_named(new_params["backbone"], "model"),
           **_named(new_params["classifier"], "classifier")}
    gj = {**_named(grads_j["backbone"], "model"),
          **_named(grads_j["classifier"], "classifier")}
    assert set(ref) == set(got)
    worst, small, total = 0.0, 0, 0
    for k in ref:
        assert np.isfinite(got[k]).all() and np.isfinite(ref[k]).all(), k
        g = np.abs(gj[k])
        held = g > 1e-5 * g.max()
        small += int((~held).sum())
        total += g.size
        d = np.abs(got[k] - ref[k])[held].max(initial=0.0) / np.abs(
            ref[k]).max()
        worst = max(worst, d)
        assert d <= 1e-5, (what, k, d)
    assert small < 0.1 * total, (what, small, total)
    return worst


def test_train_step_matches_jax(setup):
    tr, step = setup["trainer"], setup["step"]
    params, stats = setup["params"], setup["stats"]
    _load_port(tr, params, stats)
    tr.step = 0
    waves, ratio, labels = _batch()
    feats = np.asarray(setup["front"](waves, ratio), np.float64)
    with enable_x64():
        opt_state = setup["tx"].init((params, {}))
        loss_j, grads_j, stats_j, new_params, _ = jax.device_get(step(
            params, stats, opt_state, feats, ratio, labels))
    assert grads_j["classifier"]["weight"].dtype == np.float64
    loss, acc, grads = _port_step(tr, feats, ratio, labels)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
    ref = {**_named(grads_j["backbone"], "model"),
           **_named(grads_j["classifier"], "classifier")}
    assert set(ref) == set(grads)
    worst = 0.0
    floor = 1e-3 * max(np.linalg.norm(r) for r in ref.values())
    for k, r in ref.items():
        d = np.linalg.norm(grads[k].numpy() - r) / max(np.linalg.norm(r),
                                                       floor)
        worst = max(worst, d)
        assert d <= 1e-4, (k, d)
    stats_t = tr.model.state_dict()
    for k, v in jax_to_torch_state({"params": {}, "batch_stats":
                                    stats_j["backbone"]},
                                   dtype=np.float64).items():
        if k.endswith("num_batches_tracked"):
            continue
        scale = max(np.abs(v.numpy()).max(), 1e-6)
        d = np.abs(stats_t[k].numpy() - v.numpy()).max()
        assert d <= 1e-5 * scale, (k, d, scale)
    worst_p = _check_params(tr, new_params, grads_j, "step 0")
    print(f"{setup['name']}: loss {loss:.9f} vs {float(loss_j):.9f}, worst "
          f"grad leaf {worst:.2e}, worst parameter {worst_p:.2e}")


def test_jax_state_after_two_steps_continues_in_the_port(setup):
    tr, step, tx = setup["trainer"], setup["step"], setup["tx"]
    params, stats = setup["params"], setup["stats"]
    feats = {s: (np.asarray(setup["front"](*_batch(s)[:2]), np.float64),)
             + _batch(s)[1:] for s in (1, 2, 3)}
    with enable_x64():
        opt_state = tx.init((params, {}))
        for s in (1, 2):
            _, _, stats, params, opt_state = step(params, stats, opt_state,
                                                  *feats[s])
        jax_state = jax.device_get({
            "params": params, "batch_stats": stats, "loss_params": {},
            "opt_state": opt_state, "step": 2})
        loss_j, grads_j, _, new_params, _ = jax.device_get(step(
            params, stats, opt_state, *feats[3]))
    tr.load_train_state(jax_to_torch_train_state(
        jax_state, tr.optimizer, tr.param_names, dtype=np.float64))
    assert tr.step == 2 and tr.updates == 2
    loss, _, _ = _port_step(tr, *feats[3])
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
    _check_params(tr, new_params, grads_j, "step 2")
    st = tr.optimizer.state[tr.optimizer.param_groups[0]["params"][0]]
    assert float(st["step"]) == 3


def test_waveform_step_matches_jax(setup):
    """The float32 front of ``Trainer.train_step`` on the int16 batch:
    int16 -> float, the dB normalization over the valid samples, the
    port's fbank (its plain version on the CPU) and the masked CMN,
    against the JAX step's front end: within 2e-4 of the features' scale
    (the plain fbank against XLA's, float32 in the log domain). Then one
    float32 step on the waveforms trains: a finite loss, BN statistics
    that move."""
    tr = setup["trainer"]
    waves, ratio, labels = _batch(4)
    ref = np.asarray(setup["front"](waves, ratio))
    got = tr.featurize("waveforms", torch.from_numpy(waves),
                       torch.from_numpy(ratio)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-4 * np.abs(ref).max())
    tr.model.float()
    tr.classifier.float()
    tr.optimizer.state.clear()          # float64 moments of the tests above
    try:
        bn = [m for m in tr.model.modules()
              if isinstance(m, torch.nn.BatchNorm1d)][-1]
        before = bn.running_var.clone()
        loss, _, _ = _port_step(tr, waves, ratio, labels, kind="waveforms")
        assert np.isfinite(loss)
        assert not torch.equal(before, bn.running_var)
    finally:
        tr.optimizer.state.clear()
        tr.model.double()
        tr.classifier.double()


def test_dense_bn_running_variance_is_flax_s():
    """CAM++'s ``DenseBN_0`` (``batchnorm_``) in train mode at batch 4:
    the output and the running statistics against flax. The running
    variance takes the biased batch variance at momentum 0.1; torch's own
    ``nn.BatchNorm1d`` takes the unbiased one (4/3 of it at batch 4)."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 64).astype(np.float32) * 2 + 0.5
    jm = JaxDenseBN(16, config_str="batchnorm_")
    shapes = flax.core.unfreeze(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                               x))
    v = seeded_variables(shapes, rng)
    ref, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
    tm = DenseBN(64, 16, "batchnorm_")
    tm.load_state_dict(jax_to_torch_state(v))
    got = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5 * np.abs(ref).max())
    bn = tm.BatchNorm_0
    want = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_var.numpy(), want["var"], rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"],
                               rtol=1e-6, atol=1e-7)
    assert bn.momentum == 0.1
