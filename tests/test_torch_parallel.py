"""PyTorch port, data parallelism on the CPU: two gloo ranks started by the
port's launcher (``tests/test_torch_parallel_ranks.py``) against the JAX
package on the whole batch, which is what the JAX mesh computes.

- ``allgather_ragged`` with shards of 3 and 1 rows against the semantics
  of JAX ``parallel/mesh.py:96-119`` (pad, gather, trim, rank-major), and
  an empty shard;
- ``layers.BatchNorm`` in train mode, float64, 2 ranks x half a batch
  against flax ``nn.BatchNorm`` on the whole batch, for (B, C), (B, C, T)
  and the 2-D backbones' (B, C, F, T): the output within 1e-5 of its
  largest, the input and weight gradients within 1e-5 of their norms, the
  running mean (rel 1e-6, abs 1e-7) and variance (rel 1e-6), the bars of
  ``tests/test_torch_train_step.py``'s BatchNorm pin;
- ``TripletAngularMarginLoss`` mining over the global batch against the
  JAX loss and its gradients on the whole batch: the ranks' mean loss
  (rel 1e-9) and the gradients DDP's mean would hand the optimizer;
- the backend each layout takes.

The DDP train step is ``tests/test_torch_parallel_step.py``; training,
evaluation, checkpoints and serving are
``tests/test_torch_parallel_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax import enable_x64

from test_torch_parallel_ranks import launch_ranks
from voiceprintrecognition_paddlepaddle_torch.parallel import (
    allgather_ragged, backend_for, local_process_info)
from voiceprintrecognition_paddlepaddle_tpu.loss import \
    TripletAngularMarginLoss as JaxTriplet

BN_SHAPES = {"(B, C)": (8, 6), "(B, C, T)": (8, 6, 5),
             "(B, C, F, T)": (8, 4, 3, 5)}
TRIPLET = dict(args=dict(margin=0.5, normalize_feature=True,
                         add_absolute=True, absolute_loss_weight=1.0,
                         ap_value=0.8, an_value=0.4), margin=0.3)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as the other training test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bn_cases():
    rng = np.random.RandomState(0)
    cases = {}
    for name, shape in BN_SHAPES.items():
        c = shape[1]
        cases[name] = {k: torch.from_numpy(v) for k, v in dict(
            x=rng.randn(*shape) * 2 + 0.5, dy=rng.randn(*shape),
            scale=rng.uniform(0.5, 1.5, c), bias=rng.randn(c) * 0.2,
            mean=rng.randn(c) * 0.2, var=rng.uniform(0.5, 1.5, c)).items()}
    return cases


def _triplet_inputs():
    rng = np.random.RandomState(1)
    labels = np.repeat(np.arange(4), 2)
    rng.shuffle(labels)
    return dict(TRIPLET, features=torch.from_numpy(rng.randn(8, 16)),
                logits=torch.from_numpy(rng.randn(8, 6) * 3),
                labels=torch.from_numpy(labels.astype(np.int64)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of two ranks running the ragged gather, the BatchNorm
    cases and the triplet loss."""
    root = tmp_path_factory.mktemp("ranks")
    return launch_ranks(root, ["ragged", "batchnorm", "triplet"],
                        {"bn": _bn_cases(), "triplet": _triplet_inputs()})


# ---------------------------------------------------------------------------
def _jax_ragged(shards):
    """JAX ``allgather_ragged``'s semantics on the host: pad to the
    largest count, stack, trim, concatenate rank-major."""
    counts = [s.shape[0] for s in shards]
    n_max = max(counts)
    padded = np.stack([np.concatenate(
        [s, np.zeros((n_max - s.shape[0],) + s.shape[1:], s.dtype)])
        for s in shards])
    return np.concatenate([padded[r, :c] for r, c in enumerate(counts)])


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_allgather_ragged_matches_jax_semantics(ranks, kind):
    feats = [np.arange(6, dtype=np.float32).reshape(3, 2),
             np.arange(2, dtype=np.float32).reshape(1, 2) + 100]
    labels = [np.arange(3, dtype=np.int32), np.arange(1, dtype=np.int32) + 10]
    for out in ranks:
        got_f, got_l = out["ragged"][kind]
        np.testing.assert_array_equal(got_f, _jax_ragged(feats))
        np.testing.assert_array_equal(got_l, _jax_ragged(labels))
        assert got_f.dtype == np.float32 and got_l.dtype == np.int32


def test_allgather_ragged_with_an_empty_shard(ranks):
    """Rank 1 holds no row and still joins; both get rank 0's two."""
    for out in ranks:
        got = out["ragged"]["empty_shard"]
        assert got.shape == (2, 3) and got.dtype == np.float64


def test_one_rank_needs_no_group():
    """Without a process group the arrays come back as they are."""
    assert local_process_info() == (0, 1)
    a = np.ones((2, 3), np.float32)
    assert allgather_ragged(a)[0] is a


@pytest.mark.parametrize("where,want", [
    (("cuda", 1, 1), "nccl"), (("cuda", 4, 4), "nccl"),
    (("cuda", 2, 1), "gloo"), (("cpu", 2, 0), "gloo")])
def test_backend_follows_the_layout(where, want):
    assert backend_for(*where) == want


# ---------------------------------------------------------------------------
def _flax_bn(case):
    """flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5, the channel axis 1)
    on the whole batch, float64: the output, the gradients of
    ``sum(y * dy)`` and the running statistics."""
    x, dy = case["x"].numpy(), case["dy"].numpy()
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      axis=1, dtype=jnp.float64, param_dtype=jnp.float64)
    variables = {"params": {"scale": case["scale"].numpy(),
                            "bias": case["bias"].numpy()},
                 "batch_stats": {"mean": case["mean"].numpy(),
                                 "var": case["var"].numpy()}}

    def f(x, params):
        return bn.apply({"params": params,
                         "batch_stats": variables["batch_stats"]}, x,
                        mutable=["batch_stats"])

    with enable_x64():
        y, mut = f(x, variables["params"])
        _, vjp = jax.vjp(lambda x, p: f(x, p)[0], x, variables["params"])
        dx, dp = vjp(dy)
        return jax.device_get((y, dx, dp, mut["batch_stats"]))


@pytest.mark.parametrize("name", sorted(BN_SHAPES))
def test_batchnorm_global_batch_matches_flax(ranks, name):
    y, dx, dp, stats = _flax_bn(_bn_cases()[name])
    outs = [r["batchnorm"][name] for r in ranks]
    got_y = torch.cat([o["y"] for o in outs]).numpy()
    np.testing.assert_allclose(got_y, y, rtol=0, atol=1e-5 * np.abs(y).max())
    got_dx = torch.cat([o["dx"] for o in outs]).numpy()
    assert np.linalg.norm(got_dx - dx) <= 1e-5 * np.linalg.norm(dx)
    # each rank's weight gradient is its own; DDP's mean x world is the sum
    for key, ref in (("dscale", dp["scale"]), ("dbias", dp["bias"])):
        got = sum(o[key] for o in outs).numpy()
        assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref), key
    for o in outs:
        np.testing.assert_allclose(o["var"].numpy(), stats["var"], rtol=1e-6)
        np.testing.assert_allclose(o["mean"].numpy(), stats["mean"],
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
def test_triplet_loss_mines_the_global_batch(ranks):
    """Each rank's loss is the global triplet term plus its own cross
    entropy, so their mean is JAX's loss on the whole batch; each rank's
    gradients are those of its own loss, so their mean over the ranks
    (what DDP hands the optimizer) is JAX's gradient."""
    t = _triplet_inputs()
    crit = JaxTriplet(**t["args"])

    def loss_fn(feats, logits):
        return crit({"features": feats, "logits": logits},
                    jnp.asarray(t["labels"].numpy()), margin=t["margin"])

    with enable_x64():
        loss, (df, dl) = jax.device_get(jax.value_and_grad(
            loss_fn, argnums=(0, 1))(t["features"].numpy(),
                                     t["logits"].numpy()))
    got = np.mean([float(r["triplet"]["loss"]) for r in ranks])
    np.testing.assert_allclose(got, float(loss), rtol=1e-9)
    got_df = torch.cat([r["triplet"]["dfeatures"] for r in ranks]).numpy() / 2
    got_dl = torch.cat([r["triplet"]["dlogits"] for r in ranks]).numpy() / 2
    np.testing.assert_allclose(got_df, df, rtol=0,
                               atol=1e-9 * np.abs(df).max())
    np.testing.assert_allclose(got_dl, dl, rtol=0,
                               atol=1e-9 * np.abs(dl).max())
