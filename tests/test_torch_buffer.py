"""The port's replay buffers against the JAX package's: the herding order on
identical normalised features, the herding and random updates over three
tasks (labels and pixels identical), ``_shrink_old`` with and without an
rng, ``LinearSpiltBuffer.split`` and the registrations."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.core import buffer as JB  # noqa: E402
from libcontinual_tpu.data.continual import TaskData as JTaskData  # noqa: E402
from libcontinual_tpu_torch.core import buffer as B  # noqa: E402
from libcontinual_tpu_torch.data.continual import TaskData  # noqa: E402


def _normalised(n, d, seed):
    f = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-12)


@pytest.mark.parametrize("n,d,seed", [(20, 8, 0), (60, 64, 1), (7, 512, 2)])
def test_herding_order_is_identical(n, d, seed):
    feats = _normalised(n, d, seed)
    ref = np.asarray(JB._herding_order(jnp.asarray(feats)))
    got = B._herding_order(torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert sorted(got.tolist()) == list(range(n))


def test_herding_order_breaks_ties_to_the_lower_index():
    feats = _normalised(6, 4, 3)
    feats = np.concatenate([feats, feats])  # every sample twice
    ref = np.asarray(JB._herding_order(jnp.asarray(feats)))
    np.testing.assert_array_equal(B._herding_order(torch.from_numpy(feats)).numpy(), ref)


def _tasks(n_tasks=3, per_task=4, per_class=9, hw=4):
    """Three tasks of uint8 images; both packages' TaskData around the same
    arrays."""
    rng = np.random.RandomState(7)
    out = []
    for t in range(n_tasks):
        lo = t * per_task
        labels = np.repeat(np.arange(lo, lo + per_task), per_class).astype(np.int32)
        perm = rng.permutation(len(labels))
        images = rng.randint(0, 256, (len(labels), hw, hw, 3)).astype(np.uint8)
        out.append((images, labels[perm], lo, lo + per_task))
    return out


def _feature_fn(images):
    """A fixed feature map of the pixels (a random projection of them)."""
    flat = images.reshape(len(images), -1).astype(np.float32) / 255.0
    proj = np.random.RandomState(11).randn(flat.shape[1], 16).astype(np.float32)
    return flat @ proj


@pytest.mark.parametrize("strategy", ["herding", "random", "equal_random", "balance_random"])
def test_updates_over_three_tasks_are_identical(strategy):
    jb = JB.LinearBuffer(buffer_size=24, strategy=strategy)  # quota 6, 3, 2
    pb = B.LinearBuffer(buffer_size=24, strategy=strategy)
    for t, (images, labels, lo, hi) in enumerate(_tasks()):
        for buf in (jb, pb):
            buf.total_classes += hi - lo
        jb.update(JTaskData(images, labels, lo, hi), feature_fn=_feature_fn, seed=100 + t)
        pb.update(TaskData(images, labels, lo, hi), feature_fn=_feature_fn, seed=100 + t)
        np.testing.assert_array_equal(pb.labels, jb.labels)
        np.testing.assert_array_equal(pb.images, jb.images)
        jd, pd = jb.as_task_data(), pb.as_task_data()
        assert (pd.class_lo, pd.class_hi, len(pd)) == (jd.class_lo, jd.class_hi, len(jd))
    assert len(pb) == 24


@pytest.mark.parametrize("with_rng", [False, True])
def test_shrink_old(with_rng):
    images, labels, _, _ = _tasks(1, per_task=3, per_class=5)[0]
    bufs = []
    for mod in (JB, B):
        buf = mod.LinearBuffer(buffer_size=15)
        buf.images, buf.labels = images.copy(), labels.copy()
        buf._shrink_old(2, np.random.RandomState(5) if with_rng else None)
        bufs.append(buf)
    np.testing.assert_array_equal(bufs[1].labels, bufs[0].labels)
    np.testing.assert_array_equal(bufs[1].images, bufs[0].images)
    assert np.bincount(bufs[1].labels).tolist() == [2, 2, 2]
    if not with_rng:  # the first two of each class, in class order
        first = np.concatenate([np.nonzero(labels == c)[0][:2] for c in range(3)])
        np.testing.assert_array_equal(bufs[1].images, images[first])


@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.5])
def test_split_buffer(ratio):
    images, labels, _, _ = _tasks(1, per_task=4, per_class=6)[0]
    parts = []
    for mod in (JB, B):
        buf = mod.LinearSpiltBuffer(buffer_size=24, split_ratio=ratio)
        buf.images, buf.labels = images, labels
        parts.append(buf.split(seed=3))
    (jt, jv), (pt, pv) = parts
    np.testing.assert_array_equal(pt.labels, jt.labels)
    np.testing.assert_array_equal(pt.images, jt.images)
    assert (pv is None) == (jv is None) == (ratio == 0.0)
    if pv is not None:
        np.testing.assert_array_equal(pv.images, jv.images)
        assert (pv.class_lo, pv.class_hi) == (jv.class_lo, jv.class_hi)


def test_registrations_and_unknown_strategy():
    cfg = {"buffer": {"name": "LinearHerdingBuffer",
                      "kwargs": {"buffer_size": 8, "strategy": "random"}}}
    buf = B.build_buffer(cfg, "cpu")
    assert buf.strategy == "herding" and buf.buffer_size == 8
    assert isinstance(B.build_buffer({"buffer": {"name": "LinearSpiltBuffer", "kwargs": {}}}),
                      B.LinearSpiltBuffer)
    images, labels, lo, hi = _tasks(1)[0]
    with pytest.raises(ValueError, match="unknown buffer strategy"):
        B.LinearBuffer(buffer_size=4, strategy="fifo").update(TaskData(images, labels, lo, hi))
    with pytest.raises(ValueError, match="feature_fn"):
        B.LinearBuffer(buffer_size=4).update(TaskData(images, labels, lo, hi))
