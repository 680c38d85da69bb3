"""The port's config, data stream and transforms against the JAX package:
``Config`` defaults against ``default.yaml``, the shuffle and the task
stream, and each transform on the same uint8 batches."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

from libcontinual_tpu.config import Config as JaxConfig  # noqa: E402
from libcontinual_tpu.data import continual as jcont  # noqa: E402
from libcontinual_tpu.data import native as jnative  # noqa: E402
from libcontinual_tpu.data import transforms as jtr  # noqa: E402
from libcontinual_tpu_torch.config import Config  # noqa: E402
from libcontinual_tpu_torch.config.config import DEFAULTS  # noqa: E402
from libcontinual_tpu_torch.data import continual as tcont  # noqa: E402
from libcontinual_tpu_torch.data import native as tnative  # noqa: E402
from libcontinual_tpu_torch.data import transforms as ttr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: float32 resampling on values in [0, 1]: the same weights, summed in
#: another order
TOL = 1e-5


def _images(b=3, h=32, w=32, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, h, w, 3)).astype(np.uint8)


def _as_float(u8):
    return u8.astype(np.float32) / 255.0


# ------------------------------------------------------------------ config


def test_defaults_equal_default_yaml():
    with open(os.path.join(REPO, "libcontinual_tpu", "config", "default.yaml")) as f:
        assert DEFAULTS == yaml.safe_load(f)


def test_config_file_merge_matches_jax():
    path = os.path.join(REPO, "configs", "l2p-vit-cifar100-b10-10-10.yaml")
    over = {"seed": 5, "epoch": 1}
    assert Config(path, overrides=over).get_config_dict() == \
        JaxConfig(path, overrides=over).get_config_dict()


# -------------------------------------------------------------------- data


@pytest.mark.parametrize("n,seed", [(1, 0), (97, 3), (500, 1993)])
def test_shuffled_indices_equal_jax(n, seed):
    np.testing.assert_array_equal(tnative.shuffled_indices(n, seed),
                                  jnative.shuffled_indices(n, seed))
    np.testing.assert_array_equal(tnative._xorshift_permutation(n, seed),
                                  jnative._xorshift_permutation(n, seed))


def test_stream_equals_jax():
    cfg = {"dataset": "synthetic", "task_num": 3, "init_cls_num": 4, "inc_cls_num": 2,
           "per_class": 5, "seed": 11, "image_size": 8}
    js, jmap = jcont.build_stream(cfg, "train")
    ts, tmap = tcont.build_stream(cfg, "train")
    np.testing.assert_array_equal(tmap, jmap)
    for t in range(3):
        assert ts.class_range(t) == js.class_range(t)
        np.testing.assert_array_equal(ts.task(t).images, js.task(t).images)
        np.testing.assert_array_equal(ts.task(t).labels, js.task(t).labels)
    test_t, _ = tcont.build_stream(cfg, "test", tmap)
    test_j, _ = jcont.build_stream(cfg, "test", jmap)
    np.testing.assert_array_equal(test_t.task(2).images, test_j.task(2).images)


IMB_TYPES = ["exp", "exp_re", "exp_max", "exp_max_re", "exp_min", "half", "half_re",
             "halfbal", "oneshot", "step", "fewshot", "none"]


@pytest.mark.parametrize("imb_type", IMB_TYPES)
def test_imbalance_profile_equals_jax(imb_type):
    for cls_num, task_num, img_max, factor in [(100, 10, 500, 0.01), (8, 2, 24, 0.1)]:
        args = (imb_type, cls_num, task_num, cls_num // task_num, cls_num // task_num,
                img_max, factor)
        assert tcont.imbalance_profile(*args) == jcont.imbalance_profile(*args)


@pytest.mark.parametrize("imb_type,shuffle", [("exp", False), ("exp", True), ("half", True),
                                              ("step", False)])
def test_imbalanced_stream_equals_jax(imb_type, shuffle):
    cfg = {"dataset": "synthetic", "task_num": 3, "init_cls_num": 4, "inc_cls_num": 4,
           "per_class": 12, "seed": 5, "image_size": 8, "imb_type": imb_type,
           "imb_factor": 0.1, "shuffle": shuffle}
    js, jmap = jcont.build_stream(cfg, "train")
    ts, _ = tcont.build_stream(cfg, "train")
    sizes = [len(ts.task(t)) for t in range(3)]
    assert sizes == [len(js.task(t)) for t in range(3)] and sum(sizes) < 3 * 4 * 12
    for t in range(3):
        np.testing.assert_array_equal(ts.task(t).images, js.task(t).images)
        np.testing.assert_array_equal(ts.task(t).labels, js.task(t).labels)
    # the test split stays balanced
    test_t, _ = tcont.build_stream(cfg, "test", jmap)
    assert len(test_t.task(0)) == len(jcont.build_stream(cfg, "test", jmap)[0].task(0))


def test_tiny_imagenet_class_order_equals_jax(monkeypatch):
    """Without a ``class_order``, tiny-imagenet's classes are ordered by
    Python's ``random`` shuffle, not a numpy permutation: both packages'
    ``build_stream`` on the same arrays give the same map and tasks."""
    rng = np.random.RandomState(9)
    src = {"images": rng.randint(0, 256, (60, 4, 4, 3)).astype(np.uint8),
           "labels": np.repeat(np.arange(20), 3).astype(np.int32),
           "class_names": [f"c{i}" for i in range(20)]}
    monkeypatch.setattr(jcont, "load_source", lambda config, mode: src)
    monkeypatch.setattr(tcont, "load_source", lambda config, mode: src)
    cfg = {"dataset": "tiny-imagenet", "task_num": 4, "init_cls_num": 5, "inc_cls_num": 5,
           "seed": 1993}
    js, jmap = jcont.build_stream(cfg, "train")
    ts, tmap = tcont.build_stream(cfg, "train")
    np.testing.assert_array_equal(tmap, jmap)
    assert not np.array_equal(tmap, tcont.build_class_map(20, seed=1993))
    for t in range(4):
        np.testing.assert_array_equal(ts.task(t).labels, js.task(t).labels)
        np.testing.assert_array_equal(ts.task(t).images, js.task(t).images)
    assert ts.class_names == js.class_names


def test_missing_dataset_root_raises():
    with pytest.raises(FileNotFoundError):
        tcont.build_stream({"dataset": "cifar100", "data_root": "/nonexistent",
                            "task_num": 1, "init_cls_num": 1, "inc_cls_num": 1}, "train")


# -------------------------------------------------------------- transforms


@pytest.mark.parametrize("src,dst", [(32, 224), (32, 256), (17, 40), (64, 24)])
def test_resize_matches_jax(src, dst):
    x = _as_float(_images(h=src, w=src))
    ref = np.asarray(jtr.resize(jnp.asarray(x), dst))
    out = ttr.resize(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    # the border rows and columns of the upsampling, where the weights renormalise
    for sl in (np.s_[:, :4], np.s_[:, -4:], np.s_[:, :, :4], np.s_[:, :, -4:]):
        np.testing.assert_allclose(out[sl], ref[sl], atol=TOL, rtol=0)


@pytest.mark.parametrize("size", [24, 40])
def test_center_crop_matches_jax(size):
    x = _as_float(_images())
    ref = np.asarray(jtr.center_crop(jnp.asarray(x), size))
    np.testing.assert_array_equal(ttr.center_crop(torch.from_numpy(x), size).numpy(), ref)


def test_crop_and_resize_matches_jax():
    x = _as_float(_images())
    boxes = np.array([[0.0, 0.0, 32.0, 32.0], [3.5, 7.25, 20.0, 11.0],
                      [20.0, 1.0, 12.0, 30.5]], np.float32)
    ref = np.asarray(jtr.crop_and_resize(jnp.asarray(x), jnp.asarray(boxes), (224, 224)))
    out = ttr.crop_and_resize(torch.from_numpy(x), torch.from_numpy(boxes), (224, 224))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


def test_hflip_matches_jax_flip():
    x = _as_float(_images())
    flags = np.array([True, False, True])
    ref = np.where(flags[:, None, None, None], np.asarray(jnp.asarray(x)[:, :, ::-1, :]), x)
    out = ttr.hflip(torch.from_numpy(x), torch.from_numpy(flags))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_normalize_matches_jax():
    x = _as_float(_images())
    mean, std = [0.5071, 0.4866, 0.4409], [0.2675, 0.2565, 0.2761]
    ref = np.asarray(jtr.normalize(jnp.asarray(x), mean, std))
    np.testing.assert_allclose(ttr.normalize(torch.from_numpy(x), mean, std).numpy(), ref,
                               atol=TOL, rtol=0)


def test_pipeline_normalize_uploads_its_statistics_once():
    """A pipeline's Normalize makes its mean and std tensors at its first
    call and reuses them (on the card each upload waits for the device);
    its output is the plain ``normalize`` bit for bit."""
    mean, std = [0.5071, 0.4866, 0.4409], [0.2675, 0.2565, 0.2761]
    tp = ttr.Pipeline([("Normalize", {"mean": mean, "std": std})])
    x = torch.from_numpy(_as_float(_images()))
    first = tp(None, x)
    stats = dict(tp._stats)
    assert torch.equal(tp(None, x), first) and torch.equal(first, ttr.normalize(x, mean, std))
    assert len(stats) == 1 and all(a is b for a, b in zip(stats.values(), tp._stats.values()))
    tp(None, x.double())  # another dtype gets its own tensors
    assert len(tp._stats) == 2


@pytest.mark.parametrize("dataset", ["synthetic", "cifar100"])
def test_vit_eval_pipeline_matches_jax(dataset):
    u8 = _images()
    jp = jtr.build_transform(None, dataset=dataset, backbone="vit", mode="test")
    tp = ttr.build_transform(None, dataset=dataset, backbone="vit", mode="test")
    ref = np.asarray(jp(None, jnp.asarray(u8)))
    out = tp(None, torch.from_numpy(u8)).numpy()
    assert out.shape == ref.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_vit_train_pipeline_draws_valid_crops():
    tp = ttr.build_transform(None, dataset="synthetic", backbone="vit", mode="train")
    u8 = torch.from_numpy(_images(b=16))
    a = tp(torch.Generator().manual_seed(0), u8)
    b = tp(torch.Generator().manual_seed(0), u8)
    c = tp(torch.Generator().manual_seed(1), u8)
    assert a.shape == (16, 224, 224, 3) and torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    # the eval form of the same pipeline (no generator) is a plain resize
    np.testing.assert_allclose(tp(None, u8).numpy(), ttr.resize(u8.float() / 255, 224).numpy())
