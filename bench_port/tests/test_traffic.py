"""The traffic generator: deterministic per seed, different across seeds,
uint8 images at 32x32x3 with every class present."""

import numpy as np

from bench_port import traffic

P = {"num_classes": 5, "per_class": 6, "test_per_class": 2}


def test_same_seed_same_traffic():
    a, b = traffic.generate(P, 2 ** 31 + 12345, "cpu"), traffic.generate(P, 2 ** 31 + 12345, "cpu")
    for split in ("train", "test"):
        assert np.array_equal(a[split][0], b[split][0])
        assert np.array_equal(a[split][1], b[split][1])


def test_seeds_differ():
    a, b = traffic.generate(P, 1, "cpu"), traffic.generate(P, 2, "cpu")
    assert not np.array_equal(a["train"][0], b["train"][0])


def test_shapes_and_classes():
    t = traffic.generate(P, 7, "cpu")
    images, labels = t["train"]
    assert images.dtype == np.uint8 and images.shape == (30, 32, 32, 3)
    assert sorted(np.bincount(labels).tolist()) == [6] * 5
    assert t["test"][0].shape == (10, 32, 32, 3)
    assert 0 < images.mean() < 255
