"""The port's resnet-style transforms against the JAX package's, with the JAX
draws fed in: ``random_crop`` (zero padding, a per-image offset),
``color_jitter`` (brightness, contrast, saturation and hue in their fixed
order, one clamp) and ``random_grayscale``; the eval forms of the random
steps; and the resnet presets of ``build_transform``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from libcontinual_tpu.data import transforms as JT  # noqa: E402
from libcontinual_tpu_torch.data import transforms as T  # noqa: E402

#: float32 elementwise arithmetic in the same order
TOL = 1e-6


def _images(b=6, h=8, w=8, seed=0):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("size,padding", [(8, 4), (8, 0), (5, 2)])
def test_random_crop_with_the_jax_offsets(size, padding):
    x = _images()
    key = jax.random.PRNGKey(3)
    ref = np.asarray(JT.random_crop(key, jnp.asarray(x), size, padding))
    # the JAX draws: one split, then an offset per image in each axis
    k1, k2 = jax.random.split(key)
    span = x.shape[1] + 2 * padding - size + 1
    ys = np.array(jax.random.randint(k1, (x.shape[0],), 0, span))
    xs = np.array(jax.random.randint(k2, (x.shape[0],), 0, span))
    got = T.crop_at(torch.from_numpy(x), torch.from_numpy(ys), torch.from_numpy(xs), size, padding)
    np.testing.assert_array_equal(got.numpy(), ref)
    drawn = T.random_crop(torch.Generator().manual_seed(0), torch.from_numpy(x), size, padding)
    assert drawn.shape == (x.shape[0], size, size, 3)


@pytest.mark.parametrize("kw", [{"brightness": 63 / 255}, {"contrast": 0.4},
                                {"saturation": 0.5}, {"hue": 0.1},
                                {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4,
                                 "hue": 0.1}])
def test_color_jitter_with_the_jax_factors(kw):
    x = _images(seed=1)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(JT.color_jitter(key, jnp.asarray(x), **kw))
    keys = jax.random.split(key, 4)
    b = x.shape[0]

    def factor(i, v):
        if not v:
            return None
        f = jax.random.uniform(keys[i], (b, 1, 1, 1), minval=max(0.0, 1.0 - v), maxval=1.0 + v)
        return torch.from_numpy(np.array(f).reshape(b))

    hue = kw.get("hue", 0.0)
    theta = (torch.from_numpy(np.array(jax.random.uniform(keys[3], (b, 1, 1), minval=-hue,
                                                            maxval=hue)).reshape(b))
             if hue else None)
    got = T.jitter(torch.from_numpy(x), factor(0, kw.get("brightness")),
                   factor(1, kw.get("contrast")), factor(2, kw.get("saturation")), theta)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_random_grayscale_with_the_jax_flags():
    x = _images(seed=2)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JT.random_grayscale(key, jnp.asarray(x), p=0.5))
    on = np.array(jax.random.bernoulli(key, 0.5, (x.shape[0],)))
    got = T.grayscale(torch.from_numpy(x), torch.from_numpy(on))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    assert 0 < on.sum() < len(on)


@pytest.mark.parametrize("dataset", ["cifar100", "tiny-imagenet", "imagenet-r"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_resnet_presets_match(dataset, mode):
    ref = JT.build_transform(None, dataset=dataset, backbone="resnet", mode=mode)
    got = T.build_transform(None, dataset=dataset, backbone="resnet", mode=mode)
    assert got.steps == ref.steps


def test_eval_forms_of_the_random_steps():
    """Without a generator RandomCrop centre-crops the padded image and
    ColorJitter and RandomGrayscale do nothing, as the JAX pipeline does."""
    spec = [{"RandomCrop": {"size": 6, "padding": 2}}, {"ColorJitter": {"brightness": 0.5}},
            {"RandomGrayscale": {"p": 1.0}},
            {"Normalize": {"mean": [0.5, 0.4, 0.3], "std": [0.2, 0.3, 0.25]}}]
    u8 = (np.random.RandomState(3).rand(4, 8, 8, 3) * 255).astype(np.uint8)
    ref = np.asarray(JT.build_transform(spec)(None, jnp.asarray(u8)))
    got = T.build_transform(spec)(None, torch.from_numpy(u8))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    train = T.build_transform(spec)(torch.Generator().manual_seed(0), torch.from_numpy(u8))
    assert train.shape == (4, 6, 6, 3)
    gray = (train * torch.tensor([0.2, 0.3, 0.25]) + torch.tensor([0.5, 0.4, 0.3]))
    torch.testing.assert_close(gray[..., 0], gray[..., 1])  # p 1.0: every image gray
