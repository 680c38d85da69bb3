"""The LayerNorm op of the port (``ops/layer_norm.py``) on the CPU: the
routed op is the old composition ``F.layer_norm(x.float(), ...).to(dtype)``
bit for bit, forward and gradients; ``layer_norm_bwd_plain`` (the kernel's
backward equations) agrees with autograd of that composition; the op refuses
what the kernels do not take; no kernel launch is counted on the CPU; and a
bf16 ViT keeps its rounding points. The kernels themselves are checked on the
card (``tests/test_torch_gpu.py``)."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from libcontinual_tpu_torch.models import vit
from libcontinual_tpu_torch.ops import layer_norm as L

#: f32 on the CPU: the same equations as autograd's in another order of the
#: f32 sums, relative to the largest magnitude of the reference
BWD_TOL = 1e-5


def _composition(x, weight, bias, eps, dtype):
    """The port's LayerNorm before the op: f32 casts around ``F.layer_norm``."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps).to(dtype)


def _inputs(x_dtype, w_dtype, trainable, d=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(3, 7, d, generator=gen) * 2.0 + 0.5).to(x_dtype).requires_grad_()
    w = (1.0 + 0.1 * torch.randn(d, generator=gen)).to(w_dtype).requires_grad_(trainable)
    b = (0.1 * torch.randn(d, generator=gen)).to(w_dtype).requires_grad_(trainable)
    return x, w, b


def _clone(*ts):
    return [t.detach().clone().requires_grad_(t.requires_grad) for t in ts]


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("trainable", [False, True], ids=["frozen", "trainable"])
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.float32)],
                         ids=["bf16-bf16", "bf16-f32", "f32-f32"])
def test_routed_op_on_cpu_is_the_composition_bit_for_bit(dtypes, trainable, eps):
    """x -> y dtypes; frozen parameters in x's dtype (L2P's bf16 frozen ViT),
    trainable ones in f32."""
    x_dtype, y_dtype = dtypes
    x, w, b = _inputs(x_dtype, torch.float32 if trainable else x_dtype, trainable)
    x2, w2, b2 = _clone(x, w, b)
    y = L.layer_norm(x, w, b, eps, y_dtype)
    ref = _composition(x2, w2, b2, eps, y_dtype)
    assert y.dtype == y_dtype and torch.equal(y, ref)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(y_dtype)
    y.backward(g)
    ref.backward(g)
    assert torch.equal(x.grad, x2.grad) and x.grad.dtype == x_dtype
    for p, p2 in ((w, w2), (b, b2)):
        assert (p.grad is None) == (not trainable)
        if trainable:
            assert torch.equal(p.grad, p2.grad)


@pytest.mark.parametrize("d", [64, 512, 768])
def test_backward_equations_match_autograd_of_the_composition(d):
    x, w, b = _inputs(torch.float32, torch.float32, True, d=d, seed=d)
    eps = 1e-5
    y = _composition(x, w, b, eps, torch.float32)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    y.backward(g)
    got = L.layer_norm_bwd_plain(x.detach(), g, w.detach(), eps)
    for a, ref in zip(got, (x.grad, w.grad, b.grad)):
        assert a.shape == ref.shape and a.dtype == torch.float32
        assert float((a - ref).abs().max()) <= BWD_TOL * max(1.0, float(ref.abs().max()))
    mean, rstd = L.layer_norm_stats_plain(x.detach(), eps)
    xhat = (x.detach() - mean[..., None]) * rstd[..., None]
    assert torch.allclose(xhat * w.detach() + b.detach(), y.detach(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["D not a multiple of 8", "D above the limit", "device"])
def test_op_refuses_what_the_kernels_do_not_take(case):
    d = {"D not a multiple of 8": 20, "D above the limit": L.MAX_DIM + 8, "device": 64}[case]
    device = "meta" if case == "device" else "cpu"
    x = torch.zeros(2, d, device=device)
    w, b = torch.ones(d, device=device), torch.zeros(d, device=device)
    match = "no implementation for device" if case == "device" else f"D {d} not supported"
    with pytest.raises(ValueError, match=match):
        L.layer_norm(x, w, b, 1e-5, torch.float32)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        L.layer_norm_cuda(torch.zeros(2, 64), torch.ones(64), torch.zeros(64), 1e-5,
                          torch.float32)


def test_no_launch_is_counted_on_the_cpu():
    L.reset_launches()
    x, w, b = _inputs(torch.bfloat16, torch.float32, True)
    L.layer_norm(x, w, b, 1e-6, torch.float32).sum().backward()
    with torch.no_grad():
        L.layer_norm(x, w, b, 1e-6, torch.bfloat16)
    assert L.LAUNCHES == {"ln_fwd": 0, "ln_bwd": 0}


def test_bf16_vit_keeps_its_rounding_points(monkeypatch):
    """A bf16 ``vit_tiny_test`` forward (blocks at eps 1e-5, the final norm
    at 1e-6 into f32) gives the same bits through the op as through the old
    composition, with prompts prepended and the gradient of the prompts."""
    torch.manual_seed(0)
    model = vit.vit_tiny_test(dtype=torch.bfloat16, block_ln_eps=1e-5,
                              generator=torch.Generator().manual_seed(3))
    model = model.to(torch.bfloat16).requires_grad_(False)
    images = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    prompts = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(5))

    def run():
        p = prompts.clone().requires_grad_()
        out = model(images, prepend_tokens=p, feature_mode="prompt_mean")
        out["features"].square().sum().backward()
        return out["tokens"], out["features"], p.grad

    got = run()
    monkeypatch.setattr(vit, "layer_norm",
                        lambda ln, x, dtype: _composition(x, ln.weight, ln.bias, ln.eps, dtype))
    ref = run()
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.float32
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
