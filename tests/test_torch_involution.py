"""Parity of the port's Involution2d and involution stencil with the JAX package, on
the CPU in float32. The JAX module runs its Pallas kernel in interpret mode there
(``holocron_tpu/nn/modules/conv.py:386``)."""

import jax
import numpy as np
import pytest
import torch

from holocron_tpu import nn as hnn
from holocron_tpu_torch import convert
from holocron_tpu_torch.kernels.involution import involution_stencil, involution_stencil_plain
from holocron_tpu_torch.nn import Involution2d

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "stride,dilation,padding",
    [(1, 1, 1), (2, 1, 1), (1, 2, 2)],
    ids=["stencil", "strided", "dilated"],
)
def test_involution2d_matches_jax(stride, dilation, padding):
    """Same weights and input (2, 12, 12, 16), k=3, G=4, reduction 2: atol 1e-5. Stride
    and dilation 1 run the stencil (Pallas in JAX); the others shift-accumulate."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 12, 16)).astype(np.float32)
    jmod = hnn.Involution2d(kernel_size=3, padding=padding, stride=stride, groups=4, dilation=dilation,
                            reduction_ratio=2)
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.key(1), x))
    for name in ("reduce", "span"):  # non-zero biases, so that they are exercised
        variables["params"][name]["bias"] = rng.normal(size=variables["params"][name]["bias"].shape).astype(np.float32)
    expected = np.asarray(jmod.apply(variables, x))

    pmod = Involution2d(16, 3, padding=padding, stride=stride, groups=4, dilation=dilation, reduction_ratio=2,
                        device="cpu")
    pmod.load_state_dict(convert.involution_state_dict(variables))
    with torch.no_grad():
        out = pmod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, expected, atol=1e-5)


def test_plain_stencil_equals_naive_form_exactly():
    """The plain version is the per-tap sum of tests/test_kernels.py:108-111, bit for bit."""
    rng = np.random.default_rng(0)
    n, h, w, c, g, k = 2, 6, 7, 8, 4, 3
    cg = c // g
    xn = rng.normal(size=(n, h + k - 1, w + k - 1, c)).astype(np.float32)
    kn = rng.normal(size=(n, h, w, k * k * g)).astype(np.float32)
    expected = np.zeros((n, h, w, c), np.float32)
    for idx in range(k * k):
        dy, dx = divmod(idx, k)
        expected += np.repeat(kn[:, :, :, idx * g : (idx + 1) * g], cg, axis=-1) * xn[:, dy : dy + h, dx : dx + w]
    out = involution_stencil(torch.from_numpy(xn), torch.from_numpy(kn), k, g)
    np.testing.assert_array_equal(out.numpy(), expected)
    np.testing.assert_array_equal(involution_stencil_plain(torch.from_numpy(xn), torch.from_numpy(kn), k, g).numpy(),
                                  expected)


def test_stencil_matches_jax_pallas_interpret():
    """The plain stencil against the Pallas kernel in interpret mode, at k=5, G=2."""
    from holocron_tpu.kernels.involution import involution_stencil as jax_stencil

    rng = np.random.default_rng(1)
    n, h, w, c, g, k = 1, 5, 6, 8, 2, 5
    xp = rng.normal(size=(n, h + k - 1, w + k - 1, c)).astype(np.float32)
    kern = rng.normal(size=(n, h, w, k * k * g)).astype(np.float32)
    expected = np.asarray(jax_stencil(xp, kern, k, g, True))
    out = involution_stencil(torch.from_numpy(xp), torch.from_numpy(kern), k, g).numpy()
    np.testing.assert_allclose(out, expected, atol=1e-5)


def test_stencil_keeps_bf16_and_rejects_bad_shapes():
    xp = torch.randn(1, 6, 6, 8).to(torch.bfloat16)
    kern = torch.randn(1, 4, 4, 9 * 2).to(torch.bfloat16)
    out = involution_stencil(xp, kern, 3, 2)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 4, 8)
    torch.testing.assert_close(out, involution_stencil_plain(xp.float(), kern.float(), 3, 2).to(torch.bfloat16))
    with pytest.raises(ValueError):
        involution_stencil(xp, kern[..., :9], 3, 2)
    with pytest.raises(ValueError):
        involution_stencil(xp, kern, 3, 3)


def test_stencil_grads_match_jax_involution_stencil_ad():
    """InvolutionStencil's gradients (its plain backward on the CPU) against jax.grad of
    involution_stencil_ad with the Pallas forward in interpret mode, at k=3, G=4 and at
    k=5, G=2: atol 1e-4. (The stencil had no backward before: on the card the kernel's
    output carried no gradient.)"""
    from holocron_tpu.kernels.involution import involution_stencil_ad as jax_stencil_ad
    from holocron_tpu_torch.kernels.involution import InvolutionStencil

    rng = np.random.default_rng(2)
    for n, h, w, c, g, k in ((2, 6, 7, 8, 4, 3), (1, 5, 6, 8, 2, 5)):
        xp = rng.normal(size=(n, h + k - 1, w + k - 1, c)).astype(np.float32)
        kern = rng.normal(size=(n, h, w, k * k * g)).astype(np.float32)
        gcot = rng.normal(size=(n, h, w, c)).astype(np.float32)
        jdx, jdk = jax.grad(lambda a, b: jax.numpy.sum(jax_stencil_ad(a, b, k, g, True) * gcot), argnums=(0, 1))(
            xp, kern)
        txp = torch.from_numpy(xp).requires_grad_()
        tk = torch.from_numpy(kern).requires_grad_()
        InvolutionStencil.apply(txp, tk, k, g).backward(torch.from_numpy(gcot))
        np.testing.assert_allclose(txp.grad.numpy(), np.asarray(jdx), atol=1e-4)
        np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jdk), atol=1e-4)


def test_plain_dxp_equals_naive_scatter_exactly():
    """The plain dxp is the per-tap scatter-add of _involution_bwd in tap order, bit for
    bit (the order the gather-form kernel adds in)."""
    from holocron_tpu_torch.kernels.involution import involution_bwd_dkern_plain, involution_bwd_dxp_plain

    rng = np.random.default_rng(3)
    n, h, w, c, g, k = 2, 5, 6, 8, 4, 3
    cg = c // g
    xp = rng.normal(size=(n, h + k - 1, w + k - 1, c)).astype(np.float32)
    kern = rng.normal(size=(n, h, w, k * k * g)).astype(np.float32)
    gcot = rng.normal(size=(n, h, w, c)).astype(np.float32)
    dxp = np.zeros_like(xp)
    dkern = []
    for idx in range(k * k):
        dy, dx = divmod(idx, k)
        dxp[:, dy : dy + h, dx : dx + w] += np.repeat(kern[..., idx * g : (idx + 1) * g], cg, axis=-1) * gcot
        dkern.append((xp[:, dy : dy + h, dx : dx + w] * gcot).reshape(n, h, w, g, cg).sum(-1))
    args = (torch.from_numpy(xp), torch.from_numpy(kern), torch.from_numpy(gcot), k, g)
    np.testing.assert_array_equal(involution_bwd_dxp_plain(*args).numpy(), dxp)
    np.testing.assert_allclose(involution_bwd_dkern_plain(*args).numpy(), np.concatenate(dkern, -1), atol=1e-5)


def test_involution2d_grads_match_jax():
    """Gradients of the whole module for x, reduce and span (weights and biases) against
    the JAX module's (Pallas stencil in interpret mode): atol 1e-4."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, 10, 16)).astype(np.float32)
    jmod = hnn.Involution2d(kernel_size=3, padding=1, groups=4, reduction_ratio=2)
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.key(1), x))
    for name in ("reduce", "span"):
        variables["params"][name]["bias"] = rng.normal(size=variables["params"][name]["bias"].shape).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    jgv, jgx = jax.grad(lambda v, xx: jax.numpy.sum(jmod.apply(v, xx) * gy), argnums=(0, 1))(variables, x)

    pmod = Involution2d(16, 3, padding=1, groups=4, reduction_ratio=2, device="cpu")
    pmod.load_state_dict(convert.involution_state_dict(variables))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    pmod(tx).backward(torch.from_numpy(gy.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(tx.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jgx), atol=1e-4)
    expected = convert.involution_state_dict({"params": jgv["params"]})
    for name, param in pmod.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), expected[name].numpy(), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_bwd_route_is_tiled_exactly_on_whole_16_byte_vectors(dtype, direction, monkeypatch):
    """The tiled kernels take a shape exactly where a group's cg = C / G channels are
    whole 16-byte vectors; every other shape takes the general route. One rule,
    bwd_route, and both involution_stencil and InvolutionStencil's backward pick their
    wrappers by it (recorded here in place of the wrappers)."""
    from holocron_tpu_torch.kernels import involution as V

    picked = []
    names = {"forward": ("involution_stencil_tiled", "involution_stencil_general"),
             "backward": ("involution_bwd_dxp", "involution_bwd_dxp_general")}[direction]
    for route, name in zip(("tiled", "general"), names):
        monkeypatch.setattr(V, name, lambda xp, *args, route=route: picked.append(route) or torch.zeros_like(xp))
    k = 1
    for c in (1, 3, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256):
        for groups in (1, 2, 3, 4, 8, 16, 32):
            if c % groups:
                continue
            expected = "tiled" if (c // groups) * dtype.itemsize % 16 == 0 else "general"
            assert V.bwd_route(c, groups, dtype) == expected, (c, groups)
            xp, kern = torch.zeros(1, 2, 2, c, dtype=dtype), torch.zeros(1, 2, 2, groups, dtype=dtype)
            if direction == "forward":
                V.involution_stencil(xp, kern, k, groups)
            else:
                xp.requires_grad_()
                V.InvolutionStencil.apply(xp, kern, k, groups).sum().backward()
            assert picked.pop() == expected, (c, groups)
    assert V.bwd_route(128, 8, torch.float16) == "general"  # no kernel takes float16


@pytest.mark.parametrize("k", [7, 3])
def test_bf16_backward_at_least_as_accurate_as_jax(k):
    """bf16 dxp and dkern of the port (the plain versions, which the kernels equal on the
    card: dxp bit for bit, dkern within its stated tolerance) against the float64
    gradient on the same bf16-rounded inputs, beside jax.vjp of involution_stencil_ad in
    bf16 (Pallas forward in interpret mode), at 2 x 12 x 12 x 32, G = 4. JAX accumulates
    dxp in bf16 tap by tap (holocron_tpu/kernels/involution.py:105,112-114); the port in
    float32, rounded once. So each port value is within one bf16 rounding of the exact
    one (half an ulp, at most 2^-8 of its magnitude, plus the float32 sum's 1e-5 of the
    sum of |terms|), and its largest error exceeds JAX's by at most half an ulp of the
    largest value (2^-9 * max |ref|): where JAX also rounds only once (dkern), which of
    the two lands closer is luck of the rounding."""
    from holocron_tpu.kernels.involution import involution_stencil_ad as jax_stencil_ad
    from holocron_tpu_torch.kernels.involution import involution_bwd_dkern_plain, involution_bwd_dxp_plain

    rng = np.random.default_rng(5)
    n, h, w, c, g = 2, 12, 12, 32, 4
    shapes = ((n, h + k - 1, w + k - 1, c), (n, h, w, k * k * g), (n, h, w, c))
    xp, kern, gcot = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16) for s in shapes)
    _, vjp = jax.vjp(lambda a, b: jax_stencil_ad(a, b, k, g, True),
                     *(jax.numpy.asarray(t.float().numpy(), jax.numpy.bfloat16) for t in (xp, kern)))
    jax_grads = [np.asarray(t, np.float64) for t in vjp(jax.numpy.asarray(gcot.float().numpy(), jax.numpy.bfloat16))]
    for name, plain, jax_grad in (("dxp", involution_bwd_dxp_plain, jax_grads[0]),
                                  ("dkern", involution_bwd_dkern_plain, jax_grads[1])):
        ref = plain(xp.double(), kern.double(), gcot.double(), k, g).numpy()
        absterms = plain(xp.double().abs(), kern.double().abs(), gcot.double().abs(), k, g).numpy()
        got = plain(xp, kern, gcot, k, g)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.double().numpy() - ref)
        assert (err <= 2.0**-8 * np.abs(ref) + 1e-5 * absterms).all(), name
        jax_err = np.abs(jax_grad - ref).max()
        assert err.max() <= jax_err + 2.0**-9 * np.abs(ref).max(), (name, err.max(), jax_err)


@pytest.mark.parametrize("route", ["tiled", "general"])
def test_backward_wrappers_compute_the_plain_versions_on_the_cpu(route):
    """On CPU tensors both routes' wrappers are the plain versions, bit for bit, and
    InvolutionStencil's backward gives the same whichever route the shape picks."""
    from holocron_tpu_torch.kernels import involution as V

    dxp_fn, dkern_fn = ((V.involution_bwd_dxp, V.involution_bwd_dkern) if route == "tiled"
                        else (V.involution_bwd_dxp_general, V.involution_bwd_dkern_general))
    rng = np.random.default_rng(6)
    for n, h, w, c, g, k in ((1, 5, 4, 16, 4, 3), (2, 3, 6, 32, 2, 5)):
        xp, kern, gcot = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                          for s in ((n, h + k - 1, w + k - 1, c), (n, h, w, k * k * g), (n, h, w, c)))
        assert torch.equal(dxp_fn(xp, kern, gcot, k, g), V.involution_bwd_dxp_plain(xp, kern, gcot, k, g))
        assert torch.equal(dkern_fn(xp, kern, gcot, k, g), V.involution_bwd_dkern_plain(xp, kern, gcot, k, g))
        a, b = xp.clone().requires_grad_(), kern.clone().requires_grad_()
        V.InvolutionStencil.apply(a, b, k, g).backward(gcot)
        assert torch.equal(a.grad, V.involution_bwd_dxp_plain(xp, kern, gcot, k, g))
        assert torch.equal(b.grad, V.involution_bwd_dkern_plain(xp, kern, gcot, k, g))


def test_tiled_backward_refuses_32_bit_overflow_before_touching_memory():
    """A tensor off the CPU goes to a kernel: the tiled wrappers (the forward and both
    gradients) refuse 2^31 elements or more (32-bit indices) from the shapes alone,
    before any copy (meta tensors hold no memory), and every wrapper refuses operands
    that are not on one CUDA device."""
    from holocron_tpu_torch.kernels import involution as V

    n, h, w, c, g, k = 4096, 128, 128, 128, 8, 7  # xp: 4096 * 134^2 * 128 >= 2^31
    meta = dict(device="meta", dtype=torch.bfloat16)
    xp, kern, gcot = (torch.empty(s, **meta) for s in ((n, h + k - 1, w + k - 1, c), (n, h, w, k * k * g), (n, h, w, c)))
    for fn in (V.involution_bwd_dxp, V.involution_bwd_dkern):
        with pytest.raises(ValueError, match="32 bits"):
            fn(xp, kern, gcot, k, g)
    for fn in (V.involution_stencil_tiled, V.involution_stencil):
        with pytest.raises(ValueError, match="32 bits"):
            fn(xp, kern, k, g)
    small = [t[:1, :3 + k - 1, :3 + k - 1] if i == 0 else t[:1, :3, :3] for i, t in enumerate((xp, kern, gcot))]
    for fn in (V.involution_bwd_dxp, V.involution_bwd_dkern, V.involution_bwd_dxp_general,
               V.involution_bwd_dkern_general):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*small, k, g)
    for fn in (V.involution_stencil_tiled, V.involution_stencil_general):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*small[:2], k, g)


@pytest.mark.parametrize("n,h,w,c,g,k", [(1, 5, 4, 16, 4, 3), (2, 3, 6, 32, 2, 5), (2, 4, 4, 8, 8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_forward_wrappers_compute_the_plain_version_on_the_cpu(n, h, w, c, g, k, dtype):
    """On CPU tensors involution_stencil and both routes' wrappers are the plain
    version, bit for bit, whatever the shape's route."""
    from holocron_tpu_torch.kernels import involution as V

    rng = np.random.default_rng(7)
    xp, kern = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
                for s in ((n, h + k - 1, w + k - 1, c), (n, h, w, k * k * g)))
    ref = V.involution_stencil_plain(xp, kern, k, g)
    for fn in (V.involution_stencil, V.involution_stencil_tiled, V.involution_stencil_general):
        assert torch.equal(fn(xp, kern, k, g), ref)
