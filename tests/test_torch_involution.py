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
