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

    pmod = Involution2d(16, 3, padding=padding, stride=stride, groups=4, dilation=dilation, reduction_ratio=2)
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
