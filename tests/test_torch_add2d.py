"""Parity of the port's AdderNet ops with the JAX package, on the CPU in float32: the
plain ``add2d_matmul`` and its autograd form against the Pallas kernel (interpret
mode) and ``jax.grad`` of ``add2d_matmul_ad``, and ``add2d`` / ``Add2d`` against the
JAX functional and module on the same weights (``convert.add2d_state_dict``)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from holocron_tpu import nn as hnn
from holocron_tpu.kernels.add2d import add2d_matmul as jax_add2d_matmul
from holocron_tpu.kernels.add2d import add2d_matmul_ad as jax_add2d_matmul_ad
from holocron_tpu.nn import functional as JF
from holocron_tpu_torch import convert
from holocron_tpu_torch.kernels import add2d as K
from holocron_tpu_torch.nn import Add2d
from holocron_tpu_torch.nn import functional as TF

torch.set_num_threads(2)


def test_plain_matmul_matches_pallas_interpret():
    """The non-aligned shape of tests/test_kernels.py:9-16 (L50, D36, O10): atol 1e-4."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=(50, 36)).astype(np.float32)
    w = rng.normal(size=(36, 10)).astype(np.float32)
    expected = np.asarray(jax_add2d_matmul(jnp.asarray(p), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(K.add2d_matmul(torch.from_numpy(p), torch.from_numpy(w)).numpy(), expected, atol=1e-4)
    np.testing.assert_allclose(K.add2d_matmul_plain(torch.from_numpy(p), torch.from_numpy(w)).numpy(), expected,
                               atol=1e-4)


def test_autograd_matches_jax_grad():
    """Gradients of Add2dMatmul (its plain backward on the CPU) against jax.grad of
    add2d_matmul_ad at 37 x 19 x 23, the shape of tests/test_kernels.py:45-62: atol 1e-5."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=(37, 19)).astype(np.float32)
    w = rng.normal(size=(19, 23)).astype(np.float32)
    g = rng.normal(size=(37, 23)).astype(np.float32)
    jdp, jdw = jax.grad(lambda a, b: jnp.sum(jax_add2d_matmul_ad(a, b, True) * g), argnums=(0, 1))(
        jnp.asarray(p), jnp.asarray(w))
    tp = torch.from_numpy(p).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = K.Add2dMatmul.apply(tp, tw)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jdp), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=1e-5)


def test_gradients_keep_jax_zeros_and_nans():
    """sign(0) = 0 and sign(NaN) = NaN, as jnp.sign in the JAX backward (torch.sign gives
    0 at NaN): with p == w in whole columns and a NaN in p, the port's gradients have
    the zeros and NaNs of jax.grad of add2d_matmul_ad, and agree elsewhere (atol 1e-5)."""
    rng = np.random.default_rng(6)
    p = rng.normal(size=(37, 19)).astype(np.float32)
    w = rng.normal(size=(19, 23)).astype(np.float32)
    g = rng.normal(size=(37, 23)).astype(np.float32)
    p[:, :4] = p[:1, :4]
    w[:4, 7] = p[0, :4]  # p == w in every row: dw[:4, 7] = 0
    p[11, 9] = np.nan  # dw[9, :] and dp[11, 9] are NaN
    jdp, jdw = (np.asarray(t) for t in jax.grad(lambda a, b: jnp.sum(jax_add2d_matmul_ad(a, b, True) * g),
                                                argnums=(0, 1))(jnp.asarray(p), jnp.asarray(w)))
    tp, tw, tg = torch.from_numpy(p), torch.from_numpy(w), torch.from_numpy(g)
    dp, dw = K.add2d_bwd_dp(tp, tw, tg).numpy(), K.add2d_bwd_dw(tp, tw, tg).numpy()
    assert (jdw[:4, 7] == 0).all() and np.isnan(jdw[9]).all() and np.isnan(jdp[11, 9])
    for ours, theirs in ((dp, jdp), (dw, jdw)):
        np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
        np.testing.assert_array_equal(ours == 0, theirs == 0)
        np.testing.assert_allclose(ours, theirs, atol=1e-5)


def test_bf16_dp_at_least_as_accurate_as_jax():
    """A deliberate difference: for bfloat16 operands the JAX backward accumulates dp in
    bfloat16, one rounding a chunk of O (``holocron_tpu/kernels/add2d.py:106``), where
    the port sums in float32 and rounds once (``add2d_bwd_dp_plain``; the card's kernel
    likewise). At L 2048, D 256, O 64 JAX takes four chunks: against a float64 sum of
    the same bf16 values the port's dp is at least as close as jax.vjp's (0.117 against
    0.215 where |dp| <= 36.5), and dw, one float32 sum in both, is equal."""
    l, d, o = 2048, 256, 64
    rng = np.random.default_rng(0)
    p, w, g = (jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(jnp.bfloat16)
               for s in ((l, d), (d, o), (l, o)))
    _, vjp = jax.vjp(lambda a, b: jax_add2d_matmul_ad(a, b, True), p, w)
    jdp, jdw = (np.asarray(t.astype(jnp.float32)) for t in vjp(g))
    pf, wf, gf = (np.array(t.astype(jnp.float32)) for t in (p, w, g))
    ref = np.zeros((l, d))
    for start in range(0, o, 8):
        sign = np.sign(pf[:, :, None].astype(np.float64) - wf[None, :, start : start + 8])
        ref -= np.einsum("lc,ldc->ld", gf[:, start : start + 8].astype(np.float64), sign)
    tp, tw, tg = (torch.from_numpy(t).to(torch.bfloat16) for t in (pf, wf, gf))
    dp, dw = K.add2d_bwd_dp(tp, tw, tg).float().numpy(), K.add2d_bwd_dw(tp, tw, tg).float().numpy()
    port_err, jax_err = np.abs(dp - ref).max(), np.abs(jdp - ref).max()
    assert port_err <= jax_err, (port_err, jax_err)
    np.testing.assert_array_equal(dw, jdw)


def test_plain_versions_chunk_without_changing_results(monkeypatch):
    """With a budget of 3 output columns per chunk the plain forward and backward give
    what one chunk gives: the chunking is over O only, so each entry is the same sum."""
    rng = np.random.default_rng(2)
    p, w, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((37, 19), (19, 23), (37, 23)))
    whole = (K.add2d_matmul_plain(p, w), K.add2d_bwd_dp_plain(p, w, g), K.add2d_bwd_dw_plain(p, w, g))
    monkeypatch.setattr(K, "_BUDGET", 37 * 19 * 3)
    assert K._chunk(37, 19, 23) == 3
    chunked = (K.add2d_matmul_plain(p, w), K.add2d_bwd_dp_plain(p, w, g), K.add2d_bwd_dw_plain(p, w, g))
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("l,d,o,sms,balanced", [
    (12544, 576, 128, 132, True),  # the path's layer: 22 slices, 396 blocks, 3 an SM
    (12544, 100, 70, 132, True),  # D and O not multiples of the 64-wide tile
    (50000, 36, 10, 132, True),  # one tile, 132 slices
    (100000, 64, 64, 132, True),
    (12544, 576, 128, 114, True),  # another SM count
    (50, 36, 10, 132, False),  # too few rows for 132 slices of 64
    (1, 8, 8, 132, False),
    (0, 8, 8, 132, False),
    (12544, 4096, 4096, 132, False),  # 4096 tiles fill the card without slicing
])
def test_dw_slices_cover_l(l, d, o, sms, balanced):
    """The dw plan covers L with slices none of which is empty, and, where L is long
    enough and the tiles alone do not fill the card, gives every SM the same number of
    (tile, slice) blocks, at most three: those it holds at once."""
    slices, rows = K.dw_slices(l, d, o, sms)
    assert slices * rows >= l and (slices - 1) * rows < max(l, 1) and rows >= 1
    blocks = math.ceil(d / 64) * math.ceil(o / 64) * slices
    if balanced:
        assert blocks % sms == 0 and blocks <= 3 * sms and rows >= 64


@pytest.mark.parametrize("normalize_slices", [False, True], ids=["plain", "normalized"])
@pytest.mark.parametrize("padding_mode", ["zeros", "reflect"])
def test_add2d_module_matches_jax(normalize_slices, padding_mode):
    """Add2d(4 -> 6, k3, stride 2, padding 1) on (2, 4, 9, 9), weights carried by
    add2d_state_dict: outputs, and the gradients of the input, weight and bias, atol 1e-4."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 9, 4)).astype(np.float32)
    jmod = hnn.Add2d(6, 3, stride=2, padding=1, padding_mode=padding_mode, normalize_slices=normalize_slices)
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.key(0), x))
    gy = rng.normal(size=jmod.apply(variables, x).shape).astype(np.float32)

    def loss(v, xx):
        return jnp.sum(jmod.apply(v, xx) * gy)

    expected = np.asarray(jmod.apply(variables, x))
    jgv, jgx = jax.grad(loss, argnums=(0, 1))(variables, x)

    pmod = Add2d(4, 6, 3, stride=2, padding=1, padding_mode=padding_mode, normalize_slices=normalize_slices,
                 device="cpu")
    pmod.load_state_dict(convert.add2d_state_dict(variables))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    out = pmod(tx)
    out.backward(torch.from_numpy(gy.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), expected, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jgx), atol=1e-4)
    grads = convert.add2d_state_dict({"params": jgv["params"]})
    np.testing.assert_allclose(pmod.weight.grad.numpy(), grads["weight"].numpy(), atol=1e-4)
    np.testing.assert_allclose(pmod.bias.grad.numpy(), grads["bias"].numpy(), atol=1e-4)


@pytest.mark.parametrize("normalize_slices", [False, True], ids=["plain", "normalized"])
def test_functional_add2d_matches_jax(normalize_slices):
    """F.add2d on NHWC / HWIO against the JAX XLA path (use_pallas=False), stride 2,
    padding 1, dilation 2, with a bias: atol 1e-4."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 11, 10, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    expected = JF.add2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 2, 1, 2, normalize_slices, use_pallas=False)
    out = TF.add2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 2, 1, 2, normalize_slices)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=1e-4)


def test_extract_patches_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 8, 3)).astype(np.float32)
    expected = JF.extract_patches2d(jnp.asarray(x), (3, 2), (2, 1), (1, 0), (1, 2))
    np.testing.assert_array_equal(TF.extract_patches2d(torch.from_numpy(x), (3, 2), (2, 1), (1, 0), (1, 2)).numpy(),
                                  np.asarray(expected))


def test_add2d_keeps_bf16_and_rejects_bad_shapes():
    p = torch.randn(8, 6).to(torch.bfloat16)
    w = torch.randn(6, 4).to(torch.bfloat16)
    out = K.add2d_matmul(p, w)
    assert out.dtype == torch.bfloat16 and out.shape == (8, 4)
    torch.testing.assert_close(out, K.add2d_matmul_plain(p.float(), w.float()).to(torch.bfloat16))
    with pytest.raises(ValueError):
        K.add2d_matmul(p, w[:5])
    with pytest.raises(ValueError):
        K.add2d_bwd_dp(p, w, torch.zeros(8, 3, dtype=torch.bfloat16))


def test_add2d_init_is_seeded_and_bounded():
    a = Add2d(8, 4, 3, device="cpu", generator=torch.Generator().manual_seed(1))
    b = Add2d(8, 4, 3, device="cpu", generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    bound = 1 / (8 * 9) ** 0.5
    assert float(a.weight.detach().abs().max()) <= bound * 3**0.5 and float(a.bias.detach().abs().max()) <= bound
