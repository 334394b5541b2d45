"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): each is marked
``cuda`` and skips where ``torch.cuda.is_available()`` is false. The file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from holocron_tpu_torch.kernels import add2d as A
from holocron_tpu_torch.kernels import involution as V
from holocron_tpu_torch.kernels.int8_conv import KERNEL as INT8_KERNEL
from holocron_tpu_torch.kernels.int8_conv import int8_conv, int8_conv_acc, int8_conv_acc_plain, int8_conv_plain
from holocron_tpu_torch.kernels.involution import KERNEL as INVOLUTION_KERNEL
from holocron_tpu_torch.kernels.involution import involution_stencil, involution_stencil_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,h,w,c,g,k", [(2, 5, 7, 24, 3, 3), (1, 9, 9, 16, 4, 5), (3, 4, 4, 8, 8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_involution_kernel_matches_plain(cuda, n, h, w, c, g, k, dtype):
    """Both accumulate in float32 in tap order with separate roundings: equal."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    xp = torch.randn(n, h + k - 1, w + k - 1, c, generator=gen, device=cuda).to(dtype)
    kern = torch.randn(n, h, w, k * k * g, generator=gen, device=cuda).to(dtype)
    before = INVOLUTION_KERNEL.launches
    out = involution_stencil(xp, kern, k, g)
    torch.cuda.synchronize()
    assert INVOLUTION_KERNEL.launches == before + 1
    torch.testing.assert_close(out, involution_stencil_plain(xp, kern, k, g), rtol=0, atol=0)


@pytest.mark.parametrize(
    "n,h,w,c,o,ksize,stride,padding,dilation",
    [
        (2, 9, 10, 16, 24, 3, 1, 1, 1),    # fast staging, ragged M and O tiles
        (2, 9, 10, 48, 72, 3, 2, 1, 1),    # fast, stride 2, C not a multiple of the 64-wide step
        (1, 11, 11, 32, 8, 3, 1, 2, 2),    # fast, dilation 2
        (2, 8, 8, 16, 16, 1, 2, 0, 1),     # fast, 1x1 stride 2, K below one step
        (1, 11, 11, 12, 8, 3, 1, 2, 2),    # byte-wise (C % 16 != 0), dilation 2
        (2, 7, 7, 3, 5, 3, 1, 1, 1),       # byte-wise, C = 3 and O % 4 != 0
        (2, 9, 10, 16, 70, 3, 2, 1, 1),    # byte-wise (O % 4 != 0), O across two column tiles
        (1, 14, 14, 192, 192, 3, 1, 1, 1),  # repvgg_a0 stage-3 conv
    ],
)
def test_int8_conv_kernel_matches_plain(cuda, n, h, w, c, o, ksize, stride, padding, dilation):
    """int32 accumulator exact; float32 output within one float32 ulp and bf16 output
    within one bf16 ulp of the plain epilogue."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x_q = torch.randint(-127, 128, (n, h, w, c), generator=gen, device=cuda, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (ksize, ksize, c, o), generator=gen, device=cuda, dtype=torch.int8)
    acc = int8_conv_acc(x_q, w_q, stride, padding, dilation)
    assert torch.equal(acc, int8_conv_acc_plain(x_q, w_q, stride, padding, dilation).contiguous())
    s_x = torch.tensor(0.013, device=cuda)
    w_scale = torch.rand(o, generator=gen, device=cuda) / 127
    for bias in (None, torch.randn(o, generator=gen, device=cuda)):
        for dtype, ulp in ((torch.float32, 2.0**-23), (torch.bfloat16, 2.0**-7)):
            b = None if bias is None else bias.to(dtype)
            got = int8_conv(x_q, w_q, s_x, w_scale, b, stride, padding, dilation, out_dtype=dtype).float()
            ref = int8_conv_plain(x_q, w_q, s_x, w_scale, b, stride, padding, dilation, out_dtype=dtype).float()
            assert bool(((got - ref).abs() <= ref.abs() * ulp).all())


def test_int8_conv_refuses_what_it_does_not_take(cuda):
    x_q = torch.zeros(1, 4, 4, 8, dtype=torch.int8, device=cuda)
    w_q = torch.zeros(3, 3, 8, 8, dtype=torch.int8, device=cuda)
    s_x, w_scale = torch.tensor(1.0, device=cuda), torch.ones(8, device=cuda)
    before = INT8_KERNEL.launches
    with pytest.raises(NotImplementedError):
        int8_conv(x_q, w_q, s_x, w_scale, groups=2)
    with pytest.raises(ValueError):
        int8_conv(x_q, w_q.cpu(), s_x, w_scale)
    with pytest.raises(ValueError):
        int8_conv(x_q.permute(0, 2, 1, 3), w_q, s_x, w_scale)
    assert INT8_KERNEL.launches == before


def _within(got, ref, bound, what):
    err = (got.float() - ref.float()).abs()
    assert bool((err <= bound).all()), f"{what}: max error {float(err.max())}, worst excess {float((err - bound).max())}"


def _add2d_bounds(p, w, g, dtype):
    """Error bounds of the add2d kernels against their plain versions. Forward: a sum of
    D non-negative terms, added in another order: rtol 1e-4. Gradients: signed sums of
    +-g over O (dp) or L (dw), so the rounding grows with sum |g| over that axis
    (about sqrt(n) * 2^-24 * sum |g| in float32): 2e-5 * sum |g|. A bf16 result adds one
    rounding of each side: 2^-7 of the value."""
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 0.0
    gf = g.float().abs()
    fwd = lambda ref: ref.float().abs() * (1e-4 + ulp)  # noqa: E731
    dp = lambda ref: 2e-5 * gf.sum(1, keepdim=True) + ulp * ref.float().abs()  # noqa: E731
    dw = lambda ref: 2e-5 * gf.sum(0, keepdim=True) + ulp * ref.float().abs()  # noqa: E731
    return fwd, dp, dw


@pytest.mark.parametrize("l,d,o", [(50, 36, 10), (130, 70, 67), (1, 9, 3), (12544, 576, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add2d_kernels_match_plain(cuda, l, d, o, dtype):
    """Forward, dp and dw at ragged shapes and at the path's layer (L 12544, D 576, O 128)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    p, w, g = (torch.randn(*s, generator=gen, device=cuda).to(dtype) for s in ((l, d), (d, o), (l, o)))
    fwd, dp, dw = _add2d_bounds(p, w, g, dtype)
    before = [k.launches for k in (A.KERNEL_FWD, A.KERNEL_BWD_DP, A.KERNEL_BWD_DW)]
    out, gp, gw = A.add2d_matmul(p, w), A.add2d_bwd_dp(p, w, g), A.add2d_bwd_dw(p, w, g)
    torch.cuda.synchronize()
    assert [k.launches for k in (A.KERNEL_FWD, A.KERNEL_BWD_DP, A.KERNEL_BWD_DW)] == [b + 1 for b in before]
    assert out.dtype == gp.dtype == gw.dtype == dtype
    ref = A.add2d_matmul_plain(p, w)
    _within(out, ref, fwd(ref), "forward")
    ref = A.add2d_bwd_dp_plain(p, w, g)
    _within(gp, ref, dp(ref), "dp")
    ref = A.add2d_bwd_dw_plain(p, w, g)
    _within(gw, ref, dw(ref), "dw")
    torch.testing.assert_close(A.add2d_bwd_dw(p, w, g), gw, rtol=0, atol=0)  # no atomics: the same every run


def test_add2d_autograd_matches_plain(cuda):
    """Add2dMatmul's gradients on the card against autograd through the plain forward
    (abs differentiates to sign), float32, at a ragged shape."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    p, w, g = (torch.randn(*s, generator=gen, device=cuda) for s in ((77, 45), (45, 19), (77, 19)))
    p1, w1 = p.clone().requires_grad_(), w.clone().requires_grad_()
    A.Add2dMatmul.apply(p1, w1).backward(g)
    p2, w2 = p.clone().requires_grad_(), w.clone().requires_grad_()
    (-(p2[:, :, None] - w2[None]).abs().sum(1)).backward(g)
    _, dp, dw = _add2d_bounds(p, w, g, torch.float32)
    _within(p1.grad, p2.grad, dp(p2.grad), "dp")
    _within(w1.grad, w2.grad, dw(w2.grad), "dw")


@pytest.mark.parametrize("n,h,w,c,g,k", [(2, 5, 7, 24, 3, 3), (1, 9, 9, 16, 4, 5), (2, 6, 6, 64, 4, 3),
                                         (3, 4, 4, 32, 32, 1), (32, 56, 56, 128, 8, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_involution_backward_kernels_match_plain(cuda, n, h, w, c, g, k, dtype):
    """dxp: the same tap order and roundings, so equal. dkern: the group's channels are
    summed in another order (a warp butterfly where cg divides 32, else in order):
    within 1e-5 of sum |xp * g| over the group, plus one bf16 rounding of each side."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    xp = torch.randn(n, h + k - 1, w + k - 1, c, generator=gen, device=cuda).to(dtype)
    kern = torch.randn(n, h, w, k * k * g, generator=gen, device=cuda).to(dtype)
    gout = torch.randn(n, h, w, c, generator=gen, device=cuda).to(dtype)
    before = (V.KERNEL_DXP.launches, V.KERNEL_DKERN.launches)
    dxp, dkern = V.involution_bwd_dxp(xp, kern, gout, k, g), V.involution_bwd_dkern(xp, kern, gout, k, g)
    torch.cuda.synchronize()
    assert (V.KERNEL_DXP.launches, V.KERNEL_DKERN.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(dxp, V.involution_bwd_dxp_plain(xp, kern, gout, k, g), rtol=0, atol=0)
    ref = V.involution_bwd_dkern_plain(xp, kern, gout, k, g)
    absterms = V.involution_bwd_dkern_plain(xp.float().abs(), kern.float(), gout.float().abs(), k, g)
    ulp = 2.0**-7 if dtype == torch.bfloat16 else 0.0
    _within(dkern, ref, 1e-5 * absterms + ulp * ref.float().abs(), "dkern")


def test_involution_autograd_matches_plain(cuda):
    """InvolutionStencil's gradients on the card against autograd through the plain
    forward, float32."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    n, h, w, c, g, k = 2, 7, 6, 32, 4, 3
    xp = torch.randn(n, h + k - 1, w + k - 1, c, generator=gen, device=cuda)
    kern = torch.randn(n, h, w, k * k * g, generator=gen, device=cuda)
    gout = torch.randn(n, h, w, c, generator=gen, device=cuda)
    a, b = xp.clone().requires_grad_(), kern.clone().requires_grad_()
    V.InvolutionStencil.apply(a, b, k, g).backward(gout)
    a2, b2 = xp.clone().requires_grad_(), kern.clone().requires_grad_()
    V.involution_stencil_plain(a2, b2, k, g).backward(gout)
    torch.testing.assert_close(a.grad, a2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b.grad, b2.grad, rtol=1e-5, atol=1e-5)


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    p = torch.zeros(4, 3, device=cuda)
    w = torch.zeros(3, 2, device=cuda)
    with pytest.raises(ValueError):
        A.add2d_matmul(p, w.cpu())
    with pytest.raises(TypeError):
        A.add2d_matmul(p, w.half())
    xp = torch.zeros(1, 4, 4, 4, device=cuda)
    kern = torch.zeros(1, 2, 2, 9 * 2, device=cuda)
    with pytest.raises(ValueError):
        V.involution_bwd_dxp(xp, kern, torch.zeros(1, 2, 2, 3, device=cuda), 3, 2)
