"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): each is marked
``cuda`` and skips where ``torch.cuda.is_available()`` is false. The file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

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
