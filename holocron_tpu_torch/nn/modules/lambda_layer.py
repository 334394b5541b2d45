"""Lambda layer (``holocron_tpu/nn/modules/lambda_layer.py``,
`LambdaNetworks <https://openreview.net/pdf?id=xTJEN-ggl1b>`_), on NCHW tensors."""

from typing import Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from ..init import kaiming_normal_
from ._norm import FlaxBatchNorm2d

__all__ = ["LambdaLayer"]


class LambdaLayer(nn.Module):
    """Lambda layer (``lambda_layer.py:18-95``): long-range interactions through content
    and position lambdas instead of attention maps.

    Queries, keys and values come from bias-free 1x1 convs (``to_q``, ``to_k``,
    ``to_v``; q and v batch-normalized), keys are softmaxed over positions, the content
    lambda contracts the positions, and the position lambda is a local ``r x r`` conv
    over the values (``R``, ``(dim_k, dim_u, r, r)``, as a torch conv weight) or a
    learned ``(n, n, dim_k, dim_u)`` embedding (``pos_emb``). The channels split as the
    JAX package's NHWC reshapes: q head-major ``(heads, dim_k)``, k and v dim-major
    ``(dim_k, dim_u)`` and ``(dim_v, dim_u)``; the NCHW tensors are permuted to NHWC
    before each reshape.

    Weights are drawn from ``generator`` on the CPU (fan-out He-normal convs, unit
    normal ``R`` and ``pos_emb``), then the module moves to ``device``: the card unless
    the caller asks for the CPU. The norms are flax's (:class:`FlaxBatchNorm2d`),
    momentum 0.1 in torch's convention.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        dim_k: int,
        n: Optional[int] = None,
        r: Optional[int] = None,
        num_heads: int = 4,
        dim_u: int = 1,
        device: Union[str, torch.device] = torch.device("cuda"),
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if out_channels % num_heads != 0:
            raise AssertionError("values dimension must be divisible by number of heads for multi-head query")
        if r is not None and r % 2 != 1:
            raise AssertionError("Receptive kernel size should be odd")
        if r is None and n is None:
            raise AssertionError("You must specify the total sequence length (h x w)")
        self.dim_k, self.dim_u, self.num_heads, self.r = dim_k, dim_u, num_heads, r
        self.dim_v = out_channels // num_heads
        self.to_q = nn.Conv2d(in_channels, dim_k * num_heads, 1, bias=False)
        self.to_k = nn.Conv2d(in_channels, dim_k * dim_u, 1, bias=False)
        self.to_v = nn.Conv2d(in_channels, self.dim_v * dim_u, 1, bias=False)
        for conv in (self.to_q, self.to_k, self.to_v):
            kaiming_normal_(conv.weight, generator=generator)
        self.norm_q = FlaxBatchNorm2d(dim_k * num_heads)
        self.norm_v = FlaxBatchNorm2d(self.dim_v * dim_u)
        if r is not None:
            self.R = nn.Parameter(torch.randn(dim_k, dim_u, r, r, generator=generator))
        else:
            self.pos_emb = nn.Parameter(torch.randn(n, n, dim_k, dim_u, generator=generator))
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        pos, heads, dk, u, dv = h * w, self.num_heads, self.dim_k, self.dim_u, self.dim_v

        def tokens(t: torch.Tensor, *split: int) -> torch.Tensor:  # NCHW -> (b, positions, *split)
            return t.permute(0, 2, 3, 1).reshape(b, pos, *split)

        q = tokens(self.norm_q(self.to_q(x)), heads, dk)
        k = F.softmax(tokens(self.to_k(x), dk, u), dim=1)
        v = tokens(self.norm_v(self.to_v(x)), dv, u)

        lam_c = torch.einsum("bmku,bmvu->bkv", k, v)
        y_c = torch.einsum("bnhk,bkv->bnhv", q, lam_c)
        if self.r is not None:
            # a conv over (h, w) from dim_u to dim_k channels, one per value channel
            v_b = v.reshape(b, h, w, dv, u).permute(0, 3, 4, 1, 2).reshape(b * dv, u, h, w)
            lam_p = F.conv2d(v_b, self.R, padding=self.r // 2)  # (b * dv, dk, h, w)
            lam_p = lam_p.reshape(b, dv, dk, pos).permute(0, 3, 2, 1)  # b n k v
        else:
            lam_p = torch.einsum("nmku,bmvu->bnkv", self.pos_emb, v)
        y = y_c + torch.einsum("bnhk,bnkv->bnhv", q, lam_p)
        return y.reshape(b, h, w, heads * dv).permute(0, 3, 1, 2)
