"""The batch norm of the JAX package's nn modules."""

import torch
from torch import nn
from torch.nn import functional as F


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm``, which the JAX package's catalog modules use directly
    (``FReLU``, ``DimAttention``, ``LambdaLayer``, ``SlimConv2d``): torch's module but for
    the running variance, which moves towards the biased batch variance (torch's takes
    the unbiased one). ``momentum`` is torch's (flax's 0.9 is 0.1 here)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
