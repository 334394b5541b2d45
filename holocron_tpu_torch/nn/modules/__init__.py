from .activation import FReLU, HardMish, NLReLU
from .attention import SAM, DimAttention, TripletAttention
from .conv import Add2d, Involution2d, NormConv2d, PyConv2d, SlimConv2d
from .downsample import SPP, BlurPool2d, ConcatDownsample2d, GlobalAvgPool2d, GlobalMaxPool2d, ZPool
from .dropblock import DropBlock2d
from .lambda_layer import LambdaLayer
from .loss import (
    ClassBalancedWrapper,
    ComplementCrossEntropy,
    DiceLoss,
    FocalLoss,
    MultiLabelCrossEntropy,
    MutualChannelLoss,
    PolyLoss,
)

__all__ = [
    "SAM",
    "SPP",
    "Add2d",
    "BlurPool2d",
    "ClassBalancedWrapper",
    "ComplementCrossEntropy",
    "ConcatDownsample2d",
    "DiceLoss",
    "DimAttention",
    "DropBlock2d",
    "FReLU",
    "FocalLoss",
    "GlobalAvgPool2d",
    "GlobalMaxPool2d",
    "HardMish",
    "Involution2d",
    "LambdaLayer",
    "MultiLabelCrossEntropy",
    "MutualChannelLoss",
    "NLReLU",
    "NormConv2d",
    "PolyLoss",
    "PyConv2d",
    "SlimConv2d",
    "TripletAttention",
    "ZPool",
]
