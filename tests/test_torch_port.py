"""Guards of the PyTorch port: it imports no JAX, its kernels are never launched for
CPU tensors, and ``chip_smoke.py`` refuses to run without a GPU or without the package."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from holocron_tpu_torch import kernels, models, nn, quant
from holocron_tpu_torch.models import (
    Bottleneck,
    RepVGG,
    ResNet,
    ReXNet,
    pyconv_resnet50,
    resnet50,
    resnext101_32x8d,
    sknet50,
    tridentnet50,
)
from holocron_tpu_torch.nn import Add2d, Involution2d, PyConv2d
from holocron_tpu_torch.trainer import ClassificationTrainer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Every module of the package (the service, the benches, the captured forward, the
    darknets, the detectors, TAdam, the detection trainer, the segmentation models,
    trainer, optimizers, data, transforms and CLI among them), and
    chip_smoke.py, imports with jax, flax, optax and the JAX package
    made unimportable, and imports neither PIL nor fastapi (each is imported where it
    is used)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'holocron_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import holocron_tpu_torch\n"
        "for info in pkgutil.walk_packages(holocron_tpu_torch.__path__, 'holocron_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "import chip_smoke\n"
        "assert not any(sys.modules[m] is not None for m in sys.modules\n"
        "               if m.startswith('holocron_tpu.') or m == 'holocron_tpu')\n"
        "assert 'holocron_tpu_torch.ops.boxes' in sys.modules and 'holocron_tpu_torch.nn.modules.loss' in sys.modules\n"
        "assert all(m in sys.modules for m in ('holocron_tpu_torch.bench', 'holocron_tpu_torch.bench_serving',\n"
        "    'holocron_tpu_torch.models.core', 'holocron_tpu_torch.api.main', 'holocron_tpu_torch.api.vision',\n"
        "    'holocron_tpu_torch.api.batcher', 'holocron_tpu_torch.utils.data._native'))\n"
        "assert all(m in sys.modules for m in ('holocron_tpu_torch.models.classification.darknet',\n"
        "    'holocron_tpu_torch.models.classification.darknetv2', 'holocron_tpu_torch.models.classification.darknetv3',\n"
        "    'holocron_tpu_torch.models.classification.darknetv4', 'holocron_tpu_torch.models.detection._utils',\n"
        "    'holocron_tpu_torch.models.detection.yolo', 'holocron_tpu_torch.models.detection.yolov2',\n"
        "    'holocron_tpu_torch.models.detection.yolov4', 'holocron_tpu_torch.optim.tadam',\n"
        "    'holocron_tpu_torch.trainer.detection'))\n"
        "assert all(m in sys.modules for m in ('holocron_tpu_torch.models.segmentation.unet',\n"
        "    'holocron_tpu_torch.models.segmentation.encoders', 'holocron_tpu_torch.models.segmentation.unetpp',\n"
        "    'holocron_tpu_torch.models.segmentation.unet3p', 'holocron_tpu_torch.trainer.segmentation',\n"
        "    'holocron_tpu_torch.optim.adamp', 'holocron_tpu_torch.optim.adabelief',\n"
        "    'holocron_tpu_torch.utils.data.loader', 'holocron_tpu_torch.transforms.interpolation',\n"
        "    'holocron_tpu_torch.references.segmentation.train'))\n"
        "assert 'PIL' not in sys.modules and 'fastapi' not in sys.modules\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_cpu_tensors_never_launch_a_kernel():
    """On CPU tensors the wrappers take the plain versions, forward and backward: every
    launch count stays 0, and importing and running built nothing."""
    for k in kernels.KERNELS.values():
        k.launches = 0
    g = torch.Generator().manual_seed(0)
    inv = Involution2d(16, 3, padding=1, groups=4, reduction_ratio=2, generator=g, device="cpu")
    x = torch.randn(2, 16, 12, 12, generator=g, requires_grad=True)
    inv(x).sum().backward()
    add = Add2d(16, 8, 3, padding=1, generator=g, device="cpu")
    add(x).sum().backward()
    with torch.no_grad():
        model = RepVGG([1, 1], [8, 16], 1.0, 1.0, generator=g, device="cpu").reparametrize().eval()
        qm = quant.quantize_model(model, min_in_channels=8)
        qm(torch.randn(2, 3, 32, 32, generator=g))
        resnet = ResNet(Bottleneck, [1, 1], [8, 16], generator=g, device="cpu").eval()
        qr = quant.quantize_model(resnet, calibration_batches=[torch.randn(2, 3, 32, 32, generator=g)],
                                  min_in_channels=8)
        assert sum(isinstance(m, quant.QuantizedConv2d) for m in qr.modules()) == 8  # every conv but the stem
        qr(torch.randn(2, 3, 32, 32, generator=g))
        # every route: the wgmma, halo and pointwise convs above and here, a grouped conv below
        rexnet = ReXNet(0.5, 0.5, num_classes=10, generator=g, device="cpu").eval()
        quant.quantize_model(rexnet, min_in_channels=16)(torch.randn(2, 3, 32, 32, generator=g))
        resnext = ResNet(Bottleneck, [1], [16], block_args={"groups": 2}, width_per_group=128, generator=g,
                         device="cpu").eval()
        qx = quant.quantize_model(resnext, min_in_channels=32)
        assert any(isinstance(m, quant.QuantizedConv2d) and m.groups == 2 for m in qx.modules())
        qx(torch.randn(2, 3, 32, 32, generator=g))
    assert set(kernels.KERNELS) == {"involution", "involution_general", "involution_bwd_dxp", "involution_bwd_dkern",
                                    "involution_bwd_dxp_general", "involution_bwd_dkern_general", "add2d_fwd",
                                    "add2d_bwd_dp", "add2d_bwd_dw", "int8_conv", "int8_conv_halo", "int8_pointwise",
                                    "int8_conv_general", "int8_quantize"}
    assert all(k.launches == 0 for k in kernels.KERNELS.values())
    assert all(k._fn is None for k in kernels.KERNELS.values())


def test_port_reads_no_file_of_the_jax_package():
    """No module of the port names the JAX package's directory (it once read
    quant_policy.json from there); its policy copy is its own."""
    for path in (ROOT / "holocron_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert '"holocron_tpu"' not in text and "'holocron_tpu'" not in text, path
    assert quant.selection_policy("repvgg_a0") == {"min_in_channels": 48}
    assert quant.selection_policy("resnet18") is None


def test_entry_points_default_to_the_card():
    """Without device="cpu" the port's entry points go to CUDA, and raise where there is
    none, as torch itself does; there is no quiet CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults succeed here")
    model = RepVGG([1], [8], 1.0, 1.0, device="cpu")
    for build in (
        lambda: RepVGG([1], [8], 1.0, 1.0),
        lambda: Involution2d(8, 3, padding=1, groups=2),
        lambda: Add2d(8, 8, 3),
        lambda: ClassificationTrainer(model),
        lambda: ResNet(Bottleneck, [1], [8]),
        lambda: resnet50(),
        lambda: sknet50(),
        lambda: tridentnet50(),
        lambda: pyconv_resnet50(),
        lambda: PyConv2d(8, 8, 3, 2, 1),
        lambda: ReXNet(0.5, 0.5),
        *(lambda arch=arch: getattr(models, arch)() for arch in ("rexnet1_0x", "rexnet1_3x", "rexnet1_5x", "rexnet2_0x",
                                                                 "rexnet2_2x")),
        lambda: resnext101_32x8d(),
        lambda: models.MobileOne([1, 1, 1, 1], [0.125] * 4),
        lambda: models.ConvNeXt([1, 1], [8, 16]),
        lambda: nn.FReLU(8),
        lambda: nn.SAM(8),
        lambda: nn.DimAttention(2),
        lambda: nn.TripletAttention(),
        lambda: nn.LambdaLayer(8, 8, 4, r=3),
        lambda: nn.LambdaLayer(8, 8, 4, n=16),
        lambda: nn.NormConv2d(8, 8, 3),
        lambda: nn.SlimConv2d(8),
        lambda: nn.FocalLoss(weight=[1.0, 2.0]),
        lambda: nn.ComplementCrossEntropy(weight=0.3),
        lambda: nn.MultiLabelCrossEntropy(weight=[1.0, 2.0]),
        lambda: nn.MutualChannelLoss(weight=[1.0, 2.0]),
        lambda: nn.DiceLoss(weight=[1.0, 2.0]),
        lambda: nn.PolyLoss(weight=[1.0, 2.0]),
        lambda: nn.ClassBalancedWrapper(nn.FocalLoss(device="cpu"), [10, 20]),
    ):
        with pytest.raises((AssertionError, RuntimeError)):
            build()


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_gpu(tmp_path):
    """Without a CUDA device (as here), and alone in a directory, the script exits
    non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real here")
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        res = _run_smoke(cwd)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
