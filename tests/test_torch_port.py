"""Guards of the PyTorch port: it imports no JAX, its kernels are never launched for
CPU tensors, and ``chip_smoke.py`` refuses to run without a GPU or without the package."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from holocron_tpu_torch import kernels, quant
from holocron_tpu_torch.models import RepVGG
from holocron_tpu_torch.nn import Add2d, Involution2d
from holocron_tpu_torch.trainer import ClassificationTrainer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Every module of the package imports with jax, flax and optax made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import holocron_tpu_torch\n"
        "for info in pkgutil.walk_packages(holocron_tpu_torch.__path__, 'holocron_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "import chip_smoke\n"
        "assert not any(m.startswith('holocron_tpu.') or m == 'holocron_tpu' for m in sys.modules)\n"
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
    assert set(kernels.KERNELS) == {"involution", "involution_bwd_dxp", "involution_bwd_dkern", "add2d_fwd",
                                    "add2d_bwd_dp", "add2d_bwd_dw", "int8_conv"}
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
