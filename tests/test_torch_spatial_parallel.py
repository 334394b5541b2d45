"""Spatial partitioning of the port (``holocron_tpu_torch/parallel/spatial.py``) against the
JAX package's (``holocron_tpu/parallel/spatial.py``), on the CPU.

One spawn of 2 gloo processes (``tests/torch_mp_worker.py`` ``sp``), as
``tests/test_parallel.py:194-286`` does for JAX: ``UNet([8, 16], num_classes=4)`` at 64 px
with the output gathered and left as each rank's rows; the RepVGG classifier at 64 rows
and at a ragged 67 (blocks of 34 and 33); the train step's loss and gradients, each
rank holding its rows of the image and the mask (the gradients averaged over the
processes, the data-parallel rule); the error for an axis the mesh lacks. One spawn of 4
processes: DP x SP on a ``("data", "spatial")`` mesh and DP x TP on a ``("data",
"model")`` one. Each against the one-process port
and JAX's ``shard_spatial_inference`` over its 8 CPU devices (JAX's one-device step for
the gradients), on the same weights (converted) and inputs (a numpy seed), at JAX's
tests' tolerances: 1e-5 for outputs, rtol 1e-4 / atol 1e-5 for gradients.
"""

import jax
import numpy as np
import pytest
import torch

import torch_mp_worker as W
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu.models.segmentation.unet import UNet as JaxUNet
from holocron_tpu.nn import functional as JF
from holocron_tpu.parallel import create_mesh as jax_mesh
from holocron_tpu.parallel import shard_inference as jax_shard_inference
from holocron_tpu.parallel import shard_spatial_inference as jax_shard_spatial
from holocron_tpu_torch import convert
from holocron_tpu_torch.models.segmentation import UNet
from holocron_tpu_torch.nn import functional as HF

torch.set_num_threads(2)

ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    """JAX's models and sharded forwards, the port's copies run by 2 and by 4 gloo
    processes, the one-process port's train step and JAX's."""
    outdir = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    xs = {64: rng.normal(size=(2, 64, 64, 3)).astype(np.float32), 67: rng.normal(size=(2, 67, 64, 3)).astype(np.float32)}
    x_step = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y_step = rng.integers(0, 4, size=(2, 32, 32))
    unet = Model(JaxUNet([8, 16], num_classes=4)).init((2, 64, 64, 3), key=jax.random.key(0))
    jax_out = {"unet": jax_shard_spatial(unet)(x), "unet_rows": jax_shard_spatial(unet, gather_output=False)(x),
               "dpsp": jax_shard_spatial(unet, jax_mesh(axes=("data", "spatial"), model_parallel=4),
                                         batch_axis="data")(x)}
    port_unet = UNet([8, 16], num_classes=4, device="cpu")
    models = {"unet": convert.segmentation_state_dict(jax.tree.map(np.asarray, unet.variables), port_unet)}
    for h, xc in xs.items():
        clf = Model(JaxRepVGG([1, 1], [8, 16], 1.0, 2.0, num_classes=8)).init((2, h, 64, 3), key=jax.random.key(h))
        clf(xc, train=True)
        jax_out[f"repvgg{h}"] = jax_shard_spatial(clf)(xc)
        if h == 64:
            jax_out["dptp"] = jax_shard_inference(clf, jax_mesh(axes=("data", "model"), model_parallel=4),
                                                  tensor_parallel=True, min_channels=8)(xc)
        models[f"repvgg{h}"] = convert.repvgg_state_dict(jax.tree.map(np.asarray, clf.variables))
    jax_out = {k: np.asarray(v) for k, v in jax_out.items()}

    # the train step in one process: JAX's (tests/test_parallel.py:242-286) and the port's
    def loss_fn(params, xb, yb):
        return JF.cross_entropy(unet.module.apply({"params": params}, xb, train=True), yb)

    jax_loss, jax_grads = jax.value_and_grad(loss_fn)(unet.variables["params"], x_step, y_step)
    port_unet.load_state_dict(models["unet"])
    port_unet.train()
    y_t = torch.from_numpy(y_step)
    loss = HF.cross_entropy(port_unet(_nchw(x_step)).permute(0, 2, 3, 1), y_t)
    names, params = zip(*port_unet.named_parameters())
    one_step = {"loss": loss.detach(), "grads": dict(zip(names, torch.autograd.grad(loss, params)))}
    jax_step = {"loss": float(jax_loss),
                "grads": convert.segmentation_state_dict({"params": jax.tree.map(np.asarray, jax_grads)}, port_unet)}

    torch.save({"models": models, "x_unet": _nchw(x), "x64": _nchw(xs[64]), "x67": _nchw(xs[67]),
                "x_step": _nchw(x_step), "y_step": y_t}, outdir / "inputs.pt")
    W.run_workers("sp", 2, outdir)
    two = [torch.load(outdir / f"sp_{r}.pt", weights_only=False) for r in range(2)]
    W.run_workers("sp", 4, outdir)
    four = [torch.load(outdir / f"sp_{r}.pt", weights_only=False) for r in range(4)]
    return jax_out, two, four, one_step, jax_step


@pytest.mark.parametrize("name", ["unet", "repvgg64", "repvgg67"])
def test_spatial_inference_equals_one_process_and_jax(sp_run, name):
    """H split over 2 processes (the classifier's 67 rows as 34 and 33): every rank
    returns the one-process output and JAX's sharded one."""
    jax_out, two, _, _, _ = sp_run
    for res in two:
        r = res[name]
        torch.testing.assert_close(r["sp"], r["one"], rtol=0, atol=ATOL)
        got = r["sp"].numpy()
        np.testing.assert_allclose(got.transpose(0, 2, 3, 1) if got.ndim == 4 else got, jax_out[name], atol=ATOL)


def test_spatial_output_left_split(sp_run):
    """``gather_output=False``: each rank returns its own rows of the output (JAX leaves
    the array sharded), which never come whole anywhere."""
    jax_out, two, _, _, _ = sp_run
    for rank, res in enumerate(two):
        rows = res["unet"]["rows"]
        assert tuple(rows.shape) == (2, 4, 32, 64)
        np.testing.assert_allclose(rows.numpy().transpose(0, 2, 3, 1), jax_out["unet_rows"][:, 32 * rank: 32 * rank + 32],
                                   atol=ATOL)


def test_missing_axis_raises(sp_run):
    _, two, _, _, _ = sp_run
    assert all("mesh has no 'data' axis" in res["missing_axis"] for res in two)


def test_spatial_train_step_equals_one_process_and_jax(sp_run):
    """The loss and the gradients of a step through the split forward (the halo
    exchanges' backward sends the rows' gradients back to their owners; the reductions'
    backward sums over the group; each rank's gradients averaged over the processes):
    the one-process step's and JAX's."""
    _, two, _, one_step, jax_step = sp_run
    for res in two:
        step = res["step"]
        torch.testing.assert_close(step["loss"], one_step["loss"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(float(step["loss"]), jax_step["loss"], rtol=1e-5)
        assert set(step["grads"]) == set(one_step["grads"])
        for k, g in step["grads"].items():
            torch.testing.assert_close(g, one_step["grads"][k], rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=k)
            np.testing.assert_allclose(g.numpy(), jax_step["grads"][k].numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=k)


def test_dp_x_sp_and_dp_x_tp_in_four_processes(sp_run):
    """2 x 2 processes: a ``("data", "spatial")`` mesh (the batch over ``data``, the rows
    over ``spatial``) and a ``("data", "model")`` one (tensor parallelism, JAX's 1e-4);
    every rank returns the whole output, the one-process port's and JAX's DP x SP and
    DP x TP forwards'."""
    jax_out, _, four, _, _ = sp_run
    for res in four:
        r = res["dpsp"]
        torch.testing.assert_close(r["sp"], r["one"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(r["sp"].numpy().transpose(0, 2, 3, 1), jax_out["dpsp"], atol=ATOL)
        r = res["dptp"]
        torch.testing.assert_close(r["tp"], r["one"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["tp"].numpy(), jax_out["dptp"], atol=1e-4)
