"""Tensor parallelism of the port (``holocron_tpu_torch/parallel/inference.py``) against the
JAX package's (``holocron_tpu/parallel/inference.py``), on the CPU.

In this process: ``tensor_parallel_specs`` splits exactly the tensors JAX's rule splits,
matched by name through ``holocron_tpu_torch.convert`` (each JAX leaf marked with its own
value before conversion). In one spawn of 2 gloo processes (``tests/torch_mp_worker.py``
``tp``): ``shard_inference(tensor_parallel=True)`` on RepVGG's train and deploy forms and
on ConvNeXt, ``head_tensor_parallel``, and the int8 ``QuantizedModel`` (the plain int8
path on the CPU), each against the one-process port and JAX's ``shard_inference`` over
a ``("data", "model")`` mesh of its 8 CPU devices, on the same weights (converted) and
inputs (a numpy seed); and the channel gather whose backward is the local slice, whose
gradient is the one-process one where the reduce-scatter backward of ``all_gather``
gives twice as much. Tolerances: JAX's tests' 1e-4 for tensor-parallel logits, and the
int8 parity tests' 1e-3 against JAX's int8 logits (``tests/test_torch_quant.py``).
"""

import jax
import numpy as np
import pytest
import torch

import torch_mp_worker as W
from holocron_tpu.models.classification.convnext import ConvNeXt as JaxConvNeXt
from holocron_tpu.models.classification.repvgg import RepVGG as JaxRepVGG
from holocron_tpu.models.core import Model
from holocron_tpu.parallel import create_mesh as jax_mesh
from holocron_tpu.parallel import shard_inference as jax_shard_inference
from holocron_tpu.parallel import tensor_parallel_specs as jax_specs
from holocron_tpu.quant import quantize_model as jax_quantize
from holocron_tpu_torch import convert
from holocron_tpu_torch.models import RepVGG
from holocron_tpu_torch.models.classification.convnext import ConvNeXt
from holocron_tpu_torch.parallel import tensor_parallel_specs

torch.set_num_threads(2)

TP_ATOL, INT8_ATOL = 1e-4, 1e-3


class TwoWayMesh:
    """A ``("data", "model")`` mesh's names and sizes, all the rule reads (a real one needs
    a process group)."""

    mesh_dim_names = ("data", "model")

    def size(self, dim: int) -> int:
        return (1, 2)[dim]


def _marked(variables):
    """``variables`` with leaf ``i`` filled with ``i + 1``, and the leaves."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    return jax.tree_util.tree_unflatten(treedef, [np.full(np.shape(v), i + 1, np.float32)
                                                  for i, v in enumerate(leaves)]), leaves


@pytest.mark.parametrize("family,min_channels", [("repvgg", 8), ("convnext", 16)])
def test_specs_split_the_tensors_jax_splits(family, min_channels):
    """The same tensors split in both packages (``tests/test_parallel.py:160-191``): the
    port's per-output-channel dimension at 0 (OIHW, ``Linear`` ``(out, in)``, norm
    vectors), JAX's trailing one; at least the wide kernels split."""
    if family == "repvgg":
        jm = Model(JaxRepVGG([1, 1], [8, 16], 1.0, 2.0, num_classes=8)).init((2, 32, 32, 3))
        pm = RepVGG([1, 1], [8, 16], 1.0, 2.0, num_classes=8, device="cpu")
        sd = lambda v: convert.repvgg_state_dict(v)  # noqa: E731
    else:
        jm = Model(JaxConvNeXt([1, 1], [16, 32], num_classes=8)).init((2, 32, 32, 3))
        pm = ConvNeXt([1, 1], [16, 32], num_classes=8, device="cpu")
        sd = lambda v: convert.convnext_state_dict(v, pm)  # noqa: E731
    mesh = jax_mesh(axes=("data", "model"), model_parallel=2)
    theirs = [s.spec != jax.sharding.PartitionSpec() for s in jax.tree_util.tree_leaves(
        jax_specs(jm.variables, mesh, min_channels=min_channels))]
    marked, leaves = _marked(jax.tree.map(np.asarray, jm.variables))
    ours = tensor_parallel_specs(pm, TwoWayMesh(), min_channels=min_channels)
    matched = 0
    for name, t in sd(marked).items():
        split = str(ours[name].placements[1]) != "R"
        values = torch.unique(t)
        if t.ndim == 0 or values.numel() != 1 or float(values[0]) < 1:
            assert not split, name  # no JAX counterpart (num_batches_tracked)
            continue
        source = int(values[0]) - 1
        assert split == theirs[source], (name, t.shape, np.shape(leaves[source]))
        if split:
            assert ours[name].placements[1].dim == 0 and t.shape[0] >= min_channels
        matched += 1
    assert matched == len(leaves) and sum(theirs) >= 4


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The JAX models and their sharded forwards on a (4, 2) mesh, the port's copies
    run by 2 gloo processes."""
    outdir = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    calib = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    mesh = jax_mesh(axes=("data", "model"), model_parallel=2)
    rep = Model(JaxRepVGG([1, 1], [8, 16], 1.0, 2.0, num_classes=8)).init((8, 32, 32, 3), key=jax.random.key(0))
    rep(x, train=True)  # batch statistics that are not the initial ones
    cnx = Model(JaxConvNeXt([1, 1], [16, 32], num_classes=8)).init((8, 32, 32, 3), key=jax.random.key(1))
    variables = {"repvgg": jax.tree.map(np.asarray, rep.variables), "convnext": jax.tree.map(np.asarray, cnx.variables)}
    jax_out = {"repvgg": jax_shard_inference(rep, mesh, tensor_parallel=True, min_channels=8)(x),
               "convnext": jax_shard_inference(cnx, mesh, tensor_parallel=True, min_channels=16)(x)}
    rep.reparametrize()
    variables["repvgg_deploy"] = jax.tree.map(np.asarray, rep.variables)
    jax_out["repvgg_deploy"] = jax_shard_inference(rep, mesh, tensor_parallel=True, min_channels=8)(x)
    jax_out["head"] = jax_shard_inference(rep, mesh, head_tensor_parallel=True)(x)
    qm = jax_quantize(rep, calibration_batches=[calib], min_in_channels=8)
    jax_out["int8"] = jax_shard_inference(qm, mesh, tensor_parallel=True, min_channels=8)(x)
    jax_out = {k: np.asarray(v) for k, v in jax_out.items()}
    deploy = RepVGG([1, 1], [8, 16], 1.0, 2.0, num_classes=8, device="cpu").reparametrize()
    cnx_port = ConvNeXt([1, 1], [16, 32], num_classes=8, device="cpu")
    models = {"repvgg": convert.repvgg_state_dict(variables["repvgg"]),
              "repvgg_deploy": convert.repvgg_state_dict(variables["repvgg_deploy"]),
              "convnext": convert.convnext_state_dict(variables["convnext"], cnx_port)}
    del deploy
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    torch.save({"models": models, "x": nchw(x), "calib": nchw(calib)}, outdir / "inputs.pt")
    W.run_workers("tp", 2, outdir)
    return jax_out, [torch.load(outdir / f"tp_{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("name", ["repvgg", "repvgg_deploy", "convnext", "head"])
def test_shard_inference_equals_one_process_and_jax(tp_run, name):
    """Every rank returns the whole logits: the one-process port's and JAX's sharded
    forward's; under ``tensor_parallel`` each rank holds half of every split tensor,
    under ``head_tensor_parallel`` of the head alone."""
    jax_out, ranks = tp_run
    for res in ranks:
        r = res[name]
        torch.testing.assert_close(r["tp"], r["one"], rtol=0, atol=TP_ATOL)
        np.testing.assert_allclose(r["tp"].numpy(), jax_out[name], atol=TP_ATOL)
        if name == "head":
            assert r["blocks"] == ["head.bias", "head.weight"]
        else:
            assert r["blocks"] > 4 and r["halves"]


def test_int8_shard_inference_equals_one_process_and_jax(tp_run):
    """The int8 form under tensor parallelism (each rank's int8 kernels and scales its
    block of the output channels): the one-process int8 logits, and JAX's within the
    int8 parity tolerance, with the same top-1."""
    jax_out, ranks = tp_run
    for res in ranks:
        r = res["int8"]
        assert r["kernels"], "no int8 kernel was split"
        torch.testing.assert_close(r["tp"], r["one"], rtol=0, atol=TP_ATOL)
        np.testing.assert_allclose(r["tp"].numpy(), jax_out["int8"], atol=INT8_ATOL)
        np.testing.assert_array_equal(r["tp"].argmax(1).numpy(), jax_out["int8"].argmax(-1))


def test_replicated_gather_backward_is_the_local_slice(tp_run):
    """After a column-parallel layer whose whole output is replicated, the gather whose
    backward keeps the local slice gives each rank its block's one-process gradient;
    ``all_gather``'s reduce-scatter backward gives model_parallel (2) times as much."""
    _, ranks = tp_run
    for res in ranks:
        g = res["gather_grad"]
        torch.testing.assert_close(g["replicated"], g["one"], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(g["all_gather"], 2 * g["one"], rtol=1e-6, atol=1e-6)
