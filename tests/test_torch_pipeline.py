"""GPipe (``holocron_tpu_torch.parallel.pipeline``) against the JAX package's, on the CPU.

The same inputs, drawn with numpy from a seed, go through the JAX package's
``pipeline_blocks`` / ``pipeline_module`` on the 8-device CPU mesh of
``tests/conftest.py`` and through the port's in gloo processes, one stage a process
(``tests/torch_mp_worker.py``'s ``pipeline`` mode; one spawn of 4 and one of 2 for every
case):

- ``tests/test_parallel.py:289``'s residual conv stack (S = 8, C = 4, x 8 x 8 x 8 x 4,
  NHWC there and NCHW here), at n = 4, M = 8 and n = 2, M = 2 and 8: each process's rows
  of the output and the gathered output within atol 1e-5, the gradients of the global
  sum of squares (each process's blocks of the stacked parameters, its rows of x) within
  rtol 1e-4, atol 1e-5;
- darknet53's 512-channel stage with weights carried from JAX by
  ``convert.darknet_state_dict`` (``:362``'s size: batch 8, 64 px, so a 4 x 4 stage
  input) at n = 2, M = 8, within rtol 1e-4, atol 5e-3;
- the ``ValueError`` s of ``:332``, ``:355-359`` and ``:396-400``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_resnet import randomize_bn

import torch_mp_worker as W
from holocron_tpu.models.classification import darknetv3 as jdark3
from holocron_tpu.parallel import pipeline_blocks as jax_pipeline_blocks
from holocron_tpu.parallel import pipeline_module as jax_pipeline_module
from holocron_tpu.parallel import stack_stage_variables as jax_stack_stage_variables
from holocron_tpu_torch import convert
from holocron_tpu_torch.models.classification import darknetv3
from holocron_tpu_torch.parallel import stack_stage_variables, stage_variables

torch.set_num_threads(2)

S, C = 8, 4
CASES = {"n4_m8": (4, 8), "n2_m2": (2, 2), "n2_m8": (2, 8)}
STAGE = "features.layers.3"  # darknet53's 512-channel stage: children 3 to 10


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


def jax_block(p, x):
    y = jax.lax.conv_general_dilated(x, p["w"], (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return jax.nn.relu(y + p["b"]) + x


def pipe_mesh(n: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), ("pipe",))


@pytest.fixture(scope="module")
def conv_inputs():
    rng = np.random.default_rng(0)
    params = {"w": (rng.normal(size=(S, 3, 3, C, C)) * 0.1).astype(np.float32),
              "b": (rng.normal(size=(S, C)) * 0.1).astype(np.float32)}
    return params, rng.normal(size=(8, 8, 8, C)).astype(np.float32)


@pytest.fixture(scope="module")
def darknet_stage():
    """A JAX darknet53 with randomized BN, the port's copy, its stage-3 variables (both
    packages') and a stage input."""
    rng = np.random.default_rng(1)
    module = jdark3.DarknetV3([(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)])
    variables = jax.tree.map(np.asarray, jax.jit(module.init)(jax.random.key(0), np.zeros((1, 32, 32, 3), np.float32)))
    variables = randomize_bn(variables, rng)
    model = darknetv3.darknet53(device="cpu").eval()
    model.load_state_dict(convert.darknet_state_dict(variables, model))
    x = rng.normal(size=(8, 4, 4, 512)).astype(np.float32)
    return {"jax": jax_stack_stage_variables(variables, "layer_3_block_"), "port": stage_variables(model, STAGE),
            "model": model, "x": x}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory, conv_inputs, darknet_stage):
    """Every rank's results of the 4-process and the 2-process runs."""
    outdir = tmp_path_factory.mktemp("pipeline")
    params, x = conv_inputs
    torch.save({"conv": {"params": {"w": torch.from_numpy(params["w"].transpose(0, 4, 3, 1, 2).copy()),
                                    "b": torch.from_numpy(params["b"])},
                         "x": nchw(x)},
                "microbatches": {4: [8], 2: [2, 8]},
                "darknet": {"stacked": darknet_stage["port"], "x": nchw(darknet_stage["x"])}},
               outdir / "pipeline_inputs.pt")
    for world in (4, 2):
        W.run_workers("pipeline", world, outdir)
    return {world: [torch.load(outdir / f"pipeline_{world}_{r}.pt", weights_only=False) for r in range(world)]
            for world in (4, 2)}


@pytest.fixture(scope="module")
def jax_runs(conv_inputs):
    """The JAX package's output and gradients (of the global sum of squares with respect
    to the stacked parameters and x) at each case."""
    params, x = conv_inputs
    out = {}
    for name, (n, m) in CASES.items():
        def loss(p, h, mesh=pipe_mesh(n), m=m):
            y = jax_pipeline_blocks(jax_block, p, h, mesh, num_microbatches=m)
            return (y ** 2).sum(), y

        (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
        out[name] = {"y": np.asarray(y), "grads": jax.tree.map(np.asarray, grads[0]), "dx": np.asarray(grads[1])}
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_blocks_output_matches_jax(case, port_runs, jax_runs):
    """Each process's rows of the output (its ``M/n`` microbatches, in rank order) and
    the output gathered whole on every process (``gather_output``), against the JAX
    package's, within atol 1e-5."""
    n, m = CASES[case]
    want = jax_runs[case]["y"]
    ranks = [r["conv"][m] for r in port_runs[n]]
    assert all(r["y"].shape[0] == want.shape[0] // n for r in ranks)
    np.testing.assert_allclose(np.concatenate([nhwc(r["y"]) for r in ranks]), want, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(nhwc(r["whole"]), want, atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_blocks_gradients_match_jax(case, port_runs, jax_runs):
    """The gradients of the global sum of squares through the schedule: each process's
    blocks of the stacked parameters and its rows of x against the JAX package's, zeros
    elsewhere, within rtol 1e-4, atol 1e-5."""
    n, m = CASES[case]
    want = jax_runs[case]
    per, rows = S // n, want["dx"].shape[0] // n
    for rank, r in enumerate(port_runs[n]):
        got = r["conv"][m]
        blocks = slice(rank * per, (rank + 1) * per)
        w = got["grads"]["w"].numpy().transpose(0, 3, 4, 2, 1)  # OIHW -> HWIO
        for name, g in (("w", w), ("b", got["grads"]["b"].numpy())):
            np.testing.assert_allclose(g[blocks], want["grads"][name][blocks], rtol=1e-4, atol=1e-5, err_msg=name)
            outside = np.delete(g, np.arange(S)[blocks], axis=0)
            assert not outside.any(), f"{name}: gradient outside rank {rank}'s blocks"
        dx = nhwc(got["dx"])
        own = slice(rank * rows, (rank + 1) * rows)
        np.testing.assert_allclose(dx[own], want["dx"][own], rtol=1e-4, atol=1e-5, err_msg="x")
        assert not np.delete(dx, np.arange(dx.shape[0])[own], axis=0).any(), f"x: gradient outside rank {rank}'s rows"


def test_pipeline_module_runs_darknet53_stage(port_runs, darknet_stage):
    """darknet53's eight ``ResBlock(512, 256)`` with weights carried from JAX, stacked
    with their BN statistics by ``stage_variables``, pipelined over 2 processes in 8
    microbatches, against the JAX package's ``pipeline_module`` on a 2-device mesh. The
    block, passed in training mode, is applied in eval form and left in training mode."""
    port, jvars = darknet_stage["port"], darknet_stage["jax"]
    assert {"conv.1.running_mean", "conv.1.running_var", "conv.4.running_mean", "conv.4.running_var"} <= set(port)
    assert all(v.shape[0] == 8 for v in port.values())
    np.testing.assert_array_equal(port["conv.1.running_var"].numpy(),
                                  np.asarray(jvars["batch_stats"]["conv_0"]["bn"]["var"]))
    want = np.asarray(jax_pipeline_module(jdark3.ResBlock(512, 256), jvars, darknet_stage["x"], mesh=pipe_mesh(2),
                                          num_microbatches=8))
    got = np.concatenate([nhwc(r["darknet"]) for r in port_runs[2]])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)
    assert all(r["darknet_block_training"] for r in port_runs[2])


def test_pipeline_blocks_rejects_bad_arguments(port_runs):
    """Microbatches that do not spread over the belt shards (``:332``, ``:355``), a batch
    that does not divide into them, blocks that do not split over the stages (``:358``)
    and a mesh with no ``pipe`` axis raise ``ValueError``."""
    four, two = port_runs[4][0]["errors"], port_runs[2][0]["errors"]
    assert "2 microbatches cannot spread over 4 belt shards" in four["spread"]
    assert "3 microbatches cannot spread over 2 belt shards" in two["spread"]
    assert "batch 8 does not divide into 6 microbatches" in two["batch"]
    assert "7 blocks cannot split into 2 pipeline stages" in two["stages"]
    assert "no 'pipe' axis" in two["axis"]


def test_stage_variables_rejects_bad_paths(darknet_stage):
    """A path naming no module, a single block (``:396-400``), blocks of one class that
    do not match (darknet53's five stages) and a model with no weights raise."""
    model = darknet_stage["model"]
    with pytest.raises(ValueError, match="no submodule"):
        stage_variables(model, "features.layers.9")
    with pytest.raises(ValueError, match="nothing to pipeline"):
        stage_variables(model, f"{STAGE}.10")
    with pytest.raises(ValueError, match="does not match"):
        stack_stage_variables(model, "features.layers")
    empty = darknetv3.DarknetV3([(8, 2)], device="cpu").to("meta")
    with pytest.raises(RuntimeError, match="no weights"):
        stage_variables(empty, "features.layers.0")
