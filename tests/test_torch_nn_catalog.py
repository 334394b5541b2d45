"""Parity of the PyTorch port's nn catalog and box ops with the JAX package, on the CPU
in float32.

Inputs come from numpy with fixed seeds; the port's modules take NCHW, the JAX ones
NHWC, and the functions take the JAX package's layouts in both. The random functions
are fed the JAX package's own draw (DropBlock's block centers, the mutual-channel
loss's channel masks) through the port's functions that start after the draw. The
modules with parameters get the JAX module's variables (BN parameters and statistics
randomized) through ``holocron_tpu_torch.convert.nn_state_dict``.

Tolerances (float32): values within 1e-5 of the reference's largest magnitude plus
1e-5 relative; gradients, train-mode outputs and BN statistics within 1e-4 of the
largest magnitude plus 1e-4 relative (sums over a batch and its positions in another
order), a module's parameter gradients against the module's largest gradient; the
selection ops (space-to-depth, pools, DropBlock's mask) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import randomize_bn

from holocron_tpu.nn import functional as JF
from holocron_tpu.nn.modules import activation as jact
from holocron_tpu.nn.modules import attention as jatt
from holocron_tpu.nn.modules import conv as jconv
from holocron_tpu.nn.modules import downsample as jdown
from holocron_tpu.nn.modules import lambda_layer as jlambda
from holocron_tpu.nn.modules import loss as jloss
from holocron_tpu.ops import boxes as jboxes
from holocron_tpu_torch import convert, nn, ops
from holocron_tpu_torch.models.utils import ConvSequence
from holocron_tpu_torch.nn import functional as F

torch.set_num_threads(2)

NUM_CLASSES = 5


def _close(got, ref, tol: float, what: str = "") -> None:
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(float(np.abs(ref).max(initial=0.0)), 1e-12),
                               err_msg=what)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _nchw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def _value_and_grad(jfn, tfn, *arrays, tol_value=1e-5, tol_grad=1e-4, what=""):
    """``jfn`` and ``tfn`` on the same float inputs (the first argument differentiated):
    the values, and the gradients of ``sum(out * w)`` with a random ``w``."""
    x = arrays[0]
    ref = np.asarray(jfn(jnp.asarray(x), *arrays[1:]))
    w = np.random.default_rng(99).normal(size=ref.shape).astype(np.float32)
    gref = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v, *arrays[1:]) * w))(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    out = tfn(xt, *(_t(a) if isinstance(a, np.ndarray) else a for a in arrays[1:]))
    _close(out.detach().numpy(), ref, tol_value, f"{what} value")
    (out * _t(w)).sum().backward()
    _close(xt.grad.numpy(), gref, tol_grad, f"{what} grad")


# --- activations ---------------------------------------------------------------------------------


@pytest.mark.parametrize("beta", [1.0, 0.5])
def test_activations_match_jax(beta):
    x = np.random.default_rng(0).normal(scale=2.0, size=(3, 4, 5, 6)).astype(np.float32)
    _value_and_grad(JF.hard_mish, F.hard_mish, x, what="hard_mish")
    _value_and_grad(lambda v: JF.nl_relu(v, beta), lambda v: F.nl_relu(v, beta), x, what="nl_relu")
    np.testing.assert_allclose(nn.HardMish()(_t(x)).numpy(), np.asarray(jact.HardMish().apply({}, x)), rtol=1e-6)
    np.testing.assert_allclose(nn.NLReLU(beta)(_t(x)).numpy(), np.asarray(jact.NLReLU(beta).apply({}, x)),
                               rtol=1e-6, atol=1e-7)


# --- losses ----------------------------------------------------------------------------------------


def _logits_and_targets(seed: int, spatial=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, *spatial, NUM_CLASSES)).astype(np.float32)
    target = rng.integers(0, NUM_CLASSES, size=(4, *spatial)).astype(np.int64)
    target.reshape(-1)[:3] = 2  # the in-range ignore_index below
    weight = rng.uniform(0.5, 2.0, NUM_CLASSES).astype(np.float32)
    return x, target, weight


LOSS_CASES = [(r, w, ig) for r in ("mean", "sum", "none") for w in (False, True) for ig in (-100, 2)]
LOSS_IDS = [f"{r}-{'w' if w else 'nw'}-ig{ig}" for r, w, ig in LOSS_CASES]


@pytest.mark.parametrize("reduction,weighted,ignore_index", LOSS_CASES, ids=LOSS_IDS)
def test_losses_match_jax(reduction, weighted, ignore_index):
    """focal, complement cross-entropy, poly (hard and soft targets), multi-label
    cross-entropy and the mutual-channel loss on JAX's channel masks; spatial logits
    ``(N, H, W, K)``, with class weights or without, ``ignore_index`` a class or not,
    every reduction: values and gradients."""
    x, target, weight = _logits_and_targets(1, (3, 2))
    wj = jnp.asarray(weight) if weighted else None
    wt = _t(weight) if weighted else None
    kw = {"ignore_index": ignore_index, "reduction": reduction}
    tt = _t(target)
    _value_and_grad(lambda v: JF.focal_loss(v, jnp.asarray(target), wj, gamma=1.5, **kw),
                    lambda v: F.focal_loss(v, tt, wt, gamma=1.5, **kw), x, what="focal_loss")
    for gamma in (-1.0, 0.5):
        _value_and_grad(lambda v: JF.complement_cross_entropy(v, jnp.asarray(target), wj, gamma=gamma, **kw),
                        lambda v: F.complement_cross_entropy(v, tt, wt, gamma=gamma, **kw), x,
                        what=f"complement_cross_entropy {gamma}")
    _value_and_grad(lambda v: JF.poly_loss(v, jnp.asarray(target), 1.5, wj, **kw),
                    lambda v: F.poly_loss(v, tt, 1.5, wt, **kw), x, what="poly_loss hard")
    soft = np.random.default_rng(2).dirichlet(np.ones(NUM_CLASSES), size=x.shape[:-1]).astype(np.float32)
    _value_and_grad(lambda v: JF.poly_loss(v, jnp.asarray(soft), 1.5, wj, **kw),
                    lambda v: F.poly_loss(v, _t(soft), 1.5, wt, **kw), x, what="poly_loss soft")
    _value_and_grad(lambda v: JF.multilabel_cross_entropy(v, jnp.asarray(soft), wj, **kw),
                    lambda v: F.multilabel_cross_entropy(v, _t(soft), wt, **kw), x, what="multilabel")

    # mutual-channel loss: 5 classes x xi 3 channels; JAX's masks from its key
    xi, key = 3, jax.random.key(7)
    xm = np.random.default_rng(3).normal(size=(4, 3, 2, NUM_CLASSES * xi)).astype(np.float32)
    base = (jnp.arange(xi) < 2).astype(jnp.float32)
    mask = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, base))(jax.random.split(key, NUM_CLASSES)))
    _value_and_grad(lambda v: JF.mutual_channel_loss(v, jnp.asarray(target), key, wj, xi=xi, alpha=0.7, **kw),
                    lambda v: F.mutual_channel_loss_masked(v, tt, _t(mask), wt, xi=xi, alpha=0.7, **kw), xm,
                    what="mutual_channel_loss")


def test_dice_and_loss_guards_match_jax():
    """Dice loss with and without weights and at two gammas; poly loss refuses float
    hard targets and malformed soft ones, as the JAX function does."""
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(2, 4, 4, 3)).astype(np.float32)
    target = (rng.uniform(size=x.shape) > 0.5).astype(np.float32)
    weight = np.array([0.5, 1.0, 2.0], np.float32)
    for gamma in (1.0, 0.5):
        for wj, wt in ((None, None), (jnp.asarray(weight), _t(weight))):
            _value_and_grad(lambda v: JF.dice_loss(v, jnp.asarray(target), wj, gamma),
                            lambda v: F.dice_loss(v, _t(target), wt, gamma), x, what="dice_loss")
    logits = torch.zeros(2, 3)
    with pytest.raises(TypeError):
        F.poly_loss(logits, torch.zeros(2))
    with pytest.raises(ValueError):
        F.poly_loss(logits, torch.zeros(2, 4))


def test_loss_modules_match_jax():
    """Each loss module against the JAX one: a float weight (two classes), a list, a
    class-balanced wrapper, the mutual-channel module's fixed default masks drawn per
    call, and the bad reduction refused."""
    x, target, weight = _logits_and_targets(5)
    xj, tj, xt, tt = jnp.asarray(x), jnp.asarray(target), _t(x), _t(target)
    soft = np.random.default_rng(6).dirichlet(np.ones(NUM_CLASSES), size=4).astype(np.float32)
    pairs = [
        (jloss.FocalLoss(gamma=1.0, weight=list(weight)), nn.FocalLoss(gamma=1.0, weight=list(weight), device="cpu")),
        (jloss.ComplementCrossEntropy(gamma=-0.5, ignore_index=1), nn.ComplementCrossEntropy(gamma=-0.5, ignore_index=1,
                                                                                            device="cpu")),
        (jloss.PolyLoss(eps=1.0, reduction="sum"), nn.PolyLoss(eps=1.0, reduction="sum", device="cpu")),
        (jloss.ClassBalancedWrapper(jloss.FocalLoss(), [10, 20, 5, 40, 8], beta=0.9),
         nn.ClassBalancedWrapper(nn.FocalLoss(device="cpu"), [10, 20, 5, 40, 8], beta=0.9, device="cpu")),
        (jloss.ClassBalancedWrapper(jloss.PolyLoss(weight=list(weight)), [10, 20, 5, 40, 8]),
         nn.ClassBalancedWrapper(nn.PolyLoss(weight=list(weight), device="cpu"), [10, 20, 5, 40, 8], device="cpu")),
    ]
    for jm, tm in pairs:
        _close(tm(xt, tt).numpy(), np.asarray(jm(xj, tj)), 1e-5, repr(tm))
    _close(nn.MultiLabelCrossEntropy(device="cpu")(xt, _t(soft)).numpy(),
           np.asarray(jloss.MultiLabelCrossEntropy()(xj, jnp.asarray(soft))), 1e-5, "MultiLabelCrossEntropy")
    two = np.random.default_rng(7).normal(size=(6, 2)).astype(np.float32)
    t2 = np.array([0, 1, 1, 0, 1, 0])
    _close(nn.FocalLoss(weight=0.3, device="cpu")(_t(two), _t(t2)).numpy(),
           np.asarray(jloss.FocalLoss(weight=0.3)(jnp.asarray(two), jnp.asarray(t2))), 1e-5, "two-class weight")
    probs = np.random.default_rng(8).uniform(size=(2, 4, 4, 3)).astype(np.float32)
    onehot = (probs > 0.5).astype(np.float32)
    _close(nn.DiceLoss(weight=[1.0, 2.0, 0.5], gamma=0.5, device="cpu")(_t(probs), _t(onehot)).numpy(),
           np.asarray(jloss.DiceLoss(weight=[1.0, 2.0, 0.5], gamma=0.5)(jnp.asarray(probs), jnp.asarray(onehot))),
           1e-5, "DiceLoss")
    # the mutual-channel module, default masks: the JAX module's fixed key against the
    # port's seeded generator draw different masks, so each is checked against its own
    # functional on its own masks, and the port's draw is the same at every call
    xm = np.random.default_rng(9).normal(size=(4, NUM_CLASSES * 2)).astype(np.float32)
    tm = nn.MutualChannelLoss(xi=2, device="cpu")
    assert torch.equal(tm(_t(xm), tt), tm(_t(xm), tt))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(tm(_t(xm), tt), F.mutual_channel_loss(_t(xm), tt, gen, xi=2))
    with pytest.raises(NotImplementedError):
        nn.FocalLoss(reduction="max", device="cpu")
    assert repr(nn.FocalLoss(device="cpu")) == "FocalLoss(gamma=2.0, reduction='mean')"


# --- structured dropout, space-to-depth, pools ------------------------------------------------------


@pytest.mark.parametrize("block_size", [3, 4])
def test_dropblock_matches_jax_on_its_draw(block_size):
    """The JAX function against the port's on JAX's block centers (an even block size
    pads unevenly); the module's doubled division and its eval identity."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    key, drop_prob = jax.random.key(3), 0.4
    ref = np.asarray(JF.dropblock2d(jnp.asarray(x), key, drop_prob, block_size))
    centers = np.asarray(jax.random.uniform(key, x.shape[:3]) <= drop_prob / block_size**2)
    assert 0 < centers.sum() < centers.size
    got = F.dropblock2d_from_centers(_t(x), _t(centers), block_size).numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)
    _close(got, ref, 1e-6, "dropblock")
    module = nn.DropBlock2d(0.2, block_size)
    assert module.drop_prob == 0.2 / block_size**2
    # conv_sequence's drop_layer hook takes it last
    seq = ConvSequence(3, 4, drop_layer=lambda: nn.DropBlock2d(0.2, block_size), kernel_size=3, padding=1)
    assert isinstance(seq[-1], nn.DropBlock2d) and seq.eval()(torch.zeros(1, 3, 5, 5)).shape == (1, 4, 5, 5)
    xt = _t(_nchw(x))
    assert module.eval()(xt) is xt
    assert torch.equal(F.dropblock2d_from_centers(_t(x), torch.zeros(2, 9, 11), block_size), _t(x))
    out = module.train()(xt)
    assert out.shape == xt.shape and bool(torch.isfinite(out).all())


def test_downsample_modules_match_jax():
    """Space-to-depth (channel order ``(sh, sw, c)``), Z-pool along each axis, global max
    pooling, and SPP's pyramid (the JAX cascade and its direct form): exactly."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 8, 6, 5)).astype(np.float32)
    xt = _t(_nchw(x))
    ref = np.asarray(JF.concat_downsample2d(jnp.asarray(x), 2))
    np.testing.assert_array_equal(F.concat_downsample2d(_t(x), 2).numpy(), ref)
    np.testing.assert_array_equal(nn.ConcatDownsample2d(2)(xt).numpy(), _nchw(ref))
    with pytest.raises(AssertionError):
        F.concat_downsample2d(_t(x), 4)
    for axis in (1, 2, 3):
        _value_and_grad(lambda v: JF.z_pool(v, axis), lambda v: F.z_pool(v, axis), x, what=f"z_pool {axis}")
    np.testing.assert_allclose(nn.ZPool()(xt).numpy(), _nchw(np.asarray(jdown.ZPool().apply({}, x))), rtol=1e-6)
    for flatten in (False, True):
        ref = np.asarray(jdown.GlobalMaxPool2d(flatten).apply({}, x))
        np.testing.assert_array_equal(nn.GlobalMaxPool2d(flatten)(xt).numpy(), ref if flatten else _nchw(ref))
    for cascade in (True, False):
        ref = np.asarray(jdown.SPP((3, 5, 9), cascade=cascade).apply({}, x))
        np.testing.assert_array_equal(nn.SPP((3, 5, 9))(xt).numpy(), _nchw(ref))


# --- modules with parameters ------------------------------------------------------------------------


def _check_module(jmodule, tmodule, x: np.ndarray, train: bool = True, seed: int = 0):
    """A JAX module and the port's on the JAX variables (BN randomized): the state dict
    covers every tensor; in train mode (where the module has one) the output, the BN
    statistics, and the gradients of ``sum(out * w)`` for the input and each
    parameter; then the eval output."""
    rng = np.random.default_rng(seed)
    kwargs = {"train": False} if train else {}
    variables = jax.tree.map(np.asarray, jmodule.init(jax.random.key(seed), jnp.asarray(x), **kwargs))
    if "batch_stats" in variables:
        variables = randomize_bn(variables, rng)
    sd = convert.nn_state_dict(variables, tmodule)
    tmodule.load_state_dict({**tmodule.state_dict(), **sd})
    assert set(sd) == set(tmodule.state_dict())
    mutable = ["batch_stats"] if "batch_stats" in variables else []

    def loss_fn(params, xin, w):
        if train:
            out, upd = jmodule.apply({**variables, "params": params}, xin, train=True, mutable=mutable)
        else:
            out, upd = jmodule.apply({**variables, "params": params}, xin), {}
        return jnp.sum(out * w), (out, upd)

    ref_out = np.asarray(jmodule.apply(variables, jnp.asarray(x), **({"train": True} if train else {}),
                                       mutable=mutable)[0]) if mutable else None
    shape = ref_out.shape if ref_out is not None else np.asarray(jmodule.apply(variables, jnp.asarray(x))).shape
    w = rng.normal(size=shape).astype(np.float32)
    (_, (out_j, upd)), (gp, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x), jnp.asarray(w))
    tmodule.train(train)
    xt = _t(_nchw(x)).requires_grad_()
    out = tmodule(xt)
    (out * _t(_nchw(w))).sum().backward()
    _close(out.detach().numpy(), _nchw(np.asarray(out_j)), 1e-4, "output")
    _close(xt.grad.numpy(), _nchw(np.asarray(gx)), 1e-4, "input grad")
    expected = convert.nn_state_dict({"params": jax.tree.map(np.asarray, gp),
                                      "batch_stats": jax.tree.map(np.asarray, upd.get("batch_stats", {}))}, tmodule)
    # against the module's largest gradient: a bias that a train-mode norm follows has a
    # zero gradient in exact arithmetic, rounding noise in both packages
    scale = max(float(expected[name].abs().max()) for name, _ in tmodule.named_parameters())
    for name, p in tmodule.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(), rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"grad {name}")
    if upd:
        state = tmodule.state_dict()
        for key in (k for k in expected if k.endswith(("running_mean", "running_var"))):
            _close(state[key].numpy(), expected[key].numpy(), 1e-4, key)
        stats = {**variables, "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])}
        ref = np.asarray(jmodule.apply(stats, jnp.asarray(x), **kwargs))
        tmodule.eval()
        with torch.no_grad():
            _close(tmodule(_t(_nchw(x))).numpy(), _nchw(ref), 1e-4, "eval output")


X_MODULE = np.random.default_rng(12).normal(size=(2, 6, 7, 8)).astype(np.float32)


@pytest.mark.parametrize(
    "name",
    ["frelu", "sam", "dim_c", "dim_h", "dim_w", "triplet", "lambda_r", "lambda_n", "norm_conv", "norm_conv_reflect",
     "slim_conv"],
)
def test_modules_match_jax(name):
    g = torch.Generator().manual_seed(0)
    c, h, w = X_MODULE.shape[3], X_MODULE.shape[1], X_MODULE.shape[2]
    cases = {
        "frelu": (jact.FReLU(3), lambda: nn.FReLU(c, 3, device="cpu", generator=g), True),
        "sam": (jatt.SAM(), lambda: nn.SAM(c, device="cpu", generator=g), False),
        "dim_c": (jatt.DimAttention(3), lambda: nn.DimAttention(1, device="cpu", generator=g), True),
        "dim_h": (jatt.DimAttention(1), lambda: nn.DimAttention(2, device="cpu", generator=g), True),
        "dim_w": (jatt.DimAttention(2), lambda: nn.DimAttention(3, device="cpu", generator=g), True),
        "triplet": (jatt.TripletAttention(), lambda: nn.TripletAttention(device="cpu", generator=g), True),
        "lambda_r": (jlambda.LambdaLayer(8, 4, r=3, num_heads=2, dim_u=2),
                     lambda: nn.LambdaLayer(c, 8, 4, r=3, num_heads=2, dim_u=2, device="cpu", generator=g), True),
        "lambda_n": (jlambda.LambdaLayer(12, 4, n=h * w, num_heads=3, dim_u=2),
                     lambda: nn.LambdaLayer(c, 12, 4, n=h * w, num_heads=3, dim_u=2, device="cpu", generator=g), True),
        "norm_conv": (jconv.NormConv2d(6, 3, stride=2, padding=1, eps=1e-5),
                      lambda: nn.NormConv2d(c, 6, 3, stride=2, padding=1, eps=1e-5, device="cpu", generator=g), False),
        "norm_conv_reflect": (jconv.NormConv2d(5, 3, padding=1, padding_mode="reflect", use_bias=False, eps=1e-5),
                              lambda: nn.NormConv2d(c, 5, 3, padding=1, padding_mode="reflect", bias=False, eps=1e-5,
                                                    device="cpu", generator=g), False),
        "slim_conv": (jconv.SlimConv2d(3, padding=1, r=2), lambda: nn.SlimConv2d(c, 3, padding=1, r=2, device="cpu",
                                                                                 generator=g), True),
    }
    jmodule, build, train = cases[name]
    _check_module(jmodule, build(), X_MODULE, train)


def test_norm_conv2d_function_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 7, 6, 4)).astype(np.float32)
    weight = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    _value_and_grad(lambda v: JF.norm_conv2d(v, jnp.asarray(weight), jnp.asarray(bias), 1, 1, 2, 1e-5),
                    lambda v: F.norm_conv2d(v, _t(weight), _t(bias), 1, 1, 2, 1e-5), x, tol_value=1e-4,
                    what="norm_conv2d")


def test_lambda_layer_and_slim_conv_refuse_what_jax_refuses():
    with pytest.raises(AssertionError):
        nn.LambdaLayer(8, 6, 4, r=3, num_heads=4, device="cpu")
    with pytest.raises(AssertionError):
        nn.LambdaLayer(8, 8, 4, r=2, device="cpu")
    with pytest.raises(AssertionError):
        nn.LambdaLayer(8, 8, 4, device="cpu")
    assert nn.SlimConv2d(16, padding=1, device="cpu").eval()(torch.zeros(1, 16, 5, 5)).shape == (1, 12, 5, 5)


# --- box ops ------------------------------------------------------------------------------------------


def _boxes():
    """Overlapping, nested, identical, disjoint and touching boxes, a zero-area one and
    a zero-height one."""
    b1 = np.array([[0, 0, 4, 4], [1, 1, 3, 5], [2, 2, 2, 6], [0, 0, 10, 1], [5, 5, 6, 6]], np.float32)
    b2 = np.array([[0, 0, 4, 4], [2, 1, 6, 3], [10, 10, 12, 13], [4, 0, 8, 4], [1, 2, 3, 2], [0.5, 0.5, 9, 2]],
                  np.float32)
    return b1, b2


@pytest.mark.parametrize("name", ["box_iou", "box_giou", "iou_penalty", "diou_loss", "aspect_ratio_consistency",
                                  "ciou_loss"])
def test_box_ops_match_jax(name):
    """Pairwise, with a box against itself, disjoint and touching pairs, a zero-area
    and a zero-height box: values (NaN where both give NaN, IoU's 0 / 0) and the
    gradient for the first set of boxes, through the finite entries."""
    b1, b2 = _boxes()
    jfn, tfn = getattr(jboxes, name), getattr(ops, name)
    ref = np.asarray(jfn(jnp.asarray(b1), jnp.asarray(b2)))
    got = tfn(_t(b1), _t(b2)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    finite = np.isfinite(ref)
    _close(got[finite], ref[finite], 1e-5, name)
    # gradients on the pairs whose values are finite in both, where both are smooth
    rows = np.isfinite(ref).all(1) & (np.abs(ref).max(1) < 1e6)
    if rows.any():
        _value_and_grad(lambda v: jfn(v, jnp.asarray(b2)), lambda v: tfn(v, _t(b2)), b1[rows], what=name)


def test_box_area_aspect_ratio_and_giou_guard_match_jax():
    b1, _ = _boxes()
    np.testing.assert_array_equal(ops.box_area(_t(b1)).numpy(), np.asarray(jboxes.box_area(jnp.asarray(b1))))
    flat = np.array([[0, 0, 3, 0], [0, 1, 3, 1 - 1e-13], [0, 0, 2, 1]], np.float32)
    _value_and_grad(jboxes.aspect_ratio, ops.aspect_ratio, flat, what="aspect_ratio")
    swapped = np.array([[4, 4, 0, 0]], np.float32)
    with pytest.raises(AssertionError):
        ops.box_giou(_t(swapped), _t(b1))
    with pytest.raises(AssertionError):
        jboxes.box_giou(jnp.asarray(swapped), jnp.asarray(b1))
