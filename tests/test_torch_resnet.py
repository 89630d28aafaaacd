"""The port's ResNet against the reference's flax module, on ``resnet_tiny``
(f32) with converted variables and the same NHWC images.

Images are 32 px: the stem's 7x7/2 "SAME" convolution pads (2, 3) there and
the strided 3x3 of the second stage (0, 1) on its 8 px map, so a symmetric
padding would shift every window.  Tolerances (f32 on the CPU, XLA's
convolutions against torch's, summed in another order): logits and the
loss ``1e-5``; gradients ``3e-5`` of each leaf's largest magnitude (most
agree to ~3e-6; the stem norm's bias, a sum over every path through the
batch-norm backward whose elements cancel to ~1e-8 beside a largest of
5e-3, to 1.1e-5); running statistics ``1e-6``; parameters after one
``adam(1e-2)`` step ``2e-5`` (a step moves each by about the learning rate,
and a gradient near zero turns the ratio ``g / (|g| + eps)`` by a few
percent when it differs in its seventh digit, as in
``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from kubegpu_tpu.models import resnet as jr
from kubegpu_tpu_torch.convert import convert_resnet_variables
from kubegpu_tpu_torch.models import resnet as tr
from kubegpu_tpu_torch.optim import adam

LOSS_ATOL = 1e-5
GRAD_RTOL = 3e-5
STATS_ATOL = 1e-6
PARAM_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 run puts six test processes on the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + ".") if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


def _port_key(name: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """A flax path's state-dict key, its conv kernel as OIHW."""
    if name.endswith(".kernel") and value.ndim == 4:
        return name[:-len("kernel")] + "weight", value.transpose(3, 2, 0, 1)
    return name, value


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = np.arange(4) % 10
    model_j = jr.resnet_tiny()
    variables = jax.jit(model_j.init, static_argnames="train")(
        jax.random.PRNGKey(1), jnp.asarray(images), train=True)
    # random norms, so the zero-initialised last scales carry gradient
    # through every path
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (v + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(p))), v.shape)
            if "BatchNorm" in str(p) else v), variables)
    return model_j, variables, images, labels


def _port(variables):
    model = tr.resnet_tiny(device="cpu")
    model.load_state_dict(convert_resnet_variables(
        jax.tree.map(np.asarray, variables), device="cpu"))
    return model


def test_convert_maps_every_variable(tiny):
    _, variables, _, _ = tiny
    sd = convert_resnet_variables(jax.tree.map(np.asarray, variables),
                                  device="cpu")
    model = tr.resnet_tiny(device="cpu")
    assert set(sd) == set(model.state_dict())
    ref = dict(_port_key(k, v) for coll in ("params", "batch_stats")
               for k, v in _flat(variables[coll]).items())
    assert set(ref) == set(sd)
    for k, v in sd.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_logits_and_running_stats_match(tiny, train):
    model_j, variables, images, _ = tiny
    model = _port(variables)
    if train:
        ref, upd = jax.jit(lambda v, x: model_j.apply(
            v, x, train=True, mutable=["batch_stats"]))(
                variables, jnp.asarray(images))
    else:
        ref = jax.jit(lambda v, x: model_j.apply(v, x, train=False))(
            variables, jnp.asarray(images))
    with torch.no_grad():
        got = model(torch.from_numpy(images), train=train)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOSS_ATOL)
    stats = {k: v.numpy() for k, v in model.named_buffers()}
    want = _flat(upd["batch_stats"] if train else variables["batch_stats"])
    for k, v in want.items():
        np.testing.assert_allclose(stats[k], v, atol=STATS_ATOL, err_msg=k)


def test_symmetric_padding_would_differ(tiny):
    """At 32 px flax pads the 7x7/2 stem (2, 3) and the 3x3/2 conv on 8 px
    (0, 1); torch's symmetric ``padding=`` shifts the windows."""
    assert tr.same_pads(32, 7, 2) == (2, 3)
    assert tr.same_pads(8, 3, 2) == (0, 1)
    for size, k, s in ((32, 7, 2), (8, 3, 2), (16, 1, 2), (9, 3, 1),
                       (7, 3, 2), (1, 3, 2)):
        want = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
        assert tr.same_pads(size, k, s) == tuple(want), (size, k, s)
    model_j, variables, images, _ = tiny
    model = _port(variables)
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    w = model.Conv_0.weight.detach()
    flax_conv = jax.lax.conv_general_dilated(
        jnp.asarray(images), jnp.asarray(variables["params"]["Conv_0"]
                                         ["kernel"]),
        (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = model.Conv_0(x).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(flax_conv), atol=1e-5)
    sym = F.conv2d(x, w, stride=2, padding=3).permute(0, 2, 3, 1).numpy()
    assert sym.shape == got.shape
    assert np.abs(sym - np.asarray(flax_conv)).max() > 1e-1


def test_train_step_matches_flax_and_optax(tiny):
    """Loss, every gradient, the updated running statistics and every
    updated parameter after one ``adam(1e-2)`` step."""
    model_j, variables, images, labels = tiny

    def loss_fn(params, batch_stats):
        logits, upd = model_j.apply(
            {"params": params, "batch_stats": batch_stats},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), upd["batch_stats"]

    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    opt_j = optax.adam(1e-2)
    step_j = jax.jit(jr.make_resnet_train_step(model_j, opt_j))
    new_p, new_bs, _, loss_step = step_j(
        variables["params"], variables["batch_stats"],
        opt_j.init(variables["params"]), jnp.asarray(images),
        jnp.asarray(labels))

    model = _port(variables)
    params, stats = tr.resnet_variables(model)
    logits = torch.func.functional_call(
        model, {**params, **{k: v.clone() for k, v in stats.items()}},
        (torch.from_numpy(images),), {"train": True})
    loss = F.cross_entropy(logits, torch.from_numpy(labels))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=LOSS_ATOL)
    ref_g = dict(_port_key(k, v) for k, v in _flat(grads_j).items())
    assert set(ref_g) == set(grads)
    for k, g in grads.items():
        scale = max(np.abs(ref_g[k]).max(), 1e-30)
        np.testing.assert_allclose(g.numpy(), ref_g[k],
                                   atol=GRAD_RTOL * scale, err_msg=k)

    opt = adam(1e-2)
    step = tr.make_resnet_train_step(model, opt)
    params, stats, state, loss_t = step(params, stats, opt.init(params),
                                        torch.from_numpy(images),
                                        torch.from_numpy(labels))
    assert state["count"] == 1
    np.testing.assert_allclose(loss_t.item(), float(loss_step),
                               atol=LOSS_ATOL)
    for k, v in _flat(new_bs).items():
        np.testing.assert_allclose(stats[k].numpy(), v, atol=STATS_ATOL,
                                   err_msg=k)
    # where the reference gradient is within the gradient tolerance of
    # zero (the stem norm's bias has two channels at ~1e-8) both sides hold
    # rounding noise, which Adam's first step g / (|g| + eps) turns into a
    # move of up to the learning rate either way: an element off by more
    # than PARAM_ATOL must be such a one, rare, and moved by no more than
    # a step
    before = dict(_port_key(k, v) for k, v in _flat(
        variables["params"]).items())
    moved, off, total = 0.0, 0, 0
    for k, v in _flat(new_p).items():
        k, v = _port_key(k, v)
        got = params[k].detach().numpy()
        bad = np.abs(got - v) > PARAM_ATOL
        tiny_g = np.abs(ref_g[k]) <= GRAD_RTOL * np.abs(ref_g[k]).max()
        assert not (bad & ~tiny_g).any(), k
        off, total = off + int(bad.sum()), total + v.size
        assert np.abs(got - before[k]).max() <= 1e-2 * (1 + 1e-5), k
        moved = max(moved, float(np.abs(v - before[k]).max()))
    assert off <= 1e-3 * total, (off, total)
    assert moved > 5e-3   # the step really moved the parameters


def test_adam_matches_optax_over_three_steps():
    """``optim.adam`` against ``optax.adam`` on f32 leaves: moments and
    parameters after each of three steps (same arithmetic, same order:
    agreement to f32 rounding)."""
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 7), "b": (7,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 10.0 ** -i
              for k, s in shapes.items()} for i in range(3)]
    opt_j = optax.adam(1e-2)
    pj, sj = {k: jnp.asarray(v) for k, v in p0.items()}, None
    sj = opt_j.init(pj)
    opt = adam(1e-2)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    st = opt.init(pt)
    for g in grads:
        upd, sj = opt_j.update({k: jnp.asarray(v) for k, v in g.items()},
                               sj, pj)
        pj = optax.apply_updates(pj, upd)
        st = opt.update([torch.from_numpy(g[k]) for k in pt], st,
                        list(pt.values()))
        for k in pt:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(st["mu"][k].numpy(),
                                       np.asarray(sj[0].mu[k]), rtol=1e-6)
            np.testing.assert_allclose(st["nu"][k].numpy(),
                                       np.asarray(sj[0].nu[k]), rtol=1e-6)
    assert st["count"] == 3
