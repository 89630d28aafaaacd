"""The port's ViT against the JAX package's, on ``ViTConfig.tiny()`` (f32)
with the same (converted) parameters and the same NHWC images.

The reference's tiny config runs ``attn_impl="xla"``; the port's runs
``auto``, which on CPU tensors is the plain attention inside
``_FlashAttention`` (its backward the plain flash backward).  Tolerances
(f32 on the CPU, the same math in another summation order): logits and
the loss ``1e-5``; gradients ``1e-5`` of each leaf's largest magnitude
(they agree to ~1e-6); parameters after one ``adamw(1e-3)`` step ``2e-5``
as in ``tests/test_torch_train.py``.  The bf16 layer norm is held to one
bf16 rounding of its output (``2**-8`` relative).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from kubegpu_tpu.models import vit as jv
from kubegpu_tpu_torch.convert import convert_vit_params
from kubegpu_tpu_torch.models import vit as tv
from kubegpu_tpu_torch.optim import adamw
from kubegpu_tpu_torch.tree import tree_leaves

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 2e-5

# the JAX side jitted (op-by-op dispatch compiles every op of every call)
j_forward = jax.jit(jv.vit_forward, static_argnums=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 run puts six test processes on the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_jax(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_torch(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat_torch(v, name + "/") if isinstance(v, dict)
                   else {name: v.detach().numpy()})
    return out


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jv.ViTConfig.tiny()
    params_j = jax.jit(jv.vit_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                        cfg_j)
    # non-trivial norms, biases and class token, so every leaf's gradient
    # path is exercised
    params_j = jax.tree_util.tree_map_with_path(
        lambda p, v: (v + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(p))), v.shape)
            if any(s in str(p) for s in ("ln", "b_", "cls")) else v),
        params_j)
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    labels = np.arange(4) % cfg_j.n_classes
    return cfg_j, params_j, tv.ViTConfig.tiny(), images, labels


def _torch_params(params_j):
    params = convert_vit_params(jax.tree.map(np.asarray, params_j),
                                device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    return params


def test_patchify_matches():
    x = np.random.default_rng(1).standard_normal((2, 32, 24, 3)).astype(
        np.float32)
    ref = np.asarray(jv.patchify(jnp.asarray(x), 8))
    got = tv.patchify(torch.from_numpy(x), 8).numpy()
    assert got.shape == (2, 12, 192)
    np.testing.assert_array_equal(got, ref)


def test_layernorm_bf16_casts_before_the_scale():
    """f32 statistics, cast to bf16, THEN ``* scale + bias`` in bf16: the
    other order (scale and bias in f32, one cast at the end) rounds
    differently, and the test tells the two apart."""
    rng = np.random.default_rng(2)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32) * m
                      for s, m in (((64, 96), 3.0), ((96,), 2.0),
                                   ((96,), 1.0)))
    ref = np.asarray(jv._layernorm(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, scale, bias))
    ).astype(jnp.float32))
    xt, st, bt = (torch.from_numpy(a).bfloat16() for a in (x, scale, bias))
    got = tv._layernorm(xt, st, bt)
    assert got.dtype == torch.bfloat16
    tol = 2.0 ** -8 * (np.abs(ref) + 1e-2)
    assert (np.abs(got.float().numpy() - ref) <= tol).all()
    xf = xt.float()
    mu = xf.mean(-1, keepdim=True)
    norm = (xf - mu) * torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True)
                                   + 1e-6)
    other = (norm * st.float() + bt.float()).bfloat16().float().numpy()
    assert (other != got.float().numpy()).mean() > 0.05


def test_forward_and_loss_match(tiny):
    cfg_j, params_j, cfg, images, labels = tiny
    ref = j_forward(params_j, jnp.asarray(images), cfg_j)
    params = _torch_params(params_j)
    with torch.no_grad():
        got = tv.vit_forward(params, torch.from_numpy(images), cfg)
    assert got.dtype == torch.float32 and got.shape == (4, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOSS_ATOL)
    ref_loss = jax.jit(jv.vit_loss, static_argnums=3)(
        params_j, jnp.asarray(images), jnp.asarray(labels), cfg_j)
    with torch.no_grad():
        loss = tv.vit_loss(params, torch.from_numpy(images),
                           torch.from_numpy(labels), cfg)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=LOSS_ATOL)


def test_erf_gelu_would_fail(tiny, monkeypatch):
    """``jax.nn.gelu`` defaults to the tanh approximation: the erf form
    moves the logits past the tolerance."""
    cfg_j, params_j, cfg, images, _ = tiny
    ref = np.asarray(j_forward(params_j, jnp.asarray(images), cfg_j))
    erf = types.SimpleNamespace(gelu=lambda x, approximate: F.gelu(x))
    monkeypatch.setattr(tv, "F", erf)
    with torch.no_grad():
        got = tv.vit_forward(_torch_params(params_j),
                             torch.from_numpy(images), cfg)
    assert np.abs(got.numpy() - ref).max() > 10 * LOSS_ATOL


def test_grads_match_jax(tiny):
    """Every leaf's gradient of the loss; attention goes through
    ``_FlashAttention``'s plain backward (non-causal)."""
    cfg_j, params_j, cfg, images, labels = tiny
    ref = _flat_jax(jax.jit(jax.grad(jv.vit_loss), static_argnums=3)(
        params_j, jnp.asarray(images), jnp.asarray(labels), cfg_j))
    params = _torch_params(params_j)
    loss = tv.vit_loss(params, torch.from_numpy(images),
                       torch.from_numpy(labels), cfg)
    names = list(_flat_torch(params))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert set(names) == set(ref)
    for name, g in zip(names, grads):
        scale = np.abs(ref[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), ref[name],
                                   atol=GRAD_RTOL * scale, err_msg=name)


def test_train_step_matches_jax(tiny):
    """One ``make_vit_train_step`` + ``adamw(1e-3)``: the loss, both
    moments and every updated leaf against JAX + optax."""
    cfg_j, params_j, cfg, images, labels = tiny
    opt_j = optax.adamw(1e-3)
    step_j = jax.jit(jv.make_vit_train_step(cfg_j, opt_j))
    new_j, state_j, loss_j = step_j(params_j, opt_j.init(params_j),
                                    jnp.asarray(images), jnp.asarray(labels))
    opt = adamw(1e-3)
    params = _torch_params(params_j)
    step = tv.make_vit_train_step(cfg, opt)
    new, state, loss = step(params, opt.init(params),
                            torch.from_numpy(images),
                            torch.from_numpy(labels))
    assert state["count"] == 1
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=LOSS_ATOL)
    # mu = 0.1 g and nu = 1e-3 g²: a gradient error of GRAD_RTOL of the
    # leaf's largest is that share of mu's largest and twice it of nu's
    for mom, k in (("mu", 1), ("nu", 2)):
        ref_m = _flat_jax(getattr(state_j[0], mom))
        got_m = _flat_torch(state[mom])
        assert set(ref_m) == set(got_m)
        for name, ref in ref_m.items():
            np.testing.assert_allclose(
                got_m[name], ref, rtol=1e-5,
                atol=k * GRAD_RTOL * np.abs(ref).max(),
                err_msg=f"{mom} {name}")
    flat_j, flat_t = _flat_jax(new_j), _flat_torch(new)
    before = _flat_jax(params_j)
    moved = 0.0
    for name, ref in flat_j.items():
        np.testing.assert_allclose(flat_t[name], ref, atol=PARAM_ATOL,
                                   err_msg=name)
        moved = max(moved, float(np.abs(ref - before[name]).max()))
    assert moved > 5e-4


def test_train_step_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="item 9"):
        tv.make_vit_train_step(tv.ViTConfig.tiny(), adamw(1e-3), mesh=object())
