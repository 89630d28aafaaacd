"""The port's MoE training (``make_moe_train_step``) against the JAX
package's, on ``MoEConfig.tiny()`` (f32) with converted parameters and
numpy-seeded tokens.

The gradient is the new part: it goes through ``route_tokens`` (the gates
through ``combine`` and its renormalisation, the aux loss through the mean
router probabilities; the one-hot dispatch, positions and drops carry
none) and the batched expert products.  Tolerances (f32 on the CPU, the
same math in another summation order): the loss ``1e-5``; gradients
``1e-5`` of each leaf's largest magnitude (they agree to ~1e-6); updated
parameters ``2e-5`` and the moments as in ``tests/test_torch_train.py``.
The tie case compares the routing's gradient to ``1e-6``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import moe as jm
from kubegpu_tpu_torch.convert import convert_moe_params
from kubegpu_tpu_torch.models import moe as tm
from kubegpu_tpu_torch.optim import adamw
from kubegpu_tpu_torch.tree import tree_leaves

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 2e-5
# the default capacity (nothing dropped at these tokens) and a tight one
# that drops (capacity 6 of 24 tokens' 48 choices over 4 experts)
CAPACITIES = (1.25, 0.5)

# the JAX side jitted, one executable a config
j_init = jax.jit(jm.moe_init, static_argnums=1)
j_value_grad = jax.jit(jax.value_and_grad(jm.moe_next_token_loss),
                       static_argnums=2)


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
    cfg_j = jm.MoEConfig.tiny()
    params_j = j_init(jax.random.PRNGKey(0), cfg_j)
    # norms off one, so their gradients are not symmetric
    params_j = jax.tree_util.tree_map_with_path(
        lambda p, v: (v + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(p))), v.shape)
            if "norm" in str(p) else v), params_j)
    tokens = np.random.default_rng(0).integers(0, cfg_j.base.vocab_size,
                                               (4, 24))
    return cfg_j, params_j, tokens


def _cfgs(cfg_j, capacity: float, remat: bool = False):
    cj = dataclasses.replace(cfg_j, capacity_factor=capacity)
    ct = tm.MoEConfig.tiny(capacity_factor=capacity, remat=remat)
    return cj, ct


def _torch_params(params_j):
    params = convert_moe_params(jax.tree.map(np.asarray, params_j),
                                device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    return params


def _check_grads(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for name, r in ref.items():
        scale = np.abs(r).max()
        assert scale > 0, name
        np.testing.assert_allclose(got[name], r, atol=GRAD_RTOL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_loss_and_every_grad_match_jax(tiny, capacity, remat):
    """The loss and every leaf's gradient (router, expert stacks,
    attention, norms, embedding, head) at both capacities, remat off and
    on (the recompute routes as the forward did)."""
    cfg_j, params_j, tokens = tiny
    cj, ct = _cfgs(cfg_j, capacity, remat)
    if capacity < 1:
        cap = cj.capacity(tokens.shape[1])
        logits = np.asarray(jnp.einsum(
            "btd,de->bte", params_j["embed"][tokens],
            params_j["layers"]["w_router"][0]))
        assert (logits.argmax(-1)[..., None] == np.arange(4)).sum(1).max() \
            > cap   # layer 0's first choices alone overflow an expert
    loss_j, grads_j = j_value_grad(params_j, jnp.asarray(tokens, jnp.int32),
                                   cj)
    params = _torch_params(params_j)
    loss = tm.moe_next_token_loss(params, torch.from_numpy(tokens), ct)
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=LOSS_ATOL)
    names = list(_flat_torch(params))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    _check_grads({n: g.numpy() for n, g in zip(names, grads)},
                 _flat_jax(grads_j))


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_jax(tiny, accum_steps):
    """One ``make_moe_train_step`` + ``adamw(1e-3)`` against the
    reference's (``make_moe_train_step``, or Llama's ``make_train_step``
    with the MoE loss where it takes ``accum_steps``): the loss, both
    moments and every updated leaf."""
    cfg_j, params_j, tokens = tiny
    opt_j = optax.adamw(1e-3)
    if accum_steps == 1:
        step_j = jm.make_moe_train_step(cfg_j, opt_j)
    else:
        step_j = jl.make_train_step(cfg_j, opt_j,
                                    loss_fn=jm.moe_next_token_loss,
                                    accum_steps=accum_steps)
    new_j, state_j, loss_j = jax.jit(step_j)(
        params_j, opt_j.init(params_j), jnp.asarray(tokens, jnp.int32))
    opt = adamw(1e-3)
    params = _torch_params(params_j)
    step = tm.make_moe_train_step(tm.MoEConfig.tiny(), opt,
                                  accum_steps=accum_steps)
    new, state, loss = step(params, opt.init(params),
                            torch.from_numpy(tokens))
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
    # where the reference gradient (mu / 0.1) is within the gradient
    # tolerance of zero, both sides hold rounding noise, which AdamW's
    # first step g / (|g| + eps) turns into a move of up to the learning
    # rate either way (one w_down element of 65,536 here): an element off
    # by more than PARAM_ATOL must be such a one, rare, and moved by no
    # more than a step
    flat_j, flat_t = _flat_jax(new_j), _flat_torch(new)
    before, mu = _flat_jax(params_j), _flat_jax(state_j[0].mu)
    assert set(flat_j) == set(flat_t)
    moved, off, total = 0.0, 0, 0
    for name, ref in flat_j.items():
        bad = np.abs(flat_t[name] - ref) > PARAM_ATOL
        tiny_g = np.abs(mu[name]) <= GRAD_RTOL * np.abs(mu[name]).max()
        assert not (bad & ~tiny_g).any(), name
        off, total = off + int(bad.sum()), total + ref.size
        assert np.abs(flat_t[name] - before[name]).max() <= 1e-3 * (
            1 + 1e-3) + 1e-4 * np.abs(before[name]).max(), name
        moved = max(moved, float(np.abs(ref - before[name]).max()))
    assert off <= 1e-4 * total, (off, total)
    assert moved > 5e-4


def test_tied_gates_split_their_gradient_as_jax():
    """Router logits with exact ties (two experts tied for first, a row
    tied across all four): ``amax``'s backward splits the gradient evenly
    among the tied entries, as JAX's ``max``; ``max(dim)`` would send all
    of it to one index."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 4)).astype(np.float32)
    logits[0, 0, 1] = logits[0, 0, 2] = logits[0, 0].max() + 1.0
    logits[0, 1] = 0.5
    logits[1, 3, 0] = logits[1, 3, 3] = logits[1, 3].max() + 0.5
    w = rng.standard_normal((2, 6, 4, 3)).astype(np.float32)

    def loss_j(x):
        _, combine, aux = jm.route_tokens(x, 2, 3)
        return (combine * w).sum() + 0.1 * aux

    ref = np.asarray(jax.jit(jax.grad(loss_j))(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    _, combine, aux = tm.route_tokens(x, 2, 3)
    got = torch.autograd.grad((combine * torch.from_numpy(w)).sum()
                              + 0.1 * aux, x)[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert np.abs(ref[0, 1]).max() > 1e-3   # the all-tied row has a gradient

    # the split itself, on one round's gate: equal shares of the tie
    probs = torch.softmax(torch.from_numpy(logits[:1, :2]), -1)
    probs.requires_grad_()
    g_amax = torch.autograd.grad(probs.amax(-1).sum(), probs)[0]
    g_max = torch.autograd.grad(probs.max(-1).values.sum(), probs)[0]
    np.testing.assert_allclose(g_amax[0, 0, 1:3].numpy(), [0.5, 0.5])
    np.testing.assert_allclose(g_amax[0, 1].numpy(), [0.25] * 4)
    assert g_max[0, 1].max().item() == 1.0


def test_train_step_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="item 9"):
        tm.make_moe_train_step(tm.MoEConfig.tiny(), adamw(1e-3),
                               mesh=object())
