"""The port's train step against the JAX package's, on ``LlamaConfig.tiny()``
with the same (converted) parameters and the same tokens.

The JAX side is ``make_train_step`` with ``optax.adamw``; the port's is its
own ``make_train_step`` with ``kubegpu_tpu_torch.optim.adamw``, whose
attention gradient goes through ``_FlashAttention`` (plain backward on the
CPU).  Tolerances (f32 on the CPU, same math in another summation order):
``1e-5`` on losses and ``1e-6`` on gradients (of size up to ~0.2; they
agree to ~2e-7).  Updated parameters: ``2e-5``, 2% of a step.  At step 1
AdamW moves each parameter by ``lr * g / (|g| + eps)``, about ``lr`` =
1e-3 whatever the gradient's size, but for a gradient within ~1e-7 of zero
(the smallest here are ~3e-8, next to ``eps`` = 1e-8) that ratio turns by
a few percent when the gradient differs in its seventh digit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.optim import adamw
from kubegpu_tpu_torch.tree import tree_leaves

LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-6
PARAM_ATOL = 2e-5


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
    cfg_j = jl.LlamaConfig.tiny()
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    tokens = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (4, 24))
    return cfg_j, params_j, tl.LlamaConfig.tiny(), tokens


def _torch_params(params_j):
    params = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                  device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    return params


def test_next_token_loss_matches(tiny):
    cfg_j, params_j, cfg, tokens = tiny
    ref = jl.next_token_loss(params_j, jnp.asarray(tokens, jnp.int32), cfg_j)
    got = tl.next_token_loss(_torch_params(params_j),
                             torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(ref), atol=LOSS_ATOL)


def test_grads_match_jax(tiny):
    """Every leaf's gradient of the loss; the attention part goes through
    ``_FlashAttention``'s backward."""
    cfg_j, params_j, cfg, tokens = tiny
    ref = _flat_jax(jax.grad(jl.next_token_loss)(
        params_j, jnp.asarray(tokens, jnp.int32), cfg_j))
    params = _torch_params(params_j)
    loss = tl.next_token_loss(params, torch.from_numpy(tokens), cfg)
    names = list(_flat_torch(params))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert set(names) == set(ref)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[name], atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_jax(tiny, accum_steps):
    """One step: the loss, every updated leaf and both moments match JAX +
    optax."""
    cfg_j, params_j, cfg, tokens = tiny
    opt_j = optax.adamw(1e-3)
    step_j = jl.make_train_step(cfg_j, opt_j, accum_steps=accum_steps)
    new_j, state_j, loss_j = step_j(params_j, opt_j.init(params_j),
                              jnp.asarray(tokens, jnp.int32))
    opt = adamw(1e-3)
    params = _torch_params(params_j)
    step = tl.make_train_step(cfg, opt, accum_steps=accum_steps)
    new, state, loss = step(params, opt.init(params),
                            torch.from_numpy(tokens))
    assert state["count"] == 1
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=LOSS_ATOL)
    # the moments carry the gradient's scale, which the first update
    # hides (a gradient off by a factor, as a missing / accum_steps makes
    # it, moves mu by that factor and nu by its square): mu = (1 - b1) g
    # and nu = (1 - b2) g², held to the gradients' own tolerance
    for mom, atol in (("mu", 0.1 * GRAD_ATOL), ("nu", 1e-3 * GRAD_ATOL)):
        ref_m = _flat_jax(getattr(state_j[0], mom))
        got_m = _flat_torch(state[mom])
        assert set(ref_m) == set(got_m)
        for name, ref in ref_m.items():
            np.testing.assert_allclose(got_m[name], ref, rtol=1e-5,
                                       atol=atol, err_msg=f"{mom} {name}")
    flat_j, flat_t = _flat_jax(new_j), _flat_torch(new)
    assert set(flat_j) == set(flat_t)
    moved = 0.0
    for name, ref in flat_j.items():
        np.testing.assert_allclose(flat_t[name], ref, atol=PARAM_ATOL,
                                   err_msg=name)
        moved = max(moved, float(np.abs(ref - _flat_jax(params_j)[name]
                                        ).max()))
    assert moved > 5e-4   # the step really moved the parameters


def test_remat_gives_the_same_grads(tiny):
    _, params_j, cfg, tokens = tiny
    grads = []
    for remat in (False, True):
        params = _torch_params(params_j)
        loss = tl.next_token_loss(params, torch.from_numpy(tokens),
                                  dataclasses.replace(cfg, remat=remat))
        grads.append(torch.autograd.grad(loss, tree_leaves(params)))
    for g0, g1 in zip(*grads):
        torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-7)


def test_adamw_matches_optax_over_three_updates():
    """Parameters within 1e-7 and moments within 1e-5 relative: the same
    f32 arithmetic, rounded at a few other places (torch's fused
    ``add_``/``addcmul_``)."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 5), np.float32),
          "b": {"c": rng.standard_normal((7,), np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape, np.float32),
                          p0) for _ in range(3)]
    opt_j = optax.adamw(1e-2)
    pj, sj = jax.tree.map(jnp.asarray, p0), opt_j.init(p0)
    opt = adamw(1e-2)
    pt = jax.tree.map(torch.from_numpy, p0)
    pt = {"a": pt["a"].clone(), "b": {"c": pt["b"]["c"].clone()}}
    st = opt.init(pt)
    for g in grads:
        u, sj = opt_j.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, u)
        st = opt.update(jax.tree.map(torch.from_numpy, g), st, pt)
        for name, ref in _flat_jax(pj).items():
            np.testing.assert_allclose(_flat_torch(pt)[name], ref,
                                       atol=1e-7, err_msg=name)
        for mom in ("mu", "nu"):
            for name, ref in _flat_jax(getattr(sj[0], mom)).items():
                np.testing.assert_allclose(_flat_torch(st[mom])[name], ref,
                                           rtol=1e-5, atol=1e-9)
    assert st["count"] == 3 and opt.weight_decay == 1e-4


def test_accum_steps_refuse_bad_values(tiny):
    _, params_j, cfg, tokens = tiny
    with pytest.raises(ValueError, match="accum_steps"):
        tl.make_train_step(cfg, adamw(1e-3), accum_steps=0)
    step = tl.make_train_step(cfg, adamw(1e-3), accum_steps=3)
    params = _torch_params(params_j)
    with pytest.raises(ValueError, match="not divisible"):
        step(params, adamw(1e-3).init(params), torch.from_numpy(tokens))


def _indexed_per_layer(stack):
    """The stacked leaves indexed once per layer: the form ``unbind_layers``
    replaced, whose backward builds a zero-filled full stack per layer."""
    n = len(next(iter(stack.values())))
    return [{k: leaf[i] for k, leaf in stack.items()} for i in range(n)]


def _leaf_grad_ops(loss, leaves) -> dict:
    """The autograd nodes of ``loss``'s backward that feed one of
    ``leaves``' gradients directly, counted by node type."""
    ops, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if any(getattr(nxt, "variable", None) is x for x in leaves):
                ops[type(fn).__name__] = ops.get(type(fn).__name__, 0) + 1
            todo.append(nxt)
    return ops


def _deep_tiny(remat):
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), n_layers=4, remat=remat)
    params = tl.llama_init(cfg, seed=3, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)))
    return cfg, params, tokens


@pytest.mark.parametrize("remat", [False, True])
def test_unbound_layers_give_equal_grads(remat, monkeypatch):
    """Unbinding the stacked leaves once per forward gives the gradients
    of indexing them once per layer, equal under ``torch.equal`` (the old
    path only added exact zeros), at 4 layers, with and without remat."""
    cfg, params, tokens = _deep_tiny(remat)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(tl.next_token_loss(params, tokens, cfg),
                                leaves)
    monkeypatch.setattr(tl, "unbind_layers", _indexed_per_layer)
    old = torch.autograd.grad(tl.next_token_loss(params, tokens, cfg),
                              leaves)
    for g, r in zip(grads, old, strict=True):
        assert torch.equal(g, r)


@pytest.mark.parametrize("remat", [False, True])
def test_stacked_leaf_backward_is_one_stack_per_leaf(remat, monkeypatch):
    """Pins the op count of one backward: each stacked leaf's gradient
    comes from one ``unbind`` backward (one ``stack``) and no
    ``select_backward``; the per-layer-index form had one select a layer
    and leaf, each a zero-filled full stack."""
    cfg, params, tokens = _deep_tiny(remat)
    stacked = list(params["layers"].values())
    loss = tl.next_token_loss(params, tokens, cfg)
    assert _leaf_grad_ops(loss, stacked) == {"UnbindBackward0": len(stacked)}
    monkeypatch.setattr(tl, "unbind_layers", _indexed_per_layer)
    loss = tl.next_token_loss(params, tokens, cfg)
    assert _leaf_grad_ops(loss, stacked) == {
        "SelectBackward0": len(stacked) * cfg.n_layers}


def test_adamw_updates_a_large_leaf_in_slices_bit_for_bit(monkeypatch):
    """Leaves over ``optim.CHUNK`` elements update slice by slice along
    dim 0 (temporaries of a slice, not of the leaf): the same parameters
    and moments, bit for bit, as one whole-leaf update, for stacked,
    ragged (rows that do not divide evenly) and scalar leaves."""
    from kubegpu_tpu_torch import optim
    gen = torch.Generator().manual_seed(0)
    shapes = {"stack": (5, 7, 3), "ragged": (301,), "mat": (2, 50),
              "scalar": ()}
    runs = []
    for chunk in (optim.CHUNK, 7):
        monkeypatch.setattr(optim, "CHUNK", chunk)
        gen.manual_seed(0)
        params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
        opt = adamw(1e-3)
        state = opt.init(params)
        for _ in range(3):
            grads = {k: torch.randn(s, generator=gen)
                     for k, s in shapes.items()}
            state = opt.update(grads, state, params)
        runs.append(tree_leaves(params) + tree_leaves(state["mu"])
                    + tree_leaves(state["nu"]))
    for whole, sliced in zip(*runs):
        assert torch.equal(whole, sliced)
