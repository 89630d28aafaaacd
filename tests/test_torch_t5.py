"""The port's T5 family against the JAX package's, on ``T5Config.tiny()``
(f32) with the same (converted) parameters and the same numpy tokens.

The JAX side runs jitted on the CPU; its paged generate reaches kernel 7
through ``paged_attention_biased`` in interpret mode, as its own tests run
it.  Tolerances (f32 on the CPU, the same math summed in another order):
``1e-4`` on logits (encoder states and logits of size ~1-5), ``3e-4``
between cached decode and teacher forcing (the JAX package's own bound),
``1e-5`` on the loss, ``1e-6`` on gradients and ``2e-5`` on updated
parameters whose gradient is at least ``1e-6``.  At step 1 AdamW moves a
parameter by ``lr * g / (|g| + eps)``, about ``lr`` = 1e-3 whatever the
gradient's size; for a gradient near ``eps`` = 1e-8 (the smallest here are
~1e-8) that ratio turns by tens of percent when the gradient differs in its
third digit, so there both updates are only held to their common bound,
``2 * lr``.  Greedy tokens are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import t5 as jt
from kubegpu_tpu_torch.convert import convert_t5_params
from kubegpu_tpu_torch.models import t5 as tt
from kubegpu_tpu_torch.optim import adamw
from kubegpu_tpu_torch.tree import tree_leaves

LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-6
PARAM_ATOL = 2e-5


def _tokens(seed, b, t, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _convert(params_j, grad=False):
    params = convert_t5_params(jax.tree.map(np.asarray, params_j),
                               device="cpu")
    for p in tree_leaves(params) if grad else ():
        p.requires_grad_()
    return params


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict)
                   else {name: np.asarray(v.detach() if isinstance(
                       v, torch.Tensor) else v)})
    return out


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jt.T5Config.tiny()
    params_j = jt.t5_init(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, params_j, tt.T5Config.tiny(), _convert(params_j)


def test_init_has_the_reference_layout(tiny):
    cfg_j, params_j, cfg, _ = tiny
    got = _flat(tt.t5_init(cfg, seed=0, device="cpu"))
    ref = _flat(params_j)
    assert list(got) == list(ref)
    for name, r in ref.items():
        assert got[name].shape == r.shape and got[name].dtype == r.dtype, name
    assert tt.T5Config().head_dim == 64 and cfg.tdtype == torch.float32


def test_encode_and_forward_match_jax(tiny):
    cfg_j, params_j, cfg, params = tiny
    enc, dec = _tokens(1, 2, 12), _tokens(2, 2, 8)
    ref_e = jax.jit(jt.t5_encode, static_argnums=2)(params_j,
                                                    jnp.asarray(enc), cfg_j)
    ref = jax.jit(jt.t5_forward, static_argnums=3)(
        params_j, jnp.asarray(enc), jnp.asarray(dec), cfg_j)
    got_e = tt.t5_encode(params, torch.from_numpy(enc), cfg)
    got = tt.t5_forward(params, torch.from_numpy(enc), torch.from_numpy(dec),
                        cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 8, cfg.vocab_size)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(ref_e),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_ATOL)


def test_decode_steps_match_jax_and_teacher_forcing(tiny):
    cfg_j, params_j, cfg, params = tiny
    enc, dec = _tokens(20, 2, 10), _tokens(21, 2, 8)
    enc_j = jax.jit(jt.t5_encode, static_argnums=2)(params_j,
                                                    jnp.asarray(enc), cfg_j)
    state_j = jt.t5_init_decode_state(params_j, enc_j, cfg_j, max_len=8)
    step_j = jax.jit(jt.t5_decode_step, static_argnums=4)
    enc_out = tt.t5_encode(params, torch.from_numpy(enc), cfg)
    teacher = tt.t5_decode_train(params, enc_out, torch.from_numpy(dec), cfg)
    state = tt.t5_init_decode_state(params, enc_out, cfg, max_len=8)
    for pos in range(8):
        ref, state_j = step_j(params_j, state_j, jnp.asarray(dec[:, pos]),
                              pos, cfg_j)
        got, state = tt.t5_decode_step(params, state,
                                       torch.from_numpy(dec[:, pos]).long(),
                                       pos, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=LOGIT_ATOL, err_msg=f"pos {pos}")
        np.testing.assert_allclose(got.numpy(), teacher[:, pos].numpy(),
                                   atol=3e-4, rtol=3e-4, err_msg=f"pos {pos}")
    np.testing.assert_allclose(state["k"].numpy(), np.asarray(state_j["k"]),
                               atol=1e-5)


# the JAX package's TestT5OnPages setups: 11 steps over page_size 4 (two
# flushed pages and a partial third block: pool reads and buffer merge), and
# a single block with no flush
PAGED = {"three_blocks": (5, np.arange(2 * 9).reshape(2, 9) % 256, 11, 4),
         "one_block": (6, (np.arange(3 * 6).reshape(3, 6) * 5) % 256, 3, 8)}


@pytest.mark.parametrize("case", list(PAGED), ids=list(PAGED))
def test_greedy_generate_dense_and_paged_match_jax(case):
    seed, enc, n_steps, page = PAGED[case]
    cfg_j, cfg = jt.T5Config.tiny(), tt.T5Config.tiny()
    params_j = jt.t5_init(jax.random.PRNGKey(seed), cfg_j)
    params = _convert(params_j)
    enc = enc.astype(np.int32)
    ref_dense = np.asarray(jt.t5_greedy_generate(
        params_j, jnp.asarray(enc), n_steps, cfg_j, max_len=16))
    ref_paged = np.asarray(jt.t5_greedy_generate_paged(
        params_j, jnp.asarray(enc), n_steps, cfg_j, page_size=page))
    dense = tt.t5_greedy_generate(params, enc, n_steps, cfg, max_len=16,
                                  device="cpu")
    paged = tt.t5_greedy_generate_paged(params, enc, n_steps, cfg,
                                        page_size=page, device="cpu")
    assert dense.shape == paged.shape == (enc.shape[0], n_steps)
    np.testing.assert_array_equal(ref_dense, ref_paged)
    np.testing.assert_array_equal(dense.numpy(), ref_dense)
    np.testing.assert_array_equal(paged.numpy(), ref_paged)


def test_generate_validation(tiny):
    _, _, cfg, params = tiny
    enc = _tokens(23, 1, 6)
    with pytest.raises(ValueError, match="n_steps"):
        tt.t5_greedy_generate(params, enc, 0, cfg, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        tt.t5_greedy_generate(params, enc, 9, cfg, max_len=4, device="cpu")
    with pytest.raises(ValueError, match="n_steps"):
        tt.t5_greedy_generate_paged(params, enc, 0, cfg, device="cpu")


def test_mesh_waits_for_multi_device(tiny):
    _, _, cfg, params = tiny
    enc = torch.from_numpy(_tokens(24, 1, 6))
    with pytest.raises(NotImplementedError, match="item 9"):
        tt.t5_encode(params, enc, cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        tt.make_t5_train_step(cfg, adamw(1e-3), mesh=object())


@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_and_train_step_match_jax(tiny, remat):
    """``seq2seq_loss``, every leaf's gradient, and one
    ``make_t5_train_step`` + ``adamw(1e-3)`` update against JAX +
    ``optax.adamw(1e-3)``; with ``remat`` each layer is recomputed in the
    backward on both sides."""
    cfg_j, params_j, cfg, _ = tiny
    cfg_j = dataclasses.replace(cfg_j, remat=remat)
    cfg = dataclasses.replace(cfg, remat=remat)
    enc, dec = _tokens(7, 4, 10), _tokens(8, 4, 9)
    args_j = (jnp.asarray(enc), jnp.asarray(dec))
    args = (torch.from_numpy(enc), torch.from_numpy(dec))
    loss_j, grads_j = jax.jit(jax.value_and_grad(jt.seq2seq_loss),
                              static_argnums=3)(params_j, *args_j, cfg_j)
    params = _convert(params_j, grad=True)
    loss = tt.seq2seq_loss(params, *args, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=LOSS_ATOL)
    ref_g = _flat(grads_j)
    for (name, r), g in zip(ref_g.items(), grads, strict=True):
        np.testing.assert_allclose(g.numpy(), r, atol=GRAD_ATOL,
                                   err_msg=name)

    opt_j = optax.adamw(1e-3)
    new_j, _, step_loss_j = jax.jit(jt.make_t5_train_step(cfg_j, opt_j))(
        params_j, opt_j.init(params_j), *args_j)
    opt = adamw(1e-3)
    step = tt.make_t5_train_step(cfg, opt)
    new, state, step_loss = step(params, opt.init(params), *args)
    assert state["count"] == 1
    np.testing.assert_allclose(step_loss.item(), float(step_loss_j),
                               atol=LOSS_ATOL)
    ref_p = _flat(new_j)
    for name, p in _flat(new).items():
        steady = np.abs(ref_g[name]) >= 1e-6
        np.testing.assert_allclose(p[steady], ref_p[name][steady],
                                   atol=PARAM_ATOL, err_msg=name)
        assert np.abs(p - ref_p[name]).max() <= 2e-3, name


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


@pytest.mark.parametrize("remat", [False, True])
def test_unbound_stacks_give_equal_grads_and_one_stack_per_leaf(
        tiny, remat, monkeypatch):
    """``t5_encode`` and ``t5_decode_train`` unbind the encoder and decoder
    stacks once per forward: every gradient equals the per-layer-index
    form's under ``torch.equal``, and each stacked leaf's gradient comes
    from one ``unbind`` backward (one ``stack``), with no
    ``select_backward`` (the old form had one a layer and leaf)."""
    cfg_j, params_j, cfg, _ = tiny
    cfg = dataclasses.replace(cfg, remat=remat)
    params = _convert(params_j, grad=True)
    args = (torch.from_numpy(_tokens(9, 2, 10)),
            torch.from_numpy(_tokens(10, 2, 7)))
    leaves = tree_leaves(params)
    stacked = [*params["encoder"].values(), *params["decoder"].values()]
    loss = tt.seq2seq_loss(params, *args, cfg)
    assert _leaf_grad_ops(loss, stacked) == {"UnbindBackward0": len(stacked)}
    grads = torch.autograd.grad(loss, leaves)
    monkeypatch.setattr(tt, "unbind_layers", _indexed_per_layer)
    loss = tt.seq2seq_loss(params, *args, cfg)
    assert _leaf_grad_ops(loss, stacked) == {"SelectBackward0": sum(
        len(leaf) for leaf in stacked)}
    old = torch.autograd.grad(loss, leaves)
    for g, r in zip(grads, old, strict=True):
        assert torch.equal(g, r)
