"""The port's LoRA adapters against the JAX package's, on
``LlamaConfig.tiny()`` and ``MoEConfig.tiny()`` (f32) with converted base
parameters and adapters and numpy-seeded tokens.

Tolerances (f32 on the CPU, the same math in another summation order): the
loss ``1e-5``; adapter gradients ``1e-5`` of each leaf's largest magnitude;
adapters after one ``adamw(1e-3)`` step ``2e-5`` and the moments as in
``tests/test_torch_train.py``.  The base tree is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import lora as jlora
from kubegpu_tpu.models import moe as jm
from kubegpu_tpu_torch.convert import (
    convert_llama_params,
    convert_lora_adapters,
    convert_moe_params,
)
from kubegpu_tpu_torch.models import lora as tlora
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import moe as tm
from kubegpu_tpu_torch.optim import adamw
from kubegpu_tpu_torch.tree import tree_leaves

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 2e-5
LCFG = dict(rank=4, alpha=8.0, targets=("wq", "wv", "w_up"))


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


def _adapters_j(params_j, lcfg):
    """The reference's adapters with ``b`` drawn too (at init it is zero,
    which leaves ``a`` without a gradient)."""
    ad = jlora.lora_init(jax.random.PRNGKey(1), params_j, lcfg)
    return {k: {"a": v["a"], "b": 0.05 * jax.random.normal(
        jax.random.PRNGKey(7 + i), v["b"].shape)}
        for i, (k, v) in enumerate(ad.items())}


@pytest.fixture(scope="module")
def llama():
    cfg_j = jl.LlamaConfig.tiny()
    params_j = jax.jit(jl.llama_init, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j)
    lcfg_j = jlora.LoRAConfig(**LCFG)
    tokens = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (4, 24))
    return (cfg_j, params_j, lcfg_j, _adapters_j(params_j, lcfg_j),
            tl.LlamaConfig.tiny(), tlora.LoRAConfig(**LCFG), tokens)


def _base(params_j, convert=convert_llama_params):
    return convert(jax.tree.map(np.asarray, params_j), device="cpu")


def _adapters(ad_j):
    ad = convert_lora_adapters(jax.tree.map(np.asarray, ad_j), device="cpu")
    for p in tree_leaves(ad):
        p.requires_grad_()
    return ad


def test_merge_at_init_is_the_base_bit_for_bit(llama):
    _, params_j, _, _, _, lcfg, _ = llama
    base = _base(params_j)
    ad = tlora.lora_init(base, lcfg, seed=3, device="cpu")
    assert set(ad) == set(LCFG["targets"])
    for name, ab in ad.items():
        ell, d_in, d_out = base["layers"][name].shape
        assert ab["a"].shape == (ell, d_in, 4) and ab["b"].shape == (
            ell, 4, d_out)
        assert ab["a"].dtype == base["layers"][name].dtype
        assert not ab["b"].any() and ab["a"].std() > 0
    merged = tlora.lora_merge(base, ad, lcfg)
    for a, b in zip(tree_leaves(merged), tree_leaves(base)):
        assert torch.equal(a, b)


def test_n_params_and_config_errors(llama):
    _, params_j, lcfg_j, _, _, lcfg, _ = llama
    ad = tlora.lora_init(_base(params_j), lcfg, device="cpu")
    assert tlora.lora_n_params(ad) == jlora.lora_n_params(
        jlora.lora_init(jax.random.PRNGKey(0), params_j, lcfg_j))
    assert tlora.LoRAConfig().scaling == jlora.LoRAConfig().scaling == 2.0
    assert tlora.DEFAULT_TARGETS == jlora.DEFAULT_TARGETS
    assert tlora.ADAPTABLE == jlora.ADAPTABLE
    for bad in (dict(rank=0), dict(targets=("wq", "embed"))):
        with pytest.raises(ValueError) as got:
            tlora.LoRAConfig(**bad)
        with pytest.raises(ValueError) as want:
            jlora.LoRAConfig(**bad)
        assert str(got.value) == str(want.value)


def test_merge_loss_and_adapter_grads_match(llama):
    """The reference's ``adapter_loss`` (merge, then the next-token loss)
    and its gradient in the adapters, from converted adapters."""
    cfg_j, params_j, lcfg_j, ad_j, cfg, lcfg, tokens = llama

    def adapter_loss(adapters):
        return jl.next_token_loss(jlora.lora_merge(params_j, adapters,
                                                   lcfg_j),
                                  jnp.asarray(tokens, jnp.int32), cfg_j)

    loss_j, grads_j = jax.jit(jax.value_and_grad(adapter_loss))(ad_j)
    base, ad = _base(params_j), _adapters(ad_j)
    merged = tlora.lora_merge(base, ad, lcfg)
    ref_merged = _flat_jax(jlora.lora_merge(params_j, ad_j, lcfg_j))
    for name, v in _flat_torch(merged).items():
        np.testing.assert_allclose(v, ref_merged[name], atol=1e-6,
                                   err_msg=name)
    loss = tl.next_token_loss(merged, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=LOSS_ATOL)
    grads = torch.autograd.grad(loss, tree_leaves(ad))
    ref = _flat_jax(grads_j)
    names = list(_flat_torch(ad))
    assert set(names) == set(ref)
    for name, g in zip(names, grads):
        scale = np.abs(ref[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), ref[name],
                                   atol=GRAD_RTOL * scale, err_msg=name)


def _step_matches(step_j, opt_j, ad_j, params_j, tokens, step, base, ad,
                  opt) -> None:
    new_j, state_j, loss_j = jax.jit(step_j)(
        ad_j, opt_j.init(ad_j), params_j, jnp.asarray(tokens, jnp.int32))
    base_bytes = [p.clone() for p in tree_leaves(base)]
    new, state, loss = step(ad, opt.init(ad), base, torch.from_numpy(tokens))
    assert state["count"] == 1
    np.testing.assert_allclose(loss.item(), float(loss_j), atol=LOSS_ATOL)
    # freeze by construction: the base is untouched and holds no gradient
    for p, before in zip(tree_leaves(base), base_bytes):
        assert not p.requires_grad and p.grad is None
        assert torch.equal(p, before)
    assert set(state["mu"]) == set(ad)   # moments for the adapters only
    for mom, k in (("mu", 1), ("nu", 2)):
        ref_m = _flat_jax(getattr(state_j[0], mom))
        got_m = _flat_torch(state[mom])
        assert set(ref_m) == set(got_m)
        for name, r in ref_m.items():
            np.testing.assert_allclose(
                got_m[name], r, rtol=1e-5,
                atol=k * GRAD_RTOL * np.abs(r).max(), err_msg=f"{mom} {name}")
    flat_j, flat_t = _flat_jax(new_j), _flat_torch(new)
    assert set(flat_j) == set(flat_t)
    before = _flat_jax(ad_j)
    moved = 0.0
    for name, r in flat_j.items():
        np.testing.assert_allclose(flat_t[name], r, atol=PARAM_ATOL,
                                   err_msg=name)
        moved = max(moved, float(np.abs(r - before[name]).max()))
    assert moved > 5e-4


def test_train_step_matches_jax(llama):
    """One ``make_lora_train_step`` + ``adamw(1e-3)``: the loss, the
    moments (adapters only) and the updated adapters; the base tree is
    unchanged bit for bit and no base leaf got a ``.grad``."""
    cfg_j, params_j, lcfg_j, ad_j, cfg, lcfg, tokens = llama
    opt_j, opt = optax.adamw(1e-3), adamw(1e-3)
    _step_matches(jlora.make_lora_train_step(cfg_j, lcfg_j, opt_j), opt_j,
                  ad_j, params_j, tokens,
                  tlora.make_lora_train_step(cfg, lcfg, opt), _base(params_j),
                  _adapters(ad_j), opt)


def test_moe_train_step_matches_jax():
    """The MoE family through ``loss_fn=moe_next_token_loss``: adapters on
    its attention targets."""
    cfg_j = jm.MoEConfig.tiny()
    params_j = jax.jit(jm.moe_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                       cfg_j)
    lcfg_j, lcfg = jlora.LoRAConfig(rank=4), tlora.LoRAConfig(rank=4)
    ad_j = _adapters_j(params_j, lcfg_j)
    tokens = np.random.default_rng(1).integers(0, cfg_j.base.vocab_size,
                                               (2, 24))
    opt_j, opt = optax.adamw(1e-3), adamw(1e-3)
    _step_matches(
        jlora.make_lora_train_step(cfg_j, lcfg_j, opt_j,
                                   loss_fn=jm.moe_next_token_loss),
        opt_j, ad_j, params_j, tokens,
        tlora.make_lora_train_step(tm.MoEConfig.tiny(), lcfg, opt,
                                   loss_fn=tm.moe_next_token_loss),
        _base(params_j, convert_moe_params), _adapters(ad_j), opt)


def test_train_step_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="item 9"):
        tlora.make_lora_train_step(tl.LlamaConfig.tiny(), tlora.LoRAConfig(),
                                   adamw(1e-3), mesh=object())
