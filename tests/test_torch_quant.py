"""The port's int8 weights (``models/quant.py``) against the JAX package's:
``quantize`` byte for byte, the trees it makes, ``x @ QTensor`` (rtol
``1e-5``, f32 on the CPU in another summation order), the conversion of a
quantized reference tree, and ``llama_forward`` on int8 weights (``1e-4``,
as the model-dtype forward's test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models import quant as jq
from kubegpu_tpu.models import t5 as jt
from kubegpu_tpu_torch.convert import convert_llama_params, convert_t5_params
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.models import quant as tq
from kubegpu_tpu_torch.models import t5 as tt
from kubegpu_tpu_torch.tree import tree_leaves


def _weights(shape, seed=0, zero_channel=True):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_channel:
        w[..., 1] = 0.0          # an all-zero channel: scale 1
    return w


@pytest.mark.parametrize("shape,batch_dims", [
    ((7,), 0), ((16, 24), 0), ((3, 16, 24), 1), ((3, 16, 24), 0),
    ((2, 3, 8, 12), 1), ((2, 3, 8, 12), 2)])
def test_quantize_equals_reference_bytes(shape, batch_dims):
    w = _weights(shape)
    # ties at .5 after the division, so round-half-even is exercised
    w.reshape(-1)[:5] = np.array([63.5, -63.5, 0.5, 127.0, -127.0]) / 127
    ref = jq.quantize(jnp.asarray(w), batch_dims=batch_dims)
    got = tq.quantize(torch.from_numpy(w), batch_dims=batch_dims)
    assert got.values.dtype == torch.int8
    assert got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.shape == ref.shape and got.ndim == ref.ndim
    assert got.nbytes == ref.nbytes


def test_dequantize_and_bf16_input():
    w = _weights((3, 16, 24))
    ref = jq.quantize(jnp.asarray(w).astype(jnp.bfloat16), batch_dims=1)
    got = tq.quantize(torch.from_numpy(w).to(torch.bfloat16), batch_dims=1)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            got.dequantize(td).float().numpy(),
            np.asarray(ref.dequantize(jd).astype(jnp.float32)))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("wshape,bd,xshape", [
    ((16, 24), 0, (16,)),            # 1-D x: the contracted slot goes
    ((16, 24), 0, (5, 16)),
    ((16, 24), 0, (2, 5, 16)),
    ((3, 16, 24), 1, (16,)),         # stacked values, 1-D x: [L, out]
    ((3, 16, 24), 1, (5, 16)),       # stacked values, batched x: [L, B, out]
])
def test_rmatmul_matches_reference(wshape, bd, xshape):
    w, x = _weights(wshape), _x(xshape)
    ref = jnp.asarray(x) @ jq.quantize(jnp.asarray(w), batch_dims=bd)
    got = torch.from_numpy(x) @ tq.quantize(torch.from_numpy(w),
                                            batch_dims=bd)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("xshape", [(16,), (5, 16), (2, 5, 16)])
def test_unbound_layers_match_reference_slices(xshape):
    """``unbind`` slices values [in, out] and scales [1, out] in lockstep;
    each layer's product equals the reference's with the stacked leaf
    indexed as its scan slices it."""
    w, x = _weights((3, 16, 24)), _x(xshape)
    ref_q = jq.quantize(jnp.asarray(w), batch_dims=1)
    parts = tq.quantize(torch.from_numpy(w), batch_dims=1).unbind(0)
    assert len(parts) == 3
    for i, part in enumerate(parts):
        assert tuple(part.values.shape) == (16, 24)
        assert tuple(part.scale.shape) == (1, 24)
        ref = jnp.asarray(x) @ jq.QTensor(ref_q.values[i], ref_q.scale[i])
        got = torch.from_numpy(x) @ part
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def _flat(tree, prefix=""):
    """{path: leaf} with a quantized leaf kept whole."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def llama():
    cfg_j = jl.LlamaConfig.tiny()
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    return cfg_j, params_j, tl.LlamaConfig.tiny(), params_t


def _check_tree(ref_q, got_q, got_src):
    ref_flat, got_flat = _flat(ref_q), _flat(got_q)
    assert set(ref_flat) == set(got_flat)
    for path, r in ref_flat.items():
        g = got_flat[path]
        assert isinstance(g, tq.QTensor) == isinstance(r, jq.QTensor), path
        if isinstance(g, tq.QTensor):
            np.testing.assert_array_equal(g.values.numpy(),
                                          np.asarray(r.values))
            np.testing.assert_array_equal(g.scale.numpy(),
                                          np.asarray(r.scale))
        else:
            # full-precision leaves are passed through untouched
            assert g is _flat(got_src)[path], path
    assert tq.tree_nbytes(got_q) == jq.tree_nbytes(ref_q)
    assert len(tree_leaves(got_q)) == len(jax.tree.leaves(ref_q))


def test_quantize_llama_tree(llama):
    _, params_j, _, params_t = llama
    ref_q = jq.quantize_llama(params_j)
    got_q = tq.quantize_llama(params_t)
    _check_tree(ref_q, got_q, params_t)
    assert tq.tree_nbytes(got_q) < tq.tree_nbytes(params_t)
    assert tq.tree_nbytes(params_t) == jq.tree_nbytes(params_j)


def test_quantize_t5_tree():
    cfg_j = jt.T5Config.tiny()
    params_j = jt.t5_init(jax.random.PRNGKey(3), cfg_j)
    params_t = convert_t5_params(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    _check_tree(jq.quantize_t5(params_j), tq.quantize_t5(params_t),
                params_t)


def test_convert_takes_a_quantized_tree(llama):
    """A quantized reference tree converts leaf for leaf: QTensor leaves
    become the port's, int8 values stay int8 whatever ``dtype`` says, and
    only float leaves are cast."""
    _, params_j, _, params_t = llama
    ref_q = jq.quantize_llama(params_j)
    got = convert_llama_params(jax.tree.map(np.asarray, ref_q),
                               device="cpu")
    _check_tree(ref_q, got, got)
    cast = convert_llama_params(jax.tree.map(np.asarray, ref_q),
                                device="cpu", dtype=torch.bfloat16)
    wq = cast["layers"]["wq"]
    assert isinstance(wq, tq.QTensor)
    assert wq.values.dtype == torch.int8 and wq.scale.dtype == torch.float32
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["attn_norm"].dtype == torch.bfloat16
    moved = wq.to("cpu")
    assert isinstance(moved, tq.QTensor)
    assert torch.equal(moved.values, wq.values)
    assert torch.equal(moved.scale, wq.scale)


@pytest.mark.parametrize("t", [16, 33])
def test_forward_logits_on_int8_weights(llama, t):
    cfg_j, params_j, cfg, params_t = llama
    tokens = np.random.default_rng(t).integers(0, cfg.vocab_size, (2, t))
    ref = jl.llama_forward(jq.quantize_llama(params_j),
                           jnp.asarray(tokens, jnp.int32), cfg_j)
    out = tl.llama_forward(tq.quantize_llama(params_t),
                           torch.from_numpy(tokens), cfg)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
