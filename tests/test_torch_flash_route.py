"""The route rule of kernels 1 and 3, and the tensor-core instances'
arithmetic modelled on the CPU.

``_flash_route`` sends bf16 at head dims 64 and 128 to the tensor-core
instances (wgmma + TMA) and everything else to the CUDA-core ones.  The
tensor-core instances round differently from the CUDA-core ones: the
forward rounds p to bf16 before P.V, and dk/dv round p and ds to bf16
before dV and dK, with f32 sums, as the JAX package's Pallas kernels do.
The model below repeats that arithmetic in plain PyTorch and is held to

- the port's f32 plain versions (``xla_attention``, ``_xla_lse``,
  ``flash_attention_bwd_ref``) within the card check's own limits (forward
  |err| per unit of max(1, |ref|) 2e-2, lse 1e-3, backward max |err| over
  max |ref| 1e-2), at the serving shape's group of 4 and head dim 128;
- the JAX Pallas forward and backward in interpret mode, on the same bf16
  inputs, within the same limits.

So a kernel with the reference's roundings can meet the card's limits as
they stand.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.ops.flash_attention import flash_attention as jax_flash
from kubegpu_tpu.ops.flash_attention import flash_attention_bwd as jax_bwd
from kubegpu_tpu_torch.ops.flash_attention import (
    LOG2E,
    NEG_INF,
    _flash_route,
    _xla_lse,
    flash_attention_bwd_ref,
    repeat_kv,
    xla_attention,
)

LN2 = 0.6931471805599453


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 64, 80, 128, 256])
def test_flash_route(dtype, head_dim):
    want = ("tc" if dtype == torch.bfloat16 and head_dim in (64, 128)
            else "simt")
    assert _flash_route(dtype, head_dim) == want


@pytest.mark.parametrize("name,route", [("flash_fwd", None),
                                        ("flash_bwd_dkv", None),
                                        ("flash_fwd", "wgmma"),
                                        ("paged_decode", "tc")])
def test_call_refuses_a_route_that_does_not_fit(name, route):
    """Kernels 1 and 3 need a route, every other kernel takes none, and a
    route must be one of ``kernels.ROUTES``'; checked before any library
    is loaded, so no launch is counted."""
    from kubegpu_tpu_torch import kernels
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="route"):
        kernels.call(name, route=route)
    assert kernels.launches == before


def _mask(t, s, causal):
    """[t, s] True where query i sees key j (end-aligned causal)."""
    if not causal:
        return torch.ones(t, s, dtype=torch.bool)
    return torch.ones(t, s, dtype=torch.bool).tril(s - t)


def model_forward(q, k, v, causal, bn=128):
    """The tensor-core forward's arithmetic: 128-key tiles, an online
    softmax in f32 with log2(e) folded into the scale, p rounded to bf16
    before P.V (f32 sums), the output rounded to bf16; lse in natural
    log."""
    b, hq, t, d = q.shape
    s = k.shape[2]
    kr, vr = (x.float() for x in repeat_kv(q, k, v))
    qf = q.float()
    sscale = d ** -0.5 * LOG2E
    mask = _mask(t, s, causal)
    m = torch.full((b, hq, t, 1), NEG_INF)
    l = torch.zeros(b, hq, t, 1)
    o = torch.zeros(b, hq, t, d)
    for k0 in range(0, s, bn):
        mk = mask[:, k0:k0 + bn]
        sc = torch.einsum("bhtd,bhsd->bhts", qf, kr[:, :, k0:k0 + bn]) * sscale
        sc = sc.masked_fill(~mk, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp2(sc - m_new).masked_fill(~mk, 0.0)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhts,bhsd->bhtd",
                                     p.bfloat16().float(),
                                     vr[:, :, k0:k0 + bn])
        m = m_new
    l_safe = l.clamp(min=1e-30)
    return (o / l_safe).bfloat16(), (m * LN2 + torch.log(l_safe))[..., 0]


def model_dkv(q, k, v, do, lse, delta, causal):
    """The tensor-core dk/dv's arithmetic: p from the saved lse in exp2,
    ds = p (dp - delta) scale in f32, p and ds rounded to bf16 before
    dV = p^T dO and dK = ds^T Q (f32 sums), summed over the query group,
    rounded to bf16."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = d ** -0.5
    kr, vr = (x.float() for x in repeat_kv(q, k, v))
    sc = torch.einsum("bhtd,bhsd->bhts", q.float(), kr) * (scale * LOG2E)
    p = torch.exp2(sc - lse[..., None] * LOG2E)
    p = p.masked_fill(~_mask(t, s, causal), 0.0)
    dp = torch.einsum("bhtd,bhsd->bhts", do.float(), vr)
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("bhts,bhtd->bhsd", p.bfloat16().float(), do.float())
    dk = torch.einsum("bhts,bhtd->bhsd", ds.bfloat16().float(), q.float())
    g = hq // hkv
    return (dk.view(b, hkv, g, s, d).sum(2).bfloat16(),
            dv.view(b, hkv, g, s, d).sum(2).bfloat16())


def _bf16_inputs(b, hq, hkv, t, s, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, hq, t, d), np.float32))
             .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, hkv, s, d), np.float32))
            .bfloat16() for _ in range(2))
    return q, k, v, do


def _scaled_err(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs() / ref.abs().clamp(min=1)).max().item()


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("causal", [True, False])
def test_tc_model_meets_the_card_limits(causal):
    """At [1, 8, 512, 128] vs [1, 2, 512, 128] (group 4), the model's
    forward against the f32 plain forward on the same bf16 values, and its
    dk/dv against ``flash_attention_bwd_ref`` in f32 from the model's own
    out and lse (as the card check feeds the kernel's)."""
    q, k, v, do = _bf16_inputs(1, 8, 2, 512, 512, 128, seed=0)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    out, lse = model_forward(q, k, v, causal)
    assert _scaled_err(out, xla_attention(qf, kf, vf, causal)) <= 2e-2
    assert (lse - _xla_lse(qf, kf, causal, 128 ** -0.5)).abs().max() <= 1e-3
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = model_dkv(q, k, v, do, lse, delta, causal)
    _, rk, rv = flash_attention_bwd_ref(qf, kf, vf, out.float(), lse, dof,
                                        causal)
    assert _rel_err(dk, rk) <= 1e-2
    assert _rel_err(dv, rv) <= 1e-2


def test_tc_model_matches_pallas():
    """At T = S = 256 (group 2, head dim 128, causal), the model against
    the JAX Pallas kernels in interpret mode on the same bf16 inputs: the
    forward (out, lse), then dk/dv from the same out and lse."""
    q, k, v, do = _bf16_inputs(1, 4, 2, 256, 256, 128, seed=1)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                       for x in (q, k, v, do))
    jo, jl = jax_flash(jq, jk, jv, causal=True, block_q=128, block_k=128,
                       interpret=True, return_lse=True)
    out, lse = model_forward(q, k, v, True)
    j_out = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    assert _scaled_err(out, j_out) <= 2e-2
    assert (lse - torch.from_numpy(np.array(jl))).abs().max() <= 1e-3
    # the same residuals into both backwards
    j_out_bf = jnp.asarray(out.float().numpy(), jnp.bfloat16)
    _, jdk, jdv = jax_bwd(jq, jk, jv, j_out_bf, jnp.asarray(lse.numpy()),
                          jdo, causal=True, block_q=64, block_k=128,
                          interpret=True)
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = model_dkv(q, k, v, do, lse, delta, True)
    for got, ref in ((dk, jdk), (dv, jdv)):
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
        assert _rel_err(got, ref) <= 1e-2
