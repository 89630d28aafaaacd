"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import importlib

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch import kernels

fa = importlib.import_module("kubegpu_tpu_torch.ops.flash_attention")
pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")

pytestmark = pytest.mark.cuda

# row0: prompt 5 (page 7), decode at 8 with 3 written (page 1); row1:
# prompt 13 with a hole at row-local page 1; row2: empty; row3: prompt 3,
# decode at 8 with 11 written (pages 2 and 9)
PT = np.array([[7, 1, 2, 0], [3, 0, 5, 6], [0, 0, 0, 0], [4, 2, 9, 0]],
              np.int32)
STATE = np.array([[5, 13, 0, 3], [8, 16, 0, 8], [3, 0, 0, 11]], np.int32)


@pytest.fixture
def dev():
    """The card, decided at run time (a CPU host skips)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,causal,t,s", [
    (torch.bfloat16, True, 512, 512),
    (torch.float32, True, 37, 70),
    (torch.float32, False, 64, 40),
])
def test_flash_kernel_matches_plain(dev, dtype, causal, t, s):
    """out within 2e-2 in bf16 (output rounding) and 1e-4 in f32; lse
    within 1e-3 / 1e-4 (f32 sums in another order)."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((1, 8, t, 128), (1, 2, s, 128), (1, 2, s, 128)))
    before = kernels.launches["flash_fwd"]
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert kernels.launches["flash_fwd"] == before + 1
    ref = fa.xla_attention(q, k, v, causal=causal)
    ref_lse = fa._xla_lse(q, k, causal, 128 ** -0.5)
    bf16 = dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= (
        2e-2 if bf16 else 1e-4)
    assert (lse - ref_lse).abs().max().item() <= (1e-3 if bf16 else 1e-4)


@pytest.mark.parametrize("dtype,hq", [(torch.bfloat16, 8),
                                      (torch.float32, 32)])
def test_paged_kernel_matches_plain(dev, dtype, hq):
    """GQA 4 in bf16 and 4-position folded queries (G=16) in f32.  o within
    1e-2 in bf16 (the plain version rounds probabilities to bf16 before
    P.V, the kernel does not) and 1e-4 in f32; m within 1e-3; l within
    1e-3 relative."""
    g = torch.Generator(device=dev).manual_seed(0)
    pk, pv = (torch.randn(2, 12, 2, 8, 64, generator=g, device=dev).to(dtype)
              for _ in range(2))
    q = torch.randn(4, hq, 64, generator=g, device=dev).to(dtype)
    t, tpad, d = (torch.from_numpy(x).to(dev) for x in STATE)
    args = (q, pk, pv, torch.from_numpy(PT).to(dev), 1, t, tpad, d)
    (o, m, l), (ro, rm, rl) = (pa.paged_attention(*args),
                               pa.paged_attention_ref(*args))
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert (o - ro).abs().max().item() <= tol
    assert (m - rm).abs().max().item() <= 1e-3
    assert ((l - rl).abs() <= 1e-3 * rl).all()
    assert not o[2].any() and not l[2].any()        # the empty row


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 16), (torch.float32, 80),
                                      (torch.bfloat16, 96),
                                      (torch.float32, 256)])
def test_kernels_take_any_head_dim(dev, dtype, hd):
    """Head dims other than 64/128 run the padded instances of both
    kernels (16 is ``LlamaConfig.tiny()``'s); tolerances as above."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((2, 4, 37, hd), (2, 2, 50, hd), (2, 2, 50, hd)))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    bf16 = dtype == torch.bfloat16
    ref = fa.xla_attention(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= (
        2e-2 if bf16 else 1e-4)
    assert (lse - fa._xla_lse(q, k, True, hd ** -0.5)).abs().max().item() \
        <= (1e-3 if bf16 else 1e-4)
    pk, pv = (torch.randn(2, 12, 2, 8, hd, generator=g, device=dev).to(dtype)
              for _ in range(2))
    qd = torch.randn(4, 8, hd, generator=g, device=dev).to(dtype)
    t, tpad, d = (torch.from_numpy(x).to(dev) for x in STATE)
    args = (qd, pk, pv, torch.from_numpy(PT).to(dev), 1, t, tpad, d)
    (o, m, l), (ro, rm, rl) = (pa.paged_attention(*args),
                               pa.paged_attention_ref(*args))
    assert (o - ro).abs().max().item() <= (1e-2 if bf16 else 1e-4)
    assert (m - rm).abs().max().item() <= 1e-3
    assert ((l - rl).abs() <= 1e-3 * rl).all()


def _quantized(pk, pv, fmt):
    """Pools in format q8 or q4g<g>, by the port's quantizers."""
    kvq = importlib.import_module("kubegpu_tpu_torch.ops.kvquant")
    if fmt == "q8":
        (kq, ks), (vq, vs) = kvq.quantize_rows(pk), kvq.quantize_rows(pv)
    else:
        g = int(fmt[3:])
        (kq, ks), (vq, vs) = (kvq.quantize_groups_q4(x, g) for x in (pk, pv))
    return kq, vq, ks, vs


@pytest.mark.parametrize("fmt,dtype,hd,hq", [
    ("plain", torch.float32, 16, 8), ("plain", torch.bfloat16, 128, 8),
    ("q8", torch.float32, 16, 8), ("q8", torch.bfloat16, 64, 8),
    ("q8", torch.float32, 128, 32), ("q4g1", torch.float32, 16, 8),
    ("q4g4", torch.bfloat16, 64, 8), ("q4g8", torch.float32, 128, 32),
    ("q4g2", torch.float32, 64, 4)])
def test_quant_and_mass_kernels_match_plain(dev, fmt, dtype, hd, hq):
    """Kernels 5 (int8) and 6 (int4, groups of 1, 2, 4 and P = 8 keys) and
    the mass output of kernels 4-6 against ``paged_attention_ref``: o
    within 1e-2 in bf16 and 1e-4 in f32, m within 1e-3, l within 1e-3
    relative, the mass within 1e-3 in bf16 and 1e-5 in f32; the partials
    with and without the mass are the same.  hq=32 folds 4 query
    positions into a group of 4."""
    g = torch.Generator(device=dev).manual_seed(0)
    pk, pv = (torch.randn(2, 12, 2, 8, hd, generator=g, device=dev).to(dtype)
              for _ in range(2))
    kq, vq, ks, vs = (pk, pv, None, None) if fmt == "plain" else \
        _quantized(pk, pv, fmt)
    name = {"plain": "paged_decode", "q8": "paged_decode_q8"}.get(
        fmt, "paged_decode_q4")
    q = torch.randn(4, hq, hd, generator=g, device=dev).to(dtype)
    t, tpad, d = (torch.from_numpy(x).to(dev) for x in STATE)
    args = (q, kq, vq, torch.from_numpy(PT).to(dev), 1, t, tpad, d, ks, vs)
    before = dict(kernels.launches)
    o, m, l, mass = pa.paged_attention(*args, collect_mass=True)
    part = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before[name] + 2
    assert sum(kernels.launches.values()) == sum(before.values()) + 2
    ro, rm, rl, rmass = pa.paged_attention_ref(*args, collect_mass=True)
    bf16 = dtype == torch.bfloat16
    assert (o - ro).abs().max().item() <= (1e-2 if bf16 else 1e-4)
    assert (m - rm).abs().max().item() <= 1e-3
    assert ((l - rl).abs() <= 1e-3 * rl).all()
    assert (mass - rmass).abs().max().item() <= (1e-3 if bf16 else 1e-5)
    assert (mass.sum(dim=1) <= 1 + 1e-5).all()
    assert not o[2].any() and not l[2].any() and not mass[2].any()
    assert mass[1, 1] == 0                               # the hole
    for a, b in zip(part, (o, m, l)):
        assert torch.equal(a, b)


def test_engine_int4_pool_runs_kernel6(dev):
    """The tiny f32 engine with int4 pages and mass eviction on the card
    goes through kernel 6 (and no other paged kernel) ``stride × n_layers``
    times a tick, and serves the tokens and evicts the pages of the same
    engine on the CPU (plain versions)."""
    from kubegpu_tpu_torch.models import (
        ContinuousBatcher,
        LlamaConfig,
        llama_init,
    )
    cfg = LlamaConfig.tiny(n_heads=4, n_kv_heads=2, max_seq_len=64)
    params = llama_init(cfg, seed=0, device="cpu")
    kw = dict(n_slots=3, max_len=48, stride=2, prompt_buckets=(32, 40),
              paged=True, page_size=8, kv_bits=4, evict_policy="mass",
              evict_param=0.25, debug_invariants=True)
    runs = {}
    for device in ("cpu", "cuda"):
        eng = ContinuousBatcher(_to(params, device), cfg, device=device,
                                **kw)
        before = dict(kernels.launches)
        for j in range(3):
            eng.submit([(5 * j + 3 * i + 2) % cfg.vocab_size
                        for i in range(27)], 8)
        done = eng.drain()
        launched = {k: kernels.launches[k] - before[k] for k in before}
        runs[device] = ({r.rid: r.tokens for r in done}, eng.pages_evicted,
                        eng._tick, launched)
    toks, evicted, ticks, launched = runs["cuda"]
    assert launched["paged_decode_q4"] == ticks * 2 * cfg.n_layers
    assert launched["paged_decode"] == launched["paged_decode_q8"] == 0
    assert not any(runs["cpu"][3].values())
    assert evicted >= 1
    assert (toks, evicted) == runs["cpu"][:2]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _rel_err(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("dtype,causal,hq,hkv,t,s,hd", [
    (torch.bfloat16, True, 8, 2, 512, 512, 128),
    (torch.bfloat16, True, 4, 4, 100, 160, 64),
    (torch.float32, True, 8, 2, 37, 70, 128),
    (torch.float32, False, 4, 1, 64, 40, 64),
    (torch.float32, True, 4, 4, 33, 33, 16),
    (torch.float32, True, 8, 2, 29, 50, 80),
    (torch.bfloat16, False, 4, 2, 20, 45, 96),
    (torch.float32, True, 2, 1, 40, 40, 256),
])
def test_flash_backward_kernels_match_plain(dev, dtype, causal, hq, hkv, t,
                                            s, hd):
    """Kernels 2 (dq) and 3 (dk, dv) against ``flash_attention_bwd_ref`` on
    the same inputs, each launched once.  Max |err| over max |ref| within
    1e-2 in bf16 (both round f32 sums to bf16: at most one ulp apart, 2^-7
    of the value) and 1e-4 in f32 (f32 sums in another order); dk/dv at
    Hkv heads."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn(2, hq, t, hd, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, hkv, s, hd, generator=g, device=dev).to(dtype)
            for _ in range(2))
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    before = dict(kernels.launches)
    got = (fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal),
           *fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal))
    torch.cuda.synchronize()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert kernels.launches[name] == before[name] + 1
    ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape and a.dtype == dtype
        assert _rel_err(a, r) <= tol, name


def test_tiny_llama_backward_on_the_card(dev):
    """The fault this slice repairs: on CUDA tensors the attention output
    had no ``grad_fn``, so wq/wk/wv/attn_norm got no gradient.  Now every
    leaf of ``LlamaConfig.tiny()`` (f32) gets one, within 1e-4 of max |g|
    of the plain-attention path, through one launch of each backward
    kernel per layer."""
    import dataclasses

    from kubegpu_tpu_torch.models import llama as tl
    from kubegpu_tpu_torch.tree import tree_leaves
    cfg = tl.LlamaConfig.tiny()
    params = tl.llama_init(cfg, seed=0, device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    before = dict(kernels.launches)
    loss = tl.next_token_loss(params, tokens, cfg)
    grads = torch.autograd.grad(loss, leaves)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert kernels.launches[name] == before[name] + cfg.n_layers, name
    plain = torch.autograd.grad(tl.next_token_loss(
        params, tokens, dataclasses.replace(cfg, attn_impl="plain")), leaves)
    for g, r in zip(grads, plain):
        assert g is not None and bool(torch.isfinite(g).all())
        assert r.abs().max() > 0
        assert _rel_err(g, r) <= 1e-4


# the tensor-core instances of kernels 1 and 3: head dims 64/128, groups
# 1/4/8, causal on and off, T = S = 300 (ragged against the 128-row tiles)
# and T = 64 against S = 1000 (end-aligned), B = 2
TC_CASES = [(d, g, causal, t, s) for d in (64, 128) for g in (1, 4, 8)
            for causal in (True, False) for t, s in ((300, 300), (64, 1000))]


def _tc_inputs(dev, d, g, t, s, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(2, 2 * g, t, d, generator=gen, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(2, 2, s, d, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    return q, k, v, do


def _moved(before):
    """The launch counters that changed since ``before``, by how much."""
    return {k: kernels.launches[k] - before[k] for k in before
            if kernels.launches[k] != before[k]}


@pytest.mark.parametrize("d,g,causal,t,s", TC_CASES)
def test_flash_tc_forward_matches_plain(dev, d, g, causal, t, s):
    """Kernel 1's tensor-core instance against ``xla_attention``: |err| per
    unit of max(1, |ref|) within 2e-2 (both round p to bf16, the kernel
    before the normalisation, and the output to bf16) and lse within 1e-3
    (f32 on both sides); one launch, on the ``tc`` route only."""
    q, k, v, _ = _tc_inputs(dev, d, g, t, s)
    before = dict(kernels.launches)
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert _moved(before) == {"flash_fwd": 1, "flash_fwd/tc": 1}
    ref = fa.xla_attention(q, k, v, causal=causal).float()
    err = ((out.float() - ref).abs() / ref.abs().clamp(min=1)).max().item()
    assert err <= 2e-2
    ref_lse = fa._xla_lse(q, k, causal, d ** -0.5)
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("d,g,causal,t,s", TC_CASES)
def test_flash_tc_dkv_matches_plain(dev, d, g, causal, t, s):
    """Kernel 3's tensor-core instance against ``flash_attention_bwd_ref``:
    max |err| over max |ref| within 1e-2 (the kernel rounds p and ds to
    bf16 before its products, as the reference does, and its outputs to
    bf16); dk/dv at Hkv heads; one launch, on the ``tc`` route only."""
    q, k, v, do = _tc_inputs(dev, d, g, t, s)
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    before = dict(kernels.launches)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert _moved(before) == {"flash_bwd_dkv": 1, "flash_bwd_dkv/tc": 1}
    _, rk, rv = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
    for name, a, r in (("dk", dk, rk), ("dv", dv, rv)):
        assert a.shape == r.shape == k.shape and a.dtype == torch.bfloat16
        assert _rel_err(a, r) <= 1e-2, name


def test_flash_tc_dkv_is_deterministic(dev):
    """The query group is summed in registers, with no atomics: two
    launches on the same inputs give equal bits."""
    q, k, v, do = _tc_inputs(dev, 128, 4, 300, 300, seed=1)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    first = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
    second = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"),
                                         (torch.float32, "simt")])
def test_flash_route_counts(dev, dtype, route):
    """At head dim 128 a bf16 call moves only the ``tc`` counters of
    kernels 1 and 3, an f32 call only the ``simt`` ones."""
    q, k, v, do = (x.to(dtype) for x in _tc_inputs(dev, 128, 4, 64, 64))
    before = dict(kernels.launches)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    fa._flash_bwd_dkv_cuda(q, k, v, do, lse, (do * out).float().sum(-1),
                           True)
    torch.cuda.synchronize()
    assert _moved(before) == {"flash_fwd": 1, f"flash_fwd/{route}": 1,
                              "flash_bwd_dkv": 1, f"flash_bwd_dkv/{route}": 1}


# kernel 7's query positions: near the keys, then far enough that every
# bucket of (8, 32), the clamp at distance >= 32 included, is hit
BIAS_QPOS = {"near": [11, 13, 0, 19], "far": [40, 70, 5, 100]}


@pytest.mark.parametrize("qpos", list(BIAS_QPOS))
@pytest.mark.parametrize("dtype,hd", [(torch.float32, 16),
                                      (torch.float32, 64),
                                      (torch.float32, 80),
                                      (torch.bfloat16, 64)])
def test_biased_kernel_matches_plain(dev, dtype, hd, qpos):
    """Kernel 7 against ``paged_attention_biased_ref`` over the layout of
    the paged tests (MHA, 4 heads): row 1's prompt covers a 0 in its page
    table, which kernel 7 attends (no hole mask); row 2 is empty; rows 0
    and 3 have a prompt and a decode region.  o within 1e-2 in bf16 (the
    plain version rounds probabilities to bf16 before P.V) and 1e-4 in f32;
    m within 1e-3; l within 1e-3 relative; a bucket off by one would move a
    score by a table entry (~1)."""
    g = torch.Generator(device=dev).manual_seed(0)
    pk, pv = (torch.randn(2, 12, 4, 8, hd, generator=g, device=dev).to(dtype)
              for _ in range(2))
    q = torch.randn(4, 4, hd, generator=g, device=dev).to(dtype)
    table = torch.randn(4, 8, generator=g, device=dev)
    t, tpad, d = (torch.from_numpy(x).to(dev) for x in STATE)
    args = (q, pk, pv, torch.from_numpy(PT).to(dev), 1, t, tpad, d,
            torch.tensor(BIAS_QPOS[qpos], dtype=torch.int32, device=dev),
            table)
    before = dict(kernels.launches)
    o, m, l = pa.paged_attention_biased(*args, bias_max_dist=32)
    torch.cuda.synchronize()
    assert kernels.launches["paged_decode_bias"] == \
        before["paged_decode_bias"] + 1
    assert sum(kernels.launches.values()) == sum(before.values()) + 1
    ro, rm, rl = pa.paged_attention_biased_ref(*args, 32)
    assert (o - ro).abs().max().item() <= (
        1e-2 if dtype == torch.bfloat16 else 1e-4)
    assert (m - rm).abs().max().item() <= 1e-3
    assert ((l - rl).abs() <= 1e-3 * rl).all()
    assert not o[2].any() and not l[2].any() and (m[2] == -1e30).all()


def test_tiny_t5_paged_generate_on_the_card(dev):
    """``T5Config.tiny()`` (f32) with the JAX package's TestT5OnPages setup
    (encoder 2 x 9, 11 steps over page_size 4): the paged generate on the
    card runs kernel 7 once per decoder layer and step and gives the tokens
    of its CPU run and of the dense generate on the card."""
    from kubegpu_tpu_torch.models import (
        T5Config,
        t5_greedy_generate,
        t5_greedy_generate_paged,
        t5_init,
    )
    cfg = T5Config.tiny()
    params = t5_init(cfg, seed=5, device="cpu")
    enc = np.arange(2 * 9).reshape(2, 9) % cfg.vocab_size
    cpu = t5_greedy_generate_paged(params, enc, 11, cfg, page_size=4,
                                   device="cpu")
    on_card = _to(params, dev)
    before = kernels.launches["paged_decode_bias"]
    paged = t5_greedy_generate_paged(on_card, enc, 11, cfg, page_size=4,
                                     device=dev)
    assert kernels.launches["paged_decode_bias"] == before + 11 * 2
    dense = t5_greedy_generate(on_card, enc, 11, cfg, max_len=16, device=dev)
    assert torch.equal(paged.cpu(), cpu)
    assert torch.equal(dense.cpu(), cpu)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 4, 16, 128, device=dev)
    k = torch.randn(1, 2, 16, 128, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q[:, :, ::2], k[:, :, ::2], k[:, :, ::2])
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="head_dim"):
        wide = torch.randn(1, 2, 16, 320, device=dev)
        fa.flash_attention(wide, wide, wide)
    with pytest.raises(RuntimeError, match="no grad_fn"):
        fa.flash_attention(q.requires_grad_(), k, k)
    q = q.detach()
    pool = torch.zeros(1, 3, 2, 8, 128, device=dev)
    i32 = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q[:, :, 0].contiguous(), pool, pool,
                           torch.zeros(1, 2, dtype=torch.int64, device=dev),
                           0, i32, i32, i32)
    # int4 pages with a scale lane count that does not divide P, and int8
    # pages without their scales
    packed = torch.zeros(1, 3, 2, 8, 64, dtype=torch.uint8, device=dev)
    sc = torch.ones(1, 3, 2, 3, device=dev)
    pt = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="do not fit"):
        pa.paged_attention(q[:, :, 0].contiguous(), packed, packed, pt, 0,
                           i32, i32, i32, sc, sc)
    with pytest.raises(ValueError, match="requires k_scale"):
        pa.paged_attention(q[:, :, 0].contiguous(), pool.to(torch.int8),
                           pool.to(torch.int8), pt, 0, i32, i32, i32)
    # kernel 7: a table that is not [H, n_buckets], int64 positions
    qb = q[:, :2, 0].contiguous()     # MHA over the pool's 2 heads
    with pytest.raises(ValueError, match="bias table"):
        pa.paged_attention_biased(qb, pool, pool, pt, 0, i32, i32, i32, i32,
                                  torch.zeros(3, 8, device=dev),
                                  bias_max_dist=32)
    with pytest.raises(TypeError, match="q_pos must be int32"):
        pa.paged_attention_biased(qb, pool, pool, pt, 0, i32, i32, i32,
                                  i32.long(), torch.zeros(2, 8, device=dev),
                                  bias_max_dist=32)
