"""The port's MoE family (``kubegpu_tpu_torch/models/moe.py``) against the
JAX package's, on converted f32 parameters from ``moe_init`` and inputs made
with numpy from a seed: ``route_tokens`` (dispatch EXACT, the same experts
and slots, drops included; combine and aux within 1e-6) at a tight and a
generous capacity, ``moe_ffn`` and ``moe_forward`` (logits and aux within
1e-5), the loss, the cached decode against the forward, greedy tokens EQUAL
with and without the int8 cache (also through the decode step's graph
runner under a stand-in ``kernels.Graph``), ``quantize_moe`` byte for byte
and the forward on it, and the parameter conversion."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubegpu_tpu.models import moe as jm
from kubegpu_tpu.models import quant as jq
from kubegpu_tpu_torch.convert import convert_moe_params
from kubegpu_tpu_torch.models import decode as td
from kubegpu_tpu_torch.models import moe as tm
from kubegpu_tpu_torch.models import quant as tq

# tests/test_moe.py's serving config: no token is ever dropped, so the
# cached decode equals the forward
SERVE = dict(n_experts=4, top_k=2, n_layers=2, n_heads=4, n_kv_heads=2,
             max_seq_len=64, capacity_factor=8.0)


# the JAX side jitted (op-by-op dispatch compiles every op of every call)
j_init = jax.jit(jm.moe_init, static_argnums=1)
j_route = jax.jit(jm.route_tokens, static_argnums=(1, 2))
j_ffn = jax.jit(jm.moe_ffn, static_argnums=2)
j_forward = jax.jit(jm.moe_forward, static_argnums=2)
j_loss = jax.jit(jm.moe_next_token_loss, static_argnums=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the tier-1 run puts six test
    processes on the host's cores, and torch's default of a thread a core
    oversubscribes them (six concurrent copies of
    ``tests/test_torch_serve_moe.py`` took 488 s at the default, 50 s at
    one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jm.MoEConfig.tiny()
    params_j = j_init(jax.random.PRNGKey(0), cfg_j)
    return (cfg_j, params_j, tm.MoEConfig.tiny(),
            convert_moe_params(_np(params_j), device="cpu"))


@pytest.fixture(scope="module")
def serve_tiny(tiny):
    """SERVE's configs over ``tiny``'s parameters (the shapes are the
    same: only the length and the capacity factor differ)."""
    _, params_j, _, params_t = tiny
    return (jm.MoEConfig.tiny(**SERVE), params_j, tm.MoEConfig.tiny(**SERVE),
            params_t)


def test_config_matches_reference():
    for name in ("mixtral_8x7b_shaped", "tiny"):
        ref, got = getattr(jm.MoEConfig, name)(), getattr(tm.MoEConfig, name)()
        for f in dataclasses.fields(got):
            if f.name != "base":
                assert getattr(got, f.name) == getattr(ref, f.name), f.name
        for f in dataclasses.fields(got.base):
            if f.name != "attn_impl":
                assert getattr(got.base, f.name) == getattr(ref.base, f.name)
        for t in (1, 2, 7, 8, 16, 512):
            assert got.capacity(t) == ref.capacity(t)
    cfg = tm.MoEConfig.mixtral_8x7b_shaped()
    assert hash(cfg) == hash(tm.MoEConfig.mixtral_8x7b_shaped())


def test_init_tree_matches_reference(tiny):
    cfg_j, params_j, cfg, _ = tiny
    got = tm.moe_init(cfg, seed=3, device="cpu")
    ref = _np(params_j)
    assert set(got) == set(ref) and set(got["layers"]) == set(ref["layers"])
    flat = {**{k: v for k, v in got.items() if k != "layers"},
            **got["layers"]}
    flat_ref = {**{k: v for k, v in ref.items() if k != "layers"},
                **ref["layers"]}
    for name, r in flat_ref.items():
        assert tuple(flat[name].shape) == r.shape, name
        assert str(flat[name].dtype).split(".")[-1] == str(r.dtype), name
    # bf16 weights, the router stays f32
    bf = tm.moe_init(tm.MoEConfig.tiny(dtype="bfloat16"), device="cpu")
    assert bf["layers"]["w_gate"].dtype == torch.bfloat16
    assert bf["layers"]["w_router"].dtype == torch.float32


@pytest.mark.parametrize("capacity_factor", [1.0, 4.0],
                         ids=["tight", "generous"])
def test_route_tokens_matches_reference(capacity_factor):
    g, t, e, k = 3, 16, 4, 2
    cap = jm.MoEConfig.tiny(capacity_factor=capacity_factor).capacity(t)
    logits = np.random.default_rng(7).standard_normal((g, t, e)).astype(
        np.float32)
    rd, rc, ra = j_route(jnp.asarray(logits), k, cap)
    gd, gc, ga = tm.route_tokens(torch.from_numpy(logits), k, cap)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-6)
    np.testing.assert_allclose(float(ga), float(ra), atol=1e-6)
    kept = float(gd.sum())
    if capacity_factor == 1.0:
        assert kept < g * t * k          # tokens were dropped
    else:
        assert kept == g * t * k


def test_route_tokens_ties_and_overflow():
    """Exact ties route to the first expert (argmax's first maximum, in
    both packages); past capacity a token gets a zero row, the earliest
    tokens kept; a uniform router's aux is 1."""
    cases = [(np.zeros((2, 8, 4), np.float32), 2, 8),
             (np.zeros((1, 8, 4), np.float32), 1, 3)]
    cases[1][0][:, :, 0] = 10.0
    for logits, k, cap in cases:
        rd, rc, ra = j_route(jnp.asarray(logits), k, cap)
        gd, gc, ga = tm.route_tokens(torch.from_numpy(logits), k, cap)
        np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
        np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-6)
        np.testing.assert_allclose(float(ga), float(ra), atol=1e-6)
    assert float(gd.sum()) == 3.0 and float(gd[0, :3].sum()) == 3.0
    _, _, aux = tm.route_tokens(torch.zeros((2, 32, 4)), 2, 32)
    assert abs(float(aux) - 1.0) < 1e-6


@pytest.mark.parametrize("capacity_factor", [1.0, 8.0],
                         ids=["tight", "generous"])
def test_moe_ffn_matches_reference(tiny, capacity_factor):
    _, params_j, _, params_t = tiny
    cfg_j = jm.MoEConfig.tiny(capacity_factor=capacity_factor)
    cfg = tm.MoEConfig.tiny(capacity_factor=capacity_factor)
    x = np.random.default_rng(1).standard_normal((2, 8, 64)).astype(
        np.float32)
    for li in range(cfg.base.n_layers):
        lp_j = jax.tree.map(lambda a: a[li], params_j["layers"])
        lp_t = {n: v[li] for n, v in params_t["layers"].items()}
        ry, ra = j_ffn(jnp.asarray(x), lp_j, cfg_j)
        gy, ga = tm.moe_ffn(torch.from_numpy(x), lp_t, cfg)
        np.testing.assert_allclose(gy.numpy(), np.asarray(ry), atol=1e-5)
        np.testing.assert_allclose(float(ga), float(ra), atol=1e-6)


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25],
                         ids=["tight", "default"])
def test_forward_and_loss_match_reference(tiny, capacity_factor):
    _, params_j, _, params_t = tiny
    cfg_j = jm.MoEConfig.tiny(capacity_factor=capacity_factor)
    cfg = tm.MoEConfig.tiny(capacity_factor=capacity_factor)
    tokens = np.random.default_rng(4).integers(0, cfg.base.vocab_size,
                                               (2, 16))
    rl, ra = j_forward(params_j, jnp.asarray(tokens, jnp.int32), cfg_j)
    gl, ga = tm.moe_forward(params_t, torch.from_numpy(tokens), cfg)
    assert gl.dtype == torch.float32 and tuple(gl.shape) == rl.shape
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), atol=1e-5)
    np.testing.assert_allclose(float(ga), float(ra), atol=1e-5)
    if capacity_factor == 1.0:      # the loss once: the forward is above
        ref = j_loss(params_j, jnp.asarray(tokens, jnp.int32), cfg_j)
        got = tm.moe_next_token_loss(params_t, torch.from_numpy(tokens), cfg)
        np.testing.assert_allclose(float(got), float(ref), atol=1e-5)


def test_decode_matches_forward(serve_tiny):
    """Prefill and step-wise decode reproduce the port's own forward at
    every position (no drops), and the reference's prefill."""
    cfg_j, params_j, cfg, params_t = serve_tiny
    seq = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.base.vocab_size, (2, 10)))
    ref, _ = tm.moe_forward(params_t, seq, cfg)
    logits, cache = tm.moe_prefill(params_t, seq[:, :4], cfg)
    np.testing.assert_allclose(logits.numpy(), ref[:, 3].numpy(), atol=1e-5)
    jl_, _ = jax.jit(jm.moe_prefill, static_argnums=2)(
        params_j, jnp.asarray(seq[:, :4].numpy(), jnp.int32), cfg_j)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl_), atol=1e-5)
    for pos in range(4, 10):
        logits, cache = tm.moe_decode_step(params_t, cache, seq[:, pos], pos,
                                           cfg)
        np.testing.assert_allclose(logits.numpy(), ref[:, pos].numpy(),
                                   atol=1e-5, err_msg=f"position {pos}")


class _ReplayedGraph:
    """``kernels.Graph`` on the CPU: the capture records nothing and a
    replay calls the captured function."""
    replays = 0

    def __init__(self, fn):
        self.fn = fn

    def capture(self):
        pass

    def replay(self):
        type(self).replays += 1
        self.fn()


@pytest.mark.parametrize("kv_int8", [False, True], ids=["kv16", "kv8"])
def test_greedy_tokens_equal_reference(serve_tiny, monkeypatch, kv_int8):
    """``moe_greedy_generate`` eagerly and through the graph runner (a
    second call of one shape replays its step), equal to the reference's
    tokens; the graph key holds the (ffn_factory, ffn_cfg) pair, so another
    MoE config's step of the same shape is another entry."""
    cfg_j, params_j, cfg, params_t = serve_tiny
    monkeypatch.setattr(td.kernels, "Graph", _ReplayedGraph)
    td.clear_graphs()
    prompt = np.random.default_rng(5).integers(0, cfg.base.vocab_size,
                                               (2, 5))
    n = 6
    ref = np.asarray(jm.moe_greedy_generate(
        params_j, jnp.asarray(prompt, jnp.int32), n, cfg_j, kv_int8=kv_int8))
    eager = tm.moe_greedy_generate(params_t, prompt, n, cfg,
                                   kv_int8=kv_int8, device="cpu")
    assert eager.tolist() == ref.tolist()
    key = (tm._moe_decode_ffn, cfg)
    for _ in range(2):
        graph = td._rollout(params_t, torch.from_numpy(prompt), cfg.base, n,
                            cfg.base.max_seq_len, kv_int8, graphs=True,
                            ffn_key=key)
        assert torch.equal(graph, eager)
    assert len(td._graph_cache) == 1
    other = (tm._moe_decode_ffn, dataclasses.replace(cfg, capacity_factor=4.0))
    td._rollout(params_t, torch.from_numpy(prompt), cfg.base, n,
                cfg.base.max_seq_len, kv_int8, graphs=True, ffn_key=other)
    assert {k[-2] for k in td._graph_cache} == {key, other}
    td.clear_graphs()


def test_quantize_moe_matches_reference(tiny):
    """Byte for byte: the port's ``quantize_moe`` on the converted tree,
    and the converted reference ``quantize_moe`` tree; per-(layer,
    expert, channel) scales; the router stays f32; the forward on int8
    experts within 1e-5."""
    cfg_j, params_j, cfg, params_t = tiny
    qj = jq.quantize_moe(params_j)       # eager: its bytes are the contract
    qt = tq.quantize_moe(params_t)
    conv = convert_moe_params(_np(qj), device="cpu")
    L, E = cfg.base.n_layers, cfg.n_experts
    for name, leaf in qj["layers"].items():
        got, via = qt["layers"][name], conv["layers"][name]
        if isinstance(leaf, jq.QTensor):
            assert isinstance(got, tq.QTensor) and isinstance(via, tq.QTensor)
            for part in ("values", "scale"):
                r = np.asarray(getattr(leaf, part))
                for t in (got, via):
                    np.testing.assert_array_equal(
                        getattr(t, part).numpy(), r, err_msg=name)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    assert tuple(qt["layers"]["w_gate"].scale.shape) == (
        L, E, 1, cfg.base.d_ff)
    assert tuple(qt["layers"]["wq"].scale.shape)[:2] == (L, 1)
    assert qt["layers"]["w_router"] is params_t["layers"]["w_router"]
    for a, b in ((qj["lm_head"].values, qt["lm_head"].values),
                 (qj["lm_head"].scale, qt["lm_head"].scale)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    tokens = np.random.default_rng(6).integers(0, cfg.base.vocab_size,
                                               (2, 12))
    rl, ra = j_forward(qj, jnp.asarray(tokens, jnp.int32), cfg_j)
    gl, ga = tm.moe_forward(qt, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), atol=1e-5)
    np.testing.assert_allclose(float(ga), float(ra), atol=1e-5)


def test_convert_keeps_the_router_f32(tiny):
    _, params_j, _, _ = tiny
    got = convert_moe_params(_np(params_j), device="cpu",
                             dtype=torch.bfloat16)
    assert got["layers"]["w_router"].dtype == torch.float32
    np.testing.assert_array_equal(got["layers"]["w_router"].numpy(),
                                  np.asarray(params_j["layers"]["w_router"]))
    assert got["layers"]["w_up"].dtype == torch.bfloat16
    assert got["embed"].dtype == torch.bfloat16
