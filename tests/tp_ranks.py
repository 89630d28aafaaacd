"""Rank entry points for ``tests/test_torch_serve_tp.py`` and
``tests/test_torch_serve_tp_pool.py``.

Each tensor-parallel rank is a spawned process that imports this module
afresh, so it imports torch, numpy and the port only (never JAX: the test
modules that launch the ranks import the JAX package).  The same
functions serve the test process's own tp = 1 runs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models.decode import _forward_with_cache, init_kv_cache
from kubegpu_tpu_torch.models.llama import LlamaConfig, llama_init
from kubegpu_tpu_torch.models.moe import MoEConfig, moe_init
from kubegpu_tpu_torch.models.quant import quantize_llama
from kubegpu_tpu_torch.models.serve import (
    ContinuousBatcher,
    _paged_row_step,
    make_serve_mesh,
    prefill_chunk_logits,
    verify_forward,
)
from kubegpu_tpu_torch.parallel.sharding import (
    pool_specs,
    serve_param_specs,
    shard_tree,
)

COUNTERS = ("prefix_hits", "chunks_run", "prefill_waves", "spec_ticks",
            "fused_dispatches", "deadline_misses", "requests_shed",
            "emitted_tokens")


def run_traffic(eng, events) -> dict:
    """Drive ``eng`` through ``events`` (``("submit", prompt, n, kw)``,
    ``("step", k)``, ``("drain",)``); returns {rid: (tokens, error)}."""
    rids, done = [], {}
    for ev in events:
        if ev[0] == "submit":
            rids.append(eng.submit(ev[1], ev[2], **ev[3]))
        elif ev[0] == "step":
            for _ in range(ev[1]):
                done.update({r.rid: r for r in eng.step()})
        else:
            done.update({r.rid: r for r in eng.drain()})
    return {rid: (done[rid].tokens, done[rid].error) for rid in rids}


def engine_params(params_np: dict, quant_weights: bool) -> dict:
    params = convert_llama_params(params_np, device="cpu")
    return quantize_llama(params) if quant_weights else params


def migrate_case(params: dict, cfg, case: dict, mesh=None) -> dict:
    """Page-chain migration between two engines of one group (``mesh``
    None: two tp = 1 engines): the first prefills ``case["prompt"]`` as a
    one-token ``migrate_out`` leg and exports its chain, the second
    imports it with ``case["n"]`` tokens to make and decodes.  The export
    (its chain as numpy arrays), the second engine's tokens, counters and
    host digest."""
    src = ContinuousBatcher(params, cfg, device="cpu", mesh=mesh,
                            **case["engine"])
    rid = src.submit(case["prompt"], 1, migrate_out=True)
    first = src.drain()
    exp = src.take_export(rid)
    dst = ContinuousBatcher(params, cfg, device="cpu", mesh=mesh,
                            **case["engine"])
    local = dst.import_chain(exp, case["n"])
    done = dst.drain()
    dst.check_page_invariants()
    chain = {k: v.numpy() for k, v in exp["chain"].items()}
    return {"export": {**{k: exp[k] for k in ("t", "tpad", "pages",
                                              "first_token", "digest")},
                       "keys": len(exp["prefix_keys"]), "chain": chain},
            "first": [r.tokens for r in first],
            "tokens": {r.rid: r.tokens for r in done}, "local": local,
            "digest": dst.host_digest(),
            "counters": {c: getattr(dst, c) for c in (
                "chains_imported", "pages_migrated_in", "prefix_hits")},
            "exported": (src.chains_exported, src.pages_migrated_out)}


def serve_case(params: dict, cfg, case: dict, mesh=None) -> dict:
    """One case on one engine (``mesh`` None: the tp = 1 engine): its
    tokens, counters and host digest; or the error its construction or
    its traffic raised.  A case with a ``prompt`` is a migration
    (:func:`migrate_case`)."""
    if "prompt" in case:
        return migrate_case(params, cfg, case, mesh)
    try:
        eng = ContinuousBatcher(params, cfg, device="cpu", mesh=mesh,
                                **case["engine"])
        got = run_traffic(eng, case["events"])
    except (ValueError, NotImplementedError) as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    eng.check_page_invariants()
    return {"tokens": got, "digest": eng.host_digest(),
            "counters": {c: getattr(eng, c) for c in COUNTERS},
            "available_pages": eng._available_pages(),
            "total_pages": eng.total_pages}


def serve_cases(params_np: dict, cfg_kw: dict, cases: list,
                pieces_seed: int) -> dict:
    """Rank body: every case on this rank's shard of one ("tp",) mesh over
    the group (a case's ``mesh_names`` names the axis otherwise, ``cfg``
    overrides the config with weights of its own, ``moe`` serves the tiny
    MoE), each result with every rank's host digest; then
    :func:`shard_pieces`.  Rank 0's results are the launch's."""
    from torch.distributed.device_mesh import init_device_mesh
    tp = dist.get_world_size()
    mesh = make_serve_mesh(tp, "cpu")
    out = []
    for case in cases:
        if case.get("moe"):
            cfg = MoEConfig.tiny(max_seq_len=64)
            params = moe_init(cfg, device="cpu")
        elif case.get("cfg"):
            cfg = LlamaConfig.tiny(**{**cfg_kw, **case["cfg"]})
            params = llama_init(cfg, seed=1, device="cpu")
        else:
            cfg = LlamaConfig.tiny(**cfg_kw)
            params = engine_params(params_np, case.get("quant_weights",
                                                       False))
        m = (init_device_mesh("cpu", (tp,), mesh_dim_names=case["mesh_names"])
             if case.get("mesh_names") else mesh)
        res = serve_case(params, cfg, case, m)
        digests = [None] * tp
        dist.all_gather_object(digests, res.get("digest"))
        res["digests"] = digests
        out.append(res)
    return {"cases": out, "pieces": shard_pieces(params_np, cfg_kw,
                                                 pieces_seed)}


# -- the pieces: one layer stack's logits on seeded state ---------------------

def piece_inputs(cfg: LlamaConfig, seed: int = 0) -> dict:
    """A seeded pool of 9 pages of 8 (f32), page tables and positions for
    3 rows: the inputs :func:`pieces` runs on."""
    rng = np.random.default_rng(seed)
    n_pages, page, hkv, hd = 9, 8, cfg.n_kv_heads, cfg.head_dim
    shape = (cfg.n_layers, n_pages, hkv, page, hd)
    pool = {n: torch.from_numpy(rng.standard_normal(shape, np.float32))
            for n in ("k", "v")}
    pt = torch.tensor([[1, 2, 3], [4, 5, 0], [6, 7, 8]], dtype=torch.int32)
    return {"pool": pool, "pt": pt,
            "tvec": torch.tensor([13, 6, 16], dtype=torch.int32),
            "tpad": torch.tensor([16, 8, 16], dtype=torch.int32),
            "d0": torch.tensor([3, 0, 4], dtype=torch.int32),
            "tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, 3)).long(),
            "chunk": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (3, 4))).long(),
            "prompt": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (2, 7))).long()}


def pieces(params: dict, cfg: LlamaConfig, inp: dict, tp_group=None) -> dict:
    """The logits of the tp-aware bodies on :func:`piece_inputs`: one
    decode step (:func:`_paged_row_step`), the verify over 4 positions
    (:func:`verify_forward`), a prompt chunk (:func:`prefill_chunk_logits`)
    and a prefill (``_forward_with_cache``).  The pool is written in place:
    pass a copy."""
    pool, pt = inp["pool"], inp["pt"]
    tvec, tpad, d0 = inp["tvec"], inp["tpad"], inp["d0"]
    pos = tvec + d0
    b, hkv = pt.shape[0], pool["k"].shape[2]
    buf = {n: torch.zeros((cfg.n_layers, b, hkv, 4, cfg.head_dim))
           for n in ("k", "v")}
    step = _paged_row_step(params, inp["tokens"], pool, pt, tvec, tpad, d0,
                           buf, pos, 0, cfg, tp_group=tp_group)
    verify = verify_forward(params, inp["chunk"], pool, pt, tvec, tpad, d0,
                            pos, cfg, 8, tp_group)
    chunk = prefill_chunk_logits(
        params, pool, inp["chunk"][:1].repeat(1, 2), pt[:1], 8,
        torch.tensor([14], dtype=torch.int32), cfg, 8, tp_group=tp_group)
    cache = init_kv_cache(cfg, 2, 8, device="cpu")
    prefill, _ = _forward_with_cache(params, inp["prompt"], cache, 0, cfg,
                                     tp_group=tp_group)
    return {"step": step.numpy(), "verify": verify.numpy(),
            "chunk": chunk.numpy(), "prefill": prefill.numpy(),
            "pool": {n: x.numpy() for n, x in pool.items()}}


def shard_pieces(params_np: dict, cfg_kw: dict, seed: int) -> dict:
    """Rank body: :func:`pieces` on this rank's weight and pool shards,
    with the local config; rank 0 returns its logits (full vocabulary)
    and every rank's pool shard after the writes."""
    from dataclasses import replace
    tp, rank = dist.get_world_size(), dist.get_rank()
    cfg = LlamaConfig.tiny(**cfg_kw)
    lcfg = replace(cfg, n_heads=cfg.n_heads // tp,
                   n_kv_heads=cfg.n_kv_heads // tp, d_ff=cfg.d_ff // tp,
                   head_dim_override=cfg.head_dim)
    out = {}
    for quant in (False, True):
        params = engine_params(params_np, quant)
        local = shard_tree(params, serve_param_specs(quant), rank, tp)
        inp = piece_inputs(cfg, seed)
        inp["pool"] = shard_tree(inp["pool"], pool_specs(inp["pool"]), rank,
                                 tp)
        res = pieces(local, lcfg, inp, dist.group.WORLD)
        pools = [None] * tp
        dist.all_gather_object(pools, res.pop("pool"))
        res["pools"] = pools
        out["int8" if quant else "f32"] = res
    return out


# -- gang bodies (tests/test_torch_serve_tp_pool.py) -------------------------

def raise_on_rank(state: dict, rank: int) -> int:
    """A gang body that raises on ``rank`` only."""
    if state["rank"] == rank:
        raise ArithmeticError(f"rank {rank} raised on purpose")
    return state["rank"]


def bump_rid(state: dict, rank: int) -> None:
    """A gang body that moves ``rank``'s engine's next rid, so its host
    state parts from the other ranks'."""
    if state["rank"] == rank:
        state["engine"]._next_rid += 1


def engine_shapes(state: dict) -> dict:
    """A gang body: this rank's device, its pool's KV heads and its wq
    shard's columns."""
    eng = state["engine"]
    return {"device": state["device"], "backend": state["backend"],
            "kv_heads": eng.pool["k"].shape[2],
            "wq_cols": eng.params["layers"]["wq"].shape[-1]}
