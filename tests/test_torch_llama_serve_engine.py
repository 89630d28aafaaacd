"""The port's ``_serve_continuous`` (``kubegpu_tpu_torch.workloads.
programs.llama_serve``) against the JAX package's on the same converted
parameters, in-process on the CPU (the JAX side's Pallas kernels in
interpret mode): every deterministic metric line must be equal (the cfg
echoes, waves, ticks, occupancy, spec rates, fused dispatches, kv bits,
pages evicted, the fault counters); the state bytes differ only by the
slot vectors' 4 bytes a slot (``tests/test_torch_serve_acct.py``)."""

import jax
import numpy as np
import pytest

from kubegpu_tpu.models import llama as jl
from kubegpu_tpu.models.quant import quantize_llama as jquantize
from kubegpu_tpu.workloads.programs import distributed as jdist
from kubegpu_tpu.workloads.programs import llama_serve as jls
from kubegpu_tpu_torch.convert import convert_llama_params
from kubegpu_tpu_torch.models import llama as tl
from kubegpu_tpu_torch.workloads.programs import distributed as tdist
from kubegpu_tpu_torch.workloads.programs import llama_serve as tls

from test_torch_llama_serve import clean_env, run_both  # noqa: F401

# lines of _serve_continuous that are wall-clock (or state bytes, held on
# their own): every other line must be equal
TIMED = {"serve_engine_tokens_per_s", "serve_goodput_tokens_per_s",
         "serve_engine_phase_warmup_ms", "serve_engine_phase_drain_ms",
         "serve_engine_stall_p50_ms", "serve_engine_stall_p99_ms",
         "serve_hbm_pool_bytes", "serve_hbm_peak_bytes"}


@pytest.fixture(scope="module")
def tiny():
    """The program's tiny config, long enough for a prompt of 384 and 48
    steps, both sides' parameters from the reference's draw."""
    cfg_j = jl.LlamaConfig.tiny(n_heads=4, n_kv_heads=4, max_seq_len=512)
    params_j = jl.llama_init(jax.random.PRNGKey(0), cfg_j)
    cfg = tl.LlamaConfig.tiny(n_heads=4, n_kv_heads=4, max_seq_len=512)
    return cfg_j, params_j, cfg


CONT_CASES = {
    # (env, slots, prompt, steps, int8 weights)
    "kv8-int8w": ({"SERVE_KV_INT8": "1"}, 1, 128, 24, True),
    "dense": ({}, 1, 24, 20, False),
    "spec2-fused4": ({"SERVE_SPEC_GAMMA": "2", "SERVE_FUSED_K": "4"}, 1, 128,
                     32, False),
    "kv4-evict": ({"SERVE_KV_BITS": "4", "SERVE_EVICT_POLICY": "window",
                   "SERVE_EVICT_PARAM": "128"}, 1, 384, 48, False),
    "prefix-chunked": ({"SERVE_PREFIX_CACHE": "1",
                        "SERVE_CHUNKED_PREFILL": "1"}, 1, 384, 16, False),
}


@pytest.mark.parametrize("case", list(CONT_CASES))
def test_serve_continuous_matches_reference(clean_env, capsys, tiny, case):
    cfg_j, params_j, cfg = tiny
    env, slots, prompt, steps, int8 = CONT_CASES[case]
    for k, v in {"SERVE_REQS": "3", **env}.items():
        clean_env.setenv(k, v)
    if int8:
        params_j = jquantize(params_j)
    params_t = convert_llama_params(jax.tree.map(np.asarray, params_j),
                                    device="cpu")
    worker = tdist.read_env()
    ours, ref = run_both(
        capsys,
        lambda: tls._serve_continuous(worker, cfg, params_t, slots, prompt,
                                      steps, int8, device="cpu"),
        lambda: jls._serve_continuous(jdist.read_env(), cfg_j, params_j,
                                      slots, prompt, steps, int8))
    got = {m["metric"]: m["value"] for m in ours}
    want = {m["metric"]: m["value"] for m in ref}
    assert {k: v for k, v in got.items() if k not in TIMED} == {
        k: v for k, v in want.items() if k not in TIMED}
    # the slot vectors are 24 bytes a slot here, 16 in the reference (see
    # tests/test_torch_serve_acct.py); the pool or cache bytes are equal
    for name in ("serve_hbm_pool_bytes", "serve_hbm_peak_bytes"):
        assert got[name] - want[name] == 8 * slots
    # a prompt of 384 admits through chunks of 256 with chunked prefill
    assert (got["serve_engine_waves"] > 0) == (case != "prefix-chunked")
    if case == "kv4-evict":
        assert got["serve_pages_evicted_total"] > 0
        assert got["serve_kv_bits"] == 4
    if case == "spec2-fused4":
        assert got["serve_engine_spec_accept_rate"] > 0
        assert got["serve_fused_dispatches"] > 0
    assert ours[0]["devices"] == 1


