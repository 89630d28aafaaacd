"""Test-time helpers for the port's engine tests that hold the port to the
JAX package's serving engine on the CPU.

The reference builds a paged engine's jitted executables afresh for each
config (one ``_paged_engine_fns`` entry a config), and tracing and
compiling them dominates those tests' time.  Two configs that differ only
in ``fused_k`` run the same single-tick executables (decode and verify
block: a fused block runs the unmodified single-tick body), and the wave,
adopt and chunk executables read neither ``spec_gamma``, ``draft_layers``
nor ``fused_k``: :func:`shared_paged_executables` hands a later config the
jitted functions an earlier one built, so each program is traced and
compiled once a test module.  :func:`one_torch_thread` keeps a test
process to one torch thread: the tier-1 run puts six test processes on the
host's cores, and torch's default of a thread a core oversubscribes them.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

# indices into _paged_engine_fns' tuple: decode_block, prefill_wave,
# adopt_wave, prefill_chunk, activate_slot, verify_block, ...
_TICK = (0, 5)
_WAVE = (1, 2, 3)


@contextlib.contextmanager
def shared_paged_executables(serve_mod):
    """Patch ``serve_mod._paged_engine_fns`` (the JAX package's serve
    module) for the duration, sharing executables across configs."""
    inner, shared = serve_mod._paged_engine_fns, {}

    def fns(*args, **kw):
        out = list(inner(*args, **kw))
        tick = dict(kw, fused_k=0)
        wave = dict(tick, spec_gamma=0, draft_layers=0)
        for what, key, idx in (("tick", tick, _TICK),
                               ("wave", wave, _WAVE)):
            key = (what, args, tuple(sorted(key.items())))
            first = shared.setdefault(key, [out[i] for i in idx])
            for i, fn in zip(idx, first):
                out[i] = fn
        return tuple(out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve_mod, "_paged_engine_fns", fns)
        yield


@contextlib.contextmanager
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
