"""A/B of the stacked-leaf gradient repair on the card.

    python experiments/torch_repair_ab.py        # on a machine with an H100

The Llama and T5 train steps run with the stacked ``[L, ...]`` leaves
unbound once per forward (``unbind_layers``, the port's form) and indexed
once per layer (the form it replaced: autograd's ``select_backward`` builds
a zero-filled full stack per layer and leaf and sums them), in one process,
in the order unbind, index, index, unbind.  Llama-3-8B widths cut to 8
layers (remat, bf16, one [4, 2048] batch) and T5 v1.1-base (encoder
[8, 512], decoder [8, 128]), each with ``adamw(1e-3)``, as
``chip_smoke.py``'s phases 7 and 8 run them.  Each run: one warm step,
three timed steps (median ms), peak memory, then one traced step: device
busy ms, idle share, and the elementwise adds, fills and copies summed by
kernel name.  Prints one line per run and a JSON summary last, with the
card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from kubegpu_tpu_torch.models import llama, t5  # noqa: E402
from kubegpu_tpu_torch.optim import adamw  # noqa: E402
from kubegpu_tpu_torch.tree import tree_leaves  # noqa: E402

UNBIND = llama.unbind_layers
# kernel-name pieces of the elementwise work the repair moves
KINDS = {"adds": "CUDAFunctor_add", "fills": "FillFunctor",
         "copies": "copy_kernel"}


def indexed_per_layer(stack: dict) -> list[dict]:
    n = len(next(iter(stack.values())))
    return [{k: leaf[i] for k, leaf in stack.items()} for i in range(n)]


def traced(fn) -> tuple[float, dict]:
    """One ``fn()`` under torch.profiler: device ms and calls by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.device_time_total / 1e3
            rec[1] += 1
    return sum(ms for ms, _ in by_name.values()), by_name


def run(label: str, form: str, step) -> dict:
    fn = UNBIND if form == "unbind" else indexed_per_layer
    llama.unbind_layers = t5.unbind_layers = fn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()   # warm
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    busy, by_name = traced(step)
    out = {"model": label, "form": form, "step_ms": times,
           "step_ms_median": med, "busy_ms": busy,
           "idle_share": 1 - busy / med,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "device_kernels": sum(c for _, c in by_name.values())}
    for kind, piece in KINDS.items():
        recs = [r for n, r in by_name.items() if piece in n]
        out[kind] = {"ms": sum(r[0] for r in recs),
                     "calls": sum(r[1] for r in recs)}
    llama.unbind_layers = t5.unbind_layers = UNBIND
    print(json.dumps(out), flush=True)
    return out


def llama_step():
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=8)
    params = llama.llama_init(cfg, seed=0, device="cuda")
    for p in tree_leaves(params):
        p.requires_grad_()
    opt = adamw(1e-3)
    state = [opt.init(params)]
    step = llama.make_train_step(cfg, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen,
                           device="cuda")

    def one():
        _, state[0], _ = step(params, state[0], tokens)
    return one


def t5_step():
    cfg = t5.T5Config()
    params = t5.t5_init(cfg, seed=0, device="cuda")
    for p in tree_leaves(params):
        p.requires_grad_()
    opt = adamw(1e-3)
    state = [opt.init(params)]
    step = t5.make_t5_train_step(cfg, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    enc, dec = (torch.randint(0, cfg.vocab_size, (8, n), generator=gen,
                              device="cuda") for n in (512, 128))

    def one():
        _, state[0], _ = step(params, state[0], enc, dec)
    return one


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    runs = []
    for label, make in (("llama-8-layers", llama_step), ("t5-base", t5_step)):
        step = make()
        for form in ("unbind", "index", "index", "unbind"):
            runs.append(run(label, form, step))
        del step
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
