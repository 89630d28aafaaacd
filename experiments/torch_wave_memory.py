"""Peak device memory and time of one paged-engine prefill wave at
Llama-3-8B full width (bf16, random weights from seed 0): the wave of 8
prompts at bucket 512 that ``ContinuousBatcher`` admits, through
``prefill_wave`` (the LM head at each row's last prompt position only) and
through the every-position head it replaced (``[8, 512, 128256]`` logits,
then one row a prompt), in turns on the same inputs.  Both must pick the
same first tokens.

    PYTHONPATH=. python3 experiments/torch_wave_memory.py

Needs one CUDA card; prints the card's name and power limit, then one JSON
line.
"""

import json
import subprocess
import time

import torch

from kubegpu_tpu_torch.models import LlamaConfig, llama_init
from kubegpu_tpu_torch.models import decode as dec
from kubegpu_tpu_torch.models import serve as srv


def every_position_wave(params, padded, lens, cfg):
    """The replaced form: the head over every position, one row kept."""
    k, bucket = padded.shape
    cache = dec.init_kv_cache(cfg, k, bucket, device=padded.device)
    logits, cache = dec._forward_with_cache(params, padded, cache, 0, cfg)
    last = logits[torch.arange(k, device=logits.device), lens - 1]
    return last.argmax(dim=-1), cache


def measure(fn) -> dict:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        firsts, cache = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    return {"firsts": firsts.tolist(), "peak_above_weights_gb": peak / 1e9,
            "ms": ms}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    cfg = LlamaConfig.llama3_8b()
    params = llama_init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    k, bucket = 8, 512
    lens = torch.randint(200, bucket + 1, (k,), generator=gen, device="cuda")
    padded = torch.randint(0, cfg.vocab_size, (k, bucket), generator=gen,
                           device="cuda")
    padded *= torch.arange(bucket, device="cuda")[None, :] < lens[:, None]
    forms = {"gathered": lambda: srv.prefill_wave(params, padded, lens, cfg),
             "every_position": lambda: every_position_wave(params, padded,
                                                           lens, cfg)}
    for fn in forms.values():          # warm: cuBLAS, the allocator
        measure(fn)
    runs = {name: [] for name in forms}
    for name in ("gathered", "every_position", "every_position",
                 "gathered"):
        runs[name].append(measure(forms[name]))
    firsts = {name: r[0]["firsts"] for name, r in runs.items()}
    out = {"card": card, "kind": torch.cuda.get_device_name(0), "k": k,
           "bucket": bucket,
           "weights_gb": torch.cuda.memory_allocated() / 1e9,
           "first_tokens_equal": firsts["gathered"]
           == firsts["every_position"],
           **{f"{name}_peak_above_weights_gb": max(
               x["peak_above_weights_gb"] for x in r)
              for name, r in runs.items()},
           **{f"{name}_ms": [x["ms"] for x in r] for name, r in runs.items()}}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
