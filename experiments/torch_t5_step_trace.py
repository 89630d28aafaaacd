"""Trace one eager block of T5's paged decode on the card.

    python experiments/torch_t5_step_trace.py    # on a machine with an H100

T5 v1.1-base (``T5Config()``, bf16, random weights from seed 0) at
``chip_smoke.py``'s phase-8 serving shape: 8 encoder inputs of 512 tokens,
384 decode steps over pages of 128.  One graph call fills the cached decode
state, one eager call (``graphs=False``) is timed, then the third block (two
flushed pages a row) runs eagerly through ``_t5_paged_block``: once warm,
once timed, once under ``torch.profiler``.  Prints the block's trace and its
per-step wall, device-busy ms and kernel count, with the card's name and
power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from kubegpu_tpu_torch.models import t5  # noqa: E402


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    serve = chip_smoke.T5_SERVE
    page = serve["page"]
    cfg = t5.T5Config()
    params = t5.t5_init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    enc = torch.randint(0, cfg.vocab_size, (serve["batch"], serve["enc_len"]),
                        generator=gen, device="cuda")
    with torch.no_grad():
        t5.t5_greedy_generate_paged(params, enc, serve["steps"], cfg,
                                    page_size=page)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t5.t5_greedy_generate_paged(params, enc, serve["steps"], cfg,
                                    page_size=page, graphs=False)
        torch.cuda.synchronize()
        print("eager paged call s", time.perf_counter() - t0, flush=True)
        st = next(v for v in t5._graph_cache.values() if "block" in v[2])[1]

        def block():
            st["d0"].fill_(2 * page)
            t5._t5_paged_block(params, st, page, cfg)
            torch.cuda.synchronize()
        block()
        t0 = time.perf_counter()
        block()
        wall = (time.perf_counter() - t0) * 1e3
        out = chip_smoke.device_trace(torch, block, wall)
    chip_smoke.log_trace(f"eager T5 paged block of {page} steps", out)
    print("per step: wall_ms", wall / page, "busy_ms",
          out["device_busy_ms"] / page, "kernels",
          out["device_kernels"] / page)


if __name__ == "__main__":
    main()
