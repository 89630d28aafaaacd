"""``chip_smoke.py``'s phases 15 (tensor-parallel serving) and 16 (the
serving pools at tp > 1) alone, after the kernel build, on one card:
their lines, each phase's seconds, and with a path the numbers as JSON.
It times the code both phases share (``parallel.launch``'s gangs).

    PYTHONPATH=. python experiments/torch_phase15_16.py [OUT.json]
"""

import json
import subprocess
import sys
import time


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from kubegpu_tpu_torch import kernels
    t0 = time.perf_counter()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.build()
    print("[build]", round(time.perf_counter() - t0, 2), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    out = {"card": name}
    for label, fn, seed in (("tp", cs.tp_phase, cs.SEED + 16),
                            ("pool_tp", cs.pool_tp_phase, cs.SEED + 18)):
        kernels.reset_launches()
        t1 = time.perf_counter()
        out[label] = fn(torch, kernels,
                        torch.Generator(device="cuda").manual_seed(seed),
                        name)
        print(f"[{label}] seconds={time.perf_counter() - t1:.1f}",
              flush=True)
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f, indent=1, default=str)
    print("[total]", round(time.perf_counter() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
