"""``chip_smoke.py``'s phase 18 (the gang bootstrap and fault recovery)
alone on a card node: the kernels built first (the dp gang's and the
recovery gang's pods load them), then NVML's health reads, the example
gangs through the cluster ``apply --real --set backend.type=nvml`` builds,
the all-reduce bus bandwidth over NCCL where there are two or more cards,
and a card failed under a running ``llama_pjit`` gang.  Prints the phase's
lines and seconds, and with a path writes its numbers as JSON.

    PYTHONPATH=. python experiments/torch_phase18.py [OUT.json]
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    kernels.build()
    print("[build]", round(time.perf_counter() - t0, 1), flush=True)
    out = {"card": card, "gang": cs.gang_phase(torch, kernels)}
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f, indent=1, default=str)
    print("[total]", round(time.perf_counter() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
