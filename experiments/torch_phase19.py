"""``chip_smoke.py``'s phase 19 (the daemons) alone on a card node: the
kernels built first (the serving pod loads them), then the apiserver, the
scheduler daemon and the node daemon over ``NvmlBackend`` as processes of
their own, ``serve-llama.json``'s continuous serving pod and one-card probe
pods through them, the extender webhook over HTTP in this process, the
allreduce gang where there are two or more cards, and the check that
nothing the phase started outlives it.  Prints the phase's lines and
seconds, and with a path writes its numbers as JSON.

    PYTHONPATH=. python experiments/torch_phase19.py [OUT.json]
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
    out = {"card": card, "daemons": cs.daemons_phase(torch, kernels)}
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f, indent=1, default=str)
    print("[total]", round(time.perf_counter() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
