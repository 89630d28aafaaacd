"""``chip_smoke.py``'s phase 17 (the cluster layer) alone on a card node:
NVML discovery against torch and nvidia-smi, the two example specs' pods
applied through the cluster ``apply --real --set backend.type=nvml`` builds
on this node's cards (each pod reporting its kernel launches), ``apply
--real`` itself on the resnet spec, and the host-only scheduling run over
32 mock ``h100-sxm-8`` nodes.  Prints the phase's lines and seconds, and
with a path writes its numbers as JSON.  The pods build any kernel they
need themselves.

    PYTHONPATH=. python experiments/torch_phase17.py [OUT.json]
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
    out = {"card": card, "cluster": cs.cluster_phase(torch, kernels)}
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f, indent=1, default=str)
    print("[total]", round(time.perf_counter() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
