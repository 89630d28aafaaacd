"""``chip_smoke.py``'s phase 20 (the allocator core and the workload
surface) alone on a card node: the C++ allocator core built with this
host's compiler and held against the Python paths, phase 17 (c)'s gang
mix both ways, then ``configs``, ``demo config1|config2 --real``,
``metrics`` and a ``mnist_mlp`` pod over ``NvmlBackend`` (its losses
against ``mnist_mlp.train`` on the CPU, each pod's reported kernel
launches), and ``prefetch_to_device``'s card branch against its numpy
source.  No CUDA kernel of the port runs, so none is built.  Prints the phase's lines and
seconds, and with a path writes its numbers as JSON.

    PYTHONPATH=. python experiments/torch_phase20.py [OUT.json]
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
    out = {"card": card, "workloads": cs.workloads_phase(torch, kernels)}
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f, indent=1, default=str)
    print("[total]", round(time.perf_counter() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
