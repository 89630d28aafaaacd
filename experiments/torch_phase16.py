"""``chip_smoke.py``'s phase 16 (the serving pools at tp > 1) alone.  On one
card: build the kernels and run ``pool_tp_phase`` ((a) the narrow f32
pools and (b) Llama-3-8B's width at 8 layers over four gloo ranks on the
card; (c) says it was not run).  With ``--nccl`` (a call with four cards):
(c) alone, ``pool_tp_nccl``: the dp = 2 × tp = 2 and the 1 + 1
disaggregated pools at 32 layers over NCCL with graphs, gang 0 on cards
0-1 and gang 1 on cards 2-3, and the dp pool against one gang on a
throughput window of 32 prompts × 128 new tokens.  With a path, the
numbers go there as JSON.

    PYTHONPATH=. python experiments/torch_phase16.py [OUT.json]   # 1 H100
    PYTHONPATH=. python experiments/torch_phase16.py --nccl [OUT.json]
"""

import json
import subprocess
import sys
import time


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from kubegpu_tpu_torch import kernels
    nccl = "--nccl" in argv
    argv = [a for a in argv if a != "--nccl"]
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build()
    print("[build]", round(time.perf_counter() - t0, 2), flush=True)
    name = torch.cuda.get_device_name(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 18)
    kernels.reset_launches()
    if nccl:
        out = {"nccl": cs.pool_tp_nccl(torch, kernels, gen, name)}
    else:
        out = cs.pool_tp_phase(torch, kernels, gen, name)
    if argv:
        with open(argv[0], "w") as f:
            json.dump({"card": name, **out}, f, indent=1, default=str)
    print("[total]", round(time.perf_counter() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
