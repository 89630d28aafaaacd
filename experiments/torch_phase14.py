"""``chip_smoke.py``'s phase 14 (the training families) and phase 3's ViT
shape alone: build the kernels, run the card's tensor-core flash tests,
time kernels 2 and 3 at the training shape (``flash_bwd_checks``), then
``vit_shape_checks`` and ``train_families_phase``; with a path, their
numbers go there as JSON.

    PYTHONPATH=. python experiments/torch_phase14.py [OUT.json]   # H100
"""

import json
import os
import subprocess
import sys
import time


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from kubegpu_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.build()
    print("[build]", round(time.perf_counter() - t0, 2), flush=True)
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                        "-m", "cuda", "-x", "tests/test_torch_cuda.py", "-k",
                        "flash_tc"], capture_output=True, text=True)
    print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    if r.returncode:
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    bwd, _ = cs.flash_bwd_checks(
        torch, torch.Generator(device="cuda").manual_seed(5))
    print({k: v["ms"] for k, v in bwd.items()}, flush=True)
    torch.cuda.empty_cache()
    vit = cs.vit_shape_checks(
        torch, torch.Generator(device="cuda").manual_seed(cs.SEED + 9))
    torch.cuda.empty_cache()
    out = cs.train_families_phase(
        torch, kernels, torch.Generator(device="cuda").manual_seed(cs.SEED + 8),
        name)
    if len(argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(argv[1])), exist_ok=True)
        with open(argv[1], "w") as f:
            json.dump({"vit_shape": vit, "train14": out}, f, indent=1,
                      default=str)
    print("total", round(time.perf_counter() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
