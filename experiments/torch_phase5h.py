"""``chip_smoke.py``'s phase 5h (beam search, speculative and prompt-lookup
decoding) and phase 3's search shapes alone: build the kernels, run
``search_shape_checks`` (kernel 4 at the beam and PLD verify shapes), init
Llama-3-8B from seed 0, quantize it to int8 and run ``search_phase``; with
a path, their numbers go there as JSON.

    PYTHONPATH=. python experiments/torch_phase5h.py [OUT.json]   # H100
"""

import json
import subprocess
import sys
import time


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from kubegpu_tpu_torch import kernels
    from kubegpu_tpu_torch.models import LlamaConfig, llama_init
    from kubegpu_tpu_torch.models.quant import quantize_llama
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build()
    print("[build]", round(time.perf_counter() - t0, 2), flush=True)
    name = torch.cuda.get_device_name(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    shapes = cs.search_shape_checks(
        torch, torch.Generator(device="cuda").manual_seed(cs.SEED + 12))
    cfg = LlamaConfig.llama3_8b()
    qparams = quantize_llama(llama_init(cfg, seed=cs.SEED, device="cuda"))
    torch.cuda.empty_cache()
    kernels.reset_launches()
    out = cs.search_phase(
        torch, kernels, cfg, qparams,
        torch.Generator(device="cuda").manual_seed(cs.SEED + 10), name)
    print("[launches]", dict(kernels.launches), flush=True)
    if argv:
        with open(argv[0], "w") as f:
            json.dump({"card": name, "shapes": shapes, "search": out}, f,
                      indent=1, default=str)
    print("[total]", round(time.perf_counter() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
