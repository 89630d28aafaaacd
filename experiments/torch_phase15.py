"""``chip_smoke.py``'s phase 15 (tensor-parallel serving) and phase 3's
tp-local kernel shapes alone.  On one card: build the kernels, run
``tp_shape_checks`` (kernels 4-6 at the local shapes of tp = 2 and 4) and
``tp_phase`` ((a) narrow f32 and (b) Llama-3-8B over two gloo ranks; (c)
says it was not run).  With ``--nccl`` (a call with several cards): the
tp = 1 bf16 graph engine's window and first-step logits
(``tp_single``), then ``tp_nccl`` over 2 ranks and over
``min(4, device_count)``, one a card, graphs on.  With a path, the
numbers go there as JSON.

    PYTHONPATH=. python experiments/torch_phase15.py [OUT.json]   # 1 H100
    PYTHONPATH=. python experiments/torch_phase15.py --nccl [OUT.json]
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
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 16)
    if nccl:
        prompts, single, ref = cs.tp_single(torch, kernels, gen,
                                            (("bf16", True),))
        out = {"single": {k: v["tokens_per_s"] for k, v in single.items()}}
        for n in sorted({2, min(4, torch.cuda.device_count())}):
            out[f"tp{n}"] = cs.tp_nccl(torch, name, prompts, single, ref,
                                       n=n)
    else:
        gen0 = torch.Generator(device="cuda").manual_seed(cs.SEED)
        lens = [int(x) for x in torch.randint(200, 513, (8,), generator=gen0,
                                              device="cuda")]
        rows = [([1 + 5 * i + j for j in range(5)], n, 512, 16)
                for i, n in enumerate(lens)]
        out = {"shapes": cs.tp_shape_checks(
            torch, torch.Generator(device="cuda").manual_seed(cs.SEED + 15),
            rows)}
        torch.cuda.empty_cache()
        kernels.reset_launches()
        out["tp"] = cs.tp_phase(torch, kernels, gen, name)
    if argv:
        with open(argv[0], "w") as f:
            json.dump({"card": name, **out}, f, indent=1, default=str)
    print("[total]", round(time.perf_counter() - t0, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
