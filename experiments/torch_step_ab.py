"""A/B of the Llama train step between two checkouts of the port, on one card.

    python experiments/torch_step_ab.py BEFORE_ROOT AFTER_ROOT

``chip_smoke.train_phase`` (Llama-3-8B widths cut to 8 layers, remat,
bf16, one [4, 2048] batch: parity at batch 1, one warm and three timed
steps of ``make_train_step`` + ``adamw``) runs in a fresh process for each
root in the order before, after, after, before; each process imports the
port and ``chip_smoke`` from its own root, so each builds that root's
kernels under ``<root>/build/kernels``.  Prints one line per run and a
JSON summary last: median step ms, MFU, peak memory and losses per run,
with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

CODE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke
from kubegpu_tpu_torch import kernels
kernels.build()
gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
st = chip_smoke.train_phase(torch, kernels, gen,
                            torch.cuda.get_device_name(0), False)
print("RESULT " + json.dumps({{k: st[k] for k in (
    "step_ms", "step_ms_median", "tokens_per_s", "mfu", "max_memory_gb",
    "losses")}}))
"""


def run(root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CODE.format(root=root)],
                          capture_output=True, text=True, cwd=root,
                          timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"train phase failed under {root}")
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    before, after = sys.argv[1:3]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    runs = []
    for label, root in (("before", before), ("after", after),
                        ("after", after), ("before", before)):
        r = run(root)
        runs.append({"run": label, **r})
        print(label, json.dumps(r), flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
