"""What sets kernel 7's time: its time against the bytes it reads.

    python experiments/torch_paged_bias_scan.py        # on a machine with an H100

Times ``paged_attention_biased`` (kernel 7, the split walk) with
``chip_smoke.cuda_ms`` (cold L2) at T5 v1.1-base's serving shape (bf16, 8
rows, 12 heads, pages of 128, head dim 64, q_pos past the keys) with 256,
512, 1024, 2048 and 4096 flushed keys a row, and a one-element fill as the
floor of one launch under the same timer.  Each size runs under three
split policies, set through the wrapper's cap on splits a row
(``_MAX_SPLITS``): 32 (one page a split), 2 and 1 (one CTA a row and head,
no cross-CTA merge).  For each policy a least-squares line through (bytes,
ms) splits the time into a fixed part (the intercept: launch and dependent
memory round trips) and a rate (the slope, as GB/s against the card's
3.35 TB/s).  Prints one line per run and a JSON summary last, with the
card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from kubegpu_tpu_torch.ops import paged_attention as pa  # noqa: E402


def case(keys: int, gen):
    b, h, p, dd, nb = 8, 12, 128, 64, 32
    n_blocks = keys // p + 1   # one page past the keys, as the T5 path
    i32 = dict(dtype=torch.int32, device="cuda")
    pk, pv = (torch.randn(2, 1 + b * n_blocks, h, p, dd, generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    q = torch.randn(b, h, dd, generator=gen, device="cuda").bfloat16()
    pt = (1 + torch.arange(b, **i32)[:, None] * n_blocks
          + torch.arange(n_blocks, **i32)[None, :])
    zeros = torch.zeros(b, **i32)
    d = torch.full((b,), keys, **i32)
    qpos = keys + torch.arange(b, **i32) * 16
    table = torch.randn(h, nb, generator=gen, device="cuda")
    args = (q, pk, pv, pt, 1, zeros, zeros, d, qpos, table)
    n_bytes = (b * keys * h * dd * 2 * 2 + b * h * dd * 2 + h * nb * 4
               + pt.numel() * 4 + 4 * b * 4 + b * h * (dd + 2) * 4)
    return args, n_bytes


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.empty(1, device="cuda")
    floor = chip_smoke.cuda_ms(lambda: one.fill_(1.0))
    print(f"floor one-element fill ms={floor}", flush=True)
    cap = pa._MAX_SPLITS
    policies = {}
    for keys in (256, 512, 1024, 2048, 4096):
        args, n_bytes = case(keys, gen)
        for max_splits in (cap, 2, 1):
            pa._MAX_SPLITS = max_splits
            ms = chip_smoke.cuda_ms(
                lambda: pa.paged_attention_biased(*args, bias_max_dist=128))
            row = {"max_splits": max_splits, "keys": keys, "bytes": n_bytes,
                   "ms": ms,
                   "bound_ms": n_bytes / chip_smoke.PEAK_BYTES * 1e3}
            policies.setdefault(max_splits, []).append(row)
            print(json.dumps(row), flush=True)
        pa._MAX_SPLITS = cap
    fits = {}
    for max_splits, rows in policies.items():
        n = len(rows)
        mx = sum(r["bytes"] for r in rows) / n
        my = sum(r["ms"] for r in rows) / n
        slope = (sum((r["bytes"] - mx) * (r["ms"] - my) for r in rows)
                 / sum((r["bytes"] - mx) ** 2 for r in rows))
        fits[max_splits] = {"fixed_ms": my - slope * mx,
                            "rate_gb_per_s": 1e-6 / slope}
    print(json.dumps({"card": card, "floor_ms": floor, "fits": fits,
                      "runs": policies}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
