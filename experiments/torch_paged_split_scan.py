"""What sets the time of kernels 4-6 on the split walk: time against bytes.

    python experiments/torch_paged_split_scan.py    # on an H100

Times ``paged_attention`` with ``chip_smoke.cuda_ms`` (cold L2) at the
serving engine's shape (Llama-3-8B heads: 8 rows, Hq 32, Hkv 8, pages of
128, head dim 128, bf16 queries) with 256, 512, 1024, 2048 and 4096
prompt keys a row (one page past them, as the engine's decode page), over
bf16 pages (kernel 4), int8 pages (kernel 5) and packed int4 pages in
groups of 16 (kernel 6), each without and with the per-page mass; a
one-element fill is the floor of one launch under the same timer.  Each
run is also traced with ``torch.profiler``: the kernel's own duration on
the card, without the launch and the events around it.  For each series a
least-squares line through (bytes, ms) splits the time into a fixed part
(the intercept: launch and dependent memory round trips) and a streaming
rate (the slope, as GB/s against the card's 3.35 TB/s), once for the
timer's ms and once for the kernel's, and each run's share of its byte
bound (bytes over 3.35 TB/s, the ``chip_smoke.py`` count: K and V of the
valid keys, their scales, q, the page table and row state, o/m/l) is
printed.  Prints one line per run and a JSON summary last, with the
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
from kubegpu_tpu_torch.ops import kvquant as kvq  # noqa: E402
from kubegpu_tpu_torch.ops import paged_attention as pa  # noqa: E402

B, HQ, HKV, P, D = 8, 32, 8, 128, 128


def case(keys: int, gen):
    """Pools of every format and the row state for ``keys`` prompt keys a
    row, and each format's bytes."""
    n_tab = keys // P + 1
    i32 = dict(dtype=torch.int32, device="cuda")
    pk, pv = (torch.randn(2, 1 + B * n_tab, HKV, P, D, generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    q = torch.randn(B, HQ, D, generator=gen, device="cuda").bfloat16()
    pt = (1 + torch.arange(B, **i32)[:, None] * n_tab
          + torch.arange(n_tab, **i32)[None, :])
    t = torch.full((B,), keys, **i32)
    tpad = torch.full((B,), n_tab * P - P, **i32)
    zeros = torch.zeros(B, **i32)
    pools = {"bf16": (pk, pv, None, None),
             "q8": chip_smoke.quantize_pool(torch, kvq, pk, pv, "q8"),
             "q4g16": chip_smoke.quantize_pool(torch, kvq, pk, pv, "q4g16")}
    fixed = (B * HQ * D * 2 + pt.numel() * 4 + 3 * B * 4
             + B * HQ * (D + 2) * 4)
    valid = B * keys
    kv_bytes = {"bf16": valid * HKV * D * 2 * 2,
                "q8": valid * HKV * (D + 4) * 2,
                "q4g16": (valid * D // 2 + B * -(-keys // 16) * 4) * HKV * 2}
    args = {fmt: (q, kq, vq, pt, 1, t, tpad, zeros, ks, vs)
            for fmt, (kq, vq, ks, vs) in pools.items()}
    return args, {fmt: fixed + n for fmt, n in kv_bytes.items()}


def kernel_ms(fn, n: int = 10) -> float:
    """Mean duration of the paged kernel's launches in ``n`` calls of
    ``fn``, as the profiler records them on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA and "paged" in e.name]
    return sum(us) / 1e3 / n


def fit(rows: list, key: str) -> dict:
    n = len(rows)
    mx = sum(r["bytes"] for r in rows) / n
    my = sum(r[key] for r in rows) / n
    slope = (sum((r["bytes"] - mx) * (r[key] - my) for r in rows)
             / sum((r["bytes"] - mx) ** 2 for r in rows))
    return {"fixed_ms": my - slope * mx, "rate_gb_per_s": 1e-6 / slope}


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.empty(1, device="cuda")
    floor = chip_smoke.cuda_ms(lambda: one.fill_(1.0))
    print(f"floor one-element fill ms={floor}", flush=True)
    series: dict[str, list] = {}
    for keys in (256, 512, 1024, 2048, 4096):
        args, n_bytes = case(keys, gen)
        for fmt in ("bf16", "q8", "q4g16"):
            a = args[fmt]
            for mass in (False, True):
                call = (lambda: pa.paged_attention(*a, collect_mass=mass))
                ms = chip_smoke.cuda_ms(call)
                bound = n_bytes[fmt] / chip_smoke.PEAK_BYTES * 1e3
                row = {"format": fmt, "mass": mass, "keys": keys,
                       "bytes": n_bytes[fmt], "ms": ms,
                       "kernel_ms": kernel_ms(call), "bound_ms": bound,
                       "share_of_bound": bound / ms}
                series.setdefault(f"{fmt}{'+mass' if mass else ''}",
                                  []).append(row)
                print(json.dumps(row), flush=True)
        del args
        torch.cuda.empty_cache()
    fits = {name: {"timer": fit(rows, "ms"), "kernel": fit(rows, "kernel_ms")}
            for name, rows in series.items()}
    print(json.dumps({"card": card, "floor_ms": floor, "fits": fits,
                      "runs": series}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
