"""CPU-fallback MNIST in torch (counterpart of
``kubegpu_tpu/workloads/programs/mnist_torch.py``, BASELINE config 1's
workload).

The point of config 1 is that a workload asking no device schedules and
runs untouched: no device env, no allocation.  The program fails (exit 2)
if its env grants a device anyway — the reference's ``TPU_VISIBLE_CHIPS``
or the port's ``CUDA_VISIBLE_DEVICES``/``NVIDIA_VISIBLE_DEVICES`` (a 0-card
pod gets ``CUDA_VISIBLE_DEVICES=""``: no card) — or if CUDA sees a card;
then it trains the reference's torch MLP on the CPU and prints the
reference's line with the cards it saw::

    mnist_torch: first_loss=... last_loss=... cards=0

    python -m kubegpu_tpu_torch.workloads.programs.mnist_torch
"""

from __future__ import annotations

import os
import sys

DEVICE_ENV = ("TPU_VISIBLE_CHIPS", "CUDA_VISIBLE_DEVICES",
              "NVIDIA_VISIBLE_DEVICES")


def main() -> int:
    granted = {k: os.environ[k] for k in DEVICE_ENV if os.environ.get(k)}
    if granted:
        print(f"FAIL: CPU-fallback pod was granted devices: {granted}",
              file=sys.stderr)
        return 2
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards:
        print(f"FAIL: CPU-fallback pod sees {cards} cards", file=sys.stderr)
        return 2
    torch.manual_seed(0)
    x = torch.randn(256, 784)
    y = torch.randint(0, 10, (256,))
    model = torch.nn.Sequential(
        torch.nn.Linear(784, 64), torch.nn.ReLU(), torch.nn.Linear(64, 10))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss_fn = torch.nn.CrossEntropyLoss()
    first = None
    for _ in range(20):
        opt.zero_grad()
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        first = first if first is not None else float(loss.detach())
    last = float(loss.detach())
    print(f"mnist_torch: first_loss={first:.4f} last_loss={last:.4f} "
          f"cards={cards}")
    return 0 if last < first else 3


if __name__ == "__main__":
    from kubegpu_tpu_torch.workloads.programs.distributed import run_program
    raise SystemExit(run_program(main))
