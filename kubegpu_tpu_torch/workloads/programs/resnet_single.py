"""Single-card ResNet training (counterpart of
``kubegpu_tpu/workloads/programs/resnet_single.py``, BASELINE config 2's
workload).

Checks that the injection granted exactly the chips the pod expects (and,
on the card, that CUDA sees that many cards), then
trains a structure-preserving ResNet on a fixed synthetic batch with
``adam(1e-2)`` and prints the reference's line::

    resnet: first_loss=... last_loss=... chips=[...]

    python -m kubegpu_tpu_torch.workloads.programs.resnet_single

runs on the card and fails where there is none; :func:`main` takes
``device="cpu"`` for tests.

Env knobs (the reference's):
  KUBETPU_EXPECT_CHIPS  the chip count ``TPU_VISIBLE_CHIPS`` must list,
                        and on the card ``torch.cuda.device_count()``
                        (else exit 2)
  RESNET_PRESET         "50": ResNet-50 (100 classes, bf16 convolutions);
                        otherwise ``resnet_tiny``
  RESNET_STEPS          train steps (default 6)

Images [8, 32, 32, 3] (NHWC) are normal draws from a ``torch.Generator``
seeded 0 (``kubegpu_tpu_torch.prng`` has no ``normal``; the reference
draws them with ``jax.random.normal``), labels ``arange(8) % 10``.  Exit
codes: 0, 2 for a wrong chip count, 3 for a loss that did not fall.  As
the reference's, it reads the env without joining a gang: a single-chip
program.
"""

from __future__ import annotations

import os
import sys


def main(device="cuda") -> int:
    from kubegpu_tpu_torch.workloads.programs.distributed import (
        program_device,
        read_env,
    )

    env = read_env()
    expect = os.environ.get("KUBETPU_EXPECT_CHIPS")
    if expect is not None and len(env.visible_chips) != int(expect):
        print(f"FAIL: expected {expect} chips, got {env.visible_chips}",
              file=sys.stderr)
        return 2

    import torch

    from kubegpu_tpu_torch.models.resnet import (
        make_resnet_train_step,
        resnet50,
        resnet_tiny,
        resnet_variables,
    )
    from kubegpu_tpu_torch.optim import adam

    device = program_device(device, "resnet_single")
    if device.type == "cuda" and expect is not None \
            and torch.cuda.device_count() != int(expect):
        print(f"FAIL: expected {expect} cards, CUDA sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    model = (resnet50(num_classes=100, device=device, seed=1)
             if os.environ.get("RESNET_PRESET") == "50"
             else resnet_tiny(device=device, seed=1))
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randn((8, 32, 32, 3), generator=gen, device=device)
    labels = torch.arange(8, device=device) % 10
    params, bs = resnet_variables(model)
    opt = adam(1e-2)
    opt_state = opt.init(params)
    step = make_resnet_train_step(model, opt)
    first = None
    for _ in range(int(os.environ.get("RESNET_STEPS", "6"))):
        params, bs, opt_state, loss = step(params, bs, opt_state, images,
                                           labels)
        first = first if first is not None else float(loss)
    print(f"resnet: first_loss={first:.4f} last_loss={float(loss):.4f} "
          f"chips={env.visible_chips}")
    if not float(loss) < first:
        print("FAIL: loss did not decrease", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    from kubegpu_tpu_torch.workloads.programs.distributed import run_program
    raise SystemExit(run_program(main))
