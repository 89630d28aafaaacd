"""ViT training workload (counterpart of
``kubegpu_tpu/workloads/programs/vit_train.py``): the image-classification
family beyond ResNet, trained on one card.

    python -m kubegpu_tpu_torch.workloads.programs.vit_train

runs on the card and fails where there is none; :func:`main` takes
``device="cpu"`` for tests.  It prints the reference's line (worker 0)::

    vit: preset=tiny devices=1 losses=[...]

Env knobs (the reference's):
  VIT_PRESET  tiny (default) | b16
  VIT_STEPS   train steps (default 4)

One FIXED batch: images drawn with :func:`kubegpu_tpu_torch.prng.uniform`
on ``prng_key(0)``, bit-equal to the reference's ``jax.random.uniform(
PRNGKey(0), ...)``, and labels ``arange(batch) % n_classes``, so the
loss-decrease gate measures the same data.  Exit codes: 0, or 3 for a
non-finite or non-falling loss.  A pod of more than one worker raises
(ROADMAP item 9) before any rendezvous.
"""

from __future__ import annotations

import os
import sys


def main(device="cuda") -> int:
    from kubegpu_tpu_torch.workloads.programs.distributed import (
        program_device,
        single_worker_env,
    )

    env = single_worker_env("vit_train")
    import math

    import torch

    from kubegpu_tpu_torch import prng
    from kubegpu_tpu_torch.models.vit import (
        ViTConfig,
        make_vit_train_step,
        vit_init,
    )
    from kubegpu_tpu_torch.optim import adamw
    from kubegpu_tpu_torch.tree import tree_leaves

    device = program_device(device, "vit_train")
    preset = os.environ.get("VIT_PRESET", "tiny")
    steps = max(1, int(os.environ.get("VIT_STEPS", "4")))
    cfg = ViTConfig.base_16() if preset == "b16" else ViTConfig.tiny()
    n = 1   # one device: multi-device waits for ROADMAP.md item 9

    params = vit_init(cfg, seed=0, device=device)
    for p in tree_leaves(params):
        p.requires_grad_()
    opt = adamw(1e-3)
    opt_state = opt.init(params)
    step = make_vit_train_step(cfg, opt)
    batch = max(8, n)
    images = prng.uniform(prng.prng_key(0, device=device),
                          (batch, cfg.image_size, cfg.image_size, 3))
    labels = torch.arange(batch, device=device) % cfg.n_classes
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, images, labels)
        losses.append(float(loss))

    if env.worker_id == 0:
        print(f"vit: preset={preset} devices={n} "
              f"losses={[round(l, 4) for l in losses]}")
    if not all(math.isfinite(l) for l in losses) or (
            len(losses) > 1 and not losses[-1] < losses[0]):
        print("FAIL: loss not improving", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    from kubegpu_tpu_torch.workloads.programs.distributed import run_program
    raise SystemExit(run_program(main))
