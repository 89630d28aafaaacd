"""T5 seq2seq training workload (counterpart of
``kubegpu_tpu/workloads/programs/t5_train.py``): the encoder-decoder
family, trained on one card.

    python -m kubegpu_tpu_torch.workloads.programs.t5_train

runs on the card and fails where there is none; :func:`main` takes
``device="cpu"`` for tests.  It prints the reference's line (worker 0)::

    t5: devices=1 tp=1 losses=[...]

Env knobs (the reference's):
  T5_STEPS   train steps (default 4)
  T5_TP      tensor-parallel width (default 1); above 1 raises
             ``NotImplementedError``: tp waits for multi-device support
             (ROADMAP.md queue 1, item 9)

One FIXED batch (encoder [8, 16], decoder [8, 12] tokens), so the
loss-decrease gate measures the same data.  The reference draws it with
``jax.random.randint``; ``kubegpu_tpu_torch.prng`` has no ``randint``, so
here it comes from ``torch.Generator``s seeded 1 and 2: other tokens, the
same shapes and range.  Exit codes: 0, or 3 for a non-finite or
non-falling loss.  A pod of more than one worker raises (ROADMAP item 9)
before any rendezvous.
"""

from __future__ import annotations

import os
import sys


def main(device="cuda") -> int:
    from kubegpu_tpu_torch.workloads.programs.distributed import (
        program_device,
        single_worker_env,
    )

    env = single_worker_env("t5_train")
    import math

    import torch

    from kubegpu_tpu_torch.models.t5 import (
        T5Config,
        make_t5_train_step,
        t5_init,
    )
    from kubegpu_tpu_torch.optim import adamw
    from kubegpu_tpu_torch.tree import tree_leaves

    device = program_device(device, "t5_train")
    steps = max(1, int(os.environ.get("T5_STEPS", "4")))
    tp = max(1, int(os.environ.get("T5_TP", "1")))
    if tp > 1:
        raise NotImplementedError(
            f"t5_train: T5_TP={tp} (tensor parallelism) waits for "
            "multi-device support (ROADMAP.md queue 1, item 9)")
    cfg = T5Config.tiny()
    n = 1   # one device

    params = t5_init(cfg, seed=0, device=device)
    for p in tree_leaves(params):
        p.requires_grad_()
    opt = adamw(1e-3)
    opt_state = opt.init(params)
    step = make_t5_train_step(cfg, opt)
    dp = n // tp
    batch = dp * max(1, 8 // dp)

    def tokens(seed: int, length: int) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randint(0, cfg.vocab_size, (batch, length),
                             generator=gen, device=device)

    enc, dec = tokens(1, 16), tokens(2, 12)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, enc, dec)
        losses.append(float(loss))

    if env.worker_id == 0:
        print(f"t5: devices={n} tp={tp} "
              f"losses={[round(l, 4) for l in losses]}")
    if not all(math.isfinite(l) for l in losses) or (
            len(losses) > 1 and not losses[-1] < losses[0]):
        print("FAIL: loss not improving", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    from kubegpu_tpu_torch.workloads.programs.distributed import run_program
    raise SystemExit(run_program(main))
