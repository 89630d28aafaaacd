"""Llama training workload (counterpart of
``kubegpu_tpu/workloads/programs/llama_pjit.py``, BASELINE config 4's).

The pod trains a Llama-family model on its card with ``make_train_step`` +
``adamw(1e-3)`` and prints the reference's line (worker 0)::

    llama_pjit: preset=tiny mesh={'dp': 1} workers=1 devices=1
    start_step=0 resumed_opt=False losses=[...]   (one line)

    python -m kubegpu_tpu_torch.workloads.programs.llama_pjit

runs on the card and fails where there is none; :func:`main` takes
``device="cpu"`` for tests.

Env knobs (the reference's):
  LLAMA_PRESET   tiny (default) | 8b
  LLAMA_STEPS    number of train steps (default 3)
  LLAMA_MESH     e.g. "dp:2,tp:2"; defaults to the scheduler-injected
                 KUBETPU_MESH_AXES, else dp over all devices.  The axes
                 fold down to the devices present (:func:`parse_mesh`);
                 a mesh of more than one device raises
                 ``NotImplementedError``: sharded training waits for
                 multi-device support (ROADMAP.md queue 1, item 9)
  LLAMA_CKPT_DIR restore / save (params and optimizer state): raises
                 ``NotImplementedError``, the reference's
                 ``TrainCheckpointer`` is item 9's
  LLAMA_PROFILE_DIR
                 if set, worker 0 writes a ``torch.profiler`` Chrome trace
                 of the train steps there (``llama_pjit.trace.json``), where
                 the reference writes a ``jax.profiler`` trace

Exit codes: 0, or 3 for a non-finite loss.  A pod of more than one worker
raises in :func:`~kubegpu_tpu_torch.workloads.programs.distributed.
init_from_env`.
"""

from __future__ import annotations

import json
import os
import sys


def parse_mesh(spec: str | None, n_devices: int) -> dict[str, int]:
    """Mesh axes with graceful degradation: if the requested product
    doesn't match the devices actually present (e.g. the CPU simulation
    gives 1 device/process where real hosts have 4 chips), fold the axes
    down rather than crash — dropping from the front (dp absorbs last)."""
    axes: dict[str, int] = {}
    if spec:
        for part in spec.split(","):
            k, v = part.split(":")
            axes[k.strip()] = int(v)
    elif os.environ.get("KUBETPU_MESH_AXES"):
        axes = {k: int(v)
                for k, v in json.loads(os.environ["KUBETPU_MESH_AXES"])}
    if not axes:
        return {"dp": n_devices}
    prod = 1
    for v in axes.values():
        prod *= v
    if prod == n_devices:
        return axes
    # fold: shrink axes (last-first) until the product fits, then give
    # any remainder to dp
    out = dict(axes)
    for name in reversed(list(out)):
        while out[name] > 1 and prod > n_devices:
            if prod % 2:
                break
            out[name] //= 2
            prod //= 2
    if prod != n_devices:
        out = {"dp": n_devices}
    print(f"llama_pjit: folded mesh {axes} -> {out} "
          f"for {n_devices} devices", file=sys.stderr)
    return out


def _n_devices(device) -> int:
    """The devices this worker sees: the cards, or one CPU."""
    import torch

    return torch.cuda.device_count() if device.type == "cuda" else 1


def main(device="cuda") -> int:
    from kubegpu_tpu_torch.workloads.programs.distributed import (
        init_from_env,
        program_device,
    )

    env = init_from_env()
    import math

    import torch

    from kubegpu_tpu_torch.models import LlamaConfig, llama_init
    from kubegpu_tpu_torch.models.llama import make_train_step
    from kubegpu_tpu_torch.optim import adamw
    from kubegpu_tpu_torch.tree import tree_leaves

    device = program_device(device, "llama_pjit")
    preset = os.environ.get("LLAMA_PRESET", "tiny")
    steps = int(os.environ.get("LLAMA_STEPS", "3"))
    cfg = (LlamaConfig.llama3_8b() if preset == "8b"
           else LlamaConfig.tiny(n_heads=4, n_kv_heads=4, dtype="float32"))
    n_devices = _n_devices(device)
    axes = parse_mesh(os.environ.get("LLAMA_MESH"), n_devices)
    if math.prod(axes.values()) > 1:
        raise NotImplementedError(
            f"llama_pjit: a mesh of {math.prod(axes.values())} devices "
            f"({axes}) waits for multi-device support (ROADMAP.md queue 1, "
            "item 9)")
    if os.environ.get("LLAMA_CKPT_DIR"):
        raise NotImplementedError(
            "llama_pjit: LLAMA_CKPT_DIR needs the reference's "
            "TrainCheckpointer, which waits for multi-device support "
            "(ROADMAP.md queue 1, item 9)")

    params = llama_init(cfg, seed=0, device=device)
    for p in tree_leaves(params):
        p.requires_grad_()
    opt = adamw(1e-3)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    batch = max(2, axes.get("dp", 1) * axes.get("fsdp", 1))
    seq = 32   # the all-T loss contract: tokens are [B, T]
    start_step, resumed_opt = 0, False
    profile_dir = os.environ.get("LLAMA_PROFILE_DIR")
    prof = None
    if profile_dir and env.worker_id == 0:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
        prof.start()
    losses = []
    try:
        for i in range(start_step, start_step + steps):
            tokens = (torch.arange(batch * seq, dtype=torch.int64,
                                   device=device).reshape(batch, seq)
                      * (i + 3)) % cfg.vocab_size
            with torch.profiler.record_function(f"train_step_{i}"):
                params, opt_state, loss = step_fn(params, opt_state, tokens)
            losses.append(float(loss))
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "llama_pjit.trace.json"))

    if env.worker_id == 0:
        print(f"llama_pjit: preset={preset} mesh={axes} "
              f"workers={env.num_workers} devices={n_devices} "
              f"start_step={start_step} resumed_opt={resumed_opt} "
              f"losses={[round(l, 4) for l in losses]}")
    if not all(math.isfinite(l) for l in losses):
        print("FAIL: non-finite loss", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
