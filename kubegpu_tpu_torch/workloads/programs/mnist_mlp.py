"""Single-pod MNIST-style MLP (counterpart of
``kubegpu_tpu/workloads/programs/mnist_mlp.py``, BASELINE configs 1 & 2's
workload).

Checks the injection (``KUBETPU_EXPECT_CHIPS`` against the granted
``TPU_VISIBLE_CHIPS`` and, on the card, ``torch.cuda.device_count()``, as
``resnet_single`` does), then trains the reference's MLP (784 → 128 → 10,
ReLU, softmax cross-entropy) with the port's ``optim.adam(1e-3)`` for 10
epochs over this worker's shard of a fixed synthetic dataset
(``ShardedBatcher`` of 256 examples in batches of 64, double-buffered onto
the device by ``prefetch_to_device``), and prints the reference's line::

    mnist_mlp: first_loss=... last_loss=... devices=... worker_id=...

(the first and last epochs' mean losses).  On the card it first prints the
``pod_device`` line of ``distributed.program_device``.

    python -m kubegpu_tpu_torch.workloads.programs.mnist_mlp

runs on the card and fails where there is none; :func:`main` takes
``device="cpu"`` for tests.  Exit codes: 0, 2 for a wrong chip count, 3
for a loss that did not fall.  As the reference's, each worker of a gang
trains on its own shard without joining a process group.

The weights are normal draws (× 0.05) from a ``torch.Generator`` seeded 0;
the reference draws them with ``jax.random``, so :func:`train` takes
initial parameters from its caller (the tests pass the reference's).
"""

from __future__ import annotations

import os
import sys

EPOCHS = 10
LEARNING_RATE = 1e-3


def init_params(device, seed: int = 0) -> dict:
    """``{"w1": [784, 128], "b1", "w2": [128, 10], "b2"}``, f32."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return {"w1": torch.randn((784, 128), generator=gen, device=device) * .05,
            "b1": torch.zeros(128, device=device),
            "w2": torch.randn((128, 10), generator=gen, device=device) * .05,
            "b2": torch.zeros(10, device=device)}


def make_mlp(params: dict):
    """The MLP as a ``torch.nn.Module`` whose parameters are copies of
    ``params`` (named as the reference's tree)."""
    import torch

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in params.items():
                self.register_parameter(
                    k, torch.nn.Parameter(v.detach().clone()))

        def forward(self, x):
            h = torch.relu(x @ self.w1 + self.b1)
            return h @ self.w2 + self.b2

    return MLP()


def train(params: dict, batcher, device, epochs: int = EPOCHS) -> list:
    """Train from ``params`` over ``batcher``'s epochs 0..epochs-1; returns
    each epoch's mean loss."""
    import torch

    from kubegpu_tpu_torch.optim import adam
    from kubegpu_tpu_torch.workloads.data import prefetch_to_device

    model = make_mlp(params)
    weights = dict(model.named_parameters())
    opt = adam(LEARNING_RATE)
    state = opt.init(weights)
    means = []
    for epoch in range(epochs):
        # fresh reshuffled epoch each pass; loss is averaged per epoch
        # so the decrease gate compares like against like
        losses = []
        for batch in prefetch_to_device(batcher.batches(epoch), size=2,
                                        device=device):
            loss = torch.nn.functional.cross_entropy(
                model(batch["x"]), batch["y"].long())
            grads = torch.autograd.grad(loss, list(weights.values()))
            state = opt.update(dict(zip(weights, grads)), state, weights)
            losses.append(float(loss.detach()))
        means.append(sum(losses) / len(losses))
    return means


def main(device="cuda") -> int:
    from kubegpu_tpu_torch.workloads.data import (
        Shard,
        ShardedBatcher,
        synthetic_features,
    )
    from kubegpu_tpu_torch.workloads.programs.distributed import (
        program_device,
        read_env,
    )

    env = read_env()
    expect = os.environ.get("KUBETPU_EXPECT_CHIPS")
    if expect is not None and len(env.visible_chips) != int(expect):
        print(f"FAIL: expected {expect} visible chips, got "
              f"{os.environ.get('TPU_VISIBLE_CHIPS', '')!r}", file=sys.stderr)
        return 2

    import torch

    device = program_device(device, "mnist_mlp")
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cards and expect is not None and cards != int(expect):
        print(f"FAIL: expected {expect} cards, CUDA sees {cards}",
              file=sys.stderr)
        return 2
    # the input pipeline: this worker's disjoint shard of a fixed
    # synthetic dataset, batched + double-buffered onto the device
    batcher = ShardedBatcher(synthetic_features(256, 784, 10),
                             batch_size=64, shard=Shard.from_worker_env(env))
    means = train(init_params(device), batcher, device)
    first, last = means[0], means[-1]
    print(f"mnist_mlp: first_loss={first:.4f} last_loss={last:.4f} "
          f"devices={cards or 1} worker_id="
          f"{os.environ.get('TPU_WORKER_ID', 'unset')}")
    if not last < first:
        print("FAIL: loss did not decrease", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    from kubegpu_tpu_torch.workloads.programs.distributed import run_program
    raise SystemExit(run_program(main))
