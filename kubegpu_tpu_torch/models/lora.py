"""LoRA adapters for the Llama family (counterpart of
``kubegpu_tpu/models/lora.py``).

Parameter-efficient fine-tuning: frozen base weights plus trainable
low-rank deltas ``w_eff = w + (alpha / rank) * a @ b`` on selected stacked
matmul weights.  The model code uses its weights only through ``@``, so the
step differentiates :func:`lora_merge` followed by the unchanged forward and
loss, and updates only the adapters.  The base tree's leaves carry no
``requires_grad``: autograd builds no gradient for them, so they are frozen
by construction rather than masked, and the optimizer's moments exist for
the adapters alone.

Single device: the reference's adapter sharding (``lora_param_specs``)
waits for multi-device support (ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubegpu_tpu_torch.tree import tree_leaves

# the classic attention-only default (LoRA paper: q and v projections)
DEFAULT_TARGETS = ("wq", "wv")
# every stacked matmul weight that CAN take an adapter
ADAPTABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple[str, ...] = DEFAULT_TARGETS

    def __post_init__(self) -> None:
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        bad = set(self.targets) - set(ADAPTABLE)
        if bad:
            raise ValueError(f"unknown LoRA targets {sorted(bad)}; "
                             f"adaptable: {ADAPTABLE}")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def lora_init(params: dict, lcfg: LoRAConfig, seed: int = 0, device="cuda",
              generator: torch.Generator | None = None) -> dict:
    """Adapters for the targeted stacked weights: per target, ``a`` [L, in,
    r] (normal / sqrt(in)) and ``b`` [L, r, out] (zeros), in the base
    weight's dtype, drawn from ``generator`` (default: a generator on
    ``device`` seeded with ``seed``).  The initial delta is exactly zero,
    so step 0 of fine-tuning is the base model.  The weights must be
    ``[L, in, out]`` (Llama's, or the MoE family's attention leaves)."""
    gen = generator or torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in lcfg.targets:
        w = params["layers"][name]
        ell, d_in, d_out = w.shape
        a = torch.randn((ell, d_in, lcfg.rank), generator=gen, device=device,
                        dtype=torch.float32) * d_in ** -0.5
        out[name] = {"a": a.to(w.dtype),
                     "b": torch.zeros((ell, lcfg.rank, d_out), dtype=w.dtype,
                                      device=device)}
    return out


def lora_merge(params: dict, adapters: dict, lcfg: LoRAConfig) -> dict:
    """The base tree with each targeted weight replaced by ``w + scale *
    a @ b`` (the delta cast to the weight's dtype): called inside the loss
    it is differentiable in the adapters; called once, it bakes them in
    for serving."""
    layers = dict(params["layers"])
    for name, ab in adapters.items():
        delta = torch.einsum("lir,lro->lio", ab["a"], ab["b"])
        w = params["layers"][name]
        layers[name] = w + (lcfg.scaling * delta).to(w.dtype)
    return {**params, "layers": layers}


def lora_n_params(adapters: dict) -> int:
    return sum(x.numel() for x in tree_leaves(adapters))


def make_lora_train_step(cfg, lcfg: LoRAConfig, optimizer, mesh=None,
                         loss_fn=None):
    """``step(adapters, opt_state, base_params, tokens) → (adapters,
    opt_state, loss)``: gradients flow to the adapters only (leaf tensors
    with ``requires_grad``), and the base passes through untouched.
    ``loss_fn(params, tokens, cfg)`` defaults to Llama's next-token loss;
    the MoE family passes ``moe_next_token_loss``.  The update runs in
    place, as Llama's step."""
    from kubegpu_tpu_torch.models.llama import next_token_loss

    if mesh is not None:
        raise NotImplementedError("a mesh (sharded adapters) waits for "
                                  "multi-device support: ROADMAP.md queue 1,"
                                  " item 9")
    loss_fn = loss_fn if loss_fn is not None else next_token_loss

    def step(adapters, opt_state, base_params, tokens):
        leaves = tree_leaves(adapters)
        loss = loss_fn(lora_merge(base_params, adapters, lcfg), tokens, cfg)
        grads = torch.autograd.grad(loss, leaves)
        opt_state = optimizer.update(grads, opt_state, leaves)
        return adapters, opt_state, loss.detach()

    return step
