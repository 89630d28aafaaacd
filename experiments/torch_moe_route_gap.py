"""The gap between ``moe_forward`` (kernel 1's attention) and the plain
cached path (``_forward_with_cache`` with the routed FFN, which
``moe_prefill`` runs) on one [1, 512] prompt, at Mixtral-8x7B's width cut
to 8 layers in bf16 (random weights from seed 0), and how many tokens each
layer routes differently between the two: at the config's capacity factor
and at a no-drop one (4.0 = n_experts / top_k), over four prompts; then the
same comparison in f32 at 2 layers.  A routing choice is a step function of
the router's logits, so bf16 noise that the two attention paths leave in
the residual stream moves tokens to other experts, more of them each
layer, and with a tight capacity a moved token also moves which later
tokens overflow.

    PYTHONPATH=. python3 experiments/torch_moe_route_gap.py

Needs one CUDA card; prints the card's name and power limit, then one line
a case: the relative L2 of the last position's logits and of all of them,
the tokens rerouted a layer, the expert slots kept a layer, and whether
the last token was rerouted in each layer.
"""

import dataclasses
import subprocess

import torch

from kubegpu_tpu_torch import kernels
from kubegpu_tpu_torch.models import MoEConfig
from kubegpu_tpu_torch.models import decode as dm
from kubegpu_tpu_torch.models import moe as mm

SEED = 0


def width(n_layers: int, dtype: str = "bfloat16") -> MoEConfig:
    cfg = MoEConfig.mixtral_8x7b_shaped()
    return dataclasses.replace(cfg, base=dataclasses.replace(
        cfg.base, n_layers=n_layers, dtype=dtype))


def routed(record: list):
    """``mm.route_tokens`` wrapped to record, a call, which experts kept
    each token ([G, T, E] bool) and the slots kept."""
    inner = mm.route_tokens

    def route(logits, k, cap):
        dispatch, combine, aux = inner(logits, k, cap)
        record.append((dispatch.sum(-1) > 0, int(dispatch.sum())))
        return dispatch, combine, aux
    return route


def compare(cfg, params, tokens, label, record) -> None:
    with torch.no_grad():
        record.clear()
        logits, _ = mm.moe_forward(params, tokens, cfg)
        fwd = list(record)
        record.clear()
        cache = dm.init_kv_cache(cfg.base, 1, tokens.shape[1], device="cuda")
        plain, _ = dm._forward_with_cache(params, tokens, cache, 0, cfg.base,
                                          ffn=mm._moe_decode_ffn(cfg))
        ref = list(record)
    last = ((logits[:, -1] - plain[:, -1]).norm()
            / plain[:, -1].norm()).item()
    every = ((logits - plain).norm() / plain.norm()).item()
    print(label, "rel_last", last, "rel_all", every,
          "tokens_rerouted_per_layer",
          [int((a != b).any(-1).sum()) for (a, _), (b, _) in zip(fwd, ref)],
          "kept_slots_per_layer", [n for _, n in fwd],
          "last_token_rerouted",
          [bool((a[0, -1] != b[0, -1]).any()) for (a, _), (b, _)
           in zip(fwd, ref)], flush=True)


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    record: list = []
    mm.route_tokens = routed(record)
    cfg = width(8)
    params = mm.moe_init(cfg, seed=SEED, device="cuda")
    loose = dataclasses.replace(cfg, capacity_factor=4.0)
    for seed in (7, 1, 2, 3):
        g = torch.Generator(device="cuda").manual_seed(seed)
        tokens = torch.randint(0, cfg.base.vocab_size, (1, 512),
                               generator=g, device="cuda")
        compare(cfg, params, tokens, f"bf16 cf1.25 seed{seed}", record)
        compare(loose, params, tokens, f"bf16 cf4.0 seed{seed}", record)
    del params
    torch.cuda.empty_cache()
    f32 = width(2, "float32")
    params = mm.moe_init(f32, seed=SEED, device="cuda")
    compare(f32, params, tokens, "f32 2 layers cf1.25", record)


if __name__ == "__main__":
    main()
