"""Model families of the port (so far: Llama, its cached decode, the dense
and paged serving engines and the replica pools over them; the MoE family
on the same decode and engines, and its training; the T5 encoder-decoder
with its paged decode; int8 weights for all three in ``quant``; LoRA
adapters over Llama and MoE; ViT and ResNet)."""

from kubegpu_tpu_torch.models.decode import (  # noqa: F401
    beam_generate,
    beam_generate_paged,
    decode_step,
    draft_view,
    generate,
    greedy_generate,
    init_kv_cache,
    prefill,
    sample_generate,
    spec_acceptance,
    spec_generate,
)
from kubegpu_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    llama_forward,
    llama_init,
)
from kubegpu_tpu_torch.models.lora import (  # noqa: F401
    LoRAConfig,
    lora_init,
    lora_merge,
    lora_n_params,
    make_lora_train_step,
)
from kubegpu_tpu_torch.models.moe import (  # noqa: F401
    MoEConfig,
    make_moe_train_step,
    moe_decode_step,
    moe_forward,
    moe_greedy_generate,
    moe_init,
    moe_next_token_loss,
    moe_prefill,
    route_tokens,
)
from kubegpu_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    make_resnet_train_step,
    resnet50,
    resnet_tiny,
)
from kubegpu_tpu_torch.models.serve import (  # noqa: F401
    ContinuousBatcher,
    DataParallelServePool,
    DisaggServePool,
    make_serve_mesh,
)
from kubegpu_tpu_torch.models.t5 import (  # noqa: F401
    T5Config,
    make_t5_train_step,
    t5_forward,
    t5_greedy_generate,
    t5_greedy_generate_paged,
    t5_init,
)
from kubegpu_tpu_torch.models.vit import (  # noqa: F401
    ViTConfig,
    make_vit_train_step,
    vit_forward,
    vit_init,
    vit_loss,
)
