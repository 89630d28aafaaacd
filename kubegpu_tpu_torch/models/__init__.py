"""Model families of the port (so far: Llama, its cached decode and the
paged serving engine)."""

from kubegpu_tpu_torch.models.decode import greedy_generate  # noqa: F401
from kubegpu_tpu_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    llama_forward,
    llama_init,
)
from kubegpu_tpu_torch.models.serve import ContinuousBatcher  # noqa: F401
