"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips elsewhere.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import importlib

import numpy as np
import pytest
import torch

from kubegpu_tpu_torch import kernels

fa = importlib.import_module("kubegpu_tpu_torch.ops.flash_attention")
pa = importlib.import_module("kubegpu_tpu_torch.ops.paged_attention")

pytestmark = pytest.mark.cuda

# row0: prompt 5 (page 7), decode at 8 with 3 written (page 1); row1:
# prompt 13 with a hole at row-local page 1; row2: empty; row3: prompt 3,
# decode at 8 with 11 written (pages 2 and 9)
PT = np.array([[7, 1, 2, 0], [3, 0, 5, 6], [0, 0, 0, 0], [4, 2, 9, 0]],
              np.int32)
STATE = np.array([[5, 13, 0, 3], [8, 16, 0, 8], [3, 0, 0, 11]], np.int32)


@pytest.fixture
def dev():
    """The card, decided at run time (a CPU host skips)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,causal,t,s", [
    (torch.bfloat16, True, 512, 512),
    (torch.float32, True, 37, 70),
    (torch.float32, False, 64, 40),
])
def test_flash_kernel_matches_plain(dev, dtype, causal, t, s):
    """out within 2e-2 in bf16 (output rounding) and 1e-4 in f32; lse
    within 1e-3 / 1e-4 (f32 sums in another order)."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((1, 8, t, 128), (1, 2, s, 128), (1, 2, s, 128)))
    before = kernels.launches["flash_fwd"]
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    assert kernels.launches["flash_fwd"] == before + 1
    ref = fa.xla_attention(q, k, v, causal=causal)
    ref_lse = fa._xla_lse(q, k, causal, 128 ** -0.5)
    bf16 = dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= (
        2e-2 if bf16 else 1e-4)
    assert (lse - ref_lse).abs().max().item() <= (1e-3 if bf16 else 1e-4)


@pytest.mark.parametrize("dtype,hq", [(torch.bfloat16, 8),
                                      (torch.float32, 32)])
def test_paged_kernel_matches_plain(dev, dtype, hq):
    """GQA 4 in bf16 and 4-position folded queries (G=16) in f32.  o within
    1e-2 in bf16 (the plain version rounds probabilities to bf16 before
    P.V, the kernel does not) and 1e-4 in f32; m within 1e-3; l within
    1e-3 relative."""
    g = torch.Generator(device=dev).manual_seed(0)
    pk, pv = (torch.randn(2, 12, 2, 8, 64, generator=g, device=dev).to(dtype)
              for _ in range(2))
    q = torch.randn(4, hq, 64, generator=g, device=dev).to(dtype)
    t, tpad, d = (torch.from_numpy(x).to(dev) for x in STATE)
    args = (q, pk, pv, torch.from_numpy(PT).to(dev), 1, t, tpad, d)
    (o, m, l), (ro, rm, rl) = (pa.paged_attention(*args),
                               pa.paged_attention_ref(*args))
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert (o - ro).abs().max().item() <= tol
    assert (m - rm).abs().max().item() <= 1e-3
    assert ((l - rl).abs() <= 1e-3 * rl).all()
    assert not o[2].any() and not l[2].any()        # the empty row


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 16), (torch.float32, 80),
                                      (torch.bfloat16, 96),
                                      (torch.float32, 256)])
def test_kernels_take_any_head_dim(dev, dtype, hd):
    """Head dims other than 64/128 run the padded instances of both
    kernels (16 is ``LlamaConfig.tiny()``'s); tolerances as above."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((2, 4, 37, hd), (2, 2, 50, hd), (2, 2, 50, hd)))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    bf16 = dtype == torch.bfloat16
    ref = fa.xla_attention(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= (
        2e-2 if bf16 else 1e-4)
    assert (lse - fa._xla_lse(q, k, True, hd ** -0.5)).abs().max().item() \
        <= (1e-3 if bf16 else 1e-4)
    pk, pv = (torch.randn(2, 12, 2, 8, hd, generator=g, device=dev).to(dtype)
              for _ in range(2))
    qd = torch.randn(4, 8, hd, generator=g, device=dev).to(dtype)
    t, tpad, d = (torch.from_numpy(x).to(dev) for x in STATE)
    args = (qd, pk, pv, torch.from_numpy(PT).to(dev), 1, t, tpad, d)
    (o, m, l), (ro, rm, rl) = (pa.paged_attention(*args),
                               pa.paged_attention_ref(*args))
    assert (o - ro).abs().max().item() <= (1e-2 if bf16 else 1e-4)
    assert (m - rm).abs().max().item() <= 1e-3
    assert ((l - rl).abs() <= 1e-3 * rl).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.randn(1, 4, 16, 128, device=dev)
    k = torch.randn(1, 2, 16, 128, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q[:, :, ::2], k[:, :, ::2], k[:, :, ::2])
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="head_dim"):
        wide = torch.randn(1, 2, 16, 320, device=dev)
        fa.flash_attention(wide, wide, wide)
    pool = torch.zeros(1, 3, 2, 8, 128, device=dev)
    i32 = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q[:, :, 0].contiguous(), pool, pool,
                           torch.zeros(1, 2, dtype=torch.int64, device=dev),
                           0, i32, i32, i32)
