"""A/B of the design choices in the port's tensor-core flash kernels.

    python experiments/torch_flash_ab.py        # on a machine with an H100

Builds ``kubegpu_tpu_torch/csrc/flash_fwd.cu`` (kernel 1) and
``flash_bwd_dkv.cu`` (kernel 3) as they are, and copies of them with one
choice undone by a text edit, each with ``nvcc`` into ``build/flash_ab/``;
then times every copy's tensor-core instance at the training shape
([4, 32, 2048, 128] vs [4, 8, 2048, 128], bf16, causal; the forward also at
the serving shape [1, 32, 512, 128]) with ``chip_smoke.cuda_ms`` (cold L2),
in the order kernel, variants, kernel, and reports each copy's max |diff|
from the kernel's own output.  For each copy it also counts the branch, convergence-barrier and MUFU opcodes of the
D = 128 instance in ``cuobjdump -sass``.  Variants:

- ``exp2f``: ``exp2f`` (with its range checks) instead of ``ex2.approx``;
- ``branch_per_element``: the causal/ragged mask as a short-circuit test
  on every element of every tile, not one uniform branch a tile with
  selects inside;
- ``no_overlap`` (forward): P.V of tile n - 1 issued and waited for before
  S of tile n, so no softmax overlaps a product;
- ``stages2`` (forward): two K/V stages instead of three.

Prints one line per timing and a JSON summary last.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "kubegpu_tpu_torch" / "csrc"
OUT = ROOT / "build" / "flash_ab"
sys.path.insert(0, str(ROOT))

FWD_MASK = """        if (k0 + BN > S || (causal && k0 + BN - 1 > qbase + off)) {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) {
                const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
                const int qi = qbase + r0 + 8 * ((i >> 1) & 1);
                const bool ok = (key < S) & (!causal | (key <= qi + off));
                sacc[i] = ok ? sacc[i] : NEG_INF;
                mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
            }
        } else {
#pragma unroll
            for (int i = 0; i < BN / 2; ++i)
                mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
        }"""
FWD_MASK_PER_ELEMENT = """        const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > qbase + off);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
            const int qi = qbase + r0 + 8 * ((i >> 1) & 1);
            if (edge && !(key < S && (!causal || key <= qi + off)))
                sacc[i] = NEG_INF;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
        }"""
DKV_MASK = """        if (q0 + BM > Tq || kbase + 64 > S ||
            (causal && kbase + 63 > q0 + off)) {
#pragma unroll
            for (int j = 0; j < BM / 8; ++j) {
                const float2 lv = pair(lse_s, lse, j);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qi = q0 + 8 * j + cq + (e & 1);
                    const int kj = kbase + r0 + 8 * (e >> 1);
                    const bool ok = (qi < Tq) & (kj < S) &
                                    (!causal | (kj <= qi + off));
                    // NEG_INF is finite: mask the probability explicitly
                    const float p = p_of(4 * j + e, (e & 1) ? lv.y : lv.x);
                    sacc[4 * j + e] = ok ? p : 0.f;
                }
            }
        } else {
#pragma unroll
            for (int j = 0; j < BM / 8; ++j) {
                const float2 lv = pair(lse_s, lse, j);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    sacc[4 * j + e] = p_of(4 * j + e, (e & 1) ? lv.y : lv.x);
            }
        }"""
DKV_MASK_PER_ELEMENT = """        const bool edge = q0 + BM > Tq || kbase + 64 > S ||
                          (causal && kbase + 63 > q0 + off);
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
            const float2 lv = pair(lse_s, lse, j);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float p = p_of(4 * j + e, (e & 1) ? lv.y : lv.x);
                if (edge) {
                    const int qi = q0 + 8 * j + cq + (e & 1);
                    const int kj = kbase + r0 + 8 * (e >> 1);
                    if (!(qi < Tq && kj < S && (!causal || kj <= qi + off)))
                        p = 0.f;
                }
                sacc[4 * j + e] = p;
            }
        }"""
FWD_OVERLAP = """            issue_s(n, sacc);
            issue_pv(n - 1);
            wgmma_wait<1>();   // S of tile n has landed"""
FWD_NO_OVERLAP = """            issue_pv(n - 1);
            wgmma_wait<0>();
            issue_s(n, sacc);
            wgmma_wait<0>();"""


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"the source no longer holds the text this variant "
                         f"edits:\n{old[:200]}")
    return src.replace(old, new)


def _exp2f(src: str) -> str:
    tc = src.index("namespace tc {")
    return src[:tc] + src[tc:].replace("exp2_approx(", "exp2f(")


def variants() -> dict[str, dict[str, str]]:
    fwd = (CSRC / "flash_fwd.cu").read_text()
    dkv = (CSRC / "flash_bwd_dkv.cu").read_text()
    return {
        "flash_fwd": {
            "kernel": fwd,
            "exp2f": _exp2f(fwd),
            "branch_per_element": _edit(fwd, FWD_MASK, FWD_MASK_PER_ELEMENT),
            "no_overlap": _edit(fwd, FWD_OVERLAP, FWD_NO_OVERLAP),
            "stages2": _edit(fwd, "constexpr int STAGES = 3;",
                             "constexpr int STAGES = 2;"),
        },
        "flash_bwd_dkv": {
            "kernel": dkv,
            "exp2f": _exp2f(dkv),
            "branch_per_element": _edit(dkv, DKV_MASK, DKV_MASK_PER_ELEMENT),
        },
    }


def build(srcs: dict[str, dict[str, str]]) -> dict[tuple[str, str], Path]:
    from kubegpu_tpu_torch import kernels
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kern, vs in srcs.items():
        for name, src in vs.items():
            cu = OUT / f"{kern}_{name}.cu"
            cu.write_text(src)
            procs[kern, name] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(CSRC), "-o",
                 str(cu.with_suffix(".so")), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    sos = {}
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{out[-3000:]}")
        sos[key] = OUT / f"{key[0]}_{key[1]}.so"
    return sos


def sass_counts(so: Path) -> dict[str, int]:
    """Opcode counts of the D = 128 tensor-core instance in ``so`` (of
    kernel 3, the one that loads lse and delta by TMA)."""
    from kubegpu_tpu_torch import kernels
    cuobjdump = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    ops, inside = Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = ("_tc" in line and "ILi128E" in line
                      and "Lb0E" not in line)
        elif inside:
            m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P[0-9T] )?([A-Z][A-Z0-9_]*)",
                         line)
            if m:
                ops[m.group(1)] += 1
    return {k: ops[k] for k in ("BRA", "BSSY", "BSYNC", "MUFU", "HGMMA")}


def main() -> int:
    import torch

    import chip_smoke as cs
    from kubegpu_tpu_torch.ops import flash_attention as fa
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    srcs = variants()
    sos = build(srcs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    results: dict = {"card": card, "ms": {}, "sass": {}, "max_diff": {}}
    for (kern, name), so in sos.items():
        results["sass"][f"{kern}/{name}"] = sass_counts(so)

    def run_fwd(shape):
        b, hq, hkv, t = shape
        q = torch.randn(b, hq, t, 128, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(b, hkv, t, 128, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        outs = {}
        calls = {}
        for name in srcs["flash_fwd"]:
            lib = ctypes.CDLL(str(sos["flash_fwd", name]))
            fn = lib.kubetpu_flash_fwd
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
                ctypes.c_void_p]
            o = torch.empty_like(q)
            lse = torch.empty(b, hq, t, device="cuda")
            calls[name] = (lambda fn=fn, o=o, lse=lse: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, hq, hkv, t, t, 128, 1, 1, 1, stream))
            if calls[name]() != 0:
                raise SystemExit(f"flash_fwd/{name} launch failed")
            outs[name] = (o, lse)
        return calls, outs

    def run_dkv():
        b, hq, hkv, t = 4, 32, 8, 2048
        q, do = (torch.randn(b, hq, t, 128, generator=g, device="cuda")
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(b, hkv, t, 128, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        calls, outs = {}, {}
        for name in srcs["flash_bwd_dkv"]:
            lib = ctypes.CDLL(str(sos["flash_bwd_dkv", name]))
            fn = lib.kubetpu_flash_bwd_dkv
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
                ctypes.c_void_p]
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            calls[name] = (lambda fn=fn, dk=dk, dv=dv: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, hq, hkv, t, t, 128, 1, 1, 1, stream))
            if calls[name]() != 0:
                raise SystemExit(f"flash_bwd_dkv/{name} launch failed")
            outs[name] = (dk, dv)
        return calls, outs

    cases = [("flash_fwd", "training", lambda: run_fwd((4, 32, 8, 2048))),
             ("flash_fwd", "serving", lambda: run_fwd((1, 32, 8, 512))),
             ("flash_bwd_dkv", "training", run_dkv)]
    for kern, shape, make in cases:
        calls, outs = make()
        torch.cuda.synchronize()
        ref = outs["kernel"]
        for name, got in outs.items():
            results["max_diff"][f"{kern}/{shape}/{name}"] = max(
                cs.max_err(a, r) for a, r in zip(got, ref))
        order = ["kernel", *[n for n in calls if n != "kernel"], "kernel"]
        for name in order:
            ms = cs.cuda_ms(calls[name])
            results["ms"].setdefault(f"{kern}/{shape}/{name}", []).append(ms)
            print(f"{kern} {shape} {name}: {ms:.4f} ms "
                  f"(max |diff| vs kernel "
                  f"{results['max_diff'][f'{kern}/{shape}/{name}']:.3g}; "
                  f"sass {results['sass'][f'{kern}/{name}']})", flush=True)
        del calls, outs
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
