"""A/B of the flash backward kernels 2 (dq) and 3 (dk/dv) of another
checkout against this tree's, at the training shape ([4, 32, 2048, 128]
vs [4, 8, 2048, 128], bf16, causal), in one process: each copy's
``csrc/flash_bwd_{dq,dkv}.cu`` built with ``nvcc`` from a file of its own
name under ``build/ab/`` and swapped into ``kernels._libs``, timed with
``chip_smoke.cuda_ms`` (cold L2) in the order parent, change, change,
parent; outputs compared bit for bit; the tensor-core instances'
registers and spills printed from ``-Xptxas -v``.  Then the card's flash
tests.

    git archive <parent> | tar -x -C build/parent
    PYTHONPATH=. python experiments/torch_bwd_lse_ab.py build/parent
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from kubegpu_tpu_torch import kernels
    from kubegpu_tpu_torch.ops import flash_attention as fa
    before = Path(argv[1] if len(argv) > 1 else "build/parent")
    out_dir = Path("build/ab")
    out_dir.mkdir(parents=True, exist_ok=True)
    logs = kernels.build()
    for name in KERNELS:
        print(name, [(i["name"][:70], i["registers"], i["spill_bytes"])
                     for i in cs.ptxas_instances(logs[name])
                     if "_tc" in i["name"]], flush=True)
    par = {}
    for name in KERNELS:
        src = out_dir / f"{name}_parent.cu"
        shutil.copy(before / "kubegpu_tpu_torch" / "csrc" / f"{name}.cu", src)
        so = out_dir / f"{name}_parent.so"
        r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                            str(kernels.CSRC), "-o", str(so), str(src)],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(r.stdout + r.stderr)
        print(name, "parent", [(i["name"][:70], i["registers"],
                                i["spill_bytes"])
                               for i in cs.ptxas_instances(r.stdout + r.stderr)
                               if "_tc" in i["name"]], flush=True)
        lib = ctypes.CDLL(str(so))
        sym, argtypes = kernels.SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        par[name] = lib
    new = {name: kernels.lib(name) for name in KERNELS}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    b, hq, hkv, t, d = 4, 32, 8, 2048, 128
    q, do = (torch.randn(b, hq, t, d, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, hkv, t, d, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True)
    fns = {"flash_bwd_dq": lambda: (fa._flash_bwd_dq_cuda(*args),),
           "flash_bwd_dkv": lambda: fa._flash_bwd_dkv_cuda(*args)}
    res = {}
    for name, fn in fns.items():
        outs, times = {}, {}
        for label in ("parent", "change", "change", "parent"):
            kernels._libs[name] = par[name] if label == "parent" else new[name]
            outs[label] = fn()
            times.setdefault(label, []).append(cs.cuda_ms(fn))
        kernels._libs[name] = new[name]
        equal = all(torch.equal(x, y)
                    for x, y in zip(outs["parent"], outs["change"]))
        res[name] = {"times": times, "bit_equal": equal}
        print(name, "training shape ms", times, "outputs bit-equal", equal,
              flush=True)
    print(json.dumps(res), flush=True)
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                        "-m", "cuda", "tests/test_torch_cuda.py", "-k",
                        "flash"], capture_output=True, text=True)
    print(r.stdout[-800:], flush=True)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv))
