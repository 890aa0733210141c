#!/usr/bin/env python3
"""Variants of the many-row step's product kernel (``step_gemm_kernel`` in
``icee_tpu_torch/csrc/step_kernels.cuh``) side by side on one NVIDIA GPU.

    python3 scripts/probe_step_gemm.py [VARIANT ...]

Each variant is a copy of ``icee_tpu_torch`` under ``icee_tpu_torch/
_build/probe_gemm/<variant>/`` (ignored by git) whose ``step_kernels.cuh``
is text-edited as ``VARIANTS`` says (``shipped``: no edit; a variant may
edit the wrapper's mirror too), built with the
package's own nvcc flags; a process of its own then times K1 (``scripts/
step_turns.py``'s cases, CUDA events, mean of 20) and profiles one case's
kernels (``chip_smoke.device_time_by_kernel``), and prints the digest of
each case's outputs, which every variant must share (the products' chains
do not change).  For ``shipped`` it also counts the SASS instructions of
each ``step_gemm_kernel`` instance (``cuobjdump -sass``): FFMA against
the rest.  The script exits naming any text a variant no longer finds.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(ROOT, "icee_tpu_torch", "_build", "probe_gemm")
TAG = "PROBE-RESULT "
CASES = ("k1_320_h512", "k1_320_h1024", "k1_320_h2048", "factored_320_h2048",
         "lstm_320_h2048")
STEP = "csrc/step_kernels.cuh"
BOUNDS = """__launch_bounds__(BM * BN / 64,
                                  BM == 128 ? 2 : (BM == 64 && BN == 64) ? 8
                                                                         : 1)"""
UNCAPPED64 = "__launch_bounds__(BM * BN / 64, BM == 128 ? 2 : 1)"
BK16 = [(STEP, "constexpr int GEMM_BK = 8;", "constexpr int GEMM_BK = 16;"),
        ("ops/decode_step.py", "GEMM_BK = 8\n", "GEMM_BK = 16\n")]
# each variant: (file under icee_tpu_torch, text, its replacement)
VARIANTS = {
    "shipped": [],
    # at most 128 registers a thread: 16 warps an SM at every tile shape
    "regs128": [(STEP, BOUNDS, "__launch_bounds__(BM * BN / 64, 512 / (BM * "
                               "BN / 64))")],
    # the 64 x 64 tile with as many registers as it takes (the first
    # version: ~190, five blocks an SM)
    "uncapped64": [(STEP, BOUNDS, UNCAPPED64)],
    # k tiles of 16
    "bk16": BK16,
    # a heavier charge for the k tiles a block copies (fewer, larger tiles)
    "charge32": [(STEP, "(bm * bn + 8 * (bm + bn))", "(bm * bn + 32 * (bm + "
                                                     "bn))"),
                 ("ops/decode_step.py", "(bm * bn + 8 * (bm + bn))",
                  "(bm * bn + 32 * (bm + bn))")],
    # 128 x 64 tiles in place of 64 x 128
    "t128x64": [(STEP, "return cfg == 0 ? 128 : cfg == 3 ? 32 : 64;",
                 "return cfg <= 1 ? 128 : cfg == 3 ? 32 : 64;"),
                (STEP, "return cfg <= 1 ? 128 : 64;",
                 "return cfg == 0 ? 128 : 64;"),
                ("ops/decode_step.py", "GEMM_TILES = ((128, 128), (64, 128),",
                 "GEMM_TILES = ((128, 128), (128, 64),")],
}


def make_copy(name: str) -> str:
    dst = os.path.join(PROBE, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "icee_tpu_torch"),
                    os.path.join(dst, "icee_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = os.path.join(dst, "icee_tpu_torch", rel)
        src = open(path).read()
        if old not in src:
            raise SystemExit(f"{name}: text not found in {rel}: {old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return dst


def sass_counts(lib: str) -> dict:
    """{kernel instance: {"ffma": n, "all": n}} from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if "step_gemm_kernel" in m.group(1) else None
            if cur:
                out[cur] = {"ffma": 0, "all": 0}
            continue
        if cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            out[cur]["all"] += 1
            out[cur]["ffma"] += " FFMA " in line
    return out


def child(dst: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    sys.path.insert(0, ROOT)
    sys.path.insert(0, dst)
    import hashlib

    import torch

    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import cuda_lib
    from step_turns import CASES as ALL, case_call

    paths = cuda_lib.build_all(["decode_step", "att_decode_step"])
    set_float32_precision()
    device = torch.device("cuda", 0)
    out = {"lib": paths["decode_step"], "cases": {}}
    with torch.inference_mode():
        for name in CASES:
            op, hw, n_img, k = ALL[name]
            with cs.widths(H=hw, F=hw):
                decs = cs.decoder_params(device)
                run, _ = case_call(cs, op, decs, n_img, k, 7, device)
                res = run()
                torch.cuda.synchronize()
                d = hashlib.sha256()
                for t in res:
                    d.update(t.cpu().numpy().tobytes())
                rows = cs.device_time_by_kernel(
                    lambda: [run() for _ in range(10)], top=6)
                out["cases"][name] = {
                    "ms": cs.cuda_ms(run, 20, 2),
                    "bits": d.hexdigest()[:16],
                    "kernels": [(r["kernel"][:40], r["ms"] / 10, r["count"]
                                 // 10) for r in rows]}
                del decs
    print(TAG + json.dumps(out), flush=True)


def main(names) -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    results = {}
    for name in names:
        dst = make_copy(name)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", dst], capture_output=True,
                              text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(TAG)]
        if proc.returncode or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            raise SystemExit(f"variant {name} failed")
        res = json.loads(lines[-1][len(TAG):])
        if name == "shipped":
            res["sass"] = sass_counts(res["lib"])
        results[name] = res
        print(f"--- {name}", flush=True)
        for case, r in res["cases"].items():
            print(f"  {case}: {r['ms']:.4f} ms bits {r['bits']}", flush=True)
            for k in r["kernels"]:
                print(f"      {k}", flush=True)
        for fn, c in res.get("sass", {}).items():
            print(f"  sass {fn}: {c}", flush=True)
    bits = {n: {c: r["bits"] for c, r in res["cases"].items()}
            for n, res in results.items()}
    same = len({json.dumps(b, sort_keys=True) for b in bits.values()}) == 1
    print(json.dumps({"device": smi, "same_bits": same, "ms": {
        n: {c: r["ms"] for c, r in res["cases"].items()}
        for n, res in results.items()}}))
    return 0 if same else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:] or list(VARIANTS)))
