#!/usr/bin/env python3
"""Probe of the chunked CE's row passes (``icee_tpu_torch/csrc/chunked_ce.cu``:
the forward ``ce_rows_kernel``, one warp a row reading it once; the
backward ``ce_grad_rows_kernel`` over (column slab x row group) blocks and
``ce_colsum_groups_kernel``) on one NVIDIA GPU: how their time moves with
the launch geometry.

Run from the repository root on a machine with the card:

    python3 scripts/probe_ce_rows.py [variant ...]

Builds variants of the source into ``icee_tpu_torch/_build/probe_ce/``
(ignored by git), each a few text edits of the shipped source (``EDITS``),
compiled with the package's own nvcc flags, all at once:

- ``shipped``: the source as it is (the constants CER_* and CEG_*);
- ``fwd_unroll4`` / ``fwd_unroll16``: 4 or 16 loads a lane a chunk;
- ``fwd_rows2`` / ``fwd_rows8``: 2 or 8 rows a forward block;
- ``bwd_rows32`` / ``bwd_rows128``: row groups of 32 or 128 rows (twice
  or half as many partial rows for the second launch);
- ``bwd_unroll4``: 4 rows' loads a thread in flight;
- diagnostics, unchecked (``UNCHECKED``): ``fwd_no_exp`` and
  ``bwd_no_exp`` sum (or write) l - ref in place of its exp: the passes
  without their exponentials.

For each variant and each shape of the main path (1,600 and 2,112 rows x
V 8,192; 2,048 x 8,800) it checks both passes against their plain versions
(lse atol 1e-4, dl and db within 1e-4 of their largest magnitude) and
prints each pass's device time cold (after writing 100 MB) and right after
the ``addmm`` that writes the chunk (``chip_smoke.ce_pass_ms``: the passes'
own kernels in a profiler trace), beside the byte bound at 3.35 TB/s.
Nothing here is used by the package.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE = os.path.join(ROOT, "icee_tpu_torch", "_build", "probe_ce")
CSRC = os.path.join(ROOT, "icee_tpu_torch", "csrc")

# variant -> the (shipped text, replacement) edits that make it
EDITS = {
    "shipped": [],
    "fwd_unroll4": [("constexpr int CER_UNROLL = 8;",
                     "constexpr int CER_UNROLL = 4;")],
    "fwd_unroll16": [("constexpr int CER_UNROLL = 8;",
                      "constexpr int CER_UNROLL = 16;")],
    "fwd_rows2": [("constexpr int CER_ROWS = 4;",
                   "constexpr int CER_ROWS = 2;")],
    "fwd_rows8": [("constexpr int CER_ROWS = 4;",
                   "constexpr int CER_ROWS = 8;")],
    "fwd_no_exp": [("float e = expf(v[u][0] - ref);",
                    "float e = (v[u][0] - ref);"),
                   ("e = e + expf(v[u][k] - ref);",
                    "e = e + (v[u][k] - ref);")],
    "bwd_rows32": [("constexpr int CEG_ROWS = 64;",
                    "constexpr int CEG_ROWS = 32;")],
    "bwd_rows128": [("constexpr int CEG_ROWS = 64;",
                     "constexpr int CEG_ROWS = 128;")],
    "bwd_unroll4": [("constexpr int CEG_UNROLL = 8;",
                     "constexpr int CEG_UNROLL = 4;")],
    "bwd_no_exp": [("v[u][k] = (expf(v[u][k] - L) -",
                    "v[u][k] = ((v[u][k] - L) -")],
}
# diagnostics: their results are wrong by design, so they go unchecked
UNCHECKED = ("fwd_no_exp", "bwd_no_exp")
SHAPES = ((1600, 8192), (2112, 8192), (2048, 8800))


def build(variants):
    """nvcc every variant at once -> {variant: library path}."""
    from icee_tpu_torch.ops import cuda_lib

    with open(os.path.join(CSRC, "chunked_ce.cu")) as f:
        src = f.read()
    procs = {}
    for v in variants:
        text = src
        for old, new in EDITS[v]:
            if old not in text:
                raise SystemExit(f"{v}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        d = os.path.join(PROBE, v)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "chunked_ce.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(d, "libchunked_ce.so")
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", CSRC, "-o",
               lib, path]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), lib)
    out = {}
    for v, (proc, lib) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {v}:\n{log}")
        out[v] = lib
    return out


def use(path):
    """Make ``chunked_loss``'s wrappers call the library at ``path``."""
    from icee_tpu_torch.ops import chunked_loss, cuda_lib

    declared = {}

    def grab(name, signatures):
        declared.update(signatures)
        raise LookupError

    real = cuda_lib.library
    cuda_lib.library = grab
    try:
        chunked_loss._library()
    except LookupError:
        pass
    finally:
        cuda_lib.library = real
    lib = ctypes.CDLL(path)
    declared["icee_error_string"] = ([ctypes.c_int], ctypes.c_char_p)
    for fn, (argtypes, restype) in declared.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    cuda_lib._libs["chunked_ce"] = lib


def main(args) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import chunked_loss as cl

    if not torch.cuda.is_available():
        raise SystemExit("probe_ce_rows: CUDA is not available")
    variants = args or list(EDITS)
    for v in variants:
        if v not in EDITS:
            raise SystemExit(f"unknown variant {v}; known: {list(EDITS)}")
    set_float32_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    libs = build(variants)
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    h = 512
    inputs = {}
    for r, v in SHAPES:
        x = torch.tensor((0.5 * rng.standard_normal((r, h))).astype(
            np.float32), device=device)
        w = torch.tensor((rng.standard_normal((h, v)) / 8.0).astype(
            np.float32), device=device)
        b = torch.tensor((0.1 * rng.standard_normal(v)).astype(np.float32),
                         device=device)
        tgt = torch.tensor(rng.integers(0, v, r), device=device)
        wts = torch.tensor(rng.random(r).astype(np.float32), device=device)
        inputs[(r, v)] = (x, w, b, tgt, wts, torch.addmm(b, x, w))
    results = {}
    for name in variants:
        use(libs[name])
        results[name] = {}
        for (r, v), (x, w, b, tgt, wts, logits) in inputs.items():
            lse, contrib = cl.ce_rows(logits, tgt, wts)
            want_lse, want_c = cl.ce_rows_plain(logits, tgt, wts)
            db = torch.zeros((v,), device=device)
            dl = cl.ce_grad_rows(logits.clone(), tgt, wts, lse,
                                 torch.ones((1,), device=device), db)
            want_dl, want_db = cl.ce_grad_rows_plain(
                logits, tgt, wts, lse, torch.ones((), device=device))
            errs = [(lse - want_lse).abs().max().item(),
                    (contrib - want_c).abs().max().item(),
                    cs.max_rel_err(dl, want_dl), cs.max_rel_err(db, want_db)]
            if name not in UNCHECKED and not max(errs) <= 1e-4:
                raise SystemExit(f"{name} at {r} x {v}: errors {errs}")
            times = cs.ce_pass_ms(device, logits, tgt, wts, x, w, b)
            times["fwd_bound_ms"] = 4.0 * (r * v + 4 * r) / 3.35e9
            times["bwd_bound_ms"] = 4.0 * (2 * r * v + 3 * r + v) / 3.35e9
            results[name][f"{r}x{v}"] = times
            print(f"{name:13s} {r:5d} x {v}: " + ", ".join(
                f"{k} {t:.4f}" for k, t in times.items()), flush=True)
    print(json.dumps({"probe_ce_rows": results, "device": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
