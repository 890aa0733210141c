#!/usr/bin/env python3
"""Does a profiled K3 backward call lose its recurrence record, or its
launch?  Run on one CUDA card from the repository root:

    python3 scripts/probe_scan_profile.py [--iters 50]

At ``chip_smoke.py`` phase 7's shapes (B = 64, T = 25, E = 300, F = H =
512) it calls K3's backward (``csrc/lstm_scan.cu``) ``--iters`` times in
each of four ways, dh alternating between two inputs so that a call that
ran no recurrence cannot pass on the last call's dZ:

- ``phase7``: ``chip_smoke.scan_device_groups`` on the wrapper, as phase 7
  profiles it (CUDA activity, a marker kernel, a trace that lost records
  taken again), its retries counted;
- ``both``: the entry point called directly under the same profiler;
- ``cuda_only``: the same with CUDA activity alone;
- ``stressed``: ``both`` with 20,000 small kernels in the window first.

For every direct call it reads three witnesses of the recurrence: the
trace's ``scan_bwd_grid_kernel`` records, the library's own count of
cooperative launches (``icee_scan_recurrence_launches``) and the grid
barrier's counter in the workspace (set to a sentinel before the call;
the entry point zeroes it and every block adds one a barrier), and it
holds the grads to those of the first call on the same dh (the kernel is
bit-deterministic).  Prints a JSON summary and writes every call's record
to ``--out`` (JSON).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

B, T, E, F, H = 64, 25, 300, 512, 512
SENTINEL = -1


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--modes", default="both,cuda_only,stressed,phase7",
                    help="comma-separated subset of the four ways")
    ap.add_argument("--out", default="probe_scan_profile.json",
                    help="where every call's record is written")
    args = ap.parse_args()
    wanted = args.modes.split(",")

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import cuda_lib, lstm_scan, scan_grid

    cuda_lib.build_all(["lstm_scan"])
    set_float32_precision()
    dev = torch.device("cuda", 0)
    dec = chip_smoke.training_decoder(dev, 7)
    p = {k: dec[k] for k in lstm_scan.CELL_KEYS}
    p["S_w"], p["S_b"] = dec["S_w"][1], dec["S_b"][1]
    g = torch.Generator(device=dev).manual_seed(8)
    x = 0.5 * torch.randn((B, T, E), generator=g, device=dev)
    dhs = [0.02 * torch.randn((B, T, H), generator=g, device=dev)
           for _ in range(2)]
    h_seq, c_seq, saved = lstm_scan.factored_scan_fwd(p, x)
    lib = lstm_scan._library()
    plan = scan_grid.plan_on(lstm_scan.WHAT, B, H, dev)
    cplan, ws = lstm_scan._workspace(lib, plan, B, T, E, F, H, 1, dev)
    count_word = ws.view(torch.int32)[ws.numel() - 16:ws.numel() - 15]
    f32 = dict(dtype=torch.float32, device=dev)
    h_prev = lstm_scan._shift(h_seq)
    n = B * T
    v, s, gates = saved

    def direct(dh):
        """factored_scan_bwd's body with the workspace kept here."""
        dx = torch.empty((B, T, E), **f32)
        grads = {k: torch.empty(tuple(p[k].shape), **f32)
                 for k in lstm_scan.CELL_KEYS}
        scratch = [torch.empty(sh, **f32) for sh in
                   ((n, 4 * H), (n, 4 * F), (n, 4 * F))]
        ptr = cuda_lib.ptr
        rc = lib.icee_lstm_scan_bwd(
            ctypes.byref(cplan), ptr(x), ptr(p["V_w"]), ptr(p["S_w"]),
            ptr(p["U_w"]), ptr(p["W_w"]), ptr(h_prev), ptr(c_seq), ptr(v), ptr(s),
            ptr(gates), ptr(dh), ptr(dx),
            *(ptr(grads[k]) for k in lstm_scan.CELL_KEYS),
            *(ptr(t) for t in scratch), ptr(ws), ws.numel(), B, T, E, F, H,
            cuda_lib.stream_ptr(dev))
        cuda_lib.check_rc(lib, rc, "icee_lstm_scan_bwd")
        return dx, grads

    want = [direct(dh) for dh in dhs]
    torch.cuda.synchronize()
    barrier_want = int(count_word.item())
    junk = torch.zeros(16, device=dev)

    def traced(dh, activities, stress):
        count_word.fill_(SENTINEL)
        before = lib.icee_scan_recurrence_launches()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(stress):
                junk.add_(1.0)
            out = direct(dh)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation
                  and e.self_device_time_total > 0]
        rec = sum("scan_bwd_grid_kernel" in e.name for e in events)
        return out, {
            "trace_recurrence": rec,
            "trace_device_events": len(events),
            "trace_all_events": len(prof.events()),
            "library_launches": lib.icee_scan_recurrence_launches() - before,
            "barrier_count": int(count_word.item()),
        }

    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    modes = {"both": (both, 0), "cuda_only": ([ProfilerActivity.CUDA], 0),
             "stressed": (both, 20000)}
    modes = {k: v for k, v in modes.items() if k in wanted}
    records = {m: [] for m in modes}
    for it in range(args.iters):
        for mode, (acts, stress) in modes.items():
            k = it % 2
            (dx, grads), rec = traced(dhs[k], acts, stress)
            rec["outputs_equal"] = bool(
                torch.equal(dx, want[k][0]) and all(
                    torch.equal(grads[key], want[k][1][key])
                    for key in grads))
            records[mode].append(rec)

    # phase 7's own check on the wrapper, its fail() recorded, not fatal
    failures = []
    chip_smoke.fail = failures.append
    records["phase7"] = []
    for it in range(args.iters if "phase7" in wanted else 0):
        before = lib.icee_scan_recurrence_launches()
        groups = chip_smoke.scan_device_groups(
            "K3 backward", lambda: lstm_scan.factored_scan_bwd(
                p, x, h_seq, c_seq, dhs[it % 2], saved), lstm_scan)
        records["phase7"].append({
            "trace_recurrence": None if groups is None
            else groups["launches"]["recurrence_ms"],
            "trace_retries": None if groups is None
            else groups["trace_retries"],
            "library_launches": lib.icee_scan_recurrence_launches() - before,
            "failed": len(failures)})

    summary = {"barrier_count_expected": barrier_want,
               "device": torch.cuda.get_device_name(0)}
    for mode, recs in records.items():
        summary[mode] = {
            "calls": len(recs),
            "trace_recurrence_not_1": sum(r["trace_recurrence"] != 1
                                          for r in recs),
            "library_launches_not_1": sum(
                r["library_launches"] != 1 + (r.get("trace_retries") or 0)
                for r in recs),
        }
        if mode != "phase7":
            summary[mode].update(
                barrier_count_wrong=sum(r["barrier_count"] != barrier_want
                                        for r in recs),
                outputs_differ=sum(not r["outputs_equal"] for r in recs),
                device_events=sorted({r["trace_device_events"]
                                      for r in recs}))
    if not records["phase7"]:
        del summary["phase7"]
        records.pop("phase7")
    else:
        summary["phase7"]["fail_messages"] = failures[:5]
        retries = [r["trace_retries"] for r in records["phase7"]
                   if r["trace_retries"] is not None]
        summary["phase7"].update(calls_retried=sum(n > 0 for n in retries),
                                 most_retries=max(retries, default=None))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "records": records}, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
