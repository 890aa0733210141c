#!/usr/bin/env python3
"""K3 and K8 (the StyleNet and SentiCap training scans, forward and
backward) and the train steps that run them, for several checkouts in turn
on one NVIDIA GPU, so that two versions are compared on one card.

Run from the repository root on a machine with the card, with the other
version unpacked into a directory that git ignores:

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/scan_turns.py _archive/parent . . _archive/parent

Options, first: ``--json PATH`` also writes every turn's results to PATH;
``--kernels-only`` leaves out the train steps.

Each argument is a checkout's root.  Each turn runs in a process of its
own that imports that checkout's ``chip_smoke`` and ``icee_tpu_torch``,
builds the scan and CE libraries into that checkout, and measures:

- ``check_k3`` and ``check_k8`` (phases 7 and 12: each kernel against its
  plain version, timed by CUDA events);
- one call of each direction at the main path's shapes (K3: B 64, T 25,
  E 300, F = H = 512; K8: B 128, T 22, E = H = 512, gclip 5.0) on inputs
  drawn with numpy, its device time by launch group from a profiler trace
  (products, weight planes, recurrence, column sums, other), and its
  outputs, kept for the comparison below;
- ``torch.matmul`` (float32, TF32 off) at each product shape the scans
  launch over all rows: a yardstick for the products alone;
- unless ``--kernels-only``: the StyleNet factual step (phase 9), the
  SentiCap base step (phase 13) and the switch step (phase 16).

Turns of one checkout must give the same bits; turns of two checkouts
must agree within phases 7 and 12's tolerances (h and c atol 1e-4, each
gradient within 1e-3 of its largest magnitude).  The script prints each
turn's log, then tables of kernel, group and step times by turn and a JSON
line of them.  Any failed phase or comparison fails the script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

TAG = "TURN-RESULT "
KERNEL_KEYS = ("name", "ms", "plain_ms", "bound_ms", "bound_tf32x3_ms",
               "max_abs_err", "max_rel_err", "products")
# kernel-name fragments of each launch group, parent and change alike
GROUPS = (("products", ("gemm_kernel", "sb_product_kernel", "tf32x3_")),
          ("planes", ("sb_prepare_kernel",)),
          ("recurrence", ("fwd_step_kernel", "bwd_step_kernel",
                          "scan_fwd_grid_kernel", "scan_bwd_grid_kernel")),
          ("column_sums", ("colsum_kernel",)))
K3_SHAPE = dict(b=64, t=25, e=300, f=512, h=512)
K8_SHAPE = dict(b=128, t=22, e=512, h=512)


def products(k3=K3_SHAPE, k8=K8_SHAPE):
    """(name, form, M, N, K, batch) of every product over all rows that
    K3 and K8 launch; form 'N' a (M, K) b (K, N), 'T' b given (N, K), 'A'
    a given (K, M)."""
    n3, n8 = k3["b"] * k3["t"], k8["b"] * k8["t"]
    e, f, h = k3["e"], k3["f"], k3["h"]
    e8, h8 = k8["e"], k8["h"]
    return [("k3_x_Vw", "N", n3, 4 * f, e, 1),
            ("k3_v_S", "N", n3, f, f, 4),
            ("k3_s_U", "N", n3, h, f, 4),
            ("k3_dz_Ut", "T", n3, f, h, 4),
            ("k3_ds_St", "T", n3, f, f, 4),
            ("k3_dv_Vwt", "T", n3, e, 4 * f, 1),
            ("k3_g_Ww", "A", h, 4 * h, n3, 1),
            ("k3_g_U", "A", f, h, n3, 4),
            ("k3_g_S", "A", f, f, n3, 4),
            ("k3_g_Vw", "A", e, 4 * f, n3, 1),
            ("k8_x_Wx", "N", n8, 4 * h8, e8, 1),
            ("k8_dZ_Wxt", "T", n8, e8, 4 * h8, 1),
            ("k8_g_Wx", "A", e8, 4 * h8, n8, 1),
            ("k8_g_Wh", "A", h8, 4 * h8, n8, 1)]


def device_groups(fn):
    """Device ms of one call of ``fn`` by launch group (GROUPS, then
    "other"), with each group's launches; None where the profiler trace
    holds no device time.  (``chip_smoke.scan_device_groups`` fails on the
    parent's kernels, so the turns group them here.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.self_device_time_total > 0]
    if not events:
        return None
    out = {g: 0.0 for g, _ in GROUPS}
    out["other"] = 0.0
    launches = {g: 0 for g in out}
    for e in events:
        key = next((g for g, frags in GROUPS
                    if any(f in e.name for f in frags)), "other")
        out[key] += e.self_device_time_total / 1e3
        launches[key] += 1
    out["total"] = sum(e.self_device_time_total for e in events) / 1e3
    out["launches"] = launches
    out["gemm_f32_launches"] = sum("gemm_kernel" in e.name for e in events)
    return out


def scan_inputs(device):
    """Seeded (numpy) inputs of both scans at the main path's shapes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(13)

    def t(a):
        return torch.tensor(a.astype(np.float32), device=device)

    s = K3_SHAPE
    e, f, h = s["e"], s["f"], s["h"]
    k3 = {"V_w": t(rng.uniform(-1, 1, (e, 4 * f)) / np.sqrt(e)),
          "V_b": t(0.1 * rng.standard_normal((4, f))),
          "S_w": t(rng.uniform(-1, 1, (4, f, f)) / np.sqrt(f)),
          "S_b": t(0.1 * rng.standard_normal((4, f))),
          "U_w": t(rng.uniform(-1, 1, (4, f, h)) / np.sqrt(f)),
          "U_b": t(0.1 * rng.standard_normal((4, h))),
          "W_w": t(rng.uniform(-1, 1, (h, 4 * h)) / np.sqrt(h)),
          "W_b": t(0.1 * rng.standard_normal((4, h)))}
    k3_x = t(0.5 * rng.standard_normal((s["b"], s["t"], e)))
    k3_dh = t(0.02 * rng.standard_normal((s["b"], s["t"], h)))
    s = K8_SHAPE
    a = np.sqrt(6.0 / (s["e"] + 5 * s["h"]))
    w = t(rng.uniform(-a, a, (s["e"] + s["h"], 4 * s["h"])))
    k8_x = t(rng.standard_normal((s["b"], s["t"], s["e"])))
    k8_dh = t(rng.standard_normal((s["b"], s["t"], s["h"])))
    return (k3, k3_x, k3_dh), (w, k8_x, k8_dh)


def scan_calls(device):
    """One call of each direction of K3 and K8: device ms by launch group
    and the outputs (CPU tensors)."""
    import torch

    from icee_tpu_torch.ops import lstm_scan, senticap_scan

    (p, x, dh), (w, x8, dh8) = scan_inputs(device)
    h_seq, c_seq, saved = lstm_scan.factored_scan_fwd(p, x)
    dx, grads = lstm_scan.factored_scan_bwd(p, x, h_seq, c_seq, dh, saved)
    h8, c8, gates = senticap_scan.senticap_scan_fwd(w, x8)
    dx8, dw8 = senticap_scan.senticap_scan_bwd(w, x8, h8, c8, dh8, 5.0,
                                               gates)
    groups = {
        "k3_fwd": device_groups(lambda: lstm_scan.factored_scan_fwd(p, x)),
        "k3_bwd": device_groups(lambda: lstm_scan.factored_scan_bwd(
            p, x, h_seq, c_seq, dh, saved)),
        "k8_fwd": device_groups(lambda: senticap_scan.senticap_scan_fwd(
            w, x8)),
        "k8_bwd": device_groups(lambda: senticap_scan.senticap_scan_bwd(
            w, x8, h8, c8, dh8, 5.0, gates))}
    outs = {"k3_h": h_seq, "k3_c": c_seq, "k3_dx": dx,
            **{f"k3_d{k}": v for k, v in grads.items()},
            "k8_h": h8, "k8_c": c8, "k8_dx": dx8, "k8_dW": dw8}
    return groups, {k: v.cpu() for k, v in outs.items()}


def matmul_yardstick(device, cuda_ms):
    """torch.matmul's device ms (CUDA events) and TFLOP/s at each product
    shape, float32 with TF32 off."""
    import torch

    out = {}
    g = torch.Generator(device=device).manual_seed(5)
    for name, form, m, n, k, batch in products():
        lead = (batch,) if batch > 1 else ()
        a = torch.randn(lead + ((k, m) if form == "A" else (m, k)),
                        generator=g, device=device)
        b = torch.randn(lead + ((n, k) if form == "T" else (k, n)),
                        generator=g, device=device)
        aa = a.transpose(-1, -2) if form == "A" else a
        bb = b.transpose(-1, -2) if form == "T" else b
        ms = cuda_ms(lambda: torch.matmul(aa, bb), 20, warmup=3)
        out[name] = {"ms": ms, "tflops": 2.0 * m * n * k * batch / ms / 1e9}
    return out


def turn(root: str, out_path: str, with_steps: bool) -> None:
    """One checkout's measurements; prints TAG + JSON as its last line and
    saves the scans' outputs to ``out_path``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from icee_tpu_torch.core.device import set_float32_precision
    from icee_tpu_torch.ops import cuda_lib

    if not torch.cuda.is_available():
        raise SystemExit("scan_turns: CUDA is not available")
    cuda_lib.build_all(["lstm_scan", "senticap_scan", "chunked_ce",
                        "nic_scan"])
    set_float32_precision()
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    kernels = [{k: e[k] for k in KERNEL_KEYS if k in e}
               for e in (*cs.check_k3(device), *cs.check_k8(device))]
    groups, outs = scan_calls(device)
    torch.save(outs, out_path)
    result = {"root": root, "kernels": kernels, "groups": groups,
              "matmul": matmul_yardstick(device, cs.cuda_ms)}
    if with_steps:
        steps = {"stylenet_factual": cs.train_phase(device)[1][
            "factual_step_ms"]}
        steps["senticap_base"] = cs.train_senticap_phase(device)[1]["step_ms"]
        base = cs.pretrained_base(device)
        steps["senticap_switch"] = cs.train_switched_phase(device, base)[1][
            "step_ms"]
        result["steps"] = steps
    print(TAG + json.dumps(result), flush=True)


def compare(outs, same_root: bool):
    """Raise unless two turns' outputs are the same bits (one checkout)
    or within phases 7 and 12's tolerances (two checkouts)."""
    import torch

    a, b = outs
    for k in a:
        if same_root:
            if not torch.equal(a[k], b[k]):
                raise SystemExit(f"{k}: two turns of one checkout differ")
            continue
        err = (a[k] - b[k]).abs().max().item()
        if k.endswith(("_h", "_c")):
            ok = err <= 1e-4
        else:
            ok = err <= 1e-3 * b[k].abs().max().item()
        if not ok:
            raise SystemExit(f"{k}: the checkouts differ by {err}")


def main(args) -> int:
    json_path, with_steps = None, True
    while args[:1] and args[0].startswith("--"):
        if args[0] == "--json":
            json_path, args = args[1], args[2:]
        elif args[0] == "--kernels-only":
            with_steps, args = False, args[1:]
        else:
            raise SystemExit(f"unknown option {args[0]}")
    roots = args
    if not roots:
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    import torch

    tmp = tempfile.mkdtemp(prefix="scan_turns_")
    turns, paths = [], []
    for i, root in enumerate(roots):
        path = os.path.join(tmp, f"turn{i}.pt")
        cmd = [sys.executable, os.path.abspath(__file__), "--turn", root,
               path] + ([] if with_steps else ["--kernels-only"])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines = proc.stdout.splitlines()
        print(f"--- turn {i}: {root} (exit {proc.returncode})", flush=True)
        for line in lines:
            if not line.startswith(TAG):
                print(f"  {line}", flush=True)
        if proc.returncode != 0 or not lines or not lines[-1].startswith(TAG):
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turn {i} ({root}) failed")
        turns.append(dict(json.loads(lines[-1][len(TAG):]), turn=i,
                          arg=root))
        paths.append(path)
    for i in range(1, len(turns)):
        for j in range(i):
            same = os.path.realpath(roots[i]) == os.path.realpath(roots[j])
            compare([torch.load(paths[i]), torch.load(paths[j])], same)
    print("outputs: the same bits within a checkout, within the tolerances "
          "between checkouts")
    if json_path:
        with open(json_path, "w") as f:
            json.dump({"device": smi, "turns": turns}, f, indent=1)
    print("kernel ms by turn (" + ", ".join(roots) + "):")
    for j, entry in enumerate(turns[0]["kernels"]):
        print(f"  {entry['name']:28s} " + "  ".join(
            f"{t['kernels'][j]['ms']:8.3f}" for t in turns))
    print("one call's device ms by launch group, by turn:")
    for call in turns[0]["groups"]:
        for g in [g for g, _ in GROUPS] + ["other", "total"]:
            vals = [t["groups"][call] and t["groups"][call][g]
                    for t in turns]
            print(f"  {call} {g:12s} " + "  ".join(
                "    none" if v is None else f"{v:8.3f}" for v in vals))
    if with_steps:
        print("train step ms by turn:")
        for step in turns[0]["steps"]:
            print(f"  {step:28s} " + "  ".join(
                f"{t['steps'][step]:8.3f}" for t in turns))
    print(json.dumps({"scan_turns": [
        {"arg": t["arg"], "kernel_ms": {e["name"]: e["ms"]
                                        for e in t["kernels"]},
         "groups": t["groups"], "steps": t.get("steps")} for t in turns]}))
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        turn(sys.argv[2], sys.argv[3], sys.argv[4:5] != ["--kernels-only"])
    else:
        sys.exit(main(sys.argv[1:]))
