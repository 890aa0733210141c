#!/usr/bin/env python3
"""K3, K4 and K8 (the StyleNet, NIC and SentiCap training scans, forward
and backward), the chunked CE's row passes and the train steps that run
them, for several checkouts in turn on one NVIDIA GPU, so that two
versions are compared on one card.

Run from the repository root on a machine with the card, with the other
version unpacked into a directory that git ignores:

    mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
    python3 scripts/scan_turns.py _archive/parent . . _archive/parent

Options, first: ``--json PATH`` also writes every turn's results to PATH;
``--kernels-only`` leaves out the train steps; ``--same-bits PREFIXES``
(comma-separated, e.g. ``k3_,k8_``) requires the outputs whose names start
with one of them to be the same bits between checkouts too (a change that
leaves those kernels' code as it was).

Each argument is a checkout's root.  Each turn runs in a process of its
own that imports that checkout's ``chip_smoke`` and ``icee_tpu_torch``,
builds the scan and CE libraries into that checkout, and measures:

- ``check_k3``, ``check_k4`` and ``check_k8`` (phases 7 and 12: each
  kernel against its plain version, timed by CUDA events);
- one call of each direction at the main path's shapes (K3 and K4: B 64,
  T 25, E 300, F = H = 512; K8: B 128, T 22, E = H = 512, gclip 5.0) on
  inputs drawn with numpy, its device time by launch group from a
  profiler trace (products, weight planes, recurrence, column sums,
  other), and its outputs, kept for the comparison below;
- the CE's row passes at 1600 rows x V 8192 (phase 8's shape) on a chunk
  drawn with numpy: each pass's device time cold and right after the
  ``addmm`` that writes the chunk (this script's checkout's
  ``chip_smoke.ce_pass_ms``, run on the turn's own package), and its
  outputs;
- the mixture CE's row passes at 1,408 rows x V 8,800, two heads (phase
  15's chunk, drawn with numpy): the forward over both heads and the
  backward (``ce_grad_rows`` with weights -fac over head o), each pass's
  device time cold and right after its ``addmm`` (this script's
  checkout's ``chip_smoke.mixture_pass_ms``), and their outputs;
- ``torch.matmul`` (float32, TF32 off) at each product shape the scans
  launch over all rows: a yardstick for the products alone;
- unless ``--kernels-only``: the StyleNet and NIC factual steps (phase 9),
  the SentiCap base step (phase 13) and the switch step (phase 16).

Turns of one checkout must give the same bits; turns of two checkouts
must agree within phases 7, 8, 12 and 15's tolerances (h and c atol
1e-4, each gradient within 1e-3 of its largest magnitude; the CE's and
the mixture's lse and w * nll atol 1e-4, the mixture's p atol 1e-6, dl
and db within 1e-4 of their largest magnitude).  The script prints each
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
               "library_ms", "max_abs_err", "max_rel_err", "products")
# kernel-name fragments of each launch group, parent and change alike
GROUPS = (("products", ("gemm_kernel", "sb_product_kernel", "tf32x3_")),
          ("planes", ("sb_prepare_kernel",)),
          ("recurrence", ("fwd_step_kernel", "bwd_step_kernel",
                          "scan_fwd_grid_kernel", "scan_bwd_grid_kernel")),
          ("column_sums", ("colsum_kernel",)))
K3_SHAPE = dict(b=64, t=25, e=300, f=512, h=512)
K8_SHAPE = dict(b=128, t=22, e=512, h=512)
CE_SHAPE = dict(rows=1600, h=512, v=8192)
MIX_SHAPE = dict(rows=1408, h=512, v=8800)


def products(k3=K3_SHAPE, k8=K8_SHAPE):
    """(name, form, M, N, K, batch) of every product over all rows that
    K3, K4 (K3's B, T, E, H) and K8 launch; form 'N' a (M, K) b (K, N),
    'T' b given (N, K), 'A' a given (K, M)."""
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
            ("k4_x_Wih", "N", n3, 4 * h, e, 1),
            ("k4_dZ_Wiht", "T", n3, e, 4 * h, 1),
            ("k4_g_Wih", "A", e, 4 * h, n3, 1),
            ("k4_g_Whh", "A", h, 4 * h, n3, 1),
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
    a = np.sqrt(6.0 / (e + 4 * h))
    k4 = {"W_ih": t(rng.uniform(-a, a, (e, 4 * h))),
          "W_hh": t(rng.uniform(-1, 1, (h, 4 * h)) / np.sqrt(h)),
          "b_ih": t(0.1 * rng.standard_normal(4 * h)),
          "b_hh": t(0.1 * rng.standard_normal(4 * h))}
    s = K8_SHAPE
    a = np.sqrt(6.0 / (s["e"] + 5 * s["h"]))
    w = t(rng.uniform(-a, a, (s["e"] + s["h"], 4 * s["h"])))
    k8_x = t(rng.standard_normal((s["b"], s["t"], s["e"])))
    k8_dh = t(rng.standard_normal((s["b"], s["t"], s["h"])))
    return (k3, k3_x, k3_dh), (w, k8_x, k8_dh), k4


def scan_calls(device):
    """One call of each direction of K3, K4 and K8: device ms by launch
    group and the outputs (CPU tensors).  K4 takes K3's x and dh."""
    from icee_tpu_torch.ops import lstm_scan, nic_scan, senticap_scan

    (p, x, dh), (w, x8, dh8), cell = scan_inputs(device)
    h4, c4, g4 = nic_scan.nic_scan_fwd(cell, x)
    dx4, grads4 = nic_scan.nic_scan_bwd(cell, x, h4, c4, dh, g4)
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
            w, x8, h8, c8, dh8, 5.0, gates)),
        "k4_fwd": device_groups(lambda: nic_scan.nic_scan_fwd(cell, x)),
        "k4_bwd": device_groups(lambda: nic_scan.nic_scan_bwd(
            cell, x, h4, c4, dh, g4))}
    outs = {"k3_h": h_seq, "k3_c": c_seq, "k3_dx": dx,
            **{f"k3_d{k}": v for k, v in grads.items()},
            "k8_h": h8, "k8_c": c8, "k8_dx": dx8, "k8_dW": dw8,
            "k4_h": h4, "k4_c": c4, "k4_dx": dx4,
            **{f"k4_d{k}": v for k, v in grads4.items()}}
    return groups, {k: v.cpu() for k, v in outs.items()}


def this_chip_smoke():
    """This script's checkout's ``chip_smoke``, loaded by path under
    another name: its functions import ``icee_tpu_torch`` when called, so
    they run on the turn's own package."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("scan_turns_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ce_calls(device):
    """The CE's row passes on a chunk drawn with numpy (CE_SHAPE): the
    device ms of each pass cold and after the chunk's ``addmm``, and the
    outputs (CPU tensors)."""
    import numpy as np
    import torch

    from icee_tpu_torch.ops import chunked_loss as cl

    s = CE_SHAPE
    rng = np.random.default_rng(17)
    x = torch.tensor((0.5 * rng.standard_normal((s["rows"], s["h"])))
                     .astype(np.float32), device=device)
    w = torch.tensor((rng.standard_normal((s["h"], s["v"])) / 8.0)
                     .astype(np.float32), device=device)
    b = torch.tensor((0.1 * rng.standard_normal(s["v"])).astype(np.float32),
                     device=device)
    tgt = torch.tensor(rng.integers(0, s["v"], s["rows"]), device=device)
    wts = torch.tensor(rng.random(s["rows"]).astype(np.float32),
                       device=device)
    logits = torch.addmm(b, x, w)
    lse, contrib = cl.ce_rows(logits, tgt, wts)
    db = torch.ones((s["v"],), device=device)
    dl = cl.ce_grad_rows(logits.clone(), tgt, wts, lse,
                         torch.ones((1,), device=device), db)
    smoke = this_chip_smoke()
    times = smoke.ce_pass_ms(device, logits, tgt, wts, x, w, b)
    outs = {"ce_lse": lse, "ce_contrib": contrib, "ce_dl": dl, "ce_db": db}
    # the mixture: two heads' chunks, gates U(0.05, 0.95)
    s = MIX_SHAPE
    heads = []
    for _ in range(2):
        heads.append(tuple(torch.tensor(a, device=device) for a in (
            (0.5 * rng.standard_normal((s["rows"], s["h"]))).astype(
                np.float32),
            (rng.standard_normal((s["h"], s["v"])) / 8.0).astype(np.float32),
            (0.1 * rng.standard_normal(s["v"])).astype(np.float32))))
    tgt = torch.tensor(rng.integers(0, s["v"], s["rows"]), device=device)
    co = torch.tensor(rng.uniform(0.05, 0.95, s["rows"]).astype(np.float32),
                      device=device)
    cn = 1.0 - co
    wts = torch.tensor(rng.random(s["rows"]).astype(np.float32),
                       device=device)
    lo, ln = (torch.addmm(b, x, w) for x, w, b in heads)
    rows = cl.mixture_ce_rows(lo, ln, tgt, co, cn, wts)
    one = torch.ones((1,), device=device)
    _, _, fac, _ = cl.mixture_row_cotangents(rows[2], rows[3], co, cn, wts,
                                             one[0])
    neg_fac = (-fac).contiguous()
    db = torch.zeros((s["v"],), device=device)
    dl = cl.ce_grad_rows(lo.clone(), tgt, neg_fac, rows[0], one, db)
    times.update({"mix_" + k: v for k, v in smoke.mixture_pass_ms(
        device, heads[0], heads[1], tgt, co, cn, wts, neg_fac,
        rows[0]).items()})
    outs.update({"mix_" + n: t for n, t in zip(
        ("lse_o", "lse_n", "p_o", "p_n", "contrib"), rows)})
    outs.update(mix_dl=dl, mix_db=db)
    return times, {k: v.cpu() for k, v in outs.items()}


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
               for e in (*cs.check_k3(device), *cs.check_k4(device),
                         *cs.check_k8(device))]
    groups, outs = scan_calls(device)
    ce_times, ce_outs = ce_calls(device)
    torch.save({**outs, **ce_outs}, out_path)
    result = {"root": root, "kernels": kernels, "groups": groups,
              "ce_passes": ce_times,
              "matmul": matmul_yardstick(device, cs.cuda_ms)}
    if with_steps:
        steps = {"stylenet_factual": cs.train_phase(device)[1][
            "factual_step_ms"]}
        steps["nic_factual"] = cs.train_phase(device, factored=False)[1][
            "factual_step_ms"]
        steps["senticap_base"] = cs.train_senticap_phase(device)[1]["step_ms"]
        base = cs.pretrained_base(device)
        steps["senticap_switch"] = cs.train_switched_phase(device, base)[1][
            "step_ms"]
        result["steps"] = steps
    print(TAG + json.dumps(result), flush=True)


def compare(outs, same_root: bool, same_bits=()):
    """Raise unless two turns' outputs are the same bits (one checkout, or
    names starting with one of ``same_bits``) or within phases 7, 8 and
    12's tolerances (two checkouts).  -> the names whose bits are equal."""
    import torch

    a, b = outs
    equal = [k for k in a if torch.equal(a[k], b[k])]
    for k in a:
        if same_root or k.startswith(tuple(same_bits)):
            if not torch.equal(a[k], b[k]):
                raise SystemExit(f"{k}: two turns of one checkout differ")
            continue
        err = (a[k] - b[k]).abs().max().item()
        if k in ("ce_lse", "ce_contrib", "mix_lse_o", "mix_lse_n",
                 "mix_contrib"):
            ok = err <= 1e-4
        elif k in ("mix_p_o", "mix_p_n"):
            ok = err <= 1e-6
        elif k in ("mix_dl", "mix_db"):
            ok = err <= 1e-4 * b[k].abs().max().item()
        elif k in ("ce_dl", "ce_db"):
            ok = err <= 1e-4 * b[k].abs().max().item()
        elif k.endswith(("_h", "_c")):
            ok = err <= 1e-4
        else:
            ok = err <= 1e-3 * b[k].abs().max().item()
        if not ok:
            raise SystemExit(f"{k}: the checkouts differ by {err}")
    return equal


def main(args) -> int:
    json_path, with_steps, same_bits = None, True, ()
    while args[:1] and args[0].startswith("--"):
        if args[0] == "--json":
            json_path, args = args[1], args[2:]
        elif args[0] == "--same-bits":
            same_bits, args = tuple(args[1].split(",")), args[2:]
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
    across = None
    for i in range(1, len(turns)):
        for j in range(i):
            same = os.path.realpath(roots[i]) == os.path.realpath(roots[j])
            equal = compare([torch.load(paths[i]), torch.load(paths[j])],
                            same, same_bits)
            if not same:
                across = set(equal) if across is None else across & set(
                    equal)
    print("outputs: the same bits within a checkout, within the tolerances "
          "between checkouts" + (f" (the same bits for {same_bits})"
                                 if same_bits else ""))
    if across is not None:
        print("the same bits between checkouts: " + ", ".join(
            sorted(across)))
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
    print("CE and mixture CE row pass device ms by turn:")
    for key in turns[0]["ce_passes"]:
        print(f"  {key:28s} " + "  ".join(
            "    none" if t["ce_passes"].get(key) is None
            else f"{t['ce_passes'][key]:8.4f}" for t in turns))
    if with_steps:
        print("train step ms by turn:")
        for step in turns[0]["steps"]:
            print(f"  {step:28s} " + "  ".join(
                f"{t['steps'][step]:8.3f}" for t in turns))
    print(json.dumps({"scan_turns": [
        {"arg": t["arg"], "kernel_ms": {e["name"]: e["ms"]
                                        for e in t["kernels"]},
         "groups": t["groups"], "ce_passes": t["ce_passes"],
         "steps": t.get("steps")} for t in turns]}))
    print(smi)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        turn(sys.argv[2], sys.argv[3], sys.argv[4:5] != ["--kernels-only"])
    else:
        sys.exit(main(sys.argv[1:]))
