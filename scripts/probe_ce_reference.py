"""What moves the float32 CPU reference of the chunked CE card test
(``tests/test_torch_cuda.py::test_chunked_ce_on_the_card_matches_the_cpu``)?

The test's inputs (6 x 9 rows, H = 16, V = 52) go through the port's
``masked_ce_from_hiddens`` on the CPU in float32 at 1, 2, 4, 8 and the
default number of threads, each three times, and under each of PyTorch's
CPU vector paths (``ATEN_CPU_CAPABILITY``, one child process each); the
loss and every gradient are held against an independent float64
reference (log-softmax and autograd in float64 on the same inputs), and on
a card also the kernel path's, ``CARD_RUNS`` times, with the number of
distinct bit patterns of each output; then ``FRESH_PROCESSES`` fresh
processes each make one CPU pass first thing, as the card test does, and
report each stage's bits.  Prints the CPU's name, the vector path,
the BLAS PyTorch was built with, and one JSON line of the largest
deviation from float64 per run, and whether repeated runs gave the same
bits.  Writes the same JSON to ``chiprun_out/probe_ce_reference.json``.

    python3 scripts/probe_ce_reference.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_RUNS = 200
FRESH_PROCESSES = 40
sys.path.insert(0, ROOT)


def inputs():
    import numpy as np

    rng = np.random.default_rng(2)
    hid = rng.standard_normal((6, 9, 16)).astype(np.float32)
    w = (0.5 * rng.standard_normal((16, 52))).astype(np.float32)
    b = (0.1 * rng.standard_normal((52,))).astype(np.float32)
    tgt = rng.integers(0, 52, (6, 9))
    lens = np.array([9, 0, 3, 8, 5, 9])
    smask = np.array([True, True, False, True, True, True])
    return hid, w, b, tgt, lens, smask


def float64_reference():
    """Loss and grads (hiddens, W, b) in float64 from the same inputs."""
    import torch

    hid, w, b, tgt, lens, smask = inputs()
    th, tw, tb = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (hid, w, b))
    mask = (torch.arange(9)[None, :] < torch.tensor(lens)[:, None]) & \
        torch.tensor(smask)[:, None]
    weights = mask.double() / mask.sum().clamp(min=1)
    logp = torch.log_softmax(th @ tw + tb, dim=-1)
    nll = -logp.gather(-1, torch.tensor(tgt)[..., None])[..., 0]
    loss = (weights * nll).sum()
    loss.backward()
    return [x.detach() for x in (loss, th.grad, tw.grad, tb.grad)]


def port_loss(device: str, t_chunk):
    import torch

    from icee_tpu_torch.ops import chunked_loss

    hid, w, b, tgt, lens, smask = inputs()
    th, tw, tb = (torch.tensor(a, device=device, requires_grad=True)
                  for a in (hid, w, b))
    loss = chunked_loss.masked_ce_from_hiddens(
        th, tw, tb, torch.tensor(tgt, device=device),
        torch.tensor(lens, device=device), torch.tensor(smask, device=device),
        t_chunk)
    loss.backward()
    return [a.detach().cpu() for a in (loss, th.grad, tw.grad, tb.grad)]


def deviation(got, ref) -> list:
    return [float((g.double() - r).abs().max()) for g, r in zip(got, ref)]


def cpu_runs() -> dict:
    """This process's vector path: every thread count, three runs each."""
    import torch

    ref = float64_reference()
    out = {"capability": torch.backends.cpu.get_cpu_capability(),
           "default_threads": torch.get_num_threads(), "runs": {}}
    default = torch.get_num_threads()
    for n in sorted({1, 2, 4, 8, default}):
        torch.set_num_threads(n)
        for t_chunk in (None, 4):
            runs = [port_loss("cpu", t_chunk) for _ in range(3)]
            same = all(all(torch.equal(a, b) for a, b in zip(runs[0], r))
                       for r in runs[1:])
            out["runs"][f"threads={n},t_chunk={t_chunk}"] = {
                "max_abs_vs_float64": deviation(runs[0], ref),
                "loss_bits": runs[0][0].view(torch.int32).item(),
                "same_bits_3_runs": same}
    torch.set_num_threads(default)
    return out


def stages() -> dict:
    """One CPU pass as the card test makes it, first thing in a fresh
    process: the bits of each stage (the logits' product, lse, the
    contributions, the loss) as hex digests."""
    import hashlib

    import torch

    from icee_tpu_torch.ops import chunked_loss

    torch.cuda.is_available()
    hid, w, b, tgt, lens, smask = inputs()
    th, tw, tb = (torch.tensor(a) for a in (hid, w, b))
    x = th.reshape(-1, 16)
    logits = torch.addmm(tb, x, tw)
    mask = (torch.arange(9)[None, :] < torch.tensor(lens)[:, None]) & \
        torch.tensor(smask)[:, None]
    weights = (mask.float() / mask.sum()).reshape(-1)
    lse, contrib = chunked_loss.ce_rows_plain(logits, torch.tensor(
        tgt).reshape(-1), weights)

    def digest(t):
        return hashlib.sha1(t.numpy().tobytes()).hexdigest()[:12]

    return {"logits": digest(logits), "lse": digest(lse),
            "contrib": digest(contrib), "loss": float(contrib.sum()),
            "loss_bits": contrib.sum().view(torch.int32).item(),
            "threads": torch.get_num_threads(), "load": os.getloadavg()}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        print(json.dumps(cpu_runs()))
        return 0
    if len(sys.argv) > 1 and sys.argv[1] == "--stages":
        print(json.dumps(stages()))
        return 0
    import torch

    cpu_name = "unknown"
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    cpu_name = line.split(":", 1)[1].strip()
                    break
    blas = [ln.strip() for ln in torch.__config__.show().splitlines()
            if "BLAS" in ln or "MKL" in ln or "LAPACK" in ln]
    report = {"cpu": cpu_name, "cpu_count": os.cpu_count(),
              "torch": torch.__version__, "blas": blas,
              "this_process": cpu_runs(), "vector_paths": {}}
    for cap in ("default", "avx2", "avx512"):
        env = dict(os.environ, ATEN_CPU_CAPABILITY=cap, PYTHONPATH=ROOT)
        res = subprocess.run([sys.executable, __file__, "--child"],
                             capture_output=True, text=True, env=env,
                             timeout=300)
        report["vector_paths"][cap] = (
            json.loads(res.stdout.strip().splitlines()[-1])
            if res.returncode == 0 else res.stderr[-500:])
    if torch.cuda.is_available():
        from icee_tpu_torch.core.device import set_float32_precision

        set_float32_precision()
        ref = float64_reference()
        report["card"] = {"name": torch.cuda.get_device_name(0),
                          "runs": {}}
        for tc in (None, 4):
            runs = [port_loss("cuda", tc) for _ in range(CARD_RUNS)]
            devs = [deviation(r, ref) for r in runs]
            report["card"]["runs"][str(tc)] = {
                "max_abs_vs_float64": [max(d[i] for d in devs)
                                       for i in range(4)],
                "distinct_bits": [len({r[i].numpy().tobytes()
                                       for r in runs}) for i in range(4)],
                "runs_over_1e-6": sum(max(d) > 1e-6 for d in devs)}
    fresh = []
    for _ in range(FRESH_PROCESSES):
        res = subprocess.run([sys.executable, __file__, "--stages"],
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=ROOT))
        fresh.append(json.loads(res.stdout.strip().splitlines()[-1])
                     if res.returncode == 0 else res.stderr[-300:])
    report["fresh_processes"] = fresh
    line = json.dumps(report)
    print(line)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "probe_ce_reference.json"), "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
