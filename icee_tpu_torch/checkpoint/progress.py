"""Mid-epoch progress records for device-resident training (port of
``icee_tpu/checkpoint/progress.py``).

With ``TrainConfig.progress_chunk > 0`` a device epoch
(``train/loops.py::MultitaskTrainer._run_train_device``) writes a record
after every ``progress_chunk`` batches, so a killed run resumes INSIDE the
epoch with the parameters the uninterrupted run would have had there (the
reference resumes only at epoch boundaries,
``stylenet/train_multitask.py:169-177``).

The record is the JAX package's tree in the port's own format: a
directory ``progress_checkpoint_{data_name}`` holding one ``torch.save``
file written as ``checkpoint/ckpt.py`` writes one (CPU tensors, optimizer
states as plain dicts, loadable with ``weights_only=True``):

- ``epoch`` / ``pass_idx`` / ``row``: where the run was.  ``pass_idx``
  orders the passes of one multitask epoch (0 factual, 1 emotion);
  everything before it in that epoch is complete and in the record.
- ``rng``: the trainer's ``torch.Generator`` state at the record
  (``get_state()``, a CPU byte tensor, also for a CUDA generator).
- ``params`` / ``opt_states``: the training state after ``row`` batches.
- ``losses`` / ``ntoks``: the in-flight pass's per-batch loss and token
  trace so far, (nb,) float64, zero from ``row`` on, so the resumed epoch
  reports the same epoch loss.
- ``epochs_since_improvement`` / ``best_bleu4``: as of the record.

No loader state is stored: ``DeviceCaptionData.epoch_indices`` is
deterministic from its seed and the number of earlier calls, so resume
fast-forwards each train split one call a completed epoch.  The JAX
package's orbax records are not read: such a directory raises.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from icee_tpu_torch.checkpoint.ckpt import CKPT_FILE, _like, _to_saved, _write


def progress_path(folder: str, data_name: str) -> str:
    return os.path.abspath(
        os.path.join(folder, f"progress_checkpoint_{data_name}"))


def _live_path(folder: str, data_name: str) -> Optional[str]:
    """The readable record: the live path, or the ``.old`` survivor when a
    kill landed between :func:`save_progress`'s two renames."""
    path = progress_path(folder, data_name)
    for p in (path, path + ".old"):
        if os.path.isdir(p):
            return p
    return None


def save_progress(folder: str, data_name: str, record: dict) -> str:
    """Crash-atomically replace ``progress_checkpoint_{data_name}``.

    A preemption is likely to land DURING a save, so the previous record
    must survive until the new one is complete: the record is written to
    ``<path>.new`` first, then swapped in with two directory renames (live
    -> ``.old``, new -> live).  A kill at any instant leaves the previous
    record, the ``.old`` survivor (found by :func:`_live_path`), or the new
    record, never nothing."""
    os.makedirs(folder, exist_ok=True)
    path = progress_path(folder, data_name)
    new, old = path + ".new", path + ".old"
    if os.path.isdir(new):
        shutil.rmtree(new)
    _write(new, _to_saved(record))
    if os.path.isdir(old):
        shutil.rmtree(old)
    if os.path.isdir(path):
        os.rename(path, old)
    os.rename(new, path)
    if os.path.isdir(old):
        shutil.rmtree(old)
    return path


def _read(path: str) -> dict:
    file = os.path.join(path, CKPT_FILE)
    if not os.path.isfile(file):
        raise ValueError(
            f"{path} holds no {CKPT_FILE}: not a progress record written by "
            "icee_tpu_torch.checkpoint.progress (the JAX package's orbax "
            "records are not read by the port)")
    return torch.load(file, map_location="cpu", weights_only=True)


def peek_progress(folder: str, data_name: str) -> Optional[dict]:
    """The record as saved (tensors on the CPU, optimizer states as
    dicts), or None when there is none."""
    path = _live_path(folder, data_name)
    return None if path is None else _read(path)


def load_progress(folder: str, data_name: str,
                  template: dict) -> Optional[dict]:
    """The record with its ``params`` and ``opt_states`` shaped as
    ``template``'s (each tensor on its template leaf's device, optimizer
    states back as AdamState, as ``ckpt.load_checkpoint`` does), or None
    when there is none."""
    rec = peek_progress(folder, data_name)
    if rec is None:
        return None
    for key in ("params", "opt_states"):
        rec[key] = _like(rec[key], template[key])
    return rec


def clear_progress(folder: str, data_name: str) -> None:
    """Remove the record and any swap remnants (training finished past it,
    or a stale interrupted save)."""
    path = progress_path(folder, data_name)
    for p in (path, path + ".old", path + ".new"):
        if os.path.isdir(p):
            shutil.rmtree(p)


def make_record(
    epoch: int,
    pass_idx: int,
    row: int,
    rng: torch.Tensor,
    params: dict,
    opt_states: dict,
    losses,
    ntoks,
    epochs_since_improvement: dict,
    best_bleu4: dict,
) -> dict:
    return {
        "epoch": int(epoch),
        "pass_idx": int(pass_idx),
        "row": int(row),
        "rng": rng,
        "params": params,
        "opt_states": opt_states,
        "losses": torch.as_tensor(losses, dtype=torch.float64),
        "ntoks": torch.as_tensor(ntoks, dtype=torch.float64),
        "epochs_since_improvement": {
            k: int(v) for k, v in epochs_since_improvement.items()},
        "best_bleu4": {k: float(v) for k, v in best_bleu4.items()},
    }
