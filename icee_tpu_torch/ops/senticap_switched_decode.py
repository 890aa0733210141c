"""K10: the SentiCap switched model's whole beam search for a batch of images.

Port of ``icee_tpu/ops/pallas_senticap_switched_decode.py::
mega_senticap_switched_decode``: the styled decode (senti = +1) of the
switched two-LSTM model in the ``DA_SUM`` test regime, with the switch-gate
trace of every emitted token.  The CUDA kernel is
``csrc/senticap_switched_beam.cu``: one C call lays the four weights out
once as TF32 hi / lo planes (``ops/senticap_decode.py::launch_plan``, both
paths' planes in one buffer), then runs every step (both cells in one
launch, the gates, both heads in one launch, the switch gate, the exact
mixture of the two softmaxes and the per-row top-k by nll with lowest-index
ties in one row pass, per-image candidate selection carrying the trace,
parent gathers, both paths' next-word embeddings) for all images at once.
:func:`mega_senticap_switched_decode_plain` is the same search in plain
PyTorch (``senticap/beam.py::make_device_beam(with_attention=True)``
over ``senticap/switched.py::beam_step``): the CPU tests use it, and
``chip_smoke.py`` holds the kernel against it on the card.

:func:`mega_senticap_switched_decode` takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.  Its
launch count is ``mega_senticap_switched_decode.launches``.  The TPU
kernel's ``n_img_block``, ``v_tile``, ``n_streams`` and ``_profile`` are
schedules of the TPU and not part of the function: they are left out.  The
descriptive decode (senti = -1) needs no kernel of its own: it is the base
model on the background weights, K9 (``ops/senticap_decode.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from icee_tpu_torch.ops import cuda_lib
from icee_tpu_torch.ops.senticap_decode import check_params as check_base
from icee_tpu_torch.ops.senticap_decode import launch_plan, sm_count
from icee_tpu_torch.senticap.config import DA_SUM


def check_params(params: dict, v_feats: torch.Tensor, batch: int,
                 conf: Optional[dict] = None) -> Tuple[int, int, int]:
    """Validate both weight sets, the gate and the features; -> (E, H, V).
    Raises for BATCH_NORM, SOFTMAX_OUT=False and every DOMAIN_ADAPT but
    DA_SUM, which the kernel does not compute."""
    mode = (conf or {}).get("DOMAIN_ADAPT", DA_SUM)
    if mode != DA_SUM:
        raise ValueError(f"mega_senticap_switched_decode: the kernel mixes "
                         f"by DA_SUM, not {mode!r}; other modes run the "
                         f"device beam (senticap/beam.py)")
    e, h, vocab = check_base(params, v_feats, batch, conf)
    vis = params["wvm"].shape[0]
    shapes = {"wemb_sw": (vocab, e), "w_lstm_sw": (e + h, 4 * h),
              "w_sw": (h, vocab), "b_sw": (vocab,), "wvm_sw": (vis, e),
              "bmv_sw": (e,), "att_w": (2 * h, 1), "att_b": (1,)}
    for name, shape in shapes.items():
        cuda_lib.check_tensor(name, params[name], shape, torch.float32,
                              params["w"].device)
    return e, h, vocab


def mega_senticap_switched_decode_plain(
        params: dict, v_feats: torch.Tensor, batch: int, beam_size: int = 20,
        max_len: int = 20, stop_token: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The search K10 runs, as ``make_device_beam(with_attention=True)``
    over the switched model's step at senti = +1 -> (score (B,), tokens (B,
    max_len + 1), length (B,), att_trace (B, max_len + 1))."""
    from icee_tpu_torch.senticap.beam import make_device_beam
    from icee_tpu_torch.senticap.config import senticap_conf
    from icee_tpu_torch.senticap.switched import beam_step

    h = params["w"].shape[0]
    # the kernel's regime: DA_SUM, no dropout at inference; the clip bound
    # acts on gradients only
    conf = senticap_conf(lstm_hidden_size=h)
    run = make_device_beam(beam_step(params, conf, 1.0), 2 * h, beam_size,
                           max_len, stop_token, with_attention=True)
    score, tokens, length, trace = run(v_feats[:batch])
    return score, tokens.to(torch.int32), length.to(torch.int32), trace


def mega_senticap_switched_decode(
        params: dict, v_feats: torch.Tensor, batch: int, beam_size: int = 20,
        max_len: int = 20, stop_token: int = 0, conf: Optional[dict] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-search styled decode of the switched SentiCap model for
    ``batch`` images (DA_SUM mixture, softmax heads, no BATCH_NORM: the
    ``run_load_gap_filler`` test regime).  ``conf``, where given, is checked
    for those regimes.  Returns ``(score (B,), tokens (B, max_len + 1)
    int32, length (B,) int32, att_trace (B, max_len + 1))`` matching
    :func:`mega_senticap_switched_decode_plain`; the trace holds the gate of
    the step that emitted each token, valid through ``length``."""
    e, h, vocab = check_params(params, v_feats, batch, conf)
    if not 1 <= beam_size <= vocab:
        raise ValueError(f"beam_size {beam_size} outside [1, {vocab}]")
    if max_len < 0:
        raise ValueError(f"max_len {max_len} < 0")
    device = params["w"].device
    if device.type == "cpu":
        return mega_senticap_switched_decode_plain(
            params, v_feats, batch, beam_size, max_len, stop_token)
    if device.type != "cuda":
        raise ValueError(f"mega_senticap_switched_decode: unsupported device "
                         f"{device}")
    plan = launch_plan("mega_senticap_switched_decode", batch, beam_size,
                       e, h, vocab, max_len, 2, sm_count(device))
    lib = _library()
    # the two visual pseudo-words (mrnn_switched.py:792-808 via
    # mrnn.py:390-391): products outside the kernel, as the JAX wrapper
    # computes them
    x0 = torch.stack([v_feats @ params["wvm"] + params["bmv"],
                      v_feats @ params["wvm_sw"] + params["bmv_sw"]])
    rows, seq_len = batch * beam_size, max_len + 1
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    scratch = dict(planes=torch.empty((plan.planes_floats(),), **f32),
                   xh=torch.empty((2, rows, e + h), **f32),
                   c=torch.empty((2, rows, h), **f32),
                   z=torch.empty((plan.cell_splits, 2, rows, 4 * h), **f32),
                   hn=torch.empty((2, rows, h), **f32),
                   cn=torch.empty((2, rows, h), **f32),
                   att=torch.empty((rows,), **f32),
                   logits=torch.empty((2, rows, vocab), **f32),
                   top_nll=torch.empty((rows, beam_size), **f32),
                   top_tok=torch.empty((rows, beam_size), **i32),
                   seqs=torch.empty((rows, seq_len), **i32),
                   lp=torch.empty((rows,), **f32),
                   trace=torch.empty((rows, seq_len), **f32))
    tokens = torch.empty((batch, seq_len), **i32)
    length = torch.empty((batch,), **i32)
    score = torch.empty((batch,), **f32)
    att_trace = torch.empty((batch, seq_len), **f32)
    weights = [params[k] for k in ("wemb", "wemb_sw", "w_lstm", "w_lstm_sw",
                                   "w", "w_sw", "b", "b_sw", "att_w",
                                   "att_b")]
    p = cuda_lib.ptr
    c_plan = plan.c_struct()
    rc = lib.icee_senticap_switched_beam(
        ctypes.byref(c_plan), p(x0), *(p(w) for w in weights),
        *(p(scratch[k]) for k in scratch), p(tokens), p(length), p(score),
        p(att_trace), batch, beam_size, e, h, vocab, max_len, stop_token,
        cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "mega_senticap_switched_decode")
    mega_senticap_switched_decode.launches += 1
    return score, tokens, length, att_trace


mega_senticap_switched_decode.launches = 0  # wrapper calls on CUDA tensors


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    return cuda_lib.library("senticap_switched_beam", {
        "icee_senticap_switched_beam": ([vp] * 29 + [i] * 7 + [vp], i)})
