"""K6: one attention beam step with an exact top-k over the vocabulary, for
StyleNet+Att (``kind="factored"``) and NIC+Att (``kind="lstm"``).

Port of ``icee_tpu/ops/pallas_att_decode.py::fused_att_decode_step_topk``.
The CUDA kernel is ``csrc/att_decode_step.cu`` with two paths, chosen by
the shape alone and giving the same bits for a row:

* column-split (one image, k <= 8 rows: the serial serving path;
  ``csrc/split_step.cuh``): pre (every product of h and of the embedding),
  scores, context, then the cell's and the head's launches, each product's
  columns spread over the whole card and chained by programmatic dependent
  launch;
* row-tiled (several images, the batched shapes): an attention launch (one
  block per image) writes x = [emb; gate * ctx], then K1's cell, head and
  merge launches run with input width E + FS (the cell a template over the
  weight set).

:func:`att_decode_step_topk_plain` is the same function in
plain PyTorch: the CPU tests use it, and ``chip_smoke.py`` holds the kernel
against it on the card.

Also here, :func:`att_init_state`: the search's h0/c0 from the mean spatial
feature, on the card by K7's own mean and init stages run alone over the
whole card (``csrc/att_beam.cu``, :func:`~icee_tpu_torch.ops.att_beam.
init_state`), so the fused-step path (K6 per step) starts from K7's bits;
its plain version is
:func:`~icee_tpu_torch.models.attention.init_hidden_state`.

Both wrappers take the plain version only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.  Launch counts:
``att_decode_step_topk.launches`` (factored, either path),
``.lstm_launches``, per path ``.split_launches``, ``.lstm_split_launches``,
``.tiled_launches``, ``.lstm_tiled_launches``; and
``att_init_state.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from icee_tpu_torch.decode.beam import top_k
from icee_tpu_torch.models import attention as att_mod
from icee_tpu_torch.ops import cuda_lib
from icee_tpu_torch.ops.cells import factored_lstm_cell, lstm_cell
from icee_tpu_torch.ops.decode_step import (K_MAX, V_TILE,
                                            check_beam_width,
                                            check_kernel_widths)

KINDS = ("factored", "lstm")

AttStep = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]
CELL_SHAPES = {
    "factored": lambda ein, f, h, v: {
        "V_w": (ein, 4 * f), "V_b": (4, f), "S_w": (4, f, f), "S_b": (4, f),
        "U_w": (4, f, h), "U_b": (4, h), "W_w": (h, 4 * h), "W_b": (4, h),
        "C_w": (h, v), "C_b": (v,)},
    "lstm": lambda ein, f, h, v: {
        "W_ih": (ein, 4 * h), "b_ih": (4 * h,), "W_hh": (h, 4 * h),
        "b_hh": (4 * h,), "C_w": (h, v), "C_b": (v,)},
}


def _kind(kind: str) -> str:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; choose one of {KINDS}")
    return kind


def step_params(params: dict, kind: str, style: int = 0):
    """A whole attention decoder's tree -> K6's (cell, att, gate) trees:
    the cell's weights with the style's S slice (factored) and the head as
    ``C_w``/``C_b``, the style's attention net, and the context gate."""
    att = att_mod.select_attention(params, style)
    if _kind(kind) == "factored":
        cell = {k: params[k] for k in ("V_w", "V_b", "U_w", "U_b", "W_w",
                                       "W_b", "C_w", "C_b")}
        cell["S_w"] = params["S_w"][int(style)]
        cell["S_b"] = params["S_b"][int(style)]
    else:
        cell = dict(params["cell"], C_w=params["linear_w"],
                    C_b=params["linear_b"])
    gate = {"f_beta_w": params["f_beta_w"], "f_beta_b": params["f_beta_b"]}
    return cell, att, gate


def att_decode_step_topk_plain(cell_params: dict, att_params: dict,
                               gate_params: dict, x, h, c, features, att1,
                               kind: str = "factored", k: int = 5,
                               ktop: int = 5) -> AttStep:
    """attend_precomputed -> gate -> cell -> head -> log_softmax -> top-k
    (ties to the lowest index) -> (logp (R, ktop) f32, idx (R, ktop)
    int32, h', c', alpha (R, P)).  Rows are image-major, k per image."""
    feats = features.repeat_interleave(k, dim=0)
    a1 = att1.repeat_interleave(k, dim=0)
    gctx, alpha = att_mod._gated_context_pre(gate_params, att_params, a1,
                                             feats, h)
    xf = torch.cat([x, gctx], dim=-1)
    if _kind(kind) == "factored":
        stacked = dict(cell_params, S_w=cell_params["S_w"][None],
                       S_b=cell_params["S_b"][None])
        h2, c2 = factored_lstm_cell(stacked, xf, h, c, 0)
    else:
        h2, c2 = lstm_cell(cell_params, xf, h, c)
    logits = h2 @ cell_params["C_w"] + cell_params["C_b"]
    vals, idx = top_k(torch.log_softmax(logits.float(), dim=-1), ktop)
    return vals, idx.to(torch.int32), h2, c2, alpha


def check_step_params(cell_params: dict, att_params: dict, gate_params: dict,
                      kind: str, e_in: int, device: torch.device
                      ) -> Tuple[int, int, int, int, int]:
    """Validate the weights the kernels read; -> (F, H, V, A, FS)."""
    h, a = att_params["dec_w"].shape
    fs = gate_params["f_beta_w"].shape[1]
    v = cell_params["C_w"].shape[1]
    f = cell_params["U_w"].shape[1] if _kind(kind) == "factored" else h
    shapes = dict(CELL_SHAPES[kind](e_in, f, h, v), dec_w=(h, a),
                  dec_b=(a,), full_w=(a, 1), full_b=(1,), f_beta_w=(h, fs),
                  f_beta_b=(fs,))
    tree = {**gate_params, **att_params, **cell_params}
    for name, shape in shapes.items():
        cuda_lib.check_tensor(name, tree[name], shape, torch.float32, device)
    return f, h, v, a, fs


def _step_weights(cell_params: dict, att_params: dict, gate_params: dict,
                  kind: str, e: int, fs: int, device: torch.device,
                  split: bool):
    """Validates the step's weights; -> (F, H, V, A, FS, addresses): on a
    CUDA device the kernel's weight arguments after the step's inputs and
    its widths after the outputs, on the CPU None."""
    f, hd, v, a, fs = check_step_params(cell_params, att_params, gate_params,
                                        kind, e + fs, device)
    if device.type == "cpu":
        return f, hd, v, a, fs, None
    if device.type != "cuda":
        raise ValueError(f"att_decode_step_topk: unsupported device {device}")
    check_kernel_widths(f, hd, v, a, fs)
    if not split:  # the row-tiled cell launch holds 8 rows' planes
        smem = _library().icee_att_step_smem(e, f, hd, fs)
        if smem > cuda_lib.SMEM_LIMIT:
            raise ValueError(f"att_decode_step_topk needs {smem} bytes of "
                             f"shared memory per block, more than "
                             f"{cuda_lib.SMEM_LIMIT}")
    ptr = cuda_lib.ptr
    cp, ap, gp = cell_params, att_params, gate_params
    names = (("V_w", "V_b", "S_w", "S_b", "U_w", "U_b", "W_w", "W_b")
             if kind == "factored" else ("W_ih", "b_ih", "W_hh", "b_hh"))
    before = (ptr(ap["dec_w"]), ptr(ap["dec_b"]), ptr(ap["full_w"]),
              ptr(ap["full_b"]), ptr(gp["f_beta_w"]), ptr(gp["f_beta_b"]),
              *(ptr(cp[n]) for n in names), ptr(cp["C_w"]), ptr(cp["C_b"]))
    return f, hd, v, a, fs, (before, (f, hd) if kind == "factored" else (hd,))


def att_decode_step_topk(cell_params: dict, att_params: dict,
                         gate_params: dict, x: torch.Tensor, h: torch.Tensor,
                         c: torch.Tensor, features: torch.Tensor,
                         att1: torch.Tensor, kind: str = "factored",
                         k: int = 5, ktop: int = 5) -> AttStep:
    """-> (logp_top (R, ktop) f32, idx_top (R, ktop) int32, h', c', alpha
    (R, P)) for R = n_img * k image-major rows.

    ``cell_params``: the cell's weights (factored: V_w with E + FS rows, the
    style's S_w (4, F, F) and S_b; lstm: W_ih, W_hh, b_ih, b_hh) and the
    head ``C_w``/``C_b``; ``att_params``: the style's dec_w, dec_b, full_w,
    full_b; ``gate_params``: f_beta_w, f_beta_b.  ``features`` (n_img, P,
    FS) and ``att1`` (n_img, P, A) are per image.  Float32 only.
    """
    device = x.device
    rows, e = x.shape
    n_img, p, fs = features.shape
    if k < 1 or rows != n_img * k:
        raise ValueError(f"{rows} rows for {n_img} images of k={k}")
    if device.type == "cuda" and k > K_MAX:
        raise ValueError(f"k={k} rows an image: the CUDA kernel K6 "
                         f"(csrc/att_decode_step.cu) takes at most K_MAX = "
                         f"{K_MAX}")
    split = n_img == 1
    f, hd, v, a, fs, wp = cuda_lib.checked_weights(
        (cell_params, att_params, gate_params), (kind, e, fs, device, split),
        lambda: _step_weights(cell_params, att_params, gate_params, kind, e,
                              fs, device, split))
    for name, t, shape in (("x", x, (rows, e)), ("h", h, (rows, hd)),
                           ("c", c, (rows, hd)),
                           ("features", features, (n_img, p, fs)),
                           ("att1", att1, (n_img, p, a))):
        cuda_lib.check_tensor(name, t, shape, torch.float32, device)
    check_beam_width("ktop", ktop, v, device,
                     "K6 (csrc/att_decode_step.cu)")
    if device.type == "cpu":
        return att_decode_step_topk_plain(cell_params, att_params,
                                          gate_params, x, h, c, features,
                                          att1, kind, k, ktop)

    lib = _library()
    f32 = dict(dtype=torch.float32, device=device)
    h_out = torch.empty((rows, hd), **f32)
    c_out = torch.empty((rows, hd), **f32)
    logp = torch.empty((rows, ktop), **f32)
    idx = torch.empty((rows, ktop), dtype=torch.int32, device=device)
    alpha = torch.empty((rows, p), **f32)
    ptr = cuda_lib.ptr
    if split:
        work = torch.empty((lib.icee_att_step_split_work(
            kind == "factored", k, f, hd, v, a, p, fs),), **f32)
        outs = (ptr(h_out), ptr(c_out), ptr(logp), ptr(idx), ptr(alpha),
                ptr(work), k, e)
    else:
        x_full = torch.empty((rows, e + fs), **f32)
        n_tiles = -(-v // V_TILE)
        pm = torch.empty((rows, n_tiles), **f32)
        pse = torch.empty((rows, n_tiles), **f32)
        pv = torch.empty((rows, n_tiles, ktop), **f32)
        pi = torch.empty((rows, n_tiles, ktop), dtype=torch.int32,
                         device=device)
        outs = (ptr(x_full), ptr(h_out), ptr(c_out), ptr(logp), ptr(idx),
                ptr(alpha), ptr(pm), ptr(pse), ptr(pv), ptr(pi), n_img, k, e)
    fn = {("factored", False): lib.icee_att_decode_step_topk,
          ("factored", True): lib.icee_att_decode_step_topk_split,
          ("lstm", False): lib.icee_att_decode_step_topk_lstm,
          ("lstm", True): lib.icee_att_decode_step_topk_lstm_split}[
              kind, split]
    rc = fn(ptr(x), ptr(h), ptr(c), ptr(features), ptr(att1), *wp[0], *outs,
            *wp[1], v, a, p, fs, ktop, cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, f"att_decode_step_topk (kind={kind})")
    prefix = "" if kind == "factored" else "lstm_"
    counts = att_decode_step_topk.__dict__
    counts[prefix + "launches"] += 1
    counts[prefix + ("split_launches" if split else "tiled_launches")] += 1
    return logp, idx, h_out, c_out, alpha


att_decode_step_topk.launches = 0       # kernel calls, kind="factored"
att_decode_step_topk.lstm_launches = 0  # kernel calls, kind="lstm"
att_decode_step_topk.split_launches = 0       # one image: the split path
att_decode_step_topk.lstm_split_launches = 0
att_decode_step_topk.tiled_launches = 0       # several images: row-tiled
att_decode_step_topk.lstm_tiled_launches = 0


def att_init_state(params: dict, features: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h0, c0 (n_img, H) of the attention search from the mean of each
    image's spatial features (n_img, P, FS): ``init_h``/``init_c`` of the
    decoder ``params`` (either kind).  On the card K7's mean and init
    stages (``csrc/att_beam.cu``): the bits K7 starts its search from."""
    device = features.device
    n_img, p, fs = features.shape
    hd = params["init_h_w"].shape[1]
    for name, shape in (("init_h_w", (fs, hd)), ("init_h_b", (hd,)),
                        ("init_c_w", (fs, hd)), ("init_c_b", (hd,))):
        cuda_lib.check_tensor(name, params[name], shape, torch.float32,
                              device)
    cuda_lib.check_tensor("features", features, (n_img, p, fs),
                          torch.float32, device)
    if device.type == "cpu":
        return att_mod.init_hidden_state(params, features)
    if device.type != "cuda":
        raise ValueError(f"att_init_state: unsupported device {device}")
    check_kernel_widths(hd, fs)
    from icee_tpu_torch.ops import att_beam  # it imports this module

    h0, c0 = att_beam.init_state(params, features)
    att_init_state.launches += 1
    return h0, c0


att_init_state.launches = 0


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    return cuda_lib.library("att_decode_step", {
        "icee_att_decode_step_topk": ([vp] * 31 + [i] * 10 + [vp], i),
        "icee_att_decode_step_topk_lstm": ([vp] * 27 + [i] * 9 + [vp], i),
        "icee_att_decode_step_topk_split": ([vp] * 27 + [i] * 9 + [vp], i),
        "icee_att_decode_step_topk_lstm_split": (
            [vp] * 23 + [i] * 8 + [vp], i),
        "icee_att_step_split_work": ([i] * 8, ctypes.c_longlong),
        "icee_att_step_smem": ([i] * 4, ctypes.c_longlong)})
