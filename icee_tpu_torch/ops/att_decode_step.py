"""K6: one attention beam step with an exact top-k over the vocabulary, for
StyleNet+Att (``kind="factored"``) and NIC+Att (``kind="lstm"``).

Port of ``icee_tpu/ops/pallas_att_decode.py::fused_att_decode_step_topk``.
The CUDA kernel is ``csrc/att_decode_step.cu`` with two paths, chosen by
the shape alone and giving the same bits for a row:

* column-split (one image, k <= 8 rows: the serial serving path;
  ``csrc/split_step.cuh``): pre (every product of h and of the embedding),
  scores, context, then the cell's and the head's launches, each product's
  columns spread over the whole card and chained by programmatic dependent
  launch; where those launches' shared memory does not hold the rows
  (:func:`split_att_smem`: the factored cell at F above ~1,400 and k =
  8), the many-row path;
* many-row (several images, or more than 8 rows an image; the batched
  shapes; ``csrc/step_kernels.cuh``): one product launch over all rows of
  att2, the gate's pre-activation and the cell's h product, then the
  scores (a block per image, group of 8 of its rows and 8 positions) and
  the context (a block per image, group and 256 feature columns) write x
  = [emb; gate * ctx], then K1's products, gates and reduce run with input
  width E + FS (``decode_step.step_plan`` lists the launches).  Only the
  attention launches hold rows in shared memory: a group's att2 (8 A
  floats; past a block's, from A ~7,264, in column pieces) and scores (8
  P, P up to 7,264: :func:`check_attend`).

Top-ks above ``K_MAX`` = 8, up to V, take K1's wide head and reduce
(``csrc/wide_topk.cuh``), the same bits as the narrow merge would give
(above ``K_WIDE`` = 256 the survivors in device memory); any beam width k
runs, its rows in groups of 8 an attention block.

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
``.tiled_launches``, ``.lstm_tiled_launches``, and a beam or top-k
above ``K_MAX``, ``.wide_launches``, ``.lstm_wide_launches``; and
``att_init_state.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from icee_tpu_torch.decode.beam import top_k
from icee_tpu_torch.models import attention as att_mod
from icee_tpu_torch.ops import cuda_lib, widths
from icee_tpu_torch.ops.cells import factored_lstm_cell, lstm_cell
from icee_tpu_torch.ops.decode_step import (K_MAX, MIRROR_ROWS,
                                            MIRROR_SHAPES, SPLIT_ROWS,
                                            V_TILE, check_beam_width,
                                            gemm_pick, mirror_gemm_pick,
                                            split_cell_smem, split_slab_smem,
                                            step_work_floats,
                                            wide_cand_floats)

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


CELL_WEIGHTS = {"factored": ("V_w", "V_b", "S_w", "S_b", "U_w", "U_b", "W_w",
                             "W_b"),
                "lstm": ("W_ih", "b_ih", "W_hh", "b_hh")}
ATT_WEIGHTS = ("dec_w", "dec_b", "full_w", "full_b")
GATE_WEIGHTS = ("f_beta_w", "f_beta_b")


def step_layout(cell_params: dict, att_params: dict, gate_params: dict,
                kind: str, e: int) -> Tuple[widths.Widths, dict]:
    """K6's launch setup (and K7's, on the style's trees): the widths
    (true, padded) and one tree of the weights the kernel reads, the
    cell's (with the head ``C_w``/``C_b``), the attention net's and the
    gate's, laid out at the padded widths (``ops/widths.py``); the tensors
    themselves where no width grows."""
    h, a = att_params["dec_w"].shape
    f = cell_params["U_w"].shape[1] if _kind(kind) == "factored" else h
    w = widths.widths(E=e, F=f, H=h, V=cell_params["C_w"].shape[1], A=a,
                      FS=gate_params["f_beta_w"].shape[1])
    names = CELL_WEIGHTS[kind] + ("C_w", "C_b")
    tree = {**{n: att_params[n] for n in ATT_WEIGHTS},
            **{n: gate_params[n] for n in GATE_WEIGHTS},
            **{n: cell_params[n] for n in names}}
    return w, widths.pad_tree(tree, w)


def scores_cols(rows: int, a: int) -> int:
    """Columns of att2 the many-row scores launch stages at once for a
    group of ``rows`` rows (``csrc/att_decode_step.cu``
    ``att_scores_cols``): all of them (the padded A) where they fit a
    block's shared memory, else the widest multiple of 128 that does,
    taken piece after piece with each row's chain carried on."""
    fit = cuda_lib.SMEM_LIMIT // (4 * rows)
    return widths.quad(a) if widths.quad(a) <= fit else fit // 128 * 128


def attend_smem(rows: int, a: int, p: int) -> int:
    """Bytes of shared memory of the larger of the many-row path's
    attention launches for a group of ``rows`` rows (``csrc/
    att_decode_step.cu`` ``icee_att_attend_smem``): the scores launch
    holds their att2 rows (or a piece of their columns), the context
    launch their scores."""
    return 4 * rows * max(scores_cols(rows, a), widths.quad(p))


def check_attend(what: str, k: int, a: int, p: int) -> None:
    """Raise ValueError, naming the launch, where a group of min(k, 8)
    rows' scores do not fit a block's shared memory (the padded widths;
    P past 7,264, where JAX's K6 holds an image's features block beside
    its weights past its own 110 MB).  Any A fits: the scores launch
    stages att2 in column pieces."""
    smem = attend_smem(min(k, K_MAX), a, p)
    if smem > cuda_lib.SMEM_LIMIT:
        raise ValueError(
            f"{what}: the attention launches' {min(k, K_MAX)} rows at A={a}, "
            f"P={p} need {smem} bytes of shared memory, more than "
            f"{cuda_lib.SMEM_LIMIT}")


def split_att_smem(factored: bool, k: int, e: int, f: int, h: int, a: int,
                   p: int, fs: int) -> int:
    """Bytes of shared memory of K6's largest column-split launch for one
    image's k rows (``csrc/split_step.cuh`` ``split_att_smem``): the cell's
    and pre launches, the scores launch's att2 rows, the context's."""
    return max(split_cell_smem(factored, k, e, f, h, fs), 4 * k * a,
               split_slab_smem(p, 1, False, k))


def _step_weights(cell_params: dict, att_params: dict, gate_params: dict,
                  kind: str, e: int, fs: int, device: torch.device):
    """Validates the step's weights; -> (widths, kernel weights): on a
    CUDA device the kernel's weight arguments after the step's inputs (at
    the padded widths), its cell widths after the outputs, and the padded
    tensors they point into; on the CPU None."""
    f, h, v, a, fs = check_step_params(cell_params, att_params, gate_params,
                                       kind, e + fs, device)
    if device.type == "cpu":
        return widths.widths(E=e, F=f, H=h, V=v, A=a, FS=fs), None
    if device.type != "cuda":
        raise ValueError(f"att_decode_step_topk: unsupported device {device}")
    w, kern = step_layout(cell_params, att_params, gate_params, kind, e)
    fp, hp = w["F"][1], w["H"][1]
    ptr = cuda_lib.ptr
    names = ATT_WEIGHTS + GATE_WEIGHTS + CELL_WEIGHTS[kind] + ("C_w", "C_b")
    held = (tuple(ptr(kern[n]) for n in names),
            (fp, hp) if kind == "factored" else (hp,), kern)
    return widths.checked(w, held)


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
    FS) and ``att1`` (n_img, P, A) are per image.  Float32 only.  Any F,
    H, V, A and FS: on the card the kernel runs at widths rounded up to 4
    (``ops/widths.py``), h, c, the features and att1 padded in, h' and c'
    cut back out.
    """
    device = x.device
    rows, e = x.shape
    n_img, p, fs = features.shape
    if k < 1 or rows != n_img * k:
        raise ValueError(f"{rows} rows for {n_img} images of k={k}")
    w, wp = cuda_lib.checked_weights(
        (cell_params, att_params, gate_params), (kind, e, fs, device),
        lambda: _step_weights(cell_params, att_params, gate_params, kind, e,
                              fs, device))
    hd, v, a = w["H"][0], w["V"][0], w["A"][0]
    for name, t, shape in (("x", x, (rows, e)), ("h", h, (rows, hd)),
                           ("c", c, (rows, hd)),
                           ("features", features, (n_img, p, fs)),
                           ("att1", att1, (n_img, p, a))):
        cuda_lib.check_tensor(name, t, shape, torch.float32, device)
    check_beam_width("ktop", ktop, v)
    if device.type == "cpu":
        return att_decode_step_topk_plain(cell_params, att_params,
                                          gate_params, x, h, c, features,
                                          att1, kind, k, ktop)

    lib = _library()
    fp, hp, vp, ap, fsp = (w[n][1] for n in ("F", "H", "V", "A", "FS"))
    split = (n_img == 1 and k <= SPLIT_ROWS and split_att_smem(
        kind == "factored", k, e, fp, hp, ap, p, fsp) <= cuda_lib.SMEM_LIMIT)
    if not split:
        check_attend(f"att_decode_step_topk (K6, kind={kind})", k, ap, p)
    f32 = dict(dtype=torch.float32, device=device)
    h_out = torch.empty((rows, hp), **f32)
    c_out = torch.empty((rows, hp), **f32)
    logp = torch.empty((rows, ktop), **f32)
    idx = torch.empty((rows, ktop), dtype=torch.int32, device=device)
    alpha = torch.empty((rows, p), **f32)
    ptr = cuda_lib.ptr
    if split:
        work = torch.empty((lib.icee_att_step_split_work(
            kind == "factored", k, fp, hp, vp, ap, p, fsp)
            + wide_cand_floats(k, ktop),), **f32)
        outs = (ptr(h_out), ptr(c_out), ptr(logp), ptr(idx), ptr(alpha),
                ptr(work), k, e)
    else:
        work = torch.empty((lib.icee_att_step_work(
            kind == "factored", rows, e, fp, hp, vp, ap, p, fsp, ktop),),
            **f32)
        outs = (ptr(h_out), ptr(c_out), ptr(logp), ptr(idx), ptr(alpha),
                ptr(work), n_img, k, e)
    fn = {("factored", False): lib.icee_att_decode_step_topk,
          ("factored", True): lib.icee_att_decode_step_topk_split,
          ("lstm", False): lib.icee_att_decode_step_topk_lstm,
          ("lstm", True): lib.icee_att_decode_step_topk_lstm_split}[
              kind, split]
    ins = (widths.pad_last(h, hp), widths.pad_last(c, hp),
           widths.pad_last(features, fsp), widths.pad_last(att1, ap))
    rc = fn(ptr(x), *map(ptr, ins), *wp[0], *outs, *wp[1], vp, ap, p, fsp,
            ktop, cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, f"att_decode_step_topk (kind={kind})")
    prefix = "" if kind == "factored" else "lstm_"
    counts = att_decode_step_topk.__dict__
    counts[prefix + "launches"] += 1
    counts[prefix + ("split_launches" if split else "tiled_launches")] += 1
    counts[prefix + "wide_launches"] += max(k, ktop) > K_MAX
    return (logp, idx, widths.cut_last(h_out, hd), widths.cut_last(c_out, hd),
            alpha)


att_decode_step_topk.launches = 0       # kernel calls, kind="factored"
att_decode_step_topk.lstm_launches = 0  # kernel calls, kind="lstm"
att_decode_step_topk.split_launches = 0       # one image: the split path
att_decode_step_topk.lstm_split_launches = 0
att_decode_step_topk.tiled_launches = 0       # the rest: many-row
att_decode_step_topk.lstm_tiled_launches = 0
att_decode_step_topk.wide_launches = 0        # k or ktop above K_MAX
att_decode_step_topk.lstm_wide_launches = 0


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
    from icee_tpu_torch.ops import att_beam  # it imports this module

    h0, c0 = att_beam.init_state(params, features)
    att_init_state.launches += 1
    return h0, c0


att_init_state.launches = 0


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib = cuda_lib.library("att_decode_step", {
        "icee_att_decode_step_topk": ([vp] * 27 + [i] * 10 + [vp], i),
        "icee_att_decode_step_topk_lstm": ([vp] * 23 + [i] * 9 + [vp], i),
        "icee_att_decode_step_topk_split": ([vp] * 27 + [i] * 9 + [vp], i),
        "icee_att_decode_step_topk_lstm_split": (
            [vp] * 23 + [i] * 8 + [vp], i),
        "icee_att_step_split_work": ([i] * 8, ll),
        "icee_att_step_work": ([i] * 10, ll),
        "icee_att_attend_smem": ([i] * 3, ll),
        "icee_att_step_split_smem": ([i] * 8, ll),
        "icee_step_gemm_pick": ([i, i, vp, vp, i], i)})
    if getattr(lib, "mirrors_checked", False):
        return lib
    for e_in, f, h in MIRROR_SHAPES:   # E + FS = e_in, E = 300 or e_in
        e, fs = (300, e_in - 300) if e_in > 300 else (e_in, 0)
        for kind, ff in (("factored", f), ("lstm", h)):
            fact = kind == "factored"
            got = (lib.icee_att_attend_smem(8, 512, h),
                   lib.icee_att_attend_smem(8, 8192, h),   # att2 in pieces
                   *(lib.icee_att_step_split_smem(fact, r, e, ff, h, 512,
                                                  400, fs)
                     for r in (1, 5, 8)))
            want = (attend_smem(8, 512, h), attend_smem(8, 8192, h),
                    *(split_att_smem(fact, r, e, ff, h, 512, 400, fs)
                      for r in (1, 5, 8)))
            for rows in MIRROR_ROWS:
                jobs = [(512, 1), (fs, 1), (4 * h, 1)]
                got += (mirror_gemm_pick(lib, rows, jobs, 132),
                        *(lib.icee_att_step_work(fact, rows, e, ff, h, 8192,
                                                 512, 196, fs, kt)
                          for kt in (5, 20, 300)))
                want += (gemm_pick(rows, jobs, 132),
                         *(step_work_floats(kind, rows, e, ff, h, 8192, kt,
                                            512, 196, fs)
                           for kt in (5, 20, 300)))
            if got != want:
                raise RuntimeError(
                    f"csrc/att_decode_step.cu's plans and shared memory "
                    f"{got} at {kind} (E, F, H, FS) = {(e, ff, h, fs)} are "
                    f"not the wrapper's {want}")
    lib.mirrors_checked = True
    return lib
