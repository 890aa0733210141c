"""K5: the attention training scan, teacher-forced and scheduled-sampling,
forward and backward, for StyleNet+Att (``kind="factored"``) and NIC+Att
(``kind="lstm"``).

Port of ``icee_tpu/ops/pallas_att_train.py::fused_att_scan`` and
``fused_att_scan_sampled``.  Per step: the Bahdanau score pass over the P
positions, the softmax, the context, the ``f_beta`` gate, then the
factored cell (gates [i, f, o, c], h = o * c) or the torch LSTM cell
(gates [i, f, g, o], h = o * tanh c) on ``[emb ; gate * ctx]``.  The
scheduled-sampling scan also runs the head ``h C_w + C_b``, takes its
argmax (lowest index on ties) and feeds the raw embedding of that token to
the next step wherever the step's coin is 0.  The CUDA kernels are
``csrc/att_scan.cu``.

Parameters, in the JAX package's kernel-facing layout:

- ``cell``: factored ``{V_we (E, 4F), V_wc (FS, 4F), V_b (4, F), S_w
  (4, F, F) one style, S_b (4, F), U_w (4, F, H), U_b (4, H), W_w (H, 4H),
  W_b (4, H)}`` or lstm ``{W_ihe (E, 4H), W_ihc (FS, 4H), W_hh (H, 4H),
  b_ih (4H,), b_hh (4H,)}``;
- ``att``: ``{dec_w (H, A), dec_b (A,), full_w (A, 1), full_b (1,), fb_w
  (H, FS), fb_b (FS,)}``;
- ``head`` (sampled only): ``{C_w (H, V), C_b (V,), B (V, E)}``, B the raw
  (dropout-free) embedding table.

:func:`fused_att_scan` and :func:`fused_att_scan_sampled` are
``torch.autograd.Function``s.  Their cotangents follow the JAX
``custom_vjp``: ``features`` gets zero (the spatial encoder is frozen),
``C_w``, ``C_b`` and the coins get zero (the head only picks the argmax),
``B`` gets the sampled steps' input grads scattered by the token trace,
and the raw embeddings ``emb_raw`` get step 0's sampled share.

Plain versions, beside the kernels: :func:`fused_att_scan_plain`,
:func:`fused_att_scan_sampled_plain` (which can be handed a token trace to
follow) and :func:`att_scan_bwd_plain` (the explicit backward of
``_bwd_impl``).  The wrappers :func:`att_scan_fwd` and :func:`att_scan_bwd`
take the plain versions only for tensors on the CPU; for CUDA tensors they
launch the kernels or raise.  Launch counts, per cell and mode:
``att_scan_fwd.launches`` (factored, teacher-forced), ``.lstm_launches``,
``.sampled_launches``, ``.sampled_lstm_launches``, and the same on
``att_scan_bwd``.

Every product the CUDA scans launch is ``csrc/gemm_tf32x3.cuh``'s: float32
accuracy on the tensor cores from three TF32 passes over a hi/lo split of
each operand.  :func:`tf32x3_product` runs that product alone (the card
tests and ``chip_smoke.py`` hold it against float64), beside its plain
version :func:`tf32x3_product_plain`, which emulates the split, and
:func:`f32_product`, the CUDA-core product of ``csrc/gemm_f32.cuh``, the
yardstick of its error bound.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from icee_tpu_torch.ops import cuda_lib

FACTORED_KEYS = ("V_we", "V_wc", "V_b", "S_w", "S_b", "U_w", "U_b", "W_w",
                 "W_b")
LSTM_KEYS = ("W_ihe", "W_ihc", "W_hh", "b_ih", "b_hh")
ATT_KEYS = ("dec_w", "dec_b", "full_w", "full_b", "fb_w", "fb_b")
KINDS = ("factored", "lstm")


def cell_keys(kind: str) -> Tuple[str, ...]:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; choose one of {KINDS}")
    return FACTORED_KEYS if kind == "factored" else LSTM_KEYS


def counter_name(kind: str, sampled: bool) -> str:
    """The launch-count attribute of one cell and mode."""
    return (("sampled_" if sampled else "")
            + ("lstm_" if cell_keys(kind) is LSTM_KEYS else "")
            + "launches")


# --- input checks ------------------------------------------------------------

def check_scan_inputs(cell: dict, att: dict, emb_seq, att1, features, h0, c0,
                      kind: str) -> Tuple[int, ...]:
    """Validate the scan's tensors; -> (B, T, E, F, H, A, P, FS), F = 0
    for the LSTM cell."""
    device = emb_seq.device
    if emb_seq.dim() != 3 or att1.dim() != 3 or features.dim() != 3:
        raise ValueError("emb_seq, att1 and features must be 3-D")
    b, t, e = emb_seq.shape
    if b < 1 or t < 1:
        raise ValueError(f"emb_seq: empty batch or sequence "
                         f"{tuple(emb_seq.shape)}")
    p, a = att1.shape[1], att1.shape[2]
    fs = features.shape[2]
    h = att["dec_w"].shape[0]
    if cell_keys(kind) is FACTORED_KEYS:
        f = cell["U_w"].shape[1]
        shapes = {"V_we": (e, 4 * f), "V_wc": (fs, 4 * f), "V_b": (4, f),
                  "S_w": (4, f, f), "S_b": (4, f), "U_w": (4, f, h),
                  "U_b": (4, h), "W_w": (h, 4 * h), "W_b": (4, h)}
    else:
        f = 0
        shapes = {"W_ihe": (e, 4 * h), "W_ihc": (fs, 4 * h),
                  "W_hh": (h, 4 * h), "b_ih": (4 * h,), "b_hh": (4 * h,)}
    for name, shape in shapes.items():
        cuda_lib.check_tensor(name, cell[name], shape, torch.float32, device)
    for name, shape in (("dec_w", (h, a)), ("dec_b", (a,)),
                        ("full_w", (a, 1)), ("full_b", (1,)),
                        ("fb_w", (h, fs)), ("fb_b", (fs,))):
        cuda_lib.check_tensor(name, att[name], shape, torch.float32, device)
    for name, ten, shape in (("emb_seq", emb_seq, (b, t, e)),
                             ("att1", att1, (b, p, a)),
                             ("features", features, (b, p, fs)),
                             ("h0", h0, (b, h)), ("c0", c0, (b, h))):
        cuda_lib.check_tensor(name, ten, shape, torch.float32, device)
    return b, t, e, f, h, a, p, fs


def check_samp(samp: dict, dims, device: torch.device) -> int:
    """Validate the scheduled-sampling inputs; -> V."""
    b, t, e, _, h = dims[:5]
    head = samp["head"]
    v = head["C_w"].shape[1]
    for name, shape in (("C_w", (h, v)), ("C_b", (v,)), ("B", (v, e))):
        cuda_lib.check_tensor(name, head[name], shape, torch.float32, device)
    er = samp["emb_raw"]
    if er.dim() != 3 or er.shape[1] not in (1, t):
        raise ValueError(f"emb_raw: expected (B, 1 or T, E), got "
                         f"{tuple(er.shape)}")
    cuda_lib.check_tensor("emb_raw", er, (b, er.shape[1], e), torch.float32,
                          device)
    cuda_lib.check_tensor("coins", samp["coins"], (t,), torch.float32, device)
    return v


# --- plain versions ----------------------------------------------------------

def _attend(att: dict, att1, features, h):
    """One Bahdanau step -> (alpha (B, P), ctx (B, FS), gate (B, FS));
    ``_attend_step`` (``pallas_att_train.py:115``)."""
    att2 = h @ att["dec_w"] + att["dec_b"]
    e = torch.relu(att1 + att2[:, None, :]) @ att["full_w"]
    alpha = torch.softmax(e[..., 0] + att["full_b"], dim=1)
    ctx = torch.sum(features * alpha[..., None], dim=1)
    gate = torch.sigmoid(h @ att["fb_w"] + att["fb_b"])
    return alpha, ctx, gate


def _cell_acts(cell: dict, kind: str, emb, gctx, h):
    """Gate activations of one step -> (acts, v (B, 4, F), s (B, 4, F));
    acts are (i, f, o, g) for the factored cell, (i, f, g, o) for the LSTM
    cell, v and s None for the LSTM cell (``_factored_acts`` :152,
    ``_lstm_acts`` :176)."""
    b, hd = h.shape
    if kind == "factored":
        f = cell["U_w"].shape[1]
        v = (emb @ cell["V_we"] + gctx @ cell["V_wc"]).reshape(b, 4, f) \
            + cell["V_b"]
        s = torch.einsum("bgf,gfk->bgk", v, cell["S_w"]) + cell["S_b"]
        u = torch.einsum("bgf,gfh->bgh", s, cell["U_w"]) + cell["U_b"]
        z = u + (h @ cell["W_w"]).reshape(b, 4, hd) + cell["W_b"]
        acts = (torch.sigmoid(z[:, 0]), torch.sigmoid(z[:, 1]),
                torch.sigmoid(z[:, 2]), torch.tanh(z[:, 3]))
        return acts, v, s
    z = (emb @ cell["W_ihe"] + gctx @ cell["W_ihc"] + cell["b_ih"]
         + h @ cell["W_hh"] + cell["b_hh"]).reshape(b, 4, hd)
    acts = (torch.sigmoid(z[:, 0]), torch.sigmoid(z[:, 1]),
            torch.tanh(z[:, 2]), torch.sigmoid(z[:, 3]))
    return acts, None, None


def _cell_step(cell: dict, kind: str, emb, gctx, h, c):
    acts, _, _ = _cell_acts(cell, kind, emb, gctx, h)
    if kind == "factored":
        i_t, f_t, o_t, g_t = acts
        c = f_t * c + i_t * g_t
        return o_t * c, c                # reference quirk: no tanh
    i_t, f_t, g_t, o_t = acts
    c = f_t * c + i_t * g_t
    return o_t * torch.tanh(c), c


def fused_att_scan_plain(cell: dict, att: dict, emb_seq, att1, features, h0,
                         c0, kind: str = "factored"):
    """Teacher-forced scan -> (h_seq (B, T, H), alphas (B, T, P), c_seq
    (B, T, H)); ``reference_att_scan`` on the kernel's parameters."""
    cell_keys(kind)
    h, c = h0, c0
    hs, cs, alphas = [], [], []
    for step in range(emb_seq.shape[1]):
        alpha, ctx, gate = _attend(att, att1, features, h)
        h, c = _cell_step(cell, kind, emb_seq[:, step], gate * ctx, h, c)
        hs.append(h)
        cs.append(c)
        alphas.append(alpha)
    return torch.stack(hs, 1), torch.stack(alphas, 1), torch.stack(cs, 1)


def fused_att_scan_sampled_plain(cell: dict, att: dict, head: dict, emb_seq,
                                 emb_raw, att1, features, h0, c0, coins,
                                 kind: str = "factored", forced_pidx=None):
    """Scheduled-sampling scan -> (h_seq, alphas, c_seq, pidx (T, B)
    int64); ``reference_att_scan_sampled`` on the kernel's parameters.  A
    free step (coin 0) consumes the raw embedding ``B[prev]`` of the previous
    step's argmax (lowest index on ties), ``emb_raw[:, 0]`` at t = 0.  With
    ``forced_pidx`` (T, B) the scan feeds those tokens instead of its own
    argmax (it still returns its own argmax in ``pidx``)."""
    cell_keys(kind)
    h, c = h0, c0
    prev = emb_raw[:, 0]
    hs, cs, alphas, picks = [], [], [], []
    for step, coin in enumerate(coins.tolist()):
        alpha, ctx, gate = _attend(att, att1, features, h)
        x = emb_seq[:, step] if coin != 0.0 else prev
        h, c = _cell_step(cell, kind, x, gate * ctx, h, c)
        logits = h.detach() @ head["C_w"] + head["C_b"]
        idx = torch.argmax(logits, dim=-1)                   # first maximum
        picks.append(idx)
        feed = idx if forced_pidx is None else forced_pidx[step].long()
        prev = head["B"][feed]
        hs.append(h)
        cs.append(c)
        alphas.append(alpha)
    return (torch.stack(hs, 1), torch.stack(alphas, 1), torch.stack(cs, 1),
            torch.stack(picks))


def used_embeddings(emb_seq, samp: dict, pidx) -> torch.Tensor:
    """(B, T, E): the input embedding each sampled step consumed, the
    teacher's where the coin is 1, else ``emb_raw[:, 0]`` at t = 0 and
    ``B[pidx[t - 1]]`` after."""
    prev = torch.cat([samp["emb_raw"][:, :1],
                      samp["head"]["B"][pidx[:-1].long()].transpose(0, 1)],
                     dim=1)
    coin = samp["coins"][None, :, None] != 0.0
    return torch.where(coin, emb_seq, prev)


def att_scan_bwd_plain(cell: dict, att: dict, emb_used, att1, features, h0,
                       c0, h_seq, c_seq, alphas, dh_seq, dalpha_seq,
                       kind: str = "factored",
                       att2_seq=None) -> Dict[str, object]:
    """The backward of ``_bwd_impl`` (``pallas_att_train.py:669-851``) in
    tensor ops: a reverse loop that recomputes att2, the gate and the
    context (from the saved alpha) and the gate activations from h_prev,
    chains (dh, dc), accumulates d_att1, full_w's and full_b's grads, and
    keeps the per-step factors (dz, gctx, dpre_fb, d_att2; s, v for the
    factored cell); then every other weight grad as one product over all
    T * B rows.  ``emb_used`` is the input each step consumed.  -> {"cell",
    "att": grads by name, "emb": d emb_used (B, T, E), "att1", "h0",
    "c0"}.  ``att2_seq`` (B, T, A): the forward's att2, to use instead of
    recomputing it; relu'(att1 + att2) jumps at 0, so an att2 summed in
    another order flips the mask wherever att1 + att2 lies within rounding
    of 0, and a comparison of two backwards wants the same masks."""
    b, t, _ = emb_used.shape
    hd = h0.shape[1]
    factored = cell_keys(kind) is FACTORED_KEYS
    h_prev_seq = torch.cat([h0[:, None], h_seq[:, :-1]], 1)
    c_prev_seq = torch.cat([c0[:, None], c_seq[:, :-1]], 1)
    fw = att["full_w"][:, 0]
    dh_c = torch.zeros_like(h0)
    dc_c = torch.zeros_like(c0)
    datt1 = torch.zeros_like(att1)
    dfull_w = torch.zeros_like(fw)
    dfull_b = torch.zeros_like(att["full_b"])
    d_emb = torch.empty_like(emb_used)
    keep = {name: [None] * t for name in ("dz", "gctx", "dpre", "datt2",
                                          "v", "s")}
    for step in reversed(range(t)):
        hp, cp = h_prev_seq[:, step], c_prev_seq[:, step]
        att2 = (hp @ att["dec_w"] + att["dec_b"] if att2_seq is None
                else att2_seq[:, step])
        gate = torch.sigmoid(hp @ att["fb_w"] + att["fb_b"])
        alpha = alphas[:, step]
        ctx = torch.sum(features * alpha[..., None], dim=1)
        gctx = gate * ctx
        acts, v, s = _cell_acts(cell, kind, emb_used[:, step], gctx, hp)
        dh_total = dh_seq[:, step] + dh_c
        c_new = c_seq[:, step]
        if factored:
            i_t, f_t, o_t, g_t = acts
            d_o = dh_total * c_new                         # h = o * c
            dc_tot = dh_total * o_t + dc_c
        else:
            i_t, f_t, g_t, o_t = acts
            tc = torch.tanh(c_new)
            d_o = dh_total * tc
            dc_tot = dh_total * o_t * (1.0 - tc * tc) + dc_c
        d_f, d_i, d_g = dc_tot * cp, dc_tot * g_t, dc_tot * i_t
        dc_c = dc_tot * f_t
        dz_i, dz_f = d_i * i_t * (1.0 - i_t), d_f * f_t * (1.0 - f_t)
        dz_o, dz_g = d_o * o_t * (1.0 - o_t), d_g * (1.0 - g_t * g_t)
        if factored:
            dz = torch.stack([dz_i, dz_f, dz_o, dz_g], 1)        # (B, 4, H)
            ds = torch.einsum("bgh,gfh->bgf", dz, cell["U_w"])
            dv = torch.einsum("bgk,gfk->bgf", ds, cell["S_w"]).reshape(b, -1)
            d_e_in = dv @ cell["V_we"].T
            d_gctx = dv @ cell["V_wc"].T
            dz = dz.reshape(b, 4 * hd)
            dh_prev = dz @ cell["W_w"].T
            keep["v"][step], keep["s"][step] = v, s
        else:
            dz = torch.cat([dz_i, dz_f, dz_g, dz_o], 1)          # (B, 4H)
            d_e_in = dz @ cell["W_ihe"].T
            d_gctx = dz @ cell["W_ihc"].T
            dh_prev = dz @ cell["W_hh"].T
        d_gate = d_gctx * ctx
        d_ctx = d_gctx * gate
        dpre = d_gate * gate * (1.0 - gate)
        dh_prev = dh_prev + dpre @ att["fb_w"].T
        # ctx = alpha features (the features cotangent is dropped)
        d_alpha = torch.einsum("bf,bpf->bp", d_ctx, features) \
            + dalpha_seq[:, step]
        d_e = alpha * (d_alpha - torch.sum(d_alpha * alpha, 1, keepdim=True))
        dfull_b = dfull_b + d_e.sum()
        pre = att1 + att2[:, None, :]
        dfull_w = dfull_w + torch.einsum("bp,bpa->a", d_e, torch.relu(pre))
        d_r = (pre > 0).to(pre.dtype) * (d_e[:, :, None] * fw)
        datt1 = datt1 + d_r
        d_att2 = d_r.sum(1)
        dh_prev = dh_prev + d_att2 @ att["dec_w"].T
        d_emb[:, step] = d_e_in
        dh_c = dh_prev
        keep["dz"][step], keep["gctx"][step] = dz, gctx
        keep["dpre"][step], keep["datt2"][step] = dpre, d_att2

    def flat(name):
        return torch.stack(keep[name], 1).reshape(b * t, -1)

    hp_f = h_prev_seq.reshape(b * t, hd)
    emb_f = emb_used.reshape(b * t, -1)
    dz_f, gctx_f = flat("dz"), flat("gctx")
    dpre_f, datt2_f = flat("dpre"), flat("datt2")
    if factored:
        f = cell["U_w"].shape[1]
        dz4 = dz_f.reshape(-1, 4, hd)
        s_f, v_f = flat("s").reshape(-1, 4, f), flat("v").reshape(-1, 4, f)
        ds_f = torch.einsum("ngh,gfh->ngf", dz4, cell["U_w"])
        dv_f = torch.einsum("ngk,gfk->ngf", ds_f, cell["S_w"])
        dv2 = dv_f.reshape(b * t, 4 * f)
        dcell = {"V_we": emb_f.T @ dv2, "V_wc": gctx_f.T @ dv2,
                 "V_b": dv_f.sum(0),
                 "S_w": torch.einsum("ngf,ngk->gfk", v_f, ds_f),
                 "S_b": ds_f.sum(0),
                 "U_w": torch.einsum("ngf,ngh->gfh", s_f, dz4),
                 "U_b": dz4.sum(0), "W_w": hp_f.T @ dz_f,
                 "W_b": dz4.sum(0)}
    else:
        db = dz_f.sum(0)
        dcell = {"W_ihe": emb_f.T @ dz_f, "W_ihc": gctx_f.T @ dz_f,
                 "W_hh": hp_f.T @ dz_f, "b_ih": db, "b_hh": db.clone()}
    datt = {"dec_w": hp_f.T @ datt2_f, "dec_b": datt2_f.sum(0),
            "full_w": dfull_w[:, None], "full_b": dfull_b,
            "fb_w": hp_f.T @ dpre_f, "fb_b": dpre_f.sum(0)}
    return {"cell": dcell, "att": datt, "emb": d_emb, "att1": datt1,
            "h0": dh_c, "c0": dc_c}


def _sampled_split(d_emb, samp: dict):
    """The coin split of the step-input grads -> (teacher share (B, T, E),
    sampled share (B, T, E))."""
    coin = samp["coins"][None, :, None]
    return coin * d_emb, (1.0 - coin) * d_emb


def _emb_raw_grad(dsamp0, emb_raw):
    """Step 0's sampled share -> the cotangent of ``emb_raw`` (B, 1 or T,
    E): the bootstrap token's embedding is its only consumed column."""
    if emb_raw.shape[1] == 1:
        return dsamp0[:, None]
    out = torch.zeros_like(emb_raw)
    out[:, 0] = dsamp0
    return out


def att_scan_grads_plain(cell: dict, att: dict, emb_seq, att1, features, h0,
                         c0, h_seq, alphas, res: dict, dh_seq, dalpha_seq,
                         kind: str = "factored", samp: Optional[dict] = None,
                         att2_seq=None) -> Dict[str, object]:
    """:func:`att_scan_bwd`'s result from the plain backward, on any
    device: :func:`att_scan_bwd_plain` on the embeddings each step used,
    then the sampled extras of ``_bwd_impl`` (:856-876): the coin split,
    the scatter of the sampled share into ``B`` by the token trace
    ``res["pidx"]``, step 0's share to ``emb_raw``, zero for C_w and
    C_b.  ``att2_seq``: see :func:`att_scan_bwd_plain`."""
    pidx = res["pidx"]
    emb_used = (emb_seq if samp is None
                else used_embeddings(emb_seq, samp, pidx))
    g = att_scan_bwd_plain(cell, att, emb_used, att1, features, h0, c0,
                           h_seq, res["c_seq"], alphas, dh_seq, dalpha_seq,
                           kind, att2_seq)
    out = {"cell": g["cell"], "att": g["att"], "emb_seq": g["emb"],
           "att1": g["att1"], "h0": g["h0"], "c0": g["c0"]}
    if samp is None:
        return out
    out["emb_seq"], dsamp = _sampled_split(g["emb"], samp)
    e = emb_seq.shape[2]
    toks = pidx[:-1].reshape(-1).long()
    rows = dsamp[:, 1:].transpose(0, 1).reshape(-1, e)
    out["head"] = {"C_w": torch.zeros_like(samp["head"]["C_w"]),
                   "C_b": torch.zeros_like(samp["head"]["C_b"]),
                   "B": torch.zeros_like(samp["head"]["B"]).index_add_(
                       0, toks, rows)}
    out["emb_raw"] = _emb_raw_grad(dsamp[:, 0], samp["emb_raw"])
    return out


# --- the product (csrc/gemm_tf32x3.cuh) --------------------------------------

FORMS = ("N", "T", "A")


def _product_dims(a, b, form: str) -> Tuple[int, int, int, int]:
    """-> (batch, M, N, K) of ``op(a) op(b)``: form ``"N"`` a (M, K), b
    (K, N); ``"T"`` b given as (N, K); ``"A"`` a given as (K, M).  A 3-D
    operand is a batch (leading dimension); a 2-D one is shared by every
    batch entry."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; choose one of {FORMS}")
    if a.dim() not in (2, 3) or b.dim() not in (2, 3):
        raise ValueError("product operands must be 2-D or 3-D")
    batch = max(x.shape[0] if x.dim() == 3 else 1 for x in (a, b))
    if any(x.dim() == 3 and x.shape[0] != batch for x in (a, b)):
        raise ValueError(f"batch sizes differ: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    (ar, ac), (br, bc) = a.shape[-2:], b.shape[-2:]
    m, k = (ac, ar) if form == "A" else (ar, ac)
    kb, n = (bc, br) if form == "T" else (br, bc)
    if k != kb:
        raise ValueError(f"form {form}: {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    return batch, m, n, k


def _as_mk(a, form: str):
    return a.transpose(-1, -2) if form == "A" else a


def _as_kn(b, form: str):
    return b.transpose(-1, -2) if form == "T" else b


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 (10 mantissa bits), to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the bit
    pattern (the sign is separate, so this rounds the magnitude) and clear
    them.  Infinities and NaNs pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo), both TF32: hi = round(x), lo = round(x - hi) (the
    subtraction is exact), so hi + lo = x within 2^-22 of |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3_product_plain(a, b, form: str = "N", bias=None):
    """:func:`tf32x3_product`'s arithmetic in tensor ops: each operand
    split into TF32 hi and lo, the three products lo_a hi_b, hi_a lo_b and
    hi_a hi_b summed in float64, cast to float32, then + bias (float32)."""
    _product_dims(a, b, form)
    ah, al = (x.double() for x in tf32_split(_as_mk(a, form)))
    bh, bl = (x.double() for x in tf32_split(_as_kn(b, form)))
    out = ((al @ bh + ah @ bl) + ah @ bh).float()
    if bias is not None:
        out = out + (bias[:, None] if bias.dim() == 2 else bias)
    return out


def _product(a, b, form: str, bias, c_fn: str):
    """Check the operands and launch ``c_fn`` (``icee_tf32x3_gemm`` or
    ``icee_f32_gemm``) on them -> C (batch, M, N) or (M, N), contiguous.
    Operands may be strided views whose rows are contiguous: a 3-D
    operand's batch offset is its leading stride."""
    batch, m, n, k = _product_dims(a, b, form)
    device = a.device
    for name, x in (("a", a), ("b", b), ("bias", bias)):
        if x is None:
            continue
        if x.device != device:
            raise ValueError(f"{name}: on {x.device}, expected {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype}, expected float32")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: rows must be contiguous")
    if bias is not None and tuple(bias.shape) not in ((n,), (batch, n)):
        raise ValueError(f"bias: shape {tuple(bias.shape)}, expected ({n},) "
                         f"or ({batch}, {n})")
    if device.type != "cuda":
        raise ValueError(f"{c_fn}: unsupported device {device}")
    lib = _library()
    batched = a.dim() == 3 or b.dim() == 3
    out = torch.empty(((batch,) if batched else ()) + (m, n),
                      dtype=torch.float32, device=device)
    ptr = cuda_lib.ptr
    offs = [x.stride(0) if x is not None and x.dim() == 3 else 0
            for x in (a, b)]
    zbias = bias.stride(0) if bias is not None and bias.dim() == 2 else 0
    args = [ord(form), ptr(a), a.stride(-2), ptr(b), b.stride(-2), ptr(out),
            n, ctypes.c_void_p(0) if bias is None else ptr(bias), m, n, k,
            batch, offs[0], offs[1], m * n, zbias]
    if c_fn == "icee_tf32x3_gemm":   # split-K partials, stream-ordered
        part = torch.empty((max(1, lib.icee_tf32x3_part_floats(
            m, n, k, batch)),), dtype=torch.float32, device=device)
        args.append(ptr(part))
    rc = getattr(lib, c_fn)(*args, cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, f"{c_fn} (form {form})")
    return out


def tf32x3_product(a, b, form: str = "N", bias=None):
    """C = op(a) op(b) [+ bias] at float32 accuracy on the tensor cores
    (``csrc/gemm_tf32x3.cuh``, the product every K5 launch runs), forms as
    :func:`_product_dims`; ``bias`` (N,) or (batch, N).  On the CPU the
    plain version runs; on CUDA the kernel, counted in
    ``tf32x3_product.launches``."""
    if a.device.type == "cpu":
        return tf32x3_product_plain(a, b, form, bias)
    out = _product(a, b, form, bias, "icee_tf32x3_gemm")
    tf32x3_product.launches += 1
    return out


tf32x3_product.launches = 0


def f32_product(a, b, form: str = "N", bias=None):
    """The same product on the CUDA cores (``csrc/gemm_f32.cuh``'s
    ``gemm``, one float32 fmaf chain per output), CUDA only: the yardstick
    that :func:`tf32x3_product`'s error is held to on the card."""
    return _product(a, b, form, bias, "icee_f32_gemm")


# --- kernel wrappers ---------------------------------------------------------

def _kernel_weights(cell: dict, att: dict, kind: str):
    """-> (W_cat (H, A + FS + 4H) = [dec_w | fb_w | recurrent W], b_cat =
    [dec_b | fb_b | 0], the input matrix [V_we ; V_wc] or [W_ihe ; W_ihc]
    (E + FS, 4F or 4H), its bias, the recurrent bias the gates add)."""
    if kind == "factored":
        rec, in_w, in_b, rec_b = (cell["W_w"], (cell["V_we"], cell["V_wc"]),
                                  cell["V_b"], cell["W_b"])
    else:
        rec, in_w, in_b, rec_b = (cell["W_hh"], (cell["W_ihe"],
                                                 cell["W_ihc"]),
                                  cell["b_ih"], cell["b_hh"])
    w_cat = torch.cat([att["dec_w"], att["fb_w"], rec], dim=1).contiguous()
    b_cat = torch.cat([att["dec_b"], att["fb_b"],
                       torch.zeros_like(rec[0])]).contiguous()
    return (w_cat, b_cat, torch.cat(in_w).contiguous(), in_b.contiguous(),
            rec_b.contiguous())


def _time_major(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(0, 1).contiguous()


def _check_card(dims, att1, features, att: dict) -> None:
    """What the CUDA kernels take beyond the shapes: A and FS multiples of
    4 and 16-byte aligned rows (they read att1, the features and full_w as
    float4)."""
    a, fs = dims[5], dims[7]
    if a % 4 or fs % 4:
        raise ValueError(f"att_scan: A={a} and FS={fs} must be multiples "
                         f"of 4 for the CUDA kernels")
    for name, ten in (("att1", att1), ("features", features),
                      ("full_w", att["full_w"])):
        if ten.data_ptr() % 16:
            raise ValueError(f"att_scan: {name} must be 16-byte aligned")


def att_scan_fwd(cell: dict, att: dict, emb_seq, att1, features, h0, c0,
                 kind: str = "factored", samp: Optional[dict] = None):
    """K5 forward -> (h_seq (B, T, H), alphas (B, T, P), res).  ``res``
    holds ``c_seq`` (B, T, H), ``pidx`` (T, B) (the argmax trace; None when
    teacher-forced) and, on CUDA, the buffers the kernel backward reads.
    ``samp``: None (teacher-forced) or ``{"head", "emb_raw", "coins" (T,)
    float32 of 0/1}`` for the scheduled-sampling scan."""
    dims = check_scan_inputs(cell, att, emb_seq, att1, features, h0, c0,
                             kind)
    device = emb_seq.device
    v = None if samp is None else check_samp(samp, dims, device)
    if device.type == "cpu":
        if samp is None:
            h_seq, alphas, c_seq = fused_att_scan_plain(
                cell, att, emb_seq, att1, features, h0, c0, kind)
            return h_seq, alphas, {"c_seq": c_seq, "pidx": None}
        h_seq, alphas, c_seq, pidx = fused_att_scan_sampled_plain(
            cell, att, samp["head"], emb_seq, samp["emb_raw"], att1,
            features, h0, c0, samp["coins"], kind)
        return h_seq, alphas, {"c_seq": c_seq, "pidx": pidx}
    if device.type != "cuda":
        raise ValueError(f"att_scan_fwd: unsupported device {device}")
    _check_card(dims, att1, features, att)
    b, t, e, f, h, a, p, fs = dims
    lstm = kind == "lstm"
    ncat, g4 = a + fs + 4 * h, 4 * (h if lstm else f)
    w_cat, b_cat, in_w, in_b, rec_b = _kernel_weights(cell, att, kind)
    f32 = dict(dtype=torch.float32, device=device)
    buf = {"h": torch.empty((t + 1, b, h), **f32),
           "c": torch.empty((t + 1, b, h), **f32),
           "alpha": torch.empty((t, b, p), **f32),
           "x": torch.empty((t, b, e + fs), **f32),
           "hp": torch.empty((t, b, ncat), **f32),
           "ctx": torch.empty((t, b, fs), **f32),
           "z": torch.empty((t, b, 4 * h), **f32)}
    buf["h"][0].copy_(h0)
    buf["c"][0].copy_(c0)
    if not lstm:
        buf["v"] = torch.empty((t, b, g4), **f32)
        buf["s"] = torch.empty((t, b, g4), **f32)
    lib = _library()
    part = torch.empty((lib.icee_att_scan_part_floats(
        int(lstm), b, t, e, f, h, a, fs, v or 0),), **f32)
    null = ctypes.c_void_p(0)
    ptr = cuda_lib.ptr
    if samp is None:
        samp_ptrs = (null,) * 7
        pidx = None
    else:
        head = samp["head"]
        pidx = torch.empty((t, b), dtype=torch.int32, device=device)
        pemb = samp["emb_raw"][:, 0].clone(  # the kernel overwrites it
            memory_format=torch.contiguous_format)
        logits = torch.empty((b, v), **f32)
        samp_ptrs = (ptr(samp["coins"]), ptr(head["C_w"]), ptr(head["C_b"]),
                     ptr(head["B"]), ptr(pemb), ptr(logits), ptr(pidx))
    cell_ptrs = ((null,) * 4 if lstm else
                 tuple(ptr(cell[k]) for k in ("S_w", "S_b", "U_w", "U_b")))
    emb_t = _time_major(emb_seq)   # held: the kernel reads it
    rc = lib.icee_att_scan_fwd(
        int(lstm), ptr(emb_t), ptr(att1), ptr(features),
        ptr(w_cat), ptr(b_cat), ptr(att["full_w"]), ptr(att["full_b"]),
        ptr(in_w), ptr(in_b), *cell_ptrs, ptr(rec_b), *samp_ptrs,
        ptr(buf["h"]), ptr(buf["c"]), ptr(buf["alpha"]), ptr(buf["x"]),
        ptr(buf["hp"]), ptr(buf["ctx"]), ptr(buf["z"]),
        ptr(buf["v"]) if not lstm else null,
        ptr(buf["s"]) if not lstm else null, ptr(part),
        b, t, e, f, h, a, p, fs, v or 0, cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, f"att_scan_fwd (kind={kind})")
    name = counter_name(kind, samp is not None)
    setattr(att_scan_fwd, name, getattr(att_scan_fwd, name) + 1)
    h_seq = _time_major(buf["h"][1:])
    alphas = _time_major(buf["alpha"])
    return h_seq, alphas, {"c_seq": _time_major(buf["c"][1:]), "pidx": pidx,
                           "buf": buf}


def att_scan_bwd(cell: dict, att: dict, emb_seq, att1, features, h0, c0,
                 h_seq, alphas, res: dict, dh_seq, dalpha_seq,
                 kind: str = "factored", samp: Optional[dict] = None
                 ) -> Dict[str, object]:
    """K5 backward -> {"cell", "att": grads by name, "emb_seq" (B, T, E),
    "att1", "h0", "c0"}, plus ``"head"`` ({C_w, C_b: zero, B}) and
    ``"emb_raw"`` for the sampled scan.  The features and coins grads are
    zero by contract and not returned.  ``res`` is :func:`att_scan_fwd`'s.
    On the CPU the plain backward runs; on CUDA the kernels, from the
    forward's buffers."""
    dims = check_scan_inputs(cell, att, emb_seq, att1, features, h0, c0,
                             kind)
    b, t, e, f, h, a, p, fs = dims
    device = emb_seq.device
    v = None if samp is None else check_samp(samp, dims, device)
    for name, ten, shape in (("h_seq", h_seq, (b, t, h)),
                             ("alphas", alphas, (b, t, p)),
                             ("dh_seq", dh_seq, (b, t, h)),
                             ("dalpha_seq", dalpha_seq, (b, t, p))):
        cuda_lib.check_tensor(name, ten, shape, torch.float32, device)
    pidx = res["pidx"]
    if samp is not None and (pidx is None or tuple(pidx.shape) != (t, b)):
        raise ValueError("att_scan_bwd: the sampled backward needs the "
                         "forward's token trace res['pidx'] (T, B)")
    if device.type == "cpu":
        return att_scan_grads_plain(cell, att, emb_seq, att1, features, h0,
                                    c0, h_seq, alphas, res, dh_seq,
                                    dalpha_seq, kind, samp)
    if device.type != "cuda":
        raise ValueError(f"att_scan_bwd: unsupported device {device}")
    if "buf" not in res:
        raise ValueError("att_scan_bwd: the kernel backward reads the "
                         "kernel forward's buffers (res['buf'])")
    _check_card(dims, att1, features, att)
    buf = res["buf"]
    lstm = kind == "lstm"
    ncat, g4 = a + fs + 4 * h, 4 * (h if lstm else f)
    w_cat, _, in_w, _, _ = _kernel_weights(cell, att, kind)
    f32 = dict(dtype=torch.float32, device=device)
    lib = _library()
    n_fw = lib.icee_att_scan_fw_part_floats(b, t, p, a)
    if n_fw < 0:
        raise ValueError(f"att_scan_bwd: T={t} x A={a} does not fit the "
                         f"d_att1 pass's shared memory")
    sc = {"demb": torch.empty((t, b, e), **f32),
          "dsamp": torch.empty((t, b, e), **f32) if samp is not None
          else None,
          "dcat": torch.empty((t, b, ncat), **f32),
          "dx": torch.empty((b, e + fs), **f32),
          "de": torch.empty((t, b, p), **f32),
          "dh": torch.empty((b, h), **f32),
          "dc": torch.empty((b, h), **f32),
          "part": torch.empty((lib.icee_att_scan_part_floats(
              int(lstm), b, t, e, f, h, a, fs, 0),), **f32),
          "fw_part": torch.empty((n_fw,), **f32)}
    if not lstm:
        sc["ds"] = torch.empty((t, b, g4), **f32)
        sc["dv"] = torch.empty((t, b, g4), **f32)
    g = {"w_cat": torch.empty((h, ncat), **f32),
         "b_cat": torch.empty((ncat,), **f32),
         "att1": torch.empty((b, p, a), **f32),
         "full_w": torch.empty((a,), **f32),
         "full_b": torch.empty((1,), **f32),
         "in_w": torch.empty((e + fs, g4), **f32)}
    if not lstm:
        g.update(V_b=torch.empty((4, f), **f32),
                 S_w=torch.empty((4, f, f), **f32),
                 S_b=torch.empty((4, f), **f32),
                 U_w=torch.empty((4, f, h), **f32))
    null = ctypes.c_void_p(0)
    ptr = cuda_lib.ptr

    def opt(x):
        return null if x is None else ptr(x)

    dh_t, dalpha_t = _time_major(dh_seq), _time_major(dalpha_seq)
    rc = lib.icee_att_scan_bwd(
        int(lstm), ptr(att1), ptr(features), ptr(w_cat), ptr(att["full_w"]),
        ptr(in_w), opt(cell.get("S_w")), opt(cell.get("U_w")),
        opt(None if samp is None else samp["coins"]),
        ptr(buf["h"]), ptr(buf["c"]), ptr(buf["alpha"]), ptr(buf["x"]),
        ptr(buf["hp"]), ptr(buf["ctx"]), ptr(buf["z"]), opt(buf.get("v")),
        opt(buf.get("s")), ptr(dh_t), ptr(dalpha_t), ptr(sc["demb"]),
        opt(sc["dsamp"]),
        ptr(sc["dcat"]), opt(sc.get("ds")), opt(sc.get("dv")), ptr(sc["dx"]),
        ptr(sc["de"]), ptr(sc["dh"]), ptr(sc["dc"]), ptr(sc["part"]),
        ptr(sc["fw_part"]), ptr(g["att1"]), ptr(g["w_cat"]),
        ptr(g["b_cat"]), ptr(g["full_w"]), ptr(g["full_b"]), ptr(g["in_w"]),
        opt(g.get("V_b")), opt(g.get("S_w")), opt(g.get("S_b")),
        opt(g.get("U_w")), b, t, e, f, h, a, p, fs,
        cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, f"att_scan_bwd (kind={kind})")
    name = counter_name(kind, samp is not None)
    setattr(att_scan_bwd, name, getattr(att_scan_bwd, name) + 1)
    w_cat_g, b_cat_g = g["w_cat"], g["b_cat"]
    dz_sum = b_cat_g[a + fs:]
    datt = {"dec_w": w_cat_g[:, :a], "dec_b": b_cat_g[:a],
            "full_w": g["full_w"][:, None], "full_b": g["full_b"],
            "fb_w": w_cat_g[:, a:a + fs], "fb_b": b_cat_g[a:a + fs]}
    if lstm:
        dcell = {"W_ihe": g["in_w"][:e], "W_ihc": g["in_w"][e:],
                 "W_hh": w_cat_g[:, a + fs:], "b_ih": dz_sum,
                 "b_hh": dz_sum.clone()}
    else:
        dcell = {"V_we": g["in_w"][:e], "V_wc": g["in_w"][e:],
                 "V_b": g["V_b"], "S_w": g["S_w"], "S_b": g["S_b"],
                 "U_w": g["U_w"], "U_b": dz_sum.view(4, h),
                 "W_w": w_cat_g[:, a + fs:], "W_b": dz_sum.view(4, h).clone()}
    out = {"cell": dcell, "att": datt, "emb_seq": _time_major(sc["demb"]),
           "att1": g["att1"], "h0": sc["dh"], "c0": sc["dc"]}
    if samp is not None:
        d_b = torch.empty_like(samp["head"]["B"])
        rc = lib.icee_scatter_rows(ptr(pidx), ptr(sc["dsamp"][1:]),
                                   (t - 1) * b, e, v, ptr(d_b),
                                   cuda_lib.stream_ptr(device))
        cuda_lib.check_rc(lib, rc, "att_scan_bwd (token scatter)")
        out["head"] = {"C_w": torch.zeros_like(samp["head"]["C_w"]),
                       "C_b": torch.zeros_like(samp["head"]["C_b"]),
                       "B": d_b}
        out["emb_raw"] = _emb_raw_grad(sc["dsamp"][0], samp["emb_raw"])
    return out


for _fn in (att_scan_fwd, att_scan_bwd):
    for _kind in KINDS:
        for _sampled in (False, True):
            setattr(_fn, counter_name(_kind, _sampled), 0)


# --- autograd ----------------------------------------------------------------

def _unpack(kind: str, weights):
    keys = cell_keys(kind)
    return (dict(zip(keys, weights[:len(keys)])),
            dict(zip(ATT_KEYS, weights[len(keys):])))


def _weight_grads(kind: str, grads: dict):
    return (tuple(grads["cell"][k] for k in cell_keys(kind))
            + tuple(grads["att"][k] for k in ATT_KEYS))


def _res_tensors(res: dict):
    """res -> (names, tensors) to save for backward."""
    items = [("c_seq", res["c_seq"])]
    if res["pidx"] is not None:
        items.append(("pidx", res["pidx"]))
    items += [("buf." + k, v) for k, v in res.get("buf", {}).items()]
    return [k for k, _ in items], [v for _, v in items]


def _res_dict(names, tensors) -> dict:
    res = {"pidx": None}
    for k, v in zip(names, tensors):
        if k.startswith("buf."):
            res.setdefault("buf", {})[k[4:]] = v
        else:
            res[k] = v
    return res


class _AttScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kind, emb_seq, att1, features, h0, c0, *weights):
        cell, att = _unpack(kind, weights)
        h_seq, alphas, res = att_scan_fwd(cell, att, emb_seq, att1, features,
                                          h0, c0, kind)
        names, saved = _res_tensors(res)
        ctx.kind, ctx.names = kind, names
        ctx.save_for_backward(emb_seq, att1, features, h0, c0, h_seq, alphas,
                              *weights, *saved)
        return h_seq, alphas

    @staticmethod
    def backward(ctx, dh_seq, dalpha_seq):
        emb_seq, att1, features, h0, c0, h_seq, alphas, *rest = \
            ctx.saved_tensors
        n_w = len(cell_keys(ctx.kind)) + len(ATT_KEYS)
        cell, att = _unpack(ctx.kind, rest[:n_w])
        res = _res_dict(ctx.names, rest[n_w:])
        g = att_scan_bwd(cell, att, emb_seq, att1, features, h0, c0, h_seq,
                         alphas, res, dh_seq.contiguous(),
                         dalpha_seq.contiguous(), ctx.kind)
        d_feat = (torch.zeros_like(features) if ctx.needs_input_grad[3]
                  else None)
        return (None, g["emb_seq"], g["att1"], d_feat, g["h0"], g["c0"],
                *_weight_grads(ctx.kind, g))


class _AttScanSampled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kind, emb_seq, emb_raw, att1, features, h0, c0, coins,
                c_w, c_b, b_emb, *weights):
        cell, att = _unpack(kind, weights)
        samp = {"head": {"C_w": c_w, "C_b": c_b, "B": b_emb},
                "emb_raw": emb_raw, "coins": coins}
        h_seq, alphas, res = att_scan_fwd(cell, att, emb_seq, att1, features,
                                          h0, c0, kind, samp)
        names, saved = _res_tensors(res)
        ctx.kind, ctx.names = kind, names
        ctx.save_for_backward(emb_seq, emb_raw, att1, features, h0, c0,
                              coins, c_w, c_b, b_emb, h_seq, alphas,
                              *weights, *saved)
        return h_seq, alphas

    @staticmethod
    def backward(ctx, dh_seq, dalpha_seq):
        (emb_seq, emb_raw, att1, features, h0, c0, coins, c_w, c_b, b_emb,
         h_seq, alphas, *rest) = ctx.saved_tensors
        n_w = len(cell_keys(ctx.kind)) + len(ATT_KEYS)
        cell, att = _unpack(ctx.kind, rest[:n_w])
        res = _res_dict(ctx.names, rest[n_w:])
        samp = {"head": {"C_w": c_w, "C_b": c_b, "B": b_emb},
                "emb_raw": emb_raw, "coins": coins}
        g = att_scan_bwd(cell, att, emb_seq, att1, features, h0, c0, h_seq,
                         alphas, res, dh_seq.contiguous(),
                         dalpha_seq.contiguous(), ctx.kind, samp)
        need = ctx.needs_input_grad
        d_feat = torch.zeros_like(features) if need[4] else None
        d_coins = torch.zeros_like(coins) if need[7] else None
        return (None, g["emb_seq"], g["emb_raw"], g["att1"], d_feat, g["h0"],
                g["c0"], d_coins, g["head"]["C_w"], g["head"]["C_b"],
                g["head"]["B"], *_weight_grads(ctx.kind, g))


def fused_att_scan(cell: dict, att: dict, emb_seq, att1, features, h0, c0,
                   kind: str = "factored"):
    """Teacher-forced attention-decoder chain -> (h_seq (B, T, H), alphas
    (B, T, P)), differentiable in every input but ``features`` (zero
    cotangent).  Matches the ratio >= 1 branch of
    :func:`~icee_tpu_torch.models.attention.factored_att_forward_hiddens`."""
    weights = (tuple(cell[k] for k in cell_keys(kind))
               + tuple(att[k] for k in ATT_KEYS))
    return _AttScan.apply(kind, emb_seq, att1, features, h0, c0, *weights)


def fused_att_scan_sampled(cell: dict, att: dict, head: dict, emb_seq,
                           emb_raw, att1, features, h0, c0, coins,
                           kind: str = "factored"):
    """Scheduled-sampling attention scan -> (h_seq, alphas): per step the
    teacher's embedding (``coins[t] == 1``) or the raw embedding of the
    previous step's argmax token (``model_att.py:285-290``).  ``emb_seq``:
    teacher embeddings with dropout; ``emb_raw`` (B, 1 or T, E): dropout-free
    embeddings, column 0 the t = 0 bootstrap; ``coins`` (T,) float32 0/1.
    Cotangents: C_w, C_b, coins and features zero; B the sampled steps'
    scatter; emb_raw step 0's sampled share."""
    weights = (tuple(cell[k] for k in cell_keys(kind))
               + tuple(att[k] for k in ATT_KEYS))
    return _AttScanSampled.apply(kind, emb_seq, emb_raw, att1, features, h0,
                                 c0, coins, head["C_w"], head["C_b"],
                                 head["B"], *weights)


def _library() -> ctypes.CDLL:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    product = [i, vp, ll, vp, ll, vp, ll, vp] + [i] * 4 + [ll] * 4
    return cuda_lib.library("att_scan", {
        "icee_att_scan_fwd": ([i] + [vp] * 31 + [i] * 9 + [vp], i),
        "icee_att_scan_bwd": ([i] + [vp] * 40 + [i] * 8 + [vp], i),
        "icee_scatter_rows": ([vp, vp, i, i, i, vp, vp], i),
        "icee_att_scan_part_floats": ([i] * 9, ll),
        "icee_att_scan_fw_part_floats": ([i] * 4, ll),
        "icee_tf32x3_part_floats": ([i] * 4, ll),
        "icee_tf32x3_gemm": (product + [vp, vp], i),
        "icee_f32_gemm": (product + [vp], i)})
