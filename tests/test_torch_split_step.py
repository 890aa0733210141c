"""The K1 and K6 wrappers' weight-validation memo (``cuda_lib.checked_weights``)
on the CPU: a decode loop validates its weight dicts once, and any change to
them -- a tensor replaced, a tensor changed in place, another kind or width
-- validates them again, so a weight the kernels cannot take still raises.
The column-split kernels themselves run on the card only
(``tests/test_torch_cuda.py``, marker ``cuda``)."""

import numpy as np
import pytest
import torch

from icee_tpu_torch.ops import att_decode_step, cuda_lib
from icee_tpu_torch.ops.decode_step import (decode_step_topk,
                                            decode_step_topk_plain)


def _decoder(vocab=40, e=6, f=8, h=12, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return torch.tensor(0.3 * rng.standard_normal(shape),
                            dtype=torch.float32)

    return {"B": w(vocab, e), "V_w": w(e, 4 * f), "V_b": w(4, f),
            "S_w": w(4, 4, f, f), "S_b": w(4, 4, f), "U_w": w(4, f, h),
            "U_b": w(4, h), "W_w": w(h, 4 * h), "W_b": w(4, h),
            "C_w": w(h, vocab), "C_b": w(vocab)}


def _counting():
    calls = []

    def check():
        calls.append(1)
        return len(calls)

    return calls, check


def test_checked_weights_validates_a_weight_set_once():
    params = _decoder()
    calls, check = _counting()
    for _ in range(5):
        assert cuda_lib.checked_weights((params,), ("k", 1), check) == 1
    assert len(calls) == 1
    # another key (style, device, kind) is validated apart
    assert cuda_lib.checked_weights((params,), ("k", 2), check) == 2


@pytest.mark.parametrize("change", ["replace", "in_place", "new_key"])
def test_checked_weights_validates_again_after_a_change(change):
    params = _decoder()
    calls, check = _counting()
    cuda_lib.checked_weights((params,), ("k",), check)
    if change == "replace":
        params["C_w"] = params["C_w"].clone()
    elif change == "in_place":
        params["C_w"].add_(1.0)
    else:
        params["extra"] = torch.zeros(1)
    cuda_lib.checked_weights((params,), ("k",), check)
    assert len(calls) == 2


def test_checked_weights_keeps_nothing_when_the_check_raises():
    params = _decoder()

    def bad():
        raise ValueError("bad weights")

    for _ in range(2):
        with pytest.raises(ValueError, match="bad weights"):
            cuda_lib.checked_weights((params,), ("bad",), bad)


def test_decode_step_raises_on_a_weight_replaced_between_steps():
    params = _decoder()
    x, h = torch.randn(3, 6), torch.randn(3, 12)
    got = decode_step_topk(params, x, h, h, 1, ktop=4)
    want = decode_step_topk_plain(params, x, h, h, 1, ktop=4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    params["U_w"] = torch.zeros(4, 8, 10)      # H = 10 against W_w's 12
    with pytest.raises(ValueError, match="U_w"):
        decode_step_topk(params, x, h, h, 1, ktop=4)
    with pytest.raises(ValueError, match="style"):
        decode_step_topk(_decoder(), x, h, h, 4, ktop=4)


def test_att_decode_step_checks_its_inputs_with_the_weights_memoized():
    rng = np.random.default_rng(1)

    def w(*shape):
        return torch.tensor(0.3 * rng.standard_normal(shape),
                            dtype=torch.float32)

    e, h, a, fs, p, vocab, k = 6, 8, 4, 12, 5, 20, 3
    cell = {"W_ih": w(e + fs, 4 * h), "b_ih": w(4 * h), "W_hh": w(h, 4 * h),
            "b_hh": w(4 * h), "C_w": w(h, vocab), "C_b": w(vocab)}
    att = {"dec_w": w(h, a), "dec_b": w(a), "full_w": w(a, 1),
           "full_b": w(1)}
    gate = {"f_beta_w": w(h, fs), "f_beta_b": w(fs)}
    x, hh = w(k, e), w(k, h)
    feats, att1 = w(1, p, fs), w(1, p, a)
    args = (cell, att, gate, x, hh, hh, feats, att1, "lstm", k)
    got = att_decode_step.att_decode_step_topk(*args, ktop=k)
    want = att_decode_step.att_decode_step_topk_plain(*args, ktop=k)
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="att1"):   # weights memoized
        att_decode_step.att_decode_step_topk(
            cell, att, gate, x, hh, hh, feats, w(1, p, a + 4), "lstm", k)
    gate["f_beta_b"] = w(fs + 1)
    with pytest.raises(ValueError, match="f_beta_b"):
        att_decode_step.att_decode_step_topk(*args, ktop=k)
