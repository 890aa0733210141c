"""The plain version of K5's tensor-core product (``csrc/gemm_tf32x3.cuh``):
``tf32x3_product_plain`` in ``icee_tpu_torch/ops/att_scan.py``.

The kernel splits each float32 operand into TF32 hi and lo parts
(``cvt.rna.tf32.f32``: to nearest, ties away from zero, 10 mantissa bits)
and sums lo_a hi_b + hi_a lo_b + hi_a hi_b.  These tests hold the
emulation's rounding on edge cases, the split's reconstruction, and its
error against float64 at the depth and form of every product K5 launches:
it must be at most 2x that of ``torch.matmul`` in float32 on the same
inputs.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from icee_tpu_torch.ops import att_scan


def _f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))


def _bits(x):
    return x.numpy().view(np.uint32).tolist()


@pytest.mark.parametrize("sign", [0, 0x80000000])
def test_tf32_round_goes_to_nearest_and_ties_away_from_zero(sign):
    one = 0x3F800000
    x = _f32([sign | b for b in (
        one,               # already TF32
        one | 0x1000,      # exactly half a TF32 ulp above: tie, away
        one | 0x0FFF,      # just below the tie: down
        one | 0x1001,      # just above: up
        one | 0x2000,      # already TF32 (last kept bit set)
        one | 0x3000,      # tie above an odd TF32 value: away, not even
        0x3FFFF000,        # tie at the top of a binade: carries into the
    )])                    # exponent (2.0)
    want = [sign | b for b in (one, one | 0x2000, one, one | 0x2000,
                               one | 0x2000, one | 0x4000, 0x40000000)]
    assert _bits(att_scan.tf32_round(x)) == want


def test_tf32_round_keeps_tf32_values_subnormals_and_non_finite():
    tf32 = _f32([0x00000000, 0x80000000, 0x40490000, 0xC2F6E000,
                 0x00002000, 0x807FE000, 0x7F7FE000])
    assert _bits(att_scan.tf32_round(tf32)) == _bits(tf32)
    # subnormals round on the same bit pattern: a tie goes away from zero,
    # below half of the least TF32 subnormal (2^-136) goes to zero
    sub = _f32([0x00001000, 0x80001000, 0x00000FFF, 0x00003000])
    assert _bits(att_scan.tf32_round(sub)) == [0x00002000, 0x80002000, 0,
                                                0x00004000]
    # the largest float32 rounds up to infinity; inf and nan pass through
    big = _f32([0x7F7FFFFF, 0xFF7FFFFF])
    assert att_scan.tf32_round(big).tolist() == [float("inf"),
                                                 float("-inf")]
    odd = torch.tensor([float("inf"), float("-inf"), float("nan")])
    out = att_scan.tf32_round(odd)
    assert out[:2].tolist() == odd[:2].tolist() and out[2].isnan()


def test_tf32_split_reconstructs_within_2_pow_minus_22():
    rng = np.random.default_rng(0)
    x = torch.tensor((rng.standard_normal(100_000)
                      * np.exp2(rng.integers(-60, 60, 100_000))).astype(
                          np.float32))
    hi, lo = att_scan.tf32_split(x)
    for part in (hi, lo):   # both TF32: the 13 low bits clear
        assert not np.any(part.numpy().view(np.uint32) & 0x1FFF)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert torch.all(err <= 2.0 ** -22 * x.double().abs())
    assert torch.all(lo.abs() <= 2.0 ** -11 * x.abs())


# (form, M, N, K, batch): every product K5 launches, at B = 128 and the
# flagship widths (E = 300, F = H = A = 512, FS = 2048, E + FS = 2348, A +
# FS + 4H = 4608, V = 8192); the weight grads' M and N cut to 512 (their
# depth, T B = 3200 rows, is what the error grows with)
K5_PRODUCTS = {
    "h_dec_fb_W": ("N", 128, 4608, 512, 1),
    "x_Win": ("N", 128, 2048, 2348, 1),
    "S_U": ("N", 128, 512, 512, 4),
    "head": ("N", 128, 8192, 512, 1),
    "ds_dv": ("T", 128, 512, 512, 4),
    "dx": ("T", 128, 2348, 2048, 1),
    "dh": ("T", 128, 512, 4608, 1),
    "weight_grads": ("A", 512, 512, 3200, 1),
}


def _operands(form, m, n, k, batch, seed):
    """a (activations, U(-1, 1)) and b (weights, N(0, 0.05^2)) in the
    layout of ``form``, batched as K5's S / U / ds / dv products are: the
    batch entries interleaved along the rows (leading stride m, n or k)."""
    rng = np.random.default_rng(seed)
    a_rows, a_cols = (k, m) if form == "A" else (m, k)
    b_rows, b_cols = (n, k) if form == "T" else (k, n)
    a = torch.tensor(rng.uniform(-1, 1, (a_rows, batch * a_cols)).astype(
        np.float32))
    b = torch.tensor((0.05 * rng.standard_normal(
        (batch, b_rows, b_cols))).astype(np.float32))
    if batch == 1:
        return a, b[0]
    return a.view(a_rows, batch, a_cols).transpose(0, 1), b


@pytest.mark.parametrize("name", sorted(K5_PRODUCTS))
def test_emulated_product_error_is_at_most_twice_float32s(name):
    form, m, n, k, batch = K5_PRODUCTS[name]
    a, b = _operands(form, m, n, k, batch, seed=len(name))
    a_mk, b_kn = att_scan._as_mk(a, form), att_scan._as_kn(b, form)
    ref = a_mk.double() @ b_kn.double()
    got = att_scan.tf32x3_product_plain(a, b, form)
    assert got.dtype == torch.float32
    assert got.shape == ((batch,) if batch > 1 else ()) + (m, n)
    err = (got.double() - ref).abs().max().item()
    err_f32 = ((a_mk @ b_kn).double() - ref).abs().max().item()
    assert 0.0 < err <= 2.0 * err_f32, (err, err_f32)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    a, b = _operands("T", 5, 7, 33, 3, seed=1)
    bias = torch.randn(3, 7)
    before = att_scan.tf32x3_product.launches
    got = att_scan.tf32x3_product(a, b, "T", bias)
    assert att_scan.tf32x3_product.launches == before   # no kernel launch
    want = torch.stack([att_scan.tf32x3_product_plain(a[z], b[z], "T")
                        + bias[z] for z in range(3)])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    shared = att_scan.tf32x3_product(a, b[0], "T", bias[0])   # 2-D b
    assert shared.shape == (3, 5, 7)


@pytest.mark.parametrize("form,a_shape,b_shape", [
    ("X", (2, 3), (3, 4)),          # unknown form
    ("N", (2, 3), (4, 5)),          # K does not chain
    ("A", (3, 2), (4, 5)),
    ("T", (2, 3), (5, 4)),
    ("N", (2, 2, 3), (3, 3, 4)),    # batch sizes differ
    ("N", (3,), (3, 4)),            # 1-D
])
def test_wrapper_raises_on_shapes_that_do_not_chain(form, a_shape, b_shape):
    with pytest.raises(ValueError):
        att_scan.tf32x3_product(torch.zeros(a_shape), torch.zeros(b_shape),
                                form)
