"""Roofline bytes are the function's, counted from the operator's own
shape: the same for its DIA and ELL forms."""

import torch
from harness import roofline
from hypre_tpu_torch.problems.laplacian import laplacian_3d_7pt
from hypre_tpu_torch.seq.dia import try_dia


def test_function_bytes_of_a_hand_counted_operator():
    # 7-pt Laplacian on 2x2x2: 8 rows, each a corner with 3 neighbours
    ell = laplacian_3d_7pt(2, 2, 2, dtype=torch.float32, device="cpu")
    dia = try_dia(ell)
    assert dia is not None and type(dia).__name__ == "DiaMatrix"
    nnz = 8 + 8 * 3
    assert roofline.stored_nonzeros(ell) == nnz
    assert roofline.stored_nonzeros(dia) == nnz
    # y (8) + x (min(32, 8)) + one value a nonzero, 4 bytes each; a
    # stencil's pattern is its offsets, so no column is counted
    assert roofline.spmv_bytes(8, 8, nnz, 4, stencil=True) == 4 * (8 + 8 + 32)
    # an operator with no stencil adds one int32 column a nonzero
    assert roofline.spmv_bytes(8, 8, nnz, 4, stencil=False) == \
        4 * (8 + 8 + 32) + 4 * 32
    assert roofline.spmv_flops(nnz) == 64


def test_least_time_takes_the_larger_bound():
    kind = "NVIDIA H100 80GB HBM3"
    t = roofline.bound_s(3.35e12, 1.0, "float32", kind)
    assert abs(t - 1.0) < 1e-12
    assert roofline.bound_s(1.0, 67e12, "float32", kind) == 1.0
    assert roofline.bound_s(1.0, 1.0, "float32", "another card") is None
