"""The yardstick's bytes, operations and bounds against hand counts at
small shapes."""

import pytest
import torch

from h100bench import roofline


def test_stage_bytes_hand_count():
    # a 4x3x2 node: 24 cells, halo of 2 layers on the x1 faces (2*2*3*2 =
    # 24 cells) and the x2 faces (2*2*4*2 = 32 cells); 6 variables, 8 bytes
    nx = (4, 3, 2)
    halo = 24 + 32
    # stage 1 of rk2: w and u1 read, u and w written
    assert roofline.stage_bytes([(nx, [0, 1])], 2, 8, False) == (4 * 24 + halo) * 6 * 8
    # a stage that weighs u0 reads it too
    assert roofline.stage_bytes([(nx, [0, 1])], 2, 8, True) == (5 * 24 + halo) * 6 * 8
    # two nodes add; a node with no halo axis reads its interior alone
    assert roofline.stage_bytes([(nx, []), (nx, [])], 2, 4, False) == 2 * 4 * 24 * 6 * 4


def test_halo_cells_every_axis():
    assert roofline.halo_cells((4, 3, 2), 2, [0, 1, 2]) == 2 * 2 * (6 + 8 + 12)


def test_matvec_bytes_and_flops():
    assert roofline.matvec_bytes(10, 8) == 10 * 10 * 8
    # count the plain operator's operations on a small field, as the
    # stage's are counted: (diag + sf) E - sum_d (AH_d E+ + AL_d E-)
    E = torch.rand(2, 3, 4, dtype=torch.float64)
    A = torch.rand(6, 2, 3, 4, dtype=torch.float64)
    diag, sf = torch.rand_like(E), torch.rand_like(E)
    with roofline.FlopCounter() as c:
        out = (diag + sf) * E
        for d in range(3):
            out = (out - A[2 * d + 1] * torch.roll(E, -1, dims=2 - d)
                   - A[2 * d] * torch.roll(E, 1, dims=2 - d))
    assert c.counts["other"] == roofline.MATVEC_FLOPS_PER_CELL * E.numel()


def test_flop_counter_buckets():
    a = torch.ones(10, dtype=torch.float64)
    c = roofline.FlopCounter()
    with c:
        a * 2.0 + a
        with c.bucket_as("stage"):
            torch.sqrt(a)
        torch.where(a > 0, a, a)          # a selection: no operation
    assert c.counts == {"other": 20, "stage": 10}


@pytest.mark.parametrize("dtype, peak", [(torch.float64, 34e12), (torch.float32, 67e12)])
def test_bound_takes_the_larger(dtype, peak):
    t, by = roofline.bound_s(3.35e12, 1.0, dtype)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.bound_s(1.0, 2 * peak, dtype)
    assert t == pytest.approx(2.0) and by == "operations"
