"""Operation and byte counts against hand counts on tiny inputs."""
import pytest

from portbench import roofline


def test_decode_counts():
    # D=1, W=2, V=3: a row's step 2 * (1 * 4 * 8 + 2 * 3) = 76 FLOPs
    assert roofline.decode_row_flops(1, 2, 3) == 76
    # 5 positions, K=2: 10 rows
    assert roofline.decode_page(5, 2, 1, 2, 3) == 760
    # weights 2*3*2 + (4*8 + 8) = 52 words; 7 alternative slots * 2; 3*2*5
    assert roofline.decode_launch_bytes(1, 2, 3, 5, 7, 2) == 4 * (
        52 + 14 + 30)


def test_lstm_counts():
    # B=2, T=3, W=1: 2*2*3*1*4 = 48 FLOPs
    flops, nbytes = roofline.lstm_scan(2, 3, 1, c_all=False)
    assert flops == 48
    # x_proj 24, carry 4, U 4, h_all 6, final carry 4
    assert nbytes == 4 * (24 + 4 + 4 + 6 + 4)
    assert roofline.lstm_scan(2, 3, 1, c_all=True)[1] == nbytes + 4 * 6
    flops, nbytes = roofline.lstm_bwd(2, 3, 1)
    assert flops == 144
    # in: x_proj 24, h_all 6, c_all 6, carry 4, dh_all 6, dcarry 4, U 4;
    # out: dx_proj 24, dU 4, dcarry 4
    assert nbytes == 4 * (24 + 6 + 6 + 4 + 6 + 4 + 4 + 24 + 4 + 4)
    # a row fed a char: D=2, W=1, input 3, V=5:
    # 2 * (3*4 + 1*4 + 2*1*4 + 1*5) = 58
    assert roofline.lstm_row_flops(2, 1, 3, 5) == 58


def test_generation_counts():
    # fringe 4, topk 2, 4 steps: rows 1, 2, 4, 4
    flops, nbytes = roofline.gen_request(4, 4, 2, 1, 2, 3)
    assert flops == 11 * 76
    assert nbytes == 4 * (12 + 40 + 3 * 4 * 4)


def test_least_time():
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(989e12, 0, 989e12) == pytest.approx(1.0)
