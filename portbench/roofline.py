"""The card's peaks and the least time an amount of work needs on it.

Frozen copy (commit 4cfb97a) of ``chip_smoke.py``'s peak table and
``bound``; the operation and byte counts of ``decode_bound``,
``lstm_train_bound``, ``lstm_bwd_bound`` and ``gen_bound`` are
rewritten here to count from the benchmark's own inputs (page lattices,
batch shapes, prompts) instead of the port's arrays.  Nothing here
imports the port.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W: f32 outside the
# tensor cores, bf16 on them, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
F32 = 4


def least_seconds(flops: float, nbytes: float, bf16_flops: float = 0.0
                  ) -> float:
    """The larger of the operations over their peak (``bf16_flops`` of
    ``flops`` at the bf16 peak, the rest at the f32 peak) and the bytes
    over the memory rate."""
    t_ops = (flops - bf16_flops) / PEAK_F32_FLOPS \
        + bf16_flops / PEAK_BF16_FLOPS
    return max(t_ops, nbytes / PEAK_BYTES)


def lstm_row_flops(D: int, W: int, in0: int, V: int) -> int:
    """FLOPs of one stack step of one row fed a char: the input and
    recurrent products of every layer and the tied logits."""
    return 2 * (in0 * 4 * W + (D - 1) * W * 4 * W + D * W * 4 * W + W * V)


def decode_row_flops(D: int, W: int, V: int) -> int:
    """FLOPs of one beam row at one char position as the decode kernels
    count them (``chip_smoke.decode_bound``): the gate products over
    ``[x | h]`` of every layer (2W inputs each, the context folded into
    the bias) and the logits over the real vocabulary."""
    return 2 * (D * 2 * W * 4 * W + W * V)


def decode_page(n_positions: int, K: int, D: int, W: int, V: int
                ) -> int:
    """FLOPs a page's decode needs: at every char position each of the
    K hypotheses takes one step and one row of logits (the
    distribution is shared by the position's alternatives)."""
    return n_positions * K * decode_row_flops(D, W, V)


def decode_launch_bytes(D: int, W: int, V: int, n_positions: int,
                        n_alt_slots: int, K: int) -> int:
    """Bytes of one decode launch over ``n_positions`` positions: the
    weights (emb and its transpose at V real rows, the fused kernels and
    biases) read once, each alternative slot's char and conf read once,
    the beam's records (3 words a hypothesis a position) written once."""
    weights = 2 * V * W + D * (2 * W * 4 * W + 4 * W)
    return F32 * (weights + 2 * n_alt_slots + 3 * K * n_positions)


def lstm_scan(B: int, T: int, W: int, c_all: bool) -> tuple:
    """(FLOPs, bytes) of one layer's forward scan: 2*B*T*W*4W; x_proj,
    the carry and U read once, h_all (and c_all) and the final carry
    written once."""
    flops = 2 * B * T * W * 4 * W
    nbytes = F32 * (B * T * 4 * W + 2 * B * W + W * 4 * W
                    + B * T * W * (2 if c_all else 1) + 2 * B * W)
    return flops, nbytes


def lstm_bwd(B: int, T: int, W: int) -> tuple:
    """(FLOPs, bytes) of one layer's backward: 6*T*B*W*4W (the gate
    recompute, dz @ U^T, h_prev^T @ dz); x_proj, h_all, c_all, the
    carry, the output gradients and U read once, dx_proj, dU and the
    carry's gradients written once."""
    flops = 6 * T * B * W * 4 * W
    nbytes = F32 * (B * T * 4 * W + 2 * B * T * W + 2 * B * W
                    + B * T * W + 2 * B * W + W * 4 * W
                    + B * T * 4 * W + W * 4 * W + 2 * B * W)
    return flops, nbytes


def gen_request(length: int, fringe: int, topk: int, D: int, W: int,
                V: int) -> tuple:
    """(FLOPs, bytes) of one generation search of ``length`` steps: a
    stack step and a row of logits for every live fringe row (1, then
    at most ``topk`` times the last, capped at ``fringe``: the fringe
    fills in the first steps), the weights read once and a record (char,
    parent, cost) a row and step written once."""
    rows, live = 0, 1
    for _ in range(length):
        rows += live
        live = min(fringe, live * topk)
    flops = rows * decode_row_flops(D, W, V)
    nbytes = F32 * (2 * V * W + D * (2 * W * 4 * W + 4 * W)
                    + 3 * fringe * length)
    return flops, nbytes
