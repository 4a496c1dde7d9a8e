"""The grid layout of the two LSTM training kernels at W=512 (the
forward ``csrc/lstm_scan.cu`` and the backward's chain in
``csrc/lstm_bwd.cu``): host arithmetic only, no card needed.

``scan_layout.choose`` takes it where a gate column has 16 blocks of 32
terms: a group of streams on W/16 blocks, every group of the launch on
the card at once (one block an SM), so the groups are as few as the
card's SMs hold.  ``check`` accepts what the sources accept and refuses
the rest; the register and one-block choices of the other widths stay
as they were.  The wrapper's scratch and the C launch's layout code are
held here too; the kernels themselves run in ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` on the card."""
import pytest
import torch

import chip_smoke
from ocrd_keraslm_torch.ops import lstm_cell as lc
from ocrd_keraslm_torch.ops import scan_layout as sl

torch.set_num_threads(1)

# cluster occupancy of an H100 (the table of test_torch_lstm_scan.py)
H100_FITS = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}


def _fits(lay):
    return H100_FITS[lay.cl]


@pytest.mark.parametrize('kind', ['bwd', 'lstm'])
@pytest.mark.parametrize('B, rb', [(1, 1), (3, 1), (4, 1), (5, 2),
                                   (128, 32), (129, 33), (512, 128),
                                   (2048, 512)])
def test_grid_layout_chosen_at_width_512(kind, B, rb):
    """132 SMs hold 4 groups of 32 blocks: B streams in min(B, 4) groups
    of ceil(B / groups), staged in chunks of up to 8 (bwd) or 16 (lstm)
    streams."""
    for bf16 in (False, True):
        lay = sl.choose(kind, B, 512, 1, _fits, 132, bf16=bf16)
        rt = min(rb, sl.GRID_RT[kind])
        assert lay == sl.Layout(rb, 32, rt,
                                sl.grid_plan_bytes(kind, 512, rb, rt),
                                False)
        assert lay.grid
        assert lay.smem <= sl.SMEM_MAX
        assert sl.waves(B, lay, _fits, 132) == 1
        sl.check(kind, B, 512, 1, lay, bf16=bf16)


def test_grid_plan_bytes():
    """1024 bytes to align the rows, the ring of two chunks of staged
    rows, a chunk's partial sums, in the backward a chunk's gate values
    (8 floats a stream and unit), the group's carried state (c or dc) of
    16 units, and two mbarriers."""
    # lstm: h rows of 512 floats, 16 x 68 partial sums a row
    assert sl.grid_plan_bytes('lstm', 512, 32, 8) == \
        1024 + 4 * (2 * 8 * 512 + 8 * 16 * 68 + 32 * 16) + 16
    # bwd: dz rows of 2048 floats, 4 x 16 x 20 sums a row
    assert sl.grid_plan_bytes('bwd', 512, 32, 4) == \
        1024 + 4 * (2 * 4 * 2048 + 4 * 4 * 16 * 20 + 4 * 16 * 8
                    + 32 * 16) + 16 == 91152
    for kind in ('lstm', 'bwd'):
        for rb in (1, 32, 128, 1024):
            lay = sl.grid_layout_for(kind, 4 * rb, 512, rb)
            assert lay is not None and lay.smem <= sl.SMEM_MAX
    # a chunk's streams: one of a block's 256 threads a stream and unit
    assert max(sl.GRID_RT.values()) <= 256 // sl.GRID_UNITS
    # 1024 streams' dc leave room for chunks of 4 only: 8 halved once
    assert sl.grid_layout_for('bwd', 4096, 512, 1024).rt == 4
    assert sl.grid_plan_bytes('bwd', 512, 1024, 8) > sl.SMEM_MAX


@pytest.mark.parametrize('kind', ['bwd', 'lstm'])
@pytest.mark.parametrize('field, value', [
    ('rb', 0), ('rb', 129),          # 1 <= rb <= B
    ('cl', 16), ('cl', 1),           # W / 16 blocks a group
    ('rt', 2), ('rt', 32),           # min(rb, GRID_RT), halved to fit
    ('smem', 4)])
def test_grid_check_refuses(kind, field, value):
    lay = sl.grid_layout_for(kind, 128, 512, 32)
    sl.check(kind, 128, 512, 1, lay)
    bad = lay._replace(**{field: value})
    if field == 'rb':   # the plan that rb would ask
        bad = bad._replace(smem=sl.grid_plan_bytes(
            kind, 512, value, min(max(value, 1), sl.GRID_RT[kind])))
    if field == 'rt':
        bad = bad._replace(smem=sl.grid_plan_bytes(kind, 512, 32, value))
    # with cl <= 16 the fields read as the one-block layout's, refused too
    with pytest.raises(ValueError, match='grid layout' if field != 'cl'
                       else 'the one-block layout'):
        sl.check(kind, 128, 512, 1, bad)


@pytest.mark.parametrize('kind, W', [('score', 512), ('lstm', 256),
                                     ('bwd', 480), ('bwd', 1024),
                                     ('lstm', 128)])
def test_grid_layout_only_at_width_512(kind, W):
    """Only the forward and the backward's chain, only at W=512: score_scan
    has no grid kernel, other widths another number of 32-term blocks."""
    assert sl.grid_layout_for(kind, 128, W, 32) is None
    lay = sl.choose(kind, 128, W, 2 if kind == 'score' else 1, _fits, 132,
                    Vp=128)
    assert not lay.grid
    with pytest.raises(ValueError):
        sl.check(kind, 128, W, 1, sl.Layout(32, W // 16, 4, 117760, False))


@pytest.mark.parametrize('kind, B, W, want', [
    ('bwd', 1, 128, (1, 16, 1, True)), ('bwd', 128, 128, (2, 2, 2, True)),
    ('bwd', 128, 256, (4, 8, 4, True)), ('bwd', 128, 384, (8, 1, 8, False)),
    ('lstm', 4, 128, (1, 16, 1, True)), ('lstm', 128, 128, (2, 2, 2, True)),
    ('lstm', 1024, 128, (8, 1, 8, False)),
    ('lstm', 4, 384, (4, 1, 4, False))])
def test_choices_below_width_512_unchanged(kind, B, W, want):
    lay = sl.choose(kind, B, W, 1, _fits, 132)
    assert (lay.rb, lay.cl, lay.rt, lay.reg, lay.grid) == want + (False,)


def test_layout_kinds():
    """A layout's kind from its fields: the register layout (``reg``),
    the one-block layout (one block), the grid layout (a group of more
    blocks than a cluster holds); the register flag on a grid's fields is
    a register layout that does not fit, and ``check`` refuses it."""
    grid = sl.grid_layout_for('bwd', 128, 512, 32)
    one = sl.one_block_layout('bwd', 128, 512, 1)
    reg = sl.reg_layout_for('bwd', 128, 1, 2, 2)
    assert (grid.grid, one.grid, reg.grid) == (True, False, False)
    assert len(grid) == 5 and not grid.reg
    with pytest.raises(ValueError, match='a register layout that fits'):
        sl.check('bwd', 128, 512, 1, grid._replace(reg=True))


def test_grid_layout_needs_its_groups_on_the_card():
    """Fewer SMs than a group's 32 blocks: no grid layout (its waves are
    0), the one-block layout; the plan too large for a block's shared
    memory (rb = 4096): none either."""
    lay = sl.choose('bwd', 128, 512, 1, _fits, 31)
    assert not lay.grid and lay == sl.one_block_layout('bwd', 128, 512, 1)
    grid = sl.grid_layout_for('bwd', 128, 512, 32)
    assert sl.waves(128, grid, _fits, 127) == 0
    assert sl.waves(128, grid, _fits, 128) == 1
    assert sl.grid_layout_for('bwd', 4096, 512, 4096) is None
    assert sl.choose('bwd', 16384, 512, 1, _fits, 132) == \
        sl.one_block_layout('bwd', 16384, 512, 1)


def test_grid_cost_model():
    """A grid step costs GRID_STEP and GRID_PER_ROW a stream of a group,
    in one wave; at W=512 it undercuts the one-block layout's step (its
    thread's serial FMAs) at every batch the grid takes."""
    for kind in ('lstm', 'bwd'):
        lay = sl.grid_layout_for(kind, 128, 512, 32)
        assert sl.step_cost(kind, 512, 1, lay) == pytest.approx(
            sl.GRID_STEP[kind] + 32 * sl.GRID_PER_ROW[kind])
        for B in (1, 128, 2048):
            one = sl.one_block_layout(kind, B, 512, 1)
            grid = sl.choose(kind, B, 512, 1, _fits, 132)
            assert grid.grid and sl.step_cost(kind, 512, 1, grid) < \
                sl.step_cost(kind, 512, 1, one) * sl.waves(B, one, _fits,
                                                           132)


def test_launch_mode_and_group_counters():
    """The C launch functions take the layout as 0 (one-block), 1
    (register) or 2 (grid); the grid layout gets one counter a group."""
    grid = sl.grid_layout_for('bwd', 130, 512, 33)
    reg = sl.reg_layout_for('bwd', 128, 1, 2, 2)
    one = sl.one_block_layout('bwd', 128, 512, 1)
    assert [lc._mode(x) for x in (one, reg, grid)] == [0, 1, 2]
    cpu = torch.device('cpu')
    assert tuple(lc._group_flags(grid, 130, cpu).shape) == (4,)
    assert lc._group_flags(grid, 130, cpu).dtype == torch.int32
    assert lc._group_flags(reg, 128, cpu).numel() == 0


def test_chip_smoke_forces_and_lists_the_grid_layout():
    """``chip_smoke.scan_layout(rb, reg=GRID)`` makes the chooser return
    the grid layout (of ``rb`` streams a group, or as the card groups
    them); ``scan_layouts`` lists it beside the one-block layout at
    W=512."""
    assert chip_smoke.scan_layouts('bwd', 128, 512, 1) == [
        (4, 1, False), (32, 32, chip_smoke.GRID)]
    assert chip_smoke.scan_layouts('lstm', 3, 512, 1) == [
        (4, 1, False), (1, 32, chip_smoke.GRID)]
    assert all(x[2] is not chip_smoke.GRID
               for x in chip_smoke.scan_layouts('bwd', 128, 256, 1))
    with chip_smoke.scan_layout(reg=chip_smoke.GRID):
        assert sl.choose('bwd', 128, 512, 1, _fits, 132) == \
            sl.grid_layout_for('bwd', 128, 512, 32)
    with chip_smoke.scan_layout(64, reg=chip_smoke.GRID):
        assert sl.choose('lstm', 128, 512, 1, _fits, 132).rb == 64
    with chip_smoke.scan_layout(reg=False):
        assert sl.choose('lstm', 128, 512, 1, _fits, 132) == \
            sl.one_block_layout('lstm', 128, 512, 1)
    assert sl.choose('lstm', 128, 512, 1, _fits, 132).grid
