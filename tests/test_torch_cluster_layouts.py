"""How the LSTM backward and the lattice decode lay a launch out on the
card: host arithmetic only, no card needed.

``scan_layout.choose('bwd', ...)`` picks the layout of ``lstm_bwd``'s
chain (``csrc/lstm_bwd.cu``): the register layout on thread-block
clusters where it fits and pays, else the first port's one-block kernel.
``decode_kernel.choose_cluster`` picks the blocks a document of
``decode_lattice``/``decode_lattice_batch`` runs on (the cluster layout
of ``csrc/decode_common.cuh``, or one block).  Both are fed the cluster
occupancy of an H100 as a table, as ``test_torch_lstm_scan.py`` does for
the forward scans."""
import pytest
import torch

from ocrd_keraslm_torch.ops import decode_kernel as dk
from ocrd_keraslm_torch.ops import scan_layout as sl

torch.set_num_threads(1)

# cluster occupancy of an H100: how many clusters of each size the card
# holds at once (the forward's table in test_torch_lstm_scan.py)
H100_FITS = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}


def _fits(lay):
    return H100_FITS[lay.cl]


# ---- lstm_bwd's chain ----

@pytest.mark.parametrize('B, W, want', [
    # a few streams: one stream a cluster, as many blocks as pay
    (1, 128, (1, 16, 1, True)),
    (3, 128, (1, 16, 1, True)),
    (9, 128, (1, 8, 1, True)),
    (33, 128, (1, 2, 1, True)),
    # the training shape (and one stream more): 64 two-block clusters of
    # 2 streams fill 128 SMs in one wave
    (128, 128, (2, 2, 2, True)),
    (129, 128, (2, 2, 2, True)),
    # larger batches: 4 streams a thread chain, clusters in waves
    (256, 128, (4, 2, 4, True)),
    (2048, 128, (4, 2, 4, True)),
    (4, 64, (1, 8, 1, True)),
    (128, 64, (1, 1, 1, True)),
    (128, 256, (4, 8, 4, True)),
    # twelve 32-term blocks a column: the one-block layout
    (4, 384, (4, 1, 4, False)),
    (128, 384, (8, 1, 8, False)),
])
def test_bwd_layout_chooser(B, W, want):
    """The choice per (B, W), the same under f32 and bf16 U (the chain
    reads U^T as f32 either way)."""
    lays = [sl.choose('bwd', B, W, 1, _fits, 132, bf16=bf16)
            for bf16 in (False, True)]
    assert lays[0] == lays[1]
    lay = lays[0]
    assert (lay.rb, lay.cl, lay.rt, lay.reg) == want
    assert lay.smem == sl.plan_bytes('bwd', W, 1, lay.rb, lay.reg)
    sl.check('bwd', B, W, 1, lay)


@pytest.mark.parametrize('B', [1, 3, 4, 9, 33, 128, 4096])
def test_bwd_layout_without_clusters_is_the_one_block_layout(B):
    """A card that holds no cluster gets the first port's kernel: one
    block of rows_per_block(B) streams, its shared memory the rows h, dh,
    dc, z, dz and the four partial sums of dh."""
    rb = sl.rows_per_block(B)
    lay = sl.choose('bwd', B, 128, 1, lambda lay: 0, 132)
    assert lay == sl.one_block_layout('bwd', B, 128, 1)
    assert (lay.rb, lay.cl, lay.rt, lay.reg) == (rb, 1, rb, False)
    assert lay.smem == 4 * rb * (3 * 128 + 2 * 4 * 128 + 4 * 128)


@pytest.mark.parametrize('B, W', [(1, 4), (3, 36), (9, 100), (33, 128),
                                  (129, 128), (200, 256), (2, 512)])
def test_bwd_every_choice_is_valid(B, W):
    """Whatever the occupancy, the chosen layout passes the kernel's
    checks, and so does every register layout the chooser could force."""
    for fits in (lambda lay: 0, _fits, lambda lay: 1 << 20):
        sl.check('bwd', B, W, 1, sl.choose('bwd', B, W, 1, fits, 132))
    for cl in sl.CLUSTERS:
        for rb in (1, 2, 4, 8):
            lay = sl.reg_layout_for('bwd', W, 1, rb, cl)
            if lay is not None:
                sl.check('bwd', B, W, 1, lay)
                assert lay.rt in (1, 2, 4) and lay.rb % lay.rt == 0


def test_bwd_register_layout_threads_and_bytes():
    """A unit's group in the backward takes one lane per pair of U^T's
    quarters and 32-term block (8 at W=128, as the forward's lstm_scan),
    chains of up to 4 streams (the forward: 2), and the padded dz rows
    (2, rb, 4 quarters of W + 4 a 32-term block, rounded to 8 mod 16
    floats) and two mbarriers."""
    assert sl.reg_lanes('bwd', 128) == 8
    assert sl.reg_group_threads('bwd', 128, 2, 2, 2) == 512
    lay = sl.reg_layout_for('bwd', 128, 1, 8, 4)
    assert (lay.rb, lay.cl, lay.rt) == (8, 4, 4)
    assert sl.reg_layout_for('lstm', 128, 1, 8, 4) is None
    assert sl.quarter_width(128) == 152 and sl.quarter_width(64) == 72
    assert sl.plan_bytes('bwd', 128, 1, 2, True) == 4 * 2 * 2 * 4 * 152 + 16
    assert sl.plan_bytes('bwd', 128, 1, 8, False) == 4 * 8 * 15 * 128
    # one block of 32 terms, or more than eight: no register layout
    assert sl.reg_layout_for('bwd', 32, 1, 1, 2) is None
    assert sl.reg_layout_for('bwd', 384, 1, 1, 16) is None


@pytest.mark.parametrize('field, value, message', [
    ('rb', 3, 'a register layout that fits'),
    ('rt', 8, 'a register layout that fits'),
    ('rt', 3, 'a register layout that fits'),
    ('smem', 1024, 'smem equal'),
    ('reg', False, 'the one-block layout')])
def test_bwd_check_refuses(field, value, message):
    lay = sl.reg_layout_for('bwd', 128, 1, 8, 4)._replace(**{field: value})
    with pytest.raises(ValueError, match=message):
        sl.check('bwd', 8, 128, 1, lay)


def test_bwd_cost_model():
    """The one-block chain's step: one thread's FMAs of the z recompute
    and of dh (8 streams x 128 terms, twice: ~20 us, as the first port's
    kernel takes at the training shape); a register step by its chain and
    threads, as the forward's."""
    one = sl.one_block_layout('bwd', 128, 128, 1)
    assert sl.step_cost('bwd', 128, 1, one) == pytest.approx(
        sl.ONE_PER_FMA * 8 * 128 * 2)
    reg = sl.reg_layout_for('bwd', 128, 1, 2, 2)
    assert sl.step_cost('bwd', 128, 1, reg) == pytest.approx(
        sl.REG_STEP + 2 * sl.REG_PER_ROW + sl.REG_PER_BLOCK)
    with pytest.raises(ValueError, match='kind is lstm or score'):
        sl.plan_bytes('decode', 128, 1, 1, True)


# ---- the decode's blocks a document ----

def _cl_fits(cl):
    return H100_FITS[cl]


@pytest.mark.parametrize('L', [1, 8, 64])
@pytest.mark.parametrize('N, want', [
    # the german model's width: 16 blocks a document (7 such clusters at
    # once) while their waves cost less than one block a document
    (1, 16), (7, 16), (8, 16), (32, 16), (35, 16),
    # from 6 waves on, the one-block layout (132 documents at once)
    (36, 1), (132, 1), (300, 1)])
def test_decode_cluster_choice(N, want, L):
    """Blocks a document at the german model's shape (W=128, D=2, K=16,
    A=4, v_real 70) by number of documents."""
    assert dk.choose_cluster(N, 16, 4, L, 2, 128, 128, 70, _cl_fits,
                             132) == want


@pytest.mark.parametrize('L', [1, 8])
@pytest.mark.parametrize('N, want', [
    # beam_width 17-32: the sharded plan's clusters, one cost model with
    # the rows plan (rows 1k and 2k of PERF.md: 16 blocks 0.19-0.21 of
    # one block's time), so the same sizes by number of documents
    (1, 16), (7, 16), (32, 16), (35, 16), (36, 1), (300, 1)])
def test_decode_cluster_choice_at_k32(N, want, L):
    """Blocks a document at K=32, W=128, D=2 (the sharded plan)."""
    assert dk.choose_cluster(N, 32, 4, L, 2, 128, 128, 70, _cl_fits,
                             132) == want


@pytest.mark.parametrize('N, want', [(1, 16), (7, 16), (8, 8), (15, 8),
                                     (16, 4), (32, 4), (300, 1)])
def test_decode_cluster_choice_at_w64(N, want):
    """At W=64, D=2 every size fits: 16 blocks for a few documents, then
    fewer, larger waves of smaller clusters."""
    assert dk.choose_cluster(N, 16, 4, 8, 2, 64, 128, 70, _cl_fits,
                             132) == want


@pytest.mark.parametrize('W, D, K, A, L', [
    (100, 2, 16, 4, 8),    # not a multiple of 32
    (256, 2, 16, 4, 8),    # 16 blocks of 32 terms a gate column
    (96, 1, 16, 4, 8),     # 6 blocks
    (128, 3, 16, 4, 8),    # three layers' weights exceed a lane's share
    (128, 2, 64, 4, 8),    # more beam rows than the kernels take
    (128, 2, 16, 8, 64),   # more chars an edge than a block's threads
    (16, 2, 16, 4, 8)])    # one block of 32 terms
def test_decode_shapes_the_cluster_layout_does_not_take(W, D, K, A, L):
    """These take the one-block path, whatever the card holds."""
    assert dk.choose_cluster(1, K, A, L, D, W, 128, 70, lambda cl: 1 << 20,
                             132) == 1


@pytest.mark.parametrize('W, D, K, A, L, shard', [
    # K=32 at the german model's width: the candidates' rows exceed a
    # block in the rows plan, so the sharded plan
    (128, 2, 32, 4, 8, True),
    (128, 2, 32, 4, 1, True),
    (128, 2, 32, 4, 64, True),
    (128, 1, 32, 4, 8, True),
    # the rows plan wherever it fits
    (128, 2, 16, 4, 8, False),
    (128, 2, 16, 4, 64, False),
    (128, 2, 8, 4, 8, False),
    (64, 2, 32, 4, 8, False),
    (32, 1, 32, 4, 64, False)])
def test_decode_shapes_the_cluster_layout_takes(W, D, K, A, L, shard):
    """One document takes 16 blocks in the plan the shape needs, and that
    plan fits a block's shared memory."""
    assert dk.choose_cluster(1, K, A, L, D, W, 128, 70, lambda cl: 1 << 20,
                             132) == 16
    assert dk.cluster_shard(K, A, L, D, W, 128, 70, 16) == shard
    assert dk.cluster_smem_bytes(A, L, K, D, W, 128, 70, 16) <= dk.SMEM_MAX
    assert dk.cluster_ok(W, D, 16, K, shard)


def test_decode_without_clusters_is_one_block():
    for N in (1, 32, 500):
        assert dk.choose_cluster(N, 16, 4, 8, 2, 128, 128, 70, lambda cl: 0,
                                 132) == 1


def test_decode_cluster_layout_bytes_and_sizes():
    """A block's shared memory in the cluster layout (in the rows plan
    the beam's and the K*A candidates' padded rows take most of it, then
    embT's real columns) and the sizes the layout takes (a row group of
    4 x 2W/32 lanes a unit in 256 threads, within a block's shared
    memory): K=16 fits at the german model's width up to L=64 on 16
    blocks in the rows plan; K=32 there takes 16 blocks in the sharded
    plan (at W=64 the rows plan fits)."""
    assert dk.padded_width(128) == 144
    assert dk.cluster_smem_bytes(4, 8, 16, 2, 128, 128, 70, 16) == 224628
    assert dk.cluster_smem_bytes(4, 64, 16, 2, 128, 128, 70, 16) == 227316
    assert dk.cluster_sizes(16, 4, 64, 2, 128, 128, 70) == [16]
    assert dk.cluster_sizes(32, 4, 8, 2, 128, 128, 70) == [16]
    assert dk.cluster_sizes(32, 4, 8, 2, 64, 128, 70) == [4, 8, 16]
    assert [c for c in dk.CLUSTERS if dk.cluster_ok(128, 2, c)] == [16]
    assert [c for c in dk.CLUSTERS if dk.cluster_ok(64, 1, c)] == [4, 8, 16]
    assert not dk.cluster_ok(128, 2, 8)   # 512 threads a row group
    assert not dk.cluster_ok(128, 2, 16, K=33)
    assert not dk.cluster_ok(64, 2, 16, shard=True)  # built at W=128 only


def test_decode_sharded_plan_bytes():
    """K=32 at the german model's width (A=4, L=8, D=2, 16 blocks): the
    rows plan asks 388,596 bytes, over a block's 232,448, so the plan is
    the sharded one: four mbarriers, the ring of h, two chunks' padded
    rows, the own 8 units of every row (beam, candidates, the parents'
    new h), then what the rows plan holds besides the rows."""
    assert dk.SMEM_MAX == 232448
    assert dk.cluster_smem_bytes(4, 8, 32, 2, 128, 128, 70, 16,
                                 False) == 388596
    assert dk.cluster_shard(32, 4, 8, 2, 128, 128, 70, 16)
    assert not dk.cluster_shard(16, 4, 8, 2, 128, 128, 70, 16)
    WP, upb, K, KA, D = 144, 8, 32, 128, 2
    rows = (2 * 16 * 3 * WP + (K + KA) * (D + 1) * upb + K * D * upb)
    rows_plan = (K + KA) * 3 * WP + K * D * WP
    sharded = dk.cluster_smem_bytes(4, 8, 32, 2, 128, 128, 70, 16)
    assert sharded == 388596 + 16 + 4 * (rows - rows_plan) == 147972
    assert sharded <= dk.SMEM_MAX
    # the same plan at K=16 fits too; the shape keeps its rows plan
    assert dk.cluster_smem_bytes(4, 8, 16, 2, 128, 128, 70, 16,
                                 True) == 131972
    assert dk.cluster_smem_bytes(4, 8, 16, 2, 128, 128, 70, 16) == 224628


def test_decode_k32_one_document_takes_16_blocks():
    """The processor's pages at beam_width 17-32 (K=32): one document a
    launch on a 16-block cluster in the sharded plan."""
    for L in (1, 8, 64):
        assert dk.choose_cluster(1, 32, 4, L, 2, 128, 128, 70, _cl_fits,
                                 132) == 16


def test_decode_cost_model_prefers_fewer_waves():
    """Waves count: at N documents the cost is CL_COST[cl] times the
    clusters' waves, against one block a document on 132 SMs."""
    assert dk.CL_COST[1] == 1.0
    for n in (20, 40, 500):
        costs = {cl: dk.CL_COST[cl] * -(-n // H100_FITS[cl])
                 for cl in (4, 8, 16)}
        costs[1] = dk.CL_COST[1] * -(-n // 132)
        assert dk.choose_cluster(n, 16, 4, 8, 2, 64, 128, 70, _cl_fits,
                                 132) == min(costs, key=lambda cl: (
                                     costs[cl], -cl))
