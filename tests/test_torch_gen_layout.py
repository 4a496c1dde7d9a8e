"""How ``gen_beam`` lays a launch out on the card: host arithmetic only,
no card needed.

``gen_kernel.choose`` picks the layout of a launch of N streams
(``csrc/gen_beam.cu``): the unit layout (a cluster of 4, 8 or 16 blocks
in 1 or 2 row halves by unit groups; a block owns its group's units,
their weights in registers for all steps), on one cluster a stream or
in g row groups of K/g rows, one cluster each, where all N*g clusters
fit at once, or the rows layout of the first design (a block owns K/cl
fringe rows) on 8 or 16, by a cost model of a step times the waves of
clusters.  The card's
cluster occupancy is fed as a table, as ``test_torch_cluster_layouts.py``
does for the decode and the LSTM backward."""
import re

import pytest
import torch

import chip_smoke
from ocrd_keraslm_torch.ops import _build
from ocrd_keraslm_torch.ops import gen_kernel as gk

torch.set_num_threads(1)

# how many clusters of each size an H100 holds at once (one block of 512
# threads an SM): the table of test_torch_cluster_layouts.py
H100_FITS = {16: 7, 8: 15, 4: 30}
GERMAN = dict(K=256, D=2, W=128, Vp=128, topk=10, v_real=70)


def _fits(lay):
    return H100_FITS[lay.cl]


def _shape(**kw):
    shape = dict(GERMAN, **kw)
    return (shape['K'], shape['D'], shape['W'], shape['Vp'], shape['topk'],
            shape['v_real'])


def test_german_layouts_and_plans():
    """At the german model's shape: the unit layout on 16 blocks in one
    row half (tiles of 32 rows) or two (tiles of 16: two halves' blocks
    own 16 units, whose block sums would exceed a block's shared memory at
    32 rows), and on 8 blocks in one half (tiles of 16); not on 4 (512
    roles for 256 threads) nor on 8 in two halves (1024 roles); the rows
    layout on 8 and 16, with the first design's plan."""
    K, D, W, Vp, topk, v_real = _shape()
    lays = gk.gen_layouts(K, D, W, Vp, topk, v_real)
    assert lays[:5] == [gk.GenLayout(8, True, 1, 16, 191120),
                        gk.GenLayout(16, True, 1, 32, 226896),
                        gk.GenLayout(16, True, 2, 16, 189776),
                        gk.GenLayout(8, False, 0, 0, 174992),
                        gk.GenLayout(16, False, 0, 0, 99792)]
    # then the unit layout in row groups: the same blocks over K/g rows
    # (the own rows' arrays shrink: 8 rows a block from g = 2 on); 16
    # groups of 16 blocks in two halves would leave 8 rows a half, less
    # than a tile
    assert lays[5:] == [
        gk.GenLayout(8, True, 1, 16, 189776, 2),
        gk.GenLayout(16, True, 1, 32, 226224, 2),
        gk.GenLayout(16, True, 2, 16, 189104, 2),
        gk.GenLayout(8, True, 1, 16, 189104, 4),
        gk.GenLayout(16, True, 1, 32, 226224, 4),
        gk.GenLayout(16, True, 2, 16, 189104, 4),
        gk.GenLayout(8, True, 1, 16, 189104, 8),
        gk.GenLayout(16, True, 1, 32, 226224, 8),
        gk.GenLayout(16, True, 2, 16, 189104, 8),
        gk.GenLayout(8, True, 1, 16, 189104, 16),
        gk.GenLayout(16, True, 1, 16, 146352, 16)]
    assert gk.units_plan_bytes(K, 16, 2, 32, D, W, Vp, topk, v_real) > \
        gk.SMEM_MAX
    assert gk.units_layout_for(K, D, W, Vp, topk, 4, 1, v_real) is None
    assert gk.units_layout_for(K, D, W, Vp, topk, 8, 2, v_real) is None
    g = gk.unit_geometry(W, 16, 2)
    assert (g['upb'], g['nc'], g['nkb'], g['nrole'], g['nrg']) == \
        (16, 64, 8, 256, 1)
    assert (g['xp'], g['ps']) == (292, 80)
    g = gk.unit_geometry(W, 16, 1)
    assert (g['upb'], g['nc'], g['nrole'], g['nrg'], g['ps']) == \
        (8, 32, 128, 2, 40)
    # the unit plan: two staged [x | h] tiles, three tiles of old c, two
    # tiles' block sums, the bias, embT's 72 real columns, then the
    # selection's arrays
    assert gk.units_plan_bytes(K, 16, 2, 16, D, W, Vp, topk, v_real) == 4 * (
        2 * 16 * 292 + 3 * 16 * 16 + 2 * 8 * 16 * 80 + 2 * 64 + 128 * 72
        + 16 + 2 * 160 + 2 * 2560 + 7 * 256 + 256 + 4)
    # the rows layout's plan is the first design's: 16 rows a block of
    # [xemb | h | c], their 512 gates, candidates of every row
    assert gk.rows_plan_bytes(K, 16, D, W, Vp, topk) == 4 * (
        16 * 640 + 16 * 512 + 16 + 2 * 160 + 2 * 2560 + 4 * 256 + 2 * 16 + 4)


@pytest.mark.parametrize('N, want', [
    # few streams leave clusters idle: a stream in row groups of 8-block
    # clusters, as many as fit for all streams (the model rates them as
    # half as many groups of 16 blocks in two row halves; ties go to
    # more groups)
    (1, (8, True, 1, 8)), (2, (8, True, 1, 4)), (3, (8, True, 1, 4)),
    # up to seven streams: two groups of 8 blocks a stream (the same SMs
    # as one cluster of 16, a cheaper exchange than the cluster's)
    (4, (8, True, 1, 2)), (7, (8, True, 1, 2)),
    # two waves of 7 against one of 15 clusters of the rows layout on 8
    # blocks: the rows layout
    (8, (8, False, 0, 1)), (15, (8, False, 0, 1)),
    # the batch row: three waves of 7 against two of 15
    (16, (16, True, 2, 1)), (21, (16, True, 2, 1)),
    (22, (8, False, 0, 1)), (64, (8, False, 0, 1))])
def test_german_choice(N, want):
    """The german model's layout by number of streams, from the cost
    model fitted to an H100 (66.6 us a step of the unit layout in two row
    halves, 115 of the rows layout on 8 blocks; row groups cut a
    cluster's rows and add the exchange) times the waves."""
    lay = gk.choose(N, *_shape(), _fits)
    assert (lay.cl, lay.units, lay.rh, lay.g) == want
    assert lay in gk.gen_layouts(*_shape())


@pytest.mark.parametrize('N', [1, 3, 16, 100])
@pytest.mark.parametrize('kw', [
    {}, dict(K=128), dict(K=32, topk=4), dict(K=16), dict(K=8),
    dict(D=1, W=64), dict(D=2, W=64), dict(D=1, W=32), dict(W=96),
    dict(W=100, Vp=100), dict(D=3), dict(W=256, D=1), dict(topk=32),
    dict(v_real=128)])
def test_every_choice_is_a_layout_that_exists(N, kw):
    """Whatever the occupancy, the choice is one of ``gen_layouts`` for
    the shape, its plan in a block's shared memory, and the source takes
    it (``units_ok`` for the unit layout)."""
    shape = _shape(**kw)
    K, D, W, Vp, topk, v_real = shape
    lays = gk.gen_layouts(*shape)
    assert lays
    for fits in (_fits, lambda lay: 1, lambda lay: 1 << 20):
        lay = gk.choose(N, K, D, W, Vp, topk, v_real, fits)
        assert lay in lays and lay.smem <= gk.SMEM_MAX
        if lay.units:
            assert gk.units_ok(K, D, W, lay.cl, lay.rh, lay.tr, v_real,
                               lay.g)
            assert lay.smem == gk.units_plan_bytes(K, lay.cl, lay.rh, lay.tr,
                                                   D, W, Vp, topk, v_real,
                                                   lay.g)
            # row groups only where every cluster of the launch is
            # resident at once
            assert lay.g == 1 or N * lay.g <= fits(lay)
        else:
            assert lay.smem == gk.rows_plan_bytes(K, lay.cl, D, W, Vp, topk)
            assert lay.g == 1


@pytest.mark.parametrize('kw, units', [
    (dict(D=3), False),            # three layers' weights: rows layout
    (dict(W=256, D=1), False),     # 512 roles a block at W=256
    (dict(K=8), False),            # no tile of 16 rows
    (dict(W=100, Vp=100), False),  # W not a multiple of 16
    (dict(v_real=128, Vp=160, W=64), True),
    (dict(v_real=129, Vp=160), False),  # a row's logits past 4 registers
    (dict(D=1, W=64), True), (dict(K=16), True), (dict(W=96), True)])
def test_which_shapes_take_the_unit_layout(kw, units):
    lays = gk.gen_layouts(*_shape(**kw))
    assert any(lay.units for lay in lays) == units
    assert any(not lay.units for lay in lays)


@pytest.mark.parametrize('kw', [
    dict(K=12), dict(K=264), dict(topk=33), dict(topk=0),
    dict(Vp=126, W=64), dict(v_real=129)])
def test_a_shape_no_layout_takes_raises(kw):
    K, D, W, Vp, topk, v_real = _shape(**kw)
    assert gk.gen_layouts(K, D, W, Vp, topk, v_real) == []
    with pytest.raises(ValueError, match='no layout takes'):
        gk.choose(1, K, D, W, Vp, topk, v_real, _fits)


def test_no_cluster_fits_raises():
    with pytest.raises(ValueError, match='no layout takes'):
        gk.choose(1, *_shape(), lambda lay: 0)


def test_cost_model_counts_waves_and_fmas():
    """A step of the unit layout costs UNIT_STEP plus the block's FMAs
    (its columns over all K rows, its own rows' logits); the rows layout
    ROWS_STEP plus its rows' FMAs; a launch, the step times its waves."""
    K, D, W, Vp, topk, v_real = _shape()
    u16 = gk.units_layout_for(K, D, W, Vp, topk, 16, 2, v_real)
    r16 = gk.rows_layout_for(K, D, W, Vp, topk, 16, v_real)
    own = 16 * W * v_real
    assert gk.step_cost(u16, K, D, W, v_real) == pytest.approx(
        gk.UNIT_STEP + gk.UNIT_PER_MFMA * (K * D * 2 * W * 4 * W / 16
                                           + own) / 1e6
        + gk.UNIT_PER_KWORD * K / 2 * D * 2 * W / 1e3)
    # a row half loads half the x words for the same FMAs
    u16h1 = gk.units_layout_for(K, D, W, Vp, topk, 16, 1, v_real)
    assert gk.step_cost(u16h1, K, D, W, v_real) > \
        gk.step_cost(u16, K, D, W, v_real)
    assert gk.step_cost(r16, K, D, W, v_real) == pytest.approx(
        gk.ROWS_STEP + gk.ROWS_PER_MFMA * (16 * D * 2 * W * 4 * W
                                           + own) / 1e6)
    # only the rows layout fits: it is taken
    assert gk.choose(1, K, D, W, Vp, topk, v_real,
                     lambda lay: 0 if lay.units else 7) == r16


@pytest.mark.parametrize('g', [2, 4, 8, 16])
def test_row_groups_geometry_plans_and_shapes(g):
    """In g row groups a block keeps the geometry of one cluster a
    stream (its units, roles and staged rows), its layers run over its
    half of K/g rows and it owns K/(g*cl) rows' logits; its plan is the
    one-cluster plan with those own rows; ``units_ok`` asks of K/g what
    it asks of K at g = 1."""
    K, D, W, Vp, topk, v_real = _shape()
    for cl, rh in ((16, 2), (16, 1), (8, 1)):
        one = gk.unit_geometry(W, cl, rh)
        grouped = gk.unit_geometry(W, cl, rh, K, g)
        assert {k: v for k, v in grouped.items()
                if k not in ('kh', 'own')} == one
        assert (grouped['kh'], grouped['own']) == (K // g // rh,
                                                   K // g // cl)
        assert gk.unit_geometry(W, cl, rh, K)['kh'] == K // rh
        for tr in gk.TILES:
            # the own rows' costs and candidates shrink; their top-layer
            # h and logits share the staged tiles' room, which is larger
            assert gk.units_plan_bytes(K, cl, rh, tr, D, W, Vp, topk,
                                       v_real, g) == \
                gk.units_plan_bytes(K, cl, rh, tr, D, W, Vp, topk, v_real) \
                - 4 * (gk.own_rows_cap(K // cl) - gk.own_rows_cap(
                    K // g // cl)) * (1 + 2 * topk)
            assert gk.units_ok(K, D, W, cl, rh, tr, v_real, g) == \
                gk.units_ok(K // g, D, W, cl, rh, tr, v_real)
    # g divides K, at most 16 groups
    assert not gk.units_ok(K, D, W, 8, 1, 16, v_real, 3)
    assert not gk.units_ok(512, D, W, 8, 1, 16, v_real, 32)
    assert gk.units_ok(512, D, W, 8, 1, 16, v_real, 16)


def test_one_stream_spreads_over_clusters_sixteen_do_not():
    """One stream (``generate``) takes row groups: the largest number the
    cost model rates fastest among those whose clusters all fit; 16
    streams (``generate_batch``, row 6b) already fill the card and take
    one cluster a stream."""
    shape = _shape()
    one = gk.choose(1, *shape, _fits)
    assert one.units and one.g > 1 and one.g * one.cl <= 132
    assert one.g <= H100_FITS[one.cl]
    batch = gk.choose(16, *shape, _fits)
    assert batch.g == 1
    # the card's own count decides: with room for 16 clusters of 16
    # blocks 16 streams still take one each, one stream more groups
    more = gk.choose(1, *shape, lambda lay: 16)
    assert gk.choose(16, *shape, lambda lay: 16).g == 1
    assert more.g >= one.g


@pytest.mark.parametrize('how', ['occupancy', 'launch'])
def test_a_refused_cooperative_launch_leaves_one_cluster_a_stream(
        monkeypatch, how):
    """Where the card takes no cooperative launch (its occupancy query of
    a grouped layout reads 0) or CUDA refused one (the device in
    ``_GROUPS_REFUSED``), one stream takes one cluster."""
    shape = _shape()

    def fits(index, K, D, W, Vp, topk, v_real, lay):
        if how == 'occupancy' and lay.g > 1:
            return 0
        return H100_FITS[lay.cl]
    monkeypatch.setattr(gk, 'clusters_that_fit', fits)
    if how == 'launch':
        monkeypatch.setattr(gk, '_GROUPS_REFUSED', {0})
    gk._layout.cache_clear()
    try:
        lay = gk.layout_on(torch.device('cuda', 0), 1, *shape)
        assert lay.g == 1 and lay == gk.choose(16, *shape, _fits)
        # another device is not refused
        if how == 'launch':
            assert gk.layout_on(torch.device('cuda', 1), 1, *shape).g > 1
    finally:
        gk._layout.cache_clear()


@pytest.mark.parametrize('cl, rh', [(16, 2), (16, 1), (8, 1)])
def test_cost_model_exchange_term(cl, rh):
    """A step in g row groups costs the one-cluster step of K/g rows
    with the exchange through L2 in place of the cluster's: UNIT_XCHG
    and UNIT_XCHG_PER_BLOCK a block of the stream; one cluster a stream
    pays no exchange term; more groups cost less while the exchange
    grows slower than the block's rows shrink."""
    K, D, W, Vp, topk, v_real = _shape()
    costs = []
    for g in (1, 2, 4, 8):
        lay = gk.units_layout_for(K, D, W, Vp, topk, cl, rh, v_real, g)
        alone = gk.units_layout_for(K // g, D, W, Vp, topk, cl, rh, v_real)
        xchg = gk.UNIT_XCHG + gk.UNIT_XCHG_PER_BLOCK * g * cl if g > 1 \
            else 0.0
        assert gk.step_cost(lay, K, D, W, v_real) == pytest.approx(
            gk.step_cost(alone, K // g, D, W, v_real) + xchg)
        costs.append(gk.step_cost(lay, K, D, W, v_real))
    assert costs == sorted(costs, reverse=True)
    # the fit: the L2 exchange's fixed part is below the cluster's, and
    # each arriving block adds to it
    assert gk.UNIT_XCHG < 0 < gk.UNIT_XCHG_PER_BLOCK


def test_layout_cache_is_keyed_by_device_and_shape(monkeypatch):
    """``layout_on`` asks the card's occupancy once per device and
    shape: the same shape again is served from the cache, another N or
    width is chosen anew."""
    asked = []

    def fits(index, K, D, W, Vp, topk, v_real, lay):
        asked.append((index, K, D, W, lay))
        return H100_FITS[lay.cl]
    monkeypatch.setattr(gk, 'clusters_that_fit', fits)
    gk._layout.cache_clear()
    dev = torch.device('cuda', 0)
    try:
        K, D, W, Vp, topk, v_real = _shape()
        first = gk.layout_on(dev, 1, K, D, W, Vp, topk, v_real)
        n = len(asked)
        assert n == len(gk.gen_layouts(K, D, W, Vp, topk, v_real))
        assert gk.layout_on(dev, 1, K, D, W, Vp, topk, v_real) == first
        assert len(asked) == n
        gk.layout_on(dev, 16, K, D, W, Vp, topk, v_real)
        gk.layout_on(dev, 1, K, 1, 64, Vp, topk, v_real)
        gk.layout_on(torch.device('cuda', 1), 1, K, D, W, Vp, topk, v_real)
        assert len(asked) > 3 * n
        assert {a[0] for a in asked} == {0, 1}
        assert gk._layout.cache_info().currsize == 4
    finally:
        gk._layout.cache_clear()


def test_forcing_a_layout(monkeypatch):
    """``chip_smoke.gen_layout`` makes the wrapper take a given layout
    inside the block and the chooser's again after it, the cache dropped
    on entry and on exit."""
    monkeypatch.setattr(gk, 'clusters_that_fit',
                        lambda index, *shape: H100_FITS[shape[-1].cl])
    gk._layout.cache_clear()
    dev = torch.device('cuda', 0)
    shape = _shape()
    K, D, W, Vp, topk, v_real = shape
    try:
        chosen = gk.layout_on(dev, 1, *shape)
        lays = gk.gen_layouts(*shape)
        assert any(lay.g > 1 for lay in lays)
        for lay in lays:
            with chip_smoke.gen_layout(lay):
                assert gk._layout.cache_info().currsize == 0
                assert gk.layout_on(dev, 1, *shape) == lay
                assert gk.layout_on(dev, 16, *shape) == lay
            assert gk._layout.cache_info().currsize == 0
            assert gk.layout_on(dev, 1, *shape) == chosen
    finally:
        gk._layout.cache_clear()


def test_gen_layouts_on_takes_row_groups_that_fit_the_streams(
        monkeypatch):
    """``chip_smoke.gen_layouts_on`` lists row groups only where the
    card holds every cluster of a launch of N streams."""
    monkeypatch.setattr(gk, 'clusters_that_fit',
                        lambda index, *shape: H100_FITS[shape[-1].cl])
    dev = torch.device('cuda', 0)
    shape = _shape()
    for N in (1, 3, 9, 16):
        lays = chip_smoke.gen_layouts_on(dev, *shape, N)
        assert [lay for lay in lays if lay.g == 1] == [
            lay for lay in gk.gen_layouts(*shape) if lay.g == 1]
        assert all(N * lay.g <= H100_FITS[lay.cl] for lay in lays
                   if lay.g > 1)
        assert any(lay.g > 1 for lay in lays) == (N <= 7)
    assert chip_smoke.gen_layouts_on(dev, *shape) == \
        chip_smoke.gen_layouts_on(dev, *shape, 1)


def test_describe_gen_layout_names_the_row_groups():
    lay = gk.units_layout_for(*_shape()[:5], 16, 2, 70, 4)
    assert '4 row groups' in chip_smoke.describe_gen_layout(lay)
    assert 'row groups' not in chip_smoke.describe_gen_layout(
        gk.units_layout_for(*_shape()[:5], 16, 2, 70))


def test_source_constants_agree():
    """The constants the plans mirror are the source's."""
    with open(_build.source('gen_beam.cu'), encoding='utf-8') as fh:
        src = fh.read()
    assert re.search(r'#define URT (\d+)', src).group(1) == str(gk.URT)
    assert re.search(r'#define UNT (\d+)', src).group(1) == str(gk.UNT)
    assert re.search(r'#define UMAX_VCH (\d+)', src).group(1) == \
        str(gk.UNIT_MAX_VREAL // 32)
    assert '!(RH == 1 || RH == 2)' in src and gk.ROW_HALVES == (1, 2)
    assert re.search(r'#define MAX_TOPK (\d+)', src).group(1) == \
        str(gk.MAX_TOPK)
    assert '(TR == 16 || TR == 32)' in src and sorted(gk.TILES) == [16, 32]
    assert '(CL == 4 || CL == 8 || CL == 16)' in src
    assert gk.UNIT_CLUSTERS == (4, 8, 16)
    assert 'G < 1 || G > 16 || K % G' in src
    assert gk.ROW_GROUPS == (1, 2, 4, 8, 16)
    # the G = 1 kernel is its own instantiation, the row groups another
    assert 'template <int D, bool GROUPS>' in src
    assert 'ulaunch_t<2, false>' in src and 'ulaunch_t<2, true>' in src


def test_cpu_tensors_take_the_plain_version_whatever_the_layout(
        monkeypatch):
    """On the CPU no layout is asked: the wrapper runs ``gen_beam_ref``."""
    monkeypatch.setattr(gk, 'layout_on', None)
    rng = torch.Generator().manual_seed(3)
    D, W, Vp, K = 1, 16, 8, 8
    emb = torch.randn(Vp, W, generator=rng)
    args = (emb, emb.T.contiguous(), 0.3 * torch.randn(D, 2 * W, 4 * W,
                                                       generator=rng),
            0.1 * torch.randn(D, 1, 4 * W, generator=rng))
    state0 = torch.zeros(1, K, (2 * D + 1) * W)
    cost0 = torch.full((1, K), gk.BIG)
    cost0[0, 0] = 0.0
    rec = gk.gen_beam(*args, state0, cost0, length=3, v_real=6, topk=3)
    assert rec.shape == (1, 3, 3, K)
    assert torch.equal(rec, gk.gen_beam_ref(*args, state0, cost0, length=3,
                                            v_real=6, topk=3))
