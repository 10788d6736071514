"""The port's block-sparse cell program (ops/cellsp.py) against the JAX
package's, with identical cells.

The JAX side runs K2 (`_cell_kernel`) in Pallas interpret mode, as its own
tests do; the port runs `cells_plain`, which any CPU tensor takes. K2
itself runs only on the card (`chip_smoke.py` holds it against
`cells_plain` there). What the kernel reads on the host's behalf — the
per-output-tile entry lists, and the slices of its matrix-vector engine —
is checked here by replaying them in numpy as the kernel walks them.
"""

import numpy as np
import pytest
import torch

from butterfly_tpu.ops.cellsp import Cell as JaxCell
from butterfly_tpu.ops.cellsp import CellPlan as JaxCellPlan
from butterfly_tpu.ops.cellsp import \
    cells_from_dense_block as jax_cells_from_dense_block
from butterfly_tpu_torch.convert import cells_from_numpy
from butterfly_tpu_torch.ops.cellsp import _KC, _MV_MAX_R, _SLICE_CHUNKS, \
    GK, GM, K2, Cell, CellPlan, cells_from_dense_block, cells_plain, \
    k2_engine


def _dense_from_cells(cells, n_out, n_in, dev_tiles=()):
    A = np.zeros((n_out + GM, n_in))
    for c in cells:
        rows = slice(c.dst, c.dst + GM)
        cols = slice(c.src_blk * GK, (c.src_blk + 1) * GK)
        if c.w is None:
            A[rows, cols] += np.eye(GM)
        elif isinstance(c.w, tuple):
            A[rows, cols] += dev_tiles[c.w[1]][c.w[2]]
        else:
            A[rows, cols] += c.w
    return A[:n_out]


def _source(bufs, src, row0):
    """The GK source rows of a cell; rows past a buffer's end read as 0."""
    X = np.zeros((GK, bufs[0].shape[1]))
    b = bufs[src][row0:row0 + GK]
    X[:b.shape[0]] = b
    return X


def _replay_tables(plan, bufs):
    """y as K2 computes it from the plan's tables, in numpy, twice.

    From the groups, as the kernel walks them: output tiles in the plan's
    order; each group takes the source rows [row0 + k0, row0 + k1) once,
    and every 8-row group of the tile that it covers adds the product of
    the matching 8 rows of its weight tile, columns [k0, k1). From the
    matmul entries: rows [out_row0, +nrows) of the tile add rows [w_row0,
    +nrows) of the entry's product over its own depth [k0, k1). Plain adds
    go into both. Returns (y from the groups, y from the entries, flops per
    column of the groups)."""
    t = {k: v.numpy() for k, v in plan._tables.items()}
    t["ptr0"], t["ent0"] = plan.entries
    W = plan.W.numpy().astype(np.float64)
    r = bufs[0].shape[1]
    n_tiles = -(-plan.n_out // GM)
    assert sorted(t["order"]) == list(range(n_tiles))
    yg = np.zeros((n_tiles * GM, r))
    ye = np.zeros((n_tiles * GM, r))
    flops = 0
    for tile in t["order"]:
        for g in t["grp"][t["gptr"][tile]:t["gptr"][tile + 1]]:
            src, row0, kc, mask = g[:4]
            k0, k1 = (kc & 0xFF) * _KC, (kc >> 8) * _KC
            assert 0 <= k0 < k1 <= GK
            X = _source(bufs, src, row0)
            for rg in range(GM // 8):
                slot = g[4 + rg]
                assert (slot >= 0) == bool(mask >> rg & 1)
                if slot >= 0:
                    w, wrg = divmod(int(slot), GM // 8)
                    rows = slice(tile * GM + 8 * rg, tile * GM + 8 * rg + 8)
                    yg[rows] += W[w][8 * wrg:8 * wrg + 8, k0:k1] @ X[k0:k1]
                    flops += 2 * 8 * (k1 - k0)
        for kind in (0, 1):
            ptr, ent = t[f"ptr{kind}"], t[f"ent{kind}"]
            for widx, src, row0, p in ent[ptr[tile]:ptr[tile + 1]]:
                o0, w0, nr = p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF
                k0, k1 = (p >> 24 & 7) * _KC, (p >> 27 & 15) * _KC
                X = _source(bufs, src, row0)
                rows = slice(tile * GM + o0, tile * GM + o0 + nr)
                if kind:
                    yg[rows] += X[w0:w0 + nr]
                    ye[rows] += X[w0:w0 + nr]
                else:
                    ye[rows] += W[widx][w0:w0 + nr, k0:k1] @ X[k0:k1]
    return yg[:plan.n_out], ye[:plan.n_out], flops


def _random_blocks(rng, n_out, n_in, count, lo, hi, span, make):
    cells = []
    for _ in range(count):
        i0 = int(rng.integers(0, (n_out - span) // 2)) * 2
        j0 = int(rng.integers(0, (n_in - span) // 2)) * 2
        nr, nc = (int(rng.integers(lo, hi)), int(rng.integers(lo, hi))) \
            if hi > lo else (lo, lo)
        W = rng.standard_normal((nr, nc)).astype(np.float32) / 8
        make(W, i0, j0, cells)
    return cells


# The four configurations of tests/test_cellsp.py. Each returns
# (n_out, buf_rows, JAX cells, r, JAX module constants to override): the
# banded and segmented ones shrink the JAX plan's VMEM and SMEM budgets as
# that file does, so that the JAX side really runs several bands (with
# empty-band fillers) and several kernel segments; the port has neither.
def _dense_case(rng):
    cells = _random_blocks(rng, 640, 512, 6, 16, 180, 200,
                           jax_cells_from_dense_block)
    return 640, [512], cells, 36, {}


def _banded_case(rng):
    cells = _random_blocks(rng, 4096, 512, 24, 130, 130, 200,
                           jax_cells_from_dense_block)
    return 4096, [512], cells, 8, {"_OUT_BUDGET_BYTES": 1 << 20}


def _add_multibuf_case(rng):
    cells = []
    jax_cells_from_dense_block(
        rng.standard_normal((128, 128)).astype(np.float32) / 8, 0, 0, cells)
    cells.append(JaxCell(dst=128, src_buf=1, src_blk=1, w=None))
    cells.append(JaxCell(dst=264, src_buf=1, src_blk=0, w=None))
    return 512, [256, 256], cells, 12, {}


def _segments_case(rng):
    cells = _random_blocks(rng, 2048, 512, 30, 100, 100, 200,
                           jax_cells_from_dense_block)
    return 2048, [512], cells, 8, {"_OUT_BUDGET_BYTES": 1 << 20,
                                   "_SEG_CELL_CAP": 10 * 7}


@pytest.mark.parametrize("case", [_dense_case, _banded_case,
                                  _add_multibuf_case, _segments_case],
                         ids=["dense", "banded", "add_multibuf", "segments"])
def test_cell_plan_matches_jax(case, monkeypatch):
    from butterfly_tpu.ops import cellsp as jax_cellsp

    rng = np.random.default_rng(0)
    n_out, buf_rows, jcells, r, budgets = case(rng)
    bufs = [rng.standard_normal((b, r)).astype(np.float32)
            for b in buf_rows]
    plan = CellPlan(n_out, buf_rows, cells_from_numpy(jcells), device="cpu")
    for name, value in budgets.items():
        monkeypatch.setattr(jax_cellsp, name, value)
    jplan = JaxCellPlan(n_out, buf_rows, list(jcells), r_tile=512,
                        precision="highest", interpret=True)
    if budgets:
        assert jplan._meta.n_bands > 2
    if "_SEG_CELL_CAP" in budgets:
        assert jplan.num_segments > 1
    want = np.asarray(jplan.apply(bufs), np.float64)
    got = plan.apply([torch.from_numpy(b) for b in bufs])
    assert got.shape == (n_out, r) and got.dtype == torch.float32
    scale = np.linalg.norm(want)
    assert np.linalg.norm(got.double().numpy() - want) <= 1e-5 * scale
    for y in _replay_tables(plan, bufs)[:2]:
        assert np.linalg.norm(y - want) <= 1e-5 * scale


def test_cells_from_dense_block_match_jax():
    rng = np.random.default_rng(1)
    W = rng.standard_normal((70, 150)).astype(np.float32)
    jcells, cells = [], []
    jax_cells_from_dense_block(W, 34, 202, jcells)
    cells_from_dense_block(W, 34, 202, cells)
    assert [(c.dst, c.src_buf, c.src_blk) for c in cells] == [
        (c.dst, c.src_buf, c.src_blk) for c in jcells]
    for c, j in zip(cells, jcells):
        np.testing.assert_array_equal(c.w, j.w)


def _straddling_cells(rng):
    """dst mod 128 in {8, 120} (a cell split over two output tiles), plain
    adds that straddle or read past their buffer's end, a cell whose rows
    run past n_out, two cells that merge and a device-made tile. Returns
    (n_out, buf_rows, cells, device stacks)."""

    def tile():
        return rng.standard_normal((GM, GK)).astype(np.float32)

    dev = [rng.standard_normal((5, GM, GK)).astype(np.float32)]
    cells = [Cell(8, 0, 0, tile()), Cell(120, 1, 1, tile()),
             Cell(248, 0, 3, tile()), Cell(248, 0, 3, tile()),
             Cell(136, 1, 2, None), Cell(0, 1, 0, None),
             Cell(400 - 56, 0, 1, tile()), Cell(256, 1, 0, ("dev", 0, 4))]
    return 400, [512, 300], cells, dev


@pytest.mark.parametrize("r", [1, 37])
def test_straddling_and_ragged_cells_match_dense(r):
    """The straddling cells (`_straddling_cells`) at r=1 and a ragged r —
    against a dense numpy oracle."""
    rng = np.random.default_rng(2)
    n_out, buf_rows, cells, dev = _straddling_cells(rng)
    plan = CellPlan(n_out, buf_rows, cells,
                    dev_tiles=[torch.from_numpy(dev[0])], device="cpu")
    assert plan.num_cells == len(cells) - 1  # the two at (248, 0, 3) merge
    bufs = [rng.standard_normal((b, r)).astype(np.float32)
            for b in buf_rows]
    X = np.concatenate([np.pad(b, ((0, 384 - b.shape[0]), (0, 0)))
                        if b.shape[0] < 384 else b for b in bufs])
    # buffer 1 starts at block 4 of the concatenation
    shifted = [Cell(c.dst, 0, c.src_blk + 4 * c.src_buf, c.w) for c in cells]
    want = _dense_from_cells(shifted, n_out, X.shape[0], dev) @ X
    got = plan.apply([torch.from_numpy(b) for b in bufs]).double().numpy()
    scale = np.linalg.norm(want)
    assert np.linalg.norm(got - want) <= 1e-5 * scale
    for y in _replay_tables(plan, bufs)[:2]:
        assert np.linalg.norm(y - want) <= 1e-5 * scale
    # a buffer shorter than its declared rows reads as zero-padded
    short = [bufs[0], bufs[1][:200]]
    X[512 + 200:] = 0.0
    want = _dense_from_cells(shifted, n_out, X.shape[0], dev) @ X
    got = plan.apply([torch.from_numpy(b) for b in short]).double().numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_useful_flops_leave_out_padding():
    """A block's edge tiles count their nonzero rows times nonzero columns;
    the padded count takes every matmul cell as a full tile; plain adds
    count neither."""
    rng = np.random.default_rng(3)
    cells = []
    # 70 x 150 at row shift 2, column shift 74: tile (0, 0) holds 54
    # columns, tile (0, 1) the other 96; device tile of 5 nonzero rows
    cells_from_dense_block(rng.standard_normal((70, 150)), 34, 202, cells)
    dev = np.zeros((1, GM, GK), np.float32)
    dev[0, :5] = 1.0
    cells += [Cell(256, 0, 0, ("dev", 0, 0)), Cell(384, 0, 1, None)]
    plan = CellPlan(512, [512], cells, dev_tiles=[torch.from_numpy(dev)],
                    device="cpu")
    assert plan.num_matmul_cells == 3
    assert plan.flops_per_col() == 2 * 3 * GM * GK
    assert plan.useful_flops_per_col() == 2 * (70 * 54 + 70 * 96 + 5 * GK)


def test_cell_plan_rejects_bad_cells_and_buffers():
    from butterfly_tpu_torch.utils.errors import InvalidArgumentsError

    w = np.zeros((GM, GK), np.float32)
    with pytest.raises(InvalidArgumentsError):
        CellPlan(256, [256], [Cell(4, 0, 0, w)], device="cpu")  # dst % 8
    with pytest.raises(InvalidArgumentsError):
        CellPlan(256, [256], [Cell(0, 0, 2, w)], device="cpu")  # past buf
    plan = CellPlan(256, [256], [Cell(0, 0, 0, w)], device="cpu")
    with pytest.raises(InvalidArgumentsError):
        plan.apply([torch.zeros((300, 4))])  # more rows than declared
    with pytest.raises(InvalidArgumentsError):
        plan.apply([torch.zeros((256, 4), dtype=torch.float64)])


def _rank_padded_cells(rng):
    """Dense blocks at sub-8 and sub-128 row and column shifts, and the
    low-rank tiles of one member at rank 80 (V: zero rows past 80) and 96
    (U: zero columns past 96), as a partition plan makes them; the member
    window's rows past 300 are zero too."""
    cells = []
    for i0, j0, nr, nc in ((2, 6, 70, 150), (134, 250, 200, 40),
                           (388, 0, 9, 300), (517, 131, 120, 64)):
        cells_from_dense_block(rng.standard_normal((nr, nc)) / 8, i0, j0,
                               cells)
    V = np.zeros((3, GM, GK), np.float32)
    V[:, :80] = rng.standard_normal((3, 80, GK)) / 8
    V[2, :, 44:] = 0.0  # the window ends at column 300 = 2 * 128 + 44
    U = np.zeros((3, GM, GK), np.float32)
    U[:, :, :96] = rng.standard_normal((3, GM, 96)) / 8
    U[2, 44:] = 0.0  # and at row 300
    cells += [Cell(640, 0, c, ("dev", 0, c)) for c in range(3)]
    cells += [Cell(256 + 128 * c + 40, 1, 5, ("dev", 1, c))
              for c in range(3)]
    return cells, [torch.from_numpy(V), torch.from_numpy(U)]


@pytest.mark.parametrize("r", [1, 37])
def test_trimmed_tables_replay_dense(r):
    """Tiles with zero borders (block shifts, rank padding, window padding)
    replay to the dense product from the trimmed tables, and the trim cut
    work: fewer rows and depths than the padded tiles."""
    rng = np.random.default_rng(4)
    cells, dev = _rank_padded_cells(rng)
    n_out, buf_rows = 768, [512, 768]
    plan = CellPlan(n_out, buf_rows, cells, dev_tiles=list(dev),
                    device="cpu")
    bufs = [rng.standard_normal((b, r)).astype(np.float32)
            for b in buf_rows]
    X = np.concatenate(bufs)
    shifted = [Cell(c.dst, 0, c.src_blk + 4 * c.src_buf, c.w) for c in cells]
    want = _dense_from_cells(shifted, n_out, X.shape[0],
                             [d.numpy() for d in dev]) @ X
    scale = np.linalg.norm(want)
    yg, ye, _ = _replay_tables(plan, bufs)
    assert np.linalg.norm(yg - want) <= 1e-5 * scale
    assert np.linalg.norm(ye - want) <= 1e-5 * scale
    got = plan.apply([torch.from_numpy(b) for b in bufs]).double().numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * scale
    ent = plan.entries[1]
    nrows, k0 = (ent[:, 3] >> 16) & 0xFF, (ent[:, 3] >> 24 & 7) * _KC
    k1 = (ent[:, 3] >> 27 & 15) * _KC
    assert (nrows % 8 == 0).all() and (k0 % _KC == 0).all()
    assert (nrows < GM).any() and ((k1 - k0) < GK).any()
    assert plan.executed_flops_per_col() < plan.flops_per_col()


def test_straddling_cell_zero_in_one_half_is_one_entry():
    """A cell at dst % 128 == 64 whose nonzero rows all lie in one output
    tile yields one entry, not two; a cell of zeros yields none, and its
    tile is stored as zeros."""
    rng = np.random.default_rng(5)
    top = np.zeros((GM, GK), np.float32)
    top[:64] = rng.standard_normal((64, GK))  # all in tile 0
    bottom = np.zeros((GM, GK), np.float32)
    bottom[70:] = rng.standard_normal((58, GK))  # all in tile 2
    cells = [Cell(64, 0, 0, top), Cell(192, 0, 1, bottom),
             Cell(384, 0, 2, np.zeros((GM, GK), np.float32))]
    plan = CellPlan(512, [384], cells, device="cpu")
    assert plan.num_entries == (5, 2)
    assert list(np.diff(plan.entries[0])) == [1, 0, 1, 0]
    assert list(np.diff(plan._tables["gptr"].numpy())) == [1, 0, 1, 0]
    assert plan.tile_work[1] == plan.tile_work[3] == 0
    bufs = [rng.standard_normal((384, 5)).astype(np.float32)]
    want = _dense_from_cells(cells, 512, 384) @ bufs[0]
    yg, ye, _ = _replay_tables(plan, bufs)
    np.testing.assert_allclose(yg, want, rtol=0, atol=1e-9 * abs(want).max())
    np.testing.assert_allclose(ye, want, rtol=0, atol=1e-9 * abs(want).max())
    assert not want[384:].any()


def test_tile_order_and_groups():
    """The launch order is a permutation of all (tile, column tile) pairs
    with non-increasing trimmed work; a dense block's two pieces in one
    tile (same source block, disjoint rows) are staged as one group."""
    rng = np.random.default_rng(6)
    cells, dev = _rank_padded_cells(rng)
    plan = CellPlan(768, [512, 768], cells, dev_tiles=list(dev),
                    device="cpu")
    order = plan._tables["order"].numpy()
    work = plan.tile_work
    n_rtiles = 3  # r = 300
    pairs = [(order[b // n_rtiles], b % n_rtiles)
             for b in range(order.size * n_rtiles)]
    assert sorted(pairs) == [(t, c) for t in range(6)
                             for c in range(n_rtiles)]
    assert (np.diff(work[order]) <= 0).all()
    assert plan.num_groups < plan.num_entries[1]
    one = []
    cells_from_dense_block(rng.standard_normal((128, 128)), 64, 0, one)
    cells_from_dense_block(rng.standard_normal((128, 128)), 192, 0, one)
    plan = CellPlan(384, [128], one, device="cpu")
    assert plan.num_entries == (4, 4)
    assert list(np.diff(plan._tables["gptr"].numpy())) == [1, 1, 1]


def test_executed_flops_match_the_replay():
    """executed_flops_per_col() is the replay's own count and lies between
    the useful and the padded flops."""
    rng = np.random.default_rng(7)
    cells, dev = _rank_padded_cells(rng)
    plan = CellPlan(768, [512, 768], cells, dev_tiles=list(dev),
                    device="cpu")
    bufs = [np.zeros((512, 1), np.float32), np.zeros((768, 1), np.float32)]
    flops = _replay_tables(plan, bufs)[2]
    assert plan.executed_flops_per_col() == flops
    assert (plan.useful_flops_per_col() <= flops
            < plan.flops_per_col())
    assert plan.tile_work.sum() == flops


def _replay_mv(plan, bufs):
    """y as K2's matrix-vector engine computes it from the slice tables, in
    numpy: slices in launch order, warp w of a slice taking its chunks w,
    w + 8, ..., each chunk adding the 16-deep product of every 8-row group
    its group covers; the warps' sums added in warp order; then each
    tile's partials in slice order and its plain adds."""
    t = {k: v.numpy() for k, v in plan._tables.items()}
    W = plan.W.numpy().astype(np.float64)
    r = bufs[0].shape[1]
    n_tiles = t["sptr"].size - 1
    part = np.zeros((t["slices"].shape[0], GM, r))
    assert sorted(t["sorder"]) == list(range(part.shape[0]))
    for si in t["sorder"]:
        _, j0, j1, _ = t["slices"][si]
        for warp in range(8):
            acc = np.zeros((GM, r))
            for j in range(j0 + warp, j1, 8):
                g, c = t["chunks"][j]
                grp = t["grp"][g]
                X = _source(bufs, grp[0], grp[1])[c * _KC:(c + 1) * _KC]
                for rg in range(GM // 8):
                    if grp[4 + rg] >= 0:
                        w, wrg = divmod(int(grp[4 + rg]), GM // 8)
                        acc[8 * rg:8 * rg + 8] += W[w][
                            8 * wrg:8 * wrg + 8, c * _KC:(c + 1) * _KC] @ X
            part[si] += acc
    y = np.zeros((n_tiles * GM, r))
    for tile in range(n_tiles):
        rows = slice(tile * GM, (tile + 1) * GM)
        for s in range(t["sptr"][tile], t["sptr"][tile + 1]):
            y[rows] += part[s]
        for _, src, row0, p in t["ent1"][t["ptr1"][tile]:t["ptr1"][tile + 1]]:
            o0, w0, nr = p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF
            X = _source(bufs, src, row0)
            y[tile * GM + o0:tile * GM + o0 + nr] += X[w0:w0 + nr]
    return y[:plan.n_out]


def _long_tile_cells(rng):
    """One 100 x 1900 block at a sub-8 row shift: its output tile walks
    over a hundred K-chunks, so the engine cuts it into several slices; an
    empty tile below it."""
    cells = []
    cells_from_dense_block(rng.standard_normal((100, 1900)) / 8, 10, 30,
                           cells)
    return 384, [2048], cells, []


@pytest.mark.parametrize("case", ["straddling", "trimmed", "zero_half",
                                  "long_tile"])
def test_slice_tables_cover_the_groups_and_replay_dense(case):
    """The matrix-vector engine's slices cover every chunk of every group
    once and in order, hold at most _SLICE_CHUNKS chunks each, lie
    contiguous within their tile (one at least a tile) and launch heaviest
    first; a numpy replay of the engine from them matches the dense product
    at r in {1, 2, 3, _MV_MAX_R}."""
    rng = np.random.default_rng(8)
    if case == "straddling":
        n_out, buf_rows, cells, dev = _straddling_cells(rng)
    elif case == "trimmed":
        cells, dev = _rank_padded_cells(rng)
        n_out, buf_rows, dev = 768, [512, 768], [d.numpy() for d in dev]
    elif case == "zero_half":
        top = np.zeros((GM, GK), np.float32)
        top[:64] = rng.standard_normal((64, GK))
        cells = [Cell(64, 0, 0, top),
                 Cell(384, 0, 2, np.zeros((GM, GK), np.float32))]
        n_out, buf_rows, dev = 512, [384], []
    else:
        n_out, buf_rows, cells, dev = _long_tile_cells(rng)
    plan = CellPlan(n_out, buf_rows, cells,
                    dev_tiles=[torch.from_numpy(d) for d in dev],
                    device="cpu")
    t = {k: v.numpy() for k, v in plan._tables.items()}
    gptr, grp, sptr, slices = t["gptr"], t["grp"], t["sptr"], t["slices"]
    n_tiles = -(-n_out // GM)
    want = [(g, c) for g in range(plan.num_groups)
            for c in range(grp[g, 2] & 0xFF, grp[g, 2] >> 8)]
    got = [tuple(t["chunks"][j]) for _, j0, j1, _ in slices
           for j in range(j0, j1)]
    assert got == want
    assert plan.num_slices == slices.shape[0] == sptr[-1]
    assert sptr[0] == 0 and (np.diff(sptr) >= 1).all()
    assert (slices[:, 0] == np.repeat(np.arange(n_tiles),
                                      np.diff(sptr))).all()
    assert (slices[1:, 1] == slices[:-1, 2]).all()
    sizes = slices[:, 2] - slices[:, 1]
    assert (sizes >= 0).all() and (sizes <= _SLICE_CHUNKS).all()
    for tile in range(n_tiles):  # a tile's slices hold its groups' chunks
        j0, j1 = slices[sptr[tile], 1], slices[sptr[tile + 1] - 1, 2]
        assert {g for g, _ in want[j0:j1]} == set(
            range(gptr[tile], gptr[tile + 1]))
    covered = (grp[:, 4:] >= 0).sum(1) if grp.size else np.zeros(0)
    work = [sum(covered[t["chunks"][j][0]] for j in range(j0, j1))
            for _, j0, j1, _ in slices]
    assert (np.diff(np.asarray(work)[t["sorder"]]) <= 0).all()
    if case == "long_tile":
        assert sptr[1] - sptr[0] > 1
    for r in (1, 2, 3, _MV_MAX_R):
        bufs = [rng.standard_normal((b, r)).astype(np.float32)
                for b in buf_rows]
        X = np.concatenate([np.pad(b, ((0, -(-b.shape[0] // GK) * GK
                                        - b.shape[0]), (0, 0)))
                            for b in bufs])
        offs = np.concatenate([[0], np.cumsum(
            [-(-b // GK) for b in buf_rows])])
        shifted = [Cell(c.dst, 0, c.src_blk + offs[c.src_buf], c.w)
                   for c in cells]
        dense = _dense_from_cells(shifted, n_out, X.shape[0], dev) @ X
        y = _replay_mv(plan, bufs)
        assert np.linalg.norm(y - dense) <= 1e-5 * max(
            np.linalg.norm(dense), 1e-30)


def test_k2_engine_rule_and_the_cpu_path():
    """The engine follows r alone: the matrix-vector engine for 1 <= r <=
    _MV_MAX_R, the tile engine above. CellPlan.apply on CPU tensors still
    runs `cells_plain`, and launches neither engine."""
    assert [k2_engine(r) for r in (1, 2, 3, _MV_MAX_R)] == ["mv"] * 4
    assert [k2_engine(r) for r in (_MV_MAX_R + 1, 1024)] == ["tile"] * 2
    rng = np.random.default_rng(9)
    n_out, buf_rows, cells, dev = _straddling_cells(rng)
    plan = CellPlan(n_out, buf_rows, cells,
                    dev_tiles=[torch.from_numpy(dev[0])], device="cpu")
    counts = (K2.launches, K2.launches_mv, K2.launches_tile)
    for r in (1, _MV_MAX_R + 1):
        bufs = [torch.from_numpy(rng.standard_normal((b, r)).astype(
            np.float32)) for b in buf_rows]
        assert torch.equal(plan.apply(bufs), cells_plain(plan, bufs))
    assert (K2.launches, K2.launches_mv, K2.launches_tile) == counts
