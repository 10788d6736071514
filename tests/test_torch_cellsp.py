"""The port's block-sparse cell program (ops/cellsp.py) against the JAX
package's, with identical cells.

The JAX side runs K2 (`_cell_kernel`) in Pallas interpret mode, as its own
tests do; the port runs `cells_plain`, which any CPU tensor takes. K2
itself runs only on the card (`chip_smoke.py` holds it against
`cells_plain` there). What the kernel reads on the host's behalf — the
per-output-tile entry lists — is checked here by replaying them in numpy
exactly as the kernel walks them.
"""

import numpy as np
import pytest
import torch

from butterfly_tpu.ops.cellsp import Cell as JaxCell
from butterfly_tpu.ops.cellsp import CellPlan as JaxCellPlan
from butterfly_tpu.ops.cellsp import \
    cells_from_dense_block as jax_cells_from_dense_block
from butterfly_tpu_torch.convert import cells_from_numpy
from butterfly_tpu_torch.ops.cellsp import GK, GM, Cell, CellPlan, \
    cells_from_dense_block


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


def _replay_tables(plan, bufs):
    """y as K2 computes it from the plan's entry lists: per 128-row output
    tile, every entry adds rows [w_row0, w_row0 + nrows) of its cell's
    product to rows [out_row0, +nrows) of the tile; source rows past a
    buffer's end read as zero."""
    t = {k: v.numpy() for k, v in plan._tables.items()}
    W = plan.W.numpy().astype(np.float64)
    r = bufs[0].shape[1]
    n_tiles = -(-plan.n_out // GM)
    y = np.zeros((n_tiles * GM, r))
    for kind in (0, 1):
        ptr, ent = t[f"ptr{kind}"], t[f"ent{kind}"]
        for tile in range(n_tiles):
            for widx, src, row0, packed in ent[ptr[tile]:ptr[tile + 1]]:
                o0, w0, nr = packed & 0xFF, (packed >> 8) & 0xFF, packed >> 16
                X = np.zeros((GK, r))
                b = bufs[src][row0:row0 + GK]
                X[:b.shape[0]] = b
                P = X if kind else W[widx] @ X
                y[tile * GM + o0:tile * GM + o0 + nr] += P[w0:w0 + nr]
    return y[:plan.n_out]


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
    assert np.linalg.norm(_replay_tables(plan, bufs) - want) <= 1e-5 * scale


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


@pytest.mark.parametrize("r", [1, 37])
def test_straddling_and_ragged_cells_match_dense(r):
    """dst mod 128 in {8, 120} (a cell split over two output tiles), plain
    adds that straddle or read past their buffer's end, a cell whose rows
    run past n_out, merged cells and device-made tiles, at r=1 and a
    ragged r — against a dense numpy oracle."""
    rng = np.random.default_rng(2)

    def tile():
        return rng.standard_normal((GM, GK)).astype(np.float32)

    dev = [rng.standard_normal((5, GM, GK)).astype(np.float32)]
    n_out, buf_rows = 400, [512, 300]
    cells = [Cell(8, 0, 0, tile()), Cell(120, 1, 1, tile()),
             Cell(248, 0, 3, tile()), Cell(248, 0, 3, tile()),
             Cell(136, 1, 2, None), Cell(0, 1, 0, None),
             Cell(400 - 56, 0, 1, tile()), Cell(256, 1, 0, ("dev", 0, 4))]
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
    assert np.linalg.norm(_replay_tables(plan, bufs) - want) <= 1e-5 * scale
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
