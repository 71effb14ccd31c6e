"""The band plan of the single and block step kernels
(ops/fused_step.band_plan, csrc/band_sweep.cuh) on the CPU: bands that
cover the grid's rows once, halos held by the CTAs the plan names, shared
memory within what a block may take, and the CTA counts at the main-path
shapes. The kernels take the plan as arguments; on the card they are held
to their plain versions in tests/test_torch_cuda_kernels.py."""

import pytest

from conservation_fem_tpu_torch.ops import fused_step as fs

SMS = 132   # the H100's SMs
LIMIT = 270 * 2**10   # bytes per field of _fused_mode's single kernel


def _owners(plan):
    """{node: CTA} of every node a plan's bands cover."""
    return {n: b for b in range(plan["ctas"])
            for n in range(plan["starts"][b], plan["starts"][b + 1])}


def _block(B, n1y, row0, n_rows):
    """(B, n1y, rows in the grid) of a block of B rows at global row row0."""
    return B, n1y, fs.block_rows(B, row0, n_rows)


# whole grids: mesh 2, 4, 16 (bands thin, CTAs few), an uneven split; row
# blocks of mesh 16 (3 blocks, D 32: rows above the grid, padding rows
# below it) and mesh 64 x 4 (first, interior, last block)
SHAPES = [(3, 3, None), (5, 5, None), (17, 17, None), (67, 31, None),
          _block(70, 17, -32, 17), _block(70, 17, -26, 17),
          _block(70, 17, -20, 17), _block(189, 257, -62, 257),
          _block(189, 257, 3, 257), _block(189, 257, 133, 257)]


@pytest.mark.parametrize("n1x,n1y,rows", SHAPES)
@pytest.mark.parametrize("itemsize,min_nodes", [(4, None), (8, None),
                                                (8, 1)])
def test_bands_cover_the_grid_rows_once_and_hold_their_halos(n1x, n1y, rows,
                                                             itemsize,
                                                             min_nodes):
    """min_nodes 1: as many bands as the rows allow (the thin bands the
    CUDA tests also run)."""
    plan = fs.band_plan(n1x, n1y, itemsize, SMS, rows, min_nodes=min_nodes)
    lo, hi = rows if rows is not None else (0, n1x)
    starts = plan["starts"]
    assert starts[0] == lo * n1y and starts[-1] == hi * n1y
    assert all(a < b for a, b in zip(starts, starts[1:]))
    owners = _owners(plan)
    assert sorted(owners) == list(range(lo * n1y, hi * n1y))
    sizes = [b - a for a, b in zip(starts, starts[1:])]
    assert min(sizes) >= n1y + 1 or plan["ctas"] == 1
    assert max(sizes) == plan["cap"] and max(sizes) - min(sizes) <= 1
    assert plan["ctas"] <= SMS
    want = min(SMS, (hi - lo) * n1y // (n1y + 1),
               -(-(hi - lo) * n1y // (min_nodes or fs.BAND_MIN_NODES)))
    assert plan["ctas"] == max(1, want)
    # what a band reads at neighbours: n1y + 1 nodes on either side, inside
    # the grid's rows, lies in the bands the plan names
    for b, (below, above) in enumerate(plan["halo"]):
        s0, s1 = starts[b], starts[b + 1]
        halo = [n for n in range(s0 - n1y - 1, s1 + n1y + 1)
                if lo * n1y <= n < hi * n1y and not s0 <= n < s1]
        held = {owners[n] for n in halo}
        assert held <= {c for c in (below, above) if c is not None}
        assert (below is None) == (b == 0)
        assert (above is None) == (b == plan["ctas"] - 1)


def _single_limit_shapes(itemsize):
    """Square and flat grids at the single kernel's 270 KiB per field."""
    nodes = LIMIT // itemsize
    side = int(nodes ** 0.5)
    return [(side, side), (nodes // 400, 400), (4, nodes // 4)]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_shared_memory_fits_a_block(itemsize):
    """At the single limit in f32 and f64, at the sharded block kernel's
    blocks up to mesh 512 x 4 (637 x 2049), the plan's shared memory and
    the kernels' static share stay within the 227 KB a block may take;
    square grids at the limit stage all three operators and tabulate each
    band in one chunk."""
    shapes = _single_limit_shapes(itemsize) + [(189, 257), (253, 513),
                                               (381, 1025), (637, 2049)]
    for n1x, n1y in shapes:
        plan = fs.band_plan(n1x, n1y, itemsize, SMS)
        assert plan["smem"] + fs.BAND_STATIC_SMEM <= fs.SMEM_OPTIN == 232448
        assert 1 <= plan["chunk"] <= plan["cap"]
        assert plan["quad_cells"] == fs.quad_cells(plan["chunk"], n1y)
    side = _single_limit_shapes(itemsize)[0]
    plan = fs.band_plan(*side, itemsize, SMS)
    assert plan["staged"] == 3 and plan["chunk"] == plan["cap"]
    with pytest.raises(ValueError, match="shared memory"):
        fs.band_plan(17, 17, itemsize, SMS, smem_cap=40 * itemsize)


@pytest.mark.parametrize("name,shape,itemsize,cap", [
    ("KPP mesh 64", (257, 257), 4, 501),
    ("Burgers mesh 200", (201, 201), 4, 307),
    ("KPP block 189 x 257", (189, 257), 4, 368),
    ("single limit f32", (262, 263), 4, 523),
    ("single limit f64", (185, 185), 8, 260)])
def test_cta_counts_at_the_main_path_shapes(name, shape, itemsize, cap):
    """One CTA per SM at every main-path shape, the whole band staged."""
    assert shape[0] * shape[1] * itemsize <= LIMIT or "block" in name
    plan = fs.band_plan(*shape, itemsize, SMS)
    assert plan["ctas"] == SMS, name
    assert plan["cap"] == cap <= 524
    assert plan["staged"] == 3 and plan["chunk"] == cap


def test_quadrature_chunks_cover_their_cells():
    """QuadCells: the cells the nodes of a chunk read (lower-left nodes
    n - n1y - 1, n - n1y, n - 1, n) each get one slot, none twice."""
    n1y = 9
    for c0, c1 in ((30, 31), (30, 37), (30, 40), (30, 60)):
        a0, a1 = c0 - n1y - 1, c1 - n1y
        b0 = max(c0 - 1, a1)
        cells = list(range(a0, a1)) + list(range(b0, c1))
        assert len(cells) == len(set(cells)) == fs.quad_cells(c1 - c0, n1y)
        for n in range(c0, c1):
            assert {n - n1y - 1, n - n1y, n - 1, n} <= set(cells)
