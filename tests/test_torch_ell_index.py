"""The index fields the ELL kernels B and D read (ops/mesh.with_kernel_index,
ops/ell_kernels), checked on the CPU on small meshes, without the card:

  * B's segment index (int32 group bases, uint8 offsets in the group,
    perm padded to 16 bytes) rebuilds the int32 segment offsets (the
    exclusive cumsum of mat_lens / vec_lens) exactly, and refuses a group
    of more than 255 contributions (a segment longer than 255, too);
  * B's tiles (ops/mesh.segment_tiles) cover the groups in runs of whole
    16-group units within the plan's bounds, and a unit beyond a stage is
    refused;
  * a plain emulation of B's two phases on those fields (a tile's range
    of perm staged from 16 bytes below its start, its locals gathered,
    then each output's segment summed from 0 in order), on the plan of
    ell_kernels.assemble_plan and on tiles as short as the mesh's units
    allow, equals assembly.scatter_matrix / scatter_vector bit for bit in
    f32 and f64;
  * B's plans fit shared memory and keep its bulk copies on 16 bytes;
  * D's columns (ell_kernels.rv_columns: the int16 codes, or patch_cols32)
    decode to patch_cols32, padding included.
The kernels themselves run on the card: tests/test_torch_cuda_blocked.py.
"""

import numpy as np
import pytest
import torch

from conservation_fem_tpu_torch.ops import assembly
from conservation_fem_tpu_torch.ops import ell_kernels as ek
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.ops import spaces
from conservation_fem_tpu_torch.ops.tiling import tile_mesh

MESHES = ("irr", "rect", "p2", "tiled")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run shares the cores among several
    pytest worker processes, where torch's thread pool only
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(case):
    if case == "irr":
        m = tmesh.irregular_mesh((-2, -2), (2, 2), nx=16, seed=1)
        return tmesh.reorder_mesh(m, tmesh.rcm_permutation(m))
    if case == "rect":
        return tmesh.rectangle_mesh((-2, -2), (2, 2), nx=12)
    if case == "p2":
        return spaces.build_space(tmesh.irregular_mesh(nx=8, seed=2), 2)
    # a tile-slot mesh: its phantom slots have empty patches and segments
    m, _ = tile_mesh(tmesh.irregular_mesh((-2, -2), (2, 2), nx=16, seed=1))
    assert not m.slot_valid.all()
    return m


def _arrays(case, dtype=torch.float64):
    return tmesh.with_kernel_index(_host(case).device_arrays(dtype, "cpu"))


def _modes(m):
    """{mode: (perm32, off8, base32, tile32, lens, perm, outputs'
    shape)}."""
    n, K = m.patch_cols.shape
    return {"matrix": (m.mat_perm32, m.mat_off8, m.mat_base32, m.mat_tile32,
                       m.mat_lens, m.mat_perm, (n, K)),
            "vector": (m.vec_perm32, m.vec_off8, m.vec_base32, m.vec_tile32,
                       m.vec_lens, m.vec_perm, (n,))}


def _segments(off8, base):
    """(start, end) of every segment, padding included: base[g] + off[e]
    to the next segment's start in the group, or to base[g + 1]."""
    groups = base.numel() - 1
    W = off8.numel() // groups
    start = (base[:-1].long()[:, None] + off8.long().view(groups, W))
    end = torch.cat([start[:, 1:], base[1:].long()[:, None]], 1)
    return start.reshape(-1), end.reshape(-1)


@pytest.mark.parametrize("case", MESHES)
def test_segment_index_rebuilds_offsets(case):
    """Each output's start, its group's base plus its offset in the group,
    is the int32 offset the kernel read before (the exclusive cumsum of
    the lengths), and its end the next one; the padding is empty; perm32
    is the order, padded with zeros to PERM_ALIGN entries."""
    m = _arrays(case)
    widths = {"matrix": m.patch_cols.shape[1], "vector": tmesh.VEC_GROUP}
    for mode, (perm32, off8, base, _, lens, perm, shape) in \
            _modes(m).items():
        W, n = widths[mode], lens.numel()
        groups = base.numel() - 1
        assert off8.dtype == torch.uint8 and base.dtype == torch.int32
        assert perm32.dtype == torch.int32
        assert groups % tmesh.SEGMENT_GROUPS == 0
        assert groups * W >= n > (groups - tmesh.SEGMENT_GROUPS) * W
        assert off8.numel() == groups * W
        offs = torch.zeros(n + 1, dtype=torch.int64)
        torch.cumsum(lens, 0, out=offs[1:])
        start, end = _segments(off8, base)
        assert torch.equal(start[:n], offs[:-1])
        assert torch.equal(end[:n], offs[1:])
        assert torch.equal(start[n:], end[n:])      # the padding is empty
        assert torch.equal(base[1:].long(),
                           offs[torch.clamp(torch.arange(1, groups + 1) * W,
                                            max=n)])
        assert perm32.numel() % tmesh.PERM_ALIGN == 0
        assert perm32.numel() - perm.numel() < tmesh.PERM_ALIGN
        assert torch.equal(perm32[:perm.numel()].long(), perm)
        assert not perm32[perm.numel():].any()


def test_segment_index_refuses_long_segments():
    """A group of MAX_GROUP contributions is indexed; one more (in one
    segment, or over the group's segments) is refused."""
    big = tmesh.MAX_GROUP
    lens = torch.tensor([3, 0, big - 4, 1, big, 0, 0, 0])
    off8, base = tmesh.segment_index(lens, 4)
    assert off8[:8].tolist() == [0, 3, 3, big - 1, 0, big, big, big]
    assert base[:3].tolist() == [0, big, 2 * big]
    for bad in ([3, 0, big - 3, 1], [big + 1, 0, 0, 0]):
        with pytest.raises(ValueError, match="group"):
            tmesh.segment_index(torch.tensor(bad), 4)


def _emulate(vals, perm32, off8, base, tile32, n_out, cap):
    """Kernel B's two phases tile by tile (csrc/ell.cu ell_assemble_kernel),
    in the dtype of ``vals`` (flat locals in cell order): the outputs."""
    groups = base.numel() - 1
    W = off8.numel() // groups
    start, end = _segments(off8, base)
    out = torch.full((groups * W,), float("nan"), dtype=vals.dtype)
    for (g0, j0), (g1, j1) in zip(tile32[:-1].tolist(), tile32[1:].tolist()):
        gn = g1 - g0
        assert (j0, j1) == (int(base[g0]), int(base[g1]))
        a0, a1 = j0 & ~3, (j1 + 3) & ~3
        assert a1 <= perm32.numel()          # the copy stays in perm32
        assert a1 - a0 <= cap                # perm staged from a0
        stage = perm32[a0:a1]
        locals_ = vals[stage[j0 - a0:j1 - a0].long()]
        tile = slice(g0 * W, (g0 + gn) * W)
        starts, lens = start[tile] - j0, end[tile] - start[tile]
        acc = torch.zeros(gn * W, dtype=vals.dtype)
        for q in range(int(lens.max())):
            take = q < lens
            v = locals_[torch.where(take, starts + q, 0)]
            acc = torch.where(take, acc + v, acc)
        out[g0 * W:(g0 + gn) * W] = acc
    return out[:n_out]


def _largest_unit(base):
    """The most contributions a SEGMENT_GROUPS-group unit of ``base``
    holds."""
    return int(torch.diff(base[::tmesh.SEGMENT_GROUPS].long()).max())


@pytest.mark.parametrize("case", MESHES)
def test_segment_tiles(case, monkeypatch):
    """B's tiles: runs of whole SEGMENT_GROUPS-group units from the first
    group to the last, each within ASSEMBLE_TILE contributions and
    ASSEMBLE_MAX_GROUPS groups, and no run one unit longer would fit
    (greedy); the same with a bound of the mesh's largest unit (short
    tiles, empty units run together); a bound below it is refused."""
    m, tile = _arrays(case), tmesh.ASSEMBLE_TILE
    for mode in ("mat", "vec"):
        base = getattr(m, f"{mode}_base32").long()
        largest = _largest_unit(base)
        assert largest <= tile
        monkeypatch.setattr(tmesh, "ASSEMBLE_TILE", largest - 1)
        with pytest.raises(ValueError, match="tile holds"):
            tmesh.segment_tiles(getattr(m, f"{mode}_base32"))
        for bound in (tile, largest):
            monkeypatch.setattr(tmesh, "ASSEMBLE_TILE", bound)
            t = tmesh.segment_tiles(getattr(m, f"{mode}_base32")).long()
            groups = base.numel() - 1
            g, j = t[:, 0], t[:, 1]
            assert t.dtype == torch.long and g[0] == 0 and g[-1] == groups
            assert torch.equal(j, base[g])
            sizes, lengths = j[1:] - j[:-1], g[1:] - g[:-1]
            assert (lengths > 0).all()
            assert (lengths % tmesh.SEGMENT_GROUPS == 0).all()
            assert (lengths <= tmesh.ASSEMBLE_MAX_GROUPS).all()
            assert (sizes <= bound).all()
            longer = torch.clamp(g[1:] + tmesh.SEGMENT_GROUPS, max=groups)
            grown = (base[longer] - j[:-1] <= bound) & (
                lengths < tmesh.ASSEMBLE_MAX_GROUPS) & (g[1:] < groups)
            assert not grown.any()


def test_segment_tiles_refuse_units_beyond_a_stage():
    """A unit of SEGMENT_GROUPS groups holding ASSEMBLE_TILE contributions
    is a tile; one more contribution in it is refused."""
    G, tile = tmesh.SEGMENT_GROUPS, tmesh.ASSEMBLE_TILE
    for extra, ok in ((0, True), (1, False)):
        sizes = torch.zeros(3 * G, dtype=torch.int64)
        sizes[G] = tile - 1 + extra     # the second unit
        sizes[2 * G - 1] = 1
        sizes[2 * G] = 5
        base = torch.zeros(3 * G + 1, dtype=torch.int32)
        base[1:] = torch.cumsum(sizes, 0)
        if not ok:
            with pytest.raises(ValueError, match="tile holds"):
                tmesh.segment_tiles(base)
            continue
        t = tmesh.segment_tiles(base)
        assert t[:, 0].tolist() == [0, 2 * G, 3 * G]
        assert t[:, 1].tolist() == [0, tile, tile + 5]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", MESHES)
def test_assemble_emulation_bit_equal(case, dtype, monkeypatch):
    """B's two phases on the segment index, on its tiles and plan (each
    tile staging its range of perm) and on tiles no longer than the
    mesh's largest unit (many tiles), bit-equal to the plain scatter."""
    m = _arrays(case, dtype)
    n, K = m.patch_cols.shape
    nd = m.mat_perm.numel() // m.vec_perm.numel()
    M = m.vec_perm.numel() // nd
    rng = np.random.default_rng(11)
    mats = torch.as_tensor(rng.standard_normal((M, nd, nd)), dtype=dtype)
    vecs = torch.as_tensor(rng.standard_normal((M, nd)), dtype=dtype)
    want = {"matrix": assembly.scatter_matrix(m, mats).reshape(-1),
            "vector": assembly.scatter_vector(m, vecs)}
    got_vals = {"matrix": mats.reshape(-1), "vector": vecs.reshape(-1)}
    for mode, (perm32, off8, base, tiles, _, perm, shape) in \
            _modes(m).items():
        groups = base.numel() - 1
        W = off8.numel() // groups
        plan = ek.assemble_plan(W, mats.element_size())
        monkeypatch.setattr(tmesh, "ASSEMBLE_TILE", _largest_unit(base))
        units = tmesh.segment_tiles(base)
        monkeypatch.undo()
        assert units.shape[0] >= tiles.shape[0]
        for t in (tiles, units):
            got = _emulate(got_vals[mode], perm32, off8, base, t,
                           int(np.prod(shape)), plan.cap)
            assert torch.equal(got, want[mode]), (mode, t.shape[0])


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("width", [1, 9, 11, 16, 19, 37, 64])
def test_assemble_plan(width, itemsize):
    """B's plan: a stage of perm holding a tile's bound of contributions
    and the rounding to 16 bytes at both ends (a multiple of PERM_ALIGN
    entries), shared memory as the kernel carves it (its stages starting
    on 16 bytes), within the limit."""
    p = ek.assemble_plan(width, itemsize)
    assert p.groups == tmesh.ASSEMBLE_MAX_GROUPS
    assert p.groups % tmesh.SEGMENT_GROUPS == 0
    assert p.cap % tmesh.PERM_ALIGN == 0
    assert p.cap >= tmesh.ASSEMBLE_TILE + 2 * (tmesh.PERM_ALIGN - 1)
    assert p.smem == (80 + p.cap * (8 + itemsize) + 2 * p.groups * width
                      + 8 * p.groups)
    assert p.smem <= ek.SMEM_CAP
    assert (80 + 8 * p.cap) % ek.BULK_ALIGN == 0
    assert (80 + 8 * p.cap + 2 * p.groups * width) % ek.BULK_ALIGN == 0


@pytest.mark.parametrize("case", MESHES + ("even", "far"))
def test_rv_columns_decode(case):
    """D's columns decode to patch_cols32, the padding to the row itself:
    the int16 codes as i + (c >> 1) (bc bit ignored) where the mesh has
    them and K is odd, else patch_cols32 itself ("even": K padded to an
    even width; "far": a patch reaching D16_REACH rows, no codes)."""
    if case in ("even", "far"):
        a = _host("irr").device_arrays(torch.float64, "cpu")
        rows = torch.arange(a.patch_cols.shape[0])[:, None]
        if case == "even":
            a = a._replace(patch_cols=torch.cat([a.patch_cols, rows], 1),
                           patch_mask=torch.cat(
                               [a.patch_mask, torch.zeros_like(rows).bool()],
                               1))
        else:
            n = a.patch_cols.shape[0]
            a = a._replace(
                patch_cols=torch.where(rows == 0, tmesh.D16_REACH,
                                       a.patch_cols),
                boundary_mask=torch.cat([a.boundary_mask, torch.zeros(
                    tmesh.D16_REACH + 1 - n, dtype=torch.bool)]))
        m = tmesh.with_kernel_index(a)
    else:
        m = _arrays(case)
    cols = ek.rv_columns(m)
    n, K = m.patch_cols32.shape
    narrow = m.patch_cols_d16 is not None and K % 2 == 1
    assert (cols.dtype == torch.int16) == narrow
    assert narrow == (case != "far" and K % 2 == 1)
    rows = torch.arange(n)[:, None]
    got = rows + (cols.long() >> 1) if narrow else cols.long()
    assert torch.equal(got, m.patch_cols32.long())
    if case != "far":
        assert torch.equal(got[~m.patch_mask],
                           rows.expand(n, K)[~m.patch_mask])
    assert (ek.spmv_columns(m).dtype == torch.int16) == narrow
