"""The kernels' launch geometry: with the thread-to-pixel map of
``pixel_index`` in ``csrc/march.cu``, written out here, the launch of both
marches (``kernels.march_geometry``) takes every ray exactly once; with the
thread-to-row map of ``sample_kernel`` in ``csrc/sample.cu``, the sampler's
launch (``kernels.sample_blocks``) takes every row exactly once."""
import pytest
import torch

from sdfest_torch.render import kernels


def pixel_map(h: int, w: int, blocks: tuple) -> torch.Tensor:
    """The pixel each thread of a launch takes, ``(*reversed(blocks),
    TILE * TILE)`` with -1 outside the rays, as ``pixel_index``: h == 0 a
    flat set of w rays in 1-D blocks; otherwise block (bx, by) is the
    16x16 tile of the (h, w) raster, thread k at (row k / 16, column
    k % 16) of the tile."""
    tile = kernels.TILE
    k = torch.arange(tile * tile)
    if h == 0:
        i = torch.arange(blocks[0])[:, None] * (tile * tile) + k
        return torch.where(i < w, i, -1)
    bx = torch.arange(blocks[0])[None, :, None]
    by = torch.arange(blocks[1])[:, None, None]
    x = bx * tile + k % tile
    y = by * tile + k // tile
    return torch.where((x < w) & (y < h), y * w + x, -1)


# the launches of the wrappers: a culling march in tiles, a march without
# culling in 1-D blocks, the warm march (always culling) in tiles
LAUNCHES = {"march": True, "march_no_culling": False, "march_warm": True}


@pytest.mark.parametrize("launch", list(LAUNCHES))
@pytest.mark.parametrize("raster", [(480, 640), (64, 80), (37, 53), (1, 7),
                                    (1, 200), (16, 16), (2, 37, 53),
                                    (1000,)])
def test_march_launch_covers_every_ray_once(raster, launch):
    tiles = LAUNCHES[launch]
    h, w, blocks = kernels.march_geometry(raster, tiles)
    n = 1
    for d in raster:
        n *= d
    threads = kernels.TILE * kernels.TILE
    if len(raster) == 1 or not tiles:  # 1-D blocks of consecutive rays
        assert h == 0 and w == n
        assert blocks == (-(-n // threads),)
    else:  # a culling raster: one block per 16x16 tile of the (h, w) image
        assert (h, w) == (n // raster[-1], raster[-1])
        assert blocks == (-(-w // 16), -(-h // 16))
    pixels = pixel_map(h, w, blocks)
    assert pixels.shape == (*reversed(blocks), threads)
    taken = pixels[pixels >= 0]
    assert taken.numel() == n
    assert torch.equal(torch.sort(taken).values, torch.arange(n))
    if h == 0:
        assert torch.equal(taken, torch.arange(n))
    else:
        rows, cols = taken // w, taken % w
        for b in range(pixels.shape[0] * pixels.shape[1]):
            p = pixels.reshape(-1, threads)[b]
            p = p[p >= 0]
            by, bx = divmod(b, blocks[0])
            assert bool(((p // w) // 16 == by).all())
            assert bool(((p % w) // 16 == bx).all())
        assert int(rows.max()) == h - 1 and int(cols.max()) == w - 1


def row_map(n: int, blocks: int) -> torch.Tensor:
    """The row each thread of a sample launch takes, ``(blocks, TILE *
    TILE)`` with -1 outside the rows, as ``sample_kernel``: thread k of
    block b on row b * TILE * TILE + k."""
    threads = kernels.TILE * kernels.TILE
    r = torch.arange(blocks)[:, None] * threads + torch.arange(threads)
    return torch.where(r < n, r, -1)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1001, 307_200])
def test_sample_launch_covers_every_row_once(n, offset):
    """Every row is taken by exactly one thread, in order, whether the
    rows start at a tensor's base or one row past it (the kernel reads each
    row's own floats, so its launch does not depend on the base)."""
    rows = torch.arange(n + offset)[offset:]  # a view one row in, or not
    blocks = kernels.sample_blocks(rows.numel())
    assert blocks == -(-n // (kernels.TILE * kernels.TILE))
    taken = row_map(n, blocks)
    assert torch.equal(taken[taken >= 0], torch.arange(n))
    assert int((taken < 0).sum()) == blocks * kernels.TILE ** 2 - n
    assert torch.equal(rows[taken[taken >= 0]], torch.arange(n) + offset)
