"""The flagship board's pieces on the CPU (BASELINE config 4: a 65536²
board, on one device or a (4, 1) mesh), held to the JAX package.

- The packing passes (``ops/packed.py``) and the SDC fingerprint
  (``engine/backend.py``) run a row block at a time
  (``ops/stencil.py::row_blocks``); with the block made small they must
  still equal the JAX package's functions bit for bit (tolerance 0), on
  boards with leading batch axes, row counts that no block size divides
  and, for the fingerprint, a block offset.
- Config 4's full width, 65536 cells, through both packages' ``gol.run``
  at a small height: one device (the port's K2 plain version, the JAX
  ``_kernel`` in interpret mode) and a (4, 1) mesh (K9's plain version,
  the JAX ``_ext_kernel`` in interpret mode, on its virtual devices).
- Every launch plan the port chooses at 65536², on one device, (4, 1)
  and (2, 2), on an H100's 132 SMs, within the card's launch limits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_gol_torch.engine import backend as tbackend
from distributed_gol_torch.ops import cuda_adaptive, cuda_packed, packed as tpacked
from distributed_gol_torch.ops import stencil as tstencil
from distributed_gol_torch.parallel import cuda_halo
from distributed_gol_tpu.engine import backend as jbackend
from distributed_gol_tpu.ops import packed as jpacked
from distributed_gol_tpu.ops import stencil as jstencil
from tests.test_torch_run import SOUP, assert_same_run

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

#: Block sizes in cells: the default, and ones that split every board
#: below into many blocks of uneven rows (a block of fewer cells than a
#: row holds one row).
BLOCKS = [None, 100, 4096]


@pytest.fixture(params=BLOCKS, ids=lambda b: f"block-{b or 'default'}")
def block(request, monkeypatch):
    if request.param:
        monkeypatch.setattr(tstencil, "BLOCK_CELLS", request.param)
    return request.param


def cells(shape, seed, full_bytes=False):
    """A seeded board: every byte value (``full_bytes``: only the low bit
    is a cell) or {0, 255}."""
    rng = np.random.default_rng(seed)
    if full_bytes:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return np.where(rng.random(shape) < 0.4, 255, 0).astype(np.uint8)


def each_board(a: np.ndarray, fn) -> np.ndarray:
    """``fn`` (a JAX function of one 2-D board) over every board of a
    stack with any leading axes."""
    flat = a.reshape(-1, *a.shape[-2:])
    out = np.stack([np.asarray(fn(jnp.asarray(b))) for b in flat])
    return out.reshape(*a.shape[:-2], *out.shape[-2:])


def words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape", [(37, 96), (3, 64), (1, 32), (2, 3, 19, 128)])
def test_pack_and_unpack_match_jax(block, shape):
    b = cells(shape, 1, full_bytes=True)
    got = tpacked.pack(torch.from_numpy(b))
    want = each_board(b, jpacked.pack)
    assert got.dtype == torch.int32 and np.array_equal(words(got), want)
    back = tpacked.unpack(got)
    assert np.array_equal(back.numpy(), each_board(want, lambda w: jpacked.unpack(w)))
    assert np.array_equal(back.numpy(), np.where(b & 1, 255, 0))


@pytest.mark.parametrize("shape", [(96, 40), (32, 7), (2, 64, 33)])
def test_vertical_pack_and_unpack_match_jax(block, shape):
    b = cells(shape, 2, full_bytes=True)
    got = tpacked.pack_vertical(torch.from_numpy(b))
    want = each_board(b, jpacked.pack_vertical)
    assert got.shape == want.shape and np.array_equal(words(got), want)
    back = tpacked.unpack_vertical(got)
    assert np.array_equal(back.numpy(), each_board(want, jpacked.unpack_vertical))


def test_packing_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="width 48 not a multiple of 32"):
        tpacked.pack(torch.zeros((4, 48), dtype=torch.uint8))
    with pytest.raises(ValueError, match="height 40 not a multiple of 32"):
        tpacked.pack_vertical(torch.zeros((40, 32), dtype=torch.uint8))


@pytest.mark.parametrize("shape", [(53, 96), (128, 32), (7, 1000)])
def test_fingerprint_matches_jax(block, shape):
    """Whole, and as the sum of four blocks at their offsets (what
    ``ShardedBoard.reduce`` adds up on a mesh)."""
    b = cells(shape, 3)
    want = int(np.asarray(jbackend._board_fingerprint(jnp.asarray(b))))
    t = torch.from_numpy(b)
    assert int(tbackend._board_fingerprint(t)) == want
    h, w = shape
    ys, xs = (0, h // 3, h), (0, w // 2, w)
    parts = sum(int(tbackend._board_fingerprint(t[y0:y1, x0:x1], y0, x0))
                for y0, y1 in zip(ys, ys[1:]) for x0, x1 in zip(xs, xs[1:]))
    assert parts % 2**32 == want


@pytest.mark.parametrize("shape", [(53, 96), (2, 3, 40, 64)])
def test_alive_counts_match_jax(block, shape):
    b = cells(shape, 4, full_bytes=True)
    want = int(np.sum(each_board(b, lambda x: jstencil.alive_count(x)[None, None])))
    assert int(tstencil.alive_count(torch.from_numpy(b))) == want
    p = tpacked.pack(torch.from_numpy(b))
    assert int(tpacked.alive_count(p)) == want
    if len(shape) == 4:
        stack = p.reshape(-1, *p.shape[-2:])
        per_board = [int(np.asarray(jstencil.alive_count(jnp.asarray(x)))) for x in
                     b.reshape(-1, *shape[-2:])]
        assert tpacked.batched_alive_counts(stack).tolist() == per_board


@pytest.mark.parametrize("mesh,height,turns,superstep", [((1, 1), 64, 40, 20),
                                                         ((4, 1), 128, 30, 10)])
def test_config4_width_runs_like_the_jax_package(tmp_path, mesh, height, turns, superstep):
    """65536 cells wide, both packages on ``pallas-packed``: equal streams
    (turn events, final alive cells, the run's own counters and engine)
    and equal PGMs."""
    assert_same_run(tmp_path, turns=turns, superstep=superstep, image_height=height,
                    image_width=65536, engine="pallas-packed", mesh_shape=mesh,
                    turn_events="batch", **SOUP)


# -- launch limits at 65536² -----------------------------------------------------------

SIDE, SMS = 65536, 132
#: CUDA's launch limits on an H100: grid y and z, threads a block, and the
#: dynamic shared memory a block may opt into.
GRID_YZ, THREADS, SMEM = 65535, 1024, 227 * 1024


def within_limits(plan, shards: int = 1) -> bool:
    """``plan`` launched as the kernels launch it: x the column groups, y
    the row blocks of one board or shard, z the shards."""
    return (plan.grid[0] <= GRID_YZ and shards <= GRID_YZ and plan.grid[1] < 2**31
            and plan.threads <= THREADS and plan.smem_bytes <= SMEM)


def adaptive_plans(shape):
    """Every adaptive plan a dispatch on ``shape`` (rows, words) takes:
    full launches of any depth, and the loose tails of 6 to 24 turns."""
    plans = {cuda_adaptive.adaptive_plan(shape, turns) for turns in range(6, 25)}
    plans.add(cuda_adaptive.adaptive_plan(shape, 10**6))
    return sorted((p for p in plans if p is not None), key=lambda p: (p.t, p.stripe_h))


def test_one_device_plans_fit_the_card_at_65536():
    shape = (SIDE, SIDE // 32)
    plans = [cuda_packed.tiled_reg_plan(shape, t, SMS) for t in range(1, 65)]
    plans += [cuda_adaptive.tiled_skip_reg_plan(shape, t, SMS) for t in range(6, 25, 6)]
    for plan in adaptive_plans(shape):
        plans.append(cuda_adaptive.probing_reg_plan(plan, shape, SMS))
        if plan.frontier:
            plans.append(cuda_adaptive.frontier_blocks(shape, plan, 1, SMS))
    assert len(plans) > 70 and all(within_limits(p) for p in plans), plans


def test_row_mesh_plans_fit_the_card_at_65536():
    strip = (SIDE // 4, SIDE // 32)
    plans = [(cuda_halo.ext_reg_plan(strip, t, SMS), 1) for t in range(1, 33)]
    plans += [(cuda_halo.ext_skip_plan(strip, t, SMS), 1) for t in range(6, 31, 6)]
    for plan in adaptive_plans(strip):
        plans.append((cuda_halo.strip_reg_plan(plan, strip, SMS), 1))
        if plan.frontier:
            plans.append((cuda_adaptive.frontier_blocks(strip, plan, 1, SMS), 1))
            plans.append((cuda_adaptive.frontier_blocks(strip, plan, 4, SMS), 4))
    assert len(plans) > 40 and all(within_limits(p, n) for p, n in plans), plans


def test_2d_mesh_plans_fit_the_card_at_65536():
    tile = (SIDE // 2, SIDE // 64)
    plans = [(cuda_halo.ext_reg_plan(tile, t, SMS), 1) for t in range(1, 33)]
    plans += [(cuda_halo.ext_skip_plan(tile, t, SMS), 1) for t in range(6, 31, 6)]
    for turns in (*range(6, 25), 10**6):
        found = cuda_halo.adaptive_tile_plan(tile, turns)
        if found is None:
            continue
        plan, xpad = found
        plans.append((cuda_halo.tile_reg_plan(plan, tile, xpad, SMS), 1))
        if plan.frontier:
            plans.append((cuda_adaptive.frontier_blocks(tile, plan, 4, SMS), 4))
    assert len(plans) > 40 and all(within_limits(p, n) for p, n in plans), plans
