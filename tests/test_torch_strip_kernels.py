"""The adaptive strip kernels of the port (``parallel/cuda_halo.py``: K10,
K11, K12) against the JAX package's, launch by launch.

On the CPU the wrappers run their plain versions.  The JAX side runs its
Pallas kernels in interpret mode, made by the same functions that make
them for its ``make_superstep``: ``_build_ext_launch(..., skip_stable=True)`` (``_ext_kernel``'s skip
form), ``_build_ext_launch_adaptive`` (``_ext_kernel_adaptive``) and
``_build_ext_launch_frontier`` (``_ext_kernel_frontier``).  Both get the
same seeded strip, neighbour rows, bitmaps or interval arrays and the
same buffer of two launches ago; boards, bitmaps and all six interval
arrays (K12's row and column intervals) must be equal, tolerance 0.  The
block mirrors of
K10, K11 and K12 (``ext_skip_launch_mirror``,
``strip_probing_launch_mirror``, ``strip_frontier_launch_mirror``: the
register-resident blocks, runs and light cone of the kernels) are held to
the same JAX kernels and to the plain versions, at the plans of an H100
and at forced block heights.  Tests marked ``gpu`` hold the CUDA kernels
against their plain versions (and K11 against its mirror) on the card.

The JAX package is imported inside the tests that compare with it:
``python -m pytest tests/test_torch_strip_kernels.py -m gpu --noconftest``
runs the card's tests on a machine without JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive
from distributed_gol_torch.parallel import cuda_halo

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

GLIDER = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=bool)  # heads down-right
BLOCK = np.ones((2, 2), dtype=bool)
BOARDS = ["ash", "glider_north", "glider_south", "pulsar", "soup"]


def _pulsar() -> np.ndarray:
    p = np.zeros((13, 13), dtype=bool)
    for c in (2, 3, 4, 8, 9, 10):
        for r in (0, 5, 7, 12):
            p[r, c] = p[c, r] = True
    return p


def _put(b: np.ndarray, cells: np.ndarray, y: int, x: int) -> None:
    ys, xs = np.nonzero(cells)
    b[(ys + y) % b.shape[0], (xs + x) % b.shape[1]] = True


def column(kind: str, n: int, h: int, w: int, stripe: int) -> np.ndarray:
    """A (n + h + n, w) cell column: the north neighbour's last n rows, the
    strip's h rows, the south neighbour's first n rows.  "ash": blocks
    everywhere; "glider_north": ash and a glider in the north rows heading
    into the strip; "glider_south": one in the strip's last rows heading
    out of it; "pulsar": period-3 pulsars on the top seam and on a stripe
    seam; "soup": density 0.3."""
    rows = n + h + n
    if kind == "soup":
        return np.random.default_rng(h + w + n).random((rows, w)) < 0.3
    b = np.zeros((rows, w), dtype=bool)
    for y in range(3, rows - 3, 11):
        for x in range(5 + (y % 3) * 7, w - 3, 37):
            _put(b, BLOCK, y, x)
    if kind == "glider_north":
        b[n - 8 : n, :16] = False
        _put(b, GLIDER, n - 6, 3)
    elif kind == "glider_south":
        b[n + h - 8 : n + h, 40:56] = False
        _put(b, GLIDER, n + h - 5, 43)
    elif kind == "pulsar":
        for y0, x0 in ((n - 6, 20), (n + stripe - 6, 70)):
            b[y0 - 2 : y0 + 15, x0 - 2 : x0 + 15] = False
            _put(b, _pulsar(), y0, x0)
    return b


def pack_words(cells: np.ndarray) -> np.ndarray:
    """(rows, w) bool -> (rows, w / 32) uint32, the packed layout."""
    bits = cells.reshape(cells.shape[0], -1, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)


def split(words: np.ndarray, n: int):
    """(north, local, south) of a packed column."""
    return words[:n], words[n:-n], words[-n:]


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax.numpy as jnp

    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import pallas_packed
    from distributed_gol_tpu.parallel import pallas_halo

    return SimpleNamespace(jnp=jnp, life=life, pp=pallas_packed, ph=pallas_halo)


# -- K10: the skip form of K9 ----------------------------------------------------


@pytest.mark.parametrize("rule", ["conway", "highlife"])
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("strip,turns", [((32, 4), 6), ((48, 4), 18), ((64, 8), 24)])
def test_k10_plain_and_mirror_match_interpret_ext_kernel(ref, rule, kind, strip, turns):
    """The extended block at the JAX plan's pad = round8(T); the port's
    plain version and its window mirror (K10's per-tile probe) give the
    JAX skip-form kernel's centre."""
    h_loc, wp = strip
    pad = -(-turns // 8) * 8
    ext = pack_words(column(kind, pad, h_loc, wp * 32, 16))
    call = ref.ph._build_ext_launch(strip, ref.life.RULES[rule], turns, True, True, None)
    want = np.asarray(call(ref.jnp.asarray(ext)))
    got = cuda_halo.ext_skip_launch(t32(ext), tlife.RULES[rule], turns, pad, 0)
    assert np.array_equal(u32(got), want)
    mirror = cuda_halo.ext_skip_launch_mirror(t32(ext), tlife.RULES[rule], turns, pad, 0)
    assert np.array_equal(u32(mirror), want)
    if kind == "ash":
        assert np.array_equal(want, ext[pad:-pad])


def test_k10_mirror_copies_a_stable_tile_and_computes_an_active_one():
    """Blocks of 32 rows over ash, one with a glider: the mirror's
    decision is per block, and each block's centre is exact."""
    col = column("ash", 12, 64, 128, 16)
    _put(col, GLIDER, 60, 40)
    ext = t32(pack_words(col))
    plan = cuda_adaptive.RegPlan(12, 12, 32, 2, (2, 1), 1, 6)
    got = cuda_halo.ext_skip_launch_mirror(ext, tlife.CONWAY, 12, 12, 0, plan)
    assert torch.equal(got, cuda_halo.ext_launch_plain(ext, tlife.CONWAY, 12, 12, 0))
    assert cuda_halo.ext_skip_stable_tiles(ext, tlife.CONWAY, 12, 12, 0, plan).tolist() == [
        [True], [False]]


@pytest.mark.parametrize("strip,turns", [((100, 40), 18), ((65, 16), 30), ((37, 70), 12)])
def test_k10_every_block_of_a_ragged_strip_on_ash_proves_stable(strip, turns):
    """Strips whose rows and words no block height or column group divides
    (the last row tile and column group shifted to end at the strip's
    edge, so no window reads past the extended block): on ash every block
    of the plan proves stable and the launch keeps its centre."""
    h_loc, wp = strip
    ext = t32(pack_words(column("ash", turns, h_loc, wp * 32, 16)))
    plan = cuda_halo.ext_skip_plan(strip, turns, 132)
    ys, xs = cuda_halo.ext_skip_origins(plan, strip)
    assert ys[-1] + plan.tile_h == h_loc and (wp < plan.centre or xs[-1] + plan.centre == wp)
    assert plan.grid[0] * plan.tile_h > h_loc or plan.grid[1] * plan.centre > wp
    assert cuda_halo.ext_skip_stable_tiles(ext, tlife.CONWAY, turns, turns, 0).all()
    got = cuda_halo.ext_skip_launch_mirror(ext, tlife.CONWAY, turns, turns, 0)
    assert torch.equal(got, ext[turns:-turns])


def test_k10_a_glider_beside_the_last_block_edge_makes_only_that_block_compute():
    """Ash on a 100-row strip cut into 30-row tiles, a glider in the south
    neighbour's rows just past the strip's last row: only the last row
    tile (shifted to end at the strip's edge, its window reaching those
    rows) fails the proof, and every block's centre is exact."""
    h_loc, wp, turns = 100, 4, 12
    col = column("ash", turns, h_loc, wp * 32, 16)
    col[turns + h_loc - 1 : turns + h_loc + 9, 30:50] = False
    _put(col, GLIDER, turns + h_loc + 2, 36)  # in the rows just past the strip
    ext = t32(pack_words(col))
    plan = cuda_adaptive.RegPlan(turns, turns, 30, 2, (4, 1), 1, 6)
    assert cuda_halo.ext_skip_origins(plan, (h_loc, wp))[0] == [0, 30, 60, 70]
    stable = cuda_halo.ext_skip_stable_tiles(ext, tlife.CONWAY, turns, turns, 0, plan)
    assert stable.tolist() == [[True], [True], [True], [False]]
    got = cuda_halo.ext_skip_launch_mirror(ext, tlife.CONWAY, turns, turns, 0, plan)
    assert torch.equal(got, cuda_halo.ext_launch_plain(ext, tlife.CONWAY, turns, turns, 0))


@pytest.mark.parametrize("strip,turns", [((48, 4), 18), ((65, 16), 30), ((100, 40), 6)])
@pytest.mark.parametrize("tile_h,cols", [(7, 1), (16, 2), (None, None)])
def test_k10_mirror_with_forced_blocks_matches_plain(strip, turns, tile_h, cols):
    """Forced block heights (the last tile shifted) and the plan's own, on
    soups: the mirror equals the plain version."""
    h_loc, wp = strip
    ext = t32(pack_words(column("soup", turns, h_loc, wp * 32, 16)))
    plan = None
    if tile_h is not None:
        tile_h = min(tile_h, h_loc)
        plan = cuda_adaptive.RegPlan(turns, turns, tile_h, -(-(tile_h + 2 * turns) // 32),
                                     (-(-h_loc // tile_h), -(-wp // 30)), 1, 6)
    for rule in (tlife.CONWAY, tlife.HIGHLIFE):
        want = cuda_halo.ext_skip_launch_plain(ext, rule, turns, turns, 0)
        got = cuda_halo.ext_skip_launch_mirror(ext, rule, turns, turns, 0, plan)
        assert torch.equal(got, want)


def test_k10_refuses_a_depth_off_the_period():
    ext = torch.zeros((40, 4), dtype=torch.int32)
    for turns in (5, 7, 0):
        with pytest.raises(ValueError, match="multiple of 6"):
            cuda_halo.ext_skip_launch(ext, tlife.CONWAY, turns, 12, 0)


# -- K11: the probing strip launch -------------------------------------------------

# (strip in packed words, T): the JAX plan's 16-row tiles at cap 16; strips
# narrower than one window (4 and 1 words: a 32-word window wraps onto
# itself) and one of two column groups (31 words).
K11_CASES = [((64, 4), 6), ((64, 4), 12), ((64, 1), 6), ((32, 31), 12)]


def stripe_blocks(plan, strip, k: int):
    """K11's blocks forced to ``k`` whole stripes each (the strip's rows a
    multiple of k stripes)."""
    tile_h = k * plan.stripe_h
    return cuda_adaptive.RegPlan(plan.t, plan.pad, tile_h, -(-(tile_h + 2 * plan.pad) // 32),
                                 (strip[0] // tile_h, -(-strip[1] // 30)), 1, 6)


def k11_both(ref, rule, local, north, south, dst, prev_ext, plan, tile_cap):
    """One K11 launch in the JAX package and in the port, through the
    wrapper (its plain version on the CPU), K11's block mirror at the plan
    of an H100, and the mirror on blocks of two whole stripes: (JAX board,
    JAX bitmap, [(port board, port bitmap)] for each)."""
    call = ref.ph._build_ext_launch_adaptive(local.shape, ref.life.RULES[rule], plan.t, True,
                                             tile_cap)
    jnp = ref.jnp
    jb, jst = call(jnp.asarray(prev_ext, dtype=jnp.int32), jnp.asarray(local),
                   jnp.asarray(north), jnp.asarray(south), jnp.asarray(dst))
    two = stripe_blocks(plan, local.shape, 2)
    ports = []
    for launch in (cuda_halo.strip_probing_launch, cuda_halo.strip_probing_launch_mirror,
                   lambda *a: cuda_halo.strip_probing_launch_mirror(*a, two)):
        st = torch.ones(plan.grid(local.shape[0]), dtype=torch.int32)
        got = launch(t32(local), t32(north), t32(south), t32(dst),
                     torch.from_numpy(prev_ext.astype(np.int32)), st, tlife.RULES[rule], plan)
        ports.append((u32(got), st.numpy()))
    return np.asarray(jb), np.asarray(jst), ports


@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("strip,turns", K11_CASES)
def test_k11_plain_matches_interpret_kernel_over_two_launches(ref, rule, kind, strip, turns):
    """Two launches of the ping-pong protocol (both parities): the first
    from a zero bitmap into a zeroed buffer, the second from its bitmap
    (neighbour flags 1) into the input's buffer.  Boards and bitmaps of
    the plain version and of the block mirror (the kernel's blocks of 30
    words, columns wrapping modulo the strip's width, its light cone;
    within a stripe and across two, each stripe probed on its own region)
    are equal to the JAX kernel's after each."""
    h_loc, wp = strip
    tile_cap = 16
    tile_h = ref.ph._strip_plan_tile(strip, turns, tile_cap)
    plan = cuda_adaptive.AdaptivePlan(turns, tile_h, False)
    north, local, south = split(pack_words(column(kind, plan.pad, h_loc, wp * 32, tile_h)),
                                plan.pad)
    grid = plan.grid(h_loc)
    bufs = [np.zeros_like(local), local.copy()]
    prev = np.zeros(grid + 2, np.int32)
    cur = local
    for k in range(2):
        jb, jst, ports = k11_both(ref, rule, cur, north, south, bufs[k % 2], prev, plan, tile_cap)
        for name, (tb, tst) in zip(("plain", "mirror", "two-stripe mirror"), ports):
            assert np.array_equal(tb, jb) and np.array_equal(tst, jst), f"{name}, launch {k}"
        bufs[k % 2], cur = jb, jb
        prev = np.concatenate([[1], jst, [1]]).astype(np.int32)
    if kind == "ash" or (kind == "pulsar" and rule == "conway" and wp > 1):
        assert jst.all()  # proved stable: Conway's pulsar is period 3


@pytest.mark.parametrize("wp", [1, 2, 3])
@pytest.mark.parametrize("shape", ["block", "glider"])
def test_k11_narrow_strip_probes_the_torus_across_its_wrap(ref, wp, shape):
    """A strip narrower than one window whose only cells straddle its x
    wrap: a block there is still on the torus (the stripe is proved
    stable), a glider is not; the window that wraps onto itself sees what
    the JAX probe's lane rotate sees, the seam's error kept to the
    window's edge words."""
    strip, turns, tile_cap = (64, wp), 12, 16
    plan = cuda_adaptive.AdaptivePlan(turns, ref.ph._strip_plan_tile(strip, turns, tile_cap),
                                      False)
    cells = np.zeros((64 + 2 * plan.pad, wp * 32), dtype=bool)
    w = wp * 32
    y = plan.pad + 20  # in stripe 1
    _put(cells, BLOCK if shape == "block" else GLIDER, y, w - 1)
    north, local, south = split(pack_words(cells), plan.pad)
    jb, jst, ports = k11_both(ref, "conway", local, north, south, np.zeros_like(local),
                              np.zeros(plan.grid(64) + 2, np.int32), plan, tile_cap)
    if shape == "block":
        assert jst.all()
    else:  # the stripe that holds it, and those whose windows reach it
        assert jst[1] == 0 and jst[-1] == 1
    for tb, tst in ports:
        assert np.array_equal(tb, jb) and np.array_equal(tst, jst)


def k11_sequence(launch, local, north, south, plan, rule, n: int, flags, device="cpu"):
    """``n`` K11 launches through ``launch`` on one strip, each from the
    previous launch's bitmap with the neighbour strips' edge flags
    ``flags`` (north, south) at its ends, into the buffer of two launches
    ago: each launch's (strip, bitmap)."""
    h_loc = local.shape[0]
    grid = plan.grid(h_loc)
    bufs = [torch.zeros_like(local).to(device), local.clone().to(device)]
    cur, n_, s_ = local.to(device), north.to(device), south.to(device)
    st = torch.zeros(grid, dtype=torch.int32, device=device)
    seen = []
    for k in range(n):
        prev = torch.cat([st.new_tensor([flags[0]]), st, st.new_tensor([flags[1]])])
        st = torch.ones(grid, dtype=torch.int32, device=device)
        cur = launch(cur, n_, s_, bufs[k % 2], prev, st, rule, plan)
        bufs[k % 2] = cur
        seen.append((cur.cpu().clone(), st.cpu().clone()))
    return seen


@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("wp,plan,tile_h,extra", [
    (4, cuda_adaptive.AdaptivePlan(12, 16, False), 8, 0),
    (31, cuda_adaptive.AdaptivePlan(12, 16, False), 16, 1),
    (1, cuda_adaptive.AdaptivePlan(6, 8, False), 4, 0),
    (61, cuda_adaptive.AdaptivePlan(24, 32, False), 32, 0),
    (2, cuda_adaptive.AdaptivePlan(18, 24, False), 3, 2),
    (4, cuda_adaptive.AdaptivePlan(12, 16, False), 32, 0),
    (31, cuda_adaptive.AdaptivePlan(6, 8, False), 32, 0),
    (2, cuda_adaptive.AdaptivePlan(12, 16, False), 64, 1)])
def test_k11_mirror_with_forced_blocks_matches_plain(kind, wp, plan, tile_h, extra):
    """K11's decomposition with a stripe split into blocks of ``tile_h``
    rows (a stripe's flag the AND of its blocks' probes) or blocks of two
    to four whole stripes (each stripe probed on its own region), one to
    three column groups with a ragged last one, windows taller than they
    need, over three launches whose elision reads the neighbour strips'
    edge flags (north stable, south not, then both), so that blocks hold
    stripes that elide beside stripes that compute: each launch's strip
    and bitmap equal the plain version's, under a compiled-in rule and a
    generic one."""
    h_loc = 4 * plan.stripe_h
    blocks = cuda_adaptive.RegPlan(plan.t, plan.pad, tile_h,
                                   -(-(tile_h + 2 * plan.pad) // 32) + extra,
                                   (h_loc // tile_h, -(-wp // 30)), 1, 6)
    north, local, south = (t32(a) for a in split(
        pack_words(column(kind, plan.pad, h_loc, wp * 32, plan.stripe_h)), plan.pad))
    for rule in (tlife.CONWAY, tlife.DAY_AND_NIGHT):
        for flags in ((1, 0), (1, 1)):
            want = k11_sequence(cuda_halo.strip_probing_launch_plain, local, north, south, plan,
                                rule, 3, flags)
            got = k11_sequence(lambda *a: cuda_halo.strip_probing_launch_mirror(*a, blocks),
                               local, north, south, plan, rule, 3, flags)
            for (a, sa), (b, sb) in zip(got, want):
                assert torch.equal(a, b) and torch.equal(sa, sb)


def test_k11_mirror_refuses_blocks_that_do_not_cover_the_strip():
    """A row tile that neither divides a stripe nor holds whole stripes."""
    plan = cuda_adaptive.AdaptivePlan(6, 16, False)
    local, north, south = (torch.zeros(s, dtype=torch.int32) for s in ((48, 4), (8, 4), (8, 4)))
    st, prev = torch.ones(3, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    across = cuda_adaptive.RegPlan(6, 8, 24, 2, (2, 1), 1, 6)  # a stripe and a half a block
    with pytest.raises(ValueError, match="do not cover"):
        cuda_halo.strip_probing_launch_mirror(local, north, south, torch.zeros_like(local), prev,
                                              st, tlife.CONWAY, plan, across)


# (h, wp) strips with their stripe plans (stripe_h, pad, T): the JAX
# interpret plans above, path (g)'s (4, 1) strip at cap 16, path (e)'s
# loose tail on 256-row stripes, and narrow and ragged strips.
STRIP_PLANS = [((64, 4), 16, 8, 6), ((64, 1), 16, 16, 12), ((32, 31), 16, 16, 12),
               ((4096, 512), 16, 16, 12), ((4096, 512), 256, 24, 24), ((520, 17), 8, 8, 6),
               ((2048, 2), 64, 24, 18)]


@pytest.mark.parametrize("shape,stripe_h,pad,turns", STRIP_PLANS)
def test_strip_reg_plan_stores_every_centre_word_once(shape, stripe_h, pad, turns):
    """K11's plan on 132 SMs: ``stripe_reg_plan`` over the strip's width,
    blocks of a divisor of a stripe or of whole stripes (none holds part of
    one stripe and part of another; path (g)'s plan takes 8) that cover
    the strip's rows, and column groups of 30 words that cover its
    width with no group empty, so every word is probed and stored by
    exactly one block; the window holds the tile and pad rows a side; the
    probe sees every window row at generation 6 and the last generation's
    cone is the tile (or holds it, at T = 6)."""
    plan = cuda_halo.strip_reg_plan(cuda_adaptive.AdaptivePlan(turns, stripe_h, False), shape, 132)
    assert plan == cuda_adaptive.stripe_reg_plan(shape, stripe_h, pad, turns, 132,
                                                 cuda_adaptive.REG_PROBE_STRIPES)
    h, wp = shape
    nby, nbx = plan.grid
    assert (stripe_h % plan.tile_h == 0 or plan.tile_h % stripe_h == 0) and nby * plan.tile_h == h
    assert plan.tile_h // stripe_h <= 32
    assert (nbx - 1) * 30 < wp <= nbx * 30 and plan.centre == 30
    assert plan.rows == plan.tile_h + 2 * pad <= plan.warps * 32
    assert plan.cone(6) == (6, plan.rows - 6) and plan.probe == 6
    lo, hi = plan.cone(turns)
    if turns > 6:
        assert (lo, hi) == (pad, pad + plan.tile_h)
    else:
        assert lo <= pad < pad + plan.tile_h <= hi


@pytest.mark.parametrize("shape,stripe_h,pad,turns", STRIP_PLANS)
def test_strip_reg_plan_fits_hopper(shape, stripe_h, pad, turns):
    """Threads, registers and shared memory of K11's blocks within an H100
    SM's: at most 512 threads and 64 registers a thread, two blocks at
    once within 65,536 registers, the edge exchange and the probe's
    generation-0 copy within 227 KiB a block and the SM's 228 KiB."""
    plan = cuda_halo.strip_reg_plan(cuda_adaptive.AdaptivePlan(turns, stripe_h, False), shape, 132)
    assert 32 <= plan.threads <= 512
    assert plan.occupancy >= 2 and plan.occupancy * plan.threads * 64 <= 65536
    assert plan.smem_bytes == 8192 + plan.warps * 4096 <= 227 * 1024
    assert plan.occupancy * (plan.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("flags", ["all", "none", "north-edge", "south-edge", "middle"])
def test_k11_elision_reads_the_neighbour_flags(ref, flags):
    """An all-ash strip whose buffer of two launches ago differs from it:
    a stripe elides (keeps the buffer's rows) exactly where it and both
    neighbours, across the seams too, were stable."""
    strip, turns, tile_cap = (64, 4), 6, 16
    plan = cuda_adaptive.AdaptivePlan(turns, ref.ph._strip_plan_tile(strip, turns, tile_cap),
                                      False)
    north, local, south = split(pack_words(column("ash", plan.pad, 64, 128, 16)), plan.pad)
    dst = pack_words(column("soup", 0, 64, 128, 16)[:64])
    prev = np.ones(plan.grid(64) + 2, np.int32)
    prev[{"all": [], "none": slice(None), "north-edge": [0], "south-edge": [-1],
          "middle": [2]}[flags]] = 0
    jb, jst, ports = k11_both(ref, "conway", local, north, south, dst, prev, plan, tile_cap)
    assert jst.all()
    elided = prev[:-2] & prev[1:-1] & prev[2:]
    rows_kept = np.repeat(elided.astype(bool), plan.stripe_h)
    for tb, tst in ports:
        assert np.array_equal(tb, jb) and np.array_equal(tst, jst)
        assert np.array_equal(tb[rows_kept], dst[rows_kept])
        assert np.array_equal(tb[~rows_kept], local[~rows_kept])


# -- K12: the frontier strip launch --------------------------------------------------

EMPTY = cuda_adaptive._EMPTY_LO


def k12_both(ref, rule, local, north, south, dst, ps, jivals, plan, tile_cap,
             launch=cuda_halo.strip_frontier_launch):
    """One K12 launch in both packages from the JAX interval arrays
    ``jivals`` (six int32[grid + 2]: lo0, hi0, lo1, hi1, clo, chi), the
    port's through ``launch`` (the wrapper, whose CPU path is the plain
    version, or the mirror).  Returns the JAX outputs (board, st, six
    interval arrays) and the port's (board, state)."""
    jnp = ref.jnp
    call = ref.ph._build_ext_launch_frontier(local.shape, ref.life.RULES[rule], plan.t, True,
                                             tile_cap)
    out = call(jnp.asarray(ps, dtype=jnp.int32), *[jnp.asarray(a, dtype=jnp.int32) for a in jivals],
               jnp.asarray(local), jnp.asarray(north), jnp.asarray(south), jnp.asarray(dst))
    out = [np.asarray(o) for o in out]
    grid = plan.grid(local.shape[0])
    state = cuda_halo.FrontierState.start(local.shape, plan, "cpu")
    state.prev[6] = torch.from_numpy(1 - ps.astype(np.int32))
    prev_ext = torch.from_numpy(np.stack(jivals).astype(np.int32))
    got = launch(t32(local), t32(north), t32(south), t32(dst), prev_ext, state,
                 tlife.RULES[rule], plan)
    assert state.act.shape == (grid,)
    return out, u32(got), state


def full_intervals(grid: int, stripe: int, wp: int, h_loc: int) -> list:
    """The starting intervals of the JAX package's make_superstep,
    extended with the neighbour strips' (full too, shifted by -/+ h_loc)."""
    lo = np.arange(-1, grid + 1) * stripe
    return [lo, lo + stripe - 1, np.full(grid + 2, EMPTY), np.full(grid + 2, -1),
            np.zeros(grid + 2), np.full(grid + 2, wp - 1)]


def assert_k12_equal(out, tb, state):
    jb, jst = out[0], out[1]
    assert np.array_equal(tb, jb)
    assert np.array_equal(1 - state.cur[6].numpy(), jst)
    assert np.array_equal(state.cur[:6].numpy(), np.stack(out[2:8]))


def k12_two_launches(ref, rule, kind, strip, turns, launch=cuda_halo.strip_frontier_launch):
    """Launch 1 from full intervals into a zeroed buffer, launch 2 from the
    intervals launch 1 measured (each package its own; the JAX package's
    with its column interval), the neighbours' edge stripes empty on the
    north and live on the south, the port's through ``launch``.  Boards,
    skip flags and row intervals are equal after each launch, and activity
    follows the row intervals."""
    h_loc, wp = strip
    tile_cap = 256
    tile_h = ref.ph._strip_plan_tile(strip, turns, tile_cap)
    pad_f = ref.ph._frontier_plan(strip, turns, tile_cap)[0]
    plan = cuda_adaptive.AdaptivePlan(turns, tile_h, True)
    assert plan.pad_f == pad_f
    north, local, south = split(pack_words(column(kind, pad_f, h_loc, wp * 32, tile_h)), pad_f)
    grid = plan.grid(h_loc)
    ivals = full_intervals(grid, tile_h, wp, h_loc)
    out, tb, state = k12_both(ref, rule, local, north, south, np.zeros_like(local),
                              np.zeros(grid, np.int32), ivals, plan, tile_cap, launch)
    assert_k12_equal(out, tb, state)
    # Launch 2: the north neighbour's edge stripe quiet, the south's live
    # on its first rows (+h_loc in this strip's frame).
    edge_n = [EMPTY, -1, EMPTY, -1, EMPTY, -1]
    edge_s = [h_loc + 2, h_loc + 9, EMPTY, -1, 0, wp - 1]
    jivals = [np.concatenate([[edge_n[k]], out[2 + k], [edge_s[k]]]) for k in range(6)]
    out2, tb2, state2 = k12_both(ref, rule, out[0], north, south, local, out[1], jivals, plan,
                                 tile_cap, launch)
    assert_k12_equal(out2, tb2, state2)
    act = (state2.cur[0] <= state2.cur[1]).numpy()
    assert np.array_equal(state2.act.numpy(), act.astype(np.int32))
    assert np.array_equal(act, (out2[2] <= out2[3]) | (out2[4] <= out2[5]))
    if kind == "ash":  # only the south neighbour's activity reaches a stripe
        assert out2[1].tolist() == [1] * (grid - 1) + [0] and not act.any()


@pytest.mark.parametrize("rule", ["conway", "highlife"])
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("strip,turns", [((512, 4), 18), ((512, 4), 12)])
def test_k12_plain_matches_interpret_kernel_over_two_launches(ref, rule, kind, strip, turns):
    """``k12_two_launches`` on the wrapper (its plain version on the CPU)."""
    k12_two_launches(ref, rule, kind, strip, turns)


@pytest.mark.parametrize("rule", ["conway", "highlife"])
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("strip,turns", [((512, 4), 18), ((512, 4), 12)])
def test_k12_mirror_matches_interpret_kernel_over_two_launches(ref, rule, kind, strip, turns):
    """``k12_two_launches`` on K12's mirror (``strip_frontier_launch_mirror``:
    the kernel's register-resident blocks of 30 words, its row tiles and
    light cone, at the plan of an H100)."""
    k12_two_launches(ref, rule, kind, strip, turns, cuda_halo.strip_frontier_launch_mirror)


def k12_sequence(launch, local, north, south, plan, rule, n: int, device="cpu"):
    """``n`` K12 launches through ``launch`` on one strip whose neighbours
    are ``north`` and ``south`` (each launch's exchange from its own state,
    both neighbours' edge stripes the strip's own), from full intervals:
    each launch's (strip, state), then the skip count and activity."""
    h_loc = local.shape[0]
    state = cuda_halo.FrontierState.start(tuple(local.shape), plan, device)
    bufs = [torch.zeros_like(local).to(device), torch.zeros_like(local).to(device)]
    cur, n_, s_ = local.to(device), north.to(device), south.to(device)
    seen = []
    for k in range(n):
        ext = cuda_halo.edge_intervals([state.prev], h_loc)[0]
        cur = launch(cur, n_, s_, bufs[k % 2], ext, state, rule, plan)
        seen.append((cur.cpu().clone(), state.cur.cpu().clone(), state.route.cpu().clone()))
        state.advance()
    return seen, state.skipped.cpu(), state.act.cpu()


K12_PLANS = {"T24-s64": cuda_adaptive.AdaptivePlan(24, 64, True),
             "T18-s32": cuda_adaptive.AdaptivePlan(18, 32, True),
             "T6-s16": cuda_adaptive.AdaptivePlan(6, 16, True)}


@pytest.mark.parametrize("plan", list(K12_PLANS.values()), ids=list(K12_PLANS))
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
def test_k12_mirror_matches_plain_over_four_launches(rule, kind, plan):
    """K12's mirror against the plain version over four launches on a
    256 x 2-word strip (a ragged column group: 64 words in groups of 30,
    and a narrow one: 2 words), tolerance 0: each launch's strip and whole
    state, then the skip count and activity; under both compiled-in rules
    and one that takes the generic instantiation."""
    r = tlife.RULES[rule]
    for wp in (64, 2):
        north, local, south = (t32(a) for a in split(
            pack_words(column(kind, 32, 256, wp * 32, plan.stripe_h)), 32))
        plain = k12_sequence(cuda_halo.strip_frontier_launch_plain, local, north, south, plan, r, 4)
        mirror = k12_sequence(cuda_halo.strip_frontier_launch_mirror, local, north, south, plan,
                              r, 4)
        for (a, sa, ra), (b, sb, rb) in zip(plain[0], mirror[0]):
            assert torch.equal(a, b) and torch.equal(sa, sb) and torch.equal(ra, rb)
        assert torch.equal(plain[1], mirror[1]) and torch.equal(plain[2], mirror[2])


@pytest.mark.parametrize("case", ["empty-beside-live", "live-north-only", "all-empty"])
def test_k12_empty_intervals_stay_empty(ref, case):
    """An empty interval next to a live one, across each seam: the skip
    decision and the clamped union see only the live one."""
    strip, turns, tile_cap = (512, 4), 18, 256
    plan = cuda_adaptive.AdaptivePlan(turns, 256, True)
    north, local, south = split(pack_words(column("glider_north", 24, 512, 128, 256)), 24)
    e = [EMPTY, -1]
    rows = {
        "empty-beside-live": [[-20, -5] + e, e + e, [100, 120] + e, e + e],
        "live-north-only": [[-3, -1] + e, e + e, e + e, e + e],
        "all-empty": [e + e] * 4,
    }[case]
    jivals = [np.array([r[k] for r in rows]) for k in range(4)]
    live = np.array([r[0] <= r[1] for r in rows])
    jivals += [np.where(live, 0, EMPTY), np.where(live, 3, -1)]
    dst = pack_words(column("soup", 0, 512, 128, 256)[:512])
    out, tb, state = k12_both(ref, "conway", local, north, south, dst,
                              np.array([1, 0], np.int32), jivals, plan, tile_cap)
    assert_k12_equal(out, tb, state)


@pytest.mark.parametrize("kind", ["glider_north", "soup"])
def test_k12_without_the_column_interval_on_the_column_tier(ref, kind):
    """512 words wide: the JAX kernel's column tier (a 256-word window)
    engages from its column intervals, and so does the port's, which now
    carries them: over two launches (the second from the intervals each
    package measured in the first, the exchange's edge entries empty) the
    board, the skip flags and all six interval arrays, the column
    interval (clo, chi) included, equal ``_ext_kernel_frontier``'s, and
    the second launch takes the column tier somewhere."""
    strip, turns, tile_cap = (512, 512), 18, 256
    tile_h = ref.ph._strip_plan_tile(strip, turns, tile_cap)
    assert ref.ph._frontier_plan(strip, turns, tile_cap)[2] == 256
    plan = cuda_adaptive.AdaptivePlan(turns, tile_h, True)
    assert cuda_adaptive.frontier_geometry(plan, strip) == (168, 256)
    col = column("ash", 24, 512, 512 * 32, tile_h)
    if kind == "soup":
        _put(col, np.random.default_rng(3).random((40, 40)) < 0.35, 300, 9000)
    else:
        _put(col, GLIDER, 24 + 100, 5000)
    north, local, south = split(pack_words(col), 24)
    grid = plan.grid(512)
    out, tb, state = k12_both(ref, "conway", local, north, south, np.zeros_like(local),
                              np.zeros(grid, np.int32), full_intervals(grid, tile_h, 512, 512),
                              plan, tile_cap)
    assert_k12_equal(out, tb, state)
    e = [EMPTY, -1, EMPTY, -1, EMPTY, -1]
    jivals = [np.concatenate([[e[k]], out[2 + k], [e[k]]]) for k in range(6)]
    assert any(lo <= hi < 511 for lo, hi in zip(out[6], out[7]))  # a narrow column interval
    out2, tb2, state2 = k12_both(ref, "conway", out[0], north, south, local, out[1], jivals, plan,
                                 tile_cap)
    assert_k12_equal(out2, tb2, state2)
    assert cuda_adaptive.ROUTE_TIER in state2.route.tolist()


# -- the exchange --------------------------------------------------------------------


def test_interval_exchange_shifts_into_the_strip_frame_and_keeps_empty_empty():
    """(2, 1): both neighbours are the other strip, each side its own
    edge stripe; rows shift by -/+ h_loc, column intervals (board words)
    cross unshifted, and an empty interval (lo > hi) stays empty."""
    s0 = torch.tensor([[0, 10], [5, 12], [EMPTY, EMPTY], [-1, -1], [3, 40], [9, 41], [1, 1]],
                      dtype=torch.int32)
    s1 = torch.tensor([[EMPTY, 3], [-1, 7], [EMPTY, EMPTY], [-1, -1], [EMPTY, 0], [-1, 63],
                       [0, 1]], dtype=torch.int32)
    ext = cuda_halo.edge_intervals([s0, s1], 16)
    assert ext[0][:, 0].tolist() == [3 - 16, 7 - 16, EMPTY - 16, -17, 0, 63]
    assert ext[0][:, -1].tolist() == [EMPTY + 16, -1 + 16, EMPTY + 16, 15, EMPTY, -1]
    assert ext[1][:, 0].tolist() == [10 - 16, 12 - 16, EMPTY - 16, -17, 40, 41]
    assert ext[1][:, -1].tolist() == [16, 21, EMPTY + 16, 15, 3, 9]
    for src, e in ((s0, ext[0]), (s1, ext[1])):
        assert torch.equal(e[:, 1:-1], src[:6])
    for e in ext:
        empty = e[0:4:2] > e[1:4:2]
        assert empty[1].all()  # every interval 1 above is empty
    assert bool(ext[0][0, -1] > ext[0][1, -1])  # s1's empty first stripe, shifted
    assert bool(ext[0][4, -1] > ext[0][5, -1])  # and its empty column interval


def test_flag_and_row_exchange_on_two_strips():
    from distributed_gol_torch.parallel import halo

    a = torch.arange(8 * 2, dtype=torch.int32).view(8, 2)
    b = 100 + a
    (na, sa), (nb, sb) = halo.edge_rows([a, b], 3)
    assert torch.equal(na, b[-3:]) and torch.equal(sa, b[:3])
    assert torch.equal(nb, a[-3:]) and torch.equal(sb, a[:3])
    fa, fb = torch.tensor([1, 0, 1], dtype=torch.int32), torch.tensor([0, 1, 1], dtype=torch.int32)
    ea, eb = cuda_halo.edge_flags([fa, fb])
    assert ea.tolist() == [1, 1, 0, 1, 0] and eb.tolist() == [1, 0, 1, 1, 1]


# -- the kernels on the card -----------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("strip,turns", [((256, 64), 24), ((100, 17), 6), ((33, 3), 12)])
def test_gpu_k10_matches_plain(cuda_device, kind, strip, turns):
    h_loc, wp = strip
    ext = t32(pack_words(column(kind, turns, h_loc, wp * 32, 16)))
    want = cuda_halo.ext_skip_launch_plain(ext, tlife.CONWAY, turns, turns, 0)
    got = cuda_halo.ext_skip_launch(ext.to(cuda_device), tlife.CONWAY, turns, turns, 0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("stripe,turns", [(16, 12), (8, 6), (64, 24)])
@pytest.mark.parametrize("wp", [64, 4, 1])
def test_gpu_k11_matches_plain(cuda_device, rule, kind, stripe, turns, wp):
    """K11 on the card against its plain version and its block mirror on
    the CPU (at the card's blocks), from a random extended bitmap into a
    soup buffer: board and bitmap; strips of two column groups and
    narrower than one window; each launch counted in its rule's
    instantiation."""
    plan = cuda_adaptive.AdaptivePlan(turns, stripe, False)
    r = tlife.RULES[rule]
    north, local, south = split(pack_words(column(kind, plan.pad, 128, wp * 32, stripe)), plan.pad)
    dst = pack_words(column("soup", 0, 128, wp * 32, stripe)[:128])
    prev = torch.from_numpy(np.random.default_rng(1).integers(0, 2, plan.grid(128) + 2)
                            .astype(np.int32))
    blocks = cuda_halo.strip_reg_plan(plan, (128, wp), cuda_adaptive.device_sms(cuda_device))
    outs = []
    cuda_halo.strip_probing_launch.rules.clear()
    for launch, dev in ((cuda_halo.strip_probing_launch, "cpu"),
                        (lambda *a: cuda_halo.strip_probing_launch_mirror(*a, blocks), "cpu"),
                        (cuda_halo.strip_probing_launch, cuda_device)):
        st = torch.ones(plan.grid(128), dtype=torch.int32, device=dev)
        got = launch(t32(local).to(dev), t32(north).to(dev), t32(south).to(dev), t32(dst).to(dev),
                     prev.to(dev), st, r, plan)
        outs.append((got.cpu(), st.cpu()))
    for got, st in outs[1:]:
        assert torch.equal(got, outs[0][0]) and torch.equal(st, outs[0][1])
    want = {"conway": "conway", "highlife": "highlife"}.get(rule, "generic")
    assert cuda_halo.strip_probing_launch.rules == {want: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("wp", [512, 3])
def test_gpu_k11_settled_launch_elides_every_stripe(cuda_device, wp):
    """A launch whose every stripe and both neighbours' edge flags were
    stable writes nothing (its buffer keeps a board it never saw) and
    reports every stripe stable."""
    plan = cuda_adaptive.AdaptivePlan(12, 16, False)
    north, local, south = (t32(a).to(cuda_device) for a in split(
        pack_words(column("soup", plan.pad, 256, wp * 32, 16)), plan.pad))
    dst = torch.full_like(local, 7)
    prev = torch.ones(plan.grid(256) + 2, dtype=torch.int32, device=cuda_device)
    st = torch.ones(plan.grid(256), dtype=torch.int32, device=cuda_device)
    cuda_halo.strip_probing_launch(local, north, south, dst, prev, st, tlife.CONWAY, plan)
    torch.cuda.synchronize()
    assert bool((dst == 7).all()) and bool(st.all())


@pytest.mark.gpu
@pytest.mark.parametrize("plan", list(K12_PLANS.values()), ids=list(K12_PLANS))
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
def test_gpu_k12_matches_plain_launch_by_launch(cuda_device, rule, kind, plan):
    """K12 on the card against its plain version on the CPU over four
    launches (``k12_sequence``), on a ragged 64-word strip and a 2-word
    one: each launch's strip and whole state, the skip count and activity;
    every rule instantiation."""
    r = tlife.RULES[rule]
    for wp in (64, 2):
        north, local, south = (t32(a) for a in split(
            pack_words(column(kind, 32, 256, wp * 32, plan.stripe_h)), 32))
        want = k12_sequence(cuda_halo.strip_frontier_launch, local, north, south, plan, r, 4)
        got = k12_sequence(cuda_halo.strip_frontier_launch, local, north, south, plan, r, 4,
                           cuda_device)
        for (a, sa, ra), (b, sb, rb) in zip(got[0], want[0]):
            assert torch.equal(a, b) and torch.equal(sa, sb) and torch.equal(ra, rb)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", BOARDS)
def test_gpu_k12_matches_plain_over_three_launches(cuda_device, kind):
    plan = cuda_adaptive.AdaptivePlan(24, 64, True)
    h_loc = 256
    north, local, south = split(pack_words(column(kind, 32, h_loc, 2048, 64)), 32)
    results = []
    for dev in ("cpu", cuda_device):
        state = cuda_halo.FrontierState.start(tuple(local.shape), plan, dev)
        bufs = [torch.zeros_like(t32(local)).to(dev), torch.zeros_like(t32(local)).to(dev)]
        cur = t32(local).to(dev)
        n, s = t32(north).to(dev), t32(south).to(dev)
        for k in range(3):
            ext = cuda_halo.edge_intervals([state.prev], h_loc)[0]
            cur = cuda_halo.strip_frontier_launch(cur, n, s, bufs[k % 2], ext, state,
                                                  tlife.CONWAY, plan)
            state.advance()
        results.append((cur.cpu(), state.prev.cpu(), state.skipped.cpu(), state.act.cpu()))
    for a, b in zip(*results):
        assert torch.equal(a, b)
