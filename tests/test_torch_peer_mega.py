"""The in-kernel tier's peer form (``parallel/cuda_halo.py``): K14 and K15
over shards that lie on several CUDA devices of one process, one launch a
card over its own shards (the kernels' table of shard ids), the cards'
launches ordered by events (``peer_groups``, ``peer_waits``,
``peer_pairs``, ``tier_policy``; the chunk ``_mega_chunk`` behind
``strip_mega_launches`` and ``tile_mega_launches``).

On the CPU the wrappers run their plain versions, a launch group at a
time, over the group's shards (``ids``).  Tolerance 0 throughout:

- the plain versions run group by group equal the one-launch plain K14
  and K15 at every launch (board, both state parities, routes, skip
  counts, activity) under every legal order of the groups: in order,
  reversed, and running ahead (a group takes launch l + 1 as soon as the
  groups it reads have finished launch l);
- the chunk on groups equals the JAX kernels in interpret mode (the
  loopback chunk on identical strips, the JAX ``make_superstep`` on a row
  mesh, the JAX virtual 2-D build);
- ``peer_waits`` covers exactly the cards whose shards a card's shards
  read (the kernels' own index arithmetic, corners included), for every
  assignment of shards to cards;
- ``tier_policy`` gives ``ici_tier_policy``'s answer for a mesh of chips
  on a mesh of cards that reach each other, and names both cards where
  they do not.

Tests marked ``gpu`` hold the peer form to the one-launch K14 and K15 on
the card (one stream a group standing in for cards) and across the cards
present.  The JAX package is imported inside the tests that compare with
it: ``python -m pytest tests/test_torch_peer_mega.py -m gpu
--noconftest`` runs the card's tests on a machine without JAX."""

import functools
import itertools
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive
from distributed_gol_torch.ops import packed as tpacked
from distributed_gol_torch.parallel import cuda_halo, halo
from distributed_gol_torch.parallel import mesh as tmesh
from test_torch_strip_mega import PLANS, edge_strip, seam_soup, strips_of  # tests/ is on the path
from test_torch_tile_kernels import mesh_board
from test_torch_tile_mega import TILE_PLANS, mesh2d_board, packed_of, tiles_of

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

CPU = torch.device("cpu")

# Mesh shape -> its launch groups (shard ids, row-major), by name.
SPLITS = {
    "4x1-4": ((4, 1), [(0,), (1,), (2,), (3,)]),
    "8x1-4x2": ((8, 1), [(0, 1), (2, 3), (4, 5), (6, 7)]),
    "2x2-4": ((2, 2), [(0,), (1,), (2,), (3,)]),
    "2x2-rows": ((2, 2), [(0, 1), (2, 3)]),
    "1x2": ((1, 2), [(0,), (1,)]),
    "2x4-4x2": ((2, 4), [(0, 1), (2, 3), (4, 5), (6, 7)]),
}
ORDERS = ("in-order", "reversed", "run-ahead")
NLAUNCH = 6


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax
    import jax.numpy as jnp

    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import packed
    from distributed_gol_tpu.parallel import pallas_halo
    from distributed_gol_tpu.parallel.mesh import make_mesh
    from distributed_gol_tpu.parallel.packed_halo import packed_sharding

    return SimpleNamespace(jax=jax, jnp=jnp, life=life, packed=packed, ph=pallas_halo,
                           make_mesh=make_mesh, packed_sharding=packed_sharding)


@pytest.fixture()
def one_group_a_shard(monkeypatch):
    """Every shard its own launch group, as on a mesh of one card a shard:
    ``peer_groups`` keyed by shard (the CPU has one device)."""
    monkeypatch.setattr(cuda_halo, "peer_groups",
                        lambda devices: {s: (s,) for s in range(len(devices))})


# -- a mesh's chunk, launch by launch, one launch or group by group ------------------------


def mesh_case(mesh_shape, rule=tlife.CONWAY):
    """(shards in the launch's layout, plan, kind) of a small mesh: 64-row
    strips of a settled soup with a glider across every seam on a row
    mesh, 128 x 4-word tiles with gliders across a row seam, a column seam
    and a corner (the torus corner too) on a 2-D mesh."""
    ny, nx = mesh_shape
    if nx == 1:
        return strips_of(seam_soup(ny, 64), ny), PLANS["four-stripes"], "strip"
    cells = mesh_board("glider_corner", (128, 4), mesh_shape)
    cells |= mesh_board("glider_y", (128, 4), mesh_shape)
    return (tiles_of(packed_of(cells.astype(np.uint8) * 255), mesh_shape),
            TILE_PLANS["T6-s16"], "tile")


def plain_launch(kind):
    return {"strip": cuda_halo.strip_mega_launch_plain,
            "tile": cuda_halo.tile_mega_launch_plain}[kind]


def flat(shards):
    return [t for r in shards for t in r] if isinstance(shards[0], list) else list(shards)


def nest(fl, mesh_shape, kind):
    ny, nx = mesh_shape
    return fl if kind == "strip" else [fl[r * nx : (r + 1) * nx] for r in range(ny)]


def one_launch_records(shards, plan, kind, rule=tlife.CONWAY, n=NLAUNCH):
    """The one-launch plain chunk's shards and whole state after each
    launch, copied."""
    seen = []
    chunk = {"strip": cuda_halo.strip_mega_launches, "tile": cuda_halo.tile_mega_launches}[kind]
    chunk(shards, rule, plan, n, each=lambda out, s: seen.append(snapshot(out, s)))
    return seen


def snapshot(out, s):
    return ([t.clone() for t in flat(out)], s.state.clone(), s.route.clone(), s.skipped.clone(),
            s.act.clone())


def schedule(groups, waits, order: str, n: int):
    """A legal order of the (launch, group) steps of an n-launch chunk: a
    group takes launch l once each group it reads (``waits``) has finished
    launch l - 1.  "in-order" and "reversed" run every group's launch l,
    in or against group order, before any launch l + 1; "run-ahead" holds
    the last group back, taking its step only when no other group has a
    legal one (the lowest group first), so the groups that do not read it
    run a launch ahead of it."""
    g = len(groups)
    if order != "run-ahead":
        turn = range(g) if order == "in-order" else range(g - 1, -1, -1)
        return [(l, k) for l in range(n) for k in turn]
    done, steps = [0] * g, []
    while len(steps) < n * g:
        legal = [k for k in range(g)
                 if done[k] < n and all(done[w] >= done[k] for w in waits[k])]
        k = min(legal, key=lambda k: (k == g - 1, k))
        steps.append((done[k], k))
        done[k] += 1
    return steps


def run_groups(shards, plan, kind, mesh_shape, groups, order, rule=tlife.CONWAY, n=NLAUNCH):
    """The peer form's plain mirror run step by step in ``order``: one
    interval state array and each group's own state (``peer_states``),
    each step the plain version over the group's shards (``ids``).
    Returns {(launch, group): (its shards' buffers, its state columns at
    the launch's parity, its routes, its skip counts, its activity)},
    copied after the step."""
    fl = flat(shards)
    h = fl[0].shape[0]
    grid = plan.grid(h)
    sts = cuda_halo.peer_states(len(fl), h, plan, [CPU] * len(groups))
    bufs = [[torch.empty_like(t) for t in fl] for _ in range(2)]
    waits = cuda_halo.peer_waits(dict(enumerate(groups)), mesh_shape)
    fn = plain_launch(kind)
    seen = {}
    for l, k in schedule(groups, waits, order, n):
        rd = fl if l == 0 else bufs[(l - 1) % 2]
        fn(nest(rd, mesh_shape, kind), nest(bufs[l % 2], mesh_shape, kind), sts[k], rule, plan,
           l % 2, l == 0, ids=groups[k])
        cols = cuda_halo._shard_cols(groups[k], grid, CPU)
        seen[l, k] = ([bufs[l % 2][s].clone() for s in groups[k]],
                      sts[k].state[l % 2][:, cols].clone(), sts[k].route[cols].clone(),
                      sts[k].skipped[list(groups[k])].clone(), sts[k].act[cols].clone())
    return seen


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("split", list(SPLITS))
def test_groups_in_any_legal_order_equal_the_one_launch(split, order):
    """Each group's launch l, in any legal order, writes what the one
    launch over every shard writes for its shards: their buffers, their
    state columns, routes, skip counts and activity, at every launch."""
    mesh_shape, groups = SPLITS[split]
    shards, plan, kind = mesh_case(mesh_shape)
    want = one_launch_records(shards, plan, kind)
    got = run_groups(shards, plan, kind, mesh_shape, groups, order)
    grid = plan.grid(flat(shards)[0].shape[0])
    assert len(got) == NLAUNCH * len(groups)
    for (l, k), (bufs, state, route, skipped, act) in got.items():
        w_bufs, w_state, w_route, w_skipped, w_act = want[l]
        ids = list(groups[k])
        cols = cuda_halo._shard_cols(ids, grid, CPU)
        for s, t in zip(ids, bufs):
            assert torch.equal(t, w_bufs[s]), (l, k, s)
        assert torch.equal(state, w_state[l % 2][:, cols]), (l, k)
        assert torch.equal(route, w_route[cols]), (l, k)
        assert torch.equal(skipped, w_skipped[ids]), (l, k)
        assert torch.equal(act, w_act[cols]), (l, k)


@pytest.mark.parametrize("split", ["4x1-4", "8x1-4x2"])
def test_run_ahead_runs_ahead(split):
    """In the run-ahead order of a row mesh in four groups a group takes
    launch l + 1 before a group it does not read takes launch l: the
    orders differ in what they test."""
    mesh_shape, groups = SPLITS[split]
    waits = cuda_halo.peer_waits(dict(enumerate(groups)), mesh_shape)
    steps = schedule(groups, waits, "run-ahead", NLAUNCH)
    at = {step: i for i, step in enumerate(steps)}
    assert any(at[l + 1, a] < at[l, b] for l in range(NLAUNCH - 1) for a in range(4)
               for b in range(4) if b != a and b not in waits[a])
    assert sorted(steps) == sorted(itertools.product(range(NLAUNCH), range(4)))


@pytest.mark.parametrize("split", list(SPLITS))
def test_chunk_on_groups_equals_the_one_launch_chunk(split):
    """``strip_mega_launches`` / ``tile_mega_launches`` with ``groups``:
    after every launch the board, both state parities, routes, skip
    counts per shard and activity (the groups' states merged,
    ``merge_states``) equal the one-launch chunk's."""
    mesh_shape, groups = SPLITS[split]
    shards, plan, kind = mesh_case(mesh_shape, tlife.HIGHLIFE)
    want = one_launch_records(shards, plan, kind, tlife.HIGHLIFE)
    chunk = {"strip": cuda_halo.strip_mega_launches, "tile": cuda_halo.tile_mega_launches}[kind]
    got = []
    out, merged = chunk(shards, tlife.HIGHLIFE, plan, NLAUNCH, groups=groups,
                        each=lambda o, s: got.append(snapshot(o, s)))
    assert len(got) == NLAUNCH
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
        for x, y in zip(a[1:], b[1:]):
            assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(flat(out), want[-1][0]))
    assert torch.equal(merged.state, want[-1][1])
    assert int(merged.rowflag.abs().sum()) == 0


def test_groups_must_partition_the_shards():
    shards, plan, _ = mesh_case((4, 1))
    for groups in ([(0, 1), (2,)], [(0, 1), (1, 2, 3)], [(0, 0), (1, 2, 3)], [(0, 1, 2, 3, 4)]):
        with pytest.raises(ValueError):
            cuda_halo.strip_mega_launches(shards, tlife.CONWAY, plan, 2, groups=groups)


def test_merge_takes_each_entry_from_its_owner():
    """Two groups' states merge into the one launch's bookkeeping: each
    stripe's route, skips and activity from its group (the other left 0),
    the column extremes the owner's (the other left them empty)."""
    plan = PLANS["four-stripes"]
    a, b = cuda_halo.peer_states(2, 64, plan, [CPU, CPU])
    assert a.state is b.state
    a.route[:4], b.route[4:] = 3, 2
    a.skipped[0], b.skipped[1] = 5, 7
    b.colspan[5] = torch.tensor([10, 20])
    m = cuda_halo.merge_states([a, b])
    assert m.route.tolist() == [3] * 4 + [2] * 4 and m.skipped.tolist() == [5, 7]
    assert m.colspan[5].tolist() == [10, 20]
    assert m.colspan[0].tolist() == [cuda_adaptive._EMPTY_LO, -cuda_adaptive._EMPTY_LO]
    # A dispatch's merge: the skip counts and activity summed, the rest
    # the first group's.
    a.act[1], b.act[6] = 1, 1
    d = cuda_halo.merge_states([a, b], stats_only=True)
    assert d.skipped.tolist() == [5, 7] and d.act.tolist() == [0, 1, 0, 0, 0, 0, 1, 0]
    assert d.state is a.state and d.route is a.route and d.colspan is a.colspan


def test_skip_listener_hears_each_dispatch(tmp_path):
    """``Backend.skip_listener`` gets each adaptive dispatch's (skipped,
    stripe-launches, activity), the entries the skip telemetry keeps; the
    cycle probes are not dispatches."""
    from test_torch_adaptive_driver import backend, make_board

    b = backend(tmp_path, skip_stable=True, image_height=80, image_width=256,
                skip_tile_cap=16)
    heard = []
    b.skip_listener = lambda *entry: heard.append(entry)
    board = b.put(make_board("glider", 80, 256, 16))
    for _ in range(3):
        board, _ = b.run_turns(board, 60)
    b.cycle_probe_async(board)
    b.cycle_counts(board)
    assert len(heard) == 3
    assert all(x is y for got, kept in zip(heard, b._skip_stats) for x, y in zip(got, kept))


# -- against the JAX kernels in interpret mode ----------------------------------------------


@pytest.fixture(scope="module")
def loopback_chunk(ref):
    """The JAX loopback chunk (8 launches of T = 18) on one 1024-row strip
    of ``edge_strip`` at cap 256: (board, skipped, activity, plan)."""
    from test_torch_strip_mega import jax_plan

    strip = (1024, 4)
    plan = jax_plan(ref.ph, strip, 10**6, 256)
    call = ref.ph._build_dispatch_frontier_strip(strip, ref.life.CONWAY, plan.t, 8, True, 256,
                                                 False)
    p = ref.jnp.asarray(np.asarray(ref.packed.pack(ref.jnp.asarray(edge_strip(1024)))))
    a, _, sk, act = call(ref.jnp.zeros(3, ref.jnp.int32), p, ref.jnp.zeros_like(p))
    return np.asarray(ref.packed.unpack(a)), int(sk[0]), np.asarray(act), plan


@pytest.mark.parametrize("groups", [[(0,), (1,), (2,), (3,)], [(0, 2), (1, 3)], [(3, 1), (0,), (2,)]],
                         ids=["4", "2-interleaved", "3-uneven"])
def test_identical_strips_on_groups_match_the_jax_loopback_chunk(loopback_chunk, groups):
    """Four identical strips, periodic in the strip height: the K14 chunk
    on launch groups equals the JAX loopback chunk on every strip, its
    skip count four times that chunk's and its activity that chunk's
    tiled four times; gliders cross both strip edges, so a wrong
    neighbour across groups shows."""
    want, wsk, wact, plan = loopback_chunk
    strips, merged = cuda_halo.strip_mega_launches(
        strips_of(np.tile(edge_strip(1024), (4, 1)), 4), tlife.CONWAY, plan, 8, groups=groups)
    for t in strips:
        np.testing.assert_array_equal(tpacked.unpack(t).numpy(), want)
    assert merged.skipped.tolist() == [wsk] * 4 and wsk > 0
    np.testing.assert_array_equal(merged.act.numpy(), np.tile(wact, 4))


def test_row_mesh_superstep_on_groups_matches_jax(ref, monkeypatch, one_group_a_shard):
    """``make_superstep`` on a CPU (4, 1) mesh with the tier taken (the
    policy answering as on a mesh of cards) and one launch group a strip:
    8·18 + 6 turns at the JAX plan are one 8-launch K14 chunk a group
    and a K10 remainder; the board equals the JAX ``make_superstep`` on
    its (4, 1) mesh in interpret mode and the straight single-device
    board, and the skip count and activity the one-group chunk's."""
    from test_torch_strip_mega import jax_plan

    monkeypatch.setattr(cuda_halo, "adaptive_strip_plan",
                        lambda strip, turns, cap=0: jax_plan(ref.ph, strip, turns, cap))
    monkeypatch.setattr(cuda_halo, "tier_policy", lambda *a, **k: (True, "in-kernel"))
    board, turns = seam_soup(4, 1024), 8 * 18 + 6
    m = tmesh.make_mesh((4, 1), [CPU] * 4)
    sb = halo.board_sharding(m).shard(tpacked.pack(torch.from_numpy(board)))
    seen = []
    real = cuda_halo.strip_mega_launches

    def spy(*a, **kw):
        seen.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(cuda_halo, "strip_mega_launches", spy)
    out, sk, act = cuda_halo.make_superstep(m, tlife.CONWAY, skip_stable=True,
                                            with_stats=True)(sb, turns)
    assert len(seen) == 1
    got = tpacked.unpack(out.gather()).numpy()
    jm = ref.make_mesh((4, 1))
    pb = ref.jax.device_put(np.asarray(ref.packed.pack(ref.jnp.asarray(board))),
                            ref.packed_sharding(jm))
    jout = ref.ph.make_superstep(jm, ref.life.CONWAY, skip_stable=True)(pb, turns)
    np.testing.assert_array_equal(got, np.asarray(ref.packed.unpack(jout)))
    straight = tpacked.superstep(tpacked.pack(torch.from_numpy(board)), tlife.CONWAY, turns)
    np.testing.assert_array_equal(got, tpacked.unpack(straight).numpy())
    monkeypatch.setattr(cuda_halo, "peer_groups", lambda devices: {0: tuple(range(4))})
    _, one_sk, one_act = cuda_halo.make_superstep(m, tlife.CONWAY, skip_stable=True,
                                                  with_stats=True)(sb, turns)
    assert int(sk) == int(one_sk) and torch.equal(act, one_act)


@pytest.fixture(scope="module")
def jax_virtual_2d(ref):
    """The JAX virtual 2-D build on ``mesh2d_board`` by mesh shape:
    (board, skipped, activity), the megakernel in interpret mode."""

    @functools.lru_cache(maxsize=None)
    def run(mesh_shape, turns):
        p = ref.jnp.asarray(np.asarray(ref.packed.pack(ref.jnp.asarray(mesh2d_board()))))
        fn = ref.ph.make_superstep_virtual_2d(mesh_shape, ref.life.CONWAY, with_stats=True)
        out, sk, act = fn(p, turns)
        return np.asarray(out).view(np.int32), int(sk), np.asarray(act)

    return run


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_virtual_2d_on_groups_matches_jax(ref, monkeypatch, jax_virtual_2d, one_group_a_shard,
                                         mesh_shape):
    """The port's virtual 2-D build with one launch group a tile (K15's
    plain version a tile a launch) at the JAX plan: board, skip count and
    (ny·grid, nx) activity equal the JAX virtual build's."""
    from test_torch_tile_mega import jax_tile_plan

    monkeypatch.setattr(cuda_halo, "adaptive_tile_plan",
                        lambda tile, turns, cap=0: jax_tile_plan(ref.ph, tile, turns, cap))
    turns = 8 * 18
    out, sk, act = cuda_halo.make_superstep_virtual_2d(mesh_shape, tlife.CONWAY, 0, True)(
        packed_of(mesh2d_board()), turns)
    want = jax_virtual_2d(mesh_shape, turns)
    np.testing.assert_array_equal(out.numpy(), want[0])
    assert int(sk) == want[1]
    np.testing.assert_array_equal(act.numpy(), want[2])


# -- the groups, the waits and the policy ----------------------------------------------------


def kernel_reads(s: int, mesh_shape) -> set:
    """The shards whose buffers or interval state shard s's launch reads,
    by the kernels' own index arithmetic: K14's StripSource north and
    south (``rd_tab[wrap(strip -/+ 1)]``) and MeshIntervals (``t =
    wrap(s -/+ 1)``); K15's MeshTileSource (``tab[wrap(dy + sy) * nx +
    wrap(dx + sx)]``, sy, sx in -1..1) and TorusTileIntervals (tiles
    ``wrap(dx + side)`` of rows ``wrap(dy -/+ 1)`` and dy)."""
    ny, nx = mesh_shape
    if nx == 1:
        return {(s - 1) % ny, (s + 1) % ny}
    dy, dx = divmod(s, nx)
    window = {((dy + sy) % ny) * nx + (dx + sx) % nx for sy in (-1, 0, 1) for sx in (-1, 0, 1)}
    intervals = {((dy + ty) % ny) * nx + (dx + side) % nx
                 for side in (-1, 0, 1) for ty in (-1, 0, 1)}
    return window | intervals


@st.composite
def assignments(draw):
    shape = draw(st.sampled_from([(ny, nx) for ny in range(1, 5) for nx in range(1, 5)]
                                 + [(8, 1), (5, 1), (6, 1), (7, 1)]))
    n = shape[0] * shape[1]
    cards = draw(st.lists(st.integers(0, 3), min_size=n, max_size=n))
    return shape, [torch.device("cuda", c) for c in cards]


@settings(max_examples=300, deadline=None, derandomize=True)
@given(assignments())
def test_peer_waits_cover_every_card_read(case):
    """For any mesh up to (4, 4) and (8, 1) and any assignment of its
    shards to 1-4 cards: each card waits on exactly the other cards that
    own a shard its shards read, corners included; ``peer_pairs`` adds
    the first card (the interval state) to every other card's."""
    shape, devices = case
    groups = cuda_halo.peer_groups(devices)
    assert sorted(s for ids in groups.values() for s in ids) == list(range(len(devices)))
    assert all(devices[s] == card for card, ids in groups.items() for s in ids)
    owner = {s: d for s, d in enumerate(devices)}
    waits = cuda_halo.peer_waits(groups, shape)
    for card, ids in groups.items():
        want = {owner[r] for s in ids for r in kernel_reads(s, shape)} - {card}
        assert set(waits[card]) == want
    for first in dict.fromkeys((devices[0], devices[-1])):
        pairs = set(cuda_halo.peer_pairs(groups, shape, None if first == devices[0] else first))
        for card in groups:
            need = set(waits[card]) | ({first} - {card})
            assert {peer for c, peer in pairs if c == card} == need


def cards(shape):
    n = shape[0] * shape[1]
    return [torch.device("cuda", s * 4 // n) for s in range(n)]


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_policy_on_cards_equals_ici_tier_policy(ref, monkeypatch, shape):
    """Shards on cuda:0..3 whose cards reach each other: the in-kernel
    tier, ``ici_tier_policy``'s answer for a mesh of chips."""
    monkeypatch.delenv("DGOL_ICI", raising=False)
    asked = []
    monkeypatch.setattr(cuda_halo, "peer_access", lambda c, p: asked.append((c, p)) or True)
    got = cuda_halo.tier_policy(tmesh.make_mesh(shape, cards(shape)))
    assert got == (True, "in-kernel")
    assert got == ref.ph.ici_tier_policy(ref.make_mesh(shape), interpret=False)
    assert asked and all(c != p for c, p in asked)


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_policy_names_both_cards_without_peer_access(monkeypatch, shape):
    """Cards that cannot reach each other: the ppermute form, the reason
    naming both; a recorded outcome, never a warning."""
    monkeypatch.delenv("DGOL_ICI", raising=False)
    monkeypatch.setattr(cuda_halo, "peer_access", lambda c, p: p.index != 0)
    use, reason = cuda_halo.tier_policy(tmesh.make_mesh(shape, cards(shape)))
    assert not use and re.search(r"no CUDA peer access from cuda:[1-3] to cuda:0", reason)


def test_policy_on_cards_and_the_cpu():
    """Shards on a card and on the CPU take the ppermute form, by policy."""
    use, reason = cuda_halo.tier_policy(tmesh.make_mesh((2, 1), [torch.device("cuda", 0), CPU]))
    assert not use and "CUDA devices" in reason


def test_peer_groups_in_order_of_first_shard():
    devs = [torch.device("cuda", i) for i in (2, 0, 2, 1)]
    assert cuda_halo.peer_groups(devs) == {devs[0]: (0, 2), devs[1]: (1,), devs[3]: (3,)}
    assert cuda_halo.peer_groups([torch.device("cuda")] * 2) == {torch.device("cuda", 0): (0, 1)}


# -- on the card -----------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def records_on(shards, plan, kind, n, **kw):
    chunk = {"strip": cuda_halo.strip_mega_launches, "tile": cuda_halo.tile_mega_launches}[kind]
    seen = []
    chunk(shards, tlife.CONWAY, plan, n,
          each=lambda out, s: seen.append([x.cpu() for x in [*flat(out), s.state, s.route,
                                                              s.skipped, s.act]]), **kw)
    return seen


def assert_same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert all(torch.equal(p, q) for p, q in zip(x, y))


def as_plain_routes(records):
    """The routes as the plain version gives them: it forces the edge
    stripes K15 elides."""
    return [[*r[:-3], torch.where(r[-3] == cuda_adaptive.ROUTE_ELIDED, cuda_adaptive.ROUTE_FULL,
                                  r[-3]), *r[-2:]] for r in records]


@pytest.mark.gpu
@pytest.mark.parametrize("split", list(SPLITS))
def test_gpu_streams_stand_in_for_cards(cuda_device, split):
    """On one card, one stream a group: the peer form's launches, tables
    and events equal the one-launch K14 or K15 and its plain version at
    every launch (board, state, routes, skip counts, activity)."""
    mesh_shape, groups = SPLITS[split]
    shards, plan, kind = mesh_case(mesh_shape)
    on = [t.to(cuda_device) for t in flat(shards)]
    on = nest(on, mesh_shape, kind)
    want = records_on(on, plan, kind, NLAUNCH)
    plain = records_on(on, plan, kind, NLAUNCH, plain=True)
    streams = [torch.cuda.Stream(cuda_device) for _ in groups]
    got = records_on(on, plan, kind, NLAUNCH, groups=groups, streams=streams)
    torch.cuda.synchronize()
    assert_same_records(got, want)
    assert_same_records(as_plain_routes(want), plain)


@pytest.mark.gpu
@pytest.mark.parametrize("split", list(SPLITS))
def test_gpu_peer_form_across_the_cards(cuda_device, split):
    """With two cards or more: each group on a card of its own (round
    robin), peer access enabled, every launch equal to the one-card
    launch."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    mesh_shape, groups = SPLITS[split]
    shards, plan, kind = mesh_case(mesh_shape)
    fl = flat(shards)
    want = records_on(nest([t.to(cuda_device) for t in fl], mesh_shape, kind), plan, kind,
                      NLAUNCH)
    card = {s: torch.device("cuda", k % n) for k, g in enumerate(groups) for s in g}
    placed = nest([t.to(card[s]) for s, t in enumerate(fl)], mesh_shape, kind)
    got = records_on(placed, plan, kind, NLAUNCH, groups=groups)
    assert_same_records(got, want)


def final_of(out, s):
    return [x.cpu() for x in [*flat(out), s.state, s.skipped, s.act]]


@pytest.mark.gpu
@pytest.mark.parametrize("split", list(SPLITS))
def test_gpu_chunk_with_nothing_read_between_launches(cuda_device, split):
    """A 3·NLAUNCH-launch chunk with no ``each`` (which joins the groups
    after every launch), so only the events order the groups: one stream
    a group on one card, and a card a group where there are two cards or
    more, equal the one launch in shards, final state, skip counts and
    activity."""
    mesh_shape, groups = SPLITS[split]
    shards, plan, kind = mesh_case(mesh_shape)
    chunk = {"strip": cuda_halo.strip_mega_launches, "tile": cuda_halo.tile_mega_launches}[kind]
    fl = flat(shards)
    on = nest([t.to(cuda_device) for t in fl], mesh_shape, kind)
    n = 3 * NLAUNCH
    want = final_of(*chunk(on, tlife.CONWAY, plan, n))
    streams = [torch.cuda.Stream(cuda_device) for _ in groups]
    assert_same_records([final_of(*chunk(on, tlife.CONWAY, plan, n, groups=groups,
                                         streams=streams))], [want])
    cards = torch.cuda.device_count()
    if cards > 1:
        card = {s: torch.device("cuda", k % cards) for k, g in enumerate(groups) for s in g}
        placed = nest([t.to(card[s]) for s, t in enumerate(fl)], mesh_shape, kind)
        assert_same_records([final_of(*chunk(placed, tlife.CONWAY, plan, n, groups=groups))],
                            [want])
