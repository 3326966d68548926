"""The in-kernel exchange tier of ``skip_stable`` on row meshes
(``parallel/cuda_halo.py``: K14 ``strip_mega_launch``, the chunk function
``strip_mega_launches``, the dispatch split ``mega_launches`` and the
policy ``tier_policy``) against the JAX package's.

On the CPU the wrappers run their plain versions.  A (1, 1) mesh takes
the tier in both packages (the JAX loopback build of
``_kernel_frontier_mega_strip``, in interpret mode), so there the port's
dispatch must give the JAX dispatch's board, skip count and activity,
tolerance 0, across the chunk seam.  A mesh of several CPU shards takes
the ppermute tier in both (the interpret-mode reason), so the tier's
multi-strip form is held to what it must equal: on a board of identical
strips, the JAX loopback chunk on one strip (the exchange's direction and
shifts), and on soups, K5's plain version on the whole board at the
strip's stripe height (on one device the two compute the same function).
Tests marked ``gpu`` hold K14 to its plain version on the card.

The JAX package is imported inside the tests that compare with it:
``python -m pytest tests/test_torch_strip_mega.py -m gpu --noconftest``
runs the card's tests on a machine without JAX."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
from distributed_gol_torch.engine import pgm
from distributed_gol_torch.engine.backend import Backend
from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive
from distributed_gol_torch.ops import packed as tpacked
from distributed_gol_torch.parallel import cuda_halo, halo
from distributed_gol_torch.parallel import mesh as tmesh
from distributed_gol_torch.utils.soup import random_soup

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

CPU = torch.device("cpu")
GLIDER_DOWN = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=bool)
GLIDER_UP = GLIDER_DOWN[::-1, ::-1]  # heads up and left


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax
    import jax.numpy as jnp

    from distributed_gol_tpu.engine.backend import Backend as JBackend
    from distributed_gol_tpu.engine.params import Params as JParams
    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import packed
    from distributed_gol_tpu.parallel import pallas_halo
    from distributed_gol_tpu.parallel.mesh import make_mesh
    from distributed_gol_tpu.parallel.packed_halo import packed_sharding

    return SimpleNamespace(jax=jax, jnp=jnp, life=life, packed=packed, ph=pallas_halo,
                           make_mesh=make_mesh, packed_sharding=packed_sharding,
                           Backend=JBackend, Params=JParams)


def jax_plan(ph, strip, turns, cap=0):
    """The JAX package's strip plan as an ``AdaptivePlan``."""
    cap, t, adaptive, fplan = ph._adaptive_strip_plan(strip, turns, cap or None)
    if not adaptive:
        return None
    return cuda_adaptive.AdaptivePlan(t, ph._strip_plan_tile(strip, t, cap), fplan is not None)


@pytest.fixture()
def jax_strip_plan(monkeypatch, ref):
    """Put the port on the JAX package's strip plan."""
    monkeypatch.setattr(cuda_halo, "adaptive_strip_plan",
                        lambda strip, turns, cap=0: jax_plan(ref.ph, strip, turns, cap))


@pytest.fixture()
def plain_calls(monkeypatch):
    """Counts of the calls of the row-mesh kernels' plain versions (what
    the wrappers run on the CPU), by kernel."""
    counts = dict.fromkeys(("K9", "K10", "K11", "K12", "K14"), 0)
    names = {"K9": "ext_launch_plain", "K10": "ext_skip_launch_plain",
             "K11": "strip_probing_launch_plain", "K12": "strip_frontier_launch_plain",
             "K14": "strip_mega_launch_plain"}
    for k, name in names.items():
        fn = getattr(cuda_halo, name)

        def counted(*a, _fn=fn, _k=k, **kw):
            counts[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(cuda_halo, name, counted)
    return counts


def _put(b: np.ndarray, cells: np.ndarray, y: int, x: int) -> None:
    ys, xs = np.nonzero(cells)
    b[(ys + y) % b.shape[0], (xs + x) % b.shape[1]] = True


def ici_board() -> np.ndarray:
    """``tests/test_pallas_halo.py::TestInKernelICI``'s 4096 x 128 board:
    a glider, a block and a period-3 pulsar."""
    b = np.zeros((4096, 128), dtype=np.uint8)
    for dy, dx in [(0, 1), (1, 2), (2, 0), (2, 1), (2, 2)]:
        b[2030 + dy, 60 + dx] = 255
    b[100:102, 20:22] = 255
    for c in [2, 3, 4, 8, 9, 10]:
        for r in (0, 5, 7, 12):
            b[3000 + r, 40 + c] = 255
            b[3000 + c, 40 + r] = 255
    return b


def edge_strip(h: int, w: int = 128) -> np.ndarray:
    """An (h, w) strip of ash (blocks) with a glider leaving it across its
    bottom edge, one leaving across its top edge, and a period-3 pulsar:
    every launch of a chunk has work at both edges."""
    b = np.zeros((h, w), dtype=bool)
    for y in range(12, h - 12, 23):
        for x in range(4 + y % 5, w - 4, 29):
            _put(b, np.ones((2, 2), dtype=bool), y, x)
    b[h - 10 :, 40:60] = False
    _put(b, GLIDER_DOWN, h - 6, 45)
    b[:10, 80:100] = False
    _put(b, GLIDER_UP, 3, 85)
    y0 = h // 2
    b[y0 - 2 : y0 + 15, 60:79] = False
    for c in (2, 3, 4, 8, 9, 10):
        for r in (0, 5, 7, 12):
            b[y0 + r, 62 + c] = b[y0 + c, 62 + r] = True
    return b.astype(np.uint8) * 255


@functools.lru_cache(maxsize=None)
def seam_soup(ny: int, h_loc: int, w: int = 128) -> np.ndarray:
    """A settled soup of ny strips of h_loc rows with a glider heading down
    across every strip seam, the torus wrap included."""
    p = tpacked.pack(torch.from_numpy(random_soup(ny * h_loc, w, 0.3, 7 + ny)))
    b = tpacked.unpack(tpacked.superstep(p, tlife.CONWAY, 3000)).numpy() > 0
    for k in range(1, ny + 1):
        y, x = k * h_loc - 5, (17 * k) % (w - 12)
        b[y - 3 : y + 6, x : x + 9] = False
        _put(b, GLIDER_DOWN, y, x + 3)
    return b.astype(np.uint8) * 255


def strips_of(board: np.ndarray, ny: int, device=CPU) -> list[torch.Tensor]:
    p = tpacked.pack(torch.from_numpy(board)).to(device)
    return list(p.chunk(ny))


def run11(board: np.ndarray, turns: int, device=CPU, **kw):
    """The port's ``make_superstep`` on a (1, 1) mesh of ``device``:
    (board, skipped, activity) on the CPU."""
    m = tmesh.make_mesh((1, 1), [device])
    sb = halo.board_sharding(m).shard(tpacked.pack(torch.from_numpy(board)).to(device))
    out, sk, act = cuda_halo.make_superstep(m, tlife.CONWAY, skip_stable=True, with_stats=True,
                                            **kw)(sb, turns)
    return tpacked.unpack(out.gather()).cpu().numpy(), int(sk), act.cpu().numpy()


def jax_run11(ref, board: np.ndarray, turns: int, **kw):
    """The JAX package's (1, 1) ``make_superstep``: the loopback build of
    the in-kernel tier (or with ``in_kernel=False`` the ppermute form)."""
    mesh = ref.make_mesh((1, 1))
    pb = ref.jax.device_put(np.asarray(ref.packed.pack(ref.jnp.asarray(board))),
                            ref.packed_sharding(mesh))
    out, sk, act = ref.ph.make_superstep(mesh, ref.life.CONWAY, skip_stable=True,
                                         with_stats=True, **kw)(pb, turns)
    return np.asarray(ref.packed.unpack(out)), int(sk), np.asarray(act)


# -- the policy ----------------------------------------------------------------------


def cpu_mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * (shape[0] * shape[1]))


@pytest.mark.parametrize("shape,kw,env,want", [
    ((1, 1), {}, None, (True, "in-kernel")),
    ((1, 1), dict(in_kernel=False), None, (False, "forced-ppermute (in_kernel=False)")),
    ((1, 1), {}, "0", (False, "forced-ppermute (DGOL_ICI=0)")),
    ((1, 1), dict(in_kernel=True), "0", (True, "in-kernel")),
    ((2, 1), {}, None, (False, cuda_halo.INTERPRET_REASON)),
    ((2, 1), dict(in_kernel=True), None, (False, cuda_halo.INTERPRET_REASON)),
], ids=["loopback", "forced", "env", "env-overridden", "interpret", "interpret-capability"])
def test_policy_matches_ici_tier_policy(monkeypatch, ref, shape, kw, env, want):
    """The cases the JAX package's own tests pin
    (``tests/test_pallas_halo.py::TestInKernelICI``): both packages give
    the same answer on a CPU mesh, the JAX one in interpret mode."""
    if env is None:
        monkeypatch.delenv("DGOL_ICI", raising=False)
    else:
        monkeypatch.setenv("DGOL_ICI", env)
    assert cuda_halo.tier_policy(cpu_mesh(shape), **kw) == want
    assert ref.ph.ici_tier_policy(ref.make_mesh(shape), interpret=True, **kw) == want


def card(*indices):
    return [torch.device("cuda", i) for i in indices]


@pytest.mark.parametrize("shape,devices,kw,env,reach,want", [
    ((4, 1), card(0, 0, 0, 0), {}, None, True, "in-kernel"),
    ((1, 1), card(0), {}, None, True, "in-kernel"),
    ((4, 1), card(0, 0, 0, 0), dict(in_kernel=False), None, True,
     "forced-ppermute (in_kernel=False)"),
    ((4, 1), card(0, 0, 0, 0), {}, "off", True, "forced-ppermute (DGOL_ICI=0)"),
    ((4, 1), card(0, 0, 0, 0), dict(in_kernel=True), "false", True, "in-kernel"),
    ((2, 1), card(0, 1), {}, None, True, "in-kernel"),
    ((4, 1), card(0, 1, 0, 1), dict(in_kernel=True), None, False,
     "no CUDA peer access from cuda:0 to cuda:1"),
    ((2, 2), card(0, 0, 0, 0), {}, None, True, "in-kernel"),
    ((4, 1), card(0, 0, 0, 0), dict(strip=(64, 4), tile_cap=16), None, True, "no frontier plan"),
    ((4, 1), card(0, 0, 0, 0), dict(strip=(64, 4), tile_cap=16, in_kernel=False), None, True,
     "forced-ppermute (in_kernel=False)"),
    ((4, 1), card(0, 0, 0, 0), dict(strip=(64, 4)), "0", True, "forced-ppermute (DGOL_ICI=0)"),
    ((4, 1), [CPU] * 4, dict(strip=(64, 4), in_kernel=True), None, True, "interpret-mode"),
], ids=["one-card", "one-card-loopback", "forced", "env", "env-overridden", "two-cards",
        "two-cards-forced-in", "two-d", "no-plan", "forced-before-plan", "plan-then-env",
        "cpu-shards"])
def test_policy_table(monkeypatch, shape, devices, kw, env, reach, want):
    """The port's order of checks, on device descriptors (no card needed;
    ``reach`` replaces the peer-access check): ``in_kernel=False``, then
    the shard's frontier plan, then ``DGOL_ICI=0`` (which ``in_kernel=True``
    outranks), then CPU shards, then, for strips on several cards (the
    peer form), cards that cannot reach each other; a row or 2-D mesh on
    one card or on cards that reach each other takes the tier."""
    if env is None:
        monkeypatch.delenv("DGOL_ICI", raising=False)
    else:
        monkeypatch.setenv("DGOL_ICI", env)
    monkeypatch.setattr(cuda_halo, "peer_access", lambda card, peer: reach)
    use, reason = cuda_halo.tier_policy(tmesh.make_mesh(shape, devices), **kw)
    assert use == (reason == "in-kernel")
    assert want in reason


# -- the (1, 1) mesh: the JAX loopback build -------------------------------------------


@pytest.mark.parametrize("turns", [4 * 18, 5 * 18, 4 * 18 + 12, 4 * 18 + 7, 12 * 18])
def test_loopback_matches_jax(ref, jax_strip_plan, plain_calls, turns):
    """``TestInKernelICI``'s board and turns, and 12 launches (one 8-launch
    K14 chunk and a 4-launch K11 tail): at the JAX plan (T = 18 on
    1024-row stripes) the port's (1, 1) dispatch equals the JAX loopback
    tier in board, skip count and activity, and equals the straight
    single-device board."""
    b = ici_board()
    got = run11(b, turns)
    want = jax_run11(ref, b, turns)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    straight = tpacked.unpack(tpacked.superstep(tpacked.pack(torch.from_numpy(b)), tlife.CONWAY,
                                                turns))
    np.testing.assert_array_equal(got[0], straight.numpy())
    full = turns // 18
    n = plain_calls
    assert n["K14"] == (8 if full >= 8 else 0) and n["K11"] == full % 8 and not n["K12"]
    if turns == 12 * 18:
        assert got[1] > 0  # ash stripes skipped inside the chunk


@pytest.mark.parametrize("turns", [8 * 18, 12 * 18 + 7])
def test_block_mirror_loopback_matches_jax(ref, jax_strip_plan, monkeypatch, turns):
    """K14's block mirror (``strip_mega_launch_mirror``: the register-
    resident kernel's blocks, light cone and column groups) in place of
    the plain version in the (1, 1) dispatch, at the JAX plan: board,
    skip count and activity of the JAX loopback tier, tolerance 0."""
    calls = []

    def mirror(*a, **kw):
        calls.append(1)
        return cuda_halo.strip_mega_launch_mirror(*a, **kw)

    monkeypatch.setattr(cuda_halo, "strip_mega_launch_plain", mirror)
    b = ici_board()
    got = run11(b, turns)
    want = jax_run11(ref, b, turns)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert len(calls) == 8


def test_in_kernel_false_runs_the_ppermute_form(ref, jax_strip_plan, plain_calls):
    """``in_kernel=False`` on the (1, 1) mesh takes K12 with its exchange
    between launches, the board of the in-kernel tier, and the JAX
    package's ppermute telemetry; the two tiers' telemetry differ (the
    chunk restarts its state, the tail probes)."""
    b, turns = ici_board(), 12 * 18
    forced = run11(b, turns, in_kernel=False)
    assert plain_calls["K12"] == 12 and not plain_calls["K14"]
    want = jax_run11(ref, b, turns, in_kernel=False)
    np.testing.assert_array_equal(forced[0], want[0])
    assert forced[1] == want[1]
    np.testing.assert_array_equal(forced[2], want[2])
    tier = run11(b, turns, in_kernel=True)
    np.testing.assert_array_equal(forced[0], tier[0])
    assert plain_calls["K14"] == 8


@pytest.mark.parametrize("plan", [None, cuda_adaptive.AdaptivePlan(12, 32, True)],
                         ids=["port-plan", "chunk-plan"])
def test_golden_512_through_the_tier(monkeypatch, reference_dir, plain_calls, plan):
    """The reference's 512² board x 100 through the (1, 1) tier equals the
    golden PGM: at the port's plan (T = 24: a 4-launch K11 tail, then K9)
    and at T = 12 on 32-row stripes (one 8-launch K14 chunk, then K9)."""
    if plan is not None:
        monkeypatch.setattr(cuda_halo, "adaptive_strip_plan", lambda *a, **k: plan)
    board = pgm.read_pgm(reference_dir / "images" / "512x512.pgm")
    want = pgm.read_pgm(reference_dir / "check" / "images" / "512x512x100.pgm")
    m = tmesh.make_mesh((1, 1), [CPU])
    step = cuda_halo.make_superstep_bytes(m, tlife.CONWAY, skip_stable=True)
    got = step(halo.board_sharding(m).shard(torch.from_numpy(board)), 100).gather()
    np.testing.assert_array_equal(got.numpy(), want)
    assert plain_calls["K14"] == (8 if plan is not None else 0) and plain_calls["K9"] == 1


# -- several strips: the exchange inside the launch ------------------------------------


@pytest.fixture(scope="module")
def loopback_chunks(ref):
    """The JAX loopback chunk (8 launches of T = 18) on one strip of
    ``edge_strip``, by strip height: a 512-row strip (one stripe of 512
    rows, both edges of the strip) and a 1024-row strip at cap 256 (four
    stripes).  (board, skipped, activity, plan)."""
    out = {}
    for h, cap in ((512, 0), (1024, 256)):
        strip = (h, 4)
        plan = jax_plan(ref.ph, strip, 10**6, cap)
        call = ref.ph._build_dispatch_frontier_strip(strip, ref.life.CONWAY, plan.t, 8, True,
                                                     cap or None, False)
        p = ref.jnp.asarray(np.asarray(ref.packed.pack(ref.jnp.asarray(edge_strip(h)))))
        a, b, sk, act = call(ref.jnp.zeros(3, ref.jnp.int32), p, ref.jnp.zeros_like(p))
        out[h] = (np.asarray(ref.packed.unpack(a)), int(sk[0]), np.asarray(act), plan)
    return out


@pytest.mark.parametrize("h", [512, 1024])
@pytest.mark.parametrize("ny", [2, 4])
def test_identical_strips_match_the_loopback_chunk(loopback_chunks, h, ny):
    """A board of ny identical strips is periodic in the strip height, so
    every strip of one K14 chunk evolves as the single strip's torus: the
    plain chunk's strips each equal the JAX loopback chunk, its skip count
    is ny times that chunk's and its activity that chunk's tiled ny times.
    The gliders crossing both edges make a wrong exchange direction or
    shift show."""
    want, wsk, wact, plan = loopback_chunks[h]
    strips, st = cuda_halo.strip_mega_launches(strips_of(np.tile(edge_strip(h), (ny, 1)), ny),
                                               tlife.CONWAY, plan, 8)
    for t in strips:
        np.testing.assert_array_equal(tpacked.unpack(t).numpy(), want)
    assert st.skipped.tolist() == [wsk] * ny
    np.testing.assert_array_equal(st.act.numpy(), np.tile(wact, ny))
    if plan.grid(h) > 1:
        assert wsk > 0  # the ash stripe skips


PLANS = {"one-stripe": cuda_adaptive.AdaptivePlan(24, 64, True),
         "four-stripes": cuda_adaptive.AdaptivePlan(6, 16, True)}


@pytest.mark.parametrize("plan", list(PLANS.values()), ids=list(PLANS))
@pytest.mark.parametrize("ny", [1, 2, 3, 4])
@pytest.mark.parametrize("rule", ["conway", "highlife"])
def test_soup_chunk_matches_k5_on_the_whole_board(rule, ny, plan):
    """On 64-row strips of a settled soup with gliders across every seam
    and the wrap: the plain K14 chunk (8 launches) equals K5's plain chunk
    on the whole board at the same stripes, in board, total skip count
    and activity, and the straight board."""
    r = tlife.RULES[rule]
    board = seam_soup(ny, 64)
    strips, st = cuda_halo.strip_mega_launches(strips_of(board, ny), r, plan, 8)
    whole = tpacked.pack(torch.from_numpy(board))
    want, wsk, wact = cuda_adaptive.frontier_superstep_mirror(whole, r, plan, 8)
    assert torch.equal(torch.cat(strips), want)
    assert int(st.skipped.sum()) == int(wsk)
    assert torch.equal(st.act, wact)
    assert torch.equal(want, tpacked.superstep(whole, r, 8 * plan.t))
    if plan.grid(64) > 1 and rule == "conway":
        assert 0 < int(wsk) < 8 * ny * plan.grid(64)


def test_chunk_never_writes_its_input():
    board = seam_soup(2, 64)
    strips = strips_of(board, 2)
    before = [t.clone() for t in strips]
    cuda_halo.strip_mega_launches(strips, tlife.CONWAY, PLANS["four-stripes"], 3)
    assert all(torch.equal(a, b) for a, b in zip(strips, before))


def test_launch_refuses_what_k14_cannot_take():
    """The geometry gate raises, never quietly takes another tier: a plan
    with no frontier form, stripes that do not divide the strip, a write
    buffer that is a read buffer, state of another mesh's size."""
    strips = strips_of(seam_soup(2, 64), 2)
    bufs = [torch.empty_like(t) for t in strips]
    plan = PLANS["four-stripes"]
    st = cuda_halo.MeshState.start(2, 64, plan, CPU)
    bad = [
        (strips, bufs, st, cuda_adaptive.AdaptivePlan(6, 8, False)),
        (strips, bufs, st, cuda_adaptive.AdaptivePlan(6, 48, True)),
        (strips, [bufs[0], strips[0]], st, plan),
        (strips, [bufs[0], bufs[0]], st, plan),
        (strips, bufs, cuda_halo.MeshState.start(3, 64, plan, CPU), plan),
    ]
    for reads, writes, state, p in bad:
        with pytest.raises(ValueError):
            cuda_halo.strip_mega_launch(reads, writes, state, tlife.CONWAY, p, 0, True)


# -- the slice end to end ------------------------------------------------------------------


def test_run_on_the_tier_writes_the_jax_pgm(monkeypatch, tmp_path, plain_calls):
    """``gol.run`` on a (4, 1) mesh with the policy answering as it does on
    one card (CPU shards otherwise take the ppermute tier): the Backend
    records the in-kernel tier, each 200-turn dispatch runs one 8-launch
    K14 chunk (T = 24 on 256-row strips) and a K10 and a K9 remainder per
    strip (the controller's probes add K9 launches), and the run writes the
    PGM of the JAX package's run (on its ppermute tier there)."""
    import distributed_gol_tpu as jgol
    from distributed_gol_torch.engine.session import Session as TSession
    from distributed_gol_tpu.engine.session import Session as JSession
    from tests.test_torch_run import SOUP, pgms, run

    monkeypatch.setattr(cuda_halo, "tier_policy", lambda *a, **k: (True, "in-kernel"))
    kw = dict(turns=2 * 200, superstep=200, image_height=1024, image_width=64,
              engine="pallas-packed", skip_stable=True, mesh_shape=(4, 1), turn_events="batch",
              **SOUP)
    t_events, t_out = run(tgol, tmp_path, "torch", None, TSession(), **kw)
    _, j_out = run(jgol, tmp_path, "jax", None, JSession(), **kw)
    assert pgms(t_out) == pgms(j_out)
    report = dict([f for n, f in t_events if n == "MetricsReport"][0])
    assert report["info"]["backend.sharded_tier"] == "ici-megakernel"
    assert report["info"]["backend.sharded_tier_policy"] == "in-kernel"
    n = plain_calls
    assert (n["K14"], n["K10"], n["K11"], n["K12"]) == (16, 8, 0, 0) and n["K9"] >= 8


# -- the Backend's tier record ----------------------------------------------------------


@pytest.mark.parametrize("in_kernel,env", [(False, None), (None, "0"), (True, None)],
                         ids=["in_kernel=False", "DGOL_ICI=0", "in_kernel=True"])
def test_backend_tier_record_matches_jax(monkeypatch, ref, tmp_path, in_kernel, env):
    """``Backend(params, in_kernel=)`` on a (4, 1) CPU mesh whose 256-row
    strips host both packages' frontier plans: the same tier and policy as
    the JAX Backend (forced, the environment's switch, or the interpret
    reason, which ``in_kernel=True`` does not outrank)."""
    if env is None:
        monkeypatch.delenv("DGOL_ICI", raising=False)
    else:
        monkeypatch.setenv("DGOL_ICI", env)
    kw = dict(image_height=1024, image_width=64, engine="pallas-packed", skip_stable=True,
              mesh_shape=(4, 1), out_dir=tmp_path)
    tb = Backend(tgol.Params(device="cpu", **kw), in_kernel=in_kernel)
    jb = ref.Backend(ref.Params(**kw), in_kernel=in_kernel)
    assert (tb.sharded_tier, tb.sharded_tier_policy) == (jb.sharded_tier, jb.sharded_tier_policy)
    assert tb.sharded_tier == "ppermute"


@pytest.mark.parametrize("policy,want", [(None, False), ((True, "in-kernel"), True)],
                         ids=["interpret-reason", "one-card"])
def test_backend_hands_its_tier_down(monkeypatch, policy, want):
    """The Backend asks the policy once and gives its answer to the engine
    as ``in_kernel``, so the tier that runs is the tier recorded."""
    if policy is not None:
        monkeypatch.setattr(cuda_halo, "tier_policy", lambda *a, **k: policy)
    seen = {}
    real = cuda_halo.make_superstep_bytes

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(cuda_halo, "make_superstep_bytes", spy)
    be = Backend(tgol.Params(device="cpu", image_height=1024, image_width=64,
                             engine="pallas-packed", skip_stable=True, mesh_shape=(4, 1)))
    assert seen["in_kernel"] is want
    assert be.sharded_tier == ("ici-megakernel" if want else "ppermute")


# -- on the card -----------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def chunk_on(strips, plan, rule, nlaunch, plain=False, each=None):
    out, st = cuda_halo.strip_mega_launches(strips, rule, plan, nlaunch, plain, each)
    return [t.cpu() for t in out], st.state.cpu(), st.skipped.cpu(), st.act.cpu()


def launch_by_launch(strips, plan, rule, nlaunch, plain=False):
    """A chunk's strips and whole state after each of its launches, copied
    to the CPU (a later launch rewrites the buffers)."""
    seen = []
    chunk_on(strips, plan, rule, nlaunch, plain,
             lambda out, st: seen.append(([t.to(CPU, copy=True) for t in out],
                                          st.state.to(CPU, copy=True))))
    return seen


def assert_same_chunk(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("nlaunch", [1, 8])
@pytest.mark.parametrize("h,plan", [(512, cuda_adaptive.AdaptivePlan(18, 512, True)),
                                    (1024, cuda_adaptive.AdaptivePlan(18, 256, True))])
@pytest.mark.parametrize("ny", [1, 2, 4])
def test_gpu_k14_matches_plain_on_identical_strips(cuda_device, ny, h, plan, nlaunch):
    strips = strips_of(np.tile(edge_strip(h), (ny, 1)), ny)
    want = chunk_on(strips, plan, tlife.CONWAY, nlaunch)
    got = chunk_on([t.to(cuda_device) for t in strips], plan, tlife.CONWAY, nlaunch)
    assert_same_chunk(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", list(PLANS.values()), ids=list(PLANS))
@pytest.mark.parametrize("ny", [1, 2, 3, 4])
@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
def test_gpu_k14_matches_plain_on_soups(cuda_device, monkeypatch, rule, ny, plan):
    """The chunk on the card (its launcher once, one wrapper call a
    launch, each launch counted in the rule's instantiation) against the
    plain chunk, on the card and on the CPU, and against its block mirror
    on the card (``strip_mega_launch_mirror`` at the card's blocks):
    boards, final state, skip counts and activity, and strips and state
    launch by launch; the strips are 4 words wide (narrower than one
    30-word column group)."""
    r = tlife.RULES[rule]
    strips = strips_of(seam_soup(ny, 64), ny)
    on_card = [t.to(cuda_device) for t in strips]
    want = chunk_on(strips, plan, r, 8)
    cuda_halo.reset_launches()
    assert_same_chunk(chunk_on(on_card, plan, r, 8), want)
    variant = cuda_halo.REG_RULES[cuda_halo.reg_rule(r)[2]]
    assert cuda_halo.strip_mega_launch.rules == {variant: 8}
    assert_same_chunk(chunk_on(on_card, plan, r, 8, plain=True), want)
    blocks = cuda_adaptive.frontier_blocks(tuple(strips[0].shape), plan, ny,
                                           cuda_adaptive.device_sms(cuda_device))
    with monkeypatch.context() as m:
        m.setattr(cuda_halo, "strip_mega_launch_plain", functools.partial(
            cuda_halo.strip_mega_launch_mirror, blocks=blocks))
        assert_same_chunk(chunk_on(on_card, plan, r, 8, plain=True), want)
    for (a, sa), (b, sb) in zip(launch_by_launch(on_card, plan, r, 8),
                                launch_by_launch(strips, plan, r, 8)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)) and torch.equal(sa, sb)


@pytest.mark.gpu
@pytest.mark.parametrize("turns", [4 * 18 + 7, 12 * 18])
def test_gpu_loopback_dispatch_matches_the_cpu(cuda_device, turns):
    b = ici_board()
    got, want = run11(b, turns, cuda_device), run11(b, turns)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.gpu
def test_gpu_backend_on_a_virtual_row_mesh(cuda_device, monkeypatch, tmp_path):
    """On a virtual (4, 1) mesh of the card the Backend records the
    in-kernel tier; ``in_kernel=False`` and ``DGOL_ICI=0`` record the
    ppermute tier with the JAX package's forced reasons."""
    monkeypatch.delenv("DGOL_ICI", raising=False)
    params = tgol.Params(image_height=1024, image_width=64, skip_stable=True, mesh_shape=(4, 1),
                         out_dir=tmp_path)
    devices = [cuda_device] * 4
    be = Backend(params, devices)
    assert (be.sharded_tier, be.sharded_tier_policy) == ("ici-megakernel", "in-kernel")
    off = Backend(params, devices, in_kernel=False)
    assert (off.sharded_tier, off.sharded_tier_policy) == (
        "ppermute", "forced-ppermute (in_kernel=False)")
    monkeypatch.setenv("DGOL_ICI", "0")
    env = Backend(params, devices)
    assert (env.sharded_tier, env.sharded_tier_policy) == (
        "ppermute", "forced-ppermute (DGOL_ICI=0)")
