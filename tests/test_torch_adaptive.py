"""The adaptive (``skip_stable``) tier of the port (``ops/cuda_adaptive.py``)
against the JAX package's.

On the CPU the wrappers run their plain versions, which replay the stripe
decomposition, the decision regions and the state machine of the frontier
and probing kernels.  At the JAX package's own plan they must give the
same board, skip count and per-stripe activity as
``pallas_packed.make_superstep(..., skip_stable=True, with_stats=True)``
run in interpret mode, as that package's own tests run it; every
comparison is exact.  Tests marked ``gpu`` hold the CUDA kernels against
their plain versions on the card and skip where there is none.

The JAX package is imported inside the tests that compare with it, so the
``gpu`` tests also run on a machine without JAX:
``python -m pytest tests/test_torch_adaptive.py -m gpu --noconftest``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive, packed as tpacked

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

RULES = ["conway", "highlife"]
GLIDER = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=bool)  # heads down-right
PULSAR_SEG = (2, 3, 4, 8, 9, 10)


def words(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _put(b: np.ndarray, cells: np.ndarray, y: int, x: int) -> None:
    """OR a pattern into the torus at (y, x)."""
    h, w = b.shape
    ys, xs = np.nonzero(cells)
    b[(ys + y) % h, (xs + x) % w] = 255


def _pulsar() -> np.ndarray:
    p = np.zeros((13, 13), dtype=bool)
    for c in PULSAR_SEG:
        for r in (0, 5, 7, 12):
            p[r, c] = p[c, r] = True
    return p


def make_board(kind: str, h: int, w: int, stripe: int) -> np.ndarray:
    """Seeded test boards: "dead"; "ash" (blocks); "blinkers" (one across a
    stripe seam); "pulsar" (on a seam); "glider" (one crossing a stripe
    seam, one crossing the torus wrap in both axes, over ash); "soup"."""
    b = np.zeros((h, w), dtype=np.uint8)
    if kind == "soup":
        rng = np.random.default_rng(h + w)
        return np.where(rng.random((h, w)) < 0.3, 255, 0).astype(np.uint8)
    block = np.ones((2, 2), dtype=bool)
    if kind in ("ash", "glider"):
        for y in range(stripe // 2, h, 3 * stripe):
            for x in range(100, w, 700):
                _put(b, block, y, x)
    if kind == "blinkers":
        for y in range(stripe // 3, h, 2 * stripe):
            _put(b, np.ones((1, 3), dtype=bool), y, 64 + y)
        _put(b, np.ones((3, 1), dtype=bool), stripe - 1, 2000)  # across a seam
    if kind == "pulsar":
        _put(b, _pulsar(), stripe - 6, 3000)
    if kind == "glider":
        _put(b, GLIDER, stripe - 9, 1000)  # reaches the seam
        _put(b, GLIDER, h - 6, w - 5)  # wraps in both axes
    return b


BOARDS = ["dead", "ash", "blinkers", "pulsar", "glider", "soup"]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax.numpy as jnp

    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import packed, pallas_packed

    return SimpleNamespace(jnp=jnp, life=life, packed=packed, pallas=pallas_packed)


def jax_plan(ref, shape, turns, cap) -> cuda_adaptive.AdaptivePlan:
    """The JAX package's plan for a dispatch, as the port's plan type."""
    pp = ref.pallas
    t, adaptive = pp.adaptive_launch_depth(shape, turns, cap)
    assert adaptive
    return cuda_adaptive.AdaptivePlan(
        t, pp._plan_tile(shape, t, cap), pp._frontier_plan(shape, t, cap) is not None
    )


# (board shape, skip_tile_cap): the JAX package's frontier path (t 18,
# 256-row stripes, one chunk of 8 + a probing tail of 3 + a rem6 skip
# launch + a plain remainder at 211 turns) and its probing-only path (t 6,
# 16-row stripes, no frontier plan).
PATHS = {"frontier": ((2048, 4096), 256), "probing": ((64, 4096), 16)}


def path_turns(ref, path) -> tuple[int, int]:
    (h, w), cap = PATHS[path]
    t, _ = ref.pallas.adaptive_launch_depth((h, w // 32), 211, cap)
    return t * (8 + 3) + 13, cap


@pytest.fixture(scope="module")
def jax_runs(ref):
    """JAX results per (path, board, rule), computed once."""
    cache = {}

    def get(path, kind, rule):
        key = (path, kind, rule)
        if key not in cache:
            (h, w), cap = PATHS[path]
            turns, _ = path_turns(ref, path)
            b = make_board(kind, h, w, jax_plan(ref, (h, w // 32), turns, cap).stripe_h)
            fn = ref.pallas.make_superstep(
                ref.life.RULES[rule], interpret=True, skip_stable=True, skip_tile_cap=cap,
                with_stats=True,
            )
            jb, sk, act = fn(ref.packed.pack(ref.jnp.asarray(b)), turns)
            cache[key] = (b, np.asarray(jb), int(sk), np.asarray(act))
        return cache[key]

    return get


# -- 1. the mirror against the interpret-mode Pallas tier, at the JAX plan ----


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize("path", list(PATHS))
def test_mirror_matches_pallas_at_jax_plan(ref, jax_runs, path, kind, rule):
    (h, w), cap = PATHS[path]
    turns, _ = path_turns(ref, path)
    plan = jax_plan(ref, (h, w // 32), turns, cap)
    assert plan.frontier == (path == "frontier")
    b, jb, jsk, jact = jax_runs(path, kind, rule)
    p = tpacked.pack(torch.from_numpy(b))
    got, sk, act = cuda_adaptive.adaptive_superstep_mirror(p, tlife.RULES[rule], turns, plan)
    np.testing.assert_array_equal(words(got), jb)
    assert int(sk) == jsk
    np.testing.assert_array_equal(act.numpy(), jact)
    assert sk.dtype == act.dtype == torch.int32 and sk.dim() == 0
    if kind != "soup":
        assert jsk > 0  # the boards exercise skipping, not only computing


def test_jax_plans_are_the_stated_ones(ref):
    frontier_turns, _ = path_turns(ref, "frontier")
    probing_turns, _ = path_turns(ref, "probing")
    assert frontier_turns == 211
    assert jax_plan(ref, (2048, 128), 211, 256) == cuda_adaptive.AdaptivePlan(18, 256, True)
    assert jax_plan(ref, (64, 128), probing_turns, 16) == cuda_adaptive.AdaptivePlan(6, 16, False)
    for (shape, cap), turns in [((( 2048, 128), 256), 211), (((64, 128), 16), probing_turns)]:
        plan = jax_plan(ref, shape, turns, cap)
        assert cuda_adaptive.adaptive_tile_launches(shape, turns, cap, plan) == (
            ref.pallas.adaptive_tile_launches(shape, turns, cap)
        )


def test_mirror_matches_pallas_on_a_settled_soup(ref):
    """A soup settling into ash: some stripes prove stable, elide and
    wake again (the probing path)."""
    (h, w), cap = PATHS["probing"]
    turns, _ = path_turns(ref, "probing")
    rng = np.random.default_rng(17)
    soup = np.where(rng.random((h, w)) < 0.3, 255, 0).astype(np.uint8)
    settled = tpacked.superstep(tpacked.pack(torch.from_numpy(soup)), tlife.CONWAY, 2600)
    plan = jax_plan(ref, (h, w // 32), turns, cap)
    got, sk, act = cuda_adaptive.adaptive_superstep_mirror(settled, tlife.CONWAY, turns, plan)
    jb, jsk, jact = ref.pallas.make_superstep(
        ref.life.CONWAY, interpret=True, skip_stable=True, skip_tile_cap=cap, with_stats=True
    )(ref.jnp.asarray(words(settled)), turns)
    np.testing.assert_array_equal(words(got), np.asarray(jb))
    assert int(sk) == int(jsk) > 0
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    assert 0 < int(act.min()) < int(act.max())


def test_plan_vocabulary_matches_the_jax_package(ref):
    pp = ref.pallas
    assert cuda_adaptive.SKIP_PERIOD == pp.SKIP_PERIOD
    assert cuda_adaptive._NLAUNCH_CANON == pp._NLAUNCH_CANON
    assert cuda_adaptive._EMPTY_LO == pp._EMPTY_LO
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 600, 1234):
        assert cuda_adaptive._nlaunch_chunks(n) == pp._nlaunch_chunks(n)
    for t in range(1, 40):
        assert cuda_adaptive.skip_plan(t) == pp.skip_plan(t)
    for name, rule in tlife.RULES.items():
        assert cuda_adaptive.skip_covers_rule(rule) == pp.skip_covers_rule(ref.life.RULES[name])


# -- 2. the CUDA kernels on the card -------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("turns", [6, 12, 18, 24, 30])
def test_gpu_tiled_skip_kernel_matches_plain(cuda_device, rule, turns):
    b = make_board("glider", 200, 4096, 40)
    b[:40] = make_board("soup", 40, 4096, 8)
    p = tpacked.pack(torch.from_numpy(b)).to(cuda_device)
    got = cuda_adaptive.tiled_skip_superstep(p, tlife.RULES[rule], turns)
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_adaptive.tiled_skip_superstep_plain(p, tlife.RULES[rule], turns))


@pytest.mark.gpu
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("kind", BOARDS)
@pytest.mark.parametrize(
    "shape,plan",
    [((2048, 4096), cuda_adaptive.AdaptivePlan(18, 256, True)),
     ((64, 4096), cuda_adaptive.AdaptivePlan(6, 16, False)),
     ((1024, 2048), cuda_adaptive.AdaptivePlan(24, 512, True)),
     ((64, 96), cuda_adaptive.AdaptivePlan(12, 64, True))],
)
def test_gpu_adaptive_kernels_match_mirror(cuda_device, rule, kind, shape, plan):
    """K4 and K5 (and K3 and K2 in the remainder) against the plain
    versions: board, skip count and activity."""
    b = make_board(kind, *shape, plan.stripe_h)
    p = tpacked.pack(torch.from_numpy(b)).to(cuda_device)
    turns = plan.t * (8 + 3) + 13
    cuda_adaptive.reset_launches()
    got, sk, act = cuda_adaptive.adaptive_superstep(p, tlife.RULES[rule], turns, plan)
    torch.cuda.synchronize()
    full, rem = divmod(turns, plan.t)
    chunks, loose = cuda_adaptive._nlaunch_chunks(full) if plan.frontier else ([], full)
    assert cuda_adaptive.frontier_superstep.launches == sum(chunks)
    assert cuda_adaptive.probing_superstep.launches == loose
    assert cuda_adaptive.tiled_skip_superstep.launches == (rem >= 6)
    want, wsk, wact = cuda_adaptive.adaptive_superstep_mirror(p, tlife.RULES[rule], turns, plan)
    assert torch.equal(got, want)
    assert int(sk) == int(wsk)
    assert torch.equal(act, wact)
