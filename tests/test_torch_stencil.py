"""The byte stencil kernel of the port (``ops/cuda_stencil.py``, K6) against
the JAX package's Pallas kernel (``ops/pallas_stencil.py``).

On the CPU the wrapper runs the plain version (K6's own formulation:
whole-word SWAR sums and rule over the kernel's runs of rows), which is
held bit for bit against ``_stencil_kernel`` run in interpret mode under
every rule of ``models/life.RULES``, on shapes the TPU gate refuses
through a periodic tiling that it takes, with its counts against the TPU
package's; the Backend's viewer dispatches on the ``pallas`` engine, whose
count K6 gives, are held to the JAX Backend's.  Tests marked ``gpu`` hold
the CUDA kernel and its count against its plain version on the card and
skip where there is none.  The JAX package is imported inside the tests that compare
with it, so the ``gpu`` tests also run on a machine without JAX:
``python -m pytest tests/test_torch_stencil.py -m gpu --noconftest``."""

import queue
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_stencil, stencil as tstencil

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)


def random_board(rng: np.random.Generator, h: int, w: int, p: float = 0.3) -> np.ndarray:
    return np.where(rng.random((h, w)) < p, 255, 0).astype(np.uint8)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax.numpy as jnp

    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import pallas_stencil

    return SimpleNamespace(jnp=jnp, life=life, pallas=pallas_stencil)


# -- the plain version against the interpret-mode Pallas kernel ---------------


@pytest.mark.parametrize(
    "shape",
    [(8, 128), (64, 256), (96, 384), (104, 128), (512, 512), (96, 16384)],
    ids=lambda s: f"{s[0]}x{s[1]}",
)
def test_plain_matches_pallas_kernel(ref, shape):
    """(96, 16384) runs the TPU kernel on a grid of three 32-row tiles with
    wrap halos; the others fit one tile."""
    b = random_board(np.random.default_rng(shape[0] + shape[1]), *shape)
    want = ref.pallas.make_step_fn(ref.life.CONWAY, interpret=True)(ref.jnp.asarray(b))
    got = cuda_stencil.stencil_step_plain(torch.from_numpy(b), tlife.CONWAY)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rule", ["highlife", "seeds", "day-and-night"])
def test_plain_matches_pallas_kernel_other_rules(ref, rule):
    b = random_board(np.random.default_rng(5), 64, 128, 0.4)
    step = ref.pallas.make_step_fn(ref.life.RULES[rule], interpret=True)
    want, got = ref.jnp.asarray(b), torch.from_numpy(b)
    for _ in range(4):
        want = step(want)
        got = cuda_stencil.stencil_step_plain(got, tlife.RULES[rule])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# Shapes beside the TPU gate's: one row, odd heights, W % 16 != 0 (K6's
# 4-cell instantiation) and W = 4.  The TPU kernel runs them on a periodic
# tiling of the board (``tiled``), whose next generation is the tiling of
# the board's.
ODD_SHAPES = [(1, 4), (3, 20), (7, 36), (1, 48), (5, 12), (9, 100), (40, 96)]


def tiled(b: np.ndarray) -> np.ndarray:
    """``b`` repeated to the smallest board the TPU kernel takes: H a
    multiple of 8, W of 128."""
    h, w = b.shape
    return np.tile(b, (np.lcm(h, 8) // h, np.lcm(w, 128) // w))


@pytest.mark.parametrize("rule", list(tlife.RULES))
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_matches_pallas_kernel_on_every_rule_and_odd_shape(ref, rule, shape):
    """The plain version's words, SWAR sums and rule (the compiled-in
    B3/S23 and B36/S23 compares and the per-byte masks of the rest) give
    the interpret-mode TPU kernel's generation, and its count the TPU
    count, over three generations."""
    b = random_board(np.random.default_rng(shape[0] * 131 + shape[1]), *shape, p=0.4)
    h, w = shape
    step = ref.pallas.make_step_fn(ref.life.RULES[rule], interpret=True)
    want, got = ref.jnp.asarray(tiled(b)), torch.from_numpy(b)
    for _ in range(3):
        want = step(want)
        count = torch.zeros((), dtype=torch.int64)
        got = cuda_stencil.stencil_step_plain(got, tlife.RULES[rule], count)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:h, :w])
        assert int(count) * want.size // (h * w) == int(np.sum(np.asarray(want) & 1))


@pytest.mark.parametrize("run", [1, 3, 8, 32])
def test_plain_version_is_the_same_over_any_run(ref, run):
    """The run a warp walks splits the work only: every run height gives
    the TPU kernel's board and count, the ragged last run included."""
    b = random_board(np.random.default_rng(run), 40, 128)
    want = np.asarray(ref.pallas.make_step_fn(ref.life.CONWAY, interpret=True)(ref.jnp.asarray(b)))
    count = torch.zeros((), dtype=torch.int64)
    got = cuda_stencil.stencil_step_plain(torch.from_numpy(b), tlife.CONWAY, count, run=run)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(count) == int(np.sum(want & 1))


@pytest.mark.parametrize("rule", list(tlife.RULES))
@pytest.mark.parametrize("shape", [(8, 128), (3, 20), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_counts_match_pallas_counts(ref, rule, shape):
    """``make_steps_with_counts`` (each launch's own count) and the counted
    superstep (the last launch's) against the TPU package's per-turn
    counts of ``make_steps_with_counts``, 6 generations, on the board or
    its tiling (its counts divided by the tiles)."""
    b = random_board(np.random.default_rng(len(rule) + shape[1]), *shape, p=0.35)
    jb, jc = ref.pallas.make_steps_with_counts(ref.life.RULES[rule], interpret=True)(
        ref.jnp.asarray(tiled(b)), 6)
    tiles = tiled(b).size // b.size
    tb, tc = cuda_stencil.make_steps_with_counts(tlife.RULES[rule])(torch.from_numpy(b), 6)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb)[: shape[0], : shape[1]])
    np.testing.assert_array_equal(tc.numpy() * tiles, np.asarray(jc))
    sb, sc = cuda_stencil.make_counted_superstep(tlife.RULES[rule])(torch.from_numpy(b), 6)
    assert torch.equal(sb, tb) and int(sc) * tiles == int(np.asarray(jc)[-1])
    zb, zc = cuda_stencil.make_counted_superstep(tlife.RULES[rule])(torch.from_numpy(b), 0)
    assert torch.equal(zb, torch.from_numpy(b)) and int(zc) == int(np.sum(b & 1))


def test_steps_with_counts_match_pallas(ref):
    b = random_board(np.random.default_rng(11), 128, 128)
    jb, jc = ref.pallas.make_steps_with_counts(ref.life.CONWAY, interpret=True)(
        ref.jnp.asarray(b), 20
    )
    tb, tc = cuda_stencil.make_steps_with_counts(tlife.CONWAY)(torch.from_numpy(b), 20)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_superstep_matches_pallas_superstep(ref):
    b = random_board(np.random.default_rng(12), 64, 256)
    want = ref.pallas.make_superstep(ref.life.HIGHLIFE, interpret=True)(ref.jnp.asarray(b), 9)
    got = cuda_stencil.make_superstep(tlife.HIGHLIFE)(torch.from_numpy(b), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gliders_cross_the_seams():
    """Gliders crossing both wraps of a 512x128 torus, 600 generations,
    against the port's roll stencil (no JAX needed)."""
    b = np.zeros((512, 128), np.uint8)
    glider = np.array([[0, 255, 0], [0, 0, 255], [255, 255, 255]], np.uint8)
    for y, x in [(0, 0), (509, 60), (250, 125), (100, 30)]:
        rows = (np.arange(3) + y) % 512
        cols = (np.arange(3) + x) % 128
        b[np.ix_(rows, cols)] = glider
    table = tstencil.rule_table(tlife.CONWAY, "cpu")
    got = cuda_stencil.make_superstep(tlife.CONWAY)(torch.from_numpy(b), 600)
    want = tstencil.superstep(torch.from_numpy(b), table, 600)
    assert torch.equal(got, want)
    assert int((got != 0).sum()) == 4 * 5


def test_gate_takes_every_pallas_shape(ref):
    """Every shape the TPU runs its kernel on runs K6 on the card, so the
    two packages report the same engine wherever the TPU runs it."""
    hits = 0
    for h in (1, 7, 8, 16, 24, 40, 64, 96, 104, 512, 1000, 4096, 16384):
        for w in (4, 96, 128, 256, 384, 1024, 4096, 16384):
            if ref.pallas.supports((h, w)):
                hits += 1
                assert cuda_stencil.supports((h, w)), (h, w)
    assert hits > 20


@pytest.mark.parametrize(
    "shape,ok",
    [((512, 512), True), ((1, 4), True), ((3, 100), True), ((1004, 3076), True),
     ((64, 2), False), ((64, 6), False), ((64, 130), False), ((32 * 65536, 126), False),
     ((32 * 65536, 128), True)],
)
def test_gate(shape, ok):
    """W % 4 == 0 and any H: K6's grid is one dimension of (run, column
    group) warps, so no row count is too tall."""
    assert cuda_stencil.supports(shape) == ok


def test_cpu_wrapper_runs_plain_version_without_counting():
    cuda_stencil.reset_launches()
    b = torch.from_numpy(random_board(np.random.default_rng(2), 40, 96))
    got = cuda_stencil.stencil_step(b, tlife.CONWAY)
    assert torch.equal(got, cuda_stencil.stencil_step_plain(b, tlife.CONWAY))
    out = torch.empty_like(b)
    assert cuda_stencil.stencil_step(b, tlife.CONWAY, out=out) is out
    assert torch.equal(out, got)
    cuda_stencil.make_superstep(tlife.CONWAY)(b, 5)
    assert cuda_stencil.stencil_step.launches == 0


def test_superstep_never_writes_its_input():
    b = torch.from_numpy(random_board(np.random.default_rng(3), 64, 64))
    before = b.clone()
    fn = cuda_stencil.make_superstep(tlife.CONWAY)
    one, five = fn(b, 1), fn(b, 5)
    assert torch.equal(b, before)
    assert torch.equal(five, cuda_stencil.make_superstep(tlife.CONWAY)(one, 4))
    assert torch.equal(fn(b, 0), b)


def test_wrapper_rejects_bad_boards():
    with pytest.raises(ValueError):
        cuda_stencil.stencil_step(torch.zeros((4, 4), dtype=torch.int32), tlife.CONWAY)
    b = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_stencil.stencil_step(b, tlife.CONWAY, out=b)


@pytest.fixture()
def viewer_backends(tmp_path):
    """The JAX package's Backend and the port's on the ``pallas`` engine (the
    port's on the CPU: K6's plain version and its count), and a seeded
    96 x 128 soup for each."""
    import jax.numpy as jnp

    import distributed_gol_tpu as jgol
    from distributed_gol_tpu.engine.backend import Backend as JBackend

    import distributed_gol_torch as tgol
    from distributed_gol_torch.engine.backend import Backend as TBackend

    kw = dict(image_height=96, image_width=128, engine="pallas", out_dir=tmp_path)
    b = random_board(np.random.default_rng(9), 96, 128)
    jb, tb = JBackend(jgol.Params(**kw)), TBackend(tgol.Params(device="cpu", **kw))
    assert tb.engine_used == "pallas" and tb._counted is not None
    return jb, tb, jnp.asarray(b), torch.from_numpy(b)


def test_backend_viewer_counts_match_jax(viewer_backends):
    """The viewer dispatches whose count K6 now gives (flips, frames at
    strides 1 and 3, a viewport crossing the wrap) against the JAX
    Backend's at a shared seed: boards, counts and views; the frame probe
    advances nothing."""
    jb, tb, jboard, tboard = viewer_backends
    for _ in range(3):
        jn, jc, jcoords = jb.run_turn_with_flips(jboard)
        tn, tc, tcoords = tb.run_turn_with_flips(tboard)
        assert tc == jc
        np.testing.assert_array_equal(tcoords, jcoords)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jboard, tboard = jn, tn
    for fy, fx, turns in [(1, 1, 1), (5, 7, 3), (96, 128, 1)]:
        jn, jc, jf = jb.run_turn_with_frame(jboard, fy, fx, turns)
        tn, tc, tf = tb.run_turn_with_frame(tboard, fy, fx, turns)
        assert tc == jc
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    rect = (-5, -7, 33, 65)
    jn, jc, jf = jb.run_turn_with_viewport(jboard, rect, 3, 4, 2)
    tn, tc, tf = tb.run_turn_with_viewport(tboard, rect, 3, 4, 2)
    assert tc == jc
    np.testing.assert_array_equal(tf, jf)
    before = tboard.clone()
    assert tb.probe_frame_fetch(tboard, 3, 4, rect=rect) is None
    assert tb.probe_frame_fetch(tboard, 5, 7) is None
    assert torch.equal(tboard, before)


def test_viewer_turn_takes_the_count_from_the_stencil(viewer_backends, monkeypatch):
    """On the pallas engine a viewer turn and the frame probe run no
    separate sum of the board: ``stencil.alive_count`` is never called."""
    _, tb, _, tboard = viewer_backends

    def no_sum(board):
        raise AssertionError("a viewer turn on the pallas engine summed the board")

    monkeypatch.setattr(tstencil, "alive_count", no_sum)
    _, count, _ = tb.run_turn_with_frame(tboard, 4, 4, 2)
    tb.run_turn_with_flips(tboard)
    tb.run_turn_with_viewport(tboard, (0, 0, 32, 32), 2, 2)
    tb.probe_frame_fetch(tboard, 4, 4)
    want = cuda_stencil.make_superstep(tlife.CONWAY)(tboard, 2)
    assert count == int((want & 1).sum())


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (4, 8), (9, 13), (2, 129), (7, 512)])
def test_packbits_matches_numpy(shape):
    x = random_board(np.random.default_rng(shape[1]), *shape, p=0.5)
    got = tstencil.packbits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.packbits(x != 0, axis=-1))
    np.testing.assert_array_equal(
        np.unpackbits(got, axis=-1, count=shape[1]) * np.uint8(255), x
    )


# -- the CUDA kernel on the card -----------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["conway", "highlife"])
@pytest.mark.parametrize("turns", [1, 8])
@pytest.mark.parametrize("shape", [(512, 512), (16384, 16384)], ids=["512", "16384"])
def test_gpu_stencil_kernel_matches_plain(cuda_device, rule, turns, shape):
    b = torch.from_numpy(random_board(np.random.default_rng(turns), *shape)).to(cuda_device)
    before = b.clone()
    launches = cuda_stencil.stencil_step.launches
    got = cuda_stencil.make_superstep(tlife.RULES[rule])(b, turns)
    torch.cuda.synchronize()
    assert cuda_stencil.stencil_step.launches == launches + turns
    want = b
    for _ in range(turns):
        want = cuda_stencil.stencil_step_plain(want, tlife.RULES[rule])
    assert torch.equal(got, want)
    assert torch.equal(b, before)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
@pytest.mark.parametrize("shape", [(1004, 3076), (1, 4), (3, 100), (33, 132), (40, 8), (7, 20),
                                   (1, 16), (130, 4096)])
def test_gpu_stencil_kernel_beyond_the_tpu_gate(cuda_device, rule, shape):
    """Shapes the port's gate adds (any H, W % 4 == 0): one row, ragged
    runs and column groups, boards narrower than one warp, where a warp's
    columns wrap onto themselves, both instantiations (16 and 4 cells a
    thread), and every rule instantiation: boards and each launch's count
    against the plain version."""
    r = tlife.RULES[rule]
    b = torch.from_numpy(random_board(np.random.default_rng(7), *shape)).to(cuda_device)
    got, want = b, b
    for _ in range(6):
        count = torch.zeros((), dtype=torch.int64, device=cuda_device)
        want_count = torch.zeros((), dtype=torch.int64, device=cuda_device)
        got = cuda_stencil.stencil_step(got, r, count=count)
        want = cuda_stencil.stencil_step_plain(want, r, want_count)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert int(count) == int(want_count) == int((want & 1).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 512), (64, 1024)])
def test_gpu_stencil_counts_and_the_narrow_instantiation(cuda_device, shape):
    """K6's counts through ``make_steps_with_counts`` and the counted
    superstep against the plain version, and a board that starts 4 bytes
    past a 16-byte boundary, which takes the 4-cell instantiation."""
    h, w = shape
    b = torch.from_numpy(random_board(np.random.default_rng(h), h, w)).to(cuda_device)
    tb, tc = cuda_stencil.make_steps_with_counts(tlife.CONWAY)(b, 5)
    sb, sc = cuda_stencil.make_counted_superstep(tlife.CONWAY)(b, 5)
    want = b
    for i in range(5):
        want = cuda_stencil.stencil_step_plain(want, tlife.CONWAY)
        assert int(tc[i]) == int((want & 1).sum())
    assert torch.equal(tb, want) and torch.equal(sb, want) and int(sc) == int(tc[-1])
    flat = torch.zeros(h * w + 4, dtype=torch.uint8, device=cuda_device)
    shifted = flat[4:].view(h, w)
    shifted.copy_(b)
    assert cuda_stencil.words_per_thread(shifted) == 1 and cuda_stencil.words_per_thread(b) == 4
    count = torch.zeros((), dtype=torch.int64, device=cuda_device)
    got = cuda_stencil.stencil_step(shifted, tlife.HIGHLIFE, count=count)
    want = cuda_stencil.stencil_step_plain(b, tlife.HIGHLIFE)
    assert torch.equal(got, want) and int(count) == int((want & 1).sum())


@pytest.mark.gpu
def test_gpu_flips_run_takes_the_stencil_kernel(cuda_device, tmp_path):
    """``gol.run`` with a viewer attached at 512²: ``auto`` resolves to
    the byte kernel, which launches once per generation, and the stream's
    flips rebuild the final board."""
    import distributed_gol_torch as gol

    params = gol.Params(turns=20, image_width=512, image_height=512, no_vis=False,
                        soup_density=0.3, soup_seed=7, out_dir=tmp_path, ticker_period=3600)
    cuda_stencil.reset_launches()
    events: queue.Queue = queue.Queue()
    gol.run(params, events)
    shadow = np.zeros((512, 512), np.uint8)
    engine = final = None
    while (e := events.get(timeout=60)) is not None:
        if isinstance(e, gol.CellFlipped):
            shadow[e.cell.y, e.cell.x] ^= 1
        elif isinstance(e, gol.MetricsReport):
            engine = e.snapshot["info"]["backend.engine"]
        elif isinstance(e, gol.FinalTurnComplete):
            final = e
    assert engine == "pallas"
    assert cuda_stencil.stencil_step.launches == 20
    want = np.zeros_like(shadow)
    for c in final.alive:
        want[c.y, c.x] = 1
    np.testing.assert_array_equal(shadow, want)
