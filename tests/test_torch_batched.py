"""The batched engine of the port against the JAX package's: B same-shape
boards per dispatch, each its own torus.

Three layers, each exact against the JAX package on the same seeded
inputs (tolerance 0):

- the plain batched SWAR engine (``ops/packed.py``: ``batched_superstep``,
  ``batched_alive_counts``, ``make_batched_superstep``);
- the batched kernels' plain versions (``ops/cuda_packed.py`` K7,
  ``ops/cuda_adaptive.py`` K8) and the batched dispatch
  (``make_batched_superstep_bytes``, ``run_tiled_batched``) against
  ``pallas_packed``'s leading-axis kernels run in interpret mode, and per
  slot against the JAX package's solo runs; at the JAX package's own plan
  the per-board skip counts and activity agree too;
- ``BatchedBackend``: ``run_turns``, ``run_boards`` with its shared
  counts, ``count`` and ``fetch_viewport``.

Tests marked ``gpu`` hold K7 and K8 against their plain versions on the
card and skip where there is none: ``python -m pytest
tests/test_torch_batched.py -m gpu --noconftest``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.engine.backend import BatchedBackend as TBatched
from distributed_gol_torch.engine.params import Params as TParams
from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive, cuda_packed, packed as tpacked

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

RULES = ["conway", "highlife"]
GLIDER = ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2))  # heads down-right


def words(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def soup(h: int, w: int, seed: int, density: float = 0.3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.where(rng.random((h, w)) < density, 255, 0).astype(np.uint8)


def glider(b: np.ndarray, y: int, x: int) -> None:
    """OR a glider into the torus at (y, x)."""
    h, w = b.shape
    for dy, dx in GLIDER:
        b[(y + dy) % h, (x + dx) % w] = 255


def mixed_stack(nb: int, h: int, w: int) -> np.ndarray:
    """Different content in every slot: a soup, a glider crossing both
    wraps, a dead board, then more soups."""
    slots = []
    for s in range(nb):
        if s % 3 == 1:
            b = np.zeros((h, w), np.uint8)
            glider(b, h - 2, w - 2)
        elif s % 3 == 2:
            b = np.zeros((h, w), np.uint8)
        else:
            b = soup(h, w, 100 + s)
        slots.append(b)
    return np.stack(slots)


def identity_board(h: int, w: int, slot: int) -> np.ndarray:
    """Per-slot content (the JAX package's ``_identity_board`` pattern): a
    mid-board glider with far ash, a small residue cluster, a blinker
    fence — varied by slot so a cross-slot mixup cannot cancel out."""
    b = np.zeros((h, w), dtype=np.uint8)
    if slot % 3 == 0:
        glider(b, h // 3, min(w - 8, w // 2))
        b[h - 30 : h - 28, 200:202] = 255
    elif slot % 3 == 1:
        b[h // 2 : h // 2 + 2, w // 4 : w // 4 + 12 : 4] = 255
    else:
        y = min(h - 48, 2 * h // 3)
        b[y : y + 40 : 6, 100:103] = 255
    return b


def seam_stack(h: int, w: int) -> np.ndarray:
    """The cross-board seam case: board 0 holds gliders crossing its own
    row wrap (and a block of ash), board 1 is dead, board 2 a soup.  A
    kernel that let board 0's edge stripes read board 1's "no activity"
    would skip them and give a wrong board."""
    b0 = np.zeros((h, w), np.uint8)
    glider(b0, h - 3, 100)
    glider(b0, h - 4, 2000)
    b0[h // 2 : h // 2 + 2, 50:52] = 255
    return np.stack([b0, np.zeros((h, w), np.uint8), soup(h, w, 3)])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax.numpy as jnp

    from distributed_gol_tpu.engine import backend
    from distributed_gol_tpu.engine.params import Params
    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import packed, pallas_packed

    return SimpleNamespace(jnp=jnp, life=life, packed=packed, pallas=pallas_packed,
                           backend=backend, Params=Params)


# -- 1. the plain batched SWAR engine --------------------------------------------


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("nb", [1, 3])
def test_batched_superstep_and_counts_match_jax(ref, nb, rule):
    stack = mixed_stack(nb, 64, 128)
    jp = ref.jnp.stack([ref.packed.pack(ref.jnp.asarray(b)) for b in stack])
    tp = tpacked.pack(torch.from_numpy(stack))
    np.testing.assert_array_equal(words(tp), np.asarray(jp))
    got = tpacked.batched_superstep(tp, tlife.RULES[rule], 37)
    want = ref.packed.batched_superstep(jp, ref.life.RULES[rule], 37)
    np.testing.assert_array_equal(words(got), np.asarray(want))
    counts, jcounts = tpacked.batched_alive_counts(got), ref.packed.batched_alive_counts(want)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert str(counts.dtype).removeprefix("torch.") == str(jcounts.dtype)
    for i in range(nb):  # each slot is its own torus
        solo = tpacked.superstep(tp[i], tlife.RULES[rule], 37)
        assert torch.equal(got[i], solo)


@pytest.mark.parametrize("turns", [0, 1, 24])
def test_make_batched_superstep_matches_jax(ref, turns):
    stack = mixed_stack(3, 32, 64)
    out, counts = tpacked.make_batched_superstep(tlife.HIGHLIFE)(torch.from_numpy(stack), turns)
    jout, jcounts = ref.packed.make_batched_superstep(ref.life.HIGHLIFE)(
        ref.jnp.asarray(stack), turns)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_batched_vertical_packing_matches_jax(ref):
    stack = mixed_stack(3, 64, 96)
    v = tpacked.pack_vertical(torch.from_numpy(stack))
    jv = ref.jnp.stack([ref.pallas.pack_vertical(ref.jnp.asarray(b)) for b in stack])
    np.testing.assert_array_equal(words(v), np.asarray(jv))
    np.testing.assert_array_equal(tpacked.unpack_vertical(v).numpy(), stack)
    # The popcount does not depend on the packing.
    assert torch.equal(tpacked.batched_alive_counts(v),
                       tpacked.batched_alive_counts(tpacked.pack(torch.from_numpy(stack))))


# -- 2. K7's plain version and the resident half of the dispatch------------------


@pytest.mark.parametrize("nb", [1, 3])
def test_k7_plain_matches_interpret_mode_kernel_and_solo_runs(ref, nb):
    """512² boards, 9 turns: the port's batched engine (K7's plain version on the
    CPU) against ``make_batched_superstep_bytes`` in interpret mode (the
    leading-axis ``_vmem_kernel_batched``), and per slot against the JAX
    package's solo runs — as ``tests/test_batched.py`` pins the JAX
    kernel."""
    stack = mixed_stack(nb, 512, 512)
    assert cuda_packed.resident_shape(512, 512) is not None
    out, counts = cuda_packed.make_batched_superstep_bytes(tlife.CONWAY, "cpu")(
        torch.from_numpy(stack), 9)
    jout, jcounts = ref.pallas.make_batched_superstep_bytes(ref.life.CONWAY, interpret=True)(
        ref.jnp.asarray(stack), 9)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    solo = ref.pallas.make_superstep_bytes(ref.life.CONWAY, interpret=True)
    for i in range(nb):
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(solo(ref.jnp.asarray(stack[i]), 9)))


@pytest.mark.parametrize("rule", RULES)
def test_k7_plain_is_per_slot_k1_plain(rule):
    stack = tpacked.pack_vertical(torch.from_numpy(mixed_stack(3, 96, 160)))
    got = cuda_packed.resident_superstep_batched(stack, tlife.RULES[rule], 50)
    for i in range(3):
        assert torch.equal(got[i], cuda_packed.resident_superstep_plain(stack[i], tlife.RULES[rule], 50))
    assert cuda_packed.resident_superstep_batched(stack, tlife.CONWAY, 0) is stack


def test_k7_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="contiguous"):
        cuda_packed.resident_superstep_batched(torch.zeros((2, 4), dtype=torch.int32),
                                               tlife.CONWAY, 1)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_packed.resident_superstep_batched(torch.zeros((2, 4, 4), dtype=torch.int64),
                                               tlife.CONWAY, 1)


# -- 3. K8's plain version and the tiled half of the dispatch---------------------


HN, WN, CAP = 1024, 4096, 512  # the narrow shape: wp = 128


def jax_plan(ref, shape, turns, cap) -> cuda_adaptive.AdaptivePlan:
    """The JAX package's plan for a dispatch, as the port's plan type."""
    pp = ref.pallas
    t, adaptive = pp.adaptive_launch_depth(shape, turns, cap)
    assert adaptive
    return cuda_adaptive.AdaptivePlan(
        t, pp._plan_tile(shape, t, cap), pp._frontier_plan(shape, t, cap) is not None)


def mega_turns(ref) -> int:
    """A turn count whose decomposition holds one canonical chunk (8
    launches) at the JAX plan, plus a loose launch and a remainder."""
    plan = jax_plan(ref, (HN, WN // 32), 960, CAP)
    return 9 * plan.t + 5


@pytest.mark.parametrize(
    "kind,nb", [("identity", 1), ("identity", 2), ("identity", 3), ("seam", 2), ("seam", 3)])
def test_k8_plain_matches_interpret_mode_batched_dispatch(ref, nb, kind):
    """``run_tiled_batched`` through K8's plain version against
    ``pallas_packed._run_tiled_batched(..., ip=True)`` (the leading-axis
    frontier megakernel) at the JAX package's plan: the boards and the
    per-board skip counts."""
    if kind == "seam":
        stack = seam_stack(HN, WN)[:nb]
    else:
        stack = np.stack([identity_board(HN, WN, s) for s in range(nb)])
    turns = mega_turns(ref)
    plan = jax_plan(ref, (HN, WN // 32), turns, CAP)
    assert plan.frontier and cuda_adaptive._nlaunch_chunks(turns // plan.t) == ([8], 1)
    tp = tpacked.pack(torch.from_numpy(stack))
    got, sk = cuda_adaptive.run_tiled_batched(tp, tlife.CONWAY, turns, plan)
    jstack = ref.jnp.stack([ref.packed.pack(ref.jnp.asarray(b)) for b in stack])
    jgot, jsk = ref.pallas._run_tiled_batched(jstack, ref.life.CONWAY, turns, True, CAP)
    np.testing.assert_array_equal(words(got), np.asarray(jgot))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))
    assert sk.dtype == torch.int32 and sk.shape == (nb,)
    for i in range(nb):  # and per slot, the JAX package's solo engine
        np.testing.assert_array_equal(
            words(got[i]), np.asarray(ref.packed.superstep(jstack[i], ref.life.CONWAY, turns)))
    if kind == "seam":
        assert int(sk[1]) > int(sk[0])  # the dead board skips, the live one does not


def test_k8_plain_activity_matches_the_jax_kernel(ref):
    """One canonical chunk of the batched megakernel, called directly:
    boards, per-board skip counts and the per-stripe activity vector
    (board b's stripes at b * grid + i), at the JAX package's plan."""
    stack = seam_stack(HN, WN)
    plan = jax_plan(ref, (HN, WN // 32), 960, CAP)
    tp = tpacked.pack(torch.from_numpy(stack))
    got, sk, act = cuda_adaptive.frontier_superstep_batched(tp, tlife.CONWAY, plan, 8)
    call = ref.pallas._build_dispatch_frontier(
        (HN, WN // 32), ref.life.CONWAY, plan.t, 8, True, CAP, nboards=3)
    flat = ref.jnp.concatenate([ref.packed.pack(ref.jnp.asarray(b)) for b in stack])
    na, _nb, jsk, jact = call(flat, ref.jnp.zeros_like(flat))
    np.testing.assert_array_equal(words(got).reshape(3 * HN, -1), np.asarray(na))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    assert act.shape == (3 * plan.grid(HN),)


@pytest.mark.parametrize("rule", RULES)
def test_k8_plain_with_one_board_is_k5_plain(rule):
    stack = seam_stack(256, 1024)
    plan = cuda_adaptive.AdaptivePlan(12, 64, True)
    tp = tpacked.pack(torch.from_numpy(stack))
    got, sk, act = cuda_adaptive.frontier_superstep_batched(tp, tlife.RULES[rule], plan, 8)
    grid = plan.grid(256)
    for i in range(3):
        b, s, a = cuda_adaptive.frontier_superstep_mirror(tp[i], tlife.RULES[rule], plan, 8)
        assert torch.equal(got[i], b) and int(sk[i]) == int(s)
        assert torch.equal(act[i * grid : (i + 1) * grid], a)


@pytest.mark.parametrize("turns", [0, 5, 64, 211, 8 * 24 + 30])
def test_batched_dispatch_at_the_ports_own_plan(turns):
    """``make_batched_superstep_bytes`` on tiled boards at the port's plan
    (T = 24): short dispatches run only the per-slot tail, longer ones a
    K8 chunk first; every slot equals its solo packed run."""
    stack = seam_stack(1024, 2048)
    assert cuda_packed.resident_shape(1024, 2048) is None
    out, counts = cuda_packed.make_batched_superstep_bytes(tlife.CONWAY, "cpu")(
        torch.from_numpy(stack), turns)
    for i in range(3):
        want = tpacked.make_superstep(tlife.CONWAY)(torch.from_numpy(stack[i]), turns)
        assert torch.equal(out[i], want)
        assert int(counts[i]) == int((want & 1).sum())


def test_batched_gate_divergence_from_the_tpu(ref):
    """The port's batched gates are its own (ROADMAP §C): K7 takes every
    board of one block's shared memory, as K1 does, where the TPU's
    resident gate needs H % 256 == 0; so a 64² cohort runs the batched
    kernel here and the plain batched engine on the TPU.  Boards agree."""
    for shape in [(64, 2), (96, 5), (256, 3)]:
        assert cuda_adaptive.batched_supports(shape)
        assert not ref.pallas.batched_supports(shape)
    for shape in [(512, 16), (1024, 128), (4096, 128)]:
        assert cuda_adaptive.batched_supports(shape) == ref.pallas.batched_supports(shape)
    assert not cuda_adaptive.batched_supports((64, 0))
    assert not cuda_adaptive.batched_supports((1004, 3072 // 32))  # H % 8: no stripe
    kw = dict(image_width=64, image_height=64, engine="pallas-packed")
    assert TBatched(TParams(device="cpu", **kw)).engine_used == "pallas-packed"
    assert ref.backend.BatchedBackend(ref.Params(**kw)).engine_used == "packed"


# -- 4. BatchedBackend ------------------------------------------------------------


@pytest.fixture
def backends(ref):
    def make(engine, h=64, w=64, rule="conway"):
        kw = dict(image_width=w, image_height=h, engine=engine)
        tb = TBatched(TParams(device="cpu", rule=tlife.RULES[rule], **kw))
        jb = ref.backend.BatchedBackend(ref.Params(rule=ref.life.RULES[rule], **kw))
        return tb, jb

    return make


@pytest.mark.parametrize("engine", ["roll", "packed", "pallas-packed", "pallas", "auto"])
def test_batched_backend_run_turns_matches_jax(ref, backends, engine):
    tb, jb = backends(engine, rule="highlife")
    stack = mixed_stack(3, 64, 64)
    got, counts = tb.run_turns(tb.put(stack), 30)
    jgot, jcounts = jb.run_turns(jb.put(stack), 30)
    np.testing.assert_array_equal(tb.fetch(got), np.asarray(jgot))
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(tb.count(got), jb.count(jgot))
    assert tb.engine_used == {"pallas": "packed", "auto": "packed"}.get(engine, engine)
    zero, zc = tb.run_turns(tb.put(stack), 0)
    np.testing.assert_array_equal(tb.fetch(zero), stack)
    np.testing.assert_array_equal(zc, [int((b & 1).sum()) for b in stack])


@pytest.mark.parametrize("engine", ["roll", "packed", "pallas-packed"])
def test_batched_backend_run_boards_matches_jax(ref, backends, engine):
    """``run_boards``: one stack, one dispatch, per-slot views out and one
    count vector shared by the slots' ``int()``s."""
    from distributed_gol_torch.obs import metrics

    tb, jb = backends(engine)
    stack = mixed_stack(3, 64, 64)
    before = metrics.REGISTRY.snapshot()
    outs, counts = tb.run_boards([tb.put(stack[i:i + 1])[0] for i in range(3)], 24)
    after = metrics.REGISTRY.snapshot().delta(before).to_dict()["counters"]
    assert after == {f"backend.batched_dispatches.{tb.engine_used}": 1}
    jouts, jcounts = jb.run_boards([jb.put(stack[i:i + 1])[0] for i in range(3)], 24)
    assert len(outs) == len(counts) == 3
    for o, c, jo, jc in zip(outs, counts, jouts, jcounts):
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
        assert int(c) == int(jc)
    # One shared vector: the first int() fetched every slot's value.
    assert counts[0]._shared is counts[2]._shared and counts[0]._shared._counts is None
    assert outs[0]._base is outs[1]._base  # views of one output stack


def test_batched_backend_fetch_viewport_matches_jax(backends):
    tb, jb = backends("packed", h=64, w=96)
    stack = mixed_stack(3, 64, 96)
    for rect in [(0, 0, 64, 96), (60, 90, 9, 17), (-5, 200, 33, 8)]:
        np.testing.assert_array_equal(tb.fetch_viewport(tb.put(stack), rect),
                                      jb.fetch_viewport(jb.put(stack), rect))
    with pytest.raises(ValueError, match="does not fit"):
        tb.fetch_viewport(tb.put(stack), (0, 0, 65, 8))


def test_batched_backend_is_single_device():
    from distributed_gol_torch.engine.params import Params

    params = Params(device="cpu")
    object.__setattr__(params, "mesh_shape", (2, 1))  # Params refuses meshes itself
    with pytest.raises(NotImplementedError, match="single-device"):
        TBatched(params)


# -- 5. the CUDA kernels on the card ------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shape", [(16, 512, 512), (3, 1024, 1792), (2, 64, 96)])
def test_gpu_k7_matches_plain(cuda_device, rule, shape):
    nb, h, w = shape
    v = tpacked.pack_vertical(torch.from_numpy(mixed_stack(nb, h, w))).to(cuda_device)
    before = cuda_packed.resident_superstep_batched.launches
    got = cuda_packed.resident_superstep_batched(v, tlife.RULES[rule], 64)
    torch.cuda.synchronize()
    assert cuda_packed.resident_superstep_batched.launches == before + 1
    assert torch.equal(got, cuda_packed.resident_superstep_batched_plain(v, tlife.RULES[rule], 64))
    assert torch.equal(got[0], cuda_packed.resident_superstep(v[0].contiguous(), tlife.RULES[rule], 64))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["identity", "seam", "soup", "narrow"])
def test_gpu_k8_matches_plain(cuda_device, kind):
    """K8 over 8 launches against its plain version and its block mirror
    (``frontier_batched_reg_mirror`` at the card's blocks) under B3/S23,
    B36/S23 and Day & Night (the generic instantiation), each rule's
    launches counted in its instantiation; with one board it equals K5.
    "narrow" is the soup 64 cells (2 words, less than one 30-word column
    group) wide."""
    stack = {"identity": np.stack([identity_board(HN, WN, s) for s in range(3)]),
             "seam": seam_stack(HN, WN),
             "soup": np.stack([soup(HN, WN, s) for s in range(3)]),
             "narrow": np.stack([soup(HN, 64, s) for s in range(3)])}[kind]
    tp = tpacked.pack(torch.from_numpy(stack)).to(cuda_device)
    plan = cuda_adaptive.adaptive_plan(tuple(tp.shape[1:]), 10**6)
    sms = cuda_adaptive.device_sms(cuda_device)
    for rule in ("conway", "highlife", "day-and-night"):
        r = tlife.RULES[rule]
        cuda_adaptive.reset_launches()
        got = cuda_adaptive.frontier_superstep_batched(tp, r, plan, 8)
        want = cuda_adaptive.frontier_superstep_batched_mirror(tp, r, plan, 8)
        blocks = cuda_adaptive.frontier_batched_reg_mirror(tp, r, plan, 8, sms)
        torch.cuda.synchronize()
        for g, w, b in zip(got, want, blocks):
            assert torch.equal(g, w) and torch.equal(g, b)
        variant = cuda_adaptive.REG_RULES[cuda_adaptive.reg_rule(r)[2]]
        assert cuda_adaptive.frontier_superstep_batched.rules == {variant: 8}
        one = cuda_adaptive.frontier_superstep_batched(tp[:1].contiguous(), r, plan, 8)
        k5 = cuda_adaptive.frontier_superstep(tp[0].contiguous(), r, plan, 8)
        assert torch.equal(one[0][0], k5[0]) and int(one[1][0]) == int(k5[1])
        assert torch.equal(one[2], k5[2])
