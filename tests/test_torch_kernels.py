"""The packed kernel tier of the port (``ops/cuda_packed.py``) against the
JAX package's Pallas kernels.

On the CPU the kernel wrappers run their plain versions, and K2's block
mirror (``tiled_reg_mirror``) replays the CUDA kernel's decomposition:
its register-resident blocks, runs and light cone, and its load of the
torus in place; both are held bit for bit against
``distributed_gol_tpu.ops.pallas_packed`` run in interpret mode.  Tests
marked ``gpu`` hold each CUDA kernel against its plain version and its
mirror on the card and skip where there is none.

The JAX package is imported inside the tests that compare with it, so the
``gpu`` tests also run on a machine without JAX:
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive, cuda_packed, packed as tpacked

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

RULES = ["conway", "highlife"]
# Every instantiation of the register-resident kernels: B3/S23 and B36/S23
# compiled in, Day & Night by its masks (regwin.cuh::by_rule).
REG_RULES = ["conway", "highlife", "day-and-night"]


def random_board(rng: np.random.Generator, h: int, w: int, p: float = 0.3) -> np.ndarray:
    return np.where(rng.random((h, w)) < p, 255, 0).astype(np.uint8)


def words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax.numpy as jnp

    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import packed, pallas_packed

    return SimpleNamespace(jnp=jnp, life=life, packed=packed, pallas=pallas_packed)


# -- the bytes driver against the interpret-mode Pallas driver ---------------


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize(
    "shape,turns",
    [
        ((512, 512), 30),  # resident on both: _vmem_kernel vs K1
        ((64, 4096), 20),  # JAX _kernel, full launches + remainder (K1 here)
        ((64, 4096), 50),
        ((72, 4096), 50),  # tiled on both: _kernel vs K2
    ],
)
def test_superstep_bytes_matches_pallas(ref, rule, shape, turns):
    b = random_board(np.random.default_rng(turns + shape[0]), *shape)
    want = ref.pallas.make_superstep_bytes(ref.life.RULES[rule], interpret=True)(
        ref.jnp.asarray(b), turns
    )
    got = cuda_packed.make_superstep_bytes(tlife.RULES[rule], device="cpu")(b, turns)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_superstep_bytes_zero_turns_is_identity():
    b = random_board(np.random.default_rng(1), 64, 64)
    got = cuda_packed.make_superstep_bytes(device="cpu")(b, 0)
    np.testing.assert_array_equal(got.numpy(), b)


def test_resident_plain_matches_vmem_kernel(ref):
    """K1's plain version on vertical words == the JAX resident kernel's
    vertical words (the layout K1 takes)."""
    b = random_board(np.random.default_rng(9), 256, 128)
    jv = ref.pallas._build_vmem_resident((8, 128), ref.life.HIGHLIFE, 17, True)(
        ref.packed.pack_vertical(ref.jnp.asarray(b))
    )
    tv = cuda_packed.resident_superstep(
        tpacked.pack_vertical(torch.from_numpy(b)), tlife.HIGHLIFE, 17
    )
    np.testing.assert_array_equal(words(tv), np.asarray(jv))


# -- the K2 block mirror ---------------------------------------------------------


def forced(shape, t, tile_h, warps):
    """K2's blocks of ``tile_h`` rows and ``warps`` warps for a
    ``t``-generation launch on a packed (h, wp) board: ceil(t / 32) border
    words a side."""
    border = -(-t // 32)
    grid = (-(-shape[0] // tile_h), -(-shape[1] // (32 - 2 * border)))
    return cuda_adaptive.RegPlan(t, t, tile_h, warps, grid, border)


@pytest.fixture(scope="module")
def tiled_board():
    return random_board(np.random.default_rng(2024), 64, 4096)


@pytest.fixture(scope="module")
def pallas_tiled_runs(ref, tiled_board):
    """JAX ``_kernel`` (interpret) results for each turn count, computed
    once: turns -> packed uint32 words."""
    cache = {}

    def get(turns):
        if turns not in cache:
            p = ref.packed.pack(ref.jnp.asarray(tiled_board))
            cache[turns] = np.asarray(
                ref.pallas.make_superstep(ref.life.CONWAY, interpret=True)(p, turns)
            )
        return cache[turns]

    return get


@pytest.mark.parametrize(
    "t,tile_h,warps",
    [
        (1, 8, 1), (1, 30, 1),
        (6, 16, 1), (6, 40, 2),
        (12, 8, 1),
        (31, 24, 3), (32, 64, 4),
        (33, 16, 3), (48, 30, 5),
        (64, 40, 6),
    ],
)
def test_tiled_mirror_matches_pallas_forced_plans(tiled_board, pallas_tiled_runs, t, tile_h, warps):
    """Blocks of one and several warps, ragged last row tiles (64 rows in
    tiles of 30, 40, 24 and 48), the last column group ragged (128 words in
    groups of 30 or 28), T across the one-word border (32 vs 33) up to the
    plan's other depth (64, two border words), and a remainder launch
    (turns = 2T + 3) of its own border."""
    turns = 2 * t + 3
    p = tpacked.pack(torch.from_numpy(tiled_board))
    plan = forced(tuple(p.shape), t, tile_h, warps)
    got = cuda_packed.tiled_reg_mirror(p, tlife.CONWAY, turns, plan)
    np.testing.assert_array_equal(words(got), pallas_tiled_runs(turns))


@pytest.mark.parametrize("shape", [(16, 96), (1, 32), (3, 64), (72, 4096), (2, 96), (33, 32)])
def test_tiled_mirror_small_and_degenerate_boards(ref, shape):
    """Boards shorter than their halo (and the degenerate 1-, 2- and 3-row
    tori) and narrower than a warp's window, with the real plan: the
    torus load's periodic cover, and each word stored once."""
    b = random_board(np.random.default_rng(shape[0]), *shape)
    p = tpacked.pack(torch.from_numpy(b))
    turns = 45
    got = cuda_packed.tiled_reg_mirror(p, tlife.HIGHLIFE, turns)
    want = ref.packed.superstep(ref.packed.pack(ref.jnp.asarray(b)), ref.life.HIGHLIFE, turns)
    np.testing.assert_array_equal(words(got), np.asarray(want))


@pytest.mark.parametrize("rule", REG_RULES)
@pytest.mark.parametrize("shape,turns", [((64, 128), 37), ((1004, 3072), 75), ((5, 96), 70),
                                         ((40, 1024), 1)])
def test_tiled_mirror_matches_plain_under_every_rule(rule, shape, turns):
    """The mirror at the plan's choice equals the plain version under each
    instantiation's rule: 32 + 5 generations on 64 x 128 cells' words
    (4 x 128 words' tiles), 32 + 32 + 11 on the odd board, a 5-row torus
    over two launches and a remainder, one generation."""
    p = tpacked.pack(torch.from_numpy(random_board(np.random.default_rng(turns), *shape)))
    r = tlife.RULES[rule]
    assert torch.equal(cuda_packed.tiled_reg_mirror(p, r, turns),
                       cuda_packed.tiled_superstep_plain(p, r, turns))


def test_tiled_plan_rejects_short_halo():
    """A register window of one border word a side holds at most 32
    generations (K2's and K3's blocks), and K3's plan only multiples of 6."""
    with pytest.raises(ValueError):
        cuda_adaptive.RegPlan(33, 33, 16, 4, (1, 1), 1)
    with pytest.raises(ValueError):
        cuda_adaptive.tiled_skip_reg_plan((16384, 512), 32, 132)


def test_tiled_reg_mirror_refuses_blocks_that_do_not_cover_the_board():
    p = torch.zeros((64, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not cover"):
        cuda_packed.tiled_reg_mirror(p, tlife.CONWAY, 6, forced((32, 128), 6, 16, 2))
    with pytest.raises(ValueError, match="invalid register plan"):
        forced((64, 128), 33, 16, 2)  # 82 window rows in 2 warps


# -- gates and launch plan (pure Python) ---------------------------------------


@pytest.mark.parametrize(
    "shape,kernel",
    [
        ((512, 512), "resident"),
        ((64, 4096), "resident"),  # 32 KB of words: fits one block
        ((1024, 1024), "resident"),  # 128 KB
        ((1024, 1792), "resident"),  # 224 KB, the largest square-ish fit
        ((1024, 2048), "tiled"),  # 256 KB > 227 KB
        ((3072, 3072), "tiled"),  # in the TPU's resident envelope, not here
        ((16384, 16384), "tiled"),
        ((1004, 3072), "tiled"),  # H % 32 != 0
        ((72, 4096), "tiled"),
        ((1, 32), "tiled"),
        ((16, 16), None),  # W % 32 != 0: no packed words, roll runs it
        ((64, 48), None),
    ],
)
def test_gate_routes_shapes(shape, kernel):
    assert cuda_packed.kernel_for(shape) == kernel


def test_every_pallas_supported_shape_has_a_kernel(ref):
    """No board that runs a Pallas kernel on the TPU runs plain PyTorch on
    the card."""
    for h in (8, 64, 256, 512, 1000, 3072, 16384):
        for wp in (1, 2, 4, 128, 256, 512):
            if ref.pallas.supports((h, wp)):
                assert cuda_packed.kernel_for((h, wp * 32)) is not None


def test_tiled_plan_at_the_headline_board():
    """K3's launch at 16384² (24 generations, the skip form): K2's blocks
    with the probe, covering the torus once, one border word a side."""
    plan = cuda_adaptive.tiled_skip_reg_plan((16384, 512), 24, cuda_packed.H100_SMS)
    assert (plan.t, plan.halo, plan.border, plan.probe) == (24, 24, 1, 6)
    assert plan.rows <= plan.warps * 32 <= 512
    ny, nx = plan.grid
    assert ny * plan.tile_h >= 16384 and nx * plan.centre >= 512
    assert (ny - 1) * plan.tile_h < 16384 and (nx - 1) * plan.centre < 512


def test_k3_and_k4_plans_are_unchanged():
    """K3's and K4's register blocks at 16384² on an H100, pinned: K4 one
    256-row stripe a block of 10 warps (T = 24), K3 K2's candidates with
    the probe."""
    plan = cuda_adaptive.adaptive_plan((16384, 512), 10**6)
    assert cuda_adaptive.probing_reg_plan(plan, (16384, 512), 132) == cuda_adaptive.RegPlan(
        24, 24, 256, 10, (64, 18), 1, 6)
    assert cuda_adaptive.tiled_skip_reg_plan((16384, 512), 24, 132) == cuda_adaptive.RegPlan(
        24, 24, 456, 16, (36, 18), 1, 6)


@pytest.mark.parametrize("sms", [132, 114])
def test_tiled_reg_plan_at_the_headline_board(sms):
    """K2's full launch at 16384²: T = 32, K9's blocks of at most 16 warps
    covering the torus once, and a grid filling ``sms`` SMs in at least
    one full wave.  T = 64's two border words and 128 halo rows cost more
    a generation."""
    from distributed_gol_torch.parallel.cuda_halo import ext_reg_plan

    plan = cuda_packed.tiled_reg_plan((16384, 512), 10**6, sms)
    assert plan == ext_reg_plan((16384, 512), 32, sms)
    assert (plan.t, plan.halo, plan.border, plan.probe) == (32, 32, 1, 0)
    assert plan.warps <= 16 and plan.rows <= plan.warps * 32
    ny, nx = plan.grid
    assert ny * plan.tile_h >= 16384 and (ny - 1) * plan.tile_h < 16384
    assert nx * plan.centre >= 512 and (nx - 1) * plan.centre < 512
    assert plan.blocks >= sms and plan.fill(sms) > 0.9
    t64 = ext_reg_plan((16384, 512), 64, sms)
    assert t64.cost(sms) / 64 > plan.cost(sms) / 32


@pytest.mark.parametrize("turns,depths", [(1, [1]), (32, [32]), (37, [32, 5]), (100, [32, 32, 32, 4])])
def test_tiled_launch_sequence(turns, depths):
    launches = cuda_packed.tiled_reg_launches((16384, 512), turns)
    assert [p.t for p in launches] == depths
    assert all(p.t == p.halo and p.border == -(-p.t // 32) for p in launches)
    assert all(p.rows <= p.warps * 32 <= 512 for p in launches)


def test_tiled_launch_sequence_keeps_a_forced_plan_and_gives_its_remainder_its_border():
    plan = forced((64, 128), 33, 16, 3)
    first, second, rest = cuda_packed.tiled_reg_launches((64, 128), 69, plan=plan)
    assert first == second == plan
    assert (rest.t, rest.border, rest.tile_h, rest.grid) == (3, 1, 16, (4, 5))


def test_rule_masks():
    assert cuda_packed.rule_masks(tlife.CONWAY) == (1 << 3, (1 << 3) | (1 << 4))
    assert cuda_packed.rule_masks(tlife.SEEDS) == (1 << 2, 0)


def test_cpu_wrappers_run_plain_versions_without_counting():
    cuda_packed.reset_launches()
    b = random_board(np.random.default_rng(4), 64, 64)
    p = tpacked.pack(torch.from_numpy(b))
    got = cuda_packed.tiled_superstep(p, tlife.CONWAY, 40)
    np.testing.assert_array_equal(words(got), words(tpacked.superstep(p, tlife.CONWAY, 40)))
    cuda_packed.resident_superstep(tpacked.pack_vertical(torch.from_numpy(b)), tlife.CONWAY, 3)
    assert cuda_packed.resident_superstep.launches == cuda_packed.tiled_superstep.launches == 0
    assert not cuda_packed.tiled_superstep.rules and not cuda_packed.resident_superstep.rules


def test_wrappers_reject_bad_words():
    with pytest.raises(ValueError):
        cuda_packed.tiled_superstep(torch.zeros((4, 4), dtype=torch.int64), tlife.CONWAY, 1)


@pytest.mark.parametrize(
    "notation,ops",
    [
        ("B3/S23", 12),  # t0, t1, t2 and the centre decide it: 10 + 4 // 2
        ("B36/S23", 12),
        ("B1357/S1357", 5),  # t0 ^ centre: 2 SHF, h0, t0, one LOP3
        ("B/S012345678", 0),  # every cell keeps its state
    ],
)
def test_bound_counts_instructions_per_word(notation, ops):
    """``chip_smoke.py``'s operation bound counts LOP3/SHF instructions."""
    import chip_smoke

    assert chip_smoke.ops_per_word(tlife.parse_rule(notation)) == ops


# -- the CUDA kernels on the card ------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("turns", [1, 6, 100])
def test_gpu_resident_kernel_matches_plain(cuda_device, rule, turns):
    b = random_board(np.random.default_rng(turns), 512, 512)
    v = tpacked.pack_vertical(torch.from_numpy(b)).to(cuda_device)
    before = cuda_packed.resident_superstep.launches
    got = cuda_packed.resident_superstep(v, tlife.RULES[rule], turns)
    torch.cuda.synchronize()
    assert cuda_packed.resident_superstep.launches == before + 1
    want = cuda_packed.resident_superstep_plain(v, tlife.RULES[rule], turns)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", REG_RULES)
@pytest.mark.parametrize(
    "shape,turns",
    [((16384, 16384), 1), ((16384, 16384), 6), ((16384, 16384), 32), ((16384, 16384), 37),
     ((1024, 2048), 1000), ((1004, 3072), 70), ((40, 96), 45), ((1, 32), 9), ((3, 64), 45),
     ((16, 96), 45), ((72, 4096), 45)],
)
def test_gpu_tiled_kernel_matches_plain(cuda_device, rule, shape, turns):
    """K2 against its plain version at 16384² (1, 6, 32 and 37
    generations), 1,000 generations, the odd board and the small and
    degenerate tori, and against its block mirror on the card's blocks
    where the mirror is quick; each launch counted in its rule's
    instantiation."""
    b = random_board(np.random.default_rng(turns + shape[0]), *shape)
    p = tpacked.pack(torch.from_numpy(b)).to(cuda_device)
    r = tlife.RULES[rule]
    cuda_packed.reset_launches()
    got = cuda_packed.tiled_superstep(p, r, turns)
    torch.cuda.synchronize()
    n = len(cuda_packed.tiled_reg_launches(tuple(p.shape), turns,
                                           cuda_adaptive.device_sms(cuda_device)))
    variant = cuda_adaptive.REG_RULES[cuda_adaptive.reg_rule(r)[2]]
    assert cuda_packed.tiled_superstep.rules == {variant: n}
    assert torch.equal(got, tpacked.superstep(p, r, turns))
    if shape[0] * shape[1] <= 2**22:
        sms = cuda_adaptive.device_sms(cuda_device)
        assert torch.equal(got, cuda_packed.tiled_reg_mirror(p, r, turns, sms=sms))


@pytest.mark.gpu
@pytest.mark.parametrize("t,tile_h,warps", [(6, 16, 1), (31, 40, 4), (33, 48, 4), (64, 40, 6)])
def test_gpu_tiled_kernel_forced_plans(cuda_device, t, tile_h, warps):
    b = random_board(np.random.default_rng(t), 200, 4096)
    p = tpacked.pack(torch.from_numpy(b)).to(cuda_device)
    plan = forced(tuple(p.shape), t, tile_h, warps)
    got = cuda_packed.tiled_superstep(p, tlife.CONWAY, 2 * t + 3, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, tpacked.superstep(p, tlife.CONWAY, 2 * t + 3))
    assert torch.equal(got, cuda_packed.tiled_reg_mirror(p, tlife.CONWAY, 2 * t + 3, plan))


@pytest.mark.gpu
def test_gpu_k3_and_k4_keep_their_tilings(cuda_device):
    """K3 and K4 launch on their register blocks for the card's SMs, beside
    K2's, and equal their plain versions and their block mirrors."""
    b = random_board(np.random.default_rng(3), 1024, 4096)
    p = tpacked.pack(torch.from_numpy(b)).to(cuda_device)
    sms = cuda_adaptive.device_sms(cuda_device)
    got = cuda_adaptive.tiled_skip_superstep(p, tlife.CONWAY, 24)
    assert torch.equal(got, cuda_adaptive.tiled_skip_superstep_plain(p, tlife.CONWAY, 24))
    assert torch.equal(got, cuda_adaptive.tiled_skip_reg_mirror(p, tlife.CONWAY, 24, sms=sms))
    plan = cuda_adaptive.adaptive_plan(tuple(p.shape), 10**6)
    out, skipped, act = cuda_adaptive.probing_superstep(p, tlife.CONWAY, plan, 4)
    assert torch.equal(out, tpacked.superstep(p, tlife.CONWAY, 4 * plan.t))
    want = cuda_adaptive.probing_superstep_reg_mirror(p, tlife.CONWAY, plan, 4, sms=sms)
    assert all(torch.equal(a, b) for a, b in zip((out, skipped, act), want))
