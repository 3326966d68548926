"""K1, the resident kernel of the port (``ops/cuda_packed.py``,
``csrc/resident.cu``), against the JAX package's ``_vmem_kernel``, and
K7, the same kernel with a board axis, against ``_vmem_kernel_batched``.

On the CPU the wrapper runs its plain version, and the block mirror
(``resident_superstep_mirror``) replays the CUDA kernel's decomposition:
the column runs with their halo lanes, the sub-runs a warp holds, the CTAs
of the cluster and the exchange of edge columns and carries every
generation.  Both are held bit for bit against
``distributed_gol_tpu.ops.pallas_packed._build_vmem_resident`` in
interpret mode.  K7's batched mirror (each board through K1's block mirror
on the batched plan) is held to ``_build_vmem_resident_batched`` the same
way.  The plans' choices for each shape and stack, and their refusals,
are tested here too; the tests marked ``gpu`` hold the kernels against
their plain versions and mirrors on the card.

The JAX package is imported inside the tests that compare with it:
``python -m pytest tests/test_torch_resident.py -m gpu --noconftest``
runs the card's test on a machine without JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import cuda_adaptive, cuda_packed, packed as tpacked

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

RULES = ["conway", "highlife", "day-and-night"]
# (H, W) in cells: one word row 32 and 96 wide, three word rows (no run
# height divides it evenly at the plan's run), 64², a tall narrow board,
# 512² (the main path's).
SHAPES = [(32, 32), (32, 96), (96, 64), (64, 64), (1280, 32), (512, 512)]


def random_board(shape, seed: int) -> np.ndarray:
    return np.where(np.random.default_rng(seed).random(shape) < 0.3, 255, 0).astype(np.uint8)


def vwords(b: np.ndarray) -> torch.Tensor:
    return tpacked.pack_vertical(torch.from_numpy(b))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (the reference)."""
    import jax.numpy as jnp

    from distributed_gol_tpu.models import life
    from distributed_gol_tpu.ops import packed, pallas_packed

    return SimpleNamespace(jnp=jnp, life=life, packed=packed, pallas=pallas_packed)


@pytest.mark.parametrize("turns", [1, 9, 50])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shape", SHAPES)
def test_mirror_and_plain_match_interpret_vmem_kernel(ref, shape, rule, turns):
    """The block mirror at the plan's choice and the plain version give the
    JAX resident kernel's vertical words."""
    b = random_board(shape, shape[0] + shape[1] + turns)
    v = vwords(b)
    jv = ref.pallas._build_vmem_resident(tuple(v.shape), ref.life.RULES[rule], turns, True)(
        ref.packed.pack_vertical(ref.jnp.asarray(b)))
    want = np.asarray(jv)
    plain = cuda_packed.resident_superstep(v, tlife.RULES[rule], turns)
    mirror = cuda_packed.resident_superstep_mirror(v, tlife.RULES[rule], turns)
    np.testing.assert_array_equal(plain.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(mirror.numpy().view(np.uint32), want)


def forced(shape, h_run, rh, vs, cluster):
    """The plan of ``h_run``-register sub-runs of ``rh`` rows, ``vs`` a
    warp, over ``cluster`` CTAs, for a packed (hw, w) board."""
    hw, w = shape
    groups = -(-w // cuda_packed.RESIDENT_GROUP)
    warps = -(-groups * -(-hw // rh) // vs)
    return cuda_packed.ResidentPlan(shape, h_run, rh, vs, -(-warps // cluster), cluster)


@pytest.mark.parametrize("cells,h_run,rh,vs,cluster", [
    ((512, 512), 8, 5, 1, 5),     # runs of 5, 5, 5 and 1 rows: the ragged form
    ((512, 512), 8, 8, 1, 8),     # a cluster of 8, two runs of 8 rows a column
    ((512, 512), 8, 4, 2, 3),     # two 4-row sub-runs a warp over 3 CTAs
    ((512, 512), 2, 2, 16, 1),    # sixteen 2-row sub-runs a warp
    ((96, 1024), 8, 3, 1, 4),     # 3 word rows in 8 registers, ragged
    ((96, 1024), 8, 2, 4, 2),     # runs of 2 rows and one of 1
    ((32, 96), 2, 1, 3, 1),       # one word row, three groups in one warp
    ((32, 4096), 8, 1, 4, 5),     # one word row, wide
    ((1280, 32), 8, 7, 1, 2),     # 40 word rows: five runs of 7 and a ragged one of 5
    ((1280, 32), 8, 8, 2, 3),
    ((64, 64), 2, 1, 2, 2),       # two runs of one row a column
])
def test_mirror_with_forced_plans_matches_plain(cells, h_run, rh, vs, cluster):
    """Every instantiation, ragged and whole runs, several sub-runs a warp
    and clusters of 1 to 8 CTAs: the mirror equals the plain version under
    each rule."""
    v = vwords(random_board(cells, cells[0] * 7 + h_run))
    plan = forced(tuple(v.shape), h_run, rh, vs, cluster)
    for rule in (tlife.CONWAY, tlife.HIGHLIFE, tlife.DAY_AND_NIGHT):
        want = cuda_packed.resident_superstep_plain(v, rule, 13)
        assert torch.equal(cuda_packed.resident_superstep_mirror(v, rule, 13, plan), want)


@pytest.mark.parametrize("cells", [(512, 512), (32, 32), (32, 96), (32, 58112), (32 * 1816, 32),
                                   (96, 19360), (1024, 1792), (64, 64)])
def test_plan_takes_every_board_the_gate_takes(cells):
    """The plan covers the board with at most 16 warps a CTA and 16 CTAs,
    no CTA empty, at the gate's extremes too (one word row 58,112 columns
    wide, 1,816 word rows of 32 columns); 512² spreads over a cluster of
    several CTAs."""
    hw, w = cells[0] // 32, cells[1]
    assert cuda_packed.resident_shape(*cells) == (hw, w)
    plan = cuda_packed.resident_reg_plan(hw, w)
    assert plan.shape == (hw, w)
    assert plan.wpc <= 16 and plan.cluster <= 16
    assert plan.cluster * plan.spc >= plan.nsub > (plan.cluster - 1) * plan.spc
    assert plan.groups * cuda_packed.RESIDENT_GROUP >= w and plan.runs * plan.rh >= hw
    assert plan.smem_bytes <= cuda_packed.SMEM_BYTES
    assert plan.ragged == (plan.rh != plan.h_run or hw % plan.rh != 0)
    if cells == (512, 512):
        assert plan.cluster > 1
    assert plan == min(cuda_packed.resident_reg_candidates(hw, w),
                       key=lambda p: (p.cost(), p.cluster, p.wpc * p.cluster))


def test_plan_refuses_boards_outside_the_gate_and_bad_plans():
    with pytest.raises(ValueError, match="does not fit"):
        cuda_packed.resident_reg_plan(1817, 32)
    with pytest.raises(ValueError, match="does not fit"):
        cuda_packed.resident_reg_plan(1, 58144)
    for args in [((16, 512), 8, 8, 1, 17, 3),   # 17 warps a CTA
                 ((16, 512), 8, 8, 1, 5, 9),    # the ninth CTA holds nothing
                 ((16, 512), 8, 8, 5, 1, 8),    # 5 sub-runs of 8 registers
                 ((16, 512), 8, 16, 1, 5, 8),   # runs taller than the registers
                 ((16, 512), 4, 4, 1, 9, 4)]:   # no such instantiation
        with pytest.raises(ValueError, match="invalid resident plan"):
            cuda_packed.ResidentPlan(*args)
    with pytest.raises(ValueError, match="not for a"):
        cuda_packed.resident_superstep_mirror(torch.zeros((2, 64), dtype=torch.int32),
                                              tlife.CONWAY, 1, forced((16, 512), 8, 8, 1, 8))


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    v = vwords(random_board((64, 64), 1))
    before = cuda_packed.resident_superstep.launches
    got = cuda_packed.resident_superstep(v, tlife.CONWAY, 7)
    assert torch.equal(got, cuda_packed.resident_superstep_plain(v, tlife.CONWAY, 7))
    assert cuda_packed.resident_superstep.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("cells", [(512, 512), (32, 32), (32, 96), (96, 64), (1280, 32),
                                   (32, 58112), (32 * 1816, 32)])
def test_gpu_k1_matches_plain_and_mirror(cells):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    v = vwords(random_board(cells, 5)).cuda()
    for rule in (tlife.CONWAY, tlife.HIGHLIFE, tlife.DAY_AND_NIGHT):
        want = cuda_packed.resident_superstep_plain(v, rule, 9)
        assert torch.equal(cuda_packed.resident_superstep(v, rule, 9), want)
        assert torch.equal(cuda_packed.resident_superstep_mirror(v, rule, 9), want)


# -- K7: the batched form --------------------------------------------------------


def vstack(nb, cells, seed):
    return torch.stack([vwords(random_board(cells, seed + i)) for i in range(nb)])


@pytest.mark.parametrize("rule", ["conway", "day-and-night"])
@pytest.mark.parametrize("nb,cells", [(16, (512, 512)), (3, (1024, 1792)), (1, (512, 512))])
def test_batched_mirror_matches_interpret_vmem_kernel_batched(ref, rule, nb, cells):
    """K7's mirror at the batched plan (one CTA an SM of an H100) and its
    plain version give the JAX batched resident kernel's words: the serving
    pod's 16 x 512², the gate's edge 3 x 1024 x 1792, one board."""
    v = vstack(nb, cells, nb + cells[1])
    jv = ref.pallas._build_vmem_resident_batched(nb, tuple(v.shape[1:]), ref.life.RULES[rule], 9,
                                                 True)(ref.jnp.asarray(v.numpy().view(np.uint32)))
    want = np.asarray(jv)
    r = tlife.RULES[rule]
    plain = cuda_packed.resident_superstep_batched(v, r, 9)
    mirror = cuda_packed.resident_superstep_batched_mirror(v, r, 9)
    np.testing.assert_array_equal(plain.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(mirror.numpy().view(np.uint32), want)


def test_batched_plan_takes_every_stack_at_512():
    """Every B from 1 to 132 at 512² with a pinned active-cluster count
    (two clusters a GPC of 16 SMs, 8 GPCs, a 128-CTA card): a valid plan
    of the candidates, the least batched cost; one board takes K1's plan;
    16 boards fit one wave of clusters of 8; 132 take smaller clusters."""
    active = lambda p: 8 * (16 // p.cluster)  # noqa: E731
    candidates = cuda_packed.resident_reg_candidates(16, 512)
    for nb in range(1, 133):
        plan = cuda_packed.resident_batched_plan(nb, 16, 512, active, 132)
        assert plan in candidates and plan.shape == (16, 512)
        best = min(cuda_packed.resident_batched_cost(p, nb, active(p), 132)
                   for p in candidates if active(p) >= 1)
        assert cuda_packed.resident_batched_cost(plan, nb, active(plan), 132) == best
        if nb == 1:
            assert plan == cuda_packed.resident_reg_plan(16, 512)
        if nb == 16:
            assert plan.cluster == 8 and -(-nb // active(plan)) == 1
    assert plan.cluster < 8


def test_batched_plan_prices_the_waves_and_refuses_what_the_card_cannot_hold():
    plan = cuda_packed.resident_reg_plan(16, 512)
    one = cuda_packed.resident_batched_cost(plan, 1, 16, 132)
    assert cuda_packed.resident_batched_cost(plan, 16, 16, 132) == one
    assert cuda_packed.resident_batched_cost(plan, 17, 16, 132) > 2 * one - 1
    # Clusters that share SMs pay for it: 40 clusters of 8 on 132 SMs.
    assert cuda_packed.resident_batched_cost(plan, 40, 40, 132) > 2 * one
    with pytest.raises(ValueError, match="no cluster"):
        cuda_packed.resident_batched_plan(4, 16, 512, lambda p: 0)
    with pytest.raises(ValueError, match="does not fit"):
        cuda_packed.resident_batched_plan(4, 1817, 32)


def test_batched_mirror_takes_a_forced_plan_and_each_board_is_its_own_torus():
    """Forced plans of several CTAs and of one, on a stack whose boards
    differ: each slot equals K1's plain version on that board alone."""
    v = vstack(3, (96, 1024), 4)
    for plan in (forced((3, 1024), 8, 3, 1, 4), forced((3, 1024), 2, 1, 8, 1)):
        got = cuda_packed.resident_superstep_batched_mirror(v, tlife.HIGHLIFE, 13, plan)
        for i in range(3):
            want = cuda_packed.resident_superstep_plain(v[i], tlife.HIGHLIFE, 13)
            assert torch.equal(got[i], want)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,cells", [(16, (512, 512)), (3, (1024, 1792)), (1, (512, 512)),
                                      (132, (512, 512)), (2, (64, 96))])
def test_gpu_k7_matches_plain_mirror_and_k1(nb, cells):
    """K7 on the card's plan against its plain version, its batched mirror
    at that plan and, slot 0, a lone K1 launch, under each instantiation's
    rule; each launch counted in its rule's instantiation."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    v = vstack(nb, cells, 7).cuda()
    for rule in (tlife.CONWAY, tlife.HIGHLIFE, tlife.DAY_AND_NIGHT):
        cuda_packed.reset_launches()
        got = cuda_packed.resident_superstep_batched(v, rule, 9)
        plan = cuda_packed.card_batched_plan(v, rule)
        assert torch.equal(got, cuda_packed.resident_superstep_batched_plain(v, rule, 9))
        assert torch.equal(got, cuda_packed.resident_superstep_batched_mirror(v, rule, 9, plan))
        assert torch.equal(got[0], cuda_packed.resident_superstep(v[0].contiguous(), rule, 9))
        variant = cuda_adaptive.REG_RULES[cuda_adaptive.reg_rule(rule)[2]]
        assert cuda_packed.resident_superstep_batched.rules == {variant: 1}
        assert cuda_packed.card_active_clusters(v.device, rule)(plan) >= 1
