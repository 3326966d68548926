"""The port's roll stencil and packed SWAR engine against the JAX package.

Same seeded inputs through ``distributed_gol_tpu.ops.{stencil,packed}`` and
``distributed_gol_torch.ops.{stencil,packed}``; every comparison is exact
(tolerance 0: the system is an integer automaton).  Packed words are
compared on their uint32 bit pattern."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_gol_torch.models import life as tlife
from distributed_gol_torch.ops import packed as tpacked
from distributed_gol_torch.ops import stencil as tstencil
from distributed_gol_tpu.models import life as jlife
from distributed_gol_tpu.ops import packed as jpacked
from distributed_gol_tpu.ops import stencil as jstencil
from tests.conftest import random_board

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

RULE_NAMES = ["conway", "highlife", "seeds", "day-and-night", "life-without-death"]


def words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize(
    "shape,turns",
    [((16, 16), 12), ((1, 17), 5), ((2, 33), 7), ((31, 45), 9), ((64, 64), 20),
     ((128, 96), 10), ((512, 512), 6)],
)
def test_stencil_superstep_matches(shape, turns):
    b = random_board(np.random.default_rng(sum(shape) + turns), *shape)
    want = np.asarray(jstencil.superstep(jnp.asarray(b), jnp.asarray(jlife.CONWAY.table), turns))
    table = tstencil.rule_table(tlife.CONWAY, "cpu")
    got = tstencil.superstep(torch.from_numpy(b), table, turns).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_stencil_rule_zoo_with_counts(rule):
    b = random_board(np.random.default_rng(3), 40, 24)
    jb, jc = jstencil.steps_with_counts(jnp.asarray(b), jnp.asarray(jlife.RULES[rule].table), 8)
    tb, tc = tstencil.steps_with_counts(
        torch.from_numpy(b), tstencil.rule_table(tlife.RULES[rule], "cpu"), 8
    )
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_stencil_helpers_match():
    rng = np.random.default_rng(11)
    a, b = random_board(rng, 37, 53), random_board(rng, 37, 53)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert int(tstencil.alive_count(ta)) == int(jstencil.alive_count(jnp.asarray(a)))
    np.testing.assert_array_equal(
        tstencil.flip_mask(ta, tb).numpy(), np.asarray(jstencil.flip_mask(jnp.asarray(a), jnp.asarray(b)))
    )
    for fy, fx in [(1, 1), (4, 8), (5, 7)]:
        np.testing.assert_array_equal(
            tstencil.frame_pool(ta, fy, fx).numpy(),
            np.asarray(jstencil.frame_pool(jnp.asarray(a), fy, fx)),
        )
    for y0, x0, vh, vw in [(0, 0, 5, 6), (-3, 50, 10, 20), (36, 52, 37, 53)]:
        np.testing.assert_array_equal(
            tstencil.viewport(ta, y0, x0, vh, vw).numpy(),
            np.asarray(jstencil.viewport(jnp.asarray(a), y0, x0, vh, vw)),
        )


@pytest.mark.parametrize(
    "shape,turns",
    [((1, 32), 9), ((2, 64), 9), ((16, 32), 12), ((33, 96), 10), ((64, 64), 25),
     ((256, 128), 8), ((512, 512), 5)],
)
def test_packed_superstep_matches(shape, turns):
    b = random_board(np.random.default_rng(sum(shape) * 7 + turns), *shape)
    want = np.asarray(jpacked.superstep(jpacked.pack(jnp.asarray(b)), jlife.CONWAY, turns))
    got = tpacked.superstep(tpacked.pack(torch.from_numpy(b)), tlife.CONWAY, turns)
    np.testing.assert_array_equal(words(got), want)


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_packed_rule_zoo(rule):
    b = random_board(np.random.default_rng(5), 48, 64)
    want = np.asarray(jpacked.make_superstep(jlife.RULES[rule])(jnp.asarray(b), 7))
    got = tpacked.make_superstep(tlife.RULES[rule])(torch.from_numpy(b), 7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1, 32), (3, 64), (32, 32), (64, 96), (96, 128)])
def test_pack_unpack_words_identical(shape):
    b = random_board(np.random.default_rng(shape[0]), *shape)
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    tp = tpacked.pack(tb)
    np.testing.assert_array_equal(words(tp), np.asarray(jpacked.pack(jb)))
    np.testing.assert_array_equal(tpacked.unpack(tp).numpy(), b)
    if shape[0] % 32 == 0:
        tv = tpacked.pack_vertical(tb)
        np.testing.assert_array_equal(words(tv), np.asarray(jpacked.pack_vertical(jb)))
        np.testing.assert_array_equal(tpacked.unpack_vertical(tv).numpy(), b)


def test_packed_alive_count_and_high_bits():
    """All-ones words (bit 31 set, negative as int32) pack, count and step
    like the JAX package's uint32 words."""
    b = np.full((32, 64), 255, np.uint8)
    b[5, 7] = 0
    tp = tpacked.pack(torch.from_numpy(b))
    assert int(tpacked.alive_count(tp)) == int(jpacked.alive_count(jpacked.pack(jnp.asarray(b))))
    want = np.asarray(jpacked.superstep(jpacked.pack(jnp.asarray(b)), jlife.LIFE_WITHOUT_DEATH, 3))
    np.testing.assert_array_equal(words(tpacked.superstep(tp, tlife.LIFE_WITHOUT_DEATH, 3)), want)


def test_pack_rejects_ragged():
    with pytest.raises(ValueError):
        tpacked.pack(torch.zeros((4, 33), dtype=torch.uint8))
    with pytest.raises(ValueError):
        tpacked.pack_vertical(torch.zeros((33, 32), dtype=torch.uint8))


def test_carry_round_trips_reference_state():
    from distributed_gol_torch import carry

    b = random_board(np.random.default_rng(8), 64, 96)
    jw = np.asarray(jpacked.pack(jnp.asarray(b)))
    tw = carry.packed_from_reference(jw)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tw, tpacked.pack(torch.from_numpy(b)))
    np.testing.assert_array_equal(carry.packed_to_reference(tw), jw)
    np.testing.assert_array_equal(carry.board_to_device(np.asarray(jnp.asarray(b)), "cpu").numpy(), b)
    for name in RULE_NAMES:
        j = jlife.RULES[name]
        assert carry.rule_from_reference(j.notation).table.tolist() == j.table.tolist()
