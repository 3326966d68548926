"""The port's public surface against the JAX package's: the ``serve``
CLI's flags and the ``ServeConfig`` they build, and the public names of
every paired module.

A name the port does not have yet is listed below with the ROADMAP item
that brings it; any other missing name is a fault.  The functions added
to close such faults (``ops.stencil.make_step_fn``,
``ops.packed.steps_with_counts`` and ``make_steps_with_counts``) are held
to the JAX functions on a seeded board."""

import dataclasses
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import distributed_gol_torch as tgol
import distributed_gol_tpu as jgol

# One intra-op thread: the suite runs in parallel worker processes.
torch.set_num_threads(1)

# Names of the JAX package the port does not serve yet, by module, each
# with its ROADMAP item (the refusals name the same items).
NOT_YET = {
    # Dropped on purpose: a jax NamedSharding has no counterpart.
    "parallel.packed_halo": {"packed_sharding": "none"},
}


def public(mod) -> set:
    """``__all__``, else the functions and classes the module defines."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, o in vars(mod).items()
            if not n.startswith("_") and (inspect.isfunction(o) or inspect.isclass(o))
            and o.__module__ == mod.__name__}


def paired_modules() -> list:
    """Every module of the port whose name the JAX package also has."""
    names = [""] + [m.name.split(".", 1)[1]
                    for m in pkgutil.walk_packages(tgol.__path__, "distributed_gol_torch.")]
    return [n for n in names
            if importlib.util.find_spec("distributed_gol_tpu" + (f".{n}" if n else "")) is not None]


@pytest.mark.parametrize("name", paired_modules())
def test_paired_modules_have_the_reference_names(name):
    suffix = f".{name}" if name else ""
    ours = importlib.import_module("distributed_gol_torch" + suffix)
    ref = importlib.import_module("distributed_gol_tpu" + suffix)
    missing = public(ref) - public(ours) - set(NOT_YET.get(name, {}))
    assert not missing, f"distributed_gol_torch{suffix} lacks {sorted(missing)}"
    assert not set(NOT_YET.get(name, {})) & public(ours), "a listed name is ported: unlist it"


def test_new_functions_compute_what_the_reference_computes():
    import jax.numpy as jnp

    from distributed_gol_torch.models import life as tlife
    from distributed_gol_torch.ops import packed as tpacked, stencil as tstencil
    from distributed_gol_tpu.models import life as jlife
    from distributed_gol_tpu.ops import packed as jpacked, stencil as jstencil

    b = np.where(np.random.default_rng(5).random((48, 96)) < 0.3, 255, 0).astype(np.uint8)
    for rule in ("conway", "highlife"):
        tr, jr = tlife.RULES[rule], jlife.RULES[rule]
        got = tstencil.make_step_fn(tr)(torch.from_numpy(b))
        assert np.array_equal(got.numpy(), np.asarray(jstencil.make_step_fn(jr)(jnp.asarray(b))))
        tb, tc = tpacked.make_steps_with_counts(tr)(torch.from_numpy(b), 9)
        jb, jc = jpacked.make_steps_with_counts(jr)(jnp.asarray(b), 9)
        assert np.array_equal(tb.numpy(), np.asarray(jb))
        assert tc.dtype == torch.int32 and np.array_equal(tc.numpy(), np.asarray(jc))
        tp, tcounts = tpacked.steps_with_counts(tpacked.pack(torch.from_numpy(b)), tr, 5)
        jp, jcounts = jpacked.steps_with_counts(jpacked.pack(jnp.asarray(b)), jr, 5)
        assert np.array_equal(tp.numpy().view(np.uint32), np.asarray(jp))
        assert np.array_equal(tcounts.numpy(), np.asarray(jcounts))
    empty = tpacked.steps_with_counts(tpacked.pack(torch.from_numpy(b)), tlife.CONWAY, 0)[1]
    assert empty.shape == (0,) and empty.dtype == torch.int32
    assert tgol.GracefulStop is importlib.import_module(
        "distributed_gol_torch.engine.supervisor").GracefulStop


# -- the serve CLI's flags -------------------------------------------------------


class _Built(Exception):
    """Raised by the stand-in ServePlane: the config is built."""


def serve_config(monkeypatch, pkg, argv):
    """The ``ServeConfig`` that ``pkg``'s ``serve`` builds from ``argv``:
    its ServePlane is replaced by one that records the config and stops
    the pod before it starts."""
    main = importlib.import_module(f"{pkg.__name__}.__main__")
    serve = importlib.import_module(f"{pkg.__name__}.serve")
    seen = []

    def plane(config, **kw):
        seen.append(config)
        raise _Built

    monkeypatch.setattr(serve, "ServePlane", plane)
    if pkg is tgol:
        monkeypatch.setattr(main, "resolve_device", lambda device: torch.device("cpu"))
    with pytest.raises(_Built):
        main.serve_main([*argv, "--tenant", "a:64x64x10"])
    return seen[0]


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["--wire-read-timeout", "5", "--wire-body-cap", "4096", "--wire-max-connections", "3",
         "--ws-keepalive", "2.5", "--ws-max-frame", "1024", "--gateway-host", "0.0.0.0"],
        ["--wire-read-timeout", "0", "--batched", "--max-sessions", "2"],
    ],
    ids=["defaults", "every-wire-flag", "off"],
)
def test_serve_flags_build_the_reference_config(monkeypatch, argv):
    from distributed_gol_torch.__main__ import build_serve_parser as tparser
    from distributed_gol_tpu.__main__ import build_serve_parser as jparser

    theirs = dataclasses.asdict(serve_config(monkeypatch, jgol, argv))
    ours = dataclasses.asdict(serve_config(monkeypatch, tgol, argv))
    assert ours == theirs
    targs, jargs = tparser().parse_args(argv), jparser().parse_args(argv)
    assert targs.gateway_host == jargs.gateway_host


@pytest.mark.parametrize(
    "argv",
    [["--wire-read-timeout", "-1"], ["--wire-body-cap", "0"], ["--wire-max-connections", "-2"],
     ["--ws-keepalive", "-0.5"], ["--ws-max-frame", "0"]],
)
def test_serve_flags_reject_what_the_reference_rejects(capsys, argv):
    from distributed_gol_torch.__main__ import serve_main as tmain
    from distributed_gol_tpu.__main__ import serve_main as jmain

    errors = []
    for main in (jmain, tmain):
        with pytest.raises(SystemExit) as e:
            main([*argv, "--tenant", "a:64x64x10"])
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errors[0] == errors[1]
