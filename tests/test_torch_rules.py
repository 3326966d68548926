"""The port's rule data and its import isolation.

The PyTorch port (``distributed_gol_torch``) must carry the JAX package's
rule zoo exactly, and must never import ``jax`` or ``distributed_gol_tpu``
(neither its modules nor ``chip_smoke.py``)."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_gol_torch.models import life as tlife
from distributed_gol_tpu.models import life as jlife

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_gol_torch"
NOTATIONS = ["B3/S23", "B36/S23", "B2/S", "B3678/S34678", "B3/S012345678", "B1357/S1357", "B/S"]


@pytest.mark.parametrize("name", sorted(jlife.RULES))
def test_zoo_rule_tables_and_ash_periods(name):
    j, t = jlife.RULES[name], tlife.RULES[name]
    np.testing.assert_array_equal(t.table, j.table)
    assert (t.birth, t.survive, t.notation, t.ash_period) == (
        j.birth,
        j.survive,
        j.notation,
        j.ash_period,
    )


@pytest.mark.parametrize("spec", NOTATIONS + ["conway", " HighLife "])
def test_parse_rule_matches(spec):
    j, t = jlife.parse_rule(spec), tlife.parse_rule(spec)
    np.testing.assert_array_equal(t.table, j.table)
    assert (t.notation, t.ash_period, t.name) == (j.notation, j.ash_period, j.name)


def test_parse_rule_rejects_like_reference():
    for mod in (jlife, tlife):
        with pytest.raises(ValueError):
            mod.parse_rule("nonsense")


def test_every_module_imports_with_jax_blocked():
    """In a fresh interpreter where ``import jax`` fails, every module of
    the port imports."""
    mods = sorted(
        "distributed_gol_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['distributed_gol_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_reference_import(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "distributed_gol_tpu"), (path, name)
