"""The port's command line against the JAX package's."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["-w", "64", "-h", "64", "-turns", "100", "-noVis", "--soup", "0.3", "--soup-seed", "7"]


def cli(pkg, *args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", pkg, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=180,
    )


def test_cli_pgm_matches_jax_cli(tmp_path):
    t = cli("distributed_gol_torch", *ARGS, "--device", "cpu", "--out-dir", "t", cwd=tmp_path)
    j = cli("distributed_gol_tpu", *ARGS, "--out-dir", "j", cwd=tmp_path)
    assert t.returncode == 0, t.stderr
    assert j.returncode == 0, j.stderr
    name = "64x64x100.pgm"
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert t.stdout.splitlines()[-1] == j.stdout.splitlines()[-1]


def test_cli_without_gpu_names_it_and_fails(tmp_path):
    import torch

    if torch.cuda.is_available():
        return  # the card is there: nothing to refuse
    r = cli("distributed_gol_torch", *ARGS, "--out-dir", "t", cwd=tmp_path)
    assert r.returncode != 0
    assert "no CUDA GPU" in r.stderr
    assert not (tmp_path / "t").exists()


def test_cli_refuses_unported_flags(tmp_path):
    r = cli("distributed_gol_torch", *ARGS, "--device", "cpu", "--num-processes", "2",
            cwd=tmp_path)
    assert r.returncode == 2
    assert "ROADMAP A8" in r.stderr


def test_cli_mesh_pgm_matches_jax_cli(tmp_path):
    t = cli("distributed_gol_torch", *ARGS, "--device", "cpu", "--mesh", "2x2",
            "--out-dir", "t", cwd=tmp_path)
    j = cli("distributed_gol_tpu", *ARGS, "--mesh", "2x2", "--out-dir", "j", cwd=tmp_path)
    assert t.returncode == 0, t.stderr
    assert j.returncode == 0, j.stderr
    name = "64x64x100.pgm"
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert t.stdout.splitlines()[-1] == j.stdout.splitlines()[-1]
