"""Count the SASS instructions of the loops of K1-K4, K6, K7, K9, K10, K11 and K13.

    python3 tools/sass_loop_count.py [--sass-dir DIR]

Builds the port's ``resident``, ``tiled``, ``tiled_skip``, ``ext``,
``probing`` and ``stencil`` kernels (``ops/cuda_build.py``), disassembles
them with ``cuobjdump -sass`` (the CUDA toolkit's, beside ``nvcc``) and
prints one JSON object: for the B3/S23 instantiations of K9
(``ext_reg_kernel``), K2 (``tiled_reg_kernel``, its loop K9's on the
torus), K3 (``tiled_skip_reg_kernel``), K10 (``ext_skip_reg_kernel``), K13
(``tile_probing_reg_kernel``), K11 (``strip_probing_reg_kernel``) and K4
(``board_probing_reg_kernel``), their generation loop (the backward
branch whose body holds the generation's ``BAR.SYNC``: one generation of a 32-row
run, every chunk stepped; K3's, K4's, K10's, K11's and K13's first, the 6
generations before their probe); for K1 and K7 (``resident_reg_kernel``, one kernel
with a board axis) each B3/S23
instantiation's generation loop (one generation of every sub-run a warp
holds: 32 rows of registers, the exchange included; a row is one word of
each of the warp's 32 lanes, 30 of them centre); for K6
(``stencil_kernel``) each B3/S23 instantiation's row loop (the largest
backward branch: ``kAhead`` rows of a thread's column of 16 or 4 cells,
the loads, stores and the count included) and, for the first port's K6,
the whole kernel (4 rows of 4 cells a thread, the shared-memory staging
included); and for the shared-memory forms of K2, K3, K4, K10 and K11 that
came before (``tiled_kernel``, ``tiled_skip_kernel``, ``probing_kernel``,
``ext_skip_kernel``, ``strip_probing_kernel``: ``window.cuh::advance``),
where a build has them, their row loop (the innermost backward branch
whose body reads and writes shared memory: a window row).  Each loop's
static instruction count, its count per row (and per cell for K6), and
its opcodes.  The old loops evaluate the rule at run time, each total's
term behind a branch on the rule's masks; ``branch_blocks`` lists the
sizes of the blocks their predicated forward branches skip (the terms a
rule does not use, and a bounds test), so a rule's path through them is
shorter than their static count.  ``--sass-dir`` also writes the
disassembly there.

Run on a machine with the CUDA toolkit (the card's).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_gol_torch.ops import cuda_build  # noqa: E402

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]\s+)?([A-Z0-9_.]+)([^;]*);")
CONWAY = "FixedRuleILj8ELj24E"  # FixedRule<8, 24>: B3/S23's masks
RUN_ROWS = 32
STENCIL_AHEAD = 4  # csrc/stencil.cu::kAhead: the rows of K6's loop body


def functions(sass: str) -> dict:
    """{mangled name: [(address, opcode, operands)]} of a cuobjdump listing;
    a predicated instruction's opcode carries its predicate ("@P0 BRA")."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            out[name] = []
        elif name:
            m = INSTR.search(line)
            if m:
                pred = f"{m.group(2).strip()} " if m.group(2) else ""
                out[name].append((int(m.group(1), 16), pred + m.group(3), m.group(4)))
    return out


def loops(code: list) -> list:
    """[(start, end)] address ranges of every backward branch's body."""
    found = []
    for addr, op, args in code:
        op = op.split()[-1]
        if op.startswith("BRA") and not op.startswith("BRA.DIV"):
            target = int(re.findall(r"0x([0-9a-f]+)", args)[-1], 16)
            if target <= addr:
                found.append((target, addr))
    return found


def body(code: list, span: tuple) -> list:
    return [(a, op, args) for a, op, args in code if span[0] <= a <= span[1]]


def summary(code: list, span: tuple, rows: int) -> dict:
    ins = body(code, span)
    ops = collections.Counter(op.split()[-1].split(".")[0] for _, op, _ in ins)
    return dict(loop=[hex(span[0]), hex(span[1])], static=len(ins), rows=rows,
                per_row=len(ins) / rows, opcodes=dict(ops.most_common()))


def generation_loop(code: list) -> tuple:
    """The first backward branch whose body holds a BAR.SYNC."""
    for span in sorted(loops(code)):
        if any(op.split()[-1].startswith("BAR.SYNC") for _, op, _ in body(code, span)):
            return span
    raise ValueError("no generation loop")


def row_loop(code: list) -> tuple:
    """The smallest backward branch whose body reads (LDS) and writes (STS)
    shared memory and holds no barrier: ``advance``'s row loop, not the
    window's load."""
    def has(span, prefix):
        return any(op.split()[-1].startswith(prefix) for _, op, _ in body(code, span))

    spans = [s for s in loops(code) if has(s, "LDS") and has(s, "STS") and not has(s, "BAR")]
    return min(spans, key=lambda s: s[1] - s[0])


def branch_blocks(code: list, span: tuple) -> list:
    """Sizes of the blocks that predicated forward branches inside a loop
    body skip."""
    ins = body(code, span)
    sizes = []
    for addr, op, args in ins:
        if op.startswith("@") and op.split()[-1] == "BRA":
            target = int(re.findall(r"0x([0-9a-f]+)", args)[-1], 16)
            if addr < target <= span[1]:
                sizes.append(sum(1 for a, _, _ in ins if addr < a < target))
    return sizes


def largest_loop(code: list) -> tuple:
    """The backward branch with the largest body."""
    return max(loops(code), key=lambda s: s[1] - s[0])


def kernel_loops(build, libs, sass_dir: str = "") -> dict:
    """The loops of K1-K4, K6, K7, K9, K10, K11 and K13 in the kernels ``libs`` of the
    build module ``build`` (``ops/cuda_build.py`` of a checkout, built
    already), disassembled with ``cuobjdump -sass``; ``sass_dir`` also
    keeps the disassembly."""
    cuobjdump = str(Path(build.nvcc()).parent / "cuobjdump")
    out = {}
    for lib in libs:
        sass = subprocess.run([cuobjdump, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, check=True).stdout
        if sass_dir:
            Path(sass_dir).mkdir(parents=True, exist_ok=True)
            (Path(sass_dir) / f"{lib}.sass").write_text(sass)
        for name, code in functions(sass).items():
            if CONWAY in name and "ext_reg_kernel" in name:
                out["K9"] = summary(code, generation_loop(code), RUN_ROWS)
            elif CONWAY in name and "tiled_reg_kernel" in name:
                out["K2"] = summary(code, generation_loop(code), RUN_ROWS)
            elif CONWAY in name and "ext_skip_reg_kernel" in name:
                out["K10"] = summary(code, generation_loop(code), RUN_ROWS)
            elif CONWAY in name and "resident_reg_kernel" in name:
                h, ragged = re.search(r"resident_reg_kernelILi(\d+)ELb(\d)E", name).groups()
                out[f"K1_h{h}{'_ragged' if ragged == '1' else ''}"] = summary(
                    code, generation_loop(code), RUN_ROWS)
            elif CONWAY in name and "tiled_skip_reg_kernel" in name:
                out["K3"] = summary(code, generation_loop(code), RUN_ROWS)
            elif CONWAY in name and "probing_reg_kernel" in name:
                key = "K13" if "tile_probing" in name else "K4" if "board_probing" in name else "K11"
                out[key] = summary(code, generation_loop(code), RUN_ROWS)
            elif CONWAY in name and "stencil_kernel" in name:
                words = int(re.search(r"stencil_kernelILi(\d+)E", name).group(1))
                row = summary(code, largest_loop(code), STENCIL_AHEAD)
                row["per_cell"] = row["per_row"] / (4 * words)
                out[f"K6_{4 * words}_cells"] = row
            elif "stencil_kernel" in name and "ByteRule" not in name:
                row = summary(code, (code[0][0], code[-1][0]), 4)
                row["per_cell"] = row["per_row"] / 4
                out["K6"] = row
            elif any(k in name for k in ("ext_skip_kernel", "strip_probing_kernel",
                                         "12tiled_kernel", "17tiled_skip_kernel",
                                         "14probing_kernel")):
                span = row_loop(code)
                row = summary(code, span, 1)
                row["branch_blocks"] = branch_blocks(code, span)
                out[next(k for n, k in (("ext_skip", "K10"), ("strip_probing", "K11"),
                                        ("14probing", "K4"), ("tiled_skip", "K3"),
                                        ("tiled", "K2")) if n in name)] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass-dir", default="")
    args = ap.parse_args()
    libs = ("resident", "tiled", "tiled_skip", "ext", "probing", "stencil")
    cuda_build.build(*libs)
    print(json.dumps(kernel_loops(cuda_build, libs, args.sass_dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
