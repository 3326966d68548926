"""Peak device memory of the flagship board's runs on one CUDA card, for
any checkout of the port.

Runs legs of ``chip_smoke.py``'s path (t) on a seeded 65536² soup (density
0.3) through the checkout's own ``gol.run``, each in a process of its own,
so that an out-of-memory error ends only its leg:

- ``t1``: x 2,000 on one device, ``auto`` with ``skip_stable`` off (K2);
- ``t5``: the same supervised: superstep 500, an SDC check every 500
  turns, a checkpoint every 1,000, ``restart_limit=1``, one injected
  corrupt.

A leg prints one JSON line: its peak ``torch.cuda.max_memory_allocated()``
(reset just before the run), ``torch.cuda.mem_get_info()``'s total, its
seconds, and the error that ended it, if one did.  Nothing is checked
against a reference: ``chip_smoke.py`` does that.  The soup is written
once, as the legs' input PGM, into a temporary directory beside the
checkout, and removed at the end.

    python3 tools/flagship_memory.py [--root CHECKOUT] [--legs t1,t5] [--side 65536]

``--root`` (default: the checkout this file is in) is the directory whose
``distributed_gol_torch`` runs, so a parent checkout unpacked beside this
one is measured by the same legs.  It needs a CUDA card; it imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import queue
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
LEGS = ("t1", "t5")
TURNS, SDC_EVERY, CKPT_EVERY = 2_000, 500, 1_000


def child(leg: str, root: Path, images: Path, tmp: Path, side: int) -> dict:
    """One leg in this process, on ``root``'s package."""
    sys.path.insert(0, str(root))
    import torch

    import distributed_gol_torch as gol
    from distributed_gol_torch.engine.backend import Backend
    from distributed_gol_torch.engine.session import Session
    from distributed_gol_torch.testing.faults import Fault, FaultInjectionBackend, FaultPlan

    params = gol.Params(turns=TURNS, image_width=side, image_height=side, images_dir=images,
                        skip_stable=False, turn_events="batch", ticker_period=3600,
                        out_dir=tmp / leg)
    kw = {}
    if leg == "t5":
        import dataclasses

        params = dataclasses.replace(params, superstep=SDC_EVERY, restart_limit=1,
                                     checkpoint_every_turns=CKPT_EVERY,
                                     sdc_check_every_turns=SDC_EVERY)
        harness = FaultInjectionBackend(Backend(params),
                                        FaultPlan([Fault(2, "corrupt", cells=3)]))
        kw = dict(session=Session(tmp / f"{leg}_ckpt"),
                  backend_factory=lambda p, a: harness if a == 0 else harness.rebind(Backend(p)))
    torch.cuda.reset_peak_memory_stats()
    events: queue.Queue = queue.Queue()
    t0, error = time.perf_counter(), None
    try:
        gol.run(params, events, **kw)
    except Exception as e:  # noqa: BLE001 — reported, an OOM above all
        error = f"{type(e).__name__}: {str(e)[:300]}"
    seconds = time.perf_counter() - t0
    return dict(leg=leg, root=str(root), side=side, error=error, seconds=round(seconds, 3),
                peak_allocated_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
                card_total_gib=round(torch.cuda.mem_get_info()[1] / 2**30, 3),
                card=torch.cuda.get_device_name(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--side", type=int, default=65536)
    ap.add_argument("--child", choices=LEGS)
    ap.add_argument("--images", type=Path)
    ap.add_argument("--tmp", type=Path)
    args = ap.parse_args(argv)
    root = args.root.resolve()
    if args.child:
        print(json.dumps(child(args.child, root, args.images, args.tmp, args.side)), flush=True)
        return 0
    sys.path.insert(0, str(root))
    from distributed_gol_torch.engine import pgm
    from distributed_gol_torch.utils.soup import random_soup

    rows = []
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        pgm.write_pgm(tmp / "images" / f"{args.side}x{args.side}.pgm",
                      random_soup(args.side, args.side, 0.3, 7))
        print(f"soup written in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        for leg in args.legs.split(","):
            out = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child", leg, "--root",
                 str(root), "--images", str(tmp / "images"), "--tmp", str(tmp),
                 "--side", str(args.side)],
                capture_output=True, text=True, check=False)
            lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
            row = json.loads(lines[-1]) if lines else dict(
                leg=leg, root=str(root), error=f"exit {out.returncode}: {out.stderr[-500:]}")
            print(json.dumps(row), flush=True)
            rows.append(row)
    print(json.dumps({"flagship_memory": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
