#!/usr/bin/env python
"""Time ``distributed.process_group.gather``, the one collective of the
SPMD training steps, in worlds of 2 and 4 processes spawned on this host:
per message size, gloo moving the buffer in one message and in pieces of
0.5 to 8 MiB issued together (``process_group.GLOO_PIECE``). On the card
the ranks share cuda:0 (gloo, staged through pinned host memory); with
``--device cpu`` they run on the CPU. Prints the median of 5 calls in ms
for each (world, MiB, piece), then the card's name and power limit.

  PYTHONPATH=src python scripts/spmd_gather_bench.py [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.distributed import process_group as pg  # noqa: E402

SIZES_MIB = (1, 8, 32)
PIECES_MIB = (None, 0.5, 2, 8)     # None: one message


def _timed(sizes, pieces) -> dict:
    dev = pg.device()
    out = {}
    for mib in sizes:
        x = torch.zeros(int(mib * 2**20), dtype=torch.uint8, device=dev)
        for piece in pieces:
            pg.GLOO_PIECE = int(piece * 2**20) if piece else x.numel()
            times = []
            for _ in range(5):
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                dist.barrier()
                t = time.perf_counter()
                pg.gather(x, pg.WORLD)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            out[(mib, piece)] = statistics.median(times)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu', or the card by default")
    args = ap.parse_args(argv)
    for world in (2, 4):
        got = pg.spawn(_timed, world, SIZES_MIB, PIECES_MIB, device=args.device)[0]
        for (mib, piece), ms in got.items():
            print(f"world {world} {mib} MiB piece "
                  f"{'whole' if piece is None else f'{piece} MiB'}: {ms:.2f} ms")
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())


if __name__ == "__main__":
    main()
