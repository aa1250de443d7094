"""Time the build of the port's CUDA sources as ops/_build.py runs it: one
``nvcc`` process a source, all started together, with the package's flags.

It prints each source's wall seconds (the build's time is the slowest's,
its long pole) and a JSON line of them. ``--csrc`` points it at another
tree's sources (say, a parent commit unpacked with ``git archive``), so that
two trees are timed in one call on one host.

    python3 tools/build_times.py [--csrc DIR] [--label NAME]

Needs ``nvcc`` (the CUDA toolkit); the libraries go to a temporary directory
and are removed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def time_sources(csrc: pathlib.Path) -> dict:
    """{source stem: nvcc wall seconds} for every ``csrc/*.cu``, all
    started at once; raises if one fails."""
    from or_gym_inventory_torch.ops import _build
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        jobs = {}
        for src in sorted(csrc.glob("*.cu")):
            log = open(f"{out}/{src.stem}.log", "w")   # ptxas -v's lines, off the pipe
            jobs[src.stem] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{out}/lib{src.stem}.so", str(src)],
                stdout=log, stderr=subprocess.STDOUT), log)
        done, seconds = set(), {}
        while len(done) < len(jobs):
            for stem, (proc, log) in jobs.items():
                if stem not in done and proc.poll() is not None:
                    seconds[stem] = time.perf_counter() - t0
                    done.add(stem)
                    log.close()
                    if proc.returncode != 0:
                        text = pathlib.Path(f"{out}/{stem}.log").read_text()
                        raise RuntimeError(f"nvcc failed for {stem}.cu:\n{text}")
            time.sleep(0.05)
    return seconds


def main() -> int:
    from or_gym_inventory_torch.ops import _build
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=pathlib.Path, default=_build.CSRC)
    ap.add_argument("--label", default="package")
    args = ap.parse_args()
    seconds = time_sources(args.csrc)
    pole = max(seconds, key=seconds.get)
    print(f"nvcc ({args.label}, {len(seconds)} sources at once): " + ", ".join(
        f"{k}.cu {v:.1f} s" for k, v in sorted(seconds.items(), key=lambda kv: -kv[1]))
        + f"; long pole {pole}.cu {seconds[pole]:.1f} s", flush=True)
    print(json.dumps({"label": args.label, "nvcc_s": seconds, "long_pole": pole}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
