#!/usr/bin/env python3
"""Replay a test run's per-test times through pytest-xdist's ``--dist
loadfile`` schedule, to see which file sets the wall of a parallel run.

    python3 scripts/tier1_schedule.py JUNIT.xml [--workers 6] [FILE=SCALE ...]

``JUNIT.xml`` is the ``--junitxml`` of a run (each test's time, setup and
teardown included).  The replay follows pytest-xdist 3.8's
``LoadScopeScheduling`` with its default ``--loadscope-reorder``: one unit
per test file, the units sorted by their number of tests (most first,
ties in collection order), one unit to each worker, then a further unit
to a worker whenever two or fewer of its tests are left.  ``FILE=SCALE``
multiplies one file's test times (for example ``test_torch_degree=0.5``)
to ask what a cheaper file would do to the wall.  Prints each worker's
files and finishing time and the wall; the times are the run's own, so
the replay inherits that run's contention.
"""

from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def load(path: str) -> dict[str, list[float]]:
    """Test times per file (module name), in the order the run reported."""
    files: dict[str, list[float]] = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        module = case.get("classname", "").split(".")
        name = module[1] if len(module) > 1 else module[0]
        files.setdefault(name, []).append(float(case.get("time", 0.0)))
    return files


def replay(files: dict[str, list[float]], workers: int) -> tuple[list[float], list[list[str]]]:
    """Each worker's finishing time and files under the loadfile schedule."""
    queue = collections.deque(sorted(sorted(files), key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]
    assigned: list[list[str]] = [[] for _ in range(workers)]

    def assign(w: int) -> None:
        name = queue.popleft()
        assigned[w].append(name)
        pending[w].extend(files[name])

    for w in range(workers):
        if queue:
            assign(w)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            assign(w)
    events = [(pending[w][0], w) for w in range(workers) if pending[w]]
    heapq.heapify(events)
    end = [0.0] * workers
    while events:
        t, w = heapq.heappop(events)
        pending[w].popleft()
        end[w] = t
        if queue and len(pending[w]) <= 2:
            assign(w)
        if pending[w]:
            heapq.heappush(events, (t + pending[w][0], w))
    return end, assigned


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("junit")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("scale", nargs="*", metavar="FILE=SCALE")
    args = ap.parse_args(argv)
    files = load(args.junit)
    for item in args.scale:
        name, factor = item.split("=")
        files[name] = [t * float(factor) for t in files[name]]
    end, assigned = replay(files, args.workers)
    for w, (t, names) in enumerate(zip(end, assigned)):
        print(f"worker {w}: {t:8.1f} s  {', '.join(names)}")
    print(f"wall {max(end):.1f} s; worker time {sum(map(sum, files.values())):.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
