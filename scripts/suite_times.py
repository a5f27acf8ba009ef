"""Per-file times of a pytest-xdist run of the test suite: which files
set the run's end.

As a pytest plugin, on the xdist controller only, it appends one JSON
line per test to the file `$SUITE_TIMES_LOG` when the test's teardown is
reported: the test's id, the wall-clock time and the worker. Load it by
name with `scripts/` on the path, beside the suite's own command:

    SUITE_TIMES_LOG=ends.jsonl PYTEST_PLUGINS=suite_times \\
        PYTHONPATH=scripts python -m pytest tests/ -n 6 --dist loadfile \\
        --junitxml=run.xml ...

As a program it reads the run's junit XML (and that log) and prints the
files with the most testcase seconds, one line each: the test count, the
summed seconds and, with the log, the second after START (a Unix time;
default the first report) at which the file's last test ended, and on
which worker; then the total and each worker's last second.

    python scripts/suite_times.py run.xml [ends.jsonl [START]] [--top N]
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time
import xml.etree.ElementTree as ET


def pytest_runtest_logreport(report):
    node = getattr(report, "node", None)  # set on the controller's copy
    if report.when == "teardown" and node is not None:
        with open(os.environ["SUITE_TIMES_LOG"], "a") as f:
            f.write(json.dumps([report.nodeid, time.time(),
                                node.gateway.id]) + "\n")


def file_of(classname: str) -> str:
    """`tests.test_x` (or `tests.test_x.Class`) -> `test_x`."""
    parts = classname.split(".")
    return parts[1] if parts[0] == "tests" and len(parts) > 1 else parts[0]


def main(argv: list[str]) -> int:
    top = 10
    if "--top" in argv:
        i = argv.index("--top")
        top, argv = int(argv[i + 1]), argv[:i] + argv[i + 2:]
    total, count = collections.Counter(), collections.Counter()
    for tc in ET.parse(argv[0]).getroot().iter("testcase"):
        f = file_of(tc.get("classname", ""))
        total[f] += float(tc.get("time", 0))
        count[f] += 1
    ends, last = {}, {}
    if len(argv) > 1:
        with open(argv[1]) as fh:
            rows = [json.loads(line) for line in fh]
        start = float(argv[2]) if len(argv) > 2 else min(r[1] for r in rows)
        for nodeid, t, worker in rows:
            f = os.path.basename(nodeid.split("::")[0])[:-len(".py")]
            ends[f] = max(ends.get(f, (0.0, worker)), (t - start, worker))
            last[worker] = max(last.get(worker, 0.0), t - start)
    for f, s in total.most_common(top):
        end = (f"  end {ends[f][0]:7.1f} s on {ends[f][1]}"
               if f in ends else "")
        print(f"{f:45s} {count[f]:4d} tests {s:8.1f} s{end}")
    print(f"testcase seconds {sum(total.values()):.1f}")
    if last:
        print("workers' last seconds",
              {w: round(t, 1) for w, t in sorted(last.items())})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
