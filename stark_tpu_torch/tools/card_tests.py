"""Run the card test file, `tests/test_torch_cuda.py`, whole, with a stall
watchdog (a card; no JAX).

    python3 -m stark_tpu_torch.tools.card_tests [--stall SECONDS] [--limit SECONDS]
                                                 [pytest -k expression]

One pytest process runs the file (`--noconftest -m cuda -v`, pytest's
`faulthandler_timeout` set to the stall time, so that a test running longer
dumps every thread's stack). If a dump appears, the watchdog waits for it to
be written, ends that process, records the test it stalled in, and starts a
second process on the tests after it (a third after a second stall, and so
on), all within `--limit` seconds. Logs go to `chiprun_out/card_tests/`:
`pytest_<k>.log` per process and `summary.json` (passed, failed and stalled
tests, seconds, the processes' exit codes). Prints one JSON line, the
summary without the test lists."""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "chiprun_out", "card_tests")
FILE = "tests/test_torch_cuda.py"
_RESULT = re.compile(r"^(tests/\S+::\S+) (PASSED|FAILED|ERROR|SKIPPED|XFAIL|XPASS)")
_START = re.compile(r"^(tests/\S+::\S+) ")
_DUMP = re.compile(r"Timeout \(\d+:\d\d:\d\d\)!")


def _pytest(extra, stall):
    return [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
            "-p", "no:cacheprovider", "-o", f"faulthandler_timeout={stall}", *extra]


def collect(k_expr):
    out = subprocess.run(_pytest([FILE, "--collect-only", "-q"] +
                                 (["-k", k_expr] if k_expr else []), 900),
                         cwd=ROOT, capture_output=True, text=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.startswith(FILE + "::")]


def run(stall: int, limit: float, k_expr: str = "") -> dict:
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    todo = collect(k_expr)
    results, stalled, rcs = {}, [], []
    while todo and time.perf_counter() - t0 < limit:
        log_path = os.path.join(OUT, f"pytest_{len(rcs)}.log")
        with open(log_path, "w") as log:
            p = subprocess.Popen(_pytest(["-v"] + todo, stall), cwd=ROOT, stdout=log,
                                 stderr=subprocess.STDOUT, text=True)
            dumped_at = None
            while p.poll() is None:
                time.sleep(5)
                with open(log_path, errors="replace") as f:
                    text = f.read()
                if dumped_at is None and _DUMP.search(text):
                    dumped_at = time.perf_counter()
                late = time.perf_counter() - t0 > limit
                if late or (dumped_at is not None and time.perf_counter() - dumped_at > 30):
                    p.kill()
                    p.wait()
        rcs.append(p.returncode)
        with open(log_path, errors="replace") as f:
            lines = f.read().splitlines()
        started = None
        for ln in lines:
            m = _RESULT.match(ln)
            if m:
                results[m.group(1)] = m.group(2)
                started = None
            elif _START.match(ln) and ln.split()[0] in todo:
                started = ln.split()[0]
        done = [t for t in todo if t in results]
        if started is not None and started not in results:
            # a dump: the test ran past the stall time; else the process
            # ended inside it (a crash, or the limit)
            stalled.append({"test": started, "after": len(results), "log": log_path,
                            "dumped": dumped_at is not None, "rc": p.returncode,
                            "seconds": time.perf_counter() - t0})
            results[started] = "STALLED" if dumped_at is not None else "ENDED"
        rest = [t for t in todo if t not in results]
        if len(rest) == len(todo) or not done and started is None:
            break
        todo = rest
    by = lambda s: sorted(t for t, r in results.items() if r == s)
    summary = {"passed": len(by("PASSED")), "failed": by("FAILED") + by("ERROR"),
               "skipped": len(by("SKIPPED")), "stalled": stalled,
               "not_run": [t for t in todo if t not in results], "rcs": rcs,
               "seconds": time.perf_counter() - t0}
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(dict(summary, results=results), f, indent=1)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stall", type=int, default=900)
    ap.add_argument("--limit", type=float, default=3000.0)
    ap.add_argument("k", nargs="?", default="")
    a = ap.parse_args(argv)
    s = run(a.stall, a.limit, a.k)
    print(json.dumps({k: (len(v) if k == "not_run" else v) for k, v in s.items()}))
    return 0 if not s["failed"] and not s["stalled"] and not s["not_run"] else 1


if __name__ == "__main__":
    sys.exit(main())
