"""``chip_smoke.py`` stops every process it started before it exits.

The check runs in a fresh interpreter: ``adopt_orphans`` makes the calling
process a subreaper for the rest of its life, which a test worker must
not become.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, multiprocessing, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs

if __name__ == "__main__":
    cs.adopt_orphans()
    # an orphan (its shell exits at once), a spawned child holding the
    # resource tracker's pipe, and the tracker itself
    subprocess.Popen(["sh", "-c", "sleep 60 & exit 0"]).wait()
    child = multiprocessing.get_context("spawn").Process(target=time.sleep, args=(60,))
    child.start()
    time.sleep(0.5)
    before = cs.descendants()
    t0 = time.monotonic()
    found = cs.stop_children(grace_s=5.0)
    print(json.dumps({"before": len(before), "found": sorted(found.values()),
                      "after": cs.descendants(), "seconds": time.monotonic() - t0}))
"""


def test_stop_children_stops_orphans_spawned_children_and_the_tracker():
    out = subprocess.run([sys.executable, "-c", SCRIPT, ROOT], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["before"] == 3  # the orphan, the spawned child, the tracker
    assert len(rec["found"]) == 2 and any("sleep 60" in c for c in rec["found"])
    assert rec["after"] == {}
    assert rec["seconds"] < 5.0  # SIGTERM sufficed; the tracker did not wait for a child
