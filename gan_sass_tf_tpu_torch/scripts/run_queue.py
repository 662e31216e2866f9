"""Serial experiment-queue runner for on-chip measurement rounds.

    python -m gan_sass_tf_tpu_torch.scripts.run_queue [round]   (default round: r5)

A copy of `scripts/run_queue.py` (which imports no JAX) for the port: one
card runs experiments strictly serially.  This runner tails a queue file,
executes each line's command from the repo root, and appends one JSON
record per experiment to the round's results file.

Queue line format:    <tag> | <shell command>
Blank lines / lines starting with '#' are ignored.

Completed work is keyed by TAG, not by line position.  Before running a
job the runner checks every ``results/r*_results.jsonl`` for a record with
the same tag; if one exists (success OR failure) the job is skipped.
Lines may therefore be inserted, reordered, or deleted anywhere in the
queue file at any time.  To re-run a tag, give it a new name (e.g.
``foo_v2``); failed jobs are deliberately NOT retried, so a broken
command does not burn serial chip hours on a loop.

The runner exits when no runnable job remains AND ``<round>_queue.CLOSE``
exists; otherwise it sleeps and polls for new lines.
"""

from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS = os.path.join(REPO, "results")
TIMEOUT_S = 3 * 3600  # one experiment should never exceed 3 h


def paths(round_name: str):
    return (os.path.join(RESULTS, f"{round_name}_queue.txt"),
            os.path.join(RESULTS, f"{round_name}_results.jsonl"),
            os.path.join(RESULTS, f"{round_name}_log.txt"),
            os.path.join(RESULTS, f"{round_name}_queue.CLOSE"))


def done_tags() -> set:
    """Tags with a record in ANY round's results file (success or failure)."""
    tags = set()
    for name in sorted(os.listdir(RESULTS)) if os.path.isdir(RESULTS) else []:
        if not (name.endswith("_results.jsonl") and name.startswith("r")):
            continue
        with open(os.path.join(RESULTS, name)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    tags.add(json.loads(line)["tag"])
                except (json.JSONDecodeError, KeyError):
                    pass
    return tags


def parse_queue(queue_path: str):
    try:
        with open(queue_path) as f:
            lines = f.read().splitlines()
    except FileNotFoundError:
        return []
    jobs = []
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#") or "|" not in line:
            continue
        tag, _, cmd = line.partition("|")
        jobs.append((tag.strip(), cmd.strip()))
    return jobs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    round_name = argv[0] if argv else "r5"
    queue_path, out_path, log_path, close_path = paths(round_name)
    os.makedirs(RESULTS, exist_ok=True)

    # Singleton per round: two concurrent runners race on in-flight tags
    # (a tag has no record until it FINISHES, so both pick it) and split
    # the one chip's throughput.  flock is held for the process lifetime
    # and released by the kernel on any exit, clean or not.
    lock = open(os.path.join(RESULTS, f".{round_name}_runner.lock"), "w")
    try:
        fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        print(f"another {round_name} runner already holds the lock — "
              "exiting (this is the singleton guard, not an error)")
        return 0
    lock.write(str(os.getpid()))
    lock.flush()

    def log(msg: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        with open(log_path, "a") as f:
            f.write(line + "\n")

    while True:
        finished = done_tags()
        job = next(((t, c) for t, c in parse_queue(queue_path)
                    if t not in finished), None)
        if job is None:
            if os.path.exists(close_path):
                log("queue drained and CLOSE sentinel present — exiting")
                return 0
            time.sleep(20)
            continue
        tag, cmd = job
        log(f"run [{tag}]: {cmd}")
        t0 = time.time()
        try:
            proc = subprocess.run(
                cmd, shell=True, cwd=REPO, capture_output=True, text=True,
                timeout=TIMEOUT_S)
            rc = proc.returncode
            stdout, stderr = proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc = -9
            stdout = (e.stdout or b"").decode() if isinstance(
                e.stdout, bytes) else (e.stdout or "")
            stderr = "TIMEOUT"
        wall = time.time() - t0
        with open(log_path, "a") as f:
            f.write(f"--- [{tag}] stderr tail ---\n")
            f.write("\n".join(stderr.splitlines()[-30:]) + "\n")
        parsed = None
        for out_line in reversed(stdout.splitlines()):
            out_line = out_line.strip()
            if out_line.startswith("{"):
                try:
                    parsed = json.loads(out_line)
                except json.JSONDecodeError:
                    pass
                break
        rec = {"tag": tag, "cmd": cmd, "rc": rc,
               "wall_s": round(wall, 1), "result": parsed}
        if parsed is None:
            rec["stdout_tail"] = stdout[-500:]
        # Full stdout always lands in a per-tag file (profilers and other
        # multi-line reporters have no one-JSON-line contract).
        with open(os.path.join(RESULTS, f"{round_name}_out_{tag}.txt"),
                  "w") as f:
            f.write(stdout)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        log(f"done [{tag}] rc={rc} wall={wall:.0f}s "
            f"result={'ok' if parsed else 'NO-JSON'}")


if __name__ == "__main__":
    sys.exit(main())
