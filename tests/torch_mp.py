"""Start the ranks of a sharded CPU run (tests/torch_mp_worker.py), each
under a timeout, and collect what they wrote."""

import json
import os
import pickle
import socket
import subprocess
import sys

RANK_TIMEOUT = 120  # seconds: a rank that hangs fails the test in minutes


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_ranks(tmp_dir, world, spec):
    """Start `world` ranks on `spec` (see torch_mp_worker.py); returns the
    handle `collect` takes. The caller may compute meanwhile."""
    spec_path = os.path.join(tmp_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mp_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(r), str(world), str(port), spec_path, str(tmp_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(world)
    ]
    return tmp_dir, procs


def collect(handle):
    """Wait for every rank (each within RANK_TIMEOUT, killed past it) and
    return [rank 0's results, rank 1's, ...]."""
    tmp_dir, procs = handle
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"a rank did not finish in {RANK_TIMEOUT} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = []
    for r in range(len(procs)):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
