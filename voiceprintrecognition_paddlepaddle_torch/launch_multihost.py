"""Start N ranks of a command on this host (the port's copy of
``tools/launch_multihost.py``).

    python -m voiceprintrecognition_paddlepaddle_torch.launch_multihost \\
        --nproc 2 -- python -m voiceprintrecognition_paddlepaddle_torch.train \\
        --configs=configs/cam++.yml

Each rank gets ``VPR_COORDINATOR`` (``127.0.0.1:<free port>`` unless
``--coordinator`` names one), ``VPR_NUM_PROCESSES``, ``VPR_PROCESS_ID``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``; the port's ``Trainer`` and
``eval`` join the process group from them
(``parallel.maybe_initialize_distributed``), and rank ``r`` computes on
``cuda:r`` (modulo the host's cards: ranks beyond the card count share
cards over gloo). Across hosts, run the command on every host with those
variables set (``LOCAL_RANK`` counting from 0 on each host), or with
``VPR_AUTO_DISTRIBUTED=1`` under a runner that sets torch's ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``.

When a rank exits with an error the others are stopped, and so are all of
them after ``--timeout`` seconds; the exit code is then the first failing
rank's (124 for the timeout), else 0.
"""

import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + 10
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(cmd, nproc, coordinator=None, timeout=None):
    """Run ``cmd`` (a list) as ``nproc`` ranks and wait; returns the exit
    code as the module docstring says."""
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(nproc):
        procs.append(subprocess.Popen(cmd, env=dict(
            os.environ, VPR_COORDINATOR=coordinator,
            VPR_NUM_PROCESSES=str(nproc), VPR_PROCESS_ID=str(rank),
            LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nproc))))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                _stop(procs)
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if deadline is not None and time.monotonic() > deadline:
                print(f"launch_multihost: ranks still running after "
                      f"{timeout} s; stopping them", file=sys.stderr)
                _stop(procs)
                return 124
            time.sleep(0.05)
    finally:
        _stop(procs)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nproc", type=int, default=2,
                    help="number of ranks to start on this host")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (default: 127.0.0.1 and a "
                         "free port)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="stop every rank after this many seconds")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- the command each rank runs")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given (use: --nproc 2 -- python -m ...)")
    return launch(cmd, args.nproc, args.coordinator, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
