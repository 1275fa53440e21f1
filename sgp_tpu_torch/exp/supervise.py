"""Failure-detecting training supervisor: automatic crash and hang recovery.

Counterpart of ``sgp_tpu/exp/supervise.py``. The restartable runner
(``run_largescale_sgp --checkpoint-every/--checkpoint-path/--resume``)
continues the exact uninterrupted run from one atomic state file; this
wrapper detects the failure and restarts it, so that a long run survives a
crash, an out-of-memory kill or a silent stall without a human.

Usage::

    python -m sgp_tpu_torch.exp.supervise --max-restarts 5 \\
        --hang-timeout 1800 \\
        -- python -m sgp_tpu_torch.exp.run_largescale_sgp \\
           --config largescale_100nn/sgp_pv.yaml \\
           --checkpoint-every 10 --checkpoint-path /path/state.ckpt

Behaviour:
- The command after ``--`` runs as a child in its own process group; on a
  failure the supervisor kills exactly that group by its id (never by a
  name pattern, which can match unrelated processes).
- A crash is any nonzero exit (a fault, an assert, an out-of-memory kill).
- A hang is no output for ``--hang-timeout`` seconds. Set it above the
  longest silent stretch of the run: the kernels' first build, a long
  encode.
- Every restart appends ``--resume true`` (replacing an existing flag),
  so that the child continues from its checkpoint, after
  ``--restart-delay`` seconds.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from sgp_tpu_torch.utils.logging import logger


def _with_resume(cmd):
    """Return ``cmd`` with ``--resume true`` set (replacing any existing
    ``--resume`` value)."""
    out, i = [], 0
    while i < len(cmd):
        if cmd[i] == "--resume":
            i += 2 if i + 1 < len(cmd) and not \
                cmd[i + 1].startswith("--") else 1
            continue
        out.append(cmd[i])
        i += 1
    return out + ["--resume", "true"]


def _kill_group(proc):
    """Terminate the child's process group by its id, escalating to
    SIGKILL; never by name or pattern. Works after the leader has been
    reaped (``start_new_session=True`` makes the group id ``proc.pid``),
    so that cleanup after a crash also ends the group's other members,
    which could otherwise keep memory on the card."""
    pgid = proc.pid
    for sig, wait_s in ((signal.SIGTERM, 10.0), (signal.SIGKILL, 30.0)):
        try:
            os.killpg(pgid, sig)
        except ProcessLookupError:
            return   # no group members left
        deadline = time.time() + wait_s
        while time.time() < deadline:
            proc.poll()   # reap the leader: a zombie still counts as a member
            try:
                os.killpg(pgid, 0)   # probe: any member still alive?
            except ProcessLookupError:
                return
            time.sleep(0.2)


def supervise(cmd, max_restarts: int = 3, hang_timeout: float = 1800.0,
              restart_delay: float = 5.0,
              require_checkpoint: bool = True) -> int:
    """Run ``cmd`` under crash and hang supervision; returns the final exit
    code (0 on eventual success)."""
    if require_checkpoint and "--checkpoint-path" not in cmd:
        # without an explicit path the runner checkpoints into a new
        # timestamped logdir each invocation, so every --resume restart
        # would start from epoch 0 and replay the same crash
        raise ValueError(
            "supervise: the command has no --checkpoint-path; restarts "
            "could not resume (each invocation writes its checkpoint "
            "into a NEW timestamped logdir). Add --checkpoint-every/"
            "--checkpoint-path to the command, or pass "
            "--allow-no-checkpoint to supervise restart-from-scratch.")
    attempt = 0
    while True:
        argv = cmd if attempt == 0 else _with_resume(cmd)
        logger.info(f"supervise[{attempt}]: {' '.join(argv)}")
        proc = subprocess.Popen(
            argv, start_new_session=True,   # own group: exact cleanup
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        os.set_blocking(proc.stdout.fileno(), False)

        def _drain():
            try:
                chunk = proc.stdout.read()   # non-blocking: None if empty
            except (OSError, ValueError):
                chunk = None
            if chunk:
                sys.stdout.write(chunk.decode(errors="replace"))
                sys.stdout.flush()
                return True
            return False

        last_out = time.time()
        hung = False
        while True:
            if _drain():
                last_out = time.time()
            if proc.poll() is not None:
                _drain()
                break
            if hang_timeout and time.time() - last_out > hang_timeout:
                logger.warning(
                    f"supervise: no output for {hang_timeout:.0f}s — "
                    f"killing pgid {proc.pid} as hung")
                _kill_group(proc)
                hung = True
                break
            time.sleep(0.25)
        rc = proc.wait()
        proc.stdout.close()
        if rc == 0 and not hung:
            logger.info(f"supervise: success after {attempt} restart(s)")
            return 0
        if not hung:
            # the leader died, but helpers it started in its session may
            # live on: end the group before restarting
            _kill_group(proc)
        attempt += 1
        if attempt > max_restarts:
            logger.error(
                f"supervise: giving up after {max_restarts} restarts "
                f"(last rc={rc}{', hung' if hung else ''})")
            return rc if rc != 0 else 1
        logger.warning(f"supervise: child {'hung' if hung else f'died rc={rc}'}"
                       f"; restarting with --resume in {restart_delay:.0f}s")
        time.sleep(restart_delay)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run a training command with automatic crash/hang "
                    "recovery (requires the runner's --checkpoint-every/"
                    "--checkpoint-path for exact resume).")
    parser.add_argument("--max-restarts", type=int, default=3)
    parser.add_argument("--hang-timeout", type=float, default=1800.0,
                        help="seconds without child output before the "
                             "run is declared hung (0 disables)")
    parser.add_argument("--restart-delay", type=float, default=5.0)
    parser.add_argument("--allow-no-checkpoint", action="store_true",
                        help="supervise a command without "
                             "--checkpoint-path (restarts re-run from "
                             "scratch instead of resuming)")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- followed by the training command")
    args = parser.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no command given (append: -- python -m ...)")
    try:
        return supervise(cmd, max_restarts=args.max_restarts,
                         hang_timeout=args.hang_timeout,
                         restart_delay=args.restart_delay,
                         require_checkpoint=not args.allow_no_checkpoint)
    except ValueError as e:
        parser.error(str(e))


if __name__ == "__main__":
    sys.exit(main())
