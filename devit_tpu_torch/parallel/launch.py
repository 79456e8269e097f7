"""Run a function on W ranks, one fresh process each, joined by one process
group (what `torchrun --nproc-per-node W` does for a script), and collect
what each rank returns.

    results = run_ranks("devit_tpu_torch.entry:_dryrun_steps", 8, args=(8,),
                        device="cpu", timeout=300)

Each rank runs `python -m devit_tpu_torch.parallel.launch`, which sets
DEVIT_COORDINATOR (tcp://localhost:<a free port>), DEVIT_NUM_PROCESSES,
DEVIT_PROCESS_ID and LOCAL_RANK, calls runtime.setup_runtime(device), then
fn(*args), and writes its return value (torch.save) beside its log. A rank
that fails, or a run that outlives `timeout`, kills every rank's process
group and raises with the failing rank's log: no rank is left blocked in a
collective. `fn` is "package.module:function" or "path/to/file.py:function".
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Mapping, Optional, Sequence

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RankFailure(RuntimeError):
    pass


def free_port() -> int:
    """A free localhost port, taken right before the ranks start."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def run_ranks(fn: str, world: int, *, args: Sequence = (), device: str = "cpu",
              timeout: float = 300.0, env: Optional[Mapping[str, str]] = None) -> list:
    """fn(*args) on `world` ranks (module docstring), each with one intra-op
    thread; returns the ranks' return values in rank order. `env` adds
    variables (DEVIT_DIST_BACKEND=gloo for ranks that share a card)."""
    with tempfile.TemporaryDirectory(prefix="devit_ranks_") as tmp:
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        port = free_port()
        procs, logs = [], []
        try:
            for r in range(world):
                child = dict(os.environ, **(env or {}))
                child.update(DEVIT_COORDINATOR=f"localhost:{port}",
                             DEVIT_NUM_PROCESSES=str(world), DEVIT_PROCESS_ID=str(r),
                             LOCAL_RANK=str(r),
                             PYTHONPATH=os.pathsep.join(
                                 [_ROOT] + [p for p in [child.get("PYTHONPATH")] if p]))
                child.pop("DEVIT_MULTIHOST", None)
                log = open(os.path.join(tmp, f"rank{r}.log"), "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "devit_tpu_torch.parallel.launch", tmp, fn, device],
                    env=child, stdout=log, stderr=subprocess.STDOUT, start_new_session=True))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = any(p.poll() not in (None, 0) for p in procs)
                if failed or time.monotonic() > deadline:
                    _kill(procs)
                    if not failed:
                        raise RankFailure(f"{fn} on {world} ranks outlived their {timeout:.0f} "
                                          f"s timeout; rank 0's log ends:\n" + _tail(tmp, 0))
                    break
                time.sleep(0.05)
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                # a rank's peers fail too once it is gone: every failed log
                raise RankFailure(f"{fn} on {world} ranks: " + "\n".join(
                    f"rank {r} exited with {procs[r].returncode}; its log ends:\n"
                    + _tail(tmp, r) for r in bad))
        finally:
            _kill(procs)
            for log in logs:
                log.close()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _tail(tmp: str, r: int, n: int = 3000) -> str:
    with open(os.path.join(tmp, f"rank{r}.log")) as f:
        return f.read()[-n:]


def _resolve(fn: str):
    target, name = fn.rsplit(":", 1)
    if target.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(target))[0], target)
        mod = importlib.util.module_from_spec(spec)
        sys.path.insert(0, os.path.dirname(os.path.abspath(target)))
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(target)
    return getattr(mod, name)


def _main(tmp: str, fn: str, device: str) -> None:
    from devit_tpu_torch import runtime

    torch.set_num_threads(1)  # W ranks share the host's cores
    runtime.setup_runtime(device)
    try:
        out = _resolve(fn)(*torch.load(os.path.join(tmp, "args.pt"), weights_only=False))
        torch.save(out, os.path.join(tmp, f"rank{runtime.rank()}.pt"))
    finally:
        runtime.shutdown()


if __name__ == "__main__":
    _main(*sys.argv[1:4])
