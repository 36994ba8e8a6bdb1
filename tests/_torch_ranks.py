"""Run a piece of code on N ranks of a gloo group on the CPU, for the port's
distributed tests: one ``python -c`` process a rank (``PYTHONPATH=src``, one
thread each, as JAX's ``_run_sub`` runs its multi-device cases), the group
started from a ``file://`` store under the test's ``tmp_path`` (no TCP
port). The code sees ``RANK``, ``WORLD``, ``TMP`` (the directory),
``dist`` and ``emit(name, obj)``, which saves ``obj`` for the test to
``load(tmp_path, name, rank)``; ``torch.load(f"{TMP}/in.pt")`` reads what
the test ``save``d. Each rank's output goes to a file, so no pipe fills
while another rank waits in a collective."""
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

PRELUDE = """
import os, sys
import torch
torch.set_num_threads(1)
RANK, WORLD, TMP = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import torch.distributed as dist
from repro_torch.launch.mesh import init_distributed
init_distributed("gloo", f"file://{TMP}/store-{WORLD}", rank=RANK,
                 world_size=WORLD)


def emit(name, obj):
    torch.save(obj, f"{TMP}/{name}.rank{RANK}.pt")


"""
EPILOGUE = "\ndist.destroy_process_group()\n"


def save(tmp_path, obj, name="in"):
    torch.save(obj, pathlib.Path(tmp_path) / f"{name}.pt")


def load(tmp_path, name, rank=0):
    return torch.load(pathlib.Path(tmp_path) / f"{name}.rank{rank}.pt",
                      weights_only=False)


def env():
    return {"PYTHONPATH": "src", "PATH": os.environ["PATH"],
            "HOME": os.path.expanduser("~"),
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def run_ranks(code: str, world: int, tmp_path, timeout: float = 240.0):
    """Run ``code`` on ``world`` ranks; every rank must exit 0 within
    ``timeout`` seconds (the others are killed when one fails)."""
    tmp = pathlib.Path(tmp_path)
    src = PRELUDE + textwrap.dedent(code) + EPILOGUE
    logs = [tmp / f"log-{world}-{r}.txt" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", src, str(r), str(world), str(tmp)],
                stdout=f, stderr=subprocess.STDOUT, env=env(), cwd=ROOT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        text = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                         + logs[r].read_text()[-4000:] for r, c in bad)
        raise AssertionError(f"ranks failed: {bad}\n{text}")
    return [log.read_text() for log in logs]


__all__ = ["run_ranks", "save", "load", "torch"]
