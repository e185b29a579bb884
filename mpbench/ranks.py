"""Cells on several cards: one process a card in one `torch.distributed`
group, which the harness starts itself (NCCL on the cards, gloo on the
CPU; the address is `tcp://127.0.0.1:<a free port>`).

Rank 0 is the process the benchmark was started in, and prints the result;
it starts ranks 1..P-1 as processes of their own (`python -m mpbench.ranks
<spec>`), hands them the run's spec as JSON, and waits for every one to end.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from mpbench import registry

RANK_TIMEOUT_S = 240      # a rank's own end, once rank 0 has its result


class Group:
    """This rank's place in the group, its 1-D worker mesh, and the two
    exchanges the harness needs beside the program's own."""

    def __init__(self, rank: int, world: int, backend: str, port: int):
        self.rank, self.world = rank, world
        self.device = (torch.device("cuda", rank) if backend == "nccl"
                       else torch.device("cpu"))
        if backend == "nccl":
            torch.cuda.set_device(self.device)
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        from repro_torch.launch.mesh import make_worker_mesh
        self.mesh = make_worker_mesh(world)

    def agree(self, go: bool) -> bool:
        """Rank 0's `go`, on every rank."""
        flag = torch.tensor([int(go)], dtype=torch.int32, device=self.device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    def gather(self, obj) -> list | None:
        """Every rank's `obj` on rank 0, in rank order; None elsewhere."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return out

    def close(self) -> None:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(spec: dict, t_start: float):
    from mpbench import harness

    group = Group(spec["rank"], spec["world"], spec["backend"], spec["port"])
    try:
        return harness.run_cell(
            spec["cell"], spec["cfg"], spec["traffic"], spec["seed"],
            spec["seconds"], spec["trace"], str(group.device), spec["bench"],
            t_start, kind=spec["kind"], group=group, tmp=spec["tmp"])
    finally:
        group.close()


def launch(cell, cfg, traffic, seed, seconds, trace, bench, t_start, kind,
           backend: str = "nccl", rank_cmd: list[str] | None = None):
    """Run the cell on `cell["chips"]` ranks; returns rank 0's (result,
    compared numbers). `rank_cmd` starts a rank other than 0 given its spec
    (default `python -m mpbench.ranks`)."""
    world = int(cell["chips"])
    with tempfile.TemporaryDirectory(prefix="mpbench-") as tmp:
        spec = dict(cell=cell, cfg=cfg, traffic=traffic, seed=seed,
                    seconds=seconds, trace=trace, bench=bench, kind=kind,
                    backend=backend, port=_free_port(), world=world,
                    tmp=tmp)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(registry.ROOT), str(registry.ROOT / "src"),
             os.environ.get("PYTHONPATH", "")]))
        cmd = rank_cmd or [sys.executable, "-m", "mpbench.ranks"]
        procs = [subprocess.Popen(cmd + [json.dumps(dict(spec, rank=r))],
                                  env=env, stdout=sys.stderr)
                 for r in range(1, world)]
        try:
            out = _run_rank(dict(spec, rank=0), t_start)
            for p in procs:
                p.wait(timeout=RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs, 1) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"ranks {bad} ended with "
                               f"{[procs[r - 1].returncode for r in bad]}")
        return out


def rank_main(spec_json: str) -> int:
    _run_rank(json.loads(spec_json), time.perf_counter())
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1]))
