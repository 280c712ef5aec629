"""Launcher: one process a rank on ``torch.distributed``.

Counterpart of ``pointcloudpdf_tpu/engines/launch.py`` and of the
reference's ``mp.spawn`` launcher (Pointcept engines/launch.py): at world 1
with no backend asked for, ``main_func`` runs inline, as a one-process run
always has.  Otherwise each rank is a spawned process that joins a process
group (NCCL on CUDA, gloo on the CPU; ``backend`` overrides), takes
``cuda:<local rank>`` on CUDA, runs ``main_func(*cfg)`` and tears the group
down on its way out.  A world of 1 with a backend runs inline in a group
of one, so every collective of the path is issued.

More ranks than cards raises, unless the caller asks for gloo: gloo ranks
may share a card (rank r on ``cuda:r % cards``), which NCCL refuses.  A
rank that raises ends the run: ``torch.multiprocessing`` terminates the
others and re-raises here.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils import comm

TIMEOUT = timedelta(minutes=30)  # a collective waiting longer fails the rank


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _backend(backend, device_type: str, local_world: int) -> str:
    """The backend a run of ``local_world`` ranks a machine takes on
    ``device_type``; raises where it cannot run."""
    if device_type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} needs CUDA; the CPU runs gloo")
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"launch runs on cpu or cuda, not {device_type!r}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError("CUDA asked for but no CUDA device is available; "
                           "pass device=cpu to run on the CPU")
    backend = backend or "nccl"
    if local_world > cards and backend != "gloo":
        raise RuntimeError(
            f"{local_world} ranks asked for on a machine with {cards} CUDA "
            f"device(s): one rank a card ({backend} refuses ranks sharing a "
            "card); ask for backend='gloo' to share one")
    return backend


def launch(main_func, num_gpus_per_machine: int = 1, num_machines: int = 1,
           machine_rank: int = 0, dist_url=None, cfg=(), backend=None,
           device: str = "cuda"):
    """Run ``main_func(*cfg)`` on ``num_machines x num_gpus_per_machine``
    ranks (``dist_url``: ``tcp://host:port`` of rank 0, a free local port
    when None on one machine)."""
    world_size = num_machines * num_gpus_per_machine
    if world_size == 1 and backend is None:
        main_func(*cfg)
        return
    device_type = torch.device(device).type
    backend = _backend(backend, device_type, num_gpus_per_machine)
    if dist_url is None:
        if num_machines > 1:
            raise ValueError("a run over several machines needs dist_url")
        dist_url = f"tcp://localhost:{_free_port()}"
    args = (main_func, backend, device_type, world_size, num_gpus_per_machine,
            machine_rank, dist_url, cfg)
    if world_size == 1:
        _worker(0, *args)
        return
    mp.start_processes(_worker, args=args, nprocs=num_gpus_per_machine,
                       join=True, start_method="spawn")


def _worker(local_rank, main_func, backend, device_type, world_size,
            num_gpus_per_machine, machine_rank, dist_url, cfg):
    rank = machine_rank * num_gpus_per_machine + local_rank
    if num_gpus_per_machine > 1:  # a spawned process
        os.environ["LOCAL_RANK"] = str(local_rank)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    elif num_gpus_per_machine > 1 and "OMP_NUM_THREADS" not in os.environ:
        # CPU ranks share the machine's cores, as torchrun shares them
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_gpus_per_machine))
    dist.init_process_group(backend, init_method=dist_url,
                            world_size=world_size, rank=rank, timeout=TIMEOUT)
    try:
        main_func(*cfg)
        comm.synchronize()
    finally:
        comm.destroy()
