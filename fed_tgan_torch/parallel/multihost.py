"""The multi-process world: ``torch.distributed`` bootstrap and the
participants' all-gather (counterpart of
``fed_tgan_tpu/parallel/multihost.py:34-125``).

The reference spans processes with PyTorch RPC (reference
Server/dtds/distributed.py:838-891): rank 0 drives, ranks 1..N hold data
and train.  Here:

- every rank, rank 0 included, joins one process group whose TCP store
  listens on ``port + 1`` (rank 0 is its master; the transport stays on
  ``port``, so one ``-ip``/``-port`` pair configures both planes, as the
  JAX package's coordinator does with ``JAX_PORT_OFFSET``);
- the participants 1..N form :func:`participant_group`; each round every
  participant all-gathers one flat buffer of its leaves
  (:func:`gather_leaves`) and aggregates the (N, ...) stacks itself, in
  rank order, so every participant holds the same bits;
- the backend follows the topology (:func:`choose_backend`): NCCL when
  every participant has a card of its own, gloo otherwise (several
  participants on one card, or the CPU: NCCL refuses two ranks on one
  card).  Over gloo a card's buffer is staged through pinned host memory,
  so the round's bytes cross the host.  The steps still run on the card,
  and a failed collective fails the run.
"""

from __future__ import annotations

import datetime
import logging
import time

import torch
import torch.distributed as dist

from fed_tgan_torch.device import resolve_device

PORT_OFFSET = 1
log = logging.getLogger("fed_tgan_torch.parallel")

_group = None      # the participants' process group
_backend = None    # its backend
# per all-gather: bytes gathered (every participant's buffer) and seconds
stats = {"bytes": [], "seconds": []}


def participant_device(rank: int, device="cuda") -> torch.device:
    """Participant ``rank``'s device: ``cuda:(rank - 1) % device_count()``
    on the card (raising without CUDA), the CPU when asked."""
    device = resolve_device(device)
    if device.type != "cuda" or torch.device(device).index is not None:
        return device
    return torch.device("cuda", (rank - 1) % torch.cuda.device_count())


def choose_backend(n_participants: int, device="cuda") -> str:
    """``nccl`` when every participant has a card of its own on this host,
    ``gloo`` otherwise."""
    if (torch.device(device).type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= n_participants):
        return "nccl"
    return "gloo"


def initialize_multihost(ip: str, port: int, world_size: int, rank: int,
                         device="cuda", timeout_ms: int = 3_600_000) -> str:
    """Join the world (every rank, the server too) and create the
    participants' group; returns the backend.  ``timeout_ms`` bounds
    every collective, so a dead peer fails the run instead of hanging
    it."""
    global _group, _backend
    backend = choose_backend(world_size - 1, device)
    timeout = datetime.timedelta(milliseconds=timeout_ms)
    dist.init_process_group(backend, init_method=f"tcp://{ip}:"
                            f"{port + PORT_OFFSET}", world_size=world_size,
                            rank=rank, timeout=timeout)
    # every rank, the server included, must call new_group
    _group = dist.new_group(ranks=list(range(1, world_size)), timeout=timeout)
    _backend = backend
    log.info("rank %d joined a world of %d (%s)", rank, world_size, backend)
    return backend


def shutdown() -> None:
    global _group, _backend
    if dist.is_initialized():
        dist.destroy_process_group()
    _group = _backend = None


def participant_group():
    if _group is None:
        raise RuntimeError("initialize_multihost has not run")
    return _group


def n_participants() -> int:
    return dist.get_world_size(participant_group())


def gather_leaves(leaves: list) -> list:
    """Every participant's ``leaves`` (float32 tensors of one slot,
    leading axis 1) stacked in rank order: one all-gather of one flat
    buffer; returns each leaf as (N, ...) on the leaves' device."""
    group = participant_group()
    n = dist.get_world_size(group)
    device = leaves[0].device
    flat = torch.cat([x.reshape(-1) for x in leaves])
    t0 = time.perf_counter()
    staged = device.type == "cuda" and _backend == "gloo"
    src = flat
    if staged:
        src = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        src.copy_(flat)
    out = torch.empty((n, src.numel()), dtype=src.dtype,
                      device=src.device, pin_memory=staged)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    if staged:
        out = out.to(device, non_blocking=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats["seconds"].append(time.perf_counter() - t0)
    stats["bytes"].append(out.numel() * out.element_size())
    parts = out.split([x.numel() for x in leaves], dim=1)
    return [p.reshape((n,) + tuple(x.shape[1:]))
            for p, x in zip(parts, leaves)]


def agree(value: int) -> tuple[int, int]:
    """``(min, max)`` of ``value`` over the participants."""
    group = participant_group()
    t = torch.tensor([value, -value], dtype=torch.int64)
    if _backend == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(-t[1]), int(t[0])
