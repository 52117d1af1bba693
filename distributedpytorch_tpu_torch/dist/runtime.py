"""Process-group runtime: ``torch.distributed`` under torchrun's env.

Counterpart of ``distributedpytorch_tpu/dist/runtime.py``. The reference
joins its group with ``dist.init_process_group('nccl',
init_method='env://')`` under a torchrun launcher that sets LOCAL_RANK /
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT (reference train.py:29-31,
:58-61; README.md:37). The port does the same:

* backend ``nccl`` when the rank's device is a card, ``gloo`` for
  ``--device cpu``;
* a rank's device is ``cuda:LOCAL_RANK``; a LOCAL_RANK beyond the
  visible cards raises, it is never wrapped onto a card another rank
  holds. A device with an explicit index (``cuda:0``) is taken as it is;
* a ``-t DDP_MP`` rank drives S cards, ``cuda:(LOCAL_RANK·S + s)`` for
  s < S (``stage_devices``), and a node with fewer than
  ``nproc_per_node × S`` cards raises the same way. The group is joined
  without ``device_id``: such a process talks NCCL on S devices, and the
  group makes one communicator per device at its first collective there,
  in the same stage order on every rank (PyTorch's "DDP with model
  parallel" layout). With ``--device cpu`` every stage of every rank runs
  on the CPU, under gloo;
* ``DPT_DIST_INIT_TIMEOUT_S`` (seconds) bounds the rendezvous, as the
  ``timeout=`` of ``init_process_group``;
* with no launcher env the run is world 1, through the same code path
  (a one-rank group over an in-memory store), as ``--nproc_per_node 1``;
* a group that already exists (a caller made it, with any backend) is
  used as it is: ``initialize_from_env`` is idempotent.

The JAX package's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_PROCESS_ID`` and
``DPT_JAX_AUTO_INIT`` address ``jax.distributed`` and TPU pods; they have
no meaning here and are not read.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import logging
import os
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from distributedpytorch_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    """One process's place in the group: its rank, the world size, the
    rendezvous address (None without a launcher), its local rank and the
    device it computes on."""

    process_id: int
    num_processes: int
    coordinator: Optional[str] = None
    local_rank: int = 0
    device: torch.device = torch.device("cpu")

    @property
    def is_main(self) -> bool:
        return self.process_id == 0

    @property
    def backend(self) -> str:
        """``nccl`` for a card, ``gloo`` for the CPU."""
        return "nccl" if self.device.type == "cuda" else "gloo"


def torchrun_env() -> Optional[RuntimeInfo]:
    """torchrun's env contract as a RuntimeInfo (device not yet
    resolved), or None without it."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT", "29500")
    return RuntimeInfo(
        process_id=int(os.environ["RANK"]),
        num_processes=int(os.environ["WORLD_SIZE"]),
        coordinator=f"{addr}:{port}",
        local_rank=int(os.environ.get("LOCAL_RANK", "0")),
    )


def init_timeout() -> Optional[datetime.timedelta]:
    """``DPT_DIST_INIT_TIMEOUT_S`` as the rendezvous timeout; None (torch's
    default) when unset or malformed."""
    raw = os.environ.get("DPT_DIST_INIT_TIMEOUT_S")
    if not raw:
        return None
    try:
        return datetime.timedelta(seconds=float(raw))
    except ValueError:
        logger.warning("ignoring malformed DPT_DIST_INIT_TIMEOUT_S=%r", raw)
        return None


def card_of(local_rank: int, visible: int) -> torch.device:
    """``cuda:local_rank``, or a RuntimeError when ``visible`` cards have
    none of that index."""
    if not 0 <= local_rank < visible:
        raise RuntimeError(
            f"LOCAL_RANK {local_rank} has no card: {visible} visible — "
            f"launch at most one process per card (torchrun "
            f"--nproc_per_node {visible})")
    return torch.device("cuda", local_rank)


def rank_device(device: Union[None, str, torch.device],
                local_rank: int) -> torch.device:
    """The device a rank computes on: ``device`` as resolved by
    ``resolve_device`` (the card unless ``cpu`` is asked for), with
    ``cuda`` meaning ``card_of(local_rank, visible cards)``."""
    return stage_devices(device, local_rank, 1)[0]


def stage_devices(device: Union[None, str, torch.device], local_rank: int,
                  stages: int) -> List[torch.device]:
    """The ``stages`` devices of a rank, stage by stage: for ``cuda``
    ``cuda:(local_rank·stages + s)``, raising as ``card_of`` does where
    the node has too few cards; for ``cpu`` or a card named by its index,
    that device for every stage."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * stages
    visible = torch.cuda.device_count()
    if stages == 1:
        return [card_of(local_rank, visible)]
    first = local_rank * stages
    if not 0 <= first <= visible - stages:
        raise RuntimeError(
            f"LOCAL_RANK {local_rank} has no cards cuda:{first}.."
            f"{first + stages - 1}: {visible} visible — each -t DDP_MP "
            f"process drives {stages} cards, so launch at most "
            f"{visible // stages} per node (torchrun --nproc_per_node "
            f"{visible // stages})")
    return [torch.device("cuda", first + s) for s in range(stages)]


def planned_world() -> int:
    """The world size ``initialize_from_env`` would join: the existing
    group's, else torchrun's, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return (torchrun_env() or RuntimeInfo(0, 1)).num_processes


def initialize_from_env(device: Union[None, str, torch.device] = None,
                        stages: int = 1) -> RuntimeInfo:
    """Join (or make) the default process group and return this process's
    place in it; its device is the first of ``stage_devices(device,
    LOCAL_RANK, stages)`` (``rank_device``'s at one stage). Safe to call
    more than once."""
    env = torchrun_env() or RuntimeInfo(0, 1)
    dev = stage_devices(device, env.local_rank, stages)[0]
    if dist.is_initialized():
        return dataclasses.replace(env, process_id=dist.get_rank(),
                                   num_processes=dist.get_world_size(),
                                   device=dev)
    info = dataclasses.replace(env, device=dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {}
    timeout = init_timeout()
    if timeout is not None:
        kwargs["timeout"] = timeout
    if info.coordinator is None:
        # no launcher: a one-rank group over an in-memory store
        dist.init_process_group(info.backend, store=dist.HashStore(),
                                rank=0, world_size=1, **kwargs)
    else:
        dist.init_process_group(info.backend, init_method="env://",
                                rank=info.process_id,
                                world_size=info.num_processes, **kwargs)
    logger.info("process group %s: rank %d/%d on %s via %s", info.backend,
                info.process_id, info.num_processes, dev,
                info.coordinator or "an in-memory store")
    return info


def shutdown() -> None:
    """``dist.destroy_process_group`` parity (reference train.py:61).
    NCCL's ``ncclCommDestroy`` waits until every CUDA graph that captured
    a collective of the communicator is destroyed: a graph that only
    reference cycles still hold is collected first."""
    if dist.is_initialized():
        gc.collect()
        dist.destroy_process_group()
