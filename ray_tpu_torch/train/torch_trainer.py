"""TorchTrainer: the reference's flagship trainer surface on this runtime
(port of ``ray_tpu/train/torch_trainer.py``).

Reference: ``python/ray/train/torch/`` (``TorchConfig:36``,
``_TorchBackend:153``, ``config.py:66-151`` ``_setup_torch_process_
group``) + ``train/torch/train_loop_utils.py`` (``prepare_model``,
``prepare_data_loader``). Users migrating from the reference keep their
``train_loop_per_worker`` verbatim: the trainer gang-schedules workers,
wires a ``torch.distributed`` process group through the same KV
rendezvous the JaxTrainer path uses, and tears it down afterwards.

The process group is NCCL for workers that hold a GPU and gloo
otherwise, and ``prepare_model`` moves the module to the worker's device
(``device_ids`` on CUDA). The JAX package's TorchTrainer is gloo-only by
design (torch there is the CPU-side bridge beside JAX); here torch is the
accelerator path, a difference on purpose.
"""

from __future__ import annotations

import logging
import socket
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.trainer import JaxTrainer

logger = logging.getLogger(__name__)


def _worker_device():
    """The device this worker trains on: its leased GPU, else the CPU. A
    worker that holds a GPU lease but cannot reach CUDA raises rather
    than train on the CPU."""
    import os

    import torch

    from ray_tpu_torch.train.context import holds_gpu

    if not holds_gpu():
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "this worker holds a GPU lease (CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')}) but torch sees "
            "no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _setup_process_group() -> bool:
    """Initialize torch.distributed across the gang (NCCL on GPU workers,
    gloo otherwise); rank 0 binds the store port and publishes it
    (reference: ``_setup_torch_process_group``). No-op for world_size
    == 1."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train.worker_group import _host

    ctx = train.get_context()
    world = ctx.get_world_size()
    if world <= 1:
        return False
    import torch.distributed as dist

    if ctx.get_world_rank() == 0:
        host = _host()
        with socket.socket() as s:
            s.bind((host, 0))
            addr = f"{host}:{s.getsockname()[1]}"
        train.broadcast_from_rank_zero(addr)
    else:
        addr = train.broadcast_from_rank_zero(None)
    backend = "nccl" if _worker_device().type == "cuda" else "gloo"
    logger.info("torch pg init rank=%d world=%d addr=%s backend=%s",
                ctx.get_world_rank(), world, addr, backend)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{addr}",
        rank=ctx.get_world_rank(), world_size=world)
    return True


def prepare_model(model):
    """Move ``model`` to the worker's device and DDP-wrap it when
    distributed (reference ``train.torch.prepare_model``)."""
    import torch.distributed as dist

    device = _worker_device()
    model = model.to(device)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        if device.type == "cuda":
            return DistributedDataParallel(model, device_ids=[device.index])
        return DistributedDataParallel(model)
    return model


class _EpochAdvancingLoader:
    """Iterating advances the DistributedSampler epoch first, so each
    pass over a shuffled loader sees a fresh shard order (the
    ``sampler.set_epoch`` contract the reference wires up for users)."""

    def __init__(self, loader, sampler):
        self._loader = loader
        self._sampler = sampler
        self._epoch = 0

    def __iter__(self):
        self._sampler.set_epoch(self._epoch)
        self._epoch += 1
        return iter(self._loader)

    def __len__(self):
        return len(self._loader)

    def __getattr__(self, name):
        return getattr(self._loader, name)


def prepare_data_loader(data_loader):
    """Shard a DataLoader across workers with a DistributedSampler
    (reference ``train.torch.prepare_data_loader``): the incoming
    loader's shuffle intent (inferred from its sampler, as the
    reference does), batching, worker, and collate settings are
    preserved; each epoch re-shuffles via ``set_epoch``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return data_loader
    if data_loader.batch_size is None:
        # batch_sampler-driven loaders have no batch_size to rebuild
        # with; sharding one automatically would silently change its
        # batching. The user shards their batch_sampler themselves.
        raise ValueError(
            "prepare_data_loader cannot shard a DataLoader built with "
            "batch_sampler=...; construct the DistributedSampler-aware "
            "batch_sampler yourself")
    import torch.utils.data as tud
    from torch.utils.data.distributed import DistributedSampler

    shuffle = not isinstance(data_loader.sampler, tud.SequentialSampler)
    sampler = DistributedSampler(data_loader.dataset, shuffle=shuffle)
    loader = tud.DataLoader(
        data_loader.dataset, batch_size=data_loader.batch_size,
        sampler=sampler, num_workers=data_loader.num_workers,
        collate_fn=data_loader.collate_fn,
        pin_memory=data_loader.pin_memory,
        drop_last=data_loader.drop_last,
        worker_init_fn=data_loader.worker_init_fn,
        generator=data_loader.generator)
    return _EpochAdvancingLoader(loader, sampler)


class TorchTrainer(JaxTrainer):
    """Same controller/worker-group/checkpoint machinery as JaxTrainer;
    only the per-worker bootstrap differs."""

    def __init__(self, train_loop_per_worker: Callable,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 **kwargs: Any):
        def wrapped(config):
            started = _setup_process_group()
            try:
                train_loop_per_worker(config)
            finally:
                if started:
                    import torch.distributed as dist

                    try:
                        dist.destroy_process_group()
                    except Exception:  # noqa: BLE001 — teardown best-effort
                        pass

        super().__init__(wrapped, train_loop_config=train_loop_config,
                         **kwargs)
