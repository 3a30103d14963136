"""Numeric and device policy (port of ``fenicssolver_tpu/config.py``).

Dtype: float64 by default, the accuracy the verification cases need
(1e-8 rel-L2); ``FST_X32=1`` opts into float32.  Nothing here changes a
torch global default: every function that allocates takes ``dtype=`` and
``device=`` explicitly and resolves them through this module.

Device: the port runs on the card (``cuda``) unless the caller asks for
the CPU, with ``FST_DEVICE=cpu`` or ``device="cpu"`` (as the tests do).
``FST_DEVICE`` names the default device; solver classes and entry points
also take ``device=``.  Asking for ``cuda`` (the default) on a machine
without a usable card raises; nothing carries on quietly on the CPU.
"""

from __future__ import annotations

import os

import torch


def default_float():
    return torch.float32 if os.environ.get("FST_X32", "0") == "1" else torch.float64


def resolve_device(device=None):
    """``device`` (or ``FST_DEVICE``, default ``cuda``) as a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when no card is available."""
    if device is None:
        device = os.environ.get("FST_DEVICE", "cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; set FST_DEVICE=cpu (or device='cpu') to run on the CPU"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cpu' or 'cuda'")
    return dev


def synchronize(device):
    """Wait for queued work on ``device`` (phase timers read a host clock)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def shard_devices():
    """The devices the distributed layer (``parallel/``) shards over: the
    counterpart of the reference's ``jax.devices()``, one entry a shard.

    ``FST_SHARDS`` shards (default: ``torch.cuda.device_count()`` on the
    card, 1 on the CPU).  On the card they are spread over every card in
    contiguous blocks, shard r on ``cuda:(r * n_cards // n_shards)``, so
    neighbouring shards share a card where they can; with one card every
    shard is on ``cuda:0``.  On the CPU every shard is on the default
    device.  The shards of one card are stacked there as one tensor
    (``parallel/groups.py``)."""
    dev = resolve_device(None)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    n = int(os.environ.get("FST_SHARDS", n_cards))
    if n < 1:
        raise ValueError(f"FST_SHARDS must be at least 1, not {n}")
    if dev.type != "cuda":
        return [dev] * n
    return [torch.device("cuda", r * n_cards // n) for r in range(n)]
