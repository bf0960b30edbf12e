"""Command-line helpers shared by the port's example scripts."""

from __future__ import annotations

import torch

__all__ = ["add_device_arg", "resolve_device"]


def add_device_arg(parser):
    """``--device``: the card by default, ``cpu`` only when asked."""
    parser.add_argument("--device", default="cuda:0",
                        help="torch device (default the card; 'cpu' to run "
                             "on the CPU)")


def resolve_device(name) -> torch.device:
    """``name`` as a ``torch.device``; exits with a message when it names
    the card and there is none (nothing falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("No CUDA device: pass --device cpu to run on the "
                         "CPU.")
    return device
