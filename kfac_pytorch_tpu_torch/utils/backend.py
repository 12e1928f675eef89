"""The environment a number was measured in.

Port of ``environment_summary`` (``kfac_pytorch_tpu/utils/backend.py:29``):
the trainers write it at the head of their metrics log and the bench
puts it in its JSON line, so every time can be traced to the card, its
power limit and the software that produced it.
"""
from __future__ import annotations

import platform
import subprocess

import torch

from kfac_pytorch_tpu_torch.ops import _build


def card_power_line() -> str | None:
    """The first line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``),
    or ``None`` where ``nvidia-smi`` is missing or fails."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def environment_summary() -> dict:
    """Python, torch and CUDA versions; the card's name and power limit,
    the device count; and per CUDA kernel source whether its library is
    built for the sources as they are (``kernels_built``)."""
    summary = {
        'python': platform.python_version(),
        'torch': torch.__version__,
        'cuda': torch.version.cuda,
        'cuda_available': torch.cuda.is_available(),
        'device_count': torch.cuda.device_count(),
        'device': (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else 'cpu'),
        'nvidia_smi': card_power_line(),
        'kernels_built': {
            stem: path.is_file()
            for stem, path in _build.library_paths().items()
        },
    }
    return summary
