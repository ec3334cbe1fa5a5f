"""Device selection and the card's identity.

The port runs on ``cuda`` unless a caller asks for ``cpu`` explicitly; the
CPU runs every kernel's plain-PyTorch twin (the wrappers dispatch on the
tensor's device, never on a fallback).
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch


def get_device(device: Optional[Union[str, torch.device]] = None
               ) -> torch.device:
    """``cuda`` unless ``device`` names another; raises when ``cuda`` is
    asked for and absent.  Turns TF32 off for float32 matmuls and
    convolutions (the reference computes in full float32)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain-PyTorch twins")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def card_identity() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card), or "" where nvidia-smi is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return ""
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=False)
    return out.stdout.strip()
