"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument. The default is ``"cuda"``;
tests pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels. A CUDA device that is asked for (or defaulted to) while
``torch.cuda.is_available()`` is False raises: nothing here ever falls
back to the CPU on its own.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """``device`` (default cuda) as a torch.device; raises RuntimeError
    when it names CUDA and no CUDA device is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def describe() -> dict:
    """The CUDA device this process would run on: name and count."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def upload(arrays: Dict[str, np.ndarray],
           device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays as tensors on ``device``. On CUDA they cross in ONE
    host-to-device copy: packed into one byte buffer (each array at an
    8-byte-aligned offset), copied, and viewed back by dtype and shape."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    offs, total = {}, 0
    for k, v in arrays.items():
        offs[k] = total
        total += (v.nbytes + 7) // 8 * 8
    host = np.zeros(max(total, 8), dtype=np.uint8)
    for k, v in arrays.items():
        host[offs[k]:offs[k] + v.nbytes] = v.reshape(-1).view(np.uint8)
    dev = torch.from_numpy(host).to(device)
    out = {}
    for k, v in arrays.items():
        dt = torch.from_numpy(v[:0].reshape(-1)).dtype
        seg = dev[offs[k]:offs[k] + v.nbytes]
        out[k] = seg.view(dt).reshape(v.shape)
    return out
