"""Small constant tensors on a device, made once and kept.

A frame that makes a constant with ``torch.tensor(values, device=cuda)``
copies it from pageable host memory and waits for the copy: inside a CUDA
graph capture that wait is an error, and a copy captured from the host would
be replayed from memory the graph does not own.  ``device_constant`` makes
each constant on its first use, at a frame run eagerly before any capture,
and hands the same tensor to every later frame, captured or not.  Callers
only read it.
"""
from __future__ import annotations

import numpy as np
import torch

#: (values, shape, dtype, device) -> the tensor
_CACHE: dict = {}


def device_constant(values, dtype=torch.float32, device="cpu"):
    """The tensor of `values` (nested lists or a numpy array) as `dtype` on
    `device`, made at the first call with these arguments.  Raises when
    that first call comes during a CUDA graph capture."""
    arr = np.asarray(values)
    dev = torch.device(device)
    key = (tuple(arr.reshape(-1).tolist()), arr.shape, dtype, dev)
    t = _CACHE.get(key)
    if t is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device_constant {arr.tolist()} first made inside a CUDA "
                               "graph capture: run the frame eagerly once before capturing it")
        t = _CACHE[key] = torch.tensor(arr, dtype=dtype, device=dev)
    return t
