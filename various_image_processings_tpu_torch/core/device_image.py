"""DeviceImage: an explicit host↔device image container.

Counterpart of the reference's ``DeviceImage<T>``
(include/cuda/device_image.hpp:4, src/device_image.cu), a W×H×C device
buffer with upload/download, and of the JAX package's
``core/device_image.py``.  Here the buffer is a torch tensor on ``device``
(the GPU unless the caller passes ``device="cpu"``); ops and modules take
``get()`` with no copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._validate import check_device


class DeviceImage:
    def __init__(self, height: int, width: int, channels: int = 3,
                 dtype: torch.dtype = torch.uint8, device="cuda"):
        self.shape = (int(height), int(width), int(channels))
        self.dtype = dtype
        self.device = check_device(device)
        self._buf = torch.zeros(self.shape, dtype=dtype, device=self.device)

    @classmethod
    def from_array(cls, array, device="cuda") -> "DeviceImage":
        """A buffer of the array's shape (a 2-D array gets one channel) and
        dtype, holding its values."""
        host = torch.from_numpy(np.ascontiguousarray(array))
        if host.ndim == 2:
            host = host[:, :, None]
        img = cls(*host.shape, dtype=host.dtype, device=device)
        img.upload(host)
        return img

    def upload(self, host_array) -> None:
        host = (host_array if isinstance(host_array, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(host_array)))
        if host.ndim == 2:
            host = host[:, :, None]
        if tuple(host.shape) != self.shape:
            raise ValueError(f"shape {tuple(host.shape)} != {self.shape}")
        # a copy even on the CPU: the buffer never aliases the caller's array
        self._buf = host.to(device=self.device, dtype=self.dtype, copy=True)

    def download(self) -> np.ndarray:
        return self._buf.cpu().numpy()

    def get(self) -> torch.Tensor:
        """The device buffer (no copy)."""
        return self._buf

    def set(self, device_array: torch.Tensor) -> None:
        if tuple(device_array.shape) != self.shape:
            raise ValueError(f"shape {tuple(device_array.shape)} != {self.shape}")
        self._buf = device_array
