"""Host-to-device uploads that do not make the host wait for the card."""
from __future__ import annotations

import numpy as np
import torch


def to_device(a, device) -> torch.Tensor:
    """A host array (or a sequence of numbers) as a tensor on `device`.

    A copy from pageable host memory blocks the host until the card has
    run everything queued before it (a host sync). On the card the bytes
    go through pinned memory by a non-blocking copy instead, queued on the
    current stream; PyTorch's caching host allocator keeps the pinned
    buffer until that copy has run."""
    x = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)
