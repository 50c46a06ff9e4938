"""The numpy bridge the TensorFlow and MXNet frontends share: their
tensors reach the eager plane (:mod:`horovod_tpu_torch.ops.eager`, whose
ops take torch tensors) as numpy arrays, go to the runtime's device
(``hvd.device()``: the card, or the CPU under ``HOROVOD_PLATFORM=cpu``)
and come back to the host with the array's own dtype.  ``bfloat16``
arrays (``ml_dtypes.bfloat16``, TensorFlow's ``tf.bfloat16`` in numpy)
cross as their 16-bit patterns and become ``torch.bfloat16`` on the
device.  Only the wire copies; the values are never rounded."""

from __future__ import annotations

import numpy as np
import torch


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def to_device(arr) -> torch.Tensor:
    """``arr`` as a torch tensor on the runtime's device."""
    from horovod_tpu_torch.common.basics import device

    a = np.asarray(arr, order="C")  # keeps a 0-d array 0-d
    if _is_bf16(a.dtype):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device())


def to_host(t: torch.Tensor, dtype=None) -> np.ndarray:
    """The device tensor ``t`` as a numpy array of ``dtype`` (a bfloat16
    dtype takes the 16-bit patterns back; with no dtype a bfloat16
    tensor comes back as float32, which holds its values exactly)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        if dtype is None or not _is_bf16(np.dtype(dtype)):
            return to_host(t.float(), dtype)
        return t.view(torch.int16).cpu().numpy().view(dtype)
    out = t.cpu().numpy()
    if dtype is not None and out.dtype != np.dtype(dtype):
        out = out.astype(dtype)
    return out
