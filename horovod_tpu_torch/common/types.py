"""Errors the port raises (counterpart of
``horovod_tpu/common/types.py``)."""


class HorovodTpuError(RuntimeError):
    """Base error surfaced to user code."""
