"""Status, errors and the wire's dtype codes (counterpart of
``horovod_tpu/common/types.py``).

``Status`` kinds follow the reference's ``common.h:122-136``.  The dtype
codes travel on the negotiation wire and key the response cache, so they
keep the JAX package's numbers, bfloat16 included: a torch dtype gets
the code of the numpy dtype it stands for.
"""

from __future__ import annotations

import enum

import torch


class StatusType(enum.Enum):
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


class Status:
    """Result of an enqueued operation.  ``exc_class`` optionally names
    the exception a waiting user thread raises, so a failure's cause
    survives the handle layer."""

    __slots__ = ("type", "reason", "exc_class")

    def __init__(self, type_: StatusType = StatusType.OK, reason: str = "",
                 exc_class: type | None = None):
        self.type = type_
        self.reason = reason
        self.exc_class = exc_class

    @staticmethod
    def ok() -> "Status":
        return Status(StatusType.OK)

    @staticmethod
    def unknown(msg: str) -> "Status":
        return Status(StatusType.UNKNOWN_ERROR, msg)

    @staticmethod
    def precondition(msg: str, exc_class: type | None = None) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, msg, exc_class)

    @staticmethod
    def aborted(msg: str, exc_class: type | None = None) -> "Status":
        return Status(StatusType.ABORTED, msg, exc_class)

    @staticmethod
    def invalid_argument(msg: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, msg)

    @staticmethod
    def in_progress() -> "Status":
        return Status(StatusType.IN_PROGRESS)

    def ok_p(self) -> bool:
        return self.type == StatusType.OK

    def in_progress_p(self) -> bool:
        return self.type == StatusType.IN_PROGRESS

    def __repr__(self) -> str:
        return f"Status({self.type.name}, {self.reason!r})"


class HorovodTpuError(RuntimeError):
    """Base error surfaced to user code."""


class HorovodInternalError(HorovodTpuError):
    """A collective failed after it was enqueued."""


class DuplicateNameError(HorovodTpuError):
    """The same tensor name submitted twice before completion
    (reference ``common.h:161``)."""


class StalledError(HorovodTpuError):
    """Stall inspector escalation (reference ``stall_inspector.h:74-80``)."""


class RanksDownError(HorovodTpuError):
    """Peer ranks stopped and the job was aborted.  The port raises it
    only for an error response whose message carries ``WIRE_PREFIX``
    (the heartbeat plane that sends one is not ported yet); ``ranks``,
    ``round`` and ``elapsed`` are read back from the JSON header after
    the prefix, as the reference does."""

    WIRE_PREFIX = "RanksDownError:"

    def __init__(self, msg: str, ranks: tuple = (), round: int = -1,
                 elapsed: float = 0.0):
        super().__init__(msg)
        if not ranks and msg.startswith(self.WIRE_PREFIX):
            try:
                import json

                blob = msg[len(self.WIRE_PREFIX):].strip()
                meta = json.loads(blob[:blob.index("}") + 1])
                ranks = tuple(meta.get("ranks", ()))
                round = int(meta.get("round", round))
                elapsed = float(meta.get("elapsed", elapsed))
            except (ValueError, TypeError):
                pass
        self.ranks = tuple(ranks)
        self.round = round
        self.elapsed = elapsed


class JoinedRankError(HorovodTpuError):
    """Operation submitted after this rank joined."""


# The wire's dtype table, in the JAX package's order (its codes are the
# indices): uint8, int8, uint16, int16, int32, int64, float16, bfloat16,
# float32, float64, bool.
SUPPORTED_DTYPES = (
    torch.uint8,
    torch.int8,
    torch.uint16,
    torch.int16,
    torch.int32,
    torch.int64,
    torch.float16,
    torch.bfloat16,
    torch.float32,
    torch.float64,
    torch.bool,
)

_DTYPE_CODES = {d: i for i, d in enumerate(SUPPORTED_DTYPES)}


def dtype_code(dtype: torch.dtype) -> int:
    """Stable small-int code for a dtype (the negotiation wire's)."""
    if dtype not in _DTYPE_CODES:
        raise HorovodTpuError(f"Unsupported dtype for collective: {dtype}")
    return _DTYPE_CODES[dtype]


def dtype_from_code(code: int) -> torch.dtype:
    return SUPPORTED_DTYPES[code]
