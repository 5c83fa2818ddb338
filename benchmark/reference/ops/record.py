"""Where the reference's sparse, attention and sampling ops report their
calls: a sink set for a block of code (`recording`) receives each call's
operands, so the harness can count the work the calls need. Nothing is
recorded outside such a block."""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional

_SINK: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar("sink", default=None)


def record(op: str, **operands) -> None:
    sink = _SINK.get()
    if sink is not None:
        sink(op, operands)


@contextlib.contextmanager
def recording(sink: Callable[[str, dict], None]) -> Iterator[None]:
    token = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(token)
