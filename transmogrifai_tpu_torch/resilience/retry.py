"""Retry with exponential backoff — transient-vs-fatal classification.

Preemptible machines and remote file systems fail in two distinct
ways: *transient* (a dropped connection, a preempted device, an interrupted
syscall — retrying is cheap and usually succeeds) and *fatal* (a shape
error, a malformed grid — retrying re-raises the same exception forever).
``RetryPolicy`` encodes that split: exponential backoff with deterministic
seeded jitter and an overall deadline, applied only to errors the
classifier calls transient.

The clock and sleep functions are injectable so the fault-injection suite
runs the full backoff schedule without a single real sleep.

One rule of the port's own: a kernel fault
(``utils.cuda_build.is_kernel_fault``) is never transient and never
retried, whatever the classifier says, so a fault of the card is never
hidden behind a second attempt.
"""
from __future__ import annotations

import dataclasses
import errno
import random
import time
from typing import Any, Callable


class TransientError(RuntimeError):
    """Marker for errors worth retrying (preemption, torn I/O, ...)."""


class FatalError(RuntimeError):
    """Marker for errors that must never be retried."""


#: OSError errnos considered transient (interrupted / busy / flaky I/O);
#: everything else (ENOENT, EACCES, EISDIR, ...) is a programming or
#: environment error that a retry cannot fix
_TRANSIENT_ERRNOS = frozenset({
    errno.EAGAIN, errno.EINTR, errno.EIO, errno.EBUSY, errno.ETIMEDOUT,
    errno.ECONNRESET, errno.ECONNABORTED, errno.EPIPE,
})


def is_transient(exc: BaseException) -> bool:
    """Default classifier: a kernel fault is never transient; then
    explicit markers, then connection-shaped builtins, then OSError by
    errno."""
    from ..utils.cuda_build import is_kernel_fault

    if isinstance(exc, FatalError) or is_kernel_fault(exc):
        return False
    if isinstance(exc, (TransientError, ConnectionError, TimeoutError,
                        InterruptedError)):
        return True
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNOS
    return False


@dataclasses.dataclass
class RetryPolicy:
    """Exponential backoff + jitter + deadline over transient errors.

    ``call(fn)`` returns ``(result, attempts)``; on final failure the last
    exception is re-raised with ``_retry_attempts`` attached so callers can
    record how many attempts were burned. A kernel fault is re-raised at
    its first attempt whatever ``classify`` says.
    """

    max_attempts: int = 3
    base_delay: float = 0.1
    max_delay: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.25          # fraction of the delay randomized away
    deadline: float | None = None  # seconds budget across ALL attempts
    seed: int = 0
    classify: Callable[[BaseException], bool] | None = None
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        """Backoff before attempt ``attempt + 1`` (attempt is 1-based)."""
        d = min(self.max_delay, self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            d *= 1.0 - self.jitter * rng.random()
        return d

    def call(self, fn: Callable[[], Any]) -> tuple[Any, int]:
        from ..utils.cuda_build import is_kernel_fault

        classify = self.classify or is_transient
        rng = random.Random(self.seed)
        start = self.clock()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(), attempt
            except Exception as e:
                e._retry_attempts = attempt  # type: ignore[attr-defined]
                if (
                    attempt >= self.max_attempts or is_kernel_fault(e)
                    or not classify(e)
                ):
                    raise
                delay = self.delay_for(attempt, rng)
                if (
                    self.deadline is not None
                    and self.clock() - start + delay > self.deadline
                ):
                    raise
                self.sleep(delay)


#: module default for reader / checkpoint I/O: a couple of quick retries on
#: transient errors, fail fast on everything else
def default_io_policy() -> RetryPolicy:
    return RetryPolicy(max_attempts=3, base_delay=0.1, max_delay=1.0)
