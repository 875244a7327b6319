"""Structured error checking (the ``PADDLE_ENFORCE*`` family).

The port's own copy of the error types and ``enforce*`` helpers of
``paddle_tpu.core.enforce``, so the two packages raise the same kinds of
error for the same misuse.
"""

from __future__ import annotations

from typing import Any, NoReturn

__all__ = [
    "EnforceNotMet",
    "ExecuteError",
    "InvalidArgumentError",
    "NotFoundError",
    "PreconditionNotMetError",
    "PsTransportError",
    "QuotaExceededError",
    "ThrottledError",
    "UnavailableError",
    "WrongShardError",
    "WrongTenantError",
    "enforce",
    "enforce_eq",
    "enforce_le",
]


class EnforceNotMet(RuntimeError):
    """Base error for all enforce failures (``platform::EnforceNotMet``)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class PsTransportError(PreconditionNotMetError):
    """A PS connection died (reset, refused or past its deadline): the
    framed stream is undefined and the server may be gone. Distinct from
    a server's rejection of a request (``PreconditionNotMetError``,
    ``NotFoundError``), which leaves the connection usable."""


class WrongShardError(PreconditionNotMetError):
    """A keyed PS data op carried a key outside the addressed server's
    (modulus, residue) ownership class (the service's ``kErrWrongShard``):
    the client routed with a stale shard topology, because a live reshard
    (``ps.reshard``) moved the key's residue class. The server rejected the
    frame whole (no state changed), so the client re-resolves the routing
    table and replays exactly the bounced keys. Not a transport error: the
    server answered, so the breaker and failover paths stay cold."""


class WrongTenantError(PreconditionNotMetError):
    """A PS request crossed a tenant-namespace fence (the service's
    ``kErrWrongTenant``): the frame addressed a table outside the
    connection's bound tenant (the table id's high byte, ``ps.tenancy``),
    named an unknown tenant or a bad hello token, or was an operator-plane
    command from a tenant connection. Rejected whole before any state
    change or oplog tap. Not a transport error and not retryable: the same
    frame on the same connection fails the same way."""


class QuotaExceededError(PreconditionNotMetError):
    """The tenant's enforced row or SSD-byte quota is exhausted (the
    service's ``kErrQuota``): the server refused a row-creating command
    whole, pushes included (their insert creates rows). Another tenant's
    rows are never evicted to make room. Not retryable without freeing
    space."""


class ThrottledError(PreconditionNotMetError):
    """The tenant's token-bucket request budget is dry (the service's
    ``kErrThrottled``): the frame was shed before any state change, with
    the server's suggested backoff in ``retry_after_ms``. Retryable after
    that long; serve-class (pclass 0) tenants queue briefly server-side
    before this surfaces, batch classes shed at once."""

    def __init__(self, msg: str = "", retry_after_ms: int = 0):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)


class UnavailableError(EnforceNotMet):
    pass


class ExecuteError(EnforceNotMet):
    """Shell/filesystem command failure (fleet/utils/fs.py ExecuteError)."""


def _fail(err_cls: type, msg: str) -> NoReturn:
    raise err_cls(msg)


def enforce(cond: Any, msg: str = "", err_cls: type = PreconditionNotMetError) -> None:
    if not cond:
        _fail(err_cls, msg or "enforce failed")


def enforce_eq(a: Any, b: Any, msg: str = "") -> None:
    if a != b:
        _fail(InvalidArgumentError, f"expected {a!r} == {b!r}. {msg}")


def enforce_le(a: Any, b: Any, msg: str = "") -> None:
    if not a <= b:
        _fail(InvalidArgumentError, f"expected {a!r} <= {b!r}. {msg}")
