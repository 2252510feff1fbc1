"""Exception hierarchy (reference: siddhi-core exception/ — 17 types, plus
query-compiler SiddhiParserException).  Parser errors carry line/column of the
offending token, mirroring the reference's query-context indices."""
from __future__ import annotations


class SiddhiAppCreationError(Exception):
    """App could not be planned/validated."""


class SiddhiParserException(Exception):
    def __init__(self, message: str, line: int = -1, col: int = -1):
        self.line = line
        self.col = col
        if line >= 0:
            message = f"{message} (line {line}, col {col})"
        super().__init__(message)


class SiddhiAppValidationException(SiddhiAppCreationError):
    pass


class DuplicateDefinitionError(SiddhiAppValidationException):
    pass


class DuplicateAttributeError(SiddhiAppValidationException):
    pass


class AttributeNotExistError(SiddhiAppValidationException):
    pass


class DefinitionNotExistError(SiddhiAppValidationException):
    pass


class OperationNotSupportedError(Exception):
    pass


class ExtensionNotFoundError(SiddhiAppCreationError):
    pass


class SiddhiAppRuntimeException(Exception):
    """Runtime event-processing failure (routed to @OnError handling)."""


class BufferOverflowError(SiddhiAppRuntimeException):
    """An @Async junction buffer stayed full past the bounded admission
    timeout (overload='BLOCK'), or an overload policy rejected events.
    Routed through the stream's @OnError path like any runtime failure."""


class PoisonEventError(SiddhiAppRuntimeException):
    """An ingested event failed the quarantine validator (NaN/Inf
    payload, non-coercible type, or a timestamp outside the admissible
    window) and was routed to the error store instead of device state."""


class DispatchStormError(SiddhiAppRuntimeException):
    """The dispatch-storm watchdog tripped: a timer target re-fired with
    zero ingest progress and was force-disarmed (WD0xx incident)."""


class StoreQueryCreationError(SiddhiAppCreationError):
    pass


class CannotRestoreStateError(SiddhiAppRuntimeException):
    """A snapshot could not be restored.  When the restore was refused
    by the schema verifier (core/stateschema.py), ``code`` names the
    first SC0xx diagnostic and ``findings`` carries the full
    (code, message) diff list."""

    def __init__(self, message: str = "", *, code=None, findings=None):
        self.findings = list(findings or [])
        self.code = code or (self.findings[0][0] if self.findings else None)
        if not message and self.findings:
            message = "; ".join(f"{c}: {m}" for c, m in self.findings)
        super().__init__(message)

    @classmethod
    def from_findings(cls, findings, context: str = ""):
        head = (f"{context}: " if context else "") + \
            "snapshot is incompatible with this runtime — "
        body = "; ".join(f"{c}: {m}" for c, m in findings)
        return cls(head + body, findings=findings)


class NoPersistenceStoreError(Exception):
    pass


class ConnectionUnavailableError(Exception):
    """Raised by sources/sinks when the transport is down; triggers backoff retry."""


class MappingFailedError(Exception):
    pass
