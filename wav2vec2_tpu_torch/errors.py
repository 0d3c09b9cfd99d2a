"""Error types for the alignment framework.

Mirrors the four-variant error enum of the reference implementation
(the Rust reference, src/error.rs:3-47): Io, Json, Runtime{context,message},
InvalidInput — expressed as an exception hierarchy, the idiomatic Python
equivalent of a Rust error enum.
"""

from __future__ import annotations


class AlignmentError(Exception):
    """Base class for all alignment framework errors."""


class IoError(AlignmentError):
    """Filesystem / IO failure (reference: AlignmentError::Io)."""

    def __init__(self, context: str, cause: BaseException | str):
        super().__init__(f"io error while {context}: {cause}")
        self.context = context
        self.cause = cause


class JsonError(AlignmentError):
    """JSON parse failure (reference: AlignmentError::Json)."""

    def __init__(self, context: str, cause: BaseException | str):
        super().__init__(f"json error while {context}: {cause}")
        self.context = context
        self.cause = cause


class RuntimeBackendError(AlignmentError):
    """Model runtime / device failure (reference: AlignmentError::Runtime)."""

    def __init__(self, context: str, message: str):
        super().__init__(f"runtime error [{context}]: {message}")
        self.context = context
        self.message = message


class InvalidInputError(AlignmentError):
    """Caller provided invalid input (reference: AlignmentError::InvalidInput)."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message
