"""Misc utilities."""

from .validation import (  # noqa: F401
    orthonormality_error, residual_norms, validate_result)
