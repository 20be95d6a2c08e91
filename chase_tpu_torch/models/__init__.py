"""Test-problem generators (the reference's example/test matrices)."""

from .generators import (  # noqa: F401
    clement, clement_eigenvalues, hermitian_sequence, random_hermitian,
)
