"""Test-problem generators (the reference's example/test matrices)."""

from .generators import (  # noqa: F401
    clement, clement_eigenvalues, random_hermitian,
)
