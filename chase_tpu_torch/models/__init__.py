"""Test-problem generators (the reference's example/test matrices)."""

from .generators import (  # noqa: F401
    clement, clement_eigenvalues, hermitian_sequence, random_hermitian,
    random_pseudo_hermitian, structured_pseudo_hermitian,
)
