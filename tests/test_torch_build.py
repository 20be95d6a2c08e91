"""The port's kernel build (chase_tpu_torch/_build.py).

A library is cached under a name made by ``source_digest``: it must cover
every ``csrc/*.cu`` and ``*.cuh`` file and the nvcc flags, so that an
edited header never loads a stale library.  These tests edit a copy of
``csrc/`` and need no nvcc.
"""

import re
import shutil

import pytest

from chase_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, d)
    return d


def test_digest_of_a_copy_equals_the_package_digest(csrc):
    assert (_build.source_digest("ring_hemm", csrc)
            == _build.source_digest("ring_hemm"))


@pytest.mark.parametrize("edit", ["header", "kernel_source", "new_header",
                                  "removed_header"])
def test_digest_changes_when_a_source_changes(csrc, edit):
    before = _build.source_digest("ring_hemm", csrc)
    header = csrc / "hopper_tf32.cuh"
    if edit == "header":
        header.write_text(header.read_text() + "\n// one more line\n")
    elif edit == "kernel_source":
        src = csrc / "ring_hemm.cu"
        src.write_text(src.read_text().replace("STAGES = 4", "STAGES = 3"))
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        header.unlink()
    assert _build.source_digest("ring_hemm", csrc) != before


def test_digest_covers_flags_and_library_name(csrc):
    base = _build.source_digest("ring_hemm", csrc)
    assert _build.source_digest(
        "ring_hemm", csrc, _build.NVCC_FLAGS + ("-lineinfo",)) != base
    assert _build.source_digest("other", csrc) != base


def test_digest_ignores_files_nvcc_does_not_read(csrc):
    base = _build.source_digest("ring_hemm", csrc)
    (csrc / "NOTES.txt").write_text("not a source")
    assert _build.source_digest("ring_hemm", csrc) == base


def test_every_quoted_include_is_a_hashed_file():
    """The kernel's own headers live in csrc/ with a hashed suffix, so
    hashing csrc/ covers the include graph."""
    for src in _build.CSRC_DIR.iterdir():
        if src.suffix not in (".cu", ".cuh"):
            continue
        for inc in re.findall(r'^#include\s+"([^"]+)"', src.read_text(),
                              re.MULTILINE):
            path = _build.CSRC_DIR / inc
            assert path.is_file() and path.suffix in (".cu", ".cuh"), inc


def test_no_nvcc_raises_instead_of_loading(tmp_path, monkeypatch, csrc):
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library.__wrapped__("ring_hemm")
    assert not list((tmp_path / "build").glob("*.so"))
