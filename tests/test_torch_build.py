"""kernels/build.py: a CUDA library's file name hashes everything its
source compiles from, so an edited source or shared header never loads a
stale build. No nvcc is needed: only the names are computed."""

import re
import shutil

import pytest

from midi_emotion_tpu_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that build.py reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy)
    monkeypatch.setattr(build, "CSRC_DIR", copy)
    return copy


def _paths():
    return {name: build.library_path(name) for name in build.CUDA_SOURCES}


def test_header_edit_changes_the_includers_libraries(csrc):
    before = _paths()
    header = csrc / "hopper_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    for name in ("flash_rel_attn_fwd", "flash_rel_attn_bwd"):
        assert after[name] != before[name], name


def test_decode_header_edit_changes_both_decode_libraries(csrc):
    """decode_attn_stacked.cuh holds kernel 13, which decode_attn_stacked.cu
    builds up to d_head 256 and decode_attn_wide.cu past it."""
    before = _paths()
    header = csrc / "decode_attn_stacked.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    for name in ("decode_attn_stacked", "decode_attn_wide"):
        assert after[name] != before[name], name
        assert '#include "decode_attn_stacked.cuh"' in (csrc / f"{name}.cu").read_text(), name


@pytest.mark.parametrize("name", build.CUDA_SOURCES)
def test_source_edit_changes_only_its_library(csrc, name):
    before = _paths()
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _paths()
    assert {n for n in after if after[n] != before[n]} == {name}


def test_every_local_include_is_a_hashed_header():
    """Each ``#include "..."`` of a source names a header in csrc/, which
    library_path hashes."""
    headers = {p.name for p in build.CSRC_DIR.glob("*.cuh")}
    for name in build.CUDA_SOURCES:
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        for inc in re.findall(r'#include\s+"([^"]+)"', text):
            assert inc in headers, (name, inc)
    assert "hopper_sm90.cuh" in headers
