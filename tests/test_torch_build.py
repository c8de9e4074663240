"""The port's kernel build: a library's tag names the source, every local
header it includes and the compiler flags, so an edited header rebuilds.
No ``nvcc`` is needed to compute a tag."""
import pathlib
import shutil

import pytest

from repro_torch.kernels import _build, flash

FLAGS = flash.NVCC_FLAGS


@pytest.fixture
def csrc(tmp_path) -> pathlib.Path:
    out = tmp_path / "csrc"
    shutil.copytree(flash.CSRC, out)
    return out


def test_tag_follows_an_included_header(csrc):
    tags = {stem: _build.library_tag(csrc / f"{stem}.cu", FLAGS)
            for stem in flash.STEMS}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {stem: _build.library_tag(csrc / f"{stem}.cu", FLAGS)
             for stem in flash.STEMS}
    for stem in ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"):
        assert after[stem] != tags[stem]
    for stem in ("flash_fwd", "flash_bwd"):     # include no local header
        assert after[stem] == tags[stem]


def test_tag_follows_source_flags_and_nested_headers(csrc):
    src = csrc / "flash_fwd_sm90.cu"
    assert _build.local_headers(src) == [(csrc / "sm90.cuh").resolve()]
    tag = _build.library_tag(src, FLAGS)
    assert _build.library_tag(src, FLAGS) == tag
    assert _build.library_tag(src, FLAGS + ("-lineinfo",)) != tag
    (csrc / "inner.cuh").write_text("#pragma once\n")
    header = csrc / "sm90.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    tag2 = _build.library_tag(src, FLAGS)
    assert tag2 != tag
    assert (csrc / "inner.cuh").resolve() in _build.local_headers(src)
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert _build.library_tag(src, FLAGS) != tag2
    src.write_text(src.read_text() + "\n")
    assert _build.library_tag(src, FLAGS) not in (tag, tag2)


def test_unchanged_sources_keep_the_tag_of_a_plain_hash():
    """A source without local headers keeps the tag it had when the tag
    hashed only the source and the flags: its built library is reused."""
    import hashlib
    src = flash.SOURCES["flash_fwd"]
    plain = hashlib.sha256(src.read_bytes()
                           + " ".join(FLAGS).encode()).hexdigest()[:16]
    assert _build.library_tag(src, FLAGS) == plain
