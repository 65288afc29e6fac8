"""The port's kernel build (``horovod_tpu_torch/ops/_build.py``) on the CPU.

A library is named by a hash of its source, the headers beside it and the
flags, so editing a shared ``csrc/*.cuh`` header builds anew instead of
loading a library compiled from the old header. Nothing here compiles:
``library_path`` only names the file.
"""

import pytest

from horovod_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    return tmp_path


def test_library_path_follows_a_header_edit(csrc):
    before = _build.library_path("kern")
    (csrc / "common.cuh").write_text("// v2\n")
    assert _build.library_path("kern") != before


def test_library_path_follows_a_new_header(csrc):
    before = _build.library_path("kern")
    (csrc / "extra.cuh").write_text("// new\n")
    assert _build.library_path("kern") != before


def test_library_path_is_stable_and_ignores_other_files(csrc):
    before = _build.library_path("kern")
    (csrc / "notes.txt").write_text("not a header\n")
    assert _build.library_path("kern") == before
    (csrc / "kern.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build.library_path("kern") != before


def test_the_port_library_hashes_its_header():
    assert (_build.CSRC_DIR / "hopper.cuh").is_file()
    assert _build.library_path("flash_attention").name.startswith(
        "libflash_attention-")
