"""The port's kernel build (``horovod_tpu_torch/ops/_build.py``) on the CPU.

A library is named by a hash of its source, the headers beside it and the
flags, so editing a shared ``csrc/*.cuh`` header builds anew instead of
loading a library compiled from the old header. A source compiles in
parts, each its own translation unit, and links them. Nothing
here compiles: ``library_path`` only names the file, and
``build_commands`` only lists the compiler's commands.
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


def test_a_source_in_parts_compiles_each_part_then_links(csrc, monkeypatch):
    """Each part is one ``nvcc -c`` with its ``HVD_PART``, and the last
    command links their objects into the library; a variant's macros reach
    every part and rename the library."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    *parts, link = _build.build_commands("kern", "lib.so")
    assert [c[c.index("-o") + 1] for c in parts] == [
        f"lib.so.{i}.o" for i in range(_build.PARTS)]
    for i, cmd in enumerate(parts):
        assert f"-DHVD_PART={i}" in cmd and "-c" in cmd
        assert "-shared" not in cmd and cmd[-1] == str(csrc / "kern.cu")
    assert "-shared" in link
    assert link[-_build.PARTS:] == [f"lib.so.{i}.o"
                                    for i in range(_build.PARTS)]
    assert link[link.index("-o") + 1] == "lib.so"
    *variant, _ = _build.build_commands("kern", "lib.so", defines=["CHECK"])
    assert all("-DCHECK" in cmd for cmd in variant)
    assert _build.library_path("kern", ["CHECK"]) != _build.library_path(
        "kern")
