"""The port's native core (``horovod_tpu_torch/common/native.py`` and its
copy of the C++ sources in ``horovod_tpu_torch/csrc/hvd``).

- The library is built from the port's own sources into
  ``build/horovod_tpu_torch/``, named by a hash that an edited header
  changes; the sources are the JAX package's, code for code (only
  comments differ), plus lines inserted for the port's repairs, each
  hunk naming its own: the world-lost verdict (``hvd_world_lost``: the
  LOST terminal frame and the failures that set it), the stall
  inspector's bound on a silent peer (``GatherWithStallChecks``) and the
  stripe count applied at a frame that runs responses
  (``synced_stripes``); no line of the JAX package's is changed or
  dropped.
- The port's frame parsers read ``tests/golden_wire.json``'s frames as the
  JAX package's do, and accept or refuse (``FrameRejected``) every
  truncated, over-long and byte-flipped frame as those do.
- Three processes through the port's ``NativeCore``: a rank that leaves
  by ``shutdown`` ends the world without ``world_lost()``, one that exits
  without it ends the world with ``world_lost()`` on every other rank.
- Two processes through the port's ``NativeCore`` alone: the join of
  ``tests/test_native.py`` (a rank submits a tensor and joins without
  waiting for it, then contributes zeros to five more allreduces; an
  allgather while it is joined is refused), and
  a stall report that names the tensor one rank withholds (0.5 s warning,
  a 3 s stall).
"""

import dataclasses
import difflib
import json
import os
import re
import shutil
import textwrap

import numpy as np
import pytest

from horovod_tpu.common import native as jnative
from horovod_tpu_torch.common import native as tnative

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
JAX_CSRC = os.path.join(REPO, "horovod_tpu", "csrc")


# What every inserted hunk of the port's core names: the world-lost
# verdict, the stall-checked gather, the stripe count's frame.
REPAIR_MARKS = ("world_lost", '"LOST"', "stall_gather_on_",
                "GatherWithStallChecks", "synced_stripes")


def _code(path):
    """The file's lines with ``//`` comments removed."""
    with open(path) as f:
        return [re.sub(r"\s*//.*$", "", line.rstrip()) for line in f]


def _port_insertions(port, jax):
    """The hunks of code the port's file inserts into the JAX package's
    (blank lines ignored); raises when the port changes or drops a line."""
    a = [line for line in _code(jax) if line.strip()]
    b = [line for line in _code(port) if line.strip()]
    hunks = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, a, b, autojunk=False).get_opcodes():
        assert tag in ("equal", "insert"), (port, tag, a[i1:i2], b[j1:j2])
        if tag == "insert":
            hunks.append(b[j1:j2])
    return hunks


def test_library_builds_from_the_ports_own_sources():
    with open(os.path.join(JAX_CSRC, "Makefile")) as f:
        srcs = re.search(r"SRCS :=(.*?)\n# ", f.read(), re.S).group(1)
    want = [s.split("/")[1] for s in srcs.replace("\\", " ").split()]
    assert list(tnative.SOURCES) == want
    paths = tnative.source_paths()
    port_dir = os.path.join(REPO, "horovod_tpu_torch", "csrc", "hvd")
    assert all(str(p).startswith(port_dir + os.sep) for p in paths)
    assert not any("horovod_tpu" + os.sep in str(p).replace(
        "horovod_tpu_torch", "") for p in paths)
    jax_files = sorted(os.listdir(os.path.join(JAX_CSRC, "hvd")))
    assert sorted(p.name for p in paths) == jax_files
    verdict = {"controller.cc", "controller.h", "operations.cc"}
    for p in paths:
        jax = os.path.join(JAX_CSRC, "hvd", p.name)
        if p.name not in verdict:
            assert _code(p) == _code(jax), p
            continue
        hunks = _port_insertions(p, jax)
        assert hunks, p
        for hunk in hunks:
            assert any(mark in line for line in hunk
                       for mark in REPAIR_MARKS), (p, hunk)
    lib = tnative.build()
    assert lib == tnative.library_path() and lib.is_file()
    assert lib.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR == tnative.PACKAGE_DIR.parent / "build" / \
        "horovod_tpu_torch"
    assert tnative.load_library() is not None


def test_an_edited_header_renames_the_library(tmp_path, monkeypatch):
    copy = tmp_path / "hvd"
    shutil.copytree(tnative.CSRC_DIR, copy)
    monkeypatch.setattr(tnative, "CSRC_DIR", copy)
    before = tnative.library_path()
    assert before.name.startswith("libhvdcore-")
    (copy / "common.h").write_text((copy / "common.h").read_text()
                                   + "// edited\n")
    assert tnative.library_path() != before
    (copy / "notes.txt").write_text("not a source\n")
    edited = tnative.library_path()
    (copy / "extra.h").write_text("// a new header\n")
    assert tnative.library_path() != edited


def test_another_toolchain_renames_the_library(tmp_path, monkeypatch):
    # A build directory copied from another host is not loaded as it is.
    before = tnative.library_path()
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'g++ (Other) 99.1.0'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    tnative._toolchain.cache_clear()
    try:
        assert tnative.library_path() != before
        monkeypatch.setattr(tnative.platform, "machine", lambda: "other")
        other = tnative.library_path()
        tnative._toolchain.cache_clear()
        assert tnative.library_path() != other
    finally:
        tnative._toolchain.cache_clear()


with open(os.path.join(TESTS_DIR, "golden_wire.json")) as _f:
    GOLDEN = {k: bytes.fromhex(v)
              for k, v in json.load(_f)["frames"].items()}
FAMILIES = {"response": "parse_response_list", "delta": "parse_delta_frame",
            "aggregate": "parse_aggregate_frame",
            "resume": "parse_resume_frame"}


def _verdict(module, family, frame):
    """("ok", parsed fields) or ("rejected", None)."""
    try:
        out = getattr(module, FAMILIES[family])(frame)
    except module.FrameRejected:
        return "rejected", None
    if isinstance(out, list):
        return "ok", [dataclasses.asdict(r) for r in out]
    return "ok", dataclasses.asdict(out)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_parser_reads_the_golden_frame_as_the_jax_package(family):
    got, want = (_verdict(m, family, GOLDEN[family])
                 for m in (tnative, jnative))
    assert got == want and got[0] == "ok", (got, want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_parser_refuses_bad_frames_as_the_jax_package(family):
    golden = GOLDEN[family]
    rng = np.random.RandomState(len(golden))
    frames = [golden[:cut] for cut in range(len(golden))]
    frames += [golden + b"\x00", golden + bytes(64)]
    for _ in range(200):
        mut = bytearray(golden)
        for i in rng.randint(0, len(mut), size=rng.randint(1, 4)):
            mut[i] = rng.randint(0, 256)
        frames.append(bytes(mut))
    refused = 0
    for frame in frames:
        got, want = (_verdict(m, family, frame) for m in (tnative, jnative))
        assert got == want, (frame.hex(), got, want)
        refused += got[0] == "rejected"
    assert refused >= len(golden), refused   # every truncation refused


_PRELUDE = """
    import os, sys, time
    import numpy as np
    sys.path.insert(0, os.environ["HVD_REPO"])
    from horovod_tpu_torch.common import native as hn

    rank = int(sys.argv[1]); port = int(sys.argv[2])
    core = hn.NativeCore()
    assert core.available
    assert core.init(rank=rank, size=2, local_rank=0, local_size=1,
        cross_rank=rank, cross_size=2, coordinator_addr="127.0.0.1",
        coordinator_port=port, my_host="127.0.0.1", cycle_time_ms=1.0,
        fusion_threshold=64 << 20, cache_capacity=64,
        stall_warning_sec=STALL_WARNING, stall_shutdown_sec=0.0,
        stall_check_enabled=True,
        exec_callback=lambda r, i: core.response_done(i, False, "n/a"))

    def allreduce(name, x):
        h = core.enqueue(name, hn.OP_ALLREDUCE, 1, 7, x.shape,
                         data_ptr=x.ctypes.data, output_ptr=x.ctypes.data,
                         plane=hn.PLANE_HOST)
        r, err = core.wait(h); assert r == 1, err
"""

_JOIN_WORKER = textwrap.dedent(_PRELUDE.replace("STALL_WARNING", "60.0") + """
    for i in range(2):
        x = np.full(4, float(rank + 1), np.float32)
        allreduce(f"j.{i}", x)
        assert np.allclose(x, 3.0), x
    # Rank 1 submits j.late and joins without waiting for it: the
    # collective waits for rank 0's submission and carries rank 1's data.
    y = np.full(4, float(rank + 1), np.float32)
    if rank == 1:
        hy = core.enqueue("j.late", hn.OP_ALLREDUCE, 1, 7, y.shape,
                          data_ptr=y.ctypes.data, output_ptr=y.ctypes.data,
                          plane=hn.PLANE_HOST)
        jh = core.join()           # leaves after 3 of 8 allreduces
        r, err = core.wait(jh); assert r == 1, err
        r, err = core.wait(hy); assert r == 1, err
        assert np.allclose(y, 3.0), y
    else:
        time.sleep(0.3)            # let rank 1's submission and join land
        allreduce("j.late", y)
        assert np.allclose(y, 3.0), y
        for i in range(2, 7):
            x = np.full(4, 5.0, np.float32)
            allreduce(f"j.{i}", x)
            assert np.allclose(x, 5.0), x   # rank 1 contributes zeros
        d = np.ones(3, np.float32); out = np.zeros(6, np.float32)
        h = core.enqueue("j.ag", hn.OP_ALLGATHER, 1, 7, d.shape,
                         data_ptr=d.ctypes.data, output_ptr=out.ctypes.data,
                         plane=hn.PLANE_HOST)
        r, err = core.wait(h)
        assert r == -1 and "not supported with Join" in err, (r, err)
        jh = core.join()
        r, err = core.wait(jh); assert r == 1, err
    assert core.last_joined() == 0, core.last_joined()
    core.shutdown()
    print(f"JOIN_{rank}_OK")
""")

_STALL_WORKER = textwrap.dedent(_PRELUDE.replace("STALL_WARNING", "0.5") + """
    x = np.full(4, float(rank + 1), np.float32)
    if rank == 0:
        h = core.enqueue("st.warn", hn.OP_ALLREDUCE, 1, 7, x.shape,
                         data_ptr=x.ctypes.data, output_ptr=x.ctypes.data,
                         plane=hn.PLANE_HOST)
        report, deadline = "", time.time() + 20.0
        while time.time() < deadline and "st.warn" not in report:
            report += core.stall_report()
            time.sleep(0.1)
        assert "Stalled tensor 'st.warn'" in report, report
        assert "missing ranks: [1]" in report, report
        r, err = core.wait(h); assert r == 1, err
    else:
        time.sleep(3.0)            # 6x the warning time
        allreduce("st.warn", x)
    assert np.allclose(x, 3.0), x
    assert core.stall_report() == ""
    core.shutdown()
    print(f"STALL_{rank}_OK")
""")


_LEAVE_WORKER = textwrap.dedent(
    _PRELUDE.replace("STALL_WARNING", "60.0").replace("size=2", "size=3")
    + """
    leave = sys.argv[3]
    x = np.full(4, float(rank + 1), np.float32)
    allreduce("l.0", x)
    assert np.allclose(x, 6.0), x
    if rank == 2:
        print("LEAVE_2_OK", flush=True)
        if leave == "exit":
            os._exit(0)            # no farewell: its sockets just close
        core.shutdown()
        sys.exit(0)
    # The world ends with rank 2's departure: this submission resolves
    # as aborted on rank 0 (the coordinator) and on rank 1 (a worker).
    h = core.enqueue("l.1", hn.OP_ALLREDUCE, 1, 7, x.shape,
                     data_ptr=x.ctypes.data, output_ptr=x.ctypes.data,
                     plane=hn.PLANE_HOST)
    r, err = core.wait(h) if h >= 0 else (-1, "refused")
    assert r == -1, (r, err)
    assert core.world_lost() == (leave == "exit"), leave
    core.shutdown()
    print(f"LEAVE_{rank}_OK")
""")


@pytest.mark.parametrize("leave", ["shutdown", "exit"])
def test_world_lost_tells_a_lost_rank_from_a_departure(tmp_path, leave):
    """Three ranks; rank 2 leaves by ``shutdown`` (a departure: the
    others' ``world_lost()`` stays false) or exits without it (a lost
    rank: true on the coordinator, and on the other worker through the
    LOST frame)."""
    from proc_harness import run_world

    run_world(tmp_path, _LEAVE_WORKER, "LEAVE", size=3, timeout=120,
              args_for_rank=lambda rank, port: [port, leave])


def test_join_zero_contribution_two_process(tmp_path):
    from proc_harness import run_world

    run_world(tmp_path, _JOIN_WORKER, "JOIN", size=2, timeout=120)


def test_stall_report_names_the_withheld_tensor(tmp_path):
    from proc_harness import run_world

    run_world(tmp_path, _STALL_WORKER, "STALL", size=2, timeout=120)
