"""The port's native core under the sanitizers (``HOROVOD_NATIVE_SANITIZE``,
``horovod_tpu_torch/common/native.py``).

- ``tsan`` and ``asan`` build ``libhvdcore-<hash>-{tsan,asan}.so`` from
  the port's ``csrc/hvd`` beside the production library, with the
  sanitizer flags in the hash; "", "0", "none" and "off" mean the
  production library, any other value warns and is ignored; a variant
  that does not build raises, and one whose sanitizer runtime the
  process lacks raises with the ``LD_PRELOAD`` recipe.
- The port's stress harness (``csrc/testing/stress_core.cc``: the JAX
  package's phases plus the world-lost verdict across DRAIN and EVICT
  rounds, a lost rank, a departure, a shutdown and a re-init) runs
  against the TSan and the ASan+UBSan variant with zero reports, and
  leaves no shm segment behind.
- The multi-process worlds of ``tests/test_torch_native.py`` (a lost
  rank and a departure, join, stall) run on the TSan variant, its
  runtime preloaded into every worker: no ThreadSanitizer warning in any
  worker. A planted race in the same setting is reported, so the
  silence means something.

Skips, as the JAX package's ``tests/test_native_tsan.py`` does, where
the toolchain cannot give a trustworthy run: no compiler, no sanitizer
runtime, or a TSan that reports a race in a known-correct program.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

import test_torch_native as native_worlds
from horovod_tpu_torch.common import config as tconfig
from horovod_tpu_torch.common import native as tnative
from proc_harness import REPO, free_port

# A race in an instrumented library that Python threads call through
# ctypes: the setting of the worlds below, with a fault planted. The two
# calls meet on a relaxed counter (no happens-before for TSan) before
# they write: the GIL's handoffs order whatever a call does before it
# releases the GIL or after it takes it back, so a race between calls
# that never overlap would not be seen.
_RACE_LIB = r"""
#include <atomic>
static std::atomic<int> arrived{0};
static volatile long shared = 0;
extern "C" void bump(int n) {
  arrived.fetch_add(1, std::memory_order_relaxed);
  while (arrived.load(std::memory_order_relaxed) < 2) {}
  for (int i = 0; i < n; ++i) shared = shared + 1;
}
"""
_RACE_CALLER = textwrap.dedent("""
    import ctypes, sys, threading
    lib = ctypes.CDLL(sys.argv[1])
    ts = [threading.Thread(target=lib.bump, args=(1000,))
          for _ in range(2)]
    for t in ts: t.start()
    for t in ts: t.join()
""")

TSAN_ENV = {"TSAN_OPTIONS": "exitcode=66 halt_on_error=0"}
ASAN_ENV = {"ASAN_OPTIONS": "detect_leaks=0 abort_on_error=0 exitcode=67",
            "UBSAN_OPTIONS": "halt_on_error=1 print_stacktrace=1"}


def _compiler():
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        pytest.skip("no C++ compiler on PATH")
    return cxx


@pytest.fixture(scope="module")
def tsan(tmp_path_factory):
    """The TSan variant and the harness built against it, after the
    probe shows the runtime is sound; (variant, harness, runtime)."""
    _compiler()
    tmp = tmp_path_factory.mktemp("tsan")
    why = tnative.probe_sanitizer("tsan", tmp)
    if why:
        pytest.skip(f"TSan cannot be trusted here: {why}")
    harness = tnative.build_stress_harness("tsan", tmp)
    runtime = subprocess.run(
        [_compiler(), f"-print-file-name={tnative.SANITIZE_RUNTIME['tsan']}"],
        capture_output=True, text=True, check=True).stdout.strip()
    return tnative.build("tsan"), harness, runtime


@pytest.fixture(scope="module")
def asan(tmp_path_factory):
    _compiler()
    tmp = tmp_path_factory.mktemp("asan")
    why = tnative.probe_sanitizer("asan", tmp)
    if why:
        pytest.skip(f"ASan+UBSan cannot be trusted here: {why}")
    return tnative.build_stress_harness("asan", tmp)


def assert_no_segments():
    from conftest import tagged_shm_segments

    leaked = tagged_shm_segments(os.environ.get("HVD_TEST_WORLD_TAG", ""))
    assert not leaked, f"the stress harness leaked shm segments: {leaked}"


def run_harness(binary, env):
    r = subprocess.run([str(binary)], capture_output=True, text=True,
                       timeout=600, env={**os.environ, **env})
    report = r.stdout + r.stderr
    assert r.returncode == 0, report[-4000:]
    assert "STRESS_OK" in r.stdout, report[-4000:]
    # Every phase ran: the shm phase's forced-attach leg warns, the
    # liveness rounds log DRAIN and EVICT, and each round's verdict is
    # the one the harness checked.
    assert "force-failed" in report, report[-4000:]
    assert "DRAIN rank=1" in report and "EVICT rank=1" in report, \
        report[-4000:]
    for rnd in range(6):
        kind, lost = ("EVICT", 1) if rnd % 2 else ("DRAIN", 0)
        assert f"LIVENESS round={rnd} {kind} world_lost={lost}" in \
            r.stdout, r.stdout
    assert "WORLDLOST round=0 rank1=exit world_lost=1" in r.stdout
    assert "WORLDLOST round=1 rank1=shutdown world_lost=0" in r.stdout
    assert_no_segments()
    return report


def test_stress_harness_is_tsan_clean(tsan):
    report = run_harness(tsan[1], TSAN_ENV)
    assert "WARNING: ThreadSanitizer" not in report, report[-4000:]


@pytest.mark.slow
def test_stress_harness_is_asan_clean(asan):
    """The same phases under ASan+UBSan: the use-after-free family (a
    getter reading a ring that shutdown freed). Leak checking is off: the
    process-global state is immortal on purpose. ``slow``: the ASan+UBSan
    variant takes ~35 s to build on 8 idle cores, the harness ~10 s
    more."""
    report = run_harness(asan, ASAN_ENV)
    assert "ERROR: AddressSanitizer" not in report, report[-4000:]
    assert "runtime error:" not in report, report[-4000:]


def test_stress_harness_on_the_production_core(tmp_path):
    """What chip_smoke (o) runs where the host's g++ has no TSan: the
    same phases against the production core, with its flags."""
    _compiler()
    run_harness(tnative.build_stress_harness("", tmp_path), {})


def test_a_planted_race_is_reported_through_python(tsan, tmp_path):
    lib = tmp_path / "librace.so"
    (tmp_path / "race.cc").write_text(_RACE_LIB)
    subprocess.run([_compiler(), "-O1", "-g", "-std=c++17", "-shared",
                    "-fPIC", "-fsanitize=thread", str(tmp_path / "race.cc"),
                    "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    r = subprocess.run([sys.executable, "-c", _RACE_CALLER, str(lib)],
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "LD_PRELOAD": tsan[2],
                            "TSAN_OPTIONS": "exitcode=66"})
    assert "WARNING: ThreadSanitizer: data race" in r.stderr, r.stderr
    assert r.returncode == 66, r.returncode


# The worlds of tests/test_torch_native.py; each worker also checks it
# loaded the TSan variant.
_LOADED_TSAN = ("core = hn.NativeCore()\n"
                "assert hn._lib._name.endswith('-tsan.so'), hn._lib._name\n")
WORLDS = {
    "rank_lost": (native_worlds._LEAVE_WORKER, "LEAVE", 3, ["exit"]),
    "rank_leaves": (native_worlds._LEAVE_WORKER, "LEAVE", 3, ["shutdown"]),
    "join": (native_worlds._JOIN_WORKER, "JOIN", 2, []),
    "stall": (native_worlds._STALL_WORKER, "STALL", 2, []),
}


WORLD_TIMEOUT_S = 180


@pytest.fixture(scope="module")
def tsan_worlds(tsan, tmp_path_factory):
    """Every world of ``WORLDS`` at once on the TSan variant, each worker
    with the runtime preloaded and its reports in the world's directory:
    world -> (each rank's exit code and output, the reports)."""
    started = {}
    for world, (text, _, size, args) in WORLDS.items():
        tmp = tmp_path_factory.mktemp(world)
        worker = text.replace("core = hn.NativeCore()\n", _LOADED_TSAN, 1)
        assert worker != text
        (tmp / "worker.py").write_text(worker)
        env = dict(os.environ, HVD_REPO=REPO, HOROVOD_NATIVE_SANITIZE="tsan",
                   LD_PRELOAD=tsan[2], TSAN_OPTIONS=(
                       f"exitcode=66 halt_on_error=0 log_path={tmp}/tsan"))
        port = free_port()
        started[world] = (tmp, [subprocess.Popen(
            [sys.executable, str(tmp / "worker.py"), str(r), str(port),
             *args], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(size)])
    ended = {}
    try:
        for world, (tmp, procs) in started.items():
            runs = [(p.communicate(timeout=WORLD_TIMEOUT_S)[0], p.returncode)
                    for p in procs]
            reports = "".join(f.read_text() for f in tmp.glob("tsan*"))
            ended[world] = runs, reports
    finally:
        for _, procs in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return ended


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_native_world_is_tsan_clean(tsan_worlds, world):
    sentinel = WORLDS[world][1]
    runs, reports = tsan_worlds[world]
    for rank, (out, code) in enumerate(runs):
        assert code == 0 and f"{sentinel}_{rank}_OK" in out, (rank, out)
    assert "WARNING: ThreadSanitizer" not in reports, reports[-8000:]


# ---- the knob and the build ------------------------------------------------


@pytest.mark.parametrize("value,want", [
    ("", ""), ("0", ""), ("none", ""), ("off", ""), ("OFF", ""),
    ("tsan", "tsan"), (" ASan ", "asan")])
def test_knob_values(monkeypatch, value, want):
    monkeypatch.setenv("HOROVOD_NATIVE_SANITIZE", value)
    assert tconfig.native_sanitize() == want


def test_unknown_value_warns_and_is_ignored(monkeypatch, capfd):
    monkeypatch.setenv("HOROVOD_NATIVE_SANITIZE", "msan")
    assert tconfig.native_sanitize() == ""
    assert "HOROVOD_NATIVE_SANITIZE='msan'" in capfd.readouterr().err
    assert tnative.library_path() == tnative.library_path("")


def test_variants_are_named_beside_the_production_library(monkeypatch):
    monkeypatch.delenv("HOROVOD_NATIVE_SANITIZE", raising=False)
    prod = tnative.library_path()
    paths = {san: tnative.library_path(san) for san in ("tsan", "asan")}
    for san, path in paths.items():
        assert path.parent == prod.parent == tnative.BUILD_DIR
        assert path.name.startswith("libhvdcore-")
        assert path.name.endswith(f"-{san}.so")
        monkeypatch.setenv("HOROVOD_NATIVE_SANITIZE", san)
        assert tnative.library_path() == path
        assert tnative.cxxflags() == tnative.SANITIZE_FLAGS[san]
    assert tnative.SANITIZE_FLAGS["tsan"][:2] == ["-O1", "-g"]
    assert "-fsanitize=thread" in tnative.SANITIZE_FLAGS["tsan"]
    assert "-fsanitize=address,undefined" in tnative.SANITIZE_FLAGS["asan"]
    # The hash covers the flags: other flags, another name.
    before = paths["tsan"]
    monkeypatch.setitem(tnative.SANITIZE_FLAGS, "tsan",
                        tnative.SANITIZE_FLAGS["tsan"] + ["-DOTHER"])
    assert tnative.library_path("tsan") != before


def test_a_variant_that_does_not_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setitem(tnative.SANITIZE_FLAGS, "tsan",
                        ["-fsanitize=no-such-sanitizer"])
    with pytest.raises(RuntimeError, match="native core build failed"):
        tnative.build("tsan")
    assert not tnative.library_path("tsan").exists()
    assert not tnative.library_path("").exists()


@pytest.mark.parametrize("san", ["tsan", "asan"])
def test_a_variant_without_its_runtime_raises_with_the_recipe(san):
    """In a process without the runtime preloaded, loading the variant
    raises before ``dlopen`` (ASan's runtime would end the process
    there), naming ``LD_PRELOAD`` and the runtime."""
    code = textwrap.dedent("""
        import sys
        from horovod_tpu_torch.common import native as n
        try:
            n.load_library()
        except RuntimeError as e:
            print("RAISED", e)
            sys.exit(0)
        sys.exit(1)
    """)
    env = {k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}
    env["HOROVOD_NATIVE_SANITIZE"] = san
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    runtime = tnative.SANITIZE_RUNTIME[san]
    assert f"LD_PRELOAD=$(g++ -print-file-name={runtime})" in r.stdout
    assert f"-{san}.so" in r.stdout


def test_the_harness_source_is_the_ports_own():
    """Its core headers are the port's (``csrc/hvd``), and no import
    builds it."""
    text = tnative.STRESS_SOURCE.read_text()
    includes = [line for line in text.splitlines()
                if line.startswith('#include "')]
    assert includes and all(line.startswith('#include "../hvd/')
                            for line in includes), includes
    assert "horovod_tpu/" not in text
