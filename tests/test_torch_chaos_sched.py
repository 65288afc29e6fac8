"""The port's chaos schedule inspector against ``tools/chaos_sched.py``.

``horovod_tpu_torch.tools.chaos_sched`` compiles a ``HOROVOD_CHAOS_SPEC``
with the port's own ``common/config.parse_chaos_spec``; for every spec
and world size below its ``schedule_record``, ``to_fault_spec`` and CLI
output (both formats, the spec from the flag or the environment) equal
the JAX tool's exactly, and a bad spec exits 2 on both.
"""

import json

import pytest

from horovod_tpu_torch.tools import chaos_sched as port
from tools import chaos_sched as ref

SPECS = [
    "seed=7,n=4",
    "seed=7,n=4,kinds=drop_conn",
    "seed=1,n=6,kinds=delay_ms|exit|raise,ms=12.5,code=3",
    "seed=42,n=3,points=ring.exec|xla.exec|zero.gather,steps=2-9",
    "seed=9,n=5,ranks=1|3,kinds=exit|delay_ms",
    "seed=0,n=0",
]
SIZES = [0, 1, 2, 8, 64]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("size", SIZES)
def test_schedule_and_fault_spec_match(spec, size, monkeypatch):
    monkeypatch.setenv("HOROVOD_SIZE", "4")   # the pool at size 0
    assert port.schedule_record(spec, size) == ref.schedule_record(spec,
                                                                   size)
    assert port.to_fault_spec(spec, size) == ref.to_fault_spec(spec, size)


def _cli(main, argv, capsys):
    code = main(argv)
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.mark.parametrize("fmt", ["json", "fault-spec"])
@pytest.mark.parametrize("spec", SPECS[:4])
def test_cli_output_matches(spec, fmt, capsys, monkeypatch):
    argv = ["--spec", spec, "--size", "8", "--format", fmt]
    assert _cli(port.main, argv, capsys) == _cli(ref.main, argv, capsys)
    monkeypatch.setenv("HOROVOD_CHAOS_SPEC", spec)
    argv = ["--size", "8", "--format", fmt]
    got = _cli(port.main, argv, capsys)
    assert got == _cli(ref.main, argv, capsys)
    assert got[0] == 0
    if fmt == "json":
        assert json.loads(got[1])["spec"] == spec


@pytest.mark.parametrize("spec", ["seed=1", "seed=1,n=2,kinds=melt",
                                  "seed=1,n=2,steps=5", "seed=1,n=2,x=3"])
def test_bad_specs_exit_2(spec, capsys):
    argv = ["--spec", spec, "--size", "4"]
    got = _cli(port.main, argv, capsys)
    assert got == _cli(ref.main, argv, capsys)
    assert got[0] == 2 and got[2].startswith("chaos_sched: ")


def test_no_spec_is_refused(capsys, monkeypatch):
    monkeypatch.delenv("HOROVOD_CHAOS_SPEC", raising=False)
    for main in (port.main, ref.main):
        with pytest.raises(SystemExit) as e:
            main(["--size", "4"])
        assert e.value.code == 2
    capsys.readouterr()
