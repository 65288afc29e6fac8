"""The port's logger (``horovod_tpu_torch/common/logging.py``) writes each
record to the ``sys.stderr`` of its moment.

Under ``pytest -n 6 --dist loadfile`` one worker process runs many test
files, and pytest swaps ``sys.stderr`` for a capture in every test. A
handler that kept the stream of its first use went on writing into that
test's capture, so a later test reading fd 2 (``capfd``) saw none of the
port's warnings. The tests below run in this order in one process: a
first use while ``sys.stderr`` is another stream, then warnings read by
``capfd``, among them
``tests/test_torch_native_sanitize.py``'s check of an unknown
``HOROVOD_NATIVE_SANITIZE`` value.
"""

import contextlib
import io
import logging

from horovod_tpu_torch.common import logging as tlog

# The stream an earlier test's capture put in place of ``sys.stderr``; it
# outlives that test, as a capture object of an earlier test can.
_EARLIER = io.StringIO()


def test_a_first_use_under_a_capture_writes_there():
    # The logger as a fresh process makes it, here while sys.stderr is
    # another stream.
    logger = logging.getLogger("horovod_tpu_torch.log")
    for h in list(logger.handlers):
        logger.removeHandler(h)
    tlog._logger = None
    with contextlib.redirect_stderr(_EARLIER):
        tlog.warning("first use under a capture")
    assert "[WARNING] first use under a capture" in _EARLIER.getvalue()
    assert len(logger.handlers) == 1


def test_a_later_warning_reaches_fd_2(capfd):
    tlog.warning("a later warning")
    assert "[WARNING] a later warning" in capfd.readouterr().err


def test_the_sanitize_knob_warns_on_fd_2_after_an_earlier_use(monkeypatch,
                                                              capfd):
    import test_torch_native_sanitize as sanitize

    sanitize.test_unknown_value_warns_and_is_ignored(monkeypatch, capfd)


def test_level_and_format_are_kept(capfd):
    logger = tlog.get_logger()
    assert logger.level == logging.WARNING and not logger.propagate
    tlog.info("below the level")
    tlog.error("an error")
    err = capfd.readouterr().err
    assert "below the level" not in err
    line = [x for x in err.splitlines() if "an error" in x][0]
    assert line.endswith("[ERROR] an error"), line
