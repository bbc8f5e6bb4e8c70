"""Helpers of the port's gate and alive-set tests (torch only): a
function run under the test's own timeout, its exit code and printed
lines, and a gate module's ``subprocess`` replaced by canned replies."""

import subprocess
import threading
import types


def bounded(seconds: float, fn, *args):
    """``fn(*args)``, failing the test if it has not returned within
    ``seconds`` (the test's own timeout; the thread is left behind)."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # re-raised in the test's thread
            box["error"] = e

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(seconds)
    assert not worker.is_alive(), f"{fn.__name__} ran past {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def captured(capsys, fn, *args, seconds: float = 120.0):
    """``fn(*args)`` under :func:`bounded`: (its return value, the lines
    it printed to stdout, those to stderr)."""
    capsys.readouterr()
    rc = bounded(seconds, fn, *args)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err.splitlines()


def canned(monkeypatch, module, replies: list, seen: list = None):
    """Replace ``subprocess`` in one gate module alone by a stand-in whose
    ``run`` returns (or raises) ``replies`` in turn; each command run is
    appended to ``seen``."""
    queue = list(replies)

    def run(cmd, **kwargs):
        if seen is not None:
            seen.append(cmd)
        reply = queue.pop(0)
        if isinstance(reply, BaseException):
            raise reply
        return subprocess.CompletedProcess(cmd, *reply)

    monkeypatch.setattr(module, "subprocess", types.SimpleNamespace(
        run=run, TimeoutExpired=subprocess.TimeoutExpired))
