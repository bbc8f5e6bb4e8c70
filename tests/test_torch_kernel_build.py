"""The kernel build plumbing (ops/build.py), driven with a stand-in for
nvcc: where the library goes, when it is rebuilt, and how a failed
compile is reported.  The real compile happens on the card machine
(chip_smoke.py)."""

import stat

import pytest

from learning_at_home_tpu_torch.ops import build


def _fake_nvcc(tmp_path, exit_code=0):
    """A shell script taking nvcc's arguments: writes the ``-o`` file and a
    ptxas-style report, or fails with ``exit_code``."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        f"if [ {exit_code} -ne 0 ]; then echo 'error: bad kernel' >&2; "
        f"exit {exit_code}; fi\n"
        'echo built > "$2"\n'
        "echo 'ptxas info    : Used 128 registers' >&2\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


@pytest.fixture
def sandbox(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "build_reports", {})
    return tmp_path


def test_build_compiles_once_per_source_hash(sandbox, monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: _fake_nvcc(sandbox))
    build.build_all()
    libs = sorted((sandbox / "kernels").glob("lib*.so"))
    assert [p.name.split("-")[0] for p in libs] == [
        f"lib{n}" for n in sorted(build.LIBRARIES)]
    assert libs[0] == build._library_path(sorted(build.LIBRARIES)[0])
    assert "registers" in build.build_reports[sorted(build.LIBRARIES)[0]]
    build.build_reports.clear()
    build.build_all()  # nothing changed: nothing is compiled again
    assert build.build_reports == {}
    assert not list((sandbox / "kernels").glob("*.tmp.so"))


def test_failed_compile_raises_with_the_compiler_output(sandbox, monkeypatch):
    monkeypatch.setattr(build.shutil, "which",
                        lambda _: _fake_nvcc(sandbox, exit_code=2))
    with pytest.raises(RuntimeError, match="bad kernel"):
        build.build_all()
    assert not list((sandbox / "kernels").glob("lib*.so"))


def test_missing_nvcc_is_an_error(sandbox, monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(sandbox / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()
