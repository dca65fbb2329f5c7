"""``ops/_build.py`` without a CUDA toolkit: a stand-in ``nvcc`` that
writes its output file and a ptxas-style report shows what is built,
what is loaded from the cache, and that a cached library keeps its
build's report."""

import stat
import sys

import pytest

from cyberether_tpu_torch.ops import _build

REPORT = ("ptxas info    : Compiling entry function 'k_kernel' for "
          "'sm_90a'\nptxas info    : Used 40 registers, 0 bytes spill "
          "stores, 0 bytes spill loads\n")


@pytest.fixture
def fake(tmp_path, monkeypatch):
    """(csrc, build dir, calls file): ``_build`` pointed at a source
    folder and a build folder under ``tmp_path``, its nvcc a script that
    appends a line to the calls file each time it runs."""
    csrc, out, calls = tmp_path / "csrc", tmp_path / "build", \
        tmp_path / "calls"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "open(args[args.index('-o') + 1], 'w').write('lib')\n"
        f"open({str(calls)!r}, 'a').write('x\\n')\n"
        f"sys.stderr.write({REPORT!r})\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "build_log", {})
    return csrc, out, calls


def _calls(calls) -> int:
    return len(calls.read_text().splitlines()) if calls.exists() else 0


def test_cached_library_keeps_its_report(fake):
    csrc, out, calls = fake
    library = _build.build(["k.cu"])["k.cu"]
    assert library.exists() and _calls(calls) == 1
    assert _build.build_log["k.cu"][1] == REPORT
    assert _build.report("k.cu") == REPORT
    # another process: nothing built, the report read beside the library
    _build.build_log.clear()
    assert _build.build(["k.cu"])["k.cu"] == library
    assert _build.report("k.cu") == REPORT
    assert _calls(calls) == 1 and "k.cu" not in _build.build_log
    assert sorted(p.name for p in out.iterdir()) == [
        library.with_suffix(".log").name, library.name]


def test_library_without_its_report_is_built_again(fake):
    csrc, out, calls = fake
    library = _build.build(["k.cu"])["k.cu"]
    library.with_suffix(".log").unlink()
    assert _build.report("k.cu") == REPORT
    assert _calls(calls) == 2


def test_edited_source_builds_a_library_of_its_own(fake):
    csrc, out, calls = fake
    first = _build.build(["k.cu"])["k.cu"]
    (csrc / "k.cu").write_text("// v2\n")
    second = _build.build(["k.cu"])["k.cu"]
    assert second != first and second.exists() and _calls(calls) == 2
    assert _build.report("k.cu") == REPORT
