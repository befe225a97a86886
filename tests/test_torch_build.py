"""The build of the port's CUDA libraries (``repro_torch.kernels._build``)
on a machine without nvcc: one library per source, named by its own
source's hash, built by nvcc processes that run at the same time.  A
stand-in ``nvcc`` script takes the compiler's place."""

import hashlib
import os
import stat

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
# writes the -o file once every build of the run has started
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
touch "$MARK_DIR/$(basename "$a")"
i=0
while [ "$(ls "$MARK_DIR" | wc -l)" -lt "$N_BUILDS" ]; do
  i=$((i + 1)); [ "$i" -gt 200 ] && exit 3; sleep 0.05
done
echo "ptxas info: built $out"
: > "$out"
"""


def test_sources_and_library_names_are_stable():
    assert list(_build.SOURCES) == ["segmented_copy", "flash_attention"]
    assert set(_build._SIGNATURES) == set(_build.SOURCES)
    for name, src in _build.SOURCES.items():
        assert src.parent.name == "csrc" and src.suffix == ".cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        want = _build.BUILD_DIR / f"lib{name}_{digest}.so"
        assert _build.library_path(name) == want == _build.library_path(name)
    assert _build.build_info is _build.build_infos["segmented_copy"]


def test_editing_one_source_renames_only_its_library(tmp_path, monkeypatch):
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    edited = tmp_path / "flash_attention.cu"
    edited.write_bytes(_build.SOURCES["flash_attention"].read_bytes()
                       + b"\n// edited\n")
    monkeypatch.setitem(_build.SOURCES, "flash_attention", edited)
    assert _build.library_path("segmented_copy") == before["segmented_copy"]
    assert _build.library_path("flash_attention") != before["flash_attention"]


@pytest.fixture()
def fake_toolchain(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    marks = tmp_path / "marks"
    marks.mkdir()
    monkeypatch.setenv("MARK_DIR", str(marks))
    monkeypatch.setenv("N_BUILDS", str(len(_build.SOURCES)))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_infos",
                        {n: {} for n in _build.SOURCES})
    monkeypatch.setattr(_build, "_open", lambda name, path: ("lib", name))
    return marks


def test_load_all_builds_every_library_at_once(fake_toolchain):
    libs = _build.load_all()
    assert libs == {n: ("lib", n) for n in _build.SOURCES}
    assert sorted(os.listdir(fake_toolchain)) == sorted(
        p.name for p in _build.SOURCES.values())
    for name in _build.SOURCES:
        assert _build.library_path(name).exists()
        info = _build.build_infos[name]
        assert info["seconds"] > 0 and "built" in info["log"]
    assert _build.load("flash_attention") == ("lib", "flash_attention")


def test_load_reuses_a_built_library(fake_toolchain, monkeypatch):
    _build.load_all()
    monkeypatch.setattr(_build, "_LIBS", {})

    def no_nvcc():
        raise AssertionError("a built library was compiled again")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert _build.load("segmented_copy") == ("lib", "segmented_copy")
    assert _build.build_infos["segmented_copy"]["seconds"] == 0.0


def test_failed_build_raises_with_the_compiler_output(fake_toolchain,
                                                      tmp_path, monkeypatch):
    bad = tmp_path / "bad_nvcc"
    bad.write_text("#!/bin/sh\necho 'error: no such instruction'\nexit 2\n")
    bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(bad))
    with pytest.raises(RuntimeError, match=r"nvcc failed \(2\)(.|\n)*no such"):
        _build.load_all()
    assert not _build._LIBS
