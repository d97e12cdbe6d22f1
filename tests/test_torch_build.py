"""The kernel build: keyed by the sources, and no silent way around it."""

import re
import shutil

import pytest

from vqa_project_tpu_torch.ops import _build


def test_build_dir_is_keyed_by_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    first = _build.build_dir()
    assert first == _build.build_dir()
    assert first.parent == tmp_path / "_build"
    src = csrc / "gru_scan.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.build_dir() != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No toolkit: the build fails loudly and creates nothing."""
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not (tmp_path / "_build").exists()


def test_every_kernel_source_is_declared():
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(_build.KERNELS)
    assert set(_build.KERNELS) == set(_build._SIGNATURES)


@pytest.mark.parametrize("kernel", _build.KERNELS)
def test_signatures_match_the_c_entries(kernel):
    """Every extern "C" entry of a source is declared with as many
    arguments as the source gives it, and nothing else is declared."""
    text = (_build.CSRC / f"{kernel}.cu").read_text()
    entries = {m.group(1): len(m.group(2).split(","))
               for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)}
    declared = {name: len(args)
                for name, args in _build._SIGNATURES[kernel].items()}
    assert entries == declared


def test_package_data_ships_every_kernel_source():
    """An installed package carries every file nvcc reads: each file in
    csrc/ matches a [tool.setuptools.package-data] glob."""
    import fnmatch
    import tomllib

    root = _build.CSRC.parent.parent
    with open(root / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    globs = data[_build.CSRC.parent.name]
    files = sorted(p.name for p in _build.CSRC.iterdir() if p.is_file())
    assert any(f.endswith(".cuh") for f in files)
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f"csrc/{f}", g) for g in globs)]
    assert not missing


@pytest.mark.parametrize("xdg", [True, False])
def test_build_dir_moves_to_user_cache_when_package_is_read_only(
        tmp_path, monkeypatch, xdg):
    """A read-only package directory (an installed site-packages) sends
    the build to the user's cache directory, under the same hash."""
    in_package = _build.build_dir()
    real_access = _build.os.access
    monkeypatch.setattr(
        _build.os, "access",
        lambda p, mode: False if str(p) == str(_build.BUILD_ROOT.parent)
        else real_access(p, mode))
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        cache = tmp_path / "xdg"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        cache = tmp_path / "home" / ".cache"
    moved = _build.build_dir()
    assert moved.parent == cache / "vqa_project_tpu_torch" / "_build"
    assert moved.name == in_package.name
