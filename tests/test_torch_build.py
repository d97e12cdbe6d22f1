"""The kernel build: keyed by the sources, and no silent way around it."""

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
