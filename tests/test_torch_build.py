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
