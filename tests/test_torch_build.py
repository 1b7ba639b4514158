"""The port's kernel build key (``mxnet_tpu_torch.ops._build``) covers the
headers a source includes, so a changed header builds the libraries that
include it anew. Runs without nvcc: nothing here compiles."""
import pytest

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    def no_nvcc(*args, **kwargs):
        raise AssertionError("nvcc was run")

    monkeypatch.setattr(_build.subprocess, "run", no_nvcc)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    (src / "kern.cu").write_text('#include "shared.cuh"\n'
                                 '#include <stdint.h>\n'
                                 'int k() { return one(); }\n')
    (src / "shared.cuh").write_text('#pragma once\n#include "leaf.cuh"\n'
                                    'int one() { return 1; }\n')
    (src / "leaf.cuh").write_text("// leaf\n")
    return src


@pytest.mark.parametrize("edit", ["shared.cuh", "leaf.cuh", "kern.cu"])
def test_hash_changes_with_the_source_and_every_header_it_includes(csrc, edit):
    before = _build.source_hash(["kern.cu"])
    assert _build.source_hash(["kern.cu"]) == before
    (csrc / edit).write_text((csrc / edit).read_text() + "// changed\n")
    assert _build.source_hash(["kern.cu"]) != before


def test_a_source_outside_csrc_finds_its_header_there(csrc, tmp_path):
    """A variant written elsewhere (as tools/k1_ablation.py writes them)
    includes the header from csrc/, and its key covers it too."""
    variant = tmp_path / "variant.cu"
    variant.write_text((csrc / "kern.cu").read_text())
    before = _build.source_hash([variant])
    (csrc / "shared.cuh").write_text("int one() { return 2; }\n")
    assert _build.source_hash([variant]) != before


def test_a_missing_header_raises(csrc):
    (csrc / "kern.cu").write_text('#include "absent.cuh"\n')
    with pytest.raises(MXNetError, match="absent.cuh"):
        _build.source_hash(["kern.cu"])


def test_the_library_name_carries_the_key(csrc):
    """A library built for one header is found again while the header is
    unchanged, and not once it changes (build would run nvcc: refused
    here)."""
    path = _build.BUILD_DIR / \
        f"libkern-{_build.source_hash(['kern.cu'])[:16]}.so"
    path.parent.mkdir(parents=True)
    path.write_bytes(b"")
    assert _build.build("kern", ["kern.cu"]) == path
    (csrc / "shared.cuh").write_text("int one() { return 3; }\n")
    with pytest.raises(AssertionError, match="nvcc was run"):
        _build.build("kern", ["kern.cu"])
