"""The port's kernel build key (``mxnet_tpu_torch.ops._build``) covers the
headers a source includes, so a changed header builds the libraries that
include it anew. Runs without nvcc: nothing here compiles; a library built by two
processes at once is compiled once."""
import os
import sys
from pathlib import Path

import pytest

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.tools import launch


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


_COLD_START = """
import sys
from pathlib import Path
from mxnet_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
_build._nvcc = lambda: sys.argv[2]
print(_build.build("kern", [sys.argv[3]]))
"""


def test_ranks_that_start_cold_build_a_library_once(tmp_path):
    """Two processes building the same library at once (two ranks of a job
    with nothing built, started by the port's launcher): the file lock
    lets one run the compiler and the other find its library."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\n'
                    'if [ "$1" = "--version" ]; then echo V0.0.1; exit 0; fi\n'
                    'echo run >> "%s"\nsleep 1\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n' % calls)
    nvcc.chmod(0o755)
    src = tmp_path / "kern.cu"
    src.write_text("int k() { return 1; }\n")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    proc = launch.run(2, [sys.executable, "-c", _COLD_START,
                          str(tmp_path / "build"), str(nvcc), str(src)],
                      timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    outs = proc.stdout.split()
    assert len(outs) == 2 and outs[0] == outs[1] and os.path.exists(outs[0])
    assert calls.read_text().split() == ["run"]
    assert _build.built_by(Path(outs[0])) == "0.0.1"
