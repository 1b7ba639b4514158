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


def _recording_nvcc(tmp_path):
    """A stand-in nvcc: logs each call's arguments, sleeps 1 s for a
    compile (``-c``) and writes the ``-o`` file."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\n'
                    'if [ "$1" = "--version" ]; then echo V0.0.2; exit 0; fi\n'
                    'echo "$@" >> "%s"\n'
                    'for a in "$@"; do [ "$a" = "-c" ] && sleep 1; done\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo "ptxas info : Compiling entry for $2"\n'
                    'touch "$2"\n' % calls)
    nvcc.chmod(0o755)
    return nvcc, calls


def test_units_build_in_parallel_and_link_once(tmp_path, monkeypatch):
    """A library given as (source, defines) units (K1's head dims) is one
    ``nvcc -c`` a unit, all started together, and one link; every unit's
    defines reach its compile and its seconds reach the build log; no
    object is left behind."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kern.cu").write_text("int k() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    nvcc, calls = _recording_nvcc(tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    units = [("kern.cu", (f"MXT_FWD_DIM={d}",)) for d in (32, 64, 128)] \
        + ["kern.cu"]
    t0 = __import__("time").perf_counter()
    out = _build.build("kern", units)
    wall = __import__("time").perf_counter() - t0
    assert wall < 3.5, wall            # four 1-s compiles, in parallel
    lines = calls.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in f" {ln} "]
    links = [ln for ln in lines if " -shared " in f" {ln} "]
    assert len(compiles) == 4 and len(links) == 1, lines
    assert all("-shared" not in ln for ln in compiles)
    for d in (32, 64, 128):
        assert sum(f"-DMXT_FWD_DIM={d}" in ln for ln in compiles) == 1
    assert sum("-D" not in ln for ln in compiles) == 1
    assert links[0].count(".o") == 4 and "arch=compute_90a,code=sm_90a" \
        in links[0]
    log = _build.build_log("kern")
    assert [o["unit"] for o in log["objects"]] == [
        "kern.cu -DMXT_FWD_DIM=32", "kern.cu -DMXT_FWD_DIM=64",
        "kern.cu -DMXT_FWD_DIM=128", "kern.cu"]
    assert all(o["seconds"] >= 1.0 for o in log["objects"])
    assert log["ptxas"].count("Compiling entry") == 4
    assert out.exists() and _build.built_by(out) == "0.0.2"
    assert not list(out.parent.glob("*.o"))


def test_the_key_covers_each_units_defines(csrc):
    """Units of one source differing only by their defines build different
    libraries; the same units in the same order give the same key."""
    one = [("kern.cu", ("MXT_FWD_DIM=64",)), "kern.cu"]
    assert _build.source_hash(one) == _build.source_hash(list(one))
    assert _build.source_hash(one) != _build.source_hash(
        [("kern.cu", ("MXT_FWD_DIM=128",)), "kern.cu"])
    assert _build.source_hash(one) != _build.source_hash(["kern.cu"])


def test_k1_builds_from_one_object_a_head_dim():
    """K1's library: one unit a head dim and the C entry's unit, all of
    the one source; a variant may build fewer head dims."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    units = fa.fwd_sources()
    assert units[-1] == "flash_attention_fwd.cu" and len(units) == 4
    assert [u[1] for u in units[:-1]] == [
        ("MXT_FWD_DIM=32",), ("MXT_FWD_DIM=64",), ("MXT_FWD_DIM=128",)]
    assert fa.fwd_sources("v.cu", dims=(64,)) == (
        ("v.cu", ("MXT_FWD_DIM=64",)), "v.cu")
    text = (_build.CSRC / "flash_attention_fwd.cu").read_text()
    assert "#ifdef MXT_FWD_DIM" in text
