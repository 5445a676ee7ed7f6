"""How ``csrc/`` is compiled, on the CPU (no nvcc): the shared header's
slab scalar layout is the Python one, the library's name covers every
header the sources include, and the kernel tools build through
``kernels/_build``'s one function with its flags and include path."""

import re
import shutil

import pytest

from tomojax_torch.core import slab_projector as sp
from tomojax_torch.kernels import _build
from tomojax_torch.tools import adj_split, fmad_check

HEADER = _build.CSRC / "common.cuh"
_DEF = re.compile(r"\b(NS|S_\w+) = (\d+)")


def test_header_scalar_layout_is_the_python_one():
    """``common.cuh``'s ``NS`` and ``S_*`` equal ``core.slab_projector``'s,
    every ``S_*`` a source uses is the header's, and no source defines one
    itself."""
    consts = {k: int(v) for k, v in _DEF.findall(HEADER.read_text())}
    assert consts.pop("NS") == sp.NS
    assert consts and all(v == getattr(sp, k) for k, v in consts.items())
    used = set()
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        assert not _DEF.search(text), src.name
        used |= set(re.findall(r"\bS_[A-Z0-9_]+\b", text))
    assert used and used <= consts.keys()


def test_library_path_hashes_every_included_header(tmp_path, monkeypatch):
    """Every ``#include "…"`` of a source names a file in ``csrc/`` that
    ``library_path()`` hashes, and editing a header in a copy of ``csrc/``
    changes the library's name."""
    hashed = _build.files(*_build.SOURCES)
    included = set()
    for src in _build.CSRC.glob("*.cu"):
        assert src in _build.SOURCES, src.name
        included |= set(re.findall(r'^#include "([^"]+)"', src.read_text(),
                                   re.M))
    assert HEADER.name in included
    for name in included:
        assert (_build.CSRC / name).is_file() and _build.CSRC / name in hashed
    before = _build.library_path()
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "SOURCES",
                        tuple(copy / s.name for s in _build.SOURCES))
    assert _build.library_path() == before
    (copy / HEADER.name).write_text(HEADER.read_text() + "\n// edited\n")
    assert _build.library_path() != before


@pytest.fixture
def stub_nvcc(monkeypatch, tmp_path):
    """``_build``'s compiler runner stubbed: the commands it would run, and
    the calls of ``compile_libraries``; loading returns the path."""
    cmds, calls = [], []
    real = _build.compile_libraries

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run",
                        lambda c: (cmds.extend(c), [""] * len(c))[1])
    monkeypatch.setattr(_build, "compile_libraries", spy)
    monkeypatch.setattr(_build, "load_library", lambda path: path)
    monkeypatch.setattr(adj_split, "OUT_DIR", tmp_path / "adj_split")
    monkeypatch.setattr(fmad_check, "OUT_DIR", tmp_path / "fmad_check")
    return cmds, calls


def _compiles(cmds):
    return [c for c in cmds if "-c" in c]


def _carries(cmd, *args):
    n = len(args)
    return any(cmd[i:i + n] == list(args) for i in range(len(cmd)))


def test_tool_builds_go_through_compile_libraries(stub_nvcc, tmp_path):
    """``adj_split``'s builds (this tree's and a parent's) and
    ``fmad_check``'s compile each source through
    ``_build.compile_libraries`` with ``NVCC_FLAGS``, their own extra
    arguments and ``-I`` the tree's ``csrc/``; no tool reads ``_build``'s
    private names."""
    cmds, calls = stub_nvcc
    k1 = adj_split.KERNELS["k1"]
    libs, _ = adj_split.build({
        "k1": adj_split.with_occupancy(k1, _build.texts(k1["source"])),
        "k1.no_pass_a": adj_split.variant_source("k1", "no_pass_a")})
    assert set(libs) == {"k1", "k1.no_pass_a"}
    assert (adj_split.OUT_DIR / "k1.no_pass_a" / HEADER.name).is_file()
    tree = tmp_path / "parent"
    shutil.copytree(_build.CSRC, tree / "tomojax_torch" / "kernels" / "csrc")
    par = adj_split.parent_csrc(str(tree))
    adj_split.build({"parent.k1": _build.texts(par / "slab_plane.cu")}, par)
    fmad_check.load_no_fmad()
    assert len(calls) == 3
    comp = _compiles(cmds)
    assert len(comp) == 3 + len(_build.SOURCES)
    for i, cmd in enumerate(comp):
        assert _carries(cmd, *_build.NVCC_FLAGS), cmd
        csrc = par if i == 2 else _build.CSRC
        assert _carries(cmd, "-I", str(csrc)), cmd
        assert _carries(cmd, "-Xptxas", "-v") == (i < 3), cmd
        assert ("--fmad=false" in cmd) == (i >= 3), cmd
    tools = _build.CSRC.parents[1] / "tools"
    for f in tools.glob("*.py"):
        assert not re.search(r"_build\._(nvcc|run|SIGNATURES)\b",
                             f.read_text()), f.name


def test_adj_split_patches_the_file_that_holds_the_text():
    """A variant's edit lands in whichever file holds its text, the header
    included, and an edit whose text is not found exactly once raises."""
    texts = _build.texts(adj_split.PLANE)
    old = "constexpr unsigned kFloorBias = 0x4B400000u;"
    out = adj_split._apply([(old, old + " // edited")], texts, "edit")
    assert out[HEADER.name] != texts[HEADER.name]
    assert out[adj_split.PLANE.name] == texts[adj_split.PLANE.name]
    with pytest.raises(ValueError, match="0 times"):
        adj_split._apply([("no such text", "")], texts, "edit")
    with pytest.raises(ValueError, match="2 times"):
        adj_split._apply([(old, "")], {**texts, "x.cu": old}, "edit")
