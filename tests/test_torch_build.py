"""The port's kernel build on the CPU: no `nvcc` runs here.

`library_path` names a library by a hash of its source and every file
beside it but the other sources, so an edited header rebuilds; `SIGNATURES` must match the C
entry points of each source, or ctypes would pass the wrong arguments.
"""
import re

import pytest

from repro_torch.kernels import _build


def _tree(root, files):
    for name, text in files.items():
        p = root / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return root


def test_editing_a_header_beside_the_source_changes_the_library_path(
        tmp_path, monkeypatch):
    csrc = _tree(tmp_path / "csrc", {"k.cu": '#include "k.cuh"\n',
                                     "k.cuh": "#define X 1\n"})
    monkeypatch.setitem(_build.SOURCES, "k", csrc / "k.cu")
    first = _build.library_path("k")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("k-")
    assert _build.library_path("k") == first
    (csrc / "k.cuh").write_text("#define X 2\n")
    second = _build.library_path("k")
    assert second != first
    (csrc / "k.cuh").write_text("#define X 1\n")
    assert _build.library_path("k") == first


@pytest.mark.parametrize("edit", ["source", "new_header", "rename"])
def test_library_path_follows_every_file_under_csrc(tmp_path, monkeypatch,
                                                    edit):
    csrc = _tree(tmp_path / "csrc", {"k.cu": "int x;\n",
                                     "sub/h.cuh": "int y;\n"})
    monkeypatch.setitem(_build.SOURCES, "k", csrc / "k.cu")
    before = _build.library_path("k")
    if edit == "source":
        (csrc / "k.cu").write_text("int x = 1;\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("\n")
    else:
        (csrc / "sub" / "h.cuh").rename(csrc / "sub" / "g.cuh")
    assert _build.library_path("k") != before


@pytest.mark.parametrize("edited,rebuilt", [
    ("fused_band.cu", {"fused_band"}), ("stencil.cu", {"stencil"}),
    ("common.cuh", {"fused_band", "stencil"})])
def test_sources_sharing_a_directory_rebuild_only_on_their_own_edits(
        tmp_path, monkeypatch, edited, rebuilt):
    """Two sources in one `csrc/`, as `fused_band.cu` and `stencil.cu`
    are: editing one leaves the other's library as it is; a header
    beside both rebuilds both."""
    csrc = _tree(tmp_path / "csrc", {"fused_band.cu": "int f;\n",
                                     "stencil.cu": "int s;\n",
                                     "common.cuh": "int c;\n"})
    for name in ("fused_band", "stencil"):
        monkeypatch.setitem(_build.SOURCES, name, csrc / f"{name}.cu")
    before = {n: _build.library_path(n) for n in ("fused_band", "stencil")}
    (csrc / edited).write_text("int edited;\n")
    after = {n: _build.library_path(n) for n in before}
    assert {n for n in before if after[n] != before[n]} == rebuilt


_C_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_signatures_match_the_cuda_sources(name):
    """Every C entry point of a source has its ctypes signature, with as
    many arguments, pointers where the source takes pointers."""
    found = {fn: [a.strip() for a in args.split(",")]
             for fn, args in _C_ENTRY.findall(
                 _build.SOURCES[name].read_text())}
    assert sorted(found) == sorted(_build.SIGNATURES[name])
    for fn, args in found.items():
        sig = _build.SIGNATURES[name][fn]
        assert len(sig) == len(args), fn
        for arg, ctype in zip(args, sig):
            is_ptr = "*" in arg
            assert is_ptr == (ctype is not _build._I
                              and ctype is not _build._I64), (fn, arg)
