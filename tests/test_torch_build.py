"""The kernel build's file list (``core/build.py``): every CUDA source under
``core/csrc`` is compiled into exactly one library, or is one of the
``COMMON`` sources compiled once and linked into the libraries that launch
its kernels; a
library's parts (``<name>.<part>.cu``) into their own library, and the
name of a built library changes with any file it is compiled from or
links; each library takes its name as soon as it links, before a slower
one has (a stand-in for nvcc that writes empty files). Nothing here runs
nvcc."""

import pathlib
import threading
import time

import pytest

from segmminterest_tpu_torch.core import build

CU_FILES = sorted(p.name for p in build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("name", CU_FILES)
def test_every_source_belongs_to_one_library(name):
    owners = [lib for lib in build.SOURCES
              if name in {f.name for f in build._files(lib)}]
    common = name in {f.name for f in build._common_files()}
    assert len(owners) == (0 if common else 1), \
        f"{name} is compiled into {owners}"


@pytest.mark.parametrize("lib", build.SOURCES)
def test_library_files_start_with_its_source(lib):
    files = build._files(lib)
    assert files[0] == build.CSRC / f"{lib}.cu" and files[0].exists()
    # a part's name is the library's, one more dotted word, then .cu
    for part in files[1:]:
        assert part.name.startswith(f"{lib}.") and part.name.count(".") == 2


def test_fp32_backward_libraries_have_their_head_dim_parts():
    """The fp32 (3xTF32) bodies' instantiations by head dim, in parts of
    their libraries (K3f's past 64, K1f's at every head dim, the
    backwards' at 16, 64, 96 and 128; K1b's at 64 and 128 by dropout too,
    and K4b's K2 core backward), in the order the build globs them."""
    lib = "two_block_attention_bwd"
    assert [f.name for f in build._files(lib)[1:]] == [
        f"{lib}.d128.cu", f"{lib}.d128_drop.cu", f"{lib}.d16.cu",
        f"{lib}.d64.cu", f"{lib}.d64_drop.cu", f"{lib}.d96.cu"]
    lib = "masked_attention_bwd"
    assert [f.name for f in build._files(lib)[1:]] == [
        f"{lib}.d128.cu", f"{lib}.d16.cu", f"{lib}.d64.cu",
        f"{lib}.d96.cu"]
    lib = "layer_stream_bwd"
    assert [f.name for f in build._files(lib)[1:]] == [f"{lib}.core.cu"]


def test_k2_core_forward_is_compiled_once():
    """K2's bf16 core forward, which K2f, K4f and K4b run, is one COMMON
    object linked into their three libraries, each of which declares it
    extern (no library compiles it again)."""
    assert build.COMMON["k2_core_fwd"] == (
        "proj_two_block_attention", "layer_stream", "layer_stream_bwd")
    inst = "launch_k2_core<false, false, kBlockKeys, float>"
    for lib in build.COMMON["k2_core_fwd"]:
        assert build.CSRC / "k2_core_fwd.cu" in build._common_files(lib)
        text = "".join(f.read_text() for f in build._files(lib))
        assert f"extern template cudaError_t {inst}" in text, lib
    lib = "two_block_attention"
    assert [f.name for f in build._files(lib)[1:]] == [
        f"{lib}.d128.cu", f"{lib}.d16.cu", f"{lib}.d32.cu", f"{lib}.d64.cu",
        f"{lib}.d96.cu"]
    lib = "masked_attention"
    assert [f.name for f in build._files(lib)[1:]] == [
        f"{lib}.d128.cu", f"{lib}.d96.cu"]


def test_library_name_follows_its_parts(tmp_path, monkeypatch):
    """Editing a part renames the library, so a stale build is not
    loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.glob("*.cuh"):
        (csrc / f.name).write_bytes(f.read_bytes())
    lib = "two_block_attention_bwd"
    for f in build._files(lib) + build._common_files():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._lib_path(lib)
    part = csrc / f"{lib}.d64.cu"
    part.write_text(part.read_text() + "\n")
    assert build._lib_path(lib) != before
    # and with the common sources it links
    after = build._lib_path(lib)
    common = build._common_files(lib)[0]
    common = csrc / common.name
    common.write_text(common.read_text() + "\n")
    assert build._lib_path(lib) != after
    assert pathlib.Path(build._lib_path(lib)).name.startswith(f"lib{lib}-")


def test_each_library_appears_when_it_links(tmp_path, monkeypatch):
    """A library finished early is under its final name while a slower
    source still compiles; the build leaves every library and no
    temporary file."""
    # the first library in the build's order, the other the last
    slow, early = build.SOURCES[0], build.SOURCES[-1]
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/bash\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'case "$*" in *"/{slow}.cu"*) sleep 3;; esac\n'
        'touch "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    out = {}
    thread = threading.Thread(target=lambda: out.update(build.build_all()))
    thread.start()
    early = build._lib_path(early)
    deadline = time.time() + 60
    while not early.exists() and time.time() < deadline:
        time.sleep(0.05)
    assert early.exists() and thread.is_alive()
    assert not build._lib_path(slow).exists()
    thread.join(60)
    assert sorted(out) == sorted(build.SOURCES)
    assert all(p.exists() for p in out.values())
    assert sorted(f.name for f in (tmp_path / "out").iterdir()) == \
        sorted(p.name for p in out.values())
