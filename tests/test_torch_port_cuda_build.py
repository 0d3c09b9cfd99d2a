"""The port's kernel build (`ops.cuda_build`) with a stand-in `nvcc`: one
compile process a source, all started before any has finished, then one
link of their objects into the library; the compilers' outputs (ptxas's
register and spill lines) are returned and the objects removed."""

import os
import stat

import pytest

from wav2vec2_tpu_torch.ops import cuda_build

FAKE_NVCC = """#!/bin/sh
# a stand-in nvcc: "-c -o X.o SRC" waits until every source has started
# (a marker file each), then writes X.o; "-o LIB OBJS" concatenates them
log="{log}"
out=""; prev=""; compile=0
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  [ "$a" = "-c" ] && compile=1
  prev="$a"
done
src=""; for a in "$@"; do src="$a"; done
if [ $compile = 1 ]; then
  touch "$log.started.$(basename "$src")"
  n=0
  while [ "$(ls "$log".started.* 2>/dev/null | wc -l)" -lt {n_sources} ]; do
    n=$((n + 1)); [ $n -gt 200 ] && echo "sources compiled one after another" && exit 3
    sleep 0.05
  done
  echo "compiled $src" > "$out"
  echo "ptxas info    : Used 8 registers ($(basename "$src"))"
  echo "compile $(basename "$src")" >> "$log"
else
  shift 0
  cat $(for a in "$@"; do case "$a" in *.o) echo "$a";; esac; done) > "$out"
  echo "link" >> "$log"
fi
"""


def test_build_compiles_every_source_in_parallel_then_links(tmp_path, monkeypatch):
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log, n_sources=len(cuda_build.SOURCES)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build_dir = tmp_path / "torch_kernels"
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(cuda_build, "LIBRARY", build_dir / "libkernels.so")
    info = cuda_build.build(force=True)
    assert info["library"] == str(build_dir / "libkernels.so")
    steps = log.read_text().split("\n")[:-1]
    assert sorted(steps[:-1]) == sorted(f"compile {src.name}" for src in cuda_build.SOURCES)
    assert steps[-1] == "link"
    assert all(f"Used 8 registers ({src.name})" in info["compiler_output"]
               for src in cuda_build.SOURCES)
    library = (build_dir / "libkernels.so").read_text()
    assert all(f"compiled {src}" in library for src in cuda_build.SOURCES)
    assert sorted(os.listdir(build_dir)) == ["libkernels.so"]  # objects removed
    assert cuda_build.build()["seconds"] == 0.0  # up to date: no second build


def test_build_reports_the_source_that_failed(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: expected a ;'\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build_dir = tmp_path / "torch_kernels"
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(cuda_build, "LIBRARY", build_dir / "libkernels.so")
    with pytest.raises(RuntimeError, match="nvcc failed: viterbi.cu:\nerror: expected a ;"):
        cuda_build.build(force=True)
    assert not (build_dir / "libkernels.so").exists()
    assert os.listdir(build_dir) == []
