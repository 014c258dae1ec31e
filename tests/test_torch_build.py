"""The port's kernel build names each library by everything it compiles:
the ``.cu`` source, the local headers it includes and the nvcc flags.
Runs on the CPU (nothing is compiled)."""
from repro_torch.kernels import build
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _tree(tmp_path):
    (tmp_path / "a.cu").write_text(
        '#include "b.cuh"\n#include <cuda.h>\nint a;\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n  # include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("#pragma once\nint c;\n")
    (tmp_path / "d.cuh").write_text("int d;\n")
    return tmp_path / "a.cu"


def test_sources_of_follows_local_includes(tmp_path):
    src = _tree(tmp_path)
    names = [p.name for p in build.sources_of(src)]
    assert names == ["a.cu", "b.cuh", "c.cuh"]


def test_lib_path_changes_with_an_included_header(tmp_path):
    src = _tree(tmp_path)
    before = build._lib_path(src)
    (tmp_path / "d.cuh").write_text("int d2;\n")       # not included
    assert build._lib_path(src) == before
    (tmp_path / "c.cuh").write_text("#pragma once\nint c2;\n")
    after = build._lib_path(src)
    assert after != before and after.name.startswith("a-")


def test_flash_sources_share_the_hopper_header():
    for name in ("flash_fwd", "flash_bwd"):
        deps = [p.name for p in build.sources_of(build.CSRC / f"{name}.cu")]
        assert deps == [f"{name}.cu", "hopper.cuh"]
