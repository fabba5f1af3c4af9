"""The port's kernel build bookkeeping, on the CPU (no nvcc needed): a
library's content key follows every ``csrc/`` file its unit includes, and
each generated unit includes the headers it needs."""
from repro_torch.core.kernel_lang import FLT, Bin, Var
from repro_torch.core.synthesis import emit_cuda_level, emit_cuda_round
from repro_torch.kernels import build


def _write(d, name, text):
    (d / name).write_text(text)


def test_source_key_follows_every_included_header(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    _write(tmp_path, "outer.cuh", '#pragma once\n#include "inner.cuh"\n')
    _write(tmp_path, "inner.cuh", "#pragma once\n// v1\n")
    _write(tmp_path, "unused.cuh", "// v1\n")
    unit = '#include "outer.cuh"\nint x;\n'
    assert [p.name for p in build.included_files(unit)] == \
        ["outer.cuh", "inner.cuh"]
    key = build.source_key(unit)
    assert build.source_key(unit) == key
    _write(tmp_path, "unused.cuh", "// v2\n")
    assert build.source_key(unit) == key          # not included: no change
    _write(tmp_path, "inner.cuh", "#pragma once\n// v2\n")
    key2 = build.source_key(unit)
    assert key2 != key                            # included transitively
    _write(tmp_path, "outer.cuh", '#pragma once\n#include "inner.cuh"\n//\n')
    assert build.source_key(unit) not in (key, key2)


def test_units_include_their_headers():
    p = Bin("+", Var("n", FLT), Var("w", FLT))
    rnd = emit_cuda_round([p], ["float"], [float("inf")], (((0, "min"),),))
    lvl = emit_cuda_level([p], ["float"], [float("inf")], "min", "value")
    assert [f.name for f in build.included_files(rnd)] == ["edge_sweep.cuh"]
    assert [f.name for f in build.included_files(lvl)] == \
        ["edge_level.cuh", "edge_sweep.cuh"]
    fixed = build.fixed_source()
    names = {f.name for f in build.included_files(fixed)}
    assert {"embedding_bag.cu", "segment_softmax.cu",
            "flash_attention_3xtf32.cu", "flash_attention_sm90.cu",
            "flash_sm90.cuh", "dtypes.cuh"} <= names
    assert build.source_key(rnd) != build.source_key(lvl)


def test_level_unit_loads_only_what_its_p_reads():
    p_c = Bin("min", Var("n", FLT), Var("c", FLT))
    p_w = Bin("+", Var("n", FLT), Var("w", FLT))
    value = emit_cuda_level([p_c, p_w], ["float", "float"],
                            [float("-inf"), float("inf")], "min", "value")
    nonbot = emit_cuda_level([p_c, p_w], ["float", "float"],
                             [float("-inf"), float("inf")], "min", "nonbot")
    assert "READS_W = true" in value and "READS_C = true" in value
    assert "READS_W = false" in nonbot and "READS_C = true" in nonbot
    assert "NONBOT = true" in nonbot and "OP = OP_MAX" in nonbot


def test_wide_round_unit_widens_its_pointer_arrays():
    """A round of more outputs (levels + components) than a kernel's
    default 16 pointers, such as the service's fused scalar round of 8
    radius/drr requests (16 one-level components), defines a wider
    ``Ptrs`` for its own unit; a narrower round's unit is unchanged, and a
    round beyond the cap is refused."""
    import pytest
    from repro_torch.core import fusion, usecases
    from repro_torch.core.guard import KernelBuildError
    from repro_torch.core.iterate import comp_runtimes
    from repro_torch.core.synthesis import synthesize_round
    from repro_torch.kernels import edge_reduce, ops

    def scalar_round(k):
        prog = fusion.fuse_many(
            [(i, (usecases.radius if i % 2 else usecases.drr)(2 * i, 2 * i + 1))
             for i in range(k)])
        (rnd,) = [r for _n, r in prog.rounds if r.leaves]
        return ops.sweep_round(comp_runtimes(rnd, synthesize_round(rnd)),
                               [leaf.plan for leaf in rnd.leaves])

    narrow, wide = scalar_round(4), scalar_round(8)
    assert (narrow.n_levels, len(narrow.comps_order), narrow.max_ptrs) == \
        (8, 8, 16)
    assert (wide.n_levels, len(wide.comps_order), wide.max_ptrs) == \
        (16, 16, 32)
    assert "GRAFS_MAX_PTRS" not in narrow.source()
    assert wide.source().startswith("#define GRAFS_MAX_PTRS 32\n")
    assert [f.name for f in build.included_files(wide.source())] == \
        ["edge_sweep.cuh"]
    wide.max_ptrs = edge_reduce._PTRS_CAP + 16   # the memoized round:
    try:                                        # restored below
        with pytest.raises(KernelBuildError, match="too wide"):
            wide.source()
    finally:
        wide.max_ptrs = 32
