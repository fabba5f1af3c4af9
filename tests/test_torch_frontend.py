"""Port parity of the front end: fusion and synthesis give the same rounds
and kernel expressions as the JAX package, and ``emit_cuda`` prints P with
the reference's typing."""
import numpy as np
import pytest

from repro.core import fusion as JF
from repro.core import synthesis as JSy
from repro.core import usecases as JU
from repro_torch.core import fusion as TF
from repro_torch.core import kernel_lang as TK
from repro_torch.core import synthesis as TSy
from repro_torch.core import usecases as TU


def _round_keys(prog, F, Sy):
    out = []
    for name, r in prog.rounds:
        keys = [F.plan_key(leaf.plan, r.components) for leaf in r.leaves]
        synth = Sy.synthesize_round(r) if r.leaves else {}
        exprs = [(str(synth[("kernels", c.idx)].p_expr),
                  str(synth[("kernels", c.idx)].i_expr))
                 for c in r.components]
        out.append((name, keys, exprs, [str(e) for _n, e in r.maps],
                    r.vreduces, str(r.out)))
    return out


@pytest.mark.parametrize("name", sorted(JU.ALL_SPECS))
def test_rounds_and_kernels_equal(name):
    jp = JF.fuse(JU.ALL_SPECS[name]())
    tp = TF.fuse(TU.ALL_SPECS[name]())
    assert _round_keys(tp, TF, TSy) == _round_keys(jp, JF, JSy)
    assert tp.stats.total_rules() == jp.stats.total_rules()
    ju = JF.lower_unfused(JU.ALL_SPECS[name]())
    tu = TF.lower_unfused(TU.ALL_SPECS[name]())
    assert len(tu.rounds) == len(ju.rounds)


def test_direct_kernel_expressions_match_closures():
    import torch
    rng = np.random.default_rng(0)
    env = {k: torch.from_numpy(rng.uniform(1, 9, 16).astype(np.float32))
           for k in ("n", "w", "outdeg", "wdeg")}
    for jk, tk in ((JSy.pagerank_kernels, TSy.pagerank_kernels),
                   (JSy.weighted_pagerank_kernels,
                    TSy.weighted_pagerank_kernels)):
        want = np.asarray(jk(16).p_fn({k: v.numpy() for k, v in env.items()}))
        got = tk(16).p_fn(env).numpy()
        np.testing.assert_array_equal(got, want)


V = TK.Var
L = TK.Lit


@pytest.mark.parametrize("expr,types,code,ty", [
    (TK.Bin("+", V("n", "int"), L(1, "int")), {"n": "int"},
     "iadd(n, ((int)1))", "int"),
    (TK.Bin("+", V("n", "int"), V("w", "float")),
     {"n": "int", "w": "float"}, "(((float)(n)) + w)", "float"),
    (TK.Bin("min", V("n", "float"), V("c", "float")),
     {"n": "float", "c": "float"}, "fmin_nan(n, c)", "float"),
    (TK.Bin("max", V("n", "int"), V("c", "float")),
     {"n": "int", "c": "float"}, "fmax_nan(((float)(n)), c)", "float"),
    (TK.Bin("/", V("n", "int"), V("esrc", "int")),
     {"n": "int", "esrc": "int"}, "(((float)(n)) / ((float)(esrc)))",
     "float"),
    (TK.Bin("*", V("n", "float"), TK.Bin("+", L(1, "int"), L(2, "int"))),
     {"n": "float"}, "(n * ((float)3.0))", "float"),
    (TK.Bin("<", V("n", "int"), L(1.5, "float")), {"n": "int"},
     "(((float)(n)) < ((float)1.5))", "bool"),
    (TK.ITE(TK.Bin("==", V("n", "int"), L(0, "int")), V("n", "int"),
            V("w", "float")), {"n": "int", "w": "float"},
     "(((n == ((int)0))) ? ((float)(n)) : w)", "float"),
])
def test_emit_cuda_types_casts_nan(expr, types, code, ty):
    assert TK.emit_cuda(expr, types) == (code, ty)


def test_emit_cuda_round_unit():
    src = TSy.emit_cuda_round(
        [TK.Bin("+", V("n", "int"), L(1, "int")),
         TK.Bin("min", V("n", "float"), V("c", "float"))],
        ["int", "float"], [np.int32(1073741823), np.float32(-np.inf)],
        (((0, "min"), (1, "max")),))
    assert '#include "edge_sweep.cuh"' in src
    assert "GRAFS_DEFINE_ENTRY_POINTS(Round)" in src
    assert "static constexpr int NLEV = 2;" in src
    assert "static constexpr bool READS_C = true;" in src
    for name in ("W", "EDST", "OUTDEG", "WDEG"):
        assert f"static constexpr bool READS_{name} = false;" in src
    assert "0x3fffffffu" in src and "0xff800000u" in src
    assert "return w_of((int)(iadd(n, ((int)1))));" in src
    assert "return w_of((float)(fmin_nan(n, c)));" in src
    sk = TSy.synthesize_component(TU.sssp(0).f, "min")
    assert "n + w" in TSy.emit_source(sk, "cuda").replace("(", "") \
        .replace(")", "")
