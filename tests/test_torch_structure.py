"""Port parity of the graph layer: the torch package's layouts are bitwise
the JAX package's, and its generators and validation behave the same."""
import numpy as np
import pytest

from repro.graph import structure as JS
from repro_torch.core import guard as tguard
from repro_torch.graph import segment as TSeg
from repro_torch.graph import structure as TS

ELL_FIELDS = ("nbrs", "weight", "capacity", "mask", "tile_nnz")
RES_FIELDS = ("in2out", "valid", "src_tile", "tile_nnz", "contrib")


def _port(jg):
    return TS.from_arrays(jg.n, *jg.host_edges(), device="cpu")


def _graphs(small_graphs):
    out = dict(small_graphs)
    out["rm-xs"] = JS.rmat_graph(400, 3200, seed=11)
    return out


@pytest.mark.parametrize("name", ["uniform", "uniform2", "rmat", "line",
                                  "rm-xs"])
def test_layouts_bitwise_equal(small_graphs, name):
    jg = _graphs(small_graphs)[name]
    tg = _port(jg)
    for d in ("in", "out"):
        a = JS.to_blocked_ell(jg, direction=d)
        b = TS.to_blocked_ell(tg, direction=d)
        assert (a.n, a.n_pad, a.width) == (b.n, b.n_pad, b.width)
        for f in ELL_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy(), err_msg=f)
    ra, rb = JS.to_push_resolution(jg), TS.to_push_resolution(tg)
    assert (ra.width, ra.out_width) == (rb.width, rb.out_width)
    for f in RES_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ra, f)),
                                      getattr(rb, f).numpy(), err_msg=f)


@pytest.mark.parametrize("weighted", [False, True])
def test_generators_same_edges(weighted):
    jg = JS.rmat_graph(400, 3200, seed=11, weighted=weighted)
    tg = TS.rmat_graph(400, 3200, seed=11, weighted=weighted, device="cpu")
    assert tg.num_edges == jg.num_edges == 2497
    for a, b in zip(jg.host_edges(), tg.host_edges()):
        np.testing.assert_array_equal(a, b)
    ju = JS.uniform_graph(50, 300, seed=4)
    tu = TS.uniform_graph(50, 300, seed=4, device="cpu")
    for a, b in zip(JS.undirected(ju).host_edges(),
                    TS.undirected(tu).host_edges()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(JS.w_out_deg(jg)),
                                  TS.w_out_deg(tg).numpy())


@pytest.mark.parametrize("case", [
    dict(n=4, src=[0, 5], dst=[1, 2]),
    dict(n=4, src=[0, 1], dst=[1, 2], weight=[1.0, float("nan")]),
    dict(n=4, src=[0, 1], dst=[0, 2], self_loops="error"),
    dict(n=4, src=[0, 0], dst=[1, 1], duplicates="error"),
    dict(n=0, src=[], dst=[]),
])
def test_validation_errors_match(case):
    case = dict(case)
    n, src, dst = case.pop("n"), np.array(case.pop("src")), \
        np.array(case.pop("dst"))
    if "weight" in case:
        case["weight"] = np.array(case["weight"], np.float32)
    from repro.core.guard import GraphValidationError as JErr
    with pytest.raises(JErr) as je:
        JS.from_edges(n, src, dst, **case)
    with pytest.raises(tguard.GraphValidationError) as te:
        TS.from_edges(n, src, dst, device="cpu", **case)
    assert str(je.value) == str(te.value)


def test_self_loop_drop_and_caches(small_graphs):
    g = TS.from_edges(3, np.array([0, 1, 1]), np.array([1, 1, 2]),
                      self_loops="drop", device="cpu")
    assert g.num_edges == 2
    tg = _port(small_graphs["rmat"])
    assert TS.blocked_ell_cached(tg) is TS.blocked_ell_cached(tg)
    TS.push_resolution_cached(tg)
    TS.validate_graph(tg)
    assert TS.clear_graph_caches(tg) == 3
    chk = TS.validate_graph(tg)
    jchk = JS.validate_graph(small_graphs["rmat"])
    assert (chk.w_min, chk.w_max, chk.c_min, chk.c_max) == \
        (jchk.w_min, jchk.w_max, jchk.c_min, jchk.c_max)


def test_identity_and_segment_ops():
    import torch
    from repro.graph import segment as JSeg
    for op in ("min", "max", "sum", "prod", "or", "and"):
        for jdt, tdt in ((np.int32, torch.int32), (np.float32, torch.float32)):
            assert JSeg.identity(op, jdt) == TSeg.identity(op, tdt)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 7, 40)
    data = rng.normal(size=40).astype(np.float32)
    for op in ("min", "max", "sum"):
        want = np.asarray(JSeg.segment_reduce(op, data, ids, 9))
        got = TSeg.segment_reduce(op, torch.from_numpy(data),
                                  torch.from_numpy(ids), 9).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_no_cuda_means_no_silent_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.line_graph(4)
