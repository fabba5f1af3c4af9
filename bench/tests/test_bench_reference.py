"""The plain reference against the port's ``pull`` engine, the control
against the comparison, and the byte yardstick against a hand count."""
import numpy as np
import pytest
import torch

import harness
from control import control
from reference import compare, graphgen, paths, roofline

from repro_torch.core import engine, fusion, usecases

CONFIGS = {"uniform": {"generator": "uniform", "graph_seed": 4, "scale": 7,
                       "edge_factor": 4,
                       "weight_range": [1, 255],
                       "capacity_range": [1, 255]},
           "kronecker": {"generator": "kronecker", "graph_seed": 4,
                         "scale": 8,
                         "edge_factor": 8, "initiator": [0.57, 0.19, 0.19],
                         "weight_range": [1, 255],
                         "capacity_range": [1, 255]}}


@pytest.mark.parametrize("gen", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["BFS", "SSSP", "WP", "WSP"])
def test_bench_reference_matches_pull_engine(gen, kind):
    from repro_torch.graph import structure
    e = graphgen.generate(CONFIGS[gen])
    g = structure.from_edges(e["n"], e["src"], e["dst"], e["weight"],
                             e["capacity"], device="cpu")
    rg = paths.ref_graph(e)
    spec = getattr(usecases, kind.lower())
    roots = np.flatnonzero(graphgen.out_degree(e) >= 1)[::7][:8]
    for root in roots:
        got = engine.run_program(g, fusion.fuse(spec(int(root))),
                                 engine="pull", device="cpu").value.numpy()
        want = paths.answer(rg, kind, int(root))
        assert got.dtype == want.dtype
        assert compare.wrong_vertices(got, want) == 0, (kind, root)


def test_bench_generators_are_seeded_and_clean():
    for cfg in CONFIGS.values():
        a = graphgen.generate(cfg)
        b = graphgen.generate(cfg)
        c = graphgen.generate(dict(cfg, graph_seed=cfg["graph_seed"] + 1))
        assert all(np.array_equal(a[k], b[k]) for k in a if k != "n")
        assert not np.array_equal(a["src"], c["src"])
        key = a["src"].astype(np.int64) * a["n"] + a["dst"]
        assert (np.diff(key) > 0).all()              # sorted, no duplicates
        assert (a["src"] != a["dst"]).all()
        lo, hi = cfg["weight_range"]
        assert a["weight"].min() >= lo and a["weight"].max() <= hi
        # undirected: each arc's reverse is there, with its weights
        back = np.argsort(a["dst"].astype(np.int64) * a["n"] + a["src"])
        assert np.array_equal(a["src"][back], a["dst"])
        assert np.array_equal(a["dst"][back], a["src"])
        assert np.array_equal(a["weight"][back], a["weight"])
        assert np.array_equal(a["capacity"][back], a["capacity"])
        pool = graphgen.root_pool(a, 16, cfg["graph_seed"])
        assert list(pool) == list(graphgen.root_pool(b, 16,
                                                     cfg["graph_seed"]))
        assert len(set(pool)) == 16
        assert (graphgen.out_degree(a)[pool] >= 1).all()


def test_bench_traffic_is_the_same_pairs_in_another_order():
    cell = harness.load_cell(harness.load_benchmark(), "urand22-solo")
    e = graphgen.generate(dict(cell.config, scale=10))
    w5, warm5 = harness.mix_traffic(cell, e, 5)
    w6, warm6 = harness.mix_traffic(cell, e, 2 ** 31 + 6)
    assert sorted(w5.pairs) == sorted(w6.pairs) and w5.pairs != w6.pairs
    kinds = cell.mix["kinds"]
    assert len(w5.pairs) == cell.mix["root_pool"] * len(kinds)
    assert warm5.pairs == warm6.pairs
    assert len(warm5.pairs) == cell.mix["warmup_per_kind"] * len(kinds)
    assert not {r for _, r in warm5.pairs} & {r for _, r in w5.pairs}
    sent = [w5.next(0, 0.0) for _ in range(len(w5.pairs) + 3)]
    assert [(q.kind, q.root) for q in sent[-3:]] == w5.pairs[:3]


def test_bench_kronecker_labels_are_permuted():
    # unpermuted, a vertex's degree falls with the 1-bits of its label (the
    # initiator's A quadrant is the heaviest); permuted, the two are
    # unrelated
    e = graphgen.generate(CONFIGS["kronecker"])
    deg = np.bincount(e["dst"], minlength=e["n"]).astype(float)
    ones = np.array([bin(v).count("1") for v in range(e["n"])], float)
    assert deg.max() > 4 * deg.mean()
    assert abs(np.corrcoef(ones, deg)[0, 1]) < 0.25


@pytest.mark.parametrize("workload", ["urand22-serve", "kron16-serve",
                                      "urand22-solo"])
def test_bench_lower_precision_fails_the_comparison(workload):
    cell = harness.load_cell(harness.load_benchmark(), workload)
    out = control(cell, seed=2 ** 31 + 99, device="cpu",
                  overrides={"scale": 10})
    assert out["numbers"]["wrong_vertices"] > compare.LIMITS["wrong_vertices"]
    assert out["correct"] is False
    assert out["by_kind"]["BFS"] > 0


def test_bench_needed_bytes_hand_count():
    # 0 -> 1 -> 2 -> 3, 1 -> 3, 2 -> 0, and 4 -> 5 out of reach of 0
    e = {"n": 6, "src": np.array([0, 1, 1, 2, 2, 4], np.int32),
         "dst": np.array([1, 2, 3, 0, 3, 5], np.int32),
         "weight": np.ones(6, np.float32),
         "capacity": np.ones(6, np.float32)}
    g = paths.ref_graph(e)
    reached, out_edges = paths.reach(g, 0)
    assert (reached, out_edges) == (4, 5)        # 0, 1, 2, 3; 1+2+2+0
    # BFS: 5 edges x 4 B + 4 vertices x 2 components x 4 B
    assert roofline.needed_bytes("BFS", reached, out_edges) == 20 + 32
    # SSSP reads the weight: 5 x 8 + 4 x 4
    assert roofline.needed_bytes("SSSP", reached, out_edges) == 40 + 16
    assert roofline.needed_bytes("WP", reached, out_edges) == 40 + 16
    # WSP reads the capacity and keeps hops and width: 5 x 8 + 4 x 8
    assert roofline.needed_bytes("WSP", reached, out_edges) == 40 + 32
    assert paths.reach(g, 4) == (2, 1)
    # 4 queries in flight share each edge's read: a quarter of the edges
    assert roofline.needed_bytes("SSSP", reached, out_edges, 4) == 10 + 16


def test_bench_reference_hand_answers():
    e = {"n": 5, "src": np.array([0, 0, 1, 2, 1], np.int32),
         "dst": np.array([1, 2, 3, 3, 2], np.int32),
         "weight": np.array([1, 5, 1, 1, 1], np.float32),
         "capacity": np.array([4, 9, 2, 7, 3], np.float32)}
    g = paths.ref_graph(e)
    bot = paths.INT_BOT
    assert paths.answer(g, "BFS", 0).tolist() == [0, 0, 0, 1, bot]
    assert paths.answer(g, "SSSP", 0).tolist() == [0, 1, 2, 2, np.inf]
    inf = float(np.float32(1e30))
    assert paths.answer(g, "WP", 0).tolist() == [inf, 4, 9, 7, -np.inf]
    # fewest hops to 3 are 0-1-3 (min 2) and 0-2-3 (min 7)
    assert paths.answer(g, "WSP", 0).tolist() == [inf, 4, 9, 7, -np.inf]
    assert paths.answer(g, "BFS", 0, torch.bfloat16).tolist() == \
        [0, 0, 0, 1, bot]
