"""The port's GNNs and their data path against the JAX package's, on the CPU.

``repro_torch.models.gnn``, ``repro_torch.data.graphs``,
``repro_torch.graph.sampler``, ``structure.cora_like`` and the four GNN
configs held against ``repro``'s.  Each model loads the reference's own
parameters (``*_init(cfg, PRNGKey(0))``, through numpy) and takes the
inputs of the reference's own generators at a numpy seed, at ``smoke()``
and at ``full()`` on a small graph (``cora_batch`` n 64, a 6 × 6 mesh, 2
molecules × 8 atoms); this file runs the ``smoke()`` cases and the data
path, ``test_torch_gnn_full.py`` (GAT, EGNN) and
``test_torch_gnn_full_mgn_dimenet.py`` the ``full()`` cases with the same
checks (three files, so the suite's workers share them).  In float32 the forward outputs (EGNN's coordinates
too) are held allclose at rtol = atol = 1e-4 (two float32 summation
orders over up to 15 layers), the loss within rtol 1e-5, and DimeNet's
wedge cosines within 1e-6 before its outputs (``arccos`` is
ill-conditioned where |cos| → 1; the worst wedge's |cos| is printed: 72
wedges, 0.98994, Δcos 0 on the CPU).
The vertex-cut forwards run on ``ShardMesh.on("cpu", k)``: one shard
against the reference's ``*_loss_dist(..., ())`` within 1e-5, two and four
shards against the reference's single-device model within 1e-4.  Every
generator and the sampler are held bitwise; the reference's outputs are
computed once per case per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import graphs as RDG
from repro.graph import sampler as RSa
from repro.graph import structure as RS
from repro.models import gnn as RG
import repro_torch.configs as TC
from repro_torch.data import graphs as TDG
from repro_torch.graph import sampler as TSa
from repro_torch.graph import segment as TSeg
from repro_torch.graph import structure as TS
from repro_torch.graph.partition import ShardMesh
from repro_torch.models import gnn as TG

KEY = jax.random.PRNGKey(0)
SEED = 3
TOL = dict(rtol=1e-4, atol=1e-4)
GNN_ARCHS = ["gat-cora", "egnn", "meshgraphnet", "dimenet"]
SIZES = ["smoke", "full"]
INIT = {"gat": RG.gat_init, "egnn": RG.egnn_init, "mgn": RG.mgn_init,
        "dimenet": RG.dimenet_init}
LOSS = {"gat": RG.gat_loss, "egnn": RG.egnn_loss, "mgn": RG.mgn_loss,
        "dimenet": RG.dimenet_loss}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _port(batch: dict) -> dict:
    """A reference batch's arrays as CPU tensors (ints and n_graphs kept)."""
    return {k: torch.from_numpy(np.array(v)) if not isinstance(v, int) else v
            for k, v in batch.items()}


def _ref_batch(kind, cfg):
    if kind == "gat":
        return RDG.cora_batch(n=64, e=256, d_feat=cfg.d_in, seed=SEED)
    if kind == "mgn":
        return RDG.mesh_batch(rows=6, cols=6, d_node_in=cfg.d_node_in,
                              d_edge_in=cfg.d_edge_in, d_out=cfg.d_out,
                              seed=SEED)
    if kind == "egnn":
        return RDG.egnn_batch(n_graphs=2, n_atoms=8, seed=SEED)
    b = RDG.molecule_batch(n_graphs=2, n_atoms=8, n_species=cfg.n_species,
                           seed=SEED)
    b.pop("n_graphs")
    return b


def _ref_forward(kind, cfg, p, b):
    if kind == "gat":
        return RG.gat_forward(cfg, p, b["x"], b["src"], b["dst"],
                              b["x"].shape[0])
    if kind == "mgn":
        return RG.mgn_forward(cfg, p, b["node_x"], b["edge_x"], b["src"],
                              b["dst"], b["node_x"].shape[0])
    if kind == "egnn":
        return RG.egnn_forward(cfg, p, b["feats"], b["coords"], b["src"],
                               b["dst"], b["feats"].shape[0])
    return RG.dimenet_forward(cfg, p, b["species"], b["coords"], b["src"],
                              b["dst"], b["t_kj"], b["t_ji"],
                              b["species"].shape[0])


def _args(kind, b):
    """The port's forward arguments from a port batch."""
    if kind == "gat":
        return b["x"], b["src"], b["dst"], b["x"].shape[0]
    if kind == "mgn":
        return (b["node_x"], b["edge_x"], b["src"], b["dst"],
                b["node_x"].shape[0])
    if kind == "egnn":
        return (b["feats"], b["coords"], b["src"], b["dst"],
                b["feats"].shape[0])
    return (b["species"], b["coords"], b["src"], b["dst"], b["t_kj"],
            b["t_ji"], b["species"].shape[0])


class _Case:
    """One arch at one size: the reference's parameters, batch and
    outputs, and the port's model on the same parameters."""

    def __init__(self, arch, size):
        entry = RC.get(arch)
        self.kind = entry.kind
        self.cfg = getattr(entry, size)()
        self.tcfg = getattr(TC.get(arch), size)()
        kind, cfg = self.kind, self.cfg
        self.params = jax.jit(lambda k: INIT[kind](cfg, k))(KEY)
        self.tree = jax.tree.map(np.asarray, self.params)
        self.model = TG.load_reference_params(self.tcfg, self.tree,
                                              device="cpu")
        self.batch = _ref_batch(kind, cfg)
        self.tbatch = _port(self.batch)
        self.out, loss = jax.jit(lambda p, b: (
            _ref_forward(kind, cfg, p, b), LOSS[kind](cfg, p, b)))(
                self.params, self.batch)
        self.loss = float(loss)


@pytest.fixture(scope="module")
def cases():
    made = {}

    def get(arch, size):
        if (arch, size) not in made:
            made[arch, size] = _Case(arch, size)
        return made[arch, size]
    return get


def _ref_cosang(b):
    """The reference forward's wedge cosines (``gnn.py`` dimenet_forward's
    own lines)."""
    c = b["coords"]
    diff = c[b["dst"]] - c[b["src"]]
    v1, v2 = -diff[b["t_kj"]], diff[b["t_ji"]]
    return jnp.sum(v1 * v2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(v1, axis=-1) * jnp.linalg.norm(v2, axis=-1), 1e-9)


def check_forward(c):
    """The port's forward against the reference's outputs."""
    got = c.model(*_args(c.kind, c.tbatch))
    if c.kind == "egnn":
        (out, x), (ref_out, ref_x) = got, c.out
        np.testing.assert_allclose(_np(x), np.asarray(ref_x), **TOL)
        got, want = out, ref_out
    else:
        want = c.out
    if c.kind == "dimenet":
        b, tb = c.batch, c.tbatch
        cos = TG.dimenet_geometry(c.tcfg, tb["coords"], tb["src"],
                                  tb["dst"], tb["t_kj"], tb["t_ji"])[2]
        ref_cos = np.asarray(_ref_cosang(b))
        worst = float(np.abs(ref_cos).max())
        print(f"{c.cfg.name}: {ref_cos.shape[0]} wedges, worst |cos| "
              f"{worst:.9f}, max |Δcos| "
              f"{float(np.abs(_np(cos) - ref_cos).max()):.3e}")
        np.testing.assert_allclose(_np(cos), ref_cos, rtol=0, atol=1e-6)
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def check_loss(c):
    got = float(c.model.loss(c.tbatch))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, c.loss, rtol=1e-5)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_forward_matches_reference(cases, arch):
    check_forward(cases(arch, "smoke"))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_loss_matches_reference(cases, arch):
    check_loss(cases(arch, "smoke"))


@pytest.mark.parametrize("mask", ["random", "empty"])
def test_gat_loss_mask_matches_reference(cases, mask):
    """``gat_loss``'s mask: Σ(nll · mask) / max(Σ mask, 1)."""
    c = cases("gat-cora", "smoke")
    n = c.batch["x"].shape[0]
    m = (np.random.default_rng(SEED).random(n) < 0.4 if mask == "random"
         else np.zeros(n, bool)).astype(np.float32)
    ref = float(RG.gat_loss(c.cfg, c.params,
                            dict(c.batch, mask=jnp.asarray(m))))
    got = float(c.model.loss(dict(c.tbatch, mask=torch.from_numpy(m))))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0 if mask ==
                               "random" else 1e-12)


def _near(got: float, want: float, tol: float):
    """|got − want| <= tol, relative to |want| beyond 1: the reference's
    own absolute bounds at its smoke losses (O(1)), and the same share of
    the full configs' (the random 15-layer MGN's loss is O(1e6))."""
    assert abs(got - want) <= tol * max(1.0, abs(want)), (got, want)


def _mgn_dist_parts(c, k, pad):
    """The reference's flat [k·…] vertex-cut batch (the construction of its
    own multi-shard test) and the port's k per-shard batches."""
    cfg, b = c.cfg, c.batch
    n = b["node_x"].shape[0]
    src, dst = np.asarray(b["src"]), np.asarray(b["dst"])
    part = RDG.dst_block_partition(src, dst, n, k, pad_factor=pad)
    assert int(part["mask"].sum()) == src.shape[0]
    n_loc = part["n_loc"]
    npad = k * n_loc
    node_x = np.zeros((npad, cfg.d_node_in), np.float32)
    node_x[:n] = np.asarray(b["node_x"])
    target = np.zeros((npad, cfg.d_out), np.float32)
    target[:n] = np.asarray(b["target"])
    nmask = np.zeros(npad, bool)
    nmask[:n] = True
    ex = np.asarray(b["edge_x"])
    edge_x = np.zeros((k, part["e_pad"], cfg.d_edge_in), np.float32)
    for j in range(k):
        sel = np.nonzero(dst // n_loc == j)[0][:part["e_pad"]]
        edge_x[j, :len(sel)] = ex[sel]
    flat = {"node_x": node_x, "edge_x": edge_x.reshape(-1, cfg.d_edge_in),
            "src": part["src"].reshape(-1), "dst": part["dst"].reshape(-1),
            "emask": part["mask"].reshape(-1), "nmask": nmask,
            "target": target}
    tpart = TDG.dst_block_partition(src, dst, n, k, pad_factor=pad)
    shards = TDG.shard_batch({key: np.asarray(v) for key, v in b.items()},
                             tpart, ("node_x", "target"), ("edge_x",),
                             devices=["cpu"] * k)
    return flat, shards


def check_mgn_one_shard(c):
    """One shard (``mesh=None``, the reference's ``axes=()``) against the
    reference's ``mgn_loss_dist(..., ())`` on the same partition."""
    flat, shards = _mgn_dist_parts(c, 1, 2.0)
    for key in ("node_x", "edge_x", "src", "dst", "emask", "nmask",
                "target"):
        assert np.array_equal(_np(shards[0][key]), flat[key]), key
    ref = float(RG.mgn_loss_dist(c.cfg, c.params,
                                 {k: jnp.asarray(v) for k, v in flat.items()},
                                 ()))
    got = float(TG.mgn_loss_dist(c.tcfg, c.model, shards[0]))
    _near(got, ref, 1e-5)
    _near(got, c.loss, 1e-5)


def check_mgn_shards(c, k):
    """k vertex-cut shards on one CPU mesh against the reference's
    single-device loss and outputs."""
    _, shards = _mgn_dist_parts(c, k, 2.0)
    mesh = ShardMesh.on("cpu", k)
    got = float(TG.mgn_loss_dist(c.tcfg, c.model, shards, mesh))
    _near(got, c.loss, 1e-4)
    outs = TG.mgn_forward_dist(
        c.tcfg, c.model, *([s[key] for s in shards] for key in
                           ("node_x", "edge_x", "src", "dst", "emask")),
        mesh)
    n = c.batch["node_x"].shape[0]
    np.testing.assert_allclose(_np(torch.cat(outs))[:n], np.asarray(c.out),
                               **TOL)


def check_egnn_shards(c, k):
    """EGNN's vertex-cut forward on k shards against the reference's
    single-device outputs and coordinates; at one shard its loss against
    the reference's ``egnn_loss_dist(..., ())``."""
    b = {key: np.asarray(v) for key, v in c.batch.items()
         if key != "n_graphs"}
    n = b["feats"].shape[0]
    b["target"] = np.random.default_rng(SEED).normal(
        size=(n, c.cfg.d_out)).astype(np.float32)
    part = TDG.dst_block_partition(b["src"], b["dst"], n, k, pad_factor=2.0)
    assert int(part["mask"].sum()) == b["src"].shape[0]
    shards = TDG.shard_batch(b, part, ("feats", "coords", "target"),
                             devices=["cpu"] * k)
    mesh = ShardMesh.on("cpu", k) if k > 1 else None
    args = [[s[key] for s in shards] if mesh else shards[0][key]
            for key in ("feats", "coords", "src", "dst", "emask")]
    out, x = TG.egnn_forward_dist(c.tcfg, c.model, *args, mesh)
    if mesh is not None:
        out, x = torch.cat(out), torch.cat(x)
    ref_out, ref_x = c.out
    np.testing.assert_allclose(_np(out)[:n], np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(_np(x)[:n], np.asarray(ref_x), **TOL)
    got = float(TG.egnn_loss_dist(c.tcfg, c.model,
                                  shards if mesh else shards[0], mesh))
    if k == 1:
        flat = {key: jnp.asarray(_np(v)) for key, v in shards[0].items()}
        ref = float(RG.egnn_loss_dist(c.cfg, c.params, flat, ()))
        _near(got, ref, 1e-5)
    want = float(np.mean((np.asarray(ref_out) - b["target"]) ** 2))
    _near(got, want, 1e-4)


def test_mgn_dist_one_shard_matches_reference_dist(cases):
    check_mgn_one_shard(cases("meshgraphnet", "smoke"))


@pytest.mark.parametrize("k", [2, 4])
def test_mgn_dist_shards_match_reference(cases, k):
    check_mgn_shards(cases("meshgraphnet", "smoke"), k)


@pytest.mark.parametrize("arch", ["meshgraphnet", "egnn"])
def test_vertex_cut_pads_anywhere(cases, arch):
    """A shard whose padding edges are not a suffix (its edge rows
    permuted) gives the partition layout's outputs: the pads, dropped up
    front, carry no message wherever they lie."""
    c = cases(arch, "smoke")
    b = {key: np.asarray(v) for key, v in c.batch.items()
         if key != "n_graphs"}
    nodes, edges = ((("node_x",), ("edge_x",)) if c.kind == "mgn"
                    else (("feats", "coords"), ()))
    n = b[nodes[0]].shape[0]
    part = TDG.dst_block_partition(b["src"], b["dst"], n, 2, pad_factor=2.0)
    shards = TDG.shard_batch(b, part, nodes, edges, devices=["cpu"] * 2)
    rng = np.random.default_rng(SEED)
    mixed = []
    for s in shards:
        perm = torch.from_numpy(rng.permutation(s["emask"].shape[0]))
        assert not bool(s["emask"][perm][:int(s["emask"].sum())].all())
        mixed.append({key: (v[perm] if key in ("src", "dst", "emask", *edges)
                            else v) for key, v in s.items()})
    keys = (nodes[0], edges[0] if edges else "coords", "src", "dst",
            "emask")
    fwd = TG.mgn_forward_dist if c.kind == "mgn" else TG.egnn_forward_dist
    mesh = ShardMesh.on("cpu", 2)
    want, got = (fwd(c.tcfg, c.model, *([s[key] for s in ss] for key in keys),
                     mesh) for ss in (shards, mixed))
    if c.kind == "mgn":
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(torch.cat(g)), _np(torch.cat(w)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_egnn_dist_shards_match_reference(cases, k):
    check_egnn_shards(cases("egnn", "smoke"), k)


# ---------------------------------------------------------------------------
# Generators and the sampler, bitwise
# ---------------------------------------------------------------------------

def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, int):
            assert g == w and isinstance(g, int), key
            continue
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert np.array_equal(g, w), key


GENERATORS = {
    "cora_batch": (lambda m, **kw: m.cora_batch(n=200, e=900, d_feat=48,
                                                seed=5, **kw)),
    "mesh_batch": (lambda m, **kw: m.mesh_batch(rows=5, cols=7, d_node_in=8,
                                                d_edge_in=4, d_out=2, seed=2,
                                                **kw)),
    "molecule_batch": (lambda m, **kw: m.molecule_batch(
        n_graphs=3, n_atoms=9, n_species=16, seed=4, **kw)),
    "egnn_batch": (lambda m, **kw: m.egnn_batch(n_graphs=2, n_atoms=10,
                                                seed=1, **kw)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_bitwise(name):
    fn = GENERATORS[name]
    want = fn(RDG)
    got = fn(TDG, device="cpu")
    _same(got, want)
    assert all(v.device.type == "cpu" for v in got.values()
               if isinstance(v, torch.Tensor))


def test_cora_like_bitwise():
    g, x, y = RS.cora_like(n=300, e=1200, d_feat=40, seed=2)
    tg, tx, ty = TS.cora_like(n=300, e=1200, d_feat=40, seed=2,
                              device="cpu")
    assert tg.n == g.n
    for a, b in zip(tg.host_edges(), g.host_edges()):
        assert np.array_equal(a, b)
    _same({"x": tx, "y": ty}, {"x": x, "y": y})


def test_triplets_and_partition_bitwise():
    b = RDG.molecule_batch(n_graphs=2, n_atoms=12, seed=6)
    src, dst = np.asarray(b["src"]), np.asarray(b["dst"])
    for cap in (None, 50):
        for got, want in zip(TDG.triplets_for(src, dst, cap),
                             RDG.triplets_for(src, dst, cap)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    one = (np.array([0], np.int32), np.array([1], np.int32))
    assert all(np.array_equal(a, b) for a, b in
               zip(TDG.triplets_for(*one), RDG.triplets_for(*one)))
    n = 24
    # pad 0.3 drops edges past e_pad, as the reference's does
    for k, pad in ((3, 1.3), (5, 2.0), (4, 0.3)):
        got = TDG.dst_block_partition(src, dst, n, k, pad)
        want = RDG.dst_block_partition(src, dst, n, k, pad)
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(np.asarray(got[key]),
                                  np.asarray(want[key])), key
        assert (int(got["mask"].sum()) == src.shape[0]) == (pad > 1)


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_dlrm_batch_bitwise(multi_hot):
    cfg = dataclasses.replace(RC.get("dlrm-rm2").smoke(), multi_hot=multi_hot)
    _same(TDG.dlrm_batch(cfg, 32, seed=9, device="cpu"),
          RDG.dlrm_batch(cfg, 32, seed=9))


def test_neighbor_sampler_bitwise():
    g = RS.rmat_graph(200, 1600, seed=0)
    tg = TS.rmat_graph(200, 1600, seed=0, device="cpu")
    assert TSa.max_nodes_for(8, [4, 3]) == RSa.max_nodes_for(8, [4, 3])
    ref = RSa.NeighborSampler(g, [4, 3], seed=1)
    port = TSa.NeighborSampler(tg, [4, 3], seed=1)
    for seeds in (np.arange(8), np.array([3, 150, 7, 199, 0])):
        want, got = ref.sample(seeds), port.sample(seeds)
        for f in dataclasses.fields(RSa.SampledBatch):
            w, gv = getattr(want, f.name), getattr(got, f.name)
            ws, gs = (w, gv) if isinstance(w, list) else ([w], [gv])
            assert len(ws) == len(gs)
            for a, b in zip(gs, ws):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name


# ---------------------------------------------------------------------------
# Configs, parameters, invariances, the segment sum, the device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_configs_equal_reference(arch):
    ref, port = RC.get(arch), TC.get(arch)
    assert (port.arch_id, port.family, port.kind, port.shapes) == \
        (ref.arch_id, ref.family, ref.kind, ref.shapes)
    for size in SIZES:
        assert dataclasses.asdict(getattr(port, size)()) == \
            dataclasses.asdict(getattr(ref, size)())
    rcls, tcls = type(ref.full()), type(port.full())
    assert tcls.__name__ == rcls.__name__
    assert [(f.name, f.default) for f in dataclasses.fields(tcls)] == \
        [(f.name, f.default) for f in dataclasses.fields(rcls)]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_load_reference_params_round_trips(cases, arch):
    c = cases(arch, "smoke")
    want = dict(_paths(c.tree))
    got = dict(_paths(c.model.tree()))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, w in want.items():
        g = _np(got[path])
        assert g.dtype == w.dtype and np.array_equal(g, w), path
    assert all(p.device.type == "cpu" and not p.requires_grad
               for p in c.model.parameters())
    # the port's own init draws the reference's shapes
    port = {"gat": TG.gat_init, "egnn": TG.egnn_init, "mgn": TG.mgn_init,
            "dimenet": TG.dimenet_init}[c.kind](
        c.tcfg, torch.Generator().manual_seed(1), device="cpu")
    shapes = {p: tuple(_np(t).shape) for p, t in _paths(port.tree())}
    assert shapes == {p: w.shape for p, w in want.items()}


def _rotation(th):
    return np.array([[np.cos(th), -np.sin(th), 0],
                     [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)


def check_egnn_rotation(c):
    """EGNN's outputs invariant and coordinates equivariant under a
    rotation, in the port (the reference's own check)."""
    b = c.tbatch
    n = b["feats"].shape[0]
    rot = torch.from_numpy(_rotation(0.7))
    out1, x1 = c.model(b["feats"], b["coords"], b["src"], b["dst"], n)
    out2, x2 = c.model(b["feats"], b["coords"] @ rot.T, b["src"], b["dst"],
                       n)
    np.testing.assert_allclose(_np(out1), _np(out2), atol=1e-4)
    np.testing.assert_allclose(_np(x1 @ rot.T), _np(x2), atol=1e-4)


def check_dimenet_rotation(c):
    """DimeNet consumes distances and angles only: its outputs are rotation
    invariant, in the port (the reference's own check)."""
    b = c.tbatch
    rot = torch.from_numpy(_rotation(1.1))
    args = list(_args("dimenet", b))
    out1 = c.model(*args)
    args[1] = b["coords"] @ rot.T
    out2 = c.model(*args)
    np.testing.assert_allclose(_np(out1), _np(out2), atol=1e-3)


def test_rotation_checks_in_port(cases):
    check_egnn_rotation(cases("egnn", "smoke"))
    check_dimenet_rotation(cases("dimenet", "smoke"))


@pytest.mark.parametrize("shape", [(), (3,), (2, 4)])
def test_segment_sum_rows_match_float64(shape):
    """``segment.segment_sum`` of rows [e, …] (sorted and unsorted ids,
    empty segments) against a float64 numpy sum; the [e, H] softmax
    against its columns taken one by one."""
    rng = np.random.default_rng(11)
    e, n = 60, 13
    ids = np.sort(rng.integers(0, n - 3, e)).astype(np.int32)  # 3+ empty
    data = rng.normal(size=(e, *shape)).astype(np.float32)
    want = np.zeros((n, *shape))
    np.add.at(want, ids, data.astype(np.float64))
    for perm in (np.arange(e), rng.permutation(e)):
        got = TSeg.segment_sum(torch.from_numpy(data[perm]),
                               torch.from_numpy(ids[perm]), n)
        assert got.shape == (n, *shape) and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
        assert not _np(got)[n - 3:].any()
    empty = TSeg.segment_sum(torch.zeros((0, *shape)),
                             torch.zeros(0, dtype=torch.int32), 4)
    assert empty.shape == (4, *shape) and not empty.any()
    if len(shape) == 1:
        sc = torch.from_numpy(data) * 4
        alpha = TSeg.segment_softmax(sc, torch.from_numpy(ids), n)
        for h in range(shape[0]):
            col = TSeg.segment_softmax(sc[:, h].contiguous(),
                                       torch.from_numpy(ids), n)
            np.testing.assert_allclose(_np(alpha[:, h]), _np(col),
                                       rtol=1e-6, atol=1e-7)
        sums = _np(TSeg.segment_sum(alpha, torch.from_numpy(ids), n))
        np.testing.assert_allclose(sums[:n - 3], 1.0, rtol=1e-6)
    with pytest.raises(TypeError):
        TSeg.segment_sum(torch.ones(3, dtype=torch.int32),
                         torch.zeros(3, dtype=torch.int32), 2)


def test_device_rule_without_a_card(monkeypatch):
    """``device=None`` is the card: without one every entry point raises
    ``RuntimeError``; ``device="cpu"`` runs here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get("gat-cora").smoke()
    gen = torch.Generator().manual_seed(0)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda k: RG.gat_init(RC.get("gat-cora").smoke(), k))(KEY))
    calls = [lambda: TG.gat_init(cfg, gen),
             lambda: TG.egnn_init(TC.get("egnn").smoke(), gen),
             lambda: TG.mgn_init(TC.get("meshgraphnet").smoke(), gen),
             lambda: TG.dimenet_init(TC.get("dimenet").smoke(), gen),
             lambda: TG.load_reference_params(cfg, tree),
             lambda: TDG.cora_batch(n=16, e=40),
             lambda: TDG.molecule_batch(n_graphs=1, n_atoms=4),
             lambda: TS.cora_like(n=20, e=40, d_feat=8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = TG.gat_init(cfg, gen, device="cpu")
    assert model.device.type == "cpu"
    with pytest.raises(TypeError):
        TG.GNN(RC.get("gat-cora").smoke(), {})
