"""Architecture registry of the port: the five LM architectures, the four
GNNs and the paper's own analytics workload, each selectable via
``--arch <id>``.

Each arch module exposes ``full()`` (the exact published config) and
``smoke()`` (a reduced same-family config for CPU tests), field for field
the reference's (``repro.configs``), plus the family tag that picks the
model code and the shape set.  Only the reference's recsys entry
(dlrm-rm2) is still missing: it joins with its model in the next part of
the ML stack (ROADMAP Queue 1, item 12c); until then ``get`` raises the
reference's ``KeyError`` for it, and ``ASSIGNED`` lists what is
registered.  The shape sets are the reference's, all three families.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_v3_671b, dimenet, egnn,
                                 gat_cora, grafs_analytics, llama3_2_3b,
                                 llama4_maverick_400b_a17b, meshgraphnet,
                                 qwen2_72b, yi_9b)

# ---------------------------------------------------------------------------
# Shape sets (assigned per family).
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k":    {"kind": "train",   "seq": 4_096,   "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32_768,  "batch": 32},
    "decode_32k":  {"kind": "decode",  "seq": 32_768,  "batch": 128},
    "long_500k":   {"kind": "decode",  "seq": 524_288, "batch": 1},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "full",   "n": 2_708,     "e": 10_556,
                      "d_feat": 1_433},
    "minibatch_lg":  {"kind": "sample", "n": 232_965,   "e": 114_615_892,
                      "d_feat": 602, "batch_nodes": 1_024,
                      "fanout": (15, 10)},
    "ogb_products":  {"kind": "full",   "n": 2_449_029, "e": 61_859_140,
                      "d_feat": 100},
    "molecule":      {"kind": "batch",  "n": 30, "e": 64, "batch": 128,
                      "d_feat": 16},
}

RECSYS_SHAPES = {
    "train_batch":    {"kind": "train",     "batch": 65_536},
    "serve_p99":      {"kind": "serve",     "batch": 512},
    "serve_bulk":     {"kind": "serve",     "batch": 262_144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}

SHAPES_BY_FAMILY = {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                    "recsys": RECSYS_SHAPES, "analytics": {}}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str            # lm | gnn | recsys | analytics
    kind: str               # lm | gat | egnn | mgn | dimenet | dlrm | grafs
    module: object

    @property
    def shapes(self):
        return SHAPES_BY_FAMILY[self.family]

    def full(self):
        return self.module.full()

    def smoke(self):
        return self.module.smoke()


ARCHS = {
    "llama3.2-3b": ArchEntry("llama3.2-3b", "lm", "lm", llama3_2_3b),
    "qwen2-72b": ArchEntry("qwen2-72b", "lm", "lm", qwen2_72b),
    "yi-9b": ArchEntry("yi-9b", "lm", "lm", yi_9b),
    "deepseek-v3-671b": ArchEntry("deepseek-v3-671b", "lm", "lm",
                                  deepseek_v3_671b),
    "llama4-maverick-400b-a17b": ArchEntry(
        "llama4-maverick-400b-a17b", "lm", "lm", llama4_maverick_400b_a17b),
    "dimenet": ArchEntry("dimenet", "gnn", "dimenet", dimenet),
    "meshgraphnet": ArchEntry("meshgraphnet", "gnn", "mgn", meshgraphnet),
    "egnn": ArchEntry("egnn", "gnn", "egnn", egnn),
    "gat-cora": ArchEntry("gat-cora", "gnn", "gat", gat_cora),
    "grafs-analytics": ArchEntry("grafs-analytics", "analytics", "grafs",
                                 grafs_analytics),
}

ASSIGNED = [a for a in ARCHS if a != "grafs-analytics"]


def get(arch_id: str) -> ArchEntry:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def skip_reason(arch_id: str, shape: str):
    """Cells that are skipped by the assignment rules, with the reason."""
    entry = get(arch_id)
    if entry.family == "lm" and shape == "long_500k":
        cfg = entry.full()
        if cfg.attn_chunk is None:
            return ("pure full-attention arch: 512k-token decode is "
                    "quadratic-prohibitive; skipped per assignment rule "
                    "(DESIGN.md §Arch-applicability)")
    return None
