#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of GraFS on one CUDA card.

    python3 chip_smoke.py            # one card, no arguments

Run from the root of a checkout: it imports ``src/repro_torch`` (and
nothing of JAX or of the JAX package ``repro``), builds the CUDA edge-sweep
kernels from ``src/repro_torch/csrc`` with nvcc on first use (all rounds'
libraries at once, into ``build/repro_torch/``), and then

1. holds each kernel (pull sweep in both modes, push sweep, sorted push
   resolution) against its plain PyTorch version on the card, on the
   layouts of the Graph500-style Kronecker graph ``rmat_graph(65536,
   1048576, seed=16)`` (SCALE 16, edge factor 16) at frontier densities
   0.05 and 1.0 for BFS (int min), WSP (two lex levels) and weighted
   PageRank (float sum): the pull outputs with the given activity and with
   the activity derived in the kernel (and that activity against the torch
   ``tile_activity``) and the resolve outputs, has-pred included, must be
   bitwise equal in full, the push candidates on every tile the push sweep
   runs (it leaves a skipped tile undefined); each case runs once more with
   the push buffer and every pull output filled with a NaN payload before
   the launches, and must give the same bits; times each kernel with CUDA
   events beside its plain version and its memory bound (the bytes the
   kernel must move, counting of the per-edge inputs only those the
   round's P reads, and of the candidates only those of the tiles that
   run), and the derived-activity pull beside the parent's pull step (the
   torch tile activity, then the sweep).  Then each kernel's batched launch,
   8 query slots (each with its own frontier and states) over the shared
   layouts, for BFS and weighted PageRank at densities 0.05 and 1.0 on both
   graphs: every slot bitwise its solo plain version, from fresh and from
   poisoned buffers (push on the tiles it runs), timed beside 8 solo
   launches and its bound (the layout bytes of the tiles any slot runs and
   the shared vectors once, each slot's own bytes once per slot);
2. checks the RM-XS work counters against the reference's
   (BENCH_pallas.json) and a small query against the path oracle;
3. drives the main path — ``engine.run_program`` / ``run_direct`` with
   ``engine="cuda"`` — on the SCALE-16 graph (BFS, SSSP, WSP, CC on its
   undirected closure, PageRank, weighted PageRank with ``model="push"``)
   and on ``uniform_graph(2**21, 2**25, seed=21)`` (BFS, PageRank), each
   held against the port's own ``pull`` engine on the card (idempotent
   rounds bitwise, PageRank allclose rtol 1e-5).  The kernel launch counts
   are set to 0 just before each graph's queries and read just after;
   between the two graphs, the three kernels are held bitwise against
   their plain versions once more on the uniform graph's layouts (its
   262,144 row tiles exceed a CUDA grid's y limit), for BFS, PageRank and
   weighted PageRank at frontier densities 0.05 and 1.0.  Those
   comparison launches are not counted.  Warm re-runs of three queries go
   under torch.profiler (device busy time, idle share, top kernels, the
   device time of the pull and push steps); the weighted-PageRank push one
   fails if a torch gather runs every iteration (its has-pred probe lives
   in the resolve kernel), the two BFS ones if a torch gather or index
   kernel inside the pull steps runs once per pull iteration or more (the
   pull tile activity lives in the pull kernel) or the pull kernel does
   not launch once per pull iteration;
4. drives the entry points of the four kernels off the graph main path,
   each at the shapes the repository's configurations give it, with its
   launch count set to 0 just before its phase's driving calls and read
   just after (the comparison and timing launches that follow are not
   counted):
   - ``edge_reduce.ell_level_reduce`` on the SCALE-16 in-layout (int
     ``n + 1``, float ``n + w``, a two-level lex with ``bests``, ``nonbot``
     mode) and on the uniform graph's (int ``n + 1``), bitwise against its
     plain version; each case line also gives the walk's grid, the most
     non-empty tiles one row tile holds and the cell buffer's bytes;
   - ``ops.ell_softmax`` over both in-layouts with their masks, within
     1e-6 and every masked slot exactly 0; its bound counts the bytes the
     work needs (``segment_softmax.ell_softmax_bytes``: each slot's mask
     byte and output, each real slot's score), the all-slot count beside
     it; the case line also gives the kernel's registers and spills and,
     as a yardstick, ``torch.softmax`` of a ``masked_fill`` (two calls,
     NaN on an empty row);
   - ``ops.embedding_bag`` on one DLRM RM2 table (4,000,000 × 64,
     ``configs/dlrm_rm2.py``) for 65,536 bags of K = 1 and K = 8, sum, mean
     and weighted, and a bfloat16 table, bitwise; each case line names the
     kernel's path (vector or scalar) and its columns per thread;
   - ``flash_attention.flash_attention`` at llama3.2-3B's attention shape
     (24 heads, 8 KV heads, d_head 128, ``configs/llama3_2_3b.py``) with
     S = T = 4096, causal and causal with chunk 1024, in bfloat16 (the
     kernel ``flash_sm90_kernel``) and in float32 (the 3xTF32 kernel
     ``flash_3xtf32_kernel``), and float32 at S = T = 1024 causal:
     elementwise within one bfloat16 step (2^-7 of the element) + 1e-4 in
     bfloat16 and 1e-5 + 1e-5 of the element in float32 of its plain
     version (a float32 case also reports its share of that limit against
     the plain version in float64, and a peaked softmax, q × 8, is held to
     the float64 one and reports the float32 plain version's own share);
     both kernels' registers, spills and
     shared memory are printed per head dim; the float32 bound charges
     three TF32 products at the TF32 rate, the CUDA-core bound beside it;
   each timed with CUDA events beside its plain version, its bound and,
   where one PyTorch call computes the same function
   (``F.embedding_bag``, ``F.scaled_dot_product_attention``), that call;
5. drives the engines beside ``cuda`` and its fallback chain:
   - ``engine="adaptive"`` (torch segment ops, the per-iteration
     pull/push switch) on the SCALE-16 graph: BFS, SSSP, WSP, WP and CC on
     the undirected closure bitwise equal to the ``cuda`` answers, PageRank
     allclose (rtol 1e-5) with the same iteration count; on the uniform
     graph, BFS bitwise;
   - ``engine="dense"`` on ``rmat_graph(16384, 262144, seed=16)`` ([n, n]
     float32 matrices of 1.07 GB each): BFS and SSSP bitwise, PageRank
     allclose, against the ``pull`` engine, with the peak device memory;
   - the handwritten kernel sets (paper Fig. 11) on the SCALE-16 graph with
     ``engine="cuda"``: SSSP, BFS depth, WP and CC (undirected) equal to the
     synthesized programs' ``cuda`` answers bit for bit wherever the value
     is not ⊥ (⊥-ish values collapsed to one token, as the reference's test
     does: the handwritten WP starts its source at +inf, the synthesized one
     at 1e30), with equal iterations, edge work and push iterations; their
     launches of the three sweep kernels are set to 0 before and read
     after, and each must have launched;
   - ``fallback=True``: an SSSP query whose ``ops.iterate_cuda`` is
     replaced by one that raises a ``RuntimeError`` (a failure outside the
     kernel layer), and one whose kernel layer raises an out-of-memory
     error, end on ``adaptive`` with one fallback event and the ``cuda``
     answer's bits; one whose ``iterate_cuda`` raises
     ``KernelLaunchError``, and one whose round library lacks its entry
     points (a fault inside the kernel layer), propagate a
     ``KernelLaunchError`` with no retry; a clean one stays on ``cuda``
     with no event.  Every other ``cuda`` query of the run
     reports ``engine_used == "cuda"`` and no fallback.
   Each query line gives iterations, pull iterations, edge work and the
   wall time beside the ``cuda`` query's;
6. drives the chunked, checkpointed and warm-started ``cuda`` fixpoints
   through ``run_program`` / ``run_direct``, with snapshots in a temporary
   directory removed at the end: on the SCALE-16 graph BFS (checkpoint
   every 2 iterations), PageRank (pull−) and weighted PageRank with
   ``model="push"`` (every 10), on the uniform graph BFS (every 2).  Each
   query runs whole, in chunks, and killed through ``fault_hook`` after
   its second chunk and resumed (``resume=True``); the chunked and the
   resumed run must give the whole run's state bits, its six counters
   and its launches of the three sweep kernels (set to 0 before each run
   and read after; the killed run's and the resumed run's summed).  SSSP
   warm-started from its converged state (``return_state`` /
   ``init_state``) through both entry points takes one iteration to the
   same bits, and resuming BFS under another source raises
   ``CheckpointMismatchError``, with ``fallback=True`` too.  Each line
   gives the snapshot bytes, the median save ms per chunk, the restore ms
   and the warm walls of the chunked and the whole query.
7. serves batched queries, 8 sources at a time (seeded, with out-degree
   > 0), through ``run_program_batch`` and ``run_direct(sources=)`` with
   the ``cuda`` engine: on the SCALE-16 graph BFS, SSSP, WSP and WP on
   auto direction, SSSP with ``model="pull"`` and ``"push"``, NSP (the
   pull− recompute with has-pred) and the handwritten SSSP; on the uniform
   graph BFS.  Every slot must equal its solo ``cuda`` query bitwise (NaN
   equal to NaN) with its six counters, and each sweep kernel, its launch
   count set to 0 before the batch and read after, must have launched at
   most once per batch iteration and fewer times than the solo queries.
   Then SSSP is served in chunks of 2 iterations through ``return_state``
   / ``init_state``, each retired slot taking the next of 12 sources with
   a fresh ``batch_init_state`` row, every answer equal to its solo query.
   Each line gives iterations per slot, launches per kernel, the batch's
   first and warm walls beside the solo queries' summed walls, queries per
   second, the peak device memory and the card's name and power limit.
8. mutates the graphs through ``graph.mutate.mutate_edges`` (the layouts
   patched on the card) and runs delta-seeded queries (``init_state`` from
   the query's converged answer before the mutation, ``delta=`` the
   mutation) against the cold ``cuda`` query on the mutated graph, with
   the incremental bench's perturbation (seed 7, 0.5 % of |E| random
   inserts, weights 0.1 + U[0, 1)): on the SCALE-16 graph BFS, SSSP and WP
   bitwise with strictly less edge work, PageRank (``tol`` 1e-4 / n)
   within a hundredth of the mean rank in no more iterations, a second
   mutation of the mutated graph (BFS), a batch of 1,000 deleted edges
   (BFS must plan "full" and equal the cold query on a canonical rebuild),
   and one row given one insert more than it has free slots (one counted
   rebuild, two patched layouts); CC on the undirected closure with each
   insert in both directions; BFS on the uniform graph.  Each cold answer
   is also held against the pull engine, bitwise (PageRank allclose, rtol
   1e-5).  Each mutation runs once under torch.profiler for its device
   time, that graph dropped, then once unprofiled for its wall.  Each line
   gives the mutation's wall, device and host ms, the patched and rebuilt
   layouts, the delta and cold queries' six counters, launches and first
   and warm walls, the peak device memory and the card.
9. serves seeded open-loop MIX traces (``service.standard_mix``: BFS and
   SSSP from random sources, a quarter radius/drr scalars; seed 0, 16
   arrivals per chunk's virtual time) through the continuous-batching
   analytics service (``launch/service.py``) on the card: on RM-XS,
   unweighted and weighted, at the reference bench's serving config (6
   slots, chunks of 4, 16 requests), whose deterministic fields must equal
   ``BENCH_pallas.json``'s ``serving_rows``; on the SCALE-16 graph at the
   reference service's defaults (8 slots, chunks of 4, 8 scalars a round,
   4 graphs) 64 requests cold, the same trace on a fresh service (equal
   virtual metrics) and once more under torch.profiler (idle share, top
   device ops, each batch chunk's host set-up), then 16 repeats of the
   trace's batch-lane requests queued across ``mutate_graph`` with phase
   8's perturbation and drained (warm joins >= 1, every repeat bitwise
   its solo query on the mutated graph); on the uniform graph 32
   requests.  Each trace's answers pass ``verify_sequential`` (bitwise
   their solo queries, whose walls are summed) and are held bitwise
   against the pull engine (scalars as float64; on the uniform graph the
   first 4 of each lane); every query stays on ``cuda`` with no fallback
   and the carried lane state stays a card tensor.  Each line gives the
   virtual and wall metrics, launches per kernel, the libraries the trace
   built and their nvcc seconds, the chunks' host set-up, the lane-state
   and memo bytes and the peak device memory.
10. runs the sharded engines: k = 4 vertex-cut shards of one graph on the
   card (``partition.ShardMesh.on(card, 4)``), each holding its own
   widened blocked-ELL pair and resolution and launching the pull, push and
   resolve kernels on them, the partials folded across shards, through
   ``run_program`` / ``run_direct`` with ``engine="cuda_sharded"``.  The
   single-device cuda answers of a graph come first; then its caches are
   dropped and the sharded layouts built (timed), one strategy at a time.
   On the SCALE-16 graph, with both strategies (``contiguous``,
   ``dst_hash``): BFS, SSSP, WSP, WP on auto direction, BFS pinned to pull
   and to push, bitwise the single-device answer with equal iterations
   and push iterations; PageRank and weighted PageRank with
   ``model="push"`` allclose (rtol 1e-5), both iteration counts printed;
   CC on the undirected closure bitwise; on the uniform graph
   (contiguous) BFS bitwise and PageRank allclose; ``engine="distributed"``
   BFS on the SCALE-16 graph bitwise the pull engine; and k = 5 shards of
   ``line_graph(4)``, two of them empty.  Each kernel's launch count, set
   to 0 before the query and read after, must be k times the
   single-device query's (k per iteration of its direction).  Each line
   gives the per-shard edge work, launches, the sharded set-up seconds,
   the first and warm walls beside the single-device ones and the peak
   device memory;
11. writes the analytics dry-run's records (``launch/analytics_dryrun.py``,
   the reference's one fused WSP fixpoint vertex-cut over its (16, 16) and
   (2, 16, 16) TPU meshes) for 256 and 512 shards at ogb_products' n and e,
   built on ``meta`` with the card's allocated memory unchanged around
   each; then runs that step for real on ``uniform_graph(2449029,
   61859140, seed=0)`` (e′ edges once deduplicated): WSP from vertex 0
   through the single-device cuda engine (its layouts built first, timed
   as set-up; the sweep kernels' launches counted) and the pull engine, the graph's layouts dropped, then the
   step over 256 and 512 shards (``make_production_mesh()``) on the one
   card on the ``partition_edges`` blocks, each bitwise the cuda engine's
   whole state and the pull engine's answer with equal iterations; the
   256-shard step once more under torch.profiler (device busy time, idle
   share).  Each line gives n, e′, iterations, the wall, the peak device
   memory, each shard's edge work (min / max) and the phase's seconds.
12. serves the LM family through ``launch/serve.py``'s ``generate``
   (greedy prefill, then batched decode into a power-of-two cache) with
   random weights from a seeded generator on the card:
   (a) llama3.2-3B at full width (``configs/llama3_2_3b.py``: 28 layers,
   d 3072, vocab 128,256, bfloat16, 3.61 B parameters) at the reference
   serve driver's defaults (batch 2, prompt 16, 8 tokens) and at batch 8,
   prompt 512, 32 tokens (a cache of 1,024), each cold and warm with equal
   ids: the prefill logits held against ``forward`` at the prompt's last
   position and the last decode step against ``forward`` over the prompt
   and the ids fed back, elementwise within 3e-2 + 3e-2·|forward| (the
   reference's serve tests' bound), recorded in bfloat16 and required in
   float32 (the same weights cast, 14.4 GB); (b) deepseek-v3 at full width
   cut to depth 4 (its 3 dense layers, its first MoE layer of 256 experts,
   top-8 and one shared, and the MTP head; 31.6 GB) at the defaults: the
   same checks, the MoE layer's prefill routing (no expert keeps more than
   its capacity, every token's gates sum to 1 within 1e-6), MLA's absorbed
   decode against the expanded one from one prefilled cache within the
   same bound, and the loss with its MTP term finite; (c)
   ``flash_attention`` (``flash_sm90_kernel``) on (a)'s layer-0 prefill
   q, k, v at batch 8 (S 512 over T 1,024 cache slots, causal from
   position 0 for both) against the LM's own chunked attention, at the
   bfloat16 flash tolerance, both timed with CUDA events (the model path
   launches no kernel of the port: the reference's LM calls none).  Each
   line gives prefill ms, decode ms per step, tokens per second (the
   reference driver's: batch × tokens over the wall), the peak device
   memory and the card.
13. runs the GNNs (``models/gnn.py``, ``data/graphs.py``) at their
   ``full()`` configs in float32 with seeded random weights on the card:
   (a) GAT (2 layers, 8 heads of 8) on ``cora_like()`` (n 2,708, d_in
   1,433) and at ogb_products' n with phase 11's edges and
   ``cora_batch``'s features (d_in 100); (b) MeshGraphNet (15 layers, d
   128) on a 256 × 256 grid (``mesh_batch``), single-device and over 4
   vertex-cut shards (``mgn_forward_dist``, outputs and loss against the
   single device), then ``mgn_loss_dist`` over 32 shards of phase 11's
   edges (pad 1.3, every edge landed); (c) EGNN (4 layers, d 64) and (d)
   DimeNet (6 blocks, d 128) on 128 molecules × 30 atoms, EGNN's rotation
   check (float64 at atol 1e-4, float32 at ``GNN_TOL``) and 4-shard
   forward, DimeNet's rotation invariance (atol 1e-3).  Every forward runs
   twice, bitwise equal, finite; the cora, grid and molecule forwards are
   held against the same model cast to float64 within ``GNN_TOL``·(|x| +
   max|x|).  (f) ``ops.ell_softmax`` on (a)'s ogb-sized layer-0 logits,
   per head, laid into the in-layout, against the model's α within 1e-5 +
   1e-5·|α| (the ``model_check`` of the ``softmax_kernel`` row; no GNN
   launches a kernel, as the reference's call none).  Each line gives the
   cold and warm forward ms, the loss, the peak device memory and the
   card.
14. runs DLRM RM2 (``models/dlrm.py``) at ``full()`` (26 tables of
   4,000,000 × 64, 26.62 GB of float32 drawn on the card one table at a
   time) with seeded random weights and ``dlrm_batch`` inputs: (a)
   ``serve_p99`` (B 512) and (b) ``serve_bulk`` (B 262,144), forward and
   loss, each held against float64 MLPs over the same float32 tables
   (the gather is exact) within ``GNN_TOL``·(|x| + max|x|); (c)
   ``retrieval_cand``, one query against 1,000,000 candidates, the scores
   against ``user_vector @ cand.T`` (atol 1e-5) and their top 10; (d) K =
   8 multi-hot at B 65,536, then ``embedding_bag`` on each of the 26
   tables (a contiguous view) with the field's ids against the model's
   lookup within 8·2^-24·Σ|rows|, and at K = 1 on (b)'s ids bitwise the
   single-hot gather (the ``model_check`` of the ``bag_kernel`` row; the
   model launches no kernel, as the reference's calls none); (e)
   bfloat16 tables at ``serve_bulk`` (the float32 tables freed first)
   against the float32 forward over the same tables rounded (lookup
   bitwise, logits within the float64 check's limit).  Every forward runs
   twice, bitwise equal, finite.  Each line gives the cold and warm
   forward ms, its device ms and its four stages' (CUDA events; beside
   (b) a profile of the same forward), the loss, the achieved TFLOP/s
   (the reference workloads' dense FLOPs: 1,613,440 an example), the peak
   device memory and the card.
15. trains (``launch/workloads.py``'s train steps under
   ``runtime/ft.py``'s ``FaultTolerantDriver.run_step``, ``optim/adamw.py``,
   the flash core's backward in ``models/layers.py``), after phase 14's
   memory is freed: (a) llama3.2-3B at full width (28 layers, bfloat16
   parameters, float32 AdamW state), ``train_4k`` at S 4,096 with the
   batch cut from 256 to 4 (``n_micro`` 2 by the reference's rule), three
   steps on ``TokenStream`` batches, step 1 run again from the same state
   (drawn again from its seed; the first result kept in pinned host
   memory) and required bitwise, then a fourth step's two halves
   (gradients, AdamW update) timed apart and a fifth gradient half
   profiled (device busy time, top kernels), the state finite after;
   (b) the flash
   core's gradient against naive attention's at full width, depth 2,
   batch 1 × 4,096, float64, within 1e-10·(|g| + max|g|); (c) GAT on
   ``cora_like()``, MeshGraphNet on the 256 × 256 grid (single device and
   over 4 vertex-cut shards, ``variant="dist"``), EGNN and DimeNet on 128
   molecules × 30 atoms, at ``full()``, and (d) DLRM RM2 at ``train_batch``
   (B 65,536, dense AdamW, rows cut from 4,000,000 to 1,000,000): the
   first step's gradients within ``GNN_TOL``·(|g| + max|g|) of float64
   parameters' (float64 MLPs over the same tables for RM2), the float64
   run taking the float32 run's ReLU signs (the plain float64 step's share
   and the count of units whose sign differs are recorded), the shards'
   loss and gradients within 1e-5·(|g| + max|g|) of one device's, then
   three steps each run on two copies of the state and required bitwise;
   (e) ``launch.train.main`` for llama3.2-3B at ``--smoke`` for 4 steps
   (checkpoint every 2), ``--resume`` to 6, against an uninterrupted 6-step
   run (the step-6 checkpoints byte-equal), and for gat-cora and dlrm-rm2.
   Every FT driver reads 0 retries and 0 restores, and no kernel of the
   port launches (the reference's training path reaches no Pallas
   kernel).  Each step line gives the wall, device ms (CUDA events),
   TFLOP/s on the wall (6·N·tokens for the LM, the reference workloads'
   model FLOPs for the others), loss, gradient norm, learning rate, the
   peak device memory and the card.
16. serves through ``launch/workloads.py``'s ``build_workload(...).step_fn``
   at full width (the serving kinds; no kernel of the port launches, as
   the reference's serving path reaches none): (a) llama3.2-3B
   ``prefill_32k`` at S 32,768, batch 2, depth 4 (cut from 32 and 28),
   the step bitwise the direct ``TransformerLM.prefill`` and its own
   repeat (logits and the written cache); (b) ``decode_32k`` at batch 8,
   its cache filled by (a)'s step two rows at a time over 32,736 tokens,
   32 decode steps, each the direct ``decode_step``, then the step twice
   from the same cache slot (``pos`` a 0-dim tensor), all bitwise; beside
   it phase 12's per-layer decode check at S 32,768 on one row, float64,
   first and last layer; (c) its ``kvq`` variant at batch 16 from (b)'s
   rows quantized; (d) deepseek-v3 ``decode_32k`` at full width, depth 4,
   at the largest power-of-two batch ≤ 128 whose peak reckoned on
   ``meta`` (``launch.dryrun.reckon``) is ≤ 70 GB, its MLA cache seeded
   random; (e) RM2 ``serve_p99``, ``serve_bulk`` and ``retrieval_cand``
   uncut on phase 14's model and tables (run inside phase 14), bitwise
   phase 14's direct forward and scores; (f) ``python -m
   repro_torch.launch.dryrun`` for each production mesh, two child
   processes on the CPU started after the build and waited for here
   (``--both-meshes`` in two halves): 80 records, 72
   ``ok`` and 8 ``skipped``, one line per cell with
   ``benchmarks/roofline.derive``'s dominant term, useful-FLOP share and
   the cell's seconds.  Each serving line gives the step's wall (host
   clock to a synchronize), tokens per second, the peak device memory,
   the cuts and the card.

Any failure raises and exits non-zero.  The line before the last holds the
card's name and power limit; the ``kernels`` line before it the per-kernel
numbers; the last line is the JSON result.  Details also go to
``chiprun_out/chip_smoke.json`` when that directory can be written.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
# Published dense peaks of one H100 SXM (NVIDIA data sheet): bfloat16 and
# TF32 on the tensor cores, float32 outside them.
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
KERNEL_SOURCE = "src/repro_torch/csrc/edge_sweep.cuh"
MAIN_KERNELS = ("pull", "push", "resolve")
SLEEP_CYCLES = 4_000_000           # ~2 ms at the H100's 1.98 GHz boost clock
BATCH = 8                          # the reference service's max_batch
POISON = 0x7fc0dead                # a NaN payload (as float32)
REPLACES = {"pull": "src/repro/kernels/edge_reduce.py:165",
            "push": "src/repro/kernels/edge_reduce.py:367",
            "resolve": "src/repro/kernels/edge_reduce.py:553",
            "level": "src/repro/kernels/edge_reduce.py:648",
            "softmax": "src/repro/kernels/segment_softmax.py:30",
            "bag": "src/repro/kernels/embedding_bag.py:33",
            "flash_sm90": "src/repro/kernels/flash_attention.py:34",
            "flash_f32": "src/repro/kernels/flash_attention.py:34"}
SOURCES = {"level": "src/repro_torch/csrc/edge_level.cuh",
           "softmax": "src/repro_torch/csrc/segment_softmax.cu",
           "bag": "src/repro_torch/csrc/embedding_bag.cu",
           "flash_sm90": "src/repro_torch/csrc/flash_attention_sm90.cu",
           "flash_f32": "src/repro_torch/csrc/flash_attention_3xtf32.cu"}
# The kernel behind each launch count, where the two names differ.
KERNEL_NAMES = {"flash_f32": "flash_3xtf32_kernel"}
# DLRM RM2's embedding tables (configs/dlrm_rm2.py) and llama3.2-3B's
# attention (configs/llama3_2_3b.py).
RM2_VOCAB, RM2_DIM, RM2_BAGS = 4_000_000, 64, 65_536
LLAMA_HEADS, LLAMA_KV_HEADS, LLAMA_DHEAD = 24, 8, 128
# Flash attention against its plain version, elementwise |Δ| <= atol +
# rtol·|plain|.  Both compute in float32 and round the result once to the
# output type, so in bfloat16 two results differ by at most one bfloat16
# step of the element (2^-7 of it) plus the float32 difference of two
# summation orders (atol); in float32 by that difference alone.
FLASH_TOL = {"bfloat16": (2.0 ** -7, 1e-4), "float32": (1e-5, 1e-5)}

# RM-XS targets from BENCH_pallas.json (direction_rows / resolution_rows of
# rmat_graph(400, 3200, seed=11)): unweighted BFS iterations / push
# iterations / edge work auto / edge work pull-only / resolve work, and
# weighted SSSP iterations / edge work auto.
RMXS_BFS = (6, 3, 7854, 9715, 6025)
RMXS_WSSSP = (8, 13703)
# The incremental bench's perturbation (benchmarks/fusion_bench.py): seeded
# random inserts, a fraction of |E|, weights 0.1 + U[0, 1).
INCR_SEED, INCR_FRAC = 7, 0.005
# Phase 11's uniform graph at ogb_products' n and e (configs' GNN shape).
OGB_SEED = 0
# Phase 12: the LM's serving path against its own forward, elementwise
# |Δ| <= atol + rtol·|forward| (the reference's own serve tests' bound);
# deepseek-v3 cut to its 3 dense layers and first MoE layer, to fit one
# card beside the MTP head (31.6 GB of bfloat16 weights).
LM_TOL = (3e-2, 3e-2)
P12_DEEPSEEK_LAYERS = 4
# Decode against forward is required at llama's full width and depth in
# float64: the random network of the reference's init amplifies a
# rounding some 3e7-fold over 28 layers (phase 12's sensitivity line),
# past LM_TOL in bfloat16 and float32 alike (recorded), and far inside it
# in float64.
# MLA's absorbed against expanded attention context (before the output
# projection), one layer on the same bfloat16 inputs: both compute in
# float32 and round once to bfloat16, so they differ by one bfloat16 step
# of the element (2^-7 of it) plus the float32 difference of two
# association orders.  Their logits hold no such bound in bfloat16 (the
# MoE router's top-k is discontinuous, and three more layers amplify
# the step): they are held to LM_TOL with the same weights in float32,
# where the two decodes differ by association order alone.
MLA_TOL = (2.0 ** -7, 1e-3)
# Flash on the LM's layer-0 q, k, v: elementwise |Δ| <= atol + rtol·a,
# the bfloat16 flash tolerance with a = Σ_t p_t·|v_t| (the attention of
# |v|, float64) in place of |out|.  A weighted sum Σ_t p_t·v_t whose
# weights each carry a relative error δ is off by at most δ·a; the
# reference's init gives near one-hot weights over values of both signs,
# where |out| falls far below a and an |out|-relative limit measures the
# cancellation, not the kernel (recorded beside it).
FLASH_LM_TOL = FLASH_TOL["bfloat16"]
# Phase 13: a GNN output against another computation of it (float64, a
# rotation, shards), elementwise |Δ| <= GNN_TOL·(|x| + max|x|): relative to
# the element and to the output's own scale (the random 15-layer MGN's
# outputs reach ~1e3 on the grid).  The ogb_products-sized MGN runs on 32
# vertex-cut shards of the one card (its single-device [e, 384] concat
# alone would be 95 GB).
GNN_TOL = 1e-4
P13_SHARDS = 32


def dlrm_dense_flops(cfg) -> int:
    """The dense FLOPs of one DLRM example, the reference's own count
    (``src/repro/launch/workloads.py`` ``_dlrm_dense_flops``): the two
    MLPs' products and the interaction's z zᵀ; 1,613,440 at RM2's full
    size."""
    bot = sum(2 * a * b for a, b in zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:]))
    dims = [cfg.d_interact] + list(cfg.top_mlp_hidden)
    top = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    inter = 2 * cfg.n_feats * cfg.n_feats * cfg.embed_dim
    return bot + top + inter


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 15: training (launch/workloads.py, optim/adamw.py, runtime/ft.py,
# launch/train.py, the flash core's backward in models/layers.py).
# ---------------------------------------------------------------------------

# (a) llama3.2-3B's train_4k at its full sequence, the batch cut from 256
# to 4 (n_micro 2 by the reference's rule); (b) the flash core's gradient
# against naive attention's in float64 at depth 2, batch 1 × 4,096,
# elementwise within FLASH_GRAD_TOL·(|g| + max|g|); (c) the GNNs' and
# (d) DLRM RM2's steps, their first gradients within GNN_TOL·(|g| +
# max|g|) of float64 parameters, 4 vertex-cut shards against one device
# within SHARD_GRAD_TOL·(|g| + max|g|); RM2's tables cut from 4,000,000 to
# 1,000,000 rows (the DLRMConfig default: tables, gradient, m and v 26.6
# GB, against ≈ 106 GB uncut).
P15_LM_BATCH = 4
P15_STEPS = 3
FLASH_GRAD_TOL = 1e-10
SHARD_GRAD_TOL = 1e-5
P15_RM2_ROWS = 1_000_000


def phase15(torch, dev, card, record, log, bits, reset_peak):
    """Phase 15 of the smoke (module docstring, item 15); returns its
    rows, every one also logged as a ``phase 15`` line."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch.nn.functional as F

    import repro_torch.configs as GC
    from repro_torch.data import graphs as GD
    from repro_torch.data.tokens import TokenStream
    from repro_torch.graph import structure as TS
    from repro_torch.graph.partition import ShardMesh
    from repro_torch.kernels import edge_reduce as ER
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import segment_softmax as SS
    from repro_torch.launch import train as TTrain
    from repro_torch.launch import workloads as TWk
    from repro_torch.models import dlrm as DL
    from repro_torch.models import gnn as GN
    from repro_torch.models import transformer as TT
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.tree import leaves, tree_map
    from repro_torch.runtime.ft import FTConfig, FaultTolerantDriver

    rows = []
    t15 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="grafs_train_"))

    def log15(tag, row):
        log(f"phase 15 {tag} " + json.dumps(row))
        rows.append(dict(row, line=tag))

    def counts():
        return {"edge": dict(ER.LAUNCHES), "bag": dict(EB.LAUNCHES),
                "softmax": dict(SS.LAUNCHES), "flash": dict(FA.LAUNCHES)}

    launches_before = counts()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def free(stage=None):
        """Collect, then log the device bytes still allocated (each
        part's tensors are dropped before the next)."""
        gc.collect()
        torch.cuda.empty_cache()
        if stage is not None:
            log15("allocated", {"after": stage, "allocated_gb":
                                torch.cuda.memory_allocated() / 1e9})

    free("phase 14")

    def grad_share(got, want, tol):
        """The worst |Δ| over tol·(|want| + max|want|) over the leaves of
        two gradient trees (a leaf of zeros in both counts 0), and the
        max |Δ|; in float64, 2^24 elements at a time."""
        worst = err = 0.0
        for a, b in zip(leaves(got), leaves(want)):
            if a.shape != b.shape:
                raise RuntimeError(f"phase 15: gradient leaves {a.shape} "
                                   f"and {b.shape}")
            if not b.numel():
                continue
            top = float(b.abs().max())
            for ca, cb in zip(a.reshape(-1).split(1 << 24),
                              b.reshape(-1).split(1 << 24)):
                d = (ca.double() - cb.double()).abs()
                lim = tol * (cb.double().abs() + top)
                worst = max(worst, float((d / lim).nan_to_num(
                    posinf=float("inf")).max()))
                err = max(err, float(d.max()))
        return worst, err

    class Pattern:
        """The signs at every ReLU and leaky ReLU of the GNN and DLRM
        forwards (``models.gnn._mlp``'s activations, GAT's edge logits):
        recorded in call order by a float32 run, replayed by a float64
        run, which so differentiates the same piecewise-linear function.
        Unreplayed, a float64 run takes the other side of a kink wherever
        the float32 rounding crossed 0 and its gradient moves by a whole
        example's share there; ``flips`` counts those units."""

        def __init__(self):
            self.masks, self.flips, self.units, self.pos = [], 0, 0, None

        def _act(self, x, slope):
            if self.pos is None:
                self.masks.append(x.detach() > 0)
                return F.relu(x) if slope == 0.0 else \
                    F.leaky_relu(x, slope)
            m = self.masks[self.pos]
            self.pos += 1
            self.flips += int(((x.detach() > 0) != m).sum())
            self.units += m.numel()
            return torch.where(m, x, slope * x)

        @contextlib.contextmanager
        def on(self, replay=False):
            self.pos = 0 if replay else None
            orig = GN._mlp, DL._mlp, GN.F
            pat = self

            def mlp(params, x, act=None, final_act=False):
                for i, lyr in enumerate(params):
                    x = x @ lyr["w"] + lyr["b"]
                    if i < len(params) - 1 or final_act:
                        x = pat._act(x, 0.0)
                return x

            class Fns:
                def __getattr__(self, name):
                    return getattr(F, name)

                @staticmethod
                def leaky_relu(x, slope=0.01):
                    return pat._act(x, slope)

            GN._mlp = DL._mlp = mlp
            GN.F = Fns()
            try:
                yield self
            finally:
                GN._mlp, DL._mlp, GN.F = orig
            if replay and self.pos != len(self.masks):
                raise RuntimeError("phase 15: the float64 run took "
                                   f"{self.pos} activations of "
                                   f"{len(self.masks)}")

    def f64_grads(label, wl, params, params64, batch, batch64):
        """The float32 gradients, and their share of GNN_TOL·(|g| + max|g|)
        off the float64 gradients of the same step with the float32
        run's ReLU signs (required), beside the share off the plain
        float64 step (recorded).  The recording run must give the bits of
        the model's own, unpatched gradients (required), so the gradients
        held against float64 are the model's."""
        loss, g = wl.grad_fn(params, batch)
        pat = Pattern()
        with pat.on():
            loss_rec, g_rec = wl.grad_fn(params, batch)
        own = same_bits((loss, g), (loss_rec, g_rec))
        del loss_rec, g_rec
        if not own:
            raise RuntimeError(f"phase 15 {label}: the recording run's "
                               "gradients are not the model's own")
        with pat.on(replay=True):
            loss64, g64 = wl.grad_fn(params64, batch64)
        share, err = grad_share(g, g64, GNN_TOL)
        del g64
        plain64, gp = wl.grad_fn(params64, batch64)
        plain, _ = grad_share(g, gp, GNN_TOL)
        del gp
        row = {"case": label, "loss": float(loss), "loss_f64": float(loss64),
               "loss_f64_plain": float(plain64),
               "f64_worst_over_limit": share, "f64_max_abs_err": err,
               "relu_units": pat.units, "relu_flips": pat.flips,
               "recording_is_model_bitwise": own,
               "f64_plain_worst_over_limit": plain, "card": card}
        if share > 1.0:
            raise RuntimeError(f"phase 15 {label}: gradients {share} times "
                               f"the limit off float64's")
        return loss, g, row

    def same_bits(x, y):
        return all(torch.equal(bits(a), bits(b))
                   for a, b in zip(leaves(x), leaves(y)))

    def driver(wl, tag, data_state=dict, data_restore=lambda st: None):
        return FaultTolerantDriver(
            FTConfig(ckpt_dir=str(root / tag)),
            lambda st, b: _split15(wl.step_fn(st[0], st[1], b)),
            data_state, data_restore, state_devices=dev)

    def ft_ok(ft, label):
        s = ft.stats
        if s.retries or s.restores:
            raise RuntimeError(f"phase 15 {label}: {s.retries} retries, "
                               f"{s.restores} restores")
        return {"retries": s.retries, "restores": s.restores,
                "stragglers": s.stragglers}

    def step_row(ft, state, batch, flops):
        """One guarded step: wall (host clock to a synchronize), device ms
        (CUDA events), TFLOP/s on the wall, the metrics and the peak."""
        reset_peak()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        state, m = ft.run_step(state, batch)
        b.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {"wall_s": wall, "device_ms": a.elapsed_time(b),
               "tflops": flops / wall / 1e12, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "allocated_gb": torch.cuda.memory_allocated() / 1e9,
               "card": card}
        if not all(math.isfinite(row[k]) for k in ("loss", "grad_norm")):
            raise RuntimeError(f"phase 15: a non-finite step {row}")
        return state, m, row

    # -- (a) llama3.2-3B at full width, train_4k, batch 4 ----------------
    wl = TWk.build_workload("llama3.2-3b", "train_4k", None,
                            shape_changes={"batch": P15_LM_BATCH})
    cfg = wl.cfg
    n_params = cfg.param_count()
    seq, batch = wl.meta["seq"], wl.meta["batch"]
    tokens = seq * batch
    flops = 6 * n_params * tokens
    log15("llama cuts", {"arch": "llama3.2-3b", "shape": "train_4k",
                         "cuts": wl.meta["cuts"], "seq": seq,
                         "n_micro": wl.meta["n_micro"], "layers":
                         cfg.n_layers, "d_model": cfg.d_model,
                         "vocab": cfg.vocab, "params": n_params,
                         "opt_state_dtype": wl.opt_cfg.state_dtype,
                         "remat": cfg.remat, "flops_per_step": flops})
    if wl.meta["n_micro"] != 2:
        raise RuntimeError(f"phase 15: n_micro {wl.meta['n_micro']}, not 2")
    stream = TokenStream(vocab=cfg.vocab, batch=batch, seq=seq, seed=17)

    def lm_state():
        params = TT.init_params(cfg, gen(151), device=dev).tree()
        return params, adamw_init(wl.opt_cfg, params)

    def data_restore(st):
        stream.seed, stream.step = int(st["seed"]), int(st["step"])

    ft = driver(wl, "llama", stream.state, data_restore)
    state = lm_state()
    state_gb = sum(t.numel() * t.element_size() for t in leaves(state)) / 1e9
    b1 = stream.next_batch()
    state, m1, row = step_row(ft, state, b1, flops)
    log15("llama step 1", dict(row, step=1, state_gb=state_gb))
    # step 1 again from the same state (the step updates in place: the
    # state is drawn again from its seed, the first run's result kept on
    # the host meanwhile)
    def host_copy(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)

    t0 = time.perf_counter()
    first = [host_copy(t) for t in leaves(state)]
    copy_s = time.perf_counter() - t0
    del state
    free()
    stream.step = 0
    state = lm_state()
    b1_again = stream.next_batch()
    if not all(torch.equal(b1[k], b1_again[k]) for k in b1):
        raise RuntimeError("phase 15: the token stream did not replay")
    state, m1b, row = step_row(ft, state, b1_again, flops)
    t0 = time.perf_counter()
    same = float(m1b["loss"]) == float(m1["loss"]) \
        and float(m1b["grad_norm"]) == float(m1["grad_norm"])
    same = same and all(torch.equal(bits(a), bits(b.to(dev)))
                        for a, b in zip(leaves(state), first))
    row.update(step=1, repeat=True, bitwise_repeat=same,
               host_copy_s=copy_s, compare_s=time.perf_counter() - t0)
    log15("llama step 1 repeat", row)
    del first
    if not same:
        raise RuntimeError("phase 15: llama3.2-3B's step 1 is not bitwise "
                           "on its repeat")
    for step in range(2, P15_STEPS + 1):
        state, m, row = step_row(ft, state, stream.next_batch(), flops)
        log15(f"llama step {step}", dict(row, step=step))
    # where a step's time goes: its two halves (gradients, then the AdamW
    # update) timed apart with CUDA events, then the gradient half once
    # more under the profiler
    params, opt = state
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    with TWk.deterministic():
        ev[0].record()
        _, grads = wl.grad_fn(params, stream.next_batch())
        ev[1].record()
        params, opt, _ = adamw_update(wl.opt_cfg, params, grads, opt)
        ev[2].record()
    torch.cuda.synchronize()
    del grads
    # the update's least bytes: the norm reads the float32 gradient, the
    # update reads parameter, gradient, m and v and writes parameter, m, v
    p_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    upd_bytes = 2 * p_bytes + 2 * 4 * n_params + 4 * 4 * n_params
    row = {"grad_ms": ev[0].elapsed_time(ev[1]),
           "update_ms": ev[1].elapsed_time(ev[2]),
           "update_bound_ms": upd_bytes / HBM_BYTES_PER_S * 1e3,
           "update_bytes": upd_bytes}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with TWk.deterministic():
            _, grads = wl.grad_fn(params, stream.next_batch())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del grads
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    row.update(profiled_grad_wall_ms=wall * 1e3, device_busy_ms=busy,
               idle_share=1 - busy / (wall * 1e3),
               top=[{"name": e.key[:90], "ms": e.self_device_time_total
                     / 1e3, "calls": e.count} for e in top], card=card)
    log15("llama step split", row)
    state = (params, opt)
    del prof, kern, top, params, opt
    finite = all(bool(torch.isfinite(t).all()) for t in leaves(state)
                 if t.is_floating_point())
    log15("llama driver", dict(ft_ok(ft, "llama"), state_finite=finite))
    if not finite:
        raise RuntimeError("phase 15: llama3.2-3B's state is not finite")
    del state, ft
    free("llama3.2-3B training")

    # -- (b) the flash core's gradient against naive, float64, depth 2 -----
    cfg64 = dataclasses.replace(cfg, n_layers=2, dtype="float64",
                                param_dtype="float64")
    model64 = TT.init_params(cfg64, gen(152), device=dev)
    toks = TokenStream(vocab=cfg.vocab, batch=1, seq=seq, seed=18) \
        .next_batch()
    b64 = {k: v.to(dev, torch.long) for k, v in toks.items()}
    grads, losses, walls = {}, {}, {}
    for impl in ("chunked", "naive"):
        m = model64.with_config(attn_impl=impl).trainable()
        reset_peak()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with TWk.deterministic():
            loss = m.loss_fn(b64)
            grads[impl] = torch.autograd.grad(loss, leaves(
                m.tree(live=True)))
        torch.cuda.synchronize()
        walls[impl] = (time.perf_counter() - t0, torch.cuda
                       .max_memory_allocated() / 1e9)
        losses[impl] = float(loss.detach())
        m.trainable(False)
        del loss, m
    share, err = grad_share(grads["chunked"], grads["naive"], FLASH_GRAD_TOL)
    row = {"case": "llama3.2-3B full width, depth 2, float64, B 1 x "
                   f"{seq}", "kv_chunk": cfg.kv_chunk,
           "loss_flash": losses["chunked"], "loss_naive": losses["naive"],
           "worst_over_limit": share, "max_abs_err": err,
           "tolerance": f"{FLASH_GRAD_TOL}*(|g| + max|g|)",
           "flash_s": walls["chunked"][0], "flash_peak_gb":
           walls["chunked"][1], "naive_s": walls["naive"][0],
           "naive_peak_gb": walls["naive"][1], "card": card}
    log15("flash grad float64", row)
    if share > 1.0:
        raise RuntimeError(f"phase 15: the flash core's float64 gradient is "
                           f"{share} times the limit off naive attention's")
    del model64, grads
    free("the flash gradient check")

    # -- (c) the GNNs at full() ---------------------------------------------
    def f64(t):
        return t.double() if torch.is_tensor(t) and t.is_floating_point() \
            else t

    def f64_batch(b):
        if isinstance(b, list):
            return [f64_batch(x) for x in b]
        return {k: f64(v) for k, v in b.items()}

    def train_case(label, wl, params, batch, flops, mesh_wl=None,
                   mesh_batch=None):
        """The first step's gradients against float64 parameters (and a
        vertex-cut workload's against the single device's), then
        P15_STEPS steps, each run on two copies of the state and bitwise
        equal; returns the rows."""
        opt = adamw_init(wl.opt_cfg, params)
        loss, g, row = f64_grads(label, wl, params, tree_map(f64, params),
                                 batch, f64_batch(batch))
        if mesh_wl is not None:
            dloss, dg = mesh_wl.grad_fn(params, mesh_batch)
            dshare, derr = grad_share(dg, g, SHARD_GRAD_TOL)
            row.update(shards=len(mesh_batch), shard_loss=
                       float(dloss), shard_worst_over_limit=dshare,
                       shard_max_abs_err=derr)
            if dshare > 1.0 or abs(float(dloss) - float(loss)) > \
                    SHARD_GRAD_TOL * abs(float(loss)):
                raise RuntimeError(f"phase 15 {label}: the shards' loss "
                                   f"or gradients off the single device's "
                                   f"({dshare} of the limit)")
        log15(f"{label} gradients", row)
        del g
        ft = driver(wl, label.split()[0])
        state = (params, opt)
        for step in range(1, P15_STEPS + 1):
            twin = tree_map(torch.clone, state)
            dtwin = None if mesh_wl is None else tree_map(torch.clone, state)
            state, m, row = step_row(ft, state, batch, flops)
            twin, m2 = ft.step_fn(twin, batch)
            same = same_bits(state, twin) and \
                float(m["loss"]) == float(m2["loss"])
            row.update(step=step, bitwise_repeat=same)
            if dtwin is not None:
                # the same step over the shards (recorded: an element whose
                # gradient is near 0 may take another sign in Adam's step)
                dp, _, dm = mesh_wl.step_fn(dtwin[0], dtwin[1], mesh_batch)
                row.update(shard_loss=float(dm["loss"]),
                           shard_grad_norm=float(dm["grad_norm"]),
                           shard_params_max_abs_err=max(
                               float((a - b).abs().max()) for a, b in
                               zip(leaves(dp), leaves(state[0]))))
                del dp, dtwin
            log15(f"{label} step {step}", row)
            if not same:
                raise RuntimeError(f"phase 15 {label}: step {step} is not "
                                   f"bitwise on its repeat")
            del twin
        log15(f"{label} driver", ft_ok(ft, label))
        return state

    # GAT on cora_like (full_graph_sm)
    wl = TWk.build_workload("gat-cora", "full_graph_sm", None)
    g_, x_, y_ = TS.cora_like(device=dev)
    gb = {"x": x_, "src": g_.by_dst.src, "dst": g_.by_dst.dst, "y": y_}
    params = GN.gat_init(wl.cfg, gen(153), device=dev).tree()
    train_case("gat-cora cora_like", wl, params, gb, wl.meta["model_flops"])
    # MeshGraphNet on the 256 x 256 grid, single device and 4 shards
    wl = TWk.build_workload("meshgraphnet", "full_graph_sm", None)
    mcfg = wl.cfg
    mb = GD.mesh_batch(256, 256, d_node_in=mcfg.d_node_in,
                       d_edge_in=mcfg.d_edge_in, d_out=mcfg.d_out, seed=5,
                       device=dev)
    mn, me = mb["node_x"].shape[0], mb["src"].shape[0]
    mesh4 = ShardMesh.on(dev, 4)
    dwl = TWk.build_workload("meshgraphnet", "full_graph_sm", mesh4,
                             variant="dist")
    host = {k: v.cpu().numpy() for k, v in mb.items()}
    part = GD.dst_block_partition(host["src"], host["dst"], mn, 4, 1.3)
    if int(part["mask"].sum()) != me:
        raise RuntimeError("phase 15: the grid's partition dropped edges")
    shards = GD.shard_batch(host, part, ("node_x", "target"), ("edge_x",),
                            devices=mesh4.devices)
    params = GN.mgn_init(mcfg, gen(154), device=dev).tree()
    train_case("meshgraphnet grid 256x256", wl, params, mb,
               TWk._gnn_model_flops("mgn", mcfg, mn, me, None), dwl, shards)
    del mb, shards
    # EGNN and DimeNet on 128 molecules x 30 atoms
    wl = TWk.build_workload("egnn", "molecule", None)
    eb = GD.molecule_batch(n_graphs=128, n_atoms=30, seed=5, device=dev)
    eb.pop("n_graphs")
    params = GN.egnn_init(wl.cfg, gen(155), device=dev).tree()
    train_case("egnn molecule 128x30", wl, params, eb, TWk._gnn_model_flops(
        "egnn", wl.cfg, eb["feats"].shape[0], eb["src"].shape[0], None))
    wl = TWk.build_workload("dimenet", "molecule", None)
    db = GD.molecule_batch(n_graphs=128, n_atoms=30, seed=5,
                           n_species=wl.cfg.n_species, device=dev)
    db.pop("n_graphs")
    params = GN.dimenet_init(wl.cfg, gen(156), device=dev).tree()
    train_case("dimenet molecule 128x30", wl, params, db,
               TWk._gnn_model_flops("dimenet", wl.cfg, db["species"]
                                    .shape[0], db["src"].shape[0], db))
    del params
    free("the GNNs")

    # -- (d) DLRM RM2, train_batch, dense AdamW ------------------------------
    wl = TWk.build_workload("dlrm-rm2", "train_batch", None,
                            cfg_changes={"vocab": P15_RM2_ROWS})
    rcfg = wl.cfg
    log15("dlrm cuts", {"cuts": wl.meta["cuts"], "full_rows":
                        GC.get("dlrm-rm2").full().vocab, "batch":
                        wl.meta["batch"], "params": rcfg.param_count(),
                        "model_flops": wl.meta["model_flops"]})
    model = DL.dlrm_init(rcfg, gen(157), device=dev)
    params = model.tree()
    del model
    rb = GD.dlrm_batch(rcfg, wl.meta["batch"], seed=5, device=dev)
    opt = adamw_init(wl.opt_cfg, params)
    # float64 MLPs over the same float32 tables (the gather is exact)
    p64 = {"tables": params["tables"],
           **{k: tree_map(f64, params[k]) for k in ("bot", "top")}}
    _, g, row = f64_grads("dlrm-rm2 train_batch", wl, params, p64, rb, rb)
    row["state_gb"] = sum(t.numel() * t.element_size()
                          for t in leaves((params, opt))) / 1e9
    log15("dlrm-rm2 gradients", row)
    del g, p64
    free()
    ft = driver(wl, "dlrm")
    state = (params, opt)
    for step in range(1, P15_STEPS + 1):
        twin = tree_map(torch.clone, state)
        state, m, row = step_row(ft, state, rb, wl.meta["model_flops"])
        twin, m2 = ft.step_fn(twin, rb)
        same = same_bits(state, twin) and float(m["loss"]) == \
            float(m2["loss"])
        row.update(step=step, bitwise_repeat=same)
        log15(f"dlrm-rm2 step {step}", row)
        if not same:
            raise RuntimeError(f"phase 15 dlrm-rm2: step {step} is not "
                               f"bitwise on its repeat")
        del twin
        free()
    log15("dlrm-rm2 driver", ft_ok(ft, "dlrm-rm2"))
    del state, ft, params, opt, rb
    free("DLRM RM2 training")

    # -- (e) the entry point ---------------------------------------------
    def main_run(args):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = TTrain.main(args)
        text = out.getvalue()
        line = [ln for ln in text.splitlines() if ln.startswith("[train]")]
        if rc != 0 or len(line) != 1 or "retries=0" not in line[0]:
            raise RuntimeError(f"phase 15: launch.train.main {args}: rc "
                               f"{rc}, {text[-2000:]}")
        return text, time.perf_counter() - t0

    def run_dir(name):
        return str(root / name)

    smoke = ["--arch", "llama3.2-3b", "--shape", "train_4k", "--smoke",
             "--ckpt-every", "2"]
    t_a, s_a = main_run(smoke + ["--steps", "4", "--ckpt-dir",
                                 run_dir("resume")])
    t_r, s_r = main_run(smoke + ["--steps", "6", "--resume", "--ckpt-dir",
                                 run_dir("resume")])
    t_u, s_u = main_run(smoke + ["--steps", "6", "--ckpt-dir",
                                 run_dir("straight")])
    if "resumed from step 4" not in t_r:
        raise RuntimeError(f"phase 15: --resume did not resume: {t_r}")
    da = Path(run_dir("resume")) / "step_0000000006"
    dbb = Path(run_dir("straight")) / "step_0000000006"
    names = sorted(p.name for p in da.iterdir())
    same = names == sorted(p.name for p in dbb.iterdir()) and all(
        (da / n).read_bytes() == (dbb / n).read_bytes() for n in names)
    row = {"lines": [ln for t in (t_a, t_r, t_u) for ln in t.splitlines()],
           "walls_s": [s_a, s_r, s_u], "checkpoint_files": len(names),
           "resumed_bitwise_uninterrupted": same, "card": card}
    log15("main llama3.2-3b resume", row)
    if not same:
        raise RuntimeError("phase 15: the resumed run's checkpoint differs "
                           "from the uninterrupted run's")
    for arch, shape in (("gat-cora", "full_graph_sm"),
                        ("dlrm-rm2", "train_batch")):
        text, s = main_run(["--arch", arch, "--shape", shape, "--smoke",
                            "--steps", "2", "--ckpt-dir", run_dir(arch)])
        log15(f"main {arch}", {"lines": text.splitlines(), "wall_s": s,
                               "card": card})
    shutil.rmtree(root, ignore_errors=True)
    if counts() != launches_before:
        raise RuntimeError("phase 15: the training path launched a kernel "
                           "of the port")
    log(f"phase 15: {time.perf_counter() - t15:.1f} s")
    record["phase15"] = rows
    record["phase15_s"] = time.perf_counter() - t15
    return rows


def _split15(out):
    params, opt_state, metrics = out
    return (params, opt_state), metrics


# ---------------------------------------------------------------------------
# Phase 16: the serving kinds of launch/workloads.py at full width, and the
# model cells' dry-run (launch/dryrun.py).
# ---------------------------------------------------------------------------

# (a)–(c) llama3.2-3B at full width, cut from 28 layers to P16_LM_LAYERS:
# a 2-row prefill at S 32,768 spends ≈ 1.4 s a layer in its float32
# attention tiles, and (a) and (b) run seven of them.  (a) prefill_32k at
# batch 2 (cut from 32), three times: the direct call, the workload's
# step, its repeat.  (b) decode_32k at batch 8 (cut from 128): its cache
# filled by (a)'s prefill step two rows at a time over P16_PROMPT tokens,
# then P16_STEPS decode steps; the per-layer decode check of phase 12 at
# S 32,768 on one row for the first and the last layer, in float64.  (c)
# its kvq variant at batch 16, the int8 cache (b)'s prefilled rows
# quantized by the model's own rule, twice over, then P16_KVQ_STEPS
# steps.  (d) deepseek-v3 decode_32k at full width, depth 4 (phase 12's
# cut), at the largest power-of-two batch ≤ 128 whose reckoned peak
# (weights, cache and the Reckoner's peak of the step on meta) is at most
# P16_PEAK_GB, its MLA cache seeded random (a prefill of 128 rows × 32k
# would take minutes), P16_DEEPSEEK_STEPS steps.  Every decode step runs
# the direct ``decode_step`` and the workload's step twice, on one cache
# whose written slot is put back between them: logits and the slot
# bitwise equal.
P16_LM_LAYERS = 4
P16_SEQ = 32_768
P16_STEPS = 32
P16_PROMPT = P16_SEQ - P16_STEPS
P16_KVQ_STEPS = 8
P16_DEEPSEEK_STEPS = 4
P16_PEAK_GB = 70.0
# (f): the dry-run children's wait, at most (they start after the build
# and run beside phases 1–16 on the host's CPU).
P16_DRYRUN_WAIT_S = 300
CHILDREN = []


def start_dryrun(out_dir: Path) -> dict:
    """``python -m repro_torch.launch.dryrun`` for the (16, 16) and the
    (2, 16, 16) mesh, one child process each (``--both-meshes`` in two
    halves; on ``meta``, CPU only: the card is hidden from them), their
    records and logs under ``out_dir``; phase 16 (f) waits for them."""
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(SRC), os.environ.get("PYTHONPATH"))
                   if p))
    procs, logs = [], []
    for extra in ([], ["--multi-pod"]):
        log_f = open(out_dir / f"dryrun{''.join(extra)}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
             str(out_dir)] + extra, cwd=ROOT, env=env, stdout=log_f,
            stderr=subprocess.STDOUT))
        logs.append(log_f)
    CHILDREN.extend(procs)
    return {"procs": procs, "out": out_dir, "logs": logs,
            "t0": time.perf_counter()}


def stop_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def _same_bits(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.contiguous().view(torch.uint8),
                    b.contiguous().view(torch.uint8)))


def phase16_rm2(torch, dlrm, served, retrieval, card, log16):
    """Phase 16 (e), inside phase 14: RM2's ``serve_p99``, ``serve_bulk``
    and ``retrieval_cand`` through ``build_workload(...).step_fn`` on
    phase 14's model and tables (no second copy), uncut: each output
    bitwise phase 14's direct forward (the scores also the user vector's
    product with the candidates), and bitwise on its repeat."""
    from repro_torch.launch import workloads as TWk
    tree = dlrm.tree()
    for shape, (b, want) in served.items():
        wl = TWk.build_workload("dlrm-rm2", shape)
        got, ms = _timed(torch, lambda: wl.step_fn(tree, b["dense"],
                                                   b["sparse"]))
        again, ms2 = _timed(torch, lambda: wl.step_fn(tree, b["dense"],
                                                      b["sparse"]))
        row = {"case": f"dlrm-rm2 {shape}", "kind": wl.kind,
               "batch": wl.meta["batch"], "cuts": wl.meta["cuts"],
               "step_ms": ms, "repeat_ms": ms2,
               "bitwise_direct": _same_bits(torch, got, want),
               "bitwise_repeat": _same_bits(torch, got, again),
               "shape": list(got.shape), "card": card}
        log16("(e) serve", row)
        if not (row["bitwise_direct"] and row["bitwise_repeat"]):
            raise RuntimeError(f"phase 16 (e) {shape}: {json.dumps(row)}")
    rb, cand, scores, user = retrieval
    wl = TWk.build_workload("dlrm-rm2", "retrieval_cand")
    args = (tree, rb["dense"], rb["sparse"], cand)
    got, ms = _timed(torch, lambda: wl.step_fn(*args))
    again, ms2 = _timed(torch, lambda: wl.step_fn(*args))
    row = {"case": "dlrm-rm2 retrieval_cand", "kind": wl.kind,
           "batch": wl.meta["batch"],
           "n_candidates": wl.meta["n_candidates"], "cuts": wl.meta["cuts"],
           "step_ms": ms, "repeat_ms": ms2,
           "bitwise_direct": _same_bits(torch, got, scores),
           "bitwise_user_dot": _same_bits(torch, got, user @ cand.T),
           "bitwise_repeat": _same_bits(torch, got, again),
           "shape": list(got.shape), "card": card}
    log16("(e) retrieval", row)
    if not (row["bitwise_direct"] and row["bitwise_user_dot"]
            and row["bitwise_repeat"]):
        raise RuntimeError(f"phase 16 (e) retrieval: {json.dumps(row)}")


def phase16(torch, dev, card, record, log, dry, rows):
    """Phase 16 (a)–(d) and (f) of the smoke (module docstring, item 16);
    ``rows`` holds (e)'s, logged inside phase 14."""
    import dataclasses as dc

    import repro_torch.configs as GC
    from repro_torch.kernels import edge_reduce as ER
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import segment_softmax as SS
    from repro_torch.launch import dryrun as TDr
    from repro_torch.launch import workloads as TWk
    from repro_torch.models import layers as LL
    from repro_torch.models import transformer as LT
    from repro_torch.tree import leaves, tree_map
    sys.path.insert(0, str(ROOT / "benchmarks"))
    import roofline

    t16 = time.perf_counter()

    def log16(tag, row):
        log(f"phase 16 {tag} " + json.dumps(row))
        rows.append(dict(row, line=tag))

    def counts():
        return {"edge": dict(ER.LAUNCHES), "bag": dict(EB.LAUNCHES),
                "softmax": dict(SS.LAUNCHES), "flash": dict(FA.LAUNCHES)}

    launches_before = counts()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9

    def gb(tensors):
        return sum(t.numel() * t.element_size() for t in tensors) / 1e9

    def lm_err(got, want, tol=LM_TOL):
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("phase 16: non-finite values")
        rtol, atol = tol
        diff = (got.double() - want.double()).abs()
        return float(diff.max()), float(
            (diff / (atol + rtol * want.double().abs())).max())

    def decode_run(label, wl, direct, tree, cache, tok, pos0, steps):
        """``steps`` decode steps from ``pos0``: the direct call, its
        written slot kept; the slot put back and the workload's step (pos
        a 0-dim tensor on the card), then again.  Both steps' logits and
        slot bitwise the direct call's; the next token the argmax."""
        ms_direct, ms_step, ok = [], [], True
        torch.cuda.reset_peak_memory_stats()
        for i in range(steps):
            pos = pos0 + i
            before = {k: v[:, :, pos].clone() for k, v in cache.items()}
            (want, _), ms = _timed(torch, lambda: direct.decode_step(
                tok, pos, cache))
            ms_direct.append(ms)
            wrote = {k: v[:, :, pos].clone() for k, v in cache.items()}
            for _ in range(2):
                for k, v in cache.items():
                    v[:, :, pos] = before[k]
                (got, _), ms = _timed(torch, lambda: wl.step_fn(
                    tree, tok, torch.tensor(pos, dtype=torch.int32,
                                            device=dev), cache))
                ms_step.append(ms)
                ok &= _same_bits(torch, got, want) and all(
                    _same_bits(torch, cache[k][:, :, pos], wrote[k])
                    for k in cache)
            if not bool(torch.isfinite(want).all()):
                raise RuntimeError(f"phase 16 {label}: non-finite logits")
            tok = torch.argmax(want, dim=-1).to(torch.int32)
        b = tok.shape[0]
        step_ms = statistics.median(ms_step)
        return {"case": label, "kind": wl.kind, "batch": b,
                "layers": wl.cfg.n_layers, "cache_len": P16_SEQ,
                "first_pos": pos0, "steps": steps, "cuts": wl.meta["cuts"],
                "cache_gb": gb(cache.values()),
                "decode_ms_per_step": step_ms,
                "direct_ms_per_step": statistics.median(ms_direct),
                "first_step_ms": ms_step[0],
                "tokens_per_s": b / step_ms * 1e3,
                "bitwise_direct_and_repeat": bool(ok),
                "peak_gb": peak_gb(), "card": card}

    def check(row):
        if not row.get("bitwise_direct_and_repeat", True) or not all(
                row.get(k, True) for k in ("bitwise_direct",
                                            "bitwise_repeat")):
            raise RuntimeError(f"phase 16 {row['case']}: "
                               f"{json.dumps(row)}")

    # (a) llama3.2-3B prefill_32k at batch 2, depth P16_LM_LAYERS
    cut_layers = {"n_layers": P16_LM_LAYERS}
    wl_a = TWk.build_workload("llama3.2-3b", "prefill_32k",
                              shape_changes={"batch": 2},
                              cfg_changes=cut_layers)
    cfg = wl_a.cfg
    torch.cuda.reset_peak_memory_stats()
    model = LT.init_params(cfg, gen(160), device=dev)
    tree = model.tree()
    weights_gb = gb(leaves(tree))
    toks = torch.randint(0, cfg.vocab, (2, P16_SEQ), generator=gen(161),
                         device=dev, dtype=torch.int32)
    runs = []
    for name, fn in (("direct", lambda c: model.prefill(toks, c)),
                     ("step", lambda c: wl_a.step_fn(tree, toks, c)),
                     ("repeat", lambda c: wl_a.step_fn(tree, toks, c))):
        cache = model.init_cache(2, P16_SEQ)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            (logits, cache), ms = _timed(torch, lambda: fn(cache))
        runs.append((logits, cache, ms, peak_gb()))
    (want, wcache, d_ms, _), (got, gcache, s_ms, s_peak), \
        (again, acache, r_ms, _) = runs
    row = {"case": "llama3.2-3B prefill_32k", "kind": wl_a.kind,
           "batch": 2, "seq": P16_SEQ, "layers": cfg.n_layers,
           "cuts": wl_a.meta["cuts"], "weights_gb": weights_gb,
           "cache_gb": gb(gcache.values()), "direct_ms": d_ms,
           "prefill_ms": s_ms, "repeat_ms": r_ms,
           "tokens_per_s": 2 * P16_SEQ / s_ms * 1e3,
           "model_tflops": wl_a.meta["model_flops"] / s_ms / 1e9,
           "bitwise_direct": _same_bits(torch, got, want) and all(
               _same_bits(torch, gcache[k], wcache[k]) for k in wcache),
           "bitwise_repeat": _same_bits(torch, got, again) and all(
               _same_bits(torch, gcache[k], acache[k]) for k in acache),
           "finite": bool(torch.isfinite(got).all()),
           "logits_max_abs": float(got.float().abs().max()),
           "peak_gb": s_peak, "card": card}
    log16("(a) prefill", row)
    check(row)
    if not row["finite"]:
        raise RuntimeError("phase 16 (a): non-finite logits")
    del runs, want, wcache, got, gcache, again, acache
    free()

    # the per-layer decode check at S 32,768 on one row, first and last
    # layer, float64 (each layer's input from the bfloat16 forward)
    one = torch.randint(0, cfg.vocab, (1, P16_SEQ), generator=gen(163),
                        device=dev)
    pos = torch.arange(P16_SEQ, device=dev)[None, :]
    cfg64 = dc.replace(cfg, dtype="float64", param_dtype="float64")
    last = cfg.n_layers - 1
    layer_rows = []
    t0 = time.perf_counter()
    with torch.no_grad():
        x = model.embed[one].to(LL._dt(cfg))
        for li, lp in enumerate(model.layers):
            use_moe, glob = LT._layer_pattern(cfg, li)
            chunk = None if glob else cfg.attn_chunk
            if li in (0, last):
                lp64 = LT.Params(tree_map(lambda t: t.double(),
                                          tree["layers"][li]))
                x64 = x.double()
                c = {k: torch.zeros((1, P16_SEQ, cfg.n_kv_heads,
                                     cfg.head_dim), dtype=torch.float64,
                                    device=dev) for k in ("k", "v")}
                LT._layer_apply(cfg64, lp64, x64[:, :-1], pos[:, :-1],
                                chunk, use_moe, c, 0)
                step, _, _ = LT._layer_apply(cfg64, lp64, x64[:, -1:],
                                             pos[:, -1:], chunk, use_moe, c,
                                             P16_SEQ - 1)
                full, _, _ = LT._layer_apply(cfg64, lp64, x64, pos, chunk,
                                             use_moe)
                err = lm_err(step[:, 0], full[:, -1])
                layer_rows.append({"layer": li, "max_abs_err": err[0],
                                   "worst_over_limit": err[1]})
                del lp64, x64, c, step, full
            if li == last:
                break
            x, _, _ = LT._layer_apply(cfg, lp, x, pos, chunk, use_moe)
    row = {"case": "llama3.2-3B layer decode at 32k, float64",
           "seq": P16_SEQ, "layers_checked": layer_rows,
           "tolerance": {"rtol": LM_TOL[0], "atol": LM_TOL[1]},
           "s": time.perf_counter() - t0, "peak_gb": peak_gb(),
           "card": card}
    log16("(b) layer decode", row)
    if not all(r["worst_over_limit"] <= 1.0 for r in layer_rows):
        raise RuntimeError(f"phase 16 (b) layer decode: {json.dumps(row)}")
    del x, one, pos
    free()

    # (b) decode_32k at batch 8: the cache filled by (a)'s prefill step,
    # two rows at a time
    wl_b = TWk.build_workload("llama3.2-3b", "decode_32k",
                              shape_changes={"batch": 8},
                              cfg_changes=cut_layers)
    if wl_b.cfg != cfg:
        raise RuntimeError("phase 16 (b): decode and prefill configs differ")
    cache_b = model.init_cache(8, P16_SEQ)
    prompts = torch.randint(0, cfg.vocab, (8, P16_PROMPT),
                            generator=gen(162), device=dev,
                            dtype=torch.int32)
    firsts = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for r in range(0, 8, 2):
        part = {k: v[:, r:r + 2] for k, v in cache_b.items()}
        lg, _ = wl_a.step_fn(tree, prompts[r:r + 2], part)
        firsts.append(lg)
    torch.cuda.synchronize()
    fill = {"fill_s": time.perf_counter() - t0, "fill_peak_gb": peak_gb(),
            "fill_prompt": P16_PROMPT, "fill_rows_per_call": 2}
    first_tok = torch.argmax(torch.cat(firsts), dim=-1).to(torch.int32)
    # (c)'s int8 cache from these rows, before (b)'s steps write theirs
    cache_c = {"k": [], "k_s": [], "v": [], "v_s": []}
    with torch.no_grad():
        for li in range(cfg.n_layers):
            for name in ("k", "v"):
                codes, scale = LL._quantize_int8(cache_b[name][li])
                cache_c[name].append(codes.repeat(2, 1, 1, 1))
                cache_c[name + "_s"].append(scale.float().repeat(2, 1, 1))
    cache_c = {k: torch.stack(v) for k, v in cache_c.items()}
    row = decode_run("llama3.2-3B decode_32k", wl_b, model, tree, cache_b,
                     first_tok, P16_PROMPT, P16_STEPS)
    row.update(fill)
    log16("(b) decode", row)
    check(row)
    del cache_b, firsts
    free()

    # (c) the kvq variant at batch 16
    wl_c = TWk.build_workload("llama3.2-3b", "decode_32k", variant="kvq",
                              shape_changes={"batch": 16},
                              cfg_changes=cut_layers)
    row = decode_run("llama3.2-3B decode_32k kvq", wl_c,
                     model.with_config(kv_quant=True), tree, cache_c,
                     first_tok.repeat(2), P16_PROMPT, P16_KVQ_STEPS)
    row["cache_fill"] = "(b)'s prefilled rows, _quantize_int8, twice"
    log16("(c) decode kvq", row)
    check(row)
    del cache_c, model, tree
    free()

    # (d) deepseek-v3 decode_32k, full width, depth 4
    deep_cut = {"n_layers": P12_DEEPSEEK_LAYERS}
    reckoned = []
    batch = 128
    while True:
        wl_d = TWk.build_workload(
            "deepseek-v3-671b", "decode_32k", cfg_changes=deep_cut,
            shape_changes={"batch": batch} if batch != 128 else None)
        rk, _, rk_s = TDr.reckon(wl_d)
        need = gb(t for t in leaves(wl_d.abstract_args)) + rk.peak_bytes / 1e9
        reckoned.append({"batch": batch, "reckoned_peak_gb": need,
                         "step_peak_gb": rk.peak_bytes / 1e9,
                         "reckon_s": rk_s})
        if need <= P16_PEAK_GB or batch == 1:
            break
        batch //= 2
    torch.cuda.reset_peak_memory_stats()
    deep, init_ms = _timed(torch, lambda: LT.init_params(
        wl_d.cfg, gen(164), device=dev))
    dtree = deep.tree()
    cache_d = {k: torch.randn(v.shape, generator=gen(165), dtype=v.dtype,
                              device=dev)
               for k, v in wl_d.abstract_args[3].items()}
    tok = torch.randint(0, wl_d.cfg.vocab, (batch,), generator=gen(166),
                        device=dev, dtype=torch.int32)
    row = decode_run("deepseek-v3 decode_32k", wl_d, deep, dtree, cache_d,
                     tok, P16_PROMPT, P16_DEEPSEEK_STEPS)
    row.update(weights_gb=gb(leaves(dtree)), init_ms=init_ms,
               cache_fill="seeded random", reckoned=reckoned,
               measured_peak_gb=peak_gb())
    row["cuts"] = dict(row["cuts"], cache="seeded random")
    log16("(d) decode", row)
    check(row)
    del deep, dtree, cache_d
    free()
    if counts() != launches_before:
        raise RuntimeError("phase 16: a serving step launched a kernel of "
                           "the port")
    serve_s = time.perf_counter() - t16

    # (f) the dry-run children started after the build
    t0 = time.perf_counter()
    rcs = []
    for proc in dry["procs"]:
        try:
            rcs.append(proc.wait(timeout=max(
                1.0, P16_DRYRUN_WAIT_S - (time.perf_counter() - t0))))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"phase 16 (f): the dry-run still runs after "
                               f"{P16_DRYRUN_WAIT_S} s more") from None
    for log_f in dry["logs"]:
        log_f.close()
    waited_s = time.perf_counter() - t0
    recs = [json.loads(p.read_text())
            for p in sorted(dry["out"].glob("*/*.json"))]
    status = dict(collections.Counter(r["status"] for r in recs))
    for r in recs:
        d = roofline.derive(r)
        line = {"mesh": r["mesh"], "arch": r["arch"], "shape": r["shape"],
                "status": r["status"]}
        if r["status"] == "ok":
            line.update(kind=r["kind"], dominant=d["dominant"],
                        useful_flops_frac=d["useful_flops_frac"],
                        temp_gb_per_device=r["memory_analysis"][
                            "temp_size_in_bytes"] / 1e9,
                        s=r["lower_s"] + r["compile_s"])
        log(f"phase 16 (f) cell " + json.dumps(line))
    row = {"case": "dryrun, both meshes", "rcs": rcs, "records": len(recs),
           "status": status,
           "since_start_s": time.perf_counter() - dry["t0"],
           "waited_s": waited_s,
           "reckon_s": sum(r.get("lower_s", 0) + r.get("compile_s", 0)
                           for r in recs), "card": card}
    log16("(f) dryrun", row)
    if rcs != [0, 0] or len(recs) != 80 or \
            status != {"ok": 72, "skipped": 8}:
        tail = "".join(p.read_text()[-1500:]
                       for p in sorted(dry["out"].glob("dryrun*.log")))
        raise RuntimeError(f"phase 16 (f): {json.dumps(row)}\n{tail}")
    phase16_s = time.perf_counter() - t16
    log(f"phase 16: {phase16_s:.1f} s ((a)–(d) {serve_s:.1f} s)")
    record["phase16"] = rows
    record["phase16_s"] = phase16_s
    return rows



def main(argv) -> int:
    if argv:
        print(f"chip_smoke.py takes no arguments, got {argv}",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py runs from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    # ... without its debugging fill of every fresh torch.empty buffer: the
    # fill would write each wrapper's whole output on every call (the push
    # sweep's out-rectangle, 1.64 GB per component on rmat16, of which the
    # kernel writes only the live tiles) and be timed as kernel work.
    # No kernel reads memory that was not written; the poisoned cases below
    # check that for the push step.
    torch.utils.deterministic.fill_uninitialized_memory = False
    # full float32 products in the plain versions and library calls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F
    from repro_torch.core import engine as TE
    from repro_torch.core import fusion as TF
    from repro_torch.core import usecases as TU
    from repro_torch.core.iterate import DTYPES, CompRuntime, comp_runtimes
    from repro_torch.core.fusion import Prim
    from repro_torch.core.kernel_lang import FLT, INT, Bin, Lit, Var, \
        expr_vars
    from repro_torch.core.synthesis import (pagerank_kernels,
                                            synthesize_round,
                                            weighted_pagerank_kernels)
    from repro_torch.graph import structure as TS
    from repro_torch.graph.partition import ShardMesh
    from repro_torch.kernels import build
    from repro_torch.kernels import edge_reduce as ER
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops as KO
    from repro_torch.kernels import segment_softmax as SS

    dev = torch.device("cuda")
    card = card_line()
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # ------------------------------------------------------------------
    # Build every library at once (one nvcc each): the rounds', the level
    # kernels' and the fixed kernels' (bag, softmax, both flash kernels).
    # ------------------------------------------------------------------
    progs = {name: TF.fuse(TU.ALL_SPECS[name]())
             for name in ("BFS", "SSSP", "WSP", "CC", "WP", "NSP")}
    progs["BFS depth"] = TF.fuse(TU.bfs_depth(0))

    def program_round(prog):
        (rnd,) = [r for _n, r in prog.rounds if r.leaves]
        return KO.sweep_round(comp_runtimes(rnd, synthesize_round(rnd)),
                              [leaf.plan for leaf in rnd.leaves])

    def direct_round(dk):
        comp = CompRuntime(idx=0, op=dk.rop, dtype=DTYPES[dk.dtype],
                           p_fn=dk.p_fn, init_fn=dk.init_fn,
                           source=dk.source, e_fn=dk.e_fn, p_expr=dk.p_expr)
        return KO.sweep_round([comp], [Prim(dk.rop, 0)])

    rounds = {name: program_round(p) for name, p in progs.items()}
    rounds["PR"] = direct_round(pagerank_kernels(2))
    rounds["WPR"] = direct_round(weighted_pagerank_kernels(2))
    # the handwritten kernel sets of phase 5 (SSSP's and WP's rounds are
    # the synthesized ones', so they share their libraries)
    handwritten = {name: TU.HANDWRITTEN[name]()
                   for name in ("SSSP", "BFS", "WP", "CC")}
    for name, dk in handwritten.items():
        rounds[f"handwritten {name}"] = direct_round(dk)
    inf = float("inf")
    int_inf = 2 ** 30 - 1               # segment.INT_INF, the int32 min ⊥
    p_hop = Bin("+", Var("n", INT), Lit(1, INT))          # BFS-like
    p_dist = Bin("+", Var("n", FLT), Var("w", FLT))       # SSSP-like
    p_wide = Bin("min", Var("n", FLT), Var("c", FLT))     # widest-path
    # (name, op, P per level, state dtypes, identities, mode)
    level_units = {
        "int n+1": ("min", [p_hop], [torch.int32], [int_inf], "value"),
        "float n+w": ("min", [p_dist], [torch.float32], [inf], "value"),
        "lex level 0": ("max", [p_wide], [torch.float32], [-inf], "value"),
        "lex level 1": ("min", [p_wide, p_dist],
                        [torch.float32, torch.float32], [-inf, inf],
                        "value"),
        "nonbot": ("max", [p_hop], [torch.int32], [int_inf], "nonbot")}
    t0 = time.perf_counter()
    units = [("round", r.source()) for r in rounds.values()]
    units += [("level", ER.level_source(ps, dts, ids, op, mode))
              for op, ps, dts, ids, mode in level_units.values()]
    units.append(("fixed", build.fixed_source()))
    build.build_all(units)
    # phase 16 (f)'s dry-run runs on the CPU beside phases 1–16
    dry = start_dryrun(ROOT / "build" / "dryrun_torch")
    phase16_rows = []
    names = [*rounds, *(f"level {k}" for k in level_units), "fixed"]
    builds = {name: round(build.BUILD_SECONDS.get(build.source_key(u[1]),
                                                  0.0), 3)
              for name, u in zip(names, units)}
    record["build_s"] = builds
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per library "
        f"{json.dumps(builds)}")
    walk = {name: r.walk_attributes() for name, r in rounds.items()}
    record["walk_attributes"] = walk
    log(f"pull/push/resolve compiled: {json.dumps(walk)}")

    # ------------------------------------------------------------------
    # Phase 1: kernels against their plain versions on the card.
    # ------------------------------------------------------------------
    import numpy as np

    def bits(t):
        if t.dtype == torch.float32:
            return t.view(torch.int32)
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    def time_ms(fn, reps):
        """Median device time of ``fn``'s work over ``reps`` runs, CUDA
        events around each run.  The card first sleeps ~2 ms on the stream
        so the run's launches are all queued behind it: the events then
        measure the device's work, not the host's launch overhead (a host
        part longer than the sleep still shows)."""
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    cases = []

    def kernel_cases(label, g, rnames, reps, plain_reps, batched=False):
        """Each kernel against its plain version on ``g``'s layouts, for
        the rounds ``rnames`` at frontier densities 0.05 and 1.0: bitwise
        equality, CUDA-event times and the byte bound; then each case once
        more from a poisoned push buffer.  ``batched``: each kernel's
        batched launch (``batched_kernel_case``)."""
        ein = TS.blocked_ell_cached(g, direction="in")
        eout = TS.blocked_ell_cached(g, direction="out")
        res = TS.push_resolution_cached(g)
        outdeg = torch.zeros(ein.n_pad, dtype=torch.float32, device=dev)
        outdeg[:g.n] = g.out_deg.clamp(min=1).float()
        wdeg = torch.ones(ein.n_pad, dtype=torch.float32, device=dev)
        wdeg[:g.n] = TS.w_out_deg(g)
        # the flat out-tile holding each resolution slot's candidate
        src = torch.div(res.in2out, eout.width, rounding_mode="floor")
        out_tile = (torch.div(src, ER.BLOCK_V, rounding_mode="floor")
                    * (eout.width // ER.BLOCK_E)
                    + torch.div(res.in2out - src * eout.width, ER.BLOCK_E,
                                rounding_mode="floor")).reshape(-1)
        del src
        make, into = ((batched_kernel_case, batch_cases) if batched
                      else (kernel_case, cases))
        for rname in rnames:
            for density in (0.05, 1.0):
                into.append(make(label, g, ein, eout, res, out_tile, outdeg,
                                 wdeg, rname, density, reps, plain_reps))
                torch.cuda.empty_cache()

    def slots_of(tile_act):
        """[n_i, n_j] tile activity → [n_pad, width] bool per slot."""
        return tile_act.repeat_interleave(ER.BLOCK_V, dim=0) \
            .repeat_interleave(ER.BLOCK_E, dim=1) != 0

    def poisoned_like(ts):
        """Buffers of the shapes and dtypes of ``ts``, every word POISON."""
        return [torch.full(tuple(t.shape), POISON, dtype=torch.int32,
                           device=dev).view(t.dtype) for t in ts]

    def compare(kname, rname, label, density, ks, ps, where=None):
        """Bitwise equality of kernel and plain outputs (on the slots
        ``where`` keeps, when given); returns the max |Δ| there."""
        err = 0.0
        for a, b in zip(ks, ps):
            if where is not None:
                a = torch.where(where, a, b)
            if not torch.equal(bits(a), bits(b)):
                diff = (a.double() - b.double()).abs()
                raise RuntimeError(
                    f"{kname} kernel disagrees with its plain version "
                    f"({rname} on {label}, density {density}): max |Δ| "
                    f"{float(diff.nan_to_num(float('inf')).max())}")
            err = max(err, float((a.double() - b.double()).abs()
                                 .nan_to_num(0.0).max()))
        return err

    def kernel_case(label, g, ein, eout, res, out_tile, outdeg, wdeg, rname,
                    density, reps, plain_reps):
        rnd = rounds[rname]
        n_pad = ein.n_pad
        rng = np.random.default_rng(1000 + int(density * 100))
        active = torch.from_numpy(
            (rng.random(n_pad) < density).astype(np.int32)).to(dev)
        active[g.n:] = 0
        st = []
        for dt, ident in zip(rnd.dtypes, rnd.idents):
            if dt == torch.float32:
                v = rng.uniform(0.5, 9.0, n_pad).astype(np.float32)
            else:
                v = rng.integers(0, 50, n_pad).astype(np.int32)
            v[rng.random(n_pad) < 0.25] = ident
            st.append(torch.from_numpy(v).to(dev))
        t_in = ER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, active)
        t_static = ein.tiles_static
        t_out = ER.tile_activity_push(eout.tile_nnz, active)
        t_res = ER.resolution_tile_activity(res.contrib, t_out, res.tile_nnz)
        pull_rest = (ein.nbrs, ein.weight, ein.capacity, ein.mask, active,
                     outdeg, wdeg, st, float(g.n), True)
        pull_args = (rnd, t_in, *pull_rest)
        front_args = (rnd, t_static, *pull_rest)
        push_args = (rnd, t_out, eout.nbrs, eout.weight, eout.capacity,
                     eout.mask, active, outdeg, wdeg, st, float(g.n))
        res_args = (rnd, t_res, res.valid, res.in2out)
        res_kw = dict(push_tile_act=t_out, width_out=eout.width, states=st,
                      need_hp=True)
        # timed as the main path calls it: has-pred for the push− rounds
        # (non-idempotent: a sum) only
        hp_main = any(op in ("sum", "prod") for spec in rnd.plan_specs
                      for _pos, op in spec)
        timed_kw = dict(res_kw, need_hp=hp_main)
        k_pull = ER.pull_sweep(*pull_args)
        k_front, k_act = ER.pull_sweep_frontier(*front_args)
        k_push = ER.push_sweep(*push_args)
        k_res = ER.resolve_sweep(*res_args, k_push, **res_kw)
        torch.cuda.synchronize()
        p_pull = ER._pull_plain(*pull_args)
        p_push = ER._push_plain(*push_args)
        p_res = ER._resolve_plain(*res_args, p_push, **res_kw)
        ran = slots_of(t_out)
        # the derived activity against the torch tile activity, bitwise
        compare("pull derived activity", rname, label, density, [k_act],
                [t_in])
        errs = {"pull": compare("pull (derived activity)", rname, label,
                                density, k_front, p_pull),
                "pull_given": compare("pull (given activity)", rname, label,
                                      density, k_pull, p_pull),
                # a skipped tile's push candidates are undefined on the card
                "push": compare("push", rname, label, density, k_push,
                                p_push, ran),
                "resolve": compare("resolve", rname, label, density, k_res,
                                   p_res)}
        # Poisoned repeat: the push buffer holds a NaN payload before the
        # push launch; the push sweep must overwrite every slot of the
        # tiles it runs, and the resolution must read no other.
        poisoned = [torch.full(tuple(eout.nbrs.shape), POISON,
                               dtype=torch.int32, device=dev).view(dt)
                    for dt in rnd.dtypes]
        q_push = ER.push_sweep(*push_args, out=poisoned)
        q_res = ER.resolve_sweep(*res_args, q_push, **res_kw)
        # ... and every pull output, the derived activity included, starts
        # as the payload: the walk and the grid-stride pass must overwrite
        # every word
        q_pull = ER.pull_sweep(*pull_args, out=poisoned_like(k_pull))
        q_front, q_act = ER.pull_sweep_frontier(
            *front_args, out=poisoned_like([*k_front, k_act]))
        torch.cuda.synchronize()
        compare("push (poisoned)", rname, label, density, q_push, p_push,
                ran)
        compare("resolve (poisoned)", rname, label, density, q_res, p_res)
        compare("pull (given activity, poisoned)", rname, label, density,
                q_pull, p_pull)
        compare("pull (derived activity, poisoned)", rname, label, density,
                [*q_front, q_act], [*p_pull, t_in])
        del p_pull, p_push, p_res, q_push, q_res, poisoned, k_res
        del k_pull, k_front, k_act, q_pull, q_front, q_act
        nc, nl = len(rnd.dtypes), rnd.n_levels
        n_tiles_in = int(t_in.sum())
        n_tiles_static = int(t_static.sum())
        n_tiles_out = int(t_out.sum())
        n_tiles_res = int(t_res.sum())
        # candidates the resolve kernel gathers: valid slots whose out-tile
        # ran (each lies in a processed resolution tile)
        gathered = int((res.valid.reshape(-1)
                        & (t_out.reshape(-1).index_select(0, out_tile) != 0))
                       .sum())
        del ran
        slot = ER.BLOCK_V * ER.BLOCK_E
        # The least bytes: each input read once, each output written once.
        # A skipped tile reads only its activity word.  A processed slot
        # reads its mask (1 B) and, of the other per-edge inputs, only those
        # the kernels load for this round (4 B each): the pull sweep's
        # source index always; the push sweep's destination index, the
        # weight and the capacity only where the round's P reads them.  The
        # vectors read are the frontier, the states and the degree vectors
        # that P reads.  The push sweep writes its candidates (4 B per slot
        # and component) only into the tiles t_out runs, so only those are
        # charged, as the pull sweep's slots are; the resolve kernel reads
        # a candidate only where its out-tile ran.
        reads = frozenset().union(*map(expr_vars, rnd.p_exprs))

        def slot_bytes(*names):
            return 1 + 4 * sum(nm in reads for nm in names)
        vec = n_pad * 4 * (1 + nc + ("outdeg" in reads) + ("wdeg" in reads))
        n_j_res = res.width // ER.BLOCK_E
        cells = n_pad * (ein.width // ER.BLOCK_E) * 4 * (nl + nc)
        bytes_ = {
            # derived activity: the static word of every tile; the source
            # index and mask (5 B) of every slot of every non-empty tile;
            # the weight and capacity P reads only in the tiles that run;
            # the vectors; the cells and the activity array written
            "pull": t_static.numel() * 4 + n_tiles_static * slot * 5
            + n_tiles_in * slot * (slot_bytes("w", "c") - 1) + vec + cells
            + t_in.numel() * 4,
            # given activity: the activity word of every tile, then the
            # running tiles' slots, the vectors and the cells
            "pull_given": t_in.numel() * 4 + n_tiles_in * slot * (
                4 + slot_bytes("w", "c")) + vec + cells,
            "push": t_out.numel() * 4 + n_tiles_out * slot * (
                slot_bytes("edst", "w", "c") + 4 * nc) + vec,
            # in2out (4 B) and valid (1 B) per processed slot, the push
            # activity word of each out-tile that ran, one candidate word
            # per component for each slot gathered and the levels written;
            # with has-pred, the states read once and its arrays written
            "resolve": t_res.numel() * 4 + n_tiles_res * slot * 5
            + n_tiles_out * 4 + gathered * 4 * nc
            + n_pad * n_j_res * 4 * nl
            + hp_main * (n_pad * 4 * nc + n_pad * n_j_res * 4 * nc),
        }
        case = {"graph": label, "round": rname, "density": density,
                "p_reads": sorted(reads), "poisoned_repeat": "bitwise",
                "resolve_timed_with_haspred": hp_main,
                "tiles": {"pull": n_tiles_in, "pull_static": n_tiles_static,
                          "push": n_tiles_out, "resolve": n_tiles_res},
                "candidates_gathered": gathered}
        def pair():
            """The parent's pull step: the torch tile activity, then the
            sweep with the given activity."""
            act = ER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, active)
            return ER.pull_sweep(rnd, act, *pull_rest)

        def pair_plain():
            act = ER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, active)
            return ER._pull_plain(rnd, act, *pull_rest)

        for kname, fn, plain in (
                ("pull", lambda: ER.pull_sweep_frontier(*front_args),
                 pair_plain),
                ("pull_given", lambda: ER.pull_sweep(*pull_args),
                 lambda: ER._pull_plain(*pull_args)),
                ("push", lambda: ER.push_sweep(*push_args),
                 lambda: ER._push_plain(*push_args)),
                ("resolve",
                 lambda: ER.resolve_sweep(*res_args, k_push, **timed_kw),
                 lambda: ER._resolve_plain(*res_args, k_push, **timed_kw))):
            case[kname] = {
                "ms": time_ms(fn, reps),
                "plain_ms": time_ms(plain, plain_reps),
                "bound_ms": bytes_[kname] / HBM_BYTES_PER_S * 1e3,
                "bytes": bytes_[kname], "max_abs_err": errs[kname]}
        case["pull"]["pair_ms"] = time_ms(pair, reps)
        log("kernel case " + json.dumps(case))
        return case

    batch_cases = []

    def batched_kernel_case(label, g, ein, eout, res, out_tile, outdeg, wdeg,
                            rname, density, reps, plain_reps):
        """One kernel case's batched launches (BATCH query slots over the
        shared layouts) against the solo plain version per slot: bitwise,
        from fresh and from poisoned buffers; timed beside BATCH solo
        launches and the plain version (the solo plain version per slot in
        turn, the batched plain version without its final stack)."""
        rnd = rounds[rname]
        n_pad, nb = ein.n_pad, BATCH
        rng = np.random.default_rng(2000 + int(density * 100))
        act_np = (rng.random((nb, n_pad)) < density).astype(np.int32)
        act_np[:, g.n:] = 0
        active = torch.from_numpy(act_np).to(dev)
        st = []
        for dt, ident in zip(rnd.dtypes, rnd.idents):
            if dt == torch.float32:
                v = rng.uniform(0.5, 9.0, (nb, n_pad)).astype(np.float32)
            else:
                v = rng.integers(0, 50, (nb, n_pad)).astype(np.int32)
            v[rng.random((nb, n_pad)) < 0.25] = ident
            st.append(torch.from_numpy(v).to(dev))
        t_static = ein.tiles_static
        t_in = ER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz, active)
        t_out = ER.tile_activity_push(eout.tile_nnz, active)
        t_res = ER.resolution_tile_activity(res.contrib, t_out, res.tile_nnz)
        hp_main = any(op in ("sum", "prod") for spec in rnd.plan_specs
                      for _pos, op in spec)
        nv = float(g.n)
        lay_in = (ein.nbrs, ein.weight, ein.capacity, ein.mask)
        lay_out = (eout.nbrs, eout.weight, eout.capacity, eout.mask)

        def solo_args(s):
            """Slot s's own frontier, activities and states."""
            return (active[s], [x[s] for x in st], t_in[s], t_out[s],
                    t_res[s])

        # one launch each, the pull outputs and the push candidates first
        # into fresh buffers, then into buffers poisoned with a NaN payload
        k_front, k_act = ER.pull_sweep_frontier(
            rnd, t_static, *lay_in, active, outdeg, wdeg, st, nv, True)
        k_pull = ER.pull_sweep(rnd, t_in, *lay_in, active, outdeg, wdeg, st,
                               nv, True)
        k_push = ER.push_sweep(rnd, t_out, *lay_out, active, outdeg, wdeg,
                               st, nv)
        res_kw = dict(push_tile_act=t_out, width_out=eout.width, states=st,
                      need_hp=True)
        k_res = ER.resolve_sweep(rnd, t_res, res.valid, res.in2out, k_push,
                                 **res_kw)
        torch.cuda.synchronize()
        q_front = ER.pull_sweep_frontier(
            rnd, t_static, *lay_in, active, outdeg, wdeg, st, nv, True,
            out=poisoned_like([*k_front, k_act]))
        q_pull = ER.pull_sweep(rnd, t_in, *lay_in, active, outdeg, wdeg, st,
                               nv, True, out=poisoned_like(k_pull))
        errs = {"pull": 0.0, "pull_given": 0.0, "push": 0.0, "resolve": 0.0}
        for s in range(nb):
            a_s, st_s, tin_s, tout_s, tres_s = solo_args(s)
            p_pull = ER._pull_plain(rnd, tin_s, *lay_in, a_s, outdeg, wdeg,
                                    st_s, nv, True)
            compare("batched pull derived activity", rname, label, density,
                    [k_act[s], q_front[1][s]], [tin_s, tin_s])
            errs["pull"] = max(errs["pull"], compare(
                "batched pull (derived activity)", rname, label, density,
                [o[s] for o in k_front + q_front[0]], p_pull + p_pull))
            errs["pull_given"] = max(errs["pull_given"], compare(
                "batched pull (given activity)", rname, label, density,
                [o[s] for o in k_pull + q_pull], p_pull + p_pull))
            del p_pull
            p_push = ER._push_plain(rnd, tout_s, *lay_out, a_s, outdeg, wdeg,
                                    st_s, nv)
            errs["push"] = max(errs["push"], compare(
                "batched push", rname, label, density, [c[s] for c in k_push],
                p_push, slots_of(tout_s)))
            p_res = ER._resolve_plain(rnd, tres_s, res.valid, res.in2out,
                                      p_push, tout_s, eout.width, st_s, True)
            errs["resolve"] = max(errs["resolve"], compare(
                "batched resolve", rname, label, density,
                [o[s] for o in k_res], p_res))
            del p_push, p_res
        # the poisoned repeat of push and resolve, into the same buffers
        for c in k_push:
            c.view(torch.int32).fill_(POISON)
        k_push = ER.push_sweep(rnd, t_out, *lay_out, active, outdeg, wdeg,
                               st, nv, out=k_push)
        q_res = ER.resolve_sweep(rnd, t_res, res.valid, res.in2out, k_push,
                                 **res_kw)
        torch.cuda.synchronize()
        for s in range(nb):
            a_s, st_s, tin_s, tout_s, tres_s = solo_args(s)
            p_push = ER._push_plain(rnd, tout_s, *lay_out, a_s, outdeg, wdeg,
                                    st_s, nv)
            compare("batched push (poisoned)", rname, label, density,
                    [c[s] for c in k_push], p_push, slots_of(tout_s))
            compare("batched resolve (poisoned)", rname, label, density,
                    [o[s] for o in q_res], [o[s] for o in k_res])
            del p_push
        del q_front, q_pull, q_res, k_front, k_act, k_pull, k_res
        # The least bytes of the batch: the layout bytes of the tiles that
        # run in any slot and the shared vectors once, each slot's own
        # activity words, frontier, states and outputs once per slot.  The
        # timed launches take has-pred as the main path does for the round
        # (the pull− and push− of a non-idempotent round), so the pull's
        # has-pred cells are charged only then.
        nc, nl = len(rnd.dtypes), rnd.n_levels
        reads = frozenset().union(*map(expr_vars, rnd.p_exprs))

        def slot_bytes(*names):
            return 1 + 4 * sum(nm in reads for nm in names)
        slot = ER.BLOCK_V * ER.BLOCK_E
        deg = n_pad * 4 * (("outdeg" in reads) + ("wdeg" in reads))
        own = n_pad * 4 * (1 + nc) * nb          # frontier + states per slot
        union = {"in": int((t_in.sum(0) > 0).sum()),
                 "out": int((t_out.sum(0) > 0).sum()),
                 "res": int((t_res.sum(0) > 0).sum())}
        n_j = ein.width // ER.BLOCK_E
        n_j_res = res.width // ER.BLOCK_E
        cells = n_pad * n_j * 4 * (nl + nc * hp_main) * nb
        tiles_out = int(t_out.sum())
        gathered = sum(int((res.valid.reshape(-1) & (
            t_out[s].reshape(-1).index_select(0, out_tile) != 0)).sum())
            for s in range(nb))
        bytes_ = {
            "pull": t_static.numel() * 4 + int(t_static.sum()) * slot * 5
            + union["in"] * slot * (slot_bytes("w", "c") - 1) + deg + own
            + cells + t_in.numel() * 4,
            "pull_given": t_in.numel() * 4 + union["in"] * slot * (
                4 + slot_bytes("w", "c")) + deg + own + cells,
            "push": t_out.numel() * 4
            + union["out"] * slot * slot_bytes("edst", "w", "c")
            + tiles_out * slot * 4 * nc + deg + own,
            "resolve": t_res.numel() * 4 + union["res"] * slot * 5
            + tiles_out * 4 + gathered * 4 * nc
            + n_pad * n_j_res * 4 * nl * nb
            + hp_main * (n_pad * 4 * nc * nb + n_pad * n_j_res * 4 * nc * nb),
        }
        timed_kw = dict(res_kw, need_hp=hp_main)
        case = {"graph": label, "round": rname, "density": density,
                "slots": nb, "p_reads": sorted(reads),
                "poisoned_repeat": "bitwise",
                "timed_with_haspred": hp_main,
                "tiles_union": union, "tiles_summed": {
                    "pull": int(t_in.sum()), "push": tiles_out,
                    "resolve": int(t_res.sum())},
                "candidates_gathered": gathered}

        def solo_each(fn):
            def run():
                for s in range(nb):
                    fn(*solo_args(s), s)
            return run

        for kname, fn, solo, plain in (
                ("pull", lambda: ER.pull_sweep_frontier(
                    rnd, t_static, *lay_in, active, outdeg, wdeg, st, nv,
                    hp_main),
                 solo_each(lambda a, x, ti, to, tr, s: ER.pull_sweep_frontier(
                     rnd, t_static, *lay_in, a, outdeg, wdeg, x, nv,
                     hp_main)),
                 solo_each(lambda a, x, ti, to, tr, s: ER._pull_plain(
                     rnd, ER.tile_activity(ein.nbrs, ein.mask, ein.tile_nnz,
                                           a),
                     *lay_in, a, outdeg, wdeg, x, nv, hp_main))),
                ("pull_given", lambda: ER.pull_sweep(
                    rnd, t_in, *lay_in, active, outdeg, wdeg, st, nv,
                    hp_main),
                 solo_each(lambda a, x, ti, to, tr, s: ER.pull_sweep(
                     rnd, ti, *lay_in, a, outdeg, wdeg, x, nv, hp_main)),
                 solo_each(lambda a, x, ti, to, tr, s: ER._pull_plain(
                     rnd, ti, *lay_in, a, outdeg, wdeg, x, nv, hp_main))),
                ("push", lambda: ER.push_sweep(
                    rnd, t_out, *lay_out, active, outdeg, wdeg, st, nv,
                    out=k_push),
                 solo_each(lambda a, x, ti, to, tr, s: ER.push_sweep(
                     rnd, to, *lay_out, a, outdeg, wdeg, x, nv,
                     out=[c[s] for c in k_push])),
                 solo_each(lambda a, x, ti, to, tr, s: ER._push_plain(
                     rnd, to, *lay_out, a, outdeg, wdeg, x, nv))),
                ("resolve", lambda: ER.resolve_sweep(
                    rnd, t_res, res.valid, res.in2out, k_push, **timed_kw),
                 solo_each(lambda a, x, ti, to, tr, s: ER.resolve_sweep(
                     rnd, tr, res.valid, res.in2out, [c[s] for c in k_push],
                     to, eout.width, x, hp_main)),
                 solo_each(lambda a, x, ti, to, tr, s: ER._resolve_plain(
                     rnd, tr, res.valid, res.in2out, [c[s] for c in k_push],
                     to, eout.width, x, hp_main)))):
            case[kname] = {
                "ms": time_ms(fn, reps), "solo_ms": time_ms(solo, reps),
                "plain_ms": time_ms(plain, plain_reps),
                "bound_ms": bytes_[kname] / HBM_BYTES_PER_S * 1e3,
                "bytes": bytes_[kname], "max_abs_err": errs[kname]}
        del k_push
        log("batched kernel case " + json.dumps(case))
        return case

    # ------------------------------------------------------------------
    # Phase 4 helpers: the four kernels off the graph main path.
    # ------------------------------------------------------------------
    counters = {"level": ER.LAUNCHES, "softmax": SS.LAUNCHES,
                "bag": EB.LAUNCHES, "flash_sm90": FA.LAUNCHES,
                "flash_f32": FA.LAUNCHES}
    entry_cases = {k: [] for k in counters}
    phase_launches = dict.fromkeys(counters, 0)

    def library_ms(fn, reps):
        """One PyTorch call's time.  The call is only timed, never
        compared, so it may take a nondeterministic implementation."""
        torch.use_deterministic_algorithms(False)
        try:
            return time_ms(fn, reps)
        finally:
            torch.use_deterministic_algorithms(True)

    def limit_share(got, want, tol):
        """The worst elementwise |Δ| as a share of its limit atol +
        rtol·|want| for ``tol`` = (rtol, atol), the max |Δ|, and that as a
        share of the median size of the non-zero outputs (a masked softmax
        slot is exactly 0)."""
        rtol, atol = tol
        diff = (got.float() - want.float()).abs()
        mag = want.float().abs()
        err = float(diff.max())
        worst = float((diff / (atol + rtol * mag)).max())
        nonzero = mag[mag > 0]
        median = (err / float(nonzero.median()) if nonzero.numel()
                  else None)
        return worst, err, median

    def entry_case(kernel, label, drive, plain, tol, nbytes, ops=0.0,
                   peak=None, library=None, reps=10, plain_reps=2,
                   detail=None):
        """One case of a phase-4 kernel.  Its launch count is set to 0 just
        before the driving call and read just after; the result is held
        against the plain version on the same inputs (bitwise when ``tol``
        is None, else elementwise |Δ| <= atol + rtol·|plain| for ``tol`` =
        (rtol, atol)); then kernel, plain version and library call are
        timed.  The bound is the larger of ``nbytes`` over the memory rate
        and ``ops`` over ``peak``."""
        count = counters[kernel]
        count[kernel] = 0
        got = drive()
        torch.cuda.synchronize()
        launched = count[kernel]
        if launched <= 0:
            raise RuntimeError(f"the {kernel} kernel never launched in its "
                               f"phase ({label})")
        phase_launches[kernel] += launched
        want = plain()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise RuntimeError(f"{kernel} {label}: {got.shape} {got.dtype} "
                               f"vs plain {want.shape} {want.dtype}")
        check = {}
        if tol is None:
            same = torch.equal(bits(got), bits(want))
            err = 0.0 if same else float(
                (got.double() - want.double()).abs().nan_to_num(inf).max())
            if not same:
                raise RuntimeError(f"{kernel} kernel disagrees with its plain "
                                   f"version ({label}): max |Δ| {err}")
        else:
            rtol, atol = tol
            worst, err, median = limit_share(got, want, tol)
            check = {"worst_over_limit": worst, "err_over_median": median}
            if not bool(torch.isfinite(got).all()) or not worst <= 1.0:
                raise RuntimeError(
                    f"{kernel} kernel disagrees with its plain version "
                    f"({label}): max |Δ| {err}, {worst} times its limit "
                    f"{atol} + {rtol}·|plain|")
        del got, want
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3 if peak else 0.0
        case = {"case": label, "launches": launched, "max_abs_err": err,
                "tolerance": "bitwise" if tol is None
                else {"rtol": tol[0], "atol": tol[1]}, **check,
                "ms": time_ms(drive, reps),
                "plain_ms": time_ms(plain, plain_reps),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops,
                "library_ms": None if library is None
                else library_ms(library, reps), **(detail or {})}
        log(f"{kernel} case " + json.dumps(case))
        entry_cases[kernel].append(case)
        return case

    def level_cases(label, g, names):
        """ell_level_reduce on ``g``'s in-layout, every source active, a
        quarter of each state ⊥; bitwise against the plain version."""
        e = TS.blocked_ell_cached(g, direction="in")
        n_pad, width = e.nbrs.shape
        n_tiles = int((e.tile_nnz > 0).sum())
        real_slots = int(e.tile_nnz.sum())
        rng = np.random.default_rng(77)
        active = torch.ones(n_pad, dtype=torch.int32, device=dev)
        ones = torch.ones(n_pad, dtype=torch.float32, device=dev)

        def state(values, ident):
            values[rng.random(n_pad) < 0.25] = ident
            return torch.from_numpy(values).to(dev)

        s_int = state(rng.integers(0, 50, n_pad).astype(np.int32), int_inf)
        s_dist = state(rng.uniform(0.5, 9.0, n_pad).astype(np.float32), inf)
        # integral widths, so the first lex level has ties to break
        s_wide = state(rng.integers(0, 16, n_pad).astype(np.float32), -inf)
        states = {"int n+1": [s_int], "float n+w": [s_dist],
                  "lex level 0": [s_wide], "lex level 1": [s_wide, s_dist],
                  "nonbot": [s_int]}
        best0 = None
        for name in names:
            op, ps, dts, ids, mode = level_units[name]
            # the walk's grid, the most non-empty (8 × 128) tiles in one
            # row tile and the cell buffer's bytes
            walk = ER.level_walk(e, build.level_library(
                ER.level_source(ps, dts, ids, op, mode)))
            st = states[name]
            bests = [best0] if name == "lex level 1" else []
            used = ps if mode == "value" else ps[:-1]
            reads = frozenset().union(*map(expr_vars, used))
            # The least bytes this data needs: every tile's count (4 B); of
            # each non-empty tile, each slot's mask (1 B); of each real slot
            # (the kernel reads no padding slot's inputs) the source index
            # (4 B) and the weight and capacity where P reads them; the
            # vectors read once (frontier, states, bests, the degrees P
            # reads) and the output written once.  Beside it the bytes as
            # the pull bound counts them, every slot of a non-empty tile
            # (the bound of the parent's kernel, which read them all).
            per_real = 4 + 4 * ("w" in reads) + 4 * ("c" in reads)
            vec = 1 + len(st) + len(bests) + ("outdeg" in reads) + \
                ("wdeg" in reads) + 1
            fixed = e.tile_nnz.numel() * 4 + n_pad * 4 * vec
            slots = n_tiles * e.block_v * e.block_e
            nbytes = fixed + slots + real_slots * per_real
            all_slots = fixed + slots * (1 + per_real)
            entry_case(
                "level", f"{label} {name}",
                lambda: ER.ell_level_reduce(e, op, ps, st, ids, active, ones,
                                            bests=bests, mode=mode,
                                            wdeg=ones),
                lambda: ER._level_plain(op, ps, st, ids, e.nbrs, e.weight,
                                        e.capacity, e.mask, active, ones,
                                        ones, bests, mode, float(e.n)),
                None, nbytes, reps=10, plain_reps=1,
                detail={"tiles": n_tiles, "tiles_all": e.tile_nnz.numel(),
                        "real_slots": real_slots,
                        "bytes_all_slots": all_slots,
                        "bound_all_slots_ms":
                            all_slots / HBM_BYTES_PER_S * 1e3, **walk})
            if name == "lex level 0":
                best0 = ER.ell_level_reduce(e, op, ps, st, ids, active, ones)

    def softmax_case(label, g):
        """ell_softmax over ``g``'s in-layout with its real mask.  The bound
        counts the bytes the work needs: each slot's mask byte and output,
        and the score of each real slot only; beside it the all-slot count
        (every score read).  The yardstick beside the kernel is the nearest
        library route, two calls that give NaN on an empty row (so not the
        same function, and not ``library_ms``)."""
        e = TS.blocked_ell_cached(g, direction="in")
        gen = torch.Generator(device=dev).manual_seed(30)
        scores = torch.randn(tuple(e.mask.shape), generator=gen,
                             device=dev).mul_(5.0)
        all_slots = scores.numel() * (4 + 1 + 4)
        # weights lie in [0, 1]: 1e-6 is a few float32 steps at 1
        case = entry_case(
            "softmax", label, lambda: KO.ell_softmax(scores, e.mask),
            lambda: SS._softmax_plain(scores, e.mask), (0.0, 1e-6),
            SS.ell_softmax_bytes(e.mask, scores.dtype), reps=10,
            plain_reps=1,
            detail={"real_slots": int(e.mask.sum()),
                    "bytes_all_slots": all_slots,
                    "bound_all_slots_ms": all_slots / HBM_BYTES_PER_S * 1e3,
                    **SS.kernel_attributes(scores.dtype)})
        got = KO.ell_softmax(scores, e.mask)
        # real slots set to 0: anything left (NaN included) is a masked
        # slot that is not exactly 0
        case["masked_exact_0"] = int(got.masked_fill_(e.mask, 0)
                                     .count_nonzero()) == 0
        del got
        case["yardstick"] = ("torch.softmax(scores.masked_fill(~mask, -inf), "
                             "1): two calls, NaN on an empty row")
        case["yardstick_ms"] = library_ms(lambda: torch.softmax(
            scores.masked_fill(~e.mask, -inf), 1), 10)
        log("softmax yardstick " + json.dumps(
            {k: case[k] for k in ("case", "ms", "bound_ms", "yardstick",
                                  "yardstick_ms", "masked_exact_0")}))
        if not case["masked_exact_0"]:
            raise RuntimeError(f"softmax {label}: a masked slot is not 0")
        del scores

    n16, e16 = 65536, 1048576
    t0 = time.perf_counter()
    g16 = TS.rmat_graph(n16, e16, seed=16, device=dev)
    ein = TS.blocked_ell_cached(g16, direction="in")
    eout = TS.blocked_ell_cached(g16, direction="out")
    TS.push_resolution_cached(g16)
    torch.cuda.synchronize()
    log(f"graph rmat_graph({n16}, {e16}, seed=16): {g16.num_edges} edges, "
        f"in-width {ein.width}, out-width {eout.width}, layouts built in "
        f"{time.perf_counter() - t0:.1f} s")
    record["graph16"] = {"n": n16, "edges": g16.num_edges,
                         "in_width": ein.width, "out_width": eout.width}
    del ein, eout
    kernel_cases("rmat16", g16, ("BFS", "WSP", "WPR"), 20, 3)
    record["kernel_cases"] = cases
    torch.cuda.empty_cache()
    kernel_cases("rmat16", g16, ("BFS", "WPR"), 10, 1, batched=True)
    record["batch_cases"] = batch_cases
    level_cases("rmat16", g16, ("int n+1", "float n+w", "lex level 0",
                                "lex level 1", "nonbot"))
    softmax_case("rmat16 in-layout", g16)

    # ------------------------------------------------------------------
    # Phase 2: RM-XS counters and a small query against the path oracle.
    # ------------------------------------------------------------------
    def on_cuda(r, label="query"):
        """A cuda query's result, which must not have left the cuda
        engine."""
        if r.stats.engine_used != "cuda" or r.stats.fallbacks != ():
            raise RuntimeError(f"{label}: ended on {r.stats.engine_used!r} "
                               f"with fallbacks {r.stats.fallbacks}")
        return r

    gx = TS.rmat_graph(400, 3200, seed=11, weighted=False, device=dev)
    auto = on_cuda(TE.run_program(gx, progs["BFS"], engine="cuda")).stats
    pull = on_cuda(TE.run_program(gx, progs["BFS"], engine="cuda",
                                  model="pull")).stats
    got = (auto.iterations, auto.push_iters, auto.edge_work, pull.edge_work,
           auto.resolve_work)
    if got != RMXS_BFS or auto.gather_work != RMXS_BFS[4]:
        raise RuntimeError(f"RM-XS BFS counters {got} != {RMXS_BFS}")
    gxw = TS.rmat_graph(400, 3200, seed=11, weighted=True, device=dev)
    s = on_cuda(TE.run_program(gxw, progs["SSSP"], engine="cuda")).stats
    if (s.iterations, s.edge_work) != RMXS_WSSSP:
        raise RuntimeError(f"RM-XS weighted SSSP counters "
                           f"{(s.iterations, s.edge_work)} != {RMXS_WSSSP}")
    log(f"RM-XS counters: BFS {got}, weighted SSSP "
        f"{(s.iterations, s.edge_work)} — equal to BENCH_pallas.json")
    from repro_torch.core.lang import paths_semantics
    gl = TS.line_graph(8, weighted=True, seed=2, device=dev)
    want = np.array(paths_semantics(TU.ALL_SPECS["SSSP"](), gl), np.float64)
    have = on_cuda(TE.run_program(gl, progs["SSSP"], engine="cuda")).value
    if not np.array_equal(have.double().cpu().numpy(), want):
        raise RuntimeError(f"SSSP on a line graph {have} != oracle {want}")
    log("path oracle: SSSP on line_graph(8) equals the paths semantics")

    # ------------------------------------------------------------------
    # Phase 3: the main path.
    # ------------------------------------------------------------------
    queries = []
    profiles = {}
    out_dir = ROOT / "chiprun_out"

    def setup(label, g):
        """Layouts and validation of one graph, timed as set-up."""
        times = {}
        for what, fn in (
                ("validate", lambda: TS.validate_graph(g)),
                ("ell_in", lambda: TS.blocked_ell_cached(g, direction="in")),
                ("ell_out", lambda: TS.blocked_ell_cached(g,
                                                          direction="out")),
                ("resolution", lambda: TS.push_resolution_cached(g))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[what] = time.perf_counter() - t0
        log(f"setup {label}: " + json.dumps(times))
        record.setdefault("setup_s", {})[label] = times

    def is_gather(name):
        return "gather" in name.lower() or "index" in name.lower()

    def step_kernels(prof, step):
        """The torch kernels launched inside the fixpoint's ``grafs::``
        ``step`` ranges (ops.iterate_cuda): {name: [calls, ms]}.  A kernel
        belongs to the aten op it was launched from, which lies inside the
        range.  (The sweep kernels, launched through ctypes, belong to no
        op and are counted from the device events instead.)"""
        out = {}
        for ev in prof.events():
            if not ev.kernels:
                continue
            up = ev
            while up is not None and up.name != f"grafs::{step}":
                up = up.cpu_parent
            if up is None:
                continue
            for k in ev.kernels:
                c = out.setdefault(k.name, [0, 0.0])
                c[0] += 1
                c[1] += k.duration / 1e3
        return out

    def profiled(label, fn, no_gather_per=None):
        """One warm re-run under torch.profiler: device busy time against
        the wall, the top ops by device time (to the details directory),
        torch's gather and index kernels, the device spans of the pull and
        push steps and the torch kernels inside the pull steps.  With
        ``no_gather_per="iteration"`` the run fails if a torch gather or
        index kernel ran once per iteration or more; with ``"pull"``, if
        one launched inside the pull steps ran once per pull iteration or
        more, or if the pull kernel did not launch exactly once per pull
        iteration."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        on_cuda(r, label)
        ka = prof.key_averages()
        dev_ev = [e for e in ka if e.device_type == DeviceType.CUDA]
        # the grafs:: ranges also appear on the device timeline, as spans
        # from a step's first kernel to its last: kept apart from the
        # kernels
        spans = {e.key: e.device_time_total / 1e3 for e in dev_ev
                 if e.key.startswith("grafs::")}
        kern = [e for e in dev_ev if not e.key.startswith("grafs::")]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        gathers = {e.key[:60]: {"calls": e.count,
                                "ms": e.self_device_time_total / 1e3}
                   for e in kern if is_gather(e.key)}
        pull_step = step_kernels(prof, "pull")
        summary = {"wall_ms": wall, "device_busy_ms": busy,
                   "idle_share": max(0.0, 1.0 - busy / wall),
                   "iterations": r.stats.iterations,
                   "pull_iters": r.stats.pull_iters,
                   "push_iters": r.stats.push_iters,
                   "step_span_ms": spans,
                   "pull_kernel_launches": sum(
                       e.count for e in kern if "pull_kernel" in e.key),
                   "pull_step_torch_ms": sum(c[1] for c in
                                             pull_step.values()),
                   "top_device_ms": {e.key[:60]: e.self_device_time_total
                                     / 1e3 for e in top},
                   "gathers": gathers,
                   "pull_step_kernels": {k[:60]: c for k, c
                                         in pull_step.items()}}
        profiles[label] = summary
        log(f"profile {label}: " + json.dumps(summary))
        try:
            out_dir.mkdir(exist_ok=True)
            (out_dir / f"profile_{label.replace(' ', '_')}.txt").write_text(
                ka.table(sort_by="self_device_time_total", row_limit=30))
        except OSError:
            pass
        if no_gather_per == "iteration":
            per = [k for k, v in gathers.items()
                   if v["calls"] >= r.stats.iterations]
            if per:
                raise RuntimeError(f"{label}: a torch gather ran every "
                                   f"iteration: {per}")
        elif no_gather_per == "pull":
            n_pull = r.stats.pull_iters
            if summary["pull_kernel_launches"] != n_pull:
                raise RuntimeError(f"{label}: the pull kernel ran "
                                   f"{summary['pull_kernel_launches']} "
                                   f"times in {n_pull} pull iterations")
            if not pull_step:
                raise RuntimeError(f"{label}: the profiler attributed no "
                                   "kernel to a pull step")
            per = [k[:60] for k, c in pull_step.items()
                   if is_gather(k) and c[0] >= n_pull]
            if per:
                raise RuntimeError(f"{label}: a torch gather ran in every "
                                   f"pull iteration: {per}")

    def run(label, g, cuda_fn, pull_fn, exact, rows=None):
        """A cuda query against the pull engine, its row added to ``rows``
        (the main path's ``queries`` by default)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = cuda_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ref = pull_fn()
        val, want = r.value, ref.value
        if val.shape != (g.n,) or val.dtype != want.dtype:
            raise RuntimeError(f"{label}: shape/dtype {val.shape} "
                               f"{val.dtype} vs {want.shape} {want.dtype}")
        if exact:
            ok = torch.equal(bits(val), bits(want))
        else:
            ok = bool(torch.isfinite(val).all()) and \
                torch.allclose(val, want, rtol=1e-5, atol=1e-8)
        st = r.stats
        row = {"query": label, "n": g.n, "edges": g.num_edges,
               "iterations": st.iterations, "push_iters": st.push_iters,
               "pull_iters": st.pull_iters, "edge_work": st.edge_work,
               "resolve_work": st.resolve_work,
               "gather_work": st.gather_work, "wall_ms": wall,
               "pull_engine_iterations": ref.stats.iterations,
               "engine_used": st.engine_used,
               "match": ("bitwise" if exact else "allclose") if ok
               else "MISMATCH"}
        log("query " + json.dumps(row))
        if not ok:
            raise RuntimeError(f"{label}: cuda engine disagrees with the "
                               "pull engine")
        on_cuda(r, label)
        (queries if rows is None else rows).append(row)
        answers[label] = r

    # The main path's launch counts: set to 0 just before each graph's
    # queries, read just after, and summed.
    main_launches = dict.fromkeys(MAIN_KERNELS, 0)

    def add_launches():
        for kname in MAIN_KERNELS:
            main_launches[kname] += ER.LAUNCHES[kname]

    # ------------------------------------------------------------------
    # Phase 5: the adaptive and dense engines, the handwritten kernel sets
    # on the card and the fallback chain.  Its parts run while the graphs
    # they need live: the cuda answers they are held to come from phase 3
    # (``answers``).
    # ------------------------------------------------------------------
    answers = {}
    phase5_rows = []
    # phase 5's own cuda reference queries, run outside the main path's
    # launch counts and so kept out of ``queries``
    phase5_refs = []
    hw_launches = dict.fromkeys(MAIN_KERNELS, 0)
    from repro_torch.core import guard

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    def bot_mask(t):
        """⊥-ish values, as the reference's tests collapse them: NaN or
        |v| >= 1e8."""
        v = t.double()
        return v.isnan() | (v.abs() >= 1e8)

    def warm_walls(fn, ref_fn):
        """Second (warm) walls of a query and of its reference query, one
        after the other: a first query also pays synthesis, the plan, the
        caching allocator's growth and, on cuda, its sweep rounds."""
        return {"warm_wall_ms": timed(fn)[1],
                "reference_warm_wall_ms": timed(ref_fn)[1]}

    def phase5_row(part, label, r, wall, want, match, **extra):
        st = r.stats
        row = {"part": part, "query": label, "engine": st.engine_used,
               "n": int(r.value.shape[0]), "iterations": st.iterations,
               "pull_iters": st.pull_iters, "push_iters": st.push_iters,
               "edge_work": st.edge_work, "wall_ms": wall,
               "reference": want["engine"],
               "reference_iterations": want["iterations"],
               "reference_wall_ms": want["wall_ms"], "match": match,
               **extra}
        log(f"phase 5 {part} " + json.dumps(row))
        phase5_rows.append(row)

    def cuda_answer(label):
        r = answers[label]
        row = [q for q in queries + phase5_refs if q["query"] == label][0]
        return r, {"engine": "cuda", "iterations": r.stats.iterations,
                   "wall_ms": row["wall_ms"]}

    def adaptive_query(label, make, exact):
        """``make(engine)`` runs the query; adaptive's answer against the
        cuda one of phase 3: bitwise, or allclose (rtol 1e-5) with the same
        iteration count."""
        want, info = cuda_answer(label)
        r, wall = timed(lambda: make("adaptive"))
        if r.stats.engine_used != "adaptive" or r.stats.fallbacks != ():
            raise RuntimeError(f"adaptive {label}: ended on "
                               f"{r.stats.engine_used!r}")
        if exact:
            ok = torch.equal(bits(r.value), bits(want.value))
        else:
            ok = bool(torch.isfinite(r.value).all()) and torch.allclose(
                r.value, want.value, rtol=1e-5, atol=1e-8) and \
                r.stats.iterations == want.stats.iterations
        phase5_row("adaptive", label, r, wall, info,
                   ("bitwise" if exact else "allclose") if ok
                   else "MISMATCH",
                   **warm_walls(lambda: make("adaptive"),
                                lambda: on_cuda(make("cuda"))))
        if not ok:
            raise RuntimeError(f"adaptive {label} disagrees with cuda")

    def handwritten_query(name, g, label, synthesized):
        """A handwritten kernel set on cuda against the synthesized
        program's cuda answer (``synthesized()`` reruns that query for the
        warm walls): equal bits wherever the value is not ⊥ and ⊥ in the
        same places, equal counters."""
        want, info = cuda_answer(label)
        ER.reset_launches()
        r, wall = timed(lambda: on_cuda(TE.run_direct(
            g, handwritten[name], engine="cuda"), f"handwritten {name}"))
        for kname in MAIN_KERNELS:
            hw_launches[kname] += ER.LAUNCHES[kname]
        warm = warm_walls(
            lambda: on_cuda(TE.run_direct(g, handwritten[name],
                                          engine="cuda")),
            lambda: on_cuda(synthesized()))
        bot = bot_mask(want.value)
        same = torch.equal(bot_mask(r.value), bot) and torch.equal(
            bits(r.value)[~bot], bits(want.value)[~bot])
        counters = (r.stats.iterations, r.stats.edge_work,
                    r.stats.push_iters)
        want_counters = (want.stats.iterations, want.stats.edge_work,
                         want.stats.push_iters)
        ok = same and counters == want_counters
        phase5_row("handwritten", f"handwritten {name} ({label})", r, wall,
                   info, "bitwise up to ⊥" if ok else "MISMATCH",
                   bits_differ=int((bits(r.value) != bits(want.value))
                                   .sum()),
                   counters=counters, reference_counters=want_counters,
                   **warm)
        if not ok:
            raise RuntimeError(f"handwritten {name} disagrees with the "
                               f"synthesized {label}")

    def fallback_checks(g, label):
        """SSSP under ``fallback=True``: a RuntimeError raised in place of
        ``ops.iterate_cuda`` (outside the kernel layer) and an out-of-memory
        error raised inside it degrade to adaptive with one event and the
        cuda answer's bits; a KernelLaunchError, and a round library that
        lacks its entry points, propagate at once; a clean query stays on
        cuda."""
        want = answers[label]
        real = KO.iterate_cuda
        calls = []

        def query():
            return TE.run_program(g, progs["SSSP"], engine="cuda",
                                  fallback=True)

        def raising(exc):
            def fn(*a, **k):
                calls.append(type(exc).__name__)
                raise exc
            return fn

        def degrades(name, attr, exc):
            """``KO.<attr>`` raises ``exc`` for one query, which must end on
            adaptive with one event and the cuda answer's bits."""
            calls.clear()
            real_fn = getattr(KO, attr)
            setattr(KO, attr, raising(exc))
            try:
                r, wall = timed(query)
            finally:
                setattr(KO, attr, real_fn)
            event = ("cuda", "adaptive", f"{type(exc).__name__}: {exc}")
            ok = (r.stats.engine_used == "adaptive"
                  and r.stats.fallbacks == (event,)
                  and torch.equal(bits(r.value), bits(want.value)))
            phase5_row("fallback", f"{name} ({label})", r, wall,
                       {"engine": "cuda",
                        "iterations": want.stats.iterations,
                        "wall_ms": None}, "bitwise" if ok else "MISMATCH",
                       fallbacks=[list(ev) for ev in r.stats.fallbacks],
                       exec_retries=r.stats.exec_retries,
                       injected_calls=len(calls))
            if not ok:
                raise RuntimeError(f"fallback {name}: {r.stats.engine_used} "
                                   f"{r.stats.fallbacks}")

        degrades("injected RuntimeError", "iterate_cuda",
                 RuntimeError("injected fault"))
        degrades("injected OutOfMemoryError in the kernel layer",
                 "sweep_round",
                 torch.OutOfMemoryError("CUDA out of memory (injected)"))
        calls.clear()
        KO.iterate_cuda = raising(guard.KernelLaunchError(
            "CUDA push kernel launch failed: cudaError 700 (injected)"))
        try:
            query()
        except guard.KernelLaunchError as exc:
            propagated = str(exc)
        else:
            raise RuntimeError("fallback: a KernelLaunchError was caught")
        finally:
            KO.iterate_cuda = real
        if calls != ["KernelLaunchError"]:
            raise RuntimeError(f"fallback: a KernelLaunchError was retried "
                               f"({calls})")
        log("phase 5 fallback " + json.dumps(
            {"part": "fallback", "query": f"injected KernelLaunchError "
             f"({label})", "propagated": propagated,
             "iterate_cuda_calls": len(calls)}))
        # a round library without its entry points: an AttributeError in
        # the launch wrapper, raised by the engine as a KernelLaunchError
        real_library = ER.SweepRound.library
        ER.SweepRound.library = lambda self: object()
        try:
            query()
        except guard.KernelLaunchError as exc:
            if not isinstance(exc.__cause__, AttributeError):
                raise RuntimeError(f"fallback: the missing entry point "
                                   f"surfaced as {exc!r}") from exc
            propagated = str(exc)
        else:
            raise RuntimeError("fallback: a kernel-layer fault was caught")
        finally:
            ER.SweepRound.library = real_library
        log("phase 5 fallback " + json.dumps(
            {"part": "fallback", "query": f"round library without its "
             f"entry points ({label})", "propagated": propagated}))
        r, wall = timed(query)
        on_cuda(r, "clean fallback=True query")
        if not torch.equal(bits(r.value), bits(want.value)):
            raise RuntimeError("clean fallback=True query disagrees")
        phase5_row("fallback", f"clean ({label})", r, wall,
                   {"engine": "cuda", "iterations": want.stats.iterations,
                    "wall_ms": None}, "bitwise", fallbacks=[],
                   exec_retries=r.stats.exec_retries)

    def phase5_rmat16(g):
        n = g.n
        for name in ("WP", "BFS depth"):
            run(f"{name} rmat16", g,
                lambda: TE.run_program(g, progs[name], engine="cuda"),
                lambda: TE.run_program(g, progs[name], engine="pull"), True,
                rows=phase5_refs)
        for name in ("BFS", "SSSP", "WSP", "WP"):
            adaptive_query(f"{name} rmat16",
                           lambda eng: TE.run_program(g, progs[name],
                                                      engine=eng), True)
        adaptive_query("PageRank rmat16",
                       lambda eng: TE.run_direct(
                           g, pagerank_kernels(n, tol=1e-4 / n), engine=eng),
                       False)
        for name, prog in (("SSSP", "SSSP"), ("BFS", "BFS depth"),
                           ("WP", "WP")):
            handwritten_query(name, g, f"{prog} rmat16",
                              lambda: TE.run_program(g, progs[prog],
                                                     engine="cuda"))
        fallback_checks(g, "SSSP rmat16")

    def phase5_undirected(gu16):
        label = "CC undirected(rmat16)"
        adaptive_query(label, lambda eng: TE.run_program(
            gu16, progs["CC"], engine=eng), True)
        handwritten_query("CC", gu16, label, lambda: TE.run_program(
            gu16, progs["CC"], engine="cuda"))
        log(f"phase 5 handwritten launches: {json.dumps(hw_launches)}")
        for kname, cnt in hw_launches.items():
            if cnt <= 0:
                raise RuntimeError(f"the {kname} kernel never launched for "
                                   "the handwritten kernel sets")

    def phase5_dense():
        """The dense engine on rmat_graph(16384, 262144, seed=16): [n, n]
        matrices of 268,435,456 entries each, against the pull engine."""
        nd, ed = 16384, 262144
        gd = TS.rmat_graph(nd, ed, seed=16, device=dev)
        torch.cuda.synchronize()
        # the run's peak so far, kept for the record's peak_mem_gb
        record["peak_before_dense_bytes"] = max(
            torch.cuda.max_memory_allocated(), *batch_peaks)
        torch.cuda.reset_peak_memory_stats()
        for label, make, exact in (
                ("BFS", lambda eng: TE.run_program(gd, progs["BFS"],
                                                   engine=eng), True),
                ("SSSP", lambda eng: TE.run_program(gd, progs["SSSP"],
                                                    engine=eng), True),
                ("PageRank", lambda eng: TE.run_direct(
                    gd, pagerank_kernels(nd, tol=1e-4 / nd), engine=eng),
                 False)):
            ref, ref_wall = timed(lambda: make("pull"))
            r, wall = timed(lambda: make("dense"))
            if exact:
                ok = torch.equal(bits(r.value), bits(ref.value))
            else:
                ok = bool(torch.isfinite(r.value).all()) and torch.allclose(
                    r.value, ref.value, rtol=1e-5, atol=1e-8)
            phase5_row("dense", f"{label} rmat14", r, wall,
                       {"engine": "pull",
                        "iterations": ref.stats.iterations,
                        "wall_ms": ref_wall},
                       ("bitwise" if exact else "allclose") if ok
                       else "MISMATCH",
                       max_memory_allocated=torch.cuda.max_memory_allocated(),
                       **warm_walls(lambda: make("dense"),
                                    lambda: make("pull")))
            if not ok or r.stats.engine_used != "dense":
                raise RuntimeError(f"dense {label} disagrees with pull")
        record["dense_peak_bytes"] = torch.cuda.max_memory_allocated()
        del gd
        TE.clear_program_caches()
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # Phase 6: chunked, checkpointed and warm-started cuda fixpoints,
    # through the entry points, while the graphs they need live.  Each
    # query runs whole, in chunks with a snapshot after each, killed after
    # its second chunk and resumed; the sweep kernels' launch counts are
    # set to 0 just before each run and read just after (none of them
    # counts for the main path).
    # ------------------------------------------------------------------
    import contextlib
    import shutil
    import tempfile
    from repro_torch.checkpoint.fixpoint import FixpointCheckpointer
    ckpt_root = Path(tempfile.mkdtemp(prefix="grafs_ckpt_"))
    phase6_rows = []
    io_ms = {"save": [], "restore": []}

    class Killed(Exception):
        """The kill injected through ``fault_hook``."""

    @contextlib.contextmanager
    def timed_io():
        """Time every snapshot save (the device-to-host copy and the
        durable write) and restore (the read and the host-to-device
        copy)."""
        real_save = FixpointCheckpointer.save
        real_restore = FixpointCheckpointer.restore

        def save(self, carry, step):
            t0 = time.perf_counter()
            real_save(self, carry, step)
            io_ms["save"].append((time.perf_counter() - t0) * 1e3)

        def restore(self, carry_like):
            t0 = time.perf_counter()
            out = real_restore(self, carry_like)
            torch.cuda.synchronize()
            io_ms["restore"].append((time.perf_counter() - t0) * 1e3)
            return out

        FixpointCheckpointer.save = save
        FixpointCheckpointer.restore = restore
        try:
            yield
        finally:
            FixpointCheckpointer.save = real_save
            FixpointCheckpointer.restore = real_restore

    def counted(fn):
        """``fn()`` with the sweep kernels' launches counted: (result, wall
        ms, launches)."""
        ER.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return out, wall, {k: ER.LAUNCHES[k] for k in MAIN_KERNELS}

    def killed_launches(make, every):
        """Run ``make`` with a ``fault_hook`` that kills it after its second
        chunk; the launches it made."""
        real = KO.iterate_cuda

        def killer(k):
            if k >= 2 * every:
                raise Killed(k)

        KO.iterate_cuda = lambda *a, **kw: real(*a, fault_hook=killer, **kw)
        ER.reset_launches()
        try:
            make()
        except Killed:
            pass
        else:
            raise RuntimeError("the kill after the second chunk never fired")
        finally:
            KO.iterate_cuda = real
        torch.cuda.synchronize()
        return {k: ER.LAUNCHES[k] for k in MAIN_KERNELS}

    def snapshot_bytes(d):
        step = max(d.glob("step_*"))
        return sum(f.stat().st_size for f in step.iterdir())

    def stat_tuple(r):
        st = r.stats
        return (st.iterations, st.push_iters, st.pull_iters, st.edge_work,
                st.resolve_work, st.gather_work)

    def phase6_case(label, g, make, every):
        """``make(**kw)`` runs one cuda query through its entry point and
        returns (result, state).  The chunked and the killed-and-resumed
        runs must give the whole run's state bits, counters and launches
        (the killed run's and the resumed run's summed)."""
        d = ckpt_root / label.replace(" ", "_")
        (mono, mono_st), mono_wall, mono_l = counted(make)
        n_saves = len(io_ms["save"])
        (ck, ck_st), ck_wall, ck_l = counted(lambda: make(
            checkpoint_every=every, ckpt_dir=str(d / "chunked")))
        saves = io_ms["save"][n_saves:]
        kill_l = killed_launches(lambda: make(
            checkpoint_every=every, ckpt_dir=str(d / "killed")), every)
        n_rest = len(io_ms["restore"])
        (rs, rs_st), rs_wall, rs_l = counted(lambda: make(
            checkpoint_every=every, ckpt_dir=str(d / "killed"), resume=True))
        restore_ms = io_ms["restore"][n_rest:]
        mono_warm = counted(make)[1]
        ck_warm = counted(lambda: make(checkpoint_every=every,
                                       ckpt_dir=str(d / "again")))[1]
        for r in (mono, ck, rs):
            on_cuda(r, f"phase 6 {label}")
        same = all(torch.equal(bits(a), bits(b)) for x in (ck_st, rs_st)
                   for a, b in zip(mono_st, x))
        counters = stat_tuple(mono)
        ok = (same and stat_tuple(ck) == counters
              and stat_tuple(rs) == counters and ck_l == mono_l
              and {k: kill_l[k] + rs_l[k] for k in MAIN_KERNELS} == mono_l
              and len(restore_ms) == 1)
        row = {"query": label, "n": g.n, "edges": g.num_edges,
               "checkpoint_every": every,
               "iterations": counters[0], "push_iters": counters[1],
               "pull_iters": counters[2], "edge_work": counters[3],
               "resolve_work": counters[4], "gather_work": counters[5],
               "launches": mono_l, "chunked_launches": ck_l,
               "killed_launches": kill_l, "resumed_launches": rs_l,
               "snapshots": len(saves),
               "snapshot_bytes": snapshot_bytes(d / "chunked"),
               "save_ms_median": statistics.median(saves),
               "restore_ms": restore_ms[0] if restore_ms else None,
               "wall_ms": mono_wall, "chunked_wall_ms": ck_wall,
               "resumed_wall_ms": rs_wall, "warm_wall_ms": mono_warm,
               "chunked_warm_wall_ms": ck_warm,
               "match": "bitwise" if ok else "MISMATCH"}
        log("phase 6 " + json.dumps(row))
        phase6_rows.append(row)
        if not ok:
            raise RuntimeError(f"phase 6 {label}: the chunked or resumed "
                               "fixpoint differs from the whole one")

    def phase6_warm(g, label):
        """SSSP warm-started from its converged state through run_program
        and run_direct (the handwritten set): one iteration, the same
        bits."""
        (cold, state), cold_wall, cold_l = counted(lambda: TE.run_program(
            g, progs["SSSP"], engine="cuda", return_state=True))
        on_cuda(cold, "phase 6 cold SSSP")
        if state[0].device.type != "cuda":
            raise RuntimeError("return_state gave a state off the card")
        warm, wall, warm_l = counted(lambda: TE.run_program(
            g, progs["SSSP"], engine="cuda", init_state=state))
        direct, d_wall, d_l = counted(lambda: TE.run_direct(
            g, handwritten["SSSP"], engine="cuda", init_state=state))
        for r, what, w, lc in ((warm, "run_program", wall, warm_l),
                               (direct, "run_direct", d_wall, d_l)):
            on_cuda(r, f"phase 6 warm {what}")
            ok = r.stats.iterations == 1 and torch.equal(
                bits(r.value), bits(state[0] if what == "run_direct"
                                    else cold.value))
            row = {"query": f"warm SSSP {label} ({what})",
                   "iterations": r.stats.iterations,
                   "cold_iterations": cold.stats.iterations,
                   "launches": lc, "cold_launches": cold_l,
                   "warm_wall_ms": w, "cold_wall_ms": cold_wall,
                   "match": "bitwise" if ok else "MISMATCH"}
            log("phase 6 " + json.dumps(row))
            phase6_rows.append(row)
            if not ok:
                raise RuntimeError(f"phase 6 warm SSSP ({what}) took "
                                   f"{r.stats.iterations} iterations or "
                                   "changed the answer")

    def phase6_mismatch(g, d):
        """Resuming the BFS snapshots under another source must raise
        CheckpointMismatchError, which the fallback chain never takes."""
        for fallback in (False, True):
            try:
                TE.run_program(g, progs["BFS"], engine="cuda", source=3,
                               checkpoint_every=2, ckpt_dir=str(d),
                               resume=True, fallback=fallback)
            except guard.CheckpointMismatchError:
                pass
            else:
                raise RuntimeError("a snapshot resumed under another source "
                                   f"(fallback={fallback})")
        log("phase 6 " + json.dumps(
            {"query": "resume BFS rmat16 under source 3",
             "raised": "CheckpointMismatchError",
             "with_fallback": "CheckpointMismatchError"}))

    def program_query(g, name):
        def make(**kw):
            return TE.run_program(g, progs[name], engine="cuda",
                                  return_state=True, **kw)
        return make

    def direct_query(g, dk, **fixed):
        def make(**kw):
            r = TE.run_direct(g, dk, engine="cuda", **fixed, **kw)
            return r, (r.value,)
        return make

    def phase6_rmat16(g):
        n = g.n
        with timed_io():
            phase6_case("BFS rmat16", g, program_query(g, "BFS"), 2)
            phase6_case("PageRank rmat16", g, direct_query(
                g, pagerank_kernels(n, tol=1e-4 / n)), 10)
            phase6_case("weighted PageRank push rmat16", g, direct_query(
                g, weighted_pagerank_kernels(n, tol=1e-4 / n),
                model="push"), 10)
            phase6_warm(g, "rmat16")
            phase6_mismatch(g, ckpt_root / "BFS_rmat16" / "chunked")

    # ------------------------------------------------------------------
    # Phase 7: batched queries, BATCH sources at a time, through
    # run_program_batch and run_direct(sources=), while the graphs they
    # need live.  The three sweep kernels' launch counts are set to 0 just
    # before each batch and read just after (none counts for the main
    # path); every slot is held bitwise, with its six counters, against its
    # solo cuda query.
    # ------------------------------------------------------------------
    phase7_rows = []
    batch_peaks = []           # the run's peaks before each batch's reset

    def reset_peak():
        batch_peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def batch_sources(g, seed, count=BATCH):
        """``count`` distinct sources with out-degree > 0, seeded."""
        rng = np.random.default_rng(seed)
        cand = np.flatnonzero(g.out_deg.cpu().numpy() > 0)
        return [int(s) for s in rng.choice(cand, count, replace=False)]

    def phase7_case(label, g, batch_fn, solo_fn, srcs):
        """One batch against its solo queries: bits, counters, launches (at
        most one per kernel per batch iteration, fewer than the solo
        queries'), the first and warm walls and the peak device memory."""
        torch.cuda.empty_cache()
        reset_peak()
        outs, wall, launched = counted(lambda: batch_fn(srcs))
        peak = torch.cuda.max_memory_allocated()
        solos, solo_wall, solo_l = counted(
            lambda: [solo_fn(s) for s in srcs])
        warm = counted(lambda: batch_fn(srcs))[1]
        solo_warm = counted(lambda: [solo_fn(s) for s in srcs])[1]
        for r in outs + solos:
            on_cuda(r, f"phase 7 {label}")
        iters = [o.stats.iterations for o in outs]
        same = all(torch.equal(bits(o.value), bits(q.value))
                   and stat_tuple(o) == stat_tuple(q)
                   for o, q in zip(outs, solos))
        launches_ok = all(
            launched[k] <= max(iters)
            and (solo_l[k] == 0 or 0 < launched[k] < solo_l[k])
            for k in MAIN_KERNELS)
        row = {"query": label, "n": g.n, "edges": g.num_edges,
               "slots": len(srcs), "sources": srcs, "iterations": iters,
               "push_iters": [o.stats.push_iters for o in outs],
               "launches": launched, "solo_launches": solo_l,
               "wall_ms": wall, "warm_wall_ms": warm,
               "solo_wall_ms": solo_wall, "solo_warm_wall_ms": solo_warm,
               "queries_per_s": len(srcs) / warm * 1e3,
               "solo_queries_per_s": len(srcs) / solo_warm * 1e3,
               "peak_bytes": peak, "card": card,
               "match": "bitwise" if same else "MISMATCH"}
        log("phase 7 " + json.dumps(row))
        phase7_rows.append(row)
        if not same:
            raise RuntimeError(f"phase 7 {label}: a slot differs from its "
                               "solo query")
        if not launches_ok:
            raise RuntimeError(f"phase 7 {label}: launches {launched} in "
                               f"{max(iters)} iterations, solo {solo_l}")

    def phase7_continuous(label, g):
        """SSSP served in chunks of 2 iterations through return_state /
        init_state: each converged slot retires, and the next source takes
        it with a fresh batch_init_state row; every answer must equal its
        solo query's."""
        prog = progs["SSSP"]
        order = batch_sources(g, 78, BATCH + BATCH // 2)
        srcs, queue = order[:BATCH], order[BATCH:]
        answers, chunks = {}, 0
        ER.reset_launches()
        reset_peak()
        t0 = time.perf_counter()
        outs, state = TE.run_program_batch(g, prog, srcs, max_iter=2,
                                           on_nonconverge="ignore",
                                           return_state=True)
        while len(answers) < len(order):
            chunks += 1
            rows = list(state)
            for b, o in enumerate(outs):
                on_cuda(o, f"phase 7 {label}")
                if o.stats.converged and srcs[b] not in answers:
                    answers[srcs[b]] = o.value.clone()
                    if queue:
                        srcs[b] = queue.pop(0)
                        fresh = TE.batch_init_state(g, prog, [srcs[b]])
                        for r, f in zip(rows, fresh):
                            r[b] = f[0]
            if len(answers) == len(order) or chunks > 500:
                break
            outs, state = TE.run_program_batch(
                g, prog, srcs, max_iter=2, on_nonconverge="ignore",
                init_state=tuple(rows), return_state=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k: ER.LAUNCHES[k] for k in MAIN_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        same = sorted(answers) == sorted(order) and all(
            torch.equal(bits(v), bits(on_cuda(TE.run_program(
                g, prog, engine="cuda", source=s)).value))
            for s, v in answers.items())
        row = {"query": label, "n": g.n, "edges": g.num_edges,
               "slots": BATCH, "queries": len(order), "chunks": chunks,
               "max_iter": 2, "launches": launched, "wall_ms": wall,
               "queries_per_s": len(order) / wall * 1e3,
               "peak_bytes": peak, "card": card,
               "match": "bitwise" if same else "MISMATCH"}
        log("phase 7 " + json.dumps(row))
        phase7_rows.append(row)
        if not same:
            raise RuntimeError(f"phase 7 {label}: a served answer differs "
                               "from its solo query")

    def profile_batch(label, fn):
        """One warm batch under torch.profiler: the device's busy time
        against the wall and the top device kernels, by which a batch's
        time is attributed (kernel events only; the table goes to the
        details directory)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            outs = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        for r in outs:
            on_cuda(r, label)
        ka = prof.key_averages()
        kern = [e for e in ka if e.device_type == DeviceType.CUDA
                and not e.key.startswith("grafs::")]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        summary = {"wall_ms": wall, "device_busy_ms": busy,
                   "idle_share": max(0.0, 1.0 - busy / wall),
                   "iterations": max(r.stats.iterations for r in outs),
                   "top_device_ms": {e.key[:60]: [e.count,
                                                  e.self_device_time_total
                                                  / 1e3] for e in top},
                   "card": card}
        profiles[label] = summary
        log(f"profile {label}: " + json.dumps(summary))
        try:
            out_dir.mkdir(exist_ok=True)
            (out_dir / f"profile_{label.replace(' ', '_')}.txt").write_text(
                ka.table(sort_by="self_device_time_total", row_limit=30))
        except OSError:
            pass

    def phase7_rmat16(g):
        srcs = batch_sources(g, 7)
        for name, model in (("BFS", None), ("SSSP", None), ("WSP", None),
                            ("WP", None), ("SSSP", "pull"),
                            ("SSSP", "push"), ("NSP", None)):
            phase7_case(
                f"{name}{'' if model is None else ' ' + model} rmat16", g,
                lambda ss, name=name, model=model: TE.run_program_batch(
                    g, progs[name], ss, model=model),
                lambda s, name=name, model=model: TE.run_program(
                    g, progs[name], engine="cuda", model=model, source=s),
                srcs)
        phase7_case("handwritten SSSP run_direct rmat16", g,
                    lambda ss: TE.run_direct(g, handwritten["SSSP"],
                                             engine="cuda", sources=ss),
                    lambda s: TE.run_direct(g, handwritten["SSSP"],
                                            engine="cuda", source=s),
                    srcs)
        phase7_continuous("continuous SSSP rmat16", g)
        for name, model in (("BFS", None), ("SSSP", "pull"),
                            ("SSSP", "push")):
            profile_batch(
                f"batch {name}{'' if model is None else ' ' + model} rmat16",
                lambda name=name, model=model: TE.run_program_batch(
                    g, progs[name], srcs, model=model))

    # ------------------------------------------------------------------
    # Phase 8: incremental fixpoints over mutated graphs, through
    # graph.mutate.mutate_edges and the entry points' delta=, while the
    # graphs they need live.  The reference bench's perturbation: seed 7,
    # 0.5 % of |E| random inserts, weights 0.1 + U[0, 1).  Each mutation
    # runs once under torch.profiler (its device time) and once more
    # unprofiled (its wall); the
    # sweep kernels' launch counts are set to 0 just before each query and
    # read just after (none counts for the main path).  Every old graph is
    # dropped before the next mutation.
    # ------------------------------------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.graph import mutate as TM
    phase8_rows = []

    def perturbation(g, seed=INCR_SEED, frac=INCR_FRAC, both=False):
        """``frac`` of |E| seeded random inserts, weights 0.1 + U[0, 1);
        with ``both`` each one in both directions (an undirected graph)."""
        rng = np.random.default_rng(seed)
        k = max(2, int(g.num_edges * frac))
        s, d = rng.integers(0, g.n, size=k), rng.integers(0, g.n, size=k)
        w = (0.1 + rng.random(k)).astype(np.float32)
        if both:
            return np.concatenate([s, d]), np.concatenate([d, s]), \
                np.concatenate([w, w])
        return s, d, w

    def mutation(g, **kw):
        """``mutate_edges(g, **kw)`` twice: once under the profiler, for the
        device's busy time (kernels and copies), its graph dropped at
        once; then unprofiled, for the wall.  (graph, delta, its row part):
        the wall, the device time and the rest, the host's, and the
        profiled call's wall beside them."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gp, _md = TM.mutate_edges(g, **kw)
            torch.cuda.synchronize()
            profiled_wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        drop(gp)
        del gp
        reset_peak()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g2, md = TM.mutate_edges(g, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if g2.device != g.device:
            raise RuntimeError("the mutated graph left the card")
        return g2, md, {
            "n": g2.n, "edges": g2.num_edges, "inserted": md.inserted,
            "deleted": md.deleted, "touched": int(md.touched.size),
            "patched_layouts": md.patched_layouts,
            "rebuilt_layouts": md.rebuilt_layouts, "mutate_ms": wall,
            "mutate_device_ms": busy, "mutate_host_ms": wall - busy,
            "mutate_profiled_ms": profiled_wall}

    def drop(*graphs):
        for gg in graphs:
            TE.clear_graph_caches(gg)
        torch.cuda.empty_cache()

    def program(name):
        """One program's cuda query, with its pull-engine twin."""
        def query(g, **kw):
            return TE.run_program(g, progs[name], engine="cuda", **kw)
        query.pull = lambda g: TE.run_program(g, progs[name], engine="pull")
        return query

    def delta_case(label, g2, md, mrow, query, state, exact=True,
                   expect="delta", canonical=None):
        """The delta query (``init_state=state, delta=md``) on the mutated
        graph against the cold cuda query there: bitwise (``exact``) or
        within atol (PageRank), with the warm one's edge work strictly
        under the cold one's on an insert-only idempotent batch.  The cold
        answer is held against ``canonical()``, the cold query on a
        canonical rebuild, or else against the pull engine: bitwise
        (``exact``) or allclose rtol 1e-5 (PageRank, as in phase 5)."""
        warm, wall, launched = counted(
            lambda: query(g2, init_state=state, delta=md))
        cold, cold_wall, cold_l = counted(lambda: query(g2))
        warm_again = counted(lambda: query(g2, init_state=state,
                                           delta=md))[1]
        cold_again = counted(lambda: query(g2))[1]
        peak = torch.cuda.max_memory_allocated()
        for r in (warm, cold):
            on_cuda(r, f"phase 8 {label}")
        ws, cs = warm.stats, cold.stats
        if exact:
            same = torch.equal(bits(warm.value), bits(cold.value))
            err = 0.0 if same else float("inf")
        else:
            err = float((warm.value.double() - cold.value.double()).abs()
                        .max())
            # PageRank's tol is 1e-4 / n, and both answers lie within a
            # few tol of the fixpoint: held to a hundredth of the mean rank
            same = bool(torch.isfinite(warm.value).all()) and \
                err <= 1e-2 / g2.n and ws.iterations <= cs.iterations
        ref = (canonical() if canonical is not None else query.pull(g2)) \
            .value
        if exact:
            ref_ok = torch.equal(bits(cold.value), bits(ref))
        else:
            ref_ok = torch.allclose(cold.value, ref, rtol=1e-5, atol=1e-8)
        fewer = (not exact or expect != "delta" or md.has_deletes
                 or ws.edge_work < cs.edge_work)
        ok = (same and ref_ok and fewer
              and ws.plan.incremental == expect)
        row = {"query": label, **mrow, "plan": ws.plan.incremental,
               "iterations": ws.iterations, "cold_iterations": cs.iterations,
               "push_iters": ws.push_iters, "cold_push_iters": cs.push_iters,
               "pull_iters": ws.pull_iters, "cold_pull_iters": cs.pull_iters,
               "edge_work": ws.edge_work, "cold_edge_work": cs.edge_work,
               "resolve_work": ws.resolve_work,
               "cold_resolve_work": cs.resolve_work,
               "gather_work": ws.gather_work,
               "cold_gather_work": cs.gather_work,
               "launches": launched, "cold_launches": cold_l,
               "wall_ms": wall, "warm_wall_ms": warm_again,
               "cold_wall_ms": cold_wall, "cold_warm_wall_ms": cold_again,
               "max_abs_err": err, "peak_bytes": peak, "card": card,
               "reference": ("canonical rebuild" if canonical is not None
                             else "pull engine"),
               "match": ("bitwise" if exact else "allclose") if ok
               else "MISMATCH"}
        log("phase 8 " + json.dumps(row))
        phase8_rows.append(row)
        if not ok:
            raise RuntimeError(
                f"phase 8 {label}: plan {ws.plan.incremental!r} (expected "
                f"{expect!r}), answer {'equal' if same else 'differs'}, "
                f"cold against its reference {ref_ok}, edge work "
                f"{ws.edge_work} against cold {cs.edge_work}")
        return cold

    def phase8_rmat16(g):
        """BFS, SSSP and WP over one insert batch, PageRank's rescaled warm
        delta, a chained second mutation, a delete batch (planned "full",
        held against a canonical rebuild) and a forced row overflow (a
        counted rebuild of the in-layout)."""
        n = g.n
        states = {}
        for name in ("BFS", "SSSP", "WP"):
            r, states[name] = program(name)(g, return_state=True)
            on_cuda(r, f"phase 8 {name} before the mutation")
        pr_dk = pagerank_kernels(n, tol=1e-4 / n)

        def pagerank(gg, **kw):
            return TE.run_direct(gg, pr_dk, engine="cuda", **kw)
        pagerank.pull = lambda gg: TE.run_direct(gg, pr_dk, engine="pull")
        pr_prev = on_cuda(pagerank(g)).value
        g2, md, mrow = mutation(g, insert=perturbation(g))
        for name in ("BFS", "SSSP", "WP"):
            delta_case(f"{name} rmat16", g2, md, mrow, program(name),
                       states[name])
        delta_case("PageRank rmat16", g2, md, mrow, pagerank, [pr_prev],
                   exact=False)
        # a second mutation on the mutated graph patches from the recorded
        # slot maps
        _r, st2 = program("BFS")(g2, return_state=True)
        g3, md3, mrow3 = mutation(g2, insert=perturbation(g2, seed=8))
        drop(g2)
        del g2
        delta_case("BFS rmat16 chained", g3, md3, mrow3, program("BFS"), st2)
        drop(g3)
        del g3
        # a delete batch: idempotent rounds plan the cold recompute
        src, dst, _w, _c = g.host_edges()
        gone = np.random.default_rng(INCR_SEED).choice(src.size, 1000,
                                                       replace=False)
        gd, mdd, mrowd = mutation(g, delete=(src[gone], dst[gone]))

        def canonical():
            gc = TS.from_arrays(n, *gd.host_edges(), device=dev)
            r = on_cuda(program("BFS")(gc), "phase 8 canonical rebuild")
            drop(gc)
            return r
        delta_case("BFS rmat16 deletes", gd, mdd, mrowd, program("BFS"),
                   states["BFS"], expect="full", canonical=canonical)
        drop(gd)
        del gd
        # a forced row overflow: the in-row of the vertex of most in-edges
        # takes one insert more than it has free slots
        ein = TS.blocked_ell_cached(g, direction="in")
        eout = TS.blocked_ell_cached(g, direction="out")
        in_deg = g.in_deg.cpu().numpy()
        out_deg = g.out_deg.cpu().numpy()
        hub = int(in_deg.argmax())
        free = ein.width - int(in_deg[hub])
        cand = np.flatnonzero((out_deg < eout.width)
                              & (np.arange(n) != hub))
        srcs = np.random.default_rng(INCR_SEED).choice(cand, free + 1,
                                                       replace=False)
        go, mdo, mrowo = mutation(g, insert=(
            srcs, np.full(free + 1, hub), np.full(free + 1, 0.5,
                                                  np.float32)))
        if (mdo.rebuilt_layouts, mdo.patched_layouts) != (1, 2):
            raise RuntimeError(f"phase 8 overflow: {mdo.rebuilt_layouts} "
                               f"rebuilt, {mdo.patched_layouts} patched "
                               "layouts, expected 1 and 2")
        delta_case("BFS rmat16 overflow", go, mdo, mrowo, program("BFS"),
                   states["BFS"])
        drop(go)
        del go

    def phase8_single(label, g, name, both=False):
        """One idempotent query over the seeded insert batch."""
        r, state = program(name)(g, return_state=True)
        on_cuda(r, f"phase 8 {label} before the mutation")
        g2, md, mrow = mutation(g, insert=perturbation(g, both=both))
        delta_case(label, g2, md, mrow, program(name), state)
        drop(g2)

    # ------------------------------------------------------------------
    # Phase 9: the continuous-batching analytics service
    # (launch/service.py) driven by seeded open-loop traces through its
    # entry points, on the card, while the graphs it needs live.  Every
    # query it runs must stay on the cuda engine with no fallback; the
    # sweep kernels' launch counts are set to 0 just before each trace and
    # read just after (none counts for the main path).
    # ------------------------------------------------------------------
    from repro_torch.launch import service as SV
    phase9_rows = []
    serving_launches = dict.fromkeys(ER.LAUNCHES, 0)
    serving_fields = ("completed", "batch_launches", "queries_per_launch",
                      "occupancy", "scalar_rounds", "scalar_fused",
                      "solo_runs", "total_iterations", "v_p50_ms",
                      "v_p99_ms", "v_qps")
    chunk_log = []             # per batch chunk: host set-up, loop, total
    widest = []                # components of each fused scalar round

    @contextlib.contextmanager
    def serving_watch():
        """Hold every cuda query to its engine, keep the carried lane state
        a card tensor, and time each batch chunk's host set-up (entry of
        run_program_batch to the first sweep of ``_advance_batch``)."""
        real_batch, real_solo = TE.run_program_batch, TE.run_program
        real_adv = KO._advance_batch
        mark = {}

        def batch(*a, **kw):
            mark["t0"] = time.perf_counter()
            outs, state = real_batch(*a, **kw)
            t2 = time.perf_counter()
            for o in outs:
                on_cuda(o, "phase 9 batch chunk")
            if not all(s.device.type == "cuda" for s in state):
                raise RuntimeError("phase 9: the lane state left the card")
            init = kw.get("init_state")
            if init is not None and not all(
                    isinstance(s, torch.Tensor) and s.device.type == "cuda"
                    for s in init):
                raise RuntimeError("phase 9: a chunk's init_state is not a "
                                   "card tensor")
            chunk_log.append({
                "setup_ms": (mark["t1"] - mark["t0"]) * 1e3,
                "loop_ms": (mark["t2"] - mark["t1"]) * 1e3,
                "total_ms": (t2 - mark["t0"]) * 1e3,
                "state_bytes": sum(s.numel() * s.element_size()
                                   for s in state)})
            return outs, state

        def advance(*a, **kw):
            mark["t1"] = time.perf_counter()
            out = real_adv(*a, **kw)
            mark["t2"] = time.perf_counter()
            return out

        def solo(*a, **kw):
            r = real_solo(*a, **kw)
            if kw.get("engine") == "cuda":
                on_cuda(r, "phase 9 query")
                rnd = a[1].rounds[0][1]
                if rnd.multi_out:      # a fused scalar round
                    widest.append(len(rnd.components))
            return r

        TE.run_program_batch, TE.run_program = batch, solo
        KO._advance_batch = advance
        try:
            yield
        finally:
            TE.run_program_batch, TE.run_program = real_batch, real_solo
            KO._advance_batch = real_adv

    def chunk_summary(rows):
        if not rows:
            return {}
        out = {"chunks": len(rows)}
        for key in ("setup_ms", "loop_ms", "total_ms"):
            vals = [r[key] for r in rows]
            out[key] = {"median": statistics.median(vals),
                        "mean": statistics.fmean(vals), "max": max(vals),
                        "sum": sum(vals)}
        out["lane_state_bytes_max"] = max(r["state_bytes"] for r in rows)
        return out

    def serve(label, g, n_req, cfg_kw=None, profiled_run=False):
        """One seeded open-loop MIX trace (standard_mix, seed 0, 16
        arrivals per chunk's virtual time) on a fresh service at
        ``cfg_kw`` (the reference's defaults where absent): its metrics,
        launches, libraries built and their nvcc seconds, chunk set-up,
        lane-state and memo bytes and peak memory.  Under
        ``profiled_run`` the trace runs under torch.profiler."""
        cfg = SV.ServiceConfig(**(cfg_kw or {}))
        svc = SV.AnalyticsService(cfg)
        svc.add_graph(label, g)
        svc.register("BFS", TU.bfs)
        svc.register("SSSP", TU.sssp)
        rate = 16.0 / (cfg.launch_overhead_s
                       + cfg.chunk_iters * cfg.iter_cost_s)
        arrivals = SV.open_loop_arrivals(
            n_req, rate=rate, seed=0,
            make_request=SV.standard_mix(label, g.n))
        built = dict(build.BUILD_SECONDS)
        torch.cuda.empty_cache()
        reset_peak()
        del chunk_log[:], widest[:]
        ER.reset_launches()
        torch.cuda.synchronize()
        prof = None
        with serving_watch():
            if profiled_run:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    m = svc.run_open_loop(arrivals)
                    torch.cuda.synchronize()
            else:
                m = svc.run_open_loop(arrivals)
                torch.cuda.synchronize()
        launched = dict(ER.LAUNCHES)
        for k, v in launched.items():
            serving_launches[k] += v
        new = {k: v for k, v in build.BUILD_SECONDS.items()
               if k not in built}
        row = {"graph": label, "n": g.n, "edges": g.num_edges,
               "requests": n_req, "config": dataclasses.asdict(cfg)
               | {"device": str(cfg.device)},
               "metrics": m, "launches": launched,
               "libraries_built": len(new),
               "nvcc_s": sum(new.values()),
               "wall_less_nvcc_s": m["wall_s"] - sum(new.values()),
               "chunk_host": chunk_summary(chunk_log),
               "scalar_round_components": list(widest),
               **svc.state_bytes(),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "card": card}
        return svc, row, prof

    def verify(svc, row, g, oracle_per_lane=None):
        """verify_sequential (each answer bitwise its solo cuda query,
        the solo walls summed) and every batch-lane and scalar answer (the
        first ``oracle_per_lane`` of each lane, where given) bitwise the
        pull engine's, scalars as float64."""
        walls = {}
        with serving_watch():
            checked = SV.verify_sequential(svc, solo_walls=walls)
        if checked != row["requests"]:
            raise RuntimeError(f"phase 9 {row['graph']}: verify_sequential "
                               f"checked {checked} of {row['requests']}")
        held = {"batch": 0, "scalar": 0}
        for req in svc.completed:
            if req.lane not in held:
                continue
            if oracle_per_lane is not None and \
                    held[req.lane] >= oracle_per_lane:
                continue
            if req.lane == "batch":
                prog = svc._kinds[req.kind][1]
                want = TE.run_program(g, prog, engine="pull",
                                      source=req.source).value
                ok = req.value.tobytes() == want.cpu().numpy().tobytes()
            else:
                want = TE.run_program(g, TF.fuse(req.spec),
                                      engine="pull").value
                ok = np.float64(req.value).tobytes() == \
                    np.float64(float(want)).tobytes()
            if not ok:
                raise RuntimeError(f"phase 9 {row['graph']}: request "
                                   f"{req.rid} ({req.lane}) differs from "
                                   "the pull engine")
            held[req.lane] += 1
        row.update(verified_bitwise=checked, pull_checked=held,
                   solo_wall_s_sum=sum(walls.values()),
                   served_wall_s=row["metrics"]["wall_s"])

    def log9(tag, row):
        log(f"phase 9 {tag} " + json.dumps(row))
        phase9_rows.append(dict(row, tag=tag))

    def phase9_rmxs():
        """The reference bench's serving rows (BENCH_pallas.json
        serving_rows) on rmat_graph(400, 3200, seed=11), unweighted and
        weighted: 6 slots, chunks of 4, 16 requests; every deterministic
        field met exactly."""
        bench_rows = json.loads((ROOT / "BENCH_pallas.json").read_text())[
            "serving_rows"]
        for weighted in (False, True):
            gx9 = TS.rmat_graph(400, 3200, seed=11, weighted=weighted,
                                device=dev)
            label = f"RM-XS {'w' if weighted else 'unw'}"
            svc, row, _ = serve(label, gx9, 16,
                                dict(max_batch=6, chunk_iters=4))
            verify(svc, row, gx9)
            want = [r for r in bench_rows if r["weighted"] == weighted][0]
            got = {k: row["metrics"][k] for k in serving_fields}
            row["bench_row_met"] = got == {k: want[k]
                                           for k in serving_fields}
            log9("RM-XS", row)
            if not row["bench_row_met"]:
                raise RuntimeError(f"phase 9 {label}: {got} against "
                                   f"BENCH_pallas.json {want}")
            TE.clear_graph_caches(gx9)

    def virtual(m):
        return {k: v for k, v in m.items() if not k.startswith("wall")}

    def phase9_rmat16(g):
        """64 requests at the reference service's defaults (cold pass),
        the same trace on a fresh service (warm pass: equal virtual
        metrics) and once more under torch.profiler; then on the first
        service 16 repeats of its batch-lane requests, phase 8's
        perturbation through mutate_graph under them, and a drain: the
        repeats join warm and equal the solo queries on the mutated
        graph."""
        svc1, cold, _ = serve("rmat16", g, 64)
        verify(svc1, cold, g)
        log9("rmat16 cold", cold)
        svc2, warm, _ = serve("rmat16", g, 64)
        verify(svc2, warm, g)
        warm["virtual_equal_cold"] = virtual(warm["metrics"]) == \
            virtual(cold["metrics"])
        log9("rmat16 warm", warm)
        if not warm["virtual_equal_cold"]:
            raise RuntimeError("phase 9 rmat16: the warm pass's virtual "
                               "metrics differ from the cold pass's")
        del svc2
        _svc3, prow, prof = serve("rmat16", g, 64, profiled_run=True)
        ka = prof.key_averages()
        kern = [e for e in ka if e.device_type == DeviceType.CUDA
                and not e.key.startswith("grafs::")]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        wall = prow["metrics"]["wall_s"] * 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        summary = {"wall_ms": wall, "device_busy_ms": busy,
                   "idle_share": max(0.0, 1.0 - busy / wall),
                   "batch_launches": prow["metrics"]["batch_launches"],
                   "scalar_rounds": prow["metrics"]["scalar_rounds"],
                   "chunk_host": prow["chunk_host"],
                   "unprofiled_chunk_host": warm["chunk_host"],
                   "top_device_ms": {e.key[:60]: [e.count,
                                                  e.self_device_time_total
                                                  / 1e3] for e in top},
                   "card": card}
        profiles["serve rmat16"] = summary
        log("profile serve rmat16: " + json.dumps(summary))
        try:
            out_dir.mkdir(exist_ok=True)
            (out_dir / "profile_serve_rmat16.txt").write_text(
                ka.table(sort_by="self_device_time_total", row_limit=30))
        except OSError:
            pass
        del _svc3, prof, ka, kern
        # repeats of served sources queued across an edit of the graph
        repeats = [r for r in svc1.completed if r.lane == "batch"][:16]
        ER.reset_launches()
        t0 = time.perf_counter()
        with serving_watch():
            for i, r in enumerate(repeats):
                svc1.submit("rmat16", SV.Request(rid=1000 + i, kind=r.kind,
                                                 source=r.source))
            tm = time.perf_counter()
            md = svc1.mutate_graph("rmat16", insert=perturbation(g))
            torch.cuda.synchronize()
            mutate_ms = (time.perf_counter() - tm) * 1e3
            while svc1.step():
                pass
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = dict(ER.LAUNCHES)
        for k, v in launched.items():
            serving_launches[k] += v
        g2 = svc1.graphs["rmat16"]
        after = [r for r in svc1.completed if r.rid >= 1000]
        same = len(after) == len(repeats) and all(
            r.value.tobytes() == on_cuda(TE.run_program(
                g2, svc1._kinds[r.kind][1], engine="cuda",
                source=r.source)).value.cpu().numpy().tobytes()
            for r in after)
        m = svc1.metrics()
        row = {"graph": "rmat16", "repeats": len(repeats),
               "inserted": md.inserted,
               "patched_layouts": md.patched_layouts,
               "rebuilt_layouts": md.rebuilt_layouts,
               "warm_joins": m["warm_joins"],
               "drain_launches": m["drain_launches"],
               "batch_launches_after": m["batch_launches"]
               - cold["metrics"]["batch_launches"],
               "mutate_ms": mutate_ms, "wall_ms": wall,
               "launches": launched, **svc1.state_bytes(),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "card": card, "match": "bitwise" if same else "MISMATCH"}
        log9("rmat16 mutate", row)
        if not same or m["warm_joins"] < 1:
            raise RuntimeError(f"phase 9 rmat16 mutation: answers "
                               f"{'equal' if same else 'differ'}, warm "
                               f"joins {m['warm_joins']}")
        TE.clear_graph_caches(g2)
        del svc1, g2
        torch.cuda.empty_cache()

    def phase9_uniform21(g):
        """32 requests at the reference service's defaults; the first 4
        answers of each lane held against the pull engine."""
        svc, row, _ = serve("uniform21", g, 32)
        verify(svc, row, g, oracle_per_lane=4)
        row["max_scalar_fuse_cut"] = None
        log9("uniform21", row)
        del svc
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # Phase 10: the sharded engines, k = 4 vertex-cut shards of one graph
    # on the card (``ShardMesh.on(dev, 4)``), each shard sweeping its own
    # widened layouts with the same pull, push and resolve kernels, their
    # partials folded across the shards.  Each query is held against its
    # single-device cuda answer, computed first; then that graph's caches
    # are dropped and the sharded layouts built, one strategy at a time
    # (rmat16's take ≈ 43 GB, its closure's ≈ 67 GB).  The sweep kernels'
    # launch counts are set to 0 just before each query and read just
    # after (none counts for the main path).
    # ------------------------------------------------------------------
    phase10_rows = []

    def p10_query(g, name):
        """``make(**engine_kwargs)`` of one phase-10 query on ``g`` and
        whether its round is idempotent (held bitwise)."""
        n = g.n
        if name == "PageRank":
            return (lambda **kw: TE.run_direct(
                g, pagerank_kernels(n, tol=1e-4 / n), **kw)), False
        if name == "WPR push":
            return (lambda **kw: TE.run_direct(
                g, weighted_pagerank_kernels(n, tol=1e-4 / n),
                model="push", **kw)), False
        if name in ("BFS pull", "BFS push"):
            model = name.split()[1]
            return (lambda **kw: TE.run_program(g, progs["BFS"],
                                                model=model, **kw)), True
        return (lambda **kw: TE.run_program(g, progs[name], **kw)), True

    def p10_single(g, names):
        """The single-device cuda answers: name → (result, launches, first
        and warm wall ms)."""
        out = {}
        for name in names:
            make, _ = p10_query(g, name)
            r, wall, launched = counted(lambda: make(engine="cuda"))
            on_cuda(r, f"phase 10 single-device {name}")
            out[name] = (r, launched, wall,
                         counted(lambda: make(engine="cuda"))[1])
        return out

    def p10_case(graph, name, make, exact, single, mesh, strategy, setup):
        """One sharded query against its single-device answer: bits (or
        allclose rtol 1e-5 with both iteration counts), iterations and push
        iterations, launches k × the single device's (each kernel once per
        shard per iteration of its direction), on the card."""
        k = mesh.device_count
        kw = dict(engine="cuda_sharded", mesh=mesh, shard_strategy=strategy)
        r, wall, launched = counted(lambda: make(**kw))
        warm = counted(lambda: make(**kw))[1]
        one, one_l, one_wall, one_warm = single
        st = r.stats
        if exact:
            ok = torch.equal(bits(r.value), bits(one.value)) and \
                (st.iterations, st.push_iters) == \
                (one.stats.iterations, one.stats.push_iters)
        else:
            ok = bool(torch.isfinite(r.value).all()) and torch.allclose(
                r.value, one.value, rtol=1e-5, atol=1e-8)
        want_l = {"pull": k * st.pull_iters, "push": k * st.push_iters,
                  "resolve": k * st.push_iters}
        scaled = {kn: k * v for kn, v in one_l.items()}
        row = {"graph": graph, "query": name, "strategy": strategy,
               "shards": k, "match": ("bitwise" if exact else "allclose")
               if ok else "MISMATCH",
               "iterations": st.iterations, "push_iters": st.push_iters,
               "single_iterations": one.stats.iterations,
               "single_push_iters": one.stats.push_iters,
               "shard_work": list(st.shard_work), "edge_work": st.edge_work,
               "single_edge_work": one.stats.edge_work,
               "resolve_work": st.resolve_work,
               "cross_combines": st.cross_combines,
               "launches": launched, "single_launches_x_k": scaled,
               **setup, "wall_ms": wall, "warm_wall_ms": warm,
               "single_wall_ms": one_wall, "single_warm_wall_ms": one_warm,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log("phase 10 " + json.dumps(row))
        phase10_rows.append(row)
        if not ok:
            raise RuntimeError(f"phase 10 {graph} {name} ({strategy}): the "
                               "sharded answer differs from the "
                               "single-device one")
        if (st.engine_used != "cuda_sharded" or st.fallbacks != ()
                or st.shards != k or r.value.device.type != "cuda"):
            raise RuntimeError(f"phase 10 {graph} {name}: ran on "
                               f"{st.engine_used!r} ({st.fallbacks}) with "
                               f"{st.shards} shards on {r.value.device}")
        if launched != want_l or (exact and launched != scaled) or \
                not sum(launched.values()):
            raise RuntimeError(f"phase 10 {graph} {name}: launches "
                               f"{launched}, expected {want_l} (single "
                               f"device × {k}: {scaled})")

    def p10_drop(g):
        """Drop ``g``'s cached layouts (and whatever a collected cycle
        held) and return the device memory still allocated, GB."""
        TE.clear_graph_caches(g)
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated() / 1e9

    def p10_setup(g, k, strategy, mesh):
        """The sharded set-up of one strategy, timed in parts (validation
        first, which dropping the graph's caches dropped too), its layout
        bytes and the peak device memory while it built."""
        parts, held = {}, []
        for what, fn in (
                ("validate", lambda: TS.validate_graph(g)),
                ("ell_in", lambda: TS.sharded_ell_cached(
                    g, k, strategy, direction="in", devices=mesh.devices)),
                ("ell_out", lambda: TS.sharded_ell_cached(
                    g, k, strategy, direction="out", devices=mesh.devices)),
                ("resolution", lambda: TS.sharded_push_resolution_cached(
                    g, k, strategy, devices=mesh.devices))):
            t0 = time.perf_counter()
            held.append(fn())
            torch.cuda.synchronize()
            parts[what] = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for lay in held[1:]
                     for shard in lay.shards
                     for t in (getattr(shard, f.name)
                               for f in dataclasses.fields(shard))
                     if isinstance(t, torch.Tensor))
        return {"setup_s": parts, "layouts_gb": nbytes / 1e9,
                "setup_peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    def phase10_graph(graph, g, names, strategies, k=4):
        """Single-device answers of ``names`` first; then per strategy the
        sharded layouts (timed set-up, on a freed card) and the sharded
        queries; the graph's caches dropped after each."""
        single = p10_single(g, names)
        mesh = ShardMesh.on(dev, k)
        for strategy in strategies:
            resident = p10_drop(g)
            reset_peak()
            setup = dict(p10_setup(g, k, strategy, mesh),
                         resident_gb=resident)
            for name in names:
                make, exact = p10_query(g, name)
                p10_case(graph, name, make, exact, single[name], mesh,
                         strategy, setup)
        p10_drop(g)

    def phase10_rmat16(g):
        phase10_graph("rmat16", g, ("BFS", "SSSP", "WSP", "WP", "BFS pull",
                                    "BFS push", "PageRank", "WPR push"),
                      ("contiguous", "dst_hash"))
        # the distributed engine (segment ops per shard) against pull
        mesh = ShardMesh.on(dev, 4)
        ref, ref_wall = timed(lambda: TE.run_program(g, progs["BFS"],
                                                     engine="pull"))
        r, wall = timed(lambda: TE.run_program(g, progs["BFS"],
                                               engine="distributed",
                                               mesh=mesh))
        ok = torch.equal(r.value, ref.value) and \
            r.stats.iterations == ref.stats.iterations
        row = {"graph": "rmat16", "query": "BFS", "engine": "distributed",
               "shards": 4, "match": "bitwise" if ok else "MISMATCH",
               "iterations": r.stats.iterations,
               "pull_iterations": ref.stats.iterations,
               "shard_work": list(r.stats.shard_work),
               "edge_work": r.stats.edge_work,
               "pull_edge_work": ref.stats.edge_work, "wall_ms": wall,
               "pull_wall_ms": ref_wall,
               "on_card": r.value.device.type == "cuda"}
        log("phase 10 " + json.dumps(row))
        phase10_rows.append(row)
        if not ok or not row["on_card"]:
            raise RuntimeError("phase 10: distributed BFS rmat16 differs "
                               "from the pull engine")
        # k > |E|: two of five shards hold no edge
        gl4 = TS.line_graph(4, device=dev)
        for name in ("BFS", "BFS pull", "BFS push"):
            make, exact = p10_query(gl4, name)
            p10_case("line_graph(4)", name, make, exact,
                     p10_single(gl4, (name,))[name], ShardMesh.on(dev, 5),
                     "contiguous", {})
        if sorted(phase10_rows[-1]["shard_work"])[:2] != [0, 0]:
            raise RuntimeError("phase 10: line_graph(4) at k = 5 has no "
                               "empty shard")
        del gl4

    setup("rmat16", g16)
    ER.reset_launches()
    for name in ("BFS", "SSSP", "WSP"):
        run(f"{name} rmat16", g16,
            lambda: TE.run_program(g16, progs[name], engine="cuda"),
            lambda: TE.run_program(g16, progs[name], engine="pull"), True)
    # PageRank's tolerance scales with the mean rank 1/n (the default
    # absolute 1e-6 exceeds the whole mean rank of a 2-million-vertex graph)
    n = g16.n
    run("PageRank rmat16", g16,
        lambda: TE.run_direct(g16, pagerank_kernels(n, tol=1e-4 / n),
                              engine="cuda"),
        lambda: TE.run_direct(g16, pagerank_kernels(n, tol=1e-4 / n),
                              engine="pull"), False)
    run("weighted PageRank push rmat16", g16,
        lambda: TE.run_direct(g16, weighted_pagerank_kernels(n, tol=1e-4 / n),
                              engine="cuda", model="push"),
        lambda: TE.run_direct(g16, weighted_pagerank_kernels(n, tol=1e-4 / n),
                              engine="pull"), False)
    # the pull tile activity lives in the pull kernel: no torch gather over
    # the in-layout rectangle is left in the pull step
    profiled("BFS rmat16",
             lambda: TE.run_program(g16, progs["BFS"], engine="cuda"),
             no_gather_per="pull")
    # the push− has-pred probe lives in the resolve kernel: no torch
    # gather over the in-layout rectangle is left in the iteration
    profiled("weighted PageRank push rmat16",
             lambda: TE.run_direct(g16, weighted_pagerank_kernels(
                 n, tol=1e-4 / n), engine="cuda", model="push"),
             no_gather_per="iteration")
    add_launches()
    t5 = time.perf_counter()
    phase5_rmat16(g16)
    phase5_s = time.perf_counter() - t5
    t6 = time.perf_counter()
    phase6_rmat16(g16)
    phase6_s = time.perf_counter() - t6
    t7 = time.perf_counter()
    phase7_rmat16(g16)
    phase7_s = time.perf_counter() - t7
    t8 = time.perf_counter()
    phase8_rmat16(g16)
    phase8_s = time.perf_counter() - t8
    t9 = time.perf_counter()
    phase9_rmxs()
    phase9_rmat16(g16)
    phase9_s = time.perf_counter() - t9
    t10 = time.perf_counter()
    phase10_rmat16(g16)
    phase10_s = time.perf_counter() - t10
    gu16 = TS.undirected(g16)
    TE.clear_graph_caches(g16)
    torch.cuda.empty_cache()
    setup("undirected rmat16", gu16)
    ER.reset_launches()
    run("CC undirected(rmat16)", gu16,
        lambda: TE.run_program(gu16, progs["CC"], engine="cuda"),
        lambda: TE.run_program(gu16, progs["CC"], engine="pull"), True)
    add_launches()
    t5 = time.perf_counter()
    phase5_undirected(gu16)
    phase5_s += time.perf_counter() - t5
    t8 = time.perf_counter()
    phase8_single("CC undirected(rmat16)", gu16, "CC", both=True)
    phase8_s += time.perf_counter() - t8
    t10 = time.perf_counter()
    phase10_graph("undirected rmat16", gu16, ("CC",),
                  ("contiguous", "dst_hash"))
    phase10_s += time.perf_counter() - t10
    del gu16, g16
    TE.clear_program_caches()
    torch.cuda.empty_cache()
    nu, eu = 2 ** 21, 2 ** 25
    t0 = time.perf_counter()
    gu = TS.uniform_graph(nu, eu, seed=21, device=dev)
    log(f"graph uniform_graph({nu}, {eu}, seed=21): {gu.num_edges} edges "
        f"in {time.perf_counter() - t0:.1f} s")
    setup("uniform21", gu)
    # the kernels against their plain versions at this graph's shapes,
    # outside the main path's launch counts
    kernel_cases("uniform21", gu, ("BFS", "PR", "WPR"), 10, 1)
    torch.cuda.empty_cache()
    kernel_cases("uniform21", gu, ("BFS", "WPR"), 5, 1, batched=True)
    torch.cuda.empty_cache()
    ER.reset_launches()
    run("BFS uniform21", gu,
        lambda: TE.run_program(gu, progs["BFS"], engine="cuda"),
        lambda: TE.run_program(gu, progs["BFS"], engine="pull"), True)
    run("PageRank uniform21", gu,
        lambda: TE.run_direct(gu, pagerank_kernels(gu.n, tol=1e-4 / gu.n),
                              engine="cuda"),
        lambda: TE.run_direct(gu, pagerank_kernels(gu.n, tol=1e-4 / gu.n),
                              engine="pull"), False)
    profiled("BFS uniform21",
             lambda: TE.run_program(gu, progs["BFS"], engine="cuda"),
             no_gather_per="pull")
    add_launches()
    launches = main_launches
    log(f"main-path launches: {json.dumps(launches)}")
    for kname, cnt in launches.items():
        if cnt <= 0:
            raise RuntimeError(f"the {kname} kernel never launched on the "
                               "main path")
    t5 = time.perf_counter()
    adaptive_query("BFS uniform21", lambda eng: TE.run_program(
        gu, progs["BFS"], engine=eng), True)
    phase5_s += time.perf_counter() - t5
    t6 = time.perf_counter()
    with timed_io():
        phase6_case("BFS uniform21", gu, program_query(gu, "BFS"), 2)
    shutil.rmtree(ckpt_root)
    phase6_s += time.perf_counter() - t6
    log(f"phase 6: {phase6_s:.1f} s")
    record["phase6"] = phase6_rows
    record["phase6_s"] = phase6_s
    t7 = time.perf_counter()
    phase7_case("BFS uniform21", gu,
                lambda ss: TE.run_program_batch(gu, progs["BFS"], ss),
                lambda s: TE.run_program(gu, progs["BFS"], engine="cuda",
                                         source=s),
                batch_sources(gu, 21))
    profile_batch("batch BFS uniform21", lambda: TE.run_program_batch(
        gu, progs["BFS"], batch_sources(gu, 21)))
    phase7_s += time.perf_counter() - t7
    log(f"phase 7: {phase7_s:.1f} s")
    record["phase7"] = phase7_rows
    record["phase7_s"] = phase7_s
    t9 = time.perf_counter()
    phase9_uniform21(gu)
    phase9_s += time.perf_counter() - t9
    log(f"phase 9: {phase9_s:.1f} s, launches {json.dumps(serving_launches)}")
    for kname in MAIN_KERNELS:
        if serving_launches[kname] <= 0:
            raise RuntimeError(f"the {kname} kernel never launched in "
                               "phase 9's serving traces")
    record["phase9"] = phase9_rows
    record["phase9_s"] = phase9_s
    record["serving_launches"] = serving_launches
    t8 = time.perf_counter()
    phase8_single("BFS uniform21", gu, "BFS")
    phase8_s += time.perf_counter() - t8
    log(f"phase 8: {phase8_s:.1f} s")
    record["phase8"] = phase8_rows
    record["phase8_s"] = phase8_s
    t10 = time.perf_counter()
    phase10_graph("uniform21", gu, ("BFS", "PageRank"), ("contiguous",))
    phase10_s += time.perf_counter() - t10
    log(f"phase 10: {phase10_s:.1f} s")
    record["phase10"] = phase10_rows
    record["phase10_s"] = phase10_s
    level_cases("uniform21", gu, ("int n+1",))
    softmax_case("uniform21 in-layout", gu)
    del gu
    TE.clear_program_caches()
    torch.cuda.empty_cache()
    t5 = time.perf_counter()
    phase5_dense()
    phase5_s += time.perf_counter() - t5
    log(f"phase 5: {phase5_s:.1f} s")
    record["phase5"] = phase5_rows
    record["phase5_references"] = phase5_refs
    record["phase5_s"] = phase5_s
    record["handwritten_launches"] = hw_launches

    # ------------------------------------------------------------------
    # Phase 4 (continued): the embedding bag and flash attention.
    # ------------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(40)
    table = torch.randn((RM2_VOCAB, RM2_DIM), generator=gen, device=dev)
    tables = {"float32": table, "bfloat16": table.to(torch.bfloat16)}
    rng = np.random.default_rng(41)
    host_idx = {k: rng.integers(0, RM2_VOCAB, (RM2_BAGS, k)).astype(np.int32)
                for k in (1, 8)}
    bag_idx = {k: torch.from_numpy(a).to(dev) for k, a in host_idx.items()}
    rows_read = {k: int(np.unique(a).size) for k, a in host_idx.items()}
    bag_w = torch.from_numpy(rng.normal(size=(RM2_BAGS, 8))
                             .astype(np.float32)).to(dev)
    for k, mode, weighted, tname in ((1, "sum", False, "float32"),
                                     (1, "mean", False, "float32"),
                                     (8, "sum", False, "float32"),
                                     (8, "mean", False, "float32"),
                                     (8, "sum", True, "float32"),
                                     (8, "mean", True, "float32"),
                                     (8, "sum", False, "bfloat16")):
        tab, idx = tables[tname], bag_idx[k]
        w = bag_w if weighted else None
        elem = tab.element_size()
        nbytes = (rows_read[k] * RM2_DIM * elem
                  + idx.numel() * 4 + (w.numel() * 4 if weighted else 0)
                  + RM2_BAGS * RM2_DIM * elem)
        # F.embedding_bag takes per-sample weights in sum mode only
        lib = None if weighted and mode == "mean" else (
            lambda tab=tab, idx=idx, w=w, mode=mode: F.embedding_bag(
                idx, tab, mode=mode, per_sample_weights=w))
        entry_case("bag", f"{tname} table K={k} {mode}"
                   + (" weighted" if weighted else ""),
                   lambda tab=tab, idx=idx, w=w, mode=mode: KO.embedding_bag(
                       tab, idx, weights=w, mode=mode),
                   lambda tab=tab, idx=idx, w=w, mode=mode: EB._bag_plain(
                       tab, idx, w, mode),
                   None, nbytes, library=lib, reps=20, plain_reps=3,
                   detail={"path": "vector" if EB.vector_width(tab) > 1
                           else "scalar",
                           "vector_width": EB.vector_width(tab)})
    del table, tables, bag_idx, bag_w
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(50)
    for kname, dtype in (("flash_sm90", torch.bfloat16),
                         ("flash_f32", torch.float32)):
        attrs = {f"D={d}": FA.kernel_attributes(dtype, d)
                 for d in (16, 32, 64, 128)}
        log(f"{kname} compiled: {json.dumps(attrs)}")
        record[f"{kname}_attributes"] = attrs
    for s_len, chunk, dtype in ((4096, None, torch.bfloat16),
                                (4096, 1024, torch.bfloat16),
                                (1024, None, torch.float32),
                                (4096, None, torch.float32),
                                (4096, 1024, torch.float32)):
        q = torch.randn((1, LLAMA_HEADS, s_len, LLAMA_DHEAD), generator=gen,
                        device=dev).to(dtype)
        k, v = (torch.randn((1, LLAMA_KV_HEADS, s_len, LLAMA_DHEAD),
                            generator=gen, device=dev).to(dtype)
                for _ in range(2))
        vis = FA.attention_mask(s_len, s_len, True, chunk, dev)
        pairs = int(vis.sum())
        ops = 4.0 * LLAMA_HEADS * pairs * LLAMA_DHEAD
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        if chunk is None:
            lib = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        else:
            lib = (lambda q=q, k=k, v=v, vis=vis:
                   F.scaled_dot_product_attention(q, k, v, attn_mask=vis,
                                                  enable_gqa=True))
        tname = str(dtype).removeprefix("torch.")
        label = (f"llama3.2-3B {tname} S=T={s_len} causal"
                 + (f" chunk={chunk}" if chunk else ""))
        drive = (lambda q=q, k=k, v=v, chunk=chunk: FA.flash_attention(
            q, k, v, causal=True, chunk=chunk))
        # float32 runs three TF32 products per product: its bound charges
        # them at the TF32 rate, the CUDA cores' bound beside it
        f32 = dtype == torch.float32
        kname = "flash_f32" if f32 else "flash_sm90"
        case = entry_case(
            kname, label, drive,
            lambda q=q, k=k, v=v, chunk=chunk: FA._flash_plain(
                q, k, v, True, chunk),
            FLASH_TOL[tname], nbytes, 3 * ops if f32 else ops,
            PEAK_FLOPS["tf32" if f32 else tname], library=lib, reps=10,
            plain_reps=2,
            detail={"cuda_core_bound_ms": ops / PEAK_FLOPS["float32"] * 1e3}
            if f32 else None)
        if f32:
            # the same output against the plain version in float64, the
            # function's value (float32's own rounding in the plain version
            # is of the limit's order where the softmax is peaked)
            got = drive()
            want = FA._flash_plain(q.double(), k.double(), v.double(), True,
                                   chunk)
            worst, err, _ = limit_share(got, want, FLASH_TOL[tname])
            if not worst <= 1.0:
                raise RuntimeError(f"flash_f32 {label}: {worst} times its "
                                   f"limit against float64")
            case.update(worst_over_limit_vs_float64=worst,
                        max_abs_err_vs_float64=err)
            log(f"flash_f32 float64 check {label}: max |Δ| {err}, "
                f"{worst} of the limit")
            del got, want
        del q, k, v, vis
    # The float32 limit at a peaked softmax: the `gpu` tests' case q × 8,
    # D = 128 (B 2, H 4, Hkv 2, S = T = 256, causal, numpy seed 2176).
    # There the plain version's own float32 products are off its float64
    # value by about the limit, so the kernel is held to the float64 one.
    rng = np.random.default_rng(256 + 7 * 256 + 128)
    q, k, v = (torch.from_numpy((rng.normal(size=(2, hh, 256, 128)) * sc)
                                .astype(np.float32)).to(dev)
               for hh, sc in ((4, 8.0), (2, 1.0), (2, 1.0)))
    got = FA.flash_attention(q, k, v, causal=True)
    plain = FA._flash_plain(q, k, v, True, None)
    exact = FA._flash_plain(q.double(), k.double(), v.double(), True, None)
    peaked = {name: limit_share(a, b, FLASH_TOL["float32"])[0]
              for name, a, b in (("kernel_vs_float64", got, exact),
                                 ("plain_vs_float64", plain, exact),
                                 ("kernel_vs_plain", got, plain))}
    log(f"flash_f32 peaked softmax, shares of the limit: "
        f"{json.dumps(peaked)}")
    if not peaked["kernel_vs_float64"] <= 1.0:
        raise RuntimeError(f"flash_f32 peaked case: {peaked}")
    record["flash_f32_peaked"] = peaked
    del q, k, v, got, plain, exact
    log(f"phase-4 launches: {json.dumps(phase_launches)}")
    record["entry_cases"] = entry_cases
    record["phase_launches"] = phase_launches
    record["queries"] = queries
    record["launches"] = launches
    record["profiles"] = profiles
    record["peak_mem_gb"] = max(record["peak_before_dense_bytes"],
                                torch.cuda.max_memory_allocated()) / 1e9

    # ------------------------------------------------------------------
    # Phase 11: the analytics dry-run at ogb_products scale
    # (``launch/analytics_dryrun.py``).  Both production meshes' records,
    # built on ``meta`` with the card's allocated memory unchanged around
    # each; then the very step run for real on one uniform graph of
    # ogb_products' n and e: WSP from vertex 0 through the single-device
    # cuda engine (its sweep launches counted) and the pull engine, the
    # graph's layouts dropped, and the step over the 256- and 512-shard
    # meshes on the one card, each bitwise both answers with equal
    # iterations.
    # ------------------------------------------------------------------
    from repro_torch.graph.partition import partition_edges
    from repro_torch.launch import analytics_dryrun as AD
    from repro_torch.launch.dryrun import _mesh_tag
    from repro_torch.launch.mesh import make_production_mesh
    p11_n, p11_e = AD.OGB_N, AD.OGB_E
    phase11_rows = []
    t11 = time.perf_counter()

    def log11(tag, row):
        log(f"phase 11 {tag} " + json.dumps(row))
        phase11_rows.append(dict(row, line=tag))

    def p11_record(multi_pod, e):
        """The dry-run record of one production mesh at (p11_n, e), built
        on ``meta``: it must leave the card's allocated memory as it
        was."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        rec = AD.build_record(make_production_mesh(multi_pod=multi_pod,
                                                   device="meta"),
                              p11_n, e, _mesh_tag(multi_pod))
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        log11("record", dict(rec, allocated_before=before,
                             allocated_after=after))
        if after != before:
            raise RuntimeError(f"phase 11: building the {rec['mesh']} "
                               f"record allocated {after - before} bytes "
                               "on the card")
        return rec

    def p11_profile(label, fn):
        """One more run of ``fn`` under torch.profiler: device busy time
        against the wall, and the top device ops."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
        row = {"wall_ms": wall, "device_busy_ms": busy,
               "idle_share": max(0.0, 1.0 - busy / wall),
               "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                                 for e in top}}
        profiles[label] = row
        log11("profile", dict(row, label=label))

    for multi_pod in (False, True):
        p11_record(multi_pod, p11_e)
    t0 = time.perf_counter()
    g11 = TS.uniform_graph(p11_n, p11_e, seed=OGB_SEED, device=dev)
    e11 = g11.num_edges
    build_s = time.perf_counter() - t0
    reset_peak()
    setup("ogb_products uniform", g11)
    (one, one_state), one_wall, one_l = counted(lambda: TE.run_program(
        g11, progs["WSP"], engine="cuda", return_state=True))
    on_cuda(one, "phase 11 cuda WSP")
    one_warm = timed(lambda: TE.run_program(g11, progs["WSP"],
                                            engine="cuda"))[1]
    pull, pull_wall = timed(lambda: TE.run_program(g11, progs["WSP"],
                                                   engine="pull"))
    row = {"graph": f"uniform_graph({p11_n}, {p11_e}, seed={OGB_SEED})",
           "n": p11_n, "e": e11, "graph_build_s": build_s,
           "iterations": one.stats.iterations,
           "push_iters": one.stats.push_iters,
           "edge_work": one.stats.edge_work, "launches": one_l,
           "wall_ms": one_wall, "warm_wall_ms": one_warm,
           "pull_iterations": pull.stats.iterations,
           "pull_edge_work": pull.stats.edge_work, "pull_wall_ms": pull_wall,
           "pull_match": torch.equal(bits(one.value), bits(pull.value)),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log11("single", row)
    if not row["pull_match"] or one.stats.iterations != \
            pull.stats.iterations:
        raise RuntimeError("phase 11: the cuda WSP answer differs from the "
                           "pull engine's")
    if not all(v > 0 for v in one_l.values()):
        raise RuntimeError(f"phase 11: the cuda WSP query launched {one_l}")
    p10_drop(g11)
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec = p11_record(multi_pod, e11)
        k = mesh.device_count
        part = partition_edges(g11, k)
        flat = [getattr(part, f).reshape(-1) for f in
                ("src", "dst", "weight", "capacity", "mask")]
        fn, _ = AD.build_step(mesh, p11_n, e11)
        # the state component the query answers with (WSP's capacity)
        answer = [cr.idx for cr in fn.comps].index(
            TF.plan_output(fn.plans[0]))
        # the record's per-device argument bytes are shard 0's real inputs
        args = dict(zip(AD.ARG_NAMES, (*flat, g11.out_deg)))
        shard0 = sum((a if name == "out_deg" else a[:fn.e_loc]).nbytes
                     for name, a in args.items() if name in fn.reads())
        reset_peak()
        work = []
        (state, it), wall = timed(lambda: fn(*flat, g11.out_deg,
                                             shard_work=work))
        row = {"mesh": rec["mesh"], "shards": k, "n": p11_n, "e": e11,
               "e_loc": fn.e_loc, "iterations": it,
               "cuda_iterations": one.stats.iterations,
               "pull_iterations": pull.stats.iterations,
               "match_cuda": all(torch.equal(bits(a), bits(b))
                                 for a, b in zip(state, one_state)),
               "match_pull": torch.equal(bits(state[answer]),
                                         bits(pull.value)),
               "on_card": all(s.device.type == "cuda" for s in state),
               "wall_ms": wall, "ms_per_iteration": wall / max(it, 1),
               "shard_work_min": min(work), "shard_work_max": max(work),
               "edge_work": sum(work), "pull_edge_work": pull.stats.edge_work,
               "argument_bytes_per_shard": shard0,
               "record_argument_bytes":
                   rec["memory_analysis"]["argument_size_in_bytes"],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "phase_s": time.perf_counter() - t11}
        log11("sharded", row)
        if not (row["match_cuda"] and row["match_pull"] and row["on_card"]
                and it == one.stats.iterations == pull.stats.iterations):
            raise RuntimeError(f"phase 11 {rec['mesh']}: the {k}-shard step "
                               "differs from the single-device cuda and "
                               "pull answers")
        if shard0 != row["record_argument_bytes"]:
            raise RuntimeError(f"phase 11 {rec['mesh']}: shard 0 reads "
                               f"{shard0} bytes, the record says "
                               f"{row['record_argument_bytes']}")
        if k == 256:
            p11_profile(f"dry-run step {k} shards",
                        lambda: fn(*flat, g11.out_deg))
        del part, flat, args, state, fn
        gc.collect()
        torch.cuda.empty_cache()
    # phase 13's GNNs run on the same edges, in their dst-sorted order
    p13_src, p13_dst = (a.cpu().numpy() for a in (g11.by_dst.src,
                                                   g11.by_dst.dst))
    del g11, one, one_state, pull
    TE.clear_program_caches()
    torch.cuda.empty_cache()
    phase11_s = time.perf_counter() - t11
    log(f"phase 11: {phase11_s:.1f} s, cuda WSP launches "
        f"{json.dumps(one_l)}")
    record["phase11"] = phase11_rows
    record["phase11_s"] = phase11_s
    record["phase11_launches"] = one_l

    # ------------------------------------------------------------------
    # Phase 12: the LM serving path (``models/``, ``launch/serve.py``) at
    # full width.  (a) llama3.2-3B through ``serve.generate`` at the
    # reference serve driver's defaults and at batch 8, prompt 512, each
    # cold and warm in bfloat16, then (the same weights cast) in float32
    # and float64; prefill held against ``forward`` in every dtype, decode
    # against ``forward`` in float64 and recorded in the others beside
    # the network's own sensitivity.  (b) deepseek-v3 at full width,
    # depth 4 (its 3 dense layers, the first MoE layer, the MTP head):
    # generate, the MoE layer's routing, MLA's absorbed decode against the
    # expanded one (each layer's context in bfloat16, the logits in
    # float32), the loss with its MTP term.  (c) ``flash_sm90_kernel`` on
    # (a)'s layer-0 prefill q, k, v against the LM's own attention.
    # ------------------------------------------------------------------
    import repro_torch.configs as LMC
    from repro_torch.launch import serve as SV
    from repro_torch.models import layers as LL
    from repro_torch.models import transformer as LT
    phase12_rows = []
    t12 = time.perf_counter()

    def log12(tag, row):
        log(f"phase 12 {tag} " + json.dumps(row))
        phase12_rows.append(dict(row, line=tag))

    def lm_err(got, want, tol=LM_TOL):
        """max |Δ| and its worst share of the limit atol + rtol·|want| for
        ``tol`` = (rtol, atol), in float64; non-finite values fail."""
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError("phase 12: non-finite logits")
        rtol, atol = tol
        diff = (got.double() - want.double()).abs()
        return float(diff.max()), float(
            (diff / (atol + rtol * want.double().abs())).max())

    def tensor_gb(tensors):
        return sum(t.numel() * t.element_size() for t in tensors) / 1e9

    def lm_prompts(vocab, batch, prompt, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, vocab, (batch, prompt), generator=gen,
                             device=dev)

    def serve_run(model, label, batch, prompt, steps, seed, runs=2):
        """``serve.generate`` ``runs`` times on one seeded prompt set (the
        first run cold, all with equal ids), then the last run's prefill
        logits against ``forward`` at the prompt's last position and its
        last decode step against ``forward`` over the prompt and the ids
        it fed back."""
        prompts = lm_prompts(model.cfg.vocab, batch, prompt, seed)
        max_seq = 1 << (prompt + steps - 1).bit_length()   # pow2 cache
        walls, ids = [], []
        for _ in range(runs):
            cache = model.init_cache(batch, max_seq)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = SV.generate(model, prompts, steps, cache)
            walls.append((res.prefill_s * 1e3, res.decode_s * 1e3))
            peak = torch.cuda.max_memory_allocated()
            ids.append(res.ids)
        if not all(torch.equal(i, ids[0]) for i in ids):
            raise RuntimeError(f"phase 12 {label}: a warm run's ids differ "
                               "from the cold run's")
        if res.ids.shape != (batch, steps) or res.ids.device.type != "cuda":
            raise RuntimeError(f"phase 12 {label}: ids {res.ids.shape} on "
                               f"{res.ids.device}")
        with torch.no_grad():
            full, _, _ = model(prompts)
            pf = lm_err(res.prefill_logits, full[:, -1])
            del full
            full, _, _ = model(torch.cat([prompts, res.ids[:, :-1]], dim=1))
            dc = lm_err(res.logits, full[:, -1])
            del full
        prefill_ms, decode_ms = walls[-1]
        per_step = max(steps - 1, 1)
        row = {"model": model.cfg.name, "layers": model.cfg.n_layers,
               "dtype": model.cfg.dtype, "case": label, "batch": batch,
               "prompt": prompt, "decode_steps": steps, "cache_len": max_seq,
               "cache_gb": tensor_gb(cache.values()),
               "prefill_ms": prefill_ms,
               "decode_ms_per_step": decode_ms / per_step,
               "tokens_per_s": batch * steps / (prefill_ms + decode_ms)
               * 1e3,
               "decode_tokens_per_s": batch * per_step / decode_ms * 1e3,
               "cold_prefill_ms": walls[0][0],
               "cold_decode_ms_per_step": walls[0][1] / per_step,
               "peak_gb": peak / 1e9,
               "prefill_vs_forward_max_abs_err": pf[0],
               "prefill_vs_forward_worst_over_limit": pf[1],
               "decode_vs_forward_max_abs_err": dc[0],
               "decode_vs_forward_worst_over_limit": dc[1],
               "ids_head": res.ids[0, :8].tolist(), "card": card}
        if not pf[1] <= 1.0:
            raise RuntimeError(f"phase 12 {model.cfg.name} {label}: prefill "
                               f"{pf[1]} times the limit {LM_TOL} off "
                               "forward")
        return row

    def layer_decode(model, batch, length, seed):
        """Each layer's cached decode of the last of ``length`` seeded
        tokens (a prefill of the others into the layer's cache, then one
        step) against the layer's forward at that position, both on the
        forward's own input to the layer: max |Δ| and worst share of
        LM_TOL's limit over the layers."""
        cfg = model.cfg
        tokens = lm_prompts(cfg.vocab, batch, length, seed)
        pos = torch.arange(length, device=dev)[None, :].expand(batch,
                                                              length)
        cache = model.init_cache(batch, 1 << (length - 1).bit_length())
        worst = (0.0, 0.0)
        with torch.no_grad():
            x = model.embed[tokens].to(LL._dt(cfg))
            for li, lp in enumerate(model.layers):
                use_moe, glob = LT._layer_pattern(cfg, li)
                chunk = None if glob else cfg.attn_chunk
                c = {k: v[li] for k, v in cache.items()}
                LT._layer_apply(cfg, lp, x[:, :-1], pos[:, :-1], chunk,
                                use_moe, c, 0)
                step, _, _ = LT._layer_apply(cfg, lp, x[:, -1:], pos[:, -1:],
                                             chunk, use_moe, c, length - 1)
                x, _, _ = LT._layer_apply(cfg, lp, x, pos, chunk, use_moe)
                worst = max(worst, lm_err(step[:, 0], x[:, -1]),
                            key=lambda e: e[1])
        return {"layer_decode_vs_forward_max_abs_err": worst[0],
                "layer_decode_vs_forward_worst_over_limit": worst[1]}

    # (a) llama3.2-3B, full width
    cfg_l = LMC.get("llama3.2-3b").full()
    lm_sets = (("reference defaults", 2, 16, 8),
               ("batch 8 prompt 512", 8, 512, 32))
    torch.cuda.reset_peak_memory_stats()
    llama, init_ms = timed(lambda: LT.init_params(
        cfg_l, torch.Generator(device=dev).manual_seed(12), device=dev))
    params = list(llama.parameters())
    log12("llama3.2-3B weights", {
        "params": sum(p.numel() for p in params),
        "param_count": cfg_l.param_count(), "gb": tensor_gb(params),
        "init_ms": init_ms, "layers": cfg_l.n_layers,
        "d_model": cfg_l.d_model, "vocab": cfg_l.vocab, "card": card})
    del params
    for label, batch, prompt, steps in lm_sets:
        log12("llama3.2-3B serve",
              serve_run(llama, label, batch, prompt, steps, 120))
    # (c) the flash kernel on layer 0's prefill q, k, v of the batch-8 set
    # (T = 1024 cache slots, S = 512 written), against the LM's chunked
    # attention on the same card tensors and both against the function's
    # value (the plain version in float64 on the same bfloat16 inputs)
    with torch.no_grad():
        prompts = lm_prompts(cfg_l.vocab, 8, 512, 120)
        lay0, dt_l = llama.layers[0], LL._dt(cfg_l)
        b_, s_ = prompts.shape
        pos = torch.arange(s_, device=dev)[None, :].expand(b_, s_)
        h0 = LL.rms_norm(llama.embed[prompts].to(dt_l),
                         lay0["ln1"].to(dt_l), cfg_l.norm_eps)
        q0, k0, v0 = LL.gqa_qkv(cfg_l, lay0["attn"], h0, pos)
        t_len = 1 << (512 + 32 - 1).bit_length()
        kc = torch.zeros((b_, t_len) + tuple(k0.shape[2:]), dtype=dt_l,
                         device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :s_], vc[:, :s_] = k0, v0
        qf, kf, vf = (x.transpose(1, 2).contiguous() for x in (q0, kc, vc))

        def lm_attention():
            return LL._sdpa(q0, kc, vc, pos, None, dt_l,
                            kv_chunk=cfg_l.kv_chunk, impl="chunked")

        def flash():
            return FA.flash_attention(qf, kf, vf, causal=True)
        got, lm_out = flash(), lm_attention().transpose(1, 2)
        exact = FA._flash_plain(qf.double(), kf.double(), vf.double(), True,
                                None)
        scale_a = FA._flash_plain(qf.double(), kf.double(),
                                  vf.double().abs(), True, None)
        torch.cuda.synchronize()
        rtol, atol = FLASH_LM_TOL

        def shares(x, y):
            """Worst share of the weight-error limit atol + rtol·Σp|v|,
            max |Δ|, and the worst share of the |out|-relative one."""
            diff = (x.double() - y.double()).abs()
            return (float((diff / (atol + rtol * scale_a)).max()),
                    float(diff.max()),
                    float((diff / (atol + rtol * y.double().abs())).max()))
        pairs = {"flash_vs_lm": shares(got, lm_out),
                 "flash_vs_float64": shares(got, exact),
                 "lm_vs_float64": shares(lm_out, exact)}
        flash_check = {
            "case": f"llama3.2-3B layer-0 prefill q/k/v B={b_} S={s_} "
                    f"T={t_len}",
            "max_abs_err": pairs["flash_vs_lm"][1],
            "worst_over_limit": pairs["flash_vs_lm"][0],
            "vs_float64_worst_over_limit": pairs["flash_vs_float64"][0],
            "lm_vs_float64_worst_over_limit": pairs["lm_vs_float64"][0],
            **{f"{k}_max_abs_err": v[1] for k, v in pairs.items()},
            "out_relative_worst_over_limit": {k: v[2]
                                              for k, v in pairs.items()},
            "logit_std": float((torch.einsum(
                "bhsd,bhtd->bhst", qf[:1, :3, :64].float(),
                kf[:1, :1, :64].float()) / math.sqrt(qf.shape[-1])).std()),
            "v_max_abs": float(vf.float().abs().max()),
            "tolerance": {"rtol": rtol, "atol": atol,
                          "of": "attention of |v|, float64"},
            "ms": time_ms(flash, 10), "lm_attention_ms":
                time_ms(lm_attention, 5), "card": card}
        log12("flash_sm90 on the LM's prefill", flash_check)
        if not (flash_check["worst_over_limit"] <= 1.0
                and flash_check["vs_float64_worst_over_limit"] <= 1.0):
            raise RuntimeError(
                f"phase 12: flash_sm90 on the LM's layer-0 q/k/v is "
                f"{flash_check['worst_over_limit']} times its limit off "
                f"the LM's attention and "
                f"{flash_check['vs_float64_worst_over_limit']} off the "
                f"float64 value")
        del h0, q0, k0, v0, kc, vc, qf, kf, vf, got, lm_out, exact, scale_a
    # the same in float32 from the same weights, and the network's own
    # sensitivity: the float32 forward with the embedding table scaled by
    # 1 + 1e-7·N(0, 1) elementwise
    llama32 = llama.cast("float32")
    del llama
    gc.collect()
    torch.cuda.empty_cache()
    for label, batch, prompt, steps in lm_sets:
        log12("llama3.2-3B float32 serve",
              serve_run(llama32, label, batch, prompt, steps, 120, runs=1))
    with torch.no_grad():
        prompts = lm_prompts(cfg_l.vocab, 2, 16 + 8 - 1, 121)
        base, _, _ = llama32(prompts)
        saved = llama32.embed.detach().clone()
        llama32.embed.mul_(1 + 1e-7 * torch.randn(
            saved.shape, generator=torch.Generator(device=dev).manual_seed(
                122), device=dev))
        moved, _, _ = llama32(prompts)
        llama32.embed.copy_(saved)
        log12("llama3.2-3B float32 sensitivity", {
            "case": "forward, embedding × (1 + 1e-7·N(0, 1))",
            "max_abs_err": float((moved - base).abs().max()),
            "logits_max_abs": float(base.abs().max()), "card": card})
        del base, moved, saved
    # decode against forward at full depth in float64 (the same weights
    # cast once more): each layer's cached decode on both request sets,
    # and end to end at the reference defaults (at batch 8 × 544 tokens
    # even float64 rounding is amplified past LM_TOL: recorded)
    llama64 = llama32.cast("float64")
    del llama32
    gc.collect()
    torch.cuda.empty_cache()
    for label, batch, prompt, steps in lm_sets:
        row = serve_run(llama64, label, batch, prompt, steps, 120, runs=1)
        row.update(layer_decode(llama64, batch, prompt + steps - 1, 123))
        log12("llama3.2-3B float64 serve", row)
        if not row["layer_decode_vs_forward_worst_over_limit"] <= 1.0 or (
                label == lm_sets[0][0]
                and not row["decode_vs_forward_worst_over_limit"] <= 1.0):
            raise RuntimeError(
                f"phase 12 llama3.2-3B float64 {label}: decode "
                f"{row['decode_vs_forward_worst_over_limit']} times the "
                f"limit {LM_TOL} off forward, a layer's decode "
                f"{row['layer_decode_vs_forward_worst_over_limit']}")
    del llama64
    gc.collect()
    torch.cuda.empty_cache()

    # (b) deepseek-v3, full width, depth 4
    cfg_d = dataclasses.replace(LMC.get("deepseek-v3-671b").full(),
                                n_layers=P12_DEEPSEEK_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    deep, init_ms = timed(lambda: LT.init_params(
        cfg_d, torch.Generator(device=dev).manual_seed(13), device=dev))
    params = list(deep.parameters())
    moe_layers = [li for li in range(cfg_d.n_layers)
                  if cfg_d.moe.is_moe_layer(li)]
    log12("deepseek-v3 weights", {
        "params": sum(p.numel() for p in params),
        "param_count": cfg_d.param_count(), "gb": tensor_gb(params),
        "init_ms": init_ms, "layers": cfg_d.n_layers,
        "moe_layers": moe_layers, "experts": cfg_d.moe.n_experts,
        "top_k": cfg_d.moe.top_k, "mtp": cfg_d.mtp, "card": card})
    del params
    row = serve_run(deep, "reference defaults", 2, 16, 8, 130)
    prompts = lm_prompts(cfg_d.vocab, 2, 16, 130)
    # a prefill with the MoE layer's routing caught; then, from its cache,
    # one decode step absorbed ("auto" at one query) and expanded, their
    # logits, and in every layer the attention context both ways on the
    # absorbed step's own inputs
    routes, route = [], LL.moe_route
    mla_in = []
    mla = LL.mla_attention

    def spy_route(*args):
        routes.append(route(*args))
        return routes[-1]

    def spy_mla(cfg, p, x, positions, chunk, cache=None, offset=None):
        if x.shape[1] == 1:
            mla_in.append((p, x, positions,
                           {k: v.clone() for k, v in cache.items()}, offset))
        return mla(cfg, p, x, positions, chunk, cache, offset)
    with torch.no_grad():
        cache = deep.init_cache(2, 32)
        LL.moe_route = spy_route
        try:
            deep.prefill(prompts, cache)
        finally:
            LL.moe_route = route
        if len(routes) != len(moe_layers):
            raise RuntimeError(f"phase 12 deepseek-v3: {len(routes)} "
                               f"routings for MoE layers {moe_layers}")
        r = routes[0]
        kept = torch.stack([
            torch.bincount(top[keep], minlength=cfg_d.moe.n_experts)
            for top, keep in zip(r.top.reshape(r.rank.shape), r.keep)])
        gate_err = float((r.gate.sum(-1) - 1).abs().max())
        row.update(cap=r.cap, assignments=int(r.keep.numel()),
                   dropped=int((~r.keep).sum()),
                   max_kept_per_expert=int(kept.max()),
                   gate_sum_max_abs_err=gate_err)
        if int(kept.max()) > r.cap or gate_err > 1e-6:
            raise RuntimeError(f"phase 12 deepseek-v3: an expert kept "
                               f"{int(kept.max())} > cap {r.cap} or the "
                               f"gates sum to 1 ± {gate_err}")
        tok = prompts[:, -1]
        logits = {}
        for mode in ("auto", "expanded"):
            c = {k: v.clone() for k, v in cache.items()}
            LL.mla_attention = spy_mla
            try:
                logits[mode], _ = deep.with_config(
                    mla_decode=mode).decode_step(tok, prompts.shape[1], c)
            finally:
                LL.mla_attention = mla
        # each layer's attention context (before ``wo``) on the absorbed
        # run's own inputs and cache, absorbed and expanded
        attn_err = []
        for p, x, positions, c, offset in mla_in[:cfg_d.n_layers]:
            q_nope, q_rope, c_new, kr_new = LL.mla_qkv(cfg_d, p, x,
                                                       positions)
            c["c_kv"][:, offset:offset + 1] = c_new
            c["k_r"][:, offset:offset + 1] = kr_new
            args = (cfg_d, p, q_nope, q_rope, c["c_kv"], c["k_r"],
                    positions, LL._dt(cfg_d))
            attn_err.append(lm_err(LL._mla_sdpa_absorbed(*args),
                                   LL._mla_sdpa_chunked(*args), tol=MLA_TOL))
        mla_logits = lm_err(logits["auto"], logits["expanded"])
        batch = {"tokens": prompts, "targets": torch.roll(prompts, -1, 1)}
        loss = float(deep.loss_fn(batch))
        del cache, c, logits, r, routes, mla_in
        # the same weights in float32, cast leaf by leaf (both models at
        # once would not fit): the two decodes' logits from one prefill
        torch.cuda.reset_peak_memory_stats()
        for pname, prm in deep.named_parameters():
            if not pname.endswith("router"):     # float32 already
                prm.data = prm.data.float()
        deep.cfg = dataclasses.replace(deep.cfg, dtype="float32",
                                       param_dtype="float32")
        gc.collect()
        torch.cuda.empty_cache()
        cache = deep.init_cache(2, 32)
        deep.prefill(prompts, cache)
        logits = {mode: deep.with_config(mla_decode=mode).decode_step(
            tok, prompts.shape[1], {k: v.clone() for k, v in
                                    cache.items()})[0]
            for mode in ("auto", "expanded")}
        mla_logits32 = lm_err(logits["auto"], logits["expanded"])
        f32_peak = torch.cuda.max_memory_allocated()
        del cache, logits
    row.update(
        mla_context_max_abs_err=max(e for e, _ in attn_err),
        mla_context_worst_over_limit=max(w for _, w in attn_err),
        mla_tolerance={"rtol": MLA_TOL[0], "atol": MLA_TOL[1]},
        mla_logits_max_abs_err=mla_logits[0],
        mla_logits_worst_over_limit=mla_logits[1],
        float32_mla_logits_max_abs_err=mla_logits32[0],
        float32_mla_logits_worst_over_limit=mla_logits32[1],
        float32_peak_gb=f32_peak / 1e9,
        loss_with_mtp=loss)
    log12("deepseek-v3 serve", row)
    if not row["mla_context_worst_over_limit"] <= 1.0 \
            or not row["float32_mla_logits_worst_over_limit"] <= 1.0 \
            or not math.isfinite(loss):
        raise RuntimeError(f"phase 12 deepseek-v3: absorbed against "
                           f"expanded MLA attention context "
                           f"{row['mla_context_worst_over_limit']} times "
                           f"the limit {MLA_TOL}, float32 logits "
                           f"{row['float32_mla_logits_worst_over_limit']} "
                           f"times {LM_TOL}, loss {loss}")
    del deep
    gc.collect()
    torch.cuda.empty_cache()
    phase12_s = time.perf_counter() - t12
    log(f"phase 12: {phase12_s:.1f} s")
    record["phase12"] = phase12_rows
    record["phase12_s"] = phase12_s

    # ------------------------------------------------------------------
    # Phase 13: the GNNs (``models/gnn.py``, ``data/graphs.py``) at their
    # full() configs, float32, seeded random weights on the card.  (a) GAT
    # on the cora-shaped graph and at ogb_products' n and e (phase 11's
    # edges, ``cora_batch``'s features); (b) MeshGraphNet on a 256 × 256
    # grid, single-device and over 4 vertex-cut shards, then its loss over
    # 32 shards of the ogb_products-sized graph; (c) EGNN and (d) DimeNet
    # on the molecule shape (128 molecules × 30 atoms), with the rotation
    # checks.  Every forward runs twice, bitwise; outputs finite; the
    # cora, grid and molecule forwards against the same model cast to
    # float64.  (f) The ELL softmax kernel on (a)'s ogb-sized layer-0
    # logits against the model's α (a check: the reference's GNNs call no
    # kernel, and neither does the port's).
    # ------------------------------------------------------------------
    import repro_torch.configs as GC
    from repro_torch.data import graphs as GD
    from repro_torch.graph import segment as GS
    from repro_torch.models import gnn as GN
    phase13_rows = []
    t13 = time.perf_counter()

    def log13(tag, row):
        log(f"phase 13 {tag} " + json.dumps(row))
        phase13_rows.append(dict(row, line=tag))

    def outs_of(out):
        return list(out) if isinstance(out, (tuple, list)) else [out]

    def gnn_share(got, want):
        """The worst |Δ| as a share of GNN_TOL·(|want| + max|want|) (a
        bound relative to each output's own scale), and the max |Δ|."""
        diff = (got.double() - want.double()).abs()
        mag = want.double().abs()
        limit = GNN_TOL * (mag + mag.max())
        return float((diff / limit).max()), float(diff.max())

    def gnn_run(label, fn):
        """``fn`` (a forward) twice, each timed to a synchronize (cold,
        warm): the outputs bitwise equal and finite; with the peak device
        memory of the pair."""
        reset_peak()
        out, cold = timed(fn)
        again, warm = timed(fn)
        outs, agains = outs_of(out), outs_of(again)
        row = {"case": label, "cold_ms": cold, "warm_ms": warm,
               "bitwise_repeat": all(torch.equal(bits(a), bits(b))
                                     for a, b in zip(outs, agains)),
               "finite": all(bool(torch.isfinite(o).all()) for o in outs),
               "on_card": all(o.device.type == "cuda" for o in outs),
               "shapes": [list(o.shape) for o in outs],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "card": card}
        if not (row["bitwise_repeat"] and row["finite"] and row["on_card"]):
            raise RuntimeError(f"phase 13 {label}: repeat bitwise "
                               f"{row['bitwise_repeat']}, finite "
                               f"{row['finite']}, on the card "
                               f"{row['on_card']}")
        del again, agains
        return out, row

    def f64_check(row, out, out64):
        """The float32 forward against the float64 one (same weights cast):
        required within GNN_TOL·(|x64| + max|x64|) elementwise."""
        shares = [gnn_share(a, b) for a, b in zip(outs_of(out),
                                                  outs_of(out64))]
        row.update(f64_worst_over_limit=max(s[0] for s in shares),
                   f64_max_abs_err=max(s[1] for s in shares),
                   f64_scale=max(float(b.double().abs().max())
                                 for b in outs_of(out64)))
        if row["f64_worst_over_limit"] > 1.0:
            raise RuntimeError(f"phase 13 {row['case']}: float32 against "
                               f"float64 {row['f64_worst_over_limit']} "
                               f"times the limit")

    def gen13(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def p13_profile(label, fn, log_row=log13):
        """One more run of ``fn`` under torch.profiler: device busy time
        against the wall, and the top device ops."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        log_row("profile", {
            "label": label, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}, "card": card})

    def f64(t):
        return t.double() if t.is_floating_point() else t

    # (a) GAT on the cora-shaped graph (full_graph_sm: n 2,708, d_in 1,433)
    gat_cfg = GC.get("gat-cora").full()
    gc_, gx_, gy_ = TS.cora_like(device=dev)
    gsrc, gdst = gc_.by_dst.src, gc_.by_dst.dst
    gat = GN.gat_init(gat_cfg, gen13(131), device=dev)
    out, row = gnn_run("gat-cora cora_like",
                       lambda: gat(gx_, gsrc, gdst, gc_.n))
    row.update(n=gc_.n, e=int(gsrc.shape[0]), d_in=gat_cfg.d_in,
               loss=float(gat.loss({"x": gx_, "src": gsrc, "dst": gdst,
                                    "y": gy_})))
    f64_check(row, out, gat.cast("float64")(gx_.double(), gsrc, gdst,
                                             gc_.n))
    log13("gat", row)
    del gc_, gx_, gy_, gsrc, gdst, out

    # ... at ogb_products' n and e: phase 11's uniform graph's edges (its
    # dst-sorted order) with cora_batch's features and labels, d_in 100
    # (the workload's replace(cfg, d_in=d_feat))
    t0 = time.perf_counter()
    ob = GD.cora_batch_on(p13_src, p13_dst, p11_n, d_feat=100,
                          n_classes=gat_cfg.n_classes, seed=OGB_SEED,
                          device=dev)
    batch_s = time.perf_counter() - t0
    gat_o = GN.gat_init(dataclasses.replace(gat_cfg, d_in=100), gen13(132),
                        device=dev)
    out, row = gnn_run("gat-cora ogb_products", lambda: gat_o(
        ob["x"], ob["src"], ob["dst"], p11_n))
    loss, loss_ms = timed(lambda: float(gat_o.loss(ob)))
    row.update(n=p11_n, e=int(ob["src"].shape[0]), d_in=100, loss=loss,
               loss_ms=loss_ms, batch_s=batch_s)
    log13("gat", row)
    del out
    p13_profile("gat-cora ogb_products forward", lambda: gat_o(
        ob["x"], ob["src"], ob["dst"], p11_n))
    gc.collect()
    torch.cuda.empty_cache()
    # (f) the ELL softmax kernel on layer 0's logits, per head, laid into
    # the graph's in-layout (row = dst, slot = the edge's rank among its
    # dst's in-edges: to_blocked_ell's fill order), against the model's α
    with torch.no_grad():
        p0 = gat_o["layers"][0]
        w0 = p0["w"]
        h0 = (ob["x"] @ w0.reshape(w0.shape[0], -1)).view(
            p11_n, *w0.shape[1:])
        logits, alpha = GN.gat_attention(p0, h0, ob["src"], ob["dst"], p11_n)
        del h0
        g13 = TS.from_edges(p11_n, p13_src, p13_dst, validate=False,
                            device=dev)
        ell = TS.to_blocked_ell(g13)
        rows = g13.by_dst.dst.long()
        slots = TS._fill_order_slots(g13.by_dst.dst, p11_n)
        placed = bool(torch.equal(ell.nbrs[rows, slots], g13.by_dst.src))
        mask = ell.mask
        del g13
        model_ms = time_ms(lambda: GS.segment_softmax(
            logits, ob["dst"], p11_n), 3)
        worst, err, kernel_ms = 0.0, 0.0, []
        scores = torch.zeros((ell.n_pad, ell.width), dtype=torch.float32,
                             device=dev)
        for head in range(logits.shape[1]):
            scores[rows, slots] = logits[:, head]
            SS.reset_launches()
            got = SS.ell_softmax(scores, mask)
            launched = SS.LAUNCHES["softmax"]
            want = alpha[:, head]
            diff = (got[rows, slots] - want).abs()
            worst = max(worst, float((diff / (1e-5 + 1e-5 * want.abs()))
                                     .max()))
            err = max(err, float(diff.max()))
            kernel_ms.append(time_ms(lambda: SS.ell_softmax(scores, mask),
                                     5))
            if launched != 1:
                raise RuntimeError("phase 13: ell_softmax did not launch "
                                   "its kernel on GAT's logits")
        softmax_check = {
            "case": f"gat-cora layer-0 logits, ogb_products n {p11_n} e "
                    f"{int(ob['src'].shape[0])}, {logits.shape[1]} heads",
            "max_abs_err": err, "worst_over_limit": worst,
            "tolerance": {"rtol": 1e-5, "atol": 1e-5, "of": "model α"},
            "layout": {"n_pad": ell.n_pad, "width": ell.width},
            "slots_placed": placed,
            "ms_per_head": statistics.median(kernel_ms),
            "ms_all_heads": sum(kernel_ms),
            # a head's bound: the bytes it needs, and every slot's
            "bound_ms_per_head": SS.ell_softmax_bytes(mask, scores.dtype)
            / HBM_BYTES_PER_S * 1e3,
            "bound_all_slots_ms_per_head": mask.numel() * (4 + 1 + 4)
            / HBM_BYTES_PER_S * 1e3,
            "model_softmax_ms": model_ms, "card": card}
        log13("ell_softmax on GAT's logits", softmax_check)
        if worst > 1.0 or not placed:
            raise RuntimeError(f"phase 13: ell_softmax on GAT's logits is "
                               f"{worst} times 1e-5 + 1e-5·|α| off the "
                               f"model's α (slots placed: {placed})")
        del logits, alpha, scores, got, want, diff, ell, mask, rows, slots
    del ob, gat_o
    gc.collect()
    torch.cuda.empty_cache()

    # (b) MeshGraphNet on a 256 × 256 grid: single-device and 4 shards
    mgn_cfg = GC.get("meshgraphnet").full()
    mgn = GN.mgn_init(mgn_cfg, gen13(133), device=dev)
    mb = GD.mesh_batch(256, 256, d_node_in=mgn_cfg.d_node_in,
                       d_edge_in=mgn_cfg.d_edge_in, d_out=mgn_cfg.d_out,
                       device=dev)
    mn = mb["node_x"].shape[0]
    margs = (mb["node_x"], mb["edge_x"], mb["src"], mb["dst"], mn)
    single, row = gnn_run("meshgraphnet grid 256x256", lambda: mgn(*margs))
    single_loss = float(mgn.loss(mb))
    row.update(n=mn, e=int(mb["src"].shape[0]), loss=single_loss,
               ms_per_layer=row["warm_ms"] / mgn_cfg.n_layers)
    f64_check(row, single, mgn.cast("float64")(
        *(f64(a) if isinstance(a, torch.Tensor) else a for a in margs)))
    log13("meshgraphnet", row)
    host = {k: v.cpu().numpy() for k, v in mb.items()}
    part = GD.dst_block_partition(host["src"], host["dst"], mn, 4, 1.3)
    if int(part["mask"].sum()) != host["src"].shape[0]:
        raise RuntimeError("phase 13: the grid's 4-block partition dropped "
                           "edges")
    mesh4 = ShardMesh.on(dev, 4)
    shards = GD.shard_batch(host, part, ("node_x", "target"), ("edge_x",),
                            devices=mesh4.devices)
    dargs = [[s[k] for s in shards]
             for k in ("node_x", "edge_x", "src", "dst", "emask")]
    dist, row = gnn_run("meshgraphnet grid 256x256, 4 shards",
                        lambda: torch.cat(GN.mgn_forward_dist(
                            mgn_cfg, mgn, *dargs, mesh4)))
    dist_loss = float(GN.mgn_loss_dist(mgn_cfg, mgn, shards, mesh4))
    share, err = gnn_share(dist[:mn], single)
    row.update(shards=4, e_pad=part["e_pad"], loss=dist_loss,
               single_loss=single_loss,
               loss_rel_err=abs(dist_loss - single_loss) / abs(single_loss),
               vs_single_worst_over_limit=share, vs_single_max_abs_err=err,
               ms_per_layer=row["warm_ms"] / mgn_cfg.n_layers)
    log13("meshgraphnet", row)
    if share > 1.0 or row["loss_rel_err"] > 1e-4:
        raise RuntimeError(f"phase 13: 4-shard MGN against single-device: "
                           f"outputs {share} times the limit, loss "
                           f"{row['loss_rel_err']} relative")
    del single, dist, shards, dargs, mb, margs

    # ... its loss over 32 vertex-cut shards of the ogb_products-sized
    # graph (pad 1.3 as the reference's partition), on one card; seeded
    # random node / edge features and targets made on the card
    t0 = time.perf_counter()
    part = GD.dst_block_partition(p13_src, p13_dst, p11_n, P13_SHARDS, 1.3)
    part_s = time.perf_counter() - t0
    landed = int(part["mask"].sum())
    if landed != len(p13_src):
        raise RuntimeError(f"phase 13: the {P13_SHARDS}-block partition "
                           f"holds {landed} of {len(p13_src)} edges")
    n_loc, e_pad = part["n_loc"], part["e_pad"]
    mesh_o = ShardMesh.on(dev, P13_SHARDS)
    fg = gen13(134)
    oshards = []
    for j in range(P13_SHARDS):
        oshards.append({
            "node_x": torch.randn((n_loc, mgn_cfg.d_node_in), generator=fg,
                                  device=dev),
            "edge_x": torch.randn((e_pad, mgn_cfg.d_edge_in), generator=fg,
                                  device=dev),
            "target": torch.randn((n_loc, mgn_cfg.d_out), generator=fg,
                                  device=dev),
            "nmask": torch.arange(j * n_loc, (j + 1) * n_loc, device=dev)
            < p11_n,
            **{k: torch.from_numpy(part[m][j]).to(dev) for k, m in
               (("src", "src"), ("dst", "dst"), ("emask", "mask"))}})
    del part
    # why the vertex-cut forwards drop the pads: shard 0's sum of a
    # [e_pad, d] edge state with the pads kept (masked, the reference's
    # form: every pad joins local destination 0's segment) against the
    # same sum over its real edges only
    with torch.no_grad():
        s0 = oshards[0]
        e0 = torch.randn((e_pad, mgn_cfg.d_hidden), generator=fg,
                         device=dev)
        real0 = int(s0["emask"].sum())
        em0 = s0["emask"][:, None].to(e0.dtype)
        kept = GS.segment_sum(e0 * em0, s0["dst"], n_loc)
        dropped = GS.segment_sum(e0[:real0], s0["dst"][:real0], n_loc)
        pads_row = {
            "case": f"shard 0 of {P13_SHARDS}: sum of [e_pad, "
                    f"{mgn_cfg.d_hidden}] into {n_loc} rows",
            "e_pad": e_pad, "real_edges": real0,
            "longest_segment_kept": int(torch.bincount(
                s0["dst"].long()).max()),
            "longest_segment_dropped": int(torch.bincount(
                s0["dst"][:real0].long()).max()),
            "kept_ms": time_ms(lambda: GS.segment_sum(
                e0 * em0, s0["dst"], n_loc), 3),
            "dropped_ms": time_ms(lambda: GS.segment_sum(
                e0[:real0], s0["dst"][:real0], n_loc), 3),
            "max_abs_diff": float((kept - dropped).abs().max()),
            "card": card}
        log13("pads", pads_row)
        if not torch.allclose(kept, dropped, rtol=1e-5, atol=1e-5):
            raise RuntimeError("phase 13: dropping the pads changed a sum")
        del s0, e0, em0, kept, dropped

    def mgn_ogb_loss():
        return GN.mgn_loss_dist(mgn_cfg, mgn, oshards, mesh_o)
    reset_peak()
    lo1, cold = timed(mgn_ogb_loss)
    lo2, warm = timed(mgn_ogb_loss)
    row = {"case": f"meshgraphnet ogb_products, {P13_SHARDS} shards",
           "n": p11_n, "e": len(p13_src), "shards": P13_SHARDS,
           "n_loc": n_loc, "e_pad": e_pad, "edge_slots": P13_SHARDS * e_pad,
           "partition_s": part_s, "cold_ms": cold, "warm_ms": warm,
           "ms_per_layer": warm / mgn_cfg.n_layers, "loss": float(lo1),
           "bitwise_repeat": bool(torch.equal(bits(lo1), bits(lo2))),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    log13("meshgraphnet", row)
    if not (row["bitwise_repeat"] and math.isfinite(row["loss"])):
        raise RuntimeError(f"phase 13: the {P13_SHARDS}-shard MGN loss is "
                           f"{row['loss']}, repeat bitwise "
                           f"{row['bitwise_repeat']}")
    p13_profile(f"meshgraphnet ogb_products loss, {P13_SHARDS} shards",
                mgn_ogb_loss)
    del oshards, lo1, lo2, mgn
    gc.collect()
    torch.cuda.empty_cache()

    def rotation(th, dtype):
        return torch.tensor([[math.cos(th), -math.sin(th), 0.0],
                             [math.sin(th), math.cos(th), 0.0],
                             [0.0, 0.0, 1.0]], dtype=dtype, device=dev)

    # (c) EGNN on the molecule shape
    egnn_cfg = GC.get("egnn").full()
    egnn = GN.egnn_init(egnn_cfg, gen13(135), device=dev)
    eb = GD.molecule_batch(n_graphs=128, n_atoms=30, device=dev)
    en = eb["feats"].shape[0]
    eargs = (eb["feats"], eb["coords"], eb["src"], eb["dst"], en)
    (eout, ex), row = gnn_run("egnn molecule 128x30", lambda: egnn(*eargs))
    egnn64 = egnn.cast("float64")
    eargs64 = tuple(f64(a) if isinstance(a, torch.Tensor) else a
                    for a in eargs)
    e64 = egnn64(*eargs64)
    row.update(n=en, e=int(eb["src"].shape[0]), loss=float(egnn.loss(eb)))
    f64_check(row, (eout, ex), e64)
    # the rotation check of the reference's tests, held in float64 (a
    # float64 rotation) at its atol 1e-4 and in float32 at the float64
    # check's limit; float32 against atol 1e-4 recorded
    for dt, model_r, args_r, (o1, x1) in (
            ("float32", egnn, eargs, (eout, ex)),
            ("float64", egnn64, eargs64, e64)):
        rot = rotation(0.7, getattr(torch, dt))
        o2, x2 = model_r(args_r[0], args_r[1] @ rot.T, *args_r[2:])
        d_out = float((o1 - o2).abs().max())
        d_x = float((x1 @ rot.T - x2).abs().max())
        row[f"rotation_{dt}"] = {
            "out_max_abs_err": d_out, "coords_max_abs_err": d_x,
            "worst_over_limit": max(gnn_share(o2, o1)[0],
                                    gnn_share(x2, x1 @ rot.T)[0])}
    row["rotation_float64"]["within_atol_1e-4"] = \
        max(row["rotation_float64"]["out_max_abs_err"],
            row["rotation_float64"]["coords_max_abs_err"]) <= 1e-4
    # four vertex-cut shards against the single-device forward
    host = {k: v.cpu().numpy() for k, v in eb.items()
            if isinstance(v, torch.Tensor)}
    part = GD.dst_block_partition(host["src"], host["dst"], en, 4, 1.3)
    if int(part["mask"].sum()) != host["src"].shape[0]:
        raise RuntimeError("phase 13: the molecules' 4-block partition "
                           "dropped edges")
    shards = GD.shard_batch(host, part, ("feats", "coords"),
                            devices=mesh4.devices)
    do, dx = GN.egnn_forward_dist(
        egnn_cfg, egnn, *([s[k] for s in shards] for k in
                          ("feats", "coords", "src", "dst", "emask")), mesh4)
    row["vs_4_shards_worst_over_limit"] = max(
        gnn_share(torch.cat(do)[:en], eout)[0],
        gnn_share(torch.cat(dx)[:en], ex)[0])
    log13("egnn", row)
    if not (row["rotation_float64"]["within_atol_1e-4"]
            and row["rotation_float32"]["worst_over_limit"] <= 1.0
            and row["vs_4_shards_worst_over_limit"] <= 1.0):
        raise RuntimeError(f"phase 13: EGNN's rotation check or its 4-shard "
                           f"forward failed: {json.dumps(row)}")
    del egnn, egnn64, eb, eargs, eargs64, e64, eout, ex, shards, do, dx

    # (d) DimeNet on the molecule shape (n_species 16)
    dn_cfg = GC.get("dimenet").full()
    dn = GN.dimenet_init(dn_cfg, gen13(136), device=dev)
    t0 = time.perf_counter()
    db = GD.molecule_batch(n_graphs=128, n_atoms=30,
                           n_species=dn_cfg.n_species, device=dev)
    batch_s = time.perf_counter() - t0
    dargs = [db["species"], db["coords"], db["src"], db["dst"], db["t_kj"],
             db["t_ji"], db["species"].shape[0]]
    dout, row = gnn_run("dimenet molecule 128x30", lambda: dn(*dargs))
    cos = GN.dimenet_geometry(dn_cfg, db["coords"], db["src"], db["dst"],
                              db["t_kj"], db["t_ji"])[2]
    row.update(n=dargs[-1], e=int(db["src"].shape[0]),
               wedges=int(db["t_kj"].shape[0]), batch_s=batch_s,
               worst_abs_cos=float(cos.abs().max()),
               loss=float(dn.loss(db)))
    f64_check(row, dout, dn.cast("float64")(
        *(f64(a) if isinstance(a, torch.Tensor) else a for a in dargs)))
    rargs = list(dargs)
    rargs[1] = db["coords"] @ rotation(1.1, torch.float32).T
    row["rotation_max_abs_err"] = float((dn(*rargs) - dout).abs().max())
    log13("dimenet", row)
    if row["rotation_max_abs_err"] > 1e-3:
        raise RuntimeError(f"phase 13: DimeNet's outputs move by "
                           f"{row['rotation_max_abs_err']} under a rotation")
    del dn, db, dargs, rargs, dout, cos
    gc.collect()
    torch.cuda.empty_cache()
    phase13_s = time.perf_counter() - t13
    log(f"phase 13: {phase13_s:.1f} s")
    record["phase13"] = phase13_rows
    record["phase13_s"] = phase13_s

    # ------------------------------------------------------------------
    # Phase 14: DLRM RM2 (``models/dlrm.py``) at full(), float32, seeded
    # random weights on the card, ``dlrm_batch`` inputs.  (a) serve_p99
    # (B 512) and (b) serve_bulk (B 262,144): forward and loss, each held
    # against float64 MLPs over the same float32 tables; (c)
    # retrieval_cand: one query against 1,000,000 candidates; (d) K = 8
    # multi-hot at B 65,536, then the bag kernel on each of the 26 tables
    # against the model's lookup (a check: the reference's DLRM gathers
    # and calls no kernel, and neither does the port's); (e) bfloat16
    # tables at serve_bulk against the float32 forward over the same
    # tables rounded to bfloat16.  Every forward twice, bitwise; finite.
    # ------------------------------------------------------------------
    from repro_torch.models import dlrm as DL
    del p13_src, p13_dst
    phase14_rows = []
    t14 = time.perf_counter()
    p14_start_gb = torch.cuda.memory_allocated() / 1e9
    log(f"phase 14: {p14_start_gb:.3f} GB allocated at its start")

    def log14(tag, row):
        log(f"phase 14 {tag} " + json.dumps(row))
        phase14_rows.append(dict(row, line=tag))

    rm2 = GC.get("dlrm-rm2").full()
    ex_flops = dlrm_dense_flops(rm2)
    reset_peak()
    t0 = time.perf_counter()
    dlrm = DL.dlrm_init(rm2, gen13(141), device=dev)
    torch.cuda.synchronize()
    init_row = {"init_s": time.perf_counter() - t0,
                "tables_gb": dlrm["tables"].numel() * 4 / 1e9,
                "params": rm2.param_count(), "flops_per_example": ex_flops,
                "allocated_at_start_gb": p14_start_gb,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "card": card}
    log14("init", init_row)

    def dlrm_run(label, model, b):
        """``model``'s forward on ``b`` twice, each timed to a synchronize
        (cold, warm), bitwise equal and finite, its device time and its
        four stages' (CUDA events), the loss, the peak device memory and
        the achieved TFLOP/s (the reference's dense FLOPs an example)."""
        reset_peak()
        out, cold = timed(lambda: model(b["dense"], b["sparse"]))
        again, warm = timed(lambda: model(b["dense"], b["sparse"]))
        loss, loss_ms = timed(lambda: float(model.loss(b)))
        nb = b["dense"].shape[0]
        dev_ms = time_ms(lambda: model(b["dense"], b["sparse"]), 5)
        # each stage alone on the forward's own intermediates
        cfg = model.cfg
        with torch.no_grad():
            bot = DL._bottom(model, b["dense"])
            emb = DL._lookup(cfg, model["tables"], b["sparse"]).to(bot.dtype)
            x = DL._interact(cfg, bot, emb)
            stages = {
                "bottom_mlp": time_ms(lambda: DL._bottom(model, b["dense"]),
                                      5),
                "lookup": time_ms(lambda: DL._lookup(
                    cfg, model["tables"], b["sparse"]), 5),
                "interaction": time_ms(lambda: DL._interact(cfg, bot, emb),
                                       5),
                "top_mlp": time_ms(lambda: GN._mlp(model["top"], x), 5)}
            del bot, emb, x
        row = {"case": label, "batch": nb,
               "multi_hot": model.cfg.multi_hot, "dtype": model.cfg.dtype,
               "cold_ms": cold, "warm_ms": warm, "device_ms": dev_ms,
               "loss": loss, "loss_ms": loss_ms,
               "gflop": nb * ex_flops / 1e9,
               "tflops_warm": nb * ex_flops / warm / 1e9,
               "tflops_device": nb * ex_flops / dev_ms / 1e9,
               "stages_device_ms": stages,
               "bitwise_repeat": bool(torch.equal(bits(out), bits(again))),
               "finite": bool(torch.isfinite(out).all()),
               "shape": list(out.shape),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "card": card}
        if not (row["bitwise_repeat"] and row["finite"]
                and row["shape"] == [nb] and math.isfinite(loss)):
            raise RuntimeError(f"phase 14 {label}: repeat bitwise "
                               f"{row['bitwise_repeat']}, finite "
                               f"{row['finite']}, shape {row['shape']}, "
                               f"loss {loss}")
        return out, row

    def dlrm_f64(row, model, b, out):
        """The float32 logits against float64 MLPs over the same float32
        tables (the gather is exact): within GNN_TOL·(|x| + max|x|)."""
        out64 = model.cast("float64", tables=False)(b["dense"], b["sparse"])
        share, err = gnn_share(out, out64)
        row.update(f64_worst_over_limit=share, f64_max_abs_err=err,
                   f64_scale=float(out64.abs().max()))
        if share > 1.0:
            raise RuntimeError(f"phase 14 {row['case']}: float32 against "
                               f"float64 {share} times the limit")

    # (a) serve_p99, (b) serve_bulk
    bulk = None
    served = {}             # phase 16 (e)'s inputs and direct outputs
    for shape in ("serve_p99", "serve_bulk"):
        nb = GC.RECSYS_SHAPES[shape]["batch"]
        b = GD.dlrm_batch(rm2, nb, seed=142, device=dev)
        out, row = dlrm_run(f"dlrm-rm2 {shape}", dlrm, b)
        reset_peak()
        dlrm_f64(row, dlrm, b, out)
        row["f64_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log14("serve", row)
        bulk = b
        served[shape] = (b, out)
        del out
    # beside the events' device time, the profiler's busy time of the
    # same forward (the two disagree where the trace drops kernels)
    p13_profile("dlrm-rm2 serve_bulk forward",
                lambda: dlrm(bulk["dense"], bulk["sparse"]), log14)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) retrieval_cand: one query against 1,000,000 candidates
    rshape = GC.RECSYS_SHAPES["retrieval_cand"]
    rb = GD.dlrm_batch(rm2, rshape["batch"], seed=143, device=dev)
    cand = torch.randn((rshape["n_candidates"], rm2.embed_dim),
                       generator=gen13(144), device=dev)
    reset_peak()
    scores, cold = timed(lambda: dlrm.retrieval_scores(
        rb["dense"], rb["sparse"], cand))
    again, warm = timed(lambda: dlrm.retrieval_scores(
        rb["dense"], rb["sparse"], cand))
    user = dlrm.user_vector(rb["dense"], rb["sparse"])
    err = float((scores - user @ cand.T).abs().max())
    top = torch.topk(scores[0], 10)
    r_flops = (2 * rshape["batch"] * rshape["n_candidates"] * rm2.embed_dim
               + rshape["batch"] * ex_flops)
    dev_ms = time_ms(lambda: dlrm.retrieval_scores(rb["dense"], rb["sparse"],
                                                   cand), 5)
    row = {"case": "dlrm-rm2 retrieval_cand", "batch": rshape["batch"],
           "n_candidates": rshape["n_candidates"], "cold_ms": cold,
           "warm_ms": warm, "device_ms": dev_ms,
           "bytes_gb": cand.numel() * 4 / 1e9, "gflop": r_flops / 1e9,
           "vs_user_dot_max_abs_err": err,
           "bitwise_repeat": bool(torch.equal(bits(scores), bits(again))),
           "finite": bool(torch.isfinite(scores).all()),
           "shape": list(scores.shape),
           "top10": [int(i) for i in top.indices],
           "top10_scores": [float(s) for s in top.values],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    log14("retrieval", row)
    if not (err <= 1e-5 and row["bitwise_repeat"] and row["finite"]
            and row["shape"] == [rshape["batch"], rshape["n_candidates"]]):
        raise RuntimeError(f"phase 14 retrieval: {json.dumps(row)}")
    # phase 16 (e): the serving workloads' steps on this model and tables
    phase16_rm2(torch, dlrm, served, (rb, cand, scores, user), card,
                lambda tag, row: (log(f"phase 16 {tag} " + json.dumps(row)),
                                  phase16_rows.append(dict(row, line=tag))))
    del rb, cand, scores, again, user, top, served

    # (d) K = 8 multi-hot at B 65,536 over the same tables, then the bag
    # kernel on each table against the model's lookup
    cfg8 = dataclasses.replace(rm2, multi_hot=8)
    dlrm8 = DL.DLRM(cfg8, dlrm.tree())
    b8 = GD.dlrm_batch(cfg8, RM2_BAGS, seed=145, device=dev)
    out, row = dlrm_run("dlrm-rm2 multi-hot K=8", dlrm8, b8)
    log14("multi-hot", row)
    del out
    tables = dlrm["tables"]
    with torch.no_grad():
        want8 = DL._lookup(cfg8, tables, b8["sparse"])
        want1 = DL._lookup(rm2, tables, bulk["sparse"])
        ids8 = [b8["sparse"][:, f, :].contiguous()
                for f in range(rm2.n_sparse)]
        ids1 = [bulk["sparse"][:, f:f + 1].contiguous()
                for f in range(rm2.n_sparse)]
        vec = {EB.vector_width(tables[f]) for f in range(rm2.n_sparse)}
        EB.reset_launches()
        worst, err8, bitwise1 = 0.0, 0.0, True
        for f in range(rm2.n_sparse):
            got = EB.embedding_bag(tables[f], ids8[f])
            rows_abs = tables[f][EB._wrap_indices(ids8[f], rm2.vocab)] \
                .abs().sum(dim=1)
            diff = (got - want8[:, f]).abs()
            worst = max(worst, float((diff / (
                8 * 2.0 ** -24 * rows_abs)).nan_to_num(0.0).max()))
            err8 = max(err8, float(diff.max()))
            bitwise1 &= bool(torch.equal(
                EB.embedding_bag(tables[f], ids1[f]), want1[:, f]))
        launched = EB.LAUNCHES["bag"]
        del got, rows_abs, diff, want1
        kernel_ms = time_ms(lambda: [EB.embedding_bag(tables[f], ids8[f])
                                     for f in range(rm2.n_sparse)], 5)
        lookup_ms = time_ms(lambda: DL._lookup(cfg8, tables, b8["sparse"]),
                            5)
        kernel1_ms = time_ms(lambda: [EB.embedding_bag(tables[f], ids1[f])
                                      for f in range(rm2.n_sparse)], 5)
        lookup1_ms = time_ms(lambda: DL._lookup(rm2, tables,
                                                bulk["sparse"]), 5)
    bag_check = {
        "case": f"dlrm-rm2 tables (26 × {rm2.vocab:,} × {rm2.embed_dim}), "
                f"K=8 at B {RM2_BAGS}; K=1 at B {bulk['sparse'].shape[0]}",
        "max_abs_err": err8, "worst_over_limit": worst,
        "tolerance": {"of": "the model's lookup", "K=8": "8·2^-24·Σ|rows|",
                      "K=1": "bitwise"},
        "k1_bitwise": bitwise1, "vector_widths": sorted(vec),
        "launches": launched, "ms_26_launches": kernel_ms,
        "model_lookup_ms": lookup_ms, "k1_ms_26_launches": kernel1_ms,
        "k1_model_lookup_ms": lookup1_ms, "card": card}
    log14("bag on DLRM's tables", bag_check)
    if worst > 1.0 or not bitwise1 or launched != 2 * rm2.n_sparse:
        raise RuntimeError(f"phase 14: the bag kernel on DLRM's tables: "
                           f"{worst} times the K=8 limit, K=1 bitwise "
                           f"{bitwise1}, {launched} launches")
    del dlrm8, b8, want8, ids8, ids1, tables, dlrm
    gc.collect()
    torch.cuda.empty_cache()

    # (e) bfloat16 tables at serve_bulk (the float32 tables freed first),
    # against the float32 forward over the same tables rounded
    bf_cfg = dataclasses.replace(rm2, dtype="bfloat16")
    reset_peak()
    bf = DL.dlrm_init(bf_cfg, gen13(141), device=dev)
    out, row = dlrm_run("dlrm-rm2 serve_bulk, bfloat16 tables", bf, bulk)
    row["tables_gb"] = bf["tables"].numel() * 2 / 1e9
    ref32 = bf.cast("float32")
    with torch.no_grad():
        lk_bf = DL._lookup(bf_cfg, bf["tables"], bulk["sparse"])
        lk_32 = DL._lookup(rm2, ref32["tables"], bulk["sparse"])
        lookup_bitwise = bool(torch.equal(lk_bf.float(), lk_32))
        del lk_bf, lk_32
        out32 = ref32(bulk["dense"], bulk["sparse"])
    share, err = gnn_share(out, out32)
    row.update(lookup_bitwise=lookup_bitwise,
               vs_f32_worst_over_limit=share, vs_f32_max_abs_err=err,
               vs_f32_bitwise=bool(torch.equal(bits(out), bits(out32))))
    log14("bfloat16", row)
    if not lookup_bitwise or share > 1.0:
        raise RuntimeError(f"phase 14 bfloat16: lookup bitwise "
                           f"{lookup_bitwise}, logits {share} times the "
                           f"limit")
    del bf, ref32, out, out32, bulk
    gc.collect()
    torch.cuda.empty_cache()
    phase14_s = time.perf_counter() - t14
    log(f"phase 14: {phase14_s:.1f} s")
    record["phase14"] = phase14_rows
    record["phase14_s"] = phase14_s

    # Phase 15: training, after phase 14's memory is freed
    phase15(torch, dev, card, record, log, bits, reset_peak)
    # Phase 16: the serving workloads at full width, the dry-run's records
    phase16(torch, dev, card, record, log, dry, phase16_rows)

    # the contract's kernel line: times of the weighted-PageRank round with
    # every source active (the push− main path's shapes)
    ref_case = [c for c in cases if c["graph"] == "rmat16"
                and c["round"] == "WPR" and c["density"] == 1.0][0]
    kernels = []
    for kname in ("pull", "push", "resolve"):
        c = ref_case[kname]
        kernels.append({
            "name": f"{kname}_kernel", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[kname],
            "launches": launches[kname], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "case": "weighted PageRank round, all sources active, "
                    f"rmat_graph({n16}, {e16}, seed=16)"})
    # the pull kernel's line is its derived-activity mode (an idempotent
    # pull iteration); beside it the given-activity mode and the parent's
    # pair (the torch tile activity, then the sweep)
    given = ref_case["pull_given"]
    kernels[0].update(mode="derived activity", given_ms=given["ms"],
                      given_bound_ms=given["bound_ms"],
                      pair_ms=ref_case["pull"]["pair_ms"])
    # beside each, its batched launch: BATCH slots of the same round and
    # density in one launch, against BATCH solo launches
    batch_ref = [c for c in batch_cases if c["graph"] == "rmat16"
                 and c["round"] == "WPR" and c["density"] == 1.0][0]
    for row in kernels:
        kname = row["name"].removesuffix("_kernel")
        c = batch_ref[kname]
        row["batched"] = {
            "slots": BATCH, "ms": c["ms"], "solo_ms": c["solo_ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "max_abs_err": c["max_abs_err"],
            "launches": sum(r["launches"][kname] for r in phase7_rows)}
        # and its launches in phase 8's delta queries
        row["incremental_launches"] = sum(r["launches"][kname]
                                          for r in phase8_rows)
        # and in phase 9's serving traces
        row["serving_launches"] = serving_launches[kname]
        # and in phase 10's sharded queries (every shard's launches)
        row["sharded_launches"] = sum(r["launches"][kname]
                                      for r in phase10_rows
                                      if "launches" in r)
    kernels[0]["batched"].update(
        given_ms=batch_ref["pull_given"]["ms"],
        given_solo_ms=batch_ref["pull_given"]["solo_ms"],
        given_bound_ms=batch_ref["pull_given"]["bound_ms"],
        timed_with_haspred=batch_ref["timed_with_haspred"])
    for kname, label in (("level", "rmat16 float n+w"),
                         ("softmax", "rmat16 in-layout"),
                         ("bag", "float32 table K=1 sum"),
                         ("flash_sm90",
                          "llama3.2-3B bfloat16 S=T=4096 causal"),
                         ("flash_f32", "llama3.2-3B float32 S=T=1024 causal")):
        c = [c for c in entry_cases[kname] if c["case"] == label][0]
        kernels.append({
            "name": KERNEL_NAMES.get(kname, f"{kname}_kernel"),
            "route": "cuda",
            "source": SOURCES[kname], "replaces": REPLACES[kname],
            "launches": phase_launches[kname],
            "serving_launches": serving_launches.get(kname, 0),
            **{key: c[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "cuda_core_bound_ms",
                                       "bound_all_slots_ms", "yardstick_ms",
                                       "registers", "local_bytes",
                                       "narrow_registers",
                                       "narrow_local_bytes")
               if key in c},
            "case": label})
    # no model path launches flash; phase 12's check of it on the LM's
    # own layer-0 prefill tensors goes beside its row
    (flash_row,) = [k for k in kernels if k["name"] == "flash_sm90_kernel"]
    flash_row["model_check"] = {k: flash_check[k] for k in (
        "case", "max_abs_err", "worst_over_limit",
        "vs_float64_worst_over_limit", "tolerance", "ms", "lm_attention_ms")}
    # nor the softmax: phase 13's check of it on GAT's own layer-0 logits
    (softmax_row,) = [k for k in kernels if k["name"] == "softmax_kernel"]
    softmax_row["model_check"] = {k: softmax_check[k] for k in (
        "case", "max_abs_err", "worst_over_limit", "tolerance",
        "ms_per_head", "ms_all_heads", "bound_ms_per_head",
        "bound_all_slots_ms_per_head", "model_softmax_ms")}
    # nor the bag: phase 14's check of it on DLRM's own tables and ids
    (bag_row,) = [k for k in kernels if k["name"] == "bag_kernel"]
    bag_row["model_check"] = {k: bag_check[k] for k in (
        "case", "max_abs_err", "worst_over_limit", "tolerance", "k1_bitwise",
        "ms_26_launches", "model_lookup_ms", "k1_ms_26_launches",
        "k1_model_lookup_ms")}
    record["kernels"] = kernels
    try:
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(record,
                                                            indent=1))
    except OSError:
        pass
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    finally:
        stop_children()
    sys.exit(rc)
