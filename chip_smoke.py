#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (cloudberry_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # TPC-H SF1 seed 1, TPC-DS scale 100

Phases (any failure exits non-zero, and nothing is caught and passed over).
Phases 3 to 6 and 9 run at a 16 GiB per-query memory budget
(``resource.query_mem_bytes``), an operator's setting for an 80 GB card:
at the reference's default of 4 GiB four of their statements are refused
(phase 7). Phases 3 to 10 empty the session's statement cache and generic
plans before every statement (``EmptyCaches``), and run with generic plans
off (the port's default), so each of their runs parses, plans and builds
its Executable as before the caches existed; phase 11 measures the caches.

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: nvcc compiles the kernels of cloudberry_tpu_torch/csrc (one
   process per source, in parallel) into cloudberry_tpu_torch/build/;
3. TPC-H: Q1, Q3 and Q5 through ``Session()`` on CUDA. Each query runs
   once to warm up (and to record the inputs each kernel gets), then once
   more with the kernel launch counts set to 0 just before and read just
   after; the counts must show dense_agg on Q1 and Q5, sorted_seg on Q3 and
   probe_join on Q5. Each result must equal, exactly, a numpy oracle written
   here and the same query run by a ``Session(device="cpu")`` of the port
   (the kernels' plain versions). Four more runs of each query give the
   spread of its wall time;
4. TPC-DS: the 30 queries of ``cloudberry_tpu_torch/tpcds.py`` over
   tpcds-lite at scale 100, seed 0 (3,000,000 store_sales rows). A warm-up
   run holds every kernel call against its plain version on the same
   inputs; then a run with the launch counts zeroed before and read after,
   whose result must equal the CPU run of the port (NULLs included; ints,
   DECIMALs, dates and strings exactly, floats within rtol 1e-9 plus 1e-12
   times the column's sum of magnitudes) and reach the same kernels. The
   window queries (q12, q20, q36, q86, q98) get five timed runs each;
5. windows at scale: ``tpcds.WINDOW_QUERY`` (every window function family
   and frame kind) over all 3M store_sales rows, then over an empty
   selection and over one row, each equal to the CPU run; its wall time
   and the peak device memory;
6. growth: a skew join of 1,200,000 probe rows (25 % on one key, which the
   build holds 12 times) whose true pair count exceeds the planner's
   estimate: the join's buffer must grow (``growth_events``), and the
   count and sum must equal numpy's;
7. admission at the default 4 GiB budget, planning only where admitted:
   exactly TPC-DS q27, q59 and q74 and the window query (all three
   selections) must raise ResourceError (their plans cannot stream, as in
   the reference), every other statement of phases 3 to 5 and the skew
   join after its growth must be admitted;
8. tiling from RAM, on phase 3's and 4's tables: Q1 at 128 MiB, Q3 at
   512 MiB and Q5 at 256 MiB (TPC-H SF1), and WIN_DS, SORT_DS and TOPN_DS
   at 128 MiB (scale 100; budgets scale with --sf and --ds-scale); each
   must tile with the reference's mode, tile rows, tile count and
   accumulator capacity (at full size), equal its one-shot run (Q1/Q3/Q5
   also the numpy oracle, Q1's averages in the tiled finalize's order and
   within 2 ulp of the one-shot run; WIN_DS sorted by every column, floats
   as in phase 4), launch every kernel the one-shot run launched, never
   copy the streamed table to the device whole, and keep its peak device
   bytes above the resident baseline under the budget.
   One extra run holds every kernel call against its plain version. Q3 at
   256 MiB and Q18 at 512 MiB must raise ResourceError. Q3 at 512 MiB runs
   with the in-flight window 1 and 4 and the scan pipeline off and on,
   bit-identical; the deferred-overflow query of the JAX package's
   tests/test_tilepipe.py (200,000 rows, k % 7000, 4 MiB) must count a
   deferred overflow and a window replay at window 4 and equal window 1;
   a second overflow query (500,000 rows, few groups in the first
   400,000, a checkpoint every 2 tiles) must resume from a checkpoint at
   window 4 and equal window 1 and numpy.
   Per run: wall ms against the one-shot wall, tiles, tile rows, per-tile
   ms (mean, p95), the scan pipeline's stall, decode, read and overlap,
   the drain stall, the in-flight depth, the step and pipeline estimates,
   the peak and the launches per tile;
9. storage: the host packages that import (zstandard, cryptography,
   pandas) and the native codec, which must have built with g++ and
   loaded. All eight TPC-H tables written through a store-backed
   ``Session`` into a fresh ``storage.root`` in a temporary directory
   (removed at the end), lineitem once more with PARTITION BY RANGE
   (l_shipdate), one 365-day range a year from 1992-01-01 in days since
   1970, and customer's key, nation, balance and segment columns in a
   seeded random row order in 512-row micro-partitions; each table's
   manifest size and read time. Q1, Q3 and Q5 then run from fresh
   sessions, every table cold, in four tiers each: a cleared cache scope
   (host read, decode, upload), a second session (the buffer pool
   admits), a third (pool-served), and that session again (the
   store-scan cache where an entry fits beside the pool in
   ``bufferpool.max_bytes``, else the pool). Every tier must equal the
   numpy oracle and phase 3 exactly, launch the kernels phase 3 launched
   and keep the pool and the scan cache within ``bufferpool.max_bytes``;
   one more run holds every kernel call against its plain version. Per
   tier: wall ms, partitions read and decoded, read-and-decode MB/s,
   manifest and footer reads and their host ms, pool hits, misses,
   admits, evictions, refusals and resident bytes, scan-cache hits,
   refusals and bytes. Pruning: Q1 and Q3 on the partitioned lineitem
   (prune reports and kernel input sizes; equal to the unpartitioned
   run) and a c_custkey point lookup that the footer blooms prune. Join
   index: Q3 and Q5 twice in a RAM session; the second run must use the
   cached index, which must equal ``kernels.build_sort`` on the device,
   whose time is printed. Tiling from the store: Q1 at 128 MiB and Q3 at
   512 MiB from a cleared cache scope (cold), a second session (the pool
   admits) and a third (pool-served), each equal to the numpy oracle with
   the one-shot kernels (a store-backed plan sees only the manifest's
   statistics, so its decisions are printed, not held); then Q1 on
   lineitem_p with every other partition dropped from the pool, whose
   range partitions do not line up with the tiles: some tile must hold
   pooled and decoded rows in one column (assembled on the device), and
   the result must equal the numpy oracle. DML last, each
   against numpy: COPY FROM of the first COPY_ROWS (200,000)
   SF1 orders as a '|'-delimited file, COPY TO (the same bytes) and back,
   COPY with SEGMENT REJECT LIMIT and LOG ERRORS over four bad lines,
   CREATE TABLE AS of Q3's join, INSERT ... SELECT, UPDATE orders and
   DELETE FROM lineitem; a fresh session must see every change. Phase 11's
   store repeats run here, on Q3's and Q5's pool-served session;
10. telemetry, on phase 3's and 4's tables: EXPLAIN ANALYZE of Q1, Q3, Q5
   and TPC-DS q98 (its kernel calls held against their plain versions),
   whose node text (timings stripped) must equal a ``Session(device=
   "cpu")`` run's, whose root ``rows=`` must equal the statement's row
   count and whose launches must equal the plain ``sql`` run's; the
   host-time split of 10 runs each of Q1/Q3/Q5 (the parse, plan,
   queue_wait and launch stage histograms, p50 and p95, and the exact
   span medians from the traces), with EXPLAIN ANALYZE's compile_s at its
   first call and later; obs on against off, 10 interleaved runs each,
   medians; Q5's trace root covering >= 95 % of its wall, the Chrome
   trace written to chiprun_out/telemetry_q5_trace.json; the tiled Q1
   with one ``tile_seconds`` sample per tile and progress climbing to
   exactly 1.0; RunawayError on the skew join with
   ``resource.total_mem_bytes`` between its first and grown estimates
   (and no tiling); two threads running the tiled Q1 in an
   ``ACTIVE_STATEMENTS 1`` resource queue, the second waiting; and a
   flight bundle for Q3 with ``obs.slow_ms`` at 1 whose result digest
   equals the CPU run's;
11. statement cache and generic plans, on phase 3's tables in a fresh
   CUDA session: Q1, Q3 and Q5 once (a miss and a generic build), then 10
   exact repeats each, every one a statement-cache hit with no parse or
   plan span and no ``compile_plan`` call, launching phase 3's kernels
   and equal to the numpy oracle (the host-time split of the repeats, as
   in phase 10); perturbed literals (Q1's and Q3's from the JAX package's
   tests/test_generic_parity.py, Q5's date and region), each a generic
   hit with no build and no ``compile_plan`` call, bit-identical to a
   CUDA session with ``sched.generic_plans`` off and equal to the CPU
   run; 10 interleaved pairs of distinct-literal texts per query with
   generic plans on and off (the statement cache missing), medians; the
   tiled Q1 at 128 MiB twice, the second run a statement-cache hit equal
   to the first; 5 exact repeats of Q3 and Q5 on phase 9's pool-served
   session (no manifest read); invalidation: an INSERT into a cached
   statement's table re-plans it, a re-registered UDF misses the cache,
   a generate_series join and a registered table function re-run at
   every statement; a tensor UDF and a dictionary-rewrite UDF in a
   Q1-shaped aggregate, equal to the CPU run; one run of each query's
   cached and rebound path with every kernel call held against its plain
   version;
12. distributed (``n_segments > 1``: a gang of segment lowerers on the
   one card, motions exchanged on the card): the 22 TPC-H texts over all
   eight tables of phase 3's data at 8 segments, each equal to a
   one-segment CUDA session's result (ints, DECIMALs and strings exactly,
   floats within the gate above, since partial sums reorder), Q1/Q3/Q5
   also equal to the numpy oracle (Q1's averages in the two-stage
   finalize's order) and to an 8-segment CPU session of the port;
   TPC-DS q17/q25/q29 at scale 100 over 8 segments, each equal to phase
   4's one-segment run; at SF1 (``--dist-sf``; BASELINE.md's config is
   SF10, cut to fit the time limit) TPC-H Q5 and Q9 over 4 segments, each
   equal to a one-segment CUDA run at a 64 GiB budget and red line that
   admit it. The first 8-segment run of each statement holds every
   kernel call against its plain version; a counted run gives the
   launches. Per statement at 8 (4) segments and at one: the wall (one
   timed run) and its host-time split, the peak device bytes
   against the admission estimate times nseg, and per redistribute the
   bucket rung against the observed demand, the skew ratio, the wire
   bytes and the exchange's device-synchronized time. Motion behaviour:
   a skewed redistribute (200,000 probe rows, 75 % on one key behind a
   projection) that must promote its rung once and equal numpy; the
   exact and the digest runtime filter (1,000,000 probe rows), each
   equal to the filter off, with fewer rows out than in; a point query
   on ``l_orderkey`` that direct dispatch routes to one segment, equal
   to numpy and one segment; EXPLAIN ANALYZE of Q3 and Q5 at 8 segments
   whose text (timings stripped) equals the 8-segment CPU run's;
13. tiled distributed (an admission-refused statement at 8 segments tiled
   over the gang, exec/tiled_dist.py), every statement with
   ``debug.verify_plans`` on: ``verify_plan`` over phase 12's 22 TPC-H
   plans at 8 segments (planning only) with no finding; TPC-H SF1 Q1,
   Q3 and Q5 at per-segment budgets of 32, 96 and 48 MiB (scaled with
   --sf; Q9 and Q18 refuse there in both engines), each with the
   reference's mode, tile rows, tiles per segment (at least 4) and
   accumulator at full size, equal to phase 12's one-shot 8-segment
   result and to the numpy oracle (Q1's averages in the finalize's
   order); TPC-DS TOPN_DS and SORT_DS at 16 MiB and WIN_DS at 256 MiB
   (scale 100) at 8 segments, each equal to its one-segment run (WIN_DS
   sorted by every column); the JAX package's tests/test_feedback.py
   join-group shape (85 % of the fact rows on one join key, no
   broadcast) at 4,000,000 fact rows and 32 MiB: exactly one
   mid-statement replan that resumes from its checkpoint, and with the
   ``tile_replan`` fault skipped no replan, both equal to the in-memory
   run; the late accumulator overflow of tests/test_torch_dist_recovery.py
   at 5x its rows (22,000,000; the late keys' domain and the modulus
   5x too) at 16 MiB, a checkpoint every 2 tiles, windows 1 and 4: the
   window-4 run must resume from a checkpoint and both equal numpy. The
   first tiled run of each TPC-H/TPC-DS statement holds every kernel
   call against its plain version; a counted run gives the launches,
   and every kernel must launch in the phase. Per statement: the wall
   (median of 2, beside the one-shot 8-segment run's), tiles per segment
   and tile rows, the per-tile host ms (mean, p95), the exchange ms per
   tile (every exchange timed between device synchronizations in one
   extra run) and the peak device bytes, which less the buffer pool's
   admissions must stay under budget x 8, with the blocks live at a
   traced run's peak summed by allocating line;
14. recovery and topology, on phase 13's TPC-H tables and budgets at 8
   segments with a checkpoint every 2 tiles and ``debug.verify_plans``
   on: the health probe of the 8 segment slots on the card (its median
   ms over 20, and 7 slots with ``probe_degraded``); a CUDA runtime error
   and an out-of-memory error never re-dispatch; Q1, Q3 and Q5 tiled,
   uninterrupted (every kernel call held against its plain version), then
   killed through the ``tile_device_lost`` seam at tile 0, mid and last:
   each counted run must recover once, replay at most K = 2 tiles
   (``tiles_replayed``, the reference's bound) and resume from a
   checkpoint wherever a drained one existed, and equal the uninterrupted
   run; Q3 and Q5 killed mid-stream with ``probe_degraded`` armed must
   finish on 7 segments equal to the uninterrupted 8-segment run — Q5
   resuming from its checkpoint with the remaining rows re-sharded by the
   placement hash, Q3 (a one-stage aggregate on the distribution key,
   whose partials cannot re-place) declining the resume and re-running
   fresh, as the reference does — and two clean probes then expand the
   cluster back to 8; a planned online expand 8 -> 12
   (``begin``/``rebalance``/``cutover``) and the shrink back, each moving
   at most 1.25x the jump hash's minimal bound of rows, with Q5 at each
   epoch equal to the 8-segment run. Per run: the wall against the
   uninterrupted wall, the resume tile, tiles re-run, the recovery
   counters and the launches; per resize: the rows moved against the
   bound, the rebalance's seconds and the cutover's ms;
15. SQL surface, at TPC-H SF1 (``sql_surface_phase``): (a) in RAM,
   BEGIN, an INSERT … SELECT of about 100,000 lineitem rows and an UPDATE
   of orders; Q1, Q3 and Q5 inside the transaction must equal the numpy
   oracle on the changed data and, after ROLLBACK, the pre-transaction
   results bit for bit; a dropped, re-created and filled nation rolls
   back with its device copy dropped; (b) on a store, a COMMIT seen by a
   second session, a conflicting rewrite refused with
   ``SerializationError`` and two concurrent appends merged; (c) a plain
   materialized view over lineitem grouped by (l_returnflag,
   l_linestatus, l_shipdate) answers a Q1-shaped query (EXPLAIN shows
   AQUMV) equal to the run with ``planner.enable_aqumv`` off, and an
   INCREMENTAL view over a NOT NULL copy merges an INSERT of about
   60,000 rows, an UPDATE and a DELETE with no refresh, equal to a fresh
   REFRESH; (d) CLUSTER of store-backed orders by (o_orderdate,
   o_custkey): a range on o_custkey reads fewer partitions after, with an
   equal result; (e) a file:// external customer (its 150,000 rows and
   10 bad lines under a reject limit) and a sqlite foreign supplier, each
   joined to nation, equal to the RAM tables; a directory table's upload
   and read under TDE; (f) at 8 segments, a parallel retrieve cursor over
   about 100,000 filtered lineitem rows drained by 8 threads equals the
   direct result, a join cursor likewise, an ORDER BY … LIMIT falls back
   to one endpoint, and CLOSE releases the reservation. Each part's
   statement walls are printed; some runs hold every kernel call against
   its plain version, and the counted runs must launch all three kernels;
16. serving, over phase 9's store as its DML left it (``serving_phase``;
   the copies phase 9 made are dropped first): (a) a ``Server`` on CUDA
   with the event-loop front end and a backend ``Session`` per
   connection; 8 client threads send Q1, Q3, Q5 and Q1 at two more ship
   dates, every wire response equal to the numpy oracle as the server
   renders it (DECIMAL, COUNT, dates and averages exactly), the counted
   run launching all three kernels; peak device bytes with 1 and 8
   connections, the backends' one store-scan cache and the shared
   buffer pool within ``bufferpool.max_bytes``; the wire wall against
   ``Session.sql``'s for Q1, Q3, Q5;
   (d) 10,000 rows by wire appends from 4 connections equal to the same
   rows as INSERT statements; (e) two connections' transactions, the
   rewriting COMMIT refused with ``SerializationError``; (f) ``meta``
   metrics, activity, ingest, topology, sched and tenants; (g)
   ``stop(drain_s)`` under 8 clients' load: every accepted request
   answered, later ones refused with the retryable ``ServerDraining``;
   then a shared-session server with the dispatcher and generic plans on
   and tenants gold:silver at 3:1: (b) 16 Q1-shaped requests and 16
   lineitem point lookups at once go in stacked batches, each equal to
   its own sequential run, ``batched_statements`` > 0, at most 5 rung
   runners, ``dense_agg`` launched once per Q1 lane; the skeleton's
   stacked QPS over 5 rounds of 16 against one connection's sequential
   QPS over as many; (c) 12 connections per tenant of point lookups,
   every result right, the share reported; closed-loop QPS with p50/p99
   over 100 requests each, at 1, 8 and 32 connections for a point
   lookup and at 1 and 8 for Q1; (h) ``python -m cloudberry_tpu_torch
   --store ROOT serve`` in a child process (started at the phase's
   start), queried once by ``sql --connect``, then drained by SIGINT;
17. durability and management, over phase 9's store as phases 9 and 16
   left it (``durability_phase``): (a) ``fsck --deep`` of the untouched
   store is clean, and Q1, Q3 and Q5 from it equal the numpy oracle, every
   kernel call held against its plain version; (b) one forced
   compaction pass over lineitem (5,997,925 rows, every partition
   carrying phase 9's delete vector) and the threshold pass over
   ev_append's 25 group commits: rows, chunks, partitions before and
   after and seconds, then Q1, Q3 and Q5 equal to (a) bit for bit and
   ``fsck --deep`` clean again; (c) the crash-torture harness kills a
   ``serve`` child on CUDA at ``compact_commit`` on a small store of its
   own: no acknowledged write lost, fsck clean, the orphans collected,
   the restart's time to first answer; (d) the port's cbfdist serves
   customer's 150,000 lines to an external table at 8 segments, equal
   to the same file through file://; (e) the MCP server answers
   ``execute_query`` with Q1's text as ``Session.sql`` does and refuses
   an UPDATE; (f) a Q3 flight bundle captured at 8 segments replays in a
   fresh session to the same digest; (g) 8 wire clients send Q1, Q3, Q5
   and point lookups to a 4-segment server over the SF1 tables in RAM
   through ``online_resize(8)`` and a failover shrink to 7: none
   dropped, every answer equal to the static 4-segment run, the cutover
   ms and the rows moved against the bound. Every kernel must launch in
   the phase's counted runs;
18. two-level and ring motion, at TPC-H SF1 over 8 segments (phase 12's
   tables; phase 12's flat 8-segment results are the oracle, bit for
   bit, floats included): (a) ``interconnect.backend="ring"`` on the 22
   texts, and Q3 and Q9 with ``ring_chunks`` 4; (b) ``CBTPU_FORCE_HOSTS=4``
   (4 simulated hosts of 2 segments) at the default ``hierarchical="auto"``
   on the 22 texts with ``debug.verify_plans`` on: at least one
   redistribute stamped and one merge motion host-combined; per text the
   redistributes stamped and host-combined, the host rungs against the
   observed host demand, the transport's permutations and the wall
   against phase 12's flat wall; (c) ``CBTPU_FORCE_HOSTS=2`` with
   ``hierarchical="on"`` on Q1, Q3, Q5, Q9 and Q18; (d) phase 12's skewed
   redistribute under 4 hosts with ``hierarchical="on"`` records
   ``host_skew_events`` and equals numpy; its largest uncombined two-level
   redistribute, the host rung forced to 8 rows, overflows naming the
   motion, grows to the observed demand's rung and re-runs equal to
   numpy; (e)
   tiled Q3 at phase 13's budget under 4 hosts (two-level transport)
   equals the flat run and the numpy oracle; (f) the three two-level
   mutation classes, each caught under its own rule on (b)'s plan. Each
   text's first run holds every kernel call against its plain version,
   and every kernel must launch in the phase's counted runs;
19. the two-process cluster on the one card: two child processes
   (``chip_smoke.py --cluster-child``) join one cluster through
   ``init_distributed`` (CBTPU_COORDINATOR on 127.0.0.1, gloo), each
   with ``Session(Config(n_segments=8), device="cuda")`` owning 4 of the
   8 segments over phase 12's SF1 tables (pickled once by this process)
   and tests/multihost_worker.py's tables; each runs that worker's three
   statements and TPC-H Q1, Q3, Q5, Q9 and Q18 flat
   (``hierarchical="off"``) and at ``hierarchical="on"`` over the two
   real hosts (no CBTPU_FORCE_HOSTS), every result (the warm-up's and
   the counted run's) equal bit for bit to phase 12's one-process
   8-segment result (the worker's statements: to this process's), so
   equal across the children and between flat and two-level; each
   child must launch every kernel the one-process run of a text
   launched, and the bytes both children hand to ``torch.distributed``
   for each redistribute must equal ``flat_wire_model`` (flat) or
   ``two_level_wire_model`` (two-level). Per text: each child's wall
   against phase 12's flat wall, launches and bytes; per child its peak
   device bytes. Each child has 4 local slots (CBTPU_LOCAL_SLOTS), and
   the same two children then run, flat: (a) the ring
   (``interconnect.backend="ring"``) over the same texts, each result
   equal bit for bit to phase 12's (which phase 18's one-process ring
   run equals), every redistribute's gloo bytes equal to
   ``flat_wire_model``; (b) TPC-H Q1 and Q3 tiled at phase 13's budgets,
   each report ``tiled`` and ``distributed`` with more than one tile,
   equal to phase 12's one-shot result as phase 13 holds its tiled runs
   (floats within FLOAT_RTOL) and equal bit for bit across the
   children; (c) ``degrade_mesh(7, [0, 1, 2, 4, 5, 6, 7])`` (3 + 4
   segments), then Q1, Q3 and Q5, each equal bit for bit to this
   process's 7-segment run over the same survivors; (d) a session
   started at 6 segments (4 + 2) and expanded online to 8 (4 + 4), Q5
   before equal to this process's static 6-segment run and after to
   phase 12's, the children's ``moved_rows`` summed against the
   minimal-movement bound. Per part: its wall, each child's peak device
   bytes, launches and bytes to gloo. A child that fails or outlives its
   timeout fails the phase;
20. kernels: each kernel, on the inputs the TPC-H path gave it and on
   synthetic inputs at the main path's shapes plus edge cases (empty
   selection, ragged N, int64 wraparound, duplicate build keys, one hot
   cell, cell domains for each of dense_agg's modes, a skewed group, odd
   capacities; for probe_join multi-column, out-of-range, negative, bool,
   int32 and float keys, mixed payload dtypes, an empty build selection,
   key spans whose product is 2^32), must equal its plain version on the
   card; then its median time over 20 cold-cache runs on the device alone
   (``Timer.device``) and with the wrapper's host work (``wrapper_ms``),
   beside its plain version's, one PyTorch library call computing the same
   function, and its bound (bytes over 3.35 TB/s or operations over 67
   T/s, whichever is larger). The probe-join operator is also timed as it
   was before its fused kernel (key packing in PyTorch around the kernel)
   and as the executor's sorted lookup, and each Q5 probe join is traced
   with torch.profiler (after a warm-up trace, and again where a counted
   launch left no device activity in its trace): it must be one device
   kernel;
21. report: the card line, one JSON line of kernels (launches summed over
   the counted runs of phases 3 to 19, the cluster children's included),
   and last the JSON line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12      # H100 SXM non-tensor float32 peak
REPLACES = {
    "dense_agg": "cloudberry_tpu/exec/pallas_kernels.py:84",
    "probe_join": "cloudberry_tpu/exec/pallas_kernels.py:150",
    "sorted_seg": "cloudberry_tpu/exec/pallas_kernels.py:332",
}
SEED = 1          # TPC-H data and the synthetic kernel inputs
REPS = 20         # timed launches per kernel
QUERY_RUNS = 5    # timed runs per query, tables already on the card
EXPECTED = {"q1": {"dense_agg"}, "q3": {"sorted_seg"},
            "q5": {"dense_agg", "probe_join"}}
DS_SCALE = 100    # tpcds-lite: 3,000,000 store_sales rows
DS_SEED = 0
WINDOWED = ("q12", "q20", "q36", "q86", "q98")
FLOAT_RTOL = 1e-9
ATOL_PER_MAGNITUDE = 1e-12
SKEW_ROWS = 1_200_000
# Phases 3 to 6 and 9 run at a 16 GiB per-query budget (query_mem_bytes),
# an operator's setting for an 80 GB card. At the reference's default of
# 4 GiB, TPC-DS q27, q59 and q74 and the window query (phase 5, all three
# selections) are refused with ResourceError in both engines (their plans
# cannot stream); phase 7 checks exactly that.
CARD_BUDGET = 16 << 30
DEFAULT_BUDGET = 4 << 30
DEFAULT_REFUSED = ("q27", "q59", "q74")
# the tiling phase: per-query budgets in MiB at TPC-H SF1 and tpcds-lite
# scale 100 (scaled with --sf and --ds-scale), and the decisions the
# reference takes there (mode, tile rows, tiles, accumulator capacity;
# tests/test_torch_admission.py pins both engines to them on the CPU)
TILED_TPCH = {"q1": (128, (None, 524_288, 12, 8)),
              "q3": (512, (None, 524_288, 12, 1_880_181)),
              "q5": (256, (None, 524_288, 12, 25))}
REFUSED_TPCH = (("q3", 256), ("q18", 512))
SORT_DS = ("SELECT ss_ticket_number, ss_item_sk, ss_net_profit FROM "
           "store_sales JOIN date_dim ON ss_sold_date_sk = d_date_sk "
           "WHERE d_year = 2000 ORDER BY ss_net_profit DESC, "
           "ss_ticket_number, ss_item_sk")
TILED_DS = {
    "WIN_DS": ("SELECT ss_store_sk, ss_ticket_number, ss_quantity, rank() "
               "over (partition by ss_store_sk order by ss_quantity desc) "
               "AS r, sum(ss_net_profit) over (partition by ss_store_sk) "
               "AS sp, avg(ss_ext_sales_price) over (partition by "
               "ss_store_sk order by ss_ticket_number rows between 2 "
               "preceding and current row) AS aw FROM store_sales JOIN "
               "date_dim ON ss_sold_date_sk = d_date_sk WHERE d_year = 2000",
               128, ("window", 262_144, 12, 0)),
    "SORT_DS": (SORT_DS, 128, ("sort", 524_288, 6, 0)),
    "TOPN_DS": (SORT_DS + " LIMIT 100", 128, ("topn", 524_288, 6, 100)),
}
TILED_STORE = ("q1", "q3")
DEFERRED_ROWS = 200_000   # the reference test's deferred-overflow table
# the telemetry phase: runs per query for the stage split and for obs
# on/off, the stage histograms and the trace spans they correspond to
TELEMETRY_RUNS = 10
STAGES = ("parse", "plan", "queue_wait", "launch")
TRACE_STAGES = ("parse", "plan", "queue-wait", "launch")
# the statement-cache phase: exact repeats per query, interleaved generic
# on/off pairs per query, exact repeats from the store; literal swaps that
# rebind (JAX tests/test_generic_parity.py for Q1 and Q3), and per query
# the literal that the on/off pairs vary over distinct texts
STMT_REPEATS = 10
GENERIC_PAIRS = 10
STORE_REPEATS = 5
PERTURBED = {
    "q1": [("'1998-12-01'", "'1998-11-15'")],
    "q3": [("'1995-03-15'", "'1995-03-01'")],
    "q5": [("'1994-01-01'", "'1995-01-01'"), ("'ASIA'", "'EUROPE'")],
}
DISTINCT = {"q1": ("'1998-12-01'", "'1998-10-{:02d}'"),
            "q3": ("'1995-03-15'", "'1995-02-{:02d}'"),
            "q5": ("'1994-01-01'", "'1994-02-{:02d}'")}
WINDOW_CASES = (("full", "d_year >= 1998"),
                ("empty selection", "d_year = 1900"),
                ("one row", "ss_ticket_number = 777"))


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


class StackSampler:
    """``--host-profile``: a daemon thread samples the main thread's
    Python stack every ``interval`` seconds and charges the wall since
    the last sample to the innermost frame of this script (its function
    and line), to the innermost frame of all (self time) and to every
    function on the stack once (inclusive time); ``dump`` writes the
    largest of each, in seconds, as JSON."""

    def __init__(self, interval=0.01):
        import threading

        self.interval = interval
        self.main = threading.main_thread().ident
        self.script = os.path.abspath(__file__)
        self.tables = {"script_line": {}, "self": {}, "inclusive": {}}
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="chip-smoke-sampler")

    def start(self):
        self.thread.start()
        return self

    def _run(self):
        last = time.perf_counter()
        while not self.stop.wait(self.interval):
            now = time.perf_counter()
            dt, last = now - last, now
            frame = sys._current_frames().get(self.main)
            if frame is None:
                continue
            seen, line, inner = set(), None, None
            while frame is not None:
                code = frame.f_code
                where = f"{os.path.basename(code.co_filename)}:" \
                    f"{code.co_name}"
                inner = inner or f"{where}:{frame.f_lineno}"
                if line is None and code.co_filename == self.script:
                    line = f"{code.co_name}:{frame.f_lineno}"
                seen.add(where)
                frame = frame.f_back
            for table, keys in (("script_line", [line]), ("self", [inner]),
                                ("inclusive", seen)):
                t = self.tables[table]
                for k in keys:
                    t[k] = t.get(k, 0.0) + dt

    def dump(self, path, top=150):
        self.stop.set()
        self.thread.join(timeout=10)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({name: sorted(((k, round(v, 3)) for k, v in t.items()),
                                    key=lambda kv: -kv[1])[:top]
                       for name, t in self.tables.items()}, f, indent=0)


class Prefetch:
    """TPC-H at one scale generated and encoded in a child process (the
    same ``tpch.generate`` with the same seed, through the same
    ``tpch.load_tables`` into a CPU session, so the same encoded columns
    and dictionaries as loading it here) and pickled to a temporary
    file, so that this work runs beside the phases before the one that
    needs it; ``load`` waits for the child and installs the tables. The
    child and the file go at exit."""

    CODE = ("import json, os, pickle, sys, time\n"
            "import cloudberry_tpu_torch as ct\n"
            "from cloudberry_tpu_torch import tpch\n"
            "t0 = time.perf_counter()\n"
            "raw = tpch.generate(float(sys.argv[1]), int(sys.argv[2]))\n"
            "gen_s = time.perf_counter() - t0\n"
            "s = ct.Session(device='cpu')\n"
            "tpch.load_tables(s, tpch.SCHEMAS, tpch.DIST_KEYS, raw)\n"
            "del raw\n"
            "enc = {n: (t.data, {c: d.values for c, d in t.dicts.items()})\n"
            "       for n, t in s.catalog.tables.items()}\n"
            "enc_s = time.perf_counter() - t0 - gen_s\n"
            "with open(sys.argv[3] + '.part', 'wb') as f:\n"
            "    pickle.dump(enc, f, protocol=5)\n"
            "os.replace(sys.argv[3] + '.part', sys.argv[3])\n"
            "print(json.dumps({'generate_s': gen_s, 'encode_s': enc_s,\n"
            "                  'total_s': time.perf_counter() - t0}))\n")

    def __init__(self, sf: float, seed: int):
        import atexit
        import tempfile

        self.sf = sf
        self.dir = tempfile.mkdtemp(prefix="cb_prefetch_")
        self.path = os.path.join(self.dir, "tpch.pickle")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", self.CODE, str(sf), str(seed),
             self.path], cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, text=True)
        atexit.register(self.close)

    def load(self, session, timeout=900) -> dict:
        """Install the TPC-H tables in ``session`` as ``tpch.load_tables``
        would; returns seconds: the child's generate, encode and total,
        this process's wait for it, its unpickle and its install."""
        import pickle

        from cloudberry_tpu_torch import tpch
        from cloudberry_tpu_torch.catalog import carry
        from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy

        t0 = time.perf_counter()
        said, _ = self.proc.communicate(timeout=timeout)
        t1 = time.perf_counter()
        check(self.proc.returncode == 0,
              f"the sf={self.sf} generator exited {self.proc.returncode}")
        with open(self.path, "rb") as f:
            enc = pickle.load(f)
        os.remove(self.path)
        t2 = time.perf_counter()
        for name, schema in tpch.SCHEMAS.items():
            keys = tpch.DIST_KEYS[name]
            data, dicts = enc.pop(name)
            carry.load_encoded(
                session, name, schema.fields, data, None, dicts,
                DistributionPolicy.replicated() if keys is None
                else DistributionPolicy.hashed(*keys))
        return {**json.loads(said.strip().splitlines()[-1]),
                "waited_s": t1 - t0, "unpickle_s": t2 - t1,
                "install_s": time.perf_counter() - t2}

    def close(self):
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        shutil.rmtree(self.dir, ignore_errors=True)


# ------------------------------------------------------------ numpy oracle

def _cents(x):
    return np.rint(np.asarray(x, dtype=np.float64) * 100).astype(np.int64)


def _lookup(keys, probe):
    """Row index of each probe key in a unique key column."""
    order = np.argsort(keys, kind="stable")
    pos = np.searchsorted(keys[order], probe)
    pos = np.clip(pos, 0, len(keys) - 1)
    check(np.array_equal(keys[order][pos], probe), "oracle: dangling key")
    return order[pos]


_ORACLE_MEMO: dict = {}


def oracle(raw, q, D, tiled=False, q1_date="1998-12-01"):
    """Independent numpy answers, physical form: strings as str, DECIMAL
    as int64 fixed-point, DATE as day numbers, avg as float64. ``tiled``:
    Q1's averages in the tiled finalize's order of operations (the
    reference's two-stage split: sum cast to float, then divided by the
    count), which can differ from the one-shot order in the last bit.
    ``q1_date``: Q1's ship-date literal (its cutoff is 90 days before).
    Many phases ask for the same answer over the same tables: each is
    computed once per (tables, arguments), the memo holding the tables
    it was computed from (no table is changed in place), and every
    caller gets its own copy of the answer's columns."""
    tables = tuple(sorted((k, id(v)) for k, v in raw.items()))
    key = (tables, q, id(D), tiled, q1_date)
    hit = _ORACLE_MEMO.get(key)
    if hit is None:
        hit = _ORACLE_MEMO[key] = (dict(raw), D,
                                   _oracle(raw, q, D, tiled, q1_date))
    return {k: (v.copy() if isinstance(v, np.ndarray) else list(v))
            for k, v in hit[2].items()}


def _oracle(raw, q, D, tiled, q1_date):
    li = raw["lineitem"]
    ep, disc = _cents(li["l_extendedprice"]), _cents(li["l_discount"])
    if q == "q1":
        m = li["l_shipdate"] <= D(q1_date) - 90
        rf, ls = li["l_returnflag"][m], li["l_linestatus"][m]
        qty, tax = _cents(li["l_quantity"])[m], _cents(li["l_tax"])[m]
        e, d = ep[m], disc[m]
        out = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty",
                               "sum_base_price", "sum_disc_price",
                               "sum_charge", "avg_qty", "avg_price",
                               "avg_disc", "count_order")}
        for a, b in sorted(set(zip(rf.tolist(), ls.tolist()))):
            g = (rf == a) & (ls == b)
            c = np.int64(g.sum())
            out["l_returnflag"].append(a)
            out["l_linestatus"].append(b)
            out["sum_qty"].append(qty[g].sum())
            out["sum_base_price"].append(e[g].sum())
            out["sum_disc_price"].append((e[g] * (100 - d[g])).sum())
            out["sum_charge"].append(
                (e[g] * (100 - d[g]) * (100 + tax[g])).sum())
            for name, v in (("avg_qty", qty), ("avg_price", e),
                            ("avg_disc", d)):
                if tiled:   # the finalize's avg: (sum * 0.01) / count
                    out[name].append(np.float64(v[g].sum()) * 0.01
                                     / np.float64(c))
                else:
                    out[name].append(np.float64(v[g].sum()) / np.float64(c)
                                     / 100.0)
            out["count_order"].append(c)
        return out
    if q == "q3":
        cu, od = raw["customer"], raw["orders"]
        cust_ok = cu["c_mktsegment"] == "BUILDING"
        o_ok = (od["o_orderdate"] < D("1995-03-15")) \
            & cust_ok[_lookup(cu["c_custkey"], od["o_custkey"])]
        orow = _lookup(od["o_orderkey"], li["l_orderkey"])
        m = (li["l_shipdate"] > D("1995-03-15")) & o_ok[orow]
        keys, inv = np.unique(li["l_orderkey"][m], return_inverse=True)
        rev = np.zeros(len(keys), dtype=np.int64)
        np.add.at(rev, inv, (ep * (100 - disc))[m])
        first = _lookup(od["o_orderkey"], keys)
        odate = od["o_orderdate"][first].astype(np.int32)
        prio = od["o_shippriority"][first].astype(np.int32)
        top = np.lexsort((keys, odate, -rev))[:10]
        return {"l_orderkey": keys[top], "revenue": rev[top],
                "o_orderdate": odate[top], "o_shippriority": prio[top]}
    if q == "q5":
        cu, od, su = raw["customer"], raw["orders"], raw["supplier"]
        na, rg = raw["nation"], raw["region"]
        asia = rg["r_regionkey"][rg["r_name"] == "ASIA"]
        orow = _lookup(od["o_orderkey"], li["l_orderkey"])
        odate = od["o_orderdate"][orow]
        crow = _lookup(cu["c_custkey"], od["o_custkey"][orow])
        srow = _lookup(su["s_suppkey"], li["l_suppkey"])
        c_nat, s_nat = cu["c_nationkey"][crow], su["s_nationkey"][srow]
        nrow = _lookup(na["n_nationkey"], s_nat)
        m = (odate >= D("1994-01-01")) & (odate < D("1995-01-01")) \
            & (c_nat == s_nat) & np.isin(na["n_regionkey"][nrow], asia)
        names = na["n_name"][nrow][m]
        rev = (ep * (100 - disc))[m]
        out = {}
        for nm in sorted(set(names.tolist())):
            out[nm] = rev[names == nm].sum()
        order = sorted(out, key=lambda k: -out[k])
        return {"n_name": order,
                "revenue": [out[k] for k in order]}
    raise KeyError(q)


def physical(batch):
    """A result batch's selected rows, physical form (strings decoded)."""
    sel = np.asarray(batch.sel)
    out = {}
    for f in batch.schema.fields:
        arr = np.asarray(batch.columns[f.name])[sel]
        d = batch.dicts.get(f.name)
        out[f.name] = d.decode(arr) if d is not None else arr
    return out


def same(got: dict, want: dict, what: str):
    check(list(got) == list(want), f"{what}: columns {list(got)} vs "
          f"{list(want)}")
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype == object or g.dtype == object:
            ok = g.shape == w.shape and all(
                a == b for a, b in zip(g.tolist(), w.tolist()))
        elif w.dtype.kind == "f" or g.dtype.kind == "f":
            ok = g.shape == w.shape and np.array_equal(
                g.astype(np.float64).view(np.int64),
                w.astype(np.float64).view(np.int64))
        else:
            ok = g.shape == w.shape and np.array_equal(g.astype(np.int64),
                                                       w.astype(np.int64))
        check(ok, f"{what}: column {k} differs:\n got  {g[:10]}\n want "
              f"{w[:10]}")


def with_nulls(batch):
    """A result's selected rows as {column: (values, valid mask)}, values
    in physical form (DECIMAL cents, day numbers, dictionary codes
    decoded)."""
    sel = np.asarray(batch.sel)
    out = {}
    for f in batch.schema.fields:
        v = batch.validity.get(f.name)
        valid = np.ones(int(sel.sum()), dtype=bool) if v is None \
            else np.asarray(v).astype(bool)[sel]
        arr = np.asarray(batch.columns[f.name])[sel]
        d = batch.dicts.get(f.name)
        out[f.name] = (d.decode(arr) if d is not None else arr, valid)
    return out


def same_nulls(got: dict, want: dict, what: str) -> float:
    """Equal NULL masks, and equal values where valid: exactly, except
    float64 within FLOAT_RTOL * |want| + ATOL_PER_MAGNITUDE * (the column's
    sum of magnitudes; windowed float sums are differences of prefix sums,
    rounded at the prefix's magnitude). Returns the largest float
    difference seen."""
    check(list(got) == list(want), f"{what}: columns {list(got)} vs "
          f"{list(want)}")
    worst = 0.0
    for k, (w, wv) in want.items():
        g, gv = got[k]
        check(g.shape == w.shape and np.array_equal(gv, wv),
              f"{what}: column {k}: shape or NULLs differ")
        g, w = g[wv], w[wv]
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            check(g.dtype == w.dtype, f"{what}: column {k} dtype")
            diff = np.abs(g - w)
            tol = FLOAT_RTOL * np.abs(w) + ATOL_PER_MAGNITUDE * max(
                1.0, float(np.abs(w).sum()))
            ok = bool(np.all(diff <= tol))
            worst = max(worst, float(diff.max()) if diff.size else 0.0)
        elif w.dtype == object or g.dtype == object:
            ok = g.tolist() == w.tolist()
        else:
            ok = g.dtype == w.dtype and np.array_equal(g, w)
        check(ok, f"{what}: column {k} differs:\n got  {g[:10]}\n want "
              f"{w[:10]}")
    return worst


def copy_tables(src, dst, names):
    """Install src's encoded tables in dst unchanged (catalog/carry.py).
    A copy holds the same values, so it shares the source's uniqueness
    flags and distinct counts (``Table.is_unique``, ``Table.ndv``: each
    an ``np.unique`` at a first plan, both dropped by any change of the
    data): they are computed once for the data, not once in every
    session that holds a copy."""
    from cloudberry_tpu_torch.catalog import carry

    for n in names:
        t = src.catalog.table(n)
        c = carry.load_encoded(dst, n, t.schema.fields, t.data, t.validity,
                               {c: d.values for c, d in t.dicts.items()},
                               t.policy)
        c.stats.unique, c.stats.ndv = t.stats.unique, t.stats.ndv


def skew_join_tables(n):
    """The skew join's inputs: n probe rows, 25 % of them on key 0, which
    the build side holds 12 times; every other build key once."""
    rng = np.random.default_rng(13)
    probe_k = np.where(rng.random(n) < 0.25, 0,
                       rng.integers(1, 120_000, n)).astype(np.int64)
    probe_v = rng.integers(0, 1000, n).astype(np.int64)
    build_k = np.concatenate([np.zeros(12, dtype=np.int64),
                              np.arange(1, 120_000, dtype=np.int64)])
    build_v = np.arange(len(build_k), dtype=np.int64)
    return probe_k, probe_v, build_k, build_v


def skew_join_oracle(probe_k, probe_v, build_k, build_v):
    """count(*) and sum(v + w) of the inner join on k, in numpy."""
    order = np.argsort(build_k, kind="stable")
    lo = np.searchsorted(build_k[order], probe_k, side="left")
    hi = np.searchsorted(build_k[order], probe_k, side="right")
    pairs = hi - lo
    cw = np.concatenate([[0], np.cumsum(build_v[order])])
    return int(pairs.sum()), int((probe_v * pairs).sum()
                                 + (cw[hi] - cw[lo]).sum())


# ------------------------------------------------------------------ timing

class Timer:
    """Median ms of a function over ``reps`` runs, each after an L2 flush
    (the main path finds its inputs cold), taken two ways:

    - ``device``: a spin kernel (``torch.cuda._sleep``) is queued after the
      flush and before the start event, and outlasts the host's enqueue of
      ``fn``, so the events bracket only ``fn``'s device work. Every run
      checks this against the host clock; a function that blocks the host
      (a device-to-host read) fails the check and has no device time.
    - ``wrapper``: the start event follows the flush directly, so the time
      includes the host's work in the wrapper before the launch (argument
      checks, allocations, the ctypes call).
    """

    def __init__(self, torch, flush, reps):
        self.torch, self.flush, self.reps = torch, flush, reps
        cycles = 10_000_000
        torch.cuda._sleep(cycles)              # warm the spin kernel
        a, b = self._events()
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        self.cycles_per_ms = cycles / a.elapsed_time(b)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def wrapper(self, fn):
        fn()
        self.torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a, b = self._events()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def device(self, fn):
        """Device ms, or None when the host's enqueue of ``fn`` outlasted
        the spin kernel even with a 64x longer lead (then the gap between
        the events would count host time)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        lead_ms = max(0.5, 4 * enqueue_ms)
        for _ in range(4):
            times = self._device_runs(fn, lead_ms)
            if times is not None:
                return float(np.median(times))
            lead_ms *= 4
        return None

    def _device_runs(self, fn, lead_ms):
        torch = self.torch
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a, b = self._events()
            h0 = time.perf_counter()
            torch.cuda._sleep(int(lead_ms * self.cycles_per_ms))
            a.record()
            fn()
            b.record()
            host_ms = (time.perf_counter() - h0) * 1e3
            b.synchronize()
            if host_ms >= 0.5 * lead_ms:   # margin for clock drift
                return None
            times.append(a.elapsed_time(b))
        return times


def max_abs_err(torch, got, want):
    err = 0.0
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g), torch.as_tensor(w)
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if g.numel() == 0:
            continue
        if g.dtype.is_floating_point:
            err = max(err, float((g - w).abs().max()))
        else:  # exact types: the number of differing elements
            err = max(err, float((g != w).sum()))
    return err


def profile_queries(torch, session, queries):
    """Trace each query of {label: sql} once (tables already on the card):
    device time by operator, and the device's busy share of the wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs("chiprun_out", exist_ok=True)
    for q, sql in queries.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            session.sql(sql)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=25)
        kernels = [e for e in prof.events()
                   if e.device_type.name == "CUDA"]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in kernels)
        busy, end = 0.0, float("-inf")
        for a, b in spans:      # union of kernel intervals
            if b > end:
                busy += b - max(a, end)
                end = b
        with open(f"chiprun_out/profile_{q}.txt", "w") as f:
            f.write(table)
        log(f"[profile] {q}: wall {wall_us / 1e3:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall), "
            f"{len(kernels)} device kernels")
        log(table)


# ---------------------------------------------------------- storage phase

STORE_QUERIES = ("q1", "q3", "q5")
STORE_TIERS = ("cold", "pool admits", "pool-served", "scan cache")
PART_START, PART_END, PART_EVERY = "1992-01-01", "1999-01-01", 365
BLOOM_RPP = 512       # rows per micro-partition of the point-lookup table
SREH_ROWS = 100_000   # orders lines of the reject-limit load
# orders lines of the COPY round trip: the first 200,000 of SF1's 1.5M
# (all of them took 57 s of COPY FROM, TO and back on one H100's
# machine, 500,000 of them 18 s; a slow machine needs the room)
COPY_ROWS = 200_000
_DDL_TYPE = {"bool": "boolean", "int32": "integer", "int64": "bigint",
             "float64": "double", "date": "date", "string": "text"}


def ddl_columns(schema) -> str:
    """A schema as the column list of CREATE TABLE."""
    out = []
    for f in schema.fields:
        base = f.type.base.value
        out.append(f"{f.name} " + (f"decimal(15,{f.type.scale})"
                                   if base == "decimal" else _DDL_TYPE[base]))
    return ", ".join(out)


def tbl_lines(cols: dict, schema) -> list[str]:
    """A generator table's rows as '|'-delimited lines, in the text form
    COPY TO writes (ISO dates, DECIMALs from their integer units)."""
    out = []
    for f in schema.fields:
        v = np.asarray(cols[f.name])
        base = f.type.base.value
        if base == "decimal":
            s = f.type.scale
            units = np.rint(v.astype(np.float64) * 10 ** s).astype(np.int64)
            out.append([f"{'-' if x < 0 else ''}{abs(x) // 10 ** s}."
                        f"{abs(x) % 10 ** s:0{s}d}" for x in units.tolist()])
        elif base == "date":
            out.append((np.datetime64("1970-01-01")
                        + v.astype("timedelta64[D]")).astype(str).tolist())
        else:
            out.append([str(x) for x in v.tolist()])
    return ["|".join(r) for r in zip(*out)]


def physical_of(cols: dict, fields, rows=None) -> dict:
    """Some columns (``fields``) of a generator table, optionally some rows,
    in the physical form ``physical`` gives a result: DECIMALs as integer
    units."""
    out = {}
    for f in fields:
        v = np.asarray(cols[f.name])
        v = v if rows is None else v[rows]
        if f.type.base.value == "decimal":
            v = np.rint(v.astype(np.float64) * 10 ** f.type.scale
                        ).astype(np.int64)
        out[f.name] = v
    return out


def store_scan_reports(session, sql) -> list[dict]:
    """The prune report, partitions kept and capacity of every store scan
    of a statement's optimized plan."""
    from cloudberry_tpu_torch.exec.executor import scans_of
    from cloudberry_tpu_torch.plan.binder import Binder
    from cloudberry_tpu_torch.plan.planner import _optimize
    from cloudberry_tpu_torch.sql.parser import parse_sql

    plan = _optimize(Binder(session.catalog).bind_query(parse_sql(sql)),
                     session)
    return [{"table": s.table_name, **s._prune_report,
             "parts": len(s._store_parts), "capacity": s.capacity}
            for s in scans_of(plan) if hasattr(s, "_store_parts")]


def q3_groups(raw, D):
    """Every (l_orderkey, revenue, o_orderdate, o_shippriority) group of
    TPC-H Q3's join and filters, by key (the oracle's q3 without the
    top 10)."""
    li, cu, od = raw["lineitem"], raw["customer"], raw["orders"]
    ep, disc = _cents(li["l_extendedprice"]), _cents(li["l_discount"])
    cust_ok = cu["c_mktsegment"] == "BUILDING"
    o_ok = (od["o_orderdate"] < D("1995-03-15")) \
        & cust_ok[_lookup(cu["c_custkey"], od["o_custkey"])]
    m = (li["l_shipdate"] > D("1995-03-15")) \
        & o_ok[_lookup(od["o_orderkey"], li["l_orderkey"])]
    keys, inv = np.unique(li["l_orderkey"][m], return_inverse=True)
    rev = np.zeros(len(keys), dtype=np.int64)
    np.add.at(rev, inv, (ep * (100 - disc))[m])
    first = _lookup(od["o_orderkey"], keys)
    return {"l_orderkey": keys, "revenue": rev,
            "o_orderdate": od["o_orderdate"][first],
            "o_shippriority": od["o_shippriority"][first]}


def storage_phase(kit, raw, ram, ram_session, names) -> dict:
    """Phase 9 (module docstring). ``ram``: {query: (physical result,
    kernels launched)} of phase 3; ``ram_session``: phase 3's session,
    whose tables the join-index runs copy. Returns the phase's report."""
    import shutil
    import tempfile

    from cloudberry_tpu_torch import native
    from cloudberry_tpu_torch.storage import micropartition as MP
    from cloudberry_tpu_torch.storage.table_store import TableStore

    def importable(name):
        try:
            __import__(name)
            return True
        except ImportError:
            return False

    host = {n: importable(n) for n in ("zstandard", "cryptography",
                                       "pandas")}
    lib = native.load_native()
    host["codec"] = "zstd" if MP._zstd is not None else "zlib"
    host["native_codec_loaded"] = lib is not None
    log(f"[store] host packages importable: zstandard {host['zstandard']}, "
        f"cryptography {host['cryptography']}, pandas {host['pandas']}; "
        f"micro-partitions compress with {host['codec']}; native codec "
        f"({os.path.relpath(native.SOURCE)}, g++ into "
        f"{os.path.relpath(native.BUILD_DIR)}/) "
        f"{'loaded' if lib is not None else 'NOT loaded'}")
    check(lib is not None, "the native codec did not build or load: the "
          "store path must run on it")

    # every partition read and decode, and every manifest and footer read
    # (JSON parses), counted and timed where they happen
    reads = {"calls": 0, "parts": 0, "bytes": 0, "s": 0.0,
             "manifests": 0, "manifest_s": 0.0, "footers": 0,
             "footer_s": 0.0}
    real_read = TableStore.read_partitions
    real_manifest = TableStore.read_manifest
    real_footer = MP.read_footer

    def counting_read(self, table, parts, *a, **kw):
        t0 = time.perf_counter()
        cols, validity = real_read(self, table, parts, *a, **kw)
        reads["s"] += time.perf_counter() - t0
        reads["calls"] += 1
        reads["parts"] += len(parts)
        reads["bytes"] += sum(v.nbytes for v in (*cols.values(),
                                                 *validity.values()))
        return cols, validity

    def timed(fn, what):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                reads[f"{what}_s"] += time.perf_counter() - t0
                reads[f"{what}s"] += 1
        return call

    TableStore.read_partitions = counting_read
    TableStore.read_manifest = timed(real_manifest, "manifest")
    MP.read_footer = timed(real_footer, "footer")
    tmp = tempfile.mkdtemp(prefix="cb_store_")
    try:
        out = _storage_runs(kit, raw, ram, ram_session, names, reads,
                            os.path.join(tmp, "tpch"))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        TableStore.read_partitions = real_read
        TableStore.read_manifest = real_manifest
        MP.read_footer = real_footer
    out["host"] = host
    # the store stays for phase 16, which serves it; main removes it
    out["tmp"] = tmp
    out["root"] = os.path.join(tmp, "tpch")
    return out


def _storage_runs(kit, raw, ram, ram_session, names, reads, root) -> dict:
    import re

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.columnar.batch import encode_column
    from cloudberry_tpu_torch.exec import bufferpool as BUF
    from cloudberry_tpu_torch.exec import cuda_kernels as CK
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.exec import joinindex as JI
    from cloudberry_tpu_torch.exec import kernels as K
    from cloudberry_tpu_torch.exec.executor import all_nodes
    from cloudberry_tpu_torch.plan.binder import Binder
    from cloudberry_tpu_torch.plan.planner import _optimize
    from cloudberry_tpu_torch.sched import sharedcache
    from cloudberry_tpu_torch.sql.parser import parse_sql
    from cloudberry_tpu_torch.types import date_to_days as D

    torch = kit.torch
    report = {}
    cfg = ct.Config().with_overrides(**{
        "storage.root": root, "resource.query_mem_bytes": CARD_BUDGET})

    # --------------------------------------------------------- the write
    t0 = time.perf_counter()
    w = ct.Session(cfg)
    tpch.load_tables(w, tpch.SCHEMAS, tpch.DIST_KEYS, raw)
    write_s = time.perf_counter() - t0
    disk = w.store.disk_usage(fresh=True)
    li_parts = len(w.store.read_manifest("lineitem")["partitions"])
    n_li = len(raw["lineitem"]["l_orderkey"])
    check(li_parts == -(-n_li // w.store.rows_per_partition),
          f"lineitem: {li_parts} micro-partitions")
    report["write"] = {"s": write_s, "bytes_on_disk": disk,
                       "lineitem_partitions": li_parts}
    log(f"[store] wrote the eight TPC-H tables ({n_li} lineitem rows, "
        f"{li_parts} lineitem micro-partitions of at most "
        f"{w.store.rows_per_partition} rows) through a store-backed "
        f"Session in {write_s:.2f} s: {disk} bytes on disk")

    # partitioned lineitem: one RANGE partition per 365 days of l_shipdate,
    # bounds in days since 1970
    schema = tpch.SCHEMAS["lineitem"]
    lo, hi = D(PART_START), D(PART_END)
    t0 = time.perf_counter()
    w.sql(f"create table lineitem_p ({ddl_columns(schema)}) partition by "
          f"range (l_shipdate) (start {lo} end {hi} every {PART_EVERY})")
    t = w.catalog.table("lineitem_p")
    t.set_data({f.name: encode_column(raw["lineitem"][f.name], f, t.dicts)
                for f in schema.fields}, t.dicts)
    pkeys = [p["pkey"] for p in
             w.store.read_manifest("lineitem_p")["partitions"]]
    part_s = time.perf_counter() - t0
    report["write"].update(partitioned_s=part_s, partitioned_pkeys=pkeys)
    log(f"[store] lineitem_p: PARTITION BY RANGE (l_shipdate) (START {lo} "
        f"END {hi} EVERY {PART_EVERY}) — {PART_START} to {PART_END} in "
        f"days since 1970 — written in {part_s:.2f} s as {len(pkeys)} "
        f"micro-partitions {pkeys}")

    # point-lookup table: customer's key, nation, balance and segment in a
    # seeded random row order, in small micro-partitions, so min/max cannot
    # prune a c_custkey point and the footer blooms must. (Every footer
    # carries the table's whole string dictionaries, so the wide text
    # columns would make each of the 293 footer reads megabytes of JSON.)
    rng = np.random.default_rng(SEED)
    cu = raw["customer"]
    perm = rng.permutation(len(cu["c_custkey"]))
    b_fields = [f for f in tpch.SCHEMAS["customer"].fields if f.name in
                ("c_custkey", "c_nationkey", "c_acctbal", "c_mktsegment")]
    t0 = time.perf_counter()
    wb = ct.Session(cfg.with_overrides(
        **{"storage.rows_per_partition": BLOOM_RPP}))
    wb.sql("create table customer_b (" + ddl_columns(
        SimpleNamespace(fields=b_fields)) + ")")
    t = wb.catalog.table("customer_b")
    t.set_data({f.name: encode_column(cu[f.name][perm], f, t.dicts)
                for f in b_fields}, t.dicts)
    n_b = len(wb.store.read_manifest("customer_b")["partitions"])
    log(f"[store] customer_b: {n_b} micro-partitions of at most "
        f"{BLOOM_RPP} rows, written in {time.perf_counter() - t0:.2f} s")

    # what every statement on a store pays before any scan: manifest reads
    # (JSON holding the partition list, statistics and the table's
    # string dictionaries)
    manifests = {}
    for name in tpch.SCHEMAS:
        mpath = os.path.join(root, name, "_manifests",
                             f"v{w.store.current_version(name)}.json")
        t0 = time.perf_counter()
        w.store.read_manifest(name)
        manifests[name] = {"bytes": os.path.getsize(mpath),
                           "parse_ms": (time.perf_counter() - t0) * 1e3}
    report["manifests"] = manifests
    log(f"[store] manifest bytes and one read's ms per table: {manifests}")
    del w, wb

    # ---------------------------------------- cold, pool and cache tiers
    tiers, store_res = {}, {}
    for q in STORE_QUERIES:
        sql = tpch.QUERIES[q]
        want, ram_fired = ram[q]
        sharedcache.drop_store_scope(root)
        rows = []
        s = None
        for tier in STORE_TIERS:
            if tier != "scan cache":
                s = ct.Session(cfg)
                check(all(t.cold for t in s.catalog.tables.values()),
                      "a fresh session registered a table warm")
            pool = BUF.pool_for(s)
            r0, p0, c0 = dict(reads), pool.snapshot(), s.counters.snapshot()
            res, ms, counts = kit.counted_run(s, sql)
            r1, p1, c1 = dict(reads), pool.snapshot(), s.counters.snapshot()
            got = physical(res)
            same(got, oracle(raw, q, D), f"{q} from the store ({tier}) vs "
                 "the numpy oracle")
            same(got, want, f"{q} from the store ({tier}) vs the RAM path")
            fired = {k for k, v in counts.items() if v}
            check(fired == ram_fired, f"{q} from the store ({tier}): "
                  f"launches {counts}, the RAM path launched "
                  f"{sorted(ram_fired)}")
            nbytes, secs = r1["bytes"] - r0["bytes"], r1["s"] - r0["s"]
            scan_bytes = sum(X._nbytes(v)
                             for v in s._store_scan_cache.values())
            row = {"tier": tier, "ms": ms, "launches": counts,
                   "partitions_read": r1["parts"] - r0["parts"],
                   "decoded_bytes": nbytes, "read_decode_s": secs,
                   "decode_mb_s": nbytes / 1e6 / secs if secs else None,
                   "manifest_reads": r1["manifests"] - r0["manifests"],
                   "manifest_ms": (r1["manifest_s"] - r0["manifest_s"]) * 1e3,
                   "footer_reads": r1["footers"] - r0["footers"],
                   "footer_ms": (r1["footer_s"] - r0["footer_s"]) * 1e3,
                   **{f"pool_{k}": p1[k] - p0[k] for k in
                      ("hits", "misses", "admits", "evictions",
                       "refusals")},
                   "pool_resident_bytes": p1["bytes"],
                   "scan_cache_bytes": scan_bytes,
                   **{f"scan_cache_{k}":
                      c1.get(f"store_scan_cache_{k}", 0)
                      - c0.get(f"store_scan_cache_{k}", 0)
                      for k in ("hits", "refusals")}}
            rows.append(row)
            log(f"[store] {q} {tier}: {ms:.3f} ms, {row['partitions_read']} "
                f"partition(s) read and decoded ({nbytes} bytes in "
                f"{secs:.3f} s"
                + (f", {row['decode_mb_s']:.1f} MB/s" if secs else "")
                + f"), {row['manifest_reads']} manifest read(s) in "
                f"{row['manifest_ms']:.3f} ms, {row['footer_reads']} footer "
                f"read(s) in {row['footer_ms']:.3f} ms, pool hits "
                f"{row['pool_hits']} misses "
                f"{row['pool_misses']} admits {row['pool_admits']} "
                f"evictions {row['pool_evictions']} refusals "
                f"{row['pool_refusals']}, resident {p1['bytes']} bytes, "
                f"scan-cache hits {row['scan_cache_hits']} refusals "
                f"{row['scan_cache_refusals']} holding {scan_bytes} bytes, "
                f"launches {counts}; equal to the numpy oracle and the RAM "
                "path")
            check(p1["bytes"] + scan_bytes <= cfg.bufferpool.max_bytes,
                  f"{q} {tier}: pool and scan cache hold "
                  f"{p1['bytes'] + scan_bytes} device bytes, over "
                  f"bufferpool.max_bytes {cfg.bufferpool.max_bytes}")
        cold, admit, served, cached = rows
        check(cold["partitions_read"] > 0 and cold["pool_admits"] == 0,
              f"{q} cold tier: {cold}")
        check(admit["pool_admits"] > 0, f"{q}: the pool admitted nothing")
        check(served["pool_hits"] > 0, f"{q}: the pool served nothing")
        # the repeat is served from device memory: the scan cache where
        # its entry fits beside the pool in max_bytes, else the pool
        check(cached["partitions_read"] == 0
              and cached["scan_cache_hits"] + cached["pool_hits"] > 0,
              f"{q} scan-cache tier: {cached}")
        # every kernel call of one more run, held against its plain version
        kit.held(f"{q} from the store", lambda: s.sql(sql))
        if q in ("q3", "q5"):
            # phase 11, step 5: exact repeats on this pool-served session
            report.setdefault("stmt_cache_repeats", {})[q] = store_repeats(
                kit, s, q, sql, want, reads, served["ms"])
        tiers[q] = rows
        store_res[q] = got
        del s
    report["tiers"] = tiers

    # ------------------------------------------------------------ pruning
    s = ct.Session(cfg)
    prune = {}
    for q in ("q1", "q3"):
        sql = re.sub(r"\blineitem\b", "lineitem_p", tpch.QUERIES[q])
        reps = store_scan_reports(s, sql)
        sizes = []
        res = kit.held(f"{q} on lineitem_p", lambda: s.sql(sql), sizes)
        got = physical(res)
        same(got, store_res[q], f"{q} on lineitem_p vs unpartitioned")
        res, ms, counts = kit.counted_run(s, sql)
        same(physical(res), store_res[q], f"{q} on lineitem_p (counted run)")
        prune[q] = {"scans": reps, "kernel_inputs": sizes, "ms": ms,
                    "launches": counts}
        log(f"[prune] {q} on lineitem_p: {ms:.3f} ms, scans {reps}, kernel "
            f"inputs {sizes}, launches {counts}; equal to the "
            f"unpartitioned store run")
    li_p = next(r for r in prune["q3"]["scans"] if r["table"] == "lineitem_p")
    check(li_p["skipped_minmax"] > 0, f"Q3 on lineitem_p pruned nothing: "
          f"{li_p}")
    key = int(cu["c_custkey"][len(cu["c_custkey"]) // 3])
    sql = (f"select c_custkey, c_acctbal, c_mktsegment from customer_b "
           f"where c_custkey = {key}")
    reps = store_scan_reports(s, sql)
    res, ms, counts = kit.counted_run(s, sql)
    same(physical(res), physical_of(
        cu, [f for f in b_fields if f.name != "c_nationkey"],
        rows=np.nonzero(cu["c_custkey"] == key)[0]),
        "point lookup on customer_b vs numpy")
    check(reps[0]["skipped_bloom"] > 0, f"the bloom pruned nothing: {reps}")
    prune["point"] = {"sql": sql, "scans": reps, "ms": ms}
    log(f"[prune] {sql}: {ms:.3f} ms, scans {reps}; equal to numpy")
    report["prune"] = prune
    del s

    # --------------------------------------------------------- join index
    jx = ct.Session(ct.Config().with_overrides(
        **{"resource.query_mem_bytes": CARD_BUDGET}))
    copy_tables(ram_session, jx, names)
    for n in names:
        jx.device_table(n)
    jix = {}
    for q in ("q3", "q5"):
        sql = tpch.QUERIES[q]
        plan = _optimize(Binder(jx.catalog).bind_query(parse_sql(sql)), jx)
        specs = JI.jix_specs_of(plan)
        runs = []
        for i in range(2):
            c0 = jx.counters.snapshot()
            res, ms, counts = kit.counted_run(jx, sql)
            c1 = jx.counters.snapshot()
            same(physical(res), ram[q][0], f"{q} join-index run {i + 1}")
            runs.append({"ms": ms, "launches": counts, **{
                k: c1.get(f"join_index_{k}", 0) - c0.get(f"join_index_{k}", 0)
                for k in ("builds", "hits")}})
        if specs:
            check(runs[1]["hits"] == len(specs) and runs[1]["builds"] == 0,
                  f"{q}: the second run did not use the cached index: "
                  f"{runs}")
        sorts = []
        for spec in specs:
            # the build sort the cached index stands in for, on the device,
            # and the cached index held equal to it
            cols = jx.device_table(spec.table)
            rows_ = jx.catalog.table(spec.table).num_rows
            keys = [cols[p] for p in spec.phys]
            bsel = torch.arange(keys[0].shape[0], device=kit.dev) < rows_
            order, skeys, _ = K.build_sort(keys, bsel, spec.bits)
            idx = JI._cached_index(jx, spec)
            check(torch.equal(idx["order"], order)
                  and torch.equal(idx["skeys"], skeys),
                  f"{q}: the cached index of {spec.key} differs from "
                  "build_sort")
            ms = kit.timer.device(lambda: K.build_sort(keys, bsel, spec.bits))
            sorts.append({"index": spec.key, "rows": rows_,
                          "build_sort_device_ms": ms})
        eligible = sum(1 for n in all_nodes(plan)
                       if getattr(n, "_jix", None) is not None)
        jix[q] = {"runs": runs, "indexed_joins": eligible,
                  "build_sorts": sorts}
        log(f"[joinindex] {q}: {eligible} join(s) annotated with a cached index "
            f"(build: a bare scan of a whole RAM table); "
            f"run 1 {runs[0]['ms']:.3f} ms ({runs[0]['builds']} index "
            f"build(s)), run 2 {runs[1]['ms']:.3f} ms ({runs[1]['hits']} "
            f"cached index hit(s)); build sorts the index removes: {sorts}")
    check(jix["q5"]["indexed_joins"] > 0, "Q5 has no join-index join")
    report["join_index"] = jix
    del jx

    # ---------------------------------------------- tiling from the store
    t0 = time.perf_counter()
    report["tiling"] = tiling_store_runs(kit, raw, ram, cfg, root)
    report["tiling_s"] = time.perf_counter() - t0

    # ----------------------------------------------------------- DML last
    report["dml"] = _storage_dml(kit, raw, cfg, root)
    return report


def _storage_dml(kit, raw, cfg, root) -> dict:
    """DML at scale against numpy on the same data; then a fresh session
    must see every change."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.types import date_to_days as D

    od, li = raw["orders"], raw["lineitem"]
    oschema = tpch.SCHEMAS["orders"]
    n_ord = len(od["o_orderkey"])
    n_copy = min(COPY_ROWS, n_ord)
    # no auto-ANALYZE after the DML: its runs read every row of the
    # 6M- and 1.5M-row tables on the host, which no check here needs
    s = ct.Session(cfg.with_overrides(**{"planner.autostats": "none"}))
    walls = {}

    def run(sql, want_status=None):
        kit.sync()
        t0 = time.perf_counter()
        res = s.sql(sql)
        kit.sync()
        walls[sql] = (time.perf_counter() - t0) * 1e3
        if want_status is not None:
            check(res == want_status, f"{sql!r}: {res!r}, numpy says "
                  f"{want_status!r}")
        log(f"[dml] {walls[sql]:.1f} ms: {sql} -> {res}")
        return res

    def agg(sql):
        got = physical(s.sql(sql))
        return {k: v.tolist()[0] for k, v in got.items()}

    tmp = os.path.dirname(root)
    lines = tbl_lines({k: v[:n_copy] for k, v in od.items()}, oschema)
    path_in = os.path.join(tmp, "orders.tbl")
    with open(path_in, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    cols = ddl_columns(oschema)
    every = ", ".join(f.name for f in oschema.fields)
    want_orders = physical_of(od, oschema.fields)
    want_copy = physical_of(od, oschema.fields, rows=np.arange(n_copy))

    # COPY FROM, COPY TO, and back
    run(f"create table orders_load ({cols})")
    run(f"copy orders_load from '{path_in}' with delimiter '|'",
        f"COPY {n_copy}")
    same(physical(s.sql(f"select {every} from orders_load")), want_copy,
         "orders_load after COPY FROM vs numpy")
    path_out = os.path.join(tmp, "orders_out.tbl")
    run(f"copy orders_load to '{path_out}' with delimiter '|'",
        f"COPY {n_copy}")
    with open(path_in, "rb") as a, open(path_out, "rb") as b:
        check(a.read() == b.read(), "COPY TO wrote other bytes than the "
              "loaded file")
    run(f"create table orders_back ({cols})")
    run(f"copy orders_back from '{path_out}' with delimiter '|'",
        f"COPY {n_copy}")
    same(physical(s.sql(f"select {every} from orders_back")), want_copy,
         "orders_back after COPY TO and FROM vs numpy")

    # single-row error handling: four bad lines among SREH_ROWS good ones
    bad = ["oops|" + lines[0].split("|", 1)[1],                # bad bigint
           "|".join(lines[1].split("|")[:3] + ["12x.5"]
                    + lines[1].split("|")[4:]),               # bad decimal
           "|".join(lines[2].split("|")[:-1]),                 # short row
           "|".join(lines[3].split("|")[:4] + ["1995-13-45"]
                    + lines[3].split("|")[5:])]               # bad date
    n_sreh = min(SREH_ROWS, n_copy // 2)
    sreh = lines[:n_sreh // 2] + bad[:2] + lines[n_sreh // 2:n_sreh] \
        + bad[2:]
    bad_lines = {n_sreh // 2 + 1, n_sreh // 2 + 2, n_sreh + 3, n_sreh + 4}
    path_rej = os.path.join(tmp, "orders_rej.tbl")
    with open(path_rej, "w") as fh:
        fh.write("\n".join(sreh) + "\n")
    run(f"create table orders_rej ({cols})")
    run(f"copy orders_rej from '{path_rej}' with delimiter '|' segment "
        "reject limit 10 log errors",
        f"COPY {n_sreh} (rejected {len(bad)} rows)")
    check({e["line"] for e in s.copy_errors["orders_rej"]} == bad_lines,
          f"rejected lines {s.copy_errors['orders_rej']}")
    same(physical(s.sql(f"select {every} from orders_rej")),
         physical_of(od, oschema.fields, rows=np.arange(n_sreh)),
         "orders_rej vs numpy")

    # CREATE TABLE AS of Q3's join, INSERT ... SELECT
    want_q3 = q3_groups(raw, D)
    run("create table q3_all as select l_orderkey, sum(l_extendedprice * "
        "(1 - l_discount)) as revenue, o_orderdate, o_shippriority from "
        "customer, orders, lineitem where c_mktsegment = 'BUILDING' and "
        "c_custkey = o_custkey and l_orderkey = o_orderkey and o_orderdate "
        "< date '1995-03-15' and l_shipdate > date '1995-03-15' group by "
        "l_orderkey, o_orderdate, o_shippriority",
        f"SELECT {len(want_q3['l_orderkey'])}")
    same(physical(s.sql("select l_orderkey, revenue, o_orderdate, "
                        "o_shippriority from q3_all order by l_orderkey")),
         want_q3, "q3_all vs numpy")
    late = li["l_shipdate"] > D("1998-06-01")
    run("create table li_late (l_orderkey bigint, l_extendedprice "
        "decimal(15,2), l_shipdate date)")
    run("insert into li_late select l_orderkey, l_extendedprice, l_shipdate "
        "from lineitem where l_shipdate > date '1998-06-01'",
        f"INSERT {int(late.sum())}")
    same(physical(s.sql("select l_orderkey, l_extendedprice, l_shipdate "
                        "from li_late")),
         {"l_orderkey": li["l_orderkey"][late],
          "l_extendedprice": _cents(li["l_extendedprice"])[late],
          "l_shipdate": li["l_shipdate"][late]}, "li_late vs numpy")

    # UPDATE and DELETE of the store's own tables
    upd = od["o_orderdate"] < D("1995-01-01")
    price = want_orders["o_totalprice"]
    new_price = np.where(upd, price * 2, price)
    run("update orders set o_totalprice = o_totalprice * 2 where "
        "o_orderdate < date '1995-01-01'", f"UPDATE {int(upd.sum())}")
    same(physical(s.sql("select o_orderkey, o_totalprice from orders")),
         {"o_orderkey": od["o_orderkey"], "o_totalprice": new_price},
         "orders after UPDATE vs numpy")
    gone = li["l_shipdate"] > D("1998-08-01")
    keep_cents = _cents(li["l_extendedprice"])[~gone]
    run("delete from lineitem where l_shipdate > date '1998-08-01'",
        f"DELETE {int(gone.sum())}")
    want_li = {"c": int((~gone).sum()), "s": int(keep_cents.sum())}
    check(agg("select count(*) as c, sum(l_extendedprice) as s from "
              "lineitem") == want_li, "lineitem after DELETE vs numpy")

    # a fresh session sees every change
    del s
    s = ct.Session(cfg)
    check(all(t.cold for t in s.catalog.tables.values()),
          "a fresh session registered a table warm")
    want_after = {
        "orders": {"c": n_ord, "s": int(new_price.sum())},
        "lineitem": want_li,
        "orders_load": {"c": n_copy, "s": int(price[:n_copy].sum())},
        "orders_back": {"c": n_copy, "s": int(price[:n_copy].sum())},
        "orders_rej": {"c": n_sreh, "s": int(price[:n_sreh].sum())},
        "q3_all": {"c": len(want_q3["l_orderkey"]),
                   "s": int(want_q3["revenue"].sum())},
        "li_late": {"c": int(late.sum()),
                    "s": int(_cents(li["l_extendedprice"])[late].sum())},
    }
    value = {"lineitem": "l_extendedprice", "q3_all": "revenue",
             "li_late": "l_extendedprice"}
    for table, want in want_after.items():
        got = agg(f"select count(*) as c, sum({value.get(table, 'o_totalprice')}"
                  f") as s from {table}")
        check(got == want, f"{table} in a fresh session: {got}, numpy "
              f"{want}")
    log(f"[dml] a fresh session sees every change: {want_after}")
    return {"walls_ms": walls, "after": want_after}


# ------------------------------------------------------------ tiling phase

def sorted_rows(d: dict) -> dict:
    """A with_nulls() result with its rows sorted by every column (NULL
    masks included): a tiled window emits whole partitions chunk by
    chunk, in no SQL order."""
    keys = []
    for v, valid in d.values():
        keys.append(valid)
        keys.append(np.where(valid, v, np.zeros_like(v))
                    if v.dtype != object else v)
    order = np.lexsort(tuple(reversed(keys))) if keys and len(keys[0]) \
        else np.zeros(0, dtype=np.int64)
    return {k: (v[order], valid[order]) for k, (v, valid) in d.items()}


def max_ulps(got: dict, want: dict) -> int:
    """The largest distance in units of the last place between two
    results' float64 columns (0 for none)."""
    worst = 0
    for k, w in want.items():
        w = np.asarray(w)
        if w.dtype.kind != "f":
            continue
        g = np.asarray(got[k]).astype(np.float64).view(np.int64)
        d = np.abs(g - w.astype(np.float64).view(np.int64))
        worst = max(worst, int(d.max()) if d.size else 0)
    return worst


def default_budget_phase(gpu, gds, skew, full: bool) -> dict:
    """Admission at the reference's default budget (4 GiB), planning only
    where a statement is admitted: the phase-3 TPC-H texts, the 30 TPC-DS
    texts and the three window-query selections of phase 5. Exactly
    ``DEFAULT_REFUSED`` and the window query must be over the budget, and
    each of them must raise ResourceError (its plan cannot stream); every
    other statement is admitted (``full``: at SF1 and scale 100; smaller
    data may refuse fewer). ``skew``: (session, text, growths) of the
    phase-6 skew join, whose grown plan must be admitted too."""
    from cloudberry_tpu_torch import tpcds, tpch
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.exec.resource import (ResourceError,
                                                    check_admission,
                                                    estimate_plan_memory)
    from cloudberry_tpu_torch.plan.planner import plan_statement
    from cloudberry_tpu_torch.sql.parser import parse_sql

    texts = [(gpu, f"TPC-H {q}", tpch.QUERIES[q]) for q in EXPECTED]
    texts += [(gds, f"TPC-DS {q}", tpcds.QUERIES[q])
              for q in sorted(tpcds.QUERIES, key=lambda q: int(q[1:]))]
    texts += [(gds, f"window query ({case})",
               tpcds.WINDOW_QUERY.format(where=where))
              for case, where in WINDOW_CASES]
    want = {f"TPC-DS {q}" for q in DEFAULT_REFUSED} | {
        f"window query ({case})" for case, _ in WINDOW_CASES}
    out = {}
    for session, name, sql in texts:
        cfg0 = session.config
        session.config = cfg0.with_overrides(
            **{"resource.query_mem_bytes": DEFAULT_BUDGET})
        try:
            plan = plan_statement(parse_sql(sql), session, {}).plan
            est = estimate_plan_memory(plan).peak_bytes
            outcome = "admitted"
            if est > DEFAULT_BUDGET:
                try:
                    session.sql(sql)
                    outcome = "tiled"
                except ResourceError:
                    outcome = "ResourceError"
        finally:
            session.config = cfg0
        out[name] = {"estimate_bytes": est, "outcome": outcome}
    refused = {n for n, r in out.items() if r["outcome"] == "ResourceError"}
    check((refused == want or not full and refused <= want) and all(
        r["outcome"] == "admitted" for n, r in out.items() if n not in want),
        f"at the default budget: refused {sorted(refused)}, expected "
        f"{sorted(want)}; {out}")
    gsk, sql, growths = skew
    plan = plan_statement(parse_sql(sql), gsk, {}).plan
    for _ in range(growths):
        check(X.grow_expansion(plan, "expansion overflow",
                               allow_fallback=True), "skew join: no growth")
    cfg0 = gsk.config
    gsk.config = cfg0.with_overrides(
        **{"resource.query_mem_bytes": DEFAULT_BUDGET})
    try:
        est = check_admission(plan, gsk).peak_bytes
    finally:
        gsk.config = cfg0
    out["skew join after growth"] = {"estimate_bytes": est,
                                     "growths": growths,
                                     "outcome": "admitted"}
    log(f"[admission] at the default {DEFAULT_BUDGET >> 30} GiB budget: "
        f"ResourceError for {sorted(refused)} (estimates "
        f"{[out[n]['estimate_bytes'] for n in sorted(refused)]} bytes), "
        f"every other phase-3/4/5 statement admitted; the skew join after "
        f"{growths} growth(s) admitted at {est} bytes")
    return out


def tiled_run(kit, session, sql, budget, what, stream, pool=None,
              held=True):
    """One statement at ``budget`` on ``session``: (with ``held``) a
    warm-up run with every kernel call held against its plain version,
    then a counted run with the peak device bytes above the resident
    baseline. Returns (result, row of measurements). The streamed table
    must never be copied to the device whole, and the peak, less what the
    buffer pool admitted during the run, must stay under the budget."""
    torch = kit.torch
    base_cfg = session.config
    if base_cfg.resource.query_mem_bytes != budget:
        # (a store session keeps its own Config object: the buffer pool's
        # keys carry the config's identity)
        session.config = base_cfg.with_overrides(
            **{"resource.query_mem_bytes": budget})
    uploads = []
    real_upload = session.device_table

    def recording(name):
        uploads.append(name)
        return real_upload(name)

    session.device_table = recording
    try:
        if held:
            kit.held(f"{what} (tiled, held)", lambda: session.sql(sql))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pool0 = pool.snapshot()["bytes"] if pool is not None else 0
        res, ms, counts = kit.counted_run(session, sql)
        peak = torch.cuda.max_memory_allocated() - base
        pooled = (pool.snapshot()["bytes"] - pool0) if pool is not None \
            else 0
        rep = session.last_tiled_report
    finally:
        session.config = base_cfg
        del session.device_table
    check(rep is not None and rep["tiled"], f"{what}: did not tile")
    n = rep["n_tiles"]
    pipe = rep.get("pipeline", {})
    row = {"ms": ms, "budget_bytes": budget, "mode": rep.get("mode"),
           "tile_rows": rep["tile_rows"], "n_tiles": n,
           "n_chunks": rep.get("n_chunks"),
           "acc_capacity": rep["acc_capacity"],
           "tile_time": rep.get("tile_time"), "pipeline": pipe,
           "drain_stall_s": rep["drain_stall_s"],
           "inflight_depth": rep["inflight_depth"],
           "tile_window": rep["tile_window"],
           "est_step_bytes": rep["est_step_bytes"],
           "est_pipeline_bytes": rep["est_pipeline_bytes"],
           "peak_above_resident": peak, "pool_admitted_bytes": pooled,
           "launches": counts,
           "launches_per_tile": {k: v / n for k, v in counts.items()}}
    tt = rep.get("tile_time") or {}
    log(f"[tiling] {what}: {ms:.3f} ms, mode {row['mode'] or 'agg'}, "
        f"{n} tiles of {rep['tile_rows']} rows"
        + (f", {row['n_chunks']} chunks" if row["n_chunks"] else "")
        + f", acc {rep['acc_capacity']}; tile ms mean "
        f"{tt.get('mean', 0) * 1e3:.3f} p95 {tt.get('p95', 0) * 1e3:.3f}; "
        f"pipeline stall {pipe.get('stall_s')} s, decode "
        f"{pipe.get('decode_s')} s, read {pipe.get('read_s')} s, overlap "
        f"{pipe.get('overlap_frac')}, parts read {pipe.get('parts_read')} "
        f"resident {pipe.get('parts_resident')}; drain stall "
        f"{rep['drain_stall_s']} s, in-flight depth "
        f"{rep['inflight_depth']} of window {rep['tile_window']}; "
        f"estimate {rep['est_step_bytes']} + {rep['est_pipeline_bytes']} "
        f"bytes; peak {peak} bytes above the resident baseline "
        f"({pooled} admitted to the pool), budget {budget} bytes; "
        f"launches {counts} ({row['launches_per_tile']} per tile)")
    check(stream not in uploads, f"{what}: the streamed table {stream} "
          f"was copied to the device whole")
    check(peak - pooled <= budget, f"{what}: peak {peak} bytes "
          f"above the resident baseline ({pooled} of them pool admissions) "
          f"exceeds the budget {budget}")
    return res, row


def tiling_phase(kit, raw, ram, ram_ms, gpu, gds, args) -> dict:
    """Tiling from RAM (module docstring): TPC-H Q1/Q3/Q5 at SF1 and
    WIN_DS/SORT_DS/TOPN_DS at tpcds-lite scale 100 under budgets that
    force tiling, the two refusals, the dispatch window and the scan
    pipeline on Q3, and the deferred-overflow replay."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.catalog import carry
    from cloudberry_tpu_torch.exec.resource import ResourceError
    from cloudberry_tpu_torch.types import date_to_days as D

    full_h = args.sf == 1.0
    full_ds = args.ds_scale == DS_SCALE
    out = {"tpch": {}, "tpcds": {}}

    def mib(m, scale):
        return max(int(m * scale), 1) << 20

    def expect(what, row, want, full):
        got = (row["mode"], row["tile_rows"], row["n_tiles"],
               row["acc_capacity"])
        check(row["n_tiles"] > 1, f"{what}: {row['n_tiles']} tile(s)")
        if full:
            check(got == want, f"{what}: (mode, tile rows, tiles, "
                  f"accumulator) {got}, the reference decides {want}")

    for q, (m, want) in TILED_TPCH.items():
        sql = tpch.QUERIES[q]
        res, row = tiled_run(kit, gpu, sql, mib(m, args.sf),
                             f"TPC-H {q} at {m} MiB x sf", "lineitem")
        expect(q, row, want, full_h)
        got = physical(res)
        one_shot, ram_fired = ram[q]
        fired = {k for k, v in row["launches"].items() if v}
        check(ram_fired <= fired, f"tiled {q}: launches {row['launches']}, "
              f"the one-shot run launched {sorted(ram_fired)}")
        same(got, oracle(raw, q, D, tiled=True),
             f"tiled {q} vs the numpy oracle (tiled avg order)")
        row["ulps_vs_one_shot"] = max_ulps(got, one_shot)
        ints = {k: v for k, v in got.items()
                if np.asarray(v).dtype.kind != "f"}
        same(ints, {k: one_shot[k] for k in ints},
             f"tiled {q} vs the one-shot run (non-float columns)")
        check(row["ulps_vs_one_shot"] <= 2, f"tiled {q}: floats "
              f"{row['ulps_vs_one_shot']} ulps from the one-shot run")
        row["one_shot_ms"] = float(np.median(ram_ms[q]))
        out["tpch"][q] = row
        log(f"[tiling] TPC-H {q}: equal to the numpy oracle, the one-shot "
            f"run's other columns exactly and its floats within "
            f"{row['ulps_vs_one_shot']} ulp; wall {row['ms']:.3f} ms "
            f"against {row['one_shot_ms']:.3f} ms one-shot")
    for q, m in REFUSED_TPCH:
        cfg0 = gpu.config
        gpu.config = cfg0.with_overrides(
            **{"resource.query_mem_bytes": mib(m, args.sf)})
        try:
            gpu.sql(tpch.QUERIES[q])
            refused = False
        except ResourceError:
            refused = True
        finally:
            gpu.config = cfg0
        if full_h:
            check(refused, f"TPC-H {q} at {m} MiB: not refused, the "
                  "reference raises ResourceError")
        out["tpch"][f"{q}_{m}MiB_refused"] = refused
        log(f"[tiling] TPC-H {q} at {m} MiB x sf: "
            f"{'ResourceError' if refused else 'ran'}")

    for name, (sql, m, want) in TILED_DS.items():
        one, one_ms, one_counts = kit.counted_run(gds, sql)
        res, row = tiled_run(kit, gds, sql, mib(m, args.ds_scale / DS_SCALE),
                             f"{name} at {m} MiB x scale", "store_sales")
        expect(name, row, want, full_ds)
        fired = {k for k, v in row["launches"].items() if v}
        one_fired = {k for k, v in one_counts.items() if v}
        check(one_fired <= fired, f"tiled {name}: launches "
              f"{row['launches']}, the one-shot run {one_counts}")
        if name == "WIN_DS":
            err = same_nulls(sorted_rows(with_nulls(res)),
                             sorted_rows(with_nulls(one)),
                             f"tiled {name} vs the one-shot run (rows "
                             "sorted by every column)")
        else:
            same(physical(res), physical(one),
                 f"tiled {name} vs the one-shot run")
            err = 0.0
        row.update(one_shot_ms=one_ms, rows=res.num_rows(),
                   largest_float_difference=err)
        out["tpcds"][name] = row
        log(f"[tiling] {name}: {res.num_rows()} rows equal to the one-shot "
            f"run (largest float difference {err}); wall {row['ms']:.3f} ms "
            f"against {one_ms:.3f} ms one-shot (launches {one_counts})")

    # the dispatch window and the scan pipeline on the card: bit-identical
    q3 = tpch.QUERIES["q3"]
    b3 = mib(TILED_TPCH["q3"][0], args.sf)
    runs, first = {}, None
    for w in (1, 4):
        for pipe in (False, True):
            cfg0 = gpu.config
            gpu.config = cfg0.with_overrides(**{
                "resource.query_mem_bytes": b3,
                "tile_pipeline.inflight_tiles": w,
                "scan_pipeline.enabled": pipe})
            try:
                res, ms, counts = kit.counted_run(gpu, q3)
                rep = gpu.last_tiled_report
            finally:
                gpu.config = cfg0
            got = physical(res)
            if first is None:
                first = got
            same(got, first, f"Q3 window {w} pipeline {pipe} vs window 1 "
                 "pipeline off")
            p = rep.get("pipeline", {})
            runs[f"window {w}, pipeline {'on' if pipe else 'off'}"] = {
                "ms": ms, "drain_stall_s": rep["drain_stall_s"],
                "inflight_depth": rep["inflight_depth"],
                "stall_s": p.get("stall_s"), "feed_s": p.get("feed_s"),
                "overlap_frac": p.get("overlap_frac"),
                "tile_time": rep.get("tile_time")}
            log(f"[tiling] Q3 window {w}, scan pipeline "
                f"{'on' if pipe else 'off'}: {ms:.3f} ms, drain stall "
                f"{rep['drain_stall_s']} s, depth {rep['inflight_depth']}, "
                f"pipeline {p}; bit-identical to window 1 pipeline off")
    out["q3_window_pipeline"] = runs

    # a merge overflow that drains behind newer in-flight tiles
    rng = np.random.default_rng(3)
    gdf = ct.Session(ct.Config().with_overrides(
        **{"resource.query_mem_bytes": 4 << 20}))
    F = carry.field
    carry.load_encoded(gdf, "fact", [F("k", "int64", 0, False),
                                     F("v", "int64", 0, False)],
                       {"k": rng.integers(0, 10_000, DEFERRED_ROWS),
                        "v": rng.integers(0, 100, DEFERRED_ROWS)})
    sql = ("SELECT k % 7000 AS kk, count(*) AS c, sum(v) AS sv "
           "FROM fact GROUP BY k % 7000 ORDER BY kk LIMIT 50")
    deferred = {}
    for w in (1, 4):
        gdf.config = gdf.config.with_overrides(
            **{"tile_pipeline.inflight_tiles": w})
        c0 = gdf.counters.snapshot()
        res, ms, counts = kit.counted_run(gdf, sql)
        c1 = gdf.counters.snapshot()
        deferred[w] = {k: c1.get(k, 0) - c0.get(k, 0) for k in (
            "tile_deferred_overflows", "tile_window_replays",
            "tile_checkpoints", "tile_resumes")}
        deferred[w].update(ms=ms, result=physical(res),
                           acc_capacity=gdf.last_tiled_report[
                               "acc_capacity"])
    same(deferred[4].pop("result"), deferred[1].pop("result"),
         "deferred overflow: window 4 vs window 1")
    check(deferred[4]["tile_deferred_overflows"] >= 1
          and deferred[4]["tile_window_replays"] >= 1,
          f"window 4 counted no deferred overflow and replay: {deferred}")
    check(deferred[1]["tile_deferred_overflows"] == 0,
          f"window 1 deferred an overflow: {deferred}")
    out["deferred_overflow"] = deferred
    log(f"[tiling] deferred overflow ({DEFERRED_ROWS} rows, k % 7000, "
        f"4 MiB): {deferred}; window 4 equal to window 1")
    out["checkpoint_resume"] = checkpoint_resume(kit)
    return out


def checkpoint_resume(kit) -> dict:
    """A deferred overflow that surfaces behind drained-clean checkpoints:
    few groups in the stream's first 400,000 rows, many in its last
    100,000, a checkpoint every 2 tiles. At window 4 the replay must resume
    from a checkpoint (not re-stream from the first tile) and equal the
    window-1 run and numpy."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch.catalog import carry

    rng = np.random.default_rng(4)
    k = np.concatenate([rng.integers(0, 200, 400_000),
                        rng.integers(0, 30_000, 100_000)])
    v = rng.integers(0, 100, len(k))
    s = ct.Session(ct.Config().with_overrides(**{
        "resource.query_mem_bytes": 4 << 20,
        "recovery.checkpoint_every": 2}))
    F = carry.field
    carry.load_encoded(s, "fact", [F("k", "int64", 0, False),
                                   F("v", "int64", 0, False)],
                       {"k": k, "v": v})
    sql = ("SELECT k % 20000 AS kk, count(*) AS c, sum(v) AS sv "
           "FROM fact GROUP BY k % 20000 ORDER BY kk LIMIT 50")
    kk, inv = np.unique(k % 20_000, return_inverse=True)
    sv = np.zeros(len(kk), dtype=np.int64)
    np.add.at(sv, inv, v)
    want = {"kk": kk[:50], "c": np.bincount(inv)[:50], "sv": sv[:50]}
    out = {}
    for w in (1, 4):
        s.config = s.config.with_overrides(
            **{"tile_pipeline.inflight_tiles": w})
        c0 = s.counters.snapshot()
        res, ms, counts = kit.counted_run(s, sql)
        c1 = s.counters.snapshot()
        rep = s.last_tiled_report
        out[w] = {c: c1.get(c, 0) - c0.get(c, 0) for c in (
            "tile_deferred_overflows", "tile_window_replays",
            "tile_checkpoints", "tile_resumes", "tiles_replayed")}
        out[w].update(ms=ms, n_tiles=rep["n_tiles"],
                      resumed_from_tile=rep.get("resumed_from_tile"))
        same(physical(res), want, f"checkpoint resume, window {w}, vs "
             "numpy")
    check(out[4]["tile_resumes"] >= 1
          and (out[4]["resumed_from_tile"] or 0) > 0,
          f"window 4 did not resume from a checkpoint: {out}")
    log(f"[tiling] checkpoint resume (500000 rows, k % 20000, 4 MiB, a "
        f"checkpoint every 2 tiles): {out}; windows 1 and 4 equal to numpy")
    return out


def tiling_store_runs(kit, raw, ram, cfg, root) -> dict:
    """Q1 and Q3 tiled from phase 9's store: cold (cleared cache scope),
    a second session (the pool admits), a third (pool-served)."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.exec import bufferpool as BUF
    from cloudberry_tpu_torch.sched import sharedcache
    from cloudberry_tpu_torch.types import date_to_days as D

    out = {}
    for q in TILED_STORE:
        m = TILED_TPCH[q][0]
        budget = max(int(m * kit.sf), 1) << 20
        sql = tpch.QUERIES[q]
        one_shot, ram_fired = ram[q]
        sharedcache.drop_store_scope(root)
        rows = []
        # one Config object for the three sessions: pool keys carry it
        tcfg = cfg.with_overrides(**{"resource.query_mem_bytes": budget})
        for tier in ("cold", "pool admits", "pool-served"):
            s = ct.Session(tcfg)
            check(s.catalog.table("lineitem").cold,
                  "a fresh session registered lineitem warm")
            # no held warm-up here: it would count as the tier's scan
            res, row = tiled_run(kit, s, sql, budget,
                                 f"{q} from the store ({tier})", "lineitem",
                                 pool=BUF.pool_for(s), held=False)
            got = physical(res)
            same(got, oracle(raw, q, D, tiled=True),
                 f"{q} tiled from the store ({tier}) vs the numpy oracle")
            fired = {k for k, v in row["launches"].items() if v}
            check(ram_fired <= fired, f"{q} tiled from the store ({tier}): "
                  f"launches {row['launches']}, one-shot {ram_fired}")
            row["tier"] = tier
            row["ulps_vs_one_shot"] = max_ulps(got, one_shot)
            rows.append(row)
        # every kernel call of one more run, held against its plain version
        kit.held(f"{q} tiled from the store", lambda: s.sql(sql))
        del s
        cold, _, served = rows
        check(cold["pipeline"].get("parts_read", 0) > 0,
              f"{q} tiled cold read no partition: {cold['pipeline']}")
        check(served["pipeline"].get("parts_resident", 0) > 0,
              f"{q} tiled pool-served tier: {served['pipeline']}")
        out[q] = rows
    out["q1_half_warm"] = tiling_half_warm(kit, raw, ram, cfg, root)
    return out


def tiling_half_warm(kit, raw, ram, cfg, root) -> dict:
    """Q1 tiled from lineitem_p with every other partition dropped from
    the buffer pool. lineitem_p's range partitions (about 0.9M rows each at
    SF1) do not line up with the power-of-two tiles, so some tiles take
    rows from a pooled partition (device tensors) and from a decoded one
    (pinned host memory): the tile is assembled on the device. Equal to
    the numpy oracle, with the one-shot kernels."""
    import re

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.exec import bufferpool as BUF
    from cloudberry_tpu_torch.exec import scanpipe as SP
    from cloudberry_tpu_torch.sched import sharedcache
    from cloudberry_tpu_torch.types import date_to_days as D

    torch = kit.torch
    budget = max(int(TILED_TPCH["q1"][0] * kit.sf), 1) << 20
    sql = re.sub(r"\blineitem\b", "lineitem_p", tpch.QUERIES["q1"])
    sharedcache.drop_store_scope(root)
    tcfg = cfg.with_overrides(**{"resource.query_mem_bytes": budget})
    for _ in range(2):      # read cold, then admitted to the pool
        ct.Session(tcfg).sql(sql)
    s = ct.Session(tcfg)
    pool = BUF.pool_for(s)
    files = sorted({k[3] for k in pool._entries if k[1] == "lineitem_p"})
    check(len(files) > 1, f"the pool holds {len(files)} lineitem_p "
          "partition(s)")
    pool.sweep(lambda k: k[1] == "lineitem_p" and k[3] in files[1::2])
    mixed = []
    real_upload = SP.DeviceStage.upload

    def pooled(p):      # a pool-served piece: a tensor on the device
        return (torch.is_tensor(p) and p.device.type == s.device.type
                and not p.is_pinned())

    def upload(self, tile):
        for name, v in tile.items():
            if isinstance(v, SP.Mixed) and \
                    len({pooled(p) for p in v.parts}) == 2:
                mixed.append(name)
        return real_upload(self, tile)

    SP.DeviceStage.upload = upload
    try:
        res, row = tiled_run(kit, s, sql, budget,
                             "q1 from lineitem_p (half-warm pool)",
                             "lineitem_p", pool=pool, held=False)
    finally:
        SP.DeviceStage.upload = real_upload
    same(physical(res), oracle(raw, "q1", D, tiled=True),
         "q1 tiled from lineitem_p (half-warm pool) vs the numpy oracle")
    fired = {k for k, v in row["launches"].items() if v}
    check(ram["q1"][1] <= fired, f"q1 from lineitem_p (half-warm pool): "
          f"launches {row['launches']}, one-shot {ram['q1'][1]}")
    p = row["pipeline"]
    check(p.get("parts_resident", 0) > 0 and p.get("parts_read", 0) > 0,
          f"q1 from lineitem_p (half-warm pool): {p}")
    check(len(mixed) > 0, "q1 from lineitem_p (half-warm pool): no tile "
          "held pooled and decoded rows in one column")
    row.update(pooled_partitions_kept=len(files[0::2]),
               mixed_columns=len(mixed))
    log(f"[tiling] q1 from lineitem_p, {len(files[0::2])} of {len(files)} "
        f"pooled partitions kept: {len(mixed)} column(s) of tiles held "
        f"pooled and decoded rows (assembled on the device); equal to the "
        f"numpy oracle")
    del s
    return row


# ------------------------------------------------------------- the phases

def strip_timings(text: str) -> str:
    """EXPLAIN ANALYZE text without what a clock measured: the
    ``Execution time:`` line and every ``<number> ms``."""
    import re

    lines = [ln for ln in text.splitlines()
             if not ln.startswith("Execution time:")]
    out = re.sub(r"\d+(\.\d+)? ms", "<ms>", "\n".join(lines))
    return re.sub(r"overlap \d+%", "overlap <pct>", out)


def root_rows(text: str) -> int:
    """The ``rows=`` of an EXPLAIN ANALYZE text's root node."""
    import re

    m = re.match(r"-> .*?rows=(\d+)", text.splitlines()[0])
    check(m is not None, f"EXPLAIN ANALYZE root has no rows=: {text}")
    return int(m.group(1))


def hist_since(reg, name, before) -> dict:
    """Count, p50 and p95 (bucket upper bounds, seconds) of the samples a
    registry histogram took since ``before`` (its snapshot then)."""
    from cloudberry_tpu_torch.obs.metrics import _Hist

    now = reg.hist(name) or {"buckets": {}, "count": 0, "sum": 0.0}
    before = before or {"buckets": {}, "count": 0, "sum": 0.0}
    h = _Hist()
    for i, c in now["buckets"].items():
        h.counts[int(i)] = c - before["buckets"].get(i, 0)
    h.n = now["count"] - before["count"]
    h.total = now["sum"] - before["sum"]
    return {"count": h.n, "p50": h.quantile(0.5), "p95": h.quantile(0.95),
            "mean": h.total / h.n if h.n else 0.0}


def span_split(traces) -> dict:
    """Per stage, the seconds of each traced statement (its spans of that
    name summed), plus the statement root's and what no stage covers."""
    out = {st: [] for st in TRACE_STAGES + ("statement", "other")}
    for tr in traces:
        dur = {}
        for e in tr["events"]:
            dur[e["name"]] = dur.get(e["name"], 0.0) + e["dur"] / 1e6
        for st in TRACE_STAGES + ("statement",):
            out[st].append(dur.get(st, 0.0))
        out["other"].append(dur.get("statement", 0.0) - sum(
            dur.get(st, 0.0) for st in TRACE_STAGES))
    return out


def telemetry_phase(kit, ram, gpu, cpu, gds, args) -> dict:
    """The statement pipeline's telemetry on phase 3's and 4's tables
    (module docstring, phase 10)."""
    import dataclasses
    import threading

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpcds, tpch
    from cloudberry_tpu_torch.catalog import carry
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.exec.resource import (RunawayError,
                                                    estimate_plan_memory)
    from cloudberry_tpu_torch.obs import flightrec as OF
    from cloudberry_tpu_torch.obs import progress as OP
    from cloudberry_tpu_torch.obs.trace import chrome_trace
    from cloudberry_tpu_torch.plan.planner import plan_statement
    from cloudberry_tpu_torch.sql.parser import parse_sql
    from cloudberry_tpu_torch.utils import faultinject as FI

    out = {}
    reg = gpu.stmt_log.registry
    obs_on = gpu.config.obs

    # ------------------------------------------- EXPLAIN ANALYZE on the card
    cds = ct.Session(gds.config, device="cpu")
    copy_tables(gds, cds, list(tpcds.SCHEMAS))
    ea = {}
    for name, gs, cs, sql in (
            ("q1", gpu, cpu, tpch.QUERIES["q1"]),
            ("q3", gpu, cpu, tpch.QUERIES["q3"]),
            ("q5", gpu, cpu, tpch.QUERIES["q5"]),
            ("tpcds q98", gds, cds, tpcds.QUERIES["q98"])):
        metrics = []
        gs.metrics_hooks.append(metrics.append)
        try:
            kit.held(f"EXPLAIN ANALYZE {name} (held)",
                     lambda: gs.explain_analyze(sql))
            res, sql_ms, sql_counts = kit.counted_run(gs, sql)
            text, ea_ms, ea_counts = kit.counted(
                lambda: gs.explain_analyze(sql))
        finally:
            gs.metrics_hooks.remove(metrics.append)
        want = cs.explain_analyze(sql)
        check(strip_timings(text) == strip_timings(want),
              f"EXPLAIN ANALYZE {name}: the card's text differs from the "
              f"CPU run's:\n{text}\n--- CPU ---\n{want}")
        check(root_rows(text) == res.num_rows(),
              f"EXPLAIN ANALYZE {name}: root rows={root_rows(text)}, the "
              f"statement returned {res.num_rows()}")
        check(ea_counts == sql_counts,
              f"EXPLAIN ANALYZE {name}: launches {ea_counts}, sql "
              f"launches {sql_counts}")
        m = metrics[-1]
        ea[name] = {"sql_ms": sql_ms, "ea_ms": ea_ms, "exec_s": m.wall_s,
                    "compile_s_first": metrics[0].compile_s,
                    "compile_s": m.compile_s, "launches": ea_counts,
                    "rows": res.num_rows(),
                    "text": strip_timings(text)}
        log(f"[telemetry] EXPLAIN ANALYZE {name}: text equal to the CPU "
            f"run's (timings stripped), root rows={res.num_rows()}, "
            f"launches {ea_counts} = sql's; exec_s {m.wall_s * 1e3:.3f} ms "
            f"(EXPLAIN ANALYZE wall {ea_ms:.3f} ms, sql wall {sql_ms:.3f} "
            f"ms), compile_s {metrics[0].compile_s} s at its first call, "
            f"{m.compile_s} s later")
        log("[telemetry]   " + text.replace("\n", "\n[telemetry]   "))
    del cds
    out["explain_analyze"] = ea
    out["kernel_build_s"] = kit.build_s
    out["compiles"] = gpu.stmt_log.counter("compiles")
    log(f"[telemetry] kernel library built by nvcc in phase 2 "
        f"({kit.build_s:.2f} s), before any statement: every later "
        f"compile_s is 0.0; compiles counter {out['compiles']}")

    # ------------------------------------------- the host-time split
    stages = {}
    for q in ("q1", "q3", "q5"):
        sql = tpch.QUERIES[q]
        before = {st: reg.hist(f"stage_seconds.{st}") for st in STAGES}
        walls = []
        for _ in range(TELEMETRY_RUNS):
            t0 = time.perf_counter()
            gpu.sql(sql)
            kit.torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        hists = {st: hist_since(reg, f"stage_seconds.{st}", before[st])
                 for st in STAGES}
        for st, h in hists.items():
            check(h["count"] == TELEMETRY_RUNS,
                  f"{q}: {h['count']} {st} samples for {TELEMETRY_RUNS} "
                  f"statements")
        split = span_split(gpu.stmt_log.traces(TELEMETRY_RUNS))
        exact = {st: {"p50": float(np.median(v)),
                      "p95": float(np.percentile(v, 95))}
                 for st, v in split.items()}
        stages[q] = {"hist": hists, "spans": exact,
                     "wall_p50": float(np.median(walls)),
                     "wall_p95": float(np.percentile(walls, 95))}
        log(f"[telemetry] {q} host-time split over {TELEMETRY_RUNS} runs "
            f"(trace spans, median/p95 ms): " + ", ".join(
                f"{st} {exact[st]['p50'] * 1e3:.3f}/"
                f"{exact[st]['p95'] * 1e3:.3f}"
                for st in TRACE_STAGES + ("other", "statement"))
            + f"; wall {stages[q]['wall_p50'] * 1e3:.3f}/"
            f"{stages[q]['wall_p95'] * 1e3:.3f}; stage histograms "
            "(p50/p95 bucket bounds, ms): " + ", ".join(
                f"{st} {h['p50'] * 1e3:.3f}/{h['p95'] * 1e3:.3f}"
                for st, h in hists.items()))
    out["stages"] = stages

    # ------------------------------------------- obs on against off
    obs_off = dataclasses.replace(obs_on, enabled=False)
    onoff = {}
    for q in ("q1", "q3", "q5"):
        sql = tpch.QUERIES[q]
        walls = {"on": [], "off": []}
        for i in range(TELEMETRY_RUNS):
            for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
                gpu.stmt_log.configure_obs(obs_on if mode == "on"
                                           else obs_off)
                t0 = time.perf_counter()
                gpu.sql(sql)
                kit.torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
        gpu.stmt_log.configure_obs(obs_on)
        onoff[q] = {m: float(np.median(w)) for m, w in walls.items()}
        onoff[q]["runs"] = walls
        log(f"[telemetry] {q} obs on {onoff[q]['on'] * 1e3:.3f} ms, off "
            f"{onoff[q]['off'] * 1e3:.3f} ms (medians of {TELEMETRY_RUNS} "
            f"interleaved runs each)")
    out["obs_on_off"] = onoff

    # ------------------------------------------- Q5's trace coverage
    t0 = time.perf_counter()
    gpu.sql(tpch.QUERIES["q5"])
    wall = time.perf_counter() - t0
    tr = gpu.stmt_log.traces(1)[0]
    root = next(e for e in tr["events"] if e["name"] == "statement")
    cover = root["dur"] / 1e6 / wall
    names = {e["name"] for e in tr["events"]}
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "telemetry_q5_trace.json")
    with open(path, "w") as fh:
        json.dump(chrome_trace([tr]), fh)
    check(cover >= 0.95 and {"parse", "plan", "queue-wait",
                             "launch"} <= names,
          f"Q5 trace: root covers {cover:.4f} of the wall, spans {names}")
    out["q5_trace_coverage"] = cover
    log(f"[telemetry] Q5 trace: the statement span covers {cover:.4f} of "
        f"the {wall * 1e3:.3f} ms wall; spans {sorted(names)}; Chrome "
        f"trace written to {path}")

    # ------------------------------------------- tiled Q1: tiles, progress
    budget = max(int(TILED_TPCH["q1"][0] * args.sf), 1) << 20
    cfg0 = gpu.config
    fracs = []
    real_update = OP.Progress.update

    def spy(self, *a, **k):
        real_update(self, *a, **k)
        fracs.append(self.fraction)

    OP.Progress.update = spy
    gpu.config = cfg0.with_overrides(**{"resource.query_mem_bytes": budget})
    try:
        before = reg.hist("tile_seconds")
        res, ms, counts = kit.counted_run(gpu, tpch.QUERIES["q1"])
        rep = gpu.last_tiled_report
    finally:
        gpu.config = cfg0
        OP.Progress.update = real_update
    h = hist_since(reg, "tile_seconds", before)
    final = gpu.stmt_log.recent(1)[0].get("progress")
    check(rep is not None and h["count"] == rep["n_tiles"],
          f"tiled Q1: {h['count']} tile_seconds samples, report {rep}")
    check(final == 1.0 and fracs and fracs[-1] < 1.0 and all(
        a <= b for a, b in zip(fracs, fracs[1:])),
          f"tiled Q1: progress {fracs} then {final}")
    check(res.num_rows() == len(next(iter(ram["q1"][0].values()))),
          f"tiled Q1: {res.num_rows()} rows")
    out["tiled_q1"] = {"ms": ms, "n_tiles": rep["n_tiles"],
                       "tile_seconds": h, "progress": fracs + [final],
                       "launches": counts}
    log(f"[telemetry] tiled Q1 at {budget >> 20} MiB: {rep['n_tiles']} "
        f"tiles, {h['count']} tile_seconds samples (p50 "
        f"{h['p50'] * 1e3:.3f} ms, p95 {h['p95'] * 1e3:.3f} ms), progress "
        f"{[round(f, 4) for f in fracs]} then exactly {final}, "
        f"{ms:.3f} ms, launches {counts}")

    # ------------------------------------------- two threads, one slot
    gpu.sql("create resource queue one with (active_statements=1)")
    q = gpu.catalog.resource_queues["one"]
    gpu.config = cfg0.with_overrides(**{"resource.query_mem_bytes": budget,
                                        "resource.queue": "one"})
    results, seen = {}, {"waiting": 0, "active": 0}
    stop = threading.Event()

    def run(tag):
        results[tag] = physical(gpu.sql(tpch.QUERIES["q1"]))

    def poll():
        while not stop.is_set():
            seen["waiting"] = max(seen["waiting"], q.waiting)
            seen["active"] = max(seen["active"], q.active)
            time.sleep(0.0002)

    # the first statement's first tiles sleep (a fault point in the tile
    # loop), so it still holds the slot when the second one asks
    FI.inject_fault("tile_step", "sleep", sleep_s=0.05, end_hit=6)
    poller = threading.Thread(target=poll)
    first = threading.Thread(target=run, args=("first",))
    second = threading.Thread(target=run, args=("second",))
    t0 = time.perf_counter()
    try:
        poller.start()
        first.start()
        end = time.monotonic() + 30
        while q.active == 0 and first.is_alive() \
                and time.monotonic() < end:
            time.sleep(0.0002)
        second.start()
        first.join(60)
        second.join(60)
    finally:
        FI.reset_fault("tile_step")
        stop.set()
        poller.join(5)
        gpu.config = cfg0
    wall = time.perf_counter() - t0
    waits = [e["dur"] / 1e3 for tr in gpu.stmt_log.traces(2)
             for e in tr["events"] if e["name"] == "queue-wait"]
    gpu.sql("drop resource queue one")
    check(not first.is_alive() and not second.is_alive()
          and set(results) == {"first", "second"},
          f"queue: statements did not finish ({sorted(results)})")
    same(results["second"], results["first"], "queue: second vs first")
    check(seen["waiting"] >= 1 and seen["active"] == 1 and q.active == 0,
          f"queue ACTIVE_STATEMENTS 1: {seen}, active now {q.active}")
    out["queue"] = {"max_waiting": seen["waiting"],
                    "max_active": seen["active"], "wall_s": wall,
                    "queue_wait_ms": waits}
    log(f"[telemetry] resource queue ACTIVE_STATEMENTS 1, two threads "
        f"running tiled Q1: the second waited (waiting peaked at "
        f"{seen['waiting']}, active at {seen['active']}), queue-wait spans "
        f"{[round(w, 3) for w in waits]} ms, both equal, {wall:.3f} s")

    # ------------------------------------------- runaway on the skew join
    pk_, pv_, bk_, bv_ = skew_join_tables(SKEW_ROWS)
    F = carry.field
    skew_sql = ("select count(*) as c, sum(f.v + d.w) as s from f join d "
                "on f.k = d.k")

    def skew_session(cfg):
        s = ct.Session(cfg, device=gpu.device)
        carry.load_encoded(s, "f", [F("k", "int64", 0, False),
                                    F("v", "int64", 0, False)],
                           {"k": pk_, "v": pv_})
        carry.load_encoded(s, "d", [F("k", "int64", 0, False),
                                    F("w", "int64", 0, False)],
                           {"k": bk_, "w": bv_})
        return s

    plan = plan_statement(parse_sql(skew_sql), skew_session(cfg0), {}).plan
    est1 = estimate_plan_memory(plan).peak_bytes
    check(X.grow_expansion(plan, "expansion overflow", allow_fallback=True),
          "skew join: no growth")
    est2 = estimate_plan_memory(plan).peak_bytes
    red = (est1 + est2) // 2
    rz = skew_session(cfg0.with_overrides(
        **{"resource.total_mem_bytes": red}))
    err = None
    try:
        kit.counted_run(rz, skew_sql)
    except RunawayError as e:
        err = e
    check(err is not None and rz.growth_events == 1
          and rz.last_tiled_report is None and rz._vmem.used == 0,
          f"skew join under a {red}-byte red line: {err!r}, growths "
          f"{rz.growth_events}, tiled {rz.last_tiled_report}")
    out["runaway"] = {"est_first": est1, "est_grown": est2,
                      "total_mem_bytes": red, "error": str(err)}
    log(f"[telemetry] skew join ({SKEW_ROWS} probe rows) under "
        f"total_mem_bytes {red} (estimates {est1} first, {est2} grown): "
        f"RunawayError at growth 1, not tiled: {err}")
    del rz

    # ------------------------------------------- the flight recorder
    gpu.stmt_log.configure_obs(dataclasses.replace(obs_on, slow_ms=1.0))
    try:
        res = gpu.sql(tpch.QUERIES["q3"])
        bundle = gpu.stmt_log.flights(1)[0]
    finally:
        gpu.stmt_log.configure_obs(obs_on)
    want = OF.result_digest(cpu.sql(tpch.QUERIES["q3"]))
    check(bundle["reason"] == "slow" and bundle["result"] == want
          and bundle["sql"] == tpch.QUERIES["q3"],
          f"Q3 flight bundle: {bundle.get('reason')}, digest "
          f"{bundle.get('result')} against the CPU run's {want}")
    json.dumps(bundle)
    out["flight"] = {"wall_s": bundle["wall_s"], "result": bundle["result"],
                     "keys": sorted(bundle)}
    log(f"[telemetry] Q3 flight bundle (slow_ms 1): wall "
        f"{bundle['wall_s'] * 1e3:.3f} ms, result digest "
        f"{bundle['result']['sha256'][:16]}... over {bundle['result']['rows']} "
        f"rows equal to the CPU run's; keys {sorted(bundle)}")
    return out


# -------------------------------------- statement cache and generic plans


def empty_caches(session) -> None:
    """Clear a session's statement cache and its scope's generic plans,
    each under its lock."""
    with session._stmt_lock:
        session._stmt_cache.clear()
    with session._generic_lock:
        session._generic_cache.clear()


class EmptyCaches:
    """While active, every ``Session.sql`` first empties the session's
    statement cache and generic plans: phases 3 to 10 take their timed
    and counted runs with both caches empty, so their numbers stay
    comparable with the PRs before the caches. ``real`` is the method
    that keeps the caches."""

    def __init__(self, session_cls):
        self.cls = session_cls
        self.real = session_cls.sql

    def __enter__(self):
        real = self.real

        def sql(session, *a, **kw):
            empty_caches(session)
            return real(session, *a, **kw)

        self.cls.sql = sql
        return self

    def __exit__(self, *exc):
        self.cls.sql = self.real


def stage_split(log_, before, n) -> dict:
    """The host-time split of the last ``n`` statements of a statement
    log (trace spans, medians and p95 in seconds) and the stage
    histograms' samples since ``before``."""
    reg = log_.registry
    split = span_split(log_.traces(n))
    return {"spans": {st: {"p50": float(np.median(v)),
                           "p95": float(np.percentile(v, 95))}
                      for st, v in split.items()},
            "raw": split,
            "hist": {st: hist_since(reg, f"stage_seconds.{st}", before[st])
                     for st in STAGES}}


def fmt_split(spans) -> str:
    return ", ".join(f"{st} {spans[st]['p50'] * 1e3:.3f}/"
                     f"{spans[st]['p95'] * 1e3:.3f}"
                     for st in TRACE_STAGES + ("other", "statement"))


def store_repeats(kit, s, q, sql, want, reads, served_ms) -> dict:
    """Phase 11, step 5, run inside phase 9 on its third (pool-served)
    session: exact repeats of a statement whose runner the session has
    cached, with the statement cache kept (``kit.cached_sql``). No parse,
    no plan and so no manifest read; each repeat equal to the RAM path.
    ``served_ms``: the pool-served tier's wall (it parsed and planned)."""
    log_ = s.stmt_log
    before = {st: log_.registry.hist(f"stage_seconds.{st}")
              for st in STAGES}
    hits0, m0 = s.counters.counter("stmt_cache_hits"), reads["manifests"]
    walls = []
    for _ in range(STORE_REPEATS):
        res, ms, counts = kit.counted(lambda: kit.cached_sql(s, sql))
        same(physical(res), want, f"{q} exact repeat from the store")
        check(EXPECTED[q] <= {k for k, v in counts.items() if v},
              f"{q} exact repeat from the store: launches {counts}")
        walls.append(ms)
    hits = s.counters.counter("stmt_cache_hits") - hits0
    manifests = reads["manifests"] - m0
    split = stage_split(log_, before, STORE_REPEATS)
    check(hits == STORE_REPEATS, f"{q} from the store: {hits} statement-"
          f"cache hits in {STORE_REPEATS} exact repeats")
    check(split["hist"]["plan"]["count"] == 0
          and split["hist"]["parse"]["count"] == 0,
          f"{q} from the store: exact repeats parsed or planned")
    check(manifests == 0, f"{q} from the store: {manifests} manifest "
          "read(s) in exact repeats")
    out = {"ms": walls, "p50": float(np.median(walls)),
           "pool_served_ms": served_ms,
           "stmt_cache_hits": hits, "manifest_reads": manifests,
           "spans": split["spans"]}
    log(f"[stmtcache] {q} from the store, pool-served session, "
        f"{STORE_REPEATS} exact repeats: {hits} statement-cache hits, "
        f"no parse or plan, {manifests} manifest reads; wall ms median "
        f"{out['p50']:.3f} ({min(walls):.3f}-{max(walls):.3f}; the "
        f"pool-served tier {served_ms:.3f}); split (median/p95 ms): "
        f"{fmt_split(split['spans'])}; equal to the RAM path")
    return out


def stmt_cache_phase(kit, raw, gpu, cpu, names, store, args) -> dict:
    """Phase 11 (module docstring): the statement cache and generic plans
    on phase 3's tables, their invalidation, UDFs and table functions on
    the card. ``store``: phase 9's exact repeats (``store_repeats``)."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import types as T
    from cloudberry_tpu_torch.catalog import carry
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.exec import tablefunc as TF
    from cloudberry_tpu_torch.exec import udf as U
    from cloudberry_tpu_torch.types import date_to_days as D

    out = {}
    # a fresh session with generic plans on, and one with the port's
    # default, off
    g = ct.Session(gpu.config.with_overrides(
        **{"sched.generic_plans": True}), device=gpu.device)
    copy_tables(gpu, g, names)
    off = ct.Session(gpu.config, device=gpu.device)
    check(not off.config.sched.generic_plans, "generic plans on by default")
    copy_tables(gpu, off, names)
    builds = [0]
    real_compile = X.compile_plan

    def counting_compile(*a, **kw):
        builds[0] += 1
        return real_compile(*a, **kw)

    X.compile_plan = counting_compile
    try:
        out.update(_stmt_cache_runs(kit, raw, g, off, cpu, builds, args))
    finally:
        X.compile_plan = real_compile
    out["store"] = store

    # ------------------------------------------- 6. invalidation
    F = carry.field
    n = 100_000
    carry.load_encoded(g, "inv", [F("k", "int64", 0, False),
                                  F("v", "int64", 0, False)],
                       {"k": np.arange(n, dtype=np.int64),
                        "v": np.arange(n, dtype=np.int64) % 1000})
    q = "select count(*) as c, sum(v) as s from inv where k >= 0"
    first = physical(g.sql(q))
    hits = g.counters.counter("stmt_cache_hits")
    physical(g.sql(q))
    check(g.counters.counter("stmt_cache_hits") == hits + 1,
          "invalidation: the repeat was not a statement-cache hit")
    g.sql("insert into inv values (5000000, 7)")
    plans = g.stmt_log.registry.hist("stage_seconds.plan")["count"]
    after = physical(g.sql(q))
    check(g.counters.counter("stmt_cache_hits") == hits + 1
          and g.stmt_log.registry.hist("stage_seconds.plan")["count"]
          == plans + 1,
          "invalidation: the statement after the INSERT did not re-plan")
    check(int(after["c"][0]) == int(first["c"][0]) + 1
          and int(after["s"][0]) == int(first["s"][0]) + 7,
          f"invalidation: {first} then {after} after the INSERT")
    U.register_function("cb_scaled", lambda x: x * 3, [T.INT64], T.INT64,
                        jit=True)
    try:
        uq = "select sum(cb_scaled(v)) as s from inv where k >= 0"
        s1 = physical(g.sql(uq))
        hits = g.counters.counter("stmt_cache_hits")
        physical(g.sql(uq))
        check(g.counters.counter("stmt_cache_hits") == hits + 1,
              "UDF statement: the repeat was not a cache hit")
        U.register_function("cb_scaled", lambda x: x * 5, [T.INT64],
                            T.INT64, jit=True)
        s2 = physical(g.sql(uq))
        check(g.counters.counter("stmt_cache_hits") == hits + 1
              and int(s2["s"][0]) * 3 == int(s1["s"][0]) * 5,
              f"UDF re-registered: {s1} then {s2}, the cache served")
    finally:
        U.unregister_function("cb_scaled")
    calls = [0]

    def ticker(m):
        calls[0] += 1
        return {"t": np.arange(int(m) + calls[0], dtype=np.int64)}

    TF.register_table_function("cb_ticker", ticker)
    gs_q = ("select count(*) as c from inv join generate_series(1, 10) g "
            "on k = g.generate_series")
    tk_q = "select count(*) as c from inv join cb_ticker(3) t on k = t.t"
    hits = g.counters.counter("stmt_cache_hits")
    gens = []
    for _ in range(2):
        check(int(physical(g.sql(gs_q))["c"][0]) == 10,
              "generate_series join: wrong count")
        (tname,) = [t for t in g.catalog.tables
                    if t.startswith("$tf_generate_series")]
        gens.append(g.catalog.table(tname)._version)
    counts = [int(physical(g.sql(tk_q))["c"][0]) for _ in range(2)]
    check(g.counters.counter("stmt_cache_hits") == hits
          and gens[0] != gens[1] and calls[0] == 2 and counts == [4, 5],
          "table functions: hits "
          f"{g.counters.counter('stmt_cache_hits') - hits}"
          f", generate_series versions {gens}, ticker calls {calls[0]} "
          f"counts {counts}")
    out["invalidation"] = {
        "counts": [int(first["c"][0]), int(after["c"][0])],
        "udf_sums": [int(s1["s"][0]), int(s2["s"][0])],
        "generate_series_versions": gens, "ticker_counts": counts}
    log(f"[stmtcache] invalidation: an INSERT into inv re-planned the "
        f"cached statement (count {int(first['c'][0])} -> "
        f"{int(after['c'][0])}); re-registering cb_scaled missed the cache "
        f"(sum {int(s1['s'][0])} -> {int(s2['s'][0])}); generate_series "
        f"re-materialized every statement (versions {gens}) and cb_ticker "
        f"ran at each statement (counts {counts}), no cache hit")

    # ------------------------------------------- 7. UDFs on the card
    U.register_function("cb_weight", lambda x: x % 7, [T.INT64], T.INT64,
                        jit=True)
    U.register_function("cb_flag", lambda s: {"A": "accepted",
                                              "N": "none",
                                              "R": "returned"}[s],
                        [T.STRING], T.STRING)
    try:
        uq = ("select cb_flag(l_returnflag) as flag, l_linestatus, "
              "sum(cb_weight(l_orderkey)) as w, sum(l_quantity) as q, "
              "count(*) as c from lineitem where l_shipdate <= date "
              "'1998-09-02' group by cb_flag(l_returnflag), l_linestatus "
              "order by flag, l_linestatus")
        kit.held("UDF Q1-shaped aggregate (held)", lambda: g.sql(uq))
        res, ms, counts = kit.counted(lambda: g.sql(uq))
        got = physical(res)
        same(got, physical(cpu.sql(uq)), "UDF Q1-shaped aggregate vs the "
             "port on the CPU")
        li = raw["lineitem"]
        m = li["l_shipdate"] <= D("1998-09-02")
        check(int(got["c"].sum()) == int(m.sum())
              and int(got["w"].sum()) == int((li["l_orderkey"][m] % 7).sum()),
              f"UDF Q1-shaped aggregate: {got}")
        check(any(counts.values()), f"UDF aggregate: no kernel ran "
              f"({counts})")
        out["udf"] = {"ms": ms, "launches": counts,
                      "rows": res.num_rows()}
        log(f"[stmtcache] a tensor UDF (cb_weight) and a dictionary-rewrite"
            f" UDF (cb_flag) in a Q1-shaped aggregate: {res.num_rows()} "
            f"rows in {ms:.3f} ms, launches {counts}; equal to the CPU run "
            f"and numpy")
    finally:
        U.unregister_function("cb_weight")
        U.unregister_function("cb_flag")
    del g, off
    return out


def _stmt_cache_runs(kit, raw, g, off, cpu, builds, args) -> dict:
    """Phase 11, steps 1 to 4 and 8 (module docstring)."""
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.types import date_to_days as D

    out = {}
    log_ = g.stmt_log
    reg = log_.registry

    # ------------------------------------------- 1. exact repeats
    repeats = {}
    for q in ("q1", "q3", "q5"):
        sql = tpch.QUERIES[q]
        want = oracle(raw, q, D)
        b0 = g.counters.counter("generic_builds")
        res, first_ms, counts = kit.counted(lambda: g.sql(sql))
        same(physical(res), want, f"{q} first run vs the numpy oracle")
        check(g.counters.counter("generic_builds") == b0 + 1,
              f"{q}: the first run built no generic plan")
        before = {st: reg.hist(f"stage_seconds.{st}") for st in STAGES}
        hits0, c0 = g.counters.counter("stmt_cache_hits"), builds[0]
        walls = []
        for _ in range(STMT_REPEATS):
            res, ms, counts = kit.counted(lambda: g.sql(sql))
            same(physical(res), want, f"{q} exact repeat vs the numpy "
                 "oracle")
            check(EXPECTED[q] <= {k for k, v in counts.items() if v},
                  f"{q} exact repeat: launches {counts}")
            walls.append(ms)
        hits = g.counters.counter("stmt_cache_hits") - hits0
        split = stage_split(log_, before, STMT_REPEATS)
        check(hits == STMT_REPEATS and builds[0] == c0,
              f"{q}: {hits} statement-cache hits and "
              f"{builds[0] - c0} compile_plan calls in {STMT_REPEATS} "
              f"exact repeats")
        check(all(v == 0.0 for st in ("parse", "plan")
                  for v in split["raw"][st])
              and split["hist"]["parse"]["count"] == 0
              and split["hist"]["plan"]["count"] == 0,
              f"{q}: an exact repeat recorded a parse or plan span")
        del split["raw"]
        repeats[q] = {"first_ms": first_ms, "ms": walls,
                      "wall_p50": float(np.median(walls)),
                      "wall_p95": float(np.percentile(walls, 95)),
                      "stmt_cache_hits": hits, **split}
        log(f"[stmtcache] {q}: first run {first_ms:.3f} ms (a miss and a "
            f"generic build), {STMT_REPEATS} exact repeats "
            f"{repeats[q]['wall_p50']:.3f}/{repeats[q]['wall_p95']:.3f} ms "
            f"(median/p95), {hits} statement-cache hits, no parse or plan "
            f"span, no compile_plan; split (median/p95 ms): "
            f"{fmt_split(split['spans'])}; every repeat equal to the numpy "
            f"oracle with launches {counts}")
    out["exact"] = repeats

    # ------------------------------------------- 2. perturbed literals
    perturbed = {}
    for q, swaps in PERTURBED.items():
        for old, new in swaps:
            sql = tpch.QUERIES[q]
            check(old in sql, f"{q}: {old} not in the text")
            text = sql.replace(old, new)
            h0, b0 = (g.counters.counter("generic_hits"),
                      g.counters.counter("generic_builds"))
            c0 = builds[0]
            res, ms, counts = kit.counted(lambda: g.sql(text))
            hits = g.counters.counter("generic_hits") - h0
            new_builds = g.counters.counter("generic_builds") - b0
            check(hits == 1 and new_builds == 0 and builds[0] == c0,
                  f"{q} {old}->{new}: generic hits {hits}, builds "
                  f"{new_builds}, compile_plan calls {builds[0] - c0}")
            check(EXPECTED[q] <= {k for k, v in counts.items() if v},
                  f"{q} {old}->{new}: launches {counts}")
            got = physical(res)
            same(got, physical(off.sql(text)), f"{q} {old}->{new} vs "
                 "generic plans off (bit for bit)")
            same(got, physical(cpu.sql(text)), f"{q} {old}->{new} vs the "
                 "port on the CPU")
            perturbed[f"{q} {old}->{new}"] = {
                "ms": ms, "rows": len(next(iter(got.values()))),
                "launches": counts}
            log(f"[stmtcache] {q} with {old} -> {new}: a generic hit (no "
                f"build, no compile_plan), {ms:.3f} ms, launches {counts}; "
                "bit-identical to the generic-off CUDA session and equal "
                "to the CPU run")
    out["perturbed"] = perturbed

    # ------------------------------------------- 3. generic on against off
    pairs = {}
    for q, (old, fmt) in DISTINCT.items():
        sql = tpch.QUERIES[q]
        on_ms, off_ms = [], []
        h0 = g.counters.counter("generic_hits")
        c0 = builds[0]
        for i in range(GENERIC_PAIRS):
            text = sql.replace(old, fmt.format(i + 1))
            for s, walls in ((g, on_ms), (off, off_ms)):
                res, ms, counts = kit.counted(lambda: s.sql(text))
                check(EXPECTED[q] <= {k for k, v in counts.items() if v},
                      f"{q} on/off pair: launches {counts}")
                walls.append(ms)
        hits = g.counters.counter("generic_hits") - h0
        check(hits == GENERIC_PAIRS and builds[0] - c0 == GENERIC_PAIRS,
              f"{q} on/off: {hits} generic hits, {builds[0] - c0} "
              f"compile_plan calls (the off session's)")
        pairs[q] = {"on_ms": on_ms, "off_ms": off_ms,
                    "on_p50": float(np.median(on_ms)),
                    "off_p50": float(np.median(off_ms))}
        log(f"[stmtcache] {q} generic plans on / off, {GENERIC_PAIRS} "
            f"interleaved pairs of distinct texts (statement cache "
            f"missing): medians {pairs[q]['on_p50']:.3f} / "
            f"{pairs[q]['off_p50']:.3f} ms "
            f"({(pairs[q]['on_p50'] / pairs[q]['off_p50'] - 1) * 100:+.1f} "
            f"%); quartiles on {np.percentile(on_ms, 25):.3f}-"
            f"{np.percentile(on_ms, 75):.3f}, off "
            f"{np.percentile(off_ms, 25):.3f}-"
            f"{np.percentile(off_ms, 75):.3f}")
    out["generic_on_off"] = pairs

    # ------------------------------------------- 4. the cached tiled runner
    budget = max(int(TILED_TPCH["q1"][0] * args.sf), 1) << 20
    cfg0 = g.config
    g.config = cfg0.with_overrides(**{"resource.query_mem_bytes": budget})
    try:
        sql = tpch.QUERIES["q1"]
        res1, ms1, counts1 = kit.counted(lambda: g.sql(sql))
        rep1 = g.last_tiled_report
        hits0 = g.counters.counter("stmt_cache_hits")
        res2, ms2, counts2 = kit.counted(lambda: g.sql(sql))
        rep2 = g.last_tiled_report
    finally:
        g.config = cfg0
    check(rep1 is not None and rep1["tiled"] and rep2 is not None
          and rep2["tiled"] and rep2["n_tiles"] == rep1["n_tiles"],
          f"tiled Q1 at {budget} bytes: reports {rep1} then {rep2}")
    check(g.counters.counter("stmt_cache_hits") == hits0 + 1,
          "tiled Q1: the second run was not a statement-cache hit")
    same(physical(res2), physical(res1), "tiled Q1 from the cache vs its "
         "first run")
    same(physical(res1), oracle(raw, "q1", D, tiled=True),
         "tiled Q1 vs the numpy oracle (tiled order)")
    check(counts1 == counts2 and EXPECTED["q1"] <= {
        k for k, v in counts2.items() if v},
        f"tiled Q1: launches {counts1} then {counts2}")
    out["tiled_q1"] = {"budget_bytes": budget, "ms": [ms1, ms2],
                       "n_tiles": rep2["n_tiles"], "launches": counts2}
    log(f"[stmtcache] tiled Q1 at {budget >> 20} MiB: {ms1:.3f} ms, then "
        f"{ms2:.3f} ms from the statement cache ({rep2['n_tiles']} tiles, "
        f"last_tiled_report set), equal to the first run and the numpy "
        f"oracle, launches {counts2} each")

    # ------------------------------------------- 8. kernel checks
    for q in ("q1", "q3", "q5"):
        text = tpch.QUERIES[q]
        for old, new in PERTURBED[q][:1]:
            text = text.replace(old, new)
        kit.held(f"{q} cached (held)", lambda: g.sql(tpch.QUERIES[q]))
        kit.held(f"{q} generic rebind (held)", lambda: g.sql(text))
    return out


# ----------------------------------------------------- 12. distributed


DIST_NSEG = 8            # BASELINE.md configs #4-#5: 8 segments
DIST_RUNS = 1            # timed runs per statement at 8 (4) and 1 segment
DIST_BIG_NSEG = 4        # config #3: TPC-H Q5/Q9 over 4 segments
# BASELINE.md config #3 is SF10; SF10's generation and load alone took
# 220.9 s on one H100's machine, which the 1,200 s limit cannot hold
# beside the earlier phases; SF1 leaves room for phase 19's cluster parts
# and its store part (SF4 took 78.0 s, SF2 34.8-39.8 s; PERF.md §4)
DIST_BIG_SF = 1.0
# per-query budget and red line that admit the big Q5/Q9 (the reference's
# 16 GiB red line refused Q9's 27 GiB per-segment estimate at SF10)
DIST_BIG_BUDGET = 64 << 30
DIST_BIG_RED_LINE = 1 << 40
DIST_DS = ("q17", "q25", "q29")
DIST_ORACLE = ("q1", "q3", "q5")
DIST_EA = ("q3", "q5")
DIST_SKEW_ROWS = 200_000


def _motion_readings(plan, nseg, exchange_ms) -> list:
    """Per redistribute of a run's plan: its bucket rung against the
    observed demand, the skew ratio, the wire bytes it moved (every
    segment's (nseg, bucket_cap, W) buffer) and the exchange's time."""
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.obs.capacity import _wire_row_bytes
    from cloudberry_tpu_torch.plan import nodes as N

    out = []
    for n in X._dedupe_nodes(m for m in X.all_nodes(plan)
                             if isinstance(m, N.PMotion)
                             and m.kind == "redistribute"):
        out.append({
            "bucket_cap": int(n.bucket_cap),
            "observed_demand": int(getattr(n, "_observed_bucket", -1)),
            "skew_ratio": getattr(n, "_skew_ratio", None),
            "wire_bytes": int(nseg * nseg * n.bucket_cap
                              * _wire_row_bytes(n)),
            "exchange_ms": exchange_ms.get(id(n))})
    return out


def forget_feedback(session) -> None:
    """Empty the session's feedback store (plan/feedback.py)."""
    from cloudberry_tpu_torch.plan import feedback as FB

    FB.store_for(session).reset()


def dist_readings(kit, session, sql, runs) -> dict:
    """``runs`` timed runs of one statement (walls, host-time split from
    its traces), then one run with every motion's exchange (pack, route,
    exchange, unpack; its child's lowering excluded) timed between device
    synchronizations, and the peak device bytes read against the plan's
    admission estimate (times nseg at n_segments > 1: on one card every
    segment's working set coexists)."""
    from cloudberry_tpu_torch.exec import dist_executor as DX
    from cloudberry_tpu_torch.exec.resource import estimate_plan_memory

    torch = kit.torch
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        session.sql(sql)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    split = span_split(session.stmt_log.traces(runs))   # newest first
    split = {k: round(float(np.median(v)) * 1e3, 3)
             for k, v in split.items()}
    nseg = session.config.n_segments
    plans, exchange = [], {}
    real_record = DX.record_motion_stats
    real_ship = DX.Gang.ship

    def record(plan, stats, session=None):
        plans.append(plan)
        return real_record(plan, stats, session=session)

    def timed_ship(self, node, parts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_ship(self, node, parts)
        torch.cuda.synchronize()
        exchange[id(node)] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    DX.record_motion_stats = record
    DX.Gang.ship = timed_ship
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        if nseg > 1:
            session.sql(sql)
        else:
            from cloudberry_tpu_torch.plan.planner import plan_statement
            from cloudberry_tpu_torch.sql.parser import parse_sql

            plans.append(plan_statement(parse_sql(sql), session, {}).plan)
            session.sql(sql)
    finally:
        DX.record_motion_stats = real_record
        DX.Gang.ship = real_ship
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    est = estimate_plan_memory(plans[-1]).peak_bytes if plans else 0
    return {"ms": [round(w, 3) for w in walls],
            "median_ms": round(float(np.median(walls)), 3),
            "split_ms": split, "peak_bytes": int(peak),
            "estimate_bytes": int(est),
            "estimate_x_nseg": int(est * nseg),
            "motions": _motion_readings(plans[-1], nseg, exchange)
            if plans and nseg > 1 else []}


def distributed_phase(kit, raw, gpu, cpu, gds, args) -> dict:
    """Distributed execution on one card (module docstring, phase 12)."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpcds, tpch
    from cloudberry_tpu_torch.catalog import carry
    from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy
    from cloudberry_tpu_torch.types import date_to_days

    torch = kit.torch
    out = {"tpch": {}, "tpcds": {}, "big": {}, "motion": {}}
    t_phase = time.perf_counter()
    card = gpu.config
    all8 = list(tpch.SCHEMAS)
    # one-segment and 8-segment CUDA sessions over every TPC-H table of
    # phase 3's data (phase 3 loaded six of the eight)
    g1 = ct.Session(card)
    have = [n for n in all8 if n in gpu.catalog.tables]
    copy_tables(gpu, g1, have)
    tpch.load_tables(g1, tpch.SCHEMAS, tpch.DIST_KEYS, raw,
                     [n for n in all8 if n not in have])
    seg8 = card.with_overrides(n_segments=DIST_NSEG)
    g8 = ct.Session(seg8)
    copy_tables(g1, g8, all8)
    c8 = ct.Session(seg8, device="cpu")
    copy_tables(cpu, c8, [n for n in all8 if n in cpu.catalog.tables])
    nseg_runs = DIST_RUNS
    for q in sorted(tpch.QUERIES, key=lambda q: int(q[1:])):
        sql = tpch.QUERIES[q]
        # a sketch learned from another text reshapes this one's plan: the
        # reference keys sketches by (table, key set) alone, and after Q8
        # its Q15 overflows an aggregate (ROADMAP Queue C 37); each text
        # starts from an empty feedback store
        forget_feedback(g8)
        kit.held(f"TPC-H {q} at {DIST_NSEG} segments",
                 lambda: g8.sql(sql))
        res, ms, counts = kit.counted_run(g8, sql)
        want1 = g1.sql(sql)
        err = same_nulls(with_nulls(res), with_nulls(want1),
                         f"{q} at {DIST_NSEG} segments vs one segment")
        rec = {"rows": res.num_rows(), "launches": counts,
               "float_err_vs_1seg": err}
        kit.keep["results8"][q] = with_nulls(res)
        if q in DIST_ORACLE:
            t_cpu = time.perf_counter()
            got = physical(res)
            # Q1's averages: the two-stage finalize's order (sum cast to
            # float, then divided by the count), as in a tiled run
            same(got, oracle(raw, q, date_to_days, tiled=(q == "q1")),
                 f"{q} at {DIST_NSEG} segments vs numpy oracle")
            same(got, physical(c8.sql(sql)),
                 f"{q} at {DIST_NSEG} segments vs the port's "
                 f"{DIST_NSEG}-segment CPU run")
            rec["oracle"] = rec["cpu_8seg"] = "equal"
            rec["cpu_check_s"] = time.perf_counter() - t_cpu
        rec["seg8"] = dist_readings(kit, g8, sql, nseg_runs)
        rec["seg1"] = dist_readings(kit, g1, sql, nseg_runs)
        _, _, counts1 = kit.counted_run(g1, sql)
        rec["launches_1seg"] = counts1
        out["tpch"][q] = rec
        log(f"[dist] TPC-H {q}: {DIST_NSEG} segments "
            f"{rec['seg8']['median_ms']:.3f} ms against one segment "
            f"{rec['seg1']['median_ms']:.3f} ms ({nseg_runs} timed run(s) "
            "each), "
            f"{res.num_rows()} rows, launches {counts} (one segment "
            f"{counts1}), peak {rec['seg8']['peak_bytes']} B against the "
            f"estimate x {DIST_NSEG} {rec['seg8']['estimate_x_nseg']} B; "
            f"motions {rec['seg8']['motions']}; equal to one segment "
            f"(largest float difference {err})"
            + ("; equal to numpy and the CPU run" if q in DIST_ORACLE
               else ""))
    del c8
    kit.keep["g8"] = g8
    out["tpch_s"] = time.perf_counter() - t_phase
    log(f"[dist] TPC-H SF{args.sf} part: {out['tpch_s']:.1f} s")

    # ------------------------------------------ TPC-DS q17/q25/q29, 8 seg
    t_part = time.perf_counter()
    gds8 = ct.Session(gds.config.with_overrides(n_segments=DIST_NSEG))
    copy_tables(gds, gds8, list(tpcds.SCHEMAS))
    for q in DIST_DS:
        sql = tpcds.QUERIES[q]
        forget_feedback(gds8)
        kit.held(f"TPC-DS {q} at {DIST_NSEG} segments",
                 lambda: gds8.sql(sql))
        res, ms, counts = kit.counted_run(gds8, sql)
        err = same_nulls(with_nulls(res), with_nulls(gds.sql(sql)),
                         f"TPC-DS {q} at {DIST_NSEG} segments vs one")
        rec = {"rows": res.num_rows(), "launches": counts,
               "float_err_vs_1seg": err,
               "launches_1seg": kit.counted_run(gds, sql)[2],
               "seg8": dist_readings(kit, gds8, sql, nseg_runs),
               "seg1": dist_readings(kit, gds, sql, nseg_runs)}
        out["tpcds"][q] = rec
        log(f"[dist] TPC-DS {q}: {DIST_NSEG} segments "
            f"{rec['seg8']['median_ms']:.3f} ms against one segment "
            f"{rec['seg1']['median_ms']:.3f} ms, {res.num_rows()} rows, "
            f"launches {counts}, motions {rec['seg8']['motions']}, equal "
            f"to one segment (largest float difference {err})")
    del gds8
    out["tpcds_s"] = time.perf_counter() - t_part
    log(f"[dist] TPC-DS part: {out['tpcds_s']:.1f} s")

    # ---------------------------------- motion behaviour, on phase 3's data
    t_part = time.perf_counter()
    F = carry.field
    n = DIST_SKEW_ROWS
    gsk, sql, want = skew_join_session(seg8, n)
    res, ms, counts = kit.counted_run(gsk, sql)
    check(physical(res)["sw"].tolist() == [want],
          f"skewed redistribute: {physical(res)} against numpy {want}")
    check(gsk.growth_events == 1,
          f"skewed redistribute: {gsk.growth_events} growths, 1 expected")
    out["motion"]["skew"] = {"rows": n, "growth_events": gsk.growth_events,
                             "ms": ms, "launches": counts}
    log(f"[dist] skewed redistribute: {n} probe rows, 75 % on one key "
        f"behind a projection: {gsk.growth_events} rung promotion, "
        f"{ms:.1f} ms with the retry, equal to numpy")
    del gsk

    fact_n = 1_000_000
    for mode, over in (("exact", {"planner.broadcast_threshold": 0}),
                       ("digest", {"planner.broadcast_threshold": 0,
                                   "planner.runtime_filter_threshold": 0,
                                   "join_filter.bloom_bits": 1 << 16})):
        rf = {}
        for onoff in ("on", "off"):
            cfg = seg8.with_overrides(**over)
            if onoff == "off":
                cfg = cfg.with_overrides(**{
                    "join_filter.enabled": False,
                    "planner.runtime_filter_threshold": 0})
            s = ct.Session(cfg)
            carry.load_encoded(s, "fact", [F("k", "int64", 0, False),
                                           F("grp", "int64", 0, False),
                                           F("v", "int64", 0, False)],
                               {"k": np.arange(fact_n),
                                "grp": np.arange(fact_n) % 300_000,
                                "v": np.arange(fact_n) % 7},
                               policy=DistributionPolicy.hashed("k"))
            carry.load_encoded(s, "dim", [F("d", "int64", 0, False),
                                          F("p", "int64", 0, False)],
                               {"d": np.arange(30_000) * 3,
                                "p": np.arange(30_000)},
                               policy=DistributionPolicy.hashed("d"))
            q = ("select grp, count(*) as n, sum(v) as s from fact, dim "
                 "where grp = d group by grp order by grp")
            text = s.explain(q)
            check(("RuntimeFilter" in text) == (onoff == "on")
                  and (("digest(" in text) == (mode == "digest"
                                                and onoff == "on")),
                  f"runtime filter {mode} {onoff}: plan {text}")
            r, ms_, cnt = kit.counted_run(s, q)
            rf[onoff] = (physical(r), ms_, s.counters.counter("jf_rows_in"),
                         s.counters.counter("jf_rows_out"))
        same(rf["on"][0], rf["off"][0],
             f"runtime filter {mode} against the filter off")
        check(0 < rf["on"][3] < rf["on"][2],
              f"runtime filter {mode}: rows in/out {rf['on'][2:]}")
        out["motion"][f"filter_{mode}"] = {
            "ms_on": rf["on"][1], "ms_off": rf["off"][1],
            "jf_rows_in": rf["on"][2], "jf_rows_out": rf["on"][3]}
        log(f"[dist] runtime filter {mode}: {rf['on'][2]} probe rows in, "
            f"{rf['on'][3]} out; {rf['on'][1]:.1f} ms against "
            f"{rf['off'][1]:.1f} ms with the filter off, equal")

    li = raw["lineitem"]
    key = int(li["l_orderkey"][len(li["l_orderkey"]) // 2])
    sql = ("select l_orderkey, l_linenumber, l_quantity from lineitem "
           f"where l_orderkey = {key} order by l_linenumber")
    from cloudberry_tpu_torch.plan.planner import plan_statement
    from cloudberry_tpu_torch.sql.parser import parse_sql

    seg = getattr(plan_statement(parse_sql(sql), g8, {}).plan,
                  "_direct_segment", None)
    check(seg is not None, "point query on l_orderkey: no direct dispatch")
    res, ms, counts = kit.counted_run(g8, sql)
    m = li["l_orderkey"] == key
    check(physical(res)["l_linenumber"].tolist()
          == sorted(li["l_linenumber"][m].tolist()),
          f"direct dispatch: {physical(res)} against numpy")
    same(physical(res), physical(g1.sql(sql)),
         "direct dispatch vs one segment")
    out["motion"]["direct"] = {"segment": seg, "rows": res.num_rows(),
                               "ms": ms}
    log(f"[dist] point query on l_orderkey = {key}: direct dispatch to "
        f"segment {seg}, {res.num_rows()} rows, {ms:.2f} ms, equal to "
        "numpy and one segment")

    # EXPLAIN ANALYZE at 8 segments against the 8-segment CPU run, in
    # fresh sessions with the same history (feedback folds change plans)
    ea = {}
    ea_g = ct.Session(seg8)
    copy_tables(g1, ea_g, all8)
    ea_c = ct.Session(seg8, device="cpu")
    copy_tables(cpu, ea_c, [n for n in all8 if n in cpu.catalog.tables])
    for q in DIST_EA:
        sql = tpch.QUERIES[q]
        ea_g.sql(sql)
        ea_c.sql(sql)
        tg, tc = ea_g.explain_analyze(sql), ea_c.explain_analyze(sql)
        check(strip_timings(tg) == strip_timings(tc),
              f"EXPLAIN ANALYZE {q} at {DIST_NSEG} segments differs from "
              f"the CPU run:\n{tg}\n---\n{tc}")
        ea[q] = tg
        log(f"[dist] EXPLAIN ANALYZE {q} at {DIST_NSEG} segments equals "
            f"the CPU run's:\n{tg}")
    out["motion"]["explain_analyze"] = ea
    del ea_g, ea_c
    out["motion_s"] = time.perf_counter() - t_part
    log(f"[dist] motion behaviour part: {out['motion_s']:.1f} s")

    # ---------------------- TPC-H --dist-sf Q5 and Q9 over 4 segments
    if args.dist_sf > 0:
        t0 = time.perf_counter()
        big_cfg = card.with_overrides(**{
            "resource.query_mem_bytes": DIST_BIG_BUDGET,
            "resource.total_mem_bytes": DIST_BIG_RED_LINE})
        b1 = ct.Session(big_cfg)
        out["big"]["prefetch"] = args.prefetch.load(b1)
        b4 = ct.Session(big_cfg.with_overrides(n_segments=DIST_BIG_NSEG))
        copy_tables(b1, b4, all8)
        out["big"]["sf"] = args.dist_sf
        out["big"]["load_s"] = time.perf_counter() - t0
        g = out["big"]["prefetch"]
        log(f"[dist] TPC-H sf={args.dist_sf}: "
            f"{b1.catalog.table('lineitem').num_rows} lineitem rows, "
            f"{out['big']['load_s']:.1f} s to load and copy (generated "
            f"and encoded in a child process beside the earlier phases: "
            f"{g['generate_s']:.1f} + {g['encode_s']:.1f} s, "
            f"{g['total_s']:.1f} s with its pickle; here "
            f"{g['waited_s']:.1f} s waited for it, {g['unpickle_s']:.1f} "
            f"s to unpickle, {g['install_s']:.1f} s to install)")
        for q in ("q5", "q9"):
            sql = tpch.QUERIES[q]
            forget_feedback(b4)
            kit.held(f"TPC-H sf={args.dist_sf} {q} at {DIST_BIG_NSEG} "
                     "segments", lambda: b4.sql(sql))
            res, ms, counts = kit.counted_run(b4, sql)
            want = b1.sql(sql)
            err = same_nulls(with_nulls(res), with_nulls(want),
                             f"sf={args.dist_sf} {q} at {DIST_BIG_NSEG} "
                             "segments vs one segment")
            rec = {"rows": res.num_rows(), "launches": counts,
                   "float_err_vs_1seg": err,
                   "launches_1seg": kit.counted_run(b1, sql)[2],
                   "seg4": dist_readings(kit, b4, sql, DIST_RUNS),
                   "seg1": dist_readings(kit, b1, sql, DIST_RUNS)}
            out["big"][q] = rec
            log(f"[dist] TPC-H sf={args.dist_sf} {q}: {DIST_BIG_NSEG} "
                f"segments {rec['seg4']['median_ms']:.1f} ms against one "
                f"segment {rec['seg1']['median_ms']:.1f} ms, "
                f"{res.num_rows()} rows, launches {counts}, peak "
                f"{rec['seg4']['peak_bytes']} B against the estimate x "
                f"{DIST_BIG_NSEG} {rec['seg4']['estimate_x_nseg']} B, "
                f"motions {rec['seg4']['motions']}, equal to one segment "
                f"(largest float difference {err})")
        del b1, b4
        out["big"]["s"] = time.perf_counter() - t0
        log(f"[dist] TPC-H sf={args.dist_sf} part: {out['big']['s']:.1f} s")
    out["s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------ 13. tiled distributed


# per-segment budgets in MiB that tile each statement at 8 segments with at
# least 4 lock-step tiles, and the decisions the reference takes there at
# full size (mode, tile rows, tiles per segment, accumulator capacity;
# planned on the CPU through both engines): TPC-H SF1 and tpcds-lite
# scale 100. Q3's two-stage finalize holds 8 x 752,288 accumulator rows,
# so Q3 needs 96 MiB. In both engines Q9 refuses up to 256 MiB and first
# tiles at 1 GiB in one tile per segment, and Q18 refuses until it is
# admitted, so neither reaches 4 tiles.
TD_TPCH = {"q1": (32, (None, 131_072, 6, 8)),
           "q3": (96, (None, 65_536, 12, 752_288)),
           "q5": (48, (None, 131_072, 6, 25))}
# the smallest budgets in MiB that tile them at SF 0.05 (the quick check's
# size); a reduced run takes the larger of these scaled by sf / 0.05 and
# the full-size budget scaled by sf
TD_TPCH_QUICK = {"q1": 1, "q3": 6, "q5": 2}


def td_budget(q: str, sf: float) -> int:
    """Phase 13's budget in bytes for TPC-H ``q`` at scale ``sf``: the
    full-size budget at SF1, else the larger of it scaled by ``sf`` and
    the quick check's scaled by sf / 0.05."""
    def mib(m, scale):
        return max(int(m * scale), 1) << 20
    m = TD_TPCH[q][0]
    if sf == 1.0:
        return mib(m, 1.0)
    return max(mib(m, sf), mib(TD_TPCH_QUICK[q], sf / 0.05))
TD_DS = {"TOPN_DS": (16, ("topn", 65_536, 6, 100)),
         "SORT_DS": (16, ("sort", 65_536, 6, 0)),
         "WIN_DS": (256, ("window", 65_536, 6, 0))}
# the JAX package's tests/test_feedback.py replan shape at 10x its rows
TD_HOT_ROWS = 4_000_000
TD_HOT_BUDGET = 32 << 20
TD_HOT_Q = ("SELECT g, sum(v) AS sv, count(*) AS c FROM fact JOIN dim "
            "ON fact.d = dim.d GROUP BY g ORDER BY g")
# tests/test_torch_dist_recovery.py's late overflow at 5x its rows (at
# 10x both windows took 65 s of the script on one H100): the group
# estimate grows with the rows, so the late part's key domain and the
# modulus grow 5x too (its groups must still outnumber the first
# accumulator), and a 16 MiB budget keeps 6 tiles a segment, the
# resumes from tile 2 and window 4's deferred overflows (a CPU run of
# this shape: 6 tiles of 524,288 rows, 2 resumes, 2 replays, 2 deferred)
TD_LATE_ROWS = (16_000_000, 6_000_000)
TD_LATE_KEYS = (2_000, 150_000)
TD_LATE_MOD = 100_000
TD_LATE_BUDGET = 16 << 20


def peak_owners(torch, fn, top=8) -> tuple:
    """Run ``fn()`` with the CUDA caching allocator's history recorded and
    replay it: (the most bytes allocated at once above the start, and the
    blocks live at that moment, summed per allocating line of the port:
    the innermost ``cloudberry_tpu_torch`` frame, ``top`` largest first).
    Allocated bytes fall at a free's request, as
    ``torch.cuda.memory_allocated`` counts them."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python",
        max_entries=2_000_000)
    try:
        fn()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][
            torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    cur = peak = peak_at = 0
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            cur += ev["size"]
            if cur > peak:
                peak, peak_at = cur, i + 1
        elif ev["action"] == "free_requested":
            cur -= ev["size"]
    live = {}
    for ev in trace[:peak_at]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_requested":
            live.pop(ev["addr"], None)
    owners: dict = {}
    for ev in live.values():
        where = next((f"{f['filename'].rsplit('cloudberry_tpu_torch/', 1)[-1]}"
                      f":{f['line']} {f['name']}"
                      for f in ev.get("frames", ())
                      if "cloudberry_tpu_torch/" in f["filename"]),
                     "outside the port")
        owners[where] = owners.get(where, 0) + ev["size"]
    ranked = sorted(owners.items(), key=lambda kv: -kv[1])
    return peak, [[w, b] for w, b in ranked[:top]]


def dist_tiled_run(kit, session, sql, budget, what, stream, runs=2,
                   held=True) -> tuple:
    """One statement tiled at ``budget`` per segment on an n-segment
    session: (with ``held``) a run with every kernel call held against its
    plain version, a counted run (launches, peak device bytes above the
    resident baseline), ``runs`` timed runs (every tile's wall), a run
    under the allocator's history (``peak_owners``), and one run with
    every exchange (pack, route, exchange, unpack) timed between device
    synchronizations. The streamed table must never reach the device
    whole, and the peak less the buffer pool's admissions must stay under
    budget x nseg. Returns (the counted run's result, row of readings)."""
    from cloudberry_tpu_torch.exec import bufferpool as BUF
    from cloudberry_tpu_torch.exec import dist_executor as DX
    from cloudberry_tpu_torch.exec import tiled as TL

    torch = kit.torch
    nseg = session.config.n_segments
    base_cfg = session.config
    session.config = base_cfg.with_overrides(
        **{"resource.query_mem_bytes": budget})
    uploads = []
    real_shards, real_table = session.device_shards, session.device_table
    session.device_shards = lambda n: (uploads.append(n), real_shards(n))[1]
    session.device_table = lambda n: (uploads.append(n), real_table(n))[1]
    try:
        if held:
            kit.held(f"{what} (tiled, {nseg} segments, held)",
                     lambda: session.sql(sql))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pool = BUF.pool_for(session)
        pool0 = pool.snapshot()["bytes"] if pool is not None else 0
        res, ms, counts = kit.counted_run(session, sql)
        peak = torch.cuda.max_memory_allocated() - base
        pooled = max((pool.snapshot()["bytes"] - pool0) if pool is not None
                     else 0, 0)
        rep = dict(session.last_tiled_report)
        walls, tile_s = [], []
        real_init = TL._TileTimer.__init__

        class Recording:
            """The timer's histogram, keeping every tile's wall too."""

            def __init__(self, h):
                self.h = h

            def add(self, dt):
                tile_s.append(dt)
                self.h.add(dt)

            def __getattr__(self, name):
                return getattr(self.h, name)

        def recording_init(self, sess):
            real_init(self, sess)
            self._h = Recording(self._h)

        TL._TileTimer.__init__ = recording_init
        try:
            for _ in range(runs):
                t0 = time.perf_counter()
                session.sql(sql)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        finally:
            TL._TileTimer.__init__ = real_init
        gc.collect()
        traced_peak, owners = peak_owners(torch, lambda: session.sql(sql))
        ex_ms = []
        real_ship = DX.Gang.ship

        def timed_ship(self, node, parts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_ship(self, node, parts)
            torch.cuda.synchronize()
            ex_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        DX.Gang.ship = timed_ship
        try:
            session.sql(sql)
        finally:
            DX.Gang.ship = real_ship
    finally:
        session.config = base_cfg
        del session.device_shards, session.device_table
    check(rep is not None and rep["tiled"] and rep["distributed"],
          f"{what}: did not tile on the segment axis")
    check(stream not in uploads, f"{what}: the streamed table {stream} "
          "was copied to the device whole")
    n = rep["n_tiles"]
    tt = rep.get("tile_time") or {}
    row = {"ms": ms, "median_ms": round(float(np.median(walls)), 3),
           "walls_ms": [round(w, 3) for w in walls],
           "budget_bytes": budget, "nseg": nseg, "mode": rep.get("mode"),
           "tile_rows": rep["tile_rows"], "n_tiles": n,
           "n_chunks": rep.get("n_chunks"),
           "acc_capacity": rep["acc_capacity"],
           # over every tile of the timed runs; the report's own p95 is
           # its histogram's power-of-two bucket bound
           "tile_ms_mean": round(float(np.mean(tile_s)) * 1e3, 3),
           "tile_ms_p95": round(float(np.percentile(tile_s, 95)) * 1e3, 3),
           "tile_ms_p95_bucket_bound": round(tt.get("p95", 0.0) * 1e3, 3),
           "exchanges": len(ex_ms),
           "exchange_ms_per_tile": round(sum(ex_ms) / max(n, 1), 3),
           "est_step_bytes": rep["est_step_bytes"],
           "est_finalize_bytes": rep["est_finalize_bytes"],
           "peak_above_resident": int(peak),
           "budget_x_nseg": budget * nseg,
           "peak_over_budget_x_nseg": round(peak / (budget * nseg), 4),
           "pool_admitted_bytes": int(pooled),
           "peak_less_pool_over_budget_x_nseg": round(
               (peak - pooled) / (budget * nseg), 4),
           "est_pipeline_bytes": rep["est_pipeline_bytes"],
           "traced_peak": int(traced_peak), "peak_owners": owners,
           "resumed_from_tile": rep.get("resumed_from_tile"),
           "launches": counts,
           "launches_per_tile": {k: round(v / n, 3)
                                 for k, v in counts.items()}}
    log(f"[tiled-dist] {what}: median {row['median_ms']:.3f} ms of {runs} "
        f"(counted run {ms:.3f} ms), mode {row['mode'] or 'agg'}, {n} "
        f"tiles of {rep['tile_rows']} rows per segment"
        + (f", {row['n_chunks']} chunks" if row["n_chunks"] else "")
        + f", acc {rep['acc_capacity']}; tile host ms mean "
        f"{row['tile_ms_mean']} p95 {row['tile_ms_p95']} (over "
        f"{len(tile_s)} tiles of {runs} runs); {len(ex_ms)} "
        f"exchanges, {row['exchange_ms_per_tile']} ms per tile "
        f"(device-synchronized); estimate step {rep['est_step_bytes']} "
        f"finalize {rep['est_finalize_bytes']} bytes; peak {peak} bytes "
        f"above the resident baseline against budget x {nseg} = "
        f"{budget * nseg} ({row['peak_over_budget_x_nseg']}), "
        f"{pooled} of them the buffer pool's admissions "
        f"({row['peak_less_pool_over_budget_x_nseg']} without); pipeline "
        f"estimate {rep['est_pipeline_bytes']} bytes; traced run's peak "
        f"{traced_peak} bytes, live then by allocating line {owners}; "
        f"launches {counts} ({row['launches_per_tile']} per tile)")
    # admission charges each segment's step at the per-segment estimate and
    # the gang's nseg working sets share the card; the buffer pool's device
    # copies of hot feed tiles are bounded by bufferpool.max_bytes instead
    # (the single-segment tiling phase's check, times nseg)
    check(peak - pooled <= budget * nseg, f"{what}: peak {peak} bytes "
          f"above the resident baseline ({pooled} of them pool admissions) "
          f"exceeds budget x {nseg} = {budget * nseg}")
    return res, row


def tiled_dist_phase(kit, raw, gpu, gds, args) -> dict:
    """Tiled distributed execution on one card (module docstring,
    phase 13)."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpcds, tpch
    from cloudberry_tpu_torch.catalog import carry
    from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy
    from cloudberry_tpu_torch.plan.planner import plan_statement
    from cloudberry_tpu_torch.plan.verify import verify_plan
    from cloudberry_tpu_torch.sql.parser import parse_sql
    from cloudberry_tpu_torch.types import date_to_days as D
    from cloudberry_tpu_torch.utils import faultinject as FI

    torch = kit.torch
    out = {"verify": {}, "tpch": {}, "tpcds": {}}
    t_phase = time.perf_counter()
    full_h = args.sf == 1.0
    full_ds = args.ds_scale == DS_SCALE
    nseg = DIST_NSEG

    def mib(m, scale):
        return max(int(m * scale), 1) << 20

    def expect(what, row, want, full):
        got = (row["mode"], row["tile_rows"], row["n_tiles"],
               row["acc_capacity"])
        check(row["n_tiles"] >= (4 if full else 2),
              f"{what}: {row['n_tiles']} tiles per segment")
        if full:
            check(got == want, f"{what}: (mode, tile rows, tiles, "
                  f"accumulator) {got}, the reference decides {want}")

    # -------------------------------- the verify gate on 22 TPC-H plans
    g8 = kit.keep["g8"]
    for q in sorted(tpch.QUERIES, key=lambda q: int(q[1:])):
        forget_feedback(g8)
        plan = plan_statement(parse_sql(tpch.QUERIES[q]), g8, {}).plan
        findings = verify_plan(plan, g8)
        check(findings == [], f"TPC-H {q} at {nseg} segments: plan "
              f"findings {[f.render() for f in findings]}")
    out["verify"]["tpch_plans"] = len(tpch.QUERIES)
    log(f"[tiled-dist] verify_plan over the {len(tpch.QUERIES)} TPC-H "
        f"plans at {nseg} segments: no finding")

    # ------------------------------------------ TPC-H SF1 at 8 segments
    card = gpu.config
    vcfg = card.with_overrides(n_segments=nseg,
                               **{"debug.verify_plans": True})
    names = ["region", "nation", "supplier", "customer", "orders",
             "lineitem"]
    t8 = ct.Session(vcfg)
    copy_tables(gpu, t8, names)
    for q, (m, want) in TD_TPCH.items():
        sql = tpch.QUERIES[q]
        forget_feedback(t8)
        budget = td_budget(q, args.sf)
        res, row = dist_tiled_run(kit, t8, sql, budget,
                                  f"TPC-H {q} at {budget >> 20} MiB",
                                  "lineitem")
        expect(f"TPC-H {q}", row, want, full_h)
        same_nulls(with_nulls(res), kit.keep["results8"][q],
                   f"tiled {q} at {nseg} segments vs the one-shot "
                   f"{nseg}-segment run")
        same(physical(res), oracle(raw, q, D, tiled=(q == "q1")),
             f"tiled {q} at {nseg} segments vs the numpy oracle")
        one = []
        for _ in range(2):
            t0 = time.perf_counter()
            g8.sql(sql)
            torch.cuda.synchronize()
            one.append((time.perf_counter() - t0) * 1e3)
        row["one_shot_median_ms"] = round(float(np.median(one)), 3)
        out["tpch"][q] = row
        log(f"[tiled-dist] TPC-H {q}: equal to the one-shot {nseg}-segment "
            f"run and the numpy oracle; tiled {row['median_ms']:.3f} ms "
            f"against one-shot {row['one_shot_median_ms']:.3f} ms "
            "(medians of 2)")
    del t8

    # --------------------------------- TPC-DS at 8 segments (scale 100)
    d8 = ct.Session(gds.config.with_overrides(
        n_segments=nseg, **{"debug.verify_plans": True}))
    copy_tables(gds, d8, list(tpcds.SCHEMAS))
    if not full_ds:
        # at small scales these statements are admitted whole or refused
        # at every budget: none of them tiles
        log(f"[tiled-dist] TPC-DS part skipped at scale {args.ds_scale} "
            f"(it runs at scale {DS_SCALE})")
    for name, (m, want) in (TD_DS.items() if full_ds else ()):
        sql = TILED_DS[name][0]
        one = gds.sql(sql)
        res, row = dist_tiled_run(kit, d8, sql,
                                  mib(m, args.ds_scale / DS_SCALE),
                                  f"{name} at {m} MiB x scale",
                                  "store_sales")
        expect(name, row, want, full_ds)
        if name == "WIN_DS":
            err = same_nulls(sorted_rows(with_nulls(res)),
                             sorted_rows(with_nulls(one)),
                             f"tiled {name} at {nseg} segments vs one "
                             "segment (rows sorted by every column)")
        else:
            err = same_nulls(with_nulls(res), with_nulls(one),
                             f"tiled {name} at {nseg} segments vs one "
                             "segment")
        row.update(rows=res.num_rows(), largest_float_difference=err)
        out["tpcds"][name] = row
        log(f"[tiled-dist] {name}: {res.num_rows()} rows equal to the "
            f"one-segment run (largest float difference {err})")
    del d8

    # ------------------------------------------ the mid-statement replan
    F = carry.field
    rng = np.random.default_rng(3)
    # at a reduced size, the CPU test's own shape (400,000 rows, 2 MiB)
    n = TD_HOT_ROWS if full_h else 400_000
    d = rng.integers(0, 500, n)
    d[rng.random(n) < 0.85] = 7
    fact = {"k": np.arange(n) % 997, "d": d, "v": rng.integers(0, 100, n)}
    hot_cfg = card.with_overrides(n_segments=nseg, **{
        "planner.broadcast_threshold": 0, "debug.verify_plans": True})

    def hot_session(cfg):
        s = ct.Session(cfg)
        carry.load_encoded(s, "dim", [F("d", "int64", 0, False),
                                      F("g", "int64", 0, False)],
                           {"d": np.arange(500), "g": np.arange(500) % 9},
                           policy=DistributionPolicy.hashed("g"))
        carry.load_encoded(s, "fact", [F("k", "int64", 0, False),
                                       F("d", "int64", 0, False),
                                       F("v", "int64", 0, False)], fact,
                           policy=DistributionPolicy.hashed("k"))
        return s

    want = with_nulls(hot_session(hot_cfg).sql(TD_HOT_Q))
    hot_budget = TD_HOT_BUDGET if full_h else 2 << 20
    rep_hot = {}
    for skip in (False, True):
        s = hot_session(hot_cfg.with_overrides(
            **{"resource.query_mem_bytes": hot_budget}))
        FI.reset_fault()
        if skip:
            FI.inject_fault("tile_replan", action="skip")
        try:
            if not skip:
                kit.held("the replanned join-group (held)",
                         lambda: s.sql(TD_HOT_Q))
                s = hot_session(hot_cfg.with_overrides(
                    **{"resource.query_mem_bytes": hot_budget}))
            t0 = time.perf_counter()
            res, ms, counts = kit.counted_run(s, TD_HOT_Q)
        finally:
            FI.reset_fault()
        same_nulls(with_nulls(res), want, f"join-group, tile_replan "
                   f"{'skipped' if skip else 'armed'}, vs in memory")
        c = s.stmt_log.counter
        rep = s.last_tiled_report
        r = {"ms": ms, "launches": counts, "n_tiles": rep["n_tiles"],
             "tile_rows": rep["tile_rows"],
             "resumed_from_tile": rep.get("resumed_from_tile"),
             **{k: c(k) for k in ("tile_replans", "adaptive_replans",
                                  "tile_checkpoints", "tile_resumes",
                                  "feedback_folds", "tile_stat_syncs")}}
        if skip:
            check(r["tile_replans"] == 0 and r["adaptive_replans"] == 0,
                  f"replan with the tile_replan fault skipped: {r}")
        else:
            check(r["tile_replans"] == r["adaptive_replans"] == 1
                  and r["tile_resumes"] >= 1
                  and (r["resumed_from_tile"] or 0) > 0,
                  f"the replan did not fire once and resume: {r}")
        rep_hot["skipped" if skip else "armed"] = r
        log(f"[tiled-dist] join-group, {n} fact rows, 85 % on one key, "
            f"tile_replan {'skipped' if skip else 'armed'}: {ms:.3f} ms, "
            f"{r}; equal to the in-memory run")
    out["replan"] = rep_hot

    # ---------------------------------------- checkpoint resume, 8 segments
    # at a reduced size, the CPU test's own shape
    (n1, n2), keys, mod, late_budget = (
        (TD_LATE_ROWS, TD_LATE_KEYS, TD_LATE_MOD, TD_LATE_BUDGET) if full_h
        else ((3_200_000, 1_200_000), (2_000, 30_000), 20_000, 4 << 20))
    rng = np.random.default_rng(4)
    k = np.concatenate([rng.integers(0, keys[0], n1),
                        rng.integers(0, keys[1], n2)])
    v = rng.integers(0, 100, len(k))
    kk = k % mod
    cnt = np.bincount(kk, minlength=mod)
    sv = np.bincount(kk, weights=v, minlength=mod)
    present = np.flatnonzero(cnt)[:50]
    late_want = {"kk": present, "c": cnt[present],
                 "sv": sv[present].astype(np.int64)}
    late_q = (f"SELECT k % {mod} AS kk, count(*) AS c, sum(v) AS sv "
              f"FROM fact GROUP BY k % {mod} ORDER BY kk LIMIT 50")
    late = {}
    for w in (1, 4):
        s = ct.Session(card.with_overrides(n_segments=nseg, **{
            "resource.query_mem_bytes": late_budget,
            "recovery.checkpoint_every": 2, "feedback.enabled": False,
            "tile_pipeline.inflight_tiles": w,
            "debug.verify_plans": True}))
        carry.load_encoded(s, "fact", [F("k", "int64", 0, False),
                                       F("v", "int64", 0, False)],
                           {"k": k, "v": v},
                           policy=DistributionPolicy.hashed("k"))
        res, ms, counts = kit.counted_run(s, late_q)
        rep = s.last_tiled_report
        c = s.stmt_log.counter
        late[w] = {"ms": ms, "launches": counts, "n_tiles": rep["n_tiles"],
                   "tile_rows": rep["tile_rows"],
                   "acc_capacity": rep["acc_capacity"],
                   "resumed_from_tile": rep.get("resumed_from_tile"),
                   "result": physical(res),
                   **{x: c(x) for x in (
                       "tile_checkpoints", "tile_resumes", "tiles_replayed",
                       "tile_deferred_overflows", "tile_window_replays")}}
        same(late[w]["result"], late_want,
             f"late overflow at {nseg} segments, window {w}, vs numpy")
        del s
    same(late[4].pop("result"), late[1].pop("result"),
         "late overflow: window 4 vs window 1")
    check(late[4]["tile_resumes"] >= 1
          and (late[4]["resumed_from_tile"] or 0) > 0,
          f"window 4 did not resume from a checkpoint: {late}")
    out["checkpoint_resume"] = late
    log(f"[tiled-dist] late overflow ({n1 + n2} rows, k % {mod}, "
        f"a checkpoint every 2 tiles) at {nseg} segments: {late}; windows "
        "1 and 4 equal to numpy")
    out["s"] = time.perf_counter() - t_phase
    return out


# the recovery phase (phase 14): phase 13's TPC-H statements and budgets,
# a checkpoint every RC_K tiles, kills at tile 0, mid and last, 8 -> 7
# degraded runs of Q3 and Q5, one planned online expand 8 -> 12 and back
# with Q5 at each epoch
RC_K = 2
RC_EXPAND = 12
RC_PROBES = 20


def recovery_phase(kit, raw, gpu, args) -> dict:
    """Failure retry, the degraded re-shard resume and the topology plane
    on one card (module docstring, phase 14)."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.parallel import health
    from cloudberry_tpu_torch.types import date_to_days as D
    from cloudberry_tpu_torch.utils import faultinject as FI

    torch = kit.torch
    out = {"kills": {}}
    t_phase = time.perf_counter()
    full_h = args.sf == 1.0
    nseg = DIST_NSEG
    names = ["region", "nation", "supplier", "customer", "orders",
             "lineitem"]
    counters = ("recoveries", "tile_resumes", "tiles_replayed",
                "tile_checkpoints", "topo_resharded_resumes",
                "tile_resume_declined", "epoch_flips")

    def budget_of(q):
        m = TD_TPCH[q][0]
        if full_h:
            return m << 20
        return max(max(int(m * args.sf), 1) << 20,
                   max(int(TD_TPCH_QUICK[q] * args.sf / 0.05), 1) << 20)

    base = gpu.config.with_overrides(n_segments=nseg, **{
        "recovery.checkpoint_every": RC_K, "health.backoff_s": 0.01,
        "health.backoff_max_s": 0.05, "debug.verify_plans": True})
    s = ct.Session(base)
    copy_tables(gpu, s, names)

    def with_budget(q):
        s.config = s.config.with_overrides(
            **{"resource.query_mem_bytes": budget_of(q)})

    def snap():
        return {k: s.stmt_log.counter(k) for k in counters}

    def delta(before):
        after = snap()
        return {k: after[k] - before[k] for k in counters}

    def wall(sql):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = s.sql(sql)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------ the probe, on the card
    health.probe(s)
    probe_ms = []
    for _ in range(RC_PROBES):
        r = health.probe(s)
        probe_ms.append(r.latency_s * 1e3)
        check(r.ok and r.live == list(range(nseg)),
              f"the probe of {nseg} slots on the card: {r}")
    FI.inject_fault("probe_degraded", "skip")
    r = health.probe(s)
    FI.reset_fault()
    check(r.live == list(range(nseg - 1)),
          f"a probe that lost a slot reports {r.live}")
    accel = getattr(torch, "AcceleratorError", None)
    check(accel is None or not health.recoverable(
        accel("CUDA error: an illegal memory access was encountered")),
        "a CUDA runtime error must not re-dispatch")
    check(not health.recoverable(torch.OutOfMemoryError("device_lost")),
          "an out-of-memory error must not re-dispatch")
    out["probe"] = {"median_ms": round(float(np.median(probe_ms)), 4),
                    "max_ms": round(float(np.max(probe_ms)), 4),
                    "slots": nseg,
                    "accelerator_error": accel is not None}
    log(f"[recovery] probe of {nseg} slots on the card: median "
        f"{out['probe']['median_ms']} ms, max {out['probe']['max_ms']} ms "
        f"over {RC_PROBES} (a fill and a reduction kernel, one host "
        f"read); torch.AcceleratorError "
        f"{'present' if accel is not None else 'absent'} and never "
        "re-dispatched")

    # ---------------------------------------- kill matrices at 8 segments
    clean = {}
    for q in ("q1", "q3", "q5"):
        sql = tpch.QUERIES[q]
        with_budget(q)
        forget_feedback(s)
        want = with_nulls(kit.held(f"TPC-H {q} (recovery, uninterrupted, "
                                   "held)", lambda: s.sql(sql)))
        s.sql(sql)  # a second run: the statement's feedback has settled
        res, clean_ms = wall(sql)
        same_nulls(with_nulls(res), want, f"{q}: uninterrupted runs")
        if q != "q1":  # Q1's tiled averages differ from the oracle's order
            same(physical(res), oracle(raw, q, D),
                 f"{q} at {nseg} segments vs the numpy oracle")
        rep = s.last_tiled_report
        check(rep is not None and rep["tiled"] and rep["distributed"],
              f"{q}: did not tile on the segment axis")
        total, window = rep["n_tiles"], rep.get("tile_window", 1)
        check(total >= (4 if full_h else 2), f"{q}: {total} tiles")
        clean[q] = (want, clean_ms, total, window)
        rows = []
        for k in (0, total // 2, total - 1):
            FI.reset_fault()
            FI.inject_fault("tile_device_lost", "error", start_hit=k + 1,
                            end_hit=k + 1)
            before = snap()
            try:
                res, ms, counts = kit.counted_run(s, sql)
            finally:
                FI.reset_fault()
            d = delta(before)
            rep = s.last_tiled_report
            err = same_nulls(with_nulls(res), want,
                             f"{q} killed at tile {k} vs uninterrupted")
            resumed_from = rep.get("resumed_from_tile") or 0
            # an uninterrupted run after each kill: the paired wall, and a
            # statement without recovery, which resets the breaker's
            # consecutive-recovery streak (three kills in a row would trip
            # it, as in the reference)
            res2, clean_ms = wall(sql)
            same_nulls(with_nulls(res2), want, f"{q}: uninterrupted runs")
            row = {"kill_tile": k, "ms": round(ms, 3),
                   "uninterrupted_ms": round(clean_ms, 3),
                   "resumed_from_tile": resumed_from,
                   "tiles_rerun": k - resumed_from if d["tile_resumes"]
                   else k, "launches": counts,
                   "largest_float_difference": err, **d}
            check(d["recoveries"] == 1, f"{q} kill@{k}: {d}")
            check(d["tiles_replayed"] <= RC_K,
                  f"{q} kill@{k}: replayed {d['tiles_replayed']} tiles, "
                  f"past K = {RC_K}")
            check(d["tiles_replayed"] < total,
                  f"{q} kill@{k}: replayed the whole stream")
            if k >= RC_K + window - 1:  # a drained checkpoint
                check(d["tile_resumes"] == 1 and resumed_from > 0,
                      f"{q} kill@{k} did not resume: {row}")
            check(s.config.n_segments == nseg and rep["n_tiles"] == total,
                  f"{q} kill@{k}: {s.config.n_segments} segments, "
                  f"{rep['n_tiles']} tiles")
            rows.append(row)
            log(f"[recovery] {q} killed at tile {k} of {total} (window "
                f"{window}): {ms:.3f} ms against {clean_ms:.3f} ms "
                f"uninterrupted (the next run); breaker "
                f"{s._breaker.snapshot()['state']}; resumed from tile {resumed_from}, "
                f"{row['tiles_rerun']} tiles re-run, counters {d} "
                f"(reference bound: tiles_replayed <= K = {RC_K}); equal "
                f"to the uninterrupted run; launches {counts}")
        check(s._breaker.snapshot()["state"] == "closed",
              f"the breaker after {q}'s kills: {s._breaker.snapshot()}")
        out["kills"][q] = {"tiles": total, "window": window,
                           "budget_bytes": budget_of(q), "runs": rows}

    # -------------------------------------------- the 8 -> 7 degraded resumes
    # Q3 groups on lineitem's distribution key: its one-stage partials
    # cannot re-place on 7 segments, so the resume declines (counted) and
    # the statement re-runs fresh on the survivors, as in the reference.
    # Q5's two-stage partials re-place: it resumes from its checkpoint,
    # the remaining rows re-sharded by the placement hash
    out["degraded"] = {}
    for q, resumes in (("q3", False), ("q5", True)):
        sql = tpch.QUERIES[q]
        want, clean_ms, total, window = clean[q]
        with_budget(q)
        # mid-stream, and late enough that a drained checkpoint exists
        # (the window holds W - 1 tiles undrained)
        k = min(total - 1, max(total // 2, RC_K + window - 1))
        FI.inject_fault("probe_degraded", "skip")
        FI.inject_fault("tile_device_lost", "error", start_hit=k + 1,
                        end_hit=k + 1)
        before = snap()
        try:
            res, ms, counts = kit.counted_run(s, sql)
        finally:
            FI.reset_fault()
        d = delta(before)
        rep = s.last_tiled_report
        err = same_nulls(with_nulls(res), want, f"{q} after a slot loss on "
                         "7 segments vs the uninterrupted 8-segment run")
        ok = (s.config.n_segments == nseg - 1
              and rep["n_segments"] == nseg - 1 and d["recoveries"] == 1
              and d["tiles_replayed"] <= max(RC_K, k))
        checkpointed = k >= RC_K + window - 1
        if resumes and checkpointed:
            ok = ok and d["tile_resumes"] == 1 \
                and d["topo_resharded_resumes"] == 1 \
                and d["tiles_replayed"] <= RC_K
        else:
            # declined where a checkpoint existed (a reduced size may
            # kill before the first drained one)
            ok = ok and d["tile_resumes"] == 0 \
                and d["tile_resume_declined"] == int(checkpointed)
        check(ok, f"the degraded run of {q}: {s.config.n_segments} "
              f"segments, {d}")
        topo = s._topology.snapshot()
        row = {"kill_tile": k, "ms": round(ms, 3),
               "uninterrupted_ms": round(clean_ms, 3),
               "resumed_from_tile": rep.get("resumed_from_tile"),
               "n_segments": rep["n_segments"], "n_tiles": rep["n_tiles"],
               "launches": counts, "largest_float_difference": err,
               "epoch": topo["epoch"], "reason": topo["reason"], **d}
        log(f"[recovery] {q} killed at tile {k} with a slot lost: "
            + (f"resumed on {rep['n_segments']} segments from tile "
               f"{rep.get('resumed_from_tile')}" if d["tile_resumes"] else
               ("resume declined, " if d["tile_resume_declined"] else
                "no drained checkpoint yet, ")
               + f"re-run fresh on {rep['n_segments']} segments")
            + f" in {ms:.3f} ms against {clean_ms:.3f} ms uninterrupted at "
            f"{nseg}; counters {d}; epoch {topo['epoch']} "
            f"({topo['reason']}); equal to the uninterrupted {nseg}-segment "
            f"run; launches {counts}")
        # the slots come back: clean probes expand the cluster back to 8
        for _ in range(s.config.topology.recover_after):
            s._topology.probe_and_heal()
        topo = s._topology.snapshot()
        check(s.config.n_segments == nseg and topo["reason"] == "recover",
              f"recovery expand back to {nseg}: {topo['nseg']} "
              f"({topo['reason']})")
        res = kit.held(f"TPC-H {q} after the recovery expand (held)",
                       lambda: s.sql(sql))
        same_nulls(with_nulls(res), want, f"{q} after the recovery expand")
        row["recovered_epoch"] = topo["epoch"]
        out["degraded"][q] = row

    # ------------------------------------ the planned online expand and back
    q = "q5"
    sql = tpch.QUERIES[q]
    want = clean[q][0]
    with_budget(q)
    out["resize"] = []
    for target in (RC_EXPAND, nseg):
        t0 = time.perf_counter()
        state = s._topology.begin(target)
        s._topology.rebalance()
        reb_s = time.perf_counter() - t0
        cut = s._topology.cutover()
        reb = cut["rebalance"]
        frac = reb["moved_rows"] / max(reb["total_rows"], 1)
        check(s.config.n_segments == target and state.done
              and frac <= 1.25 * reb["minimal_bound"],
              f"resize to {target}: {s.config.n_segments} segments, "
              f"moved {frac:.4f} of the rows against the bound "
              f"{reb['minimal_bound']}")
        res = kit.held(f"TPC-H {q} at {target} segments (held)",
                       lambda: s.sql(sql))
        same_nulls(with_nulls(res), want, f"{q} at {target} segments after "
                   "the cutover vs the uninterrupted 8-segment run")
        res, ms, counts = kit.counted_run(s, sql)
        same_nulls(with_nulls(res), want, f"{q} at {target} segments")
        rep = s.last_tiled_report
        row = {"target_nseg": target, "epoch": cut["epoch"],
               "reason": cut["reason"], "cutover_ms": cut["cutover_ms"],
               "rebalance_s": round(reb_s, 3),
               "moved_rows": reb["moved_rows"],
               "total_rows": reb["total_rows"],
               "moved_fraction": round(frac, 6),
               "minimal_bound": reb["minimal_bound"],
               "moved_bytes": reb["moved_bytes"], "chunks": reb["chunks"],
               "q5_ms": round(ms, 3), "q5_tiles": rep["n_tiles"],
               "q5_tiled": bool(rep["tiled"]), "launches": counts,
               "topology_epoch": rep.get("topology_epoch")}
        out["resize"].append(row)
        log(f"[recovery] online {cut['reason']} to {target} segments: "
            f"rebalance {reb_s:.3f} s over {reb['total_rows']} rows, "
            f"{reb['moved_rows']} moved ({frac:.4f}; minimal bound "
            f"{reb['minimal_bound']}), {reb['moved_bytes']} bytes in "
            f"{reb['chunks']} chunks; cutover {cut['cutover_ms']} ms, "
            f"epoch {cut['epoch']}; {q} {ms:.3f} ms in {rep['n_tiles']} "
            f"tiles per segment, equal to the 8-segment run; launches "
            f"{counts}")
    out["verify_owed_after"] = s._verify_next_plans
    out["s"] = time.perf_counter() - t_phase
    del s
    return out


# ------------------------------------------------- phase 15: SQL surface

SQ_TXN_ROWS = 100_000    # lineitem rows the transaction appends
SQ_IVM_ROWS = 60_000     # rows the incremental view's INSERT merges
SQ_CURSOR_ROWS = 100_000  # rows of the parallel retrieve cursor
SQ_BAD_LINES = 10        # malformed lines in the external customer file
SQ_REJECT_LIMIT = 20
SQ_CLUSTER_RPP = 32_768  # rows per micro-partition of the clustered orders
SQ_NSEG = 8
SQ_DIR_BYTES = 1 << 20
SQ_Q1_VIEW = ("select l_returnflag, l_linestatus, sum(l_quantity) as "
              "sum_qty, sum(l_extendedprice) as sum_base_price, "
              "sum(l_discount) as sum_disc, count(*) as count_order from "
              "lineitem where l_shipdate <= date '1998-09-02' group by "
              "l_returnflag, l_linestatus order by l_returnflag, "
              "l_linestatus")
SQ_BY_NATION = ("select n_name, count(*) as c, sum({p}_acctbal) as s from "
                "{t} join nation on {p}_nationkey = n_nationkey "
                "group by n_name order by n_name")
# (g) GROUPING SETS, DISTINCT aggregates and set operations ALL at SF1
SQ_FAMILIES = {
    "rollup": ("select l_returnflag, l_linestatus, sum(l_quantity) as sq, "
               "sum(l_extendedprice) as sp, count(*) as c from lineitem "
               "group by rollup (l_returnflag, l_linestatus) "
               "order by l_returnflag, l_linestatus"),
    "cube": ("select l_returnflag, l_linestatus, count(*) as c, "
             "sum(l_quantity) as sq from lineitem group by cube "
             "(l_returnflag, l_linestatus) "
             "order by l_returnflag, l_linestatus"),
    "grouping_sets": ("select o_orderpriority, o_orderstatus, count(*) as c, "
                      "sum(o_totalprice) as s from orders group by grouping "
                      "sets ((o_orderpriority), (o_orderstatus)) "
                      "order by o_orderpriority, o_orderstatus"),
    "distinct": ("select l_returnflag, count(distinct l_suppkey) as cs, "
                 "count(distinct l_partkey) as cp from lineitem "
                 "group by l_returnflag order by l_returnflag"),
    "intersect_all": ("select o_custkey from orders intersect all "
                      "select c_custkey from customer order by o_custkey"),
    "except_all": ("select o_custkey from orders except all "
                   "select c_custkey from customer order by o_custkey"),
}


def null_rows(batch) -> list:
    """A small result's selected rows as tuples of Python values (strings
    decoded, DECIMAL as cents), None where a value is NULL."""
    cols = [(v.tolist(), ok.tolist()) for v, ok in with_nulls(batch).values()]
    n = len(cols[0][0]) if cols else 0
    return [tuple(v[i] if ok[i] else None for v, ok in cols)
            for i in range(n)]


def _codes(col):
    """(dense codes, sorted distinct values) of a key column."""
    import pandas as pd

    codes, uniq = pd.factorize(np.asarray(col), sort=True)
    return codes, uniq.tolist()


def _cell_sums(cell, values, n_cells: int):
    """Exact int64 sums of ``values`` per cell: bincount's float64 sums
    are exact while they stay below 2**53, so the values go in 26-bit
    halves."""
    v = np.asarray(values, dtype=np.int64)
    lo = np.bincount(cell, weights=v & ((1 << 26) - 1), minlength=n_cells)
    hi = np.bincount(cell, weights=v >> 26, minlength=n_cells)
    return (np.rint(hi).astype(np.int64) << 26) + np.rint(lo).astype(np.int64)


def _grouped_rows(keys: dict, sums: dict, sets: list) -> list:
    """The rows of a GROUP BY over grouping ``sets`` (tuples of key names)
    as its ORDER BY on every key gives them (NULLs last): the keys absent
    from a set are None, ``sums`` the integer columns to sum (None: a
    count), per row (keys, then sums in order). One pass over the rows
    sums every cell of the keys' product; each set sums those cells."""
    names = list(keys)
    coded = [_codes(keys[k]) for k in names]
    shape = tuple(len(u) for _, u in coded)
    n = int(np.prod(shape))
    cell = np.ravel_multi_index([c for c, _ in coded], shape)
    count = np.bincount(cell, minlength=n).reshape(shape)
    tot = [count if v is None else _cell_sums(cell, v, n).reshape(shape)
           for v in sums.values()]
    rows = []
    for st in sets:
        axes = tuple(i for i, k in enumerate(names) if k not in st)
        c = count.sum(axis=axes)
        ts = [t.sum(axis=axes) for t in tot]
        for idx in zip(*np.nonzero(c)) if st else [()]:
            it = iter(idx)
            rows.append(tuple(coded[i][1][next(it)] if k in st else None
                              for i, k in enumerate(names))
                        + tuple(int(t[idx]) for t in ts))
    return sorted(rows, key=lambda r: tuple(
        x for v in r[:len(names)] for x in (v is None, v or "")))


def family_oracle(raw, name):
    """Phase 15 (g)'s numpy answers: the grouped statements' rows
    (``null_rows`` form), the set operations' o_custkey column."""
    li, od = raw["lineitem"], raw["orders"]
    if name in ("rollup", "cube"):
        keys = {"l_returnflag": li["l_returnflag"],
                "l_linestatus": li["l_linestatus"]}
        qty, ep = _cents(li["l_quantity"]), _cents(li["l_extendedprice"])
        sums = {"sq": qty, "sp": ep, "c": None} if name == "rollup" \
            else {"c": None, "sq": qty}
        sets = [("l_returnflag", "l_linestatus"), ("l_returnflag",), ()]
        if name == "cube":
            sets.insert(2, ("l_linestatus",))
        return _grouped_rows(keys, sums, sets)
    if name == "grouping_sets":
        return _grouped_rows(
            {"o_orderpriority": od["o_orderpriority"],
             "o_orderstatus": od["o_orderstatus"]},
            {"c": None, "s": _cents(od["o_totalprice"])},
            [("o_orderpriority",), ("o_orderstatus",)])
    if name == "distinct":
        f, flags = _codes(li["l_returnflag"])
        out = []
        for col in ("l_suppkey", "l_partkey"):
            v = np.asarray(li[col])
            seen = np.zeros((len(flags), int(v.max()) + 1), dtype=bool)
            seen[f, v] = True
            out.append(seen.sum(axis=1))
        return [(flag, int(a), int(b)) for flag, a, b in zip(flags, *out)]
    keys, cnt = np.unique(np.asarray(od["o_custkey"]), return_counts=True)
    in_c = np.isin(keys, np.asarray(raw["customer"]["c_custkey"]))
    if name == "intersect_all":
        return keys[in_c]
    return np.repeat(keys, cnt - in_c.astype(np.int64))


def families_part(kit, raw, card, gpu, s8, counted) -> dict:
    """Phase 15 (g): SQ_FAMILIES at SF1 on one segment, each result equal
    to the numpy oracle, and on ``s8`` (SQ_NSEG segments), each equal to
    the one-segment result; walls and launches per statement. The first
    one-segment run of the two-DISTINCT statement, which reaches all
    three kernels, is held against their plain versions."""
    import cloudberry_tpu_torch as ct

    t0 = time.perf_counter()
    s1 = ct.Session(card)
    copy_tables(gpu, s1, ["customer", "orders", "lineitem"])
    kit.held("the two DISTINCT aggregates (held)",
             lambda: s1.sql(SQ_FAMILIES["distinct"]))
    out = {"oracle_s": 0.0}
    for name, sql in SQ_FAMILIES.items():
        grouped = not name.endswith("_all")
        res1, ms1, n1 = counted(s1, sql)
        got1 = null_rows(res1) if grouped \
            else physical(res1)["o_custkey"]
        t_or = time.perf_counter()
        want = family_oracle(raw, name)
        out["oracle_s"] += time.perf_counter() - t_or
        check((got1 == want) if grouped else np.array_equal(got1, want),
              f"(g) {name} on one segment vs the oracle: "
              f"{got1[:6]} vs {want[:6]}")
        res8, ms8, n8 = counted(s8, sql)
        got8 = null_rows(res8) if grouped \
            else physical(res8)["o_custkey"]
        check((got8 == got1) if grouped else np.array_equal(got8, got1),
              f"(g) {name} at {SQ_NSEG} segments vs one segment")
        out[name] = {"rows": len(got1), "ms": ms1, "launches": n1,
                     f"ms_{SQ_NSEG}": ms8, f"launches_{SQ_NSEG}": n8}
        log(f"[sql] (g) {name}: {len(got1)} rows, equal to the oracle and "
            f"at {SQ_NSEG} segments; one segment {ms1:.1f} ms (launches "
            f"{n1}), {SQ_NSEG} segments {ms8:.1f} ms (launches {n8})")
    del s1
    out["s"] = time.perf_counter() - t0
    log(f"[sql] (g) the three families: {out['s']:.1f} s (the oracle "
        f"{out['oracle_s']:.1f} s)")
    return out


def first_keys_below(keys, n) -> int:
    """The key K such that about n rows have a key below K."""
    ks = np.sort(np.asarray(keys))
    return int(ks[min(max(n, 1), len(ks) - 1)])


def drained_rows(session, cursor, segments, threads) -> tuple:
    """Every endpoint of a cursor drained by ``threads`` threads at once:
    (sorted row tuples, rows per endpoint, wall ms)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as ex:
        outs = list(ex.map(lambda g: session.retrieve(cursor, g),
                           segments))
    ms = (time.perf_counter() - t0) * 1e3
    check(all(o["remaining"] == 0 for o in outs),
          f"cursor {cursor}: an endpoint was not drained")
    rows = sorted(tuple(r) for o in outs for r in o["rows"])
    return rows, [len(o["rows"]) for o in outs], ms


def batch_rows(batch) -> list:
    """A result's rows as sorted tuples of decoded values (the form
    ``Session.retrieve`` returns)."""
    cols = batch.decoded_columns()
    return sorted(zip(*[cols[k].tolist() for k in cols]))


def sql_surface_phase(kit, raw, gpu, args) -> dict:
    """The rest of the SQL surface on the card (module docstring, phase
    15): transactions in RAM and on a store, materialized views with
    AQUMV and IVM, CLUSTER, external, foreign and directory tables and
    parallel retrieve cursors, each checked against a numpy oracle, the
    same statement with a feature off, a fresh REFRESH or the RAM
    tables, exactly."""
    import hashlib
    import shutil
    import sqlite3
    import tempfile

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.plan import matview as MV
    from cloudberry_tpu_torch.session import SerializationError
    from cloudberry_tpu_torch.types import date_to_days as D

    try:
        import pandas  # noqa: F401 — the IVM merge runs on it
    except ImportError:
        check(False, "pandas is not importable: the incremental views' "
              "merge needs it")
    torch = kit.torch
    sf = args.sf
    out = {}
    t_phase = time.perf_counter()
    names = ["region", "nation", "supplier", "customer", "orders",
             "lineitem"]
    card = gpu.config
    # no auto-ANALYZE after DML: its first run reads every row of the
    # 6M-row tables on the host, which no check of the phase needs
    quiet = card.with_overrides(**{"planner.autostats": "none"})
    li = raw["lineitem"]

    def scaled(n):
        return max(int(n * sf), 100)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    launches = {}

    def counted(s, sql):
        res, ms, counts = kit.counted_run(s, sql)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return res, ms, counts

    tmp = tempfile.mkdtemp(prefix="cb_sql_")
    try:
        # ------------------------------------------- (a) RAM transactions
        s = ct.Session(quiet)
        copy_tables(gpu, s, names)
        before = {}
        for q in ("q1", "q3", "q5"):
            res, ms, _ = counted(s, tpch.QUERIES[q])
            before[q] = physical(res)
            same(before[q], oracle(raw, q, D), f"{q} before BEGIN")
        k_ins = first_keys_below(li["l_orderkey"], scaled(SQ_TXN_ROWS))
        m_ins = li["l_orderkey"] < k_ins
        raw2 = dict(raw)
        raw2["lineitem"] = {c: np.concatenate([v, v[m_ins]])
                            for c, v in li.items()}
        od = dict(raw["orders"])
        prio = od["o_shippriority"].copy()
        prio[od["o_orderkey"] % 5 == 0] = 1
        od["o_shippriority"] = prio
        raw2["orders"] = od
        res, begin_ms = wall(lambda: s.sql("begin"))
        check(res == "BEGIN", f"BEGIN: {res}")
        st, ins_ms = wall(lambda: s.sql(
            f"insert into lineitem select * from lineitem "
            f"where l_orderkey < {k_ins}"))
        check(st == f"INSERT {int(m_ins.sum())}", f"INSERT … SELECT: {st}")
        st, upd_ms = wall(lambda: s.sql(
            "update orders set o_shippriority = 1 "
            "where o_orderkey % 5 = 0"))
        check(st == f"UPDATE {int((od['o_orderkey'] % 5 == 0).sum())}",
              f"UPDATE orders: {st}")
        txn_ms = {}
        for q in ("q1", "q3", "q5"):
            if q == "q3":
                res = kit.held("TPC-H q3 inside a transaction (held)",
                               lambda: s.sql(tpch.QUERIES[q]))
                same(physical(res), oracle(raw2, q, D),
                     f"{q} inside the transaction (held run)")
            res, txn_ms[q], counts = counted(s, tpch.QUERIES[q])
            same(physical(res), oracle(raw2, q, D),
                 f"{q} inside the transaction vs the oracle on the "
                 "changed data")
        res, rollback_ms = wall(lambda: s.sql("rollback"))
        check(res == "ROLLBACK", f"ROLLBACK: {res}")
        after_ms = {}
        for q in ("q1", "q3", "q5"):
            res, after_ms[q], _ = counted(s, tpch.QUERIES[q])
            same(physical(res), before[q], f"{q} after ROLLBACK vs before "
                 "BEGIN")
        # trap: a table dropped, re-created and filled in the transaction
        # leaves device copies under its name; the rollback drops them
        s.sql("begin")
        s.sql("drop table nation")
        s.sql("create table nation (n_nationkey bigint, n_name text, "
              "n_regionkey bigint, n_comment text)")
        s.sql("insert into nation values (0, 'NOWHERE', 2, 'x'), "
              "(1, 'ELSEWHERE', 2, 'y')")
        n2 = s.sql("select n_nationkey, n_name from nation "
                   "order by n_nationkey")
        check(n2.num_rows() == 2, "the re-created nation inside the txn")
        s.sql("rollback")
        check("nation" not in s._device_tables,
              "ROLLBACK kept the re-created nation's device copy")
        res, _, _ = counted(s, tpch.QUERIES["q5"])
        same(physical(res), before["q5"], "q5 after the rolled-back "
             "drop-and-recreate of nation")
        out["ram"] = {"begin_ms": begin_ms, "insert_select_ms": ins_ms,
                      "inserted": int(m_ins.sum()), "update_ms": upd_ms,
                      "in_txn_ms": txn_ms, "rollback_ms": rollback_ms,
                      "after_rollback_ms": after_ms}
        log(f"[sql] RAM transaction: BEGIN {begin_ms:.3f} ms, INSERT … "
            f"SELECT of {int(m_ins.sum())} lineitem rows {ins_ms:.1f} ms, "
            f"UPDATE orders {upd_ms:.1f} ms; Q1/Q3/Q5 inside "
            f"{[round(txn_ms[q], 1) for q in txn_ms]} ms equal to the "
            f"oracle on the changed data; ROLLBACK {rollback_ms:.3f} ms, "
            f"then {[round(after_ms[q], 1) for q in after_ms]} ms equal to "
            "the pre-transaction results bit for bit; the drop-and-"
            "recreate of nation rolled back with its device copy dropped")

        # --------------------------------------- (b) store transactions
        sroot = {"storage.root": os.path.join(tmp, "occ")}
        s1 = ct.Session(card.with_overrides(**sroot))
        copy_tables(gpu, s1, ["customer"])
        s2 = ct.Session(card.with_overrides(**sroot))
        cu = raw["customer"]
        n_cu = len(cu["c_custkey"])

        def n_rows(sess, where="true"):
            return int(np.asarray(sess.sql(
                f"select count(*) as n from customer where {where}")
                .columns["n"])[0])

        k_app = min(1000, n_cu)
        total = n_cu
        add = n_rows(s1, f"c_custkey <= {k_app}")
        s1.sql("begin")
        s1.sql(f"insert into customer select * from customer "
               f"where c_custkey <= {k_app}")
        st, commit_ms = wall(lambda: s1.sql("commit"))
        total += add
        check(st == "COMMIT" and n_rows(s2) == total,
              f"COMMIT seen by a second session: {st}, {n_rows(s2)}")
        s1.sql("begin")
        s1.sql("update customer set c_acctbal = c_acctbal + 1 "
               "where c_nationkey = 3")
        total += n_rows(s2, "c_custkey <= 10")
        s2.sql("insert into customer select * from customer "
               "where c_custkey <= 10")
        t0 = time.perf_counter()
        try:
            s1.sql("commit")
            check(False, "a conflicting rewrite committed")
        except SerializationError:
            pass
        conflict_ms = (time.perf_counter() - t0) * 1e3
        check(n_rows(s1) == total,
              "the losing session did not sync to the winner's commit")
        total += n_rows(s1, "c_custkey <= 5") + n_rows(s1, "c_custkey <= 7")
        s1.sql("begin")
        s2.sql("begin")
        s1.sql("insert into customer select * from customer "
               "where c_custkey <= 5")
        s2.sql("insert into customer select * from customer "
               "where c_custkey <= 7")
        s2.sql("commit")
        st, merge_ms = wall(lambda: s1.sql("commit"))
        s3 = ct.Session(card.with_overrides(**sroot))
        check(st == "COMMIT" and n_rows(s3) == total,
              f"concurrent appends merge: {st}, {n_rows(s3)} rows, "
              f"want {total}")
        want = total
        res, _, _ = counted(s3, "select c_nationkey, count(*) as c from "
                            "customer group by c_nationkey")
        check(int(np.asarray(res.columns["c"]).sum()) == want,
              "the merged customer's rows by nation")
        del s1, s2, s3
        out["store"] = {"commit_ms": commit_ms, "conflict_ms": conflict_ms,
                        "merge_commit_ms": merge_ms}
        log(f"[sql] store transactions: COMMIT of {k_app} appended "
            f"customer rows {commit_ms:.1f} ms, seen by a second session; "
            f"a conflicting rewrite raised SerializationError in "
            f"{conflict_ms:.1f} ms; concurrent appends merged "
            f"({merge_ms:.1f} ms), {want} rows in a fresh session")

        # ------------------------------------------- (c) views, AQUMV, IVM
        view = ("create materialized view mv_li as select l_returnflag, "
                "l_linestatus, l_shipdate, sum(l_quantity) as sum_qty, "
                "sum(l_extendedprice) as sum_base_price, sum(l_discount) "
                "as sum_disc, count(*) as count_order from lineitem group "
                "by l_returnflag, l_linestatus, l_shipdate")
        st, mat_ms, mat_counts = counted(s, view)
        check(st == "CREATE MATERIALIZED VIEW mv_li", f"the view: {st}")
        mv_rows = s.catalog.table("mv_li").num_rows
        check("AQUMV: answered from materialized view mv_li"
              in s.explain(SQ_Q1_VIEW), "EXPLAIN does not show AQUMV")
        res = kit.held("Q1-shaped from the view (held)",
                       lambda: s.sql(SQ_Q1_VIEW))
        on, on_ms, on_counts = counted(s, SQ_Q1_VIEW)
        on2, on2_ms, _ = counted(s, SQ_Q1_VIEW)
        s.config = quiet.with_overrides(**{"planner.enable_aqumv": False})
        check("AQUMV" not in s.explain(SQ_Q1_VIEW), "AQUMV off")
        off, off_ms, off_counts = counted(s, SQ_Q1_VIEW)
        off2, off2_ms, _ = counted(s, SQ_Q1_VIEW)
        s.config = quiet
        for r in (res, on, on2, off2):
            same(physical(r), physical(off), "the Q1-shaped query from the "
                 "view vs enable_aqumv off")
        # the incremental view reads a NOT NULL copy of lineitem
        k_ivm = first_keys_below(li["l_orderkey"], scaled(SQ_IVM_ROWS))
        nn_cols = ("l_orderkey bigint not null, l_returnflag text not null,"
                   " l_linestatus text not null, l_shipdate date not null, "
                   "l_quantity decimal(15,2) not null, l_extendedprice "
                   "decimal(15,2) not null")
        sel = ("select l_orderkey, l_returnflag, l_linestatus, l_shipdate, "
               "l_quantity, l_extendedprice from lineitem")
        s.sql(f"create table li_nn ({nn_cols})")
        _, copy_ms = wall(lambda: s.sql(
            f"insert into li_nn {sel} where l_orderkey >= {k_ivm}"))
        ivm = ("create incremental materialized view mv_nn as select "
               "l_returnflag, l_linestatus, l_shipdate, sum(l_quantity) as "
               "sq, sum(l_extendedprice) as se, count(*) as c from li_nn "
               "group by l_returnflag, l_linestatus, l_shipdate")
        _, ivm_ms, _ = counted(s, ivm)
        merges, refreshes = [], []
        real_app, real_dml = MV.maintain_on_append, MV.maintain_on_dml
        real_refresh = MV.refresh_matview

        def timed_merge(real):
            def call(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return real(*a, **kw)
                finally:
                    merges.append((time.perf_counter() - t0) * 1e3)
            return call

        MV.maintain_on_append = timed_merge(real_app)
        MV.maintain_on_dml = timed_merge(real_dml)
        MV.refresh_matview = lambda *a: refreshes.append(a[1]) \
            or real_refresh(*a)
        try:
            dml = {}
            for what, q in (
                    ("insert", f"insert into li_nn {sel} "
                               f"where l_orderkey < {k_ivm}"),
                    ("update", "update li_nn set l_quantity = l_quantity "
                               "+ 1 where l_shipdate < date '1992-03-01'"),
                    ("delete", "delete from li_nn where l_shipdate >= "
                               "date '1998-11-01'")):
                st, ms = wall(lambda: s.sql(q))
                dml[what] = {"status": st, "statement_ms": ms,
                             "merge_ms": merges[-1]}
        finally:
            MV.maintain_on_append, MV.maintain_on_dml = real_app, real_dml
            MV.refresh_matview = real_refresh
        check(not refreshes, f"the IVM merges refreshed {refreshes}")
        view_sql = ("select l_returnflag, l_linestatus, l_shipdate, sq, se, "
                    "c from mv_nn order by l_returnflag, l_linestatus, "
                    "l_shipdate")
        merged = physical(s.sql(view_sql))
        st, refresh_ms = wall(lambda: s.sql(
            "refresh materialized view mv_nn"))
        same(merged, physical(s.sql(view_sql)), "the merged incremental "
             "view vs a fresh REFRESH")
        out["views"] = {"materialize_ms": mat_ms, "view_rows": mv_rows,
                        "materialize_launches": mat_counts,
                        "aqumv_on_ms": [on_ms, on2_ms],
                        "aqumv_off_ms": [off_ms, off2_ms],
                        "aqumv_on_launches": on_counts,
                        "aqumv_off_launches": off_counts,
                        "not_null_copy_ms": copy_ms,
                        "incremental_materialize_ms": ivm_ms,
                        "ivm": dml, "refresh_ms": refresh_ms}
        log(f"[sql] the view over lineitem by (l_returnflag, l_linestatus, "
            f"l_shipdate): {mv_rows} rows, materialized in {mat_ms:.1f} ms "
            f"(launches {mat_counts}); the Q1-shaped query from it "
            f"{on_ms:.3f} / {on2_ms:.3f} ms (launches {on_counts}) against "
            f"{off_ms:.3f} / {off2_ms:.3f} ms with enable_aqumv off "
            f"(launches {off_counts}), equal; incremental view over the "
            f"NOT NULL copy ({copy_ms:.1f} ms to copy, {ivm_ms:.1f} ms to "
            f"materialize): "
            + ", ".join(f"{w} {d['status']} {d['statement_ms']:.1f} ms "
                        f"(merge {d['merge_ms']:.1f} ms)"
                        for w, d in dml.items())
            + f", no refresh; equal to a fresh REFRESH ({refresh_ms:.1f} "
            "ms)")
        s.sql("drop materialized view mv_nn")
        s.sql("drop table li_nn")

        # ---------------------------------------------------- (d) CLUSTER
        croot = {"storage.root": os.path.join(tmp, "cluster"),
                 "storage.rows_per_partition": SQ_CLUSTER_RPP,
                 "planner.autostats": "none"}
        sc = ct.Session(card.with_overrides(**croot))
        _, load_ms = wall(lambda: copy_tables(gpu, sc, ["orders"]))
        k_cust = first_keys_below(raw["customer"]["c_custkey"],
                                  len(raw["customer"]["c_custkey"]) // 32)
        q_range = ("select count(*) as c, sum(o_totalprice) as s from "
                   f"orders where o_custkey <= {k_cust}")

        def fresh_report():
            fresh = ct.Session(card.with_overrides(**croot))
            return fresh, store_scan_reports(fresh, q_range)[0]

        # before: the partitions the plan would read (the same range on
        # the RAM orders gives the result); after: a cold read of them
        rep0 = fresh_report()[1]
        res0 = physical(gpu.sql(q_range))
        st, cluster_ms = wall(lambda: sc.sql(
            "cluster orders by (o_orderdate, o_custkey)"))
        fresh, rep1 = fresh_report()
        res, ms1, _ = counted(fresh, q_range)
        res1 = physical(res)
        same(res1, res0, "the range on o_custkey after CLUSTER vs the RAM "
             "orders")
        o = raw["orders"]
        mo = o["o_custkey"] <= k_cust
        check(int(res0["c"][0]) == int(mo.sum())
              and int(res0["s"][0]) == int(_cents(o["o_totalprice"])[mo]
                                           .sum()),
              "the range on o_custkey vs the numpy oracle")
        check(rep1["parts"] < rep0["parts"],
              f"CLUSTER: {rep1['parts']} partitions read after, "
              f"{rep0['parts']} before")
        out["cluster"] = {"load_ms": load_ms, "cluster_s": cluster_ms / 1e3,
                          "status": st, "parts_before": rep0["parts"],
                          "parts_after": rep1["parts"],
                          "candidates": rep0["candidates"],
                          "range_ms_after": ms1}
        log(f"[sql] CLUSTER orders by (o_orderdate, o_custkey): "
            f"{cluster_ms / 1e3:.2f} s (writing orders to the store "
            f"{load_ms / 1e3:.2f} s); o_custkey <= {k_cust} reads "
            f"{rep1['parts']} of {rep1['candidates']} partitions after, "
            f"{rep0['parts']} before; cold read after {ms1:.1f} ms, equal "
            "to the RAM orders and the oracle")
        del sc, fresh

        # ------------------------- (e) external, foreign, directory tables
        lines = tbl_lines(cu, tpch.SCHEMAS["customer"])
        n_bad = SQ_BAD_LINES
        step = max(len(lines) // (n_bad + 1), 1)
        for i in range(n_bad):
            lines.insert((i + 1) * step + i, f"bad{i}|" + "|".join(
                ["x"] * (len(tpch.SCHEMAS["customer"].fields) - 1)))
        path = os.path.join(tmp, "customer.tbl")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        s.sql(f"create external table customer_x "
              f"({ddl_columns(tpch.SCHEMAS['customer'])}) "
              f"location('file://{path}') segment reject limit "
              f"{SQ_REJECT_LIMIT} log errors")
        want = physical(s.sql(SQ_BY_NATION.format(p="c", t="customer")))
        # every statement re-reads the file: one run times a re-read
        res, ext_ms, ext_counts = counted(
            s, SQ_BY_NATION.format(p="c", t="customer_x"))
        same(physical(res), want, "external customer by nation vs the RAM "
             "customer")
        errors = len(s.copy_errors.get("customer_x", []))
        check(errors == n_bad, f"external rejects: {errors}, want {n_bad}")
        sup = raw["supplier"]
        db = os.path.join(tmp, "supplier.db")
        con = sqlite3.connect(db)
        sfields = tpch.SCHEMAS["supplier"].fields
        con.execute(f"create table supplier "
                    f"({', '.join(f.name for f in sfields)})")
        con.executemany(
            f"insert into supplier values ({', '.join('?' * len(sfields))})",
            zip(*[np.asarray(sup[f.name]).tolist() for f in sfields]))
        con.commit()
        con.close()
        s.sql(f"create foreign table supplier_f "
              f"({ddl_columns(tpch.SCHEMAS['supplier'])}) server sqlite "
              f"options (database '{db}', table 'supplier')")
        want = physical(s.sql(SQ_BY_NATION.format(p="s", t="supplier")))
        res = kit.held("the foreign supplier joined to nation (held)",
                       lambda: s.sql(SQ_BY_NATION.format(p="s",
                                                         t="supplier_f")))
        same(physical(res), want, "foreign supplier by nation (held run)")
        res, fdw_ms, fdw_counts = counted(
            s, SQ_BY_NATION.format(p="s", t="supplier_f"))
        same(physical(res), want, "foreign supplier by nation vs the RAM "
             "supplier")
        droot = {"storage.root": os.path.join(tmp, "dir"),
                 "storage.encryption_key": "phase-15-key"}
        sd = ct.Session(card.with_overrides(**droot))
        sd.sql("create directory table docs")
        blob = np.random.default_rng(SEED).integers(
            0, 256, SQ_DIR_BYTES, dtype=np.uint8).tobytes()
        _, up_ms = wall(lambda: sd.dir_upload("docs", "a/blob.bin", blob))
        sd.dir_upload("docs", "b.txt", b"hello")
        meta = physical(sd.sql("select relative_path, size, md5 from docs "
                               "order by relative_path"))
        check(meta["relative_path"].tolist() == ["a/blob.bin", "b.txt"]
              and meta["size"].tolist() == [SQ_DIR_BYTES, 5]
              and meta["md5"][0] == hashlib.md5(blob).hexdigest(),
              f"directory table rows: {meta}")
        with open(os.path.join(droot["storage.root"], "_dirtab", "docs",
                               "b.txt"), "rb") as f:
            check(b"hello" not in f.read(), "TDE: the file is plaintext")
        got, read_ms = wall(lambda: sd.dir_read("docs", "a/blob.bin"))
        check(got == blob, "the directory table's read differs")
        del sd
        out["external"] = {"external_ms": ext_ms, "rejected": errors,
                           "external_launches": ext_counts,
                           "foreign_ms": fdw_ms,
                           "foreign_launches": fdw_counts,
                           "dir_upload_ms": up_ms, "dir_read_ms": read_ms}
        log(f"[sql] file:// external customer ({len(cu['c_custkey'])} rows, "
            f"{errors} bad lines rejected under a limit of "
            f"{SQ_REJECT_LIMIT}) joined to nation, re-read per statement: "
            f"{ext_ms:.1f} ms (launches {ext_counts}); "
            f"sqlite foreign supplier joined to nation {fdw_ms:.1f} ms "
            f"(launches {fdw_counts}); both equal to the RAM tables; "
            f"directory table with TDE: upload of {SQ_DIR_BYTES} bytes "
            f"{up_ms:.1f} ms, read {read_ms:.1f} ms, md5 equal")
        del s

        # -------------------------------- (f) parallel retrieve cursors
        s8 = ct.Session(card.with_overrides(n_segments=SQ_NSEG))
        copy_tables(gpu, s8, ["nation", "customer", "orders", "lineitem"])
        k_cur = first_keys_below(li["l_orderkey"], scaled(SQ_CURSOR_ROWS))
        q_cur = ("select l_orderkey, l_linenumber, l_quantity, "
                 "l_extendedprice from lineitem where l_orderkey < "
                 f"{k_cur}")
        direct, direct_ms, _ = counted(s8, q_cur)    # shards on the card
        want_rows = batch_rows(direct)
        check(len(want_rows) == int((li["l_orderkey"] < k_cur).sum()),
              "the cursor query's direct result vs numpy")
        vmem0 = s8._vmem.used
        alloc0 = torch.cuda.memory_allocated()
        info, declare_ms, cur_counts = counted(
            s8, f"declare cur parallel retrieve cursor for {q_cur}")
        check(info["parallel"] and len(info["endpoints"]) == SQ_NSEG,
              f"the cursor's endpoints: {info['parallel']}, "
              f"{len(info['endpoints'])}")
        held_bytes = s8._vmem.used - vmem0
        check(held_bytes > 0, "the cursor reserves no vmem")
        # the endpoints hold host rows: an open cursor holds no device
        # bytes beyond what the session had cached before it
        alloc_open = torch.cuda.memory_allocated()
        check(alloc_open <= alloc0, f"device bytes with the cursor open "
              f"{alloc_open} > before DECLARE {alloc0}")
        rows, per_ep, drain_ms = drained_rows(s8, "cur", range(SQ_NSEG),
                                              SQ_NSEG)
        check(rows == want_rows, "the drained endpoints vs the direct "
              "result")
        s8.sql("close cur")
        check(s8._vmem.used == vmem0, "CLOSE did not release the vmem")
        alloc1 = torch.cuda.memory_allocated()
        check(alloc1 <= alloc0, f"device bytes after CLOSE {alloc1} > "
              f"before DECLARE {alloc0}")
        qj = ("select c_custkey, c_acctbal, n_name from customer join "
              "nation on c_nationkey = n_nationkey where c_mktsegment = "
              "'BUILDING'")
        info, join_ms, join_counts = counted(
            s8, f"declare curj parallel retrieve cursor for {qj}")
        check(info["parallel"], "the join cursor fell back to one endpoint")
        rows, _, join_drain_ms = drained_rows(s8, "curj", range(SQ_NSEG),
                                              SQ_NSEG)
        check(rows == batch_rows(s8.sql(qj)), "the join cursor vs direct")
        s8.sql("close curj")
        qs = ("select l_orderkey, l_linenumber, l_extendedprice from "
              "lineitem order by l_extendedprice desc, l_orderkey, "
              "l_linenumber limit 10")
        info = s8.sql(f"declare curs parallel retrieve cursor for {qs}")
        check(not info["parallel"] and len(info["endpoints"]) == 1,
              "ORDER BY … LIMIT did not fall back to one endpoint")
        rows, _, _ = drained_rows(s8, "curs", [0], 1)
        check(rows == batch_rows(s8.sql(qs)), "the ON_ENTRY endpoint vs "
              "direct")
        s8.sql("close curs")
        check(s8._vmem.used == vmem0, "vmem after the last CLOSE")
        out["cursor"] = {"rows": len(want_rows), "per_endpoint": per_ep,
                         "declare_ms": declare_ms, "drain_ms": drain_ms,
                         "direct_ms": direct_ms, "held_bytes": held_bytes,
                         "device_bytes_before": alloc0,
                         "device_bytes_open": alloc_open,
                         "device_bytes_after_close": alloc1,
                         "launches": cur_counts,
                         "join_declare_ms": join_ms,
                         "join_drain_ms": join_drain_ms,
                         "join_launches": join_counts}
        log(f"[sql] parallel retrieve cursor at {SQ_NSEG} segments over "
            f"{len(want_rows)} lineitem rows: DECLARE {declare_ms:.1f} ms, "
            f"{SQ_NSEG} threads drained {per_ep} rows in {drain_ms:.1f} ms "
            f"(direct SELECT {direct_ms:.1f} ms), the union equal to it; "
            f"{held_bytes} bytes reserved until CLOSE, released; device "
            f"bytes {alloc0} before DECLARE, {alloc1} after CLOSE; the join "
            f"cursor {join_ms:.1f} ms + drain {join_drain_ms:.1f} ms "
            f"(launches {join_counts}); ORDER BY … LIMIT on one endpoint")

        # ---- (g) GROUPING SETS, DISTINCT aggregates, set operations ALL
        out["families"] = families_part(kit, raw, quiet, gpu, s8, counted)
        del s8
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------ phase 16: serving

# phase 9's store: the DML at its end deleted the lineitem rows shipped
# after this date (Q1/Q3/Q5's oracle is taken over the rest), and left
# these copies and derived tables, which phase 16 drops first: every
# connection's backend reads every table's manifest when it starts
STORE_DELETED_AFTER = "1998-08-01"
STORE_EXTRA = ("orders_load", "orders_back", "orders_rej", "q3_all",
               "li_late", "lineitem_p", "customer_b")
SERVE_CLIENTS = 8           # (a): client threads, one backend each
SERVE_WALL_RUNS = 3         # wire and direct walls per query
SERVE_SKELETON = 16         # (b): Q1-shaped requests and point lookups
SERVE_TENANT_CONNS = 12     # (c): connections per tenant (24 > max_batch)
SERVE_TENANT_REQS = 10      # (c): requests per connection
# closed-loop readings (statement, connections), each over a fixed count
# of requests (enough for a p99 of its own); Q1 at 32 connections went
# (it read as Q1 at 8 in every run)
SERVE_QPS = (("point", 1), ("point", 8), ("point", 32), ("q1", 1),
             ("q1", 8))
# 100 leaves the script room for phase 19's cluster and store parts on
# a slow machine (1,000 took about 29 s more than 400, 400 48 s in all);
# a p99 still has SERVE_P99_MIN samples
SERVE_QPS_REQS = 100
SERVE_P99_MIN = 100         # fewer samples report a max, not a p99
SERVE_STACK_ROUNDS = 5      # (b): stacked batches and sequential passes
# the point lookup of (b), (c) and the QPS readings: a lineitem order by
# its key. Its table's manifest is small (no comment dictionary): a point
# lookup on customer spent about 70 ms a statement parsing customer's
# manifest in this phase's first run on the card (ROADMAP Queue C 15, 47)
SERVE_POINT = ("select l_orderkey, l_linenumber, l_quantity, l_shipdate "
               "from lineitem where l_orderkey = {} order by l_linenumber")
SERVE_POINT_COLS = ("l_orderkey", "l_linenumber", "l_quantity",
                    "l_shipdate")
SERVE_APPEND_ROWS = 10_000  # (d)
SERVE_TIMEOUT = 300         # every socket and join of the phase


def wire_expected(want: dict, fields) -> dict:
    """A numpy oracle's physical columns as the server renders them on
    the wire (serve/server.py ``_render``): DECIMAL as its fixed-point
    integer over 10^scale in float64, DATE as ISO text, the rest as
    Python scalars — so the comparison with the wire is exact."""
    cols, rows = [], []
    for f in fields:
        v = np.asarray(want[f.name])
        base = f.type.base.value
        if base == "decimal":
            v = v.astype(np.int64).astype(np.float64) / (10.0 ** f.type.scale)
            cols.append([float(x) for x in v])
        elif base == "date":
            cols.append([str(np.datetime64(int(x), "D")) for x in v])
        elif base == "float64":
            cols.append([float(x) for x in v])
        elif base == "string":
            cols.append([str(x) for x in v])
        else:
            cols.append([int(x) for x in v])
    rows = [list(r) for r in zip(*cols)]
    return {"columns": [f.name for f in fields], "rows": rows,
            "rowcount": len(rows)}


def percentiles(ms: list) -> tuple:
    """(p50, p99) of the samples, with the max in place of a p99 that
    fewer than SERVE_P99_MIN samples cannot resolve."""
    a = np.asarray(ms, dtype=np.float64)
    if not len(a):
        return (None, None)
    return (float(np.percentile(a, 50)), float(np.percentile(a, 99))
            if len(a) >= SERVE_P99_MIN else float(a.max()))


def tail_name(ms: list) -> str:
    return "p99" if len(ms) >= SERVE_P99_MIN else "max"


def serving_phase(kit, raw, root) -> dict:
    """The serving front end on the card (module docstring, phase 16),
    over phase 9's store at ``root``."""
    import contextlib
    import io
    import signal
    import threading

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch.mgmt import cli as CLI
    from cloudberry_tpu_torch.types import date_to_days as D

    t_phase = time.perf_counter()
    out = {"timeouts_s": SERVE_TIMEOUT}

    # the data as phase 9 left it, and the oracle over it
    after = store_after_dml(raw)
    base_cfg = ct.Config().with_overrides(**{
        "storage.root": root, "resource.query_mem_bytes": CARD_BUDGET,
        "resource.total_mem_bytes": 64 << 30,
        "bufferpool.max_bytes": 8 << 30})
    boot = ct.Session(base_cfg)
    for name in STORE_EXTRA:
        boot.sql(f"drop table if exists {name}")
    del boot
    # the CLI's cluster record over phase 9's store, for (h)
    with contextlib.redirect_stdout(io.StringIO()):
        check(CLI.main(["--store", root, "init", "--segments", "1"]) == 0,
              "mgmt init over phase 9's store failed")
    # (h) starts first: its interpreter, imports and session load overlap
    # (a) to (g); it is queried at the end
    port_h = free_port()
    child = subprocess.Popen(
        [sys.executable, "-m", "cloudberry_tpu_torch", "--device",
         kit.device, "--store", root, "serve", "--port", str(port_h)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t_child = time.perf_counter()
    said, up = [], threading.Event()

    def read_child():
        for line in child.stdout:
            said.append((time.perf_counter(), line))
            if line.startswith("serving on"):
                up.set()

    reader = threading.Thread(target=read_child, daemon=True)
    reader.start()
    servers = []
    try:
        out["setup_s"] = time.perf_counter() - t_phase
        out.update(_serving_runs(kit, after, base_cfg, servers, port_h,
                                 up))
        # ---------------------------------------------- (h) the CLI serve
        t0 = time.perf_counter()
        t_up, first = next(x for x in said if x[1].startswith("serving"))
        check(f"serving on 127.0.0.1:{port_h}" in first
              and f", {kit.device})" in first,
              f"the `serve` subprocess said {first!r}")
        up_s = t_up - t_child
        conn = out.pop("connect")
        text, _ = conn.communicate(timeout=SERVE_TIMEOUT)
        lines = text.splitlines()
        want = oracle(after, "q1", D)
        check(conn.returncode == 0 and lines[0].split("\t") == list(want)
              and [int(r.split("\t")[-1]) for r in lines[1:]]
              == [int(c) for c in want["count_order"]],
              f"sql --connect exited {conn.returncode}: {lines[:3]}")
        child.send_signal(signal.SIGINT)
        rc_child = child.wait(timeout=SERVE_TIMEOUT)
        check(rc_child == 0, f"the `serve` subprocess exited {rc_child}")
        out["cli"] = {"ready_s": up_s, "exit": rc_child,
                      "s": time.perf_counter() - t0}
        log(f"[serve] (h) `python -m cloudberry_tpu_torch --store ROOT "
            f"serve` served {up_s:.1f} s after its start; a `python -m "
            f"cloudberry_tpu_torch sql --connect` child (both overlapping "
            f"(b)-(g)) printed Q1, its count_order column equal to the "
            f"oracle; SIGINT drained the server, exit {rc_child}")
    finally:
        for srv in servers:
            srv.stop()
        for proc in (child, out.pop("connect", None)):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        reader.join(timeout=60)
    out["s"] = time.perf_counter() - t_phase
    return out


def free_port() -> int:
    """A free localhost TCP port (bound, then released for a child)."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _serving_runs(kit, after, base_cfg, servers, port_h, up) -> dict:
    """Phase 16's (a) to (g) over phase 9's store: ``after`` is the TPC-H
    data as phase 9 left it, ``base_cfg`` the store's config; every
    server started is appended to ``servers``. Once (a) is done and the
    ``serve`` child on ``port_h`` is ``up``, (h)'s ``sql --connect``
    child starts (``out["connect"]``)."""
    import threading

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.config import TenantSpec
    from cloudberry_tpu_torch.exec import cuda_kernels as CK
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.serve import Client, Server, ServerError
    from cloudberry_tpu_torch.types import date_to_days as D

    torch = kit.torch
    out = {}
    T = SERVE_TIMEOUT
    q1_dates = ("1998-12-01", "1998-11-15", "1998-10-01")
    texts = {q: " ".join(tpch.QUERIES[q].split()) for q in ("q1", "q3", "q5")}

    def q1_at(d):
        return texts["q1"].replace("'1998-12-01'", f"'{d}'")

    # per text: the oracle rendered as the wire renders it, from the
    # direct run's field types (a direct session over the same store)
    direct = ct.Session(base_cfg)
    want = {}
    for q, d in (("q1", q1_dates[0]), ("q1b", q1_dates[1]),
                 ("q1c", q1_dates[2]), ("q3", None), ("q5", None)):
        sql = q1_at(d) if q.startswith("q1") else texts[q]
        res = direct.sql(sql)
        name = q[:2]
        phys = oracle(after, name, D, q1_date=d) if d else \
            oracle(after, name, D)
        same(physical(res), phys, f"{q} direct from the store vs the "
             "numpy oracle")
        want[sql] = wire_expected(phys, res.schema.fields)
    a_texts = [texts["q1"], texts["q3"], texts["q5"], q1_at(q1_dates[1]),
               q1_at(q1_dates[2])]
    # the point lookups: orders among the first 500,000 lineitem rows
    # (the store's first micro-partition), their rows as phase 9 left them
    lk = after["lineitem"]
    okeys = np.unique(lk["l_orderkey"][:500_000])
    rng = np.random.default_rng(SEED)
    pkeys = [int(k) for k in rng.choice(okeys, 64, replace=False)]
    fields = direct.sql(SERVE_POINT.format(pkeys[0])).schema.fields
    for k in pkeys:
        rows = np.nonzero(lk["l_orderkey"] == k)[0]
        rows = rows[np.argsort(lk["l_linenumber"][rows], kind="stable")]
        want[SERVE_POINT.format(k)] = wire_expected({
            "l_orderkey": lk["l_orderkey"][rows],
            "l_linenumber": lk["l_linenumber"][rows],
            "l_quantity": _cents(lk["l_quantity"])[rows],
            "l_shipdate": lk["l_shipdate"][rows]}, fields)

    def wire_ok(resp, sql, what):
        check(resp == want[sql], f"{what}: the wire answered "
              f"{str(resp)[:300]}, the oracle {str(want[sql])[:300]}")

    # --------------------------------- (a) per-connection server, 8 clients
    t0 = time.perf_counter()
    srv = Server(config=base_cfg).start()
    servers.append(srv)
    check(srv.per_connection and srv.session.device.type == kit.device,
          f"the store-backed server is not per-connection on "
          f"{kit.device}")
    clients = [Client(srv.host, srv.port, timeout=T)
               for _ in range(SERVE_CLIENTS)]
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_b = time.perf_counter()
    for sql in a_texts[:3]:
        wire_ok(clients[0].sql(sql), sql, "(a) one connection")
    first_conn_s = time.perf_counter() - t_b
    torch.cuda.synchronize()
    peak1 = torch.cuda.max_memory_allocated() - base_bytes
    torch.cuda.reset_peak_memory_stats()
    errors, walls = [], []

    def a_thread(i):
        try:
            # Q1, Q3, Q5 and Q1 at one of two more ship dates
            mine = a_texts[:3] + [a_texts[3 + i % 2]]
            for sql in mine[i % 4:] + mine[:i % 4]:
                t = time.perf_counter()
                resp = clients[i].sql(sql)
                walls.append((time.perf_counter() - t) * 1e3)
                wire_ok(resp, sql, f"(a) client {i}")
        except BaseException as e:  # noqa: BLE001 — failed below
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    def run_a():
        ths = [threading.Thread(target=a_thread, args=(i,))
               for i in range(SERVE_CLIENTS)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=T)
        check(not any(th.is_alive() for th in ths), "(a) a client hung")

    _, a_ms, a_counts = kit.counted(run_a)
    check(not errors, f"(a) {errors[:3]}")
    check(all(a_counts.get(k, 0) > 0 for k in CK.LAUNCHES),
          f"(a) a kernel never launched on the serving path: {a_counts}")
    torch.cuda.synchronize()
    peak8 = torch.cuda.max_memory_allocated() - base_bytes
    backends = [c.session for lp in srv._transport._loops
                for c in list(lp.conns) if c.session is not None]
    scan = srv.session._store_scan_cache
    scan_bytes = sum(X._nbytes(v) for v in list(scan.values()))
    pool = srv.session._cache_scope.bufferpool
    pool_bytes = pool.snapshot()["bytes"] if pool is not None else 0
    check(backends and all(b._cache_scope is srv.session._cache_scope
                           and b._store_scan_cache is scan
                           for b in backends),
          "the backends do not share the server's cache scope and "
          "store-scan cache")
    check(scan_bytes + pool_bytes <= base_cfg.bufferpool.max_bytes,
          f"(a) scan copies {scan_bytes} and pool {pool_bytes} bytes over "
          f"bufferpool.max_bytes")
    out["a"] = {"ms": a_ms, "requests": len(walls),
                "request_ms_p50_tail": percentiles(walls),
                "tail": tail_name(walls),
                "launches": a_counts, "first_connection_s": first_conn_s,
                "peak_bytes_1_conn": peak1, "peak_bytes_8_conns": peak8,
                "shared_scan_cache_bytes": scan_bytes,
                "shared_pool_bytes": pool_bytes,
                "s": time.perf_counter() - t0}
    log(f"[serve] (a) {SERVE_CLIENTS} clients on the per-connection "
        f"server sent Q1, Q3, Q5 and Q1 at two more ship dates: "
        f"{len(walls)} requests in {a_ms:.1f} ms, each equal to the "
        f"numpy oracle on the wire (DECIMAL, COUNT, dates, averages "
        f"exactly); request ms p50/{tail_name(walls)} "
        f"{percentiles(walls)}; launches "
        f"{a_counts}; the first connection (backend start and a cold "
        f"scan) {first_conn_s:.2f} s; peak device bytes above the "
        f"resident {base_bytes}: {peak1} with 1 connection, {peak8} with "
        f"{SERVE_CLIENTS}; the backends' one store-scan cache holds "
        f"{scan_bytes} bytes beside the shared pool's {pool_bytes}")
    kit.held("(a) Q1, Q3, Q5 over the wire",
             lambda: [wire_ok(clients[1].sql(q), q, "(a) held")
                      for q in a_texts[:3]])
    # (h)'s client: `sql --connect` in a child process of its own, which
    # runs beside (b) to (g); the `serve` child is up by now
    check(up.wait(T), "the `serve` subprocess never served")
    out["connect"] = subprocess.Popen(
        [sys.executable, "-m", "cloudberry_tpu_torch", "sql", "--connect",
         f"127.0.0.1:{port_h}", texts["q1"]],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # --------------------------- wire against direct walls, Q1, Q3, Q5
    overhead = {}
    for q in ("q1", "q3", "q5"):
        sql = texts[q]
        direct.sql(sql)
        wire_ms, direct_ms = [], []
        for _ in range(SERVE_WALL_RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            clients[0].sql(sql)
            wire_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            direct.sql(sql)
            torch.cuda.synchronize()
            direct_ms.append((time.perf_counter() - t) * 1e3)
        overhead[q] = {"wire_ms": wire_ms, "direct_ms": direct_ms,
                       "overhead_ms": float(np.median(wire_ms)
                                            - np.median(direct_ms))}
    out["wire_vs_direct"] = overhead
    log(f"[serve] wire against direct Session.sql, medians of "
        f"{SERVE_WALL_RUNS}: " + ", ".join(
            f"{q} {np.median(v['wire_ms']):.2f} / "
            f"{np.median(v['direct_ms']):.2f} ms (serving overhead "
            f"{v['overhead_ms']:.2f})" for q, v in overhead.items()))
    del direct

    # ----------------------------------- (d) 10,000 rows by wire appends
    t0 = time.perf_counter()
    c0, c1 = clients[0], clients[1]
    for name in ("ev_append", "ev_insert"):
        c0.sql(f"create table {name} (k bigint, v decimal(12,2), s text, "
               "d date)")
    rows = [[i, (i % 1000) + 0.25, f"s'{i % 97}",
             f"1995-{1 + i % 12:02d}-{1 + i % 28:02d}"]
            for i in range(SERVE_APPEND_ROWS)]
    chunks = [rows[i:i + 100] for i in range(0, len(rows), 100)]
    app_err, acks = [], []

    def appender(j):
        try:
            for ch in chunks[j::4]:
                acks.append(clients[2 + j].append("ev_append", ch))
        except BaseException as e:  # noqa: BLE001 — failed below
            app_err.append(f"{type(e).__name__}: {e}")

    ths = [threading.Thread(target=appender, args=(j,)) for j in range(4)]
    t_app = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=T)
    append_ms = (time.perf_counter() - t_app) * 1e3
    check(not app_err and sum(acks) == SERVE_APPEND_ROWS,
          f"(d) appends: {app_err[:3]}, {sum(acks)} rows acknowledged")

    def lit(r):
        return (f"({r[0]}, {r[1]!r}, '{r[2].replace(chr(39), chr(39) * 2)}'"
                f", '{r[3]}')")

    t_ins = time.perf_counter()
    for i in range(0, len(rows), 1000):
        c1.sql("INSERT INTO ev_insert VALUES "
               + ", ".join(lit(r) for r in rows[i:i + 1000]))
    insert_ms = (time.perf_counter() - t_ins) * 1e3
    got_a = c0.sql("select k, v, s, d from ev_append order by k")
    got_i = c0.sql("select k, v, s, d from ev_insert order by k")
    check(got_a == got_i and got_a["rowcount"] == SERVE_APPEND_ROWS
          and got_a["rows"][7] == [7, 7.25, "s'7", "1995-08-08"],
          f"(d) the appended table differs from the INSERT sequence: "
          f"{got_a['rows'][:2]} vs {got_i['rows'][:2]}")
    ing = c0.meta("ingest")
    out["d"] = {"rows": SERVE_APPEND_ROWS, "append_ms": append_ms,
                "insert_ms": insert_ms, "flushes": ing["flushes"],
                "appends": ing["appends"], "s": time.perf_counter() - t0}
    log(f"[serve] (d) {SERVE_APPEND_ROWS} rows by {len(chunks)} wire "
        f"appends from 4 connections in {append_ms:.1f} ms "
        f"({ing['flushes']} group commits), the same rows as 10 INSERT "
        f"statements in {insert_ms:.1f} ms: equal row for row")

    # ------------------------------------ (e) wire transaction conflict
    c0.sql("create table tx (x bigint)")
    c0.sql("insert into tx values (1)")
    c0.sql("begin")
    c1.sql("begin")
    c0.sql("insert into tx values (2)")
    c1.sql("update tx set x = x * 10 where x = 1")
    c0.sql("commit")
    try:
        c1.sql("commit")
        check(False, "(e) the losing COMMIT succeeded")
    except ServerError as e:
        check(e.etype == "SerializationError" and not e.retryable,
              f"(e) the loser got {e.etype}: {e}")
    check(clients[2].sql("select x from tx order by x")["rows"]
          == [[1], [2]], "(e) the loser's update landed")
    log("[serve] (e) two connections' transactions: the first COMMIT "
        "won, the rewriting one failed with SerializationError")

    # ------------------------------------------------------------ (f) meta
    meta = {}
    for verb in ("metrics", "activity", "ingest", "topology"):
        meta[verb] = clients[3].meta(verb)
    check(meta["ingest"]["enabled"] and meta["topology"]["enabled"]
          and "active" in meta["activity"] and "gauges" in meta["metrics"],
          f"(f) meta answers {str(meta)[:300]}")
    g = meta["metrics"]["gauges"]
    out["f"] = {"gauges": {k: g[k] for k in sorted(g)
                           if k.startswith(("mem_", "topo_"))},
                "requests_served": meta["metrics"]["counters"].get(
                    "requests_served"),
                "recent": len(meta["activity"]["recent"])}

    # ------------------------------------------------ (g) drain in flight
    t0 = time.perf_counter()
    late = Client(srv.host, srv.port, timeout=T)
    g_res, g_refused, g_err = [], [], []
    stop_pound = threading.Event()

    def pound(i):
        try:
            while not stop_pound.is_set():
                sql = a_texts[i % 3]
                try:
                    resp = clients[i].sql(sql)
                    wire_ok(resp, sql, f"(g) client {i}")
                    g_res.append(i)
                except ServerError as e:
                    if e.etype == "ServerDraining" and e.retryable:
                        g_refused.append(i)
                        return
                    if str(e).startswith("server closed"):
                        return
                    raise
        except OSError:
            return      # the transport closed: never accepted
        except BaseException as e:  # noqa: BLE001 — failed below
            g_err.append(f"client {i}: {type(e).__name__}: {e}")

    ths = [threading.Thread(target=pound, args=(i,))
           for i in range(SERVE_CLIENTS)]
    for th in ths:
        th.start()
    # the drain begins once the load is being served: under this load a
    # request takes up to seconds ((a)'s tail), and a fixed one-second
    # wait once saw no answer yet on the card
    end = time.perf_counter() + T
    while not g_res and not g_err and time.perf_counter() < end \
            and any(th.is_alive() for th in ths):
        time.sleep(0.01)
    n_before = len(g_res)
    stopper = threading.Thread(target=srv.stop, kwargs={"drain_s": 30.0})
    stopper.start()
    while not srv._draining:
        time.sleep(0.001)
    try:
        late.sql("select count(*) from tx")
        check(False, "(g) a request after the drain began was served")
    except ServerError as e:
        check(e.etype == "ServerDraining" and e.retryable,
              f"(g) the late request got {e.etype}: {e}")
    stopper.join(timeout=T)
    stop_pound.set()
    for th in ths:
        th.join(timeout=T)
    check(not g_err and n_before > 0, f"(g) {n_before} requests answered "
          f"before the drain began; errors {g_err[:3]}")
    for c in (late, *clients):
        c.close()
    out["g"] = {"served": len(g_res), "served_before_drain": n_before,
                "refused": len(g_refused), "s": time.perf_counter() - t0}
    log(f"[serve] (g) stop(drain_s=30) under {SERVE_CLIENTS} clients' "
        f"load: {len(g_res)} requests answered right ({n_before} before "
        f"the drain began), {len(g_refused)} refused with the retryable "
        f"ServerDraining, none dropped; a request after the drain began "
        f"refused likewise")

    # -------------------- (b) and (c): the dispatcher, with tenancy on
    t0 = time.perf_counter()
    dcfg = base_cfg.with_overrides(**{
        "sched.enabled": True, "sched.generic_plans": True,
        "sched.tick_s": 0.05, "sched.max_batch": SERVE_SKELETON,
        "tenancy.enabled": True, "tenancy.aging_s": 3600.0,
        "tenancy.tenants": (TenantSpec("gold", weight=3, max_queue=4096),
                            TenantSpec("silver", weight=1,
                                       max_queue=4096))})
    # an explicit session pins the shared-session mode: every connection
    # reads through the server's session (no backend per connection)
    ds = ct.Session(dcfg)
    dsrv = Server(session=ds).start()
    servers.append(dsrv)
    dates = [f"1998-{9 + i // 28:02d}-{1 + i % 28:02d}"
             for i in range(SERVE_SKELETON)]
    pt = SERVE_POINT
    b_texts = [q1_at(d) for d in dates] + \
        [pt.format(k) for k in pkeys[:SERVE_SKELETON]]
    for sql in (b_texts[0], b_texts[SERVE_SKELETON]):
        ds.sql(sql)             # build the generic plans
    conns = [Client(dsrv.host, dsrv.port, timeout=T) for _ in b_texts]
    bar = threading.Barrier(len(conns))
    b_out, b_err = {}, []

    def b_thread(i):
        try:
            bar.wait(timeout=T)
            b_out[i] = conns[i].sql(b_texts[i])
        except BaseException as e:  # noqa: BLE001 — failed below
            b_err.append(f"{type(e).__name__}: {e}")

    def run_b():
        ths = [threading.Thread(target=b_thread, args=(i,))
               for i in range(len(conns))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=T)

    c_before = ds.counters.snapshot()
    _, b_ms, b_counts = kit.counted(run_b)
    c_after = ds.counters.snapshot()
    check(not b_err and len(b_out) == len(b_texts), f"(b) {b_err[:3]}")
    delta = {k: c_after.get(k, 0) - c_before.get(k, 0) for k in (
        "batched_statements", "batch_rung_compiles", "fast_rebinds",
        "generic_hits", "dispatches")}
    for i, sql in enumerate(b_texts):
        seq = dsrv._render(ds.sql(sql))
        seq.pop("ok")
        check(b_out[i] == seq, f"(b) request {i} differs from its own "
              f"sequential run: {str(b_out[i])[:200]} vs {str(seq)[:200]}")
    for sql in b_texts[SERVE_SKELETON:]:
        wire_ok(b_out[b_texts.index(sql)], sql, "(b) point lookup")
    check(delta["batched_statements"] > 0
          and delta["batch_rung_compiles"] <= 5
          and b_counts.get("dense_agg", 0) == SERVE_SKELETON,
          f"(b) counters {delta}, launches {b_counts}")
    snap = dsrv.dispatcher.snapshot()
    # stacked against sequential, the Q1-shaped skeleton alone: rounds of
    # 16 requests at once, against as many one by one on one connection
    q1_conns = conns[:SERVE_SKELETON]
    bar2 = threading.Barrier(SERVE_SKELETON + 1)
    s_err = []

    def q1_thread(i):
        try:
            for _ in range(SERVE_STACK_ROUNDS):
                bar2.wait(timeout=T)
                q1_conns[i].sql(b_texts[i])
        except BaseException as e:  # noqa: BLE001 — failed below
            s_err.append(f"{type(e).__name__}: {e}")
            bar2.abort()

    ths = [threading.Thread(target=q1_thread, args=(i,))
           for i in range(SERVE_SKELETON)]
    c_s = ds.counters.snapshot()
    for th in ths:
        th.start()
    bar2.wait(timeout=T)
    t = time.perf_counter()
    for _ in range(SERVE_STACK_ROUNDS - 1):
        bar2.wait(timeout=T)
    for th in ths:
        th.join(timeout=T)
    stacked_s = time.perf_counter() - t
    check(not s_err, f"(b) stacked rounds: {s_err[:3]}")
    stacked_n = ds.counters.counter("batched_statements") \
        - c_s.get("batched_statements", 0)
    # from here on the default coalescing window: (b) widened it so that
    # its requests meet in one tick, which a lone request would wait out
    # (a full batch flushes at once); the worker reads it at every tick
    dsrv.dispatcher.tick_s = ct.Config().sched.tick_s
    t = time.perf_counter()
    for _ in range(SERVE_STACK_ROUNDS):
        for sql in b_texts[:SERVE_SKELETON]:
            conns[0].sql(sql)
    seq_s = time.perf_counter() - t
    n_stack = SERVE_SKELETON * SERVE_STACK_ROUNDS
    out["b"] = {"ms": b_ms, "counters": delta, "launches": b_counts,
                "dispatcher": snap, "stacked_qps": n_stack / stacked_s,
                "stacked_lanes": stacked_n, "requests": n_stack,
                "sequential_qps": n_stack / seq_s,
                "s": time.perf_counter() - t0}
    log(f"[serve] (b) {SERVE_SKELETON} Q1-shaped requests at 16 ship dates "
        f"and {SERVE_SKELETON} lineitem point lookups at once through the "
        f"dispatcher (generic plans on): {b_ms:.1f} ms, counters {delta}, "
        f"launches {b_counts}, every result equal to its own sequential "
        f"run; the skeleton alone, {SERVE_STACK_ROUNDS} rounds of "
        f"{SERVE_SKELETON}: stacked {out['b']['stacked_qps']:.1f} QPS "
        f"({stacked_n} of {n_stack} requests in stacked lanes) against "
        f"sequential {out['b']['sequential_qps']:.1f} QPS on one "
        f"connection")
    for c in conns:
        c.close()

    # ------------------------------------------ (c) two tenants at 3:1
    t0 = time.perf_counter()
    tc = {n: [Client(dsrv.host, dsrv.port, timeout=T, tenant=n)
              for _ in range(SERVE_TENANT_CONNS)] for n in ("gold", "silver")}
    c_err, c_done = [], {"gold": 0, "silver": 0}
    per_tenant = SERVE_TENANT_CONNS * SERVE_TENANT_REQS
    lock = threading.Lock()
    pick = rng.integers(0, len(pkeys),
                        (2, SERVE_TENANT_CONNS, SERVE_TENANT_REQS))
    t_snap0 = dsrv.tenancy.snapshot()

    def c_thread(ti, name, j):
        try:
            for r in pick[ti, j]:
                sql = pt.format(pkeys[r])
                wire_ok(tc[name][j].sql(sql), sql, f"(c) {name}")
                with lock:
                    c_done[name] += 1
        except BaseException as e:  # noqa: BLE001 — failed below
            c_err.append(f"{name}: {type(e).__name__}: {e}")

    ths = [threading.Thread(target=c_thread, args=(ti, n, j))
           for ti, n in enumerate(("gold", "silver"))
           for j in range(SERVE_TENANT_CONNS)]
    t_c = time.perf_counter()
    for th in ths:
        th.start()
    share = None
    while any(th.is_alive() for th in ths):
        # the share served while both tenants still had requests queued:
        # what silver had been served when gold finished
        if share is None and c_done["gold"] == per_tenant:
            share = dict(c_done)
        time.sleep(0.002)
    for th in ths:
        th.join(timeout=T)
    c_s = time.perf_counter() - t_c
    check(not c_err, f"(c) {c_err[:3]}")
    t_snap = dsrv.tenancy.snapshot()
    picks = {n: t_snap[n]["picks"] - t_snap0.get(n, {}).get("picks", 0)
             for n in ("gold", "silver")}
    out["c"] = {"requests": dict(c_done), "s": c_s,
                "share_at_half": share, "picks": picks,
                "fairness_index": dsrv.tenancy.fairness_index(),
                "wait_max_ms": {n: t_snap[n]["wait_max_ms"]
                                for n in ("gold", "silver")}}
    log(f"[serve] (c) tenants gold:silver weighted 3:1, "
        f"{SERVE_TENANT_CONNS} connections each, {SERVE_TENANT_REQS} "
        f"point lookups per connection: every result right; served "
        f"{share} when gold finished (reported, not gated); picks "
        f"{picks}; fairness index "
        f"{out['c']['fairness_index']:.4f}; {c_s:.2f} s")
    for cs in tc.values():
        for c in cs:
            c.close()

    # ----- closed-loop QPS: point lookups at 1, 8, 32 connections, Q1 at
    # 1 and 8; each reading is SERVE_QPS_REQS requests
    import itertools

    qps = {}
    gens = {"point": lambda i, n: pt.format(pkeys[(i * 7 + n) % len(pkeys)]),
            "q1": lambda i, n: b_texts[(i + n) % SERVE_SKELETON]}
    for kind, nconn in SERVE_QPS:
        gen = gens[kind]
        cl = [Client(dsrv.host, dsrv.port, timeout=T) for _ in range(nconn)]
        lat, q_err = [], []
        tickets = itertools.count()
        bar3 = threading.Barrier(nconn + 1)

        def loop(i):
            try:
                bar3.wait(timeout=T)
                n = 0
                while next(tickets) < SERVE_QPS_REQS:
                    t = time.perf_counter()
                    cl[i].sql(gen(i, n))
                    lat.append((time.perf_counter() - t) * 1e3)
                    n += 1
            except BaseException as e:  # noqa: BLE001 — failed below
                q_err.append(f"{type(e).__name__}: {e}")

        ths = [threading.Thread(target=loop, args=(i,))
               for i in range(nconn)]
        for th in ths:
            th.start()
        bar3.wait(timeout=T)
        t = time.perf_counter()
        for th in ths:
            th.join(timeout=T)
        el = time.perf_counter() - t
        check(not q_err and len(lat) == SERVE_QPS_REQS,
              f"QPS {kind} x{nconn}: {len(lat)} answers, {q_err[:3]}")
        p50, tail = percentiles(lat)
        qps[f"{kind}@{nconn}"] = {"qps": len(lat) / el, "p50_ms": p50,
                                  tail_name(lat) + "_ms": tail,
                                  "requests": len(lat), "s": el}
        for c in cl:
            c.close()
    out["qps"] = qps
    log(f"[serve] closed-loop QPS (p50 / p99 ms, {SERVE_QPS_REQS} requests "
        "each) on the dispatcher server over the store, " + ", ".join(
            f"{k}: {v['qps']:.1f} ({v['p50_ms']:.2f} / {v['p99_ms']:.2f})"
            for k, v in qps.items()))

    # ----------------------------------------------- (f) dispatcher meta
    with Client(dsrv.host, dsrv.port, timeout=T) as c:
        sched, tenants = c.meta("sched"), c.meta("tenants")
    check(sched["generic_plans"] and sched["dispatcher"]["batches"] > 0
          and tenants["enabled"] and set(tenants["groups"])
          >= {"gold", "silver"}, f"(f) sched {str(sched)[:200]}, "
          f"tenants {str(tenants)[:200]}")
    out["f"]["sched"] = {k: sched["dispatcher"][k] for k in (
        "batches", "batched_requests", "avg_occupancy", "singles",
        "seq_fallbacks", "max_depth")}
    out["f"]["fairness_index"] = tenants["fairness_index"]
    log(f"[serve] (f) meta metrics, activity, ingest and topology on the "
        f"per-connection server and sched and tenants on the dispatcher "
        f"server answered: gauges {out['f']['gauges']}, dispatcher "
        f"{out['f']['sched']}, fairness {tenants['fairness_index']}")
    dsrv.stop()
    return out


# ---------------------------------------- phase 17: durability and management

DUR_NSEG = 8            # (d) the external table's and (f) the bundle's gang
DUR_WIRE = (4, 8, 7)    # (g) the server's segments: start, expand, failover
DUR_CLIENTS = 8         # (g) client threads
DUR_ANSWERS = 8         # (g) answers each stage waits for
DUR_POINT_KEYS = 8      # (g) lineitem orders the point lookups ask for
DUR_TIMEOUT = 300       # every socket, join and wait of the phase
DUR_SEAM = ("compact_commit", 1)   # (c) the crash-torture seam and hit
# (a) the visimap delete pass: phase 9's SQL DELETE rewrote lineitem
# (delete-and-rewrite over immutable columns, as the reference's DELETE
# does), which leaves no delete vector; TableStore.delete_rows, the write
# path of the reference's compaction tests, marks these rows in every
# partition's delete vector instead
DUR_DELETE_MOD = 37


def store_after_dml(raw) -> dict:
    """The TPC-H data as phase 9's DML left its store: the lineitem rows
    shipped after STORE_DELETED_AFTER deleted (the Q1/Q3/Q5 oracle's
    columns only)."""
    from cloudberry_tpu_torch.types import date_to_days as D

    li = raw["lineitem"]
    keep = li["l_shipdate"] <= D(STORE_DELETED_AFTER)
    after = dict(raw)
    after["lineitem"] = {k: np.asarray(li[k])[keep] for k in (
        "l_orderkey", "l_suppkey", "l_linenumber", "l_quantity",
        "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
        "l_linestatus", "l_shipdate")}
    return after


def durability_phase(kit, raw, gpu, root) -> dict:
    """Durability and management on the card (module docstring, phase
    17), over phase 9's store at ``root`` as phases 9 and 16 left it;
    ``gpu``: phase 3's session, whose SF1 tables (g) serves from RAM."""
    import tempfile
    import threading

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.exec import cuda_kernels as CK
    from cloudberry_tpu_torch.storage.compact import (CompactionService,
                                                      delta_parts)
    from cloudberry_tpu_torch.tools import crash_torture
    from cloudberry_tpu_torch.storage.fsck import fsck
    from cloudberry_tpu_torch.types import date_to_days as D

    t_phase = time.perf_counter()
    out = {"timeouts_s": DUR_TIMEOUT}
    launches = {k: 0 for k in CK.LAUNCHES}

    def counted(fn):
        res, ms, counts = kit.counted(fn)
        for k, v in counts.items():
            launches[k] += v
        return res, ms

    after = store_after_dml(raw)
    texts = {q: tpch.QUERIES[q] for q in ("q1", "q3", "q5")}
    cfg = ct.Config().with_overrides(**{
        "storage.root": root, "resource.query_mem_bytes": CARD_BUDGET,
        "resource.total_mem_bytes": 64 << 30,
        "bufferpool.max_bytes": 8 << 30})

    def deep_fsck(what):
        t0 = time.perf_counter()
        rep = fsck(root, deep=True)
        s = time.perf_counter() - t0
        check(rep["clean"] and not rep["census_skipped"],
              f"fsck --deep {what}: {rep['problems'][:3]}, census skipped "
              f"{rep['census_skipped']}")
        return {"s": s, "tables": len(rep["tables"]),
                "partitions": sum(t["partitions"]
                                  for t in rep["tables"].values()),
                "checked": sum(t["checked"] for t in rep["tables"].values()),
                "orphans": len(rep["orphans"])}

    # (c) runs beside (a) and (b): its two `serve` children work on a
    # store of their own while this process checks and compacts SF1
    seam, hit = DUR_SEAM
    torture = {}

    def torture_run():
        t0 = time.perf_counter()
        try:
            torture["rec"] = crash_torture.run_seam(seam, hit=hit,
                                                    device=kit.device)
        except BaseException as e:  # noqa: BLE001 — raised at (c)
            torture["error"] = e
        finally:
            torture["s"] = time.perf_counter() - t0

    torturer = threading.Thread(target=torture_run, name="smoke-torture")
    torturer.start()

    # --------------------------------------------- (a) the untouched store
    out["fsck_before"] = deep_fsck("of the untouched store")
    s = ct.Session(cfg)
    t0 = time.perf_counter()
    s.store.delete_rows("lineitem",
                        lambda c: c["l_orderkey"] % DUR_DELETE_MOD == 0)
    out["delete_pass_s"] = time.perf_counter() - t0
    li = after["lineitem"]
    keep = li["l_orderkey"] % DUR_DELETE_MOD != 0
    after["lineitem"] = {k: v[keep] for k, v in li.items()}
    results, out["a_ms"] = {}, {}
    for q, sql in texts.items():
        kit.held(f"{q} from the store before compaction",
                 lambda sql=sql: s.sql(sql))
        res, ms = counted(lambda sql=sql: s.sql(sql))
        results[q] = physical(res)
        same(results[q], oracle(after, q, D), f"(a) {q} from the untouched "
             "store vs the numpy oracle")
        out["a_ms"][q] = ms
    log(f"[durable] (a) fsck --deep of phase 9's store: "
        f"{out['fsck_before']['tables']} tables, "
        f"{out['fsck_before']['checked']} partitions checksummed in "
        f"{out['fsck_before']['s']:.2f} s, clean; the visimap delete of "
        f"{int((~keep).sum())} lineitem rows (l_orderkey % "
        f"{DUR_DELETE_MOD} = 0) {out['delete_pass_s']:.2f} s; Q1 / Q3 / Q5 "
        f"from the store {out['a_ms']['q1']:.1f} / {out['a_ms']['q3']:.1f} "
        f"/ {out['a_ms']['q5']:.1f} ms, equal to the oracle, every kernel "
        "call held against its plain version")

    # ----------------------------------------------------- (b) compaction
    comp = CompactionService(s)
    rpp = s.store.rows_per_partition

    def census(name):
        man = s.store.read_manifest(name)
        return {"partitions": len(man["partitions"]),
                "rows": sum(p["num_rows"] - len(p["deleted"])
                            for p in man["partitions"]),
                "dirty": sum(1 for p in man["partitions"] if p["deleted"]),
                "delta_parts": delta_parts(man, rpp, comp.target_fill)}

    passes = {}
    ev_before = physical(s.sql("select count(*) as c, sum(k) as sk, "
                               "sum(v) as sv from ev_append"))
    for name, force in (("lineitem", True), ("ev_append", False)):
        before = census(name)
        check(before["delta_parts"] > (0 if force else comp.max_delta_parts),
              f"(b) {name} has no debt to fold: {before}")
        t0 = time.perf_counter()
        res = comp.run_once(table=name, force=force)
        sec = time.perf_counter() - t0
        done = census(name)
        # a chunk's output can be a small tail the next chunk merges
        # again: the pass's rows count every row it wrote
        check(res["tables"] == 1 and res["chunks"] >= 1
              and done["delta_parts"] == 0 and done["dirty"] == 0
              and done["rows"] == before["rows"] <= res["rows"],
              f"(b) {name}: {before} → {done}, pass {res}")
        passes[name] = {"before": before, "after": done, "pass": res,
                        "s": sec, "rows_per_s": res["rows"] / sec}
    check(passes["lineitem"]["pass"]["rows"]
          == int(after["lineitem"]["l_orderkey"].shape[0]),
          f"(b) lineitem rows rewritten: {passes['lineitem']['pass']}")
    out["b"] = passes
    out["b_ms"] = {}
    for q, sql in texts.items():
        res, ms = counted(lambda sql=sql: s.sql(sql))
        same(physical(res), results[q], f"(b) {q} after compaction vs (a)")
        out["b_ms"][q] = ms
    same(physical(s.sql("select count(*) as c, sum(k) as sk, sum(v) as sv "
                        "from ev_append")), ev_before,
         "(b) ev_append after its pass")
    out["fsck_after"] = deep_fsck("after compaction")
    li, ev = passes["lineitem"], passes["ev_append"]
    log(f"[durable] (b) compaction: lineitem {li['pass']['rows']} rows "
        f"({li['before']['partitions']} partitions, {li['before']['dirty']} "
        f"with delete vectors → {li['after']['partitions']} clean) in "
        f"{li['pass']['chunks']} chunk(s), {li['s']:.2f} s "
        f"({li['rows_per_s']:.0f} rows/s); ev_append's threshold pass "
        f"{ev['before']['partitions']} → {ev['after']['partitions']} "
        f"partitions ({ev['pass']['rows']} rows, {ev['s']:.3f} s); Q1 / Q3 "
        f"/ Q5 then {out['b_ms']['q1']:.1f} / {out['b_ms']['q3']:.1f} / "
        f"{out['b_ms']['q5']:.1f} ms, equal to (a) bit for bit; fsck "
        f"--deep clean again ({out['fsck_after']['s']:.2f} s)")

    # -------------------------------------------------- (c) crash torture
    t0 = time.perf_counter()
    torturer.join(timeout=DUR_TIMEOUT)
    check(not torturer.is_alive(), "(c) the crash torture did not end in "
          f"{DUR_TIMEOUT} s")
    if "error" in torture:
        raise torture["error"]
    rec = torture["rec"]
    check(rec["fired"] and rec["exit_code"] == 137 and not rec["problems"]
          and rec["acked_lost"] == 0 and rec["fsck_clean"]
          and rec["recovery_ms"] is not None,
          f"(c) crash torture at {seam}@{hit}: {rec}")
    out["c"] = {**rec, "s": torture["s"],
                "wait_s": time.perf_counter() - t0}
    log(f"[durable] (c) a `serve` child on {kit.device} killed at "
        f"{seam}@{hit} (exit {rec['exit_code']}) after "
        f"{rec['acked_inserts']} acknowledged inserts, none lost; restart "
        f"to first answer {rec['recovery_ms']:.1f} ms; fsck clean, "
        f"{rec['orphans']} orphan(s) collected by GC; {torture['s']:.1f} s "
        f"beside (a) and (b), {out['c']['wait_s']:.1f} s waited for after "
        "them")

    # --------------------------------------------------------- (d) cbfdist
    from cloudberry_tpu_torch.serve import fdist

    tmp = tempfile.mkdtemp(prefix="cb_fdist_")
    srv, port = None, None
    try:
        path = os.path.join(tmp, "customer.tbl")
        lines = tbl_lines(raw["customer"], tpch.SCHEMAS["customer"])
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        srv, port = fdist.serve(tmp)
        g = ct.Session(ct.Config(n_segments=DUR_NSEG).with_overrides(**{
            "resource.query_mem_bytes": CARD_BUDGET}))
        tpch.load_tables(g, tpch.SCHEMAS, tpch.DIST_KEYS, raw, ["nation"])
        cols = ddl_columns(tpch.SCHEMAS["customer"])
        g.sql(f"create external table customer_d ({cols}) "
              f"location('cbfdist://127.0.0.1:{port}/customer.tbl')")
        g.sql(f"create external table customer_f ({cols}) "
              f"location('file://{path}')")
        got_d, ms_d = counted(lambda: g.sql(
            SQ_BY_NATION.format(p="c", t="customer_d")))
        got_f, ms_f = counted(lambda: g.sql(
            SQ_BY_NATION.format(p="c", t="customer_f")))
        same(physical(got_d), physical(got_f), "(d) customer by nation "
             "through cbfdist:// vs file://")
        full = "select c_custkey, c_name, c_acctbal, c_phone from {} " \
               "order by c_custkey"
        same(physical(g.sql(full.format("customer_d"))),
             physical(g.sql(full.format("customer_f"))),
             "(d) every customer row through cbfdist:// vs file://")
        check(int(np.asarray(physical(got_d)["c"]).sum()) == len(lines),
              "(d) the external customer's row count")
        out["d"] = {"lines": len(lines), "cbfdist_ms": ms_d,
                    "file_ms": ms_f, "segments": DUR_NSEG}
        del g
    finally:
        if srv is not None:
            srv.shutdown()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[durable] (d) the port's cbfdist served customer's "
        f"{out['d']['lines']} lines to an external table at {DUR_NSEG} "
        f"segments: by nation {ms_d:.1f} ms through cbfdist://, "
        f"{ms_f:.1f} ms through file://, every row equal")

    # ------------------------------------------------------------- (e) MCP
    from cloudberry_tpu_torch.serve.mcp import McpServer, SessionEngine

    mcp = McpServer(SessionEngine(s))
    req = {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
           "params": {"name": "execute_query",
                      "arguments": {"sql": texts["q1"]}}}
    resp, ms_e = counted(lambda: mcp.handle(req))
    check(resp["result"]["isError"] is False,
          f"(e) MCP execute_query: {str(resp)[:300]}")
    body = json.loads(resp["result"]["content"][0]["text"])
    res = s.sql(texts["q1"])
    want = wire_expected(oracle(after, "q1", D), res.schema.fields)
    check(body == want, f"(e) MCP Q1 vs Session.sql: {str(body)[:300]} vs "
          f"{str(want)[:300]}")
    refused = mcp.handle({"jsonrpc": "2.0", "id": 2, "method": "tools/call",
                          "params": {"name": "execute_query", "arguments": {
                              "sql": "update lineitem set l_tax = 0"}}})
    check(refused.get("error", {}).get("code") == -32602
          and "read-only" in refused["error"]["message"],
          f"(e) MCP let an UPDATE through: {refused}")
    out["e"] = {"ms": ms_e, "rows": body["rowcount"]}
    log(f"[durable] (e) MCP execute_query with Q1's text answered in "
        f"{ms_e:.1f} ms, equal to Session.sql's rows rendered for the "
        "wire; an UPDATE refused as not read-only")

    # ------------------------------------------------ (f) flight replay
    from cloudberry_tpu_torch.tools import flight_replay

    cfg8 = ct.Config(n_segments=DUR_NSEG).with_overrides(**{
        "storage.root": root, "resource.query_mem_bytes": CARD_BUDGET,
        "obs.slow_ms": 0.01})
    f8 = ct.Session(cfg8)
    res, ms_cap = counted(lambda: f8.sql(texts["q3"]))
    same(physical(res), results["q3"], f"(f) Q3 at {DUR_NSEG} segments")
    bundle = next((b for b in f8.stmt_log.flights(16)
                   if b["sql"] == texts["q3"] and b.get("replayable")),
                  None)
    check(bundle is not None and bundle["n_segments"] == DUR_NSEG,
          f"(f) no replayable Q3 bundle at {DUR_NSEG} segments: "
          f"{None if bundle is None else bundle['n_segments']}")
    bundle = json.loads(json.dumps(bundle))   # as exported over the wire
    del f8
    verdict, ms_rep = counted(lambda: flight_replay.replay(
        bundle, device=kit.device))
    check(verdict["ok"], f"(f) the replay's digest differs: {verdict}")
    out["f"] = {"capture_ms": ms_cap, "replay_ms": ms_rep,
                "n_segments": bundle["n_segments"],
                "rows": verdict["got"]["rows"],
                "sha256": verdict["got"]["sha256"]}
    log(f"[durable] (f) Q3's flight bundle at {DUR_NSEG} segments "
        f"({ms_cap:.1f} ms captured) replayed in a fresh session in "
        f"{ms_rep:.1f} ms: sha256 {verdict['got']['sha256'][:16]}… equal")
    del s

    # ------------------------------------ (h) the six configuration keys
    out["h"] = keys_part(counted, raw, cfg, texts, results)

    # --------------------------------- (g) online expand under wire load
    out["g"] = _expand_under_load(kit, counted, raw, gpu)
    out["launches"] = launches
    check(all(launches.values()), f"a kernel never launched in phase 17: "
          f"{launches}")
    out["s"] = time.perf_counter() - t_phase
    return out


# (h) each key at a value other than its default, over phase 9's store
DUR_KEYS = {
    "storage.verify_checksums": {"storage.verify_checksums": False},
    "bufferpool.enabled": {"bufferpool.enabled": False},
    "sched.shared_cache": {"sched.shared_cache": False},
    # the variants bound only generic plans, which are off by default
    "sched.max_variants": {"sched.max_variants": 1,
                           "sched.generic_plans": True},
    "storage.partition_selector_max_build": {
        "storage.partition_selector_max_build": 0},
}


def keys_part(counted, raw, cfg, texts, results) -> dict:
    """Phase 17 (h): a scratch store of supplier under a disk quota below
    its usage refuses an INSERT and a COPY FROM, answers reads, runs a
    DELETE and, after a DROP, takes writes again; then each of DUR_KEYS
    over phase 9's store (``cfg``) answers Q1 / Q3 / Q5 equal to
    ``results`` (the defaults'), and the disabled pool admits nothing."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.exec import bufferpool as BUF
    from cloudberry_tpu_torch.sched import sharedcache as SC
    from cloudberry_tpu_torch.storage.table_store import QuotaError

    t_part = time.perf_counter()
    out = {}
    su = raw["supplier"]
    tmp = tempfile.mkdtemp(prefix="cb_quota_")
    try:
        qroot = os.path.join(tmp, "store")
        w = ct.Session(ct.Config().with_overrides(**{"storage.root": qroot}))
        tpch.load_tables(w, tpch.SCHEMAS, tpch.DIST_KEYS, raw, ["supplier"])
        used = w.store.disk_usage(fresh=True)
        del w
        path = os.path.join(tmp, "two.tbl")
        with open(path, "w") as f:
            f.write("\n".join(tbl_lines({k: np.asarray(v)[:2]
                                          for k, v in su.items()},
                                         tpch.SCHEMAS["supplier"])) + "\n")
        q = ct.Session(ct.Config().with_overrides(**{
            "storage.root": qroot, "storage.quota_bytes": used // 2}))
        refused = {}
        for what, sql in (
                ("insert", "insert into supplier select * from supplier "
                           "where s_suppkey = 1"),
                ("copy", f"copy supplier from '{path}'")):
            t0 = time.perf_counter()
            try:
                q.sql(sql)
                refused[what] = None
            except QuotaError as e:
                refused[what] = (str(e), (time.perf_counter() - t0) * 1e3)
            check(refused[what] is not None
                  and refused[what][0].startswith("disk quota exceeded"),
                  f"(h) the {what} past the quota: {refused[what]}")
        read = "select count(*) as c, sum(s_acctbal) as s from supplier"
        res, read_ms = counted(lambda: q.sql(read))
        same(physical(res), {"c": np.array([len(su["s_suppkey"])]),
                             "s": np.array([_cents(su["s_acctbal"]).sum()])},
             "(h) supplier read past the quota vs numpy")
        t0 = time.perf_counter()
        st = q.sql("delete from supplier where s_suppkey % 10 = 0")
        delete_ms = (time.perf_counter() - t0) * 1e3
        gone = int((np.asarray(su["s_suppkey"]) % 10 == 0).sum())
        check(st == f"DELETE {gone}", f"(h) DELETE past the quota: {st}")
        q.sql("drop table supplier")
        q.sql("create table after_drop (x bigint)")
        st = q.sql("insert into after_drop values (1)")
        check(st == "INSERT 1", f"(h) the INSERT after the DROP: {st}")
        out["quota"] = {"quota_bytes": used // 2, "used_bytes": used,
                        "refused_ms": {k: v[1] for k, v in refused.items()},
                        "read_ms": read_ms, "delete_ms": delete_ms,
                        "deleted": gone}
        del q
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[durable] (h) a supplier store of {used} bytes under a quota of "
        f"{used // 2}: INSERT and COPY FROM refused with QuotaError "
        f"({out['quota']['refused_ms']['insert']:.1f} / "
        f"{out['quota']['refused_ms']['copy']:.1f} ms), the read "
        f"{read_ms:.1f} ms equal to numpy, DELETE of {gone} rows "
        f"{delete_ms:.1f} ms, writes taken again after DROP")

    def variant(over):
        """A session with ``over``, and its Q1 / Q3 / Q5 (results, ms)."""
        v = ct.Session(cfg.with_overrides(**over))
        got, ms = {}, {}
        for qn, sql in texts.items():
            t0 = time.perf_counter()
            got[qn] = physical(v.sql(sql))
            ms[qn] = (time.perf_counter() - t0) * 1e3
        return v, got, ms

    def side_by_side():
        # each variant's config is a new cache epoch, so its scans read
        # the store cold: the five run at once, their decodes overlapping
        with ThreadPoolExecutor(max_workers=len(DUR_KEYS),
                                thread_name_prefix="smoke-keys") as ex:
            futs = {k: ex.submit(variant, over)
                    for k, over in DUR_KEYS.items()}
            return {k: f.result() for k, f in futs.items()}

    runs, out["keys_ms"] = counted(side_by_side)
    base = ct.Session(cfg)
    out["keys"] = {}
    for key, (v, got, ms) in runs.items():
        for qn in texts:
            same(got[qn], results[qn], f"(h) {qn} with {DUR_KEYS[key]} vs "
                 "the defaults")
        if key == "bufferpool.enabled":
            pool_calls = {c: v.stmt_log.counter(c) for c in (
                "bufpool_hits", "bufpool_misses", "bufpool_admits")}
            check(BUF.pool_for(v) is None and not any(pool_calls.values()),
                  f"(h) the disabled pool was used: {pool_calls}")
        elif key == "sched.shared_cache":
            check(SC.scope_for(v) is not SC.scope_for(base)
                  and SC.scope_for(v).kind == "session",
                  "(h) shared_cache off still shares the store's scope")
        elif key == "sched.max_variants":
            widths = [len(b) for b in v._generic_cache.values()]
            check(widths and max(widths) == 1,
                  f"(h) generic variants per skeleton: {widths}")
        elif key == "storage.verify_checksums":
            check(v.store.verify_checksums is False,
                  "(h) verify_checksums did not reach the store")
        out["keys"][key] = {"ms": ms}
        log(f"[durable] (h) {DUR_KEYS[key]}: Q1 / Q3 / Q5 {ms['q1']:.1f} / "
            f"{ms['q3']:.1f} / {ms['q5']:.1f} ms (five sessions side by "
            "side), equal to the defaults")
    del runs, base
    log(f"[durable] (h) the five key sessions: {out['keys_ms']:.1f} ms")
    out["s"] = time.perf_counter() - t_part
    log(f"[durable] (h) the configuration keys: {out['s']:.1f} s")
    return out


def _expand_under_load(kit, counted, raw, gpu, seed=SEED,
                       clients=DUR_CLIENTS) -> dict:
    """Phase 17 (g): a 4-segment ``Server`` over phase 3's SF1 tables in
    RAM, ``clients`` clients sending Q1, Q3, Q5 and point lookups (the
    lookups' order keys drawn with ``seed``), while the server's session
    expands online to 8 segments and then shrinks to 7 by failover; every
    answer against the static 4-segment run's."""
    import threading

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.serve import Client, Server, ServerError
    from cloudberry_tpu_torch.serve.server import _json_safe
    from cloudberry_tpu_torch.utils import faultinject as FI

    start, grown, failed = DUR_WIRE
    names = ["region", "nation", "supplier", "customer", "orders",
             "lineitem"]
    s = ct.Session(ct.Config(n_segments=start).with_overrides(**{
        "resource.query_mem_bytes": CARD_BUDGET,
        "resource.total_mem_bytes": 64 << 30, "health.retries": 4,
        "health.backoff_s": 0.01, "health.backoff_max_s": 0.05,
        "topology.promote_after": 2}))
    copy_tables(gpu, s, names)
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.unique(raw["lineitem"]["l_orderkey"]),
                      DUR_POINT_KEYS, replace=False)
    texts = [tpch.QUERIES[q] for q in ("q1", "q3", "q5")] + [
        SERVE_POINT.format(int(k)) for k in keys]

    def wire_rows(result):
        arrays = list(result.decoded_columns().values())
        n = len(arrays[0]) if arrays else 0
        return [[_json_safe(a[i]) for a in arrays] for i in range(n)]

    # the static run: each text once on the 4-segment session
    static, _ = counted(lambda: {q: wire_rows(s.sql(q)) for q in texts})
    answers: list = []
    lock = threading.Lock()
    errors: list = []
    stop = threading.Event()

    def epoch_of():
        cur = s._topology.current
        return cur.epoch_id, cur.nseg

    def client(srv, wid):
        try:
            with Client(srv.host, srv.port, timeout=DUR_TIMEOUT) as c:
                i = wid
                while not stop.is_set():
                    q = texts[i % len(texts)]
                    i += 1
                    before = epoch_of()
                    try:
                        got = c.sql(q)
                    except ServerError as e:
                        if getattr(e, "retryable", False):
                            continue
                        raise
                    with lock:
                        answers.append((q, got.get("rows"), before,
                                        epoch_of()))
        except Exception as e:  # noqa: BLE001 — checked below
            errors.append(f"{type(e).__name__}: {e}")

    def answers_after(n, what):
        deadline = time.perf_counter() + DUR_TIMEOUT
        with lock:
            target = len(answers) + n
        while time.perf_counter() < deadline and not errors:
            with lock:
                if len(answers) >= target:
                    return
            time.sleep(0.01)
        check(False, f"(g) no {n} answers {what}: {errors[:3]}")

    def load():
        rec = {}
        with Server(session=s) as srv:
            ths = [threading.Thread(target=client, args=(srv, i))
                   for i in range(clients)]
            for th in ths:
                th.start()
            try:
                answers_after(DUR_ANSWERS, f"at {start} segments")
                rec["expand"] = s._topology.online_resize(grown)
                check(rec["expand"]["nseg"] == grown,
                      f"(g) online_resize: {rec['expand']}")
                answers_after(DUR_ANSWERS, f"at {grown} segments")
                t0 = time.perf_counter()
                FI.inject_fault("probe_degraded", "skip", end_hit=1 << 30)
                FI.inject_fault("exec_device_lost", "error", start_hit=1,
                                end_hit=2)
                deadline = time.perf_counter() + DUR_TIMEOUT
                while time.perf_counter() < deadline and \
                        s._topology.snapshot()["reason"] != "failover":
                    time.sleep(0.01)
                FI.reset_fault()
                rec["failover_s"] = time.perf_counter() - t0
                rec["failover"] = s._topology.snapshot()
                answers_after(DUR_ANSWERS, f"at {failed} segments")
            finally:
                stop.set()
                for th in ths:
                    th.join(timeout=DUR_TIMEOUT)
                FI.reset_fault()
        return rec

    rec, ms = counted(load)
    check(not errors, f"(g) dropped or failed requests: {errors[:3]}")
    snap = rec["failover"]
    check(snap["reason"] == "failover" and snap["nseg"] == failed,
          f"(g) the failover shrink: {snap['reason']} at {snap['nseg']}")
    bad = [(q, rows, before, after) for q, rows, before, after in answers
           if rows != static[q]]
    for q, rows, before, after in bad[:4]:
        # where a wrong answer ran: the (epoch, segments) the topology
        # held when the request was sent and when it was answered, and
        # the rows it has that the static run has not, and the reverse
        want, rows = static[q], rows or []
        log(f"[durable] (g) differing answer to {q[:60]!r}: sent at "
            f"(epoch, nseg) {before}, answered at {after}; {len(rows)} "
            f"rows against {len(want)}; extra "
            f"{[r for r in rows if r not in want][:5]}; missing "
            f"{[r for r in want if r not in rows][:5]}")
    check(not bad, f"(g) {len(bad)} answers differ from the static "
          f"{start}-segment run: {[b[0][:40] for b in bad[:3]]}, at "
          f"(epoch, nseg) {[b[2:] for b in bad[:3]]}")
    reb = rec["expand"]["rebalance"]
    flips = s.stmt_log.counter("epoch_flips")
    out = {"answers": len(answers), "ms": ms,
           "cutover_ms": rec["expand"]["cutover_ms"],
           "moved_rows": reb["moved_rows"], "total_rows": reb["total_rows"],
           "minimal_bound": reb["minimal_bound"],
           "moved_fraction": reb["moved_rows"] / max(reb["total_rows"], 1),
           "failover_s": rec["failover_s"], "epoch_flips": flips,
           "promotions": s.stmt_log.counter("topo_promotions"),
           "recoveries": s.stmt_log.counter("recoveries")}
    check(flips >= 2 and out["promotions"] >= 1,
          f"(g) flips {flips}, promotions {out['promotions']}")
    log(f"[durable] (g) {clients} wire clients over a {start}-segment "
        f"server in RAM: {len(answers)} answers, none dropped, each equal "
        f"to the static run; online_resize({grown}) cut over in "
        f"{out['cutover_ms']:.2f} ms moving {reb['moved_rows']} of "
        f"{reb['total_rows']} rows ({out['moved_fraction']:.4f}, bound "
        f"{reb['minimal_bound']:.4f}); the failover shrink to {failed} "
        f"{out['failover_s']:.2f} s after the fault; {ms / 1e3:.1f} s")
    return out


LOAD_LOOP_CLIENTS = (8, 4, 16)   # expand_load_loop: clients, by run


def expand_load_loop(runs: int = 24, sf: float = 1.0) -> dict:
    """Phase 17 (g)'s load ``runs`` times on the card (ROADMAP C 59),
    outside the script's phases: TPC-H at ``sf`` (seed SEED) in a CUDA
    session, then ``_expand_under_load`` again and again, the client
    count cycling through LOAD_LOOP_CLIENTS and the point lookups' keys
    drawn with seed SEED + run. A run whose answers differ logs them (the
    (epoch, segment count) at send and at answer, the rows each side
    lacks) and counts as failed; the loop goes on. Writes the runs to
    chiprun_out/expand_load_loop.json and returns them. Run it with
    ``python3 -c "import chip_smoke as c; c.expand_load_loop()"``."""
    import torch

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.exec import cuda_kernels as CK

    check(torch.cuda.is_available(), "expand_load_loop needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[loop] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    t0 = time.perf_counter()
    CK.build()
    raw = tpch.generate(sf, SEED)
    names = ["region", "nation", "supplier", "customer", "orders",
             "lineitem"]
    gpu = ct.Session(ct.Config().with_overrides(
        **{"resource.query_mem_bytes": CARD_BUDGET}))
    tpch.load_tables(gpu, tpch.SCHEMAS, tpch.DIST_KEYS, raw, names)
    out = {"device": smi, "sf": sf, "setup_s": time.perf_counter() - t0,
           "runs": []}

    def counted(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    for i in range(runs):
        clients = LOAD_LOOP_CLIENTS[i % len(LOAD_LOOP_CLIENTS)]
        rec = {"run": i, "clients": clients, "seed": SEED + i}
        t = time.perf_counter()
        try:
            rec.update(_expand_under_load(None, counted, raw, gpu,
                                          seed=SEED + i, clients=clients))
            rec["ok"] = True
        except AssertionError as e:
            rec.update(ok=False, error=str(e)[:2000])
            log(f"[loop] run {i} failed: {str(e)[:400]}")
        rec["s"] = time.perf_counter() - t
        out["runs"].append(rec)
        gc.collect()
        torch.cuda.empty_cache()
    out["failed"] = [r["run"] for r in out["runs"] if not r["ok"]]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "expand_load_loop.json"),
              "w") as f:
        json.dump(out, f, indent=1, default=str)
    log(f"[loop] {runs} runs, failed {out['failed']}, answers "
        f"{sum(r.get('answers', 0) for r in out['runs'])}, "
        f"{sum(r['s'] for r in out['runs']):.1f} s")
    return out


# ------------------------------------------ 18. two-level and ring motion


HM_RING4 = ("q3", "q9")                 # (a)'s chunked ring texts
HM_ON2 = ("q1", "q3", "q5", "q9", "q18")  # (c): 2 hosts of 4, "on"


def identical(got: dict, want: dict, what: str) -> None:
    """Bit-for-bit equality of two ``with_nulls`` results: the same
    columns, NULL masks and values, floats by their bits."""
    check(list(got) == list(want), f"{what}: columns {list(got)} vs "
          f"{list(want)}")
    for k, (w, wv) in want.items():
        g, gv = got[k]
        ok = g.shape == w.shape and np.array_equal(gv, wv)
        if ok and (w.dtype == object or g.dtype == object):
            ok = g.tolist() == w.tolist()
        elif ok:
            ok = g.dtype == w.dtype and np.array_equal(
                np.ascontiguousarray(g).view(np.uint8),
                np.ascontiguousarray(w).view(np.uint8))
        check(ok, f"{what}: column {k} differs:\n got  {g[:10]}\n want "
              f"{w[:10]}")


class ForcedHosts:
    """``CBTPU_FORCE_HOSTS`` set to ``n`` (a simulated host split) for a
    block, restored after. Plans read it, so a session plans under it."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        self.old = os.environ.get("CBTPU_FORCE_HOSTS")
        os.environ["CBTPU_FORCE_HOSTS"] = str(self.n)
        return self

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("CBTPU_FORCE_HOSTS", None)
        else:
            os.environ["CBTPU_FORCE_HOSTS"] = self.old


def skew_join_session(cfg, n):
    """Phase 12's skewed redistribute: ``n`` probe rows, 75 % on one key
    behind a projection (the join cannot size its bucket exactly). Returns
    (session, sql, numpy's answer)."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch.catalog import carry
    from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy

    F = carry.field
    rng = np.random.default_rng(SEED)
    hot = np.where(np.arange(n) < (3 * n) // 4, 0, np.arange(n))
    s = ct.Session(cfg.with_overrides(**{
        "planner.broadcast_threshold": 0,
        "planner.runtime_filter_threshold": 0}))
    carry.load_encoded(s, "j1", [F("a", "int64", 0, False),
                                 F("key", "int64", 0, False)],
                       {"a": np.arange(n), "key": hot.astype(np.int64)},
                       policy=DistributionPolicy.hashed("a"))
    w = rng.integers(0, 1000, n).astype(np.int64)
    carry.load_encoded(s, "j2", [F("b", "int64", 0, False),
                                 F("key", "int64", 0, False),
                                 F("w", "int64", 0, False)],
                       {"b": np.arange(n), "key": np.arange(n), "w": w},
                       policy=DistributionPolicy.hashed("b"))
    sql = ("select sum(j2.w) as sw from (select key as kk from j1) x "
           "join j2 on kk = j2.key")
    return s, sql, int(w[0]) * ((3 * n) // 4) + int(w[(3 * n) // 4:].sum())


def hier_motion_phase(kit, raw, gpu, flat8, flat_ms, args) -> dict:
    """The ring and two-level motion at 8 segments (module docstring,
    phase 18): every result against phase 12's flat 8-segment run, bit
    for bit."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.exec import dist_executor as DX
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.parallel import transport as TT
    from cloudberry_tpu_torch.plan import mutate as M
    from cloudberry_tpu_torch.plan import nodes as N
    from cloudberry_tpu_torch.plan.planner import plan_statement
    from cloudberry_tpu_torch.plan.verify import verify_plan
    from cloudberry_tpu_torch.sql.parser import parse_sql
    from cloudberry_tpu_torch.types import date_to_days as D

    torch = kit.torch
    out = {}
    t_phase = time.perf_counter()
    all8 = list(tpch.SCHEMAS)
    seg8 = gpu.config.with_overrides(n_segments=DIST_NSEG)
    # the host tables every session of the phase copies (phase 3 loaded
    # six of the eight; this session never runs a statement)
    base = ct.Session(seg8)
    have = [n for n in all8 if n in gpu.catalog.tables]
    copy_tables(gpu, base, have)
    tpch.load_tables(base, tpch.SCHEMAS, tpch.DIST_KEYS, raw,
                     [n for n in all8 if n not in have])
    texts = sorted(tpch.QUERIES, key=lambda q: int(q[1:]))
    made, plans = [], []
    real_make, real_record = TT.make_transport, DX.record_motion_stats

    def spy_make(*a, **kw):
        tx = real_make(*a, **kw)
        made.append(tx)
        return tx

    def spy_record(plan, stats, session=None):
        plans.append(plan)
        return real_record(plan, stats, session=session)

    def motions(plan):
        return X._dedupe_nodes(m for m in X.all_nodes(plan)
                               if isinstance(m, N.PMotion)
                               and m.kind == "redistribute")

    mem = {}

    def session(part, **over):
        """A fresh session for ``part`` over the eight tables, after the
        last part's sessions are collected (each holds its own device
        shards); the device bytes in use at its start are recorded."""
        gc.collect()
        torch.cuda.empty_cache()
        mem[part] = int(torch.cuda.memory_allocated())
        s = ct.Session(seg8.with_overrides(**over))
        copy_tables(base, s, all8)
        return s

    def run_texts(s, qs, label):
        """Each text: a run with every kernel call held against its plain
        version, then a counted run; both equal to phase 12's flat run bit
        for bit. Per text: the wall against the flat wall, the launches,
        the transport's permutations and the motions' stamps."""
        recs = {}
        for q in qs:
            sql = tpch.QUERIES[q]
            forget_feedback(s)
            held = kit.held(f"{label} {q}", lambda: s.sql(sql))
            identical(with_nulls(held), flat8[q],
                      f"{label} {q} (held run) vs the flat run")
            del made[:], plans[:]
            base_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res, ms, counts = kit.counted_run(s, sql)
            peak = torch.cuda.max_memory_allocated() - base_bytes
            identical(with_nulls(res), flat8[q],
                      f"{label} {q} vs the flat 8-segment run")
            tx = made[-1]
            red = motions(plans[-1]) if plans else []
            recs[q] = {
                "ms": round(ms, 3), "flat_ms": flat_ms.get(q),
                "peak_bytes": int(peak),
                "launches": counts, "transport": tx.name,
                "permutations": getattr(tx, "launches", None),
                "redistributes": len(red),
                "stamped": sum(m.hier_hosts > 0 for m in red),
                "host_combined": sum(bool(m.host_combine) for m in red),
                "host_rungs": [(int(m.host_bucket_cap),
                                getattr(m, "_observed_host_bucket", None))
                               for m in red if m.hier_hosts > 0]}
        return recs

    TT.make_transport, DX.record_motion_stats = spy_make, spy_record
    try:
        # (a) the ring, whole-block over the 22 texts, chunked on two
        t0 = time.perf_counter()
        s = session("ring", **{"interconnect.backend": "ring"})
        out["ring"] = run_texts(s, texts, "ring")
        check(all(r["transport"] == "ring" for r in out["ring"].values()),
              "(a) a text did not run on the ring transport")
        del s
        s = session("ring4", **{"interconnect.backend": "ring",
                                "interconnect.ring_chunks": 4})
        out["ring4"] = run_texts(s, HM_RING4, "ring, 4 chunks")
        del s
        out["ring_s"] = time.perf_counter() - t0
        log(f"[hier] (a) ring: the {len(texts)} texts and "
            f"{'/'.join(HM_RING4)} with 4 chunks equal the flat run bit "
            f"for bit; " + ", ".join(
                f"{q} {r['ms']:.1f} ms (flat {r['flat_ms']})"
                for q, r in out["ring"].items())
            + f"; {out['ring_s']:.1f} s")

        # (b) two levels at the default "auto" gate, 4 hosts of 2, the
        # verify gate on (f)
        t0 = time.perf_counter()
        with ForcedHosts(4):
            s = session("auto4", **{"debug.verify_plans": True})
            out["auto4"] = run_texts(s, texts, "4 hosts, auto")
            for q, r in out["auto4"].items():
                log(f"[hier] (b) {q}: {r['stamped']} of "
                    f"{r['redistributes']} redistributes stamped, "
                    f"{r['host_combined']} host-combined, host rungs "
                    f"(cap, observed) {r['host_rungs']}, {r['permutations']}"
                    f" permutations, {r['ms']:.1f} ms against flat "
                    f"{r['flat_ms']} ms, peak {r['peak_bytes']} B, launches "
                    f"{r['launches']}")
            check(all(r["transport"] == "hier"
                      for r in out["auto4"].values()),
                  "(b) a text did not run on the two-level transport")
            stamped = sum(r["stamped"] for r in out["auto4"].values())
            combined = sum(r["host_combined"]
                           for r in out["auto4"].values())
            check(stamped >= 1, "(b) no SF1 redistribute cleared the "
                  "auto gate")
            check(combined >= 1, "(b) no merge motion was host-combined")
            # (f) the three two-level mutation classes on this card's plan
            out["mutations"] = {}
            for name in ("hier-wrong-host-grouping",
                         "hier-inter-buffer-undersize",
                         "hier-combine-forged"):
                sql, fn, expected = M.MUTATIONS[name]
                plan = plan_statement(parse_sql(sql), s, {}).plan
                check(verify_plan(plan, s) == [],
                      f"(f) {name}: the plan is dirty before mutation")
                hit = fn(plan, s)
                check(hit is not None, f"(f) {name}: no target")
                rules = sorted({f.rule for f in verify_plan(hit[0], s)})
                check(bool(set(rules) & expected),
                      f"(f) {name}: rules {rules}, want {set(expected)}")
                out["mutations"][name] = rules
            del s
        out["auto4_s"] = time.perf_counter() - t0
        log(f"[hier] (b) 4 hosts, auto: the {len(texts)} texts equal the "
            f"flat run bit for bit under the verify gate (no finding); "
            f"{stamped} redistributes stamped, {combined} host-combined; "
            f"(f) mutations caught: {out['mutations']}; "
            f"{out['auto4_s']:.1f} s")

        # (c) two levels forced on, 2 hosts of 4
        t0 = time.perf_counter()
        with ForcedHosts(2):
            s = session("on2", **{"interconnect.hierarchical": "on"})
            out["on2"] = run_texts(s, HM_ON2, "2 hosts, on")
            del s
        out["on2_s"] = time.perf_counter() - t0
        log(f"[hier] (c) 2 hosts, on: " + ", ".join(
            f"{q} {r['stamped']}/{r['redistributes']} stamped, "
            f"{r['host_combined']} combined, {r['ms']:.1f} ms"
            for q, r in out["on2"].items())
            + f"; equal to the flat run; {out['on2_s']:.1f} s")

        # (d) skew and the host rung, on phase 12's skewed redistribute
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        mem["skew"] = int(torch.cuda.memory_allocated())
        with ForcedHosts(4):
            s, sql, want = skew_join_session(
                seg8.with_overrides(**{"interconnect.hierarchical": "on"}),
                DIST_SKEW_ROWS)
            res, ms, counts = kit.counted_run(s, sql)
            check(physical(res)["sw"].tolist() == [want],
                  f"(d) skewed redistribute: {physical(res)} against "
                  f"numpy {want}")
            hsk = s.counters.counter("host_skew_events")
            check(hsk >= 1, "(d) the skewed redistribute recorded no "
                  "host_skew_events")
            out["skew"] = {"host_skew_events": hsk,
                           "growth_events": s.growth_events, "ms": ms,
                           "launches": counts}
            # its largest uncombined two-level motion, host rung forced to
            # 8 rows: a detected overflow naming the motion, one growth to
            # the observed demand's rung, then the flat run's answer
            plan = plan_statement(parse_sql(sql), s, {}).plan
            plain = [m for m in motions(plan)
                     if m.hier_hosts > 0 and not m.host_combine]
            check(bool(plain), "(d) no uncombined two-level redistribute")
            m = max(plain, key=lambda n: n.bucket_cap)
            m.host_bucket_cap = 8
            try:
                DX.execute_distributed(plan, s)
                check(False, "(d) an 8-row host rung did not overflow")
            except X.ExecError as e:
                msg = str(e)
            check("host bucket overflow" in msg
                  and f"(node {id(m)})" in msg,
                  f"(d) the overflow names another node: {msg}")
            observed = int(m._observed_host_bucket)
            check(X.grow_expansion(plan, msg), "(d) no growth")
            res, ms, counts = kit.counted(
                lambda: DX.execute_distributed(plan, s))
            check(physical(res)["sw"].tolist() == [want],
                  f"(d) after the host rung's growth: {physical(res)} "
                  f"against numpy {want}")
            out["host_rung"] = {"observed": observed,
                                "grown_to": int(m.host_bucket_cap),
                                "ms": ms, "launches": counts}
            del s
        out["skew_s"] = time.perf_counter() - t0
        log(f"[hier] (d) the skewed redistribute under 4 hosts: "
            f"host_skew_events {out['skew']['host_skew_events']}, "
            f"{out['skew']['growth_events']} growth(s), equal to numpy; "
            f"its host rung forced to 8 overflowed, observed {observed} "
            f"rows, grew to {out['host_rung']['grown_to']} and re-ran "
            f"equal to numpy; {out['skew_s']:.1f} s")

        # (e) tiled Q3 at phase 13's budget under 4 hosts
        t0 = time.perf_counter()
        m_q3 = TD_TPCH["q3"][0]
        budget = (m_q3 << 20) if args.sf == 1.0 else max(
            max(int(m_q3 * args.sf), 1) << 20,
            max(int(TD_TPCH_QUICK["q3"] * args.sf / 0.05), 1) << 20)
        with ForcedHosts(4):
            s = session("tiled", **{"debug.verify_plans": True,
                                    "resource.query_mem_bytes": budget})
            sql = tpch.QUERIES["q3"]
            held = kit.held("tiled q3, 4 hosts", lambda: s.sql(sql))
            del made[:]
            res, ms, counts = kit.counted_run(s, sql)
            rep = s.last_tiled_report or {}
            check(rep.get("tiled") and rep.get("distributed"),
                  f"(e) Q3 at {budget >> 20} MiB did not tile: {rep}")
            for r in (held, res):
                identical(with_nulls(r), flat8["q3"],
                          "(e) tiled Q3 under 4 hosts vs the flat run")
            same(physical(res), oracle(raw, "q3", D),
                 "(e) tiled Q3 under 4 hosts vs the numpy oracle")
            hier = [t for t in made if t.name == "hier"]
            check(bool(hier), "(e) the tiled runner is not two-level")
            out["tiled_q3"] = {"budget_mib": budget >> 20, "ms": ms,
                               "tiles": rep.get("n_tiles"),
                               "permutations": sum(t.launches
                                                   for t in hier),
                               "launches": counts}
            del s
        out["tiled_s"] = time.perf_counter() - t0
        log(f"[hier] (e) tiled Q3 at {budget >> 20} MiB under 4 hosts: "
            f"{out['tiled_q3']['tiles']} tiles, "
            f"{out['tiled_q3']['permutations']} permutations, "
            f"{ms:.1f} ms, equal to the flat run and the numpy oracle; "
            f"{out['tiled_s']:.1f} s")
    finally:
        TT.make_transport, DX.record_motion_stats = real_make, real_record
    out["device_bytes_at_start"] = mem
    log(f"[hier] device bytes allocated at each part's start: {mem}")
    out["s"] = time.perf_counter() - t_phase
    return out


# the two-process cluster: each child process owns 4 of the 8 segments
CLUSTER_PROCS = 2
CLUSTER_TEXTS = ("q1", "q3", "q5", "q9", "q18")   # phase 18 (c)'s set
CLUSTER_TIMEOUT_S = 600
CLUSTER_LOCAL_SLOTS = 4                 # each child's segment slots
CLUSTER_TILED = ("q1", "q3")            # (b), at phase 13's budgets
CLUSTER_SURVIVORS = [0, 1, 2, 4, 5, 6, 7]   # (c): slot 3 lost, 3 + 4
CLUSTER_DEGRADED = ("q1", "q3", "q5")   # (c)'s texts
CLUSTER_RESIZE = (6, 8)                 # (d): 4 + 2 -> 4 + 4, Q5
# (e): phase 9's store as a 6-segment cluster (4 + 2), resized to 8
CLUSTER_STORE = ("q1", "q3", "q5")
CLUSTER_STORE_CFG = {"planner.autostats": "none",
                     "bufferpool.max_bytes": 4 << 30}
CLUSTER_INSERT = (
    "INSERT INTO orders VALUES "
    "(6000001, 1, 'O', 100.25, date '1998-08-02', '1-URGENT', "
    "'Clerk#000000001', 0, 'smoke one'), "
    "(6000002, 2, 'O', 200.50, date '1998-08-02', '2-HIGH', "
    "'Clerk#000000002', 0, 'smoke two'), "
    "(6000003, 3, 'F', 300.75, date '1998-08-02', '5-LOW', "
    "'Clerk#000000003', 0, 'smoke three')")
CLUSTER_INSERTED = 3
STORE_GATE = "store_ready"   # written beside DATA once (e)'s oracle is read
# a few hundred orders after Q3's and Q5's date windows (Q1 reads
# lineitem alone): their answers stay those of (e)'s first reads
CLUSTER_DELETED = ("o_orderdate >= date '1998-07-20' AND "
                   "o_orderkey % 25 = 0")
# tests/multihost_worker.py's statements and tables (seed 11)
MULTIHOST_QUERIES = {
    "mh_agg": ("SELECT g, sum(v) AS sv, count(*) AS c FROM fact "
               "JOIN dim ON fact.k = dim.k GROUP BY g ORDER BY g"),
    "mh_count": ("SELECT count(*) AS n FROM fact JOIN dim ON fact.k = "
                 "dim.k WHERE g < 3"),
    "mh_topn": "SELECT k, v FROM fact ORDER BY v DESC, k LIMIT 7",
}


def multihost_load(session) -> None:
    """tests/multihost_worker.py's two tables, from its generator."""
    rng = np.random.default_rng(11)
    session.sql("CREATE TABLE dim (k BIGINT, g BIGINT) DISTRIBUTED BY (k)")
    session.sql("CREATE TABLE fact (k BIGINT, v BIGINT) DISTRIBUTED BY (k)")
    session.catalog.table("dim").set_data(
        {"k": np.arange(400), "g": np.arange(400) % 6})
    session.catalog.table("fact").set_data(
        {"k": rng.integers(0, 400, 20_000),
         "v": rng.integers(0, 1000, 20_000)})


def holding_kernels(torch, CK, held: dict):
    """A context in which every kernel call also runs the kernel and its
    plain version on the same inputs (a probe join on fresh flag slots)
    and must agree: integer outputs exactly, float outputs within 1e-9
    of the largest magnitude, as phase 20 holds them; ``held`` counts the
    calls per kernel."""
    import contextlib

    originals = {k: getattr(CK, k) for k in CK.LAUNCHES}
    plains = {"dense_agg": CK.dense_agg_plain,
              "probe_join": CK.probe_join_plain,
              "sorted_seg": CK.sorted_seg_plain}

    def outputs(name, fn, a):
        if name != "probe_join":
            return fn(*a)
        dev = next(x for x in a if torch.is_tensor(x)).device
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        matched, out = fn(*a[:5], flag)
        return (matched, *out, flag)

    def wrap(name):
        def wrapped(*a):
            out = originals[name](*a)
            got = outputs(name, originals[name], a)
            want = outputs(name, plains[name], a)
            for g, w in zip(got, want):
                err = max_abs_err(torch, [g], [w])
                tol = 1e-9 * max(1.0, float(w.abs().max())) \
                    if w.dtype.is_floating_point and w.numel() else 0.0
                check(err <= tol, f"{name}: the kernel differs from its "
                      f"plain version on a main-path input (max abs err "
                      f"{err}, tolerance {tol})")
            held[name] += 1
            return out
        return wrapped

    @contextlib.contextmanager
    def ctx():
        for k in originals:
            setattr(CK, k, wrap(k))
        try:
            yield held
        finally:
            for k, fn in originals.items():
                setattr(CK, k, fn)
    return ctx()


def cluster_store_oracle(kit, cfg, root) -> dict:
    """Phase 19 (e)'s oracle in this process: CLUSTER_STORE over
    ``root``'s store at 6 segments (results and counted walls) and the
    orders counts before the DML."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch

    one = ct.Session(cfg.with_overrides(
        n_segments=CLUSTER_RESIZE[0],
        **{"storage.root": root, **CLUSTER_STORE_CFG}), device=kit.device)
    want = {"results": {}, "ms": {}}
    for q in CLUSTER_STORE:
        forget_feedback(one)
        one.sql(tpch.QUERIES[q])
        empty_caches(one)
        res, ms, _ = kit.counted_run(one, tpch.QUERIES[q])
        want["results"][q] = with_nulls(res)
        want["ms"][q] = ms
    for key, where in (("orders", ""),
                       ("deleted", f" WHERE {CLUSTER_DELETED}")):
        want[key] = int(one.sql(f"SELECT count(*) AS n FROM orders{where}")
                        .decoded_columns()["n"][0])
    return want


def cluster_store_child(cfg, root, device, counted) -> dict:
    """Phase 19 (e) in one child: ``root``'s store as a 6-segment cluster
    (4 + 2). (a) CLUSTER_STORE from the store, each once to warm up with
    every kernel call held against its plain version, then counted; (b)
    CLUSTER_INSERT and the DELETE of CLUSTER_DELETED orders, each
    statement's status, seconds and manifest versions added, the orders
    counted before and after; (c) ``online_resize(8)``, its seconds and
    counts, then (a)'s texts again. ``counted(session, sql)``: the
    child's counted run."""
    import torch

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.exec import cuda_kernels as CK
    from cloudberry_tpu_torch.parallel import mesh
    from cloudberry_tpu_torch.storage.table_store import TableStore

    cuda = device == "cuda"
    t_part = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    s = ct.Session(cfg.with_overrides(
        n_segments=CLUSTER_RESIZE[0],
        **{"storage.root": root, **CLUSTER_STORE_CFG}), device=device)
    store = TableStore(root)
    out = {"held": {k: 0 for k in CK.LAUNCHES},
           "local": list(mesh.session_segments(s))}

    def reads(tag):
        got = out[tag] = {}
        for q in CLUSTER_STORE:
            sql = tpch.QUERIES[q]
            forget_feedback(s)
            t0 = time.perf_counter()
            if tag == "a":
                with holding_kernels(torch, CK, out["held"]):
                    s.sql(sql)
            else:
                s.sql(sql)
            warm_ms = (time.perf_counter() - t0) * 1e3
            empty_caches(s)
            res, ms, counts, _, nbytes = counted(s, sql)
            got[q] = {"result": with_nulls(res), "ms": ms,
                      "warm_ms": warm_ms, "launches": counts,
                      "dist_bytes": nbytes}
            print(f"[cluster child {mesh.process_index()}] (e{tag}) {q} "
                  f"from the store: {ms:.1f} ms (first {warm_ms:.1f} ms), "
                  f"launches {counts}", flush=True)

    def count(where=""):
        b = s.sql(f"SELECT count(*) AS n FROM orders{where}")
        return int(b.decoded_columns()["n"][0])

    reads("a")
    dml = out["b"] = {"orders_before": count(),
                      "deleted_match": count(f" WHERE {CLUSTER_DELETED}"),
                      "statements": []}
    for sql in (CLUSTER_INSERT, f"DELETE FROM orders WHERE "
                f"{CLUSTER_DELETED}"):
        v0 = store.current_version("orders")
        t0 = time.perf_counter()
        status = str(s.sql(sql))
        dml["statements"].append({
            "status": status, "s": time.perf_counter() - t0,
            "added": store.current_version("orders") - v0})
    dml["orders_after"] = count()
    t0 = time.perf_counter()
    rz = s._topology.online_resize(CLUSTER_RESIZE[1])
    out["c_resize"] = {"s": time.perf_counter() - t0,
                       "epoch": rz["epoch"], "reason": rz["reason"],
                       "rebalance": rz["rebalance"],
                       "local": list(mesh.session_segments(s))}
    print(f"[cluster child {mesh.process_index()}] (ec) online_resize("
          f"{CLUSTER_RESIZE[1]}) over the store in "
          f"{out['c_resize']['s']:.2f} s: {rz['rebalance']}", flush=True)
    reads("c")
    out["peak_bytes"] = int(torch.cuda.max_memory_allocated()) if cuda \
        else 0
    out["s"] = time.perf_counter() - t_part
    return out


def cluster_child(argv) -> int:
    """One process of phase 19's cluster (``chip_smoke.py
    --cluster-child DATA OUT DEVICE ROOT``): join through ``init_distributed``
    (CBTPU_* environment), load the TPC-H tables the parent pickled to
    DATA, and run the multi-host statements and CLUSTER_TEXTS at 8
    segments flat and at ``hierarchical="on"`` (one session, its config
    swapped between the two, which the statement cache keys on); each
    text after its feedback store is emptied, once to warm up and once
    counted (the statement cache emptied first); then parts (a)-(d) and,
    unless ROOT is "-", (e) over the store at ROOT
    (``cluster_store_child``). Writes the results,
    walls, launches, the bytes handed to torch.distributed per
    redistribute, per-text peak device bytes and the child's seconds to
    OUT (pickle)."""
    import pickle

    import torch

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.catalog import carry
    from cloudberry_tpu_torch.catalog.catalog import DistributionPolicy
    from cloudberry_tpu_torch.exec import cuda_kernels as CK
    from cloudberry_tpu_torch.parallel import mesh
    from cloudberry_tpu_torch.parallel import transport as TT

    data, out_path, device, root = argv
    t_start = time.perf_counter()
    mesh.init_distributed()         # CBTPU_LOCAL_SLOTS: 4 slots each
    rank = mesh.process_index()
    cuda = device == "cuda"
    if cuda:
        CK.build()
    with open(data, "rb") as f:
        enc = pickle.load(f)
    budget = enc.pop("$budget")
    td = enc.pop("$tiled")
    cfg = ct.Config().with_overrides(**{
        "n_segments": DIST_NSEG, "resource.query_mem_bytes": budget})
    made = []
    real_make = TT.make_transport

    def spy(*a, **kw):
        made.append(real_make(*a, **kw))
        return made[-1]
    TT.make_transport = spy

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def counted(s, sql):
        sync()
        for k in CK.LAUNCHES:
            CK.LAUNCHES[k] = 0
        del made[:]
        t0 = time.perf_counter()
        res = s.sql(sql)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        return res, ms, dict(CK.LAUNCHES), [
            e for tx in made for e in tx.exchanges], sum(
            tx.total_dist_bytes for tx in made)

    out = {"rank": rank, "procs": mesh.process_count(),
           "topology": mesh.mesh_topology(DIST_NSEG),
           "local": list(mesh.local_segments(DIST_NSEG)), "texts": {},
           "seconds": {"start": time.perf_counter() - t_start}}
    peak = 0

    def load_tpch(session):
        for name, schema in tpch.SCHEMAS.items():
            keys = tpch.DIST_KEYS[name]
            cols, dicts, (unique, ndv) = enc[name]
            t = carry.load_encoded(
                session, name, schema.fields, cols, None, dicts,
                DistributionPolicy.replicated() if keys is None
                else DistributionPolicy.hashed(*keys))
            # the parent's uniqueness flags and distinct counts of the
            # same values (``copy_tables``)
            t.stats.unique, t.stats.ndv = unique, ndv

    s = ct.Session(cfg, device=device)
    load_tpch(s)
    multihost_load(s)
    texts = {**MULTIHOST_QUERIES,
             **{q: tpch.QUERIES[q] for q in CLUSTER_TEXTS}}
    for mode in ("off", "on"):
        t_mode = time.perf_counter()
        s.config = cfg.with_overrides(**{"interconnect.hierarchical": mode})
        empty_caches(s)
        for q, sql in texts.items():
            forget_feedback(s)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            warm = s.sql(sql)
            empty_caches(s)
            res, ms, counts, exchanges, nbytes = counted(s, sql)
            text_peak = int(torch.cuda.max_memory_allocated()) if cuda \
                else 0
            peak = max(peak, text_peak)
            out["texts"][(mode, q)] = {
                "warm": with_nulls(warm), "result": with_nulls(res),
                "ms": ms, "launches": counts, "exchanges": exchanges,
                "dist_bytes": nbytes, "peak_bytes": text_peak}
            print(f"[cluster child {rank}] {mode} {q}: {ms:.1f} ms, "
                  f"launches {counts}, {nbytes} bytes to "
                  f"torch.distributed, peak {text_peak} B", flush=True)
        out["seconds"][mode] = time.perf_counter() - t_mode

    # (a)-(d), flat, one counted run per text
    flat = cfg.with_overrides(**{"interconnect.hierarchical": "off"})
    parts = out["parts"] = {}

    def part(name, session, sqls, over=None):
        """Counted runs of ``sqls`` ({text: sql}) on ``session``, under
        ``over`` config overrides when given; the part's wall, peak
        device bytes, launches and gloo bytes accumulate."""
        rec = parts.setdefault(name, {"texts": {}, "s": 0.0,
                                      "peak_bytes": 0})
        t_part = time.perf_counter()
        if over is not None:
            session.config = flat.with_overrides(**over)
        empty_caches(session)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        for q, sql in sqls.items():
            forget_feedback(session)
            res, ms, counts, exchanges, nbytes = counted(session, sql)
            rep = session.last_tiled_report
            rec["texts"][q] = {
                "result": with_nulls(res), "ms": ms, "launches": counts,
                "exchanges": exchanges, "dist_bytes": nbytes,
                "shifts": sum(getattr(tx, "launches", 0) for tx in made),
                "tiled": None if rep is None else {
                    k: rep.get(k) for k in ("tiled", "distributed",
                                            "n_segments", "n_tiles",
                                            "tile_rows", "acc_capacity")}}
            print(f"[cluster child {rank}] ({name}) {q}: {ms:.1f} ms, "
                  f"launches {counts}, {nbytes} bytes to "
                  f"torch.distributed", flush=True)
        if cuda:
            rec["peak_bytes"] = max(rec["peak_bytes"], int(
                torch.cuda.max_memory_allocated()))
        rec["s"] += time.perf_counter() - t_part
        return rec

    part("ring", s, texts, {"interconnect.backend": "ring"})
    for q in CLUSTER_TILED:
        part("tiled", s, {q: tpch.QUERIES[q]},
             {"resource.query_mem_bytes": td[q]})
    s.config = flat
    empty_caches(s)
    t0 = time.perf_counter()
    s.degrade_mesh(len(CLUSTER_SURVIVORS), CLUSTER_SURVIVORS)
    degrade_s = time.perf_counter() - t0
    rec = part("degrade", s, {q: tpch.QUERIES[q]
                              for q in CLUSTER_DEGRADED})
    rec["degrade_s"] = degrade_s
    rec["local"] = list(mesh.session_segments(s))
    rec["epoch"] = s._topology.current.epoch_id
    del s
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s6 = ct.Session(flat.with_overrides(n_segments=CLUSTER_RESIZE[0]),
                    device=device)
    load_tpch(s6)
    q5 = {"q5": tpch.QUERIES["q5"]}
    before = part("resize_before", s6, q5)
    before["local"] = list(mesh.session_segments(s6))
    t_resize = time.perf_counter()
    rz = s6._topology.online_resize(CLUSTER_RESIZE[1])
    resize_s = time.perf_counter() - t_resize
    after = part("resize", s6, q5)
    after["local"] = list(mesh.session_segments(s6))
    after.update(epoch=rz["epoch"], reason=rz["reason"],
                 rebalance=rz["rebalance"], resize_s=resize_s,
                 start_s=time.perf_counter() - t0)
    print(f"[cluster child {rank}] (resize) {CLUSTER_RESIZE[0]} -> "
          f"{CLUSTER_RESIZE[1]} in {resize_s:.2f} s: {rz['rebalance']}",
          flush=True)
    del s6
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if root != "-":
        # the parent reads the store for (e)'s oracle meanwhile
        gate = os.path.join(os.path.dirname(data), STORE_GATE)
        deadline = time.monotonic() + CLUSTER_TIMEOUT_S
        while not os.path.exists(gate):
            check(time.monotonic() < deadline, "the parent's store oracle "
                  f"did not finish within {CLUSTER_TIMEOUT_S} s")
            time.sleep(0.1)
        out["store"] = cluster_store_child(flat, root, device, counted)
    out["peak_bytes"] = max([peak] + [r["peak_bytes"]
                                      for r in parts.values()])
    out["s"] = time.perf_counter() - t_start
    with open(out_path + ".part", "wb") as f:
        pickle.dump(out, f, protocol=5)
    os.replace(out_path + ".part", out_path)
    return 0


def cluster_phase(kit, gpu, raw, flat8, flat_ms, flat_launches,
                  sf: float = 1.0, root=None) -> dict:
    """The two-process cluster on the one card (module docstring, phase
    19): two children of 4 segments each, every result equal bit for bit
    across them, between flat and two-level, and to the one-process
    8-segment runs (phase 12's for the TPC-H texts, this process's for
    the multi-host statements), each child launching every kernel the
    one-process run of a text launched; then (a) the ring, (b) tiled Q1
    and Q3 at phase 13's budgets for scale ``sf``, (c) the degrade to
    3 + 4 segments and (d) the online resize 6 -> 8 across the same
    children, each against its one-process counterpart; with ``root``
    (phase 9's store, of which this phase is the last user), (e) that
    store as a 6-segment cluster (``cluster_store_child``) against this
    process's one-process 6-segment run over it."""
    import pickle
    import shutil
    import tempfile

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.parallel import transport as TT

    torch = kit.torch
    out = {"texts": {}}
    t_phase = time.perf_counter()
    # the multi-host statements' one-process 8-segment oracle and walls
    one = ct.Session(gpu.config.with_overrides(n_segments=DIST_NSEG),
                     device=kit.device)
    multihost_load(one)
    want = {q: flat8[q] for q in CLUSTER_TEXTS}
    want_ms = {q: flat_ms[q] for q in CLUSTER_TEXTS}
    want_fired = {q: {k for k, v in flat_launches[q].items() if v}
                  for q in CLUSTER_TEXTS}
    for q, sql in MULTIHOST_QUERIES.items():
        one.sql(sql)
        empty_caches(one)
        res, ms, counts = kit.counted_run(one, sql)
        want[q], want_ms[q] = with_nulls(res), ms
        want_fired[q] = {k for k, v in counts.items() if v}
    del one
    # (c)'s one-process oracle: 8 segments degraded over the same
    # survivors; (d)'s: the static 6-segment Q5
    names = ["region", "nation", "supplier", "customer", "orders",
             "lineitem"]
    t_oracle = time.perf_counter()
    want7 = {}
    d7 = ct.Session(gpu.config.with_overrides(n_segments=DIST_NSEG),
                    device=kit.device)
    copy_tables(gpu, d7, names)
    d7.degrade_mesh(len(CLUSTER_SURVIVORS), CLUSTER_SURVIVORS)
    for q in CLUSTER_DEGRADED:
        forget_feedback(d7)
        want7[q] = with_nulls(d7.sql(tpch.QUERIES[q]))
    del d7
    d6 = ct.Session(gpu.config.with_overrides(
        n_segments=CLUSTER_RESIZE[0]), device=kit.device)
    copy_tables(gpu, d6, names)
    want6 = with_nulls(d6.sql(tpch.QUERIES["q5"]))
    del d6
    out["oracle_s"] = time.perf_counter() - t_oracle
    # the TPC-H tables, encoded, for the children
    base = ct.Session(gpu.config, device="cpu")
    have = [n for n in tpch.SCHEMAS if n in gpu.catalog.tables]
    copy_tables(gpu, base, have)
    tpch.load_tables(base, tpch.SCHEMAS, tpch.DIST_KEYS, raw,
                     [n for n in tpch.SCHEMAS if n not in have])
    enc = {n: (t.data, {c: d.values for c, d in t.dicts.items()},
               (t.stats.unique, t.stats.ndv))
           for n, t in base.catalog.tables.items()}
    enc["$budget"] = gpu.config.resource.query_mem_bytes
    enc["$tiled"] = {q: td_budget(q, sf) for q in CLUSTER_TILED}
    del base
    gc.collect()
    if kit.device == "cuda":
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="cb_cluster_")
    procs = []
    try:
        data = os.path.join(tmp, "tpch.pickle")
        with open(data, "wb") as f:
            pickle.dump(enc, f, protocol=5)
        del enc
        out["in_use_at_start"] = int(torch.cuda.memory_allocated()) \
            if kit.device == "cuda" else 0
        port = free_port()
        t_spawn = time.perf_counter()
        logs = [os.path.join(tmp, f"child{r}.log")
                for r in range(CLUSTER_PROCS)]
        for rank in range(CLUSTER_PROCS):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("CBTPU_")}
            env.update(CBTPU_COORDINATOR=f"127.0.0.1:{port}",
                       CBTPU_NUM_PROCS=str(CLUSTER_PROCS),
                       CBTPU_PROC_ID=str(rank),
                       CBTPU_LOCAL_SLOTS=str(CLUSTER_LOCAL_SLOTS))
            # each child writes to a file of its own: no child blocks on
            # a pipe that is not being read
            with open(logs[rank], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--cluster-child", data,
                     os.path.join(tmp, f"child{rank}.pickle"), kit.device,
                     root or "-"],
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    env=env, stdout=f, stderr=subprocess.STDOUT))

        def said(rank):
            with open(logs[rank], errors="replace") as f:
                return f.read()

        # (e)'s oracle while the children run (a)-(d), which touch no
        # store: the children start (e) when STORE_GATE appears
        store_want = None
        if root is not None:
            t0 = time.perf_counter()
            store_want = cluster_store_oracle(kit, gpu.config, root)
            gc.collect()
            if kit.device == "cuda":
                torch.cuda.empty_cache()
            with open(os.path.join(tmp, STORE_GATE), "w") as f:
                f.write("ready")
            out["store_oracle_s"] = time.perf_counter() - t0

        # wait for both against one deadline; the first child that fails
        # is named at once (the other would only wait in a collective)
        deadline = time.monotonic() + CLUSTER_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            for rank, p in enumerate(procs):
                check(p.poll() in (None, 0), f"cluster child {rank} "
                      f"exited {p.returncode}:\n{said(rank)[-4000:]}")
            check(time.monotonic() < deadline,
                  "cluster children "
                  f"{[r for r, p in enumerate(procs) if p.poll() is None]}"
                  f" did not finish within {CLUSTER_TIMEOUT_S} s")
            time.sleep(0.2)
        for rank, p in enumerate(procs):
            text = said(rank)
            for line in text.splitlines():
                if line.startswith("[cluster child"):
                    log(line)
            check(p.returncode == 0, f"cluster child {rank} exited "
                  f"{p.returncode}:\n{text[-4000:]}")
        out["children_s"] = time.perf_counter() - t_spawn
        kids = []
        for rank in range(CLUSTER_PROCS):
            with open(os.path.join(tmp, f"child{rank}.pickle"), "rb") as f:
                kids.append(pickle.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    for rank, kid in enumerate(kids):
        topo = kid["topology"]
        check(kid["rank"] == rank and kid["procs"] == CLUSTER_PROCS
              and topo["n_hosts"] == CLUSTER_PROCS
              and topo["this_host"] == rank
              and kid["local"] == list(range(4 * rank, 4 * rank + 4)),
              f"cluster child {rank}: topology {topo}, segments "
              f"{kid['local']}")
    fired = {k: [0] * CLUSTER_PROCS for k in kit.launch_names}
    for q in want:
        rec = {}
        for mode in ("off", "on"):
            got = [kid["texts"][(mode, q)] for kid in kids]
            for rank, g in enumerate(got):
                for what in ("warm", "result"):
                    identical(g[what], want[q],
                              f"cluster child {rank} {mode} {q} ({what}) "
                              "vs the one-process 8-segment run")
                for k, v in g["launches"].items():
                    fired[k][rank] += v
                check(want_fired[q] <= {k for k, v in g["launches"].items()
                                        if v},
                      f"cluster child {rank} {mode} {q}: launches "
                      f"{g['launches']}, the one-process run launched "
                      f"{sorted(want_fired[q])}")
            # per redistribute: the bytes both children handed to
            # torch.distributed against the wire models
            ex = [g["exchanges"] for g in got]
            check(len(ex[0]) == len(ex[1]),
                  f"{mode} {q}: the children ran {len(ex[0])} and "
                  f"{len(ex[1])} redistributes")
            wire = []
            for a, b in zip(*ex):
                flat = TT.flat_wire_model(DIST_NSEG, CLUSTER_PROCS,
                                          a["bucket_cap"],
                                          a["row_bytes"])["dcn_bytes"]
                w = {"op": a["op"], "bucket_cap": a["bucket_cap"],
                     "row_bytes": a["row_bytes"],
                     "bytes": a["bytes"] + b["bytes"], "flat_model": flat}
                if a["op"] == "hier_all_to_all":
                    w["host_bucket_cap"] = a["host_bucket_cap"]
                    w["two_level_model"] = TT.two_level_wire_model(
                        DIST_NSEG, CLUSTER_PROCS, a["bucket_cap"],
                        a["host_bucket_cap"], a["row_bytes"])["dcn_bytes"]
                    model = w["two_level_model"]
                else:
                    model = flat
                check(w["bytes"] == model, f"{mode} {q}: {w['bytes']} "
                      f"bytes crossed for a redistribute, model {model}")
                wire.append(w)
            rec[mode] = {"ms": [g["ms"] for g in got],
                         "launches": [g["launches"] for g in got],
                         "dist_bytes": [g["dist_bytes"] for g in got],
                         "peak_bytes": [g["peak_bytes"] for g in got],
                         "redistributes": wire}
            log(f"[cluster] {mode} {q}: walls "
                f"{[round(g['ms'], 3) for g in got]} ms against the "
                f"one-process flat {want_ms[q]:.3f} ms; peaks "
                f"{[g['peak_bytes'] for g in got]} B; launches "
                f"{[g['launches'] for g in got]}; bytes to "
                f"torch.distributed {[g['dist_bytes'] for g in got]}; "
                f"redistributes {wire}; equal bit for bit")
        rec["one_process_ms"] = want_ms[q]
        out["texts"][q] = rec
    out["parts"] = cluster_parts(kids, want, want7, want6, flat8, fired)
    if store_want is not None:
        out["store"] = cluster_store_checks(kids, store_want, fired)
    check(all(all(v) for v in fired.values()),
          f"a kernel did not launch in both cluster children: {fired}")
    out["launches"] = {k: sum(v) for k, v in fired.items()}
    out["peak_bytes"] = [kid["peak_bytes"] for kid in kids]
    out["children_self_s"] = [kid["s"] for kid in kids]
    out["children_split_s"] = [kid["seconds"] for kid in kids]
    split = [{k: round(v, 1) for k, v in x.items()}
             for x in out["children_split_s"]]
    out["s"] = time.perf_counter() - t_phase
    log(f"[cluster] launches per child {fired}; peak device bytes per "
        f"child {out['peak_bytes']}; children {out['children_s']:.1f} s "
        f"({[round(x, 1) for x in out['children_self_s']]} s each; "
        f"start, flat and two-level: {split}); phase {out['s']:.1f} s")
    return out


def cluster_parts(kids, want, want7, want6, flat8, fired) -> dict:
    """Phase 19's parts (a)-(d) of both children against their
    one-process counterparts; each part's walls, peaks, launches and
    gloo bytes, logged. ``fired`` gains the parts' launches."""
    from cloudberry_tpu_torch.parallel import transport as TT

    out = {}
    for name in ("ring", "tiled", "degrade", "resize_before", "resize"):
        recs = [kid["parts"][name] for kid in kids]
        rows = {}
        for q in recs[0]["texts"]:
            got = [r["texts"][q] for r in recs]
            identical(got[1]["result"], got[0]["result"],
                      f"({name}) {q}: the children's results")
            what = f"cluster ({name}) {q}"
            if name == "ring":
                identical(got[0]["result"], want[q],
                          f"{what} vs the one-process 8-segment run")
                for a, b in zip(*[g["exchanges"] for g in got]):
                    model = TT.flat_wire_model(
                        DIST_NSEG, CLUSTER_PROCS, a["bucket_cap"],
                        a["row_bytes"])["dcn_bytes"]
                    check(a["bytes"] + b["bytes"] == model,
                          f"{what}: {a['bytes'] + b['bytes']} bytes "
                          f"crossed for a redistribute, model {model}")
            elif name == "tiled":
                rep = got[0]["tiled"]
                check(rep is not None and rep["tiled"]
                      and rep["distributed"] and rep["n_tiles"] > 1
                      and got[1]["tiled"] == rep,
                      f"{what}: tiled reports {[g['tiled'] for g in got]}")
                same_nulls(got[0]["result"], flat8[q],
                           f"{what} vs the one-shot 8-segment run")
            elif name == "degrade":
                identical(got[0]["result"], want7[q],
                          f"{what} vs the one-process 7-segment run over "
                          "the same survivors")
            elif name == "resize_before":
                identical(got[0]["result"], want6,
                          f"{what} vs the static {CLUSTER_RESIZE[0]}-"
                          "segment run")
            else:
                identical(got[0]["result"], flat8[q],
                          f"{what} vs the static 8-segment run")
            for rank, g in enumerate(got):
                for k, v in g["launches"].items():
                    fired[k][rank] += v
            rows[q] = {"ms": [g["ms"] for g in got],
                       "launches": [g["launches"] for g in got],
                       "dist_bytes": [g["dist_bytes"] for g in got],
                       "shifts": [g["shifts"] for g in got],
                       "tiled": got[0]["tiled"]}
        out[name] = {"texts": rows, "s": [r["s"] for r in recs],
                     "peak_bytes": [r["peak_bytes"] for r in recs]}
        launched = {k: sum(sum(c[k] for c in r["launches"])
                           for r in rows.values()) for k in fired}
        texts = "; ".join(
            f"{q} {[round(x, 2) for x in r['ms']]} ms, {r['dist_bytes']} B "
            f"to gloo" + (f", {r['shifts']} shifts" if name == "ring"
                          else "")
            + (f", {r['tiled']['n_tiles']} tiles of {r['tiled']['tile_rows']}"
               if r["tiled"] else "") for q, r in rows.items())
        log(f"[cluster] ({name}) {[round(x, 2) for x in out[name]['s']]} s "
            f"per child; peaks {out[name]['peak_bytes']} B; launches "
            f"{launched}; {texts}; equal")
    deg = [kid["parts"]["degrade"] for kid in kids]
    check([d["local"] for d in deg] == [[0, 1, 2], [3, 4, 5, 6]]
          and {d["epoch"] for d in deg} == {2},
          f"(degrade) layouts {[d['local'] for d in deg]}, epochs "
          f"{[d['epoch'] for d in deg]}")
    out["degrade"]["degrade_s"] = [d["degrade_s"] for d in deg]
    bef = [kid["parts"]["resize_before"]["local"] for kid in kids]
    aft = [kid["parts"]["resize"] for kid in kids]
    check(bef == [[0, 1, 2, 3], [4, 5]]
          and [a["local"] for a in aft] == [[0, 1, 2, 3], [4, 5, 6, 7]]
          and {(a["epoch"], a["reason"]) for a in aft} == {(2, "expand")},
          f"(resize) layouts {bef} -> {[a['local'] for a in aft]}")
    # every child reports the cluster's move (the mover's counts)
    moved = aft[0]["rebalance"]["moved_rows"]
    total = aft[0]["rebalance"]["total_rows"]
    bound = aft[0]["rebalance"]["minimal_bound"]
    out["resize"].update(
        moved_rows=[a["rebalance"]["moved_rows"] for a in aft],
        total_rows=[a["rebalance"]["total_rows"] for a in aft],
        moved_fraction=moved / max(total, 1), minimal_bound=bound,
        resize_s=[a["resize_s"] for a in aft])
    check(moved > 0 and abs(moved / max(total, 1) - bound) < 0.02
          and all(a["rebalance"]["moved_rows"] == moved
                  and a["rebalance"]["total_rows"] == total for a in aft),
          f"(resize) moved {[a['rebalance']['moved_rows'] for a in aft]} "
          f"of {[a['rebalance']['total_rows'] for a in aft]} rows, bound "
          f"{bound}")
    log(f"[cluster] (resize) {CLUSTER_RESIZE[0]} -> {CLUSTER_RESIZE[1]}: "
        f"moved_rows {out['resize']['moved_rows']} of "
        f"{out['resize']['total_rows']} ({moved / max(total, 1):.4f}, "
        f"bound {bound:.4f}); resize "
        f"{[round(x, 2) for x in out['resize']['resize_s']]} s")
    return out


def cluster_store_checks(kids, want, fired) -> dict:
    """Phase 19 (e) of both children against the one-process 6-segment
    run over the same store (``want``: its results, walls and orders
    counts): (a) and (c) equal bit for bit across the children and to
    the one-process results (floats within FLOAT_RTOL), (c) after the
    resize equal to (a) since (b) touched no order they read; (b)'s
    statuses and counts, one manifest version per statement; the moved
    fraction against the jump-hash bound; every kernel launched in both
    children's counted runs and held against its plain version in both.
    ``fired`` gains the part's launches."""
    recs = [kid["store"] for kid in kids]
    out = {"one_process_ms": want["ms"]}
    launched = {k: [0] * len(recs) for k in fired}
    for tag in ("a", "c"):
        rows = out[tag] = {}
        for q in CLUSTER_STORE:
            got = [r[tag][q] for r in recs]
            identical(got[1]["result"], got[0]["result"],
                      f"(e{tag}) {q} from the store: the children's "
                      "results")
            same_nulls(got[0]["result"], want["results"][q],
                       f"(e{tag}) {q} from the store vs the one-process "
                       f"{CLUSTER_RESIZE[0]}-segment run")
            for rank, g in enumerate(got):
                for k, v in g["launches"].items():
                    fired[k][rank] += v
                    launched[k][rank] += v
            rows[q] = {"ms": [g["ms"] for g in got],
                       "first_ms": [g["warm_ms"] for g in got],
                       "launches": [g["launches"] for g in got],
                       "dist_bytes": [g["dist_bytes"] for g in got]}
            log(f"[cluster] (e{tag}) {q} from the store: walls "
                f"{[round(x, 2) for x in rows[q]['ms']]} ms (first "
                f"{[round(x, 1) for x in rows[q]['first_ms']]} ms) against "
                f"the one-process {CLUSTER_RESIZE[0]}-segment "
                f"{want['ms'][q]:.2f} ms; launches {rows[q]['launches']}; "
                "equal")
    check(all(all(r["held"].values()) for r in recs),
          f"(e) a kernel was not held against its plain version in both "
          f"children: {[r['held'] for r in recs]}")
    check([r["local"] for r in recs] == [[0, 1, 2, 3], [4, 5]],
          f"(e) layouts {[r['local'] for r in recs]}")
    dml = [r["b"] for r in recs]
    counts = [(d["orders_before"], d["deleted_match"], d["orders_after"])
              for d in dml]
    expect = (want["orders"], want["deleted"],
              want["orders"] + CLUSTER_INSERTED - want["deleted"])
    check(want["deleted"] > 0 and counts == [expect] * len(recs),
          f"(eb) orders before, matching the DELETE and after: {counts}, "
          f"the one-process run's {expect}")
    statuses = [[st["status"] for st in d["statements"]] for d in dml]
    added = [[st["added"] for st in d["statements"]] for d in dml]
    check(statuses[0] == statuses[1] == [f"INSERT {CLUSTER_INSERTED}",
                                         f"DELETE {want['deleted']}"]
          and added == [[1, 1]] * len(recs),
          f"(eb) statuses {statuses}, manifest versions added {added}")
    out["b"] = {"statuses": statuses[0], "orders": [
        dml[0]["orders_before"], dml[0]["orders_after"]],
        "deleted": want["deleted"],
        "s": [[st["s"] for st in d["statements"]] for d in dml]}
    rz = [r["c_resize"] for r in recs]
    reb = rz[0]["rebalance"]
    frac = reb["moved_rows"] / max(reb["total_rows"], 1)
    check(all(r["rebalance"] == reb for r in rz)
          and {(r["epoch"], r["reason"]) for r in rz} == {(2, "expand")}
          and [r["local"] for r in rz] == [[0, 1, 2, 3], [4, 5, 6, 7]]
          and abs(frac - reb["minimal_bound"]) < 0.01,
          f"(ec) the resize on each child: {rz}")
    for q in CLUSTER_STORE:
        same_nulls(recs[0]["c"][q]["result"], recs[0]["a"][q]["result"],
                   f"(ec) {q} after the resize vs before it")
    out["c_resize"] = {"s": [r["s"] for r in rz], "moved_rows":
                       reb["moved_rows"], "total_rows": reb["total_rows"],
                       "moved_bytes": reb["moved_bytes"],
                       "moved_fraction": frac,
                       "minimal_bound": reb["minimal_bound"]}
    out["peak_bytes"] = [r["peak_bytes"] for r in recs]
    out["held"] = [r["held"] for r in recs]
    out["launches"] = launched
    out["s"] = [r["s"] for r in recs]
    log(f"[cluster] (e) the store as a {CLUSTER_RESIZE[0]}-segment "
        f"cluster: {out['b']['statuses']} on orders "
        f"({out['b']['orders'][0]} -> {out['b']['orders'][1]} rows, one "
        f"manifest version per statement, "
        f"{[[round(x, 2) for x in d] for d in out['b']['s']]} s); "
        f"online_resize({CLUSTER_RESIZE[1]}) moved {reb['moved_rows']} of "
        f"{reb['total_rows']} rows ({frac:.4f}, bound "
        f"{reb['minimal_bound']:.4f}, {reb['moved_bytes']} B) in "
        f"{[round(x, 2) for x in out['c_resize']['s']]} s; peaks "
        f"{out['peak_bytes']} B; held {out['held']}; launches {launched}; "
        f"part {[round(x, 1) for x in out['s']]} s per child")
    check(all(all(v) for v in launched.values()),
          f"(e) a kernel did not launch in both children's counted runs "
          f"from the store: {launched}")
    return out


def main() -> int:
    if sys.argv[1:2] == ["--cluster-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return cluster_child(sys.argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--ds-scale", type=float, default=DS_SCALE,
                    help="tpcds-lite scale (100: 3M store_sales rows; a "
                    "small scale makes a quick check)")
    ap.add_argument("--dist-sf", type=float, default=DIST_BIG_SF,
                    help="TPC-H scale of the distributed phase's 4-segment "
                    f"Q5/Q9 (BASELINE.md config #3 is SF10; {DIST_BIG_SF:g} "
                    "fits the time limit); 0 skips it")
    ap.add_argument("--profile", action="store_true",
                    help="also trace TPC-H Q1/Q3/Q5, TPC-DS q36/q98 and the "
                    "window query with torch.profiler and write each "
                    "device-time table under chiprun_out/")
    ap.add_argument("--host-profile", action="store_true",
                    help="sample the host's Python stack every 10 ms and "
                    "write where the wall went to "
                    "chiprun_out/host_profile.json")
    args = ap.parse_args()
    if args.host_profile:
        sampler = StackSampler().start()
        try:
            return _main(args)
        finally:
            sampler.dump(os.path.join("chiprun_out", "host_profile.json"))
    return _main(args)


def _main(args) -> int:
    t_script = time.perf_counter()

    def stamp(what):
        log(f"[time] {what} starts {time.perf_counter() - t_script:.1f} s "
            "into the script")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch import tpcds
    from cloudberry_tpu_torch.catalog import carry
    from cloudberry_tpu_torch.exec import cuda_kernels as CK
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.exec import kernels as K
    from cloudberry_tpu_torch.types import date_to_days

    # phase 12's larger TPC-H, generated beside phases 2 to 11
    args.prefetch = Prefetch(args.dist_sf, SEED) if args.dist_sf > 0 \
        else None

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    CK.build(verbose=True)
    build_s = time.perf_counter() - t0
    log(f"[build] kernels built in {build_s:.2f} s")

    originals = {k: getattr(CK, k) for k in CK.LAUNCHES}
    launches = {k: 0 for k in CK.LAUNCHES}   # summed over counted runs

    report = {}     # per kernel: the largest difference from plain seen

    def compare(name, what, args_, kernel, plain, quiet=False):
        got = kernel(*args_)
        want = plain(*args_)
        torch.cuda.synchronize()
        exact = [(g, w) for g, w in zip(got, want)
                 if not w.dtype.is_floating_point]
        floats = [(g, w) for g, w in zip(got, want)
                  if w.dtype.is_floating_point]
        check(max_abs_err(torch, *zip(*exact)) == 0,
              f"{name} {what}: integer outputs differ from plain")
        err = max_abs_err(torch, *zip(*floats)) if floats else 0.0
        # float sums: the kernel adds in another order than index_add_
        tol = 1e-9 * max([1.0] + [float(w.abs().max()) for _, w in floats
                                  if w.numel()])
        check(err <= tol, f"{name} {what}: float outputs differ from plain "
              f"(max abs err {err}, tolerance {tol})")
        if not quiet:
            log(f"[kernel] {name} {what}: equal to the plain version "
                f"(max abs err {err})")
        report.setdefault(name, {"max_abs_err": 0.0})
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

    def probe_outputs(fn, a):
        """(matched, *payload columns, duplicate flag) of one probe-join
        call on a fresh zeroed flag slot."""
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        matched, out = fn(*a[:5], flag)
        return (matched, *out, flag)

    plains = {"dense_agg": CK.dense_agg_plain,
              "probe_join": CK.probe_join_plain,
              "sorted_seg": CK.sorted_seg_plain}
    held = {k: 0 for k in CK.LAUNCHES}   # calls held against plain

    def holding(name, what, sizes=None):
        """A kernel wrapper that also holds each call against the plain
        version on the same inputs (a warm-up run's calls); ``sizes``, if
        given, collects each call's input sizes."""
        def wrapped(*a):
            if sizes is not None:
                sizes.append(f"{name} {input_sizes(name, a)}")
            out = originals[name](*a)
            if name == "probe_join":
                compare(name, what, a,
                        lambda *x: probe_outputs(originals[name], x),
                        lambda *x: probe_outputs(plains[name], x), True)
            else:
                compare(name, what, a, originals[name], plains[name], True)
            held[name] += 1
            return out
        return wrapped

    def input_sizes(name, a):
        if name == "dense_agg":
            return f"N={a[0].shape[0]} cells={a[4]}"
        if name == "probe_join":
            return f"B={a[1].shape[0]} N={a[3].shape[0]}"
        return f"N={a[0].shape[1]} groups={int(a[3])} cap={a[4]}"

    def counted(fn):
        """One call of fn with the launch counts zeroed just before and
        read just after: (result, wall ms, launches), launches added to
        the totals."""
        torch.cuda.synchronize()
        for k in CK.LAUNCHES:
            CK.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(CK.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        return res, ms, counts

    def counted_run(session, sql):
        """One counted statement (``counted``)."""
        return counted(lambda: session.sql(sql))

    def cpu_run(session, sql):
        """The port's CPU run, and which kernels' wrappers it called."""
        called = {k: 0 for k in CK.LAUNCHES}

        def counting(name):
            def wrapped(*a):
                called[name] += 1
                return originals[name](*a)
            return wrapped

        for k in CK.LAUNCHES:
            setattr(CK, k, counting(k))
        try:
            return session.sql(sql), called
        finally:
            for k, fn in originals.items():
                setattr(CK, k, fn)

    # phases 3 to 10 run every statement with the statement cache and the
    # generic plans emptied first (EmptyCaches), generic plans off (the
    # port's default), as before the caches; phase 11 measures them
    with EmptyCaches(ct.Session) as caches:

        # ----------------------------------------------------------- 3. TPC-H
        t0 = time.perf_counter()
        raw = tpch.generate(args.sf, SEED)
        names = ["region", "nation", "supplier", "customer", "orders",
                 "lineitem"]
        card = ct.Config().with_overrides(
            **{"resource.query_mem_bytes": CARD_BUDGET})
        gpu = ct.Session(card)
        tpch.load_tables(gpu, tpch.SCHEMAS, tpch.DIST_KEYS, raw, names)
        cpu = ct.Session(card, device="cpu")
        copy_tables(gpu, cpu, names)
        log(f"[data] TPC-H sf={args.sf} seed={SEED}: "
            f"{gpu.catalog.table('lineitem').num_rows} lineitem rows, "
            f"{time.perf_counter() - t0:.1f} s to generate and load")

        # record the inputs every kernel call of the warm-up runs receives
        recorded: dict[str, list] = {k: [] for k in CK.LAUNCHES}
        current = [None]

        def snap(x):
            if torch.is_tensor(x):
                return x.clone()
            return [snap(y) for y in x] if isinstance(x, list) else x

        def recorder(name):
            def wrapped(*a):
                if a[1].device.type == "cuda":
                    recorded[name].append((current[0], [snap(x) for x in a]))
                return originals[name](*a)
            return wrapped

        # the probe-join operator as the Lowerer calls it on Q5, to count its
        # device kernels later
        operator_calls = []
        real_gate = X.Lowerer._probe_join_kernel

        def gate_recorder(self, *a):
            out = real_gate(self, *a)
            if out is not None:     # the join took the probe-join kernel
                operator_calls.append((self, a))
            return out

        query_ms = {}
        ram = {}    # per query: (physical result, kernels launched)
        for q in ("q1", "q3", "q5"):
            sql = tpch.QUERIES[q]
            for k in CK.LAUNCHES:
                setattr(CK, k, recorder(k))
            if q == "q5":
                X.Lowerer._probe_join_kernel = gate_recorder
            current[0] = q
            t0 = time.perf_counter()
            gpu.sql(sql)
            warm_ms = (time.perf_counter() - t0) * 1e3
            for k, fn in originals.items():
                setattr(CK, k, fn)
            X.Lowerer._probe_join_kernel = real_gate
            res, ms, counts = counted_run(gpu, sql)
            query_ms[q] = [ms]
            fired = {k for k, v in counts.items() if v > 0}
            check(EXPECTED[q] <= fired,
                  f"{q}: kernels {sorted(EXPECTED[q])} expected, launches "
                  f"{counts}")
            got = physical(res)
            ram[q] = (got, fired)
            same(got, oracle(raw, q, date_to_days), f"{q} vs numpy oracle")
            same(got, physical(cpu.sql(sql)), f"{q} vs the port on the CPU")
            for _ in range(QUERY_RUNS - 1):    # more runs for the spread
                t0 = time.perf_counter()
                gpu.sql(sql)
                torch.cuda.synchronize()
                query_ms[q].append((time.perf_counter() - t0) * 1e3)
            log(f"[query] {q}: {np.median(query_ms[q]):.3f} ms median of "
                f"{QUERY_RUNS} runs ({min(query_ms[q]):.3f}-"
                f"{max(query_ms[q]):.3f}; first run, tables uploaded: "
                f"{warm_ms:.1f} ms), {len(next(iter(got.values())))} rows, "
                f"launches {counts}, equal to the numpy oracle and the CPU "
                "run")


        # ---------------------------------------------------------- 4. TPC-DS
        stamp("phase 4 (TPC-DS)")
        t0 = time.perf_counter()
        ds_raw = tpcds.generate(args.ds_scale, DS_SEED)
        gds = ct.Session(card)
        tpch.load_tables(gds, tpcds.SCHEMAS, tpcds.DIST_KEYS, ds_raw)
        del ds_raw
        cds = ct.Session(card, device="cpu")
        copy_tables(gds, cds, list(tpcds.SCHEMAS))
        log(f"[data] TPC-DS (tpcds-lite) scale={args.ds_scale} "
            f"seed={DS_SEED}: "
            f"{gds.catalog.table('store_sales').num_rows} store_sales, "
            f"{gds.catalog.table('catalog_sales').num_rows} catalog_sales, "
            f"{gds.catalog.table('web_sales').num_rows} web_sales, "
            f"{gds.catalog.table('inventory').num_rows} inventory rows, "
            f"{time.perf_counter() - t0:.1f} s to generate and load")
        # phases 3 and 4's data and sessions live to the end: take them
        # out of the cyclic collector's full passes, which the memory
        # readings' gc.collect calls make dozens of times
        gc.collect()
        gc.freeze()
        ds_ms, ds_launches = {}, {}
        for q in sorted(tpcds.QUERIES, key=lambda q: int(q[1:])):
            sql = tpcds.QUERIES[q]
            for k in CK.LAUNCHES:
                setattr(CK, k, holding(k, f"TPC-DS {q} main-path input"))
            t0 = time.perf_counter()
            gds.sql(sql)
            warm_ms = (time.perf_counter() - t0) * 1e3
            for k, fn in originals.items():
                setattr(CK, k, fn)
            res, ms, counts = counted_run(gds, sql)
            want, called = cpu_run(cds, sql)
            check({k for k, v in counts.items() if v} ==
                  {k for k, v in called.items() if v},
                  f"TPC-DS {q}: launches {counts} on the card, kernel calls "
                  f"{called} on the CPU")
            check(any(counts.values()), f"TPC-DS {q}: no kernel launched")
            err = same_nulls(with_nulls(res), with_nulls(want),
                             f"TPC-DS {q} vs the port on the CPU")
            ds_ms[q] = [ms]
            runs = QUERY_RUNS if q in WINDOWED else 1
            for _ in range(runs - 1):
                t0 = time.perf_counter()
                gds.sql(sql)
                torch.cuda.synchronize()
                ds_ms[q].append((time.perf_counter() - t0) * 1e3)
            ds_launches[q] = counts
            log(f"[tpcds] {q}: {np.median(ds_ms[q]):.3f} ms median of "
                f"{len(ds_ms[q])} run(s) ({min(ds_ms[q]):.3f}-"
                f"{max(ds_ms[q]):.3f}; warm-up {warm_ms:.1f} ms), "
                f"{res.num_rows()} rows, launches {counts}, equal to the CPU "
                f"run (largest float difference {err})")
        log(f"[tpcds] kernel calls of the warm-up runs held against their "
            f"plain versions: {held}")

        # ------------------------------------------------- 5. windows at scale
        stamp("phase 5 (windows)")
        window = {}
        for case, where in WINDOW_CASES:
            sql = tpcds.WINDOW_QUERY.format(where=where)
            gds.sql(sql)                  # warm-up
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res, ms, counts = counted_run(gds, sql)
            peak = torch.cuda.max_memory_allocated()
            want, _ = cpu_run(cds, sql)
            err = same_nulls(with_nulls(res), with_nulls(want),
                             f"window query ({case}) vs the port on the CPU")
            walls = [ms]
            for _ in range(QUERY_RUNS - 1 if case == "full" else 0):
                t0 = time.perf_counter()
                gds.sql(sql)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            check((res.num_rows() > 0) if case == "full" else
                  res.num_rows() == {"empty selection": 0, "one row": 1}[case],
                  f"window query ({case}): {res.num_rows()} rows")
            window[case] = {"rows": res.num_rows(), "ms": walls,
                            "peak_bytes": peak, "resident_bytes": base,
                            "launches": counts}
            log(f"[window] {case}: {res.num_rows()} rows, "
                f"{np.median(walls):.3f} ms median of {len(walls)} run(s) "
                f"({min(walls):.3f}-{max(walls):.3f}), peak device memory "
                f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB resident "
                f"before), launches {counts}, equal to the CPU run (largest "
                f"float difference {err})")
        del cds

        # ---------------------------------------------------------- 6. growth
        pk_, pv_, bk_, bv_ = skew_join_tables(SKEW_ROWS)
        gsk = ct.Session(card)
        F = carry.field
        carry.load_encoded(gsk, "f", [F("k", "int64", 0, False),
                                      F("v", "int64", 0, False)],
                           {"k": pk_, "v": pv_})
        carry.load_encoded(gsk, "d", [F("k", "int64", 0, False),
                                      F("w", "int64", 0, False)],
                           {"k": bk_, "w": bv_})
        sql = ("select count(*) as c, sum(f.v + d.w) as s from f join d "
               "on f.k = d.k")
        res, ms, counts = counted_run(gsk, sql)
        want_c, want_s = skew_join_oracle(pk_, pv_, bk_, bv_)
        got = physical(res)
        check(got["c"].tolist() == [want_c] and got["s"].tolist() == [want_s],
              f"skew join: {got} against numpy count {want_c}, sum {want_s}")
        check(gsk.growth_events > 0, "skew join: the pair buffer never grew")
        growth = {"probe_rows": SKEW_ROWS, "pairs": want_c,
                  "growth_events": gsk.growth_events, "ms": ms,
                  "launches": counts}
        log(f"[growth] skew join: {want_c} pairs from {SKEW_ROWS} probe rows, "
            f"{gsk.growth_events} growth(s) of the pair buffer, {ms:.1f} ms "
            f"with the retries, launches {counts}, equal to numpy")

        # ---------------------------- 7. admission at the default budget
        stamp("phase 7 (admission)")
        admission = default_budget_phase(
            gpu, gds, (gsk, sql, gsk.growth_events),
            full=args.sf == 1.0 and args.ds_scale == DS_SCALE)
        del gsk

        # ------------------------------------------- 8. tiling from RAM
        stamp("phase 8 (tiling)")
        def held_run(name_of_run, fn, sizes=None):
            """Run fn with every kernel call held against its plain version
            (``sizes``, if given, collects each call's input sizes)."""
            for k in CK.LAUNCHES:
                setattr(CK, k, holding(k, name_of_run, sizes))
            try:
                return fn()
            finally:
                for k, fn_ in originals.items():
                    setattr(CK, k, fn_)

        t0 = time.perf_counter()
        held_before = dict(held)
        tile_kit = SimpleNamespace(torch=torch, counted_run=counted_run,
                                   held=held_run, sf=args.sf)
        tiling = tiling_phase(tile_kit, raw, ram, query_ms, gpu, gds, args)
        tiling["s"] = time.perf_counter() - t0
        tiling["held"] = {k: held[k] - held_before[k] for k in held}
        log(f"[tiling] kernel calls of the tiled runs held against their "
            f"plain versions: {tiling['held']}; tiling phase from RAM: "
            f"{tiling['s']:.1f} s")
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        timer = Timer(torch, flush, REPS)

        # --------------------------------------------------------- 9. storage
        stamp("phase 9 (storage)")
        t0 = time.perf_counter()
        held_before = dict(held)
        store = storage_phase(SimpleNamespace(
            torch=torch, dev=dev, sync=torch.cuda.synchronize,
            counted=counted, counted_run=counted_run, timer=timer,
            held=held_run, sf=args.sf, cached_sql=caches.real),
            raw, ram, gpu, names)
        store["s"] = time.perf_counter() - t0
        store["held"] = {k: held[k] - held_before[k] for k in held}
        log(f"[store] kernel calls of the store path held against their plain "
            f"versions: {store['held']}; storage phase: {store['s']:.1f} s")

        # ------------------------------------------------------ 10. telemetry
        t0 = time.perf_counter()
        held_before = dict(held)
        telemetry = telemetry_phase(SimpleNamespace(
            torch=torch, counted=counted, counted_run=counted_run,
            held=held_run, build_s=build_s), ram, gpu, cpu, gds, args)
        telemetry["s"] = time.perf_counter() - t0
        telemetry["held"] = {k: held[k] - held_before[k] for k in held}
        log(f"[telemetry] kernel calls of EXPLAIN ANALYZE held against their "
            f"plain versions: {telemetry['held']}; telemetry phase: "
            f"{telemetry['s']:.1f} s")

    # ------------------------------ 11. statement cache and generic plans
    t0 = time.perf_counter()
    held_before = dict(held)
    stmt_cache = stmt_cache_phase(SimpleNamespace(
        torch=torch, counted=counted, held=held_run), raw, gpu, cpu, names,
        store.pop("stmt_cache_repeats"), args)
    stmt_cache["s"] = time.perf_counter() - t0
    stmt_cache["held"] = {k: held[k] - held_before[k] for k in held}
    log(f"[stmtcache] kernel calls of the cached and generic runs held "
        f"against their plain versions: {stmt_cache['held']}; statement-"
        f"cache phase: {stmt_cache['s']:.1f} s")

    # ---------------------------------------------------- 12. distributed
    t0 = time.perf_counter()
    held_before = dict(held)
    keep = {"results8": {}}
    with EmptyCaches(ct.Session):
        dist = distributed_phase(SimpleNamespace(
            torch=torch, counted_run=counted_run, held=held_run,
            keep=keep), raw, gpu, cpu, gds, args)
    dist["held"] = {k: held[k] - held_before[k] for k in held}
    log(f"[dist] kernel calls of the distributed runs held against their "
        f"plain versions: {dist['held']}; distributed phase: "
        f"{time.perf_counter() - t0:.1f} s")

    # -------------------------------------------- 13. tiled distributed
    t0 = time.perf_counter()
    held_before = dict(held)
    launches_before = dict(launches)
    with EmptyCaches(ct.Session):
        tiled_dist = tiled_dist_phase(SimpleNamespace(
            torch=torch, counted_run=counted_run, held=held_run,
            keep=keep), raw, gpu, gds, args)
    flat8 = keep["results8"]    # phase 18's oracle
    del keep
    tiled_dist["held"] = {k: held[k] - held_before[k] for k in held}
    tiled_dist["launches"] = {k: launches[k] - launches_before[k]
                              for k in launches}
    check(all(tiled_dist["launches"].values()),
          f"a kernel never launched on the tiled distributed path: "
          f"{tiled_dist['launches']}")
    log(f"[tiled-dist] kernel calls of the tiled distributed runs held "
        f"against their plain versions: {tiled_dist['held']}; launches of "
        f"its counted runs {tiled_dist['launches']}; tiled distributed "
        f"phase: {time.perf_counter() - t0:.1f} s")

    # ----------------------------------------- 14. recovery and topology
    t0 = time.perf_counter()
    held_before = dict(held)
    launches_before = dict(launches)
    with EmptyCaches(ct.Session):
        recovery = recovery_phase(SimpleNamespace(
            torch=torch, counted_run=counted_run, held=held_run), raw, gpu,
            args)
    recovery["held"] = {k: held[k] - held_before[k] for k in held}
    recovery["launches"] = {k: launches[k] - launches_before[k]
                            for k in launches}
    check(all(recovery["launches"].values()),
          f"a kernel never launched on the recovery path: "
          f"{recovery['launches']}")
    log(f"[recovery] kernel calls of the recovery runs held against their "
        f"plain versions: {recovery['held']}; launches of its counted runs "
        f"{recovery['launches']}; recovery phase: "
        f"{time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------- 15. SQL surface
    t0 = time.perf_counter()
    held_before = dict(held)
    sql_surface = sql_surface_phase(SimpleNamespace(
        torch=torch, counted_run=counted_run, held=held_run), raw, gpu,
        args)
    sql_surface["held"] = {k: held[k] - held_before[k] for k in held}
    check(all(sql_surface["launches"].get(k, 0) for k in CK.LAUNCHES),
          f"a kernel never launched on the SQL-surface path: "
          f"{sql_surface['launches']}")
    log(f"[sql] kernel calls of the SQL-surface runs held against their "
        f"plain versions: {sql_surface['held']}; launches of its counted "
        f"runs {sql_surface['launches']}; SQL-surface phase: "
        f"{time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 16. serving
    stamp("phase 16 (serving)")
    import shutil

    t0 = time.perf_counter()
    held_before = dict(held)
    try:
        serving = serving_phase(SimpleNamespace(
            torch=torch, counted=counted, held=held_run, device="cuda"),
            raw, store["root"])
        serving["held"] = {k: held[k] - held_before[k] for k in held}
        log(f"[serve] kernel calls of the served runs held against their "
            f"plain versions: {serving['held']}; serving phase: "
            f"{time.perf_counter() - t0:.1f} s")

        # ---------------------------- 17. durability and management
        stamp("phase 17 (durability and management)")
        t0 = time.perf_counter()
        held_before = dict(held)
        durable = durability_phase(SimpleNamespace(
            torch=torch, counted=counted, held=held_run, device="cuda"),
            raw, gpu, store["root"])
        durable["held"] = {k: held[k] - held_before[k] for k in held}
        check(all(durable["held"].values()),
              f"a kernel was never held against its plain version in "
              f"phase 17: {durable['held']}")
        log(f"[durable] kernel calls held against their plain versions: "
            f"{durable['held']}; launches of its counted runs "
            f"{durable['launches']}; durability phase: "
            f"{time.perf_counter() - t0:.1f} s")
    except BaseException:
        shutil.rmtree(store.pop("tmp"), ignore_errors=True)
        raise

    # ------------------------------------- 18. two-level and ring motion
    stamp("phase 18 (two-level and ring motion)")
    t0 = time.perf_counter()
    held_before = dict(held)
    launches_before = dict(launches)
    with EmptyCaches(ct.Session):
        hier = hier_motion_phase(SimpleNamespace(
            torch=torch, counted=counted, counted_run=counted_run,
            held=held_run), raw, gpu, flat8,
            {q: r["seg8"]["median_ms"] for q, r in dist["tpch"].items()},
            args)
    hier["held"] = {k: held[k] - held_before[k] for k in held}
    hier["launches"] = {k: launches[k] - launches_before[k]
                        for k in launches}
    check(all(hier["launches"].values()) and all(hier["held"].values()),
          f"a kernel never launched or was never held on the ring and "
          f"two-level paths: launches {hier['launches']}, held "
          f"{hier['held']}")
    log(f"[hier] kernel calls held against their plain versions: "
        f"{hier['held']}; launches of its counted runs {hier['launches']};"
        f" two-level and ring phase: {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------- 19. the two-process cluster
    stamp("phase 19 (the two-process cluster)")
    gc.collect()
    torch.cuda.empty_cache()
    try:
        # phase 9's store: phase 19 is its last user
        cluster = cluster_phase(SimpleNamespace(
            torch=torch, counted_run=counted_run, device="cuda",
            launch_names=list(CK.LAUNCHES)), gpu, raw, flat8,
            {q: r["seg8"]["median_ms"] for q, r in dist["tpch"].items()},
            {q: r["launches"] for q, r in dist["tpch"].items()},
            sf=args.sf, root=store["root"])
    finally:
        shutil.rmtree(store.pop("tmp"), ignore_errors=True)
    del flat8
    for k, v in cluster["launches"].items():
        launches[k] += v
    log(f"[cluster] two-process cluster phase: {cluster['s']:.1f} s")

    # -------------------------------------------------------- 20. kernels
    stamp("phase 20 (kernels)")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand_int(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def rand_sel(n, p=0.9):
        return torch.rand(n, generator=gen, device=dev) < p

    # dense_agg -----------------------------------------------------------
    N = 6_001_215
    for q, a in recorded["dense_agg"]:
        compare("dense_agg", f"{q} main-path input (N={a[0].shape[0]}, "
                f"K={a[1].shape[0]}, cells={a[4]})", a, CK.dense_agg,
                CK.dense_agg_plain)

    def no_floats(n):
        return torch.zeros((0, n), dtype=torch.float64, device=dev)

    dense_cases = {
        f"N={N} K={k} cells={cells}": (
            rand_int(0, cells, (N,), torch.int32),
            rand_int(0, 10_000_000, (k, N)), no_floats(N), rand_sel(N),
            cells)
        for cells, k in ((6, 7), (25, 1), (300, 1), (4096, 7))}
    one_cell = f"N={N} K=7 cells=6, every row in cell 2"
    dense_cases[one_cell] = (
        torch.full((N,), 2, dtype=torch.int32, device=dev),
        rand_int(0, 10_000_000, (7, N)), no_floats(N),
        torch.ones(N, dtype=torch.bool, device=dev), 6)
    dense_cases[f"N={N} Ki=1 Kf=2 cells=25 (float sums)"] = (
        rand_int(0, 25, (N,), torch.int32), rand_int(0, 10_000, (1, N)),
        torch.randn((2, N), generator=gen, device=dev, dtype=torch.float64),
        rand_sel(N), 25)
    for what, a in dense_cases.items():
        compare("dense_agg", what, a, CK.dense_agg, CK.dense_agg_plain)
    big = (1 << 62) + 12345
    edge_n = 1001
    edges = {
        "empty selection": (rand_int(0, 6, (edge_n,), torch.int32),
                            rand_int(-5, 5, (3, edge_n)),
                            torch.zeros((0, edge_n), dtype=torch.float64,
                                        device=dev),
                            torch.zeros(edge_n, dtype=torch.bool,
                                        device=dev), 6),
        "ragged N, near-overflow values (wraparound)": (
            rand_int(-1, 8, (edge_n,), torch.int32),
            torch.stack([torch.full((edge_n,), big, device=dev),
                         torch.full((edge_n,), -big, device=dev),
                         rand_int(-(1 << 62), 1 << 62, (edge_n,))]),
            torch.zeros((0, edge_n), dtype=torch.float64, device=dev),
            rand_sel(edge_n), 6),
        "count only (no value rows)": (
            rand_int(0, 5, (edge_n,), torch.int32),
            torch.zeros((0, edge_n), dtype=torch.int64, device=dev),
            torch.zeros((0, edge_n), dtype=torch.float64, device=dev),
            rand_sel(edge_n), 5),
        "float values": (rand_int(0, 25, (edge_n,), torch.int32),
                         rand_int(-100, 100, (1, edge_n)),
                         torch.randn((2, edge_n), generator=gen,
                                     device=dev, dtype=torch.float64),
                         rand_sel(edge_n), 25),
    }
    for what, a in edges.items():
        compare("dense_agg", what, a, CK.dense_agg, CK.dense_agg_plain)

    # probe_join ----------------------------------------------------------
    def probe_compare(what, a):
        compare("probe_join", what, a,
                lambda *x: probe_outputs(CK.probe_join, x),
                lambda *x: probe_outputs(CK.probe_join_plain, x))
        return probe_outputs(CK.probe_join, a)

    for q, a in recorded["probe_join"]:
        probe_compare(f"{q} main-path input (B={a[1].shape[0]}, "
                      f"N={a[3].shape[0]}, keys={len(a[0])}, "
                      f"P={len(a[4])})", a)

    def probe_case(b, n, kind="int64", pay=(torch.int64, torch.int32),
                   bsel_p=0.9, psel_p=0.9, dup=False):
        """Raw key columns of a kind (unique build keys, probe keys drawn
        from four times their range), selections, payload columns."""
        span = 4 * b
        ids = torch.randperm(span, generator=gen, device=dev)[:b]
        pids = rand_int(0, span, (n,))
        if kind == "int64":
            bk, pk = [ids], [pids]
        elif kind == "int32":
            bk, pk = [ids.to(torch.int32)], [pids.to(torch.int32)]
        elif kind == "two_column":
            bk = [ids // 7, (ids % 7).to(torch.int32)]
            pk = [pids // 7, (pids % 7).to(torch.int32)]
        elif kind == "out_of_range":
            bk, pk = [ids], [rand_int(-span, 2 * span, (n,))]
        elif kind == "negative_int64":
            bk, pk = [ids * -(10 ** 12 + 7919)], [pids * -(10 ** 12 + 7919)]
        elif kind == "bool":
            bk = [torch.tensor([True, False], device=dev)[:b]]
            pk = [rand_sel(n, 0.5)]
        elif kind == "float64":
            bk = [1.0 + ids.to(torch.float64) * 2.0 ** -52]
            pk = [1.0 + pids.to(torch.float64) * 2.0 ** -52]
        elif kind == "span_2_32":   # spans 2^16 x 2^16: product 2^32
            bk = [rand_int(0, 1 << 16, (b,), torch.int32) for _ in "12"]
            pk = [rand_int(-5, (1 << 16) + 5, (n,), torch.int32)
                  for _ in "12"]
            for bc, pc in zip(bk, pk):
                bc[0], bc[1] = 0, 65535
                pc[:b] = bc
        else:
            raise KeyError(kind)
        bsel, psel = rand_sel(b, bsel_p), rand_sel(n, psel_p)
        if dup:
            for bc, pc in zip(bk, pk):
                bc[1] = bc[0]
                pc[:5] = bc[0]
            bsel[:2] = True
            psel[:5] = True
        payload = [rand_sel(b, 0.5) if dt == torch.bool else
                   rand_int(-(1 << 30), 1 << 30, (b,), dt) if
                   dt == torch.int32 else
                   rand_int(-(1 << 62), 1 << 62, (b,)) for dt in pay]
        return bk, bsel, pk, psel, payload

    PN = 1_500_000
    LN = gpu.catalog.table("lineitem").num_rows
    probe_large = f"B=2048 N={LN} P=2 (int64 key; int64, int32 payload)"
    probe_cases = {f"B={b} N={PN} P=2": probe_case(b, PN)
                   for b in (5, 25, 2048)}
    probe_cases[probe_large] = probe_case(2048, LN)
    edge_probe = {
        "two-column key": probe_case(300, edge_n, "two_column"),
        "probe keys below and above the build's range":
            probe_case(100, edge_n, "out_of_range"),
        "negative int64 keys": probe_case(200, edge_n, "negative_int64"),
        "int32 key": probe_case(700, edge_n, "int32"),
        "bool key": probe_case(2, edge_n, "bool", bsel_p=1.0),
        "float64 key (sort_key_u64 in the wrapper)":
            probe_case(50, edge_n, "float64"),
        "int32 + int64 + bool payload":
            probe_case(25, edge_n, pay=(torch.int32, torch.int64,
                                        torch.bool)),
        "membership only (no payload)": probe_case(25, edge_n, pay=()),
        "empty build selection": probe_case(25, edge_n, bsel_p=0.0),
        "key spans whose product is 2^32":
            probe_case(64, edge_n, "span_2_32", bsel_p=1.0),
        "duplicate build key": probe_case(25, edge_n, dup=True),
        "duplicate build key, empty probe selection":
            probe_case(25, edge_n, dup=True, psel_p=0.0),
    }
    edge_probe["duplicate build key, empty probe selection"][3].zero_()
    for what, a in {**probe_cases, **edge_probe}.items():
        flag = probe_compare(what, a)[-1]
        want_dup = what.startswith("duplicate build key") and \
            "empty probe" not in what
        check(int(flag) == int(want_dup),
              f"probe_join {what}: duplicate flag {int(flag)}")

    # sorted_seg ----------------------------------------------------------
    for q, a in recorded["sorted_seg"]:
        compare("sorted_seg", f"{q} main-path input (R={a[0].shape[0]}, "
                f"N={a[0].shape[1]}, groups={int(a[3])}, cap={a[4]})", a,
                CK.sorted_seg, CK.sorted_seg_plain)

    def seg_sized(sizes, cap, vals):
        """Groups of the given row counts, back to back from row 0."""
        ends = torch.cumsum(sizes, 0) - 1
        starts = ends - sizes + 1
        z = torch.zeros(cap - sizes.shape[0], dtype=torch.int64, device=dev)
        return (vals, torch.cat([starts, z]), torch.cat([ends, z]),
                torch.tensor(sizes.shape[0], device=dev), cap)

    def seg_case(n_rows, n_groups, cap, vals):
        if n_groups == 0:
            return seg_sized(torch.zeros(0, dtype=torch.int64, device=dev),
                             cap, vals)
        cuts = torch.sort(torch.randperm(n_rows - 1, generator=gen,
                                         device=dev)[:n_groups - 1] + 1
                          ).values
        bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            cuts, torch.tensor([n_rows], device=dev)])
        return seg_sized(bounds[1:] - bounds[:-1], cap, vals)

    q3 = recorded["sorted_seg"][0][1]
    n_q3 = int(q3[3])
    SN, singles = 6_000_000, 60_000
    skewed = (f"skewed: N={SN}, one group of {SN - singles} rows + "
              f"{singles} singletons, cap={SN}")
    seg_edges = {
        f"N={N} groups={n_q3} (Q3's group count)":
            seg_case(N, n_q3, q3[4], rand_int(-(1 << 40), 1 << 40, (1, N))),
        skewed: seg_sized(
            torch.cat([torch.tensor([SN - singles], device=dev),
                       torch.ones(singles, dtype=torch.int64, device=dev)]),
            SN, rand_int(-(1 << 40), 1 << 40, (1, SN))),
        "cap >> groups: N=1000000, 3 groups, cap=4000000":
            seg_case(1_000_000, 3, 4_000_000,
                     rand_int(-(1 << 40), 1 << 40, (2, 1_000_000))),
        "odd cap (unaligned row tails): N=1000003, 1001 groups, "
        "cap=1000003": seg_case(1_000_003, 1001, 1_000_003,
                                rand_int(-(1 << 40), 1 << 40,
                                         (3, 1_000_003))),
        "zero groups": seg_case(edge_n, 0, 64,
                                torch.zeros((2, edge_n), dtype=torch.int64,
                                            device=dev)),
        "ragged N, near-overflow values (wraparound)":
            seg_case(edge_n, 7, 13,
                     torch.stack([torch.full((edge_n,), big, device=dev),
                                  rand_int(-(1 << 62), 1 << 62,
                                           (edge_n,))])),
    }
    for what, a in seg_edges.items():
        compare("sorted_seg", what, a, CK.sorted_seg, CK.sorted_seg_plain)

    # timings: each kernel at the main path's largest input for it, then
    # the extra shapes -----------------------------------------------------

    def timing(shape, kernel, plain, library, bytes_, ops):
        ms = timer.device(kernel)
        check(ms is not None, f"{shape}: the wrapper blocks the host")
        plain_ms = timer.device(plain)
        plain_timing = "device"
        if plain_ms is None:    # the plain version reads the device
            plain_ms, plain_timing = timer.wrapper(plain), "host-inclusive"
        library_ms = timer.device(library)
        check(library_ms is not None, f"{shape}: library call blocks")
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / SCALAR_OPS_PER_S * 1e3
        out = {"shape": shape, "ms": ms, "wrapper_ms": timer.wrapper(kernel),
               "plain_ms": plain_ms, "plain_timing": plain_timing,
               "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"[time] {shape}: kernel {ms:.4f} ms on the device, "
            f"{out['wrapper_ms']:.4f} ms with the wrapper; plain "
            f"{plain_ms:.4f} ms ({plain_timing}), library call "
            f"{library_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
            f"({out['bound_by']})")
        return out

    def dense_timing(shape, a):
        gid, iv, fv, sel, cells = a
        n, k = gid.shape[0], iv.shape[0] + fv.shape[0]
        keep = sel & (gid >= 0) & (gid < cells)
        g64 = torch.where(keep, gid, cells).to(torch.int64)
        mat = torch.cat([keep.to(torch.int64)[None], iv]).t().contiguous()
        acc = torch.zeros((cells + 1, mat.shape[1]), dtype=torch.int64,
                          device=dev)
        kept = int(keep.sum())
        return timing(
            f"dense_agg {shape}", lambda: CK.dense_agg(*a),
            lambda: CK.dense_agg_plain(*a),
            lambda: acc.index_add_(0, g64, mat),
            # gid and sel of every row, the values of the kept rows only
            # (no other row's values are needed), and the output
            n * (4 + 1) + 8 * k * kept + 8 * (1 + k) * cells,
            kept * (1 + k))

    def seg_timing(shape, a):
        vals, starts, ends, ng, cap = a
        r = vals.shape[0]
        n_groups = int(ng)
        sizes = (ends - starts + 1)[:n_groups]
        n_rows = int(sizes.sum())
        rowgid = torch.repeat_interleave(
            torch.arange(n_groups, device=dev), sizes)
        # the library call's output contract is the kernel's: a count and
        # the sums for every one of the cap slots, zero past n_groups
        seg_src = torch.cat([torch.ones((1, n_rows), dtype=torch.int64,
                                        device=dev), vals[:, :n_rows]]
                            ).t().contiguous()
        return timing(
            f"sorted_seg {shape}", lambda: CK.sorted_seg(*a),
            lambda: CK.sorted_seg_plain(*a),
            lambda: torch.zeros((cap, 1 + r), dtype=torch.int64,
                                device=dev).index_add_(0, rowgid, seg_src),
            # rows read once, 16 B of boundaries per group (the kernel
            # reads none past n_groups), n_groups, the cap-slot outputs
            8 * r * n_rows + 16 * n_groups + 8 + 8 * (1 + r) * cap,
            r * n_rows)

    def probe_timing(shape, a):
        bk, bs, pk, ps, pay = a[:5]
        b, n = bs.shape[0], ps.shape[0]
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        key_bytes = sum(k.element_size() for k in bk)
        pay_bytes = sum(c.element_size() for c in pay)
        n_sel = int(ps.sum())
        # the library call: searchsorted of the raw one-column probe key
        # in the sorted selected build keys, then a gather per column
        bidx = torch.nonzero(bs).flatten()
        order = torch.sort(bk[0][bidx], stable=True).indices
        sk, src = bk[0][bidx][order].contiguous(), bidx[order]
        spay = [c[src].contiguous() for c in pay]
        top = max(sk.shape[0] - 1, 0)

        def library():
            i = torch.searchsorted(sk, pk[0]).clamp(max=top)
            return [c[i] for c in spay]

        # every probe row's selection, match flag and payload values, the
        # key columns of the selected probe rows, the build side
        bytes_ = n * (1 + 1 + pay_bytes) + n_sel * key_bytes \
            + b * (key_bytes + 1 + pay_bytes) + 4
        out = timing(
            f"probe_join {shape}", lambda: CK.probe_join(*a[:5], flag),
            lambda: CK.probe_join_plain(*a[:5], flag), library, bytes_,
            n_sel)   # one table lookup per selected probe row
        # a yardstick: a device copy moving as many bytes (half of them
        # read, half written) under the same timer
        src = torch.empty(bytes_ // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        out["copy_ms"] = timer.device(lambda: dst.copy_(src))
        log(f"[time] probe_join {shape}, a copy of as many bytes: "
            f"{out['copy_ms']:.4f} ms")
        # the operator as it was before the fused kernel (key packing in
        # PyTorch, a zeroed flag, stacked int64 payload, casts back, the
        # flag's compare), with the fused kernel on the prepacked keys,
        # and the executor's sorted lookup (K.join_lookup +
        # K.gather_payload) on the same raw inputs
        names = [f"c{i}" for i in range(len(pay))]

        def old_route():
            ranges = K.key_ranges(bk, bs)
            bp = K.downcast32(K.pack_with_ranges(bk, ranges))
            pp = K.downcast32(K.pack_with_ranges(pk, ranges))
            rows = [c.to(torch.int64) for c in pay]
            stacked = torch.stack(rows) if rows else \
                torch.zeros((0, b), dtype=torch.int64, device=dev)
            has_dup = torch.zeros((1,), dtype=torch.int32, device=dev)
            matched, got = CK.probe_join([bp], bs, [pp], ps, list(stacked),
                                         has_dup)
            return matched, [g.to(c.dtype) for g, c in zip(got, pay)], \
                has_dup[0] != 0

        def sorted_lookup():
            idx, matched, has_dup = K.join_lookup(bk, bs, pk, ps, bits=32)
            return matched, K.gather_payload(dict(zip(names, pay)), idx,
                                              matched), has_dup

        for label, fn in (("old_route", old_route),
                          ("sorted_lookup", sorted_lookup)):
            out[f"{label}_ms"] = timer.device(fn)
            out[f"{label}_wrapper_ms"] = timer.wrapper(fn)
            log(f"[time] probe_join {shape}, {label.replace('_', ' ')}: "
                f"{out[f'{label}_ms']} ms on the device, "
                f"{out[f'{label}_wrapper_ms']:.4f} ms with the host work")
        return out

    def kernels_per_probe_join():
        """Device operations (kernels, fills, copies) of each Q5 probe join
        of the warm-up run, called again on its Lowerer and inputs under
        torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        def device_ops(fn):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            return [e.name for e in prof.events()
                    if e.device_type.name == "CUDA"]

        # the first profiler sessions of a process can miss the card's
        # activity while CUPTI starts: trace one known kernel until the
        # profiler sees it
        probe = torch.zeros(1, device=dev)
        seen = [bool(device_ops(lambda: probe.add_(1))) for _ in range(3)]
        log(f"[profile] warm-up: the profiler saw the device kernel in "
            f"sessions {seen}")

        def join(low, args):
            check(low._probe_join_kernel(*args) is not None,
                  "a Q5 join left the probe-join kernel")

        counts = []
        for low, args in operator_calls:
            for _ in range(5):
                before = CK.LAUNCHES["probe_join"]
                names = device_ops(lambda: join(low, args))
                check(CK.LAUNCHES["probe_join"] - before == 1,
                      "a Q5 probe join did not launch its kernel once")
                # a counted launch with no device activity is a trace the
                # profiler missed, not a join without kernels: trace again
                if names:
                    break
                log("[profile] a counted probe-join launch left no device "
                    "activity in the trace; tracing it again")
            counts.append(len(names))
            log(f"[profile] Q5 probe join (B={args[2].shape[0]}, "
                f"N={args[4].shape[0]}): {len(names)} device "
                f"operation(s): {names}")
        check(counts and all(c == 1 for c in counts),
              f"Q5 probe joins are not one device kernel each: {counts}")
        return counts

    def main_input(name, q, size):
        """The largest input the kernel got on query q's main path."""
        return max((a for qq, a in recorded[name] if qq == q), key=size)

    def dense_size(a):
        return a[1].numel() + a[2].numel()

    # the timer's floor: one tiny op after the L2 flush (the flush leaves
    # dirty lines in L2 that the next op's misses write back)
    one = torch.zeros(1, device=dev)
    timer_floor_ms = timer.device(lambda: one.add_(1))
    log(f"[time] timer floor, one tiny op after the flush: "
        f"{timer_floor_ms:.4f} ms")
    a = main_input("dense_agg", "q1", dense_size)
    report["dense_agg"].update(dense_timing(
        f"Q1: N={a[0].shape[0]} K={a[1].shape[0] + a[2].shape[0]} "
        f"cells={a[4]}", a))
    a = main_input("dense_agg", "q5", dense_size)
    report["dense_agg"]["cases"] = [
        dense_timing(f"Q5: N={a[0].shape[0]} "
                     f"K={a[1].shape[0] + a[2].shape[0]} cells={a[4]}", a),
        dense_timing(one_cell, dense_cases[one_cell])]
    a = main_input("probe_join", "q5",
                   lambda a: a[1].shape[0] * a[3].shape[0])
    report["probe_join"].update(probe_timing(
        f"Q5: B={a[1].shape[0]} N={a[3].shape[0]} P={len(a[4])}", a))
    report["probe_join"]["cases"] = [
        probe_timing(probe_large, probe_cases[probe_large])]
    report["probe_join"]["kernels_per_q5_join"] = kernels_per_probe_join()
    a = main_input("sorted_seg", "q3", lambda a: a[0].numel())
    report["sorted_seg"].update(seg_timing(
        f"Q3: R={a[0].shape[0]} N={a[0].shape[1]} groups={int(a[3])} "
        f"cap={a[4]}", a))
    report["sorted_seg"]["cases"] = [seg_timing(skewed, seg_edges[skewed])]

    # traced last: profiler sessions before the probe-join count above left
    # it with no device events on the card
    if args.profile:
        profile_queries(torch, gpu, {q: tpch.QUERIES[q]
                                     for q in ("q1", "q3", "q5")})
        profile_queries(torch, gds, {
            **{f"tpcds_{q}": tpcds.QUERIES[q] for q in ("q36", "q98")},
            "window_query": tpcds.WINDOW_QUERY.format(
                where="d_year >= 1998")})

    # --------------------------------------------------------- 21. report
    stamp("phase 21 (report)")
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"cloudberry_tpu_torch/csrc/{CK.SOURCES[name]}",
        "replaces": REPLACES[name], "launches": launches[name],
        **report[name]} for name in CK.LAUNCHES]
    for q, ms in {**query_ms, **{f"tpcds {q}": ms for q, ms in
                                 ds_ms.items() if q in WINDOWED}}.items():
        log(f"[time] {q} wall ms {[round(x, 3) for x in ms]} on {kind} "
            f"({smi})")
    check(all(launches[k] > 0 for k in launches),
          f"a kernel never launched on the main path: {launches}")
    print(smi)
    print(json.dumps({"kernels": kernels, "queries_ms": query_ms,
                      "tpcds_ms": ds_ms, "tpcds_launches": ds_launches,
                      "window": window, "growth": growth, "store": store,
                      "admission": admission, "tiling": tiling,
                      "telemetry": telemetry, "stmt_cache": stmt_cache,
                      "distributed": dist, "tiled_distributed": tiled_dist,
                      "recovery": recovery, "sql_surface": sql_surface,
                      "serving": serving, "durability": durable,
                      "hier_motion": hier, "cluster": cluster,
                      "timer_floor_ms": timer_floor_ms, "sf": args.sf,
                      "tpcds_scale": args.ds_scale}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
