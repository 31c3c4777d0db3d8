#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ITR and the paper's
baselines, DLRM serving and training, LM serving and training, GNN training (GCN,
GatedGCN, MeshGraphNet, NequIP).

    python3 chip_smoke.py [--seed 0] [--scale 1.0] [--queries 4096]

Run from the root of a checkout; it imports the port from ``src/`` and
nothing of the JAX package. Phases:

1. build every CUDA kernel from ``src/repro_torch/csrc``, one nvcc each, in
   parallel;
2. hold each kernel against its plain PyTorch twin on the card, on the edge
   cases of its contract: exactly for the integer kernels and for
   ``embedding_bag`` with one row per bag, within a stated tolerance
   otherwise (``flash_attention`` and ``csr_spmm`` in float32 and bfloat16,
   ``flash_attention`` also split and merged at decode and its merge
   kernels on the twin's partials, up to 512 splits, in the plan's chunks
   and forced ones, the path's merge into float32 within 1e-5,
   ``csr_spmm`` also against its split twin on the plan's edges (rows of
   C and C + 1 edges, many just past C, one of hundreds of chunks) and its
   backward against the twin's autograd,
   ``dot_interaction`` against its plain and its tensor-core tiling twin
   on each case's path, read from the launch counts, with a control (the
   last field row zeroed) that must fail; the fused k²-tree descent
   ``k2_lines`` against its level-loop twin, exactly, at k = 2, 3, 4, on
   both axes, the empty tree, random trees up to 100,000 points and one
   row holding 100,000, with 0, 1, 33 and 4,097 fixed values; the build's
   ``digram_pair_accum`` against its twin, the nonzero (key, count) set
   bit for bit, on random ragged batches of node histograms (empty; 20,000
   rows of up to 7 types; 2,000 of 64; 100 of up to 300, past the
   kernel's stage), each with sign +1 and then signed, with a control (one
   row's sign flipped) that must fail, and ``digram_select`` against its
   twin on those tables, with ties, skipped slots (a control with the
   flags cleared must fail) and all counts zero); DLRM training's kernels:
   ``embedding_bag_backward`` on both routes (the one-pass kernel, and the
   two-pass kernel with its combine) against its split twin bit for bit
   and its plain twin within a tolerance on random bags (L 1-8,
   duplicates, padding, long runs of one id), int32 and int64 ids, every
   gathering path (16-byte, 8-byte and scalar pieces, misaligned
   gradients), a batch under one chunk, one id over more chunks than the
   grid holds at once, other plans of the one-pass kernel, sum and mean,
   bf16 and float32, ``dot_interaction_backward`` on both routes (tensor cores:
   bf16 at F 27, 13 and the other instances' 2, 40, 64, 70, against the
   plain and the tiling twin, with a control that drops the split's lo
   term on inputs where lo decides; SIMT: float32, bf16 at D = 24,
   misaligned bf16), each case counted under its route's name, and
   ``sgd_rows`` on registered host buffers (``SGD_CASES``: n_unique 0, 1,
   not a multiple of the rows a warp, equal to cap, 700,000 slots of a
   2M-row master, both host backings) under the wrapper's plan and, on
   bfloat16 tables of D = 128, every instance of the sweep's rows a warp
   on a persistent grid, every row bit for bit, each with a control that
   must fail;
3. drive the ITR path once at full size: geo-coordinates-en (50,000
   triples) -> ``Hypergraph.from_triples`` -> ``compress`` -> ``encode`` ->
   ``TripleQueryEngine`` -> ``query_batch_view`` for all eight patterns,
   every query checked against ``query_oracle`` (a plain scan of the
   triples on the card), with the kernels' launch counts read around it:
   ``digram_pair_accum`` exactly 1 + the replacements (the Count, then one
   Update Count each), ``digram_select`` at least once a replacement, the
   dense ``digram_pair_counts`` 0 times; each of the six batches with S or
   O bound seeds through one count and one write launch of ``k2_lines``,
   and the standalone ``bitvec_rank`` is launched 0 times; the engine's
   crossover calibration (3 worklist queries and 3 one-query frontiers at
   construction) is counted apart: exactly 6 of each ``k2_lines`` launch.
   The inputs of the first 21 accumulations and the last selection's table
   are kept. Then the scalar worklist, the crossover and the paper's
   neighbourhood queries on the same engine: the crossover measured on the
   card and the two best times it came from; ``K2Tree.row`` held against
   its twin on 256 subjects and timed; 128 single queries of each selective
   pattern (s??, ??o, sp?, s?o, ?po, spo) through ``engine.query``, at the
   calibrated crossover (8 if it chose 0) and at 0 (the frontier alone),
   each reading held against the oracle scan, p50/p99 µs per pattern, with
   exactly one ``k2_lines_count`` and one ``k2_lines_write`` a query, one of
   each for the NT-row fill (at most once an engine) and no ``bitvec_rank``;
   ``neighbors_out_batch`` and ``neighbors_in_batch`` over 4,096 nodes drawn
   from the triples (duplicates, a -1 and an id past n_nodes), every list
   equal to the oracle's distinct objects / subjects, duplicates sharing
   one tensor, µs per node, then 128 single ``neighbors_out`` and 128
   ``neighbors_in`` calls, each checked, p50/p99 µs, one of each launch a
   batch or call; controls that must fail: a neighbour list with one node
   dropped, and the worklist with its NT prune inverted on the ?po
   queries. Phase 3's engine has no result cache and no overlay budget;
   3c. the mutable engine at full size on phase 3's grammar, with a
   ``QueryResultCache()``, a delta budget of 4,096 and phase 3's crossover,
   every row drawn from ``--seed``, the launch counts set to 0 before it
   and read after (``k2_lines_count``, ``k2_lines_write``,
   ``digram_pair_accum`` and ``digram_select`` at least once, ``bitvec_rank``
   and ``digram_pair_counts`` never): ``delete_triples`` of 1,536 distinct
   base triples and 256 absent rows, ``insert_triples`` of 1,536 new rows
   (384 with S or O past the base graph's nodes, two at row ``n_rows``) and
   256 visible rows, each ``applied`` equal to the count reckoned in plain
   Python over the logical set, timed with ``_exists_rows``' share; the
   eight patterns over 4,096 rows (1,024 deleted, 1,024 inserted, 2,048
   untouched; 4 for ???) through ``query_batch_view``, cold then warm, each
   against the oracle scan of the logical triple set on the card, the warm
   run hitting every unique pattern within ``max_entry_edges`` and
   launching no ``k2_lines`` kernel; 4,096 neighbourhoods a side against the
   oracle, and ``neighbors_out(-1)`` / ``neighbors_in(-1)`` empty with
   inserts at row ``n_rows``; 128 single s?? queries cold and warm (every
   warm one a hit), p50/p99 and the cache's stats; where a cached batch's
   host time goes; 512 inserts on the warm s?? subjects, after which every
   answer equals the oracle, with a control (``bump_generation`` stubbed
   out) that must serve stale entries; the host syncs (those in the
   overlay merge apart) and busy share of an overlay s?? batch; 1,024
   inserts that pass the budget, so ``insert_triples`` rebuilds on the card
   (timed: compress, encode, the rest): ``rebuild_count`` 1, an empty
   overlay, ``digram_pair_accum`` 1 + the rebuild's iterations and no
   ``digram_pair_counts``, ``base_triples()`` equal to the logical set and
   every pattern equal to the oracle again;
   3d. engine snapshots, ``decode`` and ITR+, the launch counts set to 0
   before it and read after (``k2_lines_count``, ``k2_lines_write``,
   ``digram_pair_accum`` and ``digram_select`` at least once,
   ``bitvec_rank`` and ``digram_pair_counts`` never): a mutable engine on
   phase 3's grammar (a ``QueryResultCache()``, budget 4,096) with 1,536
   deletes and 1,536 inserts (384 past the base's nodes) is saved with
   ``save_snapshot`` into a temporary directory (ms, bytes on disk) and
   opened on the card with ``load_snapshot(mmap=True, verify=True)`` (ms,
   beside phase 3's compress + encode): every state tensor (start graph,
   flat CSR, k²-tree levels, Elias–Fano parts, δ streams, overlay rows) and
   scalar (crossover, delta budget, base edges, rebuild count) equal to the
   saved engine's, no ``k2_lines`` launch; the eight patterns over 4,096
   rows (deleted, inserted, untouched) against the oracle scan of the
   logical set, one ``k2_lines_count`` and one ``k2_lines_write`` a S/O
   batch and no ``bitvec_rank``; the opened engine saved again equal to
   the first directory byte for byte; ``encoded.decode()`` equal to the
   opened grammar and passing ``validate()``, with one ``k2_lines`` pair,
   its seconds split into the host δ decode and the rest; a flipped byte,
   a removed array file and a removed manifest must each make the open
   raise ``SnapshotError``; a crash injected at ``engine.rebuild`` must
   leave the answers (cache detached) and ``rebuild_count`` unchanged; the
   opened engine's ``rebuild()`` (``digram_pair_accum`` 1 + its
   iterations, ``rebuild_count`` + 1, every pattern equal to the oracle);
   a crash injected at ``snapshot.pre_commit`` while overwriting must
   leave the first save's files and a ``.tmp`` orphan that the next save
   clears; then ``chess-legal`` at scale 0.5 (38,129 triples, 34,317 of
   them labelled with 13 labels; scale 1.0 until phase 7c) built on the card without and
   with ``attach_node_labels`` (seconds, encoded bytes, ``digram_pair_accum``
   1 + iterations each), the ITR+ grammar equal to the port's CPU build,
   ``strip_node_labels`` of its decompression giving back the labels and
   the triples, both dictionary costs, and the eight patterns over 4,096
   edges of the ITR+ hypergraph equal to a plain scan of it, rank-1 label
   edges included;
   3e. BGP joins, N-Triples ingestion, the term dictionary and
   ``GraphStore``, the launch counts set to 0 before it and read after
   (``k2_lines_count``, ``k2_lines_write``, ``digram_pair_accum``,
   ``digram_select`` and ``csr_spmm`` at least once, ``bitvec_rank`` and
   ``digram_pair_counts`` never): on an engine over phase 3's grammar (a
   ``QueryResultCache()``, phase 3's crossover) the reference benchmark's
   and the slice's BGP shapes (chains, stars, a 2-cycle, a predicate
   variable, and one with a constant subject whose sub-batches go to the
   worklist), each cold, warm, with every step forced to bind, forced to
   scan, and in reversed order, every result equal to a host oracle written
   here (plain hash joins over dicts of the triples), with a control (one
   binding row dropped) that must fail; the join layer's host syncs a step
   by kind, ``batch_fn``'s apart (at most ``JOIN_STEP_SYNCS`` each), the
   busy share; single steps with ``batch_fn`` replaying a view computed
   beforehand, their syncs by the debug mode and by the profiler's CUDA
   runtime calls, which must not depend on the step's combos and entries;
   three shapes again after 1,536 deletes and 1,536 inserts,
   against the oracle of the logical set. Then geo-coordinates-en written
   as N-Triples with ``write_ntriples`` (IRIs with long shared prefixes,
   seven junk lines), ``scan_predicates``, and ``ingest_file`` into an
   empty engine on the card at batch 4,096 and budget 4,096, so it
   rebuilds on its own (rows/s, rebuilds and their seconds): the logical
   set through the dictionary equal to the file, ``IngestStats`` equal to
   a plain count (junk lines counted), 256 S-bound and 256 O-bound
   ``query_strings`` and every shape through ``query_bgp_strings`` equal to
   a string oracle, unknown terms answering ``[]`` with no launch, µs a
   ``term_to_id`` / ``id_to_term`` and bytes a term of the live and the
   compacted dictionary, ``save_term_dict`` -> ``load_term_dict`` and
   ``compacted()`` keeping every id. Then ``GraphStore.from_triples`` on the
   card: ``csr``, ``csc`` and ``edge_index`` equal to a plain sort of the
   triples, again after 256 inserts and 256 deletes (views dropped and
   rebuilt), 1,024 neighbourhoods a side equal to the oracle, and one
   ``csr_spmm`` over its CSC (D 16, float32) against the kernel's plain and
   split twins;
   3f. the sharded serving tier (``ShardedTripleService``) on phase 3's
   triples, the launch counts set to 0 before it and read after
   (``k2_lines_count``, ``k2_lines_write``, ``digram_pair_accum`` and
   ``digram_select`` at least once, ``bitvec_rank`` and
   ``digram_pair_counts`` never): ``build`` for ``predicate_hash`` and
   ``node_range`` at P = 1, 2, 4 (seconds, shard sizes, the shards' union
   equal to the triples, ``digram_pair_accum`` exactly the sum over shards
   of 1 + iterations), each with a shared ``QueryResultCache`` of 16,384
   general entries, budget 4,096 and phase 3's crossover, then the
   reference benchmark's mixed cycle (s??, sp?, ?p?, ??o) over 4,096 rows,
   cold and warm, against the oracle scan (the warm pass launches
   nothing); ?p? under node_range and ??o under predicate_hash at P = 4,
   4,096 patterns, caches detached, beside phase 3's engine, with the pool
   at 1 and 4 threads (views equal tensor for tensor), the flush's own host
   syncs (debug mode, the engines' batches apart) at 256 and 4,096
   patterns (they must be equal), the busy share, and a control (merged
   entries without their last shard's chunk) that must fail; phase 3e's
   nine BGP shapes through both P = 4 tiers against its host oracle, a warm
   repeat from the merged BGP cache with no launch; 1,536 deletes and
   1,536 inserts on the predicate_hash tier over three of its four
   predicates (only those shards' generations move; the fourth shard's
   warm patterns all hit with no launch), the answers against the oracle
   of the logical set, ``rebuild(shard=k)`` timed against a full build of
   the mutated set; 12,288 rows with subjects past every id inserted in
   batches of 4,096 (1,024 until phase 9) with the trigger at 1.5: on node_range the trigger
   fires, each write drains at most 4,096 migration rows (ms a migration
   batch), the eight patterns over 512 rows (half of them in motion)
   equal the oracle after every batch, 64 rows deleted in motion stay
   deleted, routing by the outgoing plan alone mid-migration must answer
   wrongly (a control), an explicit ``rebalance()`` drains the rest and
   every shard then holds exactly what the plan gives it; on
   predicate_hash (one predicate grows) the re-cut moves nothing and the
   backoff holds; shard 1 of the node_range tier failed (answers equal the
   oracle without its rows, the degraded patterns counted, writes and
   rebalance refused) and reingested; the N-Triples file into an empty
   P = 4 tier (``n_nodes`` 1) through ``ingest_file`` (``IngestStats``
   equal to a plain count), 32 S-bound and 32 O-bound ``query_strings``
   against the string oracle, an unknown term launching nothing; then 4
   reader threads, a churn writer and a rebalancer for 1 s on each P = 4
   tier (10 s until phase 3g came, 5 s until 7c, 2 s until 9), every answer checked as
   the reference's stress machine checks
   it (queries/s, p50/p99 ms), the launch counts equal to what the
   threads counted themselves;
   3g. the durable tier (``DurableShardedService``) on phase 3's triples
   at P = 4, each tier in a fresh temporary root on local disk with fsync
   on, the launch counts set to 0 before it and read after
   (``k2_lines_count``, ``k2_lines_write``, ``digram_pair_accum`` and
   ``digram_select`` at least once, ``bitvec_rank`` and
   ``digram_pair_counts`` never), every answer held against the oracle
   scan of the logical set over phase 3f's 4,096 picked rows (or 256 and
   the batch at hand between crash points) and all eight patterns: (a)
   ``build`` for both strategies (s, the initial snapshot's s and bytes,
   the WAL's bytes); (b) phase 3f's 1,536-row delete and insert batches on
   the tier alone, durably with fsync off and on (ms), the appends' own
   µs and 64 appends of the record a setting (p50/p99), the host syncs a
   256-row insert makes on the tier and durably, given numpy rows and a
   card tensor (the durable layer adds none beyond the tier's own copy);
   (c) the node_range tier grown by phase 3f's growth rows with the
   trigger at 1.5 and ``migrate.mid_apply`` armed, killed inside the first
   migration batch, ``open`` (s split into loading and replay, records/s,
   launches) resuming the migration, the killed write's rows all there,
   the rest drained, every shard holding what its plan gives it; (d) the
   nine injection points of ``tests/test_crash_oracle.py``, once each,
   chained on that tier, each held to that test's contract; (e) snapshot
   and compaction (s, bytes), ``open`` with no ``k2_lines`` launch and
   every state tensor and scalar of every shard equal to the live tier's,
   and the directory opened with ``device="cpu"`` answering 256 patterns
   as the card does; (f) ``python -m repro_torch.launch.itr_durable``
   opening the tier on the card and writing 512-row batches until it is
   sent ``SIGKILL`` after an acknowledgement in ``KILL_AFTER``: every
   acknowledged batch recovered, the batch in flight all or nothing; (g)
   on the predicate_hash tier, one replica group's seed s and device
   bytes, two groups tailing 8 logged writes (sync s; each group and the
   primary against the oracle), the lag gate (``max_lag=0``: a pending
   record's read served by the primary), a reseed after ``snapshot()``,
   and 1 s (2 s until phase 9) of 4 readers (S-bound patterns, each answer checked) beside a
   durable writer with 0 and 2 groups (queries/s, p50/p99 ms,
   ``replica_flushes``). Controls that must fail: a copy of the root with
   the WAL's last intact frame cut (it recovers without that batch, so
   the oracle holding it disagrees), a group whose cursor skipped a
   record (its answers differ), a flipped byte in one shard's snapshot
   (that shard degrades, a write routed to it raises);
   3h. the paper's baselines and the loop ablation on phase 3's triples,
   the launch counts set to 0 before it and read after (``bitvec_rank``
   and ``k2_lines_count`` at least once): ``K2Triples`` (a k²-tree a
   predicate) and ``HDTBitmapTriples`` built on the card (s), each
   ``size_in_bytes()`` equal to the port's CPU build's, beside phase 3's
   ITR encoded bytes and ``ntriples_size_bytes`` (the paper's Table 1a
   ratios); 128 queries a pattern of phase 3's picked rows (16 for ?p?, 4
   for ???) through each ``query``, every answer sorted equal to a plain
   scan of the triples, p50 / p99 µs beside phase 3's ``engine.query``
   singles, host syncs a query (sync debug mode) and the ``bitvec_rank``
   and ``k2_lines`` launches by pattern; a control (one ``Bo`` bit flipped
   in a copy of HDT-BT) that must fail; ``loop_rule_transform`` of phase
   3's grammar and of chess-legal's ITR grammar (phase 3d's): loop edges,
   rules added, encoded bytes with index-functions and with loop rules,
   the transform's s, no loop edge left, the decompression's edge set
   equal on the card and the grammar equal to the port's CPU transform;

4. time each kernel on the inputs its path gave it, beside its plain twin,
   a PyTorch library call where one computes the same function, and its
   least possible time (bytes at 3.35 TB/s or operations at the card's
   peak, whichever is larger): ``digram_pair_accum`` held against its twin
   over those 21 calls (a control must fail) and timed at the initial
   Count and a replacement, ``digram_select`` on the build's last table,
   the dense ``digram_pair_counts`` (off the path) on the initial Count's
   rows grouped by length, ``bitvec_rank`` on the per-level inputs of the
   level loop (the per-level seed) at the s?? batch, ``k2_lines`` on that
   batch, as the wrapper runs it and each pass's device time, beside its
   twin and that per-level path;
5. break the ITR path's time down: warm query repeats, the k² seed and
   its host syncs (exactly 1), the initial Count, the device's busy share
   (``torch.profiler``), the host syncs (torch's sync debug mode; a lower
   bound) of the batches and of ``compress``, those of the counter's
   Update Count and selections, the device time a launch of the two
   digram kernels in ``compress``, and the same build and s?? batch with
   ``device="cpu"`` as a host yardstick, whose grammar must equal the
   card's bit for bit (stats, label ranks, start graph, every rule);
6. serve ``dlrm-mlperf`` at its full published size (177,948,416 table rows
   x 128 in bfloat16 on the card) through ``build_cell`` under
   ``serve_p99`` (p50/p99 latency over 200 batches of 512), ``serve_bulk``
   (samples per second at 262,144 a batch) and ``retrieval_cand`` (ms per
   query against 1,000,192 candidates), with the launch counts of
   ``embedding_bag`` and ``dot_interaction`` read around each serve path's
   run; the kernel path is held against the twin path on the serve_p99
   batch and on the first 4,096 samples of the serve_bulk batch, and a
   small model against the same model on the host CPU. The timing
   rows of both DLRM kernels (phase 4) are taken here, while the model is
   on the card: ``dot_interaction`` at the serve_bulk fields and at a
   serve_p99 batch's, beside two ``torch.bmm`` yardsticks (fp32 upcast;
   bf16 with float32 output), a sweep of its launch plan, its HMMA count
   (SASS), and the device time of the two ``torch.cat`` passes around it;
   6b. with the serve tables freed, train ``dlrm-mlperf`` at full size
   (``train_batch``: B = 65,536, the bf16 tables on the card, their float32
   master, 91.1 GB, registered in host memory) through ``build_cell``: the
   host probe (memory, cgroup, PCIe link, huge-page mode, NUMA, IOMMU)
   and the master's pages on its host backing, init and registration
   seconds;
   one step with the launch counts at 0 before it (each of the five
   kernels of the step exactly once; the SIMT interaction kernels, forward
   and backward, and the two-pass backward and its combine never); the step held against the same step
   through the twins from one snapshot (loss, lr, grad_norm, the compact
   gradient, the touched rows' master and bf16 values, the MLP leaves),
   the kernel step's rows equal to ``sgd_rows_ref`` of its own gradient
   bit for bit and 100,000 untouched rows unchanged bit for bit; every
   touched row's gradient within the bound that the paths' own dz and
   field differences and bf16 roundings allow, with 26 planted faults (a
   field's gradient dropped) that must break it; ``sgd_rows`` on the
   step's own compact gradient and the model's master at lr 0.05, clip
   0.3, the touched rows bit for bit against ``sgd_rows_ref``, most rows
   moved, a control (clip left out) that must fail; 10 timed
   steps after 2 warm-ups (ms, samples/s), the step timed with each
   ``dot_interaction_backward`` route and with each
   ``embedding_bag_backward`` route in turns (20 steps a route, one traced
   step each), the busy share, host syncs a step (at most 2), device time by kernel, peak memory; phase 4's rows
   of the training kernels (``embedding_bag_backward``: the one-pass
   kernel bit for bit against its split twin on the step's own bags, the
   wrapper, the two-pass route, the sort, ``index_add_`` and an
   ``index_select`` gather in turns, device time by kernel, a plan sweep
   with occupancy; ``dot_interaction_backward`` on the tensor
   cores beside its SIMT route, a plan sweep and its occupancy;
   ``sgd_rows`` with its occupancy, beside its read and write halves, a
   page probe and the link while it runs);
   then the master is released;
7. with the DLRM tables freed, serve ``qwen2-1.5b`` at full width (28
   layers, d_model 1536, 12 query and 2 KV heads of 128, vocab 151,936):
   a small model on the card against the host CPU; the full-width model in
   float32, kernel path against twin path (logits and 8 greedy tokens);
   ``lm_serve`` (``ServeEngine.generate`` on 8 prompts of 256-2048 ids, 64
   greedy tokens, cache of 4,096, exactly 28 x 65 ``flash_attention``
   launches and 28 x 64 of its merge, one a decode layer), held against
   its twin path; ``prefill_32k`` (batch 4, no merge) and ``decode_32k``
   (batch 64, a 60.1 GB cache filled on the card, 28 merges a step)
   through ``build_cell``. Each bfloat16 path check is read beside a
   witness (p unrounded) and a control (first K/V tile dropped) that must
   fail it. The ``flash_attention`` row is timed at one layer of the
   ``lm_serve`` prefill, of ``prefill_32k`` (the twin on its last 512
   query rows) and of ``decode_32k``, beside its twin and
   ``scaled_dot_product_attention`` as the library yardstick; at each, the
   kernel is held against its twin on those inputs, in bfloat16 and in
   float32, and the control must fail the float32 comparison. At
   ``decode_32k`` the split count is swept (1, half the plan, the plan,
   twice it) and the merge kernel gets its own row: against the twin's
   merge (bfloat16, and float32 within 1e-5), a repeat bit for bit, a
   control (a chunk of a row's splits left out) that must fail, timed in
   turns against the first merge (``flash_attention_combine_rowwise``, off
   the path), whose own row says it launched 0 times on every path;
   7b. the rest of the LM zoo at full width, one arch at a time, each
   freed before the next (at most 1 GiB allocated at each start):
   ``gemma2-9b`` (alternating 4,096-window local and global layers, D =
   256, soft-caps 50 and 30, post-norms), ``olmoe-1b-7b`` (64 experts, top
   8), ``yi-34b`` (56 query heads over 8 KV heads) and
   ``phi3.5-moe-42b-a6.6b`` (16 experts, top 2; 24 of its 32 layers, its
   83.7 GB of bf16 weights not fitting whole). For each: its reduced
   config on the card against the host CPU; the full-width float32 model
   (Gemma-2 and OLMoE 8 layers, yi and phi 4) kernel path against twin
   path on one prompt (logits and 8 greedy tokens); ``lm_serve`` (8
   prompts, 4 for yi, the MoE archs' longest exactly 2,048 so that B x plen
   keeps the group rule; 32 greedy tokens) with exactly L x 33 ``flash_attention`` launches
   and a merge for each call whose own plan splits, held against the twin
   path (MoE routing replayed from the kernel path, the flips counted);
   ``prefill_32k`` (Gemma-2 and OLMoE batch 2, yi 1) and ``decode_32k``
   (Gemma-2 4, OLMoE 12, yi 1, phi 2) through ``build_cell``; one MoE
   layer's router logits, routing and output, card against host, with a
   capacity control; the ``flash_attention`` row at Gemma-2's local and
   global layers of both cells (SDPA has no soft-cap: it is timed without
   it, beside) and at yi's decode layer; both merges at each arch's first
   ``decode_32k`` layer, on the attention kernel's own partials, as at
   ``decode_32k``;
   7c. LM training (at most 1 GiB allocated at its start and end): (a) the
   forward's log-sum-exp and the backward's two launches
   (``flash_attention_bwd_dq``, which forms delta, then ``_dkdv``, in that
   order) against their twins, the delta the dq launch writes into a
   buffer of NaNs within 1e-5 of the twin's largest |delta| (a control
   with its last 8 columns dropped must fail), and the standalone
   ``flash_attention_bwd_delta`` (off the path) with dq reading it,
   at D 8 to 256, GQA groups 1, 6 and 7, lengths off the tiles, q_offset
   off Sk - Sq (rows past the keys and rows that see no key), windows 1, 7
   and 4,096 at S = 8,192 and a cap of 50, float32 and bfloat16 (bfloat16
   within 2^-6 of the largest |want| or twice the witness with p
   unrounded), with two controls that must fail the float32 comparison
   (the last key tile's dK / dV dropped, the cap's derivative left out);
   (b) the reduced ``train_4k`` cell of all five LM archs, card against
   host CPU over 3 steps, and ``launch.train --reduced --steps 4`` run
   twice (the second restores the first's checkpoint and continues); (c)
   ``qwen2-1.5b``'s ``train_4k`` at full width and depth (28 layers, bf16,
   S = 4,096), its global batch of 256 cut to 8 in its 4 micro-batches:
   the float32 model (2 layers, one sequence) kernel path against twin
   path (every leaf within 1e-4 of its max|g|), then one step's loss,
   grad_norm and every leaf's gradient against the twin path beside a
   witness (p unrounded in both passes) with a control (delta left out)
   that must fail, exactly 2 x 28 x 4 forward launches and 28 x 4 of the
   dq and dK/dV launches, dq first in each call, none of the standalone
   delta, two gradient passes bit-identical under deterministic
   algorithms, then 3 timed steps after a warm-up (s a step, tokens/s),
   the last under the profiler (busy share, device ms by kernel), and the
   peak memory; (d)
   ``gemma2-9b`` at full width, 2 of 42 layers, batch 8 in its 8
   micro-batches (D = 256, soft-capped), kernel path against twin path,
   and the four full-size cells that do not fit one card refusing with
   their bytes and nothing allocated; (e) the backward kernels' rows at
   qwen2's layer, Gemma-2's global layer and yi's (group 7): each kernel's
   ms, the twin's, SDPA's backward through autograd and the bound from
   this run's visible pairs; the dq launch that forms delta beside dq
   reading delta plus the standalone delta pass on the same inputs, in
   turns, and ``torch.bmm`` of dO by O (float32 sums) as delta's library
   call;
8. with the LM freed, train ``gcn-cora`` (2 layers, hidden 16): three
   ``Trainer`` steps on ``full_graph_sm`` (Cora's 2,816 x 1,433) on the
   card against the same on the host CPU; then ``ogb_products`` at full
   size (2,449,152 nodes, 61,859,140 heavy-tailed edges, 100 features, 47
   classes) through ``build_cell``: exactly 4 ``csr_spmm`` launches a step
   (2 forward, 2 on the transposed CSR in the backward) and 4 of its
   combine, 10 timed steps, the profiler's busy share, the kernel held
   against its twin and its split twin on the four launches' own inputs
   (a control with the last edge of each row dropped must fail) and timed
   beside its twin, ``torch.sparse.mm``, its bound and the bytes with no
   reuse of an x row, a sweep of the plan's chunk size and the time with
   the rows of more than 1,024 edges emptied, the combine on the split
   twin's partials, the kernel's gathers in a row (SASS), the kernel path
   against the twin path, and two steps from one state bit-identical.
   8b. the reference example's training path (``launch/gnn_compressed``)
   on phase 3's graph under phase 8's memory rule (at most 1 GiB
   allocated at its start and end): a ``GraphStore`` built anew (s),
   ``csc()`` ms, ``NeighborSampler`` with fanouts (15, 10) and 1,024 seeds
   (ms and host syncs a sample, nodes and edges) and its invariants
   checked on the card (every edge a CSC edge, no repeated pair, fanouts
   kept, ``node_ids`` sorted, unique, holding the seeds) with a planted
   non-edge that must fail; GatedGCN at full width (16 layers, 70 wide)
   on ``minibatch_lg``'s batch shape (602 features, 41 classes, 46,108 x
   168,960 padded): one step's loss and gradients against the twin path,
   exactly 64 ``csr_spmm`` launches and 32 combines a step, the kernel at
   the edge-id CSR and its transpose beside its twin and
   ``torch.sparse.mm``; the reduced config on the example's sizes, card
   against host CPU over 3 steps; a schedule shorter than the example's
   (80 steps, checkpoints every 20, a failure at 50, a fresh model
   restored from step 40 bit for bit against the host copy that save took,
   run to 80,
   the loss falling; a checkpoint leaf altered on disk must fail), with
   step, save, write and restore ms; 10 steps each with ``int8`` and
   ``topk`` gradient compression (decoded gradients equal to the CPU
   codec's); steps with an async save in flight against none.
   8c. the rest of the GNN zoo through ``build_cell`` at full width, every
   registry cell that fits one card besides phase 8's: ``gcn-cora`` at
   ``minibatch_lg`` and ``molecule``; GatedGCN (16 x 70), MeshGraphNet (15
   blocks x 128) and NequIP (5 layers, C = 32, l <= 2) at ``full_graph_sm``,
   ``minibatch_lg`` and ``molecule``, one cell at a time, each freed before
   the next (at most 1 GiB allocated at its start and end). First the three
   ``ogb_products`` cells that do not fit (GatedGCN, MeshGraphNet, NequIP)
   must raise ``ValueError`` naming their bytes with nothing allocated;
   then one Chung-Lu graph of Reddit's size (232,965 nodes, 114,615,892
   edges) is drawn and its CSC sorted once (s, peak) and shared by the
   ``minibatch_lg`` cells (1,024 seeds at fanouts (15, 10), padded to
   169,984 x 168,960 with edges -1 at both ends). For each cell: (a) the
   reduced cell on the card against the host CPU over 3 steps; (b) one
   full-width step's outputs, loss and gradients against the same step with
   every aggregation summed in float64, with a control (each row's last
   edge dropped) that must fail; (c) exactly 4 / 64 / 30 / 10 ``csr_spmm``
   launches a step (GCN / GatedGCN / MeshGraphNet / NequIP) and the
   combines the CSRs' plans imply; (d) ms a step (median of 5 after a
   warm-up), busy share, device ms by kernel and peak memory; (e)
   ``csr_spmm`` at each width of the step (GCN 16 and 41 or 1, GatedGCN 70,
   MeshGraphNet 128, NequIP 416, its three sums in one launch), forward and
   transposed, against its float64 twin and split twin, beside its twin and
   ``torch.sparse.mm``; NequIP at ``molecule`` also keeps its energies under
   rotations plus translations, and a shear must move them.
9. the one-card dry-run (``repro_torch.launch.dryrun``) at full size,
   with the launch counts set to 0 before each part and read after: (a)
   ``cell_specs`` of all 40 registry cells on both production meshes, (16,
   16) and (2, 16, 16), with ``memory_allocated`` unmoved, printing each
   mesh's largest per-device argument bytes and its cell; (b) ``run_cell``
   on the seven cells that ``build_cell`` refuses (the four LM ``train_4k``
   cells that do not fit and the three ``ogb_products`` ones): each a
   record naming more bytes than one card, with no device byte allocated;
   (c) ``partitioned_segment_sum`` on the card over ``partition_edges``'
   output (8 shards; 46,108 nodes, 168,960 edges, one row of 2,000, D =
   70), exactly one ``csr_spmm`` launch and the combine its plan calls for,
   against its plain twin and a float64 host sum within 1e-5 x max|want|,
   with a control (one receiver moved) that must fail; (d) ``run_cell`` on
   the two registry cells no other phase builds on the card, each built,
   run for two timed steps and one under ``op_cost``, and freed:
   ``gcn-cora`` at ``full_graph_sm`` (exactly 4 ``csr_spmm`` a step and
   the combines its CSRs' plans call for, in every step and in
   ``unseen_launches``) and ``qwen2-1.5b`` at ``long_500k`` (batch 1,
   524,288 positions: 15.03 GB of bfloat16 cache and 3.55 GB of weights;
   exactly 28 ``flash_attention`` launches a step and a merge for each
   split call; the split plan, its blocks a SM, finite logits, and one
   layer's attention against ``flash_attention_ref`` at 524,288 keys within
   phase 7's bfloat16 bound, with a control, the twin over the first half
   of the keys, that must fail; both merges on that layer's 512 splits as
   at ``decode_32k``, the merge by chunk count, and the merges' device
   time in a profiled step).

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
Without a CUDA device, or without ``src/repro_torch`` beside it, it exits 2.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
PCIE_BYTES_PER_S = 64e9       # PCIe Gen5 x16, the H100 SXM's host link, each way
CORE_OPS_PER_S = 67e12        # H100 SXM rate outside the tensor cores (fp32 table entry)
DEV = "cuda"
PATTERNS = ("s??", "?p?", "??o", "sp?", "s?o", "?po", "spo")
K2_NAMES = ("bitvec_rank", "k2_lines_count", "k2_lines_write")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def check_kernels(torch, np, seed: int) -> dict:
    """Phase 2: each kernel equals its plain twin on the card, exactly."""
    from repro_torch.core.succinct.bitvector import BitVector
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitvec_rank import bitvec_rank_cuda
    from repro_torch.kernels.digram_count import digram_pair_counts_cuda

    rng = np.random.default_rng(seed)
    err = {"bitvec_rank": 0, "digram_pair_counts": 0}
    n_cases = 0
    for nbits in (1, 32, 33, 4096, 100_003):
        bits = rng.integers(0, 2, nbits)
        bits[: min(nbits, 64)] = 1  # whole words with the top bit set
        bv = BitVector(torch.from_numpy(bits).to(DEV))
        bv.rank1(torch.zeros(1, dtype=torch.int64, device=DEV))  # builds _rank_words
        words, ranks = bv._rank_words, bv.word_ranks
        for q in (0, 1, 255, 257, 1000, 4097):
            pos = torch.from_numpy(rng.integers(0, nbits + 1, q)).to(DEV)
            if q:
                pos[-1] = nbits  # pos == n
            got = bitvec_rank_cuda(words, ranks, pos)
            want = ref.bitvec_rank_ref(words, ranks, pos)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                _fail(f"bitvec_rank differs from its twin at nbits={nbits} q={q}")
            if q:
                err["bitvec_rank"] = max(err["bitvec_rank"],
                                         int((got - want).abs().max()))
            n_cases += 1
    for k in (1, 2, 7, 64):
        for n in (1, 1001, 4099):
            its = rng.integers(0, 50, (n, k)).astype(np.int32)
            cnts = rng.integers(1, 10, (n, k)).astype(np.int32)
            pad = rng.random((n, k)) < 0.3
            its[pad] = -1
            cnts[pad] = 0
            its_t, cnts_t = torch.from_numpy(its).to(DEV), torch.from_numpy(cnts).to(DEV)
            got = digram_pair_counts_cuda(its_t, cnts_t)
            want = ref.digram_pair_counts_ref(its_t, cnts_t)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if g.shape != w.shape or not torch.equal(g, w):
                    _fail(f"digram_pair_counts differs from its twin at K={k} N={n}")
                err["digram_pair_counts"] = max(err["digram_pair_counts"],
                                                int((g - w).abs().max()))
            n_cases += 1
    print(f"kernels_vs_plain cases={n_cases} exact=True")
    return err


def check_k2_lines(torch, np, seed: int) -> dict:
    """Phase 2: the fused k²-tree descent equals its level-loop twin on the
    card, exactly: k = 2, 3, 4, both axes, the empty tree, random trees up
    to 100,000 points, one line holding every point, batches of 0, 1, 33
    and 4,097 fixed values with out-of-range values and duplicates."""
    from repro_torch.core.succinct import K2Tree
    from repro_torch.kernels import ref
    from repro_torch.kernels.k2_lines import k2_lines_cuda

    rng = np.random.default_rng(seed)
    trees = []
    for k, n_rows, n_cols in ((2, 5000, 3000), (3, 2000, 7000), (4, 4096, 4096)):
        for n_pts in (0, 1000, 100_000):
            r, c = rng.integers(0, n_rows, n_pts), rng.integers(0, n_cols, n_pts)
            trees.append((f"k={k} {n_rows}x{n_cols} points={n_pts}", r, c, n_rows, n_cols, k))
        trees.append((f"k={k} one row of 100000 points", np.full(100_000, 7),
                      np.arange(100_000), 16, 100_000, k))
    n_cases = results = heaviest = 0
    for what, r, c, n_rows, n_cols, k in trees:
        tree = K2Tree(torch.from_numpy(r).to(DEV), torch.from_numpy(c).to(DEV),
                      n_rows, n_cols, k=k, device=DEV)
        lay = tree.layout()
        for axis, n in ((0, n_rows), (1, n_cols)):
            for q in (0, 1, 33, 4097):
                fixed = rng.integers(-2, n + 2, q)
                if q:
                    fixed[0] = 7 if axis == 0 else 0  # the heavy row, or a line crossing it
                if q > 2:
                    fixed[1:3] = fixed[0]  # duplicates
                fixed = torch.from_numpy(fixed).to(DEV)
                got = k2_lines_cuda(lay, fixed, axis)
                want = ref.k2_lines_ref(lay, fixed, axis)
                torch.cuda.synchronize()
                if not all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want)):
                    _fail(f"k2_lines differs from its twin on {what}, axis={axis}, Q={q}")
                n_cases += 1
                results += got[0].numel()
                if got[0].numel():
                    heaviest = max(heaviest, int(torch.bincount(got[0]).max()))
    print(f"k2_lines kernels_vs_plain cases={n_cases} exact=True results={results} "
          f"heaviest_line={heaviest}")
    return {"k2_lines_count": 0, "k2_lines_write": 0}


def _table_items(torch, t):
    """(keys, counts) of a DigramTable's keys whose count is not 0, keys
    ascending: what a hashed table and the twin's sorted one share."""
    ok = t.counts != 0
    keys, counts = t.keys[ok], t.counts[ok]
    order = torch.argsort(keys)
    return keys[order], counts[order]


def _same_items(torch, a, b) -> bool:
    (ka, ca), (kb, cb) = _table_items(torch, a), _table_items(torch, b)
    return ka.shape == kb.shape and torch.equal(ka, kb) and torch.equal(ca, cb)


def _hashed_for(calls):
    """An empty hashed DigramTable with room for every pair of `calls` at
    the counter's load."""
    from repro_torch.core.digram import LOAD, MIN_SLOTS
    from repro_torch.kernels.digram_count import DigramTable

    pairs = 0
    for row_ptr, _, _, _ in calls:
        lens = row_ptr[1:] - row_ptr[:-1]
        pairs += int((lens * (lens + 1) // 2).sum())
    return DigramTable.hashed(max(MIN_SLOTS, int(pairs / LOAD) + 1), row_ptr.device)


def _hold_accum(torch, calls, what: str) -> tuple:
    """Run `calls` (row_ptr, its, cnts, sign), in order, through
    ``digram_pair_accum`` into a hashed table and through its twin into a
    sorted one on the card; the nonzero (key, count) sets must be equal,
    bit for bit, after each. A control, the twin with the sign flipped in
    the last call's last row whose counts sum to 2 or more (so some pair of
    it is not 0), must differ. Returns the two tables."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.digram_count import DigramTable, digram_pair_accum_cuda

    kern, twin = _hashed_for(calls), DigramTable.sorted(DEV)
    for i, call in enumerate(calls):
        digram_pair_accum_cuda(kern, *call)
        ref.digram_pair_accum_ref(twin, *call)
        torch.cuda.synchronize()
        if int(kern.used[0]) > kern.capacity or not _same_items(torch, kern, twin):
            _fail(f"digram_pair_accum differs from its twin on {what}, call {i}")
    row_ptr, its, cnts, sign = calls[-1]
    lens = row_ptr[1:] - row_ptr[:-1]
    row = torch.repeat_interleave(torch.arange(lens.numel(), device=lens.device), lens)
    sums = torch.zeros_like(lens).index_add_(0, row, cnts.to(torch.int64))
    counting = torch.nonzero(sums >= 2).reshape(-1)
    if counting.numel():
        flipped = sign.clone()
        flipped[counting[-1]] *= -1
        control = DigramTable.sorted(DEV)
        for call in calls[:-1]:
            ref.digram_pair_accum_ref(control, *call)
        ref.digram_pair_accum_ref(control, row_ptr, its, cnts, flipped)
        if _same_items(torch, kern, control):
            _fail(f"digram_pair_accum's control (one row's sign flipped) passed on {what}")
    return kern, twin


def _hold_select(torch, t, what: str, control: bool) -> None:
    """``digram_select`` against its twin on the hashed table `t`: key,
    count, slot and occupancy equal; with `control`, the twin on the table
    with its flags cleared must differ."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.digram_count import DigramTable, digram_select_cuda

    got = digram_select_cuda(t).tolist()
    want = ref.digram_select_slot_ref(t).tolist()
    if got != want:
        _fail(f"digram_select differs from its twin on {what}: {got} vs {want}")
    if control:
        cleared = DigramTable(t.keys, t.counts, torch.zeros_like(t.flags), t.used, t.scratch)
        if ref.digram_select_slot_ref(cleared).tolist() == got:
            _fail(f"digram_select's control (flags cleared) passed on {what}")


def _random_csr(torch, np, rng, n_rows: int, max_k: int, signed: bool, full: bool = False):
    """A ragged CSR of node histograms on the card: distinct types a row
    (of 1,000), counts 1..9, a fifth of the rows empty, every row of
    `max_k` items when `full`; signs +1, or random with `signed`."""
    lens = np.full(n_rows, max_k) if full else rng.integers(0, max_k + 1, n_rows)
    lens[rng.random(n_rows) < 0.2] = 0
    its = np.concatenate([rng.choice(1000, k, replace=False) for k in lens] + [[]])
    cnts = rng.integers(1, 10, its.size)
    sign = rng.choice([-1, 1], n_rows) if signed else np.ones(n_rows)
    row_ptr = np.concatenate([[0], np.cumsum(lens)])
    return (torch.from_numpy(row_ptr.astype(np.int64)).to(DEV),
            torch.from_numpy(its.astype(np.int32)).to(DEV),
            torch.from_numpy(cnts.astype(np.int32)).to(DEV),
            torch.from_numpy(sign.astype(np.int32)).to(DEV))


def check_digram_kernels(torch, np, seed: int) -> dict:
    """Phase 2: ``digram_pair_accum`` and ``digram_select`` against their
    twins on the card, exactly. The accumulation on random ragged batches,
    each first with sign +1, then with random signs into the same table: an
    empty batch, 20,000 rows of up to 7 types (the build's), 2,000 rows of
    64 (the cap), 100 rows of up to 300 (no cap: past the kernel's stage);
    the selection on those tables as they are (counts <= 0 among them),
    with many ties, with skipped slots (the best among them) and all
    zero."""
    from repro_torch.kernels.digram_count import SKIP, digram_select_cuda

    rng = np.random.default_rng(seed)
    n_cases = 0
    tables = []
    for what, n_rows, max_k, full in (("an empty batch", 0, 1, False),
                                      ("20000 rows of up to 7", 20000, 7, False),
                                      ("2000 rows of 64", 2000, 64, True),
                                      ("100 rows of up to 300", 100, 300, False)):
        plus = _random_csr(torch, np, rng, n_rows, max_k, signed=False, full=full)
        signed = plus[:3] + (torch.from_numpy(rng.choice([-1, 1], n_rows).astype(np.int32))
                             .to(DEV),)
        kern, _ = _hold_accum(torch, [plus, signed], what)
        tables.append((what, kern))
        n_cases += 2
    for what, t in tables:
        _hold_select(torch, t, what, control=False)
        live = t.keys != -1
        t.counts[live] = torch.from_numpy(rng.integers(1, 4, int(live.sum()))).to(DEV)
        _hold_select(torch, t, f"{what}, ties", control=False)
        if int(live.sum()):
            best = int(digram_select_cuda(t)[2])
            t.flags[torch.from_numpy(rng.random(t.capacity) < 0.3).to(DEV)] = SKIP
            t.flags[best] = SKIP
            _hold_select(torch, t, f"{what}, skipped", control=True)
        t.counts.zero_()
        _hold_select(torch, t, f"{what}, all zero", control=False)
        n_cases += 4
    print(f"digram kernels_vs_plain cases={n_cases} exact=True")
    return {"digram_pair_accum": 0, "digram_select": 0}


# Tolerances of the float kernels against their twins on the card. The
# embedding bag sums rows in float32 in the twin's order, l = 0..L-1: one row
# per bag is a copy and must be exact; for more rows the tolerance covers a
# float32 summation (1e-6) and, for a bfloat16 table, the one rounding of
# that sum to bfloat16 (2**-7 relative). The dot interaction sums D float32
# products in another order than cuBLAS's batched product in the twin.
EMB_TOL = {"float32": dict(rtol=1e-6, atol=1e-6), "bfloat16": dict(rtol=2**-7, atol=1e-6)}
DOT_TOL = dict(rtol=1e-4, atol=1e-4)
# The DLRM kernel path against its twin path: the fields must be equal, the
# logits differ only by the interaction's summation order through the top MLP.
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def check_recsys_kernels(torch, np, seed: int) -> dict:
    """Phase 2, DLRM's kernels: embedding_bag and dot_interaction against
    their twins on the card."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    rng = np.random.default_rng(seed)
    err = {"embedding_bag": 0.0, "dot_interaction": 0.0}
    n_cases = 0
    for dt in (torch.bfloat16, torch.float32):
        tol = EMB_TOL[str(dt).split(".")[-1]]
        for d in (16, 128):
            table = torch.from_numpy(rng.normal(size=(10_000, d)).astype(np.float32)).to(DEV, dt)
            for bag_len in (1, 3, 8):
                for b in (0, 1, 257, 4097):
                    idx = rng.integers(0, 10_000, (b, bag_len))
                    if bag_len > 1:
                        idx[rng.random((b, bag_len)) < 0.25] = -1  # ragged bags
                        idx[: min(b, 2)] = -1                      # empty bags
                    for combiner in ("sum", "mean"):
                        for it in (torch.int32, torch.int64):
                            idx_t = torch.from_numpy(idx).to(DEV, it)
                            got = embedding_bag_cuda(table, idx_t, combiner)
                            want = ref.embedding_bag_ref(table, idx_t, combiner)
                            torch.cuda.synchronize()
                            if got.shape != want.shape or got.dtype != want.dtype:
                                _fail(f"embedding_bag shape/dtype at {dt} D={d} L={bag_len} B={b}")
                            exact = torch.equal(got, want)
                            if bag_len == 1 and not exact:
                                _fail(f"embedding_bag is not exact for L=1 at {dt} D={d} B={b}")
                            if not torch.allclose(got.float(), want.float(), **tol):
                                _fail(f"embedding_bag differs at {dt} D={d} L={bag_len} "
                                      f"B={b} {combiner}")
                            if b:
                                err["embedding_bag"] = max(err["embedding_bag"], float(
                                    (got.float() - want.float()).abs().max()))
                            n_cases += 1
    err["dot_interaction"] = _check_dot_interaction(torch, np, rng)
    print(f"embedding_bag kernels_vs_plain cases={n_cases} max_abs_err="
          f"{err['embedding_bag']} tolerances emb={EMB_TOL}")
    return err


DOT_PATHS = ("dot_interaction", "dot_interaction_simt")  # tensor cores, SIMT


def _excess(torch, got, want) -> float:
    """How far got lands from want in units of DOT_TOL: the largest
    |got - want| / (atol + rtol |want|); above 1 fails the comparison."""
    lim = DOT_TOL["atol"] + DOT_TOL["rtol"] * want.abs()
    return float(((got - want).abs() / lim).max())


def _check_dot_interaction(torch, np, rng) -> float:
    """dot_interaction on the card against both twins (the plain one and the
    tensor-core kernel's tiling twin) within DOT_TOL, on every case of F in
    {2, 4, 8, 17, 27, 32}, D in {16, 24, 64, 128}, B in {1, 5, 129, 4097},
    in bfloat16 and float32, and F in {40, 64, 80} (the tensor-core kernel's
    other instances) in bfloat16 at D in {16, 128}, B in {5, 129}: each case
    must take the path its type and shape give it (tensor cores for bfloat16
    with D % 16 == 0; D = 24 is SIMT),
    counted in launch_counts. A control, the plain twin with the last field
    row zeroed, must fail the comparison in every case. Returns the largest
    error."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dot_interaction import dot_interaction_cuda, uses_tensor_cores

    errs = {p: 0.0 for p in DOT_PATHS}
    cases = {p: 0 for p in DOT_PATHS}
    ctrl_least = float("inf")
    grid = [(dt, f, d, b) for dt in (torch.bfloat16, torch.float32)
            for f in (2, 4, 8, 17, 27, 32) for d in (16, 24, 64, 128) for b in (1, 5, 129, 4097)]
    # the tensor-core kernel's instances for 3 and 4 m-tiles and for any F
    grid += [(torch.bfloat16, f, d, b) for f in (40, 64, 80) for d in (16, 128) for b in (5, 129)]
    for dt, f, d, b in grid:
        x = torch.from_numpy(rng.normal(size=(b, f, d)).astype(np.float32)).to(DEV, dt)
        path = DOT_PATHS[0] if dt == torch.bfloat16 and d % 16 == 0 else DOT_PATHS[1]
        if uses_tensor_cores(x) != (path == DOT_PATHS[0]):
            _fail(f"dot_interaction dispatch at {dt} F={f} D={d} B={b}")
        before = {p: ops.launch_counts[p] for p in DOT_PATHS}
        got = dot_interaction_cuda(x)
        launched = {p: ops.launch_counts[p] - before[p] for p in DOT_PATHS}
        if launched != {p: int(p == path) for p in DOT_PATHS}:
            _fail(f"dot_interaction at {dt} F={f} D={d} B={b} launched {launched}, "
                  f"not one {path}")
        ctrl_x = x.clone()
        ctrl_x[:, -1] = 0
        ctrl = ref.dot_interaction_ref(ctrl_x)
        for twin in (ref.dot_interaction_ref, ref.dot_interaction_tc_ref):
            want = twin(x)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != torch.float32 \
                    or not torch.allclose(got, want, **DOT_TOL):
                _fail(f"dot_interaction ({path}) differs from {twin.__name__} at "
                      f"{dt} F={f} D={d} B={b}")
            errs[path] = max(errs[path], float((got - want).abs().max()))
        if torch.allclose(got, ctrl, **DOT_TOL):
            _fail(f"the dot_interaction comparison does not tell the control (last "
                  f"field row zeroed) from the twin at {dt} F={f} D={d} B={b}")
        ctrl_least = min(ctrl_least, _excess(torch, got, ctrl))
        cases[path] += 1
    print(f"dot_interaction vs both twins (plain, tensor-core tiling): cases by path {cases}, "
          f"max_abs_err by path {errs}, tol={DOT_TOL}; control (last field row zeroed) "
          f"lands at least {ctrl_least:.1f}x outside the tolerance")
    return max(errs.values())


def drive_main_path(torch, np, seed: int, scale: float, n_queries: int) -> dict:
    """Phase 3: build and query at full size, checked against the oracle."""
    from repro_torch.core import Hypergraph, LabelTable, TripleQueryEngine, compress, encode
    from repro_torch.data.synthetic import PAPER_DATASETS
    from repro_torch.kernels import ops

    ds = PAPER_DATASETS["geo-coordinates-en"](scale=scale, seed=seed)
    print(f"dataset geo-coordinates-en scale={scale} triples={ds.n_triples} "
          f"nodes={ds.n_nodes} preds={ds.n_preds}")
    rng = np.random.default_rng(seed)
    pick = ds.triples[rng.integers(0, ds.n_triples, n_queries)]

    # record the counter's first 21 accumulations (the initial Count and 20
    # replacements) and the table it selects from, for phase 4
    accum_calls, select_table = [], []
    real_accum, real_select = ops.digram_pair_accum, ops.digram_select

    def rec_accum(t, *a):
        if len(accum_calls) < 21:
            accum_calls.append(tuple(x.clone() for x in a))
        return real_accum(t, *a)

    def rec_select(t):
        select_table[:] = [t]
        return real_select(t)

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    stages = {}
    t0 = time.perf_counter()
    graph = Hypergraph.from_triples(ds.triples, ds.n_nodes)
    table = LabelTable.terminals(np.full(ds.n_preds, 2))
    torch.cuda.synchronize()
    stages["from_triples"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    ops.digram_pair_accum, ops.digram_select = rec_accum, rec_select
    try:
        grammar, stats = compress(graph, table)
    finally:
        ops.digram_pair_accum, ops.digram_select = real_accum, real_select
    torch.cuda.synchronize()
    stages["compress"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    encoded = encode(grammar)
    torch.cuda.synchronize()
    stages["encode"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    # the engine measures its crossover at construction (3 worklist queries
    # and 3 one-query frontiers on the card): its k2_lines launches are
    # counted apart from the main path's. Phase 3's engine has no result
    # cache and no overlay budget (phase 3c drives those)
    before = {k: ops.launch_counts[k] for k in K2_NAMES}
    engine = TripleQueryEngine(grammar, encoded, cache=None, delta_budget=None)
    torch.cuda.synchronize()
    calibration = {k: ops.launch_counts[k] - before[k] for k in K2_NAMES}
    stages["engine"] = time.perf_counter() - t1
    build_s = time.perf_counter() - t0

    views, batches, query_s = {}, {}, {}
    for pat in PATTERNS + ("???",):
        n = 4 if pat == "???" else n_queries
        cols = [torch.from_numpy(pick[:n, i].copy() if pat[i] != "?"
                                 else np.full(n, -1, dtype=np.int64)).to(DEV)
                for i in range(3)]
        t1 = time.perf_counter()
        views[pat] = engine.query_batch_view(*cols)
        torch.cuda.synchronize()
        query_s[pat] = time.perf_counter() - t1
        batches[pat] = cols
    counts = {k: ops.launch_counts[k] - calibration.get(k, 0)
              for k in (*K2_NAMES, "digram_pair_counts", "digram_pair_accum", "digram_select")}

    print(f"build_s {build_s:.6f} " + " ".join(f"{k}_s={v:.6f}" for k, v in stages.items()))
    print(f"grammar rules={len(grammar.rules)} start_edges={grammar.start.n_edges} "
          f"iterations={stats.iterations} size_units={stats.final_size_units} "
          f"k2_height={encoded.incidence.h}")
    print(f"encoded_bytes {encoded.size_in_bytes()}")
    for name, c in counts.items():
        print(f"launches {name} {c}")
    print(f"crossover calibration (engine construction): launches "
          + " ".join(f"{k}={v}" for k, v in calibration.items()))
    # three worklist queries and three one-query frontiers, each one S seed
    if calibration != {"bitvec_rank": 0, "k2_lines_count": 6, "k2_lines_write": 6}:
        _fail(f"the crossover calibration launched {calibration}, not 6 k2_lines_count, "
              f"6 k2_lines_write and no bitvec_rank")
    # the Count and each replacement's Update Count: one accumulation each;
    # every replacement follows a selection; the dense pair kernel is off the path
    if counts["digram_pair_accum"] != 1 + stats.iterations:
        _fail(f"the main path launched digram_pair_accum {counts['digram_pair_accum']} times, "
              f"not 1 + {stats.iterations}")
    if counts["digram_select"] < stats.iterations:
        _fail(f"the main path launched digram_select {counts['digram_select']} times, "
              f"fewer than its {stats.iterations} replacements")
    if counts["digram_pair_counts"] != 0:
        _fail(f"the main path launched digram_pair_counts {counts['digram_pair_counts']} times")
    # each batch with S or O bound seeds through one rows_many: one count
    # and one write launch of the fused descent, no per-level rank
    seeds = sum(pat[0] != "?" or pat[2] != "?" for pat in PATTERNS)
    if counts["k2_lines_count"] != seeds or counts["k2_lines_write"] != seeds:
        _fail(f"the main path launched k2_lines_count {counts['k2_lines_count']} and "
              f"k2_lines_write {counts['k2_lines_write']} times, not {seeds} each")
    if counts["bitvec_rank"] != 0:
        _fail(f"the main path launched bitvec_rank {counts['bitvec_rank']} times, not 0")

    triples = torch.from_numpy(ds.triples).to(DEV)
    results = {}
    for pat, view in views.items():
        s = batches[pat][0]
        _check_view(torch, view, batches[pat], triples, pat)
        n_q = s.numel()
        total = view.total_results()
        results[pat] = total
        print(f"query {pat} queries={n_q} unique={view.n_entries} results={total} "
              f"us_per_query={query_s[pat] / n_q * 1e6:.3f} oracle_equal=True")
    return {"engine": engine, "graph": graph, "table": table, "counts": counts,
            "batches": batches, "build_s": build_s, "dataset": ds, "grammar": grammar,
            "encoded": encoded,
            "stats": stats, "accum_calls": accum_calls, "select_table": select_table[0],
            "pick": pick, "triples": triples, "query_s": query_s, "stages": stages}


def _view_rows(torch, view, cols, triples):
    """(got, want): a view's (entry, s, p, o) rows and the oracle scan's
    over `triples` for the batch's unique patterns, in canonical order; None
    for got when the query -> entry map is wrong."""
    from repro_torch.core import query_oracle, result_rows

    q = torch.stack(list(cols), dim=1)
    uniq = torch.unique(q, dim=0)
    want = query_oracle(triples, uniq[:, 0], uniq[:, 1], uniq[:, 2])
    if view.n_entries != uniq.shape[0] or not torch.equal(uniq[view.qid_entry], q):
        return None, want
    owner = torch.repeat_interleave(torch.arange(view.n_entries, device=DEV),
                                    view.entry_counts())
    return result_rows(owner, view.labels, view.nodes, view.offsets), want


def _check_view(torch, view, cols, triples, what: str) -> None:
    """Every query of a batch view against the oracle scan of `triples`."""
    got, want = _view_rows(torch, view, cols, triples)
    if got is None:
        _fail(f"{what}: query -> entry map is wrong")
    if not torch.equal(got, want):
        _fail(f"{what}: results differ from the oracle")


SELECTIVE = ("s??", "??o", "sp?", "s?o", "?po", "spo")
SINGLES = 128           # single queries a selective pattern; single neighbourhoods a side
                        # (256 until phase 7c)
NEIGHBOUR_NODES = 4096  # nodes of the neighbourhood batch


def _answer_rows(torch, answers):
    """(qid, s, p, o) rows of per-query (label, (s, o)) answers, in the
    oracle's canonical order."""
    from repro_torch.core._arrays import lexsort

    flat = [(q, nd[0], lbl, nd[1]) for q, ans in enumerate(answers) for lbl, nd in ans]
    rows = torch.tensor(flat, dtype=torch.int64).reshape(-1, 4).to(DEV)
    return rows[lexsort((rows[:, 3], rows[:, 2], rows[:, 1], rows[:, 0]))]


def _pcts(np, us) -> str:
    p50, p99 = np.percentile(us, [50, 99])
    return f"p50_us={p50:.3f} p99_us={p99:.3f}"


def _single_queries(torch, np, engine, main: dict, width: int) -> dict:
    """SINGLES queries of each selective pattern through ``engine.query`` at
    crossover `width`, each timed on the host clock (the answer is host
    tuples: finished work), all held against the oracle scan; the k2_lines
    launches counted around the whole reading."""
    from repro_torch.core import query_oracle
    from repro_torch.kernels import ops

    engine.crossover = width
    filled = engine._nt_rows is not None
    ops.reset_launch_counts()
    n_seeds, p50, p99 = 0, {}, {}
    for pat in SELECTIVE:
        qs = [tuple(int(main["pick"][i, j]) if pat[j] != "?" else None for j in range(3))
              for i in range(SINGLES)]
        us, answers = [], []
        for q in qs:
            t0 = time.perf_counter()
            answers.append(engine.query(*q))
            torch.cuda.synchronize()
            us.append((time.perf_counter() - t0) * 1e6)
        cols = [torch.tensor([-1 if v is None else v for v in c], device=DEV) for c in zip(*qs)]
        if not torch.equal(_answer_rows(torch, answers), query_oracle(main["triples"], *cols)):
            _fail(f"single {pat} queries at crossover {width} differ from the oracle")
        n_seeds += len(qs)
        p50[pat] = float(np.percentile(us, 50))
        p99[pat] = float(np.percentile(us, 99))
        print(f"single {pat} crossover={width} queries={len(qs)} {_pcts(np, us)} "
              f"results={sum(map(len, answers))} oracle_equal=True")
    counts = {k: ops.launch_counts[k] for k in K2_NAMES}
    fills = int(not filled and engine._nt_rows is not None)
    print(f"single queries crossover={width}: launches "
          + " ".join(f"{k}={v}" for k, v in counts.items())
          + f" over {n_seeds} S/O seeds and {fills} NT-row fill")
    # every query seeds through one row of the incidence tree (the worklist's
    # K2Tree.row, or the one-query frontier's rows_many): one count and one
    # write launch each; the worklist's NT prune fills its rows once
    want = {"bitvec_rank": 0, "k2_lines_count": n_seeds + fills,
            "k2_lines_write": n_seeds + fills}
    if counts != want:
        _fail(f"single queries at crossover {width} launched {counts}, not {want}")
    return {"p50_us": p50, "p99_us": p99, "counts": counts}


def _neighbour_rows(torch, lists):
    """(qid, node) rows of per-query neighbour tensors."""
    lens = torch.tensor([t.numel() for t in lists], device=DEV)
    qid = torch.repeat_interleave(torch.arange(len(lists), device=DEV), lens)
    return torch.stack([qid, torch.cat(lists)], 1)


def _neighbourhoods(torch, np, engine, main: dict, seed: int) -> dict:
    """The paper's neighbourhood queries: the batched forms over
    NEIGHBOUR_NODES nodes drawn from the triples (duplicates, a -1 and an id
    past n_nodes included), then SINGLES single calls a side, every list
    held exactly against the oracle's distinct objects / subjects."""
    from repro_torch.core import query_oracle
    from repro_torch.kernels import ops

    ds, triples = main["dataset"], main["triples"]
    rng = np.random.default_rng(seed + 24)
    ends = ds.triples[:, [0, 2]].reshape(-1)
    vs = ends[rng.integers(0, ends.size, NEIGHBOUR_NODES)].copy()
    vs[-1], vs[-2] = -1, ds.n_nodes + 5
    v_dev = torch.from_numpy(vs).to(DEV)
    probe = torch.where(v_dev < 0, ds.n_nodes + 1, v_dev)  # no node: matches nothing
    unbound = torch.full_like(probe, -1)
    sides = {"out": (engine.neighbors_out_batch, engine.neighbors_out, (probe, unbound, unbound), 3),
             "in": (engine.neighbors_in_batch, engine.neighbors_in, (unbound, unbound, probe), 1)}
    ops.reset_launch_counts()
    out, calls = {}, 0
    for side, (batch, single, cols, col) in sides.items():
        rows = query_oracle(triples, *cols)
        want = torch.unique(torch.stack([rows[:, 0], rows[:, col]], 1), dim=0)
        per_node = torch.split(want[:, 1], torch.bincount(
            want[:, 0], minlength=NEIGHBOUR_NODES).tolist())
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = batch(v_dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            calls += 1
            if len(got) != NEIGHBOUR_NODES or not torch.equal(_neighbour_rows(torch, got), want):
                _fail(f"neighbors_{side}_batch differs from the oracle")
        if any(got[i].numel() for i in (-1, -2)):
            _fail(f"neighbors_{side}_batch answered a -1 or an id past n_nodes")
        first = {}
        shared = 0
        for i, v in enumerate(vs.tolist()):
            if v in first:
                if got[i] is not got[first[v]]:
                    _fail(f"neighbors_{side}_batch: duplicate nodes do not share one tensor")
                shared += 1
            first.setdefault(v, i)
        # control: one node dropped from the first non-empty list must fail
        i = next(i for i, t in enumerate(got) if t.numel())
        bad = list(got)
        bad[i] = bad[i][:-1]
        if torch.equal(_neighbour_rows(torch, bad), want):
            _fail(f"neighbors_{side}_batch control (a node dropped) passed the oracle check")
        us = []
        for i in range(SINGLES):
            t0 = time.perf_counter()
            one = single(int(vs[i]))
            torch.cuda.synchronize()
            us.append((time.perf_counter() - t0) * 1e6)
            if not torch.equal(one, per_node[i]):
                _fail(f"neighbors_{side}({int(vs[i])}) differs from the oracle")
        out[side] = {"batch_us_per_node": min(times) / NEIGHBOUR_NODES * 1e6,
                     "single_p50_us": float(np.percentile(us, 50))}
        print(f"neighbors_{side}_batch nodes={NEIGHBOUR_NODES} lists={want.shape[0]} "
              f"us_per_node={min(times) / NEIGHBOUR_NODES * 1e6:.3f} (best of 3; first "
              f"{times[0] / NEIGHBOUR_NODES * 1e6:.3f}) duplicates_sharing={shared} "
              f"oracle_equal=True control_failed=True")
        print(f"neighbors_{side} single calls={SINGLES} {_pcts(np, us)} oracle_equal=True")
    counts = {k: ops.launch_counts[k] for k in K2_NAMES}
    print("neighbourhoods: launches " + " ".join(f"{k}={v}" for k, v in counts.items())
          + f" over {calls} batches and {2 * SINGLES} single calls")
    # each batch seeds through one rows_many, each single call through one row
    want = {"bitvec_rank": 0, "k2_lines_count": calls + 2 * SINGLES,
            "k2_lines_write": calls + 2 * SINGLES}
    if counts != want:
        _fail(f"the neighbourhood queries launched {counts}, not {want}")
    out["counts"] = counts
    return out


def _inverted_prune_control(torch, engine, main: dict) -> int:
    """The worklist with its NT prune inverted on the ?po singles must
    differ from the oracle: the results inside rules that generate P are
    lost. Returns how many queries lost results."""
    from repro_torch.core import query_oracle

    qs = [(None, int(main["pick"][i, 1]), int(main["pick"][i, 2])) for i in range(SINGLES)]
    real = engine._nt_generates
    engine._nt_generates = lambda label, p: not real(label, p)
    try:
        answers = [engine.query_scalar(*q) for q in qs]
    finally:
        del engine._nt_generates
    cols = [torch.tensor([-1 if v is None else v for v in c], device=DEV) for c in zip(*qs)]
    want = query_oracle(main["triples"], *cols)
    lost = int((torch.bincount(want[:, 0], minlength=SINGLES)
                != torch.tensor([len(a) for a in answers], device=DEV)).sum())
    if lost == 0:
        _fail("the worklist with its NT prune inverted still equals the oracle on ?po")
    return lost


def drive_scalar_path(torch, np, main: dict, seed: int) -> None:
    """Phase 3, the scalar worklist, the crossover and the neighbourhood
    queries on the main path's engine, at its calibrated crossover."""
    from repro_torch.kernels import ref

    engine = main["engine"]
    calibrated = engine.crossover
    cal = engine.calibration
    print(f"crossover measured on the card: {calibrated} (best of 3: worklist "
          f"{cal['scalar_s'] * 1e6:.3f} us, one-query frontier {cal['frontier_s'] * 1e6:.3f} us)")
    # the worklist's seed is one row of the incidence tree: held against the
    # level loop's twin on the s?? singles' subjects, uncounted
    lay = engine.incidence.layout()
    for v in main["pick"][:SINGLES, 0].tolist():
        if not torch.equal(engine.incidence.row(v),
                           ref.k2_lines_ref(lay, torch.tensor([v], device=DEV), 0)[1]):
            _fail(f"K2Tree.row({v}) differs from the twin")
    v0 = int(main["pick"][0, 0])
    row_ms = _time_ms(torch, lambda: engine.incidence.row(v0), 200)
    twin_ms = _time_ms(torch, lambda: ref.k2_lines_ref(
        lay, torch.tensor([v0], device=DEV), 0), 50)
    print(f"K2Tree.row (one k2_lines count + write and the host read) ms={row_ms:.6f} "
          f"twin_ms={twin_ms:.6f}")
    # the calibrated width and the frontier alone; if the calibration chose
    # the frontier, the worklist is still driven, at the largest width
    widths = (calibrated, 0) if calibrated else (8, 0)
    if not calibrated:
        print("the calibration chose 0: the worklist reading runs at crossover 8")
    try:
        readings = {w: _single_queries(torch, np, engine, main, w) for w in widths}
        engine.crossover = calibrated
        nb = _neighbourhoods(torch, np, engine, main, seed)
        # what holds a single query back: host syncs (a lower bound) and the
        # device's busy share over 64 s?? singles at each width
        subjects = main["pick"][:64, 0].tolist()
        for w in widths:
            engine.crossover = w
            syncs = _count_syncs(torch, lambda: engine.query(subjects[0], None, None))
            wall, dev, _ = _profile(torch, lambda: [engine.query(v, None, None)
                                                    for v in subjects])
            share = f"{dev / wall:.4f}" if dev > 0 else "not measured"
            print(f"single s?? crossover={w}: host_syncs={syncs} busy_share={share} "
                  f"(64 queries, wall_s={wall:.6f} kernel_s={dev:.6f})")
        engine.crossover = calibrated
        print(f"neighbors_out single: host_syncs="
              f"{_count_syncs(torch, lambda: engine.neighbors_out(subjects[0]))}")
    finally:
        engine.crossover = calibrated
    lost = _inverted_prune_control(torch, engine, main)
    print(f"control: the worklist with its NT prune inverted lost results on {lost} of "
          f"{SINGLES} ?po queries (must be > 0)")
    worklist, frontier = readings[widths[0]]["p50_us"], readings[0]["p50_us"]
    print("crossover check (p50 us, worklist width / frontier): "
          + " ".join(f"{pat}={worklist[pat]:.1f}/{frontier[pat]:.1f}" for pat in SELECTIVE))
    main["scalar_part"] = {"row_ms": row_ms, "row_twin_ms": twin_ms,
                           "singles": readings[widths[0]], "crossover": widths[0],
                           "launches": {k: sum(r["counts"][k] for r in readings.values())
                                        + nb["counts"][k] for k in K2_NAMES}}


MUTATION_BATCH = 1536   # distinct base triples deleted; distinct new triples inserted
MUTATION_PAST = 384     # of those inserts, with S or O past the base graph's nodes
PAST_IDS = 256          # ... drawn from n_nodes .. n_nodes + 255
MUTATION_NOOPS = 256    # re-inserts of visible rows; deletes of absent rows
MUTATION_PICKS = (1024, 1024, 2048)  # query rows: deleted, inserted, untouched
INVALIDATING = 512      # inserts on the subjects of the warm s?? queries
REBUILD_INSERTS = 1024  # the inserts that pass the budget and trigger the rebuild
DELTA_BUDGET = 4096
DIGRAM_NAMES = ("digram_pair_counts", "digram_pair_accum", "digram_select")


def _new_rows(np, rng, n: int, taken: set, n_nodes: int, n_preds: int, subjects=None,
              past: int = 0):
    """n distinct rows absent from `taken` (which gains them): subjects from
    `subjects` when given; the first `past` rows have S (even rows) or O
    (odd rows) in n_nodes .. n_nodes + PAST_IDS - 1, the rest inside the
    base graph's nodes."""
    out = []
    while len(out) < n:
        i = len(out)
        s = int(subjects[rng.integers(0, len(subjects))]) if subjects is not None \
            else int(rng.integers(0, n_nodes))
        o = int(rng.integers(0, n_nodes))
        if i < past:
            far = n_nodes + int(rng.integers(0, PAST_IDS))
            s, o = (far, o) if i % 2 == 0 else (s, far)
        row = (s, int(rng.integers(0, n_preds)), o)
        if row not in taken:
            taken.add(row)
            out.append(row)
    return out


def _oracle_triples(torch, logical: set):
    return torch.tensor(sorted(logical), dtype=torch.int64).reshape(-1, 3).to(DEV)


def _mutate(torch, engine, name: str, rows: list, logical: set, timing: dict) -> int:
    """One mutation batch, timed (the device synchronised around it), its
    `applied` count held against the count reckoned in plain Python over the
    logical set, which it then updates."""
    want = set(rows)
    expected = len(want - logical) if name == "insert_triples" else len(want & logical)
    batch = torch.tensor(rows, dtype=torch.int64).to(DEV)
    before = timing["exists_s"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    applied = getattr(engine, name)(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if applied != expected:
        _fail(f"{name} of {len(rows)} rows applied {applied}, not {expected}")
    if name == "insert_triples":
        logical |= want
    else:
        logical -= want
    exists = timing["exists_s"] - before
    print(f"mutation {name} rows={len(rows)} applied={applied} (reckoned {expected}) "
          f"ms={dt * 1e3:.3f} exists_rows_ms={exists * 1e3:.3f} "
          f"exists_share={exists / dt:.4f} overlay={engine.delta.size}")
    timing["batches"].append(dt)
    return applied


def _mutation_batches(torch, np, picks) -> dict:
    """The eight patterns over 4,096 picked rows (4 for ???), as phase 3
    binds them."""
    out = {}
    for pat in PATTERNS + ("???",):
        n = 4 if pat == "???" else len(picks)
        out[pat] = [torch.from_numpy(picks[:n, i].copy() if pat[i] != "?"
                                     else np.full(n, -1, dtype=np.int64)).to(DEV)
                    for i in range(3)]
    return out


def _timed_view(torch, engine, cols):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    view = engine.query_batch_view(*cols)
    torch.cuda.synchronize()
    return view, time.perf_counter() - t0


def _merge_syncs(torch, fn) -> tuple:
    """(host syncs of one call of fn, those made inside the overlay merge),
    by torch's sync debug mode."""
    import warnings

    from repro_torch.core.delta import DeltaOverlay

    real = DeltaOverlay.merge_batch
    inside = [0]
    log = []

    def merge(self, *a):
        before = len(log[0])
        try:
            return real(self, *a)
        finally:
            inside[0] += sum("synchroniz" in str(w.message) for w in log[0][before:])

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            log.append(caught)
            DeltaOverlay.merge_batch = merge
            fn()
    finally:
        DeltaOverlay.merge_batch = real
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in log[0]), inside[0]


def _neighbour_check(torch, engine, rng, logical_t, ends, n_rows: int) -> None:
    """NEIGHBOUR_NODES nodes drawn from the logical triples' ends (new ids
    included) and a -1, both sides, against the oracle's distinct lists;
    then a negative id with inserts at row n_rows answers empty."""
    from repro_torch.core import query_oracle

    vs = ends[rng.integers(0, ends.size, NEIGHBOUR_NODES)].copy()
    vs[-1] = -1
    v_dev = torch.from_numpy(vs).to(DEV)
    probe = torch.where(v_dev < 0, 1 << 62, v_dev)  # no node: matches nothing
    unbound = torch.full_like(probe, -1)
    for side, batch, cols, col in (("out", engine.neighbors_out_batch, (probe, unbound, unbound), 3),
                                   ("in", engine.neighbors_in_batch, (unbound, unbound, probe), 1)):
        rows = query_oracle(logical_t, *cols)
        want = torch.unique(torch.stack([rows[:, 0], rows[:, col]], 1), dim=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = batch(v_dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not torch.equal(_neighbour_rows(torch, got), want):
            _fail(f"neighbors_{side}_batch with the overlay differs from the oracle")
        past = int((v_dev >= engine.incidence.n_rows).sum())
        print(f"mutation neighbors_{side}_batch nodes={NEIGHBOUR_NODES} (past the base: {past}) "
              f"lists={want.shape[0]} us_per_node={dt / NEIGHBOUR_NODES * 1e6:.3f} "
              f"oracle_equal=True")
    out_n, in_n = engine.neighbors_out(n_rows).tolist(), engine.neighbors_in(n_rows).tolist()
    if not out_n or not in_n:
        _fail(f"node {n_rows} (= n_rows) has no inserted neighbours to leak")
    if engine.neighbors_out(-1).numel() or engine.neighbors_in(-1).numel():
        _fail("a negative node id answered the neighbours of the inserts at row n_rows")
    print(f"mutation negative id: neighbors_out(-1) = [] and neighbors_in(-1) = [] with "
          f"inserts at row n_rows={n_rows} (its out {out_n[:3]}, in {in_n[:3]})")


def _stale_entries(torch, view, cols, triples) -> int:
    """Entries of a batch view whose result count differs from the oracle's."""
    got, want = _view_rows(torch, view, cols, triples)
    counts = torch.bincount(want[:, 0], minlength=view.n_entries)
    return int((view.entry_counts() != counts).sum())


def _cache_breakdown(torch, engine, cols) -> None:
    """Where a cached batch's host time goes: the steps of the engine's
    cached view path run one by one on a fresh cache (each timed with the
    device synchronised around it), cold and then warm, beside what the
    earlier designs paid: one clone an entry's buffer (the first design of
    the copies), and the three views an entry (the second kept every
    entry as three tensors)."""
    import repro_torch.core.query as engine_module
    from repro_torch.core import QueryResultCache

    cache = QueryResultCache()
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t) * 1e3
        return out

    uniq, inv = timed("unique", lambda: torch.unique(torch.stack(list(cols), 1), dim=0,
                                                     return_inverse=True))
    keys = timed("key_read", uniq.tolist)
    timed("lookups", lambda: [cache.lookup(*k) for k in keys])
    res = timed("execute", lambda: engine._execute_unique(uniq[:, 0], uniq[:, 1], uniq[:, 2]))
    fresh = timed("group", lambda: engine_module._split_per_query(res, len(keys), inv))
    entries = timed("entry_copies", lambda: engine_module._owned_entries(fresh))
    timed("inserts", lambda: [cache.insert(*k, e) for k, e in zip(keys, entries)])
    timed("warm_lookups", lambda: [cache.lookup(*k) for k in keys])
    timed("warm_assembly", lambda: engine_module._view_of_entries(entries, inv))
    timed("clone_each_entry", lambda: [e.buf.clone() for e in entries])
    timed("three_views_each", lambda: [e.parts() for e in entries])
    n = len(keys)
    cold = sum(ms[k] for k in ("unique", "key_read", "lookups", "execute", "group",
                               "entry_copies", "inserts"))
    print(f"cached s?? batch breakdown (unique={n}): cold_ms={cold:.3f} "
          + " ".join(f"{k}_ms={v:.3f}" for k, v in ms.items())
          + f" host_us_per_entry: copies={ms['entry_copies'] / n * 1e3:.3f} "
          f"inserts={ms['inserts'] / n * 1e3:.3f} lookups={ms['lookups'] / n * 1e3:.3f} "
          f"assembly={ms['warm_assembly'] / n * 1e3:.3f} "
          f"one_clone={ms['clone_each_entry'] / n * 1e3:.3f} "
          f"three_views={ms['three_views_each'] / n * 1e3:.3f}")


def drive_mutation_path(torch, np, main: dict, seed: int) -> None:
    """Phase 3c: the mutable engine at full size on phase 3's grammar: the
    overlay, the result cache, invalidation and the rebuild on the card,
    every answer held against the oracle scan of the logical triple set."""
    import repro_torch.core.query as engine_module
    from repro_torch.core import QueryResultCache, TripleQueryEngine, query_oracle
    from repro_torch.kernels import ops

    ds, phase3 = main["dataset"], main["engine"]
    rng = np.random.default_rng(seed + 25)
    base = ds.triples
    logical = set(map(tuple, base.tolist()))
    if len(logical) != base.shape[0]:
        _fail("the dataset's triples are not distinct")
    names = (*K2_NAMES, *DIGRAM_NAMES)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine = TripleQueryEngine(main["grammar"], phase3.encoded, cache=QueryResultCache(),
                               crossover=phase3.crossover, delta_budget=DELTA_BUDGET)
    cache = engine.cache
    torch.cuda.synchronize()
    n_rows = engine.incidence.n_rows
    print(f"mutation engine: crossover={engine.crossover} (phase 3's) budget={engine.delta_budget} "
          f"n_rows={n_rows} n_nodes={ds.n_nodes} engine_s={time.perf_counter() - t0:.6f}")
    if not ds.n_nodes <= n_rows < ds.n_nodes + PAST_IDS:
        _fail(f"n_rows {n_rows} is outside the inserts' new ids")
    timing = {"exists_s": 0.0, "batches": []}
    real_exists = engine._exists_rows

    def timed_exists(rows):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_exists(rows)
        torch.cuda.synchronize()
        timing["exists_s"] += time.perf_counter() - t
        return out

    engine._exists_rows = timed_exists

    # 1. the first mutation batches
    taken = set(logical)
    deleted = [tuple(r) for r in base[rng.choice(base.shape[0], MUTATION_BATCH, replace=False)]
               .tolist()]
    inserted = _new_rows(np, rng, MUTATION_BATCH, taken, ds.n_nodes, ds.n_preds,
                         past=MUTATION_PAST)
    inserted[0] = (n_rows, inserted[0][1], inserted[0][2])  # a subject at row n_rows
    inserted[1] = (inserted[1][0], inserted[1][1], n_rows)  # an object at row n_rows
    if len(set(inserted)) != MUTATION_BATCH or set(inserted) & logical:
        _fail("the inserts at row n_rows collide")
    taken.update(inserted[:2])
    absent = _new_rows(np, rng, MUTATION_NOOPS, taken, ds.n_nodes, ds.n_preds)
    untouched = sorted(logical - set(deleted))
    visible = [untouched[i] for i in rng.choice(len(untouched), MUTATION_NOOPS, replace=False)]
    _mutate(torch, engine, "delete_triples", deleted + absent, logical, timing)
    _mutate(torch, engine, "insert_triples", inserted + visible, logical, timing)
    if engine.delta.size != 2 * MUTATION_BATCH or engine.rebuild_count:
        _fail(f"the overlay holds {engine.delta.size} rows after the first batches, "
              f"not {2 * MUTATION_BATCH}, or a rebuild ran")
    logical_t = _oracle_triples(torch, logical)

    # 2. the eight patterns with the overlay, cold, each then warm
    n_del, n_ins, n_keep = MUTATION_PICKS
    picks = np.array([deleted[i] for i in rng.choice(len(deleted), n_del, replace=False)]
                     + [inserted[i] for i in rng.choice(len(inserted), n_ins, replace=False)]
                     + [untouched[i] for i in rng.choice(len(untouched), n_keep)])
    picks = picks[rng.permutation(len(picks))]
    batches = _mutation_batches(torch, np, picks)
    cold, warm = {}, {}
    for pat, cols in batches.items():
        before = cache.stats.snapshot()
        view, cold[pat] = _timed_view(torch, engine, cols)
        _check_view(torch, view, cols, logical_t, f"{pat} with the overlay")
        within = int((view.entry_counts() <= cache.max_entry_edges).sum())
        mid = cache.stats.snapshot()
        k2 = {k: ops.launch_counts[k] for k in K2_NAMES}
        again, warm[pat] = _timed_view(torch, engine, cols)
        _check_view(torch, again, cols, logical_t, f"{pat} warm")
        hits, misses = cache.stats.hits - mid.hits, cache.stats.misses - mid.misses
        if hits != within or misses != view.n_entries - within:
            _fail(f"{pat} warm: {hits} hits and {misses} misses over {view.n_entries} unique "
                  f"patterns, {within} of them within max_entry_edges")
        if any(ops.launch_counts[k] != k2[k] for k in K2_NAMES):
            _fail(f"{pat} warm: an all-hit batch launched a k2_lines kernel")
        engine.cache = None  # the overlay alone: the batch executed, no cache
        try:
            bare, bare_s = _timed_view(torch, engine, cols)
        finally:
            engine.cache = cache
        _check_view(torch, bare, cols, logical_t, f"{pat} with the overlay, no cache")
        n = cols[0].numel()
        base_us = main["query_s"][pat] / n * 1e6
        print(f"mutation query {pat} queries={n} unique={view.n_entries} "
              f"results={view.total_results()} overlay_us_per_query={bare_s / n * 1e6:.3f} "
              f"(phase 3, no overlay: {base_us:.3f}) cold_us_per_query={cold[pat] / n * 1e6:.3f} "
              f"warm_us_per_query={warm[pat] / n * 1e6:.3f} cold_misses={mid.misses - before.misses} "
              f"warm_hits={hits} oracle_equal=True")
    ends = np.array(sorted(logical))[:, [0, 2]].reshape(-1)
    _neighbour_check(torch, engine, rng, logical_t, ends, n_rows)

    # 3. single queries, cold and warm
    subjects = [int(v) for v in picks[:SINGLES, 0]]
    single_us = {}
    for label in ("cold", "warm"):
        before = cache.stats.snapshot()
        us, answers = [], []
        for v in subjects:
            t0 = time.perf_counter()
            answers.append(engine.query(v, None, None))
            torch.cuda.synchronize()
            us.append((time.perf_counter() - t0) * 1e6)
        col = torch.tensor(subjects, device=DEV)
        unbound = torch.full_like(col, -1)
        if not torch.equal(_answer_rows(torch, answers), query_oracle(logical_t, col, unbound,
                                                                      unbound)):
            _fail(f"{label} single s?? queries with the overlay differ from the oracle")
        hits = cache.stats.hits - before.hits
        if label == "warm" and hits != SINGLES:
            _fail(f"{hits} of {SINGLES} warm single queries hit the cache")
        single_us[label] = us
        print(f"mutation single s?? {label} queries={SINGLES} {_pcts(np, us)} hits={hits} "
              f"oracle_equal=True")
    st = cache.stats
    print(f"cache stats: hits={st.hits} misses={st.misses} hit_rate={st.hit_rate:.4f} "
          f"inserts={st.inserts} evictions={st.evictions} oversize_skips={st.oversize_skips} "
          f"predicate_hits={st.predicate_hits} entries={len(cache)} edges={cache.cached_edges}")

    s_cols = batches["s??"]
    _cache_breakdown(torch, engine, s_cols)

    # 4. invalidation: inserts on the warm s?? queries' subjects
    engine.query_batch_view(*s_cols)  # warm again after the other patterns
    fresh = _new_rows(np, rng, INVALIDATING, taken, ds.n_nodes, ds.n_preds,
                      subjects=picks[:, 0])
    _mutate(torch, engine, "insert_triples", fresh, logical, timing)
    logical_t = _oracle_triples(torch, logical)
    view = engine.query_batch_view(*s_cols)
    _check_view(torch, view, s_cols, logical_t, "s?? after the invalidating inserts")
    # control: the same without the generation bump must serve stale entries
    cache.bump_generation = lambda shard=-1: cache.generation(shard)
    try:
        _mutate(torch, engine, "delete_triples", fresh, logical, timing)
        without = _oracle_triples(torch, logical)
        stale = _stale_entries(torch, engine.query_batch_view(*s_cols), s_cols, without)
    finally:
        del cache.bump_generation
    if stale == 0:
        _fail("control: with bump_generation stubbed out the cache served no stale answer")
    cache.bump_generation()  # drop what the stubbed deletes left behind
    _mutate(torch, engine, "insert_triples", fresh, logical, timing)
    view = engine.query_batch_view(*s_cols)
    _check_view(torch, view, s_cols, logical_t, "s?? after the inserts again")
    if engine.delta.size != 2 * MUTATION_BATCH + INVALIDATING:
        _fail(f"the overlay holds {engine.delta.size} rows, not "
              f"{2 * MUTATION_BATCH + INVALIDATING}")
    print(f"invalidation: {INVALIDATING} inserts on the warm s?? subjects, every answer equal "
          f"to the oracle; control (bump_generation stubbed) served {stale} stale entries "
          f"(must be > 0); overlay={engine.delta.size}")
    # what an overlay s?? batch costs, executed (the cache detached)
    engine.cache = None
    try:
        syncs, merge = _merge_syncs(torch, lambda: engine.query_batch_view(*s_cols))
        wall, dev, _ = _profile(torch, lambda: engine.query_batch_view(*s_cols))
        view, dt = _timed_view(torch, engine, s_cols)
    finally:
        engine.cache = cache
    share = f"{dev / wall:.4f}" if dev > 0 else "not measured"
    print(f"overlay s?? batch (cache detached): ms={dt * 1e3:.3f} host_syncs={syncs} "
          f"of them in the merge={merge} busy_share={share} (wall_s={wall:.6f} "
          f"kernel_s={dev:.6f})")

    # 5. the automatic rebuild
    real_compress, real_encode, real_rebuild = (engine_module.compress, engine_module.encode,
                                                engine.rebuild)
    rebuild = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rebuild[name] = time.perf_counter() - t
            if name == "compress":
                rebuild["stats"] = out[1]
            return out
        return run

    more = _new_rows(np, rng, REBUILD_INSERTS, taken, ds.n_nodes, ds.n_preds)
    before = {k: ops.launch_counts[k] for k in DIGRAM_NAMES}
    engine_module.compress, engine_module.encode = timed("compress", real_compress), \
        timed("encode", real_encode)
    engine.rebuild = timed("rebuild", real_rebuild)
    try:
        _mutate(torch, engine, "insert_triples", more, logical, timing)
    finally:
        engine_module.compress, engine_module.encode = real_compress, real_encode
        del engine.rebuild, engine._exists_rows
    digram = {k: ops.launch_counts[k] - before[k] for k in DIGRAM_NAMES}
    stats = rebuild.get("stats")
    if engine.rebuild_count != 1 or not engine.delta.is_empty or stats is None:
        _fail(f"the insert past the budget left rebuild_count={engine.rebuild_count} and "
              f"{engine.delta.size} overlay rows")
    if digram["digram_pair_accum"] != 1 + stats.iterations or digram["digram_pair_counts"] \
            or digram["digram_select"] < stats.iterations:
        _fail(f"the rebuild launched {digram} over {stats.iterations} replacements")
    logical_t = _oracle_triples(torch, logical)
    rebuilt = engine.base_triples()
    if rebuilt.shape[0] != len(logical) or not torch.equal(torch.unique(rebuilt, dim=0),
                                                          logical_t):
        _fail("the rebuilt base differs from the logical triple set")
    engine_s = rebuild["rebuild"] - rebuild["compress"] - rebuild["encode"]
    print(f"rebuild (inside insert_triples): rebuild_s={rebuild['rebuild']:.6f} "
          f"compress_s={rebuild['compress']:.6f} encode_s={rebuild['encode']:.6f} "
          f"rest_s={engine_s:.6f} (decompress, overlay apply, from_triples, the engine's "
          f"other structures) "
          f"write_ms={timing['batches'][-1] * 1e3:.3f} triples={rebuilt.shape[0]} "
          f"iterations={stats.iterations} rules={len(engine.grammar.rules)} launches "
          + " ".join(f"{k}={v}" for k, v in digram.items()))
    for pat, cols in batches.items():
        view, dt = _timed_view(torch, engine, cols)
        _check_view(torch, view, cols, logical_t, f"{pat} after the rebuild")
        print(f"mutation query {pat} after the rebuild us_per_query={dt / cols[0].numel() * 1e6:.3f} "
              f"oracle_equal=True")
    counts = {k: ops.launch_counts[k] for k in names}
    print("mutation part: launches " + " ".join(f"{k}={v}" for k, v in counts.items())
          + f"; mutation batches ms=" + ",".join(f"{t * 1e3:.3f}" for t in timing["batches"]))
    for k in ("k2_lines_count", "k2_lines_write", "digram_pair_accum", "digram_select"):
        if counts[k] == 0:
            _fail(f"the mutation path launched {k} no time")
    if counts["bitvec_rank"] or counts["digram_pair_counts"]:
        _fail(f"the mutation path launched {counts}")
    main["mutation_part"] = {"launches": counts}


SNAPSHOT_PICKS = (1024, 1024, 2048)  # phase 3d's query rows: deleted, inserted, untouched
PLUS_DATASET = "chess-legal"         # the paper's Table 1b size at scale 1.0 ...
PLUS_SCALE = 0.5                     # ... cut to half for the time limit (1.0 until phase 7c)


def _state_tensors(engine) -> dict:
    """Every state tensor of an engine by name: the label-sorted start graph,
    the flat CSR, the k²-tree levels, the Elias–Fano parts, the δ streams
    and the overlay rows."""
    from repro_torch.core import FlatGrammar

    enc, ef, g = engine.encoded, engine.encoded.label_ef, engine._start_sorted
    out = {"table_ranks": engine.grammar.table.ranks, "start_labels": g.labels,
           "start_nodes": g.nodes_flat, "start_offsets": g.offsets, "ef_lows": ef._lows,
           "ef_low_words": ef._low_words, "ef_upper_words": ef._upper.words,
           "fn_words": enc.fn_stream[0], "edge_fn_words": enc.edge_fn_stream[0],
           "rule_words": enc.rule_stream[0], "fn_lengths": enc.fn_lengths,
           "terminal_ranks": enc.terminal_ranks, "delta_inserts": engine.delta.inserts,
           "delta_tombstones": engine.delta.tombstones}
    out.update({f"flat_{n}": getattr(engine.flat, n) for n in FlatGrammar._ARRAY_FIELDS})
    out.update({f"k2_level_{i}": lv.words for i, lv in enumerate(enc.incidence.levels)})
    return out


def _engine_scalars(engine) -> dict:
    enc = engine.encoded
    return {"crossover": engine.crossover, "delta_budget": engine.delta_budget,
            "base_edges": engine._base_edges, "rebuild_count": engine.rebuild_count,
            "stream_bits": (enc.fn_stream[1], enc.edge_fn_stream[1], enc.rule_stream[1]),
            "counts": (enc.n_nodes, enc.n_edges, enc.n_fns, enc.n_rules, enc.rule_symbol_count)}


def _dir_diff(a: str, b: str) -> list:
    """Files that differ between two directories, or are in one only."""
    import filecmp
    import os

    na, nb = sorted(os.listdir(a)), sorted(os.listdir(b))
    if na != nb:
        return sorted(set(na) ^ set(nb))
    return [n for n in na if not filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                                             shallow=False)]


def _broken_open(path: str, scratch: str, how: str) -> str:
    """Open a broken copy of a snapshot (`how`: one byte flipped in an array
    file, an array file removed, the manifest removed); the SnapshotError's
    message, or "" when the open did not raise one."""
    import os
    import shutil

    from repro_torch.persist.snapshot import MANIFEST, SnapshotError, load_snapshot

    copy = os.path.join(scratch, f"broken_{how}")
    shutil.copytree(path, copy)
    if how == "flipped_byte":
        target = os.path.join(copy, "flat_params.npy")
        data = bytearray(open(target, "rb").read())
        data[len(data) // 2] ^= 0x10
        open(target, "wb").write(bytes(data))
    else:
        os.remove(os.path.join(copy, "start_labels.npy" if how == "removed_array" else MANIFEST))
    try:
        load_snapshot(copy)
    except SnapshotError as exc:
        return str(exc)
    finally:
        shutil.rmtree(copy)
    return ""


def _gc_pause(fn) -> tuple:
    """(fn's result, seconds Python's cyclic garbage collector ran during it)."""
    import gc

    marks = []

    def mark(phase, info):
        marks.append(time.perf_counter())

    gc.callbacks.append(mark)
    try:
        out = fn()
    finally:
        gc.callbacks.remove(mark)
    return out, sum(b - a for a, b in zip(marks[::2], marks[1::2]))


def _hyper_rows(torch, labels, nodes, offsets):
    """(s, p, o) per edge of a ragged batch, o = -2 for a rank-1 edge (which
    matches only an unbound O)."""
    if labels.numel() == 0:
        return torch.zeros((0, 3), dtype=torch.int64, device=labels.device)
    ranks = offsets[1:] - offsets[:-1]
    starts = offsets[:-1]
    second = torch.where(ranks > 1, nodes[(starts + 1).clamp(max=nodes.numel() - 1)], -2)
    return torch.stack([nodes[starts], labels, second], 1)


def _check_hyper_view(torch, view, cols, rows_t, what: str) -> None:
    """A batch view over a hypergraph with rank-1 edges against the plain
    scan of its (s, p, o / -2) rows, every unique pattern."""
    from repro_torch.core import query_oracle
    from repro_torch.core._arrays import lexsort

    q = torch.stack(list(cols), dim=1)
    uniq = torch.unique(q, dim=0)
    want = query_oracle(rows_t, uniq[:, 0], uniq[:, 1], uniq[:, 2])
    if view.n_entries != uniq.shape[0] or not torch.equal(uniq[view.qid_entry], q):
        _fail(f"{what}: query -> entry map is wrong")
    owner = torch.repeat_interleave(torch.arange(view.n_entries, device=DEV),
                                    view.entry_counts())
    got = torch.cat([owner[:, None], _hyper_rows(torch, view.labels, view.nodes,
                                                 view.offsets)], 1)
    got = got[lexsort((got[:, 3], got[:, 2], got[:, 1], got[:, 0]))]
    if not torch.equal(got, want):
        _fail(f"{what}: results differ from the plain scan")


def _itr_plus_part(torch, np, seed: int) -> dict:
    """(g) of phase 3d: ITR and ITR+ builds of chess-legal on the card."""
    from repro_torch.core import (
        Hypergraph,
        LabelTable,
        TripleQueryEngine,
        attach_node_labels,
        compress,
        dictionary_cost_itr,
        dictionary_cost_itr_plus,
        encode,
        strip_node_labels,
    )
    from repro_torch.data.synthetic import PAPER_DATASETS
    from repro_torch.kernels import ops

    ds = PAPER_DATASETS[PLUS_DATASET](scale=PLUS_SCALE, seed=seed)
    labelled = int((ds.node_labels >= 0).sum())
    n_kinds = int(ds.node_labels.max()) + 1
    print(f"itr+ dataset {PLUS_DATASET} scale={PLUS_SCALE} triples={ds.n_triples} "
          f"nodes={ds.n_nodes} "
          f"labelled_nodes={labelled} node_labels={n_kinds} preds={ds.n_preds}")
    builds = {}
    for name in ("ITR", "ITR+"):
        before = {k: ops.launch_counts[k] for k in DIGRAM_NAMES}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = Hypergraph.from_triples(ds.triples, ds.n_nodes)
        table = LabelTable.terminals(np.full(ds.n_preds, 2))
        base = None
        if name == "ITR+":
            graph, table, base = attach_node_labels(graph, table, ds.node_labels)
        t1 = time.perf_counter()
        grammar, stats = compress(graph, table)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enc = encode(grammar)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        digram = {k: ops.launch_counts[k] - before[k] for k in DIGRAM_NAMES}
        if digram["digram_pair_accum"] != 1 + stats.iterations or digram["digram_pair_counts"] \
                or digram["digram_select"] < stats.iterations:
            _fail(f"the {name} build of {PLUS_DATASET} launched {digram} over "
                  f"{stats.iterations} replacements")
        rank1 = sum(bool((r.rhs.ranks() == 1).any()) for r in grammar.rules.values())
        builds[name] = {"graph": graph, "table": table, "grammar": grammar, "encoded": enc,
                        "base": base, "build_s": t3 - t0, "compress_s": t2 - t1,
                        "encode_s": t3 - t2, "bytes": enc.size_in_bytes()}
        print(f"itr+ build {name}: edges={graph.n_edges} build_s={t3 - t0:.6f} "
              f"compress_s={t2 - t1:.6f} encode_s={t3 - t2:.6f} iterations={stats.iterations} "
              f"replaced_occurrences={stats.replaced_occurrences} "
              f"rules={len(grammar.rules)} rules_with_rank1_edges={rank1} "
              f"start_edges={grammar.start.n_edges} encoded_bytes={enc.size_in_bytes()} launches "
              + " ".join(f"{k}={v}" for k, v in digram.items()))
    plus = builds["ITR+"]
    # the card's ITR+ grammar against the port's CPU build of the same graph
    t0 = time.perf_counter()
    cpu_graph, cpu_table, _ = attach_node_labels(
        Hypergraph.from_triples(ds.triples, ds.n_nodes, device="cpu"),
        LabelTable.terminals(np.full(ds.n_preds, 2), device="cpu"), ds.node_labels)
    cpu_grammar, _ = compress(cpu_graph, cpu_table)
    cpu_s = time.perf_counter() - t0
    if not _same_grammar(torch, plus["grammar"], cpu_grammar):
        _fail("the card's ITR+ grammar of chess-legal differs from the CPU path's")
    # stripping the decompressed grammar gives back the labels and the triples
    stripped, labels_back = strip_node_labels(plus["grammar"].decompress(), plus["base"], n_kinds)
    starts = stripped.offsets[:-1]
    triples = torch.stack([stripped.nodes_flat[starts], stripped.labels,
                           stripped.nodes_flat[starts + 1]], 1)
    want = torch.unique(torch.from_numpy(ds.triples).to(DEV), dim=0)
    if not torch.equal(labels_back.cpu(), torch.from_numpy(ds.node_labels)) \
            or triples.shape[0] != ds.n_triples or not torch.equal(torch.unique(triples, dim=0),
                                                                   want):
        _fail("strip_node_labels of the decompressed ITR+ grammar differs from the dataset")
    costs = (dictionary_cost_itr(ds.node_label_names, labelled),
             dictionary_cost_itr_plus(ds.node_label_names))
    print(f"itr+ chess-legal: card grammar equal to the CPU build (cpu_s={cpu_s:.6f}); strip "
          f"gives back {labelled} node labels and {ds.n_triples} triples; encoded_bytes "
          f"ITR={builds['ITR']['bytes']} ITR+={plus['bytes']}; dictionary_cost ITR={costs[0]} "
          f"ITR+={costs[1]}")
    # the eight patterns on the ITR+ engine against the plain scan of its
    # hypergraph, rank-1 edges included
    engine = TripleQueryEngine(plus["grammar"], plus["encoded"], cache=None, delta_budget=None)
    g = plus["graph"]
    rows_t = _hyper_rows(torch, g.labels, g.nodes_flat, g.offsets)
    rng = np.random.default_rng(seed + 27)
    picks = rows_t[torch.from_numpy(rng.integers(0, g.n_edges, 4096)).to(DEV)].cpu().numpy()
    far = rng.integers(0, ds.n_nodes, picks.shape[0])
    picks[:, 2] = np.where(picks[:, 2] < 0, far, picks[:, 2])
    label_edges = 0
    for pat, cols in _mutation_batches(torch, np, picks).items():
        view, dt = _timed_view(torch, engine, cols)
        _check_hyper_view(torch, view, cols, rows_t, f"ITR+ {pat}")
        ranks = view.offsets[1:] - view.offsets[:-1]
        rank1 = int((ranks == 1).sum())
        label_edges += rank1
        print(f"itr+ query {pat} queries={cols[0].numel()} unique={view.n_entries} "
              f"results={view.total_results()} rank1_results={rank1} "
              f"us_per_query={dt / cols[0].numel() * 1e6:.3f} scan_equal=True")
    if label_edges == 0:
        _fail("no ITR+ query answered a rank-1 label edge")
    return {"bytes": (builds["ITR"]["bytes"], plus["bytes"]), "costs": costs,
            "itr_grammar": builds["ITR"]["grammar"],
            "build_s": (builds["ITR"]["build_s"], plus["build_s"]), "cpu_s": cpu_s}


def drive_snapshot_path(torch, np, main: dict, seed: int) -> None:
    """Phase 3d: save the mutable engine, open it on the card, query, save
    again, decode, rebuild the opened engine, the broken-snapshot and crash
    controls, then ITR and ITR+ builds of chess-legal."""
    import importlib
    import os
    import shutil
    import tempfile

    import repro_torch.core.query as engine_module
    from repro_torch.core import QueryResultCache, TripleQueryEngine
    from repro_torch.kernels import ops
    from repro_torch.persist.crash import CrashPoint, inject_crashes
    from repro_torch.persist.snapshot import load_snapshot, save_snapshot

    # the package's ``encode`` attribute is the function: the module by name
    encode_module = importlib.import_module("repro_torch.core.encode")
    ds, phase3 = main["dataset"], main["engine"]
    rng = np.random.default_rng(seed + 26)
    base = ds.triples
    logical = set(map(tuple, base.tolist()))
    names = (*K2_NAMES, *DIGRAM_NAMES)
    ops.reset_launch_counts()

    def k2():
        return {k: ops.launch_counts[k] for k in K2_NAMES}

    def since(before):
        return {k: ops.launch_counts[k] - v for k, v in before.items()}

    # (a) the mutable engine with an overlay, saved
    engine = TripleQueryEngine(main["grammar"], phase3.encoded, cache=QueryResultCache(),
                               crossover=phase3.crossover, delta_budget=DELTA_BUDGET)
    if engine.base_edges != ds.n_triples:
        _fail(f"base_edges {engine.base_edges} != {ds.n_triples}")
    taken = set(logical)
    deleted = [tuple(r) for r in base[rng.choice(base.shape[0], MUTATION_BATCH, replace=False)]
               .tolist()]
    inserted = _new_rows(np, rng, MUTATION_BATCH, taken, ds.n_nodes, ds.n_preds,
                         past=MUTATION_PAST)
    for name, rows in (("delete_triples", deleted), ("insert_triples", inserted)):
        applied = getattr(engine, name)(torch.tensor(rows, dtype=torch.int64).to(DEV))
        if applied != MUTATION_BATCH:
            _fail(f"{name} applied {applied} of {MUTATION_BATCH} rows")
    logical = (logical - set(deleted)) | set(inserted)
    logical_t = _oracle_triples(torch, logical)
    if engine.delta.size != 2 * MUTATION_BATCH or engine.rebuild_count:
        _fail(f"the overlay holds {engine.delta.size} rows, not {2 * MUTATION_BATCH}")
    scratch = tempfile.mkdtemp(prefix="itr_snapshot_")
    try:
        path, again = os.path.join(scratch, "snap"), os.path.join(scratch, "again")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_snapshot(engine, path)
        save_ms = (time.perf_counter() - t0) * 1e3
        files = sorted(os.listdir(path))
        nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in files)
        print(f"snapshot save: ms={save_ms:.3f} files={len(files)} bytes_on_disk={nbytes} "
              f"overlay={engine.delta.size} encoded_bytes={engine.encoded.size_in_bytes()}")

        # (b) open on the card: no calibration, so no k2_lines launch
        before = k2()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opened = load_snapshot(path, mmap=True, verify=True)
        torch.cuda.synchronize()
        open_ms = (time.perf_counter() - t0) * 1e3
        opening = since(before)
        t0 = time.perf_counter()
        load_snapshot(path, mmap=False, verify=True, cache=None)
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
        stages = main["stages"]
        build_s = stages["compress"] + stages["encode"]
        print(f"snapshot open (mmap, crc verified): ms={open_ms:.3f} (read without mmap: "
              f"{copy_ms:.3f}) against phase 3's compress + encode s={build_s:.6f} "
              f"({stages['compress']:.6f} + {stages['encode']:.6f}): "
              f"{build_s * 1e3 / open_ms:.1f}x; launches "
              + " ".join(f"{k}={v}" for k, v in opening.items()))
        if any(opening.values()):
            _fail(f"opening the snapshot launched {opening}")
        if opened.device.type != torch.device(DEV).type:
            _fail(f"the snapshot opened on {opened.device}")
        want, got = _state_tensors(engine), _state_tensors(opened)
        differ = sorted(k for k in want if k not in got or got[k].device != opened.device
                        or not torch.equal(got[k], want[k]))
        if differ or len(got) != len(want):
            _fail(f"the opened engine's state differs from the saved engine's: {differ}")
        if _engine_scalars(opened) != _engine_scalars(engine):
            _fail(f"the opened engine's scalars {_engine_scalars(opened)} differ from "
                  f"{_engine_scalars(engine)}")
        if sorted(opened.grammar.rules) != sorted(engine.grammar.rules) or not all(
                _same_graph(torch, opened.grammar.rules[lbl].rhs, engine.grammar.rules[lbl].rhs)
                for lbl in engine.grammar.rules):
            _fail("the opened grammar's rules differ from the saved engine's")
        print(f"snapshot open: {len(want)} state tensors equal to the saved engine's on the "
              f"card; scalars equal: {_engine_scalars(opened)}; {len(opened.grammar.rules)} "
              f"rules equal")

        # (c) the eight patterns on the opened engine against the oracle scan
        n_del, n_ins, n_keep = SNAPSHOT_PICKS
        untouched = sorted(logical - set(inserted))
        picks = np.array([deleted[i] for i in rng.choice(len(deleted), n_del, replace=False)]
                         + [inserted[i] for i in rng.choice(len(inserted), n_ins, replace=False)]
                         + [untouched[i] for i in rng.choice(len(untouched), n_keep)])
        batches = _mutation_batches(torch, np, picks[rng.permutation(len(picks))])

        def eight(what: str, eng) -> dict:
            out, gc_s = {}, {}
            for pat, cols in batches.items():
                before = k2()
                (view, dt), gc_s[pat] = _gc_pause(lambda: _timed_view(torch, eng, cols))
                seeds = since(before)
                _check_view(torch, view, cols, logical_t, f"{pat} {what}")
                so = pat[0] != "?" or pat[2] != "?"
                if seeds != {"bitvec_rank": 0, "k2_lines_count": int(so),
                             "k2_lines_write": int(so)}:
                    _fail(f"{pat} {what} launched {seeds}")
                out[pat] = dt / cols[0].numel() * 1e6
            print(f"snapshot query {what}: us_per_query "
                  + " ".join(f"{p}={v:.3f}" for p, v in out.items())
                  + " oracle_equal=True, one k2_lines_count and k2_lines_write a S/O batch; "
                  + "garbage collector s " + " ".join(f"{p}={v:.6f}" for p, v in gc_s.items()))
            return out

        eight("on the opened engine (cold cache)", opened)

        # (d) saving the opened engine again gives the same files
        save_snapshot(opened, again)
        diff = _dir_diff(path, again)
        if diff:
            _fail(f"the opened engine's snapshot differs from the first in {diff}")
        print(f"snapshot round trip: {len(files)} files equal byte for byte")

        # (e) decode the opened encoding
        dd_s = [0.0]
        real_dd = encode_module.delta_decode

        def timed_dd(*a):
            t = time.perf_counter()
            out = real_dd(*a)
            dd_s[0] += time.perf_counter() - t
            return out

        before = k2()
        encode_module.delta_decode = timed_dd
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decoded = opened.encoded.decode()
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        finally:
            encode_module.delta_decode = real_dd
        decoding = since(before)
        if not _same_grammar(torch, decoded, opened.grammar):
            _fail("decode of the opened encoding differs from the opened grammar")
        t0 = time.perf_counter()
        decoded.validate()
        validate_s = time.perf_counter() - t0
        if decoding != {"bitvec_rank": 0, "k2_lines_count": 1, "k2_lines_write": 1}:
            _fail(f"decode launched {decoding}")
        print(f"decode: s={decode_s:.6f} host_delta_decode_s={dd_s[0]:.6f} "
              f"rest_s={decode_s - dd_s[0]:.6f} (symbols: fn "
              f"{int(opened.encoded.fn_lengths.sum()) + opened.encoded.n_fns}, edge fn "
              f"{opened.encoded.n_edges}, rules {opened.encoded.rule_symbol_count}) equal to the "
              f"opened grammar, validate() passed in {validate_s:.6f} s; launches "
              + " ".join(f"{k}={v}" for k, v in decoding.items()))

        # the broken copies must not open
        for how in ("flipped_byte", "removed_array", "removed_manifest"):
            msg = _broken_open(path, scratch, how)
            if not msg:
                _fail(f"control: a snapshot with a {how.replace('_', ' ')} opened")
            print(f"control {how}: SnapshotError({msg[:90]!r}...)")

        # (f) rebuild the opened engine; first a crash at the swap
        real_compress = engine_module.compress
        built = {}

        def capture(*a, **kw):
            out = real_compress(*a, **kw)
            built["stats"] = out[1]
            return out

        engine_module.compress = capture
        try:
            count, size = opened.rebuild_count, opened.delta.size
            crashed = False
            try:
                with inject_crashes({"engine.rebuild": 1}) as injector:
                    opened.rebuild()
            except CrashPoint:
                crashed = True
            if not crashed or injector.hits.get("engine.rebuild") != 1:
                _fail("control: a crash injected at engine.rebuild did not crash the rebuild")
            if opened.rebuild_count != count or opened.delta.size != size:
                _fail("a crashed rebuild changed the engine")
            cache, opened.cache = opened.cache, None  # answers of the engine, not the cache
            try:
                eight("after a crash at engine.rebuild (no cache)", opened)
            finally:
                opened.cache = cache
            before = {k: ops.launch_counts[k] for k in DIGRAM_NAMES}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = opened.rebuild()
            torch.cuda.synchronize()
            rebuild_s = time.perf_counter() - t0
        finally:
            engine_module.compress = real_compress
        digram = {k: ops.launch_counts[k] - v for k, v in before.items()}
        stats = built["stats"]
        if not done or opened.rebuild_count != count + 1 or not opened.delta.is_empty:
            _fail(f"the opened engine's rebuild left rebuild_count={opened.rebuild_count}, "
                  f"overlay {opened.delta.size}")
        if digram["digram_pair_accum"] != 1 + stats.iterations or digram["digram_pair_counts"] \
                or digram["digram_select"] < stats.iterations:
            _fail(f"the opened engine's rebuild launched {digram} over {stats.iterations} "
                  f"replacements")
        print(f"rebuild of the opened engine: s={rebuild_s:.6f} iterations={stats.iterations} "
              f"rules={len(opened.grammar.rules)} rebuild_count={opened.rebuild_count}; control "
              f"(crash at engine.rebuild) left rebuild_count={count} and overlay={size}; "
              f"launches " + " ".join(f"{k}={v}" for k, v in digram.items()))
        eight("after the rebuild", opened)
        cache, opened.cache = opened.cache, None
        try:
            eight("after the rebuild, again (no cache)", opened)
        finally:
            opened.cache = cache

        # a crash before the commit keeps the first save; the next save clears it
        crashed = False
        try:
            with inject_crashes({"snapshot.pre_commit": 1}):
                save_snapshot(opened, path)
        except CrashPoint:
            crashed = True
        orphan = os.path.isdir(path + ".tmp")
        diff = _dir_diff(path, again)
        first = load_snapshot(path, cache=None)
        if not crashed or not orphan or diff or first.rebuild_count != 0 \
                or first.delta.size != 2 * MUTATION_BATCH:
            _fail(f"control: a crash at snapshot.pre_commit (crashed={crashed}) left orphan="
                  f"{orphan}, changed files {diff}, rebuild_count={first.rebuild_count}")
        save_snapshot(opened, path)
        last = load_snapshot(path, cache=None)
        if os.path.exists(path + ".tmp") or last.rebuild_count != 1 or not last.delta.is_empty:
            _fail("the save after a crashed one did not clear the orphan or commit")
        print("control snapshot.pre_commit: the directory still opens to the first save "
              "(rebuild_count 0, overlay 3072, files unchanged), a .tmp orphan was left; the next "
              "save cleared it and committed (rebuild_count 1, empty overlay)")
        del first, last, opened, engine, decoded
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    # (g) ITR and ITR+ of chess-legal on the card
    plus = _itr_plus_part(torch, np, seed)
    counts = {k: ops.launch_counts[k] for k in names}
    print("snapshot part: launches " + " ".join(f"{k}={v}" for k, v in counts.items()))
    for k in ("k2_lines_count", "k2_lines_write", "digram_pair_accum", "digram_select"):
        if counts[k] == 0:
            _fail(f"the snapshot path launched {k} no time")
    if counts["bitvec_rank"] or counts["digram_pair_counts"]:
        _fail(f"the snapshot path launched {counts}")
    main["snapshot_part"] = {"launches": counts, "itr_plus": plus}


BGP_SHAPES = {  # the reference benchmark's shapes and the slice's, over predicates 0..3
    "chain2": "?a 0 ?b . ?b 1 ?c",
    "chain3": "?a 0 ?b . ?b 1 ?c . ?c 2 ?d",
    "star2": "?h 0 ?a . ?h 1 ?b",
    "star3": "?h 0 ?a . ?h 1 ?b . ?h 2 ?c",
    "cycle2": "?a 0 ?b . ?b 0 ?a",
    "pred_var": "?a ?p ?b . ?b 3 ?c",
    "bench_chain3": "?a 0 ?b . ?b 0 ?c . ?c 0 ?d",
    "bench_star2": "?h 0 ?a . ?h 0 ?b",
}
BGP_OVERLAY_SHAPES = ("chain2", "star2", "pred_var")
JOIN_STEP_SYNCS = 4     # the most host syncs a join step may make outside batch_fn
STRING_QUERIES = 256    # single string queries a side (S bound, O bound)
MALFORMED_LINES = 7     # junk lines planted in the N-Triples file
DICT_PROBES = 10_000    # timed term_to_id and id_to_term calls
STORE_MUTATIONS = 256   # GraphStore inserts and deletes
STORE_NODES = 1024      # nodes of the GraphStore's neighbourhood batches
SPMM_WIDTH = 16         # x's columns for the csr_spmm over the store's CSC


def _bgp_terms(bgp: str) -> list:
    """A BGP string as (s, p, o) tuples of ints and ``?name`` strings."""
    return [tuple(t if t.startswith("?") else int(t) for t in part.split())
            for part in bgp.split(".") if part.strip()]


def _host_index(rows: list) -> tuple:
    """Plain dicts of a triple list by subject and by predicate."""
    by_s, by_p = {}, {}
    for r in rows:
        by_s.setdefault(r[0], []).append(r)
        by_p.setdefault(r[1], []).append(r)
    return by_s, by_p, rows


def _host_bgp(index: tuple, patterns: list) -> list:
    """The bindings of `patterns` over an indexed triple set, by plain
    hash joins in written order (no port code): each binding extended
    through the triples of its bound subject, else of the pattern's
    predicate, else all. Rows in first-appearance variable order, sorted."""
    by_s, by_p, rows = index
    out_vars = list(dict.fromkeys(t for pat in patterns for t in pat if isinstance(t, str)))
    bindings = [{}]
    for pat in patterns:
        nxt = []
        for b in bindings:
            s, p, _ = (b.get(t, t) if isinstance(t, str) else t for t in pat)
            cands = by_s.get(s, ()) if not isinstance(s, str) else \
                by_p.get(p, ()) if not isinstance(p, str) else rows
            for triple in cands:
                ext = dict(b)
                for t, v in zip(pat, triple):
                    if not isinstance(t, str):
                        if t != v:
                            break
                    elif ext.setdefault(t, v) != v:
                        break
                else:
                    nxt.append(ext)
        bindings = nxt
        if not bindings:
            break
    return sorted(tuple(b[v] for v in out_vars) for b in bindings)


def _join_syncs(torch, run) -> tuple:
    """(run's result, one (kind, syncs outside batch_fn, syncs inside it) a
    join step, syncs outside every step) by torch's sync debug mode; kind
    is "unbound" (no bound variable: one scan and a cross product), "bind"
    or "scan" (the step reached the equi-join)."""
    import warnings

    import repro_torch.core.bgp as bgp

    real_step, real_join = bgp._join_step, bgp._join_indices
    log, steps, joins = [], [], [0]

    def syncs(since: int) -> int:
        return sum("synchroniz" in str(w.message) for w in log[0][since:])

    def join(*a, **kw):
        joins[0] += 1
        return real_join(*a, **kw)

    def step(rows, solved, pattern, batch_fn, stats):
        inside = [0]

        def counted(*cols):
            mark = len(log[0])
            try:
                return batch_fn(*cols)
            finally:
                inside[0] += syncs(mark)

        mark, joined = len(log[0]), joins[0]
        unbound = not any(v in solved for v in pattern.variables())
        out = real_step(rows, solved, pattern, counted, stats)
        kind = "unbound" if unbound else "scan" if joins[0] > joined else "bind"
        steps.append((kind, syncs(mark) - inside[0], inside[0]))
        return out

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            log.append(caught)
            bgp._join_step, bgp._join_indices = step, join
            out = run()
    finally:
        bgp._join_step, bgp._join_indices = real_step, real_join
        torch.cuda.set_sync_debug_mode("default")
    return out, steps, syncs(0) - sum(a + b for _, a, b in steps)


def _const_subject(np, rng, by_s) -> int:
    """A subject with at least two objects, one of them a subject too: its
    BGP's first step is one S-bound pattern and its second a few, both
    within the crossover, so both go to the worklist."""
    subjects = sorted(by_s)
    for i in rng.permutation(len(subjects)):
        s = subjects[i]
        objs = {o for _, _, o in by_s[s]}
        if len(objs) >= 2 and any(o in by_s for o in objs):
            return int(s)
    _fail("no subject with two objects, one of them a subject")


def _bgp_part(torch, np, engine, shapes: dict, index: tuple) -> dict:
    """(a): each shape cold (a fresh cache), warm, every step forced to bind,
    every step forced to scan, and in reversed order, each result against
    the host oracle; the join layer's host syncs a step; busy share."""
    import repro_torch.core.bgp as bgp
    from repro_torch.kernels import ops

    stats = engine.selectivity()
    print(f"bgp selectivity: total={stats.total} pred_card={stats.pred_card.tolist()} "
          f"n_subjects={stats.n_subjects} n_objects={stats.n_objects}")
    want = {name: _host_bgp(index, _bgp_terms(q)) for name, q in shapes.items()}
    ms, all_steps, outside = {}, [], 0
    fanout = bgp._BIND_FANOUT

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def held(name, how, res):
        if res.tuples() != want[name]:
            _fail(f"bgp {name} ({how}): {len(res)} rows differ from the host oracle's "
                  f"{len(want[name])}")

    for name, q in shapes.items():
        order = bgp.plan_bgp(bgp.parse_bgp(q), stats)
        runs = {"cold": lambda q=q: engine.query_bgp(q), "warm": lambda q=q: engine.query_bgp(q),
                "bind": lambda q=q, o=order: bgp.execute_bgp(q, engine.query_batch_view, stats,
                                                              order=o),
                "scan": lambda q=q, o=order: bgp.execute_bgp(q, engine.query_batch_view, None,
                                                              order=o),
                "reversed": lambda q=q, o=order: bgp.execute_bgp(q, engine.query_batch_view, stats,
                                                                  order=o[::-1])}
        ms[name], kinds = {}, {}
        for how, run in runs.items():
            if how == "cold":
                engine.cache.clear()
            bgp._BIND_FANOUT = 2**62 if how == "bind" else 0 if how == "scan" else fanout
            try:
                (res, steps, out_steps), dt = timed(lambda run=run: _join_syncs(torch, run))
            finally:
                bgp._BIND_FANOUT = fanout
            held(name, how, res)
            ms[name][how] = dt
            kinds[how] = "+".join(k for k, _, _ in steps)
            all_steps += steps
            outside += out_steps
            if how in ("bind", "scan") and any(k not in ("unbound", how) for k, _, _ in steps):
                _fail(f"bgp {name}: forcing {how} ran steps {kinds[how]}")
        print(f"bgp {name} rows={len(want[name])} order={order} steps cold {kinds['cold']}, "
              f"reversed {kinds['reversed']}; ms " + " ".join(
                  f"{k}={v:.3f}" for k, v in ms[name].items()) + " oracle_equal=True")

    # the comparison must see a dropped binding row
    name = max(want, key=lambda n: len(want[n]))
    res = engine.query_bgp(shapes[name])
    dropped = bgp.BGPResult(res.vars, torch.cat([res.rows[:1], res.rows[2:]]))
    if dropped.tuples() == want[name]:
        _fail("control: a result with one binding row dropped passed the comparison")
    print(f"control dropped_row: {name} with {len(res) - 1} of {len(res)} rows differs from "
          f"the oracle")

    by_kind = {}
    for kind, n, inside in all_steps:
        by_kind.setdefault(kind, []).append((n, inside))
    for kind, vals in sorted(by_kind.items()):
        out_n = [n for n, _ in vals]
        print(f"bgp join-layer host syncs a {kind} step (batch_fn apart; a lower bound): "
              f"min={min(out_n)} max={max(out_n)} steps={len(vals)}; inside batch_fn "
              f"min={min(i for _, i in vals)} max={max(i for _, i in vals)}")
        if max(out_n) > JOIN_STEP_SYNCS:
            _fail(f"a {kind} join step made {max(out_n)} host syncs outside batch_fn")
    print(f"bgp host syncs outside the steps (plan, final sort): {outside}")
    for kind in ("bind", "scan"):
        if kind not in by_kind:
            _fail(f"no {kind} step ran")

    def cold_all():
        engine.cache.clear()
        for q in shapes.values():
            engine.query_bgp(q)

    before = {k: ops.launch_counts[k] for k in K2_NAMES}
    wall, dev_s, _ = _profile(torch, cold_all)
    k2 = {k: ops.launch_counts[k] - v for k, v in before.items()}
    print(f"bgp all {len(shapes)} shapes cold: wall_ms={wall * 1e3:.3f} "
          f"device_ms={dev_s * 1e3:.3f} busy={dev_s / wall:.4f}; launches "
          + " ".join(f"{k}={v}" for k, v in k2.items()))
    return {"ms": ms, "want": want, "busy": dev_s / wall, "k2": k2}


def _runtime_syncs(torch, fn):
    """Synchronising CUDA runtime calls (stream, event and device
    synchronisations, synchronous copies) during one call of fn, from the
    profiler's record of the runtime API: these include the waits that
    torch's sync debug mode does not see (thrust's inside
    ``torch.unique``). None when the profiler recorded no runtime call."""
    from torch.profiler import ProfilerActivity, profile

    waits = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
             "cudaMemcpy")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    names = [e.name for e in prof.events()]
    if not any(n.startswith("cuda") for n in names):
        return None
    return sum(n in waits for n in names)


def _step_sync_probe(torch, engine, stats, shapes: dict) -> None:
    """The host syncs of single join steps with ``batch_fn`` replaying a
    view computed beforehand, so only the step's own work runs: the first
    step (no bound variable) and the second forced to bind and to scan, on
    shapes whose second step meets few and many combos and entries; by the
    sync debug mode and by the profiler's runtime calls (beside two
    calibrations: nothing, and one ``.item()``)."""
    import repro_torch.core.bgp as bgp

    x = torch.ones(4, device=DEV)
    base = _runtime_syncs(torch, lambda: None)
    item = _runtime_syncs(torch, lambda: float(x.sum()))
    print(f"bgp step sync probe: runtime-call calibration: nothing {base}, one .item() {item}")
    fanout = bgp._BIND_FANOUT
    by_kind = {}
    try:
        for name in ("chain2", "bench_star2", "const_subject"):
            pats = bgp.parse_bgp(shapes[name])
            order = bgp.plan_bgp(pats, stats)
            first, second = pats[order[0]], pats[order[1]]
            saved = {}

            def record(*cols):
                saved["view"] = engine.query_batch_view(*cols)
                return saved["view"]

            def replay(*cols):
                return saved["view"]

            empty = torch.zeros((1, 0), dtype=torch.int64)
            rows, solved = bgp._join_step(empty, [], first, record, stats)
            cases = (("unbound", empty, [], first, stats, fanout),
                     ("bind", rows, solved, second, stats, 2**62),
                     ("scan", rows, solved, second, None, 0))
            for kind, r, sv, pat, st, fan in cases:
                bgp._BIND_FANOUT = fan
                out, _ = bgp._join_step(r, sv, pat, record, st)  # computes the view

                def step(r=r, sv=sv, pat=pat, st=st):
                    bgp._join_step(r, sv, pat, replay, st)

                debug = _count_syncs(torch, step)
                runtime = _runtime_syncs(torch, step)
                view = saved["view"]
                by_kind.setdefault(kind, []).append(debug)
                print(f"bgp step sync probe {name} {kind}: table_rows={r.shape[0]} "
                      f"patterns={view.n_queries} entries={view.n_entries} "
                      f"edges={view.labels.numel()} out_rows={out.shape[0]}; host syncs "
                      f"debug_mode={debug} runtime_calls={runtime}")
    finally:
        bgp._BIND_FANOUT = fanout
    for kind, counts in by_kind.items():
        if len(set(counts)) != 1:
            _fail(f"a {kind} join step's host syncs depend on its input: {counts}")


def _overlay_bgps(torch, np, engine, rng, ds, shapes: dict, base_want: dict) -> None:
    """(a) under the overlay: phase 3c-style deletes and inserts, then the
    overlay shapes cold against the oracle of the logical set."""
    base = ds.triples
    logical = set(map(tuple, base.tolist()))
    deleted = [tuple(r) for r in base[rng.choice(base.shape[0], MUTATION_BATCH, replace=False)]
               .tolist()]
    inserted = _new_rows(np, rng, MUTATION_BATCH, set(logical), ds.n_nodes, ds.n_preds,
                         past=MUTATION_PAST)
    for name, rows in (("delete_triples", deleted), ("insert_triples", inserted)):
        applied = getattr(engine, name)(torch.tensor(rows, dtype=torch.int64).to(DEV))
        if applied != MUTATION_BATCH:
            _fail(f"{name} applied {applied} of {MUTATION_BATCH} rows")
    logical = (logical - set(deleted)) | set(inserted)
    index = _host_index(sorted(logical))
    engine.cache.clear()
    moved = 0
    for name in BGP_OVERLAY_SHAPES:
        want = _host_bgp(index, _bgp_terms(shapes[name]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.query_bgp(shapes[name])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        if res.tuples() != want:
            _fail(f"bgp {name} under the overlay differs from the oracle of the logical set")
        changed = len(set(want) ^ set(base_want[name]))
        moved += changed
        print(f"bgp {name} under the overlay ({engine.delta.size} rows): rows={len(want)} "
              f"(base {len(base_want[name])}, {changed} rows gained or lost) ms={dt:.3f} "
              f"oracle_equal=True")
    if not moved:
        _fail("the overlay's rows changed no BGP result")


def _geo_names(ds) -> tuple:
    """IRIs for geo-coordinates-en's nodes (long shared prefixes) and its
    four predicates."""
    nodes = [f"<http://linkedgeodata.example.org/triplify/node/{i:07d}>"
             for i in range(ds.n_nodes)]
    preds = ["<http://www.w3.org/2003/01/geo/wgs84_pos#lat>",
             "<http://www.w3.org/2003/01/geo/wgs84_pos#long>",
             "<http://www.georss.org/georss/point>",
             "<http://www.w3.org/2000/01/rdf-schema#label>"][:ds.n_preds]
    return nodes, preds


def _write_geo_ntriples(ds, rng, path: str) -> tuple:
    """geo-coordinates-en as an N-Triples file at `path` with
    ``MALFORMED_LINES`` junk lines planted at places drawn from `rng`;
    returns (node IRIs, predicate IRIs)."""
    from repro_torch.data import write_ntriples

    nodes, preds = _geo_names(ds)
    write_ntriples(path, ds.triples, nodes, preds)
    with open(path) as f:
        lines = f.readlines()
    for k, at in enumerate(sorted(rng.choice(len(lines), MALFORMED_LINES, replace=False))[::-1]):
        lines.insert(int(at), f"this line {k} is not a statement\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return nodes, preds


def _string_bgp(q: str, nodes: list, preds: list) -> list:
    return [tuple(t if isinstance(t, str) else (preds[t] if k == 1 else nodes[t])
                  for k, t in enumerate(pat)) for pat in _bgp_terms(q)]


def _strings_part(torch, np, main: dict, rng, shapes: dict, want_ids: dict, scratch: str) -> dict:
    """(b): geo-coordinates-en written as N-Triples (with planted junk
    lines), scanned, ingested into an empty engine on the card at the
    default batch and budget (so it rebuilds on its own), then held against
    the file: the logical set through the dictionary, the stats, string
    queries and BGPs, an unknown IRI, the dictionary's files and compaction."""
    import os

    from repro_torch.core import Hypergraph, LabelTable, QueryResultCache, TripleQueryEngine
    from repro_torch.core import compress as compress_fn
    from repro_torch.data import ingest_file, scan_predicates
    from repro_torch.kernels import ops
    from repro_torch.persist.snapshot import load_term_dict, save_term_dict

    ds = main["dataset"]
    path = os.path.join(scratch, "geo.nt")
    t0 = time.perf_counter()
    nodes, preds = _write_geo_ntriples(ds, rng, path)
    write_s = time.perf_counter() - t0
    file_bytes = os.path.getsize(path)
    t0 = time.perf_counter()
    pred_terms, statements = scan_predicates(path)
    scan_s = time.perf_counter() - t0
    print(f"ntriples: {ds.n_triples} statements and {MALFORMED_LINES} junk lines, "
          f"{file_bytes} bytes, written in {write_s:.3f} s; scan_predicates {len(pred_terms)} "
          f"predicates, {statements} statements in {scan_s:.3f} s")
    if sorted(pred_terms) != sorted(preds) or statements != ds.n_triples:
        _fail(f"scan_predicates found {pred_terms} and {statements} statements")

    empty = torch.zeros((0, 3), dtype=torch.int64, device=DEV)
    grammar, _ = compress_fn(Hypergraph.from_triples(empty, 1),
                             LabelTable.terminals([2] * len(pred_terms), device=DEV))
    engine = TripleQueryEngine(grammar, cache=QueryResultCache(),
                               crossover=main["engine"].crossover, delta_budget=DELTA_BUDGET)
    rebuild_s = []
    real_rebuild = engine.rebuild

    def timed_rebuild(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_rebuild(*a, **kw)
        torch.cuda.synchronize()
        rebuild_s.append(time.perf_counter() - t)
        return out

    engine.rebuild = timed_rebuild  # insert_triples calls it past the budget
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = ingest_file(engine, path)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    td = engine.term_dict
    distinct_nodes = len(set(ds.triples[:, 0].tolist()) | set(ds.triples[:, 2].tolist()))
    expect = {"rows": ds.n_triples, "inserted": ds.n_triples, "statements": ds.n_triples,
              "malformed": MALFORMED_LINES, "new_nodes": distinct_nodes,
              "new_preds": len(preds), "batches": -(-ds.n_triples // 4096)}
    got = {k: getattr(stats, k) for k in expect}
    print(f"ingest_file: s={ingest_s:.3f} rows_per_s={ds.n_triples / ingest_s:.1f} "
          f"rebuilds={engine.rebuild_count} rebuild_s={sum(rebuild_s):.3f} "
          f"({', '.join(f'{s:.3f}' for s in rebuild_s)}) overlay={engine.delta.size}; stats {got}")
    if got != expect:
        _fail(f"IngestStats {got} differ from the plain count {expect}")
    if len(stats.malformed_samples) != min(MALFORMED_LINES, 5) or not all(
            "is not a statement" in s for s in stats.malformed_samples):
        _fail(f"the malformed samples are {stats.malformed_samples}")
    if not engine.rebuild_count or engine.rebuild_count != len(rebuild_s):
        _fail(f"ingestion rebuilt {engine.rebuild_count} times ({len(rebuild_s)} timed)")

    # the logical set, read through the dictionary, is the file's statements
    node_terms, pred_names = td.nodes.terms_in_id_order(), td.preds.terms_in_id_order()
    cur = engine.current_triples().tolist()
    got_set = {(node_terms[s], pred_names[p], node_terms[o]) for s, p, o in cur}
    file_set = {(nodes[s], preds[p], nodes[o]) for s, p, o in ds.triples.tolist()}
    if len(cur) != ds.n_triples or got_set != file_set:
        _fail(f"the ingested engine holds {len(cur)} triples, not the file's statements")
    print(f"ingested logical set: {len(cur)} triples equal to the file's statements through "
          f"the dictionary ({td.n_nodes} node terms, {td.n_preds} predicate terms)")

    # single string queries, S bound and O bound, against a string oracle
    by_s, by_o = {}, {}
    for t in file_set:
        by_s.setdefault(t[0], set()).add(t)
        by_o.setdefault(t[2], set()).add(t)
    subs, objs = sorted(by_s), sorted(by_o)
    us = {"s": [], "o": []}
    before = {k: ops.launch_counts[k] for k in K2_NAMES}
    for side, pool, oracle in (("s", subs, by_s), ("o", objs, by_o)):
        for i in rng.choice(len(pool), STRING_QUERIES, replace=False):
            term = pool[int(i)]
            q = (term, None, None) if side == "s" else (None, None, term)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ans = engine.query_strings(*q)
            us[side].append((time.perf_counter() - t0) * 1e6)
            if len(ans) != len(oracle[term]) or set(ans) != oracle[term]:
                _fail(f"query_strings{q} differs from the string oracle")
    k2 = {k: ops.launch_counts[k] - v for k, v in before.items()}
    print(f"query_strings: {STRING_QUERIES} S-bound {_pcts(np, us['s'])}, {STRING_QUERIES} "
          f"O-bound {_pcts(np, us['o'])}, all equal to the string oracle; launches "
          + " ".join(f"{k}={v}" for k, v in k2.items()))

    # an unknown IRI answers [] and launches nothing
    before = {k: ops.launch_counts[k] for k in ops.launch_counts}
    unknown = "<http://linkedgeodata.example.org/triplify/node/unknown>"
    if engine.query_strings(unknown, None, None) != [] or engine.query_strings(
            None, preds[0], unknown) != [] or engine.query_bgp_strings(
            [("?x", "<http://example.org/no-such-predicate>", "?y")]) != []:
        _fail("an unknown term answered something")
    launched = {k: v - before[k] for k, v in ops.launch_counts.items() if v != before[k]}
    if launched:
        _fail(f"queries with an unknown term launched {launched}")
    print("unknown terms: query_strings and query_bgp_strings answered [] with no launch")

    # the BGP shapes in strings, against the oracle's rows mapped to terms
    for name, q in shapes.items():
        res = engine.query_bgp_strings(_string_bgp(q, nodes, preds))
        terms = _bgp_terms(q)
        pred_vars = {pat[1] for pat in terms if isinstance(pat[1], str)}
        names_of = [preds if v in pred_vars else nodes for v in dict.fromkeys(
            t for pat in terms for t in pat if isinstance(t, str))]
        want = sorted(tuple(names_of[j][v] for j, v in enumerate(row)) for row in want_ids[name])
        got_rows = sorted(tuple(r.values()) for r in res)
        if got_rows != want:
            _fail(f"query_bgp_strings {name}: {len(res)} rows differ from the oracle's")
    print(f"query_bgp_strings: {len(shapes)} shapes equal to the oracle in terms")

    # the dictionary: lookups, size, files, compaction
    probe = [node_terms[int(i)] for i in rng.integers(0, len(node_terms), DICT_PROBES)]
    ids = [int(i) for i in rng.integers(0, len(node_terms), DICT_PROBES)]
    compact = td.compacted()
    timings = {}
    for label, d in (("live", td), ("compacted", compact)):
        t0 = time.perf_counter()
        for t in probe:
            d.node_id(t)
        t1 = time.perf_counter()
        for i in ids:
            d.node_term(i)
        t2 = time.perf_counter()
        timings[label] = ((t1 - t0) / DICT_PROBES * 1e6, (t2 - t1) / DICT_PROBES * 1e6,
                          d.bytes_per_term(), d.size_in_bytes())
    raw = sum(len(t.encode()) for t in node_terms) + sum(len(t.encode()) for t in pred_names)
    print("term dictionary (host): " + "; ".join(
        f"{k} term_to_id_us={a:.3f} id_to_term_us={b:.3f} bytes_per_term={c:.3f} "
        f"bytes={e}" for k, (a, b, c, e) in timings.items())
        + f"; raw UTF-8 {raw} bytes")
    if compact.nodes.n_extra or compact.nodes.terms_in_id_order() != node_terms \
            or compact.preds.terms_in_id_order() != pred_names:
        _fail("compacted() moved an id")
    t0 = time.perf_counter()
    save_term_dict(td, os.path.join(scratch, "td"))
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = load_term_dict(os.path.join(scratch, "td"))
    load_ms = (time.perf_counter() - t0) * 1e3
    if back.nodes.terms_in_id_order() != node_terms or \
            back.preds.terms_in_id_order() != pred_names or any(
            back.node_id(t) != td.node_id(t) for t in probe):
        _fail("save_term_dict -> load_term_dict changed an id or a term")
    print(f"term dictionary files: save_ms={save_ms:.3f} load_ms={load_ms:.3f}, every id and "
          f"term kept; compacted() kept every id")
    return {"ingest_s": ingest_s, "rebuilds": engine.rebuild_count, "rebuild_s": sum(rebuild_s),
            "us": us, "dict": timings}


def _plain_views(np, rows: np.ndarray, n: int) -> dict:
    """(row, column) pairs of the CSR and CSC of `rows`, sorted, and their
    row pointers, by numpy on the host."""
    out = {}
    for name, (a, b) in (("csr", (0, 2)), ("csc", (2, 0))):
        pairs = rows[:, [a, b]]
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
        out[name] = (np.concatenate([[0], np.cumsum(np.bincount(rows[:, a], minlength=n))]),
                     pairs)
    return out


def _check_store_views(torch, np, store, rows: np.ndarray, what: str) -> None:
    """csr, csc and edge_index of `store` against a plain sort of `rows`."""
    want = _plain_views(np, rows, store.n_nodes)
    for name in ("csr", "csc"):
        indptr, indices = getattr(store, name)()
        if indptr.device.type != torch.device(DEV).type or indices.dtype != torch.int64:
            _fail(f"{what}: the {name} view is not int64 on the card")
        ptr, pairs = indptr.cpu().numpy(), indices.cpu().numpy()
        owner = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
        got = np.stack([owner, pairs], 1)
        got = got[np.lexsort((got[:, 1], got[:, 0]))]
        if not (np.array_equal(ptr, want[name][0]) and np.array_equal(got, want[name][1])):
            _fail(f"{what}: the {name} view differs from a plain sort of the triples")
    senders, receivers = store.edge_index()
    indptr, indices = store.csr()
    if not (torch.equal(receivers, indices) and torch.equal(
            senders, torch.repeat_interleave(torch.arange(store.n_nodes, device=DEV),
                                             indptr[1:] - indptr[:-1]))):
        _fail(f"{what}: edge_index differs from the CSR")


def _store_part(torch, np, main: dict, rng) -> dict:
    """(c): GraphStore.from_triples on the card, its views against a plain
    sort, after an insert and a delete too, its neighbourhoods against the
    oracle, and one csr_spmm over its CSC against the kernel's twins."""
    from repro_torch.data import GraphStore
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_matmul import CSR

    ds = main["dataset"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = GraphStore.from_triples(torch.from_numpy(ds.triples), ds.n_nodes, ds.n_preds)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _ = store.csr(), store.csc()
    torch.cuda.synchronize()
    views_ms = (time.perf_counter() - t0) * 1e3
    _check_store_views(torch, np, store, ds.triples, "GraphStore")
    print(f"GraphStore.from_triples on the card: s={build_s:.3f} (crossover "
          f"{store.engine.crossover}) compressed_bytes={store.compressed_size_bytes()}; csr + "
          f"csc materialized in {views_ms:.3f} ms, equal to a plain sort; edge_index equal")

    logical = set(map(tuple, ds.triples.tolist()))
    dead = [tuple(r) for r in ds.triples[rng.choice(ds.n_triples, STORE_MUTATIONS,
                                                      replace=False)].tolist()]
    new = _new_rows(np, rng, STORE_MUTATIONS, set(logical), ds.n_nodes, ds.n_preds)
    if store.insert_triples(torch.tensor(new, dtype=torch.int64).to(DEV)) != STORE_MUTATIONS \
            or store._csr is not None:
        _fail("GraphStore insert_triples applied the wrong count or kept its views")
    _ = store.csr()
    if store.delete_triples(torch.tensor(dead, dtype=torch.int64).to(DEV)) != STORE_MUTATIONS \
            or store._csr is not None:
        _fail("GraphStore delete_triples applied the wrong count or kept its views")
    logical = (logical - set(dead)) | set(new)
    rows = np.array(sorted(logical), dtype=np.int64)
    _check_store_views(torch, np, store, rows, "GraphStore after an insert and a delete")
    try:
        store.insert_triples([[0, 0, ds.n_nodes]])
        _fail("GraphStore took a node id past n_nodes")
    except ValueError:
        pass
    outs, ins = {}, {}
    for s, _, o in rows.tolist():
        outs.setdefault(s, set()).add(o)
        ins.setdefault(o, set()).add(s)
    vs = rng.integers(0, ds.n_nodes, STORE_NODES).tolist()
    for side, lists, oracle in (("out", store.neighbors_out_batch(vs), outs),
                                ("in", store.neighbors_in_batch(vs), ins)):
        if any(lst.tolist() != sorted(oracle.get(v, ())) for v, lst in zip(vs, lists)):
            _fail(f"GraphStore neighbors_{side}_batch differs from the oracle")
    print(f"GraphStore after {STORE_MUTATIONS} inserts and {STORE_MUTATIONS} deletes: views "
          f"dropped and rebuilt overlay-applied, equal to a plain sort; {STORE_NODES} "
          f"neighbourhoods a side equal to the oracle")

    # the store feeding the GNN path: one csr_spmm over its CSC
    indptr, indices = store.csc()
    a = CSR(indptr, indices.to(torch.int32), store.n_nodes)
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(0, 2**31)))
    x = torch.randn(store.n_nodes, SPMM_WIDTH, generator=gen, device=DEV)
    before = {k: ops.launch_counts[k] for k in ("csr_spmm", "csr_spmm_combine")}
    got = ops.csr_spmm(x, a)
    torch.cuda.synchronize()
    spmm = {k: ops.launch_counts[k] - v for k, v in before.items()}
    want = ref.csr_spmm_ref(x, a.row_ptr, a.col, a.n_rows)
    err, same = _split_close(torch, got, a, x)
    if not _spmm_close(torch, got, want, torch.float32) or err is None:
        _fail("csr_spmm over the GraphStore's CSC differs from its twins")
    if spmm != {"csr_spmm": 1, "csr_spmm_combine": int(a.plan.n_long > 0)}:
        _fail(f"csr_spmm over the CSC launched {spmm}")
    print(f"csr_spmm over the GraphStore's CSC ({a.n_rows} rows, {a.col.numel()} edges, "
          f"{a.plan.n_long} cut rows, D {SPMM_WIDTH}): max_abs_err against the split twin "
          f"{err:.3e}, bit-identical={same}; within {SPMM_F32_SCALED} x max|want| of the plain "
          f"twin; launches " + " ".join(f"{k}={v}" for k, v in spmm.items()))
    return {"build_s": build_s, "spmm_err": err}


def drive_bgp_path(torch, np, main: dict, seed: int) -> None:
    """Phase 3e: BGP joins on phase 3's engine (cold, warm, forced bind and
    scan, reversed, under the overlay), N-Triples ingestion into an empty
    engine on the card with string queries and the term dictionary, and
    GraphStore with one csr_spmm over its CSC."""
    import shutil
    import tempfile

    from repro_torch.core import QueryResultCache, TripleQueryEngine
    from repro_torch.kernels import ops

    ds, phase3 = main["dataset"], main["engine"]
    rng = np.random.default_rng(seed + 27)
    names = (*K2_NAMES, *DIGRAM_NAMES, "csr_spmm", "csr_spmm_combine")
    ops.reset_launch_counts()

    engine = TripleQueryEngine(main["grammar"], phase3.encoded, cache=QueryResultCache(),
                               crossover=phase3.crossover, delta_budget=DELTA_BUDGET)
    index = _host_index(ds.triples.tolist())
    shapes = dict(BGP_SHAPES)
    s0 = _const_subject(np, rng, index[0])
    shapes["const_subject"] = f"{s0} ?p ?o . ?o ?q ?r"
    print(f"bgp engine: geo-coordinates-en, {ds.n_triples} triples, crossover "
          f"{engine.crossover}, a QueryResultCache(); const_subject binds node {s0}")
    part = _bgp_part(torch, np, engine, shapes, index)
    _step_sync_probe(torch, engine, engine.selectivity(), shapes)
    _overlay_bgps(torch, np, engine, rng, ds, shapes, part["want"])
    del engine

    scratch = tempfile.mkdtemp(prefix="itr_ntriples_")
    try:
        strings = _strings_part(torch, np, main, rng, shapes, part["want"], scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    store = _store_part(torch, np, main, rng)

    counts = {k: ops.launch_counts[k] for k in names}
    print("bgp part: launches " + " ".join(f"{k}={v}" for k, v in counts.items()))
    for k in ("k2_lines_count", "k2_lines_write", "digram_pair_accum", "digram_select",
              "csr_spmm"):
        if counts[k] == 0:
            _fail(f"the BGP path launched {k} no time")
    if counts["bitvec_rank"] or counts["digram_pair_counts"]:
        _fail(f"the BGP path launched {counts}")
    main["bgp_part"] = {"launches": counts, "bgp": part, "strings": strings, "store": store,
                        "shapes": shapes}


SHARD_COUNTS = (1, 2, 4)               # the reference benchmark's (benchmarks/query_latency.py:67)
SHARDED_MIXED = ("s??", "sp?", "?p?", "??o")  # its mixed cycle (:68)
TIER_ROWS = 4096          # rows of the mixed traffic; patterns of a scatter batch
TIER_CACHE_ENTRIES = 4 * TIER_ROWS  # a tier cache's general entries: the traffic's all fit
SCATTER_SYNC_WIDTHS = (256, 4096)   # patterns of the flushes whose host syncs are counted
TIER_MUTATIONS = 1536     # deletes and inserts on the predicate_hash tier
TIER_PICKS = (512, 512, 1024)  # rows of the tier checks after the writes, and of 3g's: deleted,
                               # inserted, untouched (1,024, 1,024, 2,048 until phase 9)
GROWTH_ROWS = 12288       # inserts past n_nodes that grow the graph ...
GROWTH_BATCH = 4096       # ... in batches of this many (1,024 until phase 9)
GROWTH_SKEW = 1.5         # the growing tiers' auto-rebalance trigger
MOTION_ROWS = 512         # query rows between growth batches
MOTION_VICTIMS = 64       # rows deleted while in motion
TIER_STRINGS = 32         # string queries a side on the ingested tier (64 until 9, 256 until 7c)
STRESS_SECONDS = 1.0      # the concurrency run, a strategy (10 s until 3g, 5 until 7c, 2 until 9)
STRESS_READERS = 4
STRESS_CHURN = 2048       # the churn pool's rows
STRESS_PAUSE_S = 0.5      # the rebalancer's pause between calls (a re-cut decompresses
                          # every shard at full size)


def _pattern_cols(np, rows, pat: str) -> list:
    """Host int64 columns binding `pat` from `rows` (-1 unbound)."""
    return [rows[:, i].astype(np.int64) if pat[i] != "?" else np.full(len(rows), -1, np.int64)
            for i in range(3)]


def _mixed_cols(np, rows) -> list:
    """The reference's mixed cycle over `rows`: row i takes pattern i mod 4."""
    cols = [np.full(len(rows), -1, np.int64) for _ in range(3)]
    for j, pat in enumerate(SHARDED_MIXED):
        for i in range(3):
            if pat[i] != "?":
                cols[i][j::len(SHARDED_MIXED)] = rows[j::len(SHARDED_MIXED), i]
    return cols


def _eight_cols(np, rows) -> list:
    """All eight patterns over `rows` (four rows for ???), one batch."""
    parts = [_pattern_cols(np, rows[:4] if pat == "???" else rows, pat)
             for pat in PATTERNS + ("???",)]
    return [np.concatenate([p[i] for p in parts]) for i in range(3)]


def _submit_view(svc, cols):
    """Submit every pattern of the host columns, then one flush_view."""
    for s, p, o in zip(*(c.tolist() for c in cols)):
        svc.submit(s, p, o)
    return svc.flush_view()


def _tier_check(torch, view, cols, triples_t, what: str) -> None:
    _check_view(torch, view, [torch.from_numpy(c).to(DEV) for c in cols], triples_t, what)


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _launches(ops, before: dict) -> dict:
    return {k: v - before[k] for k, v in ops.launch_counts.items() if v != before[k]}


def _sorted_rows(torch, t):
    from repro_torch.core._arrays import lexsort

    return t[lexsort((t[:, 2], t[:, 1], t[:, 0]))]


def _logical_rows(svc) -> set:
    """The tier's logical triple set, read from its engines (one host copy a
    shard)."""
    return {tuple(r) for e in svc.engines for r in e.current_triples().tolist()}


def _detached(svc):
    """Take the tier's caches off (shared tier and every engine's view);
    returns what puts them back."""
    saved = (svc.cache, [e.cache for e in svc.engines])
    svc.cache = None
    for e in svc.engines:
        e.cache = None

    def restore():
        svc.cache = saved[0]
        for e, c in zip(svc.engines, saved[1]):
            e.cache = c
    return restore


def _tier_builds(torch, np, main: dict, rng) -> dict:
    """(a) and (b): a tier of each strategy at P = 1, 2, 4 (build seconds,
    shard sizes, the shards' union equal to the triples, one accumulation
    a Count and a replacement), the mixed cycle over 4,096 rows cold and
    warm against the oracle (the warm pass launches nothing). Returns the
    P = 4 tiers."""
    import repro_torch.serve.sharded as sharded
    from repro_torch.core import QueryResultCache
    from repro_torch.kernels import ops
    from repro_torch.serve import ShardedTripleService

    ds, phase3 = main["dataset"], main["engine"]
    triples_t = main["triples"]
    want_rows = _sorted_rows(torch, triples_t)
    rows = ds.triples[rng.integers(0, ds.n_triples, TIER_ROWS)]
    cols = _mixed_cols(np, rows)
    real_compress, iterations = sharded.compress, []

    def counted(*a, **kw):
        out = real_compress(*a, **kw)
        iterations.append(out[1].iterations)
        return out

    tiers, results = {}, {}
    for strategy in ("predicate_hash", "node_range"):
        for n_shards in SHARD_COUNTS:
            what = f"tier {strategy} P={n_shards}"
            before = dict(ops.launch_counts)
            iterations.clear()
            sharded.compress = counted
            try:
                svc, build_s = _timed(torch, lambda: ShardedTripleService.build(
                    ds.triples, ds.n_nodes, ds.n_preds, n_shards=n_shards, strategy=strategy,
                    cache=QueryResultCache(max_entries=TIER_CACHE_ENTRIES),
                    crossover=phase3.crossover, delta_budget=DELTA_BUDGET,
                    rebalance_skew=None, device=DEV))
            finally:
                sharded.compress = real_compress
            accum = ops.launch_counts["digram_pair_accum"] - before["digram_pair_accum"]
            if accum != sum(1 + it for it in iterations) or len(iterations) != n_shards:
                _fail(f"{what}: digram_pair_accum launched {accum} times, not the "
                      f"sum of 1 + iterations {iterations}")
            union = _sorted_rows(torch, torch.cat([e.current_triples() for e in svc.engines]))
            if not torch.equal(union, want_rows):
                _fail(f"{what}: the shards' triples are not the dataset's")
            view, cold_s = _timed(torch, lambda: _submit_view(svc, cols))
            _tier_check(torch, view, cols, triples_t, f"{what} mixed cold")
            st = svc.stats
            routing = (st.owned, st.scattered, st.shard_batches)
            before = dict(ops.launch_counts)
            hits0 = svc.cache.stats.hits
            view, warm_s = _timed(torch, lambda: _submit_view(svc, cols))
            launched = _launches(ops, before)
            _tier_check(torch, view, cols, triples_t, f"{what} mixed warm")
            if launched:
                _fail(f"{what}: the warm mixed pass launched {launched}")
            print(f"{what}: build_s={build_s:.3f} shard_sizes={svc.shard_sizes()} "
                  f"iterations={iterations}; mixed {TIER_ROWS} rows cold_us_per_query="
                  f"{cold_s / TIER_ROWS * 1e6:.3f} warm_us_per_query="
                  f"{warm_s / TIER_ROWS * 1e6:.3f} owned={routing[0]} scattered={routing[1]} "
                  f"shard_batches={routing[2]} merged_hits={st.merged_hits} warm cache hits "
                  f"{svc.cache.stats.hits - hits0}, no launch; oracle_equal=True")
            results[what] = {"build_s": build_s, "cold_us": cold_s / TIER_ROWS * 1e6,
                             "warm_us": warm_s / TIER_ROWS * 1e6, "routing": routing}
            if n_shards == max(SHARD_COUNTS):
                tiers[strategy] = svc
            else:
                svc.close()
    return {"tiers": tiers, "results": results}


def _flush_syncs(torch, svc, cols) -> tuple:
    """(the flush's own host syncs, those inside the engines' batches) of
    one sequential submit + flush_view, by torch's sync debug mode."""
    import warnings

    log, inside = [], [0]

    def syncs(since: int) -> int:
        return sum("synchroniz" in str(w.message) for w in log[0][since:])

    for e in svc.engines:
        def counted(*a, _real=e.query_batch_view):
            mark = len(log[0])
            try:
                return _real(*a)
            finally:
                inside[0] += syncs(mark)
        e.query_batch_view = counted
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            log.append(caught)
            _submit_view(svc, cols)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for e in svc.engines:
            del e.query_batch_view
    return syncs(0) - inside[0], inside[0]


def _same_tier_view(torch, a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("labels", "nodes", "offsets", "entry_bounds", "qid_entry"))


def _tier_scatter(torch, np, main: dict, tiers: dict) -> dict:
    """(c): ?p? under node_range and ??o under predicate_hash at P = 4,
    4,096 patterns, the caches detached, against phase 3's engine; the
    pool at 1 and 4 threads (views equal tensor for tensor); the flush's
    own host syncs at 256 and 4,096 patterns; busy share; the control (a
    merged entry without its last shard's chunk) must fail."""
    engine, triples_t = main["engine"], main["triples"]
    rows = main["pick"][:TIER_ROWS]
    out = {}
    for pat, strategy in (("?p?", "node_range"), ("??o", "predicate_hash")):
        svc = tiers[strategy]
        cols = _pattern_cols(np, rows, pat)
        cols_t = [torch.from_numpy(c).to(DEV) for c in cols]
        restore = _detached(svc)
        try:
            single = min(_timed(torch, lambda: engine.query_batch_view(*cols_t))[1]
                         for _ in range(2))
            views, secs = {}, {}
            for threads in (1, 4, 1, 4):  # in turns
                svc.set_serve_threads(threads)
                view, dt = _timed(torch, lambda: _submit_view(svc, cols))
                views[threads] = view
                secs[threads] = min(secs.get(threads, dt), dt)
            _tier_check(torch, views[1], cols, triples_t, f"scatter {pat} [{strategy}]")
            if not _same_tier_view(torch, views[1], views[4]):
                _fail(f"scatter {pat} [{strategy}]: the threaded view differs from the "
                      f"sequential one")
            svc.set_serve_threads(1)
            syncs = {w: _flush_syncs(torch, svc, [c[:w] for c in cols])
                     for w in SCATTER_SYNC_WIDTHS}
            wall, dev_s, _ = _profile(torch, lambda: _submit_view(svc, cols))
            if pat == "??o":
                real_merge = svc._merge

                def dropped(work, views_, *a):
                    return real_merge(work[:-1], views_[:-1], *a)
                svc._merge = dropped
                try:
                    broken = _submit_view(svc, cols)
                finally:
                    del svc._merge
                got, want = _view_rows(torch, broken, cols_t, triples_t)
                if got is not None and torch.equal(got, want):
                    _fail("control: merged entries without their last shard's chunks passed "
                          "the oracle check")
                print(f"control last_chunk_dropped: scatter {pat} [{strategy}] without shard "
                      f"{svc.n_shards - 1}'s chunks differs from the oracle")
        finally:
            restore()
            svc.set_serve_threads(None)
        own = {w: s for w, (s, _) in syncs.items()}
        if len(set(own.values())) != 1:
            _fail(f"scatter {pat}: the flush's own host syncs grow with its patterns: {own}")
        print(f"scatter {pat} [{strategy}] P={svc.n_shards} {TIER_ROWS} patterns, caches "
              f"detached: single_engine_us={single / TIER_ROWS * 1e6:.3f} "
              f"sharded_us threads=1 {secs[1] / TIER_ROWS * 1e6:.3f}, threads=4 "
              f"{secs[4] / TIER_ROWS * 1e6:.3f} (views equal); host syncs of a sequential "
              f"flush (own, in the engines): " + ", ".join(
                  f"{w} patterns {s}, {i}" for w, (s, i) in syncs.items())
              + f"; wall_ms={wall * 1e3:.3f} device_ms={dev_s * 1e3:.3f} "
              f"busy={dev_s / wall:.4f}; oracle_equal=True")
        out[pat] = {"single_us": single / TIER_ROWS * 1e6,
                    "threads_1_us": secs[1] / TIER_ROWS * 1e6,
                    "threads_4_us": secs[4] / TIER_ROWS * 1e6, "syncs": syncs,
                    "busy": dev_s / wall}
    return out


def _tier_bgps(torch, main: dict, tiers: dict) -> dict:
    """(g), joins: phase 3e's nine shapes through each P = 4 tier's
    query_bgp, cold (the cache cleared) against phase 3e's host oracle; a
    warm repeat served from the merged BGP cache with no launch; then cold
    again with the pool off (one thread)."""
    from repro_torch.kernels import ops

    shapes, want = main["bgp_part"]["shapes"], main["bgp_part"]["bgp"]["want"]
    out = {}
    for strategy, svc in tiers.items():
        ms, seq = {}, {}
        for name, q in shapes.items():
            svc.cache.clear()
            res, cold = _timed(torch, lambda q=q: svc.query_bgp(q))
            if res.tuples() != want[name]:
                _fail(f"tier {strategy} bgp {name}: {len(res)} rows differ from the host "
                      f"oracle's {len(want[name])}")
            before, hits = dict(ops.launch_counts), svc.stats.bgp_cache_hits
            again, warm = _timed(torch, lambda q=q: svc.query_bgp(q))
            if _launches(ops, before) or svc.stats.bgp_cache_hits != hits + 1 or \
                    again.tuples() != want[name]:
                _fail(f"tier {strategy} bgp {name}: the warm repeat was not a cache hit")
            ms[name] = (cold * 1e3, warm * 1e3)
        svc.set_serve_threads(1)
        try:
            for name, q in shapes.items():
                svc.cache.clear()
                res, cold = _timed(torch, lambda q=q: svc.query_bgp(q))
                if res.tuples() != want[name]:
                    _fail(f"tier {strategy} bgp {name}, one thread: rows differ")
                seq[name] = cold * 1e3
        finally:
            svc.set_serve_threads(None)
        print(f"tier {strategy} bgp (pool of {min(svc.serve_threads, svc.n_shards)} threads): "
              + " ".join(f"{n}={c:.3f}/{w:.3f}" for n, (c, w) in ms.items())
              + " ms cold/warm; one thread, cold: " + " ".join(
                  f"{n}={c:.3f}" for n, c in seq.items())
              + " ms; every shape equal to the host oracle, warm from the merged cache with "
                "no launch")
        out[strategy] = {"ms": ms, "one_thread_cold_ms": seq}
    return out


def _tier_writes(torch, np, main: dict, svc, rng) -> tuple:
    """(d): 1,536 deletes and 1,536 inserts on the P = 4 predicate_hash tier,
    every predicate but the last (so its shard is untouched): only the
    mutated shards' generations move and a warm pattern of the untouched
    shard still hits; the answers against the oracle of the logical set;
    rebuild(shard=k) of one mutated shard against a fresh build of the
    mutated set. Returns (the logical set, readings)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import ShardedTripleService
    from repro_torch.serve.sharded import _MERGED_SHARD

    ds, cache = main["dataset"], svc.cache
    last = ds.n_preds - 1
    k_last = int(svc.plan.route(-1, last, -1))
    logical = {tuple(r) for r in ds.triples.tolist()}
    base = ds.triples[ds.triples[:, 1] != last]
    dels = base[rng.choice(len(base), TIER_MUTATIONS, replace=False)]
    ins = np.array(_new_rows(np, rng, TIER_MUTATIONS, set(logical), ds.n_nodes, last),
                   dtype=np.int64)
    k_rows = ds.triples[ds.triples[:, 1] == last]
    warm_cols = _pattern_cols(np, k_rows[rng.choice(len(k_rows), min(256, len(k_rows)),
                                                     replace=False)], "sp?")
    warm_cols = [np.concatenate([c, [v]]) for c, v in zip(warm_cols, (-1, last, -1))]
    _submit_view(svc, warm_cols)  # now warm
    gens = [cache.generation(k) for k in range(svc.n_shards)]
    merged = cache.generation(_MERGED_SHARD)
    n_del, del_s = _timed(torch, lambda: svc.delete_triples(dels))
    n_ins, ins_s = _timed(torch, lambda: svc.insert_triples(ins))
    logical -= {tuple(r) for r in dels.tolist()}
    logical |= {tuple(r) for r in ins.tolist()}
    if (n_del, n_ins) != (TIER_MUTATIONS, TIER_MUTATIONS):
        _fail(f"tier writes applied {n_del} deletes and {n_ins} inserts")
    moved = [k for k in range(svc.n_shards) if cache.generation(k) != gens[k]]
    if k_last in moved or len(moved) != svc.n_shards - 1 or \
            cache.generation(_MERGED_SHARD) == merged:
        _fail(f"tier writes bumped shards {moved} (untouched {k_last}) and the merged "
              f"namespace {cache.generation(_MERGED_SHARD) != merged}")
    before, hits = dict(ops.launch_counts), cache.stats.hits
    view = _submit_view(svc, warm_cols)
    n_warm = view.n_entries
    if _launches(ops, before) or cache.stats.hits - hits != n_warm:
        _fail(f"tier writes: the untouched shard's warm patterns did not all hit "
              f"({cache.stats.hits - hits} of {n_warm}, launches {_launches(ops, before)})")
    logical_t = _oracle_triples(torch, logical)
    p_del, p_ins, p_kept = TIER_PICKS
    picks = np.concatenate([dels[:p_del], ins[:p_ins], ds.triples[rng.integers(
        0, ds.n_triples, p_kept)]])
    main["tier_batches"] = {"dels": dels, "ins": ins, "picks": picks}  # phase 3g's too
    cols = _eight_cols(np, picks)
    _tier_check(torch, _submit_view(svc, cols), cols, logical_t, "tier after writes")
    k = moved[0]
    rebuilt, rebuild_s = _timed(torch, lambda: svc.rebuild(shard=k))
    if rebuilt != [k] or svc.delta_sizes()[k]:
        _fail(f"rebuild(shard={k}) gave {rebuilt}, overlay {svc.delta_sizes()}")
    mutated = np.array(sorted(logical), dtype=np.int64)
    full, full_s = _timed(torch, lambda: ShardedTripleService.build(
        mutated, ds.n_nodes, ds.n_preds, n_shards=svc.n_shards, strategy="predicate_hash",
        cache=None, crossover=main["engine"].crossover, delta_budget=None,
        rebalance_skew=None, device=DEV))
    full.close()
    del full
    _tier_check(torch, _submit_view(svc, cols), cols, logical_t, "tier after rebuild")
    print(f"tier writes [predicate_hash P={svc.n_shards}]: delete {TIER_MUTATIONS} "
          f"{del_s * 1e3:.3f} ms, insert {TIER_MUTATIONS} {ins_s * 1e3:.3f} ms; generations "
          f"moved on shards {moved} and the merged namespace, shard {k_last} untouched: "
          f"{n_warm} warm patterns all hit with no launch; rebuild(shard={k}) "
          f"{rebuild_s:.3f} s against a full build of the mutated set {full_s:.3f} s "
          f"({full_s / rebuild_s:.2f}x); oracle_equal=True")
    return logical, {"delete_ms": del_s * 1e3, "insert_ms": ins_s * 1e3,
                     "rebuild_s": rebuild_s, "full_s": full_s}


def _growth_rows(np, rng, logical: set, lo: int, n: int, n_nodes: int, n_preds: int,
                 preds=None):
    """n new rows with subjects in lo .. lo + n // 3 (past every id the tier
    holds), objects in the base graph's nodes."""
    out = set()
    while len(out) < n:
        p = int(rng.integers(0, n_preds)) if preds is None else preds
        row = (int(rng.integers(lo, lo + n // 3)), p, int(rng.integers(0, n_nodes)))
        if row not in logical:
            out.add(row)
    rows = np.array(sorted(out), dtype=np.int64)
    return rows[rng.permutation(len(rows))]


def _motion_cols(np, rng, svc, logical: set):
    """Query rows for the eight patterns: half of them rows still waiting to
    move when a migration is in flight, the rest drawn from the logical
    set."""
    live = np.array(sorted(logical), dtype=np.int64)
    rows = live[rng.integers(0, len(live), MOTION_ROWS)]
    if svc.migration_active:
        pend = np.concatenate([r.cpu().numpy() for _, _, r in svc._migration.pending_moves()])
        rows[:MOTION_ROWS // 2] = pend[rng.integers(0, len(pend), MOTION_ROWS // 2)]
    return _eight_cols(np, rows)


def _tier_growth(torch, np, main: dict, svc, logical: set, rng) -> tuple:
    """(e): 12,288 rows with subjects past every id, in batches of 4,096,
    with the trigger at 1.5. On node_range they clip onto the last shard
    until the trigger fires, then each write drains a bounded migration
    chunk; the eight patterns over 512 rows (half in motion) against the
    oracle between batches, rows deleted in motion stay deleted, the control
    (the outgoing plan alone mid-migration) must answer wrongly, an
    explicit rebalance() drains the rest and every shard then holds exactly
    what the plan gives it. On predicate_hash the re-cut can move nothing:
    the backoff holds. Returns (the logical set, readings)."""
    import repro_torch.serve.sharded as sharded

    ds = main["dataset"]
    strategy = svc.plan.strategy
    svc.rebalance_skew = GROWTH_SKEW
    hi = max(max(r[0] for r in logical), max(r[2] for r in logical)) + 1
    rows = _growth_rows(np, rng, logical, hi, GROWTH_ROWS, ds.n_nodes, ds.n_preds,
                        preds=0 if strategy == "predicate_hash" else None)
    batches_ms, plans = [], []  # the live total at each plan computation
    real_batch, real_plan = svc._apply_migration_batch, sharded.plan_rebalance

    def timed_batch(src, dst, batch):
        moved, dt = _timed(torch, lambda: real_batch(src, dst, batch))
        batches_ms.append((dt * 1e3, moved))
        return moved

    def counted_plan(*a):
        plans.append(sum(svc.live_edges()))
        return real_plan(*a)

    svc._apply_migration_batch = timed_batch
    sharded.plan_rebalance = counted_plan
    trigger, victims, control, per_write, write_ms = None, None, None, [], []
    try:
        for b in range(0, GROWTH_ROWS, GROWTH_BATCH):
            batch = rows[b:b + GROWTH_BATCH]
            migrated = svc.stats.migrated_rows
            n, dt = _timed(torch, lambda: svc.insert_triples(batch))
            write_ms.append(dt * 1e3)
            per_write.append(svc.stats.migrated_rows - migrated)
            if n != len(batch):
                _fail(f"growth [{strategy}]: insert applied {n} of {len(batch)}")
            logical |= {tuple(r) for r in batch.tolist()}
            if trigger is None and (svc.stats.rebalances or svc._futile_total is not None):
                trigger = b // GROWTH_BATCH + 1
            if svc.migration_active and victims is None:
                control = _outgoing_plan_control(torch, np, svc, logical)
                pend = np.concatenate([r.cpu().numpy() for _, _, r in
                                       svc._migration.pending_moves()])
                victims = pend[rng.choice(len(pend), MOTION_VICTIMS, replace=False)]
                if svc.delete_triples(victims) != MOTION_VICTIMS:
                    _fail(f"growth [{strategy}]: deleting rows in motion applied wrongly")
                logical -= {tuple(r) for r in victims.tolist()}
            cols = _motion_cols(np, rng, svc, logical)
            _tier_check(torch, _submit_view(svc, cols), cols, _oracle_triples(torch, logical),
                        f"growth [{strategy}] batch {b // GROWTH_BATCH + 1}")
        drained, drain_s = _timed(torch, lambda: svc.rebalance()) if svc.migration_active \
            else ({"moved": 0}, 0.0)
    finally:
        del svc._apply_migration_batch
        sharded.plan_rebalance = real_plan
        svc.rebalance_skew = None
    if svc.migration_active:
        _fail(f"growth [{strategy}]: rebalance() left the migration in flight")
    for k, e in enumerate(svc.engines):
        held = e.current_triples().cpu().numpy()
        if len(held) and not (svc.plan.triple_shards(held) == k).all():
            _fail(f"growth [{strategy}]: shard {k} holds rows its plan routes elsewhere")
    if _logical_rows(svc) != logical:
        _fail(f"growth [{strategy}]: the tier's rows are not the logical set")
    if max(per_write) > sharded._AUTO_MOVES_PER_CALL:
        _fail(f"growth [{strategy}]: one write migrated {max(per_write)} rows")
    cols = _motion_cols(np, rng, svc, logical)
    _tier_check(torch, _submit_view(svc, cols), cols, _oracle_triples(torch, logical),
                f"growth [{strategy}] drained")
    ms = [m for m, _ in batches_ms]
    if strategy == "node_range":
        if trigger is None or victims is None or not svc.stats.rebalances:
            _fail(f"growth [node_range]: the trigger never fired (skew {svc.skew():.3f})")
        if svc.contains_triples(victims).any():
            _fail("growth [node_range]: a row deleted in motion came back")
        detail = (f"trigger in insert batch {trigger}, rows migrated by the writes "
                  f"{per_write}, {svc.stats.migrated_rows} in all ({drained['moved']} by the "
                  f"explicit rebalance(), {drain_s:.3f} s), {len(ms)} migration batches "
                  f"ms p50={np.percentile(ms, 50):.3f} max={max(ms):.3f}; {MOTION_VICTIMS} rows "
                  f"deleted in motion stayed deleted; control: {control}")
    else:
        # each re-cut after the first waits for the live size to drift past
        # 25% of the last futile one's
        held = all(abs(b - a) * 4 > a for a, b in zip(plans, plans[1:]))
        if svc.stats.rebalances or svc._futile_total is None or not plans or not held \
                or len(plans) == GROWTH_ROWS // GROWTH_BATCH:
            _fail(f"growth [predicate_hash]: rebalances={svc.stats.rebalances} "
                  f"backoff={svc._futile_total} plan computations at live totals {plans}")
        detail = (f"the re-cut in insert batch {trigger} moved nothing: "
                  f"{len(plans)} plan computations in {GROWTH_ROWS // GROWTH_BATCH} writes "
                  f"(at live totals {plans}), backoff anchor {svc._futile_total}, live now "
                  f"{sum(svc.live_edges())}")
    print(f"growth [{strategy} P={svc.n_shards}]: {GROWTH_ROWS} rows in batches of "
          f"{GROWTH_BATCH}, trigger {GROWTH_SKEW}; write ms p50={np.percentile(write_ms, 50):.3f} "
          f"max={max(write_ms):.3f}; {detail}; skew {svc.skew():.3f}, live {svc.live_edges()}, "
          f"rebuilds {svc.stats.rebuilds}; every answer equal to the oracle")
    return logical, {"trigger": trigger, "migrated": svc.stats.migrated_rows,
                     "batch_ms": ms, "write_ms": write_ms, "plans": plans}


def _outgoing_plan_control(torch, np, svc, logical: set) -> str:
    """Mid-migration, route by the outgoing plan alone (caches detached):
    s?? over subjects whose rows already moved must answer wrongly."""
    old, new = svc.plan, svc._migration.new_plan
    live = np.array(sorted(logical), dtype=np.int64)
    pend = {tuple(r) for _, _, rows in svc._migration.pending_moves()
            for r in rows.cpu().numpy().tolist()}
    moved = [r for r, a, b in zip(live.tolist(), old.triple_shards(live),
                                  new.triple_shards(live)) if a != b and tuple(r) not in pend]
    if not moved:
        _fail("control: no row had moved yet")
    subjects = np.array(sorted({r[0] for r in moved})[:256], dtype=np.int64)
    cols = [subjects, np.full(len(subjects), -1), np.full(len(subjects), -1)]
    restore = _detached(svc)
    svc._route_patterns = lambda s, p, o: old.route_batch(s, p, o)
    try:
        view = _submit_view(svc, cols)
    finally:
        del svc._route_patterns
        restore()
    cols_t = [torch.from_numpy(c).to(DEV) for c in cols]
    got, want = _view_rows(torch, view, cols_t, _oracle_triples(torch, logical))
    if got is not None and torch.equal(got, want):
        _fail("control: routing by the outgoing plan alone mid-migration answered right")
    return (f"the outgoing plan alone answered s?? over {len(subjects)} moved subjects with "
            f"{0 if got is None else got.shape[0]} of {want.shape[0]} rows")


def _tier_degraded(torch, np, svc, logical: set, rng) -> None:
    """(f): shard 1 failed: answers equal the oracle without its rows, the
    degraded patterns counted, writes to it and rebalance raise; after
    reingest_shard every answer equals the full oracle."""
    k = 1
    live = np.array(sorted(logical), dtype=np.int64)
    on_k = live[svc.plan.triple_shards(live) == k]
    rows = live[rng.integers(0, len(live), MOTION_ROWS)]
    cols = _eight_cols(np, rows)
    uniq = np.unique(np.stack(cols, 1), axis=0)
    routes = svc.plan.route_batch(uniq[:, 0], uniq[:, 1], uniq[:, 2])
    svc.mark_shard_failed(k)
    d0 = svc.stats.degraded_patterns
    rest = logical - {tuple(r) for r in on_k.tolist()}
    _tier_check(torch, _submit_view(svc, cols), cols, _oracle_triples(torch, rest),
                f"degraded shard {k}")
    expect = int((routes == k).sum() + (routes < 0).sum())
    if svc.stats.degraded_patterns - d0 != expect:
        _fail(f"degraded: counted {svc.stats.degraded_patterns - d0} patterns, not {expect}")
    for what, fn in (("write", lambda: svc.insert_triples(on_k[:1] + np.array([0, 0, 1]))),
                     ("rebalance", lambda: svc.rebalance(force=True))):
        try:
            fn()
        except RuntimeError:
            continue
        _fail(f"degraded: a {what} on the failed shard did not raise")
    n, dt = _timed(torch, lambda: svc.reingest_shard(k, on_k))
    if n != len(on_k) or svc.failed_shards:
        _fail(f"reingest_shard gave {n} rows of {len(on_k)}")
    _tier_check(torch, _submit_view(svc, cols), cols, _oracle_triples(torch, logical),
                f"reingested shard {k}")
    print(f"degraded [{svc.plan.strategy}]: shard {k} ({len(on_k)} rows) failed, "
          f"{expect} of {len(uniq)} unique patterns degraded, answers equal to the oracle "
          f"without its rows, writes and rebalance refused; reingest_shard {dt:.3f} s, "
          f"answers equal to the full oracle")


def _tier_strings(torch, np, main: dict, rng, scratch: str) -> dict:
    """(g), strings: the N-Triples file into an empty P = 4 tier (n_nodes 1,
    n_preds from scan_predicates), as the README does; IngestStats against
    the plain count; 256 S-bound and 256 O-bound query_strings against the
    string oracle; an unknown term launches nothing."""
    import os

    from repro_torch.core import QueryResultCache
    from repro_torch.data import ingest_file, scan_predicates
    from repro_torch.kernels import ops
    from repro_torch.serve import ShardedTripleService

    ds = main["dataset"]
    path = os.path.join(scratch, "geo.nt")
    nodes, preds = _write_geo_ntriples(ds, rng, path)
    pred_terms, _ = scan_predicates(path)
    svc = ShardedTripleService.build(np.zeros((0, 3), dtype=np.int64), 1, len(pred_terms),
                                     n_shards=4, cache=QueryResultCache(),
                                     crossover=main["engine"].crossover,
                                     delta_budget=DELTA_BUDGET, device=DEV)
    stats, ingest_s = _timed(torch, lambda: ingest_file(svc, path))
    distinct_nodes = len(set(ds.triples[:, 0].tolist()) | set(ds.triples[:, 2].tolist()))
    expect = {"rows": ds.n_triples, "inserted": ds.n_triples, "statements": ds.n_triples,
              "malformed": MALFORMED_LINES, "new_nodes": distinct_nodes,
              "new_preds": len(preds), "batches": -(-ds.n_triples // 4096)}
    got = {k: getattr(stats, k) for k in expect}
    if got != expect:
        _fail(f"tier IngestStats {got} differ from the plain count {expect}")
    td = svc.term_dict
    node_terms, pred_names = td.nodes.terms_in_id_order(), td.preds.terms_in_id_order()
    file_set = {(nodes[s], preds[p], nodes[o]) for s, p, o in ds.triples.tolist()}
    if {(node_terms[s], pred_names[p], node_terms[o]) for s, p, o in _logical_rows(svc)} \
            != file_set:
        _fail("the ingested tier does not hold the file's statements")
    by_s, by_o = {}, {}
    for t in file_set:
        by_s.setdefault(t[0], set()).add(t)
        by_o.setdefault(t[2], set()).add(t)
    us = {"s": [], "o": [], "s_one_thread": []}
    for side, oracle in (("s", by_s), ("o", by_o), ("s_one_thread", by_s)):
        pool = sorted(oracle)
        svc.set_serve_threads(1 if side == "s_one_thread" else None)
        for i in rng.choice(len(pool), TIER_STRINGS, replace=False):
            term = pool[int(i)]
            q = (None, None, term) if side == "o" else (term, None, None)
            ans, dt = _timed(torch, lambda q=q: svc.query_strings(*q))
            us[side].append(dt * 1e6)
            if len(ans) != len(oracle[term]) or set(ans) != oracle[term]:
                _fail(f"tier query_strings{q} differs from the string oracle")
    before = dict(ops.launch_counts)
    unknown = "<http://linkedgeodata.example.org/triplify/node/unknown>"
    if svc.query_strings(unknown, None, None) != [] or svc.query_bgp_strings(
            [("?x", "<http://example.org/no-such-predicate>", "?y")]) != [] or \
            _launches(ops, before):
        _fail("tier: an unknown term answered or launched")
    print(f"tier ingest_file [{svc.plan.strategy} P={svc.n_shards}, n_nodes 1]: "
          f"s={ingest_s:.3f} rows_per_s={ds.n_triples / ingest_s:.1f} rebuilds="
          f"{svc.stats.rebuilds} rebalances={svc.stats.rebalances} migrated="
          f"{svc.stats.migrated_rows} live={svc.live_edges()}; stats {got}; query_strings "
          f"(the default pool) {TIER_STRINGS} S-bound {_pcts(np, us['s'])}, {TIER_STRINGS} "
          f"O-bound {_pcts(np, us['o'])}, one thread {TIER_STRINGS} S-bound "
          f"{_pcts(np, us['s_one_thread'])}, all equal to the string oracle; unknown terms [] "
          f"with no launch")
    svc.close()
    return {"ingest_s": ingest_s, "us": us}


def _tier_stress(torch, np, svc, seed: int) -> dict:
    """(h): 4 readers, a churn writer and a rebalancer for STRESS_SECONDS on a P = 4
    tier, checked as the reference's stress machine checks them: the stable
    rows are the tier's rows, churn subjects lie past every id; afterwards
    the launch counts equal the launches the threads counted themselves."""
    import threading

    from repro_torch.kernels import _build

    stable = _logical_rows(svc)
    stable_nodes = max(max(r[0] for r in stable), max(r[2] for r in stable)) + 1
    n_preds = svc.plan.n_preds
    rng = np.random.default_rng(seed)
    churn_pool = np.unique(np.stack([rng.integers(stable_nodes, stable_nodes + 512, STRESS_CHURN),
                                     rng.integers(0, n_preds, STRESS_CHURN),
                                     rng.integers(0, stable_nodes, STRESS_CHURN)], 1), axis=0)
    churn_universe = {tuple(r) for r in churn_pool.tolist()}
    by_s, by_p, by_o = {}, {}, {}
    for r in stable:
        for d, key in ((by_s, r[0]), (by_p, r[1]), (by_o, r[2])):
            d.setdefault(key, []).append(r)
    subjects, objects = sorted(by_s), sorted(by_o)
    stop, errors, lat = threading.Event(), [], []
    live = set()
    tally, real_count = threading.local(), _build.count_launch
    counted = []

    def count(kernel):
        real_count(kernel)
        if not hasattr(tally, "n"):
            tally.n = [0]
            counted.append(tally.n)
        tally.n[0] += 1

    wide = {}  # the unselective answers, made once

    def want(s, p, o):
        if s is None and o is None and (p, None) in wide:
            return wide[p, None]
        pool = by_s.get(s, []) if s is not None else by_o.get(o, []) if o is not None \
            else by_p.get(p, []) if p is not None else stable
        out = sorted((tp, (ts, to)) for ts, tp, to in pool
                     if (s is None or ts == s) and (p is None or tp == p)
                     and (o is None or to == o))
        if s is None and o is None:
            wide[p, None] = out
        return out

    def reader(rseed):
        rr = np.random.default_rng(rseed)
        try:
            while not stop.is_set():
                s = subjects[int(rr.integers(0, len(subjects)))]
                p = int(rr.integers(0, n_preds))
                o = objects[int(rr.integers(0, len(objects)))]
                for pat in PATTERNS + ("???",):
                    qs, qp, qo = (s if pat[0] != "?" else None, p if pat[1] != "?" else None,
                                  o if pat[2] != "?" else None)
                    t0 = time.perf_counter()
                    got = svc.query(qs, qp, qo)
                    lat.append(time.perf_counter() - t0)
                    got = sorted(got)
                    w = want(qs, qp, qo)
                    if qs is not None:
                        if got != w:
                            raise AssertionError(f"stress {pat} {(qs, qp, qo)}")
                        continue
                    wset = set(w)
                    if [r for r in got if r in wset] != w:
                        raise AssertionError(f"stress {pat} lost stable rows")
                    for tp, (ts, to) in (r for r in got if r not in wset):
                        if (ts, tp, to) not in churn_universe or ts < stable_nodes or \
                                (qp is not None and tp != qp) or (qo is not None and to != qo):
                            raise AssertionError(f"stress {pat}: a row from nowhere")
        except Exception as exc:  # reported below, after the threads join
            errors.append(exc)

    def churn():
        cr = np.random.default_rng(seed + 1)
        try:
            while not stop.is_set():
                picks = churn_pool[cr.integers(0, len(churn_pool), int(cr.integers(1, 6)))]
                rows = {tuple(r) for r in picks.tolist()}
                if cr.integers(0, 2):
                    if svc.insert_triples(picks) != len(rows - live):
                        raise AssertionError("stress churn: insert applied wrongly")
                    live.update(rows)
                else:
                    if svc.delete_triples(picks) != len(rows & live):
                        raise AssertionError("stress churn: delete applied wrongly")
                    live.difference_update(rows)
        except Exception as exc:
            errors.append(exc)

    def rebalancer():
        rb = np.random.default_rng(seed + 2)
        try:
            while not stop.is_set():
                svc.rebalance(force=True, max_moves=int(rb.integers(1, 64)))
                stop.wait(STRESS_PAUSE_S)
        except Exception as exc:
            errors.append(exc)

    from repro_torch.kernels import ops

    before = dict(ops.launch_counts)
    _build.count_launch = count
    threads = [threading.Thread(target=reader, args=(seed + 10 + i,))
               for i in range(STRESS_READERS)]
    threads += [threading.Thread(target=churn), threading.Thread(target=rebalancer)]
    try:
        for t in threads:
            t.start()
        time.sleep(STRESS_SECONDS)
        stop.set()
        for t in threads:
            t.join(120)
    finally:
        stop.set()
        _build.count_launch = real_count
    if any(t.is_alive() for t in threads):
        _fail("stress: a thread did not finish")
    if errors:
        _fail(f"stress [{svc.plan.strategy}]: {errors[0]!r}")
    total = sum(v - before[k] for k, v in ops.launch_counts.items())
    if total != sum(n[0] for n in counted):
        _fail(f"stress: launch counts {total} differ from the threads' own "
              f"{sum(n[0] for n in counted)}")
    svc.rebalance(force=True)
    final = stable | live
    final_t = _oracle_triples(torch, final)
    cols = _eight_cols(np, np.array(sorted(final), dtype=np.int64)[
        rng.integers(0, len(final), MOTION_ROWS)])
    _tier_check(torch, _submit_view(svc, cols), cols, final_t, "stress drained")
    ms = np.array(lat) * 1e3
    print(f"stress [{svc.plan.strategy} P={svc.n_shards}]: {STRESS_READERS} readers, a churn "
          f"writer and a rebalancer for {STRESS_SECONDS} s: queries={len(lat)} "
          f"qps={len(lat) / STRESS_SECONDS:.1f} p50_ms={np.percentile(ms, 50):.3f} "
          f"p99_ms={np.percentile(ms, 99):.3f}; churn rows live {len(live)}, rebalances "
          f"{svc.stats.rebalances}, migrated {svc.stats.migrated_rows}; launches {total} "
          f"counted by the threads {sum(n[0] for n in counted)} from {len(counted)} threads; "
          f"every answer checked, the drained tier equal to the oracle")
    return {"queries": len(lat), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "launches": total}


def drive_sharded_path(torch, np, main: dict, seed: int) -> None:
    """Phase 3f: the sharded serving tier on the card, on phase 3's triples:
    builds at P = 1, 2, 4, the mixed cycle, scatter against one engine,
    joins, writes, a growing graph with online rebalancing, degraded
    serving, ingestion with strings, and concurrent readers and writers."""
    import shutil
    import tempfile

    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed + 28)
    names = (*K2_NAMES, *DIGRAM_NAMES)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    part_s, mark = {}, [t0]

    def lap(name):
        now = time.perf_counter()
        part_s[name] = round(now - mark[0], 3)
        mark[0] = now

    built = _tier_builds(torch, np, main, rng)
    tiers = built["tiers"]
    lap("builds")
    scatter = _tier_scatter(torch, np, main, tiers)
    lap("scatter")
    bgps = _tier_bgps(torch, main, tiers)
    lap("bgp")
    logical_ph, writes = _tier_writes(torch, np, main, tiers["predicate_hash"], rng)
    lap("writes")
    logical_nr = {tuple(r) for r in main["dataset"].triples.tolist()}
    logical_nr, growth_nr = _tier_growth(torch, np, main, tiers["node_range"], logical_nr, rng)
    lap("growth node_range")
    logical_ph, growth_ph = _tier_growth(torch, np, main, tiers["predicate_hash"], logical_ph,
                                         rng)
    lap("growth predicate_hash")
    _tier_degraded(torch, np, tiers["node_range"], logical_nr, rng)
    lap("degraded")
    scratch = tempfile.mkdtemp(prefix="itr_tier_")
    try:
        strings = _tier_strings(torch, np, main, rng, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    lap("strings")
    stress = {}
    for s, svc in tiers.items():
        stress[s] = _tier_stress(torch, np, svc, seed + 7)
        lap(f"stress {s}")
    for svc in tiers.values():
        svc.close()
    counts = {k: ops.launch_counts[k] for k in names}
    print(f"sharded part: {time.perf_counter() - t0:.1f} s (by reading {part_s}); launches "
          + " ".join(f"{k}={v}" for k, v in counts.items()))
    for k in ("k2_lines_count", "k2_lines_write", "digram_pair_accum", "digram_select"):
        if counts[k] == 0:
            _fail(f"the sharded path launched {k} no time")
    if counts["bitvec_rank"] or counts["digram_pair_counts"]:
        _fail(f"the sharded path launched {counts}")
    main["sharded_part"] = {"launches": counts, "builds": built["results"], "scatter": scatter,
                            "bgp": bgps, "writes": writes,
                            "growth": {"node_range": growth_nr, "predicate_hash": growth_ph},
                            "strings": strings, "stress": stress, "part_s": part_s}


DURABLE_SHARDS = 4         # the durable tiers' P, as phase 3f's largest
DURABLE_CHECK_ROWS = 256   # rows of the eight-pattern checks between crash points (512
                           # until phase 7c)
APPEND_REPS = 64           # appends of one 1,536-row record, a fsync setting (256 until 7c)
SYNC_ROWS = 256            # rows of the writes whose host syncs are counted
HOT_ROWS = 1024            # rows piled on one subject, so a node_range re-cut moves rows
SPOT_EVERY = 4             # the spot checks of the replica readings take every 4th pick
KILL_BATCHES, KILL_ROWS = 16, 512  # the killed writer's batches (insert, then delete them;
                                   # 32 until phase 7c)
KILL_AFTER = (4, 12)       # the parent kills once an acknowledgement in this range arrives
REPLICA_WRITES, REPLICA_ROWS = 8, 256  # logged writes the replica groups tail (16 until 7c)
REPLICA_STRESS_S = 1.0     # the replicated read run, a setting (10 s until 7c, 2 s until 9)
REPLICA_READERS = 4
CRASH_POINTS = ("wal.append", "wal.torn", "wal.post_append", "snapshot.write_arrays",
                "snapshot.pre_commit", "snapshot.post_commit", "migrate.pre_apply",
                "migrate.mid_apply", "engine.rebuild")  # tests/test_crash_oracle.py:39


def _du(path: str) -> int:
    """Bytes of the files under `path`."""
    import os

    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _durable_open(torch, root: str, **kw):
    """DurableShardedService.open on the card with a tier cache of phase
    3f's size and no auto-rebalance; (service, seconds)."""
    from repro_torch.core import QueryResultCache
    from repro_torch.persist import DurableShardedService

    return _timed(torch, lambda: DurableShardedService.open(
        root, rebalance_skew=None, cache=QueryResultCache(max_entries=TIER_CACHE_ENTRIES),
        device=DEV, **kw))


def _durable_check(torch, np, svc, logical: set, rows, what: str) -> None:
    """The eight patterns over `rows` through the tier's request plane (a
    replica group may serve it) against the oracle scan of `logical`."""
    cols = _eight_cols(np, rows)
    _tier_check(torch, _submit_view(svc, cols), cols, _oracle_triples(torch, logical), what)


def _primary_check(torch, np, svc, logical: set, rows, what: str) -> None:
    """As _durable_check, with replica dispatch off (the primary serves)."""
    saved, svc.service._replicas = svc.service._replicas, None
    try:
        _durable_check(torch, np, svc, logical, rows, what)
    finally:
        svc.service._replicas = saved


def _check_rows(np, rng, logical: set, extra=None):
    live = np.array(sorted(logical), dtype=np.int64)
    rows = live[rng.integers(0, len(live), DURABLE_CHECK_ROWS)]
    return rows if extra is None else np.concatenate([np.asarray(extra), rows])


def _present(svc, rows) -> list:
    return svc.contains_triples(rows).tolist()


def _durable_builds(torch, np, main: dict, card: str, roots: dict) -> tuple:
    """(a): DurableShardedService.build for both strategies at P = 4 (build
    s, the initial snapshot's s and bytes, the WAL's bytes), every answer
    over phase 3f's picks against the oracle."""
    import os

    from repro_torch.core import QueryResultCache
    from repro_torch.persist import DurableShardedService

    ds, phase3 = main["dataset"], main["engine"]
    logical = {tuple(r) for r in ds.triples.tolist()}
    tiers, out = {}, {}
    real_snapshot = DurableShardedService.snapshot
    for strategy, root in roots.items():
        snap_s = []

        def timed_snapshot(self, *a, **kw):
            out_path, dt = _timed(torch, lambda: real_snapshot(self, *a, **kw))
            snap_s.append(dt)
            return out_path

        DurableShardedService.snapshot = timed_snapshot
        try:
            svc, build_s = _timed(torch, lambda: DurableShardedService.build(
                ds.triples, ds.n_nodes, ds.n_preds, root=root, n_shards=DURABLE_SHARDS,
                strategy=strategy, cache=QueryResultCache(max_entries=TIER_CACHE_ENTRIES),
                crossover=phase3.crossover, delta_budget=DELTA_BUDGET, rebalance_skew=None,
                device=DEV))
        finally:
            DurableShardedService.snapshot = real_snapshot
        snap_bytes = _du(os.path.join(root, "snap_000001"))
        wal_bytes = _du(os.path.join(root, "wal.log"))
        _durable_check(torch, np, svc, logical, main["tier_batches"]["picks"],
                       f"durable build [{strategy}]")
        print(f"durable build [{strategy} P={DURABLE_SHARDS}, fsync on]: build_s={build_s:.3f} "
              f"(the initial snapshot {snap_s[0]:.3f} s, {snap_bytes} B on disk), wal_bytes="
              f"{wal_bytes}, shard sizes {svc.shard_sizes()}; oracle_equal=True; card {card}")
        tiers[strategy] = svc
        out[strategy] = {"build_s": build_s, "snapshot_s": snap_s[0],
                         "snapshot_bytes": snap_bytes, "wal_bytes": wal_bytes}
    return tiers, out


def _durable_writes(torch, np, main: dict, svc, rng, root: str, card: str) -> tuple:
    """(b): phase 3f's 1,536-row delete and insert batches, on the tier alone
    (not logged), durably with fsync off and with fsync on (each restored
    but the last); the appends' own µs, an append run of APPEND_REPS records
    a setting; the host syncs a write makes on the tier and durably, given
    numpy rows and a card tensor. Returns (the logical set, readings)."""
    import os

    from repro_torch.persist import WriteAheadLog
    from repro_torch.persist.service import _pack_rows
    from repro_torch.persist.wal import OP_INSERT

    ds = main["dataset"]
    dels, ins = main["tier_batches"]["dels"], main["tier_batches"]["ins"]
    logical = {tuple(r) for r in ds.triples.tolist()}
    appends = {True: [], False: []}
    real_append = svc.wal.append

    def timed_append(payload):
        t0 = time.perf_counter()
        real_append(payload)
        appends[svc.wal.fsync].append((time.perf_counter() - t0) * 1e6)

    svc.wal.append = timed_append
    ms = {}
    try:
        for mode in ("tier", "fsync_off", "fsync_on"):
            target = svc.service if mode == "tier" else svc
            svc.wal.fsync = mode != "fsync_off"
            n_del, del_s = _timed(torch, lambda: target.delete_triples(dels))
            n_ins, ins_s = _timed(torch, lambda: target.insert_triples(ins))
            if (n_del, n_ins) != (TIER_MUTATIONS, TIER_MUTATIONS):
                _fail(f"durable writes [{mode}] applied {n_del} deletes and {n_ins} inserts")
            ms[mode] = (del_s * 1e3, ins_s * 1e3)
            if mode != "fsync_on":  # back to the base set
                if (target.insert_triples(dels), target.delete_triples(ins)) != \
                        (TIER_MUTATIONS, TIER_MUTATIONS):
                    _fail(f"durable writes [{mode}]: the restore applied wrongly")
    finally:
        del svc.wal.append
        svc.wal.fsync = True
    logical -= {tuple(r) for r in dels.tolist()}
    logical |= {tuple(r) for r in ins.tolist()}
    bench = {}
    payload = _pack_rows(OP_INSERT, ins)
    for fsync in (True, False):
        path = os.path.join(root, f"append_bench_{int(fsync)}.log")
        wal, us = WriteAheadLog(path, fsync=fsync), []
        for _ in range(APPEND_REPS):
            t0 = time.perf_counter()
            wal.append(payload)
            us.append((time.perf_counter() - t0) * 1e6)
        wal.close()
        os.remove(path)
        bench[fsync] = us
    last = ds.n_preds - 1
    small = np.array(_new_rows(np, rng, SYNC_ROWS, set(logical), ds.n_nodes, last),
                     dtype=np.int64)
    small_t = torch.from_numpy(small).to(DEV)
    syncs = {}
    for name, target, rows in (("tier numpy", svc.service, small),
                               ("durable numpy", svc, small),
                               ("tier tensor", svc.service, small_t),
                               ("durable tensor", svc, small_t)):
        syncs[name] = _count_syncs(torch, lambda: target.insert_triples(rows))
        if target.delete_triples(small) != SYNC_ROWS:  # the same state for the next
            _fail(f"durable syncs [{name}]: the restore applied wrongly")
    added = {"numpy": syncs["durable numpy"] - syncs["tier numpy"],
             "tensor": syncs["durable tensor"] - syncs["tier numpy"]}
    if added["numpy"] or syncs["durable tensor"] != syncs["tier tensor"]:
        _fail(f"durable writes: host syncs {syncs}, added beyond the tier's {added}")
    _durable_check(torch, np, svc, logical, main["tier_batches"]["picks"], "durable writes")
    print(f"durable writes [predicate_hash P={svc.n_shards}]: delete {TIER_MUTATIONS} / insert "
          f"{TIER_MUTATIONS} ms: the tier alone {ms['tier'][0]:.3f} / {ms['tier'][1]:.3f}, "
          f"durable fsync off {ms['fsync_off'][0]:.3f} / {ms['fsync_off'][1]:.3f}, durable "
          f"fsync on {ms['fsync_on'][0]:.3f} / {ms['fsync_on'][1]:.3f}; the writes' appends "
          f"fsync on {_pcts(np, appends[True])}, off {_pcts(np, appends[False])}; "
          f"{APPEND_REPS} appends of a {len(payload)} B record: fsync on "
          f"{_pcts(np, bench[True])}, off {_pcts(np, bench[False])}; host syncs of a "
          f"{SYNC_ROWS}-row insert {syncs}: a durable write adds {added['numpy']} (numpy) and "
          f"{added['tensor']} (a card tensor) beyond the tier's write of numpy rows; "
          f"oracle_equal=True; card {card}")
    return logical, {"ms": ms, "append_us": {k: _pcts(np, v) for k, v in appends.items()},
                     "bench_us": {k: _pcts(np, v) for k, v in bench.items()}, "syncs": syncs}


def _recover(torch, svc, root: str) -> tuple:
    """The kill: the live instance is abandoned (its WAL handle closed, no
    pending card work of it read again) and the tier reopens from disk;
    (the recovered tier, open seconds)."""
    svc.wal.close()
    recovered, open_s = _durable_open(torch, root)
    if recovered.last_recovery.failed_shards:
        _fail(f"recovery failed shards {recovered.last_recovery.failed_shards}")
    return recovered, open_s


def _durable_migration_kill(torch, np, main: dict, svc, root: str, rng, card: str) -> tuple:
    """(c): grow the node_range tier (phase 3f's growth rows, trigger 1.5)
    with ``migrate.mid_apply`` armed; the write that starts the migration
    dies inside its first batch. open() resumes the migration (its s split
    into loading and replay, the replay's records/s and launches), the
    write's rows are all there, the rest drains, every answer equals the
    oracle. Returns (the recovered tier, the logical set, readings)."""
    from repro_torch.kernels import ops
    from repro_torch.persist import CrashPoint, DurableShardedService, inject_crashes

    ds = main["dataset"]
    logical = {tuple(r) for r in ds.triples.tolist()}
    svc.service.rebalance_skew = GROWTH_SKEW
    hi = max(max(r[0] for r in logical), max(r[2] for r in logical)) + 1
    rows = _growth_rows(np, rng, logical, hi, GROWTH_ROWS, ds.n_nodes, ds.n_preds)
    crashed, batch, grow_t0 = None, None, time.perf_counter()
    for b in range(0, GROWTH_ROWS, GROWTH_BATCH):
        batch = rows[b:b + GROWTH_BATCH]
        try:
            with inject_crashes({"migrate.mid_apply": 1}):
                svc.insert_triples(batch)
        except CrashPoint:
            crashed = b // GROWTH_BATCH + 1
            break
        logical |= {tuple(r) for r in batch.tolist()}
    grow_s = time.perf_counter() - grow_t0
    if crashed is None:
        _fail("durable growth: the trigger never fired")
    svc.wal.close()  # killed mid-migration
    del svc
    replay = []
    real_replay = DurableShardedService._replay

    def timed_replay(self, report):
        _, dt = _timed(torch, lambda: real_replay(self, report))
        replay.append(dt)

    before = dict(ops.launch_counts)
    DurableShardedService._replay = timed_replay
    try:
        svc, open_s = _durable_open(torch, root)
    finally:
        DurableShardedService._replay = real_replay
    launched = _launches(ops, before)
    rep = svc.last_recovery
    if not (rep.migration_resumed and svc.migration_active) or rep.failed_shards:
        _fail(f"durable migration kill: recovery {rep}")
    landed = _present(svc, batch)
    if not all(landed):  # its record was durable before the kill
        _fail(f"durable migration kill: {landed.count(False)} rows of the logged write lost")
    logical |= {tuple(r) for r in batch.tolist()}
    cols = _motion_cols(np, rng, svc, logical)
    _tier_check(torch, _submit_view(svc, cols), cols, _oracle_triples(torch, logical),
                "durable migration kill, resumed")
    pending = svc._migration.pending_rows
    drained, drain_s = _timed(torch, lambda: svc.rebalance())
    if svc.migration_active or drained["moved"] == 0:
        _fail(f"durable migration kill: the drain left {drained}")
    for k, e in enumerate(svc.engines):
        held = e.current_triples().cpu().numpy()
        if len(held) and not (svc.plan.triple_shards(held) == k).all():
            _fail(f"durable migration kill: shard {k} holds rows its plan routes elsewhere")
    if _logical_rows(svc.service) != logical:
        _fail("durable migration kill: the tier's rows are not the logical set")
    _durable_check(torch, np, svc, logical, main["tier_batches"]["picks"],
                   "durable migration kill, drained")
    _, snap_s = _timed(torch, svc.snapshot)  # compacts the growth's log
    replay_s = replay[0]
    print(f"durable migration kill [node_range P={svc.n_shards}]: trigger {GROWTH_SKEW} fired in "
          f"insert batch {crashed} ({grow_s:.3f} s of durable growth writes), killed at "
          f"migrate.mid_apply; open {open_s:.3f} s = loading "
          f"{open_s - replay_s:.3f} s + replay {replay_s:.3f} s ({rep.replayed_records} records, "
          f"{rep.replayed_records / replay_s:.1f} records/s; launches {launched}); "
          f"migration_resumed={rep.migration_resumed}, {pending} rows pending, the killed "
          f"write's {len(batch)} rows all present; drained {drained['moved']} rows in "
          f"{drain_s:.3f} s; every answer equal to the oracle; snapshot and compaction "
          f"{snap_s:.3f} s; card {card}")
    return svc, logical, {"open_s": open_s, "replay_s": replay_s,
                          "records": rep.replayed_records, "launches": launched,
                          "drain_s": drain_s, "pending": pending}


def _hot_rows(np, logical: set, s: int, n_preds: int, n: int):
    rows = [(s, p, o) for o in range(n) for p in range(n_preds) if (s, p, o) not in logical]
    return np.array(rows[:n], dtype=np.int64)


def _durable_crash_points(torch, np, main: dict, svc, root: str, logical: set, rng,
                          card: str) -> tuple:
    """(d): the nine injection points of the reference's crash oracle, once
    each, chained on the tier: kill, recover from disk, hold the point's
    contract (an acknowledged operation recovered; an unacknowledged one
    wholly present or wholly absent; the snapshot step; a migration
    resumed), then every answer against the oracle."""
    from repro_torch.persist import CrashPoint, inject_crashes
    from repro_torch.persist.service import _snapshot_steps

    ds = main["dataset"]
    out = {}
    hot_subjects = iter((1, 2))
    for point in CRASH_POINTS:
        fresh = np.array(_new_rows(np, rng, SYNC_ROWS, set(logical), ds.n_nodes, ds.n_preds),
                         dtype=np.int64)
        step0 = _snapshot_steps(root)[-1]
        if point.startswith("wal."):
            op = lambda: svc.insert_triples(fresh)  # noqa: E731
        elif point.startswith("snapshot."):
            svc.insert_triples(fresh)
            logical |= {tuple(r) for r in fresh.tolist()}
            op = svc.snapshot
        elif point.startswith("migrate."):
            fresh = _hot_rows(np, logical, next(hot_subjects), ds.n_preds, HOT_ROWS)
            svc.insert_triples(fresh)
            logical |= {tuple(r) for r in fresh.tolist()}
            op = lambda: svc.rebalance(force=True)  # noqa: E731
        else:
            svc.insert_triples(fresh)
            logical |= {tuple(r) for r in fresh.tolist()}
            op = lambda: svc.rebuild(force=True)  # noqa: E731
        try:
            with inject_crashes({point: 1}):
                op()
        except CrashPoint:
            pass
        else:
            _fail(f"crash point {point} never fired")
        svc, open_s = _recover(torch, svc, root)
        rep = svc.last_recovery
        landed = _present(svc, fresh)
        if len(set(landed)) != 1:
            _fail(f"crash {point}: the batch is half there ({landed.count(True)} of "
                  f"{len(landed)})")
        if point.startswith("wal."):
            if landed[0] != (point == "wal.post_append"):
                _fail(f"crash {point}: landed={landed[0]}")
            if landed[0]:
                logical |= {tuple(r) for r in fresh.tolist()}
            if rep.torn_tail != (point == "wal.torn"):
                _fail(f"crash {point}: torn_tail={rep.torn_tail}")
        elif not landed[0]:
            _fail(f"crash {point}: an acknowledged write was lost")
        if point.startswith("snapshot.") and rep.snapshot_step != \
                step0 + (point == "snapshot.post_commit"):
            _fail(f"crash {point}: recovered from step {rep.snapshot_step}, not the expected")
        if point.startswith("migrate."):
            if not svc.migration_active:
                _fail(f"crash {point}: the migration was not resumed")
            svc.rebalance()
        _durable_check(torch, np, svc, logical, _check_rows(np, rng, logical, fresh[:64]),
                       f"crash {point}")
        out[point] = {"replayed": rep.replayed_records, "step": rep.snapshot_step,
                      "landed": landed[0], "open_s": open_s}
    if _logical_rows(svc.service) != logical:
        _fail("crash points: the tier's rows are not the logical set")
    print(f"crash points [node_range P={svc.n_shards}], chained on one tier at full size: "
          + "; ".join(f"{p} open {v['open_s']:.3f} s replayed {v['replayed']} from step "
                      f"{v['step']}, batch {'present' if v['landed'] else 'absent'}"
                      for p, v in out.items())
          + f"; every contract held, every answer equal to the oracle; card {card}")
    return svc, logical, out


def _durable_snapshot_part(torch, np, main: dict, svc, root: str, logical: set,
                           card: str) -> dict:
    """(e): snapshot and compaction of the mutated tier (s, bytes), open()
    from it with no k2_lines launch: every state tensor and scalar of every
    shard equal to the live tier's; the same directory opened on the CPU
    answers 256 patterns as the card does."""
    from repro_torch.kernels import ops
    from repro_torch.persist import DurableShardedService

    path, snap_s = _timed(torch, svc.snapshot)
    snap_bytes, wal_bytes = _du(path), _du(svc.wal.path)
    before = dict(ops.launch_counts)
    opened, open_s = _durable_open(torch, root)
    if _launches(ops, before).get("k2_lines_count") or opened.last_recovery.replayed_records:
        _fail(f"durable open after compaction launched {_launches(ops, before)}")
    for k, (a, b) in enumerate(zip(svc.engines, opened.engines)):
        ta, tb = _state_tensors(a), _state_tensors(b)
        bad = [n for n in ta if ta[n].shape != tb[n].shape or not torch.equal(ta[n], tb[n])]
        if bad or _engine_scalars(a) != _engine_scalars(b):
            _fail(f"durable snapshot: shard {k} opened unequal ({bad})")
    _durable_check(torch, np, opened, logical, main["tier_batches"]["picks"],
                   "durable snapshot, opened")
    on_cpu, cpu_s = _timed(torch, lambda: DurableShardedService.open(
        root, rebalance_skew=None, device="cpu"))
    live = np.array(sorted(logical), dtype=np.int64)
    rows = live[np.linspace(0, len(live) - 1, 32).astype(np.int64)]
    pats = [tuple(int(v) if pat[i] != "?" else None for i, v in enumerate(r))
            for pat in PATTERNS + ("???",) for r in rows.tolist()]
    got = [sorted(a) for a in on_cpu.query_many(pats)]
    if got != [sorted(a) for a in opened.query_many(pats)]:
        _fail("durable snapshot: the CPU open answers differently from the card's")
    opened.close()
    on_cpu.close()
    print(f"durable snapshot [node_range P={svc.n_shards}]: snapshot + compaction "
          f"{snap_s:.3f} s, {snap_bytes} B on disk, the WAL {wal_bytes} B after; open "
          f"{open_s:.3f} s, no k2_lines launch, every state tensor and scalar of the "
          f"{svc.n_shards} shards equal to the live tier's, answers equal to the oracle; "
          f"opened with device=\"cpu\" in {cpu_s:.3f} s: {len(pats)} patterns answered as on the "
          f"card; card {card}")
    return {"snapshot_s": snap_s, "snapshot_bytes": snap_bytes, "open_s": open_s,
            "cpu_open_s": cpu_s}


def _kill_batches(np, rng, logical: set, n_nodes: int, n_preds: int):
    """(rows, kinds) of the killed writer: even batches insert new rows,
    each odd batch deletes the batch before it."""
    fresh = _new_rows(np, rng, KILL_BATCHES // 2 * KILL_ROWS, set(logical), n_nodes, n_preds)
    ins = np.array(fresh, dtype=np.int64).reshape(KILL_BATCHES // 2, KILL_ROWS, 3)
    rows = np.repeat(ins, 2, axis=0)
    kinds = np.tile(np.array([0, 1], dtype=np.int64), KILL_BATCHES // 2)
    return rows, kinds


def _durable_sigkill(torch, np, main: dict, svc, root: str, logical: set, rng, scratch: str,
                     card: str) -> tuple:
    """(f): ``python -m repro_torch.launch.itr_durable`` opens the tier on the
    card and writes; SIGKILL once it acknowledged a batch in KILL_AFTER.
    Every acknowledged batch is recovered, the one in flight wholly or not
    at all, none after it. Returns (the recovered tier, the logical set,
    readings)."""
    import os
    import signal
    import subprocess
    import threading

    ds = main["dataset"]
    rows, kinds = _kill_batches(np, rng, logical, ds.n_nodes, ds.n_preds)
    batches = os.path.join(scratch, "kill_batches.npz")
    np.savez(batches, rows=rows, kinds=kinds)
    kill_at = int(rng.integers(*KILL_AFTER))
    svc.close()  # one writer a directory: the child owns it now
    del svc
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.itr_durable", "--root", root, "--batches",
         batches, "--device", DEV], stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    watchdog = threading.Timer(300, child.kill)
    watchdog.start()
    acked, opened_s, lines = -1, None, []
    try:
        for line in child.stdout:
            lines.append(line.strip())
            if line.startswith("opened"):
                opened_s = float(line.split()[1])
            elif line.startswith("acked"):
                acked = int(line.split()[1])
                if acked >= kill_at:
                    child.send_signal(signal.SIGKILL)
                    break
    finally:
        child.kill()
        rest = child.stdout.read()
        child.wait(60)
        watchdog.cancel()
    run_s = time.perf_counter() - t0
    acked = max([acked] + [int(w.split()[1]) for w in rest.splitlines()
                           if w.startswith("acked")])
    if child.returncode != -signal.SIGKILL or acked < kill_at or acked >= KILL_BATCHES - 1:
        _fail(f"kill -9: the child exited {child.returncode} after acknowledging {acked} "
              f"({lines[-3:]})")
    svc, open_s = _durable_open(torch, root)
    for i in range(acked + 1):
        batch = {tuple(r) for r in rows[i].tolist()}
        logical = logical | batch if kinds[i] == 0 else logical - batch
    flight = acked + 1
    got = _present(svc, rows[flight])
    if len(set(got)) != 1:
        _fail(f"kill -9: the batch in flight is half there ({got.count(True)} of {len(got)})")
    landed = got[0] == (kinds[flight] == 0)
    if landed:
        batch = {tuple(r) for r in rows[flight].tolist()}
        logical = logical | batch if kinds[flight] == 0 else logical - batch
    _durable_check(torch, np, svc, logical, _check_rows(np, rng, logical, rows[flight][:256]),
                   "kill -9 recovered")
    if _logical_rows(svc.service) != logical:  # acknowledged batches there, none after
        _fail("kill -9: the recovered tier's rows are not the logical set")
    rep = svc.last_recovery
    print(f"kill -9 [node_range P={svc.n_shards}]: the child opened the tier on the card in "
          f"{opened_s} s and was killed after acknowledging batch {acked} ({KILL_ROWS} rows a "
          f"batch, inserts and deletes in turns; {run_s:.3f} s from spawn to kill); recovery "
          f"open {open_s:.3f} s replayed {rep.replayed_records} records, torn_tail="
          f"{rep.torn_tail}: every acknowledged batch there, the batch in flight "
          f"{'wholly applied' if landed else 'wholly absent'}; every answer equal to the "
          f"oracle; card {card}")
    return svc, logical, {"acked": acked, "in_flight_landed": landed, "open_s": open_s,
                          "child_open_s": opened_s, "replayed": rep.replayed_records}


def _group_bytes(group) -> int:
    return sum(t.numel() * t.element_size() for e in group.service.engines
               for t in _state_tensors(e).values())


def _replica_stress(torch, np, svc, logical: set, seed: int, n_groups: int) -> dict:
    """REPLICA_STRESS_S s of REPLICA_READERS readers (S-bound patterns over
    the stable subjects, each answer checked exactly) beside one durable
    writer of churn rows with subjects past every id, with n_groups replica
    groups."""
    import threading

    svc.enable_replication(n_groups)
    by_s = {}
    for r in logical:
        by_s.setdefault(r[0], []).append(r)
    subjects = sorted(by_s)
    hi = max(max(r[0] for r in logical), max(r[2] for r in logical)) + 1
    stop, errors, lat = threading.Event(), [], []
    flushes0 = svc.stats.replica_flushes
    writes = [0]

    def reader(rseed):
        rr = np.random.default_rng(rseed)
        try:
            while not stop.is_set():
                s = subjects[int(rr.integers(0, len(subjects)))]
                rows = by_s[s]
                _, p, o = rows[int(rr.integers(0, len(rows)))]
                for qp, qo in ((None, None), (p, None), (None, o), (p, o)):
                    t0 = time.perf_counter()
                    got = sorted(svc.query(s, qp, qo))
                    lat.append(time.perf_counter() - t0)
                    want = sorted((tp, (ts, to)) for ts, tp, to in rows
                                  if (qp is None or tp == qp) and (qo is None or to == qo))
                    if got != want:
                        raise AssertionError(f"replicated read {(s, qp, qo)}")
        except Exception as exc:  # reported after the threads join
            errors.append(exc)

    def writer():
        wr = np.random.default_rng(seed + 5)
        try:
            while not stop.is_set():
                k = int(wr.integers(1, 6))
                rows = np.stack([wr.integers(hi, hi + 512, k), wr.integers(0, svc.plan.n_preds, k),
                                 wr.integers(0, hi, k)], 1)
                if wr.integers(0, 2):
                    svc.insert_triples(rows)
                else:
                    svc.delete_triples(rows)
                writes[0] += 1
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=reader, args=(seed + 40 + i,))
               for i in range(REPLICA_READERS)] + [threading.Thread(target=writer)]
    try:
        for t in threads:
            t.start()
        time.sleep(REPLICA_STRESS_S)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
    if any(t.is_alive() for t in threads):
        _fail("replicated reads: a thread did not finish")
    if errors:
        _fail(f"replicated reads with {n_groups} groups: {errors[0]!r}")
    ms = np.array(lat) * 1e3
    out = {"groups": n_groups, "queries": len(lat), "qps": len(lat) / REPLICA_STRESS_S,
           "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
           "replica_flushes": svc.stats.replica_flushes - flushes0, "writes": writes[0]}
    if n_groups and not out["replica_flushes"]:
        _fail("replicated reads: no flush went to a replica group")
    # churn rows off again, durably, so the logical set is the stable one
    svc.enable_replication(0)
    churn = {tuple(r) for e in svc.engines for r in e.current_triples().tolist()
             if r[0] >= hi}
    if churn:
        svc.delete_triples(np.array(sorted(churn), dtype=np.int64))
    return out


def _durable_replication(torch, np, main: dict, svc, logical: set, rng, seed: int,
                         card: str) -> tuple:
    """(g): one group's seed s and device bytes; two groups tailing a run of
    logged writes (sync s, each group and the primary against the oracle);
    the lag gate (max_lag=0, a pending record serves from the primary); a
    reseed after snapshot(); the control (a cursor that skipped a record
    answers differently); then REPLICA_STRESS_S s of readers beside a
    durable writer with 0 and 2 groups. Returns (the logical set,
    readings)."""
    ds = main["dataset"]
    picks = main["tier_batches"]["picks"]
    svc.set_serve_threads(1)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    mgr, seed_s = _timed(torch, lambda: svc.enable_replication(1))
    torch.cuda.synchronize()
    mem_bytes = torch.cuda.memory_allocated() - mem0
    state_bytes = _group_bytes(mgr.groups[0])
    spot = picks[::SPOT_EVERY]
    _durable_check(torch, np, mgr.groups[0].service, logical, spot, "replica group seeded")

    def new_batch(n):
        rows = np.array(_new_rows(np, rng, n, set(logical), ds.n_nodes, ds.n_preds),
                        dtype=np.int64)
        logical.update(tuple(r) for r in rows.tolist())
        return rows

    mgr = svc.enable_replication(2, max_lag="off", auto_sync=False)
    written = [new_batch(REPLICA_ROWS) for _ in range(REPLICA_WRITES)]
    _, write_s = _timed(torch, lambda: [svc.insert_triples(b) for b in written])
    applied, sync_s = _timed(torch, svc.sync_replicas)
    if applied != [REPLICA_WRITES] * 2:
        _fail(f"replica sync applied {applied} records")
    extra = np.concatenate(written)[:256]
    rows = np.concatenate([extra, picks])
    for g in mgr.groups:
        _durable_check(torch, np, g.service, logical, rows, f"replica group {g.index}")
    _primary_check(torch, np, svc, logical, np.concatenate([extra, spot]),
                   "primary beside 2 groups")
    flushes = svc.stats.replica_flushes
    _durable_check(torch, np, svc, logical, np.concatenate([extra, spot]), "dispatched")
    if svc.stats.replica_flushes != flushes + 1:
        _fail("replica dispatch: the caught-up groups served no flush")
    # the lag gate
    mgr = svc.enable_replication(1, max_lag=0, auto_sync=False)
    f0 = svc.stats.replica_flushes
    svc.query(int(extra[0, 0]), None, None)
    gated = new_batch(1)
    svc.insert_triples(gated)
    got = svc.query(int(gated[0, 0]), int(gated[0, 1]), int(gated[0, 2]))
    f1 = svc.stats.replica_flushes
    svc.sync_replicas()
    again = svc.query(int(gated[0, 0]), int(gated[0, 1]), int(gated[0, 2]))
    if (f1 - f0, svc.stats.replica_flushes - f1) != (1, 1) or len(got) != 1 or len(again) != 1:
        _fail(f"replica lag gate: flushes {f0} -> {f1} -> {svc.stats.replica_flushes}, "
              f"answers {got} / {again}")
    # a reseed after snapshot()
    mgr = svc.enable_replication(2, max_lag="off", auto_sync=False)
    svc.insert_triples(new_batch(REPLICA_ROWS))
    _, snap_s = _timed(torch, svc.snapshot)
    last = new_batch(REPLICA_ROWS)
    svc.insert_triples(last)
    _, reseed_s = _timed(torch, svc.sync_replicas)
    if [(g.reseeds, g.records) for g in mgr.groups] != [(1, 1)] * 2:
        _fail(f"replica reseed: {[(g.reseeds, g.records) for g in mgr.groups]}")
    for g in mgr.groups:
        _durable_check(torch, np, g.service, logical, np.concatenate([last[:256], spot]),
                       f"replica group {g.index} reseeded")
    # the control: a cursor that skips one record
    skipped = new_batch(REPLICA_ROWS)
    svc.insert_triples(skipped)
    recs, _ = mgr.groups[1].cursor.tail()  # consumed, never applied
    svc.sync_replicas()
    cols = _eight_cols(np, skipped)
    oracle_t = _oracle_triples(torch, logical)
    cols_t = [torch.from_numpy(c).to(DEV) for c in cols]
    good = _view_rows(torch, _submit_view(mgr.groups[0].service, cols), cols_t, oracle_t)
    bad = _view_rows(torch, _submit_view(mgr.groups[1].service, cols), cols_t, oracle_t)
    if len(recs) != 1 or good[0] is None or not torch.equal(*good) or \
            (bad[0] is not None and torch.equal(*bad)):
        _fail("replica control: a group whose cursor skipped a record answered right")
    stress = [_replica_stress(torch, np, svc, logical, seed, n) for n in (0, 2)]
    _primary_check(torch, np, svc, logical, spot, "after the replicated reads")
    svc.set_serve_threads(None)
    print(f"replication [predicate_hash P={svc.n_shards}]: one group seeded in {seed_s:.3f} s, "
          f"{mem_bytes} B of device memory ({state_bytes} B of state tensors); "
          f"{REPLICA_WRITES} logged writes of {REPLICA_ROWS} rows in {write_s:.3f} s, 2 groups "
          f"synced in {sync_s:.3f} s, each group and the primary equal to the oracle; the lag "
          f"gate (max_lag=0) served a pending record's read from the primary; after snapshot() "
          f"both groups reseeded in {reseed_s:.3f} s (snapshot {snap_s:.3f} s) and equal the "
          f"oracle; control: a cursor that skipped a record answered wrongly; "
          + "; ".join(f"{s['groups']} groups: {s['qps']:.1f} queries/s, p50 {s['p50_ms']:.3f} "
                      f"ms, p99 {s['p99_ms']:.3f} ms, replica_flushes {s['replica_flushes']}, "
                      f"{s['writes']} durable writes" for s in stress)
          + f" ({REPLICA_READERS} readers, serve_threads=1, {REPLICA_STRESS_S} s each); "
          f"card {card}")
    return logical, {"seed_s": seed_s, "group_bytes": mem_bytes, "state_bytes": state_bytes,
                     "sync_s": sync_s, "reseed_s": reseed_s, "stress": stress}


def _wal_cut_control(torch, np, main: dict, svc, root: str, logical: set, rng,
                     scratch: str) -> None:
    """A copy of the root with the WAL's last intact frame cut: it recovers
    without that batch, so the oracle that includes the batch must
    disagree."""
    import os
    import shutil

    from repro_torch.persist import read_wal_records

    ds = main["dataset"]
    last = np.array(_new_rows(np, rng, SYNC_ROWS, set(logical), ds.n_nodes, ds.n_preds),
                    dtype=np.int64)
    svc.insert_triples(last)
    logical |= {tuple(r) for r in last.tolist()}
    copy = os.path.join(scratch, "wal_cut")
    shutil.copytree(root, copy)
    wal = os.path.join(copy, "wal.log")
    records, rep = read_wal_records(wal)
    with open(wal, "r+b") as f:
        f.truncate(rep.valid_bytes - 8 - len(records[-1]))
    cut, _ = _durable_open(torch, copy)
    try:
        cols = _eight_cols(np, np.concatenate([last, _check_rows(np, rng, logical)]))
        cols_t = [torch.from_numpy(c).to(DEV) for c in cols]
        got, want = _view_rows(torch, _submit_view(cut, cols), cols_t,
                               _oracle_triples(torch, logical))
        if any(_present(cut, last)) or (got is not None and torch.equal(got, want)):
            _fail("control: the WAL cut before its last frame recovered the batch")
        _durable_check(torch, np, cut, logical - {tuple(r) for r in last.tolist()},
                       _check_rows(np, rng, logical, last), "the cut WAL's recovery")
    finally:
        cut.close()
        shutil.rmtree(copy, ignore_errors=True)
    print(f"control: the WAL cut before its last intact frame ({len(records)} -> "
          f"{len(records) - 1} records) recovered without that {len(last)}-row batch and "
          f"disagreed with the oracle that holds it")


def _flipped_shard_control(torch, np, root: str, logical: set, scratch: str) -> None:
    """A flipped byte in one shard's snapshot: that shard degrades
    (failed_shards == [1]) and writes routed to it raise."""
    import os
    import shutil

    from repro_torch.persist.service import _newest_snapshot

    copy = os.path.join(scratch, "flipped")
    shutil.copytree(root, copy)
    _, snap = _newest_snapshot(copy)
    target = os.path.join(snap, "shard_1", "flat_params.npy")
    data = bytearray(open(target, "rb").read())
    data[len(data) // 2] ^= 0x10
    open(target, "wb").write(bytes(data))
    svc, _ = _durable_open(torch, copy)
    try:
        if svc.last_recovery.failed_shards != [1] or svc.failed_shards != {1}:
            _fail(f"control: a flipped byte in shard 1 gave {svc.last_recovery.failed_shards}")
        live = np.array(sorted(logical), dtype=np.int64)
        on_1 = live[svc.plan.triple_shards(live) == 1][:1].copy()
        on_1[0, 2] = int(live[:, [0, 2]].max()) + 7  # a new row shard 1 owns
        try:
            svc.insert_triples(on_1)
        except RuntimeError:
            pass
        else:
            _fail("control: a write routed to the degraded shard did not raise")
    finally:
        svc.close()
        shutil.rmtree(copy, ignore_errors=True)
    print("control: a flipped byte in shard 1's snapshot degraded exactly that shard "
          "(failed_shards == [1]) and a write routed to it raised")


def drive_durable_path(torch, np, main: dict, seed: int) -> None:
    """Phase 3g: the durable tier on the card at full size, on phase 3's
    triples, each tier in a fresh temporary root with fsync on: builds,
    durable writes, a kill mid-migration, the nine crash points, snapshot
    and compaction, a real kill -9, read replicas, and three controls that
    must fail."""
    import shutil
    import tempfile

    from repro_torch.kernels import ops

    card = _card()
    rng = np.random.default_rng(seed + 29)
    names = (*K2_NAMES, *DIGRAM_NAMES)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="itr_durable_")
    roots = {s: f"{scratch}/{s}" for s in ("predicate_hash", "node_range")}
    part_s, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        part_s[name] = round(now - mark[0], 3)
        mark[0] = now

    try:
        tiers, builds = _durable_builds(torch, np, main, card, roots)
        ph, nr = tiers["predicate_hash"], tiers["node_range"]
        lap("a")
        logical_ph, writes = _durable_writes(torch, np, main, ph, rng, roots["predicate_hash"],
                                             card)
        lap("b")
        nr, logical_nr, kill = _durable_migration_kill(torch, np, main, nr, roots["node_range"],
                                                       rng, card)
        lap("c")
        nr, logical_nr, points = _durable_crash_points(torch, np, main, nr, roots["node_range"],
                                                       logical_nr, rng, card)
        lap("d")
        snap = _durable_snapshot_part(torch, np, main, nr, roots["node_range"], logical_nr,
                                      card)
        lap("e")
        nr, logical_nr, sigkill = _durable_sigkill(torch, np, main, nr, roots["node_range"],
                                                   logical_nr, rng, scratch, card)
        lap("f")
        _flipped_shard_control(torch, np, roots["node_range"], logical_nr, scratch)
        nr.close()
        lap("control: flipped shard")
        logical_ph, repl = _durable_replication(torch, np, main, ph, logical_ph, rng, seed, card)
        lap("g")
        _wal_cut_control(torch, np, main, ph, roots["predicate_hash"], logical_ph, rng, scratch)
        ph.close()
        lap("control: cut WAL")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    counts = {k: ops.launch_counts[k] for k in names}
    print(f"durable part: {time.perf_counter() - t0:.1f} s (by reading {part_s}); launches "
          + " ".join(f"{k}={v}" for k, v in counts.items()) + f"; card {card}")
    for k in ("k2_lines_count", "k2_lines_write", "digram_pair_accum", "digram_select"):
        if counts[k] == 0:
            _fail(f"the durable path launched {k} no time")
    if counts["bitvec_rank"] or counts["digram_pair_counts"]:
        _fail(f"the durable path launched {counts}")
    main["durable_part"] = {"launches": counts, "builds": builds, "writes": writes,
                            "migration_kill": kill, "crash_points": points, "snapshot": snap,
                            "sigkill": sigkill, "replication": repl, "part_s": part_s}


BASELINE_QUERIES = 128      # queries a pattern in phase 3h (16 for ?p?, 4 for ???; 256
                            # until phase 7c)
BASELINE_NARROW = {"?p?": 16, "???": 4}
BASELINE_PATTERNS = ("spo", "sp?", "s?o", "s??", "?po", "?p?", "??o", "???")
RANK_NAMES = ("bitvec_rank", "k2_lines_count", "k2_lines_write")


def _host_oracle(np, t, q) -> list:
    """The (p, (s, o)) answers of pattern q over the (n, 3) numpy triples,
    sorted: the plain scan."""
    sel = np.ones(len(t), dtype=bool)
    for i, v in enumerate(q):
        if v is not None:
            sel &= t[:, i] == v
    return sorted((int(p), (int(s), int(o))) for s, p, o in t[sel])


def _baseline_queries(np, pick, pat: str) -> list:
    n = BASELINE_NARROW.get(pat, BASELINE_QUERIES)
    return [tuple(int(pick[i, j]) if pat[j] != "?" else None for j in range(3))
            for i in range(n)]


def _baseline_reading(torch, np, what: str, obj, t_np, pat: str, qs: list) -> dict:
    """Each query of a pattern through ``obj.query`` on the host clock (the
    answer is host tuples: finished work), held against the plain scan; the
    launch counts around the whole reading and the host syncs of its first
    query."""
    from repro_torch.kernels import ops

    syncs = _count_syncs(torch, lambda: obj.query(*qs[0]))
    torch.cuda.synchronize()
    before = {k: ops.launch_counts[k] for k in RANK_NAMES}
    us, results, lines = [], 0, 0
    for q in qs:
        t0 = time.perf_counter()
        ans = obj.query(*q)
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) * 1e6)
        want = _host_oracle(np, t_np, q)
        if sorted(ans) != want:
            _fail(f"{what} {pat} query {q} differs from the oracle scan")
        results += len(ans)
        lines += len({p for p, _ in want})
    launches = {k: ops.launch_counts[k] - before[k] for k in RANK_NAMES}
    return {"p50_us": float(np.percentile(us, 50)), "p99_us": float(np.percentile(us, 99)),
            "syncs": syncs, "launches": launches, "results": results, "queries": len(qs),
            "lines": lines}


def _access_ranks(np, k2_cpu, qs: list) -> int:
    """The ``rank1`` calls that ``K2Tree.access`` makes for queries ``qs``
    (S and O bound) over the trees they name: one at each level whose bit
    on the path is set, walked over numpy copies of the CPU build's levels."""
    from repro_torch.core.succinct.bitvector import unpack_bits

    trees = []
    for t in k2_cpu.trees:
        bits = [unpack_bits(lv.words, lv.n).numpy() for lv in t.levels]
        trees.append((t, bits, [np.concatenate([[0], np.cumsum(b)]) for b in bits]))
    total = 0
    for s, p, o in qs:
        for tree, bits, ranks in (trees if p is None else [trees[p]]):
            k, block = tree.k, 0
            for lvl in range(tree.h):
                scale = k ** (tree.h - 1 - lvl)
                pos = block * k * k + (s // scale % k) * k + (o // scale % k)
                if pos >= len(bits[lvl]) or not bits[lvl][pos]:
                    break
                total += 1
                block = int(ranks[lvl][pos])
    return total


def _check_baseline_launches(name: str, pat: str, r: dict, n_preds: int, ranks: int) -> None:
    """The launches a reading ``r`` must make, exactly: HDT-BT one
    ``bitvec_rank`` a query (the S-rooted walk's ``Bo.rank1``, the scan's
    ``Bp.rank1``); k²-triples, for S and O bound, ``ranks`` ``bitvec_rank``
    (``access``, one a level reached) and no ``k2_lines``, else one
    ``k2_lines_count`` a query and tree and one ``k2_lines_write`` for each
    (query, tree) whose line the oracle shows not empty, and no
    ``bitvec_rank``."""
    n_q, got = r["queries"], r["launches"]
    trees = 1 if pat[1] == "p" else n_preds
    if name == "hdt-bt":
        want = {"bitvec_rank": n_q, "k2_lines_count": 0, "k2_lines_write": 0}
    elif pat[0] == "s" and pat[2] == "o":
        want = {"bitvec_rank": ranks, "k2_lines_count": 0, "k2_lines_write": 0}
    else:
        want = {"bitvec_rank": 0, "k2_lines_count": n_q * trees, "k2_lines_write": r["lines"]}
    if got != want:
        _fail(f"{name} {pat} launched {got}, not {want}")


def _flipped_bo(torch, hdt):
    """A copy of the HDT-BT structure with one bit of ``Bo`` flipped (the
    control of phase 3h)."""
    import copy

    from repro_torch.core.succinct import BitVector

    bad = copy.copy(hdt)
    words = hdt.Bo.words.clone()
    words[words.numel() // 2] ^= 1 << 7
    bad.Bo = BitVector.from_words(words, hdt.Bo.n)
    return bad


def _grammar_to(grammar, dev):
    """A copy of the grammar on ``dev``."""
    from repro_torch.core import Grammar, Hypergraph, LabelTable, Rule

    def graph(g):
        return Hypergraph(g.n_nodes, g.labels.to(dev), g.nodes_flat.to(dev), g.offsets.to(dev))

    table = LabelTable(grammar.table.ranks.to(dev), grammar.table.n_terminals,
                       grammar.table.names)
    return Grammar(table, graph(grammar.start),
                   {lbl: Rule(r.label, r.rank, graph(r.rhs)) for lbl, r in grammar.rules.items()})


def _loop_edges(torch, g) -> int:
    """Start edges with a repeated node (rank-2 and rank-3 edges of these
    grammars: compare every pair of positions)."""
    ranks = (g.offsets[1:] - g.offsets[:-1]).tolist()
    flat, off = g.nodes_flat.tolist(), g.offsets.tolist()
    return sum(len(set(flat[off[e]:off[e + 1]])) < ranks[e] for e in range(len(ranks)))


def _edge_set(torch, g):
    """The distinct (label, nodes...) rows of a hypergraph, padded with -1."""
    ranks = g.offsets[1:] - g.offsets[:-1]
    r_max = int(ranks.max()) if ranks.numel() else 0
    slot = torch.arange(r_max, device=g.labels.device)
    take = (g.offsets[:-1, None] + slot).clamp(max=max(g.nodes_flat.numel() - 1, 0))
    nodes = torch.where(slot < ranks[:, None], g.nodes_flat[take], -1)
    return torch.unique(torch.cat([g.labels[:, None], nodes], 1), dim=0)


def _ablation(torch, what: str, grammar) -> dict:
    from repro_torch.core import encode
    from repro_torch.core.ablations import loop_rule_transform

    loops = _loop_edges(torch, grammar.start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = loop_rule_transform(grammar)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    if _loop_edges(torch, out.start):
        _fail(f"the loop transform of {what} left loop edges in its start graph")
    if not torch.equal(_edge_set(torch, out.decompress()), _edge_set(torch, grammar.decompress())):
        _fail(f"the loop transform of {what} decompresses to another edge set on the card")
    cpu = loop_rule_transform(_grammar_to(grammar, "cpu"))
    if not _same_grammar(torch, out, cpu):
        _fail(f"the loop transform of {what} on the card differs from the CPU's")
    b_index, b_loops = encode(grammar).size_in_bytes(), encode(out).size_in_bytes()
    added = len(out.rules) - len(grammar.rules)
    print(f"loop ablation {what}: start_edges={grammar.start.n_edges} loop_edges={loops} "
          f"rules_added={added} encoded_bytes index_functions={b_index} loop_rules={b_loops} "
          f"(ratio {b_loops / b_index:.6f}) transform_s={transform_s:.6f}; no loop edge left, "
          f"decompression equal, card transform equal to the CPU's")
    return {"loop_edges": loops, "rules_added": added, "bytes_index": b_index,
            "bytes_loops": b_loops, "transform_s": transform_s}


def drive_baselines_path(torch, np, main: dict, seed: int) -> None:
    """Phase 3h: the paper's baselines (k²-triples, HDT-BT) and the loop
    ablation on phase 3's data, on the card."""
    from repro_torch.baselines import HDTBitmapTriples, K2Triples, ntriples_size_bytes
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    card = _card()
    ds = main["dataset"]
    t_np = ds.triples
    ops.reset_launch_counts()
    built, sizes, cpu_built = {}, {}, {}
    for name, cls in (("k2-triples", K2Triples), ("hdt-bt", HDTBitmapTriples)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built[name] = cls(t_np, ds.n_nodes, ds.n_preds)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sizes[name] = built[name].size_in_bytes()
        cpu_built[name] = cls(t_np, ds.n_nodes, ds.n_preds, device="cpu")
        cpu = cpu_built[name].size_in_bytes()
        if sizes[name] != cpu:
            _fail(f"{name}: size_in_bytes {sizes[name]} on the card, {cpu} on the CPU")
        print(f"baseline {name} build_s={build_s:.6f} size_in_bytes={sizes[name]} "
              f"(equal to the CPU build's) on {card}")
    build_counts = {k: ops.launch_counts[k] for k in RANK_NAMES}
    nt = ntriples_size_bytes(t_np)
    itr = main["encoded"].size_in_bytes()
    print(f"table 1a geo-coordinates-en: ntriples_bytes={nt} ITR={itr} "
          f"({100 * itr / nt:.4f}%) k2-triples={sizes['k2-triples']} "
          f"({100 * sizes['k2-triples'] / nt:.4f}%) hdt-bt={sizes['hdt-bt']} "
          f"({100 * sizes['hdt-bt'] / nt:.4f}%) of the N-Triples size")

    singles = main["scalar_part"]["singles"]
    marks = {"a": time.perf_counter() - t_start}
    readings = {}
    for pat in BASELINE_PATTERNS:
        qs = _baseline_queries(np, main["pick"], pat)
        for name, obj in built.items():
            r = _baseline_reading(torch, np, name, obj, t_np, pat, qs)
            readings[(name, pat)] = r
            ranks = _access_ranks(np, cpu_built[name], qs) \
                if name == "k2-triples" and pat[0] == "s" and pat[2] == "o" else 0
            _check_baseline_launches(name, pat, r, ds.n_preds, ranks)
            itr_pct = (f"{singles['p50_us'][pat]:.1f}/{singles['p99_us'][pat]:.1f}"
                       if pat in singles["p50_us"] else "not measured")
            print(f"baseline {name} {pat} queries={r['queries']} p50_us={r['p50_us']:.1f} "
                  f"p99_us={r['p99_us']:.1f} results={r['results']} host_syncs_a_query="
                  f"{r['syncs']} launches " + " ".join(f"{k}={v}" for k, v in
                                                       r["launches"].items())
                  + f" oracle_equal=True; ITR engine.query p50/p99_us={itr_pct} "
                  f"(phase 3, crossover {main['scalar_part']['crossover']}) on {card}")
    # the control: a flipped Bo bit must change some answer
    bad = _flipped_bo(torch, built["hdt-bt"])
    caught = 0
    for q in _baseline_queries(np, main["pick"], "??o")[:64] + [(None, None, None)]:
        try:
            caught += sorted(bad.query(*q)) != _host_oracle(np, t_np, q)
        except (IndexError, RuntimeError):
            caught += 1
    print(f"control: HDT-BT with one Bo bit flipped differs from the oracle on {caught} of 65 "
          f"queries (must be > 0)")
    if not caught:
        _fail("the flipped-Bo-bit control of HDT-BT answered every query as the oracle")
    del bad
    marks["b"] = time.perf_counter() - t_start
    counts = {k: ops.launch_counts[k] for k in (*RANK_NAMES, *DIGRAM_NAMES)}
    if counts["bitvec_rank"] == 0 or counts["k2_lines_count"] == 0:
        _fail(f"phase 3h launched bitvec_rank {counts['bitvec_rank']} and k2_lines_count "
              f"{counts['k2_lines_count']} times: both must run")
    ablation = {"geo-coordinates-en": _ablation(torch, "geo-coordinates-en", main["grammar"]),
                PLUS_DATASET: _ablation(torch, PLUS_DATASET,
                                        main["snapshot_part"]["itr_plus"]["itr_grammar"])}
    counts = {k: ops.launch_counts[k] for k in (*RANK_NAMES, *DIGRAM_NAMES)}
    seconds = time.perf_counter() - t_start
    print(f"phase 3h launches " + " ".join(f"{k}={v}" for k, v in counts.items())
          + f" (builds: " + " ".join(f"{k}={v}" for k, v in build_counts.items())
          + f") phase_3h_s={seconds:.3f} (cumulative s at the end of (a) {marks['a']:.1f}, "
          f"(b) {marks['b']:.1f})")
    # the rank kernel at the baselines' shapes: HDT-BT's run_subject, one
    # rank1 over every run of Bp (the O-rooted scan's launch)
    hdt = built["hdt-bt"]
    bp = hdt.Bp
    runs = torch.arange(hdt.Sp.numel(), device=DEV)
    bp.rank1(runs[:1])  # builds the padded words
    main["baselines_part"] = {"launches": counts, "sizes": sizes, "ablation": ablation,
                              "rank_call": (bp._rank_words, bp.word_ranks, runs),
                              "seconds": seconds}


def time_kernels(torch, np, main: dict, errs: dict) -> list:
    """Phase 4: each kernel on the inputs the main path gives it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitvec_rank import bitvec_rank_cuda

    # the per-level rank inputs of one s?? seed batch as the level loop (the
    # per-level path, which the main path no longer takes) gives them to the
    # standalone rank kernel
    rank_calls = []

    def rec_rank(*a):
        rank_calls.append(a)
        return bitvec_rank_cuda(*a)

    s = main["batches"]["s??"][0]
    lay = main["engine"].incidence.layout()
    per_level = ref.k2_lines_ref(lay, s, 0, rank=rec_rank)
    torch.cuda.synchronize()
    for a in rank_calls:
        got, want = bitvec_rank_cuda(*a), ref.bitvec_rank_ref(*a)
        if not torch.equal(got, want):
            _fail("bitvec_rank differs from its twin at main-path shapes")
        if got.numel():
            errs["bitvec_rank"] = max(errs["bitvec_rank"], int((got - want).abs().max()))
    rank_bytes = sum(16 * a[2].numel() + min(64 * a[2].numel(), 12 * a[0].numel())
                     for a in rank_calls)
    rank_ops = sum(12 * a[2].numel() for a in rank_calls)
    print(f"bitvec_rank per-level shapes: {len(rank_calls)} calls (one s?? seed batch), "
          f"Q per level={[a[2].numel() for a in rank_calls]}, "
          f"W+1 per level={[a[0].numel() for a in rank_calls]}")
    baselines = main["baselines_part"]
    out = [_kernel_row(torch, "bitvec_rank", "src/repro_torch/csrc/bitvec_rank.cu",
                       "src/repro/kernels/bitvec_rank.py:33",
                       main["counts"]["bitvec_rank"] + baselines["launches"]["bitvec_rank"],
                       errs["bitvec_rank"], lambda: [bitvec_rank_cuda(*a) for a in rank_calls],
                       lambda: [ref.bitvec_rank_ref(*a) for a in rank_calls],
                       rank_bytes, rank_ops)]
    # and at the baselines' shape: HDT-BT's run_subject, one rank1 over all runs
    call = baselines["rank_call"]
    got, want = bitvec_rank_cuda(*call), ref.bitvec_rank_ref(*call)
    if not torch.equal(got, want):
        _fail("bitvec_rank differs from its twin at HDT-BT's run_subject shape")
    q = call[2].numel()
    at_bl = _kernel_row(torch, "bitvec_rank", "src/repro_torch/csrc/bitvec_rank.cu",
                        "src/repro/kernels/bitvec_rank.py:33", baselines["launches"]["bitvec_rank"],
                        0, lambda: bitvec_rank_cuda(*call), lambda: ref.bitvec_rank_ref(*call),
                        16 * q + min(64 * q, 12 * call[0].numel()), 12 * q)
    out[0].update(launches_phase3=main["counts"]["bitvec_rank"],
                  launches_baselines_part=baselines["launches"]["bitvec_rank"],
                  at_baselines_shape={k: at_bl[k] for k in ("ms", "plain_ms", "bound_ms",
                                                            "bound_by")} | {"q": q})
    out += _digram_rows(torch, main, errs)
    out += _k2_lines_rows(torch, main, errs, lay, s, per_level, rank_calls)
    return out


def _kernel_row(torch, name, src, replaces, launches, err, run_kernel, run_plain, nbytes, nops,
                reps=(50, 20)) -> dict:
    """A kernel's row: its time and its twin's on the same inputs, in turns
    (plain, kernel, kernel, plain), and its bound."""
    plain_a = _time_ms(torch, run_plain, reps[1])
    ms_a, ms_b = _time_ms(torch, run_kernel, reps[0]), _time_ms(torch, run_kernel, reps[0])
    plain_b = _time_ms(torch, run_plain, reps[1])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / CORE_OPS_PER_S * 1e3
    entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": min(ms_a, ms_b),
             "plain_ms": min(plain_a, plain_b), "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}
    print(f"kernel {name} ms={entry['ms']:.6f} plain_ms={entry['plain_ms']:.6f} "
          f"bound_ms={entry['bound_ms']:.6f} ({entry['bound_by']}, {nbytes} B, {nops} ops) "
          f"launches={launches} library=none")
    return entry


def _accum_work(torch, call) -> tuple:
    """(bytes, operations) one accumulation must spend: its CSR read once
    and each distinct key it touches written once (key and count, 16 B);
    12 integer operations a slot pair walked."""
    from repro_torch.kernels import ref

    row_ptr, its, cnts, sign = call
    lens = row_ptr[1:] - row_ptr[:-1]
    keys, _ = ref.digram_pairs_ref(*call)
    nbytes = 8 * row_ptr.numel() + 8 * its.numel() + 4 * sign.numel() \
        + 16 * torch.unique(keys).numel()
    return nbytes, 12 * int((lens * (lens + 1) // 2).sum())


def _dense_groups(torch, row_ptr, its, cnts) -> list:
    """The CSR's rows grouped by length d as (N, d) matrices: the dense
    pair kernel's inputs for the same Count (one launch a group)."""
    lens = row_ptr[1:] - row_ptr[:-1]
    groups = []
    for d in torch.unique(lens).tolist():
        if d == 0:
            continue
        starts = row_ptr[:-1][lens == d]
        idx = starts[:, None] + torch.arange(d, device=row_ptr.device)[None, :]
        groups.append((its[idx].contiguous(), cnts[idx].contiguous()))
    return groups


def _digram_rows(torch, main: dict, errs: dict) -> list:
    """The build's digram kernels on the main path's inputs. The
    accumulation is held against its twin over the recorded initial Count
    and first 20 replacements (a control must fail) and timed at both: the
    initial Count's one launch, and a replacement's launch (the mean over
    the 20, run in sequence); the selection on the table the build ended
    with; the dense ``digram_pair_counts``, off the path, on the initial
    Count's rows grouped by length, as the build launched it before."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.digram_count import (DigramTable, digram_pair_accum_cuda,
                                                  digram_pair_counts_cuda, digram_select_cuda)

    calls = main["accum_calls"]
    _hold_accum(torch, calls, "the main path's initial Count and first 20 replacements")
    init, deltas = calls[0], calls[1:]
    kern, twin = _hashed_for(calls), DigramTable.sorted(DEV)
    digram_pair_accum_cuda(kern, *init)
    ref.digram_pair_accum_ref(twin, *init)
    init_bytes, init_ops = _accum_work(torch, init)
    work = [_accum_work(torch, c) for c in deltas]
    rows_per_delta = [c[3].numel() for c in deltas]
    print(f"digram_pair_accum main-path shapes: initial Count {init[3].numel()} rows, "
          f"{init[1].numel()} items; replacements 1-20 rows={rows_per_delta} "
          f"items={[c[1].numel() for c in deltas]}")
    first = _kernel_row(torch, "digram_pair_accum (initial Count)",
                        "src/repro_torch/csrc/digram_count.cu",
                        "src/repro/kernels/digram_count.py:39", 1, errs["digram_pair_accum"],
                        lambda: digram_pair_accum_cuda(kern, *init),
                        lambda: ref.digram_pair_accum_ref(twin, *init), init_bytes, init_ops,
                        reps=(20, 5))
    n = len(deltas)
    row = _kernel_row(torch, "digram_pair_accum", "src/repro_torch/csrc/digram_count.cu",
                      "src/repro/kernels/digram_count.py:39",
                      main["counts"]["digram_pair_accum"], errs["digram_pair_accum"],
                      lambda: [digram_pair_accum_cuda(kern, *c) for c in deltas],
                      lambda: [ref.digram_pair_accum_ref(twin, *c) for c in deltas],
                      sum(b for b, _ in work), sum(o for _, o in work), reps=(10, 3))
    for key in ("ms", "plain_ms", "bound_ms"):  # a replacement's launch: the mean of the 20
        row[key] /= n
    row.update(initial_ms=first["ms"], initial_plain_ms=first["plain_ms"],
               initial_bound_ms=first["bound_ms"], initial_bound_by=first["bound_by"])
    print(f"kernel digram_pair_accum per replacement launch: ms={row['ms']:.6f} "
          f"plain_ms={row['plain_ms']:.6f} bound_ms={row['bound_ms']:.6f}")

    table = main["select_table"]
    got, want = digram_select_cuda(table).tolist(), ref.digram_select_slot_ref(table).tolist()
    if got != want:
        _fail(f"digram_select differs from its twin on the build's last table: {got} {want}")
    print(f"digram_select main-path table: capacity {table.capacity}, used {got[3]}, "
          f"counts above 0 {int((table.counts > 0).sum())}")
    # it must read every count, and the key and flag of each count above 0
    positive = int((table.counts > 0).sum())
    sel = _kernel_row(torch, "digram_select", "src/repro_torch/csrc/digram_count.cu",
                      "src/repro/kernels/digram_count.py:39", main["counts"]["digram_select"],
                      errs["digram_select"], lambda: digram_select_cuda(table),
                      lambda: ref.digram_select_slot_ref(table),
                      8 * table.capacity + 9 * positive + 32, table.capacity + 4 * positive)

    groups = _dense_groups(torch, *init[:3])
    for a in groups:
        for g, w in zip(digram_pair_counts_cuda(*a), ref.digram_pair_counts_ref(*a)):
            if not torch.equal(g, w):
                _fail("digram_pair_counts differs from its twin at the initial Count's groups")
            errs["digram_pair_counts"] = max(errs["digram_pair_counts"], int((g - w).abs().max()))
    print(f"digram_pair_counts (off the path) on the initial Count's groups: "
          f"(N, K)={[tuple(a[0].shape) for a in groups]}")
    pair_bytes = sum(8 * a[0].numel() + 12 * a[0].shape[0] * (a[0].shape[1] * (a[0].shape[1] + 1) // 2)
                     for a in groups)
    pair_ops = sum(16 * a[0].shape[0] * (a[0].shape[1] * (a[0].shape[1] + 1) // 2)
                   for a in groups)
    dense = _kernel_row(torch, "digram_pair_counts", "src/repro_torch/csrc/digram_count.cu",
                        "src/repro/kernels/digram_count.py:39",
                        main["counts"]["digram_pair_counts"], errs["digram_pair_counts"],
                        lambda: [digram_pair_counts_cuda(*a) for a in groups],
                        lambda: [ref.digram_pair_counts_ref(*a) for a in groups],
                        pair_bytes, pair_ops)
    for entry, name in ((dense, "digram_pair_counts"), (row, "digram_pair_accum"),
                        (sel, "digram_select")):
        entry["launches_mutation_part"] = main["mutation_part"]["launches"][name]
        entry["launches_snapshot_part"] = main["snapshot_part"]["launches"][name]
        entry["launches_baselines_part"] = main["baselines_part"]["launches"][name]
    return [dense, row, sel]


def _k2_lines_rows(torch, main: dict, errs: dict, lay, s, per_level, rank_calls) -> list:
    """The fused descent on the s?? seed batch: held against its twin and
    the per-level path, timed as the wrapper runs it (both passes, the scan
    and the host read), each pass's device time from the profiler, beside
    the twin on the card and the per-level path (the level loop launching
    the standalone rank kernel). Bound: the tree's bytes, the batch's and
    16 B a result at 3.35 TB/s, or 12 operations a bit test at the float32
    rate, whichever is larger."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitvec_rank import bitvec_rank_cuda
    from repro_torch.kernels.k2_lines import k2_lines_cuda

    got = k2_lines_cuda(lay, s, 0)
    for what, want in (("twin", ref.k2_lines_ref(lay, s, 0)), ("per-level path", per_level)):
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            _fail(f"k2_lines differs from the {what} at the s?? seed batch")
    results = got[0].numel()
    heaviest = int(torch.bincount(got[0]).max()) if results else 0
    kern = lambda: k2_lines_cuda(lay, s, 0)  # noqa: E731
    twin = lambda: ref.k2_lines_ref(lay, s, 0)  # noqa: E731
    levels = lambda: ref.k2_lines_ref(lay, s, 0, rank=bitvec_rank_cuda)  # noqa: E731
    plain_a, level_a = _time_ms(torch, twin, 10), _time_ms(torch, levels, 10)
    ms_a, ms_b = _time_ms(torch, kern, 50), _time_ms(torch, kern, 50)
    level_b, plain_b = _time_ms(torch, levels, 10), _time_ms(torch, twin, 10)
    device = {}
    _, _, avgs = _profile(torch, lambda: [kern() for _ in range(20)])
    for name, key in (("k2_lines_count", "k2_count_kernel"),
                      ("k2_lines_write", "k2_write_kernel")):
        hits = [e for e in avgs if key in e.key]
        seen = sum(e.count for e in hits)
        if seen:  # the trace may lose launches: average over those it holds
            device[name] = sum(getattr(e, "self_device_time_total", 0)
                               for e in hits) / seen / 1e3
    # the work this batch needs: every valid query's root and every node the
    # level loop ranked is a node whose k candidate bits the walk tests
    n_valid = int(((s >= 0) & (s < lay.n_rows)).sum())
    tests = lay.k * (n_valid + sum(a[2].numel() for a in rank_calls))
    tree = lay.words.numel() * 4 + lay.ranks.numel() * 8 + (2 * lay.h + 1) * 8
    q = s.numel()
    t_ops = 12 * tests / CORE_OPS_PER_S * 1e3
    wrapper_ms = min(ms_a, ms_b)
    plain_ms = min(plain_a, plain_b)
    level_ms = min(level_a, level_b)
    both = (tree + 8 * q + 16 * results) / HBM_BYTES_PER_S * 1e3
    print(f"kernel k2_lines (s?? seed, Q={q}, h={lay.h}, tree {tree} B) ms={wrapper_ms:.6f} "
          f"(both passes, scan and host read; runs {ms_a:.6f} {ms_b:.6f}) "
          f"device_ms count={device.get('k2_lines_count', 'not measured')} "
          f"write={device.get('k2_lines_write', 'not measured')} plain_ms={plain_ms:.6f} "
          f"per_level_ms={level_ms:.6f} (runs {level_a:.6f} {level_b:.6f}) "
          f"bound_ms={max(both, t_ops):.6f} ({'bytes' if both >= t_ops else 'operations'}; "
          f"bit tests={tests}) results={results} heaviest_row={heaviest} library=none")
    rows = []
    for name, nbytes in (("k2_lines_count", tree + 16 * q),
                         ("k2_lines_write", tree + 16 * q + 16 * results)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/bitvec_rank.cu",
                     "replaces": "src/repro/kernels/bitvec_rank.py:33",
                     "launches": main["counts"][name], "max_abs_err": errs[name],
                     "ms": device.get(name, wrapper_ms), "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": None, "wrapper_ms": wrapper_ms, "per_level_ms": level_ms,
                     "device_measured": name in device, "heaviest_row": heaviest,
                     "launches_scalar_part": main["scalar_part"]["launches"][name],
                     "launches_mutation_part": main["mutation_part"]["launches"][name],
                     "launches_snapshot_part": main["snapshot_part"]["launches"][name],
                     "launches_baselines_part": main["baselines_part"]["launches"][name],
                     "single_row_ms": main["scalar_part"]["row_ms"]})
    return rows


def _profile(torch, fn):
    """(wall seconds, summed device kernel seconds, key averages) of one
    call of fn."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in avgs)
    return wall, dev_us / 1e6, avgs



def _count_syncs(torch, fn) -> int:
    """Host-device synchronisations during one call of fn, as counted by
    torch's CUDA sync debug mode."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _same_graph(torch, a, b) -> bool:
    return a.n_nodes == b.n_nodes and all(
        torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
        for f in ("labels", "nodes_flat", "offsets"))


def _same_grammar(torch, a, b) -> bool:
    """Label ranks, start graph and every rule's rank and right-hand side."""
    return torch.equal(a.table.ranks.cpu(), b.table.ranks.cpu()) \
        and _same_graph(torch, a.start, b.start) and sorted(a.rules) == sorted(b.rules) \
        and all(a.rules[lbl].rank == b.rules[lbl].rank
                and _same_graph(torch, a.rules[lbl].rhs, b.rules[lbl].rhs) for lbl in a.rules)


def _counter_syncs(torch, fn, iterations: int) -> None:
    """Host syncs of one call of fn (a compress) made inside the counter's
    Update Count (``DigramCounter.apply_delta``) and its selections
    (``pop_best``, ``peek_pop``), by torch's sync debug mode."""
    import warnings

    from repro_torch.core.digram import DigramCounter

    inside = {"apply_delta": 0, "pop_best": 0, "peek_pop": 0}
    real = {name: getattr(DigramCounter, name) for name in inside}
    log = []

    def wrap(name):
        def run(self, *a, **kw):
            before = len(log[0])
            try:
                return real[name](self, *a, **kw)
            finally:
                inside[name] += sum("synchroniz" in str(w.message) for w in log[0][before:])
        return run

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            log.append(caught)
            for name in inside:
                setattr(DigramCounter, name, wrap(name))
            fn()
    finally:
        for name, f in real.items():
            setattr(DigramCounter, name, f)
        torch.cuda.set_sync_debug_mode("default")
    total = sum("synchroniz" in str(w.message) for w in log[0])
    counter = sum(inside.values())
    print(f"compress host_syncs={total}: counter {counter} (apply_delta {inside['apply_delta']}, "
          f"selections {inside['pop_best'] + inside['peek_pop']}) over {iterations} "
          f"replacements, {counter / max(iterations, 1):.3f} a replacement; "
          f"the rest {(total - counter) / max(iterations, 1):.3f} a replacement")


def breakdown(torch, main: dict) -> None:
    """Phase 5: where the main path's time goes (warm repeats)."""
    from repro_torch.core import compress
    from repro_torch.core.digram import digram_counts

    engine, batches = main["engine"], main["batches"]
    for pat, cols in batches.items():
        t0 = time.perf_counter()
        engine.query_batch_view(*cols)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"warm query {pat} us_per_query={dt / cols[0].numel() * 1e6:.3f} "
              f"batch_ms={dt * 1e3:.3f}")
    s = batches["s??"][0]
    t0 = time.perf_counter()
    engine.incidence.rows_many(s)
    torch.cuda.synchronize()
    seed_ms = (time.perf_counter() - t0) * 1e3
    repeats = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.incidence.rows_many(s)
        torch.cuda.synchronize()
        repeats.append((time.perf_counter() - t0) * 1e3)
    seed_syncs = _count_syncs(torch, lambda: engine.incidence.rows_many(s))
    print(f"s?? seed (k2 rows_many, {engine.incidence.h} levels) ms={seed_ms:.3f} "
          f"min_of_5_ms={min(repeats):.3f} host_syncs={seed_syncs}")
    if seed_syncs != 1:
        _fail(f"rows_many made {seed_syncs} host syncs at the s?? batch, not 1")
    t0 = time.perf_counter()
    digram_counts(main["graph"], main["table"], cap=64)
    torch.cuda.synchronize()
    print(f"initial Count (digram_counts) ms={(time.perf_counter() - t0) * 1e3:.3f}")
    for what, fn in (("s?? batch", lambda: engine.query_batch_view(*batches["s??"])),
                     ("?p? batch", lambda: engine.query_batch_view(*batches["?p?"])),
                     ("compress", lambda: compress(main["graph"], main["table"]))):
        wall, dev, avgs = _profile(torch, fn)
        share = f"{dev / wall:.4f}" if dev > 0 else "not measured"
        syncs = _count_syncs(torch, fn)
        print(f"device busy {what}: wall_s={wall:.6f} kernel_s={dev:.6f} busy_share={share} "
              f"host_syncs={syncs}")
    for name in ("digram_pair_accum", "digram_select"):  # the last profile: compress
        hits = [e for e in avgs if f"{name}_kernel" in e.key]
        seen = sum(e.count for e in hits)
        device = sum(getattr(e, "self_device_time_total", 0) for e in hits) / seen / 1e3 \
            if seen else "not measured"
        print(f"compress {name}: launches in the trace={seen} device_ms_per_launch={device}")
    _counter_syncs(torch, lambda: compress(main["graph"], main["table"]), main["stats"].iterations)

    # the same port code on the host CPU, as a yardstick for the host-bound
    # parts (a CPU time, not a device metric)
    from repro_torch.core import Hypergraph, LabelTable, TripleQueryEngine, encode

    ds = main["dataset"]
    t0 = time.perf_counter()
    grammar, stats = compress(Hypergraph.from_triples(ds.triples, ds.n_nodes, device="cpu"),
                              LabelTable.terminals([2] * ds.n_preds, device="cpu"))
    cpu_engine = TripleQueryEngine(grammar, encode(grammar), cache=None, delta_budget=None)
    build_s = time.perf_counter() - t0
    if vars(stats) != vars(main["stats"]) or not _same_grammar(torch, grammar, main["grammar"]):
        _fail("the card's grammar differs from the CPU path's")
    print(f"card grammar == CPU grammar: stats {vars(stats)}, {len(grammar.rules)} rules, "
          f"start graph of {grammar.start.n_edges} edges, bit for bit")
    cols = [c.cpu() for c in batches["s??"]]
    t0 = time.perf_counter()
    cpu_engine.query_batch_view(*cols)
    dt = time.perf_counter() - t0
    print(f"host CPU yardstick (same code, device=cpu): build_s={build_s:.6f} "
          f"s?? us_per_query={dt / cols[0].numel() * 1e6:.3f}")


class _Twins:
    """Route ``ops.embedding_bag``, ``ops.dot_interaction``,
    ``ops.flash_attention``, ``ops.csr_spmm`` and DLRM training's
    ``ops.embedding_bag_backward``, ``ops.dot_interaction_backward`` and
    ``ops.sgd_rows`` to their plain twins inside the block, for the twin
    paths of the DLRM, LM and GNN checks;
    ``attention`` replaces the attention twin (the LM checks' witness and
    control)."""

    NAMES = ("embedding_bag", "dot_interaction", "flash_attention", "csr_spmm",
             "embedding_bag_backward", "dot_interaction_backward", "sgd_rows")

    def __init__(self, attention=None):
        self.attention = attention

    def __enter__(self):
        from repro_torch.kernels import ops, ref

        self.ops = ops
        self.saved = {n: getattr(ops, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(ops, n, getattr(ref, f"{n}_ref"))
        ops.csr_spmm = lambda x, a: ref.csr_spmm_ref(x, a.row_ptr, a.col, a.n_rows)
        if self.attention is not None:
            ops.flash_attention = self.attention
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ops, n, fn)


class _Routes:
    """Route the MoE layers' choices (``transformer.moe_route``): with no
    log, record each call's experts; with a log (another run's record),
    replay them in call order and count the tokens whose own top-k
    differs (``flips``), so that a comparison of two paths holds their
    continuous arithmetic apart from a near-tie that rounding flips. A
    dense model makes no call."""

    def __init__(self, log=None):
        self.replay = log
        self.log, self.flips, self.calls = [], 0, 0

    def __enter__(self):
        from repro_torch.models import transformer

        self.tf, self.real = transformer, transformer.moe_route

        def route(logits, top_k):
            probs, idx = self.real(logits, top_k)
            if self.replay is None:
                self.log.append(idx)
                return probs, idx
            want = self.replay[self.calls]
            self.calls += 1
            self.flips += int((idx != want).any(-1).sum())
            return probs, want

        transformer.moe_route = route
        return self

    def __exit__(self, *exc):
        self.tf.moe_route = self.real


class _Plans:
    """Spy on ``ops.flash_attention``: for each call, its window and the
    split count :func:`planned_splits` gives for the call's own arguments
    (the plan the wrapper launches, a merge when above 1)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels.flash_attention import planned_splits

        self.ops, self.real, self.calls = ops, ops.flash_attention, []

        def spy(q, k, v, **kw):
            self.calls.append((kw.get("window"), planned_splits(q, k, **kw)))
            return self.real(q, k, v, **kw)

        ops.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.real

    def merges(self) -> int:
        return sum(n > 1 for _, n in self.calls)

    def by_kind(self) -> dict:
        """{"local" | "global": {n_splits: calls}}."""
        out = {}
        for window, n in self.calls:
            kind = out.setdefault("global" if window is None else "local", {})
            kind[n] = kind.get(n, 0) + 1
        return out


def _hold_against_twins(torch, model, dense, sparse, what: str) -> None:
    """The kernel path against the twin path on one batch: the fields
    exactly equal, the logits within LOGIT_TOL."""
    x_k, f_k = model.fields(dense, sparse)
    l_k = model(dense, sparse)
    with _Twins():
        x_t, f_t = model.fields(dense, sparse)
        l_t = model(dense, sparse)
    torch.cuda.synchronize()
    if not (torch.equal(f_k, f_t) and torch.equal(x_k, x_t)):
        _fail(f"{what}: the kernel path's fields differ from the twin path's")
    if not torch.allclose(l_k, l_t, **LOGIT_TOL):
        _fail(f"{what}: the kernel path's logits differ from the twin path's")
    print(f"{what}: B={dense.shape[0]} fields equal=True logits max_abs_err="
          f"{float((l_k - l_t).abs().max())} tol={LOGIT_TOL} "
          f"logit range [{float(l_k.min()):.4f}, {float(l_k.max()):.4f}]")


def _path_counts(what: str, counts: dict) -> dict:
    """The DLRM kernels' launch counts of one path; fail if either is 0 or
    if the interaction took the SIMT kernel (DLRM's fields are bf16 with D =
    128: the tensor-core kernel's)."""
    counts = {k: counts[k] for k in ("embedding_bag", "dot_interaction",
                                     "dot_interaction_simt")}
    for name, c in counts.items():
        print(f"launches {name} {c} (dlrm {what})")
        if c <= 0 and name != "dot_interaction_simt":
            _fail(f"the DLRM {what} path never launched {name}")
    if counts["dot_interaction_simt"]:
        _fail(f"the DLRM {what} path took the SIMT dot_interaction kernel")
    return counts


def _top_kernels(avgs, n: int = 8) -> str:
    rows = sorted(((getattr(e, "self_device_time_total", 0), e.count, e.key) for e in avgs),
                  reverse=True)[:n]
    return "; ".join(f"{k[:60]} x{c} {us / 1e3:.3f} ms" for us, c, k in rows if us > 0)


def _served_counts(torch, run) -> tuple:
    """Run one served batch with every launch count at 0 before it; return
    the counts just after."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    if ops.launch_counts["flash_attention_combine_rowwise"]:
        _fail("a served batch launched the rowwise merge, which is on no path")
    return dict(ops.launch_counts), out


def _small_dlrm_params(np, cfg, seed: int) -> dict:
    """A ``dlrm_init``-shaped pytree of numpy arrays, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f = cfg.n_fields
    sizes = {"bot": [cfg.n_dense, *cfg.bot_mlp],
             "top": [f * (f - 1) // 2 + cfg.embed_dim, *cfg.top_mlp]}
    return {"tables": {f"table_{i}": (rng.normal(size=(cfg.padded_rows(r), cfg.embed_dim))
                                      / cfg.embed_dim ** 0.5).astype(np.float32)
                       for i, r in enumerate(cfg.row_counts)},
            **{k: [{"w": (rng.normal(size=(a, b)) / a ** 0.5).astype(np.float32),
                    "b": rng.normal(size=b).astype(np.float32) * 0.1}
                   for a, b in zip(v[:-1], v[1:])] for k, v in sizes.items()}}


def dlrm_vs_host(torch, np, seed: int) -> None:
    """A small DLRM (the reduced config in bfloat16) from the same numpy
    weights on the card, through the kernels, and on the host CPU, through
    the twins: the logits must agree."""
    import dataclasses

    from repro_torch.configs.dlrm_mlperf import reduced
    from repro_torch.launch.steps import dlrm_batch
    from repro_torch.models.dlrm import DLRM

    cfg = dataclasses.replace(reduced(), compute_dtype="bfloat16")
    params = _small_dlrm_params(np, cfg, seed)
    dense, sparse = dlrm_batch(cfg, 1000, torch.Generator().manual_seed(seed))
    host = DLRM.from_numpy_params(params, cfg, device="cpu")(dense, sparse)
    card = DLRM.from_numpy_params(params, cfg, device=DEV)(dense.to(DEV), sparse.to(DEV))
    err = float((card.cpu() - host).abs().max())
    if not torch.allclose(card.cpu(), host, rtol=1e-3, atol=1e-3):
        _fail(f"small DLRM on the card differs from the host CPU (max abs err {err})")
    print(f"dlrm small model card vs host CPU: B=1000 max_abs_err={err} tol=1e-3")


def time_dlrm_kernels(torch, model, dense, sparse, p99_fields, errs: dict, launches: dict,
                      p99_launches: dict) -> list:
    """Phase 4's rows for embedding_bag and dot_interaction, on the inputs
    the serve_bulk batch gave them (dot_interaction also on a serve_p99
    batch's fields, ``p99_fields``). ``launches`` are the serve_bulk path's
    counts, the run these rows time; ``p99_launches`` the serve_p99 path's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    table = model.table
    bags = (sparse + model.row_offsets).reshape(-1, 1)
    _, fields = model.fields(dense, sparse)
    got, want = embedding_bag_cuda(table, bags), ref.embedding_bag_ref(table, bags)
    if not torch.equal(got, want):
        _fail("embedding_bag differs from its twin at serve_bulk shapes")
    errs["embedding_bag"] = max(errs["embedding_bag"], float((got.float() - want.float())
                                                             .abs().max()))
    del got, want

    # each distinct row is read once (the small tables' rows recur), each
    # index read and each output row written once
    es = table.element_size()
    n_bags, d = bags.shape[0], table.shape[1]
    valid = bags[bags >= 0]
    n_valid, n_distinct = valid.numel(), int(torch.unique(valid).numel())
    emb_bytes = n_distinct * d * es + bags.numel() * bags.element_size() + n_bags * d * es
    emb_ops = n_valid * d
    print(f"embedding_bag main-path shape: table {tuple(table.shape)} {table.dtype}, "
          f"bags {tuple(bags.shape)} {bags.dtype}, {n_valid} rows gathered, "
          f"{n_distinct} distinct; dot_interaction: fields "
          f"{tuple(fields.shape)} {fields.dtype}")

    kern = lambda: embedding_bag_cuda(table, bags)  # noqa: E731
    twin = lambda: ref.embedding_bag_ref(table, bags)  # noqa: E731
    lib = lambda: torch.nn.functional.embedding_bag(bags, table, mode="sum")  # noqa: E731
    plain_a = _time_ms(torch, twin, 3)
    ms_a = _time_ms(torch, kern, 20)
    lib_a = _time_ms(torch, lib, 10)
    lib_b = _time_ms(torch, lib, 10)
    ms_b = _time_ms(torch, kern, 20)
    plain_b = _time_ms(torch, twin, 3)
    t_bytes = emb_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = emb_ops / CORE_OPS_PER_S * 1e3
    emb = {"name": "embedding_bag", "route": "cuda",
           "source": "src/repro_torch/csrc/embedding_bag.cu",
           "replaces": "src/repro/kernels/embedding_bag.py:29",
           "launches": launches["embedding_bag"], "max_abs_err": errs["embedding_bag"],
           "ms": min(ms_a, ms_b), "plain_ms": min(plain_a, plain_b),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": min(lib_a, lib_b), "launches_serve_p99": p99_launches["embedding_bag"]}
    print(f"kernel embedding_bag ms={emb['ms']:.6f} (runs {ms_a:.6f} {ms_b:.6f}) "
          f"plain_ms={emb['plain_ms']:.6f} bound_ms={emb['bound_ms']:.6f} "
          f"({emb['bound_by']}, {emb_bytes} B, {emb_ops} ops) "
          f"library_ms={emb['library_ms']:.6f} (torch.nn.functional.embedding_bag) "
          f"launches serve_bulk={emb['launches']} serve_p99={p99_launches['embedding_bag']}")
    del bags, valid
    return [emb, _dot_row(torch, fields, p99_fields, errs, launches, p99_launches)]


def _dot_yardsticks(torch, x) -> dict:
    """The PyTorch calls that compute the interaction of x, each checked
    against the plain twin within DOT_TOL first: torch.bmm of the
    float32-upcast fields, and torch.bmm of the bf16 fields with float32
    output (cuBLAS on the tensor cores, the contract of `_interact`), each
    with its tril gather. One the card's torch refuses, or that computes
    another function, is printed and left out."""
    from repro_torch.kernels import ref

    f = x.shape[1]
    ii, jj = torch.tril_indices(f, f, -1, device=x.device)
    xf = x.float()
    calls = {"bmm_fp32_upcast": lambda: torch.bmm(xf, xf.transpose(1, 2))[:, ii, jj],
             "bmm_bf16_out_fp32": lambda: torch.bmm(x, x.transpose(1, 2),
                                                    out_dtype=torch.float32)[:, ii, jj]}
    want = ref.dot_interaction_ref(x)
    for name in list(calls):
        try:
            got = calls[name]()
        except (TypeError, RuntimeError, NotImplementedError) as e:
            print(f"yardstick {name} refused by torch {torch.__version__}: "
                  f"{str(e).splitlines()[0][:200]}; left out")
            del calls[name]
            continue
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = got.shape == want.shape and torch.allclose(got, want, **DOT_TOL)
        print(f"yardstick {name} vs plain twin at B={x.shape[0]}: max_abs_err={err} "
              f"tol={DOT_TOL} same function={ok}")
        if not ok:
            del calls[name]
        del got
    return calls


def _device_ms(torch, fn, reps: int) -> float:
    """Device time of one call of fn: `reps` calls under the profiler, each
    kernel's device time over the launches it traced, summed over the
    kernels of a call."""
    fn()
    torch.cuda.synchronize()
    _, _, avgs = _profile(torch, lambda: [fn() for _ in range(reps)])
    return sum(e.self_device_time_total / e.count for e in avgs
               if getattr(e, "self_device_time_total", 0) > 0 and e.count) / 1e3


def _time_dot(torch, x, reps: int, device_reps: int = 0) -> dict:
    """The interaction on x: kernel, plain twin and yardsticks timed in
    turns (plain, kernel, yardsticks, yardsticks, kernel, plain), the
    kernel held against both twins first; with device_reps, also the
    device time of one call of the kernel and of each yardstick."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dot_interaction import dot_interaction_cuda, uses_tensor_cores

    b, f, d = x.shape
    got = dot_interaction_cuda(x)
    for twin in (ref.dot_interaction_ref, ref.dot_interaction_tc_ref):
        want = twin(x)
        if not torch.allclose(got, want, **DOT_TOL):
            _fail(f"dot_interaction differs from {twin.__name__} at B={b} F={f} D={d}")
        err = float((got - want).abs().max())
        del want
    del got
    libs = _dot_yardsticks(torch, x)
    kern = lambda: dot_interaction_cuda(x)  # noqa: E731
    twin = lambda: ref.dot_interaction_ref(x)  # noqa: E731
    plain_reps = max(3, reps // 10)
    plain_a = _time_ms(torch, twin, plain_reps)
    ms_a = _time_ms(torch, kern, reps)
    lib_a = {n: _time_ms(torch, fn, reps) for n, fn in libs.items()}
    lib_b = {n: _time_ms(torch, fn, reps) for n, fn in libs.items()}
    ms_b = _time_ms(torch, kern, reps)
    plain_b = _time_ms(torch, twin, plain_reps)
    p = f * (f - 1) // 2
    nbytes = x.numel() * x.element_size() + b * p * 4
    nops = 2 * b * p * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / (H100_BF16_FLOPS if uses_tensor_cores(x) else CORE_OPS_PER_S) * 1e3
    row = {"ms": min(ms_a, ms_b), "runs": [ms_a, ms_b], "plain_ms": min(plain_a, plain_b),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_calls": {n: min(lib_a[n], lib_b[n]) for n in libs},
           "bytes": nbytes, "ops": nops, "max_abs_err": err}
    if device_reps:
        row["device_ms"] = _device_ms(torch, kern, device_reps)
        row["library_device_ms"] = {n: _device_ms(torch, fn, device_reps)
                                    for n, fn in libs.items()}
    return row


DOT_SWEEP = ((8, 3), (8, 2), (4, 3), (4, 2), (2, 3), (8, 1))  # (samples, stages) at serve_bulk


def _dot_row(torch, fields, p99_fields, errs: dict, launches: dict, p99_launches: dict) -> dict:
    """The dot_interaction row: the serve_bulk fields and a serve_p99 batch's
    (B = 512), each beside its bound, twin and yardsticks; a sweep of the
    launch plan at serve_bulk (each plan's output bit-identical to the
    plan's own: a sample's arithmetic does not depend on its group); the
    tensor-core kernel's HMMA count in its SASS."""
    from dataclasses import asdict

    from repro_torch.kernels.dot_interaction import (_sm_count, dot_interaction_cuda, tc_plan,
                                                     uses_tensor_cores)

    if not (uses_tensor_cores(fields) and uses_tensor_cores(p99_fields)):
        _fail("DLRM's fields do not take the tensor-core dot_interaction")
    bulk = _time_dot(torch, fields, 20)
    p99 = _time_dot(torch, p99_fields, 200, device_reps=50)
    errs["dot_interaction"] = max(errs["dot_interaction"], bulk["max_abs_err"],
                                  p99["max_abs_err"])
    b, f, d = fields.shape
    n_sm = _sm_count(fields.device)
    plan = tc_plan(b, f, d, n_sm)
    base = dot_interaction_cuda(fields)
    sweep = {}
    for samples, stages in DOT_SWEEP:
        sp = tc_plan(b, f, d, n_sm, samples=samples, stages=stages)
        if not torch.equal(dot_interaction_cuda(fields, sp), base):
            _fail(f"dot_interaction's output depends on its plan ({samples}, {stages})")
        sweep[f"{samples}x{stages}"] = {"blocks": sp.blocks, "smem": sp.smem,
                                        "ms": _time_ms(torch, lambda sp=sp: dot_interaction_cuda(
                                            fields, sp), 10)}
    del base
    mma = _mma_counts("dot_interaction")
    tc_keys = [k for k in mma if "dot_interaction_tc_kernel" in k]
    hmma = sum(mma[k]["HMMA"] for k in tc_keys) if mma else None
    if mma and not hmma:
        _fail("no HMMA in the tensor-core dot_interaction kernel's SASS")
    libs = bulk["library_calls"]
    row = {"name": "dot_interaction", "route": "cuda",
           "source": "src/repro_torch/csrc/dot_interaction.cu",
           "replaces": "src/repro/kernels/dot_interaction.py:26",
           "launches": launches["dot_interaction"], "max_abs_err": errs["dot_interaction"],
           "ms": bulk["ms"], "plain_ms": bulk["plain_ms"], "bound_ms": bulk["bound_ms"],
           "bound_by": bulk["bound_by"], "library_ms": min(libs.values()) if libs else None,
           "library_calls": libs, "launches_simt": launches["dot_interaction_simt"],
           "launches_serve_p99": p99_launches["dot_interaction"],
           "serve_p99": {k: p99[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_calls",
                                              "library_device_ms")},
           "plan": asdict(plan), "plan_sweep_ms": sweep, "hmma_sass": hmma}
    for what, r in (("serve_bulk", bulk), ("serve_p99 B=512", p99)):
        print(f"kernel dot_interaction at {what} fields ms={r['ms']:.6f} (runs "
              f"{r['runs'][0]:.6f} {r['runs'][1]:.6f}) device_ms={r.get('device_ms', 'n/a')} "
              f"plain_ms={r['plain_ms']:.6f} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}, "
              f"{r['bytes']} B, {r['ops']} ops) share of bound="
              f"{r['bound_ms'] / r['ms']:.3f} library_ms={r['library_calls']} "
              f"library_device_ms={r.get('library_device_ms', 'n/a')}")
    print(f"dot_interaction plan at serve_bulk {asdict(plan)}; sweep (samples x stages): {sweep}; "
          f"HMMA in the tensor-core kernel (SASS, static) {hmma}; launches serve_bulk "
          f"tensor cores={launches['dot_interaction']} simt={launches['dot_interaction_simt']} "
          f"serve_p99 tensor cores={p99_launches['dot_interaction']} "
          f"simt={p99_launches['dot_interaction_simt']}")
    return row


def _cat_passes(avgs) -> None:
    """Device time of the concatenations in a profiled DLRM batch (the fields
    (B, 27, D) in bf16 before the interaction, the top MLP's float32 input
    after it), by kernel."""
    cats = [(e.key, getattr(e, "self_device_time_total", 0), e.count) for e in avgs
            if "Cat" in e.key and getattr(e, "self_device_time_total", 0) > 0]
    print(f"torch.cat passes in the serve_bulk batch (device time): "
          f"{[(k[:160], us / 1e3, c) for k, us, c in cats]} "
          f"total_ms={sum(us for _, us, _ in cats) / 1e3}")


def drive_dlrm(torch, np, seed: int, errs: dict) -> list:
    """Phase 6: dlrm-mlperf at full size under its three serving shapes."""
    from repro_torch.launch.steps import build_cell, dlrm_batch

    dlrm_vs_host(torch, np, seed)

    # serve_p99: batches of 512
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = build_cell("dlrm-mlperf", "serve_p99", seed=seed)
    torch.cuda.synchronize()
    model = cell.model
    table = model.table
    print(f"dlrm init_s={time.perf_counter() - t0:.3f} table_rows={table.shape[0]} "
          f"dim={table.shape[1]} dtype={table.dtype} table_bytes="
          f"{table.numel() * table.element_size()} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    counts, logits = _served_counts(torch, cell.run)
    p99_counts = _path_counts("serve_p99", counts)
    if logits.shape != (512,) or not bool(torch.isfinite(logits).all()):
        _fail("serve_p99 logits are not 512 finite values")
    _hold_against_twins(torch, model, *cell.args, "serve_p99 batch")
    _, p99_fields = model.fields(*cell.args)  # timed with the serve_bulk rows
    gen =torch.Generator(device=DEV).manual_seed(seed + 2)
    batches = [dlrm_batch(model.cfg, 512, gen) for _ in range(200)]
    for dense, sparse in batches[:20]:
        model(dense, sparse)
    torch.cuda.synchronize()
    lat = []
    for dense, sparse in batches:
        t0 = time.perf_counter()
        model(dense, sparse)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    lat_ms = np.array(lat) * 1e3
    print(f"serve_p99 B=512 batches=200 p50_ms={np.percentile(lat_ms, 50):.6f} "
          f"p99_ms={np.percentile(lat_ms, 99):.6f} mean_ms={lat_ms.mean():.6f} "
          f"max_ms={lat_ms.max():.6f}")
    wall, dev, avgs = _profile(torch, lambda: model(*batches[0]))
    p50_s = float(np.percentile(lat_ms, 50)) / 1e3
    print(f"device busy serve_p99 batch: wall_s={wall:.6f} kernel_s={dev:.6f} "
          f"busy_share={dev / wall if dev > 0 else 'not measured'} (profiled wall); "
          f"kernel_s / p50 = {dev / p50_s if dev > 0 else 'not measured'}")
    print(f"serve_p99 kernels by device time: {_top_kernels(avgs)}")
    del cell, model, table, batches, logits
    torch.cuda.empty_cache()

    # serve_bulk: one batch of 262,144
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = build_cell("dlrm-mlperf", "serve_bulk", seed=seed)
    torch.cuda.synchronize()
    model, (dense, sparse) = cell.model, cell.args
    print(f"dlrm init_s={time.perf_counter() - t0:.3f} (serve_bulk cell)")
    counts, logits = _served_counts(torch, cell.run)
    bulk_counts = _path_counts("serve_bulk", counts)
    n = dense.shape[0]
    if logits.shape != (n,) or not bool(torch.isfinite(logits).all()):
        _fail("serve_bulk logits are not finite")
    print(f"serve_bulk max_memory_allocated={torch.cuda.max_memory_allocated()}")
    _hold_against_twins(torch, model, dense[:4096], sparse[:4096], "serve_bulk first 4096")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        model(dense, sparse)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"serve_bulk B={n} repeats=5 batch_s={[round(t, 6) for t in times]} "
          f"samples_per_s={n / float(np.median(times)):.1f}")
    wall, dev, avgs = _profile(torch, lambda: model(dense, sparse))
    print(f"device busy serve_bulk batch: wall_s={wall:.6f} kernel_s={dev:.6f} "
          f"busy_share={dev / wall if dev > 0 else 'not measured'}")
    print(f"serve_bulk kernels by device time: {_top_kernels(avgs)}")
    _cat_passes(avgs)
    rows = time_dlrm_kernels(torch, model, dense, sparse, p99_fields, errs, bulk_counts,
                             p99_counts)
    print(f"peak max_memory_allocated serve_bulk={torch.cuda.max_memory_allocated()}")
    del cell, model, dense, sparse, logits, p99_fields
    torch.cuda.empty_cache()

    # retrieval_cand: one query against 1,000,192 candidates
    cell = build_cell("dlrm-mlperf", "retrieval_cand", seed=seed)
    counts, (values, idx) = _served_counts(torch, cell.run)
    query, cands = cell.args
    scores = cands.double().cpu() @ query.double().cpu()
    kth = torch.topk(scores, 101).values[-1]
    if values.shape != (100,) or not bool((scores[idx.cpu()] >= kth - 1e-3).all()) \
            or not bool((values[:-1] >= values[1:]).all()):
        _fail("retrieval_cand top-100 is not the float64 top-100 of the scores")
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        cell.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"retrieval_cand candidates={cands.shape[0]} k=100 launches={counts} "
          f"ms_per_query_median={float(np.median(times)) * 1e3:.6f} "
          f"ms_min={min(times) * 1e3:.6f}")
    del cell, cands
    torch.cuda.empty_cache()
    return rows


# DLRM training: the kernels of the train step against their twins (phase
# 2) and the full-size train_batch step (phase 6b).
EMB_BWD_TOL = dict(rtol=1e-5, scaled=1e-5)  # float32 sums in another order: atol 1e-5 max|want|
DOT_BWD_TOL = {"float32": dict(rtol=1e-5, scaled=1e-5),
               "bfloat16": dict(rtol=2.0 ** -7, scaled=1e-5)}  # + one bf16 rounding apart
TRAIN_STEPS = 10       # timed steps of train_batch, after TRAIN_WARMUP
TRAIN_WARMUP = 2
TRAIN_MAX_SYNCS = 2    # host syncs a step may make
UNTOUCHED_SAMPLE = 100_000
# the full-size step against the same step through the twins: loss and
# grad_norm within 1e-4 relative (float32 sums in another order over 65,536
# samples); the compact gradient within EMB_BWD_TOL of the twin on the
# kernel path's own input, and against the twin path's, every entry within
# the bound that the paths' own dz and field differences and roundings give
# it (_grad_bound: the twin path's dz differs, by the forward's order of
# sums and by ReLU inputs of the top MLP within float32 noise of 0, G X can
# cancel below that, and each path rounds the lookup's gradient to bf16),
# and within GRAD_PATH_RTOL in norm; the touched rows' master within 1e-7
# absolute (a step moves a row by lr x clip x g, 6e-6 x |g| at the held
# step, so gradient differences land far below it, and so does most of the
# update itself: sgd_rows' arithmetic is held apart, at SGD_CHECK_LR and
# SGD_CHECK_CLIP); their bf16 values within one bf16 step (2^-8 relative),
# where the two masters straddle a rounding boundary; the MLP leaves within
# 2 lr (an AdamW step moves an entry by about lr, as in the CPU test).
STEP_RTOL = 1e-4
GRAD_PATH_RTOL = 1e-2  # the compact gradient's relative norm difference between the paths
DZ_DIVERGED = 1e-4     # a sample's dz gap past this share of its max|dz| (counted)
MASTER_ATOL = 1e-7
F32_EPS = 2.0 ** -24   # float32 unit roundoff: a sum of m terms is off by at most m u sum|terms|
BF16_HALF_STEP = 2.0 ** -8  # bf16 rounding moves a value by at most this share of it
SGD_CHECK_LR, SGD_CHECK_CLIP = 0.05, 0.3  # sgd_rows at train_batch shapes, large enough to move
SGD_MOVED_SHARE = 0.5  # ... most touched rows, else the check fails
EMB_BWD_REPLACES = "src/repro/kernels/embedding_bag.py:29"
DOT_BWD_REPLACES = "src/repro/kernels/dot_interaction.py:26"
SGD_REPLACES = "src/repro/train/optimizer.py:93"


def _close(torch, got, want, rtol: float, scaled: float) -> bool:
    """|got - want| <= scaled max|want| + rtol |want| everywhere."""
    want = want.float()
    lim = scaled * float(want.abs().max()) + rtol * want.abs()
    return bool(((got.float() - want).abs() <= lim).all())


def _bwd_case(torch, np, rng, b: int, bag_len: int, n_rows: int, d: int, dt, pad: bool):
    idx = rng.integers(0, n_rows, (b, bag_len))
    if pad:
        idx[rng.random((b, bag_len)) < 0.25] = -1
        idx[: min(b, 2)] = -1
    g = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dt)
    return idx, g


# embedding_bag_backward's routes: the one-pass kernel (the wrapper's), the
# two-pass kernel and its combine (two_pass=True, kept to be timed beside it)
EMB_BWD_ROUTES = {"one_pass": {"embedding_bag_backward": 1},
                  "two_pass": {"embedding_bag_backward_two_pass": 1,
                               "embedding_bag_backward_combine": 1}}
# other plans of the one-pass kernel, held bit for bit: other chunks on every
# path, other rings on bfloat16 rows in 16-byte pieces (their instances)
EMB_BWD_OTHER_CHUNKS = ("128:32", "512:32")
EMB_BWD_OTHER_RINGS = ("256:16", "256:64")


def _misaligned(torch, g, elems: int):
    """g's values in a contiguous view whose pointer lies `elems` elements
    past an allocation's start."""
    buf = torch.empty(g.numel() + elems, dtype=g.dtype, device=DEV)
    out = buf[elems:].view(g.shape)
    out.copy_(g.to(DEV))
    return out


def _longest_run_chunks(np, idx, chunk: int) -> int:
    """The most chunks of `chunk` sorted positions one id's run spans, as
    the wrapper sorts `idx` (padding first)."""
    ids, start, count = np.unique(np.sort(idx.ravel()), return_index=True, return_counts=True)
    start, count = start[ids >= 0], count[ids >= 0]
    return int(((start + count - 1) // chunk - start // chunk + 1).max()) if count.size else 0


def _bwd_cases(torch, np, rng, in_flight: int) -> list:
    """(idx, g, n_rows, index dtype, misalign elems, what) of phase 2's
    backward cases: random bags (L 1-8, duplicates, padding, empty bags,
    runs of one id cut by many chunks) in bf16 and float32 at D 5, 16, 128
    with int32 ids, and at D 37 and 200 (more than one slab of columns);
    int64 ids at D 5 and 128; bf16 at D 12 (8-byte pieces);
    a batch under one chunk; misaligned gradients (one element off: scalar
    pieces; bf16 four off: 8-byte pieces); and one id in about 96% of the
    positions of a batch sized so that its run spans more chunks than the
    `in_flight` the one-pass grid holds at once, among sparse other ids and
    padding."""
    base = [(1, 1, 10, False), (300, 1, 7, False), (300, 3, 10_000, True), (1000, 8, 50, True),
            (129, 8, 3, True), (2000, 2, 4, True)]
    out = []
    for dt in (torch.bfloat16, torch.float32):
        for d in (5, 16, 128):
            for b, bag_len, n_rows, pad in base:
                idx, g = _bwd_case(torch, np, rng, b, bag_len, n_rows, d, dt, pad)
                out.append((idx, g, n_rows, torch.int32, 0, f"{dt} D={d} B={b} L={bag_len} "
                            f"V={n_rows}"))
                if d in (5, 128) and bag_len > 1:
                    out.append((idx, g, n_rows, torch.int64, 0, f"{dt} D={d} B={b} "
                                f"L={bag_len} V={n_rows} int64"))
        for d in (37, 200):  # more than one slab of 32 or 128 columns
            for b, bag_len, n_rows, pad in base[2:4]:
                idx, g = _bwd_case(torch, np, rng, b, bag_len, n_rows, d, dt, pad)
                out.append((idx, g, n_rows, torch.int32, 0, f"{dt} D={d} B={b} L={bag_len} "
                            f"V={n_rows}"))
        idx, g = _bwd_case(torch, np, rng, 37, 3, 20, 12, dt, True)
        out.append((idx, g, 20, torch.int32, 0, f"{dt} D=12 B=37 L=3 (under one chunk)"))
        for elems in ((1, 4) if dt == torch.bfloat16 else (1,)):
            idx, g = _bwd_case(torch, np, rng, 500, 2, 30, 128, dt, True)
            out.append((idx, g, 30, torch.int32, elems, f"{dt} D=128 misaligned by {elems}"))
    # bags of 2, so many that 95% of the positions fill 64 chunks more than the grid holds
    b = -(-(in_flight + 64) * 256 // 2 * 100 // 95)
    idx = np.full((b, 2), 3)
    other = rng.random(idx.shape)
    idx[other < 0.02] = rng.choice([0, 1, 2, 4, 5, 6, 7], size=int((other < 0.02).sum()))
    idx[(other >= 0.02) & (other < 0.04)] = -1
    g = torch.from_numpy(rng.normal(size=(b, 16)).astype(np.float32)).to(torch.bfloat16)
    out.append((idx, g, 8, torch.int32, 0, f"one id over most of {2 * b} positions, bf16 D=16"))
    return out


def _hold_backward(torch, rows, grads, n_u, s_rows, s_grads, n: int, p_n, p_grads,
                   what: str) -> None:
    """A backward's output against its split twin's (rows and sums bit for
    bit, on the host) and the plain twin's (n_unique; sums within
    EMB_BWD_TOL)."""
    if int(n_u) != n or n != int(p_n) or not torch.equal(rows[:n].cpu(), s_rows[:n]):
        _fail(f"embedding_bag_backward rows differ from the twins at {what}")
    if not torch.equal(grads[:n].cpu(), s_grads[:n]):
        _fail(f"embedding_bag_backward is not its split twin bit for bit at {what}")
    if not _close(torch, grads[:n], p_grads[:n], **EMB_BWD_TOL):
        _fail(f"embedding_bag_backward differs from its twin at {what}")


def check_train_kernels(torch, np, seed: int) -> dict:
    """Phase 2, DLRM training's kernels against their twins on the card.

    ``embedding_bag_backward`` on both routes (the one-pass kernel the
    wrapper launches, and the two-pass kernel with its combine) equals its
    split twin bit for bit (the kernels' order of additions, on the host)
    and the plain twin within EMB_BWD_TOL, sum and mean, on
    :func:`_bwd_cases`, each route counting its own launches; the one-pass
    kernel also at EMB_BWD_OTHER_CHUNKS (and EMB_BWD_OTHER_RINGS where the
    gradient is bf16 in 16-byte pieces) on the skewed case and the first
    random ones; a control (one occurrence's gradient zeroed) must fail.
    ``dot_interaction_backward`` on both routes (:func:`_check_dot_backward`).
    ``sgd_rows`` on registered host buffers (SGD_CASES,
    :func:`_check_sgd_case`): every row of the master and the table equal to
    the twin's bit for bit (the touched rows updated, the others untouched)
    under several launch plans; a control must fail."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.embedding_bag import (BACKWARD_CHUNK, BACKWARD_MAX_CHUNK,
                                                   BackwardPlan, backward_occupancy,
                                                   backward_path, embedding_bag_backward_cuda)

    rng = np.random.default_rng(seed + 20)
    err = {"embedding_bag_backward": 0.0, "embedding_bag_backward_two_pass": 0.0,
           "embedding_bag_backward_combine": 0.0, "sgd_rows": 0.0}
    occ = backward_occupancy()
    n_sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    in_flight = 2 * occ["warps_an_sm"] * n_sms  # chunks a full grid holds: each warp's and the next
    # every instance fits a block at the largest chunk a plan may have
    for dt, it, path, ring in ((torch.float32, torch.int64, "16-byte", 32),
                               (torch.bfloat16, torch.int64, "16-byte", 64),
                               (torch.float32, torch.int64, "scalar", 32)):
        top = backward_occupancy(BackwardPlan(BACKWARD_MAX_CHUNK, ring), dt, it, path)
        if top["blocks_an_sm"] < 1:
            _fail(f"the backward at chunk {BACKWARD_MAX_CHUNK} fits no block: {dt} {it} {path}")
    n_cases, paths, n_plans, span = 0, set(), 0, 0
    for idx, g, n_rows, it, elems, what in _bwd_cases(torch, np, rng, in_flight):
        idx_t = torch.from_numpy(idx).to(DEV, it)
        g_d = _misaligned(torch, g, elems) if elems else g.to(DEV)
        paths.add(backward_path(g_d))
        skew = what.startswith("one id")
        if skew:
            span = _longest_run_chunks(np, idx, BACKWARD_CHUNK)
            if span <= in_flight:
                _fail(f"the skewed backward case's run spans {span} chunks, not more than the "
                      f"{in_flight} the grid holds at once")
        for combiner in ("sum", "mean"):
            s_rows, s_grads, s_n = ref.embedding_bag_backward_split_ref(
                torch.from_numpy(idx), g, combiner, BACKWARD_CHUNK)
            p_rows, p_grads, p_n = ref.embedding_bag_backward_ref(idx_t, g_d, combiner, n_rows)
            n = int(s_n)
            for route, want_launches in EMB_BWD_ROUTES.items():
                before = dict(ops.launch_counts)
                rows, grads, n_u = embedding_bag_backward_cuda(idx_t, g_d, combiner, n_rows,
                                                               two_pass=route == "two_pass")
                launched = {k: ops.launch_counts[k] - before[k] for k in before}
                if {k: v for k, v in launched.items() if v} != want_launches:
                    _fail(f"embedding_bag_backward ({route}) launched {launched} at {what}")
                torch.cuda.synchronize()
                _hold_backward(torch, rows, grads, n_u, s_rows, s_grads, n, p_n, p_grads,
                               f"{route}, {what}, {combiner}")
                name = "embedding_bag_backward" if route == "one_pass" else \
                    "embedding_bag_backward_two_pass"
                if n:
                    err[name] = max(err[name], float((grads[:n] - p_grads[:n]).abs().max()))
                    hit = int(np.flatnonzero((idx >= 0).any(axis=1))[-1])
                    ctrl_g = g.clone()
                    ctrl_g[hit] = 0
                    _, c_grads, _ = ref.embedding_bag_backward_ref(idx_t, ctrl_g.to(DEV),
                                                                   combiner)
                    if _close(torch, grads[:n], c_grads[:n], **EMB_BWD_TOL):
                        _fail(f"the embedding_bag_backward check does not tell the control "
                              f"(bag {hit} dropped) from the twin at {route}, {what}")
                n_cases += 1
            if skew or n_cases <= 8:
                rings = EMB_BWD_OTHER_RINGS if (g.dtype == torch.bfloat16
                                                and backward_path(g_d) == "16-byte") else ()
                for text in EMB_BWD_OTHER_CHUNKS + rings:
                    chunk, ring = (int(x) for x in text.split(":"))
                    rows, grads, n_u = embedding_bag_backward_cuda(
                        idx_t, g_d, combiner, n_rows, plan=BackwardPlan(chunk, ring))
                    c_rows, c_grads, _ = ref.embedding_bag_backward_split_ref(
                        torch.from_numpy(idx), g, combiner, chunk)
                    torch.cuda.synchronize()
                    _hold_backward(torch, rows, grads, n_u, c_rows, c_grads, n, p_n, p_grads,
                                   f"plan {text}, {what}, {combiner}")
                    n_plans += 1
    if paths != {"16-byte", "8-byte", "scalar"}:
        _fail(f"the backward cases took the paths {paths}, not all three")
    print(f"embedding_bag_backward (one pass) and its two-pass route vs split twin (bit for "
          f"bit) and plain twin: cases={n_cases} (routes x combiners) + {n_plans} at plans "
          f"{EMB_BWD_OTHER_CHUNKS + EMB_BWD_OTHER_RINGS}; paths {sorted(paths)}; one id's run "
          f"over {span} chunks "
          f"(the grid holds {in_flight} at once: {occ}); max_abs_err one pass "
          f"{err['embedding_bag_backward']}, two pass {err['embedding_bag_backward_two_pass']} "
          f"tol={EMB_BWD_TOL}; controls fail")
    err["embedding_bag_backward_combine"] = err["embedding_bag_backward_two_pass"]

    err["dot_interaction_backward"], err["dot_interaction_backward_simt"] = \
        _check_dot_backward(torch, np, rng)

    n_sgd = 0
    for case in SGD_CASES:
        n_sgd += _check_sgd_case(torch, np, rng, *case)
    print(f"sgd_rows vs twin on registered host memory: cases={len(SGD_CASES)} launches={n_sgd} "
          f"(the wrapper's plan; on bfloat16 D=128 every instance of rows a warp, persistent "
          f"and one warp a group), every row bit for bit; controls fail")
    return err


DOT_BWD_ROUTES = ("dot_interaction_backward", "dot_interaction_backward_simt")  # TC, SIMT
DOT_BWD_MORE_F = (2, 40, 64, 70)  # the tensor-core backward's other instances: 3, 4, any m-tiles


def _dot_bwd_cases(torch):
    """(dtype, F, D, B, misaligned) of phase 2's backward cases: both types
    at F 27 and 13, D 16 and 128, B 1, 129 and 4,097; bf16 at D = 24 (the
    SIMT route); bf16 at DOT_BWD_MORE_F; misaligned bf16 fields."""
    cases = [(dt, f, d, b, False) for dt in (torch.bfloat16, torch.float32) for f in (27, 13)
             for d in (16, 128) for b in (1, 129, 4097)]
    cases += [(torch.bfloat16, f, 24, b, False) for f in (27, 13) for b in (1, 129, 4097)]
    cases += [(torch.bfloat16, f, d, 129, False) for f in DOT_BWD_MORE_F for d in (16, 128)]
    return cases + [(torch.bfloat16, 27, 128, 129, True)]


def _check_dot_backward(torch, np, rng) -> tuple:
    """``dot_interaction_backward`` on the card against its twins, each case
    on the route ``backward_uses_tensor_cores`` picks (tensor cores: bf16,
    D % 16 == 0, 16-byte aligned; else SIMT), which must be the one its
    type, width and alignment call for and must count one launch under its
    own name and none under the other's. Both routes within DOT_BWD_TOL of
    the plain twin, the tensor cores also of the tiling twin; a control
    (the last field row zeroed) must fail. On the tensor cores, also the
    split's control: on ``ref.split_decisive_case`` (dX depends on the lo
    term alone) the kernel within DOT_BWD_TOL of the plain twin and the
    tiling twin without lo outside it. Returns each route's max abs error."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dot_interaction import (backward_uses_tensor_cores,
                                                     dot_interaction_backward_cuda)

    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    err = dict.fromkeys(DOT_BWD_ROUTES, 0.0)
    n_by_route, n_split = dict.fromkeys(DOT_BWD_ROUTES, 0), 0
    for dt, f, d, b, misaligned in _dot_bwd_cases(torch):
        tol = DOT_BWD_TOL[str(dt).split(".")[-1]]
        x = torch.from_numpy(rng.normal(size=(b, f, d)).astype(np.float32)).to(DEV, dt)
        dz = torch.from_numpy(rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)).to(DEV)
        if misaligned:
            x = torch.empty(1 + x.numel(), dtype=dt, device=DEV)[1:].view(b, f, d).copy_(x)
        what = f"{dt} F={f} D={d} B={b}{' misaligned' if misaligned else ''}"
        tc = dt == torch.bfloat16 and d % 16 == 0 and not misaligned
        route = DOT_BWD_ROUTES[0 if tc else 1]
        if backward_uses_tensor_cores(x, dz) != tc:
            _fail(f"dot_interaction_backward dispatch at {what}")
        before = {k: ops.launch_counts[k] for k in DOT_BWD_ROUTES}
        got = dot_interaction_backward_cuda(x, dz)
        launched = {k: ops.launch_counts[k] - before[k] for k in DOT_BWD_ROUTES}
        if launched != {k: int(k == route) for k in DOT_BWD_ROUTES}:
            _fail(f"dot_interaction_backward at {what} launched {launched}, not one {route}")
        twins = [ref.dot_interaction_backward_ref(x, dz)]
        if tc:
            twins.append(ref.dot_interaction_backward_tc_ref(x, dz))
        ctrl_x = x.clone()
        ctrl_x[:, -1] = 0
        ctrl = ref.dot_interaction_backward_ref(ctrl_x, dz)
        torch.cuda.synchronize()
        if got.dtype != dt or got.shape != x.shape or not all(
                _close(torch, got, w, **tol) for w in twins):
            _fail(f"dot_interaction_backward ({route}) differs from its twins at {what}")
        if _close(torch, got, ctrl, **tol):
            _fail(f"the dot_interaction_backward check does not tell the control (last field "
                  f"row zeroed) from the twin at {what}")
        err[route] = max(err[route], float((got.float() - twins[0].float()).abs().max()))
        n_by_route[route] += 1
        if tc and f >= 3:
            xd, dzd = ref.split_decisive_case(b, f, d, gen)
            xd, dzd = xd.to(DEV), dzd.to(DEV)
            got_d = dot_interaction_backward_cuda(xd, dzd)
            want_d = ref.dot_interaction_backward_ref(xd, dzd)
            no_lo = ref.dot_interaction_backward_tc_ref(xd, dzd, terms=2)
            torch.cuda.synchronize()
            if not _close(torch, got_d, want_d, **tol):
                _fail(f"dot_interaction_backward differs from its twin where the split's lo "
                      f"term decides, at {what}")
            if _close(torch, no_lo, want_d, **tol) or _close(torch, got_d, no_lo, **tol):
                _fail(f"the dot_interaction_backward check does not tell the control (the "
                      f"split without lo) from the twin at {what}")
            err[route] = max(err[route], float((got_d.float() - want_d.float()).abs().max()))
            n_split += 1
    print(f"dot_interaction_backward vs twins (plain; tensor cores also the tiling twin): "
          f"cases by route {n_by_route}, split-decisive cases {n_split}, max_abs_err {err} "
          f"tol={DOT_BWD_TOL}; each case counted on its own route; controls (last field row "
          f"zeroed; the split without lo) fail")
    return err[DOT_BWD_ROUTES[0]], err[DOT_BWD_ROUTES[1]]


# sgd_rows' phase-2 cases: (dtype, D, V, n_unique, cap, host backing); the
# first three were the kernel's before its redesign; then n_unique 0 and 1,
# not a multiple of any R > 1, equal to cap, persistent grids that stride
# many times (700,000 slots: 42 strides on the wrapper's grid, 663, 332,
# 166 and 83 at 1, 2, 4 and 8 rows a warp on one block an SM, on 132 SMs;
# the check requires at least 2), and the huge-page backing
SGD_CASES = (("bfloat16", 128, 1000, 300, 400, "plain"), ("float32", 16, 1000, 300, 400, "plain"),
             ("bfloat16", 5, 1000, 300, 400, "plain"), ("bfloat16", 128, 1000, 0, 400, "plain"),
             ("bfloat16", 128, 1000, 1, 400, "plain"), ("bfloat16", 128, 1000, 301, 400, "plain"),
             ("float32", 5, 1000, 299, 400, "plain"), ("bfloat16", 128, 1000, 400, 400, "plain"),
             ("bfloat16", 128, 2_000_000, 700_000, 800_000, "huge"),
             ("float32", 128, 5000, 777, 1000, "huge"))


def _check_sgd_case(torch, np, rng, dt_name, d, v, n, cap, backing) -> int:
    """One phase-2 case of ``sgd_rows``: distinct sorted rows, gradients of
    40 x N(0, 1) (slots past n NaN, at rows past V: never read), lr 0.05,
    clip 0.3, on a master of ``backing`` registered with the card. Under the
    wrapper's own plan and, where the source has the sweep's instances (a
    bfloat16 table of D % 4 == 0), one warp a group at R = 1 and each R at
    one block an SM, every row of the master and the table equals
    ``sgd_rows_ref``'s bit for bit; the control (clip left out; with n = 0,
    every slot up to cap updated) must differ. A case of more than 100,000
    slots must make every persistent grid stride at least twice. Returns
    the launches."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.embedding_bag import (SGD_BLOCKS_AN_SM, SGD_R, SGD_ROWS_PER_WARP,
                                                   host_empty, register_host, sgd_rows_cuda,
                                                   sgd_rows_plan, unregister_host)

    dt = getattr(torch, dt_name)
    orig = host_empty((v, d), backing)
    orig.copy_(torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)))
    rows = torch.full((cap,), 10**9, dtype=torch.int64)  # slots past n: never read
    live = torch.from_numpy(np.sort(rng.choice(v, cap, replace=False)))
    rows[:n] = live[:n]
    grads = torch.full((cap, d), float("nan"))
    grads[:n] = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) * 40
    args = [t.to(DEV) for t in (rows, grads, torch.tensor(n), torch.tensor(0.05),
                                torch.tensor(0.3))]
    want_m, want_t = orig.clone(), orig.to(DEV, dt, copy=True)
    ref.sgd_rows_ref(want_m, want_t, *args)
    ctrl_m, ctrl_t = orig.clone(), orig.to(DEV, dt, copy=True)
    if n:
        ref.sgd_rows_ref(ctrl_m, ctrl_t, *args[:4], torch.tensor(1.0, device=DEV))
    else:  # a kernel that ignored n_unique would update every slot it was given
        full = [t.to(DEV) for t in (live, torch.ones(cap, d))]
        ref.sgd_rows_ref(ctrl_m, ctrl_t, *full, torch.tensor(cap, device=DEV), *args[3:])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = [None]  # the wrapper's: SGD_R rows a warp, SGD_BLOCKS_AN_SM[SGD_R] blocks an SM
    persistent = [sgd_rows_plan(cap, SGD_R, n_sms * SGD_BLOCKS_AN_SM[SGD_R])]
    if dt_name == "bfloat16" and d % 4 == 0:
        persistent += [sgd_rows_plan(cap, r, n_sms) for r in SGD_ROWS_PER_WARP]
        if cap > 100_000 and min(p.strides(n) for p in persistent) < 2:
            _fail(f"sgd_rows case cap={cap} n_unique={n}: a persistent grid strides "
                  f"{[p.strides(n) for p in persistent]} times, fewer than 2")
        plans += [sgd_rows_plan(cap, 1)] + persistent[1:]
    what = f"{dt_name} D={d} V={v} n_unique={n} cap={cap} {backing}"
    master = host_empty((v, d), backing)
    reg_s = register_host(master)
    try:
        for plan in plans:
            master.copy_(orig)
            table = orig.to(DEV, dt, copy=True)
            before = ops.launch_counts["sgd_rows"]
            sgd_rows_cuda(master, table, *args, plan=plan)
            torch.cuda.synchronize()
            if ops.launch_counts["sgd_rows"] != before + 1:
                _fail("sgd_rows did not count its launch")
            if not (torch.equal(master, want_m) and torch.equal(table, want_t)):
                _fail(f"sgd_rows differs from its twin at {what} under {plan}")
            if torch.equal(master, ctrl_m):
                _fail(f"the sgd_rows check does not tell the control at {what}")
    finally:
        unregister_host(master)
    strides = [p.strides(n) for p in persistent]
    print(f"sgd_rows {what}: {len(plans)} plans bit for bit, strides {strides} (registered "
          f"in {reg_s:.6f} s)")
    return len(plans)


def _train_counts(counts: dict) -> dict:
    """The train step's launch counts; fail unless each kernel of the path
    ran exactly once and the SIMT interaction, forward or backward, never."""
    want = {"embedding_bag": 1, "dot_interaction": 1, "dot_interaction_simt": 0,
            "dot_interaction_backward": 1, "dot_interaction_backward_simt": 0,
            "embedding_bag_backward": 1, "embedding_bag_backward_two_pass": 0,
            "embedding_bag_backward_combine": 0, "sgd_rows": 1}
    got = {k: counts[k] for k in want}
    print(f"launches in one train_batch step (dlrm train): {got}")
    if got != want:
        _fail(f"the train_batch step launched {got}, not {want}")
    return got


def _mlp_state(model, opt_state) -> dict:
    keys = [k for k in model.leaves() if k != "tables"]
    return {"p": {k: model.leaves()[k].detach().clone() for k in keys},
            **{n: {k: opt_state[n][k].clone() for k in keys} for n in ("master", "m", "v")},
            "step": opt_state["step"].clone()}


def _set_mlp_state(torch, model, opt_state, snap) -> None:
    with torch.no_grad():
        for k, p in model.leaves().items():
            if k != "tables":
                p.copy_(snap["p"][k])
                for n in ("master", "m", "v"):
                    opt_state[n][k].copy_(snap[n][k])
        opt_state["step"].copy_(snap["step"])


def _one_step(torch, model, opt_state, batch, opt_cfg, touched, touched_d) -> dict:
    """One train step through ops as they stand: the loss, metrics, the
    lookup's gradient (the backward's input), the compact gradient, and the
    touched rows and MLP leaves after it."""
    from repro_torch.kernels import ops
    from repro_torch.models.dlrm import dlrm_grads
    from repro_torch.train.optimizer import adamw_update

    seen, real, real_dot = {}, ops.embedding_bag_backward, ops.dot_interaction_backward

    def record(indices, grad_out, *rest):
        seen["g_emb"] = grad_out
        return real(indices, grad_out, *rest)

    def record_dot(x, dz):
        seen["x"], seen["dz"] = x, dz
        return real_dot(x, dz)

    ops.embedding_bag_backward, ops.dot_interaction_backward = record, record_dot
    try:
        loss, grads = dlrm_grads(model, *batch)
    finally:
        ops.embedding_bag_backward, ops.dot_interaction_backward = real, real_dot
    met = adamw_update(model.leaves(), grads, opt_state, opt_cfg)
    torch.cuda.synchronize()
    g = grads["tables"]
    n = int(g.n_unique)
    return {"loss": float(loss), "lr": met["lr"].clone(), "grad_norm": met["grad_norm"].clone(),
            "n": n, "rows": g.rows[:n].clone(), "grads": g.grads[:n].clone(),
            "g_emb": seen["g_emb"], "dz": seen["dz"], "x": seen["x"],
            "master": model.master[touched], "table": model.table[touched_d].clone(),
            "mlp": {k: p.detach().clone() for k, p in model.leaves().items() if k != "tables"}}


def _hold_train_step(torch, np, model, opt_state, batch, opt_cfg, seed: int) -> dict:
    """The full-size step against the same step through the twins, from one
    snapshot: loss, lr and grad_norm, the compact gradient (every entry
    within :func:`_grad_bound`, which 26 planted faults must break), the
    touched rows' master and bf16 values and the MLP leaves; the kernel
    step's master rows equal ``sgd_rows_ref`` on the snapshot and its own
    gradient bit for bit, and how many entries that step moved;
    :func:`_hold_sgd_rows` on its gradient; a sample of untouched rows
    unchanged bit for bit."""
    from repro_torch.kernels import ref

    dense, sparse, labels = batch
    touched_d = torch.unique((sparse + model.row_offsets).reshape(-1)).to(torch.int64)
    touched = touched_d.cpu()
    n_rows = model.table.shape[0]
    rng = np.random.default_rng(seed + 30)
    cand = rng.integers(0, n_rows, UNTOUCHED_SAMPLE * 2)
    far = np.setdiff1d(cand, touched.numpy())[:UNTOUCHED_SAMPLE]
    far_t = torch.from_numpy(far)
    far_d = far_t.to(DEV)
    snap_master, snap_table = model.master[touched], model.table[touched_d].clone()
    far_master, far_table = model.master[far_t], model.table[far_d].clone()
    mlp = _mlp_state(model, opt_state)

    kern = _one_step(torch, model, opt_state, batch, opt_cfg, touched, touched_d)
    # the kernel step's rows: sgd_rows_ref on the snapshot with its own gradient
    clip = torch.clamp(opt_cfg.grad_clip / (kern["grad_norm"] + 1e-9), max=1.0)
    want_m, want_t = snap_master.to(DEV, copy=True), snap_table.clone()
    local = torch.arange(kern["n"], device=DEV)
    ref.sgd_rows_ref(want_m, want_t, local, kern["grads"], torch.tensor(kern["n"], device=DEV),
                     kern["lr"], clip)
    if not (torch.equal(kern["master"], want_m.cpu()) and torch.equal(kern["table"], want_t)):
        _fail("the train step's master or table rows are not sgd_rows_ref of its gradient")
    # back to the snapshot, then the twin path
    model.master[touched] = snap_master
    model.table[touched_d] = snap_table
    _set_mlp_state(torch, model, opt_state, mlp)
    with _Twins():
        twin = _one_step(torch, model, opt_state, batch, opt_cfg, touched, touched_d)
    res = {"n_unique": kern["n"], "touched": int(touched.numel())}
    for k in ("lr", "grad_norm"):
        res[k] = (float(kern[k]), float(twin[k]))
    res["loss"] = (kern["loss"], twin["loss"])
    for k in ("loss", "lr", "grad_norm"):
        a, b = res[k]
        if not abs(a - b) <= STEP_RTOL * abs(b):
            _fail(f"train step {k}: kernel path {a} against twin path {b}")
    if kern["n"] != twin["n"] or kern["n"] != touched.numel() \
            or not torch.equal(kern["rows"], twin["rows"]) \
            or not torch.equal(kern["rows"], touched_d):
        _fail("the train step's compact gradient rows differ from the twin path's")
    # the kernels on the kernel path's own input: float32 summation order only
    bags = (sparse + model.row_offsets).reshape(-1, 1)
    _, own, _ = ref.embedding_bag_backward_ref(bags, kern["g_emb"], "sum")
    res["grads_vs_twin_same_input"] = float((kern["grads"] - own[:kern["n"]]).abs().max())
    if not _close(torch, kern["grads"], own[:kern["n"]], **EMB_BWD_TOL):
        _fail(f"the train step's compact gradient differs from the twin of its own input by "
              f"{res['grads_vs_twin_same_input']}")
    # the twin path's, which reaches the kernels through other inputs: the
    # forward's interaction sums in another order, so dz differs (and where a
    # ReLU input of the top MLP lies within float32 noise of 0, opens in one
    # path only), G X can cancel below that difference, and each path rounds
    # the lookup's gradient to bf16. Every row is held to the bound that
    # follows from these alone (_grad_bound); 26 planted faults, a field's
    # gradient dropped, must each break it, and the norm reading is kept
    # beside theirs
    n = kern["n"]
    with torch.no_grad():
        bound, why = _grad_bound(torch, ref, bags, kern, twin, n)
        diff = (kern["grads"] - twin["grads"]).abs()
        res["grads_max_abs_err"] = float(diff.max())
        res["grads_max_abs"] = float(twin["grads"].abs().max())
        res["grads_rel_norm_err"] = _rel_norm(torch, kern["grads"], twin["grads"])
        res["grads_rows_past_bound"] = int((diff > bound).any(dim=1).sum())
        res["grads_worst_share_of_bound"] = float((diff / bound.clamp(min=1e-38)).max())
        res.update(why)
        res["faults"] = _planted_faults(torch, ref, bags, kern["g_emb"], twin["grads"], bound, n)
    shown = {k: v for k, v in res.items() if k not in ("lr", "grad_norm", "loss")}
    print(f"train_batch compact gradient, kernel path vs twin path: {shown}")
    if res["grads_rows_past_bound"]:
        _fail(f"{res['grads_rows_past_bound']} rows of the train step's compact gradient differ "
              f"from the twin path's past what the paths' inputs explain")
    if not res["grads_rel_norm_err"] <= GRAD_PATH_RTOL:
        _fail(f"the train step's compact gradient differs from the twin path's by "
              f"{res['grads_rel_norm_err']} in norm (at most {GRAD_PATH_RTOL})")
    if res["faults"]["caught_by_bound"] != res["faults"]["planted"]:
        _fail(f"the gradient's bound check misses planted faults: {res['faults']}")
    del own, diff, bound
    moved = kern["master"] != snap_master
    res["held_step_master_entries_changed"] = int(moved.sum())
    res["held_step_master_rows_changed"] = int(moved.any(dim=1).sum())
    del moved
    res["sgd_rows_at_check_lr"] = _hold_sgd_rows(torch, model, kern["rows"], kern["grads"],
                                                 touched, touched_d)
    for k in ("g_emb", "dz", "x"):
        kern.pop(k), twin.pop(k)
    res["master_max_abs_err"] = float((kern["master"] - twin["master"]).abs().max())
    if res["master_max_abs_err"] > MASTER_ATOL:
        _fail(f"the touched master rows differ from the twin path's by "
              f"{res['master_max_abs_err']} (atol {MASTER_ATOL})")
    tk, tt = kern["table"].float(), twin["table"].float()
    if not bool(((tk - tt).abs() <= 2.0 ** -8 * tt.abs()).all()):
        _fail(f"the touched table rows differ from the twin path's by more than one bf16 "
              f"step: max abs {float((tk - tt).abs().max())}")
    res["table_rows_differing"] = int((tk != tt).any(dim=1).sum())
    lr = float(kern["lr"])
    res["mlp_max_abs_err"] = max(float((kern["mlp"][k] - twin["mlp"][k]).abs().max())
                                 for k in kern["mlp"])
    if res["mlp_max_abs_err"] > 2 * lr:
        _fail(f"the MLP leaves differ from the twin path's by {res['mlp_max_abs_err']}")
    if not (torch.equal(model.master[far_t], far_master)
            and torch.equal(model.table[far_d], far_table)):
        _fail("an untouched row moved")
    if not np.isfinite(kern["loss"]):
        _fail("the train step's loss is not finite")
    print(f"train_batch step kernel path vs twin path: {res} (tolerances: loss, lr, grad_norm "
          f"rtol {STEP_RTOL}; gradient on the same input {EMB_BWD_TOL}, against the twin "
          f"path's every row within its bound and {GRAD_PATH_RTOL} in norm; master atol "
          f"{MASTER_ATOL}; table one "
          f"bf16 step; MLP 2 lr = {2 * lr}); the kernel step's rows equal sgd_rows_ref of "
          f"its gradient bit for bit; {far.size} untouched rows unchanged bit for bit")
    return res


def _rel_norm(torch, got, want) -> float:
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def _grad_bound(torch, ref, bags, kern, twin, n: int) -> tuple:
    """Per entry of the compact gradient's first n rows, how far the kernel
    path's may lie from the twin path's given only what feeds the two
    backward passes, summed over the row's occurrences: a sample's largest
    dz difference e_b times the sum of |X| over the other fields (dX_i =
    sum_j dz_ij X_j), max|dz_b| times the sum of the fields' own
    differences, float32 sums of 27 terms in each path (27 u max|dz_b| sum
    |X|), each path's bf16 rounding of dX (BF16_HALF_STEP of |g|), and the
    two row sums' float32 order (m u sum|g| for a row of m occurrences).
    Returns the bound and its inputs' readings."""
    x_k, x_t = kern["x"].float(), twin["x"].float()
    dz_k, dz_t = kern["dz"], twin["dz"]
    e = (dz_k - dz_t).abs().amax(dim=1)
    top = torch.maximum(dz_k.abs().amax(dim=1), dz_t.abs().amax(dim=1))
    ax = x_k.abs()
    per = (e + 2 * 27 * F32_EPS * top)[:, None, None] * (ax.sum(dim=1, keepdim=True) - ax)
    per += top[:, None, None] * (x_k - x_t).abs().sum(dim=1, keepdim=True)
    g_k, g_t = kern["g_emb"].float().abs(), twin["g_emb"].float().abs()
    per = per[:, 1:].reshape(g_k.shape) + BF16_HALF_STEP * (1 + 2.0 ** -7) * (g_k + g_t)
    del ax
    _, bound, _ = ref.embedding_bag_backward_ref(bags, per, "sum")
    _, mag, _ = ref.embedding_bag_backward_ref(bags, g_k + g_t, "sum")
    _, occ = torch.unique(bags.reshape(-1), return_counts=True)
    bound = bound[:n] + occ[:, None] * F32_EPS * mag[:n]
    why = {"fields_max_abs_diff": float((x_k - x_t).abs().max()),
           "dz_max_abs_diff": float(e.max()),
           "samples_dz_diverged": int((e > DZ_DIVERGED * top).sum()),
           "most_occurrences_of_a_row": int(occ.max())}
    return bound, why


def _planted_faults(torch, ref, bags, g_emb, want, bound, n: int) -> dict:
    """The bound and norm checks on the kernel path's own gradient with
    one field's part of the lookup's gradient dropped, for each of the 26
    fields: how many the bound catches and the norm readings."""
    b = g_emb.shape[0] // 26
    norms, caught = [], 0
    for f in range(26):
        g = g_emb.view(b, 26, -1).clone()
        g[:, f] = 0
        _, got, _ = ref.embedding_bag_backward_ref(bags, g.view_as(g_emb), "sum")
        caught += bool(((got[:n] - want).abs() > bound).any())
        norms.append(_rel_norm(torch, got[:n], want))
        del g, got
    return {"planted": 26, "caught_by_bound": caught,
            "caught_by_norm": sum(x > GRAD_PATH_RTOL for x in norms),
            "rel_norm_min": min(norms), "rel_norm_max": max(norms)}


def _hold_sgd_rows(torch, model, rows, grads, touched, touched_d) -> dict:
    """``sgd_rows`` at the train_batch shapes: the step's own compact
    gradient on the model's registered master and its table, at lr
    SGD_CHECK_LR and clip SGD_CHECK_CLIP (the held step's lr moves few
    master entries); the touched rows' master and table equal
    ``sgd_rows_ref`` on a snapshot bit for bit, at least SGD_MOVED_SHARE of
    them moved, and a control (clip left out) must differ. The rows are put
    back afterwards."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import sgd_rows_cuda

    n = rows.numel()
    snap_m, snap_t = model.master[touched], model.table[touched_d].clone()
    n_t = torch.tensor(n, device=DEV)
    lr, clip = (torch.tensor(v, device=DEV) for v in (SGD_CHECK_LR, SGD_CHECK_CLIP))
    local = torch.arange(n, device=DEV)
    want_m, want_t = snap_m.to(DEV, copy=True), snap_t.clone()
    ref.sgd_rows_ref(want_m, want_t, local, grads, n_t, lr, clip)
    ctrl_m, ctrl_t = snap_m.to(DEV, copy=True), snap_t.clone()
    ref.sgd_rows_ref(ctrl_m, ctrl_t, local, grads, n_t, lr, torch.ones((), device=DEV))
    sgd_rows_cuda(model.master, model.table, rows, grads, n_t, lr, clip)
    torch.cuda.synchronize()
    got_m, got_t = model.master[touched], model.table[touched_d].clone()
    model.master[touched] = snap_m
    model.table[touched_d] = snap_t
    moved = got_m != snap_m
    res = {"lr": SGD_CHECK_LR, "clip": SGD_CHECK_CLIP, "rows": n,
           "largest_row": int(rows.max()), "master_entries_changed": int(moved.sum()),
           "master_rows_changed": int(moved.any(dim=1).sum()),
           "table_rows_changed": int((got_t != snap_t).any(dim=1).sum()),
           "control_rows_differing": int((got_m != ctrl_m.cpu()).any(dim=1).sum())}
    print(f"sgd_rows at train_batch shapes on the model's master: {res}")
    if not (torch.equal(got_m, want_m.cpu()) and torch.equal(got_t, want_t)):
        _fail("sgd_rows at train_batch shapes is not sgd_rows_ref bit for bit")
    if res["master_rows_changed"] < SGD_MOVED_SHARE * n:
        _fail(f"sgd_rows moved {res['master_rows_changed']} of {n} touched rows: the check "
              f"cannot tell a kernel that skips the update")
    if torch.equal(got_m, ctrl_m.cpu()):
        _fail("the sgd_rows check does not tell the control (clip left out) at train_batch "
              "shapes")
    return res


def _train_inputs(torch, model, batch) -> dict:
    """The inputs the train step gives each new kernel: the lookup's bags
    and gradient, the fields and the interaction's gradient."""
    from repro_torch.kernels import ops
    from repro_torch.models.dlrm import dlrm_loss, logit_loss

    dense, sparse, labels = batch
    loss, look = dlrm_loss(model, dense, sparse, labels)
    (g_emb,) = torch.autograd.grad(loss, [look.emb])
    x_bot, fields = model.fields(dense, sparse)
    inter = ops.dot_interaction(fields).requires_grad_()
    logits = model.top(torch.cat([x_bot, inter], dim=1))[:, 0]
    (dz,) = torch.autograd.grad(logit_loss(logits, labels), [inter])
    return {"bags": look.bags, "g_emb": g_emb.contiguous(), "fields": fields,
            "dz": dz.contiguous()}


def _row(name, src, replaces, launches, err, ms, plain_ms, nbytes, nops, rate, library_ms,
         link_bytes: int = 0, **extra) -> dict:
    """A kernel row: bound_ms the largest of its device bytes at
    HBM_BYTES_PER_S, its bytes over the host link each way at
    PCIE_BYTES_PER_S (link_bytes, the larger direction) and its operations
    at rate."""
    t_bytes = max(nbytes / HBM_BYTES_PER_S, link_bytes / PCIE_BYTES_PER_S) * 1e3
    t_ops = nops / rate * 1e3
    row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
           "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
           else "operations", "library_ms": library_ms, "bytes": nbytes, "ops": nops, **extra}
    print(f"kernel {name} ms={ms:.6f} plain_ms={plain_ms:.6f} bound_ms={row['bound_ms']:.6f} "
          f"({row['bound_by']}, {nbytes} B, {nops} ops) library_ms={library_ms} "
          f"launches={launches} max_abs_err={err} {extra}")
    return row


EMB_BWD_PLANS = ("256:32", "256:16", "256:64", "128:32", "512:32")  # phase 4's sweep


def _emb_bwd_rows(torch, np, bags, g_emb, n_rows: int, errs: dict, counts: dict) -> list:
    """Phase 4's rows for ``embedding_bag_backward`` on the train step's own
    bags and lookup gradient. The one-pass kernel held bit for bit against
    its split twin (on the host) and within EMB_BWD_TOL against the plain
    twin, the two-pass route within EMB_BWD_TOL, its combine against its
    twin on the kernel's own pieces (no atomics: bit for bit). Then, by CUDA
    events in turns: the one-pass wrapper (sort, fill, kernel), the
    two-pass wrapper, the sort alone, the one-pass kernel on ids sorted
    beforehand (its fill included), ``index_add_`` after ``torch.unique``
    and the gather ``g.index_select(0, perm)`` (the card's rate for these
    rows in PyTorch); each wrapper's device time by kernel (profiler); the
    one-pass kernel's device time three ways (the profiler over 10 calls,
    the events on sorted ids, and the traced step of phase 6b, added there);
    a sweep of its plan (chunk, ring) with what the card fits of each and
    the share of the bound. The bound is the bytes the function needs: the
    gradient rows read once, 4 or 8 + 8 bytes of sorted id and order a
    position, each distinct row's 512 + 8 bytes written once. Beside it
    are PR 20's bound (8 more bytes a position, for the slot array that the
    one-pass kernel no longer reads) and the bytes the one-pass kernel
    moves (each cut run's pieces written and read once)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import (BACKWARD_CHUNK, BackwardPlan,
                                                   backward_occupancy,
                                                   embedding_bag_backward_combine_cuda,
                                                   embedding_bag_backward_cuda,
                                                   embedding_bag_backward_pieces_cuda,
                                                   embedding_bag_backward_sorted_cuda)

    d = g_emb.shape[1]
    one = lambda: embedding_bag_backward_cuda(bags, g_emb, "sum", n_rows)  # noqa: E731
    two = lambda: embedding_bag_backward_cuda(bags, g_emb, "sum", n_rows,  # noqa: E731
                                              two_pass=True)
    twin = lambda: ref.embedding_bag_backward_ref(bags, g_emb, "sum", n_rows)  # noqa: E731
    p_rows, p_grads, p_n = twin()
    rows, grads, n_u = one()
    t_rows, t_grads, t_n = two()
    torch.cuda.synchronize()
    n = int(p_n)
    if not (int(n_u) == int(t_n) == n and torch.equal(rows[:n], p_rows[:n])
            and torch.equal(t_rows[:n], p_rows[:n])
            and _close(torch, grads[:n], p_grads[:n], **EMB_BWD_TOL)
            and _close(torch, t_grads[:n], p_grads[:n], **EMB_BWD_TOL)):
        _fail("embedding_bag_backward (a route) differs from its twin at train_batch shapes")
    s_rows, s_grads, s_n = ref.embedding_bag_backward_split_ref(bags, g_emb, "sum",
                                                                BACKWARD_CHUNK)
    if int(s_n) != n or not (torch.equal(rows[:n], s_rows[:n])
                             and torch.equal(grads[:n], s_grads[:n])):
        _fail("the one-pass embedding_bag_backward is not its split twin bit for bit at "
              "train_batch shapes")
    del s_rows, s_grads
    errs["embedding_bag_backward"] = max(errs["embedding_bag_backward"], float(
        (grads[:n] - p_grads[:n]).abs().max()))
    errs["embedding_bag_backward_two_pass"] = max(errs["embedding_bag_backward_two_pass"], float(
        (t_grads[:n] - p_grads[:n]).abs().max()))
    # the combine against its twin on the two-pass kernel's own pieces: both
    # add a cut run's pieces in chunk order, so bit for bit
    _, c_grads, _, pieces = embedding_bag_backward_pieces_cuda(bags, g_emb, "sum", n_rows)
    c_kern, c_twin = c_grads.clone(), c_grads.clone()
    embedding_bag_backward_combine_cuda(*pieces, c_kern)
    ref.embedding_bag_backward_combine_ref(*pieces, c_twin)
    if not torch.equal(c_kern[:n], c_twin[:n]):
        _fail("embedding_bag_backward_combine differs from its twin at train_batch shapes")
    errs["embedding_bag_backward_combine"] = float((c_kern[:n] - c_twin[:n]).abs().max())
    n_cut = int((pieces[2] >= 0).sum())
    n_cont = int((pieces[3] > 0).sum())
    del rows, grads, t_rows, t_grads, c_grads, c_twin, p_rows
    flat = bags.reshape(-1)
    ids, perm = torch.sort(flat, stable=True)
    uniq, inverse = torch.unique(flat, return_inverse=True)
    lib = lambda: torch.zeros((uniq.numel(), d), device=DEV).index_add_(  # noqa: E731
        0, inverse, g_emb.float())
    if not _close(torch, lib(), p_grads[:n], **EMB_BWD_TOL):
        _fail("the index_add_ yardstick is not the backward's function")
    del p_grads
    fns = {"one_pass": one, "two_pass": two,
           "sort": lambda: torch.sort(flat, stable=True),
           "one_pass_sorted": lambda: embedding_bag_backward_sorted_cuda(ids, perm, g_emb, 1,
                                                                         None, n_rows),
           "index_add": lib, "index_select": lambda: g_emb.index_select(0, perm)}
    ms = {k: [] for k in fns}
    for name in list(fns) + list(reversed(fns)):
        ms[name].append(_time_ms(torch, fns[name], 20))
    best = {k: min(v) for k, v in ms.items()}
    plain = min(_time_ms(torch, twin, 3), _time_ms(torch, twin, 3))
    parts = {"one_pass": _device_parts(torch, one, 10), "two_pass": _device_parts(torch, two, 10)}
    dev_one, dev_two = _kernel_device_ms(torch, one, 10), _kernel_device_ms(torch, two, 10)
    kernel_dev = sum(v for k, v in dev_one.items() if "backward_kernel" in k)
    occupancy = {"one_pass": backward_occupancy(), "two_pass": backward_occupancy(
        two_pass=True)}
    n_pos = flat.numel()
    bwd_bytes = (g_emb.numel() * g_emb.element_size() + n_pos * (flat.element_size() + 8)
                 + n * (d * 4 + 8))
    pr20_bytes = bwd_bytes + n_pos * 8  # and the int64 slot of each position
    moved = bwd_bytes + (2 * n_cut + n_cont) * d * 4
    bound_ms = bwd_bytes / HBM_BYTES_PER_S * 1e3
    bound_pr20 = {"bound_ms_pr20": pr20_bytes / HBM_BYTES_PER_S * 1e3, "bytes_pr20": pr20_bytes}
    sweep = {}
    ref_at = {}
    for text in EMB_BWD_PLANS:
        chunk, ring = (int(x) for x in text.split(":"))
        plan = BackwardPlan(chunk, ring)
        fn = lambda p=plan: embedding_bag_backward_sorted_cuda(ids, perm, g_emb, 1,  # noqa: E731
                                                               None, n_rows, p)
        got = fn()[1][:n]
        if chunk in ref_at and not torch.equal(got, ref_at[chunk]):
            _fail(f"embedding_bag_backward's sums depend on its ring ({text})")
        ref_at.setdefault(chunk, got.clone())
        t = min(_time_ms(torch, fn, 20), _time_ms(torch, fn, 20))
        sweep[text] = {"ms": t, "bound_share": bound_ms / t,
                       "occupancy": backward_occupancy(plan)}
        del got
    del ref_at
    gather_GBps = 2 * g_emb.numel() * g_emb.element_size() / best["index_select"] / 1e6
    print(f"embedding_bag_backward at train_batch: events ms (min of 2 runs of 20, in turns) "
          f"{best}; runs {ms}; plain twin {plain:.6f}; index_select {gather_GBps:.1f} GB/s "
          f"read and written; device ms by kernel, one pass {parts['one_pass']}, two pass "
          f"{parts['two_pass']}; one-pass kernel device ms: profiler {kernel_dev:.6f}, events "
          f"on sorted ids (fill included) {best['one_pass_sorted']:.6f}; the card fits "
          f"{occupancy}; plan sweep (chunk:ring) {sweep}; bound {bound_ms:.6f} ms "
          f"({bwd_bytes} B; PR 20's {bound_pr20}), the one-pass kernel moves {moved} B; cut "
          f"runs {n_cut}")
    shape = f"bags {tuple(bags.shape)}, grad {tuple(g_emb.shape)} {g_emb.dtype}"
    library = "torch.zeros(U, D).index_add_(0, inverse, g.float()) after torch.unique"
    src = "src/repro_torch/csrc/embedding_bag.cu"
    rows_out = [
        _row("embedding_bag_backward", src, EMB_BWD_REPLACES, counts["embedding_bag_backward"],
             errs["embedding_bag_backward"], best["one_pass"], plain, bwd_bytes, n_pos * d,
             CORE_OPS_PER_S, best["index_add"], runs=ms["one_pass"], kernel_ms=kernel_dev,
             kernel_events_ms=best["one_pass_sorted"], sort_ms=best["sort"],
             device_ms=dev_one, device_parts=parts["one_pass"], moved_bytes=moved,
             kernel_bound_share=bound_ms / kernel_dev if kernel_dev else None,
             occupancy=occupancy["one_pass"], plan_sweep=sweep,
             index_select_ms=best["index_select"], index_select_GBps=gather_GBps,
             n_positions=n_pos, n_unique=n, cut_runs=n_cut, library=library, shape=shape,
             **bound_pr20,
             note="ms: the wrapper as the step runs it (sort, fill, kernel); kernel_ms the "
             "kernel's device time (profiler); bound_ms the kernel's"),
        _row("embedding_bag_backward_two_pass", src, EMB_BWD_REPLACES,
             counts["embedding_bag_backward_two_pass"], errs["embedding_bag_backward_two_pass"],
             best["two_pass"], plain, bwd_bytes, n_pos * d, CORE_OPS_PER_S, best["index_add"],
             runs=ms["two_pass"], device_ms=dev_two, device_parts=parts["two_pass"],
             occupancy=occupancy["two_pass"], library=library, shape=shape, **bound_pr20,
             note="the first design, off the path (two_pass=True): the sort and bag_runs' "
             "slots, then its kernel and the combine; ms the wrapper as a whole")]
    comb_twin = lambda: ref.embedding_bag_backward_combine_ref(*pieces, c_kern)  # noqa: E731
    comb = lambda: embedding_bag_backward_combine_cuda(*pieces, c_kern)  # noqa: E731
    comb_ms = min(_time_ms(torch, comb, 50), _time_ms(torch, comb, 50))
    comb_plain = min(_time_ms(torch, comb_twin, 5), _time_ms(torch, comb_twin, 5))
    comb_bytes = (2 * n_cut + n_cont) * d * 4  # part_last and slots of cut runs, part_first
    rows_out.append(_row(
        "embedding_bag_backward_combine", src, EMB_BWD_REPLACES,
        counts["embedding_bag_backward_combine"], errs["embedding_bag_backward_combine"],
        comb_ms, comb_plain, comb_bytes, n_cont * d, CORE_OPS_PER_S, None, cut_runs=n_cut,
        pieces_added=n_cont, note="the two-pass route's second launch, off the path; the "
        "one-pass kernel completes a cut run in the chunk that brings its last piece",
        library="none: no single call adds a cut run's pieces into its slot"))
    del pieces, c_kern, uniq, inverse, ids, perm
    return rows_out


def time_train_kernels(torch, np, model, opt_state, batch, errs: dict, counts: dict) -> list:
    """Phase 4's rows for the three training kernels, on the inputs the
    train_batch step gives them, each beside its plain twin, its bound and
    a PyTorch call that computes the same function where one does: the
    backward's one-pass kernel and the two-pass route it replaced (its two
    launches as two rows, :func:`_emb_bwd_rows`), the interaction's
    backward, ``sgd_rows``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import (SGD_BLOCKS_AN_SM, SGD_R,
                                                   embedding_bag_backward_cuda, sgd_rows_cuda,
                                                   sgd_rows_occupancy, sgd_rows_plan)
    from repro_torch.launch.sgd_sweep import link_while, page_probe

    inp = _train_inputs(torch, model, batch)
    bags, g_emb, fields, dz = inp["bags"], inp["g_emb"], inp["fields"], inp["dz"]
    n_rows, d = model.table.shape
    rows_out = _emb_bwd_rows(torch, np, bags, g_emb, n_rows, errs, counts)
    rows_out += _dot_bwd_rows(torch, fields, dz, errs, counts)

    # sgd_rows on the step's own compact gradient, in place on the model's
    # master and table with lr = 0: the same traffic, and no row moves;
    # beside the read and the write alone over the same rows (the link's
    # ceiling for them)
    rows, grads, n_u = embedding_bag_backward_cuda(bags, g_emb, "sum", n_rows)
    n = int(n_u)
    zero, one = torch.zeros((), device=DEV), torch.ones((), device=DEV)
    args = (model.master, model.table, rows, grads, n_u, zero, one)
    n_sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    plan = sgd_rows_plan(rows.numel(), SGD_R, n_sms * SGD_BLOCKS_AN_SM[SGD_R])
    occupancy = sgd_rows_occupancy(SGD_R)
    if occupancy["blocks_an_sm"] != SGD_BLOCKS_AN_SM[SGD_R]:
        _fail(f"sgd_rows' grid assumes {SGD_BLOCKS_AN_SM[SGD_R]} blocks an SM, the card fits "
              f"{occupancy}")
    kern = lambda: sgd_rows_cuda(*args)  # noqa: E731
    twin = lambda: ref.sgd_rows_ref(*args)  # noqa: E731
    plain_a = _time_ms(torch, twin, 2)
    ms_a = _time_ms(torch, kern, 10)
    ms_b = _time_ms(torch, kern, 10)
    plain_b = _time_ms(torch, twin, 2)
    touched = rows[:n].cpu()
    snap_m, snap_t = model.master[touched], model.table[rows[:n]].clone()
    read_ms = _time_ms(torch, lambda: sgd_rows_cuda(*args, plan=replace(plan, mode="read")), 10)
    write_ms = _time_ms(torch, lambda: sgd_rows_cuda(*args, plan=replace(plan, mode="write")),
                        10)
    read_changed = int((model.table[rows[:n]] != snap_t).any(dim=1).sum())
    model.master[touched] = snap_m
    model.table[rows[:n]] = snap_t
    del snap_m, snap_t
    if read_changed:
        _fail(f"sgd_rows' read pass changed {read_changed} table rows: it must leave the "
              f"table as the master rounds")
    link = link_while(kern)
    probe = page_probe(model.master, model.table)
    print(f"sgd_rows read pass, ns a row by the rows' distance: {probe}")
    es = model.table.element_size()
    sgd_bytes = n * d * (4 + es) + n * 8  # on the card: grads and rows read, table rows written
    each_way = n * d * 4                  # the master rows, read and written over PCIe
    rows_out.append(_row(
        "sgd_rows", "src/repro_torch/csrc/embedding_bag.cu", SGD_REPLACES, counts["sgd_rows"],
        errs["sgd_rows"], min(ms_a, ms_b), min(plain_a, plain_b), sgd_bytes, 3 * n * d,
        CORE_OPS_PER_S, None, link_bytes=each_way, runs=[ms_a, ms_b], rows=n,
        plan=f"{plan.rows_per_warp} rows a warp, {plan.blocks} blocks",
        occupancy=occupancy, read_ms=read_ms, write_ms=write_ms,
        link_ceiling_ms=max(read_ms, write_ms), link_during=link,
        page_probe_ns_per_row=probe,
        pcie_bytes=2 * each_way, device_bound_ms=sgd_bytes / HBM_BYTES_PER_S * 1e3,
        library="none: no single call updates rows of host-mapped memory",
        note=f"bound_ms: the master rows over PCIe Gen5 x16 at {PCIE_BYTES_PER_S / 1e9:g} GB/s "
        "each way (read and written); the card's own bytes are device_bound_ms; "
        "link_ceiling_ms: the slower of the read and the write alone over these rows"))
    rows_out[-1]["pcie_GBps"] = 2 * each_way / (rows_out[-1]["ms"] / 1e3) / 1e9
    return rows_out


def _device_parts(torch, fn, reps: int) -> dict:
    """Device ms and calls a call of fn spends in each kernel, memset or
    copy, by name (the profiler, over reps calls), the longest first."""
    fn()
    torch.cuda.synchronize()
    _, _, avgs = _profile(torch, lambda: [fn() for _ in range(reps)])
    out = {e.key[:90]: {"ms": e.self_device_time_total / reps / 1e3, "calls": e.count / reps}
           for e in avgs if getattr(e, "self_device_time_total", 0) > 0}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def _kernel_device_ms(torch, fn, reps: int) -> dict:
    """Device ms of each kernel of this repository in one call of fn (the
    profiler, over reps calls)."""
    fn()
    torch.cuda.synchronize()
    _, _, avgs = _profile(torch, lambda: [fn() for _ in range(reps)])
    return {e.key[:60]: e.self_device_time_total / reps / 1e3 for e in avgs
            if getattr(e, "self_device_time_total", 0) > 0 and "embedding_bag" in e.key}


DOT_BWD_SWEEP = ((8, 3), (8, 2), (4, 3), (4, 2), (2, 3))  # (samples, stages) at train_batch


def _dot_bwd_rows(torch, x, dz, errs: dict, counts: dict) -> list:
    """Phase 4's rows for ``dot_interaction_backward`` on the train step's
    own fields and dz: the tensor-core kernel and the SIMT kernel (reached
    through its explicit route) held against the plain twin (and the
    tensor cores against the tiling twin) within DOT_BWD_TOL, then timed in
    turns beside the plain twin and the ``torch.bmm(G + Gᵀ, x.float())``
    yardstick (plain, tc, simt, bmm, bmm, simt, tc, plain) and a copy of x
    (the card's rate for such a stream), a sweep of the tensor-core plan
    (each plan's output bit-identical to the wrapper's: a sample's
    arithmetic does not depend on its group), what the card fits of the
    instance, and its HMMA count in SASS."""
    from dataclasses import asdict

    from repro_torch.kernels import ref
    from repro_torch.kernels.dot_interaction import (_sm_count, backward_occupancy,
                                                     backward_uses_tensor_cores,
                                                     dot_interaction_backward_cuda,
                                                     tc_backward_plan)

    if not backward_uses_tensor_cores(x, dz):
        _fail("the train step's fields do not take the tensor-core dot_interaction_backward")
    b, f, d = x.shape
    ii, jj = torch.tril_indices(f, f, -1, device=DEV)
    s = torch.zeros((b, f, f), device=DEV)
    s[:, ii, jj] = dz
    s = s + s.transpose(1, 2)
    tc = lambda: dot_interaction_backward_cuda(x, dz)  # noqa: E731
    simt = lambda: dot_interaction_backward_cuda(x, dz, simt=True)  # noqa: E731
    twin = lambda: ref.dot_interaction_backward_ref(x, dz)  # noqa: E731
    lib = lambda: torch.bmm(s, x.float())  # noqa: E731
    tol = DOT_BWD_TOL[str(x.dtype).split(".")[-1]]
    want = twin()
    got_tc, got_simt, tiled = tc(), simt(), ref.dot_interaction_backward_tc_ref(x, dz)
    if not (_close(torch, got_tc, want, **tol) and _close(torch, got_tc, tiled, **tol)
            and _close(torch, got_simt, want, **tol) and _close(torch, lib(), want.float(), **tol)):
        _fail("dot_interaction_backward (a route, or the yardstick) differs from its twins at "
              "train_batch shapes")
    for name, got in zip(DOT_BWD_ROUTES, (got_tc, got_simt)):
        errs[name] = max(errs[name], float((got.float() - want.float()).abs().max()))
    tiled_err = float((got_tc.float() - tiled.float()).abs().max())
    del got_simt, tiled, want
    n_sm = _sm_count(x.device)
    plan = tc_backward_plan(b, f, d, n_sm)
    sweep = {}
    for samples, stages in DOT_BWD_SWEEP:
        sp = tc_backward_plan(b, f, d, n_sm, samples=samples, stages=stages)
        if not torch.equal(dot_interaction_backward_cuda(x, dz, sp), got_tc):
            _fail(f"dot_interaction_backward's output depends on its plan ({samples}, {stages})")
        sweep[f"{samples}x{stages}"] = {
            "blocks": sp.blocks, "smem": sp.smem,
            "ms": _time_ms(torch, lambda sp=sp: dot_interaction_backward_cuda(x, dz, sp), 20)}
    del got_tc
    # what a plain copy of x reaches on this card: the practical rate for
    # a stream read and written in about equal parts, as this kernel's is
    x_copy = torch.empty_like(x)
    copy_ms = min(_time_ms(torch, lambda: x_copy.copy_(x), 20) for _ in range(2))
    del x_copy
    plain_a = _time_ms(torch, twin, 3)
    tc_a, simt_a = _time_ms(torch, tc, 20), _time_ms(torch, simt, 20)
    lib_a, lib_b = _time_ms(torch, lib, 20), _time_ms(torch, lib, 20)
    simt_b, tc_b = _time_ms(torch, simt, 20), _time_ms(torch, tc, 20)
    plain_b = _time_ms(torch, twin, 3)
    occupancy = backward_occupancy(f, plan)
    mma = _mma_counts("dot_interaction")
    hmma = sum(v["HMMA"] for k, v in mma.items() if "backward_tc" in k) if mma else None
    if mma and not hmma:
        _fail("no HMMA in the tensor-core dot_interaction_backward kernel's SASS")
    print(f"dot_interaction_backward plan at train_batch {asdict(plan)}; the card fits "
          f"{occupancy}; sweep (samples x stages): {sweep}; HMMA in the tensor-core backward "
          f"(SASS, static) {hmma}; max_abs_err vs the tiling twin {tiled_err}")
    nbytes = 2 * x.numel() * x.element_size() + dz.numel() * 4
    products = 2 * b * f * (f - 1) * d  # one (G + Gᵀ) X
    shape = f"x {tuple(x.shape)} {x.dtype}, dz {tuple(dz.shape)}"
    library = "torch.bmm(G + G^T, x.float()), G built beforehand"
    rows = [_row(DOT_BWD_ROUTES[0], "src/repro_torch/csrc/dot_interaction.cu", DOT_BWD_REPLACES,
                 counts[DOT_BWD_ROUTES[0]], errs[DOT_BWD_ROUTES[0]], min(tc_a, tc_b),
                 min(plain_a, plain_b), nbytes, 3 * products, H100_BF16_FLOPS,
                 min(lib_a, lib_b), runs=[tc_a, tc_b], simt_ms=min(simt_a, simt_b),
                 copy_ms=copy_ms, copy_GBps=2 * x.numel() * x.element_size() / copy_ms / 1e6,
                 GBps=nbytes / min(tc_a, tc_b) / 1e6,
                 plan=asdict(plan), occupancy=occupancy, plan_sweep_ms=sweep,
                 hmma_sass=hmma, max_abs_err_vs_tiling_twin=tiled_err, library=library,
                 note="ops: the three bf16 terms' products at the bf16 tensor-core rate",
                 shape=shape),
            _row(DOT_BWD_ROUTES[1], "src/repro_torch/csrc/dot_interaction.cu", DOT_BWD_REPLACES,
                 counts[DOT_BWD_ROUTES[1]], errs[DOT_BWD_ROUTES[1]], min(simt_a, simt_b),
                 min(plain_a, plain_b), nbytes, products, CORE_OPS_PER_S, min(lib_a, lib_b),
                 runs=[simt_a, simt_b], library=library,
                 note="the SIMT route, forced (simt=True) at the train step's inputs; the step "
                 "takes the tensor cores", shape=shape)]
    del s
    return rows


ROUTE_STEPS = 10  # steps a turn when the step is timed with each backward route


def _step_ms_by_route(torch, np, run, op: str, forced: dict, a_step: dict, name: str) -> dict:
    """The train step's median ms with ``ops.<op>`` set to each of the two
    routes of ``forced`` (route -> function; the first is the step as it
    is), in turns a, b, b, a of ROUTE_STEPS steps each: the two kernels on
    one host, in one process; then one profiled step on each
    (:func:`_step_trace` of the kernels whose name holds ``name``). Fails
    unless each turn launched its route's kernels as ``a_step`` says (route
    -> {kernel: launches a step}) and the other's never."""
    from repro_torch.kernels import ops

    real = getattr(ops, op)
    first, second = forced
    names = sorted({k for launches in a_step.values() for k in launches})
    times = {route: [] for route in forced}
    try:
        for route in (first, second, second, first):
            setattr(ops, op, forced[route])
            before = {k: ops.launch_counts[k] for k in names}
            for _ in range(ROUTE_STEPS):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times[route].append(time.perf_counter() - t0)
            launched = {k: ops.launch_counts[k] - before[k] for k in names}
            if launched != {k: ROUTE_STEPS * a_step[route].get(k, 0) for k in names}:
                _fail(f"the train steps timed on the {route} {op} launched {launched}")
        traces = {}
        for route in forced:
            setattr(ops, op, forced[route])
            traces[route] = _step_trace(torch, run, name)
    finally:
        setattr(ops, op, real)
    res = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    print(f"train_batch step ms by {op} route (median of {2 * ROUTE_STEPS} steps each, in "
          f"turns {first}, {second}, {second}, {first}): {res}; {second} - {first} = "
          f"{res[second] - res[first]:.6f} ms; steps "
          f"{ {k: [round(t * 1e3, 6) for t in v] for k, v in times.items()} }; "
          f"one profiled step each: {traces}")
    return {**res, "trace": traces}


def _step_ms_by_dot_route(torch, np, run) -> dict:
    """:func:`_step_ms_by_route` of ``dot_interaction_backward``: the
    tensor-core kernel (the step's) and the SIMT one."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.dot_interaction import dot_interaction_backward_cuda

    forced = {"tc": ops.dot_interaction_backward,
              "simt": lambda x, dz: dot_interaction_backward_cuda(x, dz, simt=True)}
    a_step = {"tc": {DOT_BWD_ROUTES[0]: 1}, "simt": {DOT_BWD_ROUTES[1]: 1}}
    return _step_ms_by_route(torch, np, run, "dot_interaction_backward", forced, a_step,
                             "dot_interaction_backward")


def _step_ms_by_emb_route(torch, np, run) -> dict:
    """:func:`_step_ms_by_route` of ``embedding_bag_backward``: the one-pass
    kernel (the step's) and the two-pass route (its kernel and combine)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import embedding_bag_backward_cuda

    forced = {"one_pass": ops.embedding_bag_backward,
              "two_pass": lambda idx, g, combiner="sum", n_rows=None: embedding_bag_backward_cuda(
                  idx, g, combiner, n_rows, two_pass=True)}
    return _step_ms_by_route(torch, np, run, "embedding_bag_backward", forced,
                             {r: EMB_BWD_ROUTES[r] for r in forced}, "embedding_bag_backward")


def _step_trace(torch, run, name: str) -> dict:
    """One profiled call of run: its wall ms, the device's kernel ms (also
    without ``sgd_rows``, whose time the host sets and which moves by more
    than a kernel's gain from step to step) and idle ms (no kernel running)
    inside the kernels' span, and, for the kernels whose name holds
    `name`, their device ms, the idle just before the first and after the
    last, and the kernel that follows them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ks = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start))
    res = {"wall_ms": wall * 1e3, "kernels": len(ks)}
    if not ks:
        return res
    idle, end, gaps = 0.0, ks[0][0], []
    for start, stop, _ in ks:
        gaps.append(max(0.0, start - end))
        idle += gaps[-1]
        end = max(end, stop)
    res.update(kernel_ms=sum(b - a for a, b, _ in ks) / 1e3, idle_ms=idle / 1e3,
               span_ms=(end - ks[0][0]) / 1e3,
               kernel_ms_without_sgd_rows=sum(b - a for a, b, k in ks if "sgd_rows" not in k)
               / 1e3)
    hits = [i for i, (_, _, kname) in enumerate(ks) if name in kname]
    if hits:
        i, j = hits[0], hits[-1]
        res.update(kernel=[ks[h][2][:60] for h in hits],
                   kernel_device_ms=sum(ks[h][1] - ks[h][0] for h in hits) / 1e3,
                   idle_before_ms=gaps[i] / 1e3,
                   idle_after_ms=gaps[j + 1] / 1e3 if j + 1 < len(ks) else None,
                   next=ks[j + 1][2][:60] if j + 1 < len(ks) else None)
    return res


def drive_dlrm_train(torch, np, seed: int, errs: dict) -> list:
    """Phase 6b: dlrm-mlperf train_batch at full size (177,948,416 rows x 128,
    B = 65,536), the tables' float32 master in registered host memory."""
    from repro_torch.launch.host_probe import host_report, pages
    from repro_torch.launch.steps import build_cell

    left = torch.cuda.memory_allocated()
    if left > 1 << 30:
        _fail(f"the DLRM train phase starts with {left} bytes still allocated")
    probe = host_report()
    print(f"dlrm train host probe: {json.dumps(probe)}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = build_cell("dlrm-mlperf", "train_batch", seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model, opt_state, dense, sparse, labels = cell.args
    batch = (dense, sparse, labels)
    opt_cfg = cell.fn.keywords["opt_cfg"]
    master = model.master
    print(f"dlrm train init_s={init_s:.3f} master_bytes={master.numel() * 4} "
          f"master_register_s={model.master_register_s:.3f} table {tuple(model.table.shape)} "
          f"{model.table.dtype} batch={dense.shape[0]} label_rate={float(labels.mean()):.4f} "
          f"MemAvailable_after={host_report()['meminfo']['MemAvailable']} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    master_pages = pages(master)
    print(f"dlrm train master on its host backing 'huge' (2 MB-aligned, MADV_HUGEPAGE): "
          f"{json.dumps(master_pages)}")
    if master_pages["huge_bytes"] == 0:
        print(f"dlrm train: the host gave the master no huge pages (transparent huge pages "
              f"{probe['thp']}): it is on 4 KB pages")

    counts, (loss, met) = _served_counts(torch, cell.run)
    counts = _train_counts(counts)
    if not bool(torch.isfinite(loss)):
        _fail("the train_batch loss is not finite")
    print(f"train_batch first step loss={float(loss)} lr={float(met['lr'])} "
          f"grad_norm={float(met['grad_norm'])}")
    hold = _hold_train_step(torch, np, model, opt_state, batch, opt_cfg, seed)

    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        cell.run()
    torch.cuda.synchronize()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, met = cell.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(loss)):
        _fail("the train_batch loss is not finite after the timed steps")
    step_ms = float(np.median(times)) * 1e3
    syncs = _count_syncs(torch, cell.run)
    if syncs > TRAIN_MAX_SYNCS:
        _fail(f"a train_batch step made {syncs} host syncs (at most {TRAIN_MAX_SYNCS})")
    by_route = _step_ms_by_dot_route(torch, np, cell.run)
    by_emb_route = _step_ms_by_emb_route(torch, np, cell.run)
    wall, dev, avgs = _profile(torch, cell.run)
    peak = torch.cuda.max_memory_allocated()
    print(f"train_batch B={dense.shape[0]} steps={TRAIN_STEPS} step_ms_median={step_ms:.6f} "
          f"step_ms={[round(t * 1e3, 6) for t in times]} "
          f"samples_per_s={dense.shape[0] / (step_ms / 1e3):.1f} host_syncs_per_step={syncs} "
          f"loss={float(loss)} grad_norm={float(met['grad_norm'])}")
    print(f"device busy train_batch step: wall_s={wall:.6f} kernel_s={dev:.6f} "
          f"busy_share={dev / wall if dev > 0 else 'not measured'}")
    print(f"train_batch kernels by device time: {_top_kernels(avgs, 16)}")
    print(f"train_batch peak max_memory_allocated={peak}")
    rows = time_train_kernels(torch, np, model, opt_state, batch, errs, counts)
    for r in rows:
        r["train_step_ms"] = step_ms
        if r["name"] in DOT_BWD_ROUTES:
            r["train_step_ms_by_route"] = by_route
        if r["name"].startswith("embedding_bag_backward"):
            r["train_step_ms_by_route"] = by_emb_route
        if r["name"] == "embedding_bag_backward":  # its device time, the third reading
            r["kernel_step_trace_ms"] = by_emb_route["trace"]["one_pass"].get(
                "kernel_device_ms")
    summary = {"init_s": init_s, "register_s": model.master_register_s, "step_ms": step_ms,
               "step_ms_by_backward_route": by_route,
               "step_ms_by_embedding_backward_route": by_emb_route,
               "samples_per_s": dense.shape[0] / (step_ms / 1e3), "syncs": syncs,
               "busy": dev / wall if dev > 0 else None, "peak": peak, "hold": hold,
               "master_backing": "huge", "master_pages": master_pages}
    print(f"dlrm train summary: {json.dumps(summary)}")
    t0 = time.perf_counter()
    model.release_master()
    del cell, model, opt_state, dense, sparse, labels, batch, master, loss, met
    # the backward's GEMMs ran on autograd's thread, whose cuBLAS handle got
    # its own 32 MiB workspace, carved from one of this phase's segments: a
    # live block there would keep the whole segment reserved for the phases
    # after this one
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    host = host_report()
    print(f"dlrm train master released in {time.perf_counter() - t0:.3f} s; "
          f"MemAvailable={host['meminfo']['MemAvailable']} rss={host['rss']} "
          f"memory_allocated={after} (at the start {left}) "
          f"memory_reserved={torch.cuda.memory_reserved()}")
    if after > left:
        _fail(f"the DLRM train phase left {after - left} bytes allocated")
    return rows


# Tolerances of flash_attention against its twin on the card: float32 sums
# in another order (tiles of keys, an online max), bfloat16 also rounds p
# against another running max (tests/test_kernels.py's bf16 tolerance).
ATTN_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# flash_attention against its twin at the main path's own shapes, where the
# outputs are far from unit scale (about 0.01 at decode_32k, an average over
# 32,768 keys): atol is scaled by the largest |output|, 2**-7 of it in
# bfloat16 (at least one bfloat16 step at that magnitude, what rounding p or
# the output another way moves it by), 1e-4 of it in float32 (the inputs
# cast to float32).
ATTN_MAIN_TOL = {"bfloat16": (2e-2, 2.0 ** -7), "float32": (1e-4, 1e-4)}  # (rtol, atol/max|want|)
CONTROL_TILE = 64           # the controls drop keys 0..63, a kernel that skipped its first tile
# The LM kernel path against its twin path. float32 at full width: the
# attention's summation order through 28 layers. bfloat16: both paths round
# every activation to bfloat16, so an attention output that rounds one step
# apart in one layer is carried by the residual stream through the rest. The
# limit sits between two readings of the same comparison, both printed by
# every run: the twin path with p left in float32 (what rounding p in
# another way does to the logits) and a control, the twin path with the
# first K/V tile dropped in every layer, which must land above it. On an
# H100 (700 W): kernel path 0.086 / 0.161, witness 0.088 / 0.158, control
# 5.08 / 0.549 at the lm_serve prefill / decode_32k.
LM_F32_TOL = dict(rtol=1e-3, atol=1e-3)
LM_BF16_TOL = dict(rtol=0.0, atol=0.25)
# LM_BF16_TOL's atol was set on qwen2-1.5b's readings. Phase 7b's models
# carry the two paths' bfloat16 roundings further: on an H100 (700 W) the
# witness itself read 0.258 (yi-34b, 60 layers) and 0.273 (olmoe-1b-7b) at
# decode_32k, above 0.25, so no kernel could pass that limit there. Their
# limit is LM_BF16_WITNESS times the witness of the same comparison where
# that is above 0.25 (the kernel paths read at most 1.2 times it); the
# control must land above the limit (it read 2.8 times the witness or more).
LM_BF16_WITNESS = 2.0
SDPA_TOL = 0.1              # the yardstick's agreement with the kernel (bfloat16)
LM_MAX_LEN = 4096           # lm_serve cache positions per sequence
LM_PROMPT_LENS = (256, 2048)  # lm_serve prompt lengths are drawn in this range
LM_NEW_TOKENS = 64
LM_F32_NEW = 8              # greedy tokens of the float32 qwen2 check (16 until phase 7c)
PREFILL_32K_BATCH = 4       # of the registry's 32: the smoke's time limit
DECODE_32K_BATCH = 64       # of the registry's 128: 128 caches are 120.3 GB
H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core peak, the attention bound's rate


def _close_scaled(torch, got, want, name: str) -> bool:
    """got within ATTN_MAIN_TOL[name] of want: rtol, and atol scaled by
    the largest |want| (0 where want is all 0: then got must be 0 too)."""
    rtol, scaled = ATTN_MAIN_TOL[name]
    want = want.float()
    atol = scaled * float(want.abs().max()) if want.numel() else 0.0
    return torch.allclose(got.float(), want, rtol=rtol, atol=atol)


def check_attention_kernel(torch, np, seed: int) -> dict:
    """Phase 2, flash_attention against its twin on the card: the reference
    sweeps (GQA, windows, soft-cap, non-causal), more queries than keys,
    lengths that are not tile multiples, one query row inside a cache,
    D in {64, 128, 256} and the zero-padded D = 24, 40 in float32 and
    bfloat16, the model's strided views, lm_serve's padded prompt against
    its cache, a q_offset inside a tile, decode split 1, 2, 7 ways and as
    planned (windowed with empty splits, Sk not a multiple of 64), and
    empty lengths. Each case is held within ATTN_TOL and, since outputs
    averaged over many keys are far from unit scale, also within
    ATTN_MAIN_TOL's atol scaled by its largest |output|. Each call launches
    flash_attention once and the merge once exactly when it splits. The
    merge kernels are also held against the twin's merge on the twin's own
    partials (up to 512 splits, in the plan's chunks and forced ones), the
    path's merge in float32 within MERGE_F32_RTOL."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (MERGE_MAX_SPLITS, _sm_count,
                                                     flash_attention_combine_cuda,
                                                     flash_attention_combine_rowwise_cuda,
                                                     flash_attention_cuda, pack_partials,
                                                     plan_merge, planned_splits)

    rng = np.random.default_rng(seed)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []  # (dtype, (B, Hq, Hkv, Sq, Sk, D), kwargs, strided)
    for dt in (f32, bf16):
        for shape in ((1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 128, 64),
                      (1, 4, 1, 64, 256, 32), (1, 2, 2, 256, 256, 128)):
            cases.append((dt, shape, {}, False))
        for window in (None, 64, 128):
            for softcap in (None, 30.0):
                cases.append((dt, (1, 4, 2, 256, 256, 64),
                              dict(window=window, softcap=softcap), False))
        cases.append((dt, (1, 2, 2, 128, 128, 32), dict(causal=False), False))
        cases.append((dt, (1, 4, 2, 100, 50, 32), {}, False))              # Sq > Sk
        cases.append((dt, (2, 6, 2, 77, 333, 8), {}, False))               # ragged
        cases.append((dt, (1, 12, 2, 130, 1000, 128), dict(window=40, q_offset=600), False))
        cases.append((dt, (3, 6, 2, 1, 97, 24), dict(q_offset=50), False))  # decode
        cases.append((dt, (4, 12, 2, 1, 4096, 128), dict(q_offset=1234), True))
        for d in (64, 128, 256):
            cases.append((dt, (2, 12, 2, 300, 700, d), dict(q_offset=400), True))
            cases.append((dt, (2, 12, 2, 1, 700, d), dict(q_offset=650), True))
            cases.append((dt, (1, 4, 2, 70, 70, d), dict(causal=False, softcap=20.0), False))
        cases.append((dt, (1, 4, 2, 0, 16, 64), {}, False))                # Sq = 0
        cases.append((dt, (1, 4, 2, 5, 0, 64), {}, False))                 # Sk = 0
        cases.append((dt, (1, 12, 2, 200, 300, 24), dict(q_offset=100), False))  # D padded
        cases.append((dt, (2, 6, 2, 150, 150, 40), {}, False))                   # to 16s
        cases.append((dt, (1, 12, 2, 1558, 4096, 128), dict(q_offset=0), True))  # lm_serve
        cases.append((dt, (1, 12, 2, 100, 700, 128), dict(q_offset=37), True))   # mid-tile
        for n in (1, 2, 7):  # the decode above (split as planned), split n ways
            cases.append((dt, (4, 12, 2, 1, 4096, 128), dict(q_offset=1234, n_splits=n), True))
        cases.append((dt, (2, 12, 2, 1, 2048, 128),  # 100 keys: splits 2..6 see none
                      dict(q_offset=1500, window=100, n_splits=7), True))
        cases.append((dt, (3, 6, 2, 1, 1000, 64), dict(causal=False, n_splits=7), False))
        cases.append((dt, (3, 12, 2, 1, 1000, 128), dict(q_offset=999), True))  # ragged end
    err = {"float32": 0.0, "bfloat16": 0.0}
    combines = 0
    for dt, (b, hq, hkv, sq, sk, d), kw, strided in cases:
        name = str(dt).split(".")[-1]
        if strided:  # the model's layouts: q (B, S, H, D), the cache (B, Smax, Hkv, D)
            mk = [torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
                  .to(DEV, dt).transpose(1, 2) for s, h in ((sq, hq), (sk, hkv), (sk, hkv))]
        else:
            mk = [torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32)).to(DEV, dt)
                  for s, h in ((sq, hq), (sk, hkv), (sk, hkv))]
        before = dict(ops.launch_counts)
        got = flash_attention_cuda(*mk, **kw)
        want = ref.flash_attention_ref(*mk, **{a: x for a, x in kw.items() if a != "n_splits"})
        torch.cuda.synchronize()
        launched, merged = (ops.launch_counts[n] - before[n]
                            for n in ("flash_attention", "flash_attention_combine"))
        what = f"{name} (B,Hq,Hkv,Sq,Sk,D)={(b, hq, hkv, sq, sk, d)} {kw} strided={strided}"
        if launched != (1 if sq else 0):
            _fail(f"flash_attention launched {launched} times for {what}")
        if merged != (1 if sq and planned_splits(*mk[:2], **kw) > 1 else 0):
            _fail(f"flash_attention_combine launched {merged} times for {what}")
        combines += merged
        if got.shape != want.shape or got.dtype != dt \
                or not torch.allclose(got.float(), want.float(), **ATTN_TOL[name]) \
                or not _close_scaled(torch, got, want, name):
            _fail(f"flash_attention differs from its twin at {what}")
        if got.numel():
            err[name] = max(err[name], float((got.float() - want.float()).abs().max()))
        if not bool(torch.isfinite(got).all()):
            _fail(f"flash_attention gave a value that is not finite at {what}")
        if sq > sk and kw.get("q_offset") is None and got[:, :, :sq - sk].abs().max() != 0:
            _fail(f"flash_attention rows that see no key are not 0 at {what}")
    print(f"flash_attention kernel_vs_plain cases={len(cases)} (of them split and merged: "
          f"{combines}) max_abs_err float32={err['float32']} bfloat16={err['bfloat16']} "
          f"tolerances={ATTN_TOL} and (rtol, atol / max|want|)={ATTN_MAIN_TOL}")

    # the merges alone, on the twin's partials: a windowed decode with empty
    # splits, long_500k's 512 splits of 32,768 keys (a window of 1,000 keys
    # leaves 496 empty), D = 256 and D = 24; the path's merge as planned and
    # in forced chunks (both levels), the rowwise merge as it is
    err["combine"] = err["combine_rowwise"] = 0.0
    n_merges = 0
    for (b, hq, hkv, sk, d), n, kw in (((3, 12, 2, 900, 64), 7, dict(q_offset=850, window=300)),
                                       ((1, 12, 2, 32768, 128), 512, dict(q_offset=32767)),
                                       ((1, 12, 2, 32768, 128), 512,
                                        dict(q_offset=32767, window=1000)),
                                       ((4, 16, 8, 2048, 256), 32, dict(q_offset=2047)),
                                       ((3, 6, 2, 500, 24), 9, dict(q_offset=499))):
        for dt in (f32, bf16):
            name = str(dt).split(".")[-1]
            args = [torch.from_numpy(rng.normal(size=(b, h, s_, d)).astype(np.float32))
                    .to(DEV, dt) for s_, h in ((1, hq), (sk, hkv), (sk, hkv))]
            parts = ref.flash_attention_partials_ref(*args, n_splits=n, **kw)
            packed = pack_partials(*parts)
            want = ref.flash_attention_combine_ref(*parts, hq // hkv, dt)
            plan = plan_merge(b * hq, n, d, _sm_count(args[0].device))
            for chunks in sorted({plan, 1, 2, min(16, n), min(n, MERGE_MAX_SPLITS)}):
                got = flash_attention_combine_cuda(packed, torch.empty_like(args[0]), hkv, n,
                                                   chunks=chunks)
                what = f"{name} (B,Hq,Hkv,Sk,D)={(b, hq, hkv, sk, d)} {n} splits {kw} " \
                       f"in {chunks} chunks"
                if dt == f32:
                    atol = MERGE_F32_RTOL * float(want.abs().max())
                    ok = torch.allclose(got, want, rtol=MERGE_F32_RTOL, atol=atol)
                else:
                    ok = torch.allclose(got.float(), want.float(), **ATTN_TOL[name]) \
                        and _close_scaled(torch, got, want, name)
                if not ok:
                    _fail(f"flash_attention_combine differs from the twin's merge at {what}")
                err["combine"] = max(err["combine"], _logit_err(got, want))
                n_merges += 1
            got = flash_attention_combine_rowwise_cuda(packed, torch.empty_like(args[0]), hkv, n)
            if not torch.allclose(got.float(), want.float(), **ATTN_TOL[name]) \
                    or not _close_scaled(torch, got, want, name):
                _fail(f"flash_attention_combine_rowwise differs from the twin's merge in {name}")
            err["combine_rowwise"] = max(err["combine_rowwise"], _logit_err(got, want))
    print(f"flash_attention_combine kernel_vs_plain on the twin's partials: {n_merges} merges, "
          f"max_abs_err={err['combine']} (float32 within rtol {MERGE_F32_RTOL} and atol "
          f"{MERGE_F32_RTOL} x max|want|, bfloat16 within {ATTN_TOL['bfloat16']} and "
          f"{ATTN_MAIN_TOL['bfloat16']}); flash_attention_combine_rowwise max_abs_err="
          f"{err['combine_rowwise']}")
    return err


def _lm_params(np, cfg, seed: int) -> dict:
    """An ``init_params``-shaped pytree of numpy arrays, drawn with numpy,
    norms and biases included; layer leaves stacked as the reference
    stacks them ((L/2, 2, ...) for an alternating model)."""
    from repro_torch.models.transformer import param_shapes

    rng = np.random.default_rng(seed)
    flat = {k: (rng.normal(size=shape) * (0.1 if scale is None else scale)).astype(np.float32)
            for k, (shape, scale) in param_shapes(cfg).items()}
    top = ("embed", "ln_final", "w_vocab")
    return {**{k: flat[k] for k in top},
            "layers": {k: v.reshape(cfg.layers_leading + v.shape[1:])
                       for k, v in flat.items() if k not in top}}


def _prompts(np, rng, n: int, lo: int, hi: int, vocab: int) -> list:
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist() for _ in range(n)]


def _padded(torch, prompts: list, pad_id: int = 0):
    """The prompts left-padded with pad_id into one (B, plen) batch on the
    card, as ``ServeEngine.generate`` pads them."""
    plen = max(len(p) for p in prompts)
    tokens = torch.full((len(prompts), plen), pad_id, dtype=torch.int64)
    for i, p in enumerate(prompts):
        tokens[i, plen - len(p):] = torch.tensor(p)
    return tokens.to(DEV)


def lm_vs_host(torch, np, seed: int) -> None:
    """``qwen2-reduced`` from the same numpy weights on the card, through the
    kernel, and on the host CPU, through the twin: logits within 1e-4 and
    greedy tokens equal."""
    from repro_torch.configs.qwen2_1_5b import reduced
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ServeEngine

    cfg = reduced()
    params = _lm_params(np, cfg, seed)
    host = Transformer.from_numpy_params(params, cfg, device="cpu")
    card = Transformer.from_numpy_params(params, cfg, device=DEV)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 40)))
    err = float((card.forward_logits(tokens.to(DEV)).cpu() - host.forward_logits(tokens))
                .abs().max())
    if err > 1e-4:
        _fail(f"small LM on the card differs from the host CPU (max abs err {err})")
    prompts = _prompts(np, rng, 4, 3, 30, cfg.vocab)
    got = ServeEngine(card, max_len=64).generate(prompts, max_new_tokens=24)
    want = ServeEngine(host, max_len=64).generate(prompts, max_new_tokens=24)
    if not np.array_equal(got.tokens, want.tokens):
        _fail("small LM greedy tokens on the card differ from the host CPU's")
    print(f"lm small model card vs host CPU: forward_logits max_abs_err={err} tol=1e-4; "
          f"greedy tokens equal over {got.tokens.shape} = True")


def _logit_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def lm_float32_full_width(torch, np, seed: int) -> None:
    """qwen2-1.5b at full width with float32 weights (7.1 GB): the kernel
    path against the twin path on 2 prompts of 512, logits within
    LM_F32_TOL and greedy tokens over LM_F32_NEW steps equal."""
    import dataclasses

    from repro_torch.configs.qwen2_1_5b import config
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ServeEngine

    torch.cuda.reset_peak_memory_stats()
    model = Transformer.from_config(dataclasses.replace(config(), dtype="float32"),
                                    device=DEV, seed=seed)
    rng = np.random.default_rng(seed + 3)
    tokens = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, 512))).to(DEV)
    l_k, _ = model.prefill_step(tokens, max_len=528)
    with _Twins():
        l_t, _ = model.prefill_step(tokens, max_len=528)
    err = _logit_err(l_k, l_t)
    if not torch.allclose(l_k, l_t, **LM_F32_TOL):
        _fail(f"float32 qwen2-1.5b: kernel path logits differ from the twin path's ({err})")
    prompts = tokens.cpu().tolist()
    eng = ServeEngine(model, max_len=528)
    got = eng.generate(prompts, max_new_tokens=LM_F32_NEW)
    with _Twins():
        want = eng.generate(prompts, max_new_tokens=LM_F32_NEW)
    if not np.array_equal(got.tokens, want.tokens):
        _fail("float32 qwen2-1.5b: kernel path greedy tokens differ from the twin path's")
    print(f"lm float32 full width: prefill logits max_abs_err={err} tol={LM_F32_TOL} "
          f"logit range [{float(l_k.min()):.4f}, {float(l_k.max()):.4f}]; greedy tokens "
          f"equal over 2 x {LM_F32_NEW} = True; max_memory_allocated={torch.cuda.max_memory_allocated()}")
    del model, l_k, l_t
    torch.cuda.empty_cache()


def _capture_layers(run, layers) -> dict:
    """{i: (args, kwargs)} of ``ops.flash_attention``'s calls number i in
    ``layers`` in run(): those layers of a one-forward run."""
    from repro_torch.kernels import ops

    seen, calls = {}, [0]
    real = ops.flash_attention

    def rec(*a, **kw):
        if calls[0] in layers:
            seen[calls[0]] = (a, kw)
        calls[0] += 1
        return real(*a, **kw)

    ops.flash_attention = rec
    try:
        run()
    finally:
        ops.flash_attention = real
    return seen


def _capture_attention(run) -> tuple:
    """(args, kwargs) of the first ``ops.flash_attention`` call of run()."""
    return _capture_layers(run, (0,))[0]


def _p_unrounded(q, k, v, **kw):
    """The twin with p kept in float32 for the PV product (v cast to
    float32), output in q's dtype: the witness of what rounding p does."""
    from repro_torch.kernels import ref

    return ref.flash_attention_ref(q, k, v.float(), **kw)


def _first_tile_dropped(q, k, v, *, q_offset=None, **kw):
    """The control: the twin with the first CONTROL_TILE visible keys (keys
    0..63 unless a window starts later) and all before them invisible, as a
    kernel that skipped its first K/V tile would compute."""
    from repro_torch.kernels import ref

    off = k.shape[2] - q.shape[2] if q_offset is None else q_offset
    cut = ref.visible_range(q.shape[2], k.shape[2], off, kw.get("causal", True),
                            kw.get("window"))[0] + CONTROL_TILE
    return ref.flash_attention_ref(q, k[:, :, cut:], v[:, :, cut:], q_offset=off - cut, **kw)


def _hold_lm_bf16(torch, what: str, run, l_k, l_t, routes=None, flips: int = 0,
                  by_witness: bool = False) -> None:
    """The bfloat16 kernel path's logits l_k against the twin path's l_t,
    beside the witness (run() on the twin path with p unrounded) and the
    control (run() with the first tile dropped) through the same comparison:
    fails if the kernel path is off by more than LM_BF16_TOL (``by_witness``:
    or LM_BF16_WITNESS times the witness, whichever is larger) or the
    control is not. For an MoE model ``routes`` is the kernel path's routing, which
    the twin, witness and control runs replay (:class:`_Routes`); ``flips``
    and theirs count the tokens whose own choice differed."""
    with _Twins(_p_unrounded), _Routes(routes) as w:
        l_w = run()
    with _Twins(_first_tile_dropped), _Routes(routes) as c:
        l_c = run()
    err, witness, control = (_logit_err(x, l_t) for x in (l_k, l_w, l_c))
    flipped = "" if routes is None else (
        f"; flipped routings (tokens x layers whose own top-k differed from the kernel path's, "
        f"replayed) twin {flips} witness {w.flips} control {c.flips}")
    tol = LM_BF16_TOL
    if by_witness:
        tol = {**tol, "atol": max(tol["atol"], LM_BF16_WITNESS * witness)}
    print(f"{what} kernel vs twin path: logits max_abs_err={err} tol={tol}; "
          f"witness (twin, p unrounded) {witness}; control (twin, first tile dropped) "
          f"{control}; logit range [{float(l_k.min()):.4f}, {float(l_k.max()):.4f}]{flipped}")
    if not bool(torch.isfinite(l_k).all()) or not torch.allclose(l_k, l_t, **tol):
        _fail(f"{what}: kernel path logits differ from the twin path's ({err})")
    if torch.allclose(l_c, l_t, **tol):
        _fail(f"{what}: the comparison does not tell the control ({control}) from the twin")


def _check_yardstick(torch, sdpa, args, kw, what: str) -> None:
    """Checks the yardstick, not the kernel: the library call must compute
    the kernel's function. It rounds p in its own way, so it is held to
    SDPA_TOL, a gross-error check (a wrong head mapping or mask moves
    outputs of unit scale by far more). The kernel itself is held against
    its twin in :func:`_hold_attention`."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    err = float((sdpa().float() - flash_attention_cuda(*args, **kw).float()).abs().max())
    print(f"scaled_dot_product_attention vs kernel at {what}: max_abs_err={err} "
          f"tol={SDPA_TOL}")
    if err > SDPA_TOL:
        _fail(f"scaled_dot_product_attention computes another function at {what}")


def _hold_attention(torch, what: str, args, kw) -> float:
    """The kernel against its twin on one main-path call's inputs, in their
    bfloat16 (the tensor-core kernel) and cast to float32 (the SIMT
    kernel), within ATTN_MAIN_TOL; the control (first tile dropped) must
    fail both comparisons. kw's n_splits, where given, reaches the kernel
    only. Returns the bfloat16 max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    twin_kw = {a: x for a, x in kw.items() if a != "n_splits"}
    errs, verdicts = {}, {}
    for name, xs in (("bfloat16", args), ("float32", tuple(x.float() for x in args))):
        rtol, scaled = ATTN_MAIN_TOL[name]
        want = ref.flash_attention_ref(*xs, **twin_kw).float()
        got = flash_attention_cuda(*xs, **kw).float()
        ctrl = _first_tile_dropped(*xs, **twin_kw).float()
        atol = scaled * float(want.abs().max())
        errs[name] = (_logit_err(got, want), _logit_err(ctrl, want), atol)
        verdicts[name] = torch.allclose(ctrl, want, rtol=rtol, atol=atol)
        print(f"flash_attention vs twin at {what} in {name}: max_abs_err={errs[name][0]} "
              f"tol rtol={rtol} atol={atol} (max|want| x {scaled}); control (first tile "
              f"dropped) max_abs_err={errs[name][1]} passes={verdicts[name]}")
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            _fail(f"flash_attention differs from its twin at {what} in {name}")
        del want, got, ctrl
    for name, passed in verdicts.items():
        if passed:
            _fail(f"the {name} comparison at {what} does not tell the control from the twin")
    return errs["bfloat16"][0]


def _time_attention(torch, what: str, args, kw, visible_keys: int, causal_pairs: int,
                    sdpa, twin_args=None, twin_kw=None, twin_note: str = "",
                    reps: int = 10, sdpa_is_library: bool = True) -> dict:
    """Kernel, twin and SDPA times of one layer's attention, with its bound:
    bytes (q, o and the visible K and V once per kv head) at 3.35 TB/s
    against 4 * D FLOPs per visible (query head, key) pair at 989 TFLOP/s.
    The twin runs on twin_args with twin_kw where given (a part of the
    call), and the kernel is held against it there. Where SDPA computes
    another function (``sdpa_is_library`` False: it has no soft-cap), its
    time is kept as ``sdpa_no_cap_ms`` and ``library_ms`` is None."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v = args
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    es = q.element_size()
    nbytes = 2 * b * hq * sq * d * es + 2 * b * hkv * visible_keys * d * es
    nflops = 4 * d * causal_pairs
    targs, tkw = twin_args or args, twin_kw or kw
    err = _hold_attention(torch, what + twin_note, targs, tkw)
    tkw = {a: x for a, x in tkw.items() if a != "n_splits"}
    plain_a = _time_ms(torch, lambda: ref.flash_attention_ref(*targs, **tkw), 2)
    ms_a = _time_ms(torch, lambda: flash_attention_cuda(*args, **kw), reps)
    lib_a = _time_ms(torch, sdpa, reps)
    lib_b = _time_ms(torch, sdpa, reps)
    ms_b = _time_ms(torch, lambda: flash_attention_cuda(*args, **kw), reps)
    plain_b = _time_ms(torch, lambda: ref.flash_attention_ref(*targs, **tkw), 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nflops / H100_BF16_FLOPS * 1e3
    row = {"ms": min(ms_a, ms_b), "plain_ms": min(plain_a, plain_b),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": min(lib_a, lib_b), "max_abs_err_here": err}
    library = f"library_ms={row['library_ms']:.6f} (scaled_dot_product_attention, enable_gqa)"
    if not sdpa_is_library:
        row["sdpa_no_cap_ms"], row["library_ms"] = row["library_ms"], None
        library = (f"library_ms=none (no cap in SDPA); scaled_dot_product_attention without "
                   f"the cap{', the window as a mask' if kw.get('window') else ''}: "
                   f"{row['sdpa_no_cap_ms']:.6f} ms")
    print(f"kernel flash_attention at {what}: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
          f"{kw} ms={row['ms']:.6f} (runs {ms_a:.6f} {ms_b:.6f}) plain_ms={row['plain_ms']:.6f}"
          f"{twin_note} {library} bound_ms={row['bound_ms']:.6f} "
          f"({row['bound_by']}: {nbytes} B, {nflops} FLOP) "
          f"achieved {nflops / row['ms'] / 1e9:.3f} TFLOP/s {nbytes / row['ms'] / 1e9:.3f} TB/s")
    return row


def lm_serve(torch, np, seed: int) -> dict:
    """The lm_serve requests at full width in bfloat16: 8 prompts of 256-2048
    ids, 64 greedy tokens each, cache of 4,096; flash_attention must launch
    once per layer per forward."""
    from repro_torch.configs.qwen2_1_5b import config
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ServeEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer.from_config(config(), device=DEV, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"lm qwen2-1.5b init_s={time.perf_counter() - t0:.3f} params={n_params} "
          f"bytes={sum(p.numel() * p.element_size() for p in model.parameters())}")
    rng = np.random.default_rng(seed + 4)
    prompts = _prompts(np, rng, 8, *LM_PROMPT_LENS, model.cfg.vocab)
    plen = max(len(p) for p in prompts)
    eng = ServeEngine(model, max_len=LM_MAX_LEN)
    eng.generate(prompts, max_new_tokens=2)  # warm-up: cuBLAS handles, allocator
    counts, res = _served_counts(torch, lambda: eng.generate(prompts,
                                                             max_new_tokens=LM_NEW_TOKENS))
    want = model.cfg.n_layers * (1 + LM_NEW_TOKENS)
    # every decode forward sees at least 257 keys in 16 (batch, kv head)
    # pairs, so the plan splits it and the merge runs once a layer
    want_merge = model.cfg.n_layers * LM_NEW_TOKENS
    print(f"launches flash_attention {counts['flash_attention']} (lm_serve; expected {want}) "
          f"flash_attention_combine {counts['flash_attention_combine']} (expected {want_merge})")
    if counts["flash_attention"] != want:
        _fail(f"lm_serve launched flash_attention {counts['flash_attention']} times, not {want}")
    if counts["flash_attention_combine"] != want_merge:
        _fail(f"lm_serve launched flash_attention_combine {counts['flash_attention_combine']} "
              f"times, not {want_merge}")
    if res.tokens.shape != (8, LM_NEW_TOKENS) or not (res.n_generated == LM_NEW_TOKENS).all():
        _fail("lm_serve did not generate 64 tokens for each of its 8 requests")
    real = sum(len(p) for p in prompts)
    print(f"lm_serve B=8 prompt_lens={[len(p) for p in prompts]} padded_len={plen} "
          f"max_len={LM_MAX_LEN} new_tokens={LM_NEW_TOKENS} prefill_ms={res.prefill_ms:.6f} "
          f"prefill_tokens_per_s={real / res.prefill_ms * 1e3:.1f} (real) "
          f"{8 * plen / res.prefill_ms * 1e3:.1f} (padded) "
          f"decode_ms_per_token={res.decode_ms_per_token:.6f} "
          f"decode_tokens_per_s={8 / res.decode_ms_per_token * 1e3:.1f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")

    # the kernel path against the twin path on the same batch
    tokens = _padded(torch, prompts)
    l_k, cache = model.prefill_step(tokens, max_len=LM_MAX_LEN)
    with _Twins():
        l_t, _ = model.prefill_step(tokens, max_len=LM_MAX_LEN)
    _hold_lm_bf16(torch, "lm_serve prefill", lambda: model.prefill_step(
        tokens, max_len=LM_MAX_LEN)[0], l_k, l_t)
    with _Twins():
        twin = eng.generate(prompts, max_new_tokens=LM_NEW_TOKENS)
    agree = float((twin.tokens == res.tokens).mean())
    differ = twin.tokens != res.tokens
    first = [int(np.argmax(row)) if row.any() else None for row in differ]
    print(f"lm_serve kernel vs twin path: greedy tokens agreeing={agree:.4f} "
          f"first disagreement per request={first}")

    # one decode step under the profiler
    cur = torch.argmax(l_k, dim=-1)
    wall, dev, avgs = _profile(torch, lambda: model.decode_step(cache, cur, plen))
    print(f"device busy lm_serve decode step: wall_s={wall:.6f} kernel_s={dev:.6f} "
          f"busy_share={dev / wall if dev > 0 else 'not measured'}")
    print(f"lm_serve decode step kernels by device time: {_top_kernels(avgs)}")

    # the kernel's row at one layer of the lm_serve prefill
    args, kw = _capture_attention(lambda: model.prefill_step(tokens, max_len=LM_MAX_LEN))
    q, k, v = args
    qs = q.contiguous()
    ks, vs = (x[:, :, :plen].contiguous() for x in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                                enable_gqa=True)

    _check_yardstick(torch, sdpa, args, kw, "lm_serve prefill")
    row = _time_attention(torch, "lm_serve prefill, one layer", args, kw, plen,
                          8 * model.cfg.n_heads * plen * (plen + 1) // 2, sdpa)
    del model, cache, l_k, l_t, args, q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    return {"row": row, "launches": counts["flash_attention"],
            "merges": counts["flash_attention_combine"],
            "rowwise": counts["flash_attention_combine_rowwise"]}


PREFILL_32K_TWIN_ROWS = 512  # the twin's score tensor over all 32,768 rows would be 206 GB


def prefill_32k(torch, np, seed: int) -> dict:
    """prefill_32k: one prefill_step of 32,768 tokens per sequence."""
    from repro_torch.launch.steps import build_cell

    torch.cuda.reset_peak_memory_stats()
    cell = build_cell("qwen2-1.5b", "prefill_32k", seed=seed, batch=PREFILL_32K_BATCH)
    (tokens,) = cell.args
    b, s = tokens.shape
    torch.cuda.synchronize()
    times = []
    for i in range(2):
        t0 = time.perf_counter()
        if i == 0:
            counts, (logits, _) = _served_counts(torch, cell.run)
        else:
            logits, _ = cell.run()
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if logits.shape != (b, cell.model.cfg.vocab) or not bool(torch.isfinite(logits).all()):
        _fail("prefill_32k logits are not finite")
    if counts["flash_attention"] != cell.model.cfg.n_layers or counts["flash_attention_combine"]:
        _fail(f"prefill_32k launched flash_attention {counts['flash_attention']} times and "
              f"its merge {counts['flash_attention_combine']} times")
    print(f"prefill_32k B={b} S={s} (batch cut from 32) runs_s={[round(t, 6) for t in times]} "
          f"tokens_per_s={b * s / min(times):.1f} launches flash_attention="
          f"{counts['flash_attention']} max_memory_allocated={torch.cuda.max_memory_allocated()}")

    # the kernel's row at one prefill_32k layer; the twin on the last rows
    args, kw = _capture_attention(cell.run)
    q, k, v = args
    n_heads = cell.model.cfg.n_heads
    qs = q.contiguous()
    ks, vs = (x[:, :, :s].contiguous() for x in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                                enable_gqa=True)

    _check_yardstick(torch, sdpa, args, kw, "prefill_32k")
    last = PREFILL_32K_TWIN_ROWS
    row = _time_attention(torch, "prefill_32k, one layer", args, kw, s,
                          b * n_heads * s * (s + 1) // 2, sdpa,
                          twin_args=(q[:, :, s - last:], k, v),
                          twin_kw={**kw, "q_offset": s - last},
                          twin_note=f" (twin on the last {last} of {s} query rows)", reps=3)
    attn_s = row["ms"] * cell.model.cfg.n_layers / 1e3
    print(f"prefill_32k attention share: {cell.model.cfg.n_layers} layers x {row['ms']:.6f} ms "
          f"= {attn_s:.6f} s of a {min(times):.6f} s prefill ({attn_s / min(times):.4f})")
    del cell, logits, tokens, args, q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    return {"row": row, "launches": counts["flash_attention"], "attention_share":
            attn_s / min(times), "step_s": min(times)}


def decode_32k(torch, np, seed: int) -> dict:
    """decode_32k: one decode_step per sequence at cur_index 32,767 against
    a cache of 32,768 positions, filled on the card from the seed."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, planned_splits
    from repro_torch.launch.steps import build_cell

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = build_cell("qwen2-1.5b", "decode_32k", seed=seed, batch=DECODE_32K_BATCH)
    torch.cuda.synchronize()
    model = cell.model
    cache, tokens, index = cell.args
    cache_bytes = sum(c.numel() * c.element_size() for c in cache)
    print(f"decode_32k B={tokens.shape[0]} (batch cut from 128) cache {tuple(cache[0].shape)} "
          f"x2 {cache[0].dtype} cache_bytes={cache_bytes} init_s={time.perf_counter() - t0:.3f}")
    counts, (logits, _) = _served_counts(torch, cell.run)
    args, kw = _capture_attention(cell.run)
    plan = planned_splits(*args[:2], **kw)
    want_merge = model.cfg.n_layers if plan > 1 else 0
    print(f"decode_32k launches flash_attention {counts['flash_attention']} "
          f"flash_attention_combine {counts['flash_attention_combine']} (n_splits {plan}, "
          f"expected {want_merge})")
    if counts["flash_attention"] != model.cfg.n_layers:
        _fail(f"decode_32k launched flash_attention {counts['flash_attention']} times")
    if counts["flash_attention_combine"] != want_merge:
        _fail(f"decode_32k launched flash_attention_combine {counts['flash_attention_combine']} "
              f"times, not {want_merge}")
    if logits.shape != (tokens.shape[0], model.cfg.vocab) or not bool(torch.isfinite(logits).all()):
        _fail("decode_32k logits are not finite")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        cell.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"decode_32k ms_per_step_median={float(np.median(times)) * 1e3:.6f} "
          f"steps_ms={[round(t * 1e3, 6) for t in times]} "
          f"tokens_per_s={tokens.shape[0] / float(np.median(times)):.1f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")

    # the kernel path against the twin path on the first 2 sequences
    sub = tuple(c[:, :2] for c in cache)
    l_k, _ = model.decode_step(sub, tokens[:2], index)
    with _Twins():
        l_t, _ = model.decode_step(sub, tokens[:2], index)
    _hold_lm_bf16(torch, "decode_32k first 2 sequences",
                  lambda: model.decode_step(sub, tokens[:2], index)[0], l_k, l_t)
    print(f"decode_32k kernel vs twin path: greedy equal="
          f"{bool(torch.equal(l_k.argmax(-1), l_t.argmax(-1)))}")

    wall, dev, avgs = _profile(torch, cell.run)
    print(f"device busy decode_32k step: wall_s={wall:.6f} kernel_s={dev:.6f} "
          f"busy_share={dev / wall if dev > 0 else 'not measured'}")
    print(f"decode_32k step kernels by device time: {_top_kernels(avgs)}")

    # the kernel's row at one decode_32k layer; the twin on 8 sequences,
    # with the kernel split as planned for all of them (the plan of 8 alone
    # differs), and the timed call's first 8 outputs held against that
    q, k, v = args
    s = index + 1
    qs = q.contiguous()
    ks, vs = (x[:, :, :s].contiguous() for x in (k, v))
    part = tuple(x[:8] for x in args)
    full = flash_attention_cuda(*args, **kw)[:8].float()
    alone = flash_attention_cuda(*part, **kw, n_splits=plan).float()
    same = bool(torch.equal(full, alone))
    print(f"decode_32k one layer: the call on all {q.shape[0]} sequences (n_splits {plan}) vs "
          f"the call on 8 split {plan} ways: max_abs_err={_logit_err(full, alone)} "
          f"bitwise_equal={same}")
    if not _close_scaled(torch, full, alone, "bfloat16"):
        _fail("decode_32k: the call's first 8 sequences differ from the same call on 8")
    del full, alone

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)

    _check_yardstick(torch, sdpa, args, kw, "decode_32k")
    row = _time_attention(torch, "decode_32k, one layer", args, kw, s,
                          q.shape[0] * model.cfg.n_heads * s, sdpa, twin_args=part,
                          twin_kw={**kw, "n_splits": plan},
                          twin_note=f" (twin on 8 of the {q.shape[0]} sequences, the kernel "
                                    f"split {plan} ways as planned for all)")
    sweep = _split_sweep(torch, args, kw, plan)
    merge = _time_merge(torch, args, kw, plan)
    del cell, model, cache, sub, args, part, q, k, v, qs, ks, vs, logits, l_k, l_t
    torch.cuda.empty_cache()
    return {"row": row, "launches": counts["flash_attention"], "n_splits": plan,
            "sweep": sweep, "merge": merge, "merges": counts["flash_attention_combine"]}


def _split_sweep(torch, args, kw, plan: int) -> dict:
    """ms of one decode_32k layer at 1, half the plan, the plan and twice
    it; each output is held against the planned one (the splits only
    reorder float32 sums)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    base = flash_attention_cuda(*args, **kw).float()
    out = {}
    for n in sorted({1, max(1, plan // 2), plan, 2 * plan}):
        got = flash_attention_cuda(*args, **kw, n_splits=n).float()
        rtol, scaled = ATTN_MAIN_TOL["bfloat16"]
        if not torch.allclose(got, base, rtol=rtol, atol=scaled * float(base.abs().max())):
            _fail(f"decode_32k split {n} ways differs from the planned {plan}")
        out[n] = _time_ms(torch, lambda: flash_attention_cuda(*args, **kw, n_splits=n), 10)
    print(f"decode_32k one layer by n_splits (planned {plan}): "
          + " ".join(f"{n}={ms:.6f}ms" for n, ms in out.items()))
    return {str(n): ms for n, ms in out.items()}


def _time_merge(torch, args, kw, plan: int) -> dict:
    """The merge at one decode_32k layer, on the twin's partials of that
    call (:func:`_merge_turns`)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import pack_partials

    q, k = args[0], args[1]
    chunks = [ref.flash_attention_partials_ref(*(x[i:i + 8] for x in args), n_splits=plan, **kw)
              for i in range(0, q.shape[0], 8)]  # 8 sequences at a time: the cache fills the card
    packed = pack_partials(*(torch.cat([c[j] for c in chunks], dim=1) for j in range(3)))
    del chunks
    return _merge_turns(torch, packed, torch.empty_like(q), k.shape[1], plan, "decode_32k")


# The merge into a float32 output against the twin's float32 merge: the same
# float32 partials summed in another order (the kernel's groups and chunks).
MERGE_F32_RTOL = 1e-5       # rtol, and atol as a share of the largest |want|
MERGE_REPS = 20             # launches a profiled turn
MERGE_TRACES = 4            # profiles a reading tries: a trace may hold none of its launches
MERGE_SWEEP = (1, 2, 4, 8, 16, 32, 64)  # chunks timed at long_500k beside the plan's


def _unpack_partials(part, n_splits: int, b: int, hkv: int, rows: int, d: int) -> tuple:
    """(m, l, acc) views of flat partials in pack_partials' layout."""
    k = n_splits * b * hkv * rows
    shape = (n_splits, b, hkv, rows)
    return part[k * d:k * d + k].view(shape), part[k * d + k:].view(shape), \
        part[:k * d].view(*shape, d)


def _kernel_partials(torch, args, kw):
    """(part, n_splits): the float32 partials that the attention kernel
    writes for the call (args, kw), copied at its merge; None where the call
    does not split."""
    from repro_torch.kernels import flash_attention as fa

    seen = {}
    real = fa._launch_combine

    def record(part, out, hkv, n_splits, chunks=None):
        seen["part"], seen["n"] = part.clone(), n_splits
        return real(part, out, hkv, n_splits, chunks)

    fa._launch_combine = record
    try:
        fa.flash_attention_cuda(*args, **kw)
        torch.cuda.synchronize()
    finally:
        fa._launch_combine = real
    return (seen["part"], seen["n"]) if seen else None


def _merge_device_ms(torch, fn, key: str, reps: int = MERGE_REPS):
    """Device ms a launch of the kernels whose name holds ``key`` over reps
    calls of fn (profiler: a merge takes less device time than the wrapper
    takes to issue it), from the first of MERGE_TRACES profiles that holds
    any of them; None if none does."""
    fn()
    torch.cuda.synchronize()
    for _ in range(MERGE_TRACES):
        _, _, avgs = _profile(torch, lambda: [fn() for _ in range(reps)])
        hits = [e for e in avgs if key in e.key]
        n = sum(e.count for e in hits)
        if n:
            return sum(getattr(e, "self_device_time_total", 0) for e in hits) / n / 1e3
    return None


def _merge_turns(torch, part, out, hkv: int, n_splits: int, what: str) -> dict:
    """Both merges on one call's float32 partials. The path's
    (``flash_attention_combine``, planned) against the twin's merge within
    ATTN_MAIN_TOL in out's dtype and, into a float32 output, within
    MERGE_F32_RTOL of the twin's float32 merge; a second launch bit for bit;
    a control that must fail (row 0 without the splits of one chunk: the
    plan's middle one, or the row's second half where the plan keeps it
    whole); the first merge (``flash_attention_combine_rowwise``, off the
    path) against the twin. Then the two timed in turns (path, rowwise,
    rowwise, path; device time a launch, profiler), beside the twin's time
    and the bound (the partials read once, o written once)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_sm_count, flash_attention_combine_cuda,
                                                     flash_attention_combine_rowwise_cuda,
                                                     pack_partials, plan_merge)

    b, hq, sq, d = out.shape
    group, name = hq // hkv, str(out.dtype).split(".")[-1]
    m, l, acc = _unpack_partials(part, n_splits, b, hkv, sq * group, d)
    chunks = plan_merge(b * hq * sq, n_splits, d, _sm_count(out.device))
    want = ref.flash_attention_combine_ref(m, l, acc, group, out.dtype).float()
    want32 = ref.flash_attention_combine_ref(m, l, acc, group, torch.float32)
    got = flash_attention_combine_cuda(part, torch.empty_like(out), hkv, n_splits)
    again = flash_attention_combine_cuda(part, torch.empty_like(out), hkv, n_splits)
    got32 = flash_attention_combine_cuda(part, torch.empty_like(out, dtype=torch.float32), hkv,
                                         n_splits)
    old = flash_attention_combine_rowwise_cuda(part, torch.empty_like(out), hkv, n_splits)
    cut = max(chunks, 2)
    lo, hi = ref.merge_chunks(n_splits, cut)[cut // 2]
    m2, l2, acc2 = m.clone(), l.clone(), acc.clone()
    m2[lo:hi, 0, 0, 0], l2[lo:hi, 0, 0, 0], acc2[lo:hi, 0, 0, 0] = ref.NEG_INF, 0.0, 0.0
    ctrl = flash_attention_combine_cuda(pack_partials(m2, l2, acc2), torch.empty_like(out), hkv,
                                        n_splits)
    torch.cuda.synchronize()
    atol32 = MERGE_F32_RTOL * float(want32.abs().max())
    res = {"n_splits": n_splits, "chunks": chunks, "rows": b * hq * sq,
           "max_abs_err_here": _logit_err(got, want), "err_float32": _logit_err(got32, want32),
           "atol_float32": atol32, "repeat_equal": bool(torch.equal(got, again)),
           "err_control": _logit_err(ctrl, want), "control_splits_dropped": [lo, hi],
           "control_passes": _close_scaled(torch, ctrl, want, name)}
    err_old = _logit_err(old, want)
    print(f"flash_attention_combine at {what}: {n_splits} splits x {b * hq * sq} rows, D={d}, "
          f"{chunks} chunks a row (plan_merge); vs the twin's merge max_abs_err="
          f"{res['max_abs_err_here']} (ATTN_MAIN_TOL {name}); into float32 max_abs_err="
          f"{res['err_float32']} (rtol {MERGE_F32_RTOL}, atol {atol32}); second launch "
          f"bit-identical={res['repeat_equal']}; control (row 0 without splits {lo}..{hi - 1}) "
          f"max_abs_err={res['err_control']} passes={res['control_passes']}; rowwise merge "
          f"max_abs_err={err_old}")
    if not _close_scaled(torch, got, want, name) or not torch.allclose(
            got32, want32, rtol=MERGE_F32_RTOL, atol=atol32):
        _fail(f"flash_attention_combine differs from the twin's merge at {what}")
    if not _close_scaled(torch, old, want, name):
        _fail(f"flash_attention_combine_rowwise differs from the twin's merge at {what}")
    if not res["repeat_equal"]:
        _fail(f"two flash_attention_combine launches on the same partials differ at {what}")
    if res["control_passes"]:
        _fail(f"the merge control (a chunk of row 0 left out) passed at {what}")
    del got, again, got32, old, ctrl, m2, l2, acc2
    turns = {"merge_kernel": [], "combine_kernel": []}
    runs = {"merge_kernel": lambda: flash_attention_combine_cuda(part, out, hkv, n_splits),
            "combine_kernel": lambda: flash_attention_combine_rowwise_cuda(part, out, hkv,
                                                                          n_splits)}
    for key in ("merge_kernel", "combine_kernel", "combine_kernel", "merge_kernel"):
        turns[key].append(_merge_device_ms(torch, runs[key], key))
    issue = {k: _time_ms(torch, fn, MERGE_REPS) for k, fn in runs.items()}
    ms = {k: min([x for x in v if x is not None], default=issue[k]) for k, v in turns.items()}
    plain = min(_time_ms(torch, lambda: ref.flash_attention_combine_ref(
        m, l, acc, group, out.dtype), 3) for _ in range(2))
    nbytes = part.numel() * 4 + out.numel() * out.element_size()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    res.update({"ms": ms["merge_kernel"], "plain_ms": plain, "bound_ms": bound,
                "bound_by": "bytes", "library_ms": None,
                "share_of_bound": bound / ms["merge_kernel"],
                "ms_turns": turns["merge_kernel"], "ms_issue_bound": issue["merge_kernel"],
                "rowwise": {"ms": ms["combine_kernel"], "ms_turns": turns["combine_kernel"],
                            "ms_issue_bound": issue["combine_kernel"],
                            "max_abs_err_here": err_old}})
    if None in turns["merge_kernel"] + turns["combine_kernel"]:
        print("flash_attention_combine: the profiler traced no launch in a turn; ms there is "
              "the events' figure over back-to-back calls, an upper bound")
    print(f"kernel flash_attention_combine at {what}: ms={ms['merge_kernel']} (device time a "
          f"launch, profiler; turns {turns['merge_kernel']}) against the rowwise merge "
          f"ms={ms['combine_kernel']} (turns {turns['combine_kernel']}; path, rowwise, rowwise, "
          f"path) plain_ms={plain:.6f} bound_ms={bound:.6f} (bytes: {nbytes} B) share of bound "
          f"{res['share_of_bound']:.4f}; events over {MERGE_REPS} back-to-back calls {issue}")
    return res


def _merge_sweep(torch, part, out, hkv: int, n_splits: int, what: str) -> dict:
    """Device ms a launch of the merge at each chunk count of MERGE_SWEEP
    that it takes and the plan's, each output held against the plan's within
    ATTN_MAIN_TOL (the chunks only reorder float32 sums)."""
    from repro_torch.kernels.flash_attention import (MERGE_MAX_SPLITS, _sm_count,
                                                     flash_attention_combine_cuda, plan_merge)

    b, hq, sq, d = out.shape
    plan = plan_merge(b * hq * sq, n_splits, d, _sm_count(out.device))
    base = flash_attention_combine_cuda(part, torch.empty_like(out), hkv, n_splits).float()
    res = {}
    for c in sorted({*MERGE_SWEEP, plan}):
        if c > n_splits or -(-n_splits // c) > MERGE_MAX_SPLITS:
            continue
        got = flash_attention_combine_cuda(part, out, hkv, n_splits, chunks=c)
        if not _close_scaled(torch, got, base, str(out.dtype).split(".")[-1]):
            _fail(f"the merge in {c} chunks differs from the plan's {plan} at {what}")
        res[c] = _merge_device_ms(torch, lambda c=c: flash_attention_combine_cuda(
            part, out, hkv, n_splits, chunks=c), "merge_kernel")
    print(f"flash_attention_combine at {what} by chunks a row (plan {plan}; device ms a launch, "
          f"profiler): " + " ".join(f"{c}={v}" for c, v in res.items()))
    return {str(c): v for c, v in res.items()}


def _zoo_merge(torch, arch: str, run):
    """Both merges at the cell's first attention layer, on the attention
    kernel's own partials (:func:`_merge_turns`); None where it does not
    split."""
    args, kw = _capture_attention(run)
    got = _kernel_partials(torch, args, kw)
    if got is None:
        return None
    return _merge_turns(torch, got[0], torch.empty_like(args[0]), args[1].shape[1], got[1],
                        f"lm zoo {arch} decode_32k layer 0")


def _mma_counts(source: str) -> dict:
    """Tensor-core instructions (HMMA: mma.sync, HGMMA: wgmma) in each
    kernel of csrc/<source>.cu's build, counted in its SASS by cuobjdump
    (static counts, not executions); empty where the toolkit has no
    cuobjdump."""
    import re
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("cuobjdump not found: tensor-core instruction counts not measured")
        return {}
    sass = subprocess.run([tool, "-sass", str(_build._target(source))], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        sym = fn.split()[0]
        name = re.search(r"\d([a-z_]+_kernel)I(\w+?)EEv", sym)
        if name:
            targs = re.findall(r"Li(\d+)E", name.group(2)) or [name.group(2).lstrip("0123456789")]
            key = f"{name.group(1)}<{', '.join(targs)}>"
        else:
            key = sym
        out[key] = {"HMMA": len(re.findall(r"\bHMMA\.", fn)),
                    "HGMMA": len(re.findall(r"\bHGMMA\.", fn))}
    print(f"tensor-core instructions in {source}.cu by kernel (SASS, static): {out}")
    return out


def drive_lm(torch, np, seed: int, errs: dict) -> list:
    """Phase 7: qwen2-1.5b serving at full width, after the DLRM tables are
    freed: the small model against the host, the float32 model's kernel path
    against its twin path, lm_serve, prefill_32k and decode_32k; then phase
    7b, the rest of the LM zoo (:func:`drive_lm_zoo`); returns the
    flash_attention rows of the kernels line."""
    left = torch.cuda.memory_allocated()
    print(f"lm phases start with memory_allocated={left}")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated after the DLRM phase")
    mma = _mma_counts("flash_attention")
    lm_vs_host(torch, np, seed)
    lm_float32_full_width(torch, np, seed)
    serve = lm_serve(torch, np, seed)
    pre = prefill_32k(torch, np, seed)
    dec = decode_32k(torch, np, seed)
    zoo = drive_lm_zoo(torch, np, seed)
    zoo_rows = {arch: {**z["decode_32k"]["rows"], **(z["prefill_32k"] or {}).get("rows", {})}
                for arch, z in zoo.items()}
    zoo_errs = [r["max_abs_err_here"] for rows in zoo_rows.values() for r in rows.values()]
    err = errs["flash_attention"]
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:86",
           "launches": serve["launches"],
           "max_abs_err": max(err["float32"], err["bfloat16"], serve["row"]["max_abs_err_here"],
                              pre["row"]["max_abs_err_here"], dec["row"]["max_abs_err_here"],
                              *zoo_errs),
           "max_abs_err_float32": err["float32"],
           **serve["row"], "shape": "lm_serve prefill, one layer",
           "decode_32k": {**dec["row"], "shape": f"decode_32k, one layer, B={DECODE_32K_BATCH}",
                          "n_splits": dec["n_splits"], "ms_by_n_splits": dec["sweep"]},
           "prefill_32k": {**pre["row"], "shape": f"prefill_32k, one layer, "
                           f"B={PREFILL_32K_BATCH}", "attention_share": pre["attention_share"]},
           "launches_prefill_32k": pre["launches"], "launches_decode_32k": dec["launches"],
           "launches_combine_lm_serve": serve["merges"],
           "launches_combine_decode_32k": dec["merges"], "sass_mma": mma,
           "lm_zoo": {arch: {
               "launches_lm_serve": z["lm_serve"]["launches"],
               "launches_combine_lm_serve": z["lm_serve"]["merges"],
               "launches_prefill_32k": (z["prefill_32k"] or {}).get("launches"),
               "launches_decode_32k": z["decode_32k"]["launches"],
               "launches_combine_decode_32k": z["decode_32k"]["merges"],
               **zoo_rows[arch]} for arch, z in zoo.items()}}
    zoo_merges = {arch: z["decode_32k"]["merge"] for arch, z in zoo.items()
                  if z["decode_32k"]["merge"] is not None}
    dm = {k: v for k, v in dec["merge"].items() if k != "rowwise"}
    merge = {"name": "flash_attention_combine", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:86",
             "launches": serve["merges"],
             **dm, "max_abs_err": max(err["combine"], dm["max_abs_err_here"],
                                      *(z["max_abs_err_here"] for z in zoo_merges.values())),
             "shape": f"decode_32k, one layer, B={DECODE_32K_BATCH}, {dec['n_splits']} splits",
             "launches_decode_32k": dec["merges"],
             "lm_zoo": {arch: {k: v for k, v in z.items() if k != "rowwise"}
                        for arch, z in zoo_merges.items()}}
    old = dec["merge"]["rowwise"]
    rowwise = {"name": "flash_attention_combine_rowwise", "route": "cuda",
               "source": "src/repro_torch/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:86",
               "launches": serve["rowwise"],
               "max_abs_err": max(err["combine_rowwise"], old["max_abs_err_here"],
                                  *(z["rowwise"]["max_abs_err_here"]
                                    for z in zoo_merges.values())),
               "ms": old["ms"], "plain_ms": dm["plain_ms"], "bound_ms": dm["bound_ms"],
               "bound_by": "bytes", "library_ms": None, "ms_turns": old["ms_turns"],
               "shape": merge["shape"] + " (off the path: timed in turns beside the merge)",
               "lm_zoo": {arch: z["rowwise"] for arch, z in zoo_merges.items()}}
    return [row, merge, rowwise]


# Phase 7b: the rest of the LM zoo at full width, one arch at a time, each
# freed before the next. f32_layers / layers: the depth of the float32
# kernel-vs-twin model and of the bfloat16 model on the card (None: all);
# f32_prompt: ids of the float32 check's one prompt; serve: lm_serve
# requests, of which twin_batch go through the twin comparisons (the twin's
# materialised scores of yi's 56 and phi's 32 heads beside 63-69 GB of
# weights); grouped: MoE, so the longest prompt is exactly 2,048 ids (B *
# plen a multiple of moe_group); prefill / decode: the cells' batches (None:
# no cell); rows: the layers whose flash_attention row is timed, by cell.
ZOO = (
    dict(arch="gemma2-9b", f32_layers=8, f32_prompt=4608, serve=8, twin_batch=8,
         grouped=False, prefill=2, decode=4, layers=None,
         rows={"prefill_32k": (0, 1), "decode_32k": (0, 1)}),
    dict(arch="olmoe-1b-7b", f32_layers=8, f32_prompt=2048, serve=8, twin_batch=8,
         grouped=True, prefill=2, decode=12, layers=None, rows={}),
    dict(arch="yi-34b", f32_layers=4, f32_prompt=2048, serve=4, twin_batch=2, grouped=False,
         prefill=1, decode=1, layers=None, rows={"decode_32k": (0,)}),
    dict(arch="phi3.5-moe-42b-a6.6b", f32_layers=4, f32_prompt=2048, serve=8, twin_batch=2,
         grouped=True, prefill=None, decode=2, layers=24, rows={}),
)
ZOO_F32_NEW = 8           # greedy tokens of the float32 kernel-vs-twin check (16 until 7c)
ZOO_NEW_TOKENS = 32       # the zoo's lm_serve tokens a request (LM_NEW_TOKENS, 64, until 7c)
# The MoE layer's router logits, card against host CPU (``moe_logits``):
# each a bfloat16 rounding of a float32 sum taken in another order, so
# equal or one bfloat16 step (2**-7 relative at most) apart; near zero a
# bfloat16 step is finer than the two float32 sums' own difference (about
# 1e-7 over 2,048-4,096 products), so an atol of 2**-16 of the largest
# |logit| takes that.
ROUTER_LOGIT_RTOL = 2.0 ** -7
ROUTER_LOGIT_SCALED = 2.0 ** -16


def _zoo_cfg(arch: str, layers=None, dtype=None):
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(arch).config()
    if layers is not None:
        cfg = replace(cfg, n_layers=layers)
    return cfg if dtype is None else replace(cfg, dtype=dtype)


def _paths_bf16(torch, what: str, run) -> tuple:
    """run() on the kernel path, recording any MoE routing, then on the twin
    path replaying it, held by :func:`_hold_lm_bf16` with the limit set by
    the witness; returns (kernel, twin) logits."""
    with _Routes() as rec:
        l_k = run()
    with _Twins(), _Routes(rec.log) as rep:
        l_t = run()
    _hold_lm_bf16(torch, what, run, l_k, l_t, rec.log or None, rep.flips, by_witness=True)
    return l_k, l_t


def zoo_vs_host(torch, np, seed: int, arch: str) -> None:
    """The arch's reduced config from the same numpy weights on the card,
    through the kernel, and on the host CPU, through the twin: logits
    within 1e-4 and greedy tokens equal (64 prompt tokens: one MoE group)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ServeEngine

    cfg = get_arch(arch).reduced()
    params = _lm_params(np, cfg, seed)
    host = Transformer.from_numpy_params(params, cfg, device="cpu")
    card = Transformer.from_numpy_params(params, cfg, device=DEV)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
    err = _logit_err(card.forward_logits(tokens.to(DEV)).cpu(), host.forward_logits(tokens))
    if err > 1e-4:
        _fail(f"small {arch} on the card differs from the host CPU (max abs err {err})")
    prompts = _prompts(np, rng, 4, 3, 16, cfg.vocab)
    got = ServeEngine(card, max_len=64).generate(prompts, max_new_tokens=24)
    want = ServeEngine(host, max_len=64).generate(prompts, max_new_tokens=24)
    if not np.array_equal(got.tokens, want.tokens):
        _fail(f"small {arch} greedy tokens on the card differ from the host CPU's")
    print(f"lm zoo {arch} small model ({cfg.name}) card vs host CPU: forward_logits "
          f"max_abs_err={err} tol=1e-4; greedy tokens equal over {got.tokens.shape} = True")


def zoo_float32(torch, np, seed: int, spec: dict) -> None:
    """The arch at full width in float32 (spec's depth): the kernel path
    against the twin path on one prompt of f32_prompt ids, logits within
    LM_F32_TOL and ZOO_F32_NEW greedy tokens equal; MoE routing replayed
    from the kernel path, the flips counted."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ServeEngine

    torch.cuda.reset_peak_memory_stats()
    cfg = _zoo_cfg(spec["arch"], spec["f32_layers"], "float32")
    model = Transformer.from_config(cfg, device=DEV, seed=seed)
    n = spec["f32_prompt"]
    tokens = torch.from_numpy(np.random.default_rng(seed + 3).integers(0, cfg.vocab, (1, n)))
    tokens = tokens.to(DEV)
    with _Routes() as rec:
        l_k = model.prefill_step(tokens, max_len=n + ZOO_F32_NEW)[0]
    with _Twins(), _Routes(rec.log) as rep:
        l_t = model.prefill_step(tokens, max_len=n + ZOO_F32_NEW)[0]
    err = _logit_err(l_k, l_t)
    if not torch.allclose(l_k, l_t, **LM_F32_TOL):
        _fail(f"float32 {cfg.name}: kernel path logits differ from the twin path's ({err})")
    eng = ServeEngine(model, max_len=n + ZOO_F32_NEW)
    with _Routes() as rec:
        got = eng.generate(tokens.cpu().tolist(), max_new_tokens=ZOO_F32_NEW)
    with _Twins(), _Routes(rec.log) as rep_g:
        want = eng.generate(tokens.cpu().tolist(), max_new_tokens=ZOO_F32_NEW)
    if not np.array_equal(got.tokens, want.tokens):
        _fail(f"float32 {cfg.name}: kernel path greedy tokens differ from the twin path's")
    print(f"lm zoo {cfg.name} float32 full width, {cfg.n_layers} layers, prompt {n}: prefill "
          f"logits max_abs_err={err} tol={LM_F32_TOL} logit range [{float(l_k.min()):.4f}, "
          f"{float(l_k.max()):.4f}]; greedy tokens equal over 1 x {ZOO_F32_NEW} = True; "
          f"flipped routings (replayed) prefill {rep.flips} generate {rep_g.flips}; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    del model, l_k, l_t
    torch.cuda.empty_cache()


def _moe_input(run, layer: int = 0):
    """The input x of ``moe_ffn``'s call number ``layer`` in run(), cloned."""
    from repro_torch.models import transformer

    seen, real = [], transformer.moe_ffn

    def spy(x, *a):
        if len(seen) == layer:
            seen.append(x.clone())
        elif len(seen) < layer:
            seen.append(None)
        return real(x, *a)

    transformer.moe_ffn = spy
    try:
        run()
    finally:
        transformer.moe_ffn = real
    return seen[layer]


def zoo_routing(torch, model, layer: int, x) -> dict:
    """One MoE layer on its own bfloat16 input x (one group): the card's
    router logits against the host CPU's within ROUTER_LOGIT_RTOL and
    ROUTER_LOGIT_SCALED; from
    the card's logits copied to the host, the routing (experts, positions,
    drops) equal bit for bit; y, the card's against the host's with the
    card's routing replayed, within ATTN_MAIN_TOL's bfloat16 (rtol 2e-2,
    atol 2**-7 max|y|: the expert products summed in float32 in another
    order, rounded to bfloat16 twice); a control (the capacity cut by one
    below the busiest expert's load) must change the drops."""
    import torch.nn.functional as F

    from repro_torch.models import transformer as tf

    cfg = model.cfg
    w = [getattr(model, n)[layer] for n in ("router", "w_gate_e", "w_up_e", "w_down_e")]
    b, s, d = x.shape
    g = tf.moe_group_size(cfg, b * s)
    c = tf.moe_capacity(cfg, g)
    tokens = x.reshape(-1, g, d)
    lc = tf.moe_logits(tokens, w[0]).cpu()
    lh = tf.moe_logits(tokens.cpu(), w[0].cpu())
    unequal = int((lc != lh).sum())
    atol = ROUTER_LOGIT_SCALED * float(lh.abs().max())
    if not torch.allclose(lc, lh, rtol=ROUTER_LOGIT_RTOL, atol=atol):
        far = (lc - lh).abs() > ROUTER_LOGIT_RTOL * lh.abs() + atol
        _fail(f"{cfg.name}: the card's router logits differ from the host's beyond bfloat16 "
              f"rounding at {int(far.sum())} of {lh.numel()}, e.g. {lc[far][:4].tolist()} "
              f"against {lh[far][:4].tolist()}")
    _, idx_c = tf.moe_route(lc.to(DEV), cfg.top_k)
    _, idx_h = tf.moe_route(lc, cfg.top_k)
    pos_c, pos_h = (tf.moe_positions(i, cfg.n_experts) for i in (idx_c, idx_h))
    if not (torch.equal(idx_c.cpu(), idx_h) and torch.equal(pos_c.cpu(), pos_h)):
        _fail(f"{cfg.name}: the card's routing differs from the host's on the same logits")
    keep = pos_h < c
    with _Routes() as rec:
        y_c, aux_c = tf.moe_ffn(x, *w, cfg)
    with _Routes([i.cpu() for i in rec.log]) as rep:
        y_h, aux_h = tf.moe_ffn(x.cpu(), *(t.cpu() for t in w), cfg)
    y_c = y_c.cpu()
    if not _close_scaled(torch, y_c, y_h, "bfloat16"):
        _fail(f"{cfg.name}: the MoE layer's y on the card differs from the host's "
              f"({_logit_err(y_c, y_h)})")
    load = int(F.one_hot(idx_h, cfg.n_experts).sum((1, 2)).max())
    keep_ctrl = pos_h < min(c, load) - 1
    if torch.equal(keep_ctrl, keep):
        _fail(f"{cfg.name}: the routing comparison does not tell a capacity cut by one")
    print(f"lm zoo {cfg.name} MoE layer {layer} on its own input ({b} x {s} tokens, G={g}, "
          f"C={c}): router logits card vs host max_abs_err={_logit_err(lc, lh)} (unequal "
          f"{unequal} of {lc.numel()}, rtol {ROUTER_LOGIT_RTOL}, atol {atol}); routing idx, pos, keep equal "
          f"bit for bit; drops {int((~keep).sum())} of {keep.numel()} slots, busiest expert "
          f"{load}; y card vs host (card's routing replayed, host's own differs on "
          f"{rep.flips} tokens) max_abs_err={_logit_err(y_c, y_h)} max|y|="
          f"{float(y_h.abs().max())}; aux card {float(aux_c)} host {float(aux_h)}; control "
          f"(capacity {min(c, load) - 1}) drops {int((~keep_ctrl).sum())}: differs = True")
    return {"drops": int((~keep).sum()), "y_err": _logit_err(y_c, y_h)}


def zoo_serve(torch, np, seed: int, spec: dict) -> dict:
    """lm_serve for the arch in bfloat16: ``serve`` prompts of 256-2048 ids
    (grouped archs: the first exactly 2,048), 64 greedy tokens, cache of
    4,096; flash_attention launches once a layer a forward and its merge
    once for each call whose own plan splits; the first twin_batch
    requests' prefill held against the twin path, their greedy tokens
    compared; one decode step profiled; MoE: one layer's routing, card
    against host."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ServeEngine

    arch = spec["arch"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = _zoo_cfg(arch, spec["layers"])
    model = Transformer.from_config(cfg, device=DEV, seed=seed)
    torch.cuda.synchronize()
    print(f"lm zoo {arch} init_s={time.perf_counter() - t0:.3f} layers={cfg.n_layers} "
          f"params={sum(p.numel() for p in model.parameters())} "
          f"bytes={sum(p.numel() * p.element_size() for p in model.parameters())}")
    rng = np.random.default_rng(seed + 4)
    prompts = _prompts(np, rng, spec["serve"], *LM_PROMPT_LENS, cfg.vocab)
    if spec["grouped"]:
        prompts[0] = rng.integers(0, cfg.vocab, LM_PROMPT_LENS[1]).tolist()
    plen = max(len(p) for p in prompts)
    eng = ServeEngine(model, max_len=LM_MAX_LEN)
    eng.generate(prompts, max_new_tokens=2)  # warm-up
    with _Plans() as plans:
        counts, res = _served_counts(torch, lambda: eng.generate(prompts,
                                                                 max_new_tokens=ZOO_NEW_TOKENS))
    want = cfg.n_layers * (1 + ZOO_NEW_TOKENS)
    print(f"launches flash_attention {counts['flash_attention']} (lm zoo {arch} lm_serve; "
          f"expected {want}) flash_attention_combine {counts['flash_attention_combine']} "
          f"(expected {plans.merges()}, the calls whose own plan splits); calls by kind "
          f"and n_splits {plans.by_kind()}")
    if counts["flash_attention"] != want or len(plans.calls) != want:
        _fail(f"{arch} lm_serve launched flash_attention {counts['flash_attention']} times "
              f"({len(plans.calls)} calls), not {want}")
    if counts["flash_attention_combine"] != plans.merges():
        _fail(f"{arch} lm_serve launched flash_attention_combine "
              f"{counts['flash_attention_combine']} times, not {plans.merges()}")
    if res.tokens.shape != (len(prompts), ZOO_NEW_TOKENS) \
            or not (res.n_generated == ZOO_NEW_TOKENS).all():
        _fail(f"{arch} lm_serve did not generate {ZOO_NEW_TOKENS} tokens for each request")
    real = sum(len(p) for p in prompts)
    print(f"lm zoo {arch} lm_serve B={len(prompts)} prompt_lens={[len(p) for p in prompts]} "
          f"padded_len={plen} max_len={LM_MAX_LEN} new_tokens={ZOO_NEW_TOKENS} "
          f"prefill_ms={res.prefill_ms:.6f} prefill_tokens_per_s={real / res.prefill_ms * 1e3:.1f}"
          f" (real) decode_ms_per_token={res.decode_ms_per_token:.6f} decode_tokens_per_s="
          f"{len(prompts) / res.decode_ms_per_token * 1e3:.1f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")

    # the kernel path against the twin path on the first twin_batch requests
    sub = prompts[:spec["twin_batch"]]
    tokens = _padded(torch, sub)
    splen = tokens.shape[1]
    _paths_bf16(torch, f"lm zoo {arch} lm_serve prefill ({len(sub)} requests, cache {splen})",
                lambda: model.prefill_step(tokens, max_len=splen)[0])
    eng_sub = ServeEngine(model, max_len=splen + ZOO_NEW_TOKENS)
    with _Routes() as rec:
        kern = eng_sub.generate(sub, max_new_tokens=ZOO_NEW_TOKENS)
    with _Twins(), _Routes(rec.log) as rep:
        twin = eng_sub.generate(sub, max_new_tokens=ZOO_NEW_TOKENS)
    differ = twin.tokens != kern.tokens
    print(f"lm zoo {arch} lm_serve kernel vs twin path ({len(sub)} requests): greedy tokens "
          f"agreeing={float((~differ).mean()):.4f} first disagreement per request="
          f"{[int(np.argmax(r)) if r.any() else None for r in differ]}; flipped routings "
          f"(replayed) {rep.flips}")

    # one decode step under the profiler
    full = _padded(torch, prompts)
    logits, cache = model.prefill_step(full, max_len=LM_MAX_LEN)
    cur = torch.argmax(logits, dim=-1)
    wall, dev, avgs = _profile(torch, lambda: model.decode_step(cache, cur, plen))
    print(f"device busy lm zoo {arch} lm_serve decode step: wall_s={wall:.6f} "
          f"kernel_s={dev:.6f} busy_share={dev / wall if dev > 0 else 'not measured'}")
    print(f"lm zoo {arch} lm_serve decode step kernels by device time: {_top_kernels(avgs)}")
    del logits, cache
    routing = None
    if cfg.n_experts:
        x = _moe_input(lambda: model.prefill_step(full, max_len=plen))
        routing = zoo_routing(torch, model, 0, x[:1])
        del x
    del model, full, tokens
    torch.cuda.empty_cache()
    return {"launches": counts["flash_attention"], "merges": counts["flash_attention_combine"],
            "prefill_ms": res.prefill_ms, "decode_ms_per_token": res.decode_ms_per_token,
            "busy_share": dev / wall if dev > 0 else None, "routing": routing}


def _zoo_sdpa(torch, args, kw, s: int):
    """One ``scaled_dot_product_attention`` call on the layer's inputs,
    keys cut to the s written ones: causal, no soft-cap; a window goes in
    as a boolean mask, on kv heads expanded to the query heads and the
    memory-efficient backend (the flash backend takes no mask, and the
    math backend's scores at 32k would not fit)."""
    F = torch.nn.functional
    q, k, v = args
    off = kw["q_offset"]
    qs = q.contiguous()
    ks, vs = (x[:, :, :s].contiguous() for x in (k, v))
    window = kw.get("window")
    if window is None:
        if q.shape[2] == 1:
            return lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                      enable_gqa=True)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[1] // k.shape[1]
    ks, vs = (x.repeat_interleave(group, dim=1) for x in (ks, vs))
    i = torch.arange(q.shape[2], device=q.device)[:, None] + off
    j = torch.arange(s, device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)

    def run():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    return run


def _zoo_rows(torch, arch: str, cell: str, run, layers, s: int, twin_rows=None) -> dict:
    """The flash_attention row at the given layers of one cell's forward:
    the kernel against its twin (bfloat16 and float32, the control must
    fail), timed beside the twin and SDPA (without the soft-cap where the
    arch has one: then no library time), with its bound."""
    caps = _capture_layers(run, layers)
    out = {}
    for layer in layers:
        args, kw = caps[layer]
        q, k, _ = args
        b, hq, sq, _ = q.shape
        window = kw.get("window")
        kind = "global" if window is None else "local"
        what = f"lm zoo {arch} {cell} layer {layer} ({kind}), B={b}"
        if sq == 1:
            visible = min(s, window or s)
            pairs = b * hq * visible
        else:
            w = min(window or s, s)
            visible, pairs = s, b * hq * (w * (w + 1) // 2 + (s - w) * w)
        sdpa = _zoo_sdpa(torch, args, kw, s)
        _check_yardstick(torch, sdpa, args, {**kw, "softcap": None}, what + " without the cap")
        twin = {}
        if twin_rows is not None and sq > twin_rows:
            twin = dict(twin_args=(q[:, :, sq - twin_rows:], args[1], args[2]),
                        twin_kw={**kw, "q_offset": sq - twin_rows},
                        twin_note=f" (twin on the last {twin_rows} of {sq} query rows)")
        row = _time_attention(torch, what, args, kw, visible, pairs, sdpa,
                              reps=3 if sq > 1 else 10,
                              sdpa_is_library=kw.get("softcap") is None, **twin)
        out[f"{cell}_layer{layer}_{kind}"] = {**row, "shape": what}
        del args, q, k, sdpa
    del caps
    torch.cuda.empty_cache()
    return out


def zoo_prefill(torch, np, seed: int, spec: dict) -> dict:
    """prefill_32k for the arch through ``build_cell``: one prefill_step of
    32,768 tokens a sequence; flash_attention once a layer, no merge."""
    from repro_torch.launch.steps import build_cell

    arch = spec["arch"]
    torch.cuda.reset_peak_memory_stats()
    cell = build_cell(arch, "prefill_32k", seed=seed, batch=spec["prefill"],
                      layers=spec["layers"])
    n_layers = cell.model.cfg.n_layers
    (tokens,) = cell.args
    b, s = tokens.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Plans() as plans:
        counts, out = _served_counts(torch, cell.run)
    times = [time.perf_counter() - t0]
    peak = torch.cuda.max_memory_allocated()
    logits = out[0]
    del out

    def timed_run():
        t0 = time.perf_counter()
        cell.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    if logits.shape != (b, cell.model.cfg.vocab) or not bool(torch.isfinite(logits).all()):
        _fail(f"{arch} prefill_32k logits are not finite")
    if counts["flash_attention"] != n_layers or len(plans.calls) != n_layers \
            or counts["flash_attention_combine"] or plans.merges():
        _fail(f"{arch} prefill_32k launched flash_attention {counts['flash_attention']} times "
              f"and its merge {counts['flash_attention_combine']} times")
    rows = {}
    if spec["rows"].get("prefill_32k"):  # the rows' capture run is the second timed run
        rows = _zoo_rows(torch, arch, "prefill_32k", timed_run, spec["rows"]["prefill_32k"], s,
                         twin_rows=PREFILL_32K_TWIN_ROWS)
    else:
        timed_run()
    print(f"lm zoo {arch} prefill_32k B={b} S={s} (batch cut from 32) runs_s="
          f"{[round(t, 6) for t in times]} (the first with the launch spy, the second with the "
          f"rows' capture spy where rows are timed) tokens_per_s={b * s / min(times):.1f} "
          f"launches flash_attention={counts['flash_attention']} (calls by kind "
          f"{plans.by_kind()}) max_memory_allocated={peak} (the first run)")
    del cell, logits, tokens
    torch.cuda.empty_cache()
    return {"launches": counts["flash_attention"], "step_s": min(times), "rows": rows}


def zoo_decode(torch, np, seed: int, spec: dict) -> dict:
    """decode_32k for the arch through ``build_cell``: one decode_step per
    sequence at cur_index 32,767 against a cache of 32,768 positions
    filled on the card; flash_attention once a layer and its merge once
    for each layer whose own plan splits (Gemma-2's local layers see 4,096
    keys, its global ones 32,768)."""
    from repro_torch.launch.steps import build_cell

    arch = spec["arch"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = build_cell(arch, "decode_32k", seed=seed, batch=spec["decode"],
                      layers=spec["layers"])
    torch.cuda.synchronize()
    model = cell.model
    cache, tokens, index = cell.args
    print(f"lm zoo {arch} decode_32k B={tokens.shape[0]} (batch cut from 128) layers="
          f"{model.cfg.n_layers} cache {tuple(cache[0].shape)} x2 {cache[0].dtype} cache_bytes="
          f"{sum(c.numel() * c.element_size() for c in cache)} init_s="
          f"{time.perf_counter() - t0:.3f}")
    with _Plans() as plans:
        counts, out = _served_counts(torch, cell.run)
    logits = out[0]
    del out
    n_layers = model.cfg.n_layers
    print(f"lm zoo {arch} decode_32k launches flash_attention {counts['flash_attention']} "
          f"flash_attention_combine {counts['flash_attention_combine']} (expected "
          f"{plans.merges()}; calls by kind and n_splits {plans.by_kind()})")
    if counts["flash_attention"] != n_layers or len(plans.calls) != n_layers:
        _fail(f"{arch} decode_32k launched flash_attention {counts['flash_attention']} times")
    if counts["flash_attention_combine"] != plans.merges():
        _fail(f"{arch} decode_32k launched flash_attention_combine "
              f"{counts['flash_attention_combine']} times, not {plans.merges()}")
    if logits.shape != (tokens.shape[0], model.cfg.vocab) or not bool(torch.isfinite(logits).all()):
        _fail(f"{arch} decode_32k logits are not finite")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        cell.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"lm zoo {arch} decode_32k ms_per_step_median={float(np.median(times)) * 1e3:.6f} "
          f"steps_ms={[round(t * 1e3, 6) for t in times]} "
          f"tokens_per_s={tokens.shape[0] / float(np.median(times)):.1f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    n = min(2, tokens.shape[0])
    sub = tuple(c[:, :n] for c in cache)
    _paths_bf16(torch, f"lm zoo {arch} decode_32k first {n} sequences",
                lambda: model.decode_step(sub, tokens[:n], index)[0])
    wall, dev, avgs = _profile(torch, cell.run)
    print(f"device busy lm zoo {arch} decode_32k step: wall_s={wall:.6f} kernel_s={dev:.6f} "
          f"busy_share={dev / wall if dev > 0 else 'not measured'}")
    print(f"lm zoo {arch} decode_32k step kernels by device time: {_top_kernels(avgs)}")
    rows = {}
    if "decode_32k" in spec["rows"]:
        rows = _zoo_rows(torch, arch, "decode_32k", cell.run, spec["rows"]["decode_32k"],
                         index + 1)
    merge = _zoo_merge(torch, arch, cell.run)
    del cell, model, cache, sub, logits, tokens
    torch.cuda.empty_cache()
    return {"launches": counts["flash_attention"], "merges": counts["flash_attention_combine"],
            "ms_per_step": float(np.median(times)) * 1e3,
            "busy_share": dev / wall if dev > 0 else None, "rows": rows, "merge": merge}


def drive_lm_zoo(torch, np, seed: int) -> dict:
    """Phase 7b: gemma2-9b, olmoe-1b-7b, yi-34b and phi3.5-moe-42b-a6.6b at
    full width, each built, checked and freed before the next (at most 1
    GiB allocated at each start): the small model against the host, the
    float32 kernel path against the twin path, lm_serve, prefill_32k and
    decode_32k, the MoE routing card against host; returns per-arch
    launches, times and flash_attention rows."""
    out = {}
    for spec in ZOO:
        arch = spec["arch"]
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated()
        print(f"lm zoo {arch} starts with memory_allocated={left}")
        if left > 1 << 30:
            _fail(f"{left} bytes are still allocated before lm zoo {arch}")
        zoo_vs_host(torch, np, seed, arch)
        zoo_float32(torch, np, seed, spec)
        serve = zoo_serve(torch, np, seed, spec)
        pre = zoo_prefill(torch, np, seed, spec) if spec["prefill"] else None
        dec = zoo_decode(torch, np, seed, spec)
        out[arch] = {"lm_serve": serve, "prefill_32k": pre, "decode_32k": dec,
                     "seconds": time.perf_counter() - t0}
        print(f"lm zoo {arch} sub-phase s={out[arch]['seconds']:.3f}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phase 7c: LM training on the card. qwen2-1.5b's train_4k cell is the
# slice's path: full width and depth, its global batch of 256 cut to
# TRAIN_BATCH (GRAD_ACCUM's 4 micro-batches kept) for the time limit.
TRAIN_ARCHS = ("qwen2-1.5b", "gemma2-9b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "yi-34b")
TRAIN_BATCH = 8             # of train_4k's 256 sequences of 4,096: 4 micro-batches of 2
TRAIN_TIMED_STEPS = 3       # timed steps after one warm-up
TRAIN_HOST_STEPS = 3        # the reduced cells, card against host
TRAIN_GEMMA_LAYERS = 2      # of Gemma-2's 42 (one local, one global), at its batch of 8
                            # in 8 micro-batches
TRAIN_GEMMA_BATCH = 8
BWD_REPLACES = "src/repro/kernels/flash_attention.py:86"
BWD_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
BWD_NAMES = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")  # a backward call, in order
BWD_DELTA = "flash_attention_bwd_delta"  # the standalone delta pass, off the path
BWD_MMA = ("bwd_dkdv_mma_kernel", "bwd_dq_mma_kernel")   # the bf16 route's kernels, by name
BWD_SIMT = ("bwd_dkdv_kernel", "bwd_dq_kernel")          # the float32 route's
# The backward kernels against their twin (the same out and lse): float32
# sums in another order, within 1e-4 of the case's largest |want| (over dq,
# dk and dv); bfloat16 within 2**-6 of it or twice the witness, whichever
# is larger. The bf16 kernels have two rounding points, p before dV and dS
# before dK and dQ (their A operands on the tensor cores), and the twin
# rounds at both; the witness rounds at neither, so it measures what a
# rounding flip between kernel and twin can move. The controls (last key
# tile dropped, the cap's derivative left out) must exceed the tolerance
# on both routes.
BWD_F32_SCALED = 1e-4
BWD_BF16_SCALED = 2.0 ** -6
BWD_WITNESS = 2.0
# delta = rowsum(dO O) against the twin's, within 1e-5 of the case's largest
# |delta|: float32 sums of the same products in another order (bf16 products
# are exact in float32), D at most 256 terms. Its control drops the last 8
# columns (a 16-byte chunk of bf16) from the kernel's delta.
BWD_DELTA_SCALED = 1e-5
BWD_LIB_SCALED = 1e-4  # torch.bmm's delta against the kernel's (a gross check of the yardstick)
BWD_FUSION_REPS = 10   # launches a reading of the fused / two-pass comparison (e)
TRAIN_F32_SCALED = 1e-4     # float32 model gradients, kernel path vs twin path, a leaf's max|g|
TRAIN_BF16_SCALED = 2.0 ** -6  # bf16 model gradients: or twice the witness, a leaf's norm
TRAIN_LOSS_RTOL = 1e-4      # the reduced cells' losses card against host (float32)
TRAIN_CHANGE_RTOL = 1e-2    # ... their parameter changes over the steps, a leaf's norm
# (B, Hq, Hkv, Sq, Sk, D, keywords, q scale): GQA groups 1, 6, 7; D 8 to
# 256; lengths off the 16 / 32 / 64 tiles; q_offset off Sk - Sq (rows past
# the keys, rows that see no key); windows 1, 7 and 4,096 at S = 8,192; a
# cap of 50 on scores large enough (q x 16) for the cap's derivative to
# matter
BWD_CASES = (
    (2, 6, 1, 100, 100, 64, {}, 1.0),
    (1, 7, 1, 77, 130, 128, dict(q_offset=40), 1.0),
    (1, 4, 2, 65, 65, 256, dict(softcap=50.0), 16.0),
    (1, 2, 2, 50, 50, 8, dict(window=7), 1.0),
    (1, 3, 1, 33, 20, 16, dict(q_offset=-5), 1.0),
    (1, 2, 2, 37, 40, 16, dict(q_offset=10), 1.0),
    (1, 2, 1, 8192, 8192, 128, dict(window=1), 1.0),
    (1, 2, 1, 8192, 8192, 128, dict(window=7), 1.0),
    (1, 2, 1, 8192, 8192, 128, dict(window=4096), 1.0),
)
BWD_TIMED = (  # (what, B, Hq, Hkv, S, D, keywords): the kernel rows' shapes
    ("qwen2-1.5b layer, micro-batch 2", TRAIN_BATCH // 4, 12, 2, 4096, 128, {}),
    ("gemma2-9b global layer, micro-batch 1", 1, 16, 8, 4096, 256, dict(softcap=50.0)),
    ("yi-34b layer (group 7), 1 sequence", 1, 56, 8, 4096, 128, {}),
)


class _TwinAttention:
    """The training twin path: ``ops.flash_attention`` inside the block is
    an autograd function whose forward is ``forward`` (default
    ``ref.flash_attention_lse_ref``) and whose backward is ``backward``
    (default the twin, ``ref.flash_attention_backward_ref``; the witness
    and the controls pass others) on the card's tensors."""

    def __init__(self, backward=None, forward=None):
        self.backward, self.forward = backward, forward

    def __enter__(self):
        import torch

        from repro_torch.kernels import ops, ref

        bwd = self.backward or ref.flash_attention_backward_ref
        fwd = self.forward or ref.flash_attention_lse_ref

        class Twin(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, kw):
                out, lse = fwd(q, k, v, **kw)
                ctx.save_for_backward(q, k, v, out, lse)
                ctx.kw = kw
                return out

            @staticmethod
            def backward(ctx, dout):
                return (*bwd(*ctx.saved_tensors, dout, **ctx.kw), None)

        def attention(q, k, v, **kw):
            return Twin.apply(q, k, v, kw)

        self.ops, self.saved = ops, ops.flash_attention
        ops.flash_attention = attention
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.saved


class _LaunchOrder:
    """Records, while entered, the attention backward's launches through
    ``_build.launch`` (the wrappers' one way to a kernel), in order."""

    def __enter__(self):
        from repro_torch.kernels import _build

        self.build, self.saved, self.names = _build, _build.launch, []

        def launch(source, kernel, *args):
            if kernel in (BWD_DELTA, *BWD_NAMES):
                self.names.append(kernel)
            return self.saved(source, kernel, *args)

        _build.launch = launch
        return self

    def __exit__(self, *exc):
        self.build.launch = self.saved

    def in_order(self) -> bool:
        """Each backward call launched dq, then dK/dV, and nothing else."""
        return self.names == list(BWD_NAMES) * (len(self.names) // len(BWD_NAMES))


def _bwd_witness(*args, **kw):
    """The twin with neither p (before dV) nor dS (before dK and dQ)
    rounded."""
    from repro_torch.kernels import ref

    return ref.flash_attention_backward_ref(*args, round_p=False, round_ds=False, **kw)


def _fwd_witness(q, k, v, **kw):
    """The forward twin with p unrounded before PV (v read as float32),
    its output in q's dtype, and its lse."""
    from repro_torch.kernels import ref

    return ref.flash_attention_lse_ref(q, k, v.float(), **kw)


def _bwd_last_tile_dropped(q, k, v, out, lse, dout, **kw):
    """The control: the twin with the last 64-key tile's dK and dV terms
    dropped, as a kernel that never ran its last key tile would leave."""
    from repro_torch.kernels import ref

    dq, dk, dv = ref.flash_attention_backward_ref(q, k, v, out, lse, dout, **kw)
    cut = (k.shape[2] - 1) // CONTROL_TILE * CONTROL_TILE
    dk, dv = dk.clone(), dv.clone()
    dk[:, :, cut:] = 0
    dv[:, :, cut:] = 0
    return dq, dk, dv


def _bwd_no_delta(q, k, v, out, lse, dout, **kw):
    """The control: the twin with delta left out of dS (dS = p dP), as a
    zero output gives it."""
    from repro_torch.kernels import ref

    return ref.flash_attention_backward_ref(q, k, v, out.new_zeros(out.shape), lse, dout, **kw)


def _bwd_no_cap_grad(q, k, v, out, lse, dout, *, softcap=None, **kw):
    """The control: the twin's arithmetic with the soft-cap's derivative
    left out of dS."""
    import torch

    from repro_torch.kernels import ref

    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = kw.get("sm_scale") or d ** -0.5
    off = sk - sq if kw.get("q_offset") is None else kw["q_offset"]
    s, mask = ref._attention_scores(q, k, causal=kw.get("causal", True), window=kw.get("window"),
                                    softcap=softcap, sm_scale=scale, q_offset=off)
    p = torch.where(mask, torch.exp(torch.where(mask, s, 0.0) - lse.reshape(b, hkv, g, sq, 1)),
                    0.0)
    do = dout.float().reshape(b, hkv, g, sq, d)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do).sum(dim=2)
    dp = torch.matmul(do, v.float().unsqueeze(2).transpose(-1, -2))
    delta = (do * out.float().reshape(b, hkv, g, sq, d)).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()  # rounded as the twin rounds it
    dk = torch.matmul(ds.transpose(-1, -2), q.float().reshape(b, hkv, g, sq, d)).sum(dim=2)
    dq = torch.matmul(ds, k.float().unsqueeze(2))
    return ((dq * scale).reshape(q.shape).to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype))


def _bwd_inputs(torch, gen, b, hq, hkv, sq, sk, d, dt, q_scale=1.0):
    """q and dout (B, Hq, Sq, D), k, v (B, Hkv, Sk, D) in the model's
    (B, S, H, D) memory, standard normal (q times q_scale), in dt."""
    def draw(s, h, scale=1.0):
        x = torch.randn((b, s, h, d), generator=gen, device=DEV) * scale
        return x.to(dt).transpose(1, 2)

    return draw(sq, hq, q_scale), draw(sk, hkv), draw(sk, hkv), draw(sq, hq)


def _tensor_errs(got, want, scaled: bool = True) -> list:
    """max|got - want| of each pair, over the largest max|want| of all
    the pairs when ``scaled`` (dq and dk are 0 in exact arithmetic where
    each row sees one key, a window of 1, and come out as rounding noise:
    their own max is no scale)."""
    scale = max(max(float(w.float().abs().max()) for w in want), 1e-30) if scaled else 1.0
    return [float((a.float() - w.float()).abs().max()) / scale for a, w in zip(got, want)]


def check_attention_backward(torch, np, seed: int) -> dict:
    """Phase 7c (a): the forward's lse and the backward's launches (dq,
    which forms delta, then dK/dV, in that order; delta and the two-pass
    route by :func:`_check_delta`) against their twins on BWD_CASES,
    float32 (SIMT) and bfloat16 (tensor cores), from the kernel's own out
    and lse; the controls must fail each route's comparison. Returns the
    largest errors by dtype."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (flash_attention_backward_cuda,
                                                     flash_attention_cuda)

    gen = torch.Generator(device=DEV).manual_seed(seed + 71)
    worst = {"float32": 0.0, "bfloat16": 0.0, "lse": 0.0, "abs_float32": 0.0,
             "abs_bfloat16": 0.0, "delta_float32": 0.0, "delta_bfloat16": 0.0,
             "delta_abs_float32": 0.0, "delta_abs_bfloat16": 0.0}
    controls = {}
    for b, hq, hkv, sq, sk, d, kw, q_scale in BWD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            name = "float32" if dt == torch.float32 else "bfloat16"
            q, k, v, do = _bwd_inputs(torch, gen, b, hq, hkv, sq, sk, d, dt, q_scale)
            ops.reset_launch_counts()
            out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
            with _LaunchOrder() as order:
                got = flash_attention_backward_cuda(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            counts = {n: ops.launch_counts[n] for n in ("flash_attention", BWD_DELTA, *BWD_NAMES)}
            if counts != {"flash_attention": 1, BWD_DELTA: 0, **{n: 1 for n in BWD_NAMES}} \
                    or order.names != list(BWD_NAMES):
                _fail(f"attention backward case launched {counts} in the order {order.names}")
            _, lse_t = ref.flash_attention_lse_ref(q, k, v, **kw)
            seen = torch.isfinite(lse_t)
            lse_err = float((lse - lse_t)[seen].abs().max()) if bool(seen.any()) else 0.0
            if not torch.equal(torch.isinf(lse), ~seen) or lse_err > 1e-4:
                _fail(f"the forward's lse differs from its twin ({lse_err}) at {d}, {kw}")
            want = ref.flash_attention_backward_ref(q, k, v, out, lse, do, **kw)
            errs = _tensor_errs(got, want)
            tol = BWD_F32_SCALED
            if dt == torch.bfloat16:
                wit = max(_tensor_errs(_bwd_witness(q, k, v, out, lse, do, **kw), want))
                tol = max(BWD_BF16_SCALED, BWD_WITNESS * wit)
            shape = f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} {kw}"
            scale = max(max(float(w.float().abs().max()) for w in want), 1e-30)
            d_err, d_abs, c_err, two_pass = _check_delta(torch, q, k, v, out, lse, do, kw, got,
                                                         scale, tol)
            print(f"attention backward {name} {shape}: dq/dk/dv err/max|want| "
                  f"{['%.3e' % e for e in errs]} tol {tol:.3e}; lse max_abs_err {lse_err:.3e}; "
                  f"delta err/max|want| {d_err:.3e} (tol {BWD_DELTA_SCALED:.0e}, control "
                  f"{c_err:.3e}); two-pass dq {two_pass:.3e}")
            if not all(bool(torch.isfinite(t).all()) for t in got) or max(errs) > tol:
                _fail(f"the attention backward differs from its twin at {name} {shape}")
            worst[f"delta_{name}"] = max(worst[f"delta_{name}"], d_err)
            worst[f"delta_abs_{name}"] = max(worst[f"delta_abs_{name}"], d_abs)
            key = f"delta_last_chunk_dropped {name}"  # the smallest over the cases
            controls[key] = (min(controls.get(key, (c_err,))[0], c_err), BWD_DELTA_SCALED)
            worst[name] = max(worst[name], max(errs))
            worst[f"abs_{name}"] = max(worst[f"abs_{name}"],
                                       max(_tensor_errs(got, want, scaled=False)))
            worst["lse"] = max(worst["lse"], lse_err)
            if kw.get("softcap") or (d == 64 and not kw):
                ctl = _bwd_no_cap_grad if kw.get("softcap") else _bwd_last_tile_dropped
                c_err = max(_tensor_errs(ctl(q, k, v, out, lse, do, **kw), want))
                controls[f"{ctl.__name__} {name}"] = (c_err, tol)
                if c_err <= tol:
                    _fail(f"the {name} comparison does not tell {ctl.__name__} ({c_err}) from "
                          f"the twin (tolerance {tol})")
            del q, k, v, do, out, lse, got, want
    print(f"attention backward: worst err/max|want| {worst}; controls (error, the tolerance "
          f"it must exceed) {controls}")
    return {**worst, "controls": controls}


def _move_state(torch, cell, dev):
    """(model, opt_state, tokens, targets) of a CPU cell copied to dev."""
    import dataclasses

    from repro_torch.models.transformer import Transformer
    from repro_torch.train.optimizer import init_opt_state, AdamWConfig

    model, opt_state, tokens, targets = cell.args
    with torch.no_grad():
        params = {n: p.detach().to(dev, copy=True) for n, p in model.named_parameters()}
    moved = Transformer(dataclasses.replace(model.cfg), params).requires_grad_()
    opt = init_opt_state(moved.leaves(), AdamWConfig())
    return moved, opt, tokens.to(dev), targets.to(dev)


def train_cells_vs_host(torch, np, seed: int) -> dict:
    """Phase 7c (b): each arch's reduced train_4k cell, built on the host
    CPU and copied to the card, TRAIN_HOST_STEPS steps on each: losses
    within TRAIN_LOSS_RTOL, each leaf's change within TRAIN_CHANGE_RTOL of
    the host's. Then the training script ``launch.train`` twice on the card, the
    second run restoring the first's checkpoint."""
    import os
    import shutil
    import tempfile
    from functools import partial

    from repro_torch.launch import steps
    from repro_torch.launch import train as lm_train
    from repro_torch.train.optimizer import AdamWConfig

    out = {}
    for arch in TRAIN_ARCHS:
        host = steps.build_cell(arch, "train_4k", reduced=True, device="cpu", seed=seed)
        card = _move_state(torch, host, DEV)
        h0 = {k: v.detach().clone() for k, v in host.model.leaves().items()}
        c0 = {k: v.detach().clone() for k, v in card[0].leaves().items()}
        step = partial(steps.lm_train_step, opt_cfg=AdamWConfig(), n_micro=1)
        lh = [float(host.run()[0]) for _ in range(TRAIN_HOST_STEPS)]
        lc = [float(step(*card)[0]) for _ in range(TRAIN_HOST_STEPS)]
        worst = 0.0
        for k, v in host.model.leaves().items():
            dh = v.detach() - h0[k]
            dc = (card[0].leaves()[k].detach() - c0[k]).cpu()
            worst = max(worst, float((dc - dh).norm() / dh.norm().clamp_min(1e-30)))
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        print(f"train cell {arch} reduced, card vs host over {TRAIN_HOST_STEPS} steps: losses "
              f"{[round(x, 6) for x in lc]} vs {[round(x, 6) for x in lh]} (rel err "
              f"{loss_err:.2e}); parameter changes rel err {worst:.2e}")
        if loss_err > TRAIN_LOSS_RTOL or worst > TRAIN_CHANGE_RTOL:
            _fail(f"the reduced {arch} train cell on the card differs from the host's")
        out[arch] = {"loss_err": loss_err, "change_err": worst}
        del host, card
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_lm_train_")
    try:
        argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "4", "--ckpt", ckdir]
        first = lm_train.main(argv)
        second = lm_train.main(argv)
        steps_saved = sorted(os.listdir(ckdir))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    print(f"launch.train --reduced --steps 4 twice: first from {first['start_step']}, second "
          f"from {second['start_step']}; checkpoints {steps_saved}; losses "
          f"{first['losses']} then {second['losses']}")
    if first["start_step"] != 0 or second["start_step"] != 4 or \
            steps_saved != ["step_00000004", "step_00000008"] or \
            not all(np.isfinite(first["losses"] + second["losses"])):
        _fail("the training script did not save, restore and continue")
    return out


def _leaf_errs(got: dict, want: dict, l2: bool = False) -> dict:
    """Each leaf's max|got - want| / max|want| or, with ``l2``, its
    ||got - want|| / ||want||."""
    if l2:
        return {k: float((got[k] - w).norm()) / max(float(w.norm()), 1e-30)
                for k, w in want.items()}
    return {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for k, w in want.items()}


def _attn_counts(torch):
    from repro_torch.kernels import ops

    return {n: ops.launch_counts[n] for n in ("flash_attention", "flash_attention_combine",
                                              "flash_attention_combine_rowwise", BWD_DELTA,
                                              *BWD_NAMES)}


def _hold_model_grads(torch, what: str, model, tokens, targets, n_micro: int, scaled: float,
                      control, by_witness: bool) -> dict:
    """The kernel path's gradients (``lm_grads``) against the twin path's
    from the same state: loss within scaled / 10, grad_norm within
    ``scaled``, and every leaf within ``scaled`` of its max|g| (float32);
    ``by_witness`` (bfloat16): every leaf's relative norm error
    ||g_k - g_t|| / ||g_t|| within ``scaled`` or BWD_WITNESS times the
    witness's (the twin path with p unrounded in the forward's PV product
    and before dV, and dS before dK and dQ, so that the forward's hidden
    states move by a rounding too, as the kernel path's do), where
    larger: through 28
    bfloat16 layers every rounding difference spreads, and a max over a
    billion entries reads the tail of that spread, so the norm is held and
    the max printed beside. ``control`` (a backward that must fail) goes
    through the same comparison. The kernel path's backward calls must each
    launch dq, then dK/dV. Returns the kernel path's launches, errors and
    gradients. ``control`` None: no control."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import lm_grads
    from repro_torch.train.optimizer import global_norm

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with _LaunchOrder() as order:
        loss_k, g_k = lm_grads(model, tokens, targets, n_micro)
        torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    counts = _attn_counts(torch)
    if not order.in_order():
        _fail(f"{what}: the backward's launches came in the order {order.names[:6]}...")
    with _TwinAttention():
        loss_t, g_t = lm_grads(model, tokens, targets, n_micro)
    errs = _leaf_errs(g_k, g_t, l2=by_witness)
    max_errs = _leaf_errs(g_k, g_t)
    tol = {k: scaled for k in errs}
    wit = {}
    if by_witness:
        with _TwinAttention(_bwd_witness, _fwd_witness):
            wit = _leaf_errs(lm_grads(model, tokens, targets, n_micro)[1], g_t, l2=True)
        tol = {k: max(scaled, BWD_WITNESS * wit[k]) for k in errs}
    c_errs = {"none": 0.0}
    if control is not None:
        with _TwinAttention(control):
            c_errs = _leaf_errs(lm_grads(model, tokens, targets, n_micro)[1], g_t,
                                l2=by_witness)
    norm_k, norm_t = float(global_norm(g_k)), float(global_norm(g_t))
    loss_err = abs(float(loss_k) - float(loss_t)) / abs(float(loss_t))
    norm_err = abs(norm_k - norm_t) / norm_t
    worst = max(errs, key=lambda k: errs[k] / tol[k])
    metric = "||err||/||g||" if by_witness else "err/max|g|"
    print(f"{what} kernel vs twin path: loss {float(loss_k):.6f} vs {float(loss_t):.6f} (rel "
          f"{loss_err:.2e}, tol {scaled / 10:.1e}); grad_norm {norm_k:.6f} vs {norm_t:.6f} "
          f"(rel {norm_err:.2e}, tol {scaled:.1e}); leaves {metric} max "
          f"{max(errs.values()):.3e} (err/max|g| max "
          f"{max(max_errs.values()):.3e}; worst against its tol: {worst} {errs[worst]:.3e} tol "
          f"{tol[worst]:.3e}); witness (p, dS unrounded) max {max(wit.values(), default=0.0):.3e}; "
          f"control ({getattr(control, '__name__', None)}) max {max(c_errs.values()):.3e}; "
          f"kernel-path grads "
          f"{k_s:.3f} s; launches {counts}, each backward call dq then dK/dV")
    if loss_err > scaled / 10 or norm_err > scaled or any(errs[k] > tol[k] for k in errs):
        _fail(f"{what}: the kernel path's gradients differ from the twin path's")
    if control is not None and all(c_errs[k] <= tol[k] for k in c_errs):
        _fail(f"{what}: the comparison does not tell the control from the twin path")
    return {"launches": counts, "errs": errs, "max_errs": max_errs, "grads": g_k,
            "loss": float(loss_k),
            "grad_norm": norm_k, "loss_err": loss_err, "control": max(c_errs.values()),
            "witness": max(wit.values(), default=0.0), "grads_s": k_s}


def qwen2_train(torch, np, seed: int, card: str) -> dict:
    """Phase 7c (c): qwen2-1.5b train_4k at full width. The float32 model
    (2 of 28 layers, one sequence) kernel path against twin path; then the
    bf16 cell at full depth, batch TRAIN_BATCH in its 4 micro-batches: one
    step's gradients against the twin path (witness, control), the launches
    exactly, two gradient passes bit-identical under deterministic
    algorithms, TRAIN_TIMED_STEPS timed steps after a warm-up, the last
    under the profiler (kernel events only), peak memory."""
    import dataclasses
    import statistics

    from repro_torch.configs.qwen2_1_5b import config
    from repro_torch.configs.registry import LM_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    cfg = config()
    gen = torch.Generator(device=DEV).manual_seed(seed + 73)
    seq = LM_SHAPES["train_4k"].params["seq_len"]
    f32 = Transformer.from_config(dataclasses.replace(cfg, dtype="float32", n_layers=2),
                                  device=DEV, seed=seed).requires_grad_()
    tok = torch.randint(0, cfg.vocab, (2, 1, seq), generator=gen, device=DEV)
    f32_res = _hold_model_grads(torch, f"qwen2-1.5b float32, 2 layers, 1 x {seq}", f32, tok[0],
                                tok[1], 1, TRAIN_F32_SCALED, _bwd_no_delta, False)
    del f32, f32_res["grads"]
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    cell = steps.build_cell("qwen2-1.5b", "train_4k", device=DEV, seed=seed, batch=TRAIN_BATCH)
    model, opt_state, tokens, targets = cell.args
    n_micro = steps.GRAD_ACCUM["qwen2-1.5b"]
    cell.args = opt_state = None  # the comparisons below need no optimizer state
    gc.collect()
    torch.cuda.empty_cache()
    res = _hold_model_grads(torch, f"qwen2-1.5b train_4k bf16, B={TRAIN_BATCH}", model, tokens,
                            targets, n_micro, TRAIN_BF16_SCALED, _bwd_no_delta, True)
    want = {"flash_attention": 2 * cfg.n_layers * n_micro, "flash_attention_combine": 0,
            "flash_attention_combine_rowwise": 0, BWD_DELTA: 0,
            **{n: cfg.n_layers * n_micro for n in BWD_NAMES}}
    if res["launches"] != want:
        _fail(f"a qwen2-1.5b train step launched {res['launches']}, not {want}")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, again = steps.lm_grads(model, tokens, targets, n_micro)
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(again[k], g) for k, g in res["grads"].items())
    print(f"qwen2-1.5b: two gradient passes from one state bit-identical: {same}")
    if not same:
        _fail("two qwen2-1.5b gradient passes from one state differ")
    del again, res["grads"]
    gc.collect()
    torch.cuda.empty_cache()

    opt_cfg = AdamWConfig()
    opt_state = init_opt_state(model.leaves(), opt_cfg)
    loss, metrics = cell.fn(model, opt_state, tokens, targets)  # warm-up
    torch.cuda.synchronize()
    times, losses = [], [float(loss)]
    for _ in range(TRAIN_TIMED_STEPS - 1):
        t0 = time.perf_counter()
        loss, metrics = cell.fn(model, opt_state, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    out = []  # the last timed step runs under the profiler (kernel events only)
    wall, dev_s, avgs = _profile(torch, lambda: out.extend(cell.fn(model, opt_state, tokens,
                                                                   targets)))
    times.append(wall)
    loss, metrics = out
    losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times)
    tokens_s = TRAIN_BATCH * tokens.shape[1] / step_s
    print(f"qwen2-1.5b train_4k ({cfg.n_layers} layers, B={TRAIN_BATCH} in {n_micro} "
          f"micro-batches, S={seq}, {cfg.dtype}): s a step {[round(t, 6) for t in times]} "
          f"median {step_s:.6f}, tokens/s "
          f"{tokens_s:.1f}; losses {losses}; grad_norm {float(metrics['grad_norm']):.6f}; "
          f"profiled step wall {wall:.6f} s, device {dev_s:.6f} s, busy {dev_s / wall:.4f}; "
          f"max_memory_allocated={peak}; top kernels: {_top_kernels(avgs, 10)}; card {card}")
    if not all(np.isfinite(losses)):
        _fail("qwen2-1.5b train_4k losses are not finite")
    kernel_ms = {n: sum(getattr(e, "self_device_time_total", 0) for e in avgs
                        if n in e.key) / 1e3
                 for n in ("bwd_dkdv", "bwd_dq", "bwd_delta", "tc_kernel", "simt_kernel", *BWD_MMA,
                           *BWD_SIMT)}
    print(f"qwen2-1.5b train_4k profiled step, device ms by kernel: "
          f"{ {n: round(m, 3) for n, m in kernel_ms.items()} }; card {card}")
    if any(kernel_ms[n] for n in (*BWD_SIMT, "bwd_delta")) or \
            not all(kernel_ms[n] for n in BWD_MMA):
        _fail("the bf16 train step's attention backward did not run (only) on the tensor-core "
              "kernels, without the standalone delta pass")
    del cell, model, opt_state, tokens, targets, loss, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {**{k: v for k, v in res.items() if k != "grads"}, "step_s": step_s, "times": times,
            "tokens_s": tokens_s, "busy": dev_s / wall, "peak": peak, "kernel_ms": kernel_ms,
            "f32": {k: v for k, v in f32_res.items() if k != "grads"}}


def gemma_train(torch, np, seed: int) -> dict:
    """Phase 7c (d): gemma2-9b's train_4k at full width, TRAIN_GEMMA_LAYERS
    of 42 layers, batch TRAIN_GEMMA_BATCH in its 8 micro-batches: one
    step's gradients, kernel path against twin path (D = 256, soft-capped,
    the window at 4,096); then the four full-size refusals, each with
    nothing allocated."""
    from repro_torch.launch import steps

    cell = steps.build_cell("gemma2-9b", "train_4k", device=DEV, seed=seed,
                            batch=TRAIN_GEMMA_BATCH, layers=TRAIN_GEMMA_LAYERS)
    model, _, tokens, targets = cell.args
    cell.args = None
    gc.collect()
    torch.cuda.empty_cache()
    n_micro = steps.GRAD_ACCUM["gemma2-9b"]
    res = _hold_model_grads(torch, f"gemma2-9b train_4k bf16, {TRAIN_GEMMA_LAYERS} layers, "
                            f"B={TRAIN_GEMMA_BATCH}", model, tokens, targets, n_micro,
                            TRAIN_BF16_SCALED, None, True)
    del res["grads"], cell, model, tokens, targets
    gc.collect()
    torch.cuda.empty_cache()
    refused = {}
    for arch in TRAIN_ARCHS[1:]:
        before = torch.cuda.memory_allocated()
        try:
            steps.build_cell(arch, "train_4k", device=DEV, seed=seed)
        except ValueError as e:
            refused[arch] = (str(e).split(" bytes")[0].split()[-1],
                             torch.cuda.memory_allocated() - before)
        else:
            _fail(f"the full-size {arch} train cell did not refuse")
    print(f"full-size train cells refused (bytes of training state, bytes allocated): {refused}")
    if any(a for _, a in refused.values()):
        _fail("a refusing train cell allocated on the card")
    return {**res, "refused": refused}


def _visible_pairs(s: int, window) -> int:
    """Visible (query, key) pairs of one head at causal length s."""
    w = window or s
    return sum(min(i + 1, w) for i in range(s))


def _sdpa_backward_ms(torch, q, k, v, do, reps: int) -> float:
    import torch.nn.functional as F

    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, enable_gqa=True)
    return _time_ms(torch, lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                                       retain_graph=True), reps)


def _bwd_launches(torch, q, k, v, out, lse, do, kw) -> tuple:
    """The backward's launches on these tensors, each a callable through
    ``_build.launch`` (dtype from q), and the buffers they write, all
    prefilled with NaN (a row no block writes shows): the path's dq launch
    (dq into "dq", delta from out into "delta") and dK/dV (reading "delta",
    into "dk", "dv"); the two-pass route, the standalone delta (into
    "delta_pass") and dq reading it (o null, into "dq_two_pass")."""
    from repro_torch.kernels.flash_attention import _DTYPES, _build

    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dt = _DTYPES[q.dtype]
    off = sk - sq if kw.get("q_offset") is None else kw["q_offset"]
    nan = float("nan")
    buf = {n: torch.full(lse.shape, nan, dtype=torch.float32, device=DEV)
           for n in ("delta", "delta_pass")}
    buf.update({n: torch.full_like(t, nan) for n, t in (("dq", q), ("dq_two_pass", q), ("dk", k),
                                                         ("dv", v))})

    def args(o, delta, dq):
        return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o, lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), buf["dk"].data_ptr(), buf["dv"].data_ptr(), b,
                hq, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *do.stride()[:3], *out.stride()[:3], *dq.stride()[:3], *buf["dk"].stride()[:3],
                *buf["dv"].stride()[:3], int(kw.get("causal", True)), kw.get("window") or 0, off,
                kw.get("softcap") or 0.0, kw.get("sm_scale") or d ** -0.5, dt)

    fused = args(out.data_ptr(), buf["delta"], buf["dq"])
    two_pass = args(0, buf["delta_pass"], buf["dq_two_pass"])
    dev = q.device
    calls = {
        "flash_attention_bwd_dq": lambda: _build.launch(
            "flash_attention", "flash_attention_bwd_dq", dev, *fused),
        "flash_attention_bwd_dkdv": lambda: _build.launch(
            "flash_attention", "flash_attention_bwd_dkdv", dev, *fused),
        BWD_DELTA: lambda: _build.launch(
            "flash_attention", BWD_DELTA, dev, out.data_ptr(), do.data_ptr(),
            buf["delta_pass"].data_ptr(), b, hq, sq, d, *out.stride()[:3], *do.stride()[:3], dt),
        "dq_two_pass": lambda: _build.launch(
            "flash_attention", "flash_attention_bwd_dq", dev, *two_pass),
    }
    return calls, buf


def _scaled_err(got, want, scale: float | None = None) -> float:
    """max|got - want| over ``scale`` (None: max|want|); inf where got has
    a NaN (a row no block wrote)."""
    if not bool(got.isfinite().all()):
        return float("inf")
    if scale is None:
        scale = max(float(want.float().abs().max()), 1e-30)
    return float((got.float() - want.float()).abs().max()) / scale


def _check_delta(torch, q, k, v, out, lse, do, kw, got, scale: float, tol: float) -> tuple:
    """7c (a)'s delta checks of one case (the caller's launches done, its
    grads ``got`` in hand): the dq launch again into buffers of NaN, its
    delta against the fused twin's (the twin's dq equal to the whole
    twin's, the launch's dq to the call's bit for bit), the control (its
    last 8 columns dropped) failing; then the standalone delta pass and dq
    reading it (the two-pass route). Returns (delta's error over the twin's
    max|delta|, its max abs error, the control's error, the two-pass dq's
    error over ``scale``)."""
    from repro_torch.kernels import ref

    calls, buf = _bwd_launches(torch, q, k, v, out, lse, do, kw)
    calls["flash_attention_bwd_dq"]()
    calls[BWD_DELTA]()
    calls["dq_two_pass"]()
    torch.cuda.synchronize()
    dq_t, delta_t = ref.flash_attention_bwd_dq_ref(q, k, v, out, lse, do, **kw)
    err = _scaled_err(buf["delta"], delta_t)
    pass_err = _scaled_err(buf["delta_pass"], delta_t)
    cut = (do[..., -8:].float() * out[..., -8:].float()).sum(-1)
    c_err = _scaled_err(buf["delta"] - cut, delta_t)
    two_pass = _scaled_err(buf["dq_two_pass"], dq_t, scale)
    shape = f"B={q.shape[0]} Hq={q.shape[1]} Sq={q.shape[2]} D={q.shape[3]} {kw} {q.dtype}"
    if not torch.equal(buf["dq"], got[0]) or not torch.equal(
            dq_t, ref.flash_attention_backward_ref(q, k, v, out, lse, do, **kw)[0]):
        _fail(f"the dq launch is not the backward call's dq, or the twins' dq differ, at {shape}")
    if max(err, pass_err) > BWD_DELTA_SCALED or two_pass > tol:
        _fail(f"delta ({err}, standalone {pass_err}) or the two-pass dq ({two_pass}) differs "
              f"from its twin at {shape}")
    if c_err <= BWD_DELTA_SCALED:
        _fail(f"the delta comparison does not tell the last chunk dropped ({c_err}) at {shape}")
    return err, float((buf["delta"] - delta_t).abs().max()), c_err, two_pass


def _fusion_ms(torch, calls: dict) -> dict:
    """The dq launch that forms delta against the two-pass route on the
    same inputs (``calls`` of :func:`_bwd_launches`): the standalone delta
    pass and dq reading it, timed in turns (fused, dq reading delta, the
    pass, the pass, dq reading delta, fused), BWD_FUSION_REPS launches a
    reading. Each one's mean ms, the fused dq's added time over dq reading
    delta, and whether that is below the pass's time (the fusion gains)."""
    calls[BWD_DELTA]()  # delta for the dq that reads it
    runs = {}
    for n in ("flash_attention_bwd_dq", "dq_two_pass", BWD_DELTA, BWD_DELTA, "dq_two_pass",
              "flash_attention_bwd_dq"):
        runs.setdefault(n, []).append(_time_ms(torch, calls[n], BWD_FUSION_REPS))
    ms = {n: sum(r) / len(r) for n, r in runs.items()}
    added = ms["flash_attention_bwd_dq"] - ms["dq_two_pass"]
    return {"fused_dq_ms": ms["flash_attention_bwd_dq"], "two_pass_dq_ms": ms["dq_two_pass"],
            "delta_pass_ms": ms[BWD_DELTA], "added_ms": added, "gains": added < ms[BWD_DELTA],
            "runs": runs}


def backward_rows(torch, np, seed: int, launches: dict, errs: dict, card: str) -> list:
    """Phase 7c (e): the kernel rows at BWD_TIMED's shapes: each backward
    kernel's ms (CUDA events) and share of its bound, the two launches
    together, the twin's ms, SDPA's backward through autograd (without the
    cap where the layer has one; the kernel without it beside), the
    forward with lse against the serving forward; bounds from this run's
    visible pairs. The dq launch that forms delta against the two-pass
    route on the same inputs (:func:`_fusion_ms`), and delta's library
    call, ``torch.bmm`` of dO (N, 1, D) by O (N, D, 1) with float32 sums
    on their (B, S, H, D) memory, held against the kernel's delta. At the
    first shape also the float32 route's (SIMT) dQ and dK/dV on the same
    inputs in float32."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_backward_cuda,
                                                     flash_attention_cuda)

    gen = torch.Generator(device=DEV).manual_seed(seed + 79)
    rows = {n: {} for n in (BWD_DELTA, *BWD_NAMES, "flash_attention_lse")}
    simt_ms = {}
    for what, b, hq, hkv, s, d, kw in BWD_TIMED:
        q, k, v, do = _bwd_inputs(torch, gen, b, hq, hkv, s, s, d, torch.bfloat16)
        out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        part, buf = _bwd_launches(torch, q, k, v, out, lse, do, kw)
        fusion = _fusion_ms(torch, part)  # the dq launch first: dK/dV reads its delta
        ms = {n: _time_ms(torch, part[n], 3) for n in BWD_NAMES}
        ms[BWD_DELTA] = fusion["delta_pass_ms"]
        do_r, o_r = (t.transpose(1, 2).contiguous() for t in (do, out))  # views: no copy
        lib = lambda: torch.bmm(do_r.reshape(-1, 1, d), o_r.reshape(-1, d, 1),  # noqa: E731
                                out_dtype=torch.float32)
        lib_ms = _time_ms(torch, lib, 3)
        lib_err = _scaled_err(lib().reshape(b, s, hq).transpose(1, 2), buf["delta"])
        if lib_err > BWD_LIB_SCALED:
            _fail(f"torch.bmm's delta differs from the kernel's ({lib_err}) at {what}")
        del do_r, o_r, lib
        if not simt_ms:  # the float32 route at the first shape, on the same inputs
            f32 = [t.float() for t in (q, k, v, do)]
            o32, l32 = flash_attention_cuda(*f32[:3], lse=True, **kw)
            p32, _ = _bwd_launches(torch, *f32[:3], o32, l32, f32[3], kw)
            simt_ms = {n: _time_ms(torch, p32[n], 1) for n in BWD_NAMES}  # dq first
            del f32, o32, l32, p32
        whole = _time_ms(torch, lambda: flash_attention_backward_cuda(q, k, v, out, lse, do,
                                                                      **kw), 3)
        twin = _time_ms(torch, lambda: ref.flash_attention_backward_ref(q, k, v, out, lse, do,
                                                                        **kw), 1)
        sdpa = _sdpa_backward_ms(torch, q, k, v, do, 3)
        nocap = None
        if kw.get("softcap"):
            o2, l2 = flash_attention_cuda(q, k, v, lse=True)
            nocap = _time_ms(torch, lambda: flash_attention_backward_cuda(q, k, v, o2, l2, do), 3)
        fwd_lse = _time_ms(torch, lambda: flash_attention_cuda(q, k, v, lse=True, **kw), 5)
        fwd = _time_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw), 5)
        fwd_twin = _time_ms(torch, lambda: ref.flash_attention_lse_ref(q, k, v, **kw), 1)
        import torch.nn.functional as F
        sdpa_fwd = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 5)
        pairs = b * hq * _visible_pairs(s, kw.get("window"))
        el = 2  # bf16
        qb, kb = b * hq * s * d * el, b * hkv * s * d * el
        stats = b * hq * s * 4
        work = {  # (bytes, operations): inputs read once, outputs written once
            BWD_DELTA: (2 * qb + stats, 2 * b * hq * s * d),
            "flash_attention_bwd_dkdv": (2 * qb + 2 * kb + 2 * stats + 2 * kb, 4 * 2 * d * pairs),
            # q, dO, O, k, v and lse in; dq and delta out
            "flash_attention_bwd_dq": (3 * qb + 2 * kb + 2 * stats + qb,
                                       3 * 2 * d * pairs + 2 * b * hq * s * d),
            "flash_attention_lse": (qb + 2 * kb + qb + stats, 2 * 2 * d * pairs),
        }
        for n, (nbytes, nops) in work.items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / H100_BF16_FLOPS * 1e3
            k_ms = fwd_lse if n == "flash_attention_lse" else ms[n]
            rows[n][what] = {"ms": k_ms, "bound_ms": max(t_bytes, t_ops),
                             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                             "bound_share": max(t_bytes, t_ops) / k_ms,
                             "bytes": nbytes, "ops": nops}
        whole_ops = 5 * 2 * d * pairs
        whole_bound = max(whole_ops / H100_BF16_FLOPS, (4 * qb + 4 * kb + stats)
                          / HBM_BYTES_PER_S) * 1e3
        summary = {"backward_ms": whole, "twin_ms": twin, "sdpa_backward_ms": sdpa,
                   "backward_ms_without_cap": nocap, "backward_bound_ms": whole_bound,
                   "forward_lse_ms": fwd_lse, "forward_ms": fwd, "forward_twin_ms": fwd_twin,
                   "sdpa_forward_ms": sdpa_fwd, "visible_pairs": pairs, "fusion": fusion,
                   "delta_bmm_ms": lib_ms, "delta_bmm_err": lib_err}
        for n in rows:
            rows[n][what].update(summary)
        shares = {n: f"{rows[n][what]['bound_share']:.1%}" for n in (*BWD_NAMES, BWD_DELTA)}
        print(f"attention backward fusion at {what}: dq forming delta {fusion['fused_dq_ms']:.6f} "
              f"ms; dq reading delta {fusion['two_pass_dq_ms']:.6f} + the standalone delta "
              f"{fusion['delta_pass_ms']:.6f} ms; the fused dq's added time "
              f"{fusion['added_ms']:.6f} ms, {'below' if fusion['gains'] else 'NOT below'} the "
              f"delta pass's; readings {fusion['runs']}; torch.bmm's delta {lib_ms:.6f} ms "
              f"(err/max|delta| {lib_err:.2e}); card {card}")
        print(f"attention backward rows at {what} (B={b} Hq={hq} Hkv={hkv} S={s} D={d} {kw}): "
              f"by kernel ms {ms}, share of bound {shares}; float32 route (SIMT) at the first "
              f"shape ms {simt_ms}; whole backward ms={whole:.6f} (bound {whole_bound:.6f} at "
              f"{whole_ops} ops), without the cap {nocap}; twin ms={twin:.6f}; SDPA backward "
              f"ms={sdpa:.6f}{' (no cap)' if nocap is not None else ''}; forward with lse "
              f"ms={fwd_lse:.6f}, serving forward {fwd:.6f}, twin {fwd_twin:.6f}, SDPA "
              f"{sdpa_fwd:.6f}; card {card}")
        del q, k, v, do, out, lse, part, buf
        torch.cuda.empty_cache()
    first = BWD_TIMED[0][0]
    out_rows = []
    for n, by_shape in rows.items():
        r = by_shape[first]
        lib = r["sdpa_forward_ms"] if n == "flash_attention_lse" else r["sdpa_backward_ms"]
        lib_is = "scaled_dot_product_attention(enable_gqa=True) " + (
            "forward" if n == "flash_attention_lse" else "backward through autograd")
        if n == BWD_DELTA:
            lib = r["delta_bmm_ms"]
            lib_is = "torch.bmm(dO (N, 1, D), O (N, D, 1), out_dtype=float32)"
        plain = r["forward_twin_ms"] if n == "flash_attention_lse" else r["twin_ms"]
        out_rows.append({
            "name": n, "route": "cuda", "source": BWD_SOURCE, "replaces": BWD_REPLACES,
            "launches": launches["flash_attention" if n == "flash_attention_lse" else n],
            "max_abs_err": errs["lse"] if n == "flash_attention_lse" else
            errs["delta_abs_bfloat16"] if n == BWD_DELTA else errs["abs_bfloat16"],
            "max_err_over_max_want": {"float32": errs["float32"], "bfloat16": errs["bfloat16"]},
            "ms": r["ms"], "plain_ms": plain, "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": lib, "shape": first,
            "plain_is": "the whole backward's twin" if n != "flash_attention_lse"
            else "flash_attention_lse_ref",
            "library_is": lib_is,
            "max_abs_err_float32": errs["abs_float32"], "by_shape": by_shape,
            **({"float32_simt_ms": simt_ms[n]} if n in simt_ms else {}),
            **({"note": "off the path: the dq launch forms delta"} if n == BWD_DELTA else {})})
    for r in out_rows:
        print(f"kernel {r['name']} ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%}) "
              f"library_ms={r['library_ms']:.6f} launches={r['launches']}; card {card}")
    return out_rows


def drive_lm_train(torch, np, seed: int, card: str) -> list:
    """Phase 7c: LM training on the card, after phase 7b (at most 1 GiB
    allocated at its start and end): (a) the backward kernels against
    their twins, (b) the reduced cells of every LM arch card against host
    and the training script's restore, (c) qwen2-1.5b's train_4k at full width and
    depth, (d) Gemma-2 at full width, 4 layers, and the refusals, (e) the
    kernel rows. Returns the rows of the kernels line."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"lm train phase starts with memory_allocated={left}")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated before the LM training phase")
    errs = check_attention_backward(torch, np, seed)
    cells = train_cells_vs_host(torch, np, seed)
    q = qwen2_train(torch, np, seed, card)
    g = gemma_train(torch, np, seed)
    rows = backward_rows(torch, np, seed, q["launches"], errs, card)
    for r in rows:
        r["train_4k"] = {"step_s": q["step_s"], "tokens_s": q["tokens_s"], "busy": q["busy"],
                         "peak_bytes": q["peak"], "device_ms_in_profiled_step": q["kernel_ms"],
                         "grad_err_bf16": max(q["errs"].values()), "control": q["control"],
                         "witness": q["witness"], "float32_grad_err": max(q["f32"]["errs"].values()),
                         "gemma_grad_err": max(g["errs"].values()), "gemma_control": g["control"]}
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"lm train phase s={time.perf_counter() - t0:.3f}; ends with memory_allocated={left}; "
          f"reduced cells {cells}")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated after the LM training phase")
    return rows



# Tolerances of csr_spmm against its twin on the card. float32: both sum
# in float32, the kernel in CSR order and the twin's index_add_ with atomics
# in any order; over a row of n terms that moves the sum by about
# n * 2**-24 of its terms' scale, far below 1e-5 of the largest output even
# at ogb_products' heaviest rows (over 10,000 edges). bfloat16: both round
# the float32 sum once, one bfloat16 step apart at most (2**-8 relative),
# and near zero the float32 difference itself (the atol).
SPMM_F32_SCALED = 1e-5           # atol = SPMM_F32_SCALED * max|want|, rtol 0
SPMM_BF16_RTOL = 2e-2
SPMM_LIB_SCALED = 1e-4           # the yardstick's agreement (a gross check)
# Cora, card against host CPU, three Trainer steps: float32 everywhere, sums
# in another order; the parameters may differ by 2 lr a step (a near-zero
# gradient whose sign differs moves one Adam entry by up to 2 lr), so that
# bound alone cannot tell a card that skipped its updates (each entry moves
# about lr a step) from one that made them. The moments and each leaf's
# change over the three steps can: m and v as the CPU tests hold them, and
# the change within a tenth of the host's in norm, which a card that wrote
# no parameters (1.0) misses.
GNN_GRAD_SCALED = 1e-5           # first-step gradients: atol = 1e-5 * max|g|
GNN_LOSS_RTOL = 1e-5
GNN_MOMENT_RTOL = 1e-5           # m and v: rtol 1e-5, atol 1e-5 * the leaf's max
GNN_CHANGE_RTOL = 0.1            # |dp_card - dp_host| <= 0.1 |dp_host| per leaf
# ogb_products: the loss against the twin path's at GNN_LOSS_RTOL; the
# gradients against a float64 path of the same step, since the twin path's
# own gradients (index_add_'s atomics) differ from run to run by about 1e-4
# x max|g| on this graph: two of its runs on the same inputs are printed.
GNN_MAIN_GRAD_SCALED = 1e-4
GNN_TIMED_STEPS = 10
SPMM_REPLACES = "src/repro/kernels/segment_matmul.py:61"


def _spmm_close(torch, got, want, dtype) -> bool:
    atol = SPMM_F32_SCALED * float(want.float().abs().max()) if want.numel() else 0.0
    rtol = 0.0 if dtype == torch.float32 else SPMM_BF16_RTOL
    return got.shape == want.shape and got.dtype == want.dtype and torch.allclose(
        got.float(), want.float(), rtol=rtol, atol=atol)


def _split_close(torch, got, a, x):
    """The kernel's output against the split twin on the same plan, at
    SPMM_F32_SCALED in either dtype (both round the same float32 sums
    once); (max abs error, bit-identical)."""
    from repro_torch.kernels import ref

    want = ref.csr_spmm_split_ref(x, a.row_ptr, a.col, a.n_rows, a.chunk)
    atol = SPMM_F32_SCALED * float(want.float().abs().max()) if want.numel() else 0.0
    if not (got.dtype == want.dtype and torch.allclose(got.float(), want.float(), rtol=0,
                                                       atol=atol)):
        return None, False
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    return err, bool(torch.equal(got, want))


def check_spmm_kernel(torch, np, seed: int) -> float:
    """Phase 2, csr_spmm against its twins on the card: no edges, isolated
    nodes, one row holding every edge, senders -1 and receivers out of
    range, heavy-tailed rows, more source rows than output rows, no output
    rows, and the plan's edges (rows of exactly C and C + 1 edges, many rows
    just past C, one row of hundreds of chunks), D in {1, 7, 16, 47, 128,
    256, 300}, float32 and bfloat16. Each case is held against the plain
    twin and, at SPMM_F32_SCALED, the split twin on the same plan; its
    launches are counted (csr_spmm once, csr_spmm_combine once where the
    plan cut a row). The backward through CSRSpMM is held against the
    twin's own autograd, and must have taken the split path."""
    from repro_torch.data.graphs import node_graph
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_matmul import SPMM_CHUNK, CSRSpMM, build_csr, csr_spmm_cuda

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    c = SPMM_CHUNK

    def edges(s, r):
        return torch.from_numpy(np.asarray(s, np.int64)).to(DEV), \
            torch.from_numpy(np.asarray(r, np.int64)).to(DEV)

    past = rng.integers(c + 1, c + 9, 2000)  # 2,000 rows of C + 1 .. C + 8 edges
    graphs = {  # name -> (senders, receivers, n_out, n_x)
        "no_edges": (*edges([], []), 500, 500),
        "isolated_nodes": (*edges([0, 1, 2], [5, 5, 7]), 300, 300),
        "one_row": (*edges(rng.integers(0, 1000, 5000), np.full(5000, 3)), 1000, 1000),
        "masked": (*edges(np.where(rng.random(8000) < 0.3, -1, rng.integers(0, 2000, 8000)),
                          rng.integers(-50, 2050, 8000)), 2000, 2000),
        "more_sources": (*edges(rng.integers(0, 3000, 9000), rng.integers(0, 700, 9000)),
                         700, 3000),
        "no_rows": (*edges([0, 1], [0, 1]), 0, 4),
        "rows_of_C": (*edges(rng.integers(0, 1000, 40 * c), np.repeat(np.arange(40), c)),
                      50, 1000),
        "rows_of_C_plus_1": (*edges(rng.integers(0, 1000, 40 * (c + 1)),
                                    np.repeat(np.arange(40), c + 1)), 50, 1000),
        "just_past_C": (*edges(rng.integers(0, 4000, int(past.sum())),
                               np.repeat(np.arange(2000), past)), 2100, 4000),
        # one row of 300 chunks and 17 edges, its senders 200 nodes of about
        # 385 edges each, so the transposed CSR is cut too; beside short rows
        "hundreds_of_chunks": (*edges(np.concatenate([rng.integers(0, 200, 300 * c + 17),
                                                      rng.integers(0, 1000, 3000)]),
                                      np.concatenate([np.full(300 * c + 17, 7),
                                                      rng.integers(0, 600, 3000)])), 600, 1000),
    }
    # The plan's edges take x in multiples of 1/64 in [-1, 1]: every partial
    # sum of their rows (at most 76,817 terms) is exact in float32 and in
    # the bfloat16 rounding, so the sum cannot depend on its order and the
    # kernel must equal both twins bit for bit. (On random normal rows of
    # 76,817 terms the twin's index_add_, whose atomics add in any order,
    # moves the sum by about 1e-5 of itself.)
    exact = ("rows_of_C", "rows_of_C_plus_1", "just_past_C", "hundreds_of_chunks")
    g = node_graph(100_003, 1_200_000, 1, 2, real_nodes=100_003, real_edges=1_200_000,
                   generator=gen)
    graphs["heavy_tailed"] = (g["senders"], g["receivers"], 100_003, 100_003)
    err, n_cases, heavy, split_err, same, bwd_combines = 0.0, 0, 0, 0.0, 0, 0
    for name, (s, r, n_out, n_x) in graphs.items():
        fwd, bwd = build_csr(s, r, n_out, n_x)
        if n_out:
            heavy = max(heavy, int(fwd.row_lengths().max()))
        for dt in (torch.float32, torch.bfloat16):
            for d in (1, 7, 16, 47, 128, 256, 300):
                if name in exact:
                    x = (torch.randint(-64, 65, (n_x, d), generator=gen, device=DEV)
                         .float() / 64).to(dt)
                else:
                    x = torch.randn((n_x, d), generator=gen, device=DEV).to(dt)
                before = dict(ops.launch_counts)
                got = csr_spmm_cuda(x, fwd)
                want = ref.csr_spmm_ref(x, fwd.row_ptr, fwd.col, n_out)
                torch.cuda.synchronize()
                launched = {k: ops.launch_counts[k] - before[k]
                            for k in ("csr_spmm", "csr_spmm_combine")}
                what = f"{name} {str(dt).split('.')[-1]} D={d}"
                expect = {"csr_spmm": 1 if n_out else 0,
                          "csr_spmm_combine": 1 if n_out and fwd.plan.n_long else 0}
                if launched != expect:
                    _fail(f"csr_spmm launched {launched} at {what}, not {expect}")
                if not _spmm_close(torch, got, want, dt):
                    _fail(f"csr_spmm differs from its twin at {what}")
                e_split, bits = _split_close(torch, got, fwd, x)
                if e_split is None:
                    _fail(f"csr_spmm differs from its split twin at {what}")
                if name in exact and not (bits and torch.equal(got, want)):
                    _fail(f"csr_spmm's exact sums differ from its twins' at {what}")
                split_err, same = max(split_err, e_split), same + bits
                if got.numel():
                    err = max(err, float((got.float() - want.float()).abs().max()))
                if name == "no_edges" and got.numel() and float(got.float().abs().max()) != 0:
                    _fail(f"csr_spmm rows with no edges are not 0 at {what}")
                n_cases += 1
        # the backward: the kernel on the transposed CSR against autograd
        # through the twin (index_add_'s own gradient)
        for d in (7, 47):
            x = torch.randn((n_x, d), generator=gen, device=DEV)
            w = torch.randn((n_out, d), generator=gen, device=DEV)
            xk = x.clone().requires_grad_(True)
            out = CSRSpMM.apply(xk, fwd, bwd)
            before = ops.launch_counts["csr_spmm_combine"]
            (out * w).sum().backward()
            bwd_combines += ops.launch_counts["csr_spmm_combine"] - before
            xt = x.clone().requires_grad_(True)
            (ref.csr_spmm_ref(xt, fwd.row_ptr, fwd.col, n_out) * w).sum().backward()
            torch.cuda.synchronize()
            if not _spmm_close(torch, xk.grad, xt.grad, torch.float32):
                _fail(f"csr_spmm's backward differs from the twin's autograd at {name} D={d}")
            err = max(err, float((xk.grad - xt.grad).abs().max()))
            n_cases += 1
    print(f"csr_spmm kernel_vs_plain cases={n_cases} max_abs_err={err} tolerances "
          f"float32 atol={SPMM_F32_SCALED} x max|want|, bfloat16 rtol={SPMM_BF16_RTOL} + the "
          f"same atol; vs the split twin (chunk {c}) max_abs_err={split_err} at atol "
          f"{SPMM_F32_SCALED} x max|want| in both dtypes, bit-identical in {same} of "
          f"{n_cases - 2 * len(graphs)}; backward launches of csr_spmm_combine={bwd_combines}; "
          f"longest row={heavy} edges")
    if not bwd_combines:
        _fail("no backward check took the split path (csr_spmm_combine never launched)")
    return err


def _graph_to(graph, dev):
    """The graph's CSRs and normalisation copied to ``dev``."""
    import dataclasses

    def csr(c):
        return dataclasses.replace(c, row_ptr=c.row_ptr.to(dev), col=c.col.to(dev))

    return dataclasses.replace(graph, fwd=csr(graph.fwd), bwd=csr(graph.bwd),
                               inv_sqrt=graph.inv_sqrt.to(dev))


def _loss_and_grads(torch, model, batch):
    from repro_torch.models.gnn import gnn_loss

    leaves = model.leaves()
    loss = gnn_loss(model, batch)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _f64_loss_and_grads(torch, model, batch):
    """The GCN loss and its gradients in float64, the aggregation a gather
    and an ``index_add_`` on the forward CSR: the plain float64 reference
    of the step, independent of the kernel and its twin."""
    from repro_torch.models.gnn import node_loss

    graph = batch["graph"]
    fwd = graph.fwd
    rows = torch.repeat_interleave(torch.arange(fwd.n_rows, device=fwd.col.device),
                                   fwd.row_lengths(), output_size=fwd.col.numel())
    col, s = fwd.col.long(), graph.inv_sqrt.double()
    leaves = {k: p.detach().double().requires_grad_(True) for k, p in model.leaves().items()}
    h = batch["x"].double()
    for i in range(len(model.w)):
        h = h @ leaves[f"layers/{i}/w"] + leaves[f"layers/{i}/b"]
        agg = torch.zeros_like(h).index_add_(0, rows, (h * s)[col]) * s
        h = agg + h * (s * s)
        h = torch.relu(h) if i < len(model.w) - 1 else h
    loss = node_loss(h, batch["y"])
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _grad_errs(got: dict, want: dict) -> dict:
    """Each leaf's max abs error over its largest |want|."""
    return {k: float((got[k].to(w.device).double() - w.double()).abs().max() / w.abs().max())
            for k, w in want.items()}


def _grads_close(torch, got: dict, want: dict, scaled: float) -> float:
    """Max abs error over the leaves; fails unless every leaf is within
    ``scaled`` x its largest |want|."""
    worst = 0.0
    for k, w in want.items():
        g = got[k].to(w.device)
        e = float((g - w).abs().max())
        if e > scaled * float(w.abs().max()):
            _fail(f"gradient {k} differs: max abs err {e}, max|g| {float(w.abs().max())}")
        worst = max(worst, e)
    return worst


def _cora_state_check(torch, p, m, v, want: dict, p0: dict, sum_lr: float) -> dict:
    """Parameters ``p`` and moments ``m``, ``v`` (dicts by leaf path) after
    three steps against the host's (``want``, with "p", "m", "v"), from the
    parameters ``p0``: the largest errors and whether every check holds."""
    out = {"p_err": 0.0, "m_err": 0.0, "v_err": 0.0, "change_rel": 0.0, "ok": True}
    for k, wp in want["p"].items():
        if float((p[k].cpu() - wp).abs().max()) > 2 * sum_lr:
            out["ok"] = False
        out["p_err"] = max(out["p_err"], float((p[k].cpu() - wp).abs().max()))
        for name, got in (("m", m[k]), ("v", v[k])):
            w = want[name][k]
            g = got.cpu()
            out[f"{name}_err"] = max(out[f"{name}_err"], float((g - w).abs().max()))
            if not torch.allclose(g, w, rtol=GNN_MOMENT_RTOL,
                                  atol=GNN_MOMENT_RTOL * float(w.abs().max())):
                out["ok"] = False
        d_want = wp - p0[k]
        d_got = p[k].cpu() - p0[k]
        den = float(d_want.norm())  # 0 where only weight decay could move it, and it did not
        rel = float((d_got - d_want).norm()) / den if den else (
            0.0 if float(d_got.norm()) == 0 else float("inf"))
        out["change_rel"] = max(out["change_rel"], rel)
        if not rel <= GNN_CHANGE_RTOL:
            out["ok"] = False
    return out


def gnn_vs_host(torch, np, seed: int) -> None:
    """gcn-cora on full_graph_sm (2,816 nodes, 1,433 features) from the same
    parameters and graph on the card, through the kernel, and on the host
    CPU, through the twin: the first step's gradients, each of three
    Trainer steps' loss, and the parameters, their change and the moments
    after them, with two controls that the last check must reject: no
    update at all, and moments updated but no parameter written."""
    import itertools

    from repro_torch.launch.steps import build_cell
    from repro_torch.models.gnn import GCN, gnn_loss
    from repro_torch.train import Trainer, TrainerConfig

    cell = build_cell("gcn-cora", "full_graph_sm", seed=seed)
    card, _, batch = cell.args
    params = {"layers": [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
                         for w, b in zip(card.w, card.b)]}
    host = GCN.from_numpy_params(params, card.cfg, device="cpu")
    p0 = {k: t.detach().clone() for k, t in host.leaves().items()}
    host_batch = {"x": batch["x"].cpu(), "y": batch["y"].cpu(),
                  "graph": _graph_to(batch["graph"], "cpu")}
    _, g_card = _loss_and_grads(torch, card, batch)
    _, g_host = _loss_and_grads(torch, host, host_batch)
    g_err = _grads_close(torch, g_card, g_host, GNN_GRAD_SCALED)
    logs, states = [], []
    for model, b in ((card, batch), (host, host_batch)):
        trainer = Trainer(lambda x, m=model: gnn_loss(m, x), model.leaves(),
                          TrainerConfig(log_every=1))
        logs.append(trainer.run(itertools.repeat(b), steps=3))
        states.append(trainer.opt_state)
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(*logs))
    if loss_err > GNN_LOSS_RTOL:
        _fail(f"gcn-cora full_graph_sm: card losses {[r['loss'] for r in logs[0]]} differ from "
              f"the host's {[r['loss'] for r in logs[1]]}")
    if int(states[0]["step"]) != int(states[1]["step"]) or int(states[1]["step"]) != 3:
        _fail(f"gcn-cora full_graph_sm: AdamW steps {int(states[0]['step'])} on the card, "
              f"{int(states[1]['step'])} on the host, not 3")
    sum_lr = sum(r["lr"] for r in logs[1])
    want = {"p": {k: t.detach() for k, t in host.leaves().items()},
            "m": states[1]["m"], "v": states[1]["v"]}
    got = _cora_state_check(torch, {k: t.detach() for k, t in card.leaves().items()},
                            states[0]["m"], states[0]["v"], want, p0, sum_lr)
    zeros = {k: torch.zeros_like(t) for k, t in p0.items()}
    controls = {"no update": _cora_state_check(torch, p0, zeros, zeros, want, p0, sum_lr),
                "moments but no parameter write": _cora_state_check(
                    torch, p0, want["m"], want["v"], want, p0, sum_lr)}
    print(f"gnn small graph card vs host CPU (full_graph_sm, 2,816 nodes x 1,433): first-step "
          f"grads max_abs_err={g_err} tol={GNN_GRAD_SCALED} x max|g|; 3 Trainer steps loss "
          f"max_rel_err={loss_err} tol={GNN_LOSS_RTOL} losses={[r['loss'] for r in logs[0]]}; "
          f"after 3 steps params max_abs_err={got['p_err']} limit={2 * sum_lr}, m max_abs_err="
          f"{got['m_err']} v max_abs_err={got['v_err']} tol rtol={GNN_MOMENT_RTOL} + "
          f"{GNN_MOMENT_RTOL} x max, change max_rel_err={got['change_rel']} tol="
          f"{GNN_CHANGE_RTOL}; controls: " + "; ".join(
              f"{n}: m_err={c['m_err']} change_rel={c['change_rel']} passes={c['ok']}"
              for n, c in controls.items()))
    if not got["ok"]:
        _fail("gcn-cora full_graph_sm: the card's parameters or moments after 3 steps differ "
              "from the host's")
    for n, c in controls.items():
        if c["ok"]:
            _fail(f"the full_graph_sm state check does not tell the control ({n}) from the host")
    del cell, card, batch, states


def _snapshot(model, opt_state) -> dict:
    out = {"p": {k: p.detach().clone() for k, p in model.leaves().items()},
           "step": opt_state["step"].clone()}
    for name in ("master", "m", "v"):
        out[name] = {k: None if t is None else t.clone() for k, t in opt_state[name].items()}
    return out


def _restore(torch, model, opt_state, snap) -> None:
    with torch.no_grad():
        for k, p in model.leaves().items():
            p.copy_(snap["p"][k])
        opt_state["step"].copy_(snap["step"])
        for name in ("master", "m", "v"):
            for k, t in opt_state[name].items():
                if t is not None:
                    t.copy_(snap[name][k])


def _last_edge_dropped(torch, row_ptr, col):
    """The control's CSR: every non-empty row without its last entry, as a
    kernel that stopped one edge early would read it."""
    lengths = row_ptr[1:] - row_ptr[:-1]
    keep = torch.ones(col.numel(), dtype=torch.bool, device=col.device)
    keep[row_ptr[1:][lengths > 0] - 1] = False
    short = (lengths - 1).clamp(min=0)
    return torch.cat([row_ptr.new_zeros(1), short.cumsum(0)]), col[keep]


def _no_reuse_bytes(torch, x, a) -> tuple:
    """(bytes, gathered sectors) of one launch if every edge's x row came
    from device memory: the 32-byte sectors that each gathered row spans,
    plus row_ptr, col and out once."""
    n_x, d = x.shape
    rb = d * x.element_size()
    j = torch.arange(n_x, device=x.device, dtype=torch.int64)
    spans = ((j + 1) * rb - 1) // 32 - (j * rb) // 32 + 1
    sectors = int(spans[a.col.long()].sum())
    return sectors * 32 + a.row_ptr.numel() * 8 + a.col.numel() * 4 + a.n_rows * rb, sectors


def _heavy_rows_emptied(torch, a, limit: int):
    """The CSR ``a`` with every row of more than ``limit`` edges emptied, and
    the count of those rows and of their edges."""
    from repro_torch.kernels.segment_matmul import CSR

    lengths = a.row_lengths()
    heavy = lengths > limit
    keep = torch.repeat_interleave(~heavy, lengths, output_size=a.col.numel())
    short = torch.where(heavy, 0, lengths)
    b = CSR(torch.cat([a.row_ptr.new_zeros(1), short.cumsum(0)]), a.col[keep].contiguous(),
            a.n_cols, a.chunk)
    return b, int(heavy.sum()), int(lengths[heavy].sum())


SPMM_SWEEP = (64, 128, 256, 512, 1024, 4096)  # chunk sizes timed at D = 16 and D = 47
SPMM_HEAVY = 1024                             # rows above this many edges are emptied once


def _combine_row(torch, x, a, reps: int = 50) -> dict:
    """csr_spmm_combine on the split twin's partials of ``a``'s chunks (the
    plan's layout): held against the twin's combine at SPMM_F32_SCALED,
    its device time per launch read from the profiler (a launch is shorter
    than the wrapper takes to issue it), beside the twin's combine and its
    bound (the partials read once, the long rows written once)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_matmul import csr_spmm_combine_cuda

    p = a.plan
    part = ref.csr_spmm_partials_ref(x, a.col, p.chunk_start, p.chunk_end)
    rows = p.items(a.row_ptr)[0][:p.n_chunks]
    want = ref.csr_spmm_combine_ref(part, rows, a.n_rows, x.dtype)[p.long_rows.long()]
    out = torch.zeros((a.n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    got = csr_spmm_combine_cuda(part, a, out)[p.long_rows.long()]
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if err > SPMM_F32_SCALED * float(want.float().abs().max()):
        _fail(f"csr_spmm_combine differs from the twin's combine ({err})")
    ms = []
    for _ in range(2):
        _, _, avgs = _profile(torch, lambda: [csr_spmm_combine_cuda(part, a, out)
                                              for _ in range(reps)])
        hits = [e for e in avgs if "combine_kernel" in e.key]
        seen = sum(e.count for e in hits)
        if seen:  # the trace may lose launches: average over those it holds
            ms.append(sum(getattr(e, "self_device_time_total", 0) for e in hits) / seen / 1e3)
    issue_ms = _time_ms(torch, lambda: csr_spmm_combine_cuda(part, a, out), reps)
    plain = min(_time_ms(torch, lambda: ref.csr_spmm_combine_ref(part, rows, a.n_rows, x.dtype),
                         3) for _ in range(2))
    nbytes = (part.numel() * 4 + p.n_long * x.shape[1] * x.element_size()
              + p.chunk_ptr.numel() * 8 + p.n_long * 4)
    return {"ms": min(ms) if ms else issue_ms, "plain_ms": plain,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "max_abs_err": err, "ms_issue_bound": issue_ms,
            "n_long": p.n_long, "n_chunks": p.n_chunks}


def time_spmm(torch, calls: list, max_in_degree: int, card: str) -> tuple:
    """csr_spmm on the inputs of one ogb_products step's four launches: held
    against its twin in float32 (with the control, which must fail) and the
    split twin, timed beside its twin, torch.sparse.mm on the same CSR (the
    yardstick), its bound (bytes at 3.35 TB/s against one add per edge and
    feature at 67 TFLOP/s) and the bytes with no reuse of any x row; its
    combine kernel on the split twin's partials. At the D = 16 and D = 47
    forward launches, a sweep of the chunk size and the time with the rows of
    more than SPMM_HEAVY edges emptied. Returns (the four launches' rows,
    the combine's rows)."""
    import dataclasses

    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_matmul import csr_spmm_cuda

    names = ("forward layer 0", "forward layer 1", "backward layer 1", "backward layer 0")
    rows, combines = [], []
    for i, (what, (x, a)) in enumerate(zip(names, calls)):
        row_ptr, col, n_out = a.row_ptr, a.col, a.n_rows
        n_x, d = x.shape
        nnz = col.numel()
        want = ref.csr_spmm_ref(x, row_ptr, col, n_out)
        got = csr_spmm_cuda(x, a)
        ctrl = ref.csr_spmm_ref(x, *_last_edge_dropped(torch, row_ptr, col), n_out)
        atol = SPMM_F32_SCALED * float(want.abs().max())
        err, c_err = float((got - want).abs().max()), float((ctrl - want).abs().max())
        ok = torch.allclose(got, want, rtol=0, atol=atol)
        ctrl_passes = torch.allclose(ctrl, want, rtol=0, atol=atol)
        e_split, bits = _split_close(torch, got, a, x)
        print(f"csr_spmm vs twin at ogb_products {what} (D={d}, rows={n_out}, nnz={nnz}, "
              f"{x.dtype}): max_abs_err={err} tol atol={atol} ({SPMM_F32_SCALED} x max|want| "
              f"{float(want.abs().max())}); control (last edge of each row dropped) "
              f"max_abs_err={c_err} passes={ctrl_passes}; vs the split twin max_abs_err="
              f"{e_split} bit-identical={bits}")
        if not ok:
            _fail(f"csr_spmm differs from its twin at ogb_products {what}")
        if ctrl_passes:
            _fail(f"the comparison at ogb_products {what} does not tell the control from the twin")
        if e_split is None:
            _fail(f"csr_spmm differs from its split twin at ogb_products {what}")
        del want, ctrl
        a_csr = torch.sparse_csr_tensor(row_ptr, col.to(torch.int64),
                                            torch.ones(nnz, device=x.device),
                                            size=(n_out, n_x), check_invariants=False)

        def lib(a=a_csr, x=x):
            return torch.sparse.mm(a, x)

        lib_err = float((lib() - got).abs().max())
        if lib_err > SPMM_LIB_SCALED * float(got.abs().max()):
            _fail(f"torch.sparse.mm computes another function at {what} ({lib_err})")
        plain_a = _time_ms(torch, lambda: ref.csr_spmm_ref(x, row_ptr, col, n_out), 3)
        ms_a = _time_ms(torch, lambda: csr_spmm_cuda(x, a), 20)
        lib_a = _time_ms(torch, lib, 20)
        lib_b = _time_ms(torch, lib, 20)
        ms_b = _time_ms(torch, lambda: csr_spmm_cuda(x, a), 20)
        plain_b = _time_ms(torch, lambda: ref.csr_spmm_ref(x, row_ptr, col, n_out), 3)
        es = x.element_size()
        nbytes = n_x * d * es + row_ptr.numel() * 8 + nnz * 4 + n_out * d * es
        nops = nnz * d
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / CORE_OPS_PER_S * 1e3
        nr_bytes, sectors = _no_reuse_bytes(torch, x, a)
        p = a.plan
        row = {"what": what, "D": d, "rows": n_out, "source_rows": n_x, "nnz": nnz,
               "ms": min(ms_a, ms_b), "plain_ms": min(plain_a, plain_b),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": min(lib_a, lib_b), "max_abs_err": err, "control_err": c_err,
               "no_reuse_ms": nr_bytes / HBM_BYTES_PER_S * 1e3, "chunk": p.chunk,
               "long_rows": p.n_long, "chunks": p.n_chunks, "items": p.n_items}
        print(f"kernel csr_spmm at ogb_products {what}: D={d} ms={row['ms']:.6f} (runs "
              f"{ms_a:.6f} {ms_b:.6f}) plain_ms={row['plain_ms']:.6f} library_ms="
              f"{row['library_ms']:.6f} (torch.sparse.mm, CSR of ones; vs kernel {lib_err}) "
              f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}: {nbytes} B, {nops} adds) "
              f"no_reuse_ms={row['no_reuse_ms']:.6f} ({sectors} gathered 32-byte sectors, "
              f"{nr_bytes} B) achieved {nbytes / row['ms'] / 1e9:.3f} TB/s of the bound's bytes; "
              f"plan chunk={p.chunk} long_rows={p.n_long} chunks={p.n_chunks} "
              f"items={p.n_items}; max in-degree {max_in_degree}; {card}")
        if i < 2:  # the D = 16 and D = 47 forward launches
            sweep = {}
            for c in SPMM_SWEEP:
                b = dataclasses.replace(a, chunk=c)
                if not torch.allclose(csr_spmm_cuda(x, b), got, rtol=0, atol=atol):
                    _fail(f"csr_spmm at chunk {c} differs at ogb_products {what}")
                sweep[c] = (_time_ms(torch, lambda b=b: csr_spmm_cuda(x, b), 10),
                            b.plan.n_long, b.plan.n_chunks)
            print(f"csr_spmm chunk sweep at ogb_products {what} (D={d}): " + " ".join(
                f"{c}={ms:.6f}ms ({nl} long rows, {nc} chunks)"
                for c, (ms, nl, nc) in sweep.items()))
            row["ms_by_chunk"] = {str(c): v[0] for c, v in sweep.items()}
            b, n_heavy, e_heavy = _heavy_rows_emptied(torch, a, SPMM_HEAVY)
            t_full = _time_ms(torch, lambda: csr_spmm_cuda(x, a), 20)
            t_light = _time_ms(torch, lambda: csr_spmm_cuda(x, b), 20)
            t_full_b = _time_ms(torch, lambda: csr_spmm_cuda(x, a), 20)
            light = b.col.numel()
            print(f"csr_spmm at ogb_products {what} (D={d}) with its {n_heavy} rows of more than "
                  f"{SPMM_HEAVY} edges emptied ({e_heavy} of {nnz} edges, "
                  f"{e_heavy / nnz:.6f}): ms={t_light:.6f} against {t_full:.6f} {t_full_b:.6f} "
                  f"with them; time share {t_light / min(t_full, t_full_b):.6f}, edge share "
                  f"{light / nnz:.6f}")
            row["heavy_rows_emptied"] = {"rows": n_heavy, "edges": e_heavy, "ms": t_light,
                                         "ms_with_them": min(t_full, t_full_b)}
            del b
        comb = _combine_row(torch, x, a)
        print(f"kernel csr_spmm_combine at ogb_products {what}: {comb['n_long']} long rows, "
              f"{comb['n_chunks']} chunk partials, ms={comb['ms']} (device time per traced "
              f"launch, profiler; events over 50 back-to-back calls {comb['ms_issue_bound']:.6f}) "
              f"plain_ms={comb['plain_ms']:.6f} bound_ms={comb['bound_ms']:.6f} max_abs_err vs "
              f"the twin's combine={comb['max_abs_err']}")
        rows.append(row)
        combines.append(comb)
        del got, a_csr
    return rows, combines


SPMM_SASS_RUNS = {  # kernel instance (mangled template arguments) -> least gathers in a row
    "csr_spmm_kernel<fLb1ELi1E>": 8,   # float32, 16-byte units, D = 16: 8 float4 rows
    "csr_spmm_kernel<fLb0ELi3E>": 15,  # float32, 4-byte units, D = 47: 5 rows x 3 floats
}


def _gather_runs(source: str) -> dict:
    """The longest run of global loads (LDG) with no float add (FADD)
    between them, in each kernel of csrc/<source>.cu's build, read from its
    SASS by cuobjdump (static); fails where an instance of SPMM_SASS_RUNS
    has fewer than its least, and is empty where the toolkit has no
    cuobjdump."""
    import re
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("cuobjdump not found: gathers in a row not measured")
        return {}
    sass = subprocess.run([tool, "-sass", str(_build._target(source))], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        sym = fn.split()[0]
        name = re.search(r"\d([a-z_]+_kernel)I(\w+?)EEv", sym)
        key = f"{name.group(1)}<{name.group(2)}>" if name else sym
        best = run = 0
        for ins in re.findall(r"\b(LDG|FADD)\b", fn):
            run = run + 1 if ins == "LDG" else 0
            best = max(best, run)
        out[key] = best
    print(f"global loads in a row, no float add between, in {source}.cu by kernel (SASS, "
          f"static): {out}")
    for key, least in SPMM_SASS_RUNS.items():
        if out.get(key, 0) < least:
            _fail(f"{key} issues {out.get(key, 0)} gathers in a row, not {least}")
    return out


def drive_gnn(torch, np, seed: int, errs: dict, card: str) -> list:
    """Phase 8: train gcn-cora (2 layers, hidden 16) on the ogb_products cell
    at full size after the LM phase has freed the card; returns the
    csr_spmm and csr_spmm_combine rows of the kernels line."""
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import _gnn_sizes, build_cell

    left = torch.cuda.memory_allocated()
    print(f"gnn phase on {card} starts with memory_allocated={left}")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated after the LM phase")
    sass = _gather_runs("segment_matmul")
    gnn_vs_host(torch, np, seed)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = build_cell("gcn-cora", "ogb_products", seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model, opt_state, batch = cell.args
    graph = batch["graph"]
    in_deg = graph.fwd.row_lengths()
    max_in = int(in_deg.max())
    n, e, _, _, real_n, real_e = _gnn_sizes(GNN_SHAPES["ogb_products"], False)
    print(f"ogb_products graph: nodes={graph.n_nodes} ({real_n} published, padded to {n}) "
          f"edges={graph.fwd.col.numel()} ({real_e} published, padded to {e}), features={tuple(batch['x'].shape)} classes={model.w[-1].shape[1]} "
          f"in-degree mean={float(in_deg.float().mean()):.4f} max={max_in} out-degree max="
          f"{int(graph.bwd.row_lengths().max())} build_s={build_s:.6f} (graph drawn, both "
          f"CSRs sorted, model and AdamW state, on the card)")

    counts, (loss, metrics) = _served_counts(torch, cell.run)  # also the warm-up step
    print(f"launches csr_spmm {counts['csr_spmm']} csr_spmm_combine "
          f"{counts['csr_spmm_combine']} (one ogb_products train step; expected 4 and 4: "
          f"both CSRs hold rows of more than {graph.fwd.chunk} edges, "
          f"{graph.fwd.plan.n_long} and {graph.bwd.plan.n_long})")
    if counts["csr_spmm"] != 4:
        _fail(f"one gcn-cora step launched csr_spmm {counts['csr_spmm']} times, not 4")
    cut = 2 * (bool(graph.fwd.plan.n_long) + bool(graph.bwd.plan.n_long))
    if counts["csr_spmm_combine"] != cut or not cut:
        _fail(f"one gcn-cora step launched csr_spmm_combine {counts['csr_spmm_combine']} "
              f"times, not {cut} (and more than 0)")
    if not (bool(torch.isfinite(loss)) and bool(torch.isfinite(metrics["grad_norm"]))):
        _fail("the ogb_products step's loss or gradient norm is not finite")
    times, losses = [], []
    for _ in range(GNN_TIMED_STEPS):
        t0 = time.perf_counter()
        loss, metrics = cell.run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    ms = np.array(times) * 1e3
    print(f"ogb_products train steps={GNN_TIMED_STEPS} step_ms_median={float(np.median(ms)):.6f} "
          f"mean={float(ms.mean()):.6f} min={float(ms.min()):.6f} steps_ms="
          f"{[round(t, 6) for t in ms.tolist()]} losses={losses} on {card}")
    wall, dev, avgs = _profile(torch, lambda: [cell.run() for _ in range(3)])
    print(f"device busy ogb_products 3 steps: wall_s={wall:.6f} kernel_s={dev:.6f} busy_share="
          f"{dev / wall if dev > 0 else 'not measured'}")
    print(f"ogb_products step kernels by device time: {_top_kernels(avgs, 10)}")
    print(f"ogb_products peak max_memory_allocated={torch.cuda.max_memory_allocated()}")

    # the kernel at the main path's own shapes: the four launches of one step
    calls = []
    real = ops.csr_spmm

    def rec(x, a):
        calls.append((x.detach(), a))
        return real(x, a)

    snap = _snapshot(model, opt_state)
    ops.csr_spmm = rec
    try:
        cell.run()
    finally:
        ops.csr_spmm = real
    _restore(torch, model, opt_state, snap)
    if [a[0].shape[1] for a in calls] != [16, 47, 47, 16]:
        _fail(f"one step's csr_spmm widths are {[a[0].shape[1] for a in calls]}")
    with torch.no_grad():
        rows, combines = time_spmm(torch, calls, max_in, card)
    del calls

    # the kernel path against the twin path (loss) and a float64 path
    # (gradients), from the same state
    l_k, g_k = _loss_and_grads(torch, model, batch)
    with _Twins():
        l_t, g_t = _loss_and_grads(torch, model, batch)
        _, g_t2 = _loss_and_grads(torch, model, batch)
    l_64, g_64 = _f64_loss_and_grads(torch, model, batch)
    # a reading, not a check: the float32 step with every aggregation summed
    # in float64 and rounded once, the closest a float32 kernel can come
    real = ops.csr_spmm
    ops.csr_spmm = _f64_spmm(torch)
    try:
        _, g_r = _loss_and_grads(torch, model, batch)
    finally:
        ops.csr_spmm = real
    l_err = abs(float(l_k) - float(l_t)) / abs(float(l_t))
    e_k, e_t = _grad_errs(g_k, g_64), _grad_errs(g_t, g_64)
    e_tt, e_kt = _grad_errs(g_t2, g_t), _grad_errs(g_k, g_t)
    g_err = max(e_k.values())
    print(f"ogb_products gradients over max|g| per leaf: kernel path vs float64 {e_k} "
          f"(tol {GNN_MAIN_GRAD_SCALED}); twin path vs float64 {e_t}; twin path vs itself "
          f"{e_tt}; kernel path vs twin path {e_kt}; aggregation rounded once vs float64 "
          f"{_grad_errs(g_r, g_64)}; loss kernel {float(l_k)} twin {float(l_t)} float64 "
          f"{float(l_64)}")
    if l_err > GNN_LOSS_RTOL:
        _fail(f"ogb_products kernel path loss {float(l_k)} differs from the twin path's "
              f"{float(l_t)}")
    if g_err > GNN_MAIN_GRAD_SCALED:
        _fail(f"ogb_products kernel path gradients differ from the float64 path's: {e_k}")
    del g_t2, g_64, g_r
    # determinism: the same step twice from the same state, bit for bit
    outs = []
    for _ in range(2):
        _restore(torch, model, opt_state, snap)
        loss, _ = cell.run()
        outs.append((loss.clone(), _snapshot(model, opt_state)))
    (l1, s1), (l2, s2) = outs
    same = torch.equal(l1, l2) and all(
        torch.equal(s1[n][k], s2[n][k]) for n in ("p", "master", "m", "v") for k in s1[n])
    print(f"ogb_products kernel vs twin path: loss {float(l_k)} vs {float(l_t)} rel_err={l_err} "
          f"tol={GNN_LOSS_RTOL}; grads vs float64 max_err={g_err} tol={GNN_MAIN_GRAD_SCALED} x max|g|; "
          f"kernel path twice from one state bit-identical={same}")
    if not same:
        _fail("two ogb_products steps from the same state are not bit-identical")
    del cell, model, opt_state, batch, graph, in_deg, snap, outs, g_k, g_t, s1, s2
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"gnn phase ends with memory_allocated={left}")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated after the GNN phase")

    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms", "no_reuse_ms")}
    c_total = {k: sum(r[k] for r in combines) for k in ("ms", "plain_ms", "bound_ms")}
    source = "src/repro_torch/csrc/segment_matmul.cu"
    return [{"name": "csr_spmm", "route": "cuda", "source": source,
             "replaces": SPMM_REPLACES, "launches": counts["csr_spmm"],
             "max_abs_err": max(errs["csr_spmm"], *(r["max_abs_err"] for r in rows)),
             **total, "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
             else "operations",
             "shape": "one ogb_products train step: the sums over its 4 launches, each timed "
             "as the wrapper runs it (csr_spmm, then csr_spmm_combine)",
             "per_launch": rows, "max_in_degree": max_in, "sass_gathers_in_a_row": sass},
            {"name": "csr_spmm_combine", "route": "cuda", "source": source,
             "replaces": SPMM_REPLACES, "launches": counts["csr_spmm_combine"],
             "max_abs_err": max(r["max_abs_err"] for r in combines), **c_total,
             "bound_by": "bytes", "library_ms": None,
             "shape": "one ogb_products train step: the sums over its 4 launches, on the "
             "split twin's partials", "per_launch": combines}]


# Phase 8b: the reference example's training path (store -> sampler ->
# GatedGCN -> Trainer with checkpoints, a failure and the restore) at
# minibatch_lg's batch shape on phase 3's graph, with GatedGCN at full width.
# Tolerances, kernel path against twin path on one step: both sum each
# aggregation in float32 (the twin's index_add_ in any order), which moves a
# sum by about n * 2**-24 of its terms; 16 layers of layer norms pass that
# on, so the loss is held at rtol 1e-5 and each gradient leaf at 1e-3 of its
# largest entry. Card against host CPU, 3 steps of the reduced config: the
# same sums in another order, losses at rtol 1e-4.
GATED_SEEDS = 1024          # minibatch_lg's batch_nodes
GATED_FANOUTS = (15, 10)    # minibatch_lg's fanouts
GATED_LOSS_RTOL = 1e-5
GATED_GRAD_SCALED = 1e-3
GATED_HOST_RTOL = 1e-4
GATED_STEPS = 80            # the schedule (the example's 300 / 50 / 120 until phase 7c)
GATED_CKPT_EVERY = 20
GATED_FAIL_AT = 50
GATED_RESTORED = GATED_FAIL_AT // GATED_CKPT_EVERY * GATED_CKPT_EVERY  # the step restored
CODEC_STEPS = 10            # steps a codec in 8b (d) (20 until phase 7c)
OVERLAP_STEPS = 5           # steps with and without an async save in flight (e) (10 until 7c)
FILLED_STEPS = 5            # timed steps on the filled batch (b) (10 until 7c)
SAMPLES_TIMED = 10


def _csc_keys(torch, indptr, indices, n: int):
    """dst * n + src of every CSC edge (row dst lists its in-neighbours)."""
    rows = torch.repeat_interleave(torch.arange(n, device=indptr.device), indptr.diff(),
                                   output_size=indices.numel())
    return torch.unique(rows * n + indices)


def _sample_ok(torch, batch, keys, n: int, fanouts) -> bool:
    """The sampler's invariants, on the card, read with one host copy: every
    sampled edge is a CSC edge, no (dst, src) repeats in a block, no receiver
    exceeds its fanout, node_ids is sorted, unique and holds every seed, and
    senders / receivers index it."""
    ids = batch.node_ids
    m = ids.numel()
    checks = [(ids[1:] > ids[:-1]).all(), torch.isin(batch.seeds, ids).all()]
    for blk, f in zip(batch.blocks, fanouts):
        inside = (blk.senders >= 0).all() & (blk.senders < m).all() & \
            (blk.receivers >= 0).all() & (blk.receivers < m).all()
        key = ids[blk.receivers.clamp(0, m - 1)] * n + ids[blk.senders.clamp(0, m - 1)]
        checks += [inside, torch.isin(key, keys).all(),
                   torch.tensor(torch.unique(key).numel() == key.numel(), device=ids.device),
                   torch.bincount(blk.receivers, minlength=1).max() <= f]
    return bool(torch.stack(checks).all())


def _planted_non_edge(torch, batch, keys, n: int):
    """The batch with the first sampled edge's sender swapped for a node
    that is not its receiver's in-neighbour (the control)."""
    import copy

    bad = copy.deepcopy(batch)
    blk = bad.blocks[0]
    ids = bad.node_ids
    dst = int(ids[blk.receivers[0]])
    for j in range(ids.numel()):
        if not bool(torch.isin(torch.tensor([dst * n + int(ids[j])], device=ids.device), keys)):
            blk.senders[0] = j
            return bad
    _fail("phase 8b's control found no non-edge to plant")


def _state_copy(trainer) -> list:
    from repro_torch.train.checkpoint import flatten, host_copy

    return flatten(host_copy({"params": trainer.params, "opt_state": trainer.opt_state}))


def _saved_leaves(np, torch, path: str) -> list:
    """(path, tensor) of a checkpoint step's leaves, read with numpy from
    its manifest and .npy files (no port code)."""
    import os

    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    return [(rec["path"], torch.from_numpy(np.load(os.path.join(path, rec["file"]))))
            for rec in manifest["leaves"]]


def _same_state(torch, a: list, b: list) -> bool:
    return [p for p, _ in a] == [p for p, _ in b] and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()) for (_, x), (_, y) in zip(a, b))


def _gated_spmm_row(torch, what: str, x, a, card: str, arch: str = "GatedGCN") -> dict:
    """csr_spmm at GatedGCN's edge-id CSR: held against its twin run in
    float64 and against the split twin on the same plan, timed beside the
    twin and torch.sparse.mm, with its bound.

    A batch's padded edges all sit on one dummy row (about 69,000 of the
    filled batch's edges, 167,710 of the store's), and on random normal
    rows that long the float32 twin's index_add_, whose atomics add in any
    order, moves the sum by about 1e-5 of the largest output from run to
    run (0.00696 in one run): the float32 twin cannot stand as the answer
    there. Its float64 run can, at the same SPMM_F32_SCALED; the float32
    twin's own distance from it is printed beside the kernel's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_matmul import csr_spmm_cuda

    row_ptr, col, n_out = a.row_ptr, a.col, a.n_rows
    n_x, d = x.shape
    nnz = col.numel()
    rows = torch.repeat_interleave(torch.arange(n_out, device=x.device),
                                   row_ptr[1:] - row_ptr[:-1], output_size=nnz)
    want = torch.zeros((n_out, d), dtype=torch.float64, device=x.device).index_add_(
        0, rows, x[col.to(torch.int64)].double())  # the twin's sum, in float64
    del rows
    got = csr_spmm_cuda(x, a)
    err = float((got.double() - want).abs().max())
    twin_err = float((ref.csr_spmm_ref(x, row_ptr, col, n_out).double() - want).abs().max())
    if err > SPMM_F32_SCALED * float(want.abs().max()):
        _fail(f"csr_spmm differs from its twin (run in float64) at {arch}'s {what} ({err})")
    split_err, bits = _split_close(torch, got, a, x)
    if split_err is None:
        _fail(f"csr_spmm differs from its split twin at {arch}'s {what}")
    a_csr = torch.sparse_csr_tensor(row_ptr, col.to(torch.int64), torch.ones(nnz, device=DEV),
                                    size=(n_out, n_x), check_invariants=False)
    plain_a = _time_ms(torch, lambda: ref.csr_spmm_ref(x, row_ptr, col, n_out), 5)
    ms_a = _time_ms(torch, lambda: csr_spmm_cuda(x, a), 20)
    lib_a = _time_ms(torch, lambda: torch.sparse.mm(a_csr, x), 20)
    lib_b = _time_ms(torch, lambda: torch.sparse.mm(a_csr, x), 20)
    ms_b = _time_ms(torch, lambda: csr_spmm_cuda(x, a), 20)
    plain_b = _time_ms(torch, lambda: ref.csr_spmm_ref(x, row_ptr, col, n_out), 5)
    nbytes = n_x * d * 4 + row_ptr.numel() * 8 + nnz * 4 + n_out * d * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nnz * d / CORE_OPS_PER_S * 1e3
    row = {"what": what, "D": d, "rows": n_out, "source_rows": n_x, "nnz": nnz,
           "ms": min(ms_a, ms_b), "plain_ms": min(plain_a, plain_b),
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
           else "operations", "library_ms": min(lib_a, lib_b), "max_abs_err": err,
           "float32_twin_err": twin_err, "split_err": split_err, "split_bit_identical": bits,
           "long_rows": a.plan.n_long, "chunks": a.plan.n_chunks}
    print(f"kernel csr_spmm at {arch} {what}: D={d} rows={n_out} nnz={nnz} "
          f"ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} library_ms={row['library_ms']:.6f} "
          f"(torch.sparse.mm) bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, {nbytes} B) "
          f"max_abs_err={err} vs the float64 twin (tol {SPMM_F32_SCALED} x max|want| "
          f"{float(want.abs().max())}; the float32 twin's own {twin_err}), vs the split twin "
          f"{split_err} bit-identical={bits}; long_rows={a.plan.n_long} "
          f"chunks={a.plan.n_chunks} on {card}")
    return row


def _gated_grads(torch, model, batch) -> tuple:
    from repro_torch.models.gnn import gatedgcn_loss

    leaves = model.leaves()
    loss = gatedgcn_loss(model, batch)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _gated_step_launches(torch, model, batch) -> tuple:
    """One step's loss and gradients on the kernel path, with its csr_spmm
    launches and combines checked exactly: 4 a layer, and 2 combines a
    layer for each of the two CSRs that holds a row cut into chunks."""
    counts, (loss, grads) = _served_counts(torch, lambda: _gated_grads(torch, model, batch))
    csr = batch["csr"]
    n_layers = model.cfg.n_layers
    want = {"csr_spmm": 4 * n_layers,
            "csr_spmm_combine": 2 * n_layers * (bool(csr.fwd.plan.n_long)
                                                + bool(csr.bwd.plan.n_long))}
    got = {k: counts[k] for k in want}
    print(f"launches GatedGCN step ({n_layers} layers x 2 aggregations, forward and backward): "
          f"csr_spmm {got['csr_spmm']} csr_spmm_combine {got['csr_spmm_combine']} (expected "
          f"{want}; the forward CSR's long rows {csr.fwd.plan.n_long}, the transposed CSR's "
          f"{csr.bwd.plan.n_long}, heaviest row {int(csr.fwd.row_lengths().max())} edges)")
    if got != want:
        _fail(f"one GatedGCN step launched {got}, not {want}")
    if not (bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                               for g in grads.values())):
        _fail("one GatedGCN step gave a loss or gradient that is not finite")
    return got, loss, grads


def _gated_one_step(torch, np, model, batch, card: str) -> dict:
    """One step's loss and gradients, kernel path against twin path; the
    csr_spmm launches and combines of the step, exactly."""
    got, l_k, g_k = _gated_step_launches(torch, model, batch)
    with _Twins():
        l_t, g_t = _gated_grads(torch, model, batch)
    l_err = abs(float(l_k) - float(l_t)) / abs(float(l_t))
    errs = _grad_errs(g_k, g_t)
    print(f"GatedGCN step kernel path vs twin path: loss {float(l_k)} vs {float(l_t)} "
          f"rel_err={l_err} tol={GATED_LOSS_RTOL}; grads max_err/max|g| per leaf: worst "
          f"{max(errs.values())} tol={GATED_GRAD_SCALED} ({len(errs)} leaves)")
    if l_err > GATED_LOSS_RTOL:
        _fail(f"the GatedGCN step's loss differs from the twin path's ({l_err})")
    _grads_close(torch, g_k, g_t, GATED_GRAD_SCALED)
    return {"counts": got, "loss_rel_err": l_err, "grad_err": max(errs.values())}


def _gated_filled(torch, np, cfg, seed: int, card: str) -> dict:
    """GatedGCN at minibatch_lg's batch shape on a graph whose in-degrees
    fill the fanouts: ogb_products' Chung-Lu graph at its published sizes
    (geo-coordinates-en's mean in-degree is 1.08, so the store's batch is
    mostly padding on one dummy row). One step with its launches checked
    exactly, FILLED_STEPS timed Trainer steps, one profiled, and csr_spmm
    at the batch's edge-id CSRs against its twin. The whole step is held
    against the twin path on the store's batch, in (b)."""
    import statistics

    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.data import NeighborSampler
    from repro_torch.data.graphs import csc, node_graph
    from repro_torch.launch import gnn_compressed as gnc
    from repro_torch.models.gnn import GatedGCN, gatedgcn_loss
    from repro_torch.train import Trainer, TrainerConfig

    p, mb = GNN_SHAPES["ogb_products"].params, GNN_SHAPES["minibatch_lg"].params
    n, e = p["n_nodes"], p["n_edges"]
    gen = torch.Generator(device=DEV).manual_seed(seed + 11)
    g = node_graph(n, e, mb["d_feat"], mb["n_classes"], real_nodes=n, real_edges=e,
                   generator=gen)
    indptr, indices = csc(g.pop("senders"), g.pop("receivers"), n)
    sampler = NeighborSampler(indptr, indices, GATED_FANOUTS)
    n_pad, e_pad = gnc.pad_sizes(n, GATED_SEEDS, GATED_FANOUTS)
    data = gnc.make_batches(sampler, g["x"], g["y"], gen, GATED_SEEDS, n_pad, e_pad)
    b = next(data)
    real_e = int((b["senders"] != n_pad - 1).sum())
    dummy_row = int(b["csr"].fwd.row_lengths()[n_pad - 1])
    model = GatedGCN.from_config(cfg, mb["d_feat"], gnc.D_EDGE, mb["n_classes"], device=DEV,
                                 seed=seed)
    print(f"GatedGCN on a filled batch: ogb_products' Chung-Lu graph ({n} nodes, {e} edges, "
          f"mean in-degree {e / n:.4f}), n_pad={n_pad} e_pad={e_pad} sampled edges={real_e} "
          f"({100 * real_e / e_pad:.2f}% of e_pad), the dummy row {dummy_row} edges")
    counts, _, _ = _gated_step_launches(torch, model, b)
    t = Trainer(lambda x: gatedgcn_loss(model, x), model.leaves(), TrainerConfig())
    ms = []
    for _ in range(FILLED_STEPS):
        bb = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.run(iter([bb]), steps=1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    bb = next(data)
    wall, dev_s, avgs = _profile(torch, lambda: t.run(iter([bb]), steps=1))
    csr = b["csr"]
    rows = [_gated_spmm_row(torch, "filled batch forward (edges into nodes)",
                            torch.randn((e_pad, cfg.d_hidden), generator=gen, device=DEV),
                            csr.fwd, card),
            _gated_spmm_row(torch, "filled batch backward (transposed CSR)",
                            torch.randn((n_pad, cfg.d_hidden), generator=gen, device=DEV),
                            csr.bwd, card)]
    out = {"step_ms": statistics.median(ms), "sampled_edges": real_e, "dummy_row": dummy_row,
           "busy": dev_s / wall, "counts": counts, "spmm_rows": rows}
    print(f"GatedGCN filled batch: step_ms median={out['step_ms']:.6f} (of {FILLED_STEPS}) "
          f"profiled step wall_s={wall:.6f} kernel_s={dev_s:.6f} busy_share={out['busy']:.4f}; "
          f"kernels by device time: {_top_kernels(avgs, 8)} on {card}")
    del g, indptr, indices, sampler, data, b, bb, model, t, csr
    return out


def _gated_vs_host(torch, np, make, seed: int) -> None:
    """The reduced config on the example's sizes (a fresh web graph's
    batches), card against host CPU: 3 Trainer steps' losses."""
    import itertools

    from repro_torch.configs import gatedgcn
    from repro_torch.models.gnn import EdgeCSR, GatedGCN, gatedgcn_loss
    from repro_torch.train import Trainer, TrainerConfig

    cfg = gatedgcn.reduced()
    card = GatedGCN.from_config(cfg, 32, 4, 7, device=DEV, seed=seed)
    host = GatedGCN(cfg, {k: t.detach().cpu().clone() for k, t in card.leaves().items()})
    batch = next(make)
    host_batch = {k: v.cpu() for k, v in batch.items() if k != "csr"}
    host_batch["csr"] = EdgeCSR.from_receivers(host_batch["receivers"], batch["x"].shape[0])
    logs = []
    for model, b in ((card, batch), (host, host_batch)):
        t = Trainer(lambda x, m=model: gatedgcn_loss(m, x), model.leaves(),
                    TrainerConfig(log_every=1))
        logs.append([r["loss"] for r in t.run(itertools.repeat(b), steps=3)])
    err = max(abs(a - b) / abs(b) for a, b in zip(*logs))
    print(f"GatedGCN reduced (3 layers, 16 wide) card vs host CPU, 3 Trainer steps on the "
          f"example's batch shape ({batch['x'].shape[0]} nodes, {batch['senders'].numel()} "
          f"edges): losses card {logs[0]} host {logs[1]} max_rel_err={err} "
          f"tol={GATED_HOST_RTOL}")
    if err > GATED_HOST_RTOL:
        _fail("the reduced GatedGCN's losses on the card differ from the host's")


def drive_gnn_compressed(torch, np, seed: int, card: str) -> dict:
    """Phase 8b: the reference example's path, at full width, on phase 3's
    graph. Returns the kernel line's additions."""
    import os
    import shutil
    import statistics
    import tempfile

    import repro_torch.train.checkpoint as ckmod
    from repro_torch.configs import gatedgcn
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.data import GraphStore, NeighborSampler
    from repro_torch.data.synthetic import PAPER_DATASETS, web_graph
    from repro_torch.kernels import ops
    from repro_torch.launch import gnn_compressed as gnc
    from repro_torch.models.gnn import GatedGCN, gatedgcn_loss
    from repro_torch.train import (AsyncCheckpointer, CompressionConfig, Trainer,
                                   TrainerConfig, restore_checkpoint)
    from repro_torch.train.compression import compress_int8, compress_topk, wire_bytes

    t_start = time.perf_counter()
    left = torch.cuda.memory_allocated()
    print(f"phase 8b on {card} starts with memory_allocated={left}")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated when phase 8b starts")
    shape = GNN_SHAPES["minibatch_lg"].params
    d_feat, n_cls = shape["d_feat"], shape["n_classes"]
    ds = PAPER_DATASETS["geo-coordinates-en"](scale=1.0, seed=seed)
    ops.reset_launch_counts()
    # (a) store and sampler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = GraphStore.from_triples(ds.triples, ds.n_nodes, ds.n_preds)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_counts = dict(ops.launch_counts)
    t0 = time.perf_counter()
    indptr, indices = store.csc()
    torch.cuda.synchronize()
    csc_ms = (time.perf_counter() - t0) * 1e3
    n = store.n_nodes
    sampler = NeighborSampler(indptr, indices, GATED_FANOUTS)
    keys = _csc_keys(torch, indptr, indices, n)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    seeds = torch.randperm(n, generator=gen, device=DEV)[:GATED_SEEDS]
    syncs = _count_syncs(torch, lambda: sampler.sample(seeds, gen))
    times, batch = [], None
    for _ in range(SAMPLES_TIMED):
        seeds = torch.randperm(n, generator=gen, device=DEV)[:GATED_SEEDS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = sampler.sample(seeds, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not _sample_ok(torch, batch, keys, n, GATED_FANOUTS):
            _fail("a sampled batch breaks the sampler's invariants")
    edges = [b.senders.numel() for b in batch.blocks]
    print(f"graph store geo-coordinates-en: build_s={build_s:.6f} (digram_pair_accum "
          f"{build_counts['digram_pair_accum']}, digram_select {build_counts['digram_select']}, "
          f"k2_lines_count {build_counts['k2_lines_count']}) csc_ms={csc_ms:.6f}; sampler "
          f"fanouts {GATED_FANOUTS} seeds {GATED_SEEDS}: ms_a_sample median="
          f"{statistics.median(times):.6f} (of {SAMPLES_TIMED}) host_syncs_a_sample={syncs} "
          f"nodes={batch.node_ids.numel()} edges={edges}; invariants hold on {card}")
    if build_counts["digram_pair_accum"] != 1 + store.stats.iterations or \
            build_counts["digram_select"] < store.stats.iterations:
        _fail(f"the store's build launched {build_counts['digram_pair_accum']} digram_pair_accum "
              f"and {build_counts['digram_select']} digram_select over "
              f"{store.stats.iterations} replacements")
    if _sample_ok(torch, _planted_non_edge(torch, batch, keys, n), keys, n, GATED_FANOUTS):
        _fail("the sampler's check passes a batch with a planted non-edge")
    print("control: a planted non-edge fails the sampler's check")
    marks = {"a": time.perf_counter() - t_start}

    # (b) GatedGCN at full width on minibatch_lg's batch shape
    cfg = gatedgcn.config()
    n_pad, e_pad = gnc.pad_sizes(n, GATED_SEEDS, GATED_FANOUTS)
    feats = torch.randn((n, d_feat), generator=gen, device=DEV)
    labels = torch.randint(0, n_cls, (n,), generator=gen, device=DEV)
    data = gnc.make_batches(sampler, feats, labels, gen, GATED_SEEDS, n_pad, e_pad)
    b = next(data)
    print(f"GatedGCN {cfg.n_layers} layers x {cfg.d_hidden} on minibatch_lg's batch: "
          f"d_feat={d_feat} classes={n_cls} n_pad={n_pad} e_pad={e_pad} "
          f"sampled edges={int((b['senders'] != n_pad - 1).sum())}")
    model = GatedGCN.from_config(cfg, d_feat, gnc.D_EDGE, n_cls, device=DEV, seed=seed)
    step = _gated_one_step(torch, np, model, b, card)
    calls = []
    real = ops.csr_spmm

    def rec(x, a):
        calls.append((x.detach(), a))
        return real(x, a)

    ops.csr_spmm = rec
    try:
        loss = gatedgcn_loss(model, b)
        torch.autograd.grad(loss, list(model.leaves().values()))
    finally:
        ops.csr_spmm = real
    spmm_rows = [_gated_spmm_row(torch, "forward (eta into denom, layer 0)", *calls[0], card),
                 _gated_spmm_row(torch, "backward (transposed CSR, last layer)",
                                 *calls[2 * cfg.n_layers], card)]
    del calls, loss, model
    small = web_graph(n_nodes=2000, n_edges=12000, seed=0)
    s_store = GraphStore.from_triples(small.triples, small.n_nodes, small.n_preds)
    s_sampler = NeighborSampler(*s_store.csc(), fanouts=(15, 10))
    s_gen = torch.Generator(device=DEV).manual_seed(seed)
    s_pad = gnc.pad_sizes(s_store.n_nodes, 64, (15, 10))
    _gated_vs_host(torch, np, gnc.make_batches(
        s_sampler, torch.randn((s_store.n_nodes, 32), generator=s_gen, device=DEV),
        torch.randint(0, 7, (s_store.n_nodes,), generator=s_gen, device=DEV), s_gen, 64,
        *s_pad), seed)
    del s_store, s_sampler
    filled = _gated_filled(torch, np, cfg, seed, card)
    marks["b"] = time.perf_counter() - t_start

    # (c) the schedule; every checkpoint kept, so the restored step's stays
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_gnn_")
    ops.reset_launch_counts()
    res = gnc.main(DEV, store=store, d_feat=d_feat, n_classes=n_cls, seeds=GATED_SEEDS,
                   fanouts=GATED_FANOUTS, cfg=cfg, total_steps=GATED_STEPS,
                   checkpoint_every=GATED_CKPT_EVERY, log_every=GATED_CKPT_EVERY,
                   fail_at=GATED_FAIL_AT, lr=3e-3, warmup_steps=20, seed=seed,
                   checkpoint_dir=ckdir, keep_checkpoints=GATED_STEPS // GATED_CKPT_EVERY,
                   out=lambda *_: None)
    path_counts = dict(ops.launch_counts)
    if res["failed_at"] != GATED_FAIL_AT or res["restored_step"] != GATED_RESTORED:
        _fail(f"the schedule failed at {res['failed_at']} and restored step "
              f"{res['restored_step']}, not {GATED_FAIL_AT} and {GATED_RESTORED}")
    n_steps = res["failed_at"] + GATED_STEPS - res["restored_step"]
    print(f"launches of the schedule ({n_steps} steps): " + " ".join(
        f"{k}={path_counts[k]}" for k in ("csr_spmm", "csr_spmm_combine", "k2_lines_count",
                                          "bitvec_rank", "digram_pair_accum")))
    if path_counts["csr_spmm"] != n_steps * step["counts"]["csr_spmm"] or \
            path_counts["csr_spmm_combine"] != n_steps * step["counts"]["csr_spmm_combine"]:
        _fail(f"the schedule's {n_steps} steps launched {path_counts['csr_spmm']} csr_spmm "
              f"and {path_counts['csr_spmm_combine']} csr_spmm_combine, not {n_steps} x "
              f"{step['counts']}")
    logs = res["first_log"] + res["log"]
    savers = [res["first_trainer"].ckpt, res["trainer"].ckpt]
    copy_ms = [v * 1e3 for sv in savers for v in sv.copy_s]
    write_ms = [v * 1e3 for sv in savers for v in sv.write_s]
    # the restored step as the save's host copy wrote it, read with numpy,
    # against a fresh trainer restored from it by this script
    step_dir = f"step_{GATED_RESTORED:08d}"
    saved100 = _saved_leaves(np, torch, os.path.join(ckdir, step_dir))
    d100 = tempfile.mkdtemp(prefix="chip_smoke_gnn100_")
    shutil.copytree(os.path.join(ckdir, step_dir), os.path.join(d100, step_dir))
    m100 = GatedGCN.from_config(cfg, d_feat, gnc.D_EDGE, n_cls, device=DEV, seed=seed + 2)
    t100 = Trainer(lambda x: gatedgcn_loss(m100, x), m100.leaves(),
                   TrainerConfig(checkpoint_dir=d100))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t100.maybe_restore()
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if t100.step != GATED_RESTORED or not _same_state(torch, _state_copy(t100), saved100):
        _fail(f"a trainer restored from step {GATED_RESTORED} differs from the host copy saved "
              "at that step")
    shutil.rmtree(d100, ignore_errors=True)
    losses = [r["loss"] for r in logs]
    flags = res["first_trainer"].straggler.flagged + res["trainer"].straggler.flagged
    step_ms = statistics.median(r["sec_per_step"] * 1e3 for r in logs)
    print(f"GatedGCN schedule ({GATED_STEPS} steps, checkpoint every {GATED_CKPT_EVERY}, "
          f"failure at {GATED_FAIL_AT}): step_ms median={step_ms:.6f} (of the {len(logs)} "
          f"logged steps' sec_per_step) save host copy ms median={statistics.median(copy_ms):.6f} "
          f"(of {len(copy_ms)}) worker write ms median={statistics.median(write_ms):.6f} (of "
          f"{len(write_ms)}) restore_ms={res['restore_s'] * 1e3:.6f} (in the schedule), "
          f"{restore_ms:.6f} (a fresh trainer from step {GATED_RESTORED}); restored state == "
          f"step-{GATED_RESTORED} host copy bit for bit; losses {[round(v, 6) for v in losses]} at steps "
          f"{[r['step'] for r in logs]}; straggler flags {flags} on {card}")
    if not losses[-1] < losses[0]:
        _fail(f"the schedule's loss did not fall: {losses[0]} -> {losses[-1]}")
    final = _state_copy(res["trainer"])
    got, _ = restore_checkpoint(ckdir, device=DEV)
    on_disk = ckmod.flatten(ckmod.host_copy({"params": got["params"],
                                             "opt_state": got["opt_state"]}))
    if not _same_state(torch, on_disk, final):
        _fail("the last checkpoint differs from the final state")
    leaf = os.path.join(ckdir, f"step_{GATED_STEPS:08d}", "leaf_00003.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0x01
    open(leaf, "wb").write(bytes(raw))
    got, _ = restore_checkpoint(ckdir, device=DEV)
    if _same_state(torch, ckmod.flatten(ckmod.host_copy(
            {"params": got["params"], "opt_state": got["opt_state"]})), final):
        _fail("a checkpoint with an altered leaf restores to the final state")
    print("control: a checkpoint with one leaf altered on disk restores to another state")
    shutil.rmtree(ckdir, ignore_errors=True)
    sched = {"step_ms": step_ms, "copy_ms": statistics.median(copy_ms),
             "write_ms": statistics.median(write_ms), "restore_ms": res["restore_s"] * 1e3,
             "restore_ms_fresh": restore_ms, "loss_first": losses[0], "loss_last": losses[-1],
             "flags": len(flags)}
    del res, got, final, on_disk, saved100, m100, t100, savers
    marks["c"] = time.perf_counter() - t_start

    # (d) the codecs, 20 steps each from one state
    codecs = {}
    for codec in ("none", "int8", "topk"):
        m = GatedGCN.from_config(cfg, d_feat, gnc.D_EDGE, n_cls, device=DEV, seed=seed)
        tc = TrainerConfig(total_steps=CODEC_STEPS, log_every=CODEC_STEPS,
                           compression=CompressionConfig(codec, 0.01))
        t = Trainer(lambda x, m=m: gatedgcn_loss(m, x), m.leaves(), tc)
        c_gen = torch.Generator(device=DEV).manual_seed(seed + 7)
        c_data = gnc.make_batches(sampler, feats, labels, c_gen, GATED_SEEDS, n_pad, e_pad)
        ms = []
        for _ in range(CODEC_STEPS):
            bb = next(c_data)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.run(iter([bb]), steps=1)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        leaves = m.leaves()
        loss = gatedgcn_loss(m, next(c_data))
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        res_norm = float(torch.sqrt(sum(r.square().sum() for r in t.residual.values()))) \
            if t.residual is not None else 0.0
        entry = {"ms": statistics.median(ms), "loss": t.metrics_log[-1]["loss"],
                 "residual_norm": res_norm}
        if codec != "none":
            fn = compress_int8 if codec == "int8" else (lambda g, r: compress_topk(g, r, 0.01))
            wire, dec, new = fn(grads, t.residual)
            cw, cdec, cnew = fn({k: g.cpu() for k, g in grads.items()},
                                {k: r.cpu() for k, r in t.residual.items()})
            for k in grads:
                if codec == "int8":
                    same = torch.equal(wire[k][0].cpu(), cw[k][0]) and torch.equal(
                        wire[k][1].cpu(), cw[k][1]) and torch.equal(dec[k].cpu(), cdec[k]) \
                        and torch.equal(new[k].cpu(), cnew[k])
                else:
                    same = torch.equal(wire[k][1].cpu().sort().values, cw[k][1].sort().values) \
                        and torch.equal(dec[k].cpu(), cdec[k])
                if not same:
                    _fail(f"the {codec} codec on the card differs from the CPU's at {k}")
            entry["wire_bytes"] = wire_bytes(wire)
        else:
            entry["wire_bytes"] = sum(g.numel() * 4 for g in grads.values())
        codecs[codec] = entry
        print(f"codec {codec}: {CODEC_STEPS} steps from one state, ms_a_step median="
              f"{entry['ms']:.6f} wire_bytes={entry['wire_bytes']} residual_norm={res_norm} "
              f"loss={entry['loss']}" + ("" if codec == "none" else
                                         "; decoded gradients equal the CPU codec's")
              + f" on {card}")
        del m, t, grads, loss

    marks["d"] = time.perf_counter() - t_start
    # (e) a step with an async save in flight against one with none: a
    # "none" step waits for the last write first, outside its clock
    m = GatedGCN.from_config(cfg, d_feat, gnc.D_EDGE, n_cls, device=DEV, seed=seed)
    t = Trainer(lambda x: gatedgcn_loss(m, x), m.leaves(), TrainerConfig())
    o_dir = tempfile.mkdtemp(prefix="chip_smoke_overlap_")
    saver = AsyncCheckpointer(o_dir)
    saver.save(0, {"params": t.params, "opt_state": t.opt_state})
    saver.wait()  # a write with no step beside it
    by, last = {"none": [], "in_flight": []}, None
    for i in range(1, 2 * OVERLAP_STEPS + 1):
        kind = "in_flight" if i % 2 else "none"
        bb = next(data)
        if kind == "in_flight":
            saver.save(i, {"params": t.params, "opt_state": t.opt_state})
            last = (i, [(k, v.clone()) for k, v in ckmod.flatten(
                {"params": t.params, "opt_state": t.opt_state})])
        else:
            saver.wait()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.run(iter([bb]), steps=1)
        torch.cuda.synchronize()
        by[kind].append((time.perf_counter() - t0) * 1e3)
    saver.wait()
    # the last save, taken just before an in-place step, holds the state it saw
    got, got_step = restore_checkpoint(o_dir, device=DEV)
    if got_step != last[0] or not _same_state(torch, ckmod.flatten(
            {"params": got["params"], "opt_state": got["opt_state"]}), last[1]):
        _fail("an async save followed by an in-place step restores another state")
    shutil.rmtree(o_dir, ignore_errors=True)
    overlap = {k: statistics.median(v) for k, v in by.items()}
    overlap.update(write_alone_ms=saver.write_s[0] * 1e3,
                   write_in_flight_ms=statistics.median(saver.write_s[1:]) * 1e3)
    print(f"overlap: step ms median with an async save in flight {overlap['in_flight']:.6f} "
          f"against {overlap['none']:.6f} with none ({OVERLAP_STEPS} steps each, in turns, a "
          f"none step after the write ended); the write {overlap['write_alone_ms']:.6f} ms "
          f"alone, median {overlap['write_in_flight_ms']:.6f} ms beside a step; the last "
          f"save restores to the state it copied, bit for bit, on {card}")
    del got, last
    del m, t, b, data, feats, labels, store, sampler, keys, indptr, indices, batch
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    seconds = time.perf_counter() - t_start
    print(f"phase 8b ends with memory_allocated={left}; phase_8b_s={seconds:.3f} (cumulative "
          f"s at the end of each part: " + " ".join(f"{k}={v:.1f}" for k, v in marks.items())
          + ")")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated after phase 8b")
    counts = {k: build_counts[k] + path_counts[k] for k in path_counts}
    return {"counts": counts, "build_counts": build_counts, "path_counts": path_counts,
            "step": step, "spmm_rows": spmm_rows, "filled": filled, "schedule": sched,
            "codecs": codecs, "overlap": overlap, "seconds": seconds}


def _merge_gnn_compressed(kernels: list, part: dict) -> None:
    """Phase 8b's launches and csr_spmm's GatedGCN shapes in the kernel rows."""
    for row in kernels:
        name = row["name"]
        if name in ("csr_spmm", "csr_spmm_combine"):
            row["launches_phase8"] = row["launches"]
            row["launches_gnn_compressed_part"] = part["path_counts"][name]
            row["launches"] += part["path_counts"][name]
            row["launches_gatedgcn_step"] = part["step"]["counts"][name]
        if name == "csr_spmm":
            row["gatedgcn"] = {"shape": "GatedGCN 16 x 70 on minibatch_lg's batch: the edge-id "
                               "CSR (forward) and its transpose (backward)",
                               "per_launch": part["spmm_rows"],
                               "filled_batch_per_launch": part["filled"]["spmm_rows"]}
        elif name in part["counts"] and name not in ("csr_spmm_combine",):
            row["launches_gnn_compressed_part"] = part["counts"][name]


# Phase 8c: the rest of the GNN zoo at full width, every registry cell that
# fits one card besides phase 8's (gcn-cora at minibatch_lg and molecule;
# GatedGCN, MeshGraphNet and NequIP at full_graph_sm, minibatch_lg and
# molecule). Tolerances: (a) the reduced cell card against host CPU over 3
# steps as gnn_vs_host holds Cora (losses GNN_LOSS_RTOL, m and v
# GNN_MOMENT_RTOL, parameters within 2 x the learning rates summed, each
# leaf's change GNN_CHANGE_RTOL); (b) one full-width step against the same
# step with every aggregation summed in float64 and rounded once (the
# kernel sums compensated and rounds each row once too): loss rtol 1e-5,
# each gradient leaf 1e-3 x its max|g| (phase 8b's bound for GatedGCN's 16
# layers), outputs 1e-4 x max|out| (the one-class molecule cells' loss and
# gradients are 0 whatever the sums, so their outputs carry the check); a
# control with each row's last edge dropped must fail it. Beside them, a
# reading: the step computed wholly in float64. The steps run with torch's
# deterministic algorithms on, so the gathers' gradients (index_add_) add in
# one order in every path. A twin that gathers its rows back to float32
# before summing (ref.csr_spmm_ref of a float64 x) is no float64 twin:
# against it GatedGCN's full_graph_sm layer-0 gradients sat 1.3e-3 x max|g|
# away on an H100, while the kernel's were within 2.8e-6 of the step
# computed in float64. NequIP at
# molecule: each energy after a rotation plus a translation within
# E3_RTOL x |E_i| + E3_ATOL of its own (the reference's own test holds 1e-4
# at its reduced config, where energies are near 1; at full width with
# random weights they are heavy-tailed, mean |E| 88 but max 2.2e5 on an
# H100, and the rotation moved them by up to 5.3e-4 of their own size and
# 0.45 at most, because float32 positions of nearly coincident atoms lose
# their relative distance), and a shear of E3_SHEAR must move at least one
# past it. On the host CPU, with other data from the same seeds, the
# rotations moved energies by at most 0.21 x this limit, a 1e-3 shear by
# 50-277 x and a 1e-4 shear by 5-28 x.
CELLS_8C = (("gcn-cora", ("minibatch_lg", "molecule")),
            ("gatedgcn", ("full_graph_sm", "minibatch_lg", "molecule")),
            ("meshgraphnet", ("full_graph_sm", "minibatch_lg", "molecule")),
            ("nequip", ("full_graph_sm", "minibatch_lg", "molecule")))
UNFIT_8C = ("gatedgcn", "meshgraphnet", "nequip")  # their ogb_products cells refuse
CELL_SPMM = {"gcn-cora": 4, "gatedgcn": 64, "meshgraphnet": 30, "nequip": 10}  # a step
CELL_LOSS_RTOL = 1e-5
CELL_GRAD_SCALED = 1e-3
CELL_OUT_SCALED = 1e-4
CELL_HOST_STEPS = 3
CELL_TIMED_STEPS = 5
E3_RTOL = 1e-3
E3_ATOL = 1e-3
E3_SHEAR = 1e-3


def _rel(a: float, b: float) -> float:
    """|a - b| / |b|; 0 where both are 0, infinite where only b is."""
    return abs(a - b) / abs(b) if b else (0.0 if a == 0 else float("inf"))


def _cell_copy(torch, cell, dev) -> tuple:
    """(model, opt_state, batch) of a GNN cell that has taken no step, copied
    to ``dev``: the parameters, a fresh AdamW state, the batch's tensors and
    its CSRs built anew there."""
    import copy

    from repro_torch.models.gnn import EdgeCSR, Graph
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    model, _, batch = cell.args
    model = copy.deepcopy(model).to(dev)
    b = {k: v.to(dev) for k, v in batch.items() if torch.is_tensor(v)}
    n = b["y"].shape[0]
    if "graph" in batch:
        b["graph"] = Graph.from_edges(b["senders"], b["receivers"], n)
    else:
        b["csr"] = EdgeCSR.from_receivers(b["receivers"], n)
    return model, init_opt_state(model.leaves(), AdamWConfig()), b


def _cell_vs_host(torch, arch: str, shape: str, seed: int) -> dict:
    """8c (a): the reduced cell built on the host CPU and copied to the card
    before its first step; 3 steps each side; the losses, and the state
    after them as gnn_vs_host holds Cora's."""
    from repro_torch.launch.steps import build_cell, gnn_step
    from repro_torch.train.optimizer import AdamWConfig

    cell = build_cell(arch, shape, reduced=True, device="cpu", seed=seed)
    sides = {"card": _cell_copy(torch, cell, DEV), "host": cell.args}
    p0 = {k: t.detach().clone() for k, t in cell.model.leaves().items()}
    losses = {"card": [], "host": []}
    sum_lr = 0.0
    for _ in range(CELL_HOST_STEPS):
        for side, (model, opt, b) in sides.items():
            loss, met = gnn_step(model, opt, b, AdamWConfig())
            losses[side].append(float(loss))
        sum_lr += float(met["lr"])
    (m_c, o_c, _), (m_h, o_h, _) = sides["card"], sides["host"]
    want = {"p": {k: t.detach() for k, t in m_h.leaves().items()}, "m": o_h["m"], "v": o_h["v"]}
    got = _cora_state_check(torch, {k: t.detach() for k, t in m_c.leaves().items()},
                            o_c["m"], o_c["v"], want, p0, sum_lr)
    got["loss_err"] = max(_rel(a, b) for a, b in zip(losses["card"], losses["host"]))
    got["losses"] = losses
    print(f"8c {arch} {shape} reduced card vs host CPU, {CELL_HOST_STEPS} steps: losses card "
          f"{losses['card']} host {losses['host']} max_rel_err={got['loss_err']} tol="
          f"{GNN_LOSS_RTOL}; params max_abs_err={got['p_err']} limit={2 * sum_lr}, m "
          f"{got['m_err']}, v {got['v_err']} (rtol {GNN_MOMENT_RTOL} + {GNN_MOMENT_RTOL} x max), "
          f"change max_rel_err={got['change_rel']} tol={GNN_CHANGE_RTOL}")
    if got["loss_err"] > GNN_LOSS_RTOL or not got["ok"]:
        _fail(f"{arch} {shape}: the reduced cell on the card differs from the host's")
    return got


def _cell_grads(torch, model, batch) -> tuple:
    """(outputs, loss, gradients by leaf) of one step's forward and backward,
    the state untouched."""
    from repro_torch.models.gnn import gnn_outputs, output_loss

    leaves = model.leaves()
    out = gnn_outputs(model, batch)
    loss = output_loss(model, out, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    return out.detach(), loss.detach(), dict(zip(leaves, grads))


def _f64_spmm(torch, dropped: bool = False):
    """csr_spmm's twin with its rows gathered and summed in float64 and the
    sums rounded once to x's dtype; with ``dropped``, on each row without
    its last edge (the control)."""
    def run(x, a):
        rp, col = _last_edge_dropped(torch, a.row_ptr, a.col) if dropped else (a.row_ptr, a.col)
        rows = torch.repeat_interleave(torch.arange(a.n_rows, device=x.device), rp.diff(),
                                       output_size=col.numel())
        out = torch.zeros((a.n_rows, x.shape[1]), dtype=torch.float64, device=x.device)
        return out.index_add_(0, rows, x[col.long()].double()).to(x.dtype)

    return run


def _f64_step(torch, model, b) -> tuple:
    """The step wholly in float64 (a float64 copy of the model and of the
    batch's floats, the aggregation by :func:`_f64_spmm`), cast back to
    float32: a reading beside the checks."""
    import copy

    from repro_torch.kernels import ops

    m64 = copy.deepcopy(model).double()
    b64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
           for k, v in b.items()}
    real = ops.csr_spmm
    ops.csr_spmm = _f64_spmm(torch)
    try:
        o, l, g = _cell_grads(torch, m64, b64)
    finally:
        ops.csr_spmm = real
    return o.float(), l.float(), {k: v.float() for k, v in g.items()}


def _step_errs(got: tuple, want: tuple) -> dict:
    """A step (outputs, loss, gradients) against another: the loss's
    relative error, the worst leaf's max abs error over its max|g| and the
    outputs' over max|out| (0 where both are 0), and whether all hold."""
    def scaled(a, b):
        e, m = float((a - b).abs().max()), float(b.abs().max())
        return e / m if m else (0.0 if e == 0 else float("inf"))

    (o_k, l_k, g_k), (o_t, l_t, g_t) = got, want
    by_leaf = {k: scaled(g_k[k], w) for k, w in g_t.items()}
    worst = max(by_leaf, key=by_leaf.get)
    out = {"loss": _rel(float(l_k), float(l_t)), "out": scaled(o_k, o_t),
           "grad": by_leaf[worst], "grad_leaf": worst}
    out["ok"] = (out["loss"] <= CELL_LOSS_RTOL and out["grad"] <= CELL_GRAD_SCALED
                 and out["out"] <= CELL_OUT_SCALED)
    return out


def _e3_check(torch, np, model, b, seed: int) -> dict:
    """NequIP's energies on the card after 3 rotations plus translations
    (each within E3_RTOL x |E_i| + E3_ATOL) and after a shear of E3_SHEAR
    (must move one past that)."""
    rng = np.random.default_rng(seed)

    def energies(pos):
        with torch.no_grad():
            return model(b["species"], pos, b["senders"], b["receivers"], b["csr"])

    base = energies(b["pos"])
    limit = E3_RTOL * base.abs() + E3_ATOL

    def over(pos):  # the largest move as a share of its energy's limit, and that move
        d = (energies(pos) - base).abs()
        return float((d / limit).max()), float(d.max())

    worst = worst_abs = 0.0
    for _ in range(3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        qt = torch.tensor(q.T, dtype=torch.float32, device=DEV)
        shift = torch.tensor(rng.normal(size=(3,)), dtype=torch.float32, device=DEV)
        share, d = over(b["pos"] @ qt + shift)
        worst, worst_abs = max(worst, share), max(worst_abs, d)
    shear = torch.eye(3, device=DEV)
    shear[0, 1] = E3_SHEAR
    s_share, s_abs = over(b["pos"] @ shear.T)
    print(f"8c nequip molecule E(3): limit {E3_RTOL} x |E_i| + {E3_ATOL} (max|E| "
          f"{float(base.abs().max())}, mean|E| {float(base.abs().mean())}); 3 rotations + "
          f"translations: largest move {worst} x its limit, max_abs_err={worst_abs}; control "
          f"(shear {E3_SHEAR}): largest move {s_share} x its limit, max_abs_err={s_abs} "
          f"passes={s_share <= 1}")
    if worst > 1:
        _fail(f"nequip molecule: a rotation and a translation move an energy {worst} x its limit")
    if s_share <= 1:
        _fail("nequip molecule: the E(3) check does not tell a shear from a rotation")
    return {"rotation_share": worst, "rotation_err": worst_abs, "shear_share": s_share,
            "shear_err": s_abs}


def _cell_spmm_rows(torch, arch: str, shape: str, model, batch, card: str) -> list:
    """8c (e): the step's csr_spmm launches recorded; the first forward and
    the first backward launch at each width, held against the float64 twin
    and the split twin and timed beside the twin and torch.sparse.mm."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.csr_spmm

    def rec(x, a):
        calls.append((x.detach(), a))
        return real(x, a)

    ops.csr_spmm = rec
    try:
        _cell_grads(torch, model, batch)
    finally:
        ops.csr_spmm = real
    half = len(calls) // 2
    rows, seen = [], set()
    for i, (x, a) in enumerate(calls):
        key = ("forward" if i < half else "backward", x.shape[1])
        if key in seen:
            continue
        seen.add(key)
        what = f"{shape} {key[0]} D={key[1]}"
        row = _gated_spmm_row(torch, what, x, a, card, arch=arch)
        rows.append({"arch": arch, "cell": shape, "direction": key[0], **row})
    return rows


def _gnn_cell_part(torch, np, arch: str, shape: str, seed: int, card: str) -> dict:
    """8c (a)-(e) for one cell; NequIP at molecule adds the E(3) check."""
    import statistics

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_cell

    t0 = time.perf_counter()
    host = _cell_vs_host(torch, arch, shape, seed)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    cell = build_cell(arch, shape, seed=seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    model, _, b = cell.args
    g = b.get("graph") or b["csr"]
    n_edges = int((b["senders"] >= 0).sum())
    # (b) the kernel step against the float64 twin's, and the control
    real = ops.csr_spmm
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        kern = _cell_grads(torch, model, b)
        ops.csr_spmm = _f64_spmm(torch)
        twin = _cell_grads(torch, model, b)
        ops.csr_spmm = _f64_spmm(torch, dropped=True)
        ctrl = _cell_grads(torch, model, b)
        ops.csr_spmm = real
        f64 = _step_errs(kern, _f64_step(torch, model, b))
    finally:
        ops.csr_spmm = real
        torch.use_deterministic_algorithms(False)
    errs, c_errs = _step_errs(kern, twin), _step_errs(ctrl, twin)
    finite = bool(torch.isfinite(kern[1])) and all(bool(torch.isfinite(v).all())
                                                   for v in kern[2].values())
    print(f"8c {arch} {shape} full width ({b['y'].shape[0]} nodes, {b['senders'].numel()} edges, "
          f"{n_edges} real): kernel step vs float64 twin loss {float(kern[1])} vs "
          f"{float(twin[1])} rel_err={errs['loss']} tol={CELL_LOSS_RTOL}; grads worst leaf "
          f"({errs['grad_leaf']}) {errs['grad']} x max|g| tol={CELL_GRAD_SCALED}; outputs "
          f"{errs['out']} x max|out| "
          f"tol={CELL_OUT_SCALED}; control (last edge of each row dropped) loss {c_errs['loss']} "
          f"grads {c_errs['grad']} outputs {c_errs['out']} passes={c_errs['ok']}; reading: vs "
          f"the step wholly in float64 loss {f64['loss']} grads ({f64['grad_leaf']}) "
          f"{f64['grad']} outputs {f64['out']}; build_s={build_s:.6f}")
    if not finite:
        _fail(f"{arch} {shape}: the full-width step's loss or a gradient is not finite")
    if not errs["ok"]:
        _fail(f"{arch} {shape}: the kernel step differs from the float64 twin's: {errs}")
    if c_errs["ok"]:
        _fail(f"{arch} {shape}: the step check does not tell the dropped-edge control apart")
    del twin, ctrl, kern
    # (c) launches of one train step, exactly (also the warm-up)
    n_fwd = CELL_SPMM[arch] // 2
    want = {"csr_spmm": CELL_SPMM[arch],
            "csr_spmm_combine": n_fwd * (bool(g.fwd.plan.n_long) + bool(g.bwd.plan.n_long))}
    counts, (loss, met) = _served_counts(torch, cell.run)
    got = {k: counts[k] for k in want}
    print(f"8c {arch} {shape} launches a step: {got} (expected {want}; the forward CSR's long "
          f"rows {g.fwd.plan.n_long}, the transposed CSR's {g.bwd.plan.n_long}, heaviest row "
          f"{int(g.fwd.row_lengths().max())} edges)")
    if got != want:
        _fail(f"one {arch} {shape} step launched {got}, not {want}")
    # the gradient norm may overflow to inf (the reference's MeshGraphNet at
    # full_graph_sm, whose clip then zeroes the update); the state may not
    state = [cell.args[1][n][k] for n in ("m", "v") for k in cell.args[1][n]]
    if not (bool(torch.isfinite(loss)) and not bool(torch.isnan(met["grad_norm"])) and all(
            bool(torch.isfinite(t).all()) for t in [*model.leaves().values(), *state])):
        _fail(f"{arch} {shape}: a step's loss, gradient norm ({float(met['grad_norm'])}) or "
              "state is not finite")
    # (d) time a step, its busy share and kernels, the peak
    ms = []
    for _ in range(CELL_TIMED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, _ = cell.run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    wall, dev_s, avgs = _profile(torch, cell.run)
    peak = torch.cuda.max_memory_allocated()
    out = {"arch": arch, "cell": shape, "nodes": b["y"].shape[0], "edges": b["senders"].numel(),
           "real_edges": n_edges, "build_s": build_s, "step_ms": statistics.median(ms),
           "steps_ms": ms, "busy": dev_s / wall, "peak_bytes": peak, "counts": got,
           "loss": float(loss), "grad_norm": float(met["grad_norm"]), "vs_float64": errs,
           "control": c_errs, "vs_all_float64": f64, "host": host}
    print(f"8c {arch} {shape}: step_ms median={out['step_ms']:.6f} (of {CELL_TIMED_STEPS} "
          f"after the warm-up: {[round(t, 6) for t in ms]}) busy_share={out['busy']:.6f} "
          f"(profiled step wall_s={wall:.6f} kernel_s={dev_s:.6f}) peak max_memory_allocated="
          f"{peak} loss={float(loss)} first step's grad_norm={out['grad_norm']}; kernels by "
          f"device time: {_top_kernels(avgs, 8)}; {card}")
    # (e) the kernel at the cell's widths; NequIP's E(3) at molecule
    out["spmm_rows"] = _cell_spmm_rows(torch, arch, shape, model, b, card)
    if arch == "nequip" and shape == "molecule":
        out["e3"] = _e3_check(torch, np, model, b, seed)
    out["seconds"] = time.perf_counter() - t0
    del cell, model, b, g
    return out


def drive_gnn_cells(torch, np, seed: int, card: str) -> dict:
    """Phase 8c: the ogb_products refusals, the Reddit-size graph drawn once
    alone to time it (each minibatch_lg cell draws its own), then each cell
    of CELLS_8C, one at a time, freed before the next."""
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.launch.steps import _minibatch_graph, build_cell

    t_start = time.perf_counter()
    left = torch.cuda.memory_allocated()
    print(f"phase 8c on {card} starts with memory_allocated={left}")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated when phase 8c starts")
    refusals = {}
    for arch in UNFIT_8C:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        try:
            build_cell(arch, "ogb_products", seed=seed)
        except ValueError as e:
            refusals[arch] = str(e)
        else:
            _fail(f"{arch} ogb_products built a cell that does not fit one card")
        grew = torch.cuda.max_memory_allocated() - before
        print(f"8c refusal: {refusals[arch]} (device bytes allocated meanwhile: {grew})")
        if grew or "bytes" not in refusals[arch]:
            _fail(f"{arch} ogb_products allocated {grew} bytes before refusing, or named none")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = _minibatch_graph(GNN_SHAPES["minibatch_lg"], False, DEV, seed + 2)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    deg = graph["indptr"].diff()
    g_info = {"nodes": deg.numel(), "edges": graph["indices"].numel(), "build_s": graph_s,
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "kept_bytes": torch.cuda.memory_allocated(), "max_in_degree": int(deg.max())}
    print(f"8c minibatch_lg graph (Reddit's size, Chung-Lu beta 3): nodes={g_info['nodes']} edges="
          f"{g_info['edges']} in-degree mean={float(deg.float().mean()):.4f} max="
          f"{g_info['max_in_degree']} build_s={graph_s:.6f} (drawn, CSC sorted) peak "
          f"max_memory_allocated={g_info['peak_bytes']} kept={g_info['kept_bytes']}; {card}")
    del graph, deg
    cells = []
    for arch, shapes in CELLS_8C:
        for shape in shapes:
            cells.append(_gnn_cell_part(torch, np, arch, shape, seed, card))
            gc.collect()
            torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    seconds = time.perf_counter() - t_start
    counts = {k: sum(c["counts"][k] for c in cells) for k in ("csr_spmm", "csr_spmm_combine")}
    print(f"phase 8c ends with memory_allocated={left}; phase_8c_s={seconds:.3f} (graph "
          f"{graph_s:.1f}; by cell: " + " ".join(f"{c['arch']}/{c['cell']}={c['seconds']:.1f}"
                                              for c in cells) + f"); launches of the 11 "
          f"counted steps {counts}")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated after phase 8c")
    return {"counts": counts, "cells": cells, "graph": g_info, "refusals": refusals,
            "seconds": seconds}


def _merge_gnn_cells(kernels: list, part: dict) -> None:
    """Phase 8c's launches and csr_spmm's rows at the cells' widths."""
    for row in kernels:
        name = row["name"]
        if name in part["counts"]:
            row["launches_gnn_cells_part"] = part["counts"][name]
            row["launches"] += part["counts"][name]
        if name == "csr_spmm":
            row["gnn_cells"] = {
                "shape": "one train step of each 8c cell: the first forward and backward "
                         "launch at each width",
                "per_launch": [r for c in part["cells"] for r in c["spmm_rows"]],
                "steps": [{k: c[k] for k in ("arch", "cell", "step_ms", "busy", "peak_bytes",
                                             "counts")} for c in part["cells"]]}


# Phase 9: the one-card dry-run (repro_torch.launch.dryrun) and the twins it
# rests on: the production meshes' specs of every cell (host arithmetic: no
# device byte may move), the seven refusals, the receiver-partitioned sum on
# the card, and run_cell at full size on the two registry cells that no other
# phase builds on the card. Tolerances: the partitioned sum within
# SPMM_F32_SCALED x max|want| of its plain twin and of a float64 host sum, as
# phase 8 holds csr_spmm; long_500k's attention within ATTN_MAIN_TOL's
# bfloat16 bound of flash_attention_ref, as phase 7 holds decode_32k's.
DRYRUN_REFUSALS = (("olmoe-1b-7b", "train_4k"), ("gemma2-9b", "train_4k"),
                   ("yi-34b", "train_4k"), ("phi3.5-moe-42b-a6.6b", "train_4k"),
                   ("gatedgcn", "ogb_products"), ("meshgraphnet", "ogb_products"),
                   ("nequip", "ogb_products"))
DRYRUN_MESHES = (False, True)  # (16, 16) and (2, 16, 16)
PSS_NODES, PSS_EDGES, PSS_WIDTH = 46_108, 168_960, 70  # GatedGCN's minibatch_lg batch, d_hidden
PSS_SHARDS = 8
PSS_HEAVY = 2000


def _dryrun_specs(torch) -> dict:
    """(a) cell_specs of all 40 cells on both production meshes, with the
    device's allocation unmoved; each mesh's largest per-device arguments."""
    from repro_torch.configs.registry import all_cells
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import cell_specs

    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    largest = {}
    for mp in DRYRUN_MESHES:
        mesh = make_production_mesh(multi_pod=mp)
        for arch, shape in all_cells():
            specs, nbytes = cell_specs(arch, shape, mesh)
            if not specs or nbytes <= 0:
                _fail(f"cell_specs({arch}, {shape}) on {mesh.shape} gave no specs or bytes")
            key = "x".join(map(str, mesh.axis_sizes))
            if nbytes > largest.get(key, (0,))[0]:
                largest[key] = (nbytes, f"{arch} {shape}", len(specs))
    moved = torch.cuda.max_memory_allocated() - before
    print(f"9 (a) cell_specs of {len(all_cells())} cells x {len(DRYRUN_MESHES)} meshes: largest "
          f"per-device argument bytes " + "; ".join(f"mesh {k}: {b} ({c}, {n} leaves)"
                                                    for k, (b, c, n) in largest.items())
          + f"; device bytes allocated meanwhile {moved}")
    if moved or torch.cuda.memory_allocated() != before:
        _fail(f"cell_specs allocated {moved} device bytes")
    return {k: {"bytes": b, "cell": c} for k, (b, c, _) in largest.items()}


def _dryrun_refusals(torch, seed: int) -> dict:
    """(b) run_cell on the seven cells build_cell refuses: records with the
    refusal's bytes, over one card's, and no device byte allocated."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.steps import CARD_BYTES

    out = {}
    for arch, shape in DRYRUN_REFUSALS:
        recs = run_cell(arch, shape, DRYRUN_MESHES, device=DEV, seed=seed)
        r = recs[0]
        mem = r["memory"]
        if r["ok"] or "refused" not in r or not r["refusal_bytes"] > CARD_BYTES \
                or mem["peak_bytes"] or mem["allocated_bytes_left"]:
            _fail(f"dry-run {arch} {shape}: not refused before allocating: {r}")
        out[f"{arch} {shape}"] = {"refusal_bytes": r["refusal_bytes"],
                                  "argument_bytes": [x["memory"]["argument_bytes"]
                                                     for x in recs]}
    print("9 (b) refusals (bytes needed; per-device argument bytes on 16x16, 2x16x16), none "
          "allocating: " + "; ".join(f"{k} {v['refusal_bytes']} {v['argument_bytes']}"
                                    for k, v in out.items()))
    return out


def _dryrun_segment_sum(torch, np, seed: int) -> dict:
    """(c) partitioned_segment_sum on the card over partition_edges' output
    (8 shards of a graph of GatedGCN's batch size) against its plain twin
    and a float64 host sum; exact launches; a control with one receiver
    moved must fail."""
    from repro_torch.distributed import (partition_edges, partitioned_segment_sum,
                                         validate_partitioning)
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import EdgeCSR

    rng = np.random.default_rng(seed + 36)
    n, e, d = PSS_NODES, PSS_EDGES, PSS_WIDTH
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    r[:PSS_HEAVY] = n // 3  # one row of PSS_HEAVY edges, which the plan cuts into chunks
    ps, pr, mask = partition_edges(s, r, n, PSS_SHARDS)
    if not validate_partitioning(pr, n, PSS_SHARDS) or int(mask.sum()) != e:
        _fail("partition_edges lost an edge or broke the receiver blocks")
    x = rng.standard_normal((n, d)).astype(np.float32)
    msgs = np.where(mask[:, None], x[np.maximum(ps, 0)], np.float32(0))
    want64 = np.zeros((n, d))
    np.add.at(want64, r, x[s].astype(np.float64))
    m_t, r_t = torch.from_numpy(msgs).to(DEV), torch.from_numpy(pr).to(DEV)
    plan = EdgeCSR.from_receivers(r_t, n).fwd.plan
    want_counts = {"csr_spmm": 1, "csr_spmm_combine": int(plan.n_long > 0)}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = partitioned_segment_sum(m_t, r_t, n)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts.items() if v}
    twin = partitioned_segment_sum(m_t.cpu(), r_t.cpu(), n)
    atol = SPMM_F32_SCALED * float(twin.abs().max())
    err_twin = float((got.cpu() - twin).abs().max())
    err64 = float(np.abs(got.cpu().double().numpy() - want64).max())
    moved = r_t.clone()
    j = int(np.flatnonzero(mask)[0])
    moved[j] = (int(pr[j]) + 1) % n
    ctrl = partitioned_segment_sum(m_t, moved, n).cpu().double().numpy()
    err_ctrl = float(np.abs(ctrl - want64).max())
    atol64 = SPMM_F32_SCALED * float(np.abs(want64).max())
    print(f"9 (c) partitioned_segment_sum on the card: {n} nodes, {e} edges padded to {len(pr)} "
          f"over {PSS_SHARDS} shards, D={d}, {plan.n_long} rows cut into chunks; launches "
          f"{counts} (want {want_counts}); max_abs_err vs twin {err_twin} (atol {atol}), vs "
          f"float64 {err64} (atol {atol64}); control (receiver of edge {j} moved) {err_ctrl}")
    if counts != {k: v for k, v in want_counts.items() if v}:
        _fail(f"partitioned_segment_sum launched {counts}, not {want_counts}")
    if got.shape != (n, d) or err_twin > atol or err64 > atol64:
        _fail("partitioned_segment_sum differs from its twin or the float64 sum")
    if err_ctrl <= atol64:
        _fail("the moved-receiver control passed")
    return {"counts": counts, "err_twin": err_twin, "err64": err64, "err_control": err_ctrl,
            "n_long": plan.n_long}


def _long_500k_check(torch):
    """run_cell's check of long_500k: the counts of its three steps, then
    (launches made to compare or profile, not counted) the split plan, the
    logits, one layer's attention against flash_attention_ref, with a
    control (the twin over the first half of the keys) that must fail, both
    merges on that layer's partials (:func:`_merge_turns`) and the merge by
    chunk count (:func:`_merge_sweep`), and one profiled step with its
    merges' device time."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (SPLIT_BLOCKS_PER_SM, _sm_count,
                                                     flash_attention_cuda, planned_splits)

    def check(cell, out):
        counts = dict(ops.launch_counts)
        logits = out[0]
        finite = logits.shape == (cell.args[1].shape[0], cell.model.cfg.vocab) and bool(
            torch.isfinite(logits).all())
        args, kw = _capture_attention(cell.run)
        q, k, v = args
        plan = planned_splits(q, k, **kw)
        n_sm = _sm_count(q.device)
        blocks = plan * q.shape[0] * k.shape[1]  # one row tile: 6 rows of a (batch, kv head)
        twin_kw = {a: x for a, x in kw.items() if a != "n_splits"}
        want = ref.flash_attention_ref(q, k, v, **twin_kw).float()
        got = flash_attention_cuda(q, k, v, **kw).float()
        half = k.shape[2] // 2
        ctrl = ref.flash_attention_ref(q, k[:, :, :half], v[:, :, :half],
                                       **{**twin_kw, "q_offset": half - 1}).float()
        rtol, scaled = ATTN_MAIN_TOL["bfloat16"]
        part, n = _kernel_partials(torch, args, kw)
        merge = _merge_turns(torch, part, torch.empty_like(q), k.shape[1], n, "long_500k layer 0")
        merge["sweep"] = _merge_sweep(torch, part, torch.empty_like(q), k.shape[1], n,
                                      "long_500k layer 0")
        del part
        wall, dev_s, avgs = _profile(torch, cell.run)
        merges = [e for e in avgs if "merge_kernel" in e.key]
        merge["step"] = {"launches_traced": sum(e.count for e in merges),
                         "device_ms": sum(getattr(e, "self_device_time_total", 0)
                                          for e in merges) / 1e3}
        res = {"counts": counts, "finite": finite, "n_splits": plan, "blocks": blocks,
               "merge": merge,
               "profiled": {"wall_s": wall, "device_s": dev_s, "busy": dev_s / wall,
                            "top": _top_kernels(avgs)},
               "n_layers": cell.model.cfg.n_layers,
               "n_sm": n_sm, "blocks_per_sm": blocks / n_sm, "keys": k.shape[2],
               "err": _logit_err(got, want), "err_control": _logit_err(ctrl, want),
               "atol": scaled * float(want.abs().max()),
               "same": _close_scaled(torch, got, want, "bfloat16"),
               "control_passes": _close_scaled(torch, ctrl, want, "bfloat16"),
               "aim_blocks_per_sm": SPLIT_BLOCKS_PER_SM, "rtol": rtol}
        del want, got, ctrl, args, q, k, v
        return res

    return check


def _cora_check(torch):
    """run_cell's check of Cora's full_graph_sm: the counts of its three
    steps, the combines its CSRs' plans call for, and one profiled step."""
    from repro_torch.kernels import ops

    def check(cell, out):
        g = cell.args[2]["graph"]
        counts = dict(ops.launch_counts)
        wall, dev_s, avgs = _profile(torch, cell.run)
        return {"counts": counts, "finite": bool(torch.isfinite(out[0])),
                "combines_a_step": 2 * int(g.fwd.plan.n_long > 0) + 2 * int(g.bwd.plan.n_long > 0),
                "profiled": {"wall_s": wall, "device_s": dev_s, "busy": dev_s / wall,
                             "top": _top_kernels(avgs)}}

    return check


def _dryrun_cell(torch, arch: str, shape: str, seed: int, check, card: str) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import run_cell

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    recs = run_cell(arch, shape, DRYRUN_MESHES, device=DEV, seed=seed, check=check)
    r = recs[0]
    if not r["ok"] or not r["finite"]:
        _fail(f"dry-run {arch} {shape} did not run, or its outputs are not finite: "
              f"{ {k: v for k, v in r.items() if k != 'check'} }")
    t = r["roofline"]
    print(f"9 (d) run_cell {arch} {shape} on {card}: build_s={r['build_s']:.6f} step_s="
          f"{r['step_s']} (first, second) peak_bytes={r['memory']['peak_bytes']} "
          f"resident_bytes={r['memory']['resident_bytes']} argument_bytes (16x16, 2x16x16) "
          f"{[x['memory']['argument_bytes'] for x in recs]}; model_flops={r['model_flops_global']} "
          f"roofline compute_s={t['compute_s']} memory_s={t['memory_s']} (floor) dominant="
          f"{t['dominant']} useful_flops_rate={r['useful_flops_rate']}; second step's launches "
          f"{r['launches']}; op_cost counted_flops={r['counted_flops']} bytes="
          f"{r['cost']['bytes']} unseen_launches={r['unseen_launches']}")
    p = r["check"]["profiled"]
    print(f"9 (d) {arch} {shape} one profiled step: wall_s={p['wall_s']:.6f} device_s="
          f"{p['device_s']:.6f} busy={p['busy']:.4f}; by device time: {p['top']}")
    return r


def drive_dryrun(torch, np, seed: int, card: str) -> dict:
    """Phase 9: (a) specs, (b) refusals, (c) the partitioned sum, (d) run_cell
    at full size on gcn-cora full_graph_sm and qwen2-1.5b long_500k. Returns
    the launches of the main path ((c)'s call and (d)'s steps)."""
    t_start = time.perf_counter()
    left = torch.cuda.memory_allocated()
    print(f"phase 9 on {card} starts with memory_allocated={left}")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated when phase 9 starts")
    specs = _dryrun_specs(torch)
    refusals = _dryrun_refusals(torch, seed)
    pss = _dryrun_segment_sum(torch, np, seed)
    cora = _dryrun_cell(torch, "gcn-cora", "full_graph_sm", seed, _cora_check(torch), card)
    c = cora["check"]
    want = {"csr_spmm": 12}
    if c["combines_a_step"]:
        want["csr_spmm_combine"] = 3 * c["combines_a_step"]
    got = {k: v for k, v in c["counts"].items() if v}
    step_want = {k: v // 3 for k, v in want.items()}
    if got != want or cora["launches"] != step_want or cora["unseen_launches"] != step_want:
        _fail(f"gcn-cora full_graph_sm launched {got} in 3 steps (second {cora['launches']}, "
              f"op_cost's {cora['unseen_launches']}), not {want}")
    lm = _dryrun_cell(torch, "qwen2-1.5b", "long_500k", seed, _long_500k_check(torch), card)
    c = lm["check"]
    layers = c["n_layers"]
    merges = layers if c["n_splits"] > 1 else 0
    step_want = {"flash_attention": layers, **({"flash_attention_combine": merges} if merges else {})}
    got = {k: v for k, v in c["counts"].items() if v}
    print(f"9 (d) long_500k: plan_splits picks {c['n_splits']} splits of {c['keys']} keys: "
          f"{c['blocks']} blocks over {c['n_sm']} SMs, {c['blocks_per_sm']:.4f} blocks a SM (the "
          f"planner aims at {c['aim_blocks_per_sm']}); launches of 3 steps {got} (want 3 x "
          f"{step_want}); logits finite {c['finite']}; layer 0 attention vs flash_attention_ref "
          f"at {c['keys']} keys: max_abs_err={c['err']} (rtol {c['rtol']}, atol {c['atol']}) "
          f"within={c['same']}; control (the twin over the first half of the keys) "
          f"max_abs_err={c['err_control']} passes={c['control_passes']}; card {card}")
    if got != {k: 3 * v for k, v in step_want.items()} or lm["launches"] != step_want:
        _fail(f"long_500k launched {got} in 3 steps (second {lm['launches']}), not 3 x "
              f"{step_want}")
    if not c["finite"] or not c["same"] or c["control_passes"]:
        _fail("long_500k: logits not finite, or its attention differs from the twin, or the "
              "half-keys control passed")
    mg = c["merge"]
    print(f"9 (d) long_500k merges in the profiled step: {mg['step']['launches_traced']} traced, "
          f"{mg['step']['device_ms']:.6f} ms of device time (one a layer: "
          f"{mg['step']['device_ms'] / max(mg['step']['launches_traced'], 1):.6f} ms a launch), "
          f"of the step's {c['profiled']['device_s'] * 1e3:.6f} ms (busy "
          f"{c['profiled']['busy']:.4f}); card {card}")
    left = torch.cuda.memory_allocated()
    seconds = time.perf_counter() - t_start
    counts = {k: pss["counts"].get(k, 0) + cora["check"]["counts"].get(k, 0)
              + lm["check"]["counts"].get(k, 0)
              for k in ("csr_spmm", "csr_spmm_combine", "flash_attention",
                        "flash_attention_combine", "flash_attention_combine_rowwise")}
    print(f"phase 9 ends with memory_allocated={left}; phase_9_s={seconds:.3f}; main-path "
          f"launches {counts}")
    if left > 1 << 30:
        _fail(f"{left} bytes are still allocated after phase 9")
    return {"counts": counts, "specs": specs, "refusals": refusals, "segment_sum": pss,
            "cells": [cora, lm], "seconds": seconds, "merge": mg}


def _merge_dryrun(kernels: list, part: dict) -> None:
    """Phase 9's launches in the kernel rows, and the merges at long_500k."""
    mg = part["merge"]
    at = {"flash_attention_combine": {k: v for k, v in mg.items() if k != "rowwise"},
          "flash_attention_combine_rowwise": mg["rowwise"]}
    for row in kernels:
        n = part["counts"].get(row["name"])
        if n is not None:
            row["launches_dryrun_part"] = n
            row["launches"] += n
        if row["name"] in at:
            row["long_500k"] = at[row["name"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--queries", type=int, default=4096)
    args = ap.parse_args(argv)

    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import ops

    card = _card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; card {card}")
    build_s = ops.build_all()
    print(f"kernel_build_s {build_s:.3f}")
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference's MLPs are float32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    errs = check_kernels(torch, np, args.seed)
    errs.update(check_k2_lines(torch, np, args.seed))
    errs.update(check_digram_kernels(torch, np, args.seed))
    errs.update(check_recsys_kernels(torch, np, args.seed))
    errs.update(check_train_kernels(torch, np, args.seed))
    errs["flash_attention"] = check_attention_kernel(torch, np, args.seed)
    errs["csr_spmm"] = check_spmm_kernel(torch, np, args.seed)
    print(f"elapsed_s before phase 3 {time.perf_counter() - t_main:.3f}")
    main_res = drive_main_path(torch, np, args.seed, args.scale, args.queries)
    print(f"elapsed_s after phase 3 {time.perf_counter() - t_main:.3f}")
    drive_scalar_path(torch, np, main_res, args.seed)
    print(f"elapsed_s after drive_scalar_path {time.perf_counter() - t_main:.3f}")
    drive_mutation_path(torch, np, main_res, args.seed)
    print(f"elapsed_s after drive_mutation_path {time.perf_counter() - t_main:.3f}")
    drive_snapshot_path(torch, np, main_res, args.seed)
    print(f"elapsed_s after drive_snapshot_path {time.perf_counter() - t_main:.3f}")
    drive_bgp_path(torch, np, main_res, args.seed)
    print(f"elapsed_s after drive_bgp_path {time.perf_counter() - t_main:.3f}")
    drive_sharded_path(torch, np, main_res, args.seed)
    print(f"elapsed_s after drive_sharded_path {time.perf_counter() - t_main:.3f}")
    drive_durable_path(torch, np, main_res, args.seed)
    print(f"elapsed_s after drive_durable_path {time.perf_counter() - t_main:.3f}")
    drive_baselines_path(torch, np, main_res, args.seed)
    print(f"elapsed_s after drive_baselines_path {time.perf_counter() - t_main:.3f}")
    kernels = time_kernels(torch, np, main_res, errs)
    breakdown(torch, main_res)
    del main_res
    print(f"elapsed_s before phase 6 {time.perf_counter() - t_main:.3f}")
    kernels += drive_dlrm(torch, np, args.seed, errs)
    print(f"elapsed_s before phase 6b {time.perf_counter() - t_main:.3f}")
    kernels += drive_dlrm_train(torch, np, args.seed, errs)
    print(f"elapsed_s before phase 7 {time.perf_counter() - t_main:.3f}")
    kernels += drive_lm(torch, np, args.seed, errs)
    print(f"elapsed_s after phase 7b {time.perf_counter() - t_main:.3f}")
    print(f"elapsed_s before phase 7c {time.perf_counter() - t_main:.3f}")
    kernels += drive_lm_train(torch, np, args.seed, card)
    print(f"elapsed_s after phase 7c {time.perf_counter() - t_main:.3f}")
    kernels += drive_gnn(torch, np, args.seed, errs, card)
    print(f"elapsed_s before phase 8b {time.perf_counter() - t_main:.3f}")
    _merge_gnn_compressed(kernels, drive_gnn_compressed(torch, np, args.seed, card))
    print(f"elapsed_s before phase 8c {time.perf_counter() - t_main:.3f}")
    _merge_gnn_cells(kernels, drive_gnn_cells(torch, np, args.seed, card))
    print(f"elapsed_s before phase 9 {time.perf_counter() - t_main:.3f}")
    _merge_dryrun(kernels, drive_dryrun(torch, np, args.seed, card))
    print(f"elapsed_s after phase 9 {time.perf_counter() - t_main:.3f}")
    if sys.modules.get("jax") is not None or any(
            m == "repro" or m.startswith("repro.") for m in sys.modules):
        _fail("the JAX package or jax was imported")

    print(f"chip_smoke_s {time.perf_counter() - t_main:.3f}")
    print(json.dumps({"kernels": kernels}))
    print(_card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
