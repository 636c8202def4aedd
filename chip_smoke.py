#!/usr/bin/env python3
"""Chip smoke test of siddhi_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card     name and power limit (nvidia-smi), torch/CUDA versions;
2. build    every CUDA kernel of the port, built from ``siddhi_tpu_torch/csrc``
            with one nvcc per source started together; prints ``-Xptxas -v``;
            and the native string dictionary (``native/strdict.cpp``, g++);
3. kernels  each kernel against its plain torch version on the card at the
            shapes the routed flagship gives it (exact equality: the exchange
            is a copy): ``ring_exchange_cols`` in one call over all 13
            buffers of ``exchange_columns``, a call with odd and sub-16-byte
            segments, and a call of 65 columns that must launch twice. Then
            one routed batch's 12 columns timed with CUDA events (L2 flushed
            before each run, and warm as the first port slice timed them)
            beside the plain version, one PyTorch library call per column and
            the byte bound; the host time of one call's enqueue; the
            kernel's own device time from torch.profiler and its share of
            the bound, its launch shape (blocks, chunks a block), and its
            device time on a call moving 16 B a segment (the launch's fixed
            cost);
4. slice    the partitioned flagship (per-symbol ``#window.length(1000)``,
            ``avg(price)``, ``sum(volume)``; 16,384 key slots, 573 MB of
            window state) routed over 4 logical shards with
            ``shard_exchange: pallas_ring``, fed 65,536-row batches of 10,000
            string symbols through ``send_columns``; the routed step runs as
            a CUDA graph (the first batch eager, then captured, the other
            seven replayed). Checks: the exchange kernel launched once per
            routed dispatch (replays included), one capture and seven
            replays, the exchange inside replay 2 (batch 3) held against
            ``ring_exchange_cols_plain`` on its recorded columns, no route
            overflow, routed output
            equal to an unrouted run on the card, the first two batches equal
            to the port's own CPU run (plain versions), one output row per
            input row, finite values. Prints events/s of both card runs;
5. global   the global flagship, bench.py's ``_APP`` (one
            ``#window.length(1000)`` over the whole stream, ``avg(price)``,
            ``sum(volume)`` group by symbol, 16,384 key slots), on the fused
            sliding-aggregation stage, same feed. Checks: the stage is the
            fused one in exact precision, one finite output row per input
            row, the first two batches equal the port's CPU run, all eight
            equal a card run planned without fusion (the generic window ->
            aggregator path). Prints events/s of both card runs;
6. twin     the flagship's twin, ``__graft_entry__._APP`` (``[price > 0.0]
            #window.length(128)``, avg/sum/count/min group by symbol), on the
            generic path, on the same feed with prices lowered by 15 (about
            15% fail the filter). Checks: the generic stage, rows out ==
            rows with price > 0, the first two batches equal the CPU run;
7. strdict  the native string dictionary against its plain Python probe over
            the eight batches' symbol columns (ids equal, the first batch's
            misses included); host ms per 65,536-row encode of each;
8. profile  where the routed step's and the global flagship's time goes:
            device time by torch op and the card's busy share, the sum of
            its kernels and copies (torch.profiler),
            host time by function (cProfile);
9. distinct distinctCount/unionSet and the function library, same feed:
            D1, the global flagship's shape grouped by symbol with
            ``distinctCount(volume)`` and functions (H = 64, 8 batches);
            D2, ``distinctCount(symbol)`` over the whole window (one group,
            H = 1024: one chain of every row); D3, the same over
            ``#window.length(10000)`` at H = 8192 (~6,300 symbols live);
            S, the unionSet chain createSet -> ``#window.length(1000)``
            unionSet group by symbol -> sizeOfSet (3 batches). Checks: one
            distinct-scan launch per batch, no overflow, one row out per
            row in; D1's first two batches equal the port's CPU run; D2's
            and D3's kernel == plain version on a cut of one batch and ==
            the host oracle ``scan_oracle`` on the whole batch, and every
            count equal to a numpy count of distinct symbols over the
            trailing window; S's sizes equal D1's counts row for row, and
            its first batch's unionSet companions equal the CPU run's.
            Prints state bytes and events/s of each, and the kernel at D1's,
            D2's and D3's shapes: CUDA-event ms (L2 flushed), plain ms, host
            enqueue, device ms (torch.profiler), ns per chain row, byte
            bound and share, longest chain; D1's rows through each of the
            kernel's paths at H = 32 to 256 (the crossover); a device
            profile of D1;
10. pipeline bench.py's ``bench_pipeline_curve`` app (the global flagship behind
            ``@Async(buffer.size='64')``, 16,384 key slots) at pipeline depths
            1, 4 and 8, each twice: a timed pass and a pass under
            torch.profiler and sync debug mode. Checks: output equal to phase
            5's synchronous run, the pump holding >= 2 batches in flight at
            depth > 1. Prints events/s from the first send until every row is
            out, per-batch latency (send to arrival), metas per drain, the
            card's busy share and host syncs per dispatch (with their sites);
11. pipeline-routed: the routed flagship (x4, ``pallas_ring``) behind @Async
            at depth 4: one exchange launch per routed dispatch, no route
            overflow, output equal to phase 4's routed run;
12. pipeline-distinct: D1 behind @Async at depth 4: one distinct-scan launch
            per batch, output equal to phase 9's D1;
13. ingest  the feed as wire frames (``WireEncoder`` -> ``decode_frame`` ->
            ``send_columns``) and through an ingest pool of 4: output and
            every dictionary id equal to columns ingest; host ms per batch of
            encode, decode and pack, inline and pooled;
14. onerror ``@OnError(action='stream')`` with a filter whose extension function
            raises for one symbol, present in one batch: that batch's rows
            arrive on ``!StockStream`` with ``_error``, the others flow; a
            full distinct value table still raises ``FatalQueryError``;
15. transport ``@source(type='inMemory')`` -> flagship -> ``@sink(type=
            'inMemory')`` over one batch: the sink's payloads equal a
            StreamCallback's rows;
16. D4      ``distinctCount(account)`` over ``#window.length(30000)``, one group,
            H = 32,768 (the distinct scan's global-index path), ``account``
            uniform over 100,000 ids from its own generator: one_group's
            checks (kernel == plain on a cut, == ``scan_oracle`` on a batch,
            every count == numpy's) and timings;
17. windows the time and batch windows under ``@app:playback`` over
            StockStream with an event-time attribute ``ts`` (20,000 events/s
            of event time, 65,536-row batches, 10,000 symbols): T
            (``#window.time(1 min)`` avg/sum/count group by symbol, ring of
            2,097,152 rows, 24 batches) and ET (``externalTime(ts, 1 min)``),
            each row's n and sum == numpy's and avg to 1e-9; TD
            (``distinctCount(symbol)`` over ``time(1 min)``, H = 16,384):
            every count == numpy's, one distinct-scan launch per step, timer
            steps included, and the kernel at its last batch step == plain
            and the host oracle, timed; TB (``timeBatch(1 sec)``) and LB
            (``lengthBatch(10000)``), 8 batches, == the CPU run; T and ET cut
            to 10 s windows over 8 batches == the CPU run; the default ring
            of 4,096 rows raises ``FatalQueryError`` naming
            ``window_capacity``; L (``time(250 millisec)`` in live mode):
            1,000 expired rows from the timer thread within 2 s; H (sort),
            F (pol2Cart with casts both ways), R (``output last every 1
            sec``) == the CPU run. Prints state bytes, steps per batch
            (batch and TIMER), events/s (timer steps included) and a
            profile of T's timer and batch steps;
18. partitions ``partition with (symbol of StockStream)`` over phase 17's
            feed (PR: three price ranges): PT (per-symbol ``time(1 min)``
            avg/sum/count/``distinctCount(volume)``, H = 256, 24 batches)
            and PET (``externalTime(ts, 1 min)``), every row's n, sum and
            distinct count == numpy's, avg to 1e-9; one distinct-scan
            launch per PT step, TIMER steps included, and the kernel at its
            last batch step == plain and the host oracle, timed; PS
            (``session(1 sec)`` all events: each CURRENT n == numpy's
            session rank, each session after its predecessor expired), PLB
            (``lengthBatch(4)``: n == 4), PR (``length(1000)`` per range:
            rows == numpy's range matches) and PI (``[volume > 100]`` into
            ``#Mid``, then ``length(1000)``), 8 batches, the first 2 == the
            CPU; PT's and PS's queries at 100 ms swept == one TIMER step per
            tick (3 x 1,024 rows, 64 symbols); keyed timeBatch, hopping,
            batch, timeLength, delay and the host sort and session(gap,
            key, latency) == the CPU (2 x 8,192 rows, 64 symbols);
            ``@purge``: half the keys retired, their ids reused by new keys
            starting clean, the kept keys == an unpurged run; a
            ``partition_window_capacity`` of 64 raises ``FatalQueryError``
            naming it. Prints state bytes, steps per batch, events/s and
            profiles of PT's swept TIMER and batch steps;
19. patterns BASELINE.json config #4 (bench.py ``bench_nfa_p99``: ``every
            e1=AStream -> e2=BStream[e2.v > e1.v] within 5 sec`` partitioned
            by ``k``, 10,000 string keys in 16,384 key slots, 8 match slots,
            pipeline depth 2). N: the bench's warm-up and feed (each A batch
            followed by a B batch of the same keys and ``v + 1``, 10 ms a
            pair), p99 per-batch latency at B = 1,024 and events/s at B =
            4,096; every step on the fast kernel (K4), no slot overflow, the
            matches == a per-key Python oracle, the first 2 pairs == the
            CPU run. NX: 24 pairs of 4,096 with B's keys and values drawn
            anew, 2 s a pair (``within`` expires pendings), one A batch 1.5
            s late (the host sends it to ``expire_to`` and the generic
            engine, K5): the matches == the oracle as a multiset, the same
            feed with ``fast_enabled = False`` (K5 every step) == the K4 run
            row for row. At 1 s a pair the feed outgrows 8 slots (the
            oracle holds up to 11 pendings a key): the run raises the slot
            overflow at the send where the oracle first holds a 9th. NS
            (``e1=AStream, e2=BStream[e2.v > e1.v]``) and NA
            (``every e1=AStream -> not BStream[v > e1.v] for 1 sec``, TIMER
            steps through ``apply_timer``) over 8 of NX's pairs == the CPU
            run. Cut shapes (64 keys, 2 x 1,024 rows a stream) == the CPU: a
            count with ``e1[0]``/``e1[last]``, a logical step, a mid-chain
            ``every (...) within``, a group by over captures with ``sum``;
            a pattern behind ``@Async`` at depth 4 == the synchronous run;
            ``@purge`` retiring half the keys, their ids taken by new keys
            with no pending match. Prints events/s, K4/K5 steps, K5 rounds a
            step, TIMER steps, state bytes and the card's busy share of each,
            and one K4 and one K5 step's device ops (torch.profiler), host
            functions (cProfile) and host syncs;
20. joins   J5, BASELINE config #5 at full width under ``@app:playback``:
            ``StockStream#window.time(10 sec) join
            TwitterStream#window.length(100) on symbol == company`` with
            phase 17's Stock feed (10,000 symbols, 65,536-row batches, 20
            events/ms, a 262,144-row ring: 200,000 rows live) and a
            256-row Twitter batch after each Stock batch, 112 pairs, on
            the partitioned engine (K6; auto P = 8 on the card, both sides
            partitioned). Checks: every send's rows == a numpy hash join of
            its batch with the other side's live set, built from the feed
            alone (the Stock rows of the last 10 s of event time, the last
            100 Twitter rows), as a multiset; every 8th pair the port's
            window state == those live sets; the engine == the broadcast
            probe (``join_engine = legacy``) row for row over 4 pairs; a
            64-symbol cut of 2 pairs == the port's CPU run; no overflow,
            peak device memory under 40 GB. Prints events/s, p50/p99/max
            per-send latency of each side over 109 sends, TIMER steps,
            state bytes, peak memory, host syncs a send, and one Stock and
            one Twitter step's device ops and busy share. JB, bench.py
            ``bench_join``'s shape (length(2048) both sides, 512 keys,
            2,048-row batches, probe and insert mixes): the engine at P in
            {1, 8} and depth {1, 2} == the broadcast probe row for row;
            events/s at each point over 256 timed batches (over 1 s each).
            TJ: a 10,000-row ``@primaryKey`` table filled by ``update or
            insert into`` (half the feed's symbols), 4 flagship batches
            through the indexed table join and an ``in SymbolTable`` filter
            == a dict lookup; the fill's time, and at 1,000 rows the batch
            insert against the per-event walk (the same table); events/s.
            A named window
            as a join side, on-demand find/update/delete and a `start` and
            an `every` trigger == the CPU run. No TPU kernel lies on this
            path: nothing here launches a kernel of the port;
21. aggregation and persistence, at full width. AG: Siddhi's documented
            incremental aggregation (``define aggregation StockAgg ...
            avg(price), sum(volume), count(), min(price), max(price) group
            by symbol aggregate by ts every sec ... year``) under
            ``@app:playback``, with the global flagship on the same stream,
            fed 4 of phase 17's 65,536-row batches (10,000 symbols, 20,000
            events/s of event time; 4 batches is a cut of depth: each
            batch is seconds of host fold). Checks: every duration's bucket
            store == a numpy oracle built from the feed alone (ints and
            float sums exact, avg to rtol 1e-12); six on-demand finds
            (``within ... per`` seconds/minutes/hours/days with group by,
            having, order by, limit) == the oracle; a 256-row ``Q`` batch
            joined ``within ... per 'minutes'`` (the probe on the card) ==
            a numpy hash join over the oracle. The incremental chain: a
            full revision after batch 1, an incremental one after batch 3
            (with a ``@primaryKey`` table's insert journal), restored into
            a fresh runtime: the flagship's rows, the stores and the table
            after batch 4 == the straight run. P: the routed partitioned
            flagship x4 (573 MB of state), D1, J5 (12 pairs) and N (16
            pairs, its revision through a ``FileSystemPersistenceStore``)
            each run straight and split: persist after half the feed,
            ``restore_last_revision`` into a fresh runtime, feed the rest.
            Checks: the restored state byte-equal to the revision, every
            row after the restore == the straight run bit for bit, the
            exchange kernel and the distinct scan launching after the
            restore and == their plain versions on a recorded call; the
            routed revision restored into the unrouted runtime == the
            unrouted run. Prints persist and restore ms, snapshot bytes,
            device-to-host and host-to-device bytes of each cell;
22. serving SV, the serving tier behind its REST front door: one app
            (phase 21's StockAgg with ``siddhi_tpu.agg_shards = 4``, the
            global flagship and D1 on the same stream,
            ``@app:statistics('true')``, ``enable_wal()``) deployed by
            ``POST /apps`` on a ``SiddhiRestService`` (127.0.0.1, port 0,
            2 query workers, a queue cap of 4), fed phase 21's 4 batches
            as wire frames with per-row timestamps through ``POST
            /ingest/StockStream`` (4 batches: the same cut of depth as
            phase 21). Checks: every (bucket, symbol) on the shard
            ``crc32(repr((id,))) % 4`` names, the merged stores == phase
            21's unsharded stores == the numpy oracle; the six finds via
            ``POST /query`` == phase 21's; each shard's device view on the
            card, cached until the next fold, == its rows; the flagship
            and D1 fuse into one captured fan-out group: one
            distinct-scan launch a frame (replayed) and one a capture's
            warm-up, the scan in the graph == plain on the last frame's
            call, D1 == a run fed by ``send_columns`` without REST; ``checkpoint_shards`` after batch 2, after batch 4 a
            shard killed and rebuilt from its blob and WAL suffix (2
            records) == before the kill while four clients query (200 or
            503 only); ``POST /persist`` after batch 2, ``/restore`` after
            batch 4 (the graph re-captured once): the WAL replays batches 3-4, D1's rows bit-equal to
            the first pass, the state and stores == before the restore; a
            storm of 10 clients against the cap with shard 0 gated: 503s
            with ``"shed": true``, no 500, ``/metrics`` counting them and
            the rebuild; the statistics' StockStream count == the rows
            sent, and D1's host syncs a step at ``detail`` == without
            statistics; ``/autopilot`` answers 200 with the app not
            registered, ``/autopilot/<app>`` and ``/cluster`` 404, and
            ``/profile/critical_path`` 200, ``/programs`` 200 with the
            group's program-cache entry.
            Prints the sharded and unsharded fold, routing, decode and
            ``/ingest`` ms a batch, ``/query`` p50/p99 under four clients,
            fan-out and merge ms, rebuild, persist and restore-plus-replay
            ms, WAL bytes, D1 events/s through the front door and the
            card's busy share over one frame;
23. fanout FO, fan-out fusion at full width: seven sibling queries on
            StockStream (the global flagship four times, the twin, D1 with
            H = 64, and ``[volume > 500]`` with a product) over the
            phase 4 feed, one fused group with 4 unique programs, captured
            as a CUDA graph (one replay and one meta pull a batch, the
            capture's batch eager). Checks:
            fused and captured == unfused member by member (ints, strings,
            timestamps, types and order exactly, floats to rtol 1e-12, the
            max abs difference printed); q0-q3 equal; one dispatch and one
            meta pull a batch; one compile (the capture) and 7 hits a
            batch under ``jit["fanout.StockStream.step"]``; the gauges
            group_size 7, unique_programs 4, captured 1; D1's distinct scan
            inside the graph == ``distinct_scan_plain`` on a recorded
            replay (state before, inputs, counts and state after); depth 4
            (@Async) == depth 1; a revision of the unfused run after batch
            4 restored into a fused runtime, and the reverse: the rest ==
            the unfused run, the graph re-captured once. FX (two
            ``length(1000)`` siblings with ``insert all events`` and
            ``currentTimeMillis()`` under ``@app:playback``, 3 batches):
            captured == unfused, the EXPIRED rows' timestamps included
            (the clock a tensor the replay reads). FJ: JB's join with
            a plain sibling on L (the L side's proxy fuses, the group runs
            eagerly: captured 0), 12 pairs: rows == unfused == a numpy hash
            join a send. Lists the apps of phases 1-22 that now form groups
            (AG and SV). Prints events/s fused vs unfused at depths 1 and
            4, host launch calls and device ops a batch under
            torch.profiler, host syncs a batch, the busy share, capture ms
            and the graph pool's bytes;
24. program cache PC, at full width over phase 4's feed generator: four
            apps of the global flagship and two of D1, each on its own
            seeded feed of 4 batches (65,536 rows, 10,000 symbols), fed
            batch by batch in turn, with ``siddhi_tpu.program_cache`` on
            (the default) and off; app 2 snapshots after its second batch
            and restores that revision in place. Checks: every app's rows
            bit-equal cache on vs off (max float abs difference 0); every
            replay's valid rows, meta and state after == the eager step on
            a clone of the same state and columns; cache on: 2 entries
            with refcounts 4 and 2, compiles 1 on the first app of each
            program and 0 on the others, 2 captures in all, none at the
            restore; cache off: 6 captures and the restore's re-capture;
            after every app's shutdown the cache holds nothing more and
            ``torch.cuda.memory_allocated`` is within 1 MiB of its value
            before the phase. Prints capture counts and ms, graph pool
            and slot bytes, copy-in/out ms a batch of the flagship's
            shared slot (CUDA events), events/s an app cache on vs off, and
            a flagship batch's and a routed x4 batch's host launch calls
            and busy share as a graph replay vs eager (``profile_batch``);
Single query steps run as CUDA graphs since phase 24 was added: every
capturable step of phases 1-23 (the routed and unrouted flagship, the
global flagship fused and generic, the twin, D1-D4, S, keyed length
windows in partitions, the pipelined and served apps) runs its first batch
of a shape eagerly, is captured, and replays; ``ScanRecorder`` and
``ExchangeRecorder`` count eager calls and replays alike, so each phase's
launch counts and recorded-call checks hold as they did.
25. observability OB, the observability tier at full width on phase 4's
            feed generator (4 batches of 65,536 rows): the global flagship,
            the routed flagship x4, D1, J5 (4 Stock/Twitter pairs) and N (4
            pairs at B = 4,096), each run with device instruments and batch
            journeys off, on, and on with checks. Gates: rows bit-equal; every
            "off" meta the layout before the instruments, its lanes equal the
            "on" meta's structural lanes; host syncs a send equal off and on
            (the capturing first send apart); every lane == its host recomputation from the state pulled after
            the batch (``win_fill`` the ring's live rows, ``groups`` numpy's
            distinct symbols, ``shard_rows`` the rows whose partition key
            mod 4 owns them, ``route_residual`` 4 x quota minus the fullest
            shard, ``fill.<side>`` the pulled join directory, ``nfa_runs``
            the pulled ``[K, S]`` live runs); every replay's meta == the
            eager step's on a clone; a /metrics scrape, the critical-path
            report and ``partition_occupancy`` make 0 host syncs; the report
            names ``device`` for D2 at depth 4, ``pack`` for the global
            flagship under a 50 ms planted pack delay, ``queue`` for the
            @Async flagship under a 50 ms worker delay; ``rt.start_trace``
            over two routed batches and one D1 batch writes a trace (under
            a temporary directory) holding the ring-exchange and
            distinct-scan kernels by name, as many as their wrappers
            launched; ``/profile/device`` writes only under ``trace_base``;
            ``/trace/start|stop`` around a deploy, two sends and a persist
            gives nested ``jit``, ``query.step``, ``junction.dispatch`` and
            ``persist`` spans; a breakpoint IN on the captured global
            flagship suspends its send, ``get_query_state`` == the
            snapshot's state, and after ``play`` the rows equal a run
            without the debugger. Records events/s, host launch calls and
            busy share of the global and routed flagships with instruments
            and journeys off, each alone, and both on;
26. overload OL, overload control and the app supervisor at full width
            (``make_feed``: 65,536-row batches, 10,000 symbols). Gate 1: the
            global and the routed x4 flagship (depth 1) unregistered keep
            ``app_context.overload`` None, and with generous quotas give
            bit-equal rows, equal host syncs a send and equal host launch
            calls a batch (``profile_batch``); K8 inside the routed step's
            replay 2 == plain. Gate 2: the routed x4 flagship (16,384 key
            slots, 574 MB) fed a batch of 20,000 symbols: under
            ``quota_memory_mb`` 800 the growth to 32,768 keys is denied
            naming ``siddhi_tpu.quota_memory_mb``, ``resilience.quota_denials``
            1, the peak after ``reset_peak_memory_stats`` below the
            footprint plus the projected growth, the state, step and graph
            kept, and a fresh app deploys and runs after it; under 4,096 MB
            it grows, charges the grown state's ``pytree_nbytes``,
            recaptures and gives the unbudgeted run's rows (the ledger
            against the ``memory_allocated`` delta recorded). Gate 3: the
            @Async global flagship under queue quota 2, ``shed_oldest`` and
            ``shed_newest``: 65,536 events flooded by
            ``FaultInjector.flood_stream`` (half against a wedged worker),
            events in == rows consumed + ``resilience.shed_events``, the
            rows == the admitted units fed synchronously; a revision after 5
            batches of 8,192, 5 more against the quota and a wedged worker,
            a restore with the WAL replays exactly the 2 not shed, rows
            bit-equal. Gate 4: the @Async flagship at depth 4 under
            ``supervise(0.05, 2.0)``: a worker wedged mid-feed replaced
            once (the released one exits on its generation token, no extra
            replay), a killed one restarted, rows bit-equal to an unfaulted
            run; a 4.0 s ``torch.cuda._sleep`` planted before one batch's
            meta counts ``pump_wedges`` once, rows unchanged; an ingest pool
            of 4 with a packer killed: re-packed, 4 workers alive, rows ==
            no pool. Gate 5: D1 (@Async, H = 64) solo and beside the
            flooded global flagship (quota 2, ``shed_oldest``): rows
            bit-identical, the flood's accounting exact, D1's per-batch
            latency recorded, its replayed scan == plain; the global
            flagship and D1 on two @Async streams at depth 8 under
            ``quota_pipeline_depth`` 2 (the program cache off for the app,
            its own graphs): rows bit-equal to unbounded, at
            most quota + queries - 1 in flight after a submit, D1's
            replayed scan == plain;
27. autopilot AP, the closed-loop controller's actuators on the card (8
            batches of ``make_feed`` a run). Gate 1: the routed flagship
            installed over 2 logical shards (``rows_per_shard`` 40,960),
            ``route_shards`` UP to 4 before batch 3 and DOWN to 2 before
            batch 6: rows bit-equal to the unactuated run, K8 launched once
            a batch and 3 captures (one an install), the replay after the
            4-shard capture held against ``ring_exchange_cols_plain``, and
            ``torch.cuda.memory_allocated`` after the round trip within one
            packed batch (the graph's static inputs) of its value before it.
            Gate 2: ``fuse_fanout`` DOWN before FO's batch 2 and UP before
            batch 5 (deferred to the delivering thread): rows equal, more
            captures than fused throughout, the distinct scan once a batch.
            Gate 3: the @Async global flagship with ``pipeline_depth`` 1 ->
            2 while batches are pending and ``ingest_pool`` 0 -> 2 -> 0:
            rows bit-equal. Gate 4: mode off vs ``dry_run`` (the controller
            thread ticking every 0.05 s) on the global and the routed x4
            flagship: rows bit-equal, host syncs a send and host launch
            calls a batch equal, nothing applied, 3 ticks make 0 host syncs.
            Gate 5: the controller ON every 0.05 s (cooldown 0.2 s) over
            the routed flagship at 2 shards: rows bit-equal to gate 1's
            unactuated run; the decision log printed;
28. cluster CL, the cluster fabric: ``ClusterRuntime(n_workers=2)`` with both
            worker processes on the card, ``clSplit`` (per-symbol
            ``#window.length(50)`` with ``distinctCount(volume)``, split by
            symbol) fed in-process and ``clPinned`` (the global flagship,
            pinned) fed over the ingest socket, 6 batches of 65,536 rows
            whose rows are grouped by owning worker; a checkpoint after
            batch 1, worker 1 killed after batch 3. Checks: each worker
            reports a cuda device and the card's name (before and after
            the respawn), the egress rows of both apps equal one process's
            card run of the same feed before the kill and in whole (ints
            and strings exactly, floats to rtol 1e-12), worker 1 respawned,
            the distinct scan launched in each worker. Records the socket
            ingest's events/s, the egress latency per batch and the
            recovery time;
29. fuzz   FZ, the semantic fuzzer and the runtime sanitizers on the card.
            Gate 1: the seeded corpus (seed 0, cases 0-7, at most 4 combos
            a case) through ``fuzz.run_case(device=cuda)``: every variant
            bit-identical to the baseline on the card, no census findings
            (the port's ``NOT_PORTED`` gaps listed; there are none), routed installs at
            shards 2 and 4, device joins at P=1 and P=8, fusion, depth 4
            and pool 2 all run, K8 launched once a routed dispatch, the
            first replayed routed exchange == plain, and each case's card
            baseline == the port's CPU baseline (floats to rtol 1e-12).
            Gate 2: the planted skew (seed 3, case 0, 24 events) caught and
            shrunk to <= 3 clauses, the fixture equal to the CPU run's.
            Gate 3: cases 1 and 4 on the autopilot axis, bit-identical;
            cases 6 and 11 pinned on a 2-worker fabric on the card, equal
            to one process exactly, both workers reporting ``cuda:0``.
            Gate 4: ``chip_smoke.py --sanitized`` in a child process with
            ``SIDDHI_TPU_SANITIZE=1``: the routed flagship x4 (K8), the
            global flagship and D1 (the distinct scan), each a warm-up
            batch, ``freeze_compiles()`` and 7 more batches; nothing logged
            or raised, ``CheckedRLock`` acquisitions counted, the in-graph
            K8 and scan calls == plain, rows == this process's phase 4, 5
            and 9 runs; a planted ``.item()`` on the card raises (not
            inside ``allowed_pull()``), a planted new shape after the
            freeze raises ``RecompileError`` naming its key;
30. LN     the static lint and the native ingest loader. Gate 1: ``python
            -m siddhi_tpu_torch.analysis`` exits 0 over the port's default
            roots. Gate 2: ``chip_smoke.py --imports`` in a child process
            imports every module of siddhi_tpu_torch; CUDA stays
            uninitialized and ``_build/`` gains no file (R1's runtime
            witness). Gate 3: phase 4's feed (8 batches of 65,536 rows,
            10,000 symbols) as CSV bytes (~14 MB) and as JSONL bytes, each
            parsed batch by batch by ``CsvLoader``/``JsonlLoader``
            (``native/csv_loader.cpp``, g++) and sent into the routed x4
            flagship (K8 inside its graph) and the global flagship: rows
            bit-equal to phases 4 and 5's ``send_columns`` runs, K8 launches
            == routed dispatches, the replayed exchange == plain. Prints
            parse events/s and end-to-end events/s beside ``send_columns``';
31. DS     the multi-process half on the card's world of one
            (``parallel/distributed.py``). Gate 1: ``initialize_cluster``
            joins a process group of one over NCCL on ``127.0.0.1`` and a
            free port; ``process_info`` printed, an ``all_gather`` exact.
            Gate 2: ``shard_query_step`` over ``global_mesh()``: the global
            flagship at full width (8 batches of 65,536 rows, 10,000
            symbols) == phase 5, and the partitioned pattern of
            ``tests/test_multihost.py`` == its unsharded run. Gate 3: the
            routed x4 flagship over ``global_mesh(4)`` (1 process x 4
            shards) == phase 4, K8 launches == routed dispatches, the
            replayed exchange == plain. Gate 4: DS, D1's shape inside a
            partition (``distinctCount(volume)`` and functions, H = 128),
            routed x4 == unrouted, the distinct scan launched inside the
            routed step's graph (4 a dispatch) and the replayed call ==
            plain; the partitioned keyed-length join of
            ``tests/test_join_engine.py`` routed x4 == unrouted (8 batches
            of 8,192 rows a side, 1,000 symbols). Gate 5: under
            ``cluster_step_timeout`` 5 s, ``drop_peer`` makes the routed
            flagship's doomed batch a labeled ``ClusterPeerError`` on
            ``!StockStream`` within the bound; ``PeerRecovery`` rebuilds on
            ``local_survivor_mesh(4)``, restores the revision and replays
            the WAL; the rows == phase 4; ``resilience.peer_failures`` and
            ``peer_recoveries`` and the ``siddhi_shard_rows`` gauges on
            ``/metrics``. Gate 6: that revision, persisted over the global
            mesh, restores into a routed x2 runtime and the rows after it
            == phase 4. Gate 7: two ``--routed-child`` processes on the
            card over gloo (which takes CUDA tensors for
            ``all_to_all_single`` and ``all_gather`` in this torch), the
            routed flagship at 2 processes x 2 shards: each process's rows
            == gate 3's, K8 launched once a dispatch for the local pairs;
32. split   every shape ``shard_query_step`` splits across processes, at
            full width (65,536-row batches, 10,000 keys, a batch 1 s of event
            time; 8 batches a shape, 2 for the keyed windows and the host
            window, 4 pairs for the pattern). Gate 1: ROADMAP C.11, a partitioned
            ``externalTime`` query's rows into a ``length`` window outside
            the partition: its rows == a Python oracle, and the engine logs
            no error. Gate 2: two ``--split-child`` processes on the card
            over gloo split each shape over ``global_mesh()`` (a group by
            other than the partition key, the same with
            ``distinctCount``, order by / limit over a partitioned and a
            global window, time/timeBatch/externalTime/session, a host
            window, an inner stream, a pattern's group by over captures, a
            partitioned join, its orderings, groupings and other sides, a
            join against an incremental aggregation with a fixed and a
            per-event duration, an unpartitioned pattern's group by):
            each process's rows == one process's on the card, and no
            process logs an error; events/s and state bytes a process; the
            distinct scan's launches on the split path and its last call ==
            plain. Gate 3: the legacy host router and its shim route the
            partitioned flagship x4 on the card: each key's rows == the
            unrouted step's;
33. peer    K8 across processes as peer writes through CUDA IPC, two and
            four processes on the card, completion on generation words in
            shared host memory: 7 consecutive calls held bit for bit against
            the plain path at 2 x 2 and 4 x 1, the call's card ms, host
            enqueue and its host profile (cProfile), kernel device ms, share
            and launch shape (and moving 16 B a segment), the routed rows
            against phase 31's, a corrupted arena handle that fails the
            run, and a process killed before its second call: the survivor
            raises ``ClusterPeerError`` within the step's bound, drains and
            closes;
34. api     the management API: ``validate_siddhi_app`` of the flagship
            (nothing registered) and of a broken app (the reference's
            error); the sandbox of the flagship with kafka transports and
            an rdbms store == phase 4's unrouted rows; ``persist_all`` /
            ``restore_last_state`` over the routed and the global flagship
            in one manager == the unbroken run; ``get_queries`` /
            ``is_stateful`` == the reference's management corpus;
35. a ``{"pipeline": ..., "ingest": ...}`` line, a ``{"windows": ...}`` line,
    a ``{"partitions": ...}`` line, a ``{"patterns": ...}`` line, a
    ``{"joins": ...}`` line, a ``{"persistence": ...}`` line, an
    ``{"aggregation": ...}`` line, a ``{"serving": ...}`` line, a
    ``{"fanout": ...}`` line, a ``{"program_cache": ...}`` line, an
    ``{"observability": ...}`` line, an ``{"overload": ...}`` line, an
    ``{"autopilot": ...}`` line, a ``{"cluster": ...}`` line, a
    ``{"fuzz": ...}`` line, a ``{"lint_ingest": ...}`` line, a
    ``{"distributed": ...}`` line, a ``{"split": ...}`` line, a
    ``{"peer": ...}`` line, an ``{"api": ...}`` line, a
    ``{"kernels": [...]}`` line, the nvidia-smi
    line, and last
    ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --sanitized OUT`` is phase 29's child (gate 4);
``python3 chip_smoke.py --imports`` is phase 30's (gate 2), and needs no
card; ``python3 chip_smoke.py --routed-child PORT P RANK OUT`` is one
process of phase 31's gate 7, and ``--split-child PORT P RANK OUT`` one
of phase 32's gate 2.
``python3 chip_smoke.py --cells ROOT`` instead drives the main path's
cells with the checkout at ROOT (``cells``): one process a checkout, to
compare two commits on one card.

Imports nothing of JAX nor of the JAX package ``siddhi_tpu``.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

APP = """
@app:name('chip_smoke')
@app:precision('exact')
define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream)
begin
  @info(name = 'bench')
  from StockStream#window.length({W})
  select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
  insert into OutStream;
end;
"""
# bench.py _APP (a copy): one length window over the whole stream, which
# the planner fuses into the invertible aggregators
GLOBAL_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length({W})
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
group by symbol
insert into OutStream;
"""
# __graft_entry__._APP (a copy): min() keeps it on the generic path
TWIN_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'flagship')
from StockStream[price > 0.0]#window.length(128)
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume, count() as n,
       min(price) as minPrice
group by symbol
insert into OutStream;
"""
# pipeline phases: bench.py's bench_pipeline_curve app, behind @Async
PIPE_APP = "@Async(buffer.size='64')\n" + GLOBAL_APP
# distinct phase (9): D1, the global flagship's shape with distinctCount
# and the function library; D2, distinct symbols over the whole window;
# S, the unionSet chain of tests/test_sets.py over a length window
D1_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length({W})
select symbol, distinctCount(volume) as volumes, avg(price) as avgPrice,
       ifThenElse(price > 50.0, 'high', 'low') as band,
       maximum(cast(volume, 'double'), 500.0) as volFloor,
       eventTimestamp() as ts
group by symbol insert into OutStream;
"""
D2_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length({W}) select distinctCount(symbol) as distinct
insert into OutStream;
"""
# D4: distinct cards among the last 30,000 transactions (the global-index
# path of the distinct scan, H above the shared-memory index)
D4_APP = """
define stream StockStream (symbol string, price float, volume long, account long);
@info(name = 'bench')
from StockStream#window.length({W}) select distinctCount(account) as distinct
insert into OutStream;
"""
S_APP = """
define stream StockStream (symbol string, price float, volume long);
@info(name = 'sets')
from StockStream select symbol, createSet(volume) as vs insert into SetStream;
@info(name = 'bench')
from SetStream#window.length({W})
select symbol, unionSet(vs) as volumes group by symbol insert into VolStream;
@info(name = 'size')
from VolStream select symbol, sizeOfSet(volumes) as n insert into OutStream;
"""
# phase 17: time and batch windows over StockStream with an event-time
# attribute, under @app:playback (the event timestamp is ts)
TW_HEAD = """
@app:playback
define stream StockStream (symbol string, price float, volume long, ts long);
@info(name = 'bench')
"""
T_APP = TW_HEAD + """from StockStream#window.time({T})
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume, count() as n
group by symbol insert into OutStream;"""
ET_APP = TW_HEAD + """from StockStream#window.externalTime(ts, {T})
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume, count() as n
group by symbol insert into OutStream;"""
TD_APP = TW_HEAD + """from StockStream#window.time({T})
select distinctCount(symbol) as distinct insert into OutStream;"""
TB_APP = TW_HEAD + """from StockStream#window.timeBatch(1 sec)
select symbol, sum(volume) as totalVolume, count() as n
group by symbol insert into OutStream;"""
LB_APP = TW_HEAD + """from StockStream#window.lengthBatch(10000)
select symbol, sum(volume) as totalVolume, count() as n
group by symbol insert into OutStream;"""
# L: live mode (no playback): timers fire from the scheduler's thread
L_APP = """
define stream StockStream (symbol string, price float, volume long, ts long);
@info(name = 'bench')
from StockStream#window.time(250 millisec) select symbol, price
insert expired events into OutStream;"""
# H, F, R: a host window, a stream function with casts both ways, and a
# grouped rate limit, each behind a device step
H_APP = TW_HEAD + """from StockStream#window.sort(10, price, 'desc')
select symbol, price, volume insert all events into OutStream;"""
F_APP = TW_HEAD + """from StockStream#pol2Cart(price, volume)
select symbol, x, y, cast(volume, 'string') as vs, convert(symbol, 'long') as sl
insert into OutStream;"""
R_APP = TW_HEAD + """from StockStream select symbol, sum(volume) as v
group by symbol output last every 1 sec insert into OutStream;"""
# phase 18: partitions over phase 17's feed, one window instance per symbol
PART_HEAD = """
@app:playback
define stream StockStream (symbol string, price float, volume long, ts long);
partition with (symbol of StockStream)
begin
"""
PT_APP = PART_HEAD + """@info(name = 'bench')
from StockStream#window.time({T})
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume, count() as n,
       distinctCount(volume) as volumes
insert into OutStream;
end;"""
PET_APP = PART_HEAD + """@info(name = 'bench')
from StockStream#window.externalTime(ts, {T})
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume, count() as n
insert into OutStream;
end;"""
PS_APP = PART_HEAD + """@info(name = 'bench')
from StockStream#window.session({G})
select symbol, count() as n, sum(volume) as totalVolume
insert all events into OutStream;
end;"""
PLB_APP = PART_HEAD + """@info(name = 'bench')
from StockStream#window.lengthBatch(4)
select symbol, sum(volume) as totalVolume, count() as n
insert into OutStream;
end;"""
PR_APP = """
@app:playback
define stream StockStream (symbol string, price float, volume long, ts long);
partition with (price < 10.0 as 'penny' or price >= 10.0 and price < 60.0 as 'mid'
                or price >= 50.0 as 'high' of StockStream)
begin
@info(name = 'bench')
from StockStream#window.length(1000)
select symbol, avg(price) as avgPrice, count() as n
insert into OutStream;
end;"""
PI_APP = PART_HEAD + """from StockStream[volume > 100]
select symbol, price, volume insert into #Mid;
@info(name = 'bench')
from #Mid#window.length(1000)
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
insert into OutStream;
end;"""
PART_CUT_APP = PART_HEAD + """@info(name = 'bench')
from StockStream#window.{W}
select symbol, sum(volume) as totalVolume, count() as n
insert all events into OutStream;
end;"""
PART_CUT_CONFIG = {"window_capacity": 16_384}
PART_CUT_WINDOWS = ("timeBatch(1 sec)", "hopping(2 sec, 1 sec)", "batch()",
                    "timeLength(2 sec, 10)", "delay(1 sec)", "sort(2, price)",
                    "session(1 sec, symbol, 500 millisec)")
TW_RATE = 20                    # events per ms of event time
TW_BASE = 1_700_000_000_000
TW_BATCHES = 24                 # 78.6 s: a 1-minute window expires from batch 19
TW_CAPACITY = 2_097_152         # 1,200,000 live rows + a batch, to a power of two
TW_WINDOW, TW_MS = "1 min", 60_000
TD_H = 16_384                   # all 10,000 symbols live
TB_CAPACITY = 262_144
TB_BATCHES = 8
CUT_BATCHES = 8                 # the card-vs-CPU variant: 10 s windows
CUT_WINDOW = "10 sec"
CUT_CAPACITY = 262_144          # 200,000 live rows + a batch
HFR_BATCH = 8_192
HFR_RATE = 4                    # 2 s of event time a batch: R flushes
PT_H = 256                      # distinct volumes of one symbol's minute
PART_BATCHES = 8                # PS, PLB, PR, PI
PS_GAP, PS_GAP_MS = "1 sec", 1000
SWEEP_BATCH = 1024              # the sweep check: 3 batches, 64 symbols,
SWEEP_RATE = 4                  # 4 events/ms, 100 ms windows
SWEEP_SYMBOLS = 64
PURGE_BATCHES = 3
L_ROWS = 1_000
L_WAIT_S = 2.0
D2_H = 1024                     # ~950 symbols are live at a time
D2_CUT = 2048                   # rows of the kernel-vs-plain check at D2, D3
D3_WINDOW = 10_000              # D3: ~6,300 of the 10,000 symbols live
D3_H = 8192
D4_WINDOW = 30_000              # D4: ~25,900 of 100,000 accounts live
D4_H = 32_768
D4_ACCOUNTS = 100_000
D4_RUNS = 10
CROSSOVER_H = (32, 64, 128, 256)
CROSSOVER_RUNS = 10
S_BATCHES = 3
WINDOW = 1000
NUM_SYMBOLS = 10_000
KEY_SLOTS = 16_384
BATCH = 65_536
N_BATCHES = 8
N_SHARDS = 4
ROWS_PER_SHARD = 20_480         # B / n * 1.25, as the flagship bench routes
CPU_BATCHES = 2
TIMED_RUNS = 30
L2_FLUSH_BYTES = 100 * 2 ** 20  # written before each flushed timing (L2: 50 MB)
EX_CHUNK = 16384                # csrc/ring_exchange.cu CHUNK: bytes a chunk
EX_SMEM = 4 * EX_CHUNK          # its dynamic shared memory a block (STAGES chunks)
H100_BYTES_PER_S = 3.35e12      # HBM3 rate of one H100 SXM (data sheet)
FLOAT_RTOL = 1e-12


class Failure(Exception):
    pass


def _require(cond, msg):
    if not cond:
        raise Failure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    _require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


# ------------------------------------------------------------------ feed

def make_feed(seed: int, n_batches: int, batch: int, n_symbols: int):
    """Seeded batches in the shape of bench.py's generator: uniform symbol
    ids over ``n_symbols`` string symbols, price U(0, 100) float32, volume
    U[1, 1000) int64, per-row timestamps."""
    import numpy as np

    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i}" for i in range(n_symbols)], dtype=object)
    feed = []
    for i in range(n_batches):
        ids = rng.integers(0, n_symbols, batch, dtype=np.int64)
        feed.append(({
            "symbol": syms[ids],
            "price": (rng.random(batch) * 100.0).astype(np.float32),
            "volume": rng.integers(1, 1000, batch, dtype=np.int64),
        }, np.arange(i * batch, (i + 1) * batch, dtype=np.int64)))
    return feed


def run_slice(device, feed, *, routed: bool, window: int = WINDOW,
              key_slots: int = KEY_SLOTS, n_shards: int = N_SHARDS,
              rows_per_shard: int = ROWS_PER_SHARD, on_route=None, send=None,
              mesh=None, exchange: str = "pallas_ring", knobs=None):
    """Drive the flagship through the public API on ``device``. Returns
    (per-batch output column dicts, per-batch seconds, runtime facts).
    ``send(h, feed, device)`` sends the feed (default ``send_timed``);
    ``mesh`` routes over it (default ``make_mesh(n_shards, device)``) with
    ``exchange`` (``siddhi_tpu.shard_exchange``); ``knobs`` adds other
    ``siddhi_tpu.*`` settings."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(
        {"siddhi_tpu.shard_exchange": exchange,
         **{f"siddhi_tpu.{k}": str(v) for k, v in (knobs or {}).items()}}))
    rt = m.create_siddhi_app_runtime(APP.format(W=window))
    _require(rt.app_context.precision == "exact", "precision is not exact")
    cb = collector()
    rt.add_callback("OutStream", cb)
    q = rt.query_runtimes["bench"]
    q.selector_plan.num_keys = key_slots
    q._win_keys = key_slots
    facts = {}
    if routed:
        device_route_query_step(q, mesh if mesh is not None else make_mesh(n_shards, device),
                                rows_per_shard=rows_per_shard)
    else:
        q._state = q._init_state()
    facts["state_bytes"] = sum(
        t.numel() * t.element_size() for t in _leaves(q._state))
    h = rt.get_input_handler("StockStream")
    if on_route is not None:
        on_route()
    seconds = (send or send_timed)(h, feed, device)
    if routed:
        facts["route_overflow"] = q._route_layout.route_overflow_rows
        facts["dispatches"] = q._route_layout.dispatches
    facts["key_slots"] = (q.selector_plan.num_keys * (n_shards if routed else 1))
    facts["captured"] = q.captured
    graph = getattr(q._step, "graph", None)
    facts["captures"] = graph.captures if graph is not None else 0
    facts["replays"] = graph.replays if graph is not None else 0
    m.shutdown()
    return cb.batches, seconds, facts


def collector():
    """A stream callback that keeps each emitted batch as host columns of
    its valid rows: timestamps, types and every output attribute."""
    import threading

    import numpy as np

    from siddhi_tpu_torch import StreamCallback

    class Cols(StreamCallback):
        def __init__(self):
            self.batches = []
            self.arrivals = []      # host clock at each batch's arrival
            self.rows = 0
            self.target = None      # wait_rows: set ``reached`` at this count
            self.reached = threading.Event()

        def receive_batch(self, batch, junction):
            valid = np.asarray(batch.cols["__valid__"])
            keep = [k for k in batch.cols
                    if not k.startswith("__") or k in ("__ts__", "__type__")]
            self.batches.append({k: np.asarray(batch.cols[k])[valid] for k in keep})
            self.rows += int(valid.sum())
            self.arrivals.append(time.perf_counter())
            if self.target is not None and self.rows >= self.target:
                self.reached.set()

    return Cols()


def send_timed(h, feed, device):
    """Send every batch; per batch seconds (a send returns after its
    batch is emitted; the card is synchronised before the clock stops)."""
    import torch

    seconds = []
    for cols, ts in feed:
        t0 = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds


@contextlib.contextmanager
def fusion(enabled: bool):
    """Plan apps with the fused window stage on or off: the planner reads
    ``app_context.enable_fusion`` while the runtime is built, so the flag
    is set as each app context is made."""
    from siddhi_tpu_torch.core.context import SiddhiAppContext

    orig = SiddhiAppContext.__init__

    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        self.enable_fusion = enabled

    SiddhiAppContext.__init__ = init
    try:
        yield
    finally:
        SiddhiAppContext.__init__ = orig


def global_runtime(device, app: str, query: str, fused: bool = True):
    """(manager, runtime, query runtime) of an unpartitioned app at the
    bench's key capacity (bench.py sets 16,384 slots before the feed)."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    with fusion(fused):
        rt = m.create_siddhi_app_runtime(app)
    q = rt.query_runtimes[query]
    q.selector_plan.num_keys = KEY_SLOTS
    return m, rt, q


def run_global(device, app: str, query: str, feed, fused: bool = True, send=None):
    """Drive an unpartitioned app through the public API on ``device``.
    Returns (per-batch output column dicts, per-batch seconds, facts).
    ``send(h, feed, device)`` sends the feed (default ``send_timed``)."""
    m, rt, q = global_runtime(device, app, query, fused)
    cb = collector()
    rt.add_callback("OutStream", cb)
    facts = {"stage": type(q.window_stage).__name__,
             "precision": rt.app_context.precision,
             "exact": getattr(q.window_stage, "exact", None)}
    seconds = (send or send_timed)(rt.get_input_handler("StockStream"), feed, device)
    facts["state_bytes"] = sum(t.numel() * t.element_size()
                               for t in _leaves(q._state))
    facts["strings"] = list(rt.app_context.string_dictionary._to_str)
    m.shutdown()
    return cb.batches, seconds, facts


def require_finite(batches, what: str):
    import numpy as np

    for i, b in enumerate(batches):
        for k, v in b.items():
            if v.dtype.kind == "f":
                _require(np.all(np.isfinite(v)), f"{what}: batch {i} column {k} "
                         f"not finite")


def check_strdict(feed):
    """Native vs plain dictionary ids over the feed's symbol columns, each
    in its own fresh dictionary; host ms of each encode per batch."""
    import numpy as np

    from siddhi_tpu_torch.core.event import StringDictionary

    native, plain = StringDictionary(), StringDictionary()
    native_ms, plain_ms = [], []
    for i, (cols, _ts) in enumerate(feed):
        col = cols["symbol"]
        t0 = time.perf_counter()
        got = native.encode_array(col)
        t1 = time.perf_counter()
        want = plain.probe_array_plain(col)
        plain.resolve_missing(want, lambda j: col[j])
        t2 = time.perf_counter()
        _require(np.array_equal(got, want),
                 f"strdict: native ids differ from plain ids in batch {i}")
        native_ms.append((t1 - t0) * 1e3)
        plain_ms.append((t2 - t1) * 1e3)
    _require(native._to_str == plain._to_str, "strdict: id spaces differ")
    return native_ms, plain_ms


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def compare_outputs(a, b, what: str):
    """Ints, strings, timestamps, types and row order exactly; floats to
    rtol 1e-12 (float sums run in another order on another device)."""
    import numpy as np

    _require(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} emitted batches")
    worst = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        for k in x:
            u, v = x[k], y[k]
            _require(u.shape == v.shape,
                     f"{what}: batch {i} column {k} shape {u.shape} vs {v.shape}")
            if u.dtype.kind == "f":
                _require(np.all(np.isfinite(u)) and np.all(np.isfinite(v)),
                         f"{what}: batch {i} column {k} not finite")
                close = np.isclose(u, v, rtol=FLOAT_RTOL, atol=0.0)
                _require(close.all(), f"{what}: batch {i} column {k} differs "
                         f"beyond rtol {FLOAT_RTOL} at rows "
                         f"{np.nonzero(~close)[0][:5].tolist()}")
                denom = np.maximum(np.abs(v), 1e-300)
                worst = max(worst, float(np.max(np.abs(u - v) / denom, initial=0.0)))
            else:
                _require(np.array_equal(u, v),
                         f"{what}: batch {i} column {k} differs")
    return worst


# --------------------------------------------------------------- kernels

def exchange_columns(device):
    """One send buffer per column of the routed flagship step, at its
    shapes: [n, n*Q] with Q = rows_per_shard // n, random bytes."""
    import torch

    n, Q = N_SHARDS, ROWS_PER_SHARD // N_SHARDS
    g = torch.Generator(device="cpu").manual_seed(7)
    dtypes = {
        "symbol": torch.int32, "price": torch.float32, "volume": torch.int64,
        "__ts__": torch.int64, "__type__": torch.int8, "__valid__": torch.bool,
        "symbol?": torch.bool, "price?": torch.bool, "volume?": torch.bool,
        "__gk__": torch.int32, "__pk__": torch.int32, "__ridx__": torch.int64,
    }
    bufs = {}
    for name, dt in dtypes.items():
        if dt.is_floating_point:
            t = torch.rand((n, n * Q), generator=g, dtype=dt) * 100
        else:
            raw = torch.randint(0, 256, (n, n * Q * torch.empty(0, dtype=dt).element_size()),
                                generator=g, dtype=torch.uint8)
            t = raw % 2 == 1 if dt == torch.bool else raw.view(dt)
        bufs[name] = t.to(device).contiguous()
    # a float64 buffer too: other apps route double columns
    bufs["double"] = torch.rand((n, n * Q), generator=g, dtype=torch.float64).to(device)
    return bufs


def steady_eps(seconds, batch: int) -> float:
    """Events/s over every batch after the first (the first pays the
    card's lazy kernel loading and allocator warm-up)."""
    return batch * (len(seconds) - 1) / sum(seconds[1:])


def profile_sends(label: str, h, feed, card: str):
    """Where a path's time goes: after one warm batch, torch.profiler over
    two batches (device time by torch op, device busy share of the wall
    time) and cProfile over two more (host time by function)."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    h.send_columns(feed[0][0], timestamps=feed[0][1])      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cols, ts in feed[1:3]:
            h.send_columns(cols, timestamps=ts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the profiler lists each kernel (and copy) twice: as a device event,
    # and inside the self device time of the torch op that launched it.
    # Busy time sums the device events only; the per-op table reads the ops
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in on_card)
    op_us = sum(e.self_device_time_total for e in ops)
    _require(dev_us > 0, f"profile {label}: the profiler saw no device time")
    print(f"[profile] {label}, 2 batches: wall {wall * 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}% of wall; "
          f"{len(on_card)} kernel and copy names; the same time attributed to "
          f"torch ops: {op_us / 1e3:.1f} ms) [{card}]")
    top = sorted(ops, key=lambda e: -e.self_device_time_total)
    for e in top[:15]:
        print(f"[profile]   {label} device {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d}x  {e.key[:90]}")
    pr = cProfile.Profile()
    pr.enable()
    t0 = time.perf_counter()
    for cols, ts in feed[3:5]:
        h.send_columns(cols, timestamps=ts)
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    pr.disable()
    print(f"[host] {label}, 2 batches under cProfile: {host * 1e3:.1f} ms")
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(20)
    for line in buf.getvalue().splitlines():
        if line.strip():
            print(f"[host] {label} {line}")


def profile_routed(device, feed, card: str):
    """profile_sends over the routed partitioned flagship."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(
        {"siddhi_tpu.shard_exchange": "pallas_ring"}))
    rt = m.create_siddhi_app_runtime(APP.format(W=WINDOW))
    q = rt.query_runtimes["bench"]
    q.selector_plan.num_keys = KEY_SLOTS
    q._win_keys = KEY_SLOTS
    device_route_query_step(q, make_mesh(N_SHARDS, device),
                            rows_per_shard=ROWS_PER_SHARD)
    profile_sends("routed", rt.get_input_handler("StockStream"), feed, card)
    m.shutdown()


def profile_global(device, feed, card: str):
    """profile_sends over the global flagship on the fused stage."""
    m, rt, _q = global_runtime(device, GLOBAL_APP.format(W=WINDOW), "bench")
    profile_sends("global", rt.get_input_handler("StockStream"), feed, card)
    m.shutdown()


def odd_columns(device):
    """Send buffers whose segments are odd byte counts, under 16 bytes, or
    over one chunk with unaligned ends: the kernel's byte path and the
    heads and tails around its bulk copies."""
    import torch

    n = N_SHARDS
    g = torch.Generator(device="cpu").manual_seed(11)
    bufs = [torch.randint(-128, 127, (n, n * 7), generator=g, dtype=torch.int8),
            torch.randint(0, 2, (n, n * 3), generator=g).bool(),
            torch.randint(-99, 99, (n, n * 5, 3), generator=g, dtype=torch.int16),
            torch.randint(-99, 99, (n, n * 7), generator=g, dtype=torch.int64),
            torch.randint(-128, 127, (n, n * 20_483), generator=g, dtype=torch.int8),
            torch.rand((n, n * 5_001), generator=g)]
    return [b.to(device) for b in bufs]


def time_ms(fn, runs: int = TIMED_RUNS, flush=None):
    """Median of ``runs`` CUDA-event timings of ``fn`` (after a warm-up).
    With ``flush`` (a large scratch tensor), it is written before each
    start event so that ``fn`` finds its inputs outside the L2 cache."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(runs):
        if flush is not None:
            flush.fill_(i & 0xFF)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, runs: int = TIMED_RUNS):
    """Mean host time of one call of ``fn``: what it takes to enqueue its
    work (host clock over ``runs`` calls, the card left to run behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / runs


def device_ms(fn, kernel: str, flush, runs: int = TIMED_RUNS, main=None,
              refill=None):
    """Mean device time of the CUDA kernels whose names hold ``kernel``
    over ``runs`` calls of ``fn``, each after an L2 flush (torch.profiler),
    and how many launches of the call's main kernel (names holding any of
    ``main``; default ``kernel``) the profiler recorded, and how many
    traces it took. The profiler can miss a few launches of a kernel
    started through ctypes (on an H100 it saw 27 of 30 distinct-scan
    launches in one run, and none of 10 in one), so the mean is over the
    launches it saw, and a trace that saw none is taken again, up to three
    times: a count of traces above 1 is printed beside the launches seen.
    A ``fn`` that consumes one prepared input a call (a pool of pre-call
    states) passes ``refill``, called before each trace after the first to
    prepare ``runs`` more."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    main = (kernel,) if main is None else main
    fn()
    torch.cuda.synchronize()
    for traces in range(1, 4):
        if traces > 1 and refill is not None:
            refill()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(runs):
                flush.fill_(i & 0xFF)
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in events)
        count = sum(e.count for e in events if any(m in e.key for m in main))
        if count > 0:
            break
    _require(0 < count <= runs and us > 0,
             f"profiler saw {count} launches of {main} with {us} us of device "
             f"time for {runs} calls")
    return us / 1e3 / count, count, traces


def launch_shape(segs, pairs: int) -> dict:
    """An exchange launch's chunks and blocks, as csrc/ring_exchange.cu's
    ``launch`` sizes them: ``pairs`` x ceil(seg / CHUNK) chunks a column,
    on min(chunks, resident) blocks, resident being as many blocks of
    ``EX_SMEM`` bytes (and the 1 KB the card reserves a block) as fit an
    SM's shared memory, on every SM."""
    import torch

    prop = torch.cuda.get_device_properties(0)
    smem = getattr(prop, "shared_memory_per_multiprocessor", 0) or 228 * 1024
    resident = max(smem // (EX_SMEM + 1024), 1) * prop.multi_processor_count
    chunks = pairs * sum(-(-seg // EX_CHUNK) for seg in segs)
    blocks = max(min(chunks, resident), 1)
    return {"blocks": blocks, "chunks": chunks, "chunks_per_block": chunks / blocks}


def ring_floor_ms(device, flush) -> float:
    """The one-card kernel's device ms on a call that moves almost
    nothing (one column, 16 bytes a segment): its fixed cost."""
    import torch

    from siddhi_tpu_torch.ops.exchange import ring_exchange_cols

    n = N_SHARDS
    tiny = torch.zeros((n, n, 16), dtype=torch.uint8, device=device)
    return device_ms(lambda: ring_exchange_cols([tiny], n), "ring_exchange_cols_kernel",
                     flush)[0]


def check_exchange(device):
    """Kernel vs plain: every column buffer in one call, the odd-byte call
    and the 65-column call; timings over the column set of one routed batch
    (the main path's per-dispatch exchange)."""
    import torch

    from siddhi_tpu_torch.ops.exchange import (
        ring_exchange, ring_exchange_cols, ring_exchange_cols_plain,
        ring_exchange_plain)

    n = N_SHARDS
    bufs = exchange_columns(device)
    every = list(bufs.values())
    max_err = 0.0
    got = ring_exchange_cols(every, n)
    torch.cuda.synchronize()
    for name, g, w in zip(bufs, got, ring_exchange_cols_plain(every, n)):
        _require(torch.equal(g, w), f"ring_exchange_cols differs from plain on {name}")
        if g.dtype.is_floating_point:
            max_err = max(max_err, float((g - w).abs().max()))
    odd = odd_columns(device)
    got = ring_exchange_cols(odd, n)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, ring_exchange_cols_plain(odd, n))):
        _require(torch.equal(g, w), f"ring_exchange_cols differs from plain on "
                 f"odd-byte buffer {i} {tuple(w.shape)} {w.dtype}")
    many = every * 5                        # 65 columns: two launches
    before = ring_exchange.launches
    got = ring_exchange_cols(many, n)
    torch.cuda.synchronize()
    _require(ring_exchange.launches - before == 2,
             f"{len(many)} columns took {ring_exchange.launches - before} "
             f"launches, not 2")
    for i, (g, w) in enumerate(zip(got, ring_exchange_cols_plain(many, n))):
        _require(torch.equal(g, w), f"65-column call differs from plain at {i}")

    batch_cols = [b for k, b in bufs.items() if k != "double"]
    nbytes = sum(b.numel() * b.element_size() for b in batch_cols)
    Q = batch_cols[0].shape[1] // n
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)

    def kernel():
        return ring_exchange_cols(batch_cols, n)

    def plain():
        return [ring_exchange_plain(b, n) for b in batch_cols]

    def library():
        # one PyTorch call of the same function per column (timed only; the
        # port never calls it)
        return [b.view(n, n, Q).transpose(0, 1).contiguous() for b in batch_cols]

    out = {}
    for name, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        out[name] = time_ms(fn, flush=scratch)
    for name, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        out[name + "_warm_l2"] = time_ms(fn)
    out["host_ms"] = host_ms(kernel)
    out["device_ms"], out["device_seen"], out["device_traces"] = device_ms(
        kernel, "ring_exchange_cols_kernel", scratch)
    out["launch"] = launch_shape([b.numel() // (n * n) * b.element_size()
                                  for b in batch_cols], n * n)
    out["floor_ms"] = ring_floor_ms(device, scratch)
    out["bound_ms"] = 2 * nbytes / H100_BYTES_PER_S * 1e3   # read once + write once
    out["roofline_share"] = out["bound_ms"] / out["device_ms"]
    out.update(max_abs_err=max_err, bytes_each_way=nbytes,
               columns=len(batch_cols), buffers=len(every))
    return out


def exchange_line(ex: dict, card: str) -> str:
    return (f"[kernel] ring_exchange_cols exact on {ex['buffers']} buffers in one "
            f"call, on odd-byte segments, and on 65 columns in 2 launches; one "
            f"batch's {ex['columns']} columns, {ex['bytes_each_way']} bytes each "
            f"way, L2 flushed: kernel {ex['ms']:.4f} ms, plain {ex['plain_ms']:.4f} "
            f"ms, library {ex['library_ms']:.4f} ms; warm L2: kernel "
            f"{ex['ms_warm_l2']:.4f} ms, plain {ex['plain_ms_warm_l2']:.4f} ms, "
            f"library {ex['library_ms_warm_l2']:.4f} ms; host enqueue of one "
            f"call {ex['host_ms']:.4f} ms; kernel on the device "
            f"{ex['device_ms']:.4f} ms ({ex['device_seen']} of {TIMED_RUNS} launches "
            f"seen, {ex['device_traces']} traces; {ex['launch']['blocks']} blocks, "
            f"{ex['launch']['chunks_per_block']:.2f} chunks a block of {EX_CHUNK} B) "
            f"against a {ex['bound_ms']:.4f} ms byte bound (share "
            f"{ex['roofline_share']:.3f}); the same launch moving 16 B a segment "
            f"{ex['floor_ms']:.4f} ms [{card}]")


# -------------------------------------------------------------- distinct

class ScanRecorder:
    """Stands in for ``distinct_scan`` where the aggregators call it, and
    watches every ``StepGraph.run``, to keep the scan of batch ``at`` for
    the kernel's checks and timings at the main path's shapes. Batches are
    counted as the card runs them: an eager call (the first batch of a
    captured step's shape is one, and so is every batch of an eager step)
    or a replay of a graph whose capture recorded a scan. An eager call's
    arguments are cloned before it updates the tables in place, its
    results and tables after. Under capture the recorder adds clones of
    the tables before the scan to the graph and keeps the call's tensors
    (graph-pool memory that every replay rewrites, and that the capture
    cannot reuse while they are referenced); after replay ``at`` those
    are cloned: the tables before, the inputs, the results and the tables
    after."""

    def __init__(self, at: int):
        import threading

        self.at, self.n, self.replays = at, 0, 0
        self.args = self.kwargs = self.got = None
        # the StepGraph whose run is on this thread's stack: per thread,
        # since @Async workers of several streams run graphs at once
        self._tls = threading.local()
        self.in_graph = {}          # id(graph) -> (tables before, args, kwargs, out)

    @property
    def current(self):
        return getattr(self._tls, "graph", None)

    @current.setter
    def current(self, graph):
        self._tls.graph = graph

    def __call__(self, *args, **kwargs):
        import torch

        from siddhi_tpu_torch.ops.distinct import distinct_scan

        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            before = [t.clone() for t in args[:3]]
            out = distinct_scan(*args, **kwargs)
            self.in_graph[id(self.current)] = (before, args, kwargs, out)
            return out
        i, self.n = self.n, self.n + 1
        if i != self.at:
            return distinct_scan(*args, **kwargs)
        self.args = [a.clone() if a is not None else None for a in args]
        self.kwargs = dict(kwargs)
        out = distinct_scan(*args, **kwargs)
        self.got = ([x if x is None else x.clone() for x in out],
                    [t.clone() for t in args[:3]])
        return out

    def wrap_run(self, run):
        def recorded_run(graph, *a, **k):
            prev, self.current = self.current, graph
            try:
                res = run(graph, *a, **k)
            finally:
                self.current = prev
            call = self.in_graph.get(id(graph))
            if res[2] is None and call is not None:     # a replay ran the scan
                i, self.n = self.n, self.n + 1
                self.replays += 1
                if i == self.at:
                    before, args, kwargs, out = call
                    self.args = ([t.clone() for t in before]
                                 + [x if x is None else x.clone() for x in args[3:]])
                    self.kwargs = dict(kwargs)
                    self.got = ([x if x is None else x.clone() for x in out],
                                [t.clone() for t in args[:3]])
            return res
        return recorded_run


@contextlib.contextmanager
def recording(at: int):
    """``ScanRecorder`` installed for the life of the block."""
    from siddhi_tpu_torch.core.query.step_graph import StepGraph
    from siddhi_tpu_torch.ops import aggregators

    rec = ScanRecorder(at)
    orig_scan, orig_run = aggregators.distinct_scan, StepGraph.run
    aggregators.distinct_scan = rec
    StepGraph.run = rec.wrap_run(orig_run)
    try:
        yield rec
    finally:
        aggregators.distinct_scan = orig_scan
        StepGraph.run = orig_run


def check_graph_scan(rec, what: str) -> float:
    """The recorded in-graph call against the plain version on the same
    inputs and state: counts, snapshots, overflow and the updated state
    exactly equal; and the eager kernel on them too (as ``check_scan``
    does, against the same one plain run). Returns the largest count
    difference."""
    import torch

    from siddhi_tpu_torch.ops.distinct import distinct_scan, distinct_scan_plain

    _require(rec.got is not None, f"{what}: batch {rec.at} was not recorded")
    st_p = [t.clone() for t in rec.args[:3]]
    want = distinct_scan_plain(*st_p, *rec.args[3:], **rec.kwargs)
    st_k = [t.clone() for t in rec.args[:3]]
    eager = distinct_scan(*st_k, *rec.args[3:], **rec.kwargs)
    if st_k[0].is_cuda:
        torch.cuda.synchronize()
    outs, state = rec.got
    err = 0.0
    for who, got, got_state in (("the graph's", outs, state), ("the eager kernel's",
                                                                eager, st_k)):
        for name, a, b in zip(("counts", "snapshot keys", "snapshot mask", "overflow"),
                              got, want):
            _require((a is None) == (b is None), f"{what}: {who} call and plain "
                     f"disagree on whether there are {name}")
            if a is not None:
                _require(torch.equal(a, b), f"{what}: {who} {name} differ from plain")
        for name, a, b in zip(("vk", "vc", "stamp"), got_state, st_p):
            _require(torch.equal(a, b), f"{what}: {who} state {name} differs from plain")
        if got[0].numel():
            err = max(err, float((got[0] - want[0]).abs().max()))
    return err


def run_app(device, app: str, feed, streams=("OutStream",), key_slots=KEY_SLOTS,
            capacity=None, on_start=None):
    """Drive an app's ``bench`` query (and any others) through the public
    API; ``capacity`` sets the distinct value slots before the first send.
    Returns ({stream: per-batch output columns}, per-batch seconds, facts)."""
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    rt = m.create_siddhi_app_runtime(app)
    q = rt.query_runtimes["bench"]
    if key_slots is not None:
        q.selector_plan.num_keys = key_slots
    if capacity is not None:
        for spec in q.selector_plan.specs:
            spec.distinct_capacity = capacity
    cbs = {name: collector() for name in streams}
    for name, cb in cbs.items():
        rt.add_callback(name, cb)
    if on_start is not None:
        on_start()
    seconds = send_timed(rt.get_input_handler("StockStream"), feed, device)
    facts = {"stage": type(q.window_stage).__name__,
             "state_bytes": sum(t.numel() * t.element_size()
                                for r in rt.query_runtimes.values()
                                if r._state is not None for t in _leaves(r._state))}
    m.shutdown()
    return {n: cb.batches for n, cb in cbs.items()}, seconds, facts


def scan_facts(args, kwargs):
    """Byte bound and longest chain of one distinct-scan call: each touched
    group's table read and written once, every row input read once, the
    counts (and unionSet snapshots) written once."""
    import torch

    vk = args[0]
    g = args[3]
    K, H = vk.shape
    R = g.numel()
    counts = torch.bincount(g, minlength=K)
    touched = int((counts > 0).sum())
    table = touched * (H * (8 + 4) + 8)
    rows_in = sum(t.numel() * t.element_size() for t in args[3:] if t is not None)
    out = R * 8 + (R * H * 9 if kwargs.get("emit_set") else 0)
    nbytes = 2 * table + rows_in + out
    return {"rows": R, "groups": touched, "H": H, "chain": int(counts.max()),
            "bytes": nbytes, "bound_ms": nbytes / H100_BYTES_PER_S * 1e3}


def check_scan(args, kwargs, what: str, cut=None):
    """Kernel against the plain version on the same inputs (on the first
    ``cut`` rows when given): counts, snapshots, overflow and the updated
    state exactly equal."""
    import torch

    from siddhi_tpu_torch.ops.distinct import distinct_scan, distinct_scan_plain

    rows = [a if a is None or cut is None else a[:cut] for a in args[3:]]
    st_k = [t.clone() for t in args[:3]]
    st_p = [t.clone() for t in args[:3]]
    got = distinct_scan(*st_k, *rows, **kwargs)
    torch.cuda.synchronize()
    want = distinct_scan_plain(*st_p, *rows, **kwargs)
    for name, a, b in zip(("counts", "snapshot keys", "snapshot mask", "overflow"),
                          got, want):
        _require((a is None) == (b is None), f"{what}: kernel and plain disagree "
                 f"on whether there are {name}")
        if a is not None:
            _require(torch.equal(a, b), f"{what}: kernel {name} differ from plain")
    for name, a, b in zip(("vk", "vc", "stamp"), st_k, st_p):
        _require(torch.equal(a, b), f"{what}: kernel state {name} differs from plain")
    return float((got[0] - want[0]).abs().max()) if got[0].numel() else 0.0


def time_scan(args, kwargs, flush, runs=TIMED_RUNS, plain_runs=TIMED_RUNS,
              plain_cut=None):
    """CUDA-event ms of the kernel and of the plain version (L2 flushed),
    host enqueue ms and device ms of the kernel, each over ``runs`` calls
    (``plain_runs`` for the plain version, on the first ``plain_cut``
    rows when given). Every call gets a fresh copy of the pre-call state
    (the scan updates it in place). Device ms is the whole launch: the
    offsets kernel and the scan."""
    from siddhi_tpu_torch.ops.distinct import distinct_scan, distinct_scan_plain

    state, rows = args[:3], args[3:]

    def calls(fn, n, cut=None):
        pool = []

        def refill(k=n):
            pool[:] = [[t.clone() for t in state] for _ in range(k)]

        refill(n + 1)
        r = [a if a is None or cut is None else a[:cut] for a in rows]

        def call():
            return fn(*pool.pop(), *r, **kwargs)

        call.refill = refill
        return call

    out = {"ms": time_ms(calls(distinct_scan, runs), runs=runs, flush=flush),
           "plain_ms": time_ms(calls(distinct_scan_plain, plain_runs, plain_cut),
                               runs=plain_runs, flush=flush),
           "host_ms": host_ms(calls(distinct_scan, runs), runs=runs)}
    scan = calls(distinct_scan, runs)
    out["device_ms"], out["device_seen"], out["device_traces"] = device_ms(
        scan, "distinct_scan_", flush, runs=runs,
        main=("distinct_scan_registers", "distinct_scan_hash"),
        refill=scan.refill)
    out["runs"] = runs
    if plain_cut is not None:
        out["cut_ms"] = time_ms(calls(distinct_scan, plain_runs, plain_cut),
                                runs=plain_runs, flush=flush)
    return out


def check_oracle(args, kwargs, what: str):
    """The kernel over one whole recorded batch against ``scan_oracle`` on
    the host: counts, snapshots, overflow and the updated state exactly
    equal. Returns the oracle's host seconds."""
    import numpy as np
    import torch

    from siddhi_tpu_torch.ops.distinct import distinct_scan

    st = [t.clone() for t in args[:3]]
    host = [t.cpu().numpy().copy() for t in args[:3]]
    rows = [None if a is None else a.cpu().numpy() for a in args[3:]]
    got = distinct_scan(*st, *args[3:], **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = scan_oracle(*host, *rows, **kwargs)
    seconds = time.perf_counter() - t0
    for name, a, b in zip(("counts", "snapshot keys", "snapshot mask"), got, want):
        _require((a is None) == (b is None), f"{what}: kernel and oracle disagree "
                 f"on whether there are {name}")
        if a is not None:
            _require(np.array_equal(a.cpu().numpy(), b),
                     f"{what}: kernel {name} differ from the host oracle")
    _require(bool(got[3]) == want[3], f"{what}: kernel overflow {bool(got[3])}, "
             f"oracle {want[3]}")
    for name, a, b in zip(("vk", "vc", "stamp"), st, host):
        _require(np.array_equal(a.cpu().numpy(), b),
                 f"{what}: kernel state {name} differs from the host oracle")
    return seconds


def crossover(args, kwargs, flush):
    """D1's recorded rows over tables of each H in ``CROSSOVER_H`` (the
    carried table cut or padded with never-used slots), through each of
    the kernel's paths: the launch's device ms (torch.profiler, L2
    flushed; a whole call is host-bound here, so CUDA events would time
    the host), and every path's counts and state equal to the first's."""
    import torch

    from siddhi_tpu_torch.ops import distinct

    vk, vc, stamp = args[:3]
    rows = args[3:]
    emit = kwargs.get("emit_set", False)
    paths = {"registers": distinct.PATH_REGISTERS, "hash": distinct.PATH_HASH}
    out = {}
    for H in CROSSOVER_H:
        k = min(H, vk.shape[1])
        vk_h = torch.zeros((vk.shape[0], H), dtype=vk.dtype, device=vk.device)
        vc_h = torch.full((vc.shape[0], H), -1, dtype=vc.dtype, device=vc.device)
        vk_h[:, :k], vc_h[:, :k] = vk[:, :k], vc[:, :k]
        ref = None
        for name, path in paths.items():
            st = [vk_h.clone(), vc_h.clone(), stamp.clone()]
            got = distinct.launch(*st, *rows, emit, path)
            torch.cuda.synchronize()
            if ref is None:
                ref = (got, st)
            else:
                _require(torch.equal(got[0], ref[0][0]) and all(
                    torch.equal(a, b) for a, b in zip(st, ref[1])),
                    f"crossover H={H}: the hash path differs from registers")
            pool = []

            def refill(k=CROSSOVER_RUNS):
                pool[:] = [[vk_h.clone(), vc_h.clone(), stamp.clone()]
                           for _ in range(k)]

            refill(CROSSOVER_RUNS + 1)
            # (ms, launches seen, traces)
            out[(H, name)] = device_ms(
                lambda: distinct.launch(*pool.pop(), *rows, emit, path),
                "distinct_scan_", flush, runs=CROSSOVER_RUNS,
                main=("distinct_scan_registers", "distinct_scan_hash"),
                refill=refill)
    return out


def sliding_distinct(symbols, window: int):
    """Distinct symbols among the trailing ``window`` events after each
    event, counted with a plain Python multiset (the independent check)."""
    import numpy as np

    _u, ids = np.unique(symbols, return_inverse=True)
    ids = ids.tolist()
    count = [0] * (max(ids) + 1)
    live, out = 0, []
    for t, s in enumerate(ids):
        if count[s] == 0:
            live += 1
        count[s] += 1
        if t >= window:
            o = ids[t - window]
            count[o] -= 1
            if count[o] == 0:
                live -= 1
        out.append(live)
    return np.asarray(out, np.int64)


def scan_oracle(vk, vc, stamp, g, v, delta, part, ep, set_in=None,
                set_in_m=None, emit_set=False):
    """The distinct scan as a sequential host model, independent of the
    port: row by row in arrival order, each touched group keeps a dict
    from value to a heap of its live slots (a carried-in table may hold a
    value live in more than one slot; the lowest wins) and a heap of its
    free slots (count <= 0), under the rules of ops/distinct.py: a row
    whose epoch differs from the group's stamp reads the table as empty
    and writes the reset only when it applies; an EXPIRED value with no
    live slot writes its key into the lowest free slot with count 0; a
    participating row that finds no slot overflows. numpy in, ``vk``,
    ``vc`` and ``stamp`` updated in place; returns ``(nd, snap_vk,
    snap_live, overflow)`` (the snapshots None unless ``emit_set``)."""
    import heapq

    import numpy as np

    K, H = vk.shape
    R = len(g)
    nd = np.zeros(R, np.int64)
    snap_vk = np.zeros((R, H), np.int64) if emit_set else None
    snap_live = np.zeros((R, H), bool) if emit_set else None
    overflow = False
    tables = {}                 # group -> [value -> live slots, free slots, live]
    gl, dl, pl, el = g.tolist(), delta.tolist(), part.tolist(), ep.tolist()
    if set_in is None:
        rows = ([(x, p)] for x, p in zip(v.tolist(), pl))
    else:
        rows = ([(x, p and m) for x, m in zip(xs, ms)]
                for xs, ms, p in zip(set_in.tolist(), set_in_m.tolist(), pl))
    for i, elems in enumerate(rows):
        gi = gl[i]
        t = tables.get(gi)
        if t is None:
            live = {}
            for s in np.flatnonzero(vc[gi] > 0).tolist():
                heapq.heappush(live.setdefault(int(vk[gi, s]), []), s)
            t = tables[gi] = [live, np.flatnonzero(vc[gi] <= 0).tolist(),
                              int((vc[gi] > 0).sum())]
        fresh = int(stamp[gi]) != el[i]
        applied = False
        for val, p in elems:
            live, free = t[0], t[1]
            slots = None if fresh else live.get(val)
            slot = slots[0] if slots else 0 if fresh else free[0] if free else None
            if slot is None:
                overflow |= bool(p)
                continue
            if not p:
                continue
            if fresh:               # the reset, written by the first applied element
                vc[gi] = -1
                t[:] = [{}, list(range(H)), 0]
                live, free, fresh = t[0], t[1], False
            newc = max((int(vc[gi, slot]) if slots else 0) + dl[i], 0)
            vk[gi, slot] = val
            vc[gi, slot] = newc
            if not slots and newc > 0:      # born: the lowest free slot
                heapq.heappop(free)
                live[val] = [slot]
                t[2] += 1
            elif slots and newc == 0:       # died: the slot is free again
                heapq.heappop(slots)
                if not slots:
                    del live[val]
                heapq.heappush(free, slot)
                t[2] -= 1
            applied = True
        if applied:
            stamp[gi] = el[i]
        nd[i] = 0 if fresh else t[2]
        if emit_set:
            snap_vk[i] = vk[gi]
            snap_live[i] = False if fresh else vc[gi] > 0
    return nd, snap_vk, snap_live, overflow


def one_group(device, feed, label: str, window: int, H: int, flush, card: str,
              on_start, app: str = D2_APP, column: str = "symbol",
              runs: int = TIMED_RUNS):
    """``distinctCount(<column>)`` over a ``#window.length(window)`` with no
    ``group by`` (one chain of every row) at ``H`` value slots: one launch
    per batch, every count equal to ``sliding_distinct``'s; the kernel on
    batch 3 == plain on its first ``D2_CUT`` rows and == ``scan_oracle``
    on the whole batch; its timings over ``runs`` calls. Returns (kernel
    facts with the app's state bytes and events/s, launches, max abs
    error)."""
    import numpy as np

    from siddhi_tpu_torch.ops.distinct import distinct_scan

    n = len(feed)
    with recording(at=2) as rec:
        out, secs, facts = run_app(device, app.format(W=window), feed,
                                   key_slots=None, capacity=H, on_start=on_start)
    launches = distinct_scan.launches
    _require(launches == n, f"{label}: {launches} launches for {n} batches")
    got = np.concatenate([b["distinct"] for b in out["OutStream"]])
    want = sliding_distinct(np.concatenate([c[column] for c, _t in feed]), window)
    _require(got.shape == want.shape and np.array_equal(got, want),
             f"{label}: distinct symbols differ from the numpy count at "
             f"{np.nonzero(got != want)[0][:5].tolist() if got.shape == want.shape else 'shape'}")
    a, kw = rec.args, rec.kwargs
    err = check_scan(a, kw, f"{label} scan", cut=D2_CUT)
    oracle_s = check_oracle(a, kw, f"{label} scan")
    k = {**scan_facts(a, kw),
         **time_scan(a, kw, flush, runs=runs, plain_runs=1, plain_cut=D2_CUT)}
    k["share"] = k["bound_ms"] / k["device_ms"]
    k["ns_per_row"] = k["device_ms"] * 1e6 / k["chain"]
    k["state_bytes"], k["eps"] = facts["state_bytes"], steady_eps(secs, BATCH)
    print(f"[distinct] {label} distinctCount({column}) over #window.length({window}), "
          f"one group, H={H}: {facts['state_bytes']} state bytes, {launches} "
          f"launches, no overflow, every count == numpy's over {len(got)} rows, "
          f"peak {int(got.max())}; first batch {secs[0] * 1e3:.1f} ms, then "
          f"{steady_eps(secs, BATCH):.1f} events/s [{card}]", flush=True)
    print(f"[distinct] kernel at {label}'s shape (batch 3: {k['rows']} rows, one "
          f"chain of {k['chain']}): == plain on the first {D2_CUT} rows (kernel "
          f"{k['cut_ms']:.4f} ms, plain {k['plain_ms']:.4f} ms there); == the host "
          f"oracle on the whole batch (state, counts; oracle {oracle_s:.2f} s); "
          f"whole batch, L2 flushed: kernel {k['ms']:.4f} ms; host enqueue "
          f"{k['host_ms']:.4f} ms; device {k['device_ms']:.4f} ms "
          f"({k['device_seen']} of {k['runs']} launches seen, "
          f"{k['device_traces']} traces), "
          f"{k['ns_per_row']:.1f} ns per chain row, against a {k['bound_ms']:.4f} "
          f"ms byte bound, share {k['share']:.6f} [{card}]", flush=True)
    return k, launches, err


def phase_distinct(device, feed, card: str):
    """D1, D2, D3 and S on the card (see the module doc). Returns the
    distinct kernel's measurements at D1's, D2's and D3's shapes and its
    launch count on each main-path run."""
    import numpy as np
    import torch

    from siddhi_tpu_torch.ops.distinct import distinct_scan

    def reset():
        distinct_scan.launches = 0

    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    d1_app, n = D1_APP.format(W=WINDOW), len(feed)

    # D1: the flagship's shape, grouped, on the generic path
    with recording(at=n - 1) as rec1:
        d1, d1_s, f1 = run_app(device, d1_app, feed, on_start=reset)
    d1_launches = distinct_scan.launches
    _require(f1["stage"] == "LengthWindowStage",
             f"D1 planned on {f1['stage']}, not the generic window")
    _require(d1_launches == n, f"D1: {d1_launches} distinct-scan launches for "
             f"{n} batches: want one per batch")
    d1 = d1["OutStream"]
    rows_out = sum(len(b["__ts__"]) for b in d1)
    _require(rows_out == n * BATCH, f"D1: {rows_out} rows out for {n * BATCH} in")
    require_finite(d1, "D1 (card)")
    cpu, _s, _f = run_app(torch.device("cpu"), d1_app, feed[:CPU_BATCHES])
    worst = compare_outputs(d1[:CPU_BATCHES], cpu["OutStream"], "D1 card vs cpu")
    print(f"[distinct] D1 distinctCount(volume) + functions group by symbol, "
          f"H=64, {KEY_SLOTS} key slots: {f1['state_bytes']} state bytes on the "
          f"card, {d1_launches} kernel launches for {n} batches, no overflow, "
          f"{rows_out} rows out, first batch {d1_s[0] * 1e3:.1f} ms, then "
          f"{steady_eps(d1_s, BATCH):.1f} events/s [{card}]; first {CPU_BATCHES} "
          f"batches equal the CPU run (max float rel err {worst:.3g})", flush=True)

    a1, kw1 = rec1.args, rec1.kwargs
    err1 = check_scan(a1, kw1, "D1 scan")
    k1 = {**scan_facts(a1, kw1), **time_scan(a1, kw1, scratch)}
    k1["share"] = k1["bound_ms"] / k1["device_ms"]
    k1["ns_per_row"] = k1["device_ms"] * 1e6 / k1["chain"]
    print(f"[distinct] kernel at D1's shape (batch {n}: {k1['rows']} rows, "
          f"{k1['groups']} groups, H={k1['H']}, longest chain {k1['chain']}): "
          f"== plain; L2 flushed: kernel {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.4f} ms; host enqueue {k1['host_ms']:.4f} ms; "
          f"device {k1['device_ms']:.4f} ms ({k1['device_seen']} of "
          f"{k1['runs']} launches seen, {k1['device_traces']} traces), {k1['ns_per_row']:.1f} ns per chain "
          f"row, against a {k1['bound_ms']:.4f} ms byte bound ({k1['bytes']} "
          f"bytes), share {k1['share']:.4f} [{card}]", flush=True)
    cross = crossover(a1, kw1, scratch)
    for H in CROSSOVER_H:
        paths = " ".join(f"{name} {ms:.4f} ({seen} seen, {traces} traces)"
                         for (h, name), (ms, seen, traces) in cross.items()
                         if h == H)
        print(f"[distinct] crossover, D1's rows at H={H}, device ms of the "
              f"launch (L2 flushed, {CROSSOVER_RUNS} runs), every path == registers: "
              f"{paths} [{card}]", flush=True)

    # D2: one group, H = 1,024: distinct symbols among the last 1,000 trades
    k2, d2_launches, err2 = one_group(device, feed, "D2", WINDOW, D2_H, scratch,
                                      card, reset)
    # D3: one group, H = 8,192: distinct symbols among the last 10,000 trades
    k3, d3_launches, err3 = one_group(device, feed, "D3", D3_WINDOW, D3_H, scratch,
                                      card, reset)

    # S: createSet -> window unionSet group by symbol -> sizeOfSet
    s_feed = feed[:S_BATCHES]
    s_app = S_APP.format(W=WINDOW)
    sets, s_s, fs = run_app(device, s_app, s_feed, ("OutStream", "VolStream"),
                            on_start=reset)
    s_launches = distinct_scan.launches
    _require(s_launches == S_BATCHES,
             f"S: {s_launches} launches for {S_BATCHES} batches")
    for i, (sb, db) in enumerate(zip(sets["OutStream"], d1)):
        # the rows align (one out per in, in order); the two apps' string
        # ids differ (D1 encodes 'high' and 'low' first)
        _require(np.array_equal(sb["n"], db["volumes"]),
                 f"S: sizeOfSet differs from D1's distinctCount in batch {i}")
    cpu_s, _s, _f = run_app(torch.device("cpu"), s_app, s_feed[:1], ("VolStream",))
    compare_outputs(sets["VolStream"][:1], cpu_s["VolStream"],
                    "S unionSet companions card vs cpu")
    print(f"[distinct] S unionSet chain: {fs['state_bytes']} state bytes, "
          f"{s_launches} launches for {S_BATCHES} batches; sizeOfSet == D1's "
          f"distinctCount row for row; the first batch's [{2 * BATCH}, 64] "
          f"companions equal the CPU run's; first batch {s_s[0] * 1e3:.1f} ms, "
          f"then {steady_eps(s_s, BATCH):.1f} events/s [{card}]", flush=True)

    m, rt, _q = global_runtime(device, d1_app, "bench")
    profile_sends("distinct D1", rt.get_input_handler("StockStream"), feed, card)
    m.shutdown()
    return {"launches": {"D1": d1_launches, "D2": d2_launches, "D3": d3_launches,
                         "S": s_launches},
            "d1": k1, "d2": k2, "d3": k3, "max_abs_err": max(err1, err2, err3),
            "d1_out": d1}


# -------------------------------------------------------------- pipeline

PIPE_DEPTHS = (1, 4, 8)
PIPE_TIMEOUT_S = 300


def wait_rows(cb, rows: int, what: str):
    """Wait, blocked on an event the collector sets (no polling thread
    competing for the GIL), until it holds ``rows`` output rows (an @Async
    worker delivers them); fails after PIPE_TIMEOUT_S."""
    cb.target = rows
    cb.reached.clear()
    if cb.rows >= rows:
        return
    _require(cb.reached.wait(PIPE_TIMEOUT_S),
             f"{what}: {cb.rows} of {rows} rows after {PIPE_TIMEOUT_S} s")


@contextlib.contextmanager
def counting_syncs(out: dict):
    """Count the card's host syncs in the block: torch's sync debug mode
    warns at each synchronizing call on any thread (``.item()``,
    ``nonzero``, a copy to pageable memory, ...); the warnings are
    recorded, counted and grouped by the Python line that made them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = {}
    for w in syncs:
        key = f"{Path(w.filename).name}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    out["syncs"] = len(syncs)
    out["sync_sites"] = sorted(sites.items(), key=lambda kv: -kv[1])[:6]


def run_async(device, app: str, query: str, feed, depth: int, *, cfg=None,
              key_slots=KEY_SLOTS, setup=None, measure: str = "time"):
    """Drive an @Async app at ``pipeline_depth`` ``depth`` through the
    public API: the first batch is sent and drained alone (its new
    strings and the card's first launches), then the others back to back,
    from the first send until every output row has arrived. ``measure``:
    "time" (the host clock only) or "profile" (the card's busy share from
    torch.profiler and host syncs counted in sync debug mode; both slow
    the host, so the timed pass runs without them). Returns (per-batch
    output columns, facts)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(
        {"siddhi_tpu.pipeline_depth": str(depth), **(cfg or {})}))
    rt = m.create_siddhi_app_runtime(app)
    q = rt.query_runtimes[query]
    if key_slots is not None:
        q.selector_plan.num_keys = key_slots
    if setup is not None:
        setup(q)
    cb = collector()
    rt.add_callback("OutStream", cb)
    h = rt.get_input_handler("StockStream")
    h.send_columns(feed[0][0], timestamps=feed[0][1])
    wait_rows(cb, BATCH, f"{query} depth {depth} first batch")
    pump = rt.app_context.completion_pump
    pump.high_water = 0
    pulls0, metas0, stalls0 = pump.pulls, pump.metas, pump.stalls
    facts = {}
    sends = []
    with contextlib.ExitStack() as stack:
        if measure == "profile":
            prof = stack.enter_context(profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            stack.enter_context(counting_syncs(facts))
        t0 = time.perf_counter()
        for cols, ts in feed[1:]:
            sends.append(time.perf_counter())
            h.send_columns(cols, timestamps=ts)
        wait_rows(cb, BATCH * len(feed), f"{query} depth {depth}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(feed) - 1
    facts.update(
        wall_s=wall, eps=BATCH * n / wall, high_water=pump.high_water,
        pulls=pump.pulls - pulls0, metas=pump.metas - metas0,
        stalls=pump.stalls - stalls0, dispatches=n)
    if len(cb.arrivals) == len(feed):        # one output batch per input batch
        lat = [(a - s_) * 1e3 for a, s_ in zip(cb.arrivals[1:], sends)]
        facts["latency_ms"] = (statistics.median(lat), max(lat))
    if measure == "profile":
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
        facts["busy_share"] = dev_us / 1e6 / wall
    facts["strings"] = list(rt.app_context.string_dictionary._to_str)
    m.shutdown()
    return cb.batches, facts


def require_equal(a, b, what: str, exact_floats: bool = True) -> float:
    """Per-batch outputs equal: ints, strings, timestamps, types and row
    order exactly, floats bit for bit (``exact_floats``) or to the repo's
    rtol. Returns the largest float relative difference."""
    worst = compare_outputs(a, b, what)
    if exact_floats:
        _require(worst == 0.0, f"{what}: floats differ (max rel err {worst:.3g})")
    return worst


def phase_pipeline(device, feed, fused, card: str):
    """bench.py's bench_pipeline_curve app (@Async, the global flagship)
    at depths 1, 4 and 8: outputs equal across depths and to phase 5's
    synchronous run, the pump holding >= 2 batches in flight at depth > 1;
    events/s, per-batch latency, metas per pull, busy share and host
    syncs per dispatch at each depth."""
    app = PIPE_APP.format(W=WINDOW)
    out = {}
    for depth in PIPE_DEPTHS:
        got, t = run_async(device, app, "bench", feed, depth)
        _got, p = run_async(device, app, "bench", feed, depth, measure="profile")
        worst = require_equal(got, fused, f"pipeline depth {depth} vs phase 5",
                              exact_floats=False)
        require_equal(_got, got, f"pipeline depth {depth}: profiled vs timed pass",
                      exact_floats=False)
        if depth > 1:
            _require(t["high_water"] >= 2 and p["high_water"] >= 2,
                     f"pipeline depth {depth}: the pump held at most "
                     f"{max(t['high_water'], p['high_water'])} batch(es) in flight")
        out[depth] = {**t, "busy_share": p["busy_share"], "syncs": p["syncs"],
                      "sync_sites": p["sync_sites"], "max_rel_err": worst}
        lat = t.get("latency_ms", (float("nan"), float("nan")))
        print(f"[pipeline] depth {depth}: {t['eps']:.1f} events/s send to drained "
              f"over {t['dispatches']} batches of {BATCH}; per-batch latency median "
              f"{lat[0]:.2f} ms, max {lat[1]:.2f} ms; most in flight {t['high_water']}; "
              f"{t['metas']} metas in {t['pulls']} pulls "
              f"({t['metas'] / max(1, t['pulls']):.2f} per pull), {t['stalls']} "
              f"stalled drains; card busy {100 * p['busy_share']:.1f}% of wall "
              f"(profiled pass, {p['eps']:.1f} events/s); host syncs "
              f"{p['syncs'] / p['dispatches']:.1f} per dispatch {p['sync_sites']}; "
              f"== phase 5 (max float rel err {worst:.3g}) [{card}]", flush=True)
    return out


def phase_pipeline_routed(device, feed, routed, card: str):
    """The routed partitioned flagship behind @Async at depth 4: one ring
    exchange launch per routed dispatch, no route overflow, output equal
    to phase 4's routed run."""
    from siddhi_tpu_torch.ops.exchange import ring_exchange
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    layout = {}

    def route(q):
        q._win_keys = KEY_SLOTS
        device_route_query_step(q, make_mesh(N_SHARDS, device),
                                rows_per_shard=ROWS_PER_SHARD)
        layout["rl"] = q._route_layout
        ring_exchange.launches = 0

    got, t = run_async(device, "@Async(buffer.size='64')\n" + APP.format(W=WINDOW),
                       "bench", feed, 4,
                       cfg={"siddhi_tpu.shard_exchange": "pallas_ring"}, setup=route)
    rl = layout["rl"]
    launches = ring_exchange.launches
    _require(launches == rl.dispatches >= len(feed),
             f"pipeline-routed: {launches} exchange launches for {rl.dispatches} "
             f"routed dispatches: want one per dispatch")
    _require(rl.route_overflow_rows == 0,
             f"pipeline-routed: route overflow {rl.route_overflow_rows}")
    _require(t["high_water"] >= 2,
             f"pipeline-routed: the pump held at most {t['high_water']} batch(es)")
    worst = require_equal(got, routed, "pipeline-routed vs phase 4", exact_floats=False)
    print(f"[pipeline-routed] x{N_SHARDS} at depth 4: {launches} exchange launches for "
          f"{rl.dispatches} routed dispatches, no route overflow, most in flight "
          f"{t['high_water']}, {t['eps']:.1f} events/s send to drained; == phase 4 "
          f"(max float rel err {worst:.3g}) [{card}]", flush=True)
    return launches


def phase_pipeline_distinct(device, feed, d1, card: str):
    """D1 behind @Async at depth 4: one distinct-scan launch per batch,
    output equal to phase 9's D1."""
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    def reset(_q):
        distinct_scan.launches = 0

    got, t = run_async(device, "@Async(buffer.size='64')\n" + D1_APP.format(W=WINDOW),
                       "bench", feed, 4, setup=reset)
    launches = distinct_scan.launches
    _require(launches == len(feed),
             f"pipeline-distinct: {launches} launches for {len(feed)} batches")
    _require(t["high_water"] >= 2,
             f"pipeline-distinct: the pump held at most {t['high_water']} batch(es)")
    worst = require_equal(got, d1, "pipeline-distinct vs phase 9 D1", exact_floats=False)
    print(f"[pipeline-distinct] D1 at depth 4: {launches} distinct-scan launches for "
          f"{len(feed)} batches, most in flight {t['high_water']}, {t['eps']:.1f} "
          f"events/s send to drained; == phase 9's D1 (max float rel err "
          f"{worst:.3g}) [{card}]", flush=True)
    return launches


def phase_ingest(device, feed, fused, strings, card: str):
    """The feed as wire frames (WireEncoder -> decode_frame ->
    send_columns) and through a pool of 4 packers: the global flagship's
    output equal to phase 5's columns ingest, every dictionary id equal;
    host ms per 65,536-row decode and pack, inline and pooled."""
    import numpy as np

    from siddhi_tpu_torch import InMemoryConfigManager
    from siddhi_tpu_torch.core.event import HostBatch, StringDictionary
    from siddhi_tpu_torch.core.stream.input.pack_pool import IngestPackPool
    from siddhi_tpu_torch.core.stream.input.wire import (
        DecoderRegistry, WireEncoder, decode_frame)

    app = GLOBAL_APP.format(W=WINDOW)
    enc = WireEncoder(1)
    t0 = time.perf_counter()
    frames = [enc.encode(cols, timestamps=ts) for cols, ts in feed]
    encode_ms = (time.perf_counter() - t0) * 1e3 / len(feed)
    m, rt, _q = global_runtime(device, app, "bench")
    cb = collector()
    rt.add_callback("OutStream", cb)
    h = rt.get_input_handler("StockStream")
    reg, defn = DecoderRegistry(), rt.junctions["StockStream"].definition
    decode_ms = []
    for frame in frames:
        t0 = time.perf_counter()
        data, ts = decode_frame(frame, defn, rt.app_context.string_dictionary, reg)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        h.send_columns(data, timestamps=ts)
    wire_strings = list(rt.app_context.string_dictionary._to_str)
    m.shutdown()
    require_equal(cb.batches, fused, "wire ingest vs columns ingest", exact_floats=False)
    _require(wire_strings == strings, "wire ingest: dictionary ids differ from "
             "columns ingest")

    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    split = max(256, BATCH // 8)     # 8,192 rows, the default, at the full size
    m.set_config_manager(InMemoryConfigManager({"siddhi_tpu.ingest_pool": "4",
                                                "siddhi_tpu.ingest_split": str(split)}))
    rt = m.create_siddhi_app_runtime(app)
    rt.query_runtimes["bench"].selector_plan.num_keys = KEY_SLOTS
    cb = collector()
    rt.add_callback("OutStream", cb)
    send_timed(rt.get_input_handler("StockStream"), feed, device)
    pool = rt.app_context.ingest_pack_pool
    _require(pool is not None and pool.subbatches >= 4 * len(feed),
             f"ingest pool: {getattr(pool, 'subbatches', 0)} sub-batches packed")
    pool_strings = list(rt.app_context.string_dictionary._to_str)
    m.shutdown()
    require_equal(cb.batches, fused, "pooled ingest vs inline", exact_floats=False)
    _require(pool_strings == strings, "pooled ingest: dictionary ids differ from inline")

    # the pack alone (HostBatch.from_columns, dictionary encode included),
    # inline and pooled, each into its own dictionary
    pool = IngestPackPool(rt.app_context, workers=4, split_rows=split)
    times = {"inline": [], "pool": []}
    dicts = {"inline": StringDictionary(), "pool": StringDictionary()}
    try:
        for cols, ts in feed:
            for name, pl in (("inline", None), ("pool", pool)):
                t0 = time.perf_counter()
                b = HostBatch.from_columns(cols, defn, dicts[name], timestamps=ts, pool=pl)
                times[name].append((time.perf_counter() - t0) * 1e3)
                if name == "inline":
                    ref = b
            for k in ref.cols:
                _require(np.array_equal(ref.cols[k], b.cols[k]),
                         f"pooled pack column {k} differs from inline")
    finally:
        pool.shutdown()
    _require(dicts["inline"]._to_str == dicts["pool"]._to_str,
             "pooled pack: dictionary ids differ")
    out = {"encode_ms": encode_ms, "decode_ms": statistics.mean(decode_ms[1:]),
           "decode_first_ms": decode_ms[0],
           "pack_ms": {k: statistics.mean(v[1:]) for k, v in times.items()},
           "pack_first_ms": {k: v[0] for k, v in times.items()}}
    print(f"[ingest] wire frames -> decode_frame -> send_columns == columns ingest, "
          f"every dictionary id equal; pool of 4 == inline (output and ids); host "
          f"ms per {BATCH}-row batch: encode {encode_ms:.2f}, decode "
          f"{out['decode_ms']:.2f} (first batch, {NUM_SYMBOLS} new strings: "
          f"{decode_ms[0]:.2f}); pack inline {out['pack_ms']['inline']:.2f}, pooled "
          f"{out['pack_ms']['pool']:.2f} (first batch {times['inline'][0]:.2f} / "
          f"{times['pool'][0]:.2f}) [{card}]", flush=True)
    return out


def phase_onerror(device, feed, card: str):
    """@OnError(action='stream'): a filter calls an extension function
    that raises when one symbol is present; that symbol is in one row of
    batch 2 only. The failing batch's rows arrive on !StockStream with
    _error, every other batch flows. A capacity overflow still raises
    FatalQueryError."""
    import numpy as np

    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.core.stream.junction import FatalQueryError
    from siddhi_tpu_torch.extension import ScalarFunction
    from siddhi_tpu_torch.query_api.definitions import AttrType

    bad = {}

    class Faults(StreamCallback):
        def __init__(self):
            self.events = []

        def receive(self, events):
            self.events.extend(events)

    class Tripwire(ScalarFunction):
        return_type = AttrType.BOOL

        @staticmethod
        def apply(xp, sym):
            if bool((sym == bad["id"]).any()):   # a host sync, by design
                raise ValueError("tripwire: symbol TRIP")
            return xp.ones_like(sym, dtype=xp.bool_)

    fail_at = 2
    feed = [(dict(cols), ts) for cols, ts in feed]
    sym = feed[fail_at][0]["symbol"].copy()
    sym[BATCH // 2] = "TRIP"
    feed[fail_at][0]["symbol"] = sym
    m = SiddhiManager(device=device)
    m.set_extension("function:tripwire", Tripwire)
    rt = m.create_siddhi_app_runtime("@OnError(action='stream')" + GLOBAL_APP.replace(
        "from StockStream#", "from StockStream[tripwire(symbol)]#").format(W=WINDOW))
    rt.query_runtimes["bench"].selector_plan.num_keys = KEY_SLOTS
    bad["id"] = rt.app_context.string_dictionary.encode("TRIP")
    cb, faults = collector(), Faults()
    rt.add_callback("OutStream", cb)
    rt.add_callback("!StockStream", faults)
    send_timed(rt.get_input_handler("StockStream"), feed, device)
    m.shutdown()
    fe = faults.events
    _require(len(fe) == BATCH,
             f"onerror: {len(fe)} fault rows, want the failing batch's {BATCH}")
    _require(np.array_equal(np.array([e.timestamp for e in fe]), feed[fail_at][1])
             and [e.data[0] for e in fe] == sym.tolist(),
             "onerror: the fault rows are not the failing batch's")
    _require(all("tripwire" in e.data[3] for e in fe),
             "onerror: _error does not name the failure")
    _require(cb.rows == BATCH * (len(feed) - 1) and len(cb.batches) == len(feed) - 1,
             f"onerror: {cb.rows} rows out of the other {len(feed) - 1} batches")

    over = SiddhiManager(device=device)
    rt = over.create_siddhi_app_runtime("@OnError(action='stream')" + D2_APP.format(W=WINDOW))
    for spec in rt.query_runtimes["bench"].selector_plan.specs:
        spec.distinct_capacity = 64
    try:
        rt.get_input_handler("StockStream").send_columns(feed[0][0], timestamps=feed[0][1])
        raised = None
    except FatalQueryError as e:
        raised = e
    finally:
        over.shutdown()
    _require(raised is not None and "distinct_values_capacity" in str(raised),
             "onerror: a full distinct value table did not raise FatalQueryError")
    print(f"[onerror] batch {fail_at}'s {BATCH} rows arrived on !StockStream with "
          f"_error, the other {len(feed) - 1} batches flowed ({cb.rows} rows); a "
          f"full value table still raised FatalQueryError [{card}]", flush=True)


def phase_transport(device, feed, card: str):
    """@source(type='inMemory') -> the global flagship -> @sink(type=
    'inMemory') over one batch of 65,536 rows, published one row a message
    (an @Async source stream coalesces them into units): what the sink
    publishes equals a StreamCallback's rows on the same stream."""
    import numpy as np

    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.extension import InMemoryBroker

    app = (GLOBAL_APP.format(W=WINDOW)
           .replace("define stream StockStream",
                    f"@Async(buffer.size='{BATCH}', batch.size='{BATCH}')\n"
                    "@source(type='inMemory', topic='smoke-in')\n"
                    "define stream StockStream")
           .replace("insert into OutStream;",
                    "insert into OutStream;\n@sink(type='inMemory', topic='smoke-out')\n"
                    "define stream OutStream (symbol string, avgPrice double, "
                    "totalVolume long);"))
    m = SiddhiManager(device=device)
    rt = m.create_siddhi_app_runtime(app)
    rt.query_runtimes["bench"].selector_plan.num_keys = KEY_SLOTS
    cb = collector()
    rt.add_callback("OutStream", cb)
    published = []

    class Sub(InMemoryBroker.Subscriber):
        topic = "smoke-out"

        def on_message(self, payload):
            published.append(payload)

    sub = Sub()
    InMemoryBroker.subscribe(sub)
    rt.start()
    cols, _ts = feed[0]
    rows = list(zip(cols["symbol"].tolist(), cols["price"].tolist(),
                    cols["volume"].tolist()))
    t0 = time.perf_counter()
    for row in rows:
        InMemoryBroker.publish("smoke-in", list(row))
    wait_rows(cb, BATCH, "transport")
    seconds = time.perf_counter() - t0
    m.shutdown()
    InMemoryBroker.unsubscribe(sub)
    dic = rt.app_context.string_dictionary
    want = [[dic.decode(int(i)), float(a), int(v)] for b in cb.batches
            for i, a, v in zip(b["symbol"], b["avgPrice"].tolist(),
                               b["totalVolume"].tolist())]
    _require(len(published) == BATCH and published == want,
             f"transport: the sink published {len(published)} rows, not the "
             f"{len(want)} the callback received")
    _require(np.isfinite(np.array([p[1] for p in published])).all(),
             "transport: non-finite averages")
    print(f"[transport] inMemory source -> flagship -> inMemory sink: {BATCH} rows in "
          f"{len(cb.batches)} units, the sink's payloads == the callback's rows, "
          f"{seconds:.2f} s from the first publish to the last row [{card}]", flush=True)


def phase_d4(device, feed, card: str):
    """D4: distinctCount(account) over #window.length(30000), one group,
    H = 32,768: the distinct scan's global-index path (one_group's
    checks). Returns (kernel facts with max_abs_err, launches)."""
    import torch

    from siddhi_tpu_torch.ops import distinct
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    def reset():
        distinct_scan.launches = 0

    _require(distinct.kernel_path(D4_H) == distinct.PATH_WIDE, "D4: H does not take the global-index path")
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    k, launches, err = one_group(device, d4_feed(feed), "D4", D4_WINDOW, D4_H, scratch,
                                 card, reset, app=D4_APP, column="account", runs=D4_RUNS)
    k["max_abs_err"] = err
    return k, launches


def d4_feed(feed):
    """The feed with an ``account`` column: int64 ids drawn uniformly from
    100,000 by their own seeded generator (the other columns unchanged)."""
    import numpy as np

    rng = np.random.default_rng(44)
    return [({**cols, "account": rng.integers(0, D4_ACCOUNTS, BATCH, dtype=np.int64)}, ts)
            for cols, ts in feed]


# ----------------------------------------------- time and batch windows

def tw_feed(seed: int, n_batches: int, batch: int = 0, rate: int = TW_RATE,
            n_symbols: int = 0):
    """make_feed's columns plus ``ts``, the event time: ``TW_BASE + row //
    rate`` ms over the whole feed, which is also each row's timestamp.
    Returns (feed, symbol ids of every row)."""
    import numpy as np

    batch = batch or BATCH
    n_symbols = n_symbols or NUM_SYMBOLS
    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i}" for i in range(n_symbols)], dtype=object)
    feed, ids_all = [], []
    for i in range(n_batches):
        ids = rng.integers(0, n_symbols, batch, dtype=np.int64)
        ts = TW_BASE + (i * batch + np.arange(batch, dtype=np.int64)) // rate
        feed.append(({"symbol": syms[ids],
                      "price": (rng.random(batch) * 100.0).astype(np.float32),
                      "volume": rng.integers(1, 1000, batch, dtype=np.int64),
                      "ts": ts}, ts))
        ids_all.append(ids)
    return feed, np.concatenate(ids_all)


def run_window(device, app: str, feed, capacity=None, key_slots=-1,
               distinct_h=None, on_start=None, keep=None, config=None,
               sweep=True):
    """Drive an app's ``bench`` query through the public API with
    ``siddhi_tpu.window_capacity`` = ``capacity`` and the other
    ``siddhi_tpu.*`` knobs of ``config``, counting its steps: batch steps
    and TIMER steps (the scheduler's chunks), per send. ``key_slots``
    (-1: the bench's) sets the selector's key capacity before the first
    send; ``sweep=False`` makes every TIMER step run at its own tick.
    ``keep(rt, h, steps)`` runs before the runtime shuts down. Returns
    (per-emission output columns, per-batch seconds, facts: the emissions
    after each send and the emitted rows' types before the re-publish
    turns EXPIRED into CURRENT among them)."""
    import numpy as np
    import torch

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    m = SiddhiManager(device=device)
    knobs = dict(config or {})
    if capacity is not None:
        knobs["window_capacity"] = capacity
    if knobs:
        m.set_config_manager(InMemoryConfigManager(
            {f"siddhi_tpu.{k}": str(v) for k, v in knobs.items()}))
    rt = m.create_siddhi_app_runtime(app)
    q = rt.query_runtimes["bench"]
    if key_slots is not None:       # -1: the bench's key capacity
        q.selector_plan.num_keys = KEY_SLOTS if key_slots < 0 else key_slots
    if distinct_h is not None:
        for spec in q.selector_plan.specs:
            spec.distinct_capacity = distinct_h
    if not sweep:
        q._sweep_horizon = lambda ts: None
    cb = collector()
    rt.add_callback("OutStream", cb)
    steps = {"batch": 0, "timer": 0, "batch_s": 0.0, "timer_s": 0.0}
    orig = q._finish_device_batch

    def counted(step, cols):
        kind = "timer" if q._now_override is not None else "batch"
        t0 = time.perf_counter()
        try:
            return orig(step, cols)
        finally:
            steps[kind] += 1
            steps[kind + "_s"] += time.perf_counter() - t0

    q._finish_device_batch = counted
    # the emitted rows' types before the re-publish turns EXPIRED into
    # CURRENT (one entry per emission, as the collector's batches)
    types = []
    orig_emit = q._emit

    def emit(out):
        if out.size:
            valid = np.asarray(out.cols["__valid__"])
            types.append(np.asarray(out.cols["__type__"])[valid].copy())
        return orig_emit(out)

    q._emit = emit
    if on_start is not None:
        on_start()
    h = rt.get_input_handler("StockStream")
    seconds, timers, emitted = [], [], []
    for cols, ts in feed:
        before = steps["timer"]
        t0 = time.perf_counter()
        h.send_columns(cols, timestamps=ts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        timers.append(steps["timer"] - before)
        emitted.append(len(cb.batches))
    facts = {"stage": type(q.window_stage or q.host_window).__name__,
             "steps": dict(steps), "timers": timers, "emitted": emitted,
             "types": types,
             "state_bytes": sum(t.numel() * t.element_size()
                                for r in rt.query_runtimes.values()
                                if r._state is not None for t in _leaves(r._state))}
    if keep is not None:
        facts["kept"] = keep(rt, h, steps)
    m.shutdown()
    return list(cb.batches), seconds, facts


def window_oracle(ids, ts, vol, price, lo):
    """For every row i: count, sum(volume) and the f64 mean of price over
    the rows j in [lo[i], i] of row i's symbol (numpy prefix sums over the
    rows sorted by symbol, then arrival; the price sums restart at each
    symbol, so their rounding stays that of one symbol's rows)."""
    import numpy as np

    N = len(ids)
    order = np.lexsort((np.arange(N), ids))
    pos = np.empty(N, np.int64)
    pos[order] = np.arange(N)
    skey = ids[order] * N + order
    pv = np.concatenate([[0], np.cumsum(vol[order])])
    sp = price[order].astype(np.float64)
    bounds = np.concatenate([[0], np.nonzero(np.diff(ids[order]))[0] + 1, [N]])
    pp = np.zeros(N + 1)
    for a, b in zip(bounds[:-1], bounds[1:]):
        pp[a + 1:b + 1] = np.cumsum(sp[a:b])
    start = np.searchsorted(skey, ids * N + lo)
    end = pos + 1
    n = end - start
    first = np.searchsorted(bounds, start, side="right") - 1
    # pp[k] is the sum over its block's rows before sorted position k;
    # a block's first position reads 0
    before = np.where(start == bounds[first], 0.0, pp[start])
    return n, pv[end] - pv[start], (pp[end] - before) / n


def check_window_batches(out, ids, feed, lo_of, label: str):
    """``out``: one output batch per input batch, one row per input row in
    order; n and totalVolume equal numpy's exactly, avgPrice its f64 mean
    to rtol 1e-9, over the rows ``lo_of(row) .. row`` of the row's
    symbol."""
    import numpy as np

    ts = np.concatenate([c["ts"] for c, _t in feed])
    vol = np.concatenate([c["volume"] for c, _t in feed])
    price = np.concatenate([c["price"] for c, _t in feed])
    lo = lo_of(ts)
    n, v, p = window_oracle(ids, ts, vol, price, lo)
    worst = 0.0
    _require(len(out) == len(feed), f"{label}: {len(out)} output batches for "
             f"{len(feed)} sends")
    B = len(feed[0][1])
    for b, cols in enumerate(out):
        s = slice(b * B, (b + 1) * B)
        _require(len(cols["n"]) == B, f"{label}: batch {b} has {len(cols['n'])} rows")
        _require(np.array_equal(cols["n"], n[s]) and np.array_equal(
            cols["totalVolume"], v[s]), f"{label}: batch {b} count or sum differs "
            f"from numpy at rows {np.nonzero(cols['n'] != n[s])[0][:5].tolist()}")
        # avg is a running f64 sum: rows that expired leave their rounding
        # behind (~1e-12 at these magnitudes), so a window left with one
        # small price has no relative tolerance (ROADMAP C, F2)
        err = np.abs(cols["avgPrice"] - p[s])
        worst = max(worst, float(err.max()))
        _require(np.all(err <= 1e-9 + 1e-9 * np.abs(p[s])),
                 f"{label}: batch {b} avgPrice differs from numpy's mean by up to "
                 f"{float(err.max()):.3g} at rows {np.nonzero(err > 1e-9)[0][:5].tolist()}")
    return int(n.max()), worst


def td_oracle(ids, feed):
    """Distinct symbols among the rows [lo_b, i] for every row i of batch
    b, lo_b the first row with ts > the batch's last ts - 60 s."""
    import numpy as np

    ts = np.concatenate([c["ts"] for c, _t in feed])
    N = len(ids)
    order = np.lexsort((np.arange(N), ids))
    prev = np.full(N, -1, np.int64)
    same = ids[order][1:] == ids[order][:-1]
    prev[order[1:][same]] = order[:-1][same]
    B = len(feed[0][1])
    out = []
    for b in range(len(feed)):
        end = (b + 1) * B
        lo = int(np.searchsorted(ts, ts[end - 1] - TW_MS, side="right"))
        cum = np.cumsum(prev[lo:end] < lo)
        out.append(cum[b * B - lo:])
    return np.concatenate(out)


@contextlib.contextmanager
def recording_batch_step(min_rows: int):
    """Keep the arguments of the last distinct-scan call with at least
    ``min_rows`` rows (a batch step, not a timer step), the state cloned
    before the call updates it."""
    from siddhi_tpu_torch.ops import aggregators
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    rec = ScanRecorder(at=-1)
    rec.calls = 0

    def call(*args, **kwargs):
        if args[3].numel() >= min_rows:
            rec.args = [a.clone() if a is not None else None for a in args]
            rec.kwargs = dict(kwargs)
        rec.calls += 1
        return distinct_scan(*args, **kwargs)

    orig = aggregators.distinct_scan
    aggregators.distinct_scan = call
    try:
        yield rec
    finally:
        aggregators.distinct_scan = orig


def profile_step(label: str, fn, steps, card: str):
    """torch.profiler over ``fn`` (a clock move that fires TIMER steps, or
    a send): wall, device busy share and the top device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = dict(steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    _require(dev_us > 0, f"profile {label}: no device time seen")
    ops = sorted((e for e in events if e.device_type != DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    n_timer = steps["timer"] - before["timer"]
    n_batch = steps["batch"] - before["batch"]
    print(f"[profile] {label} ({n_timer} TIMER and {n_batch} batch steps, the "
          f"TIMER steps' wall {1e3 * (steps['timer_s'] - before['timer_s']):.1f} "
          f"ms): wall {wall * 1e3:.1f} ms, device busy {dev_us / 1e3:.3f} ms "
          f"({100 * dev_us / 1e6 / wall:.1f}% of wall) [{card}]", flush=True)
    for e in ops[:8]:
        print(f"[profile]   {label} device {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:6d}x  {e.key[:80]}", flush=True)
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "timer_steps": n_timer, "batch_steps": n_batch}


def phase_windows(device, card: str):
    """Phase 17 (see the module doc): T, ET, TD, TB, LB at full width on the
    card with their checks, the cut variants against the CPU, the ring
    overflow, L in live mode, and H, F and R against the CPU. Returns the
    distinct kernel's facts at TD's shape and TD's launch count."""
    import threading

    import numpy as np
    import torch

    from siddhi_tpu_torch.core.stream.junction import FatalQueryError
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    t_phase = time.perf_counter()
    feed, ids = tw_feed(17, TW_BATCHES + 1)
    extra, feed = feed[-1], feed[:-1]        # T's profile batch, after the run
    ids = ids[:TW_BATCHES * BATCH]
    B = BATCH

    def eps(secs):
        return steady_eps(secs, B)

    def show(label, facts, secs, extra_text=""):
        st = facts["steps"]
        print(f"[windows] {label}: {facts['state_bytes']} state bytes on the card, "
              f"{st['batch']} batch steps and {st['timer']} timer steps "
              f"(per batch: {facts['timers']}), steps' wall: batch "
              f"{st['batch_s']:.2f} s, timer {st['timer_s']:.2f} s; first batch "
              f"{secs[0] * 1e3:.1f} ms, then {eps(secs):.1f} events/s{extra_text} "
              f"[{card}]", flush=True)

    # T: the sliding time window, group by symbol, on the generic path
    t_out, t_s, tf = run_window(
        device, T_APP.format(T=TW_WINDOW), feed, TW_CAPACITY,
        keep=lambda rt, h, steps: profile_step(
            "T, one more batch", lambda: h.send_columns(extra[0], timestamps=extra[1]),
            steps, card))
    _require(tf["stage"] == "TimeWindowStage", f"T planned on {tf['stage']}")
    fill = TW_MS * TW_RATE // B      # the batches before the first expiry
    _require(sum(tf["timers"][:fill]) == 0 and min(tf["timers"][fill + 1:]) > 0,
             f"T: timer steps per batch {tf['timers']}: want none before the "
             f"window fills, some in every batch after batch {fill}")

    def batch_lo(ts):
        last = ts.reshape(-1, B)[:, -1]
        return np.repeat(np.searchsorted(ts, last - TW_MS, side="right"), B)

    t_out = t_out[:tf["emitted"][-1]]     # the profile batch's rows left out
    peak, t_err = check_window_batches(t_out, ids, feed, batch_lo, "T")
    show(f"T time({TW_WINDOW})", tf, t_s, f"; every n, totalVolume == numpy, avgPrice "
         f"within 1e-9 (max abs err {t_err:.3g}; peak {peak} rows of one symbol live)")

    # ET: externalTime at B = 65,536 and Wc = 2,097,152
    et_out, et_s, ef = run_window(device, ET_APP.format(T=TW_WINDOW), feed,
                                  TW_CAPACITY)
    _require(ef["steps"]["timer"] == 0, "ET: externalTime asked for a timer")
    _peak, et_err = check_window_batches(et_out, ids, feed, lambda ts: np.searchsorted(
        ts, ts - TW_MS, side="right"), "ET")
    show(f"ET externalTime(ts, {TW_WINDOW})", ef, et_s, "; every n, totalVolume == "
         f"numpy (row's own cutoff), avgPrice within 1e-9 (max abs err {et_err:.3g})")

    # TD: distinct symbols in the last minute, H = 16,384
    def reset():
        distinct_scan.launches = 0

    with recording_batch_step(BATCH) as rec:
        td_out, td_s, tdf = run_window(device, TD_APP.format(T=TW_WINDOW), feed,
                                       TW_CAPACITY,
                                       key_slots=None, distinct_h=TD_H,
                                       on_start=reset)
    td_launches = distinct_scan.launches
    steps = tdf["steps"]["batch"] + tdf["steps"]["timer"]
    _require(td_launches == steps, f"TD: {td_launches} distinct-scan launches for "
             f"{steps} steps (timer steps included): want one per step")
    got = np.concatenate([b["distinct"] for b in td_out])
    want = td_oracle(ids, feed)
    _require(got.shape == want.shape and np.array_equal(got, want),
             "TD: distinct counts differ from numpy's")
    show(f"TD distinctCount(symbol) time({TW_WINDOW}), H={TD_H}", tdf, td_s,
         f"; every count == numpy's (peak {int(got.max())}); {td_launches} "
         f"kernel launches for {steps} steps")
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    a, kw = rec.args, rec.kwargs
    td_err = check_scan(a, kw, "TD scan", cut=D2_CUT)
    oracle_s = check_oracle(a, kw, "TD scan")
    k = {**scan_facts(a, kw),
         **time_scan(a, kw, scratch, plain_runs=1, plain_cut=D2_CUT)}
    k["share"] = k["bound_ms"] / k["device_ms"]
    k["ns_per_row"] = k["device_ms"] * 1e6 / k["chain"]
    print(f"[windows] kernel at TD's last batch step ({k['rows']} rows, one chain "
          f"of {k['chain']}, H={k['H']}): == plain on the first {D2_CUT} rows, == "
          f"the host oracle on the whole call ({oracle_s:.2f} s); L2 flushed: kernel "
          f"{k['ms']:.4f} ms a call (CUDA events), host enqueue {k['host_ms']:.4f} "
          f"ms, device {k['device_ms']:.4f} ms, {k['ns_per_row']:.1f} ns per chain "
          f"row, byte bound {k['bound_ms']:.4f} ms, share {k['share']:.6f} [{card}]",
          flush=True)
    k["max_abs_err"] = td_err

    # TB: per-second bars; LB: six or seven flushes inside one batch
    tb_feed = feed[:TB_BATCHES]
    tb_out, tb_s, tbf = run_window(device, TB_APP, tb_feed, TB_CAPACITY)
    tb_rows = sum(len(b["n"]) for b in tb_out)
    show("TB timeBatch(1 sec)", tbf, tb_s, f"; {tb_rows} bar rows")
    lb_out, lb_s, lbf = run_window(device, LB_APP, tb_feed, TB_CAPACITY)
    flushed = sum(int(b["n"].sum()) for b in lb_out)
    want_flushed = (TB_BATCHES * BATCH) // 10_000 * 10_000
    _require(flushed == want_flushed, f"LB: {flushed} rows flushed, want "
             f"{want_flushed}")
    show("LB lengthBatch(10000)", lbf, lb_s, f"; {flushed // 10_000} flushes, "
         f"the collapse's counts sum to every flushed row")
    cpu = torch.device("cpu")
    for label, app, cap, out in (("TB", TB_APP, TB_CAPACITY, tb_out),
                                 ("LB", LB_APP, TB_CAPACITY, lb_out)):
        cpu_out, _s, _f = run_window(cpu, app, tb_feed, cap)
        worst = compare_outputs(out, cpu_out, f"{label} card vs cpu")
        print(f"[windows] {label}: card == the port's CPU run over {TB_BATCHES} "
              f"batches (max float rel err {worst:.3g})", flush=True)

    # T and ET cut to 10 s windows: the card against the CPU
    cut = feed[:CUT_BATCHES]
    for label, app in (("T", T_APP), ("ET", ET_APP)):
        app = app.format(T=CUT_WINDOW)
        card_out, _s, cf = run_window(device, app, cut, CUT_CAPACITY)
        cpu_out, _s2, _f = run_window(cpu, app, cut, CUT_CAPACITY)
        worst = compare_outputs(card_out, cpu_out, f"{label} 10 s card vs cpu")
        print(f"[windows] {label} cut to a {CUT_WINDOW} window, {CUT_BATCHES} batches "
              f"({cf['steps']['timer']} timer steps): card == the port's CPU run "
              f"(max float rel err {worst:.3g}) [{card}]", flush=True)

    # the default ring of 4,096 rows overflows, naming its knob
    try:
        run_window(device, T_APP.format(T=TW_WINDOW), feed[:1], None)
        raise Failure("T at the default window_capacity did not overflow")
    except FatalQueryError as e:
        _require("window_capacity" in str(e), f"overflow names no knob: {e}")
        print(f"[windows] T at the default capacity of 4,096: FatalQueryError "
              f"'{str(e)[:110]}'", flush=True)

    # L: live mode; the expired rows come from the timer thread
    l_feed = [({**c, "symbol": c["symbol"][:L_ROWS], "price": c["price"][:L_ROWS],
                "volume": c["volume"][:L_ROWS], "ts": c["ts"][:L_ROWS]}, None)
              for c, _t in feed[:1]]
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    rt = m.create_siddhi_app_runtime(L_APP)
    lcb = collector()
    seen = []
    orig_rb = lcb.receive_batch

    def receive_batch(batch, junction):
        seen.append((threading.get_ident(), time.perf_counter(),
                     int(time.time() * 1000)))
        orig_rb(batch, junction)

    lcb.receive_batch = receive_batch
    lcb.target = L_ROWS
    rt.add_callback("OutStream", lcb)
    # the rows' timestamp is the wall clock's millisecond at the send, at or
    # after this one; they expire 250 ms after it
    t0_ms = int(time.time() * 1000)
    t0 = time.perf_counter()
    rt.get_input_handler("StockStream").send_columns(l_feed[0][0])
    sent = time.perf_counter()
    arrived = lcb.reached.wait(L_WAIT_S)
    m.shutdown()
    _require(arrived and lcb.rows == L_ROWS,
             f"L: {lcb.rows} expired rows within {L_WAIT_S} s, want {L_ROWS}")
    first = seen[0][1] - t0
    first_ms = seen[0][2] - t0_ms
    _require(250 <= first_ms and first <= L_WAIT_S and all(
        tid != threading.get_ident() for tid, _t, _w in seen),
        f"L: expired rows {first_ms} ms after the send's millisecond, on "
        f"threads {set(t for t, _, _w in seen)}")
    print(f"[windows] L time(250 millisec), live: {L_ROWS} expired rows from the "
          f"timer thread {first * 1e3:.1f} ms after the send (send returned after "
          f"{(sent - t0) * 1e3:.1f} ms) [{card}]", flush=True)

    # H, F, R: host stages behind a device step, against the CPU
    hfr, _ids = tw_feed(23, 2, batch=HFR_BATCH, rate=HFR_RATE)
    for label, app in (("H sort(10, price)", H_APP), ("F pol2Cart + casts", F_APP),
                       ("R output last every 1 sec", R_APP)):
        rows = []
        for dev in (device, cpu):
            mm = SiddhiManager(device=dev)
            rr = mm.create_siddhi_app_runtime(app)
            ev = event_rows()
            rr.add_callback("OutStream", ev)
            hh = rr.get_input_handler("StockStream")
            t0 = time.perf_counter()
            for c, ts in hfr:
                hh.send_columns(c, timestamps=ts)
            secs = time.perf_counter() - t0
            mm.shutdown()
            rows.append((ev.rows, secs))
        _require(len(rows[0][0]) > 0, f"{label}: no output")
        require_rows_equal(rows[0][0], rows[1][0], label)
        print(f"[windows] {label}: {len(rows[0][0])} rows, card == the port's "
              f"CPU run; {2 * HFR_BATCH} events in {rows[0][1] * 1e3:.1f} ms on "
              f"the card [{card}]", flush=True)
    print(f"[windows] phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k, td_launches, {"T": tf, "ET": ef, "TD": tdf, "TB": tbf, "LB": lbf}


# ------------------------------------------------- partitions (phase 18)

def distinct_oracle(ids, vals, feed, B: int, lo_of):
    """For every row i of batch b: the distinct ``vals`` among row i's
    symbol's rows j in [lo_b, i] (lo_of gives each batch's first live
    row): each (symbol, value) pair counts at its first live occurrence."""
    import numpy as np

    N = len(ids)
    idx = np.arange(N)
    # previous row of the same (symbol, value)
    o = np.lexsort((idx, vals, ids))
    prev = np.full(N, -1, np.int64)
    same = (ids[o][1:] == ids[o][:-1]) & (vals[o][1:] == vals[o][:-1])
    prev[o[1:][same]] = o[:-1][same]
    # rows by (symbol, arrival): per-symbol running counts are prefix sums
    so = np.lexsort((idx, ids))
    seg = np.concatenate([[True], ids[so][1:] != ids[so][:-1]])
    seg_start = np.maximum.accumulate(np.where(seg, np.arange(N), 0))
    out = np.empty(N, np.int64)
    for b in range(len(feed)):
        lo, end = lo_of(b), (b + 1) * B
        first = (prev[so] < lo) & (so >= lo) & (so < end)
        c = np.cumsum(first)
        run = c - np.where(seg_start > 0, c[seg_start - 1], 0)
        mine = (so >= b * B) & (so < end)
        out[so[mine]] = run[mine]
    return out


def session_ranks(ids, ts, B: int, gap: int):
    """Each row's 1-based rank in its symbol's session: a session ends
    where the symbol's next row is more than ``gap`` ms later within one
    batch, or, across batches, where the clock (the next batch's last ts)
    has passed the previous row's ts + gap before that batch runs (timers
    drain idle sessions before each batch)."""
    import numpy as np

    N = len(ids)
    batch = np.arange(N) // B
    now = ts.reshape(-1, B)[:, -1]
    so = np.lexsort((np.arange(N), ids))
    s_ids, s_ts, s_b = ids[so], ts[so], batch[so]
    same = np.concatenate([[False], s_ids[1:] == s_ids[:-1]])
    p_ts = np.concatenate([[0], s_ts[:-1]])
    p_b = np.concatenate([[0], s_b[:-1]])
    new = ~same | np.where(p_b == s_b, s_ts - p_ts > gap, p_ts + gap <= now[s_b])
    start = np.maximum.accumulate(np.where(new, np.arange(N), 0))
    rank = np.empty(N, np.int64)
    rank[so] = np.arange(N) - start + 1
    return rank


def phase_partitions(device, card: str):
    """Phase 18 (see the module doc): PT, PET, PS, PLB, PR and PI at full
    width with their checks, the sweep check, the cut windows against the
    CPU, purge and overflow. Returns (PT's distinct-kernel facts, PT's
    launches, per-configuration facts)."""
    import numpy as np
    import torch

    from siddhi_tpu_torch.core.stream.junction import FatalQueryError
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    feed, ids = tw_feed(18, TW_BATCHES + 1)
    extra, feed = feed[-1], feed[:-1]        # PT's profile batch, after the run
    ids = ids[:TW_BATCHES * BATCH]
    B = BATCH
    ts_all = np.concatenate([c["ts"] for c, _t in feed])
    res = {}

    def show(label, facts, secs, extra_text=""):
        st = facts["steps"]
        print(f"[partitions] {label}: {facts['state_bytes']} state bytes on the card, "
              f"{st['batch']} batch steps and {st['timer']} TIMER steps (per batch: "
              f"{facts['timers']}), steps' wall: batch {st['batch_s']:.2f} s, TIMER "
              f"{st['timer_s']:.2f} s; first batch {secs[0] * 1e3:.1f} ms, then "
              f"{steady_eps(secs, B):.1f} events/s{extra_text} [{card}]", flush=True)
        res[label.split()[0]] = {
            "state_bytes": facts["state_bytes"], "timer_steps": facts["timers"],
            "batch_steps": st["batch"], "first_batch_ms": secs[0] * 1e3,
            "events_per_s": steady_eps(secs, B)}

    def batch_lo(ts):
        last = ts.reshape(-1, B)[:, -1]
        return np.repeat(np.searchsorted(ts, last - TW_MS, side="right"), B)

    # PT: per-key sliding time window with distinctCount, H = 256
    def reset():
        distinct_scan.launches = 0

    with recording_batch_step(BATCH) as rec:
        def profile_pt(rt, h, steps):
            kept = {"launches": distinct_scan.launches, "steps": dict(steps),
                    "scan": (rec.args, rec.kwargs)}
            cols, ts = extra
            tsg = rt.app_context.timestamp_generator
            kept["timer"] = profile_step(
                "PT swept TIMER step",
                lambda: tsg.set_current_timestamp(int(ts.max())), steps, card)
            kept["batch"] = profile_step(
                "PT batch step", lambda: h.send_columns(cols, timestamps=ts),
                steps, card)
            return kept

        pt_out, pt_s, ptf = run_window(
            device, PT_APP.format(T=TW_WINDOW), feed, key_slots=None,
            distinct_h=PT_H, on_start=reset, keep=profile_pt)
    kept = ptf["kept"]
    a, kw = kept["scan"]
    pt_launches = kept["launches"]
    steps = kept["steps"]["batch"] + kept["steps"]["timer"]
    _require(ptf["stage"] == "KeyedTimeWindowStage", f"PT planned on {ptf['stage']}")
    _require(pt_launches == steps, f"PT: {pt_launches} distinct-scan launches for "
             f"{steps} steps (TIMER steps included): want one per step")
    cur = pt_out[:ptf["emitted"][-1]]       # the profile batch's rows left out
    peak, pt_err = check_window_batches(cur, ids, feed, batch_lo, "PT")
    lo = batch_lo(ts_all)
    got = np.concatenate([b["volumes"] for b in cur])
    vol = np.concatenate([c["volume"] for c, _t in feed])
    want = distinct_oracle(ids, vol, feed, B, lambda b: int(lo[b * B]))
    _require(np.array_equal(got, want), f"PT: distinctCount(volume) differs from "
             f"numpy's at rows {np.nonzero(got != want)[0][:5].tolist()}")
    show(f"PT time({TW_WINDOW}) per symbol", ptf, pt_s,
         f"; every n, totalVolume, volumes == numpy's, avgPrice within 1e-9 (max "
         f"abs err {pt_err:.3g}; peak {peak} rows of one symbol live); "
         f"{pt_launches} distinct-scan launches for {steps} steps")
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    pt_err_k = check_scan(a, kw, "PT scan", cut=D2_CUT)
    oracle_s = check_oracle(a, kw, "PT scan")
    k = {**scan_facts(a, kw), **time_scan(a, kw, scratch, plain_runs=1,
                                          plain_cut=D2_CUT)}
    k["share"] = k["bound_ms"] / k["device_ms"]
    k["ns_per_row"] = k["device_ms"] * 1e6 / k["chain"]
    k["max_abs_err"] = pt_err_k
    print(f"[partitions] kernel at PT's last batch step ({k['rows']} rows, "
          f"{k['groups']} groups, longest chain {k['chain']}, H={k['H']}): == plain "
          f"on the first {D2_CUT} rows, == the host oracle on the whole call "
          f"({oracle_s:.2f} s); L2 flushed: kernel {k['ms']:.4f} ms a call (CUDA "
          f"events), host enqueue {k['host_ms']:.4f} ms, device {k['device_ms']:.4f} "
          f"ms, {k['ns_per_row']:.1f} ns per chain row, byte bound "
          f"{k['bound_ms']:.4f} ms, share {k['share']:.6f} [{card}]", flush=True)

    # PET: per-key external clocks, no timers
    pet_out, pet_s, petf = run_window(device, PET_APP.format(T=TW_WINDOW), feed,
                                      key_slots=None)
    _require(petf["steps"]["timer"] == 0, "PET: externalTime asked for a timer")
    _p, pet_err = check_window_batches(pet_out, ids, feed, lambda ts: np.searchsorted(
        ts, ts - TW_MS, side="right"), "PET")
    show(f"PET externalTime(ts, {TW_WINDOW}) per symbol", petf, pet_s,
         f"; every n, totalVolume == numpy's (row's own cutoff), avgPrice within "
         f"1e-9 (max abs err {pet_err:.3g})")

    # PS, PLB, PR, PI over 8 batches; their first 2 against the CPU
    cut = feed[:PART_BATCHES]
    ids8, ts8 = ids[:PART_BATCHES * B], ts_all[:PART_BATCHES * B]
    price8 = np.concatenate([c["price"] for c, _t in cut])
    outs = {}

    def profile_ps(rt, h, steps):
        # one more batch: its swept TIMER step (the idle sessions), then
        # its batch step
        cols, ts = feed[PART_BATCHES]
        tsg = rt.app_context.timestamp_generator
        return {"timer": profile_step(
                    "PS swept TIMER step",
                    lambda: tsg.set_current_timestamp(int(ts.max())), steps, card),
                "batch": profile_step(
                    "PS batch step", lambda: h.send_columns(cols, timestamps=ts),
                    steps, card)}

    for label, app in (("PS", PS_APP.format(G=PS_GAP)), ("PLB", PLB_APP),
                       ("PR", PR_APP), ("PI", PI_APP)):
        out, secs, f = run_window(device, app, cut, key_slots=None,
                                  keep=profile_ps if label == "PS" else None)
        out = out[:f["emitted"][-1]]      # the profile batch's rows left out
        cpu_out, _s, cf = run_window(cpu, app, cut[:CPU_BATCHES], key_slots=None)
        n2 = f["emitted"][CPU_BATCHES - 1]
        _require(cf["emitted"][-1] == n2, f"{label}: {n2} emissions on the card in "
                 f"{CPU_BATCHES} batches, {cf['emitted'][-1]} on the CPU")
        worst = compare_outputs(out[:n2], cpu_out, f"{label} card vs cpu")
        outs[label] = (out, secs, f, worst)
    out, secs, f, worst = outs["PS"]
    rows = {k: np.concatenate([b[k] for b in out]) for k in ("symbol", "n")}
    is_cur = np.concatenate(f["types"][:len(out)]) == 0
    rank = session_ranks(ids8, ts8, B, PS_GAP_MS)
    _require(is_cur.sum() == len(ids8) and np.array_equal(rows["n"][is_cur], rank),
             f"PS: CURRENT rows' n differ from numpy's session ranks at "
             f"{np.nonzero(rows['n'][is_cur] != rank)[0][:5].tolist()}")
    # per symbol: a session's first row comes after every earlier row expired
    sym = rows["symbol"]
    o = np.lexsort((np.arange(len(sym)), sym))
    seg = np.concatenate([[True], sym[o][1:] != sym[o][:-1]])
    base = np.maximum.accumulate(np.where(seg, np.arange(len(o)), 0))
    c_cur = np.cumsum(is_cur[o]) - is_cur[o]
    c_exp = np.cumsum(~is_cur[o]) - (~is_cur[o])
    firsts = is_cur[o] & (rows["n"][o] == 1)
    before_cur = c_cur - np.where(base > 0, c_cur[base], 0)
    before_exp = c_exp - np.where(base > 0, c_exp[base], 0)
    _require(np.array_equal(before_cur[firsts], before_exp[firsts]),
             "PS: a session's first row came before the previous session expired")
    sessions = int(firsts.sum())
    show(f"PS session({PS_GAP}) per symbol", f, secs,
         f"; every CURRENT n == numpy's session rank, {sessions} sessions, each "
         f"after its predecessor's EXPIRED rows; first {CPU_BATCHES} batches == "
         f"the CPU (max float rel err {worst:.3g})")
    out, secs, f, worst = outs["PLB"]
    n = np.concatenate([b["n"] for b in out])
    _require(len(n) > 0 and np.all(n == 4), "PLB: a flushed row's n is not 4")
    show("PLB lengthBatch(4) per symbol", f, secs,
         f"; {len(n)} flushes, every n == 4; first {CPU_BATCHES} batches == the "
         f"CPU (max float rel err {worst:.3g})")
    out, secs, f, worst = outs["PR"]
    rows_out = sum(len(b["n"]) for b in out)
    p = price8.astype(np.float64)
    matches = int((p < 10.0).sum() + ((p >= 10.0) & (p < 60.0)).sum()
                  + (p >= 50.0).sum())
    _require(rows_out == matches, f"PR: {rows_out} CURRENT rows, numpy counts "
             f"{matches} range matches")
    show("PR range partition (3 ranges)", f, secs,
         f"; {rows_out} rows == numpy's {matches} range matches (rows in 50-60 "
         f"twice); first {CPU_BATCHES} batches == the CPU (max float rel err "
         f"{worst:.3g})")
    out, secs, f, worst = outs["PI"]
    show("PI inner #stream -> length(1000) per symbol", f, secs,
         f"; {sum(len(b['avgPrice']) for b in out)} rows; first {CPU_BATCHES} "
         f"batches == the CPU (max float rel err {worst:.3g})")

    # sweeps: PT's and PS's queries at 100 ms over a small feed, swept and
    # one step per tick, on the card
    small, _ids = tw_feed(19, 3, SWEEP_BATCH, SWEEP_RATE, SWEEP_SYMBOLS)
    for label, app in (("PT", PT_APP.format(T="100 millisec")),
                       ("PS", PS_APP.format(G="100 millisec"))):
        s_out, _s, sf = run_window(device, app, small, key_slots=None,
                                   distinct_h=PT_H)
        u_out, _s2, uf = run_window(device, app, small, key_slots=None,
                                    distinct_h=PT_H, sweep=False)
        compare_outputs(s_out, u_out, f"{label} swept vs unswept")
        _require(sf["steps"]["timer"] < uf["steps"]["timer"],
                 f"{label}: the sweep took {sf['steps']['timer']} TIMER steps, "
                 f"unswept {uf['steps']['timer']}")
        print(f"[partitions] {label} at 100 ms, {SWEEP_SYMBOLS} symbols, 3 x "
              f"{SWEEP_BATCH} rows: swept ({sf['steps']['timer']} TIMER steps, "
              f"{sf['steps']['timer_s']:.2f} s) == one step per tick "
              f"({uf['steps']['timer']} TIMER steps, {uf['steps']['timer_s']:.2f} s), "
              f"{len(s_out)} emitted chunks [{card}]", flush=True)

    # the other keyed windows and the partitioned host windows, cut
    cut_feed, _ids = tw_feed(20, 2, HFR_BATCH, HFR_RATE, SWEEP_SYMBOLS)
    for win in PART_CUT_WINDOWS:
        app = PART_CUT_APP.format(W=win)
        # delay's ring (window_capacity) holds a whole batch of 8,192 rows
        c_out, c_s, cf = run_window(device, app, cut_feed, key_slots=None,
                                    config=PART_CUT_CONFIG)
        p_out, _s, _f = run_window(cpu, app, cut_feed, key_slots=None,
                                   config=PART_CUT_CONFIG)
        _require(sum(len(b["n"]) for b in c_out) > 0, f"{win}: no output")
        worst = compare_outputs(c_out, p_out, f"{win} card vs cpu")
        print(f"[partitions] #window.{win} per symbol ({cf['stage']}): card == the "
              f"port's CPU run over 2 x {HFR_BATCH} rows, {len(c_out)} emissions, "
              f"{cf['steps']['timer']} TIMER steps (max float rel err {worst:.3g}); "
              f"{2 * HFR_BATCH} events in {sum(c_s) * 1e3:.1f} ms [{card}]", flush=True)

    # purge: half the keys idle past the period, then one more batch
    pur = phase_purge(device, feed[:PURGE_BATCHES], card)
    res["purge"] = pur

    # overflow: 64 rows a key fill within a few batches
    try:
        run_window(device, PT_APP.format(T=TW_WINDOW), feed, key_slots=None,
                   config={"partition_window_capacity": 64}, distinct_h=PT_H)
        raise Failure("PT at partition_window_capacity 64 did not overflow")
    except FatalQueryError as e:
        _require("partition_window_capacity" in str(e), f"overflow names no knob: {e}")
        print(f"[partitions] PT at partition_window_capacity 64: FatalQueryError "
              f"'{str(e)[:110]}'", flush=True)
    res["PT"]["profile"] = {"timer": kept["timer"], "batch": kept["batch"]}
    res["PS"]["profile"] = outs["PS"][2]["kept"]
    print(f"[partitions] phase 18 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k, pt_launches, res


def phase_purge(device, feed, card: str):
    """PT's app with ``@purge`` over ``feed``: half the keys marked idle
    past the period (tests/test_partition_purge.py does the same), purged,
    then one more batch of kept and new symbols. The new keys take the
    freed ids, every new key's first n and volumes are 1 and its
    totalVolume its own volume, and the kept keys' rows equal an unpurged
    run's."""
    import numpy as np

    half = NUM_SYMBOLS // 2
    rng = np.random.default_rng(21)
    pick = rng.integers(0, half, BATCH)
    new_rows = rng.random(BATCH) < 0.5
    syms = np.where(new_rows, np.char.add("N", pick.astype(str)),
                    np.char.add("S", (half + pick).astype(str))).astype(object)
    ts = int(feed[-1][1][-1]) + 1 + np.arange(BATCH, dtype=np.int64) // TW_RATE
    vol = rng.integers(1, 1000, BATCH, dtype=np.int64)
    more = ({"symbol": syms, "price": (rng.random(BATCH) * 100).astype(np.float32),
             "volume": vol, "ts": ts}, ts)
    _u, at = np.unique(syms[new_rows], return_index=True)
    first_new = np.nonzero(new_rows)[0][at]
    facts = {}

    def purge_half(rt, h, steps):
        pctx = rt.partition_contexts[0]
        enc = rt.app_context.string_dictionary.encode
        ks = pctx.keyspace
        idle = [ks._map[(enc(f"S{i}"),)] for i in range(half)]
        old = int(time.time() * 1000) - 2 * 3600_000
        for i in idle:
            ks.last_seen[i] = old
        t0 = time.perf_counter()
        freed = pctx.purge()
        facts["purge_ms"] = (time.perf_counter() - t0) * 1e3
        facts["freed"] = len(freed)
        _require(sorted(freed) == sorted(idle), "purge retired other ids than "
                 "the idle keys'")
        h.send_columns(more[0], timestamps=more[1])
        new_ids = {ks._map[(enc(f"N{i}"),)] for i in np.unique(pick[new_rows])}
        facts["reused"] = len(new_ids & set(freed))
        _require(new_ids <= set(freed), "new keys did not take the freed ids")
        return facts

    app = PT_APP.format(T=TW_WINDOW)
    purged = app.replace("partition with", "@purge(enable='true', interval='1 sec', "
                         "idle.period='1 hour')\npartition with")
    p_out, _s, pf = run_window(device, purged, feed, key_slots=None,
                               distinct_h=PT_H, keep=purge_half)
    u_out, _s, uf = run_window(device, app, feed + [more], key_slots=None,
                               distinct_h=PT_H)

    def last_rows(out, start):
        keys = ("n", "totalVolume", "avgPrice", "volumes", "__ts__")
        rows = {k: np.concatenate([b[k] for b in out[start:]]) for k in keys}
        _require(len(rows["n"]) == BATCH, f"purge: {len(rows['n'])} rows out of "
                 f"the last batch's {BATCH}")
        return rows

    p_last = last_rows(p_out, pf["emitted"][-1])
    u_last = last_rows(u_out, uf["emitted"][-2])
    _require(np.all(p_last["n"][first_new] == 1) and np.all(
        p_last["volumes"][first_new] == 1) and np.array_equal(
        p_last["totalVolume"][first_new], vol[first_new]),
        "purge: a new key's first row does not start from a clean state")
    for k in p_last:
        a, b = p_last[k][~new_rows], u_last[k][~new_rows]
        same = (np.allclose(a, b, rtol=FLOAT_RTOL, atol=0) if a.dtype.kind == "f"
                else np.array_equal(a, b))
        _require(same, f"purge: kept keys' {k} differ from the unpurged run")
    print(f"[partitions] purge: {facts['freed']} idle keys retired in "
          f"{facts['purge_ms']:.1f} ms, {facts['reused']} of their ids taken by "
          f"the {len(first_new)} new keys of the next batch; every new key's first "
          f"n and volumes == 1 and totalVolume == its volume; the kept keys' "
          f"{int((~new_rows).sum())} rows == an unpurged run [{card}]", flush=True)
    return facts
def event_rows():
    """A stream callback keeping every event as (timestamp, data, expired)."""
    from siddhi_tpu_torch import StreamCallback

    class Rows(StreamCallback):
        def __init__(self):
            self.rows = []

        def receive(self, events):
            self.rows.extend((e.timestamp, tuple(e.data), e.is_expired)
                             for e in events)

    return Rows()


def require_rows_equal(a, b, what: str):
    """Event rows equal: floats to rtol 1e-12, everything else exactly."""
    import math

    _require(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} rows")
    for i, (x, y) in enumerate(zip(a, b)):
        ok = x[0] == y[0] and x[2] == y[2] and len(x[1]) == len(y[1]) and all(
            (u is None and v is None) or (
                isinstance(u, float) and isinstance(v, float)
                and math.isclose(u, v, rel_tol=FLOAT_RTOL, abs_tol=0.0))
            or u == v for u, v in zip(x[1], y[1]))
        _require(ok, f"{what}: row {i} differs: {x} vs {y}")


# ------------------------------------------------------------- patterns

NFA_KEYS = 10_000              # config #4: 10k partition keys (bench.py NUM_KEYS)
NFA_KEY_SLOTS = 16_384         # bench_nfa_p99 pre-sizes the key space
NFA_SLOTS = 8                  # siddhi_tpu.nfa_slots, as bench_nfa_p99 sets it
NFA_DEPTH = 2                  # siddhi_tpu.pipeline_depth, as bench_nfa_p99
NFA_B_LAT = 1_024              # the latency operating point
NFA_B_THR = 4_096              # the throughput operating point
NFA_LAT_PAIRS = 120
NFA_THR_PAIRS = 60
NFA_STEP_MS = 10
NFA_T0 = 10_000
NFA_CPU_PAIRS = 2
NX_PAIRS = 24
NX_STEP_MS = 2_000             # at 1 s a pair a key holds up to 11 pendings
NX_OVERFLOW_STEP_MS = 1_000    # ... and the run must raise the slot overflow
NX_LATE_AFTER = 12             # the out-of-order A batch follows this pair
NX_LATE_MS = 1_500             # ... stamped this far below the clock
NS_PAIRS = 8
NA_CPU_LIMIT_S = 20.0
NFA_CUT_KEYS = 64
NFA_CUT_ROWS = 1_024
NFA_CUT_PAIRS = 2
NFA_PROFILE_PAIRS = 8

NFA_APP = """@app:playback
define stream AStream (k string, v double);
define stream BStream (k string, v double);
{purge}partition with (k of AStream, k of BStream)
begin
  @info(name = 'nfa')
  from {pattern}
  select {select}
  insert into MatchStream;
end;
"""
N_PATTERN = "every e1=AStream -> e2=BStream[e2.v > e1.v] within 5 sec"
N_SELECT = "e1.k as k, e1.v as v1, e2.v as v2"
NFA_CUT_SHAPES = {
    "count": ("e1=AStream<2:5> -> e2=BStream",
              "e1[0].v as first, e1[last].v as last, e2.v as v2"),
    "logical": ("e1=AStream and e2=BStream -> e3=AStream",
                "e1.v as a, e2.v as b, e3.v as c"),
    "mid_every": ("every (e1=AStream -> e2=BStream) within 1 sec",
                  "e1.k as k, e1.v as a, e2.v as b"),
    "group_sum": ("every e1=AStream -> e2=BStream[e2.v > e1.v] within 1 sec",
                  "e1.k as k, sum(e2.v) as total, count() as n group by e1.k"),
}
NFA_ASYNC_APP = """@app:playback
{ann}define stream S (src string, k string, v double);
partition with (k of S)
begin
  @info(name = 'nfa')
  from every e1=S[src == 'A'] -> e2=S[src == 'B' and v > e1.v] within 2 sec
  select e1.k as k, e1.v as v1, e2.v as v2
  insert into MatchStream;
end;
"""


def nfa_app(pattern: str, select: str, purge: bool = False) -> str:
    return NFA_APP.format(pattern=pattern, select=select, purge=(
        "@purge(enable='true', interval='1 hour', idle.period='1 hour')\n"
        if purge else ""))


def nfa_warm_feed():
    """bench_nfa_p99's warm-up: at each batch size, batches of keys in
    order (K0, K1, ...) arm at v = 0 and match at v = 1 (12,288 keys)."""
    import numpy as np

    feed = []
    for B in (NFA_B_LAT, NFA_B_THR):
        for c0 in range(0, NFA_KEYS, B):
            keys = np.array([f"K{i}" for i in range(c0, c0 + B)], dtype=object)
            ts = np.full(B, 1_000, np.int64)
            feed.append(("AStream", {"k": keys, "v": np.zeros(B)}, ts))
            feed.append(("BStream", {"k": keys, "v": np.ones(B)}, ts + 1))
    return feed


def nfa_feed(seed: int, B: int, pairs: int, t0: int, step_ms: int,
             independent: bool, n_keys: int = NFA_KEYS, late_after=None):
    """Pairs of an A batch then a B batch (``bench_nfa_p99``: the same
    keys and ``v + 1``; ``independent``: B's keys and values drawn anew),
    the clock ``step_ms`` further a pair. ``late_after``: one more A batch
    after that pair, stamped ``NX_LATE_MS`` below the clock."""
    import numpy as np

    rng = np.random.default_rng(seed)
    names = np.array([f"K{i}" for i in range(n_keys)], dtype=object)
    feed, t = [], t0
    for p in range(pairs):
        ids = rng.integers(0, n_keys, B)
        va = rng.random(B) * 100.0
        ts = np.full(B, t, np.int64)
        feed.append(("AStream", {"k": names[ids], "v": va}, ts))
        if independent:
            feed.append(("BStream", {"k": names[rng.integers(0, n_keys, B)],
                                     "v": rng.random(B) * 100.0}, ts + 1))
        else:
            feed.append(("BStream", {"k": names[ids], "v": va + 1.0}, ts + 1))
        if late_after is not None and p == late_after:
            feed.append(("AStream", {"k": names[rng.integers(0, n_keys, B)],
                                     "v": rng.random(B) * 100.0},
                         np.full(B, t - NX_LATE_MS, np.int64)))
        t += step_ms
    return feed


def pattern_oracle(feed, within_ms: int, slots=None):
    """A per-key Python model of ``every e1=A -> e2=B[e2.v > e1.v] within
    w``: each A row arms a pending (v1, ts); a B row matches, in arrival
    order, every live pending of its key with v2 > v1 and consumes it; a
    pending dies once its key's clock (the highest timestamp seen on
    either stream, as the engine's per-key expiry) passes ts + w. Returns
    (matches as (key, v1, v2, ts), the most live pendings a key held);
    with ``slots``, the index of the first feed item that makes a key hold
    more than ``slots`` pendings instead (None if none does)."""
    pend, hwm, matches, most = {}, {}, [], 0
    for i, (stream, cols, ts) in enumerate(feed):
        is_a = stream == "AStream"
        for k, v, t in zip(cols["k"].tolist(), cols["v"].tolist(), ts.tolist()):
            h = max(hwm.get(k, t), t)
            hwm[k] = h
            live = [p for p in pend.get(k, ()) if p[1] + within_ms >= h]
            if is_a:
                live.append((v, t))
                most = max(most, len(live))
                if slots is not None and most > slots:
                    return i
            else:
                keep = []
                for p in live:
                    if v > p[0]:
                        matches.append((k, p[0], v, t))
                    else:
                        keep.append(p)
                live = keep
            pend[k] = live
    return None if slots is not None else (matches, most)


def nfa_rows(batches, strings):
    """(key, v1, v2, ts) of a columnar collector's match batches."""
    import numpy as np

    out = []
    for b in batches:
        keys = np.asarray(strings, dtype=object)[b["k"]] if len(b["k"]) else []
        out.extend(zip(list(keys), b["v1"].tolist(), b["v2"].tolist(),
                       b["__ts__"].tolist()))
    return out


def run_nfa(device, app: str, feed, *, slots=None, fast: bool = True,
            depth=None, warm=(), key_slots=-1,
            profile_tail: int = 0, card: str = "", label: str = "",
            keep=None, events: bool = False):
    """Drive a pattern app through the public API on ``device``: the
    ``warm`` feed first (not timed), then ``feed`` with each send pair
    timed (the card synchronised before the clock stops). The last
    ``profile_tail`` sends run under torch.profiler (the device's busy
    share). Defaults: ``NFA_SLOTS`` match slots, depth ``NFA_DEPTH``,
    ``NFA_KEY_SLOTS`` key slots (None: the runtime's own growth). Returns
    (collector, per-send seconds, facts)."""
    import torch

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    slots = NFA_SLOTS if slots is None else slots
    depth = NFA_DEPTH if depth is None else depth
    key_slots = NFA_KEY_SLOTS if key_slots == -1 else key_slots

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager({
        "siddhi_tpu.nfa_slots": str(slots),
        "siddhi_tpu.pipeline_depth": str(depth)}))
    rt = m.create_siddhi_app_runtime(app)
    cb = event_rows() if events else collector()
    rt.add_callback("MatchStream", cb)
    q = rt.query_runtimes["nfa"]
    if key_slots is not None:
        q._win_keys = key_slots
        q.selector_plan.num_keys = key_slots
    stage = q.stage
    stage.fast_enabled = fast
    hs = {s: rt.get_input_handler(s) for s in ("AStream", "BStream")}
    try:
        for stream, cols, ts in warm:
            hs[stream].send_columns(cols, timestamps=ts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        warm_out = len(cb.rows) if events else len(cb.batches)
        for k in ("fast_steps", "generic_steps", "generic_rounds", "timer_steps"):
            setattr(stage, k, 0)
        seconds = []
        main = feed[:len(feed) - profile_tail]
        for stream, cols, ts in main:
            t0 = time.perf_counter()
            hs[stream].send_columns(cols, timestamps=ts)
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        facts = {"warm_out": warm_out,
                 "timed_events": sum(len(c["k"]) for _s, c, _t in main),
                 "steps": {k: getattr(stage, k) for k in (
                     "fast_steps", "generic_steps", "generic_rounds", "timer_steps")}}
        if profile_tail:
            tail = feed[len(feed) - profile_tail:]

            def send_tail():
                for stream, cols, ts in tail:
                    hs[stream].send_columns(cols, timestamps=ts)

            facts["profile"] = profile_block(f"{label} last {profile_tail} sends",
                                             send_tail, card)
        if keep is not None:
            keep(rt, hs)
        facts["state_bytes"] = sum(t.numel() * t.element_size()
                                   for t in _leaves(q._state))
        facts["nfa_state_bytes"] = sum(t.numel() * t.element_size()
                                       for t in _leaves(q._state["nfa"]))
        facts["key_slots"] = q._win_keys
        facts["nfa_overflow"] = int(q._state["nfa"]["nfa_overflow"])
        facts["strings"] = list(rt.app_context.string_dictionary._to_str)
    finally:
        m.shutdown()
    return cb, seconds, facts


def profile_block(label: str, fn, card: str, top: int = 8, tag: str = "patterns"):
    """torch.profiler over ``fn``: wall, the card's busy time (device
    kernels and copies) and share, and the top device ops, printed under
    ``[tag]``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    _require(dev_us > 0, f"profile {label}: no device time seen")
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    launches = sum(e.count for e in kernels)
    print(f"[{tag}] profile {label}: wall {wall * 1e3:.2f} ms, device busy "
          f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e6 / wall:.1f}% of wall), "
          f"{launches} device kernels and copies [{card}]", flush=True)
    for e in kernels[:top]:
        print(f"[{tag}]   {label}: {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}", flush=True)
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "busy_share": dev_us / 1e6 / wall, "device_launches": launches}


def host_profile(label: str, fn, card: str, top: int = 8):
    """cProfile over ``fn`` (the card synchronised at its end): the host's
    wall and the functions with the most self time."""
    import cProfile
    import pstats

    import torch

    torch.cuda.synchronize()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    wall = time.perf_counter() - t0
    st = pstats.Stats(pr)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    out = []
    print(f"[patterns] host {label}: wall {wall * 1e3:.2f} ms under cProfile "
          f"[{card}]", flush=True)
    for (path, line, fname), (_cc, nc, tt, ct, _callers) in rows:
        where = f"{Path(path).name}:{line}({fname})"
        out.append((where, nc, tt * 1e3, ct * 1e3))
        print(f"[patterns]   host {label}: self {tt * 1e3:7.3f} ms, cum "
              f"{ct * 1e3:7.3f} ms, {nc:5d} calls  {where}", flush=True)
    return out


def nfa_pair_stats(seconds, B: int):
    """bench_nfa_p99's numbers from per-send seconds of A/B pairs: the p99
    of per-batch latency (a pair's time over two) and events/s."""
    import numpy as np

    pair = np.asarray(seconds[0::2]) + np.asarray(seconds[1::2])
    lat = np.sort(pair * 1e3 / 2)
    p99 = float(lat[min(len(lat) - 1, int(len(lat) * 0.99))])
    return p99, 2 * B * len(pair) / float(pair.sum())


def sorted_rows(rows):
    return sorted(rows, key=lambda r: (r[0], r[3], r[1], r[2]))


def phase_patterns(device, card: str):
    """Phase 19 (see the module doc): N, NX, NS and NA at config #4's width
    with their checks, the cut shapes against the CPU, @Async and @purge.
    Returns the ``{"patterns": ...}`` facts."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    res = {"card": card, "reduced": [
        f"N: {NFA_LAT_PAIRS} pairs at B = {NFA_B_LAT} and {NFA_THR_PAIRS} at "
        f"B = {NFA_B_THR} in place of bench_nfa_p99's MEASURE_SECONDS of each, "
        f"no settle segment",
        f"NX: {NX_PAIRS} pairs", f"NS, NA: {NS_PAIRS} pairs of NX's feed",
        f"cut shapes: {NFA_CUT_KEYS} keys, {NFA_CUT_PAIRS} x {NFA_CUT_ROWS} rows "
        f"a stream"]}
    n_app = nfa_app(N_PATTERN, N_SELECT)

    def steps_text(f):
        st = f["steps"]
        k5 = st["generic_steps"]
        return (f"K4 steps {st['fast_steps']}, K5 steps {k5} ({st['generic_rounds']} "
                f"rounds, {st['generic_rounds'] / max(k5, 1):.2f} a step), TIMER "
                f"steps {st['timer_steps']}")

    def cell(name, f, secs, extra):
        _require(f["nfa_overflow"] == 0, f"{name}: nfa_overflow {f['nfa_overflow']}")
        res[name] = {
            "events_per_s": extra.get("eps", f["timed_events"] / sum(secs)),
            "state_bytes": f["state_bytes"], "nfa_overflow": f["nfa_overflow"],
            "nfa_state_bytes": f["nfa_state_bytes"], "key_slots": f["key_slots"],
            "slots": NFA_SLOTS, **f["steps"],
            "k5_rounds_per_step": f["steps"]["generic_rounds"] / max(
                f["steps"]["generic_steps"], 1),
            "busy_share": f["profile"]["busy_share"] if "profile" in f else None,
            **{k: v for k, v in extra.items() if k != "eps"}}
        return res[name]

    # ---- N: bench_nfa_p99's feed, both operating points in one run
    warm = nfa_warm_feed()
    lat_feed = nfa_feed(41, NFA_B_LAT, NFA_LAT_PAIRS, NFA_T0, NFA_STEP_MS, False)
    t_thr = NFA_T0 + NFA_LAT_PAIRS * NFA_STEP_MS
    thr_feed = nfa_feed(42, NFA_B_THR, NFA_THR_PAIRS, t_thr, NFA_STEP_MS, False)
    cb_n, secs_n, fn = run_nfa(device, n_app, lat_feed + thr_feed, warm=warm,
                               profile_tail=2 * NFA_PROFILE_PAIRS, card=card,
                               label="N (B = 4,096)")
    n_lat = 2 * NFA_LAT_PAIRS
    p99, _eps_l = nfa_pair_stats(secs_n[:n_lat], NFA_B_LAT)
    _p99_t, eps = nfa_pair_stats(secs_n[n_lat:], NFA_B_THR)
    want, most = pattern_oracle(warm + lat_feed + thr_feed, 5_000)
    got = nfa_rows(cb_n.batches, fn["strings"])
    _require(len(got) == len(want), f"N: {len(got)} matches, the per-key oracle "
             f"{len(want)}")
    _require(sorted_rows(got) == sorted_rows(want), "N: the matches differ from the "
             "per-key oracle")
    _require(fn["steps"]["generic_steps"] == 0,
             f"N: {fn['steps']['generic_steps']} K5 fallbacks, want every step on K4")
    _require(most <= NFA_SLOTS, f"N: the oracle holds {most} pendings a key")
    # the first pairs against the port's CPU run (the same warm-up first)
    cb_c, _s, fc = run_nfa(cpu, n_app, lat_feed[:2 * NFA_CPU_PAIRS], warm=warm,
                           depth=1)
    n_c = len(cb_c.batches) - fc["warm_out"]
    compare_outputs(cb_n.batches[fn["warm_out"]:fn["warm_out"] + n_c],
                    cb_c.batches[fc["warm_out"]:],
                    f"N: card vs cpu (first {NFA_CPU_PAIRS} pairs)")
    c = cell("N", fn, secs_n, {"eps": eps, "p99_batch_ms_b1024": p99,
                               "events_per_s_b4096": eps, "matches": len(want),
                               "most_pending_per_key": most})
    print(f"[patterns] N (config #4: {NFA_KEYS} keys in {fn['key_slots']} key "
          f"slots, {NFA_SLOTS} match slots, depth {NFA_DEPTH}): p99 per-batch "
          f"latency {p99:.3f} ms at B = {NFA_B_LAT} ({NFA_LAT_PAIRS} pairs), "
          f"{eps:.1f} events/s at B = {NFA_B_THR} ({NFA_THR_PAIRS} pairs, the "
          f"last {NFA_PROFILE_PAIRS} profiled apart); {steps_text(fn)}; "
          f"nfa_overflow 0; {len(want)} matches == the per-key oracle (most "
          f"{most} pendings a key); the first {NFA_CPU_PAIRS} pairs == the CPU "
          f"run; state {fn['state_bytes']} bytes ([K, S] "
          f"{fn['nfa_state_bytes']}); busy {100 * c['busy_share']:.1f}% [{card}]",
          flush=True)

    # ---- NX: expiry and the generic engine at full width
    nx_feed = nfa_feed(43, NFA_B_THR, NX_PAIRS, NFA_T0, NX_STEP_MS, True,
                       late_after=NX_LATE_AFTER)
    cb_x, secs_x, fx = run_nfa(device, n_app, nx_feed, warm=warm,
                               profile_tail=2 * 2, card=card, label="NX K4")
    cb_g, secs_g, fg = run_nfa(device, n_app, nx_feed, warm=warm, fast=False,
                               profile_tail=2 * 2, card=card, label="NX K5 only")
    want_x, most_x = pattern_oracle(warm + nx_feed, 5_000)
    got_x = nfa_rows(cb_x.batches, fx["strings"])
    _require(sorted_rows(got_x) == sorted_rows(want_x),
             f"NX: {len(got_x)} matches differ from the per-key oracle's "
             f"{len(want_x)}")
    compare_outputs(cb_x.batches, cb_g.batches, "NX: K4 run vs K5-only run")
    _require(fx["steps"]["generic_steps"] >= 1, "NX: the out-of-order batch did "
             "not force a K5 fallback")
    _require(most_x <= NFA_SLOTS, f"NX: the oracle holds {most_x} pendings a key")
    c = cell("NX", fx, secs_x, {"matches": len(want_x),
                                "most_pending_per_key": most_x,
                                "k5_only": {**fg["steps"],
                                            "events_per_s": fg["timed_events"]
                                            / sum(secs_g),
                                            "busy_share": fg["profile"]["busy_share"]}})
    print(f"[patterns] NX ({NX_PAIRS} pairs of {NFA_B_THR}, B drawn anew, "
          f"{NX_STEP_MS} ms a pair, one A batch {NX_LATE_MS} ms late): "
          f"{c['events_per_s']:.1f} events/s, {steps_text(fx)}; the K5-only run "
          f"{c['k5_only']['events_per_s']:.1f} events/s, {steps_text(fg)}; "
          f"{len(want_x)} matches == the oracle as a multiset, K4 run == K5-only "
          f"run row for row; most {most_x} pendings a key ({NFA_SLOTS} slots); "
          f"busy {100 * c['busy_share']:.1f}% (K5 only "
          f"{100 * c['k5_only']['busy_share']:.1f}%) [{card}]", flush=True)

    # at 1 s a pair the feed outgrows 8 slots: the run must raise the slot
    # overflow at the send where the oracle first holds a 9th pending
    ov_feed = nfa_feed(43, NFA_B_THR, NX_PAIRS, NFA_T0, NX_OVERFLOW_STEP_MS, True,
                       late_after=NX_LATE_AFTER)
    from siddhi_tpu_torch.core.stream.junction import FatalQueryError

    warm_n = len(warm)
    at = pattern_oracle(warm + ov_feed, 5_000, slots=NFA_SLOTS)
    _require(at is not None and at >= warm_n, "NX overflow: the oracle never "
             f"outgrows {NFA_SLOTS} slots at {NX_OVERFLOW_STEP_MS} ms a pair")
    raised = []
    try:
        run_nfa(device, n_app, ov_feed[:at - warm_n + 1], warm=warm)
    except FatalQueryError as e:
        raised.append(str(e))
    _require(raised and "nfa_slots" in raised[0], "NX overflow: no slot overflow "
             f"raised by send {at - warm_n} of the {NX_OVERFLOW_STEP_MS} ms feed")
    try:
        run_nfa(device, n_app, ov_feed[:at - warm_n], warm=warm)
    except FatalQueryError as e:
        raise Failure(f"NX overflow: raised before the oracle's send: {e}")
    res["NX"]["overflow_at_1s_a_pair"] = {"send": at - warm_n, "pairs": NX_PAIRS}
    print(f"[patterns] NX at {NX_OVERFLOW_STEP_MS} ms a pair: the oracle first "
          f"holds {NFA_SLOTS + 1} pendings a key at send {at - warm_n}; the run "
          f"raises the slot overflow (naming nfa_slots) there and not before "
          f"[{card}]", flush=True)

    # one K4 step and one K5 step under the profiler, and their host syncs
    def one_step(fast, label):
        from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

        m = SiddhiManager(device=device)
        m.set_config_manager(InMemoryConfigManager({
            "siddhi_tpu.nfa_slots": str(NFA_SLOTS), "siddhi_tpu.pipeline_depth": "1"}))
        rt = m.create_siddhi_app_runtime(n_app)
        rt.add_callback("MatchStream", collector())
        q = rt.query_runtimes["nfa"]
        q._win_keys = q.selector_plan.num_keys = NFA_KEY_SLOTS
        q.stage.fast_enabled = fast
        hs = {s: rt.get_input_handler(s) for s in ("AStream", "BStream")}
        for stream, cols, ts in warm + nx_feed[:7]:
            hs[stream].send_columns(cols, timestamps=ts)
        stream, cols, ts = nx_feed[7]         # pair 3's B batch
        prof = profile_block(label, lambda: hs[stream].send_columns(
            cols, timestamps=ts), card)
        stream, cols, ts = nx_feed[8]
        hs[stream].send_columns(cols, timestamps=ts)
        sync = {}
        stream, cols, ts = nx_feed[9]
        with counting_syncs(sync):
            hs[stream].send_columns(cols, timestamps=ts)
        stream, cols, ts = nx_feed[10]
        hs[stream].send_columns(cols, timestamps=ts)
        stream, cols, ts = nx_feed[11]
        prof["host_top"] = host_profile(label, lambda: hs[stream].send_columns(
            cols, timestamps=ts), card)
        m.shutdown()
        prof["host_syncs"] = sync["syncs"]
        prof["sync_sites"] = sync["sync_sites"]
        print(f"[patterns] {label}: {sync['syncs']} host syncs in one step "
              f"(sites {sync['sync_sites']})", flush=True)
        return prof

    res["step_profile"] = {"K4": one_step(True, "one K4 step (B batch, 4,096 rows)"),
                           "K5": one_step(False, "one K5 step (B batch, 4,096 rows)")}

    # ---- NS (a sequence) and NA (an absent pattern) over NX's feed
    ns_feed = nx_feed[:2 * NS_PAIRS]
    for name, pattern, select in (
            ("NS", "e1=AStream, e2=BStream[e2.v > e1.v]", N_SELECT),
            ("NA", "every e1=AStream -> not BStream[v > e1.v] for 1 sec",
             "e1.k as k, e1.v as v1")):
        app = nfa_app(pattern, select)
        cb_d, secs_d, fd = run_nfa(device, app, ns_feed, events=True,
                                   profile_tail=4, card=card, label=name)
        t0 = time.perf_counter()
        cut = ns_feed
        cb_h, _s, fh = run_nfa(cpu, app, cut, depth=1, events=True)
        cpu_s = time.perf_counter() - t0
        if cpu_s > NA_CPU_LIMIT_S:
            cut = ns_feed[:8]
            cb_h, _s, fh = run_nfa(cpu, app, cut, depth=1, events=True)
            res.setdefault("reduced", []).append(
                f"{name}: the CPU comparison over the first 4 pairs")
        n_cmp = len(cb_h.rows)
        require_rows_equal(cb_d.rows[:n_cmp], cb_h.rows, f"{name}: card vs cpu")
        if cut is ns_feed:
            _require(len(cb_d.rows) == n_cmp, f"{name}: {len(cb_d.rows)} rows on "
                     f"the card, {n_cmp} on the CPU")
        _require(n_cmp > 0, f"{name}: no rows")
        c = cell(name, fd, secs_d, {"matches": len(cb_d.rows), "cpu_s": cpu_s})
        print(f"[patterns] {name} ({pattern}; {NS_PAIRS} pairs of NX's feed): "
              f"{c['events_per_s']:.1f} events/s, {steps_text(fd)}; "
              f"{c['matches']} rows == the CPU run ({cpu_s:.1f} s there); "
              f"state {fd['state_bytes']} bytes; busy {100 * c['busy_share']:.1f}% "
              f"[{card}]", flush=True)
    _require(res["NA"]["timer_steps"] > 0, "NA: no TIMER step fired")

    # ---- the cut shapes against the CPU
    cut_feed = nfa_feed(44, NFA_CUT_ROWS, NFA_CUT_PAIRS, NFA_T0, 1_500, True,
                        n_keys=NFA_CUT_KEYS)
    for i, (_s, _c, ts) in enumerate(cut_feed):
        ts += np.arange(NFA_CUT_ROWS, dtype=np.int64) // 64   # rows creep in time
    cuts = {}
    for name, (pattern, select) in NFA_CUT_SHAPES.items():
        app = nfa_app(pattern, select)
        outs = [run_nfa(dev, app, cut_feed, slots=32, depth=1, key_slots=None,
                        events=True)[0].rows for dev in (device, cpu)]
        require_rows_equal(outs[0], outs[1], f"cut {name}: card vs cpu")
        _require(len(outs[0]) > 0, f"cut {name}: no rows")
        cuts[name] = len(outs[0])
    # a pattern behind @Async at depth 4 == the synchronous run
    rng = np.random.default_rng(45)
    s_feed = []
    for i in range(8):
        n = NFA_CUT_ROWS
        s_feed.append(({"src": np.array(["A", "B"], object)[rng.integers(0, 2, n)],
                        "k": np.array([f"K{j}" for j in range(NFA_CUT_KEYS)],
                                      object)[rng.integers(0, NFA_CUT_KEYS, n)],
                        "v": rng.random(n) * 100.0},
                       np.full(n, NFA_T0 + 700 * i, np.int64)))
    async_rows = {}
    for depth, ann in ((1, ""), (4, "@Async(buffer.size='64', batch.size='1024')\n")):
        from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

        m = SiddhiManager(device=device)
        m.set_config_manager(InMemoryConfigManager({
            "siddhi_tpu.nfa_slots": "32", "siddhi_tpu.pipeline_depth": str(depth)}))
        rt = m.create_siddhi_app_runtime(NFA_ASYNC_APP.format(ann=ann))
        cb = event_rows()
        rt.add_callback("MatchStream", cb)
        h = rt.get_input_handler("S")
        for cols, ts in s_feed:
            h.send_columns(cols, timestamps=ts)
        m.shutdown()
        async_rows[depth] = cb.rows
    require_rows_equal(async_rows[4], async_rows[1], "cut @Async depth 4 vs sync")
    _require(len(async_rows[1]) > 0, "cut @Async: no rows")
    cuts["async_depth4"] = len(async_rows[1])

    # @purge: half the keys retired, their ids taken by new keys that start
    # with no pending match
    a_only = cut_feed[:1]
    seen = set(a_only[0][1]["k"].tolist())
    retire = [k for k in (f"K{i}" for i in range(NFA_CUT_KEYS // 2)) if k in seen]
    kept = seen - set(retire)

    def purge_half(rt, hs):
        pctx = rt.partition_contexts[0]
        enc = rt.app_context.string_dictionary.encode
        ks = pctx.keyspace
        idle = sorted(ks._map[(enc(k),)] for k in retire)
        for i in idle:
            ks.last_seen[i] = int(time.time() * 1000) - 2 * 3600_000
        freed = sorted(pctx.purge())
        _require(freed == idle, "cut purge: other ids retired than the idle keys'")
        new = [f"N{i}" for i in range(len(retire))]
        names = np.array(new + sorted(kept), dtype=object)
        hs["BStream"].send_columns({"k": names, "v": np.full(len(names), 1e9)},
                                   timestamps=np.full(len(names), NFA_T0 + 2,
                                                      np.int64))
        new_ids = sorted(ks._map[(enc(k),)] for k in new)
        _require(new_ids == freed, "cut purge: the new keys did not take the freed ids")

    cb_p, _s, _f = run_nfa(device, nfa_app(N_PATTERN, N_SELECT, purge=True), a_only,
                           slots=32, depth=1, key_slots=None, keep=purge_half,
                           events=True)
    want_p = sum(1 for k in a_only[0][1]["k"] if k in kept)
    _require({r[1][0] for r in cb_p.rows} <= kept and len(cb_p.rows) == want_p,
             f"cut purge: {len(cb_p.rows)} matches, want {want_p}, all of kept keys")
    cuts["purge_matches"] = len(cb_p.rows)
    res["cuts"] = cuts
    print(f"[patterns] cut shapes ({NFA_CUT_KEYS} keys, {NFA_CUT_PAIRS} x "
          f"{NFA_CUT_ROWS} rows a stream) == the CPU: {cuts}; @Async at depth 4 "
          f"== the sync run; @purge: {len(retire)} keys retired, their ids "
          f"reused by new keys with no pending match [{card}]", flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[patterns] phase 19 in {res['phase_s']:.1f} s", flush=True)
    return res


# ------------------------------------------------------------------ main

# ----------------------------------------------------------------- joins

J5_APP = """@app:playback
define stream StockStream (symbol string, price double, volume long);
define stream TwitterStream (user string, company string);
@info(name = 'j5')
from StockStream#window.time(10 sec) join TwitterStream#window.length(100)
on StockStream.symbol == TwitterStream.company
select StockStream.symbol as symbol, TwitterStream.user as user, price
insert into JoinOut;
"""
J5_CAPACITY = 262_144           # 200,000 rows live in 10 s at 20 events/ms
J5_PAIRS = 112                  # Stock batches, each followed by a Twitter one:
                                # 109 latency samples a side, so p99 is not the max
J5_TWEETS = 256
J5_WINDOW_MS = 10_000           # the app's time(10 sec)
J5_TWITTER_WINDOW = 100         # the app's length(100)
J5_STATE_EVERY = 8              # pairs between cross-checks of the window state
J5_USERS = 1_000
J5_LEGACY_PAIRS = 4
J5_CUT_SYMBOLS = 64
J5_CUT_PAIRS = 2
J5_MEMORY_LIMIT = 40 * 2 ** 30
JB_APP = """
define stream L (sym string, lv long);
define stream R (sym string, rv long);
@info(name = 'jb') from L#window.length({W}) join R#window.length({W})
  on L.sym == R.sym
  select L.sym as sym, L.lv as lv, R.rv as rv insert into JoinOut;
"""
JB_WINDOW = 2_048               # bench.py bench_join's defaults
JB_BATCH = 2_048
JB_KEYS = 512
JB_SENDS = 256                  # timed batches a point: over 1 s at every point
TJ_APP = """@app:playback
@primaryKey('symbol')
define table SymbolTable (symbol string, sector string, cap double);
define stream SymbolFeed (symbol string, sector string, cap double);
define stream StockStream (symbol string, price double, volume long);
from SymbolFeed select symbol, sector, cap
update or insert into SymbolTable on SymbolTable.symbol == symbol;
@info(name = 'tj') from StockStream join SymbolTable
on StockStream.symbol == SymbolTable.symbol
select StockStream.symbol as symbol, SymbolTable.sector as sector, price
insert into Enriched;
@info(name = 'tin') from StockStream[(symbol == SymbolTable.symbol) in SymbolTable]
select symbol, price insert into Known;
"""
TJ_ROWS = 10_000                # S0, S2, ..., S19998: half the feed's symbols
TJ_SECTORS = 11
TJ_BATCHES = 4
TJ_WALK_ROWS = 1_000            # the fill walked one event at a time, at a cut
STORE_APP = """@app:playback
define stream S (k string, v double);
define stream R (k string, v double);
define window W (k string, v double) length(8);
@primaryKey('k') define table T (k string, v double);
define trigger Start at 'start';
define trigger Tick at every 500 millisec;
from R insert into W;
from S select k, v update or insert into T on T.k == k;
@info(name = 'wj') from S#window.length(16) join W on S.k == W.k
select S.k as k, S.v as sv, W.v as wv insert into WJ;
from Start select triggered_time as t insert into Starts;
from Tick select triggered_time as t insert into Ticks;
"""
STORE_QUERIES = [
    "from T on v > 50.0 select k, v",
    "select 1.5 as nv update T set T.v = nv on T.k == 'K3'",
    "select 10.0 as lim delete T on T.v < lim",
    "from T select k, v order by k",
    "from W select k, v",
]


def j5_feed(seed: int, pairs: int, n_symbols: int = 0):
    """Phase 17's StockStream feed (``tw_feed``) with a 256-row
    TwitterStream batch after each Stock batch, stamped at that batch's
    last timestamp: ``company`` from the same symbols, ``user`` from 1,000
    strings. Returns (items (stream, columns, timestamps), and for each
    item its symbol ids: ``symbol``'s of a Stock batch, ``company``'s of a
    Twitter batch)."""
    import numpy as np

    n_symbols = n_symbols or NUM_SYMBOLS
    stock, stock_ids = tw_feed(seed, pairs, n_symbols=n_symbols)
    rng = np.random.default_rng(seed + 1)
    syms = np.array([f"S{i}" for i in range(n_symbols)], dtype=object)
    users = np.array([f"U{i}" for i in range(J5_USERS)], dtype=object)
    feed, ids = [], []
    for i, (cols, ts) in enumerate(stock):
        feed.append(("StockStream", {k: v for k, v in cols.items() if k != "ts"}, ts))
        ids.append(stock_ids[i * BATCH: (i + 1) * BATCH])
        company = rng.integers(0, n_symbols, J5_TWEETS)
        feed.append(("TwitterStream", {
            "user": users[rng.integers(0, J5_USERS, J5_TWEETS)],
            "company": syms[company]},
            np.full(J5_TWEETS, int(ts[-1]), np.int64)))
        ids.append(company)
    return feed, ids


class J5Oracle:
    """Config #5's join from the feed alone: the Stock rows of the last
    10 s of event time (``(now - 10 s, now]``) and the last 100 Twitter
    rows, each send's rows a numpy hash join of its batch with the other
    side's live set (symbol ids, then decoded)."""

    def __init__(self, n_symbols: int):
        import numpy as np

        self.syms = [f"S{i}" for i in range(n_symbols)]
        self.stock = []         # (symbol ids, prices, timestamps) per batch
        self.users = np.empty(0, object)
        self.company = np.empty(0, np.int64)

    def live_stock(self, now: int):
        """(symbol ids, prices) of the Stock rows live at ``now``."""
        import numpy as np

        ids, price, ts = (np.concatenate(c) for c in zip(*self.stock))
        live = ts > now - J5_WINDOW_MS
        return ids[live], price[live]

    def join(self, stock_ids, price, users, company):
        """The sorted multiset of (symbol, user, price) of Stock rows
        joined with Twitter rows on symbol == company."""
        import numpy as np

        by_company = {}
        for u, c in zip(users.tolist(), company.tolist()):
            by_company.setdefault(c, []).append(u)
        hit = np.nonzero(np.isin(stock_ids, np.fromiter(by_company, np.int64)))[0]
        return sorted((self.syms[c], u, p)
                      for c, p in zip(stock_ids[hit].tolist(),
                                      price[hit].astype(np.float64).tolist())
                      for u in by_company[c])

    def send(self, stream: str, cols: dict, ts, ids):
        """The rows a send must emit; the send then joins the live sets."""
        import numpy as np

        if stream == "StockStream":
            price = np.asarray(cols["price"])
            want = self.join(ids, price, self.users, self.company)
            # batches wholly out of the window are dropped
            self.stock = [b for b in self.stock if b[2][-1] > ts[-1] - J5_WINDOW_MS]
            self.stock.append((ids, price, ts))
            return want
        want = ([] if not self.stock else
                self.join(*self.live_stock(int(ts[-1])), cols["user"], ids))
        self.users = np.concatenate([self.users, cols["user"]])[-J5_TWITTER_WINDOW:]
        self.company = np.concatenate([self.company, ids])[-J5_TWITTER_WINDOW:]
        return want


def check_live_state(q, oracle: J5Oracle, dictionary, now: int):
    """The cross-check of the port's own window state: each side's live
    rows (``contents()`` of its window stage, read to the host) equal the
    oracle's live sets as multisets."""
    import numpy as np

    def contents(side):
        st = q.sides[side]
        cols, valid = st.window_stage.contents(q._state["lwin" if side == "left" else "rwin"])
        valid = valid.cpu().numpy()
        return {a.name: cols[a.name].cpu().numpy()[valid] for a in st.definition.attributes}

    def same(a, b):
        oa, ob = np.lexsort(a[::-1]), np.lexsort(b[::-1])
        return all(np.array_equal(x[oa], y[ob]) for x, y in zip(a, b))

    dict_id = np.array([dictionary._to_id.get(s, -2) for s in oracle.syms], np.int64)
    stock, tweets = contents("left"), contents("right")
    ids, price = oracle.live_stock(now)
    _require(same((stock["symbol"].astype(np.int64), stock["price"].astype(np.float64)),
                  (dict_id[ids], price.astype(np.float64))),
             f"J5 at {now}: the Stock window holds {int(stock['symbol'].size)} rows, "
             f"the feed's last 10 s {int(ids.size)}")
    users = np.array([dictionary._to_id[u] for u in oracle.users.tolist()], np.int64)
    _require(same((tweets["company"].astype(np.int64), tweets["user"].astype(np.int64)),
                  (dict_id[oracle.company], users)),
             f"J5 at {now}: the Twitter window differs from the feed's last "
             f"{J5_TWITTER_WINDOW} rows")


def emitted_rows(batches, strings):
    rows = []
    for b in batches:
        rows.extend(zip(strings[b["symbol"]], strings[b["user"]],
                        b["price"].astype(float).tolist()))
    return rows


def run_j5(device, feed, card: str, config=None, oracle_ids=None, profile=False):
    """Drive J5 through the public API: each item through its stream's
    InputHandler, the card synchronised after each send. Given the feed's
    symbol ids (``oracle_ids``) each send's rows are held, as a multiset,
    against ``J5Oracle``'s join over live sets built from the feed alone,
    and every J5_STATE_EVERY-th pair the port's window state against
    those live sets. With ``profile`` the last pair's Stock and Twitter
    steps run under torch.profiler and the pair before under torch's sync
    debug mode. Returns the facts."""
    import numpy as np
    import torch

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    cuda = device.type == "cuda"
    m = SiddhiManager(device=device)
    knobs = {"window_capacity": J5_CAPACITY, **(config or {})}
    m.set_config_manager(InMemoryConfigManager(
        {f"siddhi_tpu.{k}": str(v) for k, v in knobs.items()}))
    rt = m.create_siddhi_app_runtime(J5_APP)
    q = rt.query_runtimes["j5"]
    cb = collector()
    rt.add_callback("JoinOut", cb)
    timers = {"n": 0}
    orig_timer = q._timer

    def counted_timer(side_key, ts):
        timers["n"] += 1
        return orig_timer(side_key, ts)

    q._timer = counted_timer
    dictionary = rt.app_context.string_dictionary
    handlers = {s: rt.get_input_handler(s) for s in ("StockStream", "TwitterStream")}
    oracle = None
    if oracle_ids is not None:
        oracle = J5Oracle(1 + max(int(i.max()) for i in oracle_ids))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    seconds = {"StockStream": [], "TwitterStream": []}
    per_send, syncs, profiles, state_checks = [], {}, {}, 0
    for i, (stream, cols, ts) in enumerate(feed):
        want = None if oracle is None else oracle.send(stream, cols, ts, oracle_ids[i])
        n0 = len(cb.batches)

        def send(stream=stream, cols=cols, ts=ts):
            handlers[stream].send_columns(cols, timestamps=ts)

        # the last pair runs under torch.profiler and the one before under
        # sync debug mode: both stay out of the latency samples
        last_pair = i >= len(feed) - 2
        if profile and cuda and last_pair:
            profiles[stream] = profile_block(f"J5 {stream} step", send, card,
                                             tag="joins")
        elif profile and cuda and len(feed) - 4 <= i < len(feed) - 2:
            out = {}
            with counting_syncs(out):
                send()
                torch.cuda.synchronize()
            syncs[stream] = out
        else:
            t0 = time.perf_counter()
            send()
            if cuda:
                torch.cuda.synchronize()
            seconds[stream].append(time.perf_counter() - t0)
        per_send.append(cb.batches[n0:])
        if want is not None:
            strings = np.array(dictionary._to_str, dtype=object)
            got = sorted(emitted_rows(cb.batches[n0:], strings))
            _require(got == want,
                     f"J5 send {i} ({stream}): {len(got)} rows, the numpy hash "
                     f"join over the feed's live sets gives {len(want)}")
            if (i // 2) % J5_STATE_EVERY == 0 and i % 2 == 1:
                check_live_state(q, oracle, dictionary, int(ts[-1]))
                state_checks += 1
    eng = q.engine
    facts = {
        "engine": None if eng is None else {
            "P": eng.P, "Wp": {k: p.Wp for k, p in eng.plans.items()},
            "partitioned": {k: p.use_pidx for k, p in eng.plans.items()}},
        "engine_reason": q.engine_reason,
        "seconds": seconds, "timer_steps": timers["n"],
        "state_bytes": sum(t.numel() * t.element_size() for t in _leaves(q._state)),
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
        "syncs": syncs, "profiles": profiles, "seq_breaks": q.seq_breaks,
        "state_checks": state_checks,
        "strings": np.array(dictionary._to_str, dtype=object),
    }
    m.shutdown()
    facts["rows"] = [emitted_rows(b, facts["strings"]) for b in per_send]
    return facts


def quantile_ms(seconds, p):
    import numpy as np

    return float(np.percentile(np.asarray(seconds) * 1e3, p))


def jb_run(device, mode: str, P: int, depth: int, mix: str):
    """bench.py ``bench_join``'s shape: L/R ``#window.length(2048)``, 512
    keys, 2,048-row batches. ``probe``: R filled to its window once, then
    L batches probe it; ``insert``: batches alternate sides. Two warm
    pairs, then JB_SENDS timed batches. Returns (the emitted columns,
    events/s, the timed seconds)."""
    import numpy as np
    import torch

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    rng = np.random.default_rng(23)
    syms = np.array([f"S{i}" for i in range(JB_KEYS)], dtype=object)

    def batch(i, side):
        ids = rng.integers(0, JB_KEYS, JB_BATCH, dtype=np.int64)
        return side, ({"sym": syms[ids],
                       ("lv" if side == "L" else "rv"):
                           rng.integers(0, 1000, JB_BATCH, dtype=np.int64)},
                      np.arange(i * JB_BATCH, (i + 1) * JB_BATCH, dtype=np.int64))

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager({
        "siddhi_tpu.join_engine": mode, "siddhi_tpu.join_partitions": str(P),
        "siddhi_tpu.pipeline_depth": str(depth),
        "siddhi_tpu.window_capacity": str(JB_WINDOW)}))
    rt = m.create_siddhi_app_runtime(JB_APP.format(W=JB_WINDOW))
    cb = collector()
    rt.add_callback("JoinOut", cb)
    h = {s: rt.get_input_handler(s) for s in ("L", "R")}
    warm = [batch(0, "R")] if mix == "probe" else []
    warm += [batch(1 + j, s) for j, s in enumerate(["L", "R", "L", "R"])]
    sides = ["L"] * JB_SENDS if mix == "probe" else ["L", "R"] * (JB_SENDS // 2)
    measured = [batch(5 + j, s) for j, s in enumerate(sides)]
    for side, (cols, ts) in warm:
        h[side].send_columns(cols, timestamps=ts)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for side, (cols, ts) in measured:
        h[side].send_columns(cols, timestamps=ts)
    rt.app_context.completion_pump.flush()
    if device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    engine = rt.query_runtimes["jb"].engine
    m.shutdown()
    _require(cb.rows, f"JB {mode} P={P} depth={depth} {mix}: no rows")
    _require((engine is not None) == (mode == "device"),
             f"JB {mode}: engine attached = {engine is not None}")
    cols = {k: np.concatenate([b[k] for b in cb.batches]) for k in ("sym", "lv", "rv")}
    return cols, JB_SENDS * JB_BATCH / secs, secs


def tj_fill(device, n_rows: int, chunk=None):
    """A TJ app whose symbol table takes ``n_rows`` rows (S0, S2, ...) by
    ``update or insert into`` in one send. ``chunk`` (None: the table's
    own) sets the table's ``insert_chunk``: 0 walks every event one at a
    time, as the reference does. Returns (manager, runtime, the send's
    seconds, the symbols, their sectors)."""
    import numpy as np
    import torch

    from siddhi_tpu_torch import SiddhiManager

    rng = np.random.default_rng(41)
    tsyms = np.array([f"S{2 * i}" for i in range(n_rows)], dtype=object)
    sectors = np.array([f"SEC{i % TJ_SECTORS}" for i in range(n_rows)], dtype=object)
    caps = rng.random(n_rows) * 1e9
    m = SiddhiManager(device=device)
    rt = m.create_siddhi_app_runtime(TJ_APP)
    table = rt.tables["SymbolTable"]
    if chunk is not None:
        table.insert_chunk = chunk
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt.get_input_handler("SymbolFeed").send_columns(
        {"symbol": tsyms, "sector": sectors, "cap": caps},
        timestamps=np.full(n_rows, TW_BASE - 1, np.int64))
    if device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _require(table.count == n_rows, f"TJ: the table holds {table.count} rows")
    return m, rt, secs, tsyms, sectors


def run_tj(device, feed):
    """TJ: the symbol table filled by ``update or insert into`` (10,000
    rows, half the feed's symbols), then the flagship feed's batches
    through the indexed table join and the ``in`` filter, both held
    against a dict lookup. Returns the row counts, the fill's seconds and
    events/s."""
    import numpy as np
    import torch

    m, rt, fill_s, tsyms, sectors = tj_fill(device, TJ_ROWS)
    outs = {s: collector() for s in ("Enriched", "Known")}
    for s, c in outs.items():
        rt.add_callback(s, c)
    q = rt.query_runtimes["tj"]
    _require(q.index_probe is not None and q.index_probe["attr"] == "symbol",
             "TJ: the table join did not take the indexed probe")
    h = rt.get_input_handler("StockStream")
    seconds = []
    for cols, ts in feed:
        t0 = time.perf_counter()
        h.send_columns({k: v for k, v in cols.items() if k != "ts"}, timestamps=ts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    strings = np.array(rt.app_context.string_dictionary._to_str, dtype=object)
    m.shutdown()
    sector_of = dict(zip(tsyms.tolist(), sectors.tolist()))
    want_e, want_k = [], []
    for cols, _ts in feed:
        for s, p in zip(cols["symbol"].tolist(), cols["price"].astype(np.float64).tolist()):
            if s in sector_of:
                want_e.append((s, sector_of[s], p))
                want_k.append((s, p))
    got_e = [r for b in outs["Enriched"].batches for r in zip(
        strings[b["symbol"]].tolist(), strings[b["sector"]].tolist(),
        b["price"].astype(float).tolist())]
    got_k = [r for b in outs["Known"].batches for r in zip(
        strings[b["symbol"]].tolist(), b["price"].astype(float).tolist())]
    _require(got_e == want_e, f"TJ: {len(got_e)} enriched rows, the dict lookup "
             f"gives {len(want_e)}")
    _require(got_k == want_k, f"TJ: {len(got_k)} `in` rows, the dict lookup "
             f"gives {len(want_k)}")
    return {"rows": len(got_e), "known": len(got_k), "fill_s": fill_s,
            "eps": steady_eps(seconds, BATCH), "seconds": seconds}


def run_stores(device):
    """The cut checks: a named window as a join side, on-demand
    find/update/delete, a `start` and an `every` trigger. Returns every
    output and query result (trigger start times dropped: they read the
    host clock before the first event)."""
    import numpy as np

    from siddhi_tpu_torch import SiddhiManager, StreamCallback

    class Rows(StreamCallback):
        def __init__(self):
            self.rows = []

        def receive(self, events):
            self.rows.extend((e.timestamp, tuple(e.data)) for e in events)

    rng = np.random.default_rng(53)
    m = SiddhiManager(device=device)
    rt = m.create_siddhi_app_runtime(STORE_APP)
    outs = {s: Rows() for s in ("WJ", "Starts", "Ticks")}
    for s, c in outs.items():
        rt.add_callback(s, c)
    rt.start()
    t = 1_000
    for i in range(60):
        t += int(rng.choice([0, 40, 300]))
        stream = "S" if rng.random() < 0.6 else "R"
        rt.get_input_handler(stream).send(
            t, [f"K{int(rng.integers(0, 6))}", float(np.round(rng.random() * 100, 2))])
    found = [[tuple(e.data) for e in rt.query(qs)] for qs in STORE_QUERIES]
    m.shutdown()
    return {"WJ": outs["WJ"].rows, "starts": len(outs["Starts"].rows),
            "Ticks": outs["Ticks"].rows, "queries": found}


def phase_joins(device, card: str):
    """Phase 20: joins, tables, named windows, on-demand queries and
    triggers. J5, BASELINE config #5 at full width, on the engine (auto
    P = 8 on the card) against a numpy hash join of every send over live
    sets built from the feed, against the broadcast probe row for row,
    and at a 64-symbol cut against the port's CPU run; JB, bench_join's
    shape, engine == broadcast at P in {1, 8} and depth {1, 2}; TJ, the
    stream-table enrichment against a dict lookup, and its fill's batch
    insert against the per-event walk; the cut store checks against the
    CPU."""
    import numpy as np

    t_phase = time.perf_counter()
    res = {"reduced": [
        f"J5: {J5_PAIRS} Stock/Twitter batch pairs (depth); the broadcast "
        f"probe over the first {J5_LEGACY_PAIRS}",
        f"J5 on the CPU: {J5_CUT_SYMBOLS} symbols, {J5_CUT_PAIRS} pairs",
        f"JB: {JB_SENDS} timed batches a point in place of bench_join's "
        f"MEASURE_SECONDS / 2; P in {{1, 8}} of {{1, 2, 4, 8}}",
        f"TJ: {TJ_BATCHES} flagship batches; the walked fill at {TJ_WALK_ROWS} "
        f"of {TJ_ROWS} rows"]}
    cpu = __import__("torch").device("cpu")

    # J5 on the engine, every send against the numpy hash join
    feed, feed_ids = j5_feed(17, J5_PAIRS)
    f = run_j5(device, feed, card, oracle_ids=feed_ids, profile=True)
    eng = f["engine"]
    _require(eng is not None and eng["P"] == (8 if device.type == "cuda" else 1),
             f"J5: engine {eng} ({f['engine_reason']})")
    if device.type == "cuda":
        _require(all(eng["partitioned"].values()),
                 f"J5: both sides must take the partitioned probe: {eng}")
    _require(f["seq_breaks"] == 0, "J5: drain sequence breaks")
    _require(f["peak_bytes"] < J5_MEMORY_LIMIT,
             f"J5: peak device memory {f['peak_bytes']} bytes")
    n_rows = sum(len(r) for r in f["rows"])
    rows_in = sum(len(ts) for _s, _c, ts in feed)
    secs = f["seconds"]
    # timed pairs: all but the first (the card's lazy loading and the
    # allocator) and the two measured under the profiler and sync mode
    timed = len(secs["StockStream"]) - 1
    timed_s = sum(secs["StockStream"][1:]) + sum(secs["TwitterStream"][1:])
    res["J5"] = {
        "pairs": J5_PAIRS, "timed_pairs": timed, "rows_in": rows_in,
        "rows_out": n_rows, "state_checks": f["state_checks"],
        "first_pair_s": secs["StockStream"][0] + secs["TwitterStream"][0],
        "events_per_s": timed * (BATCH + J5_TWEETS) / timed_s,
        "latency_samples": timed,
        **{f"{k}_{q}_ms": (max(secs[s][1:]) * 1e3 if q == "max"
                           else quantile_ms(secs[s][1:], int(q[1:])))
           for k, s in (("stock", "StockStream"), ("twitter", "TwitterStream"))
           for q in ("p50", "p99", "max")},
        "timer_steps": f["timer_steps"], "state_bytes": f["state_bytes"],
        "peak_bytes": f["peak_bytes"], "P": eng["P"], "Wp": eng["Wp"],
        "syncs": {s: v["syncs"] for s, v in f["syncs"].items()},
        "sync_sites": {s: v["sync_sites"] for s, v in f["syncs"].items()},
        "busy_share": {s: v["busy_share"] for s, v in f["profiles"].items()},
        "profile_ms": {s: {"wall": v["wall_ms"], "device": v["device_ms"]}
                       for s, v in f["profiles"].items()},
    }
    j5 = res["J5"]
    print(f"[joins] J5 (config #5: time(10 sec) x length(100) on symbol, "
          f"{NUM_SYMBOLS} symbols, {BATCH}-row Stock + {J5_TWEETS}-row Twitter "
          f"batches, ring {J5_CAPACITY}): P={eng['P']}, Wp {eng['Wp']}, "
          f"{rows_in} rows in, {n_rows} rows out, every send == the numpy hash "
          f"join over the feed's live sets, the window state == those sets at "
          f"{f['state_checks']} sends; {j5['events_per_s']:.1f} events/s over "
          f"{timed} timed pairs (the first {j5['first_pair_s']:.2f} s), Stock "
          f"p50/p99/max {j5['stock_p50_ms']:.2f}/{j5['stock_p99_ms']:.2f}/"
          f"{j5['stock_max_ms']:.2f} ms, Twitter p50/p99/max "
          f"{j5['twitter_p50_ms']:.2f}/{j5['twitter_p99_ms']:.2f}/"
          f"{j5['twitter_max_ms']:.2f} ms over {timed} sends a side, "
          f"{f['timer_steps']} TIMER steps, state {f['state_bytes']} bytes, peak "
          f"device memory {f['peak_bytes'] / 2 ** 30:.2f} GiB, host syncs a send "
          f"{j5['syncs']} [{card}]", flush=True)

    # the broadcast probe on the card, row for row, over the first pairs
    head = feed[:2 * J5_LEGACY_PAIRS]
    lg = run_j5(device, head, card, config={"join_engine": "legacy"})
    _require(lg["engine"] is None, "J5 legacy: an engine attached")
    _require(lg["rows"] == f["rows"][:len(head)],
             "J5: the engine's rows differ from the broadcast probe's")
    ls = lg["seconds"]
    j5["legacy"] = {
        "stock_p50_ms": quantile_ms(ls["StockStream"][1:], 50),
        "twitter_p50_ms": quantile_ms(ls["TwitterStream"][1:], 50),
        "peak_bytes": lg["peak_bytes"]}
    print(f"[joins] J5 engine == broadcast probe row for row over "
          f"{J5_LEGACY_PAIRS} pairs ({sum(len(r) for r in lg['rows'])} rows); "
          f"broadcast probe Stock p50 {j5['legacy']['stock_p50_ms']:.2f} ms, "
          f"Twitter p50 {j5['legacy']['twitter_p50_ms']:.2f} ms over "
          f"{J5_LEGACY_PAIRS - 1} sends a side, peak "
          f"{lg['peak_bytes'] / 2 ** 30:.2f} GiB [{card}]", flush=True)

    # a 64-symbol cut, the card against the port's CPU run
    cut, _ids = j5_feed(19, J5_CUT_PAIRS, n_symbols=J5_CUT_SYMBOLS)
    on_card = run_j5(device, cut, card)
    on_cpu = run_j5(cpu, cut, card)
    _require(on_card["rows"] == on_cpu["rows"],
             "J5 cut: the card's rows differ from the CPU run's")
    print(f"[joins] J5 at {J5_CUT_SYMBOLS} symbols, {J5_CUT_PAIRS} pairs: card == "
          f"the port's CPU run ({sum(len(r) for r in on_card['rows'])} rows)",
          flush=True)

    # JB: bench_join's shape
    res["JB"] = {}
    for mix in ("probe", "insert"):
        ref, ref_eps, ref_s = jb_run(device, "legacy", 1, 1, mix)
        pts = {"legacy_d1": {"eps": ref_eps, "s": ref_s}}
        for P in (1, 8):
            for depth in (1, 2):
                cols, eps, sec = jb_run(device, "device", P, depth, mix)
                _require(all(np.array_equal(cols[k], ref[k]) for k in ref),
                         f"JB {mix} P={P} depth={depth}: engine != broadcast probe")
                pts[f"P{P}_d{depth}"] = {"eps": eps, "s": sec}
        res["JB"][mix] = pts
        print(f"[joins] JB {mix} mix (length({JB_WINDOW}) x2, {JB_KEYS} keys, "
              f"{JB_BATCH}-row batches, {JB_SENDS} timed sends a point, "
              f"{ref['sym'].size} rows == broadcast at every point): events/s "
              + ", ".join(f"{k} {v['eps']:.1f} ({v['s']:.2f} s)" for k, v in pts.items())
              + f" [{card}]", flush=True)

    # TJ: stream-table enrichment
    stock = [(c, ts) for _s, c, ts in feed if _s == "StockStream"][:TJ_BATCHES]
    tj = run_tj(device, stock)
    res["TJ"] = {k: v for k, v in tj.items() if k != "seconds"}
    print(f"[joins] TJ: {TJ_ROWS}-row @primaryKey table by update or insert "
          f"({tj['fill_s'] * 1e3:.2f} ms), {TJ_BATCHES} flagship batches through the "
          f"indexed table join and `in`: {tj['rows']} enriched and {tj['known']} "
          f"`in` rows == the dict lookup; {tj['eps']:.1f} events/s [{card}]",
          flush=True)
    # the fill's batch insert against the per-event walk, at a cut
    fills, tables = {}, {}
    for name, chunk in (("batch", None), ("walk", 0)):
        m, rt, fills[name], _t, _s = tj_fill(device, TJ_WALK_ROWS, chunk)
        tables[name] = [tuple(e.data) for e in rt.query(
            "from SymbolTable select symbol, sector, cap")]
        m.shutdown()
    _require(tables["batch"] == tables["walk"],
             "TJ: the batch insert's table differs from the walk's")
    res["TJ"]["fill_cut"] = {"rows": TJ_WALK_ROWS, **{f"{k}_s": v for k, v in fills.items()}}
    print(f"[joins] TJ fill of {TJ_WALK_ROWS} rows: batch insert "
          f"{fills['batch'] * 1e3:.2f} ms, walked one event at a time "
          f"{fills['walk'] * 1e3:.2f} ms, the same table [{card}]", flush=True)

    # the cut store checks: the card against the CPU
    st_card, st_cpu = run_stores(device), run_stores(cpu)
    _require(st_card == st_cpu, "stores: the card's outputs differ from the CPU run's")
    _require(st_card["starts"] == 1 and st_card["Ticks"] and st_card["WJ"]
             and st_card["queries"][0], f"stores: {st_card}")
    print(f"[joins] named window join ({len(st_card['WJ'])} rows), on-demand "
          f"find/update/delete ({len(STORE_QUERIES)} queries), `start` and `every` "
          f"triggers ({len(st_card['Ticks'])} ticks) == the CPU run", flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[joins] phase 20 in {res['phase_s']:.1f} s", flush=True)
    return res


# ------------------------------------------- aggregation and persistence

AG_BATCHES = 4                  # each batch is seconds of host fold: a depth cut
AG_Q_ROWS = 256
AG_T0 = TW_BASE
AG_T1 = TW_BASE + 10 ** 8       # past the feed's last bucket
# Siddhi's documented incremental aggregation example (TradeAggregation:
# avg(price), sum(price) group by symbol aggregate by timestamp every sec
# ... year), widened to sum(volume), count(), min and max; the global
# flagship on the same stream, a @primaryKey table of each symbol's first
# trade, and an aggregation join
AG_APP = """@app:name('stock_agg')
@app:playback
define stream StockStream (symbol string, price float, volume long, ts long);
define stream Q (symbol string, t long);
@primaryKey('symbol')
define table FirstTrade (symbol string, price float, volume long);
define aggregation StockAgg
from StockStream
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume, count() as n,
       min(price) as lo, max(price) as hi
group by symbol
aggregate by ts every sec ... year;
@info(name = 'bench')
from StockStream#window.length({W})
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
group by symbol
insert into OutStream;
from StockStream select symbol, price, volume insert into FirstTrade;
@info(name = 'aggjoin')
from Q join StockAgg on Q.symbol == StockAgg.symbol
within {T0}L, {T1}L per 'minutes'
select Q.symbol as symbol, StockAgg.AGG_TIMESTAMP as bucket,
       StockAgg.totalVolume as totalVolume, StockAgg.n as n,
       StockAgg.avgPrice as avgPrice
insert into AggJoinOut;
"""
AG_DURATIONS = ("sec", "min", "hour", "day", "month", "year")
AG_FINDS = {
    "sec_all": ("from StockAgg within {T0}L, {T1}L per 'seconds' "
                "select symbol, avgPrice, totalVolume, n, lo, hi"),
    "min_top": ("from StockAgg within {T0}L, {T1}L per 'minutes' "
                "select symbol, totalVolume, n order by totalVolume desc, symbol "
                "limit 20"),
    "hour_having": ("from StockAgg within {T0}L, {T1}L per 'hours' "
                    "select symbol, min(lo) as lo, max(hi) as hi group by symbol "
                    "having lo < 1.0 order by symbol"),
    "day_group": ("from StockAgg within {T0}L, {T1}L per 'days' "
                  "select symbol, sum(totalVolume) as v, sum(n) as c group by symbol "
                  "having v > {V}L order by v desc, symbol limit 10"),
    "sec_counts": ("from StockAgg within {T0}L, {T1}L per 'seconds' "
                   "select symbol, sum(n) as c group by symbol "
                   "order by c desc, symbol limit 5"),
    "sec_totals": ("from StockAgg within {T0}L, {TM}L per 'seconds' "
                   "select AGG_TIMESTAMP as t, sum(totalVolume) as v "
                   "group by AGG_TIMESTAMP order by t"),
}
AG_DAY_VOLUME = 20_000          # day_group's having bound
J5_P_PAIRS = 12                 # P's J5 cell: split at half
N_P_PAIRS = 16                  # P's N cell: split at half


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def concat_rows(batches):
    """One batch of columns holding every row of ``batches``."""
    import numpy as np

    batches = [b for b in batches if len(b["__ts__"])]
    if not batches:
        return []
    return [{k: np.concatenate([b[k] for b in batches]) for k in batches[0]}]


def agg_oracle(feed):
    """The bucket stores of StockAgg built from the feed alone: per
    duration {(bucket, symbol): (avgPrice, totalVolume, n, lo, hi)}. Sums
    fold in arrival order (``np.add.at`` walks its rows in order), so
    they equal the runtime's float for float."""
    import numpy as np

    sym = np.concatenate([c["symbol"] for c, _t in feed])
    ts = np.concatenate([c["ts"] for c, _t in feed]).astype(np.int64)
    price = np.concatenate([c["price"] for c, _t in feed]).astype(np.float64)
    vol = np.concatenate([c["volume"] for c, _t in feed]).astype(np.int64)
    names, sid = np.unique(sym, return_inverse=True)
    out = {}
    for d in AG_DURATIONS:
        if d in ("month", "year"):
            unit = "M" if d == "month" else "Y"
            b = ts.astype("datetime64[ms]").astype(f"datetime64[{unit}]") \
                .astype("datetime64[ms]").astype(np.int64)
        else:
            w = {"sec": 1000, "min": 60_000, "hour": 3_600_000, "day": 86_400_000}[d]
            b = ts - ts % w
        key = b * len(names) + sid
        uk, inv = np.unique(key, return_inverse=True)
        s = np.zeros(len(uk))
        np.add.at(s, inv, price)
        n = np.bincount(inv, minlength=len(uk))
        tv = np.zeros(len(uk), np.int64)
        np.add.at(tv, inv, vol)
        lo = np.full(len(uk), np.inf)
        np.minimum.at(lo, inv, price)
        hi = np.full(len(uk), -np.inf)
        np.maximum.at(hi, inv, price)
        out[d] = {(int(k // len(names)), str(names[k % len(names)])):
                  (float(s[i]) / int(n[i]), int(tv[i]), int(n[i]), float(lo[i]),
                   float(hi[i])) for i, k in enumerate(uk)}
    return out


def rows_close(got, want, what: str, rtol=FLOAT_RTOL):
    """Lists of row tuples: equal length, ints and strings exact, floats
    to ``rtol`` (one value, or one per column)."""
    _require(len(got) == len(want), f"{what}: {len(got)} rows, want {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        _require(len(a) == len(b), f"{what}: row {i} width")
        tols = rtol if isinstance(rtol, tuple) else (rtol,) * len(b)
        for x, y, tol in zip(a, b, tols):
            if isinstance(y, float):
                _require(abs(x - y) <= tol * abs(y), f"{what}: row {i}: {a} vs {b}")
            else:
                _require(x == y, f"{what}: row {i}: {a} vs {b}")


def ag_expected_finds(oracle, feed):
    """What each of AG_FINDS returns, from the oracle alone."""
    import numpy as np

    tm = AG_T0 + ag_mid_ms(feed)
    sec = oracle["sec"]
    want = {"sec_all": sorted((s, *v) for (_b, s), v in sec.items())}
    mins = [(s, v[1], v[2]) for (_b, s), v in oracle["min"].items()]
    want["min_top"] = sorted(mins, key=lambda r: (-r[1], r[0]))[:20]
    hours = {}
    for (_b, s), v in oracle["hour"].items():
        lo, hi = hours.get(s, (np.inf, -np.inf))
        hours[s] = (min(lo, v[3]), max(hi, v[4]))
    want["hour_having"] = sorted((s, lo, hi) for s, (lo, hi) in hours.items() if lo < 1.0)
    days = {}
    for (_b, s), v in oracle["day"].items():
        a = days.get(s, (0, 0))
        days[s] = (a[0] + v[1], a[1] + v[2])
    want["day_group"] = sorted(((s, v, c) for s, (v, c) in days.items()
                                if v > AG_DAY_VOLUME), key=lambda r: (-r[1], r[0]))[:10]
    counts = {}
    for (_b, s), v in sec.items():
        counts[s] = counts.get(s, 0) + v[2]
    want["sec_counts"] = sorted(counts.items(), key=lambda r: (-r[1], r[0]))[:5]
    totals = {}
    for (b, _s), v in sec.items():
        if b < tm:
            totals[b] = totals.get(b, 0) + v[1]
    want["sec_totals"] = sorted(totals.items())
    return want


def ag_mid_ms(feed) -> int:
    """sec_totals' upper bound: half the feed's event time."""
    first, last = int(feed[0][1][0]), int(feed[-1][1][-1])
    return (last - first) // 2


def ag_q_batch(feed, seed: int):
    """The 256-row Q batch: symbols of the feed's universe, stamped at the
    feed's last timestamp."""
    import numpy as np

    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i}" for i in range(NUM_SYMBOLS)], dtype=object)
    t = int(feed[-1][1][-1])
    return ({"symbol": syms[rng.integers(0, NUM_SYMBOLS, AG_Q_ROWS)],
             "t": np.full(AG_Q_ROWS, t, np.int64)}, np.full(AG_Q_ROWS, t, np.int64))


def ag_build(device, store):
    from siddhi_tpu_torch import SiddhiManager

    m = SiddhiManager(device=device)
    m.set_persistence_store(store)
    rt = m.create_siddhi_app_runtime(AG_APP.format(W=WINDOW, T0=AG_T0, T1=AG_T1))
    rt.query_runtimes["bench"].selector_plan.num_keys = KEY_SLOTS
    cbs = {s: collector() for s in ("OutStream", "AggJoinOut")}
    for s, cb in cbs.items():
        rt.add_callback(s, cb)
    return m, rt, cbs


def agg_rows(rt, d: str):
    """StockAgg's stitched rows of one duration as (bucket, symbol, avg,
    totalVolume, n, lo, hi), symbols decoded."""
    from siddhi_tpu_torch.core.aggregation.incremental import parse_duration_name

    agg = rt.aggregations["StockAgg"]
    dic = rt.app_context.string_dictionary
    return sorted((r[0], dic.decode(int(r[1])), *r[2:])
                  for r in agg.rows(parse_duration_name(d)))


def phase_aggregation(device, card: str):
    """AG and the incremental chain (see the module doc). Returns
    (facts, persistence facts of the chain, the straight run's stores and
    finds)."""
    import pickle

    import numpy as np

    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore

    t_phase = time.perf_counter()
    feed, _ids = tw_feed(17, AG_BATCHES)
    oracle = agg_oracle(feed)
    store = InMemoryPersistenceStore()
    m, rt, cbs = ag_build(device, store)
    agg = rt.aggregations["StockAgg"]
    fold_s = []
    orig = agg._fold_batch

    def timed_fold(cols):
        t0 = time.perf_counter()
        orig(cols)
        fold_s.append(time.perf_counter() - t0)

    agg._fold_batch = timed_fold
    h = rt.get_input_handler("StockStream")
    revs, chain = [], {}
    for i, (cols, ts) in enumerate(feed):
        h.send_columns(cols, timestamps=ts)
        sync(device)
        if i == 0:
            revs.append(rt.persist())                    # full
            chain["full_bytes"] = len(store.load(rt.name, revs[-1]))
        elif i == AG_BATCHES - 2:
            revs.append(rt.persist_incremental())        # delta of two batches
            chain["incremental_bytes"] = len(store.load(rt.name, revs[-1]))
        if i == AG_BATCHES - 2:
            n_head = len(cbs["OutStream"].batches)
    _require(pickle.loads(store.load(rt.name, revs[-1])).get("incremental"),
             "AG: the second revision is not incremental")
    _require(sum(len(b["__ts__"]) for b in cbs["OutStream"].batches)
             == AG_BATCHES * BATCH, "AG: the flagship's rows out")

    # the stores against the oracle
    buckets = {}
    for d in AG_DURATIONS:
        got = agg_rows(rt, d)
        want = sorted((b, s, *v) for (b, s), v in oracle[d].items())
        # sums fold in arrival order on both sides: only avg may differ,
        # by its one division
        rows_close(got, want, f"AG {d} store", rtol=(0, 0, FLOAT_RTOL, 0, 0, 0.0, 0.0))
        buckets[d] = len({r[0] for r in got})
    # the finds
    V = AG_DAY_VOLUME
    want_finds = ag_expected_finds(oracle, feed)
    find_ms, finds = {}, {}
    dic = rt.app_context.string_dictionary
    for name, text in AG_FINDS.items():
        q = text.format(T0=AG_T0, T1=AG_T1, TM=AG_T0 + ag_mid_ms(feed), V=V)
        t0 = time.perf_counter()
        events = rt.query(q)
        find_ms[name] = (time.perf_counter() - t0) * 1e3
        got = [tuple(e.data) for e in events]
        if name == "sec_all":
            got = sorted(got)
        rows_close(got, want_finds[name], f"AG find {name}")
        _require(len(got) > 0, f"AG find {name}: no rows")
        finds[name] = got
    # the aggregation join: a numpy hash join over the oracle's minutes
    qcols, qts = ag_q_batch(feed, 18)
    by_sym = {}
    start = AG_T0 - AG_T0 % 60_000       # within's start, truncated to its minute
    for (b, s), v in oracle["min"].items():
        if start <= b < AG_T1:
            by_sym.setdefault(s, []).append((s, b, v[1], v[2], v[0]))
    want_join = sorted(r for s in qcols["symbol"] for r in by_sym.get(str(s), []))
    n0 = len(cbs["AggJoinOut"].batches)
    t0 = time.perf_counter()
    rt.get_input_handler("Q").send_columns(qcols, timestamps=qts)
    sync(device)
    join_ms = (time.perf_counter() - t0) * 1e3
    strings = np.array(dic._to_str, dtype=object)
    got_join = sorted(
        (str(strings[sy]), int(b), int(tv), int(n), float(ap))
        for out in cbs["AggJoinOut"].batches[n0:]
        for sy, b, tv, n, ap in zip(out["symbol"], out["bucket"], out["totalVolume"],
                                    out["n"], out["avgPrice"]))
    rows_close(got_join, want_join, "AG join")
    slots = sum(len(g) for dstore in agg.store.values() for g in dstore.values())
    store_bytes = 8 * len(agg.bases) * slots
    straight = {"tail": concat_rows(cbs["OutStream"].batches[n_head:]),
                "stores": {d: agg_rows(rt, d) for d in AG_DURATIONS},
                "finds": finds,
                "table": sorted(tuple(e.data) for e in rt.tables["FirstTrade"].all_events())}
    m.shutdown()

    # the incremental chain: full + delta restored into a fresh runtime,
    # then the last batch
    m2, rt2, cbs2 = ag_build(device, store)
    t0 = time.perf_counter()
    got_rev = rt2.restore_last_revision()
    sync(device)
    chain["restore_ms"] = (time.perf_counter() - t0) * 1e3
    _require(got_rev == revs[-1], "AG chain: restored the wrong revision")
    chain["h2d_bytes"] = rt2.persistence.snapshot_service.h2d_bytes
    cols, ts = feed[-1]
    rt2.get_input_handler("StockStream").send_columns(cols, timestamps=ts)
    sync(device)
    require_equal(concat_rows(cbs2["OutStream"].batches), straight["tail"],
                  "AG chain: the flagship after the restore")
    for d in AG_DURATIONS:
        _require(agg_rows(rt2, d) == straight["stores"][d],
                 f"AG chain: the {d} store after the restore")
    _require(sorted(tuple(e.data) for e in rt2.tables["FirstTrade"].all_events())
             == straight["table"], "AG chain: the table after the restore")
    m2.shutdown()

    facts = {"batches": AG_BATCHES, "rows": AG_BATCHES * BATCH,
             "fold_ms": [s * 1e3 for s in fold_s], "find_ms": find_ms,
             "join_ms": join_ms, "join_rows": len(got_join),
             "buckets": buckets, "slots": slots, "store_bytes": store_bytes,
             "card": card}
    chain["revisions"] = len(revs)
    print(f"[aggregation] AG StockAgg sec...year over {AG_BATCHES} batches of "
          f"{BATCH} rows ({NUM_SYMBOLS} symbols) with the global flagship on the "
          f"same sends: fold ms a batch "
          f"{', '.join(f'{x:.0f}' for x in facts['fold_ms'])} (host); buckets "
          f"{buckets}, {slots} (bucket, group) slots, {store_bytes} host store "
          f"bytes; every store == the numpy oracle; {len(AG_FINDS)} finds == the "
          f"oracle in ms {', '.join(f'{k} {v:.1f}' for k, v in find_ms.items())}; "
          f"the join of {AG_Q_ROWS} Q rows ({len(got_join)} rows) == a numpy hash "
          f"join over the oracle in {join_ms:.1f} ms [{card}]", flush=True)
    print(f"[persistence] incremental chain: full {chain['full_bytes']} bytes, "
          f"delta {chain['incremental_bytes']} bytes, chain restored in "
          f"{chain['restore_ms']:.1f} ms; the flagship, the stores and the table "
          f"after the last batch == the straight run [{card}]", flush=True)
    facts["phase_s"] = time.perf_counter() - t_phase
    return facts, chain, {"stores": straight["stores"], "finds": straight["finds"]}


def captured_queries(rt):
    """The runtime's state as a snapshot holds it (host numpy)."""
    from siddhi_tpu_torch.core.util.snapshot import SnapshotService

    return SnapshotService(rt)._capture_common()


def require_same_state(blob: bytes, rt, what: str) -> int:
    """Every state leaf of ``rt`` byte-equal to the revision's, keyer maps,
    high-water marks and partition key spaces equal. Returns the bytes
    compared."""
    import numpy as np

    from siddhi_tpu_torch.core.util.snapshot import safe_loads

    want = safe_loads(blob)
    got = captured_queries(rt)
    nbytes = 0

    def walk(a, b, path):
        nonlocal nbytes
        if isinstance(b, dict):
            _require(isinstance(a, dict) and set(a) == set(b),
                     f"{what}: state keys differ at {path}")
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        a, b = np.asarray(a), np.asarray(b)
        _require(a.dtype == b.dtype and a.shape == b.shape
                 and a.tobytes() == b.tobytes(),
                 f"{what}: state leaf {path} differs after the restore")
        nbytes += b.nbytes

    for name, q in want["queries"].items():
        g = got["queries"][name]
        if q["state"] is not None:
            walk(g["state"], q["state"], name)
        _require(g["keyer_map"] == q["keyer_map"], f"{what}: {name} keyer map")
        _require((g["nfa_hwm"] is None) == (q["nfa_hwm"] is None)
                 and (q["nfa_hwm"] is None
                      or np.array_equal(g["nfa_hwm"], q["nfa_hwm"])),
                 f"{what}: {name} high-water marks")
    _require(got["partitions"] == want["partitions"], f"{what}: partition key spaces")
    _require(got["clock"] == want["clock"], f"{what}: event clock")
    return nbytes


class ExchangeRecorder:
    """Stands in for ``ring_exchange_cols`` in the routed step, and watches
    every ``StepGraph.run``, to keep exchange call ``at`` (counted as
    ``ScanRecorder`` counts: eager calls and replays of a graph whose
    capture recorded an exchange). Every call goes through to the
    wrapper. An eager call's inputs are cloned; under capture the call's
    input and output tensors are kept (graph-pool memory each replay
    rewrites, not reused by the capture while referenced), and after
    replay ``at`` both are cloned: ``got`` is what the kernel wrote
    inside the graph."""

    def __init__(self, at: int = 0):
        self.at, self.calls, self.replays = at, 0, 0
        self.bufs = self.got = self.n = None
        self.current = None
        self.in_graph = {}          # id(graph) -> (bufs, outs, n)

    def __call__(self, bufs, n):
        import torch

        from siddhi_tpu_torch.ops.exchange import ring_exchange_cols

        out = ring_exchange_cols(bufs, n)
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            self.in_graph[id(self.current)] = (bufs, out, n)
            return out
        i, self.calls = self.calls, self.calls + 1
        if i == self.at:
            self.bufs, self.n = [b.clone() for b in bufs], n
        return out

    def wrap_run(self, run):
        def recorded_run(graph, *a, **k):
            prev, self.current = self.current, graph
            try:
                res = run(graph, *a, **k)
            finally:
                self.current = prev
            call = self.in_graph.get(id(graph))
            if res[2] is None and call is not None:
                i, self.calls = self.calls, self.calls + 1
                self.replays += 1
                if i == self.at:
                    bufs, outs, self.n = call
                    self.bufs = [b.clone() for b in bufs]
                    self.got = [o.clone() for o in outs]
            return res
        return recorded_run


@contextlib.contextmanager
def recording_exchange(at: int = 0, rec=None):
    """``rec`` (default ``ExchangeRecorder(at)``) installed for the life of
    the block."""
    from siddhi_tpu_torch.core.query.step_graph import StepGraph
    from siddhi_tpu_torch.parallel import mesh

    rec = rec if rec is not None else ExchangeRecorder(at)
    orig, orig_run = mesh.ring_exchange_cols, StepGraph.run
    mesh.ring_exchange_cols = rec
    StepGraph.run = rec.wrap_run(orig_run)
    try:
        yield rec
    finally:
        mesh.ring_exchange_cols = orig
        StepGraph.run = orig_run


def check_exchange_call(rec, what: str) -> int:
    """The recorded call through the kernel and the plain version: equal
    byte for byte; a call recorded inside a graph also holds what the
    kernel wrote there equal to plain. Returns the columns compared."""
    import torch

    from siddhi_tpu_torch.ops.exchange import ring_exchange_cols, ring_exchange_cols_plain

    _require(rec.bufs is not None, f"{what}: no exchange call recorded")
    got = ring_exchange_cols([b.clone() for b in rec.bufs], rec.n)
    torch.cuda.synchronize()
    want = ring_exchange_cols_plain([b.clone() for b in rec.bufs], rec.n)
    for i, (a, b) in enumerate(zip(got, want)):
        _require(torch.equal(a, b), f"{what}: kernel column {i} differs from plain")
    for i, (a, b) in enumerate(zip(rec.got or (), want)):
        _require(torch.equal(a, b), f"{what}: the graph's column {i} differs from plain")
    return len(want)


def split_cell(device, label: str, build, items, half: int, send, out_stream: str,
               straight, card: str, build_dst=None, tail_hook=None, store=None,
               exact: bool = True):
    """Persist after ``half`` items, restore into a fresh runtime
    (``build_dst``, else ``build``) with ``restore_last_revision``, feed the
    rest. The head's outputs equal the straight run's, the restored state
    is byte-equal to the revision, and every row after the restore equals
    the straight run's rows after ``half`` items (``straight``: that run's
    per-batch outputs and its batch count at ``half``). ``tail_hook`` is a
    context manager around the tail (a kernel recorder). Returns facts."""
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore

    store = store if store is not None else InMemoryPersistenceStore()
    m1, rt1, cb1 = build(store)
    for it in items[:half]:
        send(rt1, it)
    sync(device)
    head = cb1[out_stream].batches
    s_batches, s_half = straight
    require_equal(concat_rows(head), concat_rows(s_batches[:s_half]),
                  f"{label}: head vs the straight run")
    t0 = time.perf_counter()
    rev = rt1.persist()
    sync(device)
    facts = {"persist_ms": (time.perf_counter() - t0) * 1e3}
    facts["d2h_bytes"] = rt1.persistence.snapshot_service.d2h_bytes
    blob = store.load(rt1.name, rev)
    facts["snapshot_bytes"] = len(blob)
    facts["state_bytes"] = sum(t.numel() * t.element_size()
                               for q in rt1.query_runtimes.values()
                               if q._state is not None for t in _leaves(q._state))
    m1.shutdown()
    m2, rt2, cb2 = (build_dst or build)(store)
    t0 = time.perf_counter()
    _require(rt2.restore_last_revision() == rev, f"{label}: wrong revision")
    sync(device)
    facts["restore_ms"] = (time.perf_counter() - t0) * 1e3
    facts["h2d_bytes"] = rt2.persistence.snapshot_service.h2d_bytes
    for q in rt2.query_runtimes.values():
        for t in _leaves(q._state or {}):
            _require(t.device.type == device.type,
                     f"{label}: restored state on {t.device}, not {device}")
    facts["state_bytes_compared"] = require_same_state(blob, rt2, label)
    with (tail_hook() if tail_hook is not None else contextlib.nullcontext()) as rec:
        for it in items[half:]:
            send(rt2, it)
        sync(device)
    facts["recorder"] = rec
    tail = concat_rows(cb2[out_stream].batches)
    m2.shutdown()
    facts["rows_after_restore"] = sum(len(b["__ts__"]) for b in tail)
    facts["worst"] = require_equal(tail, concat_rows(s_batches[s_half:]),
                                   f"{label}: after the restore vs the straight run",
                                   exact_floats=exact)
    return facts


def batches_for_rows(batches, rows: int) -> int:
    """How many of ``batches`` hold the first ``rows`` rows."""
    total = 0
    for i, b in enumerate(batches):
        if total == rows:
            return i
        total += len(b["__ts__"])
    _require(total == rows, f"no batch boundary at {rows} rows")
    return len(batches)


def send_cols(stream: str):
    def send(rt, item):
        cols, ts = item
        rt.get_input_handler(stream).send_columns(cols, timestamps=ts)
    return send


def send_multi_items(rt, item):
    stream, cols, ts = item
    rt.get_input_handler(stream).send_columns(cols, timestamps=ts)


def straight_run(device, build, items, half: int, send, out_stream: str):
    """(per-batch outputs, batch count after ``half`` items)."""
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore

    m, rt, cbs = build(InMemoryPersistenceStore())
    n_half = 0
    for i, it in enumerate(items):
        send(rt, it)
        sync(device)
        if i == half - 1:
            n_half = len(cbs[out_stream].batches)
    batches = cbs[out_stream].batches
    m.shutdown()
    return batches, n_half


def phase_persistence(device, feed, routed, unrouted, d1_out, card: str):
    """P (see the module doc): each cell straight and split around a
    persist -> restore into a fresh runtime. Returns the facts."""
    import tempfile

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.core.util.persistence import FileSystemPersistenceStore
    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.ops.exchange import ring_exchange
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    res = {}
    items = list(feed)
    half = len(items) // 2

    # the routed partitioned flagship x4 (phase 4's runs are the straight ones)
    def flagship(routed_layout: bool):
        def build(store):
            m = SiddhiManager(device=device)
            m.set_config_manager(InMemoryConfigManager(
                {"siddhi_tpu.shard_exchange": "pallas_ring"}))
            m.set_persistence_store(store)
            rt = m.create_siddhi_app_runtime(APP.format(W=WINDOW))
            q = rt.query_runtimes["bench"]
            q.selector_plan.num_keys = KEY_SLOTS
            q._win_keys = KEY_SLOTS
            if routed_layout:
                device_route_query_step(q, make_mesh(N_SHARDS, device),
                                        rows_per_shard=ROWS_PER_SHARD)
            else:
                q._state = q._init_state()
            cb = collector()
            rt.add_callback("OutStream", cb)
            return m, rt, {"OutStream": cb}
        return build

    def count_exchange():
        ring_exchange.launches = 0
        return recording_exchange()

    f = split_cell(device, "P routed x4", flagship(True), items, half,
                   send_cols("StockStream"), "OutStream",
                   (routed, batches_for_rows(routed, half * BATCH)), card,
                   tail_hook=count_exchange)
    f["exchange_launches"] = ring_exchange.launches
    if cuda:
        _require(f["exchange_launches"] >= len(items) - half,
                 f"P routed: {f['exchange_launches']} exchange launches after the "
                 f"restore for {len(items) - half} batches")
        check_exchange_call(f["recorder"], "P routed: exchange after the restore")
    res["routed_x4"] = f
    # cross-layout: the routed revision into the unrouted runtime
    f = split_cell(device, "P routed -> unrouted", flagship(True), items, half,
                   send_cols("StockStream"), "OutStream",
                   (unrouted, batches_for_rows(unrouted, half * BATCH)), card,
                   build_dst=flagship(False), exact=False)
    res["routed_to_unrouted"] = f

    # D1: the [K, H] distinct tables (phase 9's run is the straight one)
    def d1_build(store):
        m = SiddhiManager(device=device)
        m.set_persistence_store(store)
        rt = m.create_siddhi_app_runtime(D1_APP.format(W=WINDOW))
        rt.query_runtimes["bench"].selector_plan.num_keys = KEY_SLOTS
        cb = collector()
        rt.add_callback("OutStream", cb)
        return m, rt, {"OutStream": cb}

    def count_scan():
        distinct_scan.launches = 0
        return recording(at=0)

    f = split_cell(device, "P D1", d1_build, items, half, send_cols("StockStream"),
                   "OutStream", (d1_out, batches_for_rows(d1_out, half * BATCH)),
                   card, tail_hook=count_scan)
    f["scan_launches"] = distinct_scan.launches
    if cuda:
        _require(f["scan_launches"] == len(items) - half,
                 f"P D1: {f['scan_launches']} distinct-scan launches after the "
                 f"restore for {len(items) - half} batches")
        check_scan(f["recorder"].args, f["recorder"].kwargs,
                   "P D1: distinct scan after the restore")
    res["D1"] = f

    # J5: config #5, the 262,144-row time ring; the engine's directories
    # are rebuilt from the rings at the restore
    j5_items, _ids = j5_feed(23, J5_P_PAIRS)

    def j5_build(store):
        m = SiddhiManager(device=device)
        m.set_config_manager(InMemoryConfigManager(
            {"siddhi_tpu.window_capacity": str(J5_CAPACITY)}))
        m.set_persistence_store(store)
        rt = m.create_siddhi_app_runtime(J5_APP)
        cb = collector()
        rt.add_callback("JoinOut", cb)
        return m, rt, {"JoinOut": cb}

    jh = len(j5_items) // 2
    straight = straight_run(device, j5_build, j5_items, jh, send_multi_items, "JoinOut")
    f = split_cell(device, "P J5", j5_build, j5_items, jh, send_multi_items,
                   "JoinOut", straight, card)
    res["J5"] = f

    # N: config #4, 10,000 partition keys, with the high-water marks; its
    # revision goes through a FileSystemPersistenceStore
    n_items = nfa_feed(29, NFA_B_LAT, N_P_PAIRS, TW_BASE, NFA_STEP_MS,
                       independent=False)

    def n_build(store):
        m = SiddhiManager(device=device)
        m.set_config_manager(InMemoryConfigManager({
            "siddhi_tpu.nfa_slots": str(NFA_SLOTS),
            "siddhi_tpu.pipeline_depth": str(NFA_DEPTH)}))
        m.set_persistence_store(store)
        rt = m.create_siddhi_app_runtime(nfa_app(N_PATTERN, N_SELECT))
        q = rt.query_runtimes["nfa"]
        q._win_keys = NFA_KEY_SLOTS
        q.selector_plan.num_keys = NFA_KEY_SLOTS
        cb = collector()
        rt.add_callback("MatchStream", cb)
        return m, rt, {"MatchStream": cb}

    nh = len(n_items) // 2
    straight = straight_run(device, n_build, n_items, nh, send_multi_items,
                            "MatchStream")
    with tempfile.TemporaryDirectory() as tmp:
        f = split_cell(device, "P N", n_build, n_items, nh, send_multi_items,
                       "MatchStream", straight, card,
                       store=FileSystemPersistenceStore(tmp))
    res["N"] = f

    for name, f in res.items():
        f.pop("recorder", None)
        print(f"[persistence] {name}: {f['state_bytes']} state bytes, snapshot "
              f"{f['snapshot_bytes']} bytes, persist {f['persist_ms']:.1f} ms "
              f"({f['d2h_bytes']} bytes device->host), restore "
              f"{f['restore_ms']:.1f} ms ({f['h2d_bytes']} bytes host->device); "
              f"restored state byte-equal ({f['state_bytes_compared']} bytes); "
              f"{f['rows_after_restore']} rows after the restore == the straight "
              f"run (max float rel err {f['worst']:.3g})"
              + (f"; {f['exchange_launches']} exchange launches after the restore, "
                 f"one == plain" if "exchange_launches" in f else "")
              + (f"; {f['scan_launches']} distinct-scan launches after the "
                 f"restore, one == plain" if "scan_launches" in f else "")
              + f" [{card}]", flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------- the serving tier

SV_SHARDS = 4
SV_CLIENTS = 4                  # /query clients during the rebuild and timed
SV_CLIENT_QUERIES = 4           # timed requests a client
SV_STORM = 10                   # clients against the storm's cap
SV_CAP = 4                      # query_queue_cap, as tests/test_serving.py
SV_WORKERS = 2                  # query_workers, as tests/test_serving.py
# phase 21's AG aggregation sharded 4 ways, the global flagship and D1
# (the flagship's shape with distinctCount(volume), H = 64) on one
# stream, behind the REST front door, with statistics and the WAL
SV_APP = """@app:name('serving')
@app:playback
@app:statistics('true')
define stream StockStream (symbol string, price float, volume long, ts long);
define aggregation StockAgg
from StockStream
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume, count() as n,
       min(price) as lo, max(price) as hi
group by symbol
aggregate by ts every sec ... year;
@info(name = 'bench')
from StockStream#window.length({W})
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
group by symbol
insert into OutStream;
""" + "@info(name = 'd1')" + D1_APP.split("@info(name = 'bench')")[1].replace(
    "eventTimestamp() as ts", "eventTimestamp() as ets").replace(
    "insert into OutStream", "insert into D1Stream")
SV_D1_APP = """@app:playback
define stream StockStream (symbol string, price float, volume long, ts long);
""" + "@info(name = 'd1')" + SV_APP.split("@info(name = 'd1')")[1]
SV_CLIENT_FIND = "hour_having"   # the timed clients' find: ~10,000 slots


def http(port: int, method: str, path: str, body=None, raw=None,
         ctype: str = "application/json"):
    """One request to the port's REST service: (status, parsed JSON or
    text, headers)."""
    import urllib.error
    import urllib.request

    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": ctype} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, payload, heads = r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        code, payload, heads = e.code, e.read(), e.headers
    text = payload.decode()
    try:
        return code, json.loads(text), heads
    except ValueError:
        return code, text, heads


def sv_clients(port: int, query: dict, n: int, until=None, per_client: int = 1):
    """``n`` threads POSTing ``query`` to /query: each makes
    ``per_client`` requests, and then more while ``until()`` is false.
    Returns [(status, seconds, body)], every thread joined."""
    import threading

    out, lock = [], threading.Lock()

    def client():
        done = 0
        while done < per_client or (until is not None and not until()):
            t0 = time.perf_counter()
            code, body, _h = http(port, "POST", "/query", query)
            with lock:
                out.append((code, time.perf_counter() - t0, body))
            done += 1

    threads = [threading.Thread(target=client) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    _require(not any(t.is_alive() for t in threads), "serving: a client hung")
    return out


def sv_d1_run(device, feed, detail: bool):
    """D1 alone, fed ``feed`` by send_columns (no REST), optionally under
    ``@app:statistics(level='detail')``; the host syncs of each step after
    the first. Returns (D1's batches, syncs per step)."""
    from siddhi_tpu_torch import SiddhiManager

    app = ("@app:statistics(level='detail')\n" if detail else "") + SV_D1_APP.format(W=WINDOW)
    m = SiddhiManager(device=device)
    rt = m.create_siddhi_app_runtime(app)
    rt.query_runtimes["d1"].selector_plan.num_keys = KEY_SLOTS
    cb = collector()
    rt.add_callback("D1Stream", cb)
    h = rt.get_input_handler("StockStream")
    h.send_columns(feed[0][0], timestamps=feed[0][1])
    sync(device)
    counted = {}
    with (counting_syncs(counted) if device.type == "cuda"
          else contextlib.nullcontext()):
        for cols, ts in feed[1:]:
            h.send_columns(cols, timestamps=ts)
        sync(device)
    m.shutdown()
    return cb.batches, counted.get("syncs", 0) / max(1, len(feed) - 1)


def phase_serving(device, straight, card: str):
    """SV (see the module doc): phase 21's feed as wire frames through the
    REST front door into the sharded aggregation, the global flagship and
    D1. Returns (facts, distinct-scan launches by run, the kernel's max
    error on the recorded call)."""
    import zlib

    import numpy as np

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.core.aggregation.incremental import parse_duration_name
    from siddhi_tpu_torch.core.query.step_graph import StepGraph
    from siddhi_tpu_torch.core.stream.input import wire
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
    from siddhi_tpu_torch.observability import export
    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.service import SiddhiRestService

    t_phase = time.perf_counter()
    feed, _ids = tw_feed(17, AG_BATCHES)
    oracle = agg_oracle(feed)
    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(
        {"siddhi_tpu.agg_shards": str(SV_SHARDS)}))
    m.set_persistence_store(InMemoryPersistenceStore())
    svc = SiddhiRestService(m, query_workers=SV_WORKERS,
                            query_queue_cap=SV_CAP).start()
    port = svc.port
    facts, launches = {"card": card}, {}
    try:
        code, body, _h = http(port, "POST", "/apps", raw=SV_APP.format(W=WINDOW).encode(),
                              ctype="text/plain")
        _require(code == 201, f"serving: POST /apps answered {code}: {body}")
        name = body["app"]
        rt = m.get_siddhi_app_runtime(name)
        for q in ("bench", "d1"):
            rt.query_runtimes[q].selector_plan.num_keys = KEY_SLOTS
        wal = rt.enable_wal()
        agg = rt.aggregations["StockAgg"]
        _require(type(agg).__name__ == "ShardedIncrementalAggregation"
                 and agg.n_shards == SV_SHARDS, "serving: StockAgg is not sharded 4 ways")
        _require(all(s.device == device for s in agg.shards),
                 "serving: a shard is not on the card")
        cbs = {s: collector() for s in ("OutStream", "D1Stream")}
        for s, cb in cbs.items():
            rt.add_callback(s, cb)
        fold_s, route_s, decode_s = [], [], []
        orig_fold, orig_route, orig_decode = agg._fold_batch, agg._route, wire.decode_frame

        def timed(fn, into):
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    into.append(time.perf_counter() - t0)
            return run

        agg._fold_batch = timed(orig_fold, fold_s)
        agg._route = timed(orig_route, route_s)
        wire.decode_frame = timed(orig_decode, decode_s)
        enc = wire.WireEncoder()
        frames = [enc.encode(cols, timestamps=ts) for cols, ts in feed]

        # ingest: one wire frame a batch; checkpoint and persist after 2
        ingest_s, blobs, views, rev = [], None, None, None
        # the flagship and D1 fuse (fan-out fusion, on by default) into one
        # step captured as a CUDA graph: D1's scan is recorded in the graph
        group = rt.query_runtimes["d1"]._fanout_group
        _require(group is not None and group.captured
                 and [q.name for q in group.members] == ["bench", "d1"],
                 "serving: bench and d1 do not run as one captured fan-out group")
        captures0 = StepGraph.total_captures
        distinct_scan.launches = 0
        with recording(at=len(feed) - 1) as rec:
            for i, frame in enumerate(frames):
                def post(frame=frame):
                    code, body, _h = http(port, "POST", "/ingest/StockStream",
                                          raw=frame, ctype="application/octet-stream")
                    _require(code == 200 and body["accepted"] == BATCH,
                             f"serving: POST /ingest answered {code}: {body}")
                t0 = time.perf_counter()
                if i == len(frames) - 1:
                    facts["profile"] = profile_block("SV /ingest frame", post, card,
                                                     tag="serving")
                else:
                    post()
                    sync(device)
                ingest_s.append(time.perf_counter() - t0)
                if i == 1:
                    blobs = agg.checkpoint_shards()
                    t0 = time.perf_counter()
                    code, body, _h = http(port, "POST", f"/apps/{name}/persist")
                    facts["persist_ms"] = (time.perf_counter() - t0) * 1e3
                    _require(code == 200, f"serving: persist answered {code}")
                    rev = body["revision"]
                    d0 = parse_duration_name("sec")
                    views = [agg.shard_device_contents(k, d0) for k in range(SV_SHARDS)]
                    _require(all(agg.shard_device_contents(k, d0) is views[k]
                                 for k in range(SV_SHARDS)),
                             "serving: a device view was not cached between folds")
                if i == 2:
                    _require(all(agg.shard_device_contents(k, d0) is not views[k]
                                 for k in range(SV_SHARDS)),
                             "serving: a device view outlived a fold")
        launches["SV_D1"] = distinct_scan.launches
        captures = StepGraph.total_captures - captures0
        agg._fold_batch, agg._route, wire.decode_frame = orig_fold, orig_route, orig_decode
        _require(launches["SV_D1"] == len(feed) and captures == 1
                 and rec.replays == len(feed) - captures,
                 f"serving: {launches['SV_D1']} distinct-scan launches for {len(feed)} "
                 f"frames, {captures} capture(s), {rec.replays} replays: want one "
                 f"launch a frame (the capture's frame eager, the others replayed)")
        facts["graph_captures"] = captures
        facts["graph_replays"] = rec.replays
        err = check_graph_scan(rec, "SV D1 (recorded call in the graph)")
        facts["d1_eps"] = len(feed) * BATCH / sum(ingest_s[:-1] + ingest_s[-1:])
        facts["fold_ms"] = [x * 1e3 for x in fold_s]
        facts["route_ms"] = [x * 1e3 for x in route_s]
        facts["decode_ms"] = [x * 1e3 for x in decode_s]
        facts["ingest_ms"] = [x * 1e3 for x in ingest_s]
        stats = http(port, "GET", f"/apps/{name}/statistics")[1]
        _require(stats["throughput"]["StockStream"]["events"] == len(feed) * BATCH,
                 f"serving: statistics count {stats['throughput']['StockStream']} "
                 f"for {len(feed) * BATCH} rows sent")

        # the stores: merged == phase 21's unsharded == the oracle, and
        # every (bucket, group) on its crc32 owner
        dic = rt.app_context.string_dictionary
        slots = 0
        for s in agg.shards:
            for d, dstore in s.store.items():
                for b, groups in dstore.items():
                    for g in groups:
                        _require(zlib.crc32(repr(g).encode()) % SV_SHARDS == s.index
                                 and isinstance(g[0], int),
                                 f"serving: ({b}, {g}) on shard {s.index}")
                        slots += 1
        for d in AG_DURATIONS:
            got = agg_rows(rt, d)
            _require(got == straight["stores"][d],
                     f"serving: the merged {d} store differs from phase 21's unsharded")
            want = sorted((b, s, *v) for (b, s), v in oracle[d].items())
            rows_close(got, want, f"serving {d} store",
                       rtol=(0, 0, FLOAT_RTOL, 0, 0, 0.0, 0.0))
        facts["slots"] = slots
        # the device views at the last fold == the columnized rows
        for k in range(SV_SHARDS):
            _d, cols, valid = agg.shard_device_contents(k, d0)
            _d2, want, want_valid = agg._columnize(
                agg._rows_from_items(agg.shards[k].partials(d0)))
            _require(valid.device == device and all(t.device == device for t in cols.values()),
                     f"serving: shard {k}'s view is not on the card")
            _require(np.array_equal(valid.cpu().numpy(), want_valid)
                     and all(np.array_equal(cols[c].cpu().numpy(), want[c]) for c in want),
                     f"serving: shard {k}'s device view differs from its rows")

        # the six finds through POST /query == phase 21's unsharded finds
        find_ms = {}
        for fname, text in AG_FINDS.items():
            q = text.format(T0=AG_T0, T1=AG_T1, TM=AG_T0 + ag_mid_ms(feed), V=AG_DAY_VOLUME)
            t0 = time.perf_counter()
            code, body, _h = http(port, "POST", "/query", {"app": name, "query": q})
            find_ms[fname] = (time.perf_counter() - t0) * 1e3
            _require(code == 200, f"serving: find {fname} answered {code}: {body}")
            got = [tuple(r) for r in body["rows"]]
            if fname == "sec_all":
                got = sorted(got)
            _require(got == straight["finds"][fname],
                     f"serving: find {fname} differs from phase 21's unsharded find")
        facts["find_ms"] = find_ms
        client_q = {"app": name, "query": AG_FINDS[SV_CLIENT_FIND].format(
            T0=AG_T0, T1=AG_T1)}
        timed_q = sv_clients(port, client_q, SV_CLIENTS, per_client=SV_CLIENT_QUERIES)
        ok = sorted(sec for code, sec, _b in timed_q if code == 200)
        _require(len(ok) == len(timed_q), "serving: a timed /query was not answered 200")
        facts["query_ms"] = {"p50": quantile_ms(ok, 50), "p99": quantile_ms(ok, 99),
                             "n": len(ok), "clients": SV_CLIENTS}

        # shards: kill one after batch 4 and rebuild it from batch 2's
        # blob plus its WAL suffix while four clients query
        k = SV_SHARDS - 1
        before = agg._ser_store(agg.shards[k].store)
        suffix = len(agg.shards[k].wal.records_after(blobs[k]["cut"]))
        agg.kill_shard(k)
        done = []

        def rebuild():
            t0 = time.perf_counter()
            facts["replayed"] = agg.rebuild_shard(k, blobs[k])
            facts["rebuild_ms"] = (time.perf_counter() - t0) * 1e3
            done.append(True)

        import threading

        th = threading.Thread(target=rebuild)
        th.start()
        during = sv_clients(port, client_q, SV_CLIENTS, until=lambda: bool(done))
        th.join(600)
        _require(done, "serving: the rebuild did not finish")
        codes = {c for c, _s, _b in during}
        _require(codes <= {200, 503} and 200 in codes,
                 f"serving: /query during the rebuild answered {sorted(codes)}")
        _require(facts["replayed"] == suffix == len(feed) - 2,
                 f"serving: rebuild replayed {facts['replayed']} records, shard {k}'s "
                 f"WAL holds {suffix} after its cut")
        _require(agg._ser_store(agg.shards[k].store) == before,
                 f"serving: shard {k} after its rebuild differs from before the kill")

        # storm: shard 0's partials gated, 10 clients against a cap of 4
        gate = threading.Event()
        orig_partials = agg.shards[0].partials
        agg.shards[0].partials = lambda d: (gate.wait(60), orig_partials(d))[1]
        storm_q = {"app": name, "query": "from StockAgg within {}L, {}L per 'years' "
                   "select symbol, n".format(AG_T0, AG_T1)}
        storm, lock = [], threading.Lock()

        def storm_client():
            code, body, _h = http(port, "POST", "/query", storm_q)
            with lock:
                storm.append((code, 0.0, body))

        threads = [threading.Thread(target=storm_client) for _ in range(SV_STORM)]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 60
        # the gate opens once every request past the cap has been answered
        while (sum(c == 503 for c, _s, _b in storm) < SV_STORM - SV_CAP
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(600)
        _require(not any(t.is_alive() for t in threads), "serving: a storm client hung")
        agg.shards[0].partials = orig_partials
        codes = [c for c, _s, _b in storm]
        _require(set(codes) <= {200, 503} and 503 in codes,
                 f"serving: the storm answered {sorted(codes)}")
        _require(all(b.get("shed") is True for c, _s, b in storm if c == 503),
                 "serving: a 503 without the shed marker")
        metrics = http(port, "GET", "/metrics?format=json")[1]
        counters = metrics["apps"][name]["statistics"]["counters"]
        _require(metrics["process"]["counters"]["serving.sheds"] >= 1
                 and counters["resilience.query_sheds"] >= 1
                 and counters["resilience.shard_rebuilds"] == 1,
                 f"serving: /metrics counters {counters}")
        text = http(port, "GET", "/metrics")[1]
        _require(export.AGGREGATION_SHARDS_FAMILY in text
                 and export._SERVING_HIST_FAMILY["serving.fanout_ms"][0] in text,
                 "serving: /metrics lacks the serving families")
        tel = metrics["apps"][name]["telemetry"]["histograms"]
        facts["fanout_ms"] = {q: tel["serving.fanout_ms"][q] for q in ("p50", "p99")}
        facts["merge_ms"] = {q: tel["serving.merge_ms"][q] for q in ("p50", "p99")}
        facts["storm"] = {"200": codes.count(200), "503": codes.count(503)}
        # the autopilot's and the fabric's routes answer as the reference's
        # (ported since PR 17; 501 before): the report with this app not
        # registered, 404 for the app, 404 with no fabric attached; the
        # critical-path report (ported with the observability tier) 200
        code, body, _h = http(port, "GET", "/autopilot")
        _require(code == 200 and len(body["actuators"]) == 6 and name not in body["apps"],
                 f"serving: /autopilot answered {code}: {body}")
        code, body, _h = http(port, "GET", f"/autopilot/{name}")
        _require(code == 404 and "autopilot control" in body["error"],
                 f"serving: /autopilot/{name} answered {code}: {body}")
        code, body, _h = http(port, "GET", "/cluster")
        _require(code == 404 and "no cluster fabric" in body["error"],
                 f"serving: /cluster answered {code}: {body}")
        code, body, _h = http(port, "GET", f"/profile/critical_path/{name}")
        _require(code == 200 and name in body["apps"],
                 f"serving: /profile/critical_path answered {code}: {body}")
        # the group's step holds a program-cache entry, served at /programs
        code, body, _h = http(port, "GET", "/programs")
        _require(code == 200 and {"programs", "clusters", "cache"} <= set(body)
                 and any(e["family"] == "fused_fanout" and name in e["shared_by"]
                         and e["captured"] for e in body["cache"]["entries"]),
                 f"serving: /programs answered {code}: {body}")
        facts["programs_entries"] = len(body["cache"]["entries"])

        # effectively-once: restore batch 2's revision; the WAL replays 3-4
        facts["wal_bytes"] = sum(np.asarray(v).nbytes for r in wal._log
                                 for v in list(r.payload.values()) + [r.timestamps])
        _require(len(wal) == len(feed) - 2, f"serving: the WAL holds {len(wal)} batches")
        state_before = rt.snapshot()
        stores_before = {d: agg_rows(rt, d) for d in AG_DURATIONS}
        n_d1 = len(cbs["D1Stream"].batches)
        distinct_scan.launches = 0
        captures0 = StepGraph.total_captures
        t0 = time.perf_counter()
        code, body, _h = http(port, "POST", f"/apps/{name}/restore", {"revision": rev})
        sync(device)
        facts["restore_replay_ms"] = (time.perf_counter() - t0) * 1e3
        launches["SV_replay"] = distinct_scan.launches
        _require(code == 200, f"serving: restore answered {code}: {body}")
        # the restore made the group a new step; its entry had one sharer,
        # so the new step's graph is captured once (its frame eager)
        recaptures = StepGraph.total_captures - captures0
        _require(recaptures == 1 and launches["SV_replay"] == len(feed) - 2,
                 f"serving: {launches['SV_replay']} distinct-scan launches and "
                 f"{recaptures} re-captures in the replay")
        first = concat_rows(cbs["D1Stream"].batches[2:n_d1])
        again = concat_rows(cbs["D1Stream"].batches[n_d1:])
        require_equal(again, first, "serving: D1's replayed rows")
        require_same_state(state_before, rt, "serving: the state after the replay")
        _require({d: agg_rows(rt, d) for d in AG_DURATIONS} == stores_before,
                 "serving: the stores after the replay")
        d1_rest = cbs["D1Stream"].batches[:n_d1]
    finally:
        svc.stop()
        m.shutdown()

    # D1 without REST, and at statistics 'detail': the same rows, and no
    # host sync added by the statistics hooks
    d1_plain, syncs = sv_d1_run(device, feed, detail=False)
    d1_detail, syncs_detail = sv_d1_run(device, feed, detail=True)
    require_equal(concat_rows(d1_rest), concat_rows(d1_plain),
                  "serving: D1 through the front door vs send_columns")
    require_equal(concat_rows(d1_detail), concat_rows(d1_plain),
                  "serving: D1 at statistics detail")
    _require(syncs_detail == syncs, f"serving: {syncs_detail} host syncs a D1 step at "
             f"statistics detail, {syncs} without")
    facts["d1_syncs_per_step"] = {"plain": syncs, "detail": syncs_detail}
    facts["phase_s"] = time.perf_counter() - t_phase
    print(f"[serving] SV: StockAgg over {SV_SHARDS} shards + the global flagship + D1 "
          f"behind POST /ingest ({len(feed)} wire frames of {BATCH} rows, "
          f"{NUM_SYMBOLS} symbols): sharded fold ms a batch "
          f"{', '.join(f'{x:.0f}' for x in facts['fold_ms'])} (host; unsharded, "
          f"phase 21: {', '.join(f'{x:.0f}' for x in straight['fold_ms'])}), routing ms "
          f"{', '.join(f'{x:.1f}' for x in facts['route_ms'])}, decode ms "
          f"{', '.join(f'{x:.1f}' for x in facts['decode_ms'])}, /ingest ms a frame "
          f"{', '.join(f'{x:.0f}' for x in facts['ingest_ms'])}; D1 through the front "
          f"door {facts['d1_eps']:.1f} events/s; {slots} (bucket, group) slots, each on "
          f"its crc32 owner, merged == phase 21 == the oracle; six finds via /query == "
          f"phase 21 in ms {', '.join(f'{a} {b:.0f}' for a, b in find_ms.items())}; "
          f"/query ({SV_CLIENT_FIND}) under {SV_CLIENTS} clients p50 "
          f"{facts['query_ms']['p50']:.1f} ms p99 {facts['query_ms']['p99']:.1f} ms; "
          f"fan-out p50 {facts['fanout_ms']['p50']:.2f} ms, merge p50 "
          f"{facts['merge_ms']['p50']:.1f} ms [{card}]", flush=True)
    print(f"[serving] shard {SV_SHARDS - 1} rebuilt in {facts['rebuild_ms']:.0f} ms "
          f"replaying {facts['replayed']} records == before the kill, /query during it "
          f"200/503 only; storm of {SV_STORM} against a cap of {SV_CAP}: "
          f"{facts['storm']}; persist {facts['persist_ms']:.0f} ms, restore + replay of "
          f"{len(feed) - 2} batches {facts['restore_replay_ms']:.0f} ms "
          f"({facts['wal_bytes']} WAL bytes), D1's replayed rows bit-equal, the state "
          f"and stores == before the restore; D1 == the no-REST run; host syncs a D1 "
          f"step {syncs:.2f} without statistics, {syncs_detail:.2f} at detail; the "
          f"distinct scan in the captured graph (bench + d1 fused, {facts['graph_captures']} "
          f"capture(s), re-captured once after the restore) == plain on the last "
          f"frame's call; phase {facts['phase_s']:.1f} s [{card}]", flush=True)
    return facts, launches, err


# ------------------------------------------------------- 23. fan-out fusion

EX_RECORD_AT = 2        # phase 4: the exchange call (batch 3, a replay) held against plain
FO_OUTS = tuple(f"O{i}" for i in range(7))
FO_RECORD_AT = 2        # the replay whose distinct-scan call is held against plain
FO_SPLIT = 4            # batches before the revisions of the restore checks
FO_DEPTHS = (1, 4)
FJ_PAIRS = 12           # L and R batches of JB's shape: a cut of depth, as P's J5
FJ_SIBLING = ("@info(name = 'fj_sib') from L select sym, lv * 2 as dbl "
              "insert into F1;\n")
# FX: EXPIRED rows stamped with the clock, which a captured step takes as
# a tensor (under @app:playback the clock is the event time: both runs
# see the same one)
FX_APP = """@app:playback
define stream StockStream (symbol string, price float, volume long);
@info(name = 'x0') from StockStream#window.length({W})
select symbol, price, currentTimeMillis() as t insert all events into X0;
@info(name = 'x1') from StockStream#window.length({W})
select symbol, sum(volume) as v group by symbol insert all events into X1;
"""
FX_BATCHES = 3


def fo_app(async_: bool = False) -> str:
    """FO: seven sibling queries on StockStream, subscribed in this order:
    q0-q3 the global flagship (``GLOBAL_APP``, into O0-O3), q4 the twin
    (``TWIN_APP``), q5 D1 (``D1_APP``, H = 64) and q6 a filter."""
    flag = GLOBAL_APP.split("@info(name = 'bench')")[1].format(W=WINDOW)
    twin = TWIN_APP.split("@info(name = 'flagship')")[1]
    d1 = D1_APP.split("@info(name = 'bench')")[1].format(W=WINDOW)
    q6 = "\nfrom StockStream[volume > 500] select symbol, price * volume as notional\n" \
         "insert into OutStream;\n"
    body = [flag] * 4 + [twin, d1, q6]
    head = "@Async(buffer.size='64')\n" if async_ else ""
    return head + "define stream StockStream (symbol string, price float, volume long);\n" \
        + "".join(f"@info(name = 'q{i}')" + q.replace("insert into OutStream", f"insert into O{i}")
                  for i, q in enumerate(body))


class FoRun:
    """One FO runtime on ``device``: fused or not, at a pump depth (@Async
    above 1, so batches really ride in flight), key slots pre-sized as the
    flagship's; per-output-stream collectors."""

    def __init__(self, device, fused: bool = True, depth: int = 1):
        from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

        self.device, self.depth = device, depth
        self.m = SiddhiManager(device=device)
        self.m.set_config_manager(InMemoryConfigManager({
            "siddhi_tpu.fuse_fanout": "true" if fused else "false",
            "siddhi_tpu.pipeline_depth": str(depth)}))
        self.rt = self.m.create_siddhi_app_runtime(fo_app(async_=depth > 1))
        for q in self.rt.query_runtimes.values():
            if q.keyer is not None:
                q.selector_plan.num_keys = KEY_SLOTS
        self.cbs = {s: collector() for s in FO_OUTS}
        for s, cb in self.cbs.items():
            self.rt.add_callback(s, cb)
        self.h = self.rt.get_input_handler("StockStream")
        self.group = (self.rt.fused_fanout_groups[0] if self.rt.fused_fanout_groups
                      else None)
        self.sent = 0

    def rows_expected(self, n_batches):
        return n_batches * BATCH     # q0-q3 and q5 emit a row per row in

    def send(self, batches):
        """Send ``batches``; per-batch seconds at depth 1 (the card
        synchronised after each), else the wall from the first send until
        O0 holds every row (the other outputs are then drained too)."""
        import torch

        if self.depth == 1:
            return send_timed(self.h, batches, self.device)
        t0 = time.perf_counter()
        for cols, ts in batches:
            self.h.send_columns(cols, timestamps=ts)
        self.sent += len(batches)
        wait_rows(self.cbs["O0"], self.rows_expected(self.sent), "FO @Async")
        self.rt.app_context.completion_pump.flush()
        torch.cuda.synchronize()
        return [time.perf_counter() - t0]

    def outputs(self):
        return {s: cb.batches for s, cb in self.cbs.items()}

    def close(self):
        self.m.shutdown()
        return self.outputs()


def fo_compare(a, b, what: str):
    """FO's outputs member by member: ints, strings, timestamps, types and
    order exactly, floats to rtol 1e-12. Returns the largest float abs
    difference (bit-equality is expected)."""
    import numpy as np

    worst = 0.0
    for s in FO_OUTS:
        x, y = concat_rows(a[s]), concat_rows(b[s])
        compare_outputs(x, y, f"{what} ({s})")
        for u, v in zip(x, y):
            for k in u:
                if u[k].dtype.kind == "f":
                    worst = max(worst, float(np.max(np.abs(u[k] - v[k]), initial=0.0)))
    return worst


def profile_batch(label: str, fn, card: str):
    """torch.profiler over one batch: the host's launch calls by CUDA API
    (a replay is one ``cudaGraphLaunch``), the kernels and copies the card
    ran, its busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    api = {}
    for e in events:
        if e.key.startswith(("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpy",
                             "cudaMemset", "cuLaunchKernel")):
            api[e.key] = api.get(e.key, 0) + e.count
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    _require(dev_us > 0, f"profile {label}: no device time seen")
    facts = {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
             "busy_share": dev_us / 1e6 / wall, "device_ops": sum(e.count for e in dev),
             "host_launch_calls": sum(api.values()), "host_api": api}
    print(f"[fanout] profile {label}: wall {facts['wall_ms']:.2f} ms, device busy "
          f"{facts['device_ms']:.3f} ms ({100 * facts['busy_share']:.1f}% of wall), "
          f"{facts['device_ops']} device kernels and copies, "
          f"{facts['host_launch_calls']} host launch calls {api} [{card}]", flush=True)
    return facts


def fj_oracle(sends, window: int):
    """A numpy hash join per send over JB's length windows: the rows of a
    batch joined with the other side's last ``window`` rows on sym, as a
    multiset of (sym, lv, rv)."""
    import collections

    import numpy as np

    held = {"L": [], "R": []}
    out = []
    for side, (cols, _ts) in sends:
        other = held["R" if side == "L" else "L"]
        by_sym = collections.defaultdict(list)
        for sym, v in other:
            by_sym[sym].append(v)
        vals = cols["lv" if side == "L" else "rv"]
        rows = collections.Counter()
        for sym, v in zip(cols["sym"], vals):
            for w in by_sym.get(sym, ()):
                rows[(sym, int(v), w) if side == "L" else (sym, w, int(v))] += 1
        out.append(rows)
        held[side] = (held[side] + list(zip(cols["sym"], (int(x) for x in vals))))[-window:]
    return out


def fj_run(device, sends, fused: bool):
    """FJ: JB's app (length windows both sides on the engine) with a plain
    sibling on L: the L side's proxy fuses with the sibling. Returns (the
    join's rows a send as multisets, the sibling's columns, facts)."""
    import collections

    import numpy as np

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager({
        "siddhi_tpu.fuse_fanout": "true" if fused else "false",
        "siddhi_tpu.pipeline_depth": "1",
        "siddhi_tpu.window_capacity": str(JB_WINDOW)}))
    rt = m.create_siddhi_app_runtime(JB_APP.format(W=JB_WINDOW) + FJ_SIBLING)
    dic = rt.app_context.string_dictionary
    jcb, scb = collector(), collector()
    rt.add_callback("JoinOut", jcb)
    rt.add_callback("F1", scb)
    h = {s: rt.get_input_handler(s) for s in ("L", "R")}
    facts = {}
    group = rt.fused_fanout_groups[0] if rt.fused_fanout_groups else None
    if fused:
        _require(group is not None and [q.name for q in group.members] == ["jb.left", "fj_sib"],
                 "FJ: the join's L side and the sibling do not form one group")
        _require(not group.captured and not group.capturable(),
                 "FJ: a group holding a join side must run eagerly")
        facts["captured"] = rt.app_context.telemetry.read_gauges()["fanout.L.captured"]
        _require(facts["captured"] == 0, "FJ: the captured gauge reads a graph")
    per_send = []
    t0 = time.perf_counter()
    for side, (cols, ts) in sends:
        n0 = len(jcb.batches)
        h[side].send_columns(cols, timestamps=ts)
        rows = collections.Counter()
        for b in jcb.batches[n0:]:
            syms = [dic.decode(int(i)) for i in b["sym"]]
            rows.update(zip(syms, (int(x) for x in b["lv"]), (int(x) for x in b["rv"])))
        per_send.append(rows)
    sync(device)
    facts["eps"] = len(sends) * JB_BATCH / (time.perf_counter() - t0)
    if group is not None:
        tel = rt.app_context.telemetry.snapshot()
        facts["dispatches"] = tel["counters"]["fanout.L.dispatches"]
        facts["meta_pulls"] = tel["counters"]["fanout.L.meta_pulls"]
    m.shutdown()
    return per_send, concat_rows(scb.batches), facts


def fx_run(device, batches, fused: bool):
    """FX over ``batches``: ({stream: its rows as one batch of columns},
    whether the group ran as a graph)."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager({
        "siddhi_tpu.fuse_fanout": "true" if fused else "false",
        "siddhi_tpu.pipeline_depth": "1"}))
    rt = m.create_siddhi_app_runtime(FX_APP.format(W=WINDOW))
    rt.query_runtimes["x1"].selector_plan.num_keys = KEY_SLOTS
    cbs = {s: collector() for s in ("X0", "X1")}
    for s, cb in cbs.items():
        rt.add_callback(s, cb)
    send_timed(rt.get_input_handler("StockStream"), batches, device)
    captured = bool(rt.fused_fanout_groups) and rt.fused_fanout_groups[0].captured
    m.shutdown()
    return {s: concat_rows(cb.batches) for s, cb in cbs.items()}, captured


def earlier_groups(device):
    """Which apps of phases 1-22 form fan-out groups now that fusion is on
    by default: {label: [[stream, members...], ...]} of every app that has
    one (the others form none)."""
    from siddhi_tpu_torch import SiddhiManager

    apps = {
        "slice (4)": APP.format(W=WINDOW), "global (5)": GLOBAL_APP.format(W=WINDOW),
        "twin (6)": TWIN_APP, "pipeline (10)": PIPE_APP.format(W=WINDOW),
        "D1 (9)": D1_APP.format(W=WINDOW), "D2 (9)": D2_APP.format(W=WINDOW),
        "S (9)": S_APP.format(W=WINDOW), "D4 (16)": D4_APP.format(W=D4_WINDOW),
        "T (17)": T_APP.format(T="1 min"), "ET (17)": ET_APP.format(T="1 min"),
        "TD (17)": TD_APP.format(T="1 min"), "TB (17)": TB_APP, "LB (17)": LB_APP,
        "L (17)": L_APP, "H (17)": H_APP, "F (17)": F_APP, "R (17)": R_APP,
        "PT (18)": PT_APP.format(T="1 min"), "PET (18)": PET_APP.format(T="1 min"),
        "PS (18)": PS_APP.format(G="1 sec"), "PLB (18)": PLB_APP, "PR (18)": PR_APP,
        "PI (18)": PI_APP, "N (19)": nfa_app(N_PATTERN, N_SELECT),
        "J5 (20)": J5_APP, "JB (20)": JB_APP.format(W=JB_WINDOW), "TJ (20)": TJ_APP,
        "store (20)": STORE_APP,
        "AG (21)": AG_APP.format(W=WINDOW, T0=AG_T0, T1=AG_T1),
        "SV (22)": SV_APP.format(W=WINDOW), "SV D1 (22)": SV_D1_APP.format(W=WINDOW),
    }
    found = {}
    for label, app in apps.items():
        m = SiddhiManager(device=device)
        rt = m.create_siddhi_app_runtime(app)
        groups = [[g.stream_id] + [q.name for q in g.members]
                  for g in rt.fused_fanout_groups]
        if groups:
            found[label] = groups
        m.shutdown()
    return found


def phase_fanout(device, feed, card: str):
    """Phase 23 (see the module doc): FO fused and captured against
    unfused, the restores across fusion, FJ. Returns (facts, the
    distinct-scan launches of the main run, the recorded call's max
    error)."""
    import numpy as np
    import torch

    from siddhi_tpu_torch.core.query.step_graph import StepGraph
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    t_phase = time.perf_counter()
    facts = {"card": card}
    facts["earlier_groups"] = earlier_groups(device)
    print(f"[fanout] earlier phases' apps that form fan-out groups: "
          f"{facts['earlier_groups']} (every other app of phases 1-22 forms none)",
          flush=True)

    # FO fused and captured, depth 1: the main path of this slice
    fo = FoRun(device)
    g = fo.group
    _require(g is not None and [q.name for q in g.members] == [f"q{i}" for i in range(7)],
             "FO: the seven siblings do not form one group")
    _require(g.captured, "FO: the group does not run as a CUDA graph")
    distinct_scan.launches = 0
    with recording(at=FO_RECORD_AT) as rec:
        fused_s = fo.send(feed)
    main_launches = distinct_scan.launches
    tel = fo.rt.app_context.telemetry.snapshot()
    gauges = tel["gauges"]
    q = fo.rt.query_runtimes
    facts["group"] = {k: gauges[f"fanout.StockStream.{k}"]
                      for k in ("group_size", "unique_programs", "captured")}
    _require(facts["group"] == {"group_size": 7, "unique_programs": 4, "captured": 1},
             f"FO: gauges {facts['group']}")
    _require([len(c) for c in g._clusters] == [4, 1, 1, 1]
             and all(q[f"q{i}"]._state is q["q0"]._state for i in range(4)),
             f"FO: clusters {g._clusters}")
    n = len(feed)
    disp, pulls = (tel["counters"][f"fanout.StockStream.{k}"]
                   for k in ("dispatches", "meta_pulls"))
    jit = tel["jit"]["fanout.StockStream.step"]
    facts.update(dispatches=disp, meta_pulls=pulls, jit=jit, captures=g.graph.captures,
                 replays=g.graph.replays, capture_ms=g.graph.capture_ms,
                 pool_bytes=g.graph.pool_bytes, scan_launches=main_launches)
    _require(disp == pulls == n, f"FO: {disp} dispatches and {pulls} meta pulls "
             f"for {n} batches")
    _require(jit["compiles"] == g.graph.captures == 1 and jit["hits"] == 7 * n,
             f"FO: jit record {jit} for {g.graph.captures} capture(s) of {n} batches")
    # the batch that captures runs eagerly, the others replay: one launch a batch
    _require(g.graph.replays == n - g.graph.captures and main_launches == n,
             f"FO: {main_launches} distinct-scan launches for {g.graph.replays} "
             f"replays and {g.graph.captures} capture(s)")
    _require(rec.replays == g.graph.replays, f"FO: {rec.replays} replays ran the "
             f"recorded scan, of {g.graph.replays}")
    scan_err = check_graph_scan(rec, "FO D1 (recorded call in the graph)")
    fused1 = fo.close()
    for s in FO_OUTS[:4] + FO_OUTS[5:6]:
        _require(sum(len(b["__ts__"]) for b in fused1[s]) == n * BATCH,
                 f"FO: {s} holds other than one row per row in")
    for s in FO_OUTS[1:4]:
        compare_outputs(concat_rows(fused1[s]), concat_rows(fused1["O0"]),
                        f"FO: {s} vs O0")
    for s in FO_OUTS:
        require_finite(fused1[s], f"FO {s}")

    # unfused, depth 1
    un = FoRun(device, fused=False)
    _require(un.group is None, "FO: fuse_fanout=false still fused")
    unfused_s = un.send(feed)
    unfused1 = un.close()
    facts["max_abs_diff"] = fo_compare(fused1, unfused1, "FO fused+captured vs unfused")
    facts["eps"] = {"fused_1": steady_eps(fused_s, BATCH),
                    "unfused_1": steady_eps(unfused_s, BATCH)}

    # depth 4 (@Async): fused == depth 1; both timed over batches 2..n
    for fused in (True, False):
        r = FoRun(device, fused=fused, depth=4)
        r.send(feed[:1])
        wall = r.send(feed[1:])[0]
        if fused:
            _require(r.group.captured, "FO @Async: the group is not captured")
            facts["high_water"] = r.rt.app_context.completion_pump.high_water
        out = r.close()
        facts["eps"][f"{'fused' if fused else 'unfused'}_4"] = (n - 1) * BATCH / wall
        if fused:
            facts["max_abs_diff_depth4"] = fo_compare(out, fused1, "FO depth 4 vs depth 1")

    # FX: the EXPIRED rows' timestamps (the clock) under the capture
    fx = {fused: fx_run(device, feed[:FX_BATCHES], fused) for fused in (True, False)}
    _require(fx[True][1], "FX: the group is not captured")
    fx = {fused: out for fused, (out, _captured) in fx.items()}
    for s in ("X0", "X1"):
        compare_outputs(fx[True][s], fx[False][s], f"FX {s} fused+captured vs unfused")
    x0 = fx[True]["X0"][0]
    n_rows = FX_BATCHES * BATCH
    _require(len(x0["__ts__"]) == 2 * n_rows - WINDOW
             and len(set(x0["t"].tolist())) == FX_BATCHES,
             f"FX: {len(x0['__ts__'])} rows, clock values {sorted(set(x0['t'].tolist()))}")
    facts["FX_rows"] = len(x0["__ts__"])

    # launches a batch, host syncs a batch, busy share
    for fused in (True, False):
        r = FoRun(device, fused=fused)
        r.send(feed[:2])
        label = "fused" if fused else "unfused"
        facts[f"profile_{label}"] = profile_batch(
            f"FO {label}, one batch", lambda r=r: r.send(feed[2:3]), card)
        sy = {}
        with counting_syncs(sy):
            r.send(feed[3:5])
        facts[f"syncs_{label}"] = sy["syncs"] / 2
        facts[f"sync_sites_{label}"] = sy["sync_sites"]
        r.close()

    # restores across fusion, each into a runtime that already ran the
    # head: the unfused revision into the fused one, the fused revision
    # into the unfused one; the rest of the feed == the straight run
    restores = {}
    for src_fused in (False, True):
        src, dst = FoRun(device, fused=src_fused), FoRun(device, fused=not src_fused)
        src.send(feed[:FO_SPLIT])
        dst.send(feed[:FO_SPLIT])
        blob = src.rt.snapshot()
        src.close()
        # the group's program-cache entry has one sharer, so the restore's
        # new step makes a new entry: its graph is captured once (the
        # unfused runtime's single steps likewise)
        cap0 = StepGraph.total_captures
        dst.rt.restore(blob)
        n0 = {s: len(cb.batches) for s, cb in dst.cbs.items()}
        dst.send(feed[FO_SPLIT:])
        tail = {s: cb.batches[n0[s]:] for s, cb in dst.cbs.items()}
        recaptures = (StepGraph.total_captures - cap0) if dst.group is not None else None
        dst.close()
        want = {s: b[FO_SPLIT:] for s, b in unfused1.items()}
        key = "unfused_into_fused" if not src_fused else "fused_into_unfused"
        restores[key] = {"max_abs_diff": fo_compare(tail, want, f"FO restore {key}"),
                         "recaptures": recaptures, "revision_bytes": len(blob)}
        if dst.group is not None:
            _require(recaptures == 1, f"FO restore {key}: {recaptures} re-captures")
    facts["restores"] = restores

    # FJ: JB's join with a sibling on L: the group runs eagerly
    rng = np.random.default_rng(29)
    syms = np.array([f"S{i}" for i in range(JB_KEYS)], dtype=object)
    sends = []
    for i in range(2 * FJ_PAIRS):
        side = "L" if i % 2 == 0 else "R"
        sends.append((side, ({"sym": syms[rng.integers(0, JB_KEYS, JB_BATCH)],
                              ("lv" if side == "L" else "rv"):
                                  rng.integers(0, 1000, JB_BATCH, dtype=np.int64)},
                             np.arange(i * JB_BATCH, (i + 1) * JB_BATCH, dtype=np.int64))))
    fj_f, sib_f, fj_facts = fj_run(device, sends, fused=True)
    fj_u, sib_u, _ = fj_run(device, sends, fused=False)
    oracle = fj_oracle(sends, JB_WINDOW)
    _require(fj_f == fj_u == oracle, "FJ: the fused join's rows differ from the "
             "unfused run's or from the numpy hash join")
    compare_outputs(sib_f, sib_u, "FJ sibling fused vs unfused")
    _require(fj_facts["dispatches"] == fj_facts["meta_pulls"] == FJ_PAIRS,
             f"FJ: {fj_facts}")
    fj_facts["rows"] = sum(sum(c.values()) for c in oracle)
    facts["FJ"] = fj_facts
    facts["phase_s"] = time.perf_counter() - t_phase
    e = facts["eps"]
    pf, pu = facts["profile_fused"], facts["profile_unfused"]
    print(f"[fanout] FO: seven siblings (4x the global flagship, the twin, D1, a "
          f"filter) on StockStream, {n} batches of {BATCH} rows, {NUM_SYMBOLS} "
          f"symbols: one group of {facts['group']['group_size']}, "
          f"{facts['group']['unique_programs']} unique programs, captured; "
          f"{disp} dispatches and {pulls} meta pulls; jit {jit}; {facts['captures']} "
          f"capture in {facts['capture_ms']:.1f} ms, graph pool "
          f"{facts['pool_bytes']} bytes; fused+captured == unfused member by member "
          f"(max float abs diff {facts['max_abs_diff']:.3g}), q0-q3 equal; depth 4 == "
          f"depth 1 (max abs diff {facts['max_abs_diff_depth4']:.3g}); FX's "
          f"{facts['FX_rows']} rows with EXPIRED ones stamped by the clock == "
          f"unfused; D1's scan in "
          f"the graph == plain on replay {FO_RECORD_AT}; events/s fused "
          f"{e['fused_1']:.1f} vs unfused {e['unfused_1']:.1f} at depth 1, "
          f"{e['fused_4']:.1f} vs {e['unfused_4']:.1f} at depth 4; a batch: "
          f"{pf['host_launch_calls']} host launch calls and {pf['device_ops']} device "
          f"ops fused, {pu['host_launch_calls']} and {pu['device_ops']} unfused; busy "
          f"share {pf['busy_share']:.3f} fused, {pu['busy_share']:.3f} unfused; host "
          f"syncs a batch {facts['syncs_fused']:.1f} fused, "
          f"{facts['syncs_unfused']:.1f} unfused [{card}]", flush=True)
    print(f"[fanout] restores across fusion after batch {FO_SPLIT}: {restores}; FJ "
          f"(JB's join + a sibling on L, {FJ_PAIRS} pairs, eager, captured 0): rows "
          f"== unfused == numpy hash join ({fj_facts['rows']} rows), "
          f"{fj_facts['dispatches']} dispatches, {fj_facts['eps']:.1f} events/s; "
          f"phase {facts['phase_s']:.1f} s [{card}]", flush=True)
    return facts, main_launches, scan_err


PC_BATCHES = 4                  # each app's seeded feed
PC_FLAGSHIPS = 4                # global flagship apps; D1 apps: 2
PC_RESTORE_APP = 1              # app 2 restores its own revision halfway
PC_SEEDS = (41, 42, 43, 44, 45, 46)


def pc_apps(device, cache_on: bool):
    """Phase 24's six apps on ``device``: four global flagships and two
    D1s, each under its own name, the program cache on or off; key slots
    pre-sized as the flagship's. Returns (manager, [(runtime, query,
    collector)])."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(
        {"siddhi_tpu.program_cache": "true" if cache_on else "false",
         "siddhi_tpu.pipeline_depth": "1"}))
    apps = []
    for i in range(PC_FLAGSHIPS + 2):
        body = (GLOBAL_APP if i < PC_FLAGSHIPS else D1_APP).format(W=WINDOW)
        rt = m.create_siddhi_app_runtime(f"@app:name('pc{i}')\n" + body)
        q = rt.query_runtimes["bench"]
        q.selector_plan.num_keys = KEY_SLOTS
        cb = collector()
        rt.add_callback("OutStream", cb)
        apps.append((rt, q, cb))
    return m, apps


@contextlib.contextmanager
def eager_beside_replays(device, checks: list):
    """Around every batch of a query step in graph mode (a replay, or the
    batch that captures): the eager step on a clone of the same state and
    device copies of the same columns; the batch's valid output rows, its
    meta and the state after must equal the eager run's bit for bit.
    Appends one count a checked batch."""
    import torch

    from siddhi_tpu_torch.core.query.step_graph import clone_tree, device_cols, state_leaves
    from siddhi_tpu_torch.observability.telemetry import InstrumentedJit

    orig = InstrumentedJit.replay

    def replay(inst, state, cols, now, depth):
        twin = clone_tree(state)
        dev = device_cols(cols, device)
        res = orig(inst, state, cols, now, depth)
        _st, want = inst._fn(twin, dev, torch.full((), int(now), dtype=torch.int64,
                                                    device=device))
        got = res[1]
        valid = want["__valid__"]
        _require(torch.equal(got["__valid__"], valid)
                 and torch.equal(got["__meta__"], want["__meta__"]),
                 f"PC: {inst.key}: replay's valid rows or meta differ from eager")
        for k, v in want.items():
            if k not in ("__valid__", "__meta__") and v.dim() and v.shape[0] == valid.shape[0]:
                _require(torch.equal(got[k][valid], v[valid]),
                         f"PC: {inst.key}: replay's column {k} differs from eager")
        for a, b in zip(state_leaves(state), state_leaves(twin)):
            _require(torch.equal(a, b), f"PC: {inst.key}: state after the replay "
                     f"differs from eager")
        checks.append(1)
        return res

    InstrumentedJit.replay = replay
    try:
        yield
    finally:
        InstrumentedJit.replay = orig


def pc_run(device, feeds, cache_on: bool, card: str):
    """The six apps fed their feeds batch by batch, interleaved; app 2
    snapshots after half its feed and restores that revision in place.
    Returns facts and the apps' rows."""
    import torch

    from siddhi_tpu_torch.core.query.step_graph import StepGraph
    from siddhi_tpu_torch.core.util import program_cache

    cache = program_cache.cache()
    size0, cap0 = cache.size(), StepGraph.total_captures
    m, apps = pc_apps(device, cache_on)
    secs = [[] for _ in apps]
    checks = []
    facts = {"restore_recaptures": None}
    cap_ms = []
    with eager_beside_replays(device, checks):
        for b in range(PC_BATCHES):
            for i, (rt, q, _cb) in enumerate(apps):
                cols, ts = feeds[i][b]
                c0 = StepGraph.total_captures
                t0 = time.perf_counter()
                rt.get_input_handler("StockStream").send_columns(cols, timestamps=ts)
                torch.cuda.synchronize()
                secs[i].append(time.perf_counter() - t0)
                if StepGraph.total_captures > c0:
                    cap_ms.append(q._step.graph.capture_ms)
            if b == PC_BATCHES // 2 - 1:
                rt, q, _cb = apps[PC_RESTORE_APP]
                blob = rt.snapshot()
                # every app captured at its first batch: what is captured
                # from here on is the restore's
                facts["_restore_c0"] = StepGraph.total_captures
                rt.restore(blob)
    c1 = StepGraph.total_captures
    for i, (rt, q, _cb) in enumerate(apps):
        _require(q.captured, f"PC: app {i}'s step does not run as a CUDA graph")
    jits = [rt.app_context.telemetry.snapshot()["jit"]["query.bench.step"]
            for rt, _q, _cb in apps]
    snap = cache.snapshot()
    entries = [e for e in snap["entries"] if any(f"pc{i}" in e["shared_by"]
                                                  for i in range(len(apps)))]
    graphs = {id(q._step.graph): q._step.graph for _rt, q, _cb in apps
              if getattr(q._step, "graph", None) is not None}
    facts.update({
        "captures": c1 - cap0,
        "capture_ms": cap_ms,
        "compiles": [j["compiles"] for j in jits],
        "hits": [j["hits"] for j in jits],
        "entries": [(e["family"], e["refcount"], e["captures"]) for e in entries],
        "pool_bytes": sum(g.pool_bytes for g in graphs.values()),
        "slot_bytes": sum(g.slot_bytes for g in graphs.values()),
        "eager_checks": len(checks),
        "eps": [steady_eps(x, BATCH) for x in secs],
        "cache_size": snap["size"] - size0,
    })
    facts["restore_recaptures"] = c1 - facts.pop("_restore_c0")
    rows = [cb.batches for _rt, _q, cb in apps]
    m.shutdown()
    _require(cache.size() == size0, f"PC: {cache.size() - size0} cache entries "
             f"outlive the apps' shutdown")
    return facts, rows, [g for g in graphs.values()]


def phase_program_cache(device, card: str):
    """Phase 24 (PC, see the module doc). Returns the facts."""
    import gc

    import torch

    from siddhi_tpu_torch.core.query.step_graph import StepGraph

    t_phase = time.perf_counter()
    feeds = [make_feed(seed, PC_BATCHES, BATCH, NUM_SYMBOLS) for seed in PC_SEEDS]
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(device)
    on, rows_on, _g = pc_run(device, feeds, True, card)
    del _g
    off, rows_off, _g = pc_run(device, feeds, False, card)
    del _g
    n_apps = len(PC_SEEDS)
    # identity: cache on == cache off, bit for bit, each app's own rows
    worst = 0.0
    for i in range(n_apps):
        worst = max(worst, require_equal(concat_rows(rows_on[i]), concat_rows(rows_off[i]),
                                         f"PC app {i}: cache on vs off"))
    _require(worst == 0.0, f"PC: max float difference {worst} between cache on and off")
    _require(on["eager_checks"] == off["eager_checks"] == n_apps * PC_BATCHES,
             f"PC: {on['eager_checks']} / {off['eager_checks']} graph batches held "
             f"against eager, want {n_apps * PC_BATCHES} each")
    _require(on["cache_size"] == 2 and sorted(r for _f, r, _c in on["entries"]) == [2, 4],
             f"PC: cache entries {on['entries']} (size {on['cache_size']})")
    _require(on["compiles"] == [1, 0, 0, 0, 1, 0],
             f"PC: compiles {on['compiles']} with the cache on")
    want_off = [1] * n_apps
    want_off[PC_RESTORE_APP] = 2      # its private graph re-captured at the restore
    _require(off["compiles"] == want_off,
             f"PC: compiles {off['compiles']} with the cache off, want {want_off}")
    _require(on["captures"] == 2, f"PC: {on['captures']} captures with the cache on")
    _require(off["captures"] == n_apps + 1,
             f"PC: {off['captures']} captures with the cache off (six, and the "
             f"restore's re-capture of app 2's private graph)")
    _require(on["restore_recaptures"] == 0,
             f"PC: the restore re-captured {on['restore_recaptures']} with the cache on")
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated(device)
    _require(abs(mem1 - mem0) <= 1 << 20,
             f"PC: device memory {mem1 - mem0} bytes off its baseline after shutdown")

    # copy-in/out of the shared graph, and launch calls: graph vs eager
    m, apps = pc_apps(device, True)
    (rt, q, _cb), (rt_d1, q_d1, _cb1) = apps[0], apps[PC_FLAGSHIPS]
    for r in (rt, rt_d1):
        r.get_input_handler("StockStream").send_columns(*feeds[0][0])
        r.get_input_handler("StockStream").send_columns(*feeds[0][1])
    graph = q._step.graph
    graph.time_copies = True
    for b in feeds[0][2:4]:
        rt.get_input_handler("StockStream").send_columns(*b)
    copies = graph.copy_times()
    graph.time_copies = False
    slot_bytes = graph.slot_bytes
    h = rt.get_input_handler("StockStream")
    prof_graph = profile_batch("PC flagship, graph", lambda: h.send_columns(*feeds[1][0]), card)
    q.captured = False
    prof_eager = profile_batch("PC flagship, eager", lambda: h.send_columns(*feeds[1][1]), card)
    m.shutdown()
    routed = pc_routed_profile(device, feeds[0], card)
    facts = {"card": card, "on": on, "off": off, "max_abs_diff": worst,
             "memory_delta_bytes": mem1 - mem0,
             "copy_in_ms": [a for a, _b in copies], "copy_out_ms": [b for _a, b in copies],
             "slot_bytes_flagship": slot_bytes,
             "flagship_graph": {k: prof_graph[k] for k in ("host_launch_calls", "busy_share", "device_ms", "wall_ms")},
             "flagship_eager": {k: prof_eager[k] for k in ("host_launch_calls", "busy_share", "device_ms", "wall_ms")},
             "routed": routed, "total_captures": StepGraph.total_captures}
    facts["phase_s"] = time.perf_counter() - t_phase
    print(f"[program_cache] PC: {PC_FLAGSHIPS} global flagships and 2 D1 apps, "
          f"{PC_BATCHES} batches each of {BATCH} rows on their own feeds: rows "
          f"bit-equal cache on vs off (max abs diff {worst}), every replay == "
          f"the eager step on a clone ({on['eager_checks']} + {off['eager_checks']}); "
          f"cache on: entries {on['entries']}, compiles {on['compiles']}, "
          f"{on['captures']} captures ({on['capture_ms']} ms), pool "
          f"{on['pool_bytes']} bytes + slots {on['slot_bytes']} bytes, the "
          f"restore re-captured {on['restore_recaptures']}; cache off: "
          f"compiles {off['compiles']}, {off['captures']} captures "
          f"({off['capture_ms']} ms), pool {off['pool_bytes']} bytes; memory "
          f"after shutdown {mem1 - mem0:+d} bytes [{card}]", flush=True)
    print(f"[program_cache] events/s an app, cache on {[round(x, 1) for x in on['eps']]} "
          f"vs off {[round(x, 1) for x in off['eps']]}; copy-in/out of the "
          f"flagship's {slot_bytes}-byte slot a batch (CUDA events): in "
          f"{facts['copy_in_ms']} ms, out {facts['copy_out_ms']} ms; a flagship "
          f"batch: {prof_graph['host_launch_calls']} host launch calls, busy "
          f"{prof_graph['busy_share']:.3f} as a graph vs "
          f"{prof_eager['host_launch_calls']}, {prof_eager['busy_share']:.3f} "
          f"eager; routed x{N_SHARDS}: {routed['graph']['host_launch_calls']} vs "
          f"{routed['eager']['host_launch_calls']} host launch calls, busy "
          f"{routed['graph']['busy_share']:.3f} vs {routed['eager']['busy_share']:.3f}; "
          f"phase {facts['phase_s']:.1f} s [{card}]", flush=True)
    return facts


def pc_routed_profile(device, feed, card: str):
    """The routed flagship x4's captured step: host launch calls and busy
    share of one batch as a graph replay and one eager."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(
        {"siddhi_tpu.shard_exchange": "pallas_ring"}))
    rt = m.create_siddhi_app_runtime(APP.format(W=WINDOW))
    q = rt.query_runtimes["bench"]
    q.selector_plan.num_keys = KEY_SLOTS
    q._win_keys = KEY_SLOTS
    device_route_query_step(q, make_mesh(N_SHARDS, device), rows_per_shard=ROWS_PER_SHARD)
    h = rt.get_input_handler("StockStream")
    for b in feed[:2]:
        h.send_columns(*b)
    _require(q.captured and q._step.graph.captures == 1,
             "PC routed: the routed step is not captured")
    out = {"graph": profile_batch("PC routed x4, graph", lambda: h.send_columns(*feed[2]), card)}
    q.captured = False
    out["eager"] = profile_batch("PC routed x4, eager", lambda: h.send_columns(*feed[3]), card)
    m.shutdown()
    return {k: {f: v[f] for f in ("host_launch_calls", "busy_share", "device_ms", "wall_ms")}
            for k, v in out.items()}


# ------------------------------------------------- phase 25: observability

OB_BATCHES = 4                  # a cut of depth: each cell's seeded feed
OB_SEED = 25
OB_J5_PAIRS = 4                 # J5: Stock/Twitter send pairs
OB_N_PAIRS = 4                  # N: A/B send pairs at B = 4,096
OB_DELAY_S = 0.05               # the planted pack and worker delays
OB_ASYNC_BATCHES = 6


class ObsCell:
    """One app of phase 25 driven through the public API on the card: its
    emitted batches (``collector``), every meta its query decoded, every
    data lane it recorded (a list a batch), and the card's host syncs a
    send (``counting_syncs``)."""

    def __init__(self, device, app: str, query: str, out: str, knobs: dict, prep=None):
        from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

        self.m = SiddhiManager(device=device)
        self.m.set_config_manager(InMemoryConfigManager(
            {f"siddhi_tpu.{k}": str(v) for k, v in knobs.items()}))
        self.rt = self.m.create_siddhi_app_runtime(app)
        self.q = self.rt.query_runtimes[query]
        self.cb = collector()
        self.rt.add_callback(out, self.cb)
        if prep is not None:
            prep(self.rt, self.q)
        self.metas, self.lanes, self.syncs = [], [], []
        q = self.q
        decode, record = q.decode_meta_suffix, q._record_instrument

        def decode_meta(meta):
            import numpy as np

            self.metas.append(np.asarray(meta).copy())
            self.lanes.append({})
            return decode(meta)

        def record_lane(slot, vals, telemetry):
            import numpy as np

            self.lanes[-1][slot.name] = np.asarray(vals).copy()
            return record(slot, vals, telemetry)

        q.decode_meta_suffix, q._record_instrument = decode_meta, record_lane
        self.handlers = {}

    def send(self, stream: str, cols, ts):
        """One send, its host syncs counted; the card synchronised after."""
        import torch

        h = self.handlers.get(stream)
        if h is None:
            h = self.handlers[stream] = self.rt.get_input_handler(stream)
        out = {}
        with counting_syncs(out):
            h.send_columns(cols, timestamps=ts)
        torch.cuda.synchronize()
        self.syncs.append(out["syncs"])

    def close(self):
        self.m.shutdown()


OB_ON = {"profile_device_instruments": "true", "profile_journeys": "true"}
OB_OFF = {"profile_device_instruments": "false", "profile_journeys": "false"}


def ob_pair(device, label: str, app: str, query: str, out: str, items, knobs: dict,
            prep=None, check=None, pre_layout: int = 3):
    """Phase 25's gates 1-3 on one cell, in three runs: instruments and
    journeys off, then on (each send's host syncs counted), then on again
    with ``check(i, cell)`` after each send (the lanes against the state
    pulled after the batch) and every replay held against the eager step
    on a clone (meta and lanes included: ``eager_beside_replays``). Rows
    bit-equal across the runs, every "off" meta ``pre_layout`` lanes (the
    layout before the instruments), each "on" meta's structural lanes ==
    the "off" meta's, host syncs a send equal off and on after the first
    (capturing) send. Returns (off, on, checked) facts."""
    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    runs = {}
    for name, k in (("off", OB_OFF), ("on", OB_ON), ("checked", OB_ON)):
        k0 = (ring_exchange.launches, distinct_scan.launches)
        cell = ObsCell(device, app, query, out, {**knobs, **k}, prep)
        checks = []
        with (eager_beside_replays(device, checks) if name == "checked"
              else contextlib.nullcontext()):
            for i, (stream, cols, ts) in enumerate(items):
                cell.send(stream, cols, ts)
                if name == "checked" and check is not None:
                    check(i, cell)
        spec = cell.q.instrument_slots()
        cell.close()
        runs[name] = {"batches": cell.cb.batches, "metas": cell.metas,
                      "lanes": cell.lanes, "syncs": cell.syncs,
                      "spec": [(s.name, s.width, s.kind) for s in spec],
                      "captured": cell.q.captured, "eager_checks": len(checks),
                      # the main path's launches (the checked run's eager
                      # twins launch the kernels too: not counted)
                      "launches": (ring_exchange.launches - k0[0],
                                   distinct_scan.launches - k0[1])}
    off, on, checked = runs["off"], runs["on"], runs["checked"]
    on["launches"] = tuple(a + b for a, b in zip(off["launches"], on["launches"]))
    for other in ("on", "checked"):
        require_equal(concat_rows(runs[other]["batches"]), concat_rows(off["batches"]),
                      f"OB {label}: rows, instruments and journeys {other} vs off")
    _require(len(off["metas"]) == len(on["metas"]) > 0,
             f"OB {label}: {len(off['metas'])} vs {len(on['metas'])} metas decoded")
    # the "on" spec's structural slots sit where the "off" layout has them
    struct, pos = [], 3
    for name, width, kind in on["spec"]:
        if kind == "check" or name == "shard_rows":
            struct.extend(range(pos, pos + width))
        pos += width
    for i, (a, b) in enumerate(zip(off["metas"], on["metas"])):
        _require(a.shape == (pre_layout,),
                 f"OB {label}: meta {i} off has {a.shape[0]} lanes, want {pre_layout}")
        _require(b.shape == (pos,), f"OB {label}: meta {i} on has {b.shape[0]} "
                 f"lanes, its spec {on['spec']} {pos}")
        _require(a[:3].tolist() == b[:3].tolist()
                 and a[3:].tolist() == b[struct].tolist(),
                 f"OB {label}: meta {i}: off {a.tolist()} vs on {b.tolist()}")
    _require([m.tolist() for m in checked["metas"]] == [m.tolist() for m in on["metas"]],
             f"OB {label}: the checked run's metas differ from the on run's")
    # a shape's first batch runs eagerly and captures, and the process's
    # first capture of a kind pays one-time syncs: the steady batches after
    # it are compared
    _require(off["syncs"][1:] == on["syncs"][1:],
             f"OB {label}: host syncs a send off {off['syncs']} vs on {on['syncs']}")
    return off, on, checked


def ob_pk_rows(q, cols, n: int):
    """The routed rows per shard of one batch, from the host: the
    partition key ids the batch's symbols hold (``pk % n`` owns a row)."""
    import numpy as np

    from siddhi_tpu_torch.core.event import HostBatch, LazyColumns

    hb = HostBatch.from_columns(cols, q.input_definition, q.dictionary)
    _c, pk = q.partition_keyer.apply(LazyColumns(hb.cols))
    valid = np.asarray(hb.cols["__valid__"])
    return np.bincount(np.asarray(pk, np.int64)[valid] % n, minlength=n)


def phase_observability(device, card: str):
    """Phase 25 (see the module doc). Returns the facts."""
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from siddhi_tpu_torch.core.debugger import SiddhiDebugger
    from siddhi_tpu_torch.observability import export, journey
    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.ops.exchange import ring_exchange
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh
    from siddhi_tpu_torch.resilience import FaultInjector

    t_phase = time.perf_counter()
    feed = make_feed(OB_SEED, OB_BATCHES, BATCH, NUM_SYMBOLS)
    items = [("StockStream", cols, ts) for cols, ts in feed]
    facts = {"card": card}
    syms = [np.asarray(cols["symbol"]) for cols, _ts in feed]
    launches = {"exchange": 0, "scan": 0}

    def key_slots(_rt, q):
        q.selector_plan.num_keys = KEY_SLOTS

    # 1-3. the global flagship (fused stage): groups == distinct symbols
    def global_check(i, cell):
        got = int(cell.lanes[-1]["groups"][0])
        _require(got == len(np.unique(syms[i])),
                 f"OB global: groups {got} vs {len(np.unique(syms[i]))} symbols")

    off, on, checked = ob_pair(device, "global", GLOBAL_APP.format(W=WINDOW), "bench",
                          "OutStream", items, {"pipeline_depth": 1}, key_slots,
                          global_check)
    _require(on["captured"] and checked["eager_checks"] == OB_BATCHES,
             f"OB global: captured {on['captured']}, {checked['eager_checks']} batches "
             f"held against eager")
    facts["global"] = {"spec": on["spec"], "syncs": on["syncs"],
                       "groups": [int(x["groups"][0]) for x in on["lanes"]]}
    global_rows = off["batches"]

    # the routed flagship x4 (K8 inside the captured step)
    def routed_prep(_rt, q):
        q.selector_plan.num_keys = KEY_SLOTS
        q._win_keys = KEY_SLOTS
        device_route_query_step(q, make_mesh(N_SHARDS, device), rows_per_shard=ROWS_PER_SHARD)

    def routed_check(i, cell):
        lanes, q = cell.lanes[-1], cell.q
        total = q._state["win"]["total"]
        fill = int(torch.clamp(total, max=WINDOW).max())
        want = ob_pk_rows(q, feed[i][0], N_SHARDS)
        Q = q._route_layout.quota
        _require(int(lanes["win_fill"][0]) == fill,
                 f"OB routed: win_fill {lanes['win_fill']} vs the ring's {fill}")
        _require(int(lanes["groups"][0]) == len(np.unique(syms[i])),
                 f"OB routed: groups {lanes['groups']} vs {len(np.unique(syms[i]))}")
        _require(lanes["shard_rows"].tolist() == want.tolist(),
                 f"OB routed: shard_rows {lanes['shard_rows']} vs {want}")
        _require(int(lanes["route_residual"][0]) == N_SHARDS * Q - int(want.max()),
                 f"OB routed: route_residual {lanes['route_residual']} vs "
                 f"{N_SHARDS * Q} - {int(want.max())}")

    off, on, checked = ob_pair(device, "routed", APP.format(W=WINDOW), "bench", "OutStream",
                          items, {"shard_exchange": "pallas_ring", "pipeline_depth": 1},
                          routed_prep, routed_check, pre_layout=4 + N_SHARDS)
    launches["exchange"] += on["launches"][0]
    _require(on["launches"][0] == 2 * OB_BATCHES,
             f"OB routed: {on['launches'][0]} exchange launches off and on for "
             f"{2 * OB_BATCHES} batches")
    _require(on["captured"] and checked["eager_checks"] == OB_BATCHES,
             f"OB routed: captured {on['captured']}, {checked['eager_checks']} checked")
    facts["routed"] = {"spec": on["spec"], "syncs": on["syncs"],
                       "lanes": [{k: v.tolist() for k, v in x.items()} for x in on["lanes"]]}

    # D1 (the distinct scan inside the captured step): the generic window
    def d1_check(i, cell):
        lanes, q = cell.lanes[-1], cell.q
        fill = int(torch.clamp(q._state["win"]["total"], max=WINDOW))
        seen = set(syms[i].tolist())
        if i > 0:   # the window's rows before the batch expire in it
            seen |= set(syms[i - 1][-WINDOW:].tolist())
        _require(int(lanes["win_fill"][0]) == fill,
                 f"OB D1: win_fill {lanes['win_fill']} vs {fill}")
        _require(int(lanes["groups"][0]) == len(seen),
                 f"OB D1: groups {lanes['groups']} vs {len(seen)} symbols among "
                 f"the batch and the rows it expires")

    off, on, checked = ob_pair(device, "D1", D1_APP.format(W=WINDOW), "bench", "OutStream",
                          items, {"pipeline_depth": 1}, key_slots, d1_check)
    launches["scan"] += on["launches"][1]
    _require(on["launches"][1] == 2 * OB_BATCHES,
             f"OB D1: {on['launches'][1]} scan launches off and on for "
             f"{2 * OB_BATCHES} batches")
    _require(on["captured"] and checked["eager_checks"] == OB_BATCHES,
             f"OB D1: captured {on['captured']}, {checked['eager_checks']} checked")
    facts["D1"] = {"spec": on["spec"], "syncs": on["syncs"]}

    # J5 (config #5, the join engine): fill.<side> == the pulled directory
    j5_items, _ids = j5_feed(OB_SEED, OB_J5_PAIRS)

    def j5_check(i, cell):
        q = cell.q
        for side, plan in q.engine.plans.items():
            if not plan.use_pidx:
                continue
            win = q._state[plan.win_key]
            floor = plan.live_floor_np({k: int(win[k]) for k in ("total", "expired_upto")
                                        if k in win})
            gseq = q._state[plan.pidx_key]["gseq"].cpu().numpy()
            want = ((gseq >= floor) & (gseq >= 0)).sum(axis=1)
            got = cell.lanes[-1][f"fill.{side}"]
            _require(got.tolist() == want.tolist(),
                     f"OB J5: fill.{side} {got.tolist()} vs the directory's {want.tolist()}")

    off, on, checked = ob_pair(device, "J5", J5_APP, "j5", "JoinOut", j5_items,
                          {"window_capacity": J5_CAPACITY, "join_partitions": 8}, None,
                          j5_check, pre_layout=4)
    j5_sides = [n for n, _w2, k in on["spec"] if n.startswith("fill.")]
    _require(j5_sides, f"OB J5: no partitioned side (spec {on['spec']})")
    facts["J5"] = {"spec": on["spec"], "syncs": on["syncs"]}

    # N (config #4): nfa_runs == the live match slots of the pulled [K, S] state
    def n_prep(_rt, q):
        q._win_keys = NFA_KEY_SLOTS
        q.selector_plan.num_keys = NFA_KEY_SLOTS

    def n_check(i, cell):
        live = int(cell.q._state["nfa"]["active"].sum())
        got = int(cell.lanes[-1]["nfa_runs"][0])
        _require(got == live, f"OB N: nfa_runs {got} vs {live} live runs in the state")

    n_items = nfa_feed(OB_SEED, NFA_B_THR, OB_N_PAIRS, 10_000, NFA_STEP_MS, False)
    off, on, checked = ob_pair(device, "N", nfa_app(N_PATTERN, N_SELECT), "nfa", "MatchStream",
                          n_items, {"nfa_slots": NFA_SLOTS, "pipeline_depth": NFA_DEPTH},
                          n_prep, n_check)
    facts["N"] = {"spec": on["spec"], "syncs": on["syncs"],
                  "nfa_runs": [int(x["nfa_runs"][0]) for x in on["lanes"]]}
    print(f"[observability] gates 1-3: global flagship, routed x{N_SHARDS}, D1, J5 "
          f"({OB_J5_PAIRS} pairs), N ({OB_N_PAIRS} pairs) at full width: rows bit-equal "
          f"with instruments and journeys on vs off, every off meta the layout before "
          f"the instruments and its lanes equal the on meta's, host syncs a send "
          f"after the first equal (on: global {facts['global']['syncs']}, "
          f"routed {facts['routed']['syncs']}, "
          f"D1 {facts['D1']['syncs']}, J5 {facts['J5']['syncs']}, N {facts['N']['syncs']}); "
          f"every lane == its host recomputation from the state pulled after the "
          f"batch; every replay's meta == the eager step's on a clone [{card}]",
          flush=True)

    # 2 (the scrape is pull-free) and 4 (the critical path on the card)
    def report(cell):
        q = journey.critical_path_report(cell.m)["apps"][cell.rt.name]["queries"][cell.q.name]
        return q["bottleneck"], sorted(q["stages"])

    def d2_prep(_rt, q):
        for spec in q.selector_plan.specs:
            spec.distinct_capacity = D2_H

    s0 = distinct_scan.launches
    d2 = ObsCell(device, D2_APP.format(W=WINDOW), "bench", "OutStream",
                 {"pipeline_depth": 4, **OB_ON}, d2_prep)
    d2.send(*items[0])
    # the first batch of a shape runs eagerly and captures (~0.1-0.3 s of
    # dispatch): the report reads the batches after it
    d2.rt.app_context.telemetry.reset()
    for it in items[1:]:
        d2.send(*it)
    launches["scan"] += distinct_scan.launches - s0
    d2_verdict, d2_stages = report(d2)
    scrape = {}
    with counting_syncs(scrape):
        text = export.prometheus_text(d2.m)
        journey.critical_path_report(d2.m)
    d2.close()
    _require(scrape["syncs"] == 0, f"OB: a scrape made {scrape['syncs']} host syncs "
             f"({scrape['sync_sites']})")
    _require(export.DEVICE_INSTRUMENT_FAMILY in text and export.STAGE_MS_FAMILY in text,
             "OB: /metrics lacks the device-instrument or stage families")
    _require(d2_verdict["stage"] == "device",
             f"OB D2 at depth 4: the report names {d2_verdict}, not device")

    g = ObsCell(device, GLOBAL_APP.format(W=WINDOW), "bench", "OutStream",
                {"pipeline_depth": 1, **OB_ON}, key_slots)
    g.send(*items[0])
    g.rt.app_context.telemetry.reset()
    inj = FaultInjector()
    inj.delay_stage("pack", OB_DELAY_S)
    try:
        for it in items[1:]:
            g.send(*it)
    finally:
        inj.clear()
    pack_verdict, _st = report(g)
    g.close()
    _require(pack_verdict["stage"] == "pack",
             f"OB global under a {OB_DELAY_S} s pack delay: the report names {pack_verdict}")

    a = ObsCell(device, PIPE_APP.format(W=WINDOW), "bench", "OutStream",
                {"pipeline_depth": 1, **OB_ON}, key_slots)
    a.send(*items[0])
    wait_rows(a.cb, BATCH, "OB @Async warm-up")
    a.rt.app_context.telemetry.reset()
    inj = FaultInjector()
    inj.delay_worker(a.rt.junctions["StockStream"], OB_DELAY_S, persistent=True)
    try:
        for i in range(OB_ASYNC_BATCHES):
            cols, ts = feed[i % OB_BATCHES]
            a.rt.get_input_handler("StockStream").send_columns(cols, timestamps=ts)
        wait_rows(a.cb, BATCH * (1 + OB_ASYNC_BATCHES), "OB @Async under a worker delay")
    finally:
        inj.clear()
    queue_verdict, _st = report(a)
    a.close()
    _require(queue_verdict["stage"] == "queue",
             f"OB @Async flagship under a {OB_DELAY_S} s worker delay: the report "
             f"names {queue_verdict}")
    facts["critical_path"] = {"D2_depth4": d2_verdict, "pack_delay": pack_verdict,
                              "worker_delay": queue_verdict, "D2_stages": d2_stages}
    print(f"[observability] gate 4: critical path on the card: D2 at depth 4 -> "
          f"{d2_verdict}; global flagship under a {OB_DELAY_S} s pack delay -> "
          f"{pack_verdict}; @Async flagship under a {OB_DELAY_S} s worker delay -> "
          f"{queue_verdict}; a /metrics scrape and the report: "
          f"{scrape['syncs']} host syncs [{card}]", flush=True)

    # J5's partition occupancy reads the drained lanes: no sync
    occ = {}
    j5 = ObsCell(device, J5_APP, "j5", "JoinOut",
                 {"window_capacity": J5_CAPACITY, "join_partitions": 8, **OB_ON})
    for it in j5_items[:2]:
        j5.send(*it)
    with counting_syncs(occ):
        for side in j5.q.engine.plans:
            j5.q.engine.partition_occupancy(side)
        export.prometheus_text(j5.m)
    j5.close()
    _require(occ["syncs"] == 0, f"OB J5: partition_occupancy and a scrape made "
             f"{occ['syncs']} host syncs ({occ['sync_sites']})")

    # 5. the device trace: two routed batches and one D1 batch
    out_dir = Path(tempfile.mkdtemp(prefix="phase25_"))
    r = ObsCell(device, APP.format(W=WINDOW), "bench", "OutStream",
                {"shard_exchange": "pallas_ring", "pipeline_depth": 1}, routed_prep)
    d1 = ObsCell(device, D1_APP.format(W=WINDOW), "bench", "OutStream",
                 {"pipeline_depth": 1}, key_slots)
    e_start, s_start = ring_exchange.launches, distinct_scan.launches
    r.send(*items[0])
    d1.send(*items[0])
    e0, s0 = ring_exchange.launches, distinct_scan.launches
    r.rt.start_trace(str(out_dir / "device_trace"))
    r.send(*items[1])
    r.send(*items[2])
    d1.send(*items[1])
    path = r.rt.stop_trace()
    de, ds = ring_exchange.launches - e0, distinct_scan.launches - s0
    launches["exchange"] += ring_exchange.launches - e_start
    launches["scan"] += distinct_scan.launches - s_start
    r.close()
    d1.close()
    counts = trace_kernel_counts(path, ("ring_exchange_cols_kernel",
                                        "distinct_scan_registers",
                                        "distinct_scan_hash"))
    scans = counts["distinct_scan_registers"] + counts["distinct_scan_hash"]
    _require((de, ds) == (2, 1), f"OB trace: {de} exchange, {ds} scan launches, want 2, 1")
    _require(counts["ring_exchange_cols_kernel"] == de and scans == ds,
             f"OB trace: the trace holds {counts} for {de} exchange and {ds} scan "
             f"launches ({path})")
    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
    from siddhi_tpu_torch.service import SiddhiRestService

    base = tempfile.mkdtemp(prefix="phase25_", dir=str(out_dir))
    sm = SiddhiManager(device=device)
    sm.set_persistence_store(InMemoryPersistenceStore())
    svc = SiddhiRestService(sm, trace_base=base).start()
    try:
        code_esc, _b, _h = http(svc.port, "POST", "/profile/device/start", {"dir": "../out"})
        code_on, body_on, _h = http(svc.port, "POST", "/profile/device/start", {"dir": "dev"})
        code_off, body_off, _h = http(svc.port, "POST", "/profile/device/stop", {})
        _require(code_esc == 400 and code_on == 200 and code_off == 200
                 and body_off["file"].startswith(base + os.sep)
                 and os.path.exists(body_off["file"]),
                 f"OB /profile/device: {code_esc}, {code_on} {body_on}, {code_off} {body_off}")
        # 6. the span trace over REST: deploy, two sends, a persist
        code, body, _h = http(svc.port, "POST", "/trace/start", {})
        _require(code == 200, f"OB /trace/start: {code} {body}")
        code, body, _h = http(svc.port, "POST", "/apps", raw=(
            "@app:name('obs_spans')\n" + GLOBAL_APP.format(W=WINDOW)).encode(),
            ctype="text/plain")
        _require(code == 201, f"OB POST /apps: {code} {body}")
        srt = sm.get_siddhi_app_runtime("obs_spans")
        for cols, ts in feed[:2]:
            srt.get_input_handler("StockStream").send_columns(cols, timestamps=ts)
        code, body, _h = http(svc.port, "POST", "/apps/obs_spans/persist", {})
        _require(code == 200, f"OB persist: {code} {body}")
        code, trace, _h = http(svc.port, "POST", "/trace/stop", {"file": "spans/p25.json"})
        _require(code == 200 and trace["file"].startswith(base + os.sep),
                 f"OB /trace/stop: {code} {trace if code != 200 else trace['file']}")
    finally:
        svc.stop()
        sm.shutdown()
    spans = [e for e in trace["trace"]["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in spans}
    _require({"jit", "query.step", "junction.dispatch", "persist"} <= names,
             f"OB span trace: names {sorted(names)}")
    nested = ob_nesting(spans)
    _require(("junction.dispatch", "query.step") in nested and ("query.step", "jit") in nested,
             f"OB span trace: nesting {sorted(nested, key=str)}")
    print(f"[observability] gates 5-6: rt.start_trace over 2 routed batches and 1 D1 "
          f"batch: the trace holds {counts} for {de} exchange and {ds} scan launches "
          f"({os.path.getsize(path)} bytes); /profile/device answered 400 outside "
          f"trace_base and wrote {os.path.basename(body_off['file'])} under it; "
          f"/trace/stop: {len(spans)} spans, names {sorted(names)}, nested "
          f"{sorted((p for p in nested if p[0]), key=str)} [{card}]", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)

    # 7. the debugger on the captured global flagship
    dbg_cell = ObsCell(device, GLOBAL_APP.format(W=WINDOW), "bench", "OutStream",
                       {"pipeline_depth": 1}, key_slots)
    for it in items[:2]:
        dbg_cell.send(*it)
    _require(dbg_cell.q.captured, "OB debugger: the step is not captured")
    from siddhi_tpu_torch.core.util.snapshot import safe_loads

    want = safe_loads(dbg_cell.rt.snapshot())["queries"]["bench"]["state"]
    dbg = dbg_cell.rt.debug()
    fired = threading.Event()
    dbg.set_debugger_callback(lambda *_a: fired.set())
    dbg.acquire_break_point("bench", SiddhiDebugger.QueryTerminal.IN)
    n_before = len(dbg_cell.cb.batches)
    cols, ts = feed[2]
    t = threading.Thread(target=lambda: dbg_cell.rt.get_input_handler(
        "StockStream").send_columns(cols, timestamps=ts), daemon=True)
    t.start()
    _require(fired.wait(60), "OB debugger: the IN breakpoint never fired")
    time.sleep(0.2)
    suspended = t.is_alive() and len(dbg_cell.cb.batches) == n_before
    got = dbg.get_query_state("bench")["state"]
    dbg.release_all_break_points()
    dbg.play()
    t.join(60)
    _require(suspended and not t.is_alive(), f"OB debugger: suspended {suspended}, "
             f"thread alive after play {t.is_alive()}")
    same = ob_leaves(got) == ob_leaves(want)
    _require(same, "OB debugger: get_query_state differs from the snapshot's state")
    for it in items[3:]:
        dbg_cell.send(*it)
    dbg_cell.close()
    require_equal(concat_rows(dbg_cell.cb.batches), concat_rows(global_rows),
                  "OB debugger: rows with the debugger vs without")
    print(f"[observability] gate 7: a breakpoint IN on the captured global flagship "
          f"suspended its send; get_query_state == the snapshot's state "
          f"({len(ob_leaves(want))} leaves); after play the rows equal a run without "
          f"the debugger [{card}]", flush=True)

    # 8. record: events/s, host launch calls and busy share with the
    # instruments and journeys on and off
    record = {}
    for label, app, prep, knobs in (
            ("global", GLOBAL_APP.format(W=WINDOW), key_slots, {"pipeline_depth": 1}),
            ("routed", APP.format(W=WINDOW), routed_prep,
             {"shard_exchange": "pallas_ring", "pipeline_depth": 1})):
        for mode, k in (("off", OB_OFF),
                        ("instruments", {**OB_OFF, "profile_device_instruments": "true"}),
                        ("journeys", {**OB_OFF, "profile_journeys": "true"}),
                        ("both", OB_ON)):
            e0 = ring_exchange.launches
            c = ObsCell(device, app, "bench", "OutStream", {**knobs, **k}, prep)
            secs = []
            for it in items[:3]:
                t0 = time.perf_counter()
                c.send(*it)
                secs.append(time.perf_counter() - t0)
            h = c.rt.get_input_handler("StockStream")
            prof = profile_batch(f"OB {label} {mode}", lambda: h.send_columns(
                *feed[3]), card)
            c.close()
            if label == "routed":
                launches["exchange"] += ring_exchange.launches - e0
            record[f"{label}_{mode}"] = {
                "eps": steady_eps(secs, BATCH),
                **{f: prof[f] for f in ("host_launch_calls", "busy_share", "wall_ms",
                                        "device_ms")}}
    facts["record"] = record
    facts["launches"] = launches
    facts["phase_s"] = time.perf_counter() - t_phase
    print(f"[observability] record: " + "; ".join(
        f"{k} {v['eps']:.1f} events/s, {v['host_launch_calls']} launch calls, busy "
        f"{v['busy_share']:.3f}" for k, v in record.items())
        + f"; phase {facts['phase_s']:.1f} s [{card}]", flush=True)
    return facts


def trace_kernel_counts(path: str, names) -> dict:
    """``{name: launches}``: the device kernel events of a Chrome trace
    file whose name contains each of ``names``."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    out = {n: 0 for n in names}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "kernel":
            continue
        for n in names:
            if n in str(ev.get("name", "")):
                out[n] += 1
    return out


def ob_nesting(spans) -> set:
    """(parent name, name) of every span, per thread by containment."""
    by_tid = {}
    for e in spans:
        by_tid.setdefault(e["tid"], []).append(e)
    pairs = set()
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - 0.01:
                stack.pop()
            if stack:
                _require(e["ts"] + e["dur"] <= stack[-1]["ts"] + stack[-1]["dur"] + 0.01,
                         f"OB span {e['name']} escapes its parent {stack[-1]['name']}")
            pairs.add((stack[-1]["name"] if stack else None, e["name"]))
            stack.append(e)
    return pairs


def ob_leaves(tree, path=()):
    """A state tree as sorted (path, dtype, bytes) leaves."""
    import numpy as np

    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(ob_leaves(tree[k], path + (k,)))
        return out
    a = np.asarray(tree)
    return [(path, a.dtype.str, a.shape, a.tobytes())]


# -------------------------------------------------- phase 26: overload

OL_SEED = 26
OL_BATCHES = 4                  # gate 1's runs: a cut of depth
OL_GENEROUS = {"queue_quota": 64, "shed_policy": "shed_oldest", "pipeline_quota": 64,
               "memory_budget_mb": 65_536, "fair_weight": 1.0, "query_cap": 64}
OL_GROWTH_SYMBOLS = 20_000      # gate 2: past the routed flagship's 16,384 key slots
OL_DENY_MB = 800                # under the ~1.15 GB growth
OL_GROW_MB = 4_096              # above it
OL_FLOOD_EVENTS = 65_536        # gate 3: events a flood, in sends of
OL_FLOOD_CHUNK = 4_096
OL_WAL_BATCH = 8_192            # gate 3's persist/restore feed: 10 batches,
OL_WAL_BATCHES = 10             # the revision after 5
# gate 4's supervisor: wedge_timeout_s, above any healthy drain
# iteration (at 0.4 s an unfaulted run was once restarted: an iteration
# can hold a new shape's eager run and capture when the @Async worker
# coalesces queued batches)
OL_WEDGE_S = 2.0
OL_SPIN_S = 4.0                 # the planted device spin, past the timeout
OL_SUP_BATCHES = 10
OL_PQ_BATCHES = 8               # gate 5's pipeline-quota app, each stream
PQ_APP = """
@app:name('ol_pq')
@Async(buffer.size='64')
define stream StockStream (symbol string, price float, volume long);
@Async(buffer.size='64')
define stream DistinctStream (symbol string, price float, volume long);
@info(name = 'bench')
from StockStream#window.length({W})
select symbol, avg(price) as avgPrice, sum(volume) as totalVolume
group by symbol insert into OutStream;
@info(name = 'd1')
from DistinctStream#window.length({W})
select symbol, distinctCount(volume) as volumes, avg(price) as avgPrice
group by symbol insert into DistinctOut;
"""


class EventUnits:
    """A stream callback keeping each delivery of an input stream (the
    units its queue admitted), as (timestamps, data rows)."""

    def __new__(cls):
        from siddhi_tpu_torch import StreamCallback

        class Units(StreamCallback):
            def __init__(self):
                self.units = []

            def receive(self, events):
                self.units.append(([e.timestamp for e in events],
                                   [list(e.data) for e in events]))

        return Units()


def wait_units(units, n: int, what: str):
    """Wait until an ``EventUnits`` holds ``n`` deliveries (it is
    subscribed after the collector that ``wait_rows`` waits on)."""
    deadline = time.perf_counter() + PIPE_TIMEOUT_S
    while len(units.units) < n and time.perf_counter() < deadline:
        time.sleep(0.005)
    _require(len(units.units) >= n, f"{what}: {len(units.units)} of {n} deliveries")


def ol_manager(device, knobs: dict):
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager

    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager(
        {f"siddhi_tpu.{k}": str(v) for k, v in knobs.items()}))
    return m


def ol_app(device, app: str, knobs: dict, queries=("bench",), outs=("OutStream",),
           routed: bool = False, store=None):
    """(manager, runtime, {out: collector}) of an app at the bench's key
    capacity; ``routed`` lays ``bench`` out over 4 shards as phase 4 does;
    ``store`` is the manager's persistence store."""
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m = ol_manager(device, knobs)
    if store is not None:
        m.set_persistence_store(store)
    rt = m.create_siddhi_app_runtime(app)
    for name in queries:
        q = rt.query_runtimes[name]
        q.selector_plan.num_keys = KEY_SLOTS
        if routed:
            q._win_keys = KEY_SLOTS
            device_route_query_step(q, make_mesh(N_SHARDS, device),
                                    rows_per_shard=ROWS_PER_SHARD)
    cbs = {o: collector() for o in outs}
    for o, cb in cbs.items():
        rt.add_callback(o, cb)
    return m, rt, cbs


def ol_sends(rt, feed, stream: str = "StockStream"):
    """Send each batch, counting its host syncs; the card synchronised
    after each. Returns the syncs a send."""
    import torch

    h = rt.get_input_handler(stream)
    syncs = []
    for cols, ts in feed:
        out = {}
        with counting_syncs(out):
            h.send_columns(cols, timestamps=ts)
        torch.cuda.synchronize()
        syncs.append(out["syncs"])
    return syncs


def ol_zero_cost(device, feed, card: str):
    """Gate 1: the global and the routed x4 flagship unregistered and with
    generous quotas: ``overload`` None when off, rows bit-equal, host syncs
    a send and host launch calls a batch equal; K8 inside the routed
    step's replays held against plain."""
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    facts, launches, replays = {}, 0, 0
    for label, app, knobs in (
            ("global", GLOBAL_APP.format(W=WINDOW), {"pipeline_depth": 1}),
            ("routed", APP.format(W=WINDOW),
             {"pipeline_depth": 1, "shard_exchange": "pallas_ring"})):
        runs = {}
        for mode in ("off", "quotas"):
            k0 = ring_exchange.launches
            record = label == "routed" and mode == "quotas"
            with (recording_exchange(at=2) if record else contextlib.nullcontext()) as rec:
                m, rt, cbs = ol_app(device, app, knobs, routed=label == "routed")
                if mode == "quotas":
                    rt.enable_overload(**OL_GENEROUS)
                registered = rt.app_context.overload is not None
                syncs = ol_sends(rt, feed[:-1])
                h = rt.get_input_handler("StockStream")
                prof = profile_batch(f"OL {label}, quotas {mode}, batch {len(feed)}",
                                     lambda: h.send_columns(*feed[-1]), card)
            q = rt.query_runtimes["bench"]
            runs[mode] = {"batches": cbs["OutStream"].batches, "syncs": syncs,
                          "calls": prof["host_launch_calls"], "registered": registered,
                          "captured": q.captured}
            m.shutdown()
            launches += ring_exchange.launches - k0
            if record:
                replays = rec.replays
                cols = check_exchange_call(rec, "OL routed with quotas: the exchange "
                                                "inside replay 2")
        off, on = runs["off"], runs["quotas"]
        _require(not off["registered"] and on["registered"],
                 f"OL {label}: overload registered off {off['registered']}, "
                 f"with quotas {on['registered']}")
        require_equal(on["batches"], off["batches"], f"OL {label}: rows with quotas vs off")
        _require(on["syncs"][1:] == off["syncs"][1:],
                 f"OL {label}: host syncs a send with quotas {on['syncs']} vs off "
                 f"{off['syncs']}")
        _require(on["calls"] == off["calls"],
                 f"OL {label}: {on['calls']} host launch calls a batch with quotas vs "
                 f"{off['calls']} off")
        _require(on["captured"] and off["captured"], f"OL {label}: the step is not captured")
        facts[label] = {"syncs_off": off["syncs"], "syncs_quotas": on["syncs"],
                        "launch_calls_off": off["calls"], "launch_calls_quotas": on["calls"]}
        print(f"[overload] gate 1 {label}: overload None when off; with generous quotas "
              f"rows bit-equal, host syncs a send {on['syncs']} == {off['syncs']} (after "
              f"the first), host launch calls a batch {on['calls']} == {off['calls']} "
              f"[{card}]", flush=True)
    _require(launches == 2 * len(feed) and replays == len(feed) - 1,
             f"OL gate 1: {launches} exchange launches for {2 * len(feed)} routed "
             f"batches, {replays} under replay")
    facts["exchange_replays_quotas"] = replays
    facts["exchange_columns_checked"] = cols
    print(f"[overload] gate 1: K8 launched {launches} times, {replays} inside the "
          f"routed step's replays with quotas; replay 2's {cols} columns == plain",
          flush=True)
    return facts, launches, replays


def ol_budget(device, feed, card: str):
    """Gate 2: the routed x4 flagship's growth to 32,768 global keys denied
    under 800 MB before anything is allocated, allowed under 4,096 MB."""
    import re

    import torch

    from siddhi_tpu_torch.core.query.step_graph import StepGraph
    from siddhi_tpu_torch.core.stream.junction import FatalQueryError
    from siddhi_tpu_torch.core.util.statistics import pytree_nbytes
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    grow = [(c, ts + BATCH) for c, ts in
            make_feed(OL_SEED + 1, 2, BATCH, OL_GROWTH_SYMBOLS)]
    items = [feed[0]] + grow
    knobs = {"pipeline_depth": 1, "shard_exchange": "pallas_ring"}
    k0 = ring_exchange.launches
    facts = {}

    # unbudgeted: the rows to hold the budgeted run against
    m, rt, cbs = ol_app(device, APP.format(W=WINDOW), knobs, routed=True)
    q = rt.query_runtimes["bench"]
    ol_sends(rt, items[:1])
    state0 = pytree_nbytes(q._state)
    ol_sends(rt, items[1:])
    keys = q.selector_plan.num_keys * N_SHARDS
    _require(keys == 2 * KEY_SLOTS, f"OL gate 2: {keys} global key slots after growth")
    plain = cbs["OutStream"].batches
    m.shutdown()

    # 800 MB: denied before anything is allocated
    m, rt, cbs = ol_app(device, APP.format(W=WINDOW), knobs, routed=True)
    q = rt.query_runtimes["bench"]
    rt.set_statistics_level("basic")
    ctl = rt.enable_overload(memory_budget_mb=OL_DENY_MB)
    ol_sends(rt, items[:1])
    state, step, graph = q._state, q._step, q._step.graph
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    err = None
    try:
        rt.get_input_handler("StockStream").send_columns(*items[1])
    except FatalQueryError as e:
        err = str(e)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    _require(err is not None and "siddhi_tpu.quota_memory_mb" in err,
             f"OL gate 2: growth under {OL_DENY_MB} MB not denied naming the knob: {err}")
    projected = int(re.search(r"needs (\d+) B", err).group(1))
    counters = rt.statistics().get("counters", {})
    _require(ctl.quota_denials == 1 and counters.get("resilience.quota_denials") == 1,
             f"OL gate 2: quota_denials {ctl.quota_denials}, counter "
             f"{counters.get('resilience.quota_denials')}")
    _require(peak < base + projected,
             f"OL gate 2: peak {peak} B past the footprint {base} B plus the projected "
             f"growth {projected} B")
    _require(q._state is state and q._step is step and q._step.graph is graph
             and pytree_nbytes(q._state) == state0,
             "OL gate 2: the denied growth replaced the state, the step or its graph")
    facts["deny"] = {"budget_mb": OL_DENY_MB, "projected_bytes": projected,
                     "footprint_bytes": base, "peak_bytes": peak,
                     "peak_over_footprint_bytes": peak - base, "message": err}
    m.shutdown()
    print(f"[overload] gate 2: routed x4 growth {KEY_SLOTS} -> {2 * KEY_SLOTS} global keys denied "
          f"under {OL_DENY_MB} MB ({projected} B projected); resilience.quota_denials "
          f"1; peak {peak} B = footprint {base} B + {peak - base} B (< + {projected} B); "
          f"state, step and graph kept [{card}]", flush=True)

    # the process lives: a fresh app deploys and runs
    m, rt, cbs = ol_app(device, GLOBAL_APP.format(W=WINDOW), {"pipeline_depth": 1})
    ol_sends(rt, feed[:1])
    _require(cbs["OutStream"].rows == BATCH, "OL gate 2: a fresh app after the denial "
             f"emitted {cbs['OutStream'].rows} rows")
    m.shutdown()

    # 4,096 MB: the growth goes through and is charged
    m, rt, cbs = ol_app(device, APP.format(W=WINDOW), knobs, routed=True)
    q = rt.query_runtimes["bench"]
    ctl = rt.enable_overload(memory_budget_mb=OL_GROW_MB)
    ol_sends(rt, items[:1])
    caps0, mem0 = StepGraph.total_captures, torch.cuda.memory_allocated()
    ol_sends(rt, items[1:2])
    mem1 = torch.cuda.memory_allocated()
    ol_sends(rt, items[2:])
    grown = pytree_nbytes(q._state)
    _require(ctl.quota_denials == 0 and ctl.charged_bytes() == grown,
             f"OL gate 2: under {OL_GROW_MB} MB {ctl.quota_denials} denials, charged "
             f"{ctl.charged_bytes()} B vs the grown state's {grown} B")
    recaptures = StepGraph.total_captures - caps0
    _require(recaptures >= 1 and q.captured, f"OL gate 2: {recaptures} captures after "
             f"the growth")
    require_equal(cbs["OutStream"].batches, plain, "OL gate 2: rows under 4,096 MB vs "
                  "unbudgeted")
    m.shutdown()
    facts["grow"] = {"budget_mb": OL_GROW_MB, "charged_bytes": grown,
                     "allocated_delta_bytes": mem1 - mem0, "recaptures": recaptures,
                     "state_bytes_before": state0}
    launches = ring_exchange.launches - k0
    print(f"[overload] gate 2: under {OL_GROW_MB} MB the growth charged {grown} B (the "
          f"grown state's pytree_nbytes) against a memory_allocated delta of "
          f"{mem1 - mem0} B over the growth batch (the ledger leaves out the graph "
          f"pool and the cache slot), {recaptures} recapture(s), rows == unbudgeted; "
          f"K8 launched {launches} times in gate 2 [{card}]", flush=True)
    return facts, launches


def ol_flood(device, feed, policy: str, card: str):
    """Gate 3a: the @Async global flagship under a queue quota of 2, flooded
    through ``FaultInjector.flood_stream`` (the first half against a wedged
    worker): events in == rows consumed + shed, and the consumed units'
    rows == a synchronous run fed exactly those units."""
    import numpy as np

    from siddhi_tpu_torch.resilience import FaultInjector

    m, rt, cbs = ol_app(device, PIPE_APP.format(W=WINDOW), {})
    rt.set_statistics_level("basic")
    ctl = rt.enable_overload(queue_quota=2, shed_policy=policy)
    units = EventUnits()
    rt.add_callback("StockStream", units)
    cols = feed[0][0]
    syms, price, vol = cols["symbol"], cols["price"], cols["volume"]

    def row(i):
        i %= len(syms)
        return [str(syms[i]), float(price[i]), int(vol[i])]

    rt.start()
    j = rt.junctions["StockStream"]
    inj = FaultInjector()
    half = OL_FLOOD_EVENTS // 2
    inj.wedge_worker(j)
    _require(inj.wait_wedged(10.0), "OL gate 3: the worker did not wedge")
    sent = inj.flood_stream(j, ratio=1.0, base_events=half, make_data=row,
                            chunk=OL_FLOOD_CHUNK)
    inj.release()
    sent += inj.flood_stream(j, ratio=1.0, base_events=half,
                             make_data=lambda i: row(half + i), chunk=OL_FLOOD_CHUNK)
    deadline = time.perf_counter() + PIPE_TIMEOUT_S
    while (sum(len(u[0]) for u in units.units) + ctl.shed_events < sent
           and time.perf_counter() < deadline):
        time.sleep(0.01)
    consumed = sum(len(u[0]) for u in units.units)
    wait_rows(cbs["OutStream"], consumed, f"OL flood {policy}")
    inj.clear()
    tel = rt.app_context.telemetry.snapshot()["counters"]
    stat = rt.statistics().get("counters", {})
    m.shutdown()
    out = cbs["OutStream"]
    _require(sent == OL_FLOOD_EVENTS and consumed + ctl.shed_events == sent
             and out.rows == consumed and ctl.shed_events > 0,
             f"OL gate 3 {policy}: {sent} events in, {consumed} consumed, {out.rows} "
             f"rows, {ctl.shed_events} shed")
    _require(tel.get("junction.StockStream.shed_events") == ctl.shed_events
             == stat.get("resilience.shed_events"),
             f"OL gate 3 {policy}: shed counters {tel.get('junction.StockStream.shed_events')}"
             f", {stat.get('resilience.shed_events')} vs {ctl.shed_events}")
    # the units the queue admitted, fed synchronously as columns
    m2, rt2, cbs2 = ol_app(device, GLOBAL_APP.format(W=WINDOW), {"pipeline_depth": 1})
    h = rt2.get_input_handler("StockStream")
    for ts, rows in units.units:
        h.send_columns({"symbol": np.array([r[0] for r in rows], dtype=object),
                        "price": np.array([r[1] for r in rows], np.float32),
                        "volume": np.array([r[2] for r in rows], np.int64)},
                       timestamps=np.asarray(ts, np.int64))
    m2.shutdown()
    worst = require_equal(out.batches, cbs2["OutStream"].batches,
                          f"OL gate 3 {policy}: the flooded rows vs the admitted units "
                          f"fed synchronously", exact_floats=False)
    print(f"[overload] gate 3 {policy}: {sent} events flooded in {OL_FLOOD_CHUNK}-event "
          f"sends (half against a wedged worker), {consumed} consumed + "
          f"{ctl.shed_events} shed ({ctl.shed_units} units) == {sent}; rows == the "
          f"admitted units fed synchronously (max rel err {worst:.3g}) [{card}]",
          flush=True)
    return {"sent": sent, "consumed": consumed, "shed_events": ctl.shed_events,
            "shed_units": ctl.shed_units, "max_rel_err": worst}


def ol_wal(device, policy: str, card: str):
    """Gate 3b: persist after 5 batches, 5 more against quota 2 and a
    wedged worker, restore into a fresh runtime with the WAL: the replay
    gives exactly the live rows of the batches not shed. Rows compare as
    events (strings decoded): a shed batch was packed before admission,
    so its new strings took dictionary ids the replay hands out to the
    next new strings instead."""
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
    from siddhi_tpu_torch.resilience import FaultInjector

    feed = make_feed(OL_SEED + 2, OL_WAL_BATCHES, OL_WAL_BATCH, NUM_SYMBOLS)
    half = OL_WAL_BATCHES // 2
    app = "@app:name('ol_wal')\n" + PIPE_APP.format(W=WINDOW)
    store = InMemoryPersistenceStore()
    m, rt, cbs = ol_app(device, app, {}, store=store)
    ctl = rt.enable_overload(queue_quota=2, shed_policy=policy)
    wal = rt.enable_wal()
    out = cbs["OutStream"]
    live_rows = EventUnits()
    rt.add_callback("OutStream", live_rows)
    h = rt.get_input_handler("StockStream")
    for i, (cols, ts) in enumerate(feed[:half]):
        h.send_columns(cols, timestamps=ts)
        wait_rows(out, (i + 1) * OL_WAL_BATCH, f"OL WAL {policy} prefix")
    rt.persist()
    inj = FaultInjector()
    inj.wedge_worker(rt.junctions["StockStream"])
    _require(inj.wait_wedged(10.0), "OL gate 3: the worker did not wedge")
    for cols, ts in feed[half:]:
        h.send_columns(cols, timestamps=ts)
    kept = 2
    inj.release()
    wait_rows(out, (half + kept) * OL_WAL_BATCH, f"OL WAL {policy} suffix")
    wait_units(live_rows, half + kept, f"OL WAL {policy} suffix")
    inj.clear()
    live = live_rows.units[half:]
    held, shed = len(wal), ctl.shed_events
    m.shutdown()
    _require(shed == (OL_WAL_BATCHES - half - kept) * OL_WAL_BATCH and held == kept
             and len(live) == kept,
             f"OL gate 3 {policy}: {shed} shed, {held} WAL records, {len(live)} live "
             f"batches after the revision")
    m2, rt2, cbs2 = ol_app(device, app, {}, store=store)
    rt2.enable_overload(queue_quota=2, shed_policy=policy)
    restored_rows = EventUnits()
    rt2.add_callback("OutStream", restored_rows)
    rt2.app_context.ingest_wal = wal
    _require(rt2.restore_last_revision() is not None, "OL gate 3: no revision restored")
    wait_rows(cbs2["OutStream"], kept * OL_WAL_BATCH, f"OL WAL {policy} replay")
    wait_units(restored_rows, kept, f"OL WAL {policy} replay")
    time.sleep(0.3)               # nothing more: shed batches stay shed
    restored = restored_rows.units
    m2.shutdown()
    _require(len(restored) == len(live) and all(
        a[0] == b[0] and a[1] == b[1] for a, b in zip(restored, live)),
        f"OL gate 3 {policy}: the restored replay's {len(restored)} batches vs the "
        f"live rows of the {len(live)} batches not shed (timestamps, strings, "
        f"ints and floats exactly)")
    print(f"[overload] gate 3 {policy}: revision after {half} batches of {OL_WAL_BATCH}; "
          f"{OL_WAL_BATCHES - half} more against quota 2 and a wedged worker: "
          f"{shed} events shed, {held} WAL records kept; the restore replays them and "
          f"its rows == the live rows bit for bit [{card}]", flush=True)
    return {"shed_events": shed, "wal_records": held, "replayed_batches": len(restored)}


def spin_cycles(seconds: float) -> int:
    """``torch.cuda._sleep`` cycles that spin the card for ``seconds``,
    calibrated with CUDA events."""
    import torch

    torch.cuda._sleep(1_000_000)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(100_000_000)
    e.record()
    e.synchronize()
    return int(100_000_000 * seconds * 1e3 / s.elapsed_time(e))


@contextlib.contextmanager
def spin_before_meta(at: int, cycles: int):
    """Plant a device spin on the stream of the query step whose meta is
    staged ``at``-th (counting from 0): the spin runs before that meta's
    copy and event, as a hung step would hold them."""
    import torch

    from siddhi_tpu_torch.core.query import runtime as query_runtime

    orig = query_runtime.stage_meta
    seen = {"n": 0, "spun": 0}

    def staged(meta):
        i, seen["n"] = seen["n"], seen["n"] + 1
        if i == at:
            torch.cuda._sleep(cycles)
            seen["spun"] += 1
        return orig(meta)

    query_runtime.stage_meta = staged
    try:
        yield seen
    finally:
        query_runtime.stage_meta = orig


def graph_replays(q) -> int:
    graph = getattr(q._step, "graph", None)
    return graph.replays if graph is not None else 0


def ol_supervised(device, feed, fault, card: str):
    """One run of gate 4's @Async global flagship at depth 4 under
    ``supervise(0.05, 2.0)``: the first batch alone, then the rest; the
    fault ("wedge": the worker wedged mid-feed, released after its
    replacement drained; then a kill; "spin": a device spin before a
    meta) lands mid-feed. Returns (batches, facts)."""
    from siddhi_tpu_torch.resilience import FaultInjector

    m, rt, cbs = ol_app(device, PIPE_APP.format(W=WINDOW), {"pipeline_depth": 4})
    rt.set_statistics_level("basic")
    out = cbs["OutStream"]
    sup = rt.supervise(interval_s=0.05, wedge_timeout_s=OL_WEDGE_S)
    j = rt.junctions["StockStream"]
    h = rt.get_input_handler("StockStream")
    inj = FaultInjector()
    q = rt.query_runtimes["bench"]
    facts = {}
    h.send_columns(*feed[0])
    wait_rows(out, BATCH, "OL supervised first batch")
    if fault == "spin":
        # five batches queue up behind a short worker delay (under the wedge
        # timeout), so the worker dispatches them back to back: the spin
        # before batch 1's meta holds it, and the fifth submit's forced
        # drain waits on it while batch 5 rides the pump
        cycles = spin_cycles(OL_SPIN_S)
        with spin_before_meta(at=1, cycles=cycles) as seen:
            inj.delay_worker(j, 0.3)
            time.sleep(0.15)
            for cols, ts in feed[1:6]:
                h.send_columns(cols, timestamps=ts)
            wait_rows(out, 6 * BATCH, "OL spin")
        _require(seen["spun"] == 1, f"OL gate 4: {seen['spun']} spins planted")
        time.sleep(3 * 0.05)
        facts.update(pump_wedges=sup.pump_wedges, restarts=sup.worker_restarts)
        stat = rt.statistics().get("counters", {})
        _require(sup.pump_wedges == 1 == stat.get("resilience.pump_wedges"),
                 f"OL gate 4: pump_wedges {sup.pump_wedges} (counter "
                 f"{stat.get('resilience.pump_wedges')}) for one {OL_SPIN_S} s spin")
    else:
        for cols, ts in feed[1:4]:
            h.send_columns(cols, timestamps=ts)
        if fault == "wedge":
            wait_rows(out, 4 * BATCH, "OL before the wedge")
            inj.wedge_worker(j)
            _require(inj.wait_wedged(10.0), "OL gate 4: the worker did not wedge")
            stale = j._worker
        for cols, ts in feed[4:8]:
            h.send_columns(cols, timestamps=ts)
        wait_rows(out, 8 * BATCH, "OL supervised")
        if fault == "wedge":
            _require(sup.worker_restarts == 1, f"OL gate 4: {sup.worker_restarts} "
                     f"restarts for one wedge")
            replays = graph_replays(q)
            inj.release()
            stale.join(5.0)
            time.sleep(0.3)
            _require(not stale.is_alive() and graph_replays(q) == replays
                     and out.rows == 8 * BATCH,
                     f"OL gate 4: the released stale worker alive {stale.is_alive()}, "
                     f"replays {replays} -> {graph_replays(q)}, rows {out.rows}")
            killed = j._worker
            inj.kill_worker(j)
            deadline = time.perf_counter() + 10.0
            while sup.worker_restarts < 2 and time.perf_counter() < deadline:
                time.sleep(0.01)
            _require(sup.worker_restarts == 2 and not killed.is_alive(),
                     f"OL gate 4: {sup.worker_restarts} restarts after the kill")
        for cols, ts in feed[8:]:
            h.send_columns(cols, timestamps=ts)
        wait_rows(out, len(feed) * BATCH, "OL supervised tail")
        facts.update(restarts=sup.worker_restarts, pump_wedges=sup.pump_wedges,
                     replays=graph_replays(q))
    stat = rt.statistics().get("counters", {})
    facts["worker_restarts_counter"] = stat.get("resilience.worker_restarts", 0)
    inj.clear()
    m.shutdown()
    return out.batches, facts


def ol_packers(device, feed, card: str):
    """Gate 4: an ingest pool of 4 under the supervisor, one packer killed
    mid-pack: its sub-batch re-packed, the pool back to 4 workers, rows
    == the same feed without the pool."""
    from siddhi_tpu_torch.resilience import FaultInjector

    rows = {}
    for pool_n in (0, 4):
        m, rt, cbs = ol_app(device, PIPE_APP.format(W=WINDOW),
                            {"pipeline_depth": 4, "ingest_pool": pool_n})
        rt.start()
        sup = rt.supervise(interval_s=0.05)
        inj = FaultInjector()
        pool = rt.app_context.ingest_pack_pool
        if pool_n:
            inj.kill_packer(pool)
        h = rt.get_input_handler("StockStream")
        for cols, ts in feed[:2]:
            h.send_columns(cols, timestamps=ts)
        wait_rows(cbs["OutStream"], 2 * BATCH, f"OL pool {pool_n}")
        if pool_n:
            deadline = time.perf_counter() + 5.0
            while pool.alive_workers() < pool_n and time.perf_counter() < deadline:
                time.sleep(0.01)
            facts = {"deaths": pool.worker_deaths, "alive": pool.alive_workers(),
                     "repacked": pool.repacked_subbatches, "healed": sup.worker_restarts}
            _require(facts["deaths"] == 1 and facts["alive"] == pool_n
                     and facts["repacked"] == 1, f"OL gate 4: the pool after a kill {facts}")
        rows[pool_n] = cbs["OutStream"].batches
        inj.clear()
        m.shutdown()
    require_equal(rows[4], rows[0], "OL gate 4: rows with a killed packer vs no pool")
    print(f"[overload] gate 4: ingest pool of 4, one packer killed: its sub-batch "
          f"re-packed, {facts['alive']} workers alive ({facts['healed']} respawned by "
          f"the supervisor's heal), rows == no pool [{card}]", flush=True)
    return facts


def ol_tenants(device, feed, card: str):
    """Gate 5a: D1 (@Async, H = 64, the distinct scan inside its graph) solo,
    then beside a flooded global flagship (quota 2, shed_oldest) on one
    card: D1's rows bit-identical, the flood's accounting exact; D1's
    per-batch latency recorded."""
    import numpy as np

    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.resilience import FaultInjector, OverloadManager

    d1_app = "@app:name('ol_d1')\n@Async(buffer.size='64')\n" + D1_APP.format(W=WINDOW)
    fair = OverloadManager.instance().fair
    yields = {}
    orig = fair.throttle

    def counted(name, units):
        d = orig(name, units)
        if d:
            yields[name] = yields.get(name, 0) + 1
        return d

    facts, launches = {}, 0
    fair.throttle = counted
    try:
        runs = {}
        for mode in ("solo", "flooded"):
            k0 = distinct_scan.launches
            stack = contextlib.ExitStack()
            rec = stack.enter_context(recording(at=3)) if mode == "flooded" else None
            m, rt, cbs = ol_app(device, d1_app, {})
            rt.enable_overload(fair_weight=1.0)
            out = cbs["OutStream"]
            h = rt.get_input_handler("StockStream")
            h.send_columns(*feed[0])
            wait_rows(out, BATCH, f"OL D1 {mode} first batch")
            if mode == "flooded":
                mf = ol_manager(device, {})
                rtf = mf.create_siddhi_app_runtime(
                    "@app:name('ol_flood')\n" + PIPE_APP.format(W=WINDOW))
                rtf.query_runtimes["bench"].selector_plan.num_keys = KEY_SLOTS
                flood_out = collector()
                rtf.add_callback("OutStream", flood_out)
                units = EventUnits()
                rtf.add_callback("StockStream", units)
                ctl = rtf.enable_overload(queue_quota=2, shed_policy="shed_oldest")
                rtf.start()
                cols = feed[1][0]
                inj = FaultInjector()
                inj.flood_stream(rtf.junctions["StockStream"], ratio=1.0,
                                 base_events=OL_FLOOD_EVENTS, chunk=OL_FLOOD_CHUNK,
                                 make_data=lambda i: [str(cols["symbol"][i % BATCH]),
                                                      float(cols["price"][i % BATCH]),
                                                      int(cols["volume"][i % BATCH])],
                                 block=False)
            with stack:
                sends = []
                for cols_, ts in feed[1:]:
                    sends.append(time.perf_counter())
                    h.send_columns(cols_, timestamps=ts)
                wait_rows(out, len(feed) * BATCH, f"OL D1 {mode}")
            lat = [(a - s) * 1e3 for a, s in zip(out.arrivals[1:], sends)]
            runs[mode] = {"batches": out.batches, "latency_ms": lat}
            if mode == "flooded":
                inj.clear()          # joins the flood thread
                deadline = time.perf_counter() + PIPE_TIMEOUT_S
                while (sum(len(u[0]) for u in units.units) + ctl.shed_events
                       < OL_FLOOD_EVENTS and time.perf_counter() < deadline):
                    time.sleep(0.01)
                consumed = sum(len(u[0]) for u in units.units)
                wait_rows(flood_out, consumed, "OL flooded tenant")
                mf.shutdown()
                _require(consumed + ctl.shed_events == OL_FLOOD_EVENTS
                         and flood_out.rows == consumed,
                         f"OL gate 5: the flooded tenant {consumed} consumed + "
                         f"{ctl.shed_events} shed vs {OL_FLOOD_EVENTS} in, "
                         f"{flood_out.rows} rows")
                facts["flood"] = {"consumed": consumed, "shed_events": ctl.shed_events}
            m.shutdown()
            # the main path's launches; the check's own launches are not
            launches += distinct_scan.launches - k0
            if mode == "flooded":
                facts["scan_max_abs_err"] = check_graph_scan(
                    rec, "OL gate 5: D1's distinct scan replayed beside the flood")
                facts["scan_replays_recorded"] = rec.replays
    finally:
        fair.throttle = orig
    require_equal(runs["flooded"]["batches"], runs["solo"]["batches"],
                  "OL gate 5: D1 beside the flooded tenant vs solo")
    for mode in ("solo", "flooded"):
        lat = sorted(runs[mode]["latency_ms"])
        facts[f"d1_{mode}_latency_ms"] = {"p50": statistics.median(lat),
                                          "p99": float(np.percentile(lat, 99)),
                                          "max": lat[-1]}
    facts["fair_yields"] = yields
    _require(launches == 2 * len(feed),
             f"OL gate 5: {launches} distinct-scan launches for 2 x {len(feed)} D1 batches")
    print(f"[overload] gate 5: D1 beside a flooded global flagship (quota 2, "
          f"shed_oldest): rows bit-identical to solo; the flood {facts['flood']['consumed']} "
          f"consumed + {facts['flood']['shed_events']} shed == {OL_FLOOD_EVENTS}; D1 "
          f"per-batch latency p50/p99 solo {facts['d1_solo_latency_ms']['p50']:.2f}/"
          f"{facts['d1_solo_latency_ms']['p99']:.2f} ms, flooded "
          f"{facts['d1_flooded_latency_ms']['p50']:.2f}/"
          f"{facts['d1_flooded_latency_ms']['p99']:.2f} ms (host clock, recorded); "
          f"fair yields {yields}; the replayed scan == plain [{card}]", flush=True)
    return facts, launches


def ol_pipeline_quota(device, feed, card: str):
    """Gate 5b: the global flagship and D1 on two @Async streams of one app
    at pipeline_depth 8, unbounded and under quota_pipeline_depth 2: rows
    bit-equal, the most in flight bounded; D1's replayed scan == plain.
    The program cache is off for this app, so its steps capture their own
    graphs (a same-program entry another app holds would replay a graph
    whose capture the scan recorder never saw)."""
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    facts, runs, launches = {}, {}, 0
    for quota in (None, 2):
        k0 = distinct_scan.launches
        knobs = {"pipeline_depth": 8, "program_cache": "false"}
        if quota is not None:
            knobs["quota_pipeline_depth"] = quota
        stack = contextlib.ExitStack()
        rec = stack.enter_context(recording(at=4)) if quota else None
        m, rt, cbs = ol_app(device, PQ_APP.format(W=WINDOW), knobs, queries=("bench", "d1"),
                            outs=("OutStream", "DistinctOut"))
        pump = rt.app_context.completion_pump
        _require((rt.app_context.overload is not None) == (quota is not None),
                 "OL gate 5: the pipeline quota did not register from its key")
        most = {"total": 0, "owner": 0}
        submit = pump.submit

        def watched(entry, _submit=submit, _pump=pump):
            _submit(entry)
            most["total"] = max(most["total"], _pump._n_pending)
            most["owner"] = max(most["owner"], _pump.inflight(entry.owner))

        pump.submit = watched
        hs, hd = rt.get_input_handler("StockStream"), rt.get_input_handler("DistinctStream")
        with stack:
            for cols, ts in feed[:OL_PQ_BATCHES]:
                hs.send_columns(cols, timestamps=ts)
                hd.send_columns(cols, timestamps=ts)
            wait_rows(cbs["OutStream"], OL_PQ_BATCHES * BATCH, "OL pipeline quota")
            wait_rows(cbs["DistinctOut"], OL_PQ_BATCHES * BATCH, "OL pipeline quota D1")
        runs[quota] = {o: cb.batches for o, cb in cbs.items()}
        facts[f"most_in_flight_{quota}"] = most
        m.shutdown()
        launches += distinct_scan.launches - k0
        if quota:
            facts["scan_max_abs_err"] = check_graph_scan(
                rec, "OL gate 5: D1's scan replayed under the pipeline quota")
    for o in ("OutStream", "DistinctOut"):
        require_equal(runs[2][o], runs[None][o], f"OL gate 5: {o} under quota 2 vs unbounded")
    bound = 2 + 2 - 1
    _require(facts["most_in_flight_2"]["total"] <= bound,
             f"OL gate 5: {facts['most_in_flight_2']['total']} in flight under quota 2 "
             f"(two queries: at most {bound})")
    _require(launches == 2 * OL_PQ_BATCHES,
             f"OL gate 5: {launches} distinct-scan launches for 2 x {OL_PQ_BATCHES} D1 "
             f"batches")
    print(f"[overload] gate 5: pipeline quota 2 at depth 8, the global flagship and D1 "
          f"on two @Async streams: rows bit-equal to unbounded; most in flight after a "
          f"submit {facts['most_in_flight_2']} (unbounded {facts['most_in_flight_None']}); "
          f"D1's replayed scan == plain; {launches} distinct-scan launches [{card}]",
          flush=True)
    return facts, launches


def phase_overload(device, card: str):
    """Phase 26 (see the module doc). Returns (facts, exchange launches,
    distinct-scan launches, exchange launches under replay)."""
    t_phase = time.perf_counter()
    feed = make_feed(OL_SEED, OL_BATCHES, BATCH, NUM_SYMBOLS)
    facts = {"card": card}
    facts["zero_cost"], ex_launches, ex_replays = ol_zero_cost(device, feed, card)
    facts["budget"], grow_launches = ol_budget(device, feed, card)
    ex_launches += grow_launches
    for policy in ("shed_oldest", "shed_newest"):
        facts[f"flood_{policy}"] = ol_flood(device, feed, policy, card)
        facts[f"wal_{policy}"] = ol_wal(device, policy, card)
    sup_feed = make_feed(OL_SEED + 3, OL_SUP_BATCHES, BATCH, NUM_SYMBOLS)
    plain, plain_facts = ol_supervised(device, sup_feed, None, card)
    wedged, wedge_facts = ol_supervised(device, sup_feed, "wedge", card)
    require_equal(wedged, plain, "OL gate 4: rows with a wedged and a killed worker vs "
                  "unfaulted")
    _require(plain_facts["restarts"] == 0 and wedge_facts["restarts"] == 2
             and wedge_facts["replays"] == plain_facts["replays"],
             f"OL gate 4: unfaulted {plain_facts}, faulted {wedge_facts}")
    print(f"[overload] gate 4: @Async global flagship at depth 4 supervised: a worker "
          f"wedged mid-feed replaced once, a killed one restarted; every batch once, in "
          f"order: rows bit-equal to the unfaulted run; {wedge_facts['replays']} graph "
          f"replays either way [{card}]", flush=True)
    spun, spin_facts = ol_supervised(device, sup_feed[:6], "spin", card)
    require_equal(spun, plain[:6], "OL gate 4: rows with a planted device spin vs "
                  "unfaulted")
    print(f"[overload] gate 4: a {OL_SPIN_S} s device spin before one meta: pump_wedges "
          f"{spin_facts['pump_wedges']} (the worker restarted "
          f"{spin_facts['restarts']} time(s) while blocked on it), rows unchanged "
          f"[{card}]", flush=True)
    facts["supervisor"] = {"plain": plain_facts, "wedge": wedge_facts, "spin": spin_facts,
                           "packers": ol_packers(device, sup_feed, card)}
    facts["tenants"], scan_launches = ol_tenants(device, feed, card)
    facts["pipeline_quota"], pq_launches = ol_pipeline_quota(device, sup_feed, card)
    scan_launches += pq_launches
    facts["phase_s"] = time.perf_counter() - t_phase
    facts["launches"] = {"exchange": ex_launches, "scan": scan_launches}
    print(f"[overload] phase 26 in {facts['phase_s']:.1f} s: K8 {ex_launches} launches, "
          f"the distinct scan {scan_launches} [{card}]", flush=True)
    return facts, ex_launches, scan_launches, ex_replays


# ---------------------------------------------------- phase 27: autopilot

AP_SEED = 27
AP_BATCHES = 8                  # each run: a cut of depth
AP_SHARDS = 2                   # the routed flagship's install, UP to 4 and back
AP_ROWS_PER_SHARD = 40_960      # B / 2 * 1.25: every pair's quota holds at 2 and 4
AP_UP_AT, AP_DOWN_AT = 3, 6     # route_shards UP before batch 3, DOWN before 6
AP_RECORD_AT = 4                # the exchange call held against plain: batch 4's
                                # replay, the first after the 4-shard capture
AP_MEM_AT = 2                   # memory_allocated read after this batch and the last
AP_FO_DOWN_AT, AP_FO_UP_AT = 2, 5
AP_INTERVAL_S = 0.05            # the controller thread's cadence under live ingest
AP_COOLDOWN_S = 0.2
AP_DRY = {"autopilot": "dry_run", "autopilot_interval_s": AP_INTERVAL_S}


def ap_routed(device, knobs=None):
    """(manager, runtime, collector) of the routed flagship (phase 4's
    app and key slots) installed over AP_SHARDS logical shards."""
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    m = ol_manager(device, {"shard_exchange": "pallas_ring", "pipeline_depth": 1,
                            **(knobs or {})})
    rt = m.create_siddhi_app_runtime(APP.format(W=WINDOW))
    q = rt.query_runtimes["bench"]
    q.selector_plan.num_keys = KEY_SLOTS
    q._win_keys = KEY_SLOTS
    device_route_query_step(q, make_mesh(AP_SHARDS, device),
                            rows_per_shard=AP_ROWS_PER_SHARD)
    cb = collector()
    rt.add_callback("OutStream", cb)
    return m, rt, cb


def graph_input_bytes(graph) -> int:
    """Bytes of a step graph's static input columns: one packed batch as
    the card holds it."""
    return sum(t.numel() * t.element_size() for cap in graph._graphs.values()
               for t in cap.inputs.values())


def ap_route_run(device, feed, actuate: bool, record_at=None):
    """The routed flagship at 2 shards over ``feed``; with ``actuate``,
    ``route_shards`` UP before batch AP_UP_AT and DOWN before AP_DOWN_AT.
    Returns (rows, facts): K8 launches a batch, shard counts, captures,
    memory_allocated after batch AP_MEM_AT and after the last, one packed
    batch's bytes, and the exchange recorder."""
    import torch

    from siddhi_tpu_torch.autopilot import ACTUATORS
    from siddhi_tpu_torch.autopilot.actuators import DOWN, UP
    from siddhi_tpu_torch.core.query.step_graph import StepGraph
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    rec_ctx = recording_exchange(at=record_at) if record_at is not None \
        else contextlib.nullcontext()
    facts = {"launches": [], "shards": [], "moves": []}
    with rec_ctx as rec:
        m, rt, cb = ap_routed(device)
        q = rt.query_runtimes["bench"]
        h = rt.get_input_handler("StockStream")
        c0 = StepGraph.total_captures
        for i, (cols, ts) in enumerate(feed):
            if actuate and i in (AP_UP_AT, AP_DOWN_AT):
                want = (2, 4) if i == AP_UP_AT else (4, 2)
                got = ACTUATORS["route_shards"].apply(rt, UP if i == AP_UP_AT else DOWN)
                _require(got == want, f"AP route_shards before batch {i}: {got}, want {want}")
                facts["moves"].append(got)
            k0 = ring_exchange.launches
            h.send_columns(cols, timestamps=ts)
            torch.cuda.synchronize()
            facts["launches"].append(ring_exchange.launches - k0)
            facts["shards"].append(q._route_layout.n)
            if i == AP_MEM_AT:
                facts["mem_start"] = torch.cuda.memory_allocated()
        facts["mem_end"] = torch.cuda.memory_allocated()
        facts["packed_batch_bytes"] = graph_input_bytes(q._step.graph)
        facts["captures"] = StepGraph.total_captures - c0
        m.shutdown()
    facts["recorder"] = rec
    return concat_rows(cb.batches), facts


def ap_reshard(device, feed, card: str):
    """Gate 1: route_shards 2 -> 4 -> 2 on the routed flagship mid-feed."""
    plain, pf = ap_route_run(device, feed, actuate=False)
    moved, mf = ap_route_run(device, feed, actuate=True)
    recorded, rf = ap_route_run(device, feed, actuate=True, record_at=AP_RECORD_AT)
    require_equal(moved, plain, "AP gate 1: rows with route_shards 2 -> 4 -> 2 vs unactuated")
    require_equal(recorded, plain, "AP gate 1: the recorded actuated run vs unactuated")
    want_shards = [2] * AP_UP_AT + [4] * (AP_DOWN_AT - AP_UP_AT) \
        + [2] * (len(feed) - AP_DOWN_AT)
    _require(mf["shards"] == want_shards, f"AP gate 1: shard counts {mf['shards']}")
    _require(mf["launches"] == [1] * len(feed) == pf["launches"],
             f"AP gate 1: K8 launches a batch actuated {mf['launches']}, "
             f"unactuated {pf['launches']}: want one a batch")
    _require(mf["captures"] == 3 and pf["captures"] == 1,
             f"AP gate 1: captures actuated {mf['captures']} (want 3: one an install), "
             f"unactuated {pf['captures']}")
    rec = rf["recorder"]
    _require(rec.got is not None, f"AP gate 1: exchange call {AP_RECORD_AT} (a replay after "
             f"the 4-shard re-install) was not recorded")
    cols = check_exchange_call(rec, "AP gate 1: K8 inside the 4-shard graph's replay")
    drift = mf["mem_end"] - mf["mem_start"]
    _require(abs(drift) <= mf["packed_batch_bytes"],
             f"AP gate 1: memory_allocated {mf['mem_start']} -> {mf['mem_end']} after the "
             f"2 -> 4 -> 2 round trip, beyond one packed batch ({mf['packed_batch_bytes']} B)")
    print(f"[autopilot] gate 1: routed flagship at 2 logical shards, route_shards UP before "
          f"batch {AP_UP_AT} and DOWN before {AP_DOWN_AT}: rows bit-equal to the unactuated "
          f"run; K8 launched once a batch ({sum(mf['launches'])} launches, 3 captures: one an "
          f"install), the replay after the 4-shard capture == plain on its {cols} columns; "
          f"memory_allocated {mf['mem_start']} -> {mf['mem_end']} B (drift {drift} B, one "
          f"packed batch {mf['packed_batch_bytes']} B) [{card}]", flush=True)
    launches = sum(mf["launches"]) + sum(pf["launches"]) + sum(rf["launches"])
    return plain, {"shards": mf["shards"], "launches": mf["launches"],
                   "captures": mf["captures"], "mem_start": mf["mem_start"],
                   "mem_end": mf["mem_end"], "mem_drift": drift,
                   "packed_batch_bytes": mf["packed_batch_bytes"],
                   "exchange_columns_checked": cols,
                   "exchange_replays_recorded_run": rec.replays}, launches


def ap_fanout(device, feed, card: str):
    """Gate 2: fuse_fanout DOWN then UP on FO (seven siblings, D1 among
    them): rows equal, the recaptures counted."""
    import torch

    from siddhi_tpu_torch.autopilot import ACTUATORS
    from siddhi_tpu_torch.autopilot.actuators import DOWN, UP
    from siddhi_tpu_torch.core.query.step_graph import StepGraph
    from siddhi_tpu_torch.ops.distinct import distinct_scan

    out, facts, launches = {}, {}, 0
    for label in ("plain", "actuated"):
        c0, k0 = StepGraph.total_captures, distinct_scan.launches
        run = FoRun(device, fused=True, depth=1)
        groups = []
        for i, b in enumerate(feed):
            if label == "actuated" and i in (AP_FO_DOWN_AT, AP_FO_UP_AT):
                got = ACTUATORS["fuse_fanout"].apply(run.rt, DOWN if i == AP_FO_DOWN_AT else UP)
                _require(got is not None, f"AP gate 2: fuse_fanout did not apply before batch {i}")
            run.send([b])
            groups.append(len(run.rt.fused_fanout_groups))
        torch.cuda.synchronize()
        out[label] = run.close()
        facts[label] = {"captures": StepGraph.total_captures - c0,
                        "scan_launches": distinct_scan.launches - k0, "groups": groups}
        launches += facts[label]["scan_launches"]
    worst = fo_compare(out["actuated"], out["plain"], "AP gate 2: FO dissolved and re-formed "
                       "vs fused throughout")
    a, p = facts["actuated"], facts["plain"]
    want_groups = [1] * AP_FO_DOWN_AT + [0] * (AP_FO_UP_AT - AP_FO_DOWN_AT) \
        + [1] * (len(feed) - AP_FO_UP_AT)
    _require(a["groups"] == want_groups, f"AP gate 2: fused groups a batch {a['groups']}")
    _require(a["scan_launches"] == p["scan_launches"] == len(feed),
             f"AP gate 2: distinct-scan launches actuated {a['scan_launches']}, fused "
             f"throughout {p['scan_launches']}: want one a batch")
    _require(a["captures"] > p["captures"],
             f"AP gate 2: {a['captures']} captures actuated vs {p['captures']}: the "
             f"dissolved members and the re-formed group never recaptured")
    print(f"[autopilot] gate 2: FO's group dissolved at batch {AP_FO_DOWN_AT} and re-formed "
          f"at {AP_FO_UP_AT} (groups a batch {a['groups']}): rows equal (max abs float diff "
          f"{worst:.3g}), {a['captures']} graph captures vs {p['captures']} fused throughout, "
          f"the distinct scan once a batch [{card}]", flush=True)
    return {"groups": a["groups"], "captures": a["captures"],
            "captures_fused_throughout": p["captures"], "max_abs_diff": worst}, launches


def ap_async_run(device, feed, actuate: bool):
    """The @Async global flagship (PIPE_APP) at depth 1; with ``actuate``,
    pipeline_depth 1 -> 2 with batches pending and ingest_pool 0 -> 2 -> 0
    between sends. Returns (rows, facts)."""
    import torch

    from siddhi_tpu_torch.autopilot import ACTUATORS
    from siddhi_tpu_torch.autopilot.actuators import DOWN, UP

    schedule = {1: ("pipeline_depth", UP), 2: ("ingest_pool", UP), 3: ("ingest_pool", UP),
                5: ("ingest_pool", DOWN), 6: ("ingest_pool", DOWN)}
    m, rt, cbs = ol_app(device, PIPE_APP.format(W=WINDOW), {"pipeline_depth": 1})
    ctx = rt.app_context
    h = rt.get_input_handler("StockStream")
    moves, subbatches = [], 0
    for i, (cols, ts) in enumerate(feed):
        if actuate and i in schedule:
            pool = ctx.ingest_pack_pool
            if pool is not None:
                subbatches += pool.subbatches
            name, direction = schedule[i]
            moves.append((name, ACTUATORS[name].apply(rt, direction)))
        h.send_columns(cols, timestamps=ts)
    if ctx.ingest_pack_pool is not None:
        subbatches += ctx.ingest_pack_pool.subbatches
    wait_rows(cbs["OutStream"], len(feed) * BATCH, "AP gate 3")
    ctx.completion_pump.flush()
    torch.cuda.synchronize()
    facts = {"moves": moves, "depth": ctx.pipeline_depth,
             "high_water": ctx.completion_pump.high_water, "pool_subbatches": subbatches}
    m.shutdown()
    return concat_rows(cbs["OutStream"].batches), facts


def ap_async(device, feed, card: str):
    """Gate 3: pipeline_depth and ingest_pool actuated behind @Async."""
    plain, _pf = ap_async_run(device, feed, actuate=False)
    moved, mf = ap_async_run(device, feed, actuate=True)
    require_equal(moved, plain, "AP gate 3: rows with depth 1 -> 2 and the pool 0 -> 2 -> 0 "
                  "vs unactuated")
    want = [("pipeline_depth", (1, 2)), ("ingest_pool", (0, 1)), ("ingest_pool", (1, 2)),
            ("ingest_pool", (2, 1)), ("ingest_pool", (1, 0))]
    _require(mf["moves"] == want, f"AP gate 3: moves {mf['moves']}")
    _require(mf["pool_subbatches"] >= 2, f"AP gate 3: the pool of 2 packed "
             f"{mf['pool_subbatches']} sub-batches")
    print(f"[autopilot] gate 3: @Async global flagship, pipeline_depth 1 -> 2 with batches "
          f"pending (pump high water {mf['high_water']}), ingest_pool 0 -> 1 -> 2 -> 1 -> 0 "
          f"({mf['pool_subbatches']} sub-batches pooled): rows bit-equal to unactuated "
          f"[{card}]", flush=True)
    return {"moves": mf["moves"], "high_water": mf["high_water"],
            "pool_subbatches": mf["pool_subbatches"]}


def ap_dry_run(device, feed, card: str):
    """Gate 4: mode off vs dry_run (the controller thread ticking every
    AP_INTERVAL_S) on the global and the routed x4 flagship: rows
    bit-equal, host syncs a send and host launch calls a batch equal, no
    decision applied; a tick makes no host sync."""
    from siddhi_tpu_torch.autopilot import AutopilotController
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    ctl = AutopilotController.instance()
    facts, launches = {}, 0
    for label, app, knobs in (
            ("global", GLOBAL_APP.format(W=WINDOW), {"pipeline_depth": 1}),
            ("routed", APP.format(W=WINDOW),
             {"pipeline_depth": 1, "shard_exchange": "pallas_ring"})):
        runs = {}
        for mode in ("off", "dry_run"):
            k0 = ring_exchange.launches
            m, rt, cbs = ol_app(device, app, {**knobs, **(AP_DRY if mode == "dry_run" else {})},
                                routed=label == "routed")
            syncs = ol_sends(rt, feed[:-1])
            h = rt.get_input_handler("StockStream")
            prof = profile_batch(f"AP {label}, autopilot {mode}, batch {len(feed)}",
                                 lambda: h.send_columns(*feed[-1]), card)
            run = {"rows": concat_rows(cbs["OutStream"].batches), "syncs": syncs,
                   "calls": prof["host_launch_calls"]}
            if mode == "dry_run":
                tick = {}
                with counting_syncs(tick):
                    for _ in range(3):
                        ctl.tick(rt.name)
                rep = ctl.report(rt.name)["apps"][rt.name]
                run.update(tick_syncs=tick["syncs"], ticks=rep["ticks"],
                           decisions=rep["decisions"],
                           applied=sum(1 for d in rep["decisions"] if d["applied"]))
            m.shutdown()
            launches += ring_exchange.launches - k0
            runs[mode] = run
        off, dry = runs["off"], runs["dry_run"]
        require_equal(dry["rows"], off["rows"], f"AP gate 4 {label}: rows dry_run vs off")
        _require(dry["syncs"][1:] == off["syncs"][1:],
                 f"AP gate 4 {label}: host syncs a send dry_run {dry['syncs']} vs off "
                 f"{off['syncs']}")
        _require(dry["calls"] == off["calls"], f"AP gate 4 {label}: {dry['calls']} host "
                 f"launch calls a batch dry_run vs {off['calls']} off")
        _require(dry["tick_syncs"] == 0, f"AP gate 4 {label}: 3 ticks made "
                 f"{dry['tick_syncs']} host syncs")
        _require(dry["applied"] == 0 and dry["ticks"] >= 3,
                 f"AP gate 4 {label}: dry run applied {dry['applied']} decisions in "
                 f"{dry['ticks']} ticks")
        facts[label] = {"syncs_off": off["syncs"], "syncs_dry_run": dry["syncs"],
                        "launch_calls_off": off["calls"], "launch_calls_dry_run": dry["calls"],
                        "ticks": dry["ticks"], "decisions": len(dry["decisions"])}
        print(f"[autopilot] gate 4 {label}: dry_run (ticking every {AP_INTERVAL_S} s, "
              f"{dry['ticks']} ticks, {len(dry['decisions'])} decisions logged, none applied) "
              f"vs off: rows bit-equal, host syncs a send {dry['syncs']} == {off['syncs']} "
              f"(after the first), host launch calls a batch {dry['calls']} == "
              f"{off['calls']}, 0 syncs in 3 ticks [{card}]", flush=True)
    return facts, launches


def ap_controller(device, feed, plain, card: str):
    """Gate 5: the controller thread ON (every AP_INTERVAL_S, cooldown
    AP_COOLDOWN_S) over the routed flagship at 2 shards under live
    ingest: rows bit-equal to the unactuated run; the decision log."""
    import torch

    from siddhi_tpu_torch.autopilot import AutopilotController
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    ctl = AutopilotController.instance()
    k0 = ring_exchange.launches
    m, rt, cb = ap_routed(device, {"autopilot": "on", "autopilot_interval_s": AP_INTERVAL_S,
                                   "autopilot_cooldown_s": AP_COOLDOWN_S})
    h = rt.get_input_handler("StockStream")
    for cols, ts in feed:
        h.send_columns(cols, timestamps=ts)
        torch.cuda.synchronize()
    rep = ctl.report(rt.name)["apps"][rt.name]
    shards = rt.query_runtimes["bench"]._route_layout.n
    m.shutdown()
    launches = ring_exchange.launches - k0
    require_equal(concat_rows(cb.batches), plain,
                  "AP gate 5: rows with the controller ON vs the unactuated run")
    _require(rep["ticks"] >= 1, f"AP gate 5: the controller thread ticked {rep['ticks']} times")
    applied = [d for d in rep["decisions"] if d["applied"]]
    print(f"[autopilot] gate 5: controller ON every {AP_INTERVAL_S} s over {len(feed)} "
          f"routed batches: {rep['ticks']} ticks, {rep['freezes']} frozen by the compile "
          f"storm, {len(rep['decisions'])} decisions ({len(applied)} applied), {shards} shards "
          f"at the end; rows bit-equal to the unactuated run [{card}]", flush=True)
    for d in rep["decisions"][-12:]:
        print(f"[autopilot] decision {json.dumps(d)}", flush=True)
    return {"ticks": rep["ticks"], "freezes": rep["freezes"],
            "decisions": rep["decisions"][-32:], "applied": len(applied),
            "shards_at_end": shards}, launches


def phase_autopilot(device, card: str):
    """Phase 27 (see the module doc). Returns (facts, exchange launches,
    distinct-scan launches)."""
    t_phase = time.perf_counter()
    feed = make_feed(AP_SEED, AP_BATCHES, BATCH, NUM_SYMBOLS)
    facts = {"card": card}
    plain, facts["reshard"], ex_launches = ap_reshard(device, feed, card)
    facts["fanout"], scan_launches = ap_fanout(device, feed, card)
    facts["async"] = ap_async(device, feed, card)
    facts["dry_run"], dry_launches = ap_dry_run(device, feed, card)
    facts["controller"], ctl_launches = ap_controller(device, feed, plain, card)
    ex_launches += dry_launches + ctl_launches
    facts["phase_s"] = time.perf_counter() - t_phase
    facts["launches"] = {"exchange": ex_launches, "scan": scan_launches}
    print(f"[autopilot] phase 27 in {facts['phase_s']:.1f} s: K8 {ex_launches} launches, "
          f"the distinct scan {scan_launches} [{card}]", flush=True)
    return facts, ex_launches, scan_launches


# ------------------------------------------------ phase 28: cluster fabric

CL_SEED = 28
CL_BATCHES = 6                  # a cut of depth: each batch crosses the sockets twice
CL_WORKERS = 2
CL_CHECKPOINT_AFTER = 1         # a checkpoint barrier after batch 1
CL_KILL_AFTER = 3               # worker 1 killed after batch 3, mid-feed
CL_TIMEOUT_S = 300              # every wait of the phase is bounded by it
# the split app: per-symbol length windows with distinctCount (H = 64 holds
# a window of 50), so the distinct scan runs in every worker
CL_SPLIT_APP = """@app:name('clSplit')
@app:playback
define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream)
begin
  @info(name = 'bench')
  from StockStream#window.length(50)
  select symbol, distinctCount(volume) as volumes, avg(price) as avgPrice,
         sum(volume) as totalVolume
  insert into OutStream;
end;
"""
# the pinned app: the global flagship, whole on one worker
CL_PINNED_APP = "@app:name('clPinned')\n@app:playback\n" + GLOBAL_APP.format(W=WINDOW)


def cl_feed():
    """``make_feed``'s batches with each batch's rows stably grouped by
    owning worker (``owner_of_key``), so the router splits a batch into one
    run a worker (random keys would cut it into ~B/2 runs of a few rows,
    each its own step); timestamps stay ascending."""
    import numpy as np

    from siddhi_tpu_torch.cluster import owner_of_key

    owner = {}
    feed = []
    for cols, ts in make_feed(CL_SEED, CL_BATCHES, BATCH, NUM_SYMBOLS):
        own = np.array([owner.setdefault(s, owner_of_key(s, CL_WORKERS))
                        for s in cols["symbol"]], dtype=np.int64)
        order = np.argsort(own, kind="stable")
        feed.append(({k: v[order] for k, v in cols.items()}, ts))
    return feed


def cl_rows_single(device, feed):
    """Both apps in one process on ``device``: {app: [(ts, values)]}."""
    from siddhi_tpu_torch import SiddhiManager, StreamCallback
    from siddhi_tpu_torch.cluster.protocol import py_value

    class Rows(StreamCallback):
        def __init__(self):
            self.rows = []

        def receive(self, events):
            self.rows.extend((int(e.timestamp), tuple(py_value(v) for v in e.data))
                             for e in events)

    out = {}
    for name, app in (("clSplit", CL_SPLIT_APP), ("clPinned", CL_PINNED_APP)):
        m = SiddhiManager(device=device)
        rt = m.create_siddhi_app_runtime(app)
        cb = Rows()
        rt.add_callback("OutStream", cb)
        h = rt.get_input_handler("StockStream")
        for cols, ts in feed:
            h.send_columns(cols, timestamps=ts)
        m.shutdown()
        out[name] = cb.rows
    return out


def cl_compare(got, want, what: str) -> float:
    """Rows in order: ints and strings exactly, floats to rtol 1e-12.
    Returns the largest float relative difference."""
    _require(len(got) == len(want), f"{what}: {len(got)} rows vs {len(want)}")
    if got == want:
        return 0.0
    worst = 0.0
    for i, ((ta, a), (tb, b)) in enumerate(zip(got, want)):
        _require(ta == tb and len(a) == len(b), f"{what}: row {i} {ta, a} vs {tb, b}")
        for x, y in zip(a, b):
            if isinstance(y, float) and isinstance(x, float):
                rel = abs(x - y) / max(abs(y), 1e-300)
                _require(rel <= FLOAT_RTOL, f"{what}: row {i} {a} vs {b}")
                worst = max(worst, rel)
            else:
                _require(x == y, f"{what}: row {i} {a} vs {b}")
    return worst


def phase_cluster(device, card: str):
    """Phase 28 (see the module doc). Returns (facts, distinct-scan
    launches in the workers)."""
    import socket

    from siddhi_tpu_torch.cluster import ClusterRuntime
    from siddhi_tpu_torch.cluster import protocol as P
    from siddhi_tpu_torch.core.stream.input.wire import (
        WireEncoder, decode_control, encode_hello)

    import torch

    t_phase = time.perf_counter()
    # the blocks this process's allocator keeps cached go back to the card:
    # each worker process opens its own context and allocates there
    torch.cuda.empty_cache()
    feed = cl_feed()
    t0 = time.perf_counter()
    want = cl_rows_single(device, feed)
    single_s = time.perf_counter() - t0
    facts = {"card": card, "single_process_s": single_s}
    cluster = ClusterRuntime(n_workers=CL_WORKERS, heartbeat_s=0.2, device=device)
    try:
        t0 = time.perf_counter()
        cluster.wait_ready(CL_TIMEOUT_S)
        cluster.deploy(CL_SPLIT_APP, partition_keys={"StockStream": "symbol"},
                       sinks=["OutStream"], timeout=CL_TIMEOUT_S)
        cluster.deploy(CL_PINNED_APP, sinks=["OutStream"], timeout=CL_TIMEOUT_S)
        facts["up_and_deployed_s"] = time.perf_counter() - t0
        stats = cluster.worker_stats(reset=True, timeout=CL_TIMEOUT_S)
        for idx, st in stats.items():
            _require(st["device"].startswith("cuda") and st["device_name"],
                     f"CL: worker {idx} runs on {st['device']} ({st['device_name']})")
        print(f"[cluster] {CL_WORKERS} workers up and both apps deployed in "
              f"{facts['up_and_deployed_s']:.1f} s: " + ", ".join(
                  f"worker {i} pid {s['pid']} on {s['device']} ({s['device_name']})"
                  for i, s in stats.items()) + f"; clSplit split, clPinned on worker "
              f"{cluster.apps['clPinned'].home} [{card}]", flush=True)

        enc = WireEncoder()
        ing = P.MessageSocket(socket.create_connection(
            ("127.0.0.1", cluster.ingest_port), timeout=CL_TIMEOUT_S))
        ing.send(P.MSG_HELLO, encode_hello())
        _require(ing.recv()[0] == P.MSG_HELLO, "CL: the ingest link's hello")
        latencies, ingest_s, last_seq = [], 0.0, 0
        t_kill = None
        for i, (cols, ts) in enumerate(feed):
            t0 = time.perf_counter()
            cluster.send_columns("clSplit", "StockStream", cols, timestamps=ts)
            t1 = time.perf_counter()
            ing.send(P.MSG_INGEST, P.pack_data(0, 0, "clPinned", "StockStream",
                                               enc.encode(cols, timestamps=ts)))
            mtype, body = ing.recv()
            _require(mtype == P.MSG_INGEST_ACK, f"CL: ingest answered {mtype}")
            seq = decode_control(body).b
            _require(seq > last_seq, f"CL: ingest seq {seq} after {last_seq}")
            last_seq = seq
            ingest_s += time.perf_counter() - t1
            if t_kill is None:
                _require(cluster.quiesce(CL_TIMEOUT_S), f"CL: batch {i} never merged")
                latencies.append(time.perf_counter() - t0)
            if i == CL_CHECKPOINT_AFTER:
                cluster.checkpoint(timeout=CL_TIMEOUT_S)
            if i == CL_KILL_AFTER:
                head = {a: len(cluster.egress.stream_rows(a, "OutStream"))
                        for a in ("clSplit", "clPinned")}
                cluster.supervisor.kill(1)
                t_kill = time.perf_counter()
        ing.close()
        _require(cluster.quiesce(CL_TIMEOUT_S), "CL: the egress never quiesced after the kill")
        recovery_s = time.perf_counter() - t_kill
        st = cluster.status()
        stats = cluster.worker_stats(timeout=CL_TIMEOUT_S)
    finally:
        cluster.shutdown()
    worst = 0.0
    for app in ("clSplit", "clPinned"):
        got = [(t, tuple(v)) for t, v in cluster.egress.stream_rows(app, "OutStream")]
        _require(len(got) == len(feed) * BATCH, f"CL {app}: {len(got)} rows for "
                 f"{len(feed) * BATCH} in")
        worst = max(worst, cl_compare(got[:head[app]], want[app][:head[app]],
                                      f"CL {app}: rows before the kill vs one process"))
        worst = max(worst, cl_compare(got, want[app], f"CL {app}: every row, the kill "
                                      f"and recovery included, vs one process"))
    respawns = st["per_worker"][1]["respawns"]
    _require(respawns >= 1 and st["live"] == CL_WORKERS,
             f"CL: worker 1 respawned {respawns} times, {st['live']} live")
    scans = {i: s["launches"]["distinct_scan"] for i, s in stats.items()}
    _require(all(n > 0 for n in scans.values()) and len(scans) == CL_WORKERS,
             f"CL: distinct-scan launches by worker {scans}")
    for idx, s in stats.items():
        _require(s["device"].startswith("cuda") and s["device_name"],
                 f"CL: worker {idx} ran on {s['device']} after the respawn")
    rows_in = len(feed) * BATCH
    facts.update({
        "rows_equal_max_rel_err": worst, "rows_before_kill": head,
        "respawns": respawns, "duplicate_emits": st["egress"]["duplicate_emits"],
        "recovery_s": recovery_s, "scan_launches_by_worker": scans,
        "workers": {i: {"device": s["device"], "device_name": s["device_name"],
                        "pid": s["pid"]} for i, s in stats.items()},
        "ingest_events_per_s": rows_in / ingest_s,
        "egress_latency_ms": [x * 1e3 for x in latencies],
        "phase_s": time.perf_counter() - t_phase})
    print(f"[cluster] rows of both apps (every row, worker 1 killed after batch "
          f"{CL_KILL_AFTER}) == the single-process card run, exactly once (max float rel "
          f"err {worst:.3g}); recovery {recovery_s:.1f} s, {respawns} respawn, "
          f"{facts['duplicate_emits']} replayed emissions dropped; the distinct scan "
          f"launched {scans} times by worker [{card}]", flush=True)
    print(f"[cluster] socket ingest of clPinned: {facts['ingest_events_per_s']:.1f} "
          f"events/s (frame sent to seq ack); egress latency per batch (send to merged, "
          f"both apps' batches of {BATCH} rows): "
          f"{', '.join(f'{x:.1f}' for x in facts['egress_latency_ms'])} ms; one process "
          f"ran both apps in {single_s:.1f} s; phase 28 in {facts['phase_s']:.1f} s [{card}]",
          flush=True)
    return facts, sum(scans.values())


# ------------------------------------- phase 29: the fuzzer and the sanitizers

FZ_SEED = 0
FZ_CASES = 8                    # seed 0, cases 0-7: every axis value runs
FZ_MAX_COMBOS = 4               # the coverage-preserving cap a case
FZ_AP_CASES = (1, 4)            # the autopilot axis: route- and fuse-live cases
FZ_CLUSTER_CASES = (6, 11)      # the cluster axis: joins and patterns, pinned
FZ_PLANT_SEED = 3               # tests/test_fuzz.py's planted case
FZ_PLANT_EVENTS = 24
FZ_SHRINK_RUNS = 12
FZ_TIMEOUT_S = 300
SAN_TIMEOUT_S = 420             # the sanitized child: build, 3 apps, checks


class FirstReplayRecorder(ExchangeRecorder):
    """``ExchangeRecorder`` keeping the first REPLAYED exchange call (the
    fuzzer's combos capture at different batches, so no fixed index lands
    on a replay)."""

    def __init__(self):
        super().__init__(at=-1)

    def wrap_run(self, run):
        def recorded_run(graph, *a, **k):
            prev, self.current = self.current, graph
            try:
                res = run(graph, *a, **k)
            finally:
                self.current = prev
            call = self.in_graph.get(id(graph))
            if res[2] is None and call is not None:
                self.replays += 1
                if self.got is None:
                    bufs, outs, self.n = call
                    self.bufs = [b.clone() for b in bufs]
                    self.got = [o.clone() for o in outs]
            return res
        return recorded_run


@contextlib.contextmanager
def logged_errors(what: str):
    """Fail the block if the engine logged an error inside it: a junction
    logs a step's exception and drops its batch, which every strategy
    would do alike and no row comparison would see."""
    import logging

    seen = []

    class Errors(logging.Handler):
        def emit(self, record):
            exc = record.exc_info[1] if record.exc_info else sys.exc_info()[1]
            seen.append(f"{type(exc).__name__ if exc else ''}: "
                        f"{record.getMessage()[:300]}")

    handler = Errors(logging.ERROR)
    logging.getLogger().addHandler(handler)
    try:
        yield seen
    finally:
        logging.getLogger().removeHandler(handler)
    _require(not seen, f"{what}: the engine logged {len(seen)} error(s): {seen[:2]}")


def fz_rows_compare(got: dict, want: dict, what: str) -> float:
    """Every stream's rows (``run_combo``'s shape) through ``cl_compare``."""
    _require(got.keys() == want.keys(), f"{what}: streams {sorted(got)} vs {sorted(want)}")
    return max([cl_compare(got[s], want[s], f"{what} {s}") for s in want] or [0.0])


def fz_matrix(device, card: str):
    """Gate 1: the seeded corpus through ``run_case`` on the card. Returns
    (facts, K8 launches, K8 launches under replay)."""
    import torch

    from siddhi_tpu_torch.core.query.step_graph import StepGraph
    from siddhi_tpu_torch.fuzz import CaseGenerator, run_case
    from siddhi_tpu_torch.fuzz.runner import BASELINE, run_combo
    from siddhi_tpu_torch.ops.exchange import ring_exchange
    from siddhi_tpu_torch.parallel import mesh

    gen = CaseGenerator(FZ_SEED)
    installs = []           # (runtime, shards) of every routed install
    orig_install = mesh.device_route_query_step

    def install(q, m, *a, **k):
        out = orig_install(q, m, *a, **k)
        installs.append((q, m.n))
        return out

    facts = {"seed": FZ_SEED, "cases": FZ_CASES, "max_combos": FZ_MAX_COMBOS,
             "combos": 0, "pairs": 0, "declared_gaps": [], "per_case_s": []}
    seen = set()
    worst_cpu = 0.0
    ring_exchange.launches = 0
    mesh.device_route_query_step = install
    captures0 = StepGraph.total_captures
    try:
        with recording_exchange(rec=FirstReplayRecorder()) as rec:
            for i in range(FZ_CASES):
                case = gen.case(i)
                t0 = time.perf_counter()
                res = run_case(case, max_combos=FZ_MAX_COMBOS, device=device)
                facts["per_case_s"].append(time.perf_counter() - t0)
                bad = [(c.label(), d.summary()) for c, d in res.divergences]
                _require(not bad, f"FZ case {i}: variants differ from the baseline on "
                         f"the card: {bad[:2]}")
                _require(not res.census_findings,
                         f"FZ case {i}: census findings {res.census_findings[:3]}")
                facts["declared_gaps"] += [f"case {i}: {g}" for g in res.declared_gaps]
                facts["combos"] += len(res.combos_run)
                facts["pairs"] += res.pairs_diffed
                joins = any(q.kind == "join" for q in case.queries)
                for c in res.plan.combos:
                    seen |= {("fuse", c.fuse), ("depth", c.depth), ("pool", c.pool)}
                    if joins and c.join_engine == "device":
                        seen.add(("join", c.join_partitions))
                cpu, _census, _errs = run_combo(case, BASELINE, device="cpu")
                worst_cpu = max(worst_cpu, fz_rows_compare(
                    res.baseline, cpu, f"FZ case {i}: card baseline vs the port's CPU"))
    finally:
        mesh.device_route_query_step = orig_install
    launches = ring_exchange.launches
    dispatches = sum(q._route_layout.dispatches for q, _n in installs)
    routed_shards = sorted({n for _q, n in installs})
    _require(routed_shards == [2, 4], f"FZ: routed installs at shards {routed_shards}, "
             f"want 2 and 4")
    for want in (("fuse", True), ("depth", 4), ("pool", 2), ("join", 1), ("join", 8)):
        _require(want in seen, f"FZ: the corpus ran no combo with {want}")
    _require(launches == dispatches > 0, f"FZ: {launches} K8 launches for "
             f"{dispatches} routed dispatches: want one per dispatch")
    _require(rec.got is not None and rec.replays > 0,
             f"FZ: no routed exchange ran inside a replay ({rec.replays} replays)")
    cols = check_exchange_call(rec, "FZ: the replayed routed exchange")
    facts.update({
        "routed_installs": len(installs), "routed_shards": routed_shards,
        "routed_dispatches": dispatches, "k8_launches": launches,
        "k8_replays": rec.replays, "replayed_columns_checked": cols,
        "captures": StepGraph.total_captures - captures0,
        "card_vs_cpu_max_rel_err": worst_cpu})
    print(f"[fuzz] FZ matrix: seed {FZ_SEED}, cases 0-{FZ_CASES - 1}, cap "
          f"{FZ_MAX_COMBOS}: {facts['combos']} combo runs, {facts['pairs']} pairs "
          f"bit-identical to the baseline on the card, no census findings "
          f"({len(facts['declared_gaps'])} declared gaps); {len(installs)} routed "
          f"installs at shards {routed_shards}, {dispatches} routed dispatches, K8 "
          f"launched {launches} times ({rec.replays} in replays; the first replayed "
          f"call == plain on {cols} columns); {facts['captures']} captures; every "
          f"case's card baseline == the port's CPU baseline (max float rel err "
          f"{worst_cpu:.3g}); {sum(facts['per_case_s']):.1f} s [{card}]", flush=True)
    return facts, launches, rec.replays


def fz_planted(device, card: str) -> dict:
    """Gate 2: the planted skew caught on the card and shrunk to the
    fixture the CPU run shrinks to."""
    import json as _json

    from siddhi_tpu_torch.fuzz import CaseGenerator, run_case, shrink_case
    from siddhi_tpu_torch.fuzz.shrink import fixture_dict

    def planted(dev):
        case = CaseGenerator(FZ_PLANT_SEED, events_per_case=FZ_PLANT_EVENTS).case(0)
        res = run_case(case, max_combos=3, plant=True, stop_on_divergence=True,
                       device=dev)
        _require(res.divergences, f"FZ planted on {dev}: the skew was not caught")
        combo, diff = res.divergences[0]
        _require(combo.depth > 1 and diff.kind == "rows",
                 f"FZ planted on {dev}: caught under {combo.label()} ({diff.kind})")
        s = shrink_case(case, combo, diff, plant=True, max_runs=FZ_SHRINK_RUNS,
                        device=dev)
        return s, fixture_dict(s.case, s.combo, s.diff)

    t0 = time.perf_counter()
    s, card_fx = planted(device)
    _cpu_s, cpu_fx = planted("cpu")
    _require(s.case.clause_count() <= 3, f"FZ planted: shrunk to "
             f"{s.case.clause_count()} clauses ({s.steps})")
    _require(_json.dumps(card_fx, sort_keys=True) == _json.dumps(cpu_fx, sort_keys=True),
             "FZ planted: the card's shrunk fixture differs from the CPU's")
    facts = {"clauses": s.case.clause_count(), "events": len(s.case.events),
             "combo": s.combo.label(), "runs": s.runs_used, "steps": s.steps,
             "phase_s": time.perf_counter() - t0}
    print(f"[fuzz] FZ planted: caught, shrunk in {s.runs_used} runs to "
          f"{facts['clauses']} clauses / {facts['events']} events under "
          f"{facts['combo']}; the fixture == the CPU run's [{card}]", flush=True)
    return facts


def fz_axes(device, card: str) -> dict:
    """Gate 3: two cases on the autopilot axis, two on a 2-worker fabric
    on the card."""
    from siddhi_tpu_torch.cluster import ClusterRuntime
    from siddhi_tpu_torch.fuzz import CaseGenerator, run_case
    from siddhi_tpu_torch.fuzz.runner import BASELINE, diff_outputs, run_cluster_case, run_combo

    gen = CaseGenerator(FZ_SEED)
    facts = {"autopilot": {}, "cluster": {}}
    for i in FZ_AP_CASES:
        res = run_case(gen.case(i), max_combos=2, autopilot=True, device=device)
        bad = [(c.label(), d.summary()) for c, d in res.divergences]
        _require(not bad and not res.census_findings,
                 f"FZ autopilot case {i}: {bad[:2]} {res.census_findings[:2]}")
        _require(sum(c.autopilot for c in res.plan.combos) >= 2,
                 f"FZ autopilot case {i}: plan {[c.label() for c in res.plan.combos]}")
        facts["autopilot"][i] = res.combos_run
    t0 = time.perf_counter()
    cluster = ClusterRuntime(n_workers=2, heartbeat_s=0.2, device=device)
    try:
        cluster.wait_ready(FZ_TIMEOUT_S)
        for i in FZ_CLUSTER_CASES:
            case = gen.case(i)
            base, _c, _e = run_combo(case, BASELINE, device=device)
            got = run_cluster_case(case, cluster, f"fz{i}")
            d = diff_outputs(base, got)
            _require(d is None, f"FZ cluster case {i}: {d.summary() if d else ''}")
            facts["cluster"][i] = sum(len(v) for v in got.values())
        stats = cluster.worker_stats(timeout=FZ_TIMEOUT_S)
    finally:
        cluster.shutdown()
    for idx, st in stats.items():
        _require(st["device"] == "cuda:0" and st["device_name"],
                 f"FZ cluster: worker {idx} reports {st['device']} ({st['device_name']})")
    facts["workers"] = {i: st["device"] for i, st in stats.items()}
    facts["cluster_s"] = time.perf_counter() - t0
    print(f"[fuzz] FZ axes: autopilot cases {list(FZ_AP_CASES)} bit-identical over "
          f"{sum(len(v) for v in facts['autopilot'].values())} runs; cluster cases "
          f"{list(FZ_CLUSTER_CASES)} ({facts['cluster']} rows) on 2 workers == one "
          f"process, exactly; workers on {facts['workers']} [{card}]", flush=True)
    return facts


def send_frozen(h, feed, device):
    """``send_timed`` with the recapture watchdog frozen after the first
    batch (the warm-up): a later build or capture raises."""
    import torch

    from siddhi_tpu_torch.analysis import sanitize

    seconds = []
    try:
        for i, (cols, ts) in enumerate(feed):
            t0 = time.perf_counter()
            h.send_columns(cols, timestamps=ts)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if i == 0:
                sanitize.freeze_compiles()
    finally:
        sanitize.thaw_compiles()
    return seconds


def sanitized_child(out_path: str) -> int:
    """``chip_smoke.py --sanitized OUT`` under ``SIDDHI_TPU_SANITIZE=1``:
    the routed flagship (x4, K8), the global flagship and D1 (the distinct
    scan) at full width, each a warm-up batch, ``freeze_compiles()`` and
    7 more batches, every sanitizer armed; the rows go to OUT (npz) for
    the parent, the facts to a ``SANITIZED {...}`` line."""
    import numpy as np
    import torch

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from siddhi_tpu_torch import native
    from siddhi_tpu_torch.analysis import locks, sanitize
    from siddhi_tpu_torch.analysis.guards import _GuardedField
    from siddhi_tpu_torch.core.query.completion import CompletionPump
    from siddhi_tpu_torch.observability.telemetry import TelemetryRegistry
    from siddhi_tpu_torch.ops import _cuda
    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    _require(sanitize.enabled(), "sanitized child: SIDDHI_TPU_SANITIZE is not set")
    _require(isinstance(vars(CompletionPump)["_pending"], _GuardedField),
             "sanitized child: the guarded-by descriptors are not installed")
    _cuda.build(["ring_exchange", "distinct_scan"])
    native.build_strdict()
    global send_timed
    send_timed_orig, send_timed = send_timed, send_frozen
    device = torch.device("cuda", 0)
    feed = make_feed(5, N_BATCHES, BATCH, NUM_SYMBOLS)
    facts, outs = {}, {}
    acq0 = locks.acquisitions()
    try:
        with logged_errors("sanitized child"):
            ring_exchange.launches = 0
            with recording_exchange(at=EX_RECORD_AT) as ex_rec:
                outs["routed"], _s, f = run_slice(device, feed, routed=True)
            facts["routed"] = {"k8_launches": ring_exchange.launches,
                               "dispatches": f["dispatches"], "captures": f["captures"],
                               "replays": f["replays"], "k8_replays": ex_rec.replays}
            with sanitize.allowed_pull():
                facts["routed"]["checked_columns"] = check_exchange_call(
                    ex_rec, "sanitized routed: the exchange in the graph")
            outs["global"], _s, _f = run_global(device, GLOBAL_APP.format(W=WINDOW), "bench",
                                                feed)
            distinct_scan.launches = 0
            with recording(at=len(feed) - 1) as rec:
                d1, _s, _f = run_app(device, D1_APP.format(W=WINDOW), feed)
            outs["d1"] = d1["OutStream"]
            facts["d1"] = {"scan_launches": distinct_scan.launches, "scan_replays": rec.replays}
            with sanitize.allowed_pull():
                facts["d1"]["max_abs_err"] = check_graph_scan(rec, "sanitized D1: the scan")
    finally:
        send_timed = send_timed_orig
    facts["checked_lock_acquisitions"] = locks.acquisitions() - acq0
    _require(facts["checked_lock_acquisitions"] > 0, "sanitized child: no CheckedRLock "
             "was acquired")
    # planted: a scalar pull on the card raises, the same one declared does not
    t = torch.arange(4, device=device) * 3
    try:
        t[1].item()
        _require(False, "sanitized child: a planted .item() on a cuda tensor did not raise")
    except sanitize.HostPullError as e:
        facts["planted_pull"] = str(e)[:120]
    with sanitize.allowed_pull():
        _require(t[1].item() == 3, "sanitized child: allowed_pull() read")
    # planted: a new column spec after the freeze refuses its capture
    tel = TelemetryRegistry()
    state = {"acc": torch.zeros((), dtype=torch.float64, device=device)}

    def fn(st, cols, now):
        st["acc"].add_(cols["x"].sum())
        return ({"y": cols["x"] * 2},), torch.stack([now, now])

    step = tel.instrument_jit(fn, "chip_smoke.planted_step", capturable=True)
    for _ in range(3):
        step.replay(state, {"x": np.ones(BATCH)}, 1, 1)
    sanitize.freeze_compiles()
    try:
        step.replay(state, {"x": np.ones(BATCH)}, 2, 1)
        step.replay(state, {"x": np.ones(BATCH // 2)}, 3, 1)
        _require(False, "sanitized child: a new shape after the freeze was captured")
    except sanitize.RecompileError as e:
        _require("chip_smoke.planted_step" in str(e), f"sanitized child: {e}")
        facts["planted_recapture"] = str(e)[:160]
    finally:
        sanitize.thaw_compiles()
    _require(step.graph.captures == 1, f"sanitized child: {step.graph.captures} captures")
    arrays = {}
    for app, batches in outs.items():
        for i, b in enumerate(batches):
            for k, v in b.items():
                arrays[f"{app}|{i}|{k}"] = v
    np.savez(out_path, **arrays)
    print("SANITIZED " + json.dumps(facts), flush=True)
    return 0


def import_witness() -> int:
    """``chip_smoke.py --imports``: import every module of
    siddhi_tpu_torch in this fresh process (``pkgutil.walk_packages``,
    ``__main__`` modules skipped), then print an ``IMPORTS {...}`` line:
    the modules imported, whether CUDA was initialized and the files
    ``siddhi_tpu_torch/_build/`` gained (R1's runtime witness). Needs no
    card."""
    import importlib
    import os
    import pkgutil

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    build = root / "siddhi_tpu_torch" / "_build"
    before = set(os.listdir(build)) if build.exists() else set()
    import torch

    import siddhi_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(siddhi_tpu_torch.__path__,
                                                    "siddhi_tpu_torch.")
             if not m.name.endswith(".__main__")]
    for name in names:
        importlib.import_module(name)
    after = set(os.listdir(build)) if build.exists() else set()
    print("IMPORTS " + json.dumps({
        "modules": len(names), "cuda_initialized": torch.cuda.is_initialized(),
        "built": sorted(after - before)}), flush=True)
    return 0


def fz_sanitized(outs: dict, card: str):
    """Gate 4: ``sanitized_child`` in a process of its own; its rows held
    against this process's unsanitized runs of the same apps and feed.
    Returns (facts, K8 launches, K8 replays, scan launches, scan replays)."""
    import os
    import tempfile

    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sanitized.npz")
        env = dict(os.environ, SIDDHI_TPU_SANITIZE="1")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--sanitized", path], env=env, capture_output=True,
                              text=True, timeout=SAN_TIMEOUT_S)
        child_s = time.perf_counter() - t0
        _require(proc.returncode == 0, f"FZ sanitized child exited {proc.returncode}:\n"
                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("SANITIZED ")]
        _require(len(line) == 1, f"FZ sanitized child printed no facts:\n{proc.stdout[-2000:]}")
        facts = json.loads(line[0][len("SANITIZED "):])
        with np.load(path, allow_pickle=True) as z:
            got = {}
            for key in z.files:
                app, i, col = key.split("|")
                got.setdefault(app, {}).setdefault(int(i), {})[col] = z[key]
    worst = 0.0
    for app, want in outs.items():
        batches = [got.get(app, {}).get(i, {}) for i in range(len(want))]
        _require(len(got.get(app, {})) == len(want),
                 f"FZ sanitized {app}: {len(got.get(app, {}))} batches vs {len(want)}")
        worst = max(worst, compare_outputs(batches, want, f"FZ sanitized {app} vs unsanitized"))
    r, d = facts["routed"], facts["d1"]
    _require(r["k8_launches"] == r["dispatches"] == N_BATCHES and r["captures"] == 1,
             f"FZ sanitized routed: {r}")
    _require(d["scan_launches"] == N_BATCHES, f"FZ sanitized D1: {d}")
    facts.update({"child_s": child_s, "rows_max_rel_err": worst})
    print(f"[fuzz] FZ sanitized (SIDDHI_TPU_SANITIZE=1, a process of its own, "
          f"{child_s:.1f} s): routed x{N_SHARDS} (K8 {r['k8_launches']} launches, "
          f"{r['k8_replays']} in replays, replayed call == plain), the global "
          f"flagship and D1 (scan {d['scan_launches']} launches, {d['scan_replays']} "
          f"in replays, == plain) each a warm-up batch, freeze_compiles(), "
          f"{N_BATCHES - 1} more: no HostPullError, RecompileError, LockOrderError or "
          f"GuardViolation; {facts['checked_lock_acquisitions']} CheckedRLock "
          f"acquisitions; rows == the unsanitized runs (max float rel err "
          f"{worst:.3g}); a planted .item() on the card raised, inside "
          f"allowed_pull() it did not; a planted new shape after the freeze: "
          f"{facts['planted_recapture']!r} [{card}]", flush=True)
    return (facts, r["k8_launches"], r["k8_replays"], d["scan_launches"],
            d["scan_replays"])


def phase_fuzz(device, outs: dict, card: str):
    """Phase 29 (see the module doc). ``outs``: this process's runs of the
    routed flagship, the global flagship and D1 on phase 4's feed. Returns
    (facts, K8 launches, K8 replays, scan launches, scan replays)."""
    t_phase = time.perf_counter()
    facts = {"card": card}
    with logged_errors("FZ gates 1-3"):
        facts["matrix"], k8, k8_replays = fz_matrix(device, card)
        facts["planted"] = fz_planted(device, card)
        facts["axes"] = fz_axes(device, card)
    facts["sanitized"], s_k8, s_k8_rep, scans, scan_replays = fz_sanitized(outs, card)
    facts["phase_s"] = time.perf_counter() - t_phase
    print(f"[fuzz] phase 29 in {facts['phase_s']:.1f} s: K8 {k8 + s_k8} launches "
          f"({k8_replays + s_k8_rep} in replays), the distinct scan {scans} "
          f"({scan_replays} in replays) [{card}]", flush=True)
    return facts, k8 + s_k8, k8_replays + s_k8_rep, scans, scan_replays


# ------------------------------------------- 30. the lint and the loader

LN_TIMEOUT_S = 300              # the linter's and the import witness's children


def feed_bytes(feed, kind: str):
    """Each batch of ``feed`` as ``CsvLoader`` or ``JsonlLoader`` bytes,
    with its timestamps. A float32 price is written as the float64 repr
    of its value, so parsing it back and casting to float32 is exact."""
    import numpy as np

    out = []
    for cols, ts in feed:
        rows = zip(cols["symbol"].tolist(), cols["price"].astype(np.float64).tolist(),
                   cols["volume"].tolist())
        if kind == "CsvLoader":
            text = "".join(f"{s},{p!r},{v}\n" for s, p, v in rows)
        else:
            text = "".join(f'{{"symbol": "{s}", "price": {p!r}, "volume": {v}}}\n'
                           for s, p, v in rows)
        out.append((text.encode(), ts))
    return out


def bytes_sender(kind: str, parse_s: list):
    """A ``send`` for ``run_slice``/``run_global``: each batch's bytes
    parsed by the port's ``kind`` loader (the app's definition and
    dictionary), then ``send_columns``; per batch seconds of both, the
    card synchronised before the clock stops; the parse's seconds go to
    ``parse_s``."""
    def send(h, blobs, device):
        import torch

        from siddhi_tpu_torch import native

        loader = getattr(native, kind)(h.junction.definition,
                                       h.app_context.string_dictionary)
        seconds = []
        for data, ts in blobs:
            t0 = time.perf_counter()
            cols, n = loader.parse(data)
            t1 = time.perf_counter()
            _require(n == len(ts), f"LN {kind}: {n} rows parsed of {len(ts)}")
            h.send_columns(cols, timestamps=ts)
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            parse_s.append(t1 - t0)
        return seconds

    return send


def require_bit_equal(a, b, what: str):
    """Every emitted batch, every column: the same keys, dtypes and bits."""
    import numpy as np

    _require(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} emitted batches")
    for i, (x, y) in enumerate(zip(a, b)):
        _require(sorted(x) == sorted(y), f"{what}: batch {i} columns {sorted(x)} "
                 f"vs {sorted(y)}")
        for k in x:
            _require(x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
                     and x[k].tobytes() == y[k].tobytes(),
                     f"{what}: batch {i} column {k} is not bit-equal")


def phase_lint_ingest(device, feed, routed, routed_s, fused, fused_s, card: str):
    """Phase 30 ("LN", see the module doc). ``routed``/``fused`` and their
    per-batch seconds: phases 4 and 5's ``send_columns`` runs of the same
    feed. Returns (facts, K8 launches)."""
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    facts = {"card": card}
    # gate 1: the port's linter over its default roots
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "siddhi_tpu_torch.analysis"], cwd=root,
                          capture_output=True, text=True, timeout=LN_TIMEOUT_S)
    _require(proc.returncode == 0, f"LN lint exited {proc.returncode}:\n"
             f"{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")
    facts["lint"] = {"summary": proc.stdout.strip().splitlines()[-1],
                     "s": time.perf_counter() - t0}
    print(f"[ingest] LN gate 1: python -m siddhi_tpu_torch.analysis exit 0 in "
          f"{facts['lint']['s']:.1f} s: {facts['lint']['summary']}", flush=True)
    # gate 2: importing every module initializes no CUDA, builds nothing
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--imports"],
                          cwd=root, capture_output=True, text=True, timeout=LN_TIMEOUT_S)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("IMPORTS ")]
    _require(proc.returncode == 0 and len(line) == 1, f"LN import witness exited "
             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    imports = json.loads(line[0][len("IMPORTS "):])
    _require(imports["cuda_initialized"] is False,
             "LN: importing siddhi_tpu_torch initialized CUDA")
    _require(imports["built"] == [], f"LN: importing siddhi_tpu_torch built "
             f"{imports['built']}")
    facts["imports"] = {**imports, "s": time.perf_counter() - t0}
    print(f"[ingest] LN gate 2: a child imported {imports['modules']} modules of "
          f"siddhi_tpu_torch: torch.cuda.is_initialized() False, _build/ gained "
          f"no file", flush=True)
    # gate 3: the feed as bytes through the loaders into both flagships
    from siddhi_tpu_torch import native

    t0 = time.perf_counter()
    so = native.build_csv_loader()
    facts["build_s"] = time.perf_counter() - t0
    base_eps = {"routed": steady_eps(routed_s, BATCH), "global": steady_eps(fused_s, BATCH)}
    launches = replays = 0
    facts["runs"] = {}
    for kind in ("CsvLoader", "JsonlLoader"):
        t0 = time.perf_counter()
        blobs = feed_bytes(feed, kind)
        nbytes = sum(len(b) for b, _ts in blobs)
        make_s = time.perf_counter() - t0
        parse_s = []

        def reset_counts():
            ring_exchange.launches = 0

        with recording_exchange(at=EX_RECORD_AT) as ex_rec:
            got, secs, f = run_slice(device, blobs, routed=True, on_route=reset_counts,
                                     send=bytes_sender(kind, parse_s))
        k8 = ring_exchange.launches
        _require(k8 == f["dispatches"] >= N_BATCHES,
                 f"LN {kind}: {k8} exchange launches for {f['dispatches']} routed "
                 f"dispatches")
        _require(f["captures"] == 1 and ex_rec.replays == f["replays"] == N_BATCHES - 1,
                 f"LN {kind}: {f['captures']} captures, {f['replays']} replays")
        cols_checked = check_exchange_call(ex_rec, f"LN {kind}: the exchange in the graph")
        _require(f["route_overflow"] == 0, f"LN {kind}: route overflow")
        require_bit_equal(got, routed, f"LN {kind} routed x{N_SHARDS} vs send_columns")
        launches += k8
        replays += ex_rec.replays
        routed_parse = list(parse_s)
        parse_s.clear()
        got_g, secs_g, _fg = run_global(device, GLOBAL_APP.format(W=WINDOW), "bench", blobs,
                                        send=bytes_sender(kind, parse_s))
        require_bit_equal(got_g, fused, f"LN {kind} global vs send_columns")
        run = {"bytes": nbytes, "make_s": make_s,
               # both runs' later batches (the first pays the new strings)
               "parse_eps": BATCH * len(routed_parse[1:] + parse_s[1:])
               / sum(routed_parse[1:] + parse_s[1:]),
               "parse_ms_per_batch": [1e3 * x for x in routed_parse + parse_s],
               "routed_eps": steady_eps(secs, BATCH), "global_eps": steady_eps(secs_g, BATCH),
               "k8_launches": k8, "k8_replays": ex_rec.replays,
               "k8_replay_columns_checked": cols_checked}
        facts["runs"][kind] = run
        print(f"[ingest] LN gate 3, {kind}: {nbytes} bytes ({N_BATCHES} batches of "
              f"{BATCH} rows, {NUM_SYMBOLS} symbols); parse {run['parse_eps']:.1f} "
              f"events/s (mean of later batches); end to end, parse + send: routed "
              f"x{N_SHARDS} {run['routed_eps']:.1f} events/s against send_columns "
              f"{base_eps['routed']:.1f}, global {run['global_eps']:.1f} against "
              f"{base_eps['global']:.1f}; rows bit-equal to send_columns in both; "
              f"K8 {k8} launches == {f['dispatches']} routed dispatches, "
              f"{ex_rec.replays} in replays, the replayed call == plain on "
              f"{cols_checked} columns [{card}]", flush=True)
    facts["send_columns_eps"] = base_eps
    facts["loader_library"] = so.name
    facts["k8_replays"] = replays
    facts["phase_s"] = time.perf_counter() - t_phase
    print(f"[ingest] phase 30 in {facts['phase_s']:.1f} s: K8 {launches} launches "
          f"({replays} in replays) [{card}]", flush=True)
    return facts, launches


# phase 31: the multi-process half on the card's world of one
# DS: D1's shape inside a partition (distinctCount with the function
# library), so the routed step holds the distinct scan
DS_APP = """
define stream StockStream (symbol string, price float, volume long);
partition with (symbol of StockStream)
begin
@info(name = 'bench')
from StockStream#window.length({W})
select symbol, distinctCount(volume) as volumes, avg(price) as avgPrice,
       ifThenElse(price > 50.0, 'high', 'low') as band,
       maximum(cast(volume, 'double'), 500.0) as volFloor,
       eventTimestamp() as ts
insert into OutStream;
end;
"""
# tests/test_multihost.py's partitioned pattern
MH_NFA_APP = """
@app:playback
define stream A (k string, v double);
define stream B (k string, v double);
partition with (k of A, k of B)
begin
  @info(name = 'q')
  from every e1=A -> e2=B[e2.v > e1.v] within 5 sec
  select e1.v as v1, e2.v as v2
  insert into Out;
end;
"""
# tests/test_join_engine.py's partitioned keyed-length join
PJ_APP = """
define stream L (sym string, lv long);
define stream R (sym string, rv long);
partition with (sym of L, sym of R)
begin
  @info(name='pj') from L#window.length(8) join R#window.length(8)
    on L.lv > R.rv
    select L.sym as sym, L.lv as lv, R.rv as rv insert into Out;
end;
"""
PJ_BATCHES, PJ_ROWS, PJ_SYMBOLS = 8, 8192, 1000
PEER_TIMEOUT_S = 5.0            # cluster_step_timeout of gate 5
DS_H = 128                      # a symbol's window holds up to ~90 of its rows
SCAN_RECORD_AT = 2              # DS: the scan call held against plain


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def pj_feed(seed: int):
    """Both sides of PJ: ``PJ_BATCHES`` batches of ``PJ_ROWS`` rows a side,
    ``PJ_SYMBOLS`` symbols, values U[0, 30)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    syms = np.array([f"S{i}" for i in range(PJ_SYMBOLS)], dtype=object)
    items, ts = [], 0
    for _ in range(PJ_BATCHES):
        for stream, col in (("L", "lv"), ("R", "rv")):
            items.append((stream, {"sym": syms[rng.integers(0, PJ_SYMBOLS, PJ_ROWS)],
                                   col: rng.integers(0, 30, PJ_ROWS, dtype=np.int64)},
                          np.arange(ts, ts + PJ_ROWS, dtype=np.int64)))
            ts += PJ_ROWS
    return items


def _concat(batches):
    """Per-batch output columns as one batch (a routed run may split a
    batch into pieces, each its own emission)."""
    import numpy as np

    return [{k: np.concatenate([b[k] for b in batches]) for k in batches[0]}]


def _run_built(build, drive, out_stream: str):
    """(per-batch outputs, facts of the query) of ``build()``'s runtime
    driven by ``drive(rt)``; ``drive`` may return its per-batch seconds
    (``send_timed``), which the facts then carry."""
    m, rt, q = build()
    cb = collector()
    rt.add_callback(out_stream, cb)
    seconds = drive(rt)
    rl = q._route_layout
    facts = {"dispatches": rl.dispatches if rl is not None else 0,
             "captured": q.captured,
             "replays": getattr(getattr(q._step, "graph", None), "replays", 0),
             "route_overflow": rl.route_overflow_rows if rl is not None else 0}
    if isinstance(seconds, list) and seconds and isinstance(seconds[0], float):
        facts["seconds"] = seconds
        facts["steady_eps"] = steady_eps(seconds, BATCH) if len(seconds) > 1 else None
    m.shutdown()
    return cb.batches, facts


def phase_distributed(device, feed, routed, fused, card: str):
    """DS (see the module doc): the process group of one card, the
    key-sharded step, the routed steps over the global mesh, the bounded
    pull and peer recovery, a revision across meshes. Returns (facts,
    exchange launches by run, distinct-scan launches)."""
    import re

    import numpy as np
    import torch

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
    from siddhi_tpu_torch.observability.export import prometheus_text
    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.ops.exchange import all_gather_same, ring_exchange
    from siddhi_tpu_torch.parallel import distributed
    from siddhi_tpu_torch.parallel.mesh import (
        device_route_query_step, make_mesh, shard_query_step)
    from siddhi_tpu_torch.resilience import FaultInjector, PeerRecovery

    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    res, k8 = {"gate_s": {}}, {}
    items = list(feed)
    t_lap = [t_phase]

    def lap(gate: int) -> str:
        """Seconds since the previous gate ended, recorded a gate."""
        now = time.perf_counter()
        res["gate_s"][gate] = now - t_lap[0]
        t_lap[0] = now
        return f"{res['gate_s'][gate]:.1f}"

    # gate 1: a world of one over NCCL (gloo off the card)
    t0 = time.perf_counter()
    distributed.initialize_cluster(f"127.0.0.1:{_free_port()}", 1, 0,
                                   device=device if not cuda else None)
    try:
        info = distributed.process_info()
        _require(info == {"process_index": 0, "process_count": 1,
                          "local_devices": 1, "global_devices": 1},
                 f"DS: process_info {info}")
        probe = torch.arange(8, device=device)
        (got,) = all_gather_same([probe])
        _require(len(got) == 1 and torch.equal(got[0], probe),
                 "DS: the world of one's all_gather")
        res["group"] = {"backend": torch.distributed.get_backend(), "info": info,
                        "init_s": time.perf_counter() - t0}
        print(f"[distributed] gate 1 ({lap(1)} s): {res['group']['backend']} world of one "
              f"up in {res['group']['init_s']:.2f} s; process_info {info}; "
              f"all_gather of 8 ints exact", flush=True)

        # gate 2: the key-sharded step over the global mesh, full width
        def sharded_global():
            m, rt, q = global_runtime(device, GLOBAL_APP.format(W=WINDOW), "bench")
            shard_query_step(q, distributed.global_mesh())
            _require(q._shard_mesh is not None and q._route_layout is None,
                     "DS: one process keeps the sharded state whole")
            return m, rt, q

        sq, sq_f = _run_built(sharded_global, lambda rt: send_timed(
            rt.get_input_handler("StockStream"), items, device), "OutStream")
        worst = compare_outputs(sq, fused, "DS: sharded global flagship vs phase 5")

        def nfa(shard):
            def build():
                m = SiddhiManager(device=device)
                rt = m.create_siddhi_app_runtime(MH_NFA_APP)
                q = rt.query_runtimes["q"]
                if shard:
                    shard_query_step(q, distributed.global_mesh())
                return m, rt, q
            return build

        def nfa_drive(rt):
            ha, hb = rt.get_input_handler("A"), rt.get_input_handler("B")
            t = 1000
            for i in range(48):
                k = f"P{(i * 7) % 16}"
                va = float((i * 3) % 11)
                ha.send(t, [k, va])
                hb.send(t + 1, [k, va + (1.0 if i % 3 else -1.0)])
                t += 50

        n_sh, _ = _run_built(nfa(True), nfa_drive, "Out")
        n_un, _ = _run_built(nfa(False), nfa_drive, "Out")
        compare_outputs(n_sh, n_un, "DS: sharded pattern vs unsharded")
        res["sharded"] = {"global_rows": sum(len(b["__ts__"]) for b in sq),
                          "global_max_rel_err": worst, "captured": sq_f["captured"],
                          "global_steady_eps": sq_f.get("steady_eps"),
                          "nfa_rows": sum(len(b["__ts__"]) for b in n_sh)}
        print(f"[distributed] gate 2 ({lap(2)} s): shard_query_step over global_mesh(): the "
              f"global flagship's {res['sharded']['global_rows']} rows == phase 5 "
              f"(max float rel err {worst:.3g}; {sq_f['steady_eps']:.1f} events/s "
              f"after the first batch), the multihost pattern's "
              f"{res['sharded']['nfa_rows']} matches == unsharded [{card}]", flush=True)

        # gate 3: the routed x4 flagship over the global mesh (1 x 4)
        def routed_global(mesh, app=None, store=None, config=None,
                          rows_per_shard=None):
            def build():
                m = SiddhiManager(device=device)
                m.set_config_manager(InMemoryConfigManager(
                    {"siddhi_tpu.shard_exchange": "pallas_ring", **(config or {})}))
                if store is not None:
                    m.set_persistence_store(store)
                rt = m.create_siddhi_app_runtime(app or APP.format(W=WINDOW))
                q = rt.query_runtimes["bench"]
                q.selector_plan.num_keys = KEY_SLOTS
                q._win_keys = KEY_SLOTS
                device_route_query_step(q, mesh,
                                        rows_per_shard=rows_per_shard or ROWS_PER_SHARD)
                return m, rt, q
            return build

        def send_all(rt, part=None):
            return send_timed(rt.get_input_handler("StockStream"),
                              part if part is not None else items, device)

        ring_exchange.launches = 0
        with recording_exchange(at=EX_RECORD_AT) as rec:
            gm, gm_f = _run_built(routed_global(distributed.global_mesh(N_SHARDS)),
                                  send_all, "OutStream")
        k8["GM"] = ring_exchange.launches
        compare_outputs(gm, routed, "DS: routed x4 over the global mesh vs phase 4")
        if cuda:
            _require(k8["GM"] == gm_f["dispatches"] >= N_BATCHES,
                     f"DS: {k8['GM']} K8 launches for {gm_f['dispatches']} dispatches")
            _require(gm_f["captured"] and rec.replays == gm_f["replays"] == N_BATCHES - 1,
                     f"DS: routed x4 captured {gm_f['captured']}, {gm_f['replays']} "
                     f"replays, {rec.replays} recorded")
            check_exchange_call(rec, "DS: the exchange in the global mesh's graph")
        res["global_mesh_routed"] = {"k8_launches": k8["GM"], **gm_f}
        print(f"[distributed] gate 3 ({lap(3)} s): routed x{N_SHARDS} over global_mesh({N_SHARDS}) "
              f"== phase 4; {k8['GM']} K8 launches for {gm_f['dispatches']} "
              f"dispatches, {gm_f['replays']} replays, replay {EX_RECORD_AT}'s "
              f"exchange == plain; {gm_f['steady_eps']:.1f} events/s after the "
              f"first batch [{card}]", flush=True)

        # gate 4a: DS, distinct value tables routed x4, the scan in the graph
        def ds(route):
            def build():
                m = SiddhiManager(device=device)
                rt = m.create_siddhi_app_runtime(DS_APP.format(W=WINDOW))
                q = rt.query_runtimes["bench"]
                q.selector_plan.num_keys = KEY_SLOTS
                q._win_keys = KEY_SLOTS
                for spec in q.selector_plan.specs:
                    spec.distinct_capacity = DS_H
                if route:
                    device_route_query_step(q, distributed.global_mesh(N_SHARDS),
                                            rows_per_shard=ROWS_PER_SHARD)
                return m, rt, q
            return build

        ds_plain, ds_pf = _run_built(ds(False), send_all, "OutStream")
        ring_exchange.launches = 0
        distinct_scan.launches = 0
        with recording(at=SCAN_RECORD_AT) as srec:
            ds_routed, ds_f = _run_built(ds(True), send_all, "OutStream")
        k8["DS"], ds_scans = ring_exchange.launches, distinct_scan.launches
        ds_worst = compare_outputs(ds_routed, ds_plain, "DS: routed distinct vs unrouted")
        if cuda:
            _require(ds_f["captured"] and ds_f["replays"] == N_BATCHES - 1
                     and srec.replays == ds_f["replays"],
                     f"DS: routed distinct captured {ds_f['captured']}, "
                     f"{ds_f['replays']} replays, {srec.replays} ran the scan")
            _require(k8["DS"] == ds_f["dispatches"],
                     f"DS: {k8['DS']} K8 launches for {ds_f['dispatches']} dispatches")
            _require(ds_scans == N_SHARDS * ds_f["dispatches"],
                     f"DS: {ds_scans} scan launches for {ds_f['dispatches']} "
                     f"dispatches of {N_SHARDS} shards")
            scan_err = check_graph_scan(srec, "DS: the scan in the routed graph")
        else:
            scan_err = 0.0
        res["routed_distinct"] = {"k8_launches": k8["DS"], "scan_launches": ds_scans,
                                  "scan_max_abs_err": scan_err,
                                  "unrouted_steady_eps": ds_pf.get("steady_eps"),
                                  "max_rel_err": ds_worst, **ds_f}

        # gate 4b: the partitioned keyed-length join routed x4
        pj_items = pj_feed(31)

        def pj(route):
            def build():
                m = SiddhiManager(device=device)
                rt = m.create_siddhi_app_runtime(PJ_APP)
                q = rt.query_runtimes["pj"]
                if route:
                    device_route_query_step(q, distributed.global_mesh(N_SHARDS))
                return m, rt, q
            return build

        def pj_drive(rt):
            t0 = time.perf_counter()
            for stream, cols, ts in pj_items:
                rt.get_input_handler(stream).send_columns(cols, timestamps=ts)
            if cuda:
                torch.cuda.synchronize()
            return [time.perf_counter() - t0]

        pj_plain, pj_pf = _run_built(pj(False), pj_drive, "Out")
        ring_exchange.launches = 0
        pj_routed, pj_f = _run_built(pj(True), pj_drive, "Out")
        k8["PJ"] = ring_exchange.launches
        compare_outputs(pj_routed, pj_plain, "DS: routed join vs unrouted")
        pj_rows = sum(len(b["__ts__"]) for b in pj_routed)
        _require(pj_rows > 0, "DS: the routed join emitted nothing")
        if cuda:
            _require(k8["PJ"] == pj_f["dispatches"] >= len(pj_items),
                     f"DS: {k8['PJ']} K8 launches for {pj_f['dispatches']} join "
                     f"side dispatches")
        res["routed_join"] = {"rows": pj_rows, "k8_launches": k8["PJ"],
                              "unrouted_s": pj_pf["seconds"][0], **pj_f}
        print(f"[distributed] gate 4 ({lap(4)} s): DS routed x{N_SHARDS} == unrouted (max float "
              f"rel err {ds_worst:.3g}), captured {ds_f['captured']}, "
              f"{ds_f['replays']} replays, {ds_scans} scan launches ({N_SHARDS} a "
              f"dispatch), the replayed scan == plain; {ds_f['steady_eps']:.1f} "
              f"events/s routed, {ds_pf['steady_eps']:.1f} unrouted, after the "
              f"first batch; the partitioned join routed x{N_SHARDS} == "
              f"unrouted, {pj_rows} rows, {k8['PJ']} K8 launches for "
              f"{pj_f['dispatches']} side dispatches, {pj_f['seconds'][0]:.2f} s "
              f"routed, {pj_pf['seconds'][0]:.2f} s unrouted for "
              f"{len(pj_items)} side batches [{card}]", flush=True)

        # gate 5: the bounded pull, the fault stream and peer recovery
        store = InMemoryPersistenceStore()
        peer_app = ("@app:name('dsPeer')\n@app:statistics('BASIC')\n"
                    + APP.format(W=WINDOW).replace(
                        "define stream StockStream",
                        "@OnError(action='stream')\ndefine stream StockStream", 1))
        built = {}

        from siddhi_tpu_torch import StreamCallback

        class Faults(StreamCallback):
            """The fault stream's events: each row's ``_error``."""

            def __init__(self):
                self.errors = []

            def receive(self, events):
                self.errors.extend(str(e.data[-1]) for e in events)

        def build_peer(mesh):
            m, rt, q = routed_global(mesh, app=peer_app, store=store)()
            cb, fault = collector(), Faults()
            rt.add_callback("OutStream", cb)
            rt.add_callback("!StockStream", fault)
            return m, rt, cb, fault

        m1, rt1, cb1, fault1 = build_peer(distributed.global_mesh(N_SHARDS))
        rt1.app_context.cluster_step_timeout = PEER_TIMEOUT_S
        wal = rt1.enable_wal()

        def rebuild():
            m2, rt2, cb2, _f2 = build_peer(distributed.local_survivor_mesh(N_SHARDS))
            built.update(m=m2, rt=rt2, cb=cb2)
            return rt2

        sup = rt1.supervise(interval_s=0.05, peer_recovery=PeerRecovery(rebuild, wal=wal))
        faults = FaultInjector()
        try:
            send_all(rt1, items[:2])
            rev = rt1.persist()
            send_all(rt1, items[2:3])
            faults.drop_peer()
            t0 = time.perf_counter()
            send_all(rt1, items[3:4])     # the doomed batch: accepted (WAL), then lost
            doomed_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            result = sup.wait_recovered(300.0)
            recover_s = time.perf_counter() - t0
            faults.restore_peer()
            _require(result is not None, "DS: peer recovery did not run")
            new_rt, restored = result
            _require(restored == rev and new_rt is built["rt"],
                     f"DS: recovery restored {restored}, want {rev}")
            errs = fault1.errors
            _require(len(errs) == BATCH and "peer" in errs[0] and "snapshot" in errs[0],
                     f"DS: {len(errs)} fault-stream rows, first {errs[:1]}")
            _require(doomed_s < PEER_TIMEOUT_S,
                     f"DS: the doomed batch took {doomed_s:.2f} s, bound {PEER_TIMEOUT_S} s")
            send_all(new_rt, items[4:])
            compare_outputs(cb1.batches[:2], routed[:2], "DS: before the peer fault")
            compare_outputs(built["cb"].batches, routed[2:],
                            "DS: recovered (restore + WAL replay + the rest)")
            text1, text2 = prometheus_text(m1), prometheus_text(built["m"])
            pf = re.search(r'name="resilience\.peer_failures"\} (\S+)', text1)
            pr = re.search(r'name="resilience\.peer_recoveries"\} (\S+)', text2)
            _require(pf and float(pf.group(1)) >= 1 and pr and float(pr.group(1)) == 1,
                     f"DS: /metrics peer counters {pf and pf.group(0)}, "
                     f"{pr and pr.group(0)}")
            rows_m = re.findall(r'siddhi_shard_rows\{[^}]*query="bench"[^}]*\} (\S+)', text2)
            _require(len(rows_m) == N_SHARDS, f"DS: {len(rows_m)} siddhi_shard_rows gauges")
            res["peer"] = {"doomed_s": doomed_s, "recover_s": recover_s,
                           "fault_rows": len(errs), "error": errs[0][:160],
                           "peer_failures": float(pf.group(1)),
                           "peer_recoveries": float(pr.group(1)),
                           "outstanding_pulls": distributed.outstanding_pulls()}
        finally:
            faults.clear()
            sup.stop()
            m1.shutdown()
        print(f"[distributed] gate 5 ({lap(5)} s): drop_peer -> ClusterPeerError on the fault "
              f"stream ({BATCH} rows) in {doomed_s:.3f} s (bound {PEER_TIMEOUT_S} "
              f"s); PeerRecovery on local_survivor_mesh({N_SHARDS}) restored the "
              f"revision and replayed the WAL in {recover_s:.2f} s; rows == phase 4; "
              f"/metrics peer_failures {res['peer']['peer_failures']:.0f}, "
              f"peer_recoveries {res['peer']['peer_recoveries']:.0f} [{card}]",
              flush=True)

        # gate 6: the revision persisted over the global mesh into routed x2
        # (its receive capacity B / 2 * 1.25, as the bench sizes a route)
        m3, rt3, q3 = routed_global(make_mesh(2, device), app=peer_app, store=store,
                                    rows_per_shard=BATCH * 5 // 8)()
        cb3 = collector()
        rt3.add_callback("OutStream", cb3)
        try:
            rt3.restore_revision(rev)
            _require(rt3.query_runtimes["bench"]._route_layout.n == 2, "DS: x2 layout")
            send_all(rt3, items[2:])
        finally:
            built["m"].shutdown()
            m3.shutdown()
        compare_outputs(_concat(cb3.batches), _concat(routed[2:]),
                        "DS: global-mesh revision into x2")
        print(f"[distributed] gate 6 ({lap(6)} s): the revision persisted over "
              f"global_mesh({N_SHARDS}) restored into a routed x2 runtime; the "
              f"{N_BATCHES - 2} batches after it == phase 4", flush=True)
    finally:
        distributed.shutdown_cluster()
    if cuda:
        # gate 7: two processes on the card over gloo (this torch's gloo
        # takes CUDA tensors for all_to_all_single and all_gather), the
        # routed flagship at 2 processes x 2 shards against gate 3's rows
        res["two_processes"] = two_process_routed(gm, card)
        lap(7)
    _require(not torch.distributed.is_initialized(), "DS: the group outlived the phase")
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[distributed] phase 31 in {res['phase_s']:.1f} s [{card}]", flush=True)
    return res, k8, ds_scans, gm


def routed_child(port: str, n_proc: str, rank: str, out: str) -> int:
    """``python3 chip_smoke.py --routed-child PORT P RANK OUT``: one process
    of a gloo group on the card (every process on ``cuda:0``) running the
    routed flagship over ``global_mesh(N_SHARDS // P)`` on phase 4's feed;
    its output batches, K8 launches, dispatches and seconds pickled to
    OUT."""
    import pickle

    import torch

    from siddhi_tpu_torch.ops.exchange import ring_exchange
    from siddhi_tpu_torch.parallel import distributed

    P = int(n_proc)
    dev = torch.device("cuda", 0)
    distributed.initialize_cluster(f"127.0.0.1:{port}", P, int(rank),
                                   backend="gloo", device=dev)
    try:
        feed = make_feed(5, N_BATCHES, BATCH, NUM_SYMBOLS)
        ring_exchange.launches = 0
        # across processes all_to_all moves the remote pairs with the
        # group's collective (pallas_ring there is K8's peer writes through
        # CUDA IPC: phase 33)
        batches, secs, facts = run_slice(
            dev, feed, routed=True, mesh=distributed.global_mesh(N_SHARDS // P),
            exchange="all_to_all")
        res = {"batches": batches, "seconds": secs, "k8": ring_exchange.launches,
               "info": distributed.process_info(), **facts}
    finally:
        distributed.shutdown_cluster()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    return 0


def two_process_routed(want, card: str) -> dict:
    """Gate 7 of phase 31: two ``--routed-child`` processes on the card,
    each one's rows held against ``want``; both stopped whatever happens."""
    import os
    import pickle
    import tempfile

    P = 2
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="ds_gloo_")
    outs = [os.path.join(tmp, f"r{r}.pkl") for r in range(P)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--routed-child", str(port), str(P), str(r), outs[r]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(P)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            logs.append(out[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    res = {"wall_s": wall, "processes": P}
    for r, (p, path) in enumerate(zip(procs, outs)):
        _require(p.returncode == 0 and os.path.exists(path),
                 f"DS gate 7: process {r} exited {p.returncode}:\n{logs[r]}")
        with open(path, "rb") as f:
            got = pickle.load(f)
        compare_outputs(got["batches"], want, f"DS gate 7: process {r} vs gate 3")
        _require(got["route_overflow"] == 0 and got["k8"] == got["dispatches"],
                 f"DS gate 7: process {r}: {got['k8']} K8 launches for "
                 f"{got['dispatches']} dispatches, overflow {got['route_overflow']}")
        res[f"rank{r}"] = {"k8_launches": got["k8"], "dispatches": got["dispatches"],
                           "steady_eps": steady_eps(got["seconds"], BATCH),
                           "state_bytes": got["state_bytes"], "info": got["info"]}
    print(f"[distributed] gate 7: 2 processes x 2 shards on the card over gloo: "
          f"both processes' rows == gate 3; K8 {res['rank0']['k8_launches']} and "
          f"{res['rank1']['k8_launches']} launches (the local pairs, one a "
          f"dispatch); {res['rank0']['steady_eps']:.1f} events/s after the "
          f"first batch; {wall:.1f} s with the processes' start [{card}]", flush=True)
    return res


# ------------------------------------- phase 32: every shape split across processes

SP_SEED = 32
SP_BATCHES = 8                  # batches (a side's, for two-stream shapes) a shape
SP_SPAN_MS = 1_000              # event time a batch spans
# shapes cut in depth, to keep the phase near 90 s: the keyed windows'
# TIMER steps (a timeBatch tick drains 64 of the 10,000 keys a step), the
# host window's Python instance a key, the pattern's host keyed select
SP_CUT = {"keyed_windows": 2, "host_window": 2, "pattern_group_by": 4,
          "pattern_order_by": 4, "join_order_by": 4, "join_group_by": 2,
          "join_aggregation": 4, "delay_window": 2, "join_batch_window_side": 4,
          "join_store_side": 2, "join_aggregation_side": 4,
          "join_aggregation_per_event": 4, "pattern_unpartitioned_group_by": 4}
# the delay ring holds a whole batch and the rows still held; the
# unpartitioned pattern holds up to ~700 live matches (every A row over
# 99.0 arms one, ~490 a batch, and those at 99.75 wait out their second)
SP_KNOBS = {"delay_window": {"window_capacity": 131_072},
            "pattern_unpartitioned_group_by": {"nfa_slots": 1_024}}
# two-stream feeds whose streams take turns in event time (each its own
# half of a batch's span), so the feed is in order: the unpartitioned
# pattern is one key, and a batch below that key's high-water mark takes
# the generic NFA engine, one round a row
SP_STAGGER = {"pattern_unpartitioned_group_by"}
# the shapes that run whole on every process (no key axis to split)
SP_WHOLE = {"pattern_unpartitioned_group_by"}
# event time a batch spans where it is not SP_SPAN_MS: a playback delay
# takes a TIMER step a millisecond of event time it releases, so its feed
# runs at 10 times the rate (the same rows and keys a batch)
SP_SPAN = {"delay_window": 100}
SP_SHIM_BATCHES = 4             # gate 3
SP_TIMEOUT_S = 600
SP_STREAM = ("@app:playback\ndefine stream S (symbol string, side string, "
             "price double, volume long, ts long);\n")
SP_TWO = ("@app:playback\ndefine stream {a} (k string, v double);\n"
          "define stream {b} (k string, v double);\n")
# gate 1: ROADMAP C.11, a partitioned query's rows into a length window
# outside the partition
SP_C11_APP = SP_STREAM + """
partition with (symbol of S)
begin
  @info(name = 'q0') from S#window.externalTime(ts, 2000 millisec)
  select symbol, max(price) as mp, avg(price) as ap group by symbol
  insert into Out0;
end;
@info(name = 'q1') from Out0#window.length(4) select symbol, ap insert into Out1;
"""
SP_AGG = """
define aggregation Agg from R select k, sum(v) as t, count() as c
  group by k aggregate every sec ... min;
partition with (k of L)
begin
  @info(name = 'q') from L#window.length(4) join Agg on L.k == Agg.k
    within 0L, 100000000L per {per}
  select L.k as k, L.v as lv, Agg.AGG_TIMESTAMP as at, Agg.t as t, Agg.c as c
  insert into Out;
end;"""
# gate 2's shapes: name -> (app, the queries split, the output streams,
# the feed: "S", or two streams ("AB", "LR", "RL"; "RLper": L's rows
# carry a per-event duration, "seconds" or "minutes"))
SP_SHAPES = {
    "group_by": (SP_STREAM + """
partition with (symbol of S)
begin
  @info(name = 'q') from S#window.length(8)
  select symbol, side, avg(price) as ap, sum(volume) as tv group by side
  insert into Out;
end;""", ["q"], ["Out"], "S"),
    "group_by_distinct": (SP_STREAM + """
partition with (symbol of S)
begin
  @info(name = 'q') from S#window.length(8)
  select symbol, side, avg(price) as ap, sum(volume) as tv,
         distinctCount(volume) as dv group by side
  insert into Out;
end;""", ["q"], ["Out"], "S"),
    "order_limit_partitioned": (SP_STREAM + """
partition with (symbol of S)
begin
  @info(name = 'q') from S#window.length(4)
  select symbol, avg(price) as ap, sum(volume) as tv
  having tv > 2500 order by ap desc, symbol limit 100 offset 1
  insert into Out;
end;""", ["q"], ["Out"], "S"),
    "order_limit_batch": (SP_STREAM + """
@info(name = 'q') from S#window.lengthBatch(4096)
select symbol, sum(volume) as tv, max(price) as mp group by symbol
having tv > 1000 order by tv desc, symbol limit 50
insert into Out;""", ["q"], ["Out"], "S"),
    "keyed_windows": (SP_STREAM + """
partition with (symbol of S)
begin
  @info(name = 'qt') from S#window.time(1 sec)
  select symbol, sum(volume) as tv, count() as c insert all events into OT;
  @info(name = 'qtb') from S#window.timeBatch(1 sec)
  select symbol, sum(volume) as tv insert into OTB;
  @info(name = 'qet') from S#window.externalTime(ts, 800 millisec)
  select symbol, max(price) as mp, avg(price) as ap insert all events into OET;
  @info(name = 'qs') from S#window.session(500 millisec)
  select symbol, sum(volume) as tv, count() as c insert all events into OS;
end;""", ["qt", "qtb", "qet", "qs"], ["OT", "OTB", "OET", "OS"], "S"),
    "host_window": (SP_STREAM + """
partition with (symbol of S)
begin
  @info(name = 'q') from S#window.sort(3, price)
  select symbol, sum(volume) as tv, min(price) as lo insert all events into Out;
end;""", ["q"], ["Out"], "S"),
    "inner_stream": (SP_STREAM + """
partition with (symbol of S)
begin
  @info(name = 'q1') from S[volume > 5]
  select symbol, price * 2.0 as p2, volume insert into #T;
  @info(name = 'q2') from #T#window.length(3)
  select symbol, sum(p2) as sp, count() as c insert into Out;
end;""", ["q1", "q2"], ["Out"], "S"),
    "pattern_group_by": (SP_TWO.format(a="A", b="B") + """
partition with (k of A, k of B)
begin
  @info(name = 'q') from every e1=A -> e2=B[e2.v > e1.v] within 1 sec
  select e1.v as v1, sum(e2.v) as total, count() as c group by e1.v
  insert into Out;
end;""", ["q"], ["Out"], "AB"),
    "partitioned_join": (SP_TWO.format(a="L", b="R") + """
partition with (k of L, k of R)
begin
  @info(name = 'q') from L#window.length(4) join R#window.time(1 sec)
    on L.v > R.v
  select L.k as k, L.v as lv, R.v as rv
  insert into Out;
end;""", ["q"], ["Out"], "LR"),
    # A.11's later shapes: an ordering without a group by, a join's group
    # by and aggregation, the delay window inside a partition
    "pattern_order_by": (SP_TWO.format(a="A", b="B") + """
partition with (k of A, k of B)
begin
  @info(name = 'q') from every e1=A -> e2=B[e2.v > e1.v] within 1 sec
  select e1.v as v1, e2.v as v2 order by v1 limit 100
  insert into Out;
end;""", ["q"], ["Out"], "AB"),
    "join_order_by": (SP_TWO.format(a="L", b="R") + """
partition with (k of L, k of R)
begin
  @info(name = 'q') from L#window.length(4) join R#window.time(1 sec)
    on L.v > R.v
  select L.k as k, L.v as lv, R.v as rv order by rv desc, lv limit 100
  insert into Out;
end;""", ["q"], ["Out"], "LR"),
    "join_group_by": (SP_TWO.format(a="L", b="R") + """
partition with (k of L, k of R)
begin
  @info(name = 'q') from L#window.length(4) join R#window.time(1 sec)
    on L.v > R.v
  select L.k as k, count() as n group by L.v
  insert into Out;
end;""", ["q"], ["Out"], "LR"),
    "join_aggregation": (SP_TWO.format(a="L", b="R") + """
partition with (k of L, k of R)
begin
  @info(name = 'q') from L#window.length(4) join R#window.time(1 sec)
    on L.v > R.v
  select L.k as k, sum(R.v) as total, count() as n
  insert into Out;
end;""", ["q"], ["Out"], "LR"),
    "delay_window": (SP_STREAM + """
partition with (symbol of S)
begin
  @info(name = 'q') from S#window.delay(50 millisec)
  select symbol, sum(volume) as tv insert into Out;
end;""", ["q"], ["Out"], "S"),
    # a join's other sides: a lengthBatch window, and a table (R's rows
    # under 1.0, about 650 a batch, inserted outside the partition) probed
    # by key. The global side (each row copied to every one of 10,000
    # keys) is held on the CPU only (tests/test_torch_multiprocess_shapes.py)
    "join_batch_window_side": (SP_TWO.format(a="L", b="R") + """
partition with (k of L, k of R)
begin
  @info(name = 'q') from L#window.length(4) join R#window.lengthBatch(4)
    on L.v > R.v
  select L.k as k, L.v as lv, R.v as rv
  insert into Out;
end;""", ["q"], ["Out"], "LR"),
    "join_store_side": (SP_TWO.format(a="L", b="R") + """
define table T (k string, v double);
from R[v < 1.0] select k, v insert into T;
partition with (k of L)
begin
  @info(name = 'q') from L#window.length(4) join T on L.k == T.k
  select L.k as k, L.v as lv, T.v as rv
  insert into Out;
end;""", ["q"], ["Out"], "LR"),
    # the last two shapes of A.11: a partitioned join against an
    # incremental aggregation outside the partition (every R row folded
    # by second and minute, whole on every process: ~10,000 buckets a
    # second of R, probed by key), with a fixed and a per-event duration;
    # an unpartitioned pattern grouped by a capture (whole on every
    # process: its match slots have no key axis)
    "join_aggregation_side": (SP_TWO.format(a="L", b="R") + SP_AGG.format(per="'seconds'"),
                              ["q"], ["Out"], "RL"),
    "join_aggregation_per_event": (SP_TWO.format(a="L", b="R").replace(
        "L (k string, v double)", "L (k string, v double, per string)")
        + SP_AGG.format(per="L.per"), ["q"], ["Out"], "RLper"),
    "pattern_unpartitioned_group_by": (SP_TWO.format(a="A", b="B") + """
@info(name = 'q') from every e1=A[v > 99.0] -> e2=B[e2.v > e1.v] within 1 sec
select e1.k as k, sum(e2.v) as total, count() as c group by e1.k
insert into Out;""", ["q"], ["Out"], "AB"),
}


def sp_feed(shape_feed: str, n_batches: int, span_ms: int = SP_SPAN_MS,
            stagger: bool = False):
    """Phase 32's feed: ``n_batches`` batches of ``BATCH`` rows over
    ``NUM_SYMBOLS`` keys, each batch ``span_ms`` of event time (so time
    windows and timers turn over between and inside batches). Prices and values
    are multiples of 0.25 (exact sums, in any order). ``"S"``: stream S;
    two letters: batches alternating on those two streams, the second a
    millisecond behind the first (``stagger``: the first stream's rows in
    the first half of the span, the second's in the second half;
    ``"RLper"``: R and L, L's rows with a ``per`` of "seconds" or
    "minutes")."""
    import numpy as np

    rng = np.random.default_rng(SP_SEED)
    syms = np.array([f"S{i}" for i in range(NUM_SYMBOLS)], dtype=object)
    sides = np.array([f"side{i}" for i in range(5)], dtype=object)
    pers = np.array(["seconds", "minutes"], dtype=object)
    items = []
    for i in range(n_batches):
        part = span_ms // 2 if stagger else span_ms
        ts = 1_000 + i * span_ms + (np.arange(BATCH, dtype=np.int64) * part) // BATCH
        if shape_feed == "S":
            items.append(("S", {
                "symbol": syms[rng.integers(0, NUM_SYMBOLS, BATCH)],
                "side": sides[rng.integers(0, 5, BATCH)],
                "price": np.floor(rng.random(BATCH) * 400.0) / 4.0,
                "volume": rng.integers(1, 1000, BATCH, dtype=np.int64),
                "ts": ts}, ts))
            continue
        for j, stream in enumerate(shape_feed[:2]):
            cols = {"k": syms[rng.integers(0, NUM_SYMBOLS, BATCH)],
                    "v": np.floor(rng.random(BATCH) * 400.0) / 4.0}
            if shape_feed.endswith("per") and stream == "L":
                cols["per"] = pers[rng.integers(0, 2, BATCH)]
            items.append((stream, cols, ts + j * (part if stagger else 1)))
    return items


def sp_run(device, name: str, split: bool):
    """One shape of phase 32 through the public API on ``device``: split
    over ``global_mesh()`` (the process group's) or in one process.
    Returns ({stream: its valid rows as columns}, per-item seconds, facts:
    each split query's split mode and the state bytes of the shape's
    queries on this process)."""
    import numpy as np
    import torch

    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.parallel import distributed
    from siddhi_tpu_torch.parallel.mesh import shard_query_step

    app, queries, streams, feed = SP_SHAPES[name]
    m = SiddhiManager(device=device)
    if name in SP_KNOBS:
        m.set_config_manager(InMemoryConfigManager(
            {f"siddhi_tpu.{k}": str(v) for k, v in SP_KNOBS[name].items()}))
    rt = m.create_siddhi_app_runtime(app)
    cbs = {s: collector() for s in streams}
    for s, cb in cbs.items():
        rt.add_callback(s, cb)
    splits = []
    if split:
        for q in queries:
            qr = rt.query_runtimes[q]
            shard_query_step(qr, distributed.global_mesh())
            splits.append(None if qr._route_layout is None else qr._route_layout.split)
    items = sp_feed(feed, SP_CUT.get(name, SP_BATCHES), SP_SPAN.get(name, SP_SPAN_MS),
                    stagger=name in SP_STAGGER)
    handlers = {s: rt.get_input_handler(s) for s in {it[0] for it in items}}
    seconds = []
    with logged_errors(f"SP {name} ({'split' if split else 'one process'})"):
        for stream, cols, ts in items:
            t0 = time.perf_counter()
            handlers[stream].send_columns(cols, timestamps=ts)
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    stages = [rt.query_runtimes[q].stage for q in queries
              if hasattr(rt.query_runtimes[q], "stage")]
    facts = {"splits": splits, "events": len(items) * BATCH,
             "nfa_steps": [(st.fast_steps, st.generic_steps, st.generic_rounds)
                           for st in stages],
             "state_bytes": sum(t.numel() * t.element_size()
                                for q in queries
                                if rt.query_runtimes[q]._state is not None
                                for t in _leaves(rt.query_runtimes[q]._state))}
    m.shutdown()
    rows = {s: ({k: np.concatenate([b[k] for b in cb.batches]) for k in cb.batches[0]}
                if cb.batches else {}) for s, cb in cbs.items()}
    return rows, seconds, facts


def sp_eps(seconds, per_item: int, items_per_step: int = 1) -> float:
    """Events/s after the first step (a step: one item, or a pair of a
    two-stream feed)."""
    skip = items_per_step
    return per_item * (len(seconds) - skip) / sum(seconds[skip:])


def sp_compare(got: dict, want: dict, what: str) -> float:
    """Every stream's rows: ints, strings, timestamps, types and order
    exactly, floats to rtol 1e-12 (``compare_outputs``)."""
    worst = 0.0
    _require(set(got) == set(want), f"{what}: streams {sorted(got)} vs {sorted(want)}")
    for s in want:
        _require(set(got[s]) == set(want[s]),
                 f"{what}: {s} columns {sorted(got[s])} vs {sorted(want[s])}")
        worst = max(worst, compare_outputs([got[s]], [want[s]], f"{what} {s}"))
    return worst


def split_child(port: str, n_proc: str, rank: str, out: str) -> int:
    """``python3 chip_smoke.py --split-child PORT P RANK OUT``: one process
    of a gloo group on the card (every process on ``cuda:0``) running
    every phase-32 shape split over ``global_mesh()``; per shape its rows,
    seconds and facts, and the group-by-distinct shape's distinct-scan
    launches with its last call held against the plain version, pickled
    to OUT."""
    import pickle

    import torch

    from siddhi_tpu_torch.ops.distinct import distinct_scan
    from siddhi_tpu_torch.parallel import distributed

    dev = torch.device("cuda", 0)
    distributed.initialize_cluster(f"127.0.0.1:{port}", int(n_proc), int(rank),
                                   backend="gloo", device=dev)
    res = {"info": None, "shapes": {}}
    try:
        res["info"] = distributed.process_info()
        for name in SP_SHAPES:
            if name == "group_by_distinct":
                distinct_scan.launches = 0
                with recording(at=SP_BATCHES - 1) as rec:
                    rows, secs, facts = sp_run(dev, name, split=True)
                facts["scan_launches"] = distinct_scan.launches
                facts["scan_max_abs_err"] = check_graph_scan(
                    rec, f"SP {name}: the split path's last scan call")
            else:
                rows, secs, facts = sp_run(dev, name, split=True)
            res["shapes"][name] = {"rows": rows, "seconds": secs, **facts}
    finally:
        distributed.shutdown_cluster()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    return 0


def sp_children(P: int, beside=None):
    """Gate 2's ``--split-child`` processes, each one's pickled results,
    and ``beside()``'s result: it runs in this process while the children
    run (their outputs go to files); every process stopped whatever
    happens."""
    import os
    import pickle
    import tempfile

    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="sp_gloo_")
    outs = [os.path.join(tmp, f"r{r}.pkl") for r in range(P)]
    logs = [os.path.join(tmp, f"r{r}.log") for r in range(P)]
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(P):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--split-child",
                     str(port), str(P), str(r), outs[r]],
                    stdout=log, stderr=subprocess.STDOUT))
        mine = beside() if beside is not None else None
        deadline = time.perf_counter() + SP_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for r, (p, path) in enumerate(zip(procs, outs)):
        with open(logs[r]) as f:
            tail = f.read()[-3000:]
        _require(p.returncode == 0 and os.path.exists(path),
                 f"SP gate 2: process {r} exited {p.returncode}:\n{tail}")
        with open(path, "rb") as f:
            res.append(pickle.load(f))
    return res, mine, time.perf_counter() - t0


def sp_c11(device, card: str) -> dict:
    """Gate 1: C.11 on the card. The rows of a partitioned query leave the
    partition into a length window outside it: Out1's rows == a
    sequential Python oracle's (each key's externalTime window of 2 s by
    its ``ts``, the window's average; q1 passes them on), and the engine
    logs no processing error (the reference drops these batches)."""
    import numpy as np

    from siddhi_tpu_torch import SiddhiManager

    items = sp_feed("S", SP_BATCHES)
    live, want = {}, {"__ts__": [], "symbol": [], "ap": []}
    for _s, cols, ts in items:
        for sym, p, t in zip(cols["symbol"].tolist(), cols["price"].tolist(),
                             cols["ts"].tolist()):
            rows = [r for r in live.get(sym, ()) if r[0] + 2_000 > t]
            rows.append((t, p))
            live[sym] = rows
            want["__ts__"].append(t)
            want["symbol"].append(sym)
            want["ap"].append(sum(v for _t, v in rows) / len(rows))
    with logged_errors("SP gate 1") as errors:
        m = SiddhiManager(device=device)
        rt = m.create_siddhi_app_runtime(SP_C11_APP)
        cb = collector()
        rt.add_callback("Out1", cb)
        h = rt.get_input_handler("S")
        t0 = time.perf_counter()
        for _s, cols, ts in items:
            h.send_columns(cols, timestamps=ts)
        secs = time.perf_counter() - t0
        strings = list(rt.app_context.string_dictionary._to_str)
        m.shutdown()
    got = {k: np.concatenate([b[k] for b in cb.batches]) for k in ("__ts__", "symbol", "ap")}
    got["symbol"] = np.asarray(strings, dtype=object)[got["symbol"]]
    _require(len(got["__ts__"]) == len(want["__ts__"]) == SP_BATCHES * BATCH,
             f"SP gate 1: {len(got['__ts__'])} rows out, the oracle "
             f"{len(want['__ts__'])}")
    _require(np.array_equal(got["__ts__"], np.asarray(want["__ts__"], np.int64)),
             "SP gate 1: timestamps differ from the oracle")
    _require(got["symbol"].tolist() == want["symbol"], "SP gate 1: symbols differ")
    ap = np.asarray(want["ap"])
    close = np.isclose(got["ap"], ap, rtol=FLOAT_RTOL, atol=0.0)
    _require(close.all(), f"SP gate 1: ap differs beyond rtol {FLOAT_RTOL} at rows "
             f"{np.nonzero(~close)[0][:5].tolist()}")
    res = {"rows": int(len(ap)), "logged_errors": len(errors), "seconds": secs,
           "max_rel_err": float(np.max(np.abs(got["ap"] - ap) / np.maximum(np.abs(ap), 1e-300)))}
    print(f"[split] gate 1: C.11 on the card: {res['rows']} rows out of the "
          f"partition through length(4) == the Python oracle (max rel err "
          f"{res['max_rel_err']:.3g}); {res['logged_errors']} logged errors; "
          f"{secs:.1f} s [{card}]", flush=True)
    return res


def sp_shim(device, card: str) -> dict:
    """Gate 3: the legacy host router (``route_batch_to_shards``) and its
    shim (``shard_keyed_query_step``) step the partitioned flagship x4 on
    the card; each key's rows == the unrouted step's, batch by batch."""
    import warnings

    import numpy as np
    import torch

    from siddhi_tpu_torch import SiddhiManager
    from siddhi_tpu_torch.core.plan.selector_plan import GK_KEY
    from siddhi_tpu_torch.ops.expressions import PK_KEY, TS_KEY, TYPE_KEY, VALID_KEY
    from siddhi_tpu_torch.parallel import (
        make_mesh, route_batch_to_shards, shard_keyed_query_step)

    n = N_SHARDS
    rng = np.random.default_rng(SP_SEED)
    batches = []
    for i in range(SP_SHIM_BATCHES):
        sym = rng.integers(0, NUM_SYMBOLS, BATCH, dtype=np.int64)
        batches.append({
            TS_KEY: np.arange(i * BATCH, (i + 1) * BATCH, dtype=np.int64),
            TYPE_KEY: np.zeros(BATCH, np.int8), VALID_KEY: np.ones(BATCH, bool),
            "symbol": sym.astype(np.int32), "symbol?": np.zeros(BATCH, bool),
            "price": (rng.random(BATCH) * 100).astype(np.float32),
            "price?": np.zeros(BATCH, bool),
            "volume": rng.integers(1, 1000, BATCH, dtype=np.int64),
            "volume?": np.zeros(BATCH, bool),
            GK_KEY: sym.astype(np.int32), PK_KEY: sym.astype(np.int32)})

    def runtime(keys):
        m = SiddhiManager(device=device)
        rt = m.create_siddhi_app_runtime(APP.format(W=WINDOW))
        q = rt.query_runtimes["bench"]
        q.selector_plan.num_keys = keys
        q._win_keys = keys
        return m, q

    def per_key(out, shards=None):
        v = out[VALID_KEY].cpu().numpy()
        key = out[PK_KEY].cpu().numpy().astype(np.int64)
        if shards is not None:
            key = key * shards + np.arange(len(v)) // (len(v) // shards)
        order = np.argsort(key[v], kind="stable")
        cols = {c: out[c].cpu().numpy()[v][order]
                for c in (TS_KEY, TYPE_KEY, "avgPrice", "totalVolume")}
        cols["key"] = key[v][order]
        return cols

    m, q = runtime(KEY_SLOTS)
    state, step = q._init_state(), q.build_step_fn()
    plain = []
    for i, b in enumerate(batches):
        state, out = step(state, {k: torch.from_numpy(v).to(device) for k, v in b.items()},
                          10_000 + i)
        plain.append(per_key(out))
    m.shutdown()
    m, q = runtime(KEY_SLOTS // n)
    sstep, sstate = shard_keyed_query_step(q, make_mesh(n, device), rows_per_shard=BATCH)
    routed, secs = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            rb = route_batch_to_shards(b, n, BATCH)
        sstate, out = sstep(sstate, rb, 10_000 + i)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        routed.append(per_key(out, n))
    m.shutdown()
    worst = compare_outputs(routed, plain, "SP gate 3: host-routed shim x4 vs unrouted")
    rows = sum(len(b["key"]) for b in plain)
    _require(rows == SP_SHIM_BATCHES * BATCH, f"SP gate 3: {rows} rows out")
    res = {"rows": rows, "max_rel_err": worst, "steady_eps": steady_eps(secs, BATCH)}
    print(f"[split] gate 3: the host router and its shim x{n} on the card: "
          f"{rows} rows, each key's == the unrouted step's (max float rel err "
          f"{worst:.3g}); {res['steady_eps']:.1f} events/s with the host "
          f"routing [{card}]", flush=True)
    return res


def phase_split(device, card: str):
    """Phase 32: gate 1 (C.11), gate 2 (every shape split across two
    processes on the card over gloo against one process on the card),
    gate 3 (the host-router shim). Returns (results, the distinct scan's
    launches by run)."""
    import torch

    from siddhi_tpu_torch.ops.distinct import distinct_scan

    t_phase = time.perf_counter()
    res = {"c11": sp_c11(device, card)}
    # gate 2: each shape split over two processes, and meanwhile in this
    # one process on the card
    scans = {}

    def one_process():
        single = {}
        for name in SP_SHAPES:
            if name == "group_by_distinct":
                distinct_scan.launches = 0
            rows, secs, facts = sp_run(device, name, split=False)
            if name == "group_by_distinct":
                scans["SP_single"] = distinct_scan.launches
            single[name] = (rows, secs, facts)
        return single

    _require(not torch.distributed.is_initialized(), "SP: a group is up before gate 2")
    P = 2
    children, single, wall = sp_children(P, beside=one_process)
    res["shapes"] = {}
    for name, (want, secs1, facts1) in single.items():
        pair = SP_SHAPES[name][3] != "S"
        shape = {"single_eps": sp_eps(secs1, BATCH, 2 if pair else 1),
                 "single_state_bytes": facts1["state_bytes"],
                 "nfa_steps": facts1["nfa_steps"]}
        # ROADMAP C.16: one key's head batches spread over several
        # instants run as K4 steps, never K5's one round a row
        _require(name not in SP_STAGGER or all(k5 == 0 for _k4, k5, _r in facts1["nfa_steps"]),
                 f"SP gate 2 {name}: K4, K5 steps and K5 rounds {facts1['nfa_steps']}")
        for r, child in enumerate(children):
            got = child["shapes"][name]
            worst = sp_compare(got["rows"], want, f"SP gate 2 {name}: process {r} vs one")
            _require(all((s is None) == (name in SP_WHOLE) for s in got["splits"][-1:]),
                     f"SP gate 2 {name}: process {r} split {got['splits']}")
            shape[f"rank{r}"] = {"eps": sp_eps(got["seconds"], BATCH, 2 if pair else 1),
                                 "state_bytes": got["state_bytes"],
                                 "splits": got["splits"], "max_rel_err": worst}
            if name == "group_by_distinct":
                _require(got["scan_launches"] >= SP_BATCHES,
                         f"SP gate 2: process {r} launched the distinct scan "
                         f"{got['scan_launches']} times on the split path")
                scans[f"SP_rank{r}"] = got["scan_launches"]
                shape[f"rank{r}"]["scan_launches"] = got["scan_launches"]
                shape[f"rank{r}"]["scan_max_abs_err"] = got["scan_max_abs_err"]
        shape["rows"] = {s: len(c.get("__ts__", ())) for s, c in want.items()}
        res["shapes"][name] = shape
        print(f"[split] gate 2 {name}: {shape['rows']} rows; both processes' "
              f"rows == one process's; events/s a process "
              f"{shape['rank0']['eps']:.1f} / {shape['rank1']['eps']:.1f} (one "
              f"process, beside them, {shape['single_eps']:.1f}); state bytes a process "
              f"{shape['rank0']['state_bytes']} / {shape['rank1']['state_bytes']} "
              f"(one process {shape['single_state_bytes']})"
              + "".join(f"; K4 steps {k4}, K5 steps {k5} ({r} rounds)"
                        for k4, k5, r in shape["nfa_steps"]) + f" [{card}]", flush=True)
    res["two_processes_wall_s"] = wall
    res["shim"] = sp_shim(device, card)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[split] phase 32 in {res['phase_s']:.1f} s [{card}]", flush=True)
    return res, scans


# ----------------------- phase 33: K8 across processes, peer writes through CUDA IPC

PX_RECORD_FROM = 1              # the first exchange call held against the plain path
PX_RECORD_CALLS = 7             # consecutive calls held (both halves of the arena)
PX_TIMED = 30                   # timed calls of each exchange (median)
PX_BAD_TIMEOUT_S = 10.0         # gate 3's cluster_step_timeout
PX_KILL_AT = 1                  # gate 4: process 1 is killed before this exchange call
PX_PROFILE_TOP = 6              # functions listed in gate 1's host profile
PX_KILL_TIMEOUT_S = 5.0         # gate 4's cluster_step_timeout
PX_TIMEOUT_S = 300


class PeerRecorder:
    """Stands in for ``peer_exchange_cols`` in the routed step; every call
    goes through to the wrapper. Calls ``at`` to ``at + count - 1`` have
    their send buffers cloned before them and their receive buffers after
    them (the arena half a call returns is rewritten two calls later);
    ``peer`` keeps the exchange state. ``kill_at``: the process kills
    itself (SIGKILL) before that call."""

    def __init__(self, at: int, count: int = 1, kill_at=None):
        self.at, self.count, self.kill_at, self.calls = at, count, kill_at, 0
        self.bufs, self.got, self.peer = [], [], None

    def __call__(self, bufs, peer, timeout_s=None, what="shard exchange"):
        import os
        import signal

        from siddhi_tpu_torch.ops.exchange import peer_exchange_cols

        i, self.calls = self.calls, self.calls + 1
        self.peer = peer
        if i == self.kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        keep = self.at <= i < self.at + self.count
        if keep:
            self.bufs.append([b.clone() for b in bufs])
        out = peer_exchange_cols(bufs, peer, timeout_s, what)
        if keep:
            self.got.append([o.clone() for o in out])
        return out


def _byte_view(t):
    import torch

    return t.contiguous().reshape(-1).view(torch.uint8)


def peer_device_ms(call, flush):
    """The peer kernel's device ms (torch.profiler, L2 flushed before each
    of ``PX_TIMED`` calls) and the launches the trace saw. Every process
    of the group runs it in step: each call waits on its peers' calls, so
    no process may retry a trace (``device_ms`` does): a trace that saw no
    launch gives None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(PX_TIMED):
            flush.fill_(i & 0xFF)
            call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if "peer_exchange_cols_kernel" in e.key]
    seen = sum(e.count for e in events)
    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in events)
    return (us / 1e3 / seen if seen and us else None), seen


def px_host_profile(call, runs: int = PX_TIMED) -> dict:
    """cProfile of ``runs`` calls of ``call``, the card synchronized
    between them outside the profile: the host ms a call and the
    ``PX_PROFILE_TOP`` functions by their own (not their callees') ms a
    call. A function that releases the GIL (a ctypes or torch call) counts
    here the time it waits to take it back."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    for _ in range(runs):
        prof.enable()
        call()
        prof.disable()
        torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, f"{Path(f).name}:{line}({fn})") for (f, line, fn), (_cc, _nc, tt, _ct,
                   _callers) in stats.items()), reverse=True)
    return {"ms": sum(tt for tt, _ in rows) * 1e3 / runs,
            "top": [(name, tt * 1e3 / runs) for tt, name in rows[:PX_PROFILE_TOP]]}


def px_measure(rec, P: int) -> dict:
    """Gate 1 in one process of the group (every process runs it in step:
    the plain path holds collectives, and each peer call waits on the
    peers'): each recorded call's send buffers through the plain path
    (``ring_exchange_cols`` plus ``all_to_all_cols`` over gloo), held bit
    for bit against what the kernel wrote; then, on the last recorded
    call's buffers, the peer exchange's card ms (CUDA events around a
    call, median), its host enqueue ms and host profile, its kernel's
    device ms (torch.profiler, L2 flushed before each call) and launch
    shape, the same launch's device ms moving 16 B a segment, the plain
    path's ms, and one gloo ``all_to_all_single`` of the same bytes (host
    clock to its end)."""
    import torch
    import torch.distributed as dist

    from siddhi_tpu_torch.ops import exchange as ex

    peer = rec.peer
    n, L, p = peer.n, peer.L, peer.p
    _require(len(rec.got) == PX_RECORD_CALLS,
             f"PX gate 1: process {p} recorded {len(rec.got)} calls, want {PX_RECORD_CALLS}")
    for j, (bufs, got) in enumerate(zip(rec.bufs, rec.got)):
        plain = ex.process_exchange_plain(bufs, n, L, p, 60.0, "PX plain")
        torch.cuda.synchronize()
        for i, (k, w) in enumerate(zip(got, plain)):
            _require(k.dtype == w.dtype and k.shape == w.shape
                     and torch.equal(_byte_view(k), _byte_view(w)),
                     f"PX gate 1: process {p} call {PX_RECORD_FROM + j} column {i} "
                     f"({w.dtype} {tuple(w.shape)}) differs from the plain path")
    bufs = rec.bufs[-1]
    out = {"columns": len(bufs), "calls_checked": len(rec.got), "max_abs_err": 0.0}

    def call():
        return ex.peer_exchange_cols(bufs, peer, 60.0, "PX timed")

    call()
    torch.cuda.synchronize()
    card, host = [], []
    for _ in range(PX_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        call()
        b.record()
        host.append((time.perf_counter() - t0) * 1e3)
        b.synchronize()
        card.append(a.elapsed_time(b))
    out["ms"], out["host_ms"] = statistics.median(card), statistics.median(host)
    out["host_profile"] = px_host_profile(call)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=bufs[0].device)
    out["device_ms"], out["device_seen"] = peer_device_ms(call, flush)
    out["launch"] = launch_shape([b.numel() // (L * n) * b.element_size() for b in bufs],
                                 L * n)
    # the fixed cost: the same launch moving 16 bytes a segment (a column
    # layout of its own, so its own arena), held against the plain path
    tiny = [torch.zeros((L, n, 16), dtype=torch.uint8, device=bufs[0].device)]
    got = ex.peer_exchange_cols(tiny, peer, 60.0, "PX floor")[0].clone()
    want = ex.process_exchange_plain(tiny, n, L, p, 60.0, "PX floor plain")[0]
    _require(torch.equal(got, want), "PX gate 1: the 16-byte call differs from the plain path")
    out["floor_ms"] = peer_device_ms(
        lambda: ex.peer_exchange_cols(tiny, peer, 60.0, "PX floor"), flush)[0]

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(PX_TIMED):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out["plain_ms"] = timed(lambda: ex.process_exchange_plain(bufs, n, L, p, 60.0, "PX"))
    # the library call: one all_to_all_single of every column's bytes,
    # packed once (the packing is the plain path's, not timed here)
    blocks = [b.view((L, P, L * (b.shape[1] // n)) + tuple(b.shape[2:])).transpose(0, 1)
              for b in bufs]
    send, _offs = ex._pack_rows([blk.contiguous() for blk in blocks], P)
    send = send.contiguous().view(-1)
    recv = torch.empty_like(send)
    out["library_ms"] = timed(lambda: dist.all_to_all_single(recv, send))
    nbytes = sum(b.numel() * b.element_size() for b in bufs)
    out["bytes"] = nbytes
    out["cross_bytes"] = nbytes * (n - L) // n
    # read once and written once, at the HBM rate: the bytes stay in one
    # card's memory when the processes share it
    out["bound_ms"] = 2 * nbytes / H100_BYTES_PER_S * 1e3
    out["cross_bound_ms"] = 2 * out["cross_bytes"] / H100_BYTES_PER_S * 1e3
    out["share"] = (out["bound_ms"] / out["device_ms"]) if out["device_ms"] else None
    return out


class PeerErrors:
    """A logging handler keeping the host clock and message of every
    logged record that names a ``ClusterPeerError``."""

    def __init__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                text = record.getMessage()
                if record.exc_info:
                    text += repr(record.exc_info[1])
                if "ClusterPeerError" in text or "presumed dead" in text:
                    self.seen.append((time.perf_counter(), text[-600:]))
                    print(f"[kill] ClusterPeerError logged: {text[-300:]}", flush=True)

        self.seen = []
        self.handler = Handler()


def peer_child(port: str, n_proc: str, rank: str, out: str, mode: str) -> int:
    """``python3 chip_smoke.py --peer-child PORT P RANK OUT MODE``: one
    process of a gloo group on the card (every process on ``cuda:0``)
    routing the flagship over ``global_mesh(N_SHARDS // P)`` on phase 4's
    feed under ``pallas_ring``, exchange calls ``PX_RECORD_FROM`` on
    recorded. MODE ``run``: then gate 1 (``px_measure``) and the same
    feed under ``all_to_all``; ``rows``: gate 1 alone; ``corrupt``:
    process 1 flips the bytes of process 0's arena handle before opening
    it, and every process bounds its collectives by ``PX_BAD_TIMEOUT_S``;
    ``kill``: process 1 kills itself before exchange call ``PX_KILL_AT``
    and every process bounds its steps by ``PX_KILL_TIMEOUT_S``; the
    survivor times each send, keeps the ClusterPeerErrors it logs, then
    times ``torch.cuda.synchronize()`` and the exchange's ``close()``.
    Pickles to OUT each run's batches, seconds and facts, and the
    launches of the peer kernel, K8 on one card and ``all_to_all_cols``."""
    import logging
    import os
    import pickle

    import torch

    from siddhi_tpu_torch.ops import exchange as ex
    from siddhi_tpu_torch.parallel import distributed
    from siddhi_tpu_torch.parallel import mesh as mesh_mod

    P, r = int(n_proc), int(rank)
    dev = torch.device("cuda", 0)
    distributed.initialize_cluster(f"127.0.0.1:{port}", P, r, backend="gloo", device=dev)
    res = {"info": distributed.process_info(), "mode": mode}
    a2a = {"calls": 0}
    plain_a2a = ex.all_to_all_cols

    def counted_a2a(*a, **k):
        a2a["calls"] += 1
        return plain_a2a(*a, **k)

    def zero():
        ex.peer_exchange_cols.launches = 0
        ex.ring_exchange.launches = 0
        a2a["calls"] = 0

    def counts():
        return {"peer": ex.peer_exchange_cols.launches, "k8": ex.ring_exchange.launches,
                "all_to_all": a2a["calls"]}

    try:
        feed = make_feed(5, N_BATCHES, BATCH, NUM_SYMBOLS)
        mesh = distributed.global_mesh(N_SHARDS // P)
        knobs, send = {}, None
        if mode == "corrupt":
            knobs["cluster_step_timeout"] = PX_BAD_TIMEOUT_S
            if r == 1:
                trade = ex.PeerExchange._trade

                def corrupt(self, payload, timeout_s, what):
                    rows = trade(self, payload, timeout_s, what)
                    H = ex.IPC_HANDLE_BYTES
                    rows[0] = bytes(b ^ 0xFF for b in rows[0][:H]) + rows[0][H:]
                    return rows

                ex.PeerExchange._trade = corrupt
        errors = PeerErrors()
        if mode == "kill":
            import faulthandler

            knobs["cluster_step_timeout"] = PX_KILL_TIMEOUT_S
            logging.getLogger("siddhi_tpu_torch").addHandler(errors.handler)
            # a survivor stuck past its bounds prints every thread's stack
            faulthandler.dump_traceback_later(10 * PX_KILL_TIMEOUT_S, exit=False)
            starts = []

            def send(h, feed, device):
                seconds = []
                for cols, ts in feed:
                    t0 = time.perf_counter()
                    starts.append(t0)
                    h.send_columns(cols, timestamps=ts)
                    seconds.append(time.perf_counter() - t0)
                    print(f"[kill] send {len(seconds) - 1}: {seconds[-1]:.3f} s", flush=True)
                return seconds

        rec = PeerRecorder(PX_RECORD_FROM, PX_RECORD_CALLS,
                           kill_at=PX_KILL_AT if mode == "kill" and r == 1 else None)
        mesh_mod.peer_exchange_cols, ex.all_to_all_cols = rec, counted_a2a
        batches, secs, facts = run_slice(dev, feed, routed=True, mesh=mesh, send=send,
                                         exchange="pallas_ring", on_route=zero, knobs=knobs)
        res["pallas_ring"] = {"batches": batches, "seconds": secs, **facts, **counts()}
        mesh_mod.peer_exchange_cols = ex.peer_exchange_cols
        if mode == "kill":
            res["errors"] = [(t - starts[PX_KILL_AT], msg) for t, msg in errors.seen]
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            res["sync_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rec.peer.close(PX_KILL_TIMEOUT_S)
            res["close_s"] = time.perf_counter() - t0
            res["broken"] = repr(rec.peer._broken)[:300]
            with open(out, "wb") as f:
                pickle.dump(res, f)
            os._exit(0)     # the group's peer is gone: no teardown
        if mode in ("run", "rows"):
            res["gate1"] = px_measure(rec, P)
        if mode == "run":
            batches, secs, facts = run_slice(dev, feed, routed=True, mesh=mesh,
                                             exchange="all_to_all", on_route=zero)
            res["all_to_all"] = {"batches": batches, "seconds": secs, **facts, **counts()}
            # pallas_ring again, so the two exchanges take turns
            _b, secs, _f = run_slice(dev, feed, routed=True, mesh=mesh,
                                     exchange="pallas_ring", on_route=zero)
            res["pallas_ring_again"] = {"seconds": secs, **counts()}
        if rec.peer is not None:
            rec.peer.close(60.0)
    finally:
        distributed.shutdown_cluster()
    with open(out, "wb") as f:
        pickle.dump(res, f)
    return 0


def px_children(P: int, mode: str, first_wait: int = PX_TIMEOUT_S):
    """``--peer-child`` processes; each one's exit code, pickled results
    (None without) and the tail of its output, and the wall seconds. In
    ``corrupt`` and ``kill`` mode process 1 is waited for first (it fails
    or is killed) and the rest are given 4 and 12 times the mode's step
    bound more; every process is stopped whatever happens."""
    import os
    import pickle
    import tempfile

    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="px_gloo_")
    outs = [os.path.join(tmp, f"r{r}.pkl") for r in range(P)]
    logs = [os.path.join(tmp, f"r{r}.log") for r in range(P)]
    t0 = time.perf_counter()
    procs = []
    for r in range(P):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--peer-child", str(port),
                 str(P), str(r), outs[r], mode], stdout=log, stderr=subprocess.STDOUT))
    rest = {"corrupt": 4 * PX_BAD_TIMEOUT_S, "kill": 12 * PX_KILL_TIMEOUT_S}.get(mode)
    try:
        order = [1] + [r for r in range(P) if r != 1] if rest else range(P)
        for i, r in enumerate(order):
            try:
                procs[r].wait(timeout=first_wait if i == 0 else (rest or PX_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    res = []
    for r in range(P):
        got = None
        if os.path.exists(outs[r]):
            with open(outs[r], "rb") as f:
                got = pickle.load(f)
        with open(logs[r]) as f:
            tail = f.read()[-3000:]
        res.append((procs[r].returncode, got, tail))
    return res, time.perf_counter() - t0


def px_gate1_line(label: str, g1: dict, pr: dict, eps: str, card: str) -> str:
    prof = g1["host_profile"]
    top = ", ".join(f"{name} {ms:.4f}" for name, ms in prof["top"])
    dev = g1["device_ms"]
    return (f"[peer] gate 1: {label}: {g1['calls_checked']} consecutive calls' "
            f"{g1['columns']} receive buffers == the plain path's (ring_exchange_cols "
            f"+ all_to_all_cols over gloo), bit for bit; {pr['peer']} peer launches for "
            f"{pr['dispatches']} dispatches, 0 collectives; a call: card {g1['ms']:.4f} "
            f"ms (CUDA events, median of {PX_TIMED}), host enqueue {g1['host_ms']:.4f} ms, "
            f"kernel on the device {dev if dev is None else round(dev, 4)} ms "
            f"({g1['device_seen']} of {PX_TIMED} seen; share "
            f"{g1['share'] if g1['share'] is None else round(g1['share'], 3)}; "
            f"{g1['launch']['blocks']} blocks, {g1['launch']['chunks_per_block']:.2f} chunks "
            f"a block of {EX_CHUNK} B), bound {g1['bound_ms']:.4f} ms "
            f"({g1['bytes']} B read and written; {g1['cross_bytes']} B cross processes: "
            f"{g1['cross_bound_ms']:.4f} ms; the same launch moving 16 B a segment "
            f"{g1['floor_ms'] if g1['floor_ms'] is None else round(g1['floor_ms'], 4)} ms), "
            f"plain {g1['plain_ms']:.4f} ms, gloo "
            f"all_to_all_single {g1['library_ms']:.4f} ms; host profile of a call "
            f"{prof['ms']:.4f} ms, by own ms: {top}; {eps} [{card}]")


def px_kill(gm, card: str) -> dict:
    """Gate 4: process 1 of 2 kills itself before exchange call
    ``PX_KILL_AT``; the survivor must log ``ClusterPeerError`` within the
    step's bound + 5 s, its rows before the kill must equal ``gm``'s (not
    compared where ``gm`` is None), and its ``torch.cuda.synchronize()``
    and ``close()`` must return."""
    kill, wall_k = px_children(2, "kill", first_wait=120)
    code1, _got1, tail1 = kill[1]
    code0, got0, tail0 = kill[0]
    _require(code1 == -9, f"PX gate 4: process 1 exited {code1}, not killed:\n{tail1}")
    _require(code0 == 0 and got0 is not None,
             f"PX gate 4: the survivor exited {code0}:\n{tail0}")
    pr, errs = got0["pallas_ring"], got0["errors"]
    _require(errs and errs[0][0] < PX_KILL_TIMEOUT_S + 5.0,
             f"PX gate 4: the survivor's first ClusterPeerError came "
             f"{errs[0][0] if errs else None} s after the doomed send (bound "
             f"{PX_KILL_TIMEOUT_S} + 5 s): {errs[:1]}")
    _require(len(pr["batches"]) == PX_KILL_AT,
             f"PX gate 4: the survivor emitted {len(pr['batches'])} batches, "
             f"not the {PX_KILL_AT} before the kill")
    if gm is not None:
        require_bit_equal(pr["batches"], gm[:PX_KILL_AT],
                          "PX gate 4: the survivor's rows before the kill vs DS gate 3")
    _require(got0["sync_s"] < 5.0 and got0["close_s"] < 5.0 and pr["all_to_all"] == 0,
             f"PX gate 4: the survivor's sync {got0['sync_s']:.2f} s, close "
             f"{got0['close_s']:.2f} s, {pr['all_to_all']} collectives")
    res = {"exit_codes": [code0, code1], "wall_s": wall_k,
           "error_after_s": errs[0][0], "errors": len(errs),
           "error": errs[0][1][-300:], "batches_out": len(pr["batches"]),
           "send_s": pr["seconds"], "sync_s": got0["sync_s"],
           "close_s": got0["close_s"], "peer_launches": pr["peer"]}
    print(f"[peer] gate 4: process 1 killed (SIGKILL) before exchange call {PX_KILL_AT}, "
          f"so the survivor's call {PX_KILL_AT} reads an arena half the peer never "
          f"wrote: the survivor logged ClusterPeerError {errs[0][0]:.2f} s after the "
          f"doomed send began (bound {PX_KILL_TIMEOUT_S} s + 5), {len(errs)} in all "
          f"(each later batch's at once); its {len(pr['batches'])} batches before "
          + ("== DS gate 3's" if gm is not None else "(rows not compared)")
          + f"; torch.cuda.synchronize() {got0['sync_s']:.3f} s, close() "
          f"{got0['close_s']:.3f} s; sends {[round(x, 3) for x in pr['seconds']]} s; "
          f"{wall_k:.1f} s [{card}]", flush=True)
    return res


def phase_peer(device, gm, card: str):
    """Phase 33: K8 across processes as peer writes through CUDA IPC, two
    and four processes on the card over gloo. Gate 1: consecutive calls'
    received buffers == the plain path's, bit for bit, one launch a
    dispatch, and the times at 2 x 2 and 4 x 1; gate 2: the routed
    flagship's rows == phase 31's gate 3 rows (``gm``) under
    ``pallas_ring`` at 2 x 2 and 4 x 1 shards and under ``all_to_all``;
    gate 3: a corrupted arena handle fails the run; gate 4: a process
    killed mid-feed gives the survivor ``ClusterPeerError`` within the
    step's bound, its rows before the kill == ``gm``'s, and it drains and
    closes. Returns (results, the peer kernel's launches by run)."""
    t_phase = time.perf_counter()
    res, launches = {}, {}
    runs, wall = px_children(2, "run")
    for r, (code, got, tail) in enumerate(runs):
        _require(code == 0 and got is not None,
                 f"PX gates 1-2: process {r} exited {code}:\n{tail}")
    for r, (_code, got, _tail) in enumerate(runs):
        pr, aa, g1 = got["pallas_ring"], got["all_to_all"], got["gate1"]
        _require(pr["peer"] == pr["dispatches"] >= N_BATCHES and pr["k8"] == 0
                 and pr["all_to_all"] == 0 and pr["route_overflow"] == 0,
                 f"PX gate 1: process {r}: {pr['peer']} peer launches, {pr['k8']} K8 "
                 f"and {pr['all_to_all']} all_to_all calls for {pr['dispatches']} "
                 f"dispatches (overflow {pr['route_overflow']})")
        _require(aa["peer"] == 0 and aa["all_to_all"] == aa["dispatches"] >= N_BATCHES,
                 f"PX: process {r}'s all_to_all run: {aa['peer']} peer launches, "
                 f"{aa['all_to_all']} collectives for {aa['dispatches']} dispatches")
        require_bit_equal(pr["batches"], gm, f"PX gate 2: process {r} pallas_ring vs DS gate 3")
        require_bit_equal(aa["batches"], gm, f"PX gate 2: process {r} all_to_all vs DS gate 3")
        launches[f"PX_rank{r}"] = pr["peer"]
        res[f"rank{r}"] = {
            "launches": pr["peer"], "dispatches": pr["dispatches"],
            "k8_launches_all_to_all": aa["k8"],
            "eps_pallas_ring": steady_eps(pr["seconds"], BATCH),
            "eps_all_to_all": steady_eps(aa["seconds"], BATCH),
            "eps_pallas_ring_again": steady_eps(got["pallas_ring_again"]["seconds"], BATCH),
            "state_bytes": pr["state_bytes"], "info": got["info"], **g1}
        print(px_gate1_line(
            f"process {r} of 2 (2 shards each)", g1, pr,
            f"events/s {res[f'rank{r}']['eps_pallas_ring']:.1f} under pallas_ring, "
            f"{res[f'rank{r}']['eps_all_to_all']:.1f} under all_to_all, "
            f"{res[f'rank{r}']['eps_pallas_ring_again']:.1f} under pallas_ring again",
            card), flush=True)
    res["two_wall_s"] = wall
    print(f"[peer] gate 2: both processes' rows == DS gate 3's, bit for bit, under "
          f"pallas_ring and all_to_all; {wall:.1f} s with the processes' start [{card}]",
          flush=True)
    # gate 3's two processes run beside the four of gate 2 (their times
    # are not kept)
    import threading

    bad_box = {}
    bad_thread = threading.Thread(
        target=lambda: bad_box.update(res=px_children(2, "corrupt", first_wait=120)))
    bad_thread.start()
    try:
        four, wall4 = px_children(4, "rows")
    finally:
        bad_thread.join()
    for r, (code, got, tail) in enumerate(four):
        _require(code == 0 and got is not None,
                 f"PX gate 2: process {r} of 4 exited {code}:\n{tail}")
        pr, g1 = got["pallas_ring"], got["gate1"]
        _require(pr["peer"] == pr["dispatches"] >= N_BATCHES and pr["k8"] == 0
                 and pr["all_to_all"] == 0,
                 f"PX gate 2: process {r} of 4: {pr['peer']} peer launches for "
                 f"{pr['dispatches']} dispatches, {pr['all_to_all']} collectives")
        require_bit_equal(pr["batches"], gm, f"PX gate 2: process {r} of 4 vs DS gate 3")
        launches[f"PX4_rank{r}"] = pr["peer"]
        res[f"four_rank{r}"] = {"launches": pr["peer"], "dispatches": pr["dispatches"],
                                "eps_pallas_ring": steady_eps(pr["seconds"], BATCH), **g1}
        print(px_gate1_line(f"process {r} of 4 (1 shard each)", g1, pr,
                            f"events/s {res[f'four_rank{r}']['eps_pallas_ring']:.1f} under "
                            f"pallas_ring", card), flush=True)
    res["four_wall_s"] = wall4
    print(f"[peer] gate 2: 4 processes x 1 shard under pallas_ring: every process's "
          f"rows == DS gate 3's, bit for bit; launches "
          f"{[res[f'four_rank{r}']['launches'] for r in range(4)]}; events/s a process "
          f"{[round(res[f'four_rank{r}']['eps_pallas_ring'], 1) for r in range(4)]}; "
          f"{wall4:.1f} s (gate 3's processes beside them) [{card}]", flush=True)
    _require("res" in bad_box, "PX gate 3: its processes were not run")
    bad, wall3 = bad_box["res"]
    code1, got1, tail1 = bad[1]
    _require(code1 not in (0, None) and got1 is None
             and "cudaIpcOpenMemHandle of process 0's receive arena" in tail1,
             f"PX gate 3: process 1 with a corrupted handle exited {code1}:\n{tail1}")
    code0, got0, _tail0 = bad[0]
    res["corrupt"] = {"exit_codes": [code0, code1], "wall_s": wall3,
                      "error": next((ln for ln in tail1.splitlines()
                                     if "cudaIpcOpenMemHandle" in ln), "")[-300:]}
    if got0 is not None:
        pr = got0["pallas_ring"]
        _require(pr["all_to_all"] == 0 and pr["k8"] == 0,
                 f"PX gate 3: process 0 fell back: {pr['all_to_all']} collectives, "
                 f"{pr['k8']} K8 launches")
        res["corrupt"]["rank0"] = {"peer": pr["peer"], "rows": sum(
            len(b["__ts__"]) for b in pr["batches"]), "all_to_all": pr["all_to_all"]}
    print(f"[peer] gate 3: a corrupted arena handle in process 1: it exited {code1} "
          f"raising ({res['corrupt']['error']}); process 0 exited {code0} "
          f"({res['corrupt'].get('rank0')}); nothing fell back to all_to_all; "
          f"{wall3:.1f} s [{card}]", flush=True)
    res["kill"] = px_kill(gm, card)
    launches["PX_kill_rank0"] = res["kill"]["peer_launches"]
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[peer] phase 33 in {res['phase_s']:.1f} s [{card}]", flush=True)
    return res, launches


# ------------------------------------------ phase 34: the management API on the card

API_BROKEN_APP = """
@app:name('validateTest')
define stream cseEventStream (symbol string, price float, volume long);
@info(name = 'query1')
from cseEventStreamA[symbol is null]
select symbol, price insert into outputStream;
"""
# the reference's error for API_BROKEN_APP (tests/test_managment_corpus.py)
API_BROKEN_ERROR = "query 'query1': stream 'cseEventStreamA' is not defined"
# the flagship with transports and a store that would each reach for a
# server (on this host only: a sandbox never connects)
API_SANDBOX_APP = APP.replace("define stream StockStream", """
@source(type='kafka', topic='stocks', bootstrap.servers='localhost:9092',
        @map(type='json'))
define stream StockStream""").replace("partition with", """
@sink(type='kafka', topic='out', bootstrap.servers='localhost:9092', @map(type='json'))
define stream OutStream (symbol string, avgPrice double, totalVolume long);
@store(type='rdbms', jdbc.url='jdbc:mysql://localhost:3306/siddhi')
define table Snapshot (symbol string, avgPrice double);
partition with""")
# tests/test_managment_corpus.py stateTest: one stateless query, then a
# window, an aggregator and a rate limiter
API_STATE_APP = """
define stream cseEventStream (symbol string, price float, volume int);
@info(name = 'query1')
from cseEventStream select * insert all events into outputStream;
@info(name = 'query2')
from cseEventStream#window.timeBatch(1 sec) select * insert all events into outputStream;
@info(name = 'query3')
from cseEventStream select sum(price) as total insert all events into outputStream1;
@info(name = 'query4')
from cseEventStream select * output every 5 min insert all events into outputStream;
"""
API_STATE_FLAGS = [False, True, True, True]


def phase_api(device, feed, unrouted, card: str):
    """Phase 34: the management API on the card. Gate 1:
    ``validate_siddhi_app`` builds the routed flagship on the card and
    registers nothing; a query over an undefined stream raises the
    reference's ``CompileError``. Gate 2: the flagship with a kafka
    ``@source``/``@sink`` and an rdbms ``@store`` fails to build as it
    stands, and ``create_sandbox_siddhi_app_runtime`` strips them: its
    rows over the 8 flagship batches == phase 4's unrouted rows. Gate 3:
    ``persist_all`` after 4 batches of two apps in one manager (the
    flagship routed x4 with K8, and the global flagship), 4 more
    batches, ``restore_last_state``, the same 4 batches again: each
    app's rows after the restore == its rows of the unbroken run. Gate 4:
    ``get_queries`` in declaration order, ``query_names`` and
    ``is_stateful`` == the reference's management corpus. Returns (facts,
    gate 3's K8 launches)."""
    from siddhi_tpu_torch import InMemoryConfigManager, SiddhiManager
    from siddhi_tpu_torch.core.util.persistence import InMemoryPersistenceStore
    from siddhi_tpu_torch.ops.exchange import ring_exchange
    from siddhi_tpu_torch.ops.expressions import CompileError
    from siddhi_tpu_torch.parallel.mesh import device_route_query_step, make_mesh

    t_phase = time.perf_counter()
    res = {}
    # gate 1
    m = SiddhiManager(device=device)
    t0 = time.perf_counter()
    m.validate_siddhi_app(APP.format(W=WINDOW))
    res["validate_ms"] = (time.perf_counter() - t0) * 1e3
    _require(m.app_runtimes == {} and m.get_siddhi_app_runtime("chip_smoke") is None,
             f"API gate 1: validate registered {sorted(m.app_runtimes)}")
    try:
        m.validateSiddhiApp(API_BROKEN_APP)
        raise Failure("API gate 1: the broken app validated")
    except CompileError as e:
        _require(str(e) == API_BROKEN_ERROR, f"API gate 1: error {e!r}")
        res["broken_error"] = str(e)
    m.shutdown()
    print(f"[api] gate 1: validate_siddhi_app built the flagship on the card in "
          f"{res['validate_ms']:.1f} ms and registered nothing; the broken app "
          f"raised CompileError({res['broken_error']!r}) [{card}]", flush=True)

    # gate 2
    m = SiddhiManager(device=device)
    try:
        m.create_siddhi_app_runtime(API_SANDBOX_APP.format(W=WINDOW))
        raise Failure("API gate 2: the app with kafka and rdbms transports built")
    except (ValueError, CompileError) as e:
        res["unsandboxed_error"] = f"{type(e).__name__}: {e}"[:200]
    m.shutdown()
    m = SiddhiManager(device=device)
    rt = m.createSandboxSiddhiAppRuntime(API_SANDBOX_APP.format(W=WINDOW))
    anns = [a.name.lower() for sd in rt.siddhi_app.stream_definitions.values()
            for a in sd.annotations or []]
    _require("source" not in anns and "sink" not in anns and not any(
        a.name.lower() == "store" for td in rt.siddhi_app.table_definitions.values()
        for a in td.annotations or []), f"API gate 2: the sandbox kept {anns}")
    cb = collector()
    rt.add_callback("OutStream", cb)
    q = rt.query_runtimes["bench"]
    q.selector_plan.num_keys = KEY_SLOTS
    q._win_keys = KEY_SLOTS
    secs = send_timed(rt.getInputHandler("StockStream"), feed, device)
    m.shutdown()
    res["sandbox"] = {"rows": sum(len(b["__ts__"]) for b in cb.batches),
                      "max_rel_err": compare_outputs(cb.batches, unrouted,
                                                     "API gate 2: sandbox vs phase 4"),
                      "eps": steady_eps(secs, BATCH)}
    _require(res["sandbox"]["rows"] == len(feed) * BATCH,
             f"API gate 2: {res['sandbox']['rows']} rows out")
    print(f"[api] gate 2: the flagship with kafka @source/@sink and an rdbms "
          f"@store fails to build ({res['unsandboxed_error']}); its sandbox "
          f"runtime's {res['sandbox']['rows']} rows == phase 4's unrouted rows "
          f"(max float rel err {res['sandbox']['max_rel_err']:.3g}); "
          f"{res['sandbox']['eps']:.1f} events/s [{card}]", flush=True)

    # gate 3
    half = len(feed) // 2
    m = SiddhiManager(device=device)
    m.set_config_manager(InMemoryConfigManager({"siddhi_tpu.shard_exchange": "pallas_ring"}))
    m.setPersistenceStore(InMemoryPersistenceStore())
    apps = {}
    rt = m.createSiddhiAppRuntime(APP.format(W=WINDOW))
    q = rt.query_runtimes["bench"]
    q.selector_plan.num_keys = KEY_SLOTS
    q._win_keys = KEY_SLOTS
    device_route_query_step(q, make_mesh(N_SHARDS, device), rows_per_shard=ROWS_PER_SHARD)
    apps["routed"] = rt
    rt = m.create_siddhi_app_runtime("@app:name('chip_smoke_global')\n"
                                     + GLOBAL_APP.format(W=WINDOW))
    rt.query_runtimes["bench"].selector_plan.num_keys = KEY_SLOTS
    apps["global"] = rt
    cbs = {name: collector() for name in apps}
    for name, rt in apps.items():
        rt.add_callback("OutStream", cbs[name])
    ring_exchange.launches = 0

    def send(items):
        for name, rt in apps.items():
            send_timed(rt.get_input_handler("StockStream"), items, device)

    send(feed[:half])
    t0 = time.perf_counter()
    m.persist_all()
    persist_ms = (time.perf_counter() - t0) * 1e3
    marks = {name: len(cb.batches) for name, cb in cbs.items()}
    send(feed[half:])
    unbroken = {name: cb.batches[marks[name]:] for name, cb in cbs.items()}
    marks = {name: len(cb.batches) for name, cb in cbs.items()}
    t0 = time.perf_counter()
    m.restoreLastState()
    restore_ms = (time.perf_counter() - t0) * 1e3
    send(feed[half:])
    launches = ring_exchange.launches
    m.shutdown()
    res["persist"] = {"persist_ms": persist_ms, "restore_ms": restore_ms,
                      "k8_launches": launches}
    for name, cb in cbs.items():
        after = cb.batches[marks[name]:]
        res["persist"][name] = {
            "rows_after_restore": sum(len(b["__ts__"]) for b in after),
            "max_rel_err": compare_outputs(after, unbroken[name],
                                           f"API gate 3 {name}: after the restore")}
        _require(res["persist"][name]["rows_after_restore"] == (len(feed) - half) * BATCH,
                 f"API gate 3 {name}: {res['persist'][name]['rows_after_restore']} rows")
    _require(launches >= 2 * (len(feed) - half),
             f"API gate 3: {launches} K8 launches for {2 * (len(feed) - half)} routed "
             f"batches")
    print(f"[api] gate 3: persist_all of two apps in {persist_ms:.1f} ms, "
          f"restore_last_state in {restore_ms:.1f} ms; the routed flagship's "
          f"{res['persist']['routed']['rows_after_restore']} and the global "
          f"flagship's {res['persist']['global']['rows_after_restore']} rows after "
          f"the restore == the unbroken run's; {launches} K8 launches [{card}]",
          flush=True)

    # gate 4
    m = SiddhiManager(device=device)
    rt = m.create_siddhi_app_runtime(API_STATE_APP)
    flags = [qr.is_stateful() for qr in rt.get_queries()]
    names = rt.query_names
    m.shutdown()
    _require(names == ["query1", "query2", "query3", "query4"],
             f"API gate 4: query_names {names}")
    _require(flags == API_STATE_FLAGS, f"API gate 4: is_stateful {flags}")
    res["stateful"] = dict(zip(names, flags))
    print(f"[api] gate 4: get_queries in declaration order {names}, is_stateful "
          f"{flags} == the reference's management corpus [{card}]", flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[api] phase 34 in {res['phase_s']:.1f} s [{card}]", flush=True)
    return res, launches


def phase_global(device, feed, card: str):
    """The global flagship on the fused stage: the card against the CPU
    and against the generic path on the card."""
    import torch

    app = GLOBAL_APP.format(W=WINDOW)
    fused, fused_s, facts = run_global(device, app, "bench", feed)
    _require(facts["stage"] == "FusedSlidingAggStage",
             f"global flagship planned on {facts['stage']}, not the fused stage")
    _require(facts["precision"] == "exact" and facts["exact"] is True,
             f"global flagship precision {facts['precision']}, not exact")
    rows_out = sum(len(b["__ts__"]) for b in fused)
    _require(rows_out == len(feed) * BATCH,
             f"global: {rows_out} output rows for {len(feed) * BATCH} input rows")
    require_finite(fused, "global fused (card)")
    print(f"[global] fused stage, exact: {facts['state_bytes']} state bytes on "
          f"the card, {KEY_SLOTS} key slots, {rows_out} rows out, first batch "
          f"{fused_s[0] * 1e3:.1f} ms, then {steady_eps(fused_s, BATCH):.1f} "
          f"events/s [{card}]", flush=True)

    generic, generic_s, gfacts = run_global(device, app, "bench", feed, fused=False)
    _require(gfacts["stage"] == "LengthWindowStage",
             f"unfused global flagship planned on {gfacts['stage']}")
    worst = compare_outputs(fused, generic, "global fused vs generic (card)")
    print(f"[global] generic path (fusion off): {gfacts['state_bytes']} state "
          f"bytes, first batch {generic_s[0] * 1e3:.1f} ms, then "
          f"{steady_eps(generic_s, BATCH):.1f} events/s [{card}]; fused == "
          f"generic over {len(feed)} batches (max float rel err {worst:.3g})",
          flush=True)

    cpu_out, _s, _f = run_global(torch.device("cpu"), app, "bench",
                                 feed[:CPU_BATCHES])
    worst_cpu = compare_outputs(fused[:CPU_BATCHES], cpu_out,
                                "global card vs cpu (first batches)")
    print(f"[global] first {CPU_BATCHES} batches equal the port's CPU run "
          f"(max float rel err {worst_cpu:.3g})", flush=True)
    return fused, facts["strings"], fused_s


def phase_twin(device, feed, card: str):
    """The twin on the generic window -> aggregator path. Its feed is the
    bench feed with every price lowered by 15, so about 15% of the rows
    fail the twin's ``price > 0.0`` filter."""
    import numpy as np
    import torch

    feed = [({**cols, "price": cols["price"] - np.float32(15.0)}, ts)
            for cols, ts in feed]
    twin, twin_s, facts = run_global(device, TWIN_APP, "flagship", feed)
    _require(facts["stage"] == "LengthWindowStage",
             f"twin planned on {facts['stage']}, not the generic window")
    rows_out = sum(len(b["__ts__"]) for b in twin)
    positive = sum(int(np.count_nonzero(cols["price"] > 0)) for cols, _ts in feed)
    _require(rows_out == positive,
             f"twin: {rows_out} output rows for {positive} rows with price > 0")
    require_finite(twin, "twin (card)")
    cpu_out, _s, _f = run_global(torch.device("cpu"), TWIN_APP, "flagship",
                                 feed[:CPU_BATCHES])
    worst_cpu = compare_outputs(twin[:CPU_BATCHES], cpu_out,
                                "twin card vs cpu (first batches)")
    print(f"[twin] generic path: {facts['state_bytes']} state bytes, "
          f"{rows_out} rows out of {len(feed) * BATCH}, first batch "
          f"{twin_s[0] * 1e3:.1f} ms, then {steady_eps(twin_s, BATCH):.1f} "
          f"events/s [{card}]; first {CPU_BATCHES} batches equal the CPU run "
          f"(max float rel err {worst_cpu:.3g})", flush=True)


def exchange_only() -> int:
    """``python3 chip_smoke.py --exchange``: the exchange kernel's quick
    check and timing alone, on one card: phases 1-3, then phase 33's gate
    1 at 2 x 2 and 4 x 1 and its gate 4 (the survivor's rows are not
    compared: phase 31, which gives them, does not run)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — --exchange runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from siddhi_tpu_torch.ops import _cuda

    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    _cuda.build(["ring_exchange"])
    print(exchange_line(check_exchange(torch.device("cuda", 0)), card), flush=True)
    for P in (2, 4):
        runs, _wall = px_children(P, "rows")
        for r, (code, got, tail) in enumerate(runs):
            _require(code == 0 and got is not None,
                     f"PX gate 1: process {r} of {P} exited {code}:\n{tail}")
            pr = got["pallas_ring"]
            print(px_gate1_line(f"process {r} of {P} ({N_SHARDS // P} shards each)",
                                got["gate1"], pr, f"events/s "
                                f"{steady_eps(pr['seconds'], BATCH):.1f} under pallas_ring",
                                card), flush=True)
    px_kill(None, card)
    return 0


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "siddhi_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: siddhi_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import sysconfig

    from siddhi_tpu_torch import native
    from siddhi_tpu_torch.ops import _cuda
    from siddhi_tpu_torch.ops.exchange import ring_exchange

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| python {sys.version.split()[0]}", flush=True)
    device = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    built = _cuda.build(["ring_exchange", "distinct_scan"])
    print(f"[build] {len(built)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, (so, log) in built.items():
        print(f"[build] {name}: {so.name}")
        for line in log.strip().splitlines():
            print(f"[ptxas] {line}")
    t0 = time.perf_counter()
    so = native.build_strdict()
    print(f"[build] native string dictionary {so.name} in "
          f"{time.perf_counter() - t0:.1f} s (g++, CPython headers at "
          f"{sysconfig.get_paths()['include']})", flush=True)

    # 3. kernels at the flagship's shapes
    ex = check_exchange(device)
    print(exchange_line(ex, card), flush=True)

    # 4. the slice
    feed = make_feed(5, N_BATCHES, BATCH, NUM_SYMBOLS)

    def reset_counts():
        ring_exchange.launches = 0
        ring_exchange.columns = 0

    # the routed step runs as a CUDA graph: the exchange the capture
    # recorded is held against the plain version on replay EX_RECORD_AT
    with recording_exchange(at=EX_RECORD_AT) as ex_rec:
        routed, routed_s, facts = run_slice(device, feed, routed=True,
                                            on_route=reset_counts)
    launches, columns = ring_exchange.launches, ring_exchange.columns
    _require(launches > 0, "routed run launched no ring_exchange kernel")
    _require(launches == facts["dispatches"] >= N_BATCHES,
             f"{launches} exchange launches for {facts['dispatches']} routed "
             f"dispatches of {N_BATCHES} batches: want one per dispatch")
    _require(facts["captured"] and facts["captures"] == 1
             and ex_rec.replays == facts["replays"] == N_BATCHES - 1,
             f"routed: captured {facts['captured']}, {facts['captures']} capture(s), "
             f"{facts['replays']} replays, {ex_rec.replays} ran the recorded exchange")
    _require(ex_rec.got is not None, "routed: the exchange inside the graph was not "
             f"recorded on call {EX_RECORD_AT}")
    ex_cols = check_exchange_call(ex_rec, "routed: the exchange in the graph")
    print(f"[slice] routed step captured as a CUDA graph: {facts['captures']} "
          f"capture, {facts['replays']} replays; the exchange inside replay "
          f"{EX_RECORD_AT} == ring_exchange_cols_plain on its {ex_cols} columns, "
          f"and the kernel launched on them eagerly too", flush=True)
    _require(facts["route_overflow"] == 0,
             f"route overflow {facts['route_overflow']} on the routed run")
    rows_out = sum(len(b["__ts__"]) for b in routed)
    _require(rows_out == N_BATCHES * BATCH,
             f"{rows_out} output rows for {N_BATCHES * BATCH} input rows")
    print(f"[slice] routed x{N_SHARDS}: {facts['state_bytes']} state bytes on "
          f"the card, {facts['key_slots']} key slots, {facts['dispatches']} "
          f"dispatches, {launches} exchange launches of {columns} columns, "
          f"{rows_out} rows out, first batch "
          f"{routed_s[0] * 1e3:.1f} ms, then {steady_eps(routed_s, BATCH):.1f} "
          f"events/s [{card}]", flush=True)

    unrouted, unrouted_s, ufacts = run_slice(device, feed, routed=False)
    worst = compare_outputs(routed, unrouted, "routed vs unrouted (card)")
    print(f"[slice] unrouted: first batch {unrouted_s[0] * 1e3:.1f} ms, then "
          f"{steady_eps(unrouted_s, BATCH):.1f} events/s [{card}]; routed == "
          f"unrouted (max float rel err {worst:.3g})", flush=True)

    cpu_out, _cpu_s, _ = run_slice(torch.device("cpu"), feed[:CPU_BATCHES],
                                   routed=True)
    worst_cpu = compare_outputs(routed[:CPU_BATCHES], cpu_out,
                                "card vs cpu (first batches)")
    print(f"[slice] first {CPU_BATCHES} batches equal the port's CPU run "
          f"(max float rel err {worst_cpu:.3g})", flush=True)

    # 5. the global flagship, fused
    fused, strings, fused_s = phase_global(device, feed, card)

    # 6. the twin, generic
    phase_twin(device, feed, card)

    # 7. the native string dictionary
    native_ms, plain_ms = check_strdict(feed)
    print(f"[strdict] native ids == plain ids over {len(feed)} batches of "
          f"{BATCH} symbols; host ms per encode, first batch ({NUM_SYMBOLS} "
          f"new strings): native {native_ms[0]:.2f}, plain {plain_ms[0]:.2f}; "
          f"later batches, mean: native "
          f"{statistics.mean(native_ms[1:]):.2f}, plain "
          f"{statistics.mean(plain_ms[1:]):.2f} [{card}]", flush=True)

    # 8. where the time goes
    profile_routed(device, feed, card)
    profile_global(device, feed, card)

    # 9. distinctCount / unionSet and the function library
    dist = phase_distinct(device, feed, card)
    d1 = dist["d1"]

    # 10. pipelined dispatch: the flagship behind @Async at depths 1, 4, 8
    pipe = phase_pipeline(device, feed, fused, card)
    # 11. the routed flagship behind @Async at depth 4
    routed_pipe_launches = phase_pipeline_routed(device, feed, routed, card)
    # 12. D1 behind @Async at depth 4
    dist["launches"]["D1_pipeline"] = phase_pipeline_distinct(
        device, feed, dist["d1_out"], card)
    # 13. the ingest front door: wire frames and the pack pool
    ingest = phase_ingest(device, feed, fused, strings, card)
    # 14. @OnError(action='stream')
    phase_onerror(device, feed, card)
    # 15. inMemory source -> flagship -> inMemory sink
    phase_transport(device, feed, card)
    # 16. D4: the distinct scan above H = 16,384
    d4, d4_launches = phase_d4(device, feed, card)
    # 17. time and batch windows, TIMER chunks, host stages
    td, td_launches, win = phase_windows(device, card)
    dist["launches"]["TD"] = td_launches
    # 18. partitions: keyed windows, range partitions, inner streams, purge
    pt, pt_launches, part = phase_partitions(device, card)
    dist["launches"]["PT"] = pt_launches
    # 19. patterns and sequences: config #4 at full width, K4 and K5
    patterns = phase_patterns(device, card)
    # 20. joins, tables, named windows, on-demand queries, triggers
    joins = phase_joins(device, card)
    # 21. incremental aggregation, then persist -> restore -> continue
    aggregation, chain, straight = phase_aggregation(device, card)
    persistence = phase_persistence(device, feed, routed, unrouted, dist["d1_out"], card)
    persistence["chain"] = chain
    dist["launches"]["P_D1"] = persistence["D1"]["scan_launches"]
    print(f"[persistence] phase 21 in {aggregation['phase_s'] + persistence['phase_s']:.1f} s",
          flush=True)
    # 22. the serving tier behind its REST front door
    straight["fold_ms"] = aggregation["fold_ms"]
    serving, sv_launches, sv_err = phase_serving(device, straight, card)
    dist["launches"].update(sv_launches)
    # 23. fan-out fusion: seven siblings as one captured step, FJ eager
    fanout, fo_launches, fo_err = phase_fanout(device, feed, card)
    dist["launches"]["FO"] = fo_launches

    # 24. the program cache: six apps, two programs, one graph each
    program_cache = phase_program_cache(device, card)

    # 25. the observability tier: instruments, journeys, traces, debugger
    observability = phase_observability(device, card)
    dist["launches"]["OB"] = observability["launches"]["scan"]

    # 26. overload control and the app supervisor
    overload, ol_exchange, ol_scan, ol_replays = phase_overload(device, card)
    dist["launches"]["OL"] = ol_scan

    # 27. the autopilot: six actuators live on the card
    autopilot, ap_exchange, ap_scan = phase_autopilot(device, card)
    dist["launches"]["AP"] = ap_scan

    # 28. the cluster fabric: two worker processes on the card
    cluster, cl_scan = phase_cluster(device, card)
    dist["launches"]["CL_workers"] = cl_scan

    # 29. the semantic fuzzer on the card, and the runtime sanitizers
    fuzz, fz_exchange, fz_ex_replays, fz_scan, fz_scan_replays = phase_fuzz(
        device, {"routed": routed, "global": fused, "d1": dist["d1_out"]}, card)
    dist["launches"]["FZ"] = fz_scan

    # 30. the lint and the native loader: CSV/JSONL bytes into both flagships
    lint_ingest, ln_exchange = phase_lint_ingest(device, feed, routed, routed_s, fused,
                                                 fused_s, card)

    # 31. the multi-process half: the card's world of one over NCCL
    distributed, ds_exchange, ds_scan, ds_gm = phase_distributed(device, feed, routed,
                                                                  fused, card)
    dist["launches"]["DS"] = ds_scan

    # 32. every shape of the key-sharded step across processes, C.11 and
    # the legacy host router
    split, sp_scans = phase_split(device, card)
    dist["launches"].update(sp_scans)

    # 33. K8 across processes: peer writes through CUDA IPC, two and four
    # processes on the card
    peer, px_launches = phase_peer(device, ds_gm, card)

    # 34. the management API: validate, the sandbox, persist_all /
    # restore_last_state over two apps, get_queries / is_stateful
    api, api_exchange = phase_api(device, feed, unrouted, card)

    # result lines
    print(f"[time] whole script {time.perf_counter() - t_start:.1f} s", flush=True)
    # each run's count is set to 0 just before it and read just after
    exchange_runs = {"routed": launches, "pipeline_routed": routed_pipe_launches,
                     "P_routed": persistence["routed_x4"]["exchange_launches"],
                     "OB": observability["launches"]["exchange"], "OL": ol_exchange,
                     "AP": ap_exchange, "FZ": fz_exchange, "LN": ln_exchange,
                     "DS": sum(ds_exchange.values()), "API": api_exchange,
                     **px_launches}
    px = peer["rank0"]
    kernels = [{
        "name": "ring_exchange", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/ring_exchange.cu",
        "replaces": "siddhi_tpu/parallel/mesh.py:1242",
        "launches": sum(exchange_runs.values()), "launches_by_run": exchange_runs,
        "max_abs_err": ex["max_abs_err"],
        "ms": ex["ms"], "kernel_ms": ex["ms"], "plain_ms": ex["plain_ms"],
        "bound_ms": ex["bound_ms"], "bound_by": "bytes",
        "library_ms": ex["library_ms"], "device_ms": ex["device_ms"],
        "device_traces": ex["device_traces"],
        # phase 4's launches inside the routed step's graph replays (the
        # capture's batch launches it eagerly), and the replayed call's
        # columns held against the plain version
        "launches_under_replay": {"routed": ex_rec.replays, "OL_quotas": ol_replays,
                                  "FZ": fz_ex_replays, "LN": lint_ingest["k8_replays"],
                                  "DS_GM": distributed["global_mesh_routed"]["replays"],
                                  "DS": distributed["routed_distinct"]["replays"]},
        "in_graph_columns_checked": ex_cols,
        "roofline_share": ex["roofline_share"],
        # phase 4's columns over phase 4's launches
        "columns_per_launch": columns / launches,
        "ms_warm_l2": ex["ms_warm_l2"],
        "plain_ms_warm_l2": ex["plain_ms_warm_l2"],
        "library_ms_warm_l2": ex["library_ms_warm_l2"],
        "host_ms": ex["host_ms"], "floor_ms": ex["floor_ms"],
        # the cross-process form (siddhi_peer_exchange_cols), phase 33's
        # process 0 of 2: its launches are launches_by_run's PX* entries
        "across_processes": {
            "wrapper": "siddhi_tpu_torch/ops/exchange.py peer_exchange_cols",
            "launches": sum(px_launches.values()), "max_abs_err": px["max_abs_err"],
            "columns": px["columns"], "calls_checked": px["calls_checked"],
            "ms": px["ms"], "host_ms": px["host_ms"],
            "host_profile_ms": px["host_profile"]["ms"],
            "device_ms": px["device_ms"], "share": px["share"], "launch": px["launch"],
            "floor_ms": px["floor_ms"],
            "plain_ms": px["plain_ms"],
            "bound_ms": px["bound_ms"], "bound_by": "bytes",
            "cross_bound_ms": px["cross_bound_ms"], "library_ms": px["library_ms"],
            "library": "gloo all_to_all_single of the same bytes",
            # process 0 of 4 (one shard each)
            "four": {k: peer["four_rank0"][k] for k in (
                "ms", "host_ms", "device_ms", "share", "launch", "plain_ms", "bound_ms",
                "library_ms")},
            "kill": {k: peer["kill"][k] for k in ("error_after_s", "sync_s", "close_s")}},
    }, {
        "name": "distinct_scan", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/distinct_scan.cu",
        "replaces": "siddhi_tpu/ops/aggregators.py:291",
        "launches": sum(dist["launches"].values()),
        "launches_by_run": dist["launches"],
        "max_abs_err": max(dist["max_abs_err"], td["max_abs_err"],
                           pt["max_abs_err"], sv_err, fo_err,
                           overload["tenants"]["scan_max_abs_err"],
                           overload["pipeline_quota"]["scan_max_abs_err"],
                           distributed["routed_distinct"]["scan_max_abs_err"],
                           *(split["shapes"]["group_by_distinct"][f"rank{r}"]
                             ["scan_max_abs_err"] for r in range(2))),
        # FO's and SV's launches are graph replays (one a batch) and one
        # eager warm-up launch a capture
        "launches_under_replay": {"FO": fanout["replays"],
                                  "SV_D1": serving["graph_replays"],
                                  "FZ": fz_scan_replays,
                                  "DS": N_SHARDS * distributed["routed_distinct"]["replays"]},
        "ms": d1["ms"], "plain_ms": d1["plain_ms"], "bound_ms": d1["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "device_ms": d1["device_ms"],
        "device_traces": d1["device_traces"],
        "roofline_share": d1["share"], "host_ms": d1["host_ms"],
        "chain": d1["chain"], "rows": d1["rows"], "H": d1["H"],
        "ns_per_chain_row": d1["ns_per_row"],
        **{name: {k: dist[name][k] for k in (
            "ms", "device_ms", "bound_ms", "share", "host_ms", "chain", "H",
            "ns_per_row", "cut_ms", "plain_ms")} for name in ("d2", "d3")},
        **{name: {k: f[k] for k in (
            "ms", "device_ms", "bound_ms", "share", "host_ms", "chain", "H",
            "ns_per_row", "cut_ms", "plain_ms", "max_abs_err")}
           for name, f in (("td", td), ("pt", pt))},
        "pt_groups": pt["groups"], "pt_rows": pt["rows"],
    }, {
        # the same kernel's global-index path (H > 16,384), at D4's shape:
        # ms and bound_ms over one whole batch, plain_ms and cut_ms (the
        # kernel) on its first D2_CUT rows
        "name": "distinct_scan (H > 16,384)", "route": "cuda",
        "source": "siddhi_tpu_torch/csrc/distinct_scan.cu",
        "replaces": "siddhi_tpu/ops/aggregators.py:291",
        "launches": d4_launches, "max_abs_err": d4["max_abs_err"],
        "ms": d4["ms"], "plain_ms": d4["plain_ms"], "bound_ms": d4["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "device_ms": d4["device_ms"],
        "roofline_share": d4["share"], "host_ms": d4["host_ms"],
        "chain": d4["chain"], "rows": d4["rows"], "H": d4["H"],
        "ns_per_chain_row": d4["ns_per_row"], "cut_ms": d4["cut_ms"],
        "plain_rows": D2_CUT, "state_bytes": d4["state_bytes"], "events_per_s": d4["eps"],
    }]
    print(json.dumps({"pipeline": {
        str(d): {k: v for k, v in f.items() if k != "strings"} for d, f in pipe.items()},
        "ingest": ingest}))
    print(json.dumps({"windows": {
        name: {"state_bytes": f["state_bytes"], "timer_steps": f["timers"],
               "batch_steps": f["steps"]["batch"]} for name, f in win.items()}}))
    print(json.dumps({"partitions": part}))
    print(json.dumps({"patterns": patterns}))
    print(json.dumps({"joins": joins}))
    print(json.dumps({"persistence": persistence}))
    print(json.dumps({"aggregation": aggregation}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"fanout": fanout}))
    print(json.dumps({"program_cache": program_cache}))
    print(json.dumps({"observability": observability}, default=str))
    print(json.dumps({"overload": overload}, default=str))
    print(json.dumps({"autopilot": autopilot}, default=str))
    print(json.dumps({"cluster": cluster}, default=str))
    print(json.dumps({"fuzz": fuzz}, default=str))
    print(json.dumps({"lint_ingest": lint_ingest}, default=str))
    print(json.dumps({"distributed": {**distributed, "k8_launches": ds_exchange}},
                     default=str))
    print(json.dumps({"split": split}, default=str))
    print(json.dumps({"peer": peer}, default=str))
    print(json.dumps({"api": api}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def cells(root: str) -> dict:
    """``python3 chip_smoke.py --cells ROOT``: the main path's cells driven
    by the checkout at ROOT (its package and its ``chip_smoke.py``'s
    helpers, imported in this process) on one card: events/s of the
    routed and unrouted partitioned flagship, the global flagship and D1
    over phase 4's feed, and one global-flagship batch under
    torch.profiler. Run it for two checkouts in one call to compare them
    on one card (parent, change, change, parent). Prints one ``CELLS``
    JSON line."""
    import importlib
    import os

    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    other = importlib.import_module("chip_smoke")
    _require(os.path.dirname(os.path.abspath(other.__file__)) == root,
             f"--cells: imported {other.__file__}, not {root}'s chip_smoke.py")
    from siddhi_tpu_torch.ops import _cuda

    _cuda.build(["ring_exchange", "distinct_scan"])
    dev = torch.device("cuda", 0)
    feed = other.make_feed(5, other.N_BATCHES, other.BATCH, other.NUM_SYMBOLS)
    res = {"root": root, "card": other.card_line()}
    for name, routed in (("routed_eps", True), ("unrouted_eps", False)):
        _o, secs, _f = other.run_slice(dev, feed, routed=routed)
        res[name] = other.steady_eps(secs, other.BATCH)
    _o, secs, _f = other.run_global(dev, other.GLOBAL_APP.format(W=other.WINDOW),
                                    "bench", feed)
    res["global_eps"] = other.steady_eps(secs, other.BATCH)
    _o, secs, _f = other.run_app(dev, other.D1_APP.format(W=other.WINDOW), feed)
    res["d1_eps"] = other.steady_eps(secs, other.BATCH)
    m, rt, _q = other.global_runtime(dev, other.GLOBAL_APP.format(W=other.WINDOW), "bench")
    h = rt.get_input_handler("StockStream")
    for b in feed[:2]:
        h.send_columns(*b)
    prof = other.profile_batch("global, one batch", lambda: h.send_columns(*feed[2]),
                               res["card"])
    m.shutdown()
    res["global_batch"] = {k: prof[k] for k in ("host_launch_calls", "busy_share",
                                                "device_ms", "wall_ms")}
    print("CELLS " + json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    try:
        if sys.argv[1:] == ["--imports"]:
            sys.exit(import_witness())
        if sys.argv[1:2] == ["--sanitized"] and len(sys.argv) == 3:
            sys.exit(sanitized_child(sys.argv[2]))
        if sys.argv[1:2] == ["--routed-child"] and len(sys.argv) == 6:
            sys.path.insert(0, str(Path(__file__).resolve().parent))
            sys.exit(routed_child(*sys.argv[2:6]))
        if sys.argv[1:2] == ["--peer-child"] and len(sys.argv) == 7:
            sys.path.insert(0, str(Path(__file__).resolve().parent))
            sys.exit(peer_child(*sys.argv[2:7]))
        if sys.argv[1:2] == ["--split-child"] and len(sys.argv) == 6:
            sys.path.insert(0, str(Path(__file__).resolve().parent))
            sys.exit(split_child(*sys.argv[2:6]))
        if sys.argv[1:] == ["--exchange"]:
            sys.exit(exchange_only())
        if sys.argv[1:2] == ["--cells"] and len(sys.argv) == 3:
            import torch

            if not torch.cuda.is_available():
                print("chip_smoke: no CUDA device — --cells runs on the card",
                      file=sys.stderr)
                sys.exit(2)
            cells(sys.argv[2])
            sys.exit(0)
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
