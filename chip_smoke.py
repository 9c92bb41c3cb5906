#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pio_tpu_torch) on one GPU.

Drives the port's text-classification serving, training and evaluation
paths at the template's full width (V = 65537 TF-IDF rows with the pad
row, H = 128, bag width L = 256, C = 20 labels, batch chunk 1024), on
weights and a
corpus made from ``--seed``, through the hand-written CUDA embedding-bag
kernels (the forward, and the backward's bag scatter and bag dot):

1. print the card's name and power limit;
2. build every kernel of the path from ``pio_tpu_torch/ops/csrc`` with nvcc;
3. hold the forward kernel against its plain PyTorch version on the card, and
   time kernel, plain version, the library call and the bound (CUDA events),
   printing beside each time the share of weight-0 slots and the achieved
   gather rate, and on a line of its own the previous design's recorded
   time; time each batch shape again at the plans that other SM
   residencies would give; then check the edge shapes of the launch plan
   (one slot, an unaligned row view, no bags, a bag of weight-0 slots),
   each called twice for the same bits;
4. build a full-width model from a synthetic 20-label corpus;
5. serve 8 ``POST /queries.json`` through the port's query server, checked
   against a CPU copy of the model run through the plain version;
6. run ``MLPAlgorithm.batch_predict`` over 1024 queries and check it against
   the loop of ``predict`` and the CPU copy;
7. check that the served path launched the kernel (launch counters);
8. hold the backward kernels (bag scatter for d_table, bag dot for d_w)
   against their plain versions at the training shape (11314 bags of 256
   slots over the f32 and bf16 tables), the NB shape (one column over
   20 x 65537 rows) and the edge shapes, each twice for the same bits and
   timed (kernel, plain version, the library's autograd, the bound, the
   bytes each design moves through L2 and their rate); time both kernels
   at D = 32, 64 and 128 over the same slots; then drive both gradients
   through the port's differentiable ``embedding_bag``;
9. ingest a synthetic 20-label corpus of 11314 documents (the size of the
   public 20 Newsgroups train split) as ``$set`` events, ``run_train`` the
   ``mlp`` (200 full-batch Adam steps) and ``nb`` algorithms on the card,
   split one training step into its parts (CUDA events), hold 5
   training steps through the kernels against 5 through the plain versions
   from the same initial parameters, and time the bag scatter and the bag
   dot on the prepared bags (their slots a row printed) against their
   plain versions;
10. ``load_models_for_instance`` and serve the trained models through the
   query server, checked against a CPU copy of the same persisted blob;
11. ``train_als`` at MovieLens-25M's shape (25 M ratings from a copy of
   ``bench.py``'s ``_synth_ratings``, rank 16, 10 iterations, reg 0.1) on
   its default route (printed: the packer and the shipment count):
   its phases and peak memory, twice for the same bits, float32 against
   bfloat16 in turns, one half-step a side split into gather + products,
   segment sum and solve with its launches and bound, each solver at both
   entity counts, the wire decoded and ``device_pack`` timed, and the
   peak memory of one iteration at rank 128;
12. ``train_als`` on the card against the CPU at MovieLens-100K's shape,
   and each device program card against CPU, both sides;
13. the recommendation template end to end at that shape: ingest,
   ``run_train``, ``load_models_for_instance``, 8 ``POST /queries.json``
   (on the card, then routed by batch size with
   ``PIO_TPU_SERVE_DEVICE=auto``) and ``batch_predict`` of 1024 against
   the ``predict`` loop, checked against a CPU copy;
14. the top-N scorer at full width on phase 11's factors, card against
   host path;
15. ``train_als`` at MovieLens-25M's shape on the default route: the
   native packer's wire against the numpy wire array for array on the
   first 5,000,000 ratings, with both host times; the default route once with its phases and peak
   memory (the native packer, phase 11's bits), and its wall time without
   stats (3 runs);
16. the native host scorer at full width on phase 11's factors (B = 1, 64,
   512) against the numpy host path and the card, and bitwise against
   numpy on factors whose dot products are exact;
17. ``run_evaluation`` of ``recommendation_evaluation`` at MovieLens-100K's
   shape (phase 13's events; 3 folds, ranks 8 and 16 at lambda 0.1) on the
   card and on the CPU: the same best params, MSE within EVAL_MSE_RTOL;
18. implicit ``train_als`` at the similar-product configuration
   (``bench.py``'s ``_bench_similarproduct``: 5 M views, rank 16, alpha
   40): phases and peak memory, twice for the same bits, one half-step a
   side split into gram, normal equations and solve with launches and
   bounds, each solver's time and residual, and card against CPU at
   MovieLens-100K's shape;
19. the similar-product template end to end at MovieLens-100K's shape
   (100,000 views, 1,682 items with 1-3 of its 19 genres, 50 items nobody
   viewed): ``run_train`` on the card, 8 ``POST /queries.json`` checked
   against a CPU copy of the blob, ``batch_predict`` of 1024 against the
   loop;
20. the e-commerce template on those events plus 5,000 buys and the
   unavailable-items constraint: 8 requests, ``unseen_only``, the
   constraint changed between two identical queries, ``batch_predict``
   of 1024 (128 of them against the loop), and a query's time with and without its live reads, on the
   memory store and again with EVENTDATA on SQLite;
21. ``run_evaluation`` of ``similarproduct_evaluation`` and
   ``ecommerce_evaluation`` on those events (3 folds, rank 16), card
   and CPU;
22. ``run_evaluation`` of ``textclassification_evaluation`` on phase 9's
   corpus (2 folds, hidden 64 and 128) on the card, its kernel launches
   added to the kernels' line; then card against CPU on a tenth of it at
   hidden 64 and 2 folds;
23. ``train_logreg`` at the classification benchmark's width
   (``bench.py``'s ``_bench_classification``: 100,000 x 256, 10 classes,
   100 Adam steps, lr 0.05) in int8, float32 and bfloat16: wall time
   (median of 3), the stats split, examples/s, train accuracy, peak
   memory, the same bits twice, card against the CPU, and one step's
   device time, launches and bound;
24. the dense ``train_multinomial_nb`` at the same shape (|X| as
   features): the same bits twice, card against the CPU, the per-class
   sums' device time against their bound;
25. the resident scorer on phase 23's int8 model at batches 1, 8, 64 and
   512 on both wires: device and host ms a call against the host numpy
   mirror, h2d bytes a request, hit rate, and the codes of every training
   row against the mirror;
26. the classification template end to end: 20,000 ``$set`` users,
   ``run_train`` of ``naivebayes`` and ``logreg`` on the card, the query
   server with the resident scorer placed, 8 ``POST /queries.json`` on
   each wire against a CPU copy, ``GET /stats.json``, ``batch_predict``
   of 1024 against the loop, and ``classification_evaluation`` card
   against CPU;
27. ``train_markov_chain`` at 4,096 states and 1,000,000 transitions, card
   against CPU;
28. the README quickstart through ``python -m pio_tpu_torch``, each verb a
   process, on SQLite under a fresh ``$PIO_TPU_HOME`` (the storage
   defaults, durability at its default): ``app new``, ``eventserver``
   taking MovieLens-100K's shape (100,000 ``rate`` events) over HTTP in
   batches of 50 with one single event per 1,000 (events/s, p50/p99 a
   batch), the reference's codes on bad requests, ``export`` and
   ``import`` into a second app (equal ``find``; these two and the second
   ``app new`` on a thread beside what follows), ``train`` on the card,
   ``deploy``, 20 ``POST /queries.json`` and ``batchpredict`` of 1024
   (``status`` beside it) against the CPU copy of the served blob, the
   CLI-trained factors against ``run_train`` on the CPU over the events
   read back through ``PEventStore``, ``undeploy``; each verb's wall
   time;
29. text classification through ``pio_tpu_torch.tools.cli.main`` in this
   process: ``import`` of phase 9's corpus, ``train`` and ``deploy`` (on a
   thread, ended by ``undeploy``), 8 queries over HTTP against the CPU
   copy of the blob; the forward's and kernel A's launches on this path
   join the kernels' line;
30. ``train_two_tower(None, ...)`` at ``bench.py``'s two-tower shape
   (500,000 pairs, 100,064 users, 50,064 items, embed 64, hidden 128, out
   64, batch 4,096, 200 steps): wall time (median of 3, the same bits
   each time), examples/s, the stats split, peak memory, the bf16 table
   wire, one step's kernels against ``steps_s / 200`` (the card's idle
   share) and its bound, and the step card against CPU;
31. two-tower training card against CPU at a small shape from one init:
   20 steps' losses and the vector tables;
32. the two-tower template end to end on phase 13's events: ``run_train``,
   8 ``POST /queries.json`` against a CPU copy of the blob,
   ``batch_predict`` of 1024 against the loop, ``twotower_evaluation``
   card against CPU at out_dim 64, 100 steps;
33. ``train_seqrec(None, ...)`` at ``bench.py``'s sequence shape (256
   histories, T 128, d 256, 8 heads, 4 layers, ffn 1,024, vocab 20,000, 30
   full-batch steps): tokens/s, the stats, peak memory, a step split into
   attention, FFN and the cross-entropy logits (kernel times), its flops
   against the f32 peak, one layer's attention against
   ``F.scaled_dot_product_attention`` as a yardstick, and card against CPU
   over 16 rows;
34. the sequence template end to end on phase 13's events in time order:
   ``run_train``, 8 ``POST /queries.json`` by user and by history against
   a CPU copy, ``batch_predict`` of 1024 against the loop, and
   ``sequence_evaluation`` card against CPU at a reduced depth;
35. checkpoints on the card: both trainers of phases 30 and 33 stopped
   after their first snapshot and resumed, the same bits as the
   uninterrupted runs; ``pio train --checkpoint-every`` (the CLI's main
   in this process) on phase 28's SQLite home;
36. phase 4's text model served under concurrency: 1 and 32 keep-alive
   clients x 32 queries with the micro-batcher off and on (adaptive off,
   the window printed), every answer against the solo path and the CPU
   copy through the plain version, p50/p99, batches, ``maxBatch``,
   dispatches a bucket and ``retraces`` after warmup (0); the adaptive
   probe's verdict; the forward kernel at each bucket of the ladder on
   the served bags against its plain version and bound (its launches in
   this phase join the kernels' line);
37. the recommendation template on phase 11's factors (MovieLens-25M's
   width, num 10) through the same runs, answers against a CPU copy;
38. ``POST /reload`` 3 times under 32 clients: two seeds' logreg
   instances of phase 26's users on the int8 wire with the resident
   scorer on the card, stored in SQLite; every answer 200 and a
   generation's CPU copy's, the outgoing scorers retired, device memory
   back to one generation's parameters and the ladder's buffers;
39. ``python -m pio_tpu_torch deploy --workers 4 --device-worker`` as a
   process over phase 38's store: JSON and packed int8 queries from 32
   clients against the CPU copy, p50/p99, worker 0's lane drained with
   no fallback, only worker 0 on the card (``nvidia-smi``), ``/reload``
   rolling all four workers and ``/undeploy`` ending the pool;
40. the device ops plane: ``run_train`` of phase 29's engine with
   ``profile_dir`` (the trace's forward and bag-scatter launches against
   the run's launch counters, its sentinels, the run ledger's new row,
   the wall against phase 29's untraced ``pio train``); two-tower at
   ``bench.py``'s shape with a recorder and the status sidecar
   (``/train.json`` advancing, the recorded losses the steps' own bits,
   the same kernels and synchronizing calls as without the recorder, the
   step time both ways); ``/device.json`` of phase 29's engine deployed
   with the micro-batcher after 32 clients x 16 (``bytesInUse`` against
   ``torch.cuda.memory_allocated``, ``limitBytes`` against the card's
   total, ``bucket_warmup`` the ladder, ``bucket_dispatch`` 0) and ``pio
   top --once`` on it; a ``deploy --workers 2 --device-worker`` pool,
   started beside that and the next check (the CPU worker's watch on the
   ledger, no CUDA context in it);
   ``PIO_TPU_PROFILE`` with 8 executions on a deploy with the
   micro-batcher, and a restart into ``capture-0001`` (the captures'
   forward launches against the dispatches': the ladder's warmup sweeps,
   then live queries through the batcher); the sampler's cost (p50 and queries/s from 1 and 32
   clients with ``PIO_TPU_DEVICEWATCH`` off and on). Every profiled
   window of the script (``count_kernels``, ``device_busy``, the traces)
   idles and launches sentinel kernels at both ends and fails when a
   window lost an end (``pio_tpu_torch/obs/profile.py``);
41. the multi-device paths on the one card: a 1-rank NCCL group formed
   through the env contract runs ``train_als`` at MovieLens-25M's shape
   on both mesh wires (phase 11's factors bit for bit; one user half-step
   split into partial_normal_eq, reduce_scatter, solve and all_gather)
   and the data-parallel ``train_mlp`` at the text defaults (phase 9's
   parameters bit for bit; the forward's and kernel A's launches, 200
   each, joining the kernels' line; the gradients' all_reduce a step);
   two ranks on cuda:0 (NCCL's refusal recorded, its two ranks beside
   the two gloo ranks; over gloo, where it
   carries CUDA tensors for all_reduce, reduce_scatter_tensor and
   all_gather_into_tensor, ALS at MovieLens-100K's shape and 5 steps of
   train_mlp against one rank); the recommendation template at
   MovieLens-25M's width with ``PIO_TPU_MESH_SERVE=1`` over (cuda:0,) x 4
   (256 users' top-10 against the unsharded scorer, ``/stats.json``'s
   ``sharding``, the ``shard`` ledger, device memory over four
   ``/reload``, each generation's live blocks by the code that allocated
   them: the shards' requested bytes and the allocator's slack, and
   nothing else); ``pio train`` (the CLI's main in this process) with
   ``PIO_TPU_SHARDED_PERSIST=1`` on SQLite and ``deploy --workers 2
   --mesh-worker`` (worker 0 alone on the
   card, sharded; worker 1 on the CPU);
42. the neural templates over a mesh on the one card: in a 1-rank NCCL
   group, ``train_two_tower`` and ``train_seqrec`` (ring and ulysses)
   over the group's mesh at ``bench.py``'s shapes, phase 30's tables and
   phase 33's parameters bit for bit, each collective's device time
   (CUDA events); two gloo ranks on cuda:0 (whether gloo carries
   ``all_to_all_single`` and a send on CUDA tensors recorded; two-tower
   over data 2 and model 2, the sequence model over model 2, seq 2 and
   pipe 2 where gloo carries their collectives, 3 steps each, against
   one rank: the parameters and the first step's gradients); and the
   two-tower template on phase 30's tables persisted as 4 shard records
   and served with ``PIO_TPU_MESH_SERVE=1`` over (cuda:0,) x 4 (256
   users' top-10 against the unsharded scorer);
43. the streamed epoch feed, the resident scorer's mesh and the
   failpoints: ``train_two_tower`` at ``bench.py``'s shape streamed
   (``stream="on"``, 8 spans, lookahead 2) against the staged run in
   turns (the same bits; walls, ``h2d_bytes``, ``h2d_s``, the overlap
   ratio of a recorded run, the pinned buffers a run, the card's busy
   share), under a budget of the params + 1 MiB (``stream="auto"``: the
   same bits, the peak within lookahead + 1 spans and a staged step's
   temporaries) and at MovieLens-25M's 25,000,095 pairs; ``train_seqrec``
   at phase 33's width in minibatches of 64, streamed against staged; the
   classification template's resident scorer served with
   ``PIO_TPU_MESH_SERVE=1`` over (cuda:0,) x 4 at 3 features
   (``meshFallback``) and 256 (sharded): codes against the unsharded
   scorer with near-ties counted, the residency block and the
   ``resident`` ledger a shard, p50/p99 both ways, device memory over a
   deploy and four ``/reload``; and fault drills: ``stream.put=error:once``
   (the streamed two-tower raises, the next run gives phase 30's bits) and
   ``scorer.dispatch.solo=latency:20ms`` on phase 4's model (the p50 lifted
   by 20 ms or more, ``/faults.json`` and ``/metrics`` counting the
   triggers; the clean p50 beside phase 36's);
44. the event and model stores feeding training on the card, in this
   process: the event server over SQLite and over the native event log
   (``PIO_TPU_DURABILITY`` at its default) takes 5,000 of phase 28's
   events in batches of 50 and 250 single posts (events/s, p50/p99 a
   batch and a single post, ``os.cpu_count()``), every acknowledged event
   read back (the store's count, ``find_frame``, ``get`` of 50); then
   a quarter of MovieLens-1M's ratings (250,052 over its 6,040 users and 3,706
   items, synthetic as ``bench.py``'s) written with ``write`` into the
   memory store, the event log, parquet, searchable and the partitioned
   log (4 partitions replicated to one follower on loopback; each write's
   and ``find_frame``'s wall), ``run_train`` of the recommendation template on
   the card from each (rank 16, 10 iterations, lambda 0.1: the memory
   store's factors bit for bit), persisted through localfs, blob on a
   ``file://`` root and the blob daemon on ``http://127.0.0.1``, each
   deployed and answering 64 queries as the localfs deployment does; 1% of
   the event log's events deleted and the log compacted (its count and
   ``find_frame`` against the memory store's after the same deletes);
   ``GET /events/search.json`` on searchable (its hits against the
   memory store's) and 501 on the event log; 44.4 the partitioned log's
   follower drained (the drain's seconds; its sidecar's ``/storage.json``
   positions the leader's committed bytes), the leader stopped, the
   mirror promoted into a fresh root, reopened and trained from on the
   card (the memory store's factors bit for bit; the failover's seconds),
   then 1,000 users' ``$set`` written and ``compact``ed (the snapshot
   reads as the full fold, the ratings as the memory store's);
45. the request plane of both servers on phase 4's model, in this
   process: 45.1 1,024 queries on one keep-alive connection, each with
   ``X-Pio-Trace: smoke45-<i>/caller``, under two SLOs and a QoS spec that
   admits them all (every answer echoes its id and is bit for bit the
   solo path's, phase 5's among them; the profiler's forward launches
   equal the queries; the traces' stages in order; ``attributedFraction``
   within 0.01 of 1; on 32 more, each ``execute.device`` span no shorter
   than its forward kernel's CUDA-event time and inside ``execute``; the
   ``served query`` record under each sampled id in ``/logs.json``; p50,
   p99 and the stages' p50s beside phase 36's solo p50; the tracer's own
   cost a request); 45.2 32 clients x 32 under ``inflight=2,queue=4`` (and
   a rate), the batcher off then on (the counts of 200, 429 and 503, each
   shed with ``Retry-After``, ``/qos.json``'s sheds adding up to them,
   every 200 the solo answer, the forward launches equal to the executed
   requests or the batches' dispatches, every ``microbatch`` trace linking
   its members); 45.3 a spent deadline shed with nothing launched,
   ``scorer.dispatch.solo=error`` until the breaker opens, cached queries
   answered from the stale cache bit for bit under ``X-Pio-Degraded``,
   others 503 ``breaker``, nothing launched, then the probes closing it
   (``/qos.json`` open, half-open, closed); 45.4 64 queries with a
   feedback app (each answer's ``prId``, 64 ``predict`` events of
   ``pio_pr`` with query and prediction); 45.5 the event server on SQLite
   with a QoS gate: 5,000 of phase 28's events in batches of 50 (events/s
   beside phase 44.1's), 200 single posts from 4 clients (their traces'
   ``store.flush``, ``store.commit_wait`` where they queued, linked from
   the committer's flush traces), ``/metrics``' group-commit and retry
   families (one retry forced), a Segment.io webhook stored, the other
   routes answering, and a storage failpoint opening the storage breaker
   (503 with ``Retry-After``);
46. the pool plane and the router over phase 29's text engine, each server
   a ``python -m pio_tpu_torch`` process on phase 29's home: a single
   ``deploy``, a pool of 4 with ``--device-worker``, a second such pool
   under ``--qos rps=100,burst=50`` and ``eventserver``, started together;
   both pools with a 5 s lane timeout; 46.1 32 clients x 32 through the
   pool (every answer within CONF_TOL of the single process's, p50, p99
   and queries/s; no query of either pool served on a sibling's CPU: no
   lane fallback, worker 0 drained every query the siblings answered),
   every worker's ``/stats.json`` pool totals and ``/metrics`` the
   requests sent, stripe
   generations 1; the busiest sibling killed, its respawn at generation 2
   with the pool's totals kept; 32 clients for 3 s against the QoS pool
   admit burst + R x t, not 4 budgets (the 429s with ``Retry-After``);
   46.2 ``fleet`` over the pool, the single process and the event server
   (every member up, its federated ``pio_tpu_queries_total`` the members'
   own), ``dashboard`` (the serving view's pool-wide total) and
   ``adminserver`` (an app made and deleted), every route 200; 46.3
   ``route`` over the pool and the single process (each routed answer the
   direct one, both members used, the ms it adds), a candidate query
   server in this process, ``rollout --start`` of phase 40.1's instance
   twice: one whose candidate burns its SLO rolls back leaving both
   replicas' ``/deploy.json`` as they were, one promotes and flips both to
   the next generation after ``verify_instance``; the forward launches of
   every server (their ``/stats.json`` ``kernelLaunches``) join the
   kernels' line;
47. the HTTP fronts: 47.1 phase 4's model in this process on the threaded
   and the evloop front (``PIO_TPU_HTTP_FRONT``), 1 and 32 keep-alive
   clients x 32 each (p50, p99, queries/s; every answer within CONF_TOL
   of phase 5's), and a pipelined burst of 16 on one connection on each
   front, answered in order; 47.2 phase 39's classification pool of 4
   with ``--device-worker`` again, ``PIO_TPU_HTTP_FRONT=evloop`` in the
   verb's environment and a 5 s lane timeout, JSON and packed int8 frames
   from 32 clients (every answer the CPU copy's, no lane fallback on any
   worker, the evloop families in ``/metrics``; beside phase 39's threaded
   numbers); 47.3 TLS with a certificate minted by the ``openssl``
   binary: a threaded query server over HTTPS answers phase 4's queries
   with the same bits as plain HTTP, ``evloop`` with TLS configured serves
   threaded, and a plain-text client gets no answer. 47's forward
   launches (``/stats.json`` ``kernelLaunches``) join the kernels' line.

The CLI phases write their homes under ``build/chip_smoke_homes/``
(gitignored), made afresh each run; every server process is stopped
before its phase ends.

Usage: ``python3 chip_smoke.py [--seed N]``. Exits non-zero when no CUDA
device is available or any phase fails. The line before the last holds
``nvidia-smi``'s name and power limit, the one before it the kernels' JSON
summary, the one before that the device programs of the recommendation,
classification and neural paths
(``{"programs": [...]}``), the one before that every phase's wall
(``{"phase_walls_s": {...}}``), and the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import datetime as dt
import gc
import http.client
import io
import json
import logging
import os
import re
import shutil
import socket
import ssl
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pio_tpu_torch.controller.engine import EngineParams, get_engine_factory  # noqa: E402
from pio_tpu_torch.controller.params import params_from_dict, params_to_dict  # noqa: E402
from pio_tpu_torch.convert import text_mlp_from_reference  # noqa: E402
from pio_tpu_torch.data.bimap import BiMap  # noqa: E402
from pio_tpu_torch.data.datamap import DataMap  # noqa: E402
from pio_tpu_torch.data.event import Event  # noqa: E402
from pio_tpu_torch.data.store import PEventStore  # noqa: E402
from pio_tpu_torch.models import als, logreg, markov_chain, mlp, naive_bayes  # noqa: E402
from pio_tpu_torch.models import adam, seqrec, two_tower  # noqa: E402
from pio_tpu_torch.models.naive_bayes import train_multinomial_nb_bags  # noqa: E402
from pio_tpu_torch.models.tfidf import TfIdfVectorizer  # noqa: E402
from pio_tpu_torch import faults  # noqa: E402
from pio_tpu_torch.obs import devicewatch, trainwatch  # noqa: E402
from pio_tpu_torch.obs import profile as window  # noqa: E402
from pio_tpu_torch import native  # noqa: E402
from pio_tpu_torch.ops import _build  # noqa: E402
from pio_tpu_torch.ops import embedding, topn  # noqa: E402
from pio_tpu_torch.parallel import stream  # noqa: E402
from pio_tpu_torch.parallel.context import ComputeContext  # noqa: E402
from pio_tpu_torch.server import residency  # noqa: E402
from pio_tpu_torch.server.http import PACKED_QUERY_CONTENT_TYPE  # noqa: E402
from pio_tpu_torch.server.query_server import QueryService, create_query_server  # noqa: E402
from pio_tpu_torch.server.query_server import deploy_query_server  # noqa: E402
from pio_tpu_torch.server.train_status import create_train_status_server  # noqa: E402
from pio_tpu_torch.server.blob_server import create_blob_server  # noqa: E402
from pio_tpu_torch.server.event_server import create_event_server  # noqa: E402
from pio_tpu_torch.server.fleetd import create_follower_status_server  # noqa: E402
from pio_tpu_torch.storage import durability  # noqa: E402
from pio_tpu_torch.storage.partlog import failover, replication  # noqa: E402
from pio_tpu_torch.storage.records import AccessKey, App  # noqa: E402
from pio_tpu_torch.storage.registry import Storage  # noqa: E402
from pio_tpu_torch.templates.classification import Query as CLSQuery  # noqa: E402
from pio_tpu_torch.templates.classification import classification_evaluation  # noqa: E402
from pio_tpu_torch.templates.classification import LogRegClassifierModel as TCLogRegModel  # noqa: E402
from pio_tpu_torch.templates.common import business_rule_mask  # noqa: E402
from pio_tpu_torch.templates.ecommerce import ECommAlgorithm  # noqa: E402
from pio_tpu_torch.templates.ecommerce import Query as ECQuery  # noqa: E402
from pio_tpu_torch.templates.ecommerce import ecommerce_evaluation  # noqa: E402
from pio_tpu_torch.templates.recommendation import ALSAlgorithm as RecALS  # noqa: E402
from pio_tpu_torch.templates.recommendation import ALSModel as RecModel  # noqa: E402
from pio_tpu_torch.templates.recommendation import Query as RecQuery  # noqa: E402
from pio_tpu_torch.templates.recommendation import recommendation_evaluation  # noqa: E402
from pio_tpu_torch.templates.sequence import Query as SeqQuery  # noqa: E402
from pio_tpu_torch.templates.sequence import sequence_evaluation  # noqa: E402
from pio_tpu_torch.templates.twotower import Query as TTQuery  # noqa: E402
from pio_tpu_torch.templates.twotower import twotower_evaluation  # noqa: E402
from pio_tpu_torch.templates.similarproduct import Query as SPQuery  # noqa: E402
from pio_tpu_torch.templates.similarproduct import SimilarProductAlgorithm as SPAlgorithm  # noqa: E402
from pio_tpu_torch.templates.similarproduct import known_codes, similarproduct_evaluation  # noqa: E402
from pio_tpu_torch.tools.cli import main as _cli_main  # noqa: E402
from pio_tpu_torch.templates.textclassification import (  # noqa: E402
    MLPAlgorithm,
    MLPParams,
    Query,
    TextPreparator,
    _query_bag,
    _stack_bags,
    textclassification_evaluation,
)
from pio_tpu_torch.workflow.checkpoint import CheckpointManager  # noqa: E402
from pio_tpu_torch.workflow.core_workflow import (  # noqa: E402
    load_models_for_instance,
    run_evaluation,
    run_train,
)
from pio_tpu_torch.utils import knobs  # noqa: E402
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict  # noqa: E402
from pio_tpu_torch.workflow.deploy_common import to_jsonable  # noqa: E402
from pio_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from pio_tpu_torch.obs.tracing import Tracer  # noqa: E402
from pio_tpu_torch.workflow.params import WorkflowParams  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, f32 outside the
# tensor cores (the kernel's FMAs are f32 whatever the table type)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

MAX_FEATURES = 65536  # PreparatorParams.max_features → V = 65537
HIDDEN = 128  # MLPParams.hidden
BAG_WIDTH = 256  # PreparatorParams.max_doc_tokens
N_QUERIES = 1024  # the batch chunk of batch_predict
N_HTTP = 8
# the 20 Newsgroups labels: the usual public benchmark of this task
LABELS = [
    "alt.atheism", "comp.graphics", "comp.os.ms-windows.misc",
    "comp.sys.ibm.pc.hardware", "comp.sys.mac.hardware", "comp.windows.x",
    "misc.forsale", "rec.autos", "rec.motorcycles", "rec.sport.baseball",
    "rec.sport.hockey", "sci.crypt", "sci.electronics", "sci.med",
    "sci.space", "soc.religion.christian", "talk.politics.guns",
    "talk.politics.mideast", "talk.politics.misc", "talk.religion.misc",
]
# kernel vs plain version: the same f32 products summed in another order;
# bag weights are L2-normalized (as TF-IDF bags are), so outputs are O(1)
# and 1e-4 leaves two orders of magnitude over f32 rounding at L = 256.
# bf16 tables convert to f32 exactly before the multiply, so the same limit.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-4}
CONF_TOL = 1e-5  # served confidence vs the CPU copy (f32 softmax)
# device ms of the kernel's previous design (one 128-thread block per bag
# walking L slot by slot, 4-byte loads, padding read), measured by this
# script at commit 1f8eded on an NVIDIA H100 80GB HBM3 at 700 W. Printed
# for comparison on a line of its own, never in the kernels' JSON line.
PREV_KERNEL_MS = {
    "serving f32": 0.02732, "serving bf16": 0.02222, "one query f32": 0.01473,
    "wide f32": 0.04500, "served batch (TF-IDF bags)": 0.02431,
    "served query (TF-IDF bag)": 0.01176,
}
# shapes the launch plan treats apart: name -> (B, L, D, table is a row view)
EDGE_SHAPES = {
    "one slot": (1, 1, 128, False),
    # D = 130 and a pointer one row in: 8-byte (f32) or 4-byte (bf16) lanes
    "unaligned row view": (3, 7, 130, True),
    "no bags": (0, 8, 128, False),
    "zero-weight bag": (4, 16, 128, False),
}
# warps of the kernel an SM holds, as the plan may assume it; at B = 1024,
# D = 128 on 132 SMs these give a bag 2, 4, 8 and 16 warps
SWEEP_WARPS_PER_SM = (16, 32, 64, 128)

N_DOCS = 11314  # documents of the public 20 Newsgroups train split
N_WORDS = 70000  # distinct synthetic words: the vocabulary caps at V - 1
APP = "newsgroups-synthetic"
COMPARE_STEPS = 5
# backward kernels vs plain versions, f32: the same f32 products summed in
# another order. d_table rows sum ~45 products of O(0.1) at the training
# shape, d_w is a 128-term dot of O(1) values (|d_w| ~ 11): 1e-4 and
# 1e-4·sqrt(D) leave two orders of magnitude over f32 rounding.
BWD_TOL = 1e-4
# a bf16 d_table is the f32 sum rounded once: where the two f32 sums differ
# in the last bit, the roundings may land one bf16 step apart, at most
# 2^-7 of the value
BF16_STEP = 2.0 ** -7
# 5 Adam steps through the kernels vs through the plain versions, from one
# init: gradients differ by f32 rounding of sums in another order (~1e-7
# relative), and Adam divides by sqrt(v) + 1e-8, so a weight moves at most
# lr·|dg|/1e-8 apart where |g| is tiny (a few 1e-6 at these gradients'
# 1e-12 rounding) and far less elsewhere; 1e-4 over 5 steps of lr 0.01
TRAIN_TOL = 1e-4
# NB log-probabilities, card vs the plain version on the CPU: feature sums
# in another order (f32, ~1e-7 relative) move log theta (~ -11) by ~1e-7
NB_TOL = 1e-5
# device ms of kernel A's first design (one lane group a row of d_table,
# reading a g row for each non-zero slot), measured by this script at
# commit 9818f09 on an NVIDIA H100 80GB HBM3 at 700 W. Printed for
# comparison on a line of its own, never in the kernels' JSON line.
PREV_SCATTER_MS = {"training f32": 0.1908, "training bf16": 0.1898,
                   "nb feature sums": 0.0329}
# the same design's D sweep over the training slots (SWEEP_D), measured by
# scripts/torch_bag_scatter.py from a checkout of 9818f09 on an NVIDIA H100
# 80GB HBM3 at 700 W; printed beside this run's sweep
PREV_D_SWEEP_MS = {32: 0.06061, 64: 0.10552, 128: 0.18978}
# widths of the D sweep: a kernel bound by bytes takes time in proportion
# to D, one bound by latency about the same time at each
SWEEP_D = (32, 64, 128)
# device ms of kernel B's first design (one warp a bag, a 5-step butterfly
# a slot), measured by this script at commit 9818f09 on an NVIDIA H100
# 80GB HBM3 at 700 W. Printed for comparison on a line of its own, never in
# the kernels' JSON line.
PREV_DOT_MS = {"training f32": 0.3026, "training bf16": 0.2855}
# shapes the backward kernels treat apart: name -> (B, L, D, table and g
# are row views one row in, pattern)
BWD_EDGE_SHAPES = {
    "one slot": (1, 1, 128, False, ""),
    "no bags": (0, 8, 128, False, ""),
    "zero-weight bag": (4, 16, 128, False, "zero-bag"),
    "every slot on one row": (16, 64, 128, False, "one-row"),
    "unaligned row view": (3, 7, 130, True, ""),
}
#: the launch counters of embedding.py, by kernel name
COUNTERS = {
    "embedding_bag": "KERNEL_LAUNCHES",
    "embedding_bag_backward_table": "BACKWARD_TABLE_LAUNCHES",
    "embedding_bag_backward_weights": "BACKWARD_WEIGHTS_LAUNCHES",
}


#: (phase, its start on the monotonic clock) in the order the phases ran:
#: a phase is the script's output from its "phase N:" line to the next one
PHASE_STARTS: list = []
_PHASE_LINE = re.compile(r"phase (\d+):")


def log(msg: str) -> None:
    m = _PHASE_LINE.match(msg)
    if m:
        PHASE_STARTS.append((int(m.group(1)), time.monotonic()))
    print(msg, flush=True)


def phase_walls() -> dict:
    """Each phase's wall in seconds (host clock), to now for the last."""
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.monotonic()]
    return {str(n): round(end - t, 1)
            for (n, t), end in zip(PHASE_STARTS, ends)}


#: ~10 ms of device spin at the H100's clock: longer than the host takes to
#: enqueue the timed launches, so the events read device time and not the
#: host's launch rate (which bounds a one-query bag otherwise)
QUEUE_FILL_CYCLES = 20_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_FILL_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed_in_turns(fns: dict, rounds: int = 3) -> dict:
    """Median of ``rounds`` timings each, the functions taking turns."""
    names = list(fns)
    runs = {n: [] for n in names}
    for r in range(rounds):
        order = names if r % 2 == 0 else names[::-1]
        for n in order:
            runs[n].append(cuda_ms(fns[n]))
    return {n: float(np.median(v)) for n, v in runs.items()}


def bound(ids: np.ndarray, w: np.ndarray, D: int, elem_bytes: int) -> dict:
    """Least time the card could take for one embedding bag over these bags.

    The work depends on the data: a slot of weight 0 needs no row. Bytes:
    each distinct table row of a non-zero slot, read once, plus the ids and
    weights of every slot (4 B each) and the f32 output. Operations: one
    f32 multiply-add (2 flops) per non-zero slot and column. Also the time
    of the row bytes the gather of the non-zero slots issues, for reference.
    """
    B, L = ids.shape
    live = w != 0
    nnz = int(live.sum())
    rows = len(np.unique(ids[live]))
    io = 8 * B * L + 4 * B * D
    bytes_ms = (rows * D * elem_bytes + io) / PEAK_BYTES_S * 1e3
    ops_ms = 2 * nnz * D / PEAK_F32_FLOP_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "gather_bytes_ms": (nnz * D * elem_bytes + io) / PEAK_BYTES_S * 1e3,
        "distinct_rows": rows,
        "nonzero_slots": nnz,
        "zero_share": 1 - nnz / max(1, B * L),
    }


def run_twice(name: str, table, ids, w) -> torch.Tensor:
    """The kernel's output; fails unless a second call gives the same bits."""
    out = embedding.embedding_bag(table, ids, w)
    again = embedding.embedding_bag(table, ids, w)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    return out


def max_err(name: str, out, ref, tol: float) -> float:
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output not finite / bad shape")
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    if err > tol:
        raise AssertionError(f"{name}: kernel vs plain max |err| {err} > {tol}")
    return err


def case_row(name, table, ids_np, tol, err) -> dict:
    B, L = ids_np.shape
    V, D = table.shape
    return {
        "case": name, "B": B, "L": L, "V": V, "D": D,
        "dtype": str(table.dtype).replace("torch.", ""),
        "align": embedding._align(table.data_ptr()),
        "plan": embedding._plan_for(table, B, L)._asdict(),
        "max_abs_err": err, "tol": tol,
    }


def plan_sweep(name, table, ids, w, ref, tol) -> None:
    """Kernel time at the plans that other SM residencies would give."""
    B, L = ids.shape
    plans = {k: embedding._plan_for(table, B, L, warps_per_sm=k)
             for k in SWEEP_WARPS_PER_SM}
    for k, plan in plans.items():
        max_err(f"{name}, plan for {k} warps an SM",
                embedding._launch(table, ids, w, plan), ref, tol)
    times = timed_in_turns({
        k: (lambda plan=plan: embedding._launch(table, ids, w, plan))
        for k, plan in plans.items()
    })
    log("  plan sweep: " + json.dumps([
        {"warps_per_sm": k, "warps_per_bag": p.warps_per_bag,
         "bags_per_block": p.bags_per_block, "kernel_ms": times[k]}
        for k, p in plans.items()
    ]))


def check_kernel(name, table, ids_np, w_np, tol) -> dict:
    """Kernel vs plain version on the card, then kernel/plain/library times."""
    dev = table.device
    ids = torch.from_numpy(ids_np).to(dev)
    w = torch.from_numpy(w_np).to(dev)
    out = run_twice(name, table, ids, w)
    ref = embedding.embedding_bag_plain(table, ids, w)
    err = max_err(name, out, ref, tol)
    w_lib = w.to(table.dtype)  # F.embedding_bag wants weights of the table type
    times = timed_in_turns({
        "kernel_ms": lambda: embedding.embedding_bag(table, ids, w),
        "plain_ms": lambda: embedding.embedding_bag_plain(table, ids, w),
        "library_ms": lambda: F.embedding_bag(
            ids, table, per_sample_weights=w_lib, mode="sum"
        ),
    })
    elem = table.element_size()
    row = {
        **case_row(name, table, ids_np, tol, err), **times,
        **bound(ids_np, w_np, table.shape[1], elem),
    }
    # row bytes the kernel read (non-zero slots) per second of its time
    row["gather_tb_s"] = (row["nonzero_slots"] * table.shape[1] * elem
                          / row["kernel_ms"] / 1e9)
    log(f"  {json.dumps(row)}")
    log(f"  recorded, not measured in this run: the previous design's "
        f"kernel_ms {PREV_KERNEL_MS[name]} (commit 1f8eded, NVIDIA H100 "
        f"80GB HBM3 at 700 W)")
    if len(ids_np) > 1:
        plan_sweep(name, table, ids, w, ref, tol)
    return row


def check_edge(name, table, ids_np, w_np, tol) -> dict:
    """Kernel vs plain version at a shape the plan treats apart (untimed)."""
    dev = table.device
    ids = torch.from_numpy(ids_np).to(dev)
    w = torch.from_numpy(w_np).to(dev)
    before = embedding.KERNEL_LAUNCHES
    out = run_twice(name, table, ids, w)
    if len(ids_np) and embedding.KERNEL_LAUNCHES != before + 2:
        raise AssertionError(f"{name}: the wrapper did not launch the kernel")
    err = max_err(name, out, embedding.embedding_bag_plain(table, ids, w), tol)
    zero_bags = torch.from_numpy(~w_np.any(axis=1)).to(dev)
    if out[zero_bags].any():
        raise AssertionError(f"{name}: a bag of weight-0 slots is not 0")
    row = case_row(name, table, ids_np, tol, err)
    log(f"  {json.dumps(row)}")
    return row


def random_bags(rng, B, L, V):
    """Uniform ids in [0, V) and L2-normalized positive weights, every slot
    used — the heaviest bag a TF-IDF query of width L can give."""
    ids = rng.integers(0, V, size=(B, L), dtype=np.int32)
    w = rng.random((B, L), dtype=np.float32) + 0.01
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return ids, w.astype(np.float32)


def phase_kernels(rng, dev) -> list:
    log("phase 3: kernel vs plain version on the card")
    rows = []
    table = torch.from_numpy(
        rng.standard_normal((MAX_FEATURES + 1, HIDDEN), dtype=np.float32)
    ).to(dev)
    ids, w = random_bags(rng, N_QUERIES, BAG_WIDTH, MAX_FEATURES + 1)
    rows.append(check_kernel("serving f32", table, ids, w, TOL[torch.float32]))
    rows.append(check_kernel(
        "serving bf16", table.to(torch.bfloat16), ids, w, TOL[torch.bfloat16]
    ))
    rows.append(check_kernel(
        "one query f32", table, ids[:1].copy(), w[:1].copy(), TOL[torch.float32]
    ))
    query = torch.from_numpy(ids[:1].copy()).to(dev)
    zeros = torch.zeros(query.shape, device=dev)
    # where one bag's time goes: the same launch with every weight 0 reads
    # ids and weights but no row; an empty kernel is the launch alone
    log("  one query, without its rows: " + json.dumps(timed_in_turns({
        "zero_weights_ms": lambda: embedding.embedding_bag(table, query, zeros),
        "empty_kernel_ms": lambda: torch.cuda._sleep(1),
    })))
    del table
    wide = torch.from_numpy(
        rng.standard_normal((50000, 256), dtype=np.float32)
    ).to(dev)
    ids, w = random_bags(rng, 4096, 64, 50000)
    rows.append(check_kernel("wide f32", wide, ids, w, TOL[torch.float32]))
    del wide
    log("  edge shapes")
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, L, D, view) in EDGE_SHAPES.items():
            full = torch.from_numpy(
                rng.standard_normal((1001, D), dtype=np.float32)
            ).to(dev, dtype)
            # view "row 1 on": a contiguous table whose pointer is off by a row
            table = full[1:] if view else full[:1000]
            ids, w = random_bags(rng, B, L, 1000)
            if name == "zero-weight bag":
                w[1] = 0.0
            check_edge(f"{name} {str(dtype)[6:]}", table, ids, w, TOL[dtype])
    return rows


def _word(i: int) -> str:
    """Distinct 4-letter token for each i < 26**4."""
    s = ""
    for _ in range(4):
        i, r = divmod(i, 26)
        s += chr(ord("a") + r)
    return s


def synth_corpus(rng, n_docs: int, n_words: int, coverage: bool):
    """Documents of Zipf-distributed 4-letter words, label-dependent.

    With ``coverage`` every one of the ``n_words`` words appears in some
    document, so the fitted vocabulary is capped by ``max_features``.
    """
    words = np.array([_word(i) for i in range(n_words)])
    labels = [LABELS[k % len(LABELS)] for k in range(n_docs)]
    extra = np.array_split(rng.permutation(n_words), n_docs) if coverage else None
    docs = []
    for k in range(n_docs):
        # post lengths vary widely; the longest exceed the bag width
        n_tokens = int(rng.integers(100, 1200))
        ranks = np.minimum(rng.zipf(1.1, size=n_tokens) - 1, n_words - 1)
        idx = (ranks + 3001 * (k % len(LABELS))) % n_words
        if extra is not None:
            idx = np.concatenate([idx, extra[k]])
        docs.append(" ".join(words[idx]))
    return docs, labels


def phase_model(args):
    log("phase 4: full-width model from a synthetic 20-label corpus")
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    docs, _ = synth_corpus(rng, 1200, 70000, coverage=True)
    vec = TfIdfVectorizer.fit(docs, max_features=MAX_FEATURES)
    V = vec.n_features
    if V != MAX_FEATURES + 1:
        raise AssertionError(f"vocabulary gives V={V}, want {MAX_FEATURES + 1}")
    queries, _ = synth_corpus(rng, N_QUERIES, 70000, coverage=False)
    g = ComputeContext.local(args.seed, device="cpu").generator()
    C = len(LABELS)
    arrays = {
        "w_in": torch.randn(V, HIDDEN, generator=g).numpy(),
        "b_in": (0.1 * torch.randn(HIDDEN, generator=g)).numpy(),
        "w_out": (torch.randn(HIDDEN, C, generator=g) / HIDDEN ** 0.5).numpy(),
        "b_out": (0.1 * torch.randn(C, generator=g)).numpy(),
        "vocab": vec.vocab, "idf": vec.idf, "labels": sorted(LABELS),
        "bag_width": BAG_WIDTH, "token_cap": BAG_WIDTH,
    }
    gpu = text_mlp_from_reference(arrays)
    cpu = text_mlp_from_reference(arrays, device="cpu")
    lens = [len(vec.transform_doc(q)[0]) for q in queries]
    log(f"  V={V} H={HIDDEN} C={C} L={BAG_WIDTH}; query bags: "
        f"{min(lens)}..{max(lens)} tokens (median {int(np.median(lens))}), "
        f"{sum(n > BAG_WIDTH for n in lens)} truncated; "
        f"{time.perf_counter() - t0:.1f} s")
    return gpu, cpu, queries


def same_answer(got: dict, want, where: str) -> None:
    if got["label"] != want.label or abs(got["confidence"] - want.confidence) > CONF_TOL:
        raise AssertionError(f"{where}: got {got}, CPU plain copy {want.to_dict()}")


def post(conn: http.client.HTTPConnection, body: bytes):
    """``POST /queries.json`` on ``conn`` → (status, decoded JSON answer)."""
    conn.request("POST", "/queries.json", body,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def phase_http(gpu, cpu, queries) -> tuple:
    log(f"phase 5: {N_HTTP} POST /queries.json through the query server")
    engine = get_engine_factory("templates.textclassification")()
    ep = EngineParams(algorithm_params_list=(("mlp", MLPParams()),))
    algo = MLPAlgorithm()
    embedding.KERNEL_LAUNCHES = 0
    server = create_query_server(engine, ep, [gpu], host="127.0.0.1", port=0)
    with server:
        # one keep-alive connection, as a client that sends many queries has
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        ms, answers = [], []
        for k, text in enumerate(queries[:N_HTTP]):
            t0 = time.perf_counter()
            status, got = post(conn, json.dumps({"text": text}).encode())
            ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"query {k}: HTTP {status} {got}")
            answers.append(got)
        launches = embedding.KERNEL_LAUNCHES
        status, _ = post(conn, b"{not json")
        conn.close()
        if status != 400:
            raise AssertionError(f"malformed JSON got HTTP {status}, want 400")
    # checked after the timed requests: the CPU copy's torch threads would
    # otherwise compete with the server thread for the host's cores
    for k, (text, got) in enumerate(zip(queries, answers)):
        same_answer(got, algo.predict(cpu, Query(text=text)), f"query {k}")
    # the same queries in process, host clock: featurization alone, and
    # predict (featurization + model on the card + host softmax)
    texts = queries[:N_HTTP]
    feat_ms = [host_ms(lambda t=t: _query_bag(
        gpu.vectorizer, t, gpu.bag_width, gpu.token_cap)) for t in texts]
    pred_ms = [host_ms(lambda t=t: algo.predict(gpu, Query(text=t)))
               for t in texts]
    log(f"  {N_HTTP} answers match the CPU copy; kernel launches {launches}")
    log(f"  host clock, ms per query: request {rounded(ms)}; predict in "
        f"process {rounded(pred_ms)}; featurization alone {rounded(feat_ms)}")
    if launches < N_HTTP:
        raise AssertionError(f"served path launched the kernel {launches} times")
    return launches, answers


def host_ms(fn) -> float:
    """Host-clock ms of one call of ``fn``, the card drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def rounded(xs) -> list:
    return [round(x, 3) for x in xs]


def phase_batch(gpu, cpu, queries):
    log(f"phase 6: batch_predict over {N_QUERIES} queries vs the predict loop")
    algo = MLPAlgorithm()
    qs = [(i, Query(text=t)) for i, t in enumerate(queries)]
    embedding.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    batch = dict(algo.batch_predict(gpu, qs))
    batch_ms = (time.perf_counter() - t0) * 1e3
    loop = {i: algo.predict(gpu, q) for i, q in qs}
    launches = embedding.KERNEL_LAUNCHES
    ref = dict(algo.batch_predict(cpu, qs))
    for i, _ in qs:
        same_answer(batch[i].to_dict(), loop[i], f"batch vs loop, query {i}")
        same_answer(batch[i].to_dict(), ref[i], f"batch vs CPU copy, query {i}")
    log(f"  {N_QUERIES} batch answers equal the loop and the CPU copy; "
        f"batch_predict {batch_ms:.1f} ms (host clock); kernel launches "
        f"{launches}")
    if launches < 1 + N_QUERIES:
        raise AssertionError(f"batch + loop launched the kernel {launches} times")
    return launches, qs


def use_memory_storage() -> None:
    """Point the port's three storage repositories at this process's memory:
    nothing is written around the checkout."""
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        os.environ[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "MEM"
    os.environ["PIO_STORAGE_SOURCES_MEM_TYPE"] = "memory"


def reset_counts() -> None:
    for attr in COUNTERS.values():
        setattr(embedding, attr, 0)


def read_counts() -> dict:
    return {name: getattr(embedding, attr) for name, attr in COUNTERS.items()}


def bound_of(n_bytes: int, flops: int) -> dict:
    """The larger of bytes over the HBM rate and f32 flops over the f32 peak."""
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = flops / PEAK_F32_FLOP_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def scatter_bound(ids: np.ndarray, w: np.ndarray, D: int, n_rows: int,
                  out_bytes: int) -> dict:
    """d_table: every slot's id and weight read once (8 B), each g row once
    (f32), every row of d_table written once; one f32 multiply-add per
    non-zero slot and column (a weight-0 slot adds nothing)."""
    B, L = ids.shape
    nnz = int((w != 0).sum())
    return bound_of(8 * B * L + 4 * B * D + n_rows * D * out_bytes, 2 * nnz * D)


def scatter_gathered_bytes(geo, B: int, D: int, n_cells: int, n_rows: int,
                           out_bytes: int) -> int:
    """Bytes kernel A's tiling moves through L2: each of a slice's blocks
    stages the slice of all B g rows once; every column slice reads the 8-
    byte records of all cells and each row's place and length again; the
    record build reads each cell's slot and a scattered 32-byte sector of
    the weights and writes the record; a row's f32 sums go out and back
    between passes; d_table is written once."""
    g_staged = geo.grid_x * B * D * 4
    records = geo.grid_y * (8 * n_cells + 8 * n_rows)
    build = n_cells * (4 + 32 + 8)
    partials = 2 * (geo.passes(B) - 1) * n_rows * D * 4
    return g_staged + records + build + partials + n_rows * D * out_bytes


def slots_a_row(plan) -> dict:
    """Non-zero slots and how many land on each row: mean, p99, max."""
    per_row = plan.offsets.diff().cpu().numpy()
    return {"nnz": int(plan.order.numel()), "slots_a_row_mean": float(per_row.mean()),
            "slots_a_row_p99": float(np.percentile(per_row, 99)),
            "slots_a_row_max": int(per_row.max())}


def dot_gathered_bytes(B: int, L: int, D: int, elem_bytes: int, g_rows: int) -> int:
    """Bytes kernel B moves through L2: a table row for every slot, weight
    0 or not; the ids and d_w once; ``g_rows`` rows of g."""
    return B * L * (D * elem_bytes + 8) + g_rows * D * 4


def dot_g_rows(geo, B: int, L: int, D: int) -> int:
    """Rows of g kernel B reads: one a warp where one pass of its lanes
    covers a row, else one a round of slots (each pass its slice)."""
    if D <= geo.group_lanes * geo.epl:
        return geo.warps(B, L)
    per_round = 32 // geo.group_lanes * min(geo.group_lanes, embedding._DOT_PARTIALS)
    return B * -(-L // per_round)


def dot_bound(ids: np.ndarray, D: int, elem_bytes: int) -> dict:
    """d_w: ids, each g row and each distinct table row of any slot (weight
    0 or not) read once, d_w written once; one multiply-add per slot and
    column."""
    B, L = ids.shape
    rows = len(np.unique(ids))
    return bound_of(8 * B * L + 4 * B * D + rows * D * elem_bytes, 2 * B * L * D)


def launched_twice(name: str, run, counter: str, launches: bool) -> torch.Tensor:
    """``run()`` twice: the same bits, and the wrapper's counter up by 2
    where it launches the kernel."""
    before = getattr(embedding, counter)
    out, again = run(), run()
    torch.cuda.synchronize()
    if launches and getattr(embedding, counter) != before + 2:
        raise AssertionError(f"{name}: the wrapper did not launch its kernel")
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    return out


def scatter_reference(g, ids, w, n_rows) -> torch.Tensor:
    """Kernel A's reference: the plain version run on the CPU from the same
    inputs, f32 (``index_add_`` there adds in slot order; on the card its
    atomics add in an order that changes from run to run, by up to 7.6e-5
    at every slot on one row, ``scripts/torch_bag_scatter_spread.py``).
    A column's sum does not depend on the others, so a narrower ``g`` of
    the same rows reads its columns off the full one."""
    return embedding.embedding_bag_backward_table_plain(
        g.cpu(), ids.cpu(), w.cpu(), n_rows)


def check_scatter(name, g, ids, w, n_rows, dtype, ref=None) -> dict:
    """Bag scatter vs its plain version (``ref``, :func:`scatter_reference`
    of the same inputs where the caller has it); then kernel/plain/library
    times."""
    B, L = ids.shape
    D = g.shape[1]
    plan = embedding.bag_plan(ids, w, n_rows)

    def run():
        return embedding.embedding_bag_backward_table(g, ids, w, n_rows, dtype, plan=plan)

    def plain():
        return embedding.embedding_bag_backward_table_plain(g, ids, w, n_rows, dtype)

    # the plain version sums in f32 and casts to dtype
    if ref is None:
        ref = scatter_reference(g, ids, w, n_rows)
    ref = ref.to(dtype).float()
    tol = BWD_TOL
    if dtype == torch.bfloat16 and ref.numel():
        tol = BF16_STEP * float(ref.abs().max())
    out = launched_twice(name, run, "BACKWARD_TABLE_LAUNCHES", n_rows * D > 0)
    row = {"case": name, "B": B, "L": L, "rows": n_rows, "D": D,
           "dtype": str(dtype)[6:],
           "max_abs_err": max_err(name, out.float().cpu(), ref, tol), "tol": tol,
           **slots_a_row(plan)}
    if n_rows * D:
        geo = embedding._scatter_geometry(g, n_rows, dtype)
        row["geometry"] = geo._asdict()
        row["gathered_bytes"] = scatter_gathered_bytes(
            geo, B, D, plan.n_cells, n_rows, out.element_size())
    fns = {"kernel_ms": run, "plain_ms": plain}
    if B * L:  # the library takes no empty batch of bags
        table = torch.zeros((n_rows, D), dtype=dtype, device=g.device,
                            requires_grad=True)
        lib_out = F.embedding_bag(ids, table, per_sample_weights=w.to(dtype),
                                  mode="sum")
        g_lib = g.to(dtype)
        fns["library_ms"] = lambda: torch.autograd.grad(
            lib_out, [table], g_lib, retain_graph=True)
    row.update({"library_ms": None, **timed_in_turns(fns)})
    row["plan_ms"] = float(np.median([
        host_ms(lambda: embedding.bag_plan(ids, w, n_rows)) for _ in range(3)
    ]))
    row.update(scatter_bound(ids.cpu().numpy(), w.cpu().numpy(), D, n_rows,
                             out.element_size()))
    if "gathered_bytes" in row:
        # the design's bytes through L2, and the bound's, per second of
        # kernel time
        row["gathered_tb_s"] = row["gathered_bytes"] / row["kernel_ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    log(f"  scatter {json.dumps(row)}")
    if name in PREV_SCATTER_MS:
        log(f"  recorded, not measured in this run: kernel A's first design "
            f"{name} kernel_ms {PREV_SCATTER_MS[name]} (commit 9818f09, "
            f"NVIDIA H100 80GB HBM3 at 700 W)")
    return row


def scatter_d_sweep(g, ids, w, n_rows, ref) -> dict:
    """Kernel A over the same slots at each width of SWEEP_D (the first
    columns of ``g``), f32, in turns: device ms by D, each held to the
    columns of ``ref`` (:func:`scatter_reference` of the full ``g``)."""
    plan = embedding.bag_plan(ids, w, n_rows)
    gs = {D: g[:, :D].contiguous() for D in SWEEP_D}
    for D, gD in gs.items():
        max_err(f"D sweep, D = {D}",
                embedding.embedding_bag_backward_table(
                    gD, ids, w, n_rows, plan=plan).cpu(),
                ref[:, :D], BWD_TOL)
    times = timed_in_turns({D: (lambda gD=gD: embedding.embedding_bag_backward_table(
        gD, ids, w, n_rows, plan=plan)) for D, gD in gs.items()})
    return {"kernel_ms_by_D": times,
            "ms_128_over_32": times[SWEEP_D[-1]] / times[SWEEP_D[0]]}


def check_dot(name, g, table, ids, w) -> dict:
    """Bag dot vs its plain version; then kernel/plain/library times."""
    B, L = ids.shape
    D = table.shape[1]

    def run():
        return embedding.embedding_bag_backward_weights(g, table, ids)

    def plain():
        return embedding.embedding_bag_backward_weights_plain(g, table, ids)

    tol = BWD_TOL * D ** 0.5
    out = launched_twice(name, run, "BACKWARD_WEIGHTS_LAUNCHES", B * L * D > 0)
    row = {"case": name, "B": B, "L": L, "V": table.shape[0], "D": D,
           "dtype": str(table.dtype)[6:],
           "max_abs_err": max_err(name, out, plain(), tol), "tol": tol}
    zero = ~(w != 0)
    if bool(zero.any()) and B * L * D and not bool(out[zero].ne(0).any()):
        raise AssertionError(f"{name}: every weight-0 slot got d_w = 0")
    if B * L * D:
        geo = embedding._dot_geometry(g, table, L)
        row["geometry"] = geo._asdict()
        row["gathered_bytes"] = dot_gathered_bytes(
            B, L, D, table.element_size(), dot_g_rows(geo, B, L, D))
    fns = {"kernel_ms": run, "plain_ms": plain}
    # PyTorch's CUDA backward of per-sample weights has no bf16 version,
    # and the library takes no empty batch of bags
    if table.dtype == torch.float32 and B * L:
        w_lib = w.clone().requires_grad_(True)
        lib_out = F.embedding_bag(ids, table, per_sample_weights=w_lib,
                                  mode="sum")
        fns["library_ms"] = lambda: torch.autograd.grad(
            lib_out, [w_lib], g, retain_graph=True)
    row.update({"library_ms": None, **timed_in_turns(fns)})
    row.update(dot_bound(ids.cpu().numpy(), D, table.element_size()))
    if "gathered_bytes" in row:
        row["gathered_tb_s"] = row["gathered_bytes"] / row["kernel_ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    log(f"  dot {json.dumps(row)}")
    if name in PREV_DOT_MS:
        log(f"  recorded, not measured in this run: kernel B's first design "
            f"{name} kernel_ms {PREV_DOT_MS[name]} (commit 9818f09, "
            f"NVIDIA H100 80GB HBM3 at 700 W)")
    return row


def dot_d_sweep(g, table, ids) -> dict:
    """Kernel B over the same slots at each width of SWEEP_D (the first
    columns of ``g`` and the table), in turns: device ms by D."""
    cols = {D: (g[:, :D].contiguous(), table[:, :D].contiguous()) for D in SWEEP_D}
    for D, (gD, tD) in cols.items():
        max_err(f"kernel B D sweep, D = {D}",
                embedding.embedding_bag_backward_weights(gD, tD, ids),
                embedding.embedding_bag_backward_weights_plain(gD, tD, ids),
                BWD_TOL * D ** 0.5)
    times = timed_in_turns({D: (lambda gD=gD, tD=tD: embedding.embedding_bag_backward_weights(
        gD, tD, ids)) for D, (gD, tD) in cols.items()})
    return {"kernel_ms_by_D": times,
            "ms_128_over_32": times[SWEEP_D[-1]] / times[SWEEP_D[0]]}


def card_tensors(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def phase_backward(rng, dev) -> dict:
    """Phase 8: both backward kernels at the training, NB and edge shapes."""
    log("phase 8: backward kernels vs their plain versions on the card")
    V, D, B, L = MAX_FEATURES + 1, HIDDEN, N_DOCS, BAG_WIDTH
    ids_np, w_np = random_bags(rng, B, L, V)
    w_np[:, -16:] = 0.0  # padding, as short documents leave it
    g_np = rng.standard_normal((B, D), dtype=np.float32)
    ids, w, g = card_tensors(dev, ids_np, w_np, g_np)
    table = torch.from_numpy(rng.standard_normal((V, D), dtype=np.float32)).to(dev)
    ref = scatter_reference(g, ids, w, V)
    scatter = [check_scatter("training f32", g, ids, w, V, torch.float32, ref),
               check_scatter("training bf16", g, ids, w, V, torch.bfloat16,
                             ref)]
    log("  kernel A, D sweep over the training slots (ms in proportion to D: "
        "bound by bytes; flat: bound by latency): "
        + json.dumps(scatter_d_sweep(g, ids, w, V, ref)))
    log(f"  recorded, not measured in this run: kernel A's first design, D "
        f"sweep kernel_ms_by_D {json.dumps(PREV_D_SWEEP_MS)} (commit 9818f09, "
        f"NVIDIA H100 80GB HBM3 at 700 W)")
    dot = [check_dot("training f32", g, table, ids, w),
           check_dot("training bf16", g, table.to(torch.bfloat16), ids, w)]
    log("  kernel B, D sweep over the training slots: "
        + json.dumps(dot_d_sweep(g, table, ids)))
    C = len(LABELS)
    y = rng.integers(0, C, size=B)
    keys = torch.from_numpy((y[:, None] * V + ids_np).astype(np.int32)).to(dev)
    ones = torch.ones((B, 1), device=dev)
    scatter.append(check_scatter("nb feature sums", ones, keys, w, C * V,
                                 torch.float32))
    log("  edge shapes")
    for dtype in (torch.float32, torch.bfloat16):
        for name, spec in BWD_EDGE_SHAPES.items():
            e_g, tab, e_ids, e_w = bwd_edge_case(rng, dev, dtype, *spec)
            label = f"{name} {str(dtype)[6:]}"
            check_scatter(label, e_g, e_ids, e_w, 1000, dtype)
            check_dot(label, e_g, tab, e_ids, e_w)
    autograd = phase_autograd(table, ids, w, g)
    return {"scatter": scatter, "dot": dot, "autograd": autograd}


def bwd_edge_case(rng, dev, dtype, B, L, D, view, pattern):
    """(g, table, ids, weights) on the card for one of BWD_EDGE_SHAPES: a
    [1000, D] table of ``dtype``, random bags over it."""
    full = torch.from_numpy(
        rng.standard_normal((1001, D), dtype=np.float32)).to(dev, dtype)
    table = full[1:] if view else full[:1000]
    ids, w = random_bags(rng, B, L, 1000)
    if pattern == "zero-bag":
        w[1] = 0.0
    if pattern == "one-row":
        ids[:] = 7
    gfull = torch.from_numpy(rng.standard_normal((B + 1, D), dtype=np.float32)).to(dev)
    return (gfull[1:] if view else gfull[:B], table, *card_tensors(dev, ids, w))


def phase_autograd(table, ids, w, g) -> dict:
    """Both gradients through the port's differentiable ``embedding_bag``, as
    a caller that learns its bag weights as well as the table asks for them;
    held against the library's autograd of ``F.embedding_bag``."""
    log("  both gradients through autograd of the port's embedding_bag")
    t = table.detach().clone().requires_grad_(True)
    ww = w.detach().clone().requires_grad_(True)
    reset_counts()
    out = embedding.embedding_bag(t, ids, ww)
    d_t, d_w = torch.autograd.grad(out, [t, ww], g)
    torch.cuda.synchronize()
    launches = read_counts()
    tl = table.detach().clone().requires_grad_(True)
    wl = w.detach().clone().requires_grad_(True)
    lib = F.embedding_bag(ids, tl, per_sample_weights=wl, mode="sum")
    ref_t, ref_w = torch.autograd.grad(lib, [tl, wl], g)
    errs = {"d_table": max_err("autograd d_table", d_t, ref_t, BWD_TOL),
            "d_w": max_err("autograd d_w", d_w, ref_w, BWD_TOL * table.shape[1] ** 0.5)}
    log(f"  launches {launches}; max |err| vs F.embedding_bag's autograd {errs}")
    if min(launches.values()) != 1:
        raise AssertionError(f"autograd launched {launches}, want each kernel once")
    return launches


def phase_train(args, dev):
    """Phase 9: ingest, run_train of mlp and nb, one step split into parts,
    and 5 steps of kernels vs plain versions."""
    log(f"phase 9: run_train of mlp and nb on {N_DOCS} synthetic documents")
    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    docs, labels = synth_corpus(rng, N_DOCS, N_WORDS, coverage=True)
    app_id = Storage.get_meta_data_apps().insert(App(0, APP))
    Storage.get_levents().write((
        Event("$set", "content", f"doc{k}", properties={"text": t, "label": lab})
        for k, (t, lab) in enumerate(zip(docs, labels))
    ), app_id)
    log(f"  corpus made and ingested in {time.perf_counter() - t0:.1f} s")
    variant = variant_from_dict({
        "id": "chip-smoke", "engineFactory": "templates.textclassification",
        "datasource": {"params": {"app_name": APP}},
        "algorithms": [{"name": "mlp", "params": {}}, {"name": "nb", "params": {}}],
    })
    engine, ep = build_engine(variant)
    ctx = ComputeContext.create(args.seed)
    reset_counts()
    t0 = time.perf_counter()
    iid = run_train(engine, ep, variant, ctx=ctx)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    env = Storage.get_meta_data_engine_instances().get(iid).env
    log(f"  run_train {train_s:.1f} s (host clock); phases {json.dumps(env)}")
    log(f"  launches {launches}")
    iterations = ep.algorithm_params_list[0][1].iterations
    if launches["embedding_bag"] < iterations or \
            launches["embedding_bag_backward_table"] < iterations + 1:
        raise AssertionError(f"training launched {launches}")

    # the same prepared bags again, for the parts of one step
    td = engine.data_source_class(ep.data_source_params).read_training(ctx)
    pd = engine.preparator_class(ep.preparator_params).prepare(ctx, td)
    bags = card_tensors(dev, pd.ids, pd.weights, pd.label_codes.astype(np.int64))
    V, C = pd.vectorizer.n_features, len(pd.label_index)
    if (V, C, pd.ids.shape[1]) != (MAX_FEATURES + 1, len(LABELS), BAG_WIDTH):
        raise AssertionError(f"prepared V={V}, C={C}, L={pd.ids.shape[1]}")
    t0 = time.perf_counter()
    mlp.train_mlp(ctx, pd.ids, pd.weights, pd.label_codes, V, C)
    torch.cuda.synchronize()
    log(f"  train_mlp again, warm: {time.perf_counter() - t0:.3f} s for "
        f"{iterations} steps (host clock; bags copied in, plan built)")
    params0 = mlp.init_params(V, HIDDEN, C, ctx.generator(0))
    step = step_parts(params0, *bags)
    mask = torch.ones(len(pd.label_codes), device=dev)
    with torch.no_grad():
        loss0 = float(mlp._loss(params0, *bags[:2], bags[2], mask, 0.0))
    log(f"  loss before the first step {loss0}")
    compare_steps(params0, *bags, mask)
    # kernel A on the main path's own bags, against its plain version
    g = torch.from_numpy(np.random.default_rng(args.seed + 3).standard_normal(
        (len(pd.ids), HIDDEN), dtype=np.float32)).to(dev)
    main_bags = check_scatter("main path bags f32", g, *bags[:2], V, torch.float32)
    # kernel B on the same bags, every slot (padding too), over a table
    # made from the seed
    table = torch.from_numpy(np.random.default_rng(args.seed + 4).standard_normal(
        (V, HIDDEN), dtype=np.float32)).to(dev)
    main_dot = check_dot("main path bags f32", g, table, *bags[:2])
    return engine, ep, iid, pd, loss0, launches, step, main_bags, main_dot


def step_parts(params0, ids, w, y, steps: int = 10, warmup: int = 3) -> dict:
    """Device ms of one full-batch Adam step, split: the forward kernel, the
    head (relu, matmul, cross-entropy and their backward), the bag scatter
    (d_w_in), and Adam. CUDA events, median over ``steps`` steps; then the
    card's own kernel time in 3 more steps (``torch.profiler``)."""
    V = params0["w_in"].shape[0]
    mask = torch.ones(len(y), device=y.device)
    plan = embedding.bag_plan(ids, w, V)
    params = {k: v.clone().requires_grad_(True) for k, v in params0.items()}
    opt = torch.optim.Adam(params.values(), lr=mlp.MLPConfig().learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    head = ["b_in", "w_out", "b_out"]
    names = ["forward_kernel_ms", "head_ms", "backward_kernel_ms", "adam_ms"]

    def one_step(ev):
        ev[0].record()
        with torch.no_grad():
            h = embedding.embedding_bag(params["w_in"], ids, w)
        ev[1].record()
        h.requires_grad_(True)
        loss = mlp._loss(params, ids, w, y, mask, 0.0, bag=lambda *_: h)
        grads = torch.autograd.grad(loss, [h] + [params[k] for k in head])
        ev[2].record()
        params["w_in"].grad = embedding.embedding_bag_backward_table(
            grads[0].contiguous(), ids, w, V, plan=plan)
        ev[3].record()
        for k, gk in zip(head, grads[1:]):
            params[k].grad = gk
        opt.step()
        ev[4].record()

    times = {n: [] for n in names}
    for s in range(warmup + steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        one_step(ev)
        torch.cuda.synchronize()
        if s >= warmup:
            for i, n in enumerate(names):
                times[n].append(ev[i].elapsed_time(ev[i + 1]))
    parts = {n: float(np.median(v)) for n, v in times.items()}
    parts["step_ms"] = sum(parts.values())
    parts["plan_ms"] = float(np.median([
        host_ms(lambda: embedding.bag_plan(ids, w, V)) for _ in range(3)]))
    # the card's own kernel time in the same steps: the span less this is
    # time the card waited for the host
    n_profiled = 3
    _, prof = guarded(lambda: [
        one_step([torch.cuda.Event(enable_timing=True) for _ in range(5)])
        for _ in range(n_profiled)], retry=True)
    # every row with device time but the sentinels: copies and user
    # annotations count in a step's device-busy time
    kernels = sorted(
        ((e.key, e.self_device_time_total / n_profiled / 1e3)
         for e in _window_rows(prof)),
        key=lambda kv: -kv[1])
    parts["device_busy_ms"] = sum(ms for _, ms in kernels)
    log("  device ms a step by kernel (torch.profiler): " + json.dumps(
        [[name[:80], ms] for name, ms in kernels[:12]]))
    log(f"  one step, device ms: {json.dumps(parts)}")
    return parts


def compare_steps(params0, ids, w, y, mask) -> float:
    """COMPARE_STEPS Adam steps through the kernels and through the plain
    versions (autograd of embedding_bag_plain) from the same parameters."""
    cfg = mlp.MLPConfig(iterations=COMPARE_STEPS)
    kern, kern_loss = mlp._fit(params0, ids, w, y, mask, cfg)
    plain, plain_loss = mlp._fit(
        params0, ids, w, y, mask, cfg,
        bag=lambda t, i, ww, plan: embedding.embedding_bag_plain(t, i, ww))
    diff = max(float((kern[k] - plain[k]).abs().max()) for k in kern)
    log(f"  {COMPARE_STEPS} steps, kernels vs plain versions: largest parameter "
        f"difference {diff} (limit {TRAIN_TOL}); losses {kern_loss.tolist()} vs "
        f"{plain_loss.tolist()}")
    if not diff <= TRAIN_TOL:
        raise AssertionError(f"training through the kernels is {diff} off the plain path")
    return diff


def phase_serve_trained(args, engine, ep, iid, pd, loss0) -> int:
    """Phase 10: load the persisted models and serve them."""
    log("phase 10: load_models_for_instance and serve the trained models")
    ctx = ComputeContext.local(args.seed)
    gpu = load_models_for_instance(iid, engine, ep, ctx)
    cpu = load_models_for_instance(iid, engine, ep,
                                   ComputeContext.local(args.seed, device="cpu"))
    model = gpu[0].mlp
    ids, w, y = card_tensors(model.w_in.device, pd.ids, pd.weights,
                             pd.label_codes.astype(np.int64))
    with torch.no_grad():
        params = dict(model.named_buffers())
        loss = float(mlp._loss(params, ids, w, y, torch.ones(len(y), device=y.device), 0.0))
        acc = float((model(ids, w).argmax(1) == y).float().mean())
    log(f"  training set: loss {loss0} before the first step, {loss} after the "
        f"last; accuracy {acc}")
    if not loss < loss0:
        raise AssertionError("training did not lower the loss")
    nb_plain = train_multinomial_nb_bags(
        pd.ids, pd.weights, pd.label_codes, pd.vectorizer.n_features,
        len(pd.label_index), device="cpu")
    nb_err = float(np.abs(gpu[1].nb.log_theta - nb_plain.log_theta).max())
    log(f"  NB log theta, card vs plain version on the CPU: max |err| {nb_err}")
    if not nb_err <= NB_TOL:
        raise AssertionError(f"NB trained on the card is {nb_err} off the plain version")

    rng = np.random.default_rng(args.seed + 2)
    texts, labels = synth_corpus(rng, N_HTTP, N_WORDS, coverage=False)
    serving = engine.make_serving(ep)
    pairs = engine.algorithms_with_models(ep, cpu)
    reset_counts()
    server = create_query_server(engine, ep, gpu, host="127.0.0.1", port=0)
    with server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        answers = []
        for k, text in enumerate(texts):
            status, got = post(conn, json.dumps({"text": text}).encode())
            if status != 200:
                raise AssertionError(f"trained query {k}: HTTP {status} {got}")
            answers.append(got)
        conn.close()
    launches = read_counts()["embedding_bag"]
    for k, (text, got) in enumerate(zip(texts, answers)):
        q = Query(text=text)
        same_answer(got, serving.serve(q, [a.predict(m, q) for a, m in pairs]),
                    f"trained query {k}")
    right = sum(a["label"] == lab for a, lab in zip(answers, labels))
    log(f"  {N_HTTP} answers match the CPU copy of the blob; {right} of "
        f"{N_HTTP} held-out labels right; kernel launches {launches}")
    if launches < N_HTTP:
        raise AssertionError(f"trained serving launched the kernel {launches} times")
    return launches


# ------------------------------------------------ the recommendation path
# MovieLens-25M's shape (ratings, users, movies), as bench.py defines it
ML25M_EDGES, ML25M_USERS, ML25M_ITEMS = 25_000_000, 162_541, 59_047
# MovieLens-100K's shape (the GroupLens ML-100K README): 943 users, 1682
# items, 100,000 ratings of 1-5 stars
ML100K_EDGES, ML100K_USERS, ML100K_ITEMS = 100_000, 943, 1682
# the README quickstart's engine.json: rank 16, 10 iterations, lambda 0.1
ALS_PARAMS = {"rank": 16, "num_iterations": 10, "lambda_": 0.1}
# card vs CPU, train_als at the ML-100K shape: the same f32 math in another
# summation order. On the CPU, changing only the block grouping
# (blocks_per_chunk 4096 vs 64 vs 8) moves the factors by at most 5.3e-5
# (|factors| up to 5.2, i.e. 1e-5 of the largest) and the train RMSE by
# less than 1e-7; ten times that spread:
ALS_FACTOR_TOL = 1e-4  # of max |factor|
ALS_RMSE_TOL = 1e-5  # relative
# a served score vs the CPU copy's: a rank-16 f32 dot of O(1) values in
# another order (~1e-6 of scores of O(5)); two orders of magnitude over it
SCORE_TOL = 1e-4
# the normal equations at ML-100K's shape, card vs CPU: f32 sums of up to
# a few thousand O(1) products (A entries up to ~1e4): relative 1e-5
NORMAL_EQ_RTOL = 1e-5
# the same with bf16 products and implicit weights: the card rounds each
# weighted row to bf16 (cuBLAS takes bf16 operands), the CPU keeps it f32,
# so each product may move by 2^-9 of itself, and a sum of positive terms
# by as much; one bf16 step, 2^-8, as the limit
BF16_ROW_RTOL = 2.0 ** -8
N_REC_HTTP = 8
N_REC_BATCH = 1024
REC_APP = "movielens-100k-synthetic"
#: the card the recommendation phases run on
CARD = torch.device("cuda")
#: the rank of phase 11's memory check: a large rank, one iteration
WIDE_RANK = 128


@contextlib.contextmanager
def knob(name: str, value: str):
    """The environment knob ``name`` set to ``value`` inside the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def serve_device(value: str):
    """``PIO_TPU_SERVE_DEVICE`` set to ``value`` inside the block."""
    return knob("PIO_TPU_SERVE_DEVICE", value)


def synth_ratings(n_edges: int, n_users: int, n_items: int, seed: int,
                  stars: str):
    """A copy of bench.py's _synth_ratings: uniform users, squared-uniform
    (popularity-skewed) items; half stars 0.5-5.0, or integer stars 1-5."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, size=n_edges).astype(np.int32)
    i = (rng.random(n_edges) ** 2 * n_items).astype(np.int32)
    if stars == "half":
        r = (rng.integers(1, 11, size=n_edges) * 0.5).astype(np.float32)
    else:
        r = rng.integers(1, 6, size=n_edges).astype(np.float32)
    return u, i, r


#: the sentinels each guarded window of this run recorded (of
#: 2 * window.SENTINELS), printed at the end
WINDOW_SENTINELS: list = []


def _sentinels_seen(rows) -> int:
    return sum(e.count for e in rows if window.is_sentinel(e.key))


def _window_rows(prof) -> list:
    """The rows of a guarded CUDA-activity window (``profiled``) with
    device time, but for the window's sentinels. Raises if the sentinels
    say that the profiler dropped records inside the window."""
    rows = prof.key_averages()
    seen = _sentinels_seen(rows)
    WINDOW_SENTINELS.append(seen)
    if not window.window_complete(seen):
        raise AssertionError(
            f"the profiler lost the ends of a window: {seen} of "
            f"{2 * window.SENTINELS} sentinel kernels recorded")
    return [e for e in rows
            if e.self_device_time_total > 0 and not window.is_sentinel(e.key)]


def _kernels(prof) -> list:
    """The kernel rows of a guarded window (``_window_rows``): neither
    copies and fills, nor user annotations (``Optimizer.step#Adam.step``),
    whose device time is their kernels' again."""
    return [e for e in _window_rows(prof)
            if not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("Memcpy", "Memset"))]


@contextlib.contextmanager
def profiled():
    """A torch.profiler CUDA-activity session held as the port holds its
    traces (``pio_tpu_torch/obs/profile.py``): idle and sentinel kernels
    at both ends, the device drained before the stop. Without them the
    profiler drops the first kernels of a session late in a process, and
    kernels whose converted device time falls outside it
    (``scripts/torch_profiler_window.py``)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            acc_events=True) as prof:
        window.open_window()
        yield prof
        window.close_window()


def guarded(fn, retry: bool = False):
    """(fn's result, the profiler of a guarded window around one call).
    Late in a process the profiler now and then drops a whole end of a
    window, which its sentinels tell. With ``retry``, for an ``fn`` that
    leaves nothing behind (no stored run, no launch counted beyond the
    window unless it resets the counters itself), such a window is
    discarded and ``fn`` runs once more in a new one. The last window is
    returned whatever its sentinels say, and ``_window_rows`` holds it to
    them."""
    for k in range(2 if retry else 1):
        with profiled() as prof:
            out = fn()
        seen = _sentinels_seen(prof.key_averages())
        if window.window_complete(seen) or not retry or k == 1:
            return out, prof
        log(f"  the profiler lost an end of a window ({seen} of "
            f"{2 * window.SENTINELS} sentinel kernels): measured again")


def count_kernels(fn):
    """(fn's result, device kernels it launched), from torch.profiler's
    CUDA activity in a guarded window; copies, fills and the window's
    sentinels are not counted."""
    out, prof = guarded(fn)
    return out, sum(e.count for e in _kernels(prof))


def device_busy(fn, iters: int = 1):
    """(kernel launches, device ms, {kernel: device ms}) a call of ``fn``,
    the mean of ``iters`` calls after one warmup: the kernels' own times
    from the profiler, so a call whose host side is slower than its
    kernels (many small launches) is measured by its device work and not
    by the host's pace."""
    fn()
    _, prof = guarded(lambda: [fn() for _ in range(iters)], retry=True)
    rows = _kernels(prof)
    ms = {e.key: e.self_device_time_total / iters / 1e3 for e in rows}
    return sum(e.count for e in rows) / iters, sum(ms.values()), ms


def card_rmse(f, u, i, r) -> float:
    """Train RMSE of host factors over the ratings, on the card."""
    P = torch.from_numpy(f.user_factors).to(CARD)
    Q = torch.from_numpy(f.item_factors).to(CARD)
    ut, it, rt = (torch.from_numpy(a).to(CARD) for a in (u, i, r))
    err = 0.0
    for lo in range(0, len(u), 1 << 22):
        sl = slice(lo, lo + (1 << 22))
        pred = (P[ut[sl].long()] * Q[it[sl].long()]).sum(1)
        err += float(((pred - rt[sl]) ** 2).double().sum())
    return (err / len(u)) ** 0.5


def sorted_layouts(u, i, r, n_users, n_items, cfg):
    """On the card: the (user, item)-sorted edges and both blocked layouts
    train_als builds from them (device_pack gives the host packer's bits)."""
    ut, it, rt = (torch.from_numpy(a).to(CARD) for a in (u, i, r))
    order = torch.argsort(ut.long() * n_items + it.long(), stable=True)
    us, its, rs = ut[order], it[order], rt[order]
    w_u = als._auto_width(len(u), n_users)
    w_i = als._auto_width(len(u), n_items)
    counts_u, chunk_u, S_u = als._counts_layout(u, w_u, n_users,
                                                cfg.blocks_per_chunk)
    counts_i, chunk_i, S_i = als._counts_layout(i, w_i, n_items,
                                                cfg.blocks_per_chunk)
    cu = torch.from_numpy(counts_u.astype(np.int32)).to(CARD)
    ci = torch.from_numpy(counts_i.astype(np.int32)).to(CARD)

    def pack_user():
        return als.device_pack(us, its, rs, n_users, w_u, S_u,
                               assume_sorted=True, counts=cu)

    def pack_item():
        return als.device_pack(its, us, rs, n_items, w_i, S_i, counts=ci)

    return dict(
        sorted=(us, its, rs), counts_u=counts_u, cu=cu, ci=ci,
        user=dict(n=n_users, w=w_u, chunk=chunk_u, S=S_u, pack=pack_user,
                  blocks=pack_user()),
        item=dict(n=n_items, w=w_i, chunk=chunk_i, S=S_i, pack=pack_item,
                  blocks=pack_item()),
    )


def normal_eq_bound(blocks, n_edges, n, n_other, K) -> dict:
    """partial_normal_eq: each input read once — block ids, other ids and
    ratings (4 B each), the other side's factor table — and A, b written
    once; one multiply-add (2 flops) per real edge for each of the K*K
    entries of A and the K of b (this run's edges, not the padded slots)."""
    ent, oth, _ = blocks
    n_bytes = ent.numel() * 4 + oth.numel() * 8 + n_other * K * 4 \
        + n * (K * K + K) * 4
    return bound_of(n_bytes, 2 * n_edges * (K * K + K))


def solve_bound(n, K, solver) -> dict:
    """solve_block: A and b read once, x written once; a Cholesky
    factorization (K^3/3 multiply-adds) and two triangular solves (K^2),
    LU (2K^3/3 and K^2), or K+8 CG iterations of a K^2 product and ~5K
    vector work, per entity."""
    mads = {"cholesky": K ** 3 / 3 + K * K, "lu": 2 * K ** 3 / 3 + K * K,
            "cg": (K + 8) * (K * K + 5 * K)}[solver]
    return bound_of(n * (K * K + 2 * K) * 4, int(2 * n * mads))


def program_row(name, replaces, shape, launches, ms, bnd, err) -> dict:
    return {"name": name, "route": "pytorch", "replaces": replaces,
            "shape": shape, "launches": launches, "ms": ms,
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
            "max_abs_err_cpu": err}


def phase_als_full(args, smi) -> dict:
    """Phase 11: train_als at MovieLens-25M's full shape on the card."""
    t_phase = time.monotonic()
    log(f"phase 11: train_als at MovieLens-25M's shape ({ML25M_EDGES} "
        f"ratings, {ML25M_USERS} users, {ML25M_ITEMS} items), rank 16, 10 "
        f"iterations, reg 0.1; {smi}")
    u, i, r = synth_ratings(ML25M_EDGES, ML25M_USERS, ML25M_ITEMS, args.seed,
                            "half")
    cfg = als.ALSConfig(rank=16, iterations=10, reg=0.1, seed=args.seed)
    ctx = ComputeContext.local(args.seed, device=CARD)
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.monotonic()
    f32 = als.train_als(ctx, u, i, r, ML25M_USERS, ML25M_ITEMS, cfg,
                        stats=stats)
    train_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"  train_als {train_s:.2f} s (host clock; the default route: "
        f"packer {stats['packer']}, n_stream {stats['n_stream']}): pack "
        f"{stats['pack_s']:.3f} s, wire {stats['wire_bytes']} B "
        f"({stats['encoding']}), h2d {stats['h2d_s']:.3f} s, device "
        f"{stats['device_s']:.3f} s; peak device memory {peak} B")
    again = als.train_als(ctx, u, i, r, ML25M_USERS, ML25M_ITEMS, cfg)
    same = bool(np.array_equal(f32.user_factors, again.user_factors)
                and np.array_equal(f32.item_factors, again.item_factors))
    log(f"  two float32 runs give the same bits: {same}")
    if not same:
        raise AssertionError("two train_als runs gave different factors")

    lay = sorted_layouts(u, i, r, ML25M_USERS, ML25M_ITEMS, cfg)
    K = cfg.rank
    # the wire train_als shipped, rebuilt from the card's sort of the edges
    us, its, rs = lay["sorted"]
    r_ship, rating_wire = als._encode_ratings(rs.cpu().numpy())
    d_lo, d_hi, ovf_idx, ovf_val, wire_b = als._encode_items_delta(
        its.cpu().numpy(), lay["counts_u"])
    if stats["encoding"] != f"{rating_wire}+delta12":
        raise AssertionError(f"train_als shipped {stats['encoding']}")
    wire = [als._wire_tensor(a, CARD)
            for a in (d_lo, d_hi, ovf_idx, ovf_val, r_ship)]
    shapes = (lay["user"]["chunk"], lay["user"]["S"], lay["user"]["w"],
              lay["item"]["chunk"], lay["item"]["S"], lay["item"]["w"])

    def trained(matmul_dtype, **over):
        """train_als's device part on this wire, from train_als's init."""
        run_cfg = dataclasses.replace(cfg, matmul_dtype=matmul_dtype, **over)
        gen = torch.Generator()
        gen.manual_seed(cfg.seed)
        P0 = als._init_factors(ML25M_USERS, run_cfg.rank, gen).to(CARD)
        Q0 = als._init_factors(ML25M_ITEMS, run_cfg.rank, gen).to(CARD)
        by_user, by_item = als._decode_pack(
            (lay["cu"], lay["ci"], *wire), shapes, ML25M_USERS, ML25M_ITEMS,
            rating_wire, "delta12")
        return als._run_iterations(by_user, by_item, P0, Q0, run_cfg,
                                   shapes[0], shapes[3])

    # float32 against explicit bfloat16, in turns (host clock around the
    # device part, the card drained before and after)
    runs = {"float32": [], "bfloat16": []}
    outs = {}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        runs[dtype].append(host_ms(
            lambda d=dtype: outs.__setitem__(d, trained(d))) / 1e3)
    if not (torch.equal(outs["float32"][0].cpu(),
                        torch.from_numpy(f32.user_factors))
            and torch.equal(outs["float32"][1].cpu(),
                            torch.from_numpy(f32.item_factors))):
        raise AssertionError("the device part on the rebuilt wire differs "
                             "from train_als")
    bf16 = als.ALSFactors(*(x.cpu().numpy() for x in outs["bfloat16"]))
    rmse32, rmse16 = card_rmse(f32, u, i, r), card_rmse(bf16, u, i, r)
    log(f"  device part, s in turns: float32 {rounded(runs['float32'])}, "
        f"bfloat16 {rounded(runs['bfloat16'])}; train RMSE float32 {rmse32}, "
        f"bfloat16 {rmse16}; the float32 run repeats train_als's bits")
    for f in (f32, bf16):
        if not (np.isfinite(f.user_factors).all()
                and np.isfinite(f.item_factors).all()):
            raise AssertionError("ALS gave non-finite factors")
    if not rmse32 < 1.5:  # half stars uniform on 0.5-5.0 have sd 1.44
        raise AssertionError(f"train RMSE {rmse32} no better than the mean")
    del outs
    P = torch.from_numpy(f32.user_factors).to(CARD)
    Q = torch.from_numpy(f32.item_factors).to(CARD)
    rows, solves = [], {}
    for side, other, n_other in (("user", Q, ML25M_ITEMS),
                                 ("item", P, ML25M_USERS)):
        sd = lay[side]
        ent, oth, rat = sd["blocks"]
        c = sd["chunk"]
        plan = als.segment_plan(ent, c)

        ext = torch.cat([other, other.new_zeros((1, K))])

        def products():
            for lo, _, _ in plan:
                als._chunk_partials(oth[lo:lo + c], rat[lo:lo + c], ext,
                                    False, cfg.alpha)

        part = als._chunk_partials(oth[:c], rat[:c], ext, False, cfg.alpha)

        def segment_sum():
            # every chunk's sum and carry, on one chunk's partials (every
            # chunk holds c blocks)
            acc = torch.zeros((sd["n"], K + 1, K), device=CARD)
            for _, e0, offsets in plan:
                als._add_runs(acc, e0, offsets, part)

        def half_step():
            return als.half_step(sd["blocks"], other, sd["n"], c, cfg,
                                 plan=plan)

        def normal_eq():
            return als.partial_normal_eq(*sd["blocks"], other, sd["n"], c,
                                         plan=plan)

        _, launches = count_kernels(half_step)
        A, b = normal_eq()
        gram = als.gram_of(other)
        parts = {
            "gather + products": cuda_ms(products, iters=3, warmup=1),
            "segment sum": cuda_ms(segment_sum, iters=3, warmup=1),
            "solve (cholesky)": cuda_ms(lambda: als.solve_block(
                A, b, gram, cfg.reg, solver="cholesky"), iters=3, warmup=1),
        }
        whole = cuda_ms(half_step, iters=3, warmup=1)
        eq_ms = cuda_ms(normal_eq, iters=3, warmup=1)
        bnd = normal_eq_bound(sd["blocks"], ML25M_EDGES, sd["n"], n_other, K)
        log(f"  {side} half-step ({sd['n']} entities, width {sd['w']}, "
            f"{sd['S']} blocks in chunks of {sd['chunk']}): {whole:.3f} ms, "
            f"{launches} launches; parts ms "
            f"{json.dumps({k: round(v, 4) for k, v in parts.items()})}; "
            f"normal equations {eq_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}); {smi}")
        x_ref = als.solve_block(A, b, gram, cfg.reg, solver="cholesky")
        for solver in ("cholesky", "cg", "lu"):
            ms = cuda_ms(lambda s=solver: als.solve_block(
                A, b, gram, cfg.reg, solver=s), iters=3, warmup=1)
            _, n_l = count_kernels(lambda s=solver: als.solve_block(
                A, b, gram, cfg.reg, solver=s))
            x = als.solve_block(A, b, gram, cfg.reg, solver=solver)
            diff = float((x - x_ref).abs().max())
            solves[(side, solver)] = dict(ms=ms, launches=n_l, diff=diff,
                                          n=sd["n"])
            log(f"    solve {solver} at {sd['n']} entities: {ms:.3f} ms, "
                f"{n_l} launches, max |x - x_cholesky| {diff}")
            if not diff < 1e-2 * max(1.0, float(x_ref.abs().max())):
                raise AssertionError(f"{solver} disagrees with cholesky")
        _, eq_launches = count_kernels(normal_eq)
        rows.append(program_row(
            f"partial_normal_eq ({side} side)", "pio_tpu/models/als.py:225",
            f"{sd['S']} blocks x {sd['w']} x K={K} -> {sd['n']} entities",
            eq_launches * cfg.iterations, eq_ms, bnd, None))
        pack_ms = cuda_ms(sd["pack"], iters=3, warmup=1)
        _, pack_l = count_kernels(sd["pack"])
        rows.append(program_row(
            f"device_pack ({side} side)", "pio_tpu/models/als.py:682",
            f"{ML25M_EDGES} edges -> {sd['S']} x {sd['w']}", pack_l, pack_ms,
            bound_of(ML25M_EDGES * 12 + sd["n"] * 4 + sd["S"] * (4 + 8 * sd["w"]),
                     0), None))
        del A, b, part
    for side in ("user", "item"):
        n = lay[side]["n"]
        for solver in ("cholesky", "cg", "lu"):
            s = solves[(side, solver)]
            rows.append(program_row(
                f"solve_block {solver} ({side} side)",
                "pio_tpu/models/als.py:312", f"{n} x {K}x{K}",
                # launches a train_als makes through this solver ("auto")
                s["launches"] * cfg.iterations
                if als._solver_for("auto") == solver else 0,
                s["ms"], solve_bound(n, K, solver), None))

    # the wire decoded on the card
    def dec_items():
        return als.decode_items(*wire[:4], lay["cu"], "delta12")

    def dec_ratings():
        return als.decode_ratings(wire[4], ML25M_EDGES, rating_wire)

    if not (torch.equal(dec_items(), its) and torch.equal(dec_ratings(), rs)):
        raise AssertionError("the decoded wire differs from the sorted edges")
    for name, fn, line, nb in (
        ("decode_items delta12", dec_items, 351,
         wire_b + 4 * ML25M_USERS + 4 * ML25M_EDGES),
        (f"decode_ratings {rating_wire}", dec_ratings, 386,
         r_ship.nbytes + 4 * ML25M_EDGES),
    ):
        ms = cuda_ms(fn, iters=5, warmup=1)
        _, n_l = count_kernels(fn)
        rows.append(program_row(name, f"pio_tpu/models/als.py:{line}",
                                f"{ML25M_EDGES} edges", n_l, ms,
                                bound_of(nb, 0), None))
    log(f"  wire decoded on the card equals the sorted edges ({len(ovf_idx)} "
        f"overflow gaps)")

    # one iteration at a large rank: the normal equations' memory is the
    # accumulator, n*K^2 floats of the larger side, plus one chunk
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    P, Q = trained("float32", rank=WIDE_RANK, iterations=1)
    torch.cuda.synchronize()
    wide_s = time.monotonic() - t0
    wide_peak = torch.cuda.max_memory_allocated()
    acc = ML25M_USERS * WIDE_RANK * (WIDE_RANK + 1) * 4
    log(f"  rank {WIDE_RANK}, one iteration: {wide_s:.2f} s (host clock), "
        f"peak device memory {wide_peak} B with {held} B of this phase's "
        f"tensors held; the user side's accumulator A, b is {acc} B; {smi}")
    if not (torch.isfinite(P).all() and torch.isfinite(Q).all()):
        raise AssertionError(f"rank {WIDE_RANK} gave non-finite factors")
    del P, Q
    log(f"  phase 11 {time.monotonic() - t_phase:.1f} s")
    return dict(factors=f32, rows=rows, solves=solves, same_bits=same,
                ratings=(u, i, r))


def phase_als_card_vs_cpu(args, smi, rows) -> None:
    """Phase 12: train_als on the card against the port's train_als on the
    CPU at MovieLens-100K's shape, and each device program card vs CPU."""
    t_phase = time.monotonic()
    log(f"phase 12: train_als card vs CPU at MovieLens-100K's shape "
        f"({ML100K_EDGES} ratings, {ML100K_USERS} users, {ML100K_ITEMS} "
        f"items); {smi}")
    u, i, r = synth_ratings(ML100K_EDGES, ML100K_USERS, ML100K_ITEMS,
                            args.seed, "int")
    cfg = als.ALSConfig(rank=16, iterations=10, reg=0.1, seed=args.seed)
    fits = {}
    for dev in ("cuda", "cpu"):
        ctx = ComputeContext.local(args.seed,
                                   device=CARD if dev == "cuda" else "cpu")
        fits[dev] = als.train_als(ctx, u, i, r, ML100K_USERS, ML100K_ITEMS, cfg)
    rm = {}
    for dev, f in fits.items():
        pred = (f.user_factors[u] * f.item_factors[i]).sum(1)
        rm[dev] = float(np.sqrt(np.mean((pred - r) ** 2)))
    scale = max(np.abs(fits["cpu"].user_factors).max(),
                np.abs(fits["cpu"].item_factors).max())
    err = max(np.abs(fits["cuda"].user_factors - fits["cpu"].user_factors).max(),
              np.abs(fits["cuda"].item_factors - fits["cpu"].item_factors).max())
    log(f"  train RMSE card {rm['cuda']}, CPU {rm['cpu']}; factors max |card -"
        f" CPU| {err} (largest |factor| {scale})")
    if abs(rm["cuda"] - rm["cpu"]) > ALS_RMSE_TOL * rm["cpu"]:
        raise AssertionError("train RMSE on the card differs from the CPU's")
    if err > ALS_FACTOR_TOL * scale:
        raise AssertionError(f"factors on the card are {err} off the CPU's")

    # each device program, card vs CPU, on this data, both sides
    errs = {}
    lay = sorted_layouts(u, i, r, ML100K_USERS, ML100K_ITEMS, cfg)
    us, its, rs = (x.cpu().numpy() for x in lay["sorted"])
    r_ship, rating_wire = als._encode_ratings(rs)
    wire = als._encode_items_delta(its, lay["counts_u"])[:4]
    for d in (CARD, torch.device("cpu")):
        got_i = als.decode_items(
            *(als._wire_tensor(a, d) for a in wire),
            als._wire_tensor(lay["counts_u"].astype(np.int32), d), "delta12")
        got_r = als.decode_ratings(als._wire_tensor(r_ship, d), len(rs),
                                   rating_wire)
        if not (np.array_equal(got_i.cpu().numpy(), its)
                and np.array_equal(got_r.cpu().numpy(), rs)):
            raise AssertionError(f"the wire decoded on {d} differs")
    errs["decode_items delta12"] = errs[f"decode_ratings {rating_wire}"] = 0.0
    gram = torch.zeros(16, 16)
    for side, ent, oth, other in (
            ("user", us, its, fits["cpu"].item_factors),
            ("item", its, us, fits["cpu"].user_factors)):
        sd = lay[side]
        # the host packer on the same (user, item)-sorted edges
        want = als._pack_blocks(ent, oth, rs, sd["n"], sd["w"], sd["chunk"])
        blocks_cpu = tuple(x.cpu() for x in sd["blocks"])
        same = all(np.array_equal(g.numpy(), w)
                   for g, w in zip(blocks_cpu, want))
        errs[f"device_pack ({side} side)"] = 0.0 if same else float("inf")
        if not same:
            raise AssertionError(f"device_pack ({side} side) on the card "
                                 f"differs from the host packer")
        A, b = als.partial_normal_eq(*sd["blocks"],
                                     torch.from_numpy(other).to(CARD),
                                     sd["n"], sd["chunk"])
        A_c, b_c = als.partial_normal_eq(*blocks_cpu, torch.from_numpy(other),
                                         sd["n"], sd["chunk"])
        err = max(float((A.cpu() - A_c).abs().max()),
                  float((b.cpu() - b_c).abs().max()))
        errs[f"partial_normal_eq ({side} side)"] = err
        rel = err / float(A_c.abs().max())
        log(f"  normal equations ({side} side) card vs CPU: max |err| {err} "
            f"(relative {rel})")
        if rel > NORMAL_EQ_RTOL:
            raise AssertionError(f"normal equations ({side} side) differ "
                                 f"from the CPU's")
        # explicit bf16: the same bf16 values and exact products in another
        # order; implicit: the weighted rows round on the card only
        for implicit, rtol in ((False, NORMAL_EQ_RTOL), (True, BF16_ROW_RTOL)):
            kw = dict(implicit=implicit, alpha=1.0,
                      matmul_dtype=torch.bfloat16)
            A16, _ = als.partial_normal_eq(
                *sd["blocks"], torch.from_numpy(other).to(CARD), sd["n"],
                sd["chunk"], **kw)
            A16_c, _ = als.partial_normal_eq(
                *blocks_cpu, torch.from_numpy(other), sd["n"], sd["chunk"],
                **kw)
            rel16 = float((A16.cpu() - A16_c).abs().max()) / float(
                A16_c.abs().max())
            log(f"  bf16 normal equations ({side} side, implicit {implicit})"
                f" card vs CPU: relative {rel16} (limit {rtol})")
            if rel16 > rtol:
                raise AssertionError("bf16 normal equations differ from the "
                                     "CPU's")
        for solver in ("cholesky", "cg", "lu"):
            x = als.solve_block(A, b, gram.to(CARD), cfg.reg, solver=solver)
            x_c = als.solve_block(A_c, b_c, gram, cfg.reg, solver=solver)
            errs[f"solve_block {solver} ({side} side)"] = float(
                (x.cpu() - x_c).abs().max())
    log(f"  device programs, max |card - CPU|: {json.dumps(errs)}")
    for row in rows:
        if row["name"] not in errs:
            raise AssertionError(f"no card-vs-CPU check for {row['name']}")
        row["max_abs_err_cpu"] = errs[row["name"]]
    log(f"  phase 12 {time.monotonic() - t_phase:.1f} s")


def rec_events(rng, app_id):
    u, i, r = synth_ratings(ML100K_EDGES, ML100K_USERS, ML100K_ITEMS,
                            int(rng.integers(1 << 30)), "int")
    t0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    events = [
        Event("rate", "user", f"u{a}", "item", f"i{b}",
              properties={"rating": float(c)},
              event_time=t0 + dt.timedelta(seconds=k))
        for k, (a, b, c) in enumerate(zip(u.tolist(), i.tolist(), r.tolist()))
    ]
    events += [Event("buy", "user", f"u{k}", "item", f"i{k}", event_time=t0)
               for k in range(16)]
    Storage.get_pevents().write(events, app_id)
    return len(events)


def check_served(got: dict, q: RecQuery, cpu_model, where: str) -> None:
    """A served top-N answer against the CPU copy of the same blob: the
    scores within SCORE_TOL of the CPU's scores of the same items, in
    order, and a top-N of the CPU's scores up to ties within SCORE_TOL."""
    items = [s["item"] for s in got["itemScores"]]
    served = np.array([s["score"] for s in got["itemScores"]])
    cpu = RecALS().predict(cpu_model, q).to_dict()
    code = cpu_model.user_index.get(q.user)
    if code is None or q.num <= 0:
        if got != cpu:
            raise AssertionError(f"{where}: {got} vs CPU copy {cpu}")
        return
    full = cpu_model.scorer().scores_batch(np.array([code], np.int32))[0]
    if q.item:
        want = full[cpu_model.item_index[q.item]]
        if items != [q.item] or abs(served[0] - want) > SCORE_TOL:
            raise AssertionError(f"{where}: {got} vs CPU score {want}")
        return
    for it in q.black_list:
        full[cpu_model.item_index[it]] = -np.inf
    codes = [cpu_model.item_index[it] for it in items]
    nth = np.sort(full)[::-1][len(cpu["itemScores"]) - 1]
    ok = (len(items) == len(cpu["itemScores"]) == len(set(items))
          and np.all(np.abs(served - full[codes]) <= SCORE_TOL)
          and np.all(np.diff(served) <= SCORE_TOL)
          and np.all(full[codes] >= nth - SCORE_TOL))
    if not ok:
        raise AssertionError(f"{where}: {got} is not the CPU copy's top-"
                             f"{q.num} ({cpu})")


def serve_bodies(engine, ep, models, bodies):
    """``POST /queries.json`` of each body through a query server over
    ``models``: (answers, launches on the card, host clock ms each)."""
    server = create_query_server(engine, ep, models, host="127.0.0.1", port=0)
    ms = []
    with server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)

        def serve_all():
            out = []
            for body in bodies:
                t = time.perf_counter()
                status, got = post(conn, json.dumps(body).encode())
                ms.append((time.perf_counter() - t) * 1e3)
                if status != 200:
                    raise AssertionError(f"query {body}: HTTP {status} {got}")
                out.append(got)
            return out

        answers, launches = count_kernels(serve_all)
        conn.close()
    return answers, launches, ms


def phase_rec_template(args, smi) -> dict:
    """Phase 13: the recommendation template end to end on the card."""
    t_phase = time.monotonic()
    log(f"phase 13: templates.recommendation end to end at MovieLens-100K's "
        f"shape: ingest, run_train, load_models_for_instance, "
        f"{N_REC_HTTP} POST /queries.json, batch_predict of {N_REC_BATCH}")
    rng = np.random.default_rng(args.seed + 3)
    app_id = Storage.get_meta_data_apps().insert(App(0, REC_APP))
    t0 = time.monotonic()
    n_events = rec_events(rng, app_id)
    ingest_s = time.monotonic() - t0
    variant = variant_from_dict({
        "id": "rec-chip-smoke", "engineFactory": "templates.recommendation",
        "datasource": {"params": {"app_name": REC_APP}},
        "algorithms": [{"name": "als",
                        "params": {**ALS_PARAMS, "seed": args.seed}}],
    })
    engine, ep = build_engine(variant)
    ctx = ComputeContext.create(args.seed, device=CARD)
    t0 = time.monotonic()
    iid, train_launches = count_kernels(
        lambda: run_train(engine, ep, variant, ctx=ctx))
    train_s = time.monotonic() - t0
    inst = Storage.get_meta_data_engine_instances().get(iid)
    phases = {k: v for k, v in inst.env.items() if k.startswith("phase_")}
    log(f"  ingest {n_events} events {ingest_s:.2f} s; run_train {train_s:.2f} s"
        f" (host clock, under the profiler), {train_launches} launches; "
        f"phases {json.dumps(phases)}; device {inst.env['device']}")
    if inst.env["device"] != str(CARD):
        raise AssertionError("run_train did not run on the card")
    gpu = load_models_for_instance(iid, engine, ep, ctx)
    cpu = load_models_for_instance(
        iid, engine, ep, ComputeContext.local(args.seed, device="cpu"))
    if gpu[0].factors.user_factors.device.type != CARD.type:
        raise AssertionError("the loaded model is not on the card")
    users = sorted(gpu[0].user_index.keys())
    items = list(gpu[0].item_index.keys())
    bodies = [
        {"user": users[0], "num": 10},
        {"user": users[1], "num": 10, "blackList": items[:5]},
        {"user": users[2], "item": items[7]},
        {"user": "stranger", "num": 10},
        {"user": users[3], "num": 0},
        {"user": users[4], "num": 20},
        {"user": users[5], "num": 5, "blackList": items[:50]},
        {"user": users[6]},
    ]
    answers, http_launches, ms = serve_bodies(engine, ep, gpu, bodies)
    for k, (body, got) in enumerate(zip(bodies, answers)):
        check_served(got, params_from_dict(RecQuery, body), cpu[0],
                     f"rec query {k}")
    log(f"  on the card (PIO_TPU_SERVE_DEVICE unset): {N_REC_HTTP} answers "
        f"match the CPU copy of the blob; {http_launches} launches; host "
        f"clock ms per request {rounded(ms)}")
    if gpu[0].scorer().min_device_batch != 1 or http_launches == 0:
        raise AssertionError("the served path did not score on the card")
    # the same requests with the reference's routing by batch size
    with serve_device("auto"):
        routed = load_models_for_instance(iid, engine, ep, ctx)
        answers, routed_launches, ms = serve_bodies(engine, ep, routed, bodies)
    scorer = routed[0].scorer()
    for k, (body, got) in enumerate(zip(bodies, answers)):
        check_served(got, params_from_dict(RecQuery, body), cpu[0],
                     f"rec query {k}, routed by batch size")
    log(f"  PIO_TPU_SERVE_DEVICE=auto: link round trip "
        f"{topn._probe_link_rtt_s(str(scorer.device)) * 1e6:.1f} us; top-N "
        f"to the card from batch {scorer.min_device_batch}, pairs from "
        f"{scorer.min_pair_batch}; {N_REC_HTTP} answers match the CPU copy; "
        f"{routed_launches} launches; host clock ms per request {rounded(ms)}")

    algo = RecALS(ep.algorithm_params_list[0][1])
    qs = [(k, RecQuery(user=users[k % len(users)], num=10))
          for k in range(N_REC_BATCH)]
    t0 = time.perf_counter()
    batch, batch_launches = count_kernels(
        lambda: dict(algo.batch_predict(gpu[0], qs)))
    batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loop = {k: algo.predict(gpu[0], q) for k, q in qs}
    loop_ms = (time.perf_counter() - t0) * 1e3
    for k, q in qs:
        for name, got in (("batch", batch[k]), ("loop", loop[k])):
            check_served(got.to_dict(), q, cpu[0], f"{name} query {k}")
    log(f"  batch_predict of {N_REC_BATCH}: {batch_ms:.1f} ms, "
        f"{batch_launches} launches; the predict loop {loop_ms:.1f} ms (host "
        f"clock, the batch under the profiler); both match the CPU copy")
    if batch_launches == 0:
        raise AssertionError("batch_predict launched nothing on the card")
    log(f"  phase 13 {time.monotonic() - t_phase:.1f} s; {smi}")
    return dict(train_launches=train_launches, http_launches=http_launches,
                routed_launches=routed_launches, batch_launches=batch_launches)


def phase_scorer_full(factors, smi, rows) -> None:
    """Phase 14: the top-N scorer at full width on phase 11's factors."""
    t_phase = time.monotonic()
    uf, itf = factors.user_factors, factors.item_factors
    log(f"phase 14: DeviceTopNScorer at full width ({uf.shape[0]} x "
        f"{itf.shape[0]}, rank {uf.shape[1]}); {smi}")
    with serve_device("auto"):
        auto = topn.DeviceTopNScorer(uf, itf, device=CARD)
    card = topn.DeviceTopNScorer(uf, itf, warmup=True, device=CARD)
    if card.min_device_batch != 1:
        raise AssertionError("a scorer on the card does not score there")
    host = topn.DeviceTopNScorer(uf, itf, prefer_device=False, device=CARD)
    log(f"  link round trip {topn._probe_link_rtt_s(str(auto.device)) * 1e6:.1f}"
        f" us; adaptive routing: top-N to the card from batch "
        f"{auto.min_device_batch}, pairs from {auto.min_pair_batch}")
    rng = np.random.default_rng(5)
    N, K = itf.shape
    results = {}
    for B in (1, 512):
        codes = rng.integers(0, uf.shape[0], B).astype(np.int32)
        for with_ex in (False, True):
            ex = rng.integers(0, N, (B, 64)).astype(np.int32) if with_ex else None
            tag = f"B={B}{' excl 64' if with_ex else ''}"
            got = {}
            for name, s in (("card", card), ("host", host)):
                s.top_n_batch(codes, 10, ex)
                got[name] = (host_ms(lambda s=s: s.top_n_batch(codes, 10, ex)),
                             s.top_n_batch(codes, 10, ex))
            (i_c, v_c), (i_h, v_h) = got["card"][1], got["host"][1]
            err = float(np.abs(v_c - v_h).max())
            full = host.scores_batch(codes)
            if ex is not None:
                full[np.arange(B)[:, None], ex] = -np.inf
            tenth = np.sort(full, axis=1)[:, -10]
            picked = np.take_along_axis(full, i_c, axis=1)
            if err > SCORE_TOL or not np.all(picked >= tenth[:, None] - SCORE_TOL):
                raise AssertionError(f"{tag}: card top-N is not the host's")
            results[tag] = {"card_ms": got["card"][0], "host_ms": got["host"][0],
                            "max_abs_err": err}
    log(f"  top_n_batch(n=10), host clock ms: {json.dumps(results)}")
    codes = rng.integers(0, uf.shape[0], 512).astype(np.int32)
    sb = {n: host_ms(lambda s=s: s.scores_batch(codes))
          for n, s in (("card", card), ("host", host))}
    sb_err = float(np.abs(card.scores_batch(codes) - host.scores_batch(codes)).max())
    rc = rng.integers(0, uf.shape[0], 100_000).astype(np.int32)
    cc = rng.integers(0, N, 100_000).astype(np.int32)
    sp = {n: host_ms(lambda s=s: s.score_pairs(rc, cc))
          for n, s in (("card", card), ("host", host))}
    sp_err = float(np.abs(card.score_pairs(rc, cc) - host.score_pairs(rc, cc)).max())
    log(f"  scores_batch(512) ms {json.dumps(sb)} max |err| {sb_err}; "
        f"score_pairs(100000) ms {json.dumps(sp)} max |err| {sp_err}")
    if max(sb_err, sp_err) > SCORE_TOL:
        raise AssertionError("card scores differ from the host's")

    # the device program alone (CUDA events), with its launches and bound
    for B in (1, 512):
        codes_t = torch.from_numpy(rng.integers(0, uf.shape[0], B)).to(CARD)

        def fn(codes_t=codes_t):
            return topn._topn_fn(card._rows_dev, card._cols_dev, codes_t, 16)

        ms = cuda_ms(fn, iters=10, warmup=2)
        _, n_l = count_kernels(fn)
        bnd = bound_of(B * K * 4 + N * K * 4 + B * 16 * 12 + B * 8,
                       2 * B * N * K)
        rows.append(program_row(
            "_topn_fn", "pio_tpu/ops/topn.py:60",
            f"B={B} x {N} items, K={K}, k=16", n_l, ms, bnd,
            results[f"B={B}"]["max_abs_err"]))
    log(f"  phase 14 {time.monotonic() - t_phase:.1f} s")


#: the held-out MSE of the evaluation sweep, card vs CPU: ten iterations
#: of the same f32 ALS in another summation order move the factors by up
#: to ALS_FACTOR_TOL of the largest (1e-4, phase 12), so a held-out
#: prediction of O(3) by ~1e-3 against errors of O(2): relative 1e-3
EVAL_MSE_RTOL = 1e-3


def exact_quarters(f: np.ndarray) -> np.ndarray:
    """``f`` rounded to multiples of 1/4 in [-2, 2]: every product and
    partial sum of a rank-16 dot of two such rows is exact in float32, so
    any summation order gives the same bits (and ties are common)."""
    return (np.clip(np.round(f * 4), -8, 8) / 4).astype(np.float32)


#: phase 15: the ratings (the first of phase 11's) on which the native
#: packer's wire is held to the numpy packer's array for array; the numpy
#: route took 16.6 s on all 25,000,000 on the H100's host
PACK_CHECK_EDGES = 5_000_000


def phase_als_route(args, smi, full) -> dict:
    """Phase 15: train_als at MovieLens-25M's shape on the default route,
    the native packer, against the numpy packer (PR 7's route)."""
    t_phase = time.monotonic()
    u, i, r = full["ratings"]
    U, I = ML25M_USERS, ML25M_ITEMS
    cfg = als.ALSConfig(rank=16, iterations=10, reg=0.1, seed=args.seed)
    ctx = ComputeContext.local(args.seed, device=CARD)
    log(f"phase 15: train_als at MovieLens-25M's shape on the default route "
        f"(the native packer, one shipment); {smi}")

    # the host pack: the native wire against the numpy wire (PR 7's
    # route), on the first PACK_CHECK_EDGES ratings
    n = PACK_CHECK_EDGES
    t0 = time.monotonic()
    native = als._encode_wire(u[:n], i[:n], r[:n], U, I, cfg)
    native_s = time.monotonic() - t0
    with knob("PIO_TPU_NO_NATIVE", "1"):
        t0 = time.monotonic()
        numpy_wire = als._encode_wire(u[:n], i[:n], r[:n], U, I, cfg)
        numpy_s = time.monotonic() - t0
    same_wire = native[1:] == numpy_wire[1:] and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(native[0], numpy_wire[0]))
    log(f"  host pack of the wire of the first {n} ratings (sort, counts, "
        f"encoders): native {native_s:.3f} s, numpy {numpy_s:.3f} s (host "
        f"clock, {os.cpu_count()} cores); {native[4]} B ({native[2]}+"
        f"{native[3]}); the {len(native[0])} arrays equal: {same_wire}")
    if not same_wire:
        raise AssertionError("the native wire differs from the numpy wire")
    del numpy_wire, native

    # the default route once with stats (phases serialized), its peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = {}
    t0 = time.monotonic()
    f = als.train_als(ctx, u, i, r, U, I, cfg, stats=st)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    if st["packer"] != "native" or st["n_stream"] != 1:
        raise AssertionError(f"train_als took the {st['packer']} packer in "
                             f"{st['n_stream']} shipments")
    log(f"  packer {st['packer']}, n_stream {st['n_stream']}: {wall:.3f} s "
        f"with stats: pack {st['pack_s']:.3f} s, h2d {st['h2d_s']:.4f} s "
        f"({st['wire_bytes']} B), device {st['device_s']:.3f} s; peak device "
        f"memory {peak} B")
    same = (np.array_equal(f.user_factors, full["factors"].user_factors)
            and np.array_equal(f.item_factors, full["factors"].item_factors))
    log(f"  the same bits as phase 11's run: {same}")
    if not same:
        raise AssertionError("train_als's factors differ from phase 11's")

    # wall time without stats (no synchronization between the phases)
    walls = [host_ms(lambda: als.train_als(ctx, u, i, r, U, I, cfg)) / 1e3
             for _ in range(3)]
    log(f"  train_als wall s without stats: {rounded(walls)}, median "
        f"{float(np.median(walls)):.4f}; {smi}")
    log(f"  phase 15 {time.monotonic() - t_phase:.1f} s")
    return dict(walls=walls, stats=st, peak=peak, pack=(native_s, numpy_s))


def median_ms(fn, n: int = 5) -> float:
    """Median of ``n`` :func:`host_ms` calls of ``fn``."""
    return float(np.median([host_ms(fn) for _ in range(n)]))


def phase_host_scorer(factors, smi) -> None:
    """Phase 16: the native host scorer at full width on phase 11's
    factors, against the numpy host path and the card."""
    t_phase = time.monotonic()
    uf, itf = factors.user_factors, factors.item_factors
    log(f"phase 16: the native host scorer at full width ({uf.shape[0]} x "
        f"{itf.shape[0]}, rank {uf.shape[1]}); {smi}")
    host = topn.DeviceTopNScorer(uf, itf, prefer_device=False, device=CARD)
    card = topn.DeviceTopNScorer(uf, itf, warmup=True, device=CARD)
    rng = np.random.default_rng(6)
    results = {}
    for B in (1, 64, 512):
        codes = rng.integers(0, uf.shape[0], B).astype(np.int32)
        i_n, v_n = host._top_n_host_native(codes, 10)  # + its mirror
        i_c, v_c = card.top_n_batch(codes, 10)
        with knob("PIO_TPU_NO_NATIVE", "1"):
            i_p, v_p = host.top_n_batch(codes, 10)
            numpy_ms = median_ms(lambda: host.top_n_batch(codes, 10))
        native_ms = median_ms(lambda: host._top_n_host_native(codes, 10))
        card_ms = median_ms(lambda: card.top_n_batch(codes, 10))
        full = host.scores_batch(codes)
        tenth = np.sort(full, axis=1)[:, -10]
        picked = np.take_along_axis(full, i_n, axis=1)
        err = float(max(np.abs(v_n - v_p).max(), np.abs(v_n - v_c).max()))
        if err > SCORE_TOL or not np.all(picked >= tenth[:, None] - SCORE_TOL):
            raise AssertionError(f"B={B}: the native top-N is not numpy's")
        results[f"B={B}"] = {
            "native_ms": native_ms, "numpy_ms": numpy_ms, "card_ms": card_ms,
            "max_abs_err": err,
            "same_items_numpy": float(np.mean(i_n == i_p)),
            "same_items_card": float(np.mean(i_n == i_c))}
    log(f"  top-10, host clock ms (median of 5): {json.dumps(results)}")
    # bitwise on exact factors at full width, ties included
    ex = topn.DeviceTopNScorer(exact_quarters(uf), exact_quarters(itf),
                               prefer_device=False, device=CARD)
    codes = rng.integers(0, uf.shape[0], 64).astype(np.int32)
    i_n, v_n = ex._top_n_host_native(codes, 100)
    i_p, v_p = ex._top_n_host_chunk(codes, 100, None)
    ties = int(np.sum(np.diff(v_p, axis=1) == 0))
    same = np.array_equal(i_n, i_p) and np.array_equal(
        v_n.view(np.uint32), v_p.view(np.uint32))
    log(f"  exact factors (multiples of 1/4), 64 rows x top-100, {ties} "
        f"tied neighbours: native and numpy the same indices and bits: {same}")
    if not same:
        raise AssertionError("the native host scorer is not numpy's bits")
    log(f"  phase 16 {time.monotonic() - t_phase:.1f} s")


def phase_evaluation(args, smi) -> dict:
    """Phase 17: run_evaluation of recommendation_evaluation at
    MovieLens-100K's shape (phase 13's events) on the card and the CPU."""
    t_phase = time.monotonic()
    # lambda 0.1 alone since PR 17 (0.05 and 0.1 before), for the
    # script's time
    ev = recommendation_evaluation(REC_APP, eval_k=3, ranks=(8, 16),
                                   lambdas=(0.1,), num_iterations=10)
    log(f"phase 17: run_evaluation of recommendation_evaluation at "
        f"MovieLens-100K's shape (phase 13's {REC_APP} events): 3 folds, "
        f"rank x lambda grid (8, 16) x (0.1,), 10 iterations; {smi}")
    out = {}
    for name, dev in (("card", CARD), ("cpu", torch.device("cpu"))):
        ctx = ComputeContext.create(args.seed, device=dev)
        t0 = time.monotonic()
        res = run_evaluation(ev, ev.engine_params_generator, ctx=ctx)
        out[name] = dict(s=time.monotonic() - t0, result=res,
                         scores=[x.score for x in res.engine_params_scores])
        log(f"  {name}: {out[name]['s']:.2f} s (host clock), MSE by params "
            f"{out[name]['scores']}, best index {res.best_index}")
    done = Storage.get_meta_data_evaluation_instances().get_completed()
    card, cpu = out["card"], out["cpu"]
    rel = max(abs(a - b) / b for a, b in zip(card["scores"], cpu["scores"]))
    log(f"  {len(done)} evaluation instances COMPLETED; MSE card vs CPU: max "
        f"relative {rel} (limit {EVAL_MSE_RTOL}); same best params: "
        f"{card['result'].best_index == cpu['result'].best_index}")
    if len(done) != 2 or not all(np.isfinite(card["scores"])):
        raise AssertionError("the evaluation did not complete")
    if card["result"].best_index != cpu["result"].best_index \
            or rel > EVAL_MSE_RTOL:
        raise AssertionError("the evaluation on the card differs from the "
                             "CPU's")
    log(f"  phase 17 {time.monotonic() - t_phase:.1f} s")
    return dict(card_s=card["s"], cpu_s=cpu["s"], scores=card["scores"])


# --------------------------------- the similar-product and e-commerce path
# bench.py:1606-1633 (BASELINE.md config #3), the similar-product template's
# implicit ALS: 5,000,000 views of 50,064 users over 20,064 items, r = 1 a
# view, from default_rng(2); rank 16, 10 iterations, reg 0.1, alpha 40
SP_EDGES, SP_USERS, SP_ITEMS = 5_000_000, 50_064, 20_064
SP_ALS = dict(rank=16, iterations=10, reg=0.1, implicit=True, alpha=40.0)
# the solver of train_als ("auto", Cholesky) on implicit systems: a
# backward-stable f32 solve of K = 16 leaves a residual of about
# K·2^-24·|A|·|x| (~1e-6 of it); ten times that as the limit
SOLVE_RESID_RTOL = 1e-5
SP_APP = "movielens-100k-views-synthetic"
# the 19 genres of MovieLens-100K (the GroupLens README's u.genre)
GENRES = ("unknown", "Action", "Adventure", "Animation", "Children's",
          "Comedy", "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir",
          "Horror", "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller",
          "War", "Western")
N_UNVIEWED = 50  # $set items nobody viewed: factor rows with no blocks
N_BUYS = 5000
N_SP_HTTP = 8
# batch_predict against the predict loop: the same f32 factors, one
# [B, K] @ [K, N] product against N K-dots (rank 10, |score| <= 1):
# ~1e-7 apart; two orders of magnitude over it
BATCH_TOL = 1e-5
# HitRate and accuracy of a sweep, card vs CPU: the factors (weights) move
# by f32 rounding in another order (at most 1e-4 of the largest, phase
# 18), which can flip a held-out item that sits at the top-10 boundary; a
# flip moves HitRate by 1/30,000 (the queries of a point) and accuracy by
# 1/1,131 (a tenth of the corpus). The limits allow 30 and 22 flips.
HITRATE_TOL = 1e-3
ACCURACY_TOL = 2e-2
TEXT_TENTH_APP = "newsgroups-synthetic-tenth"


def implicit_views(n_edges: int, n_users: int, n_items: int):
    """bench.py's _bench_similarproduct data: synth_ratings's users and
    items from seed 2 (the same draws: uniform users, squared-uniform
    items), each view r = 1."""
    u, i, _ = synth_ratings(n_edges, n_users, n_items, 2, "int")
    return u, i, np.ones(n_edges, np.float32)


def factor_diff(a, b) -> tuple:
    """(max |a - b| over both factor tables, largest |factor| of b)."""
    d = max(np.abs(a.user_factors - b.user_factors).max(),
            np.abs(a.item_factors - b.item_factors).max())
    s = max(np.abs(b.user_factors).max(), np.abs(b.item_factors).max())
    return float(d), float(s)


def phase_implicit_als(args, smi) -> dict:
    """Phase 18: implicit train_als at the similar-product configuration."""
    t_phase = time.monotonic()
    log(f"phase 18: implicit train_als at the similar-product configuration "
        f"(bench.py:1606-1633: {SP_EDGES} views, {SP_USERS} users, "
        f"{SP_ITEMS} items, {json.dumps(SP_ALS)}); {smi}")
    u, i, r = implicit_views(SP_EDGES, SP_USERS, SP_ITEMS)
    cfg = als.ALSConfig(**SP_ALS, seed=args.seed)
    K = cfg.rank
    ctx = ComputeContext.local(args.seed, device=CARD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.monotonic()
    f = als.train_als(ctx, u, i, r, SP_USERS, SP_ITEMS, cfg, stats=stats)
    train_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"  train_als {train_s:.3f} s (host clock; packer {stats['packer']}, "
        f"n_stream {stats['n_stream']}): pack {stats['pack_s']:.3f} s, wire "
        f"{stats['wire_bytes']} B ({stats['encoding']}), h2d "
        f"{stats['h2d_s']:.4f} s, device {stats['device_s']:.3f} s; peak "
        f"device memory {peak} B")
    again = als.train_als(ctx, u, i, r, SP_USERS, SP_ITEMS, cfg)
    same = bool(np.array_equal(f.user_factors, again.user_factors)
                and np.array_equal(f.item_factors, again.item_factors))
    log(f"  two runs give the same bits: {same}")
    if not same:
        raise AssertionError("two implicit train_als runs differ")
    if not (np.isfinite(f.user_factors).all()
            and np.isfinite(f.item_factors).all()):
        raise AssertionError("implicit ALS gave non-finite factors")
    P = torch.from_numpy(f.user_factors).to(CARD)
    Q = torch.from_numpy(f.item_factors).to(CARD)
    # implicit quality: a viewed pair scores above a random pair
    seen = float((P[torch.from_numpy(u[:200_000]).to(CARD).long()]
                  * Q[torch.from_numpy(i[:200_000]).to(CARD).long()])
                 .sum(1).mean())
    g = torch.Generator().manual_seed(args.seed)
    ru = torch.randint(0, SP_USERS, (200_000,), generator=g).to(CARD)
    ri = torch.randint(0, SP_ITEMS, (200_000,), generator=g).to(CARD)
    rand = float((P[ru] * Q[ri]).sum(1).mean())
    log(f"  mean p_u·q_i: viewed pairs {seen}, random pairs {rand}")
    if not seen > rand:
        raise AssertionError("viewed pairs score no higher than random ones")

    lay = sorted_layouts(u, i, r, SP_USERS, SP_ITEMS, cfg)
    sides = {}
    for side, other, n_other in (("user", Q, SP_ITEMS), ("item", P, SP_USERS)):
        sd = lay[side]
        c = sd["chunk"]
        plan = als.segment_plan(sd["blocks"][0], c)

        def gram(other=other):
            return als.gram_of(other, True)

        def normal_eq(sd=sd, other=other, c=c, plan=plan):
            return als.partial_normal_eq(*sd["blocks"], other, sd["n"], c,
                                         implicit=True, alpha=cfg.alpha,
                                         plan=plan)

        def half_step(sd=sd, other=other, c=c, plan=plan):
            return als.half_step(sd["blocks"], other, sd["n"], c, cfg,
                                 plan=plan)

        G = gram()
        A, b = normal_eq()

        def solve(A=A, b=b, G=G):
            return als.solve_block(A, b, G, cfg.reg, True, "auto")

        _, launches = count_kernels(half_step)
        whole = cuda_ms(half_step, iters=3, warmup=1)
        parts = {}
        for name, fn, bnd in (
                ("gram", gram, bound_of(n_other * K * 4 + K * K * 4,
                                        2 * n_other * K * K)),
                ("normal equations", normal_eq, normal_eq_bound(
                    sd["blocks"], SP_EDGES, sd["n"], n_other, K)),
                ("solve (auto: cholesky)", solve,
                 solve_bound(sd["n"], K, "cholesky"))):
            parts[name] = dict(ms=cuda_ms(fn, iters=3, warmup=1),
                               launches=count_kernels(fn)[1],
                               bound_ms=bnd["bound_ms"],
                               bound_by=bnd["bound_by"])
        log(f"  {side} half-step ({sd['n']} entities, width {sd['w']}, "
            f"{sd['S']} blocks in chunks of {c}): {whole:.3f} ms, {launches} "
            f"launches; parts {json.dumps(parts)}; {smi}")
        # each solver on these systems: (A + reg I + G) x = b
        eye = torch.eye(K, dtype=torch.float64, device=CARD)
        A_eff = A.double() + cfg.reg * eye + G.double()[None]
        a_norm = A_eff.abs().sum(2).amax(1)  # per-entity inf-norm
        solvers = {}
        for solver in ("cholesky", "cg", "lu"):
            ms = cuda_ms(lambda s=solver: als.solve_block(
                A, b, G, cfg.reg, True, s), iters=3, warmup=1)
            x = als.solve_block(A, b, G, cfg.reg, True, solver).double()
            res = ((A_eff @ x[:, :, None])[:, :, 0] - b.double()).abs()
            resid = float(res.max())
            rel = float((res.amax(1) / (a_norm * x.abs().amax(1)
                                        + b.double().abs().amax(1))).max())
            solvers[solver] = dict(ms=ms, resid=resid, rel_resid=rel)
            log(f"    solve {solver}: {ms:.3f} ms; largest residual "
                f"|(A + reg I + G) x - b| {resid} (normwise relative {rel})")
            if not np.isfinite(resid):
                raise AssertionError(f"{solver} gave a non-finite solution")
        auto = solvers[als._solver_for("auto")]
        if auto["rel_resid"] > SOLVE_RESID_RTOL:
            raise AssertionError(f"the auto solver's residual "
                                 f"{auto['rel_resid']} exceeds "
                                 f"{SOLVE_RESID_RTOL}")
        sides[side] = dict(ms=whole, launches=launches, parts=parts,
                           solvers=solvers, n=sd["n"])
        del A, b, A_eff
    del lay, P, Q

    # card against CPU at MovieLens-100K's shape, the same generator
    u, i, r = implicit_views(ML100K_EDGES, ML100K_USERS, ML100K_ITEMS)
    fits = {d: als.train_als(ComputeContext.local(args.seed, device=d), u, i,
                             r, ML100K_USERS, ML100K_ITEMS, cfg)
            for d in (CARD, torch.device("cpu"))}
    err, scale = factor_diff(fits[CARD], fits[torch.device("cpu")])
    log(f"  card vs CPU at MovieLens-100K's shape ({ML100K_EDGES} views): "
        f"factors max |card - CPU| {err} (largest |factor| {scale}; limit "
        f"{ALS_FACTOR_TOL} of it)")
    if err > ALS_FACTOR_TOL * scale:
        raise AssertionError("implicit factors on the card differ from the "
                             "CPU's")
    log(f"  phase 18 {time.monotonic() - t_phase:.1f} s")
    return dict(train_s=train_s, stats=stats, peak=peak, sides=sides,
                cpu_err=err, cpu_scale=scale)


def sp_events(args, app_id) -> dict:
    """ML-100K's shape as views (phase 18's generator), each item $set
    with 1-3 of the 19 genres, and N_UNVIEWED more $set items."""
    u, i, _ = implicit_views(ML100K_EDGES, ML100K_USERS, ML100K_ITEMS)
    rng = np.random.default_rng(args.seed + 5)
    t0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    names = [f"m{k}" for k in range(ML100K_ITEMS)] \
        + [f"new{k}" for k in range(N_UNVIEWED)]
    events = [Event("$set", "item", name, properties={"categories": [
        str(g) for g in rng.choice(GENRES, int(rng.integers(1, 4)),
                                   replace=False)]},
        event_time=t0) for name in names]
    events += [Event("view", "user", f"u{a}", "item", f"m{b}",
                     event_time=t0 + dt.timedelta(seconds=k + 1))
               for k, (a, b) in enumerate(zip(u.tolist(), i.tolist()))]
    Storage.get_pevents().write(events, app_id)
    return dict(n=len(events), last=t0 + dt.timedelta(seconds=len(u) + 1))


def topn_ok(answer: dict, full: np.ndarray, mask: np.ndarray, num: int,
            item_index, tol: float) -> bool:
    """``answer`` is a top-``num`` of ``full`` under ``mask`` up to ties
    within ``tol``: the right length, allowed distinct items, their scores
    within ``tol`` of ``full``'s, non-increasing, none below the n-th
    best allowed score by more than ``tol``."""
    items = [s["item"] for s in answer["itemScores"]]
    served = np.array([s["score"] for s in answer["itemScores"]])
    n = min(num, int(mask.sum()))
    if n <= 0:
        return items == []
    codes = [item_index.get(it) for it in items]
    if len(items) != n or len(set(items)) != n or None in codes:
        return False
    nth = np.sort(full[mask])[::-1][n - 1]
    return bool(mask[codes].all()
                and np.all(np.abs(served - full[codes]) <= tol)
                and np.all(np.diff(served) <= tol)
                and np.all(full[codes] >= nth - tol))


def sp_scores(model, q):
    """The similar-product scores and keep-mask of ``q`` (None: no known
    basket item)."""
    codes = known_codes(model.item_index, q.items)
    if not codes:
        return None
    full = model.norm_factors @ model.norm_factors[codes].mean(axis=0)
    mask = business_rule_mask(len(full), model.item_index, model.categories,
                              q.categories, q.white_list, q.black_list)
    mask[codes] = False
    return full, mask


def serve_and_check(engine, ep, models, bodies, query_cls, algo, cpu_model,
                    where):
    """``POST /queries.json`` of each body; each answer must equal
    ``algo.predict`` on the CPU copy of the blob (the same numpy on the
    same factors). Returns (answers, launches on the card, ms each)."""
    answers, launches, ms = serve_bodies(engine, ep, models, bodies)
    for k, (body, got) in enumerate(zip(bodies, answers)):
        want = algo.predict(cpu_model, params_from_dict(query_cls,
                                                        body)).to_dict()
        if got != want:
            raise AssertionError(f"{where} query {k}: {got} vs the CPU copy "
                                 f"{want}")
    return answers, launches, ms


def phase_sp_template(args, smi) -> dict:
    """Phase 19: the similar-product template end to end."""
    t_phase = time.monotonic()
    log(f"phase 19: templates.similarproduct end to end at MovieLens-100K's "
        f"shape: ingest, run_train (the template's defaults), "
        f"load_models_for_instance, {N_SP_HTTP} POST /queries.json, "
        f"batch_predict of {N_REC_BATCH}; {smi}")
    app_id = Storage.get_meta_data_apps().insert(App(0, SP_APP))
    t0 = time.monotonic()
    ingested = sp_events(args, app_id)
    ingest_s = time.monotonic() - t0
    variant = variant_from_dict({
        "id": "sp-chip-smoke", "engineFactory": "templates.similarproduct",
        "datasource": {"params": {"app_name": SP_APP}},
        "algorithms": [{"name": "als", "params": {}}],
    })
    engine, ep = build_engine(variant)
    ctx = ComputeContext.create(args.seed, device=CARD)
    t0 = time.monotonic()
    iid, train_launches = count_kernels(
        lambda: run_train(engine, ep, variant, ctx=ctx))
    train_s = time.monotonic() - t0
    inst = Storage.get_meta_data_engine_instances().get(iid)
    phases = {k: v for k, v in inst.env.items() if k.startswith("phase_")}
    log(f"  ingest {ingested['n']} events {ingest_s:.2f} s; run_train "
        f"{train_s:.2f} s (host clock, under the profiler), {train_launches} "
        f"launches; phases {json.dumps(phases)}; device {inst.env['device']}")
    if inst.env["device"] != str(CARD) or train_launches == 0:
        raise AssertionError("run_train did not train on the card")
    gpu = load_models_for_instance(iid, engine, ep, ctx)
    cpu = load_models_for_instance(
        iid, engine, ep, ComputeContext.local(args.seed, device="cpu"))
    model = gpu[0]
    unviewed = [model.item_index[f"new{k}"] for k in range(N_UNVIEWED)]
    if sorted(unviewed) != list(range(ML100K_ITEMS, ML100K_ITEMS + N_UNVIEWED)) \
            or model.norm_factors[unviewed].any():
        raise AssertionError("unviewed items are not zero rows at the end")
    # the same template trained on the CPU
    cpu_iid = run_train(engine, ep, variant,
                        ctx=ComputeContext.create(args.seed, device="cpu"))
    cpu_trained = load_models_for_instance(
        cpu_iid, engine, ep, ComputeContext.local(args.seed, device="cpu"))[0]
    err = float(np.abs(model.norm_factors - cpu_trained.norm_factors).max())
    log(f"  {len(model.item_index)} items ({N_UNVIEWED} unviewed: zero rows, "
        f"last); normalized item factors card vs CPU-trained: max |diff| "
        f"{err} (limit {ALS_FACTOR_TOL})")
    if err > ALS_FACTOR_TOL:
        raise AssertionError("the card's factors differ from the CPU's")

    inv = model.item_index.inverse
    items = [inv[c] for c in range(60)]  # the most viewed first
    bodies = [
        {"items": items[:1], "num": 10},
        {"items": items[1:3], "num": 10},
        {"items": items[3:6], "num": 20},
        {"items": items[6:7], "num": 10, "categories": ["Drama", "Comedy"]},
        {"items": items[7:9], "num": 5, "whiteList": items[:40],
         "blackList": items[9:13]},
        {"items": ["never-viewed-anywhere"], "num": 10},
        {"items": [items[13], "never-viewed-anywhere"], "num": 10,
         "blackList": items[:20], "categories": ["Film-Noir"]},
        {"items": items[14:15], "num": 60, "categories": ["Western"]},
    ]
    algo = SPAlgorithm(ep.algorithm_params_list[0][1])
    answers, http_launches, ms = serve_and_check(
        engine, ep, gpu, bodies, SPQuery, algo, cpu[0], "similar-product")
    sizes = [len(a["itemScores"]) for a in answers]
    log(f"  {N_SP_HTTP} answers equal the CPU copy of the blob (answer "
        f"sizes {sizes}); {http_launches} launches on the card (scoring is "
        f"host numpy, as in the reference); host clock ms per request "
        f"{rounded(ms)}")
    if sizes[5] != 0 or min(sizes[:5]) == 0:
        raise AssertionError("unexpected answer sizes")

    rng = np.random.default_rng(args.seed + 7)
    qs = []
    for k in range(N_REC_BATCH):
        basket = tuple(inv[int(c)] for c in rng.choice(
            ML100K_ITEMS, int(rng.integers(1, 4)), replace=False))
        cats = tuple(str(g) for g in rng.choice(GENRES, 2, replace=False)) \
            if k % 3 == 0 else ()
        qs.append((k, SPQuery(items=basket, num=10, categories=cats)))
    t0 = time.perf_counter()
    batch = dict(algo.batch_predict(model, qs))
    batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loop = {k: algo.predict(model, q) for k, q in qs}
    loop_ms = (time.perf_counter() - t0) * 1e3
    for k, q in qs:
        full, mask = sp_scores(model, q)
        for name, got in (("batch", batch[k]), ("loop", loop[k])):
            if not topn_ok(got.to_dict(), full, mask, q.num, model.item_index,
                           BATCH_TOL):
                raise AssertionError(f"similar-product {name} query {k}")
    log(f"  batch_predict of {N_REC_BATCH}: {batch_ms:.1f} ms; the predict "
        f"loop {loop_ms:.1f} ms (host clock); both the top-10 of the "
        f"model's scores within {BATCH_TOL}")
    log(f"  phase 19 {time.monotonic() - t_phase:.1f} s")
    return dict(train_s=train_s, train_launches=train_launches,
                http_ms=ms, batch_ms=batch_ms, loop_ms=loop_ms, items=items,
                last=ingested["last"], factor_err=err)


#: phase 20's predict loop: the first 126 of the batch's queries and its
#: two cold ones (the whole 1,024 at first, then 256; cut for the
#: script's time)
EC_LOOP_QUERIES = 128


def phase_ecomm_template(args, smi, sp) -> dict:
    """Phase 20: the e-commerce template end to end on phase 19's events."""
    t_phase = time.monotonic()
    log(f"phase 20: templates.ecommerce end to end on phase 19's events plus "
        f"{N_BUYS} buys and the unavailable-items constraint; {smi}")
    app_id = Storage.get_meta_data_apps().get_by_name(SP_APP).id
    items = sp["items"]
    rng = np.random.default_rng(args.seed + 6)
    t1 = sp["last"]
    bu = rng.integers(0, ML100K_USERS, N_BUYS)
    bi = (rng.random(N_BUYS) ** 2 * ML100K_ITEMS).astype(int)
    le = Storage.get_levents()
    Storage.get_pevents().write([
        Event("buy", "user", f"u{a}", "item", f"m{b}",
              event_time=t1 + dt.timedelta(seconds=k + 1))
        for k, (a, b) in enumerate(zip(bu.tolist(), bi.tolist()))], app_id)
    t2 = t1 + dt.timedelta(seconds=N_BUYS + 1)

    def set_unavailable(names, at):
        le.insert(Event("$set", "constraint", "unavailableItems",
                        properties={"items": list(names)}, event_time=at),
                  app_id)

    set_unavailable(items[:2], t2)
    variant = variant_from_dict({
        "id": "ecomm-chip-smoke", "engineFactory": "templates.ecommerce",
        "datasource": {"params": {"app_name": SP_APP}},
        "algorithms": [{"name": "ecomm", "params": {"app_name": SP_APP}}],
    })
    engine, ep = build_engine(variant)
    ctx = ComputeContext.create(args.seed, device=CARD)
    t0 = time.monotonic()
    iid, train_launches = count_kernels(
        lambda: run_train(engine, ep, variant, ctx=ctx))
    train_s = time.monotonic() - t0
    inst = Storage.get_meta_data_engine_instances().get(iid)
    if inst.env["device"] != str(CARD) or train_launches == 0:
        raise AssertionError("run_train did not train on the card")
    gpu = load_models_for_instance(iid, engine, ep, ctx)
    cpu = load_models_for_instance(
        iid, engine, ep, ComputeContext.local(args.seed, device="cpu"))
    model = gpu[0]
    cpu_iid = run_train(engine, ep, variant,
                        ctx=ComputeContext.create(args.seed, device="cpu"))
    cpu_trained = load_models_for_instance(
        cpu_iid, engine, ep, ComputeContext.local(args.seed, device="cpu"))[0]
    err, scale = factor_diff(model, cpu_trained)
    log(f"  run_train {train_s:.2f} s (host clock, under the profiler), "
        f"{train_launches} launches; factors card vs CPU-trained max |diff| "
        f"{err} (largest |factor| {scale}, limit {ALS_FACTOR_TOL} of it)")
    if err > ALS_FACTOR_TOL * scale:
        raise AssertionError("the card's factors differ from the CPU's")

    # a user the model never saw, with views since training
    for k, it in enumerate(items[20:23]):
        le.insert(Event("view", "user", "cold-shopper", "item", it,
                        event_time=t2 + dt.timedelta(seconds=k + 1)), app_id)
    users = [model.user_index.inverse[c] for c in range(8)]
    bodies = [
        {"user": users[0], "num": 10},
        {"user": users[1], "num": 10, "blackList": items[:5]},
        {"user": users[2], "num": 10, "categories": ["Drama", "Comedy"]},
        {"user": users[3], "num": 5, "whiteList": items[:30]},
        {"user": "cold-shopper", "num": 10},
        {"user": "nobody-at-all", "num": 10},
        {"user": users[4], "num": 20, "blackList": items[:50]},
        {"user": users[5], "num": 10, "categories": ["Horror"]},
    ]
    params = ep.algorithm_params_list[0][1]
    algo = ECommAlgorithm(params)
    answers, http_launches, ms = serve_and_check(
        engine, ep, gpu, bodies, ECQuery, algo, cpu[0], "e-commerce")
    sizes = [len(a["itemScores"]) for a in answers]
    unavailable = set(items[:2])
    for a in answers:
        if unavailable & {s["item"] for s in a["itemScores"]}:
            raise AssertionError("an unavailable item was served")
    if sizes[5] != 0 or sizes[4] == 0:
        raise AssertionError("the cold user was not answered from its views")
    log(f"  {N_SP_HTTP} answers equal the CPU copy (answer sizes {sizes}; "
        f"the cold user answered from its recent views, the unavailable "
        f"items left out); {http_launches} launches; host clock ms per "
        f"request {rounded(ms)}")

    # unseen_only: the same model served with the option on
    unseen = dataclasses.replace(params, unseen_only=True)
    ep_unseen = dataclasses.replace(ep, algorithm_params_list=(
        ("ecomm", unseen),))
    seen_bodies = [{"user": users[k], "num": 10} for k in range(3)] \
        + [{"user": "cold-shopper", "num": 10}]
    unseen_answers, _, _ = serve_and_check(
        engine, ep_unseen, gpu, seen_bodies, ECQuery, ECommAlgorithm(unseen),
        cpu[0], "e-commerce unseen_only")
    for body, a in zip(seen_bodies, unseen_answers):
        recent = set(algo._recent_items(model, body["user"], unseen.seen_events,
                                        unseen.num_recent_events))
        if recent & {s["item"] for s in a["itemScores"]} or not recent:
            raise AssertionError(f"unseen_only served a seen item: {body}")
    log(f"  unseen_only (the same model, the option on): {len(seen_bodies)} "
        f"answers equal the CPU copy and hold none of the user's recent "
        f"views or buys")

    # the constraint changed between two identical queries
    body = {"user": users[6], "num": 10}
    (first,), _, _ = serve_and_check(engine, ep, gpu, [body], ECQuery, algo,
                                     cpu[0], "before the constraint")
    top = first["itemScores"][0]["item"]
    set_unavailable([top], t2 + dt.timedelta(minutes=5))
    (second,), _, _ = serve_and_check(engine, ep, gpu, [body], ECQuery, algo,
                                      cpu[0], "after the constraint")
    after = [s["item"] for s in second["itemScores"]]
    if top in after or second == first:
        raise AssertionError("the constraint change did not take effect")
    log(f"  constraint set to [{top}] between two identical queries: the "
        f"first served it at the top, the second leaves it out (no retrain)")

    qs = [(k, ECQuery(user=model.user_index.inverse[k % len(model.user_index)],
                      num=10, categories=("Drama",) if k % 4 == 0 else ()))
          for k in range(N_REC_BATCH - 2)]
    qs += [(N_REC_BATCH - 2, ECQuery(user="cold-shopper", num=10)),
           (N_REC_BATCH - 1, ECQuery(user="nobody-at-all", num=10))]
    t0 = time.perf_counter()
    batch = dict(algo.batch_predict(model, qs))
    batch_ms = (time.perf_counter() - t0) * 1e3
    # the loop over the first EC_LOOP_QUERIES and the two cold queries
    # (each query ~18 ms of live reads: the whole batch's loop took 18 s)
    t0 = time.perf_counter()
    loop = {k: algo.predict(model, q)
            for k, q in qs[:EC_LOOP_QUERIES - 2] + qs[-2:]}
    loop_ms = (time.perf_counter() - t0) * 1e3
    snapshot = algo._unavailable_items(model)
    for k, q in qs:
        code = model.user_index.get(q.user)
        full = model.item_factors @ model.user_factors[code] \
            if code is not None else algo._cold_scores(model, q)
        for name, got in (("batch", batch[k]), ("loop", loop.get(k))):
            if got is None:
                continue
            if full is None:
                ok = got.item_scores == ()
            else:
                mask = business_rule_mask(len(full), model.item_index,
                                          model.categories, q.categories)
                for it in snapshot:
                    mask[model.item_index[it]] = False
                ok = topn_ok(got.to_dict(), full, mask, q.num,
                             model.item_index, BATCH_TOL)
            if not ok:
                raise AssertionError(f"e-commerce {name} query {k}")
    log(f"  batch_predict of {N_REC_BATCH}: {batch_ms:.1f} ms; the predict "
        f"loop over {len(loop)} of them {loop_ms:.1f} ms (host clock); both "
        f"the top-10 of the model's scores within {BATCH_TOL}")

    # what a query pays for its live reads (the memory store scans the
    # app's whole bucket on every find)
    n_events = len(le.find(app_id))
    q = ECQuery(user=users[0], num=10)
    times = {
        "predict (live constraint read)": median_ms(
            lambda: algo.predict(model, q), 21),
        "predict, constraint snapshot given": median_ms(
            lambda: algo._apply_rules(
                model, q, model.item_factors
                @ model.user_factors[model.user_index[q.user]], snapshot), 21),
        "constraint read alone": median_ms(
            lambda: algo._unavailable_items(model), 21),
        "recent views read alone": median_ms(
            lambda: algo._recent_items(model, q.user, ("view",), 10), 21),
        "cold-user predict (two live reads)": median_ms(
            lambda: algo.predict(model, ECQuery(user="cold-shopper")), 21),
    }
    log(f"  host clock ms a query, median of 21, {n_events} events in the "
        f"app's bucket: {json.dumps({k: round(v, 4) for k, v in times.items()})}")

    # the same live reads with EVENTDATA on SQLite (idx_events_entity)
    cold = ECQuery(user="cold-shopper")
    want = (algo.predict(model, q), algo.predict(model, cold))
    events = le.find(app_id)
    with sqlite_store(os.path.join(fresh_home("ecommerce"), "pio.db"),
                      repos=("EVENTDATA",)):
        t0 = time.monotonic()
        Storage.get_pevents().write(events, app_id)
        copy_s = time.monotonic() - t0
        if (algo.predict(model, q), algo.predict(model, cold)) != want:
            raise AssertionError("the live reads on SQLite answer otherwise")
        sqlite_times = {
            "predict (live constraint read)": median_ms(
                lambda: algo.predict(model, q), 21),
            "constraint read alone": median_ms(
                lambda: algo._unavailable_items(model), 21),
            "recent views read alone": median_ms(
                lambda: algo._recent_items(model, q.user, ("view",), 10), 21),
            "cold-user predict (two live reads)": median_ms(
                lambda: algo.predict(model, cold), 21),
        }
    log(f"  EVENTDATA on SQLite ({len(events)} events copied in "
        f"{copy_s:.2f} s), the same answers; host clock ms a query, median "
        f"of 21: {json.dumps({k: round(v, 4) for k, v in sqlite_times.items()})}"
        f" against the memory store's above")
    log(f"  phase 20 {time.monotonic() - t_phase:.1f} s")
    return dict(train_s=train_s, train_launches=train_launches, http_ms=ms,
                batch_ms=batch_ms, loop_ms=loop_ms, live=times,
                live_sqlite=sqlite_times, n_events=n_events, factor_err=err)


def compare_sweeps(name, out, tol) -> None:
    """Card against CPU: each point's score within ``tol``, and the same
    best params unless the two best points are within ``tol`` on a side."""
    card, cpu = out["card"], out["cpu"]
    diff = max(abs(a - b) for a, b in zip(card["scores"], cpu["scores"]))
    same = card["result"].best_index == cpu["result"].best_index
    near_tie = any(
        sorted(s["scores"])[-1] - sorted(s["scores"])[-2] <= tol
        for s in (card, cpu)) if len(card["scores"]) > 1 else False
    log(f"  {name}: card vs CPU max |score diff| {diff} (limit {tol}); same "
        f"best params: {same}" + ("" if same else f" (near tie: {near_tie})"))
    if diff > tol or not (same or near_tie):
        raise AssertionError(f"{name} on the card differs from the CPU's")


def run_sweep(name, ev, args) -> dict:
    """run_evaluation of ``ev`` on the card and on the CPU: seconds,
    scores, result."""
    out = {}
    for side, dev in (("card", CARD), ("cpu", torch.device("cpu"))):
        t0 = time.monotonic()
        res = run_evaluation(ev, ev.engine_params_generator,
                             ctx=ComputeContext.create(args.seed, device=dev))
        out[side] = dict(s=time.monotonic() - t0, result=res,
                         scores=[x.score for x in res.engine_params_scores])
        best = res.best_engine_params.algorithm_params_list[0][1]
        log(f"  {name} on the {side}: {out[side]['s']:.2f} s (host clock); "
            f"{res.metric_header} by params {out[side]['scores']}; best "
            f"{params_to_dict(best)}")
    return out


#: phase 21's grid: rank 16 alone (8 and 16 until PR 17; each point took
#: 10-15 s a sweep side, cut for the script's time)
SP_EVAL_RANKS = (16,)


def phase_sp_evaluation(args, smi) -> dict:
    """Phase 21: the similar-product and e-commerce sweeps, card and CPU."""
    t_phase = time.monotonic()
    log(f"phase 21: run_evaluation of similarproduct_evaluation and "
        f"ecommerce_evaluation on phase 19-20's events: 3 folds, rank "
        f"{SP_EVAL_RANKS}, 10 iterations, HitRate@10; {smi}")
    out = {}
    for name, ev in (
            ("similarproduct_evaluation", similarproduct_evaluation(
                SP_APP, eval_k=3, ranks=SP_EVAL_RANKS)),
            ("ecommerce_evaluation", ecommerce_evaluation(
                SP_APP, eval_k=3, ranks=SP_EVAL_RANKS))):
        out[name] = run_sweep(name, ev, args)
        compare_sweeps(name, out[name], HITRATE_TOL)
    log(f"  phase 21 {time.monotonic() - t_phase:.1f} s")
    return out


class _CountingTextPreparator(TextPreparator):
    """The template's preparator, counting its prepares and their time."""

    calls = 0
    seconds = 0.0

    def prepare(self, ctx, td):
        t0 = time.monotonic()
        out = super().prepare(ctx, td)
        type(self).calls += 1
        type(self).seconds += time.monotonic() - t0
        return out


class _FastEvalLog(logging.Handler):
    """Keeps the FastEval cache's (hits, misses) log line."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.counts = None

    def emit(self, record):
        if record.msg.startswith("FastEval cache"):
            self.counts = record.args


#: phase 22's folds on the card: 2 (was 3; cut for the script's time)
TEXT_EVAL_K = 2


def phase_text_evaluation(args, smi) -> dict:
    """Phase 22: the text-classification sweep on phase 9's corpus."""
    t_phase = time.monotonic()
    log(f"phase 22: run_evaluation of textclassification_evaluation on phase "
        f"9's corpus ({N_DOCS} documents): {TEXT_EVAL_K} folds, hidden (64, "
        f"128), on the card; {smi}")
    ev = textclassification_evaluation(APP, eval_k=TEXT_EVAL_K,
                                       hiddens=(64, 128))
    ev.engine.preparator_class = _CountingTextPreparator
    handler = _FastEvalLog()
    logger = logging.getLogger("pio_tpu_torch.evaluation")
    logger.addHandler(handler)
    old_level = logger.level
    logger.setLevel(logging.INFO)
    try:
        reset_counts()
        t0 = time.monotonic()
        res = run_evaluation(ev, ev.engine_params_generator,
                             ctx=ComputeContext.create(args.seed, device=CARD))
        torch.cuda.synchronize()
        sweep_s = time.monotonic() - t0
        launches = read_counts()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    acc = [x.score for x in res.engine_params_scores]
    hits, misses = handler.counts
    log(f"  sweep {sweep_s:.2f} s (host clock): {_CountingTextPreparator.calls}"
        f" prepares in {_CountingTextPreparator.seconds:.2f} s (one a fold), "
        f"FastEval cache {hits} hits / {misses} misses; accuracy by hidden "
        f"{acc}, best index {res.best_index}; kernel launches "
        f"{json.dumps(launches)}")
    if _CountingTextPreparator.calls != TEXT_EVAL_K:
        raise AssertionError("the sweep did not prepare once a fold")
    if not (launches["embedding_bag"] and
            launches["embedding_bag_backward_table"]):
        raise AssertionError("the sweep did not run the kernels")
    if not all(a > 1.5 / len(LABELS) for a in acc):
        raise AssertionError(f"accuracies {acc} near chance")

    # card against CPU on a tenth of the corpus, at one width and two
    # folds: the CPU side of both widths took 110 s on the H100 machine's
    # host, and both widths scored alike there; three folds took 27-41 s,
    # two keep the script's time as the neural phases join it
    src = Storage.get_meta_data_apps().get_by_name(APP).id
    docs = Storage.get_pevents().aggregate_properties(src, "content")
    app_id = Storage.get_meta_data_apps().insert(App(0, TEXT_TENTH_APP))
    Storage.get_levents().write([
        Event("$set", "content", f"doc{k}",
              properties={"text": docs[f"doc{k}"].get("text"),
                          "label": docs[f"doc{k}"].get("label")})
        for k in range(N_DOCS // 10)], app_id)
    tenth = textclassification_evaluation(TEXT_TENTH_APP, eval_k=2,
                                          hiddens=(64,))
    out = run_sweep(f"textclassification_evaluation, {N_DOCS // 10} "
                    f"documents", tenth, args)
    compare_sweeps("the tenth", out, ACCURACY_TOL)
    log(f"  phase 22 {time.monotonic() - t_phase:.1f} s")
    return dict(sweep_s=sweep_s, prepares=_CountingTextPreparator.calls,
                prepare_s=_CountingTextPreparator.seconds, hits=hits,
                misses=misses, acc=acc, launches=launches, tenth=out)


# ------------------------------------------------- the classification path
# bench.py:1570-1588 (BASELINE.md config #2), the classification template's
# logistic regression: 100,000 rows x 256 features, 10 classes, X ~ N(0, 1)
# and labels the argmax of X times a normal map, from default_rng(1); 100
# full-batch Adam steps at lr 0.05
LR_N, LR_D, LR_C, LR_ITERS, LR_RATE = 100_000, 256, 10, 100, 0.05
LR_MODES = ("int8", "float32", "bfloat16")
# card vs CPU after 100 f32 Adam steps from one init: gradients summed in
# another order (~1e-6 relative over 100,000 rows), and Adam divides by
# sqrt(v) + 1e-8, so near-zero gradients amplify it; the CPU tests measured
# 4e-6 of the largest weight at 256 rows: 1e-4 of it as the limit
LR_WEIGHT_RTOL = 1e-4
# bf16 and int8, card vs CPU: the bf16-rounded weight gradient may round one
# bf16 step apart and the runs part; held by train accuracy instead
LR_ACC_TOL = 0.005
# the resident scorer at full width
SCORER_BATCHES = (1, 8, 64, 512)
SCORER_CALLS = 200
# a code the card and the host mirror may disagree on, on the float32 wire:
# only where the mirror's top two logits lie within this (f32 rounding of a
# 256-term dot in another order, ~1e-6 of logits of O(10))
SCORER_TIE = 1e-4
# the int8 wire may flip a code only where quantization can: a feature's
# code is off by at most half its scale, so classes c and c' trade places
# only where their logits lie within sum_d s_d/2 |W[d,c] - W[d,c']| (plus
# SCORER_TIE); every other row must keep the mirror's code
# the template end to end: the reference benchmark's users (bench.py:489-
# 503: three plans, each user's plan attribute raised by 6) at 20,000 users
N_CLS_USERS = 20_000
CLS_APP = "classification-synthetic"
PLANS = ("basic", "premium", "pro")
N_CLS_HTTP = 8
# train_markov_chain: 4,096 states and 1,000,000 transitions of counts 1-3
MC_STATES, MC_TRANSITIONS, MC_TOP_K = 4096, 1_000_000, 10


def logreg_data(seed: int = 1):
    """A copy of bench.py's _bench_classification data."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(LR_N, LR_D)).astype(np.float32)
    w_true = rng.normal(size=(LR_D, LR_C))
    return X, np.argmax(X @ w_true, axis=1).astype(np.int32)


def logreg_step(X, y, dtype: str) -> dict:
    """One full-batch Adam step on the card: its kernels' device ms and
    launches (21 steps less one, so the wire's widening is not counted),
    and the bound of its two [N, D] x [D, C] products."""
    wire_scales = logreg.feature_scales(X) if dtype == "int8" else None
    wire = logreg.encode_wire(X, dtype, wire_scales).to(CARD)
    y_t = torch.from_numpy(y).to(CARD).long()
    mask = torch.ones(len(y), device=CARD)
    s = (torch.from_numpy(wire_scales).to(CARD)
         if wire_scales is not None else None)
    p0 = {k: v.to(CARD) for k, v in logreg.init_params(LR_D, LR_C, 0).items()}

    def fit(n):
        return logreg._fit(p0, wire, y_t, mask, s, logreg.LogRegConfig(
            iterations=n, learning_rate=LR_RATE))

    one, one_ms, _ = device_busy(lambda: fit(1), iters=3)
    many, many_ms, kernels = device_busy(lambda: fit(21), iters=3)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    n_bytes = wire.numel() * wire.element_size() + len(y) * 8 \
        + (LR_D * LR_C + LR_C) * 4 * 3
    return dict(ms=(many_ms - one_ms) / 20, launches=(many - one) / 20,
                top={k[:48]: round(v / 21, 5) for k, v in top},
                **bound_of(n_bytes, 4 * LR_N * LR_D * LR_C))


def phase_logreg(args, smi) -> dict:
    """Phase 23: train_logreg at BASELINE config #2's full width."""
    t_phase = time.monotonic()
    log(f"phase 23: train_logreg at the classification benchmark's width "
        f"({LR_N} x {LR_D}, {LR_C} classes, {LR_ITERS} steps, lr {LR_RATE}) "
        f"in {', '.join(LR_MODES)}; {smi}")
    X, y = logreg_data()
    card, cpu_ctx = (ComputeContext.local(args.seed, device=CARD),
                     ComputeContext.local(args.seed, device="cpu"))
    out, rows = {}, []
    for dtype in LR_MODES:
        cfg = logreg.LogRegConfig(iterations=LR_ITERS,
                                  learning_rate=LR_RATE, input_dtype=dtype)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            model = logreg.train_logreg(card, X, y, LR_C, cfg)
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        again = logreg.train_logreg(card, X, y, LR_C, cfg, stats=stats)
        peak = torch.cuda.max_memory_allocated()
        if not (np.array_equal(model.weights, again.weights)
                and np.array_equal(model.bias, again.bias)):
            raise AssertionError(f"train_logreg {dtype}: two runs differ")
        t0 = time.perf_counter()
        cpu = logreg.train_logreg(cpu_ctx, X, y, LR_C, cfg)
        cpu_s = time.perf_counter() - t0
        acc = float((model.predict(X) == y).mean())
        cpu_acc = float((cpu.predict(X) == y).mean())
        err = float(np.abs(model.weights - cpu.weights).max())
        scale = float(np.abs(cpu.weights).max())
        step = logreg_step(X, y, dtype)
        log(f"  {dtype}: wall {wall:.4f} s (median of 3: "
            f"{rounded(walls)}), {LR_N * LR_ITERS / wall:.4g} examples/s, "
            f"the card idle {1 - step['ms'] * LR_ITERS / 1e3 / stats['device_s']:.3f} "
            f"of device_s; "
            f"stats {json.dumps({k: (round(v, 5) if isinstance(v, float) else v) for k, v in stats.items()})}; "
            f"peak {peak} B; train accuracy {acc:.4f} (CPU {cpu_acc:.4f}, "
            f"{cpu_s:.2f} s); weights card vs CPU max |diff| {err} "
            f"(largest {scale}); the same bits twice; one step "
            f"{step['ms']:.5f} ms device, {step['launches']:.1f} launches, "
            f"bound {step['bound_ms']:.5f} ms ({step['bound_by']}); its "
            f"largest kernels, ms a step: {json.dumps(step['top'])}")
        if dtype == "float32" and err > LR_WEIGHT_RTOL * max(1.0, scale):
            raise AssertionError("f32 weights: the card differs from the CPU")
        if abs(acc - cpu_acc) > LR_ACC_TOL or acc < 0.8:
            raise AssertionError(f"{dtype} train accuracy {acc} vs CPU "
                                 f"{cpu_acc}")
        out[dtype] = dict(model=model, wall=wall, stats=stats, peak=peak,
                          acc=acc, cpu_acc=cpu_acc, err=err, step=step)
        rows.append(program_row(
            f"logreg step ({dtype})", "pio_tpu/models/logreg.py:49-84",
            [LR_N, LR_D, LR_C], step["launches"], step["ms"], step,
            err if dtype == "float32" else None))
    log(f"  phase 23 {time.monotonic() - t_phase:.1f} s")
    return dict(modes=out, rows=rows, X=X, y=y)


def phase_nb_dense(args, smi, lr) -> list:
    """Phase 24: train_multinomial_nb at the same N x D, |X| as features."""
    t_phase = time.monotonic()
    log(f"phase 24: train_multinomial_nb at {LR_N} x {LR_D}, {LR_C} classes "
        f"(|X| as features); {smi}")
    X, y = np.abs(lr["X"]), lr["y"]

    def train():
        return naive_bayes.train_multinomial_nb(X, y, LR_C, device=CARD)

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    nb = train()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    if peak < X.nbytes:
        raise AssertionError("train_multinomial_nb did not run on the card")
    again = train()
    if not (np.array_equal(nb.log_theta.view(np.uint32),
                           again.log_theta.view(np.uint32))
            and np.array_equal(nb.log_prior, again.log_prior)):
        raise AssertionError("train_multinomial_nb: two runs differ")
    cpu = naive_bayes.train_multinomial_nb(X, y, LR_C, device="cpu")
    err = float(max(np.abs(nb.log_theta - cpu.log_theta).max(),
                    np.abs(nb.log_prior - cpu.log_prior).max()))
    X_t, y_t = torch.from_numpy(X).to(CARD), torch.from_numpy(y).to(CARD)
    classes = torch.arange(LR_C, dtype=torch.int32, device=CARD)[:, None]
    sums_launches, sums_ms, _ = device_busy(
        lambda: (classes == y_t[None, :]).float() @ X_t, iters=20)
    bnd = bound_of(X.nbytes + y.nbytes + LR_C * LR_D * 4,
                   2 * LR_C * LR_N * LR_D)
    log(f"  {wall * 1e3:.2f} ms (host clock), peak {peak} B on the card "
        f"over what was there; "
        f"the same bits twice; card vs CPU max |diff| "
        f"{err} (limit {NB_TOL}); per-class sums (one-hot product) "
        f"{sums_ms:.5f} ms device, bound {bnd['bound_ms']:.5f} ms "
        f"({bnd['bound_by']})")
    if err > NB_TOL:
        raise AssertionError("NB on the card differs from the CPU's")
    log(f"  phase 24 {time.monotonic() - t_phase:.1f} s")
    return [program_row("NB per-class sums", "pio_tpu/models/naive_bayes.py:266-277",
                        [LR_C, LR_N, LR_D], sums_launches, sums_ms, bnd, err)]


def phase_resident_scorer(args, smi, lr) -> list:
    """Phase 25: the resident scorer at full width on phase 23's int8
    model, both wires."""
    t_phase = time.monotonic()
    log(f"phase 25: ResidentLinearScorer on phase 23's int8 model (D "
        f"{LR_D}, C {LR_C}) at batches {SCORER_BATCHES}, both wires, "
        f"{SCORER_CALLS} calls each after warmup; {smi}")
    model, X = lr["modes"]["int8"]["model"], lr["X"]
    rows = []
    for wire in ("int8", "float32"):
        with knob("PIO_TPU_SERVE_WIRE", wire):
            sc = residency.ResidentLinearScorer(
                model.weights, model.bias, scales=model.feature_scales,
                name="logreg", device=CARD)
        sc.prealloc(SCORER_BATCHES)
        for B in SCORER_BATCHES:
            xb = X[:B]
            for _ in range(10):
                sc.score_codes(xb)
            h2d0, calls0 = sc.h2d_bytes, sc.dispatches
            host = []
            for _ in range(SCORER_CALLS):
                t0 = time.perf_counter()
                sc.score_codes(xb)
                host.append((time.perf_counter() - t0) * 1e3)
            per_req = (sc.h2d_bytes - h2d0) // (sc.dispatches - calls0)
            mirror = [host_ms(lambda: model.predict(xb))
                      for _ in range(SCORER_CALLS)]
            x_dev = torch.from_numpy(sc.encode(xb)).to(CARD)
            buf = torch.empty((B, LR_C), device=CARD)
            _, dev_ms, _ = device_busy(lambda: torch.argmax(torch.addmm(
                sc._b_dev, x_dev.float(), sc._w_dev, out=buf), dim=1),
                iters=SCORER_CALLS)
            log(f"  {wire} B={B}: device {dev_ms:.5f} ms, host "
                f"{np.median(host):.4f} ms a call (median of "
                f"{SCORER_CALLS}); host numpy mirror "
                f"{np.median(mirror):.4f} ms; h2d {per_req} B a request")
            if per_req != B * LR_D * (1 if wire == "int8" else 4):
                raise AssertionError("h2d bytes off the wire's size")
        # codes over every training row, in batches of the largest bucket
        B = SCORER_BATCHES[-1]
        got = np.concatenate([sc.score_codes(X[k:k + B])
                              for k in range(0, LR_N, B)])
        logits = model.logits(X)
        want = logits.argmax(axis=1)
        margin = logits[np.arange(LR_N), want][:, None] - logits
        if wire == "int8":
            W = model.weights
            pair = (model.feature_scales[:, None, None] / 2 * np.abs(
                W[:, :, None] - W[:, None, :])).sum(axis=0)  # [C, C]
            margin = margin - pair[want]
        margin[np.arange(LR_N), want] = np.inf
        clear = margin.min(axis=1) > SCORER_TIE
        differ = got != want
        d = sc.to_dict()
        hit_rate = d["donation"]["hitRate"]
        log(f"  {wire}: codes of {LR_N} rows against the host mirror: "
            f"{int(differ.sum())} differ ({differ.mean():.5f}), "
            f"{int((differ & clear).sum())} of them where the wire cannot "
            f"flip a code ({int(clear.sum())} such rows); hit "
            f"rate {hit_rate}; {json.dumps(d)}")
        if hit_rate < 0.95:
            raise AssertionError(f"hit rate {hit_rate} below 0.95")
        if (differ & clear).any():
            raise AssertionError(f"{wire} wire: codes differ from the mirror")
        if wire == "int8":
            x_dev = torch.from_numpy(sc.encode(X[:B])).to(CARD)
            buf = torch.empty((B, LR_C), device=CARD)

            def dispatch():
                return torch.argmax(torch.addmm(
                    sc._b_dev, x_dev.float(), sc._w_dev, out=buf), dim=1)

            _, ms, _ = device_busy(dispatch, iters=SCORER_CALLS)
            launches, _, _ = device_busy(lambda: sc.score_codes(X[:B]),
                                         iters=20)
            dispatch()
            ref = sc.encode(X[:B]).astype(np.float32) @ (
                model.feature_scales[:, None] * model.weights) + model.bias
            err = float(np.abs(buf.cpu().numpy() - ref).max())
            rows.append(program_row(
                "resident scorer (int8 wire, B=512)",
                "pio_tpu/server/residency.py:155-168", [B, LR_D, LR_C],
                launches, ms, bound_of(B * LR_D + (LR_D + 1) * LR_C * 4
                                       + B * 4, 2 * B * LR_D * LR_C), err))
        sc.retire()
    log(f"  phase 25 {time.monotonic() - t_phase:.1f} s")
    return rows


def cls_events(args, app_id) -> int:
    """N_CLS_USERS $set users as bench.py:489-503 makes them."""
    rng = np.random.default_rng(args.seed + 9)
    t0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    events = []
    for n in range(N_CLS_USERS):
        hot = n % 3
        attrs = rng.integers(0, 3, size=3)
        attrs[hot] += 6
        props = {f"attr{j}": int(attrs[j]) for j in range(3)}
        props["plan"] = PLANS[hot]
        events.append(Event("$set", "user", f"u{n}", properties=props,
                            event_time=t0 + dt.timedelta(seconds=n)))
    Storage.get_pevents().write(events, app_id)
    return len(events)


def phase_cls_template(args, smi) -> dict:
    """Phase 26: the classification template end to end."""
    t_phase = time.monotonic()
    log(f"phase 26: templates.classification end to end: {N_CLS_USERS} $set "
        f"users, run_train of naivebayes and logreg on the card, the query "
        f"server with the resident scorer placed, {N_CLS_HTTP} POST "
        f"/queries.json on each wire, batch_predict of 1024, "
        f"classification_evaluation card vs CPU; {smi}")
    app_id = Storage.get_meta_data_apps().insert(App(0, CLS_APP))
    t0 = time.monotonic()
    n_events = cls_events(args, app_id)
    log(f"  ingest {n_events} events {time.monotonic() - t0:.2f} s")
    rng = np.random.default_rng(args.seed + 10)
    bodies = [{"attr0": int(a), "attr1": int(b), "attr2": int(c)}
              for a, b, c in rng.integers(0, 9, size=(N_CLS_HTTP - 2, 3))]
    bodies += [{"attrs": [8.0, 1.0, 0.5]}, {"attrs": [0.0, 0.0, 0.0]}]
    out = {}
    for algo_name, params in (("naivebayes", {}),
                              ("logreg", {"iterations": 100,
                                          "learning_rate": 0.1})):
        variant = variant_from_dict({
            "id": f"cls-{algo_name}", "engineFactory":
                "templates.classification",
            "datasource": {"params": {"app_name": CLS_APP}},
            "algorithms": [{"name": algo_name, "params": params}]})
        engine, ep = build_engine(variant)
        ctx = ComputeContext.create(args.seed, device=CARD)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        iid = run_train(engine, ep, variant, ctx=ctx)
        train_s = time.monotonic() - t0
        inst = Storage.get_meta_data_engine_instances().get(iid)
        # the features' bytes went to the card: the training ran there
        grew = torch.cuda.max_memory_allocated() - before
        if inst.env["device"] != str(CARD) or grew < N_CLS_USERS * 3 * 4:
            raise AssertionError("run_train did not train on the card")
        cpu_ctx = ComputeContext.local(args.seed, device="cpu")
        for wire in ("int8", "float32"):
            with knob("PIO_TPU_SERVE_WIRE", wire):
                gpu = load_models_for_instance(iid, engine, ep, ctx)
                cpu = load_models_for_instance(iid, engine, ep, cpu_ctx)
                with knob("PIO_TPU_DEVICE_RESIDENT", "1"):
                    mirror = QueryService(engine, ep, cpu, device="cpu")
                server = create_query_server(engine, ep, gpu, port=0,
                                             device=CARD)
            scorer = gpu[0]._resident
            if scorer.wire != wire or scorer.device.type != CARD.type:
                raise AssertionError("the scorer is not placed on the card")
            ms = []
            with server:
                conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                                  timeout=60)
                answers = []
                for body in bodies:
                    t = time.perf_counter()
                    status, got = post(conn, json.dumps(body).encode())
                    ms.append((time.perf_counter() - t) * 1e3)
                    if status != 200:
                        raise AssertionError(f"{body}: HTTP {status}")
                    answers.append(got)
                conn.request("GET", "/stats.json")
                block = json.loads(conn.getresponse().read())["residency"]
                conn.close()
                for body, got in zip(bodies, answers):
                    want = mirror.query(json.dumps(body).encode())
                    if got != want:
                        raise AssertionError(f"{algo_name} {wire} {body}: "
                                             f"{got} vs the CPU copy {want}")
                algo = engine._algorithms(ep)[0]
                qs = [(k, CLSQuery(attrs=tuple(float(v) for v in row)))
                      for k, row in enumerate(rng.integers(0, 9, (1024, 3)))]
                t0 = time.perf_counter()
                batch = dict(algo.batch_predict(gpu[0], qs))
                batch_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                loop = {k: algo.predict(gpu[0], q) for k, q in qs}
                loop_ms = (time.perf_counter() - t0) * 1e3
                cpu_batch = dict(algo.batch_predict(mirror.pairs[0][1], qs))
                if batch != loop or batch != cpu_batch:
                    raise AssertionError("batch_predict differs from the "
                                         "loop or the CPU copy")
            mirror.close()
            (entry,) = block["scorers"]
            log(f"  {algo_name}, {wire} wire: run_train {train_s:.2f} s; "
                f"{N_CLS_HTTP} answers equal the CPU copy, host clock ms per "
                f"request {rounded(ms)}; /stats.json residency: enabled "
                f"{block['enabled']}, paramBytes {block['paramBytes']}, "
                f"measuredBytes {block['measuredBytes']}, hits "
                f"{entry['donation']['hits']} misses "
                f"{entry['donation']['misses']}, h2dBytes "
                f"{entry['h2dBytes']}; batch_predict of 1024 "
                f"{batch_ms:.2f} ms, the loop {loop_ms:.1f} ms, both equal "
                f"the CPU copy")
            # the scorer on the card counted every request's dispatch
            if not block["enabled"] or entry["dispatches"] != N_CLS_HTTP \
                    or not block["measuredBytes"]:
                raise AssertionError("the served path did not dispatch on "
                                     "the card")
            if not scorer.retired or "_resident" in vars(gpu[0]):
                raise AssertionError("close() did not retire the scorer")
            out[(algo_name, wire)] = dict(ms=ms, batch_ms=batch_ms,
                                          loop_ms=loop_ms)
    ev = classification_evaluation(CLS_APP, eval_k=3)
    out["sweep"] = run_sweep("classification_evaluation", ev, args)
    compare_sweeps("classification_evaluation", out["sweep"], 1e-6)
    log(f"  phase 26 {time.monotonic() - t_phase:.1f} s")
    return out


def phase_markov(args, smi) -> list:
    """Phase 27: train_markov_chain at 4,096 states, 1,000,000 transitions."""
    t_phase = time.monotonic()
    log(f"phase 27: train_markov_chain, {MC_STATES} states, "
        f"{MC_TRANSITIONS} transitions (counts 1-3), top {MC_TOP_K}; {smi}")
    rng = np.random.default_rng(args.seed + 11)
    tr = np.stack([rng.integers(0, MC_STATES, MC_TRANSITIONS),
                   (rng.random(MC_TRANSITIONS) ** 2 * MC_STATES).astype(int),
                   rng.integers(1, 4, MC_TRANSITIONS)], axis=1).tolist()
    times = {}
    for side, dev in (("card", CARD), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        times[side] = markov_chain.train_markov_chain(tr, MC_STATES,
                                                      MC_TOP_K, device=dev)
        times[side + "_s"] = time.perf_counter() - t0
    card, cpu = times["card"], times["cpu"]
    err = float(np.abs(card.top_probs - cpu.top_probs).max())
    same = np.array_equal(card.top_indices, cpu.top_indices)
    counts = torch.zeros((MC_STATES, MC_STATES), device=CARD)
    counts.view(-1)[torch.from_numpy(rng.integers(0, MC_STATES ** 2,
                                                  MC_TRANSITIONS)).to(CARD)] = 1.0
    launches, ms, _ = device_busy(
        lambda: markov_chain.normalize_topk(counts, MC_TOP_K), iters=10)
    bnd = bound_of(MC_STATES * MC_STATES * 4 + MC_STATES * MC_TOP_K * 8,
                   2 * MC_STATES * MC_STATES)
    log(f"  card {times['card_s']:.3f} s, CPU {times['cpu_s']:.3f} s (host "
        f"clock, the host's count matrix included); the same indices "
        f"{same}, probabilities max |diff| {err}; normalize + pinned top-k "
        f"{ms:.5f} ms device, {launches} launches, bound "
        f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']})")
    if not same or err > 1e-6:
        raise AssertionError("the Markov chain on the card differs")
    log(f"  phase 27 {time.monotonic() - t_phase:.1f} s")
    return [program_row("Markov normalize + top-k",
                        "pio_tpu/models/markov_chain.py:77-83",
                        [MC_STATES, MC_STATES, MC_TOP_K], launches, ms, bnd,
                        err)]


# ------------------------------------------------ the port's CLI (phases 28-29)
ROOT = os.path.dirname(os.path.abspath(__file__))
#: each CLI phase's $PIO_TPU_HOME, made afresh under the gitignored build/
CLI_HOMES = os.path.join(ROOT, "build", "chip_smoke_homes")
#: time limit of one CLI subprocess, and of a server coming up
CLI_TIMEOUT_S = 300
N_QS_HTTP = 20
N_QS_BATCH = 1024
QS_BATCH = 50  # the event server's MAX_BATCH
QS_SINGLE_EVERY = 1000  # one POST /events.json per this many events
QS_APP, QS_COPY = "quickstart", "quickstart-copy"


def fresh_home(name: str) -> str:
    home = os.path.join(CLI_HOMES, name)
    shutil.rmtree(home, ignore_errors=True)
    os.makedirs(home)
    return home


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_env(home: str) -> dict:
    """The environment of a CLI subprocess: the quickstart defaults (no
    PIO_STORAGE_*: SQLite at ``home``/pio.db, models under ``home``/models)
    and the default durability."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_") and k != "PIO_TPU_DURABILITY"}
    env.update(PIO_TPU_HOME=home, PYTHONPATH=ROOT)
    return env


def cli_started(env: dict, *args):
    """``python -m pio_tpu_torch <args>`` started: a function that waits
    for its end and returns (stdout, wall s from the start). A non-zero
    exit fails the phase."""
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def ended() -> tuple:
        try:
            out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        wall = time.monotonic() - t0
        if proc.returncode != 0:
            raise AssertionError(f"pio {' '.join(args)} exited "
                                 f"{proc.returncode}:\n{out[-2000:]}\n"
                                 f"{err[-4000:]}")
        return out, wall

    return ended


def cli(env: dict, *args) -> tuple:
    """``python -m pio_tpu_torch <args>`` to its end: (stdout, wall s).
    A non-zero exit fails the phase."""
    return cli_started(env, *args)()


@contextlib.contextmanager
def cli_server(env: dict, home: str, *args):
    """A server verb as a subprocess, its output in ``home``/<verb>.log;
    killed on the way out if it is still running."""
    log_path = os.path.join(home, f"{args[0]}.log")
    with open(log_path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch", *args], cwd=ROOT, env=env,
            stdout=f, stderr=subprocess.STDOUT)
    try:
        yield proc
    except BaseException:
        with open(log_path) as f:
            log(f"  {args[0]} log, last lines:\n{f.read()[-3000:]}")
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)


def wait_alive(port: int, proc=None) -> dict:
    """``GET /`` until the server answers (or its process exits)."""
    deadline = time.monotonic() + CLI_TIMEOUT_S
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"the server exited with {proc.returncode}")
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("GET", "/")
            got = json.loads(conn.getresponse().read())
            conn.close()
            return got
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"no server on port {port} after {CLI_TIMEOUT_S} s")


def request(conn, method: str, path: str, body=None):
    """(status, decoded JSON) of one request on ``conn``."""
    data = body if body is None or isinstance(body, bytes) \
        else json.dumps(body).encode()
    conn.request(method, path, data, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def rate_bodies(seed: int) -> list:
    """MovieLens-100K's shape as wire events (phase 13's generator)."""
    u, i, r = synth_ratings(ML100K_EDGES, ML100K_USERS, ML100K_ITEMS, seed,
                            "int")
    t0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    return [
        {"event": "rate", "entityType": "user", "entityId": f"u{a}",
         "targetEntityType": "item", "targetEntityId": f"i{b}",
         "properties": {"rating": float(c)},
         "eventTime": (t0 + dt.timedelta(seconds=k)).isoformat()}
        for k, (a, b, c) in enumerate(zip(u.tolist(), i.tolist(), r.tolist()))
    ]


def ingest(port: int, key: str, bodies: list) -> dict:
    """Every body through the event server on one keep-alive connection:
    one ``POST /events.json`` per QS_SINGLE_EVERY events, the rest in
    ``/batch/events.json`` requests of QS_BATCH. Host clock ms a request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    batch_ms, single_ms = [], []
    t0 = time.perf_counter()
    for start in range(0, len(bodies), QS_SINGLE_EVERY):
        chunk = bodies[start:start + QS_SINGLE_EVERY]
        t = time.perf_counter()
        status, got = request(conn, "POST", f"/events.json?accessKey={key}",
                              chunk[0])
        single_ms.append((time.perf_counter() - t) * 1e3)
        if status != 201:
            raise AssertionError(f"single event: HTTP {status} {got}")
        for b in range(1, len(chunk), QS_BATCH):
            t = time.perf_counter()
            status, got = request(conn, "POST",
                                  f"/batch/events.json?accessKey={key}",
                                  chunk[b:b + QS_BATCH])
            batch_ms.append((time.perf_counter() - t) * 1e3)
            if status != 200 or any(r["status"] != 201 for r in got):
                raise AssertionError(f"batch: HTTP {status} {got[:3]}")
    wall = time.perf_counter() - t0
    conn.close()
    return {"events": len(bodies), "wall_s": wall,
            "events_per_s": len(bodies) / wall,
            "batch_requests": len(batch_ms), "single_requests": len(single_ms),
            "batch_ms_p50": float(np.percentile(batch_ms, 50)),
            "batch_ms_p99": float(np.percentile(batch_ms, 99)),
            "single_ms_p50": float(np.percentile(single_ms, 50))}


def check_error_codes(port: int, key: str, body: dict) -> list:
    """The reference's status codes on bad requests."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    ev = f"/events.json?accessKey={key}"
    cases = [
        ("POST", f"/batch/events.json?accessKey={key}", [body] * 51, 400),
        ("POST", "/events.json", body, 401),
        ("POST", "/events.json?accessKey=nope", body, 401),
        ("POST", ev, b"{not json", 400),
        ("POST", ev, {**body, "eventTime": "yesterday"}, 400),
        ("POST", ev + "&channel=nope", body, 400),
        ("GET", f"/events/nope.json?accessKey={key}", None, 404),
        ("GET", ev + "&limit=3", None, 200),
    ]
    got = []
    for method, path, b, want in cases:
        status, answer = request(conn, method, path, b)
        if status != want:
            raise AssertionError(f"{method} {path}: HTTP {status} {answer}, "
                                 f"want {want}")
        got.append(status)
    conn.close()
    return got


@contextlib.contextmanager
def sqlite_store(path: str, repos=("METADATA", "EVENTDATA")):
    """The script's own storage pointed at the SQLite file ``path`` for
    ``repos`` inside the block (the other repositories stay as they were)."""
    with contextlib.ExitStack() as stack:
        for repo in repos:
            stack.enter_context(
                knob(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "CHIPSQ"))
        stack.enter_context(knob("PIO_STORAGE_SOURCES_CHIPSQ_TYPE", "sqlite"))
        stack.enter_context(knob("PIO_STORAGE_SOURCES_CHIPSQ_PATH", path))
        yield


@contextlib.contextmanager
def cli_store(home: str):
    """The script's own storage on the CLI's quickstart defaults under
    ``home`` inside the block: SQLite at pio.db, models under models/."""
    with sqlite_store(os.path.join(home, "pio.db")), \
            knob("PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE", "CHIPFS"), \
            knob("PIO_STORAGE_SOURCES_CHIPFS_TYPE", "localfs"), \
            knob("PIO_STORAGE_SOURCES_CHIPFS_PATH", os.path.join(home, "models")):
        yield


def phase_cli_quickstart(args, smi) -> dict:
    """Phase 28: the README quickstart through ``python -m pio_tpu_torch``,
    each verb a subprocess, on SQLite under a fresh $PIO_TPU_HOME."""
    t_phase = time.monotonic()
    log(f"phase 28: the recommendation quickstart through the CLI (each verb "
        f"a process; SQLite, durability at its default): app new, "
        f"eventserver, {ML100K_EDGES} rate events, export/import, train, "
        f"deploy, {N_QS_HTTP} queries, batchpredict of {N_QS_BATCH}, status, "
        f"undeploy; {smi}")
    home = fresh_home("quickstart")
    env = cli_env(home)
    db = os.path.join(home, "pio.db")
    walls = {}
    out, walls["app new"] = cli(env, "app", "new", QS_APP)
    key = re.search(r"Access key: (\S+)", out).group(1)
    bodies = rate_bodies(args.seed + 28)
    es_port = free_port()
    with cli_server(env, home, "eventserver", "--ip", "127.0.0.1",
                    "--port", str(es_port)) as es:
        t0 = time.monotonic()
        wait_alive(es_port, es)
        walls["eventserver up"] = time.monotonic() - t0
        stats = ingest(es_port, key, bodies)
        codes = check_error_codes(es_port, key, bodies[0])
    walls["ingest"] = stats["wall_s"]
    log(f"  ingest over HTTP: {json.dumps(stats)}; bad requests answered "
        f"{codes}")

    # export, app new and import of the copy touch the second app alone:
    # they run on a thread beside train, deploy and the queries, and are
    # checked after them
    exported = os.path.join(home, "export.jsonl")
    copied = {}

    def copy_app():
        try:
            out, copied["export"] = cli(env, "export", "--app", QS_APP,
                                        "--output", exported)
            if f"Exported {ML100K_EDGES} events" not in out:
                raise AssertionError(f"export: {out}")
            _, copied["app new (copy)"] = cli(env, "app", "new", QS_COPY)
            out, copied["import"] = cli(env, "import", "--app", QS_COPY,
                                        "--input", exported)
            if f"Imported {ML100K_EDGES} events (0 failed)" not in out:
                raise AssertionError(f"import: {out}")
        except BaseException as e:
            copied["error"] = e

    copier = threading.Thread(target=copy_app, daemon=True)
    copier.start()
    try:
        iid, queries, answers, ms, ppath, card, variant_dict = \
            quickstart_serve(args, env, home, db, walls)
    finally:
        copier.join()
    if "error" in copied:
        raise copied.pop("error")
    walls.update(copied)
    with sqlite_store(db):
        apps = Storage.get_meta_data_apps()
        le = Storage.get_levents()
        a, b = (apps.get_by_name(n).id for n in (QS_APP, QS_COPY))
        orig, copy = ([e.to_api_dict() for e in le.find(app)] for app in (a, b))
    if orig != copy or len(orig) != ML100K_EDGES:
        raise AssertionError("the imported copy differs from the app")
    log(f"  export -> import into a second app (beside train and deploy): "
        f"{len(copy)} events, find equal event for event")
    log(f"  {N_QS_HTTP} POST /queries.json through the CLI-deployed server: "
        f"host clock ms per request {rounded(ms)} (median "
        f"{np.median(ms):.3f}); status lists {card} and all-OK storage")
    quickstart_check(args, home, iid, queries, answers, ppath, variant_dict)
    log(f"  wall s a verb (host clock, process start to exit; export, app "
        f"new (copy) and import beside train and deploy, status beside "
        f"batchpredict): "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}")
    log(f"  phase 28 {time.monotonic() - t_phase:.1f} s; {smi}")
    return dict(walls=walls, ingest=stats, query_ms=ms)


def quickstart_serve(args, env, home, db, walls) -> tuple:
    """Phase 28's train, deploy, queries, batchpredict and status beside
    it, and undeploy, each verb a process."""
    ej = os.path.join(home, "engine.json")
    variant_dict = {
        "id": "quickstart", "engineFactory": "templates.recommendation",
        "datasource": {"params": {"app_name": QS_APP}},
        "algorithms": [{"name": "als",
                        "params": {**ALS_PARAMS, "seed": args.seed}}],
    }
    with open(ej, "w") as f:
        json.dump(variant_dict, f)
    out, walls["train"] = cli(env, "train", "--engine-json", ej)
    iid = re.search(r"engine instance (\w+)", out).group(1)
    with sqlite_store(db):
        inst = Storage.get_meta_data_engine_instances().get(iid)
    phases = {k: v for k, v in inst.env.items() if k.startswith("phase_")}
    log(f"  train: instance {iid} on {inst.env['device']}; train_seconds "
        f"{inst.env['train_seconds']}; phases {json.dumps(phases)}")
    if not inst.env["device"].startswith("cuda"):
        raise AssertionError("pio train did not train on the card")

    queries = [{"user": f"u{k}", "num": 10} for k in range(12)] + [
        {"user": "u20", "num": 10, "blackList": [f"i{k}" for k in range(5)]},
        {"user": "u21", "item": "i7"}, {"user": "stranger", "num": 10},
        {"user": "u22", "num": 0}, {"user": "u23", "num": 40},
        {"user": "u24", "num": 5, "blackList": [f"i{k}" for k in range(50)]},
        {"user": "u25"}, {"user": "u26", "num": 1}]
    qs_port = free_port()
    with cli_server(env, home, "deploy", "--engine-json", ej, "--ip",
                    "127.0.0.1", "--port", str(qs_port)) as qs:
        t0 = time.monotonic()
        status = wait_alive(qs_port, qs)
        walls["deploy up"] = time.monotonic() - t0
        if status["engineInstanceId"] != iid:
            raise AssertionError(f"deploy serves {status}")
        conn = http.client.HTTPConnection("127.0.0.1", qs_port, timeout=60)
        answers, ms = [], []
        for body in queries:
            t = time.perf_counter()
            code, got = request(conn, "POST", "/queries.json", body)
            ms.append((time.perf_counter() - t) * 1e3)
            if code != 200:
                raise AssertionError(f"query {body}: HTTP {code} {got}")
            answers.append(got)
        conn.close()
        qpath = os.path.join(home, "queries.jsonl")
        with open(qpath, "w") as f:
            for k in range(N_QS_BATCH):
                f.write(json.dumps({"user": f"u{k % ML100K_USERS}",
                                    "num": 10}) + "\n")
        ppath = os.path.join(home, "predictions.jsonl")
        status_ended = cli_started(env, "status")
        try:
            _, walls["batchpredict"] = cli(env, "batchpredict",
                                           "--engine-json", ej, "--input",
                                           qpath, "--output", ppath)
        finally:
            out, walls["status"] = status_ended()
        card = f"cuda:0 {torch.cuda.get_device_name(0)}"
        if card not in out or "(sanity check passed)" not in out \
                or out.count("  OK  ") != 8:
            raise AssertionError(f"status: {out}")
        out, walls["undeploy"] = cli(env, "undeploy", "--port", str(qs_port))
        t0 = time.monotonic()
        code = qs.wait(timeout=60)
        walls["deploy exit after undeploy"] = time.monotonic() - t0
        if "undeployed" not in out or code != 0:
            raise AssertionError(f"undeploy: {out}; deploy exited {code}")
    return iid, queries, answers, ms, ppath, card, variant_dict


def quickstart_check(args, home, iid, queries, answers, ppath,
                     variant_dict) -> None:
    """Phase 28's answers and factors against CPU copies, in this
    process, from the same files."""
    with cli_store(home):
        n_read = len(PEventStore.find(QS_APP))
        engine, ep = build_engine(variant_from_dict(variant_dict))
        cpu_ctx = ComputeContext.local(args.seed, device="cpu")
        (blob,) = load_models_for_instance(iid, engine, ep, cpu_ctx)
        with knob("PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE", "MEM"):
            cpu_iid = run_train(engine, ep, variant_from_dict(variant_dict),
                                ctx=ComputeContext.create(args.seed,
                                                          device="cpu"))
            (trained,) = load_models_for_instance(cpu_iid, engine, ep, cpu_ctx)
    if n_read != ML100K_EDGES:
        raise AssertionError(f"PEventStore read {n_read} events")
    err, scale = factor_diff(*(
        als.ALSFactors(m.factors.user_factors.numpy(),
                       m.factors.item_factors.numpy()) for m in (blob, trained)))
    log(f"  factors of pio train on the card vs run_train on the CPU over "
        f"the {n_read} events read back through PEventStore: max |diff| "
        f"{err} (largest |factor| {scale}, limit {ALS_FACTOR_TOL} of it)")
    if err > ALS_FACTOR_TOL * scale:
        raise AssertionError("the CLI-trained factors differ from the CPU's")
    for k, (body, got) in enumerate(zip(queries, answers)):
        check_served(got, params_from_dict(RecQuery, body), blob,
                     f"CLI query {k}")
    with open(ppath) as f:
        lines = [json.loads(line) for line in f]
    if len(lines) != N_QS_BATCH:
        raise AssertionError(f"batchpredict wrote {len(lines)} lines")
    for k, line in enumerate(lines):
        check_served(line["prediction"], params_from_dict(RecQuery,
                                                          line["query"]),
                     blob, f"batchpredict line {k}")
    log(f"  the {N_QS_HTTP} answers and the {N_QS_BATCH} batchpredict lines "
        f"match the CPU copy of the served blob (check_served)")


def cli_main(argv) -> int:
    """The CLI's main in this process, its console logging undone once it
    returns: ``main`` gives the root logger a stderr handler and the
    ``pio_tpu_torch`` tree a level, which would print every query the
    later phases serve into this script's output (and time the prints).
    The structured-log ring keeps recording."""
    root, tree = logging.getLogger(), logging.getLogger("pio_tpu_torch")
    handlers, level = list(root.handlers), tree.level
    try:
        return _cli_main(argv)
    finally:
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
        tree.setLevel(level)


def phase_cli_text(args, smi) -> dict:
    """Phase 29: text classification through ``pio_tpu_torch.tools.cli.main``
    in this process (so the kernels' counters see the launches): import
    the corpus, train, deploy on a thread, 8 queries over HTTP, undeploy."""
    t_phase = time.monotonic()
    log(f"phase 29: text classification through the CLI in this process: "
        f"import {N_DOCS} documents, train, deploy, {N_HTTP} queries, "
        f"undeploy; {smi}")
    home = fresh_home("text")
    walls = {}
    rng = np.random.default_rng(args.seed + 1)  # phase 9's corpus
    docs, labels = synth_corpus(rng, N_DOCS, N_WORDS, coverage=True)
    corpus = os.path.join(home, "corpus.jsonl")
    t0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    with open(corpus, "w") as f:
        for k, (text, label) in enumerate(zip(docs, labels)):
            f.write(json.dumps({
                "event": "$set", "entityType": "content", "entityId": f"doc{k}",
                "properties": {"text": text, "label": label},
                "eventTime": (t0 + dt.timedelta(seconds=k)).isoformat()}) + "\n")
    variant_dict = {
        "id": "chip-smoke-cli", "engineFactory": "templates.textclassification",
        "datasource": {"params": {"app_name": APP}},
        "algorithms": [{"name": "mlp", "params": {}}, {"name": "nb", "params": {}}],
    }
    ej = os.path.join(home, "engine.json")
    with open(ej, "w") as f:
        json.dump(variant_dict, f)

    def run_cli(*argv):
        t = time.monotonic()
        code = cli_main(list(argv))
        walls[argv[0] if argv[0] != "app" else "app new"] = \
            time.monotonic() - t
        if code != 0:
            raise AssertionError(f"pio {' '.join(argv)} returned {code}")

    port = free_port()
    deployed = []
    variant = variant_from_dict(variant_dict, path=ej)
    with cli_store(home):
        run_cli("app", "new", APP)
        run_cli("import", "--app", APP, "--input", corpus)
        reset_counts()
        run_cli("train", "--engine-json", ej)
        train_launches = read_counts()
        thread = threading.Thread(target=lambda: deployed.append(cli_main([
            "deploy", "--engine-json", ej, "--ip", "127.0.0.1",
            "--port", str(port)])), daemon=True)
        t = time.monotonic()
        thread.start()
        wait_alive(port)
        walls["deploy up"] = time.monotonic() - t
        texts, held_out = synth_corpus(np.random.default_rng(args.seed + 2),
                                       N_HTTP, N_WORDS, coverage=False)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        answers, ms = [], []
        for text in texts:
            t = time.perf_counter()
            code, got = request(conn, "POST", "/queries.json", {"text": text})
            ms.append((time.perf_counter() - t) * 1e3)
            if code != 200:
                raise AssertionError(f"text query: HTTP {code} {got}")
            answers.append(got)
        conn.close()
        run_cli("undeploy", "--port", str(port))
        thread.join(timeout=60)
        if thread.is_alive() or deployed != [0]:
            raise AssertionError(f"pio deploy did not end cleanly: {deployed}")
        launches = read_counts()
        engine, ep = build_engine(variant)
        iid = Storage.get_meta_data_engine_instances().get_latest_completed(
            variant.engine_id, variant.engine_version, variant.path).id
        inst = Storage.get_meta_data_engine_instances().get(iid)
        cpu = load_models_for_instance(
            iid, engine, ep, ComputeContext.local(args.seed, device="cpu"))
    if not inst.env["device"].startswith("cuda"):
        raise AssertionError("pio train did not train on the card")
    serving = engine.make_serving(ep)
    pairs = engine.algorithms_with_models(ep, cpu)
    for k, (text, got) in enumerate(zip(texts, answers)):
        q = Query(text=text)
        same_answer(got, serving.serve(q, [a.predict(m, q) for a, m in pairs]),
                    f"CLI text query {k}")
    serve_launches = {k: launches[k] - train_launches[k] for k in launches}
    iterations = ep.algorithm_params_list[0][1].iterations
    log(f"  pio train on {inst.env['device']}: launches {json.dumps(train_launches)}"
        f"; phases {json.dumps({k: v for k, v in inst.env.items() if k.startswith('phase_')})}")
    log(f"  {N_HTTP} answers through the CLI-deployed server match the CPU "
        f"copy of the blob ({sum(a['label'] == lab for a, lab in zip(answers, held_out))}"
        f" held-out labels right); serving launches {json.dumps(serve_launches)}; "
        f"host clock ms per request {rounded(ms)}")
    log(f"  wall s a verb (host clock, in this process): "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}")
    if train_launches["embedding_bag"] < iterations \
            or train_launches["embedding_bag_backward_table"] < iterations + 1 \
            or serve_launches["embedding_bag"] < N_HTTP:
        raise AssertionError(f"the CLI path launched {launches}")
    log(f"  phase 29 {time.monotonic() - t_phase:.1f} s; {smi}")
    return dict(launches=launches, walls=walls, query_ms=ms, home=home,
                engine_json=ej, variant=variant_dict)


# ------------------------------------ the neural templates (phases 30-35)
# bench.py:1771-1806 (_bench_twotower, BASELINE.md config #5) at scale 1:
# 500,000 pairs of 100,064 users and 50,064 items, uniform, from
# default_rng(4); embed 64, hidden 128, out 64, batch 4,096, 200 steps
TT_PAIRS, TT_USERS, TT_ITEMS = 500_000, 100_064, 50_064
TT_EMBED, TT_HIDDEN, TT_OUT, TT_BATCH, TT_STEPS = 64, 128, 64, 4096, 200
# bench.py:1966-1975 (_bench_seqrec) at scale 1: 256 histories of length
# 64-127 in T = 128 over a 20,000-item vocabulary, from default_rng(6);
# d 256, 8 heads, 4 layers, ffn 1,024, 30 full-batch steps
SEQ_N, SEQ_T, SEQ_VOCAB, SEQ_STEPS = 256, 128, 20_000, 30
SEQ_D, SEQ_HEADS, SEQ_LAYERS, SEQ_FFN = 256, 8, 4, 1024
# card vs CPU after Adam steps from one init: the CPU tests' tolerance of
# the port against the reference (f32 sums in another order; 1.5e-7 seen
# after 15-20 steps at the tests' widths)
NEURAL_TOL = 1e-4
# a served next-item score (an O(10) logit of a d-64 dot) or a unit-vector
# dot, card vs the CPU copy of the blob: f32 in another order, ~1e-6
NEURAL_SCORE_TOL = 1e-4
# the sweeps card vs CPU: a flip of a held-out item at the top-10 boundary
# moves two-tower HitRate by 1/100,000 (three folds of ~33,000 pairs) and
# the sequence one by 1/943 (a user); the limits allow ~100 and ~9 flips
TT_HITRATE_TOL = 1e-3
SEQ_HITRATE_TOL = 0.01
# the sweeps card vs CPU at a reduced depth, for the script's time: the
# two-tower sweep at 100 steps a point (its default 300), the sequence one
# at 2 folds, 10 steps, d 16 and max_len 8 (a CPU step at the template's
# shape takes ~0.5 s; 200 a point would not fit)
TT_EVAL_STEPS = 100
#: the two-tower sweep's grid: out_dim 64 alone (32 and 64 until PR 17;
#: cut for the script's time, a point ~11 s a side)
TT_EVAL_OUT_DIMS = (64,)
SEQ_EVAL_CPU = dict(eval_k=2, layer_grid=(1, 2), steps=10, d_model=16,
                    max_len=8)
NEURAL_APP = "movielens-100k-neural"
N_NEURAL_BATCH = 1024


def tt_config(**kw):
    return two_tower.TwoTowerConfig(
        embed_dim=TT_EMBED, hidden=TT_HIDDEN, out_dim=TT_OUT,
        steps=TT_STEPS, batch_size=TT_BATCH, **kw)


def tt_pairs():
    """A copy of bench.py's _bench_twotower pairs at scale 1."""
    rng = np.random.default_rng(4)
    u = rng.integers(0, TT_USERS, TT_PAIRS).astype(np.int32)
    i = rng.integers(0, TT_ITEMS, TT_PAIRS).astype(np.int32)
    return u, i


def tt_train(u, i, cfg, **kw):
    """train_two_tower on the card, drained: (model, host-clock s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = two_tower.train_two_tower(None, u, i, TT_USERS, TT_ITEMS, cfg,
                                      device=CARD, **kw)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def init_on(dev, tree):
    """A CPU-drawn parameter tree on ``dev`` (as the trainers place it)."""
    return adam.rebuild(tree, [t.to(dev) for t in adam.leaves(tree)])


def tree_err(a, b) -> float:
    """Largest |a - b| over two lists of tensors (any devices)."""
    return max(float((x.cpu() - y.cpu()).abs().max()) for x, y in zip(a, b))


def grad_err(loss_fn, tree, dev, *inputs) -> tuple:
    """The loss and its gradients from ``tree`` on the card against the
    CPU: (|loss diff|, max over the leaves of max |gradient diff| over the
    leaf's largest |gradient|). Gradients, not the stepped weights: Adam's
    first step moves a weight by lr·g/(|g| + 1e-8), so where |g| is near
    1e-8 the rounding of g in another summation order moves the weight by
    up to 2·lr whatever the gradients' agreement."""
    out = []
    for d in (dev, torch.device("cpu")):
        p = [t.to(d).detach().requires_grad_(True) for t in adam.leaves(tree)]
        loss = loss_fn(adam.rebuild(tree, p), *(x.to(d) for x in inputs))
        out.append((float(loss.detach()), torch.autograd.grad(loss, p)))
    (l_card, g_card), (l_cpu, g_cpu) = out
    rel = max(float((a.cpu() - b).abs().max())
              / max(float(b.abs().max()), 1e-30)
              for a, b in zip(g_card, g_cpu))
    return abs(l_card - l_cpu), rel


def tt_step_bound(n_params: int, B: int) -> dict:
    """One two-tower step: params, Adam's two moments and the batch's ids
    read once, params and moments written once; the towers' two products
    a side, the [B, B] logits, each forward product and its two backward
    ones, and Adam's ~10 flops a parameter."""
    mads = 2 * B * (TT_EMBED * TT_HIDDEN + TT_HIDDEN * TT_OUT) \
        + B * B * TT_OUT
    return bound_of(6 * 4 * n_params + 2 * 4 * B,
                    3 * 2 * mads + 10 * n_params)


def phase_twotower_full(args, smi) -> dict:
    """Phase 30: train_two_tower at bench.py's two-tower shape."""
    t_phase = time.monotonic()
    log(f"phase 30: train_two_tower(None, ...) at bench.py's shape "
        f"({TT_PAIRS} pairs, {TT_USERS} users, {TT_ITEMS} items, embed "
        f"{TT_EMBED}, hidden {TT_HIDDEN}, out {TT_OUT}, batch {TT_BATCH}, "
        f"{TT_STEPS} steps); {smi}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on; the port computes in f32")
    u, i = tt_pairs()
    cfg = tt_config()
    runs = [tt_train(u, i, cfg) for _ in range(3)]
    walls = [w for _, w in runs]
    wall = float(np.median(walls))
    model = runs[0][0]
    for other, _ in runs[1:]:
        if not (torch.equal(other.user_vectors, model.user_vectors)
                and torch.equal(other.item_vectors, model.item_vectors)):
            raise AssertionError("train_two_tower: two runs differ")
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    tt_train(u, i, cfg, stats=stats)
    peak = torch.cuda.max_memory_allocated()
    bf_stats = {}
    bf, bf_wall = tt_train(u, i, tt_config(table_wire="bfloat16"),
                           stats=bf_stats)
    if not torch.equal(bf.item_vectors,
                       model.item_vectors.to(torch.bfloat16).float()):
        raise AssertionError("the bf16 table wire is not the f32 tables "
                             "rounded")
    norms = torch.linalg.vector_norm(model.item_vectors, dim=1)
    if not (torch.isfinite(model.item_vectors).all()
            and float((norms - 1).abs().max()) < 1e-5):
        raise AssertionError("the item vectors are not finite unit rows")

    # one step on the card from the trainer's init, kernels by the
    # profiler, and the loss and gradients against the CPU's
    tree = two_tower.init_params(TT_USERS, TT_ITEMS, cfg,
                                 torch.Generator().manual_seed(cfg.seed))
    n_params = sum(t.numel() for t in adam.leaves(tree))
    ub, ib = (torch.from_numpy(a[:TT_BATCH]).to(CARD) for a in (u, i))
    card = init_on(CARD, tree)
    vals, opt = adam.leaves(card), adam.adam_init(card)
    launches, ms, kernels = device_busy(
        lambda: two_tower._train_step(card, vals, opt, ub, ib, cfg), iters=5)
    loss_err, err = grad_err(
        lambda t, a, b: two_tower._contrastive_loss(t["user"], t["item"],
                                                    a, b, cfg),
        tree, CARD, ub, ib)
    bnd = tt_step_bound(n_params, TT_BATCH)
    idle = 1 - ms * TT_STEPS / 1e3 / stats["steps_s"]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"  wall {wall:.4f} s (median of 3: {rounded(walls)}), "
        f"{TT_STEPS * TT_BATCH / wall:.6g} examples/s; stats "
        f"{json.dumps({k: (round(v, 5) if isinstance(v, float) else v) for k, v in stats.items()})}; "
        f"peak {peak} B; the same bits three times")
    log(f"  table_wire bfloat16: wall {bf_wall:.4f} s, stats "
        f"{json.dumps({k: (round(v, 5) if isinstance(v, float) else v) for k, v in bf_stats.items()})}; "
        f"the f32 tables rounded, bit for bit")
    log(f"  one step: {ms:.5f} ms of kernels in {launches:.1f} launches "
        f"against steps_s / {TT_STEPS} = "
        f"{stats['steps_s'] / TT_STEPS * 1e3:.4f} ms: the card idle "
        f"{idle:.3f} of steps_s; bound {bnd['bound_ms']:.5f} ms "
        f"({bnd['bound_by']}; {n_params} parameters); card vs CPU at the "
        f"init: loss {loss_err}, gradients {err} of each one's largest; "
        f"largest kernels, ms a step: "
        f"{json.dumps({k[:96]: round(v, 5) for k, v in top})}")
    if err > NEURAL_TOL or loss_err > NEURAL_TOL:
        raise AssertionError("a two-tower step on the card differs from the "
                             "CPU's")
    log(f"  phase 30 {time.monotonic() - t_phase:.1f} s; {smi}")
    row = program_row("two-tower step",
                      "pio_tpu/models/two_tower.py:138-167, 261-266",
                      [TT_BATCH, TT_EMBED, TT_HIDDEN, TT_OUT, TT_USERS,
                       TT_ITEMS], launches, ms, bnd, loss_err)
    return dict(model=model, rows=[{**row, "grad_rel_err_cpu": err,
                                    "library_ms": None}])


def tt_small_steps(dev, tree, u, i, cfg, n_steps, B):
    """``n_steps`` two-tower steps on ``dev`` over consecutive batches:
    (losses, the vector tables)."""
    params = init_on(dev, tree)
    vals, opt = adam.leaves(params), adam.adam_init(params)
    losses = []
    for k in range(n_steps):
        sl = slice(k * B, (k + 1) * B)
        vals, opt, loss = two_tower._train_step(
            params, vals, opt, torch.from_numpy(u[sl]).to(dev),
            torch.from_numpy(i[sl]).to(dev), cfg)
        losses.append(float(loss))
    fitted = adam.rebuild(params, vals)
    with torch.no_grad():
        return losses, [two_tower._tower_forward(
            fitted[t], torch.arange(fitted[t]["emb"].shape[0], device=dev))
            for t in ("user", "item")]


def phase_twotower_card_vs_cpu(args, smi) -> None:
    """Phase 31: two-tower training card against CPU at a small shape."""
    t_phase = time.monotonic()
    n_users, n_items, B, steps = 600, 400, 256, 20
    log(f"phase 31: two-tower card vs CPU, {steps} steps of batch {B} over "
        f"{n_users} users and {n_items} items, from one init; {smi}")
    rng = np.random.default_rng(args.seed + 31)
    u = rng.integers(0, n_users, B * steps).astype(np.int32)
    i = rng.integers(0, n_items, B * steps).astype(np.int32)
    cfg = two_tower.TwoTowerConfig(embed_dim=32, hidden=64, out_dim=32,
                                   steps=steps, batch_size=B)
    tree = two_tower.init_params(n_users, n_items, cfg,
                                 torch.Generator().manual_seed(args.seed))
    card = tt_small_steps(CARD, tree, u, i, cfg, steps, B)
    cpu = tt_small_steps(torch.device("cpu"), tree, u, i, cfg, steps, B)
    loss_err = max(abs(a - b) for a, b in zip(card[0], cpu[0]))
    vec_err = tree_err(card[1], cpu[1])
    # and the trainer itself, card against CPU
    got = two_tower.train_two_tower(None, u, i, n_users, n_items, cfg,
                                    device=CARD)
    want = two_tower.train_two_tower(None, u, i, n_users, n_items, cfg,
                                     device="cpu")
    train_err = tree_err([got.user_vectors, got.item_vectors],
                         [want.user_vectors, want.item_vectors])
    log(f"  losses {rounded(card[0][:3])} ... {card[0][-1]:.5f}, card vs CPU "
        f"max |diff| {loss_err}; vector tables {vec_err}; train_two_tower "
        f"card vs CPU {train_err} (limit {NEURAL_TOL})")
    if max(loss_err, vec_err, train_err) > NEURAL_TOL:
        raise AssertionError("two-tower training on the card differs from "
                             "the CPU's")
    log(f"  phase 31 {time.monotonic() - t_phase:.1f} s")


def same_topn(got: dict, want: dict, tol: float, where: str) -> None:
    """A served top-N against the CPU copy's answer: the same length, each
    score within ``tol``, and the same items wherever the CPU's scores lie
    more than ``tol`` apart."""
    g, w = got["itemScores"], want["itemScores"]
    ok = len(g) == len(w)
    for a, b in zip(g, w):
        ok = ok and abs(a["score"] - b["score"]) <= tol
        if ok and a["item"] != b["item"]:
            tied = [s["score"] for s in w if s["item"] == a["item"]]
            ok = bool(tied) and abs(tied[0] - b["score"]) <= tol
    if not ok:
        raise AssertionError(f"{where}: {got} is not the CPU copy's {want}")


def gpu_tensors(model) -> list:
    """The tensors of a two-tower or sequence engine model."""
    if hasattr(model.model, "params"):
        return adam.leaves(model.model.params)
    return [model.model.user_vectors, model.model.item_vectors]


def neural_template(args, smi, variant_dict, query_cls, bodies_fn,
                    batch_fn):
    """run_train of ``variant_dict`` on the card, the blob loaded on the card
    and on the CPU, 8 POST /queries.json against the CPU copy, and
    batch_predict of 1024 against the predict loop. Returns the launches."""
    variant = variant_from_dict(variant_dict)
    engine, ep = build_engine(variant)
    ctx = ComputeContext.create(args.seed, device=CARD)
    t0 = time.monotonic()
    iid = run_train(engine, ep, variant, ctx=ctx)
    train_s = time.monotonic() - t0
    inst = Storage.get_meta_data_engine_instances().get(iid)
    phases = {k: v for k, v in inst.env.items() if k.startswith("phase_")}
    if inst.env["device"] != str(CARD):
        raise AssertionError("run_train did not run on the card")
    gpu = load_models_for_instance(iid, engine, ep, ctx)
    cpu = load_models_for_instance(
        iid, engine, ep, ComputeContext.local(args.seed, device="cpu"))
    if any(t.device.type != CARD.type for t in gpu_tensors(gpu[0])):
        raise AssertionError("the loaded model is not on the card")
    log(f"  run_train {train_s:.2f} s (host clock); phases "
        f"{json.dumps(phases)}")
    algo = engine._algorithms(ep)[0]
    bodies = bodies_fn(gpu[0])
    answers, http_launches, ms = serve_bodies(engine, ep, gpu, bodies)
    for k, (body, got) in enumerate(zip(bodies, answers)):
        want = algo.predict(cpu[0], params_from_dict(query_cls, body))
        same_topn(got, want.to_dict(), NEURAL_SCORE_TOL, f"query {k} {body}")
    log(f"  {len(bodies)} POST /queries.json on the card match the CPU copy "
        f"of the blob; {http_launches} launches; host clock ms per request "
        f"{rounded(ms)}")
    if http_launches == 0:
        raise AssertionError("the served path launched nothing on the card")
    qs = batch_fn(gpu[0])
    t0 = time.perf_counter()
    batch, batch_launches = count_kernels(
        lambda: dict(algo.batch_predict(gpu[0], qs)))
    batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loop = {k: algo.predict(gpu[0], q) for k, q in qs}
    loop_ms = (time.perf_counter() - t0) * 1e3
    for k, _ in qs:
        same_topn(batch[k].to_dict(), loop[k].to_dict(), NEURAL_SCORE_TOL,
                  f"batch query {k}")
    log(f"  batch_predict of {len(qs)}: {batch_ms:.1f} ms, {batch_launches} "
        f"launches; the predict loop {loop_ms:.1f} ms (host clock, the "
        f"batch under the profiler); equal within {NEURAL_SCORE_TOL}")
    if batch_launches == 0:
        raise AssertionError("batch_predict launched nothing on the card")


def phase_twotower_template(args, smi) -> None:
    """Phase 32: the two-tower template end to end at MovieLens-100K's
    shape (phase 13's events), and its sweep card vs CPU."""
    t_phase = time.monotonic()
    log(f"phase 32: templates.twotower end to end on phase 13's events "
        f"(MovieLens-100K's shape), the template's defaults (500 steps of "
        f"batch 256): run_train, {N_REC_HTTP} POST /queries.json against "
        f"the CPU copy, batch_predict of {N_NEURAL_BATCH}, "
        f"twotower_evaluation card vs CPU at {TT_EVAL_STEPS} steps; {smi}")
    app_id = Storage.get_meta_data_apps().insert(App(0, NEURAL_APP))
    t0 = time.monotonic()
    n_events = rec_events(np.random.default_rng(args.seed + 3), app_id)
    log(f"  ingest {n_events} events {time.monotonic() - t0:.2f} s")

    def bodies(model):
        users = sorted(model.user_index.keys())
        items = list(model.item_index.keys())
        return [
            {"user": users[0], "num": 10},
            {"user": users[1], "num": 10, "blackList": items[:5]},
            {"user": users[2], "item": items[7]},
            {"user": "stranger", "num": 10},
            {"user": users[3], "num": 0},
            {"user": users[4], "num": 20},
            {"user": users[5], "num": 5, "blackList": items[:50]},
            {"user": users[6]},
        ]

    def batch(model):
        users = sorted(model.user_index.keys())
        return [(k, TTQuery(user=users[k % len(users)], num=10))
                for k in range(N_NEURAL_BATCH)]

    neural_template(args, smi, {
        "id": "twotower-chip-smoke", "engineFactory": "templates.twotower",
        "datasource": {"params": {"app_name": NEURAL_APP}},
        "algorithms": [{"name": "twotower", "params": {"seed": args.seed}}],
    }, TTQuery, bodies, batch)
    out = run_sweep("twotower_evaluation", twotower_evaluation(
        NEURAL_APP, steps=TT_EVAL_STEPS, out_dims=TT_EVAL_OUT_DIMS), args)
    compare_sweeps("twotower_evaluation", out, TT_HITRATE_TOL)
    log(f"  phase 32 {time.monotonic() - t_phase:.1f} s")


def seq_histories():
    """A copy of bench.py's _bench_seqrec histories at scale 1."""
    rng = np.random.default_rng(6)
    lens = rng.integers(SEQ_T // 2, SEQ_T, SEQ_N)
    seqs = np.zeros((SEQ_N, SEQ_T), np.int32)
    for r in range(SEQ_N):
        seqs[r, : lens[r]] = rng.integers(1, SEQ_VOCAB + 1, lens[r])
    return seqs


def seq_config(**kw):
    return seqrec.SeqRecConfig(
        d_model=SEQ_D, n_heads=SEQ_HEADS, n_layers=SEQ_LAYERS, ffn=SEQ_FFN,
        max_len=SEQ_T, steps=SEQ_STEPS, **kw)


def seq_train(seqs, cfg, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = seqrec.train_seqrec(None, seqs, SEQ_VOCAB, cfg, device=CARD, **kw)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def seq_batch(seqs, dev):
    targets = np.zeros_like(seqs)
    targets[:, :-1] = seqs[:, 1:]
    mask = ((targets > 0) & (seqs > 0)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (seqs, targets, mask))


def seq_flops(rows: int) -> int:
    """bench.py:1985-1988: the step's matmul flops over ``rows`` rows
    (projections, scores and values, FFN, the logits; x3 for the
    backward; gathers not counted)."""
    fwd_per_token = SEQ_LAYERS * (8 * SEQ_D * SEQ_D + 4 * SEQ_T * SEQ_D
                                  + 4 * SEQ_D * SEQ_FFN) \
        + 2 * SEQ_D * (SEQ_VOCAB + 1)
    return 3 * fwd_per_token * rows * SEQ_T


def fwd_bwd(fn, inputs):
    """``fn(*inputs)`` and its backward with a ones gradient."""
    def run():
        out = fn(*inputs)
        grads = torch.autograd.grad(out, [x for x in inputs
                                          if x.requires_grad],
                                    torch.ones_like(out))
        return out, grads
    return run


def phase_seqrec_full(args, smi) -> dict:
    """Phase 33: train_seqrec at bench.py's sequence shape."""
    t_phase = time.monotonic()
    log(f"phase 33: train_seqrec(None, ...) at bench.py's shape ({SEQ_N} "
        f"histories, T {SEQ_T}, d {SEQ_D}, {SEQ_HEADS} heads, {SEQ_LAYERS} "
        f"layers, ffn {SEQ_FFN}, vocab {SEQ_VOCAB}, {SEQ_STEPS} full-batch "
        f"steps); {smi}")
    seqs = seq_histories()
    cfg = seq_config()
    runs = [seq_train(seqs, cfg) for _ in range(3)]
    walls = [w for _, w in runs]
    wall = float(np.median(walls))
    model = runs[0][0]
    for other, _ in runs[1:]:
        for a, b in zip(adam.leaves(model.params), adam.leaves(other.params)):
            if not torch.equal(a, b):
                raise AssertionError("train_seqrec: two runs differ")
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    seq_train(seqs, cfg, stats=stats)
    peak = torch.cuda.max_memory_allocated()
    h = seqs[:8, :SEQ_T]
    scores = model.next_item_scores(h)
    if scores.shape != (8, SEQ_VOCAB + 1) or not np.isfinite(scores).all():
        raise AssertionError(f"next_item_scores gave {scores.shape}")

    # the step, and its parts, from the trainer's init
    tree = seqrec.init_params(SEQ_VOCAB + 1, cfg,
                              torch.Generator().manual_seed(cfg.seed))
    params = init_on(CARD, tree)
    vals, opt = adam.leaves(params), adam.adam_init(params)
    batch = seq_batch(seqs, CARD)
    launches, step_ms, kernels = device_busy(
        lambda: seqrec._train_step(params, vals, opt, batch, cfg), iters=3)
    B, T, D, H = SEQ_N, SEQ_T, SEQ_D, SEQ_HEADS
    gen = torch.Generator(device=CARD).manual_seed(args.seed)

    def rnd(*shape, grad=True):
        x = torch.randn(shape, generator=gen, device=CARD) * 0.3
        return x.requires_grad_(grad)

    blk = {k: v[0].detach().requires_grad_(True)
           for k, v in params["blocks"].items()}
    q, k_, v_ = (rnd(B, T, H, D // H) for _ in range(3))
    _, attn_ms, _ = device_busy(fwd_bwd(
        lambda a, b, c: seqrec.ring_attention(a, b, c), (q, k_, v_)), iters=3)
    x = rnd(B, T, D)

    def ffn(x, g, b, w1, b1, w2, b2):
        y = seqrec._ln(x, g, b)
        return x + torch.relu(y @ w1 + b1) @ w2 + b2

    _, ffn_ms, _ = device_busy(fwd_bwd(ffn, (
        x, blk["ln2_g"], blk["ln2_b"], blk["w1"], blk["b1"], blk["w2"],
        blk["b2"])), iters=3)
    hid = rnd(B, T, D)
    emb = params["emb"].detach().requires_grad_(True)

    def ce(h_, e_):
        s, n = seqrec._vocab_parallel_ce(h_, e_, batch[1], batch[2])
        return s / torch.clamp_min(n, 1.0)

    ce_launches, ce_ms, _ = device_busy(fwd_bwd(ce, (hid, emb)), iters=3)
    parts = {"attention": SEQ_LAYERS * attn_ms, "ffn": SEQ_LAYERS * ffn_ms,
             "ce_logits": ce_ms}
    parts["other"] = step_ms - sum(parts.values())
    flops = seq_flops(SEQ_N)
    step_bnd = bound_of(6 * 4 * sum(t.numel() for t in vals)
                        + 12 * B * T, flops)
    ce_bnd = bound_of(2 * 4 * (B * T * D + (SEQ_VOCAB + 1) * D)
                      + 8 * B * T, 3 * 2 * B * T * D * (SEQ_VOCAB + 1))
    tokens = SEQ_N * SEQ_T * SEQ_STEPS
    log(f"  wall {wall:.4f} s (median of 3: {rounded(walls)}), "
        f"{tokens / wall:.6g} tokens/s; stats "
        f"{json.dumps({k: (round(v, 5) if isinstance(v, float) else v) for k, v in stats.items()})}; "
        f"peak {peak} B (the [{B}, {T}, {SEQ_VOCAB + 1}] logits are "
        f"{B * T * (SEQ_VOCAB + 1) * 4} B); the same bits three times")
    log(f"  one step {step_ms:.4f} ms of kernels in {launches:.1f} launches "
        f"(steps_s / {SEQ_STEPS} = {stats['steps_s'] / SEQ_STEPS * 1e3:.4f} ms: "
        f"the card idle {1 - step_ms * SEQ_STEPS / 1e3 / stats['steps_s']:.3f}); "
        f"split, ms: {json.dumps({k: round(v, 4) for k, v in parts.items()})}; "
        f"{flops} flops a step (bench.py's count): "
        f"{flops / step_ms / 1e9:.4g} TFLOP/s of kernels, "
        f"{flops * SEQ_STEPS / stats['steps_s'] / 1e12:.4g} over steps_s, "
        f"against 67 TFLOP/s f32 (bound {step_bnd['bound_ms']:.4f} ms, "
        f"{step_bnd['bound_by']})")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"  largest kernels of a step, ms: "
        f"{json.dumps({k[:96]: round(v, 4) for k, v in top})}")

    # the yardstick: one layer's attention against SDPA (never in the port)
    qd, kd, vd = (t.detach() for t in (q, k_, v_))
    ours = seqrec.ring_attention(qd, kd, vd)
    lib = F.scaled_dot_product_attention(
        qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
        is_causal=True).transpose(1, 2)
    sdpa_err = float((ours - lib).abs().max())
    t_attn = timed_in_turns({
        "plain": lambda: seqrec.ring_attention(qd, kd, vd),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
            is_causal=True)})
    attn_bnd = bound_of(4 * 4 * B * T * D, 2 * 2 * B * H * T * T * (D // H))
    log(f"  attention of one layer [{B}, {H}, {T}, {D // H}], forward: "
        f"plain torch {t_attn['plain']:.4f} ms, "
        f"F.scaled_dot_product_attention(is_causal=True) {t_attn['sdpa']:.4f} "
        f"ms (a yardstick only), bound {attn_bnd['bound_ms']:.4f} ms "
        f"({attn_bnd['bound_by']}); max |diff| {sdpa_err}")
    if sdpa_err > NEURAL_TOL:
        raise AssertionError("the attention differs from SDPA's")

    # card vs CPU: the loss and its gradients over 16 of the rows (the
    # whole width; the full batch takes minutes on the CPU)
    few = seq_batch(seqs[:16], torch.device("cpu"))
    loss_err, err = grad_err(
        lambda t, *b: seqrec._loss(t, *b, cfg), tree, CARD, *few)
    def ce_of(t, tg, m):
        s_, n_ = seqrec._vocab_parallel_ce(t["h"], t["emb"], tg, m)
        return s_ / torch.clamp_min(n_, 1.0)

    ce_loss_err, ce_err = grad_err(
        ce_of, {"h": hid[:16].detach().cpu(), "emb": emb.detach().cpu()},
        CARD, few[1], few[2])
    attn_err = float((seqrec.ring_attention(qd[:16], kd[:16], vd[:16]).cpu()
                      - seqrec.ring_attention(qd[:16].cpu(), kd[:16].cpu(),
                                              vd[:16].cpu())).abs().max())
    log(f"  card vs CPU over 16 rows at the init: loss {loss_err}, "
        f"gradients {err} of each one's largest; the cross-entropy alone "
        f"{ce_loss_err}, its gradients {ce_err}; attention {attn_err} "
        f"(limit {NEURAL_TOL})")
    if max(err, loss_err, ce_loss_err, ce_err, attn_err) > NEURAL_TOL:
        raise AssertionError("a seqrec step on the card differs from the "
                             "CPU's")
    log(f"  phase 33 {time.monotonic() - t_phase:.1f} s; {smi}")
    shape = [B, T, D, H, SEQ_LAYERS, SEQ_FFN, SEQ_VOCAB + 1]
    return dict(model=model, rows=[
        {**program_row("transformer step (full batch)",
                       "pio_tpu/models/seqrec.py:184-326, 576-582", shape,
                       launches, step_ms, step_bnd, loss_err),
         "grad_rel_err_cpu": err, "library_ms": None},
        {**program_row("cross-entropy logits, forward and backward",
                       "pio_tpu/models/seqrec.py:293-326",
                       [B, T, D, SEQ_VOCAB + 1], ce_launches, ce_ms, ce_bnd,
                       ce_loss_err), "grad_rel_err_cpu": ce_err,
         "library_ms": None},
        {**program_row("causal attention of one layer, forward",
                       "pio_tpu/parallel/ring.py:67-118",
                       [B, H, T, D // H], None, t_attn["plain"], attn_bnd,
                       attn_err), "library_ms": t_attn["sdpa"]},
    ])


def phase_sequence_template(args, smi) -> None:
    """Phase 34: the sequence template end to end on phase 13's events in
    time order, and its sweep card vs CPU."""
    t_phase = time.monotonic()
    log(f"phase 34: templates.sequence end to end on phase 13's events (943 "
        f"histories in time order), the template's defaults (d 64, 2 layers, "
        f"max_len 64, 300 full-batch steps): run_train, {N_REC_HTTP} POST "
        f"/queries.json by user and by history against the CPU copy, "
        f"batch_predict of {N_NEURAL_BATCH}, sequence_evaluation card vs "
        f"CPU at {json.dumps(SEQ_EVAL_CPU)}; {smi}")

    def bodies(model):
        users = sorted(model.user_histories)
        items = list(model.item_index.keys())
        return [
            {"user": users[0], "num": 10},
            {"user": users[1], "num": 5},
            {"user": users[2], "num": 20},
            {"history": items[:5], "num": 10},
            {"history": ["unknown", items[9], items[3]], "num": 10},
            {"history": ["unknown"]},
            {"user": "stranger", "num": 10},
            {"history": items[: 3 * 64], "num": 10},  # past max_len
        ]

    def batch(model):
        users = sorted(model.user_histories)
        items = list(model.item_index.keys())
        return [(k, SeqQuery(user=users[k % len(users)], num=10)
                 if k % 4 else SeqQuery(history=tuple(items[k % 97:][:12]),
                                        num=10))
                for k in range(N_NEURAL_BATCH)]

    neural_template(args, smi, {
        "id": "sequence-chip-smoke", "engineFactory": "templates.sequence",
        "datasource": {"params": {"app_name": NEURAL_APP}},
        "algorithms": [{"name": "seqrec", "params": {"seed": args.seed}}],
    }, SeqQuery, bodies, batch)
    out = run_sweep("sequence_evaluation (reduced)",
                    sequence_evaluation(NEURAL_APP, **SEQ_EVAL_CPU), args)
    compare_sweeps("sequence_evaluation (reduced)", out, SEQ_HITRATE_TOL)
    log(f"  phase 34 {time.monotonic() - t_phase:.1f} s")


def resumed(name, train, uninterrupted, every, total, directory):
    """Stop ``train`` after its first snapshot, resume it to ``total``
    steps, and hold the result against ``uninterrupted``'s tensors:
    (seconds of the two runs)."""
    shutil.rmtree(directory, ignore_errors=True)
    mgr = CheckpointManager(directory)
    t0 = time.monotonic()
    train(every, checkpoint=mgr, checkpoint_every=every)
    first = time.monotonic() - t0
    if mgr.latest_step() != every:
        raise AssertionError(f"{name}: no snapshot at step {every}")
    t0 = time.monotonic()
    got = train(total, checkpoint=mgr, checkpoint_every=every)
    second = time.monotonic() - t0
    if mgr.latest_step() != total:
        raise AssertionError(f"{name}: the resumed run saved no step {total}")
    diff = tree_err(got, uninterrupted)
    log(f"  {name}: stopped after the snapshot at {every} ({first:.2f} s), "
        f"resumed to {total} ({second:.2f} s); snapshots "
        f"{sorted(os.listdir(directory))}; against the uninterrupted run "
        f"max |diff| {diff}: "
        + ("the same bits" if diff == 0 else "NOT the same bits"))
    if diff != 0:
        raise AssertionError(f"{name}: the resumed run differs")


def phase_checkpoints(args, smi, tt, seq) -> None:
    """Phase 35: both trainers stopped after their first snapshot and
    resumed on the card, against phases 30 and 33's uninterrupted runs;
    then ``pio train --checkpoint-every`` through the CLI's main in this
    process."""
    t_phase = time.monotonic()
    tt_every, seq_every = TT_STEPS // 3, SEQ_STEPS // 3
    log(f"phase 35: checkpoints on the card: train_two_tower at phase 30's "
        f"shape every {tt_every} of {TT_STEPS} steps, train_seqrec at phase "
        f"33's every {seq_every} of {SEQ_STEPS}, each stopped after its first "
        f"snapshot and resumed; then pio train --checkpoint-every in this "
        f"process; {smi}")
    home = fresh_home("checkpoints")
    u, i = tt_pairs()
    resumed(
        "train_two_tower",
        lambda n, **kw: (lambda m: [m.user_vectors, m.item_vectors])(
            tt_train(u, i, dataclasses.replace(tt_config(), steps=n),
                     **kw)[0]),
        [tt["model"].user_vectors, tt["model"].item_vectors], tt_every,
        TT_STEPS, os.path.join(home, "two_tower"))
    seqs = seq_histories()
    resumed(
        "train_seqrec",
        lambda n, **kw: adam.leaves(seq_train(
            seqs, dataclasses.replace(seq_config(), steps=n), **kw)[0].params),
        adam.leaves(seq["model"].params), seq_every, SEQ_STEPS,
        os.path.join(home, "seqrec"))

    # the CLI: the quickstart's SQLite home of phase 28, a two-tower engine
    qs_home = os.path.join(CLI_HOMES, "quickstart")
    ej = os.path.join(home, "twotower.json")
    with open(ej, "w") as f:
        json.dump({"id": "twotower-cli", "engineFactory": "templates.twotower",
                   "datasource": {"params": {"app_name": QS_APP}},
                   "algorithms": [{"name": "twotower",
                                   "params": {"steps": 300}}]}, f)
    ck = os.path.join(home, "cli")
    said = io.StringIO()
    t0 = time.monotonic()
    with cli_store(qs_home), contextlib.redirect_stdout(said):
        code = cli_main(["train", "--engine-json", ej, "--checkpoint-every",
                         "100", "--checkpoint-dir", ck])
    wall, out = time.monotonic() - t0, said.getvalue()
    if code != 0:
        raise AssertionError(f"pio train --checkpoint-every returned "
                             f"{code}: {out[-2000:]}")
    snaps = sorted(os.listdir(os.path.join(ck, "algo0_twotower")))
    log(f"  pio train --checkpoint-every 100 (300 steps): {wall:.2f} s; "
        f"{out.strip().splitlines()[-1]}; snapshots {snaps}")
    if snaps != ["100", "200", "300", "fingerprint.json"]:
        raise AssertionError(f"pio train left snapshots {snaps}")
    log(f"  phase 35 {time.monotonic() - t_phase:.1f} s")


# ---------------------------- serving under concurrency (phases 36-39)
#: a load: concurrent keep-alive clients, and the queries each one sends
N_CLIENTS = 32
#: 32 (was 64; cut for the script's time, every run and check kept)
PER_CLIENT = 32
#: the micro-batcher's collection window in the measured runs, µs: about
#: one batched text dispatch at B = 32, so clients whose answers went out
#: together are back in the queue before the next batch leaves
MB_WINDOW_US = 2000
MB_KNOBS = ("PIO_TPU_SERVE_MICROBATCH_US", "PIO_TPU_SERVE_MICROBATCH_ADAPTIVE")
#: phase 38's stored classification variant, served again by phase 39
POOL_APP = "classification-pool"
POOL_VARIANT = {
    "id": "cls-pool", "engineFactory": "templates.classification",
    "datasource": {"params": {"app_name": POOL_APP}},
    "algorithms": [{"name": "logreg", "params": {
        "iterations": 100, "learning_rate": 0.1, "input_dtype": "int8"}}],
}
N_RELOADS = 3
POOL_WORKERS = 4
#: phase 39's pool, from its start to its readiness, and to its end
POOL_TIMEOUT_S = 180


def drive_load(port: int, bodies: list, n_clients: int, per_client: int,
               frames=None) -> tuple:
    """``n_clients`` keep-alive clients at once, each sending
    ``per_client`` queries (client k's n-th is body ``(k + n) mod
    len(bodies)``, so clients in step send distinct queries and each
    batch mixes them; with ``frames``, every other one as its packed
    int8 frame): ``([(body index, status, answer, host ms)], wall s)``."""
    records, errors = [], []
    lock = threading.Lock()

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            for n in range(per_client):
                i = (k + n) % len(bodies)
                if frames is not None and n % 2:
                    data, ctype = frames[i], PACKED_QUERY_CONTENT_TYPE
                else:
                    data, ctype = json.dumps(bodies[i]).encode(), \
                        "application/json"
                t = time.perf_counter()
                conn.request("POST", "/queries.json", data,
                             {"Content-Type": ctype})
                resp = conn.getresponse()
                answer = json.loads(resp.read())
                ms = (time.perf_counter() - t) * 1e3
                with lock:
                    records.append((i, resp.status, answer, ms))
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(f"client {k}: {e!r}")
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"load clients failed: {errors[:3]}")
    bad = [(i, s, a) for i, s, a, _ in records if s != 200]
    if bad:
        raise AssertionError(f"{len(bad)} answers not 200: {bad[:3]}")
    return records, wall


def latency(records, wall: float) -> dict:
    ms = np.array([r[3] for r in records])
    return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "qps": len(ms) / wall}


def distinct_answers(records) -> dict:
    """{(body index, answer as JSON)} → the answer: each distinct answer
    of a body is checked once."""
    return {(i, json.dumps(a, sort_keys=True)): a for i, _, a, _ in records}


def time_bucket(name: str, table, ids_np, w_np) -> dict:
    """The forward kernel at a served bucket: against its plain version
    (TOL), then kernel, plain and library times in turns, and the bound."""
    ids = torch.from_numpy(ids_np).to(table.device)
    w = torch.from_numpy(w_np).to(table.device)
    out = run_twice(name, table, ids, w)
    err = max_err(name, out, embedding.embedding_bag_plain(table, ids, w),
                  TOL[table.dtype])
    times = timed_in_turns({
        "kernel_ms": lambda: embedding.embedding_bag(table, ids, w),
        "plain_ms": lambda: embedding.embedding_bag_plain(table, ids, w),
        "library_ms": lambda: F.embedding_bag(
            ids, table, per_sample_weights=w, mode="sum"),
    })
    row = {**case_row(name, table, ids_np, TOL[table.dtype], err), **times,
           **bound(ids_np, w_np, table.shape[1], table.element_size())}
    log(f"  {json.dumps(row)}")
    return row


def served_runs(name, make_server, bodies, check, smi) -> dict:
    """The concurrency measurement of phases 36 and 37: the batcher off,
    then on (adaptive off), each with 1 client and then N_CLIENTS, every
    distinct answer checked (``check(body index, answer)``: against the
    solo path's and the CPU copy's), each run's forward launches, the
    stats after warmup and after the load; then once more with the
    adaptive probe on, its verdict printed."""
    out = {}
    for mode, window, adaptive in (("off", "0", "0"),
                                   ("on", str(MB_WINDOW_US), "0"),
                                   ("adaptive", str(MB_WINDOW_US), "1")):
        with knob(MB_KNOBS[0], window), knob(MB_KNOBS[1], adaptive):
            server = make_server()
        with server:
            warm = server.service.stats()["buckets"]
            for n_clients in ((1, N_CLIENTS) if mode != "adaptive"
                              else (N_CLIENTS,)):
                launches0 = read_counts()["embedding_bag"]
                records, wall = drive_load(server.port, bodies, n_clients,
                                           PER_CLIENT)
                launches = read_counts()["embedding_bag"] - launches0
                for (i, _), answer in distinct_answers(records).items():
                    check(i, answer)
                lat = latency(records, wall)
                out[(mode, n_clients)] = {**lat, "launches": launches}
                log(f"  {name}, batcher {mode}, {n_clients} client(s) x "
                    f"{PER_CLIENT}: p50 {lat['p50_ms']:.3f} ms, p99 "
                    f"{lat['p99_ms']:.3f} ms, {lat['qps']:.0f} queries/s "
                    f"(host clock), forward launches {launches}; {smi}")
            stats = server.service.stats()
        buckets = stats["buckets"]
        if mode == "off":
            continue
        mb = stats["microbatch"]
        log(f"  {name}, batcher {mode} (window {mb['windowUs']} us): "
            f"warmed {warm['warmed']} with retraces {warm['retraces']} "
            f"after warmup; batches {mb['batches']}, batchedQueries "
            f"{mb['batchedQueries']}, maxBatch {mb['maxBatch']}, dispatches "
            f"a bucket {json.dumps(buckets['dispatches'])}, retraces "
            f"{buckets['retraces']}, mode {mb['mode']}, probe "
            f"{json.dumps(mb['probe'])}, modeByBucket "
            f"{json.dumps(mb['modeByBucket'])}")
        if buckets["retraces"] != 0 or warm["warmed"] != list(
                server.service._buckets.buckets):
            raise AssertionError(f"{name}: the ladder retraced after warmup")
        if mode == "on" and mb["maxBatch"] < 2:
            raise AssertionError(f"{name}: {N_CLIENTS} clients never shared "
                                 f"a batch")
        out[mode] = {"microbatch": mb, "buckets": buckets}
    return out


def phase_text_microbatch(args, smi, gpu, cpu, queries) -> dict:
    """Phase 36: phase 4's model served micro-batched under concurrency."""
    t_phase = time.monotonic()
    log(f"phase 36: text classification at full width (phase 4's model), "
        f"POST /queries.json from 1 and {N_CLIENTS} keep-alive clients x "
        f"{PER_CLIENT}, the micro-batcher off, on (window {MB_WINDOW_US} "
        f"us, adaptive off) and adaptive; {smi}")
    engine = get_engine_factory("templates.textclassification")()
    ep = EngineParams(algorithm_params_list=(("mlp", MLPParams()),))
    algo = MLPAlgorithm()
    texts = queries[:PER_CLIENT]
    bodies = [{"text": t} for t in texts]
    want = [algo.predict(cpu, Query(text=t)) for t in texts]
    # the solo path: one bag a dispatch on the card, in this process
    solo_path = [algo.predict(gpu, Query(text=t)) for t in texts]

    def check(i, answer):
        same_answer(answer, want[i], f"text body {i} vs the CPU copy")
        same_answer(answer, solo_path[i], f"text body {i} vs the solo path")

    reset_counts()
    runs = served_runs("text", lambda: create_query_server(
        engine, ep, [gpu], host="127.0.0.1", port=0, device=CARD),
        bodies, check, smi)
    launches = read_counts()
    if runs[("on", N_CLIENTS)]["launches"] < 1:
        raise AssertionError("the batched run launched no forward kernel")
    log(f"  the forward kernel at the ladder's buckets on the served bags "
        f"(B = the first B bodies), against its plain version and bound:")
    rows = []
    for b in (1, 2, 4, 8, 16, 32):
        ids, w = _stack_bags(gpu, [(k, Query(text=t))
                                   for k, t in enumerate(texts[:b])])
        rows.append(time_bucket(f"served bucket B={b}", gpu.mlp.w_in, ids, w))
    log(f"  phase 36 launches (added to the kernels' line): "
        f"{json.dumps(launches)}; phase 36 {time.monotonic() - t_phase:.1f} s")
    return {"runs": runs, "launches": launches, "rows": rows}


def phase_rec_microbatch(args, smi, factors) -> dict:
    """Phase 37: the recommendation template at MovieLens-25M's width,
    micro-batched."""
    t_phase = time.monotonic()
    n_users, rank = factors.user_factors.shape
    n_items = factors.item_factors.shape[0]
    log(f"phase 37: the recommendation template on phase 11's factors "
        f"({n_users} users x {n_items} items, rank {rank}) through "
        f"ALSModel.from_factors, num 10, the same concurrency runs; {smi}")
    users = BiMap({f"u{n}": n for n in range(n_users)})
    items = BiMap({f"i{n}": n for n in range(n_items)})
    gpu = RecModel.from_factors(factors, users, items, device=CARD)
    cpu = RecModel.from_factors(factors, users, items, device="cpu")
    engine = get_engine_factory("templates.recommendation")()
    ep = EngineParams(algorithm_params_list=(
        ("als", params_from_dict(RecALS.params_class, {"rank": rank})),))
    rng = np.random.default_rng(args.seed + 36)
    bodies = []
    for k in range(PER_CLIENT):
        body = {"user": f"u{int(rng.integers(n_users))}", "num": 10}
        if k % 3 == 1:  # black lists that differ within one batch
            body["blackList"] = [f"i{int(x)}" for x in
                                 rng.integers(0, n_items // 50, 3)]
        bodies.append(body)

    def check(i, answer):
        # the CPU copy's top-N up to ties within SCORE_TOL: the solo run's
        # answers pass the same check, so batched ones equal them up to
        # those ties
        check_served(answer, params_from_dict(RecQuery, bodies[i]), cpu,
                     f"recommendation body {i}")

    runs = served_runs("recommendation", lambda: create_query_server(
        engine, ep, [gpu], host="127.0.0.1", port=0, device=CARD),
        bodies, check, smi)
    log(f"  phase 37 {time.monotonic() - t_phase:.1f} s")
    return {"runs": runs}


def pool_models(variant, seeds, ctx):
    """Train one stored instance of ``variant`` a seed (in the current
    store); returns the instance ids in training order."""
    ids = []
    for seed in seeds:
        v = variant_from_dict({**POOL_VARIANT, "algorithms": [{
            "name": "logreg", "params": {**POOL_VARIANT["algorithms"][0][
                "params"], "seed": seed}}]}, path=variant.path)
        engine, ep = build_engine(v)
        ids.append(run_train(engine, ep, v, ctx=ctx))
    return ids


def cpu_mirror(variant, iid):
    """The CPU copy of stored instance ``iid`` behind a service with the
    resident scorer on the CPU, on the int8 wire."""
    engine, ep = build_engine(variant)
    models = load_models_for_instance(
        iid, engine, ep, ComputeContext.local(0, device="cpu"))
    with knob("PIO_TPU_DEVICE_RESIDENT", "1"), \
            knob("PIO_TPU_SERVE_WIRE", "int8"):
        return QueryService(engine, ep, models, device="cpu")


def pool_bodies(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"attrs": [float(v) for v in row]}
            for row in rng.integers(0, 9, (PER_CLIENT, 3))]


def phase_reload_under_load(args, smi) -> dict:
    """Phase 38: ``/reload`` under load, the classification template."""
    t_phase = time.monotonic()
    log(f"phase 38: /reload x {N_RELOADS} under {N_CLIENTS} clients: "
        f"phase 26's {N_CLS_USERS} $set users, logreg on the int8 wire with "
        f"its resident scorer on the card, instances from two seeds in "
        f"SQLite; {smi}")
    home = fresh_home("pool")
    ej = os.path.join(home, "engine.json")
    with open(ej, "w") as f:
        json.dump(POOL_VARIANT, f)
    variant = variant_from_dict(POOL_VARIANT, path=ej)
    ctx = ComputeContext.create(args.seed, device=CARD)
    bodies = pool_bodies(args.seed + 38)
    with cli_store(home):
        app_id = Storage.get_meta_data_apps().insert(App(0, POOL_APP))
        cls_events(args, app_id)
        iids = pool_models(variant, (1, 2), ctx)
        base = allocated()
        # every request thread dispatches on its own (the batcher off):
        # the most readers a swap can land under
        with knob(MB_KNOBS[0], "0"):
            server = deploy_query_server(variant, host="127.0.0.1", port=0,
                                         device=CARD)
        service = server.service
        one_gen = allocated() - base
        (scorer,) = service._gen.scorers()
        expected = sum(-(-n // 512) * 512 for n in (
            [scorer.in_dim * scorer.n_classes * 4, scorer.n_classes * 4]
            + [b * scorer.n_classes * 4 for b in service._buckets.buckets]))
        outgoing, reloads, answers = [], [], []
        with server:
            done = threading.Event()

            def reloader():
                for k in range(N_RELOADS):
                    done.wait(0.3)
                    seed = 1 + (k + 1) % 2
                    iids.extend(pool_models(variant, (seed,), ctx))
                    outgoing.extend(service._gen.scorers())
                    conn = http.client.HTTPConnection("127.0.0.1",
                                                      server.port, timeout=60)
                    t = time.perf_counter()
                    reloads.append((request(conn, "POST", "/reload", {}),
                                    (time.perf_counter() - t) * 1e3))
                    conn.close()

            thread = threading.Thread(target=reloader, daemon=True)
            thread.start()
            records, wall = drive_load(server.port, bodies, N_CLIENTS,
                                       PER_CLIENT * 2)
            thread.join(timeout=CLI_TIMEOUT_S)
            answers = distinct_answers(records)
            current = service._gen.scorers()
            live = allocated() - base
        after = allocated() - base
        mirrors = {iid: cpu_mirror(variant, iid) for iid in set(iids)}
        want = {iid: [m.query(json.dumps(b).encode()) for b in bodies]
                for iid, m in mirrors.items()}
        for m in mirrors.values():
            m.close()
    if thread.is_alive() or len(reloads) != N_RELOADS:
        raise AssertionError(f"the reloads did not finish: {reloads}")
    for k, ((status, got), ms) in enumerate(reloads):
        if status != 200 or got["engineInstanceId"] != iids[2 + k]:
            raise AssertionError(f"reload {k}: {status} {got}")
    for (i, _), answer in answers.items():
        if not any(answer == w[i] for w in want.values()):
            raise AssertionError(f"body {i}: {answer} is no generation's "
                                 f"CPU copy's")
    lat = latency(records, wall)
    log(f"  {lat['n']} answers, all 200 and each a generation's CPU copy's "
        f"answer, across {N_RELOADS} reloads of {[round(ms, 1) for _, ms in reloads]} "
        f"ms (host clock); p50 {lat['p50_ms']:.3f} ms, p99 "
        f"{lat['p99_ms']:.3f} ms; outgoing scorers retired "
        f"{[sc.retired for sc in outgoing]}, the live one retired at close "
        f"{[sc.retired for sc in current]}")
    log(f"  torch.cuda.memory_allocated above the start (cuBLAS workspaces "
        f"cleared before each reading): one generation {one_gen} B at deploy "
        f"(its params and the ladder's {len(service._buckets.buckets)} "
        f"buffers in 512-byte blocks: {expected} B), {live} B after the "
        f"reloads, {after} B after close; {smi}")
    if len(outgoing) != N_RELOADS or not all(sc.retired for sc in outgoing):
        raise AssertionError("an outgoing scorer was not retired")
    if one_gen != expected or live != one_gen or after != 0:
        raise AssertionError(f"device memory did not come back to one "
                             f"generation: {one_gen} / {after} B, expected "
                             f"{expected}")
    placement = resident_vs_mirror(variant, home, iids[-1], bodies, smi)
    log(f"  phase 38 {time.monotonic() - t_phase:.1f} s")
    return {"home": home, "engine_json": ej, "iids": iids, "latency": lat,
            "placement": placement}


#: the queries a client sends in each of phase 38's four residency runs:
#: 16 (64 at first, then 32; cut for the script's time)
P38_PER_CLIENT = 16


def resident_vs_mirror(variant, home, iid, bodies, smi) -> dict:
    """The newest instance under N_CLIENTS clients with its resident
    scorer on the card and with the host mirror, each with the batcher
    off and on: does residency pay under concurrency? Answers against
    the CPU copy of the same placement (int8 wire, or the host numpy)."""
    out = {}
    with cli_store(home):
        on = cpu_mirror(variant, iid)
        engine, ep = build_engine(variant)
        with knob("PIO_TPU_DEVICE_RESIDENT", "0"):
            off = QueryService(engine, ep, load_models_for_instance(
                iid, engine, ep, ComputeContext.local(0, device="cpu")),
                device="cpu")
        want = {"1": [on.query(json.dumps(b).encode()) for b in bodies],
                "0": [off.query(json.dumps(b).encode()) for b in bodies]}
        on.close()
        for resident in ("1", "0"):
            for window in ("0", str(MB_WINDOW_US)):
                with knob("PIO_TPU_DEVICE_RESIDENT", resident), \
                        knob(MB_KNOBS[0], window), knob(MB_KNOBS[1], "0"):
                    server = deploy_query_server(variant, host="127.0.0.1",
                                                 port=0, device=CARD)
                with server:
                    records, wall = drive_load(server.port, bodies,
                                               N_CLIENTS, P38_PER_CLIENT)
                for (i, _), answer in distinct_answers(records).items():
                    if answer != want[resident][i]:
                        raise AssertionError(
                            f"resident={resident} body {i}: {answer} vs "
                            f"the CPU copy {want[resident][i]}")
                lat = latency(records, wall)
                where = "the card" if resident == "1" else "the host mirror"
                log(f"  scoring on {where}, batcher "
                    f"{'on' if window != '0' else 'off'}, {N_CLIENTS} "
                    f"clients x {P38_PER_CLIENT}: p50 {lat['p50_ms']:.3f} ms, "
                    f"p99 {lat['p99_ms']:.3f} ms, {lat['qps']:.0f} "
                    f"queries/s; answers equal the CPU copy; {smi}")
                out[(resident, window)] = lat
    return out


def allocated() -> int:
    """``torch.cuda.memory_allocated`` after a collection, without the
    cuBLAS workspaces of the threads that ran products (PyTorch keeps one
    a thread's handle, from the same allocator)."""
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def compute_apps() -> str:
    """``nvidia-smi``'s compute apps, a line each. In a container its
    pids need not be this namespace's (an H100 host's container lists
    every context under pid 1), so only their count is used; which
    processes hold the card is read from /proc (:func:`holds_card`)."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def holds_card(pid: int) -> bool:
    """Has process ``pid`` a GPU's device file (/dev/nvidia<N>) open, as
    a process with a CUDA context on that GPU has?"""
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia\d+", target):
            return True
    return False


def child_pids(pid: int) -> set:
    """The processes whose parent is ``pid`` (from /proc)."""
    kids = set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            kids.add(int(entry))
    return kids


def wait_listening(home: str, proc) -> None:
    """Until ``deploy``'s log says "listening" (the pool, worker 0
    included, is ready), or fail once the process exited or
    POOL_TIMEOUT_S passed."""
    deadline = time.monotonic() + POOL_TIMEOUT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"the pool exited {proc.returncode}")
        with open(os.path.join(home, "deploy.log")) as f:
            if "listening" in f.read():
                return
        time.sleep(0.2)
    raise AssertionError(f"the pool was not ready in {POOL_TIMEOUT_S} s")


def every_worker(port: int, path: str, key, want=None,
                 n_workers: int = POOL_WORKERS) -> dict:
    """``GET path`` on fresh connections until each of the pool's
    ``n_workers`` workers has answered (and, with ``want``, answered it):
    {worker: answer}."""
    seen = {}
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        status, got = request(conn, "GET", path)
        conn.close()
        if status == 200 and (want is None or want(got)):
            seen[got[key]] = got
        if len(seen) == n_workers:
            return seen
    raise AssertionError(f"{path}: workers seen {sorted(seen)}")


def phase_pool(args, smi, reloaded) -> dict:
    """Phase 39: ``deploy --workers 4 --device-worker`` as a process."""
    t_phase = time.monotonic()
    home, ej = reloaded["home"], reloaded["engine_json"]
    log(f"phase 39: python -m pio_tpu_torch deploy --workers {POOL_WORKERS} "
        f"--device-worker over phase 38's instance: JSON and packed int8 "
        f"queries from {N_CLIENTS} clients, the lane, /reload, /undeploy; "
        f"{smi}")
    env = cli_env(home)
    port = free_port()
    variant = variant_from_dict(POOL_VARIANT, path=ej)
    bodies = pool_bodies(args.seed + 39)
    with cli_store(home):
        newest = reloaded["iids"][-1]
        mirror = cpu_mirror(variant, newest)
    want = [mirror.query(json.dumps(b).encode()) for b in bodies]
    frames = [mirror.pack_query_body(b) for b in bodies]
    mirror.close()
    t0 = time.monotonic()
    with cli_server(env, home, "deploy", "--engine-json", ej, "--ip",
                    "127.0.0.1", "--port", str(port), "--workers",
                    str(POOL_WORKERS), "--device-worker", "--device",
                    CARD.type) as proc:
        wait_listening(home, proc)
        up_s = time.monotonic() - t0
        workers = child_pids(proc.pid)
        status = every_worker(port, "/", "worker")
        device_pid = status[0]["pid"]
        records, wall = drive_load(port, bodies, N_CLIENTS, PER_CLIENT,
                                   frames=frames)
        for (i, _), answer in distinct_answers(records).items():
            if answer != want[i]:
                raise AssertionError(f"pool body {i}: {answer} vs the CPU "
                                     f"copy {want[i]}")
        stats = every_worker(port, "/stats.json", "worker")
        apps = compute_apps()
        holders = {p for p in workers | {proc.pid} if holds_card(p)}
        lane = {w: s.get("batchLane", {}) for w, s in stats.items()}
        drained = lane[0].get("drained", 0)
        fallbacks = {w: sum(lane[w].get("fallbacks", {}).values())
                     for w in range(1, POOL_WORKERS)}
        lat = latency(records, wall)
        log(f"  the pool up in {up_s:.1f} s (host clock), workers {sorted(status)} "
            f"serving instance {sorted({s['engineInstanceId'] for s in status.values()})}; "
            f"{lat['n']} answers (JSON and packed int8) equal the CPU copy; "
            f"p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms, "
            f"{lat['qps']:.0f} queries/s; {smi}")
        log(f"  worker 0 batchLane {json.dumps(lane[0])}, buckets "
            f"{json.dumps(stats[0]['buckets'])}; siblings' lane "
            f"{json.dumps({w: lane[w] for w in fallbacks})}")
        log(f"  nvidia-smi compute apps {apps.splitlines()}; this process "
            f"{os.getpid()}, the supervisor {proc.pid}, its children "
            f"{sorted(workers)} (worker 0: {device_pid}); the pool's "
            f"processes with the card's device file open {sorted(holders)}"
            f" (this process: {holds_card(os.getpid())})")
        # on the card: this process and worker 0, nothing else
        if not holds_card(os.getpid()) or holders != {device_pid} \
                or len(apps.splitlines()) != 2:
            raise AssertionError(f"the pool's processes on the card are "
                                 f"{sorted(holders)}, not worker 0 alone")
        if drained <= 0 or any(fallbacks.values()):
            raise AssertionError(f"lane drained {drained}, fallbacks "
                                 f"{fallbacks}")
        with cli_store(home):
            (new,) = pool_models(variant, (3,), ComputeContext.create(
                args.seed, device=CARD))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        code, got = request(conn, "POST", "/reload", {})
        conn.close()
        if code != 200 or got["engineInstanceId"] != new:
            raise AssertionError(f"pool /reload: {code} {got}")
        rolled = every_worker(port, "/", "worker",
                              lambda s: s["engineInstanceId"] == new)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        code, got = request(conn, "POST", "/undeploy", {})
        conn.close()
        rc = proc.wait(timeout=60)
        log(f"  /reload rolled workers {sorted(rolled)} to {new}; /undeploy "
            f"{code}, the pool exited {rc} after "
            f"{time.monotonic() - t0:.1f} s")
        if code != 200 or rc != 0:
            raise AssertionError(f"/undeploy {code}, the pool exited {rc}")
    log(f"  phase 39 {time.monotonic() - t_phase:.1f} s")
    return {"latency": lat, "drained": drained, "fallbacks": fallbacks,
            "holders": sorted(holders), "instance": new}


# ------------------------------------------- the device ops plane (phase 40)
#: PIO_TPU_PROFILE_EXECUTIONS of phase 40's serving capture
OPS_EXECUTIONS = 8
#: rounds of two-tower runs with and without the recorder (each round
#: plain, recorded, recorded, plain)
OPS_TT_RUNS = 1
#: steps of the two-tower runs whose kernels are counted with and without
#: the recorder
OPS_TT_COUNTED_STEPS = 20
#: the pool of phase 40: the device worker and one CPU worker
OPS_POOL_WORKERS = 2
#: 40.3's and 40.5's queries a client
OPS_PER_CLIENT = 16
#: steps of the lagged drain timed alone, on a loss already on the card
OPS_DRAIN_STEPS = 2000


def trace_kernels(path: str) -> collections.Counter:
    """{kernel name: launches} of a Chrome trace's kernel events."""
    with open(path) as f:
        trace = json.load(f)
    return collections.Counter(e["name"] for e in trace["traceEvents"]
                               if e.get("cat") == "kernel")


def launches_of(counts, name: str) -> int:
    """The launches of the kernel function ``name`` in ``counts``."""
    rx = re.compile(rf"\b{name}\b")
    return sum(n for k, n in counts.items() if rx.search(k))


def trace_complete(counts, where: str) -> int:
    """The sentinels a trace recorded; fail unless both of its window's
    ends were recorded (``obs/profile.py``)."""
    seen = sum(n for k, n in counts.items() if window.is_sentinel(k))
    WINDOW_SENTINELS.append(seen)
    if not window.window_complete(seen):
        raise AssertionError(f"{where}: {seen} of {2 * window.SENTINELS} "
                             f"sentinels recorded, the trace lost its ends")
    return seen


def counts_since(c0: dict) -> dict:
    c = read_counts()
    return {k: c[k] - c0[k] for k in c}


def get_text(port: int, path: str) -> tuple:
    """(status, body text) of one GET."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def kernel_counts(fn) -> dict:
    """{kernel: launches} of a call, in a guarded profiler window (``fn``
    leaves nothing behind: a window that lost an end is measured again)."""
    _, prof = guarded(fn, retry=True)
    return {e.key: e.count for e in _kernels(prof)}


def ops_train_trace(args, smi, text) -> None:
    """40.1: run_train of phase 29's text engine with ``profile_dir``: the
    trace's forward and bag-scatter launches against the same run's
    launch counters, the run ledger's new row, the wall against phase
    29's ``pio train`` of the same engine without a trace."""
    variant = variant_from_dict(text["variant"], path=text["engine_json"])
    trace_dir = os.path.join(CLI_HOMES, "ops_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    with cli_store(text["home"]):
        engine, ep = build_engine(variant)
        rows0 = len(trainwatch.read_runs(variant.engine_id))
        c0 = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iid = run_train(engine, ep, variant,
                        WorkflowParams(profile_dir=trace_dir),
                        ctx=ComputeContext.create(args.seed, device=CARD))
        wall = time.perf_counter() - t0
        counts = counts_since(c0)
        env = Storage.get_meta_data_engine_instances().get(iid).env
    rows = trainwatch.read_runs(variant.engine_id)[rows0:]
    traced = trace_kernels(os.path.join(trace_dir, window.TRACE_FILE))
    sentinels = trace_complete(traced, "run_train's trace")
    in_trace = {"embedding_bag": launches_of(traced, "embedding_bag_kernel"),
                "slot_records": launches_of(traced, "slot_records_kernel"),
                "bag_scatter": launches_of(traced, "bag_scatter_kernel")}
    steps = ep.algorithm_params_list[0][1].iterations
    log(f"  40.1 run_train of phase 29's engine with the trace: wall "
        f"{wall:.3f} s (train_seconds {env['train_seconds']}); phase 29's "
        f"pio train of it without a trace {text['walls']['train']:.3f} s "
        f"(host clock, in this process); the trace's launches "
        f"{json.dumps(in_trace)} ({sentinels} sentinels), the run's launch "
        f"counters {json.dumps(counts)}; {smi}")
    if in_trace["embedding_bag"] != counts["embedding_bag"] \
            or in_trace["slot_records"] != \
            counts["embedding_bag_backward_table"] \
            or in_trace["bag_scatter"] < in_trace["slot_records"] \
            or in_trace["embedding_bag"] < steps \
            or in_trace["slot_records"] < steps:
        raise AssertionError(f"the trace's launches {in_trace} are not the "
                             f"run's {counts}")
    want = [("COMPLETED", iid, {"phase_" + k[len("phase_"):].replace(
        ":", ".") for k in env if k.startswith("phase_")})]
    got = [(r["status"], r["run_id"],
            {k for k in r if k.startswith("phase_")}) for r in rows]
    log(f"  the run ledger gained {len(rows)} row: "
        f"{json.dumps([[st, i, sorted(k)] for st, i, k in got])}")
    if got != want:
        raise AssertionError(f"run ledger rows {got}, want {want}")


def ops_step_stream(args, smi) -> None:
    """40.2: two-tower at bench.py's shape, recorded, with the status
    sidecar: /train.json advancing, the recorded losses the steps' own
    bitwise, the same kernels and synchronizations a step without the
    recorder, the step time both ways."""
    u, i = tt_pairs()
    cfg = tt_config()
    server = create_train_status_server(port=0).start()
    port = server.port
    seen, device_rows, stop = [], [], threading.Event()

    def poll():
        while not stop.is_set():
            status, body = get_text(port, "/train.json")
            if status == 200:
                seen.append(json.loads(body)["step"])
                if not device_rows:
                    status, body = get_text(port, "/device.json")
                    if status == 200:
                        device_rows.extend(json.loads(body)["devices"])
            time.sleep(0.002)

    step_losses = []
    real_step = two_tower._train_step

    def noting_step(*a, **kw):
        out = real_step(*a, **kw)
        step_losses.append(out[2])
        return out

    try:
        before = get_text(port, "/train.json")[0]
        rec = trainwatch.StepRecorder("ops-two-tower", "two_tower",
                                      loss_window=TT_STEPS)
        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        two_tower._train_step = noting_step
        try:
            with trainwatch.recording(rec), devicewatch.watching(
                    devicewatch.DeviceWatch(device=CARD)):
                _, wall = tt_train(u, i, cfg)
        finally:
            two_tower._train_step = real_step
            stop.set()
            poller.join(timeout=30)
        after = get_text(port, "/train.json")[0]
    finally:
        server.stop()
    returned = torch.stack(step_losses).cpu().numpy()
    recorded = np.asarray(list(rec.losses), np.float32)
    advancing = sorted(set(seen))
    log(f"  40.2 two-tower at bench.py's shape, recorded: {wall:.3f} s; "
        f"/train.json {before} before the run, steps seen {advancing[:6]}...{advancing[-3:]} over "
        f"{len(seen)} polls, then {after}; /device.json during the run "
        f"{json.dumps(device_rows)}; {len(recorded)} recorded losses, "
        f"last {recorded[-1]:.6f}")
    if len([s for s in advancing if 0 < s < TT_STEPS]) < 2 \
            or seen != sorted(seen) or rec.steps_done != TT_STEPS:
        raise AssertionError(f"/train.json did not advance: {advancing}")
    if before != 503 or after != 503 or not device_rows \
            or device_rows[0]["source"] != "memory_stats":
        raise AssertionError(f"sidecar after the run {after}, device rows "
                             f"{device_rows}")
    if recorded.shape != returned.shape \
            or recorded.tobytes() != returned.tobytes():
        raise AssertionError("the recorded losses are not the steps' own")
    small = tt_config()
    small = dataclasses.replace(small, steps=OPS_TT_COUNTED_STEPS)
    plain_k = kernel_counts(lambda: tt_train(u, i, small))
    with trainwatch.recording(trainwatch.StepRecorder("ops-k", "two_tower")):
        rec_k = kernel_counts(lambda: tt_train(u, i, small))
    # the synchronizing calls of a run (torch.cuda's sync debug mode warns
    # at each), by the line that made them, in turns
    syncs = {"plain": collections.Counter(),
             "recorded": collections.Counter()}
    for mode in ("plain", "recorded", "recorded", "plain"):
        with warnings.catch_warnings(record=True) as caught, \
                contextlib.ExitStack() as stack:
            warnings.simplefilter("always")
            if mode == "recorded":
                stack.enter_context(trainwatch.recording(
                    trainwatch.StepRecorder("ops-s", "two_tower")))
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tt_train(u, i, small)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs[mode].update(f"{os.path.basename(w.filename)}:{w.lineno}"
                           for w in caught
                           if "synchronizing" in str(w.message))
    steps_s = {"plain": [], "recorded": []}
    for _ in range(OPS_TT_RUNS):
        for mode in ("plain", "recorded", "recorded", "plain"):
            stats = {}
            with contextlib.ExitStack() as stack:
                if mode == "recorded":
                    stack.enter_context(trainwatch.recording(
                        trainwatch.StepRecorder("ops-t", "two_tower")))
                tt_train(u, i, cfg, stats=stats)
            steps_s[mode].append(stats["steps_s"] / TT_STEPS * 1e3)
    med = {m: float(np.median(v)) for m, v in steps_s.items()}
    # the drain's own host work a step, alone: LaggedLosses.step on a
    # loss already on the card, sealed and drained as in a run
    loss = torch.zeros((), device=CARD)
    drain = trainwatch.LaggedLosses(
        trainwatch.StepRecorder("ops-d", "two_tower"), CARD, TT_BATCH,
        OPS_DRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OPS_DRAIN_STEPS):
        drain.step(loss)
    drain_us = (time.perf_counter() - t0) / OPS_DRAIN_STEPS * 1e6
    drain.close()
    log(f"  a step's kernels over {OPS_TT_COUNTED_STEPS} steps, plain "
        f"{sum(plain_k.values())} and recorded {sum(rec_k.values())} "
        f"launches ({len(plain_k)} kernels); synchronizing calls of two "
        f"runs each (torch.cuda sync debug mode), by line: "
        f"{json.dumps(syncs)}; ms a step "
        f"(stats steps_s / {TT_STEPS}, median of {2 * OPS_TT_RUNS}, host "
        f"clock) plain {med['plain']:.4f}, recorded {med['recorded']:.4f} "
        f"(runs {json.dumps(steps_s)}); the drain alone "
        f"{drain_us:.2f} us a step (host clock, {OPS_DRAIN_STEPS} steps); "
        f"{smi}")
    if plain_k != rec_k:
        raise AssertionError(f"the recorder changed a step's kernels: "
                             f"{plain_k} vs {rec_k}")
    added = syncs["recorded"] - syncs["plain"]
    if added:
        raise AssertionError(f"the recorder added synchronizations: {added}")


def ops_device_json(args, smi, text) -> None:
    """40.3: /device.json of phase 29's text engine deployed with the
    micro-batcher after a 32-client load, ``pio top --once`` on it."""
    variant = variant_from_dict(text["variant"], path=text["engine_json"])
    texts, _ = synth_corpus(np.random.default_rng(args.seed + 40),
                            OPS_PER_CLIENT, N_WORDS, coverage=False)
    bodies = [{"text": t} for t in texts]
    with cli_store(text["home"]), knob(MB_KNOBS[0], str(MB_WINDOW_US)), \
            knob(MB_KNOBS[1], "0"):
        server = deploy_query_server(variant, host="127.0.0.1", port=0,
                                     device=CARD)
    with server:
        ladder = list(server.service._buckets.buckets)
        drive_load(server.port, bodies, N_CLIENTS, OPS_PER_CLIENT)
        status, body = get_text(server.port, "/device.json")
        allocated_now = torch.cuda.memory_allocated()
        payload = json.loads(body)
        top = io.StringIO()
        with contextlib.redirect_stdout(top):
            top_rc = cli_main(["top", "--once", "--url",
                               f"http://127.0.0.1:{server.port}"])
        m_status, metrics = get_text(server.port, "/metrics")
    (row,) = payload["devices"]
    sites = payload["compiles"]["sites"]
    total = torch.cuda.get_device_properties(CARD).total_memory
    log(f"  40.3 /device.json of the deployed text engine after {N_CLIENTS} "
        f"clients x {OPS_PER_CLIENT}: {json.dumps(row)}; memory_allocated "
        f"{allocated_now}; compiles {json.dumps(sites)}; the ladder "
        f"{ladder}; {smi}")
    log("  pio top --once:\n    " + top.getvalue().rstrip().replace(
        "\n", "\n    "))
    if status != 200 or row["source"] != "memory_stats" \
            or row["bytesInUse"] != allocated_now \
            or row["limitBytes"] != total:
        raise AssertionError(f"/device.json {status} {row} against "
                             f"memory_allocated {allocated_now}, total "
                             f"{total}")
    if sites.get("bucket_warmup", {}).get("count") != len(ladder) \
            or sites.get("bucket_dispatch", {}).get("count", 0) != 0:
        raise AssertionError(f"compiles {sites} against the ladder {ladder}")
    if top_rc != 0 or "memory_stats" not in top.getvalue() \
            or "bucket_warmup" not in top.getvalue():
        raise AssertionError(f"pio top --once: {top_rc}")
    if m_status != 200 or 'pio_tpu_xla_compile_total{site="bucket_warmup"} ' \
            f"{len(ladder)}" not in metrics:
        raise AssertionError(f"/metrics {m_status}")


@contextlib.contextmanager
def ops_pool(reloaded):
    """40.3's ``deploy --workers 2 --device-worker`` pool over phase 38's
    instance, started on the way in (its processes come up beside the
    work of the block); yields the check of the CPU worker's ledger and
    its lack of a CUDA context, which ends the pool."""
    home, ej = reloaded["home"], reloaded["engine_json"]
    port = free_port()
    t0 = time.monotonic()
    with cli_server(cli_env(home), home, "deploy", "--engine-json", ej,
                    "--ip", "127.0.0.1", "--port", str(port), "--workers",
                    str(OPS_POOL_WORKERS), "--device-worker", "--device",
                    CARD.type) as proc:
        yield lambda: ops_pool_check(home, port, proc, t0)


def ops_pool_check(home: str, port: int, proc, t0: float) -> None:
    """40.3's pool: each worker's /device.json row and whether it holds
    the card, then /undeploy."""
    wait_listening(home, proc)
    by_worker, rows = {}, {}
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            len(by_worker) < OPS_POOL_WORKERS
            or len(rows) < OPS_POOL_WORKERS):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        code, got = request(conn, "GET", "/")
        conn.close()
        if code == 200:
            by_worker[got["worker"]] = got["pid"]
        code, body = get_text(port, "/device.json")
        if code == 200:
            (r,) = json.loads(body)["devices"]
            rows[r["device"]] = r
    holders = {w: holds_card(pid) for w, pid in by_worker.items()}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    code, _ = request(conn, "POST", "/undeploy", {})
    conn.close()
    rc = proc.wait(timeout=60)
    log(f"  40.3 the pool of {OPS_POOL_WORKERS} ({time.monotonic() - t0:.1f} s "
        f"from its start, beside 40.3-40.4 in this process): "
        f"/device.json rows {json.dumps(rows)}; workers' pids "
        f"{json.dumps(by_worker)}, holding the card {json.dumps(holders)}; "
        f"/undeploy {code}, exit {rc}")
    if set(rows) != {"cuda:0", "cpu:0"} \
            or rows["cuda:0"]["source"] != "memory_stats" \
            or rows["cpu:0"]["source"] != "ledger" \
            or holders != {0: True, 1: False} or code != 200 or rc != 0:
        raise AssertionError("the pool's device watches or card holders "
                             "are not the device worker's alone")


def ops_profile_hook(args, smi, text) -> None:
    """40.4: PIO_TPU_PROFILE with PIO_TPU_PROFILE_EXECUTIONS=8 on phase
    29's text engine deployed with the micro-batcher: the capture holds
    the forward launches of the first 8 dispatches, the bucket ladder's
    warmup sweeps and then live queries through the batcher (the warmup
    sweeps are executions of the hook, as the reference's); ``POST
    /debug/profile.json?restart=1`` captures the next 8 live queries into
    capture-0001."""
    variant = variant_from_dict(text["variant"], path=text["engine_json"])
    prof_dir = os.path.join(CLI_HOMES, "ops_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    with cli_store(text["home"]), knob("PIO_TPU_PROFILE", prof_dir), \
            knob("PIO_TPU_PROFILE_EXECUTIONS", str(OPS_EXECUTIONS)), \
            knob(MB_KNOBS[0], str(MB_WINDOW_US)), knob(MB_KNOBS[1], "0"):
        c0 = read_counts()
        server = deploy_query_server(variant, host="127.0.0.1", port=0,
                                     device=CARD)
        warm = counts_since(c0)["embedding_bag"]
    got = {}
    with server:
        ladder = list(server.service._buckets.buckets)
        live = OPS_EXECUTIONS - len(ladder)
        if live < 1:
            raise AssertionError(f"the ladder {ladder} fills the window of "
                                 f"{OPS_EXECUTIONS} executions alone")
        texts, _ = synth_corpus(np.random.default_rng(args.seed + 41),
                                live + 2 * OPS_EXECUTIONS, N_WORDS,
                                coverage=False)
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)

        def queries(ts):
            c0 = read_counts()
            for t in ts:
                code, _ = request(conn, "POST", "/queries.json", {"text": t})
                if code != 200:
                    raise AssertionError(f"query: {code}")
            return counts_since(c0)["embedding_bag"]

        first = queries(texts[:live])
        rest = queries(texts[live:live + OPS_EXECUTIONS])
        code, restarted = request(conn, "POST",
                                  "/debug/profile.json?restart=1", b"")
        again = queries(texts[live + OPS_EXECUTIONS:])
        code2, status = request(conn, "GET", "/debug/profile.json")
        conn.close()
        batched = server.service.stats()["microbatch"]
    for name, sub in (("first", ""), ("restart", "capture-0001")):
        counts = trace_kernels(os.path.join(prof_dir, sub, window.TRACE_FILE))
        got[name] = (launches_of(counts, "embedding_bag_kernel"),
                     trace_complete(counts, f"the {name} capture"))
    log(f"  40.4 PIO_TPU_PROFILE, {OPS_EXECUTIONS} executions, the "
        f"micro-batcher on: forward launches of the ladder's warmup "
        f"{ladder} {warm} and of the first {live} queries {first} (the "
        f"next {OPS_EXECUTIONS}: {rest}), in the capture {got['first'][0]} "
        f"({got['first'][1]} sentinels); restart {code} -> "
        f"{restarted.get('directory')}: {again} launches, in capture-0001 "
        f"{got['restart'][0]} ({got['restart'][1]} sentinels); status "
        f"{json.dumps(status)}; the batcher's batches "
        f"{batched['batches']} of {batched['batchedQueries']} queries")
    if got["first"][0] != warm + first or got["restart"][0] != again \
            or warm < len(ladder) or first < live \
            or again < OPS_EXECUTIONS or code != 200 or code2 != 200 \
            or status["captures"] != 1 or status["armed"] \
            or batched["batchedQueries"] != live + 2 * OPS_EXECUTIONS:
        raise AssertionError(f"the captures {got} hold other launches than "
                             f"the dispatches' {warm} + {first}, {again}")


def ops_sampler_cost(args, smi, text) -> None:
    """40.5: the sampler's cost: p50 and queries/s of phase 29's text
    models served from 1 and 32 clients (x OPS_PER_CLIENT queries), with
    PIO_TPU_DEVICEWATCH=0 and then on."""
    variant = variant_from_dict(text["variant"], path=text["engine_json"])
    texts, _ = synth_corpus(np.random.default_rng(args.seed + 42),
                            OPS_PER_CLIENT, N_WORDS, coverage=False)
    bodies = [{"text": t} for t in texts]
    with cli_store(text["home"]):
        engine, ep = build_engine(variant)
        iid = Storage.get_meta_data_engine_instances().get_latest_completed(
            variant.engine_id, variant.engine_version, variant.path).id
        models = load_models_for_instance(
            iid, engine, ep, ComputeContext.create(args.seed, device=CARD))
    out = {}
    for flag in ("0", "1"):
        with knob("PIO_TPU_DEVICEWATCH", flag):
            server = create_query_server(engine, ep, models, host="127.0.0.1",
                                         port=0, device=CARD)
        with server:
            sampling = server.service.devwatch._thread is not None
            for n_clients in (1, N_CLIENTS):
                records, wall = drive_load(server.port, bodies, n_clients,
                                           OPS_PER_CLIENT)
                out.setdefault((flag, n_clients), []).append(
                    latency(records, wall))
        if sampling != (flag == "1"):
            raise AssertionError(f"PIO_TPU_DEVICEWATCH={flag}: sampler "
                                 f"{sampling}")
    log(f"  40.5 the sampler (interval {knobs.knob_float(devicewatch.INTERVAL_ENV)}"
        f" s), host clock, one run each, off then on: " + "; ".join(
            f"PIO_TPU_DEVICEWATCH={f} {n} client(s): p50 "
            f"{[round(x['p50_ms'], 3) for x in runs]} ms, "
            f"{[round(x['qps']) for x in runs]} q/s"
            for (f, n), runs in sorted(out.items())) + f"; {smi}")


def phase_ops_plane(args, smi, text, reloaded) -> dict:
    """Phase 40: the device ops plane on the card."""
    t_phase = time.monotonic()
    log(f"phase 40: the device ops plane: run_train's trace, the two-tower "
        f"step stream with its sidecar, /device.json and pio top, the "
        f"serving profile hook, the sampler's cost; {smi}")
    c0 = read_counts()
    ops_train_trace(args, smi, text)
    ops_step_stream(args, smi)
    with ops_pool(reloaded) as pool_check:
        ops_device_json(args, smi, text)
        ops_profile_hook(args, smi, text)
        pool_check()
    ops_sampler_cost(args, smi, text)
    launches = counts_since(c0)
    log(f"  phase 40 launches (added to the kernels' line): "
        f"{json.dumps(launches)}; phase 40 {time.monotonic() - t_phase:.1f} s")
    return {"launches": launches}


# ----------------------------- the multi-device paths on one card (phase 41)
#: a 1-rank group's rendezvous and a 2-rank group's, on this host
MESH_ENV = ("PIO_TPU_COORDINATOR", "PIO_TPU_NUM_PROCESSES",
            "PIO_TPU_PROCESS_ID")
#: the serving mesh of 41.4 and 41.5: four shards on the one card
MESH_SHARDS = 4
#: users answered in 41.4
#: 41.4's users answered (cut from 1,024 for the script's time)
MESH_USERS = 256
#: 41.4's score limit against the unsharded scorer: a rank-16 f32 dot in
#: another product (~1e-6 of scores of O(5)); near-ties are counted
MESH_SCORE_TOL = 1e-5
#: 41.4's device memory a generation may hold beyond its padded tables
MESH_EXTRA_LIMIT = 2 << 20
#: 41.4's /reload count, over which the extra must not grow
#: 41.4's reloads (cut from 8 for the script's time)
MESH_RELOADS = 4
#: 41.3's two ranks: the steps of train_mlp held to the 1-rank run at the
#: CPU tests' limit (5 steps, 1e-5), and the gloo collectives probed
MESH_MLP_STEPS = 5
MESH_MLP_TOL = 1e-5
MESH_ALS_TOL = 1e-4  # of the factors, the CPU tests' trainer limit
MESH_PROBES = ("all_reduce", "reduce_scatter_tensor",
               "all_gather_into_tensor")
#: what NCCL 2.28 says, on each rank, when two ranks share one device
NCCL_REFUSAL = "Duplicate GPU detected"
#: a rank process's time limit (its start, the card's context, its work),
#: by task
MESH_RANK_TIMEOUT_S = {"nccl-two": 60, "gloo": 150, "neural-gloo": 150}


@contextlib.contextmanager
def mesh_env(world: int, rank: int, port: int):
    """The env contract of rank ``rank`` of ``world`` inside the block."""
    with knob("PIO_TPU_COORDINATOR", f"127.0.0.1:{port}"), \
            knob("PIO_TPU_NUM_PROCESSES", str(world)), \
            knob("PIO_TPU_PROCESS_ID", str(rank)):
        yield


def half_split(ctx, blocks, factors, n, chunk, cfg, iters: int = 5) -> dict:
    """Device ms of one group half-step's parts (CUDA events, the mean of
    ``iters`` after a warmup): partial_normal_eq, the reduce_scatter, the
    solve and the all_gather."""
    from pio_tpu_torch.parallel import distributed

    plan = als.segment_plan(blocks[0], chunk)
    K = factors.shape[1]

    def pne():
        return als.partial_normal_acc(*blocks, factors, n, chunk, plan=plan)

    acc = pne()
    mine = distributed.reduce_scatter_rows(acc, ctx.group)
    gram = als.gram_of(factors)

    def solve():
        return als.solve_block(mine[:, :K], mine[:, K], gram, cfg.reg)

    local = solve()
    parts = {
        "partial_normal_eq": pne,
        "reduce_scatter": lambda: distributed.reduce_scatter_rows(
            acc, ctx.group),
        "solve": solve,
        "all_gather": lambda: distributed.all_gather_rows(local, ctx.group),
    }
    return {k: cuda_ms(fn, iters=iters, warmup=1) for k, fn in parts.items()}


def mesh_als(args, smi, ctx, single) -> None:
    """41.1: train_als at MovieLens-25M's shape in the 1-rank NCCL group,
    both wires, against phase 11's single-device factors."""
    u, i, r = synth_ratings(ML25M_EDGES, ML25M_USERS, ML25M_ITEMS, args.seed,
                            "half")
    cfg = als.ALSConfig(rank=16, iterations=10, reg=0.1, seed=args.seed)
    for wire in ("compact", "blocked"):
        stats = {}
        with knob("PIO_TPU_ALS_MESH_WIRE", wire):
            t0 = time.monotonic()
            got = als.train_als(ctx, u, i, r, ML25M_USERS, ML25M_ITEMS, cfg,
                                stats=stats)
            wall = time.monotonic() - t0
        same = (np.array_equal(got.user_factors, single.user_factors)
                and np.array_equal(got.item_factors, single.item_factors))
        log(f"  41.1 {wire} wire ({stats['encoding']}, {stats['wire_bytes']} "
            f"B): {wall:.2f} s (host clock), pack {stats['pack_s']:.3f} s, "
            f"h2d {stats['h2d_s']:.3f} s, device {stats['device_s']:.3f} s; "
            f"factors equal phase 11's bit for bit: {same}; {smi}")
        if not same:
            raise AssertionError(f"41.1: the group's {wire} wire did not "
                                 f"give phase 11's factors")
    # one user half-step of the last run, split into its parts
    U_pad, I_pad, counts_u, _, shapes = als._layouts(
        u, i, ML25M_USERS, ML25M_ITEMS, cfg, ctx.world_size)
    host_u, _ = als._blocked_host(u, i, r, U_pad, I_pad, counts_u, shapes)
    blocks = als.blocks_of(tuple(torch.from_numpy(a).to(CARD)
                                 for a in host_u), ctx.rank, ctx.world_size)
    Q = torch.from_numpy(single.item_factors).to(CARD)
    split = half_split(ctx, blocks, Q, U_pad, shapes[0], cfg)
    log(f"  41.1 one user half-step at world size {ctx.world_size} "
        f"({U_pad} users, {blocks[0].shape[0]} blocks), device ms: "
        f"{json.dumps({k: round(v, 5) for k, v in split.items()})}; {smi}")


def mesh_mlp(args, smi, ctx, text) -> dict:
    """41.2: data-parallel train_mlp at the text template's defaults in the
    1-rank group, against phase 9's single-device parameters; its kernel
    launches (counters and a guarded profiler window) and the all_reduce's
    time a step."""
    from pio_tpu_torch.parallel import distributed

    engine, ep, pd, want = text["engine"], text["ep"], text["pd"], \
        text["params"]
    name, params = ep.algorithm_params_list[0]
    algo = engine.algorithm_class_map[name](params)
    def train():
        reset_counts()
        t0 = time.monotonic()
        trained = algo.train(ctx, pd)
        torch.cuda.synchronize()
        return trained, time.monotonic() - t0

    (model, wall), prof = guarded(train, retry=True)
    launches = read_counts()
    rows = {e.key: e.count for e in _kernels(prof)}
    in_window = {"embedding_bag": launches_of(rows, "embedding_bag_kernel"),
                 "bag_scatter": launches_of(rows, "bag_scatter_kernel")}
    got = {k: getattr(model.mlp, k).cpu().numpy()
           for k in ("w_in", "b_in", "w_out", "b_out")}
    same = all(np.array_equal(got[k], want[k]) for k in want)
    steps = params.iterations
    log(f"  41.2 train_mlp in the group: {wall:.2f} s (host clock) for "
        f"{steps} steps; parameters equal phase 9's bit for bit: {same}; "
        f"launch counters {json.dumps(launches)}, in the profiler window "
        f"{json.dumps(in_window)}; {smi}")
    log(f"  41.2 the profiler window: {sum(rows.values())} kernel launches "
        f"of {len(rows)} kernels, the forward's and kernel A's "
        f"{json.dumps(in_window)}")
    if not same:
        raise AssertionError("41.2: data-parallel train_mlp at world size 1 "
                             "did not give phase 9's parameters")
    if launches["embedding_bag"] != steps or \
            launches["embedding_bag_backward_table"] != steps or \
            set(in_window.values()) != {steps}:
        raise AssertionError(f"41.2: {launches} launches ({in_window} in "
                             f"the window) for {steps} steps")
    grads = [torch.zeros_like(getattr(model.mlp, k))
             for k in ("w_in", "b_in", "w_out", "b_out")]

    def all_reduce():
        for g in grads:
            distributed.all_reduce_sum(g, ctx.group)

    ms = cuda_ms(all_reduce, iters=20, warmup=2)
    nbytes = sum(g.numel() * 4 for g in grads)
    log(f"  41.2 the gradients' all_reduce (4 tensors, {nbytes} B, world "
        f"size {ctx.world_size}): {ms:.5f} ms a step; {smi}")
    return {"launches": launches, "in_window": in_window,
            "all_reduce_ms": ms}


def rank_main(task: str, out: str) -> int:
    """A rank process of 41.3 or 42.2 (``chip_smoke.py --mesh-rank TASK
    --mesh-out FILE``): joins the group of the env contract and runs
    ``task``, writing what it found to ``out`` (npz)."""
    from pio_tpu_torch.parallel import distributed

    result = {}
    try:
        if task == "nccl-two":
            ctx = ComputeContext.create(device=CARD)
            x = torch.ones(4, device=ctx.device)
            distributed.all_reduce_sum(x, ctx.group)
            torch.cuda.synchronize()
            result["nccl"] = f"ok: all_reduce gave {x[0].item()}"
        elif task == "neural-gloo":
            ctx = ComputeContext.create(device=CARD, backend="gloo")
            result.update(neural_ranks_work(ctx, out))
            if result["p2p"] != "ok":
                # a refused send may have broken the ranks' gloo pair, and
                # a barrier or teardown over it could wait for minutes:
                # the process ends here, its results saved
                np.savez(out, **result)
                sys.stdout.flush()
                os._exit(0)
        else:
            ctx = ComputeContext.create(device=CARD, backend="gloo")
            probes = mesh_probe(ctx)
            result["probes"] = json.dumps(probes)
            result.update(mesh_ranks_work(ctx, out))
        distributed.barrier()
    except Exception as e:  # what the card said, for the parent's record
        result["error"] = f"{type(e).__name__}: {str(e)[:400]}"
    np.savez(out, **result)
    distributed.shutdown()
    return 0


def mesh_probe(ctx) -> dict:
    """Which collectives gloo carries on CUDA tensors: {name: "ok" or the
    error}."""
    import torch.distributed as dist

    got = {}
    world, r = ctx.world_size, ctx.rank
    cases = {
        "all_reduce": lambda: dist.all_reduce(
            torch.full((4,), float(r + 1), device=ctx.device),
            group=ctx.group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device=ctx.device),
            torch.ones(2 * world, device=ctx.device), group=ctx.group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(2 * world, device=ctx.device),
            torch.ones(2, device=ctx.device), group=ctx.group),
    }
    for name in MESH_PROBES:
        try:
            cases[name]()
            torch.cuda.synchronize()
            got[name] = "ok"
        except Exception as e:
            got[name] = f"{type(e).__name__}: {str(e)[:200]}"
    return got


def mesh_ranks_work(ctx, out: str) -> dict:
    """A 2-rank gloo group's train_als at MovieLens-100K's shape and
    train_mlp at the text defaults (MESH_MLP_STEPS steps) on the card;
    the bags from the parent's file beside ``out``."""
    seed = int(os.environ["CHIP_SMOKE_SEED"])
    u, i, r = synth_ratings(ML100K_EDGES, ML100K_USERS, ML100K_ITEMS, seed,
                            "int")
    f = als.train_als(ctx, u, i, r, ML100K_USERS, ML100K_ITEMS,
                      als.ALSConfig(rank=16, iterations=10, reg=0.1,
                                    seed=seed))
    bags = np.load(out + ".bags.npz")
    m = mlp.train_mlp(ctx, bags["ids"], bags["w"], bags["y"],
                      int(bags["V"]), int(bags["C"]),
                      mlp.MLPConfig(iterations=MESH_MLP_STEPS, seed=seed))
    return {"user_factors": f.user_factors, "item_factors": f.item_factors,
            **{k: getattr(m, k).cpu().numpy()
               for k in ("w_in", "b_in", "w_out", "b_out")}}


def ranks_started(task: str, world: int, home: str, seed: int,
                  port: int = 0):
    """``world`` rank processes of this script running ``task`` on the
    card, their rendezvous on ``port`` (a free one if 0), started: a
    function that waits for them (each stopped by its time limit) and
    returns (their npz results by rank, s from the start)."""
    port = port or free_port()
    procs, outs = [], []
    t0 = time.monotonic()
    for rank in range(world):
        out = os.path.join(home, f"{task}-{rank}.npz")
        outs.append(out)
        env = dict(os.environ, PIO_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   PIO_TPU_NUM_PROCESSES=str(world),
                   PIO_TPU_PROCESS_ID=str(rank), CHIP_SMOKE_SEED=str(seed),
                   PYTHONPATH=ROOT)
        log_f = open(os.path.join(home, f"{task}-{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", task,
             "--mesh-out", out], cwd=ROOT, env=env, stdout=log_f,
            stderr=subprocess.STDOUT), log_f))
    deadline = t0 + MESH_RANK_TIMEOUT_S[task]

    def ended() -> tuple:
        try:
            for p, _ in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        wall = time.monotonic() - t0
        results = []
        for rank, ((p, log_f), out) in enumerate(zip(procs, outs)):
            hung = p.poll() is None
            if hung:
                p.kill()
                p.wait(timeout=60)
            log_f.close()
            got = dict(np.load(out)) if os.path.exists(out) else {}
            if hung:
                got["error"] = (f"no answer in {MESH_RANK_TIMEOUT_S[task]} "
                                f"s; killed ({got.get('error', '')})")
            elif not got:
                with open(os.path.join(home, f"{task}-{rank}.log")) as f:
                    got["error"] = f"exited {p.returncode}: {f.read()[-600:]}"
            results.append(got)
        return results, wall

    return ended


def spawn_ranks(task: str, world: int, home: str, seed: int) -> list:
    """:func:`ranks_started` to its end: the ranks' results."""
    return ranks_started(task, world, home, seed)()[0]


def mesh_two_ranks(args, smi, text) -> dict:
    """41.3: two ranks on cuda:0. NCCL refuses two ranks on one device
    (each rank's error names the duplicate GPU) and gloo carries CUDA
    tensors for the three collectives the paths use, as found on an NVIDIA
    H100 (PERF.md); either changing fails the phase. Then ALS at
    MovieLens-100K's shape and train_mlp at the text defaults in a 2-rank
    gloo group on the card, held to the 1-rank results at the CPU tests'
    limits."""
    home = fresh_home("mesh-ranks")
    pd = text["pd"]
    np.savez(os.path.join(home, "gloo-0.npz.bags.npz"), ids=pd.ids,
             w=pd.weights, y=pd.label_codes.astype(np.int64),
             V=pd.vectorizer.n_features, C=len(pd.label_index))
    shutil.copy(os.path.join(home, "gloo-0.npz.bags.npz"),
                os.path.join(home, "gloo-1.npz.bags.npz"))
    # the two groups at once, each on a rendezvous of its own
    nccl_port = gloo_port = free_port()
    while gloo_port == nccl_port:
        gloo_port = free_port()
    nccl_ended = ranks_started("nccl-two", 2, home, args.seed, nccl_port)
    gloo_ended = ranks_started("gloo", 2, home, args.seed, gloo_port)
    nccl, nccl_s = nccl_ended()
    gloo, gloo_s = gloo_ended()
    nccl_str = [str(g.get("nccl", g.get("error", ""))) for g in nccl]
    log(f"  41.3 NCCL, two ranks on cuda:0 ({nccl_s:.1f} s, beside the gloo "
        f"ranks): rank 0 {nccl_str[0]!r}; rank 1 {nccl_str[1]!r}")
    probes = [json.loads(str(g["probes"])) if "probes" in g else
              {"error": str(g.get("error"))} for g in gloo]
    log(f"  41.3 gloo on CUDA tensors, two ranks on cuda:0 ({gloo_s:.1f} s): "
        f"{json.dumps(probes)}")
    if not all(NCCL_REFUSAL in said for said in nccl_str):
        raise AssertionError(f"41.3: NCCL did not refuse two ranks on one "
                             f"device as recorded: {nccl_str}")
    if not all(p.get(n) == "ok" for p in probes for n in MESH_PROBES):
        raise AssertionError(f"41.3: gloo did not carry every collective "
                             f"on CUDA tensors: {probes}")
    errors = [str(g["error"]) for g in gloo if "error" in g]
    if errors:
        raise AssertionError(f"41.3: a gloo rank failed: {errors}")
    # the 1-rank results: the local paths (world size 1 is bitwise them).
    # ALS at the two ranks' padded entity counts, so that both draw the
    # same initial factors (the padding row has no ratings)
    u, i, r = synth_ratings(ML100K_EDGES, ML100K_USERS, ML100K_ITEMS,
                            args.seed, "int")
    one = als.train_als(ComputeContext.local(args.seed, device=CARD), u, i, r,
                        -(-ML100K_USERS // 2) * 2, -(-ML100K_ITEMS // 2) * 2,
                        als.ALSConfig(rank=16, iterations=10, reg=0.1,
                                      seed=args.seed))
    m1 = mlp.train_mlp(ComputeContext.local(args.seed, device=CARD), pd.ids,
                       pd.weights, pd.label_codes, pd.vectorizer.n_features,
                       len(pd.label_index),
                       mlp.MLPConfig(iterations=MESH_MLP_STEPS,
                                     seed=args.seed))
    errs = {}
    for k, want in (("user_factors", one.user_factors[:ML100K_USERS]),
                    ("item_factors", one.item_factors[:ML100K_ITEMS])):
        errs[k] = float(np.abs(gloo[0][k] - want).max())
    for k in ("w_in", "b_in", "w_out", "b_out"):
        errs[k] = float(np.abs(gloo[0][k] - getattr(m1, k).cpu().numpy()).max())
    ranks_same = all(np.array_equal(gloo[0][k], gloo[1][k]) for k in errs)
    log(f"  41.3 two gloo ranks against one, max |diff|: "
        f"{json.dumps(errs)}; the ranks hold the same bits: {ranks_same}; "
        f"limits ALS {MESH_ALS_TOL}, train_mlp {MESH_MLP_TOL}; {smi}")
    bad = {k: v for k, v in errs.items()
           if v > (MESH_ALS_TOL if k.endswith("factors") else MESH_MLP_TOL)}
    if bad or not ranks_same:
        raise AssertionError(f"41.3: two ranks off the one-rank run: {bad}")
    return {"nccl_two_ranks_one_device": nccl_str,
            "gloo_cuda_collectives": probes, "errs": errs}


def store_instance(variant, models, sharded_over: int = 0) -> str:
    """A COMPLETED engine instance of ``variant`` holding ``models`` in
    the current store, persisted as ``run_train`` persists (with
    ``sharded_over``, as row shards over that many devices)."""
    from pio_tpu_torch.storage.records import EngineInstance, Model, RunStatus
    from pio_tpu_torch.workflow import core_workflow, shard_store

    now = dt.datetime.now(dt.timezone.utc)
    iid = Storage.get_meta_data_engine_instances().insert(EngineInstance(
        id="", status=RunStatus.COMPLETED, start_time=now, end_time=now,
        engine_id=variant.engine_id, engine_version=variant.engine_version,
        engine_variant=variant.path or variant.engine_id,
        engine_factory=variant.engine_factory))
    store = Storage.get_model_data_models()
    if sharded_over:
        models = shard_store.save_sharded(store, iid, models, sharded_over,
                                          [sharded_over])
    blob = core_workflow.serialize_models(models)
    store.insert(Model(id=iid, models=blob))
    store.insert(Model(id=iid + core_workflow.MANIFEST_SUFFIX,
                       models=json.dumps({
                           "sha256": __import__("hashlib").sha256(
                               blob).hexdigest(), "size": len(blob)},
                           sort_keys=True).encode()))
    return iid


def near_tie_check(got: list, want_idx, want_val, items, where) -> int:
    """A served top-N (``itemScores``) against the unsharded scorer's
    indices and scores: the same items except where two candidates'
    scores lie within MESH_SCORE_TOL (returns 1 for such an answer),
    every score within MESH_SCORE_TOL."""
    served = [items[s["item"]] for s in got]
    scores = np.array([s["score"] for s in got])
    if len(served) != len(want_idx) or \
            np.abs(scores - want_val).max() > MESH_SCORE_TOL:
        raise AssertionError(f"{where}: {got} vs {want_idx} {want_val}")
    if served == [int(x) for x in want_idx]:
        return 0
    for k, (a, b) in enumerate(zip(served, want_idx)):
        if a != int(b) and abs(scores[k] - want_val[k]) > MESH_SCORE_TOL:
            raise AssertionError(f"{where}: item {a} at {k}, not {b}")
    return 1


def live_blocks() -> list:
    """The CUDA allocator's live blocks that were allocated while memory
    history was recording: ``(where, size, requested size)`` each, where
    is the innermost frame in this repository (``file:line function``).
    Taken after :func:`allocated`, so no freed block or cuBLAS workspace
    is among them."""
    out = []
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for blk in seg["blocks"]:
            frames = blk.get("frames") or []
            if blk["state"] != "active_allocated" or not frames:
                continue
            ours = [f for f in frames if "pio_tpu_torch" in f["filename"]
                    or f["filename"].endswith("chip_smoke.py")]
            top = ours[0] if ours else frames[0]
            out.append((f"{os.path.relpath(top['filename'], ROOT)}:"
                        f"{top['line']} {top['name']}", blk["size"],
                        blk["requested_size"]))
    return out


def mesh_serving(args, smi, factors) -> dict:
    """41.4: the recommendation template at MovieLens-25M's width with
    PIO_TPU_MESH_SERVE=1, the scorer sharded over (cuda:0,) * 4; 1,024
    users' top-10 against the unsharded scorer; /stats.json, /device.json
    and device memory over a deploy and MESH_RELOADS /reload, each
    generation's live blocks grouped by the code that allocated them
    (the allocator's memory history)."""
    n_users, rank = factors.user_factors.shape
    n_items = factors.item_factors.shape[0]
    users = BiMap({f"u{n}": n for n in range(n_users)})
    items = BiMap({f"i{n}": n for n in range(n_items)})
    model = RecModel.from_factors(factors, users, items, device="cpu")
    variant = variant_from_dict({
        "id": "mesh-serving", "engineFactory": "templates.recommendation",
        "datasource": {"params": {"app_name": "unused"}},
        "algorithms": [{"name": "als", "params": {"rank": int(rank)}}]})
    iid = store_instance(variant, [model], sharded_over=MESH_SHARDS)
    codes = np.random.default_rng(args.seed + 41).choice(
        n_users, MESH_USERS, replace=False).astype(np.int32)
    plain = topn.DeviceTopNScorer(factors.user_factors, factors.item_factors,
                                  device=CARD)
    want_idx, want_val = plain.top_n_batch(codes, 10)
    del plain
    before = allocated()
    mesh = (CARD,) * MESH_SHARDS
    torch.cuda.memory._record_memory_history(max_entries=200_000,
                                             stacks="python")
    try:
        with knob("PIO_TPU_MESH_SERVE", "1"):
            t0 = time.monotonic()
            server = deploy_query_server(variant, host="127.0.0.1", port=0,
                                         instance_id=iid, device=CARD,
                                         mesh_devices=mesh)
            deploy_s = time.monotonic() - t0
            with server:
                conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                                  timeout=60)
                near = 0
                t0 = time.monotonic()
                for k, c in enumerate(codes):
                    code, got = request(conn, "POST", "/queries.json",
                                        {"user": f"u{int(c)}", "num": 10})
                    if code != 200:
                        raise AssertionError(f"41.4 query {k}: {code} {got}")
                    near += near_tie_check(got["itemScores"], want_idx[k],
                                           want_val[k], items,
                                           f"41.4 user {c}")
                q_s = time.monotonic() - t0
                _, stats = request(conn, "GET", "/stats.json")
                _, device = request(conn, "GET", "/device.json")
                # a generation: the deploy (its 1,024 queries), then each
                # /reload with 64 queries after it
                gens = [("deploy", allocated(), live_blocks())]
                reload_codes = set()
                for r in range(MESH_RELOADS):
                    code, _ = request(conn, "POST", "/reload", {})
                    reload_codes.add(code)
                    for c in codes[:64]:
                        reload_codes.add(request(conn, "POST", "/queries.json", {
                            "user": f"u{int(c)}", "num": 10})[0])
                    gens.append((f"reload {r + 1}", allocated(),
                                 live_blocks()))
                conn.close()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    sh = stats["sharding"]
    (m,) = sh["models"]
    rows_pad = -(-n_users // MESH_SHARDS) * MESH_SHARDS
    cols_pad = -(-n_items // MESH_SHARDS) * MESH_SHARDS
    per_device = (rows_pad + cols_pad) * rank * 4 // MESH_SHARDS
    shard_ledger = device["ledger"]["byCategory"].get("shard")
    log(f"  41.4 deploy {deploy_s:.2f} s (host clock; the blob restored "
        f"from {MESH_SHARDS} shard records and placed in {MESH_SHARDS} "
        f"shards); {MESH_USERS} users' top-10 in {q_s:.2f} s over HTTP; "
        f"answers as the unsharded scorer's, {near} with a near-tie "
        f"reordered (|score gap| <= {MESH_SCORE_TOL}); {smi}")
    log(f"  41.4 /stats.json sharding {json.dumps(sh)}")
    tables = MESH_SHARDS * per_device
    extra = [g - before - tables for _, g, _ in gens]
    log(f"  41.4 /device.json shard ledger {shard_ledger} B; "
        f"memory_allocated {before} before the deploy; the tables padded: "
        f"{tables} B; beyond them after the deploy and each of "
        f"{MESH_RELOADS} /reload: {extra} B")
    # each generation's live blocks in two parts: the scorer's shards (the
    # requested bytes, and the allocator's slack: a block reused from its
    # cache keeps a remainder it does not split, under 1 MiB a block) and
    # every other block allocated since the deploy began
    parts = []
    for (name, _, blocks), e in zip(gens, extra):
        shards = [b for b in blocks if "_place_sharded" in b[0]]
        rest = [b for b in blocks if "_place_sharded" not in b[0]]
        part = {"shard_blocks": len(shards),
                "shard_requested": sum(b[2] for b in shards),
                "shard_slack": sum(b[1] - b[2] for b in shards),
                "largest_slack": max((b[1] - b[2] for b in shards),
                                     default=0),
                "other_bytes": sum(b[1] for b in rest),
                "other": sorted({b[0] for b in rest})}
        parts.append(part)
        log(f"  41.4 {name}: {e} B beyond the tables; live blocks since the "
            f"deploy began: {json.dumps(part)}")
    if not (sh["enabled"] and sh["meshDevices"] == MESH_SHARDS
            and m["nDevices"] == MESH_SHARDS
            and m["bytesPerDevice"] == per_device):
        raise AssertionError(f"41.4 sharding block {sh}")
    # a generation holds the tables once: at the deploy and at each
    # /reload the growth over the memory before the deploy is the padded
    # tables plus the allocator's slack on them, held under
    # MESH_EXTRA_LIMIT (2 MiB): it lies above what this script has measured
    # on an NVIDIA H100 80GB HBM3 at 700 W (2,560-224,768 B after a
    # /reload, 1,003,520 B after a fresh process's first deploy) and below
    # the smallest fault, a second copy of the item table (n_items padded
    # x rank x 4 B: 3,779,072 B at MovieLens-25M's width)
    if cols_pad * rank * 4 <= MESH_EXTRA_LIMIT:
        raise AssertionError(f"41.4: a second item table ({cols_pad} x "
                             f"{rank} x 4 B) fits under the limit")
    if shard_ledger != tables or \
            not all(0 <= e < MESH_EXTRA_LIMIT for e in extra):
        raise AssertionError(f"41.4: the shard ledger or device memory "
                             f"({extra} B over the tables) is not the "
                             f"padded tables once a generation")
    # each part on its own, the same after every /reload (nothing grows):
    # the shards ask for the padded tables exactly, in one block a table a
    # device; their slack covers the extra (blocks alive before the deploy
    # can only have been freed), under 1 MiB and a rounding a block; no
    # other block lives on
    for (name, _, _), e, part in zip(gens, extra, parts):
        if part["shard_requested"] != tables or \
                part["shard_blocks"] != 2 * MESH_SHARDS or \
                e > part["shard_slack"] or \
                part["largest_slack"] > (1 << 20) + 511 or \
                part["other_bytes"]:
            raise AssertionError(f"41.4 {name}: the live blocks are not the "
                                 f"shards and their slack: {part}, {e} B "
                                 f"beyond the tables")
    if reload_codes != {200}:
        raise AssertionError(f"41.4 /reload or a query after it: "
                             f"{sorted(reload_codes)}")
    return {"near_ties": near, "per_device": per_device, "deploy_s": deploy_s,
            "extra": extra, "parts": parts}


def mesh_pool(args, smi) -> dict:
    """41.5: ``pio train`` (the CLI's main, in this process) with
    PIO_TPU_SHARDED_PERSIST=1 on SQLite at MovieLens-100K's shape, the
    shard manifest verified, then
    ``deploy --workers 2 --mesh-worker`` over (cuda:0,) * 4: worker 0
    alone on the card, sharded; worker 1 on the CPU; answers checked
    against the CPU copy of the blob as 41.4's are."""
    from pio_tpu_torch.workflow import shard_store

    home = fresh_home("mesh-pool")
    app = "mesh-ml100k"
    u, i, r = synth_ratings(ML100K_EDGES, ML100K_USERS, ML100K_ITEMS,
                            args.seed + 5, "int")
    t_evt = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
    with cli_store(home):
        app_id = Storage.get_meta_data_apps().insert(App(0, app))
        Storage.get_levents().write((
            Event("rate", "user", f"u{a}", "item", f"i{b}",
                  properties={"rating": float(c)},
                  event_time=t_evt + dt.timedelta(seconds=k))
            for k, (a, b, c) in enumerate(zip(u.tolist(), i.tolist(),
                                              r.tolist()))), app_id)
    ej = os.path.join(home, "engine.json")
    with open(ej, "w") as f:
        json.dump({"id": "mesh-cli", "engineFactory":
                   "templates.recommendation",
                   "datasource": {"params": {"app_name": app}},
                   "algorithms": [{"name": "als", "params": ALS_PARAMS}]}, f)
    env = dict(cli_env(home), PIO_TPU_SHARDED_PERSIST="1")
    said = io.StringIO()
    t0 = time.monotonic()
    with cli_store(home), knob("PIO_TPU_SHARDED_PERSIST", "1"), \
            contextlib.redirect_stdout(said):
        code = cli_main(["train", "--engine-json", ej, "--device",
                         CARD.type])
    train_s = time.monotonic() - t0
    if code != 0:
        raise AssertionError(f"41.5 pio train returned {code}: "
                             f"{said.getvalue()[-2000:]}")
    iid = re.search(r"engine instance (\S+)", said.getvalue()).group(1)
    variant = variant_from_dict(json.load(open(ej)), path=ej)
    engine, ep = build_engine(variant)
    with cli_store(home):
        verified = shard_store.verify_manifest(
            Storage.get_model_data_models(), iid)
        cpu_model, = load_models_for_instance(
            iid, engine, ep, ComputeContext.local(0, device="cpu"))
    log(f"  41.5 pio train (PIO_TPU_SHARDED_PERSIST=1, in this process): "
        f"{train_s:.2f} s; "
        f"instance {iid}; the shard manifest's sha256s verify over "
        f"{verified} shard records")
    port = free_port()
    rng = np.random.default_rng(args.seed + 42)
    bodies = [{"user": f"u{int(c)}", "num": 10}
              for c in rng.integers(0, ML100K_USERS, N_QS_HTTP)]
    t0 = time.monotonic()
    with cli_server(env, home, "deploy", "--engine-json", ej, "--ip",
                    "127.0.0.1", "--port", str(port), "--workers", "2",
                    "--mesh-worker", "--mesh-devices",
                    ",".join([CARD.type] * MESH_SHARDS), "--device",
                    CARD.type) as proc:
        wait_listening(home, proc)
        up_s = time.monotonic() - t0
        status = every_worker(port, "/", "worker", n_workers=2)
        stats = every_worker(port, "/stats.json", "worker", n_workers=2)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        for k, body in enumerate(bodies * 2):
            code, got = request(conn, "POST", "/queries.json", body)
            if code != 200:
                raise AssertionError(f"41.5 query {k}: {code} {got}")
            check_served(got, params_from_dict(RecQuery, body), cpu_model,
                         f"41.5 body {k}")
        conn.close()
        workers = child_pids(proc.pid)
        holders = {p for p in workers | {proc.pid} if holds_card(p)}
        owner = status[0]["pid"]
        sibling = status[1]["pid"]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        code, _ = request(conn, "POST", "/undeploy", {})
        conn.close()
        rc = proc.wait(timeout=60)
    log(f"  41.5 the pool up in {up_s:.1f} s; worker 0 sharding "
        f"{json.dumps(stats[0]['sharding'])}; worker 1 sharding "
        f"{json.dumps(stats[1]['sharding'])}; {2 * len(bodies)} answers "
        f"checked against the CPU copy; the card's device file held by "
        f"{sorted(holders)} (worker 0 {owner}, worker 1 {sibling}); "
        f"/undeploy {code}, exit {rc}; {smi}")
    if holders != {owner} or sibling in holders:
        raise AssertionError(f"41.5: {sorted(holders)} on the card, not "
                             f"worker 0 alone")
    if not stats[0]["sharding"].get("enabled") or \
            stats[0]["sharding"]["meshDevices"] != MESH_SHARDS or \
            stats[1]["sharding"] != {"enabled": False}:
        raise AssertionError("41.5: worker 0 not sharded, or worker 1 is")
    if code != 200 or rc != 0:
        raise AssertionError(f"41.5 /undeploy {code}, the pool exited {rc}")
    return {"verified": verified, "holders": sorted(holders)}


def text_inputs(args, engine, ep, iid, ctx) -> dict:
    """The prepared bags of a text instance's data and its mlp's stored
    parameters (host numpy): phase 9's, the baseline of 41.2 and 41.3."""
    td = engine.data_source_class(ep.data_source_params).read_training(ctx)
    pd = engine.preparator_class(ep.preparator_params).prepare(ctx, td)
    model = load_models_for_instance(iid, engine, ep, ctx)[0]
    return {"engine": engine, "ep": ep, "pd": pd, "params": {
        k: getattr(model.mlp, k).cpu().numpy()
        for k in ("w_in", "b_in", "w_out", "b_out")}}


def phase_mesh(args, smi, single_als, text) -> dict:
    """Phase 41: the multi-device paths on one card."""
    from pio_tpu_torch.parallel import distributed

    t_phase = time.monotonic()
    log(f"phase 41: the multi-device paths on one card: train_als and "
        f"data-parallel train_mlp in a 1-rank NCCL group, two ranks on "
        f"cuda:0, mesh serving over (cuda:0,) x {MESH_SHARDS}, sharded "
        f"persistence and deploy --mesh-worker; {smi}")
    with mesh_env(1, 0, free_port()):
        ctx = ComputeContext.create(args.seed, device=CARD)
    log(f"  the group: rank {ctx.rank} of {ctx.world_size}, backend "
        f"{torch.distributed.get_backend()}, device {ctx.device}, mesh "
        f"{list(ctx.mesh.shape)} over {ctx.mesh.mesh_dim_names}")
    try:
        t0 = time.monotonic()
        mesh_als(args, smi, ctx, single_als)
        als_s = time.monotonic() - t0
        t0 = time.monotonic()
        dp = mesh_mlp(args, smi, ctx, text)
        mlp_s = time.monotonic() - t0
    finally:
        distributed.shutdown()
    t0 = time.monotonic()
    two = mesh_two_ranks(args, smi, text)
    two_s = time.monotonic() - t0
    t0 = time.monotonic()
    serving = mesh_serving(args, smi, single_als)
    serve_s = time.monotonic() - t0
    t0 = time.monotonic()
    pool = mesh_pool(args, smi)
    pool_s = time.monotonic() - t0
    log(f"  phase 41 {time.monotonic() - t_phase:.1f} s: 41.1 {als_s:.1f}, "
        f"41.2 {mlp_s:.1f}, 41.3 {two_s:.1f}, 41.4 {serve_s:.1f}, 41.5 "
        f"{pool_s:.1f}")
    return {"launches": dp["launches"], "two_ranks": two,
            "serving": serving, "pool": pool}


# ------------------- the neural templates over a mesh on one card (phase 42)
#: 42.2's steps of each two-rank run, held to one rank's at NEURAL_TOL
NEURAL_MESH_STEPS = 3
#: 42.2's runs on two gloo ranks: name, trainer, mesh spec, config; the
#: second list needs point-to-point sends (ring attention, the pipeline)
NEURAL_MESH_RUNS = [
    ("tt_data2", "tt", dict(data=2), {}),
    ("tt_model2", "tt", dict(data=1, model=2), {}),
    ("seq_model2", "seq", dict(data=1, model=2), {}),
    ("seq_seq2_ulysses", "seq", dict(data=1, seq=2),
     dict(attention="ulysses")),
]
NEURAL_P2P_RUNS = [
    ("seq_seq2_ring", "seq", dict(data=1, seq=2), {}),
    ("seq_pipe2", "seq", dict(data=1, pipe=2), {}),
]
#: 42.2's first-step gradients in float64 against one rank's, of each
#: leaf's largest (f64 sums of ~1e5 terms in another order: ~1e-13), and
#: the sequence model's histories they take
NEURAL_GRAD_TOL = 1e-9
#: the same over a seq axis with ring attention, which computes its
#: blocks' online softmax in f32 whatever the input (the reference's
#: arithmetic), in another order than the one block of one rank
NEURAL_RING_GRAD_TOL = NEURAL_TOL
NEURAL_GRAD_ROWS = 64
#: 42.2's loss of the trained parameters on the whole batch against one
#: rank's, relative: f32 steps in another order (a few elements off by
#: Adam's ±lr where a ReLU flipped at its kink move it by ~1e-7)
NEURAL_LOSS_RTOL = 1e-5
#: a gloo point-to-point receive's wait in 42.2's probe
P2P_PROBE_TIMEOUT = dt.timedelta(seconds=10)
#: 42.3's users answered
NEURAL_MESH_USERS = 256


def seq_params(model) -> dict:
    """A sequence model's parameters flat (``blocks.wq``...), host numpy."""
    out = {}
    for k, v in model.params.items():
        if isinstance(v, dict):
            out.update({f"{k}.{k2}": t.cpu().numpy() for k2, t in v.items()})
        else:
            out[k] = v.cpu().numpy()
    return out


def same_bits(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def neural_one_rank(args, smi, tt_model, seq_model) -> dict:
    """42.1: train_two_tower and train_seqrec (ring and ulysses) over the
    mesh of a 1-rank NCCL group at bench.py's shapes: phase 30's tables
    and phase 33's parameters bit for bit, and the collectives' device
    time (CUDA events around each)."""
    from pio_tpu_torch.parallel import collectives, distributed

    with mesh_env(1, 0, free_port()):
        ctx = ComputeContext.create(args.seed, device=CARD)
    out = {}
    try:
        u, i = tt_pairs()
        # a host-bound loop: its wall without the events, then with them
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bare = two_tower.train_two_tower(ctx.mesh, u, i, TT_USERS, TT_ITEMS,
                                         tt_config(), device=ctx.device)
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
        timer = collectives.CollectiveTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collectives.recording(timer):
            m = two_tower.train_two_tower(ctx.mesh, u, i, TT_USERS, TT_ITEMS,
                                          tt_config(), device=ctx.device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same = all(torch.equal(a.user_vectors, tt_model.user_vectors)
                   and torch.equal(a.item_vectors, tt_model.item_vectors)
                   for a in (bare, m))
        ms, n = timer.ms(), timer.counts()
        log(f"  42.1 train_two_tower over the 1-rank mesh "
            f"{list(ctx.mesh.shape)}: {bare_s:.3f} s, {wall:.3f} s with the "
            f"events (host clock); phase 30's tables bit for bit, both "
            f"runs: {same}; collectives "
            f"{json.dumps(n)} calls, device ms {json.dumps({k: round(v, 4) for k, v in ms.items()})}: "
            f"{sum(ms.values()) / TT_STEPS:.5f} ms a step over {TT_STEPS} "
            f"steps (the tables' gathers included); {smi}")
        out["tt"] = {"same": same, "wall_s": bare_s, "ms": ms, "calls": n}
        if not same:
            raise AssertionError("42.1: the 1-rank mesh's two-tower tables "
                                 "are not phase 30's")
        seqs = seq_histories()
        for attention in ("ring", "ulysses"):
            cfg = seq_config(attention=attention)
            want = seq_params(seq_model) if attention == "ring" else \
                seq_params(seq_train(seqs, cfg)[0])
            timer = collectives.CollectiveTimer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with collectives.recording(timer):
                got = seqrec.train_seqrec(ctx.mesh, seqs, SEQ_VOCAB, cfg,
                                          device=ctx.device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            same = same_bits(seq_params(got), want)
            ms, n = timer.ms(), timer.counts()
            log(f"  42.1 train_seqrec ({attention}) over the 1-rank mesh: "
                f"{wall:.3f} s (host clock, with the events); the "
                f"single-device parameters bit for bit "
                f"({'phase 33' if attention == 'ring' else 'a run here'}): "
                f"{same}; collectives {json.dumps(n)} calls, device ms "
                f"{json.dumps({k: round(v, 4) for k, v in ms.items()})}: "
                f"{sum(ms.values()) / SEQ_STEPS:.5f} ms a step over "
                f"{SEQ_STEPS} steps")
            out[f"seq_{attention}"] = {"same": same, "wall_s": wall,
                                       "ms": ms, "calls": n}
            if not same:
                raise AssertionError(f"42.1: the 1-rank mesh's {attention} "
                                     f"parameters are not the single "
                                     f"device's")
    finally:
        distributed.shutdown()
    return out


def neural_probe(ctx) -> dict:
    """Whether gloo carries all_to_all_single on CUDA tensors: {name: "ok"
    or the error}."""
    import torch.distributed as dist

    world, r = ctx.world_size, ctx.rank
    try:
        send = torch.full((world, 2), float(r), device=ctx.device)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=ctx.group)
        torch.cuda.synchronize()
        want = torch.arange(world, device=ctx.device).float()[:, None]
        return {"all_to_all_single": "ok" if torch.equal(
            recv, want.expand(world, 2)) else f"wrong values {recv.tolist()}"}
    except Exception as e:
        return {"all_to_all_single": f"{type(e).__name__}: {str(e)[:200]}"}


def p2p_probe(ctx) -> str:
    """Whether gloo carries a send and a receive of a CUDA tensor between
    the two ranks (the receive waits P2P_PROBE_TIMEOUT), agreed by both:
    "ok" or what failed."""
    import torch.distributed as dist

    said = "ok"
    try:
        x = torch.full((4,), 7.0, device=ctx.device)
        if ctx.rank == 0:
            dist.isend(x, 1).wait(timeout=P2P_PROBE_TIMEOUT)
        else:
            y = torch.zeros(4, device=ctx.device)
            dist.irecv(y, 0).wait(timeout=P2P_PROBE_TIMEOUT)
            torch.cuda.synchronize()
            if not torch.equal(y, x):
                said = f"wrong values {y.tolist()}"
    except Exception as e:
        said = f"{type(e).__name__}: {str(e)[:200]}"
    flags = torch.tensor([1.0 if said == "ok" else 0.0])
    dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=ctx.group)  # CPU
    if said == "ok" and flags.item() < 1:
        said = "the other rank failed"
    return said


def step_grad_err(ctx, mesh, kind, extra, u, i, seqs) -> float:
    """The first step's gradients over ``mesh`` in float64 (the trainer's
    init and batch, the sequence model's first NEURAL_GRAD_ROWS histories;
    this rank's slices, summed over the work axes and gathered whole)
    against the single-device path's on this rank's device: the largest
    |diff| of a leaf over its largest |gradient|. In f32 the row-parallel
    sums round otherwise than the single device's, which flips the few
    ReLUs whose input lies within that rounding of 0 at bench.py's
    widths; in f64 none does. Every rank computes it (the collectives
    need them all)."""
    from pio_tpu_torch.parallel import collectives as C
    from pio_tpu_torch.parallel.partition import gather_shards, local_shards

    dev, f64 = ctx.device, torch.float64
    if kind == "tt":
        cfg = tt_config()
        axes = (mesh.get_group("data"), mesh.get_group("model"))
        nm = C.axis_size(axes[1])
        init = two_tower.init_params(
            -(-TT_USERS // nm) * nm, -(-TT_ITEMS // nm) * nm, cfg,
            torch.Generator().manual_seed(cfg.seed))
        specs = two_tower.param_specs(init)
        perm = np.random.default_rng(cfg.seed).permutation(len(u))
        full = [torch.from_numpy(a[perm][:TT_BATCH]).to(dev) for a in (u, i)]
        b_loc = TT_BATCH // C.axis_size(axes[0])
        lo = C.axis_index(axes[0]) * b_loc
        mine = [a[lo:lo + b_loc] for a in full]
        work, single = [axes[0]], (None, None)

        def loss(tree, batch, ax):
            return two_tower._contrastive_loss(tree["user"], tree["item"],
                                               *batch, cfg, *ax)
    else:
        cfg = seq_config(**extra)
        axes = seqrec.MeshAxes.of(mesh)
        nm = C.axis_size(axes.model)
        init = seqrec.init_params(-(-(SEQ_VOCAB + 1) // nm) * nm, cfg,
                                  torch.Generator().manual_seed(cfg.seed))
        specs = seqrec.param_specs(init)
        full = [a[:NEURAL_GRAD_ROWS].to(f64) if a.is_floating_point()
                else a[:NEURAL_GRAD_ROWS] for a in seq_batch(seqs, dev)]
        b_loc = NEURAL_GRAD_ROWS // C.axis_size(axes.data)
        t_loc = SEQ_T // C.axis_size(axes.seq)
        r0 = C.axis_index(axes.data) * b_loc
        c0 = C.axis_index(axes.seq) * t_loc
        mine = [a[r0:r0 + b_loc, c0:c0 + t_loc].contiguous() for a in full]
        work, single = [axes.data, axes.seq], seqrec.MeshAxes()

        def loss(tree, batch, ax):
            return seqrec._loss(tree, *batch, cfg, ax)
    local = local_shards(mesh, init, specs)
    p = [t.to(dev, f64).requires_grad_(True) for t in adam.leaves(local)]
    grads = C.all_reduce_flat(torch.autograd.grad(
        loss(adam.rebuild(local, p), mine, axes), p), work)
    got = adam.leaves(gather_shards(
        mesh, adam.rebuild(local, grads), specs,
        adam.rebuild(init, [t.shape for t in adam.leaves(init)])))
    q = [t.to(dev, f64).requires_grad_(True) for t in adam.leaves(init)]
    want = torch.autograd.grad(loss(adam.rebuild(init, q), full, single), q)
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
               for a, b in zip(got, want))


def neural_ranks_work(ctx, out: str) -> dict:
    """42.2 in a rank: the probes, then NEURAL_MESH_RUNS (and, where gloo
    carries sends, NEURAL_P2P_RUNS) at bench.py's shapes for
    NEURAL_MESH_STEPS steps. Rank 0 keeps the results, rank 1 their
    digests; saved to ``out`` after each step of the work, so that a
    probe that ends the process leaves what came before it."""
    import hashlib

    from pio_tpu_torch.parallel.mesh import MeshSpec

    result = {"probes": json.dumps(neural_probe(ctx))}
    u, i = tt_pairs()
    seqs = seq_histories()

    def run(name, kind, spec, extra):
        mesh = ctx.mesh_for(MeshSpec(**spec))
        t0 = time.monotonic()
        if kind == "tt":
            m = two_tower.train_two_tower(
                mesh, u, i, TT_USERS, TT_ITEMS,
                dataclasses.replace(tt_config(), steps=NEURAL_MESH_STEPS),
                device=ctx.device)
            arrays = {"user": m.user_vectors.cpu().numpy(),
                      "item": m.item_vectors.cpu().numpy()}
        else:
            m = seqrec.train_seqrec(
                mesh, seqs, SEQ_VOCAB,
                dataclasses.replace(seq_config(**extra),
                                    steps=NEURAL_MESH_STEPS),
                device=ctx.device)
            arrays = seq_params(m)
        result[f"{name}.wall_s"] = time.monotonic() - t0
        result[f"{name}.grad_err"] = step_grad_err(ctx, mesh, kind, extra, u,
                                                   i, seqs)
        for k, a in arrays.items():
            if ctx.rank == 0:
                result[f"{name}.{k}"] = a
            result[f"{name}.{k}.sha"] = hashlib.sha256(a.tobytes()).hexdigest()

    a2a = json.loads(result["probes"])["all_to_all_single"] == "ok"
    for name, kind, spec, extra in NEURAL_MESH_RUNS:
        if extra.get("attention") == "ulysses" and not a2a:
            continue
        run(name, kind, spec, extra)
        np.savez(out, **result)
    try:
        result["p2p"] = p2p_probe(ctx)
    except Exception as e:  # the agreement's all_reduce over a broken pair
        result["p2p"] = f"{type(e).__name__}: {str(e)[:200]}"
    np.savez(out, **result)
    if result["p2p"] == "ok":
        for name, kind, spec, extra in NEURAL_P2P_RUNS:
            run(name, kind, spec, extra)
            np.savez(out, **result)
    return result


def seq_loss(flat: dict, seqs) -> float:
    """``train_seqrec``'s full-batch loss of flat parameters (``blocks.wq``
    ...) on the card, the vocabulary cut to the first SEQ_VOCAB + 1 rows."""
    params = {"blocks": {}}
    for k, a in flat.items():
        t = torch.from_numpy(np.ascontiguousarray(a)).to(CARD)
        if k.startswith("blocks."):
            params["blocks"][k[len("blocks."):]] = t
        else:
            params[k] = t
    params["emb"] = params["emb"][:SEQ_VOCAB + 1]
    with torch.no_grad():
        return float(seqrec._loss(params, *seq_batch(seqs, CARD),
                                  seq_config()))


def neural_two_ranks(args, smi) -> dict:
    """42.2: two gloo ranks on cuda:0 (NCCL refuses two ranks on one
    device, 41.3): the probes of all_to_all_single and point-to-point on
    CUDA tensors, then two-tower over data 2 and model 2 and the sequence
    model over model 2, seq 2 (ulysses, and ring where gloo sends) and
    pipe 2 (where it sends), NEURAL_MESH_STEPS steps each at bench.py's
    shapes, held to the 1-rank runs (the single-device path, which a
    1-rank group gives bit for bit) at NEURAL_TOL. A collective gloo
    refuses on CUDA tensors is recorded, and the runs that need it rest
    on the CPU tests."""
    home = fresh_home("neural-ranks")
    t0 = time.monotonic()
    ranks = spawn_ranks("neural-gloo", 2, home, args.seed)
    spawn_s = time.monotonic() - t0
    errors = [str(g["error"]) for g in ranks if "error" in g]
    probes = [json.loads(str(g["probes"])) if "probes" in g else {}
              for g in ranks]
    p2p = [str(g.get("p2p", "not reached")) for g in ranks]
    log(f"  42.2 two gloo ranks on cuda:0 ({spawn_s:.1f} s): "
        f"all_to_all_single {json.dumps(probes)}; send/recv {p2p}")
    if errors:
        raise AssertionError(f"42.2: a gloo rank failed: {errors}")
    # the 1-rank baselines: the single-device path at the same steps (the
    # model-2 sequence run pads its vocabulary to 20,002 rows, a
    # single-device run over 20,001 items)
    u, i = tt_pairs()
    seqs = seq_histories()
    tt1 = two_tower.train_two_tower(
        None, u, i, TT_USERS, TT_ITEMS,
        dataclasses.replace(tt_config(), steps=NEURAL_MESH_STEPS),
        device=CARD)
    base = {"tt": {"user": tt1.user_vectors.cpu().numpy(),
                   "item": tt1.item_vectors.cpu().numpy()}}

    def seq_base(n_items, **kw):
        return seq_params(seqrec.train_seqrec(
            None, seqs, n_items,
            dataclasses.replace(seq_config(**kw), steps=NEURAL_MESH_STEPS),
            device=CARD))

    errs, refused = {}, {}
    for name, kind, spec, extra in NEURAL_MESH_RUNS + NEURAL_P2P_RUNS:
        keys = [k[len(name) + 1:-4] for k in ranks[1] if
                k.startswith(name + ".") and k.endswith(".sha")]
        if not keys:
            refused[name] = ("all_to_all_single: " + json.dumps(probes[0])
                             if extra.get("attention") == "ulysses"
                             else "send/recv: " + p2p[0])
            continue
        if kind == "tt":
            want = base["tt"]
        elif name == "seq_model2":
            want = seq_base(SEQ_VOCAB + 1)
            want["emb"] = want["emb"][:SEQ_VOCAB + 1]
        else:
            want = seq_base(SEQ_VOCAB, **extra)
        diffs = {k: np.abs(ranks[0][f"{name}.{k}"] - want[k]) for k in keys}
        errs[name] = max(float(d.max()) for d in diffs.values())
        over = {k: [int((d > NEURAL_TOL).sum()), float(d.max())]
                for k, d in diffs.items() if d.max() > NEURAL_TOL}
        grad = float(ranks[0][name + ".grad_err"])
        same = all(str(ranks[0][f"{name}.{k}.sha"])
                   == str(ranks[1][f"{name}.{k}.sha"]) for k in keys)
        loss_rel = 0.0
        if kind == "seq":
            got_l, want_l = (seq_loss({k: a[k] for k in keys}, seqs)
                             for a in ({k: ranks[0][f"{name}.{k}"]
                                        for k in keys}, want))
            loss_rel = abs(got_l - want_l) / abs(want_l)
        log(f"  42.2 {name} {json.dumps(spec)}: "
            f"{float(ranks[0][name + '.wall_s']):.2f} s on rank 0 (host "
            f"clock); the parameters' max |diff| against one rank "
            f"{errs[name]:.3g} (limit {NEURAL_TOL}; over it, by parameter, "
            f"[elements, largest]: {json.dumps(over)}); the trained "
            f"parameters' loss on the batch against one rank's "
            f"{loss_rel:.3g} relative (limit {NEURAL_LOSS_RTOL}); the first "
            f"step's f64 gradients {grad:.3g} of each one's largest; the "
            f"ranks hold the same bits: {same}")
        # the parameters within NEURAL_TOL, or, where some flipped at a
        # ReLU's kink (the f32 sums' rounding), the trained loss
        grad_tol = NEURAL_RING_GRAD_TOL if spec.get("seq", 1) > 1 and \
            extra.get("attention", "ring") == "ring" else NEURAL_GRAD_TOL
        if grad > grad_tol or not same or (
                errs[name] > NEURAL_TOL and loss_rel > NEURAL_LOSS_RTOL):
            raise AssertionError(f"42.2: {name} off the one-rank run")
    if refused:
        log(f"  42.2 refused by gloo on CUDA tensors (their parity rests on "
            f"the CPU tests): {json.dumps(refused)}; {smi}")
    return {"probes": probes, "p2p": p2p, "errs": errs, "refused": refused}


def neural_mesh_serving(args, smi, tt_model) -> dict:
    """42.3: the two-tower template on phase 30's tables persisted as
    MESH_SHARDS shard records and served with PIO_TPU_MESH_SERVE=1 over
    (cuda:0,) x MESH_SHARDS: NEURAL_MESH_USERS users' top-10 against the
    unsharded scorer, near-ties counted, and /stats.json's sharding."""
    from pio_tpu_torch.templates.twotower import TwoTowerEngineModel
    from pio_tpu_torch.workflow import shard_store

    n_users, n_items = tt_model.user_vectors.shape[0], \
        tt_model.item_vectors.shape[0]
    users = BiMap({f"u{n}": n for n in range(n_users)})
    items = BiMap({f"i{n}": n for n in range(n_items)})
    host = two_tower.TwoTowerModel(tt_model.user_vectors.cpu(),
                                   tt_model.item_vectors.cpu(),
                                   tt_model.config)
    variant = variant_from_dict({
        "id": "neural-mesh-serving", "engineFactory": "templates.twotower",
        "datasource": {"params": {"app_name": "unused"}},
        "algorithms": [{"name": "twotower", "params": {}}]})
    iid = store_instance(variant, [TwoTowerEngineModel(host, users, items)],
                         sharded_over=MESH_SHARDS)
    verified = shard_store.verify_manifest(Storage.get_model_data_models(),
                                           iid)
    codes = np.random.default_rng(args.seed + 42).choice(
        n_users, NEURAL_MESH_USERS, replace=False).astype(np.int32)
    plain = topn.DeviceTopNScorer(tt_model.user_vectors,
                                  tt_model.item_vectors, device=CARD)
    want_idx, want_val = plain.top_n_batch(codes, 10)
    del plain
    with knob("PIO_TPU_MESH_SERVE", "1"):
        t0 = time.monotonic()
        server = deploy_query_server(variant, host="127.0.0.1", port=0,
                                     instance_id=iid, device=CARD,
                                     mesh_devices=(CARD,) * MESH_SHARDS)
        deploy_s = time.monotonic() - t0
        with server:
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=60)
            near = 0
            for k, c in enumerate(codes):
                code, got = request(conn, "POST", "/queries.json",
                                    {"user": f"u{int(c)}", "num": 10})
                if code != 200:
                    raise AssertionError(f"42.3 query {k}: {code} {got}")
                near += near_tie_check(got["itemScores"], want_idx[k],
                                       want_val[k], items, f"42.3 user {c}")
            _, stats = request(conn, "GET", "/stats.json")
            conn.close()
    sh = stats["sharding"]
    log(f"  42.3 two-tower tables ({n_users} + {n_items} x "
        f"{tt_model.item_vectors.shape[1]}) persisted as {verified} "
        f"verified shard records, deployed in {deploy_s:.2f} s (host clock) "
        f"over (cuda:0,) x {MESH_SHARDS}; {NEURAL_MESH_USERS} users' top-10 "
        f"as the unsharded scorer's, {near} with a near-tie reordered; "
        f"sharding {json.dumps(sh)}; {smi}")
    if not (sh["enabled"] and sh["meshDevices"] == MESH_SHARDS
            and sh["models"][0]["nDevices"] == MESH_SHARDS):
        raise AssertionError(f"42.3 sharding block {sh}")
    return {"near_ties": near, "verified": verified, "deploy_s": deploy_s}


def phase_neural_mesh(args, smi, tt_model, seq_model) -> dict:
    """Phase 42: the neural templates over a mesh on one card."""
    t_phase = time.monotonic()
    log(f"phase 42: the neural templates over a mesh on one card: "
        f"two-tower and the sequence model in a 1-rank NCCL group, two "
        f"gloo ranks on cuda:0, two-tower served sharded over (cuda:0,) x "
        f"{MESH_SHARDS}; {smi}")
    t0 = time.monotonic()
    one = neural_one_rank(args, smi, tt_model, seq_model)
    one_s = time.monotonic() - t0
    t0 = time.monotonic()
    two = neural_two_ranks(args, smi)
    two_s = time.monotonic() - t0
    t0 = time.monotonic()
    serving = neural_mesh_serving(args, smi, tt_model)
    serve_s = time.monotonic() - t0
    log(f"  phase 42 {time.monotonic() - t_phase:.1f} s: 42.1 {one_s:.1f}, "
        f"42.2 {two_s:.1f}, 42.3 {serve_s:.1f}")
    return {"one_rank": one, "two_ranks": two, "serving": serving}


# ---------------------------------------------------------------------------
# phase 43: the streamed epoch feed, the resident scorer's mesh, the failpoints
# ---------------------------------------------------------------------------
#: the trainers' feed lookahead (models/two_tower.py, seqrec.py)
STREAM_LOOKAHEAD = 2
#: 43.1's span size: the 4,030,464 B staged ids of bench.py's shape in 8
#: spans (n_stream = ceil(bytes / MB))
TT_STREAM_MB = "0.5"
#: MovieLens-25M's rating count, users and movies (bench.py:70-73)
ML25M_RATINGS, ML25M_USERS, ML25M_ITEMS = 25_000_095, 162_541, 59_047
#: 43.2: phase 33's shape in minibatches of 64 rows (4 a epoch), spans of
#: one batch (12 x 64 x 128 B = 98,304 B)
SEQ_STREAM_BATCH = 64
SEQ_STREAM_MB = "0.05"
#: 43.3: the wide classification case (PERF.md §7), its users, queries,
#: reloads and the near-tie bound of a served code
CLS_WIDE = 256
N_CLS_MESH_QUERIES = 200
N_CLS_MESH_BATCH = 1024
#: 43.3's reloads (cut from 8 for the script's time)
N_CLS_RELOADS = 4
#: a sharded logit against the unsharded one, relative to the magnitude
#: of its dot product's terms (|x|·|W| + |b|): the partial sums of f32
#: products in another order; and the top-two gap below which a code may
#: flip (a near-tie, counted)
CLS_TIE = 1e-5
CLS_MESH = (CARD,) * 4
#: 43.3: a /reload's device memory over the deploy's: the resident weights
#: once (a second copy of the wide weights is 3 KiB, so the limit is the
#: allocator's 512 B rounding of each live block: the scorers' and the
#: model's, under a dozen)
CLS_RELOAD_SLACK = 8 * 512
#: 43.4: the injected latency, and the queries a drill sends
FAULT_LATENCY_MS = 20
N_FAULT_QUERIES = 64


def stream_stats(stats: dict) -> str:
    return json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                       for k, v in stats.items()})


def busy_share(fn) -> tuple:
    """(the device's busy share of ``fn``'s wall, kernel ms, wall s): the
    profiler's kernel time of one (warm) call over the host clock's wall
    of that call."""
    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, prof = guarded(timed, retry=True)
    ms = sum(e.self_device_time_total for e in _kernels(prof)) / 1e3
    return ms / 1e3 / wall, ms, wall


def streamed_pair(name, train_staged, train_streamed, same, smi) -> dict:
    """Staged and streamed runs in turns, 3 each: (the walls, the median
    of each), every streamed run the staged run's bits (``same``)."""
    walls = {"staged": [], "streamed": []}
    first = None
    for _ in range(3):
        staged, w = train_staged()
        walls["staged"].append(w)
        streamed, w = train_streamed()
        walls["streamed"].append(w)
        if not same(streamed, staged):
            raise AssertionError(f"{name}: a streamed run differs from the "
                                 f"staged run")
        first = first or staged
    med = {k: float(np.median(v)) for k, v in walls.items()}
    log(f"  {name}: wall staged {med['staged']:.4f} s, streamed "
        f"{med['streamed']:.4f} s (median of 3, host clock, in turns: "
        f"{json.dumps({k: rounded(v) for k, v in walls.items()})}); the "
        f"streamed bits are the staged bits; {smi}")
    return {"walls": walls, "median": med, "model": first}


def feed_readings(name, train, n_leaves, smi) -> dict:
    """A streamed run's feed: its stats (serialized phases), the overlap
    ratio of a recorded run, the pinned buffers one run allocates, and the
    card's busy share of a run."""
    stats = {}
    train(stats=stats)
    rec = trainwatch.StepRecorder(f"chip-smoke-{name}")
    pinned0 = stream.pinned_buffers_allocated()
    with trainwatch.recording(rec):
        train()
    pinned = stream.pinned_buffers_allocated() - pinned0
    busy, kernel_ms, wall = busy_share(lambda: train())
    log(f"  {name} streamed: stats {stream_stats(stats)}; recorded run: "
        f"h2d_bytes {rec.h2d_bytes}, overlap ratio {rec.overlap_ratio}; "
        f"pinned buffers a run {pinned}; the card busy {busy:.4f} of the "
        f"wall ({kernel_ms:.2f} ms of kernels in {wall:.4f} s); {smi}")
    # one feed a run (no snapshots): its ring, lookahead + 1 slots a leaf
    if stats["n_stream"] < 2 or pinned != (STREAM_LOOKAHEAD + 1) * n_leaves:
        raise AssertionError(f"{name}: the feed's stats or pinned ring")
    return {"stats": stats, "overlap": rec.overlap_ratio,
            "h2d_bytes_recorded": rec.h2d_bytes, "pinned": pinned,
            "busy": busy}


def tt_same(a, b) -> bool:
    return torch.equal(a.user_vectors, b.user_vectors) and \
        torch.equal(a.item_vectors, b.item_vectors)


def stream_twotower(args, smi, tt_model) -> dict:
    """43.1: two-tower at bench.py's shape, streamed."""
    u, i = tt_pairs()
    staged_cfg, on = tt_config(), tt_config(stream="on")
    log(f"  43.1 two-tower at bench.py's shape streamed (stream='on', "
        f"PIO_TPU_TRAIN_STREAM_MB={TT_STREAM_MB}, lookahead "
        f"{STREAM_LOOKAHEAD}) against the staged run")
    with knob("PIO_TPU_TRAIN_STREAM_MB", TT_STREAM_MB):
        pair = streamed_pair(
            "43.1 two-tower", lambda: tt_train(u, i, staged_cfg),
            lambda: tt_train(u, i, on), tt_same, smi)
        if not tt_same(pair["model"], tt_model):
            raise AssertionError("43.1: the staged run is not phase 30's")
        feed = feed_readings(
            "43.1 two-tower", lambda stats=None: tt_train(
                u, i, on, **({} if stats is None else {"stats": stats})),
            2, smi)
    if feed["stats"]["n_stream"] < 8:
        raise AssertionError(f"43.1: n_stream {feed['stats']['n_stream']}")
    if feed["stats"]["h2d_bytes"] != TT_STEPS * TT_BATCH * 8:
        raise AssertionError("43.1: the feed did not ship every step's ids "
                             "once")

    # under a budget of the params + 1 MiB, "auto" streams: the same bits,
    # and the peak above the run's resident state stays within
    # lookahead + 1 spans and a staged step's temporaries
    tree = two_tower.init_params(TT_USERS, TT_ITEMS, staged_cfg,
                                 torch.Generator().manual_seed(0))
    params_nbytes = sum(t.numel() * 4 for t in adam.leaves(tree))
    del tree
    staged_nbytes = 2 * 4 * (-(-TT_PAIRS // TT_BATCH) * TT_BATCH)

    def peak_of(cfg, **kw):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model, wall = tt_train(u, i, cfg, **kw)
        return model, wall, torch.cuda.max_memory_allocated() - base

    _, _, staged_peak = peak_of(staged_cfg)
    budget = params_nbytes + (1 << 20)
    stats = {}
    with knob("PIO_TPU_DEVICE_BUDGET_BYTES", str(budget)):
        auto, auto_wall, auto_peak = peak_of(staged_cfg)
        tt_train(u, i, staged_cfg, stats=stats)
    n_stream = stats["n_stream"]
    n_batches = staged_nbytes // (8 * TT_BATCH)
    span = -(-n_batches // n_stream) * TT_BATCH * 8
    temporaries = staged_peak - staged_nbytes
    log(f"  43.1 PIO_TPU_DEVICE_BUDGET_BYTES = params {params_nbytes} B + "
        f"1 MiB, stream='auto': n_stream {n_stream}, wall {auto_wall:.4f} s; "
        f"peak memory_allocated above the start {auto_peak} B against the "
        f"staged run's {staged_peak} B (its {staged_nbytes} B of ids "
        f"resident, {temporaries} B the rest); {STREAM_LOOKAHEAD + 1} spans "
        f"of {span} B + the rest = {temporaries + (STREAM_LOOKAHEAD + 1) * span}"
        f" B; {smi}")
    if not tt_same(auto, tt_model):
        raise AssertionError("43.1: the run under the budget differs")
    if n_stream < 4 or auto_peak > temporaries + \
            (STREAM_LOOKAHEAD + 1) * span:
        raise AssertionError("43.1: the streamed run under the budget held "
                             "more than lookahead + 1 spans")

    # MovieLens-25M's rating count, synthetic as bench.py makes them
    rng = np.random.default_rng(args.seed)
    u25 = rng.integers(0, ML25M_USERS, ML25M_RATINGS).astype(np.int32)
    i25 = (rng.random(ML25M_RATINGS) ** 2 * ML25M_ITEMS).astype(np.int32)
    epoch = 2 * 4 * ML25M_RATINGS
    out25 = {}
    for name, cfg in (("staged", tt_config(stream="off")), ("streamed", on)):
        torch.cuda.synchronize()
        h0 = stream._H2D_BYTES.value()
        t0 = time.perf_counter()
        m = two_tower.train_two_tower(None, u25, i25, ML25M_USERS,
                                      ML25M_ITEMS, cfg, device=CARD)
        torch.cuda.synchronize()
        out25[name] = (m, time.perf_counter() - t0,
                       int(stream._H2D_BYTES.value() - h0))
        if not torch.isfinite(m.item_vectors).all():
            raise AssertionError(f"43.1 25M {name}: vectors not finite")
    if not tt_same(out25["staged"][0], out25["streamed"][0]):
        raise AssertionError("43.1 25M: the streamed run differs")
    shipped = out25["streamed"][2]
    log(f"  43.1 {ML25M_RATINGS} pairs ({ML25M_USERS} users, {ML25M_ITEMS} "
        f"items, synthetic as bench.py:74): wall staged "
        f"{out25['staged'][1]:.3f} s, streamed {out25['streamed'][1]:.3f} s "
        f"(host clock, one run each, the host's shuffle of the epoch in "
        f"both); streamed h2d_bytes {shipped} against the staged epoch's "
        f"{epoch} B; the same bits; {smi}")
    if shipped != TT_STEPS * TT_BATCH * 8:
        raise AssertionError("43.1 25M: the feed shipped more than the "
                             "steps' ids")
    return {"pair": pair, "feed": feed, "auto_peak": auto_peak,
            "staged_peak": staged_peak, "walls25": {
                k: v[1] for k, v in out25.items()}, "shipped25": shipped}


def stream_seqrec(args, smi, seqs) -> dict:
    """43.2: the sequence model at phase 33's width in minibatches,
    streamed."""
    cfg = seq_config(batch_size=SEQ_STREAM_BATCH)
    on = dataclasses.replace(cfg, stream="on")
    log(f"  43.2 train_seqrec at phase 33's width in minibatches of "
        f"{SEQ_STREAM_BATCH} rows, streamed (PIO_TPU_TRAIN_STREAM_MB="
        f"{SEQ_STREAM_MB}) against staged")

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            adam.leaves(a.params), adam.leaves(b.params)))

    with knob("PIO_TPU_TRAIN_STREAM_MB", SEQ_STREAM_MB):
        pair = streamed_pair("43.2 sequence", lambda: seq_train(seqs, cfg),
                             lambda: seq_train(seqs, on), same, smi)
        feed = feed_readings(
            "43.2 sequence", lambda stats=None: seq_train(
                seqs, on, **({} if stats is None else {"stats": stats})),
            3, smi)
    if feed["stats"]["h2d_bytes"] != SEQ_STEPS * SEQ_STREAM_BATCH * SEQ_T \
            * 12:
        raise AssertionError("43.2: the feed did not ship every step's "
                             "rows once")
    if not all(torch.isfinite(t).all() for t in adam.leaves(
            pair["model"].params)):
        raise AssertionError("43.2: parameters not finite")
    return {"pair": pair, "feed": feed}


def cls_wide_model(args):
    """The classification template's logreg at 256 features: trained on
    the card over N_CLS_USERS synthetic rows (three plans, each with its
    own hot features), the int8 wire."""
    rng = np.random.default_rng(args.seed + 43)
    y = (np.arange(N_CLS_USERS) % 3).astype(np.int32)
    X = rng.integers(0, 3, (N_CLS_USERS, CLS_WIDE)).astype(np.float32)
    for c in range(3):
        X[y == c, c * 8:(c + 1) * 8] += 6
    ctx = ComputeContext.local(args.seed, device=CARD)
    lr = logreg.train_logreg(ctx, X, y, 3, logreg.LogRegConfig(
        iterations=100, learning_rate=0.1, input_dtype="int8"))
    return TCLogRegModel(lr, BiMap({p: k for k, p in enumerate(PLANS)}),
                         CLS_WIDE), X


def cls_variant(name, dim):
    return variant_from_dict({
        "id": f"cls-mesh-{name}", "engineFactory": "templates.classification",
        "datasource": {"params": {
            "app_name": CLS_APP, "attrs": [f"attr{j}" for j in range(dim)]}},
        "algorithms": [{"name": "logreg", "params": {
            "iterations": 100, "learning_rate": 0.1,
            "input_dtype": "int8"}}]})


def served_latency(port: int, bodies: list) -> tuple:
    """(answers, p50 ms, p99 ms) of ``bodies`` in turn on one keep-alive
    connection (host clock)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    answers, ms = [], []
    for body in bodies:
        t = time.perf_counter()
        status, got = request(conn, "POST", "/queries.json", body)
        ms.append((time.perf_counter() - t) * 1e3)
        if status != 200:
            raise AssertionError(f"{body}: HTTP {status} {got}")
        answers.append(got)
    conn.close()
    return answers, float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def cls_mesh_case(args, smi, name, variant, iid, model, X) -> dict:
    """One stored classification instance served over CLS_MESH and
    unsharded: codes of a batch and of HTTP answers against the unsharded
    scorer's, the residency block, the resident ledger, p50/p99, a deploy
    and N_CLS_RELOADS /reload with device memory a generation."""
    dim = model.dim
    rng = np.random.default_rng(args.seed + dim)
    batch = X[rng.choice(len(X), N_CLS_MESH_BATCH, replace=False)]
    # the scorers on their own: the sharded codes against the unsharded
    with knob("PIO_TPU_SERVE_WIRE", "int8"):
        one = residency.ResidentLinearScorer(
            model.lr.weights, model.lr.bias, model.lr.feature_scales,
            device=CARD)
        many = residency.ResidentLinearScorer(
            model.lr.weights, model.lr.bias, model.lr.feature_scales,
            device=CARD, mesh=CLS_MESH)
    want, got = one.score_codes(batch), many.score_codes(batch)
    l1 = one._out_bufs[len(batch)]._buf
    lm = many._out_bufs[len(batch)]._buf
    # the terms' magnitude of each logit: |x_wire| @ |W_eff| + |b|
    x_wire = torch.from_numpy(one.encode(batch)).to(CARD).float()
    scale = x_wire.abs() @ one._w_dev.abs() + one._b_dev.abs()
    err = float(((lm - l1).abs() / scale).max())
    top2 = torch.topk(l1, 2, dim=1).values
    ties = ((top2[:, 0] - top2[:, 1]) <= 2 * CLS_TIE * scale.max(dim=1)
            .values).cpu().numpy()
    differ = int((got != want).sum())
    one.retire()
    many.retire()
    if err > CLS_TIE or (got != want)[~ties].any():
        raise AssertionError(f"43.3 {name}: sharded logits or codes differ "
                             f"({err} relative)")
    bodies = [{"attrs": [float(v) for v in row]} for row in batch[
        :N_CLS_MESH_QUERIES]]
    out = {"logit_rel_err": err, "near_ties": int(ties.sum()),
           "codes_differ": differ}
    for mode, flag in (("unsharded", "0"), ("sharded", "1")):
        with knob("PIO_TPU_MESH_SERVE", flag), \
                knob("PIO_TPU_SERVE_WIRE", "int8"):
            before = allocated()
            server = deploy_query_server(variant, host="127.0.0.1", port=0,
                                         instance_id=iid, device=CARD,
                                         mesh_devices=CLS_MESH)
            with server:
                answers, p50, p99 = served_latency(server.port, bodies)
                conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                                  timeout=60)
                _, stats = request(conn, "GET", "/stats.json")
                _, device = request(conn, "GET", "/device.json")
                gens = [allocated() - before]
                codes = set()
                for _ in range(N_CLS_RELOADS if flag == "1" else 0):
                    codes.add(request(conn, "POST", "/reload", {})[0])
                    codes.add(request(conn, "POST", "/queries.json",
                                      bodies[0])[0])
                    gens.append(allocated() - before)
                conn.close()
        (entry,) = stats["residency"]["scorers"]
        ledger = [r for r in device["placements"]
                  if r["category"] == "resident"]
        labels = [model.label_index.inverse[int(c)] for c in want[
            :N_CLS_MESH_QUERIES]]
        wrong = [k for k, (a, l) in enumerate(zip(answers, labels))
                 if a["label"] != l and not ties[k]]
        log(f"  43.3 {name} (D {dim}) {mode}: {len(bodies)} POST "
            f"/queries.json p50 {p50:.3f} ms, p99 {p99:.3f} ms (host clock); "
            f"residency entry {json.dumps({k: entry[k] for k in ('sharded', 'meshFallback', 'paramBytes', 'dispatches', 'h2dBytes')})}; "
            f"resident ledger {json.dumps([(r['name'], r['bytes'], r['device']) for r in ledger])}; "
            f"memory_allocated over the start after the deploy and each "
            f"/reload {gens} B; {smi}")
        if wrong:
            raise AssertionError(f"43.3 {name} {mode}: answers {wrong[:3]} "
                                 f"differ from the unsharded scorer")
        sharded = flag == "1" and dim % len(CLS_MESH) == 0
        if entry["sharded"] is not sharded or entry["meshFallback"] is not (
                flag == "1" and not sharded) or len(ledger) != (
                len(CLS_MESH) if sharded else 1):
            raise AssertionError(f"43.3 {name} {mode}: residency {entry} "
                                 f"or ledger {ledger}")
        if codes - {200} or any(abs(g - gens[0]) > CLS_RELOAD_SLACK
                                for g in gens):
            raise AssertionError(f"43.3 {name}: a /reload left "
                                 f"{gens} B or answered {codes}")
        out[mode] = {"p50_ms": p50, "p99_ms": p99, "entry": entry,
                     "ledger": len(ledger), "gens": gens}
    log(f"  43.3 {name}: the sharded scorer's codes of {len(batch)} rows "
        f"equal the unsharded scorer's except {differ} (near-ties within "
        f"{CLS_TIE} of the terms' magnitude: {int(ties.sum())}); logits "
        f"within {err:.3g} of |x|·|W| + |b|")
    return out


def cls_mesh(args, smi) -> dict:
    """43.3: the classification template served over (cuda:0,) x 4."""
    log(f"  43.3 the classification template's resident scorer served with "
        f"PIO_TPU_MESH_SERVE=1 over {len(CLS_MESH)} x {CARD}, at phase 26's "
        f"shape (D 3: no divisor of 4, so mesh_fallback) and at D "
        f"{CLS_WIDE} (row-sharded)")
    variant = cls_variant("d3", 3)
    engine, ep = build_engine(variant)
    ctx = ComputeContext.create(args.seed, device=CARD)
    iid = run_train(engine, ep, variant, ctx=ctx)
    (narrow,) = load_models_for_instance(iid, engine, ep, ctx)
    rng = np.random.default_rng(args.seed + 3)
    X3 = rng.integers(0, 9, (N_CLS_MESH_BATCH * 2, 3)).astype(np.float32)
    out = {"d3": cls_mesh_case(args, smi, "d3", variant, iid, narrow, X3)}
    wide, X = cls_wide_model(args)
    variant = cls_variant("wide", CLS_WIDE)
    out["wide"] = cls_mesh_case(args, smi, "wide", variant,
                                store_instance(variant, [wide]), wide, X)
    return out


def fault_drills(args, smi, tt_model, gpu, queries, p50_36) -> dict:
    """43.4: a failed chunk put in the streamed two-tower, and injected
    latency at the solo dispatch of phase 4's model."""
    u, i = tt_pairs()
    on = tt_config(stream="on")
    faults.uninstall()
    with knob("PIO_TPU_TRAIN_STREAM_MB", TT_STREAM_MB):
        faults.install("stream.put=error:once")
        try:
            tt_train(u, i, on)
        except faults.FaultInjected as e:
            raised = str(e)
        else:
            raise AssertionError("43.4: stream.put=error:once did not raise")
        again, _ = tt_train(u, i, on)
    counts = faults.trigger_counts()
    faults.uninstall()
    if not tt_same(again, tt_model) or counts != {("stream.put", "error"): 1}:
        raise AssertionError(f"43.4: the run after the fault differs, or "
                             f"the counts {counts}")
    log(f"  43.4 stream.put=error:once: the streamed two-tower raised "
        f"FaultInjected ({raised}); the next run is clean and gives "
        f"phase 30's bits")

    engine = get_engine_factory("templates.textclassification")()
    ep = EngineParams(algorithm_params_list=(("mlp", MLPParams()),))
    texts = queries[:N_FAULT_QUERIES]  # phase 36's bodies
    bodies = [{"text": t} for t in texts]
    spec = f"scorer.dispatch.solo=latency:{FAULT_LATENCY_MS}ms"
    runs = {}
    reset_counts()
    for name, armed in (("clean", None), ("armed", spec)):
        faults.uninstall()
        if armed:
            faults.install(armed)
        server = create_query_server(engine, ep, [gpu], host="127.0.0.1",
                                     port=0, device=CARD)
        with server:
            answers, p50, p99 = served_latency(server.port, bodies)
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=60)
            _, snap = request(conn, "GET", "/faults.json")
            conn.request("GET", "/metrics")
            metrics = conn.getresponse().read().decode()
            conn.close()
        runs[name] = {"p50_ms": p50, "p99_ms": p99, "snapshot": snap,
                      "answers": answers}
        log(f"  43.4 {name} ({armed or 'no spec'}): {len(bodies)} solo "
            f"queries of phase 4's model, p50 {p50:.3f} ms, p99 {p99:.3f} ms "
            f"(host clock); /faults.json triggered "
            f"{json.dumps(snap['triggered'])}; /metrics "
            f"{[l for l in metrics.splitlines() if l.startswith('pio_tpu_fault_triggered_total')]}; {smi}")
    launches = read_counts()
    faults.uninstall()
    lift = runs["armed"]["p50_ms"] - runs["clean"]["p50_ms"]
    want_line = ('pio_tpu_fault_triggered_total{point="scorer.dispatch.solo",'
                 f'action="latency"}} {len(bodies)}')
    if lift < FAULT_LATENCY_MS or runs["armed"]["snapshot"]["triggered"] != [
            {"point": "scorer.dispatch.solo", "action": "latency",
             "count": len(bodies)}] or want_line not in metrics.splitlines() \
            or runs["armed"]["answers"] != runs["clean"]["answers"]:
        raise AssertionError(f"43.4: the latency drill: lift {lift} ms, "
                             f"{runs['armed']['snapshot']}")
    log(f"  43.4 the armed p50 {lift:.3f} ms above the clean one (>= "
        f"{FAULT_LATENCY_MS}); the clean p50 {runs['clean']['p50_ms']:.3f} "
        f"ms beside phase 36's 1-client p50 with the batcher off "
        f"{p50_36:.3f} ms (its bodies cycle the same 64 texts); serving "
        f"launches {json.dumps(launches)}")
    return {"runs": runs, "launches": launches, "lift": lift}


def phase_stream_mesh_faults(args, smi, tt_model, gpu, queries,
                             p50_36) -> dict:
    """Phase 43: the streamed epoch feed, the resident scorer's mesh and
    the failpoints, on the card."""
    t_phase = time.monotonic()
    log(f"phase 43: the streamed epoch feed (two-tower and the sequence "
        f"model), the resident scorer over a mesh, and fault drills; {smi}")
    t0 = time.monotonic()
    tt = stream_twotower(args, smi, tt_model)
    t1 = time.monotonic()
    seq = stream_seqrec(args, smi, seq_histories())
    t2 = time.monotonic()
    cls = cls_mesh(args, smi)
    t3 = time.monotonic()
    drills = fault_drills(args, smi, tt_model, gpu, queries, p50_36)
    t4 = time.monotonic()
    log(f"  phase 43 {t4 - t_phase:.1f} s: 43.1 {t1 - t0:.1f}, 43.2 "
        f"{t2 - t1:.1f}, 43.3 {t3 - t2:.1f}, 43.4 {t4 - t3:.1f}; {smi}")
    return {"tt": tt, "seq": seq, "cls": cls, "drills": drills,
            "launches": drills["launches"]}


# ------------------------------------------------- phase 44: the event stores
#: MovieLens-1M's shape (ratings, users, movies), synthetic as bench.py's
ML1M_EDGES, ML1M_USERS, ML1M_ITEMS = 1_000_209, 6_040, 3_706
#: 44.2-44.3's ratings: a quarter of MovieLens-1M's over its users and
#: movies (all 1,000,209 at first, then half; cut for the script's time,
#: the stores' and the trainers' checks unchanged)
P44_RATINGS = ML1M_EDGES // 4
#: 44.1: phase 28's rate events through the event server: these many in
#: batches of QS_BATCH, then these many single posts (were 20,000 and
#: 1,000, then 10,000 and 500; cut for the script's time)
P44_BATCHED, P44_SINGLES = 5_000, 250
#: acknowledged events read back one by one with ``get`` (the event log's
#: ``get`` scans the whole log)
P44_SAMPLE = 50
#: 44.2: queries a deployment answers
P44_QUERIES = 64
#: 44.3: one event in this many is deleted before ``compact``
P44_DELETE_EVERY = 100
P44_APP = "movielens-1m-synthetic"
#: 44.2's stores, the memory store (the baseline) first, each with the
#: model store its run persists to: localfs, blob on a file:// root, blob
#: through the blob daemon
P44_STORES = (("memory", "localfs"), ("eventlog", "blob-file"),
              ("parquet", "blob-http"), ("searchable", "localfs"),
              ("partlog", "localfs"))
#: 44.2's partitioned log: its partitions, replicated to one follower on
#: loopback (acks required at ``commit`` durability: 1)
P44_PARTITIONS, P44_MIN_ACKS = 4, 1
#: 44.4: users given a ``$set`` on the promoted log before ``compact``
P44_SET_USERS = 1_000


@contextlib.contextmanager
def store_config(repos: dict):
    """The script's storage inside the block: each repository on a source
    of its own, ``repo → (type, path)``; the registry's caches dropped on
    the way in and out."""
    with contextlib.ExitStack() as stack:
        for repo, (type_, path) in repos.items():
            src = f"P44{repo}"
            stack.enter_context(
                knob(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", src))
            stack.enter_context(knob(f"PIO_STORAGE_SOURCES_{src}_TYPE", type_))
            stack.enter_context(knob(f"PIO_STORAGE_SOURCES_{src}_PATH", path))
        Storage.reset()
        try:
            yield
        finally:
            Storage.reset()


def ingest_http(port: int, key: str, batched: list, singles: list) -> tuple:
    """``batched`` in ``/batch/events.json`` requests of QS_BATCH, then
    ``singles`` one ``POST /events.json`` each, on one keep-alive
    connection: (stats, every acknowledged event id in body order)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    batch_ms, single_ms, ids = [], [], []
    t0 = time.perf_counter()
    for b in range(0, len(batched), QS_BATCH):
        t = time.perf_counter()
        status, got = request(conn, "POST", f"/batch/events.json?accessKey={key}",
                              batched[b:b + QS_BATCH])
        batch_ms.append((time.perf_counter() - t) * 1e3)
        if status != 200 or any(r["status"] != 201 for r in got):
            raise AssertionError(f"batch: HTTP {status} {got[:3]}")
        ids += [r["eventId"] for r in got]
    for body in singles:
        t = time.perf_counter()
        status, got = request(conn, "POST", f"/events.json?accessKey={key}",
                              body)
        single_ms.append((time.perf_counter() - t) * 1e3)
        if status != 201:
            raise AssertionError(f"single event: HTTP {status} {got}")
        ids.append(got["eventId"])
    wall = time.perf_counter() - t0
    conn.close()
    n = len(batched) + len(singles)
    return {"events": n, "wall_s": wall, "events_per_s": n / wall,
            "batch_ms_p50": float(np.percentile(batch_ms, 50)),
            "batch_ms_p99": float(np.percentile(batch_ms, 99)),
            "single_ms_p50": float(np.percentile(single_ms, 50)),
            "single_ms_p99": float(np.percentile(single_ms, 99))}, ids


def ingest_store(args, smi, type_: str, bodies: list) -> dict:
    """44.1 on one store: the event server in this process over SQLite
    metadata and ``type_`` events, the bodies ingested, then every
    acknowledged event read back: the store's count and ``find_frame``,
    and ``get`` of a sample against its body."""
    home = fresh_home(f"p44_ingest_{type_}")
    db = os.path.join(home, "pio.db")
    events = db if type_ == "sqlite" else os.path.join(home, "eventlog")
    with store_config({"METADATA": ("sqlite", db),
                       "EVENTDATA": (type_, events)}):
        app_id = Storage.get_meta_data_apps().insert(App(0, "p44-ingest"))
        key = Storage.get_meta_data_access_keys().insert(AccessKey("", app_id))
        server = create_event_server(host="127.0.0.1", port=0)
        server.start()
        try:
            stats, ids = ingest_http(server.port, key, bodies[:P44_BATCHED],
                                     bodies[P44_BATCHED:])
        finally:
            server.stop()
        le = Storage.get_levents()
        t = time.perf_counter()
        frame = Storage.get_pevents().find_frame(app_id)
        read_s = time.perf_counter() - t
        count = le.count(app_id) if hasattr(le, "count") else len(frame)
        if not (len(set(ids)) == len(ids) == len(bodies) == count == len(frame)):
            raise AssertionError(
                f"{type_}: {len(bodies)} sent, {len(set(ids))} acknowledged, "
                f"count {count}, find_frame {len(frame)}")
        rng = np.random.default_rng(args.seed + 44)
        t = time.perf_counter()
        for k in rng.choice(len(ids), P44_SAMPLE, replace=False):
            e, body = le.get(ids[k], app_id), bodies[k]
            if e is None or (e.entity_id, e.target_entity_id,
                             e.properties.get("rating")) != (
                    body["entityId"], body["targetEntityId"],
                    body["properties"]["rating"]):
                raise AssertionError(f"{type_}: event {ids[k]} read back "
                                     f"as {e}, sent {body}")
        get_ms = (time.perf_counter() - t) * 1e3 / P44_SAMPLE
    log(f"  44.1 {type_}: {stats['events']} events ({P44_BATCHED} in "
        f"batches of {QS_BATCH}, {P44_SINGLES} single) in "
        f"{stats['wall_s']:.3f} s, {stats['events_per_s']:.1f} events/s; "
        f"batch ms p50 {stats['batch_ms_p50']:.3f} p99 "
        f"{stats['batch_ms_p99']:.3f}; single ms p50 "
        f"{stats['single_ms_p50']:.3f} p99 {stats['single_ms_p99']:.3f}; "
        f"every acknowledged event read back (count {count}, find_frame "
        f"{len(frame)} in {read_s:.3f} s, get of {P44_SAMPLE} at "
        f"{get_ms:.3f} ms each); host clock, "
        f"os.cpu_count() {os.cpu_count()}; {smi}")
    return stats


def ml1m_events(seed: int) -> list:
    """MovieLens-1M's shape as ``rate`` events (bench.py's generator), ids
    and creation times fixed, one second apart. The events of a rating
    share one properties map (a DataMap is immutable)."""
    u, i, r = synth_ratings(P44_RATINGS, ML1M_USERS, ML1M_ITEMS, seed, "half")
    t0 = dt.datetime(2026, 4, 1, tzinfo=dt.timezone.utc)
    props = {c: DataMap({"rating": c}) for c in set(r.tolist())}
    return [Event("rate", "user", f"u{a}", "item", f"i{b}",
                  properties=props[c],
                  event_time=t0 + dt.timedelta(seconds=k),
                  event_id=f"r{k:07d}", creation_time=t0)
            for k, (a, b, c) in enumerate(zip(u.tolist(), i.tolist(),
                                              r.tolist()))]


def p44_queries(users: list, items: list) -> list:
    rng = np.random.default_rng(64)
    out = []
    for k in range(P44_QUERIES):
        body = {"user": users[int(rng.integers(len(users)))], "num": 10}
        if k % 4 == 1:
            body["blackList"] = [items[int(j)] for j in
                                 rng.integers(len(items), size=5)]
        if k == 0:
            body["user"] = "stranger"
        out.append(body)
    return out


@contextlib.contextmanager
def timed_frames(pe):
    """Each ``find_frame`` of ``pe``'s class inside the block timed: yields
    the list of (wall s, events) it appends to."""
    cls, reads = type(pe), []
    real = cls.find_frame

    def timed(self, *a, **kw):
        t = time.perf_counter()
        frame = real(self, *a, **kw)
        reads.append((time.perf_counter() - t, len(frame)))
        return frame

    cls.find_frame = timed
    try:
        yield reads
    finally:
        cls.find_frame = real


def store_train(args, smi, type_: str, models_type: str, home: str,
                events: list, blob_url: str) -> dict:
    """44.2 on one store: ``write`` the events, ``run_train`` on the card
    from the store (its data source's ``find_frame`` timed), deploy the
    persisted instance and answer P44_QUERIES queries."""
    path = {"memory": home, "eventlog": os.path.join(home, "eventlog"),
            "parquet": os.path.join(home, "parquet"),
            "searchable": os.path.join(home, "search.db"),
            "partlog": os.path.join(home, "partlog")}[type_]
    models = {"localfs": ("localfs", os.path.join(home, f"models-{type_}")),
              "blob-file": ("blob", "file://" + os.path.join(home, "blobs")),
              "blob-http": ("blob", blob_url)}[models_type]
    with store_config({"METADATA": ("memory", home),
                       "EVENTDATA": (type_, path), "MODELDATA": models}):
        app_id = Storage.get_meta_data_apps().insert(App(0, P44_APP))
        pe = Storage.get_pevents()
        t = time.perf_counter()
        pe.write(events, app_id)
        write_s = time.perf_counter() - t
        variant, engine, ep, iid, inst, model, factors, frame_s, train_s = \
            train_from_store(args, type_, pe)
        bodies = p44_queries(sorted(model.user_index.keys()),
                             sorted(model.item_index.keys()))
        server = deploy_query_server(variant, host="127.0.0.1", port=0,
                                     instance_id=iid, device=CARD)
        with server:
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=60)
            answers = []
            for body in bodies:
                status, got = post(conn, json.dumps(body).encode())
                if status != 200:
                    raise AssertionError(f"{type_}: {body}: HTTP {status}")
                answers.append(got)
            conn.close()
    log(f"  44.2 {type_}: write {write_s:.3f} s, find_frame {frame_s:.3f} s "
        f"({P44_RATINGS} events, the run's own read), run_train "
        f"{train_s:.3f} s on the card "
        f"(phases {json.dumps({k: v for k, v in inst.env.items() if k.startswith('phase_')})}), "
        f"persisted to {models[0]} {models[1].split('?')[0]}, "
        f"deployed, {P44_QUERIES} queries answered; host clock, "
        f"os.cpu_count() {os.cpu_count()}; {smi}")
    return {"store": pe, "app_id": app_id, "factors": factors,
            "answers": answers, "path": path, "write_s": write_s}


def train_from_store(args, type_: str, pe):
    """``run_train`` of the recommendation template on the card from the
    configured event store (its data source's one ``find_frame`` timed),
    and the persisted model loaded back."""
    variant = variant_from_dict({
        "id": "p44-stores", "engineFactory": "templates.recommendation",
        "datasource": {"params": {"app_name": P44_APP}},
        "algorithms": [{"name": "als",
                        "params": {**ALS_PARAMS, "seed": args.seed}}],
    })
    engine, ep = build_engine(variant)
    ctx = ComputeContext.create(args.seed, device=CARD)
    t = time.perf_counter()
    with timed_frames(pe) as reads:
        iid = run_train(engine, ep, variant, ctx=ctx)
    train_s = time.perf_counter() - t
    if [n for _, n in reads] != [P44_RATINGS]:
        raise AssertionError(f"{type_}: the run's find_frame read {reads}")
    inst = Storage.get_meta_data_engine_instances().get(iid)
    if inst.env["device"] != str(CARD):
        raise AssertionError(f"{type_}: run_train did not run on the card")
    model = load_models_for_instance(iid, engine, ep, ctx)[0]
    factors = (model.factors.user_factors.cpu(),
               model.factors.item_factors.cpu())
    return (variant, engine, ep, iid, inst, model, factors, reads[0][0],
            train_s)


@contextlib.contextmanager
def partlog_leader_env(follower):
    """44.2's partitioned log inside the block: P44_PARTITIONS partitions
    replicated to ``follower`` with P44_MIN_ACKS acks at ``commit``."""
    with knob("PIO_TPU_PARTLOG_PARTITIONS", str(P44_PARTITIONS)), \
            knob("PIO_TPU_PARTLOG_REPLICAS", f"127.0.0.1:{follower.port}"), \
            knob("PIO_TPU_REPL_MIN_ACKS", str(P44_MIN_ACKS)):
        yield


def partlog_failover(args, smi, runs: dict, home: str, follower) -> dict:
    """44.4: the follower drains the leader's stream (its sidecar's
    ``/storage.json`` positions equal the leader's committed bytes); the
    leader stops; the follower's mirror is promoted into a fresh root,
    reopened and trained from on the card (the memory store's bits); the
    promoted log takes ``$set`` writes and ``compact``, and its reads
    agree before and after and with the memory store's."""
    run, base = runs["partlog"], runs["memory"]
    leader = run["store"]._b
    committed = {k: leader.committed(k) for k in range(leader.partitions)}
    t = time.perf_counter()
    deadline = t + 120
    while follower.positions(leader.partitions) != committed:
        if time.perf_counter() > deadline:
            raise AssertionError(
                f"follower at {follower.positions(leader.partitions)}, "
                f"leader committed {committed}")
        time.sleep(0.01)
    drain_s = time.perf_counter() - t
    topo = leader.topology()
    sidecar = create_follower_status_server(follower).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", sidecar.port,
                                          timeout=60)
        status, side = request(conn, "GET", "/storage.json")
        conn.close()
    finally:
        sidecar.stop()
    want = {str(k): v for k, v in committed.items()}
    if status != 200 or side["role"] != "follower" or \
            side["positions"] != want:
        raise AssertionError(f"follower sidecar: HTTP {status} {side}, "
                             f"leader committed {want}")
    acked = topo["replication"]["min_acked"]
    if acked != want:
        raise AssertionError(f"leader's min_acked {acked}, committed {want}")
    leader.close()  # the leader stops
    dest = os.path.join(home, "partlog-promoted")
    t = time.perf_counter()
    election = failover.promote([follower.root], dest)["election"]
    promote_s = time.perf_counter() - t
    if {k: e["position"] for k, e in election.items()} != committed:
        raise AssertionError(f"promoted positions {election}, leader "
                             f"committed {committed}")
    with store_config({"METADATA": ("memory", home),
                       "EVENTDATA": ("partlog", dest),
                       "MODELDATA": ("localfs",
                                     os.path.join(home, "models-promoted"))}):
        app_id = Storage.get_meta_data_apps().insert(App(0, P44_APP))
        if app_id != run["app_id"]:
            raise AssertionError(f"app {app_id}, the leader's {run['app_id']}")
        t = time.perf_counter()
        pe = Storage.get_pevents()
        reopen_s = time.perf_counter() - t
        *_, factors, frame_s, train_s = train_from_store(args, "partlog", pe)
        if not all(torch.equal(a, b) for a, b in zip(factors,
                                                     base["factors"])):
            raise AssertionError("promoted partlog: factors differ from the "
                                 "memory store's run")
        log_ = pe._b
        t0 = dt.datetime(2026, 5, 1, tzinfo=dt.timezone.utc)
        sets = [Event("$set", "user", f"u{u}",
                      properties=DataMap({"segment": u % 7, "tier": "a"}),
                      event_time=t0 + dt.timedelta(seconds=u),
                      event_id=f"s{u:05d}", creation_time=t0)
                for u in range(P44_SET_USERS)]
        pe.write(sets, app_id)
        folded = log_.aggregate_properties(app_id, "user")
        t = time.perf_counter()
        compacted = log_.compact()
        compact_s = time.perf_counter() - t
        snap = log_.aggregate_properties(app_id, "user")
        rates = pe.find_frame(app_id, event_names=["rate"])
    mem = base["frame"]
    if sum(compacted.values()) != P44_SET_USERS or len(folded) != \
            P44_SET_USERS or {k: (v.to_dict(), v.first_updated,
                                 v.last_updated) for k, v in snap.items()} \
            != {k: (v.to_dict(), v.first_updated, v.last_updated)
                for k, v in folded.items()}:
        raise AssertionError(f"compact folded {compacted}: the snapshot "
                             f"reads differ from the full fold")
    for c in ("event", "entity_id", "target_entity_id", "event_time_us"):
        if not np.array_equal(getattr(rates, c), getattr(mem, c)):
            raise AssertionError(f"compacted partlog's {c} differs from "
                                 f"the memory store's")
    events_per_s = P44_RATINGS / run["write_s"]
    log(f"  44.4 partlog ({P44_PARTITIONS} partitions, 1 follower, "
        f"min_acks {P44_MIN_ACKS}, durability {durability.mode()}): "
        f"write {events_per_s:.1f} events/s; replication drained "
        f"{drain_s:.3f} s after the write ({sum(committed.values())} B); "
        f"the follower sidecar's /storage.json positions are the leader's "
        f"committed bytes; failover {promote_s + reopen_s:.3f} s (promote "
        f"{promote_s:.3f}, reopen and replay {reopen_s:.3f}); run_train "
        f"from the promoted log {train_s:.3f} s (find_frame {frame_s:.3f}) "
        f"gives the memory store's factors bit for bit; compact "
        f"{compact_s:.3f} s folded {P44_SET_USERS} users' $set, the "
        f"snapshot reads as the full fold, the ratings as the memory "
        f"store's; host clock, os.cpu_count() {os.cpu_count()}; {smi}")
    return {"events_per_s": events_per_s, "drain_s": drain_s,
            "failover_s": promote_s + reopen_s}


def store_maintenance(args, smi, runs: dict, home: str, events: list) -> None:
    """44.3: 1% of the event log's events deleted and the log compacted,
    against the memory store after the same deletes; the search route on
    the searchable store and its 501 on the event log."""
    gone = [f"r{k:07d}" for k in range(0, P44_RATINGS, P44_DELETE_EVERY)]
    log_run, mem = runs["eventlog"], runs["memory"]
    log_file = os.path.join(log_run["path"], f"app_{log_run['app_id']}.pel")
    with store_config({"METADATA": ("memory", home),
                       "EVENTDATA": ("eventlog", log_run["path"])}):
        le, pe = Storage.get_levents(), Storage.get_pevents()
        pe.delete(gone, log_run["app_id"])
        size = os.path.getsize(log_file)
        t = time.perf_counter()
        reclaimed = le.compact(log_run["app_id"])
        compact_s = time.perf_counter() - t
        count = le.count(log_run["app_id"])
        got = pe.find_frame(log_run["app_id"])
    # the search below runs on the searchable store, which keeps every
    # event: the pair of the first event, and how many events it has
    user, item = events[0].entity_id, events[0].target_entity_id
    pairs = sum(1 for e in events
                if e.entity_id == user and e.target_entity_id == item)
    mem["store"].delete(gone, mem["app_id"])
    want = mem["store"].find_frame(mem["app_id"])
    if not count == len(got) == len(want) == P44_RATINGS - len(gone):
        raise AssertionError(f"after {len(gone)} deletes: count {count}, "
                             f"find_frame {len(got)}, memory {len(want)}")
    for c in ("event", "entity_type", "entity_id", "target_entity_type",
              "target_entity_id", "event_time_us"):
        if not np.array_equal(getattr(got, c), getattr(want, c)):
            raise AssertionError(f"compacted log's {c} differs from memory")
    if list(got.properties) != list(want.properties):
        raise AssertionError("compacted log's properties differ from memory")
    if reclaimed <= 0 or os.path.getsize(log_file) != size - reclaimed:
        raise AssertionError(f"compact reclaimed {reclaimed} of {size} B")
    log(f"  44.3 eventlog: {len(gone)} deleted (tombstones), compact "
        f"{compact_s:.3f} s reclaimed {reclaimed} of {size} B; count and "
        f"find_frame equal the memory store's after the same deletes")
    # the search route: searchable answers, the event log 501
    codes = {}
    for type_, path in (("searchable", runs["searchable"]["path"]),
                        ("eventlog", log_run["path"])):
        with store_config({"METADATA": ("memory", home),
                           "EVENTDATA": (type_, path)}):
            app_id = Storage.get_meta_data_apps().insert(App(0, P44_APP))
            key = Storage.get_meta_data_access_keys().insert(
                AccessKey("", app_id))
            server = create_event_server(host="127.0.0.1", port=0)
            server.start()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                                  timeout=60)
                path_ = f"/events/search.json?accessKey={key}"
                t = time.perf_counter()
                status, hits = request(
                    conn, "GET", f"{path_}&q={user}%20AND%20{item}&limit=-1")
                search_ms = (time.perf_counter() - t) * 1e3
                codes[type_] = (status, request(conn, "GET", path_)[0])
                conn.close()
            finally:
                server.stop()
        if type_ == "searchable":
            if status != 200 or len(hits) != pairs or any(
                    (h["entityId"], h["targetEntityId"]) != (user, item)
                    for h in hits):
                raise AssertionError(f"search: HTTP {status}, {len(hits)} "
                                     f"hits of {pairs}: {hits[:3]}")
            found = len(hits)
    if codes != {"searchable": (200, 400), "eventlog": (501, 400)}:
        raise AssertionError(f"search route codes {codes}")
    log(f"  44.3 GET /events/search.json: searchable 200 ({found} events of "
        f"{user} on {item} in {search_ms:.1f} ms), 400 without q; eventlog "
        f"501, 400 without q; {smi}")


def phase_event_stores(args, smi) -> dict:
    """Phase 44: the event and model stores feeding training on the card."""
    t_phase = time.monotonic()
    log(f"phase 44: the event stores: {P44_BATCHED + P44_SINGLES} of phase "
        f"28's events over HTTP into SQLite and the event log; a quarter of "
        f"MovieLens-1M's ratings ({P44_RATINGS} over {ML1M_USERS} users and "
        f"{ML1M_ITEMS} items) written into the memory store, the "
        f"event log, parquet, searchable and the partitioned log (replicated "
        f"to one follower), run_train on the card from each, "
        f"persisted through localfs, blob (file://) and the blob daemon, "
        f"deployed; 1% deleted and the log compacted; the search route; the "
        f"partitioned log failed over to its follower and trained from; "
        f"durability {durability.mode()}; {smi}")
    bodies = rate_bodies(args.seed)[:P44_BATCHED + P44_SINGLES]
    ingest = {t: ingest_store(args, smi, t, bodies) for t in ("sqlite", "eventlog")}
    t1 = time.monotonic()
    home = fresh_home("p44_stores")
    t = time.perf_counter()
    events = ml1m_events(args.seed + 44)
    log(f"  44.2 {len(events)} events built in {time.perf_counter() - t:.3f} s")
    blob = create_blob_server(os.path.join(home, "blobd"), host="127.0.0.1",
                              port=0)
    blob.start()
    follower = replication.FollowerServer(os.path.join(home, "follower"))
    runs = {}
    try:
        return p44_stores_and_failover(args, smi, t_phase, t1, home, events,
                                       blob, follower, runs, ingest)
    finally:
        if "partlog" in runs:
            runs["partlog"]["store"]._b.close()
        follower.stop()


def p44_stores_and_failover(args, smi, t_phase, t1, home, events, blob,
                            follower, runs, ingest) -> dict:
    """44.2-44.4 with the blob daemon and the partitioned log's follower
    up: the stores, their maintenance, the partitioned log's failover."""
    try:
        for type_, models in P44_STORES:
            with (partlog_leader_env(follower) if type_ == "partlog"
                  else contextlib.nullcontext()):
                runs[type_] = store_train(
                    args, smi, type_, models, home, events,
                    f"http://127.0.0.1:{blob.port}")
    finally:
        blob.stop()
    base = runs["memory"]
    # 44.4 compares with the memory store's events before 44.3's deletes
    base["frame"] = base["store"].find_frame(base["app_id"])
    for type_, run in runs.items():
        if not all(torch.equal(a, b) for a, b in zip(run["factors"],
                                                     base["factors"])):
            raise AssertionError(f"{type_}: factors differ from the memory "
                                 f"store's run")
        if run["answers"] != base["answers"]:
            raise AssertionError(f"{type_}: answers differ from localfs's")
    log(f"  44.2 the factors from eventlog, parquet, searchable and partlog "
        f"are the memory store's bit for bit; the blob (file://) and blob "
        f"daemon deployments answer the {P44_QUERIES} queries as localfs's")
    t2 = time.monotonic()
    store_maintenance(args, smi, runs, home, events)
    t3 = time.monotonic()
    partlog = partlog_failover(args, smi, runs, home, follower)
    t4 = time.monotonic()
    log(f"  phase 44 {t4 - t_phase:.1f} s: 44.1 {t1 - t_phase:.1f}, 44.2 "
        f"{t2 - t1:.1f}, 44.3 {t3 - t2:.1f}, 44.4 {t4 - t3:.1f}; {smi}")
    return {"ingest": ingest, "partlog": partlog}


# ------------------------------------------- phase 45: the request plane
#: 45.1: queries on one connection, and the ones timed by CUDA events
P45_QUERIES, P45_TIMED = 1024, 32
#: 45.1: GPU cycles spun ahead of a timed launch's start event (about
#: 0.3 ms at the H100's clock, longer than the host's launch path)
P45_SPIN_CYCLES = 500_000
#: 45.1's SLOs and a QoS spec that admits its traffic
P45_SLOS = ["p99=50ms:99.9", "availability=99.9"]
P45_ADMIT_ALL = "inflight=64,queue=64"
#: 45.2: the overload's admission (and a rate, for 429s beside the 503s)
P45_OVERLOAD = "inflight=2,queue=4,rps=300,burst=50"
#: 45.3: the breaker's window, cooldown and probes, the cache's size
P45_BREAKER = ("inflight=8,queue=8,cache=256,fail_window=4,fail_rate=0.5,"
               "cooldown=2s,probes=2")
P45_COOLDOWN_S = 2.0
P45_CACHED = 16
#: 45.4: queries served with a feedback app
P45_FEEDBACK = 64
P45_FEEDBACK_APP = "smoke45-feedback"
#: 45.5: phase 28's events in batches of QS_BATCH, and single posts from
#: these many clients
P45_EVENTS, P45_SINGLE_CLIENTS, P45_SINGLES = 5_000, 4, 50
P45_INGEST_QOS = ("inflight=32,queue=256,key_rps=1000000,fail_window=4,"
                  "fail_rate=0.5,cooldown=30s,probes=1")
#: top-level query stages, in order (the port's QUERY_STAGES)
P45_STAGES = ["accept", "admit", "parse", "queue", "execute", "serialize",
              "write"]


def call(conn, method: str, path: str, body=None, headers=None) -> tuple:
    """(status, lowercased headers, decoded body) of one request."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    conn.request(method, path, data,
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    try:
        out = json.loads(raw)
    except ValueError:
        out = raw.decode()
    return resp.status, {k.lower(): v for k, v in resp.getheaders()}, out


def top_stages(trace: dict) -> list:
    return [x["stage"] for x in trace["spans"] if "." not in x["stage"]]


def p45_traced(smi, engine, ep, gpu, texts, want, http_answers,
               p50_36) -> dict:
    """45.1: traced serving of phase 4's model under SLOs and QoS."""
    server = create_query_server(engine, ep, [gpu], host="127.0.0.1",
                                 port=0, device=CARD, slos=P45_SLOS,
                                 qos=P45_ADMIT_ALL)
    with server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        records, counted = [], []

        def serve_all():
            # a window that lost an end runs this again: start afresh
            records.clear()
            c0 = read_counts()["embedding_bag"]
            for i, t in enumerate(texts):
                t0 = time.perf_counter()
                status, headers, got = call(
                    conn, "POST", "/queries.json", {"text": t},
                    {"X-Pio-Trace": f"smoke45-{i}/caller"})
                records.append((status, headers.get("x-pio-trace"), got,
                                (time.perf_counter() - t0) * 1e3))
            counted[:] = [read_counts()["embedding_bag"] - c0]

        _, prof = guarded(serve_all, retry=True)
        counted = counted[0]
        profiled_launches = launches_of(
            {e.key: e.count for e in _kernels(prof)}, "embedding_bag_kernel")
        # 32 more, each forward kernel timed by CUDA events around its
        # launch on the current stream. A spin of P45_SPIN_CYCLES ahead of
        # the start event holds the stream until the host has enqueued the
        # kernel, so the events bracket the kernel's device time and not
        # the host's launch latency (which an idle stream would show)
        launch, timed = embedding._launch, []

        def timed_launch(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(P45_SPIN_CYCLES)
            start.record()
            out = launch(*a, **kw)
            end.record()
            timed.append((start, end))
            return out

        embedding._launch = timed_launch
        try:
            for i in range(P45_TIMED):
                status, headers, _ = call(
                    conn, "POST", "/queries.json", {"text": texts[i]},
                    {"X-Pio-Trace": f"smoke45-timed-{i}"})
                if status != 200:
                    raise AssertionError(f"45.1 timed query {i}: {status}")
        finally:
            embedding._launch = launch
        torch.cuda.synchronize()
        kernel_ms = [a.elapsed_time(b) for a, b in timed]
        device_spans = []
        for i in range(P45_TIMED):
            _, _, tr = call(conn, "GET", f"/traces.json?id=smoke45-timed-{i}")
            spans = {x["stage"]: x for x in tr["traces"][0]["spans"]}
            device_spans.append((spans["execute.device"], spans["execute"]))
        _, _, ring = call(conn, "GET", "/traces.json?n=128&order=recent")
        _, _, hot = call(conn, "GET", "/debug/hotpath.json")
        _, _, slo = call(conn, "GET", "/slo.json")
        sample = [P45_QUERIES - 1 - 7 * k for k in range(8)]
        logs = {i: call(conn, "GET",
                        f"/logs.json?trace_id=smoke45-{i}")[2]["logs"]
                for i in sample}
        conn.close()
    # the checks, after the timed requests
    if counted != P45_QUERIES or profiled_launches != P45_QUERIES:
        raise AssertionError(f"45.1: {P45_QUERIES} queries, the wrapper "
                             f"counted {counted} forward launches, the "
                             f"profiler {profiled_launches}")
    for i, (status, echoed, got, _) in enumerate(records):
        if status != 200 or echoed != f"smoke45-{i}" or got != want[i]:
            raise AssertionError(f"45.1 query {i}: {status}, echoed "
                                 f"{echoed}, {got} against {want[i]}")
    if [r[2] for r in records[:len(http_answers)]] != http_answers:
        raise AssertionError("45.1: answers differ from phase 5's")
    for t in ring["traces"]:
        if top_stages(t) != P45_STAGES:
            raise AssertionError(f"45.1 trace {t['id']}: {top_stages(t)}")
    frac = hot["attributedFraction"]
    if abs(frac - 1.0) > 0.01:
        raise AssertionError(f"45.1: attributedFraction {frac}")
    for k, ((dev, ex), ms) in enumerate(zip(device_spans, kernel_ms)):
        inside = (dev["startMs"] >= ex["startMs"] - 0.001
                  and dev["startMs"] + dev["durMs"]
                  <= ex["startMs"] + ex["durMs"] + 0.002)
        if dev["durMs"] < ms or not inside:
            raise AssertionError(f"45.1 timed {k}: execute.device {dev}, "
                                 f"execute {ex}, kernel {ms:.6f} ms")
    for i, entries in logs.items():
        if not any(e["msg"].startswith("served query") for e in entries):
            raise AssertionError(f"45.1: /logs.json has no served-query "
                                 f"record under smoke45-{i}: {entries}")
    ms = np.array([r[3] for r in records])
    stage_p50 = {x["stage"]: x["p50Ms"] for x in hot["stages"]
                 + hot["substages"]}
    log(f"  45.1 {P45_QUERIES} traced queries on one connection: every "
        f"answer 200, its id echoed, bit for bit the solo path's (phase 5's "
        f"{len(http_answers)} among them); forward launches {counted} "
        f"(wrapper) = {profiled_launches} (profiler); the ring's "
        f"{len(ring['traces'])} traces staged {P45_STAGES}; "
        f"attributedFraction {frac}; SLOs "
        f"{[(x['name'], x['errorBudgetRemaining']) for x in slo['slos']]}; "
        f"the served-query record under {len(logs)} sampled ids")
    log(f"  45.1 host clock: p50 {np.percentile(ms, 50):.3f} ms, p99 "
        f"{np.percentile(ms, 99):.3f} ms; stage p50s (ms, bucket-"
        f"interpolated) {json.dumps(stage_p50)}; phase 36's 1-client p50 "
        f"with the batcher off {p50_36:.3f} ms; {smi}")
    log(f"  45.1 {P45_TIMED} timed: forward kernel (CUDA events) "
        f"{min(kernel_ms):.6f}-{max(kernel_ms):.6f} ms, execute.device "
        f"{min(d['durMs'] for d, _ in device_spans):.3f}-"
        f"{max(d['durMs'] for d, _ in device_spans):.3f} ms (with the "
        f"{P45_SPIN_CYCLES}-cycle spin ahead of each timed launch), each "
        f"inside its execute span")
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "hotpath": hot,
            "kernel_ms": kernel_ms}


def tracer_cost(n: int = 20_000) -> float:
    """Host µs a request of the tracer's own work: a trace with the
    query path's nine spans (each a histogram observe) on a registry."""
    tracer = Tracer("query", registry=MetricsRegistry(),
                    stages=tuple(P45_STAGES) + ("admit.queue",
                                                "execute.device"),
                    extra_labels={"engine_id": ""})
    t0 = time.perf_counter()
    for _ in range(n):
        with tracer.trace("query", trace_id="cost") as tr:
            tr.rebase(0.0001)
            for stage in ("accept", "admit.queue", "admit", "parse",
                          "queue", "execute.device", "execute",
                          "serialize", "write"):
                tr.add_span(stage, 1e-5, rel_start_s=0.0)
        tr.extend_total()
    return (time.perf_counter() - t0) / n * 1e6


def drive_mixed(port: int, texts: list, n_clients: int, per_client: int,
                tag: str) -> list:
    """``n_clients`` keep-alive clients at once, each ``per_client``
    queries with ``X-Pio-Trace: <tag>-<k>-<n>``; every status accepted:
    ``[(text index, status, Retry-After, answer)]``."""
    records, errors = [], []
    lock = threading.Lock()

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            for n in range(per_client):
                i = (k + n) % len(texts)
                status, headers, got = call(
                    conn, "POST", "/queries.json", {"text": texts[i]},
                    {"X-Pio-Trace": f"{tag}-{k}-{n}"})
                with lock:
                    records.append((i, status, headers.get("retry-after"),
                                    got))
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(f"client {k}: {e!r}")
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=CLI_TIMEOUT_S)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"45.2 clients failed: {errors[:3]}")
    return records


def p45_overload(smi, engine, ep, gpu, texts, want) -> dict:
    """45.2: 32 clients x 32 against a small admission, batcher off/on."""
    out = {}
    launches = 0
    for mode, window in (("off", "0"), ("on", str(MB_WINDOW_US))):
        with knob(MB_KNOBS[0], window), knob(MB_KNOBS[1], "0"):
            server = create_query_server(engine, ep, [gpu],
                                         host="127.0.0.1", port=0,
                                         device=CARD, qos=P45_OVERLOAD)
        with server:
            svc = server.service
            d0 = dict(svc.bucket_dispatches)
            c0 = read_counts()["embedding_bag"]
            records = drive_mixed(server.port, texts, N_CLIENTS, PER_CLIENT,
                                  f"smoke45{mode}")
            run_launches = read_counts()["embedding_bag"] - c0
            dispatches = sum(svc.bucket_dispatches[b] - d0.get(b, 0)
                             for b in svc.bucket_dispatches)
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=60)
            _, _, qos = call(conn, "GET", "/qos.json")
            _, _, ring = call(conn, "GET", "/traces.json?n=128&order=recent")
            conn.close()
        codes = collections.Counter(r[1] for r in records)
        sheds = sum(qos["shed"].values())
        bad = [r for r in records if r[1] in (429, 503) and not r[2]]
        # batcher off: the solo path's bits; on: a batch's bags through
        # another launch plan and head shape, held as phase 36 holds them
        wrong = [(i, got) for i, status, _, got in records
                 if status == 200 and (got != want[i] if mode == "off" else (
                     got["label"] != want[i]["label"] or abs(
                         got["confidence"] - want[i]["confidence"])
                     > CONF_TOL))]
        other = set(codes) - {200, 429, 503}
        executed = codes[200]
        want_launches = executed if mode == "off" else dispatches
        if bad or wrong or other or sheds != codes[429] + codes[503] \
                or run_launches != want_launches:
            raise AssertionError(
                f"45.2 batcher {mode}: codes {dict(codes)}, sheds {qos['shed']}"
                f", {len(bad)} without Retry-After, {len(wrong)} 200s not the "
                f"solo answer, launches {run_launches} against "
                f"{want_launches} (dispatches {dispatches})")
        batches = [t for t in ring["traces"] if t["kind"] == "microbatch"]
        if mode == "on":
            if not batches or any(
                    len(t["links"]) != t["meta"]["batch"]
                    or not all(x.startswith("smoke45on-") for x in t["links"])
                    for t in batches):
                raise AssertionError(f"45.2: microbatch traces {batches[:2]}")
        launches += run_launches
        out[mode] = {"codes": dict(codes), "shed": qos["shed"],
                     "launches": run_launches, "dispatches": dispatches,
                     "microbatch_traces": len(batches)}
        log(f"  45.2 batcher {mode}, {N_CLIENTS} clients x {PER_CLIENT} "
            f"under {P45_OVERLOAD}: 200 {codes[200]}, 429 {codes[429]}, "
            f"503 {codes[503]}, each shed with Retry-After; /qos.json shed "
            f"{json.dumps(qos['shed'])} (sum {sheds}); every 200 the solo "
            f"answer; forward launches {run_launches} = "
            f"{'the executed requests' if mode == 'off' else 'the dispatches'}"
            f" ({want_launches}); microbatch traces in the ring "
            f"{len(batches)}, each linking its members; {smi}")
    out["launches"] = launches
    return out


def p45_breaker(smi, engine, ep, gpu, texts, want) -> dict:
    """45.3: a spent deadline, the scorer breaker and the stale cache."""
    server = create_query_server(engine, ep, [gpu], host="127.0.0.1",
                                 port=0, device=CARD, qos=P45_BREAKER)
    states = []
    with server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)

        def query(i, headers=None):
            return call(conn, "POST", "/queries.json", {"text": texts[i]},
                        headers)

        def state():
            return call(conn, "GET", "/qos.json")[2]

        c0 = read_counts()["embedding_bag"]
        spent = query(0, {"X-Pio-Deadline-Ms": "0.001"})
        if spent[0] != 503 or spent[2] != {
                "message": "overloaded: deadline"} or "retry-after" not in \
                spent[1] or read_counts()["embedding_bag"] != c0 \
                or state()["shed"]["deadline"] != 1:
            raise AssertionError(f"45.3 spent deadline: {spent}")
        cached = [query(i) for i in range(P45_CACHED)]
        if any(c[0] != 200 or c[2] != want[i] for i, c in enumerate(cached)):
            raise AssertionError("45.3: the cached queries' answers")
        faults.install("scorer.dispatch.solo=error")
        try:
            fails, k = [], P45_CACHED
            while state()["breakers"]["scorer"]["state"] != "open":
                fails.append(query(k)[0])
                k += 1
                if len(fails) > 20:
                    raise AssertionError("45.3: the breaker never opened")
            states.append(state()["breakers"]["scorer"])
            c1 = read_counts()["embedding_bag"]
            degraded = [query(i) for i in range(P45_CACHED)]
            shed = [query(P45_CACHED + 100 + i) for i in range(4)]
            open_launches = read_counts()["embedding_bag"] - c1
        finally:
            faults.uninstall()
        for i, d in enumerate(degraded):
            if d[0] != 200 or d[1].get("x-pio-degraded") != "stale-cache" \
                    or d[2] != cached[i][2]:
                raise AssertionError(f"45.3 degraded {i}: {d}")
        if any(x[0] != 503 or x[2] != {"message": "overloaded: breaker"}
               or "retry-after" not in x[1] for x in shed) \
                or open_launches or set(fails) != {500}:
            raise AssertionError(f"45.3 while open: {shed}, launches "
                                 f"{open_launches}, fails {fails}")
        time.sleep(P45_COOLDOWN_S + 0.1)
        states.append(state()["breakers"]["scorer"])
        probes = [query(P45_CACHED + 200 + i) for i in range(2)]
        states.append(state()["breakers"]["scorer"])
        final = state()
        conn.close()
        launches = read_counts()["embedding_bag"] - c0
    if [x["state"] for x in states] != ["open", "half_open", "closed"] \
            or any(p[0] != 200 for p in probes):
        raise AssertionError(f"45.3 transitions: {states}, probes "
                             f"{[p[0] for p in probes]}")
    log(f"  45.3 a {spent[1]['retry-after']}-second Retry-After on the spent "
        f"deadline (shed reason deadline, nothing launched); "
        f"scorer.dispatch.solo=error: {len(fails)} failing queries (500) "
        f"opened the breaker; while open, {len(degraded)} cached queries 200 "
        f"under X-Pio-Degraded: stale-cache, bit for bit their earlier "
        f"answers, {len(shed)} others 503 breaker with Retry-After, "
        f"{open_launches} launches; /qos.json scorer "
        f"{' -> '.join(x['state'] for x in states)} after a "
        f"{P45_COOLDOWN_S} s cooldown and {len(probes)} probes; shed "
        f"{json.dumps(final['shed'])}, degraded {final['degraded']}; {smi}")
    return {"launches": launches, "states": states}


def p45_feedback(smi, engine, ep, gpu, texts, want) -> dict:
    """45.4: feedback: every answer's prId and predict event."""
    app_id = Storage.get_meta_data_apps().insert(App(0, P45_FEEDBACK_APP))
    server = create_query_server(engine, ep, [gpu], host="127.0.0.1",
                                 port=0, device=CARD, feedback=True,
                                 feedback_app_id=app_id)
    c0 = read_counts()["embedding_bag"]
    with server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        answers = [call(conn, "POST", "/queries.json", {"text": texts[i]})
                   for i in range(P45_FEEDBACK)]
        conn.close()
    launches = read_counts()["embedding_bag"] - c0
    events = {e.entity_id: e for e in Storage.get_levents().find(app_id)}
    for i, (status, _, got) in enumerate(answers):
        e = events.get(got.get("prId"))
        plain = {k: v for k, v in got.items() if k != "prId"}
        if status != 200 or plain != want[i] or e is None \
                or (e.event, e.entity_type, e.pr_id) != (
                    "predict", "pio_pr", got["prId"]) \
                or e.properties["query"] != {"text": texts[i]} \
                or e.properties["prediction"] != got:
            raise AssertionError(f"45.4 query {i}: {status} {got}, event {e}")
    if len(events) != P45_FEEDBACK:
        raise AssertionError(f"45.4: {len(events)} predict events")
    log(f"  45.4 {P45_FEEDBACK} queries with feedback app "
        f"{P45_FEEDBACK_APP!r}: each answer carries its prId, and "
        f"{len(events)} predict events of pio_pr hold its query and "
        f"prediction; {smi}")
    return {"launches": launches}


def p45_ingest(args, smi, ingest_44) -> dict:
    """45.5: the event server's request plane on SQLite."""
    home = fresh_home("p45_ingest")
    db = os.path.join(home, "pio.db")
    bodies = rate_bodies(args.seed)[:P45_EVENTS]
    with store_config({"METADATA": ("sqlite", db),
                       "EVENTDATA": ("sqlite", db)}):
        app_id = Storage.get_meta_data_apps().insert(App(0, "p45-ingest"))
        key = Storage.get_meta_data_access_keys().insert(AccessKey("", app_id))
        server = create_event_server(host="127.0.0.1", port=0,
                                     slos=P45_SLOS, qos=P45_INGEST_QOS)
        server.start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=60)
            t0 = time.perf_counter()
            for b in range(0, len(bodies), QS_BATCH):
                status, _, got = call(
                    conn, "POST", f"/batch/events.json?accessKey={key}",
                    bodies[b:b + QS_BATCH],
                    {"X-Pio-Trace": f"ev45-{b // QS_BATCH}"})
                if status != 200 or any(r["status"] != 201 for r in got):
                    raise AssertionError(f"45.5 batch {b}: {status}")
            rate = len(bodies) / (time.perf_counter() - t0)
            batch_traces = [call(conn, "GET", f"/traces.json?id=ev45-{n}")
                            [2]["traces"][0] for n in (0, 50, 99)]
            t0 = time.perf_counter()

            def singles(k):
                c = http.client.HTTPConnection("127.0.0.1", server.port,
                                               timeout=60)
                try:
                    for n in range(P45_SINGLES):
                        status, _, _ = call(
                            c, "POST", f"/events.json?accessKey={key}",
                            {**bodies[n], "entityId": f"s{k}"},
                            {"X-Pio-Trace": f"ev45s-{k}-{n}"})
                        if status != 201:
                            raise AssertionError(f"45.5 single: {status}")
                finally:
                    c.close()

            with concurrent.futures.ThreadPoolExecutor(P45_SINGLE_CLIENTS) \
                    as ex:
                for f in [ex.submit(singles, k)
                          for k in range(P45_SINGLE_CLIENTS)]:
                    f.result(timeout=CLI_TIMEOUT_S)
            singles_s = time.perf_counter() - t0
            # the newest single posts' traces, and the flush traces of
            # the committer's ring (64) that carried them
            single_traces = [
                t for t in call(conn, "GET", "/traces.json?n=128&commits=0"
                                "&order=recent")[2]["traces"]
                if t["id"].startswith("ev45s-")]
            commits = {}
            for t in single_traces:
                cid = t["meta"]["commit"]
                if cid not in commits:
                    status, _, got = call(conn, "GET",
                                          f"/traces.json?id={cid}")
                    commits[cid] = got["traces"][0] if status == 200 \
                        else None
            # one transient commit error, retried away: the batched
            # flush fails, and the payload's solo flush fails once more
            faults.install("groupcommit.flush.sqlite=error:once,"
                           "storage.sqlite.commit=error:once")
            try:
                retried = call(conn, "POST", f"/events.json?accessKey={key}",
                               bodies[0])
            finally:
                faults.uninstall()
            hook = call(conn, "POST",
                        f"/webhooks/segmentio.json?accessKey={key}",
                        {"type": "track", "event": "signup",
                         "userId": "smoke45", "properties": {"plan": "pro"}})
            routes = {r: call(conn, "GET", r)[0] for r in (
                "/stats.json", "/storage.json", "/healthz", "/readyz",
                "/qos.json", "/slo.json", "/debug/hotpath.json",
                "/logs.json", "/plugins.json")}
            metrics = call(conn, "GET", "/metrics")[2]
            # the storage breaker: every commit fails until it opens
            faults.install("storage.sqlite.commit=error")
            try:
                codes = []
                while True:
                    status, headers, got = call(
                        conn, "POST", f"/events.json?accessKey={key}",
                        bodies[1])
                    codes.append(status)
                    if status == 503 or len(codes) > 10:
                        break
            finally:
                faults.uninstall()
            qos = call(conn, "GET", "/qos.json")[2]
            conn.close()
        finally:
            server.stop()
        stored = Storage.get_levents().get(hook[2]["eventId"], app_id)
    for t in batch_traces:
        if top_stages(t) != ["accept", "admit", "validate", "store", "write"]:
            raise AssertionError(f"45.5 batch trace {t}")
    waited = linked = 0
    for t in single_traces:
        names = [x["stage"] for x in t["spans"]]
        waited += "store.commit_wait" in names
        commit = commits[t["meta"]["commit"]]
        if commit is not None:
            if t["id"] not in commit["links"]:
                raise AssertionError(f"45.5: {t['id']} not linked from "
                                     f"{commit}")
            linked += 1
        if top_stages(t) != ["accept", "admit", "parse", "validate",
                             "store", "write"] or "store.flush" not in names:
            raise AssertionError(f"45.5 single trace {t}")
    if len(single_traces) < 100 or linked < 32:
        raise AssertionError(f"45.5: {len(single_traces)} single traces in "
                             f"the ring, {linked} linked from a commit trace")
    families = {line.split()[2] for line in metrics.splitlines()
                if line.startswith("# TYPE ")}
    retry_lines = [line for line in metrics.splitlines()
                   if line.startswith("pio_tpu_storage_retries_total{")]
    need = {"pio_tpu_groupcommit_flush_seconds",
            "pio_tpu_groupcommit_batch_size", "pio_tpu_storage_retries_total",
            "pio_tpu_event_stage_seconds", "pio_tpu_qos_shed_total"}
    if retried[0] != 201 or not need <= families or not retry_lines \
            or hook[0] != 201 or stored is None or stored.event != "signup" \
            or any(c != 200 for c in routes.values()) or codes[-1] != 503 \
            or "retry-after" not in headers \
            or qos["breakers"]["storage"]["state"] != "open":
        raise AssertionError(
            f"45.5: retried {retried[0]}, families missing "
            f"{need - families}, webhook {hook[0]} stored {stored}, routes "
            f"{routes}, breaker codes {codes}, {qos['breakers']}")
    log(f"  45.5 the event server on SQLite with a QoS gate: {len(bodies)} "
        f"events in batches of {QS_BATCH} at {rate:.1f} events/s (phase "
        f"44.1's SQLite {ingest_44:.1f}; host clock, os.cpu_count() "
        f"{os.cpu_count()}); batch traces {['/'.join(top_stages(t)) for t in batch_traces[:1]]} "
        f"(a batch is one write outside the group committer, as in the "
        f"reference); {P45_SINGLE_CLIENTS * P45_SINGLES} single posts of "
        f"{P45_SINGLE_CLIENTS} clients in {singles_s:.3f} s: the ring's "
        f"{len(single_traces)} each with store.flush, {linked} linked from "
        f"the committer's {sum(c is not None for c in commits.values())} "
        f"flush traces still in its ring, {waited} with store.commit_wait "
        f"(queued at least 100 us behind another leader); /metrics {sorted(need)} ({retry_lines}); the Segment.io "
        f"webhook stored {stored.event!r}; {sorted(routes)} 200; "
        f"storage.sqlite.commit=error: codes {codes}, the storage breaker "
        f"open with Retry-After {headers['retry-after']}; {smi}")
    return {"events_per_s": rate, "commit_waits": waited}


def phase_request_plane(args, smi, gpu, queries, http_answers, p50_36,
                        ingest_44) -> dict:
    """Phase 45: the request plane of both servers on phase 4's model."""
    t_phase = time.monotonic()
    log(f"phase 45: the request plane: traced serving of phase 4's model "
        f"under SLOs and QoS, overload, deadline, breaker and stale cache, "
        f"feedback, and the event server's; {smi}")
    engine = get_engine_factory("templates.textclassification")()
    ep = EngineParams(algorithm_params_list=(("mlp", MLPParams()),))
    algo = MLPAlgorithm()
    texts = queries[:P45_QUERIES]
    faults.uninstall()
    walls = {}
    t = time.monotonic()
    # the solo path's answers, the bits every served answer must have: in
    # this process, before the counts start (their launches compare)
    want = [to_jsonable(algo.predict(gpu, Query(text=x))) for x in texts]
    reset_counts()
    traced = p45_traced(smi, engine, ep, gpu, texts, want, http_answers,
                        p50_36)
    walls["45.1"] = time.monotonic() - t
    cost_us = tracer_cost()
    log(f"  45.1 the tracer's own work: {cost_us:.3f} us a request (a "
        f"trace, nine spans and their histogram observes; host clock, "
        f"{tracer_cost.__defaults__[0]} in a loop); {smi}")
    t = time.monotonic()
    overload = p45_overload(smi, engine, ep, gpu, texts[:PER_CLIENT],
                            want[:PER_CLIENT])
    walls["45.2"] = time.monotonic() - t
    t = time.monotonic()
    p45_breaker(smi, engine, ep, gpu, texts, want)
    walls["45.3"] = time.monotonic() - t
    t = time.monotonic()
    p45_feedback(smi, engine, ep, gpu, texts, want)
    walls["45.4"] = time.monotonic() - t
    t = time.monotonic()
    p45_ingest(args, smi, ingest_44)
    walls["45.5"] = time.monotonic() - t
    launches = read_counts()
    log(f"  phase 45 launches (added to the kernels' line): "
        f"{json.dumps(launches)}; walls {json.dumps({k: round(v, 1) for k, v in walls.items()})}; "
        f"phase 45 {time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "traced": traced, "overload": overload,
            "tracer_us": cost_us}


# ------------------------------- phase 46: the pool plane and the router
#: 46.1: the pool's workers, and the distinct text queries every load sends
P46_WORKERS = 4
P46_BODIES = 64
#: 46.1: the rate budget of the second pool (queries/s and burst), well
#: under a 4-worker text pool's rate (phase 39's classification pool served
#: 1,177-1,814 queries/s; 46.1 measures this pool's own), and how long its
#: 32 clients push against it
P46_RPS, P46_BURST, P46_QOS_S = 100.0, 50.0, 3.0
#: 46.1: how long a sibling waits for worker 0's lane answer in both pools
#: (``PIO_TPU_LANE_TIMEOUT_S``, 0.25 s by default), seconds. A query that
#: outwaits it is served on the sibling's own CPU, which 46.1 fails; the
#: default is shorter than the text pool's p99 under 32 clients
P46_LANE_TIMEOUT_S = 5.0
#: 46.2: the fleet's and the router's scrape interval, seconds
P46_INTERVAL = "0.5"
#: 46.3: a terminal rollout stage within this many seconds
P46_ROLLOUT_S = 60.0
P46_TERMINAL = ("promoted", "rolled_back", "failed")
_SAMPLE = re.compile(r"^(\w+)(\{[^}]*\})? (\S+)")


@contextlib.contextmanager
def served(env: dict, log_path: str, *args):
    """``python -m pio_tpu_torch <args>`` as a server process, its output
    in ``log_path``; killed on the way out if it is still running."""
    with open(log_path, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pio_tpu_torch", *args], cwd=ROOT, env=env,
            stdout=f, stderr=subprocess.STDOUT)
    try:
        yield proc
    except BaseException:
        with open(log_path) as f:
            log(f"  {' '.join(args[:2])} log, last lines:\n"
                f"{f.read()[-3000:]}")
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)


_LISTENING = re.compile(r"listening on [\w.:]+:(\d+)")


def listening_port(log_path: str, proc) -> int:
    """The port a server started with ``--port 0`` bound, from its
    "listening on IP:PORT" line (a pool prints it once every worker,
    worker 0 included, is ready); fail once it exited or after
    POOL_TIMEOUT_S. Port 0 lets the kernel pick: a port chosen ahead
    could be taken by another process's ephemeral socket meanwhile."""
    deadline = time.monotonic() + POOL_TIMEOUT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"{log_path}: exited {proc.returncode}")
        with open(log_path) as f:
            m = _LISTENING.search(f.read())
        if m:
            return int(m.group(1))
        time.sleep(0.2)
    raise AssertionError(f"{log_path}: not listening in {POOL_TIMEOUT_S} s")


def wait_healthy(port: int, proc, path: str = "/healthz") -> None:
    """Until the server answers ``GET path`` 200 (or its process exits)."""
    deadline = time.monotonic() + CLI_TIMEOUT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"the server exited with {proc.returncode}")
        try:
            if get_text(port, path)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"no healthy server on :{port} after "
                         f"{CLI_TIMEOUT_S} s")


def get_json(port: int, path: str) -> tuple:
    """(status, decoded JSON) of one GET on a fresh connection."""
    status, body = get_text(port, path)
    return status, json.loads(body)


def send(port: int, method: str, path: str, body=None) -> tuple:
    """(status, headers, answer) of one request on a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, None if body is None
                     else json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read().decode()
        try:
            got = json.loads(raw)
        except ValueError:
            got = raw
        return resp.status, dict(resp.getheaders()), got
    finally:
        conn.close()


def samples(text: str, family: str) -> dict:
    """{label set: value} of one family in an exposition text."""
    out = {}
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m and m.group(1) == family:
            out[m.group(2) or ""] = float(m.group(3))
    return out


def close_answer(got: dict, want: dict, where: str) -> None:
    """The same label, the confidence within CONF_TOL (a batched dispatch
    and a solo one sum the same f32 products in another order)."""
    if got["label"] != want["label"] \
            or abs(got["confidence"] - want["confidence"]) > CONF_TOL:
        raise AssertionError(f"{where}: {got} against {want}")


def timed_answers(port: int, bodies: list) -> tuple:
    """Each body once on one keep-alive connection: (answers, host ms)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    answers, ms = [], []
    try:
        for b in bodies:
            t = time.perf_counter()
            code, got = request(conn, "POST", "/queries.json", b)
            ms.append((time.perf_counter() - t) * 1e3)
            if code != 200:
                raise AssertionError(f"query on :{port}: {code} {got}")
            answers.append(got)
    finally:
        conn.close()
    return answers, ms


def drive_for(port: int, bodies: list, n_clients: int, seconds: float):
    """``n_clients`` keep-alive clients sending bodies in turn for
    ``seconds``: ([(body index, status, answer, Retry-After)], wall s)."""
    records, errors = [], []
    lock = threading.Lock()
    stop = time.monotonic() + seconds

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        n = 0
        try:
            while time.monotonic() < stop:
                i = (k + n) % len(bodies)
                conn.request("POST", "/queries.json",
                             json.dumps(bodies[i]).encode(),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                answer = json.loads(resp.read())
                with lock:
                    records.append((i, resp.status, answer,
                                    resp.getheader("Retry-After")))
                n += 1
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(f"client {k}: {e!r}")
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"load clients failed: {errors[:3]}")
    return records, wall


def p46_instances(text) -> tuple:
    """Phase 29's variant and its two newest COMPLETED text instances in
    phase 29's home: phase 29's ``pio train`` (the incumbent) and phase
    40.1's ``run_train`` (the candidate)."""
    variant = variant_from_dict(text["variant"], path=text["engine_json"])
    with cli_store(text["home"]):
        done = Storage.get_meta_data_engine_instances().get_completed(
            variant.engine_id, variant.engine_version, variant.path)
    done = sorted(done, key=lambda i: i.start_time)
    if len(done) < 2:
        raise AssertionError(f"phase 29's home holds {len(done)} COMPLETED "
                             f"text instances, not 2")
    return variant, done[-2].id, done[-1].id


def every_worker_again(port: int, path: str, key, want=None) -> dict:
    """:func:`every_worker` over the pool, again while a connection still
    lands on a killed worker's socket (reset) until its respawn listens."""
    deadline = time.monotonic() + POOL_TIMEOUT_S
    while True:
        try:
            return every_worker(port, path, key, want=want,
                                n_workers=P46_WORKERS)
        except (OSError, http.client.HTTPException):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def lane_of(stats: dict, where: str, tag: str = "46.1") -> dict:
    """A ``--device-worker`` pool's lane from every worker's
    ``/stats.json``: each sibling's enqueued and fallen-back queries (a
    fallback is a query the sibling served itself, on the CPU: the card
    is worker 0's alone) against the queries it answered, and worker 0's
    drained count. Logged here; :func:`lane_faults` judges it."""
    lane = {w: s.get("batchLane", {}) for w, s in stats.items()}
    sib = range(1, P46_WORKERS)
    out = {"where": where, "drained": lane[0].get("drained", 0),
           "enqueued": {w: lane[w].get("enqueued", 0) for w in sib},
           "answered": {w: stats[w]["requestCount"] for w in sib},
           "fallbacks": {w: lane[w].get("fallbacks", {}) for w in sib}}
    log(f"  {tag} {where}'s lane: worker 0 drained {out['drained']}; the "
        f"siblings enqueued {out['enqueued']} of the queries they answered "
        f"{out['answered']}, fallbacks by reason {out['fallbacks']}")
    return out


def lane_faults(lane: dict) -> list:
    """What is wrong with a pool's lane: any sibling's fallback, a sibling
    that answered a query it did not enqueue, or fewer drained than the
    siblings enqueued."""
    fell = sum(sum(f.values()) for f in lane["fallbacks"].values())
    bad = []
    if fell:
        bad.append(f"{lane['where']}: {fell} queries served on a "
                   f"sibling's CPU {lane['fallbacks']}")
    if lane["enqueued"] != lane["answered"]:
        bad.append(f"{lane['where']}: enqueued {lane['enqueued']}, "
                   f"answered {lane['answered']}")
    if lane["drained"] < sum(lane["enqueued"].values()):
        bad.append(f"{lane['where']}: drained {lane['drained']} < "
                   f"enqueued {sum(lane['enqueued'].values())}")
    return bad


def pool_totals(port: int, family: str, n: int = 8) -> list:
    """``family``'s samples on ``n`` scrapes of the pool's port (the kernel
    picks a worker for each connection)."""
    return [samples(get_text(port, "/metrics")[1], family) for _ in range(n)]


def p46_pool(smi, env, home, ej, iid_a, bodies, want, ports) -> dict:
    """46.1: the pool serves 32 clients; pool-wide totals on every worker;
    a killed sibling's respawn adopts its stripe; the QoS pool admits one
    budget; every query of both pools ran on the card."""
    p1, p2 = ports["pool"], ports["qos_pool"]
    records, wall = drive_load(p1, bodies, N_CLIENTS, PER_CLIENT)
    for (i, _), answer in distinct_answers(records).items():
        close_answer(answer, want[i], f"46.1 pool body {i}")
    lat = latency(records, wall)
    sent = N_CLIENTS * PER_CLIENT
    stats = every_worker(p1, "/stats.json", "worker",
                         n_workers=P46_WORKERS)
    counts = {w: s["pool"]["requestCount"] for w, s in stats.items()}
    own = {w: s["requestCount"] for w, s in stats.items()}
    lanes = [lane_of(stats, "the pool")]
    scraped = {json.dumps(t, sort_keys=True)
               for t in pool_totals(p1, "pio_tpu_queries_total")}
    gens = samples(get_text(p1, "/metrics")[1],
                   "pio_tpu_pool_stripe_generation")
    log(f"  46.1 the pool ({P46_WORKERS} workers, --device-worker) served "
        f"{lat['n']} "
        f"queries of {N_CLIENTS} clients, each within {CONF_TOL} of the "
        f"single process's answer; p50 {lat['p50_ms']:.3f} ms, p99 "
        f"{lat['p99_ms']:.3f} ms, {lat['qps']:.1f} queries/s (host clock); "
        f"/stats.json pool requestCount by worker {counts} (their own "
        f"{own}); /metrics pio_tpu_queries_total on 8 scrapes {scraped}; "
        f"stripe generations {gens}; {smi}")
    if set(counts.values()) != {sent} or sum(own.values()) != sent \
            or len(scraped) != 1 \
            or list(json.loads(scraped.pop()).values()) != [float(sent)] \
            or sorted(gens.values()) != [1.0] * P46_WORKERS:
        raise AssertionError("46.1: the workers' pool totals are not the "
                             "requests sent")
    # kill the busiest sibling: its respawn adopts the stripe (generation
    # 2), so the pool's totals keep its requests
    status = every_worker(p1, "/", "worker", n_workers=P46_WORKERS)
    victim = max(range(1, P46_WORKERS), key=lambda w: own[w])
    old_pid = status[victim]["pid"]
    t0 = time.monotonic()
    os.kill(old_pid, 9)
    status = every_worker_again(p1, "/", "worker",
                                want=lambda s: s["worker"] != victim
                                or s["pid"] != old_pid)
    respawn_s = time.monotonic() - t0
    gens = samples(get_text(p1, "/metrics")[1],
                   "pio_tpu_pool_stripe_generation")
    stats = every_worker_again(p1, "/stats.json", "worker")
    after = {w: s["pool"]["requestCount"] for w, s in stats.items()}
    log(f"  46.1 worker {victim} (pid {old_pid}, {own[victim]} of the "
        f"requests) killed, respawned as pid {status[victim]['pid']} in "
        f"{respawn_s:.1f} s; stripe generations {gens}; pool requestCount "
        f"by worker {after}")
    if gens.get(f'{{worker="{victim}"}}') != 2.0 or own[victim] <= 0 \
            or set(after.values()) != {sent}:
        raise AssertionError("46.1: the respawn did not adopt its stripe")
    # the second pool, under --qos rps=R: one budget, not one a worker
    qrec, qwall = drive_for(p2, bodies, N_CLIENTS, P46_QOS_S)
    codes = collections.Counter(s for _, s, _, _ in qrec)
    for i, s, answer, _ in qrec:
        if s == 200:
            close_answer(answer, want[i], f"46.1 QoS pool body {i}")
    sheds = [ra for _, s, _, ra in qrec if s == 429]
    budget = P46_BURST + P46_RPS * qwall
    qstats = every_worker(p2, "/stats.json", "worker", n_workers=P46_WORKERS)
    lanes.append(lane_of(qstats, "the QoS pool"))
    admitted = samples(get_text(p2, "/metrics")[1],
                       "pio_tpu_qos_admitted_total")
    log(f"  46.1 the pool under --qos rps={P46_RPS:g},burst={P46_BURST:g} "
        f"(R well under the first pool's {lat['qps']:.0f} queries/s), "
        f"{N_CLIENTS} clients for {qwall:.2f} s: statuses {dict(codes)} "
        f"({len(qrec) / qwall:.0f} requests/s offered), admitted "
        f"{codes[200]} against burst + R*t = {budget:.1f} ({P46_WORKERS} "
        f"budgets would be {P46_WORKERS * budget:.1f}); /metrics admitted "
        f"{admitted}; each worker's own answered "
        f"{ {w: s['requestCount'] for w, s in qstats.items()} } requests; "
        f"{smi}")
    if set(codes) - {200, 429} or not sheds or None in sheds \
            or codes[200] > budget + P46_WORKERS \
            or codes[200] < 0.8 * P46_RPS * qwall \
            or list(admitted.values()) != [float(codes[200])]:
        raise AssertionError(f"46.1: the QoS pool admitted {codes[200]} "
                             f"against one budget of {budget:.1f}")
    # every query either pool answered ran on the card: through worker 0's
    # lane, or in worker 0 itself
    bad = [b for lane in lanes for b in lane_faults(lane)]
    if bad:
        raise AssertionError(f"46.1: the lane: {bad}")
    return {"latency": lat, "respawn_s": respawn_s, "lanes": lanes,
            "qos": {"admitted": codes[200], "budget": budget,
                    "wall_s": qwall, "offered": len(qrec)}}


def p46_fleet(smi, env, home, ports, members: dict) -> dict:
    """46.2: ``fleet`` over the pool, the single process and the event
    server; ``dashboard`` and ``adminserver``; every route's status, and
    the fleet's sums against the members' own ``/metrics``."""
    targets = ",".join(f"127.0.0.1:{p}" for p in members.values())
    logs = {k: os.path.join(home, f"p46_{k}.log")
            for k in ("fleet", "dashboard", "admin")}
    with served(env, logs["fleet"], "fleet", "--targets", targets, "--ip",
                "127.0.0.1", "--port", "0", "--interval",
                P46_INTERVAL) as fleet, \
            served(env, logs["dashboard"], "dashboard", "--ip", "127.0.0.1",
                   "--port", "0", "--query-url",
                   f"http://127.0.0.1:{ports['pool']}", "--fleet-targets",
                   targets) as dash, \
            served(env, logs["admin"], "adminserver", "--ip", "127.0.0.1",
                   "--port", "0") as adm:
        pf, pdash, padm = (listening_port(logs[k], proc) for k, proc in (
            ("fleet", fleet), ("dashboard", dash), ("admin", adm)))
        for port, proc, path in ((pf, fleet, "/healthz"),
                                 (pdash, dash, "/healthz"),
                                 (padm, adm, "/")):
            wait_healthy(port, proc, path)
        own = {name: samples(get_text(p, "/metrics")[1],
                             "pio_tpu_queries_total")
               for name, p in members.items()}
        # two full scrape passes after the members' own reading (no
        # traffic in between): the federated samples are theirs
        status, fj = get_json(pf, "/fleet.json")
        passes = min(m["scrapes"] for m in fj["members"])
        deadline = time.monotonic() + 30
        while min(m["scrapes"] for m in fj["members"]) < passes + 2:
            if time.monotonic() > deadline:
                raise AssertionError("46.2: the fleet stopped scraping")
            time.sleep(0.1)
            status, fj = get_json(pf, "/fleet.json")
        fed = samples(get_text(pf, "/metrics")[1], "pio_tpu_queries_total")
        routes = {f"fleet {p}": get_text(pf, p)[0]
                  for p in ("/", "/fleet.json", "/metrics", "/healthz",
                            "/readyz")}
        routes.update({f"dashboard {p}": get_text(pdash, p)[0] for p in (
            "/", "/instances.json", "/serving.html", "/fleet.html",
            "/fleet.json", "/training.html", "/devices.html", "/metrics",
            "/logs.json", "/healthz", "/readyz")})
        routes.update({f"admin {p}": get_text(padm, p)[0]
                       for p in ("/", "/cmd/status", "/cmd/app")})
        serving = get_text(pdash, "/serving.html")[1]
        apps = get_json(padm, "/cmd/app")[1]
        made = send(padm, "POST", "/cmd/app", {"name": "smoke46"})
        dropped = send(padm, "DELETE", "/cmd/app/smoke46")
    want_fed = {}
    for name, port in members.items():
        for labels, v in own[name].items():
            member = f'pio_tpu_member="127.0.0.1:{port}"'
            key = ("{" + member + "}" if not labels
                   else labels[:-1] + "," + member + "}")
            want_fed[key] = v
    statuses = {m["member"]: m["status"] for m in fj["members"]}
    pool_total = sum(own["pool"].values())
    log(f"  46.2 fleet members {statuses}; the members' own "
        f"pio_tpu_queries_total {own}; the fleet's federated {fed}; "
        f"routes {json.dumps(routes)}; admin apps "
        f"{sorted(a['name'] for a in apps['apps'])}, POST {made[0]}, "
        f"DELETE {dropped[0]}; {smi}")
    names = [a["name"] for a in apps["apps"]]
    if set(statuses.values()) != {"up"} or fed != want_fed \
            or any(code != 200 for code in routes.values()) \
            or f"<td>{int(pool_total)}</td>" not in serving \
            or APP not in names or made[0] != 201 or dropped[0] != 200:
        raise AssertionError("46.2: fleet, dashboard or admin disagree")
    return {"routes": routes, "federated": fed}


def rollout_until_done(pr: int, drive) -> tuple:
    """Drive traffic until the router's rollout is terminal:
    (its ``/rollout.json``, seconds to get there)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < P46_ROLLOUT_S:
        drive()
        ro = get_json(pr, "/rollout.json")[1]
        if ro["stage"] in P46_TERMINAL:
            return ro, time.monotonic() - t0
    raise AssertionError(f"46.3: rollout still {ro['stage']} after "
                         f"{P46_ROLLOUT_S} s")


def p46_router(smi, env, home, variant, iid_a, iid_b, bodies, want, ports,
               direct_ms) -> dict:
    """46.3: ``route`` in front of the pool and the single process; a
    rollout whose candidate burns its SLO rolls back, then one promotes
    instance B onto both replicas."""
    p1, pd = ports["pool"], ports["single"]
    route_log = os.path.join(home, "p46_route.log")
    rollout_knobs = ["--judge-interval", "0.2", "--judge-fast", "2",
                     "--judge-slow", "4", "--burn-limit", "2",
                     "--mismatch-limit", "1.0", "--shadow-rate", "1.0"]
    with served(env, route_log, "route", "--targets",
                f"127.0.0.1:{p1},127.0.0.1:{pd}", "--ip", "127.0.0.1",
                "--port", "0", "--interval", P46_INTERVAL) as router, \
            cli_store(home):
        pr = listening_port(route_log, router)
        wait_alive(pr, router)
        deadline = time.monotonic() + 30
        while get_text(pr, "/readyz")[0] != 200:
            if time.monotonic() > deadline:
                raise AssertionError("46.3: the router never got ready")
            time.sleep(0.1)
        conn = http.client.HTTPConnection("127.0.0.1", pr, timeout=60)
        members, routed_ms = [], []
        try:
            for k, b in enumerate(bodies):
                t = time.perf_counter()
                conn.request("POST", "/queries.json", json.dumps(b).encode(),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                got = json.loads(resp.read())
                routed_ms.append((time.perf_counter() - t) * 1e3)
                members.append(resp.getheader("X-Pio-Router-Member"))
                if resp.status != 200:
                    raise AssertionError(f"46.3 routed query: {got}")
                close_answer(got, want[k], f"46.3 routed body {k}")
        finally:
            conn.close()
        added = float(np.median(routed_ms) - np.median(direct_ms))
        log(f"  46.3 {len(bodies)} queries through the router on one "
            f"connection, each the direct answer; members "
            f"{dict(collections.Counter(members))}; p50 "
            f"{np.median(routed_ms):.3f} ms against "
            f"{np.median(direct_ms):.3f} direct: {added:.3f} ms added a "
            f"query (host clock); {smi}")
        if len(set(members)) != 2:
            raise AssertionError(f"46.3: the router used members {members}")
        # the candidate: a query server in this process on the card
        cand = deploy_query_server(variant, host="127.0.0.1", port=0,
                                   instance_id=iid_a, device=CARD).start()
        try:
            before = {p: get_json(p, "/deploy.json")[1] for p in (p1, pd)}
            url = f"http://127.0.0.1:{pr}"
            target = f"127.0.0.1:{cand.port}"
            k = [0]

            def through_router(bad: bool):
                def drive():
                    b = bodies[k[0] % len(bodies)]
                    k[0] += 1
                    send(pr, "POST", "/queries.json", b)
                    if bad:  # a query the candidate cannot take: an error
                        send(cand.port, "POST", "/queries.json", {"txt": 1})
                return drive

            # a rollout the SLO gate fails: aborted, the old generation kept
            if cli_main(["rollout", "--url", url, "--start", iid_b,
                         "--targets", target, "--shadow-min-samples",
                         "100000", *rollout_knobs]) != 0:
                raise AssertionError("46.3: rollout --start failed")
            failed, failed_s = rollout_until_done(pr, through_router(True))
            kept = {p: get_json(p, "/deploy.json")[1] for p in (p1, pd)}
            log(f"  46.3 a rollout of {iid_b} whose candidate burns its "
                f"SLO: {failed['stage']} in {failed_s:.2f} s, trail "
                f"{[e['signal'] for e in failed['trail']]}; the replicas' "
                f"/deploy.json before {before} and after {kept}")
            if failed["stage"] != "rolled_back" or "slo_burn" not in [
                    e["signal"] for e in failed["trail"]] or kept != before:
                raise AssertionError("46.3: the failing rollout did not "
                                     "roll back to the old generation")
            # a rollout that promotes instance B onto both replicas
            t0 = time.monotonic()
            if cli_main(["rollout", "--url", url, "--start", iid_b,
                         "--targets", target, "--shadow-min-samples", "16",
                         "--shadow-hold", "0", "--canary-fraction", "1.0",
                         "--canary-hold", "0", "--canary-min-requests", "0",
                         *rollout_knobs]) != 0:
                raise AssertionError("46.3: rollout --start failed")
            done, _ = rollout_until_done(pr, through_router(False))
            rollout_s = time.monotonic() - t0
            report = io.StringIO()
            with contextlib.redirect_stdout(report):
                status_rc = cli_main(["rollout", "--url", url])
            # a pool's siblings follow the shared generation at their next
            # request (GET / is one); then every scrape is instance B's
            workers = every_worker(p1, "/", "worker", n_workers=P46_WORKERS,
                                   want=lambda s: s["engineInstanceId"]
                                   == iid_b)
            flipped = {pd: [get_json(pd, "/deploy.json")[1]],
                       p1: [get_json(p1, "/deploy.json")[1]
                            for _ in range(2 * P46_WORKERS)]}
            shadow = done.get("shadow") or {}
        finally:
            cand.close()
    signals = [e["signal"] for e in done["trail"]]
    log(f"  46.3 a rollout of {iid_b}: {done['stage']} in {rollout_s:.2f} s "
        f"(host clock, start to promoted), trail {signals}, shadow "
        f"{shadow.get('samples')} samples at mismatch rate "
        f"{shadow.get('mismatchRate')}; /deploy.json after (the pool's "
        f"on {2 * P46_WORKERS} connections) {flipped}; pool "
        f"workers on {sorted({s['engineInstanceId'] for s in workers.values()})}"
        f"; pio rollout:\n    "
        + report.getvalue().rstrip().replace("\n", "\n    "))
    if done["stage"] != "promoted" or status_rc != 0 \
            or "candidate_verified" not in signals \
            or "all_verified" not in signals \
            or any(got["engineInstanceId"] != iid_b
                   or got["generation"] != before[p]["generation"] + 1
                   for p in (p1, pd) for got in flipped[p]):
        raise AssertionError("46.3: the rollout did not flip both replicas")
    return {"added_ms": added, "rollout_s": rollout_s,
            "failed_rollout_s": failed_s}


def phase_pool_plane(args, smi, text) -> dict:
    """Phase 46: the pool plane and the router over phase 29's text
    engine, each server a process of ``python -m pio_tpu_torch``."""
    t_phase = time.monotonic()
    log(f"phase 46: the pool plane and the router over phase 29's text "
        f"engine: a pool of {P46_WORKERS} with --device-worker from "
        f"{N_CLIENTS} clients (pool-wide totals, a respawn's stripe, one "
        f"--qos budget), fleet, dashboard and adminserver, route over the "
        f"pool and a single deploy, two rollouts; {smi}")
    variant, iid_a, iid_b = p46_instances(text)
    home, ej = text["home"], text["engine_json"]
    env = cli_env(home)
    texts, _ = synth_corpus(np.random.default_rng(args.seed + 46),
                            P46_BODIES, N_WORDS, coverage=False)
    bodies = [{"text": t} for t in texts]
    c0 = read_counts()
    log_of = {k: os.path.join(home, f"p46_{k}.log")
              for k in ("single", "pool", "qos_pool", "events")}
    deploy = ["deploy", "--engine-json", ej, "--engine-instance-id", iid_a,
              "--ip", "127.0.0.1"]
    pool = ["--workers", str(P46_WORKERS), "--device-worker"]
    pool_env = {**env, "PIO_TPU_LANE_TIMEOUT_S": str(P46_LANE_TIMEOUT_S)}
    t0 = time.monotonic()
    with served(env, log_of["single"], *deploy, "--port", "0") as single, \
            served(pool_env, log_of["pool"], *deploy, "--port", "0",
                   *pool) as p1, \
            served(pool_env, log_of["qos_pool"], *deploy, "--port", "0",
                   *pool, "--qos",
                   f"rps={P46_RPS:g},burst={P46_BURST:g}") as p2, \
            served(env, log_of["events"], "eventserver", "--ip",
                   "127.0.0.1", "--port", "0") as events:
        ports = {k: listening_port(log_of[k], proc) for k, proc in (
            ("single", single), ("pool", p1), ("qos_pool", p2),
            ("events", events))}
        wait_alive(ports["single"], single)
        wait_alive(ports["events"], events)
        up_s = time.monotonic() - t0
        status = get_json(ports["single"], "/")[1]
        want, direct_ms = timed_answers(ports["single"], bodies)
        log(f"  46 the single process, both pools and the event server up "
            f"in {up_s:.1f} s (host clock, started together); instances "
            f"{iid_a} (serving) and {iid_b} (the rollouts' candidate); the "
            f"single process on {status['engineInstanceId']}, its "
            f"{len(bodies)} answers on one connection p50 "
            f"{np.median(direct_ms):.3f} ms")
        walls = {}
        t = time.monotonic()
        pooled = p46_pool(smi, env, home, ej, iid_a, bodies, want, ports)
        walls["46.1"] = time.monotonic() - t
        qos_w0 = every_worker(ports["qos_pool"], "/stats.json", "worker",
                              n_workers=P46_WORKERS)[0]["kernelLaunches"]
        send(ports["qos_pool"], "POST", "/undeploy", {})
        t = time.monotonic()
        p46_fleet(smi, env, home, ports, {
            "pool": ports["pool"], "single": ports["single"],
            "events": ports["events"]})
        walls["46.2"] = time.monotonic() - t
        t = time.monotonic()
        routed = p46_router(smi, env, home, variant, iid_a, iid_b, bodies,
                            want, ports, direct_ms)
        walls["46.3"] = time.monotonic() - t
        pool_w0 = every_worker(ports["pool"], "/stats.json", "worker",
                               n_workers=P46_WORKERS)[0]["kernelLaunches"]
        single_k = get_json(ports["single"], "/stats.json")[1][
            "kernelLaunches"]
        codes = [send(ports[k], "POST", "/undeploy", {})[0]
                 for k in ("pool", "single")]
        rcs = [proc.wait(timeout=60) for proc in (p1, single, p2)]
    here = counts_since(c0)
    launches = {k: here[k] + pool_w0[k] + qos_w0[k] + single_k[k]
                for k in here}
    log(f"  46 forward launches: the pool's worker 0 "
        f"{pool_w0['embedding_bag']}, the QoS pool's "
        f"{qos_w0['embedding_bag']}, the single process "
        f"{single_k['embedding_bag']}, the candidate in this process "
        f"{here['embedding_bag']}; /undeploy {codes}, the deploys exited "
        f"{rcs}")
    if codes != [200, 200] or rcs != [0, 0, 0] \
            or min(pool_w0["embedding_bag"], qos_w0["embedding_bag"],
                   single_k["embedding_bag"], here["embedding_bag"]) <= 0:
        raise AssertionError("46: a server did not launch the forward "
                             "kernel or did not end cleanly")
    log(f"  phase 46 launches (added to the kernels' line): "
        f"{json.dumps(launches)}; walls "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}; "
        f"phase 46 {time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "pool": pooled, "router": routed}


# ------------------------------------------------- the HTTP fronts (phase 47)
#: phase 47.1's pipelined burst on one connection
P47_BURST = 16
#: the fronts of phase 47.1, in the order they run
P47_FRONTS = ("threaded", "evloop")


def http_burst(port: int, bodies: list) -> list:
    """``bodies`` as one pipelined burst of ``POST /queries.json`` on one
    connection (the last asks to close): the decoded answers, in order."""
    blob = b""
    for n, b in enumerate(bodies):
        data = json.dumps(b).encode()
        close = b"Connection: close\r\n" if n == len(bodies) - 1 else b""
        blob += (b"POST /queries.json HTTP/1.1\r\nHost: c\r\nContent-Type: "
                 b"application/json\r\nContent-Length: %d\r\n%s\r\n%s"
                 % (len(data), close, data))
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(blob)
        raw = b""
        while chunk := s.recv(1 << 16):
            raw += chunk
    out = []
    while raw:
        head, _, raw = raw.partition(b"\r\n\r\n")
        lines = head.split(b"\r\n")
        length = next(int(ln.split(b":")[1]) for ln in lines
                      if ln.lower().startswith(b"content-length:"))
        if int(lines[0].split()[1]) != 200:
            raise AssertionError(f"burst answer {len(out)}: {lines[0]!r}")
        out.append(json.loads(raw[:length]))
        raw = raw[length:]
    return out


def p47_fronts(smi, gpu, bodies, http_answers) -> dict:
    """47.1: phase 4's model on each front in this process."""
    engine = get_engine_factory("templates.textclassification")()
    ep = EngineParams(algorithm_params_list=(("mlp", MLPParams()),))
    out = {}
    for front in P47_FRONTS:
        with knob("PIO_TPU_HTTP_FRONT", front):
            server = create_query_server(engine, ep, [gpu], host="127.0.0.1",
                                         port=0, device=CARD)
        if server.front != front:
            raise AssertionError(f"47.1: asked for {front}, got "
                                 f"{server.front}")
        with server:
            for n_clients in (1, N_CLIENTS):
                records, wall = drive_load(server.port, bodies, n_clients,
                                           PER_CLIENT)
                for i, _, answer, _ in records:
                    close_answer(answer, http_answers[i],
                                  f"47.1 {front} body {i}")
                lat = latency(records, wall)
                out[(front, n_clients)] = lat
                log(f"  47.1 {front} front, {n_clients} client(s) x "
                    f"{PER_CLIENT}: p50 {lat['p50_ms']:.3f} ms, p99 "
                    f"{lat['p99_ms']:.3f} ms, {lat['qps']:.0f} queries/s "
                    f"(host clock); {smi}")
            burst = [bodies[k % len(bodies)] for k in range(P47_BURST)]
            got = http_burst(server.port, burst)
            if len(got) != P47_BURST:
                raise AssertionError(f"47.1 {front}: {len(got)} answers to "
                                     f"a burst of {P47_BURST}")
            for k, answer in enumerate(got):
                close_answer(answer, http_answers[k % len(bodies)],
                              f"47.1 {front} burst answer {k}")
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=60)
            out[(front, "plain")] = [post(conn, json.dumps(b).encode())[1]
                                     for b in bodies]
            conn.close()
            out[(front, "stats")] = server.service.stats()
        log(f"  47.1 {front} front: a pipelined burst of {P47_BURST} on one "
            f"connection answered in order, each within {CONF_TOL} of "
            f"phase 5's")
    return out


def p47_pool(smi, args, reloaded, pool39) -> dict:
    """47.2: phase 39's pool of 4 again, on the evloop front."""
    home, ej = reloaded["home"], reloaded["engine_json"]
    variant = variant_from_dict(POOL_VARIANT, path=ej)
    bodies = pool_bodies(args.seed + 47)
    with cli_store(home):
        mirror = cpu_mirror(variant, pool39["instance"])
    want = [mirror.query(json.dumps(b).encode()) for b in bodies]
    frames = [mirror.pack_query_body(b) for b in bodies]
    mirror.close()
    env = {**cli_env(home), "PIO_TPU_HTTP_FRONT": "evloop",
           "PIO_TPU_LANE_TIMEOUT_S": str(P46_LANE_TIMEOUT_S)}
    port = free_port()
    t0 = time.monotonic()
    with cli_server(env, home, "deploy", "--engine-json", ej, "--ip",
                    "127.0.0.1", "--port", str(port), "--workers",
                    str(POOL_WORKERS), "--device-worker", "--device",
                    CARD.type) as proc:
        wait_listening(home, proc)
        up_s = time.monotonic() - t0
        records, wall = drive_load(port, bodies, N_CLIENTS, PER_CLIENT,
                                   frames=frames)
        for (i, _), answer in distinct_answers(records).items():
            if answer != want[i]:
                raise AssertionError(f"47.2 body {i}: {answer} vs the CPU "
                                     f"copy {want[i]}")
        stats = every_worker(port, "/stats.json", "worker")
        lane = lane_of(stats, "the evloop pool", tag="47.2")
        families = [samples(get_text(port, "/metrics")[1], fam)
                    for fam in ("pio_tpu_http_connections_active",
                                "pio_tpu_http_pipelined_total")]
        lat = latency(records, wall)
        t39 = pool39["latency"]
        log(f"  47.2 the evloop pool up in {up_s:.1f} s (host clock); "
            f"{lat['n']} answers (JSON and packed int8) equal the CPU copy; "
            f"p50 {lat['p50_ms']:.3f} ms, p99 {lat['p99_ms']:.3f} ms, "
            f"{lat['qps']:.0f} queries/s; phase 39's threaded pool p50 "
            f"{t39['p50_ms']:.3f} ms, p99 {t39['p99_ms']:.3f} ms, "
            f"{t39['qps']:.0f} queries/s; /metrics {families}; {smi}")
        bad = lane_faults(lane)
        if bad or lane["drained"] <= 0 or not all(families):
            raise AssertionError(f"47.2: {bad}, drained {lane['drained']}, "
                                 f"evloop families {families}")
        code = send(port, "POST", "/undeploy", {})[0]
        rc = proc.wait(timeout=60)
        if code != 200 or rc != 0:
            raise AssertionError(f"47.2 /undeploy {code}, the pool exited "
                                 f"{rc}")
    return {"latency": lat, "lane": lane}


def p47_tls(smi, gpu, bodies, plain) -> dict:
    """47.3: TLS on the threaded front, from a certificate minted by the
    openssl binary."""
    home = fresh_home("tls")
    cert, key = os.path.join(home, "cert.pem"), os.path.join(home, "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", key, "-out", cert, "-days", "1",
                    "-subj", "/CN=localhost"], capture_output=True,
                   check=True, timeout=120)
    engine = get_engine_factory("templates.textclassification")()
    ep = EngineParams(algorithm_params_list=(("mlp", MLPParams()),))
    client_ctx = ssl.create_default_context()
    client_ctx.check_hostname = False
    client_ctx.verify_mode = ssl.CERT_NONE
    out = {}
    with knob("PIO_TPU_SSL_CERTFILE", cert), knob("PIO_TPU_SSL_KEYFILE", key):
        for asked in P47_FRONTS:
            with knob("PIO_TPU_HTTP_FRONT", asked):
                server = create_query_server(engine, ep, [gpu],
                                             host="127.0.0.1", port=0,
                                             device=CARD)
            if server.front != "threaded" or not server.tls:
                raise AssertionError(f"47.3: {asked} with TLS gave the "
                                     f"{server.front} front, tls "
                                     f"{server.tls}")
            with server:
                conn = http.client.HTTPSConnection(
                    "127.0.0.1", server.port, timeout=60, context=client_ctx)
                got = [post(conn, json.dumps(b).encode())[1] for b in bodies]
                conn.close()
                with socket.create_connection(("127.0.0.1", server.port),
                                              timeout=30) as s:
                    s.sendall(b"GET / HTTP/1.1\r\nHost: c\r\n\r\n")
                    try:
                        refused = s.recv(64)
                    except (ConnectionResetError, socket.timeout):
                        refused = b""
            if got != plain:
                raise AssertionError(f"47.3 {asked}: HTTPS answers {got} "
                                     f"are not the plain answers {plain}")
            if refused.startswith(b"HTTP/1.1 200"):
                raise AssertionError("47.3: a plain-text client was answered")
            out[asked] = got
            log(f"  47.3 PIO_TPU_HTTP_FRONT={asked} with TLS: served on the "
                f"threaded front over HTTPS, {len(got)} answers the plain "
                f"HTTP bits; a plain-text client got {refused[:16]!r}")
    return out


def phase_fronts(args, smi, gpu, queries, http_answers, reloaded,
                 pool39) -> dict:
    """Phase 47: the HTTP fronts and TLS."""
    t_phase = time.monotonic()
    log(f"phase 47: the HTTP fronts: phase 4's model on the threaded and "
        f"the evloop front from 1 and {N_CLIENTS} clients and a pipelined "
        f"burst of {P47_BURST}, phase 39's pool of {POOL_WORKERS} on the "
        f"evloop front, TLS on the threaded front; {smi}")
    bodies = [{"text": t} for t in queries[:N_HTTP]]
    reset_counts()
    walls = {}
    t = time.monotonic()
    fronts = p47_fronts(smi, gpu, bodies, http_answers)
    walls["47.1"] = time.monotonic() - t
    t = time.monotonic()
    pooled = p47_pool(smi, args, reloaded, pool39)
    walls["47.2"] = time.monotonic() - t
    t = time.monotonic()
    plain = fronts[("threaded", "plain")]
    if fronts[("evloop", "plain")] != plain:
        raise AssertionError("47.1: the fronts' answers differ in their bits")
    p47_tls(smi, gpu, bodies, plain)
    walls["47.3"] = time.monotonic() - t
    launches = read_counts()
    stats_launches = fronts[("evloop", "stats")]["kernelLaunches"]
    log(f"  47 forward launches {launches['embedding_bag']} (the evloop "
        f"server's /stats.json kernelLaunches after 47.1's fronts: "
        f"{stats_launches['embedding_bag']})")
    if stats_launches["embedding_bag"] <= 0:
        raise AssertionError("47: the fronts launched no forward kernel")
    log(f"  phase 47 launches (added to the kernels' line): "
        f"{json.dumps(launches)}; walls "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}; "
        f"phase 47 {time.monotonic() - t_phase:.1f} s")
    return {"launches": launches, "fronts": {
        f"{k[0]}/{k[1]}": v for k, v in fronts.items()
        if isinstance(k[1], int)}, "pool": pooled}


def kernel_entry(name, source, replaces, launches, row) -> dict:
    """One kernel of the JSON line, from its main timed row."""
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["kernel_ms"], "kernel_ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
    }


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.mesh_rank:
        return rank_main(args.mesh_rank, args.mesh_out)
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on; the port computes in f32")

    log("phase 2: build the kernels with nvcc, and the host libraries of "
        "the recommendation path with g++, at once")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t0 = time.monotonic()
        host_libs = pool.submit(lambda: (
            native.als_pack_lib(), native.topn_host_lib(),
            native.event_log_lib(), time.monotonic() - t0))
        built = _build.build_all()
        host_s = host_libs.result()[-1]
    for name, b in built.items():
        log(f"  {name}: {b.path.name} built in {b.seconds:.1f} s")
        for line in b.log.splitlines():
            log(f"    {line}")
    log(f"  native host libraries (als_pack, topn_host, event_log) ready in "
        f"{host_s:.1f} s")

    use_memory_storage()
    # the runs' ledgers (and any default $PIO_TPU_HOME path) stay under
    # the script's own home
    os.environ["PIO_TPU_HOME"] = fresh_home("script")
    for name in MESH_ENV:  # this process is no rank until phase 41
        os.environ.pop(name, None)
    rng = np.random.default_rng(args.seed)
    shapes = phase_kernels(rng, dev)
    gpu, cpu, queries = phase_model(args)
    http_launches, http_answers = phase_http(gpu, cpu, queries)
    batch_launches, qs = phase_batch(gpu, cpu, queries)
    log(f"phase 7: kernel launches on the served path: {http_launches} "
        f"(HTTP) + {batch_launches} (batch + loop)")

    log("timing on the served path's own bags")
    w_in = gpu.mlp.w_in
    ids, w = _stack_bags(gpu, qs)
    shapes.append(check_kernel("served batch (TF-IDF bags)", w_in, ids, w,
                               TOL[torch.float32]))
    shapes.append(check_kernel("served query (TF-IDF bag)", w_in, ids[:1].copy(),
                               w[:1].copy(), TOL[torch.float32]))

    backward = phase_backward(rng, dev)
    engine, ep, iid, pd, loss0, train_launches, _, main_bags, main_dot = \
        phase_train(args, dev)
    backward["scatter"].append(main_bags)
    backward["dot"].append(main_dot)
    trained_launches = phase_serve_trained(args, engine, ep, iid, pd, loss0)
    autograd = backward["autograd"]
    log(f"main-path launches: serving {http_launches} + {batch_launches}, "
        f"training {train_launches}, trained serving {trained_launches}, "
        f"autograd {autograd}")

    main_row = shapes[0]
    summary = [
        {**kernel_entry(
            "embedding_bag", "pio_tpu_torch/ops/csrc/embedding_bag.cu",
            "pio_tpu/ops/embedding.py:132",
            http_launches + batch_launches + train_launches["embedding_bag"]
            + trained_launches + autograd["embedding_bag"], main_row),
         "shapes": shapes},
        {**kernel_entry(
            "embedding_bag_backward_table",
            "pio_tpu_torch/ops/csrc/embedding_bag_bwd.cu",
            "pio_tpu/ops/embedding.py:277",
            train_launches["embedding_bag_backward_table"]
            + autograd["embedding_bag_backward_table"], backward["scatter"][0]),
         "shapes": backward["scatter"]},
        {**kernel_entry(
            "embedding_bag_backward_weights",
            "pio_tpu_torch/ops/csrc/embedding_bag_bwd.cu",
            "pio_tpu/ops/embedding.py:284",
            autograd["embedding_bag_backward_weights"], backward["dot"][0]),
         "shapes": backward["dot"]},
    ]

    # the recommendation path: no hand-written kernel, its device programs
    # are PyTorch ops (one JSON line of them before the kernels' line)
    full = phase_als_full(args, smi)
    phase_als_card_vs_cpu(args, smi, full["rows"])
    rec = phase_rec_template(args, smi)
    phase_scorer_full(full["factors"], smi, full["rows"])
    phase_als_route(args, smi, full)
    phase_host_scorer(full["factors"], smi)
    phase_evaluation(args, smi)
    phase_implicit_als(args, smi)
    sp = phase_sp_template(args, smi)
    phase_ecomm_template(args, smi, sp)
    phase_sp_evaluation(args, smi)
    text_eval = phase_text_evaluation(args, smi)["launches"]
    # the classification path: no hand-written kernel either; its device
    # programs join the programs' line
    lr = phase_logreg(args, smi)
    full["rows"] += lr["rows"]
    full["rows"] += phase_nb_dense(args, smi, lr)
    full["rows"] += phase_resident_scorer(args, smi, lr)
    phase_cls_template(args, smi)
    full["rows"] += phase_markov(args, smi)
    # the port's CLI: the quickstart as processes, then text classification
    # in this process, its kernels' launches joining the kernels' line
    phase_cli_quickstart(args, smi)
    text = phase_cli_text(args, smi)
    cli_text = text["launches"]
    for entry in summary:
        entry["launches"] += text_eval[entry["name"]] + cli_text[entry["name"]]
    # the neural templates: no hand-written kernel either; their device
    # programs join the programs' line
    tt = phase_twotower_full(args, smi)
    full["rows"] += tt["rows"]
    phase_twotower_card_vs_cpu(args, smi)
    phase_twotower_template(args, smi)
    seq = phase_seqrec_full(args, smi)
    full["rows"] += seq["rows"]
    phase_sequence_template(args, smi)
    phase_checkpoints(args, smi, tt, seq)
    # serving under concurrency: phase 4's model micro-batched (its
    # launches join the kernels' line, its buckets' times the forward's
    # shapes), then the recommendation path, /reload and the pool
    mb_text = phase_text_microbatch(args, smi, gpu, cpu, queries)
    for entry in summary:
        entry["launches"] += mb_text["launches"][entry["name"]]
    summary[0]["shapes"] += mb_text["rows"]
    phase_rec_microbatch(args, smi, full["factors"])
    reloaded = phase_reload_under_load(args, smi)
    pool39 = phase_pool(args, smi, reloaded)
    # the device ops plane on phase 29's engine and phase 38's store; its
    # launches join the kernels' line
    ops = phase_ops_plane(args, smi, text, reloaded)
    for entry in summary:
        entry["launches"] += ops["launches"][entry["name"]]
    # the multi-device paths on the one card: phase 11's factors and
    # phase 9's text instance are their single-device baselines; the
    # data-parallel train_mlp's launches join the kernels' line
    mesh = phase_mesh(args, smi, full["factors"], text_inputs(
        args, engine, ep, iid, ComputeContext.local(args.seed, device=CARD)))
    for entry in summary:
        entry["launches"] += mesh["launches"][entry["name"]]
    # the neural templates over a mesh: phase 30's tables and phase 33's
    # parameters are their single-device baselines
    phase_neural_mesh(args, smi, tt["model"], seq["model"])
    # the streamed feed, the resident scorer's mesh and the failpoints:
    # phase 30's tables and phase 36's solo p50 are their baselines; the
    # drill's serving launches join the kernels' line
    p43 = phase_stream_mesh_faults(args, smi, tt["model"], gpu, queries,
                                   mb_text["runs"][("off", 1)]["p50_ms"])
    for entry in summary:
        entry["launches"] += p43["launches"][entry["name"]]
    # the event and model stores feeding training on the card: no
    # hand-written kernel on this path
    stores = phase_event_stores(args, smi)
    # the request plane of both servers on phase 4's model: its served
    # launches join the kernels' line
    p45 = phase_request_plane(args, smi, gpu, queries, http_answers,
                              mb_text["runs"][("off", 1)]["p50_ms"],
                              stores["ingest"]["sqlite"]["events_per_s"])
    for entry in summary:
        entry["launches"] += p45["launches"][entry["name"]]
    # the pool plane and the router over phase 29's text engine (and phase
    # 40.1's second instance of it): the servers' forward launches, read
    # from their /stats.json, join the kernels' line
    p46 = phase_pool_plane(args, smi, text)
    for entry in summary:
        entry["launches"] += p46["launches"][entry["name"]]
    # the HTTP fronts and TLS over phase 4's model and phase 39's pool:
    # their forward launches join the kernels' line
    p47 = phase_fronts(args, smi, gpu, queries, http_answers, reloaded,
                       pool39)
    for entry in summary:
        entry["launches"] += p47["launches"][entry["name"]]
    log(f"text evaluation sweep launches (added to the kernels' line): "
        f"{json.dumps(text_eval)}")
    log(f"CLI train + deploy launches (added to the kernels' line): "
        f"{json.dumps(cli_text)}")
    log(f"recommendation path launches: run_train {rec['train_launches']}, "
        f"HTTP {rec['http_launches']} (routed by batch size "
        f"{rec['routed_launches']}), batch_predict {rec['batch_launches']}")
    log(f"guarded profiler windows: {len(WINDOW_SENTINELS)}, sentinels "
        f"recorded {min(WINDOW_SENTINELS)}-{max(WINDOW_SENTINELS)} of "
        f"{2 * window.SENTINELS} each (a window lost records at an end "
        f"where fewer than {2 * window.SENTINELS})")
    print(json.dumps({"phase_walls_s": phase_walls(), "device": smi}))
    print(json.dumps({"programs": full["rows"], "device": smi}))
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
