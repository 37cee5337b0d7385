#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dynamo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # one CUDA card; nvcc on PATH or in $CUDA_HOME/bin
    python3 chip_smoke.py --mesh-cards    # every card of the machine, a rank each (NCCL)

Phases, in order; any failure ends the run with a non-zero exit:

1. the card's name and power limit, from nvidia-smi;
2. build: every ``dynamo_tpu_torch/csrc/*.cu`` compiled with nvcc for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch version on the card.
   The attention kernels run at Llama-3-8B attention geometry (H=32, Hk=8,
   D=128, L=32, layer index 5) and at D = 64 and 256, over a bf16 cache
   (Bs=16) with NaN in every dead slot and padding K/V, and over an int8
   cache (Bs=16 and 32) with random codes in every dead slot and NaN in
   every dead slot's scale and every pad lane of the scale tiles.  The
   ragged kernels also run at their block edges (G = 1, 4 and 8 at D =
   64, 128 and 256; spans cut by and ending on span-block boundaries; a
   full 16-row decode region with contexts 1 to 2047; starts inside a
   64-key tile; softcap on and off; bf16, and int8 at Bs = 16 and 32), and
   every ragged launch is run twice and must give the same bits.  The
   decode kernel over both caches and the int8 prefill kernel also run at
   their edges (G = 1, 4 and 8 at D = 64, 128 and 256, Bs = 16 and 32;
   decode at S = 1 and 8 with contexts 0 to 2048 either side of its chunks
   and tiles; prefill from a start inside a key tile), and every decode
   launch is run twice and must give the same bits; the decode kernel over
   both caches also at the speculative verify's S = 5 and 8, with every
   query live and with rows of fewer live queries than S.  The
   W8A16 matmul runs at every projection shape of Llama-3-8B and its
   lm_head (f32 out), at M = 1 to 1504 across both regimes' edges, for a
   [K, N] weight and for the transpose of an [N, K] one, then at ragged
   shapes (N = 32002 or 1000, K = 4104) and at Qwen3-30B-A3B's attention
   projections and lm_head (K = 2048 to N = 4096, 512 and 151,936; 4096 to
   2048), and a split-K launch is run twice and must give the same bits.
   The grouped expert matmul (E1 over bf16 experts, E2 over int8 ones) runs
   at Qwen3-30B-A3B's expert shapes (128 experts, top 8, [2048, 768] and
   [768, 2048]) for 1, 8, 1,504 and 3,765 tokens and at one Mixtral-8x7B
   layer's stack (8 experts, top 2, [4096, 14336] and [14336, 4096]) for 8
   and 1,504 tokens, with uniform routing and with every row on one expert,
   and at shapes off its tiles (K = 144, N = 200 and 208), each launch
   twice for the same bits; the MoE MLP as a whole (router,
   sort, grouped launches, combine) is held to the dense oracle.  Then
   decode, prefill, the matmul and one MoE layer's three grouped launches
   (T = 8 and 1,504) are timed at the serving paths' shapes (decode, the
   matmul and the grouped launches as CUDA graphs, the card's time, and
   eagerly for the log; a graph replay of
   each decode kernel must give the eager launch's bits) beside their plain
   versions, a PyTorch library call on the same work (the median of three
   readings; every SDPA yardstick as a CUDA graph, the card's time, and
   eagerly for the log; for the grouped launches ``torch._grouped_mm`` and
   a per-expert cuBLAS loop, both as CUDA graphs), and their bound on this
   card (every bound the kernel registry's work cost at its geometry,
   ``ops/kernels/registry.py``); the decode kernel over both caches also
   at the verify's S = 5 and 8 and the matmul at its M = 40.  Before the
   timings, the ``kern`` phase: each of the nine kernels at every run case
   of the registry's audit matrix (the matrix ``lint --kern`` audits on the
   CPU: JAX's adversarial rows at D = 64, the verify's S = 5 and 8, the
   int8 prefix hit, the grouped launches at T = 8 and 1,504), inputs from
   the cases' numpy seeds, NaN-poisoned as the kernel plane poisons them,
   held to the plain version on the same inputs: 0 leaks, every padding and
   zero-length lane exactly 0 (one ``{"kern": ...}`` line);
4. serving: Llama-3-8B at full width and depth (random weights from a
   seeded generator) behind ``AsyncLLMEngine``, six concurrent greedy
   requests (17 to 1500 prompt tokens, two sharing a 256-token prefix),
   twice on the bf16 model: the default path (one-request prefill, decode
   bursts), then the token-budget path (``prefill_token_budget=1024``,
   unified mixed dispatch, lookahead bursts); each default-path run prints
   one ``{"timeline": ...}`` line: its engine's step timeline over the
   run (the phases' ms a busy step, each dispatch kind's count and ms
   beside the perf model's prediction, and the host gap, wall - dispatch -
   overlap - readback, beside the earlier definition, wall - the blocking
   result reads); the bf16 default path's profiled run also marks each
   forward on the stream and prints one ``{"perf": ...}`` line: the perf
   plane's predicted ms of ``models.llama.forward[llama3-8b-h100]`` (decode
   [8, 1], prefill [1, 1504], from ``analysis/perf_manifest.json``) beside
   the profiled device ms of the run's forwards of those shapes; then the
   bf16 model is freed
   and the same two runs are made on an int8 model at 8 layers (int8 weights drawn
   directly, ``cache_dtype="int8"``, ``block_size=32`` as ``bench.py``
   serves on an accelerator).  Every kernel's launch counter is zeroed just
   before each run and read just after; the ragged kernels are then timed
   at the largest mixed dispatch of each token-budget run, with its decode
   rows and without them.  The fault plane runs on the 32-layer model too;
   the planes that follow on bf16 (HTTP, grammar, speculation,
   disaggregation, the KV tiers and the router) run on the same widths at
   8 layers (``BF16_PLANE_LAYERS``), read against a default-path run of
   that model.  It serves
   the six prompts as token-id completions through the port's HTTP service
   (concurrent, streamed): TTFT at the client beside the direct run's; and
   it runs the ``grammar`` phase: a 128,256-token vocabulary of bytes from
   a seed (ids 3-258 the single bytes, the rest printable strings of 2 to
   8 bytes) and its JSON tables; ``grammar_mask`` / ``grammar_advance`` on
   the card equal to the CPU's at reachable states of a JSON + choice +
   regex composite, the seeded noise bit-equal; their times at B = 8
   beside their bound; then the six prompts as a constrained mix (two
   greedy JSON-mode rows, a seeded JSON-mode row at temperature 1, a
   seeded free row, a guided choice and a guided regex) on the default
   path (B1, B2) and on the token-budget path (B3, B1), each row held to
   its grammar, and the seeded rows again with one decode turn a dispatch
   and other companions for the same streams.  Last on the bf16 model, the
   ``spec`` phase: speculative decoding on the copy task (each prompt a
   seeded 32-token segment repeated to its length, 64 tokens each, five
   greedy rows and one seeded at temperature 0.9, top_p 0.9) with
   speculation off, n-gram lookup at k = 4 and 7 and a Llama-3.2-1B-width
   draft (random weights from a seed), k = 4 (the model as its own draft
   is no longer run, to keep the script inside its time limit); and on the
   int8 model off and n-gram at k = 4.  Each run: every request 64 tokens
   at ``length``, the decode kernel launched at S = k + 1 (B1, or B4a on
   int8), no plain-op attention call but the draft's ingest, and every stream that parts
   from speculation off's parting at a near-tie (the common prefix
   re-scored on the card; ``SPEC_TIE_EPS``).  It prints each run's
   readings and one ``{"spec": [...]}`` line at the end.  Then the
   ``disagg`` phase on each model: disaggregated prefill/decode as
   ``examples/llm/components/colocated_worker.py`` serves it, a
   ``CoordinatorServer`` in this process, a decode engine behind a
   ``DecodeWorker`` that sends every prompt to the prefill queue
   (``max_local_prefill_length=0``) and a prefill engine behind a
   ``PrefillWorker``, both on the default path and sharing the model.  On
   bf16: the colocated path (blocks copied on the card), the six prompts
   one at a time (a1; the concurrent colocated run is left out to keep the
   script inside its time), and concurrently through the streamed
   layer-wise handoff over TCP (c: ``DYN_KV_TRANSFER_FORCE_TCP=1``, a
   prefill engine in 256-token chunks); on int8 (weights and cache,
   Bs = 32): over TCP, one at a time (d1), and concurrently streamed as c
   (d).  The blocking bf16 handoff over TCP and
   HTTP through a decode worker are the front-door phase's ``graphs`` run,
   where the prefill worker is a process of its own.
   Each run on a fresh engine pair: its blocks moved only on its path
   (``transfer.stats``), (c) and (d) sent
   layers without a fallback, the int8 runs' parts int8 + float32, the decode
   engine made no prefill dispatch and the prefill engine no decode turn,
   the launches are its model's default-path kernels and no other, every
   handoff's blocks equal the prefill engine's held blocks bit for bit, no
   block stays held, streams served one at a time equal a local engine's
   one at a time, and concurrent ones part from the default path's run
   only at near-ties.  One ``{"disagg": ...}`` line gives each run's TTFT
   and decode tok/s beside the local engine's (one at a time, or the
   default path's concurrent run), the blocks and bytes moved,
   the handoff time from queue push to notify, MB/s per path, and beside
   them a device-to-device and a pinned device-to-host copy of one
   handoff's mean bytes (each path's bound) and the block gather + scatter
   of those bytes.  Last on each model, the ``tier`` phase: the multi-tier
   KV cache with a device pool too small for the traffic (192 blocks of
   16 tokens on bf16, 96 of 32 on int8) over a host pool of 1,024 blocks
   (512 on int8; pinned) and a shared prefix P of 1,024 tokens.  On bf16:
   (h1) P + a 256-token suffix cold, (h2) P + another suffix, a device
   hit, (h3) P's blocks kept as the reference, then three distinct
   1,500-token prompts that push P off the device and a flush of the
   offload queue, (h4) P + a third suffix, restored from the host: P off
   the device after the churn, at least its 64 blocks stored and then
   restored, cached tokens >= 1,024, the restored blocks P's bits, and the
   stream that of P + the third suffix on a second engine with no host tier
   and P warm on its device; (h5) h1, h2 and h4 on three fresh prefixes;
   (p) an engine with a persist directory (the git-ignored ``_kvpersist/``)
   serves P and the churn and is closed, and a new engine over the
   directory restores P from disk (>= 64 persist hits) with h4's stream;
   (r) two engines on the model, each behind the worker wiring
   (``cli.attach_worker_publishers``: event and metrics publishers on a
   coordinator), a ``KvRouter`` and its subscriber: three requests over a
   1,024-token prefix A and three over B in turn, each later one routed to
   the engine that served its prefix first (overlap >= 64 blocks, cached >=
   1,024), and after the flush the index holds each engine's registered
   blocks.  On int8 (q): h1, h3 and h4, with the data and scale blocks
   bit-equal and the second engine's stream.  One ``{"tier": ...}`` line
   gives TTFT cold, device hit, host and persist restore, the blocks and
   bytes offloaded and restored, the copies' GB/s (offload timed on the
   offload thread, by CUDA events on its stream) beside a pinned
   device-to-host and host-to-device copy of P's bytes, persist spill and
   load MB/s and the host gap per turn of h2 and h4; one ``{"router":
   ...}`` line the decisions, overlaps and the time of one decision.
   The sharded router (s), its launches counted from 0: two engines on
   the model with (r)'s wiring, registered as ``run in=dyn://`` workers
   register, a singleton
   router and a scatter-gather scheduler over three ``ShardReplica``s of
   8 shards; (r)'s requests served where the sharded scheduler says, each
   gathered overlap equal to the singleton's and each later request
   hitting its prefix (B2 at the suffix's S); a fourth replica joins (one
   generation everywhere, the moved shards' handoff frames, a warm gather)
   and one dies (the next decision within the gather deadline, counted
   partial, scores never rising); then a ``PlannerLoop`` and a
   ``MetricsService`` over a burst of six requests (the idle snapshot the
   engines' last published metrics, every plan the policy's, ``/metrics``
   listing both workers).  One ``{"shards": ...}`` and one
   ``{"planner": ...}`` line.
   Between the ``disagg`` and ``tier`` phases on the bf16 model, the
   ``fault`` phase: two workers of this process, each its own engine on
   the model (default path), at ``dyn://dynamo.backend.generate`` behind a
   coordinator, and an ``HttpService`` over a ``MigratingClient`` with an
   ``AdmissionController`` and (from (c) on) a ``HealthMonitor``: (a) the
   1,500-token prompt streamed, 32 tokens, its worker's transport cut as
   its 8th item frame goes out (``FaultInjector.sever_after``): the stream
   ends with 32 tokens and ``: x-migrated 1``, one migration, the
   survivor's one prefill of the prompt plus the 7 tokens delivered, its
   launches B1 and B2 only, the cut engine holding no block, the tokens
   equal to a fresh engine's unbroken stream or parting at a near tie;
   (b) the same cut with ``x-migration-limit: 0`` ends in an error,
   unmigrated; (d) six requests of one tenant against a bucket of two: four
   429s with ``Retry-After``, counted in the shed family, two answered;
   (c) one worker's request plane killed: suspect within the monitor's
   fail_threshold x interval_s (plus a probe timeout), the suspect gauge
   1 on ``/metrics``, the next three requests on the survivor alone, then
   the survivor drained with two streams live, both finished (one
   ``{"fault": ...}`` line, logged at the end: the migration's gap between
   the cut worker's last token and the survivor's first, the tokens
   re-prefilled, the survivor's launches, seconds to suspect, the 429s);
   before it, the ``{"trace": ...}`` line: the compile plane's predicted
   footprint of the 32-layer bf16 default run's EngineConfig (params, KV
   pool and the meta walk's peak of live temporaries, ``analysis/
   tracecheck.py::footprint``, walked in a subprocess started with the
   lints) beside that run's ``torch.cuda.max_memory_allocated()`` (its
   peak reset before the engine was built), and the dispatch signatures
   the run made, every one of which must be in the config's declared
   matrix; then the ``load`` phase, on the host and from runs already taken: the
   load plane's serving figures read off the bf16 default-path run (its
   timeline's ``step`` seconds over the fresh prompt tokens it prefilled,
   its ``decode_multi`` seconds over the row-steps decoded, its engine's
   ``kv_bytes_per_block()``) and the router run (one decision), one
   ``{"load": ...}`` line with them beside the committed
   ``load/card_latency.json`` figures, their ratios and each capacity
   cell's knee swept at the measured figures beside the committed
   ``analysis/load_manifest.json``'s; and ``python -m dynamo_tpu_torch
   lint --load``, ``--project``, ``--wire``, ``--metrics``, ``--kern``,
   ``--perf``, ``--trace`` and ``--shard``, subprocesses started while the
   kernels build, each of which must have exited 0 (the committed surfaces,
   baseline and manifests reproduce here);
5. parity: 2-layer models at full 8B width on the card (kernels, bf16) and
   on the CPU (plain PyTorch, f32), bf16 weights with a bf16 cache and int8
   weights with an int8 cache: one 300-token prompt over a 128-token cached
   prefix then 8 decode steps, and one packed prefill then one mixed
   ragged dispatch (two decode rows, two spans); on bf16 also one
   speculative verify dispatch at S = 5 over three prefixes (5, 3 and 1
   live queries); logits held to a stated tolerance;
6. front door: a 2-layer HF checkpoint at Llama-3-8B width (random bf16
   weights from a seeded generator, two safetensors shards and an index, a
   word-level tokenizer of 128,256 ids and a chat template), written into
   the git-ignored ``_frontdoor/`` beside this script and removed at the
   end.  ``python3 -m dynamo_tpu_torch run in=http out=gpu`` serves it as a
   subprocess: unary, streamed, chat (through the template), n = 2,
   logprobs, stop-string and unknown-model requests, ``/metrics``, a clean
   exit on SIGTERM.  Then ``build_local_engine`` loads it in this process,
   bf16 on the default path and int8 (weights and cache, Bs = 32) on the
   token-budget path, each behind the port's ``HttpService``: the loaded
   tensors against the shards, and each answer, one request at a time,
   against a fresh engine's greedy tokens; the bf16 server must launch the
   decode and prefill kernels, the int8 one the int8 decode, int8 ragged and
   W8A16 kernels.  With a byte-level tokenizer beside the same weights the
   CLI also answers a ``json_schema`` chat (JSON of the schema's shape, or
   cut inside it at max_tokens), a ``guided_regex`` completion (replayed
   through its tables) and one seeded completion twice (the same text).
   Then ``run --trace --profile-dir D --profile-steps 4``'s engine behind
   ``HttpService`` answers one traced completion: the profile window's
   Chrome trace must hold B1's and B2's kernels, and ``/debug/traces/{id}``
   fetched by the ``trace`` command must be one trace id with
   ``engine.step`` spans and their phases (one ``{"profile": ...}`` line).
   Last, the distributed runtime: a coordinator on port 0 in this
   process, ``run in=dyn://dynamo.backend.generate out=gpu`` on the
   checkpoint as a process of its own, ``models add`` and the ``http``
   frontend, which discovers the model; the bf16 requests one at a time
   over HTTP must equal the fresh engine's greedy texts, the worker must
   have loaded on CUDA, and every process exits 0 on SIGTERM (one
   ``{"dyn": ...}`` line: remote seconds to the first text beside the
   in-process server's).  Then the ``graphs`` phase: the port's
   ``examples/llm/configs/disagg.yaml`` on the checkpoint (int8 weights, a
   cache in the model's dtype) with a local-prefill threshold that sends
   some prompts to the prefill worker and keeps the rest, served by
   ``DYNTPU_GPUS=0,0 python3 -m dynamo_tpu_torch serve
   dynamo_tpu_torch.examples.llm.graphs.disagg:Frontend`` against a
   coordinator in this process: four processes (Frontend, Processor, a
   GpuWorker with remote prefill, a PrefillWorker), the two workers sharing
   the card.  A warm-up pass of other words, the front-door requests and
   six token-id prompts one at a time, then six others concurrently; the
   one-at-a-time texts must equal an in-process engine's, built by the
   worker's own ``build_engine`` from the same block and decoded as the
   Processor decodes each delta, whose launches must be B1, B2 and B5 and
   no other kernel, and the concurrent answers that engine's one at a time
   but at a near tie; each worker process's ``status`` (read through a
   ``ServiceClient``) must count its own launches over those requests, B1,
   B2 and B5 in the GpuWorker, B2 and B5 in the PrefillWorker and no other
   kernel, and the PrefillWorker's must count the prompts above the
   threshold; both workers' logs must name a CUDA device; and on SIGTERM
   every process drains and exits 0 (one ``{"graphs": ...}`` line, logged
   at the end: boot seconds, remote and local seconds to the first text,
   one at a time and concurrent, the remote prefills, each worker's
   launches, exit codes).  Last, the ``formats`` phase, in process, into
   the git-ignored ``_formats/``: ``quantize`` writes the checkpoint as a
   native int8 checkpoint, whose tensors must equal ``--quantize int8``'s
   load of the directory bit for bit and whose greedy request must equal
   that load's (B5 launched; its load time beside the HF load plus
   quantisation); the same weights as a Q8_0 GGUF file with its vocabulary
   (packed on the card, checked against ``llm/gguf.py``'s writer), served
   through the checkpoint dispatch (B1 and B2, no B5), its card logits
   held to the CPU's as in phase 5; ``models push`` of the directory to a
   coordinator on a thread of this process, ``dyn://models/front`` pulled
   into a fresh cache (each file's sha256 equal to the source's, the
   pull's MB/s) and served through ``--model-path dyn://models/front`` as
   the directory serves (one ``{"formats": ...}`` line, logged at the
   end);
7. mixture of experts, serving: Qwen3-30B-A3B at full width, cut to 8 of
   its 48 layers (128 experts, random weights from a seeded generator) behind
   ``AsyncLLMEngine``, the six requests on bf16 weights and the default
   path (decode, prefill and E1 kernels), then on int8 weights and an int8
   cache (Bs = 32) on the token-budget path (int8 decode, int8 ragged,
   W8A16 and E2 kernels), each run profiled;
8. mixture of experts, parity: phase 5's four logit checks on a 2-layer
   model at Qwen3-30B-A3B width;
9. mixture of experts, front door: a 2-layer Qwen3-MoE checkpoint at
   Qwen3-30B-A3B width under the real checkpoint's tensor names (3.7 GB,
   384 expert tensors a layer) with a word-level tokenizer of 151,936 ids,
   served by the CLI (bf16, then ``--quantize int8``) and by
   ``build_local_engine`` as in phase 6 (bf16 default path: decode, prefill
   and E1; int8 token-budget path: int8 decode, int8 ragged, W8A16 and E2),
   the loaded tensors held to the shards and the answers to a fresh
   engine's;
10. DeepSeek-V2, serving: DeepSeek-V2-Lite at full width, cut to 8 of its 27
   layers (MLA with the absorbed latent cache, 64 routed experts top 6 and
   2 shared, random weights from a seeded generator; its YaRN
   ``rope_scaling`` dropped, as neither package implements it) behind
   ``AsyncLLMEngine``, the six requests on the default path with a bf16
   cache (profiled) and with an int8 cache (Bs = 32): E1 and no other
   kernel (MLA attention is the plain op, as in the JAX package);
11. DeepSeek-V2, parity: phase 5's default-path check (bf16 and int8
   cache) on a 2-layer model at DeepSeek-V2-Lite width (the dense layer and
   one MoE layer) and on one DeepSeek-V2 MoE layer (q-LoRA 1,536, 128
   heads, 160 experts, group-limited routing 8 / 3, routed scaling 16);
12. DeepSeek-V2, front door: a 2-layer checkpoint at DeepSeek-V2-Lite's
   width and tensor names (2.2 GB, 216 tensors) with a word-level tokenizer
   of 102,400 ids, served by the CLI and by ``build_local_engine`` with a
   bf16 and with an int8 cache (E1); ``--quantize int8`` refused with the
   JAX CLI's message;
13. mesh (more than one device): every kernel of the path against its
   plain version at the shapes one rank of a tp = 2 mesh gives it
   (attention at Hq 16 over Hk 4 and 2, B5 at the split matmuls and an
   lm_head of 64,128 columns, E1/E2 at F = 384 and E1 at 704) and their
   times; then ONE two-rank world on the card (this process rank 0, a
   shard follower process rank 1, gloo: NCCL refuses two ranks on one
   card): Llama-3-8B bf16 at full width and 8 layers (first-token logits
   against the one-card forward within the parity bounds, six requests'
   greedy streams held to the one-card engine's but at near ties, a decode
   turn's seconds and collective wait at tp = 1 and 2), int8 weights and
   cache at 8 layers on the default path and at 2 on the token-budget path
   (B4c on a rank's scale tiles, lookahead bursts on), Qwen3-30B-A3B width
   at 4 layers, DeepSeek-V2-Lite width at 4 layers, the options a mesh serves beyond the dispatches at Llama-3-8B
   width and 2 layers (n-gram speculation at k = 4, lookahead
   bursts on the token-budget path, and the KV tiers over a 128-block pool
   restoring a 640-token prompt from the host and, after a restart, from
   the persist directory; each tp = 2 stream held to one card's but at a
   near tie; B3, B4a, B4b and B4c also timed at one rank's shapes, and a
   float16 KV cache refused on the card by name), and on the mesh (2, 1)
   the sequence-parallel prefill of a 4,096-token prompt (8 layers; both
   ranks' cached KV equal and held to a one-card prefill's, then 16 decode
   tokens).  Every rank's launches are zeroed before each run and read
   after; rank 1 must launch what rank 0 does.  The bf16 pair's tp = 2 run
   gives the ``{"shard": ...}`` line: each rank's bytes of params and
   cache beside the sharding plane's census at (1, 2)
   (``analysis/shardcheck.py::census_at``, from the same subprocess), and
   rank 0's collectives in each pure decode dispatch, counted on the
   world, beside the census's, per dispatch and per turn; bytes and counts
   must be the census's.  In the front
   door, ``run in=http out=gpu --tp 2`` answers the front-door requests
   over HTTP and stops both ranks on SIGTERM.

The fp16 bodies (each of B1–B5 in float16: q, the fresh K/V, a float
cache, x and out) are checked after the bf16 kernels against their plain
versions on the same NaN-poisoned pools and at the same tolerance
(``fp16_kernel_phase``; the ``kern`` phase's fp16 cases too), timed at the
same serving shapes beside SDPA and cuBLAS in fp16 (``timing_phase``,
``q8_timing_phase``, ``matmul_timing`` and ``ragged_timing`` with ``dtype``
float16), and served after the int8 model (``fp16_serving_phase``): the six
requests on Llama-3-8B in float16 at full width and 32 layers on the
default path, then at 8 layers on the token-budget path and with int8
weights and cache on both paths, every fp16 body launched and no bf16 one;
an fp32 model and an fp16 Qwen3-MoE refused at construction
(``fp16_refusals``); a 2-layer fp16 card-vs-CPU parity; after the front
door ``run --dtype float16``, a native fp16 checkpoint and ``run --dtype
float32`` (which must exit with the refusal) over HTTP
(``fp16_cli_phase``).  One ``{"fp16": ...}`` line holds the fp16 runs'
TTFT, decode tok/s and launches beside the bf16 default run's, and the
``kernels`` line a row for each fp16 body (``*_fp16``, ``dtype`` float16).

The kernel timings also time E1 at one DeepSeek-V2-Lite MoE layer's
launches (64 experts, top 6, [2048, 1408] and [1408, 2048]), and the MLA
latent attention (the plain op) at B1's decode step and B2's prefill,
each beside its bound and SDPA on the same latent K/V.  Phase 4 prints
one ``{"grammar": {...}}`` line (the grammar ops' and the seeded noise's
times, launches and bounds, the table sizes, the constrained serving
readings beside the unconstrained ones).  At the end one ``{"mla": [...]}``
line, the ``{"disagg": ...}`` line, the ``{"tier": ...}``,
``{"router": ...}``, ``{"shards": ...}``, ``{"planner": ...}``,
``{"graphs": ...}``, ``{"fault": ...}``, ``{"formats": ...}`` and
``{"mesh": ...}`` and ``{"mesh_cli": ...}`` lines, one ``{"kernels": [...]}``
line (each
kernel's row also holds its launches over the disaggregated runs under
``launches_disagg``, over the KV-tier runs under ``launches_tier`` (the
sharded router run's alone under ``launches_shards``), in the
``graphs`` phase's two worker processes under ``launches_graphs``, over
the fault phase's migrated request under ``launches_fault`` and over the
formats phase's five requests under ``launches_formats``, each mesh
rank's over the mesh runs under ``launches_mesh_rank0`` and
``launches_mesh_rank1``; the grouped
kernels' rows hold their T = 8 reading and, under ``t1504``, their T =
1,504 one; E1's also its DeepSeek-V2-Lite readings and launches), and as
the last line ``{"ok": true, "device": {...}}``.  Every line it logs is
also written to ``chiprun_out/chip_smoke.log`` beside the script.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import faulthandler
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "dynamo_tpu_torch").is_dir():
    sys.exit("chip_smoke: dynamo_tpu_torch/ is not beside this script")
sys.path.insert(0, str(ROOT))

from dynamo_tpu_torch.tools.cuda_timing import (  # noqa: E402
    DECODE_LENS, LM_HEAD, MOE_EXPERTS, MOE_LAUNCHES, MOE_TOKENS, MOE_TOP_K, PROJECTIONS,
    RAGGED_MIXED, card_line, cuda_time_ms, graph_time_ms, median_ms, moe_offsets, moe_stack,
    ragged_layout)
from dynamo_tpu_torch.ops.kernels import registry as kreg  # noqa: E402

# published peaks of one H100 SXM (dense): HBM bytes/s and f32 FLOP/s
# outside the tensor cores (the grammar ops' bound; every kernel's bound is
# the registry's, ops/kernels/registry.py)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Llama-3-8B attention geometry
H, HK, D, BS, L = 32, 8, 128, 16, 32
LAYER = 5  # a runtime layer index other than 0

# serving traffic: prompt lengths; the last two share a 256-token prefix
PROMPT_LENS = (17, 300, 640, 1500, 356, 956)
SHARED_PREFIX = 256
MAX_TOKENS = 32
# the two serving configurations, on one model
# every thread's stack goes to stderr if the script still runs at this
# second, inside the 1,200 s a run is given
SMOKE_STACK_DUMP_S = 1140
DEFAULT_PATH = dict(max_batch_size=8, max_model_len=2048, block_size=16, decode_steps=8)
BUDGET_PATH = dict(DEFAULT_PATH, prefill_token_budget=1024, unified_token_dispatch=True,
                   lookahead_dispatch=True)
# the same two on the int8 model: int8 KV cache in 32-token blocks
# (bench.py's accelerator defaults)
BS_Q8 = 32
INT8_DEFAULT_PATH = dict(DEFAULT_PATH, block_size=BS_Q8, cache_dtype="int8")
INT8_BUDGET_PATH = dict(BUDGET_PATH, block_size=BS_Q8, cache_dtype="int8")
# the W8A16 checks' row counts: both regimes' edges, decode and prefill
MATMUL_ROWS = (1, 6, 8, 16, 17, 64, 65, 128, 129, 300, 1504)
# [K, N] with rows off 16 bytes in one layout or both (a 32002-token
# vocabulary, a depth of 4104), at row counts of both regimes
RAGGED_MATMULS = ((4096, 32002), (4104, 32002), (4104, 1000))
# Qwen3-30B-A3B's int8 attention projections and lm_head, [K, N]
QWEN3_MOE_MATMULS = {"wq": (2048, 4096), "wk/wv": (2048, 512), "wo": (4096, 2048),
                     "lm_head": (2048, 151936)}
RAGGED_MATMUL_ROWS = (1, 8, 16, 17, 300)

# bf16 tolerance, kernel vs plain version on identical bf16 inputs, per
# element: |out - ref| <= KERNEL_ATOL + KERNEL_RTOL * |ref|.  Both sides
# accumulate in f32 and round the output to bf16 once, and summation-order
# noise can tip that rounding by one bf16 ulp (<= |x| / 128); the prefill
# kernel also rounds the softmax probabilities to bf16 for the tensor-core
# PV product (2**-9 relative per term, <= 0.01 absolute for V rows drawn
# from N(0, 1)).  RTOL allows two ulps, ATOL the probability rounding.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 2.0 ** -6
# The int8 kernels are held to the same form and numbers.  Their inputs
# are int8 codes times f32 scales drawn so the dequantised values are of
# order 1, as the bf16 inputs are: int8 -> bf16 is exact, the scales apply
# in f32, and the one extra rounding (the attention kernels round P times
# the V scale to bf16 for the tensor-core PV product, 2**-9 relative per
# term) is the probability rounding ATOL already allows.  The W8A16 kernel
# accumulates exact bf16 x int8 products in f32 in another order than the
# plain version and rounds once, which RTOL covers.
# 2-layer model, card (bf16 activations) vs CPU (f32), same bf16 weights:
# ~a dozen bf16 roundings of 2**-9 relative each compound to ~1e-2.  With
# int8 weights and an int8 cache the weights are the same codes on both
# sides; the cache quantises bf16 activations on the card and f32 ones on
# the CPU, so some codes differ by one step (1/127 of a row's amax), which
# adds noise of the order of the bf16 roundings: the same bounds hold.
PARITY_REL_L2 = 5e-2
PARITY_MAX_REL = 1e-1
# An MoE router picks experts by comparing logits, so the card (bf16 hidden
# states; Qwen3's logits rounded to bf16, DeepSeek's f32) and the CPU (f32)
# can pick a different expert for a token whose k-th and (k+1)-th logits
# nearly tie (or, under group-limited routing, whose groups' best logits
# do), and then that token's output differs by a whole expert's share, far
# past the bounds above.  The logits are therefore compared with the CPU routed as
# the card routed (its own f32 logits weighting the card's experts); and
# where its own choice differs, the CPU's logits of the card's expert and
# of its own k-th must lie within ROUTE_TIE: about five times the card's
# logit error on unit-variance logits (hidden states ~1% off after a layer,
# plus the bf16 rounding of the logit, 2**-8 relative).
ROUTE_TIE = 0.1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# the whole run's log, beside the script (the console keeps only its end)
LOG_PATH = ROOT / "chiprun_out" / "chip_smoke.log"
_log_file = None
_log_lock = threading.Lock()  # whole lines from the threads of concurrently()


def log(msg: str) -> None:
    global _log_file
    with _log_lock:
        print(msg, flush=True)
        if _log_file is None:
            LOG_PATH.parent.mkdir(exist_ok=True)
            _log_file = open(LOG_PATH, "w")
        _log_file.write(msg + "\n")
        _log_file.flush()


def concurrently(first, *others) -> None:
    """``first()`` on this thread while each of ``others`` (functions of no
    argument) runs on a thread of its own; waits for all of them and raises
    the first one's failure.  For the checks that spend their time waiting
    on a process's boot."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(others)) as pool:
        futures = [pool.submit(c) for c in others]
        first()
    for f in futures:
        f.result()


# kernels whose every instantiation must be in the library: the paged and
# ragged prefill kernels at three head dims over bf16, fp16 and int8 caches
# under bf16 and fp16 activations; the decode kernel over each cache (its
# mangled name's first template argument: __nv_bfloat16 for B1, __half for
# its fp16 body, `a`, signed char, for B4a under either) at D = 64 and 128
# with 4, 8 or 16 query rows and at D = 256 with 4 or 8; B5 in both regimes
# (decode at 8 and 16 rows) for both layouts and copies, bf16 and fp16 x;
# the grouped expert kernel at 8, 32 and 128 rows a tile over bf16 and int8
# experts
DECODE_BF16, DECODE_INT8 = "13decode_kernelI13__nv_bfloat16", "13decode_kernelIa"
DECODE_F16 = "13decode_kernelI6__half"
GROUPED = "grouped_wgmma_kernel"
SASS_INSTANTIATIONS = {"wgmma_prefill_kernel": 12, "ragged_kernel": 12, "w8a16_wgmma_kernel": 8,
                       "w8a16_decode_kernel": 16, DECODE_BF16: 8, DECODE_F16: 8, DECODE_INT8: 16,
                       GROUPED: 6}
# SASS of the instructions counted per kernel: the wgmma, the cp.async
# copy, the TMA tile load and a 16-byte shared-memory store
SASS_OPS = {"hgmma": "HGMMA", "ldgsts": "LDGSTS", "tma": "UTMALDG", "sts128": "STS.128"}


def sass_check(torch, lib_path) -> None:
    """The redesigned kernels as compiled: the wgmma kernels (B5 above 16
    rows, the paged prefill kernels B2 and B4b, every ragged instantiation,
    B3 and B4c, and every grouped expert instantiation, E1 and E2) issue
    HGMMA; they, B5's decode kernel and the decode attention kernel over
    each cache (B1, B4a) copy with LDGSTS (cp.async), except B5's
    instantiations for rows off 16 bytes (template flag VEC = false), which
    copy element by element, and the grouped kernels, which copy with TMA
    (UTMALDG) and store no 16-byte vector to shared memory: E2 writes no
    bf16 copy of its int8 weight tile (its A operand is converted in
    registers).  Logged per kernel with its instructions' counts; a missing
    instruction fails."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()[:500]}")
    counts, name = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op, text in SASS_OPS.items():
                counts[name][op] += text in line

    def copies_async(n):  # B5's last template argument is VEC
        m = re.search(r"w8a16_\w+?_kernelI(.*?)EE", n)
        return m is None or m.group(1).endswith("Lb1")

    want = {"w8a16_wgmma_kernel": True, "wgmma_prefill_kernel": True, "ragged_kernel": True,
            "w8a16_decode_kernel": False, DECODE_BF16: False, DECODE_F16: False, DECODE_INT8: False,
            GROUPED: True}
    for key, needs_hgmma in want.items():
        found = {n: c for n, c in counts.items() if key in n}
        check(bool(found), f"sass: no {key} in the library")
        for n, c in found.items():
            copies = (c["tma"] > 0 and c["sts128"] == 0) if key == GROUPED else (
                c["ldgsts"] > 0 or not copies_async(n))
            check(copies and (c["hgmma"] > 0 or not needs_hgmma), f"sass: {n[:80]} has {c}")
        check(len(found) >= SASS_INSTANTIATIONS.get(key, 1),
              f"sass: {len(found)} instantiations of {key}, expected {SASS_INSTANTIATIONS.get(key, 1)}")
        log(f"sass {key}: {len(found)} instantiations, " + ", ".join(
            f"{SASS_OPS[op]} {sorted({c[op] for c in found.values()})}" for op in SASS_OPS))


# ------------------------------------------------------------------ kernels
def _live_slots(torch, n_blocks, tables, lens, bs):
    """[N, Bs] bool on the card: the slots some row owns below its length."""
    live = torch.zeros((n_blocks, bs), dtype=torch.bool)
    for row, n in zip(tables.tolist(), lens):
        pos = torch.arange(n)
        live[torch.tensor(row)[pos // bs], pos % bs] = True
    return live.cuda()


def _poisoned_cache(torch, gen, n_blocks, tables, lens, hkd, bs=BS, dtype=None):
    """A random bf16 (or ``dtype``) cache [L, N, 2, Bs, Hk*D] whose every
    slot no row owns below its length is NaN, in every layer."""
    cache = torch.randn((L, n_blocks, 2, bs, hkd), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype or torch.bfloat16)
    live = _live_slots(torch, n_blocks, tables, lens, bs)
    cache.masked_fill_(~live[None, :, None, :, None], float("nan"))
    return cache


def _q8_cache(torch, gen, n_blocks, hk, d, bs, tables=None, lens=None):
    """A random int8 cache (QuantKvCache) [L, N, 2, Bs, Hk*D]: random codes
    everywhere, scales that make the dequantised values of order 1 (the
    codes' standard deviation is about 73.3).  With ``tables`` and
    ``lens``, every slot no row owns below its length keeps its random
    codes but gets a NaN scale, and every pad lane of the scale tiles is
    NaN."""
    from dynamo_tpu_torch.ops.kv_quant import QuantKvCache, scale_tile

    data = torch.randint(-127, 128, (L, n_blocks, 2, bs, hk * d), generator=gen, device="cuda",
                         dtype=torch.int8)
    hp, sp = scale_tile(hk, bs)
    scale = torch.ones((L, n_blocks, 2, hp, sp), device="cuda")
    valid = scale[..., :hk, :bs]
    valid.copy_((0.5 + torch.rand(valid.shape, generator=gen, device="cuda")) / 73.3)
    if tables is not None:
        scale[..., hk:, :] = float("nan")
        scale[..., bs:] = float("nan")
        live = _live_slots(torch, n_blocks, tables, lens, bs)
        valid.masked_fill_(~live[None, :, None, None, :], float("nan"))
    return QuantKvCache(data, scale)


def _tables(torch, lens, m, n_blocks, gen, bs=BS):
    """Disjoint random block tables [B, m], 0-filled past each row's
    blocks (the engine's layout)."""
    perm = torch.randperm(n_blocks, generator=gen, device="cuda").tolist()
    bt = torch.zeros((len(lens), m), dtype=torch.int32)
    k = 0
    for i, n in enumerate(lens):
        nb = -(-n // bs)
        bt[i, :nb] = torch.tensor(perm[k:k + nb], dtype=torch.int32)
        k += nb
    return bt.cuda()


def _ints(torch, xs):
    return torch.tensor(xs, dtype=torch.int32, device="cuda")


def compare(torch, what: str, out, ref) -> float:
    """Max abs error of a kernel's output against its plain version;
    fails on a non-finite output or an element outside the tolerance."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    excess = (diff - KERNEL_RTOL * ref.float().abs()).max().item()
    check(excess <= KERNEL_ATOL,
          f"{what}: |out - ref| exceeds {KERNEL_ATOL} + {KERNEL_RTOL} |ref| by {excess - KERNEL_ATOL}")
    return diff.max().item()


def _attention_cache(torch, gen, n_blocks, bt, live_lens, hk, d, bs, quant, dtype=None):
    """The poisoned cache of a kernel check: bf16 (or ``dtype``), or int8
    (``quant``)."""
    if quant:
        return _q8_cache(torch, gen, n_blocks, hk, d, bs, bt.cpu(), live_lens)
    return _poisoned_cache(torch, gen, n_blocks, bt.cpu(), live_lens, hk * d, bs, dtype)


def _act(torch, dtype) -> tuple:
    """(the activation dtype, bf16 unless named; its label prefix)."""
    dtype = dtype or torch.bfloat16
    return dtype, ("fp16 " if dtype == torch.float16 else "")


def decode_case(torch, gen, lens, s, logit_cap, geom=(H, HK, D), bs=BS, quant=False, live=None,
                dtype=None):
    """B1 or B4a (``quant``) against its plain version over a poisoned pool,
    q (and a float cache) in bf16 or ``dtype`` (the fp16 bodies); ``live``
    gives each row's live queries (S unless named: a verify row with fewer
    proposals than k), the queries past them are padding at q0 + j as the
    engine lays them out."""
    from dynamo_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention, paged_decode_attention_q8)

    m = 2048 // bs
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen, bs)
    h, hk, d = geom
    act, tag = _act(torch, dtype)
    cache = _attention_cache(torch, gen, n_blocks, bt, lens, hk, d, bs, quant, act)
    b = len(lens)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(act)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q0 = (seq_lens - torch.tensor(live or [s] * b, dtype=torch.int32, device="cuda")).clamp_min(0)
    args = (q, cache, LAYER, bt, seq_lens, q0)
    kernel = paged_decode_attention_q8 if quant else paged_decode_attention
    out = kernel(*args, logit_cap=logit_cap)
    what = (f"{tag}decode {'int8 ' if quant else ''}{geom} Bs={bs} S={s} cap={logit_cap} lens={lens}"
            f"{f' live={live}' if live else ''}")
    err = compare(torch, what, out, decode_attention_ref(*args, logit_cap=logit_cap))
    for i, n in enumerate(lens):
        if n == 0:
            check(bool((out[i] == 0).all()), f"decode S={s}: zero-length row {i} is not 0")
    # the split-K merge is in chunk order: the same bits every launch
    check(torch.equal(out, kernel(*args, logit_cap=logit_cap)), f"{what}: two launches differ")
    return err


def prefill_case(torch, gen, starts, fresh, s, geom=(H, HK, D), bs=BS, quant=False, logit_cap=None,
                 dtype=None):
    from dynamo_tpu_torch.ops.kernels.prefill_attention import (
        paged_prefill_attention, paged_prefill_attention_q8, prefill_attention_ref)

    m = 2048 // bs
    lens = [st + f for st, f in zip(starts, fresh)]
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen, bs)
    # only the cached prefix is live in the cache; fresh slots stay poisoned
    h, hk, d = geom
    act, tag = _act(torch, dtype)
    cache = _attention_cache(torch, gen, n_blocks, bt, starts, hk, d, bs, quant, act)
    b = len(starts)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(act)
    k_new = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(act)
    v_new = torch.randn((b, s, hk, d), generator=gen, device="cuda").to(act)
    for i, f in enumerate(fresh):  # padding rows of the fresh K/V are NaN too
        k_new[i, f:] = float("nan")
        v_new[i, f:] = float("nan")
    args = (q, k_new, v_new, cache, LAYER, bt,
            torch.tensor(lens, dtype=torch.int32, device="cuda"),
            torch.tensor(starts, dtype=torch.int32, device="cuda"))
    kernel = paged_prefill_attention_q8 if quant else paged_prefill_attention
    out = kernel(*args, logit_cap=logit_cap)
    err = compare(torch, f"{tag}prefill {'int8 ' if quant else ''}{geom} Bs={bs} starts={starts} "
                  f"fresh={fresh} "
                  f"cap={logit_cap}", out, prefill_attention_ref(*args, logit_cap=logit_cap))
    for i, f in enumerate(fresh):
        check(bool((out[i, f:] == 0).all()), f"prefill: padding rows of row {i} are not 0")
    return err


def ragged_case(torch, gen, rows, region, n_pad, geom=(H, HK, D), logit_cap=None, bs=BS,
                quant=False, dtype=None):
    """The ragged kernel against its plain version on one layout: the pool
    is poisoned except each row's live prefix, and padding K/V is NaN;
    padding tokens must come out exactly 0, and a second launch must give
    the same bits."""
    from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
        ragged_paged_prefill_attention, ragged_paged_prefill_attention_q8,
        ragged_prefill_attention_ref)

    m = 2048 // bs
    t, starts, lens, offs = ragged_layout(rows, region, n_pad, bs)
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen, bs)
    h, hk, d = geom
    act, tag = _act(torch, dtype)
    cache = _attention_cache(torch, gen, n_blocks, bt, starts, hk, d, bs, quant, act)
    q = torch.randn((1, t, h, d), generator=gen, device="cuda").to(act)
    k_new = torch.randn((1, t, hk, d), generator=gen, device="cuda").to(act)
    v_new = torch.randn((1, t, hk, d), generator=gen, device="cuda").to(act)
    live = torch.zeros(t, dtype=torch.bool, device="cuda")
    for st, n, o in zip(starts, lens, offs):
        live[o:o + n - st] = True
    k_new[0, ~live] = float("nan")
    v_new[0, ~live] = float("nan")
    args = (q, k_new, v_new, cache, LAYER, bt, _ints(torch, lens), _ints(torch, starts),
            _ints(torch, offs))
    kernel = ragged_paged_prefill_attention_q8 if quant else ragged_paged_prefill_attention
    out = kernel(*args, logit_cap=logit_cap)
    what = f"{tag}ragged {'int8 ' if quant else ''}{geom} Bs={bs} rows={rows}"
    err = compare(torch, what, out, ragged_prefill_attention_ref(*args, logit_cap=logit_cap))
    check(bool((out[0, ~live] == 0).all()), f"{what}: padding tokens are not 0")
    check(torch.equal(out, kernel(*args, logit_cap=logit_cap)), f"{what}: two launches differ")
    return err


def kernel_phase(torch) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"decode": 0.0, "prefill": 0.0, "ragged": 0.0}
    mixed = [0, 1, 17, 100, 333, 1024, 1500, 2048]
    for s in (1, 4):
        for cap in (None, 50.0):
            e = decode_case(torch, gen, mixed, s, cap)
            log(f"kernel decode  B=8 S={s} softcap={cap}: max abs err {e:.3g}")
            errs["decode"] = max(errs["decode"], e)
    for s in SPEC_VERIFY_S:
        for live in (None, verify_live(mixed, s)):
            e = decode_case(torch, gen, mixed, s, None, live=live)
            log(f"kernel decode  B=8 S={s} (verify) live queries {live or s}: max abs err {e:.3g}")
            errs["decode"] = max(errs["decode"], e)
    e = prefill_case(torch, gen, starts=[0, 256], fresh=[512, 500], s=512)
    log(f"kernel prefill B=2 S=512 start=[0, 256] fresh=[512, 500]: max abs err {e:.3g}")
    errs["prefill"] = e
    # the other head widths the kernels take (Llama-3.2-1B: 64, Gemma: 256),
    # with MHA and G = 8 groupings; checked, not part of the reported error
    for geom in ((8, 8, 64), (16, 2, 256)):
        d_err = decode_case(torch, gen, [0, 5, 300], 2, None, geom=geom)
        p_err = prefill_case(torch, gen, starts=[64], fresh=[90], s=96, geom=geom)
        log(f"kernel (H, Hk, D)={geom}: decode S=2 max abs err {d_err:.3g}, "
            f"prefill start=64 max abs err {p_err:.3g}")
    # the bf16 kernel's tile edges: softcap; fresh lengths off the token tile
    # (128 / G tokens); a start that is block-aligned but not 64-aligned, so
    # a 64-key tile crosses it into poisoned slots; G = 64 (two tokens per
    # block); each at D = 64, 128 and 256
    for starts, fresh, s, geom, cap in (
            ([0, 80], [77, 301], 320, (H, HK, D), 50.0),
            ([80, 1040], [45, 1], 64, (H, HK, D), None),
            ([80], [45], 48, (64, 1, 128), None),
            ([48], [33], 48, (64, 1, 64), 50.0),
            ([80, 16], [100, 7], 112, (16, 2, 256), 50.0),
            ([0], [129], 144, (8, 8, 64), None)):
        e = prefill_case(torch, gen, starts=starts, fresh=fresh, s=s, geom=geom, logit_cap=cap)
        log(f"kernel prefill (H, Hk, D)={geom} S={s} start={starts} fresh={fresh} softcap={cap}: "
            f"max abs err {e:.3g}")
        errs["prefill"] = max(errs["prefill"], e)
    # ragged: the unified layout (8 decode rows, contexts 1 to 2047, ahead of
    # a span from 0 and one from a block-aligned start, then padding rows),
    # softcap on and off, and a packed prefill as the engine's first dispatch
    decode_rows = [(n - 1, 1) for n in (1, 17, 100, 333, 1024, 1500, 2047, 64)]
    unified = decode_rows + [(0, 300), (256, 200)]
    for cap in (None, 50.0):
        e = ragged_case(torch, gen, unified, 16, 6, logit_cap=cap)
        log(f"kernel ragged unified layout (8 decode rows + 2 spans + 6 padding rows) "
            f"softcap={cap}: max abs err {e:.3g}")
        errs["ragged"] = max(errs["ragged"], e)
    e = ragged_case(torch, gen, [(0, 17), (0, 300), (0, 640), (0, 48)], 0, 0)
    log(f"kernel ragged packed prefill spans 17/300/640/48: max abs err {e:.3g}")
    errs["ragged"] = max(errs["ragged"], e)
    # MHA (G = 1, 64-token tiles) and G = 8 (8-token tiles) straddle rows
    for geom in ((8, 8, 64), (16, 2, 256)):
        e = ragged_case(torch, gen, [(4, 1), (299, 1), (76, 1), (0, 90), (64, 45)], 16, 3,
                        geom=geom)
        log(f"kernel ragged (H, Hk, D)={geom} 3 decode rows + 2 spans: max abs err {e:.3g}")
    errs.update(q8_kernel_phase(torch, gen))
    for key, e in edge_phase(torch, gen).items():
        errs[key] = max(errs[key], e)
    for key, e in ragged_edge_phase(torch, gen).items():
        errs[key] = max(errs[key], e)
    errs["matmul"] = matmul_phase(torch, gen)
    errs.update(moe_kernel_phase(torch, gen))
    return errs


# the fp16 bodies' matmul rows: one decode row, a decode step at 8 slots,
# both sides of the decode regime's 16-row limit, a 1,504-token prefill
FP16_MATMUL_ROWS = (1, 8, 16, 17, 1504)


def fp16_kernel_phase(torch) -> dict:
    """The fp16 bodies (q, the fresh K/V, a float cache, x and out in
    float16) against their plain versions on the same NaN-poisoned pools
    and at the same tolerance as the bf16 checks: B1 at S = 1, 5 and 8 (Bs
    16, contexts 0 to 2048, softcap on and off at S = 1, a verify with rows
    of fewer live queries than S = 8), B4a the same at Bs 16 and 32; B2 from
    0 and over a 256-token prefix, from a start inside a 64-key tile and with
    softcap; B4b over the int8 prefix hit (256 + 700) and a start inside a
    key tile, Bs 16 and 32; B3 and B4c on the unified layout (8 decode rows
    with contexts 1 to 2047 ahead of two spans, softcap on and off) and B3 on
    a packed prefill; each attention kernel also at (H, Hk, D) = (8, 8, 64)
    and (16, 2, 256); B5 at every Llama-3-8B projection and the lm_head (f32
    out) at M in FP16_MATMUL_ROWS, both weight layouts, and a split-K launch
    twice for the same bits.  Every decode and ragged launch is run twice
    for the same bits (``decode_case``, ``ragged_case``).  Returns each
    body's max abs error, keyed as the bf16 ones with ``_fp16``."""
    from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    f16 = torch.float16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(28)
    errs = dict.fromkeys(("decode", "prefill", "ragged", "decode_q8", "prefill_q8", "ragged_q8",
                          "matmul"), 0.0)

    def note(key, e, what):
        errs[key] = max(errs[key], e)
        log(f"kernel fp16 {what}: max abs err {e:.3g}")

    mixed = [0, 1, 17, 100, 333, 1024, 1500, 2048]
    for quant, bs in ((False, BS), (True, BS), (True, BS_Q8)):
        key, kind = ("decode_q8", f"decode int8 Bs={bs}") if quant else ("decode", f"decode Bs={bs}")
        for s in (1, 5, 8):
            for cap in ((None, 50.0) if s == 1 else (None,)):
                note(key, decode_case(torch, gen, mixed, s, cap, bs=bs, quant=quant, dtype=f16),
                     f"{kind} B=8 S={s} softcap={cap}")
        live = verify_live(mixed, 8)
        note(key, decode_case(torch, gen, mixed, 8, None, bs=bs, quant=quant, live=live, dtype=f16),
             f"{kind} B=8 S=8 (verify) live queries {live}")
    for starts, fresh, sl, cap in (([0, 256], [512, 500], 512, None), ([80, 1040], [45, 1], 64, None),
                                   ([0, 80], [77, 301], 320, 50.0)):
        note("prefill", prefill_case(torch, gen, starts, fresh, sl, logit_cap=cap, dtype=f16),
             f"prefill start={starts} fresh={fresh} softcap={cap}")
    for bs in (16, BS_Q8):
        for starts, fresh, sl in (([SHARED_PREFIX], [700], 704), ([bs * 3, 0], [155, 77], 160)):
            note("prefill_q8", prefill_case(torch, gen, starts, fresh, sl, bs=bs, quant=True, dtype=f16),
                 f"prefill int8 Bs={bs} start={starts} fresh={fresh}")
    decode_rows = [(n - 1, 1) for n in (1, 17, 100, 333, 1024, 1500, 2047, 64)]
    for quant, bs in ((False, BS), (True, 16), (True, BS_Q8)):
        key = "ragged_q8" if quant else "ragged"
        for cap in (None, 50.0):
            note(key, ragged_case(torch, gen, decode_rows + [(0, 300), (256, 200)], 16, 6, logit_cap=cap,
                                  bs=bs, quant=quant, dtype=f16),
                 f"ragged {'int8 ' if quant else ''}Bs={bs} unified layout softcap={cap}")
    note("ragged", ragged_case(torch, gen, [(0, 17), (0, 300), (0, 640), (0, 48)], 0, 0, dtype=f16),
         "ragged packed prefill spans 17/300/640/48")
    for geom in ((8, 8, 64), (16, 2, 256)):
        for quant in (False, True):
            q8 = "_q8" if quant else ""
            note("decode" + q8, decode_case(torch, gen, [0, 5, 300], 2, None, geom=geom, quant=quant,
                                            dtype=f16), f"{'int8 ' if quant else ''}decode {geom} S=2")
            note("prefill" + q8, prefill_case(torch, gen, [64], [90], 96, geom=geom, quant=quant,
                                              dtype=f16), f"{'int8 ' if quant else ''}prefill {geom}")
            note("ragged" + q8, ragged_case(torch, gen, [(4, 1), (299, 1), (76, 1), (0, 90), (64, 45)],
                                            16, 3, geom=geom, quant=quant, dtype=f16),
                 f"{'int8 ' if quant else ''}ragged {geom} 3 decode rows + 2 spans")
    for name, (k, n) in dict(PROJECTIONS, lm_head=LM_HEAD).items():
        out_dtype = torch.float32 if name == "lm_head" else f16
        worst = 0.0
        for layout in ("kn", "nk"):
            wq, scale = _q8_weight(torch, gen, k, n, layout)
            for m in FP16_MATMUL_ROWS:
                x = torch.randn((m, k), generator=gen, device="cuda").to(f16)
                out = int8_matmul(x, wq, scale, out_dtype)
                check(out.dtype == out_dtype and out.shape == (m, n), f"fp16 matmul {name}: {out.dtype}")
                worst = max(worst, compare(torch, f"fp16 matmul {name} [{k}, {n}] {layout} M={m}", out,
                                           int8_matmul_ref(x, wq, scale, out_dtype)))
            del wq, scale
        note("matmul", worst, f"matmul {name} [K, N]=[{k}, {n}] M in {FP16_MATMUL_ROWS}, both layouts")
    k, n = PROJECTIONS["wk"]
    wq, scale = _q8_weight(torch, gen, k, n, "kn")
    for m in (8, 64):
        x = torch.randn((m, k), generator=gen, device="cuda").to(f16)
        check(torch.equal(int8_matmul(x, wq, scale), int8_matmul(x, wq, scale)),
              f"fp16 matmul wk M={m}: two runs of the split-K launch differ")
    log("kernel fp16 matmul split K, wk at M=8 and M=64: two runs bit-identical")
    return {f"{k}_fp16": v for k, v in errs.items()}


def kern_phase(torch, card: str) -> None:
    """The kernel plane's run cases on the card: each of the nine kernels
    at every geometry of the registry matrix it takes (``ops/kernels/
    registry.py`` ``audit_cases``, the matrix ``lint --kern`` audits on the
    CPU with the plain versions: JAX's adversarial rows at D = 64, the
    verify's S = 5 and 8, the int8 prefix hit, the grouped launches at T =
    8 and 1,504, and the fp16 bodies' twins of the bf16 cases, keyed
    ``<kernel>/fp16``), its inputs drawn from the case's numpy seed (bf16,
    or fp16 for an fp16 case, or int8 codes with f32 scales), NaN-poisoned
    as the plane poisons them
    (cache slots past each row's context and every unreferenced block, the
    int8 scales of both and their pad lanes, fresh padding rows, tokens in
    no span, unrouted experts' weights and scales) and held against its
    plain version on the same poisoned inputs within PERF.md §2's
    tolerance.  A leak is a non-finite value in a live lane; padding and
    zero-length rows must be exactly 0.  Prints the ``kern`` line: for each
    kernel its cases, max abs error, leaks and exact zeros."""
    t0 = time.perf_counter()
    out: dict[str, dict] = {}
    for case in kreg.audit_cases():
        if case["mode"] != "run":
            continue
        what = f"kern {case['kernel']} [{case['name']}]"
        poisoned = kreg.poison(case, kreg.build(case, device="cuda", dtype=torch.bfloat16))
        got = kreg.run(case, poisoned).float()
        ref = kreg.run_plain(case, poisoned).float()
        torch.cuda.synchronize()
        live, zero = (torch.as_tensor(m, device="cuda") for m in kreg.lanes(case, tuple(got.shape)))
        leaks = int((~torch.isfinite(got[live])).sum())
        diff = (got - ref).abs()[live]
        excess = (diff - KERNEL_RTOL * ref.abs()[live]).max().item() if live.any() else 0.0
        zeros = int((got[zero] == 0).sum())
        key = case["kernel"] + ("/fp16" if case.get("dtype") == "float16" else "")
        row = out.setdefault(key, dict(id=kreg.KERNELS[case["kernel"]]["id"], cases=0,
                                                  max_abs_err=0.0, leaks=0, zero_lanes=0,
                                                  exact_zeros=0, geometries=[]))
        row["cases"] += 1
        row["geometries"].append(case["name"])
        row["max_abs_err"] = max(row["max_abs_err"], diff.max().item() if live.any() else 0.0)
        row["leaks"] += leaks
        row["zero_lanes"] += int(zero.sum())
        row["exact_zeros"] += zeros
        check(leaks == 0, f"{what}: {leaks} non-finite live lanes: the NaN poison leaked")
        check(excess <= KERNEL_ATOL, f"{what}: |out - ref| exceeds {KERNEL_ATOL} + {KERNEL_RTOL} |ref| "
              f"by {excess - KERNEL_ATOL}")
        check(zeros == int(zero.sum()), f"{what}: {int(zero.sum()) - zeros} padding or zero-length "
              "lanes are not exactly 0")
    real = {k: m for k, m in kreg.KERNELS.items() if not m["placeholder"]}
    check(set(out) == set(real) | {f"{k}/fp16" for k, m in real.items() if "float16" in m["dtypes"]},
          f"kern: the run cases reached {sorted(out)}, not every kernel and fp16 body")
    log(json.dumps({"kern": dict(kernels=out, cases=sum(r["cases"] for r in out.values()),
                                 leaks=sum(r["leaks"] for r in out.values()),
                                 seconds=round(time.perf_counter() - t0, 3), card=card)}))


def q8_kernel_phase(torch, gen) -> dict:
    """The three int8 attention kernels against their plain version, at
    the bf16 checks' layouts and at both block sizes."""
    errs = {"decode_q8": 0.0, "prefill_q8": 0.0, "ragged_q8": 0.0}
    mixed = [0, 1, 17, 100, 333, 1024, 1500, 2048]
    decode_rows = [(n - 1, 1) for n in (1, 17, 100, 333, 1024, 1500, 2047, 64)]
    for bs in (16, BS_Q8):
        for s in (1, 4):
            for cap in (None, 50.0):
                e = decode_case(torch, gen, mixed, s, cap, bs=bs, quant=True)
                log(f"kernel decode int8 Bs={bs} B=8 S={s} softcap={cap}: max abs err {e:.3g}")
                errs["decode_q8"] = max(errs["decode_q8"], e)
        for s in SPEC_VERIFY_S:
            for live in (None, verify_live(mixed, s)):
                e = decode_case(torch, gen, mixed, s, None, bs=bs, quant=True, live=live)
                log(f"kernel decode int8 Bs={bs} B=8 S={s} (verify) live queries {live or s}: max "
                    f"abs err {e:.3g}")
                errs["decode_q8"] = max(errs["decode_q8"], e)
        e = prefill_case(torch, gen, starts=[0, 256], fresh=[512, 500], s=512, bs=bs, quant=True)
        log(f"kernel prefill int8 Bs={bs} B=2 S=512 start=[0, 256]: max abs err {e:.3g}")
        errs["prefill_q8"] = max(errs["prefill_q8"], e)
        e = prefill_case(torch, gen, starts=[1024, 96], fresh=[300, 45], s=320, bs=bs, quant=True)
        log(f"kernel prefill int8 Bs={bs} B=2 S=320 start=[1024, 96]: max abs err {e:.3g}")
        errs["prefill_q8"] = max(errs["prefill_q8"], e)
        for cap in (None, 50.0):
            e = ragged_case(torch, gen, decode_rows + [(0, 300), (256, 200)], 16, 6,
                            logit_cap=cap, bs=bs, quant=True)
            log(f"kernel ragged int8 Bs={bs} unified layout softcap={cap}: max abs err {e:.3g}")
            errs["ragged_q8"] = max(errs["ragged_q8"], e)
        for geom in ((8, 8, 64), (16, 2, 256)):
            d_err = decode_case(torch, gen, [0, 5, 300], 2, None, geom=geom, bs=bs, quant=True)
            p_err = prefill_case(torch, gen, starts=[64], fresh=[90], s=96, geom=geom, bs=bs,
                                 quant=True)
            r_err = ragged_case(torch, gen, [(4, 1), (299, 1), (76, 1), (0, 90), (64, 45)], 16, 3,
                                geom=geom, bs=bs, quant=True)
            log(f"kernel int8 (H, Hk, D)={geom} Bs={bs}: decode S=2 max abs err {d_err:.3g}, "
                f"prefill start=64 {p_err:.3g}, ragged 3 decode rows + 2 spans {r_err:.3g}")
    return errs


# The decode kernel's edges over both caches (B1 bf16, B4a int8) and the
# int8 prefill kernel's (B4b), at G = 1, 4 and 8 (H, Hk, D below) and Bs =
# 16 and 32.  Decode: contexts 0 and 1, either side of its 64-token chunks
# and 16-key tiles, and the whole 2048-token table, at S = 1 and 8 (8 x G
# query rows: one to eight row groups), each launched twice for the same
# bits.  B4b: a start inside a key tile (block-aligned, not tile-aligned),
# fresh lengths off the token tile (128 / G tokens).
EDGE_GEOMS = ((8, 8, 64), (32, 8, 128), (16, 2, 256))
DECODE_EDGE_LENS = [0, 1, 15, 17, 63, 64, 65, 127, 129, 2047, 2048]


def edge_phase(torch, gen) -> dict:
    errs = {"decode": 0.0, "decode_q8": 0.0, "prefill_q8": 0.0}
    i = 0
    for geom in EDGE_GEOMS:
        keys = 32 if geom[2] == 256 else 64  # the prefill kernel's key tile
        for bs in (16, BS_Q8):
            for s in (1, 8):
                cap = 50.0 if i % 2 else None
                i += 1
                for quant in (False, True):
                    e = decode_case(torch, gen, DECODE_EDGE_LENS, s, cap, geom=geom, bs=bs, quant=quant)
                    key = "decode_q8" if quant else "decode"
                    errs[key] = max(errs[key], e)
                    log(f"kernel decode {'int8' if quant else 'bf16'} edges (H, Hk, D)={geom} Bs={bs} S={s} "
                        f"softcap={cap} contexts {DECODE_EDGE_LENS}: max abs err {e:.3g}, two launches "
                        f"bit-identical")
            start = next((st for st in range(bs, 4 * keys, bs) if st % keys), bs)
            cap = 50.0 if i % 2 else None
            i += 1
            e = prefill_case(torch, gen, starts=[start, 0], fresh=[155, 77], s=160, geom=geom, bs=bs,
                             quant=True, logit_cap=cap)
            errs["prefill_q8"] = max(errs["prefill_q8"], e)
            log(f"kernel prefill int8 edges (H, Hk, D)={geom} Bs={bs} start=[{start}, 0] fresh=[155, 77] "
                f"softcap={cap}: max abs err {e:.3g}")
    return errs


# The ragged kernels' block edges.  (H, Hk, D): G = 1, 4 and 8 (span blocks
# of 128, 32 and 16 tokens) at D = 64, 128 and 256.  Layouts (rows, decode
# region, padding rows): spans that end on a 128-, 32- and 16-token block
# boundary and spans that a boundary cuts; a full 16-row decode region with
# contexts 1 to 2047 (64 k and 64 k + 1 keys among them) ahead of a span;
# spans from starts inside a 64-key tile, one at a flat offset inside one.
RAGGED_EDGE_GEOMS = ((8, 8, 64), (32, 8, 128), (16, 2, 256))
RAGGED_EDGE_LAYOUTS = {
    "block boundaries": ([(0, 128), (48, 96), (0, 200)], 0, 2),
    "full decode region": ([(n - 1, 1) for n in (1, 2, 17, 63, 64, 65, 100, 128, 129, 333, 640, 1024,
                                                 1025, 1500, 2000, 2047)] + [(0, 90)], 16, 1),
    "misaligned starts": ([(5, 1), (80, 150), (16, 45)], 16, 2),
}


def ragged_edge_phase(torch, gen) -> dict:
    """Both ragged kernels at every edge geometry and layout, bf16 and int8
    at Bs = 16 and 32, softcap on for every other case; each case also
    checks that padding tokens are 0 and two launches give the same bits."""
    errs = {"ragged": 0.0, "ragged_q8": 0.0}
    i = 0
    for geom in RAGGED_EDGE_GEOMS:
        for name, (rows, region, n_pad) in RAGGED_EDGE_LAYOUTS.items():
            for quant, bs in ((False, BS), (True, 16), (True, BS_Q8)):
                cap = 50.0 if i % 2 else None
                i += 1
                e = ragged_case(torch, gen, rows, region, n_pad, geom=geom, logit_cap=cap, bs=bs,
                                quant=quant)
                key = "ragged_q8" if quant else "ragged"
                errs[key] = max(errs[key], e)
                log(f"kernel ragged edges {'int8' if quant else 'bf16'} Bs={bs} (H, Hk, D)={geom} {name} "
                    f"softcap={cap}: max abs err {e:.3g}, two launches bit-identical")
    return errs


def _q8_weight(torch, gen, k, n, layout):
    """A random int8 weight [K, N] as the model holds it ("kn"), or as the
    transpose of a row-major [N, K] one ("nk", the tied embedding), with
    scales that make x @ w of order 1 for x of order 1."""
    shape = (k, n) if layout == "kn" else (n, k)
    wq = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    scale = (0.5 + torch.rand(n, generator=gen, device="cuda")) / (73.3 * math.sqrt(k))
    return (wq if layout == "kn" else wq.t()), scale


def matmul_phase(torch, gen) -> float:
    """The W8A16 kernel against its plain version at every matmul shape of
    Llama-3-8B, both weight layouts, at row counts on both sides of the
    decode regime's limit (16) and of the wgmma regime's 128-row tiles, and
    at the serving paths' decode and prefill counts; then at ragged shapes
    (rows off 16 bytes: a 32002-token vocabulary, a depth of 4104), at
    Qwen3-30B-A3B's attention projections and lm_head, and a
    split-K launch run twice, which must give the same bits."""
    from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    worst = 0.0
    shapes = dict(PROJECTIONS, lm_head=LM_HEAD)
    for name, (k, n) in shapes.items():
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        errs = []
        for layout in ("kn", "nk"):
            wq, scale = _q8_weight(torch, gen, k, n, layout)
            for m in MATMUL_ROWS:
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                out = int8_matmul(x, wq, scale, out_dtype)
                check(out.dtype == out_dtype and out.shape == (m, n), f"matmul {name}: {out.shape}")
                errs.append(compare(torch, f"matmul {name} [{k}, {n}] {layout} M={m}", out,
                                    int8_matmul_ref(x, wq, scale, out_dtype)))
            del wq, scale
        log(f"kernel matmul {name} [K, N]=[{k}, {n}] M in {MATMUL_ROWS}, both layouts: "
            f"max abs err {max(errs):.3g}")
        worst = max(worst, *errs)
    for k, n in RAGGED_MATMULS:
        errs = []
        for layout in ("kn", "nk"):
            wq, scale = _q8_weight(torch, gen, k, n, layout)
            for m in RAGGED_MATMUL_ROWS:
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                errs.append(compare(torch, f"matmul [{k}, {n}] {layout} M={m}", int8_matmul(x, wq, scale),
                                    int8_matmul_ref(x, wq, scale)))
            del wq, scale
        log(f"kernel matmul ragged [K, N]=[{k}, {n}] M in {RAGGED_MATMUL_ROWS}, both layouts: "
            f"max abs err {max(errs):.3g}")
        worst = max(worst, *errs)
    for name, (k, n) in QWEN3_MOE_MATMULS.items():
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        wq, scale = _q8_weight(torch, gen, k, n, "kn")
        errs = [compare(torch, f"matmul Qwen3-30B-A3B {name} [{k}, {n}] M={m}",
                        int8_matmul(x, wq, scale, out_dtype), int8_matmul_ref(x, wq, scale, out_dtype))
                for m in MATMUL_ROWS
                for x in [torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)]]
        del wq, scale
        log(f"kernel matmul Qwen3-30B-A3B {name} [K, N]=[{k}, {n}] M in {MATMUL_ROWS}: "
            f"max abs err {max(errs):.3g}")
        worst = max(worst, *errs)
    # wk splits K 64 ways at M = 8 (decode regime), 16 ways at M = 64
    # (wgmma regime): the same bits twice
    for name, m in (("wk", 8), ("wk", 64)):
        k, n = PROJECTIONS[name]
        wq, scale = _q8_weight(torch, gen, k, n, "kn")
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        check(torch.equal(int8_matmul(x, wq, scale), int8_matmul(x, wq, scale)),
              f"matmul {name} M={m}: two runs of the split-K launch differ")
    log("kernel matmul split K, wk at M=8 and M=64: two runs bit-identical")
    return worst


def _sdpa_decode_ms(torch, q, lens, dense_kv, layers: int = L, q0=None) -> tuple[float, float]:
    """SDPA on one decode step's layer, the decode kernels' library
    yardstick: q [B, S, H, D] over each layer's K/V laid out dense
    beforehand (``dense_kv(layer)`` gives [B, Hk, T, D] twice), successive
    calls walking the ``layers`` layers (32 unless named) as the kernels
    do; for S > 1 query j of row i sees keys up to ``q0[i] + j``.  Timed as
    the kernels are, as a CUDA graph of the calls (the card's time) and
    launched eagerly; medians of three readings."""
    import torch.nn.functional as F

    kvs = [dense_kv(layer) for layer in range(layers)]
    seq = torch.tensor(lens, device="cuda")
    t = torch.arange(kvs[0][0].shape[2], device="cuda")
    mask = (t[None, :] < seq[:, None])[:, None, None, :]
    if q0 is not None:
        qpos = q0[:, None].long() + torch.arange(q.shape[1], device="cuda")[None, :]
        mask = mask & (t[None, None, :] <= qpos[:, :, None])[:, None]
    qd = q.transpose(1, 2).contiguous()
    calls = [lambda kv=kv: F.scaled_dot_product_attention(qd, *kv, attn_mask=mask, enable_gqa=True)
             for kv in kvs]
    graph_ms = median_ms(lambda: graph_time_ms(calls, 20) / layers)
    eager_ms = median_ms(lambda: cuda_time_ms(lambda i: calls[i % layers](), 64))
    return graph_ms, eager_ms


def _sdpa_ms(call, iters: int = 10) -> tuple[float, float]:
    """An SDPA yardstick as a CUDA graph (the card's time, as the kernels
    beside it are compared) and launched eagerly: medians of three readings."""
    return (median_ms(lambda: graph_time_ms([call], iters)),
            median_ms(lambda: cuda_time_ms(lambda i: call(), iters)))


def _check_graph_replay(torch, call, what: str) -> None:
    """A decode call captured in a CUDA graph as it is (the kernel's
    tickets reset themselves) replays the eager launch's bits."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        eager = call()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            captured = call()
        for _ in range(3):
            graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(captured, eager), f"{what}: a CUDA graph replay differs from the eager launch")


def timing_phase(torch, card: str, dtype=None) -> dict:
    """Decode and prefill at the default path's shapes, timed and checked
    against their plain versions there: decode is one layer of a burst step
    (B = 8 slots, S = 1, the six requests mid-generation; timed as a CUDA
    graph, as the int8 decode kernel is, and a graph replay held to the
    eager launch's bits), and prefill the longest prompt's one dispatch
    (S = 1504, start = 0).  bf16, or the fp16 bodies for ``dtype`` float16
    (their readings keyed with ``_fp16``; SDPA in fp16 beside them)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention)
    from dynamo_tpu_torch.ops.kernels.prefill_attention import (
        paged_prefill_attention, prefill_attention_ref)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    m = 2048 // BS
    out = {}
    act, tag = _act(torch, dtype)
    sfx, dt = ("_fp16", "float16") if tag else ("", "bfloat16")

    # decode
    lens = [n + MAX_TOKENS // 2 for n in PROMPT_LENS] + [0, 0]
    b = len(lens)
    n_blocks = sum(-(-n // BS) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen)
    cache = torch.randn((L, n_blocks, 2, BS, HK * D), generator=gen, device="cuda").to(act)
    q = torch.randn((b, 1, H, D), generator=gen, device="cuda").to(act)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q0 = (seq_lens - 1).clamp_min(0)
    # successive launches walk the 32 layers, as a decode step does, so
    # the context is not served from L2; timed as a CUDA graph of the 32
    # calls (the card's time) and, for the log, launched eagerly
    calls = [lambda i=i: paged_decode_attention(q, cache, i, bt, seq_lens, q0) for i in range(L)]
    kernel_ms = graph_time_ms(calls, 20) / L
    eager_ms = cuda_time_ms(lambda i: calls[i % L](), 64)
    plain_ms = cuda_time_ms(lambda i: decode_attention_ref(q, cache, i % L, bt, seq_lens, q0), 8)
    out["decode_err" + sfx] = compare(torch, f"{tag}decode at the serving shapes",
                                paged_decode_attention(q, cache, LAYER, bt, seq_lens, q0),
                                decode_attention_ref(q, cache, LAYER, bt, seq_lens, q0))
    _check_graph_replay(torch, lambda: paged_decode_attention(q, cache, LAYER, bt, seq_lens, q0),
                        f"{tag}decode")

    library_ms, library_eager_ms = _sdpa_decode_ms(
        torch, q, lens, lambda layer: _dense_kv(torch, cache, bt, lens, layer, BS, act))
    ctx = sum(lens)
    out["decode" + sfx] = r = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                   **_bound("paged_decode_attention", dt, b=b, s=1, h=H, hk=HK, d=D, m=m,
                                            lens=lens))
    log(f"time {tag}decode  B={b} S=1 ctx={ctx}: kernel {kernel_ms:.4f} ms (CUDA graph; eager "
        f"{eager_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (CUDA graph; eager {library_eager_ms:.4f}), "
        f"bound {r['bound_ms']:.4f} ms, "
        f"max abs err {out['decode_err' + sfx]:.3g}, a CUDA graph replay bit-identical to the eager "
        f"launch ({card})")

    # prefill
    s = -(-max(PROMPT_LENS) // BS) * BS
    fresh = max(PROMPT_LENS)
    bt1 = _tables(torch, [fresh], m, -(-fresh // BS) + 8, gen)
    cache1 = torch.randn((L, bt1.max().item() + 1, 2, BS, HK * D), generator=gen,
                         device="cuda").to(act)
    qp = torch.randn((1, s, H, D), generator=gen, device="cuda").to(act)
    kp = torch.randn((1, s, HK, D), generator=gen, device="cuda").to(act)
    vp = torch.randn((1, s, HK, D), generator=gen, device="cuda").to(act)
    lens1 = torch.tensor([fresh], dtype=torch.int32, device="cuda")
    st1 = torch.zeros(1, dtype=torch.int32, device="cuda")
    pargs = (qp, kp, vp, cache1, LAYER, bt1, lens1, st1)
    kernel_ms = cuda_time_ms(lambda i: paged_prefill_attention(*pargs), 10)
    kernel_graph_ms = graph_time_ms([lambda: paged_prefill_attention(*pargs)], 10)
    plain_ms = cuda_time_ms(lambda i: prefill_attention_ref(*pargs), 3, warmup=1)
    out["prefill_err" + sfx] = compare(torch, f"{tag}prefill at the serving shapes",
                                 paged_prefill_attention(*pargs), prefill_attention_ref(*pargs))
    qs = qp[:, :fresh].transpose(1, 2).contiguous()
    ks = kp[:, :fresh].transpose(1, 2).contiguous()
    vs = vp[:, :fresh].transpose(1, 2).contiguous()
    library_ms, library_eager_ms = _sdpa_ms(
        lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True))
    out["prefill" + sfx] = r = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                    **_bound("paged_prefill_attention", dt, b=1, s=s, h=H, hk=HK, d=D, m=m,
                                             starts=[0], lens=[fresh]))
    log(f"time {tag}prefill B=1 S={s} fresh={fresh} start=0: kernel {kernel_ms:.4f} ms (CUDA graph "
        f"{kernel_graph_ms:.4f}), plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms (CUDA graph; eager {library_eager_ms:.4f}), "
        f"bound {r['bound_ms']:.4f} ms, "
        f"max abs err {out['prefill_err' + sfx]:.3g} ({card})")
    return out


def _bound(kernel: str, dtype: str = "bfloat16", **geometry) -> dict:
    """The least time the card could take for one launch of ``kernel`` at
    ``geometry`` (or, with ``calls``, for several): the registry's work
    cost, the larger of its operations over the tensor-core peak of
    ``dtype`` (bf16 and fp16 alike) and its bytes over the memory rate
    (``ops/kernels/registry.py``)."""
    return kreg.bound(kreg.work_cost(kernel, geometry), dtype)


def _dequant_rows(torch, cache, rows, n, layer=LAYER, dtype=None):
    """The first ``n`` K and V rows [n, Hk, D] (bf16, or ``dtype``) of
    blocks ``rows`` of ``layer`` of an int8 cache."""
    from dynamo_tpu_torch.ops.kv_quant import gather_layer_blocks

    kv = gather_layer_blocks(cache, layer, rows, HK).to(dtype or torch.bfloat16)
    return kv[:, 0].reshape(-1, HK, D)[:n], kv[:, 1].reshape(-1, HK, D)[:n]


def _dense_kv(torch, cache, bt, lens, layer: int, bs: int, dtype=None):
    """Layer ``layer``'s K and V of each row's live context, laid out dense
    for SDPA ([B, Hk, T, D] bf16, or ``dtype``, each; an int8 cache
    dequantised)."""
    from dynamo_tpu_torch.ops.kv_quant import is_quant

    quant = is_quant(cache)
    kd = torch.zeros((len(lens), HK, max(lens), D), dtype=dtype or torch.bfloat16, device="cuda")
    vd = torch.zeros_like(kd)
    for i, n in enumerate(lens):
        if not n:
            continue
        if quant:
            k_rows, v_rows = _dequant_rows(torch, cache, bt[i, :-(-n // bs)], n, layer, dtype)
        else:
            rows = bt[i, :-(-n // bs)].long()
            k_rows = cache[layer, rows, 0].reshape(-1, HK, D)[:n]
            v_rows = cache[layer, rows, 1].reshape(-1, HK, D)[:n]
        kd[i, :, :n], vd[i, :, :n] = k_rows.transpose(0, 1), v_rows.transpose(0, 1)
    return kd, vd


def q8_timing_phase(torch, card: str, dtype=None) -> dict:
    """The int8 decode and prefill kernels at the int8 default path's
    shapes (Bs = 32), timed and checked against their plain version there:
    decode is one layer of a burst step (B = 8 slots, S = 1, the six
    requests mid-generation; a CUDA graph of the 32 layers' calls, the
    card's time, since the kernel is shorter than a launch from Python) and
    prefill the dispatch of the request that
    hits the shared prefix (start = 256, 700 fresh tokens).  The library
    yardstick is SDPA on K/V dequantised to bf16 beforehand (for decode,
    each layer's, timed as the kernel is): it reads twice the cache bytes
    the kernel reads, and the dequantisation is not timed.  bf16 queries,
    or the fp16 bodies for ``dtype`` float16 (readings keyed with ``_fp16``,
    SDPA on K/V dequantised to fp16)."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention_q8)
    from dynamo_tpu_torch.ops.kernels.prefill_attention import (
        paged_prefill_attention_q8, prefill_attention_ref)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bs, m = BS_Q8, 2048 // BS_Q8
    out = {}
    act, tag = _act(torch, dtype)
    sfx, dt = ("_fp16", "float16") if tag else ("", "bfloat16")

    # decode
    lens = [n + MAX_TOKENS // 2 for n in PROMPT_LENS] + [0, 0]
    b = len(lens)
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen, bs)
    cache = _q8_cache(torch, gen, n_blocks, HK, D, bs)
    q = torch.randn((b, 1, H, D), generator=gen, device="cuda").to(act)
    seq_lens = _ints(torch, lens)
    q0 = (seq_lens - 1).clamp_min(0)
    calls = [lambda i=i: paged_decode_attention_q8(q, cache, i, bt, seq_lens, q0) for i in range(L)]
    kernel_ms = graph_time_ms(calls, 20) / L  # the card's time: the kernel is shorter than its launch
    eager_ms = cuda_time_ms(lambda i: calls[i % L](), 64)
    plain_ms = cuda_time_ms(lambda i: decode_attention_ref(q, cache, i % L, bt, seq_lens, q0), 8)
    out["decode_q8_err" + sfx] = compare(torch, f"{tag}int8 decode at the serving shapes",
                                   paged_decode_attention_q8(q, cache, LAYER, bt, seq_lens, q0),
                                   decode_attention_ref(q, cache, LAYER, bt, seq_lens, q0))
    _check_graph_replay(torch, lambda: paged_decode_attention_q8(q, cache, LAYER, bt, seq_lens, q0),
                        f"{tag}int8 decode")

    library_ms, library_eager_ms = _sdpa_decode_ms(
        torch, q, lens, lambda layer: _dense_kv(torch, cache, bt, lens, layer, bs, act))
    ctx = sum(lens)
    out["decode_q8" + sfx] = r = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                      **_bound("paged_decode_attention_q8", dt, b=b, s=1, h=H, hk=HK, d=D,
                                               m=m, lens=lens))
    log(f"time {tag}decode int8 B={b} S=1 Bs={bs} ctx={ctx}: kernel {kernel_ms:.4f} ms (CUDA graph; eager "
        f"{eager_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa on {dt} K/V (twice the cache bytes) {library_ms:.4f} ms (CUDA graph; "
        f"eager {library_eager_ms:.4f}), bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err "
        f"{out['decode_q8_err' + sfx]:.3g}, a CUDA graph replay bit-identical to the eager launch ({card})")

    # prefill over a cached prefix
    start, fresh = SHARED_PREFIX, PROMPT_LENS[-1] - SHARED_PREFIX
    s = -(-fresh // bs) * bs
    bt1 = _tables(torch, [start + fresh], m, -(-(start + fresh) // bs) + 8, gen, bs)
    cache1 = _q8_cache(torch, gen, int(bt1.max()) + 1, HK, D, bs)
    qp, kp, vp = (torch.randn((1, s, x, D), generator=gen, device="cuda").to(act)
                  for x in (H, HK, HK))
    pargs = (qp, kp, vp, cache1, LAYER, bt1, _ints(torch, [start + fresh]), _ints(torch, [start]))
    kernel_ms = cuda_time_ms(lambda i: paged_prefill_attention_q8(*pargs), 10)
    kernel_graph_ms = graph_time_ms([lambda: paged_prefill_attention_q8(*pargs)], 10)
    plain_ms = cuda_time_ms(lambda i: prefill_attention_ref(*pargs), 3, warmup=1)
    out["prefill_q8_err" + sfx] = compare(torch, f"{tag}int8 prefill at the serving shapes",
                                    paged_prefill_attention_q8(*pargs), prefill_attention_ref(*pargs))
    k_pre, v_pre = _dequant_rows(torch, cache1, bt1[0, :start // bs], start, dtype=act)
    ks = torch.cat([k_pre, kp[0, :fresh]]).transpose(0, 1)[None].contiguous()
    vs = torch.cat([v_pre, vp[0, :fresh]]).transpose(0, 1)[None].contiguous()
    qs = qp[:, :fresh].transpose(1, 2).contiguous()
    i = torch.arange(fresh, device="cuda")
    j = torch.arange(start + fresh, device="cuda")
    pmask = (j[None, :] < start) | (j[None, :] - start <= i[:, None])
    library_ms, library_eager_ms = _sdpa_ms(
        lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=pmask, enable_gqa=True))
    out["prefill_q8" + sfx] = r = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                       **_bound("paged_prefill_attention_q8", dt, b=1, s=s, h=H, hk=HK, d=D,
                                                m=m, starts=[start], lens=[start + fresh]))
    log(f"time {tag}prefill int8 B=1 S={s} fresh={fresh} start={start} Bs={bs}: kernel {kernel_ms:.4f} ms "
        f"(CUDA graph {kernel_graph_ms:.4f}), "
        f"plain {plain_ms:.4f} ms, sdpa on {dt} K/V {library_ms:.4f} ms (CUDA graph; eager "
        f"{library_eager_ms:.4f}), bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err "
        f"{out['prefill_q8_err' + sfx]:.3g} ({card})")
    return out


def matmul_timing(torch, card: str, dtype=None) -> dict:
    """The W8A16 kernel on one decode step's layer of the int8 model: the
    seven projections at M = 8 rows, in order, with four layers' distinct
    weights in turn (875 MB, far past the 50 MB L2), beside the plain
    version, cuBLAS bf16 on the same weights dequantised beforehand (twice
    the weight bytes; the dequantisation is not timed) and the bound.  Each
    is timed as a CUDA graph of the calls (the card's time; at M = 8 the
    host launches slower than the card runs, so eager timing measures the
    host) and, for the log, eagerly.  Also logged: each projection at M = 8,
    the layer at a prefill's M = 1504, and the lm_head at M = 8 with f32
    logits.  For ``dtype`` float16, the fp16 body beside cuBLAS fp16 (its
    readings keyed with ``_fp16``: M = 8, and the prefill's M = 1504 as
    ``matmul_prefill_fp16``; the per-projection and verify readings are the
    bf16 body's only)."""
    from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    act, tag = _act(torch, dtype)
    sfx, dt = ("_fp16", "float16") if tag else ("", "bfloat16")
    layers = [{name: _q8_weight(torch, gen, k, n, "kn") for name, (k, n) in PROJECTIONS.items()}
              for _ in range(4)]
    dense = [{name: (wq.to(act) * scale.to(act)) for name, (wq, scale)
              in layer.items()} for layer in layers]

    def rows(m):
        return {name: torch.randn((m, k), generator=gen, device="cuda").to(act)
                for name, (k, _) in PROJECTIONS.items()}

    def kernel(x, li, name):
        return int8_matmul(x, *layers[li][name])

    def plain(x, li, name):
        return int8_matmul_ref(x, *layers[li][name])

    def library(x, li, name):
        return torch.matmul(x, dense[li][name])

    def layer_calls(fn, xs, names=tuple(PROJECTIONS)):
        return [lambda li=li, name=name: fn(xs[name], li, name) for li in range(4) for name in names]

    def layer_ms(fn, xs, iters):
        """One layer's time: a graph of four layers' calls, per layer."""
        return graph_time_ms(layer_calls(fn, xs), iters) / 4

    def eager_ms(fn, xs, iters):
        calls = layer_calls(fn, xs)
        return cuda_time_ms(lambda i: [c() for c in calls], iters) / 4

    def layer_bound(m):
        return _bound("int8_matmul", dt, calls=[dict(m=m, k=k, n=n) for k, n in PROJECTIONS.values()])

    out = {}
    xs = rows(8)
    out["matmul" + sfx] = r = dict(ms=layer_ms(kernel, xs, 40), plain_ms=layer_ms(plain, xs, 8),
                                   library_ms=median_ms(lambda: layer_ms(library, xs, 40)), **layer_bound(8))
    errs = [compare(torch, f"{tag}matmul {name} at M=8", kernel(xs[name], 0, name),
                    plain(xs[name], 0, name)) for name in PROJECTIONS]
    out["matmul_err" + sfx] = max(errs)
    log(f"time {tag}matmul int8 one layer's 7 projections at M=8 (CUDA graph): kernel {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.4f} ms, cuBLAS {dt} on dequantised weights (twice the weight bytes) "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); launched eagerly: "
        f"kernel {eager_ms(kernel, xs, 16):.4f} ms, "
        f"cuBLAS {median_ms(lambda: eager_ms(library, xs, 16)):.4f} ms; "
        f"max abs err {out['matmul_err' + sfx]:.3g} ({card})")
    if tag:  # the fp16 body: the layer at a prefill's rows, then done
        xp = rows(1504)
        out["matmul_prefill" + sfx] = pre = dict(
            m=1504, ms=layer_ms(kernel, xp, 8), plain_ms=layer_ms(plain, xp, 2),
            library_ms=median_ms(lambda: layer_ms(library, xp, 8)), **layer_bound(1504),
            max_abs_err=max(compare(torch, f"{tag}matmul {name} at M=1504", kernel(xp[name], 0, name),
                                    plain(xp[name], 0, name)) for name in PROJECTIONS))
        log(f"time {tag}matmul int8 one layer's 7 projections at M=1504 (CUDA graph): kernel "
            f"{pre['ms']:.4f} ms, plain {pre['plain_ms']:.4f} ms, cuBLAS {dt} {pre['library_ms']:.4f} ms, "
            f"bound {pre['bound_ms']:.4f} ms ({pre['bound_by']}), max abs err {pre['max_abs_err']:.3g} "
            f"({card})")
        del layers, dense
        torch.cuda.empty_cache()
        return out
    per = {name: graph_time_ms(layer_calls(kernel, xs, (name,)), 40) / 4 for name in PROJECTIONS}
    bounds = {name: _bound("int8_matmul", m=8, k=k, n=n)["bound_ms"]
              for name, (k, n) in PROJECTIONS.items()}
    log("time matmul int8 at M=8 by projection (CUDA graph): " + ", ".join(
        f"{name} [{k}, {n}] {per[name]:.4f} ms (bound {bounds[name]:.4f})"
        for name, (k, n) in PROJECTIONS.items()) + f" ({card})")
    # the verify's rows: B = 8 slots x S = k + 1 = 5
    m_verify = 8 * (SPEC_VERIFY_S[0])
    xv = rows(m_verify)
    out["matmul_verify"] = dict(m=m_verify, ms=layer_ms(kernel, xv, 40),
                                plain_ms=layer_ms(plain, xv, 8),
                                library_ms=median_ms(lambda: layer_ms(library, xv, 40)),
                                **layer_bound(m_verify))
    v = out["matmul_verify"]
    log(f"time matmul int8 one layer's 7 projections at M={m_verify} (the verify at S=5, CUDA "
        f"graph): kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, cuBLAS bf16 on dequantised "
        f"weights {v['library_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms ({v['bound_by']}); "
        f"max abs err {max(compare(torch, f'matmul {n} at M={m_verify}', kernel(xv[n], 0, n), plain(xv[n], 0, n)) for n in PROJECTIONS):.3g} "
        f"({card})")
    xp = rows(1504)
    pre = dict(ms=layer_ms(kernel, xp, 8), library_ms=median_ms(lambda: layer_ms(library, xp, 8)),
               **layer_bound(1504))
    per = {name: graph_time_ms(layer_calls(kernel, xp, (name,)), 8) / 4 for name in PROJECTIONS}
    log(f"time matmul int8 one layer's 7 projections at M=1504 (CUDA graph): kernel {pre['ms']:.4f} ms, "
        f"cuBLAS bf16 {pre['library_ms']:.4f} ms, bound {pre['bound_ms']:.4f} ms ({pre['bound_by']}); by "
        f"projection " + ", ".join(f"{name} {v:.4f}" for name, v in per.items()) + f" ({card})")
    del layers, dense
    k, n = LM_HEAD
    heads = [_q8_weight(torch, gen, k, n, "kn") for _ in range(2)]
    x = torch.randn((8, k), generator=gen, device="cuda").to(torch.bfloat16)
    head_ms = graph_time_ms([lambda i=i: int8_matmul(x, *heads[i], torch.float32) for i in range(2)],
                            20) / 2
    dense_head = heads[0][0].to(torch.bfloat16) * heads[0][1].to(torch.bfloat16)
    head_lib = median_ms(lambda: cuda_time_ms(
        lambda i: torch.mm(x, dense_head, out_dtype=torch.float32), 16))
    hb = _bound("int8_matmul", m=8, k=k, n=n, out_bytes=4)
    log(f"time matmul int8 lm_head [{k}, {n}] at M=8, f32 out (CUDA graph): kernel {head_ms:.4f} ms, cuBLAS "
        f"bf16 {head_lib:.4f} ms (one weight, L2-warm for weights under 50 MB), bound {hb['bound_ms']:.4f} ms "
        f"({hb['bound_by']}) ({card})")
    return out


def verify_timing(torch, card: str) -> dict:
    """B1 (Bs 16) and B4a (Bs 32, the int8 path's block) at the verify shape:
    one layer of a verify over the eight slots (the six requests
    mid-generation, 3,865 tokens, and two empty rows) at S = 5 and 8 (k = 4
    and 7), a CUDA graph of the 32 layers' calls (the card's time), beside
    the plain version, SDPA on dense K/V (bf16; dequantised for the int8
    cache) timed the same way, and the bound.  Returns {"decode_verify":
    {S: reading}, "decode_q8_verify": {S: reading}}."""
    from dynamo_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention, paged_decode_attention_q8)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    lens = [n + MAX_TOKENS // 2 for n in PROMPT_LENS] + [0, 0]
    b = len(lens)
    seq_lens = _ints(torch, lens)
    out = {}
    for quant in (False, True):
        bs = BS_Q8 if quant else BS
        m = 2048 // bs
        n_blocks = sum(-(-n // bs) for n in lens) + 8
        bt = _tables(torch, lens, m, n_blocks, gen, bs)
        if quant:
            cache = _q8_cache(torch, gen, n_blocks, HK, D, bs)
        else:
            cache = torch.randn((L, n_blocks, 2, bs, HK * D), generator=gen,
                                device="cuda").to(torch.bfloat16)
        kernel = paged_decode_attention_q8 if quant else paged_decode_attention

        key = "decode_q8_verify" if quant else "decode_verify"
        out[key] = {}
        for s in SPEC_VERIFY_S:
            q = torch.randn((b, s, H, D), generator=gen, device="cuda").to(torch.bfloat16)
            q0 = (seq_lens - s).clamp_min(0)
            calls = [lambda i=i: kernel(q, cache, i, bt, seq_lens, q0) for i in range(L)]
            kernel_ms = graph_time_ms(calls, 20) / L
            eager_ms = cuda_time_ms(lambda i: calls[i % L](), 64)
            plain_ms = cuda_time_ms(lambda i: decode_attention_ref(q, cache, i % L, bt, seq_lens, q0), 8)
            err = compare(torch, f"{key} S={s}", kernel(q, cache, LAYER, bt, seq_lens, q0),
                          decode_attention_ref(q, cache, LAYER, bt, seq_lens, q0))
            library_ms, library_eager_ms = _sdpa_decode_ms(
                torch, q, lens, lambda layer: _dense_kv(torch, cache, bt, lens, layer, bs), q0=q0)
            ctx = sum(lens)
            out[key][f"S={s}"] = r = dict(
                ms=kernel_ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=err,
                **_bound("paged_decode_attention_q8" if quant else "paged_decode_attention", b=b, s=s,
                         h=H, hk=HK, d=D, m=m, lens=lens))
            log(f"time decode {'int8 Bs=32' if quant else 'bf16 Bs=16'} B={b} S={s} (verify) "
                f"ctx={ctx}: kernel {kernel_ms:.4f} ms (CUDA graph; eager {eager_ms:.4f}), plain "
                f"{plain_ms:.4f} ms, sdpa{' on bf16 K/V' if quant else ''} {library_ms:.4f} ms "
                f"(CUDA graph; eager {library_eager_ms:.4f}), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), max abs err {err:.3g} ({card})")
        del cache
    return out


def ragged_timing(torch, card: str, mixed: dict, quant: bool = False, dtype=None) -> dict:
    """The ragged kernel at the largest mixed dispatch a token-budget
    serving run made (its row table and block size as recorded; random bf16
    q and K/V, a random bf16 or int8 pool; fp16 for ``dtype`` float16, the
    fp16 bodies), timed beside its plain version, one SDPA call on the same
    work laid out dense with a block-diagonal causal mask (the prefix
    gather, and for an int8 pool its dequantisation to the activation type,
    excluded), and its bound on this card."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
        ragged_paged_prefill_attention, ragged_paged_prefill_attention_q8,
        ragged_prefill_attention_ref)
    from dynamo_tpu_torch.ops.kv_quant import gather_layer_blocks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    t, bt, lens, starts, offs, bs = (mixed[k] for k in ("t", "bt", "lens", "starts", "offs", "bs"))
    act, tag = _act(torch, dtype)
    n_blocks = int(bt.max()) + 1
    if quant:
        cache = _q8_cache(torch, gen, n_blocks, HK, D, bs)
    else:
        cache = torch.randn((L, n_blocks, 2, bs, HK * D), generator=gen,
                            device="cuda").to(act)
    kernel = ragged_paged_prefill_attention_q8 if quant else ragged_paged_prefill_attention
    q = torch.randn((1, t, H, D), generator=gen, device="cuda").to(act)
    k = torch.randn((1, t, HK, D), generator=gen, device="cuda").to(act)
    v = torch.randn((1, t, HK, D), generator=gen, device="cuda").to(act)
    rows = (_ints(torch, lens), _ints(torch, starts), _ints(torch, offs))
    # successive launches walk the 32 layers, as a serving dispatch does
    kernel_ms = cuda_time_ms(lambda i: kernel(q, k, v, cache, i % L, bt, *rows), 32)
    plain_ms = cuda_time_ms(lambda i: ragged_prefill_attention_ref(
        q, k, v, cache, i % L, bt, *rows), 3, warmup=1)
    label = tag + ("int8 ragged" if quant else "ragged")
    err = compare(torch, f"{label} at the serving dispatch",
                  kernel(q, k, v, cache, LAYER, bt, *rows),
                  ragged_prefill_attention_ref(q, k, v, cache, LAYER, bt, *rows))
    # what the decode rows cost: the same dispatch with the decode rows'
    # spans emptied (seq_len = start) runs the span blocks alone.
    dec = [r for r, (st, n, o) in enumerate(zip(starts, lens, offs)) if n - st == 1 and o == r]
    spans_only = [st if r in dec else n for r, (st, n) in enumerate(zip(starts, lens))]
    spans_rows = (_ints(torch, spans_only), rows[1], rows[2])
    spans_ms = cuda_time_ms(lambda i: kernel(q, k, v, cache, i % L, bt, *spans_rows), 32)

    # dense layout: each live row's queries; its prefix then its fresh keys
    qs, ks, vs, spans = [], [], [], []
    u = 0
    for r, (st, n, o) in enumerate(zip(starts, lens, offs)):
        f = n - st
        if f <= 0:
            continue
        kv = gather_layer_blocks(cache, LAYER, bt[r, :-(-st // bs)], HK).to(act)
        ks += [kv[:, 0].reshape(-1, HK, D)[:st], k[0, o:o + f]]
        vs += [kv[:, 1].reshape(-1, HK, D)[:st], v[0, o:o + f]]
        qs.append(q[0, o:o + f])
        spans.append((u, st, f))
        u += st + f
    qd = torch.cat(qs).transpose(0, 1)[None].contiguous()
    kd = torch.cat(ks).transpose(0, 1)[None].contiguous()
    vd = torch.cat(vs).transpose(0, 1)[None].contiguous()
    mask = torch.zeros((qd.shape[2], u), dtype=torch.bool, device="cuda")
    row0 = 0
    for base, st, f in spans:
        i = torch.arange(f, device="cuda")
        mask[row0:row0 + f, base:base + st] = True
        mask[row0:row0 + f, base + st:base + st + f] = i[None, :] <= i[:, None]
        row0 += f
    library_ms = median_ms(lambda: cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), 10))

    out = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               **_bound("ragged_paged_prefill_attention" + ("_q8" if quant else ""),
                        "float16" if tag else "bfloat16", t=t, h=H, hk=HK, d=D, m=bt.shape[1],
                        starts=list(starts), lens=list(lens)))
    log(f"time {label} T={t} Bs={bs} rows={len(spans)}, starts {starts}, seq_lens {lens}: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}), max abs err {err:.3g}; without its "
        f"{len(dec)} decode rows the kernel takes {spans_ms:.4f} ms ({card})")
    out["err"] = err
    return out


# --------------------------------------------------------- mixture of experts
# (experts, top k, hidden, expert width): Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B
# config.json), served below, and Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1
# config.json), 93 GB in bf16, so only one layer's expert stack is checked
# one DeepSeek-V2-Lite MoE layer (deepseek-ai/DeepSeek-V2-Lite config.json:
# 64 routed experts, top 6, hidden 2048, expert width 1408): (experts, top
# k, its three launches' [K, N])
V2_LITE_MOE = (64, 6, {"w_gate": (2048, 1408), "w_up": (2048, 1408), "w_down": (1408, 2048)})
MOE_GEOMS = {"Qwen3-30B-A3B": (MOE_EXPERTS, MOE_TOP_K, *MOE_LAUNCHES["w_gate"]),
             "Mixtral-8x7B": (8, 2, 4096, 14336),
             "DeepSeek-V2-Lite": (*V2_LITE_MOE[:2], *V2_LITE_MOE[2]["w_gate"])}
# tokens per check: one decode row, a decode step at 8 slots, the longest
# prompt, and a dispatch of 3,765 tokens (the six prompts' total)
MOE_CHECK_TOKENS = {"Qwen3-30B-A3B": (1, 8, 1504, 3765), "Mixtral-8x7B": (8, 1504),
                    "DeepSeek-V2-Lite": (1, 8, 1504)}
# the grouped kernel's edges: 5 experts of [144, N] and [N, 144] (a depth
# off the 64-deep sub-tile, N off the 128-channel tile and bf16's 64-channel
# TMA box: 200 is a multiple of 8, as bf16 needs, 208 of 16, as int8
# needs), top 2 of 5, 37 and 300 tokens (the 8-, 32- and 128-row tiles)
MOE_EDGE = dict(experts=5, k=2, depth=144, n={False: 200, True: 208}, tokens=(5, 37, 300))


def qwen3_30b_a3b(num_layers: int = 48):
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=151936, hidden_size=2048, intermediate_size=768,
                       num_layers=num_layers, num_heads=32, num_kv_heads=4, head_dim=128,
                       rope_theta=1e6, rms_norm_eps=1e-6, max_position_embeddings=40960,
                       qk_norm=True, num_experts=128, num_experts_per_tok=8, norm_topk_prob=True,
                       dtype="bfloat16")


def _expert_stack(torch, gen, experts, k, n, quant):
    """``cuda_timing.moe_stack``, an int8 stack as a QTensor."""
    from dynamo_tpu_torch.models.quant import QTensor

    w = moe_stack(gen, experts, k, n, quant)
    return QTensor(*w) if quant else w


def _grouped(quant):
    """(kernel, plain version) of E2 (``quant``) or E1, taking (x, w, offsets)
    with w a QTensor for E2."""
    from dynamo_tpu_torch.ops.kernels import grouped_matmul as g

    if quant:
        return (lambda x, w, o: g.grouped_matmul_q8(x, w.q, w.scale, o),
                lambda x, w, o: g.grouped_matmul_q8_ref(x, w.q, w.scale, o))
    return g.grouped_matmul, g.grouped_matmul_ref


def moe_kernel_phase(torch, gen) -> dict:
    """The grouped expert kernels (E1 bf16, E2 int8) against their plain
    versions at Qwen3-30B-A3B's expert shapes ([2048, 768] gate/up, [768,
    2048] down) for 1, 8, 1,504 and 3,765 tokens of top-8 rows, and at one
    Mixtral-8x7B layer's ([4096, 14336], [14336, 4096]) for 8 and 1,504
    tokens of top-2 rows, each with uniform routing and with every row on
    one expert (the others empty), and at the tile edges (``MOE_EDGE``);
    every launch run twice for the same bits.  Then the MoE MLP as a whole (router, sort, three grouped
    launches, combine) against the dense oracle, bf16 and int8."""
    errs = {"moe": 0.0, "moe_q8": 0.0}
    for model, (experts, k, dm, f) in MOE_GEOMS.items():
        for quant in (False, True):
            key = "moe_q8" if quant else "moe"
            kernel, plain = _grouped(quant)
            stacks = {"gate/up": (dm, _expert_stack(torch, gen, experts, dm, f, quant)),
                      "down": (f, _expert_stack(torch, gen, experts, f, dm, quant))}
            worst = 0.0
            for t in MOE_CHECK_TOKENS[model]:
                for routing in ("uniform", "one"):
                    offsets = moe_offsets(gen, t, experts, k, routing)
                    for name, (kdim, w) in stacks.items():
                        x = torch.randn((t * k, kdim), generator=gen, device="cuda").to(torch.bfloat16)
                        what = f"{key} {model} {name} T={t} ({t * k} rows) {routing}"
                        out = kernel(x, w, offsets)
                        check(torch.equal(out, kernel(x, w, offsets)), f"{what}: two launches differ")
                        worst = max(worst, compare(torch, what, out, plain(x, w, offsets)))
            log(f"kernel {key} {model} ({experts} experts, top {k}, [{dm}, {f}] and [{f}, {dm}]) "
                f"T in {MOE_CHECK_TOKENS[model]}, uniform and one-expert routing: max abs err {worst:.3g}, "
                f"every launch twice bit-identical")
            errs[key] = max(errs[key], worst)
            del stacks
            torch.cuda.empty_cache()
    for quant in (False, True):
        kernel, plain = _grouped(quant)
        e, k, kd, n = MOE_EDGE["experts"], MOE_EDGE["k"], MOE_EDGE["depth"], MOE_EDGE["n"][quant]
        worst = 0.0
        for a, b in ((kd, n), (n, kd)):
            w = _expert_stack(torch, gen, e, a, b, quant)
            for t in MOE_EDGE["tokens"]:
                offsets = moe_offsets(gen, t, e, k, "uniform")
                x = torch.randn((t * k, a), generator=gen, device="cuda").to(torch.bfloat16)
                what = f"{'moe_q8' if quant else 'moe'} edge [{a}, {b}] T={t}"
                out = kernel(x, w, offsets)
                check(torch.equal(out, kernel(x, w, offsets)), f"{what}: two launches differ")
                worst = max(worst, compare(torch, what, out, plain(x, w, offsets)))
        log(f"kernel {'moe_q8' if quant else 'moe'} edges: {e} experts, [{kd}, {n}] and [{n}, {kd}], "
            f"T in {MOE_EDGE['tokens']}: max abs err {worst:.3g}, every launch twice bit-identical")
        errs["moe_q8" if quant else "moe"] = max(errs["moe_q8" if quant else "moe"], worst)
    moe_mlp_check(torch, gen)
    return errs


def moe_mlp_check(torch, gen) -> None:
    """``_moe_mlp_grouped`` (the serving path: router, stable sort, the
    grouped kernel, the inverse-permutation combine) against
    ``_moe_mlp_dense`` (every expert on every token, cuBLAS) on the card at
    Qwen3-30B-A3B width, bf16 and int8 experts, one layer."""
    from dynamo_tpu_torch.models.llama import _moe_mlp_dense, _moe_mlp_grouped

    cfg = qwen3_30b_a3b(1)
    experts, _, dm, f = MOE_GEOMS["Qwen3-30B-A3B"]
    router = (torch.randn((dm, experts), generator=gen, device="cuda") / math.sqrt(dm)).to(torch.bfloat16)
    for quant in (False, True):
        lp = {"router": router, "w_gate": _expert_stack(torch, gen, experts, dm, f, quant),
              "w_up": _expert_stack(torch, gen, experts, dm, f, quant),
              "w_down": _expert_stack(torch, gen, experts, f, dm, quant)}
        errs = []
        for t in (1, 8, 64):
            x = torch.randn((1, t, dm), generator=gen, device="cuda").to(torch.bfloat16)
            got = _moe_mlp_grouped(cfg, lp, x)
            check(torch.equal(got, _moe_mlp_grouped(cfg, lp, x)), f"moe MLP T={t}: two runs differ")
            errs.append(compare(torch, f"moe MLP {'int8' if quant else 'bf16'} T={t}", got,
                                _moe_mlp_dense(cfg, lp, x)))
        log(f"kernel moe MLP (router + grouped dispatch + combine) vs the dense oracle, Qwen3-30B-A3B "
            f"width, {'int8' if quant else 'bf16'} experts, T = 1, 8, 64: max abs err {max(errs):.3g}, "
            f"two runs bit-identical")
        del lp
    torch.cuda.empty_cache()


def moe_timing(torch, card: str) -> dict:
    """One MoE layer's three grouped launches (gate and up on the sorted
    rows, down on the activations), uniform routing, at a decode step (T =
    8) and at the longest prompt's prefill (T = 1,504), two layers' stacks
    in turn (past the 50 MB L2): E1 and E2 at Qwen3-30B-A3B's launches
    (``cuda_timing.MOE_LAUNCHES``: 64 and 12,032 rows), and E1 at
    DeepSeek-V2-Lite's (``V2_LITE_MOE``: 48 and 9,024 rows).  The kernel as
    a CUDA graph (the card's time) and eagerly, the plain version, the
    per-expert cuBLAS loop over the same groups as a CUDA graph (int8: on
    the experts dequantised beforehand), ``torch._grouped_mm`` where this
    torch has it (the ``library_ms``; int8: on dequantised experts), and the
    bound: the weight bytes of the experts the rows route to (counted), x
    and every launch's input and output once, against 2 R K N per launch
    (the registry's work cost of the three launches).  Returns each kernel's Qwen3 T = 8
    row, with its T = 1,504 row under ``t1504`` and E1's DeepSeek-V2-Lite
    rows under ``deepseek_v2_lite``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    out = {}
    for quant in (False, True):
        key = "moe_q8" if quant else "moe"
        rows = _moe_layer_times(torch, card, gen, quant, "Qwen3-30B-A3B", MOE_EXPERTS, MOE_TOP_K,
                                MOE_LAUNCHES)
        (row8, err8), (row1504, err1504) = (rows[t] for t in MOE_TOKENS)
        out[key] = dict(row8, t1504=row1504)
        out[key + "_err"] = max(err8, err1504)
    rows = _moe_layer_times(torch, card, gen, False, "DeepSeek-V2-Lite", *V2_LITE_MOE)
    out["moe"]["deepseek_v2_lite"] = {f"t{t}": row for t, (row, _) in rows.items()}
    out["moe_err"] = max(out["moe_err"], *(err for _, err in rows.values()))
    return out


def _moe_layer_times(torch, card: str, gen, quant: bool, model: str, experts: int, top_k: int,
                     names: dict) -> dict:
    """``moe_timing`` for one kernel at one model's launches ``names``
    (name -> [K, N]): {T: (row, max abs err)} for T in MOE_TOKENS."""
    from dynamo_tpu_torch.models.quant import dequantize

    key = "moe_q8" if quant else "moe"
    kernel, plain = _grouped(quant)
    layers = [{n: _expert_stack(torch, gen, experts, kd, nd, quant) for n, (kd, nd) in names.items()}
              for _ in range(2)]
    dense = [{n: dequantize(w, torch.bfloat16) for n, w in layer.items()} for layer in layers]
    out = {}
    for t in MOE_TOKENS:
        r = t * top_k
        offsets = moe_offsets(gen, t, experts, top_k)
        bounds = offsets.tolist()
        groups = [(e, bounds[e], bounds[e + 1]) for e in range(experts) if bounds[e + 1] > bounds[e]]
        xs = {"w_gate": torch.randn((r, names["w_gate"][0]), generator=gen, device="cuda").to(torch.bfloat16)}
        xs["w_up"] = xs["w_gate"]
        xs["w_down"] = torch.randn((r, names["w_down"][0]), generator=gen, device="cuda").to(torch.bfloat16)
        outs = {n: torch.empty((r, nd), dtype=torch.bfloat16, device="cuda") for n, (_, nd) in names.items()}

        def calls(fn):
            return [lambda li=li, n=n: fn(xs[n], layers[li][n], offsets) for li in range(2) for n in names]

        def cublas():
            for li in range(2):
                for n in names:
                    for e, lo, hi in groups:
                        torch.matmul(xs[n][lo:hi], dense[li][n][e], out=outs[n][lo:hi])

        iters = 20 if t == 8 else 5
        ms = graph_time_ms(calls(kernel), iters) / 2
        eager = cuda_time_ms(lambda i: [c() for c in calls(kernel)], iters) / 2
        plain_ms = cuda_time_ms(lambda i: [c() for c in calls(plain)], 3) / 2
        loop_ms = median_ms(lambda: graph_time_ms([cublas], iters) / 2)
        lib_ms = None
        if hasattr(torch, "_grouped_mm"):
            ends = offsets[1:].contiguous()
            try:
                lib_ms = median_ms(lambda: graph_time_ms([
                    lambda li=li, n=n: torch._grouped_mm(xs[n], dense[li][n], offs=ends)
                    for li in range(2) for n in names], iters) / 2)
            except RuntimeError as e:  # a yardstick this torch cannot run is recorded, not used
                log(f"time {key}: torch._grouped_mm did not run here: {str(e)[:200]}")
        err = max(compare(torch, f"{key} {model} timing {n} T={t}", calls(kernel)[i](), calls(plain)[i]())
                  for i, n in enumerate(names))
        cost = kreg.work_cost(key.replace("moe", "grouped_matmul"), {"calls": [
            dict(r=r, k=kd, n=nd, live=len(groups)) for kd, nd in names.values()]})
        flops, nbytes = cost["flops"], cost["hbm_bytes"]
        b = kreg.bound(cost)
        out[t] = (dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b), err)
        log(f"time {key} one {model} layer's 3 grouped launches at T={t} ({r} rows, "
            f"{len(groups)} of {experts} experts routed to): kernel {ms:.4f} ms (CUDA graph), "
            f"eager {eager:.4f} ms, plain {plain_ms:.4f} ms, per-expert cuBLAS loop "
            f"{'on dequantised experts ' if quant else ''}{loop_ms:.4f} ms (CUDA graph), "
            f"torch._grouped_mm {'not available' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
            f"max abs err {err:.3g} ({card})")
    del layers, dense
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ serving
def llama3_8b(num_layers: int = 32):
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                       num_layers=num_layers, num_heads=32, num_kv_heads=8,
                       max_position_embeddings=8192, rope_theta=500000.0, dtype="bfloat16")


def prompts(seed: int = 0, vocab: int = 128256) -> list[list[int]]:
    """The six prompts, token ids below ``vocab`` (Llama 3's unless named)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    out = []
    for i, n in enumerate(PROMPT_LENS):
        if i >= len(PROMPT_LENS) - 2:  # the two sharing a prefix
            out.append(shared + rng.integers(0, vocab, n - SHARED_PREFIX).tolist())
        else:
            out.append(rng.integers(0, vocab, n).tolist())
    return out


def model_prompts(model, seed: int = 0) -> list[list[int]]:
    """The six prompts for ``model``: Llama 3's ids, or below a smaller
    vocabulary (DeepSeek's 102,400)."""
    return prompts(seed, min(LLAMA3_VOCAB, model.config.vocab_size))


async def _serve(engine, reqs, sampling=None, max_tokens: int = MAX_TOKENS, tag: str = "req"):
    """Each request of ``reqs`` (token ids) concurrently, greedy or with
    ``sampling[i]`` (SamplingOptions fields), ``max_tokens`` tokens at most,
    as ids ``{tag}-{i}`` (a warm-up takes another tag: the engine may apply
    a late abort of a finished id to the next request of that id):
    [(TTFT, seconds to the end, outputs)]."""
    from dynamo_tpu_torch.llm.protocols import BackendInput, SamplingOptions, StopConditions
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(i, toks):
        t0 = time.perf_counter()
        first, outs = None, []
        opts = SamplingOptions(**(sampling[i] if sampling else {"temperature": 0.0}))
        ctx = Context(BackendInput(token_ids=toks, sampling=opts,
                                   stops=StopConditions(max_tokens=max_tokens)), id=f"{tag}-{i}")
        async for out in engine.generate(ctx):
            if first is None and out.token_ids:
                first = time.perf_counter() - t0
            outs.append(out)
        return first, time.perf_counter() - t0, outs

    return await asyncio.gather(*(one(i, t) for i, t in enumerate(reqs)))


def _kernel_wrappers() -> dict:
    from dynamo_tpu_torch.ops.kernels import wrappers

    return wrappers()


def _timeline_state(core) -> dict:
    snap = core.timeline.snapshot()
    snap["host_gap_s"] = core.timeline.host_gap_s_total
    return snap


def timeline_line(core, before: dict, dispatches: int, label: str, card: str) -> dict:
    """The step timeline over one serving run (the engine's timeline read
    before and after it): the phases' ms a busy step, each dispatch kind's
    count and ms beside the perf model's prediction, and the host gap as
    the timeline defines it (wall - dispatch - overlap - readback) beside
    the definition it replaced (wall - the blocking result reads).  Logged
    as one ``{"timeline": ...}`` line."""
    after = _timeline_state(core)
    busy = after["busy_steps_total"] - before["busy_steps_total"]
    wall = after["wall_seconds_total"] - before["wall_seconds_total"]
    phases = {p: after["phases"][p] - before["phases"][p] for p in after["phases"]}
    kinds = {}
    for k, v in after["dispatch_kinds"].items():
        b = before["dispatch_kinds"].get(k, {"seconds": 0.0, "count": 0})
        n = v["count"] - b["count"]
        if n:
            ms = 1e3 * (v["seconds"] - b["seconds"]) / n
            pred = core.perf_model.predicted_ms(k)
            kinds[k] = dict(count=n, ms=round(ms, 4), predicted_ms=pred,
                            predicted_over_measured=pred / ms if pred and ms else None)
    check(busy > 0 and sum(v["count"] for v in kinds.values()) == dispatches,
          f"{label} timeline: {busy} busy steps, kinds {kinds}, {dispatches} dispatches")
    check(abs(sum(phases.values()) - wall) <= 1e-3 * wall + 1e-6,
          f"{label} timeline: phases sum to {sum(phases.values())} s of {wall} s wall")
    out = dict(label=label, steps=after["steps_total"] - before["steps_total"], busy_steps=busy,
               wall_ms_per_busy_step=round(1e3 * wall / busy, 4),
               phase_ms_per_busy_step={p: round(1e3 * v / busy, 4) for p, v in phases.items()},
               kinds=kinds,
               host_gap_ms_per_turn=round(1e3 * (after["host_gap_s"] - before["host_gap_s"]) / busy,
                                          4),
               host_gap_old_ms_per_turn=round(1e3 * (wall - phases["readback"]) / busy, 4),
               card=card)
    log(json.dumps({"timeline": out}))
    return out


def serve_run(torch, model, config: dict, card: str, label: str, profile: bool = False,
              timeline: bool = False, perf: bool = False, trace: bool = False) -> dict:
    """Serve the six requests once through ``AsyncLLMEngine`` under one
    EngineConfig, with every kernel's launch counter zeroed just before and
    read just after; returns the streams, launches and engine counters
    (and, with ``timeline``, the run's step timeline line, the perf model
    priced on the run's own first dispatch of each kind), the cached and
    prompt tokens and the engine's KV bytes a block (the load phase's
    inputs).  With ``profile`` the traffic runs once more under the
    profiler, and with ``perf`` too that run's forwards are timed on the
    card for the ``perf`` line.  With ``trace`` the card's peak memory is
    reset before the engine is built and read after the run, and every
    dispatch is recorded (``analysis/tracecheck.py``) for the ``trace``
    line."""
    from dynamo_tpu_torch.analysis.tracecheck import record_dispatches, undeclared_dispatches
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.llm.protocols import FinishReason

    if trace:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    recording = record_dispatches(EngineConfig(**config)) if trace else contextlib.nullcontext()
    with recording as dispatched:
        out = _serve_run(torch, model, config, card, label, profile, timeline, perf)
    if trace:
        torch.cuda.synchronize()
        out["trace"] = dict(max_memory_allocated=torch.cuda.max_memory_allocated(),
                            allocated_before_engine=before,
                            weights=sum(p.numel() * p.element_size() for p in model.parameters()),
                            dispatches=dispatched.total(),
                            signatures={k: sorted(v) for k, v in dispatched.labels().items()},
                            undeclared=undeclared_dispatches(dispatched, model.config))
    return out


def _serve_run(torch, model, config: dict, card: str, label: str, profile: bool,
               timeline: bool, perf: bool) -> dict:
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.llm.protocols import FinishReason

    core = EngineCore(model, EngineConfig(**config), device="cuda")
    engine = AsyncLLMEngine(core).start()
    try:
        # warm-up request: first-launch costs stay out of the measurement
        asyncio.run(_serve(engine, [list(range(1, 40))], tag="warm-up"))
        wrappers = _kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
            if hasattr(fn, "launches_fp16"):
                fn.launches_fp16 = 0
        core.perf_model.reset()
        before_tl = _timeline_state(core)
        before = (core.steps, core.overlap_s, core.read_wait_s)
        t0 = time.perf_counter()
        results = asyncio.run(_serve(engine, model_prompts(model)))
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        launches_fp16 = {name: fn.launches_fp16 for name, fn in wrappers.items()
                         if hasattr(fn, "launches_fp16")}
        # a step boundary: the run's last step has ended on the timeline
        asyncio.run(engine.run_on_engine(lambda: None))
        metrics = core.metrics()
        kv_block = core.kv_bytes_per_block()
        dispatches = core.steps - before[0]
        tl = timeline_line(core, before_tl, dispatches, label, card) if timeline else None
        overlap_ms = 1e3 * (core.overlap_s - before[1]) / dispatches
        wait_ms = 1e3 * (core.read_wait_s - before[2]) / dispatches
        for i, (_, _, outs) in enumerate(results):
            toks = [t for o in outs for t in o.token_ids]
            check(outs[-1].finish_reason is FinishReason.LENGTH,
                  f"{label} request {i}: finish {outs[-1].finish_reason}, expected length")
            check(len(toks) == MAX_TOKENS, f"{label} request {i}: {len(toks)} tokens")
            check(all(0 <= t < model.config.vocab_size for t in toks),
                  f"{label} request {i}: token out of range")
        cached = [outs[-1].cached_tokens for _, _, outs in results]
        check(max(cached[-2:]) >= SHARED_PREFIX,
              f"{label}: no request reused the shared {SHARED_PREFIX}-token prefix: {cached}")
        ttfts = [r[0] for r in results]
        decode_tokens = len(results) * (MAX_TOKENS - 1)
        decode_window = wall - min(ttfts)
        counters = {k: metrics[k] for k in (
            "prefill_dispatches_total", "prefill_batch_occupancy", "unified_dispatches_total",
            "unified_decode_rows", "unified_prefill_tokens", "lookahead_bursts_total",
            "lookahead_hits_total", "lookahead_mispredicts_total", "lookahead_commits_total",
            "lookahead_flushes_total", "device_gets_total")}
        log(f"serving {label}: {len(results)} requests, wall {wall:.3f} s, TTFT min/median/max "
            f"{min(ttfts):.3f}/{sorted(ttfts)[len(ttfts) // 2]:.3f}/{max(ttfts):.3f} s, decode "
            f"{decode_tokens / decode_window:.1f} tok/s over {decode_window:.3f} s, cached {cached}, "
            f"host gap {metrics['host_gap_ms_per_turn']:.2f} ms/turn, {dispatches} dispatches, "
            f"per dispatch: overlap-window host work {overlap_ms:.2f} ms, result-read wait "
            f"{wait_ms:.2f} ms, launches {launches}, counters {json.dumps(counters)} ({card})")
        if profile:
            profile_serving(torch, engine, model_prompts(model, seed=1), card,
                            model=model if perf else None)
    finally:
        engine.shutdown()
    streams = [[t for o in outs for t in o.token_ids] for _, _, outs in results]
    return dict(launches=launches, launches_fp16=launches_fp16, metrics=metrics, streams=streams,
                ttfts=ttfts, decode_tok_s=decode_tokens / decode_window, timeline=tl, cached=cached,
                prompt_tokens=[len(p) for p in model_prompts(model)],
                kv_bytes_per_block=kv_block)


LOAD_FIGURES = ("prefill_ms_per_token", "decode_ms_per_step", "router_ms_per_decision",
                "kv_bytes_per_block")
LOAD_LINT_S = 120  # the lint subprocesses' limit
LOAD_LINTS = ("--load", "--project", "--wire", "--metrics", "--kern", "--perf", "--trace",
              "--shard")


def _lint_clock(proc) -> None:
    """Wait for a lint subprocess and note its wall seconds from start to
    exit (its output is a few lines, well inside the pipe's buffer)."""
    proc.wait()
    proc.seconds = time.perf_counter() - proc.started


def start_lints() -> dict:
    """``python -m dynamo_tpu_torch lint --load``, ``--project``,
    ``--wire``, ``--metrics``, ``--kern``, ``--perf``, ``--trace`` and
    ``--shard`` as subprocesses,
    started while the kernels build: the committed surfaces, baseline and
    manifests, checked on this machine's Python and torch.  The load phase
    reads them; ``stop_lints`` ends whatever is left."""
    lints = {}
    for flag in LOAD_LINTS:
        proc = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch", "lint", flag],
                                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        proc.started, proc.seconds = time.perf_counter(), None
        proc.clock = threading.Thread(target=_lint_clock, args=(proc,), daemon=True)
        proc.clock.start()
        lints[flag] = proc
    return lints


# the compile and sharding planes' predictions for this run's configs, walked
# on meta tensors in a subprocess started with the lints (the walk patches
# the kernel wrappers process-wide, so it never runs beside the card's work)
ANALYSIS_SCRIPT = """
import json, sys
from dynamo_tpu_torch.analysis.shardcheck import census_at
from dynamo_tpu_torch.analysis.tracecheck import footprint
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.models.config import ModelConfig
a = json.loads(sys.argv[1])
cfg = EngineConfig(**a["engine"])
print(json.dumps(dict(
    footprint=footprint(ModelConfig(**a["trace_model"]), cfg),
    census=census_at(ModelConfig(**a["shard_model"]), (1, 2), cfg.num_blocks, cfg.block_size,
                     batch=cfg.max_batch_size, m=cfg.max_blocks_per_seq,
                     num_steps=cfg.decode_steps))))
"""


def start_analysis() -> subprocess.Popen:
    """TR007's footprint of the 32-layer bf16 default run's config and the
    shard census at (1, 2) of the mesh phase's bf16 pair (MESH_BF16_LAYERS
    layers, the same config), as one JSON document on the subprocess's
    stdout; read by :func:`trace_line` and the mesh phase's ``shard``
    line."""
    arg = json.dumps(dict(engine=DEFAULT_PATH,
                          trace_model=dataclasses.asdict(llama3_8b(32)),
                          shard_model=dataclasses.asdict(llama3_8b(MESH_BF16_LAYERS))))
    proc = subprocess.Popen([sys.executable, "-c", ANALYSIS_SCRIPT, arg], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.started = time.perf_counter()
    return proc


# the walk is read after the bf16 serving phase, ~200 s into the run; it took
# 209-217 s beside the build on an H100 host
ANALYSIS_WAIT_S = 600


def read_analysis(proc: subprocess.Popen) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=ANALYSIS_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        check(False, f"trace: the footprint and census walk ran past {ANALYSIS_WAIT_S} s")
    check(proc.returncode == 0, f"trace: the footprint and census walk exited {proc.returncode}:"
          f"\n{stderr[-4000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    out["seconds"] = round(time.perf_counter() - proc.started, 3)
    return out


def trace_line(default: dict, analysis: dict, card: str) -> None:
    """The ``{"trace": ...}`` line: TR007's predicted footprint of the
    32-layer bf16 default run's EngineConfig (params + KV pool + the meta
    walk's peak of live temporaries) beside the run's
    ``torch.cuda.max_memory_allocated()`` (peak reset before its engine was
    built), and the dispatch signatures the run made (warm-up and profiled
    rerun included), every one of which must be in the config's declared
    matrix."""
    t = default["trace"]
    fp = analysis["footprint"]
    line = dict(config="bf16 default path, 32 layers", predicted_bytes=fp["total_bytes"],
                params_bytes=fp["params_bytes"], kv_bytes=fp["kv_bytes"],
                peak_temp_bytes=fp["peak_temp_bytes"], budget_bytes=fp["budget_bytes"],
                max_memory_allocated_bytes=t["max_memory_allocated"],
                measured_over_predicted=round(t["max_memory_allocated"] / fp["total_bytes"], 4),
                # the split: what was live before the engine (the weights and what
                # earlier phases still hold), and the engine's own peak above it
                # beside the predicted KV pool + peak temporaries
                allocated_before_engine_bytes=t["allocated_before_engine"],
                weights_bytes=t["weights"],
                engine_peak_bytes=t["max_memory_allocated"] - t["allocated_before_engine"],
                predicted_engine_bytes=fp["total_bytes"] - fp["params_bytes"],
                dispatches=t["dispatches"], signatures=t["signatures"],
                undeclared=t["undeclared"], walk_s=analysis["seconds"], card=card)
    log(json.dumps({"trace": line}))
    check(not t["undeclared"], f"trace: the default run dispatched signatures outside its "
          f"config's declared matrix: {t['undeclared']}")
    check(t["max_memory_allocated"] <= fp["budget_bytes"],
          f"trace: the run's peak {t['max_memory_allocated']} B is over the budget")


def shard_line(run: dict, census: dict, card: str) -> dict:
    """The ``{"shard": ...}`` line of the mesh phase's bf16 pair at (1, 2):
    each rank's bytes of params and cache beside the census's, and rank 0's
    collectives a decode dispatch (counted on the gloo world) beside the
    census's, per dispatch and per turn.  The bytes and the counts must
    equal the census."""
    want = {k: v["count"] for k, v in census["collectives"].items()}
    steps = run["decode_dispatch_collectives"]
    full = [d for d in steps if d["turns"] == DEFAULT_PATH["decode_steps"]]
    turns = DEFAULT_PATH["decode_steps"]
    per_dispatch = {k: sum(d["counts"].get(k, {}).get("count", 0) for d in full) / max(1, len(full))
                    for k in sorted(set(want) | {k for d in full for k in d["counts"]})}
    line = dict(mesh="(1, 2)", layers=MESH_BF16_LAYERS, backend="gloo, one card",
                ranks=[dict(rank=r, params_bytes=m["params"], cache_bytes=m["cache"],
                            census_params_bytes=c["params"], census_cache_bytes=c["cache"])
                       for r, (m, c) in enumerate(zip(run["resident"], census["ranks"]))],
                decode_dispatches=len(steps), full_bursts=len(full), turns_per_burst=turns,
                collectives_per_dispatch=per_dispatch, census_per_dispatch=want,
                collectives_per_turn={k: round(v / turns, 4) for k, v in per_dispatch.items()},
                census_per_turn={k: round(v / turns, 4) for k, v in want.items()},
                payload_bytes_per_dispatch={k: v["payload_bytes"] for k, v in (
                    full[0]["counts"].items() if full else {})},
                census_payload_bytes={k: v["payload_bytes"]
                                      for k, v in census["collectives"].items()},
                card=card)
    log(json.dumps({"shard": line}))
    check(run["resident"] == census["ranks"], f"shard: the ranks' resident bytes "
          f"{run['resident']} are not the census's {census['ranks']}")
    check(full and all({k: v["count"] for k, v in d["counts"].items()} == want for d in full),
          f"shard: rank 0's collectives a decode dispatch {[d['counts'] for d in full]} are not "
          f"the census's {want}")
    return line


def stop_lints(lints: dict) -> None:
    for proc in lints.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def load_phase(default: dict, router: dict, lints: dict, card: str) -> dict:
    """The load plane at this card's figures, from runs already taken: the
    bf16 default-path run (``serve_run(timeline=True)``) gives the prefill
    ms a fresh prompt token (its ``step`` dispatches' seconds over the
    prompt tokens not served from cache) and the decode ms a row's step
    (its ``decode_multi`` seconds over the row-steps decoded: each
    request's tokens after its first), and its engine the KV bytes a
    block; the router run gives one decision's ms.  Sweeps the capacity
    grid at those figures and logs each cell's knee beside the committed
    manifest's, then reads ``lint --load``, ``--project``, ``--wire``,
    ``--metrics``, ``--kern``, ``--perf``, ``--trace`` and ``--shard``
    (``lints``, from :func:`start_lints`): each must exit 0 here."""
    from dynamo_tpu_torch.analysis.loadcheck import DEFAULT_LOAD_MANIFEST_PATH, LoadManifest
    from dynamo_tpu_torch.load.sim import sweep
    from dynamo_tpu_torch.load.workers import DEFAULT_CARD_LATENCY, LatencyModel

    t0 = time.perf_counter()
    try:
        kinds = default["timeline"]["kinds"]
        check({"step", "decode_multi"} <= set(kinds),
              f"load: the default-path timeline has no step or decode_multi dispatch: {kinds}")
        fresh = sum(default["prompt_tokens"]) - sum(default["cached"])
        decoded = sum(len(s) - 1 for s in default["streams"])
        measured = dict(
            prefill_ms_per_token=round(kinds["step"]["count"] * kinds["step"]["ms"] / fresh, 6),
            decode_ms_per_step=round(
                kinds["decode_multi"]["count"] * kinds["decode_multi"]["ms"] / decoded, 6),
            router_ms_per_decision=round(router["decision_ms"], 6),
            kv_bytes_per_block=default["kv_bytes_per_block"])
        committed = json.loads(DEFAULT_CARD_LATENCY.read_text())
        ratios = {k: round(measured[k] / committed[k], 4) for k in LOAD_FIGURES}
        facts = sweep(lat=LatencyModel(**measured, scale=1.0))
        check(all(c["twin_match"] for c in facts["cells"].values()),
              "load: a cell's twin runs at the measured figures differ")
        manifest = LoadManifest.load(DEFAULT_LOAD_MANIFEST_PATH)
        knees = {cell: dict(measured=c["knee_level"],
                            committed=manifest.cells.get(cell, {}).get("knee_level"))
                 for cell, c in facts["cells"].items()}
        sweep_s = time.perf_counter() - t0
        lint = {}
        for flag, proc in lints.items():
            stdout, stderr = proc.communicate(timeout=LOAD_LINT_S)
            proc.clock.join(timeout=5)
            tail = (stdout.strip().splitlines() or [""])[-1]
            lint[flag] = dict(rc=proc.returncode, summary=tail,
                              seconds=None if proc.seconds is None else round(proc.seconds, 3),
                              read_at_s=round(time.perf_counter() - t0, 3))
            check(proc.returncode == 0, f"load: lint {flag} exited {proc.returncode} on this "
                  f"card's machine:\n{stdout[-4000:]}\n{stderr[-4000:]}")
    finally:
        stop_lints(lints)
    out = dict(measured=measured, committed={k: committed[k] for k in LOAD_FIGURES},
               measured_over_committed=ratios, committed_card=committed.get("card"),
               fresh_prompt_tokens=fresh, decoded_row_steps=decoded,
               step=kinds["step"], decode_multi=kinds["decode_multi"], knees=knees,
               sweep_s=round(sweep_s, 3), lint=lint,
               python=sys.version.split()[0], seconds=round(time.perf_counter() - t0, 3),
               card=card)
    log(json.dumps({"load": out}))
    return out


@contextlib.contextmanager
def recorded_ragged_calls(name: str = "ragged_paged_prefill_attention"):
    """Record the row table of every ragged attention call the model makes
    at layer 0 (one per dispatch), by wrapping the routing's reference to
    the kernel's wrapper ``name`` (the bf16 or the int8 one); the wrapper
    itself, and its launch count, are untouched."""
    from dynamo_tpu_torch.ops import paged_attention as routing
    from dynamo_tpu_torch.ops.kv_quant import cache_data

    real = getattr(routing, name)
    calls = []

    def recording(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets,
                  *args, **kw):
        if layer == 0:
            calls.append((q.shape[1], block_tables, seq_lens, starts, row_offsets,
                          cache_data(cache).shape[3]))
        return real(q, k_new, v_new, cache, layer, block_tables, seq_lens, starts, row_offsets,
                    *args, **kw)

    setattr(routing, name, recording)
    try:
        yield calls
    finally:
        setattr(routing, name, real)


def largest_mixed(calls) -> dict:
    """The recorded dispatch with the most attention work among those that
    mix decode rows (1-token rows at the head of the axis) with spans."""
    best = None
    for t, bt, lens, starts, offs, bs in calls:
        lens, starts, offs = lens.tolist(), starts.tolist(), offs.tolist()
        fresh = [n - st for n, st in zip(lens, starts)]
        mixed = fresh and fresh[0] == 1 and offs[0] == 0 and max(fresh) > 1
        if mixed and (best is None or kreg.span_pairs(starts, lens) > kreg.span_pairs(best["starts"],
                                                                               best["lens"])):
            best = dict(t=t, bt=bt, lens=lens, starts=starts, offs=offs, bs=bs)
    check(best is not None, "the token-budget run made no mixed dispatch")
    return best


# The bf16 Llama-3-8B serves its default and token-budget paths and the
# fault plane at full depth (the load plane's figures and the kernels'
# launches come from those runs); HTTP, grammar, speculation,
# disaggregation and the KV tiers serve the same widths and kernels at
# this depth, so the whole script keeps its margin to the time limit on a
# slow host
BF16_PLANE_LAYERS = 8


def serving_phase(torch, card: str):
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    def llama(layers):
        cfg = llama3_8b(layers)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        t0 = time.perf_counter()
        model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda"))
        torch.cuda.synchronize()
        log(f"serving: Llama-3-8B, {cfg.num_layers} layers, random weights in "
            f"{time.perf_counter() - t0:.1f} s")
        return model

    model = llama(32)
    default, budget, mixed = serve_both(torch, model, card, quant=False)
    # the cut engine's bound (two decode bursts past the cut) is set at
    # this model's burst time
    fault = fault_phase(torch, model, card)
    del model
    torch.cuda.empty_cache()
    model = llama(BF16_PLANE_LAYERS)
    # the reference the planes below are read against, on their model
    local = serve_run(torch, model, DEFAULT_PATH, card,
                      f"default path, {BF16_PLANE_LAYERS} layers")
    http_serving_run(torch, model, local, card)
    grammar_phase(torch, model, local, card)
    t0 = time.perf_counter()
    spec = spec_phase(torch, model, card)
    log(f"spec phase (bf16): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    disagg = disagg_phase(torch, model, local, card)
    log(f"disagg phase (bf16): {time.perf_counter() - t0:.1f} s")
    tier = tier_phase(torch, model, card)
    del model
    torch.cuda.empty_cache()
    return default, budget, mixed, spec, disagg, tier, fault


def serve_both(torch, model, card: str, quant: bool):
    """The default path then the token-budget path on one model; checks
    that each run launched its path's kernels and none of the other cache
    kind's attention kernels.  Returns both runs and the largest mixed
    dispatch of the second."""
    tag = "int8 " if quant else ""
    q8 = "_q8" if quant else ""
    other = (("decode", "prefill", "ragged", "moe", "moe_q8") if quant
             else ("decode_q8", "prefill_q8", "ragged_q8", "matmul", "moe", "moe_q8"))
    default = serve_run(torch, model, INT8_DEFAULT_PATH if quant else DEFAULT_PATH, card,
                        f"{tag}default path", profile=True, timeline=True, perf=not quant,
                        trace=not quant)
    need = ["decode" + q8, "prefill" + q8] + (["matmul"] if quant else [])
    check(all(default["launches"][k] > 0 for k in need) and
          not any(default["launches"][k] for k in other),
          f"{tag}default path: launches {default['launches']}, need {need} > 0, {other} = 0")
    torch.cuda.empty_cache()  # the first engine and its cache are gone
    with recorded_ragged_calls("ragged_paged_prefill_attention" + q8) as calls:
        budget = serve_run(torch, model, INT8_BUDGET_PATH if quant else BUDGET_PATH, card,
                           f"{tag}token-budget path")
    m = budget["metrics"]
    need = ["ragged" + q8, "decode" + q8] + (["matmul"] if quant else [])
    check(all(budget["launches"][k] > 0 for k in need) and
          not any(budget["launches"][k] for k in other),
          f"{tag}token-budget path: launches {budget['launches']}, need {need} > 0, {other} = 0")
    check(m["unified_dispatches_total"] > 0 and m["lookahead_bursts_total"] > 0,
          f"the {tag}token-budget path made no mixed dispatch or no burst: {m}")
    same = sum(a == b for a, b in zip(default["streams"], budget["streams"]))
    log(f"serving: {same} of {len(default['streams'])} {tag}token-budget streams equal the "
        f"default path's (informational: the kernels round bf16 at different places) ({card})")
    mixed = largest_mixed(calls)
    del calls
    torch.cuda.empty_cache()
    return default, budget, mixed


# The int8 Llama-3-8B serving runs at 8 of its 32 layers: the same widths
# and kernels at a quarter of the forward, so the whole script keeps its
# margin to the time limit on a slow host (the bf16 default and
# token-budget runs stay at full depth)
INT8_SERVING_LAYERS = 8


def serving_phase_q8(torch, card: str):
    """The two serving runs on Llama-3-8B with int8 weights (drawn directly
    on the card, the bf16 model never made) and an int8 KV cache, at
    INT8_SERVING_LAYERS layers."""
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = llama3_8b(INT8_SERVING_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda", quantized=True))
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"serving: Llama-3-8B int8, {cfg.num_layers} layers, {weights / 1e9:.2f} GB of random "
        f"weights in {time.perf_counter() - t0:.1f} s")
    out = serve_both(torch, model, card, quant=True)
    t0 = time.perf_counter()
    spec = spec_phase_q8(torch, model, card)
    log(f"spec phase (int8): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    disagg = disagg_phase(torch, model, out[0], card, quant=True)
    log(f"disagg phase (int8): {time.perf_counter() - t0:.1f} s")
    tier = tier_phase_q8(torch, model, card)
    del model
    torch.cuda.empty_cache()
    return out + (spec, disagg, tier)


# ------------------------------------------------------------- speculation
# The copy task of benchmarks/bench_spec.py: each of the six prompts repeats
# a seeded 32-token segment to its length, so prompt lookup matches from
# the first turn; 64 tokens each, five rows greedy and one seeded.
SPEC_SEGMENT = 32
SPEC_MAX_TOKENS = 64
SPEC_SEEDED_ROW = 5
SPEC_SEEDED = dict(temperature=0.9, top_p=0.9, seed=1234)
SPEC_VERIFY_S = (5, 8)  # S = k + 1 for k = 4 and 7
# A verify and a burst compute the same logits through other kernels (the
# projections at 8 x S rows, the decode kernel at S > 1), so bf16 rounding
# can flip a greedy pick where two tokens nearly tie, and nowhere else.
# Each card computation's logits lie within eps = PARITY_MAX_REL x max|logit|
# of the exact ones (phase 5's card-vs-CPU bound): two tokens that two runs
# order differently lie within 2 eps of each other exactly, hence within 4
# eps in a third card computation, the re-scoring prefill.  A seeded row
# compares its noisy scores l / T + g the same way, within 4 eps / T.
SPEC_TIE_EPS = 4


def verify_live(lens, s: int) -> list[int]:
    """Live queries of each row of a verify whose rows proposed fewer than
    k tokens (1 to S), cut at the row's context."""
    pattern = (1, s, 2, s - 3, s, 3, s - 1, 1)
    return [min(n, pattern[i % len(pattern)]) for i, n in enumerate(lens)]


# the draft runs at 4 of Llama-3.2-1B's 16 layers, as the target runs at
# BF16_PLANE_LAYERS: its autoregressive proposals are most of a verify turn
SPEC_DRAFT_LAYERS = 4


def llama32_1b(num_layers: int = 16):
    """Llama-3.2-1B's published geometry (meta-llama/Llama-3.2-1B
    config.json): Llama 3's tokenizer, so a draft for Llama-3-8B."""
    from dynamo_tpu_torch.models.config import ModelConfig

    return ModelConfig(vocab_size=LLAMA3_VOCAB, hidden_size=2048, intermediate_size=8192,
                       num_layers=num_layers, num_heads=32, num_kv_heads=8, head_dim=64,
                       max_position_embeddings=131072, rope_theta=500000.0,
                       rope_scaling={"rope_type": "llama3", "factor": 32.0,
                                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 8192},
                       tie_word_embeddings=True, dtype="bfloat16")


def spec_prompts(seed: int = 2) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for n in PROMPT_LENS:
        seg = rng.integers(0, LLAMA3_VOCAB, SPEC_SEGMENT).tolist()
        out.append((seg * -(-n // SPEC_SEGMENT))[:n])
    return out


def spec_sampling() -> list[dict]:
    return [SPEC_SEEDED if i == SPEC_SEEDED_ROW else {"temperature": 0.0}
            for i in range(len(PROMPT_LENS))]


@contextlib.contextmanager
def recorded_attention(torch, draft=None):
    """Count the decode kernel's calls by wrapper and S, and time every call
    of the plain attention op with CUDA events, by wrapping the routing's
    references (the wrappers and their launch counts are untouched).  A
    plain-op call made inside the draft's dispatch is marked: its k - 1
    steps run at S = 1, so only its ingest can make one."""
    from dynamo_tpu_torch.ops import paged_attention as routing

    names = ("paged_decode_attention", "paged_decode_attention_q8", "paged_attention")
    real = {n: getattr(routing, n) for n in names}
    rec = dict(decode={}, plain=[])
    in_draft = [False]

    def decode(name):
        def call(q, *args, **kw):
            key = f"{'B4a' if name.endswith('q8') else 'B1'} S={q.shape[1]}"
            rec["decode"][key] = rec["decode"].get(key, 0) + 1
            return real[name](q, *args, **kw)
        return call

    def plain(q, *args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real["paged_attention"](q, *args, **kw)
        end.record()
        rec["plain"].append((q.shape[1], in_draft[0], start, end))
        return out

    if draft is not None:
        real_impl = draft._impl

        def impl(*args, **kw):
            in_draft[0] = True
            try:
                return real_impl(*args, **kw)
            finally:
                in_draft[0] = False
        draft._impl = impl
    for n in names[:2]:
        setattr(routing, n, decode(n))
    routing.paged_attention = plain
    try:
        yield rec
    finally:
        for n in names:
            setattr(routing, n, real[n])
        if draft is not None:
            del draft._impl


def spec_run(torch, model, config: dict, card: str, label: str, draft=None) -> dict:
    """The spec cell's six requests once through ``AsyncLLMEngine`` under
    one EngineConfig (a draft model when named), every launch counter zeroed
    just before and read just after; each decode turn timed on the host (a
    verify turn, the draft's dispatch included, or a burst), the decode
    kernel's calls split by S, the plain op's calls timed."""
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.llm.protocols import FinishReason

    core = EngineCore(model, EngineConfig(**config), device="cuda", draft=draft)
    turns = {"verify": [], "burst": []}
    real_decode = core._run_decode

    def run_decode():
        t0, s0, d0, g0 = time.perf_counter(), core.spec_steps, core.decode_steps, core.tokens_generated
        real_decode()
        kind = "verify" if core.spec_steps > s0 else "burst"
        turns[kind].append((time.perf_counter() - t0, core.decode_steps - d0,
                            core.tokens_generated - g0))

    core._run_decode = run_decode
    engine = AsyncLLMEngine(core).start()
    try:
        asyncio.run(_serve(engine, [list(range(1, 40))], max_tokens=8, tag="warm-up"))
        wrappers = _kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        for v in turns.values():
            v.clear()
        keys = ("spec_steps", "spec_proposed", "spec_accepted", "device_gets_total")
        before = {k: core.metrics()[k] for k in keys}
        host0, turns0 = core.timeline.host_gap_s_total, core.timeline.busy_steps_total
        dispatches0 = core.draft.dispatches if core.draft is not None else 0
        with recorded_attention(torch, core.draft) as rec:
            t0 = time.perf_counter()
            results = asyncio.run(_serve(engine, spec_prompts(), spec_sampling(),
                                         max_tokens=SPEC_MAX_TOKENS))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in wrappers.items()}
        counts = {k: core.metrics()[k] - before[k] for k in keys}
        asyncio.run(engine.run_on_engine(lambda: None))  # the last step has ended
        host_gap_ms = 1e3 * (core.timeline.host_gap_s_total - host0) / max(
            1, core.timeline.busy_steps_total - turns0)
        draft_dispatches = (core.draft.dispatches - dispatches0) if core.draft is not None else 0
    finally:
        engine.shutdown()
        # the wrapper closes over the core: without this the core, its cache,
        # its model and its draft wait for the cycle collector
        del core._run_decode
    for i, (_, _, outs) in enumerate(results):
        toks = [t for o in outs for t in o.token_ids]
        check(outs[-1].finish_reason is FinishReason.LENGTH,
              f"spec {label} request {i}: finish {outs[-1].finish_reason}, expected length")
        check(len(toks) == SPEC_MAX_TOKENS, f"spec {label} request {i}: {len(toks)} tokens")
    plain = [(s, ingest, start.elapsed_time(end)) for s, ingest, start, end in rec["plain"]]
    ttfts = sorted(r[0] for r in results)
    decode_window = wall - ttfts[0]
    share = counts["spec_accepted"] / counts["spec_proposed"] if counts["spec_proposed"] else 0.0
    verify_tokens = sum(t for _, _, t in turns["verify"])
    verify_ms = [1e3 * dt for dt, _, _ in turns["verify"]]
    burst_step_ms = [1e3 * dt / n for dt, n, _ in turns["burst"] if n]
    out = dict(
        label=label, wall_s=wall, ttft_median_s=ttfts[len(ttfts) // 2], ttft_max_s=ttfts[-1],
        decode_tok_s=len(results) * (SPEC_MAX_TOKENS - 1) / decode_window,
        host_gap_ms_per_turn=host_gap_ms, **counts, accepted_share=share,
        tokens_per_verify=verify_tokens / counts["spec_steps"] if counts["spec_steps"] else 0.0,
        verify_turns=len(verify_ms), verify_turn_ms=sorted(verify_ms)[len(verify_ms) // 2]
        if verify_ms else None, bursts=len(burst_step_ms),
        burst_step_ms=sorted(burst_step_ms)[len(burst_step_ms) // 2] if burst_step_ms else None,
        draft_dispatches=draft_dispatches, decode_calls_by_s=rec["decode"],
        plain_calls=len(plain), plain_calls_outside_draft=sum(1 for _, ing, _ in plain if not ing),
        plain_ms=sum(ms for _, _, ms in plain), plain_s=sorted({s for s, _, _ in plain}),
        launches=launches)
    log(f"spec {label}: wall {wall:.3f} s, TTFT median/max {out['ttft_median_s']:.3f}/"
        f"{out['ttft_max_s']:.3f} s, decode {out['decode_tok_s']:.1f} tok/s, host gap "
        f"{host_gap_ms:.2f} ms/turn; verify turns {out['verify_turns']} (median "
        f"{out['verify_turn_ms'] or 0:.2f} ms), bursts {out['bursts']} (median "
        f"{out['burst_step_ms'] or 0:.2f} ms a step); spec_steps {counts['spec_steps']}, "
        f"proposed {counts['spec_proposed']}, accepted {counts['spec_accepted']} (share "
        f"{share:.3f}), tokens emitted per verify {out['tokens_per_verify']:.2f} (6 rows); draft "
        f"dispatches {draft_dispatches}; decode kernel calls by S {rec['decode']}; plain-op calls "
        f"{len(plain)} (S {out['plain_s']}, outside the draft {out['plain_calls_outside_draft']}) "
        f"{out['plain_ms']:.3f} ms; device reads {counts['device_gets_total']} ({card})")
    out["streams"] = [[t for o in outs for t in o.token_ids] for _, _, outs in results]
    return out


def _rescore(torch, model, seq, bs, cache_dtype):
    """The logits after ``seq`` from one prefill over a fresh cache."""
    n = len(seq)
    pad = -(-n // bs) * bs
    nb = pad // bs
    cache = model.init_kv_cache(nb + 1, bs, cache_dtype)
    bt = torch.zeros((1, max(2048 // bs, nb)), dtype=torch.int32, device="cuda")
    bt[0, :nb] = torch.arange(1, nb + 1, dtype=torch.int32)
    t = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    t[0, :n] = torch.tensor(seq, dtype=torch.int32)
    pos = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
    pos[0, :n] = torch.arange(n, dtype=torch.int32)
    slot = torch.full((1, pad), -1, dtype=torch.int32, device="cuda")
    slot[0, :n] = bt[0, pos[0, :n].long() // bs] * bs + pos[0, :n] % bs
    hidden, _ = model.forward(t, pos, cache, bt, torch.tensor([n], dtype=torch.int32,
                                                               device="cuda"), slot,
                              prefix_blocks=0)
    return model.compute_logits(hidden[:, n - 1])[0].float().cpu()


def spec_near_ties(torch, model, base: dict, run: dict, card: str, bs=BS, cache_dtype=None,
                   prompts=None, sampling=None, against: str = "off") -> int:
    """Hold ``run``'s streams to ``base``'s (speculation off, unless
    ``against`` names another base): where a row parts, re-score the common
    prefix on the card and require the two tokens' logits (a seeded row:
    its noisy scores) within SPEC_TIE_EPS x PARITY_MAX_REL x max|logit|
    (/ T).  Returns the rows that parted.  The rows are the spec phase's
    unless ``prompts`` and ``sampling`` (each row's SamplingOptions fields)
    are given."""
    from dynamo_tpu_torch.engine.sampling import K_MAX, seeded_gumbel

    prompts = spec_prompts() if prompts is None else prompts
    sampling = spec_sampling() if sampling is None else sampling
    parted = 0
    for i, (a, b) in enumerate(zip(base["streams"], run["streams"])):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        parted += 1
        logits = _rescore(torch, model, prompts[i] + a[:j], bs, cache_dtype)
        tol = SPEC_TIE_EPS * PARITY_MAX_REL * float(logits.abs().max())
        la, lb = float(logits[a[j]]), float(logits[b[j]])
        samp = sampling[i]
        if samp.get("seed") is None:
            gap, what = abs(la - lb), "logit gap"
        else:
            t = samp["temperature"]
            g = seeded_gumbel(torch.tensor([samp["seed"] & 0x7FFFFFFF], dtype=torch.int32),
                              torch.tensor([len(prompts[i]) + j], dtype=torch.int32),
                              torch.tensor([[a[j], b[j]]], dtype=torch.int32))[0]
            gap, what, tol = abs((la - lb) / t + float(g[0] - g[1])), "noisy-score gap", tol / t
        top = torch.topk(logits, 2).values
        ranks = [int((logits > logits[tok]).sum()) for tok in (a[j], b[j])]
        edge = ""
        if samp.get("top_p", 1.0) < 1.0:
            # the probability mass ranked above each token (the top-K_MAX
            # candidates at T): a token near top_p sits at the kept set's edge
            probs = torch.softmax(torch.topk(logits, K_MAX).values / samp["temperature"], -1)
            before = (torch.cumsum(probs, -1) - probs).tolist()
            edge = (f", mass ranked above them {', '.join(f'{before[r]:.4f}' if r < K_MAX else '-' for r in ranks)} "
                    f"(top_p {samp['top_p']})")
        log(f"spec {run['label']} vs {against}: request {i} parts at token {j} ({a[j]} vs {b[j]}, logit "
            f"ranks {ranks[0]} and {ranks[1]}{edge}), re-scored {what} {gap:.4g} (tol {tol:.4g}; "
            f"top-2 margin there {float(top[0] - top[1]):.4g}) ({card})")
        check(gap <= tol, f"spec {run['label']}: request {i} parts at token {j} by a {what} of "
              f"{gap} > {tol}: not a near-tie")
    log(f"spec {run['label']}: {len(base['streams']) - parted} of {len(base['streams'])} streams "
        f"equal {'speculation off' if against == 'off' else against}'s ({card})")
    return parted


def spec_checks(runs: dict, quant: bool = False) -> None:
    """Each speculative run verified, at S = k + 1 on the decode kernel, and
    made plain-op calls only in a draft's ingest (none without a draft)."""
    kernel = "B4a" if quant else "B1"
    for label, r in runs.items():
        k = r.get("k", 0)
        if not k:
            check(r["spec_steps"] == 0, f"spec {label}: {r['spec_steps']} verifies with spec off")
            continue
        check(r["spec_steps"] > 0, f"spec {label}: no verify turn")
        check(r["decode_calls_by_s"].get(f"{kernel} S={k + 1}", 0) > 0,
              f"spec {label}: {kernel} never launched at S={k + 1}: {r['decode_calls_by_s']}")
        if r["draft"]:
            check(r["plain_calls_outside_draft"] == 0,
                  f"spec {label}: {r['plain_calls_outside_draft']} plain-op calls outside the "
                  "draft's ingest")
        else:
            check(r["plain_calls"] == 0, f"spec {label}: {r['plain_calls']} plain-op calls")


def spec_phase(torch, model, card: str) -> dict:
    """Speculative decoding on the loaded Llama-3-8B bf16 model: the spec
    cell's requests with speculation off, n-gram lookup at k = 4 and 7 and
    a Llama-3.2-1B-width draft (random weights from a seed), k = 4."""
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    t0 = time.perf_counter()
    cfg = llama32_1b(SPEC_DRAFT_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    draft = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda"))
    n_params = sum(p.numel() for p in draft.parameters())
    log(f"spec: Llama-3.2-1B-width draft, {cfg.num_layers} layers, {n_params / 1e9:.3f} B parameters, "
        f"{2 * n_params / 1e9:.2f} GB bf16, random weights in {time.perf_counter() - t0:.1f} s")
    plan = (("off", 0, None), ("ngram k=4", 4, None), ("ngram k=7", 7, None),
            ("1B draft k=4", 4, draft))
    runs = {}
    for label, k, d in plan:
        runs[label] = spec_run(torch, model, dict(DEFAULT_PATH, spec_tokens=k), card, label,
                               draft=d)
        runs[label].update(k=k, draft=d is not None)
        torch.cuda.empty_cache()
    del draft
    gc.collect()
    torch.cuda.empty_cache()
    spec_checks(runs)
    for label, r in runs.items():
        if r["k"]:
            r["parted"] = spec_near_ties(torch, model, runs["off"], r, card)
    log(f"spec: accepted share, the 1B draft's {runs['1B draft k=4']['accepted_share']:.3f} "
        f"({card})")
    return runs


def spec_phase_q8(torch, model, card: str) -> dict:
    """Speculation off and n-gram lookup at k = 4 on the int8 model (int8
    weights and cache, Bs = 32): the verify on B4a and B5."""
    runs = {}
    for label, k in (("int8 off", 0), ("int8 ngram k=4", 4)):
        runs[label] = spec_run(torch, model, dict(INT8_DEFAULT_PATH, spec_tokens=k), card, label)
        runs[label].update(k=k, draft=False)
        gc.collect()
        torch.cuda.empty_cache()
    spec_checks(runs, quant=True)
    check(runs["int8 ngram k=4"]["launches"]["matmul"] > 0, "spec int8: B5 never launched")
    runs["int8 ngram k=4"]["parted"] = spec_near_ties(
        torch, model, runs["int8 off"], runs["int8 ngram k=4"], card, bs=BS_Q8, cache_dtype="int8")
    return runs


# Qwen3-30B-A3B's serving runs at 8 of its 48 layers: the same widths,
# experts and kernels, a sixth of the forward, so the whole script keeps
# its margin to the time limit on a slow host
QWEN3_SERVING_LAYERS = 8


def moe_serving_phase(torch, card: str) -> tuple[dict, dict]:
    """Qwen3-30B-A3B at full width, QWEN3_SERVING_LAYERS of its 48 layers
    (random weights from a seeded generator, drawn on the card one layer at a time) behind
    ``AsyncLLMEngine``, the six requests once per configuration, each run
    profiled: bf16 on the default path (B1, B2, E1), then, the bf16 model
    freed, int8 weights with an int8 KV cache (Bs = 32) on the token-budget
    path (B4a, B4c, B5, E2).  Every Llama model and engine is gone before
    (all 48 layers' 61 GB of bf16 weights fit, leaving about 18 GB)."""
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = qwen3_30b_a3b(QWEN3_SERVING_LAYERS)
    runs = []
    for quant, config, label, need, none in (
            (False, DEFAULT_PATH, "Qwen3-30B-A3B bf16 default path", ["decode", "prefill", "moe"],
             ["decode_q8", "prefill_q8", "ragged", "ragged_q8", "matmul", "moe_q8"]),
            (True, INT8_BUDGET_PATH, "Qwen3-30B-A3B int8 token-budget path",
             ["decode_q8", "ragged_q8", "matmul", "moe_q8"], ["decode", "prefill", "ragged", "moe"])):
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        t0 = time.perf_counter()
        model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda", quantized=quant))
        torch.cuda.synchronize()
        weights = sum(p.numel() * p.element_size() for p in model.parameters())
        log(f"serving: Qwen3-30B-A3B{' int8' if quant else ''}, {cfg.num_layers} layers, "
            f"{weights / 1e9:.2f} GB of random weights in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run = serve_run(torch, model, config, card, label, profile=True)
        log(f"serving: the {label} run, its warm-up and its profile took "
            f"{time.perf_counter() - t0:.1f} s on the host")
        check(all(run["launches"][k] > 0 for k in need) and not any(run["launches"][k] for k in none),
              f"{label}: launches {run['launches']}, need {need} > 0, {none} = 0")
        if quant:
            m = run["metrics"]
            check(m["unified_dispatches_total"] > 0 and m["lookahead_bursts_total"] > 0,
                  f"the {label} made no mixed dispatch or no burst: {m}")
        runs.append(run)
        del model
    torch.cuda.empty_cache()
    return runs[0], runs[1]


# the perf plane's full-width forward (analysis/perf_manifest.json): the
# default path's decode forward [8, 1] and its longest prompt's prefill
# forward [1, 1504]
PERF_ENTRY = "models.llama.forward[llama3-8b-h100]"
PERF_SHAPES = {"decode": (8, 1), "prefill": (1, 1504)}
# torch.cuda._sleep's kernel: one launch of it marks each end of a forward
# on the stream, so the profile can cut the stream's kernels into forwards
FORWARD_MARK = "spin_kernel"


@contextlib.contextmanager
def marked_forwards(torch, model, shapes: list):
    """``model.forward`` with a mark launched on its stream before and
    after it, and each call's token shape appended to ``shapes``."""
    real = model.forward

    def forward(tokens, *args, **kwargs):
        shapes.append(tuple(tokens.shape))
        torch.cuda._sleep(0)
        try:
            return real(tokens, *args, **kwargs)
        finally:
            torch.cuda._sleep(0)

    model.forward = forward
    try:
        yield
    finally:
        del model.forward


def forward_device_ms(device_events, shapes: list) -> list:
    """Each marked forward's device ms: the kernels and copies its marks'
    stream ran between its two marks.  ``device_events`` are (start ns,
    duration ns, name, stream) tuples; None when the marks do not pair up
    with the forwards."""
    import bisect

    events = sorted(device_events)
    marks = [e for e in events if FORWARD_MARK in e[2]]
    if not marks or len(marks) != 2 * len(shapes):
        log(f"perf: {len(marks)} forward marks on the card for {len(shapes)} forwards")
        return None
    stream = marks[0][3]
    work = [e for e in events if e[3] == stream and FORWARD_MARK not in e[2]]
    starts = [e[0] for e in work]
    total = [0]
    for e in work:
        total.append(total[-1] + e[1])
    out = []
    for i in range(len(shapes)):
        lo = bisect.bisect_right(starts, marks[2 * i][0])
        hi = bisect.bisect_left(starts, marks[2 * i + 1][0])
        out.append((total[hi] - total[lo]) / 1e6)
    return out


def perf_line(forwards: list, card: str) -> None:
    """The perf plane's predicted ms of ``PERF_ENTRY``'s decode and
    prefill forwards (the committed manifest, read as ``/metrics`` reads
    it) beside the profiled device ms of the run's forwards of the same
    shapes."""
    from dynamo_tpu_torch.analysis.perfcheck import manifest_predictions

    base, _, config = PERF_ENTRY.partition("[")
    pred = {r["signature"]: r for r in manifest_predictions()
            if r["entrypoint"] == base and r["config"] == config.rstrip("]")}
    line = dict(entry=PERF_ENTRY, card=card)
    for sig, shape in PERF_SHAPES.items():
        ms = sorted(t for s, t in forwards if tuple(s) == shape)
        row = dict(shape=list(shape), predicted_ms=pred[sig]["predicted_ms"], bound=pred[sig]["bound"],
                   forwards=len(ms))
        if ms:
            row.update(device_ms_mean=sum(ms) / len(ms), device_ms_median=ms[len(ms) // 2],
                       device_ms_min=ms[0], device_ms_max=ms[-1],
                       device_over_predicted=sum(ms) / len(ms) / pred[sig]["predicted_ms"])
        line[sig] = row
    line["other_forwards"] = sum(1 for s, _ in forwards if tuple(s) not in PERF_SHAPES.values())
    log(json.dumps({"perf": line}))


def profile_serving(torch, engine, reqs, card: str, model=None) -> None:
    """The same traffic (fresh prompts, so no prefix is cached) once more
    under torch.profiler: the share of wall time the card ran a kernel,
    and the kernels that took the most device time.  With ``model`` (the
    bf16 Llama-3-8B default path) each of its forwards is marked on the
    stream and the ``perf`` line prints their device ms beside the perf
    plane's prediction."""
    from torch.profiler import ProfilerActivity, profile

    shapes: list = []
    marking = marked_forwards(torch, model, shapes) if model is not None else contextlib.nullcontext()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, marking:
        t0 = time.perf_counter()
        asyncio.run(_serve(engine, reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device time and launches by kernel name, summed over the raw events:
    # key_averages() builds a Python object for each of a run's ~10^5
    # launches and took up to 160 s for one Qwen3-30B-A3B run
    t0 = time.perf_counter()
    per_name: dict[str, tuple[float, int]] = {}
    device_events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            us, n = per_name.get(e.name(), (0.0, 0))
            per_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
            if model is not None:
                device_events.append((e.start_ns(), e.duration_ns(), e.name(), e.device_resource_id()))
    events = sorted(per_name.items(), key=lambda kv: kv[1][0], reverse=True)
    busy_s = sum(us for us, _ in per_name.values()) / 1e6
    top = ", ".join(f"{name[:48]} {us / 1e3:.1f} ms x{n}" for name, (us, n) in events[:6])
    log(f"profile: device busy {busy_s:.3f} s of {wall:.3f} s wall ({100 * busy_s / wall:.1f}%); "
        f"top kernels: {top}; {len(events)} device event names summed in "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    if model is not None:
        times = forward_device_ms(device_events, shapes)
        perf_line(list(zip(shapes, times)) if times is not None else [], card)
    grouped = {}  # the grouped expert kernel's device time by (E1 or E2, rows a tile)
    for name, (us, count) in events:
        m = re.search(r"grouped_wgmma_kernel<(\d+), (true|false)>", name)
        if m:
            kind = "E2" if m.group(2) == "true" else "E1"
            ms, n = grouped.get((kind, int(m.group(1))), (0.0, 0))
            grouped[(kind, int(m.group(1)))] = (ms + us / 1e3, n + count)
    for kind in ("E1", "E2"):
        rows = sorted((r, v) for (k, r), v in grouped.items() if k == kind)
        if rows:
            log(f"profile: {kind} device time {sum(v[0] for _, v in rows):.1f} ms over "
                f"{sum(v[1] for _, v in rows)} launches; by rows a tile: " + ", ".join(
                    f"{r}: {ms:.1f} ms x{n}" for r, (ms, n) in rows) + f" ({card})")


# ------------------------------------------------------------------- parity
def _forward_logits(torch, model, device, prompt, steps, prefix, bs=BS, cache_dtype=None):
    """Prefill ``prompt[:prefix]``, then the rest over that cached prefix
    (prefill kernel with start > 0), then ``steps`` single-token decode
    steps teacher-forced with ``steps`` fixed tokens; returns the logits
    at the last position of each dispatch after the first."""
    m = 2048 // bs
    n = len(prompt) + len(steps)
    nb = -(-n // bs)
    cache = model.init_kv_cache(nb + 1, bs, cache_dtype)
    bt = torch.zeros((1, m), dtype=torch.int32, device=device)
    bt[0, :nb] = torch.arange(1, nb + 1, dtype=torch.int32)
    logits = []

    def run(toks, start, prefix_blocks):
        s = len(toks)
        pad = -(-s // bs) * bs if prefix_blocks is not None else s
        t = torch.zeros((1, pad), dtype=torch.int32, device=device)
        t[0, :s] = torch.tensor(toks, dtype=torch.int32)
        pos = torch.zeros((1, pad), dtype=torch.int32, device=device)
        pos[0, :s] = torch.arange(start, start + s, dtype=torch.int32)
        slot = torch.full((1, pad), -1, dtype=torch.int32, device=device)
        slot[0, :s] = bt[0, pos[0, :s].long() // bs] * bs + pos[0, :s] % bs
        lens = torch.tensor([start + s], dtype=torch.int32, device=device)
        LIVE_TOKENS["mask"] = slot.reshape(-1) >= 0
        hidden, _ = model.forward(t, pos, cache, bt, lens, slot, prefix_blocks=prefix_blocks)
        return model.compute_logits(hidden[:, s - 1]).float().cpu()

    run(prompt[:prefix], 0, 0)
    logits.append(run(prompt[prefix:], prefix, prefix // bs))
    for i, tok in enumerate(steps):
        logits.append(run([tok], len(prompt) + i, None))
    return torch.cat(logits)


def _ragged_logits(torch, model, device, dispatches, bs=BS, cache_dtype=None):
    """Run ragged dispatches over a fresh cache; each is (rows, region)
    with rows (tokens, start, block table) laid out by
    :func:`ragged_layout`.  Returns the logits at every row's last token."""
    m = 2048 // bs
    n_blocks = 1 + max(b for rows, _ in dispatches for _, _, table in rows for b in table)
    cache = model.init_kv_cache(n_blocks, bs, cache_dtype)
    logits = []

    def ints(xs):
        return torch.tensor(xs, dtype=torch.int32, device=device)

    for rows, region in dispatches:
        t, starts, lens, offs = ragged_layout([(st, len(toks)) for toks, st, _ in rows], region, 0,
                                              bs)
        tokens = torch.zeros((1, t), dtype=torch.int32)
        pos = torch.zeros((1, t), dtype=torch.int32)
        slot = torch.full((1, t), -1, dtype=torch.int32)
        seq_ids = torch.full((1, t), -1, dtype=torch.int32)
        bt = torch.zeros((len(rows), m), dtype=torch.int32)
        for r, ((toks, st, table), o) in enumerate(zip(rows, offs)):
            n = len(toks)
            bt[r, :len(table)] = torch.tensor(table, dtype=torch.int32)
            tokens[0, o:o + n] = torch.tensor(toks, dtype=torch.int32)
            p = torch.arange(st, st + n)
            pos[0, o:o + n] = p
            slot[0, o:o + n] = bt[r, p // bs] * bs + p % bs
            seq_ids[0, o:o + n] = r
        max_pb = max(-(-st // bs) for st in starts)
        pb = 0 if max_pb == 0 else min(m, 1 << (max_pb - 1).bit_length())
        last = torch.tensor([o + n - st - 1 for st, n, o in zip(starts, lens, offs)])
        LIVE_TOKENS["mask"] = slot.reshape(-1) >= 0
        hidden, _ = model.forward(tokens.to(device), pos.to(device), cache, bt.to(device),
                                  ints(lens), slot.to(device), prefix_blocks=pb,
                                  ragged=(seq_ids.to(device), ints(starts), ints(offs)),
                                  ragged_row_tokens=region)
        logits.append(model.compute_logits(hidden[0, last.to(device)]).float().cpu())
    return torch.cat(logits)


# the live (non-padding) tokens of the dispatch being run, flat, for
# moe_routes: a padding token's hidden state is nobody's output and may
# differ between the kernels and the plain versions
LIVE_TOKENS = {"mask": None}


@contextlib.contextmanager
def moe_routes(torch, replay=None):
    """Within the block every MoE router call's expert ids are recorded
    (``replay`` None; the yielded list fills in call order), or replaced
    by the recorded ones (``replay``: that list), the replaying side
    weighting them by its own logits as the router does.  Both families'
    routers are covered: the Llama family's (Mixtral, Qwen3-MoE) and
    DeepSeek's, whose group-limited routing also records the groups it
    kept.  On replay the yielded dict counts the live (token, layer)
    routes whose own choice agreed and the largest logit gap of a
    disagreeing one (see ROUTE_TIE and :func:`_route_gap`)."""
    from dynamo_tpu_torch.models import deepseek, llama

    real = {mod: mod._moe_router for mod in (llama, deepseek)}
    recorded = [] if replay is None else iter(replay)
    stats = {"routes": 0, "same": 0, "max_gap": 0.0}

    def router(mod):
        def routed(cfg, lp, xf):
            weights, topi = real[mod](cfg, lp, xf)
            logits = deepseek.router_logits(lp, xf) if mod is deepseek else (xf @ lp["router"]).float()
            grouped = getattr(cfg, "topk_method", None) == "group_limited_greedy"
            if replay is None:
                groups = deepseek.limited_groups(cfg, torch.softmax(logits, -1)) if grouped else None
                recorded.append((topi.cpu(), None if groups is None else groups.cpu()))
                return weights, topi
            pinned, groups = (None if x is None else x.to(topi.device) for x in next(recorded))
            live = LIVE_TOKENS["mask"].to(topi.device)
            same = (topi.sort(-1).values == pinned.sort(-1).values).all(-1)[live]
            gap = _route_gap(torch, cfg, logits, pinned, groups)[live]
            stats["routes"] += len(same)
            stats["same"] += int(same.sum())
            stats["max_gap"] = max(stats["max_gap"], float(gap.max()))
            return mod.router_weights(cfg, logits, pinned), pinned
        return routed

    for mod in real:
        mod._moe_router = router(mod)
    try:
        yield recorded if replay is None else stats
    finally:
        for mod, fn in real.items():
            mod._moe_router = fn


def _route_gap(torch, cfg, logits, pinned, groups=None):
    """Per token, how far this side's logits [T, E] are from choosing the
    pinned experts [T, k]: the k-th largest logit minus a pinned expert's,
    at most over the pinned (0 where they are this side's top k).  Under
    group-limited routing (``groups``: the pinned side's kept groups [T,
    topk_group]) the k-th largest is taken within those groups, and the
    group choice adds its own gap: this side's ``topk_group``-th group best
    minus the best of a group the pinned side kept."""
    k = pinned.shape[1]
    if groups is not None:
        t, per = logits.shape[0], cfg.n_routed_experts // cfg.n_group
        best = logits.reshape(t, cfg.n_group, per).amax(-1)                  # [T, G]
        kth_group = best.sort(-1, descending=True).values[:, cfg.topk_group - 1:cfg.topk_group]
        group_gap = (kth_group - best.gather(-1, groups)).clamp_min(0).amax(-1)
        allowed = torch.zeros_like(best, dtype=torch.bool).scatter_(1, groups, True)
        logits = logits.masked_fill(~allowed.repeat_interleave(per, dim=-1), float("-inf"))
    kth = logits.sort(-1, descending=True).values[:, k - 1:k]
    gap = (kth - logits.gather(-1, pinned)).clamp_min(0).amax(-1)
    return gap if groups is None else gap.maximum(group_gap)


def _hold_card_to_cpu(torch, what: str, on_card, on_cpu, card: str) -> None:
    """The card's logits (``on_card()``) held to the CPU's; an MoE model's
    CPU run routes as the card's did, and its own routes are held to
    ROUTE_TIE."""
    with moe_routes(torch) as routes:
        got = on_card()
    with moe_routes(torch, routes) as stats:
        ref = on_cpu()
    if stats["routes"]:
        _hold_routes(what, stats, card)
    _hold_logits(torch, what, got, ref, card)


def _hold_routes(what: str, stats: dict, card: str) -> None:
    log(f"parity {what}: {stats['same']} of {stats['routes']} (token, layer) routes chose the card's "
        f"experts on the CPU too; the largest logit gap of one that did not: {stats['max_gap']:.3g} "
        f"(tol {ROUTE_TIE}) ({card})")
    check(stats["max_gap"] <= ROUTE_TIE,
          f"parity {what}: a route differs by a logit gap of {stats['max_gap']} > {ROUTE_TIE}")


def _hold_logits(torch, what: str, a, b, card: str) -> None:
    check(bool(torch.isfinite(a).all()), f"{what}: non-finite logits on the card")
    rel_l2 = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
    max_rel = ((a - b).abs().amax(dim=-1) / b.abs().amax(dim=-1)).max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"parity {what}: max rel L2 {rel_l2:.3g} (tol {PARITY_REL_L2}), max |diff|/max|logit| "
        f"{max_rel:.3g} (tol {PARITY_MAX_REL}), argmax agreement {agree:.3f} ({card})")
    check(rel_l2 <= PARITY_REL_L2, f"parity {what}: rel L2 {rel_l2} > {PARITY_REL_L2}")
    check(max_rel <= PARITY_MAX_REL, f"parity {what}: max rel {max_rel} > {PARITY_MAX_REL}")


def _verify_logits(torch, model, device, rows, bs=BS, cache_dtype=None):
    """Prefill each row's prefix (its own dispatch), then ONE speculative
    verify dispatch [B, S]: row i's live tokens at its prefix length on,
    padding past them (positions 0, no cache write), as the engine lays a
    verify out.  Returns the logits at every live verify position."""
    m = 2048 // bs
    s = max(len(toks) for _, toks in rows)
    b = len(rows)
    cache = model.init_kv_cache(1 + sum(-(-(len(p) + s) // bs) for p, _ in rows), bs, cache_dtype)
    host_bt = torch.zeros((b, m), dtype=torch.int32)
    nxt = 1
    for i, (prefix, _) in enumerate(rows):
        nb = -(-(len(prefix) + s) // bs)
        host_bt[i, :nb] = torch.arange(nxt, nxt + nb, dtype=torch.int32)
        nxt += nb
    bt = host_bt.to(device)
    for i, (prefix, _) in enumerate(rows):  # prefill each prefix
        n = len(prefix)
        pad = -(-n // bs) * bs
        t = torch.zeros((1, pad), dtype=torch.int32)
        t[0, :n] = torch.tensor(prefix, dtype=torch.int32)
        pos = torch.zeros((1, pad), dtype=torch.int32)
        pos[0, :n] = torch.arange(n, dtype=torch.int32)
        slot = torch.full((1, pad), -1, dtype=torch.int32)
        slot[0, :n] = host_bt[i, pos[0, :n].long() // bs] * bs + pos[0, :n] % bs
        LIVE_TOKENS["mask"] = (slot.reshape(-1) >= 0).to(device)
        model.forward(t.to(device), pos.to(device), cache, bt[i:i + 1],
                      torch.tensor([n], dtype=torch.int32, device=device), slot.to(device),
                      prefix_blocks=0)
    tokens = torch.zeros((b, s), dtype=torch.int32)
    pos = torch.zeros((b, s), dtype=torch.int32)
    slot = torch.full((b, s), -1, dtype=torch.int32)
    lens = torch.zeros(b, dtype=torch.int32)
    for i, (prefix, toks) in enumerate(rows):
        n, p = len(toks), len(prefix)
        tokens[i, :n] = torch.tensor(toks, dtype=torch.int32)
        pos[i, :n] = torch.arange(p, p + n, dtype=torch.int32)
        slot[i, :n] = host_bt[i, pos[i, :n].long() // bs] * bs + pos[i, :n] % bs
        lens[i] = p + n
    LIVE_TOKENS["mask"] = (slot.reshape(-1) >= 0).to(device)
    hidden, _ = model.forward(tokens.to(device), pos.to(device), cache, bt, lens.to(device),
                              slot.to(device))
    live = (slot >= 0).to(device)
    return model.compute_logits(hidden[live]).float().cpu()


def parity_phase(torch, card: str, quant: bool = False, make_cfg=None, width: str = "8B",
                 verify: bool = False) -> None:
    """A 2-layer model at full width (``make_cfg``: Llama-3-8B's unless
    named) on the card and on the CPU, the same weights on both: bf16
    weights with a bf16 cache (Bs = 16), or int8 weights with an int8 cache
    (``quant``, Bs = 32).  An MoE model's CPU run takes the card's expert
    choices (``moe_routes``).  With ``verify``, also a speculative verify
    dispatch at S = 5 (the decode kernel on the card)."""
    import numpy as np

    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    make_cfg = make_cfg or llama3_8b
    cfg = make_cfg(2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_params(cfg, gen, device="cuda", quantized=quant)
    gpu = LlamaModel.from_state(cfg, state)
    cpu_cfg = make_cfg(2)
    cpu_cfg.dtype = "float32"
    # int8 codes and f32 scales as they are; bf16 tensors in f32
    cpu = LlamaModel.from_state(cpu_cfg, {
        k: (v if v.dtype in (torch.int8, torch.float32) else v.float()).cpu()
        for k, v in state.items()})
    bs, kv = (BS_Q8, "int8") if quant else (BS, None)
    tag = "int8 weights and cache, " if quant else ""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
    steps = rng.integers(0, cfg.vocab_size, 8).tolist()
    _hold_card_to_cpu(
        torch, f"default path: 2-layer {width} width, {tag}300-token prompt over a 128-token "
        "prefix + 8 decode steps",
        lambda: _forward_logits(torch, gpu, torch.device("cuda"), prompt, steps, 128, bs, kv),
        lambda: _forward_logits(torch, cpu, torch.device("cpu"), prompt, steps, 128, bs, kv), card)

    # a packed prefill of A, B and C's head, then a mixed dispatch: decode
    # rows for A and B ahead of D from 0 and C's rest from 128
    a, b, c, d = (rng.integers(0, cfg.vocab_size, n).tolist() for n in (200, 97, 300, 150))
    x, y = rng.integers(0, cfg.vocab_size, 2).tolist()
    tables, nxt = [], 1
    for n in (201, 98, 300, 150):
        nb = -(-n // bs)
        tables.append(list(range(nxt, nxt + nb)))
        nxt += nb
    dispatches = [
        ([(a, 0, tables[0]), (b, 0, tables[1]), (c[:128], 0, tables[2])], 0),
        ([([x], 200, tables[0]), ([y], 97, tables[1]), (d, 0, tables[3]),
          (c[128:], 128, tables[2])], bs),
    ]
    _hold_card_to_cpu(
        torch, f"ragged: 2-layer {width} width, {tag}packed prefill of 3 spans, then 2 decode "
        "rows + 2 spans",
        lambda: _ragged_logits(torch, gpu, torch.device("cuda"), dispatches, bs, kv),
        lambda: _ragged_logits(torch, cpu, torch.device("cpu"), dispatches, bs, kv), card)
    if verify:
        # three rows: all five verify tokens live, three, and one (a row
        # whose proposal is empty)
        s = SPEC_VERIFY_S[0]
        rows = [(rng.integers(0, cfg.vocab_size, n).tolist(),
                 rng.integers(0, cfg.vocab_size, live).tolist())
                for n, live in ((300, s), (97, 3), (640, 1))]
        _hold_card_to_cpu(
            torch, f"verify: 2-layer {width} width, {tag}one S={s} dispatch over prefixes of "
            "300, 97 and 640 tokens, 5, 3 and 1 live queries",
            lambda: _verify_logits(torch, gpu, torch.device("cuda"), rows, bs, kv),
            lambda: _verify_logits(torch, cpu, torch.device("cpu"), rows, bs, kv), card)
    del gpu, cpu, state
    torch.cuda.empty_cache()


# ------------------------------------------------------------------- fp16
# The fp16 model (Llama-3-8B architecture in float16, as Llama-2's published
# checkpoints are stored and `--dtype half` serves): the default path at
# full depth, the planes that carry the other fp16 bodies (token budget,
# int8 weights and cache) at this depth, as the bf16 planes
FP16_PLANE_LAYERS = BF16_PLANE_LAYERS


def llama3_8b_fp16(num_layers: int = 32):
    cfg = llama3_8b(num_layers)
    cfg.dtype = "float16"
    return cfg


def _fp16_model(torch, layers: int, quantized: bool = False):
    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = llama3_8b_fp16(layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda", quantized=quantized))
    torch.cuda.synchronize()
    dtypes = {p.dtype for p in model.parameters()}
    check(dtypes <= {torch.float16, torch.int8, torch.float32} and torch.float16 in dtypes,
          f"fp16 model: parameter dtypes {dtypes}")
    log(f"serving: Llama-3-8B fp16{' int8 weights' if quantized else ''}, {layers} layers, random "
        f"weights in {time.perf_counter() - t0:.1f} s")
    return model


def fp16_serving_phase(torch, card: str) -> dict:
    """The six requests on the Llama-3-8B architecture in float16 through
    ``AsyncLLMEngine``: the default path at full width and 32 layers (B1,
    B2), then at FP16_PLANE_LAYERS the token-budget path (B3, B1) and int8
    weights with an int8 cache, Bs 32, on the default and token-budget paths
    (B5, B4a, B4b; B4c).  Every kernel's counters are zeroed just before
    each run and read just after: the run's path must have launched each of
    its fp16 bodies and no bf16 body.  The 32-layer model's logits over a
    300-token prompt and 8 decode steps must be finite.  Returns each run
    by its label."""
    import numpy as np

    from dynamo_tpu_torch.ops.kernels import wrappers

    runs = {}

    def run(model, config, label, need):
        r = serve_run(torch, model, config, card, label)
        hf = r["launches_fp16"]
        bf = {k: n - hf.get(k, 0) for k, n in r["launches"].items()}
        check(all(hf[k] > 0 for k in need) and not any(bf.values()),
              f"{label}: fp16 launches {hf}, need {need} > 0; bf16 launches {bf} must be 0")
        runs[label] = r

    model = _fp16_model(torch, 32)
    run(model, DEFAULT_PATH, "fp16 default path", ["decode", "prefill"])
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, LLAMA3_VOCAB, 300).tolist()
    logits = _forward_logits(torch, model, torch.device("cuda"), prompt,
                             rng.integers(0, LLAMA3_VOCAB, 8).tolist(), 128)
    check(bool(torch.isfinite(logits).all()), "fp16 32-layer model: non-finite logits")
    log(f"fp16 32-layer model: logits of 9 dispatches finite, max |logit| "
        f"{logits.abs().max().item():.3f} ({card})")
    del model
    torch.cuda.empty_cache()
    model = _fp16_model(torch, FP16_PLANE_LAYERS)
    run(model, BUDGET_PATH, f"fp16 token-budget path, {FP16_PLANE_LAYERS} layers", ["ragged", "decode"])
    del model
    torch.cuda.empty_cache()
    model = _fp16_model(torch, FP16_PLANE_LAYERS, quantized=True)
    run(model, INT8_DEFAULT_PATH, f"fp16 int8 default path, {FP16_PLANE_LAYERS} layers",
        ["decode_q8", "prefill_q8", "matmul"])
    run(model, INT8_BUDGET_PATH, f"fp16 int8 token-budget path, {FP16_PLANE_LAYERS} layers",
        ["ragged_q8", "decode_q8", "matmul"])
    del model
    torch.cuda.empty_cache()
    check(not any(getattr(fn, "launches_fp16", 0) for k, fn in wrappers().items() if k.startswith("moe")),
          "fp16: a grouped expert kernel counted an fp16 launch")
    return runs


def fp16_refusals(torch, card: str) -> None:
    """On the card a float32 model and a float16 Qwen3-MoE model (2 layers
    at Qwen3-30B-A3B width) are refused at construction, each naming the
    kernel that has no body for it; a float16 dense model with an int8
    cache is accepted."""
    from dynamo_tpu_torch.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.llama import LlamaModel

    def refusal(cfg):
        model = LlamaModel(cfg, device="cuda")
        try:
            EngineCore(model, EngineConfig(max_model_len=64, num_blocks=8), device="cuda").close()
            return None
        except ValueError as e:
            return str(e)
        finally:
            del model
            torch.cuda.empty_cache()

    fp32 = refusal(ModelConfig.tiny(dtype="float32"))
    check(fp32 is not None and "float32" in fp32 and "no kernel" in fp32,
          f"fp16 refusals: a float32 model on cuda was not refused by name: {fp32}")
    moe_cfg = qwen3_30b_a3b(2)
    moe_cfg.dtype = "float16"
    moe = refusal(moe_cfg)
    check(moe is not None and "mixture-of-experts" in moe and "E1/E2" in moe,
          f"fp16 refusals: a float16 Qwen3-MoE model on cuda was not refused by name: {moe}")
    EngineCore(LlamaModel(ModelConfig.tiny(dtype="float16"), device="cuda"),
               EngineConfig(max_model_len=64, num_blocks=8, cache_dtype="int8"), device="cuda").close()
    log(f"fp16 refusals on the card at construction: float32 {fp32!r}; float16 Qwen3-MoE {moe!r}; a "
        f"float16 dense model with an int8 cache accepted ({card})")


FP16_CLI_TOKENS = 16


def fp16_cli_phase(card: str) -> dict:
    """The front door in float16, at once: ``run in=http out=gpu --dtype
    float16`` on the 2-layer checkpoint, and the same checkpoint converted
    by ``quantize --scheme none --dtype float16`` into a native fp16
    checkpoint, served without ``--dtype`` (it keeps its stored dtype):
    one streamed 300-token completion each, the same greedy text from both;
    and ``run ... --dtype float32``, which must exit non-zero at
    construction with the refusal."""
    import aiohttp

    body = {"model": FRONT_MODEL, "max_tokens": FP16_CLI_TOKENS, "temperature": 0, "stream": True,
            "prompt": list(range(4000, 4300))}
    out = {}
    native_dir = FRONT_DIR / "native-fp16"

    def serve(key, model_dir, flags=()):
        with cli_server(model_dir, flags) as (base, wait_ready):
            async def go():
                async with aiohttp.ClientSession() as s:
                    ready = await wait_ready(s)
                    return ready, await _post(s, base + "/v1/completions", body)

            ready, (status, events, first) = asyncio.run(go())
        check(status == 200 and events[-1] == "[DONE]" and
              events[-2]["choices"][0]["finish_reason"] == "length",
              f"fp16 CLI {key}: {status} {events[-3:]}")
        out[key] = dict(ready_s=ready, first_s=first, text=_text(events))

    def native():
        t0 = time.perf_counter()
        q = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch", "quantize", str(FRONT_DIR),
                            str(native_dir), "--scheme", "none", "--dtype", "float16"],
                           cwd=str(ROOT), capture_output=True, text=True, timeout=300)
        check(q.returncode == 0, f"fp16 quantize --scheme none: {q.stderr[-2000:]}")
        out["quantize_s"] = time.perf_counter() - t0
        serve("native fp16 checkpoint", native_dir)

    def refused():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch", "run", "in=http", "out=gpu",
                            "--model-path", str(FRONT_DIR), "--model-name", FRONT_MODEL, "--http-port",
                            "0", "--dtype", "float32"], cwd=str(ROOT), capture_output=True, text=True,
                           timeout=300)
        check(r.returncode != 0 and "model dtype 'float32' on cuda: no kernel" in r.stderr,
              f"run --dtype float32: exit {r.returncode}, {r.stderr[-2000:]}")
        out["fp32_refused"] = dict(rc=r.returncode, s=time.perf_counter() - t0,
                                   message=r.stderr.strip().splitlines()[-1])

    concurrently(lambda: serve("--dtype float16", FRONT_DIR, ("--dtype", "float16")), native, refused)
    check(out["--dtype float16"]["text"] == out["native fp16 checkpoint"]["text"],
          f"fp16 CLI: run --dtype float16 answered {out['--dtype float16']['text']!r}, the native fp16 "
          f"checkpoint {out['native fp16 checkpoint']['text']!r}")
    log(f"fp16 front door: `run in=http out=gpu --dtype float16` answered a streamed completion "
        f"(/health after {out['--dtype float16']['ready_s']:.1f} s, first text "
        f"{out['--dtype float16']['first_s']:.3f} s); `quantize --scheme none --dtype float16` "
        f"({out['quantize_s']:.1f} s) then `run` on the native checkpoint gave the same text; `run "
        f"--dtype float32` exited {out['fp32_refused']['rc']} at construction: "
        f"{out['fp32_refused']['message']!r} ({card})")
    return out


# --------------------------------------------------------------- front door
# A 2-layer HF checkpoint at Llama-3-8B width (3.0 GB in bf16), written by
# this script into a git-ignored directory beside it and removed at the end
FRONT_DIR = ROOT / "_frontdoor"
FRONT_LAYERS = 2
FRONT_MODEL = "front"
FRONT_MAX_TOKENS = 16
# the word-level tokenizer's special tokens, at Llama 3's ids (128,000 on)
# or, for a larger vocabulary, at the same places in its last 256 ids; ids
# 0-2 are the chat roles and the rest up to the specials the words w3 ...
SPECIALS = {"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001, "<unk>": 128002,
            "<|start_header_id|>": 128006, "<|end_header_id|>": 128007, "<|eot_id|>": 128009}
ROLES = ("system", "user", "assistant")
LLAMA3_VOCAB = 128256


def specials(vocab: int = LLAMA3_VOCAB) -> dict[str, int]:
    return {t: i + vocab - LLAMA3_VOCAB for t, i in SPECIALS.items()}


def eos_ids(vocab: int = LLAMA3_VOCAB) -> list[int]:
    sp = specials(vocab)
    return [sp["<|end_of_text|>"], sp["<|eot_id|>"]]
# Llama 3's chat layout, spaced for a whitespace tokenizer; it emits BOS
# itself, so the preprocessor must not add a second one
CHAT_TEMPLATE = (
    "{{ bos_token }}{% for m in messages %}<|start_header_id|> {{ m['role'] }} <|end_header_id|> "
    "{{ m['content'] }} <|eot_id|> {% endfor %}"
    "{% if add_generation_prompt %}<|start_header_id|> assistant <|end_header_id|>{% endif %}")
FRONT_CHAT = [{"role": "system", "content": "w5 w6"}, {"role": "user", "content": "w7 w8 w9"}]
# BOS, then 6 + 7 tokens of the two turns and 3 of the generation prompt
FRONT_CHAT_TOKENS = 17
# (port name, HF name with {i} for the layer, whether HF stores it [out, in])
FRONT_NAMES = {
    "embed": ("model.embed_tokens.weight", False), "final_norm": ("model.norm.weight", False),
    "lm_head": ("lm_head.weight", True),
    "layers.attn_norm": ("model.layers.{i}.input_layernorm.weight", False),
    "layers.mlp_norm": ("model.layers.{i}.post_attention_layernorm.weight", False),
    "layers.wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "layers.wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "layers.wv": ("model.layers.{i}.self_attn.v_proj.weight", True),
    "layers.wo": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "layers.w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "layers.w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "layers.w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
}
# the in-process servers' bf16 flags, and the int8 token-budget ones
FRONT_FLAGS = ["--max-model-len", "2048", "--num-blocks", "256"]
FRONT_INT8_FLAGS = FRONT_FLAGS + ["--quantize", "int8", "--kv-cache-dtype", "int8",
                                  "--block-size", "32", "--prefill-token-budget", "1024",
                                  "--unified-token-dispatch", "--lookahead-dispatch"]


def write_tokenizer(d: Path, size: int = LLAMA3_VOCAB) -> None:
    """A word-level tokenizer of ``size`` ids (Llama 3's 128,256 unless
    named; BOS added on encode) and a tokenizer_config.json with the chat
    template."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    sp, first = specials(size), size - 256
    vocab = {r: i for i, r in enumerate(ROLES)}
    vocab.update({f"w{i}": i for i in range(len(ROLES), first)})
    vocab.update(sp)
    vocab.update({f"<|reserved_special_token_{i}|>": i for i in range(first, size)
                  if i not in sp.values()})
    tk = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tk.add_special_tokens([t for t, i in sorted(vocab.items(), key=lambda x: x[1]) if i >= first])
    bos = sp["<|begin_of_text|>"]
    tk.post_processor = processors.TemplateProcessing(
        single="<|begin_of_text|> $A", special_tokens=[("<|begin_of_text|>", bos)])
    d.mkdir(parents=True, exist_ok=True)
    tk.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "chat_template": CHAT_TEMPLATE, "bos_token": "<|begin_of_text|>",
        "eos_token": "<|eot_id|>"}))


def write_checkpoint(torch, d: Path) -> float:
    """The 2-layer checkpoint: config.json and random bf16 weights from a
    seeded generator (matrices N(0, 1/fan_in), norms 1 + N(0, 0.1^2)) in
    two safetensors shards with an index.  Returns the bytes written."""
    from safetensors.torch import save_file

    cfg = llama3_8b(FRONT_LAYERS)
    dm, hd, f = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    (d / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": dm, "intermediate_size": f,
        "num_hidden_layers": FRONT_LAYERS, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings, "rms_norm_eps": 1e-5,
        "hidden_act": "silu", "tie_word_embeddings": False, "bos_token_id": 128000,
        "eos_token_id": eos_ids(), "torch_dtype": "bfloat16"}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)

    def matrix(rows, cols):  # HF layout [out, in]
        w = torch.randn((rows, cols), generator=gen, device="cuda", dtype=torch.float32)
        return w.div_(math.sqrt(cols)).to(torch.bfloat16).cpu()

    def norm():
        w = 1 + 0.1 * torch.randn((dm,), generator=gen, device="cuda", dtype=torch.float32)
        return w.to(torch.bfloat16).cpu()

    def layer(i):
        p = f"model.layers.{i}."
        return {p + "input_layernorm.weight": norm(), p + "post_attention_layernorm.weight": norm(),
                p + "self_attn.q_proj.weight": matrix(cfg.num_heads * hd, dm),
                p + "self_attn.k_proj.weight": matrix(cfg.num_kv_heads * hd, dm),
                p + "self_attn.v_proj.weight": matrix(cfg.num_kv_heads * hd, dm),
                p + "self_attn.o_proj.weight": matrix(dm, cfg.num_heads * hd),
                p + "mlp.gate_proj.weight": matrix(f, dm), p + "mlp.up_proj.weight": matrix(f, dm),
                p + "mlp.down_proj.weight": matrix(dm, f)}

    shards = [{"model.embed_tokens.weight": matrix(cfg.vocab_size, dm), **layer(0)},
              {**layer(1), "model.norm.weight": norm(), "lm_head.weight": matrix(cfg.vocab_size, dm)}]
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, str(d / name), metadata={"format": "pt"})
        weight_map.update({t: name for t in shard})
        total += sum(t.numel() * t.element_size() for t in shard.values())
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def check_loaded(torch, model, d: Path, label: str, names: dict = FRONT_NAMES,
                 experts: int = 0, first_layer: dict | None = None) -> None:
    """Every parameter the loader built equals the shards' tensor,
    transposed where HF stores [out, in] and stacked over the layers of its
    group (``layers.``, or DeepSeek's ``dense_layers.`` / ``moe_layers.``,
    whose slot j is HF layer ``first_layer[group] + j``) and the
    ``experts`` of a name with ``{e}``: exactly in bf16; for int8 weights,
    the codes and scales equal the quantisation of the shards' bf16
    tensor."""
    from safetensors import safe_open

    from dynamo_tpu_torch.models.quant import quantize

    index = json.loads((d / "model.safetensors.index.json").read_text())["weight_map"]
    state = model.state_dict()
    n = 0
    for name, (fmt, transpose) in names.items():
        slots = [()]
        group = name.rpartition(".")[0]
        if group:
            depth = state[name].shape[0]
            slots = [(i, e) for i in range(depth) for e in range(experts)] if "{e}" in fmt else [
                (i,) for i in range(depth)]
        first = (first_layer or {}).get(group, 0)
        for slot in slots:
            key = fmt.format(i=first + slot[0], e=slot[-1]) if slot else fmt
            with safe_open(d / index[key], framework="pt", device="cuda") as f:
                w = f.get_tensor(key)
            w = w.t() if transpose else w
            got = state[name][slot]
            if name + "_scale" in state:
                qt = quantize(w, (0,) if name == "embed" else (-1,))
                same = torch.equal(got, qt.q) and torch.equal(state[name + "_scale"][slot], qt.scale)
            else:
                same = got.dtype == w.dtype and torch.equal(got, w)
            check(same, f"front door {label}: {name}{list(slot)} differs from the checkpoint's {key}")
            n += 1
    log(f"front door {label}: {n} loaded tensors equal the checkpoint's shards")


async def _post(session, url: str, body: dict) -> tuple:
    """(status, JSON body or the SSE events' data, seconds to the first SSE
    event that carries text or a finish)."""
    t0 = time.perf_counter()
    async with session.post(url, json=body) as r:
        if r.headers.get("Content-Type", "").split(";")[0] != "text/event-stream":
            return r.status, await r.json(), None
        events, first = [], None
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[6:]
            ev = data if data == "[DONE]" else json.loads(data)
            if first is None and ev != "[DONE]" and ev["choices"] and (
                    ev["choices"][0].get("text") or ev["choices"][0].get("delta", {}).get("content")
                    or ev["choices"][0].get("finish_reason")):
                first = time.perf_counter() - t0
            events.append(ev)
        return r.status, events, first


async def _timed_post(session, url: str, body: dict) -> tuple:
    """``_post``, with the seconds to the first text for a streamed answer
    and to the whole answer for a unary one."""
    t0 = time.perf_counter()
    status, answer, first = await _post(session, url, body)
    return status, answer, first if first is not None else time.perf_counter() - t0


def _text(events) -> str:
    """The text of one choice's SSE events (completion or chat)."""
    return "".join(e["choices"][0].get("text") or e["choices"][0].get("delta", {}).get("content")
                   or "" for e in events if e != "[DONE]" and e["choices"])


def _front_requests(shift: int = 0) -> list[tuple[str, dict]]:
    """The requests a server answers one at a time and a fresh engine
    replays: (path, body), all greedy.  ``shift`` moves every prompt's
    words and ids (the same shapes, no shared prefix: a warm-up pass)."""
    base = {"model": FRONT_MODEL, "max_tokens": FRONT_MAX_TOKENS, "temperature": 0}
    words = " ".join(f"w{i}" for i in range(1000 + shift, 1030 + shift))
    chat = [{"role": m["role"], "content": " ".join(f"w{int(w[1:]) + shift}"
                                                    for w in m["content"].split())}
            for m in FRONT_CHAT]
    return [
        ("/v1/completions", {**base, "prompt": words}),
        ("/v1/completions", {**base, "prompt": list(range(2000 + shift, 2300 + shift)),
                             "stream": True}),
        ("/v1/chat/completions", {**base, "messages": chat, "stream": True}),
        ("/v1/completions", {**base, "prompt": words[:60], "logprobs": 3}),
    ]


def _detok(tokenizer, toks) -> str:
    """Tokens to text as the serving path's detokenizer streams them (a
    special token in the middle drops the space before the next word,
    where ``decode`` of the whole list keeps it)."""
    stream = tokenizer.decode_stream()
    return "".join(stream.step(t) for t in toks)


def _answer_text(answer) -> str:
    if isinstance(answer, list):
        return _text(answer)
    c = answer["choices"][0]
    return c["text"] if "text" in c else c["message"]["content"]


@contextlib.contextmanager
def served_process(name: str, args, log_path: Path, env=None, grace_s: float = 90):
    """``python3 -m dynamo_tpu_torch ARGS`` as a user starts it, in a
    process group of its own, its output in ``log_path``.  Yields a
    namespace: ``proc``, ``tail()`` (the log's end) and ``alive(what, t0,
    limit)``, which fails the phase with the log when the process has
    exited or ``limit`` seconds have passed since ``t0``.  On leaving:
    SIGTERM to the process alone (a supervisor stops its own workers),
    ``grace_s`` to exit, then SIGKILL to whatever is left of its group; it
    must have exited 0 with nothing left."""
    import os
    import signal
    from types import SimpleNamespace

    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch", *args], cwd=str(ROOT),
                                env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)

    def tail() -> str:
        return log_path.read_text()[-3000:]

    def alive(what: str, t0: float, limit: float = 300.0) -> None:
        check(proc.poll() is None and time.perf_counter() - t0 < limit, f"{name}: {what}: " + tail())

    try:
        yield SimpleNamespace(proc=proc, tail=tail, alive=alive)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            rc = None
        try:  # whatever is left of the process group (nothing, on the normal path)
            os.killpg(proc.pid, signal.SIGKILL)
            leftover = True
        except ProcessLookupError:
            leftover = False
        if rc is None:
            rc = proc.wait()
    check(rc == 0 and not leftover,
          f"{name} exited {rc} on SIGTERM, processes left: {leftover}: " + tail())


@contextlib.contextmanager
def cli_server(model_dir: Path, flags=()):
    """``python3 -m dynamo_tpu_torch run in=http out=gpu`` on ``model_dir``
    (with ``flags``) as a subprocess, as a user starts it; yields (its base
    URL, a coroutine function waiting for /health that returns the seconds
    it took), then stops it with SIGTERM, which must exit 0.  Its log is
    ``cli.log`` in ``model_dir`` (``cli-quantize-int8.log`` with those
    flags) while it runs, one a server, so servers may run at once."""
    import socket

    import aiohttp

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    base = f"http://127.0.0.1:{port}"
    with served_process("the CLI server", [
            "run", "in=http", "out=gpu", "--model-path", str(model_dir), "--model-name",
            FRONT_MODEL, "--http-port", str(port), *flags],
            model_dir / ("-".join(["cli", *(f.lstrip("-") for f in flags)]) + ".log"),
            grace_s=60) as server:
        async def ready(s) -> float:
            while True:
                try:
                    async with s.get(f"{base}/health") as r:
                        health = await r.json()
                    break
                except aiohttp.ClientConnectionError:
                    server.alive("did not come up", t0)
                    await asyncio.sleep(0.25)
            check(health["models"] == [FRONT_MODEL], f"CLI /health: {health}")
            return time.perf_counter() - t0

        yield base, ready


def cli_phase(card: str, flags: tuple = (), label: str = "Llama-3-8B-width") -> None:
    """``python3 -m dynamo_tpu_torch run in=http out=gpu`` on the
    checkpoint (with ``flags``), as a user starts it: every request kind,
    /metrics, and a clean exit on SIGTERM."""
    import aiohttp

    with cli_server(FRONT_DIR, flags) as (base, wait_ready):
        async def go():
            async with aiohttp.ClientSession() as s:
                ready = await wait_ready(s)
                base_body = {"model": FRONT_MODEL, "max_tokens": FRONT_MAX_TOKENS,
                             "temperature": 0}
                words = " ".join(f"w{i}" for i in range(3000, 3020))
                answers = {}
                for kind, path, body in [
                    ("unary", "/v1/completions", {**base_body, "prompt": words}),
                    ("stream", "/v1/completions", {**base_body, "prompt": words, "stream": True}),
                    ("chat", "/v1/chat/completions", {**base_body, "messages": FRONT_CHAT,
                                                      "stream": True}),
                    ("n2", "/v1/completions", {**base_body, "prompt": words, "n": 2}),
                    ("logprobs", "/v1/completions", {**base_body, "prompt": words, "logprobs": 2}),
                    ("stop", "/v1/completions", {**base_body, "prompt": words, "stop": [" "]}),
                    ("404", "/v1/completions", {**base_body, "model": "nope", "prompt": words}),
                ]:
                    answers[kind] = await _post(s, base + path, body)
                async with s.get(f"{base}/metrics") as r:
                    metrics = await r.text()
            return ready, answers, metrics

        ready, answers, metrics = asyncio.run(go())

    def finished(c, usage_tokens):
        return (c["finish_reason"] == "length" and usage_tokens == FRONT_MAX_TOKENS) or (
            c["finish_reason"] == "stop" and 1 <= usage_tokens <= FRONT_MAX_TOKENS)

    status, body, _ = answers["unary"]
    check(status == 200 and finished(body["choices"][0], body["usage"]["completion_tokens"]),
          f"CLI unary completion: {status} {body}")
    status, events, _ = answers["stream"]
    check(status == 200 and events[-1] == "[DONE]" and
          events[-2]["choices"][0]["finish_reason"] in ("length", "stop"),
          f"CLI streamed completion: {status} {events[-3:]}")
    status, events, _ = answers["chat"]
    check(status == 200 and events[0]["choices"][0]["delta"].get("role") == "assistant" and
          events[-1] == "[DONE]" and events[-2]["usage"]["prompt_tokens"] == FRONT_CHAT_TOKENS,
          f"CLI streamed chat (expected {FRONT_CHAT_TOKENS} prompt tokens through the template, "
          f"one BOS): {status} {events[:1]} {events[-2:]}")
    status, body, _ = answers["n2"]
    check(status == 200 and [c["index"] for c in body["choices"]] == [0, 1],
          f"CLI n=2: {status} {body}")
    status, body, _ = answers["logprobs"]
    lp = body["choices"][0]["logprobs"] if status == 200 else {}
    check(status == 200 and len(lp["tokens"]) == body["usage"]["completion_tokens"] and
          all(math.isfinite(v) and v <= 0 for v in lp["token_logprobs"]) and
          all(len(t) <= 2 for t in lp["top_logprobs"]), f"CLI logprobs: {status} {body}")
    status, body, _ = answers["stop"]
    c = body["choices"][0] if status == 200 else {}
    check(status == 200 and c["finish_reason"] == "stop" and " " not in c["text"],
          f"CLI stop string: {status} {body}")
    status, body, _ = answers["404"]
    check(status == 404 and body["error"]["type"] == "model_not_found", f"CLI 404: {status} {body}")
    from dynamo_tpu_torch.obs.metric_names import HttpMetric

    rows = dict(line.rsplit(" ", 1) for line in metrics.splitlines() if not line.startswith("#"))
    done = {ep: int(rows.get(f'{HttpMetric.REQUESTS_TOTAL}{{model="{FRONT_MODEL}",'
                             f'endpoint="{ep}",status="success"}}', 0))
            for ep in ("completions", "chat_completions")}
    check(done == {"completions": 5, "chat_completions": 1} and
          int(rows.get(f'{HttpMetric.OUTPUT_TOKENS_TOTAL}{{model="{FRONT_MODEL}"}}', 0)) > 0,
          f"CLI /metrics: requests {done}")
    log(f"front door CLI: `python3 -m dynamo_tpu_torch run in=http out=gpu{''.join(' ' + f for f in flags)}` "
        f"on the {FRONT_LAYERS}-layer {label} checkpoint answered /health after {ready:.1f} s, then unary, "
        f"streamed, chat, n=2, logprobs, stop-string and 404 requests, /metrics counted "
        f"{done}; exit 0 on SIGTERM ({card})")


GRAMMAR_DIR = FRONT_DIR / "bytes"
GRAMMAR_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                                   "n": {"type": "integer"}},
                  "required": ["ok", "n"]}


def write_byte_tokenizer(d: Path, size: int = LLAMA3_VOCAB) -> None:
    """A byte-level BPE with no merges (so every text is one token per
    byte and the grammar compiler sees real bytes): the 256 bytes in
    GPT-2's printable alphabet at ids 3-258, Llama 3's special tokens at
    their ids, filler entries up to ``size``; and a tokenizer_config.json
    with the chat template."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    from dynamo_tpu_torch.engine.grammar import _gpt2_unicode_to_bytes

    sp = specials(size)
    vocab = {r: i for i, r in enumerate(ROLES)}
    vocab.update({ch: 3 + b for ch, b in _gpt2_unicode_to_bytes().items()})
    vocab.update(sp)
    vocab.update({f"<|filler_{i}|>": i for i in range(259, size) if i not in sp.values()})
    tk = Tokenizer(models.BPE(vocab=vocab, merges=[], unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    tk.add_special_tokens(list(sp))
    d.mkdir(parents=True, exist_ok=True)
    tk.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "chat_template": CHAT_TEMPLATE, "bos_token": "<|begin_of_text|>",
        "eos_token": "<|eot_id|>"}))


def grammar_cli_phase(card: str) -> None:
    """The front-door checkpoint with a byte-level tokenizer, served by
    ``python3 -m dynamo_tpu_torch run in=http out=gpu``: a chat with a
    ``json_schema`` response format answers JSON of the schema's shape (or
    stops at max_tokens inside it), a ``guided_regex`` completion replays
    through the regex's tables, and one seeded completion sent twice gives
    the same text."""
    import aiohttp

    from dynamo_tpu_torch.engine.grammar import (
        compile_regex_vocab, compile_vocab, json_schema_to_regex)

    for f in FRONT_DIR.iterdir():
        if f.suffix in (".json", ".safetensors") and not f.name.startswith("tokenizer"):
            (GRAMMAR_DIR / f.name).parent.mkdir(parents=True, exist_ok=True)
            (GRAMMAR_DIR / f.name).symlink_to(f)
    write_byte_tokenizer(GRAMMAR_DIR)
    base_body = {"model": FRONT_MODEL, "max_tokens": 48}
    schema_format = {"type": "json_schema", "json_schema": {"name": "r", "schema": GRAMMAR_SCHEMA}}
    seeded = {**base_body, "prompt": "Once upon a time", "temperature": 0.9, "seed": 7}
    with cli_server(GRAMMAR_DIR) as (base, wait_ready):
        async def go():
            async with aiohttp.ClientSession() as s:
                ready = await wait_ready(s)
                answers = [await _post(s, base + path, body) for path, body in [
                    ("/v1/chat/completions", {**base_body, "temperature": 0,
                                              "messages": [{"role": "user", "content": "Report."}],
                                              "response_format": schema_format}),
                    ("/v1/completions", {**base_body, "temperature": 0, "prompt": "Phone: ",
                                         "guided_regex": GRAMMAR_REGEX}),
                    ("/v1/completions", seeded), ("/v1/completions", seeded)]]
            return ready, answers

        ready, answers = asyncio.run(go())
    check(all(a[0] == 200 for a in answers), f"grammar CLI: statuses {[a[:2] for a in answers]}")
    bytes_vocab = [bytes([b]) for b in range(256)]
    texts = [_answer_text(a[1]) for a in answers]
    reasons = [a[1]["choices"][0]["finish_reason"] for a in answers]
    schema_rx = json_schema_to_regex(GRAMMAR_SCHEMA)
    for i, (rx, text, reason) in enumerate(zip((schema_rx, GRAMMAR_REGEX), texts, reasons)):
        tables = compile_regex_vocab(bytes_vocab, rx)
        check(_replays(tables, list(text.encode()), ()) and (
            reason == "length" or re.fullmatch(rx, text)),
            f"grammar CLI answer {i} ({reason}): {text!r} is outside {rx}")
    if reasons[0] == "stop":
        json.loads(texts[0])
    check(_replays(compile_vocab(bytes_vocab), list(texts[0].encode()), ()),
          f"grammar CLI: the schema answer {texts[0]!r} leaves the JSON grammar")
    check(texts[2] == texts[3], f"grammar CLI: one seeded request gave {texts[2]!r} then "
                                f"{texts[3]!r}")
    log(f"grammar CLI: `python3 -m dynamo_tpu_torch run in=http out=gpu` on the {FRONT_LAYERS}-layer "
        f"checkpoint with a byte-level tokenizer answered /health after {ready:.1f} s; json_schema "
        f"chat {reasons[0]} {texts[0][:60]!r}, guided_regex {reasons[1]} {texts[1]!r}, the seeded "
        f"completion twice {texts[2][:40]!r}; exit 0 on SIGTERM ({card})")


def front_server(torch, flags: list[str], card: str, label: str, need: list[str],
                 none: list[str], names: dict = FRONT_NAMES, experts: int = 0,
                 first_layer: dict | None = None) -> tuple[list[str], list[float]]:
    """``build_local_engine`` on the checkpoint with ``flags`` behind the
    port's HttpService on port 0: the loaded tensors against the shards,
    then the requests one at a time with every kernel counter zeroed just
    before and read just after (the kernels in ``need`` must have
    launched, those in ``none`` not), then each answer against a fresh
    engine's greedy tokens on the same model and config, one at a time.
    Returns the fresh engine's texts, each HTTP answer's seconds to its
    first text (``_timed_post``) and, for each request, the prompt's ids and
    the fresh engine's output ids."""
    import aiohttp

    from dynamo_tpu_torch.cli import build_local_engine, parse_args
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineCore
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService
    from dynamo_tpu_torch.llm.openai import parse_request
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime.engine import Context

    args = parse_args(["run", "in=http", "out=gpu", "--model-path", str(FRONT_DIR),
                       "--model-name", FRONT_MODEL, *flags])
    engine, mcard = build_local_engine(args)
    model, config = engine.core.model, engine.core.config
    reqs = _front_requests()
    try:
        check_loaded(torch, model, FRONT_DIR, label, names, experts, first_layer)
        wrappers = _kernel_wrappers()

        async def serve():
            svc = HttpService(port=0, core=engine.core)
            svc.manager.add_model(FRONT_MODEL, build_serving_pipeline(engine, mcard), mcard)
            await svc.start()
            try:
                async with aiohttp.ClientSession() as s:
                    url = f"http://127.0.0.1:{svc.port}"
                    return [await _timed_post(s, url + path, body) for path, body in reqs]
            finally:
                await svc.stop()

        for fn in wrappers.values():
            fn.launches = 0
        answers = asyncio.run(serve())
        launches = {name: fn.launches for name, fn in wrappers.items()}
    finally:
        engine.shutdown()
    check(all(a[0] == 200 for a in answers), f"front door {label}: statuses {[a[0] for a in answers]}")
    check(all(launches[k] > 0 for k in need) and not any(launches[k] for k in none),
          f"front door {label}: launches {launches}, need {need} > 0, {none} = 0")

    fresh = AsyncLLMEngine(EngineCore(model, config, eos_token_ids=mcard.eos_token_ids or None,
                                      device="cuda")).start()
    pre = OpenAIPreprocessor(mcard)
    try:
        async def direct():
            out, ids = [], []
            for path, body in reqs:
                ctx = await pre.forward(Context(parse_request(body, chat="chat" in path)))
                prompt = list(ctx.data.token_ids)
                toks = [t async for o in fresh.generate(Context(ctx.data)) for t in o.token_ids]
                out.append(_detok(pre.tokenizer, toks))
                ids.append((prompt, toks))
            return out, ids

        texts, ids = asyncio.run(direct())
    finally:
        fresh.shutdown()
    got = [_answer_text(a[1]) for a in answers]
    check(got == texts, f"front door {label}: HTTP answers {got} != a fresh engine's {texts}")
    log(f"front door {label}: build_local_engine({' '.join(flags)}) behind HttpService; "
        f"{len(reqs)} requests one at a time (unary, streamed token-id prompt, streamed chat, "
        f"logprobs) equal a fresh engine's greedy text; launches {launches} ({card})")
    return texts, [a[2] for a in answers], ids


def front_door_phase(torch, card: str) -> dict:
    t0 = time.perf_counter()
    nbytes = write_checkpoint(torch, FRONT_DIR)
    log(f"front door: wrote a {FRONT_LAYERS}-layer Llama-3-8B-width checkpoint, "
        f"{nbytes / 1e9:.2f} GB in two shards, in {time.perf_counter() - t0:.1f} s")
    # the two CLI servers boot at once, each on its own port and log
    concurrently(lambda: cli_phase(card), lambda: grammar_cli_phase(card))
    texts, local_ttfts, ids = front_server(
        torch, FRONT_FLAGS, card, "bf16 default path", ["decode", "prefill"],
        ["decode_q8", "prefill_q8", "ragged", "ragged_q8", "matmul", "moe", "moe_q8"])
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    profile_phase(torch, card)
    torch.cuda.empty_cache()
    # the --tp 2 server's two ranks and the dyn:// worker boot at once
    mesh_cli = {}
    concurrently(lambda: mesh_cli.update(mesh_cli_phase(torch, card, texts, ids)),
                 lambda: dyn_phase(card, texts, local_ttfts))
    log(f"front door: profile, then --tp 2 and dyn:// phases at once, "
        f"{time.perf_counter() - t1:.1f} s ({card})")
    graphs = graphs_phase(card)
    torch.cuda.empty_cache()
    front_server(torch, FRONT_INT8_FLAGS, card, "int8 token-budget path",
                 ["decode_q8", "ragged_q8", "matmul"], ["decode", "prefill", "ragged", "moe", "moe_q8"])
    torch.cuda.empty_cache()
    formats = formats_phase(torch, card)
    log(f"front door: phase wall {time.perf_counter() - t0:.1f} s ({card})")
    return graphs, formats, mesh_cli


PROFILE_STEPS = 4
# the kernel symbols the profile window must show: B1 (the decode kernel
# over a bf16 cache) and B2 (the paged prefill kernel)
PROFILE_KERNELS = {"B1": "decode_kernel<__nv_bfloat16", "B2": "wgmma_prefill_kernel<"}


def profile_phase(torch, card: str) -> None:
    """``run --trace --profile-dir D --profile-steps 4``'s engine
    (``build_local_engine`` on the front-door checkpoint) behind
    HttpService: one traced completion long enough for the window's four
    dispatches; the window's Chrome trace must exist and hold B1's and B2's
    kernels, and ``/debug/traces/{id}``, fetched by the port's ``trace``
    command, must be one trace id whose ``engine.step`` spans carry their
    phases.  Logs one ``{"profile": ...}`` line."""
    import shutil

    import aiohttp

    from dynamo_tpu_torch.cli import build_local_engine, parse_args
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService
    from dynamo_tpu_torch.obs import tracing

    prof_dir = FRONT_DIR / "profile"
    shutil.rmtree(prof_dir, ignore_errors=True)
    args = parse_args(["run", "in=http", "out=gpu", "--model-path", str(FRONT_DIR),
                       "--model-name", FRONT_MODEL, *FRONT_FLAGS, "--trace", "--profile-dir",
                       str(prof_dir), "--profile-steps", str(PROFILE_STEPS)])
    was = tracing.enabled()
    tracing.enable(args.trace)  # what main() does for --trace
    tracing.collector.reset()
    engine, mcard = build_local_engine(args)
    rid = "profile-1"
    body = {"model": FRONT_MODEL, "prompt": " ".join(f"w{i}" for i in range(1100, 1400)),
            "max_tokens": 40, "temperature": 0}
    try:
        async def go():
            svc = HttpService(port=0, core=engine.core)
            svc.manager.add_model(FRONT_MODEL, build_serving_pipeline(engine, mcard), mcard)
            await svc.start()
            base = f"http://127.0.0.1:{svc.port}"
            try:
                async with aiohttp.ClientSession() as s:
                    async with s.post(f"{base}/v1/completions", json=body,
                                      headers={"x-request-id": rid}) as r:
                        answer = (r.status, await r.json())
                await engine.run_on_engine(lambda: None)  # the last step's span is in
                # the trace command, as a user runs it against this server
                proc = await asyncio.create_subprocess_exec(
                    sys.executable, "-m", "dynamo_tpu_torch", "trace", rid, "--url", base,
                    cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                out, err = await asyncio.wait_for(proc.communicate(), 120)
                return answer, proc.returncode, out, err
            finally:
                await svc.stop()

        t0 = time.perf_counter()
        (status, answer), rc, out, err = asyncio.run(go())
        wall = time.perf_counter() - t0
        steps = engine.core.steps
    finally:
        engine.shutdown()
        tracing.enable(was)
    check(status == 200 and answer["choices"][0]["finish_reason"] == "length",
          f"profile: completion {status} {answer}")
    check(rc == 0, f"profile: the trace command exited {rc}: {err.decode()[-2000:]}")
    doc = json.loads(out)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    trace_ids = {e["args"]["trace_id"] for e in spans}
    step_spans = [e for e in spans if e["name"] == "engine.step"]
    check(len(trace_ids) == 1 and step_spans and all(e["args"].get("phases_ms")
                                                    for e in step_spans),
          f"profile: /debug/traces/{rid}: {len(trace_ids)} trace ids, "
          f"{len(step_spans)} engine.step spans")
    windows = sorted(prof_dir.iterdir())
    check([w.name for w in windows] == ["steps-000000"] and (windows[0] / "trace.json").exists(),
          f"profile: windows {[w.name for w in windows]}")
    trace_path = windows[0] / "trace.json"
    chrome = json.loads(trace_path.read_text())
    kernels = [e for e in chrome["traceEvents"] if e.get("cat") == "kernel"]
    found = {}
    for b, sym in PROFILE_KERNELS.items():
        hits = [e for e in kernels if sym in e.get("name", "")]
        found[b] = dict(events=len(hits), device_ms=round(sum(e.get("dur", 0) for e in hits) / 1e3,
                                                          4))
    check(all(v["events"] > 0 for v in found.values()),
          f"profile: kernel events {found} in {len(kernels)} kernel events")
    line = dict(window=f"{windows[0].name}/trace.json", trace_mb=round(
        trace_path.stat().st_size / 1e6, 3), dispatches=steps, profile_steps=PROFILE_STEPS,
        kernel_events=len(kernels), kernels=found, trace_spans=len(spans),
        engine_step_spans=len(step_spans), phases_ms_first_step=step_spans[0]["args"]["phases_ms"],
        wall_s=round(wall, 3), card=card)
    log(json.dumps({"profile": line}))
    shutil.rmtree(prof_dir, ignore_errors=True)


@contextlib.contextmanager
def background_coordinator():
    """A CoordinatorServer on port 0, served by an event loop on a thread
    of its own; yields its URL and stops it on exit."""
    import threading

    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorServer

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="coordinator", daemon=True)
    thread.start()
    srv = asyncio.run_coroutine_threadsafe(
        CoordinatorServer(host="127.0.0.1", port=0).start(), loop).result(30)
    try:
        yield srv.url
    finally:
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()


DYN_ENDPOINT = "dyn://dynamo.backend.generate"


def dyn_phase(card: str, texts: list[str], local_ttfts: list[float]) -> None:
    """The distributed runtime as a user starts it: a coordinator (port 0,
    in this process), ``run in=dyn://dynamo.backend.generate out=gpu`` on
    the front-door checkpoint as a process of its own, ``models add``, and
    the ``http`` frontend, which discovers the model; the front-door
    requests one at a time over HTTP must answer the fresh engine's greedy
    texts of the bf16 front-door run, the worker must have loaded on a
    CUDA device, and every process must exit 0 on SIGTERM.  A warm-up pass
    of the same shapes (other words, no shared prefix) runs first, as the
    worker is a fresh process whose first calls pay the library loads and
    first cuBLAS calls.  Logs one ``{"dyn": ...}`` line with the remote
    seconds to first text, both passes, beside the in-process server's."""
    import socket
    import statistics

    import aiohttp

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        http_port = sk.getsockname()[1]
    logs = {name: FRONT_DIR / f"{name}.log" for name in ("worker", "http")}
    procs = {}
    t0 = time.perf_counter()
    # the stack stops the http frontend, then the worker, then the coordinator
    with background_coordinator() as coord, contextlib.ExitStack() as stack:
        def spawn(name, *args):
            procs[name] = stack.enter_context(served_process(
                f"dyn: the {name}", [*args, "--coordinator", coord], logs[name], grace_s=60))

        spawn("worker", "run", f"in={DYN_ENDPOINT}", "out=gpu", "--model-path",
              str(FRONT_DIR), "--model-name", FRONT_MODEL, *FRONT_FLAGS)
        spawn("http", "http", "--http-port", str(http_port))
        added = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch", "models", "add", FRONT_MODEL,
             DYN_ENDPOINT, "--model-path", str(FRONT_DIR), "--coordinator", coord],
            cwd=str(ROOT), capture_output=True, text=True, timeout=120)
        check(added.returncode == 0, f"dyn: models add: {added.stdout} {added.stderr}")
        while "serving front at" not in logs["worker"].read_text():
            for p in procs.values():
                p.alive("the worker did not come up", t0)
            time.sleep(0.25)
        worker_up = time.perf_counter() - t0
        base = f"http://127.0.0.1:{http_port}"

        async def go():
            async with aiohttp.ClientSession() as s:
                while True:  # the frontend up, and the model discovered
                    try:
                        async with s.get(f"{base}/v1/models") as r:
                            if [m["id"] for m in (await r.json())["data"]] == [FRONT_MODEL]:
                                break
                    except aiohttp.ClientConnectionError:
                        pass
                    procs["http"].alive("no model at the frontend", t0)
                    await asyncio.sleep(0.25)
                warm = [await _timed_post(s, base + path, body)
                        for path, body in _front_requests(shift=5000)]
                return warm, [await _timed_post(s, base + path, body)
                              for path, body in _front_requests()]

        warm, answers = asyncio.run(go())
    rcs = {name: p.proc.returncode for name, p in procs.items()}
    worker_log = logs["worker"].read_text()
    if any(a[0] != 200 for a in warm + answers):
        check(False, f"dyn: statuses {[a[0] for a in warm + answers]}, answers "
              f"{[a[1] for a in warm + answers if a[0] != 200]}; the frontend's log: "
              f"{logs['http'].read_text()[-6000:]}\nthe worker's log: {worker_log[-6000:]}")
    got = [_answer_text(a[1]) for a in answers]
    check(got == texts, f"dyn: answers {got} != a fresh engine's {texts}")
    loaded = [ln for ln in worker_log.splitlines() if "loaded" in ln and " on cuda" in ln]
    check(bool(loaded), "dyn: the worker's log names no CUDA device: " + worker_log[-2000:])
    remote = [a[2] for a in answers]
    line = dict(endpoint=DYN_ENDPOINT, requests=len(answers), worker_up_s=round(worker_up, 3),
                remote_ttft_median_s=round(statistics.median(remote), 4),
                remote_ttft_max_s=round(max(remote), 4),
                local_ttft_median_s=round(statistics.median(local_ttfts), 4),
                local_ttft_max_s=round(max(local_ttfts), 4),
                remote_ttft_s=[round(x, 4) for x in remote],
                remote_warm_up_ttft_s=[round(a[2], 4) for a in warm],
                local_ttft_s=[round(x, 4) for x in local_ttfts],
                worker_device=loaded[0].split(" on ", 1)[1], exit_codes=rcs, card=card)
    log(json.dumps({"dyn": line}))
    for path in logs.values():
        path.unlink(missing_ok=True)


GRAPH = "dynamo_tpu_torch.examples.llm.graphs.disagg:Frontend"
GRAPH_CONFIG = ROOT / "dynamo_tpu_torch" / "examples" / "llm" / "configs" / "disagg.yaml"
# the config's max-local-prefill-length here: of the front-door requests the
# 300-token one prefills remotely and the rest (9 to 31 tokens) locally; of
# each set of six token-id prompts all but the 17-token one prefill remotely
GRAPH_LOCAL_PREFILL = 64
# each service's component and one endpoint: the graph is up once all four
# are discovered (the Frontend registers after its HTTP server listens)
GRAPH_ENDPOINTS = {"frontend": "info", "processor": "process", "gpuworker": "generate",
                   "prefillworker": "status"}
GRAPH_WORKERS = ("Frontend", "Processor", "GpuWorker", "PrefillWorker")
GRAPH_BOOT_LIMIT_S = 300
# the kernels each worker process must launch over the measured requests,
# and no other: the decode worker decodes and prefills the short prompts,
# the prefill worker only prefills
GRAPH_KERNELS = {"GpuWorker": ("decode", "prefill", "matmul"),
                 "PrefillWorker": ("prefill", "matmul")}
# the words of the checkpoint's tokenizer (write_tokenizer); its specials
# decode to nothing
GRAPH_WORDS = re.compile("|".join(ROLES) + r"|w\d+")


def graph_prompts(seed: int = 11) -> list[list[int]]:
    """Six token-id prompts of PROMPT_LENS tokens, no two sharing a block."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, LLAMA3_VOCAB, n).tolist() for n in PROMPT_LENS]


def _seconds(xs: list) -> dict:
    import statistics

    return dict(n=len(xs), median_s=round(statistics.median(xs), 4) if xs else None,
                max_s=round(max(xs), 4) if xs else None, all_s=[round(x, 4) for x in xs])


def graph_stream(text: str, base: list[int], tok) -> list[int]:
    """An answer's token ids read from its text against ``base``, the ids
    the in-process engine gave for the same prompt: ``base`` itself while
    the words agree, else ``base`` up to the first word that differs and
    the answer's id there.  A special token decodes to nothing, so a parting
    at one lands on the next word and then fails the near-tie check."""
    got = [tok.token_to_id(w) for w in GRAPH_WORDS.findall(text)]
    shown = [(j, t) for j, t in enumerate(base) if tok.decode([t])]
    for k, (j, t) in enumerate(shown):
        check(k < len(got), f"graphs: the answer {text!r} ends before the in-process engine's "
              f"ids {base}")
        if got[k] != t:
            return base[:j] + [got[k]]
    if len(got) > len(shown):
        j = shown[-1][0] + 1 if shown else 0
        check(j < len(base), f"graphs: the answer {text!r} runs past the in-process engine's "
              f"ids {base}")
        return base[:j] + [got[len(shown)]]
    return list(base)


def graphs_phase(card: str) -> dict:
    """The disaggregated serving graph as a user starts it:
    ``DYNTPU_GPUS=0,0 python3 -m dynamo_tpu_torch serve GRAPH -f CONFIG``
    against a coordinator in this process, CONFIG the port's
    ``configs/disagg.yaml`` with the checkpoint, GRAPH_LOCAL_PREFILL, the
    checkpoint's tokenizer in the Processor and a free HTTP port.  Four
    processes; the GpuWorker and the PrefillWorker share card 0.  Requests,
    all streamed: a warm-up pass of the front-door requests' shapes over
    other words, then the measured ones: the front-door requests and six
    token-id prompts one at a time, then six other token-id prompts at once.
    Checks: the one-at-a-time texts equal an in-process engine's (the
    worker's ``build_engine`` on the same block, each delta decoded as the
    Processor decodes it), whose launches are B1, B2 and B5 and no other
    kernel; the concurrent answers equal that engine's one at a time but
    at a near tie; each worker process's own ``status`` counts its kernel
    launches over the measured requests, GRAPH_KERNELS and no other; the
    PrefillWorker's ``status`` counts every prompt above the threshold;
    both workers' logs name a CUDA device; on SIGTERM every process drains
    and exits 0.  The in-process engine then serves six prompts at once
    itself, every prefill local, as the one-process reading beside the
    graph's, on six other prompts of the same lengths (the concurrent ones
    are in its prefix cache by then).  Returns the ``{"graphs": ...}``
    line."""
    import os
    import socket

    import aiohttp
    import torch
    import yaml

    from dynamo_tpu_torch.examples.llm.components.frontend import processor_request
    from dynamo_tpu_torch.examples.llm.components.prefill_worker import PrefillWorker
    from dynamo_tpu_torch.examples.llm.components.processor import with_text, worker_payload
    from dynamo_tpu_torch.examples.llm.components.worker import (
        GpuWorker, backend_input, build_engine, wire_output)
    from dynamo_tpu_torch.llm.openai import parse_request
    from dynamo_tpu_torch.llm.preprocessor import PromptFormatter
    from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.sdk.config import ServiceConfig
    from dynamo_tpu_torch.sdk.service import ServiceClient

    t_phase = time.perf_counter()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        http_port = sk.getsockname()[1]
    cfg = yaml.safe_load(GRAPH_CONFIG.read_text())
    cfg["Common"]["model-path"] = str(FRONT_DIR)
    cfg["GpuWorker"]["max-local-prefill-length"] = GRAPH_LOCAL_PREFILL
    cfg["Processor"]["tokenizer"] = str(FRONT_DIR / "tokenizer.json")
    cfg["Frontend"]["port"] = http_port
    cfg_path = FRONT_DIR / "disagg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    served = cfg["Frontend"]["served_model_name"]

    def named(reqs):  # all streamed, so that each answer has its seconds to the first text
        return [(path, {**body, "model": served, "stream": True}) for path, body in reqs]

    def token_requests(seed):
        return named([("/v1/completions", {"prompt": toks, "max_tokens": FRONT_MAX_TOKENS,
                                           "temperature": 0}) for toks in graph_prompts(seed)])

    warm = named(_front_requests(shift=5000))
    one = named(_front_requests()) + token_requests(12)
    concurrent = token_requests(11)
    tok, fmt = TokenizerWrapper.from_file(FRONT_DIR), PromptFormatter(None)

    def payload(path, body) -> dict:  # what the Frontend and Processor send the worker
        return worker_payload(processor_request(parse_request(body, chat="chat" in path), fmt),
                              tok)

    def remote(reqs) -> list[bool]:
        return [len(payload(*r)["token_ids"]) > GRAPH_LOCAL_PREFILL for r in reqs]

    expected = sum(remote(warm) + remote(one) + remote(concurrent))
    check(any(remote(one)) and not all(remote(one)) and any(remote(concurrent)),
          f"graphs: threshold {GRAPH_LOCAL_PREFILL} does not split the prompts: "
          f"{remote(one)} {remote(concurrent)}")
    log_path = FRONT_DIR / "graphs.log"
    t0 = time.perf_counter()
    with background_coordinator() as coord, served_process(
            "graphs: serve", ["serve", GRAPH, "-f", str(cfg_path), "--coordinator", coord],
            log_path, env=dict(os.environ, DYNTPU_GPUS="0,0")) as serve:
        async def drive():
            rt = await DistributedRuntime.connect(RuntimeConfig(coordinator_url=coord))
            try:
                for comp, ep in GRAPH_ENDPOINTS.items():
                    client = await rt.namespace("dynamo").component(comp).endpoint(ep).client()
                    while not client.instance_ids():
                        serve.alive(f"{comp} did not come up", t0, GRAPH_BOOT_LIMIT_S)
                        await asyncio.sleep(0.25)
                    await client.close()
                boot = time.perf_counter() - t0
                workers = {"GpuWorker": ServiceClient(rt, GpuWorker),
                           "PrefillWorker": ServiceClient(rt, PrefillWorker)}

                async def status():
                    return {w: [x async for x in c.status({})][0] for w, c in workers.items()}

                base = f"http://127.0.0.1:{http_port}"
                async with aiohttp.ClientSession() as s:
                    warm_answers = [await _timed_post(s, base + p, b) for p, b in warm]
                    before = await status()
                    answers = [await _timed_post(s, base + p, b) for p, b in one]
                    t1 = time.perf_counter()
                    together = await asyncio.gather(*(_timed_post(s, base + p, b)
                                                      for p, b in concurrent))
                    wall = time.perf_counter() - t1
                deadline = time.perf_counter() + 30
                while True:  # handled counts after the queue ack, which trails the answer
                    after = await status()
                    if (after["PrefillWorker"]["handled"] >= expected
                            or time.perf_counter() > deadline):
                        break
                    await asyncio.sleep(0.1)
                for c in workers.values():
                    await c.close()
                launches = {w: {k: after[w]["launches"][k] - before[w]["launches"][k]
                                for k in after[w]["launches"]} for w in workers}
                return (boot, warm_answers, answers, together, wall,
                        after["PrefillWorker"]["handled"], launches)
            finally:
                await rt.shutdown()

        boot, warm_answers, answers, together, wall, handled, worker_launches = \
            asyncio.run(drive())
    serve_log = log_path.read_text()
    codes_line = [ln for ln in serve_log.splitlines() if "worker exit codes" in ln]
    codes = json.loads(codes_line[-1].split("worker exit codes ", 1)[1]) if codes_line else {}
    check(codes == {f"{w}:0": 0 for w in GRAPH_WORKERS}, f"graphs: worker exit codes {codes}")
    check("did not drain" not in serve_log and all(
        f"[{w}] INFO dynamo_tpu_torch.serve_worker: {w} drained and stopped" in serve_log
        for w in GRAPH_WORKERS), "graphs: a worker did not drain: " + serve_log[-3000:])
    devices = {}
    for w in ("GpuWorker", "PrefillWorker"):
        loaded = [ln for ln in serve_log.splitlines()
                  if ln.startswith(f"[{w}]") and "loaded" in ln and " on cuda" in ln]
        check(bool(loaded), f"graphs: the {w} log names no CUDA device: " + serve_log[-3000:])
        devices[w] = loaded[0].split(" on ", 1)[1]
    statuses = [a[0] for a in warm_answers + answers + together]
    check(all(st == 200 for st in statuses), f"graphs: statuses {statuses}")
    check(handled == expected, f"graphs: the PrefillWorker handled {handled} prompts, "
          f"{expected} are above the threshold {GRAPH_LOCAL_PREFILL}")
    for w, need in GRAPH_KERNELS.items():
        got = worker_launches[w]
        check(all(got[k] > 0 for k in need) and not any(v for k, v in got.items() if k not in need),
              f"graphs: the {w} process launched {got}, need {need} > 0 and no other")

    # the in-process twin: the worker's engine from the same block, each
    # delta decoded on its own as the Processor decodes it
    block = ServiceConfig(cfg).for_service("GpuWorker")
    engine, _ = build_engine(block)
    wrappers = _kernel_wrappers()
    try:
        async def alone(path, body):
            outs = [with_text(wire_output(o), tok) async for o in
                    engine.generate(Context(backend_input(payload(path, body))))]
            return "".join(o.get("text", "") for o in outs), [t for o in outs
                                                              for t in o["token_ids"]]

        async def twin():
            one_twin = [await alone(*r) for r in one]
            base = [await alone(*r) for r in concurrent]
            # six prompts of the concurrent ones' lengths at once on the one
            # engine, every prefill local and none a prefix hit: what the
            # graph's concurrent seconds are read against
            return one_twin, base, await _serve(
                engine, [payload(*r)["token_ids"] for r in token_requests(13)],
                max_tokens=FRONT_MAX_TOKENS, tag="graphs-twin")

        for fn in wrappers.values():
            fn.launches = 0
        one_twin, base, twin_together = asyncio.run(twin())
        launches = {name: fn.launches for name, fn in wrappers.items()}
        got = [_answer_text(a[1]) for a in answers]
        texts = [t for t, _ in one_twin]
        check(got == texts, f"graphs: answers {got} != the in-process engine's {texts}")
        need = ("decode", "prefill", "matmul")
        check(all(launches[k] > 0 for k in need) and not any(
            v for k, v in launches.items() if k not in need),
              f"graphs: the in-process engine's launches {launches}, need {need} > 0 and no other")
        # the concurrent answers: the twin's one at a time, but at a near tie
        # (the decode batch differs), re-scored on the twin's model
        streams = [ids for _, ids in base]
        parted = spec_near_ties(
            torch, engine.core.model,
            dict(streams=streams),
            dict(streams=[graph_stream(_answer_text(a[1]), ids, tok)
                          for a, ids in zip(together, streams)], label="graphs concurrent"),
            card, bs=int(block.get("block-size", 16)),
            prompts=[payload(*r)["token_ids"] for r in concurrent],
            sampling=[{"temperature": 0.0}] * len(concurrent), against="one at a time")
    finally:
        engine.shutdown()

    def split(reqs, results):
        flags = remote(reqs)
        return dict(remote=_seconds([r[2] for r, f in zip(results, flags) if f]),
                    local=_seconds([r[2] for r, f in zip(results, flags) if not f]))

    line = dict(graph=GRAPH, config=str(GRAPH_CONFIG.relative_to(ROOT)),
                changed={"model-path": "the 2-layer checkpoint",
                         "GpuWorker.max-local-prefill-length": GRAPH_LOCAL_PREFILL,
                         "Processor.tokenizer": "the checkpoint's tokenizer.json",
                         "Frontend.port": "a free port"},
                gpus="0,0", processes=list(GRAPH_WORKERS), boot_s=round(boot, 3),
                one_at_a_time=split(one, answers), concurrent=split(concurrent, together),
                concurrent_wall_s=round(wall, 3), concurrent_parted=parted,
                warm_up=split(warm, warm_answers),
                twin_concurrent=split(concurrent, [(None, None, r[0]) for r in twin_together]),
                prompt_tokens=dict(one=[len(payload(*r)["token_ids"]) for r in one],
                                   concurrent=[len(payload(*r)["token_ids"]) for r in concurrent]),
                remote_prefills=handled, expected_remote_prefills=expected,
                exit_codes=codes, worker_devices=devices, worker_launches=worker_launches,
                twin_launches=launches, seconds=round(time.perf_counter() - t_phase, 3),
                card=card)
    log(f"graphs: {GRAPH} up in {boot:.1f} s; {len(one)} requests one at a time equal the "
        f"in-process engine's texts, {len(concurrent) - parted} of {len(concurrent)} concurrent "
        f"ones too (the rest at a near tie), {handled} remote prefills, worker launches "
        f"{worker_launches}, exit codes {codes} ({card})")
    for path in (log_path, cfg_path):
        path.unlink(missing_ok=True)
    return line


# The Qwen3-MoE checkpoint: Qwen3-30B-A3B's width and tensor names, cut to
# 2 layers (3.7 GB: 384 expert tensors a layer), its 151,936-id vocabulary
MOE_FRONT_NAMES = {
    **{k: v for k, v in FRONT_NAMES.items() if k not in ("layers.w_gate", "layers.w_up", "layers.w_down")},
    "layers.q_norm": ("model.layers.{i}.self_attn.q_norm.weight", False),
    "layers.k_norm": ("model.layers.{i}.self_attn.k_norm.weight", False),
    "layers.router": ("model.layers.{i}.mlp.gate.weight", True),
    "layers.w_gate": ("model.layers.{i}.mlp.experts.{e}.gate_proj.weight", True),
    "layers.w_up": ("model.layers.{i}.mlp.experts.{e}.up_proj.weight", True),
    "layers.w_down": ("model.layers.{i}.mlp.experts.{e}.down_proj.weight", True),
}


def write_moe_checkpoint(torch, d: Path) -> float:
    """The 2-layer Qwen3-MoE checkpoint: config.json as Qwen3-30B-A3B's with
    2 layers, and random bf16 weights from a seeded generator (matrices
    N(0, 1/fan_in), norms 1 + N(0, 0.1^2)) under the real checkpoint's
    names, in two safetensors shards with an index.  Returns the bytes
    written."""
    from safetensors.torch import save_file

    cfg = qwen3_30b_a3b(FRONT_LAYERS)
    dm, hd, f, e = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.num_experts
    sp = specials(cfg.vocab_size)
    (d / "config.json").write_text(json.dumps({
        "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe",
        "vocab_size": cfg.vocab_size, "hidden_size": dm, "intermediate_size": 6144,
        "moe_intermediate_size": f, "num_hidden_layers": FRONT_LAYERS,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": hd, "num_experts": e, "num_experts_per_tok": cfg.num_experts_per_tok,
        "norm_topk_prob": True, "decoder_sparse_step": 1, "mlp_only_layers": [],
        "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "hidden_act": "silu", "tie_word_embeddings": False,
        "bos_token_id": sp["<|begin_of_text|>"], "eos_token_id": eos_ids(cfg.vocab_size),
        "torch_dtype": "bfloat16"}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def matrix(rows, cols):  # HF layout [out, in]
        w = torch.randn((rows, cols), generator=gen, device="cuda", dtype=torch.float32)
        return w.div_(math.sqrt(cols)).to(torch.bfloat16).cpu()

    def norm(n=dm):
        w = 1 + 0.1 * torch.randn((n,), generator=gen, device="cuda", dtype=torch.float32)
        return w.to(torch.bfloat16).cpu()

    def layer(i):
        p = f"model.layers.{i}."
        out = {p + "input_layernorm.weight": norm(), p + "post_attention_layernorm.weight": norm(),
               p + "self_attn.q_proj.weight": matrix(cfg.num_heads * hd, dm),
               p + "self_attn.k_proj.weight": matrix(cfg.num_kv_heads * hd, dm),
               p + "self_attn.v_proj.weight": matrix(cfg.num_kv_heads * hd, dm),
               p + "self_attn.o_proj.weight": matrix(dm, cfg.num_heads * hd),
               p + "self_attn.q_norm.weight": norm(hd), p + "self_attn.k_norm.weight": norm(hd),
               p + "mlp.gate.weight": matrix(e, dm)}
        for j in range(e):
            q = f"{p}mlp.experts.{j}."
            out.update({q + "gate_proj.weight": matrix(f, dm), q + "up_proj.weight": matrix(f, dm),
                        q + "down_proj.weight": matrix(dm, f)})
        return out

    shards = [{"model.embed_tokens.weight": matrix(cfg.vocab_size, dm), **layer(0)},
              {**layer(1), "model.norm.weight": norm(), "lm_head.weight": matrix(cfg.vocab_size, dm)}]
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, str(d / name), metadata={"format": "pt"})
        weight_map.update({t: name for t in shard})
        total += sum(t.numel() * t.element_size() for t in shard.values())
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def moe_front_door_phase(torch, card: str) -> None:
    """The front door on the 2-layer Qwen3-MoE checkpoint: the CLI server
    (bf16, and at once ``--quantize int8``), then ``build_local_engine`` in this
    process, bf16 on the default path (B1, B2, E1) and int8 weights and
    cache on the token-budget path (B4a, B4c, B5, E2)."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(FRONT_DIR, ignore_errors=True)
    cfg = qwen3_30b_a3b(FRONT_LAYERS)
    write_tokenizer(FRONT_DIR, cfg.vocab_size)
    nbytes = write_moe_checkpoint(torch, FRONT_DIR)
    n_files = len(json.loads((FRONT_DIR / "model.safetensors.index.json").read_text())["weight_map"])
    log(f"front door: wrote a {FRONT_LAYERS}-layer Qwen3-30B-A3B-width Qwen3-MoE checkpoint, "
        f"{nbytes / 1e9:.2f} GB, {n_files} tensors in two shards, in {time.perf_counter() - t0:.1f} s")
    concurrently(lambda: cli_phase(card, (), "Qwen3-MoE"),
                 lambda: cli_phase(card, ("--quantize", "int8"), "Qwen3-MoE"))
    front_server(torch, FRONT_FLAGS, card, "Qwen3-MoE bf16 default path", ["decode", "prefill", "moe"],
                 ["decode_q8", "prefill_q8", "ragged", "ragged_q8", "matmul", "moe_q8"],
                 MOE_FRONT_NAMES, cfg.num_experts)
    torch.cuda.empty_cache()
    front_server(torch, FRONT_INT8_FLAGS, card, "Qwen3-MoE int8 token-budget path",
                 ["decode_q8", "ragged_q8", "matmul", "moe_q8"], ["decode", "prefill", "ragged", "moe"],
                 MOE_FRONT_NAMES, cfg.num_experts)
    torch.cuda.empty_cache()
    log(f"front door Qwen3-MoE: phase wall {time.perf_counter() - t0:.1f} s ({card})")


def _http_run(model, mcard) -> tuple[list, float]:
    """One HTTP run on a fresh default-path engine: a warm-up request, then
    the six prompts concurrently; returns the answers and the wall time.
    Every stream must end on the length limit and the server must count
    MAX_TOKENS tokens out for each request, so that decode tok/s counts
    the tokens the streams carried."""
    import aiohttp

    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService

    engine = AsyncLLMEngine(EngineCore(model, EngineConfig(**DEFAULT_PATH), device="cuda")).start()

    async def go():
        svc = HttpService(port=0, core=engine.core)
        svc.manager.add_model(mcard.name, build_serving_pipeline(engine, mcard), mcard)
        await svc.start()
        try:
            async with aiohttp.ClientSession() as s:
                url = f"http://127.0.0.1:{svc.port}/v1/completions"

                def body(toks):
                    return {"model": mcard.name, "prompt": toks, "max_tokens": MAX_TOKENS,
                            "temperature": 0, "stream": True}

                await _post(s, url, body(list(range(1, 40))))  # warm-up, as the direct run
                t0 = time.perf_counter()
                out = await asyncio.gather(*(_post(s, url, body(p)) for p in prompts()))
                return out, time.perf_counter() - t0, svc.metrics.tokens_out[mcard.name]
        finally:
            await svc.stop()

    try:
        answers, wall, n_out = asyncio.run(go())
    finally:
        engine.shutdown()
    check(all(a[0] == 200 and a[1][-1] == "[DONE]" for a in answers),
          f"32-layer HTTP run: {[a[0] for a in answers]}")
    finishes = [[e["choices"][0]["finish_reason"] for e in a[1] if e != "[DONE]" and e["choices"]
                 and e["choices"][0].get("finish_reason")] for a in answers]
    check(all(f == ["length"] for f in finishes) and n_out == (len(answers) + 1) * MAX_TOKENS,
          f"32-layer HTTP run: finish reasons {finishes}, {n_out} tokens out for "
          f"{len(answers) + 1} requests of {MAX_TOKENS}")
    return answers, wall


def http_serving_run(torch, model, direct: dict, card: str) -> None:
    """The serving phase's bf16 model at BF16_PLANE_LAYERS behind the port's HttpService
    with the word-level tokenizer: the six prompts as token-id completions,
    concurrent and streamed, 32 greedy tokens each; TTFT at the client
    (first SSE event with text).  The host's speed drifts within a call, so
    the HTTP run sits between direct runs (direct, HTTP, direct, the first
    direct run being the default path's) and the front door's cost is the
    HTTP run's TTFT median minus the median of the direct runs'."""
    import statistics

    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper

    mcard = ModelDeploymentCard(name="llama3-8b", tokenizer_path=str(FRONT_DIR / "tokenizer.json"),
                                context_length=8192)
    tok = TokenizerWrapper.from_file(FRONT_DIR)
    runs = {"direct": [direct], "http": []}
    for turn in range(1):
        answers, wall = _http_run(model, mcard)
        ttfts = [a[2] for a in answers]
        runs["http"].append(dict(ttfts=ttfts, decode_tok_s=len(answers) * (MAX_TOKENS - 1) /
                                 (wall - min(ttfts))))
        same = sum(_text(a[1]) == _detok(tok, s) for a, s in zip(answers, direct["streams"]))
        log(f"serving over HTTP, run {turn + 1}: Llama-3-8B {model.config.num_layers} layers, "
            f"default path, the six prompts as token-id completions, concurrent, streamed, "
            f"{MAX_TOKENS} greedy tokens: wall {wall:.3f} s, TTFT min/median/max "
            f"{min(ttfts):.3f}/{sorted(ttfts)[len(ttfts) // 2]:.3f}/{max(ttfts):.3f} s at the client, "
            f"decode {runs['http'][-1]['decode_tok_s']:.1f} tok/s; {same} of {len(answers)} texts "
            f"equal the first direct run's (informational: batch timing differs) ({card})")
        runs["direct"].append(serve_run(torch, model, DEFAULT_PATH, card,
                                        f"default path beside HTTP, run {turn + 2}"))
    # a run's median as the serving lines print it (the upper of the six's two)
    med = {k: [sorted(r["ttfts"])[len(r["ttfts"]) // 2] for r in v] for k, v in runs.items()}
    tps = {k: [r["decode_tok_s"] for r in v] for k, v in runs.items()}
    cost = statistics.median(med["http"]) - statistics.median(med["direct"])
    log(f"front-door cost: TTFT medians over HTTP {[round(x, 3) for x in med['http']]} s, direct "
        f"{[round(x, 3) for x in med['direct']]} s: {1e3 * cost:.1f} ms per request (median of "
        f"the HTTP run minus median of the direct runs); decode tok/s over HTTP "
        f"{[round(x, 1) for x in tps['http']]}, direct {[round(x, 1) for x in tps['direct']]} "
        f"({card})")


# ---------------------------------------------------- disaggregated serving
# The prefill engine of the streamed run prefills in chunks of this many
# tokens (the six prompts: 1 to 6 chunks), so its first chunks' layers are
# on the wire while later chunks compute.
DISAGG_STREAM_CHUNK = 256
# tokens a request when served one at a time (M = 1 decode turns are the
# slowest a token; the token-for-token check needs no more)
DISAGG_ONE_BY_ONE_TOKENS = 16


def _bits(torch, t):
    """``t``'s bits as integers of its width, so equality is bitwise (NaN
    pad included)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def _parts(cache) -> tuple:
    return tuple(cache) if isinstance(cache, tuple) else (cache,)


def _checked_scatter(torch, dec_core, pre_core, record: dict):
    """Wrap the decode engine's ``scatter_external`` on its instance: after
    each handoff lands, the decode cache's blocks are held to the prefill
    engine's held blocks (the prefill worker releases them only after this
    write's reply), bit for bit, on the card without a sync; the results
    are read after the run.  Returns the function that removes the wrap."""
    real = dec_core.scatter_external

    def checking(block_ids, blocks, request_id=None):
        real(block_ids, blocks, request_id)
        held = pre_core.held_blocks(request_id)
        src = pre_core.gather_blocks_device(held[len(held) - len(block_ids):])
        dst = dec_core.gather_blocks_device(block_ids)
        record["differ"].append(torch.stack([(_bits(torch, a) != _bits(torch, b)).any()
                                             for a, b in zip(_parts(src), _parts(dst))]).any())
        record["blocks"] += len(block_ids)
        record["parts"].append([str(p.dtype).replace("torch.", "") for p in _parts(blocks)])

    dec_core.scatter_external = checking

    def unwrap():
        del dec_core.scatter_external  # no cycle keeps the engine alive

    return unwrap


async def _one_by_one(engine, reqs, tag: str) -> list:
    """``_serve`` of each request alone, in turn, DISAGG_ONE_BY_ONE_TOKENS
    tokens each: [(TTFT, seconds, outputs)]."""
    out = []
    for i, r in enumerate(reqs):
        out += await _serve(engine, [r], max_tokens=DISAGG_ONE_BY_ONE_TOKENS, tag=f"{tag}{i}")
    return out


def _streams(results) -> list:
    return [[t for o in outs for t in o.token_ids] for _, _, outs in results]


def _readings(results, wall: float, one_by_one: bool) -> dict:
    """Streams, TTFTs and decode tok/s of a ``_serve`` run: over the window
    from the first first token to the end, or, one request at a time, over
    the sum of each request's time after its first token."""
    ttfts = [r[0] for r in results]
    window = sum(r[1] - r[0] for r in results) if one_by_one else wall - min(ttfts)
    tokens = DISAGG_ONE_BY_ONE_TOKENS if one_by_one else MAX_TOKENS
    return dict(streams=_streams(results), ttfts=ttfts,
                decode_tok_s=len(results) * (tokens - 1) / window)


def local_one_by_one(torch, model, config: dict, label: str) -> dict:
    """The six prompts one at a time on a fresh local engine (the default
    path), after a warm-up: the streams a remote-prefill run serving them
    one at a time must equal, and the TTFT and tok/s it is read beside."""
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore

    engine = AsyncLLMEngine(EngineCore(model, EngineConfig(**config), device="cuda")).start()
    try:
        asyncio.run(_serve(engine, [list(range(1, 40))], tag=f"{label}-warm-up"))
        t0 = time.perf_counter()
        results = asyncio.run(_one_by_one(engine, model_prompts(model), f"{label}-"))
        return _readings(results, time.perf_counter() - t0, True)
    finally:
        engine.shutdown()


def _disagg_engines(torch, model, config: dict, *, stream: bool) -> tuple:
    """The two engines of one disaggregated run, started, sharing
    ``model``: (decode core, prefill core, decode engine, prefill engine);
    the prefill engine's prefill in DISAGG_STREAM_CHUNK-token chunks when
    ``stream``."""
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore

    dec = EngineCore(model, EngineConfig(**config), device="cuda")
    pre = EngineCore(model, EngineConfig(**(dict(config, prefill_chunk_tokens=DISAGG_STREAM_CHUNK)
                                            if stream else config)), device="cuda")
    dec_engine = AsyncLLMEngine(dec).start()
    try:
        return dec, pre, dec_engine, AsyncLLMEngine(pre).start()
    except BaseException:
        dec_engine.shutdown()
        raise


async def _disagg_serve(torch, engines: tuple, label: str, *, stream: bool, one_by_one: bool,
                        sanitizer=None) -> dict:
    """One disaggregated run on ``engines`` (:func:`_disagg_engines`): a
    coordinator in this process, the decode engine behind a DecodeWorker
    that sends every prompt to the prefill queue, and the prefill engine
    behind a PrefillWorker (streamed when ``stream``).  A warm-up request,
    then every launch counter zeroed and the six prompts served
    concurrently (``one_by_one``: one at a time); both engines are shut
    down before it returns.  Under ``sanitizer`` (the port's dtsan,
    installed before this run's event loop was made) the watched window
    opens here, inside the loop's main task, and is read after the servers
    and engines have shut down, as the pytest plugin reads at a test
    boundary: ``out["dtsan"]``."""
    from dynamo_tpu_torch.engine.counters import kv_stream_counters
    from dynamo_tpu_torch.llm.disagg_router import DisaggregatedRouter, DisaggRouterConf
    from dynamo_tpu_torch.llm.kv import transfer
    from dynamo_tpu_torch.llm.workers import DecodeWorker, PrefillWorker
    from dynamo_tpu_torch.obs.costs import transfer_costs
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer

    dec, pre, dec_engine, pre_engine = engines
    if sanitizer is not None:
        sanitizer.begin_epoch()
    clients, unwrap, out, srv = [], None, {}, None
    try:
        srv = await CoordinatorServer(port=0).start()
        c_dec = await CoordinatorClient(srv.url).connect()
        c_pre = await CoordinatorClient(srv.url).connect()
        clients += [c_dec, c_pre]
        worker = DecodeWorker(dec_engine, coordinator=c_dec, namespace=label,
                              router=DisaggregatedRouter(
                                  DisaggRouterConf(max_local_prefill_length=0), namespace=label))
        await worker.start()
        prefill = PrefillWorker(pre_engine, c_pre, label, stream=stream)
        prefill_task = asyncio.ensure_future(prefill.run())
        try:
            await _serve(worker, [list(range(1, 40))], tag=f"{label}-warm-up")
            # each request's queue push and the arrival of its notify
            pushed, notified = {}, {}
            real_push, real_notify = worker.queue.push, worker._transfer.notify_cb

            async def timed_push(rpr):
                pushed[rpr.request_id] = time.perf_counter()
                return await real_push(rpr)

            async def timed_notify(rid, first_token, error):
                notified[rid] = time.perf_counter()
                return await real_notify(rid, first_token, error)

            worker.queue.push, worker._transfer.notify_cb = timed_push, timed_notify
            record = dict(differ=[], blocks=0, parts=[])
            unwrap = _checked_scatter(torch, dec, pre, record)
            wrappers = _kernel_wrappers()
            for fn in wrappers.values():
                fn.launches = 0
            for k in transfer.stats:
                transfer.stats[k] = 0
            transfer_costs.reset()
            kv_stream_counters.reset()
            before = (dec.metrics()["prefill_dispatches_total"], pre.decode_steps)
            reqs = model_prompts(dec.model)
            t0 = time.perf_counter()
            if one_by_one:
                out.update(_readings(await _one_by_one(worker, reqs, f"{label}-"),
                                     time.perf_counter() - t0, True))
            else:
                results = await _serve(worker, reqs, tag=label)
                out.update(_readings(results, time.perf_counter() - t0, False))
            out["launches"] = {name: fn.launches for name, fn in wrappers.items()}
            out["stats"] = dict(transfer.stats)
            out["costs"] = {path: dict(e) for (_, _, path), e in transfer_costs.snapshot().items()}
            out["stream"] = dict(sessions=kv_stream_counters.sessions_total,
                                 layers_sent=kv_stream_counters.layers_sent_total,
                                 bytes=kv_stream_counters.bytes_total,
                                 fallbacks=kv_stream_counters.fallbacks_total,
                                 overlap_ratio=kv_stream_counters.overlap_ratio)
            out["decode_prefill_dispatches"] = dec.metrics()["prefill_dispatches_total"] - before[0]
            out["prefill_decode_steps"] = pre.decode_steps - before[1]
            out["handoff_ms"] = sorted(1e3 * (notified[r] - pushed[r]) for r in pushed if r in notified
                                       and "warm-up" not in r)
            torch.cuda.synchronize()
            out["blocks_checked"] = record["blocks"]
            out["blocks_differ"] = int(sum(bool(d) for d in record["differ"]))
            out["handoffs_checked"] = len(record["differ"])
            out["parts"] = record["parts"]
            out["kv_bytes_per_block"] = dec.kv_bytes_per_block()
        finally:
            prefill.request_stop()
            await prefill_task
            await worker.stop()
        out["held_after"] = len(pre._held)
    finally:
        if unwrap is not None:
            unwrap()
        for c in clients:
            await c.close()
        if srv is not None:
            await srv.stop()
        # off the loop: joining an engine's thread would hold the loop
        await asyncio.to_thread(dec_engine.shutdown)
        await asyncio.to_thread(pre_engine.shutdown)
        if sanitizer is not None:
            out["dtsan"] = dtsan_reading(sanitizer)
    return out


# the port's runtime sanitizer (dtsan) watches this disaggregated run: the
# streamed bf16 handoff over TCP with concurrent requests
DTSAN_RUN = "c"
# its blocking-callback threshold: the sanitizer's default (the pytest
# plugin's DYNAMO_SANITIZE_BLOCK_S unset)
DTSAN_BLOCK_S = 0.25


def dtsan_reading(san) -> dict:
    """What the sanitizer saw in its current window: tasks and transports
    made, the tasks still pending that nobody asked to cancel and the
    transports neither closed nor closing (each with its creation stack),
    frames written through the port's framing and the frame-protocol
    violations, and the loop callbacks over the threshold (each with the
    stack the watchdog sampled while it blocked and the garbage
    collector's time inside it)."""
    return dict(
        tasks_tracked=san.tasks.tracked_in_epoch(),
        leaked_tasks=[rec.render() for _, rec in san.tasks.pending_in_epoch()],
        transports_tracked=san.transports.tracked_in_epoch(),
        live_transports=[rec.render(t) for t, rec in san.transports.unclosed_in_epoch()],
        frames_checked=san.framing.frames_in_epoch,
        frame_violations=san.framing.violations_in_epoch(),
        blocking_callbacks=[dict(where=r.where, ms=round(1e3 * r.duration_s, 3),
                                 gc_ms=round(1e3 * r.gc_s, 3), stack=r.blocked_stack)
                            for r in san.blocking.reports_in_epoch()],
        threshold_s=san.blocking.threshold_s)


def disagg_run(torch, model, config: dict, label: str, *, stream: bool, one_by_one: bool,
               sanitize: bool = False) -> dict:
    """:func:`_disagg_serve` on a fresh engine pair in an event loop of its
    own; with ``sanitize``, the port's sanitizer in full mode is installed
    after the engines are built and before the loop is made, and
    uninstalled after it closes.  Adds ``serve_s`` (the loop's seconds) and,
    sanitized, the blocking callbacks seen up to the loop's close."""
    from dynamo_tpu_torch.analysis.sanitizer import MODE_FULL, Sanitizer

    engines = _disagg_engines(torch, model, config, stream=stream)
    san = Sanitizer(MODE_FULL, blocking_threshold_s=DTSAN_BLOCK_S).install() if sanitize else None
    t0 = time.perf_counter()
    try:
        r = asyncio.run(_disagg_serve(torch, engines, label, stream=stream,
                                      one_by_one=one_by_one, sanitizer=san))
        r["serve_s"] = time.perf_counter() - t0
        if san is not None:
            # asyncio.run's own teardown ran after the reading
            r["dtsan"]["blocking_callbacks"] = dtsan_reading(san)["blocking_callbacks"]
    finally:
        if san is not None:
            san.uninstall()
    return r


def dtsan_check(r: dict, plain: dict, name: str, card: str) -> None:
    """The ``{"dtsan": ...}`` line of the sanitized run ``r`` beside its
    unsanitized twin ``plain`` (the same run on a fresh engine pair, just
    after): what the sanitizer saw, each run's loop seconds and TTFTs, and
    the card.  Fails on any leaked task, live transport, frame violation
    or blocking callback, and if the twin did not stream as ``r`` did."""
    d = r["dtsan"]
    line = dict(run=name, mode="full", **d, seconds_sanitized=round(r["serve_s"], 3),
                seconds_plain=round(plain["serve_s"], 3),
                cost_ratio=round(r["serve_s"] / plain["serve_s"], 4),
                ttft_median_s=dict(sanitized=sorted(r["ttfts"])[len(r["ttfts"]) // 2],
                                   plain=sorted(plain["ttfts"])[len(plain["ttfts"]) // 2]),
                decode_tok_s=dict(sanitized=r["decode_tok_s"], plain=plain["decode_tok_s"]),
                card=card)
    log(json.dumps({"dtsan": line}))
    check(plain["stream"]["layers_sent"] > 0 and plain["stream"]["fallbacks"] == 0
          and plain["held_after"] == 0,
          f"{name} without the sanitizer: stream {plain['stream']}, {plain['held_after']} held")
    dtsan_clean(d, name)


def dtsan_clean(d: dict, name: str) -> None:
    """Fail on any leaked task, live transport, frame violation or
    blocking callback in the reading ``d``, each with its stack."""
    check(not (d["leaked_tasks"] or d["live_transports"] or d["frame_violations"]
               or d["blocking_callbacks"]),
          f"{name}: the sanitizer found {len(d['leaked_tasks'])} leaked tasks, "
          f"{len(d['live_transports'])} live transports, {len(d['frame_violations'])} frame "
          f"violations and {len(d['blocking_callbacks'])} callbacks over {d['threshold_s']} s:\n"
          + "\n\n".join(d["leaked_tasks"] + d["live_transports"] + d["frame_violations"]
                          + [f"{b['ms']} ms ({b['gc_ms']} ms in gc): {b['where']}\n{b['stack']}"
                             for b in d["blocking_callbacks"]]))


def dtsan_cost(torch, card: str, pairs: int) -> None:
    """``chip_smoke.py --dtsan-cost N``: DTSAN_RUN on the
    BF16_PLANE_LAYERS-layer bf16 Llama-3-8B (random weights), after one
    unmeasured warm-up run, N times under the sanitizer and N times without
    it in turns (on, off, off, on, ...), each on a fresh engine pair.
    Every sanitized run must find nothing and every run must stream without
    a fallback.  Logs one ``{"dtsan_cost": ...}`` line: each run's loop
    seconds and TTFT median, each side's median loop seconds, and their
    ratio."""
    import os
    import statistics

    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = llama3_8b(BF16_PLANE_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda"))
    _, _, stream, one_by_one = DISAGG_RUNS[DTSAN_RUN]
    sides = {True: [], False: []}
    os.environ["DYN_KV_TRANSFER_FORCE_TCP"] = "1"
    try:
        for i in range(-1, 2 * pairs):
            on = i >= 0 and i % 4 in (0, 3)
            name = f"dtsan cost {i} ({'on' if on else 'off'})" if i >= 0 else "dtsan warm-up"
            r = disagg_run(torch, model, DEFAULT_PATH, f"dtsan-cost-{i}", stream=stream,
                           one_by_one=one_by_one, sanitize=on)
            check(r["stream"]["layers_sent"] > 0 and r["stream"]["fallbacks"] == 0
                  and r["held_after"] == 0, f"{name}: stream {r['stream']}, "
                  f"{r['held_after']} held")
            if i >= 0:
                if on:
                    dtsan_clean(r["dtsan"], name)
                sides[on].append(dict(serve_s=round(r["serve_s"], 3),
                                      ttft_median_s=statistics.median(r["ttfts"])))
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("DYN_KV_TRANSFER_FORCE_TCP", None)
    med = {on: statistics.median(x["serve_s"] for x in runs) for on, runs in sides.items()}
    log(json.dumps({"dtsan_cost": dict(
        run=f"disagg ({DTSAN_RUN})", layers=BF16_PLANE_LAYERS, pairs=pairs,
        order="on, off, off, on, ...", sanitized=sides[True], plain=sides[False],
        median_sanitized_s=med[True], median_plain_s=med[False],
        ratio_of_medians=round(med[True] / med[False], 4), card=card)}))


def copy_yardsticks(torch, nbytes: int) -> dict:
    """The bound of each handoff path, timed on the card for ``nbytes``:
    a plain device-to-device copy (the colocated path moves the blocks so)
    and a device-to-host copy into pinned memory (the least the TCP path
    does), as MB/s; and the port's block gather + scatter of that many
    bytes of 2 MiB blocks (the colocated path's two copies) in ms."""
    from dynamo_tpu_torch.ops.block_copy import gather_blocks, scatter_blocks_inplace

    n = nbytes // 2
    src = torch.randn(n, device="cuda").to(torch.bfloat16)
    dst = torch.empty_like(src)
    host = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
    d2d = median_ms(lambda: cuda_time_ms(lambda i: dst.copy_(src), 10))
    d2h = median_ms(lambda: cuda_time_ms(lambda i: host.copy_(src, non_blocking=True), 5))
    del src, dst, host
    # blocks of Llama-3-8B's cache: [32, N, 2, 16, 1024] bf16, 2 MiB each
    blocks = max(1, nbytes // (32 * 2 * 16 * 1024 * 2))
    pool = torch.zeros((32, 2 * blocks + 1, 2, 16, 1024), dtype=torch.bfloat16, device="cuda")
    ids, to = list(range(1, blocks + 1)), list(range(blocks + 1, 2 * blocks + 1))
    block_ms = median_ms(lambda: cuda_time_ms(
        lambda i: scatter_blocks_inplace(pool, to, gather_blocks(pool, ids)), 5))
    del pool
    torch.cuda.empty_cache()
    return dict(bytes=nbytes, d2d_mb_s=nbytes / d2d / 1e3, d2h_pinned_mb_s=nbytes / d2h / 1e3,
                d2d_ms=d2d, d2h_ms=d2h, block_copy_ms=block_ms, block_copy_blocks=blocks)


DISAGG_RUNS = {
    # label: (cache, path, streamed, one request at a time); every run on a
    # fresh engine pair, so no run hits another's prefix cache
    "a1": ("bf16", "colocated", False, True),
    "c": ("bf16", "tcp", True, False),
    "d1": ("int8", "tcp", False, True),
    "d": ("int8", "tcp", True, False),
}


def disagg_phase(torch, model, local: dict, card: str, quant: bool = False) -> dict:
    """Disaggregated prefill/decode on the loaded Llama-3-8B: the bf16 runs
    of DISAGG_RUNS on the bf16 model, the int8 ones on the int8 model.
    Checks: each run's handoffs moved only on its path (the transfer
    stats), the streamed run sent layers and never fell back, the int8
    runs' parts are int8 + float32, the decode engine made no prefill
    dispatch and the prefill engine no decode turn, the launches are the
    default path's kernels of this model and no other, the moved blocks
    equal the prefill engine's held blocks bit for bit, no block stays
    held, the streams served one at a time equal a local engine's one at a
    time, and concurrent streams part from ``local`` (the default path's
    run of this call) only at near-ties.  DTSAN_RUN runs under the port's
    sanitizer in full mode, then once more without it for the sanitizer's
    cost (:func:`dtsan_check`: the ``dtsan`` line; any leak, live
    transport, frame violation or blocking callback fails).  Returns the
    runs' readings, each beside the local run it is read against."""
    import os

    config = INT8_DEFAULT_PATH if quant else DEFAULT_PATH
    labels = [k for k, v in DISAGG_RUNS.items() if (v[0] == "int8") == quant]
    need = ["decode_q8", "prefill_q8", "matmul"] if quant else ["decode", "prefill"]
    alone = local_one_by_one(torch, model, config, f"disagg-local-{'int8' if quant else 'bf16'}")
    runs = {}
    for label in labels:
        cache, path, stream, one_by_one = DISAGG_RUNS[label]
        if path == "tcp":
            os.environ["DYN_KV_TRANSFER_FORCE_TCP"] = "1"
        t0 = time.perf_counter()
        try:
            r = disagg_run(torch, model, config, f"disagg-{label}", stream=stream,
                           one_by_one=one_by_one, sanitize=label == DTSAN_RUN)
            r["seconds"] = time.perf_counter() - t0
            if label == DTSAN_RUN:
                # the same run on a fresh pair without the sanitizer: its cost
                gc.collect()
                torch.cuda.empty_cache()
                plain = disagg_run(torch, model, config, f"disagg-{label}-plain", stream=stream,
                                   one_by_one=one_by_one)
        finally:
            os.environ.pop("DYN_KV_TRANSFER_FORCE_TCP", None)
        if label == DTSAN_RUN:
            dtsan_check(r, plain, f"disagg ({label})", card)
        gc.collect()
        torch.cuda.empty_cache()
        base = alone if one_by_one else local
        lt = sorted(base["ttfts"])
        r.update(label=f"disagg ({label})", cache=cache, path=path, streamed=stream,
                 one_by_one=one_by_one,
                 local=dict(one_by_one=one_by_one, ttft_median_s=lt[len(lt) // 2],
                            ttft_max_s=lt[-1], decode_tok_s=base["decode_tok_s"]))
        name = f"disagg ({label}, {cache}, {path}{', streamed' if stream else ''})"
        st = r["stats"]
        if path == "colocated":
            check(st["local_write_calls"] > 0 and st["tcp_write_calls"] == 0,
                  f"{name}: blocks did not move only on the card: {st}")
        elif not stream:
            check(st["tcp_write_calls"] > 0 and st["local_write_calls"] == 0,
                  f"{name}: blocks did not move only over TCP: {st}")
        if stream:
            check(r["stream"]["layers_sent"] > 0 and r["stream"]["fallbacks"] == 0
                  and st["local_write_calls"] == 0 and st["tcp_write_calls"] == 0,
                  f"{name}: no streamed layers or a fallback: {r['stream']}, {st}")
        want = ["int8", "float32"] if quant else ["bfloat16"]
        check(r["parts"] and all(p == want for p in r["parts"]),
              f"{name}: handed-over parts {r['parts'][:3]}, expected {want}")
        check(r["decode_prefill_dispatches"] == 0 and r["prefill_decode_steps"] == 0,
              f"{name}: the decode engine made {r['decode_prefill_dispatches']} prefill dispatches "
              f"and the prefill engine {r['prefill_decode_steps']} decode turns")
        check(all(r["launches"][k] > 0 for k in need) and
              not any(v for k, v in r["launches"].items() if k not in need),
              f"{name}: launches {r['launches']}, need {need} > 0 and no other")
        check(r["handoffs_checked"] > 0 and r["blocks_differ"] == 0,
              f"{name}: {r['blocks_differ']} of {r['handoffs_checked']} handoffs' blocks differ "
              "from the prefill engine's held blocks")
        check(r["held_after"] == 0, f"{name}: {r['held_after']} requests' blocks still held")
        if one_by_one:
            same = [a == b for a, b in zip(r["streams"], alone["streams"])]
            check(all(same), f"{name}: served one at a time, streams {same} equal the local "
                  "engine's one at a time")
        else:
            r["parted"] = spec_near_ties(torch, model, local, r, card, bs=config["block_size"],
                                         cache_dtype=config.get("cache_dtype"),
                                         prompts=model_prompts(model),
                                         sampling=[{"temperature": 0.0}] * len(PROMPT_LENS))
        runs[label] = r
        log(f"{name}: {r['seconds']:.1f} s, TTFT median/max "
            f"{sorted(r['ttfts'])[len(r['ttfts']) // 2]:.3f}/{max(r['ttfts']):.3f} s"
            + (f", decode {r['decode_tok_s']:.1f} tok/s" if "decode_tok_s" in r else "")
            + f" (local default path{', one at a time' if one_by_one else ''}: TTFT median/max "
            f"{r['local']['ttft_median_s']:.3f}/{r['local']['ttft_max_s']:.3f} s, decode "
            f"{r['local']['decode_tok_s']:.1f} tok/s), "
            f"{r['blocks_checked']} blocks in "
            f"{r['handoffs_checked']} handoffs equal the prefill engine's, handoff push-to-notify "
            f"ms median/max {r['handoff_ms'][len(r['handoff_ms']) // 2]:.1f}/"
            f"{r['handoff_ms'][-1]:.1f}, transfer {r['stats']}, costs {r['costs']}, "
            f"stream {r['stream']}, launches {r['launches']} ({card})")
    return runs


# ``--disagg-soak``: the concurrent streamed bf16 handoff over TCP (run c of
# DISAGG_RUNS), repeated; a run that outlasts DISAGG_SOAK_RUN_S dumps every
# thread's stack and exits
DISAGG_SOAK_RUN_S = 180


def disagg_soak(torch, card: str, n: int) -> list[float]:
    """``chip_smoke.py --disagg-soak N``: the concurrent streamed bf16
    handoff over TCP, N times on Llama-3-8B bf16 at full depth (random
    weights), each on a fresh engine pair; checks each run streamed layers
    without a fallback and held no block after.  Returns each run's
    seconds."""
    import faulthandler
    import os

    from dynamo_tpu_torch.models.convert import init_params
    from dynamo_tpu_torch.models.llama import LlamaModel

    cfg = llama3_8b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = LlamaModel.from_state(cfg, init_params(cfg, gen, device="cuda"))
    secs = []
    os.environ["DYN_KV_TRANSFER_FORCE_TCP"] = "1"
    try:
        for i in range(n):
            faulthandler.dump_traceback_later(DISAGG_SOAK_RUN_S, exit=True)
            t0 = time.perf_counter()
            r = disagg_run(torch, model, DEFAULT_PATH, f"disagg-soak-{i}", stream=True,
                           one_by_one=False)
            faulthandler.cancel_dump_traceback_later()
            secs.append(time.perf_counter() - t0)
            check(r["stream"]["layers_sent"] > 0 and r["stream"]["fallbacks"] == 0
                  and r["held_after"] == 0,
                  f"disagg soak {i}: stream {r['stream']}, {r['held_after']} held after")
            log(f"disagg soak {i}: {secs[-1]:.1f} s, stream {r['stream']} ({card})")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("DYN_KV_TRANSFER_FORCE_TCP", None)
    return secs


def disagg_line(torch, runs: dict, card: str) -> dict:
    """The ``{"disagg": ...}`` line: each run's readings beside the local
    default path's of the same call and each path's copy yardstick, timed
    on the mean bytes one handoff moved."""
    rows = []
    per_handoff = []
    for r in runs.values():
        if r["handoffs_checked"]:
            per_handoff.append(r["blocks_checked"] * r["kv_bytes_per_block"]
                               / r["handoffs_checked"])
    yard = copy_yardsticks(torch, int(sum(per_handoff) / len(per_handoff)))
    for label, r in runs.items():
        ttfts = sorted(r["ttfts"])
        moved = r["blocks_checked"] * r["kv_bytes_per_block"]
        rows.append(dict(
            run=label, cache=r["cache"], path=r["path"], streamed=r["streamed"],
            one_by_one=r["one_by_one"],
            ttft_median_s=ttfts[len(ttfts) // 2], ttft_max_s=ttfts[-1],
            decode_tok_s=r.get("decode_tok_s"), local=r.get("local"),
            blocks=r["blocks_checked"], bytes=moved, handoffs=r["handoffs_checked"],
            handoff_ms_median=r["handoff_ms"][len(r["handoff_ms"]) // 2],
            handoff_ms_max=r["handoff_ms"][-1],
            mb_s={path: e["bytes"] / e["seconds"] / 1e6 for path, e in r["costs"].items()},
            mb_s_ewma={path: e["ewma_mbps"] for path, e in r["costs"].items()},
            stream=r["stream"] if r["streamed"] else None, parted=r.get("parted"),
            launches=r["launches"], seconds=r["seconds"]))
    return dict(runs=rows, yardstick=yard, card=card)


# ------------------------------------------------------------- KV tiers
# The multi-tier KV cache on Llama-3-8B: a device pool too small for the
# traffic (192 blocks of 16 tokens, 384 MiB), a host pool of 1,024 blocks
# (2 GiB, pinned) and a shared prefix P of 1,024 tokens (64 blocks): long
# shared system prompts and multi-turn chats whose prefixes outlive the
# device pool.
TIER_BLOCKS = 192
TIER_HOST_BLOCKS = 1024
TIER_PREFIX = 1024
TIER_SUFFIX = 256
TIER_CHURN = 1500      # three distinct prompts that push P off the device
TIER_CHURN_TOKENS = 2  # the churn only has to allocate
TIER_REPEATS = 3
TIER_PATH = dict(DEFAULT_PATH, num_blocks=TIER_BLOCKS, num_host_blocks=TIER_HOST_BLOCKS)
# the int8 run in its 32-token blocks: the same tokens in half the blocks
INT8_TIER_PATH = dict(INT8_DEFAULT_PATH, num_blocks=TIER_BLOCKS // 2,
                      num_host_blocks=TIER_HOST_BLOCKS // 2)
PERSIST_DIR = ROOT / "_kvpersist"
# the router run: two engines, prefixes A and B of 1,024 tokens, three
# requests over each in turn, each with its own 64-token suffix
ROUTER_PREFIX = 1024
ROUTER_SUFFIX = 64
ROUTER_TOKENS = 8
ROUTER_NS = "tier-router"
HOST_COPY_REPEATS = 7  # readings of each host copy timed (the median is kept)
# the sharded router run: the router run's requests, decided by the
# singleton and by a scatter-gather scheduler over three shard replicas (a
# fourth joins, one dies) of an index cut into SHARDS hash-prefix shards
SHARDS = 8
SHARD_REPLICAS = ("router-a", "router-b", "router-c")
SHARD_JOINER = "router-d"
SHARD_DEADLINE_S = 0.25  # a shard that has not answered by then is left out of that gather
SHARD_NS = "tier-shards"
SHARD_DECISIONS = 50     # decisions timed, each way
# the planner and metrics burst: six concurrent requests over the two engines
PLANNER_BURST = 6
PLANNER_PROMPT = 512
PLANNER_TOKENS = 24
PLANNER_TICK_S = 0.25


def tier_prompts(seed: int) -> dict:
    """A prefix P (1,024 tokens), P + each of three suffixes, and three
    churn prompts, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def ids(n):
        return rng.integers(0, LLAMA3_VOCAB, n).tolist()

    p = ids(TIER_PREFIX)
    return dict(s1=p + ids(TIER_SUFFIX), s2=p + ids(TIER_SUFFIX), s3=p + ids(TIER_SUFFIX),
                churn=[ids(TIER_CHURN) for _ in range(3)])


def _on_engine(engine, fn):
    """``fn()`` on the engine thread, at a step boundary."""
    return asyncio.run(engine.run_on_engine(fn))


def _one(engine, toks, tag: str, max_tokens: int = MAX_TOKENS) -> dict:
    """One request alone, greedy: its TTFT, stream, cached tokens and the
    engine's host gap per turn over it."""
    tl = engine.core.timeline
    host0, turns0 = tl.host_gap_s_total, tl.busy_steps_total
    ((ttft, _, outs),) = asyncio.run(_serve(engine, [toks], max_tokens=max_tokens, tag=tag))
    asyncio.run(engine.run_on_engine(lambda: None))  # the last step has ended
    turns = tl.busy_steps_total - turns0
    return dict(ttft=ttft, stream=[t for o in outs for t in o.token_ids],
                cached=outs[-1].cached_tokens,
                host_gap_ms=1e3 * (tl.host_gap_s_total - host0) / turns if turns else 0.0)


def _prefix_blocks(core, toks) -> list:
    """The device blocks registered for P's sequence hashes (None where one
    is not on the device)."""
    from dynamo_tpu_torch.tokens import sequence_hashes

    bs = core.config.block_size
    return [core.block_manager.lookup(h) for h in sequence_hashes(toks, bs)[:TIER_PREFIX // bs]]


def _p_on_device(engine, toks) -> int:
    """How many of ``toks``'s tokens would hit the device cache."""
    from dynamo_tpu_torch.tokens import sequence_hashes

    core = engine.core
    return _on_engine(engine, lambda: core.prefix_hit_tokens(
        sequence_hashes(toks, core.config.block_size), len(toks)))


def _same_bits(torch, a, b) -> bool:
    return all(torch.equal(_bits(torch, x), _bits(torch, y)) for x, y in zip(_parts(a), _parts(b)))


def _churn(engine, ps: dict, tag: str) -> None:
    """The three churn prompts in turn, then every offload landed."""
    for i, toks in enumerate(ps["churn"]):
        _one(engine, toks, f"{tag}-churn{i}", max_tokens=TIER_CHURN_TOKENS)
    _on_engine(engine, engine.core.flush_host_offload)


def _tier_engine(model, config: dict):
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore

    return AsyncLLMEngine(EngineCore(model, EngineConfig(**config), device="cuda")).start()


def _close(torch, engine) -> None:
    engine.shutdown()
    gc.collect()
    torch.cuda.empty_cache()


def tier_run(torch, model, config: dict, ps: dict, label: str, reference: bool = True) -> dict:
    """h1 (cold), h2 (device hit, unless ``ps`` has no s2), h3 (P's blocks
    kept as the reference, then the churn that pushes P off the device) and
    h4 (host restore) on one engine.  Checks: h2 hit P on the device; after
    the churn P is off the device and the host stored at least its blocks;
    h4 restored them from the host, with P's bits; with ``reference``, h4's
    stream is that of P + s3 on a second engine with no host tier and P
    warm on its device (whose prefill of P gave the same bits)."""
    n_p = TIER_PREFIX // config["block_size"]
    engine = _tier_engine(model, config)
    core = engine.core
    try:
        runs = {"h1": _one(engine, ps["s1"], f"{label}-h1")}
        if "s2" in ps:
            runs["h2"] = _one(engine, ps["s2"], f"{label}-h2")
            check(runs["h2"]["cached"] >= TIER_PREFIX,
                  f"{label} h2: cached {runs['h2']['cached']} < {TIER_PREFIX}")
        ids = _prefix_blocks(core, ps["s1"])
        check(None not in ids, f"{label}: P is not all on the device after h1")
        ref = _on_engine(engine, lambda: core.gather_blocks_np(ids))
        t0 = time.perf_counter()
        _churn(engine, ps, label)
        churn_s = time.perf_counter() - t0
        m = core.metrics()
        check(_p_on_device(engine, ps["s3"]) == 0, f"{label} h3: P is still on the device")
        check(m["host_blocks_stored"] >= n_p,
              f"{label} h3: the host stored {m['host_blocks_stored']} < {n_p} blocks")
        restored0 = m["host_blocks_restored"]
        runs["h4"] = _one(engine, ps["s3"], f"{label}-h4")
        m = core.metrics()
        check(runs["h4"]["cached"] >= TIER_PREFIX,
              f"{label} h4: cached {runs['h4']['cached']} < {TIER_PREFIX}")
        check(m["host_blocks_restored"] - restored0 >= n_p,
              f"{label} h4: restored {m['host_blocks_restored'] - restored0} < {n_p} blocks")
        ids4 = _prefix_blocks(core, ps["s3"])
        check(None not in ids4, f"{label} h4: P is not registered after the restore")
        got = _on_engine(engine, lambda: core.gather_blocks_np(ids4))
        check(_same_bits(torch, ref, got), f"{label} h4: the restored blocks are not P's bits")
        stats, metrics = dict(core.tier_stats), m
    finally:
        del core
        _close(torch, engine)
    if reference:
        plain = _tier_engine(model, dict(config, num_host_blocks=0))
        try:
            _one(plain, ps["s1"], f"{label}-ref-warm")
            ids = _prefix_blocks(plain.core, ps["s1"])
            warm = _on_engine(plain, lambda: plain.core.gather_blocks_np(ids))
            check(_same_bits(torch, ref, warm),
                  f"{label}: the second engine's prefill of P gave other bits")
            stream = _one(plain, ps["s3"], f"{label}-ref-h4")["stream"]
        finally:
            _close(torch, plain)
        check(runs["h4"]["stream"] == stream,
              f"{label} h4: the host-restored stream differs from the device-hit stream")
    log(f"tier {label}: TTFT " + ", ".join(f"{k} {1e3 * v['ttft']:.1f} ms" for k, v in runs.items())
        + f"; cached {[v['cached'] for v in runs.values()]}, churn {churn_s:.2f} s, "
        f"host stored {metrics['host_blocks_stored']} restored {metrics['host_blocks_restored']}, "
        f"{stats}")
    return dict(runs=runs, stats=stats, metrics=metrics)


def persist_run(torch, model, ps: dict, h4_stream: list, label: str = "p") -> dict:
    """(p): an engine with a persist directory serves P + s1 and the churn,
    flushes and is closed; a new engine over the directory serves P + s3.
    Checks: the disk held P, the new engine restored at least P's blocks
    from it (persist hits), and its stream is h4's."""
    import shutil

    from dynamo_tpu_torch.engine.counters import persist_counters

    n_p = TIER_PREFIX // BS
    shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    config = dict(TIER_PATH, kv_persist_dir=str(PERSIST_DIR))
    try:
        engine = _tier_engine(model, config)
        try:
            _one(engine, ps["s1"], f"{label}-cold")
            _churn(engine, ps, label)
            spill = dict(engine.core.tier_stats)
            files = engine.core.persist_store.stats()
        finally:
            _close(torch, engine)
        persist_counters.reset()
        engine = _tier_engine(model, config)
        try:
            check(engine.core.persist_store.stats()["persist_blocks"] >= n_p,
                  f"{label}: the restarted engine found {files} on disk")
            warm = _one(engine, ps["s3"], f"{label}-warm")
            load = dict(engine.core.tier_stats)
        finally:
            _close(torch, engine)
    finally:
        shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    check(persist_counters.hits_total >= n_p,
          f"{label}: {persist_counters.hits_total} persist hits < {n_p}")
    check(warm["cached"] >= TIER_PREFIX, f"{label}: cached {warm['cached']} < {TIER_PREFIX}")
    check(warm["stream"] == h4_stream, f"{label}: the persist-restored stream differs from h4's")
    log(f"tier {label}: persist restore TTFT {1e3 * warm['ttft']:.1f} ms, cached "
        f"{warm['cached']}, {persist_counters.hits_total} persist hits, files {files}")
    return dict(warm=warm, files=files, hits=persist_counters.hits_total,
                spill_bytes=spill["spill_bytes"], spill_s=spill["spill_s"],
                load_bytes=load["load_bytes"], load_s=load["load_s"])


def tier_yardsticks(torch, nbytes: int) -> dict:
    """A pinned device-to-host and host-to-device copy of ``nbytes``, timed on
    the card: what an offload and a restore of that many bytes could take."""
    n = nbytes // 2
    dev = torch.zeros(n, dtype=torch.bfloat16, device="cuda")
    host = torch.zeros(n, dtype=torch.bfloat16, pin_memory=True)
    d2h = median_ms(lambda: cuda_time_ms(lambda i: host.copy_(dev, non_blocking=True), 5))
    h2d = median_ms(lambda: cuda_time_ms(lambda i: dev.copy_(host, non_blocking=True), 5))
    del dev, host
    torch.cuda.empty_cache()
    return dict(bytes=nbytes, d2h_pinned_ms=d2h, h2d_pinned_ms=h2d,
                d2h_pinned_gb_s=nbytes / d2h / 1e6, h2d_pinned_gb_s=nbytes / h2d / 1e6)


def host_copies(torch, model, card: str) -> dict:
    """The native block copies on the tier phase's own block shape: 64 blocks
    of ``[L, 2, Bs, Hk*D]`` bf16 (a 1,024-token prefix) scattered into and
    gathered out of a pinned pool of TIER_HOST_BLOCKS rows.  Checks: the
    scatter equals ``index_copy_`` and the gather ``index_select`` bit for
    bit.  Times (host clock, medians of HOST_COPY_REPEATS) of each beside
    the torch copy, and their GB/s over the 64 blocks' bytes."""
    from dynamo_tpu_torch import native

    cfg = model.config
    shape = (cfg.num_layers, 2, BS, cfg.num_kv_heads * cfg.head_dim)
    n = TIER_PREFIX // BS
    gen = torch.Generator().manual_seed(0)
    pool = torch.zeros((TIER_HOST_BLOCKS,) + shape, dtype=torch.bfloat16, pin_memory=True)
    twin = torch.zeros_like(pool, pin_memory=True)
    src = torch.randn((n,) + shape, generator=gen).to(torch.bfloat16).pin_memory()
    ids = torch.randperm(TIER_HOST_BLOCKS, generator=gen)[:n]
    native.blocks_scatter(pool, ids, src)
    twin.index_copy_(0, ids, src)
    check(torch.equal(pool.view(torch.int16), twin.view(torch.int16)),
          "native: blocks_scatter differs from index_copy_")
    out = torch.empty_like(src, pin_memory=True)
    ref = torch.empty_like(src, pin_memory=True)
    native.blocks_gather(pool, ids, out=out)
    torch.index_select(pool, 0, ids, out=ref)
    check(torch.equal(out.view(torch.int16), ref.view(torch.int16))
          and torch.equal(ref.view(torch.int16), src.view(torch.int16)),
          "native: blocks_gather differs from index_select")

    def host_ms(fn):
        def once():
            t0 = time.perf_counter()
            fn()
            return 1e3 * (time.perf_counter() - t0)
        fn()
        return median_ms(once, HOST_COPY_REPEATS)

    nbytes = src.numel() * src.element_size()
    ms = dict(scatter=host_ms(lambda: native.blocks_scatter(pool, ids, src)),
              index_copy=host_ms(lambda: twin.index_copy_(0, ids, src)),
              gather=host_ms(lambda: native.blocks_gather(pool, ids, out=out)),
              index_select=host_ms(lambda: torch.index_select(pool, 0, ids, out=ref)))
    del pool, twin
    log(f"native copies: 64 blocks of {list(shape)} bf16 ({nbytes} bytes), " + ", ".join(
        f"{k} {v:.3f} ms ({nbytes / v / 1e6:.2f} GB/s)" for k, v in ms.items()) + f" ({card})")
    return dict(blocks=n, block_shape=list(shape), dtype="bfloat16", bytes=nbytes,
                bit_equal=True, ms=ms, gb_s={k: nbytes / v / 1e6 for k, v in ms.items()},
                repeats=HOST_COPY_REPEATS, clock="host perf_counter")


class _Runtime:
    """The duck-typed runtime the worker wiring takes: an instance id, a
    coordinator client and the stops to await at shutdown."""

    def __init__(self, coordinator, instance_id: int):
        self.coordinator = coordinator
        self.instance_id = instance_id
        self.stops = []

    def on_shutdown(self, fn) -> None:
        self.stops.append(fn)

    async def shutdown(self) -> None:
        for fn in reversed(self.stops):
            await fn()


def router_requests() -> list:
    """(prefix name, token ids): ABABAB over two 1,024-token prefixes, each
    request with its own 64-token suffix."""
    import numpy as np

    rng = np.random.default_rng(7)
    prefixes = {"A": rng.integers(0, LLAMA3_VOCAB, ROUTER_PREFIX).tolist(),
                "B": rng.integers(0, LLAMA3_VOCAB, ROUTER_PREFIX).tolist()}
    return [(name, prefixes[name] + rng.integers(0, LLAMA3_VOCAB, ROUTER_SUFFIX).tolist())
            for name in "ABABAB"]


def router_run(torch, model, card: str) -> dict:
    """(r): two engines on the one model, each behind the worker wiring
    (event and metrics publishers), a coordinator, a KvRouter and its
    subscriber; three requests over prefix A and three over prefix B in
    turn, each sent where the router says.  Checks: each prefix's later
    requests go to the worker that served its first, with an overlap of at
    least P's blocks, and hit them there (cached tokens); after the flush,
    the index holds each engine's registered blocks.  The router's index is
    the native one: a Python ``KvIndexer(use_native=False)`` fed the same
    events gives the same scores at every decision (so the same decisions)
    and holds the same blocks; then one native ``find_matches`` over each
    request's hashes is timed against the Python index's."""
    import random

    from dynamo_tpu_torch.cli import attach_worker_publishers
    from dynamo_tpu_torch.llm.kv_router import DefaultWorkerSelector, KvIndexer, KvRouter
    from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvRouterSubscriber
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer
    from dynamo_tpu_torch.tokens import sequence_hashes

    reqs = router_requests()
    engines = {w: _tier_engine(model, DEFAULT_PATH) for w in (1, 2)}

    async def go():
        srv = await CoordinatorServer(port=0).start()
        clients = [await CoordinatorClient(srv.url).connect() for _ in range(3)]
        runtimes = {w: _Runtime(clients[i], w) for i, w in enumerate(engines)}
        subscriber = None
        try:
            for w, engine in engines.items():
                attach_worker_publishers(runtimes[w], engine, ROUTER_NS)
            router = KvRouter(block_size=BS, selector=DefaultWorkerSelector(random.Random(0)))
            check(router.indexer.is_native, "router: the default index is not the native one")
            shadow = KvIndexer(use_native=False)
            native_apply = router.indexer.apply_event

            def apply_both(worker_id, event, event_id=None):  # the same events, both indexes
                shadow.apply_event(worker_id, event, event_id=event_id)
                native_apply(worker_id, event, event_id=event_id)

            router.indexer.apply_event = apply_both
            subscriber = await KvRouterSubscriber(router, clients[2], namespace=ROUTER_NS).start()
            for _ in range(500):
                if len(router.scheduler.workers()) == 2:
                    break
                await asyncio.sleep(0.01)
            check(len(router.scheduler.workers()) == 2, "router: the workers' metrics never came")
            rows = []
            for i, (name, toks) in enumerate(reqs):
                hashes = sequence_hashes(toks, BS)
                scores = router.indexer.find_matches(hashes).scores
                check(scores == shadow.find_matches(hashes).scores,
                      f"router: request {i}: native scores {scores} vs Python "
                      f"{shadow.find_matches(hashes).scores}")
                d = router.schedule(toks)
                check(d.overlap_blocks == scores.get(d.worker_id, 0),
                      f"router: request {i}: overlap {d.overlap_blocks} vs scores {scores}")
                ((ttft, _, outs),) = await _serve(engines[d.worker_id], [toks],
                                                  max_tokens=ROUTER_TOKENS, tag=f"router-{i}")
                rows.append(dict(prefix=name, worker=d.worker_id, overlap_blocks=d.overlap_blocks,
                                 cached=outs[-1].cached_tokens, ttft_ms=1e3 * ttft))
                await asyncio.sleep(0.2)  # the publishers flush every 50 ms
            index = {w: router.indexer.worker_blocks(w) for w in engines}
            check(index == {w: shadow.worker_blocks(w) for w in engines},
                  f"router: the native index holds {index}, the Python index "
                  f"{ {w: shadow.worker_blocks(w) for w in engines} }")
            registered = {w: len(e.core.block_manager._table) for w, e in engines.items()}
            # one routing decision: hash the prompt, match, score, pick
            t0 = time.perf_counter()
            for _ in range(50):
                router.schedule(reqs[0][1])
            schedule_ms = 1e3 * (time.perf_counter() - t0) / 50
            # the match alone, native and Python, over each request's hashes
            every = [sequence_hashes(toks, BS) for _, toks in reqs]
            match_ms = {}
            for label, ix in (("native", router.indexer), ("python", shadow)):
                def once():
                    t0 = time.perf_counter()
                    for _ in range(50):
                        for hashes in every:
                            ix.find_matches(hashes)
                    return 1e3 * (time.perf_counter() - t0) / (50 * len(every))
                match_ms[label] = median_ms(once, 5)
            return rows, index, registered, schedule_ms, match_ms
        finally:
            if subscriber is not None:
                await subscriber.stop()
            for rt in runtimes.values():
                await rt.shutdown()
            for c in clients:
                await c.close()
            await srv.stop()

    try:
        rows, index, registered, schedule_ms, match_ms = asyncio.run(go())
    finally:
        for e in engines.values():
            _close(torch, e)
    first = {}
    for i, r in enumerate(rows):
        if r["prefix"] not in first:
            first[r["prefix"]] = r["worker"]
            continue
        check(r["worker"] == first[r["prefix"]],
              f"router: request {i} over {r['prefix']} went to worker {r['worker']}, "
              f"not to {first[r['prefix']]}: {rows}")
        check(r["overlap_blocks"] >= ROUTER_PREFIX // BS and r["cached"] >= ROUTER_PREFIX,
              f"router: request {i}: overlap {r['overlap_blocks']}, cached {r['cached']}")
    check(index == registered, f"router: the index holds {index}, the engines {registered}")
    log(f"router: {rows}; index {index}, one decision {schedule_ms:.3f} ms, find_matches "
        f"native {match_ms['native']:.4f} ms, Python {match_ms['python']:.4f} ms ({card})")
    return dict(decisions=rows, index_blocks=index, registered_blocks=registered,
                decision_ms=schedule_ms, native_index=True, python_index_agrees=True,
                find_matches_ms=match_ms, card=card)


@contextlib.contextmanager
def recorded_prefill():
    """The fresh-query count S of every paged prefill call (B2 and B4b),
    recorded by wrapping the routing's references (the wrappers and their
    launch counts are untouched)."""
    from dynamo_tpu_torch.ops import paged_attention as routing

    names = ("paged_prefill_attention", "paged_prefill_attention_q8")
    real = {n: getattr(routing, n) for n in names}
    calls = []

    def wrap(name):
        def call(q, *args, **kw):
            calls.append(q.shape[1])
            return real[name](q, *args, **kw)
        return call

    for n in names:
        setattr(routing, n, wrap(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(routing, n, real[n])


def _median(xs):
    return sorted(xs)[len(xs) // 2]


async def _until(cond, what: str, limit_s: float = 10.0) -> None:
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < limit_s, f"shards: {what} within {limit_s} s")
        await asyncio.sleep(0.01)


def shard_run(torch, model, card: str) -> tuple[dict, dict]:
    """(s): the router run's two engines and worker wiring, now registered as
    ``run in=dyn://`` workers register (a lease each, the decode endpoint's
    discovery key), with both a singleton KvRouter and a scatter-gather
    scheduler over three ShardReplicas (SHARDS index shards, one
    PubSubShardClient per shard) fed by the same KV events and metrics.

    * Decisions: the router run's ABABAB requests, each gathered, decided by
      the sharded scheduler and served there.  Every gathered overlap equals
      the singleton index's; each prefix's later requests go to its first
      worker and hit there: cached tokens cover the prefix and B2 runs over
      the fresh suffix only.  Then one decision timed each way.
    * A replica joins: every replica and the scheduler reach the new
      membership's generation, the handoff frames carry exactly the moved
      shards, and the joiner's ranges equal their old owners' (warm): the
      next request over prefix A gathers the singleton's overlap.
    * A replica dies (its connection closes, which revokes its lease at once;
      no handoff ships): the next decision completes within the gather
      deadline, the partial gather is counted, and after the rebind the
      scores never rise and the request is served.
    * The planner and metrics: during a burst of six concurrent requests a
      PlannerLoop (LogActuator) over the decode pool ticks, and a
      MetricsService listens; the loop's snapshots read the engines' last
      published metrics, its plans are the policy's on them, and /metrics
      lists both workers' gauges as published.

    Returns the ``shards`` and ``planner`` lines."""
    import random

    import aiohttp

    from dynamo_tpu_torch.cli import attach_worker_publishers
    from dynamo_tpu_torch.components.metrics import MetricsService
    from dynamo_tpu_torch.engine.counters import kv_shard_counters
    from dynamo_tpu_torch.llm.kv_router import DefaultWorkerSelector, KvRouter
    from dynamo_tpu_torch.llm.kv_router.metrics_aggregator import KvRouterSubscriber
    from dynamo_tpu_torch.llm.kv_router.publisher import events_subject, metrics_subject
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvScheduler, WorkerMetrics
    from dynamo_tpu_torch.llm.kv_router.shards import (PubSubShardClient, ScatterGatherScheduler,
                                                       ShardMap, ShardReplica,
                                                       membership_generation, shard_of)
    from dynamo_tpu_torch.llm.kv_router.shards.lifecycle import DEFAULT_ROUTERS_PREFIX
    from dynamo_tpu_torch.llm.kv_router.shards.wire import (decode_shard_handoff,
                                                            shard_handoff_subject)
    from dynamo_tpu_torch.obs.metric_names import RouterMetric as RM
    from dynamo_tpu_torch.planner import LogActuator, PlannerLoop, PlannerPolicy
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient, CoordinatorServer
    from dynamo_tpu_torch.tokens import sequence_hashes

    reqs = router_requests()
    engines = [_tier_engine(model, DEFAULT_PATH) for _ in range(2)]
    kv_shard_counters.reset()

    async def go():
        srv = await CoordinatorServer(port=0).start()
        conns, stops = [], []

        async def conn():
            c = await CoordinatorClient(srv.url).connect()
            conns.append(c)
            return c

        replicas, dead = {}, set()
        try:
            # the workers: a lease each, the publishers, the discovery key
            wids, by_wid = [], {}
            for engine in engines:
                c = await conn()
                wid = await c.lease_create(ttl=10.0)
                rt = _Runtime(c, wid)
                stops.append(rt.shutdown)
                attach_worker_publishers(rt, engine, SHARD_NS)
                created = await c.kv_create(
                    f"{SHARD_NS}/components/decode/endpoints/generate/{wid:x}",
                    {"instance_id": wid, "subject": f"{SHARD_NS}.decode.generate-{wid:x}"},
                    lease_id=wid)
                check(created, "shards: a worker's discovery key was taken")
                wids.append(wid)
                by_wid[wid] = engine
            # the singleton router
            router = KvRouter(block_size=BS, selector=DefaultWorkerSelector(random.Random(0)))
            sub = await KvRouterSubscriber(router, await conn(), namespace=SHARD_NS).start()
            stops.append(sub.stop)
            # the replicas, on a connection each
            for rid in SHARD_REPLICAS:
                r = ShardReplica(await conn(), rid, SHARDS, namespace=SHARD_NS, lease_ttl_s=10.0)
                await r.subscribe_events(events_subject(SHARD_NS))
                replicas[rid] = await r.start()
            # the sharded scheduler: fed the workers' metrics as the
            # singleton's is, its generation kept from the membership
            sc = await conn()
            sched = KvScheduler(DefaultWorkerSelector(random.Random(0)), block_size=BS)

            def on_metrics(subject, payload):
                sched.update_worker(WorkerMetrics(**json.loads(payload)))

            await sc.subscribe(metrics_subject(SHARD_NS), on_metrics)
            clients = [await PubSubShardClient(sc, SHARD_NS, s, "scheduler").start()
                       for s in range(SHARDS)]
            stops += [c.stop for c in clients]
            gate = ScatterGatherScheduler(sched, clients, SHARDS, deadline_s=SHARD_DEADLINE_S)
            members = set()

            def on_member(event, key, value):
                rid = key.rsplit("/", 1)[-1]
                (members.add if event == "put" else members.discard)(rid)
                gate.set_generation(membership_generation(sorted(members), SHARDS))

            _, existing = await sc.watch(DEFAULT_ROUTERS_PREFIX, on_member)
            for key in existing:
                on_member("put", key, None)
            # the handoff frames, as a bystander sees them
            frames = []
            await sc.subscribe(shard_handoff_subject(SHARD_NS),
                               lambda subj, pl: frames.append(decode_shard_handoff(pl)))

            def settled(live):
                gen = membership_generation(sorted(live), SHARDS)
                return gate.generation == gen and all(
                    replicas[r].map.generation == gen and not replicas[r]._bg_tasks
                    and set(replicas[r]._subs) == set(replicas[r].map.shards_of(r))
                    for r in live)

            live = list(SHARD_REPLICAS)
            await _until(lambda: settled(live), "three replicas at one generation")
            await _until(lambda: set(wids) <= set(router.scheduler.workers())
                         and set(wids) <= set(sched.workers()), "the workers' metrics")

            async def gather(toks):
                hashes = sequence_hashes(toks, BS)
                ov, partial = await gate.overlaps(hashes)
                return hashes, dict(ov.scores), partial

            # decisions
            rows = []
            for i, (name, toks) in enumerate(reqs):
                hashes, scores, partial = await gather(toks)
                single = dict(router.indexer.find_matches(hashes).scores)
                check(scores == single and not partial,
                      f"shards: request {i} gathered {scores} (partial {partial}), "
                      f"the singleton {single}")
                wid = await gate.schedule(hashes, len(toks))
                d = router.schedule(toks)
                with recorded_prefill() as fresh:
                    ((ttft, _, outs),) = await _serve(by_wid[wid], [toks],
                                                      max_tokens=ROUTER_TOKENS, tag=f"shard-{i}")
                rows.append(dict(prefix=name, worker=wids.index(wid) + 1,
                                 singleton_worker=wids.index(d.worker_id) + 1,
                                 overlap={wids.index(w) + 1: n for w, n in sorted(scores.items())},
                                 cached=outs[-1].cached_tokens, prefill_s=sorted(set(fresh)),
                                 ttft_ms=1e3 * ttft))
                await asyncio.sleep(0.2)  # the publishers flush every 50 ms
            # one decision timed each way: the singleton hashes, matches and
            # scores; the sharded one hashes, scatters, gathers and scores
            toks = reqs[0][1]
            single_ms, shard_ms = [], []
            for _ in range(SHARD_DECISIONS):
                t0 = time.perf_counter()
                router.schedule(toks)
                single_ms.append(1e3 * (time.perf_counter() - t0))
            for _ in range(SHARD_DECISIONS):
                t0 = time.perf_counter()
                await gate.schedule(sequence_hashes(toks, BS), len(toks))
                shard_ms.append(1e3 * (time.perf_counter() - t0))
            check(kv_shard_counters.gather_partial_total == 0,
                  f"shards: {kv_shard_counters.gather_partial_total} partial gathers before "
                  "the join")
            # a replica joins
            old_map = ShardMap.from_replicas(live, SHARDS)
            del frames[:]
            joiner = ShardReplica(await conn(), SHARD_JOINER, SHARDS, namespace=SHARD_NS,
                                  lease_ttl_s=10.0)
            await joiner.subscribe_events(events_subject(SHARD_NS))
            replicas[SHARD_JOINER] = await joiner.start()
            live.append(SHARD_JOINER)
            await _until(lambda: settled(live), "four replicas and the scheduler at one generation")
            gen4 = gate.generation
            moved = old_map.moved_shards(replicas[SHARD_JOINER].map)
            await _until(lambda: all(
                joiner.index.export_shard(s) == replicas[old_map.owner(s)].index.export_shard(s)
                for s in moved), "the joiner's handed-off ranges")
            handoffs = sorted((f[0], f[2], len(f[3])) for f in frames)
            check(sorted(f[0] for f in frames) == moved and all(f[1] == gen4 for f in frames)
                  and moved, f"shards: handoff frames {handoffs}, moved {moved}")
            toks_a = next(t for n, t in reqs if n == "A")
            hashes_a, warm, partial = await gather(toks_a)
            single_a = dict(router.indexer.find_matches(hashes_a).scores)
            check(warm == single_a and not partial,
                  f"shards: after the join prefix A gathered {warm}, the singleton {single_a}")
            generations = {r: replicas[r].map.generation for r in live}
            generations["scheduler"] = gate.generation
            # a replica dies: the one owning prefix A's first block
            victim = replicas[SHARD_JOINER].map.owner(shard_of(hashes_a[0], SHARDS))
            victim_conn = replicas[victim].coord
            partial0 = kv_shard_counters.gather_partial_total
            await victim_conn.close()
            for t in list(replicas[victim]._bg_tasks):
                t.cancel()
            dead.add(victim)
            live.remove(victim)
            t0 = time.perf_counter()
            after_wid = await gate.schedule(hashes_a, len(toks_a))
            death_ms = 1e3 * (time.perf_counter() - t0)
            check(death_ms < 1e3 * SHARD_DEADLINE_S + 200,
                  f"shards: the decision after the death took {death_ms:.1f} ms")
            check(kv_shard_counters.gather_partial_total > partial0,
                  "shards: the gather that missed the dead replica was not counted partial")
            await _until(lambda: settled(live), "the survivors' rebind")
            _, rebound, rpartial = await gather(toks_a)
            check(all(n <= warm.get(w, 0) for w, n in rebound.items()),
                  f"shards: after the rebind the overlap rose: {rebound} over {warm}")
            wid = await gate.schedule(hashes_a, len(toks_a))
            ((_, _, outs),) = await _serve(by_wid[wid], [toks_a], max_tokens=ROUTER_TOKENS,
                                           tag="shard-after-death")
            check(sum(len(o.token_ids) for o in outs) == ROUTER_TOKENS,
                  "shards: the request after the death was not served")
            death = dict(replica=victim, decision_ms=death_ms, decided_worker=wids.index(
                after_wid) + 1, partial_gathers=kv_shard_counters.gather_partial_total - partial0,
                overlap_before={wids.index(w) + 1: n for w, n in sorted(warm.items())},
                overlap_after={wids.index(w) + 1: n for w, n in sorted(rebound.items())},
                partial_after_rebind=rpartial, served_worker=wids.index(wid) + 1,
                generation_after=gate.generation)
            shards_line = dict(
                card=card, shards=SHARDS, replicas=list(SHARD_REPLICAS), joiner=SHARD_JOINER,
                deadline_ms=1e3 * SHARD_DEADLINE_S, decisions=rows,
                decision_ms=dict(sharded_median=_median(shard_ms), singleton_median=_median(
                    single_ms), sharded_mean=sum(shard_ms) / len(shard_ms),
                    singleton_mean=sum(single_ms) / len(single_ms), n=SHARD_DECISIONS),
                join=dict(generations=generations, moved_shards=moved, handoffs=handoffs,
                          warm_overlap={wids.index(w) + 1: n for w, n in sorted(warm.items())}),
                death=death, scatters_total=kv_shard_counters.scatters_total,
                gather_partial_total=kv_shard_counters.gather_partial_total,
                owned_index_blocks={r: sum(replicas[r].index.shard(s).num_blocks
                                           for s in replicas[r].map.shards_of(r)) for r in live})
            # the planner and the metrics service, during one burst
            pc = await conn()
            published = {}

            def on_published(subject, payload):
                d = json.loads(payload)
                published[int(d["worker_id"])] = d

            await pc.subscribe(metrics_subject(SHARD_NS), on_published)
            svc = await MetricsService(await conn(), namespace=SHARD_NS, port=0).start()
            stops.append(svc.stop)
            loop = await PlannerLoop(pc, namespace=SHARD_NS, actuators=(LogActuator(),),
                                     interval_s=PLANNER_TICK_S).attach()
            stops.append(loop.stop)
            snaps, real_plan = [], loop.policy.plan

            def recorded_plan(snap):
                snaps.append(snap)
                return real_plan(snap)

            loop.policy.plan = recorded_plan
            await _until(lambda: set(wids) <= set(loop._metrics), "the planner's first metrics")
            rng = __import__("numpy").random.default_rng(11)
            burst = [rng.integers(0, LLAMA3_VOCAB, PLANNER_PROMPT).tolist()
                     for _ in range(PLANNER_BURST)]
            ticks = []

            async def ticker():
                while True:
                    ticks.append(await loop.tick_once())
                    await asyncio.sleep(PLANNER_TICK_S)

            task = asyncio.ensure_future(ticker())
            t0 = time.perf_counter()
            await asyncio.gather(*(
                _serve(engines[i % 2], [toks], max_tokens=PLANNER_TOKENS, tag=f"burst-{i}")
                for i, toks in enumerate(burst)))
            burst_s = time.perf_counter() - t0
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            # idle: one more publish each (1 s cadence), then the last tick
            n_pub = {w: 0 for w in wids}

            def count(subject, payload):
                n_pub[int(json.loads(payload)["worker_id"])] += 1

            await pc.subscribe(metrics_subject(SHARD_NS), count)
            await _until(lambda: all(n >= 2 for n in n_pub.values()), "an idle metrics publish",
                         limit_s=5.0)
            last = await loop.tick_once()
            snap = snaps[-1]
            fields = ("request_active_slots", "request_total_slots", "kv_active_blocks",
                      "kv_total_blocks", "num_requests_waiting")
            read = {s.worker_id: {f: getattr(s, f) for f in fields} for s in snap.decode.samples}
            want = {w: {f: published[w][f] for f in fields} for w in wids}
            check(read == want, f"planner: the snapshot read {read}, the workers published {want}")
            core_now = {w: {f: by_wid[w].core.metrics()[f] for f in fields} for w in wids}
            check(core_now == want, f"planner: the engines' metrics {core_now}, published {want}")
            replay = PlannerPolicy(loop.policy.config)
            replayed = [replay.plan(sn) for sn in snaps]
            check(replayed == ticks + [last], "planner: a plan differs from the policy's on its "
                  "snapshot")
            check(snap.decode.registered == 2 and len(ticks) >= 2,
                  f"planner: registered {snap.decode.registered}, {len(ticks)} ticks in the burst")
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://127.0.0.1:{svc.port}/metrics") as r:
                    text = await r.text()
            for w in wids:
                for name, f in ((RM.KV_BLOCKS_ACTIVE, "kv_active_blocks"),
                                (RM.KV_BLOCKS_TOTAL, "kv_total_blocks"),
                                (RM.REQUEST_ACTIVE_SLOTS, "request_active_slots"),
                                (RM.REQUESTS_WAITING, "num_requests_waiting")):
                    line = f'{name}{{worker="{w}"}} {published[w][f]}'
                    check(line in text, f"planner: /metrics lacks {line}")
            plans = ticks + [last]

            def decision(p):
                return p.prefill_replicas, p.decode_replicas, p.flip, p.decode_usage

            changed = [p for i, p in enumerate(plans)
                       if i == 0 or decision(p) != decision(plans[i - 1])]
            planner_line = dict(
                card=card, burst=dict(requests=PLANNER_BURST, prompt=PLANNER_PROMPT,
                                      tokens=PLANNER_TOKENS, seconds=burst_s),
                ticks=len(ticks) + 1,
                # the plans at the ticks where the decision or its usage changed
                plans=[dict(tick=p.tick, prefill=p.prefill_replicas, decode=p.decode_replicas,
                            flip=p.flip, usage=p.decode_usage) for p in changed],
                snapshot={wids.index(w) + 1: v for w, v in read.items()},
                metrics_lines=sum(
                    1 for line in text.splitlines() if line and not line.startswith("#")))
            return shards_line, planner_line
        finally:
            for fn in reversed(stops):
                await fn()
            for rid, r in replicas.items():
                if rid not in dead:
                    await r.stop()
            for c in conns:
                await c.close()
            await srv.stop()

    try:
        shards_line, planner_line = asyncio.run(go())
    finally:
        for e in engines:
            _close(torch, e)
    first = {}
    for i, r in enumerate(shards_line["decisions"]):
        if r["prefix"] not in first:
            first[r["prefix"]] = r["worker"]
            continue
        fresh = len(reqs[i][1]) - r["cached"]
        check(r["worker"] == first[r["prefix"]] and r["cached"] >= ROUTER_PREFIX
              and r["prefill_s"] == [fresh],
              f"shards: request {i} over {r['prefix']}: worker {r['worker']} (first "
              f"{first[r['prefix']]}), cached {r['cached']}, B2 at S {r['prefill_s']}")
    log(f"shards: {shards_line['decisions']}; one decision {shards_line['decision_ms']} ({card})")
    return shards_line, planner_line


def tier_phase(torch, model, card: str) -> dict:
    """The KV tiers on the bf16 Llama-3-8B: h1-h4 on prefix 0 (with the
    second engine's reference stream), h1, h2 and h4 again on three fresh
    prefixes (h5), the persist restart (p), the router (r), and the pinned
    copy yardsticks of P's bytes; each kernel's launches over all of it.
    The host pool's stores over h1-h5 are native scatters (counted), and
    its restores onto the card stay pinned asynchronous copies (no native
    gather counted); then the native copies are checked and timed on the
    phase's block shape (``host_copies``)."""
    from dynamo_tpu_torch import native

    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    ps = tier_prompts(0)
    native.calls.update(gather=0, scatter=0)
    first = tier_run(torch, model, TIER_PATH, ps, "h")
    repeats = [tier_run(torch, model, TIER_PATH, tier_prompts(1 + i), f"h5.{i}", reference=False)
               for i in range(TIER_REPEATS)]
    copies = dict(native.calls)
    stored = sum(r["metrics"]["host_blocks_stored"] for r in [first] + repeats)
    restored = sum(r["stats"]["restore_blocks"] for r in [first] + repeats)
    check(copies["scatter"] > 0 and stored > 0 and restored > 0 and copies["gather"] == 0,
          f"native: the tier runs stored {stored} and restored {restored} blocks with "
          f"{copies} native copies (scatters > 0 and no gather wanted)")
    persist = persist_run(torch, model, ps, first["runs"]["h4"]["stream"])
    router = router_run(torch, model, card)
    # the sharded run's own launches: counted from 0, then added back
    before = {name: fn.launches for name, fn in wrappers.items()}
    for fn in wrappers.values():
        fn.launches = 0
    shards, planner = shard_run(torch, model, card)
    shards["launches"] = {name: fn.launches for name, fn in wrappers.items()}
    check(shards["launches"]["decode"] > 0 and shards["launches"]["prefill"] > 0,
          f"shards: launches {shards['launches']}")
    for name, fn in wrappers.items():
        fn.launches += before[name]
    launches = {name: fn.launches for name, fn in wrappers.items()}
    check(launches["decode"] > 0 and launches["prefill"] > 0 and not any(
        launches[k] for k in ("decode_q8", "prefill_q8", "ragged", "ragged_q8", "matmul")),
          f"tier phase: launches {launches}")
    yard = tier_yardsticks(torch, TIER_PREFIX // BS * first["stats"]["offload_bytes"]
                           // max(1, first["stats"]["offload_blocks"]))
    host = host_copies(torch, model, card)
    host.update(tier_calls=copies, tier_blocks_stored=stored, tier_blocks_restored=restored)
    log(f"tier phase (bf16): {time.perf_counter() - t0:.1f} s, launches {launches} ({card})")
    return dict(first=first, repeats=repeats, persist=persist, router=router, shards=shards,
                planner=planner, yard=yard, launches=launches, host=host)


def tier_phase_q8(torch, model, card: str) -> dict:
    """(q): h1, h3 and h4 on the int8 model with an int8 cache (32-token
    blocks): the restored data and scale blocks bit-equal, the stream that
    of a second engine with P warm on its device."""
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    ps = {k: v for k, v in tier_prompts(0).items() if k != "s2"}
    run = tier_run(torch, model, INT8_TIER_PATH, ps, "q")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    check(all(launches[k] for k in ("decode_q8", "prefill_q8", "matmul")),
          f"int8 tier phase: launches {launches}")
    log(f"tier phase (int8): {time.perf_counter() - t0:.1f} s, launches {launches} ({card})")
    return dict(run=run, launches=launches)


def _gb_s(nbytes, seconds):
    return nbytes / seconds / 1e9 if seconds else None


def tier_line(bf16: dict, q8: dict, card: str) -> dict:
    """The ``{"tier": ...}`` line: TTFT cold, device hit, host restore and
    persist restore (the first run's and the repeats' median), blocks and
    bytes offloaded and restored, the copies' GB/s beside the pinned-copy
    yardsticks, persist spill and load MB/s, and h2's and h4's host gap."""
    runs = [bf16["first"]] + bf16["repeats"]

    def ttfts(key):
        return [1e3 * r["runs"][key]["ttft"] for r in runs]

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    st = {k: sum(r["stats"][k] for r in runs) for k in runs[0]["stats"]}
    p = bf16["persist"]
    q = q8["run"]
    return dict(
        card=card,
        ttft_ms={k: ttfts(h) for k, h in (("cold", "h1"), ("device_hit", "h2"),
                                           ("host_restore", "h4"))},
        ttft_median_ms={k: median(ttfts(h)[1:]) for k, h in (("cold", "h1"), ("device_hit", "h2"),
                                                             ("host_restore", "h4"))},
        ttft_persist_restore_ms=1e3 * p["warm"]["ttft"],
        host_gap_ms_per_turn={"h2": [r["runs"]["h2"]["host_gap_ms"] for r in runs],
                              "h4": [r["runs"]["h4"]["host_gap_ms"] for r in runs]},
        offloaded=dict(blocks=st["offload_blocks"], bytes=st["offload_bytes"]),
        restored=dict(blocks=st["restore_blocks"], bytes=st["restore_bytes"]),
        offload_gb_s=_gb_s(st["offload_bytes"], st["offload_copy_s"]),
        offload_store_gb_s=_gb_s(st["offload_bytes"], st["offload_store_s"]),
        restore_gb_s=_gb_s(st["restore_bytes"], st["restore_copy_s"]),
        restore_wall_gb_s=_gb_s(st["restore_bytes"], st["restore_wall_s"]),
        persist=dict(spill_mb_s=1e3 * (_gb_s(p["spill_bytes"], p["spill_s"]) or 0.0),
                     load_mb_s=1e3 * (_gb_s(p["load_bytes"], p["load_s"]) or 0.0),
                     spill_bytes=p["spill_bytes"], load_bytes=p["load_bytes"], hits=p["hits"],
                     files=p["files"]["persist_files"]),
        yardsticks=bf16["yard"],
        int8=dict(ttft_ms={k: 1e3 * v["ttft"] for k, v in q["runs"].items()},
                  cached={k: v["cached"] for k, v in q["runs"].items()},
                  offloaded_blocks=q["stats"]["offload_blocks"],
                  restored_blocks=q["stats"]["restore_blocks"],
                  offload_gb_s=_gb_s(q["stats"]["offload_bytes"], q["stats"]["offload_copy_s"]),
                  restore_gb_s=_gb_s(q["stats"]["restore_bytes"], q["stats"]["restore_copy_s"])),
        launches=bf16["launches"], launches_int8=q8["launches"])


# ------------------------------------------------------------------ grammar
GRAMMAR_CHOICES = ["alpha", "beta", "gamma"]
GRAMMAR_REGEX = "[0-9][0-9][0-9]-[0-9][0-9][0-9][0-9]"
# the constrained mix, one row per serving prompt; the seeded rows sit on
# prompts that share no prefix, so their prefill never depends on another
# request's cached blocks
GRAMMAR_TRAFFIC = (
    dict(temperature=0.0, json_mode=True),
    dict(temperature=1.0, seed=1234, json_mode=True),
    dict(temperature=0.9, top_p=0.9, seed=4321),
    dict(temperature=0.0, json_mode=True),
    dict(temperature=0.0, guided_choice=GRAMMAR_CHOICES),
    dict(temperature=0.0, guided_regex=GRAMMAR_REGEX),
)
GRAMMAR_SEEDED = (1, 2)
GRAMMAR_B = 8  # rows of the grammar and seeded-noise checks and timings: max_batch_size


def grammar_vocab(seed: int = 0, vocab: int = LLAMA3_VOCAB) -> list:
    """Token bytes of a ``vocab``-entry vocabulary made from a seed: ids
    3-258 the single bytes, the rest below Llama 3's specials printable
    ASCII strings of 2 to 8 bytes; ids 0-2 and the specials (EOS among
    them) None."""
    import numpy as np

    rng = np.random.default_rng(seed)
    first = vocab - 256
    lens = rng.integers(2, 9, size=first)
    chars = rng.integers(0x20, 0x7F, size=(first, 8)).astype(np.uint8)
    toks: list = [None] * vocab
    for i in range(259, first):
        toks[i] = chars[i, :lens[i]].tobytes()
    for b in range(256):
        toks[3 + b] = bytes([b])
    return toks


def _replays(tables, ids, eos) -> bool:
    """Every token of ``ids`` up to an EOS is one the tables allow where
    it was sampled (request-relative states from the initial one)."""
    from dynamo_tpu_torch.engine.grammar import INIT_STATE

    s, d, st = INIT_STATE, 0, 0
    for t in ids:
        if t in eos:
            return True
        if not tables.valid_mask(s, d, st)[t]:
            return False
        s, d, st = tables.advance(s, d, st, t)
    return True


def grammar_ops(torch, grammar, toks, card: str) -> dict:
    """The device half of constrained decoding and the seeded noise on the
    card against the CPU, then their times.

    ``grammar_mask`` / ``grammar_advance`` over a composite of the JSON
    grammar, a choice set and a regex at 128,256 tokens: four rounds of 8
    rows at states reached by random walks on the host tables (one row
    unconstrained), masked logits and advanced states equal to the CPU's
    exactly.  ``seeded_uniform`` on 512 random (seed, step, token)
    triples: bit-equal to the CPU's, ``seeded_gumbel`` within 2 f32 ulps.
    Then each op at B = 8 as a CUDA graph (the card's time) and eagerly,
    its kernel launches per call, and its bound."""
    import numpy as np

    from dynamo_tpu_torch.engine.grammar import (
        INIT_STATE, compile_choice_vocab, compile_regex_vocab, compose_tables, device_tables,
        grammar_advance, grammar_mask)
    from dynamo_tpu_torch.engine.sampling import K_MAX, seeded_gumbel, seeded_uniform

    eos = eos_ids()
    parts = [grammar.tables, compile_choice_vocab(toks, GRAMMAR_CHOICES, eos),
             compile_regex_vocab(toks, GRAMMAR_REGEX, eos)]
    comp, offs = compose_tables(parts)
    v, b = LLAMA3_VOCAB, GRAMMAR_B
    t0 = time.perf_counter()
    gt = device_tables(comp, v, "cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    gt_cpu = device_tables(comp, v, "cpu")
    rng = np.random.default_rng(0)

    def walk():
        """A random part's initial state, then up to 24 random valid tokens
        (a third of them opening a container where one may open)."""
        part = int(rng.integers(0, 3))
        s, d, st = INIT_STATE if part == 0 else 1 + offs[part], 0, 0
        for _ in range(int(rng.integers(0, 25))):
            ok = np.flatnonzero(comp.valid_mask(s, d, st))
            ok = ok[~np.isin(ok, eos)]
            push = ok[comp.npush[s, ok] > 0]
            if push.size and rng.random() < 0.3:
                ok = push
            if not ok.size:
                break
            s, d, st = comp.advance(s, d, st, int(rng.choice(ok)))
        return s, d, st

    depths = []
    for rnd in range(4):
        state, depth, stack = (np.asarray(x, np.int32) for x in zip(*(walk() for _ in range(b))))
        depths += depth.tolist()
        jrows = np.arange(b) != rnd  # one row unconstrained
        logits = rng.normal(size=(b, v)).astype(np.float32)
        cpu = [torch.from_numpy(a) for a in (logits, jrows, state, depth, stack)]
        dev = [a.cuda() for a in cpu]
        masked_cpu = grammar_mask(cpu[0], gt_cpu, *cpu[1:])
        masked = grammar_mask(dev[0], gt, *dev[1:])
        check(torch.equal(masked.cpu(), masked_cpu),
              f"grammar_mask on the card differs from the CPU's (round {rnd})")
        picks = np.zeros(b, np.int32)
        for i in range(b):
            ok = np.flatnonzero(masked_cpu[i].numpy() > -1e29)
            picks[i] = rng.choice(ok) if ok.size else eos[0]
        adv_cpu = grammar_advance(gt_cpu, *cpu[1:], torch.from_numpy(picks))
        adv = grammar_advance(gt, *dev[1:], torch.from_numpy(picks).cuda())
        check(all(torch.equal(a.cpu(), r) for a, r in zip(adv, adv_cpu)),
              f"grammar_advance on the card differs from the CPU's (round {rnd})")
    seeds = torch.from_numpy(rng.integers(0, 2 ** 31, size=b).astype(np.int32))
    steps = torch.from_numpy(rng.integers(0, 1 << 17, size=b).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, v, size=(b, K_MAX)).astype(np.int64))
    u_cpu, g_cpu = seeded_uniform(seeds, steps, ids), seeded_gumbel(seeds, steps, ids)
    u = seeded_uniform(seeds.cuda(), steps.cuda(), ids.cuda()).cpu()
    g = seeded_gumbel(seeds.cuda(), steps.cuda(), ids.cuda()).cpu()
    check(torch.equal(u.view(torch.int32), u_cpu.view(torch.int32)),
          "seeded uniforms on the card are not bit-equal to the CPU's")
    ulps = ((g - g_cpu).abs() / torch.finfo(torch.float32).eps / g_cpu.abs().clamp_min(1.0)).max()
    check(float(ulps) <= 2.0, f"seeded Gumbel noise on the card is {float(ulps):.2f} ulps off")

    # times at B = 8 on the last round's operands
    from torch.profiler import ProfilerActivity, profile

    sampled = torch.from_numpy(picks).cuda()
    sd, sp, cid = seeds.cuda(), steps.cuda(), ids.cuda()
    calls = {"grammar_mask": lambda: grammar_mask(dev[0], gt, *dev[1:]),
             "grammar_advance": lambda: grammar_advance(gt, *dev[1:], sampled),
             "seeded_gumbel": lambda: seeded_gumbel(sd, sp, cid)}
    # bytes each op must move: the four [S, V] table rows at each row's
    # state (int16 + 3 int8) and the f32 logits read and written; the
    # advance's five table entries and three int32 states in and out a
    # row; the noise's int32 seeds and steps and int64 ids in, f32 out.
    # The noise's operations are 32-bit integer and f32 ALU work (about 290
    # a value: three threefry blocks of 20 rounds and their key schedule),
    # counted against the f32 rate outside the tensor cores.
    work = {"grammar_mask": (0.0, b * v * (2 + 3 + 4 + 4) + v),
            "grammar_advance": (0.0, b * (2 + 4 + 4 * 4 + 3 * 4)),
            "seeded_gumbel": (290.0 * b * K_MAX, b * 8 + b * K_MAX * (8 + 4))}
    out = {}
    for name, fn in calls.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n_launch = sum(e.count for e in prof.key_averages()
                       if (getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0.0)) > 0)
        ops, nbytes = work[name]
        t_ops, t_bytes = ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        out[name] = dict(graph_ms=graph_time_ms([fn], 200), eager_ms=cuda_time_ms(lambda i: fn(), 200),
                         launches_per_call=n_launch, bound_ms=1e3 * max(t_ops, t_bytes),
                         bound_by="operations" if t_ops > t_bytes else "bytes")
    log(f"grammar ops: mask/advance on the card equal the CPU's exactly over 4 x {b} rows "
        f"at reachable states (depths up to {max(depths)}) of a {comp.n_states}-state composite "
        f"(json {parts[0].n_states}, choice {parts[1].n_states}, regex {parts[2].n_states}; "
        f"{gt.nbytes / 1e6:.1f} MB on the card, uploaded in {upload_s:.3f} s); seeded uniforms "
        f"bit-equal on {b * K_MAX} triples, Gumbel within {float(ulps):.2f} ulps; per call at "
        f"B = {b}, V = {v}: " + "; ".join(
            f"{k} graph {r['graph_ms']:.4f} ms, eager {r['eager_ms']:.4f} ms, "
            f"{r['launches_per_call']} launches, bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
            for k, r in out.items()) + f" ({card})")
    return dict(ops=out, composite_mb=gt.nbytes / 1e6, composite_states=comp.n_states,
                upload_s=upload_s)


@contextlib.contextmanager
def counted_grammar_calls():
    """Count the engine's calls of ``grammar_mask`` and ``grammar_advance``
    in a serving run, by wrapping the engine module's references to them
    (the functions themselves are untouched)."""
    from dynamo_tpu_torch.engine import core as engine_core

    counts = {"grammar_mask": 0, "grammar_advance": 0}
    real = {name: getattr(engine_core, name) for name in counts}

    def counting(name):
        def call(*args):
            counts[name] += 1
            return real[name](*args)
        return call

    for name in counts:
        setattr(engine_core, name, counting(name))
    try:
        yield counts
    finally:
        for name, fn in real.items():
            setattr(engine_core, name, fn)


def grammar_serve_run(torch, model, grammar, toks, config: dict, card: str, label: str,
                      traffic=GRAMMAR_TRAFFIC, reqs=None) -> dict:
    """The constrained mix (``traffic``, one row per prompt of ``reqs``:
    the six serving prompts unless named) once through ``AsyncLLMEngine``
    under ``config``, every kernel counter zeroed just before and read just
    after; each row held to its grammar: a JSON row that ended on EOS
    parses, one cut at max_tokens replays through the JSON tables; the
    choice row's text is a choice; the regex row replays through its tables
    (and, ended, fullmatches)."""
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.grammar import compile_regex_vocab
    from dynamo_tpu_torch.llm.protocols import FinishReason

    eos = eos_ids()
    core = EngineCore(model, EngineConfig(**config), eos_token_ids=eos, device="cuda",
                      grammar=grammar)
    engine = AsyncLLMEngine(core).start()
    reqs = reqs or prompts()
    try:
        asyncio.run(_serve(engine, [list(range(1, 40))], tag="warm-up"))  # unconstrained
        wrappers = _kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        with counted_grammar_calls() as calls:
            t0 = time.perf_counter()
            results = asyncio.run(_serve(engine, reqs, list(traffic)))
            wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        metrics = core.metrics()
    finally:
        engine.shutdown()
    streams = [[t for o in outs for t in o.token_ids] for _, _, outs in results]
    reasons = [outs[-1].finish_reason for _, _, outs in results]
    regex_tables = compile_regex_vocab(toks, GRAMMAR_REGEX, eos_ids=eos)
    texts = []
    for i, (opts, ids, reason) in enumerate(zip(traffic, streams, reasons)):
        text = b"".join(toks[t] for t in ids if toks[t] is not None)
        texts.append(text)
        check(reason in (FinishReason.EOS, FinishReason.LENGTH) and 0 < len(ids) <= MAX_TOKENS,
              f"grammar {label} row {i}: finish {reason} after {len(ids)} tokens")
        if opts.get("guided_regex"):
            check(_replays(regex_tables, ids, eos) and (
                reason is FinishReason.LENGTH or re.fullmatch(GRAMMAR_REGEX, text.decode())),
                f"grammar {label} row {i}: {text!r} is outside {GRAMMAR_REGEX}")
        elif opts.get("json_mode"):
            if reason is FinishReason.EOS:
                try:  # the JSON grammar does not check UTF-8 inside strings
                    json.loads(text.decode("utf-8", errors="replace"))
                except ValueError as e:
                    raise SmokeFailure(f"grammar {label} row {i}: {text!r} is not JSON: {e}")
            check(_replays(grammar.tables, ids, eos),
                  f"grammar {label} row {i}: {text!r} leaves the JSON grammar")
        elif opts.get("guided_choice"):
            check(reason is FinishReason.EOS and text.decode() in GRAMMAR_CHOICES,
                  f"grammar {label} row {i}: {text!r} is not one of {GRAMMAR_CHOICES}")
    ttfts = [r[0] for r in results]
    decode_tokens = sum(len(x) - 1 for x in streams)
    decode_window = wall - min(ttfts)
    kinds = [("json" if o.get("json_mode") else "choice" if o.get("guided_choice") else
              "regex" if o.get("guided_regex") else "free") + (" seeded" if "seed" in o else "")
             for o in traffic]
    log(f"grammar serving {label}: {len(results)} requests ({', '.join(kinds)}), wall {wall:.3f} s, TTFT min/median/max {min(ttfts):.3f}/"
        f"{sorted(ttfts)[len(ttfts) // 2]:.3f}/{max(ttfts):.3f} s, decode "
        f"{decode_tokens / decode_window:.1f} tok/s over {decode_window:.3f} s, host gap "
        f"{metrics['host_gap_ms_per_turn']:.2f} ms/turn, device reads {metrics['device_gets_total']}, "
        f"finish {[r.value for r in reasons]}, texts {[t[:40] for t in texts]}, grammar calls "
        f"{calls}, launches {launches} ({card})")
    return dict(streams=streams, launches=launches, metrics=metrics, ttfts=ttfts, wall=wall,
                decode_tok_s=decode_tokens / decode_window, calls=dict(calls))


def grammar_phase(torch, model, plain: dict, card: str) -> None:
    """Constrained decoding and per-request seeds on the serving phase's
    bf16 Llama-3-8B: a 128,256-token vocabulary from a seed and its JSON
    tables; the device ops against the CPU and their times
    (:func:`grammar_ops`); the constrained mix on the default path (B1, B2)
    and on the token-budget path (B3, B1); then the two seeded requests
    again, with one decode turn a dispatch and other companions, for the
    same streams.  Its serving line stands beside the unconstrained
    default run's (``plain``)."""
    from dynamo_tpu_torch.engine.grammar import JsonGrammar

    t_phase = time.perf_counter()
    toks = grammar_vocab()
    t0 = time.perf_counter()
    grammar = JsonGrammar.from_token_bytes(toks, eos_ids=eos_ids())
    compile_s = time.perf_counter() - t0
    log(f"grammar: JSON tables, {grammar.tables.n_states} states x {grammar.tables.vocab_size} "
        f"tokens, compiled in {compile_s:.2f} s on the host ({card})")
    ops = grammar_ops(torch, grammar, toks, card)
    torch.cuda.empty_cache()
    default = grammar_serve_run(torch, model, grammar, toks, DEFAULT_PATH, card, "default path")
    check(default["launches"]["decode"] > 0 and default["launches"]["prefill"] > 0,
          f"grammar default path: launches {default['launches']}, need decode and prefill > 0")
    torch.cuda.empty_cache()
    budget = grammar_serve_run(torch, model, grammar, toks, BUDGET_PATH, card, "token-budget path")
    check(budget["launches"]["ragged"] > 0 and budget["launches"]["decode"] > 0,
          f"grammar token-budget path: launches {budget['launches']}, need ragged and decode > 0")
    torch.cuda.empty_cache()
    # the seeded requests again: one decode turn a dispatch, and two
    # unconstrained greedy companions in place of the other four rows
    base = prompts()
    others = prompts(seed=3)[:2]
    again = grammar_serve_run(
        torch, model, grammar, toks, dict(DEFAULT_PATH, decode_steps=1), card,
        "seeded again, decode_steps=1, other companions",
        traffic=[GRAMMAR_TRAFFIC[i] for i in GRAMMAR_SEEDED] + [dict(temperature=0.0)] * 2,
        reqs=[base[i] for i in GRAMMAR_SEEDED] + others)
    for j, i in enumerate(GRAMMAR_SEEDED):
        check(again["streams"][j] == default["streams"][i],
              f"grammar: seeded request {i} gave {again['streams'][j]} with decode_steps=1 and "
              f"other companions, {default['streams'][i]} in the constrained run")
    torch.cuda.empty_cache()
    pm = plain["metrics"]
    log(f"grammar beside plain (default path, the same six prompts): constrained wall "
        f"{default['wall']:.3f} s, TTFT median/max {sorted(default['ttfts'])[3]:.3f}/"
        f"{max(default['ttfts']):.3f} s, decode {default['decode_tok_s']:.1f} tok/s, host gap "
        f"{default['metrics']['host_gap_ms_per_turn']:.2f} ms/turn; unconstrained TTFT "
        f"median/max {sorted(plain['ttfts'])[3]:.3f}/{max(plain['ttfts']):.3f} s, decode "
        f"{plain['decode_tok_s']:.1f} tok/s, host gap {pm['host_gap_ms_per_turn']:.2f} ms/turn; "
        f"tok/s share {default['decode_tok_s'] / plain['decode_tok_s']:.3f} ({card})")
    log(json.dumps({"grammar": dict(
        ops["ops"], composite_mb=ops["composite_mb"], composite_states=ops["composite_states"],
        upload_s=ops["upload_s"], json_compile_s=compile_s,
        launches={k: default["calls"][k] for k in ("grammar_mask", "grammar_advance")},
        constrained=dict(wall=default["wall"], ttft_median=sorted(default["ttfts"])[3],
                         ttft_max=max(default["ttfts"]), decode_tok_s=default["decode_tok_s"],
                         host_gap_ms=default["metrics"]["host_gap_ms_per_turn"]),
        plain=dict(ttft_median=sorted(plain["ttfts"])[3], ttft_max=max(plain["ttfts"]),
                   decode_tok_s=plain["decode_tok_s"], host_gap_ms=pm["host_gap_ms_per_turn"]),
        card=card)}))
    log(f"phase grammar (inside the bf16 serving phase): {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------- DeepSeek
def deepseek_v2_lite(num_layers: int = 27):
    """DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite config.json) at full
    width: no q-LoRA, kv_lora 512, nope 128, rope 64, v 128, 16 heads, 64
    routed experts top 6 of width 1,408 and 2 shared, greedy routing, the
    first layer dense (FFN 10,944).  Its YaRN ``rope_scaling`` is dropped:
    neither package implements it (``DeepseekConfig.from_hf`` refuses it)."""
    from dynamo_tpu_torch.models.deepseek import DeepseekConfig

    return DeepseekConfig(vocab_size=102400, hidden_size=2048, num_layers=num_layers, num_heads=16,
                          qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                          kv_lora_rank=512, q_lora_rank=None, intermediate_size=10944,
                          moe_intermediate_size=1408, n_routed_experts=64, num_experts_per_tok=6,
                          n_shared_experts=2, routed_scaling_factor=1.0, topk_method="greedy",
                          first_k_dense_replace=1, rms_norm_eps=1e-6, rope_theta=10000.0,
                          max_position_embeddings=163840, dtype="bfloat16")


def deepseek_v2_moe_layer():
    """One DeepSeek-V2 MoE layer (deepseek-ai/DeepSeek-V2 config.json) as a
    1-layer model: hidden 5,120, q-LoRA 1,536, 128 heads, 160 routed experts
    top 6 of width 1,536 and 2 shared, group-limited routing (8 groups, top
    3), routed scaling 16; 7.55 GB of experts.  The model (236 B) does not
    fit one card; ``rope_scaling`` dropped as for V2-Lite."""
    from dynamo_tpu_torch.models.deepseek import DeepseekConfig

    return DeepseekConfig(vocab_size=102400, hidden_size=5120, num_layers=1, num_heads=128,
                          qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                          kv_lora_rank=512, q_lora_rank=1536, intermediate_size=12288,
                          moe_intermediate_size=1536, n_routed_experts=160, num_experts_per_tok=6,
                          n_shared_experts=2, routed_scaling_factor=16.0,
                          topk_method="group_limited_greedy", n_group=8, topk_group=3,
                          first_k_dense_replace=0, rms_norm_eps=1e-6, rope_theta=10000.0,
                          max_position_embeddings=163840, dtype="bfloat16")


def _deepseek_model(torch, cfg, seed: int = 0):
    """A DeepseekModel of ``cfg`` on the card, random weights from a seeded
    generator (``deepseek_init_params``, one layer's draw at a time)."""
    from dynamo_tpu_torch.models.convert import deepseek_init_params
    from dynamo_tpu_torch.models.deepseek import DeepseekModel

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return DeepseekModel.from_state(cfg, deepseek_init_params(cfg, gen, device="cuda"))


# DeepSeek-V2-Lite's serving runs at 8 of its 27 layers (the first dense,
# the rest MoE): the same widths, experts and kernels, for the time limit
DEEPSEEK_SERVING_LAYERS = 8


def deepseek_serving_phase(torch, card: str) -> tuple[dict, dict]:
    """DeepSeek-V2-Lite at full width, DEEPSEEK_SERVING_LAYERS of its 27
    layers, behind ``AsyncLLMEngine``,
    the six requests on the default path: a bf16 cache (profiled), then an
    int8 cache in 32-token blocks.  Each run launches E1 and nothing else:
    no B kernel (MLA attention is the plain op) and no E2 (no int8
    weights).  Every Qwen3 model is gone before."""
    t0 = time.perf_counter()
    cfg = deepseek_v2_lite(DEEPSEEK_SERVING_LAYERS)
    model = _deepseek_model(torch, cfg)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"serving: DeepSeek-V2-Lite, {cfg.num_layers} layers, {weights / 1e9:.2f} GB of random "
        f"weights in {time.perf_counter() - t0:.1f} s")
    none = [k for k in _kernel_wrappers() if k != "moe"]
    runs = []
    for config, label, profile in (
            (DEFAULT_PATH, "DeepSeek-V2-Lite bf16 cache, default path", True),
            (INT8_DEFAULT_PATH, "DeepSeek-V2-Lite int8 cache (Bs 32), default path", False)):
        run = serve_run(torch, model, config, card, label, profile=profile)
        check(run["launches"]["moe"] > 0 and not any(run["launches"][k] for k in none),
              f"{label}: launches {run['launches']}, need moe > 0, {none} = 0")
        runs.append(run)
        torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(runs[0]["streams"], runs[1]["streams"]))
    log(f"serving: {same} of {len(runs[0]['streams'])} DeepSeek-V2-Lite int8-cache streams equal the "
        f"bf16 cache's (informational: the cache rounds to int8) ({card})")
    del model
    torch.cuda.empty_cache()
    return runs[0], runs[1]


def deepseek_parity_phase(torch, card: str) -> None:
    """Phase 5's default-path check (a 300-token prompt over a 128-token
    cached prefix, then 8 decode steps) on the card (bf16 weights) and on
    the CPU (f32, the same weights), with a bf16 cache (Bs 16) and an int8
    one (Bs 32): a 2-layer model at DeepSeek-V2-Lite width (the dense layer
    and one MoE layer), and one DeepSeek-V2 MoE layer.  The CPU routes as
    the card routed (``moe_routes``)."""
    import numpy as np

    from dynamo_tpu_torch.models.deepseek import DeepseekModel

    for make_cfg, width in ((lambda: deepseek_v2_lite(2), "2-layer DeepSeek-V2-Lite width"),
                            (deepseek_v2_moe_layer, "1 DeepSeek-V2 MoE layer")):
        cfg = make_cfg()
        gpu = _deepseek_model(torch, cfg)
        cpu_cfg = make_cfg()
        cpu_cfg.dtype = "float32"
        cpu = DeepseekModel.from_state(cpu_cfg, {k: v.cpu().float() for k, v in gpu.state_dict().items()})
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
        steps = rng.integers(0, cfg.vocab_size, 8).tolist()
        for bs, kv, tag in ((BS, None, "bf16 cache"), (BS_Q8, "int8", "int8 cache")):
            _hold_card_to_cpu(
                torch, f"default path: {width}, {tag}, 300-token prompt over a 128-token prefix "
                "+ 8 decode steps",
                lambda: _forward_logits(torch, gpu, torch.device("cuda"), prompt, steps, 128, bs, kv),
                lambda: _forward_logits(torch, cpu, torch.device("cpu"), prompt, steps, 128, bs, kv),
                card)
        del gpu, cpu
        torch.cuda.empty_cache()


def mla_timing(torch, card: str) -> list[dict]:
    """One DeepSeek-V2-Lite layer's latent attention, the plain op the model
    runs (``DeepseekModel._paged`` over a bf16 cache of 576-wide latent
    rows, one KV head, G = 16), as a CUDA graph: decode at B1's row shape
    (B = 8, S = 1, ``cuda_timing.DECODE_LENS``, 3,865 context tokens; the
    graph walks 27 layers' caches, past the L2, as a decode step does) and
    prefill at B2's (S = 1,504 from 0 over a 2,048-slot table).  Beside
    each: SDPA on the same latent K/V (laid out dense beforehand, V the
    whole row as the plain op reads it) timed the same way, held to the
    plain op, and the bound: one latent row per context token read once,
    q and the 512-wide output, against 2 H (576 + 512) operations per
    visible (query, key) pair.  Returns the ``mla`` line's rows."""
    import torch.nn.functional as F

    from dynamo_tpu_torch.models.deepseek import DeepseekModel

    cfg = deepseek_v2_lite()
    layers = cfg.num_layers
    model = DeepseekModel(cfg, device="meta")  # _paged reads only the config
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    # the latent row (576) of one KV head, the part that is attended (512), the heads (16)
    m, d, latent, h = 2048 // BS, cfg.head_dim, cfg.kv_lora_rank, cfg.num_heads
    rows = []

    def work(pairs, q_rows, ctx_rows, what):
        return dict(name=what, **kreg.bound(kreg.latent_attention_work(h, d, latent, pairs, q_rows,
                                                                        ctx_rows)))

    # decode
    lens = list(DECODE_LENS)
    b = len(lens)
    n_blocks = sum(-(-n // BS) for n in lens) + 8
    bt = _tables(torch, lens, m, n_blocks, gen)
    cache = torch.randn((layers, n_blocks, 1, BS, d), generator=gen, device="cuda").to(torch.bfloat16)
    cache = cache.expand(-1, -1, 2, -1, -1).contiguous()  # the latent row in both planes, as written
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    seq_lens = _ints(torch, lens)
    pos = (seq_lens - 1).clamp_min(0)[:, None].contiguous()
    calls = [lambda li=li: model._paged(q, cache, li, bt, seq_lens, pos) for li in range(layers)]
    ms = median_ms(lambda: graph_time_ms(calls, 10) / layers)
    eager = cuda_time_ms(lambda i: calls[i % layers](), 27)
    live = [i for i, n in enumerate(lens) if n]

    def dense_kv(layer):
        kd = torch.zeros((b, 1, max(lens), d), dtype=torch.bfloat16, device="cuda")
        for i, n in enumerate(lens):
            kd[i, 0, :n] = cache[layer, bt[i, :-(-n // BS)].long(), 0].reshape(-1, d)[:n]
        return kd, kd

    lib_ms, lib_eager = _sdpa_decode_ms(torch, q, lens, dense_kv, layers)
    kd, _ = dense_kv(LAYER)
    mask = (torch.arange(max(lens), device="cuda")[None, :] < seq_lens[:, None])[:, None, None, :]
    sdpa = F.scaled_dot_product_attention(q.transpose(1, 2), kd, kd, attn_mask=mask, enable_gqa=True,
                                          scale=model.sm_scale).transpose(1, 2)
    err = compare(torch, "mla decode: the plain op vs SDPA", model._paged(q, cache, LAYER, bt, seq_lens, pos)[live],
                  sdpa[live])
    row = work(sum(lens), b, sum(lens), "mla_decode")
    rows.append(dict(row, shape=f"B={b} S=1 ctx={sum(lens)}", ms=ms, library_ms=lib_ms, max_abs_err=err))
    log(f"time mla decode B={b} S=1 ctx={sum(lens)} (one DeepSeek-V2-Lite layer, latent {d}, G={h}): "
        f"plain op {ms:.4f} ms (CUDA graph; eager {eager:.4f}), sdpa {lib_ms:.4f} ms (CUDA graph; "
        f"eager {lib_eager:.4f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain op vs "
        f"sdpa max abs err {err:.3g} ({card})")
    del cache

    # prefill from 0
    fresh = max(PROMPT_LENS)
    s = -(-fresh // BS) * BS
    bt1 = _tables(torch, [fresh], m, -(-fresh // BS) + 8, gen)
    cache1 = torch.randn((1, int(bt1.max()) + 1, 1, BS, d), generator=gen, device="cuda").to(torch.bfloat16)
    cache1 = cache1.expand(-1, -1, 2, -1, -1).contiguous()
    q1 = torch.randn((1, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    lens1 = _ints(torch, [fresh])
    pos1 = torch.zeros((1, s), dtype=torch.int32, device="cuda")
    pos1[0, :fresh] = torch.arange(fresh, dtype=torch.int32, device="cuda")
    call = lambda: model._paged(q1, cache1, 0, bt1, lens1, pos1)  # noqa: E731
    ms = median_ms(lambda: graph_time_ms([call], 5))
    eager = cuda_time_ms(lambda i: call(), 5)
    k1 = cache1[0, bt1[0, :-(-fresh // BS)].long(), 0].reshape(-1, d)[:fresh][None, None]
    qs = q1[:, :fresh].transpose(1, 2).contiguous()

    def sdpa1():
        return F.scaled_dot_product_attention(qs, k1, k1, is_causal=True, enable_gqa=True,
                                              scale=model.sm_scale)

    lib_ms, lib_eager = _sdpa_ms(sdpa1)
    err = compare(torch, "mla prefill: the plain op vs SDPA", call()[:, :fresh], sdpa1().transpose(1, 2))
    row = work(fresh * (fresh + 1) // 2, fresh, fresh, "mla_prefill")
    rows.append(dict(row, shape=f"B=1 S={s} fresh={fresh} start=0", ms=ms, library_ms=lib_ms,
                     max_abs_err=err))
    log(f"time mla prefill B=1 S={s} fresh={fresh} start=0 (one DeepSeek-V2-Lite layer): plain op "
        f"{ms:.4f} ms (CUDA graph; eager {eager:.4f}), sdpa {lib_ms:.4f} ms (CUDA graph; eager "
        f"{lib_eager:.4f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain op vs sdpa max "
        f"abs err {err:.3g} ({card})")
    del cache1
    torch.cuda.empty_cache()
    return rows


# The DeepSeek checkpoint: DeepSeek-V2-Lite's width and tensor names, cut
# to 2 layers (the dense one and one MoE layer: 216 tensors, 2.2 GB)
DEEPSEEK_ATTN_NAMES = {
    "attn_norm": ("input_layernorm.weight", False),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "kv_a": ("self_attn.kv_a_proj_with_mqa.weight", True),
    "kv_a_norm": ("self_attn.kv_a_layernorm.weight", False),
    "kv_b": ("self_attn.kv_b_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
}
DEEPSEEK_FRONT_NAMES = {
    "embed": ("model.embed_tokens.weight", False), "final_norm": ("model.norm.weight", False),
    "lm_head": ("lm_head.weight", True),
    **{f"{g}.{k}": ("model.layers.{i}." + hf, t) for g in ("dense_layers", "moe_layers")
       for k, (hf, t) in DEEPSEEK_ATTN_NAMES.items()},
    "dense_layers.w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "dense_layers.w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "dense_layers.w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
    "moe_layers.router": ("model.layers.{i}.mlp.gate.weight", True),
    "moe_layers.w_gate": ("model.layers.{i}.mlp.experts.{e}.gate_proj.weight", True),
    "moe_layers.w_up": ("model.layers.{i}.mlp.experts.{e}.up_proj.weight", True),
    "moe_layers.w_down": ("model.layers.{i}.mlp.experts.{e}.down_proj.weight", True),
    "moe_layers.shared_gate": ("model.layers.{i}.mlp.shared_experts.gate_proj.weight", True),
    "moe_layers.shared_up": ("model.layers.{i}.mlp.shared_experts.up_proj.weight", True),
    "moe_layers.shared_down": ("model.layers.{i}.mlp.shared_experts.down_proj.weight", True),
}
QUANTIZE_REFUSED = "--quantize int8 is not wired for this model family yet"  # the JAX CLI's words


def write_deepseek_checkpoint(torch, d: Path) -> float:
    """The 2-layer DeepSeek checkpoint: config.json as DeepSeek-V2-Lite's
    with 2 layers and no ``rope_scaling``, and random bf16 weights from a
    seeded generator (matrices N(0, 1/fan_in), norms 1 + N(0, 0.1^2)) under
    the real checkpoint's names, in two safetensors shards with an index.
    Returns the bytes written."""
    from safetensors.torch import save_file

    cfg = deepseek_v2_lite(FRONT_LAYERS)
    dm, h, e = cfg.hidden_size, cfg.num_heads, cfg.n_routed_experts
    r, rope, fm = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.moe_intermediate_size
    sp = specials(cfg.vocab_size)
    (d / "config.json").write_text(json.dumps({
        "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2",
        "vocab_size": cfg.vocab_size, "hidden_size": dm, "intermediate_size": cfg.intermediate_size,
        "moe_intermediate_size": fm, "num_hidden_layers": FRONT_LAYERS, "num_attention_heads": h,
        "num_key_value_heads": h, "n_routed_experts": e, "num_experts_per_tok": cfg.num_experts_per_tok,
        "n_shared_experts": cfg.n_shared_experts, "routed_scaling_factor": cfg.routed_scaling_factor,
        "kv_lora_rank": r, "q_lora_rank": None, "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": rope, "v_head_dim": cfg.v_head_dim, "topk_method": "greedy",
        "n_group": 1, "topk_group": 1, "norm_topk_prob": False, "scoring_func": "softmax",
        "first_k_dense_replace": 1, "moe_layer_freq": 1, "rope_theta": cfg.rope_theta,
        "rope_scaling": None, "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps, "hidden_act": "silu", "attention_bias": False,
        "tie_word_embeddings": False, "bos_token_id": sp["<|begin_of_text|>"],
        "eos_token_id": eos_ids(cfg.vocab_size), "torch_dtype": "bfloat16"}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)

    def matrix(rows, cols):  # HF layout [out, in]
        w = torch.randn((rows, cols), generator=gen, device="cuda", dtype=torch.float32)
        return w.div_(math.sqrt(cols)).to(torch.bfloat16).cpu()

    def norm(n=dm):
        w = 1 + 0.1 * torch.randn((n,), generator=gen, device="cuda", dtype=torch.float32)
        return w.to(torch.bfloat16).cpu()

    def layer(i):
        p = f"model.layers.{i}."
        out = {p + "input_layernorm.weight": norm(), p + "post_attention_layernorm.weight": norm(),
               p + "self_attn.q_proj.weight": matrix(h * cfg.qk_head_dim, dm),
               p + "self_attn.kv_a_proj_with_mqa.weight": matrix(r + rope, dm),
               p + "self_attn.kv_a_layernorm.weight": norm(r),
               p + "self_attn.kv_b_proj.weight": matrix(h * (cfg.qk_nope_head_dim + cfg.v_head_dim), r),
               p + "self_attn.o_proj.weight": matrix(dm, h * cfg.v_head_dim)}
        if i < cfg.first_k_dense_replace:
            f = cfg.intermediate_size
            out.update({p + "mlp.gate_proj.weight": matrix(f, dm), p + "mlp.up_proj.weight": matrix(f, dm),
                        p + "mlp.down_proj.weight": matrix(dm, f)})
            return out
        fs = fm * cfg.n_shared_experts
        out[p + "mlp.gate.weight"] = matrix(e, dm)
        for j in range(e):
            q = f"{p}mlp.experts.{j}."
            out.update({q + "gate_proj.weight": matrix(fm, dm), q + "up_proj.weight": matrix(fm, dm),
                        q + "down_proj.weight": matrix(dm, fm)})
        out.update({p + "mlp.shared_experts.gate_proj.weight": matrix(fs, dm),
                    p + "mlp.shared_experts.up_proj.weight": matrix(fs, dm),
                    p + "mlp.shared_experts.down_proj.weight": matrix(dm, fs)})
        return out

    shards = [{"model.embed_tokens.weight": matrix(cfg.vocab_size, dm), **layer(0)},
              {**layer(1), "model.norm.weight": norm(), "lm_head.weight": matrix(cfg.vocab_size, dm)}]
    weight_map, total = {}, 0
    for k, shard in enumerate(shards):
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, str(d / name), metadata={"format": "pt"})
        weight_map.update({t: name for t in shard})
        total += sum(t.numel() * t.element_size() for t in shard.values())
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def deepseek_front_door_phase(torch, card: str) -> None:
    """The front door on the 2-layer DeepSeek checkpoint: the CLI server
    (bf16 cache) and, at once, ``--quantize int8`` refused with the JAX CLI's message,
    then ``build_local_engine`` in this process with a bf16 cache and with
    an int8 one (Bs 32), each launching E1 and nothing else, the loaded
    tensors held to the shards and the answers to a fresh engine's."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(FRONT_DIR, ignore_errors=True)
    cfg = deepseek_v2_lite(FRONT_LAYERS)
    write_tokenizer(FRONT_DIR, cfg.vocab_size)
    nbytes = write_deepseek_checkpoint(torch, FRONT_DIR)
    n_files = len(json.loads((FRONT_DIR / "model.safetensors.index.json").read_text())["weight_map"])
    log(f"front door: wrote a {FRONT_LAYERS}-layer DeepSeek-V2-Lite-width checkpoint, "
        f"{nbytes / 1e9:.2f} GB, {n_files} tensors in two shards, in {time.perf_counter() - t0:.1f} s")
    refused = []
    concurrently(lambda: cli_phase(card, (), "DeepSeek-V2-Lite"), lambda: refused.append(
        subprocess.run([sys.executable, "-m", "dynamo_tpu_torch", "run", "in=text:w5 w6",
                        "out=gpu", "--model-path", str(FRONT_DIR), "--quantize", "int8"],
                       cwd=str(ROOT), capture_output=True, text=True, timeout=300)))
    refused = refused[0]
    check(refused.returncode != 0 and QUANTIZE_REFUSED in refused.stderr and not refused.stdout,
          f"front door DeepSeek: --quantize int8 exited {refused.returncode}, stderr "
          f"{refused.stderr[-1000:]!r}")
    log(f"front door CLI: `--quantize int8` on the DeepSeek checkpoint exits {refused.returncode} with "
        f"{QUANTIZE_REFUSED!r} ({card})")
    none = [k for k in _kernel_wrappers() if k != "moe"]
    first = {"moe_layers": cfg.first_k_dense_replace}
    for flags, label in ((FRONT_FLAGS, "DeepSeek bf16 cache"),
                         (FRONT_FLAGS + ["--kv-cache-dtype", "int8", "--block-size", str(BS_Q8)],
                          "DeepSeek int8 cache")):
        front_server(torch, flags, card, label, ["moe"], none, DEEPSEEK_FRONT_NAMES,
                     cfg.n_routed_experts, first)
        torch.cuda.empty_cache()
    log(f"front door DeepSeek: phase wall {time.perf_counter() - t0:.1f} s ({card})")


# --------------------------------------------------------------- fault plane
# two workers, each its own engine on the loaded Llama-3-8B, behind a
# MigratingClient with a HealthMonitor and an AdmissionController in front
FAULT_PROMPT = PROMPT_LENS.index(1500)  # the 1,500-token prompt
FAULT_CUT_ITEMS = 8  # the serving worker's transport is cut as its 8th item frame goes out
FAULT_HEALTH = dict(interval_s=0.25, timeout_s=1.0, fail_threshold=2)
FAULT_BURST, FAULT_BUCKET = 6, 2  # one tenant's burst against a bucket of two
FAULT_NEXT = 3  # requests after the kill, each of which must land on the survivor
FAULT_SHORT_TOKENS = 8
FAULT_ENDPOINT = ("dynamo", "backend", "generate")


@contextlib.contextmanager
def launches_by_thread():
    """Count the attention kernels' calls by the thread that made them (each
    AsyncLLMEngine steps its core on a thread of its own), by wrapping the
    routing's references to the wrappers; the wrappers and their launch
    counts are untouched."""
    import threading

    from dynamo_tpu_torch.ops import paged_attention as routing

    names = {"decode": "paged_decode_attention", "prefill": "paged_prefill_attention",
             "ragged": "ragged_paged_prefill_attention",
             "decode_q8": "paged_decode_attention_q8", "prefill_q8": "paged_prefill_attention_q8",
             "ragged_q8": "ragged_paged_prefill_attention_q8"}
    real = {k: getattr(routing, n) for k, n in names.items()}
    rec: dict[int, dict[str, int]] = {}

    def wrap(k):
        def call(*args, **kw):
            per = rec.setdefault(threading.get_ident(), {})
            per[k] = per.get(k, 0) + 1
            return real[k](*args, **kw)
        return call

    for k, n in names.items():
        setattr(routing, n, wrap(k))
    try:
        yield rec
    finally:
        for k, n in names.items():
            setattr(routing, n, real[k])


def _hops(client) -> dict:
    """Wrap the client's ``direct`` on the instance: every item the
    MigratingClient receives is recorded, per request id, as (host time,
    instance id, token ids).  Returns the record; ``del client.direct``
    removes the wrap."""
    real = client.direct
    rec: dict[str, list] = {}

    def direct(request, iid):
        async def gen():
            async for item in real(request, iid):
                if getattr(item, "token_ids", None):
                    rec.setdefault(request.id, []).append(
                        (time.perf_counter(), iid, list(item.token_ids)))
                yield item
        return gen()

    client.direct = direct
    return rec


async def _fault_post(session, url: str, prompt: list[int], rid: str, max_tokens: int,
                      stream: bool = True, headers: dict | None = None) -> dict:
    """One completion of token ids as ``rid`` (also its tenant): status,
    Retry-After, SSE comments and finish reasons (a stream) or the body."""
    body = {"model": "fault", "prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
            "stream": stream}
    hdrs = {"x-request-id": rid, "x-tenant": rid, **(headers or {})}
    async with session.post(url + "/v1/completions", json=body, headers=hdrs) as r:
        out = dict(status=r.status, retry_after=r.headers.get("Retry-After"),
                   migrated=r.headers.get("x-migrated"), comments=[], finishes=[])
        if not stream or r.status != 200:
            out["body"] = await r.json()
            return out
        async for raw in r.content:
            line = raw.decode().strip()
            if line.startswith(": "):
                out["comments"].append(line[2:])
            elif line.startswith("data: ") and line != "data: [DONE]":
                out["finishes"] += [c.get("finish_reason") for c in json.loads(line[6:])["choices"]]
        return out


def _metric(text: str, name: str) -> float:
    """The sum of a family's samples on a /metrics page."""
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name) and line[len(name)] in " {")


async def _wait_idle(engine, limit_s: float = 10.0) -> int:
    """Step boundaries until the engine's core holds no block (an aborted
    request's release lands on the engine thread): its active blocks."""
    t0 = time.perf_counter()
    while True:
        held = await engine.run_on_engine(lambda: engine.core.block_manager.active_blocks)
        if held == 0 or time.perf_counter() - t0 > limit_s:
            return held
        await asyncio.sleep(0.05)


async def _fault_serve(torch, model, card: str) -> dict:
    """The fault phase's serving: (a) a streamed request whose worker is cut
    at its FAULT_CUT_ITEMS-th item migrates; (b) the same cut with
    ``x-migration-limit: 0`` ends in an error; (d) a burst of FAULT_BURST
    from one tenant against a bucket of FAULT_BUCKET; (c) the first
    worker's request plane killed, suspect, the next requests on the
    survivor, then the survivor drained under two live streams."""
    import aiohttp

    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore
    from dynamo_tpu_torch.fault import FaultInjector, HealthMonitor, MigratingClient
    from dynamo_tpu_torch.fault.counters import counters
    from dynamo_tpu_torch.llm.engines import build_serving_pipeline
    from dynamo_tpu_torch.llm.http import HttpService, ModelManager
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.obs.metric_names import FaultMetric as FM
    from dynamo_tpu_torch.obs.metric_names import HttpMetric as HM
    from dynamo_tpu_torch.planner import AdmissionConfig, AdmissionController
    from dynamo_tpu_torch.runtime import serde
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorServer

    serde.register_llm_types()
    counters.reset()
    ns, comp, ep = FAULT_ENDPOINT
    engines = [AsyncLLMEngine(EngineCore(model, EngineConfig(**DEFAULT_PATH), device="cuda")).start()
               for _ in range(2)]
    srv = await CoordinatorServer(port=0).start()
    runtimes, client, mon, http, out = [], None, None, None, {}
    injector = FaultInjector()
    try:
        for i, e in enumerate(engines):
            await _serve(e, [list(range(1, 40))], tag=f"fault-warm-up-{i}")
        for e in engines:
            rt = await DistributedRuntime.connect(RuntimeConfig(coordinator_url=srv.url,
                                                                lease_ttl_s=10.0))
            await rt.namespace(ns).component(comp).endpoint(ep).serve(e)
            runtimes.append(rt)
        fe = await DistributedRuntime.connect(RuntimeConfig(coordinator_url=srv.url))
        runtimes.append(fe)
        client = await fe.namespace(ns).component(comp).endpoint(ep).client()
        await client.wait_for_instances(2, timeout=30)
        mon = HealthMonitor(client, **FAULT_HEALTH)
        client.health = mon
        # the first pick is the lowest healthy instance id, so the worker a
        # request lands on is known before it is sent
        mig = MigratingClient(client, backoff_s=0.05,
                              pick=lambda exclude: min(client._candidate_ids(exclude)))
        hops = _hops(client)
        mcard = ModelDeploymentCard(name="fault", tokenizer_path=str(FRONT_DIR / "tokenizer.json"),
                                    context_length=DEFAULT_PATH["max_model_len"])
        manager = ModelManager()
        manager.add_model("fault", build_serving_pipeline(mig, mcard), mcard)
        admission = AdmissionController(AdmissionConfig(
            max_concurrent=8, rate_tokens_per_s=0.01, burst_tokens=float(FAULT_BUCKET)))
        http = HttpService(manager, port=0, admission=admission)
        await http.start()
        url = f"http://127.0.0.1:{http.port}"
        first = min(client.instance_ids())
        cut = runtimes[[rt.instance_id for rt in runtimes[:2]].index(first)]
        cut_engine, survivor = (engines[0], engines[1]) if cut is runtimes[0] else (
            engines[1], engines[0])
        surv_rt = runtimes[1] if cut is runtimes[0] else runtimes[0]
        prompt = model_prompts(model)[FAULT_PROMPT]
        async with aiohttp.ClientSession() as s:
            # (a) migration
            wrappers = _kernel_wrappers()
            for fn in wrappers.values():
                fn.launches = 0
            before = (survivor.core.prefill_counters.dispatches_total,
                      survivor.core.prefill_counters.tokens_total)
            cut_reqs = []
            real_submit = cut_engine.core.submit
            cut_engine.core.submit = lambda req: (cut_reqs.append(req), real_submit(req))[1]
            injector.sever_after(cut, n_items=FAULT_CUT_ITEMS)
            with launches_by_thread() as by_thread:
                a = await _fault_post(s, url, prompt, "fault-a", MAX_TOKENS)
                # both engines at a step boundary with no block held: the
                # cut request's release has landed and no burst is running
                out["cut_held"] = await _wait_idle(cut_engine)
                await _wait_idle(survivor)
            injector.clear(cut)
            del cut_engine.core.submit
            out["cut_finish"] = [(str(r.finish_reason and r.finish_reason.value), r.generated)
                                 for r in cut_reqs]
            out["launches"] = {k: fn.launches for k, fn in wrappers.items()}
            out["survivor_launches"] = by_thread.get(survivor._thread.ident, {})
            out["cut_launches"] = by_thread.get(cut_engine._thread.ident, {})
            rec = hops.get("fault-a", [])
            out["a"] = a
            out["tokens"] = [t for _, _, toks in rec for t in toks]
            from_cut = [r for r in rec if r[1] == cut.instance_id]
            from_surv = [r for r in rec if r[1] == surv_rt.instance_id]
            out["emitted_before_cut"] = sum(len(r[2]) for r in from_cut)
            out["gap_ms"] = (1e3 * (from_surv[0][0] - from_cut[-1][0])
                             if from_cut and from_surv else None)
            out["reprefill"] = (survivor.core.prefill_counters.dispatches_total - before[0],
                                survivor.core.prefill_counters.tokens_total - before[1])
            out["migrations_a"] = counters.migrations_total
            # (b) the same cut, opted out of migration
            injector.sever_after(cut, n_items=FAULT_CUT_ITEMS)
            b = await _fault_post(s, url, prompt[:300], "fault-b", MAX_TOKENS,
                                  headers={"x-migration-limit": "0"})
            injector.clear(cut)
            out["b"] = b
            out["migrations_b"] = counters.migrations_total - out["migrations_a"]
            out["cut_held_b"] = await _wait_idle(cut_engine)
            # (d) admission: one tenant's burst against a bucket of FAULT_BUCKET
            short = model_prompts(model, seed=5)
            burst = await asyncio.gather(*(
                _fault_post(s, url, short[0], "fault-burst", FAULT_SHORT_TOKENS, stream=False,
                            headers={"x-request-id": f"fault-burst-{i}"})
                for i in range(FAULT_BURST)))
            out["burst"] = burst
            text = await (await s.get(url + "/metrics")).text()
            out["shed_metric"] = _metric(text, HM.ADMISSION_SHED_TOTAL)
            out["shed_total"] = dict(admission.shed_total)
            # (c) kill the first worker's request plane: suspect, then the
            # next requests on the survivor
            await mon.start()
            await asyncio.sleep(2 * FAULT_HEALTH["interval_s"])
            check(not mon.suspect_ids(), f"fault (c): suspects {mon.suspect_ids()} before the kill")
            t0 = time.perf_counter()
            await injector.kill_tcp_server(cut)
            while cut.instance_id not in mon.suspect_ids():
                check(time.perf_counter() - t0 < 30, "fault (c): no suspect after 30 s")
                await asyncio.sleep(0.01)
            out["suspect_s"] = time.perf_counter() - t0
            text = await (await s.get(url + "/metrics")).text()
            out["suspect_metric"] = _metric(text, FM.SUSPECT_INSTANCES)
            nxt = [await _fault_post(s, url, short[1 + i][:100], f"fault-next-{i}",
                                     FAULT_SHORT_TOKENS, stream=False)
                   for i in range(FAULT_NEXT)]
            out["survivor_id"] = surv_rt.instance_id
            out["next"] = [dict(status=r["status"], migrated=r["migrated"],
                                workers=sorted({h[1] for h in hops.get(f"fault-next-{i}", [])}))
                           for i, r in enumerate(nxt)]
            # drain the survivor with two streams live
            live = [asyncio.ensure_future(_fault_post(s, url, short[4 + i][:200],
                                                      f"fault-drain-{i}", MAX_TOKENS))
                    for i in range(2)]
            while not all(hops.get(f"fault-drain-{i}") for i in range(2)):
                check(time.perf_counter() - t0 < 120, "fault (c): the drain's streams never started")
                await asyncio.sleep(0.01)
            drain = asyncio.ensure_future(
                surv_rt.namespace(ns).component(comp).endpoint(ep).drain(timeout=60.0))
            await asyncio.sleep(0)
            out["drains_in_progress"] = counters.drains_in_progress
            out["drained"] = await drain
            out["drain"] = await asyncio.gather(*live)
            out["drain_tokens"] = [sum(len(h[2]) for h in hops[f"fault-drain-{i}"])
                                   for i in range(2)]
            out["drains_after"] = counters.drains_in_progress
        del client.direct
        return out
    finally:
        if http is not None:
            await http.stop()
        if mon is not None:
            await mon.stop()
        injector.release_all()
        if client is not None:
            await client.close()
        for rt in runtimes:
            await rt.shutdown()
        await srv.stop()
        for e in engines:
            e.shutdown()
        counters.reset()


def fault_phase(torch, model, card: str) -> dict:
    """The fault plane on the loaded Llama-3-8B (``_fault_serve``), held:
    the migrated stream ends with MAX_TOKENS tokens and ``x-migrated 1``,
    one migration, the survivor's one prefill of the prompt and the tokens
    the cut worker delivered, which launched only B1 and B2 (as the whole
    run did), the cut worker's engine stopping early (its request cancelled
    within two decode bursts past the cut) and holding no block; its tokens equal
    the request served unbroken by a fresh engine, or part only at a near
    tie; the opted-out request ends in an error, unmigrated; FAULT_BURST -
    FAULT_BUCKET of the burst shed with Retry-After and counted, the rest
    answered; the killed worker suspect within fail_threshold x interval_s
    (plus one probe's timeout), counted on /metrics, the next requests on
    the survivor alone; the drain finishing both live streams.  Logs and
    returns the ``{"fault": ...}`` line."""
    from dynamo_tpu_torch.engine import AsyncLLMEngine, EngineConfig, EngineCore

    t0 = time.perf_counter()
    prompt = model_prompts(model)[FAULT_PROMPT]
    ref_engine = AsyncLLMEngine(EngineCore(model, EngineConfig(**DEFAULT_PATH),
                                           device="cuda")).start()
    try:
        asyncio.run(_serve(ref_engine, [list(range(1, 40))], tag="fault-ref-warm-up"))
        ref = _streams(asyncio.run(_serve(ref_engine, [prompt], tag="fault-ref")))[0]
    finally:
        ref_engine.shutdown()
    r = asyncio.run(_fault_serve(torch, model, card))
    gc.collect()
    torch.cuda.empty_cache()
    a, b = r["a"], r["b"]
    check(a["status"] == 200 and a["finishes"][-1] == "length" and len(r["tokens"]) == MAX_TOKENS,
          f"fault (a): status {a['status']}, finishes {a['finishes'][-3:]}, "
          f"{len(r['tokens'])} tokens")
    check("x-migrated 1" in a["comments"] and r["migrations_a"] == 1,
          f"fault (a): comments {a['comments']}, migrations {r['migrations_a']}")
    emitted = r["emitted_before_cut"]
    check(emitted == FAULT_CUT_ITEMS - 1, f"fault (a): {emitted} tokens before the cut")
    check(r["reprefill"] == (1, len(prompt) + emitted),
          f"fault (a): the survivor's prefills {r['reprefill']}, expected one of "
          f"{len(prompt) + emitted} tokens")
    surv = r["survivor_launches"]
    check(set(surv) == {"decode", "prefill"} and all(surv.values()),
          f"fault (a): the survivor launched {surv}, expected B1 and B2 only")
    check(all(v == 0 for k, v in r["launches"].items() if k not in ("decode", "prefill"))
          and all(r["launches"][k] == surv.get(k, 0) + r["cut_launches"].get(k, 0)
                  for k in ("decode", "prefill")),
          f"fault (a): launches {r['launches']}, by engine {surv} + {r['cut_launches']}")
    check(r["cut_held"] == 0 and r["cut_held_b"] == 0,
          f"fault: the cut worker's engine holds {r['cut_held']} / {r['cut_held_b']} blocks")
    # the cut engine stops early: its request ends cancelled, and it ran at
    # most two decode bursts past the one that made the cut item
    steps = DEFAULT_PATH["decode_steps"]
    cut_steps = steps * (-(-(FAULT_CUT_ITEMS - 1) // steps) + 2)
    cut_b1 = r["cut_launches"].get("decode", 0)
    check(r["cut_finish"] and all(f == "cancelled" and g <= 1 + cut_steps
                                  for f, g in r["cut_finish"])
          and cut_b1 <= cut_steps * model.config.num_layers,
          f"fault (a): the cut engine's request ended {r['cut_finish']} (finish, tokens) with "
          f"{cut_b1} B1 launches; expected cancelled within {cut_steps} decode steps "
          f"({cut_steps * model.config.num_layers} launches)")
    parted = spec_near_ties(torch, model, dict(streams=[ref]),
                            dict(streams=[r["tokens"]], label="fault (a) migrated"), card,
                            bs=DEFAULT_PATH["block_size"], prompts=[prompt],
                            sampling=[{"temperature": 0.0}], against="the unbroken stream")
    check(b["status"] == 200 and b["finishes"][-1] == "error" and not b["comments"]
          and r["migrations_b"] == 0,
          f"fault (b): finishes {b['finishes'][-2:]}, comments {b['comments']}, "
          f"migrations {r['migrations_b']}")
    shed = [x for x in r["burst"] if x["status"] == 429]
    ok = [x for x in r["burst"] if x["status"] == 200]
    check(len(shed) == FAULT_BURST - FAULT_BUCKET and len(ok) == FAULT_BUCKET
          and all(int(x["retry_after"]) >= 1 for x in shed)
          and all(x["body"]["usage"]["completion_tokens"] == FAULT_SHORT_TOKENS for x in ok)
          and r["shed_metric"] == len(shed) == sum(r["shed_total"].values()),
          f"fault (d): statuses {[x['status'] for x in r['burst']]}, shed metric "
          f"{r['shed_metric']}, controller {r['shed_total']}")
    h = FAULT_HEALTH
    bound = h["fail_threshold"] * h["interval_s"] + h["timeout_s"]
    check(r["suspect_s"] <= bound and r["suspect_metric"] == 1,
          f"fault (c): suspect after {r['suspect_s']:.3f} s (bound {bound} s), gauge "
          f"{r['suspect_metric']}")
    check(all(n["status"] == 200 and not n["migrated"] and n["workers"] == [r["survivor_id"]]
              for n in r["next"]),
          f"fault (c): the next requests {r['next']}")
    check(r["drained"] and r["drains_in_progress"] == 1 and r["drains_after"] == 0
          and all(d["status"] == 200 and d["finishes"][-1] == "length" for d in r["drain"])
          and r["drain_tokens"] == [MAX_TOKENS, MAX_TOKENS],
          f"fault (c): drained {r['drained']}, gauge {r['drains_in_progress']} then "
          f"{r['drains_after']}, streams {[d['finishes'][-1:] for d in r['drain']]} "
          f"{r['drain_tokens']}")
    line = dict(
        label="fault plane: Llama-3-8B bf16, default path, two workers in one process",
        prompt_tokens=len(prompt), cut_at_item=FAULT_CUT_ITEMS, tokens=len(r["tokens"]),
        emitted_before_cut=emitted, migrated=a["comments"], gap_ms=r["gap_ms"],
        reprefilled_tokens=r["reprefill"][1], survivor_launches=surv,
        cut_worker_launches=r["cut_launches"], cut_worker_finish=r["cut_finish"],
        launches=r["launches"], parted_from_unbroken=parted,
        opt_out_finish=b["finishes"][-1], seconds_to_suspect=r["suspect_s"],
        suspect_bound_s=bound, shed_429=len(shed), admitted=len(ok),
        next_on_survivor=len(r["next"]), drained=r["drained"], seconds=time.perf_counter() - t0,
        card=card)
    log(f"fault phase: {line['seconds']:.1f} s, migration gap {line['gap_ms']:.1f} ms, "
        f"{line['reprefilled_tokens']} tokens re-prefilled, the cut engine's request "
        f"{r['cut_finish']} (finish, tokens) after {cut_b1} B1 launches, suspect after "
        f"{line['seconds_to_suspect']:.3f} s, {len(shed)} shed ({card})")
    return line


# ------------------------------------------------------- checkpoint formats
# the front-door checkpoint as a native int8 checkpoint, as a Q8_0 GGUF file
# and pulled through the model store, each into this git-ignored directory
FORMATS_DIR = ROOT / "_formats"
FORMATS_TOKENS = 16
# the GGUF's card-packed Q8_0 bytes held to llm/gguf.py's writer: one whole
# matrix, and this many rows (from a seed) of every other one
FORMATS_Q8_WHOLE = "blk.0.attn_k.weight"
FORMATS_Q8_ROWS, FORMATS_Q8_SEED = 64, 7
FORMATS_MODEL = "front"
FORMATS_FILES = ("config.json", "tokenizer.json", "tokenizer_config.json",
                 "model.safetensors.index.json")


def _q8_0_bytes(torch, w) -> bytes:
    """``w`` as GGUF Q8_0 blocks, packed on the card: per 32 values an f16
    scale amax / 127 and 32 int8 codes, in the arithmetic of ``llm/gguf.py``'s
    writer (f32 division, round half to even).  The divisor 127 is a card
    tensor: a Python scalar divisor makes the card multiply by its
    reciprocal, which is off by one bit for some scales."""
    flat = w.reshape(-1, 32).float()
    amax = flat.abs().amax(dim=1)
    d = amax / torch.full_like(amax, 127.0)
    safe = torch.where(d == 0, torch.ones_like(d), d)
    qs = torch.round(flat / safe[:, None]).clamp(-127, 127).to(torch.int8)
    rec = torch.cat([d.to(torch.float16).view(torch.uint8).reshape(-1, 2), qs.view(torch.uint8)],
                    dim=1)
    return rec.cpu().numpy().tobytes()


def write_front_gguf(torch, path: Path) -> dict:
    """The front-door checkpoint's weights as a Q8_0 GGUF file with its
    vocabulary: every matrix Q8_0 (Q and K rope-permuted as llama.cpp's
    converter stores them), packed on the card and held to ``llm/gguf.py``'s
    writer on the rows FORMATS_Q8_* name; the norms f32.  Returns sizes,
    seconds and the rows held."""
    from safetensors import safe_open
    from tokenizers import Tokenizer

    from dynamo_tpu_torch.llm import gguf

    t0 = time.perf_counter()
    cfg = llama3_8b(FRONT_LAYERS)
    index = json.loads((FRONT_DIR / "model.safetensors.index.json").read_text())["weight_map"]
    # HF name -> llama.cpp name: the GGUF loader's own map
    names = dict(gguf._GGUFStateDict._MAP)
    for i in range(FRONT_LAYERS):
        names.update({f"model.layers.{i}.{k}": f"blk.{i}.{v}"
                      for k, v in gguf._GGUFStateDict._LAYER_MAP.items()})
    tensors, raw, rows_checked = {}, {}, 0
    gen = torch.Generator().manual_seed(FORMATS_Q8_SEED)
    for hf, name in names.items():
        with safe_open(FRONT_DIR / index[hf], framework="pt", device="cuda") as f:
            w = f.get_tensor(hf)
        if w.ndim == 1:
            tensors[name] = w.float().cpu().numpy()
            continue
        heads = cfg.num_heads if "q_proj" in hf else cfg.num_kv_heads if "k_proj" in hf else 0
        if heads:  # llama.cpp's permutation, gguf.permute_qk on the card
            w = w.reshape(heads, 2, w.shape[0] // heads // 2, -1).transpose(1, 2).reshape(w.shape)
        packed = _q8_0_bytes(torch, w)
        raw[name] = (gguf.GGML_Q8_0, tuple(w.shape), packed)
        # the bytes written against the package's writer on the same rows:
        # every row of FORMATS_Q8_WHOLE, FORMATS_Q8_ROWS seeded rows of the rest
        rows = (list(range(w.shape[0])) if name == FORMATS_Q8_WHOLE else
                sorted(torch.randperm(w.shape[0], generator=gen)[:FORMATS_Q8_ROWS].tolist()))
        row_bytes = len(packed) // w.shape[0]
        got = b"".join(packed[i * row_bytes:(i + 1) * row_bytes] for i in rows)
        check(got == gguf._quant_q8_0(w[rows].float().cpu().numpy()),
              f"formats: the card's Q8_0 packing of {name} differs from llm/gguf.py's "
              f"on rows {rows[:8]}")
        rows_checked += len(rows)
    vocab = Tokenizer.from_file(str(FRONT_DIR / "tokenizer.json")).get_vocab(with_added_tokens=True)
    tokens = [t for t, _ in sorted(vocab.items(), key=lambda x: x[1])]
    check(len(tokens) == cfg.vocab_size, f"formats: vocabulary of {len(tokens)} tokens")
    sp = specials()
    meta = {"general.architecture": "llama", "general.name": FORMATS_MODEL,
            "llama.block_count": FRONT_LAYERS, "llama.embedding_length": cfg.hidden_size,
            "llama.feed_forward_length": cfg.intermediate_size,
            "llama.attention.head_count": cfg.num_heads,
            "llama.attention.head_count_kv": cfg.num_kv_heads,
            "llama.rope.freq_base": float(cfg.rope_theta),
            "llama.attention.layer_norm_rms_epsilon": 1e-5,
            "llama.context_length": cfg.max_position_embeddings,
            "llama.vocab_size": cfg.vocab_size, "tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.scores": [0.0] * len(tokens),
            "tokenizer.ggml.bos_token_id": sp["<|begin_of_text|>"],
            "tokenizer.ggml.eos_token_id": sp["<|eot_id|>"]}
    gguf.write_gguf(path, meta, tensors, raw=raw)
    return dict(bytes=path.stat().st_size, seconds=time.perf_counter() - t0,
                q8_rows_checked=rows_checked)


async def _manifest(url: str, name: str) -> dict:
    from dynamo_tpu_torch.llm.model_store import manifest_key
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient

    c = await CoordinatorClient(url).connect()
    try:
        return await c.kv_get(manifest_key(name))
    finally:
        await c.close()


def _formats_engine(args: list[str]):
    from dynamo_tpu_torch.cli import build_local_engine, parse_args

    return build_local_engine(parse_args(["run", "in=http", "out=gpu", "--model-name",
                                          FORMATS_MODEL, *FRONT_FLAGS, *args]))


def _formats_serve(engine, prompt: list[int], tag: str) -> tuple[list[int], dict]:
    """One greedy request of FORMATS_TOKENS tokens, alone, with every
    kernel counter zeroed just before and read just after: (tokens,
    launches)."""
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    toks = _streams(asyncio.run(_serve(engine, [prompt], max_tokens=FORMATS_TOKENS, tag=tag)))[0]
    return toks, {k: fn.launches for k, fn in wrappers.items()}


def formats_phase(torch, card: str) -> dict:
    """The checkpoint formats on the 2-layer Llama-3-8B-width front-door
    checkpoint, in process.  Native: ``quantize`` to an int8 checkpoint,
    its tensors bit-equal to ``--quantize int8``'s load of the directory,
    its load beside that load plus quantisation, and one greedy request
    served from each, equal, launching B5.  GGUF: the weights as a Q8_0
    file written with ``write_gguf``, served through the checkpoint
    dispatch (B1 and B2 launched, no B5), its card logits held to the CPU's
    on the same weights.  Model store, on a thread beside the GGUF checks:
    ``models push`` of the directory to a coordinator on a thread of this
    process, ``dyn://models/front``
    pulled into a fresh cache (every file's sha256 equal to the source's,
    the pull's MB/s), served through ``--model-path dyn://models/front`` as
    the directory serves.  Logs and returns the ``{"formats": ...}`` line."""
    import dataclasses
    import os
    import shutil

    import numpy as np

    from dynamo_tpu_torch import cli
    from dynamo_tpu_torch.llm import model_store
    from dynamo_tpu_torch.models.checkpoint import load_checkpoint
    from dynamo_tpu_torch.models.llama import LlamaModel
    from dynamo_tpu_torch.models.loader import load_model_dir

    t_phase = time.perf_counter()
    shutil.rmtree(FORMATS_DIR, ignore_errors=True)
    FORMATS_DIR.mkdir()
    native = FORMATS_DIR / "native-int8"
    prompt = np.random.default_rng(7).integers(0, LLAMA3_VOCAB - 256, 300).tolist()
    out = dict(label="checkpoint formats: 2-layer Llama-3-8B width", card=card)
    launches = {}

    # native int8 checkpoint
    t0 = time.perf_counter()
    cli.main(["quantize", str(FRONT_DIR), str(native)])
    out["quantize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, nstate, quantized = load_checkpoint(native, device="cuda")
    torch.cuda.synchronize()
    out["native_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, hstate = load_model_dir(FRONT_DIR, device="cuda", quantize=True)
    torch.cuda.synchronize()
    out["hf_load_quantize_s"] = time.perf_counter() - t0
    differ = sorted(k for k in hstate if not (k in nstate and nstate[k].dtype == hstate[k].dtype
                                              and torch.equal(nstate[k], hstate[k])))
    check(quantized and set(nstate) == set(hstate) and not differ,
          f"formats native: tensors {differ[:5]} differ from --quantize int8's")
    out["native_tensors"] = len(nstate)
    out["native_int8_tensors"] = sum(t.dtype == torch.int8 for t in nstate.values())
    out["native_bytes"] = (native / "params.safetensors").stat().st_size
    del nstate, hstate
    torch.cuda.empty_cache()
    streams = {}
    for label, args in (("hf --quantize int8", ["--model-path", str(FRONT_DIR), "--quantize",
                                                "int8"]),
                        ("native int8", ["--model-path", str(native)])):
        engine, _ = _formats_engine(args)
        try:
            streams[label], launches[label] = _formats_serve(engine, prompt, f"formats-{label}")
        finally:
            engine.shutdown()
        gc.collect()
        torch.cuda.empty_cache()
    nl = launches["native int8"]
    check(streams["native int8"] == streams["hf --quantize int8"] and streams["native int8"],
          f"formats native: stream {streams['native int8']} != --quantize int8's "
          f"{streams['hf --quantize int8']}")
    check(nl["matmul"] > 0 and nl["decode"] > 0 and nl["prefill"] > 0
          and not any(v for k, v in nl.items() if k not in ("matmul", "decode", "prefill")),
          f"formats native: launches {nl}, need B5, B1 and B2 and no other")

    def gguf():
        gpath = FORMATS_DIR / "front-q8_0.gguf"
        out["gguf_write"] = write_front_gguf(torch, gpath)
        t0 = time.perf_counter()
        engine, gcard = _formats_engine(["--model-path", str(gpath)])
        out["gguf_load_s"] = time.perf_counter() - t0
        try:
            streams["gguf"], launches["gguf"] = _formats_serve(engine, prompt, "formats-gguf")
            model = engine.core.model
            state = {k: v.float().cpu() for k, v in model.state_dict().items()}
            cfg = dataclasses.replace(model.config, dtype="float32")
            cpu = LlamaModel.from_state(cfg, state)
            rng = np.random.default_rng(1)
            p300, steps = rng.integers(0, cfg.vocab_size, 300).tolist(), rng.integers(
                0, cfg.vocab_size, 8).tolist()
            _hold_card_to_cpu(
                torch, "GGUF Q8_0: 2-layer 8B width, 300-token prompt over a 128-token prefix + "
                "8 decode steps",
                lambda: _forward_logits(torch, model, torch.device("cuda"), p300, steps, 128),
                lambda: _forward_logits(torch, cpu, torch.device("cpu"), p300, steps, 128), card)
            del model, cpu, state
        finally:
            engine.shutdown()
        gc.collect()
        torch.cuda.empty_cache()
        gl = launches["gguf"]
        check(len(streams["gguf"]) > 0 and gl["decode"] > 0 and gl["prefill"] > 0
              and not any(v for k, v in gl.items() if k not in ("decode", "prefill")),
              f"formats GGUF: {len(streams['gguf'])} tokens, launches {gl}, need B1 and B2 only")
        check(gcard.name == FORMATS_MODEL and gcard.eos_token_ids == [specials()["<|eot_id|>"]],
              f"formats GGUF: card {gcard.name} eos {gcard.eos_token_ids}")

    # model store
    src = FORMATS_DIR / "hf"
    src.mkdir()
    index = json.loads((FRONT_DIR / "model.safetensors.index.json").read_text())["weight_map"]
    for name in sorted(set(FORMATS_FILES) | set(index.values())):
        (src / name).symlink_to(FRONT_DIR / name)
    cache = FORMATS_DIR / "cache"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    files = sorted(p.name for p in src.iterdir())
    nbytes = sum((src / f).stat().st_size for f in files)
    pulled = []

    def store(url):
        t0 = time.perf_counter()
        push = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch", "models", "push",
                               FORMATS_MODEL, str(src), "--coordinator", url], cwd=str(ROOT),
                              env=env, capture_output=True, text=True, timeout=300)
        out["push_s"] = time.perf_counter() - t0
        check(push.returncode == 0, f"formats store: models push exited {push.returncode}: "
              f"{push.stderr[-2000:]}")
        t0 = time.perf_counter()
        pulled.append(Path(model_store.resolve_model_sync(f"dyn://models/{FORMATS_MODEL}", url,
                                                          cache_dir=cache)))
        out["pull_s"] = time.perf_counter() - t0
        # the pushed digests: the manifest push_model hashed from the source
        pushed = asyncio.run(_manifest(url, FORMATS_MODEL))["files"]
        same = [model_store.file_sha256(pulled[0] / f) == pushed[f]["sha256"] for f in files]
        check(all(same) and sorted(pushed) == files
              and sorted(p.name for p in pulled[0].iterdir()) == files,
              f"formats store: pushed {sorted(pushed)}, pulled "
              f"{sorted(p.name for p in pulled[0].iterdir())}, digests equal {same}")
        out.update(pushed=push.stdout.strip(), files=len(files), pull_bytes=nbytes,
                   pull_mb_s=nbytes / out["pull_s"] / 1e6)

    with background_coordinator() as url:
        # GGUF beside the push and pull (disk, sockets and hashing, no kernel)
        concurrently(gguf, lambda: store(url))
        pulled = pulled[0]
        # served through the ref: a cache hit, verified against the manifest
        real_cache = model_store.DEFAULT_CACHE
        model_store.DEFAULT_CACHE = cache
        try:
            for label, args in (("directory", ["--model-path", str(FRONT_DIR)]),
                                ("dyn://models/front", ["--model-path",
                                                        f"dyn://models/{FORMATS_MODEL}",
                                                        "--coordinator", url])):
                engine, mcard = _formats_engine(args)
                try:
                    streams[label], launches[label] = _formats_serve(engine, prompt,
                                                                     f"formats-{label}")
                finally:
                    engine.shutdown()
                gc.collect()
                torch.cuda.empty_cache()
            check(mcard.model_path == str(pulled),
                  f"formats store: served from {mcard.model_path}, not the pulled {pulled}")
        finally:
            model_store.DEFAULT_CACHE = real_cache
    check(streams["dyn://models/front"] == streams["directory"] and streams["directory"],
          f"formats store: the pulled copy's stream {streams['dyn://models/front']} != the "
          f"directory's {streams['directory']}")
    out.update(streams={k: len(v) for k, v in streams.items()}, launches=launches,
               launches_total={k: sum(l[k] for l in launches.values()) for k in nl},
               seconds=time.perf_counter() - t_phase)
    log(f"formats: native int8 load {out['native_load_s']:.2f} s vs HF load + quantise "
        f"{out['hf_load_quantize_s']:.2f} s (warm page cache); GGUF Q8_0 "
        f"{out['gguf_write']['bytes'] / 1e9:.2f} GB written in {out['gguf_write']['seconds']:.1f} s, "
        f"loaded in {out['gguf_load_s']:.1f} s; pull {nbytes / 1e9:.2f} GB at "
        f"{out['pull_mb_s']:.0f} MB/s; phase {out['seconds']:.1f} s ({card})")
    shutil.rmtree(FORMATS_DIR, ignore_errors=True)
    return out


# --------------------------------------------------------------------- mesh
# More than one device (slice 20): ONE two-rank world on the one card.  This
# process is rank 0 (the engine); rank 1 is a shard follower process
# (``engine/follower.py``).  NCCL refuses two ranks on one card, so the
# world's backend is gloo (``DYN_MH_BACKEND=gloo``): every all-gather and
# ring step is staged through pinned host buffers, and every collective of
# a CUDA tensor waits for the card.
MESH_BF16_LAYERS = 8      # Llama-3-8B width, bf16: the logits and the decode turn
MESH_Q8_LAYERS = 8        # int8 weights and cache
MESH_MOE_LAYERS = 4       # Qwen3-30B-A3B width
MESH_DS_LAYERS = 4        # DeepSeek-V2-Lite width
MESH_SP_LAYERS = 8        # Llama-3-8B width, the sequence-parallel prefill
MESH_SP_PROMPT = 4096
MESH_SP_THRESHOLD = 2048
MESH_SP_TOKENS = 16
MESH_TIMEOUT_S = 300.0    # a collective's wait for its peers in the mesh phases
# the options a mesh serves beyond the dispatches, Llama-3-8B width (bf16)
MESH_OPT_LAYERS = 2
# (n-gram verifies at decode_steps 1: a turn speculates when any row proposes)
MESH_OPT_PATHS = {"ngram k=4": dict(DEFAULT_PATH, spec_tokens=4, decode_steps=1),
                  "lookahead": BUDGET_PATH}
MESH_TIER_BLOCKS = 128        # an undersized pool: a 640-token prompt is pushed out
MESH_TIER_HOST_BLOCKS = 512
MESH_OPTION_METRICS = ("spec_steps", "spec_proposed", "spec_accepted", "lookahead_bursts_total",
                       "unified_dispatches_total")
# per-rank geometry at tp = 2: Llama-3-8B's (Hq 16, Hk 4) and Qwen3-30B-A3B's
# (Hq 16, Hk 2) attention, D 128
MESH_GEOMS = {"Llama-3-8B": (16, 4, 128), "Qwen3-30B-A3B": (16, 2, 128)}
# Llama-3-8B's matmuls on one rank at tp = 2, [K, N]: q/k/v and gate/up split
# by column, wo and w_down by row, the lm_head over the vocab
MESH_MATMULS = {"wq": (4096, 2048), "wk/wv": (4096, 512), "wo": (2048, 4096),
                "w_gate/w_up": (4096, 7168), "w_down": (7168, 4096), "lm_head": (4096, 64128)}
# the experts' F on one rank: Qwen3-30B-A3B 768 / 2, DeepSeek-V2-Lite 1,408 / 2
MESH_EXPERTS = {"Qwen3-30B-A3B": (128, 8, 2048, 384), "DeepSeek-V2-Lite": (64, 6, 2048, 704)}


def _world_gather(ctx, t):
    """Every rank's ``t``, stacked on the first axis in rank order (the
    model axis gathered first: a rank's index is data * tp + model)."""
    for axis in reversed(ctx.mesh.axis_names):
        if ctx.mesh.axis_size(axis) > 1:
            t = ctx.mesh.all_gather(t, axis, dim=0)
    return t


def mesh_zero_counts(ctx) -> None:
    """Every rank: each kernel wrapper's launch count to 0."""
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def mesh_counts(ctx) -> list:
    """Every rank: its launch counts, gathered (a list in rank order)."""
    import torch

    names = list(_kernel_wrappers())
    mine = torch.tensor([[float(_kernel_wrappers()[n].launches) for n in names]],
                        device=ctx.device)
    return [dict(zip(names, map(int, row))) for row in _world_gather(ctx, mine).tolist()]


def mesh_logits(ctx, prompt: list) -> object:
    """Every rank: one prefill of ``prompt`` over a fresh cache (its slice of
    the model, in step with the other rank); the logits after it."""
    import torch

    return _rescore(torch, ctx.model, prompt, BS, None)


def mesh_blocks(ctx, block_ids: list) -> object:
    """Every rank: its cache's ``block_ids`` ([L, n, 2, Bs, Hk*D]), the
    ranks' gathered on the first axis."""
    from dynamo_tpu_torch.ops.block_copy import gather_blocks

    return _world_gather(ctx, gather_blocks(ctx.cache, block_ids)).float().cpu()


class MeshWorld:
    """This process as rank 0 of a world of ``n`` ranks on the card(s) and
    the follower processes it starts (rank r on ``cuda:{r % cards}``), laid
    out as the mesh ``shape``; ``backend`` None is NCCL, one rank a card.
    :meth:`close` stops it."""

    def __init__(self, n: int = 2, backend="gloo", shape=(1, 2)):
        import os

        from dynamo_tpu_torch.runtime.multihost import MultiHostSpec, bootstrap, free_port
        from dynamo_tpu_torch.utils.mesh import MESH_AXES, build_mesh

        addr = f"127.0.0.1:{free_port()}"
        self.log_path = ROOT / "chiprun_out" / "mesh_follower.log"
        self.log_path.parent.mkdir(exist_ok=True)
        # a collective waits at most MESH_TIMEOUT_S for its peers: a failed
        # check on one rank ends the phase instead of hanging the others
        env = dict(os.environ, DYN_MH_NPROCS=str(n), DYN_MH_STORE=addr,
                   DYN_MH_MESH=",".join(map(str, shape)), DYN_MH_TIMEOUT_S=str(MESH_TIMEOUT_S),
                   PYTHONPATH=str(ROOT))
        if backend:
            env["DYN_MH_BACKEND"] = backend
        with open(self.log_path, "w") as f:
            self.procs = [subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.engine.follower"], cwd=str(ROOT),
                env=dict(env, DYN_MH_RANK=str(r), DYN_MH_LOCAL_RANK=str(r)), stdout=f,
                stderr=subprocess.STDOUT) for r in range(1, n)]
        try:
            self.backend = bootstrap(MultiHostSpec(num_processes=n, process_id=0, store_addr=addr,
                                                   backend=backend, timeout_s=MESH_TIMEOUT_S),
                                     "cuda:0")
            self.mesh = build_mesh(shape, MESH_AXES, device="cuda:0")
        except BaseException:
            for p in self.procs:
                p.kill()
            raise

    def layout(self, shape):
        from dynamo_tpu_torch.engine.follower import remesh

        if tuple(self.mesh.sizes) != tuple(shape):
            self.mesh = remesh(self.mesh, shape)
        return self.mesh

    def close(self) -> int:
        from dynamo_tpu_torch.engine.follower import stop_followers
        from dynamo_tpu_torch.runtime.multihost import shutdown

        try:
            if all(p.poll() is None for p in self.procs):
                stop_followers(self.mesh)
        finally:
            # every rank leaves the world together (NCCL's teardown waits for
            # its peers), then the followers' exits are read
            shutdown()
        try:
            rcs = [p.wait(timeout=60) for p in self.procs]
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            rcs = [p.wait() for p in self.procs]
        return max(rcs, key=abs)


def mesh_kernel_checks(torch, card: str) -> tuple[dict, dict]:
    """Each kernel of the mesh's path against its plain version at the
    shapes one rank gives it (``MESH_GEOMS``, ``MESH_MATMULS``,
    ``MESH_EXPERTS``), pools NaN-poisoned as in the kernel phase; then
    their times at one rank's serving shapes."""
    from dynamo_tpu_torch.ops.kernels.decode_attention import (paged_decode_attention,
                                                               paged_decode_attention_q8)
    from dynamo_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref
    from dynamo_tpu_torch.ops.kernels.prefill_attention import (paged_prefill_attention,
                                                                paged_prefill_attention_q8)
    from dynamo_tpu_torch.ops.kernels.ragged_prefill_attention import (
        ragged_paged_prefill_attention, ragged_paged_prefill_attention_q8)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    errs = {k: 0.0 for k in ("decode", "prefill", "ragged", "decode_q8", "prefill_q8",
                             "ragged_q8", "matmul", "moe")}
    mixed = [0, 1, 17, 100, 333, 1024, 1500, 2048]
    unified = [(n - 1, 1) for n in (1, 17, 100, 333, 1024, 1500, 2047, 64)] + [(0, 300), (256, 200)]
    for model, geom in MESH_GEOMS.items():
        for quant, bs in ((False, BS), (True, BS_Q8)):
            sfx = "_q8" if quant else ""
            errs["decode" + sfx] = max(errs["decode" + sfx], *(
                decode_case(torch, gen, mixed, s, None, geom=geom, bs=bs, quant=quant) for s in (1, 4)))
            errs["prefill" + sfx] = max(errs["prefill" + sfx], prefill_case(
                torch, gen, starts=[0, 256], fresh=[512, 500], s=512, geom=geom, bs=bs, quant=quant))
            errs["ragged" + sfx] = max(errs["ragged" + sfx], ragged_case(
                torch, gen, unified, 16, 6, geom=geom, bs=bs, quant=quant))
        log(f"mesh kernels at one rank's {model} attention {geom}: B1/B4a S=1 and 4, B2/B4b, "
            f"B3/B4c unified layout, bf16 Bs {BS} and int8 Bs {BS_Q8} ({card})")
    for name, (k, n) in MESH_MATMULS.items():
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        wq, scale = _q8_weight(torch, gen, k, n, "kn")
        for m in (1, 8, 300):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            errs["matmul"] = max(errs["matmul"], compare(
                torch, f"mesh matmul {name} [{k}, {n}] M={m}", int8_matmul(x, wq, scale, out_dtype),
                int8_matmul_ref(x, wq, scale, out_dtype)))
        del wq, scale
    log(f"mesh kernels: B5 at one rank's Llama-3-8B matmuls {MESH_MATMULS} (K, N), M 1/8/300: max "
        f"abs err {errs['matmul']:.3g} ({card})")
    errs["moe_q8"] = 0.0
    for model, (experts, top_k, dm, f) in MESH_EXPERTS.items():
        # E2 serves Qwen3-30B-A3B's int8 experts; DeepSeek has no int8 weights
        for quant in (False, True) if model == "Qwen3-30B-A3B" else (False,):
            key = "moe_q8" if quant else "moe"
            kernel, plain = _grouped(quant)
            for t in (8, 1504):
                offsets = moe_offsets(gen, t, experts, top_k, "uniform")
                for a, b in ((dm, f), (f, dm)):
                    w = _expert_stack(torch, gen, experts, a, b, quant)
                    x = torch.randn((t * top_k, a), generator=gen, device="cuda").to(torch.bfloat16)
                    what = f"mesh {key} {model} [{a}, {b}] T={t}"
                    out = kernel(x, w, offsets)
                    check(torch.equal(out, kernel(x, w, offsets)), f"{what}: two launches differ")
                    errs[key] = max(errs[key], compare(torch, what, out, plain(x, w, offsets)))
    log(f"mesh kernels: E1 at one rank's F (Qwen3-30B-A3B 384, DeepSeek-V2-Lite 704) and E2 at "
        f"384, T 8 and 1504: max abs err {errs['moe']:.3g} / {errs['moe_q8']:.3g} ({card})")
    kernel, _ = _grouped(False)

    # one rank's times: B1 one decode layer (8 rows, DECODE_LENS) as a graph;
    # B2 a 1,504-token prefill; B5 one layer's seven projections at M = 8 as a
    # graph; E1 one Qwen3 MoE layer's three launches at T = 8 as a graph
    ms = {}
    h, hk, d = MESH_GEOMS["Llama-3-8B"]
    lens = DECODE_LENS
    n_blocks = sum(-(-n // BS) for n in lens) + 8
    bt = _tables(torch, lens, 2048 // BS, n_blocks, gen, BS)
    cache = _poisoned_cache(torch, gen, n_blocks, bt.cpu(), lens, hk * d, BS)
    q = torch.randn((8, 1, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    sl = _ints(torch, lens)
    q0 = (sl - 1).clamp_min(0)
    ms["B1"] = graph_time_ms([lambda: paged_decode_attention(q, cache, LAYER, bt, sl, q0)], 50)
    s = 1504
    bt2 = _tables(torch, [s], 2048 // BS, 200, gen, BS)
    cache2 = _poisoned_cache(torch, gen, 200, bt2.cpu(), [0], hk * d, BS)
    qp = torch.randn((1, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn((1, s, hk, d), generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn((1, s, hk, d), generator=gen, device="cuda").to(torch.bfloat16)
    args = (qp, kp, vp, cache2, LAYER, bt2, _ints(torch, [s]), _ints(torch, [0]))
    ms["B2"] = cuda_time_ms(lambda i: paged_prefill_attention(*args), 20)
    layer = [("wq", 1), ("wk/wv", 2), ("wo", 1), ("w_gate/w_up", 2), ("w_down", 1)]
    calls = []
    for name, reps in layer:
        k, n = MESH_MATMULS[name]
        wq, scale = _q8_weight(torch, gen, k, n, "kn")
        x = torch.randn((8, k), generator=gen, device="cuda").to(torch.bfloat16)
        calls += [lambda x=x, wq=wq, scale=scale: int8_matmul(x, wq, scale)] * reps
    ms["B5"] = graph_time_ms(calls, 50)
    experts, top_k, dm, f = MESH_EXPERTS["Qwen3-30B-A3B"]
    offsets = moe_offsets(gen, 8, experts, top_k, "uniform")
    wg, wd = (_expert_stack(torch, gen, experts, dm, f, False),
              _expert_stack(torch, gen, experts, f, dm, False))
    xg = torch.randn((8 * top_k, dm), generator=gen, device="cuda").to(torch.bfloat16)
    xd = torch.randn((8 * top_k, f), generator=gen, device="cuda").to(torch.bfloat16)
    ms["E1"] = graph_time_ms([lambda: kernel(xg, wg, offsets), lambda: kernel(xg, wg, offsets),
                              lambda: kernel(xd, wd, offsets)], 50)
    # the int8 and ragged attention kernels at one rank's Llama-3-8B heads:
    # B4a the same decode layer over an int8 cache (Bs 32) as a graph; B4b
    # the int8 prefix hit (start 256, 700 fresh); B3 and B4c one T = 1024
    # mixed dispatch (cuda_timing.RAGGED_MIXED: eight decode rows, a
    # 700-token span over a 256-token prefix and a 300-token span), bf16 Bs
    # 16 and int8 Bs 32 (a 32-slot decode region)
    bt3 = _tables(torch, lens, 2048 // BS_Q8, n_blocks, gen, BS_Q8)
    cache3 = _q8_cache(torch, gen, n_blocks, hk, d, BS_Q8)
    ms["B4a"] = graph_time_ms([lambda: paged_decode_attention_q8(q, cache3, LAYER, bt3, sl, q0)],
                              50)
    start, fresh = SHARED_PREFIX, PROMPT_LENS[-1] - SHARED_PREFIX
    s4 = -(-fresh // BS_Q8) * BS_Q8
    bt4 = _tables(torch, [start + fresh], 2048 // BS_Q8, 64, gen, BS_Q8)
    cache4 = _q8_cache(torch, gen, 64, hk, d, BS_Q8)
    q4, k4, v4 = (torch.randn((1, s4, x, d), generator=gen, device="cuda").to(torch.bfloat16)
                  for x in (h, hk, hk))
    args4 = (q4, k4, v4, cache4, LAYER, bt4, _ints(torch, [start + fresh]), _ints(torch, [start]))
    ms["B4b"] = cuda_time_ms(lambda i: paged_prefill_attention_q8(*args4), 20)
    rows, _ = RAGGED_MIXED
    for key, quant, bs, region in (("B3", False, BS, 16), ("B4c", True, BS_Q8, BS_Q8)):
        t, starts, seq_lens, offs = ragged_layout(rows, region, 0, bs)
        nb = sum(-(-n // bs) for n in seq_lens) + 8
        bt5 = _tables(torch, seq_lens, 2048 // bs, nb, gen, bs)
        cache5 = _attention_cache(torch, gen, nb, bt5, starts, hk, d, bs, quant)
        q5, k5, v5 = (torch.randn((1, t, x, d), generator=gen, device="cuda").to(torch.bfloat16)
                      for x in (h, hk, hk))
        args5 = (q5, k5, v5, cache5, LAYER, bt5, _ints(torch, seq_lens), _ints(torch, starts),
                 _ints(torch, offs))
        kernel5 = ragged_paged_prefill_attention_q8 if quant else ragged_paged_prefill_attention
        ms[key] = cuda_time_ms(lambda i: kernel5(*args5), 20)
        del cache5
    log(f"mesh kernels, one rank's times (ms): B1 one decode layer (8 rows) graph {ms['B1']:.4f}, "
        f"B4a the same over int8 Bs {BS_Q8} graph {ms['B4a']:.4f}, B2 1,504-token prefill "
        f"{ms['B2']:.4f}, B4b int8 prefix hit (start {start}, {fresh} fresh) {ms['B4b']:.4f}, B3 "
        f"T=1024 mixed dispatch {ms['B3']:.4f}, B4c the same int8 {ms['B4c']:.4f}, B5 one layer's "
        f"7 projections at M=8 graph {ms['B5']:.4f}, E1 one Qwen3 MoE layer at T=8 graph "
        f"{ms['E1']:.4f} ({card})")
    del cache, cache2, cache3, cache4, wg, wd
    torch.cuda.empty_cache()
    return errs, ms


def mesh_run(torch, mesh, model, config: dict, label: str, reqs: list, card: str,
             max_tokens: int = MAX_TOKENS, shard: bool = False) -> dict:
    """The requests at once through an ``EngineCore`` on ``model`` (on
    ``mesh``, rank 0's, or one card's when None), stepped here so each
    step's wall is read: greedy streams, every rank's launches (zeroed just
    before), the seconds of a decode turn (the pure decode dispatches' walls
    over their turns) and the collective wait of one.  With ``shard`` (on a
    mesh) also rank 0's collectives in each pure decode dispatch
    (``shardcheck.counted_collectives``) and every rank's resident bytes of
    params and cache, for the ``shard`` line."""
    import copy

    from dynamo_tpu_torch.analysis.shardcheck import counted_collectives
    from dynamo_tpu_torch.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.follower import call_all
    from dynamo_tpu_torch.engine.request import EngineRequest
    from dynamo_tpu_torch.llm.protocols import FinishReason, SamplingOptions, StopConditions

    core = EngineCore(model, EngineConfig(**config), device="cuda")

    def submit(tag, prompts, n):
        outs = {i: [] for i in range(len(prompts))}
        for i, p in enumerate(prompts):
            core.submit(EngineRequest(request_id=f"{tag}-{i}", prompt=list(p),
                                      sampling=SamplingOptions(temperature=0.0),
                                      stops=StopConditions(max_tokens=n), emit=outs[i].append))
        return outs

    try:
        submit("warm-up", [list(range(1, 40))], 4)
        while core.step():
            pass
        if mesh is not None:
            call_all(mesh, "chip_smoke:mesh_zero_counts")
        else:
            mesh_zero_counts(None)
        outs = submit(label, reqs, max_tokens)
        decode_s = wait_s = 0.0
        turns, steps0, sp0 = 0, core.steps, core.sp_prefills
        decode_collectives = []
        counting = (counted_collectives(mesh) if shard and mesh is not None
                    else contextlib.nullcontext({}))
        t0 = time.perf_counter()
        with counting as counts:
            while True:
                d0, p0 = core.decode_steps, core.prefill_steps
                w0 = mesh.wait_s if mesh is not None else 0.0
                c0 = copy.deepcopy(counts)
                s0 = time.perf_counter()
                if not core.step():
                    break
                if core.prefill_steps == p0 and core.decode_steps > d0:
                    decode_s += time.perf_counter() - s0
                    turns += core.decode_steps - d0
                    wait_s += (mesh.wait_s - w0) if mesh is not None else 0.0
                    if shard:
                        decode_collectives.append(dict(turns=core.decode_steps - d0, counts={
                            k: {f: v[f] - c0.get(k, {}).get(f, 0) for f in v}
                            for k, v in counts.items()
                            if v["count"] > c0.get(k, {}).get("count", 0)}))
        wall = time.perf_counter() - t0
        resident = (call_all(mesh, "dynamo_tpu_torch.analysis.shardcheck:gathered_resident_bytes",
                             model=model, cache=core.cache) if shard and mesh is not None else None)
        launches = (call_all(mesh, "chip_smoke:mesh_counts") if mesh is not None
                    else [{k: fn.launches for k, fn in _kernel_wrappers().items()}])
        dispatches, sp = core.steps - steps0, core.sp_prefills - sp0
        metrics = {k: v for k, v in core.metrics().items() if k in MESH_OPTION_METRICS}
    finally:
        core.close()
    streams = []
    for i in range(len(reqs)):
        toks = [t for o in outs[i] for t in o.token_ids]
        check(outs[i][-1].finish_reason is FinishReason.LENGTH and len(toks) == max_tokens
              and all(0 <= t < model.config.vocab_size for t in toks),
              f"mesh {label} request {i}: {len(toks)} tokens, finish {outs[i][-1].finish_reason}")
        streams.append(toks)
    out = dict(label=label, streams=streams, launches=launches, wall_s=wall, dispatches=dispatches,
               decode_turns=turns, decode_s_per_turn=decode_s / max(1, turns),
               collective_wait_s_per_turn=wait_s / max(1, turns), sp_prefills=sp, metrics=metrics,
               decode_dispatch_collectives=decode_collectives, resident=resident)
    log(f"mesh {label}: wall {wall:.3f} s, {dispatches} dispatches, a decode turn "
        f"{1e3 * out['decode_s_per_turn']:.2f} ms (collective wait "
        f"{1e3 * out['collective_wait_s_per_turn']:.2f} ms) over {turns} turns, launches "
        f"{launches} ({card})")
    return out


def mesh_tier_run(torch, mesh, model, label: str, card: str) -> dict:
    """The KV tiers on ``model`` (rank 0's on ``mesh``, or one card's when
    None), over an undersized device pool (``MESH_TIER_BLOCKS``): a 640-token
    prompt served cold, pushed out by two longer ones, served again from the
    host pool, then served by a restarted engine from the persist directory
    alone.  Every rank's launches (zeroed first), rank 0's restored blocks
    and the three streams."""
    import shutil

    from dynamo_tpu_torch.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.follower import call_all
    from dynamo_tpu_torch.engine.request import EngineRequest
    from dynamo_tpu_torch.llm.protocols import SamplingOptions, StopConditions

    persist = PERSIST_DIR / ("mesh" if mesh is not None else "one")
    shutil.rmtree(persist, ignore_errors=True)
    config = dict(DEFAULT_PATH, num_blocks=MESH_TIER_BLOCKS, num_host_blocks=MESH_TIER_HOST_BLOCKS,
                  kv_persist_dir=str(persist))
    ps = model_prompts(model)
    target, churn = ps[2], [ps[3], ps[5]]

    def serve(core, tag, prompt):
        outs = []
        req = EngineRequest(request_id=tag, prompt=list(prompt),
                            sampling=SamplingOptions(temperature=0.0),
                            stops=StopConditions(max_tokens=MAX_TOKENS), emit=outs.append)
        core.submit(req)
        while core.step():
            pass
        toks = [t for o in outs for t in o.token_ids]
        check(len(toks) == MAX_TOKENS, f"mesh tiers {label} {tag}: {len(toks)} tokens")
        return toks, req.cached_tokens

    if mesh is not None:
        call_all(mesh, "chip_smoke:mesh_zero_counts")
    else:
        mesh_zero_counts(None)
    t0 = time.perf_counter()
    core = EngineCore(model, EngineConfig(**config), device="cuda")
    try:
        cold, _ = serve(core, "cold", target)
        for i, p in enumerate(churn):
            serve(core, f"churn{i}", p)
        core.flush_host_offload()
        host, host_cached = serve(core, "host", target)
        stats = dict(core.tier_stats)
    finally:
        core.close()
    core = EngineCore(model, EngineConfig(**config), device="cuda")
    try:
        check(core.host_pool.stored_blocks == 0, f"mesh tiers {label}: the restart's pool is warm")
        disk, disk_cached = serve(core, "disk", target)
        persist_hits = core.metrics()["persist_hits"]
        disk_restored = core.tier_stats["restore_blocks"]
    finally:
        core.close()
    wall = time.perf_counter() - t0
    launches = (call_all(mesh, "chip_smoke:mesh_counts") if mesh is not None
                else [{k: fn.launches for k, fn in _kernel_wrappers().items()}])
    shutil.rmtree(persist, ignore_errors=True)
    check(stats["restore_blocks"] > 0 and host_cached > 0 and disk_cached > 0 and persist_hits > 0,
          f"mesh tiers {label}: host restore {stats['restore_blocks']} blocks ({host_cached} "
          f"cached tokens), disk {persist_hits} hits ({disk_cached} cached tokens)")
    out = dict(label=label, streams=[cold, host, disk], launches=launches, wall_s=wall,
               restore_blocks=stats["restore_blocks"], offload_blocks=stats["offload_blocks"],
               host_cached_tokens=host_cached, disk_cached_tokens=disk_cached,
               disk_restore_blocks=disk_restored, persist_hits=persist_hits)
    log(f"mesh tiers {label}: {MESH_TIER_BLOCKS}-block pool, {stats['offload_blocks']} blocks "
        f"offloaded, {stats['restore_blocks']} restored from the host ({host_cached} cached tokens), "
        f"{disk_restored} from disk after a restart ({disk_cached} cached tokens, {persist_hits} "
        f"persist hits); wall {wall:.2f} s; launches {launches} ({card})")
    return out


def mesh_options_run(torch, world, card: str) -> dict:
    """The options a mesh serves beyond the dispatches, at Llama-3-8B width
    (``MESH_OPT_LAYERS`` layers, bf16) on one card and at tp = 2: n-gram
    speculation (k = 4) on the spec phase's copy-task prompts, lookahead
    bursts on the token-budget path, and the KV tiers (:func:`mesh_tier_run`).
    Every tp = 2 stream is held to one card's but at a near tie."""
    from dynamo_tpu_torch.engine.follower import broadcast_model, free_followers
    from dynamo_tpu_torch.models.loader import model_from_spec

    spec = {"kind": "init", "family": "llama", "seed": 5,
            "config": dataclasses.asdict(llama3_8b(MESH_OPT_LAYERS))}
    out = {}
    for name, config in MESH_OPT_PATHS.items():
        reqs = spec_prompts() if config.get("spec_tokens") else None
        one, two = _mesh_pair(torch, world, spec, config,
                              f"Llama-3-8B {MESH_OPT_LAYERS} layers {name}", card, reqs=reqs)
        out[name], out[f"{name} tp=1"] = two[(1, 2)], one
    check(out["ngram k=4"]["metrics"]["spec_steps"] > 0
          and out["lookahead"]["metrics"]["lookahead_bursts_total"] > 0,
          f"mesh options: no verify or no burst at tp=2: "
          f"{ {k: r['metrics'] for k, r in out.items()} }")
    mesh = world.layout((1, 2))
    full = model_from_spec(spec, "cuda", None)
    one = mesh_tier_run(torch, None, full, "tp=1", card)
    sharded = broadcast_model(spec, mesh, "cuda")
    two = mesh_tier_run(torch, mesh, sharded, "tp=2", card)
    target = model_prompts(full)[2]
    two["parted"] = spec_near_ties(torch, full, one, two, card, prompts=[target] * 3,
                                   sampling=[{"temperature": 0.0}] * 3, against="tiers tp=1")
    out["tiers"], out["tiers tp=1"] = two, one
    del sharded, full
    free_followers(mesh)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cache_dtype_refusal(torch, card: str) -> None:
    """A18 on the card: an engine asked for a float KV cache dtype that no
    attention kernel takes (fp16 under a bf16 model) is refused at
    construction, by name and "no kernel"; an int8 cache is not."""
    from dynamo_tpu_torch.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.llama import LlamaModel

    model = LlamaModel(ModelConfig.tiny(dtype="bfloat16"), device="cuda")
    try:
        EngineCore(model, EngineConfig(max_model_len=64, num_blocks=8, cache_dtype="float16"),
                   device="cuda")
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "float16" in refused and "no kernel" in refused,
          f"A18: a float16 cache on cuda was not refused by name: {refused}")
    EngineCore(model, EngineConfig(max_model_len=64, num_blocks=8, cache_dtype="int8"),
               device="cuda").close()
    log(f"A18: a float16 KV cache under a bf16 model refused on the card at construction: "
        f"{refused!r}; an int8 cache accepted ({card})")


def _mesh_pair(torch, world, spec: dict, config: dict, label: str, card: str, reqs=None,
               bs: int = BS, cache_dtype=None, logits: bool = False,
               shapes=((1, 2),), shard: bool = False) -> tuple[dict, dict]:
    """One model on one card (tp = 1) and on the world's meshes ``shapes``:
    the same requests through each, every mesh's streams held to tp = 1's
    but at a near tie (re-scored on the tp = 1 model), and with ``logits``
    the first token's logits of the 300-token prompt within the parity
    bounds.  Returns (the tp = 1 run, {mesh shape: its run})."""
    from dynamo_tpu_torch.engine.follower import broadcast_model, call_all, free_followers
    from dynamo_tpu_torch.models.loader import model_from_spec

    full = model_from_spec(spec, "cuda", None)
    reqs = reqs or model_prompts(full)
    one = mesh_run(torch, None, full, config, f"{label} tp=1", reqs, card)
    runs = {}
    for shape in shapes:
        mesh = world.layout(shape)
        name = f"{label} mesh {shape}"
        sharded = broadcast_model(spec, mesh, "cuda")
        check(sharded.mesh is mesh, f"mesh {name}: the model is not on the mesh")
        if logits:
            a = call_all(mesh, "chip_smoke:mesh_logits", reqs[1], model=sharded)
            b = _rescore(torch, full, reqs[1], BS, None)
            _hold_logits(torch, f"mesh {name} first token (300-token prompt), vs tp=1",
                         a[None], b[None], card)
        run = mesh_run(torch, mesh, sharded, config, name, reqs, card, shard=shard)
        run["parted"] = spec_near_ties(torch, full, one, run, card, bs=bs,
                                       cache_dtype=cache_dtype, prompts=reqs,
                                       sampling=[{"temperature": 0.0}] * len(reqs),
                                       against=f"{label} tp=1")
        runs[shape] = run
        del sharded
        free_followers(mesh)
        gc.collect()
        torch.cuda.empty_cache()
    del full
    gc.collect()
    torch.cuda.empty_cache()
    return one, runs


def mesh_sp_run(torch, world, card: str, shape=(2, 1)) -> dict:
    """The sequence-parallel prefill on the mesh ``shape``: a 4,096-token prompt
    over ``sp_prefill_threshold`` 2,048 prefills in ONE dispatch with the
    sequence split over "data" (ring attention), the fresh KV all-gathered
    into both ranks' caches; each rank's blocks are held to a tp = 1
    prefill's (per layer, within the parity bounds) and to each other's (the
    same bits), and the run goes on for 16 decode tokens, held to tp = 1's
    but at a near tie (re-scored on the tp = 1 model)."""
    import numpy as np

    from dynamo_tpu_torch.engine import EngineConfig, EngineCore
    from dynamo_tpu_torch.engine.follower import broadcast_model, call_all, free_followers
    from dynamo_tpu_torch.engine.request import EngineRequest, RequestState
    from dynamo_tpu_torch.llm.protocols import SamplingOptions, StopConditions
    from dynamo_tpu_torch.models.loader import model_from_spec
    from dynamo_tpu_torch.ops.block_copy import gather_blocks

    mesh = world.layout(shape)
    spec = {"kind": "init", "family": "llama", "seed": 3,
            "config": dataclasses.asdict(llama3_8b(MESH_SP_LAYERS))}
    prompt = np.random.default_rng(7).integers(0, LLAMA3_VOCAB, MESH_SP_PROMPT).tolist()
    nb = MESH_SP_PROMPT // BS
    cfg = dict(max_batch_size=2, max_model_len=8192, block_size=BS, num_blocks=nb + 64,
               decode_steps=8)

    def serve(core, label):
        outs = []
        req = EngineRequest(request_id=label, prompt=prompt, sampling=SamplingOptions(temperature=0.0),
                            stops=StopConditions(max_tokens=MESH_SP_TOKENS), emit=outs.append)
        core.submit(req)
        t0 = time.perf_counter()
        while req.state is not RequestState.RUNNING:
            check(core.step(), f"mesh SP {label}: the engine idled before the prefill")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        ids = list(req.block_ids[:nb])
        blocks = (call_all(mesh, "chip_smoke:mesh_blocks", ids, cache=core.cache)
                  if core.mesh is not None else gather_blocks(core.cache, ids).float().cpu())
        while core.step():
            pass
        core.close()
        return [t for o in outs for t in o.token_ids], blocks, prefill_s

    full = model_from_spec(spec, "cuda", None)
    ref_toks, ref, ref_s = serve(EngineCore(full, EngineConfig(**cfg), device="cuda"), "sp-ref")
    gc.collect()
    torch.cuda.empty_cache()
    sharded = broadcast_model(spec, mesh, "cuda")
    call_all(mesh, "chip_smoke:mesh_zero_counts")
    w0 = mesh.wait_s
    core = EngineCore(sharded, EngineConfig(**cfg, sp_prefill_threshold=MESH_SP_THRESHOLD),
                      device="cuda")
    toks, got, sp_s = serve(core, "sp")
    launches = call_all(mesh, "chip_smoke:mesh_counts")
    check(core.sp_prefills == 1 and len(toks) == MESH_SP_TOKENS,
          f"mesh SP: {core.sp_prefills} SP prefills, {len(toks)} tokens")
    layers = ref.shape[0]
    check(all(torch.equal(got[:layers], got[r * layers:(r + 1) * layers])
              for r in range(1, got.shape[0] // layers)), "mesh SP: the ranks' cached KV differ")
    rel = [((got[i] - ref[i]).norm() / ref[i].norm()).item() for i in range(layers)]
    max_rel = [((got[i] - ref[i]).abs().max() / ref[i].abs().max()).item() for i in range(layers)]
    log(f"mesh SP {shape}: {MESH_SP_PROMPT}-token prompt, {MESH_SP_LAYERS} layers: SP prefill "
        f"{sp_s:.3f} s (tp=1 one-dispatch prefill {ref_s:.3f} s); every rank's cached KV bit-equal; vs tp=1 per "
        f"layer rel L2 {max(rel):.3g} (tol {PARITY_REL_L2}; by layer {[round(r, 5) for r in rel]}), "
        f"max |diff|/max {max(max_rel):.3g} (tol {PARITY_MAX_REL}); first token {toks[0]} vs tp=1 "
        f"{ref_toks[0]}; collective wait {mesh.wait_s - w0:.3f} s ({card})")
    check(max(rel) <= PARITY_REL_L2 and max(max_rel) <= PARITY_MAX_REL,
          f"mesh SP: cached KV vs tp=1: rel L2 {max(rel)}, max rel {max(max_rel)}")
    parted = spec_near_ties(torch, full, dict(streams=[ref_toks]),
                            dict(streams=[toks], label=f"mesh SP {shape}"), card, prompts=[prompt],
                            sampling=[{"temperature": 0.0}], against="tp=1")
    del sharded, core, full
    free_followers(mesh)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prompt=MESH_SP_PROMPT, layers=MESH_SP_LAYERS, sp_prefill_s=sp_s,
                tp1_prefill_s=ref_s, kv_rel_l2=max(rel), kv_rel_l2_by_layer=rel,
                kv_max_rel=max(max_rel), parted=parted, launches=launches)


def mesh_nccl_refusal(card: str) -> None:
    """Two ranks on the one card with the default backend (NCCL on CUDA):
    both follower processes must stop in the bootstrap, naming the card,
    before NCCL is asked; nothing gives way to gloo by itself."""
    import os

    from dynamo_tpu_torch.runtime.multihost import free_port

    env = dict(os.environ, DYN_MH_NPROCS="2", DYN_MH_STORE=f"127.0.0.1:{free_port()}",
               DYN_MH_MESH="1,2", PYTHONPATH=str(ROOT))
    env.pop("DYN_MH_BACKEND", None)
    procs = [subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.engine.follower"],
                              cwd=str(ROOT), env=dict(env, DYN_MH_RANK=str(r), DYN_MH_LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    refused = ["NCCL refuses two ranks on one card" in o for o in outs]
    check(all(p.returncode != 0 for p in procs) and any(refused),
          f"mesh: NCCL asked for two ranks on one card: exit codes "
          f"{[p.returncode for p in procs]}: {outs[0][-1500:]} {outs[1][-1500:]}")
    log(f"mesh: NCCL for two ranks on one card refused by the bootstrap, exit codes "
        f"{[p.returncode for p in procs]}, the refusal in {sum(refused)} of 2 logs ({card})")


def mesh_phase(torch, card: str, census: dict) -> dict:
    """The mesh phase: the kernels at one rank's shapes, NCCL refused for two
    ranks on one card, then ONE two-rank gloo world: Llama-3-8B bf16 at full
    width, MESH_BF16_LAYERS layers (logits and streams against tp = 1), int8 weights and
    cache (the default path at 8 layers, the token-budget path at 2),
    Qwen3-30B-A3B width (4 layers),
    DeepSeek-V2-Lite width (4 layers), the sequence-parallel prefill on (2,
    1), and the options a mesh serves beyond the dispatches
    (:func:`mesh_options_run`: n-gram speculation, lookahead bursts, the KV
    tiers).  Rank 1 must launch what rank 0 does, B1, B2, B3, B4a, B4c, B5
    and E1 among them.  The bf16 pair's tp = 2 run also gives the
    ``{"shard": ...}`` line against ``census`` (:func:`shard_line`).
    Logs the ``{"mesh": ...}`` line."""
    t_phase = time.perf_counter()
    errs, kernel_ms = mesh_kernel_checks(torch, card)
    cache_dtype_refusal(torch, card)
    worlds = []
    try:  # the NCCL refusal's two processes boot beside the gloo world's follower
        concurrently(lambda: worlds.append(MeshWorld()), lambda: mesh_nccl_refusal(card))
    except BaseException:
        for w in worlds:
            w.close()
        raise
    world = worlds[0]
    runs, sp = {}, None
    tp2 = (1, 2)
    try:
        llama = {"kind": "init", "family": "llama", "seed": 0,
                 "config": dataclasses.asdict(llama3_8b(MESH_BF16_LAYERS))}
        one, two = _mesh_pair(torch, world, llama, DEFAULT_PATH,
                              f"Llama-3-8B bf16 {MESH_BF16_LAYERS} layers", card,
                              logits=True, shard=True)
        runs["bf16 tp=1"], runs["bf16"] = one, two[tp2]
        shard = shard_line(runs["bf16"], census, card)
        # int8 weights and cache: the default path at MESH_Q8_LAYERS, the
        # token-budget path (B4c on the rank's scale tiles, lookahead bursts
        # on) at MESH_OPT_LAYERS, which costs seconds
        for path, cfg, layers in (("default", INT8_DEFAULT_PATH, MESH_Q8_LAYERS),
                                  ("token budget", INT8_BUDGET_PATH, MESH_OPT_LAYERS)):
            q8 = {"kind": "init", "family": "llama", "seed": 1, "quantized": True,
                  "config": dataclasses.asdict(llama3_8b(layers))}
            one, two = _mesh_pair(torch, world, q8, cfg,
                                  f"Llama-3-8B int8 {layers} layers {path}", card,
                                  bs=BS_Q8, cache_dtype="int8")
            runs[f"int8 {path} tp=1"], runs[f"int8 {path}"] = one, two[tp2]
        moe = {"kind": "init", "family": "llama", "seed": 2,
               "config": dataclasses.asdict(qwen3_30b_a3b(MESH_MOE_LAYERS))}
        one, two = _mesh_pair(torch, world, moe, DEFAULT_PATH,
                              f"Qwen3-30B-A3B {MESH_MOE_LAYERS} layers", card)
        runs["Qwen3 tp=1"], runs["Qwen3"] = one, two[tp2]
        ds = {"kind": "init", "family": "deepseek", "seed": 4,
              "config": dataclasses.asdict(deepseek_v2_lite(MESH_DS_LAYERS))}
        one, two = _mesh_pair(torch, world, ds, DEFAULT_PATH,
                              f"DeepSeek-V2-Lite {MESH_DS_LAYERS} layers", card)
        runs["DeepSeek tp=1"], runs["DeepSeek"] = one, two[tp2]
        options = mesh_options_run(torch, world, card)
        runs.update(options)
        sp = mesh_sp_run(torch, world, card)
    finally:
        rc = world.close()
    check(rc == 0, f"mesh: a follower exited {rc}: " + world.log_path.read_text()[-3000:])
    tp2_runs = {k: r for k, r in runs.items() if "tp=1" not in k}
    per_rank = [{k: sum(r["launches"][rank][k] for r in tp2_runs.values())
                 + sp["launches"][rank][k] for k in _kernel_wrappers()} for rank in (0, 1)]
    check(all(per_rank[1][k] > 0 for k in ("decode", "prefill", "matmul", "ragged", "decode_q8",
                                            "ragged_q8", "moe"))
          and per_rank[1] == per_rank[0],
          f"mesh: rank 1 must launch what rank 0 launches, B1, B2, B5, B3, B4a, B4c and E1 among "
          f"them: {per_rank}")
    line = dict(
        backend=world.backend, world=2, meshes=["(1, 2)", "(2, 1)"],
        launches_rank0=per_rank[0], launches_rank1=per_rank[1],
        decode_turn_s={"tp1": runs["bf16 tp=1"]["decode_s_per_turn"],
                       "tp2": runs["bf16"]["decode_s_per_turn"]},
        collective_wait_s_per_turn=runs["bf16"]["collective_wait_s_per_turn"],
        runs={k: _run_readings(r) for k, r in runs.items()},
        options={k: dict(launches=r["launches"], parted=r.get("parted"),
                         **{f: r[f] for f in ("metrics", "decode_s_per_turn", "restore_blocks",
                                              "disk_restore_blocks", "persist_hits") if f in r})
                 for k, r in options.items()},
        sp={k: v for k, v in sp.items() if k != "launches"},
        kernel_max_abs_err=errs, kernel_ms_one_rank=kernel_ms,
        seconds=time.perf_counter() - t_phase, card=card)
    log(json.dumps({"mesh": line}))
    return dict(line, per_rank=per_rank, errs=errs, shard=shard)


def _run_readings(r: dict) -> dict:
    return {f: r.get(f) for f in ("wall_s", "dispatches", "decode_turns", "decode_s_per_turn",
                                  "collective_wait_s_per_turn", "parted")}


def mesh_allreduce(ctx, nbytes: int, iters: int) -> float:
    """Every rank: the mean seconds of one all-reduce of ``nbytes`` of f32
    over the "model" axis, by CUDA events over ``iters`` calls."""
    import torch

    from dynamo_tpu_torch.utils.mesh import AXIS_MODEL

    x = torch.ones(nbytes // 4, device=ctx.device)
    for _ in range(3):
        ctx.mesh.all_reduce(x, AXIS_MODEL)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        ctx.mesh.all_reduce(x, AXIS_MODEL)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters / 1e3


def mesh_cards_phase(torch, card: str) -> dict:
    """``chip_smoke.py --mesh-cards``: ONE world of a rank a card over NCCL,
    every card of the machine (4): an all-reduce's time over the model axis
    beside ``obs/topology.py``'s NVLink price; Llama-3-8B bf16 at full width
    and depth on the meshes (1, n) and (2, n / 2) against one card (logits,
    near-tie streams, a decode turn and its collective wait); the
    sequence-parallel prefill on (n, 1).  Logs the ``{"mesh_cards": ...}``
    line."""
    from dynamo_tpu_torch.engine.follower import call_all
    from dynamo_tpu_torch.obs.topology import collective_cost_s

    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    check(n >= 2 and n % 2 == 0, f"mesh cards: {n} cards, need an even number above 1")
    world = MeshWorld(n=n, backend=None, shape=(1, n))
    try:
        check(world.backend == "nccl", f"mesh cards: backend {world.backend}, expected nccl")
        ar = {}
        for nbytes in (4096 * 4 * 6, 64 << 20):  # a decode step's partials; 64 MiB
            got = call_all(world.mesh, "chip_smoke:mesh_allreduce", nbytes, 50)
            ar[nbytes] = dict(measured_s=got, nvlink_priced_s=collective_cost_s(
                "all_reduce", n, nbytes, link="nvlink"))
            log(f"mesh cards: all-reduce of {nbytes} bytes over {n} cards (NCCL): "
                f"{1e6 * got:.1f} us, NVLink-priced {1e6 * ar[nbytes]['nvlink_priced_s']:.1f} us "
                f"({card})")
        llama = {"kind": "init", "family": "llama", "seed": 0,
                 "config": dataclasses.asdict(llama3_8b())}
        shapes = ((1, n), (2, n // 2))
        one, many = _mesh_pair(torch, world, llama, DEFAULT_PATH, "Llama-3-8B bf16", card,
                               logits=True, shapes=shapes)
        sp = mesh_sp_run(torch, world, card, shape=(n, 1))
    finally:
        rc = world.close()
    check(rc == 0, f"mesh cards: a follower exited {rc}: " + world.log_path.read_text()[-3000:])
    line = dict(backend="nccl", world=n, all_reduce={str(k): v for k, v in ar.items()},
                runs={"tp=1": _run_readings(one),
                      **{str(shape): _run_readings(r) for shape, r in many.items()}},
                launches={str(shape): r["launches"] for shape, r in many.items()},
                sp={k: v for k, v in sp.items() if k != "launches"},
                seconds=time.perf_counter() - t_phase, card=card)
    log(json.dumps({"mesh_cards": line}))
    return line


def mesh_cli_phase(torch, card: str, texts: list[str], ids: list[tuple[list, list]]) -> dict:
    """``run in=http out=gpu --tp 2`` on the front-door checkpoint as a user
    starts it on one card (``DYN_MH_BACKEND=gloo``): ``run`` is rank 0 and
    starts rank 1, each loads its half of the checkpoint, and the front-door
    requests are answered one at a time over HTTP; SIGTERM stops both ranks
    with exit 0.  Each answer is held to the one-card answer ``texts`` (its
    prompt and output ids in ``ids``) but at a near tie: two ranks round the
    row-parallel sums differently, so where an answer parts, the common
    prefix is re-scored on the checkpoint loaded on one card."""
    import os
    import socket

    import aiohttp

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    log_path = FRONT_DIR / "cli_tp2.log"
    env = dict(os.environ, DYN_MH_BACKEND="gloo")
    with served_process("the --tp 2 CLI server", [
            "run", "in=http", "out=gpu", "--model-path", str(FRONT_DIR), "--model-name",
            FRONT_MODEL, "--http-port", str(port), "--tp", "2", *FRONT_FLAGS], log_path,
            env=env, grace_s=60) as server:
        async def go():
            async with aiohttp.ClientSession() as s:
                while True:
                    try:
                        async with s.get(f"{base}/health") as r:
                            await r.json()
                        break
                    except aiohttp.ClientConnectionError:
                        server.alive("did not come up", t0)
                        await asyncio.sleep(0.25)
                up = time.perf_counter() - t0
                return up, [await _timed_post(s, base + path, body)
                            for path, body in _front_requests()]

        up, answers = asyncio.run(go())
        served_log = log_path.read_text()
    check(all(a[0] == 200 for a in answers) and all(_answer_text(a[1]) for a in answers),
          f"mesh CLI --tp 2: statuses {[a[0] for a in answers]}: {served_log[-3000:]}")
    check("1 followers started here" in served_log and "(gloo)" in served_log,
          f"mesh CLI --tp 2: no follower rank in the log: {served_log[-3000:]}")
    got = [_answer_text(a[1]) for a in answers]
    same = sum(a == b for a, b in zip(got, texts))
    parted = 0
    if same < len(got):
        from dynamo_tpu_torch.cli import load_any_checkpoint
        from dynamo_tpu_torch.llm.tokenizer import TokenizerWrapper

        model, _ = load_any_checkpoint(str(FRONT_DIR), None, torch.device("cuda"), False)
        tok = TokenizerWrapper.from_file(FRONT_DIR)
        try:
            parted = spec_near_ties(
                torch, model, dict(streams=[o for _, o in ids]),
                dict(streams=[graph_stream(t, o, tok) for t, (_, o) in zip(got, ids)],
                     label="mesh CLI --tp 2"),
                card, prompts=[p for p, _ in ids], sampling=[{"temperature": 0.0}] * len(ids),
                against="one card")
        finally:
            del model
            gc.collect()
            torch.cuda.empty_cache()
    out = dict(answered=len(answers), equal_to_tp1=same, parted_at_near_ties=parted, up_s=up,
               ttft_s=[round(a[2], 4) for a in answers])
    log(f"mesh CLI: run --tp 2 in=http on the {FRONT_LAYERS}-layer checkpoint: up in {up:.1f} s, "
        f"{len(answers)} answers over HTTP, {same} equal the one-card texts, {parted} part at a "
        f"near tie, seconds to first text {out['ttft_s']}, both ranks stopped on SIGTERM ({card})")
    log_path.unlink(missing_ok=True)
    return out


# --------------------------------------------------------------------- main
def phase_clock():
    """A function that logs, under a phase's name, the seconds since its
    last call and since the clock was made: where the run's time goes."""
    start = last = time.perf_counter()

    def mark(name: str) -> None:
        nonlocal last
        now = time.perf_counter()
        log(f"phase {name}: {now - last:.1f} s (run {now - start:.1f} s)")
        last = now

    return mark


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import shutil

    from dynamo_tpu_torch import native
    from dynamo_tpu_torch.ops.kernels import build

    shutil.rmtree(FRONT_DIR, ignore_errors=True)
    shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    shutil.rmtree(FORMATS_DIR, ignore_errors=True)
    mark = phase_clock()
    # a hang leaves every thread's stack on stderr before the time limit
    faulthandler.dump_traceback_later(SMOKE_STACK_DUMP_S, exit=False)
    if sys.argv[1:2] == ["--disagg-soak"]:  # the streamed bf16 handoff, repeated
        try:
            card = card_line()
            log(card)
            build.build_library(verbose=True)
            build.library()
            secs = disagg_soak(torch, card, int(sys.argv[2]))
            log(json.dumps({"disagg_soak": dict(runs=len(secs), seconds=secs, card=card)}))
        except (SmokeFailure, RuntimeError) as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    if sys.argv[1:2] == ["--dtsan-cost"]:  # run c with and without the sanitizer, in turns
        try:
            card = card_line()
            log(card)
            build.build_library(verbose=True)
            build.library()
            dtsan_cost(torch, card, int(sys.argv[2]))
        except (SmokeFailure, RuntimeError) as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
    if sys.argv[1:] == ["--mesh-cards"]:  # every card of the machine, a rank each
        try:
            card = card_line()
            log(card)
            build.build_library(verbose=True)
            build.library()
            mark("build")
            mesh_cards_phase(torch, card)
            mark("mesh cards")
        except (SmokeFailure, RuntimeError) as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
        return 0
    lints, analysis_proc = {}, None
    try:
        card = card_line()
        log(card)
        lints = start_lints()
        analysis_proc = start_analysis()
        # the host RAM the KV tiers' pinned pools come out of
        log("free -g: " + " | ".join(subprocess.run(["free", "-g"], capture_output=True,
                                                    text=True).stdout.strip().splitlines()))
        t0 = time.perf_counter()
        lib_path = build.build_library(verbose=True)
        build.library()
        log(f"build: {time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        host_lib = native.build_library()
        native.load()
        host_build_s = time.perf_counter() - t0
        log(f"host library build: {host_build_s:.2f} s, {host_lib.name} ({card})")
        mark("build")
        sass_check(torch, lib_path)
        errs = kernel_phase(torch)
        mark("kernel checks")
        errs.update(fp16_kernel_phase(torch))
        mark("fp16 kernel checks")
        kern_phase(torch, card)
        mark("kern")
        times = timing_phase(torch, card)
        times.update(q8_timing_phase(torch, card))
        times.update(matmul_timing(torch, card))
        times.update(verify_timing(torch, card))
        times.update(moe_timing(torch, card))
        mla = mla_timing(torch, card)
        mark("kernel timings")
        f16 = torch.float16
        times.update(timing_phase(torch, card, f16))
        times.update(q8_timing_phase(torch, card, f16))
        times.update(matmul_timing(torch, card, f16))
        mark("fp16 kernel timings")
        write_tokenizer(FRONT_DIR)
        default, budget, mixed, spec, disagg, tier, fault = serving_phase(torch, card)
        times["ragged"] = ragged_timing(torch, card, mixed)
        times["ragged_err"] = times["ragged"].pop("err")
        times["ragged_fp16"] = ragged_timing(torch, card, mixed, dtype=f16)
        times["ragged_err_fp16"] = times["ragged_fp16"].pop("err")
        mark("Llama-3-8B bf16 serving")
        analysis = read_analysis(analysis_proc)
        trace_line(default, analysis, card)
        load_phase(default, tier["router"], lints, card)
        mark("load")
        q8_default, q8_budget, q8_mixed, q8_spec, q8_disagg, q8_tier = serving_phase_q8(torch,
                                                                                       card)
        times["ragged_q8"] = ragged_timing(torch, card, q8_mixed, quant=True)
        times["ragged_q8_err"] = times["ragged_q8"].pop("err")
        times["ragged_q8_fp16"] = ragged_timing(torch, card, q8_mixed, quant=True, dtype=f16)
        times["ragged_q8_err_fp16"] = times["ragged_q8_fp16"].pop("err")
        disagg.update(q8_disagg)
        disagg_out = disagg_line(torch, disagg, card)
        tier_out = tier_line(tier, q8_tier, card)
        mark("Llama-3-8B int8 serving")
        fp16 = fp16_serving_phase(torch, card)
        fp16_refusals(torch, card)
        mark("Llama-3-8B fp16 serving")
        parity_phase(torch, card, verify=True)
        parity_phase(torch, card, quant=True)
        parity_phase(torch, card, make_cfg=llama3_8b_fp16, width="8B fp16")
        mark("Llama-3-8B parity")
        graphs, formats, mesh_cli = front_door_phase(torch, card)
        mark("Llama-3-8B front door")
        fp16_cli = fp16_cli_phase(card)
        mark("Llama-3-8B fp16 front door")
        moe_default, moe_budget = moe_serving_phase(torch, card)
        mark("Qwen3-30B-A3B serving")
        parity_phase(torch, card, make_cfg=qwen3_30b_a3b, width="Qwen3-30B-A3B")
        parity_phase(torch, card, quant=True, make_cfg=qwen3_30b_a3b, width="Qwen3-30B-A3B")
        mark("Qwen3-30B-A3B parity")
        moe_front_door_phase(torch, card)
        mark("Qwen3-MoE front door")
        ds_default, ds_q8 = deepseek_serving_phase(torch, card)
        mark("DeepSeek-V2-Lite serving")
        deepseek_parity_phase(torch, card)
        mark("DeepSeek parity")
        deepseek_front_door_phase(torch, card)
        mark("DeepSeek front door")
        mesh = mesh_phase(torch, card, analysis["census"])
        mark("mesh")
    except (SmokeFailure, RuntimeError) as e:  # a failed check, build or nvidia-smi
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        stop_lints(lints)
        if analysis_proc is not None and analysis_proc.poll() is None:
            analysis_proc.kill()
            analysis_proc.wait()
        shutil.rmtree(FRONT_DIR, ignore_errors=True)
        shutil.rmtree(PERSIST_DIR, ignore_errors=True)
        shutil.rmtree(FORMATS_DIR, ignore_errors=True)
    # launches: each kernel's count over the serving run of the path it
    # carries (decode and prefill: the default path; ragged: the token-budget
    # path; the int8 kernels: the same paths on the int8 model; the grouped
    # expert kernels: Qwen3-30B-A3B's bf16 default and int8 token-budget runs;
    # E1 also DeepSeek-V2-Lite's two default-path runs, bf16 and int8 cache)
    times["moe"]["deepseek_v2_lite"].update(
        launches=ds_default["launches"]["moe"], launches_int8_cache=ds_q8["launches"]["moe"])
    # the verify shape: each decode kernel's readings at S = 5 and 8 and its
    # launches at S = k + 1 over the spec runs; B5's at the verify's M = 40
    spec.update(q8_spec)
    verify_launches = {kernel: {label: r["decode_calls_by_s"].get(f"{kernel} S={r['k'] + 1}", 0)
                                for label, r in spec.items()
                                if r["k"] and label.startswith("int8") == (kernel == "B4a")}
                       for kernel in ("B1", "B4a")}
    # each kernel's launches over the disaggregated runs (DISAGG_RUNS)
    disagg_launches = {k: sum(r["launches"][k] for r in disagg.values())
                       for k in _kernel_wrappers()}
    # and over the KV-tier runs (bf16 and int8 models, the router's included)
    tier_launches = {k: tier["launches"][k] + q8_tier["launches"][k] for k in _kernel_wrappers()}
    # and in the serving graph's two worker processes, as each one's status read them
    graph_launches = {k: sum(w[k] for w in graphs["worker_launches"].values())
                      for k in _kernel_wrappers()}
    kernels = [
        dict(name="paged_decode_attention", route="cuda",
             source="dynamo_tpu_torch/csrc/decode_attention.cu",
             replaces="dynamo_tpu/ops/pallas/decode_attention.py:281",
             launches=default["launches"]["decode"],
             launches_disagg=disagg_launches["decode"],
             launches_tier=tier_launches["decode"],
             launches_shards=tier["shards"]["launches"]["decode"],
             launches_graphs=graph_launches["decode"],
             launches_fault=fault["launches"]["decode"],
             launches_formats=formats["launches_total"]["decode"],
             max_abs_err=max(errs["decode"], times["decode_err"]), **times["decode"],
             verify=dict(times["decode_verify"], launches=verify_launches["B1"])),
        dict(name="paged_prefill_attention", route="cuda",
             source="dynamo_tpu_torch/csrc/prefill_attention.cu",
             replaces="dynamo_tpu/ops/pallas/prefill_attention.py:246",
             launches=default["launches"]["prefill"],
             launches_disagg=disagg_launches["prefill"],
             launches_tier=tier_launches["prefill"],
             launches_shards=tier["shards"]["launches"]["prefill"],
             launches_graphs=graph_launches["prefill"],
             launches_fault=fault["launches"]["prefill"],
             launches_formats=formats["launches_total"]["prefill"],
             max_abs_err=max(errs["prefill"], times["prefill_err"]), **times["prefill"]),
        dict(name="ragged_paged_prefill_attention", route="cuda",
             source="dynamo_tpu_torch/csrc/ragged_prefill_attention.cu",
             replaces="dynamo_tpu/ops/pallas/prefill_attention.py:593",
             launches=budget["launches"]["ragged"],
             launches_disagg=disagg_launches["ragged"],
             launches_tier=tier_launches["ragged"],
             launches_shards=tier["shards"]["launches"]["ragged"],
             launches_graphs=graph_launches["ragged"],
             launches_fault=fault["launches"]["ragged"],
             launches_formats=formats["launches_total"]["ragged"],
             max_abs_err=max(errs["ragged"], times["ragged_err"]), **times["ragged"]),
        dict(name="paged_decode_attention_q8", route="cuda",
             source="dynamo_tpu_torch/csrc/decode_attention.cu",
             replaces="dynamo_tpu/ops/pallas/decode_attention.py:94",
             launches=q8_default["launches"]["decode_q8"],
             launches_disagg=disagg_launches["decode_q8"],
             launches_tier=tier_launches["decode_q8"],
             launches_shards=tier["shards"]["launches"]["decode_q8"],
             launches_graphs=graph_launches["decode_q8"],
             launches_fault=fault["launches"]["decode_q8"],
             launches_formats=formats["launches_total"]["decode_q8"],
             max_abs_err=max(errs["decode_q8"], times["decode_q8_err"]), **times["decode_q8"],
             verify=dict(times["decode_q8_verify"], launches=verify_launches["B4a"])),
        dict(name="paged_prefill_attention_q8", route="cuda",
             source="dynamo_tpu_torch/csrc/prefill_attention.cu",
             replaces="dynamo_tpu/ops/pallas/prefill_attention.py:57",
             launches=q8_default["launches"]["prefill_q8"],
             launches_disagg=disagg_launches["prefill_q8"],
             launches_tier=tier_launches["prefill_q8"],
             launches_shards=tier["shards"]["launches"]["prefill_q8"],
             launches_graphs=graph_launches["prefill_q8"],
             launches_fault=fault["launches"]["prefill_q8"],
             launches_formats=formats["launches_total"]["prefill_q8"],
             max_abs_err=max(errs["prefill_q8"], times["prefill_q8_err"]), **times["prefill_q8"]),
        dict(name="ragged_paged_prefill_attention_q8", route="cuda",
             source="dynamo_tpu_torch/csrc/ragged_prefill_attention.cu",
             replaces="dynamo_tpu/ops/pallas/prefill_attention.py:384",
             launches=q8_budget["launches"]["ragged_q8"],
             launches_disagg=disagg_launches["ragged_q8"],
             launches_tier=tier_launches["ragged_q8"],
             launches_shards=tier["shards"]["launches"]["ragged_q8"],
             launches_graphs=graph_launches["ragged_q8"],
             launches_fault=fault["launches"]["ragged_q8"],
             launches_formats=formats["launches_total"]["ragged_q8"],
             max_abs_err=max(errs["ragged_q8"], times["ragged_q8_err"]), **times["ragged_q8"]),
        dict(name="int8_matmul", route="cuda",
             source="dynamo_tpu_torch/csrc/int8_matmul.cu",
             replaces="dynamo_tpu/ops/pallas/int8_matmul.py:64",
             launches=q8_default["launches"]["matmul"],
             launches_disagg=disagg_launches["matmul"],
             launches_tier=tier_launches["matmul"],
             launches_shards=tier["shards"]["launches"]["matmul"],
             launches_graphs=graph_launches["matmul"],
             launches_fault=fault["launches"]["matmul"],
             launches_formats=formats["launches_total"]["matmul"],
             max_abs_err=max(errs["matmul"], times["matmul_err"]), **times["matmul"],
             verify=dict(times["matmul_verify"],
                         launches=spec["int8 ngram k=4"]["launches"]["matmul"])),
        dict(name="grouped_matmul", route="cuda",
             source="dynamo_tpu_torch/csrc/grouped_matmul.cu",
             replaces="dynamo_tpu/models/llama.py:631",
             launches=moe_default["launches"]["moe"],
             launches_disagg=disagg_launches["moe"],
             launches_tier=tier_launches["moe"],
             launches_shards=tier["shards"]["launches"]["moe"],
             launches_graphs=graph_launches["moe"],
             launches_fault=fault["launches"]["moe"],
             launches_formats=formats["launches_total"]["moe"],
             max_abs_err=max(errs["moe"], times["moe_err"]), **times["moe"]),
        dict(name="grouped_matmul_q8", route="cuda",
             source="dynamo_tpu_torch/csrc/grouped_matmul.cu",
             replaces="dynamo_tpu/models/llama.py:631",
             launches=moe_budget["launches"]["moe_q8"],
             launches_disagg=disagg_launches["moe_q8"],
             launches_tier=tier_launches["moe_q8"],
             launches_shards=tier["shards"]["launches"]["moe_q8"],
             launches_graphs=graph_launches["moe_q8"],
             launches_fault=fault["launches"]["moe_q8"],
             launches_formats=formats["launches_total"]["moe_q8"],
             max_abs_err=max(errs["moe_q8"], times["moe_q8_err"]), **times["moe_q8"]),
    ]
    # the fp16 bodies: launches over the fp16 serving run of the path each
    # carries (decode and prefill: the 32-layer default path; ragged: the
    # token-budget path; the int8 bodies: the int8 model's two paths)
    fp16_runs = {"default": fp16["fp16 default path"],
                 "budget": fp16[f"fp16 token-budget path, {FP16_PLANE_LAYERS} layers"],
                 "q8_default": fp16[f"fp16 int8 default path, {FP16_PLANE_LAYERS} layers"],
                 "q8_budget": fp16[f"fp16 int8 token-budget path, {FP16_PLANE_LAYERS} layers"]}
    fp16_rows = []
    for name, key, run, source, replaces in (
            ("paged_decode_attention", "decode", "default", "decode_attention.cu", "decode_attention.py:281"),
            ("paged_prefill_attention", "prefill", "default", "prefill_attention.cu",
             "prefill_attention.py:246"),
            ("ragged_paged_prefill_attention", "ragged", "budget", "ragged_prefill_attention.cu",
             "prefill_attention.py:593"),
            ("paged_decode_attention_q8", "decode_q8", "q8_default", "decode_attention.cu",
             "decode_attention.py:94"),
            ("paged_prefill_attention_q8", "prefill_q8", "q8_default", "prefill_attention.cu",
             "prefill_attention.py:57"),
            ("ragged_paged_prefill_attention_q8", "ragged_q8", "q8_budget", "ragged_prefill_attention.cu",
             "prefill_attention.py:384"),
            ("int8_matmul", "matmul", "q8_default", "int8_matmul.cu", "int8_matmul.py:64")):
        t = times[key + "_fp16"]
        fp16_rows.append(dict(
            name=f"{name}_fp16", route="cuda", source=f"dynamo_tpu_torch/csrc/{source}",
            replaces=f"dynamo_tpu/ops/pallas/{replaces}", dtype="float16",
            launches=fp16_runs[run]["launches_fp16"][key],
            max_abs_err=max(errs[key + "_fp16"], times[key + "_err_fp16"]),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], **({"prefill": times["matmul_prefill_fp16"]}
                                            if key == "matmul" else {})))
    # and on the mesh, each rank's over the tp = 2 and SP runs (mesh_phase)
    mesh_keys = {"paged_decode_attention": "decode", "paged_prefill_attention": "prefill",
                 "ragged_paged_prefill_attention": "ragged",
                 "paged_decode_attention_q8": "decode_q8",
                 "paged_prefill_attention_q8": "prefill_q8",
                 "ragged_paged_prefill_attention_q8": "ragged_q8", "int8_matmul": "matmul",
                 "grouped_matmul": "moe", "grouped_matmul_q8": "moe_q8"}
    for row in kernels:
        key = mesh_keys[row["name"]]
        row.update(launches_mesh_rank0=mesh["per_rank"][0][key],
                   launches_mesh_rank1=mesh["per_rank"][1][key],
                   max_abs_err_mesh=mesh["errs"].get(key))
    mesh_cli.update(card=card)
    log(json.dumps({"mesh_cli": mesh_cli}))
    log(json.dumps({"spec": [{k: v for k, v in r.items() if k != "streams"}
                             for r in spec.values()]}))
    log(json.dumps({"mla": mla}))
    log(json.dumps({"disagg": disagg_out}))
    log(json.dumps({"tier": tier_out}))
    log(json.dumps({"router": tier["router"]}))
    r = tier["router"]
    log(json.dumps({"native": dict(
        card=card, build_s=host_build_s, copies=tier["host"],
        router=dict(native_index=r["native_index"], python_index_agrees=r["python_index_agrees"],
                    decisions=len(r["decisions"]), find_matches_ms=r["find_matches_ms"],
                    decision_ms=r["decision_ms"]))}))
    log(json.dumps({"shards": tier["shards"]}))
    log(json.dumps({"planner": tier["planner"]}))
    log(json.dumps({"graphs": graphs}))
    log(json.dumps({"fault": fault}))
    log(json.dumps({"formats": formats}))
    log(json.dumps({"fp16": dict(
        card=card, layers={label: FP16_PLANE_LAYERS if "layers" in label else 32 for label in fp16},
        runs={label: dict(ttft_median_s=sorted(r["ttfts"])[len(r["ttfts"]) // 2],
                          ttft_max_s=max(r["ttfts"]), decode_tok_s=r["decode_tok_s"],
                          launches_fp16=r["launches_fp16"]) for label, r in fp16.items()},
        bf16_default=dict(ttft_median_s=sorted(default["ttfts"])[len(default["ttfts"]) // 2],
                          ttft_max_s=max(default["ttfts"]), decode_tok_s=default["decode_tok_s"]),
        cli={k: ({kk: vv for kk, vv in v.items() if kk != "text"} if isinstance(v, dict) else v)
             for k, v in fp16_cli.items()})}))
    log(json.dumps({"kernels": kernels + fp16_rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
