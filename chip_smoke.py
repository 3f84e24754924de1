#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``seldon_core_tpu_torch``) only, and imports nothing of
JAX or of the JAX package.  Phases, each of which fails the run:

1. card report (``nvidia-smi`` name and power limit);
2. build every CUDA kernel of the main paths from ``ops/csrc``, one
   ``nvcc`` per source, all started together; the server processes of
   phases 4, 7, 9, 11-17 and 18a launch beside the build (each waits on the
   build's lock for a kernel it loads), with those of phases 23 and 24,
   and are awaited before phase 3, so
   no phase waits on a load and no load runs beside a timed window (the
   line ``early servers`` gives their ready times, the card memory in use
   and the host memory available);
3. ``fused_normalize`` (K1) against its plain PyTorch version on the
   card, bit for bit, for bf16, f16 and f32 out: the main path's shapes
   (32 and 1 images of 224x224x3), C = 3 with a byte count that is not a
   whole number of 16-byte vectors, C = 1 and C = 4 with a tail, C = 5
   (the generic body), fewer bytes than one vector, and a view 1 byte off
   16-byte alignment; kernel, plain and library-call times (CUDA events,
   median of 100, L2 flushed before each launch, then a GPU-side spin so
   the host has enqueued the call before the start event) beside the
   bound (bytes moved over the card's memory rate), the launch floor of
   K1's own grid (the ``launch only`` copy of ``probe_normalize``, whose
   kernels return at once) and PyTorch's cast-copy of the same traffic
   (``out_bf16.copy_(x_u8)``);
3b. the paged-decode kernels K4 (``stream``) and K5 (``grid``) against
   their plain version on the card: the serving shape (16 lanes, 8
   heads of 64, pages of 64, 16-page tables, random non-contiguous page
   ids, ragged lengths 0..1024) and a small ragged one (head_dim 16,
   pages of 8), bf16 and f32 pages; largest |kernel - plain| over finite
   entries within 1e-4 of the largest |plain|, -inf and 0 exactly where
   the plain version has them, no NaN; at the serving shape each lane's
   bits unchanged by a repeated call, by the lanes in reverse order, by
   half the batch, and by other lengths and tables in the other lanes
   (one launch a call for both kernels); kernel, plain and library
   (gather + scaled_dot_product_attention) times at uniform length 512
   and at the ragged lengths, beside the bound;
3c. the flash-attention kernel K3 against its plain version on the card
   (TF32 off for matmul and cuDNN): the ViT-B/16 serving shape (32, 197,
   12, 64) bf16 non-causal, also as the strided views of the qkv split;
   (4, 1024, 8, 64) bf16 causal; (2, 50, 2, 16) and (1, 1, 1, 8) f32,
   causal and not; head_dim 128 in bf16, 40 in f16 and 96 in bf16 (a
   scale that is not a power of two; checked, not timed).  float32: the
   largest |kernel - plain| within 1e-5 of the largest |plain|; bf16 /
   f16: one step of the format (rtol 2**-7 / 2**-10) with a floor at one
   step of 2**-8 of the largest |plain|; no NaN.  Kernel, plain and
   ``F.scaled_dot_product_attention`` times (median of 100, L2 flushed)
   beside the bound, at the serving and the causal shape;
3d. the int8-weight matmul K2 (``int8_matmul``) against its plain
   version on the card (TF32 off): (6304, 768) @ (768, 3072) bf16 (ViT-B/16's
   MLP fc1 at batch 32), (32, 2048) @ (2048, 1000) bf16 (the ResNet-50
   head at batch 32), (16, 512) @ (512, 1536) f32 (the LM's qkv at 16
   lanes), ragged (5, 16) @ (16, 10) and (100, 300) @ (300, 70) f32,
   (197, 768) @ (768, 2304) f16 and (1, 768) @ (768, 3072) bf16 (the last
   two checked, not timed);
   float32 within 1e-5 of the largest |plain|, bf16 within one step as
   3c, no NaN; kernel, plain and ``torch.matmul(x, w.to(x.dtype)) * scale``
   times (median of 100, 4 GB L2 flush) beside the bound at the first
   three; then K2's path, an ``Int8Dense`` forward at the fc1 shape with
   the launch counts set to 0 just before it: one launch, its output bit
   for bit K2's product plus the bias in bf16, and that product within
   one bf16 step of its plain version;
4. the main path: the microservice CLI serving ResNet-50 (224x224x3,
   1000 classes, bf16, normalize=true, max_batch_size=32, seeded random
   weights with live residual branches) over REST as a subprocess; uint8
   ``rawTensor`` requests (a batch of 8 and 8 concurrent single images)
   must give 1000 finite logits per row, and every row must agree with an
   in-process model of the same weights; ``/metrics`` must show batching;
   the server's kernel launch counts, taken just before and just after
   the traffic, must show every kernel launched;
5. whole-path numerics in-process: bf16 with the kernels against f32
   with the plain versions (TF32 off), relative L2 error <= 5e-2 and
   per-row cosine similarity >= 0.99;
6. numbers: p50/p99 latency of 200 sequential single-image requests,
   img/s of batch-32 requests from 4 clients over a 2 s window, device
   forward time, and a profiler breakdown;
7. the generation path: the CLI serving ``StreamingLM`` (vocab 16384,
   d_model 512, 8 layers, 8 heads, max_len 1024, pages of 64, 16 slots,
   8 steps a chunk, 64 new tokens, bf16, seeded random weights) over
   REST as a subprocess; 16 concurrent greedy requests (prompts of 16 to
   700 tokens) return 64 ids each, in the vocabulary; 8 sequential
   single requests equal an in-process ``PagedEngine`` of the same
   weights, each prompt alone, bit for bit; at least 75% of the
   concurrent rows equal theirs too; a repeated request is identical;
   the server's K4 launches grow by exactly 8 layers x its decode calls
   (one a step, two in a chunk split into length buckets); numbers:
   REST p50 and the largest of 16 sequential requests (too few for a
   p99; every tail the smoke prints rests on at least 100 samples)
   (prompt 128, 32 new) and REST tokens/s of 16 closed-loop clients
   over 2 s;
8. engine numerics in-process: in f32 the kernel lane, the gather lane
   (``SELDON_TPU_PAGED_KERNEL=0`` with ``SELDON_TPU_CHUNK_IMPL=pool``: the
   kernel off alone would pick the ring chunk) and the grid kernel give identical
   greedy tokens for 16 ragged prompts (K5's launches counted there);
   bf16 kernel lane against f32 gather lane on the first decode step's
   logits, relative L2 <= 5e-2 and per-row cosine >= 0.99; numbers:
   decode tokens/s at 16 slots (prompt 128, 128 new tokens, full run
   minus prefill and one chunk), prefill ms for 16 x 128, and a profile
   of one decode chunk (device time by kernel, K4's share, idle share);
9. the ViT path: the CLI serving ViT-B/16 (224x224x3, 1000 classes, d768,
   12 layers of 12 heads of 64, 197 tokens, bf16, normalize=true,
   max_batch_size=32, ``{"attention": "flash"}``, seeded random weights)
   over REST as a subprocess; uint8 ``rawTensor`` requests (a batch of 8
   and 8 concurrent single images) give 1000 finite logits per row, each
   within relative L2 2e-2 of an in-process model of the same weights and
   nearer its own image's answer than any other's; the server's
   ``flash_attention`` launches grow by exactly 12 x the batches served
   and ``fused_normalize``'s by the batch count; numbers: p50/p99 of 150
   sequential single images, img/s of batch-32 requests from 4 clients
   over 2 s, and the device time of the in-process forward at batch 1
   and 32 from the profiler, with K3's share and the idle share;
10. transformer numerics in-process: ViT-B/16 bf16 with K3 against f32
   with plain attention (TF32 off), relative L2 <= 5e-2 and per-row
   cosine >= 0.99; ``transformer_lm`` (the generation config) served by
   an in-process ``CudaServer`` with ``attention=flash`` (causal K3, 8
   launches a forward) against the plain model in f32, within 1e-4;
11. the quantised multi-adapter generation path:
   (a) the int8 and LoRA-fold variants K4-int8, K5-int8, K4-LoRA and
   K4-int8+LoRA against their plain version on the card at the 3b shapes
   (random int8 pages, positive random scales, lanes over adapter slots
   0, 1 and 2, rank 8), q in bf16 and f32: acc / m / l as in 3b, the
   (B, 3D) delta within 1e-5 of the largest |plain|, slot-0 lanes' delta
   exactly 0; each lane's bits unchanged as in 3b (the other lanes'
   adapter slots changed too); kernel, plain and library (dequantised gather +
   scaled_dot_product_attention, plus two torch.bmm for the fold) times at
   uniform length 512 and ragged, beside the bound;
   (b) the CLI serving ``StreamingLM`` at the generation config with
   ``SELDON_TPU_KV_DTYPE=int8``, ``max_adapters=2``, ``lora_rank=8`` and
   two seeded adapters; 16 concurrent greedy requests mixing the base
   model, ``a1`` by body tag and ``a2`` by the ``X-Seldon-Adapter``
   header; 8 sequential requests equal an in-process ``PagedEngine`` of the
   same weights, adapters and int8 pool, bit for bit, at least 75% of the
   concurrent rows equal theirs, adapter rows differ from the base row of
   the same prompt, a body tag wins over the header, and the server's
   K4-int8+LoRA launches grow by exactly 8 layers x its decode calls;
   numbers: REST p50 and the largest of 16 sequential requests (prompt
   128, 32 new) and tokens/s of 16 closed-loop clients over 2 s;
   (c) in-process at the same config: in f32 the int8 kernel lane, the
   int8 gather lane and the int8 grid kernel, and (native pool, adapters)
   the fold and the einsum lane, give identical greedy tokens for 16
   ragged prompts (the gather and einsum lanes on the pool chunk; each
   variant's launches counted there, exactly layers x decode calls);
   bf16 int8 kernel lane against the bf16 native pool on
   the first decode step's logits, relative L2 <= 5e-2 and per-row cosine
   >= 0.99; f32 int8 against native greedy tokens, first tokens equal and
   an agreement of at least 0.75; in bf16 with int8 + adapters, 16 prompts
   in one wave (mixed-adapter prefill groups) give each prompt's tokens
   alone, all 16 (32 new tokens); decode tokens/s with int8 + adapters and a profile of
   one decode chunk (the variant's share, the idle share);
12. the int8 precision lanes: the CLI serving ResNet-50 in the phase 4
   configuration with ``precision`` ``int8w`` and then ``w8a8`` over REST;
   ``/health/status`` must show 54 int8 kernels and 52 calibrated
   activation scales (w8a8, each by layer, logged against the in-process
   server's; 0 for int8w); a batch of 8 and 8 concurrent
   single images each within relative L2 2e-2 of an in-process server of
   the same lane (in w8a8 each row is logged beside its group's batch
   count and its error against in-process runs of its image alone at
   every bucket up to 8); every batch one ``fused_normalize`` and, in w8a8, 52
   integer GEMMs; each lane against the bf16 lane on the same weights
   (32 images): int8w relative L2 <= 5e-2 and per-row cosine >= 0.99,
   w8a8 top-1 agreement >= 0.8 (its cosine reported); one w8a8 conv's
   int32 accumulator equal to the float64 product of the same integers;
   numbers: REST p50/p99 of 100 sequential single images, img/s of
   batch-32 requests from 4 clients over 2 s, the device time by group
   of an in-process forward at batch 32, and the weight bytes on the card;
13. the ResNet-50 SeldonDeployment over the port's engine (the phase 4
   served parameters with ``max_wait_ms=1.0``; ``BASELINE.json``'s metric):
   (a) a gateway child process (``subprocess``, not ``fork``) built by
   ``gateway_child`` from a one-node ``CUDA_SERVER`` graph
   (``UnitSpec.from_dict`` -> ``PredictorService`` -> ``Gateway`` ->
   ``serve_gateway``, sync gRPC), driven with the JAX headline's method
   (``bench.py:1296-1345``): uint8 ``rawTensor`` flat rows [rows, 150528];
   4 clients of batch-1 requests for 3 s (p50 / p90 / p99, QPS), then 8
   clients of batch-32 requests over three windows of 1 s (img/s, best
   and mean), after 2 s of one client's sequential batch-1 requests (the
   service time without queueing), over gRPC ``Seldon/Predict`` and then REST
   ``/api/v0.1/predictions`` on the same gateway (the same windows); zero
   failures, and the
   gateway's K1 launches equal its batches (``/metrics``); the headline
   line prints ``grpc_p50_ms``, ``grpc_p99_ms``, ``grpc_qps``,
   ``grpc_img_s``, the REST numbers and the 10 ms target beside the p50;
   (b) the two-process deployment: the microservice CLI with ``--api
   GRPC`` and a gateway whose node is its gRPC endpoint, the windows of 3 s,
   the hop (p50 minus (a)'s), K1 launches equal to batches (from the
   answers' metrics); (c) every row served in (a) and (b) within relative
   L2 2e-2 of an in-process model of the same weights and nearer its own
   image's answer than any other image's (of the 8 singles, or of its
   batch); (d) in-process
   gateways for ``BASELINE.json`` configs 4 and 5 with ResNet-50 children
   (seeds 1 and 2): an ``EPSILON_GREEDY`` router, 50 predicts each
   followed by ``SendFeedback`` (routing on every answer, the router's
   counts sum to 50 and equal the branches served, each answer within 2e-2
   of its branch's in-process model), and a pass-through ``TRANSFORMER``
   over an ``AVERAGE_COMBINER`` (each answer within 2e-2 of the mean of
   the two in-process models; gRPC p50 of 50 sequential requests);
14. the C++ native ingress (``engine/native_ingress.py``,
   ``native/frontserver.cc`` built by g++ with phase 2's builds) in front
   of 13a's gateway child, one port for HTTP/1.1 and h2c gRPC, 4 batch
   threads (the knob's default): (a) 13a's gRPC clients and windows aimed
   at the native port, the latency window 5 s (``bench.py:1281-1345``, the JAX headline's
   method), the batcher's mean collection wait over the one-client
   window; (b) SRT1 frames over HTTP/1.1 (one client's sequential p50,
   batch-32 img/s), one multi-frame container of 1, 2 and 5 rows served
   as ONE micro-batch, one ``Seldon/PredictRaw``; (c) the C++ load
   clients of ``bench.py``'s ``native_model_phase`` (``loadgen.cc``) on
   both wire formats: one connection at batch 1, then batch 32 at (8, 1)
   best of three windows and (8, 4), (8, 8), (8, 12), every answer a 2xx
   / grpc-status 0 (their bodies, checked in (b) and (a), are not read);
   (d) every row served in (a) and (b), the container, PredictRaw and a
   JSON predict within 2e-2 of the in-process model and nearest its own
   image; no failure on the native server's ``/stats``; its fast-lane
   count equal to the gRPC and frame requests of (a) and (b); K1
   launches equal to the model's batches (``/metrics`` on the native
   port); a JSON predict and a ``SendFeedback`` on the fallback lane; the
   ``14 headline`` line beside 13a's numbers;
15. A4 on the card, the request contract on every ingress of the
   ResNet-50 deployment (13a's served parameters): (a) a gateway child
   with TLS (the repo's test CA, ``tests/data/torch_port_tls``) and OAuth
   on REST and sync gRPC, tracing to its ring and the metrics observer,
   with a native port in front, beside 13a's plain gateway child; a
   token from ``/oauth/token``, then 4 TLS sync-gRPC clients of uint8
   rows [1, 150528], each request with ``authorization: Bearer``,
   ``x-seldon-deadline-ms: 10000`` and a ``traceparent``, for 2 s after
   one client's 2 s of sequential requests, on the two gateways in turns
   (on, off, off, on): p50 / p99 / QPS and the sequential p50 of each
   window and the A4-minus-plain difference of the means; every served
   row against the in-process model; K1 launches equal batches on both;
   (b) the two-process deployment (the CLI with ``--api BOTH
   --tracing`` and an A4 gateway whose node is its gRPC endpoint, both
   with ``SELDON_TPU_TRACE_EXPORT``): 8 single images each with a trace
   of its own and a batch of 8 within 2e-2 of the in-process model and
   nearest their own image; for each of the 8, in the two JSONL sinks,
   the microservice's ``microservice.predict`` span a child of the
   gateway's node span under the client's trace id;
   ``X-Seldon-Deadline-Ms: 0`` answers 504 ``DEADLINE_EXCEEDED`` on REST
   and a FAILURE naming ``gateway grpc ingress Seldon/Predict`` on gRPC,
   no token answers 401 and ``UNAUTHENTICATED``, and K1 does not run for
   any of them; a multipart REST predict within 2e-2 of the same JSON
   predict; K1 launches equal batches (the microservice's ``/metrics``);
   (c) ``/metrics``: ``seldon_api_engine_server_requests_duration_seconds_count``
   equal to the requests (a) served, on the A4 gateway and on its native
   port; the two-process hop's request bytes > 0 and its in-flight gauge
   0 at rest; ``cudaserver_kernel_launches{kernel="fused_normalize"}`` on
   the gateway, the native port and the microservice;
16. A2.2 on the card, failure containment on replicated ResNet-50 (13a's
   served parameters): two replicas R1 and R2 (the CLI with ``--api
   BOTH``, the same seed; the gateway dials their gRPC ports, the smoke
   reads their ``/metrics``) behind a gateway child whose root node is a
   ``BalancedClient`` of ``build_client`` replica clients
   (``seldon.io/breaker-failures: 5``, ``seldon.io/breaker-reset-ms:
   1000``), sync gRPC; uint8 rows [1, 150528] of 8 distinct images:
   (a) one client's 2 s, then 4 clients for 4 s: p50 / p99 / QPS, each
   replica 50% +- 5% of the requests, K1 launches = batches on each;
   (b) SIGKILL of R2 half-way through a 4 s window of 4 clients: zero
   client-visible failures; on the gateway's ``/metrics`` R2's
   ``seldon_tpu_transport_breaker_state`` 2, a transition to open,
   fast-fails and failovers; p50 / p99 before and after the kill and the
   slowest request around it (one failover); (c) R2 restarted on its
   ports and warmed by requests sent to it directly (its first request
   and the slowest of 4 x 4 concurrent ones printed): the breaker gauge 0
   within the 1 s cooldown plus 2 s for one probe, R2's K1 launches = its
   batches again;
   (d) a gateway whose node is remote on R1 with an in-process
   ``CUDA_SERVER`` ``precision: int8w`` fallback: 50 sequential answers
   untagged, a malformed row a 4xx and ``x-seldon-deadline-ms: 0`` a 504
   ``DEADLINE_EXCEEDED`` with no fallback and no K1 for either; SIGKILL of
   R1, then 50 answers tagged ``degraded`` / ``fallback_for: model``,
   each within 2e-2 of an in-process int8w model and nearest its own
   image, the fallbacks counter = 50 and the fallback's K1 = its batches;
   the time to the first degraded answer and the degraded p50; R1
   restarted and warmed as R2, untagged answers again within 3 s;
   (e) hedging on R1, measured only: ``seldon.io/hedge-ms`` at the p90 of
   a 2 s unhedged window, then 1.5 s windows off, on, on, off; hedges and
   wins on ``/metrics`` = the client's counters; R1's rows between the
   requests sent and that plus the hedges; a ``SendFeedback`` under
   ``hedge-ms: 1`` fires no hedge.  Every row of (a)-(e) within 2e-2 of
   its in-process model and nearest its own image;
17. A5 and A6 on the card, a user's checkpoint and two resolutions (the
   three CLI servers start together at the phase's start):
   (a) ResNet-50 from ``model_uri``: phase 4's seeded weights as flax's
   ``{"params", "batch_stats"}`` tree (``resnet_flax_variables``; the
   port's ``resnet_params_from_flax`` gives back every tensor bit for bit)
   written by the port's ``utils/serialization.to_bytes`` (~102 MB of
   float32) into a directory, served by the CLI with ``model_uri=file://``
   that directory: the ``state_dict`` an in-process ``CudaServer`` loads
   from it equal to the seeded one bit for bit; a batch of 8 and 8
   concurrent singles within 2e-2 of the in-process model and nearest
   their own image; K1 launches = batches; the download / decode /
   convert / pin seconds;
   (b) ``StreamingLM`` from ``model_uri`` at phase 7's config (bf16) with
   one rank-8 adapter from ``{"uri": ...}``, both written by the port's
   ``to_bytes``: greedy tokens of 4 prompts x 16 new, sent one after
   another, equal an in-process ``PagedEngine`` on the same weights and
   factors, for the base model and the adapter;
   (c) the committed orbax fixture (``tests/data/torch_port_orbax``,
   written by ``StandardCheckpointer``) read through the system's
   libzstd: every leaf's SHA-256 as orbax restores it (``digest.json``),
   and an in-process float32 ``CudaServer`` on it (TF32 off) within
   rtol = atol = 1e-4 of the JAX server's logits for the 4 images;
   (d) ViT-B/16 (``{"attention": "flash", "pos_grid": 14}``, bf16) served
   with ``input_shape [224, 224, 3]`` and ``extra_input_shapes [[384,
   384, 3]]`` from one seeded checkpoint: the first request of each
   signature after load timed (the first-use stall, ROADMAP S2), then a
   batch of 8 and 8 concurrent singles at each resolution within 2e-2 of
   the in-process model at that resolution and nearest their own image;
   two signature groups; K1 launches = batches summed over the groups
   and K3 = 12 x batches; a 256x256 request refused with the 400 that
   lists both shapes; K3 at (32, 577, 12, 64) bf16 against its plain
   version within one bf16 step (3c's bar) and timed beside
   ``F.scaled_dot_product_attention`` and its bound;
18. the generation scheduler and precision lanes at the generation
   config, in-process: (a) bf16 / int8w / w8a8 decode rates, a w8a8
   chunk's ``int8_lowering_report``, a served w8a8 ``StreamingLM``; (b)
   the prefix cache on / off; (c) the steps ladder and a 49-page pool that
   stalls and evicts; (d) the SLO queue under the allocator audit; (e)
   chunked prefill under a 512-token budget; every counted run launches
   K4 once a layer a decode call;
19. the ring chunk, the length-bucketed split and token streaming at the
   generation config: (a) 16 prompts of 128 tokens, 64 new: the chunk
   ``SELDON_TPU_PAGED_KERNEL=0`` picks with the chunk unset is the ring;
   in f32 the ring (``SELDON_TPU_CHUNK_IMPL=ring``) and the pool chunk on
   K4 give equal greedy tokens, plain, with the two adapters of phase 11
   and with a prefix hit; no K4 launch over the ring's runs; bf16 rows and
   token agreement of the two, and their decode tokens/s in turns (ring,
   pool, pool, ring); (b) 8 prompts of 64 beside 8 of 768, 64 new:
   ``SELDON_TPU_CTX_BUCKETS=2`` against ``1`` on the pool chunk, then on
   the ring: equal f32 tokens, bucketed chunks under 2 only, K4 exactly
   layers x steps x buckets, bf16 tokens/s in turns; a pool engine with
   the knob unset runs one bucket (the CUDA default) and the tokens of
   ``1``; (c) a served bf16
   ``StreamingLM`` (cache off, ``max_queue`` 4) behind an in-process
   gateway: for 8 prompts on REST SSE, sync gRPC ``Seldon/GenerateStream``
   and the native ingress's, the streamed chunks joined equal the unary
   row of the same request on that lane, bit for bit; p50 time to the
   first and the last chunk beside the unary time; 4 concurrent streams
   a lane (at least 75% equal their rows); a client dropped after its
   first chunk leaves no slot and no page held within 2 s; SSE answers a
   spent deadline 504 and a shed 503, not a 200 stream; K4 exactly layers
   x decode calls; (d) 16 streamed f32 requests on a 49-page pool: an
   eviction, and every stream's chunks joined equal its result and the
   full pool's, each token once;
20. speculative decoding at the generation config, the JAX bench's
   method (``bench.py:2391-2500``): (a) float32 with TF32 off, 4 echo
   prompts of up to 160 tokens, 64 new: plain decode (8 steps a chunk),
   token-wise (1), oracle drafts (the plain tokens as hints) and ngram
   drafts, ``draft_k`` 4, give equal greedy tokens; tokens/s, acceptance
   and verify rounds of each; K4 exactly layers x decode calls on the
   plain lanes and none over the verify rounds; (b)
   ``SpeculativeGenerator`` with a seeded 2-layer d512 draft model, one
   prompt of 128, 64 new, f32: the plain engine's greedy tokens, and K4
   exactly 2 x the draft's one-token forwards; (c) bf16 at 16 lanes,
   16 echo prompts: ngram against plain, token agreement and decode
   tokens/s in turns;
21. drain and replay, live migration and the KV tier at the generation
   config, the JAX bench's methods (``bench.py:2129-2265``, ``:2884-2960``):
   (a) float32 with TF32 off, 16 streamed prompts of 128 tokens, 64 new,
   three waves on engine A, then ``evacuate_streams`` to engine B on the
   card: token loss 0 and every stream's tokens equal an uninterrupted
   control, ``migrate_ttr_ms``; again on an int8 pool; then ``drain()`` +
   ``replay()`` on a fresh engine: equal tokens, ``replay_ttr_ms``; K4
   exactly layers x decode calls on B and on the replay engine; (b) two
   returning sessions of 512 tokens, 4 new a revisit, 4 rounds, through
   a pool that holds one, ``SELDON_TPU_KV_OFFLOAD`` on and off in turns:
   equal tokens, host hits, promote x, hit % and revisit ms; a run with a
   host budget under one page and a spill directory: disk hits, equal
   tokens; a run with ``SELDON_TPU_KV_CHECKSUM=0`` and the CRC32C rate on
   the host (where a promotion's time goes); (c) two CLI ``StreamingLM`` processes: A, with
   ``SELDON_TPU_EVACUATE_TO`` naming B's gRPC port and a journal path, is
   SIGTERMed with 16 requests decoding and 8 queued: B imports the live
   streams and finishes them, A's clients get 503 ``MIGRATING`` or
   ``DRAINING``, and a process started on A's journal path replays as
   many streams as the journal has lines;
22. generation telemetry and chaos at the generation config (ROADMAP
   A8.11): (a) bf16 at 16 lanes, prompt 128, 64 new: the telemetry plane
   (flight recorder, telemetry ring, NaN guard, watchdog, bridge, every
   request captured) on and off in turns, decode tokens/s of each turn
   and the ratio (no limit, no gain claimed); (b) float32 with TF32 off:
   tokens equal on and off; ``paged.nan`` once on 16 lanes retires one
   stream 500 ``NUMERIC_POISON`` and the other 15 equal an uninjected
   run; ``paged.chunk`` once fails only that chunk's 16 streams while the
   8 queued serve on and the allocator audit stays clean;
   ``paged.alloc:times=3`` stalls and leaves the tokens equal;
   ``transport.corrupt`` on a migration container is the named CRC32C
   rejection with nothing imported; (c) a cold engine whose first wave
   builds K4 anew with ``nvcc`` stays healthy under a 200 ms ceiling; a
   ceiling under the chunk wall drives an engine to degraded and then
   evacuating, ``evacuate_streams`` skips a degraded peer and moves its
   16 streams to the healthy one with no token lost; the force knob
   forces evacuating and clearing it recovers; (d) a served StreamingLM
   behind the gateway: ``/debug/engine?detail=1`` (one record a chunk,
   ``kernel_active`` 1), ``/debug/traces`` (the gen.* spans under the
   request span), ``/debug/knobs``, ``/debug/telemetry``, ``/metrics``
   (``seldon_tpu_engine_*``, the chunk histogram's ``_count`` = chunks),
   an OpenMetrics scrape with a trace exemplar, ``/debug/request/{puid}``
   (the capture's tokens = the served row), ``tools/replay.py`` bit for
   bit, the cost tags; K4 exactly layers x decode calls on every engine;
23. the non-paged generation lane at the generation config (ROADMAP
   A8.12): (a) float32 with TF32 off, 16 prompts of 128 tokens, 64 new:
   the ``Generator``'s greedy ids equal the ``PagedEngine``'s on the same
   weights (K4 exactly layers x decode calls); (b) ``GENERATIVE_LM``
   served over REST in bf16 and int8 on the weights of
   ``load_lm_params("", LM_CONFIG, 0)``: one 16x128 request returns 16x64
   ids in the vocabulary, at least 75% of rows equal to an in-process
   ``Generator`` of the same weights, and a seeded sampled request
   repeats its ids; (c) decode tokens/s of the ``Generator`` and the
   pool-chunk ``PagedEngine`` in turns (3 pairs), the bf16 cache's bytes
   and a profile of one decode step (device time, idle share, device
   events a step);
24. the MLP and detection families and the pool's capacity accounting
   (A9, A8.13): (a) ``detector_resnet50`` at 512x512 served in bf16 with
   ``normalize``: a uint8 batch of 8 and 8 concurrent singles answer
   (B, 50, 6) finite rows whose scores are within 2e-2 of an in-process
   server of the same weights, the server's K1 launches equal its
   batches, K1 bit for bit and timed at (8, 512, 512, 3) and (1, 512,
   512, 3) beside its bound and ``torch.addcmul``; ``mlp`` served in
   float32 within 1e-6 of in-process; (b) a bf16 and an int8
   ``PagedEngine``'s pool bytes (K/V pools and scale tables) equal
   ``paged_hbm_accounting`` at ``split_tile_pad=1.0`` plus the trash
   page; the peak memory of one ring chunk beside the accounting's
   working set (recorded).

The first line names the card, torch, CUDA and ``grpc.__version__``.
Output: the ``nvidia-smi`` line, then one ``{"kernels": [...]}`` line,
then the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, when CUDA is unavailable or the port is not beside
this script.
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import random
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL_PARAMS = [
    {"name": "model", "value": "resnet50", "type": "STRING"},
    {"name": "normalize", "value": "true", "type": "BOOL"},
    {"name": "dtype", "value": "bfloat16", "type": "STRING"},
    {"name": "max_batch_size", "value": "32", "type": "INT"},
]
IMG = (224, 224, 3)
NUM_CLASSES = 1000
SEED = 0
LATENCY_REQUESTS = 200          # p99 rests on the 2 slowest (600 before phase 19, 300 before PR 18's cut)
THROUGHPUT_CLIENTS = 4
THROUGHPUT_SECONDS = 2.0       # 5 s until phase 19 joined the time limit, 3 s until phase 22
# tolerances, stated before any run
SERVED_VS_LOCAL_REL_L2 = 2e-2   # each bf16 served row vs in-process bf16, same weights
CROSS_ROW_MIN_REL_L2 = 2 * SERVED_VS_LOCAL_REL_L2  # two images' answers must differ by more
WHOLE_PATH_REL_L2 = 5e-2        # bf16 + kernel vs f32 + plain, same weights
WHOLE_PATH_MIN_COS = 0.99
# the generation cell: the repo's generation serving config (bench.py
# generation phase, docs/architecture.md: B=16, d512/L8, vocab 16k)
LM_CONFIG = dict(vocab_size=16384, d_model=512, num_layers=8, num_heads=8, max_len=1024)
LM_ENGINE = dict(page_size=64, max_slots=16, steps_per_call=8)
LM_MAX_NEW = 64
LM_PARAMS = [{"name": k, "value": str(v), "type": "INT"}
             for k, v in {**LM_CONFIG, **LM_ENGINE, "max_new_tokens": LM_MAX_NEW}.items()]
# phases 7-17 measure the engine without the prefix cache (on by default
# since phase 18's slice, as in the JAX package): phase 7's windows repeat
# prompts, and a hit would change what they measure
NO_PREFIX_CACHE = dict(prefix_cache=False)
NO_PREFIX_CACHE_ENV = {"SELDON_TPU_PREFIX_CACHE": "0"}
# the ViT cell: the JAX registry's vit_base16 (ViT-Base/16, Dosovitskiy et al.
# 2020, Table 1) served with flash attention
VIT_PARAMS = [
    {"name": "model", "value": "vit_base16", "type": "STRING"},
    {"name": "normalize", "value": "true", "type": "BOOL"},
    {"name": "dtype", "value": "bfloat16", "type": "STRING"},
    {"name": "max_batch_size", "value": "32", "type": "INT"},
    {"name": "model_kwargs", "value": json.dumps({"attention": "flash"}), "type": "JSON"},
]
VIT_LAYERS = 12
VIT_LATENCY_REQUESTS = 150       # 500 before phase 19 joined the time limit, 250 before phase 22
FLASH_CASES = [  # (B, L, H, D, dtype name, causal, strided qkv views)
    (32, 197, 12, 64, "bfloat16", False, False),
    (32, 197, 12, 64, "bfloat16", False, True),
    (4, 1024, 8, 64, "bfloat16", True, False),
    (2, 50, 2, 16, "float32", False, False),
    (2, 50, 2, 16, "float32", True, False),
    (1, 1, 1, 8, "float32", False, False),
    (1, 1, 1, 8, "float32", True, False),
    (2, 197, 4, 128, "bfloat16", False, False),
    (2, 130, 3, 40, "float16", True, False),
    (2, 77, 4, 96, "bfloat16", False, False),   # a scale that is not a power of two
]
FLASH_F32_REL_TOL = 1e-5        # largest |kernel - plain| / largest |plain|
FLASH_STEP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}  # one step of the format, relative
LM_FLASH_ATOL = 1e-4            # f32 logits, causal K3 vs plain attention
BF16_PEAK_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores (data sheet)
RAGGED_LENGTHS = [0, 1, 63, 64, 65, 127, 128, 200, 333, 511, 512, 640, 777, 900, 1000, 1024]
PAGED_CASES = [  # (lanes, heads, head_dim, page_size, table pages, lengths)
    (16, 8, 64, 64, 16, RAGGED_LENGTHS),
    (5, 2, 16, 8, 6, [0, 1, 8, 9, 48]),
]
K1_DESIGN = ("one 16-byte vector a thread, the grid's threads a multiple of lcm(16, C) / 16 so a thread's channel "
             "phase is fixed (C = 1, 3, 4 at compile time: scale and shift in registers), two loads in flight before "
             "the arithmetic, each warp store writing whole 32-byte sectors (lane pairs trade halves), L2 evict_first "
             "in / evict_last out, one wave sized from the occupancy")
PAGED_REL_TOL = 1e-4            # largest |kernel - plain| over finite entries / largest |plain|
PAGED_DESIGN = ("one launch: a block a (lane, chunk of pages, head group), cp.async into an mbarrier ring, "
                "the lane's chunks merged by its last block")
GEN_MIN_IDENTICAL_SHARE = 0.75  # concurrent served rows equal to the in-process rows
GEN_LATENCY_REQUESTS = 16       # too few for a p99: the line prints p50 and the largest (MIN_P99_SAMPLES)
GEN_CLIENTS = 16
GEN_SECONDS = 2.0              # 5 s until phase 19 joined the time limit, 3 s until phase 22
F32_PEAK_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores (data sheet)
# the quantised multi-adapter cell: the generation config with an int8 KV
# pool and two rank-8 adapters (the JAX package's default rank)
LORA_RANK = 8
LM_ADAPTERS = {"a1": {"seed": 1}, "a2": {"seed": 2}}
Q_LM_PARAMS = LM_PARAMS + [
    {"name": "max_adapters", "value": "2", "type": "INT"},
    {"name": "lora_rank", "value": str(LORA_RANK), "type": "INT"},
    {"name": "adapters", "value": json.dumps(LM_ADAPTERS), "type": "JSON"},
]
Q_WAVE_NEW = 32                 # phase 11: new tokens of the one-wave == alone check (LM_MAX_NEW until phase 22)
#                                 and of the concurrent served rows against each prompt alone (since phase 25)
Q_LATENCY_REQUESTS = 16         # p50 and the largest, as GEN_LATENCY_REQUESTS
# (impl, int8 pages, fold) -> the JAX kernel it replaces
PAGED_VARIANTS = [("stream", True, False), ("grid", True, False), ("stream", False, True), ("stream", True, True)]
VARIANT_REPLACES = {
    ("stream", True, False): "seldon_core_tpu/ops/kernels.py:409 (quantized=True)",
    ("grid", True, False): "seldon_core_tpu/ops/kernels.py:343 (quantized=True)",
    ("stream", False, True): "seldon_core_tpu/ops/kernels.py:409 (fold_lora=True)",
    ("stream", True, True): "seldon_core_tpu/ops/kernels.py:409 (quantized=True, fold_lora=True)",
}
LORA_SLOTS = 3                  # the zero adapter and two adapters
DELTA_REL_TOL = 1e-5            # largest |kernel delta - plain| / largest |plain delta|
INT8_MIN_AGREEMENT = 0.75       # int8 vs native greedy tokens (tests/test_paged_kernel_lane.py's bound)
# K2 (int8_matmul): (M, K, N, x dtype, what the shape is)
K2_CASES = [
    (6304, 768, 3072, "bfloat16", "ViT-B/16 MLP fc1 at batch 32"),
    (32, 2048, 1000, "bfloat16", "ResNet-50 head at batch 32"),
    (16, 512, 1536, "float32", "the LM's qkv at 16 lanes"),
    (5, 16, 10, "float32", "ragged"),
    (100, 300, 70, "float32", "ragged"),
    (197, 768, 2304, "float16", "ViT-B/16 qkv of one image, f16"),
    (1, 768, 3072, "bfloat16", "ViT-B/16 MLP fc1, one row"),
]
K2_TIMED = 3                    # the first three cases are timed
K2_F32_REL_TOL = 1e-5           # largest |kernel - plain| / largest |plain|
K2_FLUSH_MB = 4096              # the L2 flush before each timed K2 launch
TIMING_SLEEP_CYCLES = 1_000_000  # GPU spin before each timed call: ~0.5 ms at the H100's 1.98 GHz boost clock
# the precision lanes: the phase 4 configuration with precision=...
PRECISIONS = ("int8w", "w8a8")
PRECISION_KERNELS = 54          # ResNet-50 kernels the surgery quantises (JAX's rule: the stem too)
W8A8_LAYERS = 52                # block and shortcut convs of ResNet-50: one integer GEMM each a forward
PRECISION_LATENCY_REQUESTS = 100  # 300 before phase 19 joined the time limit, 150 before phase 22
# phase 13, the gateway: the JAX headline's method (bench.py:1296-1345)
GRPC_PARAMS = MODEL_PARAMS + [{"name": "max_wait_ms", "value": "1.0", "type": "FLOAT"}]
GRPC_SECONDS = 3.0              # the latency window; throughput: three windows of a third (10 s to phase 19, 5 to 22)
GRPC_SEQUENTIAL_SECONDS = 2.0   # one client before the windows: service time without queueing (3 s until phase 19)
NATIVE_GRPC_SECONDS = 5.0       # 14a, the headline: the latency window of 4 clients (10 s until phase 22)
MIN_P99_SAMPLES = 100           # a p99 is printed over at least this many samples; fewer print their largest
READY_POLL_S = 0.2              # how often a starting server is asked whether it is ready
GRPC_LAT_CLIENTS = 4            # batch-1 requests
GRPC_TPUT_CLIENTS = 8           # batch-32 requests
GRPC_TPUT_WINDOWS = 3
HEADLINE_P50_MS = 10.0          # BASELINE.json: ResNet-50 gRPC p50 < 10 ms
MAB_REQUESTS = 50
COMBINER_REQUESTS = 50
# phase 14, the native ingress: the JAX headline's own method (bench.py:1281-1345), then bench.py's C++
# clients (native_model_phase, bench.py:835-960)
NATIVE_LOAD_SECONDS = 1.5       # bench.py's 6 s / 4: three windows of a third at (8, 1), one each deeper (3 s to 22)
NATIVE_SEQUENTIAL_SECONDS = 1.5  # 14c: one connection, batch 1, before the windows (3 s until phase 22)
NATIVE_LOAD_DEPTHS = ((8, 4), (8, 8), (8, 12))  # (connections, requests in flight on each)
NATIVE_BATCH_THREADS = (4, 48)  # 14c at each: the ingress default is one, bench.py's BENCH_NATIVE_BATCH_THREADS 48
NATIVE_CONTAINER_ROWS = (1, 2, 5)  # one multi-frame container, one micro-batch
# phase 15, A4 on the card: the request contract on every ingress of the deployment
TLS_DIR = os.path.join(ROOT, "tests", "data", "torch_port_tls")  # test-only CA and server certificate
A4_OAUTH = ("chip-smoke-client", "chip-smoke-secret")  # test-only client credentials of the gateways
A4_DEADLINE_MS = "10000"
A4_FEATURES = ("tls", "auth", "tracing", "observer")  # what an A4 gateway child puts on
A4_WINDOWS = 2                  # windows of each gateway, in turns: on, off, off, on
A4_SECONDS = 2.0                # 15a's 4-client windows (10 s until PR 13, 5 s until phase 19, 3 s until phase 22)
A4_TRACED_REQUESTS = 8          # 15b: requests whose spans are followed across the two processes
# phase 16, A2.2 on the card: breakers, failover, fallback and hedging on replicated ResNet-50
A22_ANNOTATIONS = {"seldon.io/breaker-failures": "5", "seldon.io/breaker-reset-ms": "1000"}
A22_RESET_S = 1.0               # the breaker-reset-ms above
A22_PROBE_SLACK_S = 2.0         # one probe: a fresh channel's connect and a batch-1 forward on a new process
A22_SECONDS = 4.0               # 16a and 16b windows of 4 sync-gRPC clients (10 s before phase 19, 5 s before 22)
A22_CLIENTS = 4
A22_SPLIT_TOL = 0.05            # each replica serves 50% +- 5% of 16a's requests
A22_SEQUENTIAL = 50             # 16d: sequential requests healthy, then with the primary killed
A22_HEDGE_P90_SECONDS = 2.0     # 16e: the unhedged window whose p90 is seldon.io/hedge-ms (5 s to phase 19, 3 to 22)
A22_HEDGE_SECONDS = 1.5         # 16e's off / on / on / off windows (10 s to PR 13, 5 s to phase 19, 3 to 22)
# phase 17, A5 and A6 on the card: model_uri checkpoints and a second ViT resolution
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_orbax")  # resnet_tiny, StandardCheckpointer
ORBAX_LOGITS_TOL = 1e-4         # float32, TF32 off: rtol = atol against the JAX server's logits
CKPT_LM_SEED = 7                # 17b's weights (the served StreamingLM's own seed is 0)
CKPT_ADAPTER_SEED = 5
CKPT_PROMPTS = (20, 65, 128, 333)  # 17b: prompt lengths, each sent alone
CKPT_MAX_NEW = 16
VIT_384 = (384, 384, 3)         # ViT-B/16's second signature: 24 x 24 patches + the class token = 577 tokens
VIT_MULTI_PARAMS = [p for p in VIT_PARAMS if p["name"] != "model_kwargs"] + [
    {"name": "model_kwargs", "value": json.dumps({"attention": "flash", "pos_grid": 14}), "type": "JSON"},
    {"name": "input_shape", "value": json.dumps(list(IMG)), "type": "JSON"},
    {"name": "extra_input_shapes", "value": json.dumps([list(VIT_384)]), "type": "JSON"},
]
INT8W_VS_BF16_REL_L2 = 5e-2     # int8w lane vs the bf16 lane on the same weights
INT8W_VS_BF16_MIN_COS = 0.99
W8A8_MIN_TOP1 = 0.8             # w8a8 vs bf16 top-1 agreement (tests/test_w8a8.py's bar)
# phase 18, the generation scheduler and precision lanes at the generation config
SCHED_DEVICE = "cuda"
SCHED_PROMPT = 128              # 18a, 18d: prompt tokens (16 prompts, LM_MAX_NEW new)
SCHED_RATE_REPS = 2             # 18a: decode-rate turns per lane (bf16, int8w, w8a8, then reversed)
# 7, 11, 18a, 19c: prompts sent one by one (short, a page, a page and one, ten pages; eight lengths until
# phases 25-26 joined the time limit)
SEQUENTIAL_PROMPTS = (20, 64, 65, 640)
SCHED_REST_PROMPTS = SEQUENTIAL_PROMPTS  # 18a: the served w8a8 rows, sent one by one
SCHED_SYSTEM = 256              # 18b: the shared system prompt (the JAX bench's shared-prefix shape)
SCHED_SUFFIX = (16, 64)         # 18b: distinct suffix tokens, inclusive
SCHED_TIGHT_PAGES = 1 + 16 * 3  # 18c: the shrunk pool
SCHED_TIGHT_PROMPT = (150, 190)  # 18c: 3 pages a prompt, a 4th to grow into
SCHED_MAX_STEPS = 32            # 18c: max_steps_per_call
SCHED_QUEUE = 16                # 18d: max_queue
SCHED_SUBMITS = 48              # 18d: 16 to fill the slots, then 32 of priority 0 and 2
SCHED_SHORT_DEADLINE_S = 0.05   # 18d: a deadline that runs out in the queue
SCHED_BUDGET = 512              # 18e: chunk_token_budget
SCHED_LONG = 900                # 18e: the long prompts' tokens (4 of them beside 12 decoding streams)
SCHED_LONG_NEW = 16
SCHED_SHORT_NEW = 128
W8A8_LM_PARAMS = LM_PARAMS + [
    {"name": "precision", "value": "w8a8", "type": "STRING"},
    {"name": "max_queue", "value": "64", "type": "INT"},
    {"name": "chunk_token_budget", "value": str(SCHED_BUDGET), "type": "INT"},
]
# phase 19, the ring chunk, the length-bucketed split and token streaming at the generation config
RING_PROMPT = 128               # 19a: 16 prompts of 128 tokens, LM_MAX_NEW new
RING_SYSTEM = 128               # 19a: the shared prefix of the prefix-hit run (two pages)
RING_RATE_REPS = 2              # 19a / 19b: timed turns a lane (a, b, b, a)
SPLIT_SHORT, SPLIT_LONG = 64, 768  # 19b: 8 prompts of each
STREAM_PROMPTS = SEQUENTIAL_PROMPTS  # 19c: the sequential requests a lane
STREAM_CONCURRENT = 4           # 19c: concurrent streams a lane
STREAM_DROP_NEW = 512           # 19c: the budget of a stream whose client drops after its first chunk
STREAM_FREE_S = 2.0             # 19c: the slot and pages of a dropped stream are free within this
STREAM_QUEUE = 4                # 19c: the served component's max_queue (the shed check fills it)
# phase 20, speculative decoding at the generation config (the JAX bench's
# method, bench.py:2391-2500)
SPEC_SLOTS = 4                  # 20a: the bench's spec_batch
SPEC_NEW = 64                   # 20a-c: new tokens a stream (the bench's spec_new)
SPEC_ECHO = 160                 # 20a, 20c: echo prompts cut to their last 160 tokens
SPEC_DRAFT_K = 4                # 20a-c: drafts a round (the bench's draft_k)
SPEC_DRAFT_LAYERS = 2           # 20b: the draft model's depth (d512, 8 heads, the target's vocabulary)
SPEC_GEN_PROMPT = 128           # 20b: the one echo prompt's tokens (a 64-token ramp and its continuation)
SPEC_RATE_REPS = 2              # 20c: timed turns a lane (plain, ngram, ngram, plain)
# phase 21, drain, migration and the KV tier (the JAX bench's methods,
# bench.py:2129-2265 and 2884-2960)
MIG_STREAMS = 16                # 21a: streamed requests (the generation config's slots)
MIG_PROMPT = 128                # 21a, 21c: prompt tokens
MIG_NEW = 64                    # 21a: new tokens a stream
MIG_WAVES = 3                   # 21a: waves on engine A before the evacuation or the drain
TIER_HIST = 512                 # 21b: a returning session's tokens
TIER_NEW = 4                    # 21b: new tokens a revisit
TIER_ROUNDS = 4                 # 21b: revisits of both sessions; the walls of rounds 2 on are timed
SERVED_REQUESTS = 24            # 21c: 16 decoding and 8 queued when A is SIGTERMed
SERVED_NEW = 512                # 21c: new tokens a request (still decoding at the signal)
# phase 22, generation telemetry and chaos (ROADMAP A8.11)
TELE_STREAMS = 16               # 22a-c: lanes (the generation config's slots)
TELE_PROMPT = 128               # 22a-d: prompt tokens
TELE_NEW = 64                   # 22a, 22b: new tokens a stream
TELE_LONG_NEW = 128             # 22b alloc, 22c: new tokens a stream (page growth past the prompt's third page)
TELE_QUEUED = 8                 # 22b chunk fault: streams queued behind the faulted chunk's 16
TELE_RATE_REPS = 2              # 22a: timed turns a lane (on, off, off, on)
WD_WINDOW = 4                   # 22c: SELDON_TPU_WATCHDOG_WINDOW (waves)
WD_BREACHES = 2                 # 22c: SELDON_TPU_WATCHDOG_BREACHES
WD_COLD_CEILING_MS = 200.0      # 22c: the cold engine's ceiling (below a first-use nvcc build, above a warm chunk)
TELE_SERVED_REQUESTS = 4        # 22d: sequential requests through the gateway
# phase 23, the non-paged generation lane (ROADMAP A8.12)
GLM_COMPONENT = "seldon_core_tpu_torch.models.generate.GenerativeLM"
GLM_ROWS = 16                   # 23a-c: one request of 16 equal-length prompts
GLM_PROMPT = 128                # 23a-c: prompt tokens
GLM_NEW = LM_MAX_NEW            # 23a-c: new tokens
GLM_RATE_PAIRS = 3              # 23c: Generator / PagedEngine (pool chunk) turns: g e, e g, g e
GLM_SAMPLE_TAGS = {"seed": 23, "temperature": 0.8, "top_k": 40}  # 23b: the repeated sampled request
GLM_PROFILE_NEW = 17            # 23c: the profiled run's new tokens (16 steps past the first)
# phase 24, the MLP and detection families (A9) and the pool's capacity accounting (A8.13)
CUDA_COMPONENT = "seldon_core_tpu_torch.models.cudaserver.CudaServer"
DET_MODEL = "detector_resnet50"
DET_SIZE = 512                  # 24a: the registry's default input, 512 x 512 x 3
DET_BATCH = 8                   # 24a: a batch of 8, then 8 concurrent singles
DET_TOP_K = 50                  # 24a: rows a detector answers (the registry's default top_k)
DET_SCORE_TOL = 2e-2            # 24a: |served - in-process| of each row's score, bf16 (a k-th largest moves by
#                                 no more than the map does, so the sorted scores are continuous in the map)
MLP_ROWS = 8                    # 24a: one float32 request of 8 rows
MLP_TOL = 1e-6                  # 24a: served mlp rows vs in-process, float32, the same bucket
# phase 25, disaggregated prefill/decode (ROADMAP A10) at the generation config
DISAGG_ROWS = 16                # 25a-e: prompts (the generation config's slots)
DISAGG_PROMPT = 128             # 25a-e: prompt tokens
DISAGG_NEW = LM_MAX_NEW         # 25a-e: new tokens a stream
DISAGG_WORKERS = 2              # 25a, 25e: in-process prefill engines
DISAGG_RATE_PAIRS = 2           # 25e: timed turns a lane (unified, disaggregated, disaggregated, unified)
DISAGG_DEADLINE_MS = 1.0        # 25d: a deadline no predicted prefill + decode fits
# phase 26, the graph components, the prepackaged servers and request logging (ROADMAP A11)
GUARD_ROWS = 64                 # 26a: rows a request through the outlier-guarded mlp
GUARD_SHIFT = 10.0              # 26a: the shifted batch's offset (far outside the normal rows)
GUARD_TOL = 1e-6                # 26a: served mlp rows vs in-process, float32
VAE_ROWS, VAE_FEATURES = 4096, 32  # 26b: the VAE's training rows and features
VAE_EPOCHS = 10                 # 26b: full passes of batch 128
IFOREST_TREES, IFOREST_SUBSAMPLE = 100, 256  # 26b: the JAX detector's defaults
DETECTOR_TOL = 1e-5             # 26b: card scores vs the plain CPU scoring, relative to the largest score
IG_STEPS = 16                   # 26c: integrated-gradients path points
IG_REL_L2 = 2e-2                # 26c: served attributions vs in-process, bf16
SHAP_SAMPLES = 64               # 26d: kernel SHAP's coalitions on the mlp's 4 features (2^4 - 2 = 14: exact)
SHAP_TOL = 1e-4                 # 26d: the efficiency axiom and the card against the CPU, float32
TORCHSCRIPT_ROWS = 4            # 26e: images a TORCH_SERVER request
TORCHSCRIPT_REL_L2 = 2e-2       # 26e: served rows vs the in-process ResNet50, bf16
XGB_TREES, XGB_DEPTH, XGB_FEATURES, XGB_ROWS = 200, 6, 16, 512  # 26f: the JSON booster
LOGGED_REQUESTS = 8             # 26g: requests through a JSONL pair logger


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class PhaseClock:
    """Wall seconds of each phase, logged as it ends: where the smoke's
    time limit goes."""

    def __init__(self):
        self.seconds = {}
        self.t = time.perf_counter()

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self.t
        self.t = now
        log(f"{phase}: {self.seconds[phase]:.1f} s of wall time")


class EarlyServers:
    """The server processes of later phases, launched together while the
    kernels build and awaited before the first timed phase: no phase then
    waits on a load, and no load runs beside a timed window.  A launch
    function returns its phase's context: ``procs``, ``logfile``,
    ``logpath``, ``launched`` and ``ready()``, which blocks until every
    process answers; the phase takes it by name, or launches anew when it
    is not there.  ``stop()`` ends what no phase took (one failed first)."""

    def __init__(self):
        self.slots = {}

    def launch(self, name: str, launch) -> None:
        ctx = dict(launch(), early=True)
        # below the kernels' nvcc: every early server waits on that build, and
        # the loading processes on the host's cores otherwise slow it down
        renice(ctx["procs"], EARLY_NICE)
        self.slots[name] = ctx

    def ready(self, torch, card) -> None:
        t0 = time.perf_counter()
        for ctx in self.slots.values():
            ctx["ready"]()
            ctx["ready_s"] = time.perf_counter() - ctx["launched"]
        # back to the smoke's own priority before any timed phase
        restored = renice([p for ctx in self.slots.values() for p in ctx["procs"]], 0)
        log(f"early servers niced to {EARLY_NICE} while the kernels built; {restored[0]} threads back to 0"
            + (f", {restored[1]} could not be" if restored[1] else ""))
        for ctx in self.slots.values():
            ctx["idle_from"] = (time.perf_counter(), cpu_seconds(ctx["procs"]))
        free, total = torch.cuda.mem_get_info()
        with open("/proc/meminfo") as f:
            avail = next(int(line.split()[1]) for line in f if line.startswith("MemAvailable:")) / 2 ** 20
        procs = sum(len(ctx["procs"]) for ctx in self.slots.values())
        each = ", ".join("%s %.1f s" % (name, ctx["ready_s"]) for name, ctx in self.slots.items())
        log(f"early servers: {procs} processes of {len(self.slots)} phases ({each} after their launch), "
            f"awaited {time.perf_counter() - t0:.1f} s past the build; card memory in use "
            f"{(total - free) / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB, host memory available {avail:.1f} GiB "
            f"[{card}]")

    def take(self, name: str, launch) -> dict:
        ctx = self.slots.pop(name, None)
        if ctx is None:
            return launch()
        if "idle_from" in ctx:  # what the waiting processes cost the phases before this one
            t, cpu = ctx["idle_from"]
            log(f"early servers of {name}: {len(ctx['procs'])} processes idle {time.perf_counter() - t:.1f} s "
                f"since ready used {cpu_seconds(ctx['procs']) - cpu:.2f} CPU s")
        return ctx

    def stop(self) -> None:
        for ctx in self.slots.values():
            for proc in ctx["procs"]:
                stop_server(proc)
            ctx["logfile"].close()
            ctx.get("cleanup", lambda: None)()
        self.slots.clear()


EARLY = EarlyServers()
EARLY_NICE = 10


def renice(procs, value: int):
    """Every thread of ``procs`` to niceness ``value`` (threads started
    later inherit their starter's); returns (threads set, threads refused)."""
    done = refused = 0
    for proc in procs:
        try:
            tids = os.listdir(f"/proc/{proc.pid}/task")
        except OSError:  # the process has exited
            continue
        for tid in tids:
            try:
                os.setpriority(os.PRIO_PROCESS, int(tid), value)
                done += 1
            except ProcessLookupError:  # the thread has exited
                pass
            except PermissionError:
                refused += 1
    return done, refused


def cpu_seconds(procs) -> float:
    """User + system CPU seconds the processes have used (``/proc``)."""
    total = 0.0
    for proc in procs:
        try:
            with open(f"/proc/{proc.pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            total += (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
        except (OSError, IndexError, ValueError):
            pass
    return total


def ready_since(ctx) -> float:
    """Seconds from a context's launch to its readiness: as awaited before
    the first timed phase when it launched early, else until now."""
    return ctx.get("ready_s", time.perf_counter() - ctx["launched"])


def early_note(ctx) -> str:
    return " (launched early with the other phases' servers)" if ctx.get("early") else ""


def server_context(prefix: str, **start):
    """One microservice CLI on a free port (``start_server``'s arguments)."""
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    fd, logpath = tempfile.mkstemp(prefix=prefix, suffix=".log")
    logfile = os.fdopen(fd, "w")
    launched = time.perf_counter()
    proc = start_server(port, logfile, **start)
    return {"procs": [proc], "logfile": logfile, "logpath": logpath, "launched": launched, "port": port,
            "base": base, "ready": lambda: wait_ready(proc, base, logpath)}


# ---------------------------------------------------------------- phase 1

def card_report(torch, grpc):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    # HBM is double data rate: bytes/s = 2 * clock * bus width / 8
    mem_bytes_per_s = 2.0 * props.memory_clock_rate * 1e3 * props.memory_bus_width / 8
    log(f"card: {smi_line} | torch: {name} | {props.multi_processor_count} SMs | "
        f"memory {mem_bytes_per_s / 1e12:.3f} TB/s (clock {props.memory_clock_rate} kHz, "
        f"bus {props.memory_bus_width} bit) | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"grpc {grpc.__version__}")
    return smi_line, name, mem_bytes_per_s


# ---------------------------------------------------------------- timing

def time_cuda(torch, fn, reps: int = 100, warm: int = 5, flush_mb: int = 256) -> float:
    """Median ms of one call, CUDA events around each, L2 flushed before
    each by a ``flush_mb`` write.  Between the flush and the start event
    the GPU spins for ``TIMING_SLEEP_CYCLES`` (``torch.cuda._sleep``),
    longer than a wrapper's host work, so the host has enqueued ``fn``
    before the start event fires and host time stays out of the span."""
    flush = torch.empty(flush_mb * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        torch.cuda._sleep(TIMING_SLEEP_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


# ---------------------------------------------------------------- phase 3

def kernel_checks(torch, np, kernels, mem_bytes_per_s, launch_only):
    shapes = [(32, *IMG), (1, *IMG), (3, 5, 7, 1), (2, 9, 11, 4), (1, 5, 7, 3), (3, 5, 7, 4), (2, 3, 5, 5),
              (1, 1, 5, 3), "misaligned"]
    dtypes = [torch.bfloat16, torch.float16, torch.float32]
    bits = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    inputs = {}
    for shape in shapes:
        view = shape == "misaligned"
        if view:  # (2, 7, 9, 3) one byte past a 16-byte boundary
            shape = (2, 7, 9, 3)
        c = shape[-1]
        if c == 3:
            scale, shift = kernels.imagenet_affine()
        else:
            scale = rng.uniform(0.001, 0.05, c).astype(np.float32)
            shift = rng.uniform(-2.0, 1.0, c).astype(np.float32)
        n = int(np.prod(shape))
        x = torch.from_numpy(rng.integers(0, 256, n + view, dtype=np.uint8)).cuda()[int(view):].view(shape)
        check(bool(x.data_ptr() % 16) == view, f"fused_normalize {shape}: the input's alignment is not the case's")
        s, b = torch.from_numpy(scale).cuda(), torch.from_numpy(shift).cuda()
        inputs[shape] = (x, s, b)
        what = f"{shape}{' misaligned' if view else ''}"
        for dt in dtypes:
            got = kernels.fused_normalize(x, s, b, dt)
            ref = kernels.fused_normalize_reference(x, s, b, dt)
            torch.cuda.synchronize()
            check(got.shape == x.shape and got.dtype == dt and got.is_contiguous(),
                  f"fused_normalize {what} {dt}: bad output {tuple(got.shape)} {got.dtype}")
            same = torch.equal(got.view(bits[dt]), ref.view(bits[dt]))
            err = (got.float() - ref.float()).abs().max().item()
            max_err = max(max_err, err)
            log(f"fused_normalize {what} -> {str(dt)[6:]}: bit-identical={same} max_abs_err={err}")
            check(same, f"fused_normalize {what} {dt} differs from its plain version (max {err})")

    timings = {}
    for batch in (32, 1):
        timings[batch] = k1_timing(torch, kernels, *inputs[(batch, *IMG)], mem_bytes_per_s, launch_only)
    return max_err, timings


def k1_timing(torch, kernels, x, s, b, mem_bytes_per_s, launch_only=None):
    """K1 on uint8 ``x`` -> bf16: kernel, plain chain, ``torch.addcmul``
    and cast-copy times (``time_cuda``) beside the bound; the launch floor
    of K1's own grid when the ``launch only`` copy is given."""
    lib_out = torch.empty(x.shape, dtype=torch.bfloat16, device="cuda")

    def library():
        # one PyTorch call for the same function: shift + x * scale,
        # u8 promoted to f32, cast to bf16 on store
        torch.addcmul(b, x, s, out=lib_out)

    library()
    lib_err = (lib_out.float() - kernels.fused_normalize_reference(x, s, b, torch.bfloat16).float()
               ).abs().max().item()
    ms = time_cuda(torch, lambda: kernels.fused_normalize(x, s, b, torch.bfloat16))
    plain_ms = time_cuda(torch, lambda: kernels.fused_normalize_reference(x, s, b, torch.bfloat16))
    library_ms = time_cuda(torch, library)
    copy_ms = time_cuda(torch, lambda: lib_out.copy_(x))  # reads 1, writes 2 bytes an element
    launch_floor_ms = None
    if launch_only is not None:
        with launch_only:
            launch_floor_ms = time_cuda(torch, lambda: kernels.fused_normalize(x, s, b, torch.bfloat16))
    n = x.numel()
    bound_bytes = n * (1 + 2) + 2 * s.numel() * 4  # u8 in, bf16 out, scale+shift
    # 2 f32 flops per element; 67 TFLOP/s f32 (non-tensor-core) peak
    bound_ms = max(bound_bytes / mem_bytes_per_s, 2 * n / F32_PEAK_FLOPS) * 1e3
    geo = kernels.fused_normalize_grid(x, torch.bfloat16)
    floor = "" if launch_floor_ms is None else f"launch floor (same grid, kernels return at once) " \
                                              f"{launch_floor_ms * 1e3:.2f} us, "
    log(f"fused_normalize {tuple(x.shape)} u8->bf16: kernel {ms * 1e3:.2f} us on {geo.blocks} blocks of "
        f"{geo.threads}, {floor}out_bf16.copy_(x_u8) {copy_ms * 1e3:.2f} us, plain chain {plain_ms * 1e3:.2f} us, "
        f"torch.addcmul(out=bf16) {library_ms * 1e3:.2f} us (max abs diff from the plain version {lib_err}), bound "
        f"{bound_ms * 1e3:.2f} us ({bound_bytes} bytes; {bound_ms / ms * 100:.1f}% of the memory roofline)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "launch_floor_ms": launch_floor_ms, "copy_ms": copy_ms, "bytes": bound_bytes,
            "grid": [geo.blocks, geo.threads]}


# ---------------------------------------------------------------- phase 3b

@contextlib.contextmanager
def knob_env(**values):
    """Set SELDON_TPU_* knobs for a block (None unsets), then restore them."""
    before = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def paged_inputs(torch, np, B, h, hd, ps, P, lengths, dtype, seed):
    """q, pages, tables with random non-contiguous page ids, lengths."""
    rng = np.random.default_rng(seed)
    num_pages = B * P + 1
    pk = rng.standard_normal((num_pages, ps, h, hd), dtype=np.float32)
    pv = rng.standard_normal((num_pages, ps, h, hd), dtype=np.float32)
    q = rng.standard_normal((B, h, hd), dtype=np.float32) * 0.125
    tables = rng.permutation(np.arange(1, num_pages)).reshape(B, P).astype(np.int32)
    out = [torch.from_numpy(a).to(dtype).cuda() for a in (q, pk, pv)]
    return out + [torch.from_numpy(tables).cuda(), torch.tensor(lengths, dtype=torch.int32).cuda()]


def compare_flash_state(torch, got, ref, what):
    """-> (largest abs error, largest relative error) over acc, m, l."""
    worst_abs = worst_rel = 0.0
    for name, g, r in zip(("acc", "m", "l"), got, ref):
        check(g.shape == r.shape and g.dtype == torch.float32, f"{what} {name}: bad output {tuple(g.shape)}")
        check(not bool(torch.isnan(g).any()), f"{what} {name}: NaN in the kernel's output")
        special = torch.isinf(r) | (r == 0)
        check(bool(torch.equal(g[special], r[special])), f"{what} {name}: -inf/0 differ from the plain version")
        fin = ~special
        if bool(fin.any()):
            err = (g[fin] - r[fin]).abs().max().item()
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / r[fin].abs().max().item())
    return worst_abs, worst_rel


def lane_invariance(torch, kernels, impl, args, kw, what):
    """A lane's outputs, bit for bit, do not depend on what it is
    co-scheduled with: a repeated call, the lanes in reverse order, the
    even lanes alone (half the batch), and the odd lanes given other
    lengths, tables and adapter slots all give each lane the bits of the
    first call.  -> the number of comparisons made."""
    q, pk, pv, tables, lens = args
    B = q.shape[0]

    def call(sel=None, lens_=lens, tables_=tables, slots=None):
        sel = torch.arange(B, device=q.device) if sel is None else sel
        kw_ = dict(kw)
        if kw.get("lora") is not None:
            x, a, b, idx, q_scale = kw["lora"]
            kw_["lora"] = (x[sel], a, b, (idx if slots is None else slots)[sel], q_scale)
        with knob_env(SELDON_TPU_PAGED_KERNEL_IMPL=impl):
            out = kernels.paged_attention_decode(q[sel], pk, pv, tables_[sel], lens_[sel], **kw_)
        torch.cuda.synchronize()
        return out

    def same(got, lanes, label):
        for name, g, r in zip(("acc", "m", "l", "delta"), got, base):
            check(bool(torch.equal(g, r[lanes])), f"{what}: {label} changes a lane's {name} bits")

    base = call()
    every = torch.arange(B, device=q.device)
    same(call(), every, "a repeated call")
    rev = torch.flip(every, (0,))
    same(call(rev), rev, "reversing the lanes")
    even, odd = every[0::2], every[1::2]
    same(call(even), even, "half the batch")
    lens2, tables2 = lens.clone(), tables.clone()
    lens2[odd] = torch.roll(lens[odd], 1)
    tables2[odd] = torch.roll(tables[odd], 1, 0)
    slots = None
    if kw.get("lora") is not None:
        slots = kw["lora"][3].clone()
        slots[odd] = (slots[odd] + 1) % LORA_SLOTS
    other = call(lens_=lens2, tables_=tables2, slots=slots)
    same([t[even] for t in other], even, "other lengths, tables and adapter slots in the other lanes")
    return 4


def paged_bound(B, h, hd, ps, P, lengths, elt, mem_bytes_per_s):
    """Least time for one call: the live pages' K and V, q, the tables and
    lengths read once, acc/m/l written once, over the memory rate; the
    4 * len * h * hd flops over the f32 peak (far below)."""
    live = [min(max(n, 0), P * ps) for n in lengths]
    kv = sum(-(-n // ps) for n in live) * ps * h * hd * 2 * elt
    nbytes = kv + B * h * hd * elt + B * P * 4 + B * 4 + B * h * hd * 4 + 2 * B * h * 4
    flops = sum(4 * n * h * hd for n in live)
    return max(nbytes / mem_bytes_per_s, flops / F32_PEAK_FLOPS) * 1e3, nbytes


def paged_kernel_checks(torch, np, kernels, mem_bytes_per_s):
    errs = {impl: {"max_abs_err": 0.0, "max_rel_err": 0.0} for impl in ("stream", "grid")}
    for case, (B, h, hd, ps, P, lengths) in enumerate(PAGED_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_inputs(torch, np, B, h, hd, ps, P, lengths, dtype, seed=case)
            ref = kernels.paged_attention_decode_reference(*args, page_size=ps)
            for impl in ("stream", "grid"):
                with knob_env(SELDON_TPU_PAGED_KERNEL_IMPL=impl):
                    got = kernels.paged_attention_decode(*args, page_size=ps)
                torch.cuda.synchronize()
                what = f"paged_decode_{impl} B={B} h={h} hd={hd} ps={ps} P={P} {str(dtype)[6:]}"
                err_abs, err_rel = compare_flash_state(torch, got, ref, what)
                log(f"{what}: max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e} (limit {PAGED_REL_TOL})")
                check(err_rel <= PAGED_REL_TOL, f"{what} differs from its plain version: {err_rel}")
                e = errs[impl]
                e["max_abs_err"], e["max_rel_err"] = max(e["max_abs_err"], err_abs), max(e["max_rel_err"], err_rel)

    import torch.nn.functional as F

    B, h, hd, ps, P, lengths = PAGED_CASES[0]
    for dtype in (torch.bfloat16, torch.float32):
        args = paged_inputs(torch, np, B, h, hd, ps, P, lengths, dtype, seed=3)
        for impl in ("stream", "grid"):
            what = f"paged_decode_{impl} B={B} h={h} hd={hd} ps={ps} P={P} {str(dtype)[6:]}"
            n = lane_invariance(torch, kernels, impl, args, dict(page_size=ps), what)
            log(f"{what}: each lane bit-identical over {n} co-schedulings (repeat, reversed, B/2, other lanes "
                f"changed)")
    timings = {}
    for label, lengths in (("uniform512", [512] * B), ("ragged", RAGGED_LENGTHS)):
        q, pk, pv, tables, lens = paged_inputs(torch, np, B, h, hd, ps, P, lengths, torch.bfloat16, seed=7)
        T = P * ps
        mask = (torch.arange(T, device=lens.device)[None, :] < lens[:, None])[:, None, None, :]

        def library():
            # the closest PyTorch calls: gather the pages, then one fused
            # attention over the length mask (normalised output)
            gk = pk[tables].reshape(B, T, h, hd).transpose(1, 2)
            gv = pv[tables].reshape(B, T, h, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(q[:, :, None, :], gk, gv, attn_mask=mask, scale=1.0)

        row = {}
        for impl in ("stream", "grid"):
            with knob_env(SELDON_TPU_PAGED_KERNEL_IMPL=impl):
                row[impl] = time_cuda(torch, lambda: kernels.paged_attention_decode(q, pk, pv, tables, lens,
                                                                                     page_size=ps), flush_mb=1024)
        row["plain_ms"] = time_cuda(torch, lambda: kernels.paged_attention_decode_reference(
            q, pk, pv, tables, lens, page_size=ps), reps=20)
        row["library_ms"] = time_cuda(torch, library, flush_mb=1024)
        row["bound_ms"], row["bytes"] = paged_bound(B, h, hd, ps, P, lengths, 2, mem_bytes_per_s)
        timings[label] = row
        log(f"paged decode bf16 B={B} h={h} hd={hd} ps={ps} P={P} {label}: K4 stream {row['stream'] * 1e3:.2f} us, "
            f"K5 grid {row['grid'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, gather + SDPA (two calls, "
            f"normalised) {row['library_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us "
            f"({row['bytes']} bytes)")
    return errs, timings


# ---------------------------------------------------------------- phase 3c

@contextlib.contextmanager
def no_tf32(torch):
    """float32 matmuls and convolutions in full float32 for a block."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def flash_inputs(torch, np, B, L, H, D, dtype, strided, seed):
    """q, k, v on the card; `strided`: the three views of one qkv tensor."""
    rng = np.random.default_rng(seed)
    if strided:
        qkv = torch.from_numpy(rng.standard_normal((B, L, 3 * H * D), dtype=np.float32)).to(dtype).cuda()
        return [t.reshape(B, L, H, D) for t in qkv.split(H * D, dim=-1)]
    return [torch.from_numpy(rng.standard_normal((B, L, H, D), dtype=np.float32)).to(dtype).cuda()
            for _ in range(3)]


def flash_bound(B, L, H, D, causal, elt, mem_bytes_per_s):
    """Least time for one call: q, k, v read once and o written once over
    the memory rate, against the 4 * B * H * D flops per (query, live key)
    pair (L * (L + 1) / 2 pairs when causal) over the bf16 tensor-core
    peak; -> (ms, "bytes" or "operations", bytes, flops)."""
    nbytes = 4 * B * L * H * D * elt
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 4 * B * H * D * pairs
    t_bytes, t_ops = nbytes / mem_bytes_per_s, flops / BF16_PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def flash_check(torch, kernels, q, k, v, causal: bool, dt: str, what: str):
    """K3 against its plain version on one input (3c's bar) -> (max abs, rel) error."""
    got = kernels.flash_attention(q, k, v, causal=causal)
    ref = kernels.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == ref.dtype, f"{what}: bad output {tuple(got.shape)}")
    g, r = got.float(), ref.float()
    check(not bool(torch.isnan(g).any()), f"{what}: NaN in the kernel's output")
    err = (g - r).abs()
    peak = r.abs().max().item()
    rel = err.max().item() / peak
    if dt == "float32":
        ok, limit = rel <= FLASH_F32_REL_TOL, f"{FLASH_F32_REL_TOL} of max |plain|"
    else:
        step = FLASH_STEP[dt]
        ok = bool((err <= step * r.abs() + step * 2.0 ** -8 * peak).all())
        limit = f"one {dt} step, rtol {step}, floor {step * 2.0 ** -8:.3e} x max |plain|"
    log(f"{what}: max_abs_err={err.max().item():.3e} max|plain|={peak:.3e} rel={rel:.3e} ({limit})")
    check(ok, f"{what} differs from its plain version")
    return err.max().item(), rel


def flash_timing(torch, np, kernels, B, L, H, D, causal: bool, mem_bytes_per_s):
    """K3, its plain version and F.scaled_dot_product_attention timed in bf16
    beside the bound."""
    import torch.nn.functional as F

    q, k, v = flash_inputs(torch, np, B, L, H, D, torch.bfloat16, False, seed=7)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, L, D) views for the library call
    row = {
        "ms": time_cuda(torch, lambda: kernels.flash_attention(q, k, v, causal=causal)),
        "plain_ms": time_cuda(torch, lambda: kernels.flash_attention_reference(q, k, v, causal=causal)),
        "library_ms": time_cuda(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)),
        "shape": [B, L, H, D], "causal": causal,
    }
    row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = flash_bound(B, L, H, D, causal, 2,
                                                                                 mem_bytes_per_s)
    log(f"flash_attention bf16 {(B, L, H, D)} causal={causal}: kernel {row['ms'] * 1e3:.2f} us, plain "
        f"{row['plain_ms'] * 1e3:.2f} us, F.scaled_dot_product_attention {row['library_ms'] * 1e3:.2f} us, "
        f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {row['bytes']} bytes, "
        f"{row['flops']} flops; {row['bound_ms'] / row['ms'] * 100:.1f}% of the roofline)")
    return row


def flash_kernel_checks(torch, np, kernels, mem_bytes_per_s):
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    with no_tf32(torch):
        for case, (B, L, H, D, dt, causal, strided) in enumerate(FLASH_CASES):
            q, k, v = flash_inputs(torch, np, B, L, H, D, getattr(torch, dt), strided, seed=100 + case)
            what = f"flash_attention {(B, L, H, D)} {dt} causal={causal}{' qkv-split views' if strided else ''}"
            err_abs, rel = flash_check(torch, kernels, q, k, v, causal, dt, what)
            worst["max_abs_err"] = max(worst["max_abs_err"], err_abs)
            worst["max_rel_err"] = max(worst["max_rel_err"], rel)
        timings = {label: flash_timing(torch, np, kernels, *shape, mem_bytes_per_s)
                   for label, shape in (("serving", (32, 197, 12, 64, False)), ("causal", (4, 1024, 8, 64, True)))}
    return worst, timings


# ---------------------------------------------------------------- phase 4 + 6

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tls_context():
    """A client context trusting the repo's test CA (phase 15's listeners)."""
    import ssl

    return ssl.create_default_context(cafile=os.path.join(TLS_DIR, "ca.crt"))


def http(url: str, body=None, timeout: float = 120.0, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json", **(headers or {})})
    ctx = tls_context() if url.startswith("https:") else None
    with urllib.request.urlopen(req, timeout=timeout, context=ctx) as r:
        raw = r.read()
    return raw if url.endswith("/metrics") else json.loads(raw)


def raw_request(np, images):
    return {"data": {"rawTensor": {
        "shape": list(images.shape), "dtype": "uint8",
        "data": base64.b64encode(np.ascontiguousarray(images).tobytes()).decode("ascii"),
    }}}


def decode_logits(np, resp, rows: int):
    check("data" in resp and "rawTensor" in resp["data"], f"response carries no rawTensor: {str(resp)[:300]}")
    r = resp["data"]["rawTensor"]
    arr = np.frombuffer(base64.b64decode(r["data"]), dtype=np.dtype(r["dtype"])).reshape(r["shape"])
    check(arr.shape == (rows, NUM_CLASSES), f"expected ({rows}, {NUM_CLASSES}) logits, got {arr.shape}")
    check(bool(np.isfinite(arr).all()), "non-finite logits in a served answer")
    return arr


def metrics_values(text: bytes):
    out = {}
    for line in text.decode().splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def start_server(port: int, logfile, component: str = "seldon_core_tpu_torch.models.cudaserver.CudaServer",
                 params=MODEL_PARAMS, env=None):
    cmd = [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice", component, "--api", "REST",
           "--host", "127.0.0.1", "--http-port", str(port), "--parameters", json.dumps(params)]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=logfile, stderr=subprocess.STDOUT,
                            start_new_session=True, env=env)


def wait_ready(proc, base: str, logpath: str, timeout_s: float = 600.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if proc.poll() is not None:
            raise SmokeFailure(f"server exited with {proc.returncode}:\n{tail(logpath)}")
        try:
            status = http(base + "/health/status", timeout=5)
            if status.get("jsonData", {}).get("loaded"):
                return status["jsonData"], time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(READY_POLL_S)
    raise SmokeFailure(f"server not ready after {timeout_s}s:\n{tail(logpath)}")


def tail(path: str, n: int = 40) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-n:])


def stop_server(proc) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)


def pct(values, q: float) -> float:
    import math

    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def p99(values):
    """The p99 of at least MIN_P99_SAMPLES values, else None: the p99 of a
    few dozen is only their largest."""
    return pct(values, 0.99) if len(values) >= MIN_P99_SAMPLES else None


def tail_text(values, fmt: str = ".2f") -> str:
    """The tail of a latency list as a log line says it: its p99, or its
    largest value where there are too few for a p99."""
    if len(values) >= MIN_P99_SAMPLES:
        return f"p99 {pct(values, 0.99):{fmt}} ms"
    return f"max {max(values):{fmt}} ms ({len(values)} samples, too few for a p99)"


def distinct_images(np, rng, n: int, shape=IMG):
    """uint8 images that differ in per-channel level as well as in noise,
    so a random-weight model gives each a clearly different answer and a
    row served to the wrong request cannot pass the per-row check."""
    level = rng.integers(0, 160, (n, 1, 1, shape[-1]))
    noise = rng.integers(0, 96, (n, *shape))
    return (level + noise).astype(np.uint8)


def rel_l2(np, a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def concurrent(fn, n: int):
    """Run fn(i) for i < n on n threads at once; returns the results in
    order and re-raises the first failure."""
    results, errors = [None] * n, []

    def run(i):
        try:
            results[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — re-raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def served_rows_check(torch, np, kernels, resnet, base, rng):
    """A batch of 8 and 8 concurrent single images, every served row held
    against an in-process model with the server's weights."""
    eight = distinct_images(np, rng, 8)
    served_eight = decode_logits(np, http(base + "/predict", raw_request(np, eight)), 8)
    singles = distinct_images(np, rng, 8)
    answers = concurrent(lambda i: http(base + "/predict", raw_request(np, singles[i:i + 1])), 8)
    served_singles = np.concatenate([decode_logits(np, a, 1) for a in answers])

    # the server's weights in-process: the same seeded init, residual branches live
    local = resnet.ResNet50(num_classes=NUM_CLASSES, dtype=torch.bfloat16)
    local.reset_parameters(torch.Generator().manual_seed(SEED), zero_init_residual=False)
    local = local.cuda().eval().to(memory_format=torch.channels_last)
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    errs, cross = [], []
    for images, served in ((eight, served_eight), (singles, served_singles)):
        with torch.inference_mode():
            x = kernels.fused_normalize(torch.from_numpy(images).cuda(), scale, shift, torch.bfloat16)
            ref = local(x).double().cpu().numpy()
        errs += [rel_l2(np, served[i], ref[i]) for i in range(len(ref))]
        cross += [rel_l2(np, ref[i], ref[j]) for i in range(len(ref)) for j in range(len(ref)) if i != j]
    log(f"served vs in-process bf16, {len(errs)} rows (batch of 8 + 8 concurrent singles): max row rel L2 "
        f"{max(errs):.3e} (limit {SERVED_VS_LOCAL_REL_L2}); least rel L2 between two images' answers "
        f"{min(cross):.3e} (must exceed {CROSS_ROW_MIN_REL_L2})")
    check(min(cross) > CROSS_ROW_MIN_REL_L2,
          f"the test images' answers are too alike to tell a row mix-up apart: {min(cross)}")
    check(max(errs) <= SERVED_VS_LOCAL_REL_L2, f"served rows disagree with the in-process model: {errs}")
    return max(errs)


def latency_window(np, base, rng, n: int):
    """REST latency of n sequential single-image requests, in ms."""
    bodies = [raw_request(np, rng.integers(0, 256, (1, *IMG), dtype=np.uint8)) for _ in range(16)]
    for body in bodies:  # warm the client and server sides
        decode_logits(np, http(base + "/predict", body), 1)
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        decode_logits(np, http(base + "/predict", bodies[i % len(bodies)]), 1)
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def throughput_window(np, base, rng, clients: int, seconds: float):
    """img/s of batch-32 requests from `clients` closed-loop clients that
    send until `seconds` have passed; the in-flight requests finish and
    count, and the wall clock runs until the last one returns."""
    bodies = [raw_request(np, rng.integers(0, 256, (32, *IMG), dtype=np.uint8)) for _ in range(clients)]
    decode_logits(np, http(base + "/predict", bodies[0]), 32)  # warm the client side
    t0 = time.perf_counter()

    def client(k):
        n = 0
        while time.perf_counter() - t0 < seconds:
            decode_logits(np, http(base + "/predict", bodies[k]), 32)
            n += 1
        return n

    requests = sum(concurrent(client, clients))
    wall = time.perf_counter() - t0
    return requests * 32 / wall, requests, wall


def launch_main():
    return server_context("chip_smoke_server_")


def main_path(torch, np, kernels, resnet, card):
    rng = np.random.default_rng(SEED + 1)
    ctx = EARLY.take("main", launch_main)
    (proc,), base, logpath, logfile = ctx["procs"], ctx["base"], ctx["logpath"], ctx["logfile"]
    try:
        status, _ = wait_ready(proc, base, logpath)
        log(f"server ready in {ready_since(ctx):.1f}s{early_note(ctx)} (load {status['load_time_s']:.1f}s, buckets "
            f"{status['buckets']}, device {status['device_name']})")
        check(status["device"].startswith("cuda"), f"server is not on the card: {status['device']}")
        m0 = metrics_values(http(base + "/metrics"))
        before = status["kernel_launches"]

        served_err = served_rows_check(torch, np, kernels, resnet, base, rng)
        lat = latency_window(np, base, rng, LATENCY_REQUESTS)
        img_s, b32_requests, b32_wall = throughput_window(np, base, rng, THROUGHPUT_CLIENTS, THROUGHPUT_SECONDS)

        after = http(base + "/health/status")["jsonData"]["kernel_launches"]
        m1 = metrics_values(http(base + "/metrics"))
    finally:
        stop_server(proc)
        logfile.close()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    batches = m1["cudaserver_batches_total"] - m0["cudaserver_batches_total"]
    log(f"main path: {int(batches)} batches, mean rows/batch {m1['cudaserver_mean_batch_rows']:.2f}, "
        f"kernel launches {launches}")
    check(batches > 0 and m1["cudaserver_mean_batch_rows"] > 1.0, f"/metrics shows no batching: {m1}")
    check(launches["fused_normalize"] == batches,
          f"fused_normalize launches {launches['fused_normalize']} != {int(batches)} batches on the main path")
    numbers = {
        "batches": batches, "launches_per_batch": {k: n / batches for k, n in launches.items()},
        "served_max_row_rel_l2": served_err,
        "p50_ms": pct(lat, 0.50), "p99_ms": pct(lat, 0.99), "n_latency": len(lat),
        "batch32_img_s": img_s, "batch32_requests": b32_requests, "batch32_wall_s": b32_wall,
        "clients": THROUGHPUT_CLIENTS,
    }
    log(f"REST single-image latency over {len(lat)} sequential requests: p50 {numbers['p50_ms']:.2f} ms, "
        f"p99 {numbers['p99_ms']:.2f} ms; batch-32 throughput ({THROUGHPUT_CLIENTS} clients, "
        f"{b32_requests} requests in {b32_wall:.2f} s): {img_s:.1f} img/s [{card}]")
    return launches, numbers


# ---------------------------------------------------------------- phase 5 + 6

def whole_path(torch, np, kernels, resnet, card):
    rng = np.random.default_rng(SEED + 2)
    images = torch.from_numpy(rng.integers(0, 256, (8, *IMG), dtype=np.uint8)).cuda()
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())

    def build(dtype):
        m = resnet.ResNet50(num_classes=NUM_CLASSES, dtype=dtype)
        # every residual branch live (no zero-initialised BatchNorm scale)
        m.reset_parameters(torch.Generator().manual_seed(SEED + 3), zero_init_residual=False)
        return m.cuda().eval().to(memory_format=torch.channels_last)

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.inference_mode():
            ref = build(torch.float32)(
                kernels.fused_normalize_reference(images, scale, shift, torch.float32)).double().cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    model = build(torch.bfloat16)
    with torch.inference_mode():
        got = model(kernels.fused_normalize(images, scale, shift, torch.bfloat16)).double().cpu()
    check(bool(torch.isfinite(got).all()) and got.shape == (8, NUM_CLASSES), "bad bf16 whole-path logits")
    rel = float((got - ref).norm() / ref.norm())
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
    log(f"whole path bf16+kernel vs f32+plain (TF32 off), ResNet-50 batch 8: rel L2 {rel:.3e} "
        f"(limit {WHOLE_PATH_REL_L2}), min row cosine {cos:.6f} (limit {WHOLE_PATH_MIN_COS})")
    check(rel <= WHOLE_PATH_REL_L2 and cos >= WHOLE_PATH_MIN_COS, "whole-path numerics out of tolerance")

    # device time of the served program (normalize + ResNet-50), in-process
    fwd = {}
    for batch in (1, 32):
        x = torch.from_numpy(rng.integers(0, 256, (batch, *IMG), dtype=np.uint8)).cuda()

        def step():
            with torch.inference_mode():
                model(kernels.fused_normalize(x, scale, shift, torch.bfloat16))

        fwd[batch] = time_cuda(torch, step, reps=30, warm=5)
        log(f"device forward (normalize + ResNet-50 bf16) batch {batch}: {fwd[batch]:.3f} ms "
            f"= {batch / fwd[batch] * 1e3:.1f} img/s [{card}]")

    x = torch.from_numpy(rng.integers(0, 256, (32, *IMG), dtype=np.uint8)).cuda()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with torch.inference_mode():
                model(kernels.fused_normalize(x, scale, shift, torch.bfloat16))
        torch.cuda.synchronize()
    log("profile, 3 forwards at batch 32, top device time:")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12, max_name_column_width=60))
    return {"rel_l2": rel, "min_cos": cos, "forward_ms": fwd}


# ---------------------------------------------------------------- phase 7

def decode_calls(stats) -> int:
    """Paged-decode calls a layer an engine has made, from its
    ``engine_stats()`` (or a served ``/health/status``'s ``engine``): one a
    decode step, two in a chunk split into length buckets."""
    return sum(int(k) * v for k, v in stats["chunk_steps"].items()) + stats["bucketed_steps"]


def gen_request(np, base, prompt, max_new: int = LM_MAX_NEW, timeout: float = 300.0, tag=None, header=None):
    """One greedy generation request over REST; returns its (max_new,) ids.
    ``tag`` / ``header``: the adapter named in ``meta.tags.adapter`` / in
    the ``X-Seldon-Adapter`` header."""
    body = {"data": {"ndarray": [[int(t) for t in prompt]]}}
    tags = {"max_new_tokens": max_new} if max_new != LM_MAX_NEW else {}
    if tag:
        tags["adapter"] = tag
    if tags:
        body["meta"] = {"tags": tags}
    resp = http(base + "/predict", body, timeout=timeout, headers={"X-Seldon-Adapter": header} if header else None)
    check("data" in resp and "ndarray" in resp["data"], f"response carries no ndarray: {str(resp)[:300]}")
    row = np.asarray(resp["data"]["ndarray"], np.int64)
    check(row.shape == (1, max_new), f"expected (1, {max_new}) ids, got {row.shape}")
    check(bool(((row >= 0) & (row < LM_CONFIG["vocab_size"])).all()), "served ids outside the vocabulary")
    return row[0]


def gen_latency(np, base, prompts, n: int, max_new: int, adapters=(None,)):
    """ms of n sequential requests; request i names ``adapters[i % len]``."""
    for p in prompts[:4]:  # warm the client side
        gen_request(np, base, p, max_new)
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        gen_request(np, base, prompts[i % len(prompts)], max_new, tag=adapters[i % len(adapters)])
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def gen_throughput(np, base, prompts, clients: int, seconds: float, max_new: int, adapters=(None,)):
    """Generated tokens/s of `clients` closed-loop clients sending until
    `seconds` have passed; in-flight requests finish and count.  Client k
    names ``adapters[k % len]``."""
    t0 = time.perf_counter()

    def client(k):
        n = 0
        while time.perf_counter() - t0 < seconds:
            gen_request(np, base, prompts[(k + n) % len(prompts)], max_new, tag=adapters[k % len(adapters)])
            n += 1
        return n

    requests = sum(concurrent(client, clients))
    wall = time.perf_counter() - t0
    return requests * max_new / wall, requests, wall


def lm_engine(PagedEngine, params, dtype):
    return PagedEngine(params, dtype=dtype, device="cuda", **LM_CONFIG, **LM_ENGINE, **NO_PREFIX_CACHE)


def launch_lm():
    return server_context("chip_smoke_lm_server_", component="seldon_core_tpu_torch.models.paged.StreamingLM",
                          params=LM_PARAMS, env=dict(os.environ, **NO_PREFIX_CACHE_ENV))


def generation_path(torch, np, PagedEngine, load_lm_params, card):
    """The served generation path, rows held against an in-process engine."""
    rng = np.random.default_rng(SEED + 20)
    V = LM_CONFIG["vocab_size"]
    conc_prompts = [rng.integers(0, V, int(n)) for n in np.linspace(16, 700, 16)]
    single_prompts = [rng.integers(0, V, n) for n in SEQUENTIAL_PROMPTS]
    bench_prompts = [rng.integers(0, V, 128) for _ in range(16)]
    ctx = EARLY.take("lm", launch_lm)
    (proc,), base, logpath, logfile = ctx["procs"], ctx["base"], ctx["logpath"], ctx["logfile"]
    try:
        # the server's weights in-process (its default seed 0), each prompt
        # alone, beside the server's load unless it launched early
        eng = lm_engine(PagedEngine, load_lm_params("", LM_CONFIG, 0, torch.device("cuda")), "bfloat16")
        local_single = [eng.generate(p, max_new_tokens=LM_MAX_NEW) for p in single_prompts]
        local_conc = [eng.generate(p, max_new_tokens=LM_MAX_NEW) for p in conc_prompts]
        del eng
        torch.cuda.empty_cache()
        status, _ = wait_ready(proc, base, logpath)
        log(f"StreamingLM ready {ready_since(ctx):.1f}s after its launch{early_note(ctx)} (load "
            f"{status['load_time_s']:.1f}s, device "
            f"{status['device_name']}, kernel lane {status['kernel_active']})")
        check(status["device"].startswith("cuda") and status["kernel_active"],
              f"the generation server is not on the card's kernel lane: {status}")
        before, calls0 = status["kernel_launches"], decode_calls(status["engine"])
        served_conc = concurrent(lambda i: gen_request(np, base, conc_prompts[i]), len(conc_prompts))
        served_single = [gen_request(np, base, p) for p in single_prompts]
        repeat = gen_request(np, base, single_prompts[1])
        after_status = http(base + "/health/status")["jsonData"]
        lat = gen_latency(np, base, bench_prompts, GEN_LATENCY_REQUESTS, 32)
        tok_s, tp_requests, tp_wall = gen_throughput(np, base, bench_prompts, GEN_CLIENTS, GEN_SECONDS, 32)
    finally:
        stop_server(proc)
        logfile.close()
    after = after_status["kernel_launches"]
    launches = {k: after[k] - before.get(k, 0) for k in after}
    steps = decode_calls(after_status["engine"]) - calls0
    log(f"generation path: {steps} decode calls a layer (steps x buckets), kernel launches {launches}")
    check(steps > 0 and launches["paged_decode_stream"] == LM_CONFIG["num_layers"] * steps,
          f"K4 was not launched once a bucket on every layer of every decode step: {launches}, {steps} calls")
    check(bool((repeat == served_single[1]).all()), "a repeated greedy request changed its answer")
    same_single = [bool((a == b).all()) for a, b in zip(served_single, local_single)]
    share = float(np.mean([bool((a == b).all()) for a, b in zip(served_conc, local_conc)]))
    log(f"served vs in-process engine, each prompt alone: {sum(same_single)}/{len(same_single)} sequential rows "
        f"bit-identical; concurrent rows identical share {share:.3f} (limit {GEN_MIN_IDENTICAL_SHARE})")
    check(all(same_single), f"sequential served rows differ from the in-process engine: {same_single}")
    check(share >= GEN_MIN_IDENTICAL_SHARE, f"too few concurrent rows equal the in-process engine: {share}")
    numbers = {
        "decode_steps": steps, "launches": launches, "concurrent_identical_share": share,
        "rest_p50_ms": pct(lat, 0.50), "rest_p99_ms": p99(lat), "rest_max_ms": max(lat), "n_latency": len(lat),
        "rest_tokens_per_s": tok_s, "rest_requests": tp_requests, "rest_wall_s": tp_wall,
        "clients": GEN_CLIENTS,
    }
    log(f"generation REST over {len(lat)} sequential requests (prompt 128, 32 new): p50 "
        f"{numbers['rest_p50_ms']:.2f} ms, {tail_text(lat)}; {GEN_CLIENTS} closed-loop clients: "
        f"{tok_s:.1f} tokens/s ({tp_requests} requests in {tp_wall:.2f} s) [{card}]")
    return launches, numbers


# ---------------------------------------------------------------- phase 8

def device_time_by_name(prof):
    """-> ({name: (device us, count)}, busy us) of a profiler run.  Device
    time two ways: the device-side events (kernels, copies, fills), and
    the kernels the profiler files under the host op that launched them;
    the fuller of the two is the breakdown."""
    from torch.autograd import DeviceType

    views = ({}, {})
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = views[0].get(e.name, (0.0, 0))
            views[0][e.name] = (us + e.time_range.elapsed_us(), n + 1)
        for k in getattr(e, "kernels", None) or ():
            us, n = views[1].get(k.name, (0.0, 0))
            views[1][k.name] = (us + k.duration, n + 1)
    totals = [sum(us for us, _ in v.values()) for v in views]
    log(f"profiler device time: {totals[0] / 1e3:.3f} ms in {sum(n for _, n in views[0].values())} device events, "
        f"{totals[1] / 1e3:.3f} ms in {sum(n for _, n in views[1].values())} kernels under host ops")
    return (views[0] if totals[0] >= totals[1] else views[1]), max(totals)


def first_step_logits(torch, np, eng, prompts, tokens):
    """Prefill `prompts` (one per slot), then one decode step of `tokens`
    on the engine's own lane; returns its (slots, vocab) logits."""
    for p in prompts:
        eng.submit(p, max_new_tokens=1)
    with eng._lock:
        admitted = [s for s, _ in eng._admit_locked()]
    check(len(admitted) == len(prompts), "not every prompt was admitted")
    eng._prefill_streams(admitted)
    with torch.inference_mode(), eng._materialized():
        lengths = torch.from_numpy(eng._lengths.copy()).to(eng.device)
        width = eng._pages_horizon(admitted, 1)
        tables = torch.from_numpy(np.ascontiguousarray(eng._block_tables[:, :width])).to(eng.device)
        logits, _, _ = eng.module(tokens[:, None], lengths[:, None], eng.pages_k, eng.pages_v, tables, lengths,
                                  use_kernel=eng._kernel_active, **eng._model_kwargs(eng._adapter_slots.copy()))
    return logits[:, 0].double().cpu()


def engine_numerics(torch, np, kernels, PagedEngine, load_lm_params, card):
    rng = np.random.default_rng(SEED + 30)
    V = LM_CONFIG["vocab_size"]
    prompts = [rng.integers(0, V, int(n)) for n in np.linspace(16, 700, 16)]
    params = load_lm_params("", LM_CONFIG, SEED + 5, torch.device("cuda"))

    def tokens(**env):
        with knob_env(**env):
            eng = lm_engine(PagedEngine, params, "float32")
            streams = [eng.submit(p, max_new_tokens=16) for p in prompts]
            eng.run()
        return np.stack([s.result for s in streams]), eng._kernel_active

    k_stream, lane = tokens(SELDON_TPU_PAGED_KERNEL=None, SELDON_TPU_PAGED_KERNEL_IMPL="stream")
    gather, lane0 = tokens(SELDON_TPU_PAGED_KERNEL="0", SELDON_TPU_CHUNK_IMPL="pool")
    kernels.reset_launch_counts()
    k_grid, lane_grid = tokens(SELDON_TPU_PAGED_KERNEL=None, SELDON_TPU_PAGED_KERNEL_IMPL="grid")
    grid_launches = kernels.launch_counts()["paged_decode_grid"]
    check(lane and lane_grid and not lane0, "the f32 engines did not take the lanes asked for")
    log(f"f32 greedy, 16 ragged prompts x 16 tokens: K4 lane == gather lane {bool((k_stream == gather).all())}, "
        f"K4 == K5 {bool((k_stream == k_grid).all())} (K5 launches {grid_launches})")
    check(bool((k_stream == gather).all()), "f32 kernel lane and gather lane disagree on greedy tokens")
    check(bool((k_stream == k_grid).all()), "f32 stream and grid kernels disagree on greedy tokens")
    check(grid_launches > 0, "the grid engine launched no K5")

    step_tokens = torch.from_numpy(rng.integers(0, V, len(prompts))).cuda()
    with knob_env(SELDON_TPU_PAGED_KERNEL=None, SELDON_TPU_PAGED_KERNEL_IMPL="stream"):
        got = first_step_logits(torch, np, lm_engine(PagedEngine, params, "bfloat16"), prompts, step_tokens)
    with knob_env(SELDON_TPU_PAGED_KERNEL="0", SELDON_TPU_CHUNK_IMPL="pool"):
        ref = first_step_logits(torch, np, lm_engine(PagedEngine, params, "float32"), prompts, step_tokens)
    torch.cuda.empty_cache()
    rel = float((got - ref).norm() / ref.norm())
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
    log(f"first decode step, bf16 kernel lane vs f32 gather lane: rel L2 {rel:.3e} (limit {WHOLE_PATH_REL_L2}), "
        f"min row cosine {cos:.6f} (limit {WHOLE_PATH_MIN_COS})")
    check(bool(torch.isfinite(got).all()), "non-finite bf16 decode logits")
    check(rel <= WHOLE_PATH_REL_L2 and cos >= WHOLE_PATH_MIN_COS, "bf16 decode numerics out of tolerance")
    return grid_launches, {"rel_l2": rel, "min_cos": cos}


def engine_numbers(torch, np, PagedEngine, load_lm_params, card, make_engine=None, adapters=(None,),
                   what="bf16"):
    """In-process bf16 numbers at 16 slots: decode tokens/s (prompt 128,
    128 new: full run minus prefill and one chunk, min of 3 each),
    prefill ms for 16 x 128, and a profile of one decode chunk.  Prompt i
    names ``adapters[i % len]``; ``make_engine(params)`` builds another
    engine than the plain bf16 one."""
    rng = np.random.default_rng(SEED + 40)
    prompts = rng.integers(0, LM_CONFIG["vocab_size"], (LM_ENGINE["max_slots"], 128))
    params = load_lm_params("", LM_CONFIG, 0, torch.device("cuda"))
    eng = make_engine(params) if make_engine else lm_engine(PagedEngine, params, "bfloat16")
    names = [adapters[i % len(adapters)] for i in range(len(prompts))]

    def run(max_new):
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=max_new, adapter=a) for p, a in zip(prompts, names)]
        eng.run()
        check(all(s.result.shape == (max_new,) for s in streams), "bad in-process generation")
        return time.perf_counter() - t0

    run(128)
    run(1)
    dt_p1 = min(run(1) for _ in range(3))
    dt_full = min(run(128) for _ in range(3))
    decode_tok_s = len(prompts) * 127 / max(dt_full - dt_p1, 1e-9)

    prefill_ms = float("inf")
    for _ in range(3):
        for p, a in zip(prompts, names):
            eng.submit(p, max_new_tokens=1, adapter=a)
        with eng._lock:
            admitted = [s for s, _ in eng._admit_locked()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._prefill_streams(admitted)
        torch.cuda.synchronize()
        prefill_ms = min(prefill_ms, (time.perf_counter() - t0) * 1e3)
        eng.run()

    from torch.profiler import ProfilerActivity, profile

    for p, a in zip(prompts, names):
        eng.submit(p, max_new_tokens=128, adapter=a)
    eng.step()  # admission, prefill and the first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()  # one decode chunk (its readback synchronises)
        chunk_ms = (time.perf_counter() - t0) * 1e3
    eng.run()

    by_name, busy_us = device_time_by_name(prof)
    k4_us = sum(us for name, (us, _) in by_name.items() if "paged_decode_kernel" in name)
    launches = sum(n for _, n in by_name.values())
    log(f"profile of one {what} decode chunk ({LM_ENGINE['steps_per_call']} steps, 16 lanes, prompt 128): wall "
        f"{chunk_ms:.3f} ms, {launches} device events, device busy {busy_us / 1e3:.3f} ms, idle share "
        f"{1 - busy_us / 1e3 / chunk_ms:.3f}, K4 {k4_us / 1e3:.3f} ms ({k4_us / max(busy_us, 1e-9):.3f} of device "
        f"time)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {us / 1e3:9.3f} ms  {n:6d}x  {us / max(busy_us, 1e-9):6.3f}  {name[:90]}")
    check(launches > 0, "the profiler recorded no device event in the decode chunk")
    del eng
    torch.cuda.empty_cache()
    numbers = {
        "decode_tokens_per_s": decode_tok_s, "full_run_s": dt_full, "prefill_plus_chunk_s": dt_p1,
        "prefill_ms_16x128": prefill_ms, "chunk_wall_ms": chunk_ms, "chunk_device_busy_ms": busy_us / 1e3,
        "chunk_idle_share": 1 - busy_us / 1e3 / chunk_ms, "k4_share_of_device_time": k4_us / max(busy_us, 1e-9),
        "chunk_device_events": launches,
    }
    log(f"in-process {what}, 16 slots, prompt 128, 128 new: decode {decode_tok_s:.1f} tokens/s, prefill 16x128 "
        f"{prefill_ms:.3f} ms [{card}]")
    return numbers


# ---------------------------------------------------------------- phase 9

def vit_model(torch, kernels, vit, dtype, flash: bool, seed: int):
    """ViT-B/16 in-process with the server's seeded init."""
    attn = {"attn_fn": kernels.flash_attn_fn()} if flash else {}
    model = vit.ViTBase16(num_classes=NUM_CLASSES, dtype=dtype, **attn)
    return model.reset_parameters(torch.Generator().manual_seed(seed)).cuda().eval()


def launch_vit():
    return server_context("chip_smoke_vit_server_", params=VIT_PARAMS)


def vit_path(torch, np, kernels, vit, card):
    """The served ViT-B/16 path, rows held against an in-process model."""
    rng = np.random.default_rng(SEED + 50)
    ctx = EARLY.take("vit", launch_vit)
    (proc,), base, logpath, logfile = ctx["procs"], ctx["base"], ctx["logpath"], ctx["logfile"]
    try:
        status, _ = wait_ready(proc, base, logpath)
        log(f"ViT-B/16 server ready in {ready_since(ctx):.1f}s{early_note(ctx)} (load {status['load_time_s']:.1f}s, "
            f"buckets {status['buckets']}, device {status['device_name']})")
        check(status["device"].startswith("cuda"), f"the ViT server is not on the card: {status['device']}")
        m0 = metrics_values(http(base + "/metrics"))
        before = status["kernel_launches"]
        groups = [distinct_images(np, rng, 8), distinct_images(np, rng, 8)]
        served = [decode_logits(np, http(base + "/predict", raw_request(np, groups[0])), 8)]
        answers = concurrent(lambda i: http(base + "/predict", raw_request(np, groups[1][i:i + 1])), 8)
        served.append(np.concatenate([decode_logits(np, a, 1) for a in answers]))
        lat = latency_window(np, base, rng, VIT_LATENCY_REQUESTS)
        img_s, b32_requests, b32_wall = throughput_window(np, base, rng, THROUGHPUT_CLIENTS, THROUGHPUT_SECONDS)
        after = http(base + "/health/status")["jsonData"]["kernel_launches"]
        m1 = metrics_values(http(base + "/metrics"))
    finally:
        stop_server(proc)
        logfile.close()
    launches = {k: after[k] - before.get(k, 0) for k in after}
    batches = int(m1["cudaserver_batches_total"] - m0["cudaserver_batches_total"])
    log(f"ViT path: {batches} batches, mean rows/batch {m1['cudaserver_mean_batch_rows']:.2f}, kernel launches "
        f"{launches}")
    check(batches > 0, "the ViT server served no batch")
    check(launches["flash_attention"] == VIT_LAYERS * batches,
          f"flash_attention launches {launches['flash_attention']} != {VIT_LAYERS} x {batches} batches")
    check(launches["fused_normalize"] == batches,
          f"fused_normalize launches {launches['fused_normalize']} != {batches} batches")

    # the server's weights in-process (its default seed 0), each group as one batch
    local = vit_model(torch, kernels, vit, torch.bfloat16, True, SEED)
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    refs = []
    with torch.inference_mode():
        for images in groups:
            x = kernels.fused_normalize(torch.from_numpy(images).cuda(), scale, shift, torch.bfloat16)
            refs.append(local(x).double().cpu().numpy())
    served_all, ref_all = np.concatenate(served), np.concatenate(refs)
    n = len(ref_all)
    errs = [rel_l2(np, served_all[i], ref_all[i]) for i in range(n)]
    nearest = [int(np.argmin([rel_l2(np, served_all[i], ref_all[j]) for j in range(n)])) for i in range(n)]
    cross = min(rel_l2(np, ref_all[i], ref_all[j]) for i in range(n) for j in range(n) if i != j)
    log(f"ViT served vs in-process bf16, {n} rows (batch of 8 + 8 concurrent singles): max row rel L2 "
        f"{max(errs):.3e} (limit {SERVED_VS_LOCAL_REL_L2}); every row nearest its own image's answer: "
        f"{nearest == list(range(n))}; least rel L2 between two images' answers {cross:.3e}")
    check(max(errs) <= SERVED_VS_LOCAL_REL_L2, f"served ViT rows disagree with the in-process model: {errs}")
    check(nearest == list(range(n)), f"a served ViT row is nearer another image's answer: {nearest}")
    numbers = {
        "batches": batches, "launches": launches, "served_max_row_rel_l2": max(errs),
        "least_cross_row_rel_l2": cross,
        "p50_ms": pct(lat, 0.50), "p99_ms": pct(lat, 0.99), "n_latency": len(lat),
        "batch32_img_s": img_s, "batch32_requests": b32_requests, "batch32_wall_s": b32_wall,
        "clients": THROUGHPUT_CLIENTS,
    }
    log(f"ViT-B/16 REST single-image latency over {len(lat)} sequential requests: p50 {numbers['p50_ms']:.2f} ms, "
        f"p99 {numbers['p99_ms']:.2f} ms; batch-32 throughput ({THROUGHPUT_CLIENTS} clients, {b32_requests} "
        f"requests in {b32_wall:.2f} s): {img_s:.1f} img/s [{card}]")
    return local, numbers


def vit_forward_profile(torch, np, kernels, model, card):
    """Device time of the served program (K1 + ViT-B/16 bf16 with K3) at
    batch 1 and 32: event-timed forward, and a profile of 5 forwards
    (device busy per forward, K3's share, idle share)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 51)
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    out = {}
    for batch in (1, 32):
        x = torch.from_numpy(rng.integers(0, 256, (batch, *IMG), dtype=np.uint8)).cuda()

        def step():
            with torch.inference_mode():
                model(kernels.fused_normalize(x, scale, shift, torch.bfloat16))

        forward_ms = time_cuda(torch, step, reps=30, warm=5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, busy_us = device_time_by_name(prof)
        k3_us = sum(us for name, (us, _) in by_name.items() if "flash_attention" in name)
        k3_n = sum(n for name, (_, n) in by_name.items() if "flash_attention" in name)
        row = {"forward_ms": forward_ms, "device_busy_ms_per_forward": busy_us / 5e3,
               "k3_share_of_device_time": k3_us / max(busy_us, 1e-9), "k3_launches_profiled": k3_n,
               "profiled_wall_ms_per_forward": wall_ms / 5, "idle_share": 1 - busy_us / 1e3 / wall_ms}
        out[batch] = row
        log(f"ViT-B/16 forward (K1 + bf16 ViT with K3) batch {batch}: event-timed {forward_ms:.3f} ms "
            f"= {batch / forward_ms * 1e3:.1f} img/s; profiled: device busy {row['device_busy_ms_per_forward']:.3f} "
            f"ms a forward, K3 {row['k3_share_of_device_time']:.3f} of it ({k3_n} launches in 5 forwards), idle "
            f"share {row['idle_share']:.3f} [{card}]")
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
            log(f"  {us / 5e3:9.3f} ms/fwd  {n // 5:5d}x  {us / max(busy_us, 1e-9):6.3f}  {name[:90]}")
        check(k3_n == 5 * VIT_LAYERS, f"the profile shows {k3_n} K3 launches in 5 forwards")
    return out


# ---------------------------------------------------------------- phase 10

def transformer_numerics(torch, np, kernels, vit, transformer, CudaServer, card):
    """ViT-B/16 bf16 + K3 against f32 + plain attention; the causal K3
    lane of transformer_lm against the plain model, both f32."""
    rng = np.random.default_rng(SEED + 60)
    images = torch.from_numpy(rng.integers(0, 256, (8, *IMG), dtype=np.uint8)).cuda()
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    with no_tf32(torch), torch.inference_mode():
        ref_model = vit_model(torch, kernels, vit, torch.float32, False, SEED + 3)
        ref = ref_model(kernels.fused_normalize_reference(images, scale, shift, torch.float32)).double().cpu()
        del ref_model
        model = vit_model(torch, kernels, vit, torch.bfloat16, True, SEED + 3)
        got = model(kernels.fused_normalize(images, scale, shift, torch.bfloat16)).double().cpu()
        del model
    check(bool(torch.isfinite(got).all()) and got.shape == (8, NUM_CLASSES), "bad bf16 ViT logits")
    rel = float((got - ref).norm() / ref.norm())
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
    log(f"ViT-B/16 bf16 + K1 + K3 vs f32 + plain versions (TF32 off), batch 8: rel L2 {rel:.3e} (limit "
        f"{WHOLE_PATH_REL_L2}), min row cosine {cos:.6f} (limit {WHOLE_PATH_MIN_COS})")
    check(rel <= WHOLE_PATH_REL_L2 and cos >= WHOLE_PATH_MIN_COS, "ViT numerics out of tolerance")

    seq = 256
    tokens = rng.integers(0, LM_CONFIG["vocab_size"], (2, seq)).astype(np.int32)
    with no_tf32(torch):
        cs = CudaServer(model="transformer_lm", input_shape=[seq], dtype="float32", max_batch_size=2,
                        warmup_dtypes=("int32",), seed=SEED + 6, model_kwargs={**LM_CONFIG, "attention": "flash"})
        cs.load()
        try:
            before = kernels.launch_counts()["flash_attention"]
            flash = cs.predict(tokens, [])
            lm_launches = kernels.launch_counts()["flash_attention"] - before
        finally:
            cs.unload()
        del cs
        plain_lm = transformer.TransformerLM(dtype=torch.float32, **LM_CONFIG)
        plain_lm = plain_lm.reset_parameters(torch.Generator().manual_seed(SEED + 6)).cuda().eval()
        with torch.inference_mode():
            plain = plain_lm(torch.from_numpy(tokens).cuda()).cpu().numpy()
        del plain_lm
    torch.cuda.empty_cache()
    err = float(np.abs(flash - plain).max())
    log(f"transformer_lm served in-process with attention=flash (causal K3, {lm_launches} launches for one batch "
        f"of 2 x {seq}) vs plain attention, f32: max abs logit diff {err:.3e} (limit {LM_FLASH_ATOL}), max |logit| "
        f"{float(np.abs(plain).max()):.3f}")
    check(flash.shape == plain.shape == (2, seq, LM_CONFIG["vocab_size"]), f"bad LM logits {flash.shape}")
    check(lm_launches == LM_CONFIG["num_layers"], f"causal K3 launched {lm_launches} times, not once per layer")
    check(err <= LM_FLASH_ATOL, "causal flash LM differs from the plain LM")
    return {"vit_rel_l2": rel, "vit_min_cos": cos, "lm_max_abs_err": err, "lm_launches": lm_launches}


# ---------------------------------------------------------------- phase 11a

def variant_inputs(torch, np, B, h, hd, ps, P, lengths, qdtype, quantized, seed):
    """The 3b inputs with int8 pages (positive random scales) or pages in
    q's dtype, plus the fold's inputs: x (B, D), A (3, D, r), B (3, r, 3D)
    float32 with slot 0 zero, lanes spread over slots 0, 1 and 2."""
    rng = np.random.default_rng(seed)
    num_pages, D = B * P + 1, h * hd
    if quantized:
        pk, pv = (torch.from_numpy(rng.integers(-127, 128, (num_pages, ps, h, hd), dtype=np.int8)).cuda()
                  for _ in range(2))
        scales = tuple(torch.from_numpy(rng.uniform(0.001, 0.05, num_pages).astype(np.float32)).cuda()
                       for _ in range(2))
    else:
        pk, pv = (torch.from_numpy(rng.standard_normal((num_pages, ps, h, hd), dtype=np.float32)).to(qdtype).cuda()
                  for _ in range(2))
        scales = None
    q = torch.from_numpy(rng.standard_normal((B, h, hd), dtype=np.float32) * 0.125).to(qdtype).cuda()
    tables = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).reshape(B, P).astype(np.int32)).cuda()
    a = rng.standard_normal((LORA_SLOTS, D, LORA_RANK), dtype=np.float32) / np.float32(np.sqrt(D))
    b = rng.standard_normal((LORA_SLOTS, LORA_RANK, 3 * D), dtype=np.float32) / np.float32(np.sqrt(LORA_RANK))
    a[0] = b[0] = 0
    lora = (torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32)).cuda(), torch.from_numpy(a).cuda(),
            torch.from_numpy(b).cuda(), torch.tensor([i % LORA_SLOTS for i in range(B)], dtype=torch.int32).cuda(),
            hd ** -0.5)
    return (q, pk, pv, tables, torch.tensor(lengths, dtype=torch.int32).cuda()), scales, lora


def paged_variant_bound(B, h, hd, ps, P, lengths, q_elt, pool_elt, quantized, fold, slots_used, mem_bytes_per_s):
    """Least time for one call of a variant: the 3b bytes with pool
    elements of `pool_elt` bytes, plus each live page's two scales (int8),
    plus the distinct slots' A and B, the x rows, the slot ids and the
    (B, 3D) delta (fold); the flops (scores, weighted sums, the dequant
    products, the fold's two products and the q update) over the f32 peak.
    -> (ms, "bytes" or "operations", bytes, flops)."""
    live = [min(max(n, 0), P * ps) for n in lengths]
    pages = sum(-(-n // ps) for n in live)
    D = h * hd
    nbytes = (pages * ps * h * hd * 2 * pool_elt + B * h * hd * q_elt + B * P * 4 + B * 4
              + B * h * hd * 4 + 2 * B * h * 4)
    flops = sum(4 * n * h * hd for n in live)
    if quantized:
        nbytes += pages * 2 * 4
        flops += sum(2 * n * h * hd for n in live)
    if fold:
        nbytes += slots_used * (D * LORA_RANK + LORA_RANK * 3 * D) * 4 + B * D * 4 + B * 4 + B * 3 * D * 4
        flops += B * (2 * D * LORA_RANK + 2 * LORA_RANK * 3 * D + 2 * D)
    t_bytes, t_ops = nbytes / mem_bytes_per_s, flops / F32_PEAK_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def paged_variant_checks(torch, np, kernels, mem_bytes_per_s):
    """K4-int8, K5-int8, K4-LoRA and K4-int8+LoRA against their plain
    version at the 3b shapes, then their times."""
    import torch.nn.functional as F

    errs = {v: {"max_abs_err": 0.0, "max_rel_err": 0.0, "delta_max_rel_err": 0.0} for v in PAGED_VARIANTS}
    for case, (B, h, hd, ps, P, lengths) in enumerate(PAGED_CASES):
        for qdtype in (torch.bfloat16, torch.float32):
            for quantized in (True, False):
                args, scales, lora = variant_inputs(torch, np, B, h, hd, ps, P, lengths, qdtype, quantized,
                                                    seed=20 + case)
                for v in PAGED_VARIANTS:
                    impl, v_quant, fold = v
                    if v_quant != quantized:
                        continue
                    kw = dict(page_size=ps, kv_scales=scales, lora=lora if fold else None)
                    ref = kernels.paged_attention_decode_reference(*args, **kw)
                    with knob_env(SELDON_TPU_PAGED_KERNEL_IMPL=impl):
                        got = kernels.paged_attention_decode(*args, **kw)
                    torch.cuda.synchronize()
                    what = (f"{kernels.paged_launch_name(*v)} B={B} h={h} hd={hd} ps={ps} P={P} q "
                            f"{str(qdtype)[6:]}")
                    check(len(got) == len(ref) == (4 if fold else 3), f"{what}: {len(got)} outputs")
                    err_abs, err_rel = compare_flash_state(torch, got[:3], ref[:3], what)
                    e = errs[v]
                    e["max_abs_err"], e["max_rel_err"] = max(e["max_abs_err"], err_abs), max(e["max_rel_err"], err_rel)
                    msg = f"{what}: max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e} (limit {PAGED_REL_TOL})"
                    if fold:
                        delta, ref_delta, idx = got[3], ref[3], lora[3]
                        check(delta.shape == ref_delta.shape and not bool(torch.isnan(delta).any()),
                              f"{what}: bad delta {tuple(delta.shape)}")
                        check(bool((delta[idx == 0] == 0).all()), f"{what}: a slot-0 lane's delta is not exactly 0")
                        d_rel = ((delta - ref_delta).abs().max() / ref_delta.abs().max()).item()
                        e["max_abs_err"] = max(e["max_abs_err"], (delta - ref_delta).abs().max().item())
                        e["delta_max_rel_err"] = max(e["delta_max_rel_err"], d_rel)
                        msg += f"; delta max_rel_err={d_rel:.3e} (limit {DELTA_REL_TOL}), slot-0 lanes exactly 0"
                        check(d_rel <= DELTA_REL_TOL, f"{what}: the delta differs from its plain version: {d_rel}")
                    log(msg)
                    check(err_rel <= PAGED_REL_TOL, f"{what} differs from its plain version: {err_rel}")

    B, h, hd, ps, P, lengths = PAGED_CASES[0]
    for quantized in (True, False):
        args, scales, lora = variant_inputs(torch, np, B, h, hd, ps, P, lengths, torch.bfloat16, quantized, seed=23)
        for v in PAGED_VARIANTS:
            impl, v_quant, fold = v
            if v_quant != quantized:
                continue
            what = f"{kernels.paged_launch_name(*v)} B={B} h={h} hd={hd} ps={ps} P={P} q bfloat16"
            n = lane_invariance(torch, kernels, impl, args,
                                dict(page_size=ps, kv_scales=scales, lora=lora if fold else None), what)
            log(f"{what}: each lane bit-identical over {n} co-schedulings (repeat, reversed, B/2, other lanes "
                f"changed{', adapter slots too' if fold else ''})")
    T = P * ps
    timings = {}
    for label, lengths in (("uniform512", [512] * B), ("ragged", RAGGED_LENGTHS)):
        for quantized in (True, False):
            args, scales, lora = variant_inputs(torch, np, B, h, hd, ps, P, lengths, torch.bfloat16, quantized,
                                                seed=7)
            q, pk, pv, tables, lens = args
            x, a, b, idx, q_scale = lora
            mask = (torch.arange(T, device=lens.device)[None, :] < lens[:, None])[:, None, None, :]
            slots_used = len(set(idx.tolist()))
            for v in PAGED_VARIANTS:
                impl, v_quant, fold = v
                if v_quant != quantized:
                    continue
                kw = dict(page_size=ps, kv_scales=scales, lora=lora if fold else None)

                def library():
                    # the closest PyTorch calls: the (dequantised) page
                    # gather, two torch.bmm for the fold, one fused attention
                    gk, gv = pk[tables], pv[tables]
                    if quantized:
                        gk = (gk.float() * scales[0][tables][:, :, None, None, None]).to(q.dtype)
                        gv = (gv.float() * scales[1][tables][:, :, None, None, None]).to(q.dtype)
                    qq = q
                    if fold:
                        t = torch.bmm(x[:, None, :], a[idx])
                        delta = torch.bmm(t, b[idx])[:, 0]
                        qq = (q.float() + q_scale * delta[:, : h * hd].reshape(B, h, hd)).to(q.dtype)
                    gk = gk.reshape(B, T, h, hd).transpose(1, 2)
                    gv = gv.reshape(B, T, h, hd).transpose(1, 2)
                    return F.scaled_dot_product_attention(qq[:, :, None, :], gk, gv, attn_mask=mask, scale=1.0)

                with knob_env(SELDON_TPU_PAGED_KERNEL_IMPL=impl):
                    row = {"ms": time_cuda(torch, lambda: kernels.paged_attention_decode(*args, **kw), flush_mb=1024)}
                row["plain_ms"] = time_cuda(torch, lambda: kernels.paged_attention_decode_reference(*args, **kw),
                                            reps=20)
                # ~20 host ops a call: a longer flush keeps their enqueue out of the span
                row["library_ms"] = time_cuda(torch, library, flush_mb=4096)
                row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = paged_variant_bound(
                    B, h, hd, ps, P, lengths, 2, 1 if quantized else 2, quantized, fold, slots_used, mem_bytes_per_s)
                timings[v, label] = row
                log(f"{kernels.paged_launch_name(*v)} q bf16 B={B} h={h} hd={hd} ps={ps} P={P} {label}: kernel "
                    f"{row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, library "
                    f"{row['library_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: "
                    f"{row['bytes']} bytes, {row['flops']} flops)")
    return errs, timings


# ---------------------------------------------------------------- phase 11b

def adapter_registry(WeightRegistry, make_lora_params):
    """The server's adapter catalogue in-process: StreamingLM's loader for
    ``{"seed": n}`` is ``make_lora_params(n, alpha=rank)``."""
    reg = WeightRegistry()
    for name, spec in LM_ADAPTERS.items():
        reg.register(name, (lambda seed=spec["seed"]: make_lora_params(
            seed, num_layers=LM_CONFIG["num_layers"], d_model=LM_CONFIG["d_model"], rank=LORA_RANK,
            alpha=float(LORA_RANK))))
    return reg


def launch_qlm():
    return server_context("chip_smoke_qlm_server_", component="seldon_core_tpu_torch.models.paged.StreamingLM",
                          params=Q_LM_PARAMS, env=dict(os.environ, SELDON_TPU_KV_DTYPE="int8", **NO_PREFIX_CACHE_ENV))


def quantized_generation_path(torch, np, PagedEngine, load_lm_params, WeightRegistry, make_lora_params, card):
    """The served int8 + multi-adapter generation path, rows held against
    an in-process engine of the same weights, adapters and pool."""
    rng = np.random.default_rng(SEED + 70)
    V = LM_CONFIG["vocab_size"]
    conc_prompts = [rng.integers(0, V, int(n)) for n in np.linspace(16, 700, 16)]
    # request i: the base model, a1 by body tag, a2 by header, in turn
    conc_routes = [(None, None), ("a1", None), (None, "a2")] * 6
    single_prompts = [rng.integers(0, V, n) for n in SEQUENTIAL_PROMPTS]
    single_adapters = [None, "a1", "a2", "a1", None, "a2", "a1", "a2"]
    bench_prompts = [rng.integers(0, V, 128) for _ in range(16)]
    ctx = EARLY.take("qlm", launch_qlm)
    (proc,), base, logpath, logfile = ctx["procs"], ctx["base"], ctx["logpath"], ctx["logfile"]
    try:
        # the in-process reference of the same weights, adapters and pool,
        # each prompt alone, beside the server's load unless it launched early
        with knob_env(SELDON_TPU_KV_DTYPE="int8"):
            eng = PagedEngine(load_lm_params("", LM_CONFIG, 0, torch.device("cuda")), dtype="bfloat16",
                              device="cuda", max_adapters=2, lora_rank=LORA_RANK,
                              weight_registry=adapter_registry(WeightRegistry, make_lora_params), **LM_CONFIG,
                              **LM_ENGINE, **NO_PREFIX_CACHE)
        check(eng._kv_int8, "the in-process reference engine has no int8 pool")
        local_single = [eng.generate(p, max_new_tokens=LM_MAX_NEW, adapter=a)
                        for p, a in zip(single_prompts, single_adapters)]
        local_conc = [eng.generate(p, max_new_tokens=Q_WAVE_NEW, adapter=r[0] or r[1])
                      for p, r in zip(conc_prompts, conc_routes)]
        del eng
        torch.cuda.empty_cache()
        status, _ = wait_ready(proc, base, logpath)
        log(f"int8 + adapters StreamingLM ready {ready_since(ctx):.1f}s after its launch{early_note(ctx)} (load "
            f"{status['load_time_s']:.1f}s, "
            f"kv pool {status['kv_dtype']}, adapters {status['adapters']['max_adapters']} slots of rank "
            f"{status['adapters']['rank']}, kernel lane {status['kernel_active']})")
        check(status["device"].startswith("cuda") and status["kernel_active"] and status["kv_dtype"] == "int8"
              and status["adapters"]["max_adapters"] == 2,
              f"the int8 + adapters server is not on the card's kernel lane with its pool and adapters: {status}")
        before, calls0 = status["kernel_launches"], decode_calls(status["engine"])
        served_conc = concurrent(lambda i: gen_request(np, base, conc_prompts[i], max_new=Q_WAVE_NEW,
                                                       tag=conc_routes[i][0], header=conc_routes[i][1]),
                                 len(conc_prompts))
        served_single = [gen_request(np, base, p, tag=a) for p, a in zip(single_prompts, single_adapters)]
        same_prompt = {a: gen_request(np, base, single_prompts[1], tag=a) for a in (None, "a1", "a2")}
        same_prompt["a2 header"] = gen_request(np, base, single_prompts[1], header="a2")
        same_prompt["a1 tag, a2 header"] = gen_request(np, base, single_prompts[1], tag="a1", header="a2")
        after_status = http(base + "/health/status")["jsonData"]
        lat = gen_latency(np, base, bench_prompts, Q_LATENCY_REQUESTS, 32, adapters=(None, "a1", "a2"))
        tok_s, tp_requests, tp_wall = gen_throughput(np, base, bench_prompts, GEN_CLIENTS, GEN_SECONDS, 32,
                                                     adapters=(None, "a1", "a2"))
        metrics = metrics_values(http(base + "/metrics"))
    finally:
        stop_server(proc)
        logfile.close()
    after = after_status["kernel_launches"]
    launches = {k: after[k] - before.get(k, 0) for k in after}
    steps = decode_calls(after_status["engine"]) - calls0
    variant = "paged_decode_stream_int8_lora"
    log(f"int8 + adapters generation path: {steps} decode calls a layer (steps x buckets), kernel launches "
        f"{launches}; adapter stats { {k: v for k, v in after_status['engine'].items() if k.startswith('adapter')} }")
    check(steps > 0 and launches[variant] == LM_CONFIG["num_layers"] * steps,
          f"K4-int8+LoRA was not launched once a bucket on every layer of every decode step: {launches}, "
          f"{steps} calls")
    check(same_prompt["a1"].tolist() != same_prompt[None].tolist() != same_prompt["a2"].tolist()
          and same_prompt["a1"].tolist() != same_prompt["a2"].tolist(),
          "adapter rows do not differ from the base row of the same prompt")
    check(bool((same_prompt["a2 header"] == same_prompt["a2"]).all()), "the header and the tag select differently")
    check(bool((same_prompt["a1 tag, a2 header"] == same_prompt["a1"]).all()), "the header won over the body tag")
    check(bool((same_prompt["a1"] == served_single[1]).all()), "a repeated greedy adapter request changed")
    check(metrics.get("paged_adapter_loads", 0) >= 2, f"/metrics shows no adapter loads: {metrics}")

    same_single = [bool((a == b).all()) for a, b in zip(served_single, local_single)]
    share = float(np.mean([bool((a == b).all()) for a, b in zip(served_conc, local_conc)]))
    log(f"int8 + adapters served vs in-process engine, each prompt alone: {sum(same_single)}/{len(same_single)} "
        f"sequential rows bit-identical; concurrent rows identical share {share:.3f} (limit "
        f"{GEN_MIN_IDENTICAL_SHARE})")
    check(all(same_single), f"sequential served rows differ from the in-process engine: {same_single}")
    check(share >= GEN_MIN_IDENTICAL_SHARE, f"too few concurrent rows equal the in-process engine: {share}")
    numbers = {
        "decode_steps": steps, "launches": launches, "concurrent_identical_share": share,
        "rest_p50_ms": pct(lat, 0.50), "rest_p99_ms": p99(lat), "rest_max_ms": max(lat), "n_latency": len(lat),
        "rest_tokens_per_s": tok_s, "rest_requests": tp_requests, "rest_wall_s": tp_wall, "clients": GEN_CLIENTS,
        "adapter_loads": metrics.get("paged_adapter_loads"), "adapter_hits": metrics.get("paged_adapter_hits"),
    }
    log(f"int8 + adapters generation REST over {len(lat)} sequential requests (prompt 128, 32 new, base/a1/a2 in "
        f"turn): p50 {numbers['rest_p50_ms']:.2f} ms, {tail_text(lat)}; {GEN_CLIENTS} "
        f"closed-loop clients: {tok_s:.1f} tokens/s ({tp_requests} requests in {tp_wall:.2f} s) [{card}]")
    return launches, numbers


# ---------------------------------------------------------------- phase 11c

def quantized_engine_numerics(torch, np, kernels, PagedEngine, load_lm_params, WeightRegistry, make_lora_params,
                              card):
    """Lane agreement of the int8 pool and of the fold in f32, each
    variant's launches on its in-process path, and the int8 pool's
    numerics against the native pool."""
    rng = np.random.default_rng(SEED + 80)
    V = LM_CONFIG["vocab_size"]
    prompts = [rng.integers(0, V, int(n)) for n in np.linspace(16, 700, 16)]
    adapters = [None, "a1", "a2"] * 6
    params = load_lm_params("", LM_CONFIG, SEED + 5, torch.device("cuda"))
    launches = {}

    def tokens(dtype="float32", with_adapters=False, max_new=16, **env):
        """Greedy tokens of the 16 prompts; the launches of each kernel
        variant on this engine's path (counts reset just before)."""
        with knob_env(**env):
            extra = (dict(max_adapters=2, lora_rank=LORA_RANK,
                          weight_registry=adapter_registry(WeightRegistry, make_lora_params)) if with_adapters else {})
            eng = PagedEngine(params, dtype=dtype, device="cuda", **LM_CONFIG, **LM_ENGINE, **NO_PREFIX_CACHE, **extra)
            kernels.reset_launch_counts()
            streams = [eng.submit(p, max_new_tokens=max_new, adapter=a if with_adapters else None)
                       for p, a in zip(prompts, adapters)]
            eng.run()
            counts = {k: n for k, n in kernels.launch_counts().items() if n}
        steps = decode_calls(eng.engine_stats())
        out = np.stack([s.result for s in streams])
        lane = (eng._kernel_active, eng._kv_int8, steps)
        del eng
        torch.cuda.empty_cache()
        return out, counts, lane

    def expect_launches(counts, lane, name):
        kernel_active, _, steps = lane
        want = LM_CONFIG["num_layers"] * steps  # K4 and K5 alike: one launch a layer-step a bucket
        check(kernel_active and counts == {name: want},
              f"{name}: launches {counts} on its path, expected exactly {want} ({steps} decode calls a layer)")
        launches[name] = want

    k_int8, c, lane = tokens(SELDON_TPU_KV_DTYPE="int8", SELDON_TPU_PAGED_KERNEL=None,
                             SELDON_TPU_PAGED_KERNEL_IMPL="stream")
    check(lane[1], "the int8 engine has no int8 pool")
    expect_launches(c, lane, "paged_decode_stream_int8")
    g_int8, c, lane = tokens(SELDON_TPU_KV_DTYPE="int8", SELDON_TPU_PAGED_KERNEL="0", SELDON_TPU_CHUNK_IMPL="pool")
    check(not lane[0] and not c, f"the int8 gather lane launched kernels: {c}")
    k5_int8, c, lane = tokens(SELDON_TPU_KV_DTYPE="int8", SELDON_TPU_PAGED_KERNEL=None,
                              SELDON_TPU_PAGED_KERNEL_IMPL="grid")
    expect_launches(c, lane, "paged_decode_grid_int8")
    fold, c, lane = tokens(with_adapters=True, SELDON_TPU_KV_DTYPE=None, SELDON_TPU_PAGED_KERNEL=None,
                           SELDON_TPU_PAGED_KERNEL_IMPL="stream")
    expect_launches(c, lane, "paged_decode_stream_lora")
    einsum, c, lane = tokens(with_adapters=True, SELDON_TPU_KV_DTYPE=None, SELDON_TPU_PAGED_KERNEL="0",
                             SELDON_TPU_CHUNK_IMPL="pool")
    check(not lane[0] and not c, f"the einsum lane launched kernels: {c}")
    native, _, _ = tokens(SELDON_TPU_KV_DTYPE=None, SELDON_TPU_PAGED_KERNEL=None,
                          SELDON_TPU_PAGED_KERNEL_IMPL="stream")
    agreement = float((native == k_int8).mean())
    firsts = bool((native[:, 0] == k_int8[:, 0]).all())
    log(f"f32 greedy, 16 ragged prompts x 16 tokens: int8 K4 lane == int8 gather lane "
        f"{bool((k_int8 == g_int8).all())}, int8 K4 == int8 K5 {bool((k_int8 == k5_int8).all())}; adapters "
        f"(base/a1/a2 in turn) K4 fold == einsum lane {bool((fold == einsum).all())}; int8 vs native pool: first "
        f"tokens equal {firsts}, agreement {agreement:.4f} (limit {INT8_MIN_AGREEMENT}); launches {launches}")
    check(bool((k_int8 == g_int8).all()), "f32 int8 kernel lane and int8 gather lane disagree on greedy tokens")
    check(bool((k_int8 == k5_int8).all()), "f32 int8 stream and grid kernels disagree on greedy tokens")
    check(bool((fold == einsum).all()), "f32 fold and einsum lanes disagree on greedy tokens")
    check(firsts and agreement >= INT8_MIN_AGREEMENT, f"int8 vs native greedy agreement too low: {agreement}")
    check(not bool((fold[1::3] == native[1::3]).all()), "the adapters changed no token")

    # the served config in-process (bf16, int8 pool, adapters): each prompt
    # alone against all 16 in one wave, so in mixed-adapter prefill groups
    with knob_env(SELDON_TPU_KV_DTYPE="int8", SELDON_TPU_PAGED_KERNEL=None, SELDON_TPU_PAGED_KERNEL_IMPL="stream"):
        eng = PagedEngine(params, dtype="bfloat16", device="cuda", max_adapters=2, lora_rank=LORA_RANK,
                          weight_registry=adapter_registry(WeightRegistry, make_lora_params), **LM_CONFIG, **LM_ENGINE,
                          **NO_PREFIX_CACHE)
        alone = [eng.generate(p, max_new_tokens=Q_WAVE_NEW, adapter=a) for p, a in zip(prompts, adapters)]
        wave = [eng.submit(p, max_new_tokens=Q_WAVE_NEW, adapter=a) for p, a in zip(prompts, adapters)]
        eng.run()
    del eng
    torch.cuda.empty_cache()
    wave_same = sum(bool((s.result == r).all()) for s, r in zip(wave, alone))
    log(f"bf16 int8 + adapters, 16 ragged prompts x {Q_WAVE_NEW} tokens: one wave (mixed-adapter prefill groups) "
        f"== each prompt alone for {wave_same}/16 rows")
    check(wave_same == len(prompts), f"a stream's tokens depend on its prefill group: {wave_same}/16")

    step_tokens = torch.from_numpy(rng.integers(0, V, len(prompts))).cuda()
    with knob_env(SELDON_TPU_KV_DTYPE="int8", SELDON_TPU_PAGED_KERNEL=None, SELDON_TPU_PAGED_KERNEL_IMPL="stream"):
        got = first_step_logits(torch, np, lm_engine(PagedEngine, params, "bfloat16"), prompts, step_tokens)
    with knob_env(SELDON_TPU_KV_DTYPE=None, SELDON_TPU_PAGED_KERNEL=None, SELDON_TPU_PAGED_KERNEL_IMPL="stream"):
        ref = first_step_logits(torch, np, lm_engine(PagedEngine, params, "bfloat16"), prompts, step_tokens)
    torch.cuda.empty_cache()
    rel = float((got - ref).norm() / ref.norm())
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
    log(f"first decode step, bf16 int8 pool (K4-int8) vs bf16 native pool (K4): rel L2 {rel:.3e} (limit "
        f"{WHOLE_PATH_REL_L2}), min row cosine {cos:.6f} (limit {WHOLE_PATH_MIN_COS})")
    check(bool(torch.isfinite(got).all()), "non-finite int8 decode logits")
    check(rel <= WHOLE_PATH_REL_L2 and cos >= WHOLE_PATH_MIN_COS, "int8 decode numerics out of tolerance")
    return launches, {"int8_vs_native_rel_l2": rel, "int8_vs_native_min_cos": cos,
                      "int8_vs_native_agreement": agreement, "int8_vs_native_first_tokens_equal": firsts,
                      "wave_equals_alone_rows": wave_same}


# ---------------------------------------------------------------- phase 3d

def k2_bound(m, k, n, x_elt, out_elt, peak_flops, mem_bytes_per_s):
    """Least time for one int8_matmul: x, w (int8), scale read once and
    the output written once over the memory rate, against 2*M*N*K
    operations over the peak rate of x's type; -> (ms, bound_by, bytes,
    flops)."""
    nbytes = m * k * x_elt + k * n + n * 4 + m * n * out_elt
    flops = 2 * m * n * k
    t_bytes, t_ops = nbytes / mem_bytes_per_s, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def int8_matmul_checks(torch, np, kernels, mem_bytes_per_s, card):
    """K2 against its plain version at the cases' shapes; kernel, plain
    and library times at the first three; then K2's path, one Int8Dense
    forward at the fc1 shape with the counts set to 0 just before."""
    worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    timings = {}
    rng = np.random.default_rng(SEED + 70)
    with no_tf32(torch):
        for case, (m, k, n, dt, what) in enumerate(K2_CASES):
            dtype = getattr(torch, dt)
            x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(dtype).cuda()
            w_q, scale = (torch.from_numpy(a).cuda()
                          for a in kernels.quantize_weights(rng.standard_normal((k, n), dtype=np.float32)))
            got = kernels.int8_matmul(x, w_q, scale)
            ref = kernels.int8_matmul_reference(x, w_q, scale)
            torch.cuda.synchronize()
            label = f"int8_matmul ({m}, {k}) @ ({k}, {n}) {dt} [{what}]"
            check(got.shape == ref.shape and got.dtype == dtype, f"{label}: bad output {tuple(got.shape)}")
            g, r = got.float(), ref.float()
            check(not bool(torch.isnan(g).any()), f"{label}: NaN in the kernel's output")
            err = (g - r).abs()
            peak = r.abs().max().item()
            rel = err.max().item() / peak
            if dt == "float32":
                ok, limit = rel <= K2_F32_REL_TOL, f"{K2_F32_REL_TOL} of max |plain|"
            else:
                step = FLASH_STEP[dt]
                ok = bool((err <= step * r.abs() + step * 2.0 ** -8 * peak).all())
                limit = f"one {dt} step, rtol {step}, floor {step * 2.0 ** -8:.3e} x max |plain|"
            log(f"{label}: max_abs_err={err.max().item():.3e} max|plain|={peak:.3e} rel={rel:.3e} ({limit})")
            check(ok, f"{label} differs from its plain version")
            worst["max_abs_err"] = max(worst["max_abs_err"], err.max().item())
            worst["max_rel_err"] = max(worst["max_rel_err"], rel)
            if case >= K2_TIMED:
                continue
            row = {
                "ms": time_cuda(torch, lambda: kernels.int8_matmul(x, w_q, scale), flush_mb=K2_FLUSH_MB),
                "plain_ms": time_cuda(torch, lambda: kernels.int8_matmul_reference(x, w_q, scale),
                                      flush_mb=K2_FLUSH_MB),
                "library_ms": time_cuda(torch, lambda: torch.matmul(x, w_q.to(x.dtype)) * scale,
                                        flush_mb=K2_FLUSH_MB),
                "shape": [m, k, n], "dtype": dt, "what": what,
            }
            peak_flops = BF16_PEAK_FLOPS if dt != "float32" else F32_PEAK_FLOPS
            row["bound_ms"], row["bound_by"], row["bytes"], row["flops"] = k2_bound(
                m, k, n, x.element_size(), x.element_size(), peak_flops, mem_bytes_per_s)
            timings[case] = row
            log(f"{label}: kernel {row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, "
                f"torch.matmul(x, w.to(x.dtype)) * scale {row['library_ms'] * 1e3:.2f} us, bound "
                f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {row['bytes']} bytes, {row['flops']} flops; "
                f"{row['bound_ms'] / row['ms'] * 100:.1f}% of the roofline) [{card}]")

        # K2's path: Int8Dense, the JAX package's public entry point, at the fc1 shape
        m, k, n = K2_CASES[0][:3]
        kernel = (rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)).astype(np.float32)
        bias = rng.standard_normal(n, dtype=np.float32)
        layer = kernels.Int8Dense(kernel, bias)
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(torch.bfloat16).cuda()
        kernels.reset_launch_counts()
        y = layer(x)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["int8_matmul"]
        # the layer is K2's product plus the bias in bf16: bit for bit that
        # composition, and the product within K2's one-step bar of its plain
        # version (the bf16 rounding of the product is where a sum order other
        # than the plain version's shows; the bias add only composes it)
        product = kernels.int8_matmul(x, layer.w_q, layer.scale)
        composed = product + layer.bias.to(torch.bfloat16)
        plain = kernels.int8_matmul_reference(x, layer.w_q, layer.scale).float()
        torch.cuda.synchronize()
        exact = torch.equal(y.view(torch.int16), composed.view(torch.int16))
        err = (product.float() - plain).abs()
        step = FLASH_STEP["bfloat16"]
        ok = bool((err <= step * plain.abs() + step * 2.0 ** -8 * plain.abs().max()).all())
        log(f"Int8Dense (768 -> 3072) on ({m}, {k}) bf16: {launches} int8_matmul launch(es); output == K2's "
            f"product + bias bit for bit: {exact}; product max_abs_err vs plain {err.max().item():.3e} (one bf16 "
            f"step, floor {step * 2.0 ** -8:.3e} x max |plain|)")
        check(launches == 1, f"the Int8Dense forward launched int8_matmul {launches} times")
        check(y.shape == (m, n) and exact and ok and not bool(torch.isnan(y).any()),
              "Int8Dense output out of tolerance")
    return worst, timings, launches


# ---------------------------------------------------------------- phase 12

def precision_server(CudaServer, precision):
    """An in-process server of the phase-4 configuration and lane (its
    weights are the CLI server's: seed 0, live residual branches)."""
    cs = CudaServer(model="resnet50", normalize=True, dtype="bfloat16", max_batch_size=32, warmup=False,
                    precision=precision)
    cs.load()
    return cs


def lane_logits(torch, np, cs, images):
    with torch.inference_mode():
        return cs.apply_fn(torch.from_numpy(images).cuda()).double().cpu().numpy()


def w8a8_exact_conv(torch, np, w8a8, same_pads, cs, images):
    """One w8a8 conv of the served model on real activations: its int32
    accumulator against the float64 product of the same integers."""
    key = "blocks.1.conv1"  # 3x3, stride 1, 64 -> 64, on the 56x56 map
    layer = cs.module.get_submodule(key)
    captured = {}
    hook = layer.register_forward_hook(lambda m, i, o: captured.setdefault("x", i[0]))
    try:
        lane_logits(torch, np, cs, images)
    finally:
        hook.remove()
    x = captured["x"].permute(0, 2, 3, 1)
    xq, _ = w8a8.quantize_activation(x, layer.act_scale, reduce_axes=(1, 2, 3))
    wq, _ = w8a8._quantize_weight_last_axis(cs._qparams[key + ".weight"].dequantize(torch.float32).permute(2, 3, 1, 0))
    acc = w8a8._int_conv(xq, wq, (1, 1), "SAME")
    lo, hi = same_pads(x.shape[1], 3, 1)
    x64 = torch.nn.functional.pad(xq.double().permute(0, 3, 1, 2), (lo, hi, lo, hi))
    want = torch.nn.functional.conv2d(x64, wq.double().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    exact = bool(torch.equal(acc.double(), want))
    log(f"w8a8 {key} on {tuple(x.shape)} activations: int32 accumulator == float64 product of the same "
        f"integers: {exact} (largest |acc| {int(acc.abs().max())})")
    check(exact, f"the w8a8 integer GEMM of {key} is not exact")
    return exact


def lane_profile(torch, np, cs, images, card):
    """Device time by op of 3 forwards at batch 32 of an in-process lane."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(images).cuda()

    def step():
        with torch.inference_mode():
            cs.apply_fn(x)

    forward_ms = time_cuda(torch, step, reps=20, warm=3)
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            cs.apply_fn(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, busy_us = device_time_by_name(prof)
    groups = {"int GEMM (cuBLASLt s8)": ("s8", "i8", "imma", "int8"), "cuDNN / cuBLAS float conv + GEMM":
              ("conv", "gemm", "cutlass", "xmma", "sm90", "nvjet"), "copies (im2col, pads, casts)": ("copy", "pad", "cat")}
    shares = {g: 0.0 for g in groups}
    shares["other (quantise, rescale, dequant, BatchNorm, ...)"] = 0.0
    for name, (us, _) in by_name.items():
        low = name.lower()
        for g, keys in groups.items():
            if any(k in low for k in keys):
                shares[g] += us
                break
        else:
            shares["other (quantise, rescale, dequant, BatchNorm, ...)"] += us
    row = {"forward_ms": forward_ms, "device_busy_ms_per_forward": busy_us / 3e3,
           "idle_share": 1 - busy_us / 1e3 / wall_ms, "profiled_wall_ms_per_forward": wall_ms / 3,
           "device_ms_by_group": {g: us / 3e3 for g, us in shares.items()}}
    log(f"{cs.precision} forward (K1 + ResNet-50) batch 32: event-timed {forward_ms:.3f} ms = "
        f"{32 / forward_ms * 1e3:.1f} img/s; profiled: device busy {row['device_busy_ms_per_forward']:.3f} ms a "
        f"forward, idle share {row['idle_share']:.3f}; by group {row['device_ms_by_group']} [{card}]")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  {us / 3e3:9.3f} ms/fwd  {n // 3:5d}x  {us / max(busy_us, 1e-9):6.3f}  {name[:90]}")
    return row


def served_row_buckets(torch, np, local, groups, served_all, errs, group_batches, buckets):
    """The record C14 asks for: each served row's group (the batch of 8 is
    one request in one batch; the 8 concurrent singles went out in
    ``group_batches[1]`` batches), its error against the in-process group
    batch, and its error against in-process runs of its image alone in a
    zero-padded batch of each bucket (the batcher pads with zeros)."""
    out = []
    for i, served_row in enumerate(served_all):
        g, j = divmod(i, 8)
        by_bucket = {}
        for b in buckets:
            batch = np.zeros((b, *IMG), np.uint8)
            batch[0] = groups[g][j]
            by_bucket[b] = rel_l2(np, served_row, lane_logits(torch, np, local, batch)[0])
        what = "batch of 8 (bucket 8)" if g == 0 else f"concurrent single ({group_batches[1]} batches for 8 rows)"
        log(f"  w8a8 served row {i:2d}, {what}: rel L2 {errs[i]:.3e} vs in-process batch of 8; alone at buckets "
            + ", ".join(f"{b}: {e:.3e}" for b, e in by_bucket.items()))
        out.append({"row": i, "group": what, "rel_l2_vs_group": errs[i],
                    "rel_l2_alone_by_bucket": {str(b): e for b, e in by_bucket.items()}})
    return out


def act_scale_gap(served, local):
    """The record C14 asks for: the served process's calibrated activation
    scales (``/health/status``) against the in-process server's, layer by
    layer: how many differ, and the largest relative gap."""
    names = sorted(set(served) | set(local))
    gaps = {n: abs(served.get(n, 0.0) - local.get(n, 0.0)) / max(abs(local.get(n, 0.0)), 1e-30) for n in names}
    worst = max(names, key=gaps.get) if names else ""
    differ = sum(g > 0 for g in gaps.values())
    log(f"  w8a8 calibrated activation scales, served process vs in-process: {differ} of {len(names)} differ, "
        f"largest relative gap {gaps.get(worst, 0.0):.3e} ({worst})")
    return {"layers": len(names), "differ": differ, "max_rel_gap": gaps.get(worst, 0.0), "worst_layer": worst}


def precision_path(torch, np, kernels, w8a8, same_pads, CudaServer, card):
    """Phase 12: ResNet-50 served over REST in each int8 lane, held against
    the in-process model of the same lane and against the bf16 lane."""
    rng = np.random.default_rng(SEED + 80)
    # both lanes' servers load at once (beside the in-process bf16 reference
    # unless they launched early); both are ready before the first request,
    # so no load runs beside a window
    ctx = EARLY.take("precision", launch_precision)
    servers = ctx["servers"]
    try:
        bf16 = precision_server(CudaServer, "")
        compare = distinct_images(np, rng, 32)
        ref_bf16 = lane_logits(torch, np, bf16, compare)
        out = {"bf16_param_bytes": bf16.param_bytes}
        del bf16
        torch.cuda.empty_cache()
        statuses = {p: wait_ready(proc, base, logpath)[0] for p, (proc, base, _, logpath) in servers.items()}
        ready_s = ready_since(ctx)
        return {**out, **{p: precision_lane(torch, np, w8a8, same_pads, CudaServer, card, p, statuses[p],
                                            servers[p], compare, ref_bf16, ready_s, rng, out, early_note(ctx))
                          for p in PRECISIONS}}
    finally:
        for proc, _, logfile, _ in servers.values():
            stop_server(proc)
            logfile.close()


def launch_servers(specs):
    """Several CLI servers at once, ``specs``: name -> (component,
    parameters).  ``servers``: name -> (process, base URL, log file, log
    path); ``logfile`` closes every log, ``logpath`` is the first's."""
    servers, launched = {}, time.perf_counter()
    for name, (component, params) in specs.items():
        port = free_port()
        fd, logpath = tempfile.mkstemp(prefix=f"chip_smoke_{name}_server_", suffix=".log")
        logfile = os.fdopen(fd, "w")
        servers[name] = (start_server(port, logfile, component=component, params=params),
                         f"http://127.0.0.1:{port}", logfile, logpath)

    def ready():
        for proc, base, _, logpath in servers.values():
            wait_ready(proc, base, logpath)

    first = next(iter(servers.values()))
    return {"procs": [v[0] for v in servers.values()], "logfile": _Files([v[2] for v in servers.values()]),
            "logpath": first[3], "launched": launched, "servers": servers, "ready": ready}


def launch_precision():
    """Phase 12's two servers, one a lane."""
    return launch_servers({precision: (CUDA_COMPONENT, MODEL_PARAMS + [
        {"name": "precision", "value": precision, "type": "STRING"}]) for precision in PRECISIONS})


class _Files:
    """Several log files closed as one."""

    def __init__(self, files):
        self.files = files

    def close(self):
        for f in self.files:
            f.close()


def precision_lane(torch, np, w8a8, same_pads, CudaServer, card, precision, status, server, compare, ref_bf16,
                   ready_s, rng, out, note=""):
    """One int8 lane of phase 12 on its server, ready since ``ready_s``
    after both lanes' servers launched."""
    proc, base, _, _ = server
    try:
        log(f"ResNet-50 {precision} server ready {ready_s:.1f}s after both lanes' launch{note} (load "
            f"{status['load_time_s']:.1f}s, "
            f"precision {status['precision']}, quantize {status['quantize']}, {status['quantized_kernels']} "
            f"int8 kernels, {status['act_scales_calibrated']} activation scales, param bytes "
            f"{status['param_bytes']})")
        check(status["device"].startswith("cuda"), f"the {precision} server is not on the card")
        check((status["precision"], status["quantize"]) == (precision, "int8"), f"bad lane status {status}")
        check(status["quantized_kernels"] == PRECISION_KERNELS,
              f"{precision}: {status['quantized_kernels']} int8 kernels, not {PRECISION_KERNELS}")
        want_scales = W8A8_LAYERS if precision == "w8a8" else 0
        check(status["act_scales_calibrated"] == want_scales,
              f"{precision}: {status['act_scales_calibrated']} activation scales, not {want_scales}")
        m0 = metrics_values(http(base + "/metrics"))
        before = status["kernel_launches"]
        groups = [distinct_images(np, rng, 8), distinct_images(np, rng, 8)]
        served = [decode_logits(np, http(base + "/predict", raw_request(np, groups[0])), 8)]
        m_mid = metrics_values(http(base + "/metrics"))
        answers = concurrent(lambda i: http(base + "/predict", raw_request(np, groups[1][i:i + 1])), 8)
        served.append(np.concatenate([decode_logits(np, a, 1) for a in answers]))
        after = http(base + "/health/status")["jsonData"]["kernel_launches"]
        m1 = metrics_values(http(base + "/metrics"))
        lat = latency_window(np, base, rng, PRECISION_LATENCY_REQUESTS)
        img_s, b32_requests, b32_wall = throughput_window(np, base, rng, THROUGHPUT_CLIENTS, THROUGHPUT_SECONDS)
    finally:
        stop_server(proc)
    launches = {k: after[k] - before.get(k, 0) for k in after}
    batches = int(m1["cudaserver_batches_total"] - m0["cudaserver_batches_total"])
    int_mm_per_forward = launches["w8a8_int_mm"] / max(batches, 1)
    log(f"{precision} path: {batches} batches for the 16 checked rows, launches {launches} "
        f"({int_mm_per_forward:.1f} integer GEMMs a forward)")
    check(launches["fused_normalize"] == batches, f"{precision}: fused_normalize launches != batches")
    check(int_mm_per_forward == (W8A8_LAYERS if precision == "w8a8" else 0),
          f"{precision}: {launches['w8a8_int_mm']} integer GEMMs over {batches} forwards")

    local = precision_server(CudaServer, precision)
    ref = np.concatenate([lane_logits(torch, np, local, g) for g in groups])
    served_all = np.concatenate(served)
    errs = [rel_l2(np, served_all[i], ref[i]) for i in range(len(ref))]
    log(f"{precision} served vs in-process {precision}, {len(ref)} rows (batch of 8 + 8 concurrent singles): "
        f"max row rel L2 {max(errs):.3e} (limit {SERVED_VS_LOCAL_REL_L2})")
    if precision == "w8a8":  # C14: each served row beside its batch and in-process runs at every bucket
        group_batches = [int(m_mid["cudaserver_batches_total"] - m0["cudaserver_batches_total"]),
                         int(m1["cudaserver_batches_total"] - m_mid["cudaserver_batches_total"])]
        row_log = served_row_buckets(torch, np, local, groups, served_all, errs, group_batches,
                                     [b for b in status["buckets"] if b <= 8])
        check(len(status["act_scales"]) == W8A8_LAYERS,
              f"w8a8: /health/status shows {len(status['act_scales'])} activation scales")
        scale_gap = act_scale_gap(status["act_scales"], local.act_scales)
    check(max(errs) <= SERVED_VS_LOCAL_REL_L2, f"{precision}: served rows disagree with in-process: {errs}")

    got = lane_logits(torch, np, local, compare)
    rel = rel_l2(np, got, ref_bf16)
    cos = float(torch.nn.functional.cosine_similarity(torch.from_numpy(got), torch.from_numpy(ref_bf16),
                                                      dim=-1).min())
    top1 = float((got.argmax(-1) == ref_bf16.argmax(-1)).mean())
    log(f"{precision} vs bf16 lane, same weights, 32 images: rel L2 {rel:.3e}, min row cosine {cos:.6f}, "
        f"top-1 agreement {top1:.3f}")
    if precision == "int8w":
        check(rel <= INT8W_VS_BF16_REL_L2 and cos >= INT8W_VS_BF16_MIN_COS,
              f"int8w drifts from the bf16 lane: rel L2 {rel}, cosine {cos}")
    else:
        check(top1 >= W8A8_MIN_TOP1, f"w8a8 top-1 agreement with the bf16 lane {top1} < {W8A8_MIN_TOP1}")
    row = {"param_bytes": status["param_bytes"], "load_time_s": status["load_time_s"], "batches": batches,
           "launches": launches, "served_max_row_rel_l2": max(errs), "vs_bf16_rel_l2": rel,
           "vs_bf16_min_cos": cos, "vs_bf16_top1": top1,
           "p50_ms": pct(lat, 0.50), "p99_ms": pct(lat, 0.99), "n_latency": len(lat),
           "batch32_img_s": img_s, "batch32_requests": b32_requests, "batch32_wall_s": b32_wall}
    if precision == "w8a8":
        row["exact_int32_conv"] = w8a8_exact_conv(torch, np, w8a8, same_pads, local, compare)
        row["served_rows"] = row_log
        row["act_scales_served_vs_local"] = scale_gap
    row["profile_b32"] = lane_profile(torch, np, local, compare, card)
    log(f"ResNet-50 {precision} REST single-image latency over {len(lat)} sequential requests: p50 "
        f"{row['p50_ms']:.2f} ms, p99 {row['p99_ms']:.2f} ms; batch-32 throughput ({THROUGHPUT_CLIENTS} "
        f"clients, {b32_requests} requests in {b32_wall:.2f} s): {img_s:.1f} img/s; weights on the card "
        f"{row['param_bytes']} bytes (bf16 lane {out['bf16_param_bytes']}) [{card}]")
    del local
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------- phase 13

def reference_resnet(torch, resnet, seed: int):
    """An in-process ResNet-50 with a served node's weights: CudaServer's
    seeded init, residual branches live."""
    m = resnet.ResNet50(num_classes=NUM_CLASSES, dtype=torch.bfloat16)
    m.reset_parameters(torch.Generator().manual_seed(seed), zero_init_residual=False)
    return m.cuda().eval().to(memory_format=torch.channels_last)


def reference_logits(torch, np, kernels, model, images):
    """float64 logits of uint8 images through K1 and `model`, batches of 32."""
    scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
    out = []
    with torch.inference_mode():
        for i in range(0, len(images), 32):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + 32])).cuda()
            out.append(model(kernels.fused_normalize(x, scale, shift, torch.bfloat16)).double().cpu().numpy())
    return np.concatenate(out)


class PassThrough:
    """The pipeline's TRANSFORMER in phase 13d: data passes unchanged.
    examples/combiner_pipeline.yaml puts OUTLIER_MAHALANOBIS there in front
    of two mlps; in front of ResNet-50 its running covariance would be
    150528 x 150528, so phase 26a runs the detector in front of the mlp."""

    def transform_input(self, X, names, meta=None):
        return X


def gateway_child(spec_json: str) -> None:
    """Child process of phases 13-16: UnitSpec.from_dict -> PredictorService
    -> Gateway -> serve_gateway (sync gRPC), serving until SIGTERM.  With
    ``a4`` in the spec (phase 15; ``a4_features``): the predictor's
    PrometheusObserver, TLS from the repo's test certificates and OAuth on
    both listeners, and the tracer (its JSONL sink at
    SELDON_TPU_TRACE_EXPORT when set).  Phase 16: the spec's
    ``annotations`` go to the predictor, and ``replicas`` (gRPC ports)
    put a BalancedClient of ``build_client`` replica clients in the root
    node (the wiring of the JAX deployer's autoscaled root); on SIGTERM
    the child prints its clients' hedge counters as ``clients <name>
    {...}``."""
    import asyncio

    sys.path.insert(0, ROOT)
    from seldon_core_tpu_torch.engine import BalancedClient, PredictorService, UnitSpec, build_client
    from seldon_core_tpu_torch.engine.graph import Endpoint
    from seldon_core_tpu_torch.engine.server import Gateway, serve_gateway

    spec = json.loads(spec_json)
    features = a4_features(spec.get("a4"))
    observer = tls = auth = None
    if "observer" in features:
        from seldon_core_tpu_torch.utils.metrics import PrometheusObserver

        observer = PrometheusObserver(deployment_name=spec["name"], predictor_name=spec["name"])
    if "tls" in features:
        from seldon_core_tpu_torch.utils.tls import TlsConfig

        tls = TlsConfig(cert_file=os.path.join(TLS_DIR, "server.crt"), key_file=os.path.join(TLS_DIR, "server.key"))
    if "auth" in features:
        from seldon_core_tpu_torch.utils.auth import OAuthConfig

        auth = OAuthConfig(*A4_OAUTH)
    if "tracing" in features:
        from seldon_core_tpu_torch.runtime import knobs
        from seldon_core_tpu_torch.utils.tracing import setup_tracing

        setup_tracing(service_name="gateway", export_path=knobs.raw("SELDON_TPU_TRACE_EXPORT") or None)

    async def main():
        root = UnitSpec.from_dict(spec["graph"])
        annotations = spec.get("annotations") or {}
        clients = None
        if spec.get("replicas"):
            replicas = [build_client(UnitSpec(name=root.name, type=root.type,
                                              endpoint=Endpoint("127.0.0.1", port, "GRPC")), annotations)
                        for port in spec["replicas"]]
            clients = {root.name: BalancedClient(replicas)}
        svc = PredictorService(root, name=spec["name"], observer=observer, annotations=annotations,
                               clients=clients)
        gateway = Gateway([(svc, 1.0)])
        runner, handle = await serve_gateway(gateway, host="127.0.0.1", http_port=spec["http_port"],
                                             grpc_port=spec["grpc_port"], tls=tls, auth=auth)
        ingresses = []
        for port, threads in spec["native"]:  # one C++ front server a (port, batch threads), one gateway
            from seldon_core_tpu_torch.engine import serve_native_ingress

            ingresses.append(await serve_native_ingress(gateway, host="127.0.0.1", http_port=port,
                                                        batch_threads=threads))
            print(f"native ingress serving on port {port} with {threads} batch threads", flush=True)
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
        print("gateway serving", flush=True)
        await stop.wait()
        counters = {name: {"hedges_fired": client.hedges_fired, "hedge_wins": client.hedge_wins}
                    for name, client in svc.executor.clients.items() if hasattr(client, "hedges_fired")}
        print(f"clients {spec['name']} {json.dumps(counters)}", flush=True)
        for ingress in ingresses:
            await ingress.stop()
        await handle.stop(None)
        await runner.cleanup()
        await gateway.close()
        for unit in svc.graph.walk():
            component = svc.executor.component(unit.name)
            if hasattr(component, "unload"):
                component.unload()

    asyncio.run(main())


def a4_features(a4) -> set:
    """The parts of phase 15's request contract a gateway child puts on:
    ``True`` is all of A4_FEATURES, a list names some of them."""
    return set(A4_FEATURES) if a4 is True else set(a4 or ())


def start_gateway(name: str, graph: dict, logfile, native=(), a4=False, env=None, annotations=None, replicas=()):
    """A gateway child; ``native`` lists (port, batch threads) of native
    ingress servers to put in front of it; ``a4`` puts phase 15's request
    contract on its listeners (``a4_features``; with TLS the base URL is
    https); ``annotations`` and ``replicas`` as ``gateway_child`` says."""
    http_port, grpc_port = free_port(), free_port()
    spec = {"name": name, "graph": graph, "http_port": http_port, "grpc_port": grpc_port, "native": list(native),
            "a4": a4, "annotations": annotations or {}, "replicas": list(replicas)}
    proc = subprocess.Popen([sys.executable, "-c", "import sys, chip_smoke; chip_smoke.gateway_child(sys.argv[1])",
                             json.dumps(spec)], cwd=ROOT, stdout=logfile, stderr=subprocess.STDOUT,
                            start_new_session=True, env=env)
    scheme = "https://localhost" if "tls" in a4_features(a4) else "http://127.0.0.1"
    return proc, f"{scheme}:{http_port}", grpc_port


def wait_gateway(procs, base: str, logpath: str, timeout_s: float = 600.0) -> float:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        for proc in procs:
            if proc.poll() is not None:
                raise SmokeFailure(f"a phase 13 process exited with {proc.returncode}:\n{tail(logpath)}")
        try:
            ctx = tls_context() if base.startswith("https:") else None
            with urllib.request.urlopen(base + "/ready", timeout=10, context=ctx) as r:
                if r.status == 200:
                    return time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(READY_POLL_S)
    raise SmokeFailure(f"gateway not ready after {timeout_s}s:\n{tail(logpath)}")


def wait_listening(procs, port: int, logpath: str, timeout_s: float = 600.0) -> None:
    """Until a port on this host takes connections: the CLI listens only
    after its load and warmup."""
    import socket

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        for proc in procs:
            if proc.poll() is not None:
                raise SmokeFailure(f"a process exited with {proc.returncode}:\n{tail(logpath)}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
            return
        except OSError:
            time.sleep(READY_POLL_S)
    raise SmokeFailure(f"nothing listens on port {port} after {timeout_s}s:\n{tail(logpath)}")


def grpc_request(pb, images):
    """A uint8 rawTensor of flat rows [rows, 150528] (bench.py:645-667)."""
    import numpy as np

    req = pb.SeldonMessage()
    req.data.rawTensor.dtype = "uint8"
    req.data.rawTensor.shape.extend([len(images), int(np.prod(IMG))])
    req.data.rawTensor.data = np.ascontiguousarray(images).tobytes()
    return req


def proto_logits(pb, resp, rows: int):
    import numpy as np

    check(resp.status.status == pb.Status.SUCCESS and resp.status.code in (0, 200),
          f"gRPC answer failed: {resp.status}")
    r = resp.data.rawTensor
    arr = np.frombuffer(r.data, dtype=np.dtype(r.dtype)).reshape(tuple(r.shape))
    check(arr.shape == (rows, NUM_CLASSES), f"expected ({rows}, {NUM_CLASSES}) logits, got {arr.shape}")
    check(bool(np.isfinite(arr).all()), "non-finite logits in a served answer")
    return arr


def grpc_callable(services, grpc_server, port: int):
    import grpc

    channel = grpc.insecure_channel(f"127.0.0.1:{port}", options=grpc_server.message_size_options())
    return channel, services.unary_callable(channel, "Seldon", "Predict")


def timed_window(lane, bodies, clients: int, seconds: float, at=None):
    """load_window's closed loop, keeping each request: (start, ms, body,
    answer or the exception it raised), in order of start.  ``at`` =
    (seconds, fn) runs fn on a timer thread that many seconds in."""
    stop_at = time.perf_counter() + seconds

    def client(k):
        send, close = lane()
        out = []
        try:
            while time.perf_counter() < stop_at:
                body = (k + len(out) * clients) % len(bodies)
                t = time.perf_counter()
                try:
                    answer = send(bodies[body])
                except Exception as e:  # noqa: BLE001 — counted as a client-visible failure by the caller
                    answer = e
                out.append((t, (time.perf_counter() - t) * 1e3, body, answer))
        finally:
            close()
        return out

    timer = None
    if at is not None:
        timer = threading.Timer(at[0], at[1])
        timer.start()
    try:
        results = concurrent(client, clients)
    finally:
        if timer is not None:
            timer.join()
    return sorted((r for rs in results for r in rs), key=lambda r: r[0])


def load_window(lane, bodies, clients: int, seconds: float):
    """Closed-loop clients, each on its own connection, sending body k %
    len(bodies) until `seconds` have passed (bench.py:645-700); the last
    requests finish and count.  Returns the latencies in ms, the answers
    as (body index, answer) and the wall time to the last answer; a
    request that raised fails the window."""
    t0 = time.perf_counter()
    records = timed_window(lane, bodies, clients, seconds)
    wall = time.perf_counter() - t0
    for record in records:
        if isinstance(record[3], Exception):
            raise record[3]
    return [r[1] for r in records], [(r[2], r[3]) for r in records], wall


def grpc_lane(pb, services, grpc_server, port: int):
    def lane():
        channel, predict = grpc_callable(services, grpc_server, port)
        return (lambda req: predict(req, timeout=120)), channel.close
    return lane


def rest_lane(base: str):
    def send(data: bytes):
        req = urllib.request.Request(base + "/api/v0.1/predictions", data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())
    return lambda: (send, lambda: None)


def window_numbers(np, lat, seconds: float, clients: int):
    return {"p50_ms": pct(lat, 0.50), "p90_ms": pct(lat, 0.90), "p99_ms": pct(lat, 0.99),
            "qps": len(lat) / seconds, "requests": len(lat), "clients": clients, "seconds": seconds}


def headline_windows(np, pb, lane, images, rows_of, refs, errs, what: str, card, after_sequential=None,
                     seconds: float = GRPC_SECONDS):
    """The JAX headline's method on one lane (bench.py:1296-1345):
    latency = 4 clients of batch-1 requests for ``seconds``; throughput
    = 8 clients of batch-32 requests over three windows of GRPC_SECONDS / 3.
    Every served row is held against its image's in-process answer.
    ``after_sequential()`` runs right after the one-client window."""
    lat_bodies, tput_bodies = images["latency"], images["throughput"]
    # one client, one request at a time: the service time without queueing
    seq, answers, _ = load_window(lane, lat_bodies["bodies"], 1, GRPC_SEQUENTIAL_SECONDS)
    if after_sequential is not None:
        after_sequential()
    served_rows_errors(np, answers, lat_bodies, rows_of, refs, 1, errs)
    lat, answers, _ = load_window(lane, lat_bodies["bodies"], GRPC_LAT_CLIENTS, seconds)
    served_rows_errors(np, answers, lat_bodies, rows_of, refs, 1, errs)
    out = window_numbers(np, lat, seconds, GRPC_LAT_CLIENTS)
    out.update({"sequential_p50_ms": pct(seq, 0.50), "sequential_p99_ms": p99(seq), "sequential_max_ms": max(seq),
                "sequential_requests": len(seq)})
    windows, tput_lat = [], []
    for _ in range(GRPC_TPUT_WINDOWS):
        w_lat, w_answers, wall = load_window(lane, tput_bodies["bodies"], GRPC_TPUT_CLIENTS,
                                             GRPC_SECONDS / GRPC_TPUT_WINDOWS)
        served_rows_errors(np, w_answers, tput_bodies, rows_of, refs, 32, errs)
        windows.append(len(w_lat) * 32 / wall)
        tput_lat += w_lat
    out.update({"img_s_best": max(windows), "img_s_mean": statistics.fmean(windows), "img_s_windows": windows,
                "batch32_p50_ms": pct(tput_lat, 0.50), "batch32_p99_ms": pct(tput_lat, 0.99),
                "tput_clients": GRPC_TPUT_CLIENTS, "tput_requests": len(tput_lat)})
    log(f"{what}: one client, {len(seq)} sequential batch-1 requests: p50 {out['sequential_p50_ms']:.3f} ms, "
        f"{tail_text(seq, '.3f')}; batch-1 latency ({GRPC_LAT_CLIENTS} clients, {seconds:.0f} s, "
        f"{len(lat)} requests) "
        f"p50 {out['p50_ms']:.3f} ms, p90 {out['p90_ms']:.3f}, p99 {out['p99_ms']:.3f}, {out['qps']:.1f} QPS; "
        f"batch-32 throughput ({GRPC_TPUT_CLIENTS} clients, {GRPC_TPUT_WINDOWS} windows) best "
        f"{out['img_s_best']:.1f} img/s, mean {out['img_s_mean']:.1f} (windows "
        f"{', '.join(f'{w:.1f}' for w in windows)}) [{card}]")
    return out


def served_rows_errors(np, answers, bodies, rows_of, refs, rows: int, errs):
    """Rel L2 of every served row against its image's in-process row; a
    row nearer another image's in-process row (of the 8 singles, or of
    its own batch) fails: a row served to the wrong request."""
    for body, answer in answers:
        got = rows_of(answer, rows).astype(np.float64)
        own, pool = bodies["index"][body], bodies["pool"][body]
        for i in range(rows):
            dist = np.linalg.norm(refs[pool] - got[i], axis=1)
            check(pool[int(np.argmin(dist))] == own[i], f"served row {i} of body {body} is nearer another image")
            errs.append(float(dist[list(pool).index(own[i])] / np.linalg.norm(refs[own[i]])))


def phase13_images(np, pb, rng):
    """8 distinct single images (latency) and 8 batch-32 bodies
    (throughput), as gRPC requests and as REST JSON bodies; `index` maps
    a body to its rows of the reference array and `pool` to the rows a
    served row must be nearest its own among."""
    singles = distinct_images(np, rng, 8)
    batches = distinct_images(np, rng, 8 * 32).reshape(8, 32, *IMG)
    all_images = np.concatenate([singles, batches.reshape(-1, *IMG)])
    lat = {"index": [np.arange(i, i + 1) for i in range(8)], "pool": [np.arange(8)] * 8}
    tput = {"index": [8 + np.arange(32 * b, 32 * b + 32) for b in range(8)]}
    tput["pool"] = tput["index"]
    flat = lambda x: x.reshape(len(x), -1)  # noqa: E731 — flat rows, as the JAX headline sends them
    grpc_images = {"latency": {"bodies": [grpc_request(pb, singles[i:i + 1]) for i in range(8)], **lat},
                   "throughput": {"bodies": [grpc_request(pb, b) for b in batches], **tput}}
    rest_images = {"latency": {"bodies": [json.dumps(raw_request(np, flat(singles[i:i + 1]))).encode()
                                          for i in range(8)], **lat},
                   "throughput": {"bodies": [json.dumps(raw_request(np, flat(b))).encode() for b in batches],
                                  **tput}}
    return all_images, grpc_images, rest_images


def response_metric(resp, key: str, **tags) -> float:
    """A gauge from a gRPC answer's meta.metrics (the gateway folds in
    each node's metrics, a remote node's included)."""
    for m in resp.meta.metrics:
        if m.key == key and all(m.tags.get(k) == v for k, v in tags.items()):
            return float(m.value)
    raise SmokeFailure(f"answer carries no metric {key} {tags}")


def launch_gateway():
    """Phase 13's processes.  (a) one process: the gateway's MODEL node is
    CUDA_SERVER in-process; (b) two processes: the microservice CLI (--api
    GRPC) and a gateway whose node is its gRPC endpoint."""
    fd, logpath = tempfile.mkstemp(prefix="chip_smoke_gateway_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    launched = time.perf_counter()
    graph = {"name": "resnet50", "type": "MODEL", "implementation": "CUDA_SERVER", "parameters": GRPC_PARAMS}
    a = start_gateway("resnet50", graph, logfile)
    ms_port = free_port()
    ms = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
         "seldon_core_tpu_torch.models.cudaserver.CudaServer", "--api", "GRPC", "--host", "127.0.0.1",
         "--grpc-port", str(ms_port), "--parameters", json.dumps(GRPC_PARAMS)],
        cwd=ROOT, stdout=logfile, stderr=subprocess.STDOUT, start_new_session=True)
    remote = {"name": "resnet50", "type": "MODEL",
              "endpoint": {"host": "127.0.0.1", "port": ms_port, "transport": "GRPC"}}
    b = start_gateway("resnet50", remote, logfile)
    procs = [a[0], ms, b[0]]

    def ready():
        wait_gateway(procs, a[1], logpath)
        wait_gateway(procs, b[1], logpath)
        wait_listening(procs, ms_port, logpath)

    return {"procs": procs, "logfile": logfile, "logpath": logpath, "launched": launched, "a": a, "b": b,
            "ms_port": ms_port, "ready": ready}


def gateway_paths(torch, np, kernels, resnet, card):
    """Phases 13a-13c: the ResNet-50 SeldonDeployment over gRPC and REST,
    one process and two."""
    from seldon_core_tpu_torch.proto import pb, services
    from seldon_core_tpu_torch.runtime import grpc_server

    rng = np.random.default_rng(SEED + 13)
    all_images, grpc_images, rest_images = phase13_images(np, pb, rng)
    eight = {"index": [np.arange(8)], "pool": [np.arange(8)]}
    grpc_rows = lambda resp, rows: proto_logits(pb, resp, rows)  # noqa: E731
    rest_rows = lambda body, rows: decode_logits(np, body, rows)  # noqa: E731
    numbers, errs = {}, {"one_process": [], "two_process": []}

    # (a)'s gateway and (b)'s two processes load at once (beside the
    # in-process reference unless they launched early); all are ready
    # before (a)'s first request, so no load runs beside a window
    ctx = EARLY.take("gateway", launch_gateway)
    procs, logfile, logpath = ctx["procs"], ctx["logfile"], ctx["logpath"]
    proc, base, grpc_port = ctx["a"]
    proc_b, base_b, grpc_port_b = ctx["b"]
    ms_port = ctx["ms_port"]
    try:
        local = reference_resnet(torch, resnet, SEED)
        refs = reference_logits(torch, np, kernels, local, all_images)
        del local
        torch.cuda.empty_cache()
        wait_gateway(procs, base, logpath)
        log(f"13a gateway ready {ready_since(ctx):.1f}s after its launch{early_note(ctx)} (ResNet-50 CUDA_SERVER, "
            f"sync gRPC, port {grpc_port})")
        wait_gateway(procs, base_b, logpath)
        wait_listening(procs, ms_port, logpath)
        log(f"13b microservice (--api GRPC, port {ms_port}) and gateway ready {ready_since(ctx):.1f}s "
            f"after their launch, beside 13a's")
        m0 = metrics_values(http(base + "/metrics"))
        channel, predict = grpc_callable(services, grpc_server, grpc_port)
        try:
            answer = predict(grpc_request(pb, all_images[:8]), timeout=120)
            served_rows_errors(np, [(0, answer)], eight, grpc_rows, refs, 8, errs["one_process"])
        finally:
            channel.close()
        lane = grpc_lane(pb, services, grpc_server, grpc_port)
        numbers["grpc"] = headline_windows(np, pb, lane, grpc_images, grpc_rows, refs, errs["one_process"],
                                           "13a gRPC Seldon/Predict, one process", card)
        numbers["rest"] = headline_windows(np, pb, rest_lane(base), rest_images, rest_rows, refs,
                                           errs["one_process"], "13a REST /api/v0.1/predictions, one process",
                                           card)
        m1 = metrics_values(http(base + "/metrics"))
        labels = 'predictor="resnet50",unit="resnet50"'
        k1 = m1[f'cudaserver_kernel_launches{{kernel="fused_normalize",{labels}}}'] - \
            m0[f'cudaserver_kernel_launches{{kernel="fused_normalize",{labels}}}']
        batches = m1[f"cudaserver_batches_total{{{labels}}}"] - m0[f"cudaserver_batches_total{{{labels}}}"]
        requests = m1['seldon_api_gateway_requests_total{predictor="resnet50"}']
        failures = m1['seldon_api_gateway_failures_total{predictor="resnet50"}']
        log(f"13a gateway path: {int(requests)} requests, {int(failures)} failures, {int(batches)} batches, "
            f"mean rows/batch {m1[f'cudaserver_mean_batch_rows{{{labels}}}']:.2f}, K1 launches {int(k1)}")
        check(failures == 0, f"the gateway counted {failures} failed requests")
        check(batches > 0 and k1 == batches, f"K1 launches {k1} != {batches} batches on the gateway path")
        numbers["gateway_k1_launches"], numbers["gateway_batches"] = int(k1), int(batches)
        stop_server(proc)
        procs.remove(proc)

        # (b) the two-process deployment, loaded beside (a)
        channel, predict = grpc_callable(services, grpc_server, grpc_port_b)
        try:
            probe = grpc_request(pb, all_images[:1])
            before = predict(probe, timeout=120)
            answer = predict(grpc_request(pb, all_images[:8]), timeout=120)
            served_rows_errors(np, [(0, answer)], eight, grpc_rows, refs, 8, errs["two_process"])
            lane = grpc_lane(pb, services, grpc_server, grpc_port_b)
            numbers["two_process_grpc"] = headline_windows(np, pb, lane, grpc_images, grpc_rows, refs,
                                                           errs["two_process"], "13b gRPC, two processes", card)
            after = predict(probe, timeout=120)
        finally:
            channel.close()
        k1_b = response_metric(after, "cudaserver_kernel_launches", kernel="fused_normalize") - \
            response_metric(before, "cudaserver_kernel_launches", kernel="fused_normalize")
        batches_b = response_metric(after, "cudaserver_batches_total") - \
            response_metric(before, "cudaserver_batches_total")
        check(batches_b > 0 and k1_b == batches_b, f"two-process K1 launches {k1_b} != {batches_b} batches")
        numbers["two_process_k1_launches"], numbers["two_process_batches"] = int(k1_b), int(batches_b)
    finally:
        for proc in procs:
            stop_server(proc)
        logfile.close()

    # (c) every served row against the in-process model
    for lane_name, e in errs.items():
        log(f"13c {lane_name}: {len(e)} served rows, max rel L2 {max(e):.3e} against the in-process model "
            f"(limit {SERVED_VS_LOCAL_REL_L2})")
        check(max(e) <= SERVED_VS_LOCAL_REL_L2, f"{lane_name} served rows disagree with the in-process model")
        numbers[f"{lane_name}_rows"], numbers[f"{lane_name}_max_row_rel_l2"] = len(e), max(e)
    numbers["hop_p50_ms"] = numbers["two_process_grpc"]["p50_ms"] - numbers["grpc"]["p50_ms"]
    headline = {
        "grpc_p50_ms": numbers["grpc"]["p50_ms"], "grpc_p99_ms": numbers["grpc"]["p99_ms"],
        "grpc_qps": numbers["grpc"]["qps"], "grpc_img_s": numbers["grpc"]["img_s_best"],
        "rest_p50_ms": numbers["rest"]["p50_ms"], "rest_p99_ms": numbers["rest"]["p99_ms"],
        "rest_qps": numbers["rest"]["qps"], "rest_img_s": numbers["rest"]["img_s_best"],
        "grpc_sequential_p50_ms": numbers["grpc"]["sequential_p50_ms"],
        "rest_sequential_p50_ms": numbers["rest"]["sequential_p50_ms"],
        "two_process": {k: numbers["two_process_grpc"][m] for k, m in (
            ("grpc_p50_ms", "p50_ms"), ("grpc_p99_ms", "p99_ms"), ("grpc_qps", "qps"), ("grpc_img_s", "img_s_best"))},
        "hop_p50_ms": numbers["hop_p50_ms"], "target_p50_ms": HEADLINE_P50_MS,
        "target_met": numbers["grpc"]["p50_ms"] < HEADLINE_P50_MS, "card": card,
    }
    log("13 headline " + json.dumps(headline))
    return numbers


class LoopThread:
    """An asyncio loop on a thread of its own: the in-process gateways of
    phase 13d serve on it and the sync gRPC server bridges into it."""

    def __init__(self):
        import asyncio

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 900.0):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


def serve_in_process(loop, graph: dict):
    from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
    from seldon_core_tpu_torch.engine.server import Gateway, serve_gateway

    grpc_port = free_port()

    async def start():
        svc = PredictorService(UnitSpec.from_dict(graph), name=graph["name"])
        gateway = Gateway([(svc, 1.0)])
        runner, handle = await serve_gateway(gateway, host="127.0.0.1", http_port=free_port(),
                                             grpc_port=grpc_port)
        return svc, gateway, runner, handle

    return (*loop.run(start()), grpc_port)


def stop_in_process(loop, svc, gateway, runner, handle):
    async def stop():
        await handle.stop(None)
        await runner.cleanup()
        await gateway.close()

    loop.run(stop())
    for unit in svc.graph.walk():
        component = svc.executor.component(unit.name)
        if hasattr(component, "unload"):
            component.unload()


def graph_paths(torch, np, kernels, resnet, card):
    """Phase 13d: BASELINE.json configs 4 and 5 with ResNet-50 children,
    served in-process over sync gRPC."""
    from seldon_core_tpu_torch.proto import pb, services
    from seldon_core_tpu_torch.runtime import grpc_server

    rng = np.random.default_rng(SEED + 14)
    images = distinct_images(np, rng, 8)
    refs = {}
    for seed in (1, 2):
        model = reference_resnet(torch, resnet, seed)
        refs[seed] = reference_logits(torch, np, kernels, model, images)
        del model
    torch.cuda.empty_cache()
    member = lambda name, seed: {"name": name, "type": "MODEL", "implementation": "CUDA_SERVER",  # noqa: E731
                                 "parameters": GRPC_PARAMS + [{"name": "seed", "value": str(seed), "type": "INT"}]}
    loop = LoopThread()
    out = {}
    try:
        # config 4: an EPSILON_GREEDY router over two ResNet-50s, feedback after every predict
        mab = {"name": "eg-router", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
               "parameters": [{"name": "n_branches", "value": "2", "type": "INT"},
                              {"name": "epsilon", "value": "0.2", "type": "FLOAT"},
                              {"name": "seed", "value": str(SEED), "type": "INT"}],
               "children": [member("model-a", 1), member("model-b", 2)]}
        svc, gateway, runner, handle, port = serve_in_process(loop, mab)
        channel, predict = grpc_callable(services, grpc_server, port)
        feedback = services.unary_callable(channel, "Seldon", "SendFeedback")
        branches, errs = [], []
        try:
            for i in range(MAB_REQUESTS):
                req = grpc_request(pb, images[i % 8:i % 8 + 1])
                resp = predict(req, timeout=120)
                check("eg-router" in resp.meta.routing, f"answer {i} carries no routing: {resp.meta}")
                branch = resp.meta.routing["eg-router"]
                branches.append(branch)
                check(set(resp.meta.requestPath) == {"eg-router", ("model-a", "model-b")[branch]},
                      f"requestPath {dict(resp.meta.requestPath)} does not follow branch {branch}")
                errs.append(rel_l2(np, proto_logits(pb, resp, 1)[0].astype(np.float64), refs[1 + branch][i % 8]))
                fb = pb.Feedback(reward=float(branch == 1))
                fb.request.CopyFrom(req)
                fb.response.CopyFrom(resp)
                ack = feedback(fb, timeout=120)
                check(ack.status.status == pb.Status.SUCCESS, f"feedback {i} failed: {ack.status}")
        finally:
            channel.close()
        router = svc.executor.component("eg-router")
        counts = router.counts.tolist()
        stop_in_process(loop, svc, gateway, runner, handle)
        log(f"13d MAB (EPSILON_GREEDY over two ResNet-50s): {MAB_REQUESTS} predicts + feedback, branches "
            f"{branches.count(0)} / {branches.count(1)}, router counts {counts}, max row rel L2 against the "
            f"branch's in-process model {max(errs):.3e} (limit {SERVED_VS_LOCAL_REL_L2})")
        check(sum(counts) == MAB_REQUESTS, f"router counts {counts} do not sum to {MAB_REQUESTS}")
        check(counts == [branches.count(0), branches.count(1)], f"router counts {counts} != branches served")
        check(max(errs) <= SERVED_VS_LOCAL_REL_L2, "MAB answers disagree with their branch's in-process model")
        out["mab"] = {"requests": MAB_REQUESTS, "branches": [branches.count(0), branches.count(1)],
                      "router_counts": counts, "max_row_rel_l2": max(errs)}

        # config 5: a pass-through TRANSFORMER over an AVERAGE_COMBINER of two ResNet-50s
        pipeline = {"name": "passthrough", "type": "TRANSFORMER", "componentClass": "chip_smoke.PassThrough",
                    "children": [{"name": "ensemble", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
                                  "children": [member("member-a", 1), member("member-b", 2)]}]}
        svc, gateway, runner, handle, port = serve_in_process(loop, pipeline)
        channel, predict = grpc_callable(services, grpc_server, port)
        errs, lat = [], []
        try:
            mean = (refs[1] + refs[2]) / 2
            for i in range(2):  # untimed: the new graph's first requests
                proto_logits(pb, predict(grpc_request(pb, images[i:i + 1]), timeout=120), 1)
            for i in range(COMBINER_REQUESTS):
                req = grpc_request(pb, images[i % 8:i % 8 + 1])
                t = time.perf_counter()
                resp = predict(req, timeout=120)
                lat.append((time.perf_counter() - t) * 1e3)
                check(set(resp.meta.requestPath) == {"passthrough", "ensemble", "member-a", "member-b"},
                      f"requestPath {dict(resp.meta.requestPath)}")
                errs.append(rel_l2(np, proto_logits(pb, resp, 1)[0].astype(np.float64), mean[i % 8]))
        finally:
            channel.close()
            stop_in_process(loop, svc, gateway, runner, handle)
        log(f"13d pipeline (pass-through TRANSFORMER, AVERAGE_COMBINER of two ResNet-50s): {COMBINER_REQUESTS} "
            f"sequential gRPC requests, p50 {pct(lat, 0.5):.3f} ms, {tail_text(lat, '.3f')}; max row rel L2 "
            f"against the mean of the two in-process models {max(errs):.3e} (limit {SERVED_VS_LOCAL_REL_L2}) "
            f"[{card}]")
        check(max(errs) <= SERVED_VS_LOCAL_REL_L2, "combiner answers disagree with the in-process mean")
        out["combiner"] = {"requests": COMBINER_REQUESTS, "grpc_p50_ms": pct(lat, 0.5),
                           "grpc_p99_ms": p99(lat), "grpc_max_ms": max(lat), "max_row_rel_l2": max(errs)}
    finally:
        loop.close()
    return out


# ---------------------------------------------------------------- phase 14

def frame_lane(port: int):
    """HTTP/1.1 SRT1 frames on one keep-alive connection per client."""
    from seldon_core_tpu_torch.native.frontserver import read_http_response

    def lane():
        sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        pending = [b""]

        def send(frame: bytes):
            sock.sendall(b"POST /api/v0.1/predictions HTTP/1.1\r\nHost: localhost\r\n"
                         b"Content-Type: application/x-seldon-raw\r\nContent-Length: "
                         + str(len(frame)).encode() + b"\r\n\r\n" + frame)
            status, body, pending[0] = read_http_response(sock, pending[0], timeout_s=120)
            check(status == 200, f"frame answered {status}: {body[:300]!r}")
            return body

        return send, sock.close
    return lane


def frame_logits(np, body: bytes, rows: int):
    from seldon_core_tpu_torch import codec

    arr = codec.unpack_frame(body).array()
    check(arr.shape == (rows, NUM_CLASSES) and arr.dtype == np.float32,
          f"expected float32 ({rows}, {NUM_CLASSES}) logits in the frame, got {arr.dtype}{arr.shape}")
    check(bool(np.isfinite(arr).all()), "non-finite logits in a served frame")
    return arr


def native_stats(base: str) -> dict:
    return http(base + "/stats")  # answered in C++: requests, fast, raw, batches, rows, failures


def quiesce(base: str, max_wait_s: float = 8.0) -> None:
    """Wait until the native server's batch count stops moving (bench.py's
    quiesce): requests a C++ client left in flight at its deadline finish
    before the next window starts."""
    last, deadline = -1, time.perf_counter() + max_wait_s
    while time.perf_counter() < deadline:
        now = native_stats(base)["batches"]
        if now == last:
            return
        last = now
        time.sleep(0.2)


def batcher_means(m0, m1, labels: str):
    """The batcher's mean collection wait and enqueue -> result time (ms)
    over the requests between two ``/metrics`` reads."""
    n = m1[f"cudaserver_batched_requests_total{{{labels}}}"] - m0[f"cudaserver_batched_requests_total{{{labels}}}"]
    collect = m1[f"cudaserver_batch_collect_ms_total{{{labels}}}"] - m0[f"cudaserver_batch_collect_ms_total{{{labels}}}"]
    total = m1[f"cudaserver_batch_total_ms_total{{{labels}}}"] - m0[f"cudaserver_batch_total_ms_total{{{labels}}}"]
    return {"batcher_requests": n, "batcher_collect_mean_ms": collect / max(n, 1),
            "batcher_total_mean_ms": total / max(n, 1)}


def cpp_client_windows(load, base: str, what: str, card, after_first=None):
    """bench.py's native_model_phase schedule for one C++ client: one
    connection sequential (NATIVE_SEQUENTIAL_SECONDS), then (8 connections, depth 1) best of
    three windows of NATIVE_LOAD_SECONDS / 3, then one window at each of
    NATIVE_LOAD_DEPTHS; every answer a 2xx / grpc-status 0.
    ``after_first()`` runs once the one-connection run has drained."""
    window = NATIVE_LOAD_SECONDS / 3
    runs = [dict(load("one", NATIVE_SEQUENTIAL_SECONDS, 1, 1), connections=1, depth=1, rows=1)]
    quiesce(base)
    if after_first is not None:
        after_first()
    for _ in range(3):
        runs.append(dict(load("batch", window, 8, 1), connections=8, depth=1, rows=32))
        quiesce(base)
    for conns, depth in NATIVE_LOAD_DEPTHS:
        runs.append(dict(load("batch", window, conns, depth), connections=conns, depth=depth, rows=32))
        quiesce(base)
    for r in runs:
        check(r["ok"] > 0 and r["non2xx"] == 0 and r["errors"] == 0, f"{what}: C++ client run failed: {r}")
        r["img_s"] = r["qps"] * r["rows"]
    matched = max(runs[1:4], key=lambda r: r["qps"])
    best = max(runs[1:], key=lambda r: r["qps"])
    out = {"sequential_qps": runs[0]["qps"], "sequential_mean_ms": 1e3 / runs[0]["qps"],
           "matched_img_s": matched["img_s"], "best_img_s": best["img_s"],
           "best_at": [best["connections"], best["depth"]], "runs": runs}
    log(f"{what}: one connection, batch 1: {runs[0]['qps']:.1f} QPS ({out['sequential_mean_ms']:.3f} ms a "
        f"request); batch 32 at (8, 1) best of 3: {matched['img_s']:.1f} img/s; "
        + ", ".join(f"({r['connections']}, {r['depth']}) {r['img_s']:.1f}" for r in runs[4:])
        + f" img/s; best {best['img_s']:.1f} at ({best['connections']}, {best['depth']}) [{card}]")
    return out


def launch_native():
    """Phase 14's gateway child (13a's graph) with two native ingress
    servers in front: the default batch threads, and the other count 14c
    compares."""
    from seldon_core_tpu_torch.engine.native_ingress import BATCH_THREADS

    other_threads = next(t for t in NATIVE_BATCH_THREADS if t != BATCH_THREADS)
    fd, logpath = tempfile.mkstemp(prefix="chip_smoke_native_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    port, other_port = free_port(), free_port()
    graph = {"name": "resnet50", "type": "MODEL", "implementation": "CUDA_SERVER", "parameters": GRPC_PARAMS}
    launched = time.perf_counter()
    proc, _, _ = start_gateway("resnet50", graph, logfile, native=((port, BATCH_THREADS), (other_port, other_threads)))

    def ready():
        wait_gateway([proc], f"http://127.0.0.1:{port}", logpath)
        wait_gateway([proc], f"http://127.0.0.1:{other_port}", logpath)

    return {"procs": [proc], "logfile": logfile, "logpath": logpath, "launched": launched, "ports": (port, other_port),
            "ready": ready}


def native_paths(torch, np, kernels, resnet, card, gateway_numbers, forward_ms_b1: float):
    """Phase 14: the C++ native ingress in front of 13a's gateway child."""
    import grpc

    from seldon_core_tpu_torch import codec, native
    from seldon_core_tpu_torch.engine.native_ingress import BATCH_THREADS
    from seldon_core_tpu_torch.native import frontserver
    from seldon_core_tpu_torch.proto import pb, services
    from seldon_core_tpu_torch.runtime import grpc_server

    check(native.available(), "the port's native library (native/*.cc, g++) did not build or load")
    rng = np.random.default_rng(SEED + 13)  # phase 13's images and bodies
    all_images, grpc_images, _ = phase13_images(np, pb, rng)
    flat = lambda x: np.ascontiguousarray(x.reshape(len(x), -1))  # noqa: E731
    singles, batches = all_images[:8], all_images[8:].reshape(8, 32, *IMG)
    frame_images = {"latency": {**grpc_images["latency"],
                                "bodies": [codec.pack_frame(flat(singles[i:i + 1])) for i in range(8)]},
                    "throughput": {**grpc_images["throughput"],
                                   "bodies": [codec.pack_frame(flat(b)) for b in batches]}}
    grpc_rows = lambda resp, rows: proto_logits(pb, resp, rows)  # noqa: E731
    frame_rows = lambda body, rows: frame_logits(np, body, rows)  # noqa: E731
    numbers, errs = {}, []
    labels = 'predictor="resnet50",unit="resnet50"'
    k1_key = f'cudaserver_kernel_launches{{kernel="fused_normalize",{labels}}}'
    batches_key = f"cudaserver_batches_total{{{labels}}}"

    def metric_delta(m0, m1, key):
        return m1[key] - m0[key]

    check(BATCH_THREADS in NATIVE_BATCH_THREADS, f"the ingress default of {BATCH_THREADS} batch threads is not "
          f"one of the counts 14c compares, {NATIVE_BATCH_THREADS}")
    other_threads = next(t for t in NATIVE_BATCH_THREADS if t != BATCH_THREADS)
    ctx = EARLY.take("native", launch_native)
    (proc,), logfile, logpath = ctx["procs"], ctx["logfile"], ctx["logpath"]
    port, other_port = ctx["ports"]
    try:
        nbase, other_base = f"http://127.0.0.1:{port}", f"http://127.0.0.1:{other_port}"
        local = reference_resnet(torch, resnet, SEED)  # beside the gateway's load unless it launched early
        refs = reference_logits(torch, np, kernels, local, all_images)
        del local
        torch.cuda.empty_cache()
        wait_gateway([proc], nbase, logpath)
        ready_s = ready_since(ctx)
        wait_gateway([proc], other_base, logpath)
        log(f"14 native ingress ready in {ready_s:.1f}s{early_note(ctx)} (C++ HTTP/1.1 + h2c on port {port} in "
            f"front of 13a's "
            f"gateway, {BATCH_THREADS} batch threads; a second on port {other_port} with {other_threads}, for 14c)")
        m0, s0 = metrics_values(http(nbase + "/metrics")), native_stats(nbase)
        probes = {}

        def probe(name):
            return lambda: probes.__setitem__(name, metrics_values(http(nbase + "/metrics")))

        # (a) the headline by the JAX method: Python gRPC clients aimed at the native port
        lane = grpc_lane(pb, services, grpc_server, port)
        numbers["grpc"] = headline_windows(np, pb, lane, grpc_images, grpc_rows, refs, errs,
                                           "14a native gRPC Seldon/Predict (C++ fast lane)", card,
                                           after_sequential=probe("a_sequential"), seconds=NATIVE_GRPC_SECONDS)
        numbers["grpc"]["sequential_batcher"] = batcher_means(m0, probes["a_sequential"], labels)
        # (b) SRT1 frames over HTTP/1.1 to /api/v0.1/predictions
        flane = frame_lane(port)
        seq, answers, _ = load_window(flane, frame_images["latency"]["bodies"], 1, GRPC_SEQUENTIAL_SECONDS)
        served_rows_errors(np, answers, frame_images["latency"], frame_rows, refs, 1, errs)
        windows, tput_n = [], 0
        for _ in range(GRPC_TPUT_WINDOWS):
            w_lat, w_answers, wall = load_window(flane, frame_images["throughput"]["bodies"], GRPC_TPUT_CLIENTS,
                                                 GRPC_SECONDS / GRPC_TPUT_WINDOWS)
            served_rows_errors(np, w_answers, frame_images["throughput"], frame_rows, refs, 32, errs)
            windows.append(len(w_lat) * 32 / wall)
            tput_n += len(w_lat)
        numbers["frames"] = {"sequential_p50_ms": pct(seq, 0.5), "sequential_p99_ms": p99(seq),
                             "sequential_requests": len(seq), "img_s_best": max(windows),
                             "img_s_mean": statistics.fmean(windows), "img_s_windows": windows}
        log(f"14b SRT1 frames over HTTP/1.1: one client, {len(seq)} sequential batch-1 frames: p50 "
            f"{pct(seq, 0.5):.3f} ms, {tail_text(seq, '.3f')}; batch-32 frames ({GRPC_TPUT_CLIENTS} clients, "
            f"{GRPC_TPUT_WINDOWS} windows) best {max(windows):.1f} img/s, mean {statistics.fmean(windows):.1f} "
            f"[{card}]")
        m_ab, s_ab = metrics_values(http(nbase + "/metrics")), native_stats(nbase)
        # one multi-frame container (1, 2 and 5 rows): the Python frame lane, one raw_batch_views micro-batch
        parts = np.split(flat(singles), np.cumsum(NATIVE_CONTAINER_ROWS)[:-1])
        send, close = flane()
        try:
            body = send(codec.pack_frames(parts))
        finally:
            close()
        outs = codec.unpack_frames(body)
        check([v.shape for v in outs] == [(r, NUM_CLASSES) for r in NATIVE_CONTAINER_ROWS],
              f"container answer shapes {[v.shape for v in outs]}")
        served_rows_errors(np, [(0, np.concatenate([v.array() for v in outs]))], {"index": [np.arange(8)],
                           "pool": [np.arange(8)]}, lambda a, rows: a, refs, 8, errs)
        m_c = metrics_values(http(nbase + "/metrics"))
        container_batches = metric_delta(m_ab, m_c, batches_key)
        check(container_batches == 1, f"the container took {container_batches} batches, not one micro-batch")
        # one Seldon/PredictRaw over h2c: the gRPC message is one SRT1 frame
        channel = grpc.insecure_channel(f"127.0.0.1:{port}", options=grpc_server.message_size_options())
        try:
            raw = channel.unary_unary("/seldon.protos.Seldon/PredictRaw", request_serializer=lambda b: b,
                                      response_deserializer=lambda b: b)
            answer = raw(codec.pack_frame(flat(singles)), timeout=120)
        finally:
            channel.close()
        served_rows_errors(np, [(0, answer)], {"index": [np.arange(8)], "pool": [np.arange(8)]}, frame_rows,
                           refs, 8, errs)
        # (c) bench.py's own C++ clients (loadgen.cc): the Python client's cost taken out
        one_blob = frontserver.build_http_blob("/api/v0.1/predictions", frame_images["latency"]["bodies"][0],
                                               "application/x-seldon-raw")
        batch_blob = frontserver.build_http_blob("/api/v0.1/predictions", frame_images["throughput"]["bodies"][0],
                                                 "application/x-seldon-raw")
        http_blobs = {"one": one_blob, "batch": batch_blob}
        probe("c_before")()
        numbers["cpp_http"] = cpp_client_windows(
            lambda which, sec, conns, depth: frontserver.native_load(port, http_blobs[which], sec, conns, depth),
            nbase, "14c C++ client (loadgen.cc lg_run), SRT1 frames over HTTP/1.1", card,
            after_first=probe("c_sequential"))
        numbers["cpp_http"]["sequential_batcher"] = batcher_means(probes["c_before"], probes["c_sequential"], labels)
        grpc_blobs = {"one": grpc_images["latency"]["bodies"][0].SerializeToString(),
                      "batch": grpc_images["throughput"]["bodies"][0].SerializeToString()}
        numbers["cpp_grpc"] = cpp_client_windows(
            lambda which, sec, conns, depth: frontserver.native_load_grpc(
                port, "/seldon.protos.Seldon/Predict", grpc_blobs[which], sec, conns, depth),
            nbase, "14c C++ client (loadgen.cc lg_run_h2), uint8 rawTensor Seldon/Predict over h2c", card)
        m1, s1 = metrics_values(http(nbase + "/metrics")), native_stats(nbase)
        # (d) the counts over (a)-(c), then the fallback lane
        k1, batches = metric_delta(m0, m1, k1_key), metric_delta(m0, m1, batches_key)
        fast = s1["fast"] - s0["fast"]
        log(f"14d native path: {int(s1['requests'] - s0['requests'])} requests ({int(fast)} fast lane, "
            f"{int(s1['raw'] - s0['raw'])} Python lanes), {int(s1['failures'] - s0['failures'])} failures, "
            f"{int(s1['batches'] - s0['batches'])} C++ batches, {int(batches)} model batches, K1 launches "
            f"{int(k1)}")
        # (the /ready polls answered 503 before the ready flag rose count as failures: deltas from s0)
        check(s1["failures"] == s0["failures"], f"the native server counted {s1['failures'] - s0['failures']} failures")
        check(batches > 0 and k1 == batches, f"K1 launches {k1} != {batches} batches on the native path")
        check(s_ab["fast"] - s0["fast"] == numbers["grpc"]["sequential_requests"] + numbers["grpc"]["requests"]
              + numbers["grpc"]["tput_requests"] + numbers["frames"]["sequential_requests"] + tput_n,
              f"fast-lane count {s_ab['fast'] - s0['fast']} != the gRPC and frame requests sent through it")
        numbers.update(native_k1_launches=int(k1), native_batches=int(batches), fast_requests=int(fast),
                       raw_requests=int(s1["raw"] - s0["raw"]), container_batches=int(container_batches))
        answer = http(nbase + "/api/v0.1/predictions", raw_request(np, flat(singles[:1])))
        served_rows_errors(np, [(0, answer)], {"index": [np.arange(1)], "pool": [np.arange(8)]},
                           lambda a, rows: decode_logits(np, a, rows), refs, 1, errs)
        check(answer["meta"]["tags"].get("predictor") == "resnet50", f"JSON answer meta {answer.get('meta')}")
        channel = grpc.insecure_channel(f"127.0.0.1:{port}", options=grpc_server.message_size_options())
        try:
            fb = pb.Feedback(reward=1.0)
            fb.response.meta.puid = answer["meta"]["puid"]
            fb.response.meta.tags["predictor"].string_value = "resnet50"
            ack = services.unary_callable(channel, "Seldon", "SendFeedback")(fb, timeout=120)
        finally:
            channel.close()
        check(ack.status.status == pb.Status.SUCCESS, f"SendFeedback on the fallback lane failed: {ack.status}")
        s2 = native_stats(nbase)
        check(s2["failures"] == s0["failures"] and s2["raw"] - s1["raw"] == 2,
              f"fallback lane: {s2['raw'] - s1['raw']} Python-lane requests, {s2['failures'] - s0['failures']} failures")
        log(f"14d fallback lane: a JSON rawTensor predict and a SendFeedback served with full engine semantics; "
            f"a {len(NATIVE_CONTAINER_ROWS)}-frame container of {sum(NATIVE_CONTAINER_ROWS)} rows as "
            f"{int(container_batches)} micro-batch; PredictRaw of 8 rows")
        # (c) again, on the second front server of the same gateway: the other count of batch threads
        m_t0, s_t0 = metrics_values(http(other_base + "/metrics")), native_stats(other_base)
        other = {
            "cpp_http": cpp_client_windows(
                lambda which, sec, conns, depth: frontserver.native_load(other_port, http_blobs[which], sec, conns,
                                                                         depth),
                other_base, f"14c C++ client (lg_run), SRT1 frames over HTTP/1.1, {other_threads} batch threads",
                card),
            "cpp_grpc": cpp_client_windows(
                lambda which, sec, conns, depth: frontserver.native_load_grpc(
                    other_port, "/seldon.protos.Seldon/Predict", grpc_blobs[which], sec, conns, depth),
                other_base, f"14c C++ client (lg_run_h2), rawTensor Seldon/Predict over h2c, {other_threads} batch "
                f"threads", card),
        }
        m_t1, s_t1 = metrics_values(http(other_base + "/metrics")), native_stats(other_base)
        k1_t, batches_t = metric_delta(m_t0, m_t1, k1_key), metric_delta(m_t0, m_t1, batches_key)
        check(s_t1["failures"] == s_t0["failures"],
              f"the {other_threads}-thread native server counted {s_t1['failures'] - s_t0['failures']} failures")
        check(batches_t > 0 and k1_t == batches_t,
              f"K1 launches {k1_t} != {batches_t} batches behind the {other_threads}-thread native server")
        by_threads = {}
        for threads, source in ((BATCH_THREADS, numbers), (other_threads, other)):
            by_threads[threads] = {
                lane: {"sequential_ms": source[lane]["sequential_mean_ms"],
                       "matched_img_s": source[lane]["matched_img_s"],
                       "img_s_at": {f"{r['connections']},{r['depth']}": r["img_s"] for r in source[lane]["runs"][4:]},
                       "best_img_s": source[lane]["best_img_s"], "best_at": source[lane]["best_at"]}
                for lane in ("cpp_http", "cpp_grpc")}
        numbers["cpp_by_batch_threads"] = by_threads
        log(f"14c batch threads: {BATCH_THREADS} (the default) against {other_threads}, the same gateway and clients: "
            + json.dumps(by_threads) + f"; {int(batches_t)} batches = K1 launches behind the second server [{card}]")
    finally:
        stop_server(proc)
        logfile.close()
    log(f"14d {len(errs)} served rows, max rel L2 {max(errs):.3e} against the in-process model "
        f"(limit {SERVED_VS_LOCAL_REL_L2})")
    check(max(errs) <= SERVED_VS_LOCAL_REL_L2, "native-ingress rows disagree with the in-process model")
    numbers.update(rows=len(errs), max_row_rel_l2=max(errs))
    g = gateway_numbers["grpc"]
    headline = {
        "native_grpc_p50_ms": numbers["grpc"]["p50_ms"], "native_grpc_p99_ms": numbers["grpc"]["p99_ms"],
        "native_grpc_qps": numbers["grpc"]["qps"], "native_grpc_img_s": numbers["grpc"]["img_s_best"],
        "native_grpc_sequential_p50_ms": numbers["grpc"]["sequential_p50_ms"],
        "one_client_split_ms": {  # the C++ client's one connection at batch 1 (14c, SRT1 frames)
            "request": numbers["cpp_http"]["sequential_mean_ms"],
            "batcher_collect": numbers["cpp_http"]["sequential_batcher"]["batcher_collect_mean_ms"],
            "batcher_enqueue_to_result": numbers["cpp_http"]["sequential_batcher"]["batcher_total_mean_ms"],
            "forward_b1_phase5": forward_ms_b1},
        "native_grpc_one_client_batcher": numbers["grpc"]["sequential_batcher"],
        "native_frame_sequential_p50_ms": numbers["frames"]["sequential_p50_ms"],
        "native_frame_img_s": numbers["frames"]["img_s_best"],
        "cpp_client_grpc_img_s": numbers["cpp_grpc"]["best_img_s"],
        "cpp_client_http_img_s": numbers["cpp_http"]["best_img_s"],
        "cpp_client_grpc_sequential_ms": numbers["cpp_grpc"]["sequential_mean_ms"],
        "cpp_client_by_batch_threads": numbers["cpp_by_batch_threads"],
        "gateway_13a": {"grpc_p50_ms": g["p50_ms"], "grpc_p99_ms": g["p99_ms"], "grpc_qps": g["qps"],
                        "grpc_img_s": g["img_s_best"], "grpc_sequential_p50_ms": g["sequential_p50_ms"]},
        "target_p50_ms": HEADLINE_P50_MS, "target_met": numbers["grpc"]["p50_ms"] < HEADLINE_P50_MS, "card": card,
    }
    log("14 headline " + json.dumps(headline))
    return numbers


# ---------------------------------------------------------------- phase 15

def metric_samples(text: bytes):
    """[(name, {label: value}, value)] of a Prometheus text exposition."""
    import re

    out = []
    for line in text.decode().splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            name, _, rest = key.partition("{")
            out.append((name, dict(re.findall(r'([a-zA-Z_]\w*)="((?:[^"\\]|\\.)*)"', rest)), float(val)))
    return out


def metric_value(samples, name: str, **labels) -> float:
    """The one series of `name` whose labels include `labels`."""
    hits = [v for n, lab, v in samples if n == name and all(lab.get(k) == w for k, w in labels.items())]
    check(len(hits) == 1, f"{len(hits)} series {name} {labels} on /metrics, expected one")
    return hits[0]


def http_status(url: str, data: bytes = b"", headers=None, timeout: float = 120.0):
    """(status, JSON body) of a POST, error statuses included."""
    req = urllib.request.Request(url, data=data, headers=headers or {})
    ctx = tls_context() if url.startswith("https:") else None
    try:
        with urllib.request.urlopen(req, timeout=timeout, context=ctx) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def oauth_token(base: str) -> str:
    basic = base64.b64encode(":".join(A4_OAUTH).encode()).decode()
    status, body = http_status(base + "/oauth/token", headers={"Authorization": f"Basic {basic}"})
    check(status == 200 and body.get("token_type") == "bearer", f"/oauth/token answered {status}: {body}")
    return body["access_token"]


def a4_metadata(token: str, trace_hex: str, span: int, deadline_ms: str = A4_DEADLINE_MS):
    return (("authorization", f"Bearer {token}"), ("x-seldon-deadline-ms", deadline_ms),
            ("traceparent", f"00-{trace_hex}-{span:016x}-01"))


def a4_grpc_lane(services, grpc_server, port: int, token: str, trace_hex: str):
    """Phase 15a's clients: a TLS channel each, every request with a bearer
    token, a 10 s deadline and a traceparent of its own."""
    import itertools

    import grpc

    with open(os.path.join(TLS_DIR, "ca.crt"), "rb") as f:
        creds = grpc.ssl_channel_credentials(root_certificates=f.read())
    spans = itertools.count(1)

    def lane():
        channel = grpc.secure_channel(f"localhost:{port}", creds, options=grpc_server.message_size_options())
        predict = services.unary_callable(channel, "Seldon", "Predict")
        return (lambda req: predict(req, timeout=120, metadata=a4_metadata(token, trace_hex, next(spans)))), \
            channel.close
    return lane


def a4_window(np, lane, bodies, rows_of, refs, errs, what: str, card):
    """One window of 15a: one client's sequential batch-1 requests for
    GRPC_SEQUENTIAL_SECONDS, then GRPC_LAT_CLIENTS clients for A4_SECONDS."""
    seq, answers, _ = load_window(lane, bodies["bodies"], 1, GRPC_SEQUENTIAL_SECONDS)
    served_rows_errors(np, answers, bodies, rows_of, refs, 1, errs)
    lat, answers, _ = load_window(lane, bodies["bodies"], GRPC_LAT_CLIENTS, A4_SECONDS)
    served_rows_errors(np, answers, bodies, rows_of, refs, 1, errs)
    out = window_numbers(np, lat, A4_SECONDS, GRPC_LAT_CLIENTS)
    out.update(sequential_p50_ms=pct(seq, 0.50), sequential_requests=len(seq))
    log(f"{what}: one client, {len(seq)} sequential batch-1 requests: p50 {out['sequential_p50_ms']:.3f} ms; "
        f"{GRPC_LAT_CLIENTS} clients, {A4_SECONDS:.0f} s, {len(lat)} requests: p50 {out['p50_ms']:.3f} ms, "
        f"p99 {out['p99_ms']:.3f}, {out['qps']:.1f} QPS [{card}]")
    return out


def multipart_body(fields):
    """multipart/form-data of (name, bytes) fields, and its Content-Type."""
    boundary = "chip-smoke-" + os.urandom(8).hex()
    body = b"".join(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'.encode() + value
                    + b"\r\n" for name, value in fields)
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def read_spans(path: str, want: int, timeout_s: float = 20.0):
    """The spans of a JSONL sink, once it holds at least `want`."""
    deadline = time.perf_counter() + timeout_s
    spans = []
    while time.perf_counter() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                spans = [json.loads(line) for line in f if line.strip()]
            if len(spans) >= want:
                break
        time.sleep(0.2)
    return spans


def launch_a4():
    """Phase 15's processes.  (a) the A4 gateway (with a native port in
    front, read in (c)) and 13a's plain gateway; (b) the two-process
    deployment: the CLI (--api BOTH --tracing) and an A4 gateway whose
    node is its gRPC endpoint."""
    from seldon_core_tpu_torch.engine.native_ingress import BATCH_THREADS

    graph = {"name": "resnet50", "type": "MODEL", "implementation": "CUDA_SERVER", "parameters": GRPC_PARAMS}
    fd, logpath = tempfile.mkstemp(prefix="chip_smoke_a4_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_traces_")
    launched = time.perf_counter()
    native_port = free_port()
    a4 = start_gateway("resnet50", graph, logfile, native=((native_port, BATCH_THREADS),), a4=True)
    plain = start_gateway("resnet50", graph, logfile)
    ms_http, ms_grpc = free_port(), free_port()
    ms_spans, gw_spans = os.path.join(trace_dir, "microservice.jsonl"), os.path.join(trace_dir, "gateway.jsonl")
    ms = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
         "seldon_core_tpu_torch.models.cudaserver.CudaServer", "--api", "BOTH", "--tracing", "--host",
         "127.0.0.1", "--http-port", str(ms_http), "--grpc-port", str(ms_grpc), "--unit-id", "resnet50",
         "--parameters", json.dumps(GRPC_PARAMS)],
        cwd=ROOT, stdout=logfile, stderr=subprocess.STDOUT, start_new_session=True,
        env={**os.environ, "SELDON_TPU_TRACE_EXPORT": ms_spans})
    remote = {"name": "resnet50", "type": "MODEL",
              "endpoint": {"host": "127.0.0.1", "port": ms_grpc, "transport": "GRPC"}}
    gw = start_gateway("resnet50", remote, logfile, a4=True, env={**os.environ, "SELDON_TPU_TRACE_EXPORT": gw_spans})
    procs = [a4[0], plain[0], ms, gw[0]]

    def ready():
        for url in (a4[1], plain[1], f"http://127.0.0.1:{native_port}", gw[1]):
            wait_gateway(procs, url, logpath)
        wait_ready(ms, f"http://127.0.0.1:{ms_http}", logpath)

    return {"procs": procs, "logfile": logfile, "logpath": logpath, "launched": launched, "native_port": native_port,
            "a4": a4, "plain": plain, "gw": gw, "ms": ms, "ms_http": ms_http, "ms_grpc": ms_grpc,
            "ms_spans": ms_spans, "gw_spans": gw_spans, "ready": ready}


def a4_paths(torch, np, kernels, resnet, card):
    """Phase 15: A4 on the card, on ResNet-50 at full width.  (a) the
    gateway with TLS, OAuth, deadlines, tracing and the metrics observer
    against 13a's plain gateway, in turns; (b) correctness on the
    two-process deployment; (c) /metrics on the gateway, the
    microservice and the native port."""
    import grpc

    from seldon_core_tpu_torch.proto import pb, services
    from seldon_core_tpu_torch.runtime import grpc_server

    rng = np.random.default_rng(SEED + 15)
    all_images, grpc_images, _ = phase13_images(np, pb, rng)
    grpc_rows = lambda resp, rows: proto_logits(pb, resp, rows)  # noqa: E731
    eight = {"index": [np.arange(8)], "pool": [np.arange(8)]}
    flat = lambda x: np.ascontiguousarray(x.reshape(len(x), -1))  # noqa: E731
    numbers, errs = {}, {"15a": [], "15b": []}
    with open(os.path.join(TLS_DIR, "ca.crt"), "rb") as f:
        creds = grpc.ssl_channel_credentials(root_certificates=f.read())
    # (a)'s two gateways and (b)'s two processes load at once (beside the
    # in-process reference unless they launched early); all are ready
    # before (a)'s first request, so no load runs beside a window
    ctx = EARLY.take("a4", launch_a4)
    procs, logfile, logpath, native_port = ctx["procs"], ctx["logfile"], ctx["logpath"], ctx["native_port"]
    (a4_proc, a4_base, a4_grpc), (plain_proc, plain_base, plain_grpc) = ctx["a4"], ctx["plain"]
    (gw_proc, gw_base, gw_grpc), ms = ctx["gw"], ctx["ms"]
    ms_http, ms_grpc, ms_spans, gw_spans = ctx["ms_http"], ctx["ms_grpc"], ctx["ms_spans"], ctx["gw_spans"]
    ms_base = f"http://127.0.0.1:{ms_http}"
    try:
        local = reference_resnet(torch, resnet, SEED)
        refs = reference_logits(torch, np, kernels, local, all_images)
        del local
        torch.cuda.empty_cache()
        wait_gateway(procs, a4_base, logpath)
        wait_gateway(procs, plain_base, logpath)
        ready_s = ready_since(ctx)
        wait_gateway(procs, f"http://127.0.0.1:{native_port}", logpath)
        wait_gateway(procs, gw_base, logpath)
        wait_ready(ms, ms_base, logpath)
        ready_b = ready_since(ctx)
        token = oauth_token(a4_base)
        log(f"15a gateways ready {ready_s:.1f}s after their launch{early_note(ctx)}: A4 on (TLS and OAuth on REST "
            f"and sync gRPC, "
            f"port {a4_grpc}; tracing to the ring, the metrics observer; native port {native_port}) and 13a's plain gateway "
            f"(port {plain_grpc}); token from /oauth/token")
        trace_hex = os.urandom(16).hex()
        a4_lane = a4_grpc_lane(services, grpc_server, a4_grpc, token, trace_hex)
        plain_lane = grpc_lane(pb, services, grpc_server, plain_grpc)
        served_a4 = 0

        def a4_probe():
            send, close = a4_lane()
            try:
                answer = send(grpc_request(pb, all_images[:8]))
            finally:
                close()
            served_rows_errors(np, [(0, answer)], eight, grpc_rows, refs, 8, errs["15a"])
            return answer

        before_a4 = a4_probe()
        served_a4 += 1
        m0_plain = metric_samples(http(plain_base + "/metrics"))
        windows = {"on": [], "off": []}
        for turn in ["on", "off", "off", "on"][:2 * A4_WINDOWS]:
            lane = a4_lane if turn == "on" else plain_lane
            w = a4_window(np, lane, grpc_images["latency"], grpc_rows, refs, errs["15a"],
                          f"15a A4 {turn}, window {len(windows[turn]) + 1}", card)
            windows[turn].append(w)
            if turn == "on":
                served_a4 += w["sequential_requests"] + w["requests"]
        after_a4 = a4_probe()
        served_a4 += 1
        m1_plain = metric_samples(http(plain_base + "/metrics"))
        launches = {}
        for what, k1, batches in (
                ("a4", response_metric(after_a4, "cudaserver_kernel_launches", kernel="fused_normalize")
                 - response_metric(before_a4, "cudaserver_kernel_launches", kernel="fused_normalize"),
                 response_metric(after_a4, "cudaserver_batches_total")
                 - response_metric(before_a4, "cudaserver_batches_total")),
                ("plain", metric_value(m1_plain, "cudaserver_kernel_launches", kernel="fused_normalize")
                 - metric_value(m0_plain, "cudaserver_kernel_launches", kernel="fused_normalize"),
                 metric_value(m1_plain, "cudaserver_batches_total")
                 - metric_value(m0_plain, "cudaserver_batches_total"))):
            check(batches > 0 and k1 == batches, f"15a {what}: K1 launches {k1} != {batches} batches")
            launches[what] = {"k1": int(k1), "batches": int(batches)}
        stop_server(plain_proc)
        procs.remove(plain_proc)
        mean = lambda ws, k: statistics.fmean(w[k] for w in ws)  # noqa: E731
        summary = {turn: {k: mean(ws, k) for k in ("p50_ms", "p99_ms", "qps", "sequential_p50_ms")}
                   for turn, ws in windows.items()}
        cost = {k: summary["on"][k] - summary["off"][k] for k in ("p50_ms", "p99_ms", "qps", "sequential_p50_ms")}
        numbers["15a"] = {"windows": windows, "mean": summary, "a4_minus_plain": cost, "launches": launches,
                          "a4_requests": served_a4, "card": card}
        log("15a A4 on against off, in turns (" + ", ".join(["on", "off", "off", "on"][:2 * A4_WINDOWS])
            + "): " + json.dumps({"mean": summary, "a4_minus_plain": cost, "launches": launches}) + f" [{card}]")

        # (b) the two-process deployment, loaded beside (a)
        token_b = oauth_token(gw_base)
        log(f"15b microservice (--api BOTH --tracing, gRPC port {ms_grpc}) and A4 gateway ready {ready_b:.1f}s after "
            f"their launch, beside 15a's")
        ms_m0 = metric_samples(http(ms_base + "/metrics"))
        channel = grpc.secure_channel(f"localhost:{gw_grpc}", creds, options=grpc_server.message_size_options())
        predict = services.unary_callable(channel, "Seldon", "Predict")
        traced = [os.urandom(16).hex() for _ in range(A4_TRACED_REQUESTS)]
        try:
            for i, trace in enumerate(traced):  # single images, each with a trace of its own
                answer = predict(grpc_request(pb, all_images[i:i + 1]), timeout=120,
                                 metadata=a4_metadata(token_b, trace, i + 1))
                served_rows_errors(np, [(i, answer)], grpc_images["latency"], grpc_rows, refs, 1, errs["15b"])
            answer = predict(grpc_request(pb, all_images[:8]), timeout=120, metadata=a4_metadata(token_b, traced[0], 99))
            served_rows_errors(np, [(0, answer)], eight, grpc_rows, refs, 8, errs["15b"])
            ms_m1 = metric_samples(http(ms_base + "/metrics"))
            # refusals: a spent deadline and a missing token, on both listeners; the model runs for none
            url = gw_base + "/api/v0.1/predictions"
            body = json.dumps(raw_request(np, flat(all_images[:1]))).encode()
            auth_h = {"Authorization": f"Bearer {token_b}", "Content-Type": "application/json"}
            spent_rest = http_status(url, body, {**auth_h, "X-Seldon-Deadline-Ms": "0"})
            check(spent_rest[0] == 504 and spent_rest[1]["status"]["reason"] == "DEADLINE_EXCEEDED",
                  f"REST with X-Seldon-Deadline-Ms: 0 answered {spent_rest}")
            spent_grpc = predict(grpc_request(pb, all_images[:1]), timeout=120,
                                 metadata=a4_metadata(token_b, traced[0], 100, deadline_ms="0"))
            check(spent_grpc.status.status == pb.Status.FAILURE and spent_grpc.status.reason == "DEADLINE_EXCEEDED"
                  and "gateway grpc ingress Seldon/Predict" in spent_grpc.status.info,
                  f"gRPC with x-seldon-deadline-ms: 0 answered {spent_grpc.status}")
            no_token_rest = http_status(url, body, {"Content-Type": "application/json"})
            check(no_token_rest[0] == 401, f"REST without a token answered {no_token_rest}")
            try:
                predict(grpc_request(pb, all_images[:1]), timeout=120)
                check(False, "gRPC without a token was served")
            except grpc.RpcError as e:
                check(e.code() == grpc.StatusCode.UNAUTHENTICATED, f"gRPC without a token answered {e.code()}")
            ms_m2 = metric_samples(http(ms_base + "/metrics"))
            k1_key = dict(name="cudaserver_kernel_launches", kernel="fused_normalize")
            refused_k1 = metric_value(ms_m2, **k1_key) - metric_value(ms_m1, **k1_key)
            check(refused_k1 == 0, f"refused requests launched K1 {refused_k1} times")
            # a multipart predict answers as the same JSON predict
            status_json, as_json = http_status(url, body, auth_h)
            mp, ctype = multipart_body([("data", json.dumps(raw_request(np, flat(all_images[:1]))["data"]).encode())])
            status_mp, as_mp = http_status(url, mp, {"Authorization": f"Bearer {token_b}", "Content-Type": ctype})
            check(status_json == status_mp == 200, f"JSON / multipart predicts answered {status_json} / {status_mp}")
            multipart_err = rel_l2(np, decode_logits(np, as_mp, 1).astype(np.float64),
                                   decode_logits(np, as_json, 1).astype(np.float64))
            check(multipart_err <= SERVED_VS_LOCAL_REL_L2, f"multipart answer {multipart_err:.3e} from the JSON one")
            ms_m3 = metric_samples(http(ms_base + "/metrics"))
        finally:
            channel.close()
        k1_b = metric_value(ms_m3, **k1_key) - metric_value(ms_m0, **k1_key)
        batches_b = metric_value(ms_m3, "cudaserver_batches_total") - metric_value(ms_m0, "cudaserver_batches_total")
        check(batches_b > 0 and k1_b == batches_b, f"15b K1 launches {k1_b} != {batches_b} batches")
        # every traced request: the microservice's span is a child of the gateway's node span, one trace id
        gw_all = read_spans(gw_spans, 2 * len(traced))  # predictor.predict and the node span of each
        ms_all = read_spans(ms_spans, len(traced))
        for trace in traced:
            nodes = [s for s in gw_all if s["traceId"] == trace and s["name"] == "node.resnet50.transform_input"]
            micro = [s for s in ms_all if s["traceId"] == trace and s["name"] == "microservice.predict"]
            check(len(nodes) >= 1 and len(micro) >= 1, f"trace {trace}: {len(nodes)} node spans, {len(micro)} "
                  "microservice spans")
            node_ids = {s["spanId"] for s in nodes}
            check(all(s["parentSpanId"] in node_ids for s in micro),
                  f"trace {trace}: a microservice span's parent is not the gateway's node span")
        numbers["15b"] = {"traced_requests": len(traced), "gateway_spans": len(gw_all),
                          "microservice_spans": len(ms_all), "k1_launches": int(k1_b), "batches": int(batches_b),
                          "refused_k1_launches": int(refused_k1), "multipart_rel_l2": multipart_err,
                          "spent_rest": spent_rest[1]["status"]["info"], "spent_grpc": spent_grpc.status.info}
        log(f"15b two processes, A4 on: {len(traced)} traced requests each one trace across both processes "
            f"(the microservice's span a child of the gateway's node span); X-Seldon-Deadline-Ms: 0 -> 504 "
            f"DEADLINE_EXCEEDED / gRPC FAILURE '{spent_grpc.status.info}'; no token -> 401 / UNAUTHENTICATED; K1 "
            f"launches for the refusals {int(refused_k1)}; multipart against JSON {multipart_err:.3e}; K1 {int(k1_b)}"
            f" = {int(batches_b)} batches")

        # (c) /metrics on the A4 gateway, its native port, the two-process gateway and the microservice
        count = "seldon_api_engine_server_requests_duration_seconds_count"
        labels = dict(deployment_name="resnet50", predictor_name="resnet50", method="predictions", code="200")
        seen = {}
        for what, url in (("gateway", a4_base), ("native port", f"http://127.0.0.1:{native_port}")):
            m = metric_samples(http(url + "/metrics"))
            seen[what] = metric_value(m, count, **labels)
            check(seen[what] == served_a4, f"{what} /metrics counts {seen[what]} requests, 15a served {served_a4}")
            metric_value(m, "cudaserver_kernel_launches", kernel="fused_normalize")
        m_gw = metric_samples(http(gw_base + "/metrics"))
        hop = dict(unit="resnet50", method="predict", transport="grpc")
        hop_bytes = metric_value(m_gw, "seldon_tpu_transport_request_bytes_total", **hop)
        inflight = metric_value(m_gw, "seldon_tpu_transport_inflight", **hop)
        check(hop_bytes > 0 and inflight == 0, f"two-process hop: {hop_bytes} request bytes, in-flight {inflight}")
        metric_value(ms_m3, "cudaserver_kernel_launches", kernel="fused_normalize")
        numbers["15c"] = {"requests_counted": seen, "a4_requests": served_a4, "hop_request_bytes": hop_bytes,
                          "hop_inflight_at_rest": inflight}
        log(f"15c /metrics: {count} {seen} = the {served_a4} requests 15a served; the two-process hop "
            f"{int(hop_bytes)} request bytes, in flight {inflight} at rest; cudaserver_kernel_launches"
            f"{{kernel=\"fused_normalize\"}} on the gateway, the native port and the microservice")
    finally:
        for proc in procs:
            stop_server(proc)
        logfile.close()
    for what, e in errs.items():
        log(f"{what}: {len(e)} served rows, max rel L2 {max(e):.3e} against the in-process model "
            f"(limit {SERVED_VS_LOCAL_REL_L2})")
        check(max(e) <= SERVED_VS_LOCAL_REL_L2, f"{what} served rows disagree with the in-process model")
        numbers[f"{what}_rows"], numbers[f"{what}_max_row_rel_l2"] = len(e), max(e)
    return numbers


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- phase 16

def k1_equals_batches(k1: float, batches: float) -> bool:
    """One K1 launch per served batch (a CPU rehearsal, whose plain
    version counts nothing, replaces this)."""
    return batches > 0 and k1 == batches


def start_replica(http_port: int, grpc_port: int, logfile):
    """A microservice replica: the CLI serving 13a's parameters with
    ``--api BOTH`` (as the JAX deployer starts replicas): the gateway
    dials its gRPC port, the smoke reads its REST ``/metrics``."""
    return subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
         "seldon_core_tpu_torch.models.cudaserver.CudaServer", "--api", "BOTH", "--host", "127.0.0.1",
         "--http-port", str(http_port), "--grpc-port", str(grpc_port), "--parameters", json.dumps(GRPC_PARAMS)],
        cwd=ROOT, stdout=logfile, stderr=subprocess.STDOUT, start_new_session=True)


def kill_hard(proc) -> None:
    """SIGKILL a replica's process group, as a crash would end it."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)


def metric_sum(samples, name: str, **labels) -> float:
    """The sum of every series of `name` whose labels include `labels`."""
    return sum(v for n, lab, v in samples if n == name and all(lab.get(k) == w for k, w in labels.items()))


def replica_counts(port: int) -> dict:
    """K1 launches, batches and requests a replica's CudaServer counted."""
    s = metric_samples(http(f"http://127.0.0.1:{port}/metrics"))
    return {"k1": metric_value(s, "cudaserver_kernel_launches", kernel="fused_normalize"),
            "batches": metric_value(s, "cudaserver_batches_total"),
            "requests": metric_value(s, "cudaserver_batched_requests_total")}


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def single_bodies(np, pb, rng, n: int = 8):
    """n distinct images as uint8 rawTensor requests of one flat row each."""
    images = distinct_images(np, rng, n)
    bodies = {"bodies": [grpc_request(pb, images[i:i + 1]) for i in range(n)],
              "index": [np.arange(i, i + 1) for i in range(n)], "pool": [np.arange(n)] * n}
    return images, bodies


def warm_replica(pb, services, grpc_server, port: int, bodies) -> dict:
    """A restarted replica's first requests, sent straight to its gRPC
    port (Model/Predict) before the gateway's breaker may probe it: one
    alone, then 4 threads of 4 (batches of 1, 2 and 4 rows).  A fresh
    process's first batches stall (ROADMAP S2); warming it first keeps
    that stall out of the breaker's recovery time, and both are printed."""
    import grpc

    def send(n: int):
        with grpc.insecure_channel(f"127.0.0.1:{port}", options=grpc_server.message_size_options()) as channel:
            predict = services.unary_callable(channel, "Model", "Predict")
            out = []
            for i in range(n):
                t = time.perf_counter()
                proto_logits(pb, predict(bodies[i % len(bodies)], timeout=120), 1)
                out.append((time.perf_counter() - t) * 1e3)
            return out

    first = send(1)[0]
    rest = [ms for r in concurrent(lambda k: send(4), 4) for ms in r]
    return {"first_ms": first, "concurrent_max_ms": max(rest)}


def answer_tags(resp) -> dict:
    return {k: getattr(v, v.WhichOneof("kind")) for k, v in resp.meta.tags.items()}


def window_failures(pb, records) -> list:
    return [r for r in records if isinstance(r[3], Exception) or r[3].status.status != pb.Status.SUCCESS
            or r[3].status.code not in (0, 200)]


def check_rows(np, pb, records, bodies, refs, errs, degraded=None):
    """Every answer succeeded, carries the tags it should (``degraded``:
    None = untagged, else the primary's name) and passes 16a's row check."""
    failed = window_failures(pb, records)
    check(not failed, f"{len(failed)} client-visible failures, first: {str(failed[0][3])[:300] if failed else ''}")
    for _, _, body, resp in records:
        tags = answer_tags(resp)
        if degraded is None:
            check("degraded" not in tags and "fallback_for" not in tags, f"a primary answer carries {tags}")
        else:
            check(tags.get("degraded") is True and tags.get("fallback_for") == degraded,
                  f"a degraded answer carries {tags}")
    served_rows_errors(np, [(b, a) for _, _, b, a in records], bodies, lambda r, n: proto_logits(pb, r, n), refs,
                       1, errs)


def lat_numbers(records, seconds: float) -> dict:
    ms = [r[1] for r in records]
    return {"p50_ms": pct(ms, 0.5), "p99_ms": pct(ms, 0.99), "qps": len(ms) / seconds, "requests": len(ms)}


def child_clients(logpath: str, name: str) -> dict:
    """The hedge counters a gateway child printed on SIGTERM."""
    with open(logpath, errors="replace") as f:
        lines = [ln for ln in f if ln.startswith(f"clients {name} ")]
    check(len(lines) == 1, f"gateway {name} printed {len(lines)} client counter lines")
    return json.loads(lines[0][len(f"clients {name} "):])


def sequential(lane, bodies, n: int):
    """n requests from one client, one at a time, as timed_window records."""
    send, close = lane()
    out = []
    try:
        for i in range(n):
            body = i % len(bodies)
            t = time.perf_counter()
            answer = send(bodies[body])
            out.append((t, (time.perf_counter() - t) * 1e3, body, answer))
    finally:
        close()
    return out


def feedback_never_hedges(np, grpc_port: int) -> dict:
    """16e: a SendFeedback through a remote client built with
    ``seldon.io/hedge-ms: 1`` fires no hedge (not idempotent)."""
    import asyncio

    from seldon_core_tpu_torch.engine import UnitSpec, build_client
    from seldon_core_tpu_torch.engine.graph import Endpoint
    from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage
    from seldon_core_tpu_torch.utils import metrics

    def hedges() -> float:
        return metric_sum(metric_samples(metrics.generate_latest()), "seldon_tpu_transport_hedges_total")

    async def go():
        client = build_client(UnitSpec(name="feedback", type="MODEL", endpoint=Endpoint("127.0.0.1", grpc_port, "GRPC")),
                              {"seldon.io/hedge-ms": "1"})
        try:
            request = InternalMessage(payload=np.zeros((1, 4), np.float32), kind="tensor")
            out = await client.send_feedback(InternalFeedback(request=request, reward=1.0))
        finally:
            await client.close()
        return client, out

    before = hedges()
    client, out = asyncio.run(go())
    after = hedges()
    check(client.hedge_ms == 1.0 and client.hedges_fired == 0 and after == before,
          f"a SendFeedback under hedge-ms 1 fired {client.hedges_fired} hedges ({before} -> {after} on /metrics)")
    check(out.status is None or out.status.get("status") == "SUCCESS", f"SendFeedback failed: {out.status}")
    return {"hedge_ms": client.hedge_ms, "hedges_fired": client.hedges_fired, "hedges_metric_delta": after - before}


def launch_a2_2():
    """Every process of phase 16 but 16e's hedged gateway (it needs 16e's
    first window), together: the two replicas (same seed, same weights),
    the balanced gateway (a), the fallback gateway (d) and the unhedged
    one (e).  ``procs`` is the list of both, ``replicas`` and
    ``gateways`` the lists the phase restarts and adds to."""
    fd, logpath = tempfile.mkstemp(prefix="chip_smoke_a2_2_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    r_http, r_grpc = [free_port(), free_port()], [free_port(), free_port()]
    on_r1 = {"host": "127.0.0.1", "port": r_grpc[0], "transport": "GRPC"}
    fb_unit = "model-int8w"
    fb_graph = {"name": "model", "type": "MODEL", "endpoint": on_r1,
                "fallback": {"name": fb_unit, "type": "MODEL", "implementation": "CUDA_SERVER",
                             "parameters": GRPC_PARAMS + [{"name": "precision", "value": "int8w", "type": "STRING"}]}}
    launched = time.perf_counter()
    replicas = [start_replica(r_http[i], r_grpc[i], logfile) for i in range(2)]
    graph = {"name": "model", "type": "MODEL", "remote": True, "endpoint": on_r1}
    balanced = start_gateway("balanced", graph, logfile, annotations=A22_ANNOTATIONS, replicas=r_grpc)
    fallback = start_gateway("fallback", fb_graph, logfile, annotations=A22_ANNOTATIONS)
    off = start_gateway("hedge-off", {"name": "model", "type": "MODEL", "endpoint": on_r1}, logfile,
                        annotations=A22_ANNOTATIONS)
    gateways = [balanced[0], fallback[0], off[0]]

    def ready():
        for i in range(2):
            wait_ready(replicas[i], f"http://127.0.0.1:{r_http[i]}", logpath)
        for b in (balanced[1], fallback[1], off[1]):
            wait_gateway(replicas + gateways, b, logpath)

    return {"procs": replicas + gateways, "logfile": logfile, "logpath": logpath, "launched": launched,
            "r_http": r_http, "r_grpc": r_grpc, "replicas": replicas, "gateways": gateways, "balanced": balanced,
            "fallback": fallback, "off": off, "on_r1": on_r1, "fb_unit": fb_unit, "ready": ready}


def a2_2_paths(torch, np, kernels, resnet, CudaServer, card):
    """Phase 16: ROADMAP A2.2 on the card.  ResNet-50 (13a's served
    parameters) on two replicas behind a BalancedClient: (a) balanced
    steady state; (b) SIGKILL of one replica mid-window; (c) its restart
    and the breaker closing; (d) a fallback route to an in-process int8w
    model when the primary dies; (e) hedging, measured only."""
    from seldon_core_tpu_torch.proto import pb, services
    from seldon_core_tpu_torch.runtime import grpc_server

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 16)
    images, bodies = single_bodies(np, pb, rng)
    errs = {"16a": [], "16b": [], "16c": [], "16d": [], "16d_degraded": [], "16e": []}
    numbers = {}
    lane_of = lambda port: grpc_lane(pb, services, grpc_server, port)  # noqa: E731
    gauge = lambda s, port: metric_value(s, "seldon_tpu_transport_breaker_state",  # noqa: E731
                                         endpoint=f"127.0.0.1:{port}")
    ctx = EARLY.take("a2_2", launch_a2_2)
    logfile, logpath, r_http, r_grpc = ctx["logfile"], ctx["logpath"], ctx["r_http"], ctx["r_grpc"]
    replicas, gateways = ctx["replicas"], ctx["gateways"]
    (proc, base, port), (fb_proc, fb_base, fb_port), (off_proc, off_base, off_port) = ctx["balanced"], \
        ctx["fallback"], ctx["off"]
    on_r1, fb_unit = ctx["on_r1"], ctx["fb_unit"]
    try:
        # the in-process references, beside the processes' load unless they launched early
        local = reference_resnet(torch, resnet, SEED)
        refs = reference_logits(torch, np, kernels, local, images)
        del local
        int8w = precision_server(CudaServer, "int8w")
        int8w_refs = lane_logits(torch, np, int8w, images)
        int8w.unload()
        del int8w
        torch.cuda.empty_cache()
        for i in range(2):
            wait_ready(replicas[i], f"http://127.0.0.1:{r_http[i]}", logpath)
        ready_s = max(wait_gateway(replicas + gateways, b, logpath) for b in (base, fb_base, off_base))
        log(f"16 replicas R1 / R2 (CLI --api BOTH, gRPC ports {r_grpc}) and the balanced, fallback and unhedged "
            f"gateways ready in {ready_since(ctx):.1f}s{early_note(ctx)} (gateways {ready_s:.1f}s)")
        lane = lane_of(port)
        send, close = lane()
        try:  # untimed: each replica's first requests
            for body in bodies["bodies"][:4]:
                proto_logits(pb, send(body), 1)
        finally:
            close()
        c0 = [replica_counts(p) for p in r_http]
        seq = timed_window(lane, bodies["bodies"], 1, GRPC_SEQUENTIAL_SECONDS)
        win = timed_window(lane, bodies["bodies"], A22_CLIENTS, A22_SECONDS)
        c1 = [replica_counts(p) for p in r_http]
        check_rows(np, pb, seq + win, bodies, refs, errs["16a"])
        served = [delta(c1[i], c0[i]) for i in range(2)]
        total = len(seq) + len(win)
        shares = [d["requests"] / total for d in served]
        numbers["16a"] = {**lat_numbers(win, A22_SECONDS), "sequential_p50_ms": pct([r[1] for r in seq], 0.5),
                          "replica_requests": [d["requests"] for d in served], "shares": shares,
                          "replica_k1": [d["k1"] for d in served], "replica_batches": [d["batches"] for d in served]}
        a = numbers["16a"]
        log(f"16a balanced: one client p50 {a['sequential_p50_ms']:.3f} ms; {A22_CLIENTS} clients "
            f"{A22_SECONDS:.1f} s: p50 {a['p50_ms']:.3f} ms, p99 {a['p99_ms']:.3f}, {a['qps']:.1f} QPS; "
            f"R1 / R2 served {a['replica_requests']} of {total} ({shares[0]:.3f} / {shares[1]:.3f}); K1 "
            f"{a['replica_k1']} = batches {a['replica_batches']} [{card}]")
        check(sum(d["requests"] for d in served) == total, f"replicas counted {served}, the clients sent {total}")
        check(all(abs(x - 0.5) <= A22_SPLIT_TOL for x in shares), f"replica shares {shares} not 50% +- 5%")
        check(all(k1_equals_batches(d["k1"], d["batches"]) for d in served), f"replica K1 != batches: {served}")

        # (b) SIGKILL R2 half-way through a window of 4 clients
        killed = {}

        def kill_r2():
            killed["t"] = time.perf_counter()
            kill_hard(replicas[1])

        c0 = replica_counts(r_http[0])
        m0 = metric_samples(http(base + "/metrics"))
        win = timed_window(lane, bodies["bodies"], A22_CLIENTS, A22_SECONDS, at=(A22_SECONDS / 2, kill_r2))
        m1 = metric_samples(http(base + "/metrics"))
        c1 = replica_counts(r_http[0])
        failed = window_failures(pb, win)
        t_kill = killed["t"]
        pre = [r for r in win if r[0] + r[1] / 1e3 < t_kill]
        post = [r for r in win if r[0] > t_kill]
        around = [r for r in win if r[0] <= t_kill + 1.0 and r[0] + r[1] / 1e3 >= t_kill]
        slowest = max(r[1] for r in around)
        state = gauge(m1, r_grpc[1])
        opened = metric_value(m1, "seldon_tpu_transport_breaker_transitions_total", endpoint=f"127.0.0.1:{r_grpc[1]}",
                              to="open")
        fastfails = metric_sum(m1, "seldon_tpu_transport_breaker_fastfail_total") - \
            metric_sum(m0, "seldon_tpu_transport_breaker_fastfail_total")
        failovers = metric_sum(m1, "seldon_tpu_transport_failovers_total", transport="balanced") - \
            metric_sum(m0, "seldon_tpu_transport_failovers_total", transport="balanced")
        r1 = delta(c1, c0)
        numbers["16b"] = {"requests": len(win), "failures": len(failed), "before": lat_numbers(pre, A22_SECONDS / 2),
                          "after": lat_numbers(post, A22_SECONDS / 2), "slowest_around_kill_ms": slowest,
                          "breaker_state": state, "transitions_to_open": opened, "fastfails": fastfails,
                          "failovers": failovers, "r1_k1": r1["k1"], "r1_batches": r1["batches"]}
        b = numbers["16b"]
        log(f"16b SIGKILL R2 at {A22_SECONDS / 2:.1f} s of {A22_SECONDS:.1f}: {len(win)} requests, {len(failed)} "
            f"client-visible failures; p50 / p99 before {b['before']['p50_ms']:.3f} / {b['before']['p99_ms']:.3f} ms, "
            f"after {b['after']['p50_ms']:.3f} / {b['after']['p99_ms']:.3f}; slowest request around the kill "
            f"{slowest:.3f} ms (one failover); gateway /metrics: breaker_state{{R2}} {state:.0f}, transitions to "
            f"open {opened:.0f}, fast-fails {fastfails:.0f}, failovers {failovers:.0f}; R1 K1 {r1['k1']:.0f} = "
            f"batches {r1['batches']:.0f} [{card}]")
        check_rows(np, pb, win, bodies, refs, errs["16b"])
        check(state == 2 and opened >= 1 and fastfails > 0 and failovers > 0,
              f"after the kill the gateway reads breaker {state}, opened {opened}, fast-fails {fastfails}, "
              f"failovers {failovers}")
        check(k1_equals_batches(r1["k1"], r1["batches"]), f"R1 K1 {r1['k1']} != batches {r1['batches']}")

        # (c) restart R2 on the same ports: the breaker closes and R2 serves again
        replicas[1] = start_replica(r_http[1], r_grpc[1], logfile)
        restart_s = wait_ready(replicas[1], f"http://127.0.0.1:{r_http[1]}", logpath)[1]
        warm = warm_replica(pb, services, grpc_server, r_grpc[1], bodies["bodies"])
        t_ready = time.perf_counter()
        c0 = replica_counts(r_http[1])
        closed = {}

        def watch_gauge():
            while time.perf_counter() - t_ready < A22_RESET_S + A22_PROBE_SLACK_S + 5.0:
                if gauge(metric_samples(http(base + "/metrics")), r_grpc[1]) == 0:
                    closed["s"] = time.perf_counter() - t_ready
                    return
                time.sleep(0.02)

        watcher = threading.Thread(target=watch_gauge)
        watcher.start()
        win = timed_window(lane, bodies["bodies"], A22_CLIENTS, A22_RESET_S + A22_PROBE_SLACK_S + 2.0)
        watcher.join()
        c1 = replica_counts(r_http[1])
        r2 = delta(c1, c0)
        numbers["16c"] = {"restart_ready_s": restart_s, "warm": warm,
                          "closed_after_ready_s": closed.get("s"),
                          "requests": len(win), "r2_k1": r2["k1"], "r2_batches": r2["batches"],
                          "r2_requests": r2["requests"]}
        log(f"16c R2 restarted on its ports, ready in {restart_s:.1f}s; sent to it directly, its first request "
            f"{warm['first_ms']:.3f} ms, then 4 x 4 concurrent at most {warm['concurrent_max_ms']:.3f}; the "
            f"gateway's breaker gauge read 0 "
            f"{closed.get('s', float('nan')):.3f} s after that (limit {A22_RESET_S + A22_PROBE_SLACK_S:.1f}); "
            f"{len(win)} requests, R2 served {r2['requests']:.0f}, its K1 {r2['k1']:.0f} = batches "
            f"{r2['batches']:.0f} [{card}]")
        check_rows(np, pb, win, bodies, refs, errs["16c"])
        check(closed.get("s") is not None and closed["s"] <= A22_RESET_S + A22_PROBE_SLACK_S,
              f"the breaker of R2 did not close within {A22_RESET_S + A22_PROBE_SLACK_S} s of R2 ready")
        check(r2["requests"] > 0 and k1_equals_batches(r2["k1"], r2["batches"]),
              f"the restarted R2: {r2} (K1 must grow with its batches)")
        stop_server(proc)
        stop_server(replicas[1])

        # (d) a fallback route: the primary remote on R1, the fallback an in-process int8w model in the gateway
        base, port = fb_base, fb_port
        lane = lane_of(port)
        fb_counts = lambda s: {"k1": metric_value(s, "cudaserver_kernel_launches", kernel="fused_normalize",  # noqa
                                                  unit=fb_unit),
                               "batches": metric_value(s, "cudaserver_batches_total", unit=fb_unit),
                               "fallbacks": metric_sum(s, "seldon_tpu_graph_fallbacks_total")}
        m0, c0 = fb_counts(metric_samples(http(base + "/metrics"))), replica_counts(r_http[0])
        healthy = sequential(lane, bodies["bodies"], A22_SEQUENTIAL)
        check_rows(np, pb, healthy, bodies, refs, errs["16d"])
        channel, predict = grpc_callable(services, grpc_server, port)
        try:
            bad = pb.SeldonMessage()
            bad.data.rawTensor.dtype = "uint8"
            bad.data.rawTensor.shape.extend([1, 1000])
            bad.data.rawTensor.data = bytes(1000)
            malformed = predict(bad, timeout=120)
            spent = predict(grpc_request(pb, images[:1]), timeout=120, metadata=(("x-seldon-deadline-ms", "0"),))
        finally:
            channel.close()
        m1, c1 = fb_counts(metric_samples(http(base + "/metrics"))), replica_counts(r_http[0])
        log(f"16d primary healthy: {A22_SEQUENTIAL} sequential answers untagged, p50 "
            f"{pct([r[1] for r in healthy], 0.5):.3f} ms; a malformed row answers {malformed.status.code} "
            f"{malformed.status.reason}; x-seldon-deadline-ms 0 answers {spent.status.code} {spent.status.reason}; "
            f"fallbacks {m1['fallbacks'] - m0['fallbacks']:.0f} [{card}]")
        check(400 <= malformed.status.code < 500 and "degraded" not in answer_tags(malformed),
              f"a malformed row answered {malformed.status}")
        check(spent.status.code == 504 and spent.status.reason == "DEADLINE_EXCEEDED"
              and "degraded" not in answer_tags(spent), f"a spent deadline answered {spent.status}")
        check(m1["fallbacks"] == m0["fallbacks"], "a fallback ran while the primary was healthy")
        r1 = delta(c1, c0)
        check(r1["requests"] == A22_SEQUENTIAL and k1_equals_batches(r1["k1"], r1["batches"]),
              f"R1 counted {r1} for {A22_SEQUENTIAL} healthy requests (the refused two must not run K1)")
        check(m1["k1"] == m0["k1"] and m1["batches"] == m0["batches"], "the fallback ran K1 while R1 was healthy")
        kill_hard(replicas[0])
        t_kill = time.perf_counter()
        degraded = sequential(lane, bodies["bodies"], A22_SEQUENTIAL)
        first_s = degraded[0][0] + degraded[0][1] / 1e3 - t_kill
        m2 = fb_counts(metric_samples(http(base + "/metrics")))
        check_rows(np, pb, degraded, bodies, int8w_refs, errs["16d_degraded"], degraded="model")
        fb = delta(m2, m1)
        check(fb["fallbacks"] == A22_SEQUENTIAL, f"fallbacks counter grew {fb['fallbacks']} for {A22_SEQUENTIAL}")
        check(k1_equals_batches(fb["k1"], fb["batches"]), f"fallback K1 {fb['k1']} != batches {fb['batches']}")
        replicas[0] = start_replica(r_http[0], r_grpc[0], logfile)
        wait_ready(replicas[0], f"http://127.0.0.1:{r_http[0]}", logpath)
        warm = warm_replica(pb, services, grpc_server, r_grpc[0], bodies["bodies"])
        t_ready = time.perf_counter()
        resumed, send_close = None, lane()
        try:
            while time.perf_counter() - t_ready < A22_RESET_S + A22_PROBE_SLACK_S + 5.0:
                resp = send_close[0](bodies["bodies"][0])
                if "degraded" not in answer_tags(resp):
                    resumed = time.perf_counter() - t_ready
                    break
        finally:
            send_close[1]()
        open_p50 = pct([r[1] for r in degraded[10:]], 0.5)
        numbers["16d"] = {"healthy_p50_ms": pct([r[1] for r in healthy], 0.5), "malformed": malformed.status.code,
                          "spent": spent.status.code, "first_degraded_s": first_s, "degraded_p50_ms": open_p50,
                          "degraded_p99_ms": p99([r[1] for r in degraded[10:]]), "fallbacks": fb["fallbacks"],
                          "fallback_k1": fb["k1"], "fallback_batches": fb["batches"], "r1_warm": warm,
                          "resumed_after_ready_s": resumed}
        d = numbers["16d"]
        log(f"16d SIGKILL R1: first degraded answer {first_s * 1e3:.3f} ms after the kill; {A22_SEQUENTIAL} "
            f"answers degraded / fallback_for model, p50 {open_p50:.3f} ms with the breaker open (requests 11-"
            f"{A22_SEQUENTIAL}; healthy p50 {d['healthy_p50_ms']:.3f}); fallbacks {fb['fallbacks']:.0f}; fallback "
            f"K1 {fb['k1']:.0f} = batches {fb['batches']:.0f}; R1 restarted (sent to it directly, its first request "
            f"{warm['first_ms']:.3f} ms, then at most {warm['concurrent_max_ms']:.3f}), untagged answers "
            f"{resumed if resumed is None else f'{resumed:.3f} s'} after that [{card}]")
        check(resumed is not None and resumed <= A22_RESET_S + A22_PROBE_SLACK_S,
              "untagged answers did not resume once R1 was back")
        stop_server(fb_proc)

        # (e) hedging on R1, measured only: off, then on at the unhedged p90, in turns
        c0 = replica_counts(r_http[0])
        first = timed_window(lane_of(off_port), bodies["bodies"], A22_CLIENTS, A22_HEDGE_P90_SECONDS)
        hedge_ms = pct([r[1] for r in first], 0.9)
        on_proc, on_base, on_port = start_gateway(
            "hedge-on", {"name": "model", "type": "MODEL", "endpoint": on_r1}, logfile,
            annotations={**A22_ANNOTATIONS, "seldon.io/hedge-ms": f"{hedge_ms:.3f}"})
        gateways.append(on_proc)
        wait_gateway([replicas[0], off_proc, on_proc], on_base, logpath)
        windows, records = [], list(first)
        for name, p in (("off", off_port), ("on", on_port), ("on", on_port), ("off", off_port)):
            win = timed_window(lane_of(p), bodies["bodies"], A22_CLIENTS, A22_HEDGE_SECONDS)
            records += win
            windows.append({"hedge": name, **lat_numbers(win, A22_HEDGE_SECONDS)})
        m = metric_samples(http(on_base + "/metrics"))
        fired, wins = metric_sum(m, "seldon_tpu_transport_hedges_total"), metric_sum(m, "seldon_tpu_transport_hedge_wins_total")
        fb_hedge = feedback_never_hedges(np, r_grpc[0])
        c1 = replica_counts(r_http[0])
        stop_server(on_proc)
        counters = child_clients(logpath, "hedge-on")["model"]
        r1 = delta(c1, c0)
        numbers["16e"] = {"hedge_ms": hedge_ms, "windows": windows, "hedges_fired": fired, "hedge_wins": wins,
                          "client": counters, "feedback": fb_hedge, "r1_k1": r1["k1"], "r1_batches": r1["batches"],
                          "r1_requests": r1["requests"], "client_requests": len(records)}
        log(f"16e hedging at seldon.io/hedge-ms {hedge_ms:.3f} (p90 of {len(first)} unhedged requests): "
            + "; ".join(f"{w['hedge']} p50 {w['p50_ms']:.3f} ms, p99 {w['p99_ms']:.3f}, {w['qps']:.1f} QPS"
                        for w in windows)
            + f"; /metrics hedges {fired:.0f}, wins {wins:.0f} (client {counters}); R1 served {r1['requests']:.0f} "
            f"rows for {len(records)} requests, K1 {r1['k1']:.0f} = batches {r1['batches']:.0f}; SendFeedback "
            f"under hedge-ms 1 fired {fb_hedge['hedges_fired']} hedges [{card}]")
        check_rows(np, pb, records, bodies, refs, errs["16e"])
        check(fired == counters["hedges_fired"] and wins == counters["hedge_wins"],
              f"/metrics hedges {fired} / wins {wins} != the client's {counters}")
        check(k1_equals_batches(r1["k1"], r1["batches"]), f"R1 K1 {r1['k1']} != batches {r1['batches']}")
        check(len(records) <= r1["requests"] <= len(records) + fired,
              f"R1 served {r1['requests']} rows for {len(records)} requests and {fired} hedges")
    finally:
        for p in gateways + replicas:
            if p is not None:
                stop_server(p)
        logfile.close()
    for name, e in errs.items():
        limit_refs = "int8w" if name == "16d_degraded" else "bf16"
        log(f"16 rows {name}: {len(e)} served rows, max rel L2 {max(e):.3e} against the in-process {limit_refs} "
            f"model (limit {SERVED_VS_LOCAL_REL_L2})")
        check(max(e) <= SERVED_VS_LOCAL_REL_L2, f"16 {name} rows disagree with the in-process model")
        numbers[f"{name}_max_row_rel_l2"] = max(e)
    numbers["seconds"] = time.perf_counter() - t_phase
    log(f"16 A2.2 phase wall time {numbers['seconds']:.1f} s [{card}]")
    return numbers


# ---------------------------------------------------------------- phase 17

def resnet_flax_variables(np, model):
    """A port ResNet's weights as flax's ``{"params", "batch_stats"}`` tree
    (float32 numpy): conv OIHW -> HWIO, dense (out, in) -> (in, out),
    BatchNorm weight / bias / running stats -> scale / bias / mean / var,
    ``blocks.N.convK`` -> ``<BlockClass>_N/Conv_K``.  The inverse of
    ``convert.resnet_params_from_flax``: what a user's flax checkpoint of
    these weights holds."""
    import re

    tree = {"params": {}, "batch_stats": {}}
    norm = {"weight": ("params", "scale"), "bias": ("params", "bias"), "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var")}
    for key, t in model.state_dict().items():
        *mods, name = key.split(".")
        if mods[0] == "blocks":
            layer = re.match(r"^(conv|bn)(\d+)$", mods[2])
            part = ({"conv": "Conv_", "bn": "BatchNorm_"}[layer.group(1)] + layer.group(2)) if layer else mods[2]
            path = [f"{type(model.blocks[int(mods[1])]).__name__}_{mods[1]}", part]
        else:
            path = mods
        arr = t.detach().float().cpu().numpy()
        if name == "weight" and arr.ndim in (2, 4):  # a conv or the head: a kernel
            collection, leaf = "params", "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        else:
            collection, leaf = norm[name]
        node = tree[collection]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def leaf_digests(torch, np, tree, prefix=""):
    """{path: {dtype, shape, sha256}} of a restored tree (digest.json's form)."""
    import hashlib

    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(leaf_digests(torch, np, v, path + "/"))
            continue
        if isinstance(v, torch.Tensor):  # bfloat16: its bits
            dtype, data = "bfloat16", v.contiguous().view(torch.int16).numpy()
        else:
            data = np.ascontiguousarray(v)
            dtype = str(data.dtype)
        out[path] = {"dtype": dtype, "shape": list(data.shape), "sha256": hashlib.sha256(data.tobytes()).hexdigest()}
    return out


def launch_a5(torch, np, resnet, load_lm_params, make_lora_params):
    """Phase 17's checkpoints, the ones a user would hand over, written by
    the port's own flax writer, and its three servers, loading together
    from them."""
    from seldon_core_tpu_torch.models import convert
    from seldon_core_tpu_torch.utils import serialization

    tmp = tempfile.mkdtemp(prefix="chip_smoke_a5_")
    fd, logpath = tempfile.mkstemp(prefix="chip_smoke_a5_a6_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    t0 = time.perf_counter()
    local = reference_resnet(torch, resnet, SEED)
    tree = resnet_flax_variables(np, local)
    back = convert.resnet_params_from_flax(tree)
    seeded = local.state_dict()
    check(set(back) == set(seeded) and all(torch.equal(back[k], seeded[k].float().cpu()) for k in seeded),
          "resnet_params_from_flax(resnet_flax_variables(model)) is not the model's state_dict bit for bit")
    resnet_dir = os.path.join(tmp, "resnet50")
    os.makedirs(resnet_dir)
    data = serialization.to_bytes(tree)
    with open(os.path.join(resnet_dir, "variables.msgpack"), "wb") as f:
        f.write(data)
    resnet_write_s, resnet_bytes = time.perf_counter() - t0, len(data)
    del tree, back, data
    t0 = time.perf_counter()
    lm_state = load_lm_params("", LM_CONFIG, CKPT_LM_SEED)
    factors = make_lora_params(CKPT_ADAPTER_SEED, num_layers=LM_CONFIG["num_layers"],
                               d_model=LM_CONFIG["d_model"], rank=LORA_RANK)
    lm_path, adapter_path = os.path.join(tmp, "lm.msgpack"), os.path.join(tmp, "adapter.msgpack")
    with open(lm_path, "wb") as f:
        f.write(serialization.to_bytes(convert.lm_flax_params(lm_state)))
    with open(adapter_path, "wb") as f:
        f.write(serialization.to_bytes(factors))
    lm_write_s = time.perf_counter() - t0
    log(f"17 checkpoints written by utils/serialization.to_bytes: ResNet-50 {resnet_bytes} bytes in "
        f"{resnet_write_s:.2f} s (resnet_params_from_flax gives the seeded state_dict back bit for bit); "
        f"StreamingLM {os.path.getsize(lm_path)} bytes + rank-{LORA_RANK} adapter "
        f"{os.path.getsize(adapter_path)} bytes in {lm_write_s:.2f} s")

    # the three servers load together
    ports = [free_port() for _ in range(3)]
    bases = [f"http://127.0.0.1:{p}" for p in ports]
    launched = time.perf_counter()
    servers = [
        start_server(ports[0], logfile, params=MODEL_PARAMS + [
            {"name": "model_uri", "value": f"file://{resnet_dir}", "type": "STRING"}]),
        start_server(ports[1], logfile, "seldon_core_tpu_torch.models.paged.StreamingLM",
                     LM_PARAMS + [
                         {"name": "model_uri", "value": f"file://{lm_path}", "type": "STRING"},
                         {"name": "adapters", "type": "JSON",
                          "value": json.dumps({"ckpt": {"uri": f"file://{adapter_path}"}})},
                         {"name": "max_adapters", "value": "1", "type": "INT"},
                         {"name": "lora_rank", "value": str(LORA_RANK), "type": "INT"}],
                     env=dict(os.environ, **NO_PREFIX_CACHE_ENV)),
        start_server(ports[2], logfile, params=VIT_MULTI_PARAMS)]
    ctx = {"procs": servers, "logfile": logfile, "logpath": logpath, "launched": launched, "bases": bases,
           "tmp": tmp, "local": local, "seeded": seeded, "factors": factors, "resnet_dir": resnet_dir,
           "resnet_bytes": resnet_bytes, "resnet_write_s": resnet_write_s, "ready_each": [None] * 3}

    def ready():
        for i, (proc, base) in enumerate(zip(servers, bases)):
            wait_ready(proc, base, logpath)
            ctx["ready_each"][i] = time.perf_counter() - launched

    ctx.update(ready=ready, cleanup=lambda: shutil.rmtree(tmp, ignore_errors=True))
    return ctx


def a5_a6_paths(torch, np, kernels, resnet, vit, CudaServer, PagedEngine, load_lm_params, WeightRegistry,
                make_lora_params, mem_bytes_per_s, card):
    """Phase 17: ROADMAP A5 and A6 on the card.  (a) ResNet-50 from a
    model_uri msgpack directory; (b) StreamingLM and a {"uri": ...}
    adapter from model_uri; (c) the committed orbax fixture through
    libzstd; (d) ViT-B/16 serving 224 and 384 from one server."""
    from seldon_core_tpu_torch.runtime import MicroserviceError
    from seldon_core_tpu_torch.utils import orbax

    t_phase = time.perf_counter()
    numbers = {}
    ctx = EARLY.take("a5", lambda: launch_a5(torch, np, resnet, load_lm_params, make_lora_params))
    servers, bases, logfile, logpath, launched = (ctx[k] for k in ("procs", "bases", "logfile", "logpath",
                                                                   "launched"))
    local, seeded, factors, resnet_dir = ctx["local"], ctx["seeded"], ctx["factors"], ctx["resnet_dir"]
    resnet_bytes, resnet_write_s = ctx["resnet_bytes"], ctx["resnet_write_s"]
    del ctx["local"], ctx["seeded"]

    note = early_note(ctx).replace(" (", ", ").rstrip(")")

    def ready_since_each(i):  # the three loaded side by side
        return ctx["ready_each"][i] if ctx["ready_each"][i] is not None else time.perf_counter() - launched

    try:
        # 17c meanwhile: the committed orbax fixture, read through libzstd
        fixture = os.path.join(ORBAX_FIXTURE, "resnet_tiny")
        if orbax.zstd_available():
            t0 = time.perf_counter()
            restored = orbax.restore(fixture)
            read_s = time.perf_counter() - t0
            with open(os.path.join(ORBAX_FIXTURE, "digest.json")) as f:
                want = json.load(f)
            got = leaf_digests(torch, np, restored)
            check(got == want, f"17c: the orbax fixture's leaves differ from orbax's restore: "
                               f"{sorted(k for k in want if got.get(k) != want[k])[:5]}")
            images = np.load(os.path.join(ORBAX_FIXTURE, "images.npy"))
            jax_logits = np.load(os.path.join(ORBAX_FIXTURE, "logits.npy"))
            with no_tf32(torch):
                cs = CudaServer(model="resnet_tiny", num_classes=10, dtype="float32", normalize=True,
                                max_batch_size=4, warmup=False, model_uri=fixture)
                cs.load()
                try:
                    logits = np.asarray(cs.predict(images, []))
                finally:
                    cs.unload()
            err = float(np.max(np.abs(logits - jax_logits) / (ORBAX_LOGITS_TOL + np.abs(jax_logits))))
            ok = bool(np.allclose(logits, jax_logits, rtol=ORBAX_LOGITS_TOL, atol=ORBAX_LOGITS_TOL))
            log(f"17c orbax fixture ({len(got)} leaves, read in {read_s * 1e3:.1f} ms through libzstd): every leaf's "
                f"SHA-256 equals orbax's restore; CudaServer float32 logits vs the JAX server's: max |diff| "
                f"{float(np.max(np.abs(logits - jax_logits))):.3e} (rtol = atol = {ORBAX_LOGITS_TOL})")
            check(ok, f"17c: the fixture's logits differ from the JAX server's: {err}")
            numbers["17c"] = {"libzstd": True, "leaves": len(got), "read_ms": read_s * 1e3,
                              "max_abs_diff": float(np.max(np.abs(logits - jax_logits)))}
        else:
            try:
                CudaServer(model="resnet_tiny", num_classes=10, dtype="float32", warmup=False,
                           model_uri=fixture).load()
                check(False, "17c: the orbax fixture loaded without libzstd")
            except MicroserviceError as e:
                check(e.reason == "BAD_CHECKPOINT" and "libzstd" in str(e), f"17c: not the named refusal: {e}")
            log("17c: libzstd.so.1 does not load on this host; the orbax lane refuses with BAD_CHECKPOINT naming "
                "it (ROADMAP A5.2)")
            numbers["17c"] = {"libzstd": False}

        # 17a: the loaded weights bit for bit, then the served rows
        cs = CudaServer(model="resnet50", normalize=True, dtype="bfloat16", max_batch_size=32, warmup=False,
                        model_uri=f"file://{resnet_dir}")
        cs.load()
        loaded = cs.module.state_dict()
        same = set(loaded) == set(seeded) and all(torch.equal(loaded[k], seeded[k]) for k in seeded)
        inproc_times = dict(cs.checkpoint_times)
        cs.unload()
        del cs, loaded, local, seeded
        torch.cuda.empty_cache()
        check(same, "17a: the state_dict loaded from model_uri differs from the seeded one")
        status, _ = wait_ready(servers[0], bases[0], logpath)
        ready_s = ready_since_each(0)
        times = status["checkpoint_times"]
        rng = np.random.default_rng(SEED + 17)
        m0 = metrics_values(http(bases[0] + "/metrics"))
        before = status["kernel_launches"]
        err = served_rows_check(torch, np, kernels, resnet, bases[0], rng)
        after = http(bases[0] + "/health/status")["jsonData"]["kernel_launches"]
        m1 = metrics_values(http(bases[0] + "/metrics"))
        batches = int(m1["cudaserver_batches_total"] - m0["cudaserver_batches_total"])
        k1 = after["fused_normalize"] - before.get("fused_normalize", 0)
        numbers["17a"] = {"bytes": resnet_bytes, "write_s": resnet_write_s, "checkpoint_times": times,
                          "in_process_checkpoint_times": inproc_times, "load_time_s": status["load_time_s"],
                          "ready_s": ready_s, "max_row_rel_l2": err, "k1": k1, "batches": batches}
        log(f"17a ResNet-50 from model_uri (a directory, {resnet_bytes} bytes of float32 msgpack): the CLI server "
            f"ready {ready_s:.1f} s after its launch (three servers loading at once{note}), load {status['load_time_s']:.2f} s of which download "
            f"{times['download_s'] * 1e3:.1f} ms, decode {times['decode_s'] * 1e3:.1f} ms, convert "
            f"{times['convert_s'] * 1e3:.1f} ms, pin {times['pin_s'] * 1e3:.1f} ms (in-process: "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in inproc_times.items())
            + f"); state_dict bit for bit the seeded one; rows max rel L2 {err:.3e}; K1 {k1} = batches {batches} "
            f"[{card}]")
        check(k1 == batches > 0, f"17a: K1 launches {k1} != batches {batches}")

        # 17b: greedy tokens against an in-process engine on the same weights and factors
        status, _ = wait_ready(servers[1], bases[1], logpath)
        ready_s = ready_since_each(1)
        check(status["kernel_active"] and status["device"].startswith("cuda"), f"17b: not on the kernel lane: {status}")
        rng = np.random.default_rng(SEED + 171)
        prompts = [rng.integers(0, LM_CONFIG["vocab_size"], n) for n in CKPT_PROMPTS]
        served = {a: [gen_request(np, bases[1], p, CKPT_MAX_NEW, tag=a) for p in prompts] for a in (None, "ckpt")}
        reg = WeightRegistry()
        reg.register("ckpt", lambda: factors)
        eng = PagedEngine(load_lm_params("", LM_CONFIG, CKPT_LM_SEED, torch.device("cuda")), dtype="bfloat16",
                          device="cuda", max_adapters=1, lora_rank=LORA_RANK, weight_registry=reg,
                          **LM_CONFIG, **LM_ENGINE, **NO_PREFIX_CACHE)
        local_rows = {a: [eng.generate(p, max_new_tokens=CKPT_MAX_NEW, adapter=a) for p in prompts]
                      for a in (None, "ckpt")}
        del eng
        torch.cuda.empty_cache()
        same = {str(a): [bool((x == y).all()) for x, y in zip(served[a], local_rows[a])] for a in served}
        differs = sum(not bool((x == y).all()) for x, y in zip(served[None], served["ckpt"]))
        numbers["17b"] = {"ready_s": ready_s, "load_time_s": status["load_time_s"], "equal": same,
                          "adapter_rows_that_differ_from_base": differs}
        log(f"17b StreamingLM from model_uri + a {{'uri': ...}} adapter: server ready {ready_s:.1f} s after launch{note} (load "
            f"{status['load_time_s']:.2f} s); greedy rows of {len(prompts)} prompts x {CKPT_MAX_NEW} sent one "
            f"after another equal the in-process engine's: base {same['None']}, adapter {same['ckpt']}; "
            f"{differs} of {len(prompts)} adapter rows differ from the base rows [{card}]")
        check(all(same["None"]) and all(same["ckpt"]), f"17b: served tokens differ from the in-process engine: {same}")

        # 17d: ViT-B/16 at 224 and 384 from one server
        status, _ = wait_ready(servers[2], bases[2], logpath)
        ready_s = ready_since_each(2)
        base = bases[2]
        check(status["signatures"] == [list(IMG), list(VIT_384)], f"17d: signatures {status['signatures']}")
        rng = np.random.default_rng(SEED + 172)
        first_ms = {}
        for shape in (IMG, VIT_384):  # the first request of each signature after load (ROADMAP S2)
            body = raw_request(np, distinct_images(np, rng, 1, shape))
            t0 = time.perf_counter()
            decode_logits(np, http(base + "/predict", body), 1)
            first_ms[f"{shape[0]}"] = (time.perf_counter() - t0) * 1e3
        m0 = metrics_values(http(base + "/metrics"))
        before = http(base + "/health/status")["jsonData"]["kernel_launches"]
        groups = {}
        for shape in (IMG, VIT_384):
            eight, singles = distinct_images(np, rng, 8, shape), distinct_images(np, rng, 8, shape)
            served_eight = decode_logits(np, http(base + "/predict", raw_request(np, eight)), 8)
            answers = concurrent(lambda i: http(base + "/predict", raw_request(np, singles[i:i + 1])), 8)
            groups[shape] = (np.concatenate([eight, singles]),
                             np.concatenate([served_eight] + [decode_logits(np, a, 1) for a in answers]))
        status = http(base + "/health/status")["jsonData"]
        after = status["kernel_launches"]
        m1 = metrics_values(http(base + "/metrics"))
        bad_status, bad_body = http_status(base + "/predict",
                                           json.dumps(raw_request(np, distinct_images(np, rng, 1, (256, 256, 3))))
                                           .encode(), headers={"Content-Type": "application/json"})
        batches = int(m1["cudaserver_batches_total"] - m0["cudaserver_batches_total"])
        k1 = after["fused_normalize"] - before.get("fused_normalize", 0)
        k3 = after["flash_attention"] - before.get("flash_attention", 0)
        local = vit_model(torch, kernels, vit, torch.bfloat16, True, SEED)
        scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
        errs, nearest_ok = {}, {}
        with torch.inference_mode():
            for shape, (images, served_rows) in groups.items():
                refs = np.concatenate([local(kernels.fused_normalize(torch.from_numpy(images[i:i + 8]).cuda(), scale,
                                                                     shift, torch.bfloat16)).double().cpu().numpy()
                                       for i in (0, 8)])
                n = len(refs)
                errs[shape[0]] = max(rel_l2(np, served_rows[i], refs[i]) for i in range(n))
                nearest = [int(np.argmin([rel_l2(np, served_rows[i], refs[j]) for j in range(n)])) for i in range(n)]
                nearest_ok[shape[0]] = nearest == list(range(n))
        del local
        torch.cuda.empty_cache()
        refusal = json.dumps(bad_body)
        log(f"17d ViT-B/16 at 224 + 384 from one server: ready {ready_s:.1f} s after launch{note} (load {status['load_time_s']:.1f} s, "
            f"warmup over 2 shapes x {len(status['buckets'])} buckets x 2 dtypes); first request after load: 224 "
            f"{first_ms['224']:.1f} ms, 384 {first_ms['384']:.1f} ms; groups {status['signature_groups']}; rows max "
            f"rel L2 224 {errs[224]:.3e}, 384 {errs[384]:.3e}, each nearest its own image {nearest_ok}; {batches} "
            f"batches (summed over the groups): K1 {k1}, K3 {k3}; 256x256 answered {bad_status} [{card}]")
        check(len(status["signature_groups"]) == 2, f"17d: signature groups {status['signature_groups']}")
        check(max(errs.values()) <= SERVED_VS_LOCAL_REL_L2, f"17d: served rows disagree with in-process: {errs}")
        check(all(nearest_ok.values()), f"17d: a served row is nearer another image's answer: {nearest_ok}")
        check(k1 == batches > 0 and k3 == VIT_LAYERS * batches,
              f"17d: K1 {k1} / K3 {k3} against {batches} batches (K3 must be {VIT_LAYERS} x batches)")
        check(bad_status == 400 and "BAD_INPUT_SHAPE" in refusal and "(batch, 224, 224, 3) | (batch, 384, 384, 3)"
              in refusal, f"17d: a 256x256 request answered {bad_status}: {refusal[:300]}")
        with no_tf32(torch):
            B, L, H, D = 32, (VIT_384[0] // 16) ** 2 + 1, 12, 64
            q, k, v = flash_inputs(torch, np, B, L, H, D, torch.bfloat16, False, seed=577)
            k3_abs, k3_rel = flash_check(torch, kernels, q, k, v, False, "bfloat16",
                                         f"flash_attention {(B, L, H, D)} bfloat16 causal=False (ViT-B/16 at 384)")
            del q, k, v
            k3_row = flash_timing(torch, np, kernels, B, L, H, D, False, mem_bytes_per_s)
        numbers["17d"] = {"ready_s": ready_s, "load_time_s": status["load_time_s"], "first_request_ms": first_ms,
                          "groups": status["signature_groups"], "max_row_rel_l2": errs, "batches": batches,
                          "k1": k1, "k3": k3, "refusal_status": bad_status,
                          "k3_577": {**k3_row, "max_abs_err": k3_abs, "max_rel_err": k3_rel, "launches": k3}}
    finally:
        for proc in servers:
            stop_server(proc)
        logfile.close()
        ctx["cleanup"]()
    numbers["seconds"] = time.perf_counter() - t_phase
    log(f"17 A5 + A6 phase wall time {numbers['seconds']:.1f} s [{card}]")
    return numbers


# ---------------------------------------------------------------- phase 18

def sched_sync(torch):
    if SCHED_DEVICE == "cuda":
        torch.cuda.synchronize()


class K4Tally:
    """Phases 18 and 19's K4 accounting: every counted run resets the
    launch counts just before it.  The caller says which lane it built
    the engine for: on the kernel lane (the default) the engine must be
    on it and launch the paged decode kernel once per layer per decode
    step per length bucket; off it (the ring chunk) never."""

    def __init__(self, torch, kernels):
        self.torch, self.kernels = torch, kernels
        # launches and decode calls on the kernel lane; decode calls off it
        self.launches = self.steps = self.off_lane_calls = 0
        self.last = (0, 0)

    def run(self, eng, fn, what: str, kernel: bool = True):
        check(eng._kernel_active == kernel, f"{what}: the engine runs chunk {eng._chunk_impl}, kernel lane "
              f"{eng._kernel_active}; the run expects kernel lane {kernel}")
        c0 = decode_calls(eng.engine_stats())
        sched_sync(self.torch)
        self.kernels.reset_launch_counts()
        out = fn()
        sched_sync(self.torch)
        n = sum(v for k, v in self.kernels.launch_counts().items() if k.startswith("paged_decode"))
        steps = decode_calls(eng.engine_stats()) - c0
        want = LM_CONFIG["num_layers"] * steps if kernel else 0
        check(steps > 0 and n == want,
              f"{what}: the paged decode kernel launched {n} times over {steps} decode calls a layer (steps x "
              f"buckets, {LM_CONFIG['num_layers']} layers, chunk {eng._chunk_impl}); expected {want}")
        self.launches += n
        self.steps += steps if kernel else 0
        self.off_lane_calls += 0 if kernel else steps
        self.last = (n, steps)
        return out


def sched_engine(torch, PagedEngine, params, dtype="bfloat16", **kw):
    return PagedEngine(params, dtype=dtype, device=SCHED_DEVICE, **LM_CONFIG, **{**LM_ENGINE, **kw})


def drive(eng, prompts, max_new, **kw):
    """Submit every prompt, run the engine dry; the (rows, max_new) tokens."""
    streams = [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    eng.run()
    for st in streams:
        check(st.error is None and st.result is not None and st.result.shape == (max_new,),
              f"a stream failed: {st.error}")
    return [st.result for st in streams]


def stat_delta(eng, before, keys=("prefix_hits", "prefix_tokens_saved", "prefill_tokens", "tokens")):
    after = eng.engine_stats()
    return {k: after[k] - before[k] for k in keys}


def launch_w8a8_lm():
    params = W8A8_LM_PARAMS + ([{"name": "device", "value": SCHED_DEVICE, "type": "STRING"}]
                               if SCHED_DEVICE != "cuda" else [])
    return server_context("chip_smoke_w8a8_lm_", component="seldon_core_tpu_torch.models.paged.StreamingLM",
                          params=params)


def precision_lanes(torch, np, w8a8, PagedEngine, params, tally, card):
    """18a: bf16, int8w and w8a8 engines; the served w8a8 StreamingLM."""
    rng = np.random.default_rng(SEED + 180)
    V = LM_CONFIG["vocab_size"]
    prompts = list(rng.integers(0, V, (LM_ENGINE["max_slots"], SCHED_PROMPT)))
    rest_prompts = [rng.integers(0, V, n) for n in SCHED_REST_PROMPTS]
    ctx = EARLY.take("w8a8_lm", launch_w8a8_lm)
    (proc,), base, logpath, logfile = ctx["procs"], ctx["base"], ctx["logpath"], ctx["logfile"]
    try:
        lanes = {"bf16": {}, "int8w": {"quantize": "int8"}, "w8a8": {"precision": "w8a8"}}
        engines = {name: sched_engine(torch, PagedEngine, params, prefix_cache=False, **kw)
                   for name, kw in lanes.items()}
        wbytes = {name: eng.weight_bytes() for name, eng in engines.items()}
        status, _ = wait_ready(proc, base, logpath)
        ready_s = ready_since(ctx)
        check(status["precision"] == "w8a8" and status["quantize"] == "int8" and status["prefix_cache"]
              and status["chunk_token_budget"] == SCHED_BUDGET and status["max_queue"] == 64,
              f"the w8a8 server does not report its options: {status}")
        steps0, before = decode_calls(status["engine"]), status["kernel_launches"]
        served = [gen_request(np, base, p) for p in rest_prompts]
        after_status = http(base + "/health/status")["jsonData"]
    finally:
        stop_server(proc)
        logfile.close()
    served_steps = decode_calls(after_status["engine"]) - steps0
    served_k4 = after_status["kernel_launches"].get("paged_decode_stream", 0) - before.get("paged_decode_stream", 0)
    check(served_k4 == LM_CONFIG["num_layers"] * served_steps,
          f"the served w8a8 path launched K4 {served_k4} times over {served_steps} steps")
    ref = sched_engine(torch, PagedEngine, params, precision="w8a8", max_queue=64, chunk_token_budget=SCHED_BUDGET)
    local = [ref.generate(p, max_new_tokens=LM_MAX_NEW) for p in rest_prompts]
    del ref
    same = [bool((a == b).all()) for a, b in zip(served, local)]
    log(f"18a served w8a8 StreamingLM (cache on, max_queue 64, budget {SCHED_BUDGET}): ready {ready_s:.1f} s after "
        f"launch{early_note(ctx)}, {sum(same)}/{len(same)} sequential rows bit-identical to an in-process w8a8 engine; K4 "
        f"{served_k4} = {LM_CONFIG['num_layers']} x {served_steps} steps")
    check(all(same), f"served w8a8 rows differ from the in-process engine: {same}")

    rates = {name: [] for name in lanes}
    for rep in range(SCHED_RATE_REPS):
        for name in (list(lanes) if rep % 2 == 0 else list(lanes)[::-1]):
            eng = engines[name]

            def timed(max_new, eng=eng):
                sched_sync(torch)
                t0 = time.perf_counter()
                drive(eng, prompts, max_new)
                sched_sync(torch)
                return time.perf_counter() - t0

            t_full = tally.run(eng, lambda: timed(LM_MAX_NEW), f"18a {name} decode")
            t_one = timed(1)
            rates[name].append(len(prompts) * (LM_MAX_NEW - 1) / max(t_full - t_one, 1e-9))

    eng = engines["w8a8"]
    for p in prompts:
        eng.submit(p, max_new_tokens=LM_MAX_NEW)
    eng.step()  # admission, prefill and the first chunk: the next step is one decode chunk alone
    report = tally.run(eng, lambda: w8a8.int8_lowering_report(eng.step), "18a w8a8 chunk under the profiler")
    eng.run()
    log(f"18a int8_lowering_report of one w8a8 decode chunk: verdict {report['verdict']}, int8 {report['int8_ops']}, "
        f"float {report['float_ops']}, widened {report['int_widened_ops']}, backend {report['backend']}")
    for line in report["evidence"]:
        log(f"  {line}")
    check(report["verdict"] == "int8" and report["int8_majority"], f"the w8a8 chunk is not int8: {report}")

    step_tokens = torch.from_numpy(rng.integers(0, V, len(prompts))).to(SCHED_DEVICE)
    logits = {}
    for name, e in engines.items():
        logits[name] = first_step_logits(torch, np, e, prompts, step_tokens)
        e.run()
    ref = logits["bf16"]
    rel = float((logits["int8w"] - ref).norm() / ref.norm())
    cos = float(torch.nn.functional.cosine_similarity(logits["int8w"], ref, dim=-1).min())
    top1 = float((logits["w8a8"].argmax(-1) == ref.argmax(-1)).double().mean())
    w_rel = float((logits["w8a8"] - ref).norm() / ref.norm())
    del engines
    numbers = {
        "weight_bytes": wbytes, "decode_tokens_per_s": {k: max(v) for k, v in rates.items()},
        "decode_tokens_per_s_runs": rates, "int8w_rel_l2": rel, "int8w_min_cos": cos, "w8a8_top1": top1,
        "w8a8_rel_l2": w_rel, "report": report, "served_rows_identical": sum(same), "served_ready_s": ready_s,
        "served_k4": served_k4, "served_steps": served_steps,
    }
    best = numbers["decode_tokens_per_s"]
    log(f"18a lanes, 16 lanes, prompt {SCHED_PROMPT}, {LM_MAX_NEW} new: weight bytes {wbytes}; decode tokens/s "
        f"bf16 {best['bf16']:.1f}, int8w {best['int8w']:.1f} ({best['int8w'] / best['bf16']:.3f}x), w8a8 "
        f"{best['w8a8']:.1f} ({best['w8a8'] / best['bf16']:.3f}x); first step vs bf16: int8w rel L2 {rel:.3e} "
        f"(limit {INT8W_VS_BF16_REL_L2}), min cosine {cos:.6f} (limit {INT8W_VS_BF16_MIN_COS}); w8a8 top-1 "
        f"{top1:.4f} (limit {W8A8_MIN_TOP1}), rel L2 {w_rel:.3e} [{card}]")
    check(rel <= INT8W_VS_BF16_REL_L2 and cos >= INT8W_VS_BF16_MIN_COS, "int8w first-step logits out of tolerance")
    check(top1 >= W8A8_MIN_TOP1, f"w8a8 argmax agreement with bf16 too low: {top1}")
    return numbers


def prefix_cache_lanes(torch, np, PagedEngine, params, params32, tally, card):
    """18b: a shared 256-token system prompt, cache on against off."""
    rng = np.random.default_rng(SEED + 181)
    V = LM_CONFIG["vocab_size"]
    system = rng.integers(0, V, SCHED_SYSTEM)
    prompts = [np.concatenate([system, rng.integers(0, V, int(n))])
               for n in rng.integers(SCHED_SUFFIX[0], SCHED_SUFFIX[1] + 1, LM_ENGINE["max_slots"])]
    engines = {True: sched_engine(torch, PagedEngine, params, prefix_cache=True),
               False: sched_engine(torch, PagedEngine, params, prefix_cache=False)}
    for eng in (engines[True], engines[True], engines[False]):
        drive(eng, prompts, LM_MAX_NEW)  # warm: the cache-on engine's second run takes the hit path once
    runs, tokens = [], {}
    for on in (True, False, False, True):
        eng = engines[on]
        before = eng.engine_stats()
        sched_sync(torch)
        t0 = time.perf_counter()
        tokens[on] = tally.run(eng, lambda eng=eng: drive(eng, prompts, LM_MAX_NEW), f"18b cache {on}")
        wall = time.perf_counter() - t0
        d = stat_delta(eng, before)
        runs.append({"cache": on, "wall_s": wall, "tokens_per_s": len(prompts) * LM_MAX_NEW / wall, **d})
        log(f"18b cache {'on ' if on else 'off'}: hits {d['prefix_hits']}, tokens saved {d['prefix_tokens_saved']}, "
            f"prefill tokens computed {d['prefill_tokens']}, wall {wall:.3f} s, {runs[-1]['tokens_per_s']:.1f} tokens/s")
    on_runs = [r for r in runs if r["cache"]]
    check(all(r["prefix_hits"] == len(prompts) and r["prefix_tokens_saved"] == len(prompts) * SCHED_SYSTEM
              for r in on_runs), f"the warm cache did not serve every system prompt: {on_runs}")
    bf16_same = float(np.mean([bool((a == b).all()) for a, b in zip(tokens[True], tokens[False])]))
    del engines
    e32 = {on: sched_engine(torch, PagedEngine, params32, dtype="float32", prefix_cache=on) for on in (True, False)}
    drive(e32[True], prompts, LM_MAX_NEW)  # warm the cache
    t32 = {on: tally.run(e, lambda e=e: drive(e, prompts, LM_MAX_NEW), f"18b f32 cache {on}") for on, e in e32.items()}
    hits32 = e32[True].engine_stats()["prefix_hits"]
    del e32
    f32_same = all(bool((a == b).all()) for a, b in zip(t32[True], t32[False]))
    ratio = (statistics.mean(r["tokens_per_s"] for r in on_runs)
             / statistics.mean(r["tokens_per_s"] for r in runs if not r["cache"]))
    log(f"18b f32 greedy tokens cache on == off: {f32_same} ({hits32} hits); bf16 rows equal on vs off "
        f"{bf16_same:.3f}; tokens/s on / off {ratio:.3f} [{card}]")
    check(f32_same and hits32 >= len(prompts), "f32 greedy tokens differ with the prefix cache on")
    return {"runs": runs, "tokens_per_s_ratio": ratio, "bf16_rows_equal": bf16_same, "f32_equal": f32_same}


def ladder_and_pressure(torch, np, PagedEngine, params32, tally, card):
    """18c: the steps ladder with nothing queued; a pool of 1 + 16 x 3 pages."""
    rng = np.random.default_rng(SEED + 182)
    prompts = [rng.integers(0, LM_CONFIG["vocab_size"], int(n))
               for n in rng.integers(SCHED_TIGHT_PROMPT[0], SCHED_TIGHT_PROMPT[1] + 1, LM_ENGINE["max_slots"])]
    out = {}
    for name, kw in (("full", {}), ("tight", {"num_pages": SCHED_TIGHT_PAGES})):
        eng = sched_engine(torch, PagedEngine, params32, dtype="float32", max_steps_per_call=SCHED_MAX_STEPS, **kw)
        sched_sync(torch)
        t0 = time.perf_counter()
        tokens = tally.run(eng, lambda eng=eng: drive(eng, prompts, LM_MAX_NEW), f"18c {name} pool")
        s = eng.engine_stats()
        out[name] = {"tokens": tokens, "chunk_steps": s["chunk_steps"], "stalls": s["stalls"],
                     "evictions": s["evictions"], "wall_s": time.perf_counter() - t0}
        del eng
        log(f"18c {name} pool ({kw.get('num_pages', 'default')} pages), max_steps_per_call {SCHED_MAX_STEPS}: chunk "
            f"lengths {dict(sorted(s['chunk_steps'].items()))}, stalls {s['stalls']}, evictions {s['evictions']}, "
            f"wall {out[name]['wall_s']:.3f} s")
    same = all(bool((a == b).all()) for a, b in zip(out["full"]["tokens"], out["tight"]["tokens"]))
    log(f"18c f32 tokens of the shrunk pool == the full pool's: {same} [{card}]")
    check(max(out["full"]["chunk_steps"]) > LM_ENGINE["steps_per_call"], "the ladder never doubled the chunk")
    check(out["tight"]["stalls"] > 0 and out["tight"]["evictions"] > 0, "the shrunk pool neither stalled nor evicted")
    check(same, "the shrunk pool changed f32 tokens")
    return {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in out.items()}


def slo_lanes(torch, np, PagedEngine, params, tally, card):
    """18d: a bounded queue, priorities 0 and 2, spent and short deadlines."""
    rng = np.random.default_rng(SEED + 183)
    prompts = rng.integers(0, LM_CONFIG["vocab_size"], (SCHED_SUBMITS, SCHED_PROMPT))
    slots = LM_ENGINE["max_slots"]
    with knob_env(SELDON_TPU_PAGED_DEBUG="1"):
        eng = sched_engine(torch, PagedEngine, params, max_queue=SCHED_QUEUE)
    check(eng._debug_invariants, "the allocator audit is off")
    outcomes = []  # (priority, stream or None, error reason or None)

    def fill_then_burst():
        for p in prompts[:slots]:
            outcomes.append((0, eng.submit(p, max_new_tokens=LM_MAX_NEW), None))
        eng.step()  # every slot taken by priority 0
        for i, p in enumerate(prompts[slots:]):
            priority = 2 if i % 2 else 0
            deadline = (time.monotonic() - 1.0 if i % 8 == 0
                        else time.monotonic() + SCHED_SHORT_DEADLINE_S if i % 8 == 1 else None)
            try:
                outcomes.append((priority, eng.submit(p, max_new_tokens=LM_MAX_NEW, priority=priority,
                                                      deadline=deadline), None))
            except Exception as e:  # noqa: BLE001 — each refusal is checked below
                outcomes.append((priority, None, getattr(e, "reason", repr(e))))
        time.sleep(2 * SCHED_SHORT_DEADLINE_S)
        eng.run()

    tally.run(eng, fill_then_burst, "18d SLO")
    with eng._lock:
        eng._check_invariants_locked()
    s = eng.engine_stats()
    ends = {"result": 0, "SHED": 0, "DEADLINE_EXCEEDED": 0}
    waits = {0: [], 2: []}
    for priority, st, reason in outcomes:
        if st is not None:
            reason = None if st.error is None else getattr(st.error, "reason", repr(st.error))
            status = None if st.error is None else getattr(st.error, "status_code", None)
            check(reason is None or (reason, status) in (("SHED", 503), ("DEADLINE_EXCEEDED", 504)),
                  f"a stream ended with an unexpected error: {st.error!r}")
            if reason is None:
                check(st.result is not None and st.result.shape == (LM_MAX_NEW,), "a stream ended with no result")
                waits[priority].append((st.t_prefill_start - st.t_submit) * 1e3)
        check(reason in (None, "SHED", "DEADLINE_EXCEEDED"), f"a submission ended with {reason}")
        ends["result" if reason is None else reason] += 1
    counters = {k: s[k] for k in ("shed", "expired", "preempted", "restored")}
    check(sum(ends.values()) == SCHED_SUBMITS and waits[0] and waits[2], f"submissions without an end: {ends}")
    p50 = {k: pct(v, 0.5) for k, v in waits.items()}
    del eng
    log(f"18d {SCHED_SUBMITS} submissions, max_queue {SCHED_QUEUE}, audit on: ends {ends}; counters {counters}; "
        f"queue wait p50 priority 2 {p50[2]:.2f} ms, priority 0 {p50[0]:.2f} ms [{card}]")
    check(all(v > 0 for v in counters.values()), f"an SLO counter stayed 0: {counters}")
    return {"ends": ends, "counters": counters, "wait_p50_ms": p50}


def chunked_prefill_lanes(torch, np, PagedEngine, params, params32, tally, card):
    """18e: chunk_token_budget=512, 4 prompts of 900 beside 12 decoding streams."""
    rng = np.random.default_rng(SEED + 184)
    V = LM_CONFIG["vocab_size"]
    shorts = list(rng.integers(0, V, (LM_ENGINE["max_slots"] - 4, SCHED_PROMPT)))
    longs = list(rng.integers(0, V, (4, SCHED_LONG)))

    def budgeted(eng):
        short = [eng.submit(p, max_new_tokens=SCHED_SHORT_NEW) for p in shorts]
        while any(st.prefilled < len(st.prompt) for st in short):
            eng.step()
        long = [eng.submit(p, max_new_tokens=SCHED_LONG_NEW) for p in longs]
        waves = []
        while eng.has_work():
            before = eng.engine_stats()
            prefilling = any(st.prefilled < len(st.prompt) for st in long)
            decoding = [st for st in short if st.result is None]
            eng.step()
            d = stat_delta(eng, before, ("prefill_tokens", "tokens"))
            waves.append((d["prefill_tokens"], d["tokens"], prefilling and bool(decoding)))
        for st in short + long:
            check(st.error is None and st.result is not None, f"a stream failed: {st.error}")
        return [st.result for st in short + long], waves

    eng = sched_engine(torch, PagedEngine, params, chunk_token_budget=SCHED_BUDGET)
    _, waves = tally.run(eng, lambda: budgeted(eng), "18e budget")
    del eng
    biggest = max(p + d for p, d, _ in waves)
    overlap = [(p, d) for p, d, both in waves if both]
    log(f"18e budget {SCHED_BUDGET}: {len(waves)} waves, the largest {biggest} tokens; {len(overlap)} waves while "
        f"the 900-token prompts prefilled, decode tokens in each {[d for _, d in overlap]}, prefill "
        f"{[p for p, _ in overlap]}")
    check(biggest <= SCHED_BUDGET, f"a wave carried {biggest} tokens, over the budget {SCHED_BUDGET}")
    check(overlap and all(d > 0 for _, d in overlap), "the decoding streams stalled while the long prompts prefilled")
    e32 = sched_engine(torch, PagedEngine, params32, dtype="float32", chunk_token_budget=SCHED_BUDGET)
    on, _ = tally.run(e32, lambda: budgeted(e32), "18e f32 budget")
    del e32
    off = sched_engine(torch, PagedEngine, params32, dtype="float32", chunk_token_budget=0)
    ref = tally.run(off, lambda: drive(off, shorts, SCHED_SHORT_NEW) + drive(off, longs, SCHED_LONG_NEW),
                    "18e f32 no budget")
    del off
    same = all(bool((a == b).all()) for a, b in zip(on, ref))
    log(f"18e f32 tokens with the budget == without: {same} [{card}]")
    check(same, "chunked prefill changed f32 tokens")
    return {"waves": len(waves), "largest_wave_tokens": biggest, "overlap_waves": len(overlap),
            "overlap_decode_tokens": [d for _, d in overlap]}


def scheduler_paths(torch, np, kernels, w8a8, PagedEngine, load_lm_params, card):
    """Phase 18: the JAX engine's scheduler and precision lanes on the
    generation config (18a-e); every counted run launches K4 once per
    layer per decode step per length bucket."""
    t0 = time.perf_counter()
    tally = K4Tally(torch, kernels)
    params = load_lm_params("", LM_CONFIG, 0, torch.device(SCHED_DEVICE))
    params32 = load_lm_params("", LM_CONFIG, SEED + 5, torch.device(SCHED_DEVICE))
    numbers = {"18a": precision_lanes(torch, np, w8a8, PagedEngine, params, tally, card)}
    numbers["18b"] = prefix_cache_lanes(torch, np, PagedEngine, params, params32, tally, card)
    numbers["18c"] = ladder_and_pressure(torch, np, PagedEngine, params32, tally, card)
    numbers["18d"] = slo_lanes(torch, np, PagedEngine, params, tally, card)
    numbers["18e"] = chunked_prefill_lanes(torch, np, PagedEngine, params, params32, tally, card)
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    numbers.update(k4_launches=tally.launches, decode_calls=tally.steps, seconds=time.perf_counter() - t0)
    log(f"phase 18: K4 launched {tally.launches} = {LM_CONFIG['num_layers']} x {tally.steps} decode calls (steps x "
        f"buckets) over every counted run, {numbers['seconds']:.1f} s [{card}]")
    return numbers


# ---------------------------------------------------------------- phase 19

def impl_engine(torch, PagedEngine, params, impl: str, dtype: str = "bfloat16", buckets=None, **kw):
    """A phase 19 engine on the chunk asked for (``SELDON_TPU_CTX_BUCKETS``
    too when given), the prefix cache off unless asked for."""
    with knob_env(SELDON_TPU_CHUNK_IMPL=impl, SELDON_TPU_CTX_BUCKETS=buckets):
        eng = sched_engine(torch, PagedEngine, params, dtype=dtype, **{"prefix_cache": False, **kw})
    check(eng._chunk_impl == impl and eng._kernel_active == (impl == "pool"),
          f"the {impl} engine runs chunk {eng._chunk_impl}, kernel lane {eng._kernel_active}")
    return eng


def drive_mixed(eng, prompts, adapters, max_new):
    """``drive`` with prompt i on adapter ``adapters[i]``."""
    streams = [eng.submit(p, max_new_tokens=max_new, adapter=a) for p, a in zip(prompts, adapters)]
    eng.run()
    for st in streams:
        check(st.error is None and st.result is not None, f"a stream failed: {st.error}")
    return [st.result for st in streams]


def decode_rate(torch, eng, prompts, tally, what: str, kernel: bool = True) -> float:
    """Decode tokens/s of one turn: a run of LM_MAX_NEW new tokens minus a
    run of one (prefill and the first chunk), 18a's method."""
    def timed(max_new):
        sched_sync(torch)
        t0 = time.perf_counter()
        drive(eng, prompts, max_new)
        sched_sync(torch)
        return time.perf_counter() - t0

    t_full = tally.run(eng, lambda: timed(LM_MAX_NEW), what, kernel)
    t_one = timed(1)
    return len(prompts) * (LM_MAX_NEW - 1) / max(t_full - t_one, 1e-9)


def same_rows(a, b) -> bool:
    return all(bool((x == y).all()) for x, y in zip(a, b))


def ring_lanes(torch, np, PagedEngine, params, params32, registry, tally, card):
    """19a: the ring chunk against the pool chunk on K4."""
    rng = np.random.default_rng(SEED + 190)
    V, slots = LM_CONFIG["vocab_size"], LM_ENGINE["max_slots"]
    prompts = list(rng.integers(0, V, (slots, RING_PROMPT)))
    system = rng.integers(0, V, RING_SYSTEM)
    shared = [np.concatenate([system, rng.integers(0, V, int(n))]) for n in rng.integers(16, 65, slots)]
    names = [(None, "a1", "a2")[i % 3] for i in range(slots)]
    with knob_env(SELDON_TPU_PAGED_KERNEL="0", SELDON_TPU_CHUNK_IMPL=None):
        eng = sched_engine(torch, PagedEngine, params, prefix_cache=False)
    auto = eng._chunk_impl
    del eng
    check(auto == "ring", f"SELDON_TPU_PAGED_KERNEL=0 with the chunk unset picked {auto}, not the ring")

    f32, hits = {}, {}
    for case, kw in (("plain", {}), ("adapters", {"max_adapters": 2, "lora_rank": LORA_RANK}),
                     ("prefix hit", {"prefix_cache": True})):
        out = {}
        for impl in ("ring", "pool"):
            extra = dict(kw, weight_registry=registry()) if "max_adapters" in kw else kw
            eng = impl_engine(torch, PagedEngine, params32, impl, "float32", **extra)
            what = f"19a f32 {case} {impl}"
            if case == "adapters":
                out[impl] = tally.run(eng, lambda eng=eng: drive_mixed(eng, prompts, names, LM_MAX_NEW), what,
                                      impl == "pool")
            elif case == "prefix hit":
                drive(eng, shared[:1], LM_MAX_NEW)  # publishes the system prompt's two pages
                out[impl] = tally.run(eng, lambda eng=eng: drive(eng, shared, LM_MAX_NEW), what, impl == "pool")
                hits[impl] = eng.engine_stats()["prefix_hits"]
            else:
                out[impl] = tally.run(eng, lambda eng=eng: drive(eng, prompts, LM_MAX_NEW), what, impl == "pool")
            del eng
        f32[case] = same_rows(out["ring"], out["pool"])
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()

    engines = {impl: impl_engine(torch, PagedEngine, params, impl) for impl in ("ring", "pool")}
    # the bf16 tokens first: the run also warms each engine before its turns
    bf = {impl: drive(e, prompts, LM_MAX_NEW) for impl, e in engines.items()}
    rates = {impl: [] for impl in engines}
    for rep in range(RING_RATE_REPS):
        for impl in (("ring", "pool") if rep % 2 == 0 else ("pool", "ring")):
            rates[impl].append(decode_rate(torch, engines[impl], prompts, tally, f"19a bf16 {impl} decode",
                                           impl == "pool"))
    del engines
    agreement = float(np.mean([np.mean(a == b) for a, b in zip(bf["ring"], bf["pool"])]))
    rows = sum(bool((a == b).all()) for a, b in zip(bf["ring"], bf["pool"]))
    best = {k: max(v) for k, v in rates.items()}
    log(f"19a chunk with SELDON_TPU_PAGED_KERNEL=0 and the chunk unset: {auto}; f32 greedy ring == pool (16 x "
        f"{LM_MAX_NEW}): {f32}; prefix hits ring / pool {hits.get('ring')} / {hits.get('pool')}; K4 over the ring "
        f"runs 0 ({tally.off_lane_calls} decode calls off the kernel lane); bf16 ring vs pool: {rows}/{slots} rows "
        f"equal, token agreement {agreement:.4f}; bf16 decode tokens/s (16 lanes, prompt {RING_PROMPT}, "
        f"{LM_MAX_NEW} new) ring {best['ring']:.1f}, pool {best['pool']:.1f} ({best['ring'] / best['pool']:.3f}x), "
        f"turns {rates} [{card}]")
    check(all(f32.values()), f"f32 ring and pool tokens differ: {f32}")
    check(hits["ring"] > 0 and hits["ring"] == hits["pool"], f"the prefix-hit runs did not hit alike: {hits}")
    return {"auto_chunk_k0": auto, "f32_ring_equals_pool": f32, "prefix_hits": hits, "bf16_rows_equal": rows,
            "bf16_token_agreement": agreement, "decode_tokens_per_s": best, "decode_tokens_per_s_runs": rates}


def split_lanes(torch, np, PagedEngine, params, params32, tally, card):
    """19b: 8 prompts of 64 beside 8 of 768, one bucket against two, on
    both chunks."""
    rng = np.random.default_rng(SEED + 191)
    V, slots = LM_CONFIG["vocab_size"], LM_ENGINE["max_slots"]
    prompts = [rng.integers(0, V, SPLIT_SHORT if i % 2 == 0 else SPLIT_LONG) for i in range(slots)]
    out = {}
    for impl in ("pool", "ring"):
        tokens, stats, k4 = {}, {}, {}
        for b in ("2", "1"):
            eng = impl_engine(torch, PagedEngine, params32, impl, "float32", buckets=b)
            tokens[b] = tally.run(eng, lambda eng=eng: drive(eng, prompts, LM_MAX_NEW), f"19b f32 {impl} buckets {b}",
                                  impl == "pool")
            stats[b], k4[b] = eng.engine_stats(), tally.last
            del eng
        check(stats["2"]["bucketed_chunks"] > 0 and stats["1"]["bucketed_chunks"] == 0,
              f"19b {impl}: bucketed chunks {stats['2']['bucketed_chunks']} / {stats['1']['bucketed_chunks']}")
        same = same_rows(tokens["2"], tokens["1"])
        engines = {b: impl_engine(torch, PagedEngine, params, impl, buckets=b) for b in ("2", "1")}
        for eng in engines.values():
            drive(eng, prompts, LM_MAX_NEW)  # warm, untimed
        rates = {b: [] for b in engines}
        for rep in range(RING_RATE_REPS):
            for b in (("2", "1") if rep % 2 == 0 else ("1", "2")):
                rates[b].append(decode_rate(torch, engines[b], prompts, tally, f"19b bf16 {impl} buckets {b}",
                                            impl == "pool"))
        del engines
        best = {k: max(v) for k, v in rates.items()}
        out[impl] = {"f32_equal": same, "bucketed_chunks": {b: s["bucketed_chunks"] for b, s in stats.items()},
                     "chunks": {b: s["chunks"] for b, s in stats.items()},
                     "k4_launches_and_calls": k4, "decode_tokens_per_s": best, "decode_tokens_per_s_runs": rates}
        log(f"19b {impl} chunk, {slots // 2} x {SPLIT_SHORT} beside {slots // 2} x {SPLIT_LONG} tokens, {LM_MAX_NEW} "
            f"new: f32 tokens buckets 2 == 1: {same}; bucketed chunks {out[impl]['bucketed_chunks']} of "
            f"{out[impl]['chunks']}; K4 (launches, calls a layer) {k4}; bf16 decode tokens/s buckets 2 "
            f"{best['2']:.1f}, 1 {best['1']:.1f} ({best['2'] / best['1']:.3f}x), turns {rates} [{card}]")
        check(same, f"19b {impl}: f32 tokens differ between one and two buckets")
        if impl == "pool":
            # the knob unset: a CUDA engine's default is one bucket (C19)
            eng = impl_engine(torch, PagedEngine, params32, impl, "float32", buckets=None)
            unset = tally.run(eng, lambda eng=eng: drive(eng, prompts, LM_MAX_NEW), "19b f32 pool, buckets unset")
            st = eng.engine_stats()
            del eng
            out["unset"] = {"ctx_buckets": st["ctx_buckets"], "bucketed_chunks": st["bucketed_chunks"],
                            "chunks": st["chunks"], "f32_equal_to_1": same_rows(unset, tokens["1"])}
            log(f"19b pool chunk with SELDON_TPU_CTX_BUCKETS unset: ctx_buckets {st['ctx_buckets']}, bucketed chunks "
                f"{st['bucketed_chunks']} of {st['chunks']}, f32 tokens == buckets 1: "
                f"{out['unset']['f32_equal_to_1']} [{card}]")
            check(st["ctx_buckets"] == 1 and st["bucketed_chunks"] == 0 and out["unset"]["f32_equal_to_1"],
                  f"19b: the engine with the knob unset ran {out['unset']} (one bucket expected on a CUDA device)")
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def sse_stream(base: str, prompt, max_new=None, headers=None, drop_after_first: bool = False):
    """One REST SSE request: (token chunks, s to the first chunk, s to the
    end, the end event's payload)."""
    body = {"data": {"ndarray": [[int(t) for t in prompt]]}}
    if max_new:
        body["meta"] = {"tags": {"max_new_tokens": max_new}}
    req = urllib.request.Request(base + "/api/v0.1/generate/stream", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    chunks, t_first, end, event = [], None, None, None
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        check(resp.status == 200 and resp.headers.get("Content-Type", "").startswith("text/event-stream"),
              f"the SSE answer is {resp.status} {resp.headers.get('Content-Type')}")
        for raw in resp:
            line = raw.decode().rstrip("\r\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
                check(event != "error", f"an SSE error event: {data}")
                if event == "end":
                    end = data
                    break
                chunks.append(data["tokens"])
                t_first = t_first if t_first is not None else time.perf_counter() - t0
                if drop_after_first:
                    break
            elif not line:
                event = None
    return chunks, t_first, time.perf_counter() - t0, end


def proto_prompt(np, InternalMessage, prompt, max_new=None):
    msg = InternalMessage(payload=np.asarray([prompt], np.int32), kind="ndarray")
    if max_new:
        msg.meta.tags["max_new_tokens"] = max_new
    return msg.to_proto()


def proto_tokens(np, InternalMessage, msg) -> list:
    return np.asarray(InternalMessage.from_proto(msg).host_payload()).reshape(-1).astype(int).tolist()


def grpc_stream(np, pb, InternalMessage, channel, prompt, max_new=None, drop_after_first: bool = False):
    """One ``Seldon/GenerateStream`` call: (token chunks, s to the first
    chunk, s to the end, None)."""
    call = channel.unary_stream("/seldon.protos.Seldon/GenerateStream",
                                request_serializer=pb.SeldonMessage.SerializeToString,
                                response_deserializer=pb.SeldonMessage.FromString)
    chunks, t_first = [], None
    t0 = time.perf_counter()
    it = call(proto_prompt(np, InternalMessage, prompt, max_new), timeout=300)
    for msg in it:
        chunks.append(proto_tokens(np, InternalMessage, msg))
        t_first = t_first if t_first is not None else time.perf_counter() - t0
        if drop_after_first:
            it.cancel()
            break
    return chunks, t_first, time.perf_counter() - t0, None


def served_streams(torch, np, kernels, StreamingLM, card):
    """19c: a served StreamingLM behind the gateway's REST SSE, its sync
    gRPC and the native ingress's GenerateStream."""
    import grpc

    from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
    from seldon_core_tpu_torch.engine.native_ingress import serve_native_ingress
    from seldon_core_tpu_torch.engine.server import Gateway, serve_gateway
    from seldon_core_tpu_torch.proto import pb
    from seldon_core_tpu_torch.runtime.message import InternalMessage

    rng = np.random.default_rng(SEED + 192)
    V = LM_CONFIG["vocab_size"]
    prompts = [rng.integers(0, V, n) for n in STREAM_PROMPTS]
    lm = StreamingLM(device=SCHED_DEVICE, dtype="bfloat16", max_new_tokens=LM_MAX_NEW, max_queue=STREAM_QUEUE,
                     **LM_CONFIG, **LM_ENGINE, **NO_PREFIX_CACHE)
    lm.load()
    check(lm.engine._chunk_impl == "pool" and lm.engine._kernel_active,
          "the served StreamingLM is not on the pool chunk's kernel lane")
    loop = LoopThread()
    http_port, grpc_port = free_port(), free_port()

    async def start():
        gateway = Gateway([(PredictorService(UnitSpec(name="lm", type="MODEL", component=lm), name="gen"), 1.0)])
        runner, handle = await serve_gateway(gateway, host="127.0.0.1", http_port=http_port, grpc_port=grpc_port)
        native = await serve_native_ingress(gateway, host="127.0.0.1", http_port=0)
        return gateway, runner, handle, native

    gateway, runner, handle, native = loop.run(start())
    base = f"http://127.0.0.1:{http_port}"
    channels = {"grpc": grpc.insecure_channel(f"127.0.0.1:{grpc_port}"),
                "native": grpc.insecure_channel(f"127.0.0.1:{native.port}")}
    total = lm.engine.engine_stats()["pool_pages_total"]

    def unary(lane, prompt):
        t0 = time.perf_counter()
        if lane == "sse":
            row = http(base + "/api/v0.1/predictions", {"data": {"ndarray": [[int(t) for t in prompt]]}})
            row = [int(t) for t in row["data"]["ndarray"][0]]
        else:
            predict = channels[lane].unary_unary("/seldon.protos.Seldon/Predict",
                                                 request_serializer=pb.SeldonMessage.SerializeToString,
                                                 response_deserializer=pb.SeldonMessage.FromString)
            row = proto_tokens(np, InternalMessage, predict(proto_prompt(np, InternalMessage, prompt), timeout=300))
        return row, time.perf_counter() - t0

    def stream(lane, prompt, **kw):
        if lane == "sse":
            return sse_stream(base, prompt, **kw)
        return grpc_stream(np, pb, InternalMessage, channels[lane], prompt, **kw)

    def idle_after(t0):
        """Seconds until the engine holds no slot, no queued stream and
        every page is free again."""
        while time.perf_counter() - t0 < 10 * STREAM_FREE_S:
            s = lm.engine.engine_stats()
            if s["active"] == 0 and s["queued"] == 0 and s["free_pages"] == total:
                return time.perf_counter() - t0
            time.sleep(0.01)
        return float("inf")

    out = {}
    try:
        calls0 = decode_calls(lm.engine.engine_stats())
        sched_sync(torch)
        kernels.reset_launch_counts()
        for lane in ("sse", "grpc", "native"):
            rows, t_unary, t_first, t_last, chunk_counts = [], [], [], [], []
            for p in prompts:
                row, dt = unary(lane, p)
                chunks, first, last, end = stream(lane, p)
                joined = [t for c in chunks for t in c]
                check(joined == row, f"19c {lane}: the streamed tokens differ from the unary row of the same request")
                check(lane != "sse" or end is not None, "19c sse: no end event")
                rows.append(row)
                t_unary.append(dt)
                t_first.append(first)
                t_last.append(last)
                chunk_counts.append(len(chunks))
            conc = concurrent(lambda i: stream(lane, prompts[i]), STREAM_CONCURRENT)
            conc_rows = [[t for c in chunks for t in c] for chunks, *_ in conc]
            check(all(len(r) == LM_MAX_NEW and all(0 <= t < V for t in r) for r in conc_rows),
                  f"19c {lane}: a concurrent stream came back short or out of the vocabulary")
            share = float(np.mean([a == b for a, b in zip(conc_rows, rows)]))
            t0 = time.perf_counter()
            dropped, *_ = stream(lane, prompts[0], max_new=STREAM_DROP_NEW, drop_after_first=True)
            freed = idle_after(t0)
            out[lane] = {"unary_p50_ms": pct(t_unary, 0.5) * 1e3, "first_chunk_p50_ms": pct(t_first, 0.5) * 1e3,
                         "last_chunk_p50_ms": pct(t_last, 0.5) * 1e3, "chunks": chunk_counts,
                         "concurrent_identical_share": share, "dropped_freed_s": freed}
            log(f"19c {lane}: {len(prompts)} streams bit-identical to their unary rows ({chunk_counts} chunks); p50 "
                f"first chunk {out[lane]['first_chunk_p50_ms']:.2f} ms, last {out[lane]['last_chunk_p50_ms']:.2f} ms, "
                f"unary {out[lane]['unary_p50_ms']:.2f} ms; {STREAM_CONCURRENT} concurrent: identical share "
                f"{share:.3f}; a client dropped after its first chunk ({len(dropped)} chunk): slot and pages free "
                f"after {freed:.3f} s [{card}]")
            check(len(dropped) == 1 and freed <= STREAM_FREE_S,
                  f"19c {lane}: a dropped stream still held its slot or pages after {freed:.3f} s")
            check(share >= GEN_MIN_IDENTICAL_SHARE, f"19c {lane}: too few concurrent streams equal their rows")
        sched_sync(torch)
        k4 = sum(v for k, v in kernels.launch_counts().items() if k.startswith("paged_decode"))
        calls = decode_calls(lm.engine.engine_stats()) - calls0
        want = LM_CONFIG["num_layers"] * calls
        check(calls > 0 and k4 == want, f"19c: K4 launched {k4} times over {calls} decode calls a layer")
        # refusals before any 200: a spent deadline, then a shed (the decode
        # loop held at its step lock while the queue is full)
        status, body = http_status(base + "/api/v0.1/generate/stream", json.dumps(
            {"data": {"ndarray": [[1, 2, 3]]}}).encode(), {"Content-Type": "application/json",
                                                             "X-Seldon-Deadline-Ms": "0"})
        check(status == 504 and body["status"]["reason"] == "DEADLINE_EXCEEDED", f"19c spent deadline: {status} {body}")
        with lm.engine._step_lock:
            held = [lm.engine.submit(prompts[0], max_new_tokens=4) for _ in range(STREAM_QUEUE)]
            shed, shed_body = http_status(base + "/api/v0.1/generate/stream", json.dumps(
                {"data": {"ndarray": [[1, 2, 3]]}}).encode(), {"Content-Type": "application/json"})
            for st in held:
                lm.engine.cancel(st)
        check(shed == 503 and shed_body["status"]["reason"] == "SHED", f"19c shed: {shed} {shed_body}")
        out.update(k4_launches=k4, decode_calls=calls)
        log(f"19c K4 launched {k4} = {LM_CONFIG['num_layers']} x {calls} decode calls over every lane's streams; SSE "
            f"answers a spent deadline {status} and a shed {shed} before any stream [{card}]")
    finally:
        for ch in channels.values():
            ch.close()

        async def stop():
            await native.stop()
            await handle.stop(None)
            await runner.cleanup()

        loop.run(stop())
        loop.close()
        lm.unload()
    return out


def stream_eviction(torch, np, PagedEngine, params32, tally, card):
    """19d: 16 streamed requests on a pool of 1 + 16 x 3 pages."""
    rng = np.random.default_rng(SEED + 193)
    prompts = [rng.integers(0, LM_CONFIG["vocab_size"], int(n))
               for n in rng.integers(SCHED_TIGHT_PROMPT[0], SCHED_TIGHT_PROMPT[1] + 1, LM_ENGINE["max_slots"])]
    out = {}
    for name, kw in (("full", {}), ("tight", {"num_pages": SCHED_TIGHT_PAGES})):
        eng = sched_engine(torch, PagedEngine, params32, dtype="float32", prefix_cache=False, **kw)

        def run(eng=eng):
            streams = [eng.submit(p, max_new_tokens=LM_MAX_NEW, stream_tokens=True) for p in prompts]
            eng.run()
            return streams

        streams = tally.run(eng, run, f"19d f32 {name} pool, streamed")
        chunks = []
        for st in streams:
            check(st.error is None and st.result is not None, f"19d: a stream failed: {st.error}")
            got = []
            while (part := st.token_queue.get(timeout=10)) is not None:
                got.append(part)
            chunks.append(got)
        out[name] = (chunks, [st.result for st in streams], eng.engine_stats())
        del eng
    (chunks, results, stats), (_, full, _) = out["tight"], out["full"]
    joined = [[t for part in c for t in part] for c in chunks]
    same = all(j == r.tolist() == f.tolist() for j, r, f in zip(joined, results, full))
    log(f"19d f32, 16 streams on {SCHED_TIGHT_PAGES} pages: stalls {stats['stalls']}, evictions {stats['evictions']}; "
        f"every streamed concatenation == its result == the full pool's, each token once: {same} [{card}]")
    check(stats["evictions"] > 0, "19d: the shrunk pool evicted no stream")
    check(same and all(len(j) == LM_MAX_NEW for j in joined), "19d: an evicted stream repeated or lost a token")
    return {"stalls": stats["stalls"], "evictions": stats["evictions"], "streams_equal": same}


def streaming_paths(torch, np, kernels, PagedEngine, StreamingLM, load_lm_params, WeightRegistry, make_lora_params,
                    card):
    """Phase 19: the ring chunk (19a), the length-bucketed split (19b),
    token streaming on every lane (19c) and under eviction (19d)."""
    t0 = time.perf_counter()
    tally = K4Tally(torch, kernels)
    params = load_lm_params("", LM_CONFIG, 0, torch.device(SCHED_DEVICE))
    params32 = load_lm_params("", LM_CONFIG, SEED + 5, torch.device(SCHED_DEVICE))
    numbers = {"19a": ring_lanes(torch, np, PagedEngine, params, params32,
                                 lambda: adapter_registry(WeightRegistry, make_lora_params), tally, card)}
    numbers["19b"] = split_lanes(torch, np, PagedEngine, params, params32, tally, card)
    numbers["19d"] = stream_eviction(torch, np, PagedEngine, params32, tally, card)
    del params, params32
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    numbers["19c"] = served_streams(torch, np, kernels, StreamingLM, card)
    numbers.update(k4_launches=tally.launches + numbers["19c"]["k4_launches"],
                   decode_calls=tally.steps + numbers["19c"]["decode_calls"], seconds=time.perf_counter() - t0)
    log(f"phase 19: K4 launched {numbers['k4_launches']} = {LM_CONFIG['num_layers']} x {numbers['decode_calls']} "
        f"decode calls on the pool chunk, 0 over {tally.off_lane_calls} on the ring, {numbers['seconds']:.1f} s "
        f"[{card}]")
    return numbers


# ---------------------------------------------------------------- phase 20

def echo_prompts(np, eng, n: int):
    """The JAX bench's echo workload (``bench.py:2412-2430``): ramps of
    eight tokens repeated, 32 + 8 i tokens long, each followed by the
    engine's own greedy continuation and cut to the last SPEC_ECHO tokens,
    so the context holds what the model goes on to say."""
    base = np.tile(np.arange(8, dtype=np.int32) + 3, 32)
    seeds = [base[: 32 + 8 * i] % LM_CONFIG["vocab_size"] for i in range(n)]
    prior = drive(eng, seeds, SPEC_NEW)
    return [np.concatenate([p, g[g >= 0]])[-SPEC_ECHO:].astype(np.int32) for p, g in zip(seeds, prior)]


def counted_run(torch, kernels, eng, prompts, max_new: int, hints=None):
    """One run of every prompt with the launch counts set to 0 just
    before it: (tokens, seconds, K4 launches, decode calls a layer,
    verify rounds, drafts, accepted drafts)."""
    st0 = eng.engine_stats()
    sched_sync(torch)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    streams = [eng.submit(p, max_new_tokens=max_new, draft_hint=None if hints is None else hints[i])
               for i, p in enumerate(prompts)]
    eng.run()
    sched_sync(torch)
    dt = time.perf_counter() - t0
    k4 = sum(v for k, v in kernels.launch_counts().items() if k.startswith("paged_decode"))
    st1 = eng.engine_stats()
    for st in streams:
        check(st.error is None and st.result is not None and st.result.shape == (max_new,),
              f"a stream failed: {st.error}")
    rounds = st1["chunks"] - st0["chunks"] if eng.speculative is not None else 0
    return ([st.result for st in streams], dt, k4, decode_calls(st1) - decode_calls(st0), rounds,
            st1["spec_drafted"] - st0["spec_drafted"], st1["spec_accepted"] - st0["spec_accepted"])


def check_k4(eng, k4: int, calls: int, rounds: int, what: str) -> None:
    """A plain lane launches K4 once a layer a decode call; a speculative
    one launches none over its verify rounds."""
    if eng.speculative is None:
        check(calls > 0 and k4 == LM_CONFIG["num_layers"] * calls,
              f"{what}: K4 launched {k4} times over {calls} decode calls a layer; expected "
              f"{LM_CONFIG['num_layers'] * calls}")
    else:
        check(rounds > 0 and k4 == 0 and calls == 0,
              f"{what}: {k4} K4 launches and {calls} decode calls over {rounds} verify rounds; expected none")


def spec_engines_f32(torch, np, kernels, PagedEngine, params32, card):
    """20a: the JAX bench's comparison in float32 with TF32 off: plain (8
    steps a chunk), token-wise (1), oracle drafts (the plain tokens as
    hints) and ngram drafts, 4 echo prompts, 64 new; a warm run, then the
    timed one."""
    def make(**kw):
        return PagedEngine(params32, dtype="float32", device=SCHED_DEVICE, **LM_CONFIG,
                           **{**LM_ENGINE, "max_slots": SPEC_SLOTS, "prefix_cache": False, **kw})

    out, tokens = {}, {}
    with no_tf32(torch):
        plain = make()
        prompts = echo_prompts(np, plain, SPEC_SLOTS)  # warms the plain lane too
        lanes = {"plain": plain, "tokenwise": make(steps_per_call=1),
                 "oracle": make(speculative={"draft": "oracle", "draft_k": SPEC_DRAFT_K}),
                 "ngram": make(speculative={"draft": "ngram", "draft_k": SPEC_DRAFT_K})}
        for name, eng in lanes.items():
            hints = tokens["plain"] if name == "oracle" else None
            if name != "plain":
                counted_run(torch, kernels, eng, prompts, SPEC_NEW, hints)  # first calls pay here
            toks, dt, k4, calls, rounds, drafted, accepted = counted_run(torch, kernels, eng, prompts, SPEC_NEW,
                                                                         hints)
            check_k4(eng, k4, calls, rounds, f"20a f32 {name}")
            tokens[name] = toks
            out[name] = {"tokens_per_s": SPEC_SLOTS * SPEC_NEW / dt, "seconds": dt, "k4_launches": k4,
                         "decode_calls": calls, "verify_rounds": rounds, "drafted": drafted, "accepted": accepted,
                         "acceptance": accepted / max(1, drafted), "chunks": eng.engine_stats()["chunks"]}
        del lanes, plain
    equal = {name: same_rows(tokens[name], tokens["plain"]) for name in tokens}
    log(f"20a f32 (TF32 off), {SPEC_SLOTS} echo prompts of <= {SPEC_ECHO}, {SPEC_NEW} new, draft_k {SPEC_DRAFT_K}: "
        f"tokens == plain {equal}; tokens/s " + ", ".join(f"{k} {v['tokens_per_s']:.1f}" for k, v in out.items())
        + f"; acceptance oracle {out['oracle']['acceptance']:.3f}, ngram {out['ngram']['acceptance']:.3f}; verify "
        f"rounds oracle {out['oracle']['verify_rounds']}, ngram {out['ngram']['verify_rounds']}; K4 plain "
        f"{out['plain']['k4_launches']} = {LM_CONFIG['num_layers']} x {out['plain']['decode_calls']}, token-wise "
        f"{out['tokenwise']['k4_launches']} = {LM_CONFIG['num_layers']} x {out['tokenwise']['decode_calls']}, 0 over "
        f"the verify rounds [{card}]")
    check(all(equal.values()), f"20a: f32 greedy tokens differ between the lanes: {equal}")
    check(out["oracle"]["accepted"] == out["oracle"]["drafted"] > 0,
          f"20a: the oracle accepted {out['oracle']['accepted']} of {out['oracle']['drafted']} drafts")
    return {"lanes": out, "tokens_equal": equal}


def spec_generator_path(torch, np, kernels, PagedEngine, SpeculativeGenerator, load_lm_params, params32, card):
    """20b: ``SpeculativeGenerator`` with a seeded 2-layer d512 draft model,
    one echo prompt of 128 tokens, 64 new, float32 with TF32 off: the
    plain engine's greedy tokens, and K4 once a draft layer a one-token
    forward."""
    draft_cfg = dict(LM_CONFIG, num_layers=SPEC_DRAFT_LAYERS)
    draft = load_lm_params("", draft_cfg, SEED + 20, torch.device(SCHED_DEVICE))
    with no_tf32(torch):
        plain = PagedEngine(params32, dtype="float32", device=SCHED_DEVICE, **LM_CONFIG,
                            **{**LM_ENGINE, "max_slots": 1, "prefix_cache": False})
        seed = (np.arange(SPEC_GEN_PROMPT - SPEC_NEW, dtype=np.int32) % 8 + 3) % LM_CONFIG["vocab_size"]
        prompt = np.concatenate([seed, plain.generate(seed, max_new_tokens=SPEC_NEW)]).astype(np.int32)
        check(len(prompt) == SPEC_GEN_PROMPT, f"20b: the echo prompt has {len(prompt)} tokens")
        want = plain.generate(prompt, max_new_tokens=SPEC_NEW)
        del plain
        gen = SpeculativeGenerator(params32, dtype="float32", device=SCHED_DEVICE, page_size=LM_ENGINE["page_size"],
                                   draft="model", draft_k=SPEC_DRAFT_K, draft_params=draft, draft_config=draft_cfg,
                                   **LM_CONFIG)
        check(gen._use_kernel, "20b: the generator's one-token forwards are not on the kernel lane")
        gen.generate(prompt, SPEC_NEW)  # first calls pay here
        f0, s0 = gen.single_token_forwards, dict(gen.stats)
        sched_sync(torch)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = gen.generate(prompt, SPEC_NEW)
        sched_sync(torch)
        dt = time.perf_counter() - t0
        k4 = kernels.launch_counts().get("paged_decode_stream", 0)
        others = sum(v for k, v in kernels.launch_counts().items() if k != "paged_decode_stream")
    forwards = gen.single_token_forwards - f0
    stats = {k: gen.stats[k] - s0[k] for k in s0}
    equal = bool((got == want).all())
    out = {"tokens_equal": equal, "k4_launches": k4, "single_token_forwards": forwards,
           "draft_layers": SPEC_DRAFT_LAYERS, "stats": stats, "seconds": dt, "tokens_per_s": SPEC_NEW / dt,
           "acceptance": stats["accepted"] / max(1, stats["drafted"])}
    log(f"20b SpeculativeGenerator, a {SPEC_DRAFT_LAYERS}-layer d512 draft, prompt {len(prompt)}, {SPEC_NEW} new, "
        f"f32: tokens == the plain engine's {equal}; {stats['rounds']} rounds, acceptance {out['acceptance']:.3f}, "
        f"{out['tokens_per_s']:.1f} tokens/s; K4 {k4} = {SPEC_DRAFT_LAYERS} x {forwards} one-token draft forwards "
        f"[{card}]")
    check(equal, "20b: the generator's f32 tokens differ from the plain engine's")
    check(forwards > 0 and k4 == SPEC_DRAFT_LAYERS * forwards and others == 0,
          f"20b: K4 launched {k4} (other paged launches {others}) over {forwards} one-token draft forwards; "
          f"expected {SPEC_DRAFT_LAYERS * forwards}")
    return out


def spec_engines_bf16(torch, np, kernels, PagedEngine, params, card):
    """20c: bf16 at 16 lanes, 16 echo prompts, 64 new: ngram drafts against
    plain decode, token agreement, decode tokens/s in turns (18a's method:
    a run of 64 new minus a run of one)."""
    def make(**kw):
        return PagedEngine(params, dtype="bfloat16", device=SCHED_DEVICE, **LM_CONFIG,
                           **{**LM_ENGINE, "prefix_cache": False, **kw})

    slots = LM_ENGINE["max_slots"]
    plain = make()
    prompts = echo_prompts(np, plain, slots)
    engines = {"plain": plain, "ngram": make(speculative={"draft": "ngram", "draft_k": SPEC_DRAFT_K})}
    tokens, counted = {}, {}
    for name, eng in engines.items():
        counted_run(torch, kernels, eng, prompts, SPEC_NEW)  # warm
        toks, _dt, k4, calls, rounds, drafted, accepted = counted_run(torch, kernels, eng, prompts, SPEC_NEW)
        check_k4(eng, k4, calls, rounds, f"20c bf16 {name}")
        tokens[name] = toks
        counted[name] = {"k4_launches": k4, "decode_calls": calls, "verify_rounds": rounds,
                         "acceptance": accepted / max(1, drafted)}
    rates = {name: [] for name in engines}
    for rep in range(SPEC_RATE_REPS):
        for name in (("plain", "ngram") if rep % 2 == 0 else ("ngram", "plain")):
            full = counted_run(torch, kernels, engines[name], prompts, SPEC_NEW)[1]
            one = counted_run(torch, kernels, engines[name], prompts, 1)[1]
            rates[name].append(slots * (SPEC_NEW - 1) / max(full - one, 1e-9))
    del engines, plain
    agreement = float(np.mean([np.mean(a == b) for a, b in zip(tokens["plain"], tokens["ngram"])]))
    rows = sum(bool((a == b).all()) for a, b in zip(tokens["plain"], tokens["ngram"]))
    best = {k: max(v) for k, v in rates.items()}
    log(f"20c bf16, {slots} echo prompts, {SPEC_NEW} new: ngram vs plain {rows}/{slots} rows equal, token agreement "
        f"{agreement:.4f}; ngram acceptance {counted['ngram']['acceptance']:.3f} over "
        f"{counted['ngram']['verify_rounds']} rounds; decode tokens/s plain {best['plain']:.1f}, ngram "
        f"{best['ngram']:.1f} ({best['ngram'] / best['plain']:.3f}x), turns {rates} [{card}]")
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"rows_equal": rows, "token_agreement": agreement, "decode_tokens_per_s": best,
            "decode_tokens_per_s_runs": rates, "counted": counted}


def speculative_paths(torch, np, kernels, PagedEngine, SpeculativeGenerator, load_lm_params, card):
    """Phase 20: speculative decoding at the generation config: the engine's
    lanes in f32 (20a), the generator's draft model on K4 (20b), ngram
    against plain in bf16 at 16 lanes (20c)."""
    t0 = time.perf_counter()
    params = load_lm_params("", LM_CONFIG, 0, torch.device(SCHED_DEVICE))
    params32 = load_lm_params("", LM_CONFIG, SEED + 5, torch.device(SCHED_DEVICE))
    numbers = {}
    numbers["20a"] = spec_engines_f32(torch, np, kernels, PagedEngine, params32, card)
    numbers["20b"] = spec_generator_path(torch, np, kernels, PagedEngine, SpeculativeGenerator, load_lm_params,
                                         params32, card)
    del params32
    numbers["20c"] = spec_engines_bf16(torch, np, kernels, PagedEngine, params, card)
    numbers["seconds"] = time.perf_counter() - t0
    log(f"phase 20: K4 launched {numbers['20b']['k4_launches']} = {SPEC_DRAFT_LAYERS} x "
        f"{numbers['20b']['single_token_forwards']} draft forwards in 20b, none over the verify rounds, "
        f"{numbers['seconds']:.1f} s [{card}]")
    return numbers


def queued_tokens(streams):
    """Pop every token the streams' queues hold now: {index: [tokens]}, and
    whether a queue ended."""
    got, ended = {}, False
    for i, s in enumerate(streams):
        while s.token_queue.qsize():
            item = s.token_queue.get()
            if item is None:
                ended = True
            else:
                got.setdefault(i, []).extend(item)
    return got, ended


def resumed_run(torch, kernels, eng, streams, t0):
    """Step ``eng`` dry with the launch counts set to 0 just before it:
    ms from ``t0`` to the first token a queue received (the time to
    resume), the tokens the queues received, K4 launches and decode calls
    a layer."""
    c0 = decode_calls(eng.engine_stats())
    sched_sync(torch)
    kernels.reset_launch_counts()
    got, ttr_ms = {}, None
    while eng.has_work():
        eng.step()
        new, _ = queued_tokens(streams)
        for i, toks in new.items():
            got.setdefault(i, []).extend(toks)
        if ttr_ms is None and new:
            ttr_ms = (time.perf_counter() - t0) * 1e3
    sched_sync(torch)
    k4 = sum(v for k, v in kernels.launch_counts().items() if k.startswith("paged_decode"))
    new, _ = queued_tokens(streams)
    for i, toks in new.items():
        got.setdefault(i, []).extend(toks)
    return ttr_ms, got, k4, decode_calls(eng.engine_stats()) - c0


def migration_lane(torch, np, kernels, PagedEngine, evacuate_streams, params32, prompts, pool: str, card):
    """21a on one pool: an uninterrupted control, then the same streamed
    requests evacuated from engine A to engine B after MIG_WAVES waves."""
    def make():
        with knob_env(SELDON_TPU_KV_DTYPE="int8" if pool == "int8" else None):
            eng = sched_engine(torch, PagedEngine, params32, dtype="float32", **NO_PREFIX_CACHE)
        check(eng._kernel_active and eng._kv_int8 == (pool == "int8"),
              f"21a {pool}: the engine is off the kernel lane or on the wrong pool")
        return eng

    ref = make()
    want = drive(ref, prompts, MIG_NEW, seed=0)  # also warms every call the lanes below make
    del ref
    a, b = make(), make()
    drive(b, prompts[:1], 8)  # B's first calls pay here, not in the window
    streams = [a.submit(p, max_new_tokens=MIG_NEW, seed=0, stream_tokens=True) for p in prompts]
    for _ in range(MIG_WAVES):
        a.step()
    got, ended = queued_tokens(streams)
    check(not ended and all(0 < len(got.get(i, [])) < MIG_NEW for i in range(len(prompts))),
          f"21a {pool}: the streams are not mid-decode after {MIG_WAVES} waves")
    p0 = b.engine_stats()["prefill_tokens"]
    t0 = time.perf_counter()
    summary = evacuate_streams(a, [b])
    check(summary["migrated"] == len(prompts) and summary["failed"] == 0,
          f"21a {pool}: evacuation moved {summary['migrated']} of {len(prompts)} streams ({summary['failed']} failed)")
    ttr_ms, more, k4, calls = resumed_run(torch, kernels, b, streams, t0)
    for i, toks in more.items():
        got.setdefault(i, []).extend(toks)
    loss = sum(max(0, len(w) - len(got.get(i, []))) for i, w in enumerate(want))
    equal = all(got.get(i, []) == w.tolist() for i, w in enumerate(want))
    check(all(s.error is None for s in streams), f"21a {pool}: a migrated stream failed")
    check(loss == 0 and equal, f"21a {pool}: token loss {loss}, tokens equal to the control {equal}")
    check(calls > 0 and k4 == LM_CONFIG["num_layers"] * calls,
          f"21a {pool}: K4 launched {k4} times over {calls} decode calls a layer on B; expected "
          f"{LM_CONFIG['num_layers'] * calls}")
    stats = b.engine_stats()
    check(stats["prefill_tokens"] == p0, f"21a {pool}: B prefilled {stats['prefill_tokens'] - p0} tokens of the "
          "migrated streams; their pages arrive computed")
    return {"migrate_ttr_ms": ttr_ms, "migrate_token_loss": loss, "tokens_equal": equal,
            "migrated": summary["migrated"], "migrated_in": stats["migrated_in"], "k4_launches": k4,
            "decode_calls": calls}, want


def replay_lane(torch, np, kernels, PagedEngine, params32, prompts, want, card):
    """21a's journal contrast: the same streams drained after MIG_WAVES
    waves and re-derived by ``replay`` on a fresh engine."""
    def make():
        return sched_engine(torch, PagedEngine, params32, dtype="float32", **NO_PREFIX_CACHE)

    c, d = make(), make()
    drive(d, prompts[:1], 8)
    for p in prompts:
        c.submit(p, max_new_tokens=MIG_NEW, seed=0, stream_tokens=True)
    for _ in range(MIG_WAVES):
        c.step()
    t0 = time.perf_counter()
    entries = c.drain()
    replayed = d.replay(entries, stream_tokens=True)
    check(len(replayed) == len(prompts), f"21a replay: {len(replayed)} of {len(prompts)} journal entries replayed")
    ttr_ms, _got, k4, calls = resumed_run(torch, kernels, d, replayed, t0)
    equal = all(s.error is None and bool((s.result == w).all()) for s, w in zip(replayed, want))
    check(equal, "21a replay: the replayed streams' tokens differ from the uninterrupted control")
    check(calls > 0 and k4 == LM_CONFIG["num_layers"] * calls,
          f"21a replay: K4 launched {k4} times over {calls} decode calls a layer; expected "
          f"{LM_CONFIG['num_layers'] * calls}")
    return {"replay_ttr_ms": ttr_ms, "tokens_equal": equal, "replayed": d.engine_stats()["replayed"],
            "drained": c.engine_stats()["drained"], "k4_launches": k4, "decode_calls": calls}


def migration_paths(torch, np, kernels, PagedEngine, evacuate_streams, params32, card):
    """21a: live migration and journal replay at the generation config, the
    JAX bench's method (``bench.py:2129-2265``), float32 with TF32 off."""
    rng = np.random.default_rng(SEED + 210)
    prompts = [rng.integers(0, LM_CONFIG["vocab_size"], MIG_PROMPT).astype(np.int32) for _ in range(MIG_STREAMS)]
    out = {}
    with no_tf32(torch):
        out["native"], want = migration_lane(torch, np, kernels, PagedEngine, evacuate_streams, params32, prompts,
                                             "native", card)
        out["int8"], _ = migration_lane(torch, np, kernels, PagedEngine, evacuate_streams, params32, prompts,
                                        "int8", card)
        out["replay"] = replay_lane(torch, np, kernels, PagedEngine, params32, prompts, want, card)
    n, q, r = out["native"], out["int8"], out["replay"]
    log(f"21a f32 (TF32 off), {MIG_STREAMS} streamed prompts of {MIG_PROMPT}, {MIG_NEW} new, evacuated after "
        f"{MIG_WAVES} waves: native pool migrate_ttr_ms {n['migrate_ttr_ms']:.2f}, token loss "
        f"{n['migrate_token_loss']}, tokens == control {n['tokens_equal']}; int8 pool migrate_ttr_ms "
        f"{q['migrate_ttr_ms']:.2f}, loss {q['migrate_token_loss']}, equal {q['tokens_equal']}; drain + replay "
        f"replay_ttr_ms {r['replay_ttr_ms']:.2f}, equal {r['tokens_equal']}; K4 on B {n['k4_launches']} = "
        f"{LM_CONFIG['num_layers']} x {n['decode_calls']} (int8 {q['k4_launches']} = {LM_CONFIG['num_layers']} x "
        f"{q['decode_calls']}), on the replay engine {r['k4_launches']} = {LM_CONFIG['num_layers']} x "
        f"{r['decode_calls']} [{card}]")
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def tier_point(torch, np, kernels, PagedEngine, params32, sessions, offload: bool, spill_dir=None,
               checksum: str = "1"):
    """21b: revisit both sessions TIER_ROUNDS times through a pool that
    holds one: the outputs, the least wall of the warm rounds (2 on), the
    tier counters over them, K4 launches and decode calls."""
    pages = -(-(TIER_HIST + TIER_NEW) // LM_ENGINE["page_size"]) + 1
    budget = "1e-9" if spill_dir else "2"
    with knob_env(SELDON_TPU_KV_OFFLOAD="1" if offload else "0", SELDON_TPU_KV_HOST_BUDGET_GIB=budget,
                  SELDON_TPU_KV_SPILL_DIR=spill_dir):
        eng = sched_engine(torch, PagedEngine, params32, dtype="float32", max_slots=1, steps_per_call=4,
                           max_steps_per_call=8, num_pages=pages)
    outs, walls, warm0 = [], [], None
    k4 = calls = 0
    with knob_env(SELDON_TPU_KV_CHECKSUM=checksum):
        for r in range(TIER_ROUNDS):
            if r == 2:
                warm0 = eng.engine_stats()
            c0 = decode_calls(eng.engine_stats())
            sched_sync(torch)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            for p in sessions:
                outs.append(eng.generate(p, max_new_tokens=TIER_NEW))
            sched_sync(torch)
            walls.append(time.perf_counter() - t0)
            k4 += sum(v for k, v in kernels.launch_counts().items() if k.startswith("paged_decode"))
            calls += decode_calls(eng.engine_stats()) - c0
    stats = eng.engine_stats()
    tier = {k: stats[k] - warm0[k] for k in stats if k.startswith("kv_tier_") and not k.endswith("_bytes")}
    return outs, min(walls[2:]), tier, stats, k4, calls


def tier_paths(torch, np, kernels, PagedEngine, params32, card):
    """21b: the KV tier, the JAX bench's method (``bench.py:2884-2960``):
    two returning sessions of TIER_HIST tokens, TIER_NEW new a revisit,
    float32, offload on and off in turns (on, off, off, on); then one run
    with a host budget under one page and a spill directory."""
    from seldon_core_tpu_torch.codec.bufview import crc32c, crc32c_impl

    rng = np.random.default_rng(SEED + 211)
    sessions = [rng.integers(0, LM_CONFIG["vocab_size"], TIER_HIST).astype(np.int32) for _ in range(2)]
    runs = {True: [], False: []}
    with no_tf32(torch):
        for offload in (True, False, False, True):
            runs[offload].append(tier_point(torch, np, kernels, PagedEngine, params32, sessions, offload))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_kv_spill_") as spill:
            disk = tier_point(torch, np, kernels, PagedEngine, params32, sessions, True, spill_dir=spill)
            spilled = len([n for n in os.listdir(spill) if n.endswith(".srt1")])
        # where a promotion's time goes: the same run with the CRC32C trailer off
        no_crc = tier_point(torch, np, kernels, PagedEngine, params32, sessions, True, checksum="0")
    blob = bytes(64 << 20)
    t_crc = time.perf_counter()
    crc32c(blob)
    crc_mb_s = len(blob) / 1e6 / (time.perf_counter() - t_crc)
    off_outs = runs[False][0][0]
    equal = all(same_rows(r[0], off_outs) for r in runs[True] + runs[False] + [disk, no_crc])
    on_wall = min(r[1] for r in runs[True])
    off_wall = min(r[1] for r in runs[False])
    on = runs[True][0][2]
    hits = on["kv_tier_host_hits"] + on["kv_tier_disk_hits"]
    hit_pct = 100.0 * hits / max(1, hits + on["kv_tier_misses"])
    k4 = sum(r[4] for r in runs[True] + runs[False] + [disk, no_crc])
    calls = sum(r[5] for r in runs[True] + runs[False] + [disk, no_crc])
    out = {"kv_tier_promote_x": off_wall / max(on_wall, 1e-9), "kv_tier_hit_pct": hit_pct,
           "kv_tier_on_revisit_ms": on_wall * 1e3, "kv_tier_off_revisit_ms": off_wall * 1e3,
           "on_walls_ms": [r[1] * 1e3 for r in runs[True]], "off_walls_ms": [r[1] * 1e3 for r in runs[False]],
           "warm_counters": on, "totals": {k: v for k, v in runs[True][0][3].items() if k.startswith("kv_tier_")},
           "disk": {"counters": disk[2], "totals": {k: v for k, v in disk[3].items() if k.startswith("kv_tier_")},
                    "files_left": spilled},
           "on_no_checksum_revisit_ms": no_crc[1] * 1e3, "crc32c": crc32c_impl(), "crc32c_mb_per_s": crc_mb_s,
           "tokens_equal": equal, "k4_launches": k4, "decode_calls": calls}
    log(f"21b KV tier, 2 sessions of {TIER_HIST} tokens, {TIER_NEW} new a revisit, {TIER_ROUNDS} rounds, a "
        f"one-session pool, f32: tokens equal on and off {equal}; promote {out['kv_tier_promote_x']:.3f}x, hit "
        f"{hit_pct:.1f}%, revisit {on_wall * 1e3:.2f} ms on / {off_wall * 1e3:.2f} ms off (turns on "
        f"{out['on_walls_ms']}, off {out['off_walls_ms']}); host hits {on['kv_tier_host_hits']}, disk run: disk hits "
        f"{disk[2]['kv_tier_disk_hits']}, host hits {disk[2]['kv_tier_host_hits']}; on with the checksum off "
        f"{no_crc[1] * 1e3:.2f} ms; K4 {k4} = {LM_CONFIG['num_layers']} x {calls}; CRC32C {out['crc32c']} at "
        f"{crc_mb_s:.0f} MB/s on the host [{card}]")
    check(equal, "21b: the tokens differ with the KV tier on and off")
    check(on["kv_tier_host_hits"] > 0, f"21b: no host-tier hit with offload on: {on}")
    check(disk[2]["kv_tier_disk_hits"] > 0, f"21b: no disk-tier hit with a spill directory: {disk[2]}")
    check(calls > 0 and k4 == LM_CONFIG["num_layers"] * calls,
          f"21b: K4 launched {k4} times over {calls} decode calls a layer; expected {LM_CONFIG['num_layers'] * calls}")
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def start_lm_worker(http_port: int, grpc_port: int, logfile, env):
    """A served StreamingLM at the generation config with ``--api BOTH``."""
    return subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
         "seldon_core_tpu_torch.models.paged.StreamingLM", "--api", "BOTH", "--host", "127.0.0.1",
         "--http-port", str(http_port), "--grpc-port", str(grpc_port), "--parameters", json.dumps(LM_PARAMS)],
        cwd=ROOT, stdout=logfile, stderr=subprocess.STDOUT, start_new_session=True, env=env)


def failed_reason(base: str, prompt, max_new: int):
    """One unary request that the server is expected to fail: its HTTP
    status and ``status.reason``, or the error that ended it."""
    body = {"data": {"ndarray": [[int(t) for t in prompt]]}, "meta": {"tags": {"max_new_tokens": max_new}}}
    try:
        resp = http(base + "/predict", body, timeout=300)
        return 200, resp.get("status", {}).get("reason", "")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read()).get("status", {}).get("reason", "")
        except ValueError:
            return e.code, ""
    except (urllib.error.URLError, ConnectionError, OSError) as e:
        return 0, type(e).__name__


class ServedPair:
    """21c's two CLI StreamingLM processes, started before 21a so their
    loads overlap the in-process work: A (``SELDON_TPU_EVACUATE_TO`` = B's
    gRPC port, a journal path) and B."""

    def __init__(self):
        (self.a_http, a_grpc), (self.b_http, self.b_grpc) = [(free_port(), free_port()) for _ in range(2)]
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_evacuate_")
        self.journal = os.path.join(self.tmp, "journal.jsonl")
        self.env = dict(os.environ, **NO_PREFIX_CACHE_ENV)
        self.logs = {name: os.path.join(self.tmp, f"{name}.log") for name in ("a", "b", "c")}
        self.files = {name: open(path, "w") for name, path in self.logs.items()}
        self.procs = {"b": start_lm_worker(self.b_http, self.b_grpc, self.files["b"], self.env),
                      "a": start_lm_worker(self.a_http, a_grpc, self.files["a"], dict(
                          self.env, SELDON_TPU_EVACUATE_TO=f"grpc://127.0.0.1:{self.b_grpc}",
                          SELDON_TPU_DRAIN_JOURNAL=self.journal))}

    def close(self) -> None:
        for proc in self.procs.values():
            stop_server(proc)
        for f in self.files.values():
            f.close()


def served_evacuation(np, pair: ServedPair, card):
    """21c: A is SIGTERMed with requests decoding and queued: B imports the
    live ones and finishes them, A's clients get 503 MIGRATING or
    DRAINING, and a process started on A's journal path replays it."""
    rng = np.random.default_rng(SEED + 212)
    prompts = [rng.integers(0, LM_CONFIG["vocab_size"], MIG_PROMPT) for _ in range(SERVED_REQUESTS)]
    base_a, base_b = f"http://127.0.0.1:{pair.a_http}", f"http://127.0.0.1:{pair.b_http}"
    procs, logs, journal = pair.procs, pair.logs, pair.journal
    wait_ready(procs["b"], base_b, logs["b"])
    wait_ready(procs["a"], base_a, logs["a"])
    b0 = http(base_b + "/health/status")["jsonData"]["engine"]
    with ThreadPoolExecutor(SERVED_REQUESTS) as pool:
        futures = [pool.submit(failed_reason, base_a, p, SERVED_NEW) for p in prompts]
        deadline = time.perf_counter() + 120
        while time.perf_counter() < deadline:
            eng = http(base_a + "/health/status")["jsonData"]["engine"]
            if eng["active"] == LM_ENGINE["max_slots"] and eng["queued"] > 0 and eng["tokens"] > 64:
                break
            time.sleep(0.05)
        check(eng["active"] == LM_ENGINE["max_slots"] and eng["queued"] > 0,
              f"21c: A never held full slots and a queue before the SIGTERM: {eng}")
        t_term = time.perf_counter()
        os.killpg(procs["a"].pid, signal.SIGTERM)
        answers = [f.result() for f in futures]
        procs["a"].wait(timeout=120)
        exit_s = time.perf_counter() - t_term
    reasons = sorted({r for _c, r in answers})
    check(all(code == 503 and reason in ("MIGRATING", "DRAINING") for code, reason in answers),
          f"21c: A's clients did not all get 503 MIGRATING / DRAINING: {answers}")
    lines = [json.loads(line) for line in open(journal)] if os.path.exists(journal) else []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 120:
        b1 = http(base_b + "/health/status")["jsonData"]["engine"]
        if b1["completed"] - b0["completed"] >= b1["migrated_in"] - b0["migrated_in"] > 0 and b1["active"] == 0:
            break
        time.sleep(0.1)
    migrated = b1["migrated_in"] - b0["migrated_in"]
    check(migrated > 0, f"21c: B imported no migrated stream: {b1}")
    check(b1["completed"] - b0["completed"] >= migrated, f"21c: B did not finish the streams it imported: {b1}")
    check(len(lines) > 0, "21c: A journaled nothing (its queued streams cannot migrate)")
    c_http, c_grpc = free_port(), free_port()
    procs["c"] = start_lm_worker(c_http, c_grpc, pair.files["c"], dict(pair.env, SELDON_TPU_DRAIN_JOURNAL=journal))
    status_c, _ = wait_ready(procs["c"], f"http://127.0.0.1:{c_http}", logs["c"])
    replayed = status_c["engine"]["replayed"]
    check(replayed == len(lines) and not os.path.exists(journal),
          f"21c: the respawned process replayed {replayed} of {len(lines)} journal lines")
    a_log = open(logs["a"], errors="replace").read()
    out = {"requests": SERVED_REQUESTS, "reasons": reasons, "migrated_in": migrated, "journal_lines": len(lines),
           "replayed": replayed, "sigterm_to_exit_s": exit_s,
           "evacuation_log": [line for line in a_log.splitlines() if "remote evacuation" in line][-1:]}
    log(f"21c served: A SIGTERMed with {LM_ENGINE['max_slots']} streams decoding and "
        f"{SERVED_REQUESTS - LM_ENGINE['max_slots']} queued: B imported {migrated}, A journaled {len(lines)}, its "
        f"clients got 503 {reasons}, A exited {exit_s:.2f} s after the signal; a process on A's journal path "
        f"replayed {replayed} [{card}]")
    return out


def evacuation_paths(torch, np, kernels, PagedEngine, evacuate_streams, load_lm_params, card):
    """Phase 21: drain and replay, live migration and the KV tier at the
    generation config (21a, 21b in process; 21c served)."""
    t0 = time.perf_counter()
    pair = ServedPair()
    try:
        params32 = load_lm_params("", LM_CONFIG, SEED + 21, torch.device(SCHED_DEVICE))
        numbers = {"21a": migration_paths(torch, np, kernels, PagedEngine, evacuate_streams, params32, card),
                   "21b": tier_paths(torch, np, kernels, PagedEngine, params32, card)}
        del params32
        numbers["21c"] = served_evacuation(np, pair, card)
    finally:
        pair.close()
    a = numbers["21a"]
    numbers["k4_launches"] = (a["native"]["k4_launches"] + a["int8"]["k4_launches"] + a["replay"]["k4_launches"]
                              + numbers["21b"]["k4_launches"])
    numbers["decode_calls"] = (a["native"]["decode_calls"] + a["int8"]["decode_calls"] + a["replay"]["decode_calls"]
                               + numbers["21b"]["decode_calls"])
    numbers["seconds"] = time.perf_counter() - t0
    log(f"phase 21: K4 launched {numbers['k4_launches']} = {LM_CONFIG['num_layers']} x {numbers['decode_calls']} "
        f"decode calls on the resumed, replayed and promoted streams, {numbers['seconds']:.1f} s [{card}]")
    return numbers

# ---------------------------------------------------------------------------
# phase 22: generation telemetry and chaos
# ---------------------------------------------------------------------------

def telemetry_lane_env(on: bool, capture_dir: str = ""):
    """The telemetry plane's knobs: ``on`` = recorder, telemetry, NaN guard,
    watchdog (and the bridge) at their defaults with every request
    captured; off = the off lane (each plane off, capture unset)."""
    if on:
        return knob_env(SELDON_TPU_TELEMETRY=None, SELDON_TPU_FLIGHT_RECORDER=None, SELDON_TPU_NAN_GUARD=None,
                        SELDON_TPU_WATCHDOG=None, SELDON_TPU_CAPTURE="1", SELDON_TPU_CAPTURE_SAMPLE="1",
                        SELDON_TPU_CAPTURE_DIR=capture_dir or None)
    return knob_env(SELDON_TPU_TELEMETRY="0", SELDON_TPU_FLIGHT_RECORDER="0", SELDON_TPU_NAN_GUARD="0",
                    SELDON_TPU_WATCHDOG="0", SELDON_TPU_CAPTURE=None, SELDON_TPU_CAPTURE_SAMPLE=None,
                    SELDON_TPU_CAPTURE_DIR=None)


def telemetry_drive(eng, prompts, max_new: int, extras=None, check_ok: bool = True):
    """Submit every prompt (seed 0, puid ``smoke22-<i>``) and step the
    engine dry; ``extras`` = (bridge, ring): one bridge collect and one
    telemetry sample a wave, and every stream captured at its end (the on
    lane's work).  Returns the streams."""
    streams = [eng.submit(p, max_new_tokens=max_new, seed=0, puid=f"smoke22-{i}") for i, p in enumerate(prompts)]
    while eng.has_work():
        eng.step()
        if extras is not None:
            extras[0].collect()
            extras[1].sample_engine(eng)
    if extras is not None:
        for st in streams:
            trigger = eng.capture_trigger(st.puid, st.error)
            if trigger is not None:
                eng.capture_request(st, puid=st.puid, trigger=trigger, extra={"request_seed": 0})
    if check_ok:
        for st in streams:
            check(st.error is None and st.result is not None and st.result.shape == (max_new,),
                  f"a stream failed: {st.error}")
    return streams


def telemetry_rate(torch, eng, prompts, tally, what: str, extras=None) -> float:
    """22a: decode tokens/s of one turn, 18a's method (a run of TELE_NEW
    new tokens minus a run of one), the on lane's work inside both."""
    def timed(max_new):
        sched_sync(torch)
        t0 = time.perf_counter()
        telemetry_drive(eng, prompts, max_new, extras)
        sched_sync(torch)
        return time.perf_counter() - t0

    t_full = tally.run(eng, lambda: timed(TELE_NEW), what)
    t_one = timed(1)
    return len(prompts) * (TELE_NEW - 1) / max(t_full - t_one, 1e-9)


def telemetry_overhead(torch, np, PagedEngine, params, tally, card):
    """22a: bf16 at 16 lanes, the telemetry plane on and off in turns."""
    from seldon_core_tpu_torch.utils.metrics import GenerationPrometheusBridge, Registry
    from seldon_core_tpu_torch.utils.telemetry import TelemetryRing

    rng = np.random.default_rng(SEED + 220)
    prompts = [rng.integers(0, LM_CONFIG["vocab_size"], TELE_PROMPT).astype(np.int32) for _ in range(TELE_STREAMS)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as capdir:
        with telemetry_lane_env(True, capdir):
            on = sched_engine(torch, PagedEngine, params, **NO_PREFIX_CACHE)
        with telemetry_lane_env(False):
            off = sched_engine(torch, PagedEngine, params, **NO_PREFIX_CACHE)
        check(on.recorder is not None and on._watchdog is not None and on._nan_guard and on._capture_enabled
              and off.recorder is None and off._watchdog is None and not off._nan_guard
              and not off._capture_enabled and not off._telemetry_enabled,
              "22a: the on and off engines do not carry the planes they were built for")
        extras = (GenerationPrometheusBridge(on, model_name="smoke22a", registry=Registry()), TelemetryRing())
        with telemetry_lane_env(True, capdir):
            telemetry_drive(on, prompts[:2], 8, extras)  # first calls pay outside the turns
            telemetry_drive(off, prompts[:2], 8)
            rates = {"on": [], "off": []}
            for lane in ("on", "off", "off", "on")[: 2 * TELE_RATE_REPS]:
                eng = on if lane == "on" else off
                rates[lane].append(telemetry_rate(torch, eng, prompts, tally, f"22a {lane}",
                                                  extras if lane == "on" else None))
            captures = on.engine_stats()["captures"]
            stats_keys = set(off.engine_stats())
    ratio = statistics.mean(rates["on"]) / statistics.mean(rates["off"])
    check(captures > 0, "22a: the on lane captured no request")
    check(not any(k.startswith(("cost_", "capture")) for k in stats_keys),
          f"22a: the off lane's engine_stats carries a telemetry key: {sorted(stats_keys)}")
    log(f"22a bf16, {TELE_STREAMS} lanes, prompt {TELE_PROMPT}, {TELE_NEW} new, telemetry plane in turns (on, off, "
        f"off, on): decode tok/s on {[round(r, 1) for r in rates['on']]}, off {[round(r, 1) for r in rates['off']]}, "
        f"on/off {ratio:.4f}; {captures} captures [{card}]")
    return {"decode_tok_s_on": rates["on"], "decode_tok_s_off": rates["off"], "on_off_ratio": ratio,
            "captures": captures}


def chaos_paths(torch, np, PagedEngine, params32, tally, card):
    """22b: float32 with TF32 off: one paged.nan on 16 lanes, one
    contained paged.chunk, paged.alloc:times=3; against uninjected runs on
    an off-lane engine (which are also the on/off token check)."""
    from seldon_core_tpu_torch.utils import faults

    rng = np.random.default_rng(SEED + 221)
    V = LM_CONFIG["vocab_size"]
    prompts = [rng.integers(0, V, TELE_PROMPT).astype(np.int32) for _ in range(TELE_STREAMS + TELE_QUEUED)]
    main = prompts[:TELE_STREAMS]
    out = {}
    with no_tf32(torch):
        with telemetry_lane_env(False):
            off = sched_engine(torch, PagedEngine, params32, dtype="float32", **NO_PREFIX_CACHE)
        with telemetry_lane_env(True), knob_env(SELDON_TPU_PAGED_DEBUG="1"):
            on = sched_engine(torch, PagedEngine, params32, dtype="float32", **NO_PREFIX_CACHE)
        check(on._debug_invariants, "22b: the on engine does not audit its allocator")
        ctrl24 = [st.result for st in tally.run(off, lambda: telemetry_drive(off, prompts, TELE_NEW), "22b control")]
        ctrl_long = [st.result for st in tally.run(off, lambda: telemetry_drive(off, main, TELE_LONG_NEW),
                                                   "22b long control")]
        plain = [st.result for st in tally.run(on, lambda: telemetry_drive(on, main, TELE_NEW), "22b on lane")]
        out["on_off_equal"] = same_rows(plain, ctrl24[:TELE_STREAMS])
        check(out["on_off_equal"], "22b: f32 tokens differ between the telemetry plane on and off")
        # paged.nan: the first decode chunk's lowest slot goes non-finite
        faults.configure("paged.nan:times=1")
        try:
            streams = tally.run(on, lambda: telemetry_drive(on, main, TELE_NEW, check_ok=False), "22b paged.nan")
        finally:
            faults.clear()
        poisoned = [i for i, st in enumerate(streams) if st.error is not None]
        reasons = {getattr(streams[i].error, "reason", "") for i in poisoned}
        mates = [i for i in range(TELE_STREAMS) if i not in poisoned]
        mates_equal = all(streams[i].result is not None and (streams[i].result == ctrl24[i]).all() for i in mates)
        q = on.engine_stats()["quarantined"]
        out["nan"] = {"poisoned": len(poisoned), "reasons": sorted(reasons), "quarantined": q,
                      "mates_equal": mates_equal}
        check(len(poisoned) == 1 and reasons == {"NUMERIC_POISON"} and q == 1 and mates_equal,
              f"22b paged.nan: {out['nan']}")
        # paged.chunk: the first chunk of 16 fails, the 8 queued serve on
        faults.configure("paged.chunk:times=1")
        try:
            streams = tally.run(on, lambda: telemetry_drive(on, prompts, TELE_NEW, check_ok=False), "22b paged.chunk")
        finally:
            faults.clear()
        failed = [i for i, st in enumerate(streams) if st.error is not None]
        served_equal = all(streams[i].result is not None and (streams[i].result == ctrl24[i]).all()
                           for i in range(len(prompts)) if i not in failed)
        stats = on.engine_stats()
        out["chunk"] = {"failed": len(failed), "reasons": sorted({streams[i].error.reason for i in failed}),
                        "served": len(prompts) - len(failed), "served_equal": served_equal,
                        "chunk_faults": stats["chunk_faults"], "pages_in_use_after": stats["pool_pages_used"]}
        check(len(failed) == TELE_STREAMS and out["chunk"]["reasons"] == ["ENGINE_CHUNK_FAULT"] and served_equal
              and stats["chunk_faults"] == 1 and stats["pool_pages_used"] == 0,
              f"22b paged.chunk: {out['chunk']}")
        # paged.alloc:times=3, armed after the first wave: three growths fail
        def alloc_run():
            streams = [on.submit(p, max_new_tokens=TELE_LONG_NEW, seed=0) for p in main]
            on.step()
            faults.configure("paged.alloc:times=3")
            try:
                on.run()
            finally:
                faults.clear()
            return streams

        s0 = on.engine_stats()["stalls"]
        streams = tally.run(on, alloc_run, "22b paged.alloc")
        stalls = on.engine_stats()["stalls"] - s0
        alloc_equal = all(st.error is None and (st.result == w).all() for st, w in zip(streams, ctrl_long))
        out["alloc"] = {"stalls": stalls, "tokens_equal": alloc_equal, "fired": faults.stats().get("paged.alloc", 0)}
        check(stalls > 0 and alloc_equal, f"22b paged.alloc:times=3: {out['alloc']}")
    out["ctrl_long"] = ctrl_long
    out["prompts"] = main
    del on, off
    log(f"22b f32 (TF32 off), {TELE_STREAMS} lanes, prompt {TELE_PROMPT}: tokens on == off {out['on_off_equal']}; "
        f"paged.nan: {out['nan']['poisoned']} stream 500 {out['nan']['reasons']}, quarantined "
        f"{out['nan']['quarantined']}, the other {len(mates)} equal {mates_equal}; paged.chunk: "
        f"{out['chunk']['failed']} failed {out['chunk']['reasons']}, {out['chunk']['served']} queued served equal "
        f"{served_equal}, audit clean, pages in use after {stats['pool_pages_used']}; paged.alloc:times=3: stalls "
        f"{stalls}, tokens equal {alloc_equal} [{card}]")
    return out


def watchdog_paths(torch, np, kernels, PagedEngine, evacuate_streams, params, params32, chaos, tally, card):
    """22c: a cold engine's first waves (a first-use nvcc build of K4 among
    them) stay healthy; a ceiling under the chunk wall drives an engine to
    degraded and then evacuating; evacuate_streams skips a degraded peer
    and moves the streams to the healthy one with no token lost; the force
    knob forces the state and clearing it recovers."""
    from seldon_core_tpu_torch.ops import _build

    wd = dict(SELDON_TPU_WATCHDOG_WINDOW=str(WD_WINDOW), SELDON_TPU_WATCHDOG_BREACHES=str(WD_BREACHES))
    prompts, ctrl_long = chaos["prompts"], chaos["ctrl_long"]
    out = {}
    # the cold engine: K4 built anew by nvcc inside its first wave
    built_before = _build.build_events()
    saved_dir, saved_lib = _build.BUILD_DIR, _build._LIBS.pop("paged_decode", None)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cold_build_") as cold_dir:
        _build.BUILD_DIR = type(saved_dir)(cold_dir)
        try:
            with knob_env(SELDON_TPU_WATCHDOG_CHUNK_MS=str(WD_COLD_CEILING_MS), **wd):
                cold = sched_engine(torch, PagedEngine, params, **NO_PREFIX_CACHE)
            tally.run(cold, lambda: telemetry_drive(cold, prompts, TELE_NEW), "22c cold engine")
        finally:
            _build.BUILD_DIR = saved_dir
            if saved_lib is not None:
                _build._LIBS["paged_decode"] = saved_lib
    stats = cold.engine_stats(detail=True)
    first = stats["recorder"][0]
    warm_walls = [r["wall_ms"] for r in stats["recorder"][1:]]
    out["cold"] = {"health": stats["health"], "trips": stats["watchdog_trips"],
                   "builds": _build.build_events() - built_before,
                   "first_wave_ms": first["wall_ms"] + first["prefill_wall_ms"], "warm_chunk_ms": min(warm_walls),
                   "ceiling_ms": WD_COLD_CEILING_MS, "window_compiles": stats["watchdog"]["window_compiles"]}
    check(stats["health"] == "healthy" and stats["watchdog_trips"] == 0 and out["cold"]["builds"] >= 1,
          f"22c: a cold engine's first waves left it {stats['health']}: {out['cold']}")
    del cold
    with no_tf32(torch):
        # the source: a ceiling under a quarter of the warm bf16 chunk wall
        ceiling = out["cold"]["warm_chunk_ms"] / 4
        with knob_env(SELDON_TPU_WATCHDOG_CHUNK_MS=f"{ceiling:.4f}", **wd):
            src = sched_engine(torch, PagedEngine, params32, dtype="float32", **NO_PREFIX_CACHE)
            deg = sched_engine(torch, PagedEngine, params32, dtype="float32", **NO_PREFIX_CACHE)
        with knob_env(**wd):
            healthy = sched_engine(torch, PagedEngine, params32, dtype="float32", **NO_PREFIX_CACHE)
        tally.run(deg, lambda: telemetry_drive(deg, prompts[:1], 4 * LM_ENGINE["steps_per_call"]), "22c peer")
        telemetry_drive(healthy, prompts[:1], 8)
        check(deg.engine_stats()["health"] == "degraded" and healthy.engine_stats()["health"] == "healthy",
              f"22c: the peers are {deg.engine_stats()['health']} / {healthy.engine_stats()['health']}, expected "
              "degraded / healthy")
        streams = [src.submit(p, max_new_tokens=TELE_LONG_NEW, seed=0, stream_tokens=True) for p in prompts]
        states, t_breach, t_evac = [], None, None

        def degrade():
            nonlocal t_breach, t_evac
            while src.has_work() and t_evac is None:
                src.step()
                st = src.engine_stats(detail=True)
                states.append(st["health"])
                if t_breach is None and st["watchdog"]["wall_breaches"] > 0:
                    t_breach = time.perf_counter()
                if st["health"] == "evacuating":
                    t_evac = time.perf_counter()

        tally.run(src, degrade, "22c source")
        got, _ended = queued_tokens(streams)
        check(t_evac is not None and "degraded" in states,
              f"22c: the source went {states}, never degraded then evacuating under a {ceiling:.3f} ms ceiling")
        out["degrade"] = {"ceiling_ms": ceiling, "states": states, "waves_to_evacuating": len(states),
                          "breach_to_evacuating_ms": (t_evac - t_breach) * 1e3}
        t0 = time.perf_counter()
        summary = evacuate_streams(src, [deg, healthy])
        ttr_ms, more, k4, calls = resumed_run(torch, kernels, healthy, streams, t0)
        for i, toks in more.items():
            got.setdefault(i, []).extend(toks)
        loss = sum(max(0, len(w) - len(got.get(i, []))) for i, w in enumerate(ctrl_long))
        equal = all(got.get(i, []) == w.tolist() for i, w in enumerate(ctrl_long))
        mig = {"migrated": summary["migrated"], "failed": summary["failed"],
               "degraded_peer_in": deg.engine_stats()["migrated_in"],
               "healthy_peer_in": healthy.engine_stats()["migrated_in"], "token_loss": loss, "tokens_equal": equal,
               "ttr_ms": ttr_ms, "k4_launches": k4, "decode_calls": calls}
        out["evacuate"] = mig
        check(mig["migrated"] == TELE_STREAMS and mig["degraded_peer_in"] == 0
              and mig["healthy_peer_in"] == TELE_STREAMS and loss == 0 and equal,
              f"22c: evacuate_streams did not move every stream to the healthy peer, losslessly: {mig}")
        check(calls > 0 and k4 == LM_CONFIG["num_layers"] * calls,
              f"22c: K4 launched {k4} times over {calls} decode calls a layer on the healthy peer")
        tally.launches += k4
        tally.steps += calls
        # the operator's switch on the healthy peer, then cleared
        with knob_env(SELDON_TPU_FORCE_EVACUATE="1"):
            tally.run(healthy, lambda: telemetry_drive(healthy, prompts[:1], 8), "22c forced")
            forced = healthy.engine_stats()["health"]
        tally.run(healthy, lambda: telemetry_drive(healthy, prompts[:1], 8), "22c cleared")
        cleared = healthy.engine_stats()["health"]
        out["force"] = {"forced": forced, "cleared": cleared}
        check(forced == "evacuating" and cleared == "healthy",
              f"22c: SELDON_TPU_FORCE_EVACUATE gave {forced}, clearing it {cleared}")
    del src, deg, healthy
    log(f"22c watchdog (window {WD_WINDOW}, {WD_BREACHES} breaches): a cold engine with K4 built anew "
        f"({out['cold']['builds']} build/load events, first wave {out['cold']['first_wave_ms']:.1f} ms over a "
        f"{WD_COLD_CEILING_MS:.0f} ms ceiling) stays {out['cold']['health']}; under a {ceiling:.3f} ms ceiling the "
        f"source went {'/'.join(dict.fromkeys(states))} in {len(states)} waves, "
        f"{out['degrade']['breach_to_evacuating_ms']:.1f} ms from its first breach to evacuating; evacuate_streams "
        f"moved {mig['migrated']} streams to the healthy peer ({mig['degraded_peer_in']} to the degraded one), "
        f"token loss {loss}, equal {equal}, ttr {ttr_ms:.2f} ms; forced {forced}, cleared {cleared} [{card}]")
    return out


def served_telemetry(torch, np, kernels, StreamingLM, PagedEngine, params, tally, card):
    """22d: a served StreamingLM behind the gateway with every plane on and
    tracing: the debug endpoints, the bridge's series, an OpenMetrics
    scrape with a trace exemplar, the capture of a request and its replay
    bit for bit, the cost tags; then a corrupted migration container at
    the ingress (22b's transport.corrupt)."""
    from seldon_core_tpu_torch.codec.bufview import pack_kv_migration
    from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
    from seldon_core_tpu_torch.engine.server import Gateway, serve_gateway
    from seldon_core_tpu_torch.runtime.component import MicroserviceError
    from seldon_core_tpu_torch.tools.replay import replay_capture
    from seldon_core_tpu_torch.utils import capture, faults, tracing
    from seldon_core_tpu_torch.utils.telemetry import validate_snapshot

    rng = np.random.default_rng(SEED + 223)
    prompts = [rng.integers(0, LM_CONFIG["vocab_size"], TELE_PROMPT) for _ in range(TELE_SERVED_REQUESTS)]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as capdir, telemetry_lane_env(True, capdir):
        capture.reset_default_store()
        tracing.setup_tracing(service_name="chip-smoke-22d")
        lm = StreamingLM(device=SCHED_DEVICE, dtype="bfloat16", max_new_tokens=TELE_NEW, **LM_CONFIG, **LM_ENGINE,
                         **NO_PREFIX_CACHE)
        lm.load()
        loop = LoopThread()
        http_port = free_port()

        async def start():
            gateway = Gateway([(PredictorService(UnitSpec(name="lm", type="MODEL", component=lm), name="gen"), 1.0)])
            runner, handle = await serve_gateway(gateway, host="127.0.0.1", http_port=http_port,
                                                 grpc_port=free_port())
            return gateway, runner, handle

        gateway, runner, handle = loop.run(start())
        base = f"http://127.0.0.1:{http_port}"
        try:
            before = lm.engine.engine_stats()
            sched_sync(torch)
            kernels.reset_launch_counts()
            answers = [http(base + "/api/v0.1/predictions", {"data": {"ndarray": [[int(t) for t in p]]}})
                       for p in prompts]
            sched_sync(torch)
            k4 = sum(v for k, v in kernels.launch_counts().items() if k.startswith("paged_decode"))
            engine = http(base + "/debug/engine?detail=1")["gen"]["lm"]
            calls = decode_calls(engine) - decode_calls(before)
            check(calls > 0 and k4 == LM_CONFIG["num_layers"] * calls,
                  f"22d: K4 launched {k4} times over {calls} decode calls a layer on the served engine")
            tally.launches += k4
            tally.steps += calls
            puid = answers[-1]["meta"]["puid"]
            row = [int(t) for t in answers[-1]["data"]["ndarray"][0]]
            cost = answers[-1]["meta"]["tags"].get("cost") or {}
            decode_recs = [r for r in engine["recorder"] if r["phase"] == "decode"]
            spans = http(base + f"/debug/traces?trace_id={puid}")["spans"]
            request_ids = {sp["spanId"] for sp in spans if sp["name"] == "microservice.predict"}
            gen = [sp for sp in spans if sp["name"].startswith("gen.")]
            knobs_set = http(base + "/debug/knobs")["set"]
            snap = http(base + "/debug/telemetry")
            validate_snapshot(snap)
            # the bridge collects from the idle decode loop every ~0.5 s
            want_chunks, count = engine["chunks"], None
            model = lm._prom_bridge._labels["model_name"]
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 10:
                samples = metric_samples(http(base + "/metrics"))
                hits = [v for n, lab, v in samples
                        if n == "seldon_tpu_engine_chunk_duration_seconds_count" and lab.get("model_name") == model]
                count = hits[0] if len(hits) == 1 else None
                if count == want_chunks:
                    break
                time.sleep(0.25)
            series = sorted({n for n, lab, _v in samples
                             if n.startswith("seldon_tpu_engine_") and lab.get("model_name") == model})
            req = urllib.request.Request(base + "/metrics", headers={"Accept": "application/openmetrics-text"})
            with urllib.request.urlopen(req, timeout=60) as r:
                om_type, om = r.headers.get("Content-Type", ""), r.read().decode()
            exemplars = om.count('# {trace_id="')
            doc = http(base + f"/debug/request/{puid}")
            cap_tokens = doc["capture"]["tokens"] if doc.get("capture") else None
            stats = lm.engine.engine_stats()
            split = {f: sum(v[f] for v in stats["cost_by_adapter"].values())
                     for f in ("page_seconds", "prefill_tokens", "decode_tokens")}
            totals = {"page_seconds": stats["cost_page_seconds"], "prefill_tokens": stats["cost_prefill_tokens"],
                      "decode_tokens": stats["cost_decode_tokens"]}
            out.update({
                "chunks": want_chunks, "records": len(engine["recorder"]), "decode_records": len(decode_recs),
                "records_kernel_active": all(r["kernel_active"] == 1 for r in decode_recs),
                "gen_spans": sorted({sp["name"] for sp in gen}),
                "gen_spans_under_request": bool(gen) and all(sp["parentSpanId"] in request_ids for sp in gen),
                "knobs_set": knobs_set, "telemetry_points": len(snap["points"]), "engine_series": len(series),
                "histogram_count": count, "openmetrics_type": om_type, "openmetrics_exemplars": exemplars,
                "captures": stats["captures"], "capture_tokens_equal": cap_tokens == row, "cost": cost,
                "cost_split_equal": split == totals, "k4_launches": k4, "decode_calls": calls,
            })
            check(len(decode_recs) == want_chunks and out["records_kernel_active"],
                  f"22d: /debug/engine?detail=1 has {len(decode_recs)} decode records for {want_chunks} chunks, "
                  f"kernel_active all 1 {out['records_kernel_active']}")
            check({"gen.queued", "gen.prefill", "gen.decode", "gen.finish"} <= set(out["gen_spans"])
                  and out["gen_spans_under_request"], f"22d: the gen.* spans of {puid}: {spans}")
            check("SELDON_TPU_CAPTURE" in knobs_set and "SELDON_TPU_CAPTURE_SAMPLE" in knobs_set,
                  f"22d: /debug/knobs lists {knobs_set}")
            check(count == want_chunks and "seldon_tpu_engine_chunks_total" in series,
                  f"22d: the chunk-duration histogram counts {count} for {want_chunks} chunks; series {series}")
            check(om_type.startswith("application/openmetrics-text") and exemplars > 0 and om.endswith("# EOF\n"),
                  f"22d: the OpenMetrics scrape ({om_type}) carries {exemplars} exemplars")
            check(stats["captures"] > 0 and out["capture_tokens_equal"],
                  f"22d: /debug/request/{puid} capture tokens {cap_tokens} vs served {row}")
            check(cost.get("page_seconds", 0) > 0 and out["cost_split_equal"],
                  f"22d: cost tags {cost}, per-adapter split {split} vs totals {totals}")
            # the replay tool on the captured request, on the card
            cap = capture.default_store().get(puid)
            sched_sync(torch)
            kernels.reset_launch_counts()
            t_replay = time.perf_counter()
            report = replay_capture(cap, strict=False, device=SCHED_DEVICE)
            sched_sync(torch)
            replay_s = time.perf_counter() - t_replay
            rk4 = sum(v for k, v in kernels.launch_counts().items() if k.startswith("paged_decode"))
            rcalls = decode_calls(report["engine"])
            out["replay"] = {"bit_exact": report["bit_exact"], "first_divergence": report["first_divergence"],
                             "device": report["device"], "dtype": report["dtype"], "latency": report["latency"],
                             "seconds": replay_s, "k4_launches": rk4, "decode_calls": rcalls}
            check(report["bit_exact"] and report["engine"]["kernel_active"] == 1,
                  f"22d: the replay of {puid} is not bit for bit: {report}")
            check(rcalls > 0 and rk4 == LM_CONFIG["num_layers"] * rcalls,
                  f"22d: K4 launched {rk4} times over {rcalls} decode calls a layer on the replay engine")
            tally.launches += rk4
            tally.steps += rcalls
            # transport.corrupt at the migration ingress: a mid-decode stream
            # of a bf16 engine of the same geometry, its container corrupted
            src = sched_engine(torch, PagedEngine, params, **NO_PREFIX_CACHE)
            src.submit(prompts[0], max_new_tokens=TELE_NEW, seed=0)
            src.step()
            src.step()
            (payload, _stream), = src.migrate_export()
            blob = pack_kv_migration(payload)
            before = lm.engine.engine_stats()
            faults.configure("transport.corrupt:times=1")
            random.seed(SEED + 222)  # the flipped byte's place, fixed
            try:
                lm.predict(np.frombuffer(blob, np.uint8)[None, :], [], meta={"tags": {"kv_migration": 1}})
                reason, info = "accepted", ""
            except MicroserviceError as exc:
                reason, info = exc.reason, str(exc)
            finally:
                faults.clear()
            after = lm.engine.engine_stats()
            out["corrupt"] = {"reason": reason, "info": info[:200], "container_bytes": len(blob),
                              "migrated_in": after["migrated_in"] - before["migrated_in"],
                              "pages_in_use": after["pool_pages_used"],
                              "fired": faults.stats().get("transport.corrupt")}
            check(reason == "BAD_MIGRATION_PAYLOAD" and "CRC32C" in info and out["corrupt"]["migrated_in"] == 0
                  and after["pool_pages_used"] == before["pool_pages_used"],
                  f"22b transport.corrupt: {out['corrupt']}")
            del src
        finally:
            async def stop():
                await handle.stop(None)
                await runner.cleanup()
                await gateway.close()

            loop.run(stop())
            loop.close()
            lm.unload()
            tracing.get_tracer().close()
            tracing._tracer = None
            capture.reset_default_store()
    log(f"22d served (gateway, bf16, {TELE_SERVED_REQUESTS} requests of {TELE_PROMPT}, {TELE_NEW} new): "
        f"/debug/engine?detail=1 {out['decode_records']} decode records for {out['chunks']} chunks, kernel_active 1; "
        f"/debug/traces {out['gen_spans']} under the request span; /debug/knobs set {out['knobs_set']}; "
        f"/debug/telemetry valid, {out['telemetry_points']} points; /metrics {out['engine_series']} "
        f"seldon_tpu_engine_* series, chunk histogram _count {out['histogram_count']:.0f}; OpenMetrics "
        f"{out['openmetrics_exemplars']} exemplars; capture tokens == served {out['capture_tokens_equal']}, replay "
        f"bit-exact {out['replay']['bit_exact']} on {out['replay']['device']} in "
        f"{out['replay']['seconds']:.2f} s; cost "
        f"page_seconds {cost.get('page_seconds')}, split == totals {out['cost_split_equal']}; transport.corrupt: "
        f"{out['corrupt']['reason']} ({out['corrupt']['container_bytes']} bytes, {out['corrupt']['migrated_in']} "
        f"imported) [{card}]")
    return out


def telemetry_paths(torch, np, kernels, PagedEngine, StreamingLM, evacuate_streams, load_lm_params, card):
    """Phase 22: generation telemetry and chaos at the generation config
    (22a-c in process, 22d served); K4 = layers x decode calls on every
    engine."""
    t0 = time.perf_counter()
    tally = K4Tally(torch, kernels)
    # one float32 weight set: the bf16 engines cast it, the f32 ones take it as is
    params = load_lm_params("", LM_CONFIG, SEED + 22, torch.device(SCHED_DEVICE))
    marks = [time.perf_counter()]
    numbers = {"22a": telemetry_overhead(torch, np, PagedEngine, params, tally, card)}
    marks.append(time.perf_counter())
    chaos = chaos_paths(torch, np, PagedEngine, params, tally, card)
    marks.append(time.perf_counter())
    numbers["22c"] = watchdog_paths(torch, np, kernels, PagedEngine, evacuate_streams, params, params, chaos,
                                    tally, card)
    marks.append(time.perf_counter())
    numbers["22b"] = {k: v for k, v in chaos.items() if k not in ("ctrl_long", "prompts")}
    del chaos
    numbers["22d"] = served_telemetry(torch, np, kernels, StreamingLM, PagedEngine, params, tally, card)
    marks.append(time.perf_counter())
    del params
    numbers["part_seconds"] = {part: marks[i + 1] - marks[i] for i, part in enumerate(("22a", "22b", "22c", "22d"))}
    numbers["k4_launches"], numbers["decode_calls"] = tally.launches, tally.steps
    numbers["seconds"] = time.perf_counter() - t0
    log(f"phase 22: K4 launched {tally.launches} = {LM_CONFIG['num_layers']} x {tally.steps} decode calls over "
        f"every engine of the phase, {numbers['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in numbers["part_seconds"].items()) + f") [{card}]")
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return numbers



# ---------------------------------------------------------------- phase 23

def device_param():
    """The CLI parameter that moves a server to ``SCHED_DEVICE`` (none on the card)."""
    return [] if SCHED_DEVICE == "cuda" else [{"name": "device", "value": SCHED_DEVICE, "type": "STRING"}]


def glm_params(quantize: str = ""):
    """A served ``GENERATIVE_LM`` at the generation config, on the weights
    of ``load_lm_params("", LM_CONFIG, SEED)``."""
    params = [{"name": k, "value": str(v), "type": "INT"} for k, v in LM_CONFIG.items()]
    params += [{"name": "max_new_tokens", "value": str(GLM_NEW), "type": "INT"},
               {"name": "seed", "value": str(SEED), "type": "INT"}]
    if quantize:
        params.append({"name": "quantize", "value": quantize, "type": "STRING"})
    return params + device_param()


def launch_a8_12():
    return launch_servers({"glm_bf16": (GLM_COMPONENT, glm_params()), "glm_int8": (GLM_COMPONENT, glm_params("int8"))})


def glm_request(np, base, prompts, tags=None):
    """One generation request of every row of ``prompts``; its (rows,
    GLM_NEW) ids."""
    body = {"data": {"ndarray": np.asarray(prompts).tolist()}}
    if tags:
        body["meta"] = {"tags": tags}
    resp = http(base + "/predict", body, timeout=300.0)
    check("data" in resp and "ndarray" in resp["data"], f"response carries no ndarray: {str(resp)[:300]}")
    ids = np.asarray(resp["data"]["ndarray"], np.int64)
    check(ids.shape == (len(prompts), GLM_NEW), f"expected ({len(prompts)}, {GLM_NEW}) ids, got {ids.shape}")
    check(bool(((ids >= 0) & (ids < LM_CONFIG["vocab_size"])).all()), "served ids outside the vocabulary")
    return ids


def generator_rate(torch, gen, prompts) -> float:
    """Decode tokens/s of one Generator turn: a run of GLM_NEW new tokens
    minus a run of one (prefill and the first token), as ``decode_rate``."""
    def timed(n):
        sched_sync(torch)
        t0 = time.perf_counter()
        gen.generate(prompts, max_new_tokens=n)  # the ids' readback synchronises
        return time.perf_counter() - t0

    t_full = timed(GLM_NEW)
    t_one = timed(1)
    return len(prompts) * (GLM_NEW - 1) / max(t_full - t_one, 1e-9)


def generator_step_profile(torch, gen, prompts, card):
    """One decode step of the Generator under the profiler: the runs of
    GLM_PROFILE_NEW and of one new token, their difference over
    GLM_PROFILE_NEW - 1 steps."""
    from torch.profiler import ProfilerActivity, profile

    runs = {}
    for n in (1, GLM_PROFILE_NEW):
        sched_sync(torch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gen.generate(prompts, max_new_tokens=n)
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name, busy_us = device_time_by_name(prof)
        runs[n] = (wall_ms, busy_us / 1e3, sum(c for _, c in by_name.values()), by_name)
    # the host ops that launched the device time, by their own device time
    ops = sorted(((getattr(e, "self_device_time_total", 0.0), e.count, e.key) for e in prof.key_averages()
                  if e.key.startswith("aten::")), reverse=True)[:6]
    steps = GLM_PROFILE_NEW - 1
    wall = (runs[GLM_PROFILE_NEW][0] - runs[1][0]) / steps
    busy = (runs[GLM_PROFILE_NEW][1] - runs[1][1]) / steps
    launches = (runs[GLM_PROFILE_NEW][2] - runs[1][2]) / steps
    log(f"23c profile of a Generator decode step (bf16, {len(prompts)} rows, prompt {GLM_PROMPT}; the runs of "
        f"{GLM_PROFILE_NEW} and 1 new tokens, differenced): wall {wall:.3f} ms under the profiler, device busy "
        f"{busy:.3f} ms, idle share {1 - busy / max(wall, 1e-9):.3f}, {launches:.1f} device events a step [{card}]")
    by_name = runs[GLM_PROFILE_NEW][3]
    total = sum(us for us, _ in by_name.values())
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  {us / 1e3:9.3f} ms  {n:6d}x  {us / max(total, 1e-9):6.3f}  {name[:90]}")
    log("  by host op: " + ", ".join(f"{key} {us / 1e3:.3f} ms / {n}" for us, n, key in ops))
    if SCHED_DEVICE == "cuda":
        check(runs[GLM_PROFILE_NEW][2] > runs[1][2], "the profiler recorded no device event in the Generator's decode")
    return {"step_wall_ms": wall, "step_device_busy_ms": busy, "step_idle_share": 1 - busy / max(wall, 1e-9),
            "device_events_per_step": launches,
            "host_ops_device_ms": {key: us / 1e3 for us, _, key in ops}}


def generative_paths(torch, np, kernels, Generator, PagedEngine, load_lm_params, card):
    """Phase 23: the non-paged generation lane at the generation config.
    (a) f32, TF32 off: the Generator's greedy ids are the paged engine's;
    (b) GENERATIVE_LM served in bf16 and int8 over REST against in-process
    Generators of the same weights, a seeded sampled request repeated;
    (c) decode tokens/s of the Generator and the pool-chunk PagedEngine in
    turns, the bf16 cache's bytes and a profile of one decode step."""
    t0 = time.perf_counter()
    dev = torch.device(SCHED_DEVICE)
    kernel_lane = SCHED_DEVICE == "cuda"
    tally = K4Tally(torch, kernels)
    rng = np.random.default_rng(SEED + 23)
    prompts = rng.integers(0, LM_CONFIG["vocab_size"], (GLM_ROWS, GLM_PROMPT)).astype(np.int32)
    out = {}

    params32 = load_lm_params("", LM_CONFIG, SEED + 23, dev)
    with no_tf32(torch):
        got = Generator(params32, dtype="float32", device=dev, **LM_CONFIG).generate(prompts, max_new_tokens=GLM_NEW)
        eng = sched_engine(torch, PagedEngine, params32, dtype="float32", **NO_PREFIX_CACHE)
        want = np.stack(tally.run(eng, lambda: drive(eng, list(prompts), GLM_NEW), "23a f32 engine", kernel_lane))
    rows = (got == want).all(axis=1)
    log(f"23a f32, TF32 off, {GLM_ROWS} prompts of {GLM_PROMPT}, {GLM_NEW} new: Generator rows equal to the "
        f"PagedEngine's (chunk {eng._chunk_impl}, kernel lane {eng._kernel_active}) {int(rows.sum())}/{len(rows)}")
    check(bool(rows.all()), "23a: the f32 Generator's greedy ids differ from the paged engine's")
    out["23a"] = {"rows_equal": int(rows.sum()), "engine_chunk": eng._chunk_impl, "k4_launches": tally.last[0]}
    del eng, params32

    params = load_lm_params("", LM_CONFIG, SEED, dev)
    local = {"bf16": Generator(params, dtype="bfloat16", device=dev, **LM_CONFIG),
             "int8": Generator(params, dtype="bfloat16", device=dev, quantize="int8", **LM_CONFIG)}
    ctx = EARLY.take("a8_12", launch_a8_12)
    servers, served = ctx["servers"], {}
    try:
        for proc, base, _, logpath in servers.values():
            wait_ready(proc, base, logpath)
        log(f"23b GENERATIVE_LM servers (bf16, int8) ready {ready_since(ctx):.1f}s after their launch{early_note(ctx)}")
        for lane in ("bf16", "int8"):
            base = servers[f"glm_{lane}"][1]
            t1 = time.perf_counter()
            served[lane] = glm_request(np, base, prompts)
            request_ms = (time.perf_counter() - t1) * 1e3
            mine = local[lane].generate(prompts, max_new_tokens=GLM_NEW)
            share = float((served[lane] == mine).all(axis=1).mean())
            log(f"23b served {lane} {GLM_ROWS}x{GLM_PROMPT} -> {GLM_ROWS}x{GLM_NEW} in {request_ms:.1f} ms: rows equal "
                f"to the in-process Generator {share:.3f} (limit {GEN_MIN_IDENTICAL_SHARE})")
            check(share >= GEN_MIN_IDENTICAL_SHARE, f"23b: served {lane} rows disagree with the in-process Generator")
            out[f"23b_{lane}"] = {"rows_equal_share": share, "request_ms": request_ms}
        base = servers["glm_bf16"][1]
        sampled = [glm_request(np, base, prompts[:4], GLM_SAMPLE_TAGS) for _ in range(2)]
        check(bool((sampled[0] == sampled[1]).all()), "23b: a repeated seeded sampled request gave other ids")
        out["23b_sampled"] = {"repeat_equal": True,
                              "tokens_equal_greedy": float((sampled[0] == served["bf16"][:4]).mean())}
        out["23b_int8_vs_bf16_tokens"] = float((served["int8"] == served["bf16"]).mean())
        log(f"23b a seeded sampled request ({GLM_SAMPLE_TAGS}) repeated: equal; its tokens equal greedy's "
            f"{out['23b_sampled']['tokens_equal_greedy']:.3f}; int8 tokens equal bf16's "
            f"{out['23b_int8_vs_bf16_tokens']:.3f} (recorded)")
    finally:
        for proc in ctx["procs"]:
            stop_server(proc)
        ctx["logfile"].close()

    gen = local["bf16"]
    del local
    with knob_env(SELDON_TPU_CHUNK_IMPL="pool"):
        eng = sched_engine(torch, PagedEngine, params, dtype="bfloat16", **NO_PREFIX_CACHE)
    gen.generate(prompts, max_new_tokens=2)
    drive(eng, list(prompts), 2)
    rates = {"generator": [], "engine": []}
    for i in range(GLM_RATE_PAIRS):
        for lane in (("generator", "engine") if i % 2 == 0 else ("engine", "generator")):
            rates[lane].append(generator_rate(torch, gen, prompts) if lane == "generator" else
                               decode_rate(torch, eng, list(prompts), tally, "23c bf16 pool engine", kernel_lane))
    ratio = statistics.median(rates["generator"]) / statistics.median(rates["engine"])
    cache = gen.module.init_cache(GLM_ROWS)
    out["23c"] = {"generator_tok_s": rates["generator"], "engine_tok_s": rates["engine"],
                  "generator_over_engine": ratio, "cache_bytes_bf16": cache.nbytes,
                  "engine_pool_bytes_bf16": sum(t.numel() * t.element_size() for t in (eng.pages_k, eng.pages_v))}
    del cache, eng
    log(f"23c decode tokens/s, bf16, {GLM_ROWS} rows, prompt {GLM_PROMPT}, {GLM_NEW} new, in turns: Generator "
        + ", ".join(f"{r:.1f}" for r in rates["generator"]) + "; PagedEngine (pool chunk) "
        + ", ".join(f"{r:.1f}" for r in rates["engine"]) + f"; median ratio {ratio:.3f} (recorded); the Generator's "
        f"bf16 cache {out['23c']['cache_bytes_bf16']} bytes ({GLM_ROWS} x {LM_CONFIG['max_len']} slots), the "
        f"engine's pool {out['23c']['engine_pool_bytes_bf16']} bytes [{card}]")
    out["23c"]["profile"] = generator_step_profile(torch, gen, prompts, card)
    del gen, params
    out["k4_launches"], out["decode_calls"] = tally.launches, tally.steps
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 23: K4 launched {tally.launches} = {LM_CONFIG['num_layers']} x {tally.steps} decode calls over "
        f"the phase's engines, {out['seconds']:.1f} s [{card}]")
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 24

def det_params():
    return [{"name": "model", "value": DET_MODEL, "type": "STRING"},
            {"name": "normalize", "value": "true", "type": "BOOL"},
            {"name": "dtype", "value": "bfloat16", "type": "STRING"},
            {"name": "max_batch_size", "value": str(DET_BATCH), "type": "INT"}] + device_param()


def mlp_params():
    return [{"name": "model", "value": "mlp", "type": "STRING"},
            {"name": "dtype", "value": "float32", "type": "STRING"},
            {"name": "max_batch_size", "value": str(MLP_ROWS), "type": "INT"}] + device_param()


def launch_a9():
    return launch_servers({"detector": (CUDA_COMPONENT, det_params()), "mlp": (CUDA_COMPONENT, mlp_params())})


def decode_boxes(np, resp, rows: int):
    check("data" in resp and "rawTensor" in resp["data"], f"response carries no rawTensor: {str(resp)[:300]}")
    r = resp["data"]["rawTensor"]
    arr = np.frombuffer(base64.b64decode(r["data"]), dtype=np.dtype(r["dtype"])).reshape(r["shape"])
    check(arr.shape == (rows, DET_TOP_K, 6), f"expected ({rows}, {DET_TOP_K}, 6) boxes, got {arr.shape}")
    check(bool(np.isfinite(arr).all()), "non-finite boxes in a served answer")
    check(bool(((arr[..., 5] >= 0) & (arr[..., 5] < NUM_CLASSES)).all()), "a served class outside the classes")
    return arr


def box_rows_equal(np, a, b) -> float:
    """Share of rows with the same class and box within a pixel."""
    return float(((a[..., 5] == b[..., 5]) & (np.abs(a[..., :4] - b[..., :4]).max(axis=-1) <= 1.0)).mean())


def capacity_checks(torch, np, PagedEngine, paged_hbm_accounting, params, card):
    """A8.13 on the card: the bf16 and int8 pools' real bytes against the
    accounting at pad 1.0 plus the trash page; the peak memory of one ring
    chunk against the working set (recorded)."""
    cfg = dict(d_model=LM_CONFIG["d_model"], num_layers=LM_CONFIG["num_layers"], page_size=LM_ENGINE["page_size"],
               steps_per_call=LM_ENGINE["steps_per_call"], dtype_bytes=2, flat_pool=False, split_tile_pad=1.0)
    slots = LM_ENGINE["max_slots"]
    out = {}
    for kv in ("bf16", "int8"):
        with knob_env(SELDON_TPU_CHUNK_IMPL="pool", SELDON_TPU_KV_DTYPE=kv):
            eng = sched_engine(torch, PagedEngine, params, dtype="bfloat16", **NO_PREFIX_CACHE)
        pools = [eng.pages_k, eng.pages_v] + ([eng.scales_k, eng.scales_v] if kv == "int8" else [])
        real = sum(t.numel() * t.element_size() for t in pools)
        acct = paged_hbm_accounting(streams=slots, ctx_len=LM_CONFIG["max_len"], chunk_impl="pool", kv_dtype=kv,
                                    **cfg)["pool_bytes"]
        page = paged_hbm_accounting(streams=1, ctx_len=LM_ENGINE["page_size"], chunk_impl="pool", kv_dtype=kv,
                                    **cfg)["pool_bytes"]
        logical = paged_hbm_accounting(streams=slots, ctx_len=LM_CONFIG["max_len"], chunk_impl="pool", kv_dtype=kv,
                                       **{**cfg, "flat_pool": True})["pool_bytes"]
        allocated = None
        if SCHED_DEVICE == "cuda":  # what the caching allocator hands out for a tensor of the pool's shape
            sched_sync(torch)
            before = torch.cuda.memory_allocated()
            probe = torch.empty_like(eng.pages_k)
            allocated = (torch.cuda.memory_allocated() - before) / (probe.numel() * probe.element_size())
            del probe
        pad = (real - page) / logical
        log(f"24b {kv} pool ({eng.num_pages} pages of {LM_ENGINE['page_size']}, {slots} slots x {LM_CONFIG['max_len']}): "
            f"real {real} bytes, accounting at pad 1.0 {acct} + trash page {page} = {acct + page}; the split pool's "
            f"pad as read {pad:.6f}, allocator bytes / tensor bytes of one pool {allocated} [{card}]")
        check(real == acct + page, f"24b: the {kv} pool's real bytes {real} != the accounting's {acct} + {page}")
        out[kv] = {"real_bytes": real, "accounting_bytes": acct, "trash_page_bytes": page, "split_pad": pad,
                   "allocator_over_tensor": allocated}
        eng.close()
        del eng, pools
    with knob_env(SELDON_TPU_CHUNK_IMPL="ring"):
        eng = sched_engine(torch, PagedEngine, params, dtype="bfloat16", **NO_PREFIX_CACHE)
    rng = np.random.default_rng(SEED + 241)
    for p in rng.integers(0, LM_CONFIG["vocab_size"], (slots, GLM_PROMPT)):
        eng.submit(p, max_new_tokens=GLM_NEW)
    eng.step()  # admission, prefill and the first chunk
    peak = None
    if SCHED_DEVICE == "cuda":
        sched_sync(torch)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    eng.step()  # one ring chunk
    if SCHED_DEVICE == "cuda":
        sched_sync(torch)
        peak = torch.cuda.max_memory_allocated() - before
    chunk = eng._chunk_impl
    eng.run()
    eng.close()
    ctx_len = GLM_PROMPT + 2 * LM_ENGINE["steps_per_call"]
    ws = paged_hbm_accounting(streams=slots, ctx_len=ctx_len, chunk_impl="ring", **cfg)["working_set_bytes"]
    log(f"24b peak memory over one {chunk} chunk ({slots} lanes at {ctx_len} tokens): {peak} bytes above the "
        f"allocated; accounting working set at pad 1.0 {ws} bytes (recorded, not checked) [{card}]")
    check(chunk == "ring", f"24b: the ring engine ran chunk {chunk}")
    out["ring_chunk"] = {"peak_delta_bytes": peak, "working_set_bytes": ws, "ctx_len": ctx_len}
    return out


def detection_paths(torch, np, kernels, CudaServer, PagedEngine, load_lm_params, paged_hbm_accounting,
                    mem_bytes_per_s, card):
    """Phase 24: (a) detector_resnet50 at 512x512 served in bf16 from
    uint8 with normalize, a batch and concurrent singles against an
    in-process server of the same weights, K1 once a served batch and K1
    timed at the detector's shapes; mlp served in float32 against
    in-process; (b) the pool's real bytes against the capacity
    accounting."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 24)
    shape = (DET_SIZE, DET_SIZE, 3)
    eight, singles = distinct_images(np, rng, DET_BATCH, shape), distinct_images(np, rng, DET_BATCH, shape)
    x_mlp = rng.normal(size=(MLP_ROWS, 4)).astype(np.float32)
    out = {}
    ctx = EARLY.take("a9", launch_a9)
    servers = ctx["servers"]
    try:
        for proc, base, _, logpath in servers.values():
            wait_ready(proc, base, logpath)
        det_base, mlp_base = servers["detector"][1], servers["mlp"][1]
        status = http(det_base + "/health/status")["jsonData"]
        log(f"24a detector and mlp servers ready {ready_since(ctx):.1f}s after their launch{early_note(ctx)} "
            f"({DET_MODEL} signatures {status['signatures']}, buckets {status['buckets']})")
        check(status["device"].startswith(SCHED_DEVICE), f"the detector server is not on {SCHED_DEVICE}")
        k1_0, m0 = status["kernel_launches"].get("fused_normalize", 0), metrics_values(http(det_base + "/metrics"))
        t1 = time.perf_counter()
        served_eight = decode_boxes(np, http(det_base + "/predict", raw_request(np, eight)), DET_BATCH)
        batch_ms = (time.perf_counter() - t1) * 1e3
        answers = concurrent(lambda i: http(det_base + "/predict", raw_request(np, singles[i:i + 1])), DET_BATCH)
        served_singles = np.concatenate([decode_boxes(np, a, 1) for a in answers])
        k1_1 = http(det_base + "/health/status")["jsonData"]["kernel_launches"].get("fused_normalize", 0)
        m1 = metrics_values(http(det_base + "/metrics"))
        resp = http(mlp_base + "/predict", {"data": {"ndarray": x_mlp.tolist()}})
        served_mlp = np.asarray(resp["data"]["ndarray"], np.float32)
    finally:
        for proc in ctx["procs"]:
            stop_server(proc)
        ctx["logfile"].close()
    k1, batches = k1_1 - k1_0, m1["cudaserver_batches_total"] - m0["cudaserver_batches_total"]
    log(f"24a served detector: {int(batches)} batches (a batch of {DET_BATCH} in {batch_ms:.1f} ms, then "
        f"{DET_BATCH} concurrent singles), K1 launches {int(k1)}")
    check(k1_equals_batches(k1, batches), f"24a: K1 launched {k1} times for {batches} served batches")

    local = CudaServer(model=DET_MODEL, normalize=True, dtype="bfloat16", max_batch_size=DET_BATCH, warmup=False,
                       device=SCHED_DEVICE)
    local.load()
    ref = np.concatenate([np.asarray(local.predict(eight, []))]
                         + [np.asarray(local.predict(singles[i:i + 1], [])) for i in range(DET_BATCH)])
    local.unload()
    del local
    got = np.concatenate([served_eight, served_singles])
    score_err = float(np.abs(got[..., 4] - ref[..., 4]).max())
    rows_equal = box_rows_equal(np, got, ref)
    log(f"24a served boxes vs in-process ({2 * DET_BATCH} images x {DET_TOP_K} rows): largest score difference "
        f"{score_err:.3e} (limit {DET_SCORE_TOL}), rows with the same class and box within a pixel {rows_equal:.3f} "
        f"(recorded); top score range {float(got[:, 0, 4].min()):.4f}-{float(got[:, 0, 4].max()):.4f}")
    check(score_err <= DET_SCORE_TOL, f"24a: served scores differ from the in-process server's by {score_err}")
    out["24a"] = {"batches": batches, "k1_launches": k1, "batch_ms": batch_ms, "score_max_abs_err": score_err,
                  "rows_equal_share": rows_equal}

    mlp = CudaServer(model="mlp", dtype="float32", max_batch_size=MLP_ROWS, warmup=False, device=SCHED_DEVICE)
    mlp.load()
    with no_tf32(torch):
        mlp_ref = np.asarray(mlp.predict(x_mlp, []))
    mlp.unload()
    mlp_err = float(np.abs(served_mlp - mlp_ref).max())
    log(f"24a served mlp (float32, {MLP_ROWS} rows x {mlp_ref.shape[-1]} classes) vs in-process: largest difference "
        f"{mlp_err:.3e} (limit {MLP_TOL})")
    check(served_mlp.shape == mlp_ref.shape and mlp_err <= MLP_TOL, "24a: served mlp rows differ from in-process")
    out["24a"]["mlp_max_abs_err"] = mlp_err

    if SCHED_DEVICE == "cuda":
        scale, shift = (torch.from_numpy(a).cuda() for a in kernels.imagenet_affine())
        out["k1_512"] = {}
        for batch in (DET_BATCH, 1):
            x = torch.from_numpy(distinct_images(np, rng, batch, shape)).cuda()
            same = torch.equal(kernels.fused_normalize(x, scale, shift, torch.bfloat16).view(torch.int16),
                               kernels.fused_normalize_reference(x, scale, shift, torch.bfloat16).view(torch.int16))
            check(same, f"24a: K1 at {tuple(x.shape)} differs from its plain version")
            out["k1_512"][batch] = k1_timing(torch, kernels, x, scale, shift, mem_bytes_per_s)

    params = load_lm_params("", LM_CONFIG, SEED, torch.device(SCHED_DEVICE))
    out["24b"] = capacity_checks(torch, np, PagedEngine, paged_hbm_accounting, params, card)
    del params
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 24: {out['seconds']:.1f} s [{card}]")
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out

# ---------------------------------------------------------------- phase 25

def prefill_params():
    return LM_PARAMS + [{"name": "dtype", "value": "float32", "type": "STRING"},
                        {"name": "prefix_cache", "value": "false", "type": "BOOL"}] + device_param()


def launch_a10():
    """25b's served PrefillLM (float32, the generation config) with
    ``--api BOTH``: its gRPC port is what a DisaggregatedLM dials."""
    http_port, grpc_port = free_port(), free_port()
    fd, logpath = tempfile.mkstemp(prefix="chip_smoke_prefill_server_", suffix=".log")
    logfile = os.fdopen(fd, "w")
    launched = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
         "seldon_core_tpu_torch.models.disagg.PrefillLM", "--api", "BOTH", "--host", "127.0.0.1",
         "--http-port", str(http_port), "--grpc-port", str(grpc_port), "--parameters", json.dumps(prefill_params())],
        cwd=ROOT, stdout=logfile, stderr=subprocess.STDOUT, start_new_session=True)
    base = f"http://127.0.0.1:{http_port}"
    return {"procs": [proc], "logfile": logfile, "logpath": logpath, "launched": launched, "base": base,
            "grpc_port": grpc_port, "ready": lambda: wait_ready(proc, base, logpath)}


def lm_front(cls, dtype: str, **kw):
    """A generation front at the generation config on the card, the prefix
    cache off (the turns repeat no prompt, and a hit would change what they
    measure), loaded."""
    front = cls(**LM_CONFIG, **LM_ENGINE, max_new_tokens=DISAGG_NEW, dtype=dtype, device=SCHED_DEVICE,
                **NO_PREFIX_CACHE, **kw)
    front.load()
    return front


def k4_disagg_run(torch, kernels, front, fn, what: str):
    """Run ``fn`` with the launch counts reset just before: K4 launches once
    a layer a decode call on the front's decode engine, and its prefill
    engines make no decode call."""
    engines = getattr(front, "_prefill_engines", [])
    pre0 = [decode_calls(e.engine_stats()) for e in engines]
    c0 = decode_calls(front.engine.engine_stats())
    sched_sync(torch)
    kernels.reset_launch_counts()
    out = fn()
    with front.engine._step_lock:  # the decode loop's last step has finished
        sched_sync(torch)
    n = sum(v for k, v in kernels.launch_counts().items() if k.startswith("paged_decode"))
    calls = decode_calls(front.engine.engine_stats()) - c0
    pre = [decode_calls(e.engine_stats()) - p for e, p in zip(engines, pre0)]
    kernel_lane = SCHED_DEVICE == "cuda"
    want = LM_CONFIG["num_layers"] * (calls + sum(pre)) if kernel_lane else 0
    check(front.engine._kernel_active == kernel_lane, f"{what}: the decode engine's kernel lane is "
          f"{front.engine._kernel_active}, expected {kernel_lane}")
    check(calls > 0 and n == want and not any(pre),
          f"{what}: K4 launched {n} times over {calls} decode calls on the decode engine and {pre} on the prefill "
          f"engines; expected {want} = {LM_CONFIG['num_layers']} layers x the calls, none on a prefill engine")
    return out, {"launches": n, "decode_calls": calls, "prefill_decode_calls": pre}


def stream_turn(front, prompts):
    """One streamed request a prompt, all at once: each stream's time to
    its first chunk and to its last, and its tokens."""
    t0 = time.perf_counter()

    def one(i):
        first = last = None
        n = 0
        for chunk in front.predict_stream(prompts[i:i + 1], [], {"tags": {"seed": i}}):
            last = time.perf_counter()
            first = first or last
            n += len(chunk)
        return first - t0, last - t0, n

    got = concurrent(one, len(prompts))
    ttft = statistics.median(g[0] for g in got)
    span = max(g[1] for g in got) - min(g[0] for g in got)
    decoded = sum(g[2] - 1 for g in got)
    check(all(g[2] == DISAGG_NEW for g in got), "25e: a stream ended short of its tokens")
    return {"ttft_ms": ttft * 1e3, "decode_tok_s": decoded / span, "wall_s": max(g[1] for g in got)}


def disagg_paths(torch, np, kernels, StreamingLM, DisaggregatedLM, faults, card):
    """Phase 25: disaggregated prefill/decode at the generation config.
    (a) in-process, two prefill engines: float32 (TF32 off) tokens equal a
    unified StreamingLM's; bf16 first tokens equal, agreement >= 0.75;
    (b) a served PrefillLM dialled over gRPC: float32 tokens equal (a)'s;
    (c) transport.corrupt armed on (b)'s lane: every waiter sees the
    CRC32C refusal and no stream decodes; (d) an unreachable deadline:
    504 DEADLINE_UNREACHABLE before any prefill; (e) time to the first
    token and decode tokens/s, unified against disaggregated in turns
    (recorded, no gain claimed).  K4 on every decode engine, once a layer
    a decode call; none on a prefill engine."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 25)
    vocab = LM_CONFIG["vocab_size"]
    prompts = rng.integers(0, vocab, (DISAGG_ROWS, DISAGG_PROMPT)).astype(np.int32)
    meta = {"tags": {"seed": 25}}
    out, k4 = {}, {"launches": 0, "decode_calls": 0}

    def tally(numbers):
        k4["launches"] += numbers["launches"]
        k4["decode_calls"] += numbers["decode_calls"]
        return numbers

    with no_tf32(torch):
        uni = lm_front(StreamingLM, "float32")
        dis = lm_front(DisaggregatedLM, "float32", prefill_workers=DISAGG_WORKERS)
        try:
            want = uni.predict(prompts, [], dict(meta))
            check(all(e.pages_k.dtype == dis.engine.pages_k.dtype == torch.float32 for e in dis._prefill_engines),
                  "25a: a float32 front's prefill engines hold other pages than its decode pool")
            t1 = time.perf_counter()
            got, numbers = k4_disagg_run(torch, kernels, dis, lambda: dis.predict(prompts, [], dict(meta)),
                                         "25a f32 disaggregated")
            request_ms = (time.perf_counter() - t1) * 1e3
            rows = (got == want).all(axis=1)
            exports = sum(e.engine_stats()["kv_exports"] for e in dis._prefill_engines)
            stats = dis.engine.engine_stats()
            log(f"25a f32, TF32 off, {DISAGG_ROWS}x{DISAGG_PROMPT} -> {DISAGG_NEW} new through {DISAGG_WORKERS} "
                f"in-process prefill engines in {request_ms:.1f} ms: rows equal to unified StreamingLM's "
                f"{int(rows.sum())}/{len(rows)}; kv exports {exports}, imports {stats['kv_imports']}; K4 "
                f"{numbers['launches']} = {LM_CONFIG['num_layers']} x {numbers['decode_calls']} decode calls on the "
                f"decode engine, prefill engines' decode calls {numbers['prefill_decode_calls']} [{card}]")
            check(bool(rows.all()), "25a: f32 disaggregated tokens differ from unified serving's")
            check(exports == stats["kv_imports"] == DISAGG_ROWS, "25a: not every row went through a prefill engine")
            out["25a_f32"] = {"rows_equal": int(rows.sum()), "request_ms": request_ms, "k4": tally(numbers)}

            # (d) on the warm f32 front: the cost model has measured rates now
            before = sum(e.engine_stats()["kv_exports"] for e in dis._prefill_engines)
            try:
                dis.predict(prompts[:1], [], {"tags": {"deadline_ms": DISAGG_DEADLINE_MS}})
                raise SmokeFailure("25d: a request with an unreachable deadline was served")
            except SmokeFailure:
                raise
            except Exception as e:  # noqa: BLE001 — the refusal is what is checked
                status, reason, text = getattr(e, "status_code", None), getattr(e, "reason", ""), str(e)
            cost = dis.engine.predict_cost_s(DISAGG_PROMPT, DISAGG_NEW)
            after = sum(e.engine_stats()["kv_exports"] for e in dis._prefill_engines)
            log(f"25d deadline {DISAGG_DEADLINE_MS} ms against a predicted {cost * 1e3:.1f} ms: {status} {reason} "
                f"({text}); prefill exports {before} -> {after} [{card}]")
            check(status == 504 and reason == "DEADLINE_UNREACHABLE" and after == before,
                  "25d: an unreachable deadline was not refused before prefill")
            out["25d"] = {"status": status, "reason": reason, "predicted_ms": cost * 1e3}
        finally:
            uni.unload()
            dis.unload()
        del uni, dis

        ctx = EARLY.take("a10", launch_a10)
        try:
            ctx["ready"]()
            base = ctx["base"]
            log(f"25b served PrefillLM (float32, gRPC :{ctx['grpc_port']}) ready {ready_since(ctx):.1f}s after its "
                f"launch{early_note(ctx)} [{card}]")
            served_k4_0 = http(base + "/health/status")["jsonData"]["kernel_launches"]
            remote = lm_front(DisaggregatedLM, "float32",
                              prefill_endpoints=json.dumps([f"grpc://127.0.0.1:{ctx['grpc_port']}"]))
            try:
                t1 = time.perf_counter()
                got, numbers = k4_disagg_run(torch, kernels, remote, lambda: remote.predict(prompts, [], dict(meta)),
                                             "25b f32 remote prefill")
                request_ms = (time.perf_counter() - t1) * 1e3
                rows = (got == want).all(axis=1)
                status = http(base + "/health/status")["jsonData"]
                served_k4 = sum(status["kernel_launches"].get(k, 0) - served_k4_0.get(k, 0)
                                for k in status["kernel_launches"] if k.startswith("paged_decode"))
                exports = status["engine"]["kv_exports"]
                log(f"25b f32 through the served PrefillLM over gRPC in {request_ms:.1f} ms: rows equal to 25a's "
                    f"{int(rows.sum())}/{len(rows)}; the server exported {exports}, K4 there {served_k4} (a prefill "
                    f"worker never decodes); K4 here {numbers['launches']} = {LM_CONFIG['num_layers']} x "
                    f"{numbers['decode_calls']} decode calls [{card}]")
                check(bool(rows.all()), "25b: f32 tokens through the served PrefillLM differ from 25a's")
                check(served_k4 == 0 and exports == DISAGG_ROWS, "25b: the served PrefillLM decoded or missed a row")
                out["25b"] = {"rows_equal": int(rows.sum()), "request_ms": request_ms, "k4": tally(numbers),
                              "served_prefill_k4": served_k4}

                imports0, tokens0 = (remote.engine.engine_stats()[k] for k in ("kv_imports", "tokens"))
                faults.configure("transport.corrupt:k=4,times=inf")
                try:
                    def corrupted(i):
                        try:
                            remote.predict(prompts[i:i + 1], [], dict(meta))
                            return "served"
                        except Exception as e:  # noqa: BLE001 — the refusal is what is checked
                            return f"{type(e).__name__}: {e}"

                    answers = concurrent(corrupted, DISAGG_ROWS)
                finally:
                    faults.configure("0")
                stats = remote.engine.engine_stats()
                named = sum("CRC32C" in a for a in answers)
                log(f"25c transport.corrupt on the remote lane: {named}/{DISAGG_ROWS} waiters refused naming the "
                    f"CRC32C ({answers[0][:160]}); imports {imports0} -> {stats['kv_imports']}, tokens {tokens0} -> "
                    f"{stats['tokens']} [{card}]")
                check(named == DISAGG_ROWS and stats["kv_imports"] == imports0 and stats["tokens"] == tokens0,
                      "25c: a corrupted KV container was not refused by its CRC32C, or a stream decoded")
                out["25c"] = {"refused": named}
            finally:
                remote.unload()
        except Exception:
            ctx["logfile"].flush()
            log(f"25b-c: the served PrefillLM's log ends:\n{tail(ctx['logpath'])}")
            raise
        finally:
            for proc in ctx["procs"]:
                stop_server(proc)
            ctx["logfile"].close()

    uni = lm_front(StreamingLM, "bfloat16")
    dis = lm_front(DisaggregatedLM, "bfloat16", prefill_workers=DISAGG_WORKERS)
    try:
        want = uni.predict(prompts, [], dict(meta))
        got, numbers = k4_disagg_run(torch, kernels, dis, lambda: dis.predict(prompts, [], dict(meta)),
                                     "25a bf16 disaggregated")
        first = bool((got[:, 0] == want[:, 0]).all())
        agree = float((got == want).mean())
        log(f"25a bf16: first tokens equal {first}, token agreement with unified serving {agree:.3f} (limit "
            f"{INT8_MIN_AGREEMENT}; C3, C18); K4 {numbers['launches']} = {LM_CONFIG['num_layers']} x "
            f"{numbers['decode_calls']} [{card}]")
        check(first and agree >= INT8_MIN_AGREEMENT, "25a: bf16 disaggregated tokens stray from unified serving's")
        out["25a_bf16"] = {"first_tokens_equal": first, "agreement": agree, "k4": tally(numbers)}

        turns = {"unified": [], "disaggregated": []}
        for i in range(DISAGG_RATE_PAIRS):
            for lane in (("unified", "disaggregated") if i % 2 == 0 else ("disaggregated", "unified")):
                fresh = rng.integers(0, vocab, (DISAGG_ROWS, DISAGG_PROMPT)).astype(np.int32)
                front = uni if lane == "unified" else dis
                turns[lane].append(stream_turn(front, fresh))
        med = {lane: {k: statistics.median(t[k] for t in runs) for k in ("ttft_ms", "decode_tok_s")}
               for lane, runs in turns.items()}
        log(f"25e bf16, {DISAGG_ROWS} concurrent streams of {DISAGG_PROMPT} + {DISAGG_NEW}, in turns: time to the "
            f"first chunk (median of the streams) unified " + ", ".join(
                f"{t['ttft_ms']:.1f}" for t in turns["unified"]) + " ms, disaggregated " + ", ".join(
                f"{t['ttft_ms']:.1f}" for t in turns["disaggregated"]) + " ms; decode tokens/s unified " + ", ".join(
                f"{t['decode_tok_s']:.1f}" for t in turns["unified"]) + ", disaggregated " + ", ".join(
                f"{t['decode_tok_s']:.1f}" for t in turns["disaggregated"]) + f" (recorded, no gain claimed) [{card}]")
        # where the disaggregated first token waits: one prefill engine's export of one prompt, alone
        eng, export_ms = dis._prefill_engines[0], []
        for p in rng.integers(0, vocab, (8, DISAGG_PROMPT)).astype(np.int32):
            sched_sync(torch)
            t1 = time.perf_counter()
            eng.prefill_export(p)
            export_ms.append((time.perf_counter() - t1) * 1e3)
        log(f"25e a prefill engine exports one {DISAGG_PROMPT}-token prompt (prefill, the pages read back to the "
            f"host) in {statistics.median(export_ms):.2f} ms (median of 8; {min(export_ms):.2f}-{max(export_ms):.2f})"
            f": {DISAGG_ROWS} prompts over {DISAGG_WORKERS} engines take {DISAGG_ROWS // DISAGG_WORKERS} of them "
            f"in turn [{card}]")
        # do the prefill engines' host syncs serialise them? 4 exports on one engine, then 4 on each at once
        batches = [rng.integers(0, vocab, (4, DISAGG_PROMPT)).astype(np.int32) for _ in dis._prefill_engines]

        def exports(i):
            for p in batches[i]:
                dis._prefill_engines[i].prefill_export(p)

        walls = {}
        for lane, n in (("alone", 1), ("together", len(batches))):
            sched_sync(torch)
            t1 = time.perf_counter()
            concurrent(exports, n)
            walls[lane] = (time.perf_counter() - t1) * 1e3
        overlap = walls["together"] / walls["alone"]
        log(f"25e 4 exports on one prefill engine {walls['alone']:.1f} ms, 4 on each of {len(batches)} at once "
            f"{walls['together']:.1f} ms: {overlap:.2f}x (1.0: the engines overlap; {len(batches)}.0: their host "
            f"syncs serialise them; recorded) [{card}]")
        out["25e"] = {"turns": turns, "median": med, "export_ms": export_ms, "export_walls_ms": walls,
                      "export_together_over_alone": overlap,
                      "ttft_disagg_over_unified": med["disaggregated"]["ttft_ms"] / med["unified"]["ttft_ms"],
                      "decode_disagg_over_unified": (med["disaggregated"]["decode_tok_s"]
                                                     / med["unified"]["decode_tok_s"])}
    finally:
        uni.unload()
        dis.unload()
    del uni, dis
    out["k4_launches"], out["decode_calls"] = k4["launches"], k4["decode_calls"]
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 25: K4 launched {k4['launches']} = {LM_CONFIG['num_layers']} x {k4['decode_calls']} decode calls "
        f"over the phase's decode engines (0 on its prefill engines), {out['seconds']:.1f} s [{card}]")
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 26

def a11_gateway(loop, graph: dict, request_logger=None):
    """``graph`` as one predictor behind an in-process gateway on ``loop``;
    returns (service, gateway, runner, handle, REST base URL)."""
    from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
    from seldon_core_tpu_torch.engine.server import Gateway, serve_gateway

    http_port = free_port()

    async def start():
        svc = PredictorService(UnitSpec.from_dict(graph), name=graph["name"])
        gateway = Gateway([(svc, 1.0)], request_logger=request_logger)
        runner, handle = await serve_gateway(gateway, host="127.0.0.1", http_port=http_port, grpc_port=free_port())
        return svc, gateway, runner, handle

    return (*loop.run(start()), f"http://127.0.0.1:{http_port}")


def guard_mlp_params():
    """examples/outlier_guard.yaml's classifier on the card: mlp, 3
    classes, 4 features, float32."""
    return [{"name": "model", "value": "mlp", "type": "STRING"},
            {"name": "num_classes", "value": "3", "type": "INT"},
            {"name": "input_shape", "value": "[4]", "type": "JSON"},
            {"name": "dtype", "value": "float32", "type": "STRING"},
            {"name": "max_batch_size", "value": str(GUARD_ROWS), "type": "INT"},
            {"name": "warmup", "value": "false", "type": "BOOL"}] + device_param()


def booster_spec(np, rng):
    """A JSON booster of XGB_TREES full trees of depth XGB_DEPTH over
    XGB_FEATURES features (xgboost's save_model('model.json') layout)."""
    trees = []
    n_internal = 2 ** XGB_DEPTH - 1
    for _ in range(XGB_TREES):
        n = 2 ** (XGB_DEPTH + 1) - 1
        left = [2 * i + 1 if i < n_internal else -1 for i in range(n)]
        right = [2 * i + 2 if i < n_internal else -1 for i in range(n)]
        feats = [int(f) if i < n_internal else 0 for i, f in enumerate(rng.integers(0, XGB_FEATURES, n))]
        conds = [float(c) for c in rng.normal(size=n) * 0.1]
        trees.append({"left_children": left, "right_children": right, "split_indices": feats,
                      "split_conditions": conds, "default_left": [int(b) for b in rng.integers(0, 2, n)]})
    return {"learner": {"learner_model_param": {"base_score": "0.5"}, "objective": {"name": "reg:squarederror"},
                        "gradient_booster": {"model": {"trees": trees}}}}


def booster_rows(spec, X):
    """The booster's margins, one row and one node at a time in Python."""
    out = []
    for x in X:
        margin = float(spec["learner"]["learner_model_param"]["base_score"])
        for t in spec["learner"]["gradient_booster"]["model"]["trees"]:
            node = 0
            while t["left_children"][node] != -1:
                go_left = x[t["split_indices"][node]] < t["split_conditions"][node]
                node = t["left_children"][node] if go_left else t["right_children"][node]
            margin += t["split_conditions"][node]
        out.append(margin)
    return out


def card_vs_cpu(np, a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def component_paths(torch, np, resnet, CudaServer, components, card):
    """Phase 26: the graph components, prepackaged servers and request
    logging on the card.  (a) examples/outlier_guard.yaml (OUTLIER_MAHALANOBIS
    in front of a float32 mlp on CUDA_SERVER) behind a gateway: rows against
    in-process, outlier tags on a shifted batch; (b) OUTLIER_VAE and
    OUTLIER_ISOLATION_FOREST fitted and scored on the card against the
    plain CPU scoring; (c) integrated gradients over a served ResNet-50
    bf16 through POST /api/v0.1/explanations against in-process; (d) kernel
    SHAP on the mlp; (e) a TorchScript ResNet-50 through TORCH_SERVER; (f)
    the JSON booster through XGBOOST_SERVER against a row-by-row
    evaluation; (g) a JSONL pair logger on the gateway; (h) a
    THOMPSON_SAMPLING router's state through a persistence round trip."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 26)
    outliers, explainers, reqlogger, persistence, units = components
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_a11_")
    loop = LoopThread()
    try:
        # (a) + (d) + (g): the outlier-guarded mlp, a kernel SHAP explainer on it, a pair logger on its gateway
        pairs_path = os.path.join(tmp, "pairs.jsonl")
        guard = {"name": "guard", "type": "TRANSFORMER", "implementation": "OUTLIER_MAHALANOBIS",
                 "parameters": [{"name": "n_components", "value": "3", "type": "INT"},
                                {"name": "threshold", "value": "25.0", "type": "FLOAT"}],
                 "children": [{"name": "classifier", "type": "MODEL", "implementation": "CUDA_SERVER",
                               "parameters": guard_mlp_params()}]}
        with no_tf32(torch):
            svc, gateway, runner, handle, base = a11_gateway(loop, guard, reqlogger.JsonlPairLogger(pairs_path))
            try:
                mlp = svc.executor.component("classifier")
                mlp.load()
                normal = rng.normal(size=(GUARD_ROWS, 4)).astype(np.float32)
                answers = [http(base + "/api/v0.1/predictions", {"data": {"ndarray": x.tolist()}}) for x in (
                    normal, normal[::-1].copy(), normal + GUARD_SHIFT)]
                served = [np.asarray(a["data"]["ndarray"], np.float32) for a in answers]
                tags = [a["meta"]["tags"] for a in answers]
                svc.explainer = explainers.KernelShapExplainer(model=mlp, n_samples=SHAP_SAMPLES)
                x_shap = normal[:2].astype(np.float64)
                shap = http(base + "/api/v0.1/explanations", {"data": {"ndarray": x_shap.tolist()}})["jsonData"]
                for _ in range(LOGGED_REQUESTS - len(answers)):
                    answers.append(http(base + "/api/v0.1/predictions", {"data": {"ndarray": normal[:4].tolist()}}))
            finally:
                stop_in_process(loop, svc, gateway, runner, handle)
            local = CudaServer(model="mlp", num_classes=3, input_shape=(4,), dtype="float32",
                               max_batch_size=GUARD_ROWS, warmup=False, device=SCHED_DEVICE)
            local.load()
            ref = [np.asarray(local.predict(x, [])) for x in (normal, normal[::-1].copy(), normal + GUARD_SHIFT)]
            local.unload()
            cpu = CudaServer(model="mlp", num_classes=3, input_shape=(4,), dtype="float32", max_batch_size=32,
                             warmup=False, device="cpu")
            cpu.load()
            shap_cpu = explainers.KernelShapExplainer(model=cpu, n_samples=SHAP_SAMPLES).explain(x_shap)
            f_x, f_b = (np.asarray(cpu.predict(v, [])) for v in (x_shap, np.zeros_like(x_shap)))
            cpu.unload()
        err = max(float(np.abs(s - r).max()) for s, r in zip(served, ref))
        log(f"26a outlier-guarded mlp (examples/outlier_guard.yaml, CUDA_SERVER float32) behind a gateway: rows "
            f"against in-process {err:.3e} (limit {GUARD_TOL}); tags normal {tags[0].get('outlier')} / "
            f"{tags[1].get('outlier')} ({tags[1].get('outlier_count')} flagged), shifted by {GUARD_SHIFT}: "
            f"{tags[2].get('outlier')} ({tags[2].get('outlier_count')} of {GUARD_ROWS} flagged) [{card}]")
        check(err <= GUARD_TOL, "26a: served mlp rows behind the outlier guard differ from in-process")
        check(tags[2].get("outlier") is True and tags[2].get("outlier_count") == GUARD_ROWS,
              "26a: the shifted batch was not tagged as outliers")
        out["26a"] = {"max_abs_err": err, "normal_flagged": tags[1].get("outlier_count"),
                      "shifted_flagged": tags[2].get("outlier_count")}
        phi = np.asarray(shap["attributions"])
        eff = max(abs(float(phi[i].sum()) - float(f_x[i, t] - f_b[i, t])) for i, t in enumerate(shap["targets"]))
        vs_cpu = float(np.abs(phi - np.asarray(shap_cpu["attributions"])).max())
        log(f"26d kernel SHAP on the mlp through /api/v0.1/explanations ({SHAP_SAMPLES} samples, 4 features: exact "
            f"enumeration): targets {shap['targets']}, efficiency |sum phi - (f(x) - f(b))| {eff:.3e}, against the "
            f"CPU mlp {vs_cpu:.3e} (limit {SHAP_TOL}) [{card}]")
        check(shap["targets"] == shap_cpu["targets"] and eff <= SHAP_TOL and vs_cpu <= SHAP_TOL,
              "26d: kernel SHAP on the card disagrees with the axiom or the CPU")
        out["26d"] = {"efficiency_err": eff, "vs_cpu": vs_cpu}

        pairs = [json.loads(line) for line in open(pairs_path)]
        puids = [a["meta"]["puid"] for a in answers]
        log(f"26g JSONL pair logger on the gateway: {len(pairs)} pairs for {len(answers)} requests (the explanation "
            f"is not a predict), puids equal {[p['puid'] for p in pairs] == puids} [{card}]")
        check(len(pairs) == len(answers) and [p["puid"] for p in pairs] == puids
              and all(re.match(r"^00-[0-9a-f]{32}-[0-9a-f]{16}-01$", p["traceparent"]) for p in pairs),
              "26g: the pair log does not hold one pair a request with its puid")
        out["26g"] = {"pairs": len(pairs), "requests": len(answers)}

        # (b) the two device detectors fitted and scored on the card, against the plain CPU scoring
        with no_tf32(torch):
            X = rng.normal(size=(VAE_ROWS, VAE_FEATURES)).astype(np.float32)
            odd = X[:64] + 4.0
            vae = outliers.VAEOutlierDetector(latent_dim=2, hidden_dim=32, seed=0, device=SCHED_DEVICE)
            t1 = time.perf_counter()
            losses = vae.fit(X, epochs=VAE_EPOCHS)
            fit_s = time.perf_counter() - t1
            vae_cpu = outliers.VAEOutlierDetector(latent_dim=2, hidden_dim=32, device="cpu")
            vae_cpu._build(VAE_FEATURES)
            vae_cpu.module.load_state_dict({k: v.cpu() for k, v in vae.module.state_dict().items()})
            t1 = time.perf_counter()
            scores = vae.score(X)
            score_ms = (time.perf_counter() - t1) * 1e3
            vae_err = card_vs_cpu(np, scores, vae_cpu.score(X))
            vae_odd = float(vae.score(odd).mean() / scores.mean())
        log(f"26b OUTLIER_VAE fitted on the card ({VAE_ROWS}x{VAE_FEATURES}, {VAE_EPOCHS} epochs of 128 in "
            f"{fit_s:.2f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}), {VAE_ROWS} rows scored in {score_ms:.2f} ms: "
            f"card vs CPU {vae_err:.3e} of the largest score (limit {DETECTOR_TOL}); shifted rows score "
            f"{vae_odd:.1f}x the normal mean [{card}]")
        check(vae_err <= DETECTOR_TOL and losses[-1] < losses[0], "26b: the VAE's card scores stray from the CPU's")
        forest = outliers.IsolationForestDetector(n_trees=IFOREST_TREES, subsample=IFOREST_SUBSAMPLE, seed=0,
                                                  device=SCHED_DEVICE)
        t1 = time.perf_counter()
        forest.fit(X)
        forest_fit_s = time.perf_counter() - t1
        forest_cpu = outliers.IsolationForestDetector(device="cpu")
        forest_cpu.restore_state(forest.checkpoint_state())
        forest.score(X[:8])  # the forest's upload
        sched_sync(torch)
        t1 = time.perf_counter()
        f_scores = forest.score(X)
        forest_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        f_cpu = forest_cpu.score(X)
        forest_cpu_ms = (time.perf_counter() - t1) * 1e3
        forest_err = card_vs_cpu(np, f_scores, f_cpu)
        forest_odd = float(forest.score(odd).mean() - f_scores.mean())
        log(f"26b OUTLIER_ISOLATION_FOREST ({IFOREST_TREES} trees of {IFOREST_SUBSAMPLE}, host fit "
            f"{forest_fit_s:.2f} s): {VAE_ROWS} rows scored on the card in {forest_ms:.2f} ms (CPU {forest_cpu_ms:.2f} "
            f"ms): card vs CPU {forest_err:.3e} (limit {DETECTOR_TOL}); shifted rows score +{forest_odd:.3f} [{card}]")
        check(forest_err <= DETECTOR_TOL and forest_odd > 0, "26b: the forest's card scores stray from the CPU's")
        out["26b"] = {"vae_rel_err": vae_err, "vae_fit_s": fit_s, "vae_score_ms": score_ms,
                      "forest_rel_err": forest_err, "forest_score_ms": forest_ms, "forest_cpu_ms": forest_cpu_ms}
        del vae, vae_cpu, forest, forest_cpu

        # (c) integrated gradients over the served ResNet-50 bf16
        graph = {"name": "resnet", "type": "MODEL", "implementation": "CUDA_SERVER",
                 "parameters": MODEL_PARAMS + [{"name": "warmup", "value": "false", "type": "BOOL"}]}
        image = rng.normal(size=(1, *IMG)).astype(np.float32)
        svc, gateway, runner, handle, base = a11_gateway(loop, graph)
        try:
            model = svc.executor.component("resnet")
            model.load()
            svc.explainer = explainers.IntegratedGradientsExplainer(model=model, steps=IG_STEPS)
            http(base + "/api/v0.1/explanations", {"data": {"ndarray": image.tolist()}}, timeout=300)  # first use
            t1 = time.perf_counter()
            resp = http(base + "/api/v0.1/explanations", {"data": {"ndarray": image.tolist()}}, timeout=300)
            served_ms = (time.perf_counter() - t1) * 1e3
        finally:
            stop_in_process(loop, svc, gateway, runner, handle)
        attr = np.asarray(resp["jsonData"]["attributions"], np.float64)
        local = CudaServer(model="resnet50", normalize=True, dtype="bfloat16", max_batch_size=32, warmup=False,
                           device=SCHED_DEVICE)
        local.load()
        ig = explainers.IntegratedGradientsExplainer(model=local, steps=IG_STEPS)
        mine = ig.explain(image)
        sched_sync(torch)
        t1 = time.perf_counter()
        mine = ig.explain(image)
        sched_sync(torch)
        local_ms = (time.perf_counter() - t1) * 1e3
        local.unload()
        del local, ig
        ig_err = rel_l2(np, attr, np.asarray(mine["attributions"]))
        log(f"26c integrated gradients ({IG_STEPS} steps, ResNet-50 bf16) through /api/v0.1/explanations: "
            f"attributions {attr.shape}, finite {bool(np.isfinite(attr).all())}, target {resp['jsonData']['targets']}"
            f" (in-process {mine['targets']}), rel L2 against in-process {ig_err:.3e} (limit {IG_REL_L2}); served "
            f"{served_ms:.1f} ms, in-process {local_ms:.1f} ms [{card}]")
        check(attr.shape == (1, *IMG) and bool(np.isfinite(attr).all()) and ig_err <= IG_REL_L2
              and resp["jsonData"]["targets"] == mine["targets"], "26c: served IG attributions stray from in-process")
        out["26c"] = {"rel_l2": ig_err, "served_ms": served_ms, "in_process_ms": local_ms}
        del attr, mine, resp

        # (e) a TorchScript ResNet-50 through TORCH_SERVER on the card
        ref_model = reference_resnet(torch, resnet, SEED)
        images = rng.normal(size=(TORCHSCRIPT_ROWS, *IMG)).astype(np.float32)
        script_path = os.path.join(tmp, "resnet50.pt")
        with torch.inference_mode():
            x = torch.from_numpy(images).to(SCHED_DEVICE)
            want = ref_model(x).float().cpu().numpy()
            torch.jit.save(torch.jit.trace(ref_model, x[:1]), script_path)
        del ref_model
        graph = {"name": "torchscript", "type": "MODEL", "implementation": "TORCH_SERVER",
                 "parameters": [{"name": "model_uri", "value": script_path, "type": "STRING"}] + device_param()}
        svc, gateway, runner, handle, base = a11_gateway(loop, graph)
        try:
            server = svc.executor.component("torchscript")
            server.load()
            device = str(next(server.module.parameters()).device)
            got = np.asarray(http(base + "/api/v0.1/predictions", {"data": {"ndarray": images.tolist()}},
                                  timeout=300)["data"]["ndarray"], np.float32)
        finally:
            stop_in_process(loop, svc, gateway, runner, handle)
        ts_err = max(rel_l2(np, got[i], want[i]) for i in range(TORCHSCRIPT_ROWS))
        log(f"26e TorchScript ResNet-50 (traced bf16, {os.path.getsize(script_path)} bytes) through TORCH_SERVER on "
            f"{device}: {got.shape} rows, largest rel L2 against the in-process ResNet50 {ts_err:.3e} (limit "
            f"{TORCHSCRIPT_REL_L2}) [{card}]")
        check(device.startswith(SCHED_DEVICE) and got.shape == want.shape and ts_err <= TORCHSCRIPT_REL_L2,
              "26e: TORCH_SERVER rows stray from the in-process ResNet50, or it runs off the card")
        out["26e"] = {"max_rel_l2": ts_err, "device": device}

        # (f) the JSON booster through XGBOOST_SERVER
        spec = booster_spec(np, rng)
        booster_dir = os.path.join(tmp, "booster")
        os.makedirs(booster_dir)
        with open(os.path.join(booster_dir, "model.json"), "w") as f:
            json.dump(spec, f)
        rows = rng.normal(size=(XGB_ROWS, XGB_FEATURES)) * 0.1
        graph = {"name": "xgb", "type": "MODEL", "implementation": "XGBOOST_SERVER",
                 "parameters": [{"name": "model_uri", "value": booster_dir, "type": "STRING"}]}
        svc, gateway, runner, handle, base = a11_gateway(loop, graph)
        try:
            t1 = time.perf_counter()
            got = http(base + "/api/v0.1/predictions", {"data": {"ndarray": rows.tolist()}})["data"]["ndarray"]
            xgb_ms = (time.perf_counter() - t1) * 1e3
        finally:
            stop_in_process(loop, svc, gateway, runner, handle)
        want = booster_rows(spec, rows.tolist())
        equal = got == want
        log(f"26f JSON booster ({XGB_TREES} trees of depth {XGB_DEPTH}, {XGB_FEATURES} features) through "
            f"XGBOOST_SERVER: {XGB_ROWS} rows in {xgb_ms:.1f} ms, equal to a row-by-row evaluation {equal} [{card}]")
        check(equal, "26f: the booster's served rows differ from the row-by-row evaluation")
        out["26f"] = {"rows_equal": equal, "request_ms": xgb_ms}
    finally:
        loop.close()

    # (h) a THOMPSON_SAMPLING router through a persistence round trip
    router = units.make_builtin("THOMPSON_SAMPLING", n_branches=2, seed=0)
    manager = persistence.PersistenceManager(os.path.join(tmp, "state"), "ab-test/main/router")
    thread = manager.start_background(router, period_s=3600.0)
    for i in range(50):
        branch = router.route(None, [])
        router.send_feedback(None, [], float(branch == 1 or i % 4 == 0), None, routing=branch)
    thread.stop()  # the final snapshot
    thread.join(timeout=30)
    fresh = units.make_builtin("THOMPSON_SAMPLING", n_branches=2, seed=0)
    restored = manager.restore(fresh)
    same = all(np.array_equal(fresh.checkpoint_state()[k], v) for k, v in router.checkpoint_state().items())
    log(f"26h THOMPSON_SAMPLING after 50 feedbacks: snapshot {os.path.basename(manager.path)}, restored {restored}, "
        f"alpha {router.alpha.tolist()} beta {router.beta.tolist()} equal after the round trip {same} [{card}]")
    check(restored and same, "26h: the router's state did not survive the persistence round trip")
    out["26h"] = {"restored": restored, "alpha": router.alpha.tolist(), "beta": router.beta.tolist()}
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 26: {out['seconds']:.1f} s [{card}]")
    if SCHED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def run() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this smoke test needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import grpc
    except ImportError as e:
        print(f"chip_smoke: FAIL: grpc (grpcio) is not importable: {e}", file=sys.stderr)
        return 1
    try:
        import numpy as np

        from seldon_core_tpu_torch import native
        from seldon_core_tpu_torch.models import resnet, transformer, vit
        from seldon_core_tpu_torch.models.cudaserver import CudaServer
        from seldon_core_tpu_torch.components import explainers, outliers
        from seldon_core_tpu_torch.engine import units
        from seldon_core_tpu_torch.models.disagg import DisaggregatedLM, evacuate_streams
        from seldon_core_tpu_torch.models.generate import Generator, load_lm_params
        from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM, paged_hbm_accounting
        from seldon_core_tpu_torch.models.registry import WeightRegistry
        from seldon_core_tpu_torch.models.resnet import same_pads
        from seldon_core_tpu_torch.models.speculative import SpeculativeGenerator
        from seldon_core_tpu_torch.ops import _build, kernels, w8a8
        from seldon_core_tpu_torch.ops.lora import make_lora_params
        from seldon_core_tpu_torch.tools import probe_normalize
        from seldon_core_tpu_torch.utils import faults, persistence, reqlogger
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port is not beside this script ({e})", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    clock = PhaseClock()
    try:
        smi_line, device_kind, mem_bytes_per_s = card_report(torch, grpc)
        card = smi_line
        # the servers of phases 4-18a load while the kernels build (each waits
        # on the build's lock for the kernels it loads) and are ready before phase 3
        for name, launch in (("main", launch_main), ("lm", launch_lm), ("vit", launch_vit), ("qlm", launch_qlm),
                             ("precision", launch_precision),
                             ("gateway", launch_gateway), ("native", launch_native), ("a4", launch_a4),
                             ("a2_2", launch_a2_2), ("w8a8_lm", launch_w8a8_lm),
                             ("a5", lambda: launch_a5(torch, np, resnet, load_lm_params, make_lora_params)),
                             ("a8_12", launch_a8_12), ("a9", launch_a9), ("a10", launch_a10)):
            EARLY.launch(name, launch)
        t0 = time.perf_counter()
        sources = ("fused_normalize", "paged_decode", "flash_attention", "int8_matmul")
        with tempfile.TemporaryDirectory() as variant_dir, ThreadPoolExecutor(len(sources) + 2) as pool:
            # one nvcc per source, all at once, K1's launch-only copy and the native ingress's g++ beside them
            floor = pool.submit(probe_normalize.build_variants, variant_dir, ("launch only",))
            native_lib = pool.submit(native.build)
            libs = list(pool.map(_build.build, sources))
            log(f"native ingress library {native_lib.result().name} (g++, native/*.cc)")
            for source in sources:
                _build.load(source)
            launch_only = probe_normalize.Swapped(floor.result()[0]["launch only"])
            log(f"built {', '.join(lib.name for lib in libs)} and K1's launch-only copy in "
                f"{time.perf_counter() - t0:.1f}s")
            clock.mark("phases 1-2")
            EARLY.ready(torch, card)
            clock.mark("early servers")
            max_err, timings = kernel_checks(torch, np, kernels, mem_bytes_per_s, launch_only)
        paged_errs, paged_timings = paged_kernel_checks(torch, np, kernels, mem_bytes_per_s)
        flash_errs, flash_timings = flash_kernel_checks(torch, np, kernels, mem_bytes_per_s)
        k2_errs, k2_timings, k2_launches = int8_matmul_checks(torch, np, kernels, mem_bytes_per_s, card)
        clock.mark("phase 3")
        launches, numbers = main_path(torch, np, kernels, resnet, card)
        whole = whole_path(torch, np, kernels, resnet, card)
        clock.mark("phases 4-6")
        gen_launches, gen_numbers = generation_path(torch, np, PagedEngine, load_lm_params, card)
        clock.mark("phase 7")
        grid_launches, gen_numerics = engine_numerics(torch, np, kernels, PagedEngine, load_lm_params, card)
        engine = engine_numbers(torch, np, PagedEngine, load_lm_params, card)
        clock.mark("phase 8")
        vit_local, vit_numbers = vit_path(torch, np, kernels, vit, card)
        vit_profile = vit_forward_profile(torch, np, kernels, vit_local, card)
        del vit_local
        torch.cuda.empty_cache()
        clock.mark("phase 9")
        tf_numerics = transformer_numerics(torch, np, kernels, vit, transformer, CudaServer, card)
        clock.mark("phase 10")
        variant_errs, variant_timings = paged_variant_checks(torch, np, kernels, mem_bytes_per_s)
        q_launches, q_numbers = quantized_generation_path(torch, np, PagedEngine, load_lm_params, WeightRegistry,
                                                          make_lora_params, card)
        q_engine_launches, q_numerics = quantized_engine_numerics(torch, np, kernels, PagedEngine, load_lm_params,
                                                                  WeightRegistry, make_lora_params, card)

        def int8_adapter_engine(params):
            with knob_env(SELDON_TPU_KV_DTYPE="int8"):
                return PagedEngine(params, dtype="bfloat16", device="cuda", max_adapters=2, lora_rank=LORA_RANK,
                                   weight_registry=adapter_registry(WeightRegistry, make_lora_params),
                                   **LM_CONFIG, **LM_ENGINE, **NO_PREFIX_CACHE)

        q_engine = engine_numbers(torch, np, PagedEngine, load_lm_params, card, make_engine=int8_adapter_engine,
                                  adapters=(None, "a1", "a2"), what="bf16 int8 pool + adapters (base/a1/a2)")
        clock.mark("phase 11")
        precision_numbers = precision_path(torch, np, kernels, w8a8, same_pads, CudaServer, card)
        clock.mark("phase 12")
        gateway_numbers = gateway_paths(torch, np, kernels, resnet, card)
        graph_numbers = graph_paths(torch, np, kernels, resnet, card)
        clock.mark("phase 13")
        native_numbers = native_paths(torch, np, kernels, resnet, card, gateway_numbers, whole["forward_ms"][1])
        clock.mark("phase 14")
        a4_numbers = a4_paths(torch, np, kernels, resnet, card)
        clock.mark("phase 15")
        a2_2_numbers = a2_2_paths(torch, np, kernels, resnet, CudaServer, card)
        clock.mark("phase 16")
        a5_a6_numbers = a5_a6_paths(torch, np, kernels, resnet, vit, CudaServer, PagedEngine, load_lm_params,
                                    WeightRegistry, make_lora_params, mem_bytes_per_s, card)
        clock.mark("phase 17")
        sched_numbers = scheduler_paths(torch, np, kernels, w8a8, PagedEngine, load_lm_params, card)
        clock.mark("phase 18")
        stream_numbers = streaming_paths(torch, np, kernels, PagedEngine, StreamingLM, load_lm_params, WeightRegistry,
                                         make_lora_params, card)
        clock.mark("phase 19")
        spec_numbers = speculative_paths(torch, np, kernels, PagedEngine, SpeculativeGenerator, load_lm_params, card)
        clock.mark("phase 20")
        evac_numbers = evacuation_paths(torch, np, kernels, PagedEngine, evacuate_streams, load_lm_params, card)
        clock.mark("phase 21")
        tele_numbers = telemetry_paths(torch, np, kernels, PagedEngine, StreamingLM, evacuate_streams, load_lm_params,
                                       card)
        clock.mark("phase 22")
        glm_numbers = generative_paths(torch, np, kernels, Generator, PagedEngine, load_lm_params, card)
        clock.mark("phase 23")
        det_numbers = detection_paths(torch, np, kernels, CudaServer, PagedEngine, load_lm_params,
                                      paged_hbm_accounting, mem_bytes_per_s, card)
        clock.mark("phase 24")
        disagg_numbers = disagg_paths(torch, np, kernels, StreamingLM, DisaggregatedLM, faults, card)
        clock.mark("phase 25")
        a11_numbers = component_paths(torch, np, resnet, CudaServer,
                                      (outliers, explainers, reqlogger, persistence, units), card)
        clock.mark("phase 26")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        EARLY.stop()
    t32, t1 = timings[32], timings[1]
    result = {
        "numbers": numbers,
        "whole_path": {"rel_l2": whole["rel_l2"], "min_cos": whole["min_cos"],
                       "forward_ms_b1": whole["forward_ms"][1], "forward_ms_b32": whole["forward_ms"][32]},
        "generation": gen_numbers,
        "generation_numerics": gen_numerics,
        "generation_engine": engine,
        "paged_timings": paged_timings,
        "vit": vit_numbers,
        "vit_forward": vit_profile,
        "transformer_numerics": tf_numerics,
        "flash_timings": flash_timings,
        "int8_adapters_generation": q_numbers,
        "int8_adapters_numerics": q_numerics,
        "int8_adapters_engine": q_engine,
        "paged_variant_timings": {f"{kernels.paged_launch_name(*v)}/{label}": row
                                  for (v, label), row in variant_timings.items()},
        "int8_matmul_timings": {K2_CASES[c][4]: row for c, row in k2_timings.items()},
        "precision_lanes": precision_numbers,
        "gateway": gateway_numbers,
        "graphs": graph_numbers,
        "native_ingress": native_numbers,
        "a4": a4_numbers,
        "a2_2": a2_2_numbers,
        "a5_a6": a5_a6_numbers,
        "scheduler": sched_numbers,
        "streaming": stream_numbers,
        "speculative": spec_numbers,
        "evacuation": evac_numbers,
        "telemetry": tele_numbers,
        "generative": glm_numbers,
        "detection": det_numbers,
        "disaggregated": disagg_numbers,
        "components": a11_numbers,
        "phase_seconds": clock.seconds,
        "seconds": time.perf_counter() - t_start,
    }
    log(json.dumps(result))
    log(f"chip_smoke: every phase passed in {result['seconds']:.1f} s [{card}]")
    kernel_line = {"kernels": [{
        "name": "fused_normalize",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/fused_normalize.cu",
        "replaces": "seldon_core_tpu/ops/kernels.py:46",
        "launches": launches["fused_normalize"],
        "launches_on": f"served ResNet-50 REST path (phases 4 + 6), one per batch: {int(numbers['batches'])} batches",
        "max_abs_err": max_err,
        "ms": t32["ms"], "plain_ms": t32["plain_ms"], "bound_ms": t32["bound_ms"],
        "bound_by": "bytes", "library_ms": t32["library_ms"], "library_call": "torch.addcmul(out=bf16)",
        "launches_on_gateway": {"launches": gateway_numbers["gateway_k1_launches"],
                                "batches": gateway_numbers["gateway_batches"],
                                "path": "ResNet-50 SeldonDeployment, gateway over gRPC and REST (phase 13a)"},
        "launches_on_native_ingress": {"launches": native_numbers["native_k1_launches"],
                                       "batches": native_numbers["native_batches"],
                                       "path": "ResNet-50 SeldonDeployment behind the C++ native ingress (phase 14)"},
        "launches_on_a4": {
            "a4_gateway": a4_numbers["15a"]["launches"]["a4"], "plain_gateway": a4_numbers["15a"]["launches"]["plain"],
            "two_process": {"k1": a4_numbers["15b"]["k1_launches"], "batches": a4_numbers["15b"]["batches"]},
            "path": "ResNet-50 SeldonDeployment with TLS, OAuth, deadlines and tracing (phase 15)"},
        "launches_on_phase24": {"launches": det_numbers["24a"]["k1_launches"],
                                "batches": det_numbers["24a"]["batches"],
                                "path": f"served {DET_MODEL} at {DET_SIZE}x{DET_SIZE}, uint8 rawTensor with normalize "
                                        "(phase 24a)"},
        "shape_512": {f"{b}x{DET_SIZE}x{DET_SIZE}x3": {k: det_numbers["k1_512"][b][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "copy_ms", "grid")} for b in (DET_BATCH, 1)},
        "launch_floor_ms": t32["launch_floor_ms"], "copy_ms": t32["copy_ms"],
        "design": K1_DESIGN, "grid": t32["grid"],
        "shape": [32, *IMG], "out_dtype": "bfloat16",
        "batch1": {k: t1[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "launch_floor_ms", "copy_ms",
                                      "grid")},
    }]}
    uni, rag = paged_timings["uniform512"], paged_timings["ragged"]
    B, h, hd, ps, P, _ = PAGED_CASES[0]
    for impl, line, n, where in (
            ("stream", 409, gen_launches["paged_decode_stream"], "served generation path"),
            ("grid", 343, grid_launches, "in-process PagedEngine, SELDON_TPU_PAGED_KERNEL_IMPL=grid")):
        kernel_line["kernels"].append({
            "name": f"paged_decode_{impl}",
            "route": "cuda",
            "source": "seldon_core_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": f"seldon_core_tpu/ops/kernels.py:{line}",
            "launches": n, "launches_on": where,
            "max_abs_err": paged_errs[impl]["max_abs_err"], "max_rel_err": paged_errs[impl]["max_rel_err"],
            "ms": uni[impl], "plain_ms": uni["plain_ms"], "bound_ms": uni["bound_ms"], "bound_by": "bytes",
            "library_ms": uni["library_ms"],
            "library_call": "pk[tables] gather + F.scaled_dot_product_attention (two calls, normalised)",
            "design": PAGED_DESIGN,
            "shape": [B, h, hd, ps, P], "lengths": "uniform 512", "pool_dtype": "bfloat16",
            "ragged": {"ms": rag[impl], "plain_ms": rag["plain_ms"], "library_ms": rag["library_ms"],
                       "bound_ms": rag["bound_ms"], "lengths": RAGGED_LENGTHS},
        })
        if impl == "stream":
            kernel_line["kernels"][-1]["launches_on_phase18"] = {
                "launches": sched_numbers["k4_launches"], "decode_calls": sched_numbers["decode_calls"],
                "path": "in-process PagedEngine: bf16 / int8w / w8a8, prefix cache, steps ladder and stall/evict, "
                        "SLO queue, chunked prefill (phase 18)"}
            kernel_line["kernels"][-1]["launches_on_phase19"] = {
                "launches": stream_numbers["k4_launches"], "decode_calls": stream_numbers["decode_calls"],
                "served_launches": stream_numbers["19c"]["k4_launches"],
                "path": "the pool chunk beside the ring (19a), the length-bucketed split (19b), StreamingLM streams "
                        "over REST SSE, sync gRPC and the native ingress (19c), streams under eviction (19d); one "
                        "launch a layer-step a bucket, none on the ring (phase 19)"}
            g = spec_numbers["20b"]
            kernel_line["kernels"][-1]["launches_on_phase20"] = {
                "launches": g["k4_launches"], "draft_forwards": g["single_token_forwards"],
                "draft_layers": g["draft_layers"],
                "plain_lane_launches": {k: spec_numbers["20a"]["lanes"][k]["k4_launches"]
                                        for k in ("plain", "tokenwise")},
                "verify_rounds": {k: spec_numbers["20a"]["lanes"][k]["verify_rounds"] for k in ("oracle", "ngram")},
                "verify_launches": 0,
                "path": "SpeculativeGenerator's draft model: one launch a draft layer a one-token forward (20b); "
                        "the engine's verify rounds on the gather lane launch none (20a, 20c)"}
            kernel_line["kernels"][-1]["launches_on_phase21"] = {
                "launches": evac_numbers["k4_launches"], "decode_calls": evac_numbers["decode_calls"],
                "by_run": {k: evac_numbers["21a"][k]["k4_launches"] for k in ("native", "int8", "replay")}
                | {"tier": evac_numbers["21b"]["k4_launches"]},
                "path": "streams resumed on engine B after an evacuation (native and int8 pools), re-derived by "
                        "replay after a drain (21a), and continuing from promoted KV-tier chains (21b); one launch "
                        "a layer a decode call (phase 21)"}
            kernel_line["kernels"][-1]["launches_on_phase22"] = {
                "launches": tele_numbers["k4_launches"], "decode_calls": tele_numbers["decode_calls"],
                "served_launches": tele_numbers["22d"]["k4_launches"],
                "replay_launches": tele_numbers["22d"]["replay"]["k4_launches"],
                "path": "the telemetry plane on and off (22a), chaos runs under paged.nan / paged.chunk / "
                        "paged.alloc (22b), a cold engine, a degraded source and the healthy peer its streams "
                        "moved to (22c), a served StreamingLM behind the gateway and the replay of its capture "
                        "(22d); one launch a layer a decode call (phase 22)"}
            kernel_line["kernels"][-1]["launches_on_phase25"] = {
                "launches": disagg_numbers["k4_launches"], "decode_calls": disagg_numbers["decode_calls"],
                "by_run": {k: disagg_numbers[k]["k4"] for k in ("25a_f32", "25b", "25a_bf16")},
                "prefill_engine_launches": 0,
                "path": "DisaggregatedLM's decode engine over pages handed off by two in-process prefill engines "
                        "(f32 and bf16, 25a) and by a served PrefillLM over gRPC (25b); launches = layers x the "
                        "decode engine's decode calls, and the prefill engines make none (phase 25)"}
    serving, causal = flash_timings["serving"], flash_timings["causal"]
    kernel_line["kernels"].append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "seldon_core_tpu/ops/kernels.py:255",
        "launches": vit_numbers["launches"]["flash_attention"],
        "launches_on": f"served ViT-B/16 REST path ({VIT_LAYERS} per batch, {vit_numbers['batches']} batches)",
        "max_abs_err": flash_errs["max_abs_err"], "max_rel_err": flash_errs["max_rel_err"],
        "ms": serving["ms"], "plain_ms": serving["plain_ms"], "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"], "library_ms": serving["library_ms"],
        "library_call": "F.scaled_dot_product_attention on (B, H, L, D) views",
        "design": "tensor-core mma.sync (bf16 / f16); f32: CUDA-core body",
        "shape": serving["shape"], "dtype": "bfloat16",
        "causal": {"shape": causal["shape"], "ms": causal["ms"], "plain_ms": causal["plain_ms"],
                        "library_ms": causal["library_ms"], "bound_ms": causal["bound_ms"],
                        "bound_by": causal["bound_by"], "launches": tf_numerics["lm_launches"],
                        "launches_on": "in-process CudaServer transformer_lm, attention=flash, f32"},
        "vit384": {k: a5_a6_numbers["17d"]["k3_577"][k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                                  "bound_ms", "bound_by", "max_abs_err",
                                                                  "max_rel_err", "launches")}
        | {"launches_on": f"served ViT-B/16 at 224 + 384 from one server (phase 17d, {VIT_LAYERS} per batch, "
                          f"{a5_a6_numbers['17d']['batches']} batches over both signature groups)"},
    })
    for v in PAGED_VARIANTS:
        variant = kernels.paged_launch_name(*v)
        uni, rag = variant_timings[v, "uniform512"], variant_timings[v, "ragged"]
        if v == ("stream", True, True):
            n, where = q_launches[variant], "served int8 + adapters generation path (StreamingLM over REST)"
        else:
            n = q_engine_launches[variant]
            where = {"paged_decode_stream_int8": "in-process PagedEngine, SELDON_TPU_KV_DTYPE=int8, f32",
                     "paged_decode_grid_int8": "in-process PagedEngine, SELDON_TPU_KV_DTYPE=int8, "
                                               "SELDON_TPU_PAGED_KERNEL_IMPL=grid, f32",
                     "paged_decode_stream_lora": "in-process PagedEngine, max_adapters=2, f32"}[variant]
        kernel_line["kernels"].append({
            "name": variant,
            "route": "cuda",
            "source": "seldon_core_tpu_torch/ops/csrc/paged_decode.cu",
            "replaces": VARIANT_REPLACES[v],
            "launches": n, "launches_on": where,
            "max_abs_err": variant_errs[v]["max_abs_err"], "max_rel_err": variant_errs[v]["max_rel_err"],
            "delta_max_rel_err": variant_errs[v]["delta_max_rel_err"] if v[2] else None,
            "ms": uni["ms"], "plain_ms": uni["plain_ms"], "bound_ms": uni["bound_ms"], "bound_by": uni["bound_by"],
            "library_ms": uni["library_ms"],
            "library_call": ("pk[tables] gather" + (" dequantised" if v[1] else "")
                             + (" + two torch.bmm" if v[2] else "") + " + F.scaled_dot_product_attention"),
            "design": PAGED_DESIGN,
            "shape": [B, h, hd, ps, P], "lengths": "uniform 512", "q_dtype": "bfloat16",
            "pool_dtype": "int8" if v[1] else "bfloat16",
            "ragged": {"ms": rag["ms"], "plain_ms": rag["plain_ms"], "library_ms": rag["library_ms"],
                       "bound_ms": rag["bound_ms"], "bound_by": rag["bound_by"], "lengths": RAGGED_LENGTHS},
        })
    fc1 = k2_timings[0]
    kernel_line["kernels"].append({
        "name": "int8_matmul",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "seldon_core_tpu/ops/kernels.py:97",
        "launches": k2_launches, "launches_on": "Int8Dense forward at the fc1 shape (its public entry point)",
        "max_abs_err": k2_errs["max_abs_err"], "max_rel_err": k2_errs["max_rel_err"],
        "ms": fc1["ms"], "plain_ms": fc1["plain_ms"], "bound_ms": fc1["bound_ms"], "bound_by": fc1["bound_by"],
        "library_ms": fc1["library_ms"], "library_call": "torch.matmul(x, w.to(x.dtype)) * scale",
        "design": "tensor-core mma.sync",
        "shape": fc1["shape"], "dtype": fc1["dtype"],
        "others": [{k: k2_timings[c][k] for k in ("shape", "dtype", "ms", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by")} for c in range(1, K2_TIMED)],
    })
    print(smi_line)
    print(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
